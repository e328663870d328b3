"""Command line of the port: `python -m imaginary_tpu_torch --port 9000`."""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="imaginary_tpu_torch",
        description="imaginary-tpu on PyTorch/CUDA: /resize and /crop on JPEG")
    ap.add_argument("--host", default="0.0.0.0", help="bind address")
    ap.add_argument("--port", type=int, default=9000, help="TCP port")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the kernels on (cuda, cuda:N, or cpu)")
    ap.add_argument("--mount", default="",
                    help="directory served to GET ?file= requests")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from imaginary_tpu_torch.web.app import make_server

    srv = make_server(args.host, args.port, device=args.device, mount=args.mount)
    print(f"imaginary_tpu_torch listening on {args.host}:{args.port} "
          f"(device {srv.service.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
