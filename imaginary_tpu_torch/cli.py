"""Command line of the port: `python -m imaginary_tpu_torch --port 9000`."""

from __future__ import annotations

import argparse

from imaginary_tpu_torch.engine import MAX_BATCH


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="imaginary_tpu_torch",
        description="imaginary-tpu on PyTorch/CUDA: the image routes and "
                    "/pipeline on JPEG, PNG, WEBP, GIF and TIFF")
    ap.add_argument("--host", default="0.0.0.0", help="bind address")
    ap.add_argument("--port", type=int, default=9000, help="TCP port")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the kernels on (cuda, cuda:N, or cpu)")
    ap.add_argument("--mount", default="",
                    help="directory served to GET ?file= requests")
    ap.add_argument("--max-batch", type=int, default=MAX_BATCH,
                    help="micro-batch size cap")
    ap.add_argument("--batch-form-ms", type=float, default=5.0,
                    help="max milliseconds an item may wait for its chunk "
                         "to close (the batch-formation latency cap)")
    ap.add_argument("--max-inflight", type=int, default=4,
                    help="device chunks launched but not yet fetched")
    ap.add_argument("--transport-dct", action="store_true",
                    help="serve baseline JPEG requests (4:2:0/4:2:2/4:4:4/"
                         "grayscale) over the compressed-domain transport: "
                         "host entropy decode ships DCT coefficients, the "
                         "device runs the IDCT, and shrink-on-load folds in "
                         "the DCT domain")
    ap.add_argument("--transport-dct-egress", action="store_true",
                    help="drain JPEG-bound dct-transport responses as "
                         "quantized DCT coefficients: the device runs the "
                         "forward DCT + quantization and the host only "
                         "entropy-codes (requires --transport-dct)")
    ap.add_argument("--devices", type=int, default=0,
                    help="device count of the lanes' mesh (0 = all visible "
                         "cards; with --device cpu, that many cpu entries)")
    ap.add_argument("--mesh-policy", default="off",
                    choices=["off", "lanes", "sharded", "auto"],
                    help="multi-GPU serving: 'lanes' gives every card its own "
                         "continuous-batching lane (own stream, formation "
                         "cap, in-flight window and fault domain); "
                         "'sharded'/'auto' also split big chunks over the "
                         "healthy cards; 'off' (default) is one "
                         "collector/fetcher pair on --device")
    ap.add_argument("--spatial", type=int, default=1,
                    help="spatial axis of the lanes' mesh: a single image "
                         "whose input bucket crosses the bar is W-sharded "
                         "over that many entries (1 = off)")
    ap.add_argument("--spatial-threshold-px", type=int, default=3840 * 2160,
                    help="input-bucket pixel count at which a single image "
                         "W-shards over the spatial axis")
    ap.add_argument("--spatial-mpix", type=float, default=0.0,
                    help="the same bar in megapixels (maps onto "
                         "--spatial-threshold-px; 0 keeps the pixel knob)")
    ap.add_argument("--lane-form-ms", type=float, default=-1.0,
                    help="per-lane batch-formation cap in ms (negative = "
                         "inherit --batch-form-ms)")
    ap.add_argument("--lane-inflight", type=int, default=2,
                    help="per-lane chunks launched but not yet fetched "
                         "(the lane's only backpressure)")
    args = ap.parse_args(argv)
    if args.transport_dct_egress and not args.transport_dct:
        ap.error("--transport-dct-egress requires --transport-dct")
    return args


def make_server_from_args(args: argparse.Namespace):
    """Bind (not start) the server the parsed command line describes."""
    from imaginary_tpu_torch.web.app import make_server

    return make_server(args.host, args.port, device=args.device, mount=args.mount,
                       max_batch=args.max_batch, batch_form_ms=args.batch_form_ms,
                       max_inflight=args.max_inflight,
                       transport_dct=args.transport_dct,
                       transport_dct_egress=args.transport_dct_egress,
                       mesh_policy=args.mesh_policy, n_devices=args.devices,
                       lane_form_ms=args.lane_form_ms if args.lane_form_ms >= 0 else None,
                       lane_inflight=args.lane_inflight,
                       spatial=max(1, args.spatial),
                       spatial_threshold_px=max(1, args.spatial_threshold_px),
                       spatial_mpix=max(0.0, args.spatial_mpix))


def main(argv=None) -> None:
    args = parse_args(argv)
    srv = make_server_from_args(args)
    print(f"imaginary_tpu_torch listening on {args.host}:{args.port} "
          f"(device {srv.service.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
