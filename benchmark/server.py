"""The system under test as a child process: `python -m imaginary_tpu_torch`
on 127.0.0.1, its counters, its CPU time, and the card's memory beside it.

The harness needs nothing of the port but its command line and its HTTP
surfaces (/metrics, /debugz/profile).
"""

from __future__ import annotations

import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request

from benchmark import spec

LISTENING = "listening on"
_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_metrics(text: str) -> dict:
    """Prometheus text -> {(name, labels): value}; labels as the sorted
    tuple of their (key, value) pairs."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line.strip())
        if not m:
            continue
        name, labels, value = m.groups()
        pairs = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', labels or "")))
        try:
            out[(name, pairs)] = float(value)
        except ValueError:
            continue
    return out


def proc_cpu_seconds(pid: int) -> float:
    """User and system CPU seconds of pid, its reaped children and every
    live descendant (Linux /proc)."""
    tick = os.sysconf("SC_CLK_TCK")
    stats = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        stats[int(entry)] = (int(fields[1]), [int(v) for v in fields[11:15]])
    total, todo = 0, [pid]
    while todo:
        p = todo.pop()
        if p not in stats:
            continue
        _, (ut, st, cut, cst) = stats[p]
        total += ut + st + (cut + cst if p == pid else 0)
        todo.extend(c for c, (ppid, _) in stats.items() if ppid == p)
    return total / tick


class MemorySampler:
    """nvidia-smi's reading of the card's used memory every 250 ms, one
    process for the whole run; `peak_bytes()` after `stop()`."""

    def __init__(self, out_path: str, device_index: int = 0):
        self.out_path = out_path
        self.proc = None
        smi = shutil.which("nvidia-smi")
        if smi:
            self._out = open(out_path, "w")
            self.proc = subprocess.Popen(
                [smi, "--query-gpu=memory.used", "--format=csv,noheader,nounits",
                 "-i", str(device_index), "-lms", "250"],
                stdout=self._out, stderr=subprocess.DEVNULL)

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
            self._out.close()

    def peak_bytes(self) -> int:
        if self.proc is None:
            return 0
        with open(self.out_path) as f:
            mib = [float(v) for v in f.read().split() if v.replace(".", "", 1).isdigit()]
        return int(max(mib, default=0.0) * 1024 * 1024)


class Server:
    """One server process; output in `<out_dir>/server.out|err`."""

    def __init__(self, flags: list, out_dir: str, device: str, boot_timeout_s: float):
        self.port = free_port()
        os.makedirs(out_dir, exist_ok=True)
        self.out_path = os.path.join(out_dir, "server.out")
        self.err_path = os.path.join(out_dir, "server.err")
        self._out = open(self.out_path, "w")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "imaginary_tpu_torch", "--addr", "127.0.0.1",
             "--port", str(self.port), "--device", device, "--log-level", "error"] + flags,
            cwd=spec.ROOT, stdout=self._out, stderr=self._err)
        self.boot_timeout_s = boot_timeout_s

    def wait_listening(self) -> None:
        deadline = time.monotonic() + self.boot_timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"the server exited {self.proc.returncode}: "
                                   f"{self._tail(self.err_path)}")
            with open(self.out_path) as f:
                if LISTENING in f.read():
                    return
            time.sleep(0.05)
        raise RuntimeError(f"the server did not listen within {self.boot_timeout_s} s")

    @staticmethod
    def _tail(path: str, n: int = 2000) -> str:
        with open(path) as f:
            return f.read()[-n:]

    def get(self, path: str, timeout: float = 30.0) -> bytes:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=timeout) as r:
            return r.read()

    def metrics(self) -> dict:
        return parse_metrics(self.get("/metrics").decode())

    def cpu_seconds(self) -> float:
        return proc_cpu_seconds(self.proc.pid)

    def stop(self) -> None:
        """SIGTERM, then SIGKILL after 30 s; waits for the process."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._out.close()
        self._err.close()
