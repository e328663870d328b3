"""Multi-process serving: the --workers N supervisor (the port's copy of
`imaginary_tpu/web/workers.py`).

The reference gets multi-core scaling from Go's per-request goroutines
(ref: server.go:110-166) and scales further with N identical instances
behind a balancer (README.md:248-269). A Python process is GIL-bound for
everything outside the GIL-released codec and kernel calls, so the
equivalent is N worker PROCESSES accepting on one port through
SO_REUSEPORT: the kernel balances connections, there is no proxy hop,
and a worker crash loses only its own in-flight requests.

How the workers share the card: a CUDA card takes many processes, each
with its own context, so every worker serves on the operator's device
(`--device`, IMAGINARY_TPU_DEVICE, `cuda` by default) and launches the
same hand-written kernels there; `--require-device` holds for every
worker. What lives once per card stays with one worker, the device
owner (fleet/ownership.py, the lowest live index under
--fleet-coherence): the lanes, the mesh and the device-resident frame
tier. Each extra worker costs the card one more CUDA context's memory,
and the governor's --pressure-hbm-mb reads its own process's
allocations, not the card's. The supervisor never touches the card: it
builds the kernel libraries with nvcc before the first spawn (no CUDA
context), so no worker's boot waits on a compile, and spawns workers as
fresh interpreters, never by fork.

The supervisor forwards SIGTERM/SIGINT so every worker runs its own
graceful drain, and supervises LIVENESS, not just exit status:

  * crash: an exited worker respawns under a rolling-hour budget with
    exponential backoff and FULL JITTER (a correlated fleet death must
    not respawn in lockstep);
  * hang: a worker whose process is alive but whose event loop is
    wedged never exits on its own. A probe thread samples the fleet's
    shared /health port with a per-request deadline and tracks when each
    worker index was last seen; a worker unseen past the liveness window
    is declared hung. Its REPLACEMENT spawns first (SO_REUSEPORT lets
    both bind), then the hung worker gets SIGTERM, a drain grace, and
    finally SIGKILL.

Worker fencing (fleet/shmcache.py): every (re)spawn is stamped with a
fleet-monotonic EPOCH, in the child's env and (with the shared cache
armed) in the shm header's epoch table, stamped BEFORE the process
spawns. A deposed worker that wakes up after its replacement exists
finds the table ahead of its own epoch: it may read the shared cache but
can no longer publish.

Rolling restarts: SIGHUP rolls the fleet one worker at a time with no
listener downtime:

    stamp epoch+1 -> spawn replacement -> wait for ITS /health
    -> SIGUSR1 old (close listener; in-flight + keep-alive continue)
    -> roll grace -> SIGTERM old (normal drain) -> next worker

Probe-by-sampling is the honest design for SO_REUSEPORT: no probe can
TARGET worker k, but every /health answer carries its worker index and
epoch, the kernel spreads fresh connections across listeners, and the
probe rate scales with the fleet size.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time

# env contract with cli.main: presence of WORKER_ENV marks a child (it
# must serve, never supervise) and carries its index; reuse_port comes
# from the child's own re-parsed --workers flag. WORKER_EPOCH_ENV
# carries the supervisor-stamped fencing epoch (0 = unsupervised).
WORKER_ENV = "IMAGINARY_TPU_WORKER"
WORKER_EPOCH_ENV = "IMAGINARY_TPU_WORKER_EPOCH"

# A worker that dies gets this many respawns per rolling hour before the
# supervisor gives up and shuts the fleet down (a crash loop at boot
# would otherwise spin forever — the backoff slows it, the budget ends
# it). Env-tunable (IMAGINARY_TPU_SUPERVISOR_RESTART_BUDGET) so tests
# and cautious deployments can tighten it.
MAX_RESTARTS_PER_WORKER = 5


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def worker_index() -> int:
    """This process's worker index; 0 when not running under a supervisor
    (a single-process server IS worker 0, the device owner)."""
    try:
        return int(os.environ.get(WORKER_ENV, "0"))
    except ValueError:
        return 0


def worker_epoch() -> int:
    """This process's supervisor-stamped fencing epoch; 0 when
    unsupervised (a standalone process stamps its own table entry 0 at
    shm create, so it is never fenced against itself)."""
    try:
        return int(os.environ.get(WORKER_EPOCH_ENV, "0"))
    except ValueError:
        return 0


def check_reuseport() -> None:
    """Refuse a multi-worker boot on hosts without SO_REUSEPORT, with a
    diagnosis — the alternative is N-1 workers crash-looping on a late
    bind failure after each pays a full torch import."""
    import socket

    if not hasattr(socket, "SO_REUSEPORT"):
        raise SystemExit(
            "imaginary-tpu: --workers > 1 needs SO_REUSEPORT and this "
            "platform's python does not expose it; run one worker per "
            "port behind a balancer instead")
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except OSError as e:
        raise SystemExit(
            "imaginary-tpu: --workers > 1 needs SO_REUSEPORT and this "
            f"kernel refused it ({e}); run one worker per port behind a "
            "balancer instead") from None
    finally:
        s.close()


def _backoff_delay(base: float, consec: int) -> float:
    """Respawn delay: exponential base with FULL jitter (uniform over
    [0, cap]). Several workers dying together — the common case: shared
    boot crash, host OOM sweep — then respawn DECORRELATED instead of
    slamming the card/origin in lockstep every 2^k seconds."""
    cap = min(30.0, base * (2.0 ** max(0, consec - 1)))
    return random.uniform(0.0, cap)


def _spawn(argv: list, idx: int, epoch: int = 0) -> subprocess.Popen:
    """A fresh interpreter serving as worker `idx`. It inherits the
    operator's device (every worker serves on the card; none is pinned to
    the CPU) and carries its index and epoch in the environment."""
    env = dict(os.environ)
    env[WORKER_ENV] = str(idx)
    env[WORKER_EPOCH_ENV] = str(epoch)
    return subprocess.Popen([sys.executable, "-m", "imaginary_tpu_torch.cli"] + argv,
                            env=env)


def prepare_kernels(device: str) -> None:
    """Build the kernel libraries ahead of the first spawn, for a CUDA
    device: nvcc only, no CUDA context in the supervisor, so every
    worker's boot loads a finished build instead of racing to compile.
    A build failure is left to the workers, whose first launch reports
    it."""
    if not device.startswith("cuda"):
        return
    from imaginary_tpu_torch.kernels import build

    try:
        build.build_all()
    except (RuntimeError, OSError) as e:
        print(f"imaginary-tpu supervisor: kernel prebuild failed ({e}); "
              "the workers build at first launch", file=sys.stderr)


def _open_health(health_url: str, timeout_s: float, ctx=None):
    import json
    import urllib.request

    req = urllib.request.Request(
        health_url, headers={"Connection": "close"})
    with urllib.request.urlopen(req, timeout=timeout_s, context=ctx) as r:
        return json.loads(r.read())


def metrics_url_for(health_url: str) -> str:
    """Derive the fleet /metrics scrape target from the /health probe
    URL by swapping the terminal path segment — on the parsed path
    component, not by blind suffix slicing of the whole URL, so a
    query string can't corrupt it and a probe URL whose path doesn't
    end in /health fails loudly at boot instead of leaving the admin
    plane silently scraping garbage (every worker reported as missed).
    The path prefix (--path-prefix) is preserved."""
    from urllib.parse import urlsplit, urlunsplit

    parts = urlsplit(health_url)
    if not parts.path.endswith("/health"):
        raise ValueError(
            f"cannot derive fleet /metrics URL from {health_url!r}: "
            "path does not end with /health")
    path = parts.path[: -len("/health")] + "/metrics"
    return urlunsplit(
        (parts.scheme, parts.netloc, path, parts.query, parts.fragment))


def _ssl_ctx_for(health_url: str):
    if not health_url.startswith("https:"):
        return None
    import ssl

    # a self-signed serving cert must not blind the prober
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


class _LivenessProbe:
    """Samples the fleet's shared /health port from a daemon thread and
    records, per worker index, when that worker last answered. The probe
    carries its own per-request deadline so a hung worker costs one
    timed-out sample, never a wedged prober."""

    def __init__(self, health_url: str, workers: int, interval_s: float,
                 timeout_s: float):
        self.health_url = health_url
        self.last_seen: dict = {}
        self._lock = threading.Lock()
        # more workers need more samples for the same per-worker coverage
        self._interval = max(0.2, interval_s / max(1, workers))
        self._timeout = timeout_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="itpu-supervisor-probe")
        self._thread.start()

    def _loop(self) -> None:
        ctx = _ssl_ctx_for(self.health_url)
        # Samples run CONCURRENTLY, one short-lived thread each: a hung
        # worker's listener keeps accepting (the backlog answers the
        # handshake, the wedged loop never answers the request), so a
        # serial prober would spend most of its life stalled on the very
        # worker it is trying to convict — and every HEALTHY worker would
        # go "unseen" too, cascading into false hang kills (measured:
        # one SIGSTOPped worker took the whole fleet's liveness down).
        inflight = threading.Semaphore(16)
        while not self._stop.wait(self._interval):
            if not inflight.acquire(blocking=False):
                continue  # stalled samples already saturate the cap
            threading.Thread(target=self._sample_once,
                             args=(ctx, inflight), daemon=True,
                             name="itpu-supervisor-sample").start()

    def _sample_once(self, ctx, inflight) -> None:
        try:
            body = _open_health(self.health_url, self._timeout, ctx)
            idx = int(body.get("worker", -1))
        except Exception:
            return  # timeouts/refusals are absence, not evidence
        finally:
            inflight.release()
        if idx >= 0:
            with self._lock:
                self.last_seen[idx] = time.monotonic()

    def seen_at(self, idx: int):
        with self._lock:
            return self.last_seen.get(idx)

    def forget(self, idx: int) -> None:
        """A respawned worker starts a fresh liveness clock."""
        with self._lock:
            self.last_seen.pop(idx, None)

    def close(self) -> None:
        self._stop.set()


class _ReadyWaiter:
    """Rapid-samples /health until worker `idx` answers at `epoch` or
    newer — the rolling restart's 'replacement is actually serving'
    gate. SO_REUSEPORT spreads samples across ALL listeners, so seeing
    the right (index, epoch) pair is the only targeted signal there is."""

    def __init__(self, health_url: str, idx: int, epoch: int,
                 timeout_s: float):
        self.event = threading.Event()
        self._stop = threading.Event()
        self._idx = idx
        self._epoch = epoch
        self._url = health_url
        self._timeout = timeout_s
        threading.Thread(target=self._loop, daemon=True,
                         name="itpu-supervisor-rollwait").start()

    def _loop(self) -> None:
        ctx = _ssl_ctx_for(self._url)
        while not self._stop.is_set():
            try:
                body = _open_health(self._url, self._timeout, ctx)
                if int(body.get("worker", -1)) == self._idx \
                        and int(body.get("epoch", 0)) >= self._epoch:
                    self.event.set()
                    return
            except Exception:  # itpu: allow[ITPU004] boot poll: refusals are just "not ready yet"
                pass
            time.sleep(0.15)

    def ready(self) -> bool:
        return self.event.is_set()

    def close(self) -> None:
        self._stop.set()


def run_supervisor(argv: list, workers: int, health_url: str = "",
                   fleet=None, roll_grace_s: float = 5.0,
                   admin_port: int = 0, host_info=None, peers: str = "",
                   peer_probe_interval: float = 2.0) -> int:
    """Spawn and babysit `workers` serving processes; returns an exit code.

    Lifecycle: SIGTERM/SIGINT here fans out to every worker (each drains
    in-flight requests, ref: server.go:144-165 semantics per process);
    the supervisor then waits for all of them. An unexpected worker death
    outside shutdown is respawned under the restart budget with
    full-jitter exponential backoff; with a `health_url`, a HUNG worker
    (alive but unseen by the liveness probe past the window) is replaced
    drain-aware: stamp + spawn the replacement, then SIGTERM -> grace ->
    SIGKILL the hung one. SIGHUP rolls the fleet one worker at a time
    (see the module docstring for the protocol). `fleet` is the shared
    cache (fleet/shmcache.ShmCache) whose epoch table fences deposed
    workers; None when --fleet-cache-mb is off (epochs still ride env).

    With `admin_port` > 0 (and a health_url to derive scrape targets
    from), the supervisor also serves the fleet observability plane on
    127.0.0.1:admin_port — the merged reset-corrected /metrics and the
    /fleetz process-table view (obs/aggregate.FleetAdmin).

    With `host_info` (the cross-host identity cli.main minted) and
    `peers`, the supervisor also runs the host-level gossip agent
    (fleet/multihost.py, stdlib only: it never touches the card): /fleetz
    grows a `host` block and answers ?scope=cluster with the merged
    cross-host view, and the host epoch is stamped into the shared cache's
    header.
    """
    check_reuseport()
    # -- the cross-host plane: the peer table and its gossip --------------
    peer_table = None
    gossip = None
    if peers and host_info:
        from imaginary_tpu_torch.fleet import multihost

        peer_table = multihost.PeerTable(multihost.parse_peers(peers))
        gossip = multihost.GossipAgent(
            peer_table, interval_s=max(0.05, peer_probe_interval)).start()
        if fleet is not None:
            # one header stamp deposes the whole previous host generation
            fleet.stamp_host_epoch(int(host_info.get("epoch", 0)))
    probe_interval = _env_f("IMAGINARY_TPU_SUPERVISOR_PROBE_INTERVAL", 2.0)
    probe_timeout = _env_f("IMAGINARY_TPU_SUPERVISOR_PROBE_TIMEOUT", 2.0)
    # 0 disables hang detection (probing still runs for logs/ops)
    liveness_timeout = _env_f("IMAGINARY_TPU_SUPERVISOR_LIVENESS_TIMEOUT", 30.0)
    # a fresh worker pays a torch import and a CUDA context before it can
    # answer
    boot_grace = _env_f("IMAGINARY_TPU_SUPERVISOR_BOOT_GRACE", 90.0)
    hang_grace = _env_f("IMAGINARY_TPU_SUPERVISOR_HANG_GRACE", 7.0)
    backoff_base = _env_f("IMAGINARY_TPU_SUPERVISOR_BACKOFF", 0.5)
    restart_budget = int(_env_f("IMAGINARY_TPU_SUPERVISOR_RESTART_BUDGET",
                                MAX_RESTARTS_PER_WORKER))

    procs: dict = {}
    spawn_t: dict = {}
    epochs: dict = {}
    restarts = {i: [] for i in range(workers)}
    # lifetime (not budget-windowed) restart counts, for /fleetz: an
    # operator asking "how churny has worker 2 been" wants the total
    restart_totals = {i: 0 for i in range(workers)}
    consec_restarts = {i: 0 for i in range(workers)}
    respawn_at: dict = {}  # idx -> monotonic time the backoff allows it
    terminating: list = []  # (proc, sigkill_deadline) for draining workers
    stopping = False
    roll_pending = False
    roll_queue: list = []
    roll = None  # the in-flight roll step's state dict
    epoch_counter = 0

    def next_epoch() -> int:
        nonlocal epoch_counter
        epoch_counter += 1
        return epoch_counter

    def handle_stop(signum, frame):
        nonlocal stopping
        stopping = True

    def handle_roll(signum, frame):
        nonlocal roll_pending
        roll_pending = True

    signal.signal(signal.SIGTERM, handle_stop)
    signal.signal(signal.SIGINT, handle_stop)
    signal.signal(signal.SIGHUP, handle_roll)

    probe = None

    def spawn(i: int) -> None:
        """Every (re)spawn: mint a fresh epoch, stamp the shm fence
        table FIRST (the predecessor — crashed, hung, or rolling out —
        is deposed from this instant), then exec the child."""
        e = next_epoch()
        epochs[i] = e
        if fleet is not None:
            fleet.stamp_epoch(i, e)
        if probe is not None:
            probe.forget(i)
        procs[i] = _spawn(argv, i, epoch=e)
        spawn_t[i] = time.monotonic()

    for i in range(workers):
        spawn(i)
    print(f"imaginary-tpu supervisor: {workers} workers "
          f"(pids {[p.pid for p in procs.values()]})")

    if health_url and liveness_timeout > 0:
        probe = _LivenessProbe(health_url, workers, probe_interval,
                               probe_timeout)

    admin = None
    if admin_port > 0 and health_url:
        # Fleet observability plane (obs/aggregate.py): merged /metrics
        # + /fleetz on loopback. The view closure reads the supervisor's
        # own state dicts — int/handle reads under the GIL, served from
        # the admin's request threads while this loop mutates them.
        from imaginary_tpu_torch.obs.aggregate import FleetAdmin

        metrics_url = metrics_url_for(health_url)
        _admin_ctx = _ssl_ctx_for(health_url)

        def _admin_fetch(url: str, timeout: float) -> str:
            # Connection: close — each scrape sample must land on a
            # FRESH SO_REUSEPORT pick, not ride a kept-alive pipe to
            # the same worker (and a TLS fleet needs the probe's
            # self-signed-tolerant context)
            import urllib.request

            req = urllib.request.Request(
                url, headers={"Connection": "close"})
            with urllib.request.urlopen(
                    req, timeout=timeout, context=_admin_ctx) as r:
                return r.read().decode("utf-8", "replace")

        def _admin_view() -> dict:
            now = time.monotonic()
            view = {}
            for i, p in list(procs.items()):
                seen = probe.seen_at(i) if probe is not None else None
                view[i] = {
                    "pid": p.pid,
                    "alive": p.poll() is None,
                    "epoch": epochs.get(i, 0),
                    "restarts": restart_totals.get(i, 0),
                    "spawned_s_ago": round(now - spawn_t.get(i, now), 1),
                    "liveness_age_s": round(now - seen, 1)
                    if seen is not None else None,
                }
            return view

        admin = FleetAdmin(admin_port, metrics_url, health_url,
                           _admin_view, fetch=_admin_fetch,
                           host_info=host_info,
                           peer_table=peer_table).start()
        print(f"imaginary-tpu supervisor: fleet admin plane on "
              f"127.0.0.1:{admin.port} (/metrics /fleetz)")

    def charge_restart(i: int, now: float) -> bool:
        """Book one restart against worker i's budget; False = exhausted.
        Planned rolls never charge — the budget meters FAILURES."""
        restarts[i] = [t for t in restarts[i] if now - t < 3600.0]
        if len(restarts[i]) >= restart_budget:
            return False
        restarts[i].append(now)
        restart_totals[i] += 1
        # survived long enough since its last (re)spawn? the crash loop
        # is over — start the backoff ladder from the bottom again
        if now - spawn_t.get(i, 0.0) > 60.0:
            consec_restarts[i] = 0
        consec_restarts[i] += 1
        return True

    def abort_roll(reason: str) -> None:
        """A replacement that never became ready must not take the old
        worker down with it: keep the old serving (re-stamp its epoch so
        it is unfenced again), discard the replacement, drop the roll."""
        nonlocal roll, roll_queue
        i = roll["idx"]
        print(f"imaginary-tpu supervisor: roll of worker {i} aborted "
              f"({reason}); old worker keeps serving", file=sys.stderr)
        repl = procs[i]
        if repl.poll() is None:
            try:
                repl.kill()
            except ProcessLookupError:
                pass
        procs[i] = roll["old"]
        epochs[i] = roll["old_epoch"]
        spawn_t[i] = roll["old_spawn_t"]
        if fleet is not None:
            fleet.stamp_epoch(i, roll["old_epoch"])
        if roll["waiter"] is not None:
            roll["waiter"].close()
        roll = None
        roll_queue = []

    exit_code = 0
    stop_deadline = None
    while True:
        if stopping:
            # Re-signal every sweep rather than once in the handler: a
            # SIGTERM that lands between a death check and its respawn
            # would otherwise leave the replacement un-signaled and the
            # supervisor waiting on it forever. SIGTERM is idempotent for
            # the workers (their stop event just sets again). A worker
            # whose drain wedges (e.g. stuck inside a hung accelerator
            # runtime) gets SIGKILLed after the drain window + margin —
            # without the escalation the supervisor would spin here until
            # the platform kills the whole cgroup.
            if stop_deadline is None:
                stop_deadline = time.monotonic() + 15.0  # 5 s drain + margin
                if roll is not None and roll["waiter"] is not None:
                    roll["waiter"].close()
            alive = [p for p in procs.values() if p.poll() is None]
            alive += [p for p, _ in terminating if p.poll() is None]
            if roll is not None and roll["old"].poll() is None:
                alive.append(roll["old"])
            if not alive:
                break
            hard = time.monotonic() > stop_deadline
            for p in alive:
                try:
                    p.send_signal(signal.SIGKILL if hard else signal.SIGTERM)
                except ProcessLookupError:
                    pass
            time.sleep(0.1)
            continue
        now = time.monotonic()
        # escalate draining workers: SIGTERM was sent when the
        # replacement spawned (hang) or the roll grace expired; past the
        # grace the kernel takes over
        for p, deadline in list(terminating):
            if p.poll() is not None:
                terminating.remove((p, deadline))
            elif now > deadline:
                try:
                    p.kill()
                except ProcessLookupError:
                    pass
        # -- rolling restart state machine (SIGHUP) -----------------------
        if roll_pending:
            roll_pending = False
            if not roll_queue and roll is None:
                roll_queue = list(range(workers))
                print("imaginary-tpu supervisor: SIGHUP — rolling "
                      f"{workers} workers (grace {roll_grace_s:.1f}s)",
                      file=sys.stderr)
        if roll is None and roll_queue:
            i = roll_queue.pop(0)
            old, old_epoch, old_spawn = procs[i], epochs[i], spawn_t[i]
            spawn(i)  # stamps epoch+1: the old worker is deposed NOW
            waiter = None
            if health_url:
                waiter = _ReadyWaiter(health_url, i, epochs[i],
                                      probe_timeout)
            roll = {"idx": i, "old": old, "old_epoch": old_epoch,
                    "old_spawn_t": old_spawn, "phase": "wait_ready",
                    "waiter": waiter, "deadline": now + boot_grace}
            print(f"imaginary-tpu supervisor: rolling worker {i} "
                  f"(epoch {old_epoch} -> {epochs[i]})", file=sys.stderr)
        elif roll is not None and roll["phase"] == "wait_ready":
            i = roll["idx"]
            ready = roll["waiter"].ready() if roll["waiter"] is not None \
                else now - spawn_t[i] > boot_grace
            if procs[i].poll() is not None:
                abort_roll(f"replacement exited {procs[i].poll()} before "
                           "ready")
            elif ready:
                # replacement serves; old stops ACCEPTING (SIGUSR1
                # closes its listener, SO_REUSEPORT routes new
                # connections next door) but keeps finishing in-flight
                # and keep-alive work through the grace
                try:
                    roll["old"].send_signal(signal.SIGUSR1)
                except ProcessLookupError:
                    pass
                roll["phase"] = "grace"
                roll["until"] = now + max(0.0, roll_grace_s)
                if roll["waiter"] is not None:
                    roll["waiter"].close()
            elif now > roll["deadline"]:
                abort_roll("replacement never reported ready within the "
                           "boot grace")
        elif roll is not None and roll["phase"] == "grace" \
                and now >= roll["until"]:
            # grace over: the old worker runs its normal shutdown drain
            # (app["draining"] 503 + Retry-After for stragglers, 5 s
            # in-flight completion), escalated like any hung drain
            try:
                roll["old"].send_signal(signal.SIGTERM)
            except ProcessLookupError:
                pass
            terminating.append((roll["old"], now + hang_grace + 6.0))
            done_idx = roll["idx"]
            roll = None
            print(f"imaginary-tpu supervisor: worker {done_idx} rolled",
                  file=sys.stderr)
        # Sweep deaths BEFORE any liveness break: if every worker dies
        # inside one interval (shared boot crash — bad mount, bad cert),
        # the respawn/budget logic must still run; breaking on "none
        # alive" first would report exit 0 for a fleet that never served.
        for i, p in list(procs.items()):
            rc = p.poll()
            if stopping:
                continue
            if rc is None:
                # alive — but is it SERVING? A worker the probe has not
                # seen for the whole liveness window (measured from its
                # last sighting, or from spawn + boot grace) is hung:
                # replace it drain-aware, then terminate it.
                if probe is None:
                    continue
                if roll is not None and roll["idx"] == i:
                    continue  # the roll's ready gate owns this index now
                seen = probe.seen_at(i)
                ref = seen if seen is not None else spawn_t[i] + boot_grace
                if now - ref < liveness_timeout:
                    continue
                if not charge_restart(i, now):
                    print(f"imaginary-tpu supervisor: worker {i} hung and "
                          "exceeded the restart budget; shutting down",
                          file=sys.stderr)
                    exit_code = 1
                    stopping = True
                    break
                print(f"imaginary-tpu supervisor: worker {i} (pid {p.pid}) "
                      f"unseen for {now - ref:.0f}s; presumed hung — "
                      "fencing, spawning replacement, then SIGTERM",
                      file=sys.stderr)
                # replacement FIRST: both bind via SO_REUSEPORT, so the
                # port keeps a live listener while the old worker drains.
                # spawn() stamps the fence table before the exec, so the
                # hung worker — should it ever wake — is already deposed.
                spawn(i)
                try:
                    p.send_signal(signal.SIGTERM)
                except ProcessLookupError:
                    pass
                terminating.append((p, now + hang_grace))
                continue
            # exited: respawn under budget, after the jittered backoff
            if i not in respawn_at:
                if not charge_restart(i, now):
                    print(f"imaginary-tpu supervisor: worker {i} exceeded "
                          "the restart budget; shutting down",
                          file=sys.stderr)
                    exit_code = rc or 1
                    stopping = True
                    break
                delay = _backoff_delay(backoff_base, consec_restarts[i])
                respawn_at[i] = now + delay
                print(f"imaginary-tpu supervisor: worker {i} (pid {p.pid}) "
                      f"exited {rc}; respawning in {delay:.1f}s",
                      file=sys.stderr)
            if now >= respawn_at[i]:
                respawn_at.pop(i, None)
                spawn(i)
        time.sleep(0.2)

    if admin is not None:
        admin.close()
    if gossip is not None:
        gossip.close()
    if probe is not None:
        probe.close()
    reap = list(procs.values()) + [p for p, _ in terminating]
    if roll is not None:
        reap.append(roll["old"])
    for p in reap:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return exit_code
