"""Fleet tier of the port: the data plane every local worker process of a
`--workers N` server shares (the port's copy of `imaginary_tpu/fleet/`).

`web/workers.py` is the control plane (the SO_REUSEPORT supervisor,
liveness probing, rolling restarts). Here: the crash-safe mmap result
cache with its worker-fencing epoch table, claim table and qos table
(`shmcache.py`), the forward hop between workers (`ipc.py`), and digest
ownership, fleet singleflight and the fleet qos handle (`ownership.py`).
Everything here is stdlib-only: the supervisor attaches it without
initialising the card.
"""
