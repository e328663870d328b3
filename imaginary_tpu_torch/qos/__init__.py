"""Multi-tenant quality of service (the port's copy of `imaginary_tpu/qos/`;
its fleet-wide qos, `--fleet-qos`, waits for the fleet's port).

The serving path used to treat every request identically: one FIFO intake
queue in the micro-batch executor and one method-keyed GCRA throttle. At
scale that is exactly the layer SLOs die in — one hog tenant submitting 4K
enlarges occupies the whole queue and every other client's p99 rides the
hog's backlog. This package threads TENANT identity and a PRIORITY CLASS
through the whole request path, in the tradition of SLO-aware serving
schedulers (Clipper, Crankshaw et al., NSDI '17) and priority-based
overload control (DAGOR, Zhou et al., SoCC '18):

  tenancy.py   who is asking: API-key/IP -> TenantSpec lookup table
               (--qos-config), stamped onto the request trace
  limiter.py   per-tenant GCRA rate limiting (rekeys the web layer's
               existing limiter store by tenant)
  sched.py     class-aware executor intake: strict priority with aging
               (weighted-fair interleave, no starvation), EDF within a
               class, per-tenant in-queue share caps
  shed.py      class-based overload shedding thresholds + the qos
               counters /health and /metrics surface

Everything defaults OFF: without --qos-config there is a single default
tenant, the executor keeps its plain FIFO queue, and responses are
byte-identical to the build without qos (tests/test_torch_qos.py pins the
parity).
"""

from __future__ import annotations

# Priority classes, HIGHEST priority first. Index order is the dispatch
# and shed order everywhere: the scheduler serves lower indices first and
# the overload gate sheds higher indices first (lowest class sheds first).
CLASSES = ("interactive", "standard", "batch")
CLASS_INDEX = {name: i for i, name in enumerate(CLASSES)}
DEFAULT_CLASS = "standard"
