"""Band-elastic serving runtime: the reference package's ``repro.serving``
on PyTorch, with one CUDA graph per grid cell on the card.

* :mod:`~repro_torch.serving.ladder` — one plan compiled into a ladder of
  band tiers, bit-identical to compiling each budget, with save/restore in
  the reference's manifest format;
* :mod:`~repro_torch.serving.grid` — the (batch bucket × band tier) grid
  of captured executors, pinned host staging and one shared graph memory
  pool;
* :mod:`~repro_torch.serving.scheduler` — the async scheduler: admission
  control, deadlines, a decode thread over the supervised ingest pool,
  fault containment;
* :mod:`~repro_torch.serving.qos` — the tier policy (queue depth and
  deadline slack, with hysteresis);
* :mod:`~repro_torch.serving.metrics`, :mod:`~repro_torch.serving.trace`,
  :mod:`~repro_torch.serving.breaker` — the reference's metrics report
  (and its periodic snapshot writer), flight recorder and circuit breaker,
  kept as the port's own copies; ``trace.device_profile`` is a
  ``torch.profiler`` window;
* :mod:`~repro_torch.serving.faults` — the reference's deterministic fault
  injector (corrupt bytes, a killed decode worker, executor faults), which
  drives the chaos drill.

``launch/serve.py --qos`` is the command-line entry point (``--chaos``,
``--metrics-out``, ``--jax-profile``).
"""
from repro_torch.serving.breaker import BreakerPolicy, CircuitBreaker
from repro_torch.serving.faults import FaultInjector, FaultSpec, InjectedFault
from repro_torch.serving.grid import (
    GridCell,
    GridColumn,
    PinnedPool,
    PlanGrid,
    batch_buckets,
    bucket_for,
    cover_buckets,
    validate_buckets,
)
from repro_torch.serving.ladder import (
    DEFAULT_CAPS,
    PlanLadder,
    PlanTier,
    build_ladder,
    cap_plan,
    load_ladder,
    save_ladder,
)
from repro_torch.serving.metrics import (
    Log2Histogram,
    MetricsWriter,
    ServeMetrics,
    percentiles,
)
from repro_torch.serving.qos import QosPolicy, TierSelector
from repro_torch.serving.scheduler import (
    BandElasticScheduler,
    DeadlineExceeded,
    RequestFailed,
    SchedulerClosed,
    ServeRequest,
    ServiceUnavailable,
)
from repro_torch.serving.trace import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    device_profile,
    jax_profile,
    validate_trace,
)

__all__ = [
    "DEFAULT_CAPS", "GridCell", "GridColumn", "PinnedPool", "PlanGrid",
    "batch_buckets", "bucket_for", "cover_buckets", "validate_buckets",
    "PlanLadder", "PlanTier", "build_ladder", "cap_plan", "save_ladder",
    "load_ladder", "Log2Histogram", "MetricsWriter", "NULL_TRACER",
    "NullTracer", "ServeMetrics", "Tracer", "device_profile", "jax_profile",
    "percentiles", "validate_trace", "QosPolicy", "TierSelector",
    "BandElasticScheduler", "BreakerPolicy", "CircuitBreaker",
    "DeadlineExceeded", "FaultInjector", "FaultSpec", "InjectedFault",
    "RequestFailed", "SchedulerClosed", "ServeRequest", "ServiceUnavailable",
]
