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
  :mod:`~repro_torch.serving.breaker` — the reference's metrics report,
  flight recorder and circuit breaker, kept as the port's own copies.

``launch/serve.py --qos`` is the command-line entry point.  The
reference's fault injector (``faults.py``, ``--chaos``) comes in a later
slice (ROADMAP Queue 1 item 3(b)); the scheduler's ``faults`` argument is
a duck-typed hook until then.
"""
from repro_torch.serving.breaker import BreakerPolicy, CircuitBreaker
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
    validate_trace,
)

__all__ = [
    "DEFAULT_CAPS", "GridCell", "GridColumn", "PinnedPool", "PlanGrid",
    "batch_buckets", "bucket_for", "cover_buckets", "validate_buckets",
    "PlanLadder", "PlanTier", "build_ladder", "cap_plan", "save_ladder",
    "load_ladder", "Log2Histogram", "MetricsWriter", "NULL_TRACER",
    "NullTracer", "ServeMetrics", "Tracer", "percentiles", "validate_trace",
    "QosPolicy", "TierSelector", "BandElasticScheduler", "BreakerPolicy",
    "CircuitBreaker", "DeadlineExceeded", "RequestFailed",
    "SchedulerClosed", "ServeRequest", "ServiceUnavailable",
]
