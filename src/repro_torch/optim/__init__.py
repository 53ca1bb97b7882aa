"""Optimizers, schedules and gradient transforms as functional updates over
trees of tensors (``repro_torch.tree``), with the reference package's
arithmetic."""
from repro_torch.optim.grad import (  # noqa: F401
    accumulate_microbatches,
    clip_by_global_norm,
    compress_grads,
    global_norm,
    value_and_grad,
)
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    OptState,
    adamw,
    lion,
    make_optimizer,
    sgd,
)
from repro_torch.optim.schedule import make_schedule  # noqa: F401
