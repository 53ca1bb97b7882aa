"""Command-line entry points (``train``, ``serve``, ``inspect``,
``dryrun``), the mesh launchers, and the step builders (``steps``).  The
reference's ``hlo_analysis.py`` reads a compiled step's HLO text; its
counterpart here is ``introspect/opcount.py``, which counts a step's ops
as they run (the dry-run runs them on fake tensors)."""
from repro_torch.launch.mesh import (  # noqa: F401
    make_axis_rules,
    make_mesh_from_config,
    make_production_mesh,
    make_test_mesh,
    run_local,
)
