"""Command-line entry points, and the mesh launchers."""
from repro_torch.launch.mesh import (  # noqa: F401
    make_axis_rules,
    make_mesh_from_config,
    make_production_mesh,
    make_test_mesh,
    run_local,
)
