"""The reference's six example scripts (``examples/`` at the repo root) on
the port.

Each module keeps its script's flags and defaults, adds ``--device``
(default: the CUDA device, where the hand-written kernels run; ``cpu``
runs their plain versions; without CUDA and without ``--device cpu`` it
raises), and builds the entry points' arguments through the port's own
``launch.serve.parse_args`` / ``launch.train.parse_args``:

* ``quickstart``: the paper's small ResNet converted once, its logits on
  step-4 JPEG coefficients against the spatial ones;
* ``convert_pretrained``: a torch-layout state dict imported, converted,
  verified, its fused plan saved, restored and served;
* ``serve_jpeg``: the plan-backed slot server with autotuned bands;
* ``serve_qos``: the band-elastic QoS runtime, narrated;
* ``train_e2e``: the JPEG-domain ResNet trained with checkpoints and
  resume;
* ``lm_train``: a reduced language model trained on the synthetic corpus.

Run one as ``python -m repro_torch.examples.<name> [--device cpu]``, or
call its ``main(argv=None)``: it returns what it printed, with ``ok``, the
outcome of the script's own check; from the command line a failed check
exits non-zero.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable

__all__ = ["EXAMPLES", "add_device", "run"]

EXAMPLES = ("quickstart", "convert_pretrained", "serve_jpeg", "serve_qos",
            "train_e2e", "lm_train")


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")


def run(main: Callable[[], dict]) -> None:
    """``main()`` as a command: exit non-zero unless its report is ok."""
    out = main()
    if not out.get("ok"):
        sys.exit(f"{main.__module__}: the example's check failed")
