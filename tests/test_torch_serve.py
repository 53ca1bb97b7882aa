"""The port's server on the CPU: the command line prints its JSON report,
refuses to run without CUDA unless ``--device cpu`` is given, and every
served batch agrees with the reference package's plan walk on the same
weights and bytes."""
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.codec import ingest as ref_ing
from repro.core import dispatch as ref_dsp
from repro.core import plan as ref_plan
from repro.core import resnet as ref_resnet
from repro_torch.configs import reduced_config
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan as planlib
from repro_torch.launch import serve

# one intra-op thread: the suite runs in parallel workers beside
# wall-clock tests of the reference package
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMD = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
       "jpeg-resnet", "--reduced", "--ingest", "bytes", "--batch", "2",
       "--requests", "2"]


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run(CMD + args, env=env, capture_output=True,
                          text=True, timeout=300, cwd=ROOT)


def test_cli_prints_report_on_cpu():
    proc = _run(["--device", "cpu", "--max-new", "2"])
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["completed"] == 2 and report["images"] >= 2
    assert report["images_per_s"] > 0 and report["device"] == "cpu"
    assert report["plan"]["fused_blocks"] == ["s0b0", "s1b0"]
    assert report["plan"]["fallback_steps"] == ["s2b0"]


def test_cli_without_cuda_raises():
    proc = _run([])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not proc.stdout.strip().startswith("{")


@pytest.mark.parametrize("compiled", [True, False])
def test_served_batches_match_reference_package(compiled):
    """Both walks, fed the synthetic byte stream: the logits of every
    batch equal the reference package's plan walk (same weights handed
    over as numpy, same bytes ingested by its codec) within 2e-4, and the
    port's plain runtime path on the same plan."""
    args = serve.parse_args(["--arch", "jpeg-resnet", "--reduced",
                             "--device", "cpu", "--ingest", "bytes",
                             "--bands", "48",
                             "--batch", "2", "--requests", "3",
                             "--max-new", "1"]
                            + ([] if compiled else ["--no-compiled"]))
    cfg = reduced_config("jpeg-resnet")
    plan, cp, info = serve.prepare_plan(args, cfg, torch.device("cpu"))
    seen = []
    report = serve.serve_jpeg_resnet(
        args, prepared=(plan, cp, info),
        on_batch=lambda x, lg: seen.append((x.clone(), lg.clone())))
    assert report["completed"] == 3 and len(seen) == report["batches"]

    def np_tree(tree):
        if isinstance(tree, dict):
            return {k: np_tree(v) for k, v in tree.items()}
        return jnp.asarray(tree.numpy())

    # rebuild the reference plan from the port's own weights
    gen = torch.Generator().manual_seed(args.seed)
    from repro_torch.core import resnet
    from repro_torch.configs.jpeg_resnet import spec_of
    params, state = resnet.init_resnet(gen, spec_of(cfg), device="cpu")
    ref = ref_plan.build_plan(
        np_tree(params), np_tree(state),
        ref_resnet.ResNetSpec(widths=cfg.widths, num_classes=10),
        dispatch=ref_dsp.DispatchConfig(path="reference", bands=48))
    requests = serve.jpeg_byte_requests(args.batch, cfg, args.seed)
    for step, (x, lg) in enumerate(seen, start=1):
        coef, _ = ref_ing.ingest_batch(requests(step), grid=(4, 4),
                                       parallel=False)
        want = np.asarray(ref_plan.apply_plan(ref, jnp.asarray(coef)))
        np.testing.assert_allclose(lg.numpy(), want, atol=2e-4)
        plain_cfg = dsp.DispatchConfig(path="reference", bands=48)
        again = (planlib.apply_compiled_packed(cp, x, plain_cfg) if compiled
                 else planlib.apply_plan(plan, x, plain_cfg))
        np.testing.assert_allclose(lg.numpy(), again.numpy(), atol=1e-5)


@pytest.mark.parametrize("requests,batch,max_new", [(3, 2, 1), (16, 4, 2),
                                                    (5, 8, 3)])
def test_slot_schedule_serves_every_request_once(requests, batch, max_new):
    """Every request completes exactly once, after 1..max_new images from
    its slot; no more slots start than requests; the draws repeat for a
    seed."""
    steps = serve.slot_schedule(requests, batch, max_new, seed=0)
    assert steps == serve.slot_schedule(requests, batch, max_new, seed=0)
    assert all(1 <= n <= min(batch, requests) for n, _ in steps)
    assert sum(len(done) for _, done in steps) == requests
    images = sum(n for n, _ in steps)
    assert requests <= images <= requests * max_new
    if max_new == 1:
        assert all(len(done) == n for n, done in steps)
