"""The port's six examples (``repro_torch.examples``) on the CPU, each
through its ``main`` at a small size (temporary directories), asserting
the check each script ends with: quickstart's logits within 1e-4 of the
spatial network's with the same top-1, the restored plan's logits bit
for bit, every request served, every healthy request served under the
QoS runtime and its fault drill, a falling loss (and a resume) for both
trainers.  The examples import neither JAX nor the reference package
(``tests/test_torch_imports.py`` walks them)."""
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.examples import EXAMPLES


def test_every_script_of_the_reference_has_its_example():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scripts = sorted(f[:-3] for f in os.listdir(os.path.join(root,
                                                             "examples"))
                     if f.endswith(".py"))
    assert sorted(EXAMPLES) == scripts


def test_quickstart():
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    assert out["ok"] and out["max_abs_diff"] <= quickstart.ATOL
    assert out["spatial_top1"] == out["jpeg_top1"]
    assert len(out["jpeg_top1"]) == 8


def test_convert_pretrained():
    from repro_torch.examples import convert_pretrained

    out = convert_pretrained.main(["--device", "cpu"])
    assert out["ok"] and out["bit_identical"]
    assert out["deviation"] <= 1e-4 and out["tensors"] > 0


def test_serve_jpeg_builds_then_restores_its_plan(tmp_path):
    from repro_torch.examples import serve_jpeg

    argv = ["--device", "cpu", "--batch", "1", "--requests", "2",
            "--max-images", "1", "--plan-dir", str(tmp_path / "plan")]
    first = serve_jpeg.main(argv)
    assert first["ok"] and first["built"] and first["completed"] == 2
    again = serve_jpeg.main(argv)
    assert again["ok"] and not again["built"]
    assert again["bands"] == first["bands"]


@pytest.mark.parametrize("chaos", (False, True), ids=("burst", "chaos"))
def test_serve_qos(tmp_path, monkeypatch, chaos):
    from repro_torch.examples import serve_qos

    argv = ["--device", "cpu", "--batch", "2", "--requests", "4",
            "--trace-out", str(tmp_path / "trace.json"),
            "--metrics-out", str(tmp_path / "metrics.prom")]
    if chaos:
        monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
        argv += ["--ingest", "bytes", "--chaos", "--requests", "8"]
    out = serve_qos.main(argv)
    assert out["ok"]
    assert out["healthy_completed"] == out["healthy_total"] > 0
    assert (tmp_path / "trace.json").exists()
    assert any("trace:" in line for line in out["narration"])
    if chaos:
        assert out["healthy_total"] < 8  # the drill corrupted some
        assert any("chaos:" in line for line in out["narration"])


def test_train_e2e_checkpoints_and_resumes(tmp_path):
    """Two steps at batch 4 (the reduced model's CPU step is seconds long;
    at this seed the second step's loss is below the first's), then the
    same directory to step 3: it resumes at step 2 and runs one step."""
    from repro_torch.examples import train_e2e

    argv = ["--device", "cpu", "--batch", "4", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    first = train_e2e.main(argv + ["--steps", "2"])
    assert first["ok"], first
    assert first["last_loss"] < first["first_loss"]
    assert first["resumed_from"] == 0 and first["final_step"] == 2
    assert first["plan_dir"]
    again = train_e2e.main(argv + ["--steps", "3"])
    assert again["resumed_from"] == 2 and again["steps_run"] == 1


def test_lm_train():
    from repro_torch.examples import lm_train

    out = lm_train.main(["--device", "cpu", "--steps", "3", "--batch", "2"])
    assert out["ok"], out
    assert out["steps_run"] == 3
    # the reference's reduced config on the CPU: heads of 20
    assert out["head_dim"] == reduced_config("smollm-360m").head_dim == 20


@pytest.mark.parametrize("arch", ("smollm-360m", "mixtral-8x7b"))
def test_the_trainer_widens_heads_the_kernel_does_not_take_on_the_card(arch):
    """``launch.train.card_config``: on a CUDA device a reduced config's
    heads of 20 train at the kernel's 64; heads the kernel takes, a full
    config's and every config on the CPU stay as they are."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import card_config

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    small = reduced_config(arch)
    assert card_config(small, cpu) is small
    full = get_config(arch)
    assert full.head_dim in (64, 128) and card_config(full, cuda) is full
    want = 64 if small.head_dim not in (64, 128) else small.head_dim
    assert card_config(small, cuda).head_dim == want


def test_an_example_without_cuda_raises(monkeypatch):
    import torch

    from repro_torch.examples import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])
