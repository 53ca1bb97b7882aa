"""Model conversion from a foreign (torch-layout) checkpoint.

Simulates a pretrained spatial ResNet exported as a ``{name: array}``
state dict (OIHW convs, BN running stats), maps it into the port via
``from_torch_layout``, verifies JPEG-domain equivalence (the paper's
"apply pretrained spatial domain networks to JPEG images" workflow) and
finishes with the deployment step: save the fused ``InferencePlan`` and
serve from the restored artifact (convert once, load anywhere).  The port
of the reference's ``examples/convert_pretrained.py``.

    python -m repro_torch.examples.convert_pretrained [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convert, jpeg, plan as planlib, resnet
from repro_torch.examples import add_device, run


def export_torch_style(params, state, spec) -> dict[str, np.ndarray]:
    """What a torch training run would hand us."""
    def a(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    t = {"stem.weight": a(params["stem"]["kernel"])}

    def bn(src, dst):
        t[f"{dst}.weight"] = a(params[src]["gamma"])
        t[f"{dst}.bias"] = a(params[src]["beta"])
        t[f"{dst}.running_mean"] = a(state[src]["mean"])
        t[f"{dst}.running_var"] = a(state[src]["var"])

    bn("stem_bn", "stem_bn")
    for name, _, _, _ in resnet._stages(spec):
        t[f"{name}.conv1.weight"] = a(params[name]["conv1"])
        t[f"{name}.conv2.weight"] = a(params[name]["conv2"])
        if "proj" in params[name]:
            t[f"{name}.proj.weight"] = a(params[name]["proj"])
        bn(f"{name}_bn1", f"{name}.bn1")
        bn(f"{name}_bn2", f"{name}.bn2")
    t["head.weight"] = a(params["head"]["w"]).T
    t["head.bias"] = a(params["head"]["b"])
    return t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    spec = resnet.ResNetSpec(widths=(16, 32, 64), num_classes=10)
    params, state = resnet.init_resnet(torch.Generator().manual_seed(42),
                                       spec, device="cpu")
    tensors = export_torch_style(params, state, spec)
    print(f"imported {len(tensors)} tensors from the torch-layout dict")

    p2, s2 = convert.from_torch_layout(tensors, spec, device=device)
    x = torch.randn((4, 3, 32, 32),
                    generator=torch.Generator().manual_seed(1)) * 0.4
    x = x.to(device)
    model, dev = convert.convert_and_verify(p2, s2, spec, x)
    print(f"converted; spatial/JPEG deviation = {dev:.2e}")
    with torch.inference_mode():
        coef = jpeg.jpeg_encode(x, quality=spec.quality,
                                scaled=True).movedim(1, 3)
        logits = model(coef)
    predictions = logits.argmax(-1).tolist()
    print("JPEG-domain predictions:", predictions)

    # save-plan -> serve-plan: persist the fused operators through the
    # checkpoint manager; a serving process restores them and never
    # re-explodes (launch/serve.py --arch jpeg-resnet does this too).
    with tempfile.TemporaryDirectory() as plan_dir:
        planlib.save_plan(model.plan, plan_dir)
        served = planlib.load_plan(plan_dir, device=device)
        with torch.inference_mode():
            restored = planlib.apply_plan(served, coef)
        same = bool(torch.equal(logits, restored))
        print(f"restored plan from {plan_dir}; bit-identical logits: {same}")
        print("per-layer bands:", served.bands)
    return {"device": str(device), "tensors": len(tensors),
            "deviation": dev, "predictions": predictions,
            "bit_identical": same, "bands": dict(served.bands), "ok": same}


if __name__ == "__main__":
    run(main)
