"""Drive the port's training step: ``launch/train.py:make_step`` over
``build_model(cfg).loss_fn`` (the JPEG-domain forward through
``core/resnet.py:jpeg_apply``), global-norm clipping and the optimizer.

Set-up makes the weights and the batches on the device from the seed and
builds one step object; its first three steps, on three different batches
through the window's own call, are the warm-up and what the reference
follows.  The window keeps stepping the same object over the batches,
cycled.  Afterwards the reference runs the first three steps from the same
weights, and the losses, the first gradient (as the optimizer's first
moment holds it) and the parameters' change are compared.
"""
from __future__ import annotations

import torch

from perfbench.lib import devtrace, spec, weights, work
from perfbench.reference import jpeg
from perfbench.reference import train as reftrain

#: steps the reference follows
CHECKED_STEPS = 3


class Trainer:
    """The step under test and its state: ``step(batch)`` advances it."""

    def __init__(self, model, optimizer, schedule, clip, bundle):
        from repro_torch.launch.train import make_step

        self.step_fn = make_step(model, optimizer, schedule, clip)
        self.params = bundle
        self.opt_state = optimizer.init(bundle)

    def step(self, batch):
        self.params, self.opt_state, loss, _ = self.step_fn(
            self.params, self.opt_state, batch)
        return loss


def _flat(tree) -> dict:
    return {p: t.detach().clone() for p, t in reftrain.leaves(tree)}


def run(ctx) -> dict:
    from repro_torch.configs import ModelConfig
    from repro_torch.core import dispatch as dispatchlib
    from repro_torch.models.registry import build_model
    from repro_torch.optim import make_optimizer, make_schedule

    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    wl, cfg = cell["workload"], cell["config_data"]
    tr, hp = wl["traffic"], wl["train"]
    gen = spec.load_module("traffic", tr["kind"])

    params, state = weights.resnet(cfg, seed, dev)
    bundle = {"params": params, "bn_state": state}
    start = _flat(bundle)
    batches = gen.batches(cfg, tr, seed, dev)
    mcfg = ModelConfig(name=cfg["name"], family="jpeg_resnet",
                       image_size=cfg["image_size"],
                       in_channels=cfg["in_channels"],
                       widths=tuple(cfg["widths"]),
                       blocks_per_stage=cfg["blocks_per_stage"],
                       num_classes=cfg["num_classes"],
                       asm_phi=cfg["asm_phi"], dtype=cfg["dtype"])
    model = build_model(mcfg, dispatch=dispatchlib.DispatchConfig(
        bands=int(hp["bands"])))
    opt = make_optimizer(hp["optimizer"], b1=hp["b1"], b2=hp["b2"],
                         eps=hp["eps"], weight_decay=hp["weight_decay"])
    sched = make_schedule("constant", hp["lr"], 0, 1)
    trainer = Trainer(model, opt, sched, hp["clip"], bundle)

    losses, grad1 = [], None
    for i in range(CHECKED_STEPS):
        losses.append(float(trainer.step(batches[i])))
        if i == 0:
            # the clipped gradient, as AdamW's first moment holds it
            grad1 = {p: m / (1.0 - hp["b1"]) for p, m in
                     _flat(trainer.opt_state.inner["m"]).items()}
    after = _flat(trainer.params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    ctx.setup_done()
    n_b = len(batches)
    with devtrace.window(ctx.trace, dev) as trace:
        t0 = ctx.clock()
        end = t0 + ctx.seconds
        steps = 0
        while ctx.clock() < end:
            trainer.step(batches[(CHECKED_STEPS + steps) % n_b])
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = ctx.clock()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    images_n = steps * int(tr["batch"])
    del trainer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    q = torch.as_tensor(jpeg.canonical_table(cfg["quality"]),
                        dtype=torch.float32, device=dev)
    ref = reftrain.steps(
        reftrain.rebuild(bundle, start), [(b["coefficients"] * q, b["labels"])
                 for b in batches[:CHECKED_STEPS]],
        widths=cfg["widths"], blocks_per_stage=cfg["blocks_per_stage"],
        lr=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
        weight_decay=hp["weight_decay"], clip=hp["clip"])
    limits = wl["correct"]
    got = reftrain.checks(
        (losses[0], ref["losses"][0]), (grad1, ref["grad1"]),
        ({p: after[p] - start[p] for p in start},
         {p: ref["params"][p] - start[p] for p in start}))
    checks = {k: (v, limits[k]) for k, v in got.items()}
    record = {"window_s": t1 - t0, "images_done": images_n,
              "flops_per_image": 3.0 * work.spatial_flops(cfg),
              "trace": trace}
    return {"e2e": {"train_images_per_s": images_n / (t1 - t0)},
            "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
            "checks": checks, "record": record, "host_spans": []}

