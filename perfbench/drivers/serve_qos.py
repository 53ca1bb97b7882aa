"""Drive the port's band-elastic server: ``serving.BandElasticScheduler``
over a ladder compiled from the plan at the cell's band count.

Set-up makes the weights and the traffic from the seed, builds the plan
(``core.plan.build_plan``, batch norm fused, every layer at ``bands``) and
its one-tier ladder (``serving.build_ladder``: the compiled schedule, one
CUDA graph per batch bucket), captures the grid for the cell's request
kind, and sends a full batch of each image through the server.  The
window is the traffic mix's.  Afterwards every answer that came is held
against the plain reference's logits for its image.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import devtrace, spec, weights, work
from perfbench.reference import jpeg
from perfbench.reference import resnet as refnet
from perfbench.traffic import images, jfif

#: images the reference runs at a time
REF_BLOCK = 8


def _payloads(cfg: dict, traffic: dict, seed: int, device):
    """``(payloads, reference inputs (n, bh, bw, C, 64) on the host)``: the
    cell's distinct images as what a client sends (``coefficients``: the
    quantized coefficients in the network's convention, ``k / 128`` under
    the canonical table; ``bytes``: baseline JFIF files at the quality
    mix) and as the orthonormal coefficients the reference reads."""
    n = int(traffic["images"])
    imgs, _ = images.synth(seed, "images", n, cfg["image_size"],
                           cfg["in_channels"], cfg["num_classes"], device)
    if traffic["payload"] == "coefficients":
        q = np.tile(jpeg.canonical_table(cfg["quality"]), (n, 1))
        k = images.quantize(imgs, q)
        pay = (k / 128.0).float().cpu().numpy()
        payloads = [pay[i] for i in range(n)]
    else:
        q = np.stack([jpeg.ijg_table(v)
                      for v in images.qualities(n, traffic["qualities"])])
        k = images.quantize(imgs, q)
        kh = k.cpu().numpy().astype(np.int64)
        payloads = [jfif.encode(kh[i].transpose(2, 0, 1, 3), q[i])
                    for i in range(n)]
    return payloads, images.network_coefficients(k, q).cpu()


def _banded_launches(compiled, image_size: int):
    """``[(rows, out_rows, noff, cin, w_in, cout, w_out)]``, rows per image,
    of every banded-conv launch one forward of ``compiled`` makes: the
    convs of fused blocks, and those of per-layer blocks whose operator
    runs on the ``cuda`` path (the stem's products are plain matmuls)."""
    out = []
    g = image_size // jpeg.BLOCK
    for blk in compiled.blocks:
        if blk.kind == "fused":
            s = blk.conv1.stride
            convs = [(slot, pc.ndy * pc.ndx, pc.cin, pc.w_in, pc.cout,
                      pc.w_out) for slot, pc in (("conv1", blk.conv1),
                                                 ("proj", blk.proj),
                                                 ("conv2", blk.conv2))
                     if pc is not None]
        else:
            s = blk.ops["conv1"].stride
            convs = [(slot, *(op.xi.shape[0] * op.xi.shape[1],
                              *op.xi.shape[2:]))
                     for slot, op in blk.ops.items()
                     if op.path == "cuda" and op.xi is not None]
        for slot, noff, cin, w_in, cout, w_out in convs:
            rows = (g // s) ** 2 if slot == "conv2" else g * g
            out.append((rows, (g // s) ** 2, noff, cin, w_in, cout, w_out))
        g //= s
    return out


def reference_logits(params, state, cfg: dict, coef: torch.Tensor,
                     bands: int, device, precision: str = "fp32"):
    """The plain reference's logits of ``coef`` (host), in blocks."""
    out = []
    with torch.no_grad():
        for i in range(0, coef.shape[0], REF_BLOCK):
            x = coef[i: i + REF_BLOCK].to(device)
            out.append(refnet.forward(
                params, state, x, widths=cfg["widths"],
                blocks_per_stage=cfg["blocks_per_stage"], bands=bands,
                precision=precision).double().cpu())
    return torch.cat(out)


def logit_gaps(served: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per answer: the largest logit difference over the reference's
    largest logit magnitude."""
    return (served - ref).abs().amax(-1) / ref.abs().amax(-1)


class Server:
    """The program set up for a serving cell from the seed and warmed: the
    plan at the cell's bands, its one-tier ladder, the scheduler with its
    grid captured for the cell's request kind, and the traffic's
    payloads.  ``send(k)`` submits request ``k``."""

    def __init__(self, cell: dict, seed: int, device, tracer=None):
        from repro_torch import serving
        from repro_torch.core import dispatch as dispatchlib
        from repro_torch.core import plan as planlib
        from repro_torch.core.resnet import ResNetSpec

        #: seconds of each part of set-up, in order
        self.setup_parts: dict[str, float] = {}
        lap = [time.monotonic()]

        def part(name: str) -> None:
            lap.append(time.monotonic())
            self.setup_parts[name] = lap[-1] - lap[-2]

        wl, cfg = cell["workload"], cell["config_data"]
        sv, traffic = wl["serve"], wl["traffic"]
        self.kind, self.bands = traffic["payload"], int(sv["bands"])
        batch = int(sv["batch"])
        self.params, self.state = weights.resnet(cfg, seed, device)
        rspec = ResNetSpec(in_channels=cfg["in_channels"],
                           widths=tuple(cfg["widths"]),
                           blocks_per_stage=cfg["blocks_per_stage"],
                           num_classes=cfg["num_classes"],
                           quality=cfg["quality"], phi=cfg["asm_phi"])
        with torch.no_grad():
            plan = planlib.build_plan(
                self.params, self.state, rspec, bands=self.bands,
                dispatch=dispatchlib.DispatchConfig(bands=self.bands))
            ladder = serving.build_ladder(
                plan, caps=(None,), image_size=cfg["image_size"],
                buckets=serving.cover_buckets(tuple(sv["buckets"]), batch))
        part("weights_plan_ladder")
        self.launches = _banded_launches(ladder.tiers[0].compiled,
                                         cfg["image_size"])
        nb = cfg["image_size"] // jpeg.BLOCK
        self.sched = serving.BandElasticScheduler(
            ladder, batch=batch, metrics=serving.ServeMetrics(),
            max_pending=int(sv["max_pending"]), grid=(nb, nb),
            channels=cfg["in_channels"], tracer=tracer)
        try:
            self.sched.warmup(kinds=(self.kind,))
            part("grid_capture")
            self.payloads, self.ref_in = _payloads(cfg, traffic, seed,
                                                   device)
            part("payloads")
            # every image once through the whole path, in full batches:
            # the decode pool's workers, pinned staging and the graphs
            # are warm
            warm = [self.send(i)
                    for i in range(max(len(self.payloads), batch))]
            for r in warm:
                r.result(timeout=600)
            part("warm_requests")
        except BaseException:
            self.close()
            raise

    def send(self, k: int):
        return self.sched.submit(self.payloads[k % len(self.payloads)],
                                 kind=self.kind)

    def close(self) -> None:
        """Stop the scheduler and the decode pool; the program's state
        goes with them."""
        try:
            self.sched.close()
        finally:
            if self.kind == "bytes":
                from repro_torch.codec import ingest

                ingest.shutdown_pool()
        self.sched = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def summarize(rec: dict, seconds: float, grace_s: float) -> dict:
    """The window's end-to-end numbers: answers in the window per second,
    and the 95th percentile latency over every request sent, from when it
    was due; a request not answered counts as ``seconds + grace_s``."""
    t0, t1 = rec["t0"], rec["t1"]
    cap = seconds + grace_s
    lat = [cap if d is None else d - u
           for u, d in zip(rec["due"], rec["done"])]
    done = sum(1 for d in rec["done"] if d is not None and d <= t1)
    return {"images_per_s": done / (t1 - t0),
            "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3
            if lat else cap * 1e3}


def run(ctx) -> dict:
    from repro_torch import serving

    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    wl, cfg = cell["workload"], cell["config_data"]
    traffic = wl["traffic"]
    gen = spec.load_module("traffic", traffic["kind"])
    clock_t0: list[float] = []
    tracer = None
    if ctx.trace:
        def clock():
            t = ctx.clock()
            if not clock_t0:
                clock_t0.append(t)
            return t
        tracer = serving.Tracer(capacity=1 << 23, clock=clock)
    server = Server(cell, seed, dev, tracer)
    try:
        ctx.setup_done()
        anchor = devtrace.anchor()
        with devtrace.window(ctx.trace, dev) as trace:
            traced = [ctx.clock()]
            rec = gen.run(server.send, traffic, seed, ctx.seconds)
            traced.append(ctx.clock())
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        spans = tracer.events() if tracer is not None else []
    finally:
        server.close()

    t0, t1 = rec["t0"], rec["t1"]
    ok = [i for i, a in enumerate(rec["answer"]) if a is not None]
    e2e = summarize(rec, ctx.seconds, gen.GRACE_S)

    n_img = len(server.payloads)
    ref = reference_logits(server.params, server.state, cfg, server.ref_in,
                           server.bands, dev)
    gap = 0.0
    if ok:
        got = torch.as_tensor(np.stack([np.asarray(rec["answer"][i])
                                        for i in ok]), dtype=torch.float64)
        gap = float(logit_gaps(got, ref[[i % n_img for i in ok]]).max())
    n = len(rec["due"])
    limits = wl["correct"]
    checks = {"logit_gap": (gap, limits["logit_gap"]),
              "answers_missing": (n - len(ok), 0)}

    tr_t0 = clock_t0[0] if clock_t0 else 0.0
    record = {
        "window_s": t1 - t0,
        "images_done": e2e["images_per_s"] * (t1 - t0),
        "flops_per_image": work.spatial_flops(cfg),
        "batch": int(wl["serve"]["batch"]),
        "due": rec["due"], "sent": rec["sent"],
        # the program's spans: (track, name, start, end, args), monotonic s
        "spans": [(tk, nm, tr_t0 + ts, tr_t0 + ts + d, args)
                  for ph, tk, _tid, nm, ts, d, args in spans if ph == "X"],
        "window": (t0, t1),
        "traced": tuple(traced),
        "trace": trace,
        "banded_launches": server.launches,
    }
    return {"e2e": e2e, "attempted": n,
            "failed": n - len(ok), "memory_peak_bytes": peak,
            "checks": checks, "record": record,
            "setup_parts": server.setup_parts,
            # what the host was doing: the program's spans but the
            # requests' own (a queued request does no work)
            "host_spans": [(f"{tk}/{nm}", devtrace.wall_ns(a, anchor),
                            devtrace.wall_ns(b, anchor))
                           for tk, nm, a, b, _ in record["spans"]
                           if tk != "request"]}
