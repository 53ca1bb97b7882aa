"""Serve ``jpeg-resnet`` from JPEG bytes to logits.

Requests are real baseline JFIF files: the synthetic image corpus encoded
at a rotating quality mix (35/50/75/90, the true IJG tables), so every
batch exercises the per-image quantization normalization that lets one
plan serve all of them.  The host entropy-decodes and normalizes each
batch (``repro_torch.codec``, never a spatial decode), the device runs the
plan built in-process from seeded random weights: by default the compiled
schedule from the tile-packed stem input, with ``--no-compiled`` the
per-layer plan walk from 64-lane coefficients.

Requests run through a pool of ``--batch`` slots: each request classifies
a random number (1..``--max-new``) of images and a finished slot refills
from the pending queue.  The report is one JSON line: images/s, per-request
latency percentiles, the server's time split into host ingest and device
forward, and the plan's fused and per-layer split.  The server's clock
excludes the synthetic client's image synthesis and encoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jpeg-resnet \\
        --ingest bytes --bands 16 --batch 4 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jpeg-resnet \\
        --reduced --device cpu --batch 2 --requests 2

Runs on the CUDA device unless ``--device cpu`` is given; without CUDA it
raises.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.jpeg_resnet import spec_of
from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import plan as planlib
from repro_torch.core import resnet as resnetlib

__all__ = ["BYTE_QUALITIES", "jpeg_byte_requests", "prepare_plan",
           "serve_jpeg_resnet", "percentiles", "parse_args", "main"]

#: quality mix of the synthetic byte stream
BYTE_QUALITIES = (35, 50, 75, 90)


def jpeg_byte_requests(batch: int, cfg, seed: int) -> Callable[[int], list]:
    """``fn(step) -> list[bytes]``: ``batch`` synthetic images encoded to
    baseline JFIF at a rotating quality mix."""
    from repro_torch.codec import encode_pixels
    from repro_torch.data.synthetic import image_batch

    def from_synthetic(step: int) -> list[bytes]:
        b = image_batch(seed, step, batch, cfg.image_size, cfg.in_channels,
                        cfg.num_classes)
        out = []
        for i, img in enumerate(b["images"]):
            q = BYTE_QUALITIES[(step * batch + i) % len(BYTE_QUALITIES)]
            # the true IJG table (no dc_is_mean): foreign files do not
            # share the plan's DC convention; normalize rescales exactly
            qt = np.rint(dctlib.quantization_table(
                q, dc_is_mean=False)).astype(np.int64)
            out.append(encode_pixels(np.clip(img, -1.0, 127.0 / 128.0),
                                     qtable=qt))
        return out

    return from_synthetic


def percentiles(latencies_s) -> dict[str, float]:
    """Latency summary in milliseconds (p50/p95/p99, mean, max, n)."""
    xs = np.asarray(list(latencies_s), np.float64)
    if xs.size == 0:
        return {"n": 0}
    out = {f"p{p}_ms": float(np.percentile(xs, p)) * 1e3
           for p in (50, 95, 99)}
    out.update(mean_ms=float(xs.mean()) * 1e3, max_ms=float(xs.max()) * 1e3,
               n=int(xs.size))
    return out


def prepare_plan(args, cfg, device: torch.device):
    """Random weights from ``--seed`` → plan (and compiled schedule unless
    ``--no-compiled``) on ``device``.  Returns ``(plan, compiled, info)``."""
    spec = spec_of(cfg)
    gen = torch.Generator().manual_seed(args.seed)
    params, state = resnetlib.init_resnet(gen, spec, device)
    dcfg = dispatchlib.DispatchConfig(
        bands=dctlib.NFREQ if args.bands is None else args.bands)
    plan = planlib.build_plan(params, state, spec, dispatch=dcfg)
    compiled = planlib.compile_plan(plan) if args.compiled else None
    info: dict[str, Any] = {"bands": plan.bands, "compiled": args.compiled}
    if compiled is not None:
        info["path"] = compiled.meta["path"]
        info["fused_blocks"] = list(compiled.meta["fused"])
        info["fallback_steps"] = sorted(compiled.meta["layers"])
        info["smem_bytes"] = dict(compiled.meta["smem"])
    return plan, compiled, info


def serve_jpeg_resnet(args, *, prepared=None,
                      on_batch: Callable[[torch.Tensor, torch.Tensor], None]
                      | None = None) -> dict:
    """Serve ``--requests`` requests; returns (and prints) the report.

    ``prepared`` is a ``prepare_plan`` result to reuse; ``on_batch(x,
    logits)`` sees every timed batch's device input and logits.
    """
    from repro_torch.codec import ingest as ingestlib

    device = resolve_device(args.device)
    cfg = reduced_config("jpeg-resnet") if args.reduced \
        else get_config("jpeg-resnet")
    plan, compiled, info = prepared or prepare_plan(args, cfg, device)
    spec = plan.spec
    n_blocks = cfg.image_size // dctlib.BLOCK
    if compiled is not None:
        meta = compiled.meta
        print(f"[serve] compiled schedule: {len(meta['fused'])} blocks fused "
              f"({','.join(meta['fused']) or '-'}), {len(meta['layers'])} "
              f"steps per-layer ({','.join(sorted(meta['layers'])) or '-'})",
              flush=True)
        pack_w = compiled.stem.w_in

        def fwd(x):
            return planlib.apply_compiled_packed(compiled, x)
    else:
        print("[serve] per-layer plan walk (no compiled schedule)",
              flush=True)
        pack_w = None

        def fwd(x):
            return planlib.apply_plan(plan, x)

    requests = jpeg_byte_requests(args.batch, cfg, args.seed)
    ingest_kw = dict(quality=spec.quality, grid=(n_blocks, n_blocks),
                     channels=cfg.in_channels, pack_width=pack_w)
    stats = []

    def next_batch(payload: list[bytes]) -> torch.Tensor:
        batch, st = ingestlib.ingest_batch(payload, **ingest_kw)
        stats.append(st)
        return torch.as_tensor(batch).to(device)

    with torch.inference_mode():
        fwd(next_batch(requests(0))).cpu()  # warmup: builds the kernels
        stats.clear()
        rng = np.random.default_rng(args.seed)
        b = args.batch
        max_imgs = max(args.max_new, 1)
        started = min(b, args.requests)
        pending = args.requests - started
        budgets = rng.integers(1, max_imgs + 1, size=(b,))
        active = np.arange(b) < started
        produced = np.zeros((b,), np.int64)
        n_imgs, completed, step = 0, 0, 1
        # The server's clock runs only while it ingests and forwards: the
        # synthetic client's image synthesis and JPEG encoding stay outside
        # it, as they would on another machine.
        ingest_s = forward_s = 0.0
        slot_start = np.zeros((b,))
        latencies: list[float] = []
        while completed < args.requests and active.any():
            payload = requests(step)
            t_a = time.perf_counter()
            x = next_batch(payload)
            t_b = time.perf_counter()
            logits = fwd(x)
            logits.argmax(-1).cpu()  # labels ship to clients here
            t_c = time.perf_counter()
            ingest_s += t_b - t_a
            forward_s += t_c - t_b
            now = ingest_s + forward_s
            step += 1
            if on_batch is not None:
                on_batch(x, logits)
            n_imgs += int(active.sum())
            produced += active
            for i in np.where(active & (produced >= budgets))[0]:
                completed += 1
                produced[i] = 0
                latencies.append(now - slot_start[i])
                slot_start[i] = now
                if pending > 0:
                    pending -= 1
                    budgets[i] = rng.integers(1, max_imgs + 1)
                else:
                    active[i] = False
        wall = ingest_s + forward_s
    from repro_torch.codec import merge_stats

    ist = merge_stats(stats)
    out = {"arch": cfg.name, "images": n_imgs, "batches": step - 1,
           "wall_s": wall, "ingest_s": ingest_s, "forward_s": forward_s,
           "images_per_s": n_imgs / max(wall, 1e-9),
           "completed": completed, "ingest": "bytes",
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "latency_ms": percentiles(latencies), "plan": info,
           "ingest_stats": {"images": ist.images, "bytes_in": ist.bytes_in,
                            "mean_nonzero_per_block": ist.mean_nonzero},
           "seed": args.seed, "batch": args.batch}
    print(json.dumps(out), flush=True)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=("jpeg-resnet",))
    ap.add_argument("--reduced", action="store_true",
                    help="the CIFAR-scale config instead of the full one")
    ap.add_argument("--ingest", default="bytes", choices=("bytes",),
                    help="request format: baseline JPEG bytes")
    ap.add_argument("--bands", type=int, default=None,
                    help="zigzag coefficients kept per layer (default 64)")
    ap.add_argument("--compiled", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="serve the compiled schedule (default); "
                         "--no-compiled serves the per-layer plan walk")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32,
                    help="most images one request classifies")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    return serve_jpeg_resnet(parse_args(argv))


if __name__ == "__main__":
    main()
