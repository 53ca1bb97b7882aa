"""Serve ``jpeg-resnet`` from JPEG bytes (or coefficients) to logits, and
every language model of the reference by slot-batched decoding.

jpeg-resnet serving is plan-backed, as the reference's: with
``--plan-dir`` the process restores an ``InferencePlan`` and its compiled
schedule from the directory (written by either package), and builds,
saves and re-loads them only when the directory holds none for this
config; without it the plan is built in-process from seeded random
weights.  ``--dispatch`` (``reference`` / ``cuda`` / ``factored``, or the
reference's ``pallas`` for ``cuda``) and ``--bands`` set the dispatch
config for the run, defaulting to ``JPEG_DISPATCH`` / ``JPEG_BANDS``.
``--autotune-bands`` builds the plan with per-layer bands
(``plan.autotune_bands``), probed on one batch of the run's own traffic:
for byte traffic its decoded coefficients and their ``IngestStats``
energy profile; a restored plan that was not autotuned is rebuilt.

Two request formats (``--ingest``): ``coefficients`` (the default, as in
the reference: coefficient tensors from the synthetic pipeline) and
``bytes``: real baseline JFIF files, from ``--jpeg-dir`` or the synthetic
image corpus encoded at a rotating quality mix (35/50/75/90, the true IJG
tables), entropy-decoded and normalized on the host by
``repro_torch.codec`` (never a spatial decode).

With ``--qos`` the process serves through the band-elastic runtime
(``repro_torch.serving``): the plan is compiled into a ladder of band
tiers (``--tiers``, default top/48/32/24), restored from and saved to
``--plan-dir``, and an async scheduler with admission control
(``--max-queue``) and per-request deadlines (``--deadline-ms``) picks the
tier per batch from queue depth and deadline slack.  Each (batch bucket ×
tier) cell (``--batch-buckets``) is one CUDA graph captured at warmup, so
a batch is one graph replay; bytes requests decode on the scheduler's
ingest thread over the supervised spawn pool.  ``--requests``
single-image requests are submitted as a burst; the report (also written
to ``--report-out``) carries the reference's keys: latency percentiles,
per-tier throughput, tier switches, capture accounting
(``compiles_total`` / ``compiles_post_warmup``), ingest occupancy and
health; ``--trace-out`` writes the flight recorder's Chrome trace,
``--metrics-out`` a Prometheus-style snapshot every ``--metrics-interval``
seconds, and ``--jax-profile DIR`` (the reference's flag name) a
``torch.profiler`` trace of the same window; all three are written on any
exit.  ``--chaos`` (byte traffic only) turns the burst into the
reference's fault drill (``serving.faults``): ``--chaos-rate`` of the
requests carry corrupted bytes (``--chaos-seed``), one decode worker is
killed before the third batch (``--chaos-kill-worker``), and
``--chaos-exec-faults`` dispatches raise in the executor under a breaker
that trips on two consecutive failures; the client retries through the
open breaker and resubmits healthy requests that failed at the executor
or ingest stage (up to 4 rounds), and the report's ``chaos`` entry counts
what failed where.  ``--profile-grid`` sweeps the warmed grid before
traffic (``introspect.profile_plan_grid`` against the ``--hw-profile``
roofline: every cell's predicted and measured capacity, no capture): the
capacities go to the ``serve_predicted_capacity`` gauges, each cell's
FLOPs and predicted wall onto its ``device-dispatch`` spans, and the
sweep into the report's ``profile_grid``.

Without ``--qos`` requests run through a pool of ``--batch`` slots: each
request classifies a random number (1..``--max-new``) of images and a
finished slot refills from the pending queue.  The report is one JSON
line: images/s, per-request latency percentiles, the server's time split
into host ingest and device forward, and the plan's fused and per-layer
split.  Bytes requests decode as the reference's do, double-buffered
(``codec.ingest_pipeline``): batch ``N+1`` decodes on a producer thread,
over the spawn pool, while the device runs batch ``N``, so the ingest
time reported is the part the device did not hide.  The server's clock
excludes the synthetic client's image synthesis and encoding: the client
makes every batch's bytes before the clock starts.

Language models (:func:`serve_lm`, a port of the reference's): ``--batch``
decode slots over a ``--ctx``-slot cache, each request generating a random
4..``--max-new`` greedy tokens from a random one-token start, finished
slots refilled from the pending requests; the report is one JSON line
with decode tokens/s.  The prompt path (``Model.prefill``, which runs the
flash-attention kernel) is driven by ``chip_smoke.py``.  As in the
reference, decoding starts from ``Model.init_cache``: a VLM's steps see no
image, and ``whisper-small``'s decoder attends to the zero ``cross``
cache that ``init_cache`` makes, not to an encoded input.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jpeg-resnet \\
        --qos --ingest bytes --plan-dir /tmp/plan --batch 8 --requests 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jpeg-resnet \\
        --ingest bytes --bands 16 --batch 4 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jpeg-resnet \\
        --reduced --device cpu --qos --ingest bytes --batch 4 --requests 8 \\
        --plan-dir /tmp/plan-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --reduced --device cpu

Runs on the CUDA device unless ``--device cpu`` is given; without CUDA it
raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.configs.jpeg_resnet import spec_of
from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import plan as planlib
from repro_torch.core import resnet as resnetlib
from repro_torch.models.registry import build_model

__all__ = ["BYTE_QUALITIES", "jpeg_byte_requests", "prepare_plan",
           "autotune_probe", "prepare_ladder", "parse_buckets", "parse_tiers",
           "run_metadata", "slot_schedule",
           "serve_jpeg_resnet", "serve_lm", "percentiles", "parse_args",
           "main"]

#: quality mix of the synthetic byte stream
BYTE_QUALITIES = (35, 50, 75, 90)


def jpeg_byte_requests(batch: int, cfg, seed: int,
                       jpeg_dir: str | None = None
                       ) -> Callable[[int], list]:
    """``fn(step) -> list[bytes]``: ``batch`` JPEG files a step.  With
    ``jpeg_dir``, files drawn by the pure ``(seed, step)`` rule of
    ``data.jpeg_file_iterator`` from the sorted list; else synthetic
    images encoded to baseline JFIF at a rotating quality mix."""
    from repro_torch.data.synthetic import _rng, image_batch

    if jpeg_dir:
        from repro_torch.data.pipeline import list_jpeg_files

        paths = list_jpeg_files(jpeg_dir)
        if not paths:
            raise FileNotFoundError(f"no JPEG files under {jpeg_dir}")

        def from_files(step: int) -> list[bytes]:
            out = []
            for j in _rng(seed, step).integers(0, len(paths), size=batch):
                with open(paths[j], "rb") as f:
                    out.append(f.read())
            return out

        return from_files

    from repro_torch.codec import encode_pixels

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


def _git_sha() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def run_metadata(args, device: torch.device, *, plan=None, ladder=None,
                 buckets=None) -> dict:
    """The run-identity block of a serve report (``meta``), the
    reference's keys with the card in place of the JAX backend: git sha,
    backend, device name and count, torch version, dispatch config, band
    tiers and bucket schedule."""
    meta: dict[str, Any] = {
        "git_sha": _git_sha(),
        "backend": device.type,
        "device": _device_name(device),
        "device_count": (torch.cuda.device_count()
                         if device.type == "cuda" else 1),
        "torch_version": torch.__version__,
        "seed": args.seed,
        "batch": args.batch,
        "requests": args.requests,
        "reduced": bool(getattr(args, "reduced", False)),
        "ingest": getattr(args, "ingest", "coefficients"),
    }
    if plan is not None:
        meta["dispatch"] = plan.cfg.path
        meta["bands_min"] = min(plan.bands.values())
        meta["bands_max"] = max(plan.bands.values())
    if ladder is not None:
        meta["band_tiers"] = [
            {"name": t.name, "cap": t.cap,
             "bands": sorted(set(t.bands.values()))} for t in ladder.tiers]
    if buckets is not None:
        meta["batch_buckets"] = list(buckets)
    return meta


def _dispatch_changes(args) -> dict[str, Any]:
    changes: dict[str, Any] = {}
    if getattr(args, "dispatch", None) is not None:
        changes["path"] = args.dispatch
    if args.bands is not None:
        changes["bands"] = args.bands
    return changes


def prepare_plan(args, cfg, device: torch.device):
    """The serving plan on ``device``, and its compiled schedule unless
    ``--no-compiled``.  Returns ``(plan, compiled, info)``.

    With ``--plan-dir`` the plan is restored from the directory (a plan
    either package saved) unless it holds none, or one for another spec,
    ``--dispatch`` or ``--bands``; then it is built from ``--seed``,
    saved, and served from the re-loaded copy, so the save → restore
    round trip is on the serve path.  With ``--autotune-bands`` a restored
    plan whose ``provenance["bands_mode"]`` is not ``auto`` is rebuilt,
    with ``bands="auto"`` probed by :func:`autotune_probe`.  The compiled
    schedule comes from ``DIR/compiled`` the same way (recompiled when
    missing, stale or unreadable).  Without ``--plan-dir`` both are built
    in-process and nothing is written (the reference defaults to
    ``plans/<arch>``)."""
    spec = spec_of(cfg)
    dcfg = dataclasses.replace(dispatchlib.get_config(),
                               **_dispatch_changes(args))
    autotune = bool(getattr(args, "autotune_bands", False))
    plan_dir = getattr(args, "plan_dir", None)
    plan, built = None, False
    if plan_dir:
        try:
            plan = planlib.load_plan(plan_dir, device=device)
        except (FileNotFoundError, ValueError, KeyError):
            plan = None
        dispatch = getattr(args, "dispatch", None)
        if plan is not None and (
                plan.spec != spec
                or (dispatch is not None and plan.cfg.path
                    != dispatchlib.canonical_path(dispatch))
                or (args.bands is not None
                    and set(plan.bands.values()) != {args.bands})
                or (autotune and (plan.provenance or {}).get("bands_mode")
                    != "auto")):
            plan = None  # a plan for another config: rebuild
    if plan is None:
        built = True
        gen = torch.Generator().manual_seed(args.seed)
        params, state = resnetlib.init_resnet(gen, spec, device)
        probe = profile = occupancy = None
        if autotune:
            probe, profile, occupancy = autotune_probe(args, cfg, device)
        plan = planlib.build_plan(params, state, spec, dispatch=dcfg,
                                  bands="auto" if autotune else args.bands,
                                  probe_coef=probe, profile=profile,
                                  occupancy=occupancy)
        if plan_dir:
            planlib.save_plan(plan, plan_dir)
            plan = planlib.load_plan(plan_dir, device=device)

    compiled = None
    if args.compiled:
        if plan_dir:
            cdir = os.path.join(plan_dir, "compiled")
            if not built:
                try:
                    compiled = planlib.load_compiled_plan(cdir, device=device)
                    if compiled.spec != plan.spec \
                            or compiled.bands != plan.bands:
                        compiled = None  # a schedule of another plan
                except (FileNotFoundError, ValueError, KeyError):
                    compiled = None
            if compiled is None:
                planlib.save_compiled_plan(planlib.compile_plan(plan), cdir)
                compiled = planlib.load_compiled_plan(cdir, device=device)
        else:
            compiled = planlib.compile_plan(plan)
    info: dict[str, Any] = {"dir": plan_dir, "built": built,
                            "bands": plan.bands, "path": plan.cfg.path,
                            "provenance": plan.provenance, "fused_bn": True,
                            "compiled": compiled is not None}
    if compiled is not None:
        info["schedule_path"] = compiled.meta["path"]
        info["fused_blocks"] = list(compiled.meta["fused"])
        info["fallback_steps"] = sorted(compiled.meta["layers"])
        info["smem_bytes"] = dict(compiled.meta["smem"])
    return plan, compiled, info


def autotune_probe(args, cfg, device: torch.device):
    """``(probe_coef, profile, occupancy)`` for ``--autotune-bands``: with
    ``--ingest bytes`` one batch of the run's byte traffic (seed
    ``--seed`` + 1) through ``codec.ingest_batch``, whose ``IngestStats``
    energy and occupancy are the profile; else the first batch of 4 of
    ``jpeg_iterator`` (no profile: the qtable prior)."""
    if getattr(args, "ingest", "coefficients") == "bytes":
        from repro_torch.codec import ingest as ingestlib

        n = cfg.image_size // dctlib.BLOCK
        coef, stats = ingestlib.ingest_batch(
            jpeg_byte_requests(args.batch, cfg, args.seed + 1,
                               getattr(args, "jpeg_dir", None))(0),
            quality=spec_of(cfg).quality, grid=(n, n),
            channels=cfg.in_channels)
        return (torch.as_tensor(coef).to(device), stats.energy,
                stats.occupancy)
    from repro_torch.data.pipeline import jpeg_iterator

    it = jpeg_iterator(args.seed + 1, 4, cfg.image_size, cfg.in_channels,
                       cfg.num_classes, device=device)
    return next(it)["coefficients"], None, None


def parse_buckets(spec, batch: int) -> tuple | None:
    """``--batch-buckets`` → capture buckets: ``auto``/None → the
    aphrodite schedule up to ``--batch``; ``fixed`` → the one full-batch
    bucket; else comma-separated ints, e.g. ``1,2,4,8``."""
    if spec in (None, ""):
        return None
    tok = str(spec).strip().lower()
    if tok == "auto":
        return None
    if tok == "fixed":
        return (batch,)
    return tuple(int(t) for t in tok.split(","))


def parse_tiers(spec) -> tuple:
    """``--tiers`` → ladder caps: ``"auto,48,32,24"`` → ``(None, 48, 32,
    24)`` (``auto``/``top``/``none`` = the plan's own assignment);
    None/empty → the default ladder."""
    from repro_torch.serving import DEFAULT_CAPS

    if not spec:
        return DEFAULT_CAPS
    caps = []
    for tok in str(spec).split(","):
        tok = tok.strip().lower()
        caps.append(None if tok in ("auto", "top", "none") else int(tok))
    return tuple(caps)


def prepare_ladder(args, cfg, plan, plan_dir: str | None):
    """The tier ladder: restored from ``plan_dir`` unless it holds none,
    or one with other caps than ``--tiers``; a ladder whose capture
    buckets differ from ``--batch-buckets`` only gets its manifest
    rewritten.  A built ladder is saved to ``plan_dir`` (beside the plan,
    which is not saved again).  Returns ``(ladder, restored)``."""
    from repro_torch import serving

    caps = parse_tiers(getattr(args, "tiers", None))
    buckets = serving.cover_buckets(
        parse_buckets(getattr(args, "batch_buckets", None), args.batch),
        args.batch)
    ladder = None
    if plan_dir:
        try:
            ladder = serving.load_ladder(plan_dir, plan=plan)
            if ladder.caps != caps:
                ladder = None  # another ladder was asked for: rebuild
            elif ladder.buckets != buckets:
                # same tiers, another grid: only the manifest changes
                ladder = serving.PlanLadder(
                    ladder.tiers, ladder.base, ladder.caps,
                    ladder.image_size, ladder.vmem_budget, buckets)
                serving.save_ladder(ladder, plan_dir, save_base=False)
        except (FileNotFoundError, ValueError, KeyError):
            ladder = None
    restored = ladder is not None
    if ladder is None:
        ladder = serving.build_ladder(plan, caps=caps,
                                      image_size=cfg.image_size,
                                      buckets=buckets)
        if plan_dir:
            serving.save_ladder(ladder, plan_dir, save_base=False)
    return ladder, restored


def _qos_request_source(args, cfg, seed: int, device: torch.device):
    """``(fn, kind)``: ``fn(i)`` is request ``i``'s payload, one image's
    JPEG bytes or ``(bh, bw, C, 64)`` coefficients (numpy, encoded on
    ``device``), drawn from the sources the slot loop uses."""

    def per_item(fetch_batch):
        # requests are submitted in order: one batch of payloads is held
        # at a time
        cache: dict[int, Any] = {}

        def fn(i: int):
            step = i // args.batch
            if step not in cache:
                cache.clear()
                cache[step] = fetch_batch(step)
            return cache[step][i % args.batch]

        return fn

    if getattr(args, "ingest", "coefficients") == "bytes":
        return per_item(jpeg_byte_requests(
            args.batch, cfg, seed, getattr(args, "jpeg_dir", None))), "bytes"

    from repro_torch.data.pipeline import jpeg_iterator

    it = jpeg_iterator(seed, args.batch, cfg.image_size, cfg.in_channels,
                       cfg.num_classes, device=device)
    return per_item(lambda step: next(it)["coefficients"].cpu().numpy()), \
        "coefficients"


def _warm_ingest_pool(payloads: list, cfg, spec) -> dict[str, Any]:
    """Start the decode pool before traffic (a worker imports the port,
    hence torch) and time it: the first batch would pay it otherwise."""
    from repro_torch.codec import ingest as ingestlib

    workers = ingestlib.ingest_workers()
    t0 = time.perf_counter()
    if workers > 1 and len(payloads) >= 2:
        n = cfg.image_size // dctlib.BLOCK
        ingestlib.ingest_batch(payloads, quality=spec.quality, grid=(n, n),
                               channels=cfg.in_channels, with_stats=False)
    return {"workers": workers,
            "pool_start_s": time.perf_counter() - t0 if workers > 1
            else 0.0}


def _chaos_faults(args, serving):
    """The chaos drill's deterministic fault plan and breaker policy:
    ``--chaos-rate`` of the request indices get bytes that must fail to
    decode, one decode worker is killed before the third ingest batch,
    and dispatches 2 .. 2 + ``--chaos-exec-faults`` raise in the executor.
    The breaker opens after 2 consecutive service failures, half-opens
    after 0.5 s and closes on the first good probe, so the burst trips it
    and the run closes it again."""
    n_exec = getattr(args, "chaos_exec_faults", 2)
    spec = serving.FaultSpec(
        seed=getattr(args, "chaos_seed", 1234),
        corrupt_rate=getattr(args, "chaos_rate", 0.2),
        kill_worker_before_batch=(
            3 if getattr(args, "chaos_kill_worker", True) else None),
        executor_fail_batches=(2, 2 + n_exec) if n_exec else None)
    policy = serving.BreakerPolicy(window=16, failure_rate=0.5,
                                   min_samples=8, max_consecutive=2,
                                   open_s=0.5, half_open_successes=1)
    return serving.FaultInjector(spec), policy


def _submit_retry(sched, serving, payload, kind, deadline_s,
                  timeout_s: float = 60.0):
    """The chaos client's submit: retries through the open breaker's
    fast rejections and admission control's, as a client's backoff
    would; gives up (raises, or returns None) after ``timeout_s``."""
    t0 = time.monotonic()
    while True:
        try:
            r = sched.submit(payload, kind=kind, deadline_s=deadline_s)
        except serving.ServiceUnavailable:
            if time.monotonic() - t0 > timeout_s:
                raise
            time.sleep(0.05)  # breaker open: wait for the half-open probe
            continue
        if r is not None:
            return r
        if time.monotonic() - t0 > timeout_s:
            return None
        time.sleep(0.01)      # queue full: admission backpressure


def _resubmit_failed(sched, serving, requests: list, faults, kind,
                     deadline_s, rounds: int = 4) -> None:
    """Up to ``rounds`` resubmit rounds, in place, for the healthy requests
    the injected faults failed at the executor or ingest stage; a
    corrupted request is never retried (its typed codec error is the
    drill's expected outcome)."""
    def retryable(i, r):
        e = r.error()
        return (isinstance(e, serving.RequestFailed)
                and e.stage in ("executor", "ingest")
                and i not in faults.corrupted)

    for _ in range(rounds):
        retry = [k for k, (i, _, r) in enumerate(requests)
                 if retryable(i, r)]
        if not retry:
            return
        for k in retry:
            i, p, _ = requests[k]
            nr = _submit_retry(sched, serving, p, kind, deadline_s)
            if nr is not None:
                requests[k] = (i, p, nr)
        sched.drain()


def _chaos_report(requests: list, faults, total: int) -> dict:
    """The report's ``chaos`` entry, with the reference's keys."""
    from repro_torch import serving

    stages: dict[str, int] = {}
    for _, _, r in requests:
        e = r.error()
        key = e.stage if isinstance(e, serving.RequestFailed) \
            else type(e).__name__ if e is not None else None
        if key is not None:
            stages[key] = stages.get(key, 0) + 1
    modes = list(faults.corrupted.values())
    return {"corrupted": len(faults.corrupted),
            "corrupt_modes": {m: modes.count(m) for m in set(modes)},
            "killed_worker_pid": faults.killed_pid,
            "failed_by_stage": stages,
            "healthy_total": total - len(faults.corrupted),
            "healthy_completed": sum(
                1 for i, _, r in requests
                if i not in faults.corrupted and r.tier is not None)}


def _serve_jpeg_qos(args, cfg, plan, plan_info, device,
                    on_served=None) -> dict:
    """Serve a burst of ``--requests`` single-image requests through the
    band-elastic runtime: admission control, per-batch tier selection,
    degradation under overload and recovery on drain; with ``--chaos``,
    under the fault drill.  ``on_served(ladder, requests, grid)`` sees the
    ladder, every ``(index, payload, request)`` (the last submission of a
    resubmitted one) and the scheduler's ``PlanGrid`` (its captured
    cells) after the burst drained."""
    from repro_torch import serving

    chaos = bool(getattr(args, "chaos", False))
    if chaos and getattr(args, "ingest", "coefficients") != "bytes":
        raise ValueError("--chaos corrupts JPEG bytes; needs --ingest bytes")
    ladder, ladder_restored = prepare_ladder(args, cfg, plan,
                                             plan_info["dir"])
    names = [t.name for t in ladder.tiers]
    print("[serve] band-elastic ladder ("
          + ("restored" if ladder_restored else "built") + "): "
          + " > ".join(f"{t.name}(bands {min(t.bands.values())}-"
                       f"{max(t.bands.values())}, fused "
                       f"{','.join(t.compiled.meta['fused']) or '-'})"
                       for t in ladder.tiers), flush=True)
    n_blocks = cfg.image_size // dctlib.BLOCK
    total = args.requests
    deadline_s = (args.deadline_ms / 1e3
                  if getattr(args, "deadline_ms", None) else None)
    max_pending = getattr(args, "max_queue", None) or total
    metrics = serving.ServeMetrics()
    payload_of, kind = _qos_request_source(args, cfg, args.seed, device)
    pool_info = {"workers": 1, "pool_start_s": 0.0}
    if kind == "bytes":
        pool_info = _warm_ingest_pool(
            [payload_of(i) for i in range(min(args.batch, total))], cfg,
            plan.spec)

    faults, breaker_policy = None, None
    if chaos:
        faults, breaker_policy = _chaos_faults(args, serving)
        print(f"[serve] chaos: corrupt_rate={faults.spec.corrupt_rate:g} "
              f"seed={faults.spec.seed} kill_worker_before_batch="
              f"{faults.spec.kill_worker_before_batch} "
              f"executor_fail_batches={faults.spec.executor_fail_batches}",
              flush=True)

    # the sidecars (flight recorder, metrics snapshots, profiler window)
    # are written on any exit, a crashed run included; the scheduler
    # closes first
    tracer, writer = None, None
    trace_path = getattr(args, "trace_out", None)
    metrics_path = getattr(args, "metrics_out", None)
    with contextlib.ExitStack() as obs:
        if trace_path:
            tracer = serving.Tracer(
                capacity=int(getattr(args, "trace_capacity", None) or 65536))
            obs.callback(lambda: tracer.write(trace_path))
        if metrics_path:
            writer = serving.MetricsWriter(
                metrics, metrics_path,
                interval_s=float(getattr(args, "metrics_interval", None)
                                 or 1.0))
            t_writer = time.monotonic()
            obs.callback(writer.close)
        profile_path = obs.enter_context(serving.device_profile(
            getattr(args, "jax_profile", None), device))
        sched = obs.enter_context(serving.BandElasticScheduler(
            ladder, batch=args.batch, metrics=metrics,
            max_pending=max_pending, grid=(n_blocks, n_blocks),
            channels=cfg.in_channels, breaker=breaker_policy, faults=faults,
            tracer=tracer))
        t_w = time.perf_counter()
        sched.warmup(kinds=(kind,))
        warmup_s = time.perf_counter() - t_w
        gs = sched.grid_engine.summary()
        print(f"[serve] plan grid: {gs['distinct_columns']} tier columns x "
              f"buckets {gs['buckets']} = {gs['cells']} captured cells "
              f"({'CUDA graphs' if gs['cuda_graphs'] else 'eager, CPU'}; "
              f"{gs['host_staging_bytes'] / 2**20:.1f} MiB host staging) "
              f"in {warmup_s:.2f} s", flush=True)
        profile_grid = None
        if getattr(args, "profile_grid", False):
            profile_grid = _profile_grid(args, sched, metrics)
        # the client makes (and corrupts) every payload before the burst:
        # its image synthesis and encoding stay outside the server's clock
        payloads = [payload_of(i) for i in range(total)]
        if faults is not None:
            payloads = [faults.corrupt(i, p) for i, p in enumerate(payloads)]
        t0 = time.monotonic()
        requests = []  # (request index, payload, ServeRequest)
        for i, p in enumerate(payloads):
            if chaos:
                r = _submit_retry(sched, serving, p, kind, deadline_s)
            else:
                r = sched.submit(p, kind=kind, deadline_s=deadline_s)
            if r is not None:
                requests.append((i, p, r))
        sched.drain()
        if chaos:
            _resubmit_failed(sched, serving, requests, faults, kind,
                             deadline_s)
        wall = time.monotonic() - t0
        health = sched.health()
        graph_launches = sched.grid_engine.graph_launches()
        replays = {c.name: c.hits for c in sched.grid_engine.cells()
                   if c.hits}
    t_closed = time.monotonic()

    # top-tier fidelity probe: requests served at the top tier agree
    # (top-1) with the per-layer plan walk
    probe = [(p, r) for _, p, r in requests if r.tier == names[0]]
    probe = probe[: args.batch]
    agree = None
    if probe:
        if kind == "bytes":
            from repro_torch.codec import ingest as ingestlib

            coefs, _ = ingestlib.ingest_batch(
                [p for p, _ in probe], quality=plan.spec.quality,
                grid=(n_blocks, n_blocks), channels=cfg.in_channels,
                with_stats=False)
        else:
            coefs = np.stack([np.asarray(p) for p, _ in probe])
        with torch.inference_mode():
            ref = planlib.apply_plan(plan, torch.as_tensor(coefs).to(device))
        served = np.stack([r.result() for _, r in probe])
        agree = float(np.mean(ref.argmax(-1).cpu().numpy()
                              == served.argmax(-1)))
    if on_served is not None:
        on_served(ladder, requests, sched.grid_engine)

    qos_report = metrics.report()
    qos_report["grid"] = gs
    qos_report["tiers"] = [
        {"name": t.name, "cap": t.cap, "bands": sorted(set(t.bands.values())),
         "fused": list(t.compiled.meta["fused"])} for t in ladder.tiers]
    qos_report["top1_agree_top_tier"] = agree
    qos_report["ladder"] = {
        "restored": ladder_restored,
        "device_bytes": ladder.device_bytes(),
        "top_tier_bytes": ladder.device_bytes([ladder.top])}
    qos_report["warmup_s"] = warmup_s
    qos_report["graph_launches"] = graph_launches
    qos_report["cell_replays"] = replays
    qos_report["ingest_pool"] = pool_info
    served_n = len(requests)
    completed = sum(1 for *_, r in requests if r.tier is not None)
    # the classes that ship to clients, in request order (None: failed)
    labels = [int(r.result().argmax()) if r.error() is None else None
              for *_, r in requests]
    out = {"arch": cfg.name, "images": served_n, "wall_s": wall,
           "images_per_s": served_n / max(wall, 1e-9),
           "completed": completed, "rejected": total - served_n,
           "dispatch": plan.cfg.path, "ingest": kind,
           "device": _device_name(device),
           "latency_ms": qos_report["latency_ms"],
           "labels": labels, "qos": qos_report, "plan": plan_info,
           "health": health,
           "meta": run_metadata(args, device, plan=plan, ladder=ladder,
                                buckets=sched.buckets)}
    if tracer is not None:
        s = tracer.summary()
        out["trace"] = {"path": trace_path, "events": s["events"],
                        "dropped": s["dropped"], "capacity": s["capacity"]}
        print(f"[serve] flight recorder: {s['events']} events "
              f"({s['dropped']} dropped) -> {trace_path}", flush=True)
    if writer is not None:
        out["metrics_out"] = metrics_path
        out["metrics_writes"] = writer.writes
        out["metrics_window_s"] = t_closed - t_writer
    if profile_path is not None:
        out["profile"] = profile_path
    if profile_grid is not None:
        out["profile_grid"] = profile_grid
    if chaos:
        out["chaos"] = _chaos_report(requests, faults, total)
    _emit_report(args, out)
    return out


def _profile_grid(args, sched, metrics) -> dict:
    """``--profile-grid``: the pre-traffic capacity sweep over every
    warmed cell (captured executors and eager walks only: no capture),
    its capacities on the ``serve_predicted_capacity`` gauges and each
    cell's FLOPs and predicted wall on the scheduler's device-dispatch
    spans.  Returns the report's ``profile_grid`` section, with the
    sweep's ``seconds``."""
    from repro_torch import introspect

    t0 = time.perf_counter()
    hw = introspect.resolve_profile(getattr(args, "hw_profile", None))
    out = introspect.profile_plan_grid(sched.grid_engine, hw=hw)
    for c in out["cells"]:
        metrics.record_predicted_capacity(c["cell"], c["predicted_req_s"])
    sched.grid_engine.annotate_costs(
        {c["cell"]: {"flops": c["flops"], "predicted_us": c["predicted_us"]}
         for c in out["cells"]})
    out["seconds"] = time.perf_counter() - t0
    print(f"[serve] grid profile ({hw.name}, {out['seconds']:.2f} s): "
          + "  ".join(f"{c['cell']}={c['predicted_req_s']:.0f}req/s "
                      f"(measured {c['measured_req_s']:.0f})"
                      for c in out["cells"][:6])
          + ("  ..." if len(out["cells"]) > 6 else ""), flush=True)
    return out


def _emit_report(args, out: dict) -> None:
    print(json.dumps(out), flush=True)
    path = getattr(args, "report_out", None)
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)


def slot_schedule(requests: int, batch: int, max_new: int,
                  seed: int) -> list[tuple[int, list[int]]]:
    """The slot loop's steps, drawn as the reference's loop draws them:
    ``batch`` slots, each request classifying ``1..max_new`` images (numpy
    from ``seed``), a finished slot refilled from the pending requests.
    Returns, for each step, the number of images served and the slots
    whose request completes there."""
    rng = np.random.default_rng(seed)
    max_imgs = max(max_new, 1)
    started = min(batch, requests)
    pending = requests - started
    budgets = rng.integers(1, max_imgs + 1, size=(batch,))
    active = np.arange(batch) < started
    produced = np.zeros((batch,), np.int64)
    steps, completed = [], 0
    while completed < requests and active.any():
        n_active = int(active.sum())
        produced += active
        done = [int(i) for i in np.where(active & (produced >= budgets))[0]]
        for i in done:
            completed += 1
            produced[i] = 0
            if pending > 0:
                pending -= 1
                budgets[i] = rng.integers(1, max_imgs + 1)
            else:
                active[i] = False
        steps.append((n_active, done))
    return steps


def serve_jpeg_resnet(args, *, prepared=None,
                      on_batch: Callable[[torch.Tensor, torch.Tensor], None]
                      | None = None, on_served=None) -> dict:
    """Serve ``--requests`` requests; returns (and prints) the report.

    ``--dispatch`` and ``--bands`` replace the global dispatch config for
    the run (``dispatch.override``: the process's config is restored
    after it).  ``prepared`` is a ``prepare_plan`` result to reuse;
    ``on_batch(x, logits)`` sees every timed batch of the slot loop;
    ``on_served(ladder, requests, grid)`` the ``--qos`` run's requests
    and its grid of captured cells."""
    with dispatchlib.override(**_dispatch_changes(args)):
        return _serve_jpeg_resnet(args, prepared, on_batch, on_served)


def _serve_jpeg_resnet(args, prepared, on_batch, on_served) -> dict:
    from repro_torch.codec import ingest as ingestlib

    device = resolve_device(args.device)
    cfg = reduced_config("jpeg-resnet") if args.reduced \
        else get_config("jpeg-resnet")
    plan, compiled, info = prepared or prepare_plan(args, cfg, device)
    if getattr(args, "qos", False):
        return _serve_jpeg_qos(args, cfg, plan, info, device,
                               on_served=on_served)
    if any(getattr(args, a, None) for a in ("trace_out", "metrics_out",
                                            "jax_profile", "chaos",
                                            "profile_grid")):
        print("[serve] --trace-out/--metrics-out/--jax-profile/--chaos/"
              "--profile-grid instrument the QoS runtime; ignored without "
              "--qos", flush=True)
    spec = plan.spec
    n_blocks = cfg.image_size // dctlib.BLOCK
    from_bytes = getattr(args, "ingest", "coefficients") == "bytes"
    if compiled is not None:
        meta = compiled.meta
        print(f"[serve] compiled schedule: {len(meta['fused'])} blocks fused "
              f"({','.join(meta['fused']) or '-'}), {len(meta['layers'])} "
              f"steps per-layer ({','.join(sorted(meta['layers'])) or '-'})",
              flush=True)
        pack_w = compiled.stem.w_in if from_bytes else None

        def fwd(x):
            if from_bytes:
                return planlib.apply_compiled_packed(compiled, x)
            return planlib.apply_compiled(compiled, x)
    else:
        print("[serve] per-layer plan walk (no compiled schedule)",
              flush=True)
        pack_w = None

        def fwd(x):
            return planlib.apply_plan(plan, x)

    schedule = slot_schedule(args.requests, args.batch, args.max_new,
                             args.seed)
    stats = []
    pipe = None
    if from_bytes:
        requests = jpeg_byte_requests(args.batch, cfg, args.seed,
                                      getattr(args, "jpeg_dir", None))
        ingest_kw = dict(quality=spec.quality, grid=(n_blocks, n_blocks),
                         channels=cfg.in_channels, pack_width=pack_w)
        # the client makes every timed batch's bytes up front; the decode
        # of batch N+1 then overlaps the device walk of batch N
        pipe = ingestlib.ingest_pipeline(
            [requests(step) for step in range(1, len(schedule) + 1)],
            depth=2, **ingest_kw)

        def client_batch() -> None:
            return None  # made above

        def next_batch(_payload) -> torch.Tensor:
            batch, st = next(pipe)
            stats.append(st)
            return torch.as_tensor(batch).to(device)

        with torch.inference_mode():  # warmup: builds the kernels
            batch, _ = ingestlib.ingest_batch(requests(0), **ingest_kw)
            fwd(torch.as_tensor(batch).to(device)).cpu()
    else:
        # coefficient requests arrive decoded, made on the device by the
        # synthetic client (outside the server's clock)
        from repro_torch.data.pipeline import jpeg_iterator

        coef_it = jpeg_iterator(args.seed, args.batch, cfg.image_size,
                                cfg.in_channels, cfg.num_classes,
                                device=device)

        def client_batch() -> torch.Tensor:
            return next(coef_it)["coefficients"]

        def next_batch(payload: torch.Tensor) -> torch.Tensor:
            return payload

        with torch.inference_mode():
            fwd(client_batch()).cpu()  # warmup: builds the kernels

    # The server's clock runs only while it waits for a batch and forwards
    # it: the client's work and the hooks stay outside.
    ingest_s = forward_s = 0.0
    slot_start = np.zeros((args.batch,))
    latencies: list[float] = []
    n_imgs = completed = 0
    try:
        with torch.inference_mode():
            for n_active, done in schedule:
                payload = client_batch()
                t_a = time.perf_counter()
                x = next_batch(payload)
                t_b = time.perf_counter()
                logits = fwd(x)
                logits.argmax(-1).cpu()  # labels ship to clients here
                t_c = time.perf_counter()
                ingest_s += t_b - t_a
                forward_s += t_c - t_b
                now = ingest_s + forward_s
                if on_batch is not None:
                    on_batch(x, logits)
                n_imgs += n_active
                for i in done:
                    completed += 1
                    latencies.append(now - slot_start[i])
                    slot_start[i] = now
    finally:
        if pipe is not None:
            pipe.close()  # joins the decode producer thread
    wall = ingest_s + forward_s
    out = {"arch": cfg.name, "images": n_imgs, "batches": len(schedule),
           "wall_s": wall, "ingest_s": ingest_s, "forward_s": forward_s,
           "images_per_s": n_imgs / max(wall, 1e-9),
           "completed": completed, "dispatch": plan.cfg.path,
           "ingest": "bytes" if from_bytes else "coefficients",
           "device": _device_name(device),
           "latency_ms": percentiles(latencies), "plan": info,
           "seed": args.seed, "batch": args.batch,
           "meta": run_metadata(args, device, plan=plan)}
    if from_bytes:
        from repro_torch.codec import merge_stats

        ist = merge_stats(stats)
        out["ingest_stats"] = {"images": ist.images,
                               "bytes_in": ist.bytes_in,
                               "mean_nonzero_per_block": ist.mean_nonzero,
                               "workers": ingestlib.ingest_workers()}
    _emit_report(args, out)
    return out


def serve_lm(args) -> dict:
    """Decode-only slot serving of a language model, as the reference's
    ``serve_lm``: the same numpy draws (request budgets, start tokens) from
    ``--seed`` and the same report keys.  As there, every slot shares the
    cache's one position index, so a refilled slot continues at the global
    index over the previous request's cache."""
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, device)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    cache = model.init_cache(b, args.ctx, device)

    # synthetic request stream; never start more than args.requests
    started = min(b, args.requests)
    pending = args.requests - started
    budgets = rng.integers(4, args.max_new + 1, size=(b,))
    active = np.arange(b) < started
    produced = np.zeros((b,), np.int64)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, 1)),
                             device=device)

    n_tokens = 0
    completed = 0
    with torch.inference_mode():
        t0 = time.perf_counter()
        while completed < args.requests:
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": tokens})
            tokens = torch.argmax(logits[:, -1], dim=-1)[:, None]
            n_tokens += int(active.sum())
            produced += active
            done = active & (produced >= budgets)
            for i in np.where(done)[0]:
                completed += 1
                produced[i] = 0
                if pending > 0:
                    pending -= 1
                    budgets[i] = rng.integers(4, args.max_new + 1)
                else:
                    active[i] = False
            if not active.any():
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    out = {"arch": cfg.name, "decode_tokens": n_tokens, "wall_s": wall,
           "tokens_per_s": n_tokens / max(wall, 1e-9),
           "completed": completed}
    print(json.dumps(out), flush=True)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the CIFAR-scale config instead of the full one")
    ap.add_argument("--dispatch", default=None,
                    choices=("auto",) + dispatchlib.PATHS
                    + tuple(dispatchlib.PATH_ALIASES),
                    help="jpeg-resnet operator path (default: "
                         "JPEG_DISPATCH or auto; pallas = cuda)")
    ap.add_argument("--bands", type=int, default=None,
                    help="zigzag coefficients kept per layer (default: "
                         "JPEG_BANDS or 64)")
    ap.add_argument("--plan-dir", default=None,
                    help="jpeg-resnet plan directory (either package's "
                         "format): restored at start, built and saved "
                         "once if it holds no plan for this config; "
                         "default: build in-process, save nothing")
    ap.add_argument("--ingest", default="coefficients",
                    choices=("coefficients", "bytes"),
                    help="request format: coefficient tensors from the "
                         "synthetic pipeline, or baseline JPEG bytes "
                         "through the host codec")
    ap.add_argument("--jpeg-dir", default=None,
                    help="directory of .jpg files to serve with --ingest "
                         "bytes (default: the synthetic mixed-quality "
                         "stream)")
    ap.add_argument("--compiled", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="serve the compiled schedule (default); "
                         "--no-compiled serves the per-layer plan walk")
    ap.add_argument("--qos", action="store_true",
                    help="serve jpeg-resnet through the band-elastic "
                         "runtime (repro_torch.serving): tier ladder, "
                         "CUDA-graph grid, async scheduler; --requests "
                         "single-image requests as one burst")
    ap.add_argument("--tiers", default=None,
                    help="ladder band caps for --qos, best first, e.g. "
                         "'auto,48,32,24' (the default)")
    ap.add_argument("--batch-buckets", default=None,
                    help="--qos capture buckets: 'auto' (1,2,4 then "
                         "multiples of 8 up to --batch), 'fixed' (--batch "
                         "only) or comma ints")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for --qos")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="--qos admission bound on queued requests "
                         "(default: the whole burst)")
    ap.add_argument("--report-out", default=None,
                    help="also write the serve report JSON to this path")
    ap.add_argument("--trace-out", default=None,
                    help="write the --qos flight recorder (Chrome "
                         "trace-event JSON) here, on any exit")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="flight-recorder ring size in events")
    ap.add_argument("--metrics-out", default=None,
                    help="write Prometheus-style metrics snapshots of the "
                         "--qos run to this path, every --metrics-interval "
                         "seconds and on exit")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    help="seconds between --metrics-out snapshots")
    ap.add_argument("--jax-profile", default=None,
                    help="directory for a torch.profiler trace (Chrome "
                         "trace JSON, CPU and CUDA activity) of the --qos "
                         "window; the reference's flag name, kept so that "
                         "its command lines run unchanged")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-drill the --qos byte stream: corrupt a "
                         "share of the requests, kill a decode worker, "
                         "fail a window of executor dispatches; healthy "
                         "requests must still complete and every fault "
                         "surface as a typed per-request error")
    ap.add_argument("--chaos-rate", type=float, default=0.2,
                    help="share of requests whose bytes --chaos corrupts")
    ap.add_argument("--chaos-seed", type=int, default=1234,
                    help="fault-injection seed: what is corrupted, and "
                         "how, is a function of (seed, request index)")
    ap.add_argument("--chaos-kill-worker", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="SIGKILL one decode worker before the third "
                         "ingest batch (needs JPEG_INGEST_WORKERS > 1)")
    ap.add_argument("--chaos-exec-faults", type=int, default=2,
                    help="dispatches (from dispatch 2 on) that raise an "
                         "injected executor fault")
    ap.add_argument("--autotune-bands", action="store_true",
                    help="build the plan with per-layer bands from an "
                         "energy budget and a parity sweep on one probe "
                         "batch of the run's traffic")
    ap.add_argument("--profile-grid", action="store_true",
                    help="after grid warmup, before traffic: every warmed "
                         "cell's roofline-predicted and measured capacity "
                         "(no capture) -> the serve_predicted_capacity "
                         "gauges, device-dispatch span annotations and the "
                         "report's profile_grid section")
    ap.add_argument("--hw-profile", default=None,
                    help="roofline hardware profile for --profile-grid: a "
                         "registry name (h100, gpu, cpu, tpu-v5e, tpu-v4), "
                         "a 'peak_flops,hbm_bw,link_bw' triple, or unset "
                         "for $JPEG_HW_PROFILE / the detected device")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=256,
                    help="LM decode cache slots")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32,
                    help="most images one request classifies (LM: most "
                         "tokens one request generates)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.arch == "jpeg-resnet":
        return serve_jpeg_resnet(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
