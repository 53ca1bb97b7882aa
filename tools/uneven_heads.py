"""The dry-run of a cell whose query heads ``model`` does not divide, in
two layouts of its attention, side by side.

``smollm-360m`` has 15 query and 5 key/value heads, ``whisper-small`` 12;
``model`` has 16 ranks.  The port's forward and prefill gather such a
layer's projections whole (``models/transformer.py:_heads_split``).  The
reference's partitioner instead keeps them cut by columns and gathers the
activations: every head's query, key and value columns (for
cross-attention, the encoder's key and value columns), so each rank
attends with every head and ``o_proj``'s rows take the rank's columns of
the output.  This script traces a cell in the port's layout and then with
that layout patched in (the gathered columns' gradient reduce-scattered),
and prints for each its per-rank collective bytes by group size, FLOPs
and temporary bytes, then one JSON line with both.
``tests/test_torch_model_axis.py`` holds the patched layout against the
port's (one training step on four gloo ranks) and its traffic against
the reference's compiled step.

    PYTHONPATH=src python tools/uneven_heads.py [--arch smollm-360m]
        [--shape train_4k] [--mesh single] [--reduced]

``--reduced`` traces the reduced config (head_dim 64, the attention
kernel's) over 4 × 64 tokens on data 1 × model 4 instead (seconds, not a
minute).  Needs no card: the dry-run runs on fake tensors
(``launch/dryrun.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import tempfile


@contextlib.contextmanager
def activation_layout():
    """The reference's layout of attention with uneven heads, patched into
    ``models/transformer.py`` for the ``with`` block."""
    from repro_torch.models import transformer as T

    block, cross, rule = T._attn_block, T._cross, T._heads_split

    def uneven(split, cfg) -> bool:
        return split is not None and not rule(cfg, split.index()[1],
                                              decode=False)

    def columns(h, p, cfg, positions, *, causal, window, want_cache=False,
                plain=False):
        split = T._attn_split(p, cfg)
        if not uneven(split, cfg):
            return block(h, p, cfg, positions, causal=causal,
                         window=window, want_cache=want_cache, plain=plain)
        b, s, _ = h.shape
        x = split.enter(h)
        q, k, v = (split.join(x @ p[w], summed=True)
                   for w in ("q_proj", "k_proj", "v_proj"))
        q = T._rope(T._heads(q, cfg.head_dim), positions, cfg)
        k = T._rope(T._heads(k, cfg.head_dim), positions, cfg)
        v = T._heads(v, cfg.head_dim)
        cache = None
        if want_cache:
            t = s if window is None else min(s, window)
            cache = {"k": k[:, s - t:], "v": v[:, s - t:]}
        out = T.L.attention(q, k, v, causal=causal, window=window,
                            plain=plain)
        return T._rows_out(out.reshape(b, s, -1), p, split), cache

    def cross_columns(h, p, cfg, enc_kv, plain=False):
        cp = p["cross"]
        split = T._attn_split(cp, cfg)
        if not uneven(split, cfg):
            return cross(h, p, cfg, enc_kv, plain=plain)
        x = split.enter(T._norm(h, p["ln_cross"], p.get("ln_cross_b"),
                                cfg.norm_eps))
        q = split.join(x @ cp["q_proj"], summed=True)
        k, v = (split.join(t, summed=True) for t in enc_kv)
        out = T.L.attention(*(T._heads(t, cfg.head_dim) for t in (q, k, v)),
                            causal=False, plain=plain)
        return T._rows_out(out.reshape(q.shape), cp, split)

    T._attn_block, T._cross = columns, cross_columns
    T._heads_split = lambda cfg, m, decode: True
    try:
        yield
    finally:
        T._attn_block, T._cross, T._heads_split = block, cross, rule


def trace(arch: str, shape: str, mesh: str, reduced: bool) -> dict:
    """One cell's record (``dryrun.run_cell``) → the numbers printed."""
    from repro_torch.configs import (SHAPES, MeshConfig, ShapeConfig,
                                     reduced_config)
    from repro_torch.launch.dryrun import run_cell

    kw = {}
    if reduced:
        kind = SHAPES[shape].kind
        cfg = dataclasses.replace(reduced_config(arch), head_dim=64)
        kw = dict(cfg=cfg, mesh_cfg=MeshConfig(data=1,
                                                                model=4),
                  shape=ShapeConfig(shape, 64, 4, kind))
    with tempfile.TemporaryDirectory() as out:
        rec = run_cell(arch, shape, mesh, out, **kw)
    if rec["status"] != "ok":
        raise RuntimeError(rec.get("traceback", rec["status"]))
    cost = rec["hlo_cost"]
    return {"collective_bytes": cost["collective_bytes"],
            "collectives_by_group": cost["collectives_by_group"],
            "flops": cost["flops"],
            "temp_bytes": rec["memory"]["temp_bytes"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    cell = (args.arch, args.shape, args.mesh, args.reduced)
    res = {"weights": trace(*cell)}
    print(f"[uneven_heads] weights gathered (the port's): {res['weights']}",
          flush=True)
    with activation_layout():
        res["activations"] = trace(*cell)
    print(f"[uneven_heads] activations gathered (the reference's): "
          f"{res['activations']}", flush=True)
    out = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "reduced": args.reduced, **res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
