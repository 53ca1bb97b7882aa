"""Mamba (S6) block, the SSM half of Jamba [arXiv:2312.00752, 2403.19887].

A port of ``repro/models/mamba.py``.  Prefill and training run a chunked
selective scan: the sequence is cut into ``CHUNK``-long pieces (the last
one ragged, so every length runs); within a chunk the diagonal linear
recurrence

    h_t = a_t * h_{t-1} + b_t,   a_t = exp(Δ_t ⊙ A),  b_t = Δ_t B_t x_t

is a log-depth Hillis–Steele scan of the reference's ``combine`` over
``(B, c, di, ds)``, and a loop over chunks carries the boundary state.
Each chunk is recomputed in the backward (non-reentrant
``torch.utils.checkpoint``), as ``jax.checkpoint(outer)`` does.  The scan
is torch ops: the reference writes it in jnp, with no Pallas kernel.

Decode is the single-step recurrence over ``(conv, ssm)`` states.

On a mesh a rank computes its own slice of ``d_inner``, as the reference's
partitioner cuts the layer (its ``xin`` pinned to ``model``, the weights'
specs of ``parallel/sharding.py``), in the forward, prefill and decode
alike: ``xz`` is the rank's x and z columns of the in-projection's product
and a ``layers.Split`` sums the x- and out-projections' partial products;
the causal conv, the scan, ``d_skip`` and the gate run on the slice, and
the states a prefill or a decode step returns are the rank's slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs import ModelConfig

__all__ = ["CHUNK", "init_mamba", "mamba_forward", "mamba_decode_step",
           "init_mamba_cache"]

CHUNK = 128


def _dt_rank(cfg: ModelConfig) -> int:
    return -(-cfg.d_model // 16)


def init_mamba(normal, full, cfg: ModelConfig) -> dict:
    """One Mamba mixer's parameters in the reference's layout, scales and
    dtypes (``mamba.py:31-47``): ``normal(shape, scale)`` draws a weight
    in the model's dtype, ``full(shape, value, dtype=None)`` fills one
    (``a_log`` and ``d_skip`` fp32)."""
    d = cfg.d_model
    di = cfg.expand * d
    ds, dc, dtr = cfg.d_state, cfg.d_conv, _dt_rank(cfg)
    a = torch.arange(1, ds + 1, dtype=torch.float32).log()
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((dc, di), dc ** -0.5),
        "conv_b": full((di,), 0.0),
        "x_proj": normal((di, dtr + 2 * ds), di ** -0.5),
        "dt_proj": normal((dtr, di), dtr ** -0.5),
        "dt_bias": full((di,), -4.6),  # softplus^-1(0.01)
        "a_log": full((di, ds), a, torch.float32),
        "d_skip": full((di,), 1.0, torch.float32),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over (B, S, di) with kernel (dc, di); the
    ``dc - 1`` steps before the sequence are ``init_state`` (else 0)."""
    dc = w.shape[0]
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([init_state, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, dc):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _scan_chunk(h, delta, a, bmat, xbar, cmat):
    """One chunk: the state after every step from ``h`` (B, di, ds) →
    (y = C_t·h_t (B, c, di), the last state)."""
    ac = torch.exp(delta[..., None] * a)                 # (B, c, di, ds)
    bc = xbar[..., None] * bmat[:, :, None, :]           # (B, c, di, ds)
    c = ac.shape[1]
    step = 1
    while step < c:  # Hillis–Steele: combine(l, r) = (al·ar, bl·ar + br)
        ac, bc = (torch.cat([ac[:, :step], ac[:, step:] * ac[:, :-step]], 1),
                  torch.cat([bc[:, :step],
                             bc[:, :-step] * ac[:, step:] + bc[:, step:]],
                            1))
        step *= 2
    h_all = bc + ac * h[:, None]
    y = torch.einsum("bcdn,bcn->bcd", h_all, cmat)
    # a copy: a view would hold every step's state for as long as the
    # next chunk's checkpoint keeps its input
    return y, h_all[:, -1].clone()


class _Repeated(torch.autograd.Function):
    """The scan's chunk loop on the dry-run's fake tensors
    (``introspect/opcount.py``, ``introspect/memory.py``), traced from its
    first chunk: ``parts`` holds each chunk's ``(delta, bmat, xbar,
    cmat)`` in turn, every chunk of the same shapes.

    The forward runs the first chunk and adds its counted work once for
    each other chunk; the states between chunks, which the loop's
    checkpoints keep, are held as tensors of their shape.  The backward
    walks the chunks from the last, as the autograd engine does: for each
    kind of chunk (the last, whose final state may have no gradient; the
    middle ones; the first, whose state is ``h``) it builds the chunk's
    checkpointed graph, runs its recomputation and gradient once and adds
    that work once for each other chunk of the kind, freeing each chunk's
    state and keeping its gradients, as the split's backward holds them
    until it joins all ``n``.  ``a``'s gradient is summed ``n``
    times, as the engine sums the loop's ``n`` uses of it."""

    @staticmethod
    def forward(ctx, h, a, *parts):
        from repro_torch.introspect import opcount

        ctx.set_materialize_grads(False)
        n = ctx.times = len(parts) // 4
        ctx.save_for_backward(h, a, *parts[:4])
        with opcount.count() as fwd:
            out = _scan_chunk(h, parts[0], a, *parts[1:4])
        opcount.add_work(fwd, n - 1)
        ctx.states = [h.new_empty(h.shape) for _ in range(n - 1)]
        return out

    @staticmethod
    def backward(ctx, gy, gh):
        from torch.autograd.graph import get_gradient_edge

        from repro_torch.introspect import opcount

        n = ctx.times
        h, a, d_c, b_c, x_c, c_c = ctx.saved_tensors
        wanted = [ctx.needs_input_grad[i] for i in (2, 1, 3, 4, 5)]
        held, g_next = [], gh
        for times, h_grad in ((1, True), (n - 2, True),
                              (1, ctx.needs_input_grad[0])):
            if times <= 0:
                continue
            need = [h_grad] + wanted
            ins = [t.detach().requires_grad_(r)
                   for t, r in zip((h, d_c, a, b_c, x_c, c_c), need)]
            # the graph's first forward is not the loop's: off the counts,
            # and its outputs freed before the backward, as the loop's are
            with torch.enable_grad(), opcount.count() as rebuilt:
                out = ckpt.checkpoint(_scan_chunk, *ins, use_reentrant=False)
            opcount.add_work(rebuilt, -1)
            pairs = [(get_gradient_edge(o), g)
                     for o, g in zip(out, (gy, g_next)) if g is not None]
            del out
            with opcount.count() as back:
                grads = iter(torch.autograd.grad(
                    [e for e, _ in pairs], [t for t in ins if t.requires_grad],
                    [g for _, g in pairs], allow_unused=True))
            opcount.add_work(back, times - 1)
            g = [next(grads) if r else None for r in need]
            g_next, part = g[0], [g[1], g[3], g[4], g[5]]
            for i in range(times):
                if ctx.states:
                    ctx.states.pop()
                held.append(part if i == 0 else [
                    None if x is None else torch.empty_like(x)
                    for x in part])
        g_a = g[2]
        if g_a is not None:
            g_a1 = g_a
            for _ in range(n - 1):
                g_a = g_a + g_a1
        return (g[0], g_a, *(x for chunk in reversed(held) for x in chunk))


def _selective_scan(delta: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                    xbar: torch.Tensor, cmat: torch.Tensor, h0: torch.Tensor,
                    chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective diagonal SSM over (B, S), all fp32: ``delta``/``xbar``
    (B, S, di), ``a`` (di, ds), ``bmat``/``cmat`` (B, S, ds), ``h0`` (B,
    di, ds) → (y (B, S, di), the final state).  Chunks of ``chunk`` steps,
    the last one ragged; each is recomputed in the backward when autograd
    records.  The inputs are split into their chunks once, so the
    backward joins the chunks' gradients in one op.

    On the dry-run's fake tensors (``kernels/_build.is_fake``) a sequence
    of whole chunks runs its first chunk only and counts it for every
    chunk (:class:`_Repeated`); the other chunks' outputs are shaped, not
    traced, so a long sequence traces in the time of one chunk, with the
    loop's counts."""
    from repro_torch.kernels._build import is_fake

    s = delta.shape[1]
    n = -(-s // chunk)
    parts = [x.split(chunk, dim=1) for x in (delta, bmat, xbar, cmat)]
    if n > 1 and s % chunk == 0 and is_fake(delta):
        y, h = _Repeated.apply(h0, a, *(x for chunk in zip(*parts)
                                        for x in chunk))
        return torch.cat([y] + [y.new_empty(y.shape) for _ in range(n - 1)],
                         1), h
    h, ys = h0, []
    for d_c, b_c, x_c, c_c in zip(*parts):
        if torch.is_grad_enabled():
            y, h = ckpt.checkpoint(_scan_chunk, h, d_c, a, b_c, x_c, c_c,
                                   use_reentrant=False)
        else:
            y, h = _scan_chunk(h, d_c, a, b_c, x_c, c_c)
        ys.append(y)
    return torch.cat(ys, 1), h


def _x_proj(xc: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, split
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dt, B and C from the conv's output: on a mesh the partial products
    of the rank's rows of ``x_proj`` summed first, then taken as the
    input of the rank's part again (dt feeds its ``dt_proj`` columns, B
    and C its slice of the scan)."""
    proj = xc @ w
    if split is not None:
        proj = split.enter(split.exit(proj))
    ds = cfg.d_state
    return proj.split([_dt_rank(cfg), ds, ds], dim=-1)


def mamba_forward(x: torch.Tensor, params: dict, cfg: ModelConfig,
                  cache: dict | None = None, *,
                  xz: torch.Tensor | None = None, split=None
                  ) -> tuple[torch.Tensor, dict | None]:
    """(B, S, D) → (B, S, D); with ``cache`` (its states before the
    sequence) also the cache after it, as decode takes it.

    On a mesh (``split``, a ``layers.Split``) ``params`` and ``cache``
    hold this rank's slice of ``d_inner``, ``xz`` is the rank's x and z
    columns of the in-projection's product (B, S, 2·di/n), and the
    returned states are the rank's slices."""
    s = x.shape[1]
    if xz is None:
        xz = x @ params["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    conv_init = None if cache is None else cache["conv"]
    xc = F.silu(_causal_conv(xin, params["conv_w"], params["conv_b"],
                             conv_init))
    dt, bmat, cmat = _x_proj(xc, params["x_proj"], cfg, split)
    delta = F.softplus(dt @ params["dt_proj"] + params["dt_bias"]).float()
    a = -torch.exp(params["a_log"])  # (di, ds)
    xbar = delta * xc.float()
    if cache is None:
        h0 = x.new_zeros((x.shape[0],) + tuple(params["a_log"].shape),
                         dtype=torch.float32)
    else:
        h0 = cache["ssm"]
    y, h_last = _selective_scan(delta, a, bmat.float(), xbar, cmat.float(),
                                h0)
    y = y + params["d_skip"] * xc.float()
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    if split is not None:
        out = split.exit(out)
    if cache is None:
        return out, None
    dc = params["conv_w"].shape[0]
    conv = xin[:, s - (dc - 1):] if s >= dc - 1 else \
        torch.cat([cache["conv"][:, s:], xin], dim=1)
    return out, {"conv": conv, "ssm": h_last}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> dict:
    """Zero decode states: ``conv`` (B, d_conv - 1, di) in ``dtype``,
    ``ssm`` (B, di, d_state) in fp32."""
    di = cfg.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                           device=device),
    }


def _ssm_step(h: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
              bmat: torch.Tensor, cmat: torch.Tensor,
              xc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence on the state ``h`` (B, di, ds), fp32 →
    (y = C·h' (B, di), the new state h')."""
    abar = torch.exp(delta[..., None] * a)  # (B, di, ds)
    bbar = (delta * xc)[..., None] * bmat[:, None, :]
    h = abar * h + bbar
    return torch.einsum("bdn,bn->bd", h, cmat), h


def mamba_decode_step(x: torch.Tensor, params: dict, cfg: ModelConfig,
                      cache: dict, *, xz: torch.Tensor | None = None,
                      split=None) -> tuple[torch.Tensor, dict]:
    """One token, ``x`` (B, 1, D) → (out (B, 1, D), the new states); on a
    mesh over this rank's slice of ``d_inner`` as in
    :func:`mamba_forward`, ``xz`` (B, 1, 2·di/n)."""
    if xz is None:
        xz = x @ params["in_proj"]
    xin, z = xz[:, 0].chunk(2, dim=-1)  # (B, di)
    conv_buf = torch.cat([cache["conv"], xin[:, None]], dim=1)  # (B, dc, di)
    xc = F.silu(torch.einsum("bcd,cd->bd", conv_buf, params["conv_w"])
                + params["conv_b"])
    dt, bmat, cmat = _x_proj(xc, params["x_proj"], cfg, split)
    delta = F.softplus(dt @ params["dt_proj"] + params["dt_bias"]).float()
    a = -torch.exp(params["a_log"])
    y, h = _ssm_step(cache["ssm"], delta, a, bmat.float(), cmat.float(),
                     xc.float())
    y = y + params["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    if split is not None:
        out = split.exit(out)
    return out[:, None], {"conv": conv_buf[:, 1:], "ssm": h}
