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
    return y, h_all[:, -1]


def _selective_scan(delta: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                    xbar: torch.Tensor, cmat: torch.Tensor, h0: torch.Tensor,
                    chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective diagonal SSM over (B, S), all fp32: ``delta``/``xbar``
    (B, S, di), ``a`` (di, ds), ``bmat``/``cmat`` (B, S, ds), ``h0`` (B,
    di, ds) → (y (B, S, di), the final state).  Chunks of ``chunk`` steps,
    the last one ragged; each is recomputed in the backward when autograd
    records."""
    s = delta.shape[1]
    h, ys = h0, []
    for lo in range(0, s, chunk):
        part = [x[:, lo:lo + chunk] for x in (delta, bmat, xbar, cmat)]
        d_c, b_c, x_c, c_c = part
        if torch.is_grad_enabled():
            y, h = ckpt.checkpoint(_scan_chunk, h, d_c, a, b_c, x_c, c_c,
                                   use_reentrant=False)
        else:
            y, h = _scan_chunk(h, d_c, a, b_c, x_c, c_c)
        ys.append(y)
    return torch.cat(ys, 1), h


def mamba_forward(x: torch.Tensor, params: dict, cfg: ModelConfig,
                  cache: dict | None = None
                  ) -> tuple[torch.Tensor, dict | None]:
    """(B, S, D) → (B, S, D); with ``cache`` (its states before the
    sequence) also the cache after it, as decode takes it."""
    s = x.shape[1]
    ds, dtr = cfg.d_state, _dt_rank(cfg)
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    conv_init = None if cache is None else cache["conv"]
    xc = F.silu(_causal_conv(xin, params["conv_w"], params["conv_b"],
                             conv_init))
    dt, bmat, cmat = (xc @ params["x_proj"]).split([dtr, ds, ds], dim=-1)
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


def mamba_decode_step(x: torch.Tensor, params: dict, cfg: ModelConfig,
                      cache: dict) -> tuple[torch.Tensor, dict]:
    """One token, ``x`` (B, 1, D) → (out (B, 1, D), the new states)."""
    ds, dtr = cfg.d_state, _dt_rank(cfg)
    xin, z = (x[:, 0] @ params["in_proj"]).chunk(2, dim=-1)  # (B, di)
    conv_buf = torch.cat([cache["conv"], xin[:, None]], dim=1)  # (B, dc, di)
    xc = F.silu(torch.einsum("bcd,cd->bd", conv_buf, params["conv_w"])
                + params["conv_b"])
    dt, bmat, cmat = (xc @ params["x_proj"]).split([dtr, ds, ds], dim=-1)
    delta = F.softplus(dt @ params["dt_proj"] + params["dt_bias"]).float()
    a = -torch.exp(params["a_log"])
    abar = torch.exp(delta[..., None] * a)  # (B, di, ds)
    bbar = (delta * xc.float())[..., None] * bmat.float()[:, None, :]
    h = abar * cache["ssm"] + bbar
    y = torch.einsum("bdn,bn->bd", h, cmat.float())
    y = y + params["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return (y @ params["out_proj"])[:, None], {"conv": conv_buf[:, 1:],
                                               "ssm": h}
