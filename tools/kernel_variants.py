#!/usr/bin/env python3
"""Time variants of the hand-written kernels against the committed ones.

    python3 tools/kernel_variants.py [attention] [conv] [asm] [--parent DIR]

Each variant is a named set of text edits to ``src/repro_torch/csrc/*.cu``:
an ablation (a part of the kernel removed, so its results are wrong and
only its time means something) or another tile shape.  Every variant is
built by ``_build.build`` like the committed sources (the same flags, one
``nvcc`` per source, all started together) into ``build/variants/<name>/``,
loaded with ``_build.use`` in place of the committed library, and timed
with ``chip_smoke.cuda_ms`` in two rounds:

* attention: bf16 ``flash_attention`` at ``smollm-360m``'s prefill (q
  (4, 2048, 15, 64), causal) and at ``mistral-nemo-12b``'s heads (q (1,
  4096, 32, 128), causal), with the error against SDPA;
* conv: ``jpeg_conv`` at s1b0.conv1 (coef (4, 32, 32, 64, 64), Ξ for 16
  bands, stride 2), at the s2b0 projection (coef (4, 16, 16, 128, 64), a
  1×1 stride-2 Ξ for 16 bands: the one shape of the served path where
  ``jpeg_conv.tile_rows`` picks 64 rows) and an s0b0-shaped
  ``fused_block`` (64 → 64 channels at width 16), each with the 64- and
  the 128-row tiles (forced by replacing ``jpeg_conv.tile_rows``), with
  the error against the plain version;
* asm: ``asm_relu`` at 262,144 rows of 64 lanes read at w = 16, 32, 48
  and 64, and ``fused_block`` at s0b0 (x (4, 32, 32, 64·16), 64 → 64
  channels, width 16) and s1b0 (64 → 128 channels, stride 2, projection),
  each with the 64- and the 128-row banded-conv tiles.  With ``--parent
  DIR`` (a directory holding an earlier ``csrc/*.cu``, such as ``git
  archive`` of the parent commit's ``src/repro_torch/csrc``), the set also
  times that source as it is and with its ASM epilogue skipped.

Needs one CUDA card of capability 9.0 and ``nvcc``; prints the card's
name and power limit first.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

FA, JK = "flash_attention.cu", "jpeg_kernels.cu"

_SHAPE = """  static constexpr int MT = 2;  // m16 tiles a warp
  static constexpr int WARPS = HD == 64 ? 4 : 8;
  static constexpr int MINB = HD == 64 ? 2 : 1;"""


def _shape(hd64: tuple, hd128: tuple) -> dict:
    """Attention tile shape per head dim: (MT, WARPS, MINB)."""
    lines = [f"  static constexpr int {k} = HD == 64 ? {a} : {b};"
             for k, a, b in zip(("MT", "WARPS", "MINB"), hd64, hd128)]
    return {FA: [(_SHAPE, "\n".join(lines))]}


SETS = {
    "attention": {
        "as committed": {},
        "no K/V loads after the first two tiles": {FA: [(
            "if (it + 2 < ntiles) load_kv(it + 2);",
            "if (false) load_kv(it + 2);")]},
        "no exponentials": {FA: [
            ("ex2(fmaf(sc[mt][j][2 * r], scale_log2, -mc[rr]))",
             "fmaf(sc[mt][j][2 * r], scale_log2, -mc[rr])"),
            ("ex2(fmaf(sc[mt][j][2 * r + 1], scale_log2, -mc[rr]))",
             "fmaf(sc[mt][j][2 * r + 1], scale_log2, -mc[rr])"),
            ("alpha[rr] = ex2((m[rr] - m_new) * scale_log2);",
             "alpha[rr] = 1.f;")]},
        "no P·V": {FA: [("for (int kc = 0; kc < NK / 2; ++kc) {",
                         "for (int kc = 0; kc < 0; ++kc) {")]},
        "no Q·Kᵀ": {FA: [("for (int kk = 0; kk < KT; ++kk) {\n      uint32_t qa",
                          "for (int kk = 0; kk < 0; ++kk) {\n      uint32_t qa")]},
        "16-row warps: 4 (hd 64, 3 CTAs an SM) or 8 (hd 128)":
            _shape((1, 4, 3), (1, 8, 1)),
        "16-row warps, 8 of them (hd 64, 2 CTAs an SM; hd 128)":
            _shape((1, 8, 2), (1, 8, 1)),
        "32-row warps: 8 at hd 64, 4 at hd 128 (2 CTAs an SM)":
            _shape((2, 8, 1), (2, 4, 2)),
    },
    "conv": {
        "as committed": {},
        "16-wide K slices": {JK: [
            ("constexpr int BK = 32;", "constexpr int BK = 16;"),
            ("constexpr int LDA = BK + 4;", "constexpr int LDA = BK;")]},
        "three stages": {JK: [("constexpr int STAGES = 2;",
                               "constexpr int STAGES = 3;")]},
        "two CTAs an SM for the 128-row tiles": {JK: [(
            "__launch_bounds__(THREADS, BM == 128 ? 1 : 2)",
            "__launch_bounds__(THREADS, 2)")]},
        "no loads after the first slice": {JK: [(
            "if (s + STAGES - 1 < nk) load(", "if (false) load(")]},
        "no FFMA loop": {JK: [("for (int kq = 0; kq < BK; kq += 4) {",
                               "for (int kq = 0; kq < 0; kq += 4) {")]},
    },
    "asm": {
        "as committed": {},
        "no product 2": {JK: [(
            "kq < NF; kq += 4) {  // product 2's K loop",
            "kq < 0; kq += 4) {  // product 2's K loop")]},
        "no loads after the first tile": {JK: [(
            "if (tile + gridDim.x < ntiles)", "if (false)")]},
        "no ASM epilogue": {JK: [(
            "for (int ch = 0; ch < a.cpt && c0 + ch < a.cout; ++ch) {",
            "for (int ch = 0; ch < 0; ++ch) {")]},
        "64-row asm_kernel tiles": {JK: [(
            "constexpr int ASM_BM = 128;", "constexpr int ASM_BM = 64;")]},
        "asm_kernel at one CTA an SM": {JK: [(
            "__launch_bounds__(THREADS, 2) asm_kernel(",
            "__launch_bounds__(THREADS, 1) asm_kernel(")]},
        "both K loops unrolled by 2": {JK: [
            ("      for (int kq = 0; kq < kw; kq += 4) {",
             "#pragma unroll 2\n      for (int kq = 0; kq < kw; kq += 4) {"),
            ("  for (int kq = 0; kq < NF; kq += 4) {  // product 2's K loop",
             "#pragma unroll 2\n  for (int kq = 0; kq < NF; kq += 4) {")]},
        # the stores skipped at run time (the compiler cannot tell, so the
        # products stay)
        "no output stores": {JK: [
            ("if (rows[i] >= nrows) continue;",
             "if (rows[i] >= nrows || ld_out >= 0) continue;"),
            ("bulk_store(out + r0 * ld_out, obuf, nrows * ld_out * 4);",
             ";")]},
        "stores by the threads, no bulk copy": {JK: [(
            "const bool bulk = vo && w < ld_out && ld_out <= NF;",
            "const bool bulk = false;")]},
        "bulk copy for full rows too": {JK: [(
            "const bool bulk = vo && w < ld_out && ld_out <= NF;",
            "const bool bulk = vo && ld_out <= NF;")]},
        "no product 1": {JK: [("for (int kq = 0; kq < kw; kq += 4) {",
                               "for (int kq = 0; kq < 0; kq += 4) {")]},
    },
}

#: variants of the source before the ASM tile routine (``--parent``): one
#: warp a (row, channel) pair in the epilogue
PARENT_SETS = {
    "asm": {
        "parent as it is": {},
        "parent, no ASM epilogue": {JK: [(
            "for (int pr = warp; pr < BM * a.cpt; pr += WARPS) {",
            "for (int pr = warp; pr < 0; pr += WARPS) {")]},
    },
}


def build(name: str, edits: dict, src_dir: str | None = None
          ) -> tuple[str, str]:
    """Compile the edited sources (the committed ones, or those of the same
    names in ``src_dir``) into one library; returns its path and the
    compiler's ``-Xptxas -v`` report."""
    from repro_torch.kernels import _build

    out = os.path.join(ROOT, "build", "variants",
                       "".join(c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    paths = []
    for src in _build.SOURCES:
        if src_dir is not None:
            src = Path(src_dir) / src.name
        text = src.read_text()
        for old, new in edits.get(src.name, ()):
            if old not in text:
                raise SystemExit(f"{name}: edit not found in {src.name}: "
                                 f"{old!r}")
            text = text.replace(old, new)
        paths.append(os.path.join(out, src.name))
        with open(paths[-1], "w") as f:
            f.write(text)
    lib = _build.build(paths, out)
    return str(lib), str(_build.build_log().get("ptxas", ""))


def attention_cases(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.introspect import opcount

    g = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for label, b, s, h, kvh, hd in (("smollm-360m prefill", 4, 2048, 15, 5, 64),
                                    ("mistral-nemo-12b heads", 1, 4096, 32, 8,
                                     128)):
        q = torch.randn((b, s, h, hd), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, s, kvh, hd), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        want = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True,
            enable_gqa=True).transpose(1, 2).float()
        flops = 4.0 * b * h * hd * opcount.attention_pairs(s, s, True, None)
        cases.append((label, (q, k, v), want, flops))
    return cases


def conv_cases(dev):
    import torch

    from repro_torch.core import conv as convlib
    from repro_torch.kernels import fused_block as kfb
    from repro_torch.kernels import jpeg_conv as kjc
    from repro_torch.kernels import tiling

    g = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn((128, 64, 3, 3), generator=g, device=dev) * 0.1
    xi = convlib.explode(k, 2, bands=16).contiguous()
    coef = torch.randn((4, 32, 32, 64, 64), generator=g, device=dev)
    shift = torch.randn((128,), generator=g, device=dev)

    def conv():
        return kjc.jpeg_conv(coef, xi, 2, shift=shift, w_out=64)

    def pc():
        kk = torch.randn((64, 64, 3, 3), generator=g, device=dev) * 0.05
        sh = torch.randn((64,), generator=g, device=dev)
        return tiling.pack_conv(convlib.explode(kk, 1, bands=16), sh, 1,
                                w_in=16, w_out=16)

    ops = (torch.randn((4, 32, 32, 64 * 16), generator=g, device=dev), pc(),
           tiling.pack_asm(14, 16, 16, device=dev), pc(),
           tiling.pack_asm(14, 16, 16, device=dev), None)
    kp = torch.randn((256, 128, 1, 1), generator=g, device=dev) * 0.1
    xi_p = convlib.explode(kp, 2, bands=16).contiguous()
    coef_p = torch.randn((4, 16, 16, 128, 64), generator=g, device=dev)
    shift_p = torch.randn((256,), generator=g, device=dev)

    def proj():
        return kjc.jpeg_conv(coef_p, xi_p, 2, shift=shift_p, w_out=64)

    return [("jpeg_conv s1b0.conv1", conv,
             kjc.jpeg_conv_plain(coef, xi, 2, shift=shift, w_out=64)),
            ("jpeg_conv s2b0.proj", proj,
             kjc.jpeg_conv_plain(coef_p, xi_p, 2, shift=shift_p, w_out=64)),
            ("fused_block s0b0", lambda: kfb.fused_block(*ops),
             kfb.fused_block_reference(*ops))]


def asm_cases(dev):
    import torch

    from repro_torch.core import conv as convlib
    from repro_torch.kernels import asm_relu as kasm
    from repro_torch.kernels import fused_block as kfb
    from repro_torch.kernels import tiling

    g = torch.Generator(device=dev).manual_seed(1)
    t = torch.randn((262144, 64), generator=g, device=dev)
    cases = []
    for w in (16, 32, 48, 64):
        cases.append((f"asm_relu w={w}",
                      lambda w=w: kasm.asm_relu(t, 14, bands=w),
                      kasm.asm_relu_plain(t, 14, bands=w)))

    def pc(cin, cout, stride, r):
        k = torch.randn((cout, cin, r, r), generator=g, device=dev) * 0.05
        sh = torch.randn((cout,), generator=g, device=dev)
        return tiling.pack_conv(convlib.explode(k, stride, bands=16), sh,
                                stride, w_in=16, w_out=16)

    asm = (tiling.pack_asm(14, 16, 16, device=dev),
           tiling.pack_asm(14, 16, 16, device=dev))
    x = torch.randn((4, 32, 32, 64 * 16), generator=g, device=dev)
    for label, cout, s in (("s0b0", 64, 1), ("s1b0", 128, 2)):
        ops = (x, pc(64, cout, s, 3), asm[0], pc(cout, cout, 1, 3), asm[1],
               pc(64, cout, s, 1) if s == 2 else None)
        cases.append((f"fused_block {label}",
                      lambda ops=ops: kfb.fused_block(*ops),
                      kfb.fused_block_reference(*ops)))
    return cases


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import jpeg_conv as kjc

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = args[i + 1]
        del args[i:i + 2]
    sets = args or list(SETS)
    dev = torch.device("cuda", 0)
    libs = {}
    shown = {"attention": ("flash_attention_tc",),
             "conv": ("banded_conv",), "asm": ("banded_conv", "asm_kernel")}
    for which in sets:
        variants = [(name, edits, None) for name, edits in SETS[which].items()]
        if parent is not None:
            variants += [(name, edits, parent) for name, edits
                         in PARENT_SETS.get(which, {}).items()]
        for name, edits, src_dir in variants:
            lib, log = build(f"{which} {name}", edits, src_dir)
            libs[(which, name)] = lib
            for line in cs.ptxas_report(log):
                if any(k in line for k in shown[which]):
                    print(f"{which} / {name}: ptxas {line}", flush=True)
    with torch.inference_mode():
        makers = {"attention": attention_cases, "conv": conv_cases,
                  "asm": asm_cases}
        cases = {k: makers[k](dev) for k in sets}
        tile_rows = kjc.tile_rows
        for rnd in range(2):
            for (which, name), lib in libs.items():
                _build.use(lib)
                row = {"round": rnd, "set": which, "variant": name}
                if which == "attention":
                    for label, qkv, want, flops in cases[which]:
                        got = kfa.flash_attention(*qkv)
                        ms = cs.cuda_ms(lambda: kfa.flash_attention(*qkv))
                        row[label] = {
                            "ms": ms, "tflops": flops / ms / 1e9,
                            "err_vs_sdpa": float((got.float() - want)
                                                 .abs().max())}
                for label, fn, want in cases[which] \
                        if which in ("conv", "asm") else ():
                    # both banded-conv tile heights; asm_relu has one
                    for bm in kjc.TILE_ROWS[:1 if "asm_relu" in label
                                            else 2]:
                        kjc.tile_rows = lambda *_, bm=bm: bm
                        err = float((fn() - want).abs().max())
                        key = label if "asm_relu" in label \
                            else f"{label} bm{bm}"
                        row[key] = {"ms": cs.cuda_ms(fn), "err": err}
                    kjc.tile_rows = tile_rows
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
