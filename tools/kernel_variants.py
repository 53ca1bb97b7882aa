#!/usr/bin/env python3
"""Time variants of the hand-written kernels against the committed ones.

    python3 tools/kernel_variants.py [attention] [attention_bwd] [conv] [asm]
                                     [--parent DIR]

Each variant is a named set of text edits to ``src/repro_torch/csrc/*.cu``:
an ablation (a part of the kernel removed, so its results are wrong and
only its time means something) or another tile shape.  Every variant is
built by ``_build.build`` like the committed sources (the same flags, one
``nvcc`` per source, all started together; the variants themselves are
built side by side, one process each) into ``build/variants/<name>/``,
loaded with ``_build.use`` in place of the committed library, and timed
with ``chip_smoke.cuda_ms`` in two rounds:

* attention: bf16 ``flash_attention`` at ``smollm-360m``'s prefill (q
  (4, 2048, 15, 64), causal) and at ``mistral-nemo-12b``'s heads (q (1,
  4096, 32, 128), causal), with the error against SDPA;
* attention_bwd: the bf16 backward (``flash_attention_backward``, its
  three launches) at the same two shapes, fed by the forward's output,
  its bf16 rounding residual and lse, as a training step feeds it, with
  the largest error of dq, dk and dv against the fp32 plain backward,
  SDPA's backward through autograd timed beside it once a
  round, and each kernel's device ms (dK/dV, dQ, D) from
  ``torch.profiler``; the variants weigh the dK/dV kernel's keys a warp
  (16 or 32), query tile (64 or 32), ring depth (2 or 3), K and V
  fragments in registers or reloaded, and warps a CTA, the dQ kernel's
  rows a warp, ring depth, Q and dO fragments and warps a CTA, and, as an
  ablation over the gate, P and dS rounded once to bf16 (no lo halves).
  With ``--parent DIR`` the set also times that source's backward as it
  is (an earlier source may run fp32 FFMA for bf16 operands too).  Only
  ``flash_attention.cu`` is built for the attention sets;
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
import multiprocessing as mp
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

FA, JK = "flash_attention.cu", "jpeg_kernels.cu"
#: the sources each set builds (a library without the others' entry points
#: still loads: ``_build.use`` binds what it finds)
BUILDS = {"attention": (FA,), "attention_bwd": (FA,)}

_SHAPE = """  static constexpr int MT = 2;  // m16 tiles a warp
  static constexpr int WARPS = HD == 64 ? 4 : 8;
  static constexpr int MINB = HD == 64 ? 2 : 1;"""


def _shape(hd64: tuple, hd128: tuple) -> dict:
    """Attention tile shape per head dim: (MT, WARPS, MINB)."""
    lines = [f"  static constexpr int {k} = HD == 64 ? {a} : {b};"
             for k, a, b in zip(("MT", "WARPS", "MINB"), hd64, hd128)]
    return {FA: [(_SHAPE, "\n".join(lines))]}


_DKDV = """  static constexpr int MT = 1;  // m16 key tiles a warp
  static constexpr int WARPS = 4;
  static constexpr int BQ = 64;
  static constexpr int STAGES = 2;
  static constexpr bool KREG = HD == 64;
  static constexpr int MINB = 2;"""

_DQ = """  static constexpr int MT = 1;  // m16 row tiles a warp
  static constexpr int WARPS = 4;
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr bool QREG = HD == 64;
  static constexpr int MINB = 2;"""


def _dkdv(mt=1, warps=4, bq=64, stages=2, kreg="HD == 64", minb=2) -> dict:
    """The bf16 dK/dV kernel's tile shape (``DkdvShape``)."""
    return {FA: [(_DKDV, f"""  static constexpr int MT = {mt};  // m16 key tiles a warp
  static constexpr int WARPS = {warps};
  static constexpr int BQ = {bq};
  static constexpr int STAGES = {stages};
  static constexpr bool KREG = {kreg};
  static constexpr int MINB = {minb};""")]}


def _dq(mt=1, warps=4, stages="HD == 64 ? 3 : 2", qreg="HD == 64",
        minb=2) -> dict:
    """The bf16 dQ kernel's tile shape (``DqShape``)."""
    return {FA: [(_DQ, f"""  static constexpr int MT = {mt};  // m16 row tiles a warp
  static constexpr int WARPS = {warps};
  static constexpr int STAGES = {stages};
  static constexpr bool QREG = {qreg};
  static constexpr int MINB = {minb};""")]}


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
    "attention_bwd": {
        "as committed": {},
        "dK/dV: 32 keys a warp, K and V reloaded, query tile 32":
            _dkdv(mt=2, bq=32, kreg="false", minb=1),
        "dK/dV: query tile 32": _dkdv(bq=32),
        "dK/dV: ring of 3": _dkdv(stages=3),
        "dK/dV: K and V reloaded at hd 64 too": _dkdv(kreg="false"),
        "dK/dV: 8 warps (128 keys a CTA)": _dkdv(warps=8, minb=1),
        "dK/dV: query tile 32, K and V reloaded, 3 CTAs an SM":
            _dkdv(bq=32, kreg="false", minb=3),
        "dQ: 32 rows a warp, Q and dO reloaded":
            _dq(mt=2, qreg="false", minb=1),
        "dQ: ring of 2 at hd 64, 3 at hd 128":
            _dq(stages="HD == 64 ? 2 : 3"),
        "dQ: Q and dO reloaded at hd 64 too": _dq(qreg="false"),
        "dQ: 8 warps (128 rows a CTA)": _dq(warps=8, minb=1),
        # the error then exceeds the gate; only the time means something
        "P and dS rounded once (no lo halves)": {FA: [
            (f"mma_bf16(dva[mt][2 * np{t}], pl[mt], bo[{i}], bo[{i + 1}]);",
             ";") for t, i in (("", 0), (" + 1", 2))] + [
            (f"mma_bf16(dka[mt][2 * np{t}], sl[mt], bq[{i}], bq[{i + 1}]);",
             ";") for t, i in (("", 0), (" + 1", 2))] + [
            (f"mma_bf16(dqa[mt][2 * np{t}], sl[mt], bk[{i}], bk[{i + 1}]);",
             ";") for t, i in (("", 0), (" + 1", 2))]},
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

#: variants of an earlier source (``--parent``): for ``asm``, the source
#: before the ASM tile routine, one warp a (row, channel) pair in the
#: epilogue
PARENT_SETS = {
    "attention_bwd": {"parent as it is": {}},
    "asm": {
        "parent as it is": {},
        "parent, no ASM epilogue": {JK: [(
            "for (int pr = warp; pr < BM * a.cpt; pr += WARPS) {",
            "for (int pr = warp; pr < 0; pr += WARPS) {")]},
    },
}


def build(which: str, name: str, edits: dict, src_dir: str | None = None
          ) -> tuple[str, str]:
    """Compile the edited sources of set ``which`` (the committed ones, or
    those of the same names in ``src_dir``) into one library; returns its
    path and the compiler's ``-Xptxas -v`` report."""
    from repro_torch.kernels import _build

    name = f"{which} {name}"
    out = os.path.join(ROOT, "build", "variants",
                       "".join(c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    paths = []
    for src in _build.SOURCES:
        if src.name not in BUILDS.get(which, (src.name,)):
            continue
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


def attention_bwd_cases(dev):
    """The bf16 backward's inputs at the two shapes (the forward's output
    and lse from the committed library), the fp32 plain backward on fp32
    copies as the reference, the operation count, and SDPA's backward
    through autograd."""
    import torch
    import torch.nn.functional as F

    from repro_torch.introspect import opcount
    from repro_torch.kernels import flash_attention as kfa

    g = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for label, b, s, h, kvh, hd in (("smollm-360m training", 4, 2048, 15, 5,
                                     64),
                                    ("mistral-nemo-12b heads", 1, 4096, 32, 8,
                                     128)):
        q, do = (torch.randn((b, s, h, hd), generator=g, device=dev)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, kvh, hd), generator=g, device=dev)
                .bfloat16() for _ in range(2))
        with torch.no_grad():
            out, lse, lo = kfa.flash_attention_lse(q, k, v)
            f32 = [x.float() for x in (q, k, v, do)]
            o32, l32 = kfa.attention_lse_plain(*f32[:3])
            want = kfa.attention_backward_plain(*f32[:3], o32, f32[3], l32)
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 enable_gqa=True)
        dot = do.transpose(1, 2)

        def library(lib_out=lib_out, leaves=leaves, dot=dot):
            return torch.autograd.grad(lib_out, leaves, dot,
                                       retain_graph=True)

        flops = 14.0 * b * h * hd * opcount.attention_pairs(s, s, True, None)
        cases.append((label, (q, k, v, out, do, lse, lo), want, flops,
                      library))
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


def kernel_split(fn, calls: int = 3) -> dict[str, float]:
    """Device ms a call of each backward kernel (dK/dV, dQ, D), from a
    ``torch.profiler`` trace of ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = next((v for v in (getattr(e, a, 0) for a in (
            "self_device_time_total", "self_cuda_time_total")) if v), 0.0)
        for key, part in (("attn_bwd_dkdv", "dK/dV"), ("attn_bwd_dq", "dQ"),
                          ("attn_bwd_preprocess", "D")):
            if key in e.key:
                out[part] = out.get(part, 0.0) + t / calls / 1e3
    return out


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import jpeg_conv as kjc

    def bwd(q, k, v, out, do, lse, lo):  # as a training step calls it
        return kfa.flash_attention_backward(q, k, v, out, do, lse, out_lo=lo)

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
             "attention_bwd": ("attn_bwd",),
             "conv": ("banded_conv",), "asm": ("banded_conv", "asm_kernel")}
    variants = []
    for which in sets:
        variants += [(which, name, edits, None)
                     for name, edits in SETS[which].items()]
        if parent is not None:
            variants += [(which, name, edits, parent) for name, edits
                         in PARENT_SETS.get(which, {}).items()]
    # one process a variant, so each keeps its own build log
    with ProcessPoolExecutor(max_workers=min(8, len(variants)),
                             mp_context=mp.get_context("fork")) as pool:
        built = list(pool.map(build, *zip(*variants)))
    for (which, name, _, _), (lib, log) in zip(variants, built):
        libs[(which, name)] = lib
        for line in cs.ptxas_report(log):
            if any(k in line for k in shown[which]):
                print(f"{which} / {name}: ptxas {line}", flush=True)
    makers = {"attention": attention_cases, "attention_bwd":
              attention_bwd_cases, "conv": conv_cases, "asm": asm_cases}
    _build.use(next(iter(libs.values())))  # a set's first: as committed
    cases = {k: makers[k](dev) for k in sets}
    with torch.inference_mode():
        tile_rows = kjc.tile_rows
        for rnd in range(2):
            for which in sets:
                if which != "attention_bwd":
                    continue
                row = {"round": rnd, "set": which, "variant": "SDPA backward"}
                for label, *_, library in cases[which]:
                    with torch.inference_mode(False):
                        row[label] = {"ms": cs.cuda_ms(library)}
                print(json.dumps(row), flush=True)
            for (which, name), lib in libs.items():
                _build.use(lib)
                row = {"round": rnd, "set": which, "variant": name}
                if which == "attention_bwd":
                    for label, args, want, flops, _ in cases[which]:
                        got = bwd(*args)
                        ms = cs.cuda_ms(lambda: bwd(*args))
                        row[label] = {
                            "ms": ms, "tflops": flops / ms / 1e9,
                            "err": max(float((a.float() - w).abs().max())
                                       for a, w in zip(got, want)),
                            "kernel_ms": kernel_split(lambda: bwd(*args))}
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
