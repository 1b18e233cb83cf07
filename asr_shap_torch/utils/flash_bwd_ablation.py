"""Where the time of K3 and K4 (the tensor-core flash dq and dk/dv kernels)
and of their full-bias variants K3b and K4f goes: each kernel timed whole
and with one part of it taken out.

Run on a machine with a CUDA card, from the repository root:

    python3 -m asr_shap_torch.utils.flash_bwd_ablation          # float32
    python3 -m asr_shap_torch.utils.flash_bwd_ablation --bf16   # bf16

With ``--bf16`` the same is done for the bf16 kernels of
``csrc/flash_bwd_bf16.cu`` on bf16 inputs (``bwd_groups_per_block`` is
``groups_per_block`` there), and each variant that keeps every part
(marked "numerics") is also held to float64 at the conformer's shape: dq
and d(bias) of K3b, each error beside the plain float32 version's, as
``chip_smoke.py``'s float64 check takes them.

Each variant is a copy of ``csrc/flash_attention.cu`` (``flash_common.cuh``
inlined, so that a substitution reaches its helpers too) with one part
removed by a text substitution (the results are wrong; only the times
count), built with the port's nvcc flags, all builds at once, and launched
through its C entry points: K3 and K4 at the Wav2Vec2-base main-path shape
(BH = 12, T = 149, D = 64, N = 1,788, no mask), K3b and K4f at the conformer's
(BH = 16, N = 2,384, a [16, 149, 149] full bias). One template serves
each kernel and its full-bias variant, so a change to its body shows in
both. A variant's time against the whole kernel's bounds what that part
costs; two parts that overlap cost less together than apart. The "G = n"
variants fix the launcher's run of cotangent-row groups per block at n
(``bwd_groups_per_block`` picks 19 for K3/K4 and 5 for K3b/K4f here).
Prints the card's name and power limit, ptxas's register and spill report of
the four kernels for each variant, then the mean of 20 launches per variant
between CUDA events, for three rounds.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from asr_shap_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
SOURCE_BF16 = _build.CSRC / "flash_bwd_bf16.cu"
K3 = "flash_dq_mma_kernel(const float*"
K4 = "flash_dkv_mma_kernel(const float*"
K3_BF16 = "flash_dq_bf16_kernel(const bf16*"
K4_BF16 = "flash_dkv_bf16_kernel(const bf16*"
ZERO_DP = "for (int a_ = 0; a_ < {jt}; ++a_) for (int b_ = 0; b_ < 4; ++b_) dp[a_][b_] = 0.f;"
PICK_G = "const int G = bwd_groups_per_block(BH * tiles, groups);"
PICK_G_BF16 = "const int G = groups_per_block(BH * tiles, groups, slots);"
# ptxas's (template, FULL) -> the kernel's name
KERNEL_NAMES = {("flash_dq_mma_kernel", "0"): "K3", ("flash_dq_mma_kernel", "1"): "K3b",
                ("flash_dkv_mma_kernel", "0"): "K4", ("flash_dkv_mma_kernel", "1"): "K4f",
                ("flash_dq_bf16_kernel", "0"): "K3", ("flash_dq_bf16_kernel", "1"): "K3b",
                ("flash_dkv_bf16_kernel", "0"): "K4", ("flash_dkv_bf16_kernel", "1"): "K4f"}
# the entry points of each kind: (K3, K4, K3b, K4f)
ENTRIES = {False: ("flash_dq_f32", "flash_dkv_f32", "flash_dq_dbias_f32", "flash_dkv_bias_f32"),
           True: ("flash_dq_bf16", "flash_dkv_bf16", "flash_dq_dbias_bf16",
                  "flash_dkv_bias_bf16")}
# name -> (kernel whose body is changed, text, replacement); None: the
# source. Without a kernel, every occurrence of the text is replaced.
VARIANTS = {
    "whole": None,
    "K3/K3b without dq += ds.k": (K3, "step_3xtf32<D, false>(acc, da",
                                  "if (0) step_3xtf32<D, false>(acc, da"),
    "K3/K3b without dP (dP = 0)": (K3, "dp_tiles<D, DQ_JT, false>(dp, ga, vhi + j0 * 8 * LDS, "
                                       "vlo + j0 * 8 * LDS, nt - j0, lane);",
                                   ZERO_DP.format(jt="DQ_JT")),
    "K3/K3b without its tile loop": (K3, "for (int j0 = 0; j0 < nt; j0 += DQ_JT) {",
                                     "for (int j0 = 0; j0 < 0; j0 += DQ_JT) {"),
    "K3b without the d(bias) store": (K3, "if (FULL) {  // d(bias) = ds",
                                      "if (0) {  // d(bias) = ds"),
    "K4/K4f without dk += ds^T.q": (K4, "step_3xtf32<D, false>(acc_k",
                                    "if (0) step_3xtf32<D, false>(acc_k"),
    "K4/K4f without dv += p^T.g": (K4, "step_3xtf32<D, true>(acc_v",
                                   "if (0) step_3xtf32<D, true>(acc_v"),
    "K4/K4f without dP^T (dP^T = 0)": (K4, "dp_tiles<D, DKV_JT, true>(dp, va, gb, nullptr, "
                                           "nt - j0, lane);", ZERO_DP.format(jt="DKV_JT")),
    "K4/K4f without its tile loop": (K4, "for (int j0 = 0; j0 < nt; j0 += DKV_JT) {",
                                     "for (int j0 = 0; j0 < 0; j0 += DKV_JT) {"),
    "K4/K4f without streaming g (first 16 rows reused)": (
        K4, "if (j0 + DKV_JT < nt) {\n          cp_g_dd", "if (0) {\n          cp_g_dd"),
    "all with each mma replaced by four adds": (
        None, '  asm volatile(\n      "mma.sync.aligned.m16n8k8',
        "  c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);\n"
        "  c[2] += __uint_as_float(a[2]); c[3] += __uint_as_float(a[3]);\n"
        '  if (0) asm volatile(\n      "mma.sync.aligned.m16n8k8'),
    **{f"G = {n}": (None, PICK_G, f"const int G = {n} < groups ? {n} : groups;")
       for n in (4, 6, 7, 10)},
}
# the same for csrc/flash_bwd_bf16.cu (launcher's G: 10 for K3/K4, 7 for
# K3b/K4f at two blocks per SM); "numerics" variants are also held to float64
NUMERICS = ("whole", "K3b with its d(bias) sums inside the mma")
VARIANTS_BF16 = {
    "whole": None,
    "K3b with its d(bias) sums inside the mma": (
        None, "constexpr bool DBIAS_PARTIALS = true;", "constexpr bool DBIAS_PARTIALS = false;"),
    "K3/K3b without dq += ds.k": (K3_BF16, "step_split<D>(acc, ah, al,",
                                  "if (0) step_split<D>(acc, ah, al,"),
    "K3/K3b without dP (dP = 0)": (
        K3_BF16, "tile_abt<D, PART>(ds[jj], ga, vs + j * 8 * LD, lane);",
        "for (int b_ = 0; b_ < 4; ++b_) ds[jj][b_] = 0.f;"),
    "K3b without the d(bias) store": (K3_BF16, "if (FULL) {  // d(bias) = ds",
                                      "if (0) {  // d(bias) = ds"),
    "K3b storing d(bias) from its ds registers (scalar stores, not staged)": (
        K3_BF16, "store_dbias(dbias, sw, n, q0, kv0 + j0 * 8, T, lane);",
        "for (int jj = 0; jj < STEP_TILES; ++jj) for (int h = 0; h < 2; ++h) {"
        " const int row = rows_[h], col = kv0 + (j0 + jj) * 8 + 2 * t; if (row < T) {"
        " float* out_ = dbias + (n * T + row) * (long long)T + col;"
        " if (col < T) out_[0] = ds[jj][2 * h]; if (col + 1 < T) out_[1] = ds[jj][2 * h + 1]; } }"),
    "K3b writing d(bias) rows from the staging, one float per lane": (
        K3_BF16, "store_dbias(dbias, sw, n, q0, kv0 + j0 * 8, T, lane);",
        "for (int r_ = 0; r_ < 16 && q0 + r_ < T; ++r_) { const int c_ = kv0 + j0 * 8 + lane;"
        " if (c_ < T) dbias[(n * T + q0 + r_) * (long long)T + c_] ="
        " sw[r_ * LDST + row_phase(n, q0 + r_, T) + lane]; }"),
    "K3b with each d(bias) row's start rounded down to 16 bytes (wrong data)": (
        None, "const int m = row_phase(n, row0 + r0, T);",
        "const int m = 0;"
        " out = reinterpret_cast<float*>(reinterpret_cast<uintptr_t>(out) & ~15ull);"),
    "K4/K4f without dk += ds^T.q": (K4_BF16, "step_split<D>(acc_k,", "if (0) step_split<D>(acc_k,"),
    "K4/K4f without dv += p^T.g": (K4_BF16, "step_split<D>(acc_v,", "if (0) step_split<D>(acc_v,"),
    "K4/K4f without dP^T (dP^T = 0)": (
        K4_BF16, "tile_abt<D, false>(dp[0], va, gb, lane);\n        "
                 "tile_abt<D, false>(dp[1], va, gb + 8 * LD, lane);",
        "for (int a_ = 0; a_ < 2; ++a_) for (int b_ = 0; b_ < 4; ++b_) dp[a_][b_] = 0.f;"),
    "K4/K4f with p^T in one bf16 term (wrong data)": (
        K4_BF16, "split_bf16(p.x, p.y, ph[2 * h + r], pl[2 * h + r]);",
        "ph[2 * h + r] = pl[2 * h + r] = bits(__floats2bfloat162_rn(p.x, p.y));"),
    "K3/K3b with ds in one bf16 term (wrong data)": (
        K3_BF16, "          split_bf16(ds[kk][0], ds[kk][1], ah[0], al[0]);\n"
                 "          split_bf16(ds[kk][2], ds[kk][3], ah[1], al[1]);\n"
                 "          split_bf16(ds[kk + 1][0], ds[kk + 1][1], ah[2], al[2]);\n"
                 "          split_bf16(ds[kk + 1][2], ds[kk + 1][3], ah[3], al[3]);",
        "          ah[0] = al[0] = bits(__floats2bfloat162_rn(ds[kk][0], ds[kk][1]));\n"
        "          ah[1] = al[1] = bits(__floats2bfloat162_rn(ds[kk][2], ds[kk][3]));\n"
        "          ah[2] = al[2] = bits(__floats2bfloat162_rn(ds[kk + 1][0], ds[kk + 1][1]));\n"
        "          ah[3] = al[3] = bits(__floats2bfloat162_rn(ds[kk + 1][2], ds[kk + 1][3]));"),
    "all with each mma replaced by four adds": (
        None, '  asm volatile(\n      "mma.sync.aligned.m16n8k16',
        "  c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);\n"
        "  c[2] += __uint_as_float(a[2]); c[3] += __uint_as_float(a[3]);\n"
        '  if (0) asm volatile(\n      "mma.sync.aligned.m16n8k16'),
    **{f"G = {n}": (None, PICK_G_BF16, f"const int G = {n} < groups ? {n} : groups;")
       for n in (5, 7, 10, 19)},
}


def variant_source(src: str, change) -> str:
    """``src`` with ``change`` made: None (the source as it is), one
    (anchor, text, replacement) or a list of them, each made in turn. With an
    anchor, the first ``text`` after it is replaced; without, every one."""
    for anchor, old, new in [] if change is None else [change] if isinstance(change, tuple) \
            else change:
        start = src.index(anchor) if anchor else 0
        at = src.find(old, start)
        if at < 0:
            raise ValueError(f"ablation text not found in the source: {old!r}")
        src = src.replace(old, new) if anchor is None else src[:at] + new + src[at + len(old):]
    return src


def build_variants(workdir: Path, source: Path, variants: dict, entries: dict) -> dict:
    """Build a copy of ``source`` for each of ``variants`` (name -> change,
    as ``variant_source`` takes it), with the shared header inlined, all
    nvcc processes at once; declare each library's ``entries`` (entry point
    -> argtypes). Returns name -> (library, nvcc's output)."""
    header = (_build.CSRC / "flash_common.cuh").read_text().replace("#pragma once\n", "")
    src = source.read_text().replace('#include "flash_common.cuh"', header)
    procs = {}
    for i, (name, change) in enumerate(variants.items()):
        cu = workdir / f"v{i}.cu"
        cu.write_text(variant_source(src, change))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in entries.items():
            getattr(lib, fn_name).argtypes = argtypes
        out[name] = (lib, log)
    return out


def build(workdir: Path, bf16: bool) -> dict:
    """Build every variant at once; name -> (library, ptxas report)."""
    # the entry points of csrc/flash_attention.cu or flash_bwd_bf16.cu
    entries = {fn_name: (ctypes.c_void_p,) * pointers + (ctypes.c_int,) * 5
               + (ctypes.c_float, ctypes.c_void_p)
               for fn_name, pointers in zip(ENTRIES[bf16], (9, 9, 10, 9))}
    libs = build_variants(workdir, SOURCE_BF16 if bf16 else SOURCE,
                          VARIANTS_BF16 if bf16 else VARIANTS, entries)
    out = {}
    for name, (lib, log) in libs.items():
        report = [(KERNEL_NAMES[kern, full], spill, regs) for kern, full, _, spill, regs in
                  re.findall(r"entry function '\S*?(flash_d\w*?_(?:mma|bf16)_kernel)"
                             r"ILi64ELb([01])E\S*'"
                             r"[^\n]*\n[^\n]*\n *(\d+) bytes stack frame, (\d+) bytes spill "
                             r"stores[^\n]*\n[^\n]*Used (\d+) registers", log)]
        out[name] = (lib, report)
    return out


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    bf16 = "--bf16" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    t, d, rows = 149, 64, 149
    dtype = torch.bfloat16 if bf16 else torch.float32
    # (heads of the path, full bias): K3/K4 on the base path, K3b/K4f on the conformer's
    shapes = {False: inputs(gen, 12, t, d, rows, False, dtype),
              True: inputs(gen, 16, t, d, rows, True, dtype)}
    with tempfile.TemporaryDirectory(prefix="flash_bwd_ablation_") as tmp:
        libs = build(Path(tmp), bf16)
        for name, (_, report) in libs.items():
            print(f"ptxas {name}: " + "; ".join(
                f"{kern} {regs} registers, {spill} bytes spilled" for kern, spill, regs in report))
        if bf16:
            for name in NUMERICS:
                for seed in range(3):
                    for rel_pos in (False, True):
                        float64_check(name, libs[name][0], seed, 16, t, d, rows, rel_pos)
            # the yardstick of K3b's d(bias) store: one fill of the same bytes
            dbias = shapes[True]["tensors"][-1]
            print(f"fill of d(bias) [{', '.join(map(str, dbias.shape))}] float32: "
                  f"{time_ms(lambda: dbias.fill_(1.0)):.4f} ms")
        dq_fn, dkv_fn, dq_bias_fn, dkv_bias_fn = ENTRIES[bf16]
        for rnd in range(3):
            for name, (lib, _) in libs.items():
                calls = {
                    "K3": (getattr(lib, dq_fn), shapes[False]["dq"]),
                    "K4": (getattr(lib, dkv_fn), shapes[False]["dkv"]),
                    "K3b": (getattr(lib, dq_bias_fn), shapes[True]["dq"]),
                    "K4f": (getattr(lib, dkv_bias_fn), shapes[True]["dkv"]),
                }
                for kern, (fn, args) in calls.items():
                    if fn(*args):
                        raise RuntimeError(f"{name}: {kern} launch failed")
                times = {kern: time_ms(lambda: fn(*args)) for kern, (fn, args) in calls.items()}
                print(f"round {rnd} {name}: " + ", ".join(
                    f"{kern} {ms:.4f} ms" for kern, ms in times.items()) + " per launch")
    return 0


def float64_check(name: str, lib, seed: int, h: int, t: int, d: int, rows: int,
                  rel_pos: bool) -> None:
    """K3b of a bf16 variant against float64 on the same bf16 inputs (o
    rounded to bf16; the bias unit-normal or, ``rel_pos``, q times random
    position projections, rel-shifted and scaled, as ``chip_smoke.py``'s):
    dq's and d(bias)'s largest error beside the plain float32 version's (dq
    rounded to bf16)."""
    from asr_shap_torch.kernels import flash_attention as fa
    from asr_shap_torch.ops.attention import rel_shift

    gen = torch.Generator(device="cuda").manual_seed(100 + seed)
    q, k, v = (torch.randn((h, t, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    g = torch.randn((rows * h, t, d), generator=gen, device="cuda").to(torch.bfloat16)
    if rel_pos:
        proj = torch.randn((2 * t - 1, h, d), generator=gen, device="cuda")
        bias = (rel_shift(torch.einsum("bhtd,rhd->bhtr", q[None].float(), proj))[0]
                * d ** -0.5).contiguous()
    else:
        bias = torch.randn((h, t, t), generator=gen, device="cuda")
    q64, k64, v64, g64, b64 = (x.double() for x in (q, k, v, g, bias))
    o64, lse64 = fa.flash_fwd_plain(q64, k64, v64, b64, h)
    o = o64.to(torch.bfloat16)
    lse = lse64.float()
    dq64, _, db64 = fa.flash_dq_plain(q64, k64, v64, o.double(), lse64, g64, b64, h)
    dq_p, _, db_p = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
    dq, dbias = torch.empty_like(g), torch.empty_like(db_p)
    dd = torch.empty((g.shape[0], t), device="cuda")
    rc = lib.flash_dq_dbias_bf16(*[x.data_ptr() for x in (q, k, v, o, lse, g, bias, dq, dd, dbias)],
                                 g.shape[0], h, t, d, h, d ** -0.5, _build.stream_of(q))
    if rc:
        raise RuntimeError(f"{name}: K3b launch failed")
    torch.cuda.synchronize()
    for part, got, plain, want in (("dq", dq, dq_p, dq64), ("d(bias)", dbias, db_p, db64)):
        kern = float((got.double() - want).abs().max())
        ref = float((plain.double() - want).abs().max())
        print(f"float64 {name}, seed {seed}, {'rel-pos' if rel_pos else 'unit-normal'} bias: "
              f"K3b {part} error {kern:.4e}, plain float32 {ref:.4e} (ratio {kern / ref:.3f})")


def inputs(gen, h: int, t: int, d: int, rows: int, full: bool, dtype=torch.float32) -> dict:
    """The C arguments of the dq and the dk/dv entry point at one path's
    shape: BH = h residual rows (one clip), ``rows`` cotangent rows per
    residual row, no mask or (``full``) a unit-normal [BH, T, T] bias; and
    the tensors they point into, to keep them alive. q, k, v, o, g and the
    outputs dq, dk, dv in ``dtype``; lse, dd and the bias float32."""
    q, k, v, o = (torch.randn((h, t, d), generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    lse = torch.randn((h, t), generator=gen, device="cuda")
    g = torch.randn((rows * h, t, d), generator=gen, device="cuda").to(dtype)
    n = g.shape[0]
    dq, dk, dv = (torch.empty_like(g) for _ in range(3))
    dd = torch.zeros((n, t), device="cuda")
    bias = torch.randn((h, t, t), generator=gen, device="cuda") if full else None
    dbias = torch.empty((n, t, t), device="cuda") if full else None
    tail = [n, h, t, d, h, d ** -0.5, _build.stream_of(q)]

    def ptrs(*xs):
        return [None if x is None else x.data_ptr() for x in xs]

    return {"dq": ptrs(q, k, v, o, lse, g, bias, dq, dd) + (ptrs(dbias) if full else []) + tail,
            "dkv": ptrs(q, k, v, lse, g, dd, bias, dk, dv) + tail,
            "tensors": (q, k, v, o, lse, g, dq, dk, dv, dd, bias, dbias)}

if __name__ == "__main__":
    sys.exit(main())
