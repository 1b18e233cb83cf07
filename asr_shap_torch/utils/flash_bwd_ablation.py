"""Where the time of K3 and K4 (the tensor-core flash dq and dk/dv kernels)
and of their full-bias variants K3b and K4f goes: each kernel timed whole
and with one part of it taken out.

Run on a machine with a CUDA card, from the repository root:

    python3 -m asr_shap_torch.utils.flash_bwd_ablation

Each variant is a copy of ``csrc/flash_attention.cu`` with one part removed
by a text substitution (the results are wrong; only the times count), built
with the port's nvcc flags, all builds at once, and launched through its C
entry points: K3 and K4 at the Wav2Vec2-base main-path shape (BH = 12,
T = 149, D = 64, N = 1,788, no mask), K3b and K4f at the conformer's
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
K3 = "flash_dq_mma_kernel(const float*"
K4 = "flash_dkv_mma_kernel(const float*"
ZERO_DP = "for (int a_ = 0; a_ < {jt}; ++a_) for (int b_ = 0; b_ < 4; ++b_) dp[a_][b_] = 0.f;"
PICK_G = "const int G = bwd_groups_per_block(BH * tiles, groups);"
# ptxas's (template, FULL) -> the kernel's name
KERNEL_NAMES = {("flash_dq_mma_kernel", "0"): "K3", ("flash_dq_mma_kernel", "1"): "K3b",
                ("flash_dkv_mma_kernel", "0"): "K4", ("flash_dkv_mma_kernel", "1"): "K4f"}
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


def variant_source(src: str, change) -> str:
    if change is None:
        return src
    anchor, old, new = change
    start = src.index(anchor) if anchor else 0
    at = src.find(old, start)
    if at < 0:
        raise ValueError(f"ablation text not found in the source: {old!r}")
    if anchor is None:
        return src.replace(old, new)
    return src[:at] + new + src[at + len(old):]


def build(workdir: Path) -> dict:
    """Build every variant at once; name -> (library, ptxas report)."""
    src = SOURCE.read_text()
    procs = {}
    for i, (name, change) in enumerate(VARIANTS.items()):
        cu = workdir / f"v{i}.cu"
        cu.write_text(variant_source(src, change))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        report = [(KERNEL_NAMES[kern, full], spill, regs) for kern, full, _, spill, regs in
                  re.findall(r"entry function '\S*?(flash_d\w*?_mma_kernel)ILi64ELb([01])E\S*'"
                             r"[^\n]*\n[^\n]*\n *(\d+) bytes stack frame, (\d+) bytes spill "
                             r"stores[^\n]*\n[^\n]*Used (\d+) registers", log)]
        lib = ctypes.CDLL(str(so))
        # csrc/flash_attention.cu's entry points
        for fn, pointers in ((lib.flash_dq_f32, 9), (lib.flash_dkv_f32, 9),
                             (lib.flash_dq_dbias_f32, 10), (lib.flash_dkv_bias_f32, 9)):
            fn.argtypes = (ctypes.c_void_p,) * pointers + (ctypes.c_int,) * 5 + (
                ctypes.c_float, ctypes.c_void_p)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    t, d, rows = 149, 64, 149
    # (heads of the path, full bias): K3/K4 on the base path, K3b/K4f on the conformer's
    shapes = {False: inputs(gen, 12, t, d, rows, False), True: inputs(gen, 16, t, d, rows, True)}
    with tempfile.TemporaryDirectory(prefix="flash_bwd_ablation_") as tmp:
        libs = build(Path(tmp))
        for name, (_, report) in libs.items():
            print(f"ptxas {name}: " + "; ".join(
                f"{kern} {regs} registers, {spill} bytes spilled" for kern, spill, regs in report))
        for rnd in range(3):
            for name, (lib, _) in libs.items():
                calls = {
                    "K3": (lib.flash_dq_f32, shapes[False]["dq"]),
                    "K4": (lib.flash_dkv_f32, shapes[False]["dkv"]),
                    "K3b": (lib.flash_dq_dbias_f32, shapes[True]["dq"]),
                    "K4f": (lib.flash_dkv_bias_f32, shapes[True]["dkv"]),
                }
                for kern, (fn, args) in calls.items():
                    if fn(*args):
                        raise RuntimeError(f"{name}: {kern} launch failed")
                times = {kern: time_ms(lambda: fn(*args)) for kern, (fn, args) in calls.items()}
                print(f"round {rnd} {name}: " + ", ".join(
                    f"{kern} {ms:.4f} ms" for kern, ms in times.items()) + " per launch")
    return 0


def inputs(gen, h: int, t: int, d: int, rows: int, full: bool) -> dict:
    """The C arguments of the dq and the dk/dv entry point at one path's
    shape: BH = h residual rows (one clip), ``rows`` cotangent rows per
    residual row, no mask or (``full``) a unit-normal [BH, T, T] bias; and
    the tensors they point into, to keep them alive."""
    q, k, v, o = (torch.randn((h, t, d), generator=gen, device="cuda") for _ in range(4))
    lse = torch.randn((h, t), generator=gen, device="cuda")
    g = torch.randn((rows * h, t, d), generator=gen, device="cuda")
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
