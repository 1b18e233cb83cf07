"""Where the time of K1-bf16 (the wgmma conv dgrad of
``csrc/conv_dgrad_bf16.cu``) goes: the kernel timed whole and with one part
of it taken out or resized.

Run on a machine with a CUDA card, from the repository root:

    python3 -m asr_shap_torch.utils.conv_dgrad_ablation

Each variant is a copy of the source changed by text substitutions (the
results of a variant that takes a part out are wrong; only the times
count), built with the port's nvcc flags, all builds at once, and launched
through its C entry point ``conv1d_dgrad_bf16`` at the six main-path shapes
of the Wav2Vec2 feature encoder (layers 2-7: 149 cotangent rows, C = 512,
48,000 samples). The parts taken out: the wgmma products (leaving the loads
and the epilogue), the TMA loads (the products then run on whatever the
ring holds), the storer warps' global stores, the whole epilogue (no
staging either; each sum is still read, since ptxas drops products whose
sums are never read) and both (the products alone). The designs beside
the kernel's: two m64n128k16 per k16 where one m64n256k16 serves both
phases, the consumers storing their own tiles, one storer warp, a ring of
2 slots, 64 input channels per tile (an m64n64k16 product) with 3, 4 or 6
slots, no L2 promotion in the tensor maps and the row tile fastest in the
walk. A variant's time against the whole kernel's bounds what that part
costs; two parts that overlap cost less together than apart. Prints the
card's name and power limit, ptxas's register and spill report of each
variant, then each variant's time per launch at each shape and per draw
(the six summed; the mean of ITERS launches between CUDA events) and its
rate against the bf16 peak, for ROUNDS rounds. Within a round every
variant runs each shape back to back, in reverse order every other round:
the card's clock falls as it warms, so compare variants within a round.
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

SOURCE = _build.CSRC / "conv_dgrad_bf16.cu"
PEAK_BF16 = 989e12  # H100 SXM dense bf16, NVIDIA data sheet (700 W)
ROWS, C, N_SAMPLES = 149, 512, 48_000
# (K, stride) of Wav2Vec2's conv layers 1-7; layer 1 (C_in = 1) is not K1's
LAYERS = ((10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2))
ITERS = 10
ROUNDS = 4
# the m64n64k16 product a BN = 64 variant needs (and m64n128k16 for its
# two-phase steps), put in beside the kernel's
WGMMA64 = """
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %34, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\\n"
        "}\\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
"""
BN64 = [("constexpr int BN = 128;", "constexpr int BN = 64;"),
        ("// One BK-wide step:", WGMMA64 + "\n// One BK-wide step:")]
STORE = "*reinterpret_cast<uint4*>(s.xbar"
STAGE = ("          *reinterpret_cast<uint32_t*>(out + ((j ^ (row & 7)) << 4)) =\n"
         "              pack_bf16(sums[4 * j], sums[4 * j + 1]);")
# ptxas drops products whose sums are never read, so a variant without the
# staging still reads each sum (a compare that never stores)
NO_STAGE = "          if (sums[4 * j] == 1.5e-38f) *reinterpret_cast<uint32_t*>(out) = 0;"
WGMMA = "__device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b) {\n    asm volatile("
NO_LOADS = ("load_step(s, t, step, &tm_y, &tm_w, ring + slot * STAGE_BYTES, full0 + 8 * slot);",
            "mbar_arrive(full0 + 8 * slot);")
STORERS_COPY = "store_tile<STORERS>(s, tile_of(s, tile), staging, threadIdx.x - 32);"
NO_EPILOGUE = [(STAGE, NO_STAGE), (STORERS_COPY, "")]
HAND_OFF = "    __syncwarp();\n    if (lane == 0) mbar_arrive(staged);\n"
CONSUMERS_BAR = '    asm volatile("bar.sync 1, 256;\\n" ::: "memory");\n'
# name -> [(text, replacement), ...], each text replaced once; [] is the source
VARIANTS = {
    "whole": [],
    "without the wgmma products (loads and epilogue only)": [
        (f"struct Wgmma<{n}> {{\n  " + WGMMA, f"struct Wgmma<{n}> {{\n  " + WGMMA.replace(
            "asm volatile(", "if (0) asm volatile(")) for n in (128, 256)],
    "each two-phase step as two m64n128k16 (A read twice)": [
        ("        step_products<P * BN>(acc, a, w);",
         "        step_products<BN>(acc, a, w);\n"
         "        step_products<BN>(acc + BN / 2, a, desc_sw128(base + TILE_A + TILE_W));")],
    "without the TMA loads (products on the ring as it stands)": [NO_LOADS],
    "without the storers' global stores": [(STORE, "if (0) " + STORE)],
    "without the epilogue (no staging, no stores)": NO_EPILOGUE,
    "products alone (no loads, no epilogue)": [NO_LOADS] + NO_EPILOGUE,
    "consumers store their own tiles (no storer warps)": [
        (STORERS_COPY, ""),
        (HAND_OFF, CONSUMERS_BAR + "    store_tile<CONSUMERS>(s, t, staging, threadIdx.x - 128);\n"
         + CONSUMERS_BAR + HAND_OFF)],
    "L2 promotion none (256 B in the kernel)": [
        ("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    "row tile fastest (channel tile in the kernel)": [
        ("  t.n0 = tile % s.NT * BN;\n  tile /= s.NT;\n  t.v0 = tile % s.VT * BM;\n  tile /= s.VT;\n",
         "  t.v0 = tile % s.VT * BM;\n  tile /= s.VT;\n  t.n0 = tile % s.NT * BN;\n  tile /= s.NT;\n")],
    "one storer warp (STORERS = 32)": [
        ("constexpr int STORERS = 96;", "constexpr int STORERS = 32;"),
        ("    } else {\n      uint32_t phase = 0;",
         "    } else if (warp == 1) {\n      uint32_t phase = 0;")],
    "STAGES = 2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "BN = 64 (m64n64k16)": BN64,
    "BN = 64, STAGES = 4": BN64 + [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "BN = 64, STAGES = 6": BN64 + [("constexpr int STAGES = 3;", "constexpr int STAGES = 6;")],
}


def variant_source(src: str, changes) -> str:
    for old, new in changes:
        if src.count(old) != 1:
            raise ValueError(f"ablation text not found once in the source: {old!r}")
        src = src.replace(old, new)
    return src


def build(workdir: Path) -> dict:
    """Build every variant at once; name -> (library, ptxas report)."""
    src = SOURCE.read_text()
    procs = {}
    for i, (name, changes) in enumerate(VARIANTS.items()):
        cu = workdir / f"v{i}.cu"
        cu.write_text(variant_source(src, changes))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        found = re.search(r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
        report = (f"{found.group(2)} registers, {found.group(1)} bytes spilled" if found
                  else "no ptxas report")
        fn = ctypes.CDLL(str(so)).conv1d_dgrad_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
        out[name] = (fn, report)
    return out


def main_shapes():
    """(K, s, T_in, T_out) of layers 2-7 at N_SAMPLES."""
    out, t = [], N_SAMPLES
    for i, (k, s) in enumerate(LAYERS):
        t_out = (t - k) // s + 1
        if i > 0:
            out.append((k, s, t, t_out))
        t = t_out
    return out


def time_ms(fn, iters: int = ITERS) -> float:
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
    if not torch.cuda.is_available():
        print("conv_dgrad_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls, flops = [], 0.0
    for k, s, t_in, t_out in main_shapes():
        ybar = torch.randn((ROWS, t_out, C), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, C, C), generator=gen, device="cuda") * (2.0 / (k * C)) ** 0.5
             ).to(torch.bfloat16)
        xbar = torch.empty((ROWS, t_in, C), device="cuda", dtype=torch.bfloat16)
        calls.append((f"K={k} T_out={t_out}", (ybar, w, xbar),
                      [ybar.data_ptr(), w.data_ptr(), xbar.data_ptr(), ROWS, t_out, t_in, C, C,
                       k, s, _build.stream_of(ybar)]))
        flops += 2.0 * ROWS * t_out * k * C * C
    with tempfile.TemporaryDirectory(prefix="conv_dgrad_ablation_") as tmp:
        libs = build(Path(tmp))
        for name, (_, report) in libs.items():
            print(f"ptxas {name}: {report}")
        for rnd in range(ROUNDS):
            # the card's clock drifts as it warms: each shape runs every
            # variant back to back, in reverse order every other round
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            times = {name: [] for name in libs}
            for label, _, args in calls:
                for name in order:
                    fn = libs[name][0]
                    if fn(*args):
                        raise RuntimeError(f"{name}: launch failed at {label}")
                    times[name].append(time_ms(lambda: fn(*args)))
            for name in libs:
                total = sum(times[name])
                rate = (f" ({flops / total / 1e9:.1f} TFLOP/s, "
                        f"{flops / total / PEAK_BF16 * 1e5:.1f}% of the bf16 peak)")
                print(f"round {rnd} {name}: per draw {total:.4f} ms{rate}; " + ", ".join(
                    f"{label} {ms:.4f}" for (label, _, _), ms in zip(calls, times[name])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
