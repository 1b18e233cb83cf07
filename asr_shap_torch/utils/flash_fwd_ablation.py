"""Where the time of the bf16 flash forward (K2-bf16 and K2f-bf16, the
kernels of ``csrc/flash_fwd_bf16.cu``) goes: the kernel timed whole, with
one part of it taken out or done another way, at other row and key-split
choices, and as an empty kernel of the same grid.

Run on a machine with a CUDA card, from the repository root:

    python3 -m asr_shap_torch.utils.flash_fwd_ablation

Each variant is a copy of the source changed by text substitutions, built
and loaded by ``flash_bwd_ablation.build_variants`` (all builds at once),
and launched through its C entry points at three shapes (T = 149, D = 64):
K2 at the Wav2Vec2-base main path's BH = 12 with no bias, K2f at the
Wav2Vec2-Conformer's BH = 16 with a [16, 149, 149] full bias, and K2 at the
sweep's batched forward, 8 clips of 12 heads (BH = 96), each at 16 and 32
query rows per block (64 too for the variants that allow it). Times are
device time per launch under torch.profiler (the mean over ITERS launches):
the host launches these kernels more slowly than the card runs them, so
CUDA events around back-to-back launches would time the host. A variant's
time against the whole kernel's bounds what that part costs; two parts
that overlap cost less together than apart; the empty kernel is the
latency floor that sits beside the byte bound. The "numerics" variants
(two p terms and one) are also held to float64 on the same bf16 inputs: o's
largest error beside the plain float32 version's. Prints the card's name
and power limit; each variant's registers, spills, shared bytes and blocks
per SM (ptxas, ``flash_fwd_bf16_info``); then ROUNDS rounds, each variant's
time per shape and block height and its ratio to the whole kernel's at the
same height in that round (the variants in reverse order every other round:
compare within a round). Beside each shape it prints the device time of
PyTorch's scaled_dot_product_attention on the same inputs (the full bias
as a bf16 mask), the yardstick. Before the rounds, a copy of the kernel with
timestamps (``TIMELINE``) gives each shape's timeline: how far apart its
blocks start, how long they run, and the cycles a block takes to each of
its checkpoints (q, K and the bias in; the scores and softmax done; V in;
p.v done; the partials written; o stored).
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
from asr_shap_torch.kernels import flash_attention as fa
from asr_shap_torch.utils.flash_bwd_ablation import build_variants

SOURCE = _build.CSRC / "flash_fwd_bf16.cu"
KERNEL = "flash_fwd_bf16_kernel(const bf16*"
T, D = 149, 64
ITERS = 100
ROUNDS = 3
# (label, BH, heads, full bias)
SHAPES = (("K2 base", 12, 12, False), ("K2f conformer", 16, 16, True), ("K2 sweep", 96, 12, False))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SPLITS_OF_WHOLE = 4  # the source's SPLITS: warps per 16 query rows
ENTRIES = {"flash_fwd_bf16": (_P,) * 6 + (_I,) * 5 + (_F, _P),
           "flash_fwd_bias_bf16": (_P,) * 6 + (_I,) * 5 + (_F, _P),
           "flash_fwd_bf16_info": (_I,) * 4 + (_P,)}
STAGE = "if (brow != nullptr)\n      cp_bias<FULL>"
# the staging of the kernel before its 16-byte units: a 4-byte cp.async per
# entry, neighbouring threads on neighbouring keys, rows unshifted
BIAS4 = r"""template <bool FULL>
__device__ __forceinline__ void cp_bias4(float* dst, const float* src, int row0, int rows, int kv0,
                                         int keys, int ld, int T, int tid, int nthreads) {
  const uint32_t s0 = smem_u32(dst);
  for (int idx = tid; idx < rows * keys; idx += nthreads) {
    const int r = idx / keys, c = idx - r * keys;
    const bool ok = (!FULL || row0 + r < T) && kv0 + c < T;
    const float* p = ok ? src + (FULL ? (long long)(row0 + r) * T : 0LL) + kv0 + c : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     s0 + (uint32_t)(r * ld + c) * 4u), "l"(p), "r"(ok ? 4 : 0));
  }
}

"""
READ = ("            const float* e = bl + (FULL ? 8 * r * ldb : 0) + bm + key;\n"
        "            b = make_float2(e[0], e[1]);")
# name -> change (``flash_bwd_ablation.variant_source``)
VARIANTS = {
    "whole": None,
    "empty kernel (same grid, threads and shared memory)": (
        KERNEL, "  constexpr int LD = D + 8,", "  return;\n  constexpr int LD = D + 8,"),
    "without loads (no cp.async of q, K, V, bias)": [
        (KERNEL, "cp_rows<D>(qs,", "if (0) cp_rows<D>(qs,"),
        (KERNEL, "cp_rows<D>(ks,", "if (0) cp_rows<D>(ks,"),
        (KERNEL, "cp_rows<D>(vs,", "if (0) cp_rows<D>(vs,"),
        (KERNEL, STAGE, "if (0)\n      cp_bias<FULL>")],
    "without the bias staging (stale shared bias)": (KERNEL, STAGE, "if (0)\n      cp_bias<FULL>"),
    "bias staged by 4-byte cp.async, one entry per thread": [
        (None, "template <int D, bool FULL>\n__global__", BIAS4 + "template <int D, bool FULL>\n__global__"),
        (KERNEL, "cp_bias<FULL>(bs, brow, row0, bias_rows, kv0, nt * 16, ldb, T, warp, lane, "
                 "blockDim.x >> 5);",
         "cp_bias4<FULL>(bs, brow, row0, bias_rows, kv0, nt * 16, ldb, T, threadIdx.x, "
         "blockDim.x);"),
        (KERNEL, "const int bm = brow == nullptr ? 0 : phase(brow + brow_off + kv0);",
         "const int bm = 0;")],
    "bias read by each lane from device memory, not staged": [
        (KERNEL, STAGE, "if (0)\n      cp_bias<FULL>"),
        (KERNEL, READ,
         "            const int row_ = row0 + grp * 16 + gi + 8 * r;\n"
         "            const float* e = brow + (FULL ? (long long)row_ * T : 0LL) + kv0 + key;\n"
         "            const bool in_ = !FULL || row_ < T;\n"
         "            b = make_float2(in_ && kv0 + key < T ? e[0] : 0.f,\n"
         "                            in_ && kv0 + key + 1 < T ? e[1] : 0.f);")],
    "V in the keys' commit group (no overlap)": [
        (KERNEL, "    cp_commit();\n    cp_rows<D>(vs,", "    cp_rows<D>(vs,"),
        (KERNEL, "cp_wait<1>();", "cp_wait<0>();")],
    "without products (each mma four adds)": (
        None, '  asm volatile(\n      "mma.sync.aligned.m16n8k16',
        "  c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);\n"
        "  c[2] += __uint_as_float(a[2]); c[3] += __uint_as_float(a[3]);\n"
        '  if (0) asm volatile(\n      "mma.sync.aligned.m16n8k16'),
    "without p.v": (KERNEL, "step_split<D>(acc,", "if (0) step_split<D>(acc,"),
    "without the merge (partials written, not combined)": (
        KERNEL, "for (int u = threadIdx.x; u < groups * 16 * UNITS; u += blockDim.x) {",
        "for (int u = threadIdx.x; u < 0; u += blockDim.x) {"),
    "one p term (hi.v alone; wrong data)": (
        KERNEL, "step_split<D>(acc, ph, pl,", "step_split<D, false>(acc, ph, pl,"),
    "expf as __expf (wrong data)": (None, "expf(", "__expf("),
    **{f"SPLITS = {n}": (None, "constexpr int SPLITS = 4;", f"constexpr int SPLITS = {n};")
       for n in (8, 2)},
    **{f"SPLITS = {n}, up to 64 rows per block": [
        (None, "constexpr int SPLITS = 4;", f"constexpr int SPLITS = {n};"),
        (None, "constexpr int MAX_GROUPS = 2;", "constexpr int MAX_GROUPS = 4;")]
       for n in (8, 4, 2)},
}
NUMERICS = ("whole", "one p term (hi.v alone; wrong data)")
# the whole kernel with timestamps: clock64 of lane 0 of each warp at seven
# checkpoints (slots 0-6) and the global timer (ns) at its start and end
# (slots 7, 8), read back through stamps_copy
STAMPS = r"""__device__ long long g_stamps_[1 << 20];
#define STAMP_AT_(k, value) do { if ((threadIdx.x & 31) == 0) g_stamps_[((blockIdx.y * gridDim.x \
    + blockIdx.x) * 32 + (threadIdx.x >> 5)) * 9 + (k)] = (value); } while (0)
#define STAMP(k) STAMP_AT_(k, clock64())
#define GSTAMP(k) do { long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
    STAMP_AT_(k, t_); } while (0)

"""
TIMELINE = ("whole, with timestamps", [
    (None, "template <int D, bool FULL>\n__global__", STAMPS + "template <int D, bool FULL>\n__global__"),
    (None, 'extern "C" int flash_fwd_bf16_info(',
     'extern "C" int stamps_copy(long long* host, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, g_stamps_, (size_t)n * sizeof(long long));\n}\n\n'
     'extern "C" int flash_fwd_bf16_info('),
    (KERNEL, "  const int bias_rows = FULL ? groups * 16 : 1;\n",
     "  const int bias_rows = FULL ? groups * 16 : 1;\n  GSTAMP(7);\n  STAMP(0);\n"),
    (KERNEL, "    __syncthreads();  // q, keys and bias in; values may still be on their way\n",
     "    __syncthreads();  // q, keys and bias in; values may still be on their way\n"
     "    STAMP(1);\n"),
    (KERNEL, "    cp_wait<0>();\n    __syncthreads();  // values in\n",
     "    STAMP(2);\n    cp_wait<0>();\n    __syncthreads();  // values in\n    STAMP(3);\n"),
    (KERNEL, "  // the row group's warps meet", "  STAMP(4);\n  // the row group's warps meet"),
    (KERNEL, "  __syncthreads();\n  // one thread per 8 columns of a row",
     "  __syncthreads();\n  STAMP(5);\n  // one thread per 8 columns of a row"),
    (KERNEL, "m_all + logf(l_all);\n  }\n", "m_all + logf(l_all);\n  }\n  STAMP(6);\n  GSTAMP(8);\n")])
CHECKPOINTS = ("q, K and bias in", "scores and softmax", "V in", "p.v", "partials written",
               "o stored")


def sass_size(so: Path) -> dict:
    """SASS instructions of each D = 64 kernel in library ``so`` (K2, K2f),
    from ``cuobjdump -sass`` beside nvcc."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"Function : ", sass)[1:]:
        m = re.search(r"flash_fwd_bf16_kernelILi64ELb([01])E", body.split(maxsplit=1)[0])
        if m:
            out["K2f" if m[1] == "1" else "K2"] = len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/", body,
                                                                   re.M))
    return out


def block_rows(name: str):
    return (16, 32, 64) if "64 rows" in name else (16, 32)


def inputs(gen, bh: int, heads: int, full: bool, masked: bool = False) -> dict:
    """The C arguments of the forward at one shape, and its tensors: q, k, v
    unit-normal in bf16; no bias, a [B, T] mask with the last 29 keys at
    -1e9 (``masked``), or (``full``) a unit-normal [BH, T, T] bias with
    the same keys masked if ``masked``."""
    q, k, v = (torch.randn((bh, T, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    bias = None
    if full:
        bias = torch.randn((bh, T, T), generator=gen, device="cuda")
        if masked:
            bias[..., T - 29:] = -1e9
    elif masked:
        bias = torch.zeros((bh // heads, T), device="cuda")
        bias[:, T - 29:] = -1e9
    o = torch.empty_like(q)
    lse = torch.empty((bh, T), device="cuda")
    return {"entry": "flash_fwd_bias_bf16" if full else "flash_fwd_bf16",
            "head": [x if x is None else x.data_ptr() for x in (q, k, v, bias, o, lse)],
            "tail": [bh, T, D, heads], "stream": _build.stream_of(q),
            "tensors": (q, k, v, bias, o, lse), "heads": heads}


def launcher(lib, args: dict, rows: int):
    fn = getattr(lib, args["entry"])
    call_args = args["head"] + args["tail"] + [rows, D ** -0.5, args["stream"]]

    def launch():
        if fn(*call_args):
            raise RuntimeError(f"{args['entry']}: launch failed")
    return launch


def device_us(fn, iters: int = ITERS, tries: int = 3) -> float:
    """Device time per launch of the forward kernel over ``iters`` calls of
    ``fn`` under torch.profiler, after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            if "flash_fwd_bf16_kernel" in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
                total += e.self_device_time_total
                count += e.count
        if count >= iters // 2:  # the profiler may drop some of its window's records
            return total / count
    raise RuntimeError(f"profiler saw under half the launches in {tries} tries")


def timeline(lib, label: str, args: dict, rows: int) -> None:
    """One launch of the timestamped kernel: the spread of its blocks' start
    times, their durations, and the cycles from a block's start (its first
    warp's) to each checkpoint of its slowest warp, the median over blocks."""
    import numpy as np

    bh, heads = args["tail"][0], args["heads"]
    blocks, warps = bh * -(-T // rows), rows // 16 * SPLITS_OF_WHOLE
    launcher(lib, args, rows)()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (blocks * 32 * 9))()
    if lib.stamps_copy(buf, len(buf)):
        raise RuntimeError("stamps_copy failed")
    st = np.frombuffer(buf, dtype=np.int64).reshape(blocks, 32, 9)[:, :warps]
    start = st[:, :, 0].min(axis=1)
    at = [np.median(st[:, :, k].max(axis=1) - start) for k in range(1, 7)]
    g0, g1 = st[:, 0, 7], st[:, 0, 8]
    ghz = np.median((st[:, 0, 6] - st[:, 0, 0]) / np.maximum(g1 - g0, 1))
    print(f"timeline {label} {rows} rows ({blocks} blocks, BH={bh}, H={heads}): blocks start "
          f"over {int(g0.max() - g0.min())} ns, run {int(np.median(g1 - g0))} ns (median; "
          f"longest {int((g1 - g0).max())}), first start to last end {int(g1.max() - g0.min())} "
          f"ns; cycles from a block's start to its slowest warp's " + ", ".join(
              f"{what} {int(c)}" for what, c in zip(CHECKPOINTS, at))
          + f" (median over blocks; {ghz:.2f} cycles per ns)")


def sdpa_us(args: dict, iters: int = ITERS) -> float:
    """Device time per call of PyTorch's scaled_dot_product_attention on
    the same bf16 q, k, v ([B, H, T, D]) under torch.profiler, every device
    kernel of the call summed; the full bias as a bf16 float mask, as
    ``chip_smoke.py``'s yardstick takes it. Timed here, used nowhere in the
    port."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, bias, _, _ = args["tensors"]
    shape = (-1, args["heads"], T, D)
    q4, k4, v4 = (x.reshape(shape) for x in (q, k, v))
    mask = None if bias is None else bias.to(torch.bfloat16).reshape(-1, args["heads"], T, T)
    call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters


def float64_check(name: str, lib, gen) -> None:
    """o of a variant against float64 on the same bf16 inputs, beside the
    plain float32 version's error, at the base shape (no bias and masked)
    and the conformer's (a unit-normal full bias, plain and masked)."""
    for label, bh, heads, full in SHAPES[:2]:
        for masked in (False, True):
            args = inputs(gen, bh, heads, full, masked)
            q, k, v, bias, o, _ = args["tensors"]
            launcher(lib, args, 16)()
            torch.cuda.synchronize()
            want, _ = fa.flash_fwd_plain(q.double(), k.double(), v.double(),
                                         None if bias is None else bias.double(), heads)
            plain, _ = fa.flash_fwd_plain(q, k, v, bias, heads)
            kern = float((o.double() - want).abs().max())
            ref = float((plain.double() - want).abs().max())
            print(f"float64 {name}, {label} masked={masked}: o error {kern:.4e}, plain float32 "
                  f"{ref:.4e} (ratio {kern / ref:.3f}, the card's gate 1.25)")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {label: inputs(gen, bh, heads, full) for label, bh, heads, full in SHAPES}
    with tempfile.TemporaryDirectory(prefix="flash_fwd_ablation_") as tmp:
        libs = build_variants(Path(tmp), SOURCE, dict([*VARIANTS.items(), TIMELINE]), ENTRIES)
        stamped = libs.pop(TIMELINE[0])[0]
        stamped.stamps_copy.argtypes = (_P, _I)
        for name, (lib, log) in libs.items():
            regs = re.findall(r"flash_fwd_bf16_kernelILi64ELb([01])E\S*'[^\n]*\n[^\n]*\n *\d+ "
                              r"bytes stack frame, (\d+) bytes spill stores[^\n]*\n[^\n]*Used "
                              r"(\d+) registers", log)
            occupancy = []
            for full in (0, 1):
                for rows in block_rows(name):
                    info = (ctypes.c_int * 4)()
                    if lib.flash_fwd_bf16_info(full, D, rows, T, ctypes.addressof(info)):
                        raise RuntimeError(f"{name}: info failed")
                    occupancy.append(f"{'K2f' if full else 'K2'} {rows} rows: {info[2]} B shared, "
                                     f"{info[3]} blocks/SM")
            size = sass_size(Path(lib._name))
            print(f"ptxas {name}: " + "; ".join(
                f"{'K2f' if full == '1' else 'K2'} {r} registers, {sp} bytes spilled"
                for full, sp, r in regs) + "; " + "; ".join(occupancy) + "; SASS instructions "
                + ", ".join(f"{k} {n}" for k, n in size.items()))
        for name in NUMERICS:
            float64_check(name, libs[name][0], gen)
        for label, args in shapes.items():
            for rows in (16, 32):
                timeline(stamped, label, args, rows)
            print(f"sdpa {label}: {sdpa_us(args):.3f} us per call (device time of its kernels)")
        names = list(VARIANTS)
        for rnd in range(ROUNDS):
            for label, args in shapes.items():
                times = {name: {rows: device_us(launcher(libs[name][0], args, rows))
                                for rows in block_rows(name)}
                         for name in (names if rnd % 2 == 0 else names[::-1])}
                for name in names:
                    print(f"round {rnd} {label} {name}: " + ", ".join(
                        f"{rows} rows {us:.3f} us" + (
                            f" ({us / times['whole'][rows]:.3f}x)" if rows in times["whole"]
                            else "") for rows, us in times[name].items()) + " per launch",
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
