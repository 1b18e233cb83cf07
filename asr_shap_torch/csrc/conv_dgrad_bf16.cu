// K1 in bf16: the input gradient (dgrad) of a valid stride-S conv1d,
// channels-last, for bf16 ybar and w, on the H100's warpgroup MMA (wgmma).
//
// Replaces, for bf16 inputs, the Pallas TPU kernel
// asr_shap/kernels/conv_dgrad.py (_dgrad_kernel, launched by _dgrad_call).
// With t = v*S + r and k = d*S + r:
//
//   xbar[b, v*S + r, ci] = sum_{d : d*S + r < K, 0 <= v - d < T_out}
//                          sum_co ybar[b, v - d, co] * w[d*S + r, ci, co]
//
// ybar [B, T_out, C_out], w [K, C_in, C_out] and xbar [B, T_in, C_in] are
// bf16; the sums are float32 and xbar is rounded to bf16 once, as the TPU
// kernel's float32 accumulator cast to ybar's dtype. Every row t < T_in is
// written (rows no tap reaches are zero). The float32 kernel of the same
// function is in conv_dgrad.cu.
//
// Bound on the H100: tensor-core operations. A call does
// 2*B*T_out*K*C_in*C_out operations on (B*T_out*C_out + K*C_in*C_out +
// B*T_in*C_in)*2 bytes, about 500 operations per byte on the Wav2Vec2
// feature encoder (C = 512): its bound is the operations at the dense bf16
// peak, 989 TFLOP/s (2.20 ms per draw of 149 cotangent rows).
//
// Design (the Pallas cell's, on Hopper's tensor cores):
//   - A tile is 128 rows v of one clip b, 128 input channels and every
//     phase r of a group of P = 2 (all phases at S = 2; S > 2 runs
//     ceil(S / 2) groups). Each phase has its own float32 accumulator, and
//     the shifted ybar rows v - d are shared by the phases: at K = 3, S = 2,
//     acc0 += A0.W0 + A1.W2 and acc1 += A0.W1, with A_d the rows v - d.
//   - The products are wgmma.mma_async bf16 with float32 accumulators, both
//     operands K-major in shared memory (A = the ybar rows, B = w[k] as
//     [C_in, C_out]), read through descriptors with the 128-byte swizzle:
//     tiles of 64 bf16 (128 bytes) per row, each on a 1024-byte boundary.
//     A step that meets both phases is one m64n256k16 per k16 over the two
//     w tiles side by side (B = 256 rows), so A is read once for both; a
//     step of one phase is m64n128k16. Two consumer warpgroups own 64 rows
//     each, with P x 64 accumulator registers per thread (setmaxnreg gives
//     them 224).
//   - Loads: a ring of STAGES slots, each an A tile (the rows v - d, 64
//     output channels) and the P tiles of w[d*S + r] it meets, filled by one
//     producer thread with TMA (cp.async.bulk.tensor) and mbarriers. The
//     reduction runs over (d, C_out / 64) steps. The tensor map over ybar
//     [B, T_out, C_out] is 3-D, so a row v - d outside [0, T_out) arrives as
//     TMA's zero fill (the reference's `where`): tiles never span clips. A
//     slot is refilled only after the wgmma group that read it has retired
//     (wgmma.wait_group 1, then the consumers' arrival on its empty barrier).
//   - Persistent blocks, one per SM, walk the tiles with the channel tile
//     fastest, so the four channel tiles of a row tile run together and read
//     its ybar rows from L2; w (1.5 MB at K = 3) stays in L2.
//   - Epilogue: the consumers round the accumulators to bf16 into a staging
//     tile in shared memory (16-byte chunks XOR-swizzled by row,
//     conflict-free) and go on to the next tile's products; the producer
//     warpgroup's other three warps (the storers) copy the staged tile to
//     xbar in 16-byte stores, 256 contiguous bytes per row (the output rows
//     t = v*S + r of a tile are one contiguous range of xbar per phase
//     group), and free the staging for the next tile (two mbarriers). The
//     consumers' products overlap the stores: consumers that store their
//     own tiles are slower (utils/conv_dgrad_ablation.py).
//   - Numerics: the sums stay inside the wgmma accumulator. The tensor cores
//     round their sums toward zero, about 2^-17 of a sum over a layer's
//     reduction, far under the 2^-9 of the final rounding to bf16
//     (chip_smoke.py holds the kernel to one bf16 ulp of the plain version
//     and to at most 1.25x its error against float64).
// utils/conv_dgrad_ablation.py times copies of this source with one part
// taken out (PERF.md quotes it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // rows v of one clip per tile: two consumer warpgroups of 64
constexpr int BN = 128;        // input channels per tile (the wgmma's N)
constexpr int BK = 64;         // reduction step over C_out: one 128-byte swizzle row of bf16
constexpr int P = 2;           // phases r per tile, one accumulator each
constexpr int STAGES = 3;      // ring slots
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int STORERS = 96;    // warps 1-3 of the producer warpgroup
constexpr int TILE_A = BM * BK * 2;
constexpr int TILE_W = BN * BK * 2;
constexpr int STAGE_BYTES = TILE_A + P * TILE_W;
constexpr int ROW_BYTES = BN * 2;  // one staged output row
constexpr int STAGING_BYTES = P * BM * ROW_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + STAGING_BYTES;  // + the base's alignment
static_assert(TILE_A % 1024 == 0 && TILE_W % 1024 == 0, "swizzle atoms are 1024 bytes");

struct Shape {
  __nv_bfloat16* xbar;
  int B, T_out, T_in, C_out, C_in, K, S;
  int VT, NT;   // row tiles per clip, channel tiles
  int tiles;    // groups * B * VT * NT
};

struct Tile {
  int b, v0, n0, r0, nsteps;
};

__device__ __forceinline__ Tile tile_of(const Shape& s, int tile) {
  Tile t;
  t.n0 = tile % s.NT * BN;
  tile /= s.NT;
  t.v0 = tile % s.VT * BM;
  tile /= s.VT;
  t.b = tile % s.B;
  t.r0 = tile / s.B * P;
  const int taps = t.r0 < s.K ? (s.K - 1 - t.r0) / s.S + 1 : 0;  // shifts d of phase r0
  t.nsteps = taps * (s.C_out / BK);
  return t;
}

// Does step d of the tile meet phase r0 + 1 too (a tap d*S + r0 + 1 < K)?
__device__ __forceinline__ bool second_phase(const Shape& s, const Tile& t, int d) {
  return t.r0 + 1 < s.S && d * s.S + t.r0 + 1 < s.K;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// ---------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Descriptor of a K-major tile of 128-byte rows with the 128-byte swizzle:
// start address >> 4, leading offset 16 bytes (unused with this swizzle),
// 1024 bytes from one 8-row group to the next, swizzle mode 1 (128 bytes).
// The k16 step kk of the row starts 32 * kk bytes in: + 2 * kk.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products (which it cannot see).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] . B[N x 16]^T, bf16 in, float32 sums, both from
// shared memory: m64nNk16 with N = BN (one phase) or 2 * BN (two phases: the
// w tiles of phases r0 and r0 + 1 lie one after the other in a ring slot, so
// one product over both reads A once; its first BN columns are phase r0's).
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// One BK-wide step: four k16 products of N columns into acc.
template <int N>
__device__ __forceinline__ void step_products(float* acc, uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) Wgmma<N>::mma(acc, a + 2 * kk, b + 2 * kk);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The producer's load of one step into ring slot `slot`: the A tile (rows
// v0 - d .. v0 - d + BM of clip b, channels co0 .. co0 + BK; rows outside
// the clip arrive as zeros) and the w tile of each phase the step meets.
__device__ __forceinline__ void load_step(const Shape& s, const Tile& t, int step,
                                          const CUtensorMap* tm_y, const CUtensorMap* tm_w,
                                          uint32_t slot, uint32_t full) {
  const int csteps = s.C_out / BK;
  const int d = step / csteps;
  const int co0 = step % csteps * BK;
  const int k = d * s.S + t.r0;
  const bool two = second_phase(s, t, d);
  mbar_expect_tx(full, TILE_A + (two ? 2 : 1) * TILE_W);
  tma_load_3d(slot, tm_y, co0, t.v0 - d, t.b, full);
  tma_load_2d(slot + TILE_A, tm_w, co0, k * s.C_in + t.n0, full);
  if (two) tma_load_2d(slot + TILE_A + TILE_W, tm_w, co0, (k + 1) * s.C_in + t.n0, full);
}

// The copy of one staged tile to xbar by N threads (the storers; thread
// index stid): 16-byte units, UNROLL loads in flight per thread; rows
// t >= T_in (and phases r >= S) are not stored.
template <int N>
__device__ __forceinline__ void store_tile(const Shape& s, const Tile& t, const uint8_t* staging,
                                           int stid) {
  constexpr int CHUNKS = ROW_BYTES / 16, UNITS = P * BM * CHUNKS, UNROLL = 4;
  for (int u0 = stid; u0 < UNITS; u0 += UNROLL * N) {
    uint4 val[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = u0 + k * N, row = u / CHUNKS, ch = u % CHUNKS;
      if (u < UNITS)
        val[k] = *reinterpret_cast<const uint4*>(staging + row * ROW_BYTES +
                                                 ((ch ^ (row & 7)) << 4));
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = u0 + k * N, row = u / CHUNKS, ch = u % CHUNKS;
      const int r = t.r0 + row / BM;
      const int tt = (t.v0 + row % BM) * s.S + r;
      if (u < UNITS && r < s.S && tt < s.T_in)
        *reinterpret_cast<uint4*>(s.xbar + ((long long)t.b * s.T_in + tt) * s.C_in + t.n0 +
                                  ch * 8) = val[k];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
dgrad_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_y,
                        const __grid_constant__ CUtensorMap tm_w, const Shape s) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES], staged_bar, free_bar;
  // the ring's slots and the staging tile, from a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  uint8_t* staging = smem + STAGES * STAGE_BYTES;
  const uint32_t full0 = smem_addr(full_bar), empty0 = smem_addr(empty_bar);
  const uint32_t staged = smem_addr(&staged_bar), freed = smem_addr(&free_bar);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);                 // the producer's expect_tx
      mbar_init(empty0 + 8 * i, CONSUMERS / 32);   // one arrival per consumer warp
    }
    mbar_init(staged, CONSUMERS / 32);  // the consumers have staged a tile
    mbar_init(freed, STORERS / 32);     // the storers have copied it out
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (wg == 0) {
    // Producer warpgroup: one thread of warp 0 issues every load; warps 1-3
    // (the storers) copy each staged tile to xbar while the consumers run
    // the next tile's products.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == 0) {
      if (lane != 0) return;
      int slot = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
        const Tile t = tile_of(s, tile);
        for (int step = 0; step < t.nsteps; ++step) {
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          load_step(s, t, step, &tm_y, &tm_w, ring + slot * STAGE_BYTES, full0 + 8 * slot);
          if (++slot == STAGES) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    } else {
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x, phase ^= 1) {
        mbar_wait(staged, phase);
        store_tile<STORERS>(s, tile_of(s, tile), staging, threadIdx.x - 32);
        __syncwarp();
        if (lane == 0) mbar_arrive(freed);
      }
    }
    return;
  }

  // Consumer warpgroups: c owns rows 64c .. 64c + 63 of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int c = wg - 1;
  const int csteps = s.C_out / BK;
  float acc[P * BN / 2];  // phase p's sums are acc[p * BN / 2 ...]
  int slot = 0;
  uint32_t phase = 0, staging_phase = 0;

  for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x, staging_phase ^= 1) {
    const Tile t = tile_of(s, tile);
#pragma unroll
    for (int i = 0; i < P * BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);

    int held = -1;  // the slot whose products may still be in flight
    for (int step = 0; step < t.nsteps; ++step) {
      mbar_wait(full0 + 8 * slot, phase);
      const uint32_t base = ring + slot * STAGE_BYTES;
      const uint64_t a = desc_sw128(base + c * (BM / 2) * BK * 2);
      const uint64_t w = desc_sw128(base + TILE_A);
      // each branch a whole group: fence, products, commit (a group that
      // closes after the branches makes ptxas add dummy products)
      if (second_phase(s, t, step / csteps)) {
        wgmma_fence();
        step_products<P * BN>(acc, a, w);
        wgmma_commit();
      } else {
        wgmma_fence();
        step_products<BN>(acc, a, w);
        wgmma_commit();
      }
      // the previous step's products have retired: its slot may be refilled
      wgmma_wait<1>();
      if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);
      held = slot;
      if (++slot == STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);

    // Epilogue: once the storers have copied the previous tile out, stage
    // this one, rows p * BM + i (phase-major), each row's 16-byte chunks
    // XOR-swizzled by row & 7 (conflict-free), and hand it to the storers.
    mbar_wait(freed, staging_phase ^ 1);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = p * BM + c * 64 + warp * 16 + lane / 4 + 8 * h;
        uint8_t* out = staging + row * ROW_BYTES + (lane % 4) * 4;
        const float* sums = acc + p * BN / 2 + 2 * h;  // row's columns 8j + 2 (lane % 4)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          *reinterpret_cast<uint32_t*>(out + ((j ^ (row & 7)) << 4)) =
              pack_bf16(sums[4 * j], sums[4 * j + 1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(staged);
  }
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle and zero fill; dims innermost
// first, strides in bytes (one fewer than dims).
int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                          dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 100000 + (int)res;
}

// The kernel's shared memory attribute, set once; blocks per SM and SMs.
int prepare(int* per_sm, int* sms) {
  static int cached_per_sm = 0, cached_sms = 0;
  if (cached_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        dgrad_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &cached_per_sm, dgrad_bf16_wgmma_kernel, THREADS, SMEM_BYTES)) != cudaSuccess)
      return (int)err;
    if (cached_per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  *per_sm = cached_per_sm;
  *sms = cached_sms;
  return 0;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success; 100000 + the CUresult
// when cuTensorMapEncodeTiled refuses a tensor map). ybar, w and xbar are bf16 and
// 16-byte aligned; C_in a multiple of 128, C_out of 64; T_out >= 1.
extern "C" int conv1d_dgrad_bf16(const void* ybar, const void* w, void* xbar, int B,
                                 int T_out, int T_in, int C_out, int C_in, int K, int S,
                                 void* stream) {
  if (C_in % BN != 0 || C_out % BK != 0 || S < 1 || K < 1 || B < 1 || T_out < 1 || T_in < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int per_sm = 0, sms = 0;
  int err = prepare(&per_sm, &sms);
  if (err) return err;
  const long long V = (T_in + S - 1) / S;
  const long long VT = (V + BM - 1) / BM;
  const long long tiles = (S + P - 1) / P * (long long)B * VT * (C_in / BN);
  if (tiles > 0x7fffffffLL || (long long)K * C_in > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tm_y, tm_w;
  const cuuint64_t y_dims[3] = {(cuuint64_t)C_out, (cuuint64_t)T_out, (cuuint64_t)B};
  const cuuint64_t y_strides[2] = {(cuuint64_t)C_out * 2, (cuuint64_t)T_out * C_out * 2};
  const cuuint32_t y_box[3] = {BK, BM, 1};
  if ((err = encode(&tm_y, ybar, 3, y_dims, y_strides, y_box))) return err;
  const cuuint64_t w_dims[2] = {(cuuint64_t)C_out, (cuuint64_t)K * C_in};
  const cuuint64_t w_strides[1] = {(cuuint64_t)C_out * 2};
  const cuuint32_t w_box[2] = {BK, BN};
  if ((err = encode(&tm_w, w, 2, w_dims, w_strides, w_box))) return err;
  Shape s;
  s.xbar = static_cast<__nv_bfloat16*>(xbar);
  s.B = B, s.T_out = T_out, s.T_in = T_in, s.C_out = C_out, s.C_in = C_in, s.K = K, s.S = S;
  s.VT = (int)VT, s.NT = C_in / BN, s.tiles = (int)tiles;
  const long long grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  dgrad_bf16_wgmma_kernel<<<(unsigned)grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tm_y, tm_w, s);
  return (int)cudaGetLastError();
}

// {registers per thread, local (spilled) bytes per thread, shared bytes per
// block (dynamic and static), blocks per SM} of the kernel, in `info`.
extern "C" int conv_dgrad_bf16_info(int* info) {
  int per_sm = 0, sms = 0;
  int err = prepare(&per_sm, &sms);
  if (err) return err;
  cudaFuncAttributes attr;
  if ((err = (int)cudaFuncGetAttributes(&attr, dgrad_bf16_wgmma_kernel))) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = SMEM_BYTES + (int)attr.sharedSizeBytes;
  info[3] = per_sm;
  return 0;
}
