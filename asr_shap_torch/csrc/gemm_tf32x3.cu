// The input gradient of a linear, gx = g . w^T, in float32 on the H100's
// warpgroup MMA (wgmma) in 3xTF32:
//
//   C[M, N] = A[M, K] . B[N, K]^T
//
// with A = g [M, out] and B = w [in, out], both K-major as stored (K = out,
// N = in), C row-major. A, B and C are float32.
//
// It replaces no Pallas kernel: the reference leaves `dot` to XLA at
// Precision.HIGHEST, and the port's products went to cuBLAS. With TF32 off
// ("highest"), cuBLAS runs them on the CUDA cores (its FFMA kernel), at 73%
// of their 67 TFLOP/s; the input-gradient products are the float32 cells'
// largest device op. Every product at the cells' shapes is bound by its
// operations: with M the draws' cotangent rows (76,288 at 3 s) and N, K of
// 768-4,096, a call does 2MNK operations on 4(MK + NK + MN) bytes, 190
// operations per byte or more, against a ridge of 49 (165 TFLOP/s of
// 3xTF32 over 3.35 TB/s). Its bound is three TF32 products per float32
// product at the card's 495 TFLOP/s TF32 rate.
//
// Numerics, as K1 (conv_dgrad.cu) and the flash kernels: each operand is
// split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (kernels/conv_dgrad.py::tf32_split is this rounding), and the sum takes
// lo.hi + hi.lo, then hi.hi. The tensor cores round their sums toward zero,
// so a sum kept inside the wgmma accumulator over all of K drifts (6-15x
// float32's error against float64 at K = 768-3,072 in an emulation); each
// 32-wide step's twelve products start from a zero partial instead, which a
// float32 add then takes into the running sum (0.3x float32's error in the
// same emulation; chip_smoke.py holds the kernel to at most 2x cuBLAS
// FFMA's error against float64 on the card).
//
// Design:
//   - Tiles of BM = 128 rows by BN = 128 columns; persistent blocks, one per
//     SM, walk them with the column tile fastest, so that the column tiles of
//     one row tile run together and read its A rows from L2 (w, at most
//     16 MB, stays in L2). A tile's epilogue, stored from registers, overlaps
//     the loads of the next tile, which the producer issues meanwhile.
//   - Loads: a ring of STAGES slots, each a raw float32 A tile [128 x 32]
//     and a raw float32 B tile [128 x 32], fetched by one producer thread
//     with TMA and mbarriers, with the 128-byte swizzle (a row is 32 float32
//     values, 128 bytes). TMA's zero fill past M, N and K masks the ragged
//     edges: no shape needs a multiple of the tile, only K and N a multiple
//     of 4 (16-byte rows).
//   - B's split: the producer warpgroup's other three warps (the splitters)
//     round each slot's B tile, once, into hi (in place) and lo (the slot's
//     third tile), at the same swizzled offsets, so the wgmma descriptors
//     read both as the TMA wrote them; both consumer warpgroups read them.
//   - Two consumer warpgroups own 64 rows of a tile each. Each loads its A
//     fragments from the slot (conflict-free under the swizzle), splits them
//     in registers and issues wgmma m64n128k8 .tf32 with A from registers
//     and B from shared memory: per 8-wide step lo.hi, hi.lo, hi.hi, twelve
//     products per slot into the zero-started partial. It then waits for
//     them, frees the slot, and adds the partial to the running sum. While
//     one warpgroup waits and adds, the other's products keep the tensor
//     cores busy.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // rows per tile: two consumer warpgroups of 64
constexpr int BN = 128;        // columns per tile (the wgmma's N)
constexpr int BK = 32;         // reduction per slot: one 128-byte swizzle row of float32
constexpr int STAGES = 4;      // ring slots
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int SPLITTERS = 96;  // warps 1-3 of the producer warpgroup
constexpr int TILE_A = BM * BK * 4;
constexpr int TILE_B = BN * BK * 4;
constexpr int STAGE_BYTES = TILE_A + 2 * TILE_B;  // A, B raw then hi, B lo
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES;  // + the base's alignment
constexpr int ACC = BN / 2;    // accumulator registers per consumer thread
static_assert(TILE_A % 1024 == 0 && TILE_B % 1024 == 0, "swizzle atoms are 1024 bytes");

struct Shape {
  float* C;
  int M, N;
  int NT;      // column tiles
  int tiles;   // row tiles * NT
  int ksteps;  // slots per tile: ceil(K / BK)
};

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

// ---------------------------------------------------------------- split

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero:
// the bits of cvt.rna.tf32.f32, on the integer pipe (conv_dgrad.cu's).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------- wgmma

// Descriptor of a K-major tile of 128-byte rows with the 128-byte swizzle:
// start address >> 4, leading offset 16 bytes (unused with this swizzle),
// 1024 bytes from one 8-row group to the next, swizzle mode 1 (128 bytes).
// The 8-wide step kk of the row starts 32 * kk bytes in: + 2 * kk.
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

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products (which it cannot see).
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = A[64 x 8] . B[128 x 8]^T + (accumulate ? d : 0), TF32
// operands with float32 sums: A from registers (the fragment of
// mma.m16n8k8 per warp of 16 rows: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)), B through its shared-memory descriptor.
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Byte offset of element (row, col) of a [rows x 32] float32 tile written by
// TMA with the 128-byte swizzle: the 16-byte chunk col / 4 of a row moves
// to chunk (col / 4) ^ (row % 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_tf32x3_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b, const Shape s) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], split_bar[STAGES], empty_bar[STAGES];
  // the ring's slots, from a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full0 = smem_addr(full_bar), split0 = smem_addr(split_bar);
  const uint32_t empty0 = smem_addr(empty_bar);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);                 // the producer's expect_tx
      mbar_init(split0 + 8 * i, SPLITTERS / 32);   // one arrival per splitter warp
      mbar_init(empty0 + 8 * i, CONSUMERS / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int slot = 0;
    uint32_t phase = 0;
    if (warp == 0) {
      // Producer: one thread issues every load.
      if (lane != 0) return;
      for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
        const int m0 = tile / s.NT * BM, n0 = tile % s.NT * BN;
        for (int ks = 0; ks < s.ksteps; ++ks) {
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          const uint32_t base = ring + slot * STAGE_BYTES, full = full0 + 8 * slot;
          mbar_expect_tx(full, TILE_A + TILE_B);
          tma_load_2d(base, &tm_a, ks * BK, m0, full);
          tma_load_2d(base + TILE_A, &tm_b, ks * BK, n0, full);
          if (++slot == STAGES) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    } else {
      // Splitters: B raw -> hi in place and lo beside it, 16 bytes at a time.
      const int sid = threadIdx.x - 32;
      for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
        for (int ks = 0; ks < s.ksteps; ++ks) {
          mbar_wait(full0 + 8 * slot, phase);
          uint4* hi = reinterpret_cast<uint4*>(smem + slot * STAGE_BYTES + TILE_A);
          uint4* lo = hi + TILE_B / 16;
          for (int i = sid; i < TILE_B / 16; i += SPLITTERS) {
            const uint4 x = hi[i];
            uint4 h, l;
            split(__uint_as_float(x.x), h.x, l.x);
            split(__uint_as_float(x.y), h.y, l.y);
            split(__uint_as_float(x.z), h.z, l.z);
            split(__uint_as_float(x.w), h.w, l.w);
            hi[i] = h;
            lo[i] = l;
          }
          // the writes are read by the wgmma (the async proxy)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(split0 + 8 * slot);
          if (++slot == STAGES) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups: c owns rows 64c .. 64c + 63 of each tile; this
  // thread's A rows (in the slot) are r and r + 8, its columns t and t + 4
  // of each 8-wide step.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  const int g = lane / 4, t = lane % 4;
  const int r = c * 64 + warp * 16 + g;
  float acc[ACC], part[ACC] = {};  // part: each slot's first product overwrites it
  int slot = 0;
  uint32_t phase = 0;

  for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    const int m0 = tile / s.NT * BM, n0 = tile % s.NT * BN;
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    for (int ks = 0; ks < s.ksteps; ++ks) {
      mbar_wait(full0 + 8 * slot, phase);
      const uint8_t* As = smem + slot * STAGE_BYTES;
      uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int k0 = kk * 8 + t;
        split(*reinterpret_cast<const float*>(As + swz(r, k0)), ahi[kk][0], alo[kk][0]);
        split(*reinterpret_cast<const float*>(As + swz(r + 8, k0)), ahi[kk][1], alo[kk][1]);
        split(*reinterpret_cast<const float*>(As + swz(r, k0 + 4)), ahi[kk][2], alo[kk][2]);
        split(*reinterpret_cast<const float*>(As + swz(r + 8, k0 + 4)), ahi[kk][3],
              alo[kk][3]);
      }
      mbar_wait(split0 + 8 * slot, phase);
      const uint32_t bhi = ring + slot * STAGE_BYTES + TILE_A;
      const uint64_t dhi = desc_sw128(bhi), dlo = desc_sw128(bhi + TILE_B);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        wgmma_tf32(part, alo[kk], dhi + 2 * kk, kk > 0);
        wgmma_tf32(part, ahi[kk], dlo + 2 * kk, 1);
        wgmma_tf32(part, ahi[kk], dhi + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += part[i];
      if (++slot == STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }

    // Epilogue: this thread holds rows r and r + 8 of the tile, columns
    // 8j + 2t and 8j + 2t + 1 (acc[4j + 2h], acc[4j + 2h + 1] for row
    // r + 8h); float2 stores, four lanes to a 32-byte sector.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r + 8 * h;
      if (row >= s.M) continue;
      float* out = s.C + (long long)row * s.N + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j + 2 * t < s.N)
          *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j + 2 * h],
                                                               acc[4 * j + 2 * h + 1]);
      }
    }
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

// A float32 tensor map over a row-major [rows, K] matrix, boxes of `box_rows`
// rows by BK columns, with the 128-byte swizzle and zero fill past its edges.
int encode(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                          strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 100000 + (int)res;
}

// The kernel's shared memory attribute, set once; blocks per SM and SMs.
int prepare(int* per_sm, int* sms) {
  static int cached_per_sm = 0, cached_sms = 0;
  if (cached_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_tf32x3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &cached_per_sm, gemm_tf32x3_wgmma_kernel, THREADS, SMEM_BYTES)) != cudaSuccess)
      return (int)err;
    if (cached_per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  *per_sm = cached_per_sm;
  *sms = cached_sms;
  return 0;
}

}  // namespace

// C[M, N] = A[M, K] . B[N, K]^T in float32 (3xTF32). Returns the CUDA error
// of the launch (0 on success; 100000 + the CUresult when
// cuTensorMapEncodeTiled refuses a tensor map). A, B and C are contiguous
// and 16-byte aligned; N and K are multiples of 4; M, N, K >= 1.
extern "C" int gemm_tf32x3_nt(const float* A, const float* B, float* C, long long M, int N,
                              int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 4 != 0 || K % 4 != 0 || M > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  int per_sm = 0, sms = 0;
  int err = prepare(&per_sm, &sms);
  if (err) return err;
  const long long MT = (M + BM - 1) / BM, NT = (N + BN - 1) / BN;
  if (MT * NT > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  if ((err = encode(&tm_a, A, (int)M, K, BM))) return err;
  if ((err = encode(&tm_b, B, N, K, BN))) return err;
  Shape s;
  s.C = C;
  s.M = (int)M, s.N = N;
  s.NT = (int)NT, s.tiles = (int)(MT * NT), s.ksteps = (K + BK - 1) / BK;
  const long long slots = (long long)per_sm * sms;
  const long long grid = s.tiles < slots ? s.tiles : slots;
  gemm_tf32x3_wgmma_kernel<<<(unsigned)grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tm_a, tm_b, s);
  return (int)cudaGetLastError();
}

// {registers per thread, local (spilled) bytes per thread, shared bytes per
// block (dynamic and static), blocks per SM} of the kernel, in `info`.
extern "C" int gemm_tf32x3_info(int* info) {
  int per_sm = 0, sms = 0;
  int err = prepare(&per_sm, &sms);
  if (err) return err;
  cudaFuncAttributes attr;
  if ((err = (int)cudaFuncGetAttributes(&attr, gemm_tf32x3_wgmma_kernel))) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = SMEM_BYTES + (int)attr.sharedSizeBytes;
  info[3] = per_sm;
  return 0;
}
