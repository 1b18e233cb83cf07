// Helpers of the flash attention kernels shared by flash_attention.cu,
// flash_bwd_bf16.cu and flash_fwd_bf16.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// The bias plane or row of residual row res: a [T, T] plane of the full bias,
// or the [T] key mask of its batch entry; null without a bias.
template <bool FULL>
__device__ __forceinline__ const float* bias_base(const float* bias, int res, int H, int T) {
  if (bias == nullptr) return nullptr;
  return FULL ? bias + (long long)res * T * T : bias + (long long)(res / H) * T;
}

// The sum over the four lanes of a quad (the lanes of one accumulator row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The same for the maximum.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Groups of cotangent rows per block for the flash backwards: the run length
// G (at most 32) that finishes `jobs` (residual row, 16-row tile) pairs of
// `groups` groups each in the fewest group-times with `slots` blocks resident
// at once: ceil(jobs * ceil(groups / G) / slots) waves of G groups each,
// counting half a group-time per wave for a block's loads and scores.
inline int groups_per_block(int jobs, int groups, int slots) {
  int best = 1;
  double best_cost = 1e300;
  for (int G = 1; G <= groups && G <= 32; ++G) {
    const long long blocks = (long long)jobs * ((groups + G - 1) / G);
    const double cost = (double)((blocks + slots - 1) / slots) * (G + 0.5);
    if (cost < best_cost) best = G, best_cost = cost;
  }
  return best;
}

// Raise `kernel`'s dynamic shared-memory limit to `max_smem` bytes and
// prefer shared memory over L1; with `per_sm`, also count the blocks of
// `threads` threads and `smem` bytes an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <typename Kernel>
int prepare_kernel(Kernel kernel, int max_smem, int threads, int smem, int* per_sm) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && per_sm != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  return (int)err;
}

// info = {registers per thread, local (spilled) bytes per thread, `smem`
// (dynamic shared bytes per block), `per_sm` (blocks per SM)} of `kernel`.
template <typename Kernel>
int kernel_info(Kernel kernel, int smem, int per_sm, int* info) {
  cudaFuncAttributes attr;
  const int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = smem;
  info[3] = per_sm;
  return 0;
}

// ------------------------------------------------ bf16 tensor-core helpers
//
// Shared rows of bf16 are stored unwidened with a row stride of D + 8 (16
// bytes of padding, so that the eight rows of an ldmatrix hit eight
// different bank groups).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a.b for one 16x8 tile and a 16-deep step, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two neighbouring float32 values as two bf16 terms each, packed as one
// register of an mma operand (the lower index in the low half): hi = rn(x),
// lo = rn(x - hi). kernels/flash_attention.py::bf16_split is this rounding.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Rows [row0, row0 + rows) of a row-major [T, D] bf16 matrix into shared rows
// of stride D + 8, 16 bytes per copy; rows past T are zero filled. The copies
// are dealt out over `nthreads` threads, this one being `tid`.
template <int D>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int row0, int rows, int T,
                                        int tid, int nthreads) {
  constexpr int CH = D / 8;
  const uint32_t s0 = smem_u32(dst);
  for (int idx = tid; idx < rows * CH; idx += nthreads) {
    const int row = idx / CH, c = idx % CH;
    const bool ok = row0 + row < T;
    const bf16* p = ok ? src + (long long)(row0 + row) * D + c * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     s0 + (uint32_t)(row * (D + 8) + c * 8) * 2u),
                 "l"(p), "r"(ok ? 16 : 0));
  }
}

// The A fragments of 16 shared rows (stride D + 8) over D, k16 step by step.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const bf16* rows, int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8, c = (lane >> 4) * 8;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) ldsm_x4(a[st], smem_u32(rows + r * (D + 8) + st * 16 + c));
}

// s = A.B^T for one 16x8 tile over D: A the warp's 16 rows as the fragments
// `a`, B the 8 shared rows at `b` (stride D + 8). PART: each k16 step from a
// zero partial that a float32 add takes into s.
template <int D, bool PART>
__device__ __forceinline__ void tile_abt(float* s, const uint32_t (*a)[4], const bf16* b,
                                         int lane) {
  const uint32_t addr = smem_u32(b + (lane & 7) * (D + 8) + (lane >> 3) * 8);
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 16; st += 2) {  // two k16 steps per ldmatrix.x4
    uint32_t bb[4];
    ldsm_x4(bb, addr + st * 32u);
    if (PART) {
      float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(p0, a[st], bb[0], bb[1]);
      mma_bf16(p1, a[st + 1], bb[2], bb[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] += p0[c] + p1[c];
    } else {
      mma_bf16(s, a[st], bb[0], bb[1]);
      mma_bf16(s, a[st + 1], bb[2], bb[3]);
    }
  }
}

// acc[nd] += A.B for one k16 step, as lo.B + hi.B: A the float32 16x16 tile
// split into the fragments ah, al; B the 16 shared rows at `b` (stride
// D + 8, k along the rows, read with ldmatrix.trans), all D columns. LO
// false: hi.B alone (A in one bf16 term; al unread).
template <int D, bool LO = true>
__device__ __forceinline__ void step_split(float (*acc)[4], const uint32_t* ah, const uint32_t* al,
                                           const bf16* b, int lane) {
  const uint32_t addr =
      smem_u32(b + ((lane & 7) + ((lane >> 3) & 1) * 8) * (D + 8) + (lane >> 4) * 8);
#pragma unroll
  for (int nd = 0; nd < D / 8; nd += 2) {  // two n8 tiles per ldmatrix.x4
    uint32_t bb[4];
    ldsm_x4_t(bb, addr + nd * 16u);
    if (LO) {
      mma_bf16(acc[nd], al, bb[0], bb[1]);
      mma_bf16(acc[nd + 1], al, bb[2], bb[3]);
    }
    mma_bf16(acc[nd], ah, bb[0], bb[1]);
    mma_bf16(acc[nd + 1], ah, bb[2], bb[3]);
  }
}

}  // namespace
