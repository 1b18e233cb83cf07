// K2, K2f in bf16: the flash attention forward for bf16 q, k, v, built for
// the H100's bf16 tensor cores.
//
// Replace, for bf16 inputs, the Pallas TPU kernel of
// asr_shap/kernels/flash_attention.py:
//   K2  flash_fwd_bf16_kernel<D, false> <- _fwd_kernel (launched by _fwd), a
//                                          key mask or no bias
//   K2f flash_fwd_bf16_kernel<D, true>  <- the same call with a [bq, T]
//                                          full-bias block
// The float32 kernels of the same function are in flash_attention.cu; the C
// entry points' signatures are theirs.
//
// Layouts: q, k, v, o [BH, T, D] bf16 (D = 32 or 64); lse [BH, T] float32.
// The bias is null, a [B, T] float32 key mask (B = BH / H) or a full
// [BH, T, T] float32 score bias. Scores are scale * (q . k) + bias in
// float32, scale = D^-1/2 applied to the float32 scores, never to q; the
// softmax is float32 (p = exp(s - m), l = sum p); o = (p . v) / l is rounded
// to bf16 once and lse = m + log l is stored in float32, as in the TPU
// kernel, which upcasts its blocks and casts the result to the input's dtype
// once. Keys past T and bias entries of -1e9 get probability exactly 0.
//
// Bound on the H100: latency. A launch is a few MFLOP (at the bf16
// tensor-core rate well under a microsecond) on at most 2.7 MB (the
// conformer's K2f, 1.4 MB of it its [16, 149, 149] bias; the base path's
// K2 moves 0.9 MB), so its time is the chain of dependent phases in a
// block: the loads and the barrier after them, the scores and softmax,
// p.v, the merge. On an H100
// (utils/flash_fwd_ablation.py) an empty kernel of the same grid takes a
// fifth of K2's time; taking out the loads saves under 10%, the merge about
// 15%, the second p term 2-4%, and replacing the products by plain adds
// saves nothing: no one part, neither the bytes nor the tensor cores, sets
// the time. The design:
//   - A block takes one residual row (batch x head) and 16 or 32 query rows
//     (the caller's `rows`); each 16 rows belong to SPLITS = 4 warps, and
//     each of those warps takes every fourth 16-key tile of the keys, so a
//     warp's chain (q.k^T over its keys, the exponentials, p.v) is a
//     quarter of the row's (8 warps were as fast at the base path's 12
//     heads and slower elsewhere, at 1.5x on the sweep's 96; 2 were slower
//     on the main paths). The warps of a row group meet at the end: with
//     each warp's row max m_w, sum l_w and unnormalised O_w,
//     o = sum_w e^(m_w - M) O_w / L and lse = M + log L, M = max_w m_w,
//     L = sum_w e^(m_w - M) l_w.
//   - K, V and the block's q rows stay bf16 in shared memory (row stride
//     D + 8, conflict-free for ldmatrix), up to CHUNK keys at a time,
//     loaded with 16-byte cp.async, rows past T zero filled (V's must be
//     zeros, not stale data: 0 x NaN is NaN). q, K and the bias are one
//     commit group and V another, so V arrives while q.k^T and the softmax
//     run. A row longer than CHUNK keys (not on the main paths, where
//     T = 149 is one chunk) is walked chunk by chunk with the online rescale.
//   - The bias of the block's rows and the chunk's keys (one row for a key
//     mask) is staged in shared memory in the first commit group, one warp
//     per row and a 16-byte cp.async per lane. T is odd on the main paths,
//     so a full-bias row starts at every 4-byte alignment, and neither a
//     16-byte copy of the row as it lies nor a tensor map takes it: each
//     shared row is shifted by its first entry's offset from a 16-byte
//     boundary (its phase), so that its 16-byte units are those of device
//     memory (as K3b's d(bias) stores in flash_bwd_bf16.cu); bytes past the
//     row's last key below T are not read.
//   - q.k^T is one bf16 mma.sync.m16n8k16 per k16 step (sums inside the
//     mma). p.v takes p from the score registers: two neighbouring n8
//     accumulator tiles have the layout of one k16 A fragment, split into
//     two bf16 terms, hi = rn(p) and lo = rn(p - hi), as lo.v + hi.v.
//     One term rounds p to 8 bits: o's error against float64 then reached
//     1.30x the plain version's in tests/test_torch_kernels.py, over the
//     card's 1.25x gate (1.16x on the card, in the ablation).
//   - The merge area aliases the key rows once every warp is done with them;
//     o leaves as 16-byte units of 8 bf16, one per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int CHUNK = 160;      // keys in shared memory at a time
constexpr int SPLITS = 4;       // warps per 16 query rows
constexpr int MAX_GROUPS = 2;   // 16-row groups per block
constexpr int MAX_THREADS = 32 * SPLITS * MAX_GROUPS;
constexpr int TILES_PER_WARP = (CHUNK / 16 + SPLITS - 1) / SPLITS;  // 16-key tiles, per chunk
static_assert(CHUNK % 32 == 0, "chunk of whole 32-key units");

// Float stride of a staged bias row of `keys` keys (a multiple of 16) and
// up to 3 floats of phase: 8 more than a multiple of 32, so that the reads
// of the 8 rows of a fragment spread over the banks.
__host__ __device__ constexpr int bias_stride(int keys) { return ((keys + 31) & ~31) + 8; }

// Dynamic shared memory of a launch: K, V (`keys` rows each) and the block's
// q rows in bf16, the staged bias (`bias_rows` rows, 0 without a bias); the
// merge area (each warp's O [16][D + 8], row max and row sum) aliases them.
template <int D>
__host__ __device__ constexpr int fwd_smem_bytes(int groups, int keys, int bias_rows) {
  const int loads = (2 * keys + 16 * groups) * (D + 8) * 2 + bias_rows * bias_stride(keys) * 4;
  const int merge = SPLITS * groups * (16 * (D + 8) + 32) * 4;
  return loads > merge ? loads : merge;
}

// Keys per chunk of a row of T keys: whole 16-key tiles, at most CHUNK.
__host__ __device__ constexpr int chunk_keys(int T) {
  return ((T + 15) & ~15) < CHUNK ? ((T + 15) & ~15) : CHUNK;
}

// The offset, in floats, of `p` from a 16-byte boundary (the phase of a
// bias row that starts at p; rows 4 apart share it).
__device__ __forceinline__ int phase(const float* p) { return (int)((uintptr_t)p >> 2) & 3; }

// Bias entries of rows [row0, row0 + rows) (FULL: rows of a [T, T] plane;
// else the one row of a key mask) and keys [kv0, kv0 + keys) into shared
// rows of stride `ld`: row r holds key c at c + phase(its key kv0), as the
// 16-byte units of device memory that hold its keys below T, one warp per
// row and one unit per lane (a unit's bytes past the row's last key below
// T are zero filled, not read). Entries of rows and keys past T are left
// as they are.
template <bool FULL>
__device__ __forceinline__ void cp_bias(float* dst, const float* src, int row0, int rows, int kv0,
                                        int keys, int ld, int T, int warp, int lane, int warps) {
  for (int r = warp; r < rows && (!FULL || row0 + r < T); r += warps) {
    const float* first = src + (FULL ? (long long)(row0 + r) * T : 0LL) + kv0;
    const int m = phase(first), end = m + min(keys, T - kv0);  // floats of the row's units
    const float* unit0 = first - m;
    const uint32_t s0 = smem_u32(dst + r * ld);
    for (int u = lane; 4 * u < end; u += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s0 + 16u * u),
                   "l"(unit0 + 4 * u), "r"(4 * min(4, end - 4 * u)));
  }
}

template <int D, bool FULL>
__global__ void __launch_bounds__(MAX_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ o, float* __restrict__ lse, int T, int H, float scale) {
  constexpr int LD = D + 8, KS = D / 16, ND = D / 8, LDO = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / (32 * SPLITS);
  const int keys = chunk_keys(T), ldb = bias_stride(keys);
  bf16* ks = reinterpret_cast<bf16*>(smem);                  // [keys][LD]
  bf16* vs = ks + keys * LD;                                 // [keys][LD]
  bf16* qs = vs + keys * LD;                                 // [groups * 16][LD]
  float* bs = reinterpret_cast<float*>(qs + groups * 16 * LD);  // [bias rows][ldb]

  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / SPLITS, split = warp % SPLITS;
  const int row0 = blockIdx.y * groups * 16;  // the block's first query row
  const int gi = lane >> 2, t = lane & 3;
  const long long base = (long long)n * T * D;
  const float* brow = bias_base<FULL>(bias, n, H, T);
  const int bias_rows = FULL ? groups * 16 : 1;

  // the block's q rows arrive with the first chunk's keys
  cp_rows<D>(qs, q + base, row0, groups * 16, T, threadIdx.x, blockDim.x);
  uint32_t qa[KS][4];  // A fragments of the group's q rows

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[ND][4];  // unnormalised O: rows g, g + 8 x columns nd * 8 + 2t, + 1
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  for (int kv0 = 0; kv0 < T; kv0 += CHUNK) {
    const int nt = min(CHUNK, (T - kv0 + 15) & ~15) / 16;  // 16-key tiles of the chunk
    if (kv0 > 0) __syncthreads();  // every warp is done with the last chunk
    cp_rows<D>(ks, k + base, kv0, nt * 16, T, threadIdx.x, blockDim.x);
    if (brow != nullptr)
      cp_bias<FULL>(bs, brow, row0, bias_rows, kv0, nt * 16, ldb, T, warp, lane, blockDim.x >> 5);
    cp_commit();
    cp_rows<D>(vs, v + base, kv0, nt * 16, T, threadIdx.x, blockDim.x);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // q, keys and bias in; values may still be on their way
    if (kv0 == 0) load_a<D>(qa, qs + grp * 16 * LD, lane);

    // the staged bias row of this lane's rows g, g + 8 (which share their
    // phase) or of the mask, and its phase
    const float* bl = bs + (FULL ? grp * 16 + gi : 0) * ldb;
    const long long brow_off = FULL ? (long long)min(row0 + grp * 16 + gi, T - 1) * T : 0LL;
    const int bm = brow == nullptr ? 0 : phase(brow + brow_off + kv0);
    // scores s[jj][h]: rows g, g + 8 x keys 16 j + 8 h + 2t, + 1, j = split + jj * SPLITS
    float s[TILES_PER_WARP][2][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < TILES_PER_WARP; ++jj) {
      const int j = split + jj * SPLITS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (j < nt) tile_abt<D, false>(s[jj][h], qa, ks + (j * 16 + h * 8) * LD, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows g + 8r
          const int key = j * 16 + h * 8 + 2 * t;
          float2 b = make_float2(0.f, 0.f);
          if (j < nt && brow != nullptr) {
            const float* e = bl + (FULL ? 8 * r * ldb : 0) + bm + key;
            b = make_float2(e[0], e[1]);
          }
          float& x0 = s[jj][h][2 * r];
          float& x1 = s[jj][h][2 * r + 1];
          x0 = j < nt && kv0 + key < T ? x0 * scale + b.x : -INFINITY;
          x1 = j < nt && kv0 + key + 1 < T ? x1 * scale + b.y : -INFINITY;
          mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
        }
      }
    }
    // a warp whose keys all lie past T keeps m = -inf and adds nothing
    float rs[2] = {0.f, 0.f}, alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_i[r] - m_use[r]);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < TILES_PER_WARP; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = expf(s[jj][h][c] - m_use[c >> 1]);  // exp(-inf) = 0
          s[jj][h][c] = p;
          rs[c >> 1] += p;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nd][c] *= alpha[c >> 1];

    cp_wait<0>();
    __syncthreads();  // values in
    // O += p.v, 16 keys per step: the two 8-key tiles form one A fragment
#pragma unroll
    for (int jj = 0; jj < TILES_PER_WARP; ++jj) {
      const int j = split + jj * SPLITS;
      if (j < nt) {
        uint32_t ph[4], pl[4];
        split_bf16(s[jj][0][0], s[jj][0][1], ph[0], pl[0]);
        split_bf16(s[jj][0][2], s[jj][0][3], ph[1], pl[1]);
        split_bf16(s[jj][1][0], s[jj][1][1], ph[2], pl[2]);
        split_bf16(s[jj][1][2], s[jj][1][3], ph[3], pl[3]);
        step_split<D>(acc, ph, pl, vs + j * 16 * LD, lane);
      }
    }
  }

  // the row group's warps meet: each warp's O, row max and row sum
  __syncthreads();  // every warp is done with the keys and values, which the merge area aliases
  const int warps = blockDim.x >> 5;
  float* parts = reinterpret_cast<float*>(smem);  // [warps][16][LDO]
  float* stats = parts + warps * 16 * LDO;        // [warps][32]: row max [16], row sum [16]
  float* mine = parts + warp * 16 * LDO;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(mine + (gi + 8 * r) * LDO + nd * 8 + 2 * t) =
          make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
    if (t == 0) {
      stats[warp * 32 + gi + 8 * r] = m_i[r];
      stats[warp * 32 + 16 + gi + 8 * r] = l_i[r];
    }
  }
  __syncthreads();
  // one thread per 8 columns of a row: a 16-byte unit of o
  constexpr int UNITS = D / 8;
  for (int u = threadIdx.x; u < groups * 16 * UNITS; u += blockDim.x) {
    const int r = u / UNITS, c0 = (u % UNITS) * 8, row = row0 + r;
    if (row >= T) break;  // u only grows: later rows are past T too
    const int w0 = (r / 16) * SPLITS, rr = r % 16;
    float mw[SPLITS], m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < SPLITS; ++w) {
      mw[w] = stats[(w0 + w) * 32 + rr];
      m_all = fmaxf(m_all, mw[w]);
    }
    float l_all = 0.f, out[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < SPLITS; ++w) {
      const float e = expf(mw[w] - m_all);  // 0 for a warp with no key
      l_all += e * stats[(w0 + w) * 32 + 16 + rr];
      const float* pw = parts + ((w0 + w) * 16 + rr) * LDO + c0;
      const float4 a = *reinterpret_cast<const float4*>(pw);
      const float4 b = *reinterpret_cast<const float4*>(pw + 4);
      out[0] += e * a.x, out[1] += e * a.y, out[2] += e * a.z, out[3] += e * a.w;
      out[4] += e * b.x, out[5] += e * b.y, out[6] += e * b.z, out[7] += e * b.w;
    }
    uint4 packed;
    packed.x = bits(__floats2bfloat162_rn(out[0] / l_all, out[1] / l_all));
    packed.y = bits(__floats2bfloat162_rn(out[2] / l_all, out[3] / l_all));
    packed.z = bits(__floats2bfloat162_rn(out[4] / l_all, out[5] / l_all));
    packed.w = bits(__floats2bfloat162_rn(out[6] / l_all, out[7] / l_all));
    *reinterpret_cast<uint4*>(o + base + (long long)row * D + c0) = packed;
    if (c0 == 0) lse[(long long)n * T + row] = m_all + logf(l_all);
  }
}

template <int D, bool FULL>
constexpr int max_smem() {
  return fwd_smem_bytes<D>(MAX_GROUPS, CHUNK, FULL ? 16 * MAX_GROUPS : 1);
}

// One block per (residual row, 16 x groups query rows)
template <int D, bool FULL>
int fwd_launch(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* o,
               float* lse, int BH, int T, int H, int groups, float scale, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const int err =
        prepare_kernel(flash_fwd_bf16_kernel<D, FULL>, max_smem<D, FULL>(), 0, 0, nullptr);
    if (err) return err;
    ready = true;
  }
  const int smem =
      fwd_smem_bytes<D>(groups, chunk_keys(T), bias == nullptr ? 0 : FULL ? 16 * groups : 1);
  dim3 grid(BH, (T + 16 * groups - 1) / (16 * groups));
  flash_fwd_bf16_kernel<D, FULL><<<grid, 32 * SPLITS * groups, smem, stream>>>(
      q, k, v, bias, o, lse, T, H, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int fwd(const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
        int BH, int T, int D, int H, int rows, float scale, void* stream) {
  if (BH < 1 || T < 1 || (FULL && bias == nullptr)) return (int)cudaErrorInvalidValue;
  if (rows < 16 || rows % 16 != 0 || rows / 16 > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = rows / 16;
  if (D == 64)
    return fwd_launch<64, FULL>(in(q), in(k), in(v), bias, static_cast<bf16*>(o), lse, BH, T, H,
                                groups, scale, st);
  if (D == 32)
    return fwd_launch<32, FULL>(in(q), in(k), in(v), bias, static_cast<bf16*>(o), lse, BH, T, H,
                                groups, scale, st);
  return (int)cudaErrorInvalidValue;
}

// info = {registers per thread, local (spilled) bytes per thread, dynamic
// shared bytes per block, blocks per SM} of one kernel at `rows` query rows
// per block and T keys, with a bias (a key mask for K2).
template <int D, bool FULL>
int info_of(int rows, int T, int* info) {
  const int groups = rows / 16, threads = 32 * SPLITS * groups;
  const int smem = fwd_smem_bytes<D>(groups, chunk_keys(T), FULL ? 16 * groups : 1);
  int per_sm = 0;
  const int err =
      prepare_kernel(flash_fwd_bf16_kernel<D, FULL>, max_smem<D, FULL>(), threads, smem, &per_sm);
  return err ? err : kernel_info(flash_fwd_bf16_kernel<D, FULL>, smem, per_sm, info);
}

}  // namespace

// Each entry point returns the CUDA error of its launch (0 on success). q, k,
// v, o are __nv_bfloat16 (passed as void*); lse and the bias (null or a
// [B, T] key mask; a [BH, T, T] full score bias for flash_fwd_bias_bf16)
// float32. D must be 32 or 64; `rows`, the query rows per block, 16 or 32.

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const float* bias,
                              void* o, float* lse, int BH, int T, int D, int H, int rows,
                              float scale, void* stream) {
  return fwd<false>(q, k, v, bias, o, lse, BH, T, D, H, rows, scale, stream);
}

extern "C" int flash_fwd_bias_bf16(const void* q, const void* k, const void* v,
                                   const float* bias, void* o, float* lse, int BH, int T, int D,
                                   int H, int rows, float scale, void* stream) {
  return fwd<true>(q, k, v, bias, o, lse, BH, T, D, H, rows, scale, stream);
}

// Registers, spilled bytes, shared bytes and blocks per SM (`info`, 4 ints)
// of K2 (full = 0, with a key mask) or K2f (full = 1) at head dim D, `rows`
// query rows per block and T keys.
extern "C" int flash_fwd_bf16_info(int full, int D, int rows, int T, int* info) {
  if (rows < 16 || rows % 16 != 0 || rows / 16 > MAX_GROUPS || T < 1)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return full ? info_of<64, true>(rows, T, info) : info_of<64, false>(rows, T, info);
  if (D == 32) return full ? info_of<32, true>(rows, T, info) : info_of<32, false>(rows, T, info);
  return (int)cudaErrorInvalidValue;
}
