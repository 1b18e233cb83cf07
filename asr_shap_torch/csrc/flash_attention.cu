// K2-K4: flash attention forward, dq backward and dk/dv backward, float32,
// each with a key-mask or no bias, or with a full score bias (K2f, K3b, K4f).
//
// Replace the Pallas TPU kernels of asr_shap/kernels/flash_attention.py:
//   K2  flash_fwd_kernel<D, false>     <- _fwd_kernel (launched by _fwd)
//   K2f flash_fwd_kernel<D, true>      <- the same call with a [bq, T] full-bias
//                                         block
//   K3  flash_dq_mma_kernel<D, false>  <- _dq_kernel (launched by _bwd), no
//                                         d(bias) output
//   K3b flash_dq_mma_kernel<D, true>   <- _dq_kernel with its d(bias) = ds output
//   K4  flash_dkv_mma_kernel<D, false> <- _dkv_kernel (launched by _bwd)
//   K4f flash_dkv_mma_kernel<D, true>  <- _dkv_kernel with the transposed
//                                         [bk, Tq] full-bias block
//
// Layouts: q, k, v, o [BH, T, D]; lse [BH, T]; g, dq, dk, dv [N, T, D] and
// dd [N, T] with N a multiple of BH. Row n of g is the cotangent of residual
// row res = n % BH: the explainer's vmapped cotangent rows fold into N while
// the forward residuals are stored once. Scores are (q * scale) . k + bias,
// scale = D^-1/2. The bias is one of
//   - null;
//   - a [B, T] additive key mask (B = BH / H), the [B, 1, 1, T] mask of the
//     reference; it gets no gradient;
//   - a full [BH, T, T] score bias (the rel-pos scores of the conformer
//     families); row n reads plane res, and K3b writes d(bias) = ds as
//     dbias [N, T, T], one plane per cotangent row.
// Bias entries of -1e9 (padded keys) give probabilities of exactly 0.
//
// Bound on the H100: operations, for the backward. Per residual row pair it
// does 14*T*T*D operations on O(T*D) bytes (T = 149, D = 64 on the main
// path); K3b adds its N * T * T floats of d(bias), 212 MB per launch on the
// conformer path, which puts its bytes (0.12 ms of the card's memory rate)
// just above its operations. The backward kernels (see their section) run
// every product on the tensor cores in 3xTF32, so three TF32 products per
// float32 product at the TF32 rate bound them, and they compute each
// residual row's probabilities once for a run of groups of its cotangent
// rows (mma.sync.m16n8k8 TF32), never once per cotangent row. Scores and
// probabilities live in registers and shared memory; they never reach
// device memory. Each dq kernel also computes dd = rowsum(g * o) for its
// rows and writes it for the dk/dv kernel, which runs after it on the same
// stream.
//
// The forward (K2, K2f) is a few MFLOP per launch (about 1 us of the card's
// float32 rate), so its time is latency: loading the head's K and V, and
// the chain of products and the softmax within one warp. Its design (see
// the K2 section) keeps the whole key row in shared memory, runs both
// products on the tensor cores in 3xTF32 and splits each 16 query rows'
// keys over eight warps, so that each warp's chain is an eighth as long.
//
// Full bias: the kernels read bias[res, q, k] straight from device memory,
// once per block: K2f its lanes' entries into registers while its keys
// load, K3b and K4f as they compute the block's p tile (K4f's p^T reads the
// plane strided by T across queries, the TPU kernel's transposed block).
// K3b stores each warp's ds tile to d(bias) from the registers it was
// computed in.
//
// bf16: the same functions on bf16 q, k, v (o, dq, dk, dv in bf16) are
// kernels of their own, built for the bf16 tensor cores: the forward (K2,
// K2f) in flash_fwd_bf16.cu, the backward (K3, K4, K3b, K4f) in
// flash_bwd_bf16.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

// ------------------------------------------------------------------ K2
//
// The TPU kernel takes the whole padded key row of K and V at once and runs
// a single-pass softmax; so does this one. A block holds the head's keys and
// values in shared memory (up to FWD_CHUNK = 192 rows at a time, loaded with
// 16-byte cp.async copies, rows past T zero filled), and its query rows,
// copied the same way. Each 16 query rows of the block belong to
// FWD_SPLITS = 8 warps, and each of those warps takes an eighth of the key
// tiles: the chain of dependent work a warp runs (Q.K^T over its keys, the
// exponentials, P.V) is an eighth of the row's, which is what sets the
// time of a launch this small. A full bias is
// read into registers while the keys are on their way. Q.K^T and P.V run on
// the tensor cores in 3xTF32 (mma.sync.m16n8k8, hi/lo split in registers,
// as K1); the three products of a group of accumulators are issued pass by
// pass, so no mma waits on the one before. Unlike K1's, the sums here are
// short (8 steps over D, at most 3 key tiles per warp and chunk), so they
// accumulate in the mma itself: its rounding toward zero costs a few ulp,
// well inside the checks' tolerance. A warp's scores stay in registers: its row max and sum come
// from the four lanes of a quad, and P feeds P.V from the registers it was
// computed in, because the score tile's accumulator layout equals the
// A-fragment layout once the keys of each 8-key step are taken in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (the V fragments are read in the same order). The
// warps of a row group then meet in shared memory: with each warp's row max
// m_w, sum l_w and unnormalised O_w, o = sum_w e^(m_w - M) O_w / L and
// lse = M + log L, where M = max_w m_w and L = sum_w e^(m_w - M) l_w. A row
// longer than FWD_CHUNK keys (not on the main path, where T = 149 fits one
// chunk) is walked in chunks with the online rescale between them. The
// block's row count is the caller's: 16 or 32.

constexpr int FWD_KT = 24;      // 8-key tiles per chunk
constexpr int FWD_CHUNK = 8 * FWD_KT;
constexpr int FWD_SPLITS = 8;   // warps per 16 query rows
constexpr int FWD_MAX_GROUPS = 2;  // 16-row groups per block
constexpr int FWD_MAX_THREADS = 32 * FWD_SPLITS * FWD_MAX_GROUPS;

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  // cvt.rna.tf32.f32's bits (nearest, ties away from zero), on the integer pipe
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + rows) of a row-major [T, D] matrix into shared rows of
// stride D + 4 floats, 16 bytes per copy; rows past T are zero filled. The
// copies are dealt out over `nthreads` threads, this one being `tid`.
template <int D>
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int row0, int rows,
                                        int T, int tid, int nthreads) {
  constexpr int CH = D / 4;
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(dst);
  for (int idx = tid; idx < rows * CH; idx += nthreads) {
    const int row = idx / CH, c = idx % CH;
    const bool ok = row0 + row < T;
    const float* p = ok ? src + (long long)(row0 + row) * D + c * 4 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     s0 + (uint32_t)(row * (D + 4) + c * 4) * 4u),
                 "l"(p), "r"(ok ? 16 : 0));
  }
}

// Shared memory of one launch: K and V of a chunk, the block's q rows, then
// each warp's partial O [16][D + 4], row max [16] and row sum [16].
template <int D>
__host__ __device__ constexpr int fwd_part_floats() { return 16 * (D + 4) + 32; }

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes(int groups) {
  return ((size_t)2 * FWD_CHUNK * (D + 4) + (size_t)groups * 16 * (D + 4) +
          (size_t)groups * FWD_SPLITS * fwd_part_floats<D>()) * sizeof(float);
}

template <int D, bool FULL>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int T, int H,
                 float scale) {
  constexpr int LDS = D + 4;  // shared row stride: conflict-free fragments
  constexpr int KS = D / 8;   // 8-wide steps over D (4 or 8)
  constexpr int CHUNK = FWD_CHUNK;
  constexpr int SPLITS = FWD_SPLITS;
  constexpr int KTW = FWD_KT / SPLITS;  // key tiles of one warp per chunk
  static_assert(FWD_KT % SPLITS == 0, "key tiles split evenly over the warps");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [CHUNK][LDS]
  float* vs = ks + CHUNK * LDS;   // [CHUNK][LDS]
  const int groups = blockDim.x / (32 * SPLITS);
  float* qs = vs + CHUNK * LDS;   // [groups * 16][LDS]
  float* parts = qs + groups * 16 * LDS;

  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / SPLITS, split = warp % SPLITS;
  const int q0 = (blockIdx.y * groups + grp) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + g;  // this lane's rows: r0 and r0 + 8
  const long long base = (long long)n * T * D;
  const float* brow = bias_base<FULL>(bias, n, H, T);
  const float* bias_r0 = FULL ? brow + (long long)min(r0, T - 1) * T : brow;
  const float* bias_r1 = FULL ? brow + (long long)min(r0 + 8, T - 1) * T : brow;

  // the block's q rows arrive with the first chunk's keys
  cp_rows<D>(qs, q + base, blockIdx.y * groups * 16, groups * 16, T, threadIdx.x, blockDim.x);
  float qa[KS][4];  // A fragments of the group's scaled q rows

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int kv0 = 0; kv0 < T; kv0 += CHUNK) {
    const int rows = min(CHUNK, (T - kv0 + 7) & ~7);
    const int nt = rows / 8;
    const int j0 = split * KTW;  // this warp's first key tile
    if (kv0 > 0) __syncthreads();  // every warp is done with the last chunk
    cp_rows<D>(ks, k + base, kv0, rows, T, threadIdx.x, blockDim.x);
    asm volatile("cp.async.commit_group;\n" ::);
    cp_rows<D>(vs, v + base, kv0, rows, T, threadIdx.x, blockDim.x);
    asm volatile("cp.async.commit_group;\n" ::);
    // this warp's bias (or -inf past T), read while the copies run
    float bb[KTW][4];
#pragma unroll
    for (int jj = 0; jj < KTW; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kv0 + (j0 + jj) * 8 + 2 * t + (c & 1);
        const float* b = (c >> 1) ? bias_r1 : bias_r0;
        bb[jj][c] = col >= T ? -INFINITY : b == nullptr ? 0.f : b[col];
      }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();  // keys (and q) in; values may still be on their way
    if (kv0 == 0) {
#pragma unroll
      for (int st = 0; st < KS; ++st)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          qa[st][c] = qs[(grp * 16 + g + (c & 1) * 8) * LDS + st * 8 + t + (c >> 1) * 4] *
                      scale;
    }

    // scores s[jj]: rows g, g + 8 x keys 8(j0 + jj) + 2t, + 1
    float s[KTW][4];
#pragma unroll
    for (int jj = 0; jj < KTW; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jj][c] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint32_t ahi[4], alo[4], bh[KTW][2], bl[KTW][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) split_tf32(qa[st][c], ahi[c], alo[c]);
#pragma unroll
      for (int jj = 0; jj < KTW; ++jj) {
        const float* kr = ks + ((j0 + jj) * 8 + g) * LDS + st * 8 + t;
        if (j0 + jj < nt) {
          split_tf32(kr[0], bh[jj][0], bl[jj][0]);
          split_tf32(kr[4], bh[jj][1], bl[jj][1]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < KTW; ++jj)
        if (j0 + jj < nt) mma_tf32(s[jj], alo, bh[jj][0], bh[jj][1]);
#pragma unroll
      for (int jj = 0; jj < KTW; ++jj)
        if (j0 + jj < nt) mma_tf32(s[jj], ahi, bl[jj][0], bl[jj][1]);
#pragma unroll
      for (int jj = 0; jj < KTW; ++jj)
        if (j0 + jj < nt) mma_tf32(s[jj], ahi, bh[jj][0], bh[jj][1]);
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < KTW; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = j0 + jj < nt ? s[jj][c] + bb[jj][c] : -INFINITY;
        s[jj][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    // a warp whose keys all lie past T keeps m = -inf and adds nothing
    float rs[2] = {0.f, 0.f}, alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_i[h], quad_max(mx[h]));
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = expf(m_i[h] - m_use[h]);
      m_i[h] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < KTW; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[jj][c] - m_use[c >> 1]);  // exp(-inf) = 0
        s[jj][c] = p;
        rs[c >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
    for (int jd = 0; jd < KS; ++jd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[jd][c] *= alpha[c >> 1];

    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // values in
    // P.V: the k index t of an 8-key step is key 2t, index t + 4 key 2t + 1
#pragma unroll
    for (int jj = 0; jj < KTW; ++jj) {
      if (j0 + jj < nt) {
        uint32_t ahi[4], alo[4];
        const float pa[4] = {s[jj][0], s[jj][2], s[jj][1], s[jj][3]};
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(pa[c], ahi[c], alo[c]);
        const float* vr = vs + ((j0 + jj) * 8 + 2 * t) * LDS + g;
#pragma unroll
        for (int d0 = 0; d0 < KS; d0 += 4) {  // 4 accumulators per pass
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(vr[(d0 + i) * 8], bh[i][0], bl[i][0]);
            split_tf32(vr[LDS + (d0 + i) * 8], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(acc[d0 + i], alo, bh[i][0], bh[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_tf32(acc[d0 + i], ahi, bl[i][0], bl[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(acc[d0 + i], ahi, bh[i][0], bh[i][1]);
        }
      }
    }
  }

  // the row group's warps meet: partial O, row max and row sum of each
  float* mine = parts + warp * fwd_part_floats<D>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int jd = 0; jd < KS; ++jd)
      *reinterpret_cast<float2*>(mine + (g + 8 * h) * LDS + jd * 8 + 2 * t) =
          make_float2(acc[jd][2 * h], acc[jd][2 * h + 1]);
    if (t == 0) {
      mine[16 * LDS + g + 8 * h] = m_i[h];
      mine[16 * LDS + 16 + g + 8 * h] = l_i[h];
    }
  }
  __syncthreads();
  const float* grp_parts = parts + grp * SPLITS * fwd_part_floats<D>();
  for (int idx = split * 32 + lane; idx < 16 * D; idx += 32 * SPLITS) {
    const int row = idx / D, col = idx % D;
    if (q0 + row >= T) break;  // idx only grows: later rows are past T too
    float mw[SPLITS], m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < SPLITS; ++w) {
      mw[w] = grp_parts[w * fwd_part_floats<D>() + 16 * LDS + row];
      m_all = fmaxf(m_all, mw[w]);
    }
    float l_all = 0.f, o_all = 0.f;
#pragma unroll
    for (int w = 0; w < SPLITS; ++w) {
      const float* pw = grp_parts + w * fwd_part_floats<D>();
      const float e = expf(mw[w] - m_all);  // 0 for a warp with no key
      l_all += e * pw[16 * LDS + 16 + row];
      o_all += e * pw[row * LDS + col];
    }
    o[base + (long long)(q0 + row) * D + col] = o_all / l_all;
    if (col == 0) lse[(long long)n * T + q0 + row] = m_all + logf(l_all);
  }
}

// ------------------------------------------------ K3, K4 (K3b, K4f) on the tensor cores
//
// On the main paths N / BH = 149 cotangent rows share each residual row, so
// its probabilities p = exp((q * scale) . k + bias - lse) are the same for
// all of them. One template per function serves both bias kinds (FULL: the
// full score bias of K3b and K4f). A block takes one residual row `res`,
// one 16-row tile of the blocked axis (query rows for K3, key rows for K4)
// and a run of groups of BWD_ROWS of that residual row's cotangent rows
// (n = res + BH * c), one warp per row of a group; the launcher picks the
// run's length so that the grid fills the card's SMs evenly. The block holds the other axis (keys for K3,
// queries for K4) in shared memory, BWD_CHUNK rows at a time (T = 149 is one
// chunk), and its warps compute that chunk's tile of p (K4: p^T) once, into
// shared memory. When the whole axis is one chunk, those rows and the p tile
// serve every group of the run, so a residual row's scores are computed once
// per run of groups, never once per cotangent row; a longer axis is walked
// chunk by chunk for each group (lse is known, so no rescale is needed).
// Every product runs on the tensor cores in 3xTF32 (mma.sync.m16n8k8,
// lo*hi + hi*lo, then hi*hi, as K2): the rows that every warp reads (K and
// V in K3, q in K4) are split into TF32 hi and lo parts as they are stored
// to shared memory; a warp's own rows (g in K3, v in K4) are held in
// registers as A fragments and split where they are used. The accumulator
// tile of dP = g.v^T (K4: dP^T = v.g^T) and the p tile give ds in
// registers, and ds feeds the next product as its A fragment from those
// registers, with the keys (K4: queries) of each 8-wide step in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (as K2's P.V). The tensor cores round their sums
// toward zero, so every 8-wide step of every product (the scores, dP, dq,
// dk, dv) starts from a zero partial that a float32 add takes into its sum
// (K1's remedy): summed inside the mma over D, dq and dk carried 2.5x the
// float32 error against float64 on the card. K3 copies each group's g rows
// (16-byte cp.async) while the group before computes. K4 reads g in two
// fragment layouts, so each warp streams its g rows and dd through shared
// memory, 16 queries at a time in two buffers: the next 16 arrive while the
// warp computes on these. Each g row is read from L2 once per 16-key tile.
// Rows and keys past T give p = 0; a -1e9 key gives p = 0 exactly.
// With a full bias, the p tile adds bias[res, row, key] where the mask adds
// mask[key]: read once per block and chunk, strided by T across K4f's
// queries. K3b then writes each warp's 16 x 8 ds tile to d(bias) as it
// forms it, one scalar store per entry (T = 149 is odd, so a row's start
// has either parity and a float2 store would be misaligned on half the
// rows), skipping rows and keys past T; a chunked key axis writes each
// chunk's part. Stores do not wait for memory, so the 212 MB per launch on
// the conformer path overlaps the products.

constexpr int BWD_CHUNK = 152;           // rows of the walked axis in shared memory
constexpr int BWD_ROWS = 8;              // cotangent rows per group, one warp each
constexpr int BWD_THREADS = 32 * BWD_ROWS;
constexpr int BWD_LDP = BWD_CHUNK + 16;  // row stride of the p tile: conflict-free
constexpr int DQ_JT = 4;                 // 8-wide tiles of dP a K3 warp runs at once
constexpr int DKV_JT = 2;                // the same in K4: one g buffer, 16 queries
static_assert(BWD_CHUNK % 8 == 0 && BWD_LDP % 32 == 8, "chunk and p-tile stride");

// Rows [row0, row0 + rows) of a row-major [T, D] matrix, times `scale`,
// split into TF32 hi and lo parts in shared rows of stride D + 4; rows past
// T are zero.
template <int D>
__device__ __forceinline__ void split_rows(uint32_t* hi, uint32_t* lo, const float* src,
                                           int row0, int rows, int T, float scale) {
  constexpr int CH = D / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int row = idx / CH, c = idx % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < T)
      x = *reinterpret_cast<const float4*>(src + (long long)(row0 + row) * D + c * 4);
    uint4 h, l;
    split_tf32(x.x * scale, h.x, l.x);
    split_tf32(x.y * scale, h.y, l.y);
    split_tf32(x.z * scale, h.z, l.z);
    split_tf32(x.w * scale, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + row * (D + 4) + c * 4) = h;
    *reinterpret_cast<uint4*>(lo + row * (D + 4) + c * 4) = l;
  }
}

// One 16x8 tile of A.B^T over D in 3xTF32, each 8-wide step from a zero
// partial: A the 16 shared rows at ahi/alo, B the 8 shared rows at bhi/blo,
// both split hi/lo with stride D + 4. The score tiles of K3 and K4.
template <int D>
__device__ __forceinline__ void scores_tile(float* s, const uint32_t* ahi, const uint32_t* alo,
                                            const uint32_t* bhi, const uint32_t* blo,
                                            int lane) {
  constexpr int LDS = D + 4;
  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 8; ++st) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int idx = (gi + (c & 1) * 8) * LDS + st * 8 + t + (c >> 1) * 4;
      ah[c] = ahi[idx];
      al[c] = alo[idx];
    }
    const int br = gi * LDS + st * 8 + t;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(part, al, bhi[br], bhi[br + 4]);
    mma_tf32(part, ah, blo[br], blo[br + 4]);
    mma_tf32(part, ah, bhi[br], bhi[br + 4]);
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] += part[c];
  }
}

// acc[nd] += A.B for one 8-wide step in 3xTF32, from a zero partial: A the
// 16x8 fragment (a0..a3, as floats), B the 8 shared rows from `bhi` (stride
// D + 4, taken in the order 0, 2, 4, 6, 1, 3, 5, 7), split hi/lo in `bhi`
// and `blo`, or with FLOAT_B float rows at `bhi` that are split here.
template <int D, bool FLOAT_B>
__device__ __forceinline__ void step_3xtf32(float (*acc)[4], const float* a,
                                            const void* bhi, const uint32_t* blo, int lane) {
  constexpr int LDS = D + 4, ND = D / 8;
  const int gi = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) split_tf32(a[c], ah[c], al[c]);
  const int br = 2 * t * LDS + gi;  // rows 2t and 2t + 1, column nd * 8 + g
#pragma unroll
  for (int d0 = 0; d0 < ND; d0 += 4) {  // 4 partials per pass
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = br + (d0 + i) * 8;
      if (FLOAT_B) {
        const float* bf = static_cast<const float*>(bhi);
        split_tf32(bf[off], bh[i][0], bl[i][0]);
        split_tf32(bf[off + LDS], bh[i][1], bl[i][1]);
      } else {
        const uint32_t* bu = static_cast<const uint32_t*>(bhi);
        bh[i][0] = bu[off];
        bh[i][1] = bu[off + LDS];
        bl[i][0] = blo[off];
        bl[i][1] = blo[off + LDS];
      }
    }
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][c] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_tf32(part[i], al, bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_tf32(part[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_tf32(part[i], ah, bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[d0 + i][c] += part[i][c];
  }
}

// Store a warp's [16, D] accumulator tile (rows row0 + g and + 8, columns
// nd * 8 + 2t, + 1), times `scale`, to rows below T of `out` [T, D].
template <int D>
__device__ __forceinline__ void store_tile(float* out, const float (*acc)[4], int row0,
                                           int T, float scale, int lane) {
  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + gi + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(out + (long long)row * D + nd * 8 + 2 * t) =
          make_float2(scale * acc[nd][2 * h], scale * acc[nd][2 * h + 1]);
  }
}

// dp[jj] = A.B_jj^T over D for the first `nt` (at most JT) 8-row tiles of
// B, in 3xTF32, each 8-wide step from a zero partial: A the warp's 16 rows
// as fragments in registers (floats, split here), B_jj the 8 shared rows at
// bhi + jj * 8 * (D + 4), split hi/lo in bhi and blo, or with FLOAT_B float
// rows at bhi that are split here.
template <int D, int JT, bool FLOAT_B>
__device__ __forceinline__ void dp_tiles(float (*dp)[4], const float (*a)[4], const void* bhi,
                                         const uint32_t* blo, int nt, int lane) {
  constexpr int LDS = D + 4;
  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < JT; ++jj)
#pragma unroll
    for (int c = 0; c < 4; ++c) dp[jj][c] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 8; ++st) {
    uint32_t bh[JT][2], bl[JT][2];
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      const int off = (jj * 8 + gi) * LDS + st * 8 + t;
      if (jj < nt) {
        if (FLOAT_B) {
          const float* bf = static_cast<const float*>(bhi);
          split_tf32(bf[off], bh[jj][0], bl[jj][0]);
          split_tf32(bf[off + 4], bh[jj][1], bl[jj][1]);
        } else {
          const uint32_t* bu = static_cast<const uint32_t*>(bhi);
          bh[jj][0] = bu[off];
          bh[jj][1] = bu[off + 4];
          bl[jj][0] = blo[off];
          bl[jj][1] = blo[off + 4];
        }
      }
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) split_tf32(a[st][c], ah[c], al[c]);
    float part[JT][4];
#pragma unroll
    for (int jj = 0; jj < JT; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[jj][c] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj)
      if (jj < nt) mma_tf32(part[jj], al, bh[jj][0], bh[jj][1]);
#pragma unroll
    for (int jj = 0; jj < JT; ++jj)
      if (jj < nt) mma_tf32(part[jj], ah, bl[jj][0], bl[jj][1]);
#pragma unroll
    for (int jj = 0; jj < JT; ++jj)
      if (jj < nt) mma_tf32(part[jj], ah, bh[jj][0], bh[jj][1]);
#pragma unroll
    for (int jj = 0; jj < JT; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[jj][c] += part[jj][c];
  }
}

template <int D>
__host__ __device__ constexpr size_t dq_mma_smem_bytes() {
  // K and V of a chunk and the block's q rows, each split hi/lo; each
  // warp's g rows and the block's o rows; the p tile
  return ((size_t)4 * BWD_CHUNK * (D + 4) + (size_t)2 * 16 * (D + 4) +
          (size_t)(BWD_ROWS + 1) * 16 * (D + 4) + (size_t)16 * BWD_LDP) * 4;
}

template <int D, bool FULL>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dq_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    const float* __restrict__ bias, float* __restrict__ dq,
                    float* __restrict__ dd_out, float* __restrict__ dbias, int T, int H,
                    int BH, int V, int G, float scale) {
  constexpr int LDS = D + 4, KS = D / 8, CHUNK = BWD_CHUNK, LDP = BWD_LDP;
  extern __shared__ __align__(16) float smem[];
  uint32_t* khi = reinterpret_cast<uint32_t*>(smem);  // [CHUNK][LDS]
  uint32_t* klo = khi + CHUNK * LDS;
  uint32_t* vhi = klo + CHUNK * LDS;
  uint32_t* vlo = vhi + CHUNK * LDS;
  uint32_t* qhi = vlo + CHUNK * LDS;                  // [16][LDS], scaled
  uint32_t* qlo = qhi + 16 * LDS;
  float* gs = reinterpret_cast<float*>(qlo + 16 * LDS);  // [BWD_ROWS][16][LDS]
  float* os = gs + BWD_ROWS * 16 * LDS;                  // [16][LDS]
  float* ps = os + 16 * LDS;                             // [16][LDP]

  const int res = blockIdx.x, q0 = blockIdx.y * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int grp0 = blockIdx.z * G, grp1 = min(grp0 + G, (V + BWD_ROWS - 1) / BWD_ROWS);
  const long long rbase = (long long)res * T * D;
  const float* brow = bias_base<FULL>(bias, res, H, T);
  const int rows_[2] = {q0 + gi, q0 + gi + 8};  // this lane's rows
  float* gw = gs + warp * 16 * LDS;
  const bool one_chunk = T <= CHUNK;

  split_rows<D>(qhi, qlo, q + rbase, q0, 16, T, scale);
  cp_rows<D>(os, o + rbase, q0, 16, T, threadIdx.x, BWD_THREADS);
  if (grp0 * BWD_ROWS + warp < V)  // the first group's g rows of this warp
    cp_rows<D>(gw, g + (res + (long long)BH * (grp0 * BWD_ROWS + warp)) * T * D, q0, 16, T,
               lane, 32);
  asm volatile("cp.async.commit_group;\n" ::);
  float lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lse_r[h] = rows_[h] < T ? lse[(long long)res * T + rows_[h]] : 0.f;

  for (int grp = grp0; grp < grp1; ++grp) {
    const int c = grp * BWD_ROWS + warp;  // this warp's cotangent row
    const bool active = c < V;
    const long long n = res + (long long)BH * c;
    float acc[KS][4];  // dq / scale: rows g, g + 8 x columns nd * 8 + 2t, + 1
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[nd][cc] = 0.f;
    float ga[KS][4], dd[2] = {0.f, 0.f};

    for (int kv0 = 0; kv0 < T; kv0 += CHUNK) {
      const int nt = min(CHUNK, (T - kv0 + 7) & ~7) / 8;
      if (grp == grp0 || !one_chunk) {
        if (grp > grp0 || kv0 > 0) __syncthreads();  // every warp is done with the chunk
        split_rows<D>(khi, klo, k + rbase, kv0, nt * 8, T, 1.f);
        split_rows<D>(vhi, vlo, v + rbase, kv0, nt * 8, T, 1.f);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        // p of the block's 16 rows and the chunk's keys, once for the run
        for (int j = warp; j < nt; j += BWD_ROWS) {
          float s[4];
          scores_tile<D>(s, qhi, qlo, khi + j * 8 * LDS, klo + j * 8 * LDS, lane);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int key = j * 8 + 2 * t + (cc & 1), col = kv0 + key;
            const int row = rows_[cc >> 1];
            float p = 0.f;
            if (row < T && col < T) {
              const float b = FULL ? brow[(long long)row * T + col] : brow ? brow[col] : 0.f;
              p = expf(s[cc] + b - lse_r[cc >> 1]);
            }
            ps[(gi + 8 * (cc >> 1)) * LDP + key] = p;
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      if (kv0 == 0) {
        // the warp's g rows into registers as the A fragments of dP = g.v^T,
        // dd = rowsum(g * o); then the next group's rows start to arrive
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncwarp();
#pragma unroll
        for (int st = 0; st < KS; ++st)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int idx = (gi + 8 * (cc & 1)) * LDS + st * 8 + t + (cc >> 1) * 4;
            ga[st][cc] = gw[idx];
            dd[cc & 1] = fmaf(ga[st][cc], os[idx], dd[cc & 1]);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dd[h] = quad_sum(dd[h]);
          if (t == 0 && rows_[h] < T) dd_out[n * T + rows_[h]] = dd[h];
        }
        __syncwarp();
        if (grp + 1 < grp1 && c + BWD_ROWS < V) {
          cp_rows<D>(gw, g + (n + (long long)BH * BWD_ROWS) * T * D, q0, 16, T, lane, 32);
          asm volatile("cp.async.commit_group;\n" ::);
        }
      }
      for (int j0 = 0; j0 < nt; j0 += DQ_JT) {
        float dp[DQ_JT][4];
        dp_tiles<D, DQ_JT, false>(dp, ga, vhi + j0 * 8 * LDS, vlo + j0 * 8 * LDS, nt - j0, lane);
        // ds = p * (dP - dd) in registers, then dq += ds.k, keys 0,2,4,6,1,3,5,7
#pragma unroll
        for (int jj = 0; jj < DQ_JT; ++jj) {
          const int j = j0 + jj;
          if (j >= nt) break;
          const float2 p0 = *reinterpret_cast<const float2*>(ps + gi * LDP + j * 8 + 2 * t);
          const float2 p1 = *reinterpret_cast<const float2*>(ps + (gi + 8) * LDP + j * 8 + 2 * t);
          const float da[4] = {p0.x * (dp[jj][0] - dd[0]), p1.x * (dp[jj][2] - dd[1]),
                               p0.y * (dp[jj][1] - dd[0]), p1.y * (dp[jj][3] - dd[1])};
          if (FULL) {  // d(bias) = ds: rows g, g + 8 x keys 2t, 2t + 1
            const int col = kv0 + j * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (rows_[h] >= T) continue;
              float* out = dbias + (n * T + rows_[h]) * T + col;
              if (col < T) out[0] = da[h];
              if (col + 1 < T) out[1] = da[h + 2];
            }
          }
          step_3xtf32<D, false>(acc, da, khi + j * 8 * LDS, klo + j * 8 * LDS, lane);
        }
      }
    }
    if (active) store_tile<D>(dq + n * T * D, acc, q0, T, scale, lane);
  }
}

template <int D>
__host__ __device__ constexpr size_t dkv_mma_smem_bytes() {
  // the chunk's q rows and the block's keys, split hi/lo; the p^T tile and
  // the chunk's lse; each warp's two g buffers and two dd buffers
  return ((size_t)2 * BWD_CHUNK * (D + 4) + (size_t)2 * 16 * (D + 4) +
          (size_t)16 * BWD_LDP + BWD_CHUNK + (size_t)BWD_ROWS * 2 * 16 * (D + 4) +
          (size_t)BWD_ROWS * 2 * 16) * 4;
}

// One warp's copy of 16 rows of g (rows past T zero) and of dd into a buffer.
template <int D>
__device__ __forceinline__ void cp_g_dd(float* gb, float* db, const float* g, const float* dd,
                                        int row0, int T, int lane) {
  cp_rows<D>(gb, g, row0, 16, T, lane, 32);
  if (lane < 16) {
    const bool ok = row0 + lane < T;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(db + lane)),
                 "l"(ok ? dd + row0 + lane : dd), "r"(ok ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int D, bool FULL>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dkv_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ g, const float* __restrict__ dd,
                     const float* __restrict__ bias, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int H, int BH, int V, int G, float scale) {
  constexpr int LDS = D + 4, KS = D / 8, CHUNK = BWD_CHUNK, LDP = BWD_LDP;
  extern __shared__ __align__(16) float smem[];
  uint32_t* qhi = reinterpret_cast<uint32_t*>(smem);   // [CHUNK][LDS], scaled
  uint32_t* qlo = qhi + CHUNK * LDS;
  uint32_t* khi = qlo + CHUNK * LDS;                   // [16][LDS]
  uint32_t* klo = khi + 16 * LDS;
  float* gbuf = reinterpret_cast<float*>(klo + 16 * LDS);  // [BWD_ROWS][2][16][LDS]
  float* pts = gbuf + BWD_ROWS * 2 * 16 * LDS;             // [16][LDP] p^T
  float* lses = pts + 16 * LDP;                            // [CHUNK]
  float* ddbuf = lses + CHUNK;                             // [BWD_ROWS][2][16]

  const int res = blockIdx.x, k0 = blockIdx.y * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int grp0 = blockIdx.z * G, grp1 = min(grp0 + G, (V + BWD_ROWS - 1) / BWD_ROWS);
  const long long rbase = (long long)res * T * D;
  const float* brow = bias_base<FULL>(bias, res, H, T);
  const int keys_[2] = {k0 + gi, k0 + gi + 8};  // this lane's keys
  float* gw = gbuf + warp * 2 * 16 * LDS;
  float* dw = ddbuf + warp * 2 * 16;
  const bool one_chunk = T <= CHUNK;

  split_rows<D>(khi, klo, k + rbase, k0, 16, T, 1.f);
  float mk[2];  // the key mask's entries (0 with a full bias, read per query)
#pragma unroll
  for (int h = 0; h < 2; ++h) mk[h] = (!FULL && brow && keys_[h] < T) ? brow[keys_[h]] : 0.f;
  // the block's v rows as the A fragments of dP^T = v.g^T
  float va[KS][4];
#pragma unroll
  for (int st = 0; st < KS; ++st)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int row = keys_[cc & 1], col = st * 8 + t + (cc >> 1) * 4;
      va[st][cc] = row < T ? v[rbase + (long long)row * D + col] : 0.f;
    }

  for (int grp = grp0; grp < grp1; ++grp) {
    const int c = grp * BWD_ROWS + warp;
    const bool active = c < V;
    const long long n = res + (long long)BH * c;
    const float* gn = g + n * T * D;
    const float* ddn = dd + n * T;
    float acc_k[KS][4], acc_v[KS][4];  // keys g, g + 8 x columns nd * 8 + 2t, + 1
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc_k[nd][cc] = acc_v[nd][cc] = 0.f;

    for (int qq0 = 0; qq0 < T; qq0 += CHUNK) {
      const int nt = min(CHUNK, (T - qq0 + 7) & ~7) / 8;
      if (active) cp_g_dd<D>(gw, dw, gn, ddn, qq0, T, lane);  // the first 16 queries
      if (grp == grp0 || !one_chunk) {
        if (grp > grp0 || qq0 > 0) __syncthreads();
        split_rows<D>(qhi, qlo, q + rbase, qq0, nt * 8, T, scale);
        for (int i = threadIdx.x; i < nt * 8; i += BWD_THREADS)
          lses[i] = qq0 + i < T ? lse[(long long)res * T + qq0 + i] : 0.f;
        __syncthreads();
        // p^T of the block's 16 keys and the chunk's queries, once for the run
        for (int j = warp; j < nt; j += BWD_ROWS) {
          float s[4];
          scores_tile<D>(s, khi, klo, qhi + j * 8 * LDS, qlo + j * 8 * LDS, lane);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int qc = j * 8 + 2 * t + (cc & 1);
            const int key = keys_[cc >> 1];
            float p = 0.f;
            if (qq0 + qc < T && key < T) {
              const float b = FULL ? brow[(long long)(qq0 + qc) * T + key] : mk[cc >> 1];
              p = expf(s[cc] + b - lses[qc]);
            }
            pts[(gi + 8 * (cc >> 1)) * LDP + qc] = p;
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      // 16 queries (two 8-wide tiles) per buffer; the next 16 arrive meanwhile
      for (int j0 = 0; j0 < nt; j0 += DKV_JT) {
        const int b = (j0 / DKV_JT) & 1;
        if (j0 + DKV_JT < nt) {
          cp_g_dd<D>(gw + (b ^ 1) * 16 * LDS, dw + (b ^ 1) * 16, gn, ddn,
                     qq0 + (j0 + DKV_JT) * 8, T, lane);
          asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncwarp();
        const float* gb = gw + b * 16 * LDS;
        float dp[DKV_JT][4];
        dp_tiles<D, DKV_JT, true>(dp, va, gb, nullptr, nt - j0, lane);
        // dv += p^T.g and dk += ds^T.(q * scale), ds^T = p^T * (dP^T - dd),
        // queries 0,2,4,6,1,3,5,7
#pragma unroll
        for (int jj = 0; jj < DKV_JT; ++jj) {
          const int j = j0 + jj;
          if (j >= nt) break;
          const int qc = j * 8 + 2 * t;
          const float2 p0 = *reinterpret_cast<const float2*>(pts + gi * LDP + qc);
          const float2 p1 = *reinterpret_cast<const float2*>(pts + (gi + 8) * LDP + qc);
          const float2 ddq = *reinterpret_cast<const float2*>(dw + b * 16 + jj * 8 + 2 * t);
          const float pa[4] = {p0.x, p1.x, p0.y, p1.y};
          const float da[4] = {p0.x * (dp[jj][0] - ddq.x), p1.x * (dp[jj][2] - ddq.x),
                               p0.y * (dp[jj][1] - ddq.y), p1.y * (dp[jj][3] - ddq.y)};
          step_3xtf32<D, true>(acc_v, pa, gb + jj * 8 * LDS, nullptr, lane);
          step_3xtf32<D, false>(acc_k, da, qhi + j * 8 * LDS, qlo + j * 8 * LDS, lane);
        }
        __syncwarp();  // the buffer is refilled two steps on
      }
    }
    if (active) {  // q was scaled before the products
      store_tile<D>(dk + n * T * D, acc_k, k0, T, 1.f, lane);
      store_tile<D>(dv + n * T * D, acc_v, k0, T, 1.f, lane);
    }
  }
}

// Raise the kernel's dynamic shared-memory limit to `smem` bytes. Each
// launcher keeps its own `ready` flag, so this runs once per kernel.
template <typename Kernel>
int launch_prep(Kernel kernel, size_t smem, bool& ready) {
  if (ready) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ready = err == cudaSuccess;
  return (int)err;
}

template <int D, bool FULL>
int fwd_launch(const float* q, const float* k, const float* v, const float* bias,
               float* o, float* lse, int BH, int T, int H, int groups, float scale,
               cudaStream_t stream) {
  dim3 grid(BH, (T + 16 * groups - 1) / (16 * groups));
  static bool ready = false;
  int err = launch_prep(flash_fwd_kernel<D, FULL>, fwd_smem_bytes<D>(FWD_MAX_GROUPS), ready);
  if (err) return err;
  flash_fwd_kernel<D, FULL><<<grid, 32 * FWD_SPLITS * groups, fwd_smem_bytes<D>(groups),
                              stream>>>(q, k, v, bias, o, lse, T, H, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int fwd(const float* q, const float* k, const float* v, const float* bias,
        float* o, float* lse, int BH, int T, int D, int H, int rows, float scale,
        void* stream) {
  if (BH < 1 || T < 1 || (FULL && bias == nullptr)) return (int)cudaErrorInvalidValue;
  if (rows != 16 && rows != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = rows / 16;
  if (D == 64) return fwd_launch<64, FULL>(q, k, v, bias, o, lse, BH, T, H, groups, scale, st);
  if (D == 32) return fwd_launch<32, FULL>(q, k, v, bias, o, lse, BH, T, H, groups, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Groups of BWD_ROWS cotangent rows per block for K3 and K4 (K3b, K4f), whose
// blocks take one SM each: groups_per_block with one block per SM.
int bwd_groups_per_block(int jobs, int groups) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return groups_per_block(jobs, groups, sms);
}

// K3 (K3b): one block per (residual row, 16 query rows, run of G groups)
template <int D, bool FULL>
int dq_mma_launch(const float* q, const float* k, const float* v, const float* o,
                  const float* lse, const float* g, const float* bias, float* dq,
                  float* dd, float* dbias, int N, int BH, int T, int H, float scale,
                  cudaStream_t stream) {
  const int V = N / BH, groups = (V + BWD_ROWS - 1) / BWD_ROWS, tiles = (T + 15) / 16;
  const int G = bwd_groups_per_block(BH * tiles, groups);
  dim3 grid(BH, tiles, (groups + G - 1) / G);
  constexpr size_t smem = dq_mma_smem_bytes<D>();
  static bool ready = false;
  int err = launch_prep(flash_dq_mma_kernel<D, FULL>, smem, ready);
  if (err) return err;
  flash_dq_mma_kernel<D, FULL><<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, o, lse, g, bias, dq, dd, dbias, T, H, BH, V, G, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int dq(const float* q, const float* k, const float* v, const float* o,
       const float* lse, const float* g, const float* bias, float* dq_, float* dd,
       float* dbias, int N, int BH, int T, int D, int H, float scale, void* stream) {
  if (N < 1 || BH < 1 || N % BH != 0 || T < 1) return (int)cudaErrorInvalidValue;
  if (FULL && (bias == nullptr || dbias == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return dq_mma_launch<64, FULL>(q, k, v, o, lse, g, bias, dq_, dd, dbias, N, BH, T, H,
                                   scale, st);
  if (D == 32)
    return dq_mma_launch<32, FULL>(q, k, v, o, lse, g, bias, dq_, dd, dbias, N, BH, T, H,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}

// K4 (K4f): one block per (residual row, 16 key rows, run of G groups)
template <int D, bool FULL>
int dkv_mma_launch(const float* q, const float* k, const float* v, const float* lse,
                   const float* g, const float* dd, const float* bias, float* dk,
                   float* dv, int N, int BH, int T, int H, float scale, cudaStream_t stream) {
  const int V = N / BH, groups = (V + BWD_ROWS - 1) / BWD_ROWS, tiles = (T + 15) / 16;
  const int G = bwd_groups_per_block(BH * tiles, groups);
  dim3 grid(BH, tiles, (groups + G - 1) / G);
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  static bool ready = false;
  int err = launch_prep(flash_dkv_mma_kernel<D, FULL>, smem, ready);
  if (err) return err;
  flash_dkv_mma_kernel<D, FULL><<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, lse, g, dd, bias, dk, dv, T, H, BH, V, G, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int dkv(const float* q, const float* k, const float* v, const float* lse,
        const float* g, const float* dd, const float* bias, float* dk, float* dv,
        int N, int BH, int T, int D, int H, float scale, void* stream) {
  if (N < 1 || BH < 1 || N % BH != 0 || T < 1 || (FULL && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return dkv_mma_launch<64, FULL>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, H, scale, st);
  if (D == 32)
    return dkv_mma_launch<32, FULL>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry point returns the CUDA error of its launch (0 on success).
// D must be 32 or 64. bias: null or a [B, T] key mask for K2-K4, a [BH, T, T]
// full score bias for the *_bias / *_dbias entry points. The forward's
// `rows` is its query rows per block: 16 or 32.

extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             const float* bias, float* o, float* lse, int BH,
                             int T, int D, int H, int rows, float scale, void* stream) {
  return fwd<false>(q, k, v, bias, o, lse, BH, T, D, H, rows, scale, stream);
}

extern "C" int flash_fwd_bias_f32(const float* q, const float* k, const float* v,
                                  const float* bias, float* o, float* lse, int BH,
                                  int T, int D, int H, int rows, float scale,
                                  void* stream) {
  return fwd<true>(q, k, v, bias, o, lse, BH, T, D, H, rows, scale, stream);
}

extern "C" int flash_dq_f32(const float* q, const float* k, const float* v,
                            const float* o, const float* lse, const float* g,
                            const float* bias, float* dq_, float* dd, int N,
                            int BH, int T, int D, int H, float scale,
                            void* stream) {
  return dq<false>(q, k, v, o, lse, g, bias, dq_, dd, nullptr, N, BH, T, D, H, scale, stream);
}

extern "C" int flash_dq_dbias_f32(const float* q, const float* k, const float* v,
                                  const float* o, const float* lse, const float* g,
                                  const float* bias, float* dq_, float* dd,
                                  float* dbias, int N, int BH, int T, int D, int H,
                                  float scale, void* stream) {
  return dq<true>(q, k, v, o, lse, g, bias, dq_, dd, dbias, N, BH, T, D, H, scale, stream);
}

extern "C" int flash_dkv_f32(const float* q, const float* k, const float* v,
                             const float* lse, const float* g, const float* dd,
                             const float* bias, float* dk, float* dv, int N,
                             int BH, int T, int D, int H, float scale,
                             void* stream) {
  return dkv<false>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, D, H, scale, stream);
}

extern "C" int flash_dkv_bias_f32(const float* q, const float* k, const float* v,
                                  const float* lse, const float* g, const float* dd,
                                  const float* bias, float* dk, float* dv, int N,
                                  int BH, int T, int D, int H, float scale,
                                  void* stream) {
  return dkv<true>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, D, H, scale, stream);
}
