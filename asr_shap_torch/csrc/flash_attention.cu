// K2-K4: flash attention forward, dq backward and dk/dv backward, float32,
// each with a key-mask or no bias, or with a full score bias (K2f, K3b, K4f).
//
// Replace the Pallas TPU kernels of asr_shap/kernels/flash_attention.py:
//   K2  flash_fwd_kernel<D, false> <- _fwd_kernel (launched by _fwd)
//   K2f flash_fwd_kernel<D, true>  <- the same call with a [bq, T] full-bias
//                                     block
//   K3  flash_dq_kernel<D, false>  <- _dq_kernel (launched by _bwd), no
//                                     d(bias) output
//   K3b flash_dq_kernel<D, true>   <- _dq_kernel with its d(bias) = ds output
//   K4  flash_dkv_kernel<D, false> <- _dkv_kernel (launched by _bwd)
//   K4f flash_dkv_kernel<D, true>  <- _dkv_kernel with the transposed
//                                     [bk, Tq] full-bias block
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
// Bound on the H100: float32 FMA throughput. Per residual row pair the
// backward does 14*T*T*D operations on O(T*D) bytes (T = 149, D = 64 on the
// main path), so operations bound it; the forward is a few MFLOP and is
// bound by its launch. Design: one block of 256 threads per (row n, 64-row
// tile) of the blocked axis, a loop over 64-row tiles of the other axis
// inside the block (the TPU's sequential grid axis has no Hopper
// counterpart). Scores and probabilities live in registers (4x4 per thread)
// and, where a second product needs them in another thread, in shared
// memory; they never reach device memory. The forward uses the online
// softmax. The dq kernel also computes dd = rowsum(g * o) for its rows and
// writes it for the dk/dv kernel, which runs after it on the same stream.
//
// Full bias: K2f and K3b read bias[res, q, k] straight from device memory,
// 16 neighbouring keys per half warp. K3b stores each ds tile once, from
// registers, in the same pattern: its N * T * T floats of d(bias) are the
// one output that is not O(T * D), 212 MB per launch on the conformer path,
// 0.06 ms of the card's memory rate against 0.2 ms of operations. K4f walks
// q tiles for a fixed kv tile, so it stages the [kv, q] bias tile through
// the shared buffer that then holds p, reading device memory along k
// (coalesced) instead of the TPU kernel's transposed copy.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;
constexpr int LD = TILE + 1;  // padded leading dimension: no bank conflicts
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

// Copy rows [row0, row0 + 64) of a row-major [T, D] matrix into a transposed
// shared tile dst[d * LD + row], scaled; rows past T are zero.
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* src, int row0,
                                       int T, float scale) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int row = idx / D, d = idx % D;
    const int t = row0 + row;
    dst[d * LD + row] = t < T ? src[(long long)t * D + d] * scale : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The bias plane or row of residual row res: a [T, T] plane of the full bias,
// or the [T] key mask of its batch entry; null without a bias.
template <bool FULL>
__device__ __forceinline__ const float* bias_base(const float* bias, int res,
                                                  int H, int T) {
  if (bias == nullptr) return nullptr;
  return FULL ? bias + (long long)res * T * T : bias + (long long)(res / H) * T;
}

// The bias of query row `row` and key `col`, both < T.
template <bool FULL>
__device__ __forceinline__ float bias_at(const float* b, int row, int col, int T) {
  if (b == nullptr) return 0.f;
  return FULL ? b[(long long)row * T + col] : b[col];
}

// ------------------------------------------------------------------ K2
template <int D, bool FULL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int T, int H,
                 float scale) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qT = smem;           // [D][LD]
  float* kT = qT + D * LD;    // [D][LD]
  float* vT = kT + D * LD;    // [D][LD]
  float* ps = vT + D * LD;    // [TILE][LD]

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long base = (long long)n * T * D;
  const float* brow = bias_base<FULL>(bias, n, H, T);

  load_t<D>(qT, q + base, q0, T, scale);
  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < T; kv0 += TILE) {
    __syncthreads();
    load_t<D>(kT, k + base, kv0, T, 1.f);
    load_t<D>(vT, v + base, kv0, T, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qT[d * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kT[d * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = kv0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = min(q0 + ty + 16 * i, T - 1);  // rows past T are dropped
        s[i][j] = col < T ? s[i][j] + bias_at<FULL>(brow, row, col, T) : NEG;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
        rs += p;
      }
      l_i[i] = l_i[i] * alpha + half_warp_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    for (int jj = 0; jj < TILE; ++jj) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LD + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vT[(tx + 16 * c) * LD + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) o[base + (long long)t * D + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[(long long)n * T + t] = m_i[i] + logf(l_i[i]);
  }
}

// ------------------------------------------------------------------ K3
template <int D, bool FULL>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ lse, const float* __restrict__ g,
                const float* __restrict__ bias, float* __restrict__ dq,
                float* __restrict__ dd_out, float* __restrict__ dbias, int T,
                int H, int BH, float scale) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qT = smem;           // [D][LD] scaled q
  float* gT = qT + D * LD;    // [D][LD]
  float* kT = gT + D * LD;    // [D][LD]
  float* vT = kT + D * LD;    // [D][LD]
  float* dss = vT + D * LD;   // [TILE][LD]

  const int n = blockIdx.x;
  const int res = n % BH;
  const int q0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long rbase = (long long)res * T * D;
  const long long gbase = (long long)n * T * D;
  const float* brow = bias_base<FULL>(bias, res, H, T);
  float* dbias_n = FULL ? dbias + (long long)n * T * T : nullptr;

  load_t<D>(qT, q + rbase, q0, T, scale);
  load_t<D>(gT, g + gbase, q0, T, 1.f);
  __syncthreads();

  float lse_i[4], dd_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int t = q0 + row;
    float part = 0.f;
    if (t < T) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        part = fmaf(gT[col * LD + row], o[rbase + (long long)t * D + col], part);
      }
    }
    dd_i[i] = half_warp_sum(part);
    lse_i[i] = t < T ? lse[(long long)res * T + t] : 0.f;
    if (tx == 0 && t < T) dd_out[(long long)n * T + t] = dd_i[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < T; kv0 += TILE) {
    __syncthreads();
    load_t<D>(kT, k + rbase, kv0, T, 1.f);
    load_t<D>(vT, v + rbase, kv0, T, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], ga[4], b[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qT[d * LD + ty + 16 * i];
        ga[i] = gT[d * LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = kT[d * LD + tx + 16 * j];
        vb[j] = vT[d * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = kv0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        float ds = 0.f;
        if (col < T) {
          const float b = bias_at<FULL>(brow, min(row, T - 1), col, T);
          const float p = expf(s[i][j] + b - lse_i[i]);
          ds = p * (dp[i][j] - dd_i[i]);
          if (FULL && row < T) dbias_n[(long long)row * T + col] = ds;
        }
        dss[(ty + 16 * i) * LD + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    for (int jj = 0; jj < TILE; ++jj) {
      float dv_[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = dss[(ty + 16 * i) * LD + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = kT[(tx + 16 * c) * LD + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dv_[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[gbase + (long long)t * D + tx + 16 * c] = scale * acc[i][c];
  }
}

// ------------------------------------------------------------------ K4
template <int D, bool FULL>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lse,
                 const float* __restrict__ g, const float* __restrict__ dd,
                 const float* __restrict__ bias, float* __restrict__ dk,
                 float* __restrict__ dv, int T, int H, int BH, float scale) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* kT = smem;            // [D][LD]
  float* vT = kT + D * LD;     // [D][LD]
  float* qT = vT + D * LD;     // [D][LD] scaled q
  float* gT = qT + D * LD;     // [D][LD]
  float* pts = gT + D * LD;    // [TILE][LD] p transposed (kv rows, q cols);
                               // K4f stages the bias tile here first
  float* dsts = pts + TILE * LD;
  float* lse_s = dsts + TILE * LD;  // [TILE]
  float* dd_s = lse_s + TILE;       // [TILE]

  const int n = blockIdx.x;
  const int res = n % BH;
  const int k0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long rbase = (long long)res * T * D;
  const long long gbase = (long long)n * T * D;
  const float* brow = bias_base<FULL>(bias, res, H, T);

  load_t<D>(kT, k + rbase, k0, T, 1.f);
  load_t<D>(vT, v + rbase, k0, T, 1.f);
  float bk[4], acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    bk[i] = (!FULL && brow && t < T) ? brow[t] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  for (int qq0 = 0; qq0 < T; qq0 += TILE) {
    __syncthreads();
    load_t<D>(qT, q + rbase, qq0, T, scale);
    load_t<D>(gT, g + gbase, qq0, T, 1.f);
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int t = qq0 + j;
      lse_s[j] = t < T ? lse[(long long)res * T + t] : 0.f;
      dd_s[j] = t < T ? dd[(long long)n * T + t] : 0.f;
    }
    if (FULL && brow) {
      // pts[kr][qc] = bias[res, qq0 + qc, k0 + kr]: neighbouring threads
      // read neighbouring keys of one query row
      for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
        const int kr = idx % TILE, qc = idx / TILE;
        const int tq = qq0 + qc, tk = k0 + kr;
        pts[kr * LD + qc] = (tq < T && tk < T) ? brow[(long long)tq * T + tk] : 0.f;
      }
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], gb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = kT[d * LD + ty + 16 * i];
        va[i] = vT[d * LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = qT[d * LD + tx + 16 * j];
        gb[j] = gT[d * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], gb[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = tx + 16 * j;
      const bool ok = qq0 + qc < T;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = 0.f, ds = 0.f;
        if (ok) {
          // K4f: this thread's own bias entry, staged above; it is
          // overwritten by p just below, by the same thread
          const float b = (FULL && brow) ? pts[(ty + 16 * i) * LD + qc] : bk[i];
          p = expf(st[i][j] + b - lse_s[qc]);
          ds = p * (dpt[i][j] - dd_s[qc]);
        }
        pts[(ty + 16 * i) * LD + qc] = p;
        dsts[(ty + 16 * i) * LD + qc] = ds;
      }
    }
    __syncthreads();
    for (int jj = 0; jj < TILE; ++jj) {
      float pa[4], da[4], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pts[(ty + 16 * i) * LD + jj];
        da[i] = dsts[(ty + 16 * i) * LD + jj];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gv[c] = gT[(tx + 16 * c) * LD + jj];
        qv[c] = qT[(tx + 16 * c) * LD + jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[i][c] = fmaf(pa[i], gv[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(da[i], qv[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const long long off = gbase + (long long)t * D + tx + 16 * c;
      dk[off] = acc_k[i][c];  // q was scaled on load: this is scale * ds^T q
      dv[off] = acc_v[i][c];
    }
  }
}

template <typename Kernel>
int launch_prep(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)err;
}

template <int D, bool FULL>
int fwd_launch(const float* q, const float* k, const float* v, const float* bias,
               float* o, float* lse, int BH, int T, int H, float scale,
               cudaStream_t stream) {
  dim3 grid(BH, (T + TILE - 1) / TILE);
  const size_t smem = (size_t)(3 * D * LD + TILE * LD) * sizeof(float);
  int err = launch_prep(flash_fwd_kernel<D, FULL>, smem);
  if (err) return err;
  flash_fwd_kernel<D, FULL><<<grid, THREADS, smem, stream>>>(q, k, v, bias, o, lse, T, H, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int fwd(const float* q, const float* k, const float* v, const float* bias,
        float* o, float* lse, int BH, int T, int D, int H, float scale,
        void* stream) {
  if (BH < 1 || T < 1 || (FULL && bias == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return fwd_launch<64, FULL>(q, k, v, bias, o, lse, BH, T, H, scale, st);
  if (D == 32) return fwd_launch<32, FULL>(q, k, v, bias, o, lse, BH, T, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <int D, bool FULL>
int dq_launch(const float* q, const float* k, const float* v, const float* o,
              const float* lse, const float* g, const float* bias, float* dq,
              float* dd, float* dbias, int N, int BH, int T, int H, float scale,
              cudaStream_t stream) {
  dim3 grid(N, (T + TILE - 1) / TILE);
  const size_t smem = (size_t)(4 * D * LD + TILE * LD) * sizeof(float);
  int err = launch_prep(flash_dq_kernel<D, FULL>, smem);
  if (err) return err;
  flash_dq_kernel<D, FULL><<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, g, bias, dq, dd, dbias, T, H, BH, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int dq(const float* q, const float* k, const float* v, const float* o,
       const float* lse, const float* g, const float* bias, float* dq_, float* dd,
       float* dbias, int N, int BH, int T, int D, int H, float scale, void* stream) {
  if (N < 1 || BH < 1 || N % BH != 0 || T < 1) return (int)cudaErrorInvalidValue;
  if (FULL && (bias == nullptr || dbias == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return dq_launch<64, FULL>(q, k, v, o, lse, g, bias, dq_, dd, dbias, N, BH, T, H, scale, st);
  if (D == 32) return dq_launch<32, FULL>(q, k, v, o, lse, g, bias, dq_, dd, dbias, N, BH, T, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <int D, bool FULL>
int dkv_launch(const float* q, const float* k, const float* v, const float* lse,
               const float* g, const float* dd, const float* bias, float* dk,
               float* dv, int N, int BH, int T, int H, float scale,
               cudaStream_t stream) {
  dim3 grid(N, (T + TILE - 1) / TILE);
  const size_t smem = (size_t)(4 * D * LD + 2 * TILE * LD + 2 * TILE) * sizeof(float);
  int err = launch_prep(flash_dkv_kernel<D, FULL>, smem);
  if (err) return err;
  flash_dkv_kernel<D, FULL><<<grid, THREADS, smem, stream>>>(q, k, v, lse, g, dd, bias, dk, dv, T, H, BH, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int dkv(const float* q, const float* k, const float* v, const float* lse,
        const float* g, const float* dd, const float* bias, float* dk, float* dv,
        int N, int BH, int T, int D, int H, float scale, void* stream) {
  if (N < 1 || BH < 1 || N % BH != 0 || T < 1 || (FULL && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return dkv_launch<64, FULL>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, H, scale, st);
  if (D == 32) return dkv_launch<32, FULL>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry point returns the CUDA error of its launch (0 on success).
// D must be 32 or 64. bias: null or a [B, T] key mask for K2-K4, a [BH, T, T]
// full score bias for the *_bias / *_dbias entry points.

extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             const float* bias, float* o, float* lse, int BH,
                             int T, int D, int H, float scale, void* stream) {
  return fwd<false>(q, k, v, bias, o, lse, BH, T, D, H, scale, stream);
}

extern "C" int flash_fwd_bias_f32(const float* q, const float* k, const float* v,
                                  const float* bias, float* o, float* lse, int BH,
                                  int T, int D, int H, float scale, void* stream) {
  return fwd<true>(q, k, v, bias, o, lse, BH, T, D, H, scale, stream);
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
