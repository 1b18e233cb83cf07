// K1: input gradient (dgrad) of a valid stride-S conv1d, channels-last.
//
// Replaces the Pallas TPU kernel asr_shap/kernels/conv_dgrad.py
// (_dgrad_kernel, launched by _dgrad_call). With t = v*S + r and k = d*S + r:
//
//   xbar[b, v*S + r, ci] = sum_{d : d*S + r < K, 0 <= v - d < T_out}
//                          sum_co ybar[b, v - d, co] * w[d*S + r, ci, co]
//
// ybar [B, T_out, C_out], w [K, C_in, C_out], xbar [B, T_in, C_in], float32.
// Every row t < T_in is written (rows no tap reaches are zero).
//
// Bound on the H100: float32 FMA throughput. Per call it does
// 2*B*T_out*K*C_in*C_out operations on (B*T_out*C_out + B*T_in*C_in)*4 bytes,
// far above the card's float32 operations-per-byte balance. Design: a tiled
// SIMT GEMM. A block owns 128 output rows (b, v) of one phase r and 128 input
// channels; the reduction runs over (tap d, C_out) in steps of 8. Each thread
// keeps an 8x8 tile of sums in registers (two 4-row by two 4-channel
// sub-tiles, so its operands come from shared memory as 16-byte loads).
// Shared memory is double-buffered: the next step's operands are loaded
// from device memory into registers and stored to the other buffer while
// the current step computes, one barrier per step. The halo rows v - d are
// read straight from device memory, out-of-range rows are loaded as zeros,
// and the phase interleave is the store address.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows (b, v) per block
constexpr int BN = 128;  // input channels per block
constexpr int BK = 8;    // reduction step over C_out
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const float* __restrict__ ybar, const float* __restrict__ w,
             float* __restrict__ xbar, int B, int T_out, int T_in, int C_out,
             int C_in, int K, int S, int V) {
  __shared__ __align__(16) float As[2][BK][BM];  // ybar rows, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];  // w[k] rows, transposed

  const int r = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)B * V;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid / 16;  // rows     ty*4 + {0..3} and 64 + ty*4 + {0..3}

  // Loader: each thread moves one float4 of A and one of B per step; two
  // neighbouring threads cover the 32 contiguous bytes of one row.
  const int lrow = tid >> 1;       // 0..127
  const int lcol = (tid & 1) * 4;  // 0 or 4
  const long long am = m0 + lrow;
  const bool arow_ok = am < M;
  const int ab = arow_ok ? (int)(am / V) : 0;
  const int av = arow_ok ? (int)(am % V) : 0;

  const int ntaps = r < K ? (K - 1 - r) / S + 1 : 0;
  const int steps_per_tap = C_out / BK;
  const int nsteps = ntaps * steps_per_tap;

  float4 a_next = make_float4(0.f, 0.f, 0.f, 0.f), b_next = a_next;
  auto load = [&](int step) {
    const int d = step / steps_per_tap;
    const int co0 = (step % steps_per_tap) * BK;
    const int k = d * S + r;
    const int u = av - d;
    a_next = make_float4(0.f, 0.f, 0.f, 0.f);
    if (arow_ok && u >= 0 && u < T_out) {
      a_next = *reinterpret_cast<const float4*>(
          ybar + ((long long)ab * T_out + u) * C_out + co0 + lcol);
    }
    b_next = *reinterpret_cast<const float4*>(
        w + ((long long)k * C_in + n0 + lrow) * C_out + co0 + lcol);
  };
  auto store = [&](int buf) {
    As[buf][lcol + 0][lrow] = a_next.x;
    As[buf][lcol + 1][lrow] = a_next.y;
    As[buf][lcol + 2][lrow] = a_next.z;
    As[buf][lcol + 3][lrow] = a_next.w;
    Bs[buf][lcol + 0][lrow] = b_next.x;
    Bs[buf][lcol + 1][lrow] = b_next.y;
    Bs[buf][lcol + 2][lrow] = b_next.z;
    Bs[buf][lcol + 3][lrow] = b_next.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nsteps > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int step = 0; step < nsteps; ++step) {
    const int cur = step & 1;
    if (step + 1 < nsteps) load(step + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (step + 1 < nsteps) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    const int b = (int)(m / V);
    const int t = (int)(m % V) * S + r;
    if (t >= T_in) continue;
    float* out = xbar + ((long long)b * T_in + t) * C_in + n0;
    *reinterpret_cast<float4*>(out + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). ybar, w and xbar must
// be 16-byte aligned; C_in a multiple of 128 and C_out of 8.
extern "C" int conv1d_dgrad_f32(const float* ybar, const float* w, float* xbar,
                                int B, int T_out, int T_in, int C_out, int C_in,
                                int K, int S, void* stream) {
  if (C_in % BN != 0 || C_out % BK != 0 || S < 1 || K < 1 || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int V = (T_in + S - 1) / S;
  const long long M = (long long)B * V;
  dim3 grid((unsigned)((M + BM - 1) / BM), C_in / BN, S);
  dgrad_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      ybar, w, xbar, B, T_out, T_in, C_out, C_in, K, S, V);
  return (int)cudaGetLastError();
}
