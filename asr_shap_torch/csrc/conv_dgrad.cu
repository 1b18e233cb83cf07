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
// Bound on the H100: tensor-core operations. Per phase r the sum is a GEMM
// with M = B*V rows (b, v), N = C_in and a reduction over (tap d, C_out),
// A = the ybar rows and B = w[k] as [C_in, C_out], both K-major. Per call it
// does 2*B*T_out*K*C_in*C_out operations on (B*T_out*C_out + B*T_in*C_in)*4
// bytes. The products run on the tensor cores in 3xTF32: each operand x is
// split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and the sum takes
// lo*hi + hi*lo, then hi*hi (lo*lo is dropped). The tensor cores round
// their float32 sums toward zero, so each 8-wide step's three products
// start from a zero partial sum, which a float32 add (round to nearest)
// then adds to the running sum: on the card this keeps the result as close
// to float64 as a float32 sum (chip_smoke.py checks it against float64
// beside the float32 plain version). Three TF32 products per float32
// product make the bound 3 * ops / 495 TFLOP/s: 13.2 ms per draw of the
// Wav2Vec2 feature encoder (149 cotangent rows, C = 512), against 32.5 ms
// for float32 FMAs.
//
// Design: mma.sync.m16n8k8 TF32 with register fragments. A block owns 128
// rows (b, v) of one phase r and 128 input channels; its four warps each own
// a 64 x 64 tile of sums in registers. The blocks of one row tile (all
// channel tiles and phases) are launched next to each other, so its ybar
// rows come from device memory about once and from L2 after. The reduction
// runs in steps of 32 over (d, C_out) through a 3-stage ring of
// shared-memory tiles filled by 16-byte cp.async copies; a halo row v - d outside [0, T_out), or a row
// past B*V, arrives as the copy's zero fill. Tiles span clips, as the rows
// (b, v) run on: only the last tile of a phase has rows to spare. Tiles are
// stored with their 16-byte chunks XOR-swizzled by row, so the fragment
// loads are free of bank conflicts. The hi/lo split is done in registers on
// each fragment with integer rounding (bit-identical to cvt.rna.tf32.f32).
// The three products of one partial sum depend on each other, so they are
// issued pass by pass over 4 partials, not back to back.
// Sums are stored from registers at the phase-interleaved address, in
// 16-byte stores after a swap between neighbouring lanes.
//
// The bf16 kernel of the same function is in conv_dgrad_bf16.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // output rows (b, v) per block
constexpr int BN = 128;     // input channels per block
constexpr int BK = 32;      // reduction step over C_out
constexpr int STAGES = 3;   // shared-memory ring
constexpr int THREADS = 128;
constexpr int WM = 64, WN = 64;  // warp tile: warps 2 x 2
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int TILE_FLOATS = BM * BK;  // one operand tile (BM == BN)
constexpr size_t SMEM_BYTES = (size_t)STAGES * 2 * TILE_FLOATS * sizeof(float);

// Offset of (row, col) in a [rows][BK] tile whose 16-byte chunks are
// XOR-swizzled by the row's low three bits.
__device__ __forceinline__ int swz(int row, int col) {
  return row * BK + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero:
// the same bits as cvt.rna.tf32.f32, on the integer pipe.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
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

__global__ void __launch_bounds__(THREADS, 2)
dgrad_kernel(const float* __restrict__ ybar, const float* __restrict__ w,
             float* __restrict__ xbar, int B, int T_out, int T_in, int C_out,
             int C_in, int K, int S, int V) {
  extern __shared__ __align__(16) float smem[];  // [STAGES][A tile, B tile]
  __shared__ int2 rows_bv[BM];  // (b * T_out, v) of each A row; v < 0: no row

  // The blocks of one row tile (every channel tile and phase) are
  // consecutive, so they run together and read its ybar rows from L2.
  const int per_tile = (C_in / BN) * S;
  const long long m0 = (long long)(blockIdx.x / per_tile) * BM;
  const int r = blockIdx.x % per_tile / (C_in / BN);
  const int n0 = blockIdx.x % (C_in / BN) * BN;
  const long long M = (long long)B * V;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * WM, wn = (warp & 1) * WN;

  for (int i = tid; i < BM; i += THREADS) {
    const long long m = m0 + i;
    rows_bv[i] = m < M ? make_int2((int)(m / V) * T_out, (int)(m % V))
                       : make_int2(0, -(1 << 30));
  }
  __syncthreads();

  // Loader: thread tid moves chunk (tid & 7) of rows (tid >> 3) + 16 * i.
  constexpr int LROWS = BM * (BK / 4) / THREADS;  // 8 rows per thread
  const int lchunk = tid & 7;
  const int lrow0 = tid >> 3;

  const int ntaps = r < K ? (K - 1 - r) / S + 1 : 0;
  const int steps_per_tap = C_out / BK;
  const int nsteps = ntaps * steps_per_tap;
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(smem);

  auto load = [&](int step, int slot) {
    const int d = step / steps_per_tap;
    const int co0 = (step % steps_per_tap) * BK + lchunk * 4;
    const int k = d * S + r;
    const uint32_t a_s = smem0 + (uint32_t)(slot * 2 * TILE_FLOATS) * 4u;
    const uint32_t b_s = a_s + (uint32_t)TILE_FLOATS * 4u;
#pragma unroll
    for (int i = 0; i < LROWS; ++i) {
      const int row = lrow0 + 16 * i;
      const int2 bv = rows_bv[row];
      const int u = bv.y - d;
      const bool ok = u >= 0 && u < T_out;
      const float* src = ok ? ybar + ((long long)bv.x + u) * C_out + co0 : ybar;
      cp_async16(a_s + (uint32_t)swz(row, lchunk * 4) * 4u, src, ok);
      cp_async16(b_s + (uint32_t)swz(row, lchunk * 4) * 4u,
                 w + ((long long)k * C_in + n0 + row) * C_out + co0, true);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int step = 0; step < nsteps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // the tile of `step` is in; every warp is done with step - 1
    const int next = step + STAGES - 1;
    if (next < nsteps) load(next, next % STAGES);
    asm volatile("cp.async.commit_group;\n" ::);

    const float* As = smem + (step % STAGES) * 2 * TILE_FLOATS;
    const float* Bs = As + TILE_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ahi[MI][4], alo[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = wm + i * 16 + g;
        split(As[swz(row, kk + t)], ahi[i][0], alo[i][0]);
        split(As[swz(row + 8, kk + t)], ahi[i][1], alo[i][1]);
        split(As[swz(row, kk + t + 4)], ahi[i][2], alo[i][2]);
        split(As[swz(row + 8, kk + t + 4)], ahi[i][3], alo[i][3]);
      }
      // One channel tile at a time: its three products for this 8-wide step
      // go into a partial sum that starts at zero, pass by pass over the MI
      // partials (an mma waits for the last one on its accumulator), and
      // the partial is then added to the sum with a float32 add. The tensor
      // cores round their sum toward zero, so adding small products to the
      // large running sum inside the mma would lose part of each of them,
      // always in the same direction.
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        uint32_t bhi[2], blo[2];
        const int col = wn + j * 8 + g;
        split(Bs[swz(col, kk + t)], bhi[0], blo[0]);
        split(Bs[swz(col, kk + t + 4)], bhi[1], blo[1]);
        float part[MI][4] = {};
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_tf32(part[i], alo[i], bhi[0], bhi[1]);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_tf32(part[i], ahi[i], blo[0], blo[1]);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_tf32(part[i], ahi[i], bhi[0], bhi[1]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][c];
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // Epilogue. Lane t holds rows g and g + 8, channels 2t and 2t + 1 of each
  // 8-channel tile; neighbouring lanes swap halves so that an even lane
  // stores 4 channels of row g and an odd lane 4 channels of row g + 8.
  const bool odd = t & 1;
  const int ccol = wn + 2 * (t & ~1);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long long m = m0 + wm + i * 16 + g + (odd ? 8 : 0);
    float* out = nullptr;
    if (m < M) {
      const int b = (int)(m / V);
      const int tt = (int)(m % V) * S + r;
      if (tt < T_in) out = xbar + ((long long)b * T_in + tt) * C_in + n0 + ccol;
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float* c = acc[i][j];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      if (out != nullptr) {
        *reinterpret_cast<float4*>(out + j * 8) =
            odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1);
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). ybar, w and xbar must
// be 16-byte aligned; C_in and C_out multiples of 128.
extern "C" int conv1d_dgrad_f32(const float* ybar, const float* w, float* xbar,
                                int B, int T_out, int T_in, int C_out, int C_in,
                                int K, int S, void* stream) {
  if (C_in % BN != 0 || C_out % BK != 0 || S < 1 || K < 1 || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int V = (T_in + S - 1) / S;
  const long long M = (long long)B * V;
  const long long blocks = (M + BM - 1) / BM * (C_in / BN) * S;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dgrad_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      ybar, w, xbar, B, T_out, T_in, C_out, C_in, K, S, V);
  return (int)cudaGetLastError();
}
