// K3, K4 (K3b, K4f) in bf16: the flash attention dq and dk/dv backward for
// bf16 q, k, v, o and g, built for the H100's bf16 tensor cores.
//
// Replace, for bf16 inputs, the Pallas TPU kernels of
// asr_shap/kernels/flash_attention.py:
//   K3  flash_dq_bf16_kernel<D, false>  <- _dq_kernel (launched by _bwd), no
//                                          d(bias) output
//   K3b flash_dq_bf16_kernel<D, true>   <- _dq_kernel with its d(bias) = ds output
//   K4  flash_dkv_bf16_kernel<D, false> <- _dkv_kernel (launched by _bwd)
//   K4f flash_dkv_bf16_kernel<D, true>  <- _dkv_kernel with the transposed
//                                          [bk, Tq] full-bias block
// The float32 kernels of the same functions are in flash_attention.cu; the
// layouts, the work plan and the C entry points' signatures are theirs.
//
// Layouts: q, k, v, o [BH, T, D] bf16; lse [BH, T] float32; g, dq, dk, dv
// [N, T, D] bf16 and dd [N, T] float32, N a multiple of BH; row n of g is
// the cotangent of residual row res = n % BH. The bias is null, a [B, T]
// float32 key mask (B = BH / H) or a full [BH, T, T] float32 score bias, for
// which K3b writes d(bias) = ds [N, T, T] in float32. lse, dd, the mask, the
// full bias and d(bias) are float32, and everything between the bf16 loads
// and the bf16 stores is float32, as in the TPU kernels, which upcast their
// blocks and cast the result to the input's dtype once. Scores are
// scale * (q . k) + bias with scale = D^-1/2 applied to the float32 scores,
// never to q; a -1e9 key gives p = 0 exactly.
//
// Bound on the H100: bytes. Per launch the function reads g and writes dq
// (K3) or dk and dv (K4), 2 bytes each, and K3b writes its float32 d(bias),
// N * T * T * 4 bytes (212 MB on the conformer path); the products the
// function needs, at the bf16 tensor-core peak, take half of that time (K3,
// K4) or a sixth (K3b). The design:
//   - Work plan (as the float32 kernels): a block takes one residual row, one
//     16-row tile of the blocked axis (queries for K3, keys for K4) and a run
//     of G groups of ROWS cotangent rows, one warp per row of a group. It
//     holds the walked axis (keys for K3, queries for K4) in shared memory,
//     CHUNK rows at a time, and computes that chunk's p tile once, into
//     shared memory, for every group of the run (T <= CHUNK is one chunk; a
//     longer axis is walked chunk by chunk for each group, with no rescale:
//     lse is known).
//   - Shared rows stay bf16: K and V of the chunk (K3), the chunk's q and
//     the block's k and v (K4), and each warp's g rows, stored unwidened with
//     a row stride of D + 8 (16 bytes of padding, so that the eight rows of
//     an ldmatrix hit eight different bank groups), loaded with 16-byte
//     cp.async. A block needs 75-96 KB at D = 64 (the float32 kernels
//     173-224 KB), so two blocks share an SM; the launcher counts waves of
//     blocks per SM times SMs (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
//   - A product of two bf16 operands (q.k^T, g.v^T, v.g^T) is one
//     mma.sync.m16n8k16 bf16 per tile step with float32 accumulation;
//     fragments come from ldmatrix.x4, with .trans for an operand read
//     along the other axis.
//   - A product with a float32 operand (ds.k, ds^T.q, p^T.g) splits it in
//     registers into two bf16 terms, hi = rn(x) and lo = rn(x - hi) (16
//     mantissa bits), and takes lo.b + hi.b: one bf16 term would round p and
//     ds to 8 bits, which breaks the card's float64 gate
//     (tests/test_torch_kernels.py shows both on the CPU). Two neighbouring
//     n8 accumulator tiles of m16n8 have the layout of one k16 A fragment,
//     so ds and p^T go from the registers they are computed in straight
//     into the next product; ds never passes through shared memory.
//   - Sums accumulate inside the mma: the outputs are rounded to bf16, far
//     coarser than the tensor cores' truncation. d(bias) is float32 and held
//     to 2x the float32 error against float64, so K3b sums each k16 step of
//     its scores and of dP from zero and adds it in float32
//     (DBIAS_PARTIALS).
//   - K3b stages each warp's 16 x 32 tile of ds in shared memory, each row
//     shifted so that its 16-byte units there are those of device memory
//     (T is odd on the main paths, so row starts take every alignment), and
//     writes d(bias) as whole units, a float4 load and store each, four rows
//     of eight lanes per pass; the unit that straddles two tiles waits for
//     the next one. Only a row's first and last units take scalar stores.
//   - K4 streams each warp's g rows and dd through two shared buffers, 16
//     queries at a time: the next 16 arrive while the warp computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int CHUNK = 160;            // rows of the walked axis in shared memory
constexpr int ROWS = 8;               // cotangent rows per group, one warp each
constexpr int THREADS = 32 * ROWS;
constexpr int LDP = CHUNK + 8;        // float row stride of the p tile
constexpr int STEP_TILES = 4;         // 8-key tiles per step of K3 (two k16 steps)
constexpr int LDST = 8 * STEP_TILES + 4;  // float row stride of K3b's d(bias) staging
// K3b: each k16 step of the scores and of dP summed from zero, then added in
// float32: d(bias) is held to 2x the float32 error against float64 (PERF.md)
constexpr bool DBIAS_PARTIALS = true;
static_assert(CHUNK % (8 * STEP_TILES) == 0 && LDP % 32 == 8, "chunk and p-tile stride");

// The two bf16 of a register (the lower index in the low half) as float32.
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Store a warp's [16, D] accumulator tile (rows row0 + g and + 8, columns
// nd * 8 + 2t, + 1), times `scale`, to the rows below T of `out` [T, D].
template <int D>
__device__ __forceinline__ void store_tile(bf16* out, const float (*acc)[4], int row0, int T,
                                           float scale, int lane) {
  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + gi + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(scale * acc[nd][2 * h], scale * acc[nd][2 * h + 1]);
  }
}

// ------------------------------------------------------------------ K3, K3b

template <int D>
__host__ __device__ constexpr int dq_smem_bytes(bool full) {
  // K and V of a chunk, the block's q and o rows and each warp's g rows, in
  // bf16; the p tile; with a full bias each warp's d(bias) staging rows
  return (2 * CHUNK + 2 * 16 + ROWS * 16) * (D + 8) * 2 + 16 * LDP * 4 +
         (full ? ROWS * 16 * LDST * 4 : 0);
}

// The offset, in floats, of d(bias) row `row` of plane n from a 16-byte
// boundary of device memory (d(bias) itself starts on one). Rows 4 apart
// share it: 4 T floats is a whole number of 16-byte units.
__device__ __forceinline__ int row_phase(long long n, int row, int T) {
  return (int)(((n * T + row) * (long long)T) & 3);
}

// Write a warp's staged 16 x 32 tile of ds to d(bias): rows row0.. of plane
// n, keys col0.. below T. Row r of `sw` (stride LDST) holds key c at
// c - col0 + m, m = row_phase(row): its 16-byte units in shared memory are
// those of device memory. A row goes out as those units, one float4 load
// and store each, up to the unit that holds key col0 + 32: that unit is left
// to the next tile, whose row starts with it (the carry, slots 0..3). Only
// a row's first and last units, which it shares with the rows beside it,
// take scalar stores. Eight lanes per row, rows lane / 8 + 4i.
__device__ __forceinline__ void store_dbias(float* dbias, const float* sw, long long n, int row0,
                                            int col0, int T, int lane) {
  constexpr int KEYS = 8 * STEP_TILES;
  const int r0 = lane >> 3, rows = min(16, T - row0);
  float* out = dbias + (n * T + row0 + r0) * (long long)T;  // row r0's first entry
  const int m = row_phase(n, row0 + r0, T);
  const int hi = col0 + KEYS >= T ? T : col0 + KEYS - m;  // this tile's keys end here
  const int c0 = col0 - m + 4 * (lane & 7);               // this lane's unit
  const float* src = sw + r0 * LDST + 4 * (lane & 7);
  for (int r = r0; r < rows; r += 4, out += 4LL * T, src += 4 * LDST) {
    for (int c = c0, i = 0; c < hi; c += 32, i += 32) {  // a 9th unit: last tile, m + keys > 32
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      if (c >= 0 && c + 4 <= hi) {
        *reinterpret_cast<float4*>(out + c) = x;
      } else {
        const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j >= 0 && c + j < hi) out[c + j] = e[j];
      }
    }
  }
}

template <int D, bool FULL>
__global__ void __launch_bounds__(THREADS, 2)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const float* __restrict__ lse, const bf16* __restrict__ g,
                     const float* __restrict__ bias, bf16* __restrict__ dq,
                     float* __restrict__ dd_out, float* __restrict__ dbias, int T, int H, int BH,
                     int V, int G, float scale) {
  constexpr int LD = D + 8, KS = D / 16, ND = D / 8;
  constexpr bool PART = FULL && DBIAS_PARTIALS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [CHUNK][LD]
  bf16* vs = ks + CHUNK * LD;                 // [CHUNK][LD]
  bf16* qs = vs + CHUNK * LD;                 // [16][LD]
  bf16* os = qs + 16 * LD;                    // [16][LD]
  bf16* gs = os + 16 * LD;                    // [ROWS][16][LD]
  float* ps = reinterpret_cast<float*>(gs + ROWS * 16 * LD);  // [16][LDP]
  float* stage = ps + 16 * LDP;                               // FULL: [ROWS][16][LDST]

  const int res = blockIdx.x, q0 = blockIdx.y * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int grp0 = blockIdx.z * G, grp1 = min(grp0 + G, (V + ROWS - 1) / ROWS);
  const long long rbase = (long long)res * T * D;
  const float* brow = bias_base<FULL>(bias, res, H, T);
  const int rows_[2] = {q0 + gi, q0 + gi + 8};  // this lane's rows
  bf16* gw = gs + warp * 16 * LD;
  float* sw = stage + warp * 16 * LDST;
  const bool one_chunk = T <= CHUNK;

  cp_rows<D>(qs, q + rbase, q0, 16, T, threadIdx.x, THREADS);
  cp_rows<D>(os, o + rbase, q0, 16, T, threadIdx.x, THREADS);
  if (grp0 * ROWS + warp < V)  // the first group's g rows of this warp
    cp_rows<D>(gw, g + (res + (long long)BH * (grp0 * ROWS + warp)) * T * D, q0, 16, T, lane, 32);
  cp_commit();
  float lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lse_r[h] = rows_[h] < T ? lse[(long long)res * T + rows_[h]] : 0.f;

  for (int grp = grp0; grp < grp1; ++grp) {
    const int c = grp * ROWS + warp;  // this warp's cotangent row
    const bool active = c < V;
    const long long n = res + (long long)BH * c;
    float acc[ND][4];  // dq / scale: rows g, g + 8 x columns nd * 8 + 2t, + 1
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[nd][cc] = 0.f;
    uint32_t ga[KS][4];  // the warp's g rows: the A fragments of dP = g.v^T
    float dd[2] = {0.f, 0.f};

    for (int kv0 = 0; kv0 < T; kv0 += CHUNK) {
      const int nt = min(CHUNK, (T - kv0 + 15) & ~15) / 8;  // 8-key tiles, even
      if (grp == grp0 || !one_chunk) {
        if (grp > grp0 || kv0 > 0) __syncthreads();  // every warp is done with the chunk
        cp_rows<D>(ks, k + rbase, kv0, nt * 8, T, threadIdx.x, THREADS);
        cp_rows<D>(vs, v + rbase, kv0, nt * 8, T, threadIdx.x, THREADS);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        // p of the block's 16 rows and the chunk's keys, once for the run
        uint32_t qa[KS][4];
        load_a<D>(qa, qs, lane);
        for (int j = warp; j < nt; j += ROWS) {
          float s[4];
          tile_abt<D, PART>(s, qa, ks + j * 8 * LD, lane);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int key = j * 8 + 2 * t + (cc & 1), col = kv0 + key;
            const int row = rows_[cc >> 1];
            float p = 0.f;
            if (row < T && col < T) {
              const float b = FULL ? brow[(long long)row * T + col] : brow ? brow[col] : 0.f;
              p = expf(s[cc] * scale + b - lse_r[cc >> 1]);
            }
            ps[(gi + 8 * (cc >> 1)) * LDP + key] = p;
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      if (kv0 == 0) {
        // the warp's g rows into registers, dd = rowsum(g * o) from the same
        // fragment positions of o; then the next group's rows start to arrive
        cp_wait<0>();
        __syncwarp();
        load_a<D>(ga, gw, lane);
#pragma unroll
        for (int st = 0; st < KS; ++st)
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // a0..a3: rows g, g + 8 x columns 2t (+ 8)
            const float2 gf = unpack_bf16(ga[st][r]);
            const float2 of = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                os + (gi + 8 * (r & 1)) * LD + st * 16 + 8 * (r >> 1) + 2 * t));
            dd[r & 1] = fmaf(gf.x, of.x, dd[r & 1]);
            dd[r & 1] = fmaf(gf.y, of.y, dd[r & 1]);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dd[h] = quad_sum(dd[h]);
          if (t == 0 && rows_[h] < T) dd_out[n * T + rows_[h]] = dd[h];
        }
        __syncwarp();
        if (grp + 1 < grp1 && c + ROWS < V) {
          cp_rows<D>(gw, g + (n + (long long)BH * ROWS) * T * D, q0, 16, T, lane, 32);
          cp_commit();
        }
      }
      for (int j0 = 0; j0 < nt; j0 += STEP_TILES) {
        // dP = g.v^T, then ds = p * (dP - dd), for four 8-key tiles
        float ds[STEP_TILES][4];
#pragma unroll
        for (int jj = 0; jj < STEP_TILES; ++jj) {
          const int j = j0 + jj;
          if (j < nt) {
            tile_abt<D, PART>(ds[jj], ga, vs + j * 8 * LD, lane);
            const float2 p0 = *reinterpret_cast<const float2*>(ps + gi * LDP + j * 8 + 2 * t);
            const float2 p1 = *reinterpret_cast<const float2*>(ps + (gi + 8) * LDP + j * 8 + 2 * t);
            ds[jj][0] = p0.x * (ds[jj][0] - dd[0]);
            ds[jj][1] = p0.y * (ds[jj][1] - dd[0]);
            ds[jj][2] = p1.x * (ds[jj][2] - dd[1]);
            ds[jj][3] = p1.y * (ds[jj][3] - dd[1]);
          } else {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) ds[jj][cc] = 0.f;
          }
        }
        if (FULL) {  // d(bias) = ds, staged so that rows go out in 16-byte units
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g and g + 8 share their phase
            float* row = sw + (gi + 8 * h) * LDST + row_phase(n, rows_[0], T) + 2 * t;
#pragma unroll
            for (int jj = 0; jj < STEP_TILES; ++jj) {
              row[jj * 8] = ds[jj][2 * h];
              row[jj * 8 + 1] = ds[jj][2 * h + 1];
            }
          }
          __syncwarp();
          store_dbias(dbias, sw, n, q0, kv0 + j0 * 8, T, lane);
          __syncwarp();
          if (lane < 16)  // the unit left over is the next tile's first (the carry)
            *reinterpret_cast<float4*>(sw + lane * LDST) =
                *reinterpret_cast<const float4*>(sw + lane * LDST + 8 * STEP_TILES);
          __syncwarp();
        }
        // dq += ds.k, 16 keys per step: tiles j and j + 1 form one A fragment
#pragma unroll
        for (int kk = 0; kk < STEP_TILES; kk += 2) {
          if (j0 + kk >= nt) break;
          uint32_t ah[4], al[4];
          split_bf16(ds[kk][0], ds[kk][1], ah[0], al[0]);
          split_bf16(ds[kk][2], ds[kk][3], ah[1], al[1]);
          split_bf16(ds[kk + 1][0], ds[kk + 1][1], ah[2], al[2]);
          split_bf16(ds[kk + 1][2], ds[kk + 1][3], ah[3], al[3]);
          step_split<D>(acc, ah, al, ks + (j0 + kk) * 8 * LD, lane);
        }
      }
    }
    if (active) store_tile<D>(dq + n * T * D, acc, q0, T, scale, lane);
  }
}

// ------------------------------------------------------------------ K4, K4f

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // the chunk's q rows, the block's k and v rows and each warp's two g
  // buffers, in bf16; the p^T tile, the chunk's lse and each warp's two dd
  // buffers
  return (CHUNK + 2 * 16 + ROWS * 2 * 16) * (D + 8) * 2 +
         (16 * LDP + CHUNK + ROWS * 2 * 16) * 4;
}

// One warp's copy of 16 rows of g (rows past T zero) and of dd into a buffer.
template <int D>
__device__ __forceinline__ void cp_g_dd(bf16* gb, float* db, const bf16* g, const float* dd,
                                        int row0, int T, int lane) {
  cp_rows<D>(gb, g, row0, 16, T, lane, 32);
  if (lane < 16) {
    const bool ok = row0 + lane < T;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(db + lane)),
                 "l"(ok ? dd + row0 + lane : dd), "r"(ok ? 4 : 0));
  }
  cp_commit();
}

template <int D, bool FULL>
__global__ void __launch_bounds__(THREADS, 2)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ lse,
                      const bf16* __restrict__ g, const float* __restrict__ dd,
                      const float* __restrict__ bias, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int T, int H, int BH, int V, int G, float scale) {
  constexpr int LD = D + 8, KS = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [CHUNK][LD]
  bf16* kb = qs + CHUNK * LD;                 // [16][LD]
  bf16* vb = kb + 16 * LD;                    // [16][LD]
  bf16* gbuf = vb + 16 * LD;                  // [ROWS][2][16][LD]
  float* pts = reinterpret_cast<float*>(gbuf + ROWS * 2 * 16 * LD);  // [16][LDP] p^T
  float* lses = pts + 16 * LDP;                                      // [CHUNK]
  float* ddbuf = lses + CHUNK;                                       // [ROWS][2][16]

  const int res = blockIdx.x, k0 = blockIdx.y * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int grp0 = blockIdx.z * G, grp1 = min(grp0 + G, (V + ROWS - 1) / ROWS);
  const long long rbase = (long long)res * T * D;
  const float* brow = bias_base<FULL>(bias, res, H, T);
  const int keys_[2] = {k0 + gi, k0 + gi + 8};  // this lane's keys
  bf16* gw = gbuf + warp * 2 * 16 * LD;
  float* dw = ddbuf + warp * 2 * 16;
  const bool one_chunk = T <= CHUNK;

  cp_rows<D>(kb, k + rbase, k0, 16, T, threadIdx.x, THREADS);
  cp_rows<D>(vb, v + rbase, k0, 16, T, threadIdx.x, THREADS);
  cp_commit();
  float mk[2];  // the key mask's entries (0 with a full bias, read per query)
#pragma unroll
  for (int h = 0; h < 2; ++h) mk[h] = (!FULL && brow && keys_[h] < T) ? brow[keys_[h]] : 0.f;

  for (int grp = grp0; grp < grp1; ++grp) {
    const int c = grp * ROWS + warp;
    const bool active = c < V;
    const long long n = res + (long long)BH * c;
    const bf16* gn = g + n * T * D;
    const float* ddn = dd + n * T;
    float acc_k[ND][4], acc_v[ND][4];  // keys g, g + 8 x columns nd * 8 + 2t, + 1
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc_k[nd][cc] = acc_v[nd][cc] = 0.f;

    for (int qq0 = 0; qq0 < T; qq0 += CHUNK) {
      const int nt = min(CHUNK, (T - qq0 + 15) & ~15) / 8;  // 8-query tiles, even
      if (active) cp_g_dd<D>(gw, dw, gn, ddn, qq0, T, lane);  // the first 16 queries
      if (grp == grp0 || !one_chunk) {
        if (grp > grp0 || qq0 > 0) __syncthreads();
        cp_rows<D>(qs, q + rbase, qq0, nt * 8, T, threadIdx.x, THREADS);
        cp_commit();
        for (int i = threadIdx.x; i < nt * 8; i += THREADS)
          lses[i] = qq0 + i < T ? lse[(long long)res * T + qq0 + i] : 0.f;
        cp_wait<0>();
        __syncthreads();
        // p^T of the block's 16 keys and the chunk's queries, once for the run
        uint32_t ka[KS][4];
        load_a<D>(ka, kb, lane);
        for (int j = warp; j < nt; j += ROWS) {
          float s[4];
          tile_abt<D, false>(s, ka, qs + j * 8 * LD, lane);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int qc = j * 8 + 2 * t + (cc & 1);
            const int key = keys_[cc >> 1];
            float p = 0.f;
            if (qq0 + qc < T && key < T) {
              const float b = FULL ? brow[(long long)(qq0 + qc) * T + key] : mk[cc >> 1];
              p = expf(s[cc] * scale + b - lses[qc]);
            }
            pts[(gi + 8 * (cc >> 1)) * LDP + qc] = p;
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      // 16 queries (one k16 step) per buffer; the next 16 arrive meanwhile
      for (int st16 = 0; st16 < nt / 2; ++st16) {
        const int b = st16 & 1;
        if (st16 + 1 < nt / 2) {
          cp_g_dd<D>(gw + (b ^ 1) * 16 * LD, dw + (b ^ 1) * 16, gn, ddn, qq0 + (st16 + 1) * 16, T,
                     lane);
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncwarp();
        const bf16* gb = gw + b * 16 * LD;
        // dP^T = v.g^T for the two 8-query tiles
        uint32_t va[KS][4];
        load_a<D>(va, vb, lane);
        float dp[2][4];
        tile_abt<D, false>(dp[0], va, gb, lane);
        tile_abt<D, false>(dp[1], va, gb + 8 * LD, lane);
        // p^T and ds^T = p^T * (dP^T - dd) as the A fragments of the step:
        // keys g, g + 8 x queries 2t, + 1 (a0, a1) and 8 + 2t, + 1 (a2, a3)
        uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the query tile
          const int qc = st16 * 16 + 8 * h + 2 * t;
          const float2 ddq = *reinterpret_cast<const float2*>(dw + b * 16 + 8 * h + 2 * t);
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // key g + 8r
            const float2 p = *reinterpret_cast<const float2*>(pts + (gi + 8 * r) * LDP + qc);
            split_bf16(p.x, p.y, ph[2 * h + r], pl[2 * h + r]);
            split_bf16(p.x * (dp[h][2 * r] - ddq.x), p.y * (dp[h][2 * r + 1] - ddq.y),
                       dh[2 * h + r], dl[2 * h + r]);
          }
        }
        // dv += p^T.g and dk += ds^T.q over these 16 queries
        step_split<D>(acc_v, ph, pl, gb, lane);
        step_split<D>(acc_k, dh, dl, qs + st16 * 16 * LD, lane);
        __syncwarp();  // the buffer is refilled two steps on
      }
    }
    if (active) {
      store_tile<D>(dk + n * T * D, acc_k, k0, T, scale, lane);
      store_tile<D>(dv + n * T * D, acc_v, k0, T, 1.f, lane);
    }
  }
}

// ------------------------------------------------------------------ launchers

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes, prefer shared
// memory over L1, and count the blocks the card holds at once: `slots` =
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) x SMs.
template <typename Kernel>
int prepare(Kernel kernel, int smem, int* per_sm, int* slots) {
  int dev = 0, sms = 0;
  cudaError_t err = (cudaError_t)prepare_kernel(kernel, smem, THREADS, smem, per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) *slots = *per_sm * sms;
  return (int)err;
}

// K3 (K3b): one block per (residual row, 16 query rows, run of G groups)
template <int D, bool FULL>
int dq_launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const float* lse,
              const bf16* g, const float* bias, bf16* dq, float* dd, float* dbias, int N, int BH,
              int T, int H, float scale, cudaStream_t stream) {
  const int V = N / BH, groups = (V + ROWS - 1) / ROWS, tiles = (T + 15) / 16;
  constexpr int smem = dq_smem_bytes<D>(FULL);
  static int per_sm = 0, slots = 0;
  if (slots == 0) {
    const int err = prepare(flash_dq_bf16_kernel<D, FULL>, smem, &per_sm, &slots);
    if (err) return err;
  }
  const int G = groups_per_block(BH * tiles, groups, slots);
  dim3 grid(BH, tiles, (groups + G - 1) / G);
  flash_dq_bf16_kernel<D, FULL><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, g, bias, dq, dd, dbias, T, H, BH, V, G, scale);
  return (int)cudaGetLastError();
}

// K4 (K4f): one block per (residual row, 16 key rows, run of G groups)
template <int D, bool FULL>
int dkv_launch(const bf16* q, const bf16* k, const bf16* v, const float* lse, const bf16* g,
               const float* dd, const float* bias, bf16* dk, bf16* dv, int N, int BH, int T,
               int H, float scale, cudaStream_t stream) {
  const int V = N / BH, groups = (V + ROWS - 1) / ROWS, tiles = (T + 15) / 16;
  constexpr int smem = dkv_smem_bytes<D>();
  static int per_sm = 0, slots = 0;
  if (slots == 0) {
    const int err = prepare(flash_dkv_bf16_kernel<D, FULL>, smem, &per_sm, &slots);
    if (err) return err;
  }
  const int G = groups_per_block(BH * tiles, groups, slots);
  dim3 grid(BH, tiles, (groups + G - 1) / G);
  flash_dkv_bf16_kernel<D, FULL><<<grid, THREADS, smem, stream>>>(
      q, k, v, lse, g, dd, bias, dk, dv, T, H, BH, V, G, scale);
  return (int)cudaGetLastError();
}

template <bool FULL>
int dq(const void* q, const void* k, const void* v, const void* o, const float* lse,
       const void* g, const float* bias, void* dq_, float* dd, float* dbias, int N, int BH, int T,
       int D, int H, float scale, void* stream) {
  if (N < 1 || BH < 1 || N % BH != 0 || T < 1) return (int)cudaErrorInvalidValue;
  if (FULL && (bias == nullptr || dbias == nullptr)) return (int)cudaErrorInvalidValue;
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return dq_launch<64, FULL>(in(q), in(k), in(v), in(o), lse, in(g), bias,
                               static_cast<bf16*>(dq_), dd, dbias, N, BH, T, H, scale, st);
  if (D == 32)
    return dq_launch<32, FULL>(in(q), in(k), in(v), in(o), lse, in(g), bias,
                               static_cast<bf16*>(dq_), dd, dbias, N, BH, T, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <bool FULL>
int dkv(const void* q, const void* k, const void* v, const float* lse, const void* g,
        const float* dd, const float* bias, void* dk, void* dv, int N, int BH, int T, int D,
        int H, float scale, void* stream) {
  if (N < 1 || BH < 1 || N % BH != 0 || T < 1 || (FULL && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return dkv_launch<64, FULL>(in(q), in(k), in(v), lse, in(g), dd, bias,
                                static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, BH, T, H,
                                scale, st);
  if (D == 32)
    return dkv_launch<32, FULL>(in(q), in(k), in(v), lse, in(g), dd, bias,
                                static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, BH, T, H,
                                scale, st);
  return (int)cudaErrorInvalidValue;
}

// `kernel_info` of one kernel after `prepare`.
template <typename Kernel>
int bwd_info(Kernel kernel, int smem, int* info) {
  int per_sm = 0, slots = 0;
  const int err = prepare(kernel, smem, &per_sm, &slots);
  return err ? err : kernel_info(kernel, smem, per_sm, info);
}

template <int D>
int info_of(int kernel, int* info) {
  switch (kernel) {
    case 0: return bwd_info(flash_dq_bf16_kernel<D, false>, dq_smem_bytes<D>(false), info);
    case 1: return bwd_info(flash_dq_bf16_kernel<D, true>, dq_smem_bytes<D>(true), info);
    case 2: return bwd_info(flash_dkv_bf16_kernel<D, false>, dkv_smem_bytes<D>(), info);
    case 3: return bwd_info(flash_dkv_bf16_kernel<D, true>, dkv_smem_bytes<D>(), info);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry point returns the CUDA error of its launch (0 on success). q, k,
// v, o, g, dq, dk, dv are __nv_bfloat16 (passed as void*); lse, dd, the bias
// (null or a [B, T] key mask; a [BH, T, T] full score bias for the *_bias /
// *_dbias entry points) and d(bias) float32. D must be 32 or 64.

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v, const void* o,
                             const float* lse, const void* g, const float* bias, void* dq_,
                             float* dd, int N, int BH, int T, int D, int H, float scale,
                             void* stream) {
  return dq<false>(q, k, v, o, lse, g, bias, dq_, dd, nullptr, N, BH, T, D, H, scale, stream);
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v, const float* lse,
                              const void* g, const float* dd, const float* bias, void* dk,
                              void* dv, int N, int BH, int T, int D, int H, float scale,
                              void* stream) {
  return dkv<false>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, D, H, scale, stream);
}

extern "C" int flash_dq_dbias_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const float* lse, const void* g,
                                   const float* bias, void* dq_, float* dd, float* dbias,
                                   int N, int BH, int T, int D, int H, float scale,
                                   void* stream) {
  return dq<true>(q, k, v, o, lse, g, bias, dq_, dd, dbias, N, BH, T, D, H, scale, stream);
}

extern "C" int flash_dkv_bias_bf16(const void* q, const void* k, const void* v,
                                   const float* lse, const void* g, const float* dd,
                                   const float* bias, void* dk, void* dv, int N, int BH,
                                   int T, int D, int H, float scale, void* stream) {
  return dkv<true>(q, k, v, lse, g, dd, bias, dk, dv, N, BH, T, D, H, scale, stream);
}

// Registers, spilled bytes, shared bytes and blocks per SM (`info`, 4 ints)
// of kernel 0 (K3), 1 (K3b), 2 (K4) or 3 (K4f) at head dim D.
extern "C" int flash_bwd_bf16_info(int kernel, int D, int* info) {
  if (D == 64) return info_of<64>(kernel, info);
  if (D == 32) return info_of<32>(kernel, info);
  return (int)cudaErrorInvalidValue;
}
