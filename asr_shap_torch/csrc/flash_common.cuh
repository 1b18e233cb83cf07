// Helpers of the flash attention kernels shared by flash_attention.cu and
// flash_bwd_bf16.cu.

#pragma once

#include <cuda_runtime.h>

namespace {

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

}  // namespace
