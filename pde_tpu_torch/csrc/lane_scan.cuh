// The lane-group affine scan of the shared-memory routes of K1
// (adi_fused_batched.cu) and K2 (adi_fused.cu).  With its factors known, a
// tridiagonal sweep's forward pass d_i = (R_i - l_i d_{i-1}) inv_i and back
// substitution y_i = d_i - c_i y_{i+1} are affine recurrences
// x_i = A_i x_{i-1} + B_i, and affine maps compose associatively: each lane
// of a group composes its chunk of the line into one map x -> P x + Q, this
// scan gives it the value entering its chunk, and the lane walks the chunk
// again with the sequential arithmetic.
#pragma once

#include <cuda_runtime.h>

// Value entering this lane's chunk of a line split over the g lanes of a
// group (g a power of two, groups aligned within the warp): an inclusive
// scan of the chunks' affine maps x -> P x + Q, in lane order (forward) or
// in reverse, applied to 0 and taken from the neighbouring lane.  Every
// lane of the warp must call it.
__device__ __forceinline__ float scan_entry(float P, float Q, int g, int lane,
                                            bool reverse) {
  constexpr unsigned kFull = 0xffffffffu;
  for (int off = 1; off < g; off <<= 1) {
    const float Pn = reverse ? __shfl_down_sync(kFull, P, off, g)
                             : __shfl_up_sync(kFull, P, off, g);
    const float Qn = reverse ? __shfl_down_sync(kFull, Q, off, g)
                             : __shfl_up_sync(kFull, Q, off, g);
    if (reverse ? lane + off < g : lane >= off) {
      Q = P * Qn + Q;
      P = P * Pn;
    }
  }
  const float x = reverse ? __shfl_down_sync(kFull, Q, 1, g)
                          : __shfl_up_sync(kFull, Q, 1, g);
  return (reverse ? lane + 1 < g : lane >= 1) ? x : 0.f;
}
