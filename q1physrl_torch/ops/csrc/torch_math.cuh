// Device functions that give torch's bits on the card, shared by the
// kernels that stand in for torch operations: the PPO loss head
// (ppo_head.cu) and the decoded forms of the env kernels (env_rollout.cu).
//
// Each mirrors one of torch's CUDA kernels.  The libraries are built with
// -fmad=false, so a product and a sum are fused only where written so
// (__fmaf_rn), as torch's kernel contracts them.
#pragma once

#include <math.h>

#include "ndtri.cuh"

// torch.clamp(v, lo, hi) on the card: NaN passes through.
__device__ __forceinline__ float clamp_like_torch(float v, float lo,
                                                  float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum / torch.maximum on the card: NaN wins.
__device__ __forceinline__ float minimum_like_torch(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float maximum_like_torch(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// clamp's backward: the gradient where lo <= x <= hi, else 0.
__device__ __forceinline__ float pass_in(float g, float x, float lo,
                                         float hi) {
  return (x >= lo && x <= hi) ? g : 0.0f;
}

// log_softmax of (x0, x1) as torch's warp kernel: lane j's max is
// r(x_j, x_other) with r(a, b) = a < b ? b : a.
__device__ __forceinline__ void log_softmax2(float x0, float x1, float& o0,
                                             float& o1) {
  const float m0 = x0 < x1 ? x1 : x0;
  const float m1 = x1 < x0 ? x0 : x1;
  const float lse = logf(expf(x0 - m0) + expf(x1 - m1));
  o0 = (x0 - m0) - lse;
  o1 = (x1 - m1) - lse;
}

// Its backward: g - exp(o) * (g0 + g1), contracted as torch's is.
__device__ __forceinline__ void log_softmax2_backward(float o0, float o1,
                                                      float g0, float g1,
                                                      float& c0, float& c1) {
  const float s = g0 + g1;
  c0 = __fmaf_rn(-expf(o0), s, g0);
  c1 = __fmaf_rn(-expf(o1), s, g1);
}
