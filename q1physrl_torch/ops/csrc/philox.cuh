// Philox4x32-10 counter-based generator (Salmon et al., SC'11), as a device
// function, and the 24-bit uniforms the rollout kernels take from its words.
//
// Its plain version is q1physrl_torch/ops/env_rollout.py:philox4x32_10,
// which builds each 32x32->64-bit product from 16-bit halves; chip_smoke.py
// holds this function against that one and against curand's
// curand_Philox4x32_10 (csrc/philox_check.cu) on the card.
//
// What it costs on Hopper: with the key (seed, 0) and a counter whose first
// word is loop-invariant, nvcc folds the first round and the second key
// word's bumps, and one call in rollout_random_kernel's T loop issues 39
// instructions: 19 products (18 IMAD.WIDE.U32, each a 32x32->64-bit
// product, and one IMAD.HI.U32), 19 three-input LOP3 xors and a constant
// load; the key bumps depend on the seed alone and leave the loop
// (scripts/torch_sass_mix.py).  The integer pipe takes them
// at 64 per clock per SM, half the float32 rate.  So that kernel draws one
// call's four words for several frames.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace q1 {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // key bumps (golden ratio)
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;  // sqrt(3) - 1

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The top 24 bits of an unsigned word as a float32 in [0, 1).  The bits are
// unsigned: an arithmetic shift of a signed word would leave half the draws
// negative.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return (float)((bits >> 8) & 0xFFFFFFu) * 5.9604644775390625e-8f;  // 2^-24
}

// A fifth uniform from the low bytes of three words whose top 24 bits went
// to uniform_from_bits: (a & 0xFF) << 16 | (b & 0xFF) << 8 | (c & 0xFF),
// times 2^-24, exact in float32.
__device__ __forceinline__ float uniform_from_low_bytes(uint32_t a,
                                                        uint32_t b,
                                                        uint32_t c) {
  const uint32_t bits =
      ((a & 0xFFu) << 16) | ((b & 0xFFu) << 8) | (c & 0xFFu);
  return (float)bits * 5.9604644775390625e-8f;
}

}  // namespace q1
