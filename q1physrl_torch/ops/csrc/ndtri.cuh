// torch.special.ndtri on the card, to the bit.
//
// torch computes ndtri with a jiterated kernel (ATen/native/cuda/Math.cuh,
// ndtri_string: Cephes' ndtri in float), which NVRTC compiles with
// multiply-adds contracted.  This is the same code with each contraction
// written as __fmaf_rn, for a library built with -fmad=false: Horner's
// steps of polevl, and y + y * (...) of the central interval.
// scripts/torch_decode_math_check.py holds it to torch.special.ndtri on
// every float32.
#pragma once

#include <math.h>

namespace ndtri_detail {

// Cephes' polevl as Math.cuh writes it: `len` coefficients, from 0.
__device__ __forceinline__ float polevl(float x, const float* a, int len) {
  float result = 0.0f;
  for (int i = 0; i < len; ++i) result = __fmaf_rn(result, x, a[i]);
  return result;
}

}  // namespace ndtri_detail

__device__ __forceinline__ float ndtri_like_torch(float y0) {
  using ndtri_detail::polevl;
  const float zero = 0.0f, one = 1.0f;
  if (y0 == zero) return -INFINITY;
  if (y0 == one) return INFINITY;
  if (y0 < zero || y0 > one) return NAN;
  bool code = true;
  float y = y0;
  // 0.135... is exp(-2)
  if (y > one - 0.13533528323661269189f) {
    y = one - y;
    code = false;
  }
  if (y > 0.13533528323661269189f) {
    // approximation for 0 <= |y - 0.5| <= 3/8
    const float p0[5] = {-5.99633501014107895267E1f, 9.80010754185999661536E1f,
                         -5.66762857469070293439E1f, 1.39312609387279679503E1f,
                         -1.23916583867381258016E0f};
    const float q0[9] = {1.00000000000000000000E0f,  1.95448858338141759834E0f,
                         4.67627912898881538453E0f,  8.63602421390890590575E1f,
                         -2.25462687854119370527E2f, 2.00260212380060660359E2f,
                         -8.20372256168333339912E1f, 1.59056225126211695515E1f,
                         -1.18331621121330003142E0f};
    const float s2pi = 2.50662827463100050242E0f;  // sqrt(2 pi)
    y = y - 0.5f;
    const float y2 = y * y;
    const float x = __fmaf_rn(y, y2 * polevl(y2, p0, 5) / polevl(y2, q0, 9), y);
    return x * s2pi;
  }
  float x = sqrtf(-2.0f * logf(y));
  const float x0 = x - (logf(x) / x);
  const float z = one / x;
  float x1;
  if (x < 8.0f) {
    // y between exp(-2) and exp(-32)
    const float p1[9] = {4.05544892305962419923E0f,   3.15251094599893866154E1f,
                         5.71628192246421288162E1f,   4.40805073893200834700E1f,
                         1.46849561928858024014E1f,   2.18663306850790267539E0f,
                         -1.40256079171354495875E-1f, -3.50424626827848203418E-2f,
                         -8.57456785154685413611E-4f};
    const float q1[9] = {1.00000000000000000000E0f,   1.57799883256466749731E1f,
                         4.53907635128879210584E1f,   4.13172038254672030440E1f,
                         1.50425385692907503408E1f,   2.50464946208309415979E0f,
                         -1.42182922854787788574E-1f, -3.80806407691578277194E-2f,
                         -9.33259480895457427372E-4f};
    x1 = z * polevl(z, p1, 9) / polevl(z, q1, 9);
  } else {
    // y between exp(-32) and exp(-2048)
    const float p2[9] = {3.23774891776946035970E0f,  6.91522889068984211695E0f,
                         3.93881025292474443415E0f,  1.33303460815807542389E0f,
                         2.01485389549179081538E-1f, 1.23716634817820021358E-2f,
                         3.01581553508235416007E-4f, 2.65806974686737550832E-6f,
                         6.23974539184983293730E-9f};
    const float q2[9] = {1.00000000000000000000E0f,  6.02427039364742014255E0f,
                         3.67983563856160859403E0f,  1.37702099489081330271E0f,
                         2.16236993594496635890E-1f, 1.34204006088543189037E-2f,
                         3.28014464682127739104E-4f, 2.89247864745380683936E-6f,
                         6.79019408009981274425E-9f};
    x1 = z * polevl(z, p2, 9) / polevl(z, q2, 9);
  }
  x = x0 - x1;
  return code ? -x : x;
}
