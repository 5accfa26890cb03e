// The PPO loss head and its gradient for Hopper: two kernels over the rows
// of a minibatch.
//
// Replaces no TPU kernel.  The JAX package leaves the head to XLA, which
// fuses it with the rest of the jitted update; torch runs the same head as
// separate operations on (rows,) tensors, about 160-175 kernels forward and
// 225 in autograd's backward, each moving a few tens of kilobytes.  Plain
// version: ops/ppo_head.py:ppo_head_plain (forward) and head_backward_plain.
//
// - ppo_head_forward_kernel: one thread per row.  It reads the row's
//   logits and behaviour logits (2K + 2 each), its K key actions, its yaw
//   action, behaviour log-probability, advantage, old value and value
//   target, the value tower's output, and its member's KL and entropy
//   coefficients; it writes the row's total, policy loss (the negated
//   surrogate), KL, value loss and entropy, and the unit gradient of the
//   total (upstream gradient 1) with respect to the row's logits and value
//   (2K + 3 floats).
// - ppo_head_backward_kernel: one thread per element of the unit
//   gradient, times the upstream gradient of its row's total.
//
// What bounds them: bytes and the launch.  A row reads 116 B (K = 4) and
// writes 64 B forward; the backward reads 48 B and writes 44 B a row.  At
// the shapes the training cells run (8,192 rows; 4 x 128) that is at most
// 1.5 MB, under half a microsecond at HBM's rate, so a launch's fixed cost
// sets their time.  What the design does about it: the whole head is one
// launch forward and one backward, in place of some 390; one thread keeps
// a row in registers; the backward's threads read and write neighbouring
// addresses.
//
// Numerics.  Every operation mirrors one of torch's kernels in the head
// that ops/ppo_head.py's docstring names, in the same order, so that the
// forward terms equal torch's on the card to the bit:
//
// - the library is built with -fmad=false, so no product and sum are fused
//   unless written so; torch's contracted multiply-adds on this path, in its
//   log_softmax backward (grad - exp(output) * sum) and in ndtri, are
//   __fmaf_rn;
// - log_softmax of two values follows torch's warp kernel
//   (PersistentSoftmax.cuh): each lane's max of its value and its
//   neighbour's (a < b ? b : a), exp of the differences summed, log, then
//   (x - max) - log;
// - the yaw action is unsquashed as torch does it, SQUASH_SCALE *
//   ndtri((yaw - low) / (high - low)), with torch's ndtri (ndtri.cuh);
// - a product by a Python scalar uses the scalar as torch casts it to
//   float; a division by one is a product by the float reciprocal
//   (torch's div_true_kernel_cuda), which the wrapper computes;
// - torch.clamp, torch.minimum and torch.maximum are fminf / fmaxf with
//   NaN passed through; expf, logf and sqrtf are the CUDA library's, which
//   torch calls too (scripts/torch_decode_math_check.py holds logf, expf
//   and ndtri to torch's on every float32).
//
// The device functions that mirror torch's kernels (the clamps, the
// two-value log_softmax and its backward) sit in torch_math.cuh, which the
// env kernels' decoded forms share.
//
// The unit gradient follows autograd's backward formulas (FunctionsManual,
// derivatives.yaml): maximum and minimum halve the gradient on a tie,
// clamp passes it at its bounds, x^2 is grad * (2 * x), a / b gives
// grad / b and -grad * ((a / b) / b).  Where several uses of a tensor
// meet, autograd adds their gradients in the order its engine runs their
// nodes, the node made last first: per key the entropy's log_softmax, then
// the KL's, then the log-probability's; the yaw mean's three clamps and
// log_std's five likewise, entropy first.  Each mean over the rows hands a
// row scale / rows, a power of two at the shapes ops/ppo_head.py takes,
// so the row's unit gradient times it is autograd's gradient to the bit.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "torch_math.cuh"

namespace {

constexpr int kThreads = 128;

struct HeadParams {
  float ratio_lo;          // 1 - clip_param, as float
  float ratio_hi;          // 1 + clip_param
  float vf_clip_lo;        // -vf_clip_param
  float vf_clip_hi;        // vf_clip_param
  float vf_loss_coeff;
  float half_log_2pi;      // 0.5 * log(2 pi)
  float squash_scale;      // SQUASH_SCALE
  float log_span;          // log(high - low)
  float log_squash_scale;  // log(SQUASH_SCALE), in double, as float
  float inv_ent_den;       // 1 / float(2 * SQUASH_SCALE ** 2), in float
  float mean_lo;           // -MAX_ABS_MEAN
  float mean_hi;           // MAX_ABS_MEAN
  float log_std_lo;        // MIN_LOG_NN_OUTPUT
  float log_std_hi;        // MAX_LOG_NN_OUTPUT
  float yaw_low;           // low = -action_range
  float inv_yaw_span;      // 1 / float(high - low), in float
  float entropy_coeff;     // every member's, where no table is given
};
constexpr int kNumHeadParams = 17;
static_assert(sizeof(HeadParams) == kNumHeadParams * sizeof(float),
              "HeadParams must hold the float array");

struct HeadIn {
  const float* logits;          // (n, 2K + 2)
  const float* value;           // (n,)
  const float* blogits;         // (n, 2K + 2)
  const int32_t* key_actions;   // (n, K)
  const float* yaw_actions;     // (n,)
  const float* blogp;           // (n,)
  const float* advantage;       // (n,)
  const float* old_value;       // (n,)
  const float* value_target;    // (n,)
  const float* kl_coeff;        // (P,)
  const float* entropy_coeff;   // (P,) or null
};

struct HeadOut {
  float* row_total;    // (n,)
  float* policy_loss;  // (n,), -surrogate
  float* kl;           // (n,)
  float* vf_loss;      // (n,)
  float* entropy;      // (n,)
  float* grad;         // (n, 2K + 3)
};

template <int K>
__global__ void __launch_bounds__(kThreads)
    ppo_head_forward_kernel(HeadIn in, HeadOut out, int n,
                            int rows_per_member, HeadParams p) {
  constexpr int L = 2 * K + 2;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int member = r / rows_per_member;
  const float* x = in.logits + (size_t)r * L;
  const float* b = in.blogits + (size_t)r * L;
  const float kc = in.kl_coeff[member];
  const float ec = in.entropy_coeff ? in.entropy_coeff[member]
                                    : p.entropy_coeff;

  // The keys.  Python's sum starts from 0.
  float o[K][2], e[K][2], eb[K][2];
  bool first[K];
  float logp = 0.0f, ent = 0.0f, kl = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float b0, b1;
    log_softmax2(x[2 * i], x[2 * i + 1], o[i][0], o[i][1]);
    log_softmax2(b[2 * i], b[2 * i + 1], b0, b1);
    first[i] = in.key_actions[(size_t)r * K + i] == 0;
    e[i][0] = expf(o[i][0]);
    e[i][1] = expf(o[i][1]);
    eb[i][0] = expf(b0);
    eb[i][1] = expf(b1);
    const float h = -(e[i][0] * o[i][0] + e[i][1] * o[i][1]);
    const float d = eb[i][0] * (b0 - o[i][0]) + eb[i][1] * (b1 - o[i][1]);
    logp = logp + (first[i] ? o[i][0] : o[i][1]);
    ent = ent + h;
    kl = kl + d;
  }

  // The yaw.
  const float mean_raw = x[2 * K], log_std_raw = x[2 * K + 1];
  const float mean = clamp_like_torch(mean_raw, p.mean_lo, p.mean_hi);
  const float log_std =
      clamp_like_torch(log_std_raw, p.log_std_lo, p.log_std_hi);
  const float stdv = expf(log_std);
  const float b_mean = clamp_like_torch(b[2 * K], p.mean_lo, p.mean_hi);
  const float b_log_std =
      clamp_like_torch(b[2 * K + 1], p.log_std_lo, p.log_std_hi);
  const float b_std = expf(b_log_std);
  // unsquash: SQUASH_SCALE * ndtri((yaw - low) / (high - low))
  const float u =
      ndtri_like_torch((in.yaw_actions[r] - p.yaw_low) * p.inv_yaw_span) *
      p.squash_scale;
  const float num = u - mean;
  const float dev = num / stdv;
  const float y_logp = (-logf(stdv) - p.half_log_2pi) - 0.5f * (dev * dev);
  const float scale = p.squash_scale;
  const float dev0 = (u - 0.0f) / scale;
  const float squash_grad =
      ((-logf(scale) - p.half_log_2pi) - 0.5f * (dev0 * dev0)) + p.log_span;
  logp = logp + (y_logp - squash_grad);
  const float dm = b_mean - mean;
  const float kl_num = b_std * b_std + dm * dm;
  const float kl_den = 2.0f * (stdv * stdv);
  const float kl_frac = kl_num / kl_den;
  kl = kl + (((log_std - b_log_std) + kl_frac) - 0.5f);
  const float ent_x = (stdv * stdv + mean * mean) * p.inv_ent_den;
  ent = ent +
        (p.log_span - (((p.log_squash_scale - log_std) + ent_x) - 0.5f));

  // The clipped surrogate, the clipped value loss, the row's total.
  const float adv = in.advantage[r];
  const float ratio = expf(logp - in.blogp[r]);
  const float p1 = adv * ratio;
  const float p2 = adv * clamp_like_torch(ratio, p.ratio_lo, p.ratio_hi);
  const float surrogate = minimum_like_torch(p1, p2);
  const float value = in.value[r], vt = in.value_target[r];
  const float bv = in.old_value[r];
  const float d1 = value - vt;
  const float l1 = d1 * d1;
  const float dv = value - bv;
  const float d2 = (bv + clamp_like_torch(dv, p.vf_clip_lo, p.vf_clip_hi)) - vt;
  const float l2 = d2 * d2;
  const float vf_loss = maximum_like_torch(l1, l2);
  const float total =
      ((-surrogate + kc * kl) + p.vf_loss_coeff * vf_loss) - ec * ent;
  out.row_total[r] = total;
  out.policy_loss[r] = -surrogate;
  out.kl[r] = kl;
  out.vf_loss[r] = vf_loss;
  out.entropy[r] = ent;

  // The unit gradient.  Upstream: -1 to the surrogate, kc to the KL,
  // vf_loss_coeff to the value loss, -ec to the entropy.
  const float g_kl = kc;
  const float g_ent = -ec;
  const float g_s = -1.0f;
  const float g_half = p1 == p2 ? g_s * 0.5f : g_s;
  const float g1 = p1 > p2 ? 0.0f : g_half;
  const float g2 = p1 < p2 ? 0.0f : g_half;
  const float d_ratio =
      g1 * adv + pass_in(g2 * adv, ratio, p.ratio_lo, p.ratio_hi);
  const float d_logp = d_ratio * ratio;

  float* g = out.grad + (size_t)r * (L + 1);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    // entropy: -sum(exp(o) * o)
    const float dt = -g_ent;
    const float ge0 = dt * e[i][0] + (dt * o[i][0]) * e[i][0];
    const float ge1 = dt * e[i][1] + (dt * o[i][1]) * e[i][1];
    float ce0, ce1, ck0, ck1, cp0, cp1;
    log_softmax2_backward(o[i][0], o[i][1], ge0, ge1, ce0, ce1);
    // KL: sum(exp(b) * (b - o))
    log_softmax2_backward(o[i][0], o[i][1], -(g_kl * eb[i][0]),
                          -(g_kl * eb[i][1]), ck0, ck1);
    // log-probability: o[a]
    log_softmax2_backward(o[i][0], o[i][1], first[i] ? d_logp : 0.0f,
                          first[i] ? 0.0f : d_logp, cp0, cp1);
    g[2 * i] = (ce0 + ck0) + cp0;
    g[2 * i + 1] = (ce1 + ck1) + cp1;
  }

  // entropy: log_std's clamp (L5), std's (L4), mean's (M3)
  const float d_inner = -g_ent;
  const float c_l5 = -d_inner;
  const float d_y = d_inner * p.inv_ent_den;
  const float c_m3 = d_y * (2.0f * mean);
  const float c_l4 = (d_y * (2.0f * stdv)) * stdv;
  // KL: other.log_std (L3), o_std (L2), o_mean (M2)
  const float c_l3 = g_kl;
  const float d_num = g_kl / kl_den;
  const float d_den = -g_kl * (kl_frac / kl_den);
  const float c_m2 = -(d_num * (2.0f * dm));
  const float c_l2 = ((d_den * 2.0f) * (2.0f * stdv)) * stdv;
  // log-probability: self.mean (M1), self.std (L1)
  const float d_dev = (-d_logp * 0.5f) * (2.0f * dev);
  const float c_m1 = -(d_dev / stdv);
  const float d_std = (-d_dev) * (dev / stdv) + (-d_logp) / stdv;
  const float c_l1 = d_std * stdv;
  const float ml = p.mean_lo, mh = p.mean_hi;
  const float sl = p.log_std_lo, sh = p.log_std_hi;
  g[2 * K] = (pass_in(c_m3, mean_raw, ml, mh) + pass_in(c_m2, mean_raw, ml, mh))
             + pass_in(c_m1, mean_raw, ml, mh);
  g[2 * K + 1] = (((pass_in(c_l5, log_std_raw, sl, sh) +
                    pass_in(c_l4, log_std_raw, sl, sh)) +
                   pass_in(c_l3, log_std_raw, sl, sh)) +
                  pass_in(c_l2, log_std_raw, sl, sh)) +
                 pass_in(c_l1, log_std_raw, sl, sh);

  // value: max(l1, l2), half the gradient each on a tie
  const float g_vf = p.vf_loss_coeff;
  const float v_half = l1 == l2 ? g_vf * 0.5f : g_vf;
  const float gl1 = l1 < l2 ? 0.0f : v_half;
  const float gl2 = l1 > l2 ? 0.0f : v_half;
  g[L] = gl1 * (2.0f * d1) +
         pass_in(gl2 * (2.0f * d2), dv, p.vf_clip_lo, p.vf_clip_hi);
}

__global__ void __launch_bounds__(kThreads)
    ppo_head_backward_kernel(const float* __restrict__ grad_row,
                             const float* __restrict__ grad,
                             float* __restrict__ d_logits,
                             float* __restrict__ d_value, int n, int width) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * width) return;
  const int r = (int)(i / width);
  const int j = (int)(i - (long long)r * width);
  const float v = grad_row[r] * grad[i];
  if (j < width - 1) {
    d_logits[(size_t)r * (width - 1) + j] = v;
  } else {
    d_value[r] = v;
  }
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// The forward kernel on n rows, P = n / rows_per_member members' of
// rows_per_member each; `entropy_coeff` null takes fparams' scalar for
// every member.  `fparams`: the 17 floats of HeadParams.
extern "C" int q1_ppo_head_forward(
    const float* logits, const float* value, const float* blogits,
    const int32_t* key_actions, const float* yaw_actions, const float* blogp,
    const float* advantage, const float* old_value, const float* value_target,
    const float* kl_coeff, const float* entropy_coeff, float* row_total,
    float* policy_loss, float* kl, float* vf_loss, float* entropy, float* grad,
    int n, int rows_per_member, int k, const float* fparams, void* stream) {
  if (n < 0 || rows_per_member < 1 || (k != 3 && k != 4))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  HeadParams p;
  std::memcpy(&p, fparams, sizeof(p));
  const HeadIn in{logits,      value,     blogits,      key_actions,
                  yaw_actions, blogp,     advantage,    old_value,
                  value_target, kl_coeff, entropy_coeff};
  const HeadOut out{row_total, policy_loss, kl, vf_loss, entropy, grad};
  auto kernel = k == 3 ? ppo_head_forward_kernel<3> : ppo_head_forward_kernel<4>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      in, out, n, rows_per_member, p);
  return (int)cudaGetLastError();
}

// The backward kernel: d_logits (n, width - 1) and d_value (n,) from the
// upstream gradient (n,) and the unit gradient (n, width).
extern "C" int q1_ppo_head_backward(const float* grad_row, const float* grad,
                                    float* d_logits, float* d_value, int n,
                                    int width, void* stream) {
  if (n < 0 || width < 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ppo_head_backward_kernel<<<blocks_for((long long)n * width), kThreads, 0,
                             (cudaStream_t)stream>>>(grad_row, grad, d_logits,
                                                     d_value, n, width);
  return (int)cudaGetLastError();
}
