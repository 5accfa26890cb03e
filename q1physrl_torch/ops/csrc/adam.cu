// Adam's step for Hopper: up to 56 leaves of all members in one launch.
//
// Replaces no TPU kernel.  The JAX package leaves its optimizer to XLA,
// which fuses the update into the jitted step; torch runs it as separate
// operations: a solo run's step (algo/ppo.py:adam_update) is 14
// multi-tensor (_foreach) launches over its 12 leaves, a population's
// (algo/population.py:adam_step) about 15 elementwise kernels on the
// stacked (P, D) tensors, after a copy of its gradients into one buffer.
// Plain version: ops/adam.py:adam_plain.
//
// - adam_kernel: each block takes kChunk elements of one segment (one leaf
//   of one member: its parameters p, gradient g and moments m and v), each
//   thread kVec neighbouring elements.  A segment's blocks follow one
//   another in the grid; a block finds its segment by a binary search over
//   the segments' first blocks, in the kernel's parameters.
//
// What bounds it: bytes and the launch.  A step reads p, g, m and v and
// writes p, m and v: 28 B an element, 3,863,860 B for a solo run's
// 137,995 parameters and 15,455,440 B for four members, 1.2 and 4.6 us at
// HBM's rate; a launch costs a few microseconds, and the composed steps
// took 0.12 ms (solo) and 0.05 ms (stacked) on an H100 replayed from a
// graph, each operation a pass over every element.  What the design does
// about it: one launch a step (two past 56 segments), one pass; blocks of
// kChunk elements, so that a solo step (142 blocks) fills the 132 SMs and a
// population's (about 570) stays resident at once; 16-byte loads and stores where the leaf's
// addresses allow; the gradient read where autograd left it, through its
// strides (a stacked tower's weight gradient is the transpose of baddbmm's
// product), so no copy comes first.
//
// Numerics.  The kernel runs the float32 operations of the composed step,
// in its order, each rounded on its own (the library is built with
// -fmad=false, and every operation here is an explicit _rn intrinsic):
//
//   m = m * b1 + g * (1 - b1)
//   v = v * b2 + (g * g) * (1 - b2)
//   p = p + ((m / bc1) / (sqrt(v / bc2) + eps)) * (-lr)
//
// with each Python scalar as torch casts it to float.  A member's bias
// corrections and rate are read from device tables (a population's rows),
// which the kernel divides by, as torch divides by a tensor; or they are a
// solo run's scalars, given as the float32 reciprocals of the bias
// corrections, which it multiplies by, as torch's _foreach_div by a host
// float computes the division on the card.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kChunk = kThreads * kVec;  // the elements of one block
// Segments one launch takes in its parameters (64 B each, under the 4 KB
// that a kernel's parameters may hold); more take further launches.
constexpr int kMaxSegments = 56;

// Segment flags.
constexpr int kVecPMV = 1;   // p, m, v share their 16-byte phase
constexpr int kVecG = 2;     // g is contiguous and shares it too
constexpr int kGDense = 4;   // g is contiguous

struct Segment {
  float* p;
  const float* g;
  float* m;
  float* v;
  int n;            // elements
  int cols;         // g's element e is at (e / cols) * row_stride
  int row_stride;   //   + (e % cols) * col_stride
  int col_stride;
  int member;
  int first_block;  // the segment's first block in the grid
  int phase;        // p's address in floats, mod kVec, where kVecPMV
  int flags;
};

struct Table {
  Segment seg[kMaxSegments];
  int count;
};

struct Coeffs {
  const float* bc1;     // per member, or null: the scalars below
  const float* bc2;
  const float* neg_lr;
  float inv_bc1, inv_bc2, neg_lr_s;  // a solo run's: 1 / bc1, 1 / bc2
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

struct Member {
  float bc1, bc2, neg_lr;
};

// kTables: a member's bc1 and bc2 from the tables, divided by; else the
// solo run's reciprocals, multiplied by.
template <bool kTables>
__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     const Coeffs& c, const Member& k) {
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, c.b2),
                __fmul_rn(__fmul_rn(g, g), c.one_minus_b2));
  const float v_hat = kTables ? __fdiv_rn(v, k.bc2) : __fmul_rn(v, k.bc2);
  const float denom = __fadd_rn(__fsqrt_rn(v_hat), c.eps);
  const float m_hat = kTables ? __fdiv_rn(m, k.bc1) : __fmul_rn(m, k.bc1);
  p = __fadd_rn(p, __fmul_rn(__fdiv_rn(m_hat, denom), k.neg_lr));
}

__device__ __forceinline__ float load_g(const Segment& s, long long e) {
  if (s.flags & kGDense) return __ldg(s.g + e);
  const int i = (int)e;  // a segment holds at most 2^30 elements
  return __ldg(s.g + (long long)(i / s.cols) * s.row_stride +
               (long long)(i % s.cols) * s.col_stride);
}

template <bool kTables>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const Table t, const Coeffs c) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const Segment s = t.seg[lo];
  Member k;
  k.bc1 = kTables ? c.bc1[s.member] : c.inv_bc1;
  k.bc2 = kTables ? c.bc2[s.member] : c.inv_bc2;
  k.neg_lr = kTables ? c.neg_lr[s.member] : c.neg_lr_s;
  // The thread's first element; a segment whose addresses start kVec-phase
  // into a 16-byte word begins its first block that many elements early.
  const long long e0 =
      ((long long)(b - s.first_block) * kThreads + threadIdx.x) * kVec -
      s.phase;
  if ((s.flags & kVecPMV) && e0 >= 0 && e0 + kVec <= s.n) {
    float4 p4 = *reinterpret_cast<const float4*>(s.p + e0);
    float4 m4 = *reinterpret_cast<const float4*>(s.m + e0);
    float4 v4 = *reinterpret_cast<const float4*>(s.v + e0);
    float4 g4;
    if (s.flags & kVecG) {
      g4 = __ldg(reinterpret_cast<const float4*>(s.g + e0));
    } else {
      g4.x = load_g(s, e0);
      g4.y = load_g(s, e0 + 1);
      g4.z = load_g(s, e0 + 2);
      g4.w = load_g(s, e0 + 3);
    }
    step<kTables>(p4.x, g4.x, m4.x, v4.x, c, k);
    step<kTables>(p4.y, g4.y, m4.y, v4.y, c, k);
    step<kTables>(p4.z, g4.z, m4.z, v4.z, c, k);
    step<kTables>(p4.w, g4.w, m4.w, v4.w, c, k);
    *reinterpret_cast<float4*>(s.p + e0) = p4;
    *reinterpret_cast<float4*>(s.m + e0) = m4;
    *reinterpret_cast<float4*>(s.v + e0) = v4;
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const long long e = e0 + j;
    if (e < 0 || e >= s.n) continue;
    float p = s.p[e], m = s.m[e], v = s.v[e];
    step<kTables>(p, load_g(s, e), m, v, c, k);
    s.p[e] = p;
    s.m[e] = m;
    s.v[e] = v;
  }
}

// A leaf of every member as the wrapper describes it: member 0's addresses
// of p, g, m, v, each tensor's member stride in elements, the elements of
// one member's leaf, and the gradient's (rows, cols) view.
enum LeafField {
  kP, kG, kM, kV, kPMember, kGMember, kMMember, kVMember,
  kN, kCols, kRowStride, kColStride, kLeafFields
};

int phase_of(uint64_t address) { return (int)((address >> 2) & (kVec - 1)); }

// Launches the table's segments, if any, and counts the launch.
int launch(Table& t, int blocks, const Coeffs& c, cudaStream_t stream,
           int* launches) {
  if (t.count == 0) return 0;
  if (c.bc1) {
    adam_kernel<true><<<blocks, kThreads, 0, stream>>>(t, c);
  } else {
    adam_kernel<false><<<blocks, kThreads, 0, stream>>>(t, c);
  }
  t.count = 0;
  ++*launches;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int q1_adam_leaf_fields() { return kLeafFields; }

// One Adam step of ``members`` members over ``n_leaves`` leaves
// (``leaves``: n_leaves x kLeafFields int64, host memory).  ``bc1``,
// ``bc2``, ``neg_lr``: device tables of one float a member, all three, or
// all null for the scalars in ``fparams`` (1 / bc1, 1 / bc2, neg_lr, b1,
// 1 - b1, b2, 1 - b2, eps).  Launches on ``stream`` (one launch for each
// kMaxSegments segments), adds the launches to ``*launches`` and returns
// the CUDA error of the last one.
extern "C" int q1_adam_step(const int64_t* leaves, int n_leaves, int members,
                            const float* bc1, const float* bc2,
                            const float* neg_lr, const float* fparams,
                            void* stream, int* launches) {
  if (n_leaves < 0 || members < 1 || !bc1 != !bc2 || !bc1 != !neg_lr)
    return (int)cudaErrorInvalidValue;
  Coeffs c;
  c.bc1 = bc1;
  c.bc2 = bc2;
  c.neg_lr = neg_lr;
  c.inv_bc1 = fparams[0];
  c.inv_bc2 = fparams[1];
  c.neg_lr_s = fparams[2];
  c.b1 = fparams[3];
  c.one_minus_b1 = fparams[4];
  c.b2 = fparams[5];
  c.one_minus_b2 = fparams[6];
  c.eps = fparams[7];
  Table t;
  std::memset(&t, 0, sizeof(t));
  int blocks = 0;
  for (int member = 0; member < members; ++member) {
    for (int leaf = 0; leaf < n_leaves; ++leaf) {
      const int64_t* f = leaves + (int64_t)leaf * kLeafFields;
      const int64_t n = f[kN];
      if (n < 0 || n > (1LL << 30) || f[kCols] < 1)
        return (int)cudaErrorInvalidValue;
      if (n == 0) continue;
      const uint64_t p = (uint64_t)(f[kP] + 4 * member * f[kPMember]);
      const uint64_t g = (uint64_t)(f[kG] + 4 * member * f[kGMember]);
      const uint64_t m = (uint64_t)(f[kM] + 4 * member * f[kMMember]);
      const uint64_t v = (uint64_t)(f[kV] + 4 * member * f[kVMember]);
      if ((p | g | m | v) & 3) return (int)cudaErrorInvalidValue;
      Segment& s = t.seg[t.count];
      s.p = reinterpret_cast<float*>(p);
      s.g = reinterpret_cast<const float*>(g);
      s.m = reinterpret_cast<float*>(m);
      s.v = reinterpret_cast<float*>(v);
      s.n = (int)n;
      s.cols = (int)f[kCols];
      s.row_stride = (int)f[kRowStride];
      s.col_stride = (int)f[kColStride];
      s.member = member;
      s.first_block = blocks;
      const bool dense =
          s.col_stride == 1 && (s.row_stride == s.cols || n <= s.cols);
      const int phase = phase_of(p);
      s.flags = dense ? kGDense : 0;
      if (phase_of(m) == phase && phase_of(v) == phase) {
        s.flags |= kVecPMV;
        s.phase = phase;
        if (dense && phase_of(g) == phase) s.flags |= kVecG;
      } else {
        s.phase = 0;
      }
      blocks += (int)((n + s.phase + kChunk - 1) / kChunk);
      if (++t.count == kMaxSegments) {
        const int err = launch(t, blocks, c, (cudaStream_t)stream, launches);
        if (err != 0) return err;
        blocks = 0;
      }
    }
  }
  return launch(t, blocks, c, (cudaStream_t)stream, launches);
}
