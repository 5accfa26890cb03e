// Fused T-step env rollouts for Hopper: three kernels that share one env
// step and one episode reset.
//
// Replaces the JAX package's Pallas TPU kernels in ops/env_rollout_pallas.py:
//
// - rollout_actions_kernel replaces rollout_actions: T frames of
//   env/core.py:step with compute_observation=False, streamed actions, no
//   reset.  Plain version: env_rollout.py:rollout_actions_plain.
// - rollout_autoreset_kernel replaces rollout_actions_autoreset: the same
//   frames, and every env whose episode ended is re-drawn from streamed
//   uniforms, exactly a loop of env/core.py:step_autoreset(reset_uniforms=
//   ru[t]).  Its T=1 form is the env step of the PPO rollout.  Plain
//   version: env_rollout.py:rollout_actions_autoreset_plain.
// - rollout_random_kernel replaces rollout_random (with _uniform_from_bits):
//   actions and reset uniforms are drawn in the kernel from Philox4x32-10
//   (philox.cuh) and only the state, a per-env reward sum and a per-env
//   done count are written.  Plain version: env_rollout.py:
//   rollout_random_plain, which draws the same bits.
//
// Every operation below mirrors one in the plain versions, in the same
// order, so that each kernel equals its plain version bitwise on the card.
//
// What bounds them: rollout_actions and rollout_autoreset move bytes.  Each
// env's state (11 leaves, two of them (K, N)) is read once and written once
// per launch, and each env-step reads K key actions and one yaw action (and
// five reset uniforms where an episode ends) and writes one reward and one
// done flag; the arithmetic (47 float operations per env-step for K=4 in
// the air, 57 on the ground, counting each sinf, cosf, sqrtf and divide as
// one) is far below the card's float32 rate.  rollout_random moves only the
// state, so its arithmetic bounds it: one Philox call per env-step (98
// integer operations) plus a second where an episode ends, and the step's
// float operations.
//
// What the design does about it: one thread per env, state in registers
// across the T loop, loaded and stored once per launch; per-step inputs and
// outputs are indexed t*N+i (keys (t*K+k)*N+i, reset uniforms (t*5+j)*N+i),
// so the threads of a warp touch neighbouring addresses.  Reset uniforms
// are read, and the second Philox call made, only where an episode ended.
// The config arrives as launch arguments, so one binary serves every
// Config, and branches on its flags are uniform across a warp.
//
// Numerics: float32 only (the float64 parity mode is the plain versions'
// job).  Build with -fmad=false: the plain versions and the JAX reference
// round every product before the following add, and a fused multiply-add
// here changes z_pos by an ulp, which can flip the z_pos < FLOOR_HEIGHT
// ground test and with it a jump.  Float literals carry the f suffix so no
// expression is promoted to double; sinf/cosf/sqrtf are the IEEE-accurate
// versions (no --use_fast_math).  Scalars that the plain version folds in
// double before rounding once to float32 (1 - time_limit, 2 pi, ...)
// arrive from Python already rounded.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxKeys = 4;
constexpr int kThreads = 256;

// Config flags, packed by the Python wrapper.
constexpr int kAllowYaw = 1;
constexpr int kSmoothKeys = 2;
constexpr int kAutoJump = 4;
constexpr int kAllowJump = 8;
constexpr int kHover = 16;
constexpr int kSpeedReward = 32;

// Physics constants (q1physrl_torch/phys.py).
constexpr float kMaxSpeed = 320.0f;
constexpr float kAccelerate = 10.0f;
constexpr float kFriction = 4.0f;
constexpr float kStopSpeed = 100.0f;
constexpr float kJumpSpeed = 270.0f;
constexpr float kGravity = 800.0f;
constexpr float kFloorHeight = 24.03125f;
// math.pi / 180.0 in double, rounded once to float as torch and JAX do
// when they multiply a float32 tensor by the Python float.
constexpr float kDegToRad = (float)(3.14159265358979323846 / 180.0);

// Key indices (env/config.py:Key).
constexpr int kStrafeLeft = 0;
constexpr int kStrafeRight = 1;
constexpr int kForward = 2;
constexpr int kJump = 3;

// Device pointers of the state leaves, in the wrapper's order.
struct Leaves {
  float* z_pos;
  float* vel_x;
  float* vel_y;
  float* vel_z;
  uint8_t* on_ground;
  uint8_t* jump_released;
  float* yaw;
  float* time_remaining;
  uint8_t* zero_start;           // null for rollout_actions, which keeps it
  int32_t* last_keys;            // (K, N)
  float* last_key_press_time;    // (K, N)
};

Leaves leaves_from(void* const* p) {
  return Leaves{(float*)p[0], (float*)p[1], (float*)p[2], (float*)p[3],
                (uint8_t*)p[4], (uint8_t*)p[5], (float*)p[6], (float*)p[7],
                (uint8_t*)p[8], (int32_t*)p[9], (float*)p[10]};
}

// Launch parameters.  The float fields arrive as one host array in this
// order (env_rollout.py:_float_params).
struct Params {
  float time_delta;
  float time_limit;
  float max_yaw_delta;
  float action_range;
  float fmove_max;
  float smove_max;
  float key_press_delay;
  // Episode reset (env/core.py:reset_from_uniforms).
  float zero_start_prob;
  float yaw_lo;            // initial_yaw_range[0]
  float yaw_span;          // initial_yaw_range[1] - initial_yaw_range[0]
  float time_span;         // 1 - time_limit
  float speed_hi;          // max_initial_speed
  float speed_span;        // 1 - max_initial_speed
  float angle_hi;          // 2 pi
  float angle_span;        // 1 - 2 pi
  float initial_z;
  float initial_vz;
  float initial_yaw_zero;
  float reset_press_time;  // -key_press_delay
  float hover_speed;
  float hover_angle;       // pi / 2
  int discrete_yaw_steps;
  int flags;
};
constexpr int kNumFloatParams = 21;

static_assert(sizeof(Params) == (kNumFloatParams + 2) * sizeof(float),
              "Params must hold the float array, then two ints");

Params params_from(const float* f, int discrete_yaw_steps, int flags) {
  Params p;
  std::memcpy(&p, f, kNumFloatParams * sizeof(float));
  p.discrete_yaw_steps = discrete_yaw_steps;
  p.flags = flags;
  return p;
}

// One env's state, held in registers across the T loop.
struct Env {
  float z, vx, vy, vz;
  bool on_ground, jump_released;
  float yaw, time_remaining;
  bool zero_start;
  int last_keys[kMaxKeys];
  float last_press[kMaxKeys];
};

__device__ __forceinline__ Env load_env(const Leaves& s, int i, int n, int k) {
  Env e;
  e.z = s.z_pos[i];
  e.vx = s.vel_x[i];
  e.vy = s.vel_y[i];
  e.vz = s.vel_z[i];
  e.on_ground = s.on_ground[i] != 0;
  e.jump_released = s.jump_released[i] != 0;
  e.yaw = s.yaw[i];
  e.time_remaining = s.time_remaining[i];
  e.zero_start = s.zero_start != nullptr && s.zero_start[i] != 0;
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    e.last_keys[j] = j < k ? s.last_keys[j * n + i] : 0;
    e.last_press[j] = j < k ? s.last_key_press_time[j * n + i] : 0.0f;
  }
  return e;
}

__device__ __forceinline__ void store_env(const Leaves& s, const Env& e, int i,
                                          int n, int k) {
  s.z_pos[i] = e.z;
  s.vel_x[i] = e.vx;
  s.vel_y[i] = e.vy;
  s.vel_z[i] = e.vz;
  s.on_ground[i] = e.on_ground;
  s.jump_released[i] = e.jump_released;
  s.yaw[i] = e.yaw;
  s.time_remaining[i] = e.time_remaining;
  if (s.zero_start != nullptr) s.zero_start[i] = e.zero_start;
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    if (j < k) {
      s.last_keys[j * n + i] = e.last_keys[j];
      s.last_key_press_time[j * n + i] = e.last_press[j];
    }
  }
}

// One frame of env/core.py:step: decode the actions, move the player,
// return the reward and set `done` from the episode clock.
__device__ __forceinline__ float env_step(Env& e, const int (&key_in)[kMaxKeys],
                                          float yaw_action, int k,
                                          const Params& p, bool& done) {
  const float td = p.time_delta;
  const bool allow_yaw = p.flags & kAllowYaw;
  const bool smooth_keys = p.flags & kSmoothKeys;
  const bool auto_jump = p.flags & kAutoJump;
  const bool allow_jump = p.flags & kAllowJump;
  const bool hover = p.flags & kHover;
  const bool speed_reward = p.flags & kSpeedReward;

  if (hover) {
    e.vz = 0.0f;
    e.z = 100.0f;
  }

  // --- action decode (env/core.py:_decode) ---
  float mouse_x;
  if (!allow_yaw) {
    mouse_x = 0.0f;
  } else if (p.discrete_yaw_steps == -1) {
    mouse_x = yaw_action * p.max_yaw_delta / p.action_range;
  } else {
    const float steps = (float)p.discrete_yaw_steps;
    mouse_x = (yaw_action - steps) * p.max_yaw_delta / steps;
  }

  const float current_time = p.time_limit - e.time_remaining;
  float smoothed[kMaxKeys];
  int keys[kMaxKeys];
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    keys[j] = 0;
    smoothed[j] = 0.0f;
    if (j < k) {
      const bool elapsed =
          current_time >= e.last_press[j] + p.key_press_delay;
      const int key =
          key_in[j] & ((elapsed || e.last_keys[j] > 0) ? 1 : 0);
      if (key > 0 && e.last_keys[j] == 0) e.last_press[j] = current_time;
      smoothed[j] = smooth_keys ? (float)(key + e.last_keys[j]) * 0.5f
                                : (float)key;
      keys[j] = key;
      e.last_keys[j] = key;
    }
  }
  e.yaw = e.yaw + mouse_x;
  const float strafe = smoothed[kStrafeRight] - smoothed[kStrafeLeft];
  const float smove = (float)(int)(p.smove_max * strafe);
  const float fmove = (float)(int)(p.fmove_max * smoothed[kForward]);
  bool jump;
  if (auto_jump) {
    jump = e.vz <= 16.0f;
  } else if (allow_jump) {
    jump = keys[kJump] > 0;
  } else {
    jump = false;
  }

  // --- horizontal physics (phys.py:air_move), pitch = roll = 0 ---
  // With pitch = roll = 0, angle_vectors gives exactly
  // f = (cy, sy) and r = (sy, -cy).
  const float angle = e.yaw * kDegToRad;
  const float sy = sinf(angle);
  const float cy = cosf(angle);
  const float wish_x = cy * fmove + sy * smove;
  const float wish_y = sy * fmove - cy * smove;
  const float unclipped = sqrtf(wish_x * wish_x + wish_y * wish_y);
  const bool nonzero = unclipped > 0.0f;
  const float dir_x = nonzero ? wish_x / unclipped : wish_x;
  const float dir_y = nonzero ? wish_y / unclipped : wish_y;
  const float wish_speed = unclipped < kMaxSpeed ? unclipped : kMaxSpeed;

  if (e.on_ground) {  // phys.py:user_friction
    const float speed = sqrtf(e.vx * e.vx + e.vy * e.vy);
    const float control = speed > kStopSpeed ? speed : kStopSpeed;
    float new_speed = speed - td * control * kFriction;
    new_speed = new_speed > 0.0f ? new_speed : 0.0f;
    const float ratio = new_speed / speed;
    if (speed > 0.0f) {
      e.vx = e.vx * ratio;
      e.vy = e.vy * ratio;
    }
  }
  // phys.py:accelerate
  const float current_speed = e.vx * dir_x + e.vy * dir_y;
  const float clipped =
      (wish_speed > 30.0f && !e.on_ground) ? 30.0f : wish_speed;
  float add_speed = clipped - current_speed;
  add_speed = add_speed > 0.0f ? add_speed : 0.0f;
  float accel_speed = kAccelerate * td * wish_speed;
  accel_speed = accel_speed < add_speed ? accel_speed : add_speed;
  e.vx = e.vx + accel_speed * dir_x;
  e.vy = e.vy + accel_speed * dir_y;

  // --- vertical physics (phys.py:do_z_physics) ---
  e.jump_released = e.jump_released || !jump;
  const bool do_jump = e.on_ground && jump && e.jump_released;
  e.vz = e.vz + (do_jump ? kJumpSpeed : 0.0f);
  e.vz = e.vz - kGravity * td;
  e.z = e.z + td * e.vz;
  e.on_ground = e.z < kFloorHeight;
  if (e.on_ground) {
    e.z = kFloorHeight;
    e.vz = 0.0f;
  }

  // --- reward and episode clock (env/core.py:step) ---
  const float reward =
      speed_reward ? td * sqrtf(e.vx * e.vx + e.vy * e.vy) : td * e.vy;
  e.time_remaining = e.time_remaining - td;
  done = e.time_remaining < 0.0f;
  return reward;
}

// Replace the env with a fresh episode start drawn from five uniforms
// (env/core.py:reset_from_uniforms, then merge_reset where done).  The
// quirk of the original holds: time, speed and angle come from (1, x].
__device__ __forceinline__ void reset_env(Env& e, float u_zs, float u_yaw,
                                          float u_time, float u_speed,
                                          float u_angle, int k,
                                          const Params& p) {
  const bool zero_start = u_zs < p.zero_start_prob;
  float speed = zero_start ? 0.0f : p.speed_hi + p.speed_span * u_speed;
  float move_angle = p.angle_hi + p.angle_span * u_angle;
  if (p.flags & kHover) {
    speed = p.hover_speed;
    move_angle = p.hover_angle;
  }
  e.z = p.initial_z;
  e.vx = speed * cosf(move_angle);
  e.vy = speed * sinf(move_angle);
  e.vz = p.initial_vz;
  e.on_ground = false;
  e.jump_released = true;
  e.yaw = zero_start ? p.initial_yaw_zero : p.yaw_lo + p.yaw_span * u_yaw;
  e.time_remaining =
      zero_start ? p.time_limit : p.time_limit + p.time_span * u_time;
  e.zero_start = zero_start;
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    if (j < k) {
      e.last_keys[j] = 0;
      e.last_press[j] = p.reset_press_time;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rollout_actions_kernel(Leaves in, Leaves out,
                       const int32_t* __restrict__ key_actions,  // (T, K, N)
                       const float* __restrict__ yaw_actions,    // (T, N)
                       float* __restrict__ rewards,              // (T, N)
                       uint8_t* __restrict__ dones,              // (T, N)
                       int n, int t_steps, int k, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Env e = load_env(in, i, n, k);
  for (int t = 0; t < t_steps; ++t) {
    int keys[kMaxKeys];
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      keys[j] = j < k ? key_actions[(t * k + j) * n + i] : 0;
    }
    bool done;
    rewards[t * n + i] = env_step(e, keys, yaw_actions[t * n + i], k, p, done);
    dones[t * n + i] = done;
  }
  store_env(out, e, i, n, k);
}

__global__ void __launch_bounds__(kThreads)
rollout_autoreset_kernel(Leaves in, Leaves out,
                         const int32_t* __restrict__ key_actions,  // (T, K, N)
                         const float* __restrict__ yaw_actions,    // (T, N)
                         const float* __restrict__ reset_uniforms, // (T, 5, N)
                         float* __restrict__ rewards,              // (T, N)
                         uint8_t* __restrict__ dones,              // (T, N)
                         int n, int t_steps, int k, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Env e = load_env(in, i, n, k);
  for (int t = 0; t < t_steps; ++t) {
    int keys[kMaxKeys];
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      keys[j] = j < k ? key_actions[(t * k + j) * n + i] : 0;
    }
    bool done;
    rewards[t * n + i] = env_step(e, keys, yaw_actions[t * n + i], k, p, done);
    dones[t * n + i] = done;
    if (done) {
      const float* u = reset_uniforms + (size_t)t * 5 * n + i;
      reset_env(e, u[0], u[n], u[2 * n], u[3 * n], u[4 * n], k, p);
    }
  }
  store_env(out, e, i, n, k);
}

// Draws of env i at frame t: counter (i, t, 0, 0) gives the key bits (word
// x, bit j for key j), the yaw uniform (y) and the first two reset uniforms
// (z, w); counter (i, t, 1, 0), made only where the episode ended, the last
// three (x, y, z).  The key is (seed, 0).
__global__ void __launch_bounds__(kThreads)
rollout_random_kernel(Leaves in, Leaves out,
                      float* __restrict__ reward_sum,    // (N,)
                      int32_t* __restrict__ done_count,  // (N,)
                      int n, int t_steps, int k, uint32_t seed, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2 key = make_uint2(seed, 0u);
  Env e = load_env(in, i, n, k);
  float reward_acc = 0.0f;
  int done_acc = 0;
  for (int t = 0; t < t_steps; ++t) {
    const uint4 r0 = q1::philox4x32_10(make_uint4(i, t, 0u, 0u), key);
    int keys[kMaxKeys];
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      keys[j] = j < k ? (int)((r0.x >> j) & 1u) : 0;
    }
    const float yaw_action =
        (q1::uniform_from_bits(r0.y) * 2.0f - 1.0f) * p.action_range;
    bool done;
    reward_acc = reward_acc + env_step(e, keys, yaw_action, k, p, done);
    if (done) {
      done_acc += 1;
      const uint4 r1 = q1::philox4x32_10(make_uint4(i, t, 1u, 0u), key);
      reset_env(e, q1::uniform_from_bits(r0.z), q1::uniform_from_bits(r0.w),
                q1::uniform_from_bits(r1.x), q1::uniform_from_bits(r1.y),
                q1::uniform_from_bits(r1.z), k, p);
    }
  }
  store_env(out, e, i, n, k);
  reward_sum[i] = reward_acc;
  done_count[i] = done_acc;
}

bool bad_shape(int n, int t_steps, int k) {
  return k < 0 || k > kMaxKeys || n < 0 || t_steps < 0;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points, loaded with ctypes.  Pointers are device pointers
// unless named otherwise; `stream` is a cudaStream_t.  Each returns the
// cudaError_t of its launch (0 on success) and launches nothing for n == 0.

// rollout_actions: the state leaves without zero_start, which it keeps.
extern "C" int q1_rollout_actions(
    const float* z_pos, const float* vel_x, const float* vel_y,
    const float* vel_z, const uint8_t* on_ground,
    const uint8_t* jump_released, const float* yaw,
    const float* time_remaining, const int32_t* last_keys,
    const float* last_key_press_time,
    float* out_z_pos, float* out_vel_x, float* out_vel_y, float* out_vel_z,
    uint8_t* out_on_ground, uint8_t* out_jump_released, float* out_yaw,
    float* out_time_remaining, int32_t* out_last_keys,
    float* out_last_key_press_time,
    const int32_t* key_actions, const float* yaw_actions, float* rewards,
    uint8_t* dones, int n, int t_steps, int k, float time_delta,
    float time_limit, float max_yaw_delta, float action_range,
    float fmove_max, float smove_max, float key_press_delay,
    int discrete_yaw_steps, int flags, void* stream) {
  if (bad_shape(n, t_steps, k)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Leaves in{const_cast<float*>(z_pos), const_cast<float*>(vel_x),
            const_cast<float*>(vel_y), const_cast<float*>(vel_z),
            const_cast<uint8_t*>(on_ground),
            const_cast<uint8_t*>(jump_released), const_cast<float*>(yaw),
            const_cast<float*>(time_remaining), nullptr,
            const_cast<int32_t*>(last_keys),
            const_cast<float*>(last_key_press_time)};
  Leaves out{out_z_pos, out_vel_x, out_vel_y, out_vel_z, out_on_ground,
             out_jump_released, out_yaw, out_time_remaining, nullptr,
             out_last_keys, out_last_key_press_time};
  Params p{};
  p.time_delta = time_delta;
  p.time_limit = time_limit;
  p.max_yaw_delta = max_yaw_delta;
  p.action_range = action_range;
  p.fmove_max = fmove_max;
  p.smove_max = smove_max;
  p.key_press_delay = key_press_delay;
  p.discrete_yaw_steps = discrete_yaw_steps;
  p.flags = flags;
  rollout_actions_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      in, out, key_actions, yaw_actions, rewards, dones, n, t_steps, k, p);
  return (int)cudaGetLastError();
}

// rollout_actions_autoreset: `in` and `out` are host arrays of the 11 leaf
// pointers (Leaves order); `fparams` a host array of the 21 floats of
// Params.
extern "C" int q1_rollout_actions_autoreset(
    void* const* in, void* const* out, const int32_t* key_actions,
    const float* yaw_actions, const float* reset_uniforms, float* rewards,
    uint8_t* dones, int n, int t_steps, int k, const float* fparams,
    int discrete_yaw_steps, int flags, void* stream) {
  if (bad_shape(n, t_steps, k)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  rollout_autoreset_kernel<<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
      leaves_from(in), leaves_from(out), key_actions, yaw_actions,
      reset_uniforms, rewards, dones, n, t_steps, k,
      params_from(fparams, discrete_yaw_steps, flags));
  return (int)cudaGetLastError();
}

// rollout_random: as above, plus the per-env outputs and the seed.
extern "C" int q1_rollout_random(
    void* const* in, void* const* out, float* reward_sum, int32_t* done_count,
    int n, int t_steps, int k, const float* fparams, int discrete_yaw_steps,
    int flags, unsigned int seed, void* stream) {
  if (bad_shape(n, t_steps, k)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  rollout_random_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      leaves_from(in), leaves_from(out), reward_sum, done_count, n, t_steps,
      k, seed, params_from(fparams, discrete_yaw_steps, flags));
  return (int)cudaGetLastError();
}

// The library's Philox on m counters (4, m) with key (key0, key1), written
// to (4, m): lets chip_smoke.py hold it against its plain version and
// curand's.
__global__ void philox_kernel(const uint32_t* __restrict__ counters,
                              uint32_t* __restrict__ out, int m,
                              uint32_t key0, uint32_t key1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint4 r = q1::philox4x32_10(
      make_uint4(counters[i], counters[m + i], counters[2 * m + i],
                 counters[3 * m + i]),
      make_uint2(key0, key1));
  out[i] = r.x;
  out[m + i] = r.y;
  out[2 * m + i] = r.z;
  out[3 * m + i] = r.w;
}

extern "C" int q1_philox(const uint32_t* counters, uint32_t* out, int m,
                         unsigned int key0, unsigned int key1, void* stream) {
  if (m <= 0) return m < 0 ? (int)cudaErrorInvalidValue : 0;
  philox_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      counters, out, m, key0, key1);
  return (int)cudaGetLastError();
}
