// Fused T-step env rollout with streamed actions and no reset, for Hopper.
//
// Replaces: the JAX package's Pallas TPU kernel
// ops/env_rollout_pallas.py:rollout_actions, which is equal to a scan of its
// env/core.py:step with compute_observation=False.  Its plain version is
// q1physrl_torch/ops/env_rollout.py:rollout_actions_plain, a loop of the
// port's env/core.py:step; every operation below mirrors one there, in the
// same order.
//
// What bounds it: bytes.  Each env's state (8 (N,) leaves and 2 (K,N)
// leaves) is read once and written once, and each env-step reads K key
// actions and one yaw action and writes one reward and one done flag.  The
// arithmetic (47 float operations per env-step for K=4 in the air, 57 on
// the ground, counting each sinf, cosf, sqrtf and divide as one) is far
// below the card's float32 rate.  At the
// scoring shape (N=512, T=1) the bytes take tens of nanoseconds, so launch
// latency sets the pace there.
//
// What the design does about it: one thread per env, state in registers
// across the T loop, loaded and stored once per launch; per-step inputs and
// outputs are indexed t*N+i (keys (t*K+k)*N+i), so the threads of a warp
// touch neighbouring addresses.  The config arrives as launch arguments, so
// one binary serves every Config, and branches on its flags are uniform
// across a warp.
//
// Numerics: float32 only (the float64 parity mode is the plain version's
// job).  Build with -fmad=false: the plain version and the JAX reference
// round every product before the following add, and a fused multiply-add
// here changes z_pos by an ulp, which can flip the z_pos < FLOOR_HEIGHT
// ground test and with it a jump.  Float literals carry the f suffix so no
// expression is promoted to double; sinf/cosf/sqrtf are the IEEE-accurate
// versions (no --use_fast_math).

#include <cstdint>
#include <cuda_runtime.h>

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

struct State {
  float* z_pos;
  float* vel_x;
  float* vel_y;
  float* vel_z;
  uint8_t* on_ground;
  uint8_t* jump_released;
  float* yaw;
  float* time_remaining;
  int32_t* last_keys;            // (K, N)
  float* last_key_press_time;    // (K, N)
};

struct Params {
  float time_delta;
  float time_limit;
  float max_yaw_delta;
  float action_range;
  float fmove_max;
  float smove_max;
  float key_press_delay;
  int discrete_yaw_steps;
  int flags;
};

__global__ void __launch_bounds__(kThreads)
rollout_actions_kernel(State in, State out,
                       const int32_t* __restrict__ key_actions,  // (T, K, N)
                       const float* __restrict__ yaw_actions,    // (T, N)
                       float* __restrict__ rewards,              // (T, N)
                       uint8_t* __restrict__ dones,              // (T, N)
                       int n, int t_steps, int k, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float z = in.z_pos[i];
  float vx = in.vel_x[i];
  float vy = in.vel_y[i];
  float vz = in.vel_z[i];
  bool on_ground = in.on_ground[i] != 0;
  bool jump_released = in.jump_released[i] != 0;
  float yaw = in.yaw[i];
  float time_remaining = in.time_remaining[i];
  int last_keys[kMaxKeys];
  float last_press[kMaxKeys];
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    last_keys[j] = j < k ? in.last_keys[j * n + i] : 0;
    last_press[j] = j < k ? in.last_key_press_time[j * n + i] : 0.0f;
  }

  const float td = p.time_delta;
  const bool allow_yaw = p.flags & kAllowYaw;
  const bool smooth_keys = p.flags & kSmoothKeys;
  const bool auto_jump = p.flags & kAutoJump;
  const bool allow_jump = p.flags & kAllowJump;
  const bool hover = p.flags & kHover;
  const bool speed_reward = p.flags & kSpeedReward;

  for (int t = 0; t < t_steps; ++t) {
    if (hover) {
      vz = 0.0f;
      z = 100.0f;
    }

    // --- action decode (env/core.py:_decode) ---
    const float yaw_action = yaw_actions[t * n + i];
    float mouse_x;
    if (!allow_yaw) {
      mouse_x = 0.0f;
    } else if (p.discrete_yaw_steps == -1) {
      mouse_x = yaw_action * p.max_yaw_delta / p.action_range;
    } else {
      const float steps = (float)p.discrete_yaw_steps;
      mouse_x = (yaw_action - steps) * p.max_yaw_delta / steps;
    }

    const float current_time = p.time_limit - time_remaining;
    float smoothed[kMaxKeys];
    int keys[kMaxKeys];
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      keys[j] = 0;
      smoothed[j] = 0.0f;
      if (j < k) {
        const bool elapsed =
            current_time >= last_press[j] + p.key_press_delay;
        const int key = key_actions[(t * k + j) * n + i] &
                        ((elapsed || last_keys[j] > 0) ? 1 : 0);
        if (key > 0 && last_keys[j] == 0) last_press[j] = current_time;
        smoothed[j] = smooth_keys ? (float)(key + last_keys[j]) * 0.5f
                                  : (float)key;
        keys[j] = key;
        last_keys[j] = key;
      }
    }
    yaw = yaw + mouse_x;
    const float strafe = smoothed[kStrafeRight] - smoothed[kStrafeLeft];
    const float smove = (float)(int)(p.smove_max * strafe);
    const float fmove = (float)(int)(p.fmove_max * smoothed[kForward]);
    bool jump;
    if (auto_jump) {
      jump = vz <= 16.0f;
    } else if (allow_jump) {
      jump = keys[kJump] > 0;
    } else {
      jump = false;
    }

    // --- horizontal physics (phys.py:air_move), pitch = roll = 0 ---
    // With pitch = roll = 0, angle_vectors gives exactly
    // f = (cy, sy) and r = (sy, -cy).
    const float angle = yaw * kDegToRad;
    const float sy = sinf(angle);
    const float cy = cosf(angle);
    const float wish_x = cy * fmove + sy * smove;
    const float wish_y = sy * fmove - cy * smove;
    const float unclipped = sqrtf(wish_x * wish_x + wish_y * wish_y);
    const bool nonzero = unclipped > 0.0f;
    const float dir_x = nonzero ? wish_x / unclipped : wish_x;
    const float dir_y = nonzero ? wish_y / unclipped : wish_y;
    const float wish_speed = unclipped < kMaxSpeed ? unclipped : kMaxSpeed;

    if (on_ground) {  // phys.py:user_friction
      const float speed = sqrtf(vx * vx + vy * vy);
      const float control = speed > kStopSpeed ? speed : kStopSpeed;
      float new_speed = speed - td * control * kFriction;
      new_speed = new_speed > 0.0f ? new_speed : 0.0f;
      const float ratio = new_speed / speed;
      if (speed > 0.0f) {
        vx = vx * ratio;
        vy = vy * ratio;
      }
    }
    // phys.py:accelerate
    const float current_speed = vx * dir_x + vy * dir_y;
    const float clipped =
        (wish_speed > 30.0f && !on_ground) ? 30.0f : wish_speed;
    float add_speed = clipped - current_speed;
    add_speed = add_speed > 0.0f ? add_speed : 0.0f;
    float accel_speed = kAccelerate * td * wish_speed;
    accel_speed = accel_speed < add_speed ? accel_speed : add_speed;
    vx = vx + accel_speed * dir_x;
    vy = vy + accel_speed * dir_y;

    // --- vertical physics (phys.py:do_z_physics) ---
    jump_released = jump_released || !jump;
    const bool do_jump = on_ground && jump && jump_released;
    vz = vz + (do_jump ? kJumpSpeed : 0.0f);
    vz = vz - kGravity * td;
    z = z + td * vz;
    on_ground = z < kFloorHeight;
    if (on_ground) {
      z = kFloorHeight;
      vz = 0.0f;
    }

    // --- reward and episode clock (env/core.py:step) ---
    const float reward =
        speed_reward ? td * sqrtf(vx * vx + vy * vy) : td * vy;
    time_remaining = time_remaining - td;
    rewards[t * n + i] = reward;
    dones[t * n + i] = time_remaining < 0.0f;
  }

  out.z_pos[i] = z;
  out.vel_x[i] = vx;
  out.vel_y[i] = vy;
  out.vel_z[i] = vz;
  out.on_ground[i] = on_ground;
  out.jump_released[i] = jump_released;
  out.yaw[i] = yaw;
  out.time_remaining[i] = time_remaining;
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    if (j < k) {
      out.last_keys[j * n + i] = last_keys[j];
      out.last_key_press_time[j * n + i] = last_press[j];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Returns the cudaError_t of the launch (0 on
// success).  Launches nothing for n == 0.
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
  if (k < 0 || k > kMaxKeys || n < 0 || t_steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  State in{const_cast<float*>(z_pos), const_cast<float*>(vel_x),
           const_cast<float*>(vel_y), const_cast<float*>(vel_z),
           const_cast<uint8_t*>(on_ground),
           const_cast<uint8_t*>(jump_released), const_cast<float*>(yaw),
           const_cast<float*>(time_remaining),
           const_cast<int32_t*>(last_keys),
           const_cast<float*>(last_key_press_time)};
  State out{out_z_pos, out_vel_x, out_vel_y, out_vel_z, out_on_ground,
            out_jump_released, out_yaw, out_time_remaining, out_last_keys,
            out_last_key_press_time};
  Params p{time_delta, time_limit, max_yaw_delta, action_range, fmove_max,
           smove_max, key_press_delay, discrete_yaw_steps, flags};
  const int blocks = (n + kThreads - 1) / kThreads;
  rollout_actions_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, key_actions, yaw_actions, rewards, dones, n, t_steps, k, p);
  return (int)cudaGetLastError();
}
