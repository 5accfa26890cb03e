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
// state, so the rate at which the SMs issue instructions bounds it: on
// run4's common path (in the air, no reset) an env-step issues about 234
// warp instructions (scripts/torch_sass_mix.py; PERF.md): 14 are a third
// of the 42-instruction block of one Philox call, 34 three IEEE divides,
// and the rest the step's physics, one shared range reduction and the
// sine and cosine polynomials.
//
// What the design does about it: one thread per env, state in registers
// across the T loop, loaded and stored once per launch; per-step inputs and
// outputs are indexed t*N+i (keys (t*K+k)*N+i, reset uniforms (t*5+j)*N+i),
// so the threads of a warp touch neighbouring addresses.  Reset uniforms
// are read, and the reset's Philox call made, only where an episode ended.
// The config arrives as launch arguments, so one binary serves every
// Config, and branches on its flags are uniform across a warp; only the
// number of keys K (3 or 4) is a template argument, so the per-key loops
// carry no branch.  To issue fewer instructions per env-step:
//
// - rollout_random draws the actions of kFramesPerDraw = 3 frames from one
//   Philox call (see the draw layout above rollout_random_kernel), and an
//   episode's five reset uniforms from one more;
// - the yaw angle's sine and cosine share one range reduction (sincosf,
//   bitwise equal to sinf and cosf on every float32:
//   scripts/torch_sincos_check.py);
// - smove and fmove come from a table of the 15 (strafe, forward) pairs the
//   keys can give, built once per block in shared memory with the plain
//   version's operations, instead of two int-to-float conversions, a float
//   product and a float-to-int-to-float truncation per move each env-step
//   (the table serves key latches of 0 and 1, which every step leaves; an
//   env that starts with another latch takes its first frame through those
//   conversions, outside the T loop);
// - blocks of 64 threads spread the last wave of a launch over the SMs.
//
// rollout_actions and rollout_autoreset run on their main paths at T=1, one
// launch per env step inside a frame loop (scoring, eval_sim, the PPO
// rollout), so what binds them there is the launch, not the body.  The
// loops are captured as CUDA graphs (q1physrl_torch/utils/cuda_graph.py),
// which takes the host's launch cost out; inside a launch, the state, key
// and yaw loads of frame 0 are issued before the move-table fill and its
// barrier (run_frames), so their latency overlaps the fill.  The wrappers
// may write the new state over the old (each thread reads its env's leaves
// before it writes them), so a captured frame keeps fixed addresses.

// Numerics: float32 only (the float64 parity mode is the plain versions'
// job).  Build with -fmad=false: the plain versions and the JAX reference
// round every product before the following add, and a fused multiply-add
// here changes z_pos by an ulp, which can flip the z_pos < FLOOR_HEIGHT
// ground test and with it a jump.  Float literals carry the f suffix so no
// expression is promoted to double; sincosf/sqrtf and the divides are the
// IEEE-accurate versions (no --use_fast_math).  Scalars that the plain version folds in
// double before rounding once to float32 (1 - time_limit, 2 pi, ...)
// arrive from Python already rounded.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxKeys = 4;
constexpr int kThreads = 64;
// rollout_random: frames whose actions one Philox call draws.
constexpr int kFramesPerDraw = 3;
// The move table: strafe = s/2 for s in -2..2, forward = f/2 for f in 0..2.
constexpr int kMoveTable = 5 * 3;
static_assert(kThreads >= kMoveTable, "one thread fills each table entry");

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

template <int K>
__device__ __forceinline__ Env load_env(const Leaves& s, int i, int n) {
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
    e.last_keys[j] = j < K ? s.last_keys[j * n + i] : 0;
    e.last_press[j] = j < K ? s.last_key_press_time[j * n + i] : 0.0f;
  }
  return e;
}

// Whether every key latch is 0 or 1.  A step leaves them so (each latch
// takes the frame's key, an action masked to one bit) and so does a reset;
// a state made otherwise takes its first frame through env_step's
// kAnyLatch path.  Each kernel keeps that case out of its main T loop, a
// copy of the loop entered only from a frame-0 state that holds bits, so
// the compiler schedules the main loop as if the case did not exist.
template <int K>
__device__ __forceinline__ bool latches_are_bits(const Env& e) {
  bool bits = true;
#pragma unroll
  for (int j = 0; j < K; ++j) bits = bits && (unsigned)e.last_keys[j] <= 1u;
  return bits;
}

template <int K>
__device__ __forceinline__ void store_env(const Leaves& s, const Env& e, int i,
                                          int n) {
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
  for (int j = 0; j < K; ++j) {
    s.last_keys[j * n + i] = e.last_keys[j];
    s.last_key_press_time[j * n + i] = e.last_press[j];
  }
}

// The (smove, fmove) pair of each key state, at (s + 2) * 3 + f for strafe
// s/2 and forward f/2: the plain version's truncation through int32 of
// smove_max * strafe and fmove_max * forward, whose operands are exactly
// these halves (env/core.py:_decode).  Filled by the block's first threads;
// every thread of the block waits for it.
__device__ __forceinline__ void fill_move_table(float2* moves,
                                                const Params& p) {
  const int j = threadIdx.x;
  if (j < kMoveTable) {
    const float strafe = 0.5f * (float)(j / 3 - 2);
    const float forward = 0.5f * (float)(j % 3);
    moves[j] = make_float2((float)(int)(p.smove_max * strafe),
                           (float)(int)(p.fmove_max * forward));
  }
  __syncthreads();
}

// One frame of env/core.py:step: decode the actions, move the player,
// return the reward and set `done` from the episode clock.  `moves` is the
// block's move table (fill_move_table), which serves key latches of 0 and
// 1; with kAnyLatch the step takes smove and fmove from the plain version's
// operations instead, which hold for a latch of any value.
template <int K, bool kAnyLatch = false>
__device__ __forceinline__ float env_step(Env& e, const int (&key_in)[K],
                                          float yaw_action,
                                          const float2* moves,
                                          const Params& p, bool& done) {
  static_assert(K == 3 || K == 4, "the strafe and forward keys must exist");
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
  int keys[K], last[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool elapsed =
        current_time >= e.last_press[j] + p.key_press_delay;
    const int key = key_in[j] & ((elapsed || e.last_keys[j] > 0) ? 1 : 0);
    if (key > 0 && e.last_keys[j] == 0) e.last_press[j] = current_time;
    keys[j] = key;
    last[j] = e.last_keys[j];
    e.last_keys[j] = key;
  }
  e.yaw = e.yaw + mouse_x;
  float smove, fmove;
  if (kAnyLatch) {
    float smoothed[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // The sum wraps as the plain version's int32 sum does.
      smoothed[j] =
          smooth_keys ? (float)(int)((unsigned)keys[j] + (unsigned)last[j]) *
                            0.5f
                      : (float)keys[j];
    }
    const float strafe = smoothed[kStrafeRight] - smoothed[kStrafeLeft];
    smove = (float)(int)(p.smove_max * strafe);
    fmove = (float)(int)(p.fmove_max * smoothed[kForward]);
  } else {
    // Twice the plain version's smoothed strafe and forward, (key + last) *
    // 0.5 each with smooth_keys, else the key: integers whose halves are
    // the plain version's values exactly, so the table holds its smove and
    // fmove.
    const int strafe2 =
        smooth_keys ? (keys[kStrafeRight] + last[kStrafeRight]) -
                          (keys[kStrafeLeft] + last[kStrafeLeft])
                    : 2 * (keys[kStrafeRight] - keys[kStrafeLeft]);
    const int forward2 =
        smooth_keys ? keys[kForward] + last[kForward] : 2 * keys[kForward];
    const float2 move = moves[(strafe2 + 2) * 3 + forward2];
    smove = move.x;
    fmove = move.y;
  }
  // The jump key exists only where K = 4 (env/config.py:num_keys).
  const bool jump_key = K > kJump && keys[kJump % K] > 0;
  const bool jump = auto_jump ? e.vz <= 16.0f : allow_jump && jump_key;

  // --- horizontal physics (phys.py:air_move), pitch = roll = 0 ---
  // With pitch = roll = 0, angle_vectors gives exactly
  // f = (cy, sy) and r = (sy, -cy).  sincosf shares one range reduction
  // and gives sinf's and cosf's bits.
  const float angle = e.yaw * kDegToRad;
  float sy, cy;
  sincosf(angle, &sy, &cy);
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
template <int K>
__device__ __forceinline__ void reset_env(Env& e, float u_zs, float u_yaw,
                                          float u_time, float u_speed,
                                          float u_angle, const Params& p) {
  const bool zero_start = u_zs < p.zero_start_prob;
  float speed = zero_start ? 0.0f : p.speed_hi + p.speed_span * u_speed;
  float move_angle = p.angle_hi + p.angle_span * u_angle;
  if (p.flags & kHover) {
    speed = p.hover_speed;
    move_angle = p.hover_angle;
  }
  float sa, ca;
  sincosf(move_angle, &sa, &ca);
  e.z = p.initial_z;
  e.vx = speed * ca;
  e.vy = speed * sa;
  e.vz = p.initial_vz;
  e.on_ground = false;
  e.jump_released = true;
  e.yaw = zero_start ? p.initial_yaw_zero : p.yaw_lo + p.yaw_span * u_yaw;
  e.time_remaining =
      zero_start ? p.time_limit : p.time_limit + p.time_span * u_time;
  e.zero_start = zero_start;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    e.last_keys[j] = 0;
    e.last_press[j] = p.reset_press_time;
  }
}

// One frame's streamed actions of env i: K keys and the yaw action.
template <int K>
struct Actions {
  int keys[K];
  float yaw;
};

template <int K>
__device__ __forceinline__ Actions<K> load_actions(
    const int32_t* __restrict__ key_actions,
    const float* __restrict__ yaw_actions, int t, int i, int n) {
  Actions<K> a;
#pragma unroll
  for (int j = 0; j < K; ++j) a.keys[j] = key_actions[(t * K + j) * n + i];
  a.yaw = yaw_actions[t * n + i];
  return a;
}

// The T loop of rollout_actions_kernel and rollout_autoreset_kernel.  The
// scoring, analysis and PPO-rollout loops launch them at T=1, one env step
// per launch, so a launch's time is its latency: the state, key and yaw
// loads of frame 0 are issued before the block fills its move table and
// waits at the barrier, and their global-memory latency overlaps the fill.
// A thread past the last env loads nothing but still meets the barrier.
// Frame 0 takes the plain conversions where a key latch is not 0 or 1
// (latches_are_bits); every later frame finds bits.  `after_step(t, e,
// done)` runs after each step (the auto-reset).
template <int K, typename AfterStep>
__device__ __forceinline__ void run_frames(
    const Leaves& in, const Leaves& out,
    const int32_t* __restrict__ key_actions,
    const float* __restrict__ yaw_actions, float* __restrict__ rewards,
    uint8_t* __restrict__ dones, int n, int t_steps, const Params& p,
    AfterStep after_step) {
  __shared__ float2 moves[kMoveTable];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  Env e;
  Actions<K> first;
  if (live) {
    e = load_env<K>(in, i, n);
    if (t_steps > 0) first = load_actions<K>(key_actions, yaw_actions, 0, i, n);
  }
  fill_move_table(moves, p);
  if (!live) return;
  auto frame = [&](int t, const Actions<K>& a, auto any_latch) {
    bool done;
    rewards[t * n + i] = env_step<K, decltype(any_latch)::value>(
        e, a.keys, a.yaw, moves, p, done);
    dones[t * n + i] = done;
    after_step(t, e, done);
  };
  if (t_steps > 0) {
    if (latches_are_bits<K>(e)) {
      frame(0, first, std::false_type{});
    } else {  // a hand-made latch: see latches_are_bits
      frame(0, first, std::true_type{});
    }
  }
  for (int t = 1; t < t_steps; ++t) {
    frame(t, load_actions<K>(key_actions, yaw_actions, t, i, n),
          std::false_type{});
  }
  store_env<K>(out, e, i, n);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
rollout_actions_kernel(Leaves in, Leaves out,
                       const int32_t* __restrict__ key_actions,  // (T, K, N)
                       const float* __restrict__ yaw_actions,    // (T, N)
                       float* __restrict__ rewards,              // (T, N)
                       uint8_t* __restrict__ dones,              // (T, N)
                       int n, int t_steps, Params p) {
  run_frames<K>(in, out, key_actions, yaw_actions, rewards, dones, n,
                t_steps, p, [](int, Env&, bool) {});
}

template <int K>
__global__ void __launch_bounds__(kThreads)
rollout_autoreset_kernel(Leaves in, Leaves out,
                         const int32_t* __restrict__ key_actions,  // (T, K, N)
                         const float* __restrict__ yaw_actions,    // (T, N)
                         const float* __restrict__ reset_uniforms, // (T, 5, N)
                         float* __restrict__ rewards,              // (T, N)
                         uint8_t* __restrict__ dones,              // (T, N)
                         int n, int t_steps, Params p) {
  run_frames<K>(in, out, key_actions, yaw_actions, rewards, dones, n,
                t_steps, p, [&](int t, Env& e, bool done) {
                  if (done) {
                    const int i = blockIdx.x * blockDim.x + threadIdx.x;
                    const float* u = reset_uniforms + (size_t)t * 5 * n + i;
                    reset_env<K>(e, u[0], u[n], u[2 * n], u[3 * n], u[4 * n],
                                 p);
                  }
                });
}

// The draw layout, under key (seed, 0).  Env i's frames 3m, 3m+1 and 3m+2
// (m = 0, 1, ...) take their actions from one call at counter (i, m, 0, 0):
// word x holds key j of frame 3m+f in bit 4f+j, and words y, z and w hold
// the three frames' yaw uniforms in their top 24 bits.  An episode that
// ends at frame t re-draws from one call at counter (i, t, 1, 0): zero
// start, yaw, time and speed from the top 24 bits of x, y, z and w, and
// the angle from their low bytes, (x & 0xFF) << 16 | (y & 0xFF) << 8 |
// (z & 0xFF), times 2^-24.  The plain version, env_rollout.py:
// random_frame_inputs, draws the same bits.
template <int K>
__global__ void __launch_bounds__(kThreads)
rollout_random_kernel(Leaves in, Leaves out,
                      float* __restrict__ reward_sum,    // (N,)
                      int32_t* __restrict__ done_count,  // (N,)
                      int n, int t_steps, uint32_t seed, Params p) {
  static_assert(4 * (kFramesPerDraw - 1) + K <= 32, "key bits fit word x");
  __shared__ float2 moves[kMoveTable];
  fill_move_table(moves, p);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2 key = make_uint2(seed, 0u);
  Env e = load_env<K>(in, i, n);
  float reward_acc = 0.0f;
  int done_acc = 0;
  // The current call's words, shifted after each frame so that x's low
  // bits and y hold the next frame's draws.
  uint4 draw = make_uint4(0u, 0u, 0u, 0u);
  uint32_t call = 0;
  int used = kFramesPerDraw;  // frames of `draw` used
  auto frame = [&](int t, auto any_latch) {
    if (used == kFramesPerDraw) {  // uniform across the warp
      draw = q1::philox4x32_10(make_uint4((uint32_t)i, call, 0u, 0u), key);
      call += 1;
      used = 0;
    }
    int keys[K];
#pragma unroll
    for (int j = 0; j < K; ++j) keys[j] = (int)((draw.x >> j) & 1u);
    const float yaw_action =
        (q1::uniform_from_bits(draw.y) * 2.0f - 1.0f) * p.action_range;
    draw = make_uint4(draw.x >> 4, draw.z, draw.w, 0u);
    used += 1;
    bool done;
    reward_acc = reward_acc + env_step<K, decltype(any_latch)::value>(
                                  e, keys, yaw_action, moves, p, done);
    if (done) {
      done_acc += 1;
      const uint4 r =
          q1::philox4x32_10(make_uint4((uint32_t)i, (uint32_t)t, 1u, 0u), key);
      reset_env<K>(e, q1::uniform_from_bits(r.x), q1::uniform_from_bits(r.y),
                   q1::uniform_from_bits(r.z), q1::uniform_from_bits(r.w),
                   q1::uniform_from_low_bytes(r.x, r.y, r.z), p);
    }
  };
  if (latches_are_bits<K>(e)) {
    for (int t = 0; t < t_steps; ++t) frame(t, std::false_type{});
  } else if (t_steps > 0) {  // a hand-made latch: see latches_are_bits
    frame(0, std::true_type{});
    for (int t = 1; t < t_steps; ++t) frame(t, std::false_type{});
  }
  store_env<K>(out, e, i, n);
  reward_sum[i] = reward_acc;
  done_count[i] = done_acc;
}

bool bad_shape(int n, int t_steps, int k) {
  return (k != 3 && k != 4) || n < 0 || t_steps < 0;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points, loaded with ctypes.  Pointers are device pointers
// unless named otherwise; `stream` is a cudaStream_t.  Each returns the
// cudaError_t of its launch (0 on success) and launches nothing for n == 0.
// The number of keys k is 3 or 4.

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
  auto kernel =
      k == 3 ? rollout_actions_kernel<3> : rollout_actions_kernel<4>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      in, out, key_actions, yaw_actions, rewards, dones, n, t_steps, p);
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
  auto kernel =
      k == 3 ? rollout_autoreset_kernel<3> : rollout_autoreset_kernel<4>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      leaves_from(in), leaves_from(out), key_actions, yaw_actions,
      reset_uniforms, rewards, dones, n, t_steps,
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
  auto kernel = k == 3 ? rollout_random_kernel<3> : rollout_random_kernel<4>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      leaves_from(in), leaves_from(out), reward_sum, done_count, n, t_steps,
      seed, params_from(fparams, discrete_yaw_steps, flags));
  return (int)cudaGetLastError();
}

// How a launch of n envs runs: out[0] threads per block, out[1] blocks,
// out[2] blocks resident per SM (the runtime's occupancy query).  `kernel`
// is 0 (rollout_actions), 1 (rollout_actions_autoreset) or 2
// (rollout_random), the ids of env_rollout.py:_KERNEL_IDS; the shapes of
// chip_smoke.py's tail line.
extern "C" int q1_launch_shape(int kernel, int n, int k, int* out) {
  if (bad_shape(n, 0, k) || kernel < 0 || kernel > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const void* fns[3][2] = {
      {(const void*)rollout_actions_kernel<3>,
       (const void*)rollout_actions_kernel<4>},
      {(const void*)rollout_autoreset_kernel<3>,
       (const void*)rollout_autoreset_kernel<4>},
      {(const void*)rollout_random_kernel<3>,
       (const void*)rollout_random_kernel<4>}};
  out[0] = kThreads;
  out[1] = blocks_for(n);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fns[kernel][k - 3], kThreads, 0);
}

// The frames whose actions one rollout_random Philox call draws: the
// wrapper holds its plain version's FRAMES_PER_DRAW to it.
extern "C" int q1_frames_per_draw() { return kFramesPerDraw; }

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
