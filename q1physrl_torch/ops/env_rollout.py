"""Fused T-step env rollouts: the CUDA kernels, their wrappers and their
plain versions.

Three kernels in ``csrc/env_rollout.cu`` share one env step and one episode
reset:

- :func:`rollout_actions` advances N envs T frames with streamed actions and
  no reset.  It replaces the JAX package's Pallas TPU kernel
  ``ops/env_rollout_pallas.py:rollout_actions``; plain version
  :func:`rollout_actions_plain`, a loop of
  ``env.core.step(compute_observation=False)``.  The scoring path runs it.
- :func:`rollout_actions_autoreset` adds the auto-reset from streamed
  uniforms.  It replaces ``rollout_actions_autoreset``; plain version
  :func:`rollout_actions_autoreset_plain`, a loop of
  ``env.core.step_autoreset(reset_uniforms=ru[t])``.  The PPO rollout runs
  it once per frame (T=1).
- :func:`rollout_random` draws its actions and reset uniforms in the kernel
  from Philox4x32-10 and returns only the state, a per-env reward sum and
  the done count.  It replaces ``rollout_random``; plain version
  :func:`rollout_random_plain`, which draws the same bits with
  :func:`philox4x32_10` (layout: :func:`random_frame_inputs`).  The port's
  bench times it.

On CUDA tensors each wrapper launches its kernel (one thread per env, state
held in registers across the T loop) or raises, and adds one to its
``launches`` count; on CPU tensors it runs the plain version.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``q1physrl_torch/_build/``
(named by a hash of the sources and flags, so an edited source rebuilds),
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import phys
from ..env import core as env_core
from ..env.config import INITIAL_STATE, INITIAL_YAW_ZERO, Config

__all__ = ("rollout_actions", "rollout_actions_plain",
           "rollout_actions_autoreset", "rollout_actions_autoreset_plain",
           "rollout_random", "rollout_random_plain", "random_frame_inputs",
           "FRAMES_PER_DRAW", "philox4x32_10", "uniform_from_bits",
           "uniform_from_low_bytes", "launch_shape", "build", "build_all",
           "compile_library")

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# Each library and its source.  philox_check holds curand's Philox, the
# yardstick chip_smoke.py compares the kernels' own with; no path runs it.
_SOURCES = {"env_rollout": "env_rollout.cu", "philox_check": "philox_check.cu"}

# -fmad=false: see the note on numerics at the top of the source.
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")

# Config flag bits, as csrc/env_rollout.cu reads them.
_ALLOW_YAW, _SMOOTH_KEYS, _AUTO_JUMP, _ALLOW_JUMP, _HOVER, _SPEED_REWARD = (
    1, 2, 4, 8, 16, 32)

# Philox4x32-10 constants (csrc/philox.cuh).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
# Frames whose actions one Philox call draws: the plain version's layout,
# held to the library's kFramesPerDraw when it loads (_library).
FRAMES_PER_DRAW = 3


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA rollout kernels cannot "
                           "be built (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _library_path(name: str) -> Path:
    """Where library ``name`` lives once built: tagged by a hash of its
    source, the shared headers and the flags."""
    source = (_CSRC / _SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha1(source + headers
                       + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"{name}-{tag[:16]}.so"


def _nvcc_command(source, out, include) -> list:
    return [_nvcc(), *_NVCC_FLAGS, "-I", str(include), "-o", str(out),
            str(source)]


def build_all(names=tuple(_SOURCES)) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together; return {name: path}.

    The compiler's ``-Xptxas=-v`` report (registers, spills) is kept beside
    each library as ``<name>.log``.
    """
    libs = {name: _library_path(name) for name in names}
    jobs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = _nvcc_command(_CSRC / _SOURCES[name], tmp, _CSRC)
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    errors = []
    for name, (tmp, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {_SOURCES[name]} "
                          f"({proc.returncode}):\n{err}")
            continue
        libs[name].with_suffix(".log").write_text(out + err)
        os.replace(tmp, libs[name])  # atomic: a concurrent build sees all
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def build(name: str = "env_rollout") -> Path:
    """Compile library ``name`` unless it is built; return its path."""
    return build_all((name,))[name]


def compile_library(source, out, include=None) -> Path:
    """Compile the CUDA source ``source`` with the rollout library's flags
    into the shared library ``out``, its headers from ``include`` (default:
    the source's directory), and keep the compiler's ``-Xptxas=-v`` report
    beside it as ``<out>.log``; return ``out``.  For builds of another copy
    of ``csrc/`` or of a check's own source (``scripts/``)."""
    source, out = Path(source), Path(out)
    include = source.parent if include is None else include
    proc = subprocess.run(_nvcc_command(source, out, include),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.q1_rollout_actions.argtypes = ([ptr] * 24 + [i32] * 3 + [f32] * 7
                                       + [i32] * 2 + [ptr])
    lib.q1_rollout_actions_autoreset.argtypes = ([ptr] * 7 + [i32] * 3
                                                 + [ptr] + [i32] * 2 + [ptr])
    lib.q1_rollout_random.argtypes = ([ptr] * 4 + [i32] * 3 + [ptr]
                                      + [i32] * 2 + [ctypes.c_uint, ptr])
    lib.q1_philox.argtypes = [ptr, ptr, i32, ctypes.c_uint, ctypes.c_uint,
                              ptr]
    lib.q1_launch_shape.argtypes = [i32, i32, i32, ptr]
    lib.q1_frames_per_draw.argtypes = []
    for fn in (lib.q1_rollout_actions, lib.q1_rollout_actions_autoreset,
               lib.q1_rollout_random, lib.q1_philox, lib.q1_launch_shape,
               lib.q1_frames_per_draw):
        fn.restype = i32
    if lib.q1_frames_per_draw() != FRAMES_PER_DRAW:
        raise RuntimeError(
            f"the library draws {lib.q1_frames_per_draw()} frames per Philox "
            f"call, the plain version FRAMES_PER_DRAW = {FRAMES_PER_DRAW}")
    return lib


# The kernel ids of the library's q1_launch_shape.
_KERNEL_IDS = {"rollout_actions": 0, "rollout_actions_autoreset": 1,
               "rollout_random": 2}


def launch_shape(kernel: str, n: int, num_keys: int = 4) -> dict:
    """How the library launches ``kernel`` on n envs, on the current card:
    threads per block, blocks, blocks resident per SM (the runtime's
    occupancy query), SMs, and the waves of resident blocks the launch
    takes."""
    out = (ctypes.c_int * 3)()
    _raise_on(_library().q1_launch_shape(_KERNEL_IDS[kernel], n, num_keys,
                                         out))
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    threads, blocks, per_sm = out
    return {"threads_per_block": threads, "blocks": blocks,
            "blocks_per_sm": per_sm, "sms": sms,
            "waves": blocks / (per_sm * sms)}


def _flags(cfg: Config) -> int:
    return ((_ALLOW_YAW if cfg.allow_yaw else 0)
            | (_SMOOTH_KEYS if cfg.smooth_keys else 0)
            | (_AUTO_JUMP if cfg.auto_jump else 0)
            | (_ALLOW_JUMP if cfg.allow_jump else 0)
            | (_HOVER if cfg.hover else 0)
            | (_SPEED_REWARD if cfg.speed_reward else 0))


def _float_params(cfg: Config):
    """The 21 floats of the kernels' ``Params``, in its order.  Each is
    computed in double, as the plain version folds it before torch rounds
    it to float32, and ``ctypes.c_float`` rounds it once."""
    lo, hi = cfg.initial_yaw_range
    values = (
        cfg.time_delta, cfg.time_limit, env_core.max_yaw_delta(cfg),
        cfg.action_range, cfg.fmove_max, cfg.smove_max, cfg.key_press_delay,
        cfg.zero_start_prob, lo, hi - lo, 1.0 - cfg.time_limit,
        cfg.max_initial_speed, 1.0 - cfg.max_initial_speed,
        2 * math.pi, 1.0 - 2 * math.pi,
        INITIAL_STATE["z_pos"], INITIAL_STATE["vel"][2], INITIAL_YAW_ZERO,
        -cfg.key_press_delay, 320.0, math.pi / 2)
    return (ctypes.c_float * len(values))(*values)


_LEAF_NAMES = ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
               "jump_released", "yaw", "time_remaining", "zero_start",
               "last_keys", "last_key_press_time")


def _state_leaves(state: env_core.EnvState):
    """The leaves ``rollout_actions`` reads and writes, in its C argument
    order.  ``zero_start`` is not among them: the step carries it
    unchanged."""
    leaves = state.leaves()
    return leaves[:8] + leaves[9:]


def _state_from(leaves) -> env_core.EnvState:
    z, vx, vy, vz, og, jr, yaw, tr, zs, lk, lkpt = leaves
    return env_core.EnvState(
        player=phys.PlayerState(z_pos=z, vel_x=vx, vel_y=vy, vel_z=vz,
                                on_ground=og, jump_released=jr),
        yaw=yaw, time_remaining=tr, zero_start=zs, last_keys=lk,
        last_key_press_time=lkpt)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))


def _check_state(cfg: Config, state: env_core.EnvState, device, extra=()):
    """Raise unless the state and the ``extra`` (name, tensor, dtype, shape)
    arguments are what the kernels take: float32 state with bool flags and
    int32 key latches, all contiguous and on ``device``."""
    n, k = state.num_envs, cfg.num_keys
    if n < 1:
        raise ValueError("the env rollout needs at least one env")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    dtypes = (f32, f32, f32, f32, b, b, f32, f32, b, i32, f32)
    shapes = [(n,)] * 9 + [(k, n)] * 2
    expected = list(extra) + list(zip(_LEAF_NAMES, state.leaves(),
                                      dtypes, shapes))
    for name, x, dtype, shape in expected:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, k


def _check(cfg: Config, state: env_core.EnvState, key_actions, yaw_actions,
           reset_uniforms=None):
    """Raise unless the arguments are what the kernels take, with (T, K, N)
    int32 key actions, (T, N) float32 yaw actions and, where given, (T, 5,
    N) float32 reset uniforms, all on the yaw actions' device."""
    n, k = state.num_envs, cfg.num_keys
    if key_actions.dim() != 3 or tuple(key_actions.shape[1:]) != (k, n):
        raise ValueError(f"key_actions must be (T, {k}, {n}), got "
                         f"{tuple(key_actions.shape)}")
    t = key_actions.shape[0]
    if t < 1:
        raise ValueError("the env rollout needs at least one step")
    extra = [("key_actions", key_actions, torch.int32, (t, k, n)),
             ("yaw_actions", yaw_actions, torch.float32, (t, n))]
    if reset_uniforms is not None:
        extra.append(("reset_uniforms", reset_uniforms, torch.float32,
                      (t, 5, n)))
    _check_state(cfg, state, yaw_actions.device, extra)
    return n, t, k


def _check_out(cfg: Config, out, n, t, device):
    """Raise unless ``out`` is an (EnvState, rewards (T, N) float32, dones
    (T, N) bool) the kernels can write, on ``device``."""
    state, rewards, dones = out
    _check_state(cfg, state, device,
                 [("rewards out", rewards, torch.float32, (t, n)),
                  ("dones out", dones, torch.bool, (t, n))])


def _write_out(result, out):
    """Copy the plain version's ``result`` into ``out``; return ``out``."""
    for o, x in zip(out, result):
        o.copy_(x)
    return out


def _cuda_device(device, name):
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")


def _raise_on(err):
    if err != 0:
        raise RuntimeError(f"env rollout kernel launch failed: CUDA error "
                           f"{err}")


# --- rollout_actions ------------------------------------------------------


def rollout_actions_plain(cfg: Config, state: env_core.EnvState, key_actions,
                          yaw_actions):
    """The plain version: a loop of ``core.step`` over T.  Any dtype and
    device; float64 state gives the parity mode."""
    rewards, dones = [], []
    for t in range(key_actions.shape[0]):
        state, out = env_core.step(cfg, state, key_actions[t], yaw_actions[t],
                                   compute_observation=False)
        rewards.append(out.reward)
        dones.append(out.done)
    return state, torch.stack(rewards), torch.stack(dones)


def rollout_actions(cfg: Config, state: env_core.EnvState, key_actions,
                    yaw_actions, out=None):
    """Fused T-step rollout with streamed actions (no auto-reset).

    Args:
        key_actions: (T, K, N) int32.
        yaw_actions: (T, N) float32.
        out: optional (EnvState, rewards, dones) to write the result into
            and return; its state may be ``state`` itself (each env's
            leaves are read before they are written).  A loop captured as
            a CUDA graph writes so to fixed addresses.

    Returns: (EnvState, rewards (T, N) float32, dones (T, N) bool) — equal
    to a loop of ``core.step`` with ``compute_observation=False``.

    CUDA tensors go through the kernel, and ``rollout_actions.launches``
    counts its launches; CPU tensors go through the plain version.
    """
    n, t, k = _check(cfg, state, key_actions, yaw_actions)
    device = yaw_actions.device
    if out is not None:
        _check_out(cfg, out, n, t, device)
    if device.type == "cpu":
        result = rollout_actions_plain(cfg, state, key_actions, yaw_actions)
        return result if out is None else _write_out(result, out)
    _cuda_device(device, "rollout_actions")

    fn = _library().q1_rollout_actions
    leaves = _state_leaves(state)
    if out is None:
        outs = tuple(torch.empty_like(x) for x in leaves)
        rewards = torch.empty((t, n), dtype=torch.float32, device=device)
        dones = torch.empty((t, n), dtype=torch.bool, device=device)
        zero_start = state.zero_start
    else:
        outs = _state_leaves(out[0])
        rewards, dones = out[1:]
        zero_start = out[0].zero_start
        if zero_start.data_ptr() != state.zero_start.data_ptr():
            zero_start.copy_(state.zero_start)
    with torch.cuda.device(device):
        err = fn(*(x.data_ptr() for x in leaves),
                 *(x.data_ptr() for x in outs),
                 key_actions.data_ptr(), yaw_actions.data_ptr(),
                 rewards.data_ptr(), dones.data_ptr(),
                 n, t, k,
                 cfg.time_delta, cfg.time_limit, env_core.max_yaw_delta(cfg),
                 cfg.action_range, cfg.fmove_max, cfg.smove_max,
                 cfg.key_press_delay, cfg.discrete_yaw_steps, _flags(cfg),
                 torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err)
    rollout_actions.launches += 1
    if out is not None:
        return out
    leaves = outs[:8] + (zero_start,) + outs[8:]
    return _state_from(leaves), rewards, dones


rollout_actions.launches = 0


# --- rollout_actions_autoreset --------------------------------------------


def rollout_actions_autoreset_plain(cfg: Config, state: env_core.EnvState,
                                    key_actions, yaw_actions,
                                    reset_uniforms):
    """The plain version: a loop of ``core.step_autoreset`` with the frame's
    reset uniforms.  Any dtype and device."""
    rewards, dones = [], []
    for t in range(key_actions.shape[0]):
        state, out = env_core.step_autoreset(
            cfg, state, key_actions[t], yaw_actions[t],
            compute_observation=False, reset_uniforms=reset_uniforms[t])
        rewards.append(out.reward)
        dones.append(out.done)
    return state, torch.stack(rewards), torch.stack(dones)


def rollout_actions_autoreset(cfg: Config, state: env_core.EnvState,
                              key_actions, yaw_actions, reset_uniforms,
                              out=None):
    """Fused T-step rollout with streamed actions and episode auto-reset
    from streamed uniform draws.

    Args:
        key_actions: (T, K, N) int32.
        yaw_actions: (T, N) float32.
        reset_uniforms: (T, 5, N) float32 uniform-[0, 1) draws, in the
            order of ``core.reset_from_uniforms`` (zero start, yaw, time,
            speed, angle).
        out: as in :func:`rollout_actions`.

    Returns: (EnvState, rewards (T, N) float32, dones (T, N) bool) — equal
    to a loop of ``core.step_autoreset(reset_uniforms=ru[t])``; rewards and
    dones are those from before the reset.

    CUDA tensors go through the kernel, and
    ``rollout_actions_autoreset.launches`` counts its launches; CPU tensors
    go through the plain version.
    """
    n, t, k = _check(cfg, state, key_actions, yaw_actions, reset_uniforms)
    device = yaw_actions.device
    if out is not None:
        _check_out(cfg, out, n, t, device)
    if device.type == "cpu":
        result = rollout_actions_autoreset_plain(cfg, state, key_actions,
                                                 yaw_actions, reset_uniforms)
        return result if out is None else _write_out(result, out)
    _cuda_device(device, "rollout_actions_autoreset")

    fn = _library().q1_rollout_actions_autoreset
    leaves = state.leaves()
    if out is None:
        outs = tuple(torch.empty_like(x) for x in leaves)
        rewards = torch.empty((t, n), dtype=torch.float32, device=device)
        dones = torch.empty((t, n), dtype=torch.bool, device=device)
    else:
        outs = out[0].leaves()
        rewards, dones = out[1:]
    with torch.cuda.device(device):
        err = fn(_pointers(leaves), _pointers(outs), key_actions.data_ptr(),
                 yaw_actions.data_ptr(), reset_uniforms.data_ptr(),
                 rewards.data_ptr(), dones.data_ptr(), n, t, k,
                 _float_params(cfg), cfg.discrete_yaw_steps, _flags(cfg),
                 torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err)
    rollout_actions_autoreset.launches += 1
    return out if out is not None else (_state_from(outs), rewards, dones)


rollout_actions_autoreset.launches = 0


# --- Philox and rollout_random --------------------------------------------


def _mulhilo(m: int, x):
    """High and low words of the 64-bit product of the constant ``m`` and
    ``x``, an int64 tensor of unsigned 32-bit values.  Built from 16-bit
    halves: a full 32x32-bit product overflows int64."""
    m_lo, m_hi = m & 0xFFFF, m >> 16
    x_lo, x_hi = x & 0xFFFF, x >> 16
    ll, lh, hl, hh = x_lo * m_lo, x_lo * m_hi, x_hi * m_lo, x_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11), the plain version of
    ``csrc/philox.cuh``: counter words ``c0..c3`` as int64 tensors of
    unsigned 32-bit values (any broadcastable shapes), key ``(k0, k1)``;
    returns the four output words the same way."""
    m0, m1 = _PHILOX_M
    for r in range(10):
        if r > 0:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(m0, c0)
        hi1, lo1 = _mulhilo(m1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits):
    """Unsigned 32-bit words (int64 tensor) -> float32 uniforms on [0, 1)
    from their top 24 bits."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24


def uniform_from_low_bytes(a, b, c):
    """A float32 uniform on [0, 1) from the low bytes of three unsigned
    32-bit words (int64 tensors): (a & 0xFF) << 16 | (b & 0xFF) << 8 |
    (c & 0xFF), times 2^-24."""
    bits = ((a & 0xFF) << 16) | ((b & 0xFF) << 8) | (c & 0xFF)
    return bits.to(torch.float32) * 2.0 ** -24


def random_frame_inputs(cfg: Config, seed: int, t: int, n: int,
                        device="cpu"):
    """What ``rollout_random``'s kernel draws for frame ``t`` of envs
    0..n-1: Bernoulli(0.5) keys (K, N) int32, yaw actions (N,) float32
    uniform on +-action_range, and the five reset uniforms (5, N) float32
    that the frame's resets use.

    The layout, under key (seed, 0): env i's frames 3m, 3m+1 and 3m+2 take
    their actions from one Philox call at counter (i, m, 0, 0); word x holds
    key j of frame 3m+f in bit 4f+j, and words y, z and w hold the three
    frames' yaw uniforms in their top 24 bits.  A reset at frame t draws one
    call at counter (i, t, 1, 0): zero start, yaw, time and speed from the
    top 24 bits of x, y, z and w, the angle from their low bytes
    (:func:`uniform_from_low_bytes` of x, y, z).  The kernel makes the
    reset's call only where an episode ended, and one action call every
    ``FRAMES_PER_DRAW`` frames."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(i)
    key = (seed & _MASK32, 0)
    call, frame = divmod(t, FRAMES_PER_DRAW)
    w = philox4x32_10(i, zero + call, zero, zero, *key)
    key_actions = torch.stack([((w[0] >> (4 * frame + j)) & 1)
                               .to(torch.int32) for j in range(cfg.num_keys)])
    yaw_actions = ((uniform_from_bits(w[1 + frame]) * 2.0 - 1.0)
                   * cfg.action_range)
    r = philox4x32_10(i, zero + t, zero + 1, zero, *key)
    reset_uniforms = torch.stack([uniform_from_bits(x) for x in r]
                                 + [uniform_from_low_bytes(*r[:3])])
    return key_actions, yaw_actions, reset_uniforms


def rollout_random_plain(cfg: Config, state: env_core.EnvState, t_steps: int,
                         seed: int = 0):
    """The plain version: a loop of ``core.step_autoreset`` on the draws of
    :func:`random_frame_inputs`."""
    n = state.num_envs
    device = state.yaw.device
    reward_sum = torch.zeros(n, dtype=torch.float32, device=device)
    done_count = torch.zeros(n, dtype=torch.int32, device=device)
    for t in range(t_steps):
        ka, ya, ru = random_frame_inputs(cfg, seed, t, n, device)
        state, out = env_core.step_autoreset(cfg, state, ka, ya,
                                             compute_observation=False,
                                             reset_uniforms=ru)
        reward_sum = reward_sum + out.reward
        done_count = done_count + out.done.to(torch.int32)
    return state, reward_sum, done_count.sum()


def rollout_random(cfg: Config, state: env_core.EnvState, t_steps: int,
                   seed: int = 0):
    """Fused T-step rollout with in-kernel random actions and in-kernel
    episode auto-reset: Bernoulli(0.5) keys, uniform yaw on
    +-action_range, and the reset uniforms, all from Philox4x32-10 keyed by
    ``seed``, one call per ``FRAMES_PER_DRAW`` frames of actions and one per
    reset (layout: :func:`random_frame_inputs`).

    Returns (EnvState, reward_sum (N,) float32, done_count () int64).

    CUDA tensors go through the kernel, and ``rollout_random.launches``
    counts its launches; CPU tensors go through the plain version.  The
    kernel is bound by the rate at which the SMs issue instructions, not by
    bytes; its design answers that (``csrc/env_rollout.cu``).
    """
    device = state.yaw.device
    n, k = _check_state(cfg, state, device)
    if t_steps < 1:
        raise ValueError("rollout_random needs at least one step")
    if device.type == "cpu":
        return rollout_random_plain(cfg, state, t_steps, seed)
    _cuda_device(device, "rollout_random")

    fn = _library().q1_rollout_random
    leaves = state.leaves()
    outs = tuple(torch.empty_like(x) for x in leaves)
    reward_sum = torch.empty(n, dtype=torch.float32, device=device)
    done_count = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = fn(_pointers(leaves), _pointers(outs), reward_sum.data_ptr(),
                 done_count.data_ptr(), n, t_steps, k, _float_params(cfg),
                 cfg.discrete_yaw_steps, _flags(cfg), seed & _MASK32,
                 torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err)
    rollout_random.launches += 1
    return _state_from(outs), reward_sum, done_count.sum()


rollout_random.launches = 0


def philox_on_card(counters, key=(0, 0), curand: bool = False):
    """Philox4x32-10 of (4, M) counters (int64 tensor of unsigned 32-bit
    values on a card) by the rollout library's device function, or by
    curand's with ``curand=True``; returns (4, M) the same way.  For
    holding the kernels' generator against :func:`philox4x32_10`."""
    device = counters.device
    _cuda_device(device, "philox_on_card")
    c = counters.to(torch.int32).contiguous()  # wraps to the same bits
    out = torch.empty_like(c)
    if curand:
        lib = ctypes.CDLL(str(build("philox_check")))
        fn = lib.q1_curand_philox
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    else:
        fn = _library().q1_philox
    with torch.cuda.device(device):
        err = fn(c.data_ptr(), out.data_ptr(), c.shape[1], key[0] & _MASK32,
                 key[1] & _MASK32,
                 torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err)
    return out.to(torch.int64) & _MASK32
