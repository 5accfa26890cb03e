"""Fused T-step env rollout: the CUDA kernel, its wrapper and its plain version.

:func:`rollout_actions` advances N envs T frames with streamed actions and
no reset.  It replaces the JAX package's Pallas TPU kernel
``ops/env_rollout_pallas.py:rollout_actions`` and computes
the same function as :func:`rollout_actions_plain`, a loop of
``env.core.step(compute_observation=False)``.

- On CUDA tensors it launches the hand-written kernel in
  ``csrc/env_rollout.cu`` (one thread per env, state held in registers
  across the T loop) or raises.
- On CPU tensors it runs :func:`rollout_actions_plain`.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``q1physrl_torch/_build/``
(named by a hash of the source and flags, so an edited source rebuilds),
and is loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import phys
from ..env import core as env_core
from ..env.config import Config

__all__ = ("rollout_actions", "rollout_actions_plain", "build")

_SOURCE = Path(__file__).resolve().parent / "csrc" / "env_rollout.cu"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# -fmad=false: see the note on numerics at the top of the source.
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")

# Config flag bits, as csrc/env_rollout.cu reads them.
_ALLOW_YAW, _SMOOTH_KEYS, _AUTO_JUMP, _ALLOW_JUMP, _HOVER, _SPEED_REWARD = (
    1, 2, 4, 8, 16, 32)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA rollout kernel cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def build() -> Path:
    """Compile ``csrc/env_rollout.cu`` unless a library built from the same
    source and flags exists; return the library's path.

    The compiler's ``-Xptxas=-v`` report (registers, spills) is kept beside
    the library as ``<name>.log``.
    """
    source = _SOURCE.read_bytes()
    tag = hashlib.sha1(source + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    lib = _BUILD_DIR / f"env_rollout-{tag[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    fn = lib.q1_rollout_actions
    fn.argtypes = ([ctypes.c_void_p] * 24
                   + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 7
                   + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _flags(cfg: Config) -> int:
    return ((_ALLOW_YAW if cfg.allow_yaw else 0)
            | (_SMOOTH_KEYS if cfg.smooth_keys else 0)
            | (_AUTO_JUMP if cfg.auto_jump else 0)
            | (_ALLOW_JUMP if cfg.allow_jump else 0)
            | (_HOVER if cfg.hover else 0)
            | (_SPEED_REWARD if cfg.speed_reward else 0))


def _state_leaves(state: env_core.EnvState):
    """The leaves the step reads and writes, in the C argument order.
    ``zero_start`` is not among them: the step carries it unchanged."""
    p = state.player
    return (p.z_pos, p.vel_x, p.vel_y, p.vel_z, p.on_ground, p.jump_released,
            state.yaw, state.time_remaining, state.last_keys,
            state.last_key_press_time)


def _check(cfg: Config, state: env_core.EnvState, key_actions, yaw_actions):
    """Raise unless the arguments are what the kernel takes: float32 state
    with bool flags and int32 key latches, (T, K, N) int32 key actions,
    (T, N) float32 yaw actions, all contiguous and on one device."""
    n, k = state.num_envs, cfg.num_keys
    if n < 1:
        raise ValueError("rollout_actions needs at least one env")
    if key_actions.dim() != 3 or tuple(key_actions.shape[1:]) != (k, n):
        raise ValueError(f"key_actions must be (T, {k}, {n}), got "
                         f"{tuple(key_actions.shape)}")
    t = key_actions.shape[0]
    if t < 1:
        raise ValueError("rollout_actions needs at least one step")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    expected = [
        ("key_actions", key_actions, i32, (t, k, n)),
        ("yaw_actions", yaw_actions, f32, (t, n)),
        ("zero_start", state.zero_start, b, (n,)),
    ]
    names = ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground", "jump_released",
             "yaw", "time_remaining", "last_keys", "last_key_press_time")
    dtypes = (f32, f32, f32, f32, b, b, f32, f32, i32, f32)
    shapes = [(n,)] * 8 + [(k, n)] * 2
    expected += list(zip(names, _state_leaves(state), dtypes, shapes))
    device = yaw_actions.device
    for name, x, dtype, shape in expected:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, yaw_actions on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, t, k


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
                    yaw_actions):
    """Fused T-step rollout with streamed actions (no auto-reset).

    Args:
        key_actions: (T, K, N) int32.
        yaw_actions: (T, N) float32.

    Returns: (EnvState, rewards (T, N) float32, dones (T, N) bool) — equal
    to a loop of ``core.step`` with ``compute_observation=False``.

    CUDA tensors go through the kernel, and ``rollout_actions.launches``
    counts its launches; CPU tensors go through the plain version.
    """
    n, t, k = _check(cfg, state, key_actions, yaw_actions)
    device = yaw_actions.device
    if device.type == "cpu":
        return rollout_actions_plain(cfg, state, key_actions, yaw_actions)
    if device.type != "cuda":
        raise ValueError(f"rollout_actions runs on cuda or cpu, not {device}")

    fn = _library().q1_rollout_actions
    leaves = _state_leaves(state)
    outs = tuple(torch.empty_like(x) for x in leaves)
    rewards = torch.empty((t, n), dtype=torch.float32, device=device)
    dones = torch.empty((t, n), dtype=torch.bool, device=device)
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
    if err != 0:
        raise RuntimeError(f"env rollout kernel launch failed: CUDA error "
                           f"{err}")
    rollout_actions.launches += 1

    z, vx, vy, vz, og, jr, yaw, tr, lk, lkpt = outs
    new_state = env_core.EnvState(
        player=phys.PlayerState(z_pos=z, vel_x=vx, vel_y=vy, vel_z=vz,
                                on_ground=og, jump_released=jr),
        yaw=yaw, time_remaining=tr, zero_start=state.zero_start,
        last_keys=lk, last_key_press_time=lkpt)
    return new_state, rewards, dones


rollout_actions.launches = 0
