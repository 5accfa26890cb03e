"""Functional batched Quake-movement environment on torch tensors.

All mutable state — player physics state, integrated yaw, episode clock,
zero-start flag, and the action decoder's key-latch state — is one explicit
:class:`EnvState`, and every transition is a plain function:

    reset(cfg, generator, n, dtype, device)   -> EnvState
    step(cfg, state, keys, yaw_action)        -> (EnvState, StepResult)
    step_autoreset(cfg, state, keys, yaw_action, reset_uniforms=None,
                   generator=None)            -> (EnvState, StepResult)

Layout: every per-env quantity is a flat ``(N,)`` tensor; per-key decoder
state is ``(K, N)`` with the env axis minor, so that one thread per env
reads neighbouring addresses in the CUDA rollout kernels
(``ops/csrc/env_rollout.cu``), which fuse :func:`step` (the scoring path)
and :func:`step_autoreset` (the training path).  The functions here are
those kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import phys
from .config import (INITIAL_STATE, INITIAL_YAW_ZERO, MAX_YAW_SPEED, Config,
                     Key, get_obs_scale)

__all__ = ("EnvState", "StepResult", "reset", "reset_from_uniforms", "step",
           "merge_reset", "step_autoreset", "compute_obs", "decode_actions",
           "max_yaw_delta")


@dataclasses.dataclass
class EnvState:
    """All environment state for N lockstep envs."""

    player: phys.PlayerState
    yaw: torch.Tensor                  # (N,) integrated view yaw, degrees
    time_remaining: torch.Tensor       # (N,) seconds
    zero_start: torch.Tensor           # (N,) bool
    last_keys: torch.Tensor            # (K, N) int32 — decoder key latch
    last_key_press_time: torch.Tensor  # (K, N) — decoder rate-limit clock

    @property
    def num_envs(self) -> int:
        return self.yaw.shape[0]

    def leaves(self) -> tuple:
        """The 11 tensors: the player's six fields, then the rest, in the
        order of the env kernels' ``Leaves`` (``ops/csrc/env_rollout.cu``)."""
        p = self.player
        return (p.z_pos, p.vel_x, p.vel_y, p.vel_z, p.on_ground,
                p.jump_released, self.yaw, self.time_remaining,
                self.zero_start, self.last_keys, self.last_key_press_time)

    def clone(self) -> "EnvState":
        return dataclasses.replace(
            self, player=phys.PlayerState(**{
                f.name: getattr(self.player, f.name).clone()
                for f in dataclasses.fields(phys.PlayerState)}),
            **{f.name: getattr(self, f.name).clone()
               for f in dataclasses.fields(self) if f.name != "player"})

    def copy_(self, other: "EnvState") -> "EnvState":
        """Copy ``other``'s values into these tensors, in place."""
        for mine, theirs in zip(self.leaves(), other.leaves()):
            mine.copy_(theirs)
        return self


@dataclasses.dataclass
class StepResult:
    obs: torch.Tensor | None  # (N, 6) normalized observation (optional)
    reward: torch.Tensor      # (N,)
    done: torch.Tensor        # (N,) bool
    zero_start: torch.Tensor  # (N,) bool — flag of the episode just stepped


def _round_vel(v):
    """Protocol velocity quantization: multiples of 16, truncated toward zero
    (sv_main.c:SV_WriteClientdataToMessage)."""
    return torch.trunc(v / 16.0) * 16.0


def _round_origin(o):
    """Protocol coordinate quantization: nearest 1/8, ties-to-even
    (common.c:MSG_WriteCoord).  ``torch.round`` rounds half to even."""
    return torch.round(o * 8.0) / 8.0


def compute_obs(cfg: Config, player: phys.PlayerState, yaw, time_remaining):
    """Build the normalized (N, 6) observation, in yaw's dtype or float32,
    whichever is wider.

    The agent sees exactly what a real Quake client would see on the wire:
    velocities quantized to multiples of 16 and origins to 1/8 units.
    """
    dtype = torch.promote_types(yaw.dtype, torch.float32)
    cols = [
        time_remaining.to(dtype),
        yaw.to(dtype),
        _round_origin(player.z_pos.to(dtype)),
        _round_vel(player.vel_x.to(dtype)),
        _round_vel(player.vel_y.to(dtype)),
        _round_vel(player.vel_z.to(dtype)),
    ]
    scale = _obs_scale(tuple(get_obs_scale(cfg)), dtype, yaw.device)
    return torch.stack(cols, dim=-1) / scale


@functools.lru_cache(maxsize=None)
def _obs_scale(scale: tuple, dtype: torch.dtype, device: torch.device):
    """The observation divisors as a tensor, made once per values, dtype and
    device, so that a rollout does not copy them to the card every frame.
    Made outside inference mode, so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(scale, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _divisor(value: float, dtype: torch.dtype, device: torch.device):
    """``value`` as a 0-dim tensor, made once per value, dtype and device,
    so that a frame does not fill a new one (a kernel on the card) every
    step.  Made outside inference mode, as :func:`_obs_scale` is."""
    with torch.inference_mode(False):
        return torch.full((), value, dtype=dtype, device=device)


def max_yaw_delta(cfg: Config) -> float:
    """Largest yaw change per frame, in degrees.

    Computed as ``np.float32(720) * time_delta``, a float32 scalar, as the
    original implementation does; the exact value matters for parity.
    """
    return float(np.float32(MAX_YAW_SPEED) * cfg.time_delta)


def _decode(cfg: Config, last_keys, last_key_press_time, yaw, key_actions,
            yaw_action, z_vel, time_remaining):
    """Map raw actions to a move command (the original ActionDecoder.map).

    Args:
        key_actions: (K, N) int32 in {0, 1}.
        yaw_action: (N,) float — continuous mouse value, or (when
            ``cfg.discrete_yaw_steps >= 0``) the discrete step index.

    Returns:
        (new_last_keys, new_last_key_press_time, new_yaw,
         smove, fmove, jump) — smove/fmove already truncated to integers
        but returned as floats.
    """
    yaw_delta = max_yaw_delta(cfg)
    yaw_steps = cfg.discrete_yaw_steps

    # The divisors are 0-dim tensors on the actions' device: on CUDA, torch
    # divides by a Python scalar as a multiply by its reciprocal, which
    # differs by an ulp from the division the kernel and JAX do.
    if not cfg.allow_yaw:
        mouse_x = torch.zeros_like(yaw)
    elif yaw_steps == -1:
        mouse_x = (yaw_action * yaw_delta
                   / _divisor(float(cfg.action_range), yaw_action.dtype,
                              yaw_action.device))
    else:
        mouse_x = ((yaw_action - yaw_steps) * yaw_delta
                   / _divisor(float(yaw_steps), yaw_action.dtype,
                              yaw_action.device))

    # Rate-limit key presses: a 0->1 transition is suppressed unless
    # key_press_delay has elapsed since the last registered press.
    # current_time counts up from episode start.
    current_time = cfg.time_limit - time_remaining  # (N,)
    elapsed = current_time >= last_key_press_time + cfg.key_press_delay
    keys = key_actions & (elapsed | (last_keys > 0)).to(torch.int32)
    pressed = (keys > 0) & (last_keys == 0)
    new_last_key_press_time = torch.where(
        pressed, current_time.to(last_key_press_time.dtype),
        last_key_press_time)

    # Half-strength press on transition frames, per cl_input.c:CL_KeyState().
    if cfg.smooth_keys:
        smoothed = (keys + last_keys) * 0.5
    else:
        smoothed = keys

    new_yaw = yaw + mouse_x
    strafe = smoothed[Key.STRAFE_RIGHT] - smoothed[Key.STRAFE_LEFT]
    fdtype = yaw.dtype
    # Move magnitudes are truncated to whole units through int32.
    smove = (cfg.smove_max * strafe).to(torch.int32).to(fdtype)
    fmove = (cfg.fmove_max * smoothed[Key.FORWARD]).to(torch.int32).to(fdtype)

    if cfg.auto_jump:
        jump = z_vel <= 16
    elif cfg.allow_jump:
        jump = keys[Key.JUMP] > 0
    else:
        jump = torch.zeros(keys.shape[1], dtype=torch.bool, device=keys.device)

    return keys, new_last_key_press_time, new_yaw, smove, fmove, jump


def decode_actions(cfg: Config, state: EnvState, key_actions, yaw_action):
    """Pure view of the decoded move command for the given state+action —
    what :func:`step` will send to the physics (yaw, smove, fmove, jump).
    Does not advance any state."""
    _, _, yaw, smove, fmove, jump = _decode(
        cfg, state.last_keys, state.last_key_press_time, state.yaw,
        key_actions, yaw_action, state.player.vel_z, state.time_remaining)
    return yaw, smove, fmove, jump


def reset_from_uniforms(cfg: Config, u_zs, u_yaw, u_time, u_speed,
                        u_angle, float_dtype=None) -> EnvState:
    """Build fresh episode-start state from five uniform-[0,1) draw tensors.
    yaw, time, z_pos and the press clock are computed in the draws' dtype
    and stored in ``float_dtype`` (default: the draws' dtype); velocity is
    float32.

    This is the single implementation of the reset distribution:
    :func:`reset` feeds it generator draws, and tests feed it the same
    numpy draws that they hand to the JAX package.

    Faithfully reproduces a quirk of the original implementation: the
    randomized draws call ``np.random.uniform(x, size=...)`` — i.e. low=x,
    high=1.0 — so time_remaining / speed / move_angle are drawn from (1, x],
    *not* (0, x].
    """
    if float_dtype is None:
        float_dtype = u_yaw.dtype
    shape = u_zs.shape
    device = u_zs.device

    zero_start = u_zs < cfg.zero_start_prob

    lo, hi = cfg.initial_yaw_range
    yaw = torch.where(zero_start, INITIAL_YAW_ZERO, lo + (hi - lo) * u_yaw)
    time_remaining = torch.where(
        zero_start, cfg.time_limit,
        cfg.time_limit + (1.0 - cfg.time_limit) * u_time)
    speed = torch.where(
        zero_start, 0.0,
        cfg.max_initial_speed + (1.0 - cfg.max_initial_speed) * u_speed)
    move_angle = 2 * math.pi + (1.0 - 2 * math.pi) * u_angle
    if cfg.hover:
        speed = torch.full(shape, 320.0, dtype=float_dtype, device=device)
        move_angle = torch.full(shape, math.pi / 2, dtype=float_dtype,
                                device=device)

    f32 = torch.float32
    player = phys.PlayerState(
        z_pos=torch.full(shape, INITIAL_STATE["z_pos"], dtype=float_dtype,
                         device=device),
        vel_x=(speed * torch.cos(move_angle)).to(f32),
        vel_y=(speed * torch.sin(move_angle)).to(f32),
        vel_z=torch.full(shape, INITIAL_STATE["vel"][2], dtype=f32,
                         device=device),
        on_ground=torch.zeros(shape, dtype=torch.bool, device=device),
        jump_released=torch.ones(shape, dtype=torch.bool, device=device),
    )

    nk = cfg.num_keys
    return EnvState(
        player=player,
        yaw=yaw.to(float_dtype),
        time_remaining=time_remaining.to(float_dtype),
        zero_start=zero_start,
        last_keys=torch.zeros((nk,) + tuple(shape), dtype=torch.int32,
                              device=device),
        last_key_press_time=torch.full((nk,) + tuple(shape),
                                       -cfg.key_press_delay,
                                       dtype=float_dtype, device=device),
    )


def reset(cfg: Config, generator: torch.Generator, n: int,
          dtype=torch.float32, device="cuda") -> EnvState:
    """Reset all n envs, drawing the five uniforms from ``generator``.

    ``dtype=torch.float64`` gives the parity mode (yaw/time/z_pos in
    float64); float32 is the production mode that the CUDA kernel runs.
    """
    u = torch.rand((5, n), generator=generator, dtype=dtype, device=device)
    return reset_from_uniforms(cfg, *u)


def step(cfg: Config, state: EnvState, key_actions, yaw_action,
         compute_observation: bool = True):
    """Advance all envs one frame.

    No auto-reset — done envs keep their terminal state.

    Args:
        key_actions: (K, N) int32 in {0, 1} — pressed keys.
        yaw_action: (N,) float — mouse action (see :func:`_decode`).
        compute_observation: skip the obs build (quantize + stack) when the
            caller recomputes obs from the carried state anyway.
    """
    player = state.player
    if cfg.hover:
        player = dataclasses.replace(
            player, vel_z=torch.zeros_like(player.vel_z),
            z_pos=torch.full_like(player.z_pos, 100.0))

    (last_keys, last_kpt, yaw, smove, fmove, jump) = _decode(
        cfg, state.last_keys, state.last_key_press_time, state.yaw,
        key_actions, yaw_action, player.vel_z, state.time_remaining)

    inputs = phys.Inputs(
        yaw=yaw,
        pitch=torch.zeros_like(yaw),
        roll=torch.zeros_like(yaw),
        fmove=fmove,
        smove=smove,
        button2=jump,
        time_delta=torch.full_like(yaw, cfg.time_delta),
    )
    player = phys.apply(inputs, player)

    if cfg.speed_reward:
        reward = cfg.time_delta * torch.sqrt(
            player.vel_x * player.vel_x + player.vel_y * player.vel_y)
    else:
        reward = cfg.time_delta * player.vel_y

    time_remaining = state.time_remaining - cfg.time_delta
    done = time_remaining < 0

    new_state = dataclasses.replace(
        state, player=player, yaw=yaw, time_remaining=time_remaining,
        last_keys=last_keys, last_key_press_time=last_kpt)

    obs = (compute_obs(cfg, player, yaw, time_remaining)
           if compute_observation else None)
    return new_state, StepResult(obs=obs, reward=reward, done=done,
                                 zero_start=state.zero_start)


def merge_reset(done, fresh: EnvState, current: EnvState) -> EnvState:
    """Select ``fresh`` episode-start state where ``done``, else ``current``.
    The (N,) ``done`` broadcasts against both (N,) and (K, N) leaves."""
    merge = lambda f, c: torch.where(done, f, c)
    fp, cp = fresh.player, current.player
    return EnvState(
        player=phys.PlayerState(**{
            f.name: merge(getattr(fp, f.name), getattr(cp, f.name))
            for f in dataclasses.fields(phys.PlayerState)}),
        yaw=merge(fresh.yaw, current.yaw),
        time_remaining=merge(fresh.time_remaining, current.time_remaining),
        zero_start=merge(fresh.zero_start, current.zero_start),
        last_keys=merge(fresh.last_keys, current.last_keys),
        last_key_press_time=merge(fresh.last_key_press_time,
                                  current.last_key_press_time),
    )


def step_autoreset(cfg: Config, state: EnvState, key_actions, yaw_action,
                   compute_observation: bool = True, reset_uniforms=None,
                   generator: torch.Generator | None = None):
    """Step, then re-draw every env whose episode finished.

    Episode boundaries stay staggered across the batch, and the returned
    :class:`StepResult` carries the reward, done and zero_start from *before*
    the reset, so that episode metrics can be accumulated on the device.

    ``reset_uniforms``: (5, N) uniform-[0,1) draws for the re-draw.  When
    None, they are drawn from ``generator`` in the state's float dtype, as
    :func:`reset` draws them.
    """
    new_state, out = step(cfg, state, key_actions, yaw_action,
                          compute_observation=compute_observation)
    if reset_uniforms is None:
        if generator is None:
            raise ValueError("step_autoreset needs reset_uniforms or a "
                             "generator")
        reset_uniforms = torch.rand((5, state.num_envs), generator=generator,
                                    dtype=state.yaw.dtype,
                                    device=state.yaw.device)
    fresh = reset_from_uniforms(cfg, *reset_uniforms,
                                float_dtype=state.yaw.dtype)
    return merge_reset(out.done, fresh, new_state), out
