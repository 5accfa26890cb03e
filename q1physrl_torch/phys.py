"""Quake 1 player-movement physics as plain functions on torch tensors.

Semantics follow the original Quake engine code (sv_user.c, sv_phys.c,
client.qc, mathlib.c), in the same structure-of-arrays layout as the rest of
the package: velocity is three ``(N,)`` tensors, not one ``(N, 3)`` tensor.

The functions are dtype-polymorphic: every op computes in the dtype of its
operands and only casts where the original NumPy implementation's in-place
assignments truncate (``vel`` stays float32 while intermediates may be
float64).  That gives two modes from one code path: a float64 "parity" mode
and the float32 production mode, which the CUDA rollout kernel
(``ops/csrc/env_rollout.cu``) reproduces operation for operation.

``Inputs`` and ``PlayerState`` also convert to and from the engine log's
frames (``to_df``/``from_df``; pandas is imported only there) and an
``(N, 3)`` velocity.

Type promotion: torch treats a 0-dim tensor like a Python scalar, so a
float64 0-dim ``time_delta`` would not promote float32 operands.  ``apply``
therefore expands a 0-dim ``time_delta`` to the batch shape, which makes it
promote like any other per-env operand.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = (
    "Inputs",
    "PlayerState",
    "angle_vectors",
    "accelerate",
    "user_friction",
    "air_move",
    "do_z_physics",
    "apply",
    "MAX_SPEED",
    "ACCELERATE",
    "FRICTION",
    "STOP_SPEED",
    "JUMP_SPEED",
    "GRAVITY",
    "FLOOR_HEIGHT",
)


# Quake engine physics constants (quakespasm's sv_user.c / sv_phys.c cvar
# defaults and the 100m map geometry).  Python floats take the dtype of the
# tensor they combine with, which keeps this module dtype-polymorphic.
MAX_SPEED = 320.0
ACCELERATE = 10.0
FRICTION = 4.0
STOP_SPEED = 100.0
JUMP_SPEED = 270.0
GRAVITY = 800.0
FLOOR_HEIGHT = 24.03125  # 24 + DIST_EPSILON; exactly representable in binary.


def _numpy(x):
    """A tensor (on any device), array or number as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x):
    """A copy of a column (or array) as a CPU tensor."""
    return torch.tensor(np.asarray(x))


@dataclasses.dataclass
class Inputs:
    """Per-frame player inputs, as sent over the Quake network layer.

    ``time_delta`` may be a Python float, a 0-dim tensor (broadcast) or a
    per-env tensor.
    """

    yaw: torch.Tensor
    pitch: torch.Tensor
    roll: torch.Tensor
    fmove: torch.Tensor
    smove: torch.Tensor
    button2: torch.Tensor  # bool: jump held
    time_delta: torch.Tensor | float

    @classmethod
    def from_df(cls, df):
        """From a frame with the engine log's column names (CPU tensors)."""
        return cls(
            yaw=_tensor(df.yaw), pitch=_tensor(df.pitch),
            roll=_tensor(df.roll), fmove=_tensor(df.fmove),
            smove=_tensor(df.smove),
            button2=_tensor(np.asarray(df.button2) > 0),
            time_delta=_tensor(df.host_frametime))

    def to_df(self):
        import pandas as pd

        return pd.DataFrame({
            "yaw": _numpy(self.yaw), "pitch": _numpy(self.pitch),
            "roll": _numpy(self.roll), "fmove": _numpy(self.fmove),
            "smove": _numpy(self.smove), "button2": _numpy(self.button2),
            "host_frametime": np.broadcast_to(_numpy(self.time_delta),
                                              np.shape(_numpy(self.yaw))),
        })


@dataclasses.dataclass
class PlayerState:
    """Player movement state (SoA).

    ``vel_x``/``vel_y``/``vel_z`` stand for an ``(N, 3)`` velocity; use
    :meth:`vel3` / :meth:`from_vel3` to convert.
    """

    z_pos: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor
    vel_z: torch.Tensor
    on_ground: torch.Tensor  # bool
    jump_released: torch.Tensor  # bool

    def vel3(self):
        """Velocity as an (N, 3) numpy array (host-side convenience)."""
        return np.stack([_numpy(self.vel_x), _numpy(self.vel_y),
                         _numpy(self.vel_z)], axis=-1)

    @classmethod
    def from_vel3(cls, z_pos, vel, on_ground, jump_released):
        vel = torch.as_tensor(vel)
        return cls(z_pos=torch.as_tensor(z_pos), vel_x=vel[..., 0],
                   vel_y=vel[..., 1], vel_z=vel[..., 2],
                   on_ground=torch.as_tensor(on_ground),
                   jump_released=torch.as_tensor(jump_released))

    @classmethod
    def from_df(cls, df):
        """From a frame with the engine log's column names (CPU tensors)."""
        return cls(
            z_pos=_tensor(df.z), vel_x=_tensor(df.velx),
            vel_y=_tensor(df.vely), vel_z=_tensor(df.velz),
            on_ground=_tensor(np.asarray(df.onground) > 0),
            jump_released=_tensor(np.asarray(df.jumpreleased) > 0))

    def to_df(self):
        import pandas as pd

        return pd.DataFrame({
            "z": _numpy(self.z_pos),
            "velx": _numpy(self.vel_x), "vely": _numpy(self.vel_y),
            "velz": _numpy(self.vel_z),
            "onground": _numpy(self.on_ground),
            "jumpreleased": _numpy(self.jump_released),
        })

    @classmethod
    def concatenate(cls, states):
        return cls(*(torch.cat([getattr(s, f.name) for s in states])
                     for f in dataclasses.fields(cls)))


def angle_vectors(yaw, pitch, roll):
    """View angles (degrees) -> forward/right basis vectors, z row dropped
    (mathlib.c:AngleVectors).

    Returns ``(f_x, f_y, r_x, r_y)`` where wish velocity is
    ``(f_x*fmove + r_x*smove, f_y*fmove + r_y*smove)``.
    """
    rad = math.pi / 180.0
    sy, cy = torch.sin(yaw * rad), torch.cos(yaw * rad)
    sp, cp = torch.sin(pitch * rad), torch.cos(pitch * rad)
    sr, cr = torch.sin(roll * rad), torch.cos(roll * rad)
    f_x = cp * cy
    f_y = cp * sy
    r_x = -sr * sp * cy + cr * sy
    r_y = -sr * sp * sy - cr * cy
    return f_x, f_y, r_x, r_y


def accelerate(vel_x, vel_y, wish_speed, wish_dir_x, wish_dir_y, on_ground,
               time_delta):
    """sv_user.c:SV_Accelerate / SV_AirAccelerate.

    Airborne wish speed is clipped to 30 — the strafe-jumping exploit core:
    the *acceleration magnitude* still uses the unclipped wish speed, so a
    wish direction nearly perpendicular to the velocity keeps
    ``current_speed`` below the 30-unit clip and lets speed grow unboundedly.
    """
    current_speed = vel_x * wish_dir_x + vel_y * wish_dir_y
    clipped_wish_speed = torch.where((wish_speed > 30) & ~on_ground, 30.0,
                                     wish_speed)
    add_speed = torch.clamp(clipped_wish_speed - current_speed, min=0.0)
    accel_speed = torch.minimum(ACCELERATE * time_delta * wish_speed,
                                add_speed)
    return vel_x + accel_speed * wish_dir_x, vel_y + accel_speed * wish_dir_y


def user_friction(vel_x, vel_y, time_delta):
    """sv_user.c:SV_UserFriction."""
    speed = torch.sqrt(vel_x * vel_x + vel_y * vel_y)
    control = torch.clamp(speed, min=STOP_SPEED)
    new_speed = torch.clamp(speed - time_delta * control * FRICTION, min=0.0)
    ratio = new_speed / speed
    keep = speed > 0
    return (torch.where(keep, vel_x * ratio, vel_x),
            torch.where(keep, vel_y * ratio, vel_y))


def air_move(yaw, pitch, roll, fmove, smove, on_ground, time_delta, vel_x,
             vel_y):
    """sv_user.c:SV_AirMove: the horizontal update."""
    f_x, f_y, r_x, r_y = angle_vectors(yaw, pitch, roll)
    wish_x = f_x * fmove + r_x * smove
    wish_y = f_y * fmove + r_y * smove
    unclipped_wish_speed = torch.sqrt(wish_x * wish_x + wish_y * wish_y)
    nonzero = unclipped_wish_speed > 0
    wish_dir_x = torch.where(nonzero, wish_x / unclipped_wish_speed, wish_x)
    wish_dir_y = torch.where(nonzero, wish_y / unclipped_wish_speed, wish_y)
    wish_speed = torch.clamp(unclipped_wish_speed, max=MAX_SPEED)

    fric_x, fric_y = user_friction(vel_x, vel_y, time_delta)
    vel_x = torch.where(on_ground, fric_x, vel_x)
    vel_y = torch.where(on_ground, fric_y, vel_y)
    return accelerate(vel_x, vel_y, wish_speed, wish_dir_x, wish_dir_y,
                      on_ground, time_delta)


def do_z_physics(jump_pressed, time_delta, z_pos, z_vel, on_ground,
                 jump_released):
    """Jump latch + gravity + single-plane fly-move.

    Jump logic from client.qc:PlayerJump; gravity from
    sv_phys.c:SV_AddGravity; the floor clamp is a simplified
    sv_phys.c:SV_FlyMove (about 1e-2 off the real engine's
    stop-above-ground behaviour).
    """
    z_dtype = z_vel.dtype
    jump_released = jump_released | ~jump_pressed
    do_jump = on_ground & jump_pressed & jump_released
    z_vel = z_vel + do_jump.to(z_dtype) * JUMP_SPEED
    # Gravity is subtracted in place into a float32 array while time_delta
    # may be float64: mirror that promotion-then-truncation.
    z_vel = (z_vel - GRAVITY * time_delta).to(z_dtype)
    z_pos = z_pos + time_delta * z_vel
    on_ground = z_pos < FLOOR_HEIGHT
    z_pos = torch.where(on_ground, FLOOR_HEIGHT, z_pos)
    z_vel = torch.where(on_ground, 0.0, z_vel)
    return z_pos, z_vel, on_ground, jump_released


def apply(inputs: Inputs, player_state: PlayerState) -> PlayerState:
    """Advance the player state by one frame.

    The horizontal update runs first using the *pre-step* ``on_ground``
    flag, then the vertical update — matching the engine's frame ordering.
    """
    v_dtype = player_state.vel_x.dtype
    time_delta = inputs.time_delta
    if isinstance(time_delta, torch.Tensor) and time_delta.dim() == 0:
        time_delta = time_delta.expand(player_state.vel_x.shape)
    vel_x, vel_y = air_move(
        inputs.yaw, inputs.pitch, inputs.roll, inputs.fmove, inputs.smove,
        player_state.on_ground, time_delta,
        player_state.vel_x, player_state.vel_y)

    z_pos, vel_z, on_ground, jump_released = do_z_physics(
        inputs.button2, time_delta, player_state.z_pos,
        player_state.vel_z, player_state.on_ground, player_state.jump_released)

    # Mirror the in-place assignment into the float32 vel array.
    return PlayerState(z_pos=z_pos, vel_x=vel_x.to(v_dtype),
                       vel_y=vel_y.to(v_dtype), vel_z=vel_z.to(v_dtype),
                       on_ground=on_ground, jump_released=jump_released)
