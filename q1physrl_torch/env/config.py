"""Environment configuration (reference env.py:94-180).

A frozen, hashable dataclass.  Every field is a constant of the environment
program: the plain torch path branches on it in Python, and the CUDA
rollout kernel receives it as launch arguments, so one compiled kernel
serves every config.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

__all__ = ("Config", "Key", "Obs", "INITIAL_STATE", "INITIAL_YAW_ZERO",
           "MAX_YAW_SPEED", "get_obs_scale")


# Initial state of a freshly-spawned player on the 100m map
# (reference env.py:54-58).
INITIAL_STATE = {
    # float(np.float32(32.843201)) — the reference stores this as float32
    # (env.py:54); using the exact float32 value keeps float64 parity mode
    # bit-identical.
    "z_pos": 32.84320068359375,
    "vel": (0.0, 0.0, -12.0),
    "on_ground": False,
    "jump_released": True,
}
INITIAL_YAW_ZERO = 90.0

# Maximum mouse turn rate, degrees per second (reference env.py:90-91).
_DEFAULT_TIME_DELTA = 0.014
MAX_YAW_SPEED = 2.0 * 360.0


class Key(enum.IntEnum):
    """Input keys == action-vector indices (reference env.py:61-73)."""

    STRAFE_LEFT = 0
    STRAFE_RIGHT = 1
    FORWARD = 2
    JUMP = 3  # Not used if allow_jump is False or auto_jump is True


class Obs(enum.IntEnum):
    """Observation vector indices (reference env.py:76-86)."""

    TIME_LEFT = 0
    YAW = 1
    Z_POS = 2
    X_VEL = 3
    Y_VEL = 4
    Z_VEL = 5


@dataclasses.dataclass(frozen=True)
class Config:
    """Environment configuration (reference env.py:94-180).

    Field names and defaults match the reference exactly; see its docstring
    for the meaning of each field.  ``num_envs`` is advisory here — the
    functional API takes batch shape from its tensor arguments — but is kept
    for config-file parity.
    """

    num_envs: Optional[int] = None
    zero_start_prob: float = 0.01
    initial_yaw_range: Tuple[float, float] = (0.0, 360.0)
    max_initial_speed: float = 700.0
    time_delta: float = 0.014  # Rules say 1/72; 0.014 is the legacy default.
    time_limit: float = 5.0
    allow_yaw: bool = True
    action_range: float = MAX_YAW_SPEED * _DEFAULT_TIME_DELTA
    discrete_yaw_steps: int = -1  # -1 = continuous mouse axis
    speed_reward: bool = False
    fmove_max: float = 800.0
    smove_max: float = 700.0
    hover: bool = False
    key_press_delay: float = 0.3
    smooth_keys: bool = False
    auto_jump: bool = False
    allow_jump: bool = True

    def __post_init__(self):
        # YAML gives lists; freeze to tuple so the config stays hashable.
        if isinstance(self.initial_yaw_range, list):
            object.__setattr__(self, "initial_yaw_range",
                               tuple(self.initial_yaw_range))

    @classmethod
    def get_default(cls) -> "Config":
        """The real defaults used for training (reference env.py:150-170)."""
        return cls(
            num_envs=None,
            allow_jump=True,
            allow_yaw=True,
            auto_jump=False,
            discrete_yaw_steps=-1,
            fmove_max=800.0,
            smove_max=1060.0,
            hover=False,
            initial_yaw_range=(0.0, 360.0),
            key_press_delay=0.3,
            max_initial_speed=700.0,
            smooth_keys=True,
            speed_reward=False,
            time_delta=1.0 / 72,
            time_limit=10.0,
            zero_start_prob=0.01,
        )

    def conforms_to_rules(self) -> bool:
        """Would speed-running rules permit runs generated under this config?

        (reference env.py:172-180)
        """
        return self.time_delta == 1.0 / 72 and not self.hover

    @property
    def has_jump_action(self) -> bool:
        return not self.auto_jump and self.allow_jump

    @property
    def num_keys(self) -> int:
        """Number of discrete key slots in the action vector."""
        return len(Key) if self.has_jump_action else len(Key) - 1

    @property
    def has_yaw_action(self) -> bool:
        return self.allow_yaw

    @property
    def num_action_logits(self) -> int:
        """Policy-head width: 2 logits per key + (mean, log_std) for yaw."""
        n = 2 * self.num_keys
        if self.allow_yaw:
            n += 2 if self.discrete_yaw_steps == -1 else 2 * self.discrete_yaw_steps + 1
        return n


def get_obs_scale(config: Config):
    """Normalization divisors for observations (reference env.py:294-296)."""
    return [config.time_limit, 90.0, 100.0, 200.0, 200.0, 200.0]
