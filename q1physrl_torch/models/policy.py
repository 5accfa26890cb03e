"""Policy/value networks and the joint (tuple) action distribution.

:class:`Policy` holds RLLib's default FC-net towers (``pi``: fc_1/fc_2/fc_out,
``vf``: fc_value_1/fc_value_2/value_out).  :class:`ActionDist` is the tuple
distribution over the action space — per-key Categorical(2) children plus a
GaussianSquashedGaussian for the continuous mouse axis (or a Categorical
for a discrete one), consuming a flat logits vector in tuple-space order.
Actions use the env core's layout: keys as a (K, N) int32 tensor, yaw as an
(N,) float tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..env.config import Config
from .distributions import Categorical, GaussianSquashedGaussian
from .mlp import MLP

__all__ = ("Policy", "ActionDist", "action_dist", "OBS_DIM", "HIDDENS")

OBS_DIM = 6
HIDDENS = (256, 256)


class Policy(nn.Module):
    """Policy and value towers (RLLib FC-net layout and initializers)."""

    def __init__(self, cfg: Config, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.pi = MLP((OBS_DIM, *HIDDENS, cfg.num_action_logits), generator,
                      device=device)
        self.vf = MLP((OBS_DIM, *HIDDENS, 1), generator, device=device)

    def forward(self, obs):
        """obs (N, 6) -> (logits (N, num_action_logits), value (N,))."""
        return self.pi(obs), self.vf(obs)[..., 0]


@dataclasses.dataclass(frozen=True)
class ActionDist:
    """Joint distribution over the tuple action space.

    Children in tuple-space order: ``num_keys`` x Categorical(2), then the
    yaw axis — continuous (GaussianSquashedGaussian on ±action_range, 2
    inputs) or discrete (Categorical(2*steps+1)), or none.
    """

    keys: tuple  # tuple of Categorical, one per key
    yaw: Optional[object]  # GaussianSquashedGaussian | Categorical | None

    def _yaw_action(self, key_actions, draw):
        logits = self.keys[0].logits
        if self.yaw is None:
            return torch.zeros(key_actions.shape[1], dtype=logits.dtype,
                               device=logits.device)
        return draw(self.yaw).to(logits.dtype)

    def sample(self, generator: torch.Generator, shard=None):
        """``shard``: an env shard whose rows to keep of draws made for the
        whole batch (see ``distributions``)."""
        key_actions = torch.stack(
            [d.sample(generator, shard) for d in self.keys]).to(torch.int32)
        return key_actions, self._yaw_action(
            key_actions, lambda d: d.sample(generator, shard))

    def mode(self):
        key_actions = torch.stack([d.mode() for d in self.keys]).to(torch.int32)
        return key_actions, self._yaw_action(key_actions, lambda d: d.mode())

    def logp(self, key_actions, yaw_action):
        lp = sum(d.logp(key_actions[i]) for i, d in enumerate(self.keys))
        if self.yaw is not None:
            lp = lp + self.yaw.logp(yaw_action)
        return lp

    def entropy(self):
        h = sum(d.entropy() for d in self.keys)
        if self.yaw is not None:
            h = h + self.yaw.entropy()
        return h

    def kl(self, other: "ActionDist"):
        kl = sum(d.kl(o) for d, o in zip(self.keys, other.keys))
        if self.yaw is not None:
            kl = kl + self.yaw.kl(other.yaw)
        return kl


def action_dist(cfg: Config, logits) -> ActionDist:
    """Split flat logits (N, num_action_logits) into the joint dist."""
    nk = cfg.num_keys
    keys = tuple(Categorical(logits[..., 2 * i:2 * i + 2]) for i in range(nk))
    yaw = None
    if cfg.allow_yaw:
        rest = logits[..., 2 * nk:]
        if cfg.discrete_yaw_steps == -1:
            yaw = GaussianSquashedGaussian(
                mean_raw=rest[..., 0], log_std_raw=rest[..., 1],
                low=-cfg.action_range, high=cfg.action_range)
        else:
            yaw = Categorical(rest)
    return ActionDist(keys=keys, yaw=yaw)
