"""Policy/value networks and the joint (tuple) action distribution.

:class:`Policy` holds RLLib's default FC-net towers (``pi``: fc_1/fc_2/fc_out,
``vf``: fc_value_1/fc_value_2/value_out).  :class:`ActionDist` is the tuple
distribution over the action space — per-key Categorical(2) children plus a
GaussianSquashedGaussian for the continuous mouse axis (or a Categorical
for a discrete one), consuming a flat logits vector in tuple-space order.
Actions use the env core's layout: keys as a (K, N) int32 tensor, yaw as an
(N,) float tensor.

:class:`StackedPolicy` holds P members' towers for a population
(``algo/population.py``): each weight ``(P, out, in)`` and bias ``(P, out)``
is a view of one ``(P, D)`` buffer, so that an optimizer step on all P
members is a few operations on that buffer, and the forward is one batched
product per layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..env.config import Config
from .distributions import Categorical, GaussianSquashedGaussian
from .mlp import MLP

__all__ = ("Policy", "StackedPolicy", "ActionDist", "action_dist", "OBS_DIM",
           "HIDDENS")

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


class _StackedLinear(nn.Module):
    """P members' ``nn.Linear`` of one layer: ``weight`` (P, out, in) and
    ``bias`` (P, out), parameters that are views of the stacked buffer."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x):
        """x (P, n, in) -> (P, n, out)."""
        return torch.baddbmm(self.bias.unsqueeze(1), x,
                             self.weight.transpose(1, 2))


class _StackedMLP(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        *hidden, out = self.layers
        for layer in hidden:
            x = torch.tanh(layer(x))
        return out(x)


class StackedPolicy(nn.Module):
    """The towers of P members, with :class:`Policy`'s parameter names.

    ``flat`` (P, D) holds member i's parameters in row i, in the order of
    ``Policy.named_parameters()``; every parameter is a view of it, so an
    in-place change of ``flat`` is one of the parameters (and the other way
    round).  The buffer is made on its device: moving the module would cut
    the views loose, so :meth:`to` is not for it.
    """

    def __init__(self, cfg: Config, members: int, device=None):
        super().__init__()
        names = Policy(cfg, device="meta").named_parameters()
        self.shapes = {k: tuple(p.shape) for k, p in names}
        self.members = members
        self.flat = torch.zeros((members, sum(
            math.prod(s) for s in self.shapes.values())), device=device)
        views = self.views(self.flat)
        towers = {}
        for tower in ("pi", "vf"):
            towers[tower] = _StackedMLP(
                _StackedLinear(views[f"{tower}.layers.{i}.weight"],
                               views[f"{tower}.layers.{i}.bias"])
                for i in range(len(HIDDENS) + 1))
        self.pi, self.vf = towers["pi"], towers["vf"]

    def views(self, flat) -> dict:
        """Views of a (P, D) tensor of this layout (the parameters, or
        moments and gradients alike), by parameter name, each (P, *shape)."""
        out, offset = {}, 0
        for name, shape in self.shapes.items():
            size = math.prod(shape)
            out[name] = flat[:, offset:offset + size].view(
                (flat.shape[0],) + shape)
            offset += size
        return out

    def flatten(self, tensors) -> torch.Tensor:
        """(P, *shape) tensors in parameter order -> one (P, D) tensor."""
        return torch.cat([x.reshape(self.members, -1) for x in tensors], 1)

    @classmethod
    def from_policies(cls, cfg: Config, policies) -> "StackedPolicy":
        """The members' towers stacked in the order given, on the first
        policy's device; the values are copied."""
        p0 = next(policies[0].parameters())
        stacked = cls(cfg, len(policies), p0.device)
        stacked.load_members([p.state_dict() for p in policies])
        return stacked

    def load_members(self, state_dicts):
        """Member i's parameters from ``state_dicts[i]`` (a
        :class:`Policy` state dict)."""
        with torch.no_grad():
            for i, sd in enumerate(state_dicts):
                for name, view in self.views(self.flat).items():
                    view[i].copy_(sd[name])

    def member_state_dict(self, i: int) -> dict:
        """Member ``i`` as a :class:`Policy` state dict (copies)."""
        return {k: v[i].detach().clone()
                for k, v in self.views(self.flat).items()}

    def member_policy(self, cfg: Config, i: int) -> Policy:
        """Member ``i`` as a :class:`Policy` on the buffer's device."""
        policy = Policy(cfg, device=self.flat.device)
        policy.load_state_dict(self.member_state_dict(i))
        return policy

    def forward(self, obs):
        """obs (P, n, 6) -> (logits (P, n, L), value (P, n)); obs (P * n,
        6), member-major -> (logits (P * n, L), value (P * n,))."""
        x = obs if obs.dim() == 3 else obs.view(self.members, -1,
                                                obs.shape[-1])
        logits, value = self.pi(x), self.vf(x)[..., 0]
        if obs.dim() == 3:
            return logits, value
        return logits.reshape(-1, logits.shape[-1]), value.reshape(-1)


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

    def sample(self, generator, shard=None):
        """``shard``: an env shard whose rows to keep of draws made for the
        whole batch; ``generator`` may be a tuple of P generators, one per
        member of a population whose envs the rows are, member-major (see
        ``distributions``)."""
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
