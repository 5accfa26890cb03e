"""Action distributions on torch tensors.

- :class:`Categorical` — RLLib's default for Discrete spaces.
- :class:`GaussianSquashedGaussian` — a diagonal Gaussian squashed through
  the CDF of N(0, _SCALE) onto (low, high).  A clipped Gaussian plus an
  entropy bonus pushes probability mass outside the clip region; the squash
  keeps logp/KL/entropy exact.  ``_SCALE = 0.5 * 1.8137`` matches the
  standard-logistic variance.

Closed forms:

- GSG entropy  = -KL(N(mean, std) || N(0, SCALE)) + log(high - low), the
  exact differential entropy of the squashed variable (the Jacobian term
  telescopes under the change of variables).
- GSG KL       = KL of the unsquashed Gaussians; the squash is a fixed
  bijection, so KL is invariant.

Sampling draws from an explicit ``torch.Generator``; given an env shard
(``parallel.mesh.EnvShard``), it draws for the whole batch along the leading
env axis and keeps the shard's rows, so that each rank of a process group
draws what one process would for those envs.  Given a tuple of P
generators (a population, ``algo/population.py``), the leading env axis is
P members' envs, member-major, and member i's rows are drawn from
generator i at the shape one member's batch has: each member draws what a
run of its own would.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ("Categorical", "GaussianSquashedGaussian", "draw", "SMALL_NUMBER",
           "MIN_LOG_NN_OUTPUT", "MAX_LOG_NN_OUTPUT")

# RLLib 0.8.4 numeric constants (ray.rllib.utils.numpy).
SMALL_NUMBER = 1e-6
MIN_LOG_NN_OUTPUT = -20.0
MAX_LOG_NN_OUTPUT = 2.0

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def draw(fn, shape, generator, dim: int = 0, shard=None, **kwargs):
    """``fn(shape, generator=generator, **kwargs)`` (``torch.rand``,
    ``torch.randn``) with ``dim`` the env axis: with a shard, drawn for the
    global batch and cut to the shard; with a tuple of P generators, P
    member blocks of ``shape[dim] / P`` envs joined on ``dim``, block i
    drawn from generator i."""
    if isinstance(generator, tuple):
        if shard is not None:
            raise ValueError("a population's draws are not sharded")
        members = len(generator)
        if shape[dim] % members:
            raise ValueError(f"axis {dim} of {tuple(shape)} does not split "
                             f"into {members} members")
        block = list(shape)
        block[dim] //= members
        return torch.cat([fn(block, generator=g, **kwargs)
                          for g in generator], dim)
    if shard is None:
        return fn(shape, generator=generator, **kwargs)
    return shard.draw(fn, shape, dim, generator=generator, **kwargs)


def _draw(fn, like, generator, shard=None):
    """:func:`draw` of ``like``'s shape, dtype and device on axis 0."""
    return draw(fn, like.shape, generator, 0, shard, dtype=like.dtype,
                device=like.device)


def _normal_logpdf(x, mean, std):
    return -torch.log(std) - _HALF_LOG_2PI - 0.5 * torch.square((x - mean) / std)


@dataclasses.dataclass(frozen=True)
class Categorical:
    """Categorical over n classes, parameterized by raw logits (..., n)."""

    logits: torch.Tensor

    def sample(self, generator: torch.Generator, shard=None):
        """Gumbel-max draw: argmax(logits - log(-log(u)))."""
        u = _draw(torch.rand, self.logits, generator, shard)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def mode(self):
        return torch.argmax(self.logits, dim=-1)

    def logp(self, x):
        logz = torch.log_softmax(self.logits, dim=-1)
        return torch.gather(logz, -1, x.long().unsqueeze(-1))[..., 0]

    def entropy(self):
        logz = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(torch.exp(logz) * logz, dim=-1)

    def kl(self, other: "Categorical"):
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


@dataclasses.dataclass(frozen=True)
class GaussianSquashedGaussian:
    """Gaussian-CDF-squashed Gaussian on (low, high).

    Parameterized by raw NN outputs ``mean_raw``/``log_std_raw`` of shape
    (...,): mean clipped to [-3, 3], log_std clipped to [-20, 2].
    """

    mean_raw: torch.Tensor
    log_std_raw: torch.Tensor
    low: float = -1.0
    high: float = 1.0

    _SCALE = 0.5 * 1.8137

    @property
    def log_std(self):
        return torch.clamp(self.log_std_raw, MIN_LOG_NN_OUTPUT,
                           MAX_LOG_NN_OUTPUT)

    @property
    def mean(self):
        return torch.clamp(self.mean_raw, -3.0, 3.0)

    @property
    def std(self):
        return torch.exp(self.log_std)

    def _squash(self, raw):
        values = torch.special.ndtr(raw / self._SCALE)
        return (torch.clamp(values, SMALL_NUMBER, 1.0 - SMALL_NUMBER)
                * (self.high - self.low) + self.low)

    def _unsquash(self, values):
        return self._SCALE * torch.special.ndtri(
            (values - self.low) / (self.high - self.low))

    def _log_squash_grad(self, unsquashed):
        scale = torch.full_like(unsquashed, self._SCALE)
        return (_normal_logpdf(unsquashed, 0.0, scale)
                + math.log(self.high - self.low))

    def sample(self, generator: torch.Generator, shard=None):
        mean = self.mean
        eps = _draw(torch.randn, mean, generator, shard)
        return self._squash(mean + self.std * eps)

    def mode(self):
        return self._squash(self.mean)

    def logp(self, x):
        u = self._unsquash(x)
        return _normal_logpdf(u, self.mean, self.std) - self._log_squash_grad(u)

    def entropy(self):
        mean, std, scale = self.mean, self.std, self._SCALE
        return (math.log(self.high - self.low)
                - (math.log(scale) - self.log_std
                   + (torch.square(std) + torch.square(mean))
                   / (2.0 * scale ** 2)
                   - 0.5))

    def kl(self, other: "GaussianSquashedGaussian"):
        mean, std = self.mean, self.std
        o_mean, o_std = other.mean, other.std
        return (other.log_std - self.log_std
                + (torch.square(std) + torch.square(mean - o_mean))
                / (2.0 * torch.square(o_std)) - 0.5)
