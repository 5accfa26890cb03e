"""Tanh MLP towers matching RLLib 0.8.4's default fully-connected net.

The policy tower is 6->256->256->num_action_logits and the value tower
6->256->256->1, tanh on hidden layers, normc weight init (hidden layers
std 1.0, output std 0.01) and zero biases.  Weights are ``nn.Linear``
``(out, in)``; the JAX package and RLLib lay them out ``(in, out)``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ("normc_init", "MLP")

HIDDEN_STD = 1.0
OUT_STD = 0.01


def normc_init(out_features: int, in_features: int, std: float,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """RLLib's normc initializer for an ``(out, in)`` weight: normal samples
    rescaled so every output unit's weights have L2 norm ``std``."""
    w = torch.randn((out_features, in_features), generator=generator,
                    device=device)
    return w * (std / w.square().sum(dim=1, keepdim=True).sqrt())


class MLP(nn.Module):
    """Tanh on hidden layers, linear output; float32."""

    def __init__(self, sizes, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(n_in, n_out, device=device)
            for n_in, n_out in zip(sizes[:-1], sizes[1:]))
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                std = OUT_STD if i == len(self.layers) - 1 else HIDDEN_STD
                layer.weight.copy_(normc_init(
                    layer.out_features, layer.in_features, std, generator,
                    layer.weight.device))
                layer.bias.zero_()

    def forward(self, x):
        *hidden, out = self.layers
        for layer in hidden:
            x = torch.tanh(layer(x))
        return out(x)
