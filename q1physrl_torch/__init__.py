"""q1physrl_torch — the PyTorch/CUDA port of the JAX/TPU package.

A second package beside the JAX package (the reference, which it never
imports), holding the same modules in PyTorch's idiom:

- ``phys``            Quake player-movement physics, plain functions on tensors
- ``env``             config + functional batched environment core
- ``models``          policy/value towers, action distributions, RLLib
                      checkpoint import
- ``ops``             the hand-written CUDA env-rollout kernel, its wrapper
                      and its plain version
- ``analyse``         the zero-start scoring instrument
- ``algo``            run configs and the evaluation CLI

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import phys  # noqa: F401
