"""q1physrl_torch — the PyTorch/CUDA port of the JAX/TPU package.

A second package beside the JAX package (the reference, which it never
imports), holding the same modules in PyTorch's idiom:

- ``phys``            Quake player-movement physics, plain functions on tensors
- ``env``             config + functional batched environment core
- ``models``          policy/value towers, action distributions, RLLib
                      checkpoint import and export
- ``ops``             the hand-written CUDA env-rollout kernels, their
                      wrappers and their plain versions
- ``analyse``         the zero-start scoring instrument, ``eval_sim`` and
                      the trajectory analysis (counterfactual sweep,
                      plots, key overlay, demo parsing)
- ``algo``            run configs, PPO, checkpoints, the training driver,
                      population sweeps and the evaluation CLI
- ``parallel``        data-parallel training over ``torch.distributed``:
                      process groups, the env axis split by rank, the
                      explicit data-parallel iteration
- ``utils``           the metrics writer, the .dem reader and writer
- ``bench``           the throughput bench

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import phys  # noqa: F401
