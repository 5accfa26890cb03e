"""q1physrl_torch — the PyTorch/CUDA port of the JAX/TPU package.

A second package beside the JAX package (the reference, which it never
imports), holding the same modules in PyTorch's idiom:

- ``phys``            Quake player-movement physics, plain functions on tensors
- ``env``             config + functional batched environment core, and
                      the gym and gymnasium shims over it
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
- ``utils``           the metrics writer, the .dem reader and writer, the
                      CUDA-graph frame loops, the NetQuake protocol-15
                      client, the lockstep oracle server, profiling helpers
- ``mkdemo``          a checkpoint made into a .dem speedrun demo: the
                      simulated export and the lockstep bridge over UDP
- ``vidtools``        speed-overlay frames from a demo
- ``native``          the ctypes binding to the C++ physics and demo-parser
                      oracles in ``native/``, built with g++ at first use
- ``bench``           the throughput bench

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import phys  # noqa: F401
