"""The CUDA rollout kernel on the card: held against its plain version, its
argument checks and launch count, and scoring on the card against the CPU.

These tests need an NVIDIA card and nvcc; without them they skip (the
kernel has no CPU mode).  Run them on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

from pathlib import Path

import pytest
import torch

from q1physrl_torch import analyse
from q1physrl_torch.algo.config import load_run_config
from q1physrl_torch.models import Policy, import_policy_params
from q1physrl_torch.ops import env_rollout

from chip_smoke import probe_configs, rollout_inputs

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
RUN4 = load_run_config(str(ROOT / "configs" / "run4.yml")).env
CHECKPOINT = str(ROOT / "data" / "checkpoints" / "tpu_pb" / "checkpoint")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(cfg, n, steps, seed, device):
    # Every env starts under 1 s from its limit: all episodes end inside
    # 100 frames (1.39 s).
    return rollout_inputs(cfg, n, steps, seed, device, near_end=1.0)


@pytest.mark.parametrize("n", [1, 1000])
@pytest.mark.parametrize("name", list(probe_configs(RUN4)))
def test_kernel_equals_plain_version(cuda, name, n):
    """The kernel runs the plain version's float32 operations in the same
    order, without fused multiply-adds: the results are bitwise equal.  N=1
    and N=1000 leave ragged blocks."""
    cfg = probe_configs(RUN4)[name]
    state, ka, ya = _case(cfg, n, 100, 0, cuda)
    got_state, got_r, got_d = env_rollout.rollout_actions(cfg, state, ka, ya)
    want_state, want_r, want_d = env_rollout.rollout_actions_plain(
        cfg, state, ka, ya)
    assert bool(want_d.any())
    assert torch.equal(got_r, want_r)
    assert torch.equal(got_d, want_d)
    for f in ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
              "jump_released"):
        assert torch.equal(getattr(got_state.player, f),
                           getattr(want_state.player, f)), f
    for f in ("yaw", "time_remaining", "last_keys", "last_key_press_time",
              "zero_start"):
        assert torch.equal(getattr(got_state, f), getattr(want_state, f)), f


def test_one_launch_per_call(cuda):
    state, ka, ya = _case(RUN4, 300, 7, 1, cuda)
    before = env_rollout.rollout_actions.launches
    env_rollout.rollout_actions(RUN4, state, ka, ya)
    env_rollout.rollout_actions(RUN4, state, ka[:1], ya[:1])
    assert env_rollout.rollout_actions.launches == before + 2


def test_wrapper_rejects_bad_cuda_arguments(cuda):
    state, ka, ya = _case(RUN4, 64, 2, 2, cuda)
    with pytest.raises(ValueError):
        env_rollout.rollout_actions(RUN4, state, ka, ya.double())
    with pytest.raises(ValueError):  # actions on the CPU, state on the card
        env_rollout.rollout_actions(RUN4, state, ka.cpu(), ya.cpu())


def test_deterministic_score_on_card_matches_cpu(cuda):
    """The same trajectory on the card and the CPU; 10 points per episode
    as in test_torch_eval (the policy's products sum in another order)."""
    scores = {}
    for device in ("cpu", "cuda"):
        policy = Policy(RUN4, device=device)
        policy.load_state_dict(import_policy_params(CHECKPOINT))
        scores[device] = analyse.eval_zero_start(
            policy, RUN4, num_episodes=2, deterministic=True,
            device=device)["mean"]
    assert abs(scores["cuda"] - scores["cpu"]) <= 10.0, scores
