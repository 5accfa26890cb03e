"""The port's configs against the JAX package's: run YAMLs in both formats,
the PPO geometry presets, and the env config's derived widths."""

import dataclasses
from pathlib import Path

import pytest
import yaml

from q1physrl_torch.algo import config as tconfig
from q1physrl_torch.env import config as tenv_config
from q1physrl_tpu.algo import config as jconfig
from q1physrl_tpu.algo.train import load_run_config as jload
from q1physrl_tpu.env import config as jenv_config

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yml"))
RUN_CONFIGS = [p for p in CONFIGS
               if "members" not in yaml.safe_load(p.read_text())]


# The reference's own data/params.yml layout: RLLib trainer config with the
# env config nested inside.
REFERENCE_FORMAT = """
trainer_class: PPO
trainer_config:
  num_workers: 4
  train_batch_size: 50000
  lambda: 0.95
  kl_target: 0.0036
  lr: 5.0e-06
  vf_clip_param: 100
  sgd_minibatch_size: 128
  env_config:
    num_envs: 100
    smove_max: 1060
    smooth_keys: true
    time_delta: 0.013888888888888
    time_limit: 10
    zero_start_prob: 0.01
    initial_yaw_range: [0, 360]
checkpoint_fname: null
plot_frequency: 10
"""


def test_reference_format_loads_alike(tmp_path):
    path = tmp_path / "params.yml"
    path.write_text(REFERENCE_FORMAT)
    got = tconfig.load_run_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(jload(str(path)))
    assert (got.ppo.num_envs, got.ppo.rollout_length) == (400, 125)
    assert got.env.num_envs is None and got.plot_frequency == 10
    assert len(RUN_CONFIGS) >= 5


@pytest.mark.parametrize("path", RUN_CONFIGS, ids=lambda p: p.name)
def test_run_config_loads_alike(path):
    got = tconfig.load_run_config(str(path))
    want = jload(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("preset", ["parity", "tpu", "tpu_fresh"])
def test_ppo_presets(preset):
    got = getattr(tconfig.PPOConfig, preset)(num_sgd_iter=7)
    want = getattr(jconfig.PPOConfig, preset)(num_sgd_iter=7)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.batch_size, got.num_minibatches) == (want.batch_size,
                                                     want.num_minibatches)


@pytest.mark.parametrize("overrides", [
    {}, {"allow_yaw": False}, {"auto_jump": True}, {"allow_jump": False},
    {"discrete_yaw_steps": 3}, {"hover": True, "time_delta": 1 / 72}])
def test_env_config_widths(overrides):
    got = dataclasses.replace(tenv_config.Config.get_default(), **overrides)
    want = dataclasses.replace(jenv_config.Config.get_default(), **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for attr in ("num_keys", "num_action_logits", "has_jump_action",
                 "has_yaw_action"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.conforms_to_rules() == want.conforms_to_rules()
    assert tenv_config.get_obs_scale(got) == jenv_config.get_obs_scale(want)
    assert tenv_config.INITIAL_STATE == jenv_config.INITIAL_STATE
    assert tenv_config.MAX_YAW_SPEED == jenv_config.MAX_YAW_SPEED
    assert ([(k.name, int(k)) for k in tenv_config.Key]
            == [(k.name, int(k)) for k in jenv_config.Key])
    assert ([(o.name, int(o)) for o in tenv_config.Obs]
            == [(o.name, int(o)) for o in jenv_config.Obs])
