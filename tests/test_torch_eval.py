"""The port's scoring path against the JAX package, its CLI, and the
package boundary: q1physrl_torch imports with JAX blocked and names neither
JAX nor the JAX package anywhere."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from q1physrl_torch import analyse as tanalyse
from q1physrl_torch.algo.config import load_run_config as tload
from q1physrl_torch.models import Policy, import_policy_params
from q1physrl_tpu import analyse as janalyse
from q1physrl_tpu import models as jmodels
from q1physrl_tpu.algo.train import load_run_config as jload

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = str(ROOT / "configs" / "run4.yml")
CHECKPOINT = str(ROOT / "data" / "checkpoints" / "tpu_pb" / "checkpoint")


def _port_policy(cfg):
    policy = Policy(cfg, device="cpu")
    policy.load_state_dict(import_policy_params(CHECKPOINT))
    return policy


def test_deterministic_score_matches_jax():
    """Zero-start episodes are all alike, so this is one trajectory scored
    by both packages.  The tolerance, 10 points per episode: both packages
    run the same float32 operations, but a trajectory can move about 8
    points when one observation lands on the other side of a quantization
    step, which another summation order in the policy's products can cause
    (measured between a CPU and a TPU for the JAX package).  The JAX
    return sums in float64 here (x64 is on), the port's in float32: a few
    tenths at most over 723 frames."""
    cfg = tload(RUN4).env
    got = tanalyse.eval_zero_start(_port_policy(cfg), cfg, num_episodes=4,
                                   deterministic=True, device="cpu")
    want = janalyse.eval_zero_start(jmodels.import_policy_params(CHECKPOINT),
                                    jload(RUN4).env, num_episodes=4,
                                    deterministic=True)
    assert got["num_episodes"] == 4 and got["std"] == 0.0
    assert abs(got["mean"] - want["mean"]) <= 10.0, (got, want)
    assert 5900 < got["mean"] < 5960


def test_stochastic_score_agrees_with_jax_in_distribution():
    """The two packages draw from different generators, so stochastic
    scores agree only in distribution: 128-episode means of a score with a
    std near 10 differ by 1.3 points per standard deviation; 6 is over
    four."""
    cfg = tload(RUN4).env
    got = tanalyse.eval_zero_start(_port_policy(cfg), cfg, num_episodes=128,
                                   device="cpu")
    want = janalyse.eval_zero_start(jmodels.import_policy_params(CHECKPOINT),
                                    jload(RUN4).env, num_episodes=128)
    assert abs(got["mean"] - want["mean"]) <= 6.0, (got, want)
    assert got["std"] < 30.0


def test_stochastic_spread_matches_jax():
    """The spread of the 512-episode instrument is seed noise, in both
    packages alike: the pooled std of seeds 0 and 1 (about 10 in each
    package, set by a few low episodes) agrees within [0.7, 1.4]x.  Over
    seeds 0-3 the two packages' stds ranged 9.8-11.7 and 9.5-13.5 (PERF.md
    §7), so the band leaves room for a seed's tail and catches a sampler
    whose spread is off by half."""
    cfg = tload(RUN4).env
    policy = _port_policy(cfg)
    jparams = jmodels.import_policy_params(CHECKPOINT)
    got, want = [], []
    for seed in (0, 1):
        got.append(tanalyse.eval_zero_start(policy, cfg, num_episodes=512,
                                            seed=seed, device="cpu"))
        want.append(janalyse.eval_zero_start(jparams, jload(RUN4).env,
                                             num_episodes=512, seed=seed))
    pooled = lambda runs: (sum(r["std"] ** 2 for r in runs) / len(runs)) ** .5
    ratio = pooled(got) / pooled(want)
    assert 0.7 <= ratio <= 1.4, (got, want)
    assert all(abs(g["mean"] - w["mean"]) <= 6.0 for g, w in zip(got, want))


def test_eval_is_seeded():
    cfg = tload(RUN4).env
    policy = _port_policy(cfg)
    run = lambda seed: tanalyse.eval_zero_start(policy, cfg, num_episodes=4,
                                                seed=seed, device="cpu")
    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c


def test_scripted_policy_callable():
    """A callable policy: always forward with no yaw; ground speed caps at
    320 ups, so 10 s of forward running scores under 3,300."""
    cfg = tload(RUN4).env

    def forward_only(obs, generator):
        n = obs.shape[0]
        keys = torch.zeros((cfg.num_keys, n), dtype=torch.int32)
        keys[2] = 1
        return keys, torch.zeros(n)

    stats = tanalyse.eval_zero_start(forward_only, cfg, num_episodes=2,
                                     device="cpu")
    assert stats["std"] == 0.0 and 0 < stats["mean"] < 3300


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    cfg = tload(RUN4).env
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tanalyse.eval_zero_start(lambda o, g: None, cfg, num_episodes=2)


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_cli_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "q1physrl_torch.algo.evaluate", RUN4,
         CHECKPOINT, "2", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=_clean_env(),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("checkpoint: ") and "iteration 10194" in lines[0]
    assert lines[1].startswith("zero-start stochastic (2 episodes): mean ")
    det = re.fullmatch(r"zero-start deterministic: (\d+)", lines[2])
    assert det and 5900 < int(det.group(1)) < 5960


def test_imports_with_jax_blocked():
    """Every module imports with JAX and the JAX package blocked, and with
    matplotlib, pandas, gymnasium, gym and PIL missing (the card's machine
    has none of them)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'q1physrl_tpu',\n"
        "          'matplotlib', 'pandas', 'gymnasium', 'gym', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, q1physrl_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    q1physrl_torch.__path__, 'q1physrl_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=_clean_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 39  # every module of the port was imported


def test_port_never_names_jax():
    pattern = re.compile(r"\b(jax|jaxlib|flax|optax)\b|q1physrl_tpu")
    files = [p for p in (ROOT / "q1physrl_torch").rglob("*")
             if p.is_file() and p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) >= 43
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits
