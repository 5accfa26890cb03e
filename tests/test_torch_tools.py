"""The port's tools against the JAX package's: the C++ oracle binding, the
speed-overlay frames, the profiling helpers, and the copies of the sweep's
scripts (gate report, sweep evaluation, run finalization)."""

import importlib.util
import json
import math
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch import native as tnative
from q1physrl_torch import phys as tphys
from q1physrl_torch import vidtools as tvidtools
from q1physrl_torch.algo.config import PPOConfig, RunConfig
from q1physrl_torch.algo.train import Trainer
from q1physrl_torch.utils import demfile as tdemfile
from q1physrl_torch.utils import profiling
from q1physrl_tpu import native as jnative
from q1physrl_tpu import vidtools as jvidtools

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = str(ROOT / "configs" / "run4.yml")
CHECKPOINTS = ROOT / "data" / "checkpoints"
DEMOS = [CHECKPOINTS / "tpu_pb" / "run.dem",
         CHECKPOINTS / "repl_r5" / "winner_lockstep.dem",
         CHECKPOINTS / "tpu_geom_r4" / "run_lockstep.dem"]

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is not installed")


def _random_case(n, seed):
    rng = np.random.default_rng(seed)
    state = {
        "z_pos": rng.uniform(24.03125, 200, n),
        "vel_x": rng.uniform(-800, 800, n).astype(np.float32),
        "vel_y": rng.uniform(-800, 800, n).astype(np.float32),
        "vel_z": rng.uniform(-800, 800, n).astype(np.float32),
        "on_ground": rng.random(n) < 0.5,
        "jump_released": rng.random(n) < 0.5,
    }
    inputs = {
        "yaw": rng.uniform(-360, 720, n).astype(np.float32),
        "pitch": np.zeros(n, np.float32),
        "roll": np.zeros(n, np.float32),
        "fmove": rng.integers(-850, 851, n).astype(np.float32),
        "smove": rng.integers(-1100, 1101, n).astype(np.float32),
        "button2": rng.random(n) < 0.5,
        "time_delta": np.full(n, 1.0 / 72, np.float32),
    }
    return inputs, state


def _assert_same_arrays(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@needs_gxx
def test_native_builds_into_the_port_build_dir():
    """Both oracles build from native/*.cpp into q1physrl_torch/_build/,
    tagged by a hash of the source; native/*.so is left alone."""
    so_files = {p: p.stat().st_mtime_ns for p in (ROOT / "native").glob(
        "*.so")}
    for name in ("qphys", "demparse"):
        path = tnative.build(name)
        assert path.parent == ROOT / "q1physrl_torch" / "_build"
        assert path.name.startswith(f"{name}-") and path.exists()
    assert tnative.available() and tnative.dem_available()
    assert {p: p.stat().st_mtime_ns for p in so_files} == so_files


@needs_gxx
def test_native_apply_and_trajectory_match_jax_binding():
    """The same oracle through both bindings: arrays equal, from dicts, and
    from the port's PlayerState/Inputs of tensors."""
    inputs, state = _random_case(4096, 0)
    _assert_same_arrays(tnative.apply(inputs, state),
                        jnative.apply(inputs, state))
    tinputs = tphys.Inputs(**{k: torch.from_numpy(v)
                              for k, v in inputs.items()})
    tstate = tphys.PlayerState(**{k: torch.from_numpy(np.asarray(v))
                                  for k, v in state.items()})
    _assert_same_arrays(tnative.apply(tinputs, tstate),
                        jnative.apply(inputs, state))

    seq, _ = _random_case(720, 1)
    state0 = {"z_pos": 32.84320068359375, "vel_x": 0.0, "vel_y": 0.0,
              "vel_z": -12.0, "on_ground": False, "jump_released": True}
    _assert_same_arrays(tnative.trajectory(seq, state0),
                        jnative.trajectory(seq, state0))


@needs_gxx
@pytest.mark.parametrize("demo", DEMOS, ids=lambda p: p.parent.name)
def test_native_parse_demo_matches_jax_binding(demo):
    """The committed demos through both bindings: arrays and finish equal,
    and equal to the port's Python reader."""
    got, want = tnative.parse_demo(str(demo)), jnative.parse_demo(str(demo))
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] and got[3] is not None
    times, origins, yaws, finish = tdemfile.parse_demo(str(demo))
    np.testing.assert_array_equal(got[0], times)
    np.testing.assert_array_equal(got[1], np.asarray(origins, np.float32))
    np.testing.assert_array_equal(got[2], np.asarray(yaws, np.float32))
    assert finish == got[3]


def test_speed_anim_frames_match_jax(tmp_path):
    """tpu_pb's demo at 60 fps: the same number of frames, each PNG equal
    to the JAX module's byte for byte."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    demo = DEMOS[0]
    n = tvidtools.make_speed_anim(demo, tmp_path / "torch", anim_fps=60)
    assert n == jvidtools.make_speed_anim(demo, tmp_path / "jax", anim_fps=60)
    assert n > 500
    for i in range(n):
        name = f"{i:05d}.png"
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    speeds = np.array([0.0, 350.0, 700.0])
    np.testing.assert_array_equal(tvidtools.render_speed_bars(speeds),
                                  jvidtools.render_speed_bars(speeds))
    frame = tvidtools.render_speed_bars(speeds)[1]
    np.testing.assert_array_equal(tvidtools.rgba_to_bgra(frame),
                                  jvidtools.rgba_to_bgra(frame))


def test_step_timer():
    timer = profiling.StepTimer(window=3, device="cpu")
    for _ in range(5):
        with timer:
            time.sleep(0.01)
    assert len(timer.times) == 3
    assert 0.005 < timer.mean < 0.1
    assert timer.steps_per_sec(100) > 100
    assert math.isnan(profiling.StepTimer().steps_per_sec(1))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_memory_stats():
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.device_memory_stats()


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sweep_copy(directory: Path, members=None) -> Path:
    """members.json and the logs of the committed round-5 sweep."""
    src = CHECKPOINTS / "repl_r5"
    directory.mkdir(parents=True)
    shutil.copytree(src / "logs", directory / "logs")
    members = members or json.loads((src / "members.json").read_text())
    (directory / "members.json").write_text(json.dumps(members))
    return directory


def test_gate_report_matches_jax_on_round5(tmp_path, capsys):
    for name in ("gate_report", "torch_gate_report"):
        _script(name).main([str(_sweep_copy(tmp_path / name))])
    got = (tmp_path / "torch_gate_report" / "gate_report.json").read_text()
    assert got == (tmp_path / "gate_report" / "gate_report.json").read_text()
    assert json.loads(got) == json.loads(
        (CHECKPOINTS / "repl_r5" / "gate_report.json").read_text())
    assert capsys.readouterr().out.count("<- deadline") >= 2


def test_gate_report_fixes(tmp_path, capsys):
    """A stage without a gate value engages by its deadline, and a deadline
    of 0 is reported; the JAX script raises on the first and drops the
    second."""
    members = json.loads((CHECKPOINTS / "repl_r5" / "members.json")
                         .read_text())
    null_gate = json.loads(json.dumps(members))
    null_gate[0]["gates"][1][0] = None
    zero_deadline = json.loads(json.dumps(members))
    zero_deadline[0]["gates"][1] = zero_deadline[0]["gates"][1][:3] + [0]

    port = _script("torch_gate_report")
    port.main([str(_sweep_copy(tmp_path / "null", null_gate))])
    (first, *_) = json.loads((tmp_path / "null" / "gate_report.json")
                             .read_text())[0]["transitions"]
    assert first["gate"] is None and first["trigger"] == "deadline"
    with pytest.raises(TypeError):
        _script("gate_report").main([str(_sweep_copy(tmp_path / "jnull",
                                                     null_gate))])

    capsys.readouterr()
    port.main([str(_sweep_copy(tmp_path / "zero", zero_deadline))])
    stage_1 = lambda out: out.split("stage 1:")[1].split("\n")[0]
    assert stage_1(capsys.readouterr().out).endswith(
        "(gate 1.41 deadline=0) <- deadline")
    _script("gate_report").main([str(_sweep_copy(tmp_path / "jzero",
                                                 zero_deadline))])
    assert stage_1(capsys.readouterr().out).endswith(
        "(gate 1.41) <- deadline")


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """A --smoke sized run of 2 iterations on the CPU; its
    checkpoint_dir."""
    tmp = tmp_path_factory.mktemp("smoke")
    run = RunConfig(ppo=PPOConfig(num_envs=64, rollout_length=16,
                                  num_sgd_iter=2, sgd_minibatch_size=256),
                    max_iterations=2, checkpoint_dir=str(tmp / "ckpt"))
    Trainer(run, device="cpu").train()
    return Path(run.checkpoint_dir)


def test_eval_sweep_writes_the_jax_keys(smoke_run, tmp_path):
    """Two best-member snapshots in the single-run format, scored on the
    CPU with 2 episodes each: eval_summary.json has the JAX script's keys,
    sorted by stochastic mean."""
    sweep = tmp_path / "sweep"
    iters = sorted(smoke_run.glob("iter_*"))
    for i, path in enumerate(iters[-2:]):
        shutil.copytree(path, sweep / f"best_member_{i:02d}")
    (sweep / "best_member_00.json").write_text(json.dumps({"ema": 1.5}))
    (sweep / "members.json").write_text(json.dumps(
        [{"label": "a"}, {"label": "b"}]))
    _script("torch_eval_sweep").main([RUN4, str(sweep), "2", "--device",
                                      "cpu"])
    rows = json.loads((sweep / "eval_summary.json").read_text())
    committed = json.loads((CHECKPOINTS / "repl_r5" / "eval_summary.json")
                           .read_text())
    assert [list(r) for r in rows] == [list(committed[0])] * 2
    assert sorted(r["label"] for r in rows) == ["a", "b"]
    assert rows[0]["stochastic_mean"] >= rows[1]["stochastic_mean"]
    assert {r["member"]: r["train_ema"] for r in rows} == {0: 1.5, 1: None}
    assert all(np.isfinite(r["deterministic"]) for r in rows)


def test_finalize_run_writes_the_jax_bundle(smoke_run, tmp_path):
    """The bundle of the latest checkpoint: every file, the committed
    tpu_pb bundle's keys, finite scores, a demo both parsers read alike,
    an RLLib export the port reads back, and a native copy that
    restores."""
    from q1physrl_torch.algo import checkpoint, ppo
    from q1physrl_torch.models import import_policy_params

    out = tmp_path / "bundle"
    _script("torch_finalize_run").main([RUN4, str(smoke_run), str(out),
                                        "--device", "cpu"])
    committed = CHECKPOINTS / "tpu_pb"
    for name in ("eval.json", "behaviour.json", "native_meta.json"):
        got = json.loads((out / name).read_text())
        assert list(got) == list(json.loads((committed / name).read_text()))
    evals = json.loads((out / "eval.json").read_text())
    assert list(evals["stochastic"]) == list(json.loads(
        (committed / "eval.json").read_text())["stochastic"])
    assert evals["stochastic"]["num_episodes"] == 512
    assert all(np.isfinite(v) for v in evals["stochastic"].values())
    assert np.isfinite(evals["deterministic"])
    assert evals["iteration"] == 2 and evals["checkpoint"].endswith("native")

    times, origins, yaws, finish = tdemfile.parse_demo(str(out / "run.dem"))
    assert len(times) > 500
    if tnative.dem_available():
        ct, co, cy, cf = tnative.parse_demo(str(out / "run.dem"))
        np.testing.assert_array_equal(ct, times)
        np.testing.assert_array_equal(co, np.asarray(origins, np.float32))
        assert cf == finish

    latest = sorted(smoke_run.glob("iter_*"))[-1]
    exported = import_policy_params(str(out / "checkpoint"))
    trained = torch.load(latest / checkpoint.STATE_FILE,
                         weights_only=True)["params"]
    for k, v in trained.items():
        assert torch.equal(exported[k], v), k
    with open(out / "checkpoint.tune_metadata", "rb") as f:
        assert pickle.load(f)["iteration"] == 2
    run = RunConfig(ppo=PPOConfig(num_envs=64, rollout_length=16,
                                  num_sgd_iter=2, sgd_minibatch_size=256))
    ts = ppo.init_train_state(0, run.env, run.ppo, "cpu")
    restored = checkpoint.restore_checkpoint(str(out / "native"), ts)
    assert restored.iteration == 2
