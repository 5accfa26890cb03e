"""The port's population sweep (q1physrl_torch/algo/sweep.py) against the
JAX package's: the sweep YAMLs, the member schedules and the dead-zone
rule; the committed round-5 sweep replayed through the port's bookkeeping;
mirrors of the JAX package's sweep tests (tests/test_ppo.py:208-478); warm
starts, resumes, the log rows and the CLI.  CPU, tiny geometry (16 envs x
8 frames, minibatch 32, 2 epochs).

Tolerances: the YAMLs, schedules, stages, EMAs and sidecars are host
arithmetic in the same float64/float32 operations as the JAX package's,
so they are compared exactly.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch.algo import checkpoint as tckpt
from q1physrl_torch.algo import population as tpop
from q1physrl_torch.algo import ppo as tppo
from q1physrl_torch.algo.config import PPOConfig, RunConfig
from q1physrl_torch.algo.sweep import (EMA_ALPHA, Bookkeeping, MemberSpec,
                                       PopulationTrainer, check_dead_zone,
                                       load_sweep, resume_stage,
                                       sidecar_best)
from q1physrl_torch.env import Config
from q1physrl_torch.parallel import distributed
from q1physrl_torch.parallel.spmd import _fold_in
from q1physrl_tpu.algo import sweep as jsweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SWEEPS = sorted(p.name for p in (ROOT / "configs").glob("sweep_*.yml"))
R5 = ROOT / "data" / "checkpoints" / "repl_r5"
TINY = PPOConfig(num_envs=16, rollout_length=8, num_sgd_iter=2,
                 sgd_minibatch_size=32)
ENV = dataclasses.replace(Config.get_default(), num_envs=None)
RUN = RunConfig(env=ENV, ppo=TINY)
GATES = ((None, 0.03, 5e-6), (3.0, 0.01, 5e-6), (1.5, 0.002, 1.5e-6))
# The keys a member's log row adds to the iteration's metrics.
ROW_KEYS = ("step", "iteration", "zs_ema", "t", "entropy_coeff", "lr",
            "stage")


def _trainer(tmp_path, members, name="s", **kw):
    return PopulationTrainer(RUN, members, str(tmp_path / name),
                             device="cpu", **kw)


# --- the sweep YAMLs ---------------------------------------------------------


@pytest.mark.parametrize("name", SWEEPS)
def test_load_sweep_matches_jax(name, monkeypatch):
    """Every committed sweep loads alike in both packages: the base run's
    fields, the members, out_dir, max_env_steps, the trainer's settings
    and max_seconds; and both accept or refuse it for the dead zone."""
    monkeypatch.chdir(ROOT)
    run, members, out_dir, max_steps, kw, max_s = load_sweep(
        f"configs/{name}")
    jrun, jmembers, jout, jmax, jkw, jmax_s = jsweep.load_sweep(
        f"configs/{name}")
    assert dataclasses.asdict(run.env) == dataclasses.asdict(jrun.env)
    assert dataclasses.asdict(run.ppo) == dataclasses.asdict(jrun.ppo)
    for f in dataclasses.fields(RunConfig):
        if f.name not in ("env", "ppo"):
            assert getattr(run, f.name) == getattr(jrun, f.name), f.name
    assert [dataclasses.asdict(m) for m in members] == [
        dataclasses.asdict(m) for m in jmembers]
    assert (out_dir, max_steps, kw, max_s) == (jout, jmax, jkw, jmax_s)

    def refuses(check, ppo):
        try:
            check(len(members), ppo, kw["allow_dead_zone"])
        except ValueError:
            return True
        return False

    from q1physrl_tpu.algo.config import PPOConfig as JPPOConfig
    ppo = dataclasses.replace(run.ppo, lr_schedule=None,
                              entropy_coeff_schedule=None)
    jppo = JPPOConfig(**dataclasses.asdict(ppo))
    assert refuses(check_dead_zone, ppo) == refuses(
        jsweep.PopulationTrainer._check_dead_zone, jppo)


def _grid(member):
    """x values at every schedule knot and deadline, one either side, and
    entropies at every gate, one either side, and NaN."""
    xs = {-1.0, 0.0, 1e12}
    for sched in (member.entropy, member.lr):
        for x, _ in sched:
            xs.update((x - 1.0, float(x), x + 1.0))
    ents = {float("nan"), 10.0, -10.0}
    for g in member.gates or ():
        if g[0] is not None:
            ents.update((g[0] - 1e-3, float(g[0]), g[0] + 1e-3))
        if len(g) > 3:
            xs.update((g[3] - 1.0, float(g[3]), g[3] + 1.0))
    return sorted(xs), sorted(ents, key=lambda e: (math.isnan(e), e))


@pytest.mark.parametrize("name", SWEEPS)
def test_member_schedules_match_jax(name, monkeypatch):
    """coeffs_at (float64) and next_stage of every member of every sweep,
    against the JAX package's, on a grid through every knot, deadline and
    gate."""
    monkeypatch.chdir(ROOT)
    _, members, *_ = load_sweep(f"configs/{name}")
    _, jmembers, *_ = jsweep.load_sweep(f"configs/{name}")
    for m, jm in zip(members, jmembers):
        xs, ents = _grid(m)
        stages = range(len(m.gates)) if m.gates else [0]
        for x in xs:
            for stage in stages:
                assert m.coeffs_at(x, stage) == jm.coeffs_at(x, stage), (
                    m.label, x, stage)
                for ent in ents:
                    assert m.next_stage(stage, ent, x) == jm.next_stage(
                        stage, ent, x), (m.label, x, stage, ent)


# --- the committed round-5 sweep, replayed -----------------------------------


def _rows(member):
    with open(R5 / "logs" / f"member_{member:02d}.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("member", range(4))
def test_committed_sweep_replays_exactly(member, monkeypatch):
    """configs/sweep_r5_repl2.yml's logs (data/checkpoints/repl_r5) through
    the port's bookkeeping: each process of the run (a row whose iteration
    is not the last one's + 1, or more than 60 s after it, starts one)
    builds its Bookkeeping as PopulationTrainer does on resume (stage from
    the last logged row, best EMA from the sidecar as the replay has
    written it), then every row's coefficients from Bookkeeping.coeffs at
    the env steps before it (50,000 per iteration, summed in float32), and
    its stage, EMA and step from Bookkeeping.advance, must equal the
    logged ones exactly; each process ends with Bookkeeping.flush.  The
    sidecars the replay writes must equal the committed
    best_member_0X.json exactly."""
    monkeypatch.chdir(ROOT)
    run, members, _, _, kw, _ = load_sweep("configs/sweep_r5_repl2.yml")
    spec = members[member]
    per_iter = np.float32(run.ppo.batch_size)
    steps = [np.float32(0)]

    def env_steps(i):
        while len(steps) <= i:
            steps.append(np.float32(steps[-1] + per_iter))
        return steps[i]

    rows = _rows(member)
    sidecar, book, processes, last_i = None, None, 0, None

    def save(book, i):  # the replay's book holds this member alone
        return dict(book.sidecar(0, i, env_steps(i)), member=member)

    for k, row in enumerate(rows):
        i = row["iteration"]
        if k == 0 or i != rows[k - 1]["iteration"] + 1 or (
                row["t"] > rows[k - 1]["t"] + 60):
            if book is not None:
                for _ in book.flush():
                    sidecar = save(book, last_i + 1)
            processes += 1
            prev = rows[k - 1] if k else None
            book = Bookkeeping(
                [spec], kw["schedule_unit"], run.ppo.num_sgd_iter,
                kw["ema_alpha"], kw["snapshot_min_interval"],
                stage=[resume_stage(spec, prev, kw["schedule_unit"],
                                    run.ppo.num_sgd_iter)],
                best_ema=[sidecar_best(sidecar)], start_iter=i)
        coeffs = book.coeffs(env_steps(i))
        metrics = {name: np.asarray([v], np.float32)
                   for name, v in row.items() if name not in ROW_KEYS}
        (got,), snapshots = book.advance(i, [env_steps(i + 1)], metrics,
                                         coeffs, row["t"])
        assert got == row or all(
            got[key] == row[key] or (math.isnan(got[key])
                                     and math.isnan(row[key]))
            for key in row), (k, {key: (got[key], row[key]) for key in row
                                  if got[key] != row[key]})
        for _ in snapshots:
            sidecar = save(book, i + 1)
        last_i = i
    for _ in book.flush():
        sidecar = save(book, last_i + 1)
    assert processes == 5  # the first run and four resumes
    with open(R5 / f"best_member_{member:02d}.json") as f:
        assert sidecar == json.load(f)


# --- mirrors of the JAX package's sweep tests --------------------------------


def test_population_sweep_trains_and_snapshots(tmp_path):
    """P members advance independently; a member's snapshot restores
    through the single-run loader and the evaluate CLI scores it; the
    stacked checkpoint resumes."""
    from q1physrl_torch.algo import evaluate

    members = [MemberSpec(seed=1, entropy=((0, 0.03), (1000, 0.01)),
                          label="a"),
               MemberSpec(seed=2, entropy=((0, 0.01),),
                          lr=((0, 5e-6), (2000, 1e-6)), label="b")]
    pt = _trainer(tmp_path, members, checkpoint_every=4)
    pt.train(max_env_steps=TINY.batch_size * 6)
    assert pt.ps.iteration == [6, 6]
    flat = pt.ps.policy.flat
    assert not torch.equal(flat[0], flat[1])

    pt.book.ema = [1.0, 2.0]
    pt._snapshot_best(1)
    out = tmp_path / "s"
    sidecar = json.loads((out / "best_member_01.json").read_text())
    assert sidecar["iteration"] == pt.ps.iteration[1]
    assert sidecar["ema"] == 2.0
    template = tppo.init_train_state(0, ENV, TINY, "cpu")
    ts = tckpt.restore_checkpoint(str(out / "best_member_01"), template)
    for k, v in pt.ps.policy.views(flat).items():
        assert torch.equal(ts.policy.state_dict()[k], v[1]), k
    assert torch.equal(ts.generator.get_state(),
                       pt.ps.generators[1].get_state())
    assert ts.env_steps == pt.ps.env_steps[1]
    run_yml = tmp_path / "run.yml"
    run_yml.write_text("env:\n  num_envs: null\n")
    sto, det = evaluate.main([str(run_yml), str(out / "best_member_01"), "4",
                              "--device", "cpu"])
    assert math.isfinite(sto["mean"]) and math.isfinite(det["mean"])

    pt2 = _trainer(tmp_path, members, checkpoint_every=4)
    assert pt2.ps.iteration == [6, 6]
    assert torch.equal(pt2.ps.policy.flat, flat)
    assert torch.equal(pt2.ps.mu, pt.ps.mu)
    for g, h in zip(pt2.ps.generators, pt.ps.generators):
        assert torch.equal(g.get_state(), h.get_state())
    assert pt2.book.best_ema == [-math.inf, 2.0]  # from the sidecar


def test_sweep_schedule_units(tmp_path):
    """schedule_unit='sgd_samples' reads member-schedule milestones as
    cumulative SGD samples (env_steps * num_sgd_iter)."""
    run = dataclasses.replace(RUN, ppo=dataclasses.replace(TINY,
                                                           num_sgd_iter=4))
    member = MemberSpec(seed=1, entropy=((0, 0.03), (1000, 0.01)),
                        lr=((0, 5e-6),))
    pt_steps = PopulationTrainer(run, [member], str(tmp_path / "a"),
                                 device="cpu")
    pt_samples = PopulationTrainer(run, [member], str(tmp_path / "b"),
                                   schedule_unit="sgd_samples", device="cpu")
    # At 500 env steps: x=500 (mid-anneal) against x=2000 (past it).
    assert abs(float(pt_steps.book.coeffs(500.0).entropy_coeff[0])
               - 0.02) < 1e-6
    assert abs(float(pt_samples.book.coeffs(500.0).entropy_coeff[0])
               - 0.01) < 1e-6
    with pytest.raises(ValueError):
        PopulationTrainer(run, [member], str(tmp_path / "c"),
                          schedule_unit="bogus", device="cpu")


def test_sweep_entropy_gated_schedule(tmp_path):
    """Stages advance when the measured entropy reaches each gate or the
    clock a deadline, never retreat, and drive one real iteration."""
    m = MemberSpec(seed=1, gates=GATES)
    assert m.next_stage(0, 4.2) == 0
    assert m.next_stage(0, 2.9) == 1
    assert m.next_stage(0, 1.2) == 2          # skips straight through
    assert m.next_stage(2, 5.0) == 2          # never retreats
    assert m.next_stage(1, float("nan")) == 1

    md = MemberSpec(seed=1, gates=((None, 0.03, 5e-6),
                                   (3.0, 0.01, 5e-6, 100.0),
                                   (1.5, 0.002, 1.5e-6, 500.0)))
    assert md.next_stage(0, 4.2, x=50.0) == 0      # neither condition
    assert md.next_stage(0, 2.9, x=50.0) == 1      # gate first
    assert md.next_stage(0, 4.2, x=150.0) == 1     # deadline first
    assert md.next_stage(0, 4.2, x=600.0) == 2     # deadlines cascade
    assert md.next_stage(0, float("nan"), x=600.0) == 2
    assert md.next_stage(2, 5.0, x=0.0) == 2

    pt = _trainer(tmp_path, [m], "g")
    c0 = pt.book.coeffs(0.0)
    assert abs(float(c0.entropy_coeff[0]) - 0.03) < 1e-9
    pt.book.stage[0] = 2
    c2 = pt.book.coeffs(12345.0)  # the x-axis does not matter here
    assert abs(float(c2.entropy_coeff[0]) - 0.002) < 1e-9
    assert abs(float(c2.lr[0]) - 1.5e-6) < 1e-12
    # A fresh policy's entropy (~5.8) stays in stage 0.
    pt.book.stage[0] = 0
    pt.train(max_env_steps=TINY.batch_size)
    assert pt.book.stage[0] == 0


def test_sweep_gate_none_is_deadline_only():
    m = MemberSpec(seed=1, gates=((None, 0.03, 5e-6),
                                  (None, 0.01, 5e-6, 100.0),
                                  (None, 0.002, 1.5e-6, 500.0)))
    assert m.next_stage(0, 0.0, x=50.0) == 0   # entropy can never trigger
    assert m.next_stage(0, 5.0, x=150.0) == 1  # the deadline does
    assert m.next_stage(0, 0.1, x=600.0) == 2  # deadlines cascade


def test_sweep_resume_stage_floor_and_clamp(tmp_path):
    """Resume never retreats a logged stage (the last flushed row may show
    entropy above every gate), and clamps it to the member's ladder (a log
    written under a longer one)."""
    m = MemberSpec(seed=1, gates=GATES)
    out = tmp_path / "rs"
    pt = _trainer(tmp_path, [m], "rs", checkpoint_every=1)
    pt.train(max_env_steps=TINY.batch_size)
    log = out / "logs" / "member_00.jsonl"
    with open(log, "a") as f:
        f.write(json.dumps({"entropy": 5.5, "step": 400, "stage": 2}) + "\n")
    assert _trainer(tmp_path, [m], "rs").book.stage == [2]
    with open(log, "a") as f:
        f.write(json.dumps({"entropy": 5.5, "step": 400, "stage": 6}) + "\n")
    pt3 = _trainer(tmp_path, [m], "rs")
    assert pt3.book.stage == [2]
    assert pt3.book.coeffs(0.0).lr[0] == np.float32(1.5e-6)


def test_sweep_population_dead_zone_guard(tmp_path):
    """The JAX package's refusal: several members x over 25,000 updates per
    iteration at minibatches under 4,096, unless allow_dead_zone."""
    bad = PPOConfig(num_envs=8192, rollout_length=96, num_sgd_iter=30,
                    sgd_minibatch_size=256)
    members = [MemberSpec(seed=1), MemberSpec(seed=2)]
    with pytest.raises(ValueError, match="dead zone"):
        PopulationTrainer(RunConfig(env=ENV, ppo=bad), members,
                          str(tmp_path / "bad"), device="cpu")
    check_dead_zone(1, bad, False)
    check_dead_zone(4, dataclasses.replace(bad, num_sgd_iter=3,
                                           sgd_minibatch_size=128), False)
    check_dead_zone(4, dataclasses.replace(bad, sgd_minibatch_size=8192),
                    False)
    check_dead_zone(4, PPOConfig(num_envs=400, rollout_length=125,
                                 num_sgd_iter=30, sgd_minibatch_size=128),
                    False)
    check_dead_zone(2, bad, True)


def test_sweep_per_member_schedule_clock(tmp_path):
    """Each member's schedule reads its own env steps, and train() runs
    until the slowest member reaches max_env_steps."""
    sched = ((0, 0.03), (1000, 0.01))
    pt = _trainer(tmp_path, [MemberSpec(seed=1, entropy=sched),
                             MemberSpec(seed=2, entropy=sched)])
    c = pt.book.coeffs(np.asarray([0.0, 1000.0]))
    assert abs(float(c.entropy_coeff[0]) - 0.03) < 1e-9
    assert abs(float(c.entropy_coeff[1]) - 0.01) < 1e-9

    lag = 2 * TINY.batch_size
    pt.ps.env_steps[1] += lag
    pt.train(max_env_steps=3 * TINY.batch_size)
    steps = pt.ps.env_steps
    assert steps[0] >= 3 * TINY.batch_size
    assert steps[1] == steps[0] + lag
    pt.book.ema = [1.0, 2.0]
    pt._snapshot_best(1)
    with open(tmp_path / "s" / "best_member_01.json") as f:
        assert json.load(f)["env_steps"] == float(steps[1])


def test_pending_best_is_flushed_only_near_the_peak():
    """A best inside the rate-limit window stays pending; the end flushes
    it when the EMA is within 2.0 of the best, and not when it fell
    further."""
    book = Bookkeeping([MemberSpec(seed=1)] * 2, start_iter=0,
                       snapshot_min_interval=25)
    coeffs = book.coeffs(0.0)
    for i, zs in enumerate([100.0] * 40 + [200.0]):
        metrics = {"entropy": np.full(2, 5.0, np.float32),
                   "zero_start_total_reward_mean": np.full(2, zs,
                                                           np.float32)}
        _, snapshots = book.advance(i, [0.0, 0.0], metrics, coeffs, 0.0)
        assert snapshots == ([0, 1] if i == 31 else [])
    assert book.pending == [True, True]
    book.ema[1] = book.best_ema[1] - 2.5
    assert book.flush() == [0]
    assert book.pending == [False, True]


# --- warm starts, resumes, log rows, the CLI ---------------------------------


def test_warm_start_carries_state_and_reseeds(tmp_path):
    """init_from a port checkpoint: params, Adam's moments and count, KL
    coefficient, iteration and env steps carried to the bit; the
    generator reseeded to SplitMix64(seed, 17), whatever the checkpoint's
    generator kind."""
    ts, _ = tppo.train_iter(ENV, TINY, tppo.init_train_state(7, ENV, TINY,
                                                             "cpu"))
    path = tckpt.save_checkpoint(str(tmp_path / "src"), ts, 1)
    state_file = os.path.join(path, tckpt.STATE_FILE)
    tree = torch.load(state_file, weights_only=True)
    tree["generator"] = torch.zeros(16, dtype=torch.uint8)  # a card's
    torch.save(tree, state_file)
    with pytest.raises(ValueError, match="cuda generator"):
        tckpt.restore_checkpoint(path, tppo.init_train_state(1, ENV, TINY,
                                                             "cpu"))

    members = [MemberSpec(seed=3), MemberSpec(seed=4, init_from=path)]
    pt = _trainer(tmp_path, members)
    ps = pt.ps
    views = ps.policy.views(ps.policy.flat)
    for k, v in ts.policy.state_dict().items():
        assert torch.equal(views[k][1], v), k
    for moments, want in ((ps.mu, ts.opt_state.mu), (ps.nu, ts.opt_state.nu)):
        for k, v in ps.policy.views(moments).items():
            assert torch.equal(v[1], want[k]), k
            assert not v[0].any()
    assert ps.count == [0, ts.opt_state.count]
    assert float(ps.kl_coeff[1]) == float(ts.kl_coeff)
    assert ps.iteration == [0, 1]
    assert ps.env_steps == [0.0, ts.env_steps]
    want = torch.Generator().manual_seed(_fold_in(4, 17)).get_state()
    assert torch.equal(ps.generators[1].get_state(), want)
    solo = tppo.init_train_state(3, ENV, TINY, "cpu")
    assert torch.equal(ps.generators[0].get_state(),
                       solo.generator.get_state())
    pt.train(max_env_steps=TINY.batch_size)  # both members step
    assert ps.count[1] != pt.ps.count[1]


def test_log_rows_have_the_committed_keys(tmp_path):
    """A row of a port sweep's log has the keys, in the order, of the
    committed round-5 logs; members.json holds the member specs."""
    members = [MemberSpec(seed=1, label="x"), MemberSpec(seed=2)]
    pt = _trainer(tmp_path, members)
    pt.train(max_env_steps=TINY.batch_size)
    row = json.loads((tmp_path / "s" / "logs" / "member_01.jsonl")
                     .read_text().splitlines()[0])
    assert list(row) == list(_rows(1)[0])
    assert all(math.isfinite(row[k]) for k in ("entropy", "kl", "vf_loss"))
    assert row["iteration"] == 0 and row["step"] == TINY.batch_size
    specs = json.loads((tmp_path / "s" / "members.json").read_text())
    assert [s["seed"] for s in specs] == [1, 2]
    assert specs[0]["label"] == "x"


def test_sweep_refuses_a_process_group_and_defaults_to_cuda(tmp_path,
                                                           monkeypatch):
    members = [MemberSpec(seed=1)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PopulationTrainer(RUN, members, str(tmp_path / "a"))
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="one process"):
        _trainer(tmp_path, members, "b")


def test_sweep_cli_on_cpu(tmp_path):
    """python -m q1physrl_torch.algo.sweep <yml> --device cpu: two
    iterations of two members, a stacked checkpoint, two log rows each."""
    base = tmp_path / "base.yml"
    base.write_text("env:\n  num_envs: null\nppo:\n  num_envs: 16\n"
                    "  rollout_length: 8\n  num_sgd_iter: 2\n"
                    "  sgd_minibatch_size: 32\n")
    spec = tmp_path / "sweep.yml"
    spec.write_text(f"base: {base}\nout_dir: {tmp_path / 'out'}\n"
                    f"max_env_steps: {2 * TINY.batch_size}\n"
                    "members:\n  - {seed: 1}\n  - {seed: 2, label: b}\n")
    proc = subprocess.run(
        [sys.executable, "-m", "q1physrl_torch.algo.sweep", str(spec),
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Sweep done: 2 iterations" in proc.stdout
    out = tmp_path / "out"
    assert (out / "stacked" / "iter_0000002" / tckpt.POPULATION_FILE).exists()
    for i in range(2):
        rows = (out / "logs" / f"member_{i:02d}.jsonl").read_text()
        assert len(rows.splitlines()) == 2


def test_ema_alpha_is_the_jax_packages():
    assert EMA_ALPHA == jsweep.EMA_ALPHA


def test_warm_start_from_exported_orbax_member(tmp_path):
    """scripts/torch_export_orbax.py --train-state on round 5's winner
    (repl_r5/best_member_02), then a member warm-started from it: the
    orbax params and Adam moments to the bit, its count, KL coefficient,
    iteration 5151 and env steps 257,550,000 from the sidecar."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_export_orbax

    out = tmp_path / "exp"
    torch_export_orbax.export(str(R5 / "best_member_02"), str(out),
                              train_state=True)
    jts = torch_export_orbax.restore(str(R5 / "best_member_02"))
    adam = torch_export_orbax.adam_state(jts.opt_state)
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.models import params_from_jax

    run = load_run_config(str(ROOT / "configs" / "run4.yml"))
    ppo = dataclasses.replace(run.ppo, num_envs=4)
    with pytest.raises(ValueError, match="no generator state"):
        tckpt.restore_checkpoint(str(out), tppo.init_train_state(
            1, run.env, ppo, "cpu"))
    ps = tpop.init_population([7777], run.env, ppo, "cpu", [str(out)])
    import jax
    host = lambda tree: jax.tree.map(np.asarray, tree)
    for flat, tree in ((ps.policy.flat, jts.params), (ps.mu, adam.mu),
                       (ps.nu, adam.nu)):
        views = ps.policy.views(flat)
        for k, v in params_from_jax(host(tree)).items():
            assert torch.equal(views[k][0], v), k
    assert ps.count == [int(adam.count)]
    assert float(ps.kl_coeff[0]) == float(np.asarray(jts.kl_coeff))
    assert ps.iteration == [5151]
    assert ps.env_steps == [257_550_000.0]
