"""Population training sweep: P independent PPO runs advanced together.

usage: python -m q1physrl_torch.algo.sweep <sweep.yml> [--device cuda|cpu]
       q1physrl-torch-sweep <sweep.yml> [--device cuda|cpu]

P members with different seeds and different entropy/lr schedules advance
in lockstep (``algo/population.py``): per rollout frame one stacked policy
forward and one launch of the auto-reset env kernel on all members' envs;
per minibatch one Adam step for all members.  Schedules are per-iteration
values (``ppo.Coeffs``), so every member shares one loop.  Runs on the
card unless ``--device cpu`` is given, in one process (a process group of
more than one rank is refused).

Sweep YAML format (the JAX package's sweep reads the same files):
    base: configs/run4.yml          # RunConfig YAML; schedules ignored
    out_dir: runs/sweep_r2
    max_env_steps: 400000000        # per member
    checkpoint_every: 1000          # iterations, stacked resume checkpoint
    members:
      - label: control
        seed: 101
        entropy: [[0, 0.03], [40000000, 0.01]]     # piecewise-linear
        lr: [[0, 5.0e-6]]                          # piecewise-linear
        kl_target: 0.0036                          # constant

Per member, the driver tracks an EMA of the north-star metric
(zero_start_total_reward_mean) and snapshots the best params and Adam
state seen, as a single-run checkpoint (``best_member_XX/``) that
``algo.evaluate`` scores and ``checkpoint.restore_checkpoint`` restores;
``logs/member_XX.jsonl`` gets one row per iteration and ``members.json``
the member specs; ``stacked/iter_%07d`` is the resume point.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..analyse import resolve_device
from ..parallel import distributed
from . import checkpoint as ckpt
from . import population
from .config import PPOConfig, RunConfig, load_run_config
from .ppo import Coeffs

__all__ = ("EMA_ALPHA", "MemberSpec", "Bookkeeping", "PopulationTrainer",
           "check_dead_zone", "last_row", "resume_stage", "sidecar_best",
           "load_sweep", "main")

# EMA weight of the noisy per-iteration north-star metric (~1-2 zero-start
# episodes per 50k-step iteration at zero_start_prob=0.01).  Sweeps at
# bigger per-iteration batches (more zero-start episodes per sample) should
# raise it via the ``ema_alpha`` sweep key so the EMA responds on a
# comparable env-step (not iteration) timescale.
EMA_ALPHA = 0.02


@dataclasses.dataclass(frozen=True)
class MemberSpec:
    seed: int
    entropy: tuple = ((0, 0.01),)  # ((x, coeff), ...); x per schedule_unit
    lr: tuple = ((0, 5e-6),)
    kl_target: float = 0.0036
    label: str = ""
    # Warm start: restore params/Adam state/env_steps from this single-run
    # checkpoint (e.g. a best_member_* snapshot of a previous phase); the
    # member's own seed reseeds the rollout generator so warm-started
    # members explore decorrelated trajectories.
    init_from: Optional[str] = None
    # ENTROPY-GATED schedule (alternative to the x-axis schedules above):
    # stages of (policy_entropy_gate, entropy_coeff, lr).  Stage k+1
    # activates once the MEASURED policy entropy falls to its gate:
    # annealing keyed to how converged the policy is, not to how many
    # samples have passed.  Stage 0's gate is ignored (entry stage);
    # stages only advance, never retreat.
    #
    # A stage whose coeff or lr is None follows the member's x-axis
    # schedule instead (hybrid form): an early exploration ramp must ramp,
    # because a high coefficient held flat while waiting on an entropy gate
    # keeps entropy above the gate itself.
    #
    # A stage may carry a 4th element, an x-axis DEADLINE (in the sweep's
    # schedule_unit): the stage engages when the measured entropy reaches
    # its gate OR the clock reaches the deadline, whichever comes first,
    # so a coefficient whose equilibrium entropy sits above the gate cannot
    # stall the anneal.  A null gate means deadline-only.
    gates: Optional[tuple] = None

    def coeffs_at(self, x: float, stage: int = 0) -> tuple:
        if self.gates is not None:
            _, e, l = self.gates[stage][:3]
            if e is None:
                e = _interp(self.entropy, x)
            if l is None:
                l = _interp(self.lr, x)
            return e, l, self.kl_target
        e = _interp(self.entropy, x)
        l = _interp(self.lr, x)
        return e, l, self.kl_target

    def next_stage(self, stage: int, measured_entropy: float,
                   x: float = -math.inf) -> int:
        if self.gates is None:
            return stage
        while stage + 1 < len(self.gates):
            nxt = self.gates[stage + 1]
            # A null gate means deadline-only (mirrors the null coeff/lr
            # hybrid form): the stage can engage ONLY by its deadline.
            gate_hit = (nxt[0] is not None
                        and not math.isnan(measured_entropy)
                        and measured_entropy <= nxt[0])
            deadline_hit = len(nxt) > 3 and x >= nxt[3]
            if not (gate_hit or deadline_hit):
                break
            stage += 1
        return stage


def _interp(schedule, x):
    """Piecewise-linear schedule at x, in float64 (``np.interp``), as the
    sweep's host reads its member schedules."""
    xs = np.asarray([p[0] for p in schedule], np.float64)
    ys = np.asarray([p[1] for p in schedule], np.float64)
    return float(np.interp(x, xs, ys))


def check_dead_zone(n_members: int, ppo: PPOConfig, allow: bool):
    """Refuse a population in the regime where the JAX package measured
    each member running several times slower than alone: more than one
    member, minibatches under 4,096 rows and over 25,000 updates per
    iteration, unless the sweep opts in with ``allow_dead_zone: true``.
    The rule and its thresholds are the JAX package's, so both packages
    accept and refuse the same sweeps; whether the card has such a zone is
    not measured."""
    if n_members <= 1 or allow:
        return
    updates_per_iter = ppo.num_sgd_iter * (
        ppo.batch_size // ppo.sgd_minibatch_size)
    if ppo.sgd_minibatch_size < 4096 and updates_per_iter > 25_000:
        raise ValueError(
            f"population dead zone: {n_members} members x "
            f"{updates_per_iter} updates/iter at minibatch "
            f"{ppo.sgd_minibatch_size} is the update-dominated regime the "
            f"JAX package refuses.  Use num_sgd_iter<=3, minibatch>=4096, "
            f"one member, or set allow_dead_zone: true to override.")


def last_row(log_path: str) -> Optional[dict]:
    """The last row of a member's log, or None without one."""
    try:
        last = None
        with open(log_path) as f:
            for line in f:
                last = line
        return json.loads(last) if last else None
    except (OSError, ValueError):
        return None


def resume_stage(member: MemberSpec, row: Optional[dict], schedule_unit: str,
                 num_sgd_iter: int) -> int:
    """A gated member's stage at resume, from the last row of its log.

    The logged stage is a FLOOR: logs flush every ~20 iterations and a
    supervisor may kill with SIGKILL, so the last flushed row can predate
    a gate engagement (or show entropy noise-bounced back above the gate).
    Stages only advance, never retreat: re-deriving from entropy alone
    could resume a converged member at a hotter stage.  Clamped to the
    member's last stage, so a log written under a longer ladder (a config
    whose ladder was shortened between runs) cannot index past this one's;
    the JAX package's sweep does not clamp, and raises IndexError there."""
    if member.gates is None or row is None:
        return 0
    ent = float(row.get("entropy", float("nan")))
    x = float(row.get("step", 0.0))
    if schedule_unit == "sgd_samples":
        x *= num_sgd_iter
    stage = max(int(row.get("stage", 0)), member.next_stage(0, ent, x))
    return min(stage, len(member.gates) - 1)


def sidecar_best(sidecar: Optional[dict]) -> float:
    """The best EMA a snapshot's sidecar records (the larger of its
    ``ema`` and ``best_ema``), or -inf without one."""
    best = -float("inf")
    if sidecar is not None:
        best = max(float(sidecar.get("ema", best)),
                   float(sidecar.get("best_ema", best)))
    return best


def _read_sidecar(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class Bookkeeping:
    """The sweep's host bookkeeping of each member, per iteration: the
    gated stage, the EMA of the north star, the logged row, and the
    snapshot decision (warm-up, rate limit, a pending best flushed at the
    end), and the values a snapshot's sidecar records.

    ``start_iter`` is the first iteration of this process: a resumed sweep
    rebuilds its EMA from NaN, and the first few samples are single-
    iteration noise that must not trigger best snapshots.
    """

    def __init__(self, members, schedule_unit: str = "env_steps",
                 num_sgd_iter: int = 1, ema_alpha: float = EMA_ALPHA,
                 snapshot_min_interval: int = 25, stage=None, best_ema=None,
                 start_iter: int = 0):
        if schedule_unit not in ("env_steps", "sgd_samples"):
            raise ValueError(f"unknown schedule_unit {schedule_unit!r}")
        p = len(members)
        self.members = list(members)
        # "sgd_samples" = env_steps * num_sgd_iter, the cumulative samples
        # SGD processed: a geometry-invariant x-axis, so a recipe tuned at
        # one geometry transfers to one with other epochs per sample.
        self.unit = num_sgd_iter if schedule_unit == "sgd_samples" else 1
        self.ema_alpha = ema_alpha
        self.snapshot_min_interval = snapshot_min_interval
        self.stage = list(stage) if stage is not None else [0] * p
        self.ema = [float("nan")] * p
        self.best_ema = (list(best_ema) if best_ema is not None
                         else [-float("inf")] * p)
        self.last_snap = [-(10 ** 9)] * p
        self.pending = [False] * p
        self.start_iter = start_iter

    def coeffs(self, env_steps) -> Coeffs:
        """Each member's (entropy_coeff, lr, kl_target) at its own env
        steps (a scalar is every member's), as float32 arrays."""
        xs = np.broadcast_to(np.asarray(env_steps, np.float64),
                             (len(self.members),)) * self.unit
        vals = [m.coeffs_at(float(xs[i]), self.stage[i])
                for i, m in enumerate(self.members)]
        e, l, k = zip(*vals)
        f32 = lambda v: np.asarray(v, np.float32)
        return Coeffs(entropy_coeff=f32(e), lr=f32(l), kl_target=f32(k))

    def advance(self, i: int, env_steps, metrics: dict, coeffs: Coeffs,
                t: float):
        """Iteration ``i`` ran with ``coeffs`` and left each member at
        ``env_steps`` (float32 values) with ``metrics`` ({name: (P,)}):
        advance the stages and EMAs.  Returns (rows, snapshots): each
        member's log row, and the members to snapshot now."""
        rows, snapshots = [], []
        for m, spec in enumerate(self.members):
            self.stage[m] = spec.next_stage(
                self.stage[m], float(metrics["entropy"][m]),
                float(env_steps[m]) * self.unit)
            zs = float(metrics["zero_start_total_reward_mean"][m])
            if not math.isnan(zs):
                prev, a = self.ema[m], self.ema_alpha
                self.ema[m] = (zs if math.isnan(prev)
                               else (1 - a) * prev + a * zs)
            row = {k: float(metrics[k][m]) for k in sorted(metrics)}
            row.update(step=int(env_steps[m]), iteration=i,
                       zs_ema=self.ema[m], t=t,
                       entropy_coeff=float(coeffs.entropy_coeff[m]),
                       lr=float(coeffs.lr[m]), stage=self.stage[m])
            rows.append(row)
            # Snapshot on a new best smoothed north-star; warm up 30
            # iterations so the EMA has support, and rate-limit the saves
            # so a steadily rising curve doesn't checkpoint every
            # iteration.  A rise inside the rate-limit window stays
            # pending and is flushed at the end (:meth:`flush`).
            if (i - self.start_iter > 30 and not math.isnan(self.ema[m])
                    and self.ema[m] > self.best_ema[m] + 1e-6):
                self.best_ema[m] = self.ema[m]
                if i - self.last_snap[m] >= self.snapshot_min_interval:
                    self.last_snap[m] = i
                    self.pending[m] = False
                    snapshots.append(m)
                else:
                    self.pending[m] = True
        return rows, snapshots

    def flush(self) -> list:
        """The members whose rate-limited best to snapshot at the end: only
        those still at (or within noise of) their peak, since the flush
        saves the CURRENT params, and overwriting the last good snapshot
        with a since-degraded policy would lose the peak."""
        out = [m for m in range(len(self.members))
               if self.pending[m] and self.ema[m] >= self.best_ema[m] - 2.0]
        for m in out:
            self.pending[m] = False
        return out

    def sidecar(self, m: int, iteration: int, env_steps: float) -> dict:
        """A snapshot's sidecar: the member's iteration and env steps as
        saved, ``ema`` at save time and ``best_ema`` the peak (they differ
        only for an end-of-run flush)."""
        return {"member": m, "label": self.members[m].label,
                "iteration": int(iteration), "ema": self.ema[m],
                "best_ema": self.best_ema[m], "env_steps": float(env_steps)}


class PopulationTrainer:
    """The sweep's host loop: the members' population
    (``population.PopulationState``) on ``device``, resumed from
    ``out_dir/stacked`` when there is a resume point, the per-iteration
    :class:`Bookkeeping`, the logs, snapshots and resume points."""

    def __init__(self, run: RunConfig, members: list, out_dir: str,
                 checkpoint_every: int = 1000,
                 schedule_unit: str = "env_steps",
                 ema_alpha: float = EMA_ALPHA,
                 snapshot_min_interval: int = 25,
                 allow_dead_zone: bool = False, device="cuda"):
        if schedule_unit not in ("env_steps", "sgd_samples"):
            raise ValueError(f"unknown schedule_unit {schedule_unit!r}")
        if distributed.world_size() > 1:
            raise RuntimeError("a sweep runs in one process on one device; "
                               f"this process group has "
                               f"{distributed.world_size()} ranks")
        self.device = resolve_device(device)
        # Float32 products in full float32 on the card (TF32 off).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.run = run
        self.members = members
        self.out_dir = out_dir
        self.checkpoint_every = checkpoint_every
        self.env_cfg = (dataclasses.replace(run.env, num_envs=None)
                        if run.env.num_envs is not None else run.env)
        # Per-member coefficients replace the static schedules entirely.
        self.ppo = dataclasses.replace(run.ppo, lr_schedule=None,
                                       entropy_coeff_schedule=None)
        check_dead_zone(len(members), self.ppo, allow_dead_zone)
        os.makedirs(f"{out_dir}/logs", exist_ok=True)

        # Members may disagree on env_steps (warm starts from snapshots of
        # a run whose members stopped at different iterations): the
        # schedule clock is PER MEMBER, and the stop condition is the
        # minimum across members, so every member completes at least
        # max_env_steps.
        self.ps = population.init_population(
            [m.seed for m in members], self.env_cfg, self.ppo, self.device,
            [m.init_from for m in members])
        resume = ckpt.latest_checkpoint(f"{out_dir}/stacked")
        if resume:
            print(f"Resuming sweep from {resume}", flush=True)
            self.ps = ckpt.restore_population(resume, self.ps)
        # On resume, best_ema comes from the snapshot sidecars, so a
        # restarted sweep cannot overwrite a better earlier best_member_XX
        # with its (still-rebuilding) current EMA; a gated member's stage
        # from its log's last row, so the first post-resume iteration never
        # runs stage-0 coefficients against a converged policy.
        p = len(members)
        self.book = Bookkeeping(
            members, schedule_unit, self.ppo.num_sgd_iter, ema_alpha,
            snapshot_min_interval,
            stage=[resume_stage(m, last_row(self._log_path(i)),
                                schedule_unit, self.ppo.num_sgd_iter)
                   if resume else 0 for i, m in enumerate(members)],
            best_ema=[sidecar_best(_read_sidecar(
                f"{self._best_path(i)}.json")) if resume else -float("inf")
                for i in range(p)])
        self.seconds = {}
        self._log_files = [open(self._log_path(i), "a") for i in range(p)]
        with open(f"{out_dir}/members.json", "w") as f:
            json.dump([dataclasses.asdict(m) for m in members], f, indent=2)

    def _log_path(self, i: int) -> str:
        return f"{self.out_dir}/logs/member_{i:02d}.jsonl"

    def _best_path(self, i: int) -> str:
        return f"{self.out_dir}/best_member_{i:02d}"

    def step(self, coeffs: Coeffs) -> dict:
        """One population iteration with ``coeffs``; returns its metrics
        as {name: (P,) numpy array}, copied from the device once, and
        sets ``seconds`` to the rollout's and the learning half's."""
        t0 = time.perf_counter()
        ps = self.ps
        env_state, stats, traj, bootstrap_value = population.rollout(
            self.env_cfg, self.ppo, ps.policy, ps.env_state, ps.stats,
            ps.generators)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        ps = dataclasses.replace(ps, env_state=env_state, stats=stats)
        self.ps, metrics = population.learn(self.env_cfg, self.ppo, ps,
                                            traj, bootstrap_value, coeffs)
        names = sorted(metrics)
        values = torch.stack([metrics[k] for k in names]).cpu().numpy()
        self.seconds = {"rollout_seconds": t1 - t0,
                        "learn_seconds": time.perf_counter() - t1}
        return dict(zip(names, values))

    def _snapshot_best(self, m: int):
        path = self._best_path(m)
        ckpt.save_member_checkpoint(
            path, population.member_train_state(self.env_cfg, self.ps, m))
        with open(f"{path}.json", "w") as f:
            json.dump(self.book.sidecar(m, self.ps.iteration[m],
                                        self.ps.env_steps[m]), f)

    def train(self, max_env_steps: float,
              max_seconds: Optional[float] = None):
        i = self.ps.iteration[0]
        self.book.start_iter = i
        t_start = time.time()
        steps_per_iter = self.ppo.batch_size
        try:
            while min(self.ps.env_steps) < max_env_steps:
                coeffs = self.book.coeffs(np.asarray(self.ps.env_steps,
                                                     np.float32))
                t0 = time.time()
                metrics = self.step(coeffs)
                dt = time.time() - t0
                env_steps = np.asarray(self.ps.env_steps, np.float32)
                rows, snapshots = self.book.advance(i, env_steps, metrics,
                                                    coeffs, time.time())
                for f, row in zip(self._log_files, rows):
                    f.write(json.dumps(row) + "\n")
                for m in snapshots:
                    self._snapshot_best(m)
                if i % 20 == 0:
                    for f in self._log_files:
                        f.flush()
                    emas = " ".join(f"{e:7.1f}" for e in self.book.ema)
                    print(f"iter {i} steps {int(env_steps.min()):,} "
                          f"steps/s "
                          f"{len(self.members) * steps_per_iter / dt:,.0f}"
                          f" rollout_s {self.seconds['rollout_seconds']:.3f}"
                          f" learn_s {self.seconds['learn_seconds']:.3f}"
                          f" ema [{emas}]", flush=True)
                i += 1
                if i % self.checkpoint_every == 0:
                    self._save_resume()
                if max_seconds and time.time() - t_start > max_seconds:
                    print("Time budget reached", flush=True)
                    break
        finally:
            self._save_resume()
            for m in self.book.flush():
                self._snapshot_best(m)
            for f in self._log_files:
                f.close()
        print(f"Sweep done: {i} iterations in "
              f"{time.time() - t_start:.0f}s; best EMAs "
              f"{[round(b, 1) for b in self.book.best_ema]}", flush=True)

    def _save_resume(self):
        ckpt.save_population(f"{self.out_dir}/stacked", self.ps)


def load_sweep(path: str):
    """A sweep YAML -> (run, members, out_dir, max_env_steps,
    trainer_kwargs, max_seconds)."""
    import yaml

    with open(path) as f:
        spec = yaml.safe_load(f)
    run = load_run_config(spec["base"])
    members = [MemberSpec(
        seed=m["seed"],
        entropy=tuple(tuple(p) for p in m.get("entropy", [[0, 0.01]])),
        lr=tuple(tuple(p) for p in m.get("lr", [[0, run.ppo.lr]])),
        kl_target=m.get("kl_target", run.ppo.kl_target),
        label=m.get("label", f"member{j}"),
        init_from=m.get("init_from"),
        gates=(tuple(tuple(g) for g in m["gates"])
               if m.get("gates") else None),
    ) for j, m in enumerate(spec["members"])]
    trainer_kwargs = dict(
        checkpoint_every=spec.get("checkpoint_every", 1000),
        schedule_unit=spec.get("schedule_unit", "env_steps"),
        ema_alpha=spec.get("ema_alpha", EMA_ALPHA),
        snapshot_min_interval=spec.get("snapshot_min_interval", 25),
        allow_dead_zone=spec.get("allow_dead_zone", False),
    )
    return (run, members, spec["out_dir"],
            float(spec.get("max_env_steps", 4e8)),
            trainer_kwargs,
            spec.get("max_seconds"))


def main(argv=None):
    """Run the sweep a YAML describes; returns the PopulationTrainer."""
    parser = argparse.ArgumentParser(
        prog="python -m q1physrl_torch.algo.sweep",
        description="Train a population of PPO runs together.")
    parser.add_argument("sweep_yaml")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    # A plain SIGTERM (manual run management) must still run the train()
    # finally block (resume state, pending best-snapshot flush), so a
    # terminated sweep loses nothing.  A SIGKILL is covered by the
    # periodic stacked checkpoint.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    run, members, out_dir, max_steps, trainer_kwargs, max_seconds = \
        load_sweep(args.sweep_yaml)
    trainer = PopulationTrainer(run, members, out_dir, device=args.device,
                                **trainer_kwargs)
    trainer.train(max_steps, max_seconds)
    return trainer


if __name__ == "__main__":
    main()
