"""One rank of the multi-process tests of the port's data-parallel layer.

usage: python _torch_parallel_worker.py <task> <init_method> <rank> <world>
           <dir> [<backend> <device>]

Joins a process group (gloo on the CPU unless told otherwise) at
``init_method``, runs ``task`` on the arguments in ``<dir>/args.json`` and
``<dir>/inputs.pt`` (written by the parent test), and saves what it
computed to ``<dir>/rank<rank>.pt``.  It imports torch and the port only.
"""

import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from q1physrl_torch.algo import ppo as tppo  # noqa: E402
from q1physrl_torch.algo.config import PPOConfig, RunConfig  # noqa: E402
from q1physrl_torch.env import Config  # noqa: E402
from q1physrl_torch.ops import env_rollout, sharded_rollout  # noqa: E402
from q1physrl_torch.parallel import distributed, spmd  # noqa: E402
from q1physrl_torch.parallel.mesh import (env_shard,  # noqa: E402
                                          init_sharded_train_state,
                                          shard_env_axis)
from q1physrl_torch.utils import profiling  # noqa: E402

STATE_LEAVES = ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
                "jump_released", "yaw", "time_remaining", "zero_start",
                "last_keys", "last_key_press_time")


def state_dict_of(state):
    p = state.player
    return {k: getattr(p, k) if hasattr(p, k) else getattr(state, k)
            for k in STATE_LEAVES}


def state_from(d):
    from q1physrl_torch import phys
    from q1physrl_torch.env import core

    return core.EnvState(
        player=phys.PlayerState(**{k: d[k] for k in STATE_LEAVES[:6]}),
        **{k: d[k] for k in STATE_LEAVES[6:]})


def _params(ts):
    return {k: v.detach().cpu().clone()
            for k, v in ts.policy.state_dict().items()}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def task_rollouts(args, inputs, device):
    """The three sharded rollouts on this rank's envs of the given global
    inputs."""
    cfg, reset_cfg = Config(**args["cfg"]), Config(**args["reset_cfg"])
    n = inputs["yaw"].shape[-1]
    shard = env_shard(n)
    to = lambda x: x.to(device)
    state = shard_env_axis(state_from({k: to(v) for k, v in
                                       inputs.items()
                                       if k in STATE_LEAVES}), shard)
    ka, ya, ru = (shard.take(to(inputs[k])) for k in ("ka", "ya", "ru"))
    out = {}
    s, r, d = sharded_rollout.sharded_rollout_actions(cfg, state, ka, ya)
    out["actions"] = (state_dict_of(s), r, d)
    s, r, d = sharded_rollout.sharded_rollout_actions_autoreset(
        reset_cfg, state, ka, ya, ru)
    out["autoreset"] = (state_dict_of(s), r, d)
    seed, t = args["seed"], args["t_random"]
    s, r, d = sharded_rollout.sharded_rollout_random(reset_cfg, state, t, seed)
    s0, r0, d0 = env_rollout.rollout_random_plain(
        reset_cfg, state, t, seed + distributed.rank()
        * sharded_rollout.SEED_STRIDE)
    out["random"] = (state_dict_of(s), r, d)
    out["random_plain"] = (state_dict_of(s0), r0, d0)
    out["launches"] = {name: getattr(sharded_rollout, name).launches
                       for name in ("sharded_rollout_actions",
                                    "sharded_rollout_actions_autoreset",
                                    "sharded_rollout_random")}
    return out


def _setup(args, device):
    cfg = dataclasses.replace(Config.get_default(), num_envs=None,
                              zero_start_prob=0.3)
    ppo = PPOConfig(**args["ppo"])
    shard = env_shard(ppo.num_envs)
    ts = init_sharded_train_state(args["seed"], cfg, ppo, shard, device)
    return cfg, ppo, shard, ts


def task_global(args, inputs, device):
    """``iterations`` global-mode iterations from a seed."""
    cfg, ppo, shard, ts = _setup(args, device)
    metrics = []
    for _ in range(args["iterations"]):
        ts, m = tppo.train_iter(cfg, ppo, ts,
                                layout=tppo.GlobalLayout(shard))
        metrics.append(_floats(m))
    return {"params": _params(ts), "metrics": metrics,
            "iteration": ts.iteration, "env_steps": ts.env_steps}


def task_spmd_learn(args, inputs, device):
    """One spmd iteration, its learning half ``ppo.learn`` under the spmd
    layout with the parent's local permutations; returns the rank's
    trajectory and starting params too, for the JAX composition, and the
    learning half's spans as (name, id, parent, root)."""
    cfg, ppo, shard, ts = _setup(args, device)
    params0 = _params(ts)
    layout = spmd.SpmdLayout(ppo)
    gen = layout.generator(ts)
    env_state, stats, traj, boot = tppo.rollout(
        cfg, ppo, ts.policy, ts.env_state, ts.stats, gen)
    ts = dataclasses.replace(ts, env_state=env_state, stats=stats)
    perms = inputs["perms"][distributed.rank()]
    new, metrics = tppo.learn(cfg, ppo, ts, traj, boot, perms=perms,
                              layout=layout, generator=gen)
    learn = profiling.events("ppo.learn")[-1]
    spans = [(e.name, e.id, e.parent, e.root) for e in profiling.events()
             if e.root == learn.id]
    return {"params0": params0, "traj": traj._asdict(), "boot": boot,
            "params": _params(new), "mu": new.opt_state.mu,
            "nu": new.opt_state.nu, "count": new.opt_state.count,
            "metrics": _floats(metrics), "kl_coeff": float(new.kl_coeff),
            "spans": spans}


def task_spmd_coeffs(args, inputs, device):
    """One spmd iteration built static, with Coeffs equal to the config,
    and with lr 0, each from the same starting state."""
    out = {}
    cfg, ppo, _, _ = _setup(args, device)
    runs = {"static": (spmd.make_spmd_train_iter(cfg, ppo), ()),
            "coeffs": (spmd.make_spmd_train_iter(cfg, ppo, True),
                       (tppo.Coeffs(ppo.entropy_coeff, ppo.lr,
                                    ppo.kl_target),)),
            "frozen": (spmd.make_spmd_train_iter(cfg, ppo, True),
                       (tppo.Coeffs(ppo.entropy_coeff, 0.0,
                                    ppo.kl_target),))}
    for name, (fn, extra) in runs.items():
        ts = _setup(args, device)[3]
        out["params0"] = _params(ts)
        ts, metrics = fn(ts, *extra)
        out[name] = {"params": _params(ts), "metrics": _floats(metrics)}
    return out


def task_trainer(args, inputs, device):
    """The Trainer for ``max_iterations`` into ``checkpoint_dir``."""
    from q1physrl_torch.algo.train import Trainer

    run = RunConfig(ppo=PPOConfig(**args["ppo"]), seed=args["seed"],
                    use_shard_map=args["use_shard_map"],
                    max_iterations=args["iterations"],
                    checkpoint_dir=args["checkpoint_dir"])
    trainer = Trainer(run, device=device)
    trainer.train()
    return {"params": _params(trainer.ts), "mode": trainer.mode,
            "iteration": trainer.ts.iteration,
            "env_steps": trainer.ts.env_steps}


def task_score(args, inputs, device):
    """The evaluate CLI inside the process group: each rank plays its share
    of the episodes."""
    from q1physrl_torch.algo import evaluate

    sto, det = evaluate.main([args["run_yaml"], args["checkpoint"],
                              str(args["episodes"]), "--device", str(device)])
    return {"sto": sto, "det": det,
            "launches": sharded_rollout.sharded_rollout_actions.launches}


def task_draws(args, inputs, device):
    """The CUDA (or CPU) generator's bits from a seed."""
    gen = torch.Generator(device).manual_seed(args["seed"])
    return {"rand": torch.rand(args["n"], generator=gen, device=device),
            "randn": torch.randn(args["n"], generator=gen, device=device),
            "perm": torch.randperm(args["n"], generator=gen, device=device)}


def main():
    task, init_method, rank, world, directory = sys.argv[1:6]
    backend, device = (sys.argv[6:8] if len(sys.argv) > 6
                       else ("gloo", "cpu"))
    torch.set_num_threads(1)
    with open(os.path.join(directory, "args.json")) as f:
        args = json.load(f)
    path = os.path.join(directory, "inputs.pt")
    inputs = torch.load(path) if os.path.exists(path) else {}
    if task != "draws":
        distributed.initialize(backend=backend, init_method=init_method,
                               world_size=int(world), rank=int(rank),
                               timeout=60)
    try:
        out = globals()[f"task_{task}"](args, inputs, torch.device(device))
    finally:
        distributed.shutdown()
    with tempfile.NamedTemporaryFile(dir=directory, delete=False) as f:
        torch.save(out, f)
    os.replace(f.name, os.path.join(directory, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
