"""Demo production: a trained checkpoint becomes a protocol-15 ``.dem``, the
counterpart of the reference's ``q1physrl_make_demo`` (reference
mkdemo.py).

Three paths, each running the policy and kernel #1 (``rollout_actions``)
on ``device`` (``cuda`` unless the caller asks for the CPU):

1. ``export_sim_demo``: roll the policy in the simulated env through
   ``analyse.eval_sim`` (one launch of ``rollout_actions`` per frame),
   integrate horizontal position from velocity, and write the .dem via
   ``utils/demfile.py``: no game engine needed.

2. ``make_demo_lockstep``: the full lockstep protocol loop, the port's
   NetQuake client (``utils/netclient.py``) driving ``_eval_coro`` over
   real UDP, against the in-repo oracle server
   (``utils/lockstep_server.py``).  Every wire byte of the real path, no
   engine binary needed.

3. ``make_demo``: the reference's sim-to-real lockstep loop against a
   modified quakespasm dedicated server (reference mkdemo.py:95-149),
   launched with ``+sync_movements 1`` so each frame blocks until a move
   command arrives.  Uses the same client; only the quakespasm binary is
   external.

In the lockstep loop (paths 2 and 3) each frame builds the observation
from the client's state, runs the policy, decodes its actions into a move
command with ``env.core.decode_actions``, and advances the decoder's key
latches and yaw by one call of ``rollout_actions`` at N=1, T=1: on the card
one launch of the kernel per frame.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging

import numpy as np
import torch

from . import analyse
from .env import core as env_core
from .env.config import INITIAL_YAW_ZERO, Config, get_obs_scale
from .ops.env_rollout import rollout_actions

logger = logging.getLogger(__name__)

__all__ = ("export_sim_demo", "make_demo", "make_demo_lockstep",
           "trajectory_from_result", "load_policy", "main")

# The 100m map player spawn (x, y are arbitrary for the flat-plane sim; z
# matches the env's initial state).
SPAWN_ORIGIN = (0.0, 0.0, 32.84320068359375)

# Demo timing correction (reference mkdemo.py:147-149; README.md:121-134):
# runs recorded the usual way start ~1.356s in, so finish times are
# reported as finish + (1.3 + 4/72) - t0.
DEMO_TIME_CORRECTION = 1.3 + 4.0 / 72

# The port quakespasm listens on unless told otherwise.
ENGINE_PORT = 26000

# Seconds ``make_demo`` gives the engine to start answering the handshake:
# loading the map (or a stand-in's imports and device set-up) can take
# longer than the client's own 10 s.  An engine that exits first fails the
# call at once.
ENGINE_START_S = 120.0


def trajectory_from_result(r: analyse.EvalSimResult):
    """Integrate horizontal position from the recorded velocities."""
    vel = np.stack([np.asarray(r.player_state.vel_x),
                    np.asarray(r.player_state.vel_y)], axis=1)
    xy = SPAWN_ORIGIN[:2] + np.cumsum(vel * r.time_delta, axis=0)
    xy = np.concatenate([[SPAWN_ORIGIN[:2]], xy[:-1]], axis=0)
    z = np.asarray(r.player_state.z_pos)
    origins = np.concatenate([xy, z[:, None]], axis=1)
    times = np.arange(len(z)) * r.time_delta
    return times, origins, np.asarray(r.yaw)


def _corrected(finish_time, times):
    return (finish_time + DEMO_TIME_CORRECTION - times[0]
            if finish_time is not None else None)


def export_sim_demo(policy, env_config: Config, demo_file_fname: str, *,
                    seed: int = 0, deterministic: bool = True,
                    finish_y: float = 3600.0, device="cuda"):
    """Roll out the policy in the sim and write a .dem of the run.

    ``policy``: a ``models.Policy`` on ``device`` or a callable, as
    ``analyse.eval_sim`` takes.  ``finish_y``: distance along +y treated as
    the 100m finish line for the intermission marker (the practice map is
    ~3600 units long).  Returns (EvalSimResult, corrected_finish_time |
    None).
    """
    from .utils import demfile

    r = analyse.eval_sim(policy, env_config, seed=seed,
                         deterministic=deterministic, device=device)
    times, origins, yaws = trajectory_from_result(r)
    crossed = np.nonzero(origins[:, 1] - SPAWN_ORIGIN[1] >= finish_y)[0]
    finish_time = float(times[crossed[0]]) if len(crossed) else None
    demfile.write_demo(demo_file_fname, times, origins, yaws,
                       finish_time=finish_time)
    corrected = _corrected(finish_time, times)
    if corrected is not None:
        logger.info("Corrected finish time: %s s", corrected)
    return r, corrected


def _make_observation(client, time_remaining, config: Config):
    """Build an observation from live game-client state exactly like the
    env does (reference mkdemo.py:39-44): float64 numpy, shape (6,)."""
    yaw = 180.0 * client.angles[1] / np.pi
    vel = np.array(client.velocity)
    z_pos = client.player_origin[2]
    obs = np.concatenate([[time_remaining], [yaw], [z_pos], vel])
    return obs / np.asarray(get_obs_scale(config))


async def _eval_coro(config: Config, port, policy_fn, demo_file, *,
                     host: str = "localhost", client_cls=None,
                     device="cuda", record=None, connect_timeout=None):
    """Lockstep eval loop against a +sync_movements server (reference
    mkdemo.py:58-92).  Returns (observations, actions): per frame the
    float64 observation and the (key_actions, yaw_action) numpy pair.

    ``policy_fn(obs, generator) -> (key_actions (K, 1) int32, yaw_action
    (1,) float32)`` on ``device`` (``analyse._policy_from`` of a Policy),
    called with the observation as a (1, 6) float32 tensor there.  The game
    client defaults to the port's protocol-15 implementation
    (``utils/netclient.AsyncClient``); ``client_cls`` accepts any object
    with the same surface.

    ``record``: a list to append, per frame, the decoder state the kernel
    was launched on (a copy), its actions, the move sent and the yaw the
    kernel wrote; for replaying the loop's launches.
    ``connect_timeout``: seconds for the handshake, passed to ``connect`` as
    ``timeout`` when given (the client's own default otherwise).
    """
    if client_cls is None:
        from .utils.netclient import AsyncClient as client_cls

    device = analyse.resolve_device(device)
    client = await client_cls.connect(
        host, port, **({} if connect_timeout is None
                       else {"timeout": connect_timeout}))
    cfg = dataclasses.replace(config, num_envs=None)
    obs_list, actions = [], []
    try:
        with torch.inference_mode():
            # The decoder's state, advanced in place by the kernel.
            state = env_core.reset(cfg, torch.Generator(device).manual_seed(0),
                                   1, device=device)
            state.yaw.fill_(INITIAL_YAW_ZERO)
            rewards = torch.empty((1, 1), dtype=torch.float32, device=device)
            dones = torch.empty((1, 1), dtype=torch.bool, device=device)
            demo = client.record_demo()
            await client.wait_until_spawn()
            client.move(*client.angles, 0, 0, 0, 0, 0)
            await client.wait_for_movement(client.view_entity)
            start_time = client.time
            time_remaining = None
            while time_remaining is None or time_remaining >= 0:
                time_remaining = cfg.time_limit - (client.time - start_time)
                obs = _make_observation(client, time_remaining, cfg)
                obs_list.append(obs)
                ka, ya = policy_fn(torch.tensor(obs[None], dtype=torch.float32,
                                                device=device), None)
                actions.append((ka, ya))
                # Mirror live client state into the decoder's env state;
                # the clock is reckoned in float64 and cast to the state's
                # dtype.
                state.time_remaining.fill_(time_remaining)
                state.player.vel_z.fill_(client.velocity[2])
                yaw, smove, fmove, jump = env_core.decode_actions(cfg, state,
                                                                  ka, ya)
                if record is not None:
                    before = state.clone()
                # Advance the decoder latches: one launch of the kernel.
                rollout_actions(cfg, state, ka.unsqueeze(0), ya.unsqueeze(0),
                                out=(state, rewards, dones))
                yaw, smove, fmove, jump = torch.cat(
                    [yaw, smove, fmove, jump.to(yaw.dtype)]).tolist()
                if record is not None:
                    record.append({"state": before, "key_actions": ka,
                                   "yaw_action": ya,
                                   "sent": (yaw, smove, fmove, jump),
                                   "kernel_yaw": state.yaw.clone()})
                client.move(pitch=0, yaw=yaw * np.pi / 180, roll=0,
                            forward=int(fmove), side=int(smove), up=0,
                            buttons=2 if jump else 0, impulse=0)
                await client.wait_for_movement(client.view_entity)
        demo.stop_recording()
        demo.dump(demo_file)
    finally:
        await client.disconnect()
    return obs_list, [(ka.cpu().numpy(), ya.cpu().numpy())
                      for ka, ya in actions]


def load_policy(run_yaml: str, checkpoint: str, device):
    """(run config, ``models.Policy`` on ``device``) from a run YAML and an
    RLLib checkpoint pickle, a directory holding one, or a training run's
    ``checkpoint_dir`` (its latest ``iter_*``), as the evaluate CLI takes
    them."""
    from .algo.config import load_run_config
    from .algo.evaluate import resolve_checkpoint
    from .models import Policy, import_policy_params

    run = load_run_config(run_yaml)
    policy = Policy(run.env, device=device)
    policy.load_state_dict(import_policy_params(
        resolve_checkpoint(checkpoint)))
    return run, policy


async def make_demo(checkpoint_fname, run_yaml, quakespasm_binary_fname,
                    game_dir, demo_file_fname, *, port: int = ENGINE_PORT,
                    device="cuda"):
    """Spawn a lockstep quakespasm server, drive the trained agent through
    the real engine, record a demo (reference mkdemo.py:95-149).  The
    engine's argument list gains ``-port <port>`` only when ``port`` is not
    quakespasm's own 26000.  Returns the corrected finish time (None if the
    run did not finish).  The engine has ``ENGINE_START_S`` to answer the
    handshake; if it exits before the demo is recorded the call raises."""
    import signal

    device = analyse.resolve_device(device)
    run, policy = load_policy(run_yaml, checkpoint_fname, device)
    policy_fn = analyse._policy_from(policy, run.env, deterministic=True)

    logger.info("Spawning quakespasm server")
    port_args = ["-port", str(port)] if port != ENGINE_PORT else []
    proc = await asyncio.create_subprocess_exec(
        quakespasm_binary_fname,
        "-protocol", "15",
        "-dedicated", "1",
        "-basedir", game_dir,
        *port_args,
        "+host_framerate", str(1.0 / 72),
        "+sys_ticrate", "0.0",
        "+sync_movements", "1",
        "+nomonsters", "1",
        "+map", "100m")
    exited = asyncio.ensure_future(proc.wait())
    try:
        with open(demo_file_fname, "wb") as f:
            demo = asyncio.ensure_future(_eval_coro(
                run.env, port, policy_fn, f, device=device,
                connect_timeout=ENGINE_START_S))
            await asyncio.wait({demo, exited},
                               return_when=asyncio.FIRST_COMPLETED)
            if not demo.done():
                demo.cancel()
                await asyncio.gather(demo, return_exceptions=True)
                raise RuntimeError(f"the engine exited with code "
                                   f"{proc.returncode} before the demo "
                                   f"was recorded")
            demo.result()
    finally:
        if proc.returncode is None:
            proc.send_signal(signal.SIGINT)
        await exited

    times, _, _, finish_time = analyse.parse_demo(demo_file_fname)
    corrected = _corrected(finish_time, times)
    logger.info("Corrected finish time: %s s", corrected)
    return corrected


async def make_demo_lockstep(checkpoint_fname, run_yaml, demo_file_fname, *,
                             device="cuda", record=None):
    """Drive the trained agent through the LOCKSTEP PROTOCOL PATH without a
    game engine: the full ``_eval_coro`` loop (the port's protocol-15
    client, real UDP sockets, clc_move / frame-datagram lockstep) against
    the in-repo oracle server (``utils/lockstep_server.py``), whose physics
    runs on ``device`` too.  Returns parse_demo's (times, origins, yaws,
    finish_time) of the recorded demo.  ``record``: as ``_eval_coro``
    takes it."""
    from .utils.lockstep_server import LockstepServer

    device = analyse.resolve_device(device)
    run, policy = load_policy(run_yaml, checkpoint_fname, device)
    policy_fn = analyse._policy_from(policy, run.env, deterministic=True)

    server = LockstepServer(run.env, device=device)
    port = await server.start("127.0.0.1", 0)
    try:
        with open(demo_file_fname, "wb") as f:
            await _eval_coro(run.env, port, policy_fn, f, host="127.0.0.1",
                             device=device, record=record)
    finally:
        server.close()

    times, origins, yaws, finish_time = analyse.parse_demo(demo_file_fname)
    logger.info("Lockstep demo: %d frames, final y=%.0f, corrected "
                "finish=%s", len(times), origins[-1][1],
                _corrected(finish_time, times))
    return times, origins, yaws, finish_time


def main(argv=None):
    """CLI: make a demo from a checkpoint.

    usage: q1physrl-torch-make-demo [--lockstep] <run.yaml> <checkpoint>
               <out.dem> [--device cuda|cpu]

    Default: engine-free sim export (``export_sim_demo``).  With
    ``--lockstep``, run the full protocol bridge loop against the in-repo
    lockstep oracle server over real UDP (no engine required); with a
    quakespasm binary, use ``mkdemo.make_demo`` directly.  ``<checkpoint>``
    is an RLLib pickle, a directory holding one, or a training run's
    ``checkpoint_dir``.  Returns what the path returned:
    (EvalSimResult, corrected finish) for the export, parse_demo's tuple
    for ``--lockstep``.
    """
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="q1physrl-torch-make-demo",
        description="Make a .dem speedrun demo from a checkpoint.")
    parser.add_argument("--lockstep", action="store_true",
                        help="drive the policy over UDP against the in-repo "
                             "lockstep server")
    parser.add_argument("run_yaml")
    parser.add_argument("checkpoint")
    parser.add_argument("out_dem")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = analyse.resolve_device(args.device)

    if args.lockstep:
        out = asyncio.run(make_demo_lockstep(args.checkpoint, args.run_yaml,
                                             args.out_dem, device=device))
        times, origins = out[:2]
        if len(times) == 0:
            raise SystemExit(
                f"lockstep bridge recorded zero TIME blocks into "
                f"{args.out_dem} — the oracle server died before the first "
                f"frame; nothing to report")
        print(f"wrote {args.out_dem} via lockstep bridge: {len(times)} "
              f"frames, final y={origins[-1][1]:.0f}")
        return out

    run, policy = load_policy(args.run_yaml, args.checkpoint, device)
    r, corrected = export_sim_demo(policy, run.env, args.out_dem,
                                   device=device)
    total = float(np.asarray(r.reward).sum())
    print(f"wrote {args.out_dem}: return={total:.1f} "
          f"corrected_finish={corrected}")
    return r, corrected


if __name__ == "__main__":
    main()
