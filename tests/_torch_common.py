"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: the same numpy inputs go through both, and results are compared
as numpy arrays.  The probe configs and the seeded action stream are the
ones ``chip_smoke.py`` holds the CUDA kernel to on the card."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import probe_configs, random_actions  # noqa: F401
from q1physrl_torch import phys as tphys
from q1physrl_torch.env import core as tcore

PLAYER_FIELDS = ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
                 "jump_released")


def t(x):
    """numpy / JAX array -> CPU torch tensor of the same dtype."""
    return torch.from_numpy(np.array(x))


def env_state_from_jax(st) -> tcore.EnvState:
    return tcore.EnvState(
        player=tphys.PlayerState(**{f: t(getattr(st.player, f))
                                    for f in PLAYER_FIELDS}),
        yaw=t(st.yaw), time_remaining=t(st.time_remaining),
        zero_start=t(st.zero_start), last_keys=t(st.last_keys),
        last_key_press_time=t(st.last_key_press_time))


def assert_env_state_close(got: tcore.EnvState, want, vel_rtol=1e-5,
                           vel_atol=1e-3, yaw_rtol=1e-6, yaw_atol=0.0,
                           time_atol=0.0):
    """``got`` (torch) against ``want`` (JAX): flags and key latches exactly,
    float leaves at the rollout kernel tolerances.

    ``yaw_atol``: under jit, XLA folds ``yaw_action * max_yaw_delta /
    action_range`` to ``yaw_action`` when the two constants are equal in
    float32 (they are for run4 and the defaults), while the port divides as
    written.  The mouse step then differs by up to an ulp per frame, and the
    integrated yaw by about an ulp of its magnitude (6e-5 at 512 degrees)
    per frame in which the rounding of the sum differs.

    ``time_atol``: under jit, XLA on the CPU may fuse a reset's
    ``time_limit + (1 - time_limit) * u_time`` into one multiply-add, an ulp
    of ``time_limit`` or less off the port's two roundings.
    """
    for f in ("on_ground", "jump_released"):
        np.testing.assert_array_equal(getattr(got.player, f).numpy(),
                                      np.asarray(getattr(want.player, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.last_keys.numpy(),
                                  np.asarray(want.last_keys))
    np.testing.assert_array_equal(got.zero_start.numpy(),
                                  np.asarray(want.zero_start))
    for f in ("vel_x", "vel_y", "vel_z", "z_pos"):
        np.testing.assert_allclose(getattr(got.player, f).numpy(),
                                   np.asarray(getattr(want.player, f)),
                                   rtol=vel_rtol, atol=vel_atol, err_msg=f)
    np.testing.assert_allclose(got.yaw.numpy(), np.asarray(want.yaw),
                               rtol=yaw_rtol, atol=yaw_atol)
    np.testing.assert_allclose(got.time_remaining.numpy(),
                               np.asarray(want.time_remaining), rtol=1e-6,
                               atol=time_atol)
    np.testing.assert_allclose(got.last_key_press_time.numpy(),
                               np.asarray(want.last_key_press_time),
                               rtol=1e-6, atol=1e-6)


WORKER = Path(__file__).resolve().with_name("_torch_parallel_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(task, directory: Path, args, inputs=None, world=2,
              backend="gloo", device="cpu", timeout=180):
    """``task`` of ``tests/_torch_parallel_worker.py`` in ``world``
    processes joined by ``backend`` on ``device``; returns what each rank
    saved.  Each child has a process group timeout and this wall-clock
    limit."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "args.json").write_text(json.dumps(args))
    if inputs is not None:
        torch.save(inputs, directory / "inputs.pt")
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), task, init, str(r), str(world),
         str(directory), backend, device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}"
    return [torch.load(directory / f"rank{r}.pt", map_location="cpu")
            for r in range(world)]
