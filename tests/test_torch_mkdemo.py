"""The port's demo path against the JAX package's: the simulated export
(the .dem bytes from one trajectory, and tpu_pb's export on the CPU), the
lockstep loop's move commands, ``make_demo`` against a stub engine on a
free port, the CLI in both modes, and the two constants chip_smoke.py holds
the card's demos to.

Kernel #1 itself is held against its plain version on the card by
chip_smoke.py (phase 4c) and tests/test_torch_cuda.py; here its wrapper
runs the plain version on CPU tensors."""

import asyncio
import dataclasses
import io
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch import mkdemo as tmkdemo
from q1physrl_torch import native as tnative
from q1physrl_torch.algo.config import load_run_config as tload
from q1physrl_torch.env.config import Key
from q1physrl_torch.utils import demfile as tdemfile
from q1physrl_torch.utils.lockstep_server import LockstepServer as TServer
from q1physrl_tpu import analyse as janalyse
from q1physrl_tpu import mkdemo as jmkdemo
from q1physrl_tpu import models as jmodels
from q1physrl_tpu.algo.train import load_run_config as jload
from q1physrl_tpu.utils import demfile as jdemfile
from q1physrl_tpu.utils.lockstep_server import LockstepServer as JServer

import chip_smoke

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = str(ROOT / "configs" / "run4.yml")
CHECKPOINTS = ROOT / "data" / "checkpoints"
TPU_PB = str(CHECKPOINTS / "tpu_pb" / "checkpoint")
R5_RLLIB = str(CHECKPOINTS / "repl_r5" / "best_member_02_rllib")
FRAME = 1.0 / 72


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """The JAX package's export_sim_demo of tpu_pb on the CPU: its result,
    corrected finish and .dem bytes."""
    path = tmp_path_factory.mktemp("jax_export") / "run.dem"
    r, corrected = jmkdemo.export_sim_demo(
        jmodels.import_policy_params(TPU_PB), jload(RUN4).env, str(path))
    return r, corrected, path.read_bytes()


def test_demo_bytes_from_the_jax_trajectory(jax_export, tmp_path):
    """The port's trajectory_from_result and demfile.write_demo, fed the
    JAX EvalSimResult's arrays, write the JAX function's .dem byte for
    byte."""
    r, corrected, want = jax_export
    times, origins, yaws = tmkdemo.trajectory_from_result(r)
    crossed = np.nonzero(origins[:, 1] - tmkdemo.SPAWN_ORIGIN[1]
                         >= 3600.0)[0]
    finish = float(times[crossed[0]])
    path = tmp_path / "port.dem"
    tdemfile.write_demo(str(path), times, origins, yaws, finish_time=finish)
    assert path.read_bytes() == want
    assert tmkdemo._corrected(finish, times) == corrected


def test_export_sim_demo_matches_jax(jax_export, tmp_path):
    """tpu_pb's deterministic export on the CPU: the same finish frame
    within one, origins within 1e-2, and the .dem parses alike through the
    port's reader and its C++ binding."""
    jr, jcorrected, _ = jax_export
    run = tload(RUN4)
    _, policy = tmkdemo.load_policy(RUN4, TPU_PB, "cpu")
    path = tmp_path / "run.dem"
    r, corrected = tmkdemo.export_sim_demo(policy, run.env, str(path),
                                           device="cpu")
    assert abs(corrected - jcorrected) <= FRAME + 1e-9
    _, origins, _ = tmkdemo.trajectory_from_result(r)
    _, jorigins, _ = jmkdemo.trajectory_from_result(jr)
    n = min(len(origins), len(jorigins))
    assert abs(len(origins) - len(jorigins)) <= 1
    np.testing.assert_allclose(origins[:n], jorigins[:n], atol=1e-2)
    parsed = tdemfile.parse_demo(str(path))
    if tnative.dem_available():
        for a, b in zip(tnative.parse_demo(str(path))[:3], parsed[:3]):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype))
    assert parsed[3] == pytest.approx(corrected - tmkdemo.DEMO_TIME_CORRECTION
                                      + parsed[0][0])


class _MockClient:
    """A lockstep 'engine' without sockets: one frame of the port's physics
    per move (the +sync_movements contract), the wire's quantization on
    what it reports, and every move command kept."""

    def __init__(self):
        self.server = TServer(device="cpu")
        self.angles = (0.0, float(np.deg2rad(90.0)), 0.0)
        self.time = 1.25
        self.view_entity = 1
        self.moves = []
        self._spawn_frame = True

    @classmethod
    async def connect(cls, host, port):
        return cls()

    def record_demo(self):
        class _Demo:
            def stop_recording(self):
                pass

            def dump(self, f):
                f.write(b"MOCKDEMO")

        return _Demo()

    async def wait_until_spawn(self):
        pass

    def move(self, pitch, yaw, roll, forward=0, side=0, up=0, buttons=0,
             impulse=0):
        self.angles = (pitch, yaw, roll)
        self.moves.append((yaw, forward, side, buttons))

    async def wait_for_movement(self, entity):
        if self._spawn_frame:
            self._spawn_frame = False
            return
        yaw, forward, side, buttons = self.moves[-1]
        z, vx, vy, vz, og, jr = self.server._apply(
            {"yaw": float(np.rad2deg(yaw)), "forward": forward,
             "side": side, "buttons": buttons})
        s = self.server
        s.origin[2], s.vel[:] = z, (vx, vy, vz)
        s.on_ground, s.jump_released = bool(og), bool(jr)
        self.time += FRAME

    @property
    def velocity(self):
        return np.trunc(self.server.vel / 16.0) * 16.0

    @property
    def player_origin(self):
        return np.array([0.0, 0.0, np.round(self.server.origin[2] * 8) / 8])

    async def disconnect(self):
        pass


def _scripted(convert, nk):
    counter = {"t": 0}

    def fn(obs, rng):
        t = counter["t"]
        counter["t"] += 1
        ka = np.zeros((nk, 1), np.int32)
        ya = np.zeros((1,), np.float32)
        if t < 100:
            ka[Key.FORWARD] = 1
            if 40 <= t < 60:
                ka[Key.JUMP] = 1
        else:
            ka[Key.STRAFE_LEFT] = 1
            ya[0] = -2.0
        return convert(ka), convert(ya)

    return fn


def test_eval_coro_sends_the_jax_move_commands():
    """Both packages' lockstep loops, driving the same mock engine with the
    same script, send the same move commands and build the same
    observations, over 3 s episodes (both phases of the script)."""
    cfg = dataclasses.replace(tload(RUN4).env, num_envs=None,
                              zero_start_prob=1.0, time_limit=3.0)
    jcfg = dataclasses.replace(jload(RUN4).env, num_envs=None,
                               zero_start_prob=1.0, time_limit=3.0)
    clients = {}

    def capture(name):
        class Client(_MockClient):
            @classmethod
            async def connect(cls, host, port):
                clients[name] = cls()
                return clients[name]
        return Client

    sink = io.BytesIO()
    record = []
    tobs, tact = asyncio.run(tmkdemo._eval_coro(
        cfg, 0, _scripted(torch.from_numpy, cfg.num_keys), sink,
        client_cls=capture("torch"), device="cpu", record=record))
    jobs, jact = asyncio.run(jmkdemo._eval_coro(
        jcfg, 26000, _scripted(jnp.asarray, cfg.num_keys), io.BytesIO(),
        client_cls=capture("jax")))
    assert sink.getvalue() == b"MOCKDEMO"
    assert clients["torch"].moves == clients["jax"].moves
    assert len(tobs) == len(jobs) == len(record) >= 3 * 72
    np.testing.assert_array_equal(np.asarray(tobs), np.asarray(jobs))
    for (ka, ya), (jka, jya) in zip(tact, jact):
        np.testing.assert_array_equal(ka, np.asarray(jka))
        np.testing.assert_array_equal(ya, np.asarray(jya))
    # The yaw sent is the yaw the decoder's step wrote.
    for frame, move in zip(record, clients["torch"].moves[1:]):
        assert frame["sent"][0] == float(frame["kernel_yaw"][0])
        assert move[0] == frame["sent"][0] * np.pi / 180


def test_make_demo_against_stub_engine(tmp_path, monkeypatch):
    """make_demo spawns the engine with the reference's argument list plus
    ``-port``, drives tpu_pb through it over UDP, records a demo, stops the
    engine with SIGINT and reports the corrected finish."""
    stub = chip_smoke.write_stub(tmp_path, "cpu")
    dem = tmp_path / "out.dem"
    port = chip_smoke._free_udp_port()
    spawned = []
    real_exec = asyncio.create_subprocess_exec

    async def spy(*args, **kwargs):
        spawned.append(args)
        return await real_exec(*args, **kwargs)

    monkeypatch.setattr(asyncio, "create_subprocess_exec", spy)
    corrected = asyncio.run(tmkdemo.make_demo(
        TPU_PB, RUN4, str(stub), str(tmp_path), str(dem), port=port,
        device="cpu"))
    (args,) = spawned
    assert args[:7] == (str(stub), "-protocol", "15", "-dedicated", "1",
                        "-basedir", str(tmp_path))
    assert args[7:9] == ("-port", str(port))
    assert args[-2:] == ("+map", "100m")
    times, origins, _, finish = tdemfile.parse_demo(str(dem))
    assert len(times) >= 700
    np.testing.assert_allclose(np.diff(times), FRAME, atol=1e-5)
    assert abs(origins[0][2] - 32.875) < 1e-4
    assert finish is not None
    assert corrected == pytest.approx(
        finish + tmkdemo.DEMO_TIME_CORRECTION - times[0])
    # The stub saw make_demo's SIGINT after serving every frame.
    assert int(Path(f"{stub}.stopped").read_text()) == len(times)


def _engine(tmp_path, body):
    """An executable shell script standing in for the engine."""
    engine = tmp_path / "engine.sh"
    engine.write_text("#!/bin/sh\n" + body + "\n")
    engine.chmod(0o755)
    return str(engine)


def test_make_demo_raises_when_the_engine_exits(tmp_path):
    """An engine that exits before the demo is recorded fails make_demo at
    once, naming its exit code, instead of waiting out the handshake."""
    engine = _engine(tmp_path, "exit 3")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with code 3"):
        asyncio.run(tmkdemo.make_demo(
            TPU_PB, RUN4, engine, str(tmp_path), str(tmp_path / "x.dem"),
            port=chip_smoke._free_udp_port(), device="cpu"))
    assert time.monotonic() - t0 < tmkdemo.ENGINE_START_S / 4


def test_make_demo_bounds_the_engine_start(tmp_path, monkeypatch):
    """The handshake waits ENGINE_START_S for an engine that never answers,
    then raises, and the engine is stopped with SIGINT."""
    monkeypatch.setattr(tmkdemo, "ENGINE_START_S", 1.0)
    stopped = tmp_path / "stopped"
    engine = _engine(tmp_path, f"trap 'echo int > {stopped}; exit 0' INT\n"
                               "while :; do sleep 0.05; done")
    with pytest.raises(TimeoutError):
        asyncio.run(tmkdemo.make_demo(
            TPU_PB, RUN4, engine, str(tmp_path), str(tmp_path / "x.dem"),
            port=chip_smoke._free_udp_port(), device="cpu"))
    assert stopped.read_text() == "int\n"


def test_default_engine_port_adds_no_argument(tmp_path, monkeypatch):
    """With quakespasm's own port the argument list is the JAX package's."""
    spawned = []

    class _Stop(Exception):
        pass

    async def spy(*args, **kwargs):
        spawned.append(args)
        raise _Stop

    monkeypatch.setattr(asyncio, "create_subprocess_exec", spy)
    with pytest.raises(_Stop):
        asyncio.run(tmkdemo.make_demo(TPU_PB, RUN4, "qs", "game",
                                      str(tmp_path / "x.dem"), device="cpu"))
    assert "-port" not in spawned[0]
    assert spawned[0][1:7] == ("-protocol", "15", "-dedicated", "1",
                               "-basedir", "game")


@pytest.fixture(scope="module")
def jax_lockstep(tmp_path_factory):
    """The JAX package's lockstep run of round 5's winner on the CPU:
    frames and corrected finish."""
    run = jload(RUN4)
    params = jmodels.import_policy_params(R5_RLLIB + "/checkpoint")
    fn = janalyse._policy_from(params, run.env, deterministic=True)
    path = tmp_path_factory.mktemp("jax_lockstep") / "r5.dem"

    async def main():
        server = JServer(run.env)
        port = await server.start("127.0.0.1", 0)
        try:
            with open(path, "wb") as f:
                await jmkdemo._eval_coro(run.env, port, fn, f,
                                         host="127.0.0.1")
        finally:
            server.close()

    asyncio.run(main())
    times, _, _, finish = jdemfile.parse_demo(str(path))
    return len(times), finish + jmkdemo.DEMO_TIME_CORRECTION - times[0]


def test_chip_smoke_constants_are_the_jax_runs(jax_export, jax_lockstep):
    """chip_smoke.py holds the card's demos to the JAX package's CPU runs
    through constants: these are those runs."""
    assert jax_export[1] == chip_smoke.DEMO_EXPORT_FINISH
    assert jax_lockstep == (chip_smoke.DEMO_LOCKSTEP_FRAMES,
                            chip_smoke.DEMO_LOCKSTEP_FINISH)


def test_cli_export(tmp_path, capsys):
    dem = tmp_path / "run.dem"
    r, corrected = tmkdemo.main([RUN4, TPU_PB, str(dem), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"wrote {dem}: return=") and "corrected_finish=" in out
    assert abs(corrected - chip_smoke.DEMO_EXPORT_FINISH) <= \
        chip_smoke.DEMO_FINISH_TOL
    assert len(tdemfile.parse_demo(str(dem))[0]) == len(r.reward)


def test_cli_lockstep(tmp_path, capsys):
    """Round 5's winner over the lockstep bridge on the CPU, given as a
    directory: within chip_smoke's limits of the JAX package's run."""
    dem = tmp_path / "r5.dem"
    times, origins, _, finish = tmkdemo.main(
        ["--lockstep", RUN4, R5_RLLIB, str(dem), "--device", "cpu"])
    assert capsys.readouterr().out.startswith(
        f"wrote {dem} via lockstep bridge: {len(times)} frames")
    assert abs(len(times) - chip_smoke.DEMO_LOCKSTEP_FRAMES) <= 2
    assert abs(tmkdemo._corrected(finish, times)
               - chip_smoke.DEMO_LOCKSTEP_FINISH) <= chip_smoke.DEMO_FINISH_TOL
    assert origins[-1][1] > 3600


def test_cli_raises_without_a_card(tmp_path):
    """The CLI runs on the card unless told otherwise; it does not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmkdemo.main([RUN4, TPU_PB, str(tmp_path / "x.dem")])
