"""The port's NetQuake protocol-15 client and lockstep oracle server against
the JAX package's: the packet layer's cases run on both packages, each
package's client is driven against the other's server over real UDP, and
the two servers, given the same moves, send the same frame datagrams.

Every socket binds an ephemeral port (port 0)."""

import asyncio
import dataclasses
import io
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch import mkdemo as tmkdemo
from q1physrl_torch.env import core as tcore
from q1physrl_torch.env.config import Config as TConfig
from q1physrl_torch.env.config import Key
from q1physrl_torch.utils import lockstep_server as tserver
from q1physrl_torch.utils import netclient as tnet
from q1physrl_tpu import mkdemo as jmkdemo
from q1physrl_tpu.env.config import Config as JConfig
from q1physrl_tpu.utils import lockstep_server as jserver
from q1physrl_tpu.utils import netclient as jnet

torch.set_num_threads(1)

PACKAGES = {"jax": (jnet, jserver), "torch": (tnet, tserver)}


def _server(package, *args, **kwargs):
    """The package's LockstepServer; the port's on the CPU."""
    net, srv = PACKAGES[package]
    if package == "torch":
        kwargs["device"] = "cpu"
    return srv.LockstepServer(*args, **kwargs)


class _Capture:
    def __init__(self):
        self.sent = []
        self.drop_next = False

    def sendto(self, data, addr):
        if self.drop_next:
            self.drop_next = False
            return  # the network ate it
        self.sent.append(data)


def _reliable_ack_roundtrip(net):
    a, b = _Capture(), _Capture()
    tx = net.NetQuakePacketLayer(a, ("x", 1))
    rx = net.NetQuakePacketLayer(b, ("y", 2))
    tx.send_reliable(b"hello")
    assert rx.decode(a.sent[-1]) == ("reliable", b"hello")
    (flags_len,) = np.frombuffer(b.sent[-1][:4], ">u4")
    assert int(flags_len) & net.NETFLAG_ACK
    tx.send_unreliable(b"frame1")
    tx.send_unreliable(b"frame2")
    p1, p2 = a.sent[-2], a.sent[-1]
    assert rx.decode(p2) == ("unreliable", b"frame2")  # arrives first
    assert rx.decode(p1)[0] is None  # late/stale -> dropped
    return a.sent + b.sent


def _fragmented_reassembly(net):
    rx = net.NetQuakePacketLayer(_Capture(), ("y", 2))
    frags = [b"aaa", b"bbbb", b"cc"]
    out = []
    for i, frag in enumerate(frags):
        flags = net.NETFLAG_DATA | (net.NETFLAG_EOM if i == len(frags) - 1
                                    else 0)
        out.append(rx.decode(net._header(flags | (len(frag) + 8), i) + frag))
    assert out == [(None, b""), (None, b""), ("reliable", b"aaabbbbcc")]
    # A duplicate fragment (stale sequence) does not corrupt the stream.
    dup = net._header(net.NETFLAG_DATA | net.NETFLAG_EOM | (2 + 8), 1) + b"zz"
    assert rx.decode(dup)[0] is None
    return rx.transport.sent


def _retransmission(net):
    wire_tx, wire_rx = _Capture(), _Capture()
    tx = net.NetQuakePacketLayer(wire_tx, ("x", 1))
    rx = net.NetQuakePacketLayer(wire_rx, ("y", 2))
    wire_tx.drop_next = True
    tx.send_reliable(b"first")       # lost on the wire
    tx.send_reliable(b"second")      # queued behind the in-flight packet
    assert wire_tx.sent == []
    tx.resend_pending()              # timer fires -> retransmit
    assert rx.decode(wire_tx.sent[-1]) == ("reliable", b"first")
    tx.decode(wire_rx.sent[-1])      # ACK flows back -> frees the queue
    assert rx.decode(wire_tx.sent[-1]) == ("reliable", b"second")
    # A duplicate delivery is dropped but re-ACKed.
    n_acks = len(wire_rx.sent)
    assert rx.decode(wire_tx.sent[-2])[0] is None
    assert len(wire_rx.sent) == n_acks + 1
    return wire_tx.sent + wire_rx.sent


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", [_reliable_ack_roundtrip,
                                  _fragmented_reassembly, _retransmission],
                         ids=lambda f: f.__name__.strip("_"))
def test_packet_layer(case, package):
    """The JAX package's packet-layer cases on each package, and the bytes
    each puts on the wire equal to the other's."""
    sent = case(PACKAGES[package][0])
    assert sent == case(PACKAGES["jax" if package == "torch" else "torch"][0])


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_client_wait_timeouts_fail_loudly(package):
    """Spawn waits raise TimeoutError instead of hanging when the server
    goes silent."""
    net, srv = PACKAGES[package]

    class _SilentServer(srv.LockstepServer):
        def _send_signon_1(self):
            pass  # accept the connection, then say nothing

    async def main():
        kwargs = {"device": "cpu"} if package == "torch" else {}
        server = _SilentServer(**kwargs)
        port = await server.start("127.0.0.1", 0)
        client = await net.AsyncClient.connect("127.0.0.1", port, timeout=5)
        try:
            with pytest.raises(TimeoutError):
                await client.wait_until_spawn(timeout=0.5)
        finally:
            await client.disconnect()
            server.close()

    asyncio.run(main())


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_duplicate_connect_does_not_desync_signon(package):
    """A retransmitted CCREQ_CONNECT mid-session keeps the server's packet
    layer, and the session still advances frames."""
    net, _ = PACKAGES[package]

    async def main():
        server = _server(package)
        port = await server.start("127.0.0.1", 0)
        client = await net.AsyncClient.connect("127.0.0.1", port, timeout=10)
        try:
            layer_before = server._layer
            req = (bytes([net.CCREQ_CONNECT]) + net.GAME_NAME.encode()
                   + b"\x00" + bytes([net.NET_PROTOCOL_VERSION]))
            client._transport.sendto(
                net._header(net.NETFLAG_CTL | (len(req) + 4)) + req,
                ("127.0.0.1", port))
            await client.wait_until_spawn(timeout=30)
            assert server._layer is layer_before
            for _ in range(5):
                client.move(0.0, math.radians(90), 0.0, 800, 0, 0, 0, 0)
                await asyncio.wait_for(
                    client.wait_for_movement(client.view_entity), 10)
            assert server.frames == 5 and client.time is not None
        finally:
            await client.disconnect()
            server.close()

    asyncio.run(main())


def _script(t, nk):
    """tests/test_netclient.py's schedule: forward for 100 frames with a
    jump burst, then left strafe with mouse -2."""
    ka = np.zeros((nk, 1), np.int32)
    ya = np.zeros((1,), np.float32)
    if t < 100:
        ka[Key.FORWARD] = 1
        if 40 <= t < 60:
            ka[Key.JUMP] = 1
    else:
        ka[Key.STRAFE_LEFT] = 1
        ya[0] = -2.0
    return ka, ya


def _scripted(convert, nk):
    counter = {"t": 0}

    def fn(obs, rng):
        counter["t"] += 1
        return tuple(convert(x) for x in _script(counter["t"] - 1, nk))

    return fn


def _bridge(mkdemo, package, cfg, convert):
    """``mkdemo._eval_coro`` (with its package's client) against
    ``package``'s server; returns (server, observations)."""

    async def main():
        server = _server(package, cfg)
        port = await server.start("127.0.0.1", 0)
        try:
            obs, _ = await asyncio.wait_for(mkdemo._eval_coro(
                cfg, port, _scripted(convert, cfg.num_keys), io.BytesIO(),
                host="127.0.0.1", **({"device": "cpu"}
                                     if mkdemo is tmkdemo else {})),
                timeout=120)
        finally:
            server.close()
        return server, np.asarray(obs, np.float64)

    return asyncio.run(main())


@pytest.fixture(scope="module")
def cross_runs():
    """The port's client against the JAX package's server, and the JAX
    package's client against the port's server, with the script."""
    tcfg = dataclasses.replace(TConfig.get_default(), zero_start_prob=1.0)
    jcfg = dataclasses.replace(JConfig.get_default(), zero_start_prob=1.0)
    return {
        "torch client, jax server": _bridge(tmkdemo, "jax", jcfg,
                                            torch.from_numpy),
        "jax client, torch server": _bridge(jmkdemo, "torch", tcfg,
                                            jnp.asarray),
    }


def _sim_observations(cfg):
    """The script in the port's sim: one zero-action frame (the bridge's
    spawn-sync move), the clock reset, then the script to the episode's
    end."""
    state = tcore.reset(cfg, torch.Generator().manual_seed(0), 1,
                        device="cpu")
    state, _ = tcore.step(cfg, state,
                          torch.zeros((cfg.num_keys, 1), dtype=torch.int32),
                          torch.zeros(1), compute_observation=False)
    state.time_remaining = torch.full((1,), cfg.time_limit)
    obs = []
    for t in range(2000):
        obs.append(tcore.compute_obs(cfg, state.player, state.yaw,
                                     state.time_remaining)[0].double()
                   .numpy())
        ka, ya = (torch.from_numpy(x) for x in _script(t, cfg.num_keys))
        state, out = tcore.step(cfg, state, ka, ya,
                                compute_observation=False)
        if bool(out.done[0]):
            break
    return np.asarray(obs)


@pytest.mark.parametrize("pair", ["torch client, jax server",
                                  "jax client, torch server"])
def test_cross_wired_bridge_matches_sim(cross_runs, pair):
    """Each package's client drives the other's server for a whole
    episode; the observations follow the sim as tests/test_netclient.py
    holds the JAX package's own bridge to it."""
    server, obs = cross_runs[pair]
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None,
                              zero_start_prob=1.0)
    sim = _sim_observations(cfg)
    assert server.frames >= 700
    assert abs(len(obs) - len(sim)) <= 2, (len(obs), len(sim))
    n = min(len(obs), len(sim))
    np.testing.assert_allclose(obs[:100], sim[:100], atol=1e-5)
    assert np.abs(obs[:n] - sim[:n]).max() < 0.3


def test_servers_send_identical_datagrams(cross_runs):
    """The two servers, given one run's move sequence, send the same frame
    datagrams byte for byte: the same wire quantization of the same
    float32 physics."""
    moves = cross_runs["torch client, jax server"][0].moves
    assert len(moves) >= 700

    class _Layer:
        def __init__(self):
            self.sent = []

        def send_unreliable(self, payload):
            self.sent.append(payload)

    sent = []
    for package in ("jax", "torch"):
        server = _server(package)
        server._layer = _Layer()
        for move in moves:
            server._advance_frame(move)
        sent.append(server._layer.sent)
    assert len(sent[0]) == len(moves)
    assert sent[0] == sent[1]
