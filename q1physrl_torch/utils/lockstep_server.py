"""Fake lockstep Quake server: a headless stand-in for the reference's
modified quakespasm (``+sync_movements 1``), over the port's physics.

The reference validates sim-vs-real by driving its agent against a real
dedicated server patched to block each frame until a move command arrives
(reference mkdemo.py:121-129, README.md:104-107).  This module provides the
next-strongest oracle: a UDP server that speaks the genuine NetQuake
protocol-15 wire format (handshake, signon sequence, reliable/unreliable
framing, svc_*/clc_* messages — see utils/netclient.py for the format
notes) and advances the port's ``phys.apply`` one frame per received
``clc_move`` — exactly the lockstep discipline of the patched engine.

The player's physics runs on ``device`` (``cuda`` unless the caller asks for
the CPU): each frame sends its inputs and state to the device in one copy,
applies the move, and brings the new state back in one copy.  On the card
``phys.apply`` uses CUDA's ``sinf``/``cosf``, so its velocities can differ
from the CPU's by float32 ulps per frame; everything after (the origin
integrated in float64, the wire quantization) is host arithmetic.

Server-side quantization mirrors the engine paths the env's observation
model already models (reference env.py:381-390):

- client velocity is sent as ``trunc(v / 16)`` signed bytes
  (SV_WriteClientdataToMessage),
- origins as 13.3 fixed point with round-to-nearest (MSG_WriteCoord),
- move angles arrive byte-quantized (360/256 degrees, MSG_ReadAngle) and
  the server runs its physics on the QUANTIZED yaw, like the real engine.
"""

from __future__ import annotations

import asyncio
import math
import struct
from typing import Optional

import numpy as np
import torch

from .. import phys
from ..env.config import Config
from . import demfile
from .demfile import ServerMessageType as SVC
from .device import resolve_device
from .netclient import (CCREP_ACCEPT, CCREQ_CONNECT, CLC_DISCONNECT,
                        CLC_MOVE, CLC_NOP, CLC_STRINGCMD, NETFLAG_CTL,
                        NetQuakePacketLayer, _header)

__all__ = ("LockstepServer",)

SPAWN_ORIGIN = (0.0, 0.0, 32.84320068359375)
SPAWN_YAW = 90.0
FRAME_DT = 1.0 / 72
START_TIME = 1.3


class _ServerProtocol(asyncio.DatagramProtocol):
    def __init__(self, owner):
        self.owner = owner

    def connection_made(self, transport):
        self.owner._transport = transport

    def datagram_received(self, data, addr):
        self.owner._on_packet(data, addr)


class LockstepServer:
    """Single-client protocol-15 lockstep server over the port's player
    physics on ``device``."""

    def __init__(self, config: Optional[Config] = None,
                 level_name: str = "100m", finish_y: float = 3600.0,
                 device="cuda"):
        self.config = config or Config.get_default()
        self.device = resolve_device(device)
        self.level_name = level_name
        # The 100m practice map's finish trigger is ~3600 units along +y
        # from spawn; crossing it fires svc_intermission, exactly what the
        # real map's trigger_changelevel does and what parse_demo uses for
        # the finish time (reference analyse.py:66-67).
        self.finish_y = finish_y
        self.intermission_sent = False
        self._transport = None
        self._layer: Optional[NetQuakePacketLayer] = None
        self.port: Optional[int] = None
        self.time = START_TIME
        self.frames = 0
        self.moves: list[dict] = []
        self._reset_player()

    def _reset_player(self):
        # The env's canonical initial state (reference env.py:54-57).
        self.origin = np.array(SPAWN_ORIGIN, np.float64)
        self.vel = np.array([0.0, 0.0, -12.0], np.float64)
        self.on_ground = False
        self.jump_released = True
        self.yaw = SPAWN_YAW

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        loop = asyncio.get_running_loop()
        await loop.create_datagram_endpoint(
            lambda: _ServerProtocol(self), local_addr=(host, port))
        self.port = self._transport.get_extra_info("sockname")[1]
        self._resender = loop.create_task(self._resend_loop())
        return self.port

    async def _resend_loop(self):
        try:
            while True:
                await asyncio.sleep(0.25)
                if self._layer is not None:
                    self._layer.resend_pending()
        except asyncio.CancelledError:
            pass

    def close(self):
        resender = getattr(self, "_resender", None)
        if resender is not None:
            resender.cancel()
        if self._transport is not None:
            self._transport.close()

    # -- wire ------------------------------------------------------------

    def _on_packet(self, data: bytes, addr):
        if len(data) >= 5:
            (flags_len,) = struct.unpack_from(">I", data, 0)
            if flags_len & NETFLAG_CTL:
                if data[4] == CCREQ_CONNECT:
                    self._accept_client(addr)
                return
        if self._layer is None or addr != self._layer.peer:
            return
        kind, payload = self._layer.decode(data)
        if kind in ("reliable", "unreliable") and payload:
            self._handle_client_messages(payload)

    def _accept_client(self, addr):
        # CCREP_ACCEPT with our data port (same socket, engine-style).
        w = demfile._Writer()
        w.u8(CCREP_ACCEPT)
        w.s32(self.port)
        payload = w.getvalue()
        self._transport.sendto(_header(NETFLAG_CTL | (len(payload) + 4))
                               + payload, addr)
        # Duplicate/late connect retransmission (the client re-sends
        # every 1 s until accepted): answer with the existing accept but
        # do NOT rebuild the packet layer — resetting reliable sequence
        # state mid-signon desyncs the session.  The engine behaves the
        # same for an already-connected address (net_dgrm.c
        # _Datagram_CheckNewConnections).
        if self._layer is not None and addr == self._layer.peer:
            return
        self._layer = NetQuakePacketLayer(self._transport, addr)
        self._send_signon_1()

    def _send_signon_1(self):
        """SV_SendServerinfo: serverinfo + model/sound lists + signon 1."""
        w = demfile._Writer()
        w.u8(SVC.SERVERINFO)
        w.s32(demfile.PROTOCOL_VERSION)
        w.u8(1)   # maxclients
        w.u8(0)   # gametype
        w.string(self.level_name)
        w.string(f"maps/{self.level_name}.bsp")
        w.string("progs/player.mdl")
        w.string("")
        w.string("")
        w.u8(SVC.CDTRACK)
        w.u8(0)
        w.u8(0)
        w.u8(SVC.SIGNONNUM)
        w.u8(1)
        self._layer.send_reliable(w.getvalue())

    def _handle_client_messages(self, payload: bytes):
        r = demfile._Reader(payload)
        while not r.eof():
            cmd = r.u8()
            if cmd == CLC_NOP:
                continue
            if cmd == CLC_DISCONNECT:
                return
            if cmd == CLC_STRINGCMD:
                self._on_stringcmd(r.string())
            elif cmd == CLC_MOVE:
                move = {
                    "time": r.f32(),
                    "pitch": r.angle(), "yaw": r.angle(),
                    "roll": r.angle(),
                    "forward": r.s16(), "side": r.s16(), "up": r.s16(),
                    "buttons": r.u8(), "impulse": r.u8(),
                }
                self.moves.append(move)
                self._advance_frame(move)
            else:
                raise ValueError(f"unhandled client message {cmd}")

    def _on_stringcmd(self, cmd: str):
        cmd = cmd.strip()
        if cmd == "prespawn":
            w = demfile._Writer()
            # Baselines go out during prespawn (SV_CreateBaseline).
            w.u8(SVC.SETVIEW)
            w.s16(1)
            w.u8(SVC.SPAWNBASELINE)
            w.s16(1)
            w.u8(1)  # modelindex
            w.u8(0)  # frame
            w.u8(0)  # colormap
            w.u8(0)  # skin
            for c in SPAWN_ORIGIN:
                w.coord(c)
                w.angle(0)
            w.u8(SVC.SIGNONNUM)
            w.u8(2)
            self._layer.send_reliable(w.getvalue())
        elif cmd.startswith("spawn"):
            w = demfile._Writer()
            w.u8(SVC.SETANGLE)
            w.angle(0)
            w.angle(SPAWN_YAW)
            w.angle(0)
            w.u8(SVC.SIGNONNUM)
            w.u8(3)
            self._layer.send_reliable(w.getvalue())
        elif cmd == "begin":
            # +sync_movements discipline: NOTHING is sent until a move
            # arrives — the client's spawn-sync move triggers the first
            # frame (reference README.md:104-107).
            pass

    # -- lockstep physics ------------------------------------------------

    def _apply(self, move) -> list:
        """The move through ``phys.apply`` on the device, in float32 like
        the engine: one copy of the inputs and state there, one of the new
        state back.  Returns [z_pos, vel_x, vel_y, vel_z, on_ground,
        jump_released] as Python numbers."""
        # yaw (byte-quantized, like the engine), fmove, smove, dt, z, vel.
        floats = torch.tensor(
            [move["yaw"], move["forward"], move["side"], FRAME_DT,
             self.origin[2], *self.vel], dtype=torch.float32
        ).to(self.device)
        flags = torch.tensor(
            [bool(move["buttons"] & 2), self.on_ground, self.jump_released]
        ).to(self.device)
        one = lambda i: floats[i:i + 1]
        zero = torch.zeros_like(one(0))
        inputs = phys.Inputs(yaw=one(0), pitch=zero, roll=zero,
                             fmove=one(1), smove=one(2),
                             button2=flags[0:1], time_delta=one(3))
        state = phys.PlayerState(z_pos=one(4), vel_x=one(5), vel_y=one(6),
                                 vel_z=one(7), on_ground=flags[1:2],
                                 jump_released=flags[2:3])
        with torch.inference_mode():
            out = phys.apply(inputs, state)
            return torch.cat([out.z_pos, out.vel_x, out.vel_y, out.vel_z,
                              out.on_ground.to(torch.float32),
                              out.jump_released.to(torch.float32)]
                             ).tolist()

    def _advance_frame(self, move):
        """One +sync_movements frame: apply the move through the player
        physics, then emit the frame datagram."""
        z_pos, vel_x, vel_y, vel_z, on_ground, jump_released = self._apply(
            move)
        self.origin[0] += vel_x * FRAME_DT
        self.origin[1] += vel_y * FRAME_DT
        self.origin[2] = z_pos
        self.vel = np.array([vel_x, vel_y, vel_z], np.float64)
        self.on_ground = bool(on_ground)
        self.jump_released = bool(jump_released)
        self.yaw = move["yaw"]
        self.time += FRAME_DT
        self.frames += 1
        self._send_frame()

    def _send_frame(self):
        """svc_time + svc_clientdata + player fast update — the per-frame
        datagram SV_SendClientDatagram builds."""
        w = demfile._Writer()
        w.u8(SVC.TIME)
        w.f32(self.time)

        w.u8(SVC.CLIENTDATA)
        bits = (demfile.SU_VELOCITY1 | (demfile.SU_VELOCITY1 << 1)
                | (demfile.SU_VELOCITY1 << 2))
        w.s16(bits)
        for v in self.vel:
            # Engine: MSG_WriteChar(velocity[i] / 16) — C truncation.
            w.u8(int(math.trunc(v / 16.0)) & 0xFF)
        w.s32(0)   # items
        w.s16(100)  # health
        w.u8(0)    # ammo
        for _ in range(4):
            w.u8(0)
        w.u8(0)    # weapon

        ubits = (demfile.U_SIGNAL | demfile.U_MOREBITS | demfile.U_ORIGIN1
                 | demfile.U_ORIGIN2 | demfile.U_ORIGIN3 | demfile.U_ANGLE2)
        w.u8(ubits & 0xFF)
        w.u8((ubits >> 8) & 0xFF)
        w.u8(1)  # entity
        w.coord(self.origin[0])
        w.coord(self.origin[1])
        w.angle(self.yaw)
        w.coord(self.origin[2])

        if (not self.intermission_sent
                and self.origin[1] - SPAWN_ORIGIN[1] >= self.finish_y):
            w.u8(SVC.INTERMISSION)
            self.intermission_sent = True
        self._layer.send_unreliable(w.getvalue())
