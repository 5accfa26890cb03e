"""Minimal NetQuake protocol-15 network client (asyncio, UDP).

Host code only (numpy, asyncio, ``struct``): the same module as the JAX
package's, copied so that the port imports nothing of that package, and
held to it byte for byte on the wire by ``tests/test_torch_netclient.py``.

The reference drives its sim-to-real lockstep validation through the
external ``pyquake`` package (reference mkdemo.py:58-92: AsyncClient
connect / move / wait_for_movement / record_demo).  This module
reimplements that client surface natively so the L5 real-game bridge has
no external protocol dependency: the same wire bytes a real engine
expects, spoken over a real UDP socket.

Wire format (engine net_dgrm.c / net_main.c):

- Control packets (connection handshake) to the server's main port:
  ``[u32 BE  NETFLAG_CTL | length] [payload]`` where payload is
  ``CCREQ_CONNECT "QUAKE\\0" <u8 protocol=3>``; the server answers
  ``CCREP_ACCEPT <i32 LE data-port>`` (payload ints are little-endian —
  they are written with the engine's MSG_Write* routines; only the packet
  HEADER ints are big-endian).
- Data packets to the per-client data port:
  ``[u32 BE flags | length] [u32 BE sequence] [payload]`` with
  NETFLAG_DATA (reliable fragment; NETFLAG_EOM marks the last), ACKed by
  ``NETFLAG_ACK`` + same sequence; NETFLAG_UNRELIABLE carries the
  per-frame datagram stream.
- Server messages inside payloads are the same svc_* stream the demo
  format stores (utils/demfile.py); client->server messages are clc_*:
  ``clc_move <f32 time> <angle*3> <i16 fwd> <i16 side> <i16 up> <u8
  buttons> <u8 impulse>`` (CL_SendMove), ``clc_stringcmd <string>`` for
  the signon sequence ("prespawn" / "name" / "color" / "spawn" / "begin",
  CL_SignonReply).

The client records demos exactly like the engine does (CL_WriteDemoMessage:
each received payload framed as ``[i32 len][3 x f32 viewangles][bytes]``),
so recorded files parse with both utils.demfile.parse_demo and the
independent C++ parser (native/demparse.cpp).
"""

from __future__ import annotations

import asyncio
import math
import struct
from dataclasses import dataclass
from typing import Optional

from . import demfile
from .demfile import ServerMessageType as SVC

__all__ = ("AsyncClient", "Demo", "NetQuakePacketLayer")

# net.h packet header flags (header ints are big-endian on the wire).
NETFLAG_LENGTH_MASK = 0x0000FFFF
NETFLAG_DATA = 0x00010000
NETFLAG_ACK = 0x00020000
NETFLAG_NAK = 0x00040000
NETFLAG_EOM = 0x00080000
NETFLAG_UNRELIABLE = 0x00100000
NETFLAG_CTL = 0x80000000

# net_dgrm.c connection control opcodes.
CCREQ_CONNECT = 0x01
CCREP_ACCEPT = 0x81
CCREP_REJECT = 0x82

NET_PROTOCOL_VERSION = 3
GAME_NAME = "QUAKE"

# client -> server message opcodes (protocol.h clc_*).
CLC_BAD = 0
CLC_NOP = 1
CLC_DISCONNECT = 2
CLC_MOVE = 3
CLC_STRINGCMD = 4

MAX_DATAGRAM = 32000  # generous; engine uses 32000 for local, 1400 net


def _header(flags_len: int, seq: Optional[int] = None) -> bytes:
    h = struct.pack(">I", flags_len & 0xFFFFFFFF)
    if seq is not None:
        h += struct.pack(">I", seq & 0xFFFFFFFF)
    return h


class Demo:
    """In-memory demo recording (engine CL_WriteDemoMessage framing)."""

    def __init__(self):
        self._blocks: list[tuple[tuple, bytes]] = []
        self.recording = True

    def add(self, view_angles_deg, payload: bytes):
        if self.recording:
            self._blocks.append((tuple(view_angles_deg), bytes(payload)))

    def stop_recording(self):
        self.recording = False

    def dump(self, f, cd_track: int = -1):
        writer = demfile.DemoWriter(f, cd_track=cd_track)
        for angles, payload in self._blocks:
            writer.write_block(angles, payload)


@dataclass
class _EntityState:
    origin: tuple = (0.0, 0.0, 0.0)


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, owner):
        self.owner = owner

    def datagram_received(self, data, addr):
        self.owner._on_packet(data, addr)

    def error_received(self, exc):  # pragma: no cover - depends on OS
        self.owner._error = exc


class NetQuakePacketLayer:
    """Sequenced/reliable packet framing shared by client and (test)
    server endpoints."""

    def __init__(self, transport, peer):
        self.transport = transport
        self.peer = peer
        self.unreliable_send_seq = 0
        self.unreliable_recv_seq = 0
        self.reliable_send_seq = 0
        self.reliable_recv_seq = 0
        self._recv_reliable_buf = b""
        # NetQuake allows one reliable message in flight; it is resent
        # until ACKed (net_dgrm.c resends every frame).  Callers drive the
        # resend clock via resend_pending().
        self._in_flight: bytes | None = None
        self._in_flight_seq: int | None = None
        self._pending: list[bytes] = []

    def send_unreliable(self, payload: bytes):
        pkt = _header(NETFLAG_UNRELIABLE | (len(payload) + 8),
                      self.unreliable_send_seq) + payload
        self.unreliable_send_seq += 1
        self.transport.sendto(pkt, self.peer)

    def send_reliable(self, payload: bytes):
        # Single-fragment reliable send (our messages are tiny); the
        # engine would fragment at MAX_DATAGRAM.  One in flight at a time;
        # further sends queue until the ACK arrives.
        if self._in_flight is not None:
            self._pending.append(payload)
            return
        pkt = _header(NETFLAG_DATA | NETFLAG_EOM | (len(payload) + 8),
                      self.reliable_send_seq) + payload
        self._in_flight = pkt
        self._in_flight_seq = self.reliable_send_seq
        self.reliable_send_seq += 1
        self.transport.sendto(pkt, self.peer)

    def resend_pending(self):
        """Retransmit the un-ACKed reliable packet, if any (lost-UDP
        recovery; call on a timer)."""
        if self._in_flight is not None:
            self.transport.sendto(self._in_flight, self.peer)

    def _on_ack(self, seq: int):
        if seq == self._in_flight_seq:
            self._in_flight = self._in_flight_seq = None
            if self._pending:
                self.send_reliable(self._pending.pop(0))

    def _ack(self, seq: int):
        self.transport.sendto(_header(NETFLAG_ACK | 8, seq), self.peer)

    def decode(self, data: bytes):
        """-> (kind, payload) where kind is 'unreliable' | 'reliable' |
        'ack' | None (dropped/duplicate/control)."""
        if len(data) < 4:
            return None, b""
        (flags_len,) = struct.unpack_from(">I", data, 0)
        flags = flags_len & ~NETFLAG_LENGTH_MASK
        length = flags_len & NETFLAG_LENGTH_MASK
        if flags & NETFLAG_CTL or length != len(data):
            return None, b""
        (seq,) = struct.unpack_from(">I", data, 4)
        payload = data[8:]
        if flags & NETFLAG_UNRELIABLE:
            if seq < self.unreliable_recv_seq:
                return None, b""  # stale
            self.unreliable_recv_seq = seq + 1
            return "unreliable", payload
        if flags & NETFLAG_ACK:
            self._on_ack(seq)
            return "ack", b""
        if flags & NETFLAG_DATA:
            self._ack(seq)
            if seq != self.reliable_recv_seq:
                return None, b""  # duplicate
            self.reliable_recv_seq = seq + 1
            self._recv_reliable_buf += payload
            if flags & NETFLAG_EOM:
                msg = self._recv_reliable_buf
                self._recv_reliable_buf = b""
                return "reliable", msg
            return None, b""
        return None, b""


class AsyncClient:
    """Protocol-15 game client: the pyquake.client.AsyncClient surface the
    bridge uses (reference mkdemo.py:58-92), implemented natively.

    Attributes mirror pyquake: ``angles`` (radians, (pitch, yaw, roll)),
    ``velocity``, ``player_origin``, ``view_entity``, ``time``,
    ``level_name``.
    """

    def __init__(self):
        self.angles = (0.0, 0.0, 0.0)      # radians
        self.velocity = (0.0, 0.0, 0.0)
        self.view_entity: Optional[int] = None
        self.time: Optional[float] = None
        self.level_name: Optional[str] = None
        self.signon = 0
        self.intermission = False
        self.entities: dict[int, _EntityState] = {}
        self._baselines: dict[int, tuple] = {}
        self._spawned = asyncio.get_running_loop().create_future()
        self._moved: dict[int, asyncio.Future] = {}
        self._demos: list[Demo] = []
        self._error = None
        self._disconnected = False
        self._layer: Optional[NetQuakePacketLayer] = None
        # Datagrams can arrive between CCREP_ACCEPT and the connect
        # coroutine resuming to install the layer (same select batch on
        # loopback); buffer them instead of dropping the server's signon.
        self._pre_layer: list[bytes] = []
        self._transport = None

    # -- pyquake-compatible surface -------------------------------------

    @property
    def player_origin(self):
        if self.view_entity is None or self.view_entity not in self.entities:
            return (0.0, 0.0, 0.0)
        return self.entities[self.view_entity].origin

    @classmethod
    async def connect(cls, host: str, port: int,
                      timeout: float = 10.0) -> "AsyncClient":
        loop = asyncio.get_running_loop()
        self = cls()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Protocol(self), remote_addr=None,
            local_addr=("0.0.0.0", 0))
        # Connection handshake (net_dgrm.c _Datagram_Connect).
        req = (bytes([CCREQ_CONNECT]) + GAME_NAME.encode() + b"\x00"
               + bytes([NET_PROTOCOL_VERSION]))
        pkt = _header(NETFLAG_CTL | (len(req) + 4)) + req
        self._accept = loop.create_future()
        self._server_addr = (host, port)
        deadline = loop.time() + timeout
        # Handshake datagrams are as droppable as any other: re-send the
        # connect request until accepted.  On timeout, close the
        # transport we just created — the caller never sees the client
        # object, so nobody else can release the socket.
        try:
            while not self._accept.done():
                if loop.time() > deadline:
                    raise TimeoutError("no CCREP_ACCEPT from server")
                self._transport.sendto(pkt, (host, port))
                try:
                    await asyncio.wait_for(asyncio.shield(self._accept), 1.0)
                except asyncio.TimeoutError:
                    pass
        except BaseException:
            self._transport.close()
            raise
        data_port = self._accept.result()
        self._layer = NetQuakePacketLayer(self._transport,
                                          (host, data_port))
        for data in self._pre_layer:
            self._on_packet(data, (host, data_port))
        self._pre_layer.clear()
        self._resender = asyncio.get_running_loop().create_task(
            self._resend_loop())
        return self

    async def _resend_loop(self):
        # Retransmit un-ACKed reliables (NetQuake resends every frame;
        # 0.25 s is plenty for the signon sequence).
        try:
            while not self._disconnected:
                await asyncio.sleep(0.25)
                if self._layer is not None:
                    self._layer.resend_pending()
        except asyncio.CancelledError:
            pass

    def record_demo(self) -> Demo:
        demo = Demo()
        self._demos.append(demo)
        return demo

    async def wait_until_spawn(self, timeout: float = 30.0):
        await asyncio.wait_for(asyncio.shield(self._spawned), timeout)

    async def wait_for_movement(self, entity_num: int,
                                timeout: float = 30.0):
        fut = asyncio.get_running_loop().create_future()
        self._moved[entity_num] = fut
        await asyncio.wait_for(fut, timeout)

    def move(self, pitch, yaw, roll, forward, side, up, buttons, impulse):
        """Send a clc_move (CL_SendMove layout).  Angles in RADIANS for
        pyquake API compatibility."""
        w = demfile._Writer()
        w.u8(CLC_MOVE)
        w.f32(self.time if self.time is not None else 0.0)
        for a in (pitch, yaw, roll):
            w.angle(math.degrees(a))
        w.s16(int(forward))
        w.s16(int(side))
        w.s16(int(up))
        w.u8(int(buttons))
        w.u8(int(impulse))
        # The engine records demos with the CURRENT view angles; keep them
        # in sync with what we just sent so recorded blocks carry the
        # commanded yaw (what parse_demo extracts).
        self.angles = (float(pitch), float(yaw), float(roll))
        self._layer.send_unreliable(w.getvalue())

    async def disconnect(self):
        if self._layer is not None and not self._disconnected:
            self._disconnected = True
            w = demfile._Writer()
            w.u8(CLC_DISCONNECT)
            self._layer.send_unreliable(w.getvalue())
        resender = getattr(self, "_resender", None)
        if resender is not None:
            resender.cancel()
        if self._transport is not None:
            self._transport.close()

    # -- wire handling ---------------------------------------------------

    def _send_stringcmd(self, cmd: str):
        w = demfile._Writer()
        w.u8(CLC_STRINGCMD)
        w.string(cmd)
        self._layer.send_reliable(w.getvalue())

    def _on_packet(self, data: bytes, addr):
        # Control-phase: CCREP_ACCEPT carries the data port (LE long).
        if self._layer is None:
            if len(data) >= 9:
                (flags_len,) = struct.unpack_from(">I", data, 0)
                if flags_len & NETFLAG_CTL and data[4] == CCREP_ACCEPT:
                    (port,) = struct.unpack_from("<i", data, 5)
                    if not self._accept.done():
                        self._accept.set_result(port)
                    return
            self._pre_layer.append(bytes(data))
            return
        kind, payload = self._layer.decode(data)
        if kind in ("unreliable", "reliable") and payload:
            self._handle_messages(payload)

    def _handle_messages(self, payload: bytes):
        view_deg = tuple(math.degrees(a) for a in self.angles)
        for demo in self._demos:
            demo.add(view_deg, payload)
        r = demfile._Reader(payload)
        while not r.eof():
            msg = r.u8()
            if msg & demfile.U_SIGNAL:
                upd = demfile._read_fast_update(r, msg)
                ent = self.entities.setdefault(upd.entity_num,
                                               _EntityState())
                # Engine semantics (CL_ParseUpdate): an omitted origin
                # component resets to the entity's BASELINE, not to the
                # previous frame's value — servers omit components within
                # 0.1 of the baseline, so previous-frame patching would go
                # stale.  (The demo PARSERS deliberately keep
                # previous-frame patching instead: that is what the
                # reference's pyquake-based parse_demo does, reference
                # analyse.py:47-58.)
                base = self._baselines.get(upd.entity_num, ent.origin)
                ent.origin = tuple(
                    b if u is None else u
                    for b, u in zip(base, upd.origin))
                fut = self._moved.pop(upd.entity_num, None)
                if fut is not None and not fut.done():
                    fut.set_result(None)
                continue
            t = SVC
            if msg == t.NOP:
                pass
            elif msg == t.DISCONNECT:
                self._disconnected = True
                return
            elif msg == t.TIME:
                self.time = r.f32()
            elif msg == t.CLIENTDATA:
                self._read_clientdata(r)
            elif msg == t.SETVIEW:
                self.view_entity = r.s16()
            elif msg == t.SETANGLE:
                self.angles = tuple(math.radians(r.angle())
                                    for _ in range(3))
            elif msg == t.SERVERINFO:
                r.s32()           # protocol
                r.u8()            # maxclients
                r.u8()            # gametype
                self.level_name = r.string()
                while r.string():
                    pass
                while r.string():
                    pass
            elif msg == t.SIGNONNUM:
                self._on_signon(r.u8())
            elif msg == t.SPAWNBASELINE:
                ent = r.s16()
                r.u8(); r.u8(); r.u8(); r.u8()
                origin = []
                for _ in range(3):
                    origin.append(r.coord())
                    r.angle()
                self._baselines[ent] = tuple(origin)
                self.entities.setdefault(
                    ent, _EntityState()).origin = tuple(origin)
            elif msg == t.INTERMISSION:
                self.intermission = True
            elif msg == t.STUFFTEXT:
                r.string()  # cvar pushes etc.; nothing to honor headless
            elif msg in (t.PRINT, t.CENTERPRINT, t.FINALE, t.CUTSCENE):
                r.string()
            elif msg == t.UPDATESTAT:
                r.u8(); r.s32()
            elif msg == t.VERSION:
                r.s32()
            elif msg == t.PARTICLE:
                for _ in range(3):
                    r.coord()
                for _ in range(3):
                    r.s8()
                r.u8(); r.u8()
            elif msg == t.DAMAGE:
                r.u8(); r.u8()
                for _ in range(3):
                    r.coord()
            elif msg == t.SOUND:
                demfile._skip_sound(r)
            elif msg == t.LIGHTSTYLE:
                r.u8(); r.string()
            elif msg == t.UPDATENAME:
                r.u8(); r.string()
            elif msg == t.UPDATEFRAGS:
                r.u8(); r.s16()
            elif msg == t.STOPSOUND:
                r.s16()
            elif msg == t.UPDATECOLORS:
                r.u8(); r.u8()
            elif msg == t.SPAWNSTATIC:
                demfile._read_baseline(r)
            elif msg == t.SPAWNSTATICSOUND:
                for _ in range(3):
                    r.coord()
                r.u8(); r.u8(); r.u8()
            elif msg == t.TEMP_ENTITY:
                demfile._skip_temp_entity(r)
            elif msg == t.CDTRACK:
                r.u8(); r.u8()
            elif msg == t.SETPAUSE:
                r.u8()
            elif msg in (t.KILLEDMONSTER, t.FOUNDSECRET, t.SELLSCREEN):
                pass
            else:
                raise ValueError(f"unhandled server message {msg}")

    def _read_clientdata(self, r: demfile._Reader):
        """SV_WriteClientdataToMessage layout; velocity components are
        sent as value/16 in a signed byte."""
        bits = r.u16()
        if bits & demfile.SU_VIEWHEIGHT:
            r.s8()
        if bits & demfile.SU_IDEALPITCH:
            r.s8()
        vel = list(self.velocity)
        for i in range(3):
            if bits & (demfile.SU_PUNCH1 << i):
                r.s8()
            if bits & (demfile.SU_VELOCITY1 << i):
                vel[i] = r.s8() * 16.0
        self.velocity = tuple(vel)
        r.s32()  # items
        if bits & demfile.SU_WEAPONFRAME:
            r.u8()
        if bits & demfile.SU_ARMOR:
            r.u8()
        if bits & demfile.SU_WEAPON:
            r.u8()
        r.s16()  # health
        r.u8()   # ammo
        for _ in range(4):
            r.u8()
        r.u8()   # active weapon

    def _on_signon(self, num: int):
        """CL_SignonReply."""
        self.signon = num
        if num == 1:
            self._send_stringcmd("prespawn")
        elif num == 2:
            self._send_stringcmd('name "q1physrl"\n')
            self._send_stringcmd("color 0 0\n")
            self._send_stringcmd("spawn ")
        elif num == 3:
            self._send_stringcmd("begin")
            if not self._spawned.done():
                self._spawned.set_result(None)
