"""Quake protocol-15 .dem demo file writer/reader (pyquake-subset).

The reference depends on the external ``pyquake`` package to parse demo
files (reference analyse.py:34-68) and to speak the network protocol
(mkdemo.py).  This module reimplements, from the NetQuake protocol-15 wire
format, the subset the framework needs:

- ``parse_demo``: extract (times, origins, yaws, finish_time) from a demo,
  tracking the view entity exactly like the reference parser — SETVIEW /
  SPAWNBASELINE / fast-entity-UPDATE / TIME / INTERMISSION handling.
- ``write_demo``: serialize a simulated trajectory into a structurally
  valid .dem (serverinfo + baseline + per-frame time/update blocks), so
  runs can be exported, round-tripped through ``parse_demo``, and fed to
  the video tooling.

Wire format notes: a demo is an ASCII CD-track line then length-prefixed
blocks ``[i32 len][3 x f32 view angles][len bytes of server messages]``.
Coordinates are 13.3 fixed point (i16 / 8); angles are signed bytes
(value * 256 / 360).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ("parse_demo", "write_demo", "DemoWriter", "ServerMessageType")


class ServerMessageType:
    BAD = 0
    NOP = 1
    DISCONNECT = 2
    UPDATESTAT = 3
    VERSION = 4
    SETVIEW = 5
    SOUND = 6
    TIME = 7
    PRINT = 8
    STUFFTEXT = 9
    SETANGLE = 10
    SERVERINFO = 11
    LIGHTSTYLE = 12
    UPDATENAME = 13
    UPDATEFRAGS = 14
    CLIENTDATA = 15
    STOPSOUND = 16
    UPDATECOLORS = 17
    PARTICLE = 18
    DAMAGE = 19
    SPAWNSTATIC = 20
    SPAWNBASELINE = 22
    TEMP_ENTITY = 23
    SETPAUSE = 24
    SIGNONNUM = 25
    CENTERPRINT = 26
    KILLEDMONSTER = 27
    FOUNDSECRET = 28
    SPAWNSTATICSOUND = 29
    INTERMISSION = 30
    FINALE = 31
    CDTRACK = 32
    SELLSCREEN = 33
    CUTSCENE = 34
    UPDATE = 128  # fast entity update (0x80 bit)


# Fast-update bits (protocol.h U_*).
U_MOREBITS = 1 << 0
U_ORIGIN1 = 1 << 1
U_ORIGIN2 = 1 << 2
U_ORIGIN3 = 1 << 3
U_ANGLE2 = 1 << 4
U_NOLERP = 1 << 5
U_FRAME = 1 << 6
U_SIGNAL = 1 << 7
U_ANGLE1 = 1 << 8
U_ANGLE3 = 1 << 9
U_MODEL = 1 << 10
U_COLORMAP = 1 << 11
U_SKIN = 1 << 12
U_EFFECTS = 1 << 13
U_LONGENTITY = 1 << 14

# Clientdata bits (protocol.h SU_*).
SU_VIEWHEIGHT = 1 << 0
SU_IDEALPITCH = 1 << 1
SU_PUNCH1 = 1 << 2
SU_PUNCH2 = 1 << 3
SU_PUNCH3 = 1 << 4
SU_VELOCITY1 = 1 << 5
SU_VELOCITY2 = 1 << 6
SU_VELOCITY3 = 1 << 7
SU_ONGROUND = 1 << 9
SU_INWATER = 1 << 10
SU_WEAPONFRAME = 1 << 12
SU_ARMOR = 1 << 13
SU_WEAPON = 1 << 14

PROTOCOL_VERSION = 15


class _Reader:
    """Bounds-checked message reader: every read past the end of the
    buffer raises ValueError (mirrors the native parser's Reader::need,
    native/demparse.cpp) so truncated or garbage streams fail cleanly
    instead of leaking struct.error/IndexError or silently misparsing."""

    def __init__(self, data: bytes):
        self.b = data
        self.i = 0

    def eof(self):
        return self.i >= len(self.b)

    def _need(self, n: int):
        if self.i + n > len(self.b):
            raise ValueError(
                f"truncated message: need {n} byte(s) at offset "
                f"{self.i} of {len(self.b)}")

    def u8(self):
        self._need(1)
        v = self.b[self.i]
        self.i += 1
        return v

    def s8(self):
        self._need(1)
        v = struct.unpack_from("<b", self.b, self.i)[0]
        self.i += 1
        return v

    def u16(self):
        self._need(2)
        v = struct.unpack_from("<H", self.b, self.i)[0]
        self.i += 2
        return v

    def s16(self):
        self._need(2)
        v = struct.unpack_from("<h", self.b, self.i)[0]
        self.i += 2
        return v

    def s32(self):
        self._need(4)
        v = struct.unpack_from("<i", self.b, self.i)[0]
        self.i += 4
        return v

    def f32(self):
        self._need(4)
        v = struct.unpack_from("<f", self.b, self.i)[0]
        self.i += 4
        return v

    def string(self):
        end = self.b.find(b"\x00", self.i)
        if end < 0:
            raise ValueError(
                f"unterminated string at offset {self.i} of {len(self.b)}")
        s = self.b[self.i:end].decode("latin-1")
        self.i = end + 1
        return s

    def coord(self):
        return self.s16() / 8.0

    def angle(self):
        return self.s8() * 360.0 / 256.0


@dataclass
class _Update:
    entity_num: int
    origin: tuple  # per-component Optional[float]


def _read_fast_update(r: _Reader, first_byte: int) -> _Update:
    bits = first_byte & 0x7F
    if bits & U_MOREBITS:
        bits |= r.u8() << 8
    entity = r.s16() if bits & U_LONGENTITY else r.u8()
    if bits & U_MODEL:
        r.u8()
    if bits & U_FRAME:
        r.u8()
    if bits & U_COLORMAP:
        r.u8()
    if bits & U_SKIN:
        r.u8()
    if bits & U_EFFECTS:
        r.u8()
    o = [None, None, None]
    if bits & U_ORIGIN1:
        o[0] = r.coord()
    if bits & U_ANGLE1:
        r.angle()
    if bits & U_ORIGIN2:
        o[1] = r.coord()
    if bits & U_ANGLE2:
        r.angle()
    if bits & U_ORIGIN3:
        o[2] = r.coord()
    if bits & U_ANGLE3:
        r.angle()
    return _Update(entity, tuple(o))


def _skip_clientdata(r: _Reader):
    bits = r.u16()
    if bits & SU_VIEWHEIGHT:
        r.s8()
    if bits & SU_IDEALPITCH:
        r.s8()
    for i in range(3):
        if bits & (SU_PUNCH1 << i):
            r.s8()
        if bits & (SU_VELOCITY1 << i):
            r.s8()
    r.s32()  # items (always sent)
    if bits & SU_WEAPONFRAME:
        r.u8()
    if bits & SU_ARMOR:
        r.u8()
    if bits & SU_WEAPON:
        r.u8()
    r.s16()  # health
    r.u8()   # ammo
    for _ in range(4):
        r.u8()  # shells/nails/rockets/cells
    r.u8()   # active weapon


def _skip_sound(r: _Reader):
    mask = r.u8()
    if mask & 1:
        r.u8()  # volume
    if mask & 2:
        r.u8()  # attenuation
    r.s16()  # (entity << 3) | channel
    r.u8()   # sound number
    for _ in range(3):
        r.coord()


def _read_baseline(r: _Reader):
    r.u8()  # modelindex
    r.u8()  # frame
    r.u8()  # colormap
    r.u8()  # skin
    origin = []
    for _ in range(3):
        origin.append(r.coord())
        r.angle()
    return tuple(origin)


def _skip_temp_entity(r: _Reader):
    t = r.u8()
    if t in (0, 1, 2, 3, 4, 7, 8, 10, 11):  # point effects: coord*3
        size = 6
    elif t in (5, 6, 9, 13):  # beams: entity short + 2 * coord*3
        size = 2 + 12
    elif t == 12:  # TE_EXPLOSION2: coord*3 + colorstart + colorlength
        size = 8
    else:
        raise ValueError(f"unhandled temp entity type {t}")
    r._need(size)
    r.i += size


def parse_demo_messages(fname):
    """Yield (view_angles, msg_type, payload_dict) tuples per message."""
    with open(fname, "rb") as f:
        data = f.read()
    # CD track line.
    nl = data.find(b"\n")
    if nl < 0:
        raise ValueError("not a demo file: missing CD-track line")
    pos = nl + 1

    while pos + 16 <= len(data):
        (length,) = struct.unpack_from("<i", data, pos)
        start = pos + 16
        if length < 0 or start + length > len(data):
            raise ValueError(
                f"bad demo block length {length} at offset {pos} "
                f"(file size {len(data)})")
        angles = struct.unpack_from("<3f", data, pos + 4)
        block = data[start:start + length]
        pos = start + length
        r = _Reader(block)
        while not r.eof():
            msg = r.u8()
            if msg & U_SIGNAL:
                upd = _read_fast_update(r, msg)
                yield angles, ServerMessageType.UPDATE, {
                    "entity_num": upd.entity_num, "origin": upd.origin}
                continue
            t = ServerMessageType
            if msg == t.NOP:
                pass
            elif msg == t.DISCONNECT:
                return
            elif msg == t.UPDATESTAT:
                r.u8(); r.s32()
            elif msg == t.VERSION:
                r.s32()
            elif msg == t.SETVIEW:
                yield angles, t.SETVIEW, {"viewentity": r.s16()}
            elif msg == t.SOUND:
                _skip_sound(r)
            elif msg == t.TIME:
                yield angles, t.TIME, {"time": r.f32()}
            elif msg in (t.PRINT, t.STUFFTEXT, t.CENTERPRINT, t.FINALE,
                         t.CUTSCENE):
                r.string()
            elif msg == t.SETANGLE:
                yield angles, t.SETANGLE, {
                    "angles": (r.angle(), r.angle(), r.angle())}
            elif msg == t.SERVERINFO:
                proto = r.s32()
                maxclients = r.u8()
                gametype = r.u8()
                levelname = r.string()
                models = []
                while True:
                    s = r.string()
                    if not s:
                        break
                    models.append(s)
                sounds = []
                while True:
                    s = r.string()
                    if not s:
                        break
                    sounds.append(s)
                yield angles, t.SERVERINFO, {
                    "protocol": proto, "maxclients": maxclients,
                    "gametype": gametype, "levelname": levelname,
                    "models": models, "sounds": sounds}
            elif msg == t.LIGHTSTYLE:
                r.u8(); r.string()
            elif msg == t.UPDATENAME:
                r.u8(); r.string()
            elif msg == t.UPDATEFRAGS:
                r.u8(); r.s16()
            elif msg == t.CLIENTDATA:
                _skip_clientdata(r)
            elif msg == t.STOPSOUND:
                r.s16()
            elif msg == t.UPDATECOLORS:
                r.u8(); r.u8()
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
            elif msg in (t.SPAWNSTATIC,):
                _read_baseline(r)
            elif msg == t.SPAWNBASELINE:
                ent = r.s16()
                origin = _read_baseline(r)
                yield angles, t.SPAWNBASELINE, {"entity_num": ent,
                                                "origin": origin}
            elif msg == t.TEMP_ENTITY:
                _skip_temp_entity(r)
            elif msg == t.SETPAUSE:
                r.u8()
            elif msg == t.SIGNONNUM:
                r.u8()
            elif msg in (t.KILLEDMONSTER, t.FOUNDSECRET, t.SELLSCREEN):
                pass
            elif msg == t.SPAWNSTATICSOUND:
                for _ in range(3):
                    r.coord()
                r.u8(); r.u8(); r.u8()
            elif msg == t.INTERMISSION:
                yield angles, t.INTERMISSION, {}
            elif msg == t.CDTRACK:
                r.u8(); r.u8()
            else:
                raise ValueError(f"unhandled server message {msg}")


def parse_demo(fname):
    """-> (times, origins, yaws, finish_time); mirrors the reference's
    view-entity tracking (analyse.py:34-68)."""
    view_entity = None
    origin = None
    origins, times, yaws = [], [], []
    time = None
    finish_time = None

    def patch(old, upd):
        # A view-entity update can legally precede its baseline in a
        # malformed/truncated stream; patch against a zero origin then,
        # matching the native parser (demparse.cpp have_origin default).
        if old is None:
            old = (0.0, 0.0, 0.0)
        return tuple(v if u is None else u for v, u in zip(old, upd))

    t = ServerMessageType
    for angles, msg_type, msg in parse_demo_messages(fname):
        if msg_type == t.SETVIEW:
            view_entity = msg["viewentity"]
        elif (msg_type == t.SPAWNBASELINE
              and msg["entity_num"] == view_entity):
            origin = msg["origin"]
        elif msg_type == t.UPDATE and msg["entity_num"] == view_entity:
            origin = patch(origin, msg["origin"])
        elif msg_type == t.TIME:
            time = msg["time"]
            origins.append(origin)
            times.append(time)
            yaws.append(angles[1])
        elif msg_type == t.INTERMISSION:
            finish_time = time

    return np.array(times), np.array(origins), np.array(yaws), finish_time


class _Writer:
    def __init__(self):
        self.b = io.BytesIO()

    def u8(self, v):
        self.b.write(struct.pack("<B", int(v) & 0xFF))

    def s16(self, v):
        self.b.write(struct.pack("<h", int(v)))

    def s32(self, v):
        self.b.write(struct.pack("<i", int(v)))

    def f32(self, v):
        self.b.write(struct.pack("<f", float(v)))

    def string(self, s):
        self.b.write(s.encode("latin-1") + b"\x00")

    def coord(self, v):
        # Protocol-15 coords are 13.3 fixed point: the representable world
        # is +/-4096 units (real Quake maps, incl. 100m, fit; unbounded sim
        # trajectories are clamped).
        self.s16(max(-32768, min(32767, int(round(v * 8.0)))))

    def angle(self, v):
        self.u8(int(round(v * 256.0 / 360.0)) & 0xFF)

    def getvalue(self):
        return self.b.getvalue()


class DemoWriter:
    """Streamed .dem writer."""

    def __init__(self, f, cd_track: int = -1):
        self._f = f
        self._f.write(f"{cd_track}\n".encode("ascii"))

    def write_block(self, view_angles, payload: bytes):
        self._f.write(struct.pack("<i", len(payload)))
        self._f.write(struct.pack("<3f", *view_angles))
        self._f.write(payload)


def write_demo(fname, times, origins, yaws, *, level_name="100m",
               view_entity=1, finish_time=None):
    """Serialize a trajectory into a .dem file.

    Args:
        times: (T,) seconds.
        origins: (T, 3) player origins.
        yaws: (T,) view yaw in degrees.
        finish_time: if given, an INTERMISSION message is emitted at the
            first frame whose time >= finish_time.
    """
    times = np.asarray(times)
    origins = np.asarray(origins)
    yaws = np.asarray(yaws)
    t = ServerMessageType

    with open(fname, "wb") as f:
        demo = DemoWriter(f)

        w = _Writer()
        w.u8(t.SERVERINFO)
        w.s32(PROTOCOL_VERSION)
        w.u8(1)   # maxclients
        w.u8(0)   # gametype
        w.string(level_name)
        w.string(f"maps/{level_name}.bsp")
        w.string("progs/player.mdl")
        w.string("")  # end of models
        w.string("")  # end of sounds
        w.u8(t.SETVIEW)
        w.s16(view_entity)
        w.u8(t.SPAWNBASELINE)
        w.s16(view_entity)
        w.u8(1)  # modelindex
        w.u8(0)  # frame
        w.u8(0)  # colormap
        w.u8(0)  # skin
        for i in range(3):
            w.coord(origins[0][i])
            w.angle(0)
        w.u8(t.SIGNONNUM)
        w.u8(3)
        demo.write_block((0.0, float(yaws[0]), 0.0), w.getvalue())

        intermission_done = False
        for k in range(len(times)):
            w = _Writer()
            w.u8(t.TIME)
            w.f32(times[k])
            bits = (U_SIGNAL | U_MOREBITS | U_ORIGIN1 | U_ORIGIN2 | U_ORIGIN3
                    | U_ANGLE2)
            w.u8(bits & 0xFF)
            w.u8((bits >> 8) & 0xFF)
            w.u8(view_entity)
            w.coord(origins[k][0])
            w.coord(origins[k][1])
            w.angle(yaws[k])
            w.coord(origins[k][2])
            if (finish_time is not None and not intermission_done
                    and times[k] >= finish_time):
                w.u8(t.INTERMISSION)
                intermission_done = True
            demo.write_block((0.0, float(yaws[k]), 0.0), w.getvalue())

        w = _Writer()
        w.u8(t.DISCONNECT)
        demo.write_block((0.0, float(yaws[-1]), 0.0), w.getvalue())
