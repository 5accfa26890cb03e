"""ctypes binding to the C++ oracles in the repo's ``native/`` directory:
the physics (``qphys.cpp``) and the demo parser (``demparse.cpp``).

Each library is compiled from its source with ``g++`` and the flags of
``native/Makefile`` at first use, into ``q1physrl_torch/_build/``, named by
a hash of the source and the flags, so an edited source rebuilds; the
``.so`` files in ``native/`` are never read or written.  A failed build
raises.  :func:`available` and :func:`dem_available` are false only where
there is no ``g++`` and no library built.

The physics oracle is the headless stand-in for the reference's
quakespasm ground-truth engine, an implementation independent of
``phys.py``; the demo parser is a second reading of the engine's wire
format, independent of ``utils/demfile.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ("available", "apply", "trajectory",
           "dem_available", "parse_demo", "build")

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_SOURCES = {"qphys": "qphys.cpp", "demparse": "demparse.cpp"}
# native/Makefile's CXXFLAGS.
_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_libs: dict = {}


def _library_path(name: str) -> Path:
    source = (_NATIVE_DIR / _SOURCES[name]).read_bytes()
    tag = hashlib.sha1(source + " ".join(_CXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"{name}-{tag[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` (``qphys`` or ``demparse``) unless it is
    built; return its path.  Raises if ``g++`` is missing or fails."""
    lib = _library_path(name)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the {name} oracle cannot be "
                           f"built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp),
                           str(_NATIVE_DIR / _SOURCES[name])],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on native/{_SOURCES[name]} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all of it
    return lib


def _can_build(name: str) -> bool:
    return _library_path(name).exists() or shutil.which("g++") is not None


def _load():
    if "qphys" in _libs:
        return _libs["qphys"]
    lib = ctypes.CDLL(str(build("qphys")))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.qphys_apply.argtypes = [
        ctypes.c_int, f32p, f32p, f32p, f32p, f32p, u8p, f32p,
        f64p, f32p, f32p, f32p, u8p, u8p]
    lib.qphys_apply.restype = None
    lib.qphys_trajectory.argtypes = [
        ctypes.c_int, f32p, f32p, f32p, f32p, f32p, u8p, f32p,
        ctypes.c_double, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_ubyte, ctypes.c_ubyte,
        f64p, f32p, f32p, f32p, u8p, u8p]
    lib.qphys_trajectory.restype = None
    _libs["qphys"] = lib
    return lib


def available() -> bool:
    """Whether the physics oracle is built or can be (``g++`` found)."""
    return _can_build("qphys")


def _numpy(x):
    """A tensor (on any device), array or number as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _get(o, k):
    return _numpy(o[k] if isinstance(o, dict) else getattr(o, k))


def _f32(x):
    return np.ascontiguousarray(x, np.float32)


def _u8(x):
    return np.ascontiguousarray(x).astype(np.uint8)


def apply(inputs, state):
    """Batch apply via the C++ oracle.  ``inputs``/``state`` follow the
    ``phys`` SoA field layout (dicts, or ``phys.Inputs``/``PlayerState``
    of tensors or arrays).  Returns a dict of updated state arrays."""
    lib = _load()
    yaw = _f32(_get(inputs, "yaw"))
    n = yaw.shape[0]
    dt = np.broadcast_to(_get(inputs, "time_delta").astype(np.float32),
                         (n,))
    # The C call updates state in place; always copy so the caller's
    # arrays are never mutated.
    z = np.array(_get(state, "z_pos"), np.float64, copy=True)
    vx = np.array(_get(state, "vel_x"), np.float32, copy=True)
    vy = np.array(_get(state, "vel_y"), np.float32, copy=True)
    vz = np.array(_get(state, "vel_z"), np.float32, copy=True)
    og = np.array(_get(state, "on_ground"), np.uint8, copy=True)
    jr = np.array(_get(state, "jump_released"), np.uint8, copy=True)
    lib.qphys_apply(
        n, yaw, _f32(_get(inputs, "pitch")), _f32(_get(inputs, "roll")),
        _f32(_get(inputs, "fmove")), _f32(_get(inputs, "smove")),
        _u8(_get(inputs, "button2")), np.ascontiguousarray(dt),
        z, vx, vy, vz, og, jr)
    return {"z_pos": z, "vel_x": vx, "vel_y": vy, "vel_z": vz,
            "on_ground": og.astype(bool), "jump_released": jr.astype(bool)}


def trajectory(inputs_seq, state0):
    """Roll a single player through T frames of inputs; returns dict of
    (T,) trajectory arrays (post-step state per frame)."""
    lib = _load()
    yaw = _f32(_get(inputs_seq, "yaw"))
    t = yaw.shape[0]
    dt = np.broadcast_to(_get(inputs_seq, "time_delta").astype(np.float32),
                         (t,))
    out = {
        "z_pos": np.empty(t, np.float64),
        "vel_x": np.empty(t, np.float32),
        "vel_y": np.empty(t, np.float32),
        "vel_z": np.empty(t, np.float32),
        "on_ground": np.empty(t, np.uint8),
        "jump_released": np.empty(t, np.uint8),
    }
    lib.qphys_trajectory(
        t, yaw, _f32(_get(inputs_seq, "pitch")),
        _f32(_get(inputs_seq, "roll")), _f32(_get(inputs_seq, "fmove")),
        _f32(_get(inputs_seq, "smove")), _u8(_get(inputs_seq, "button2")),
        np.ascontiguousarray(dt),
        float(_get(state0, "z_pos")), float(_get(state0, "vel_x")),
        float(_get(state0, "vel_y")), float(_get(state0, "vel_z")),
        int(_get(state0, "on_ground")), int(_get(state0, "jump_released")),
        out["z_pos"], out["vel_x"], out["vel_y"], out["vel_z"],
        out["on_ground"], out["jump_released"])
    out["on_ground"] = out["on_ground"].astype(bool)
    out["jump_released"] = out["jump_released"].astype(bool)
    return out


def _load_dem():
    if "demparse" in _libs:
        return _libs["demparse"]
    lib = ctypes.CDLL(str(build("demparse")))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.dem_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                              f64p, f32p, f32p,
                              ctypes.POINTER(ctypes.c_double)]
    lib.dem_parse.restype = ctypes.c_long
    _libs["demparse"] = lib
    return lib


def dem_available() -> bool:
    """Whether the demo parser is built or can be (``g++`` found)."""
    return _can_build("demparse")


def parse_demo(fname, max_records: int = 1 << 20):
    """Parse a .dem via the independent C++ protocol implementation
    (native/demparse.cpp) -> (times, origins, yaws, finish_time), matching
    the shape contract of utils.demfile.parse_demo.  Exists to
    cross-validate the Python protocol code against a second reading of
    the engine wire format (the reference's equivalent oracle is pyquake,
    reference analyse.py:34-68)."""
    lib = _load_dem()
    times = np.empty(max_records, np.float64)
    origins = np.empty((max_records, 3), np.float32)
    yaws = np.empty(max_records, np.float32)
    finish = ctypes.c_double(-1.0)
    n = lib.dem_parse(os.fsencode(fname), max_records, times,
                      origins.reshape(-1), yaws, ctypes.byref(finish))
    if n < 0:
        raise ValueError(f"dem_parse failed with code {n} on {fname}")
    finish_time = None if finish.value < 0 else finish.value
    return (times[:n].copy(), origins[:n].copy(), yaws[:n].copy(),
            finish_time)
