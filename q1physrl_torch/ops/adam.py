"""Adam's step: the CUDA kernel, its wrapper and its plain version.

One step of Adam on P members' parameters, each member with its own bias
corrections and learning rate, in place:

    m = m * b1 + g * (1 - b1)
    v = v * b2 + (g * g) * (1 - b2)
    p = p + ((m / bc1) / (sqrt(v / bc2) + eps)) * neg_lr

each operation float32 and rounded on its own, as the composed steps of
``algo/ppo.py:adam_update`` (a solo run: torch's ``_foreach`` operations
over its leaves) and ``algo/population.py:adam_step`` (a population: torch
operations on its stacked (P, D) tensors) compute it.  Composed, the step
is 14 launches (solo) or about 20 (stacked, with the copy of the
gradients into one buffer); here it is one, ``csrc/adam.cu``.

The leaves: ``grads`` is a sequence of gradients, and ``params``, ``mu``
and ``nu`` are each a sequence of tensors shaped as the gradients, or one
(P, D) tensor that holds member i's leaves in row i, in order.  With the
coefficients ``bc1``, ``bc2`` and ``neg_lr`` Python floats the step is one
member's and the leaves have no member axis; with them tensors of P values
on the leaves' device, the first axis of every leaf is the member axis.
The kernel reads a gradient through its strides (a stacked tower's weight
gradient is a transposed view); parameters and moments are contiguous
within a member.

The divisions by the bias corrections follow the composed steps: the
kernel divides by tensor coefficients, as torch divides by a tensor, and
multiplies by the float32 reciprocals of float ones, as torch's
``_foreach_div`` by a Python float computes the division on the card.  The
plain version divides by both, as the composed step does on the CPU.

On CUDA tensors :func:`adam` launches the kernel (``adam.launches`` counts
the kernel's launches: one for each 56 segments, a segment one leaf of one
member) or raises; on CPU tensors it runs the plain version,
:func:`adam_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .env_rollout import LEARNING_LIBRARIES, build_all

__all__ = ("AdamParams", "adam", "adam_plain", "leaf_table")

# The fields of a leaf in the kernel's table (csrc/adam.cu, LeafField).
_LEAF_FIELDS = 12
# The largest offset, in elements, that the kernel's int indexing takes.
_MAX_ELEMENTS = 1 << 30


class AdamParams(NamedTuple):
    """Adam's constants: the moments' decay rates and the denominator's
    epsilon."""

    b1: float
    b2: float
    eps: float


def _float(x) -> np.float32:
    """``x`` rounded to float32, as torch casts a Python scalar."""
    return np.float32(x)


def _reciprocal(x) -> np.float32:
    """1 / x in float32."""
    return np.float32(1) / np.float32(x)


def _members(bc1):
    """P for tensor coefficients, None (one member, no member axis) for
    floats."""
    return bc1.numel() if isinstance(bc1, torch.Tensor) else None


def _split(x, grads, members):
    """The leaves of ``x``: the sequence itself, or views of a (P, D)
    tensor shaped as the gradients."""
    if not isinstance(x, torch.Tensor):
        return list(x)
    sizes = [g[0].numel() for g in grads]
    return [part.view(g.shape) for part, g in
            zip(torch.split(x, sizes, dim=1), grads)]


def adam_plain(hyper: AdamParams, params, grads, mu, nu, bc1, bc2, neg_lr):
    """The plain version: the kernel's arithmetic in torch operations, in
    its order, each division a true one, in place (arguments as the
    module's docstring says)."""
    members = _members(bc1)
    params, mu, nu = (_split(x, grads, members) for x in (params, mu, nu))
    b1, b2, eps = hyper
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            def coeff(c):
                if isinstance(c, torch.Tensor):
                    return c.reshape((-1,) + (1,) * (p.dim() - 1))
                return torch.tensor([_float(c)], dtype=p.dtype,
                                    device=p.device)

            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_((g * g) * (1 - b2))
            denom = torch.sqrt(v / coeff(bc2)).add_(eps)
            p.add_(((m / coeff(bc1)) / denom).mul_(coeff(neg_lr)))


def _grad_view(shape, strides):
    """(cols, row_stride, col_stride) of a gradient whose dims merge into
    at most two, (rows, cols); None where they do not."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1]
    merged = []
    for n, s in dims:
        if merged and merged[-1][1] == s * n:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if not merged:
        return 1, 0, 0
    if len(merged) == 1:
        (n, s), = merged
        return n, 0, s
    if len(merged) == 2:
        (rows, rs), (cols, cs) = merged
        if (rows - 1) * rs + (cols - 1) * cs < _MAX_ELEMENTS:
            return cols, rs, cs
    return None


def _dense(x, start: int) -> bool:
    """Whether ``x`` is contiguous over its dims from ``start`` on."""
    expected = 1
    for n, s in zip(reversed(x.shape[start:]), reversed(x.stride()[start:])):
        if n != 1 and s != expected:
            return False
        expected *= n
    return True


def _table(params, grads, mu, nu, members):
    """The kernel's leaf table (ctypes int64, len(grads) x _LEAF_FIELDS) and
    the device, or None where the leaves are not what the kernel takes:
    float32 on one card, parameters and moments contiguous within a member,
    each gradient at most two merged dims within a member."""
    if not grads:
        return None
    f32, device = torch.float32, grads[0].get_device()
    start = 0 if members is None else 1
    rows = []
    for g in grads:
        if g.dtype is not f32 or g.get_device() != device:
            return None
        if start and (g.dim() == 0 or g.shape[0] != members):
            return None
        if g.is_contiguous():
            n = g.numel() // (members or 1)
            view = (n, 0, 1)
        else:
            n = math.prod(g.shape[start:])
            view = _grad_view(g.shape[start:], g.stride()[start:])
        if view is None or n >= _MAX_ELEMENTS:
            return None
        rows.append([0, g.data_ptr(), 0, 0, 0,
                     g.stride(0) if start else 0, 0, 0, n, *view])
    for column, x in ((0, params), (2, mu), (3, nu)):
        if isinstance(x, torch.Tensor):
            total = sum(r[8] for r in rows)
            if (members is None or x.dtype is not f32
                    or x.get_device() != device
                    or tuple(x.shape) != (members, total)
                    or not _dense(x, 1)):
                return None
            address, member = x.data_ptr(), x.stride(0)
            for r in rows:
                r[column], r[column + 4] = address, member
                address += 4 * r[8]
            continue
        if len(x) != len(grads):
            return None
        for r, t, g in zip(rows, x, grads):
            if (t.dtype is not f32 or t.get_device() != device
                    or t.shape != g.shape
                    or not (t.is_contiguous() or _dense(t, start))):
                return None
            r[column] = t.data_ptr()
            r[column + 4] = t.stride(0) if start else 0
    flat = [v for r in rows for v in r]
    return (ctypes.c_int64 * len(flat))(*flat), grads[0].device


def leaf_table(params, grads, mu, nu, bc1):
    """The kernel's table of these leaves, for :func:`adam`, or None where
    the kernel does not take them: float32 on a card, laid out as it reads
    them."""
    if not grads or not grads[0].is_cuda:
        return None
    return _table(params, grads, mu, nu, _members(bc1))


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_all(LEARNING_LIBRARIES)["adam"]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.q1_adam_step.argtypes = [ptr, i32, i32, ptr, ptr, ptr, ptr, ptr,
                                 ctypes.POINTER(i32)]
    lib.q1_adam_step.restype = i32
    lib.q1_adam_leaf_fields.argtypes = []
    lib.q1_adam_leaf_fields.restype = i32
    if lib.q1_adam_leaf_fields() != _LEAF_FIELDS:
        raise RuntimeError(f"the library's leaves have "
                           f"{lib.q1_adam_leaf_fields()} fields, the wrapper "
                           f"{_LEAF_FIELDS}")
    return lib


@functools.lru_cache(maxsize=8)
def _constants(hyper: AdamParams) -> tuple:
    return tuple(_float(x) for x in (hyper.b1, 1 - hyper.b1, hyper.b2,
                                     1 - hyper.b2, hyper.eps))


def _scalars(hyper: AdamParams, bc1: float, bc2: float, neg_lr: float):
    """The kernel's 8 floats: 1 / bc1, 1 / bc2, neg_lr (a solo step's;
    unread where the member tables give them), b1, 1 - b1, b2, 1 - b2, eps,
    each the float32 that torch's kernels apply."""
    return (ctypes.c_float * 8)(_reciprocal(bc1), _reciprocal(bc2),
                                _float(neg_lr), *_constants(hyper))


def _member_table(c, members, device):
    if (c.dtype is not torch.float32 or c.device != device
            or c.numel() != members or not c.is_contiguous()):
        raise ValueError(f"a coefficient must be a contiguous float32 tensor "
                         f"of {members} values on {device}, got {c.dtype} "
                         f"{tuple(c.shape)} on {c.device}")
    return c.data_ptr()


def adam(hyper: AdamParams, params, grads, mu, nu, bc1, bc2, neg_lr,
         table=None):
    """One Adam step in place (arguments as the module's docstring says;
    ``table``: :func:`leaf_table`'s of these leaves, where the caller has
    it).  CUDA leaves go through the kernel, and ``adam.launches`` counts
    its launches; CPU leaves through the plain version."""
    if grads and grads[0].device.type == "cpu":
        return adam_plain(hyper, params, grads, mu, nu, bc1, bc2, neg_lr)
    if not grads or grads[0].device.type != "cuda":
        raise ValueError("the Adam step runs on cuda or cpu leaves")
    members = _members(bc1)
    found = table or _table(params, grads, mu, nu, members)
    if found is None:
        raise ValueError("the leaves are not what the Adam kernel takes: "
                         "float32 on one card, parameters and moments "
                         "contiguous within a member, gradients of at most "
                         "two merged dims")
    table, device = found
    if members is None:
        tables = (None, None, None)
        scalars = _scalars(hyper, bc1, bc2, neg_lr)
    else:
        tables = tuple(_member_table(c, members, device)
                       for c in (bc1, bc2, neg_lr))
        scalars = _scalars(hyper, 1.0, 1.0, 0.0)
    launched = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library().q1_adam_step(
            table, len(grads), members or 1, *tables, scalars,
            torch.cuda.current_stream(device).cuda_stream,
            ctypes.byref(launched))
    adam.launches += launched.value
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")


adam.launches = 0
