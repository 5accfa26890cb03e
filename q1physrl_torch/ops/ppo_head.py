"""The PPO loss head and its gradient: the CUDA kernels, their wrapper and
their plain version.

The head is what RLLib 0.8.4's PPOLoss computes per row from the towers'
outputs (``algo/ppo.py:loss_terms``): the joint action distribution's
log-probability, KL against the behaviour distribution and entropy, the
clipped surrogate, the clipped value loss, and the row's total

    row_total = ((-surrogate + kl_coeff * kl) + vf_loss_coeff * vf_loss)
                - entropy_coeff * entropy.

Composed of torch operations, the head and autograd's backward through it
are about 390 kernels an update; here they are two, in
``csrc/ppo_head.cu``:

- the forward kernel writes, per row, the row's total, its policy loss
  (the negated surrogate), KL, value loss and entropy (detached, for the
  loss statistics), and the
  gradient of the row's total with respect to the row's logits and value
  (its *unit gradient*: the upstream gradient taken as 1);
- the backward kernel multiplies each row's unit gradient by the upstream
  gradient of the row's total.

The means over the rows stay torch reductions.  Their backward hands each
row ``scale / rows``, a power of two where rows and the data-parallel
share are, and a product by a power of two is exact: so the saved unit
gradient times it equals autograd's chain, in which that factor enters at
the top, to the bit.  ``algo.ppo`` takes this head only then.

The kernel runs no new arithmetic: it follows torch's own kernels on the
card operation by operation (see the notes in the source), so that the
forward terms equal the composed head's to the bit, and the unit gradient
follows autograd's backward formulas in the order in which autograd's
engine adds a tensor's gradients (the node made last runs first).

It covers the action space of the shipped configs: K keys as
Categorical(2) and the continuous squashed-Gaussian yaw
(``allow_yaw``, ``discrete_yaw_steps == -1``), logits (..., 2K + 2).
Rows are P members' of B rows each, member-major, with per-member
coefficients: a solo run is P = 1.

On CUDA tensors :func:`ppo_head` launches the kernels (``launches`` counts
the forward's) or raises; on CPU tensors it runs the plain version,
:func:`ppo_head_plain`, the same arithmetic in torch operations.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..models.distributions import (MAX_ABS_MEAN, MAX_LOG_NN_OUTPUT,
                                    MIN_LOG_NN_OUTPUT, SQUASH_SCALE)
from .env_rollout import LEARNING_LIBRARIES, build_all

__all__ = ("HeadParams", "ppo_head", "ppo_head_plain", "head_backward_plain")

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class HeadParams(NamedTuple):
    """What the head reads of the env and PPO configs."""

    num_keys: int
    action_range: float
    clip_param: float
    vf_clip_param: float
    vf_loss_coeff: float


def _float(x, dtype) -> float:
    """``x`` rounded to ``dtype``, as torch casts a Python scalar."""
    return torch.tensor(x, dtype=torch.float64).to(dtype).item()


def _reciprocal(x, dtype) -> float:
    """1 / x in ``dtype``: a division by a Python scalar on the card is a
    product by the scalar's reciprocal, computed in the tensor's type."""
    one = torch.ones((), dtype=dtype)
    return (one / torch.tensor(x, dtype=torch.float64).to(dtype)).item()


def _fma(a, b, c):
    """a * b + c rounded once, as a contracted multiply-add: in float64,
    whose product of two float32 values is exact (float64 itself rounds
    twice)."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def _log_softmax2(x0, x1):
    """log_softmax of two values, as torch's warp kernel computes it on the
    card: each lane's max of its value and its neighbour's, the sum of the
    two exps, its log, then (x - max) - log."""
    m0 = torch.where(x0 < x1, x1, x0)
    m1 = torch.where(x1 < x0, x0, x1)
    lse = torch.log(torch.exp(x0 - m0) + torch.exp(x1 - m1))
    return (x0 - m0) - lse, (x1 - m1) - lse


def _log_softmax2_backward(o0, o1, g0, g1):
    """Its backward: g - exp(o) * (g0 + g1), the product contracted."""
    s = g0 + g1
    return _fma(-torch.exp(o0), s, g0), _fma(-torch.exp(o1), s, g1)


def _where(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def _in(x, lo, hi):
    return (x >= lo) & (x <= hi)


def ppo_head_plain(params: HeadParams, logits, value, behaviour_logits,
                   key_actions, yaw_actions, behaviour_logp, advantage,
                   old_value, value_target, kl_coeff, entropy_coeff):
    """The plain version: the forward kernel's arithmetic in torch
    operations, in its order.

    Args: ``logits`` and ``behaviour_logits`` (..., 2K + 2); ``key_actions``
    (..., K) integers; ``value`` and the other row inputs (...), the rows
    P members' of B each, member-major; ``kl_coeff``: (P,) tensor;
    ``entropy_coeff``: a float or a (P,) tensor.

    Returns (row_total, policy_loss, action_kl, vf_loss, entropy, grad),
    policy_loss the negated surrogate, each
    shaped like ``value`` but ``grad``, (..., 2K + 3): the unit gradient of
    row_total with respect to the logits, then the value.  On the card each
    torch operation rounds as the kernel's does, and the contracted
    multiply-adds of the log-softmax backward are taken in float64: equal
    to the kernel's but where float64 rounds onto a float32 tie.
    """
    dtype = value.dtype
    k = params.num_keys
    rows = value.shape
    per_member = lambda c: c.to(dtype).repeat_interleave(
        value.numel() // c.numel()).reshape(rows)
    kc = per_member(kl_coeff)
    ec = (per_member(entropy_coeff)
          if isinstance(entropy_coeff, torch.Tensor)
          else torch.full(rows, _float(entropy_coeff, dtype), dtype=dtype,
                          device=value.device))
    col = lambda x, j: x[..., j]
    zero = torch.zeros_like(value)

    # The keys: Categorical(2) each, log_softmax made once per use.
    logp = ent = kl = None
    key_out = []
    for i in range(k):
        x0, x1 = col(logits, 2 * i), col(logits, 2 * i + 1)
        o0, o1 = _log_softmax2(x0, x1)
        b0, b1 = _log_softmax2(col(behaviour_logits, 2 * i),
                               col(behaviour_logits, 2 * i + 1))
        first = col(key_actions, i) == 0
        e0, e1 = torch.exp(o0), torch.exp(o1)
        h = -(e0 * o0 + e1 * o1)
        eb0, eb1 = torch.exp(b0), torch.exp(b1)
        d = eb0 * (b0 - o0) + eb1 * (b1 - o1)
        lp = torch.where(first, o0, o1)
        logp = lp + 0.0 if logp is None else logp + lp
        ent = h + 0.0 if ent is None else ent + h
        kl = d + 0.0 if kl is None else kl + d
        key_out.append((o0, o1, e0, e1, eb0, eb1, first))

    # The yaw: the squashed Gaussian, its clamps taken once per access.
    mean_raw, log_std_raw = col(logits, 2 * k), col(logits, 2 * k + 1)
    mean = torch.clamp(mean_raw, -MAX_ABS_MEAN, MAX_ABS_MEAN)
    log_std = torch.clamp(log_std_raw, MIN_LOG_NN_OUTPUT, MAX_LOG_NN_OUTPUT)
    std = torch.exp(log_std)
    b_mean = torch.clamp(col(behaviour_logits, 2 * k), -MAX_ABS_MEAN,
                         MAX_ABS_MEAN)
    b_log_std = torch.clamp(col(behaviour_logits, 2 * k + 1),
                            MIN_LOG_NN_OUTPUT, MAX_LOG_NN_OUTPUT)
    b_std = torch.exp(b_log_std)
    low, span = -params.action_range, 2.0 * params.action_range
    u = SQUASH_SCALE * torch.special.ndtri(
        (yaw_actions - low) * _reciprocal(span, dtype))
    num = u - mean
    dev = num / std
    y_logp = (-torch.log(std) - _HALF_LOG_2PI) - 0.5 * (dev * dev)
    scale = torch.full_like(u, SQUASH_SCALE)
    dev0 = (u - 0.0) / scale
    squash_grad = (((-torch.log(scale) - _HALF_LOG_2PI) - 0.5 * (dev0 * dev0))
                   + math.log(span))
    logp = logp + (y_logp - squash_grad)
    dm = b_mean - mean
    kl_num = b_std * b_std + dm * dm
    kl_den = 2.0 * (std * std)
    kl_frac = kl_num / kl_den
    kl = kl + (((log_std - b_log_std) + kl_frac) - 0.5)
    inv_ent = _reciprocal(2.0 * SQUASH_SCALE ** 2, dtype)
    ent_x = (std * std + mean * mean) * inv_ent
    ent = ent + (math.log(span)
                 - (((math.log(SQUASH_SCALE) - log_std) + ent_x) - 0.5))

    # The clipped surrogate, the clipped value loss, the row's total.
    ratio = torch.exp(logp - behaviour_logp)
    lo, hi = 1.0 - params.clip_param, 1.0 + params.clip_param
    p1 = advantage * ratio
    p2 = advantage * torch.clamp(ratio, lo, hi)
    surrogate = torch.minimum(p1, p2)
    vclip = params.vf_clip_param
    d1 = value - value_target
    l1 = d1 * d1
    dv = value - old_value
    d2 = (old_value + torch.clamp(dv, -vclip, vclip)) - value_target
    l2 = d2 * d2
    vf_loss = torch.maximum(l1, l2)
    row_total = (((-surrogate + kc * kl) + params.vf_loss_coeff * vf_loss)
                 - ec * ent)

    # The unit gradient, each chain as autograd's backward formulas run it.
    g_kl = kc
    g_vf = zero + _float(params.vf_loss_coeff, dtype)
    g_ent = -ec
    g_s = zero - 1.0
    tie = p1 == p2
    g_half = torch.where(tie, g_s * 0.5, g_s)
    g1 = torch.where(p1 > p2, zero, g_half)
    g2 = torch.where(p1 < p2, zero, g_half)
    d_ratio = g1 * advantage + _where(_in(ratio, lo, hi), g2 * advantage)
    d_logp = d_ratio * ratio

    grads = []
    for o0, o1, e0, e1, eb0, eb1, first in key_out:
        # entropy: -sum(exp(o) * o); kl: sum(exp(b) * (b - o)); logp: o[a]
        dt = -g_ent
        ge0 = dt * e0 + (dt * o0) * e0
        ge1 = dt * e1 + (dt * o1) * e1
        ce0, ce1 = _log_softmax2_backward(o0, o1, ge0, ge1)
        ck0, ck1 = _log_softmax2_backward(o0, o1, -(g_kl * eb0),
                                          -(g_kl * eb1))
        gp0, gp1 = _where(first, d_logp), _where(~first, d_logp)
        cp0, cp1 = _log_softmax2_backward(o0, o1, gp0, gp1)
        grads += [(ce0 + ck0) + cp0, (ce1 + ck1) + cp1]

    mean_in = _in(mean_raw, -MAX_ABS_MEAN, MAX_ABS_MEAN)
    log_std_in = _in(log_std_raw, MIN_LOG_NN_OUTPUT, MAX_LOG_NN_OUTPUT)
    # entropy: the clamp of log_std (L5), then of std's (L4) and mean's (M3)
    d_inner = -g_ent
    c_l5 = -d_inner
    d_y = d_inner * inv_ent
    c_m3 = d_y * (2.0 * mean)
    c_l4 = (d_y * (2.0 * std)) * std
    # kl: other.log_std (L3), o_std (L2), o_mean (M2)
    c_l3 = g_kl
    d_num = g_kl / kl_den
    d_den = -g_kl * (kl_frac / kl_den)
    c_m2 = -(d_num * (2.0 * dm))
    c_l2 = ((d_den * 2.0) * (2.0 * std)) * std
    # logp: self.mean (M1), self.std (L1)
    d_dev = (-d_logp * 0.5) * (2.0 * dev)
    c_m1 = -(d_dev / std)
    d_std = (-d_dev) * (dev / std) + (-d_logp) / std
    c_l1 = d_std * std
    grads.append((_where(mean_in, c_m3) + _where(mean_in, c_m2))
                 + _where(mean_in, c_m1))
    grads.append(((((_where(log_std_in, c_l5) + _where(log_std_in, c_l4))
                    + _where(log_std_in, c_l3)) + _where(log_std_in, c_l2))
                  + _where(log_std_in, c_l1)))

    # value: max(l1, l2), half the gradient each on a tie
    v_half = torch.where(l1 == l2, g_vf * 0.5, g_vf)
    gl1 = torch.where(l1 < l2, zero, v_half)
    gl2 = torch.where(l1 > l2, zero, v_half)
    grads.append(gl1 * (2.0 * d1)
                 + _where(_in(dv, -vclip, vclip), gl2 * (2.0 * d2)))
    return (row_total, -surrogate, kl, vf_loss, ent,
            torch.stack(grads, -1))


def head_backward_plain(grad_row, grad):
    """The plain version of the backward kernel: each row's unit gradient
    times the upstream gradient of its total; (d logits, d value)."""
    out = grad_row.unsqueeze(-1) * grad
    return out[..., :-1], out[..., -1]


# --- the kernels ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_all(LEARNING_LIBRARIES)["ppo_head"]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.q1_ppo_head_forward.argtypes = [ptr] * 17 + [i32] * 3 + [ptr, ptr]
    lib.q1_ppo_head_backward.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    for fn in (lib.q1_ppo_head_forward, lib.q1_ppo_head_backward):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=64)
def _head_params(params: HeadParams, entropy_coeff: float):
    """The 17 floats of the kernel's ``HeadParams``, in its order: each the
    float32 that torch's own kernel applies in the composed head.  Kept per
    (params, entropy_coeff): a run has a few of them, and an update's host
    time is what the fused head saves."""
    f32 = lambda x: _float(x, torch.float32)
    span = 2.0 * params.action_range
    values = (f32(1.0 - params.clip_param), f32(1.0 + params.clip_param),
              f32(-params.vf_clip_param), f32(params.vf_clip_param),
              f32(params.vf_loss_coeff), f32(_HALF_LOG_2PI),
              f32(SQUASH_SCALE), f32(math.log(span)),
              f32(math.log(SQUASH_SCALE)),
              _reciprocal(2.0 * SQUASH_SCALE ** 2, torch.float32),
              -MAX_ABS_MEAN, MAX_ABS_MEAN, MIN_LOG_NN_OUTPUT,
              MAX_LOG_NN_OUTPUT, f32(-params.action_range),
              _reciprocal(span, torch.float32), f32(entropy_coeff))
    return (ctypes.c_float * len(values))(*values)


def _raise_on(err):
    if err != 0:
        raise RuntimeError(f"ppo head kernel launch failed: CUDA error {err}")


def _check(params: HeadParams, tensors: dict, value, kl_coeff,
           entropy_coeff):
    """Raise unless the inputs are what the kernels take: float32 rows (and
    int32 key actions) on one card, contiguous, P members' of equal
    counts."""
    rows = tuple(value.shape)
    n = value.numel()
    members = kl_coeff.numel()
    if n == 0 or n % members:
        raise ValueError(f"{n} rows do not split into {members} members")
    width = 2 * params.num_keys + 2
    shapes = {"logits": rows + (width,), "behaviour_logits": rows + (width,),
              "key_actions": rows + (params.num_keys,)}
    device = value.device
    extra = {"kl_coeff": kl_coeff}
    if isinstance(entropy_coeff, torch.Tensor):
        extra["entropy_coeff"] = entropy_coeff
    for name, x in {**tensors, **extra}.items():
        want = ((members,) if name in extra else shapes.get(name, rows))
        dtype = torch.int32 if name == "key_actions" else torch.float32
        if x.dtype != dtype or tuple(x.shape) != want:
            raise ValueError(f"{name}: expected {dtype} {want}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, members


class _Head(torch.autograd.Function):
    """The head's terms, with row_total differentiable with respect to the
    logits and the value through the saved unit gradient."""

    @staticmethod
    def forward(ctx, logits, value, params, inputs, kl_coeff,
                entropy_coeff):
        if value.device.type == "cpu":
            *terms, grad = ppo_head_plain(params, logits, value, *inputs,
                                          kl_coeff, entropy_coeff)
        else:
            terms, grad = _forward(params, logits, value, inputs, kl_coeff,
                                   entropy_coeff)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(*terms[1:])
        return tuple(terms)

    @staticmethod
    def backward(ctx, grad_row, *_):
        (grad,) = ctx.saved_tensors
        grad_row = grad_row.contiguous()
        if grad.device.type == "cpu":
            d_logits, d_value = head_backward_plain(grad_row, grad)
        else:
            d_logits, d_value = _backward(grad_row, grad)
        return d_logits, d_value, None, None, None, None


def _forward(params, logits, value, inputs, kl_coeff, entropy_coeff):
    names = ("behaviour_logits", "key_actions", "yaw_actions",
             "behaviour_logp", "advantage", "old_value", "value_target")
    tensors = {"logits": logits, "value": value, **dict(zip(names, inputs))}
    n, members = _check(params, tensors, value, kl_coeff, entropy_coeff)
    if value.device.type != "cuda":
        raise ValueError(f"the ppo head runs on cuda or cpu, not "
                         f"{value.device}")
    terms = [torch.empty_like(value) for _ in range(5)]
    grad = torch.empty(tuple(value.shape) + (2 * params.num_keys + 3,),
                       dtype=torch.float32, device=value.device)
    table = entropy_coeff if isinstance(entropy_coeff, torch.Tensor) else None
    scalar = 0.0 if table is not None else entropy_coeff
    with torch.cuda.device(value.device):
        err = _library().q1_ppo_head_forward(
            logits.data_ptr(), value.data_ptr(),
            *(x.data_ptr() for x in inputs), kl_coeff.data_ptr(),
            None if table is None else table.data_ptr(),
            *(x.data_ptr() for x in terms), grad.data_ptr(),
            n, n // members, params.num_keys,
            _head_params(params, scalar),
            torch.cuda.current_stream(value.device).cuda_stream)
    _raise_on(err)
    ppo_head.launches += 1
    return terms, grad


def _backward(grad_row, grad):
    n, width = grad.numel() // grad.shape[-1], grad.shape[-1]
    if grad_row.dtype != torch.float32 or grad_row.numel() != n:
        raise ValueError(f"the upstream gradient must be float32 with {n} "
                         f"rows, got {grad_row.dtype} {tuple(grad_row.shape)}")
    d_logits = torch.empty(tuple(grad.shape[:-1]) + (width - 1,),
                           dtype=torch.float32, device=grad.device)
    d_value = torch.empty(grad.shape[:-1], dtype=torch.float32,
                          device=grad.device)
    with torch.cuda.device(grad.device):
        err = _library().q1_ppo_head_backward(
            grad_row.data_ptr(), grad.data_ptr(), d_logits.data_ptr(),
            d_value.data_ptr(), n, width,
            torch.cuda.current_stream(grad.device).cuda_stream)
    _raise_on(err)
    return d_logits, d_value


def ppo_head(params: HeadParams, logits, value, behaviour_logits,
             key_actions, yaw_actions, behaviour_logp, advantage, old_value,
             value_target, kl_coeff, entropy_coeff):
    """The PPO head's per-row terms (arguments as :func:`ppo_head_plain`'s):
    (row_total, policy_loss, action_kl, vf_loss, entropy), each shaped like
    ``value``; row_total carries the gradient to ``logits`` and ``value``,
    the others are detached.

    CUDA tensors go through the kernels (float32, contiguous; int32 key
    actions), and ``ppo_head.launches`` counts the forward's launches; CPU
    tensors go through the plain version.
    """
    inputs = (behaviour_logits, key_actions, yaw_actions, behaviour_logp,
              advantage, old_value, value_target)
    return _Head.apply(logits, value, params, inputs, kl_coeff,
                       entropy_coeff)


ppo_head.launches = 0
