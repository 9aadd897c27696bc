"""Sim(3) Lie group on torch tensors (port of ``mast3r_slam_tpu/lie/sim3.py``).

A transform is a flat 8-vector ``[tx ty tz, qx qy qz qw, s]``; tangents are
``[tau(3), phi(3), sigma]``.  Every function broadcasts over leading batch
dimensions.  ``exp`` keeps the scaling-and-squaring form of the JAX package:
the closed-form W-coefficient branches cancel catastrophically in float32.
"""

from __future__ import annotations

import math

import torch

DIM = 8

_EPS = 1e-6
_EXP_SQUARINGS = 7  # argument scaled by 2^-7 before the Taylor leg


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# quaternion helpers (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_mul(qa, qb):
    """Hamilton product qa * qb."""
    ax, ay, az, aw = qa.unbind(-1)
    bx, by, bz, bw = qb.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_inv(q):
    """Conjugate of a unit quaternion (built on the device: a host
    constant's copy would wait for the stream)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_act(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


# ---------------------------------------------------------------------------
# accessors
# ---------------------------------------------------------------------------

def t_of(T):
    return T[..., 0:3]


def q_of(T):
    return T[..., 3:7]


def s_of(T):
    return T[..., 7:8]


def make(t, q, s):
    t, q, s = _broadcast_lead(t, q, s)
    return torch.cat([t, q, s], dim=-1)


def _broadcast_lead(*xs):
    lead = torch.broadcast_shapes(*[x.shape[:-1] for x in xs])
    return [x.expand(lead + x.shape[-1:]) for x in xs]


def identity(batch_shape=(), dtype=torch.float32, device=None):
    # filled in on the device: a host tensor's copy would wait for the stream
    T = torch.zeros(tuple(batch_shape) + (DIM,), dtype=dtype, device=device)
    T[..., 6:] = 1
    return T


# ---------------------------------------------------------------------------
# group operations
# ---------------------------------------------------------------------------

def act(T, X):
    """s * R @ X + t."""
    return s_of(T) * quat_act(q_of(T), X) + t_of(T)


def mul(Ta, Tb):
    """(Ta * Tb)(x) = Ta(Tb(x))."""
    q = quat_mul(q_of(Ta), q_of(Tb))
    t = s_of(Ta) * quat_act(q_of(Ta), t_of(Tb)) + t_of(Ta)
    s = s_of(Ta) * s_of(Tb)
    return make(t, q, s)


def inv(T):
    qi = quat_inv(q_of(T))
    si = 1.0 / s_of(T)
    ti = -si * quat_act(qi, t_of(T))
    return make(ti, qi, si)


def rel(Ti, Tj):
    """T_ij = Ti^-1 * Tj."""
    si_inv = 1.0 / s_of(Ti)
    qi_inv = quat_inv(q_of(Ti))
    qij = quat_mul(qi_inv, q_of(Tj))
    tij = si_inv * quat_act(qi_inv, t_of(Tj) - t_of(Ti))
    sij = si_inv * s_of(Tj)
    return make(tij, qij, sij)


# ---------------------------------------------------------------------------
# exponential / logarithm
# ---------------------------------------------------------------------------

def exp_so3_quat(phi):
    """SO(3) exp to a quaternion, (..., 3) -> (..., 4)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    small = theta_sq < _EPS
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    theta_p4 = theta_sq * theta_sq
    imag = torch.where(
        small,
        0.5 - theta_sq / 48.0 + theta_p4 / 3840.0,
        torch.sin(0.5 * theta) / theta_safe,
    )
    real = torch.where(
        small,
        1.0 - theta_sq / 8.0 + theta_p4 / 384.0,
        torch.cos(0.5 * theta),
    )
    return torch.cat([imag * phi, real], dim=-1)


def exp(xi):
    """Sim(3) exp by scaling and squaring (see the JAX ``sim3.exp``)."""
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6:7]

    f = 1.0 / (1 << _EXP_SQUARINGS)
    ts = tau * f
    ps = phi * f
    ss = sigma * f
    th2 = torch.sum(ps * ps, dim=-1, keepdim=True)

    C = 1.0 + ss * (0.5 + ss * (1.0 / 6.0 + ss / 24.0))
    A = (
        0.5
        + ss * (1.0 / 3.0 + ss * (0.125 + ss / 30.0))
        - th2 * (1.0 / 24.0 + ss / 30.0)
    )
    B = (
        1.0 / 6.0
        + ss * (0.125 + ss * (1.0 / 20.0 + ss / 72.0))
        - th2 * (1.0 / 120.0 + ss / 144.0)
    )
    pxt = _cross(ps, ts)
    t = C * ts + A * pxt + B * _cross(ps, pxt)

    T = make(t, exp_so3_quat(ps), torch.exp(ss))
    for _ in range(_EXP_SQUARINGS):
        T = mul(T, T)
    return make(t_of(T), exp_so3_quat(phi), torch.exp(sigma))


def log(T):
    """Sim(3) log, the inverse of :func:`exp`."""
    q = q_of(T)
    s = s_of(T)
    t = t_of(T)

    qv = q[..., :3]
    qw = q[..., 3:4]
    nv = torch.sqrt(torch.sum(qv * qv, dim=-1, keepdim=True))
    small = nv < _EPS
    nv_safe = torch.where(small, torch.ones_like(nv), nv)
    angle = 2.0 * torch.atan2(nv, qw)
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    qw_safe = torch.where(qw == 0, torch.ones_like(qw), qw)
    k = torch.where(small, 2.0 / qw_safe, angle / nv_safe)
    phi = k * qv

    sigma = torch.log(s)

    # W built column-wise from the stable exponential: the translation of
    # exp([e_i; phi; sigma]) is W e_i
    cols = []
    for i in range(3):
        e = torch.zeros_like(phi)
        e[..., i] = 1.0
        cols.append(t_of(exp(torch.cat([e, phi, sigma], dim=-1))))
    W = torch.stack(cols, dim=-1)
    tau = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def retr(T, xi):
    """Left retraction exp(xi) * T."""
    return mul(exp(xi), T)


def normalize(T):
    q = q_of(T)
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return make(t_of(T), q, s_of(T))


def apply_adj_inv(T, x):
    """Row-vector adjoint-inverse application (see the JAX docstring)."""
    t = t_of(T)
    q = q_of(T)
    s_inv = 1.0 / s_of(T)
    a = x[..., 0:3]
    b = x[..., 3:6]
    c = x[..., 6:7]
    Ra = quat_act(q, a)
    Rb = quat_act(q, b)
    y0 = s_inv * Ra
    y1 = Rb + s_inv * _cross(t, Ra)
    y2 = c + s_inv * torch.sum(t * Ra, dim=-1, keepdim=True)
    return torch.cat(_broadcast_lead(y0, y1, y2), dim=-1)


def to_se3(T):
    """Drop the scale: [t, q]."""
    return T[..., 0:7]
