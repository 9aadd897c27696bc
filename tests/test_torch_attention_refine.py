"""Port parity of the two kernel modules' plain versions (CPU).

Attention: the port's ``sdpa_plain`` (what ``sdpa`` runs on a CPU tensor)
against the JAX package's ``sdpa_xla``.  ``sdpa_fused`` (the Pallas kernel)
has no interpret switch and cannot run on the CPU; ``sdpa_xla`` is its
stated same-numerics reference.  Tolerance: f32 inputs agree to 1e-5
(float32 reassociation of 64-term dot products); bf16 inputs to one bf16
ulp at unit scale (2**-7 = 7.8e-3 relative), since the two sides may round
the PV product's output differently.

Refine: exact integer equality against ``refine_matches`` (radius 3,
dilation 5 and radius 1) and against ``refine_r1_pallas`` in interpret
mode, including border pixels and ties.  The CUDA wrappers must refuse
CPU tensors rather than fall back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops.attention import sdpa_xla
from mast3r_slam_tpu.ops.matching import pixel_to_lin, refine_matches
from mast3r_slam_tpu.ops.refine_pallas import refine_r1_pallas
from mast3r_slam_tpu_torch.ops import matching as tmatching
from mast3r_slam_tpu_torch.ops.attention import sdpa, sdpa_cuda
from mast3r_slam_tpu_torch.ops.refine import quantize, refine_window, refine_window_cuda

from test_torch_common import assert_close, f32, n, t


@pytest.mark.parametrize("shape", [(1, 2, 12, 32, 12), (2, 4, 40, 64, 24)])
def test_sdpa_plain_matches_sdpa_xla_f32(shape):
    B, H, N, D, M = shape
    rng = np.random.default_rng(N)
    q, k, v = f32(rng, B, H, N, D), f32(rng, B, H, M, D), f32(rng, B, H, M, D)
    want = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = sdpa(t(q), t(k), t(v))
    assert_close(got, want, 1e-5, 1e-5)


def test_sdpa_plain_matches_sdpa_xla_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (f32(rng, 1, 3, 96, 64) for _ in range(3))
    want = sdpa_xla(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)))
    got = sdpa(*(t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert_close(got, np.asarray(want.astype(jnp.float32)), 2 ** -7, 2 ** -7)


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        sdpa_cuda(q, q, q)
    d = torch.zeros(1, 16, 24, dtype=torch.int8)
    idx = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        refine_window_cuda(d, d, idx, 4, 4, 1, 1)


def _case(rng, B, H, W, F, structured=True, shift=1):
    """Descriptor image + targets taken near a shifted location (the JAX
    package's refine test recipe)."""
    D11 = rng.normal(size=(B, H, W, F)).astype(np.float32)
    if structured:
        D11 = D11 + np.roll(D11, 1, axis=2) * 0.7 + np.roll(D11, 1, axis=1) * 0.5
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    N = H * W
    sh = rng.integers(-shift, shift + 1, size=(B, N, 2))
    u = np.clip(np.arange(N) % W + sh[..., 0], 0, W - 1)
    v = np.clip(np.arange(N) // W + sh[..., 1], 0, H - 1)
    D21 = np.stack([D11[b].reshape(N, F)[v[b] * W + u[b]] for b in range(B)])
    D21 = (D21 + rng.normal(size=D21.shape) * 0.05).astype(np.float32)
    p = np.stack([np.arange(N) % W, np.arange(N) // W], -1)
    p = np.broadcast_to(p, (B, N, 2)).astype(np.int32).copy()
    return D11, D21, p


@pytest.mark.parametrize("radius,dil", [(3, 5), (1, 1), (2, 3)])
def test_refine_matches_exact(radius, dil):
    rng = np.random.default_rng(radius * 10 + dil)
    D11, D21, p = _case(rng, 2, 24, 32, 24, shift=6)
    # start some matches on the image border so out-of-image masking matters
    p[0, :32] = np.stack([np.arange(32), np.zeros(32)], -1)
    p[1, :24] = np.stack([np.full(24, 31), np.arange(24)], -1)
    want = refine_matches(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p),
                          radius=radius, dilation_max=dil)
    got = tmatching.refine_matches(t(D11), t(D21), t(p), radius=radius,
                                   dilation_max=dil)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_refine_ties_take_first_candidate():
    # a constant descriptor image: every in-image candidate ties, so the
    # first in-image candidate of the dy-major order wins at each level
    B, H, W, F = 1, 9, 11, 8
    D11 = np.ones((B, H, W, F), np.float32) / np.sqrt(F)
    D21 = np.ones((B, H * W, F), np.float32) / np.sqrt(F)
    p = np.stack([np.arange(H * W) % W, np.arange(H * W) // W], -1)[None].astype(np.int32)
    for radius, dil in ((1, 1), (3, 2)):
        want = refine_matches(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p),
                              radius=radius, dilation_max=dil)
        got = tmatching.refine_matches(t(D11), t(D21), t(p), radius=radius,
                                       dilation_max=dil)
        np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("border", [False, True])
def test_refine_r1_matches_pallas_interpret(border):
    rng = np.random.default_rng(3 + border)
    B, H, W, F = 2, 8, 16, 24  # N = 128, lane-aligned for the Pallas kernel
    D11, D21, p = _case(rng, B, H, W, F)
    idx = p[..., 0] + W * p[..., 1]
    if border:
        idx[0, :64] = np.arange(64)  # top rows
    d11q = quantize(t(D11)).reshape(B, H * W, F)
    d21q = quantize(t(D21))
    want = refine_r1_pallas(jnp.asarray(n(d11q)), jnp.asarray(n(d21q)),
                            jnp.asarray(idx, jnp.int32), H, W, tile_n=128,
                            interpret=True)
    got = refine_window(d11q, d21q, t(idx.astype(np.int32)), H, W, 1, 1)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_quantize_rounds_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -200.0], np.float32) / 127.0
    got = n(quantize(t(x)))
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * 127.0), -127, 127)
                      .astype(jnp.int8))
    np.testing.assert_array_equal(got, want)
    lin = pixel_to_lin(jnp.asarray([[3, 2]]), 10)
    assert int(np.asarray(lin)[0]) == int(n(tmatching.pixel_to_lin(t(np.array([[3, 2]])), 10))[0])
