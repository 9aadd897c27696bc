"""Port parity of dense matching: ``match`` indices equal the JAX package's.

Scenes: a shift scene after the verify recipe (view 2 sees view 1's
surface shifted sideways) and oracle pointmap pairs along an arc
(tests/oracle.py).  The LM solutions are f32 on both sides with the same
formulas, but the two sides round differently in the last bit (XLA
rewrites x / sqrt(s); even jitted and eager JAX differ there), and the LM
amplifies that to ~1e-3 px.  A solution that lands within that distance of
a pixel edge can floor to the other pixel, so the indices may differ in at
most 0.1% of pixels.  The shift is whole pixels plus one half in u and in v: with a
whole-pixel roll every true solution sits exactly ON a pixel edge, where
the floor is decided by rounding noise (12% of pixels flip), which would
test the noise and not the port.  The descriptor argmax, on identical
quantised descriptors, is exact once the start pixels agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mast3r_slam_tpu.geometry import backproject, get_pixel_coords
from mast3r_slam_tpu.ops import matching as jm
from mast3r_slam_tpu_torch.ops import matching as tm

from oracle import OracleModel, PlaneScene, arc_trajectory
from test_torch_common import assert_close, n, t

HW = (48, 64)
MAX_MISMATCH = 1e-3  # fraction of pixels


def _shift_scene(shift, seed=0):
    H, W = HW
    rng = np.random.default_rng(seed)
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    uv = np.asarray(get_pixel_coords(HW)).reshape(-1, 2)

    def surface(uv):
        z = 2.0 + 0.4 * np.sin(uv[:, 0:1] / 9.0) + 0.3 * np.cos(uv[:, 1:2] / 7.0)
        X = backproject(jnp.asarray(uv), jnp.asarray(z), jnp.asarray(K))
        return np.asarray(X, np.float32).reshape(1, H, W, 3)

    X11 = surface(uv)
    # pixel (u, v) of view 2 sees view 1's surface at (u + shift + 1/2, v + 1/2)
    X21 = surface(uv + np.array([shift + 0.5, 0.5]))
    D11 = rng.normal(size=(1, H, W, 24)).astype(np.float32)
    D11 = D11 + np.roll(D11, 1, axis=2) * 0.6
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    D21 = np.roll(D11, -shift, axis=2)
    return X11, X21, D11, D21


def _oracle_pair(i, j):
    scene = PlaneScene(HW)
    oracle = OracleModel(scene, arc_trajectory(8, radius=0.5, max_angle=0.6))
    (Xii, _, Dii, _), (Xji, _, Dji, _) = oracle._pair(i, j)
    return tuple(np.asarray(a, np.float32) for a in (Xii, Xji, Dii, Dji))


def _compare(X11, X21, D11, D21, idx_init=None):
    kw = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-6,
              dist_thresh=0.1, radius=3, dilation_max=5)
    ji = None if idx_init is None else jnp.asarray(idx_init)
    ti = None if idx_init is None else t(idx_init)
    jidx, jvalid = jm.match(*(jnp.asarray(a) for a in (X11, X21, D11, D21)), ji, **kw)
    tidx, tvalid = tm.match(*(t(a) for a in (X11, X21, D11, D21)), ti, **kw)
    jidx, tidx = np.asarray(jidx), n(tidx)
    mismatch = float(np.mean(jidx != tidx))
    assert mismatch <= MAX_MISMATCH, f"{mismatch:.4%} of indices differ"
    vmis = float(np.mean(np.asarray(jvalid) != n(tvalid)))
    assert vmis <= MAX_MISMATCH, f"{vmis:.4%} of validity flags differ"
    return tidx, n(tvalid)


@pytest.mark.parametrize("shift", [2, 5])
def test_match_shift_scene(shift):
    X11, X21, D11, D21 = _shift_scene(shift)
    idx, valid = _compare(X11, X21, D11, D21)
    H, W = HW
    u = np.arange(H * W) % W
    v = np.arange(H * W) // W
    inner = (u > 3) & (u < W - shift - 4) & (v > 3) & (v < H - 4)
    # the port recovers the true shift on the interior
    assert np.mean(idx[0][inner] == (u + shift + W * v)[inner]) > 0.95


@pytest.mark.parametrize("pair", [(1, 0), (3, 2), (5, 3)])
def test_match_oracle_pointmaps(pair):
    X11, X21, D11, D21 = _oracle_pair(*pair)
    _compare(X11, X21, D11, D21)


def test_match_warm_start():
    X11, X21, D11, D21 = _oracle_pair(4, 3)
    rng = np.random.default_rng(9)
    N = HW[0] * HW[1]
    init = np.clip(np.arange(N) + rng.integers(-2, 3, size=N), 0, N - 1)
    _compare(X11, X21, D11, D21, init[None].astype(np.int32))


def test_iter_proj_parity():
    X11, X21, _, _ = _oracle_pair(2, 1)
    jr, jp, jinit = jm.prep_for_iter_proj(jnp.asarray(X11), jnp.asarray(X21), None)
    tr, tp, tinit = tm.prep_for_iter_proj(t(X11), t(X21), None)
    assert_close(tr, jr, 1e-5, 1e-6, "ray image")
    assert_close(tp, jp, 1e-5, 1e-6, "targets")
    jp1, jconv, jx = jm.iter_proj(jr, jp, jinit, extra_img=jnp.asarray(X11))
    tp1, tconv, tx = tm.iter_proj(tr, tp, tinit, extra_img=t(X11))
    # sub-pixel LM solutions: last-bit noise grows to ~1e-3 px (see above)
    dp = np.abs(n(tp1) - np.asarray(jp1)).max(-1)
    assert np.quantile(dp, 0.99) < 1e-3
    floor_mis = np.mean(np.any(np.floor(n(tp1)) != np.floor(np.asarray(jp1)), -1))
    assert floor_mis <= MAX_MISMATCH
    assert np.mean(n(tconv) != np.asarray(jconv)) <= MAX_MISMATCH
    assert_close(tx, jx, 1e-4, 1e-4, "X11 at the final pixel")


def test_unported_matching_paths_raise():
    X11, X21, D11, D21 = (t(a) for a in _shift_scene(2))
    for kw in ({"refine_gate": "converged"}, {"proj_gate": "converged"},
               {"proj_init": "pinhole"}, {"proj_init": "best"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.match(X11, X21, D11, D21, **kw)
