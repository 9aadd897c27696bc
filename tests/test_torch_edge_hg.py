"""The structural zeros that the edge-block kernel (``csrc/edge_hg_rays.cu``)
leaves out of its arithmetic, held on both packages' rows and blocks.

The kernel accumulates only the entries of a row [J_t | J_rot | J_s | err]
that can be non-zero: in each ray row J_t, two entries of -[rj]x and err
(its J_s and the diagonal of -[rj]x are zero); in the distance row rj,
|P| and err (its J_rot is zero).  So Mloc[:, 3:6, 6] and its mirror are
sums of exact zeros.  The same numpy inputs go through the JAX package's
``global_gn._ray_residuals`` (one edge at a time, as its solve calls it)
and the port's ``edge_hg.ray_residuals``; the blocks through the JAX
Pallas kernel (interpret mode, as the JAX package's own tests run it on
the CPU) and the port's ``edge_hg_rays_plain``.  The zeros are exact: no
tolerance.  The two packages' rows agree within 2e-6 absolute (f32 rows of
magnitude up to 1/|P| <= 1, the same formulas in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.ops import global_gn as jgn
from mast3r_slam_tpu.ops.edge_hg_pallas import TILE_N, edge_hg_rays_pallas
from mast3r_slam_tpu_torch.ops import edge_hg

from test_torch_common import assert_close, n, random_sim3, t

SIG = dict(sigma_ray=0.003, sigma_dist=10.0, huber_k=1.345)
# columns of the 7 Jacobian entries that can be non-zero in each of the 4
# rows: the kernel's RAY0, RAY1, RAY2 and DIST masks without the err column
NONZERO = ({0, 1, 2, 4, 5}, {0, 1, 2, 3, 5}, {0, 1, 2, 3, 4}, {0, 1, 2, 6})


def _inputs(E, N, seed, garbage=None):
    """Edges whose j-points map near their i-points, a fifth of the pixels
    invalid (sq = 0); with ``garbage``, the invalid pixels' points set to it."""
    rng = np.random.default_rng(seed)
    Tij = random_sim3(rng, (E,), t_scale=0.2, rot_scale=0.2)
    Xi = rng.normal(size=(E, N, 3)).astype(np.float32)
    Xi[..., 2] = np.abs(Xi[..., 2]) + 2.0
    Xj = np.asarray(jsim3.act(jsim3.inv(jnp.asarray(Tij))[:, None, :], jnp.asarray(Xi)))
    Xj = (Xj + rng.normal(size=Xj.shape) * 0.01).astype(np.float32)
    sq = (np.sqrt(rng.uniform(1.5, 3.0, size=(E, N)))
          * (rng.uniform(size=(E, N)) > 0.2)).astype(np.float32)
    if garbage is not None:
        Xi[sq == 0] = garbage
        Xj[sq == 0] = garbage
    return Tij, Xi, Xj, sq


def _rows(package, Tij, Xi, Xj):
    """(err (E, N, 4), J (E, N, 4, 7)) as numpy, from one package."""
    if package == "jax":
        out = [jgn._ray_residuals(jnp.asarray(Tij[e]), jnp.asarray(Xi[e]), jnp.asarray(Xj[e]))
               for e in range(len(Tij))]
        return np.stack([n(o[0]) for o in out]), np.stack([n(o[1]) for o in out])
    err, J = edge_hg.ray_residuals(t(Tij), t(Xi), t(Xj))
    return n(err), n(J)


def _blocks(package, Tij, Xi, Xj, sq):
    """Mloc (E, 8, 8) as numpy: the JAX Pallas kernel (pixels padded to its
    tile with finite points at zero weight, channel-major) or the port's
    plain version."""
    if package == "jax":
        pad = (-Xi.shape[1]) % TILE_N
        pts = lambda X: np.swapaxes(np.pad(X, ((0, 0), (0, pad), (0, 0)),
                                           constant_values=1.0), 1, 2)
        sq_p = np.pad(sq, ((0, 0), (0, pad)))[:, None, :]
        return n(edge_hg_rays_pallas(jnp.asarray(Tij), jnp.asarray(pts(Xi)),
                                     jnp.asarray(pts(Xj)), jnp.asarray(sq_p), **SIG))
    return n(edge_hg.edge_hg_rays_plain(t(Tij), t(Xi), t(Xj), t(sq), **SIG))


CASES = [dict(E=3, N=200, seed=0), dict(E=2, N=333, seed=1, garbage=0.0),
         dict(E=2, N=150, seed=2, garbage=37.0)]


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES, ids=["valid", "zero_points", "garbage_points"])
def test_ray_rows_structural_zeros(package, case):
    _, J = _rows(package, *_inputs(**case)[:3])
    assert J.shape[-2:] == (4, 7)
    assert (J[..., :3, 6] == 0).all()                  # J_ray[..., 6]: no scale term
    assert (J[..., 3, 3:6] == 0).all()                 # J_dist[..., 3:6]: no rotation
    for k in range(3):
        assert (J[..., k, 3 + k] == 0).all()           # the zero diagonal of -[rj]x
    for r, cols in enumerate(NONZERO):                 # the kernel's masks, row by row
        off = [c for c in range(7) if c not in cols]
        assert (J[..., r, off] == 0).all(), (r, off)
        assert np.isfinite(J[..., r, :]).all()


@pytest.mark.parametrize("case", CASES, ids=["valid", "zero_points", "garbage_points"])
def test_ray_rows_agree_between_packages(case):
    Tij, Xi, Xj, _ = _inputs(**case)
    err_j, J_j = _rows("jax", Tij, Xi, Xj)
    err_t, J_t = _rows("torch", Tij, Xi, Xj)
    valid = np.linalg.norm(Xi, axis=-1) > 0    # the JAX rows take no clamp at |Xi| = 0
    assert_close(err_t[valid], err_j[valid], rtol=0, atol=2e-6, what="err")
    assert_close(J_t[valid], J_j[valid], rtol=0, atol=2e-6, what="J")


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES[:2], ids=["valid", "zero_points"])
def test_plain_blocks_zero_where_no_row_reaches(package, case):
    M = _blocks(package, *_inputs(**case))
    assert M.shape[-2:] == (8, 8) and np.isfinite(M).all()
    assert (M[:, 3:6, 6] == 0).all() and (M[:, 6, 3:6] == 0).all()
    # and only there: every other entry of an edge with valid pixels is non-zero
    rest = np.ones((8, 8), bool)
    rest[3:6, 6] = rest[6, 3:6] = False
    assert (M[:, rest] != 0).all()
