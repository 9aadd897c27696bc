"""Port parity of the speed profile's matching paths (``ops/matching.py``):
the pinhole fit and start, the compaction of unconverged pixels, the gated
LM, ``refine_matches_gated`` on the refine kernel's plain version with a
dilation schedule, and ``match`` with each speed knob, against the JAX
package on the same numpy inputs at 48x64.

Tolerances.  The pinhole fit is four sums over the image in f32, taken in
another order: 1e-5 relative, so 1e-3 px on the start pixels.  The
compaction is integer work: equal.  The gated LM and ``match`` carry the
LM's last-bit noise (see tests/test_torch_matching.py), so at most 0.1% of
indices and validity flags may differ.  The descriptor refinement is
integer arithmetic on the same quantised descriptors: on equal inputs,
equal, level by level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import matching as jm
from mast3r_slam_tpu_torch.ops import matching as tm
from mast3r_slam_tpu_torch.ops import refine

from test_torch_common import assert_close, n, t
from test_torch_matching import MAX_MISMATCH, _oracle_pair, _shift_scene

HW = (48, 64)
N = HW[0] * HW[1]
BASE_KW = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-6,
               dist_thresh=0.1, radius=3, dilation_max=5)
# the packaged `speed` profile's matching section (config.py)
SPEED_KW = dict(refine_gate="converged", refine_subset_dilations=(5, 2),
                refine_final_radius=1, proj_gate="converged", proj_init="best",
                proj_pre_iters=0, proj_budget_frac=0.0625, refine_budget_frac=0.0625)


def _rays(pair=(3, 1)):
    X11, X21, D11, D21 = _oracle_pair(*pair)
    jr, jp, jinit = jm.prep_for_iter_proj(jnp.asarray(X11), jnp.asarray(X21), None)
    tr, tp, tinit = tm.prep_for_iter_proj(t(X11), t(X21), None)
    return (X11, X21, D11, D21), (jr, jp, jinit), (tr, tp, tinit)


def test_pinhole_fit_and_start():
    _, (jr, jp, _), (tr, tp, _) = _rays()
    want = jm.fit_pinhole_from_rays(jr[..., :3])
    got = tm.fit_pinhole_from_rays(tr[..., :3])
    for name, g, w in zip(("fx", "fy", "cx", "cy"), got, want):
        assert_close(g, np.asarray(w), 1e-5, 0, name)
    # the fit's 1e-5 relative on focal lengths and centres of tens of
    # pixels: a thousandth of a pixel
    assert_close(tm.pinhole_init(tr, tp), np.asarray(jm.pinhole_init(jr, jp)), 0, 1e-3,
                 "pinhole start pixels")


@pytest.mark.parametrize("frac_unconv,budget", [(0.05, 384), (0.3, 384), (0.0, 128),
                                                 (1.0, 2048), (0.6, 3072)])
def test_compact_unconverged_exact(frac_unconv, budget):
    """Unconverged pixels first in index order, filler after; pixels beyond
    the budget (0.3 and 1.0 of 3072 overflow 384 and 2048) are dropped."""
    rng = np.random.default_rng(int(frac_unconv * 100) + budget)
    conv = rng.random((2, N)) >= frac_unconv
    want = np.asarray(jm._compact_unconverged(jnp.asarray(conv), budget))
    got = n(tm._compact_unconverged(torch.from_numpy(conv), budget))
    np.testing.assert_array_equal(got, want)
    n_unconv = (~conv).sum(1)
    for b in range(2):  # every unconverged pixel that fits is in the subset
        first = np.nonzero(~conv[b])[0][:budget]
        np.testing.assert_array_equal(got[b, :min(budget, n_unconv[b])], first)


@pytest.mark.parametrize("pre_iters,alt", [(0, False), (2, False), (0, True), (4, True)])
def test_gated_iter_proj(pre_iters, alt):
    X, (jr, jp, jinit), (tr, tp, tinit) = _rays((5, 3))
    jalt = jm.pinhole_init(jr, jp) if alt else None
    talt = tm.pinhole_init(tr, tp) if alt else None
    kw = dict(gate="converged", pre_iters=pre_iters, budget_frac=0.0625)
    jp1, jconv, jx = jm.iter_proj(jr, jp, jinit, p_init_alt=jalt,
                                  extra_img=jnp.asarray(X[0]), **kw)
    tp1, tconv, tx = tm.iter_proj(tr, tp, tinit, p_init_alt=talt, extra_img=t(X[0]), **kw)
    floor_mis = np.mean(np.any(np.floor(n(tp1)) != np.floor(np.asarray(jp1)), -1))
    assert floor_mis <= MAX_MISMATCH, floor_mis
    assert np.mean(n(tconv) != np.asarray(jconv)) <= MAX_MISMATCH
    assert_close(tx, jx, 1e-4, 1e-4, "X11 at the final pixel")


KNOBS = [
    {"refine_gate": "converged"},
    {"refine_gate": "converged", "refine_subset_dilations": (5, 2, 1),
     "refine_final_radius": 1},
    {"refine_gate": "converged", "refine_final_radius": 0},
    {"proj_gate": "converged"},
    {"proj_gate": "converged", "proj_pre_iters": 0, "proj_budget_frac": 0.0625},
    {"proj_init": "pinhole"},
    {"proj_init": "best"},
    SPEED_KW,
]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "+".join(f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("warm", [False, True])
def test_match_with_speed_knobs(knobs, warm):
    X11, X21, D11, D21 = _oracle_pair(4, 2)
    init = None
    if warm:
        rng = np.random.default_rng(3)
        init = np.clip(np.arange(N) + rng.integers(-2, 3, size=N), 0, N - 1)[None]
        init = init.astype(np.int32)
    kw = dict(BASE_KW, **knobs)
    jidx, jvalid = jm.match(*(jnp.asarray(a) for a in (X11, X21, D11, D21)),
                            None if init is None else jnp.asarray(init), **kw)
    tidx, tvalid = tm.match(*(t(a) for a in (X11, X21, D11, D21)),
                            None if init is None else t(init), **kw)
    mismatch = float(np.mean(np.asarray(jidx) != n(tidx)))
    assert mismatch <= MAX_MISMATCH, f"{mismatch:.4%} of indices differ"
    assert float(np.mean(np.asarray(jvalid) != n(tvalid))) <= MAX_MISMATCH


def _gated_inputs(seed=0):
    """Descriptors of the shift scene, starts a few pixels off, and a
    convergence mask with about 8% unconverged pixels (more than a 1/16
    budget holds, so some are left out)."""
    _, _, D11, D21 = _shift_scene(3, seed)
    rng = np.random.default_rng(seed)
    H, W = HW
    u = np.clip(np.arange(N) % W + 3 + rng.integers(-4, 5, N), 0, W - 1)
    v = np.clip(np.arange(N) // W + rng.integers(-4, 5, N), 0, H - 1)
    p1 = np.stack([u, v], -1)[None].astype(np.int32)
    conv = rng.random((1, N)) > 0.08
    return D11, D21.reshape(1, N, -1), p1, conv


@pytest.mark.parametrize("subset", [None, (5, 2), (5, 2, 1)])
@pytest.mark.parametrize("final_radius", [None, 1, 0])
def test_refine_matches_gated_exact(subset, final_radius):
    D11, D21, p1, conv = _gated_inputs()
    kw = dict(radius=3, dilation_max=5, budget_frac=0.0625, subset_dilations=subset,
              final_radius=final_radius)
    want = jm.refine_matches_gated(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p1),
                                   jnp.asarray(conv), **kw)
    got = tm.refine_matches_gated(t(D11), t(D21), t(p1), t(conv), **kw)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert (n(got) != p1).any()  # the refinement moved pixels


def test_refine_schedule_level_by_level():
    """The plain refine with a schedule against the JAX strip-table levels
    (``_refine_coarse_subset``), one level at a time on a compacted subset
    in its own order, and the full schedule (5, ..., 1) against
    ``refine_matches``."""
    D11, D21, p1, conv = _gated_inputs(1)
    H, W = HW
    radius, max_rd = 3, 3 * 5
    D11q = jnp.clip(jnp.round(jnp.asarray(D11) * 127.0), -127, 127).astype(jnp.int8)
    D21q = jnp.clip(jnp.round(jnp.asarray(D21) * 127.0), -127, 127).astype(jnp.int8)
    Dpad = jnp.pad(D11q, ((0, 0), (max_rd, max_rd), (max_rd, max_rd), (0, 0)))
    sel = np.asarray(jm._compact_unconverged(jnp.asarray(conv), 256))
    u0 = jnp.asarray(np.take_along_axis(p1[..., 0], sel, 1))
    v0 = jnp.asarray(np.take_along_axis(p1[..., 1], sel, 1))
    tD11q = refine.quantize(t(D11)).reshape(1, N, -1)
    tD21q = refine.quantize(t(D21))[:, t(sel[0])].contiguous()
    idx = t((np.asarray(v0) * W + np.asarray(u0)).astype(np.int32))
    for d in (5, 4, 2, 1, 3):
        u0, v0 = jm._refine_coarse_subset(Dpad, jnp.take_along_axis(D21q, jnp.asarray(sel)[..., None], 1),
                                          u0, v0, H, W, max_rd, radius, [d])
        idx = refine.refine_window_plain(tD11q, tD21q, idx, H, W, radius, (d,))
        np.testing.assert_array_equal(n(idx), np.asarray(v0 * W + u0), err_msg=f"d={d}")
    want = jm.refine_matches(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p1),
                             radius=3, dilation_max=5)
    start = t((p1[..., 1] * W + p1[..., 0]).astype(np.int32))
    got = refine.refine_window_plain(tD11q, refine.quantize(t(D21)), start, H, W, 3,
                                     (5, 4, 3, 2, 1))
    np.testing.assert_array_equal(n(got), np.asarray(want[..., 1] * W + want[..., 0]))


def test_schedule_is_checked():
    d = torch.zeros(1, 16, 8, dtype=torch.int8)
    idx = torch.zeros(1, 16, dtype=torch.int32)
    for bad in ((), (1,) * 9, (2, 0)):
        with pytest.raises(ValueError, match="dilations"):
            refine.refine_window(d, d, idx, 4, 4, 1, bad)
    with pytest.raises(ValueError, match="gate"):
        tm.match(*(t(a) for a in _oracle_pair(1, 0)), refine_gate="strips")
