"""Port parity: Sim(3) group and projective geometry, with Jacobians, in f32.

Tolerance: both sides evaluate the same float32 formulas, so results agree
to float32 rounding; 2e-5 relative / 2e-6 absolute leaves room for a few
ulps of reordered sums and the different libm of each side.  ``log``
solves a 3x3 system (different LAPACK paths): 1e-4 / 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mast3r_slam_tpu.geometry import projective as jproj
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu_torch.geometry import projective as tproj
from mast3r_slam_tpu_torch.lie import sim3 as tsim3

from test_torch_common import assert_close, f32, n, random_sim3, t

RTOL, ATOL = 2e-5, 2e-6
B = (5, 7)


@pytest.fixture
def data():
    rng = np.random.default_rng(11)
    return dict(
        Ta=random_sim3(rng, B),
        Tb=random_sim3(rng, B),
        X=f32(rng, *B, 3, scale=2.0),
        q=random_sim3(rng, B)[..., 3:7],
        xi_small=f32(rng, *B, 7, scale=1e-3),
        xi_mid=f32(rng, *B, 7, scale=0.3),
        row=f32(rng, *B, 7),
    )


BINARY = ["mul", "rel", "retr_small", "retr_mid", "act", "apply_adj_inv"]


@pytest.mark.parametrize("op", BINARY)
def test_sim3_binary_ops(data, op):
    Ta, Tb = data["Ta"], data["Tb"]
    if op == "mul":
        args = (Ta, Tb)
    elif op == "rel":
        args = (Ta, Tb)
    elif op == "retr_small":
        args, op = (Ta, data["xi_small"]), "retr"
    elif op == "retr_mid":
        args, op = (Ta, data["xi_mid"]), "retr"
    elif op == "act":
        args = (Ta, data["X"])
    else:
        args = (Ta, data["row"])
    want = getattr(jsim3, op)(*[jnp.asarray(a) for a in args])
    got = getattr(tsim3, op)(*[t(a) for a in args])
    assert_close(got, want, RTOL, ATOL, op)


UNARY = ["inv", "normalize", "to_se3", "exp_small", "exp_mid", "exp_so3_quat",
         "quat_inv"]


@pytest.mark.parametrize("op", UNARY)
def test_sim3_unary_ops(data, op):
    arg = {"exp_small": data["xi_small"], "exp_mid": data["xi_mid"],
           "exp_so3_quat": data["xi_mid"][..., 3:6],
           "quat_inv": data["q"]}.get(op, data["Ta"])
    name = "exp" if op.startswith("exp_") and op != "exp_so3_quat" else op
    want = getattr(jsim3, name)(jnp.asarray(arg))
    got = getattr(tsim3, name)(t(arg))
    assert_close(got, want, RTOL, ATOL, op)


def test_sim3_quat_ops(data):
    qa, qb, X = data["q"], data["Ta"][..., 3:7], data["X"]
    assert_close(tsim3.quat_mul(t(qa), t(qb)),
                 jsim3.quat_mul(jnp.asarray(qa), jnp.asarray(qb)), RTOL, ATOL)
    assert_close(tsim3.quat_act(t(qa), t(X)),
                 jsim3.quat_act(jnp.asarray(qa), jnp.asarray(X)), RTOL, ATOL)


@pytest.mark.parametrize("scale", [1e-3, 0.3])
def test_sim3_log_and_roundtrip(data, scale):
    rng = np.random.default_rng(5)
    xi = f32(rng, 6, 7, scale=scale)
    T = jsim3.exp(jnp.asarray(xi))
    want = jsim3.log(T)
    got = tsim3.log(t(T))
    assert_close(got, want, 1e-4, 1e-5, "log")
    # and the port's own round trip log(exp(xi)) == xi
    assert_close(tsim3.log(tsim3.exp(t(xi))), xi, 1e-3, 2e-5, "log(exp)")


def test_sim3_identity():
    assert_close(tsim3.identity((3,)), jsim3.identity((3,)), 0, 0)


# ---------------------------------------------------------------------------
# projective geometry
# ---------------------------------------------------------------------------

K = np.array([[50.0, 0, 31.5], [0, 52.0, 23.5], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("jac", [False, True])
def test_point_to_ray_dist(data, jac):
    X = data["X"]
    want = jproj.point_to_ray_dist(jnp.asarray(X), jacobian=jac)
    got = tproj.point_to_ray_dist(t(X), jacobian=jac)
    if jac:
        for g, w in zip(got, want):
            assert_close(g, w, RTOL, ATOL)
    else:
        assert_close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("jac", [False, True])
def test_act_sim3(data, jac):
    Ta, X = data["Ta"], data["X"]
    want = jproj.act_sim3(jnp.asarray(Ta), jnp.asarray(X), jacobian=jac)
    got = tproj.act_sim3(t(Ta), t(X), jacobian=jac)
    if jac:
        for g, w in zip(got, want):
            assert_close(g, w, RTOL, ATOL)
    else:
        assert_close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("jac", [False, True])
def test_project_calib(jac):
    rng = np.random.default_rng(2)
    P = f32(rng, 200, 3)
    P[:, 2] = np.abs(P[:, 2]) * 3 + 0.05
    P[:7, 2] = -0.5  # behind the camera: invalid
    want = jproj.project_calib(jnp.asarray(P), jnp.asarray(K), (48, 64), jacobian=jac,
                               border=-10.0, z_eps=1e-6)
    got = tproj.project_calib(t(P), t(K), (48, 64), jacobian=jac, border=-10.0,
                              z_eps=1e-6)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if n(w).dtype == bool:
            np.testing.assert_array_equal(n(g), n(w))
        else:
            assert_close(g, w, RTOL, 1e-5)


def test_tau_jacobian_backproject_constrain(data):
    rng = np.random.default_rng(4)
    dres = f32(rng, 30, 4, 3)
    Y = f32(rng, 30, 3)
    assert_close(tproj.tau_jacobian(t(dres), t(Y)),
                 jproj.tau_jacobian(jnp.asarray(dres), jnp.asarray(Y)), RTOL, ATOL)
    uv = np.asarray(jproj.get_pixel_coords((6, 8))).reshape(-1, 2)
    z = np.abs(f32(rng, 48, 1)) + 0.5
    assert_close(tproj.get_pixel_coords((6, 8)), jproj.get_pixel_coords((6, 8)), 0, 0)
    assert_close(tproj.backproject(t(uv), t(z), t(K)),
                 jproj.backproject(jnp.asarray(uv), jnp.asarray(z), jnp.asarray(K)),
                 RTOL, ATOL)
    Xs = f32(rng, 48, 3)
    assert_close(tproj.constrain_points_to_ray((6, 8), t(Xs), t(K)),
                 jproj.constrain_points_to_ray((6, 8), jnp.asarray(Xs), jnp.asarray(K)),
                 RTOL, ATOL)
    assert_close(tproj.skew(t(Y)), jproj.skew(jnp.asarray(Y)), 0, 0)
