"""Port parity of the model: encode, asymmetric and mono inference with the
JAX package's random-init weights carried across by ``params_from_jax``,
and the npz round trip (JAX ``save_params`` -> port ``load_params``).

``VIT_TINY_TEST`` (f32 trunk and heads) at 48x64.  Tolerance: both sides
run the same f32 network; matrix products and convolutions sum in
different orders (XLA against oneDNN), which moves the last bits through
~30 layers.  Tokens and head outputs agree to 1e-4 relative / 1e-4
absolute; the pointmap goes through exp(|xyz|), so it gets 5e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import io as jio
from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.models.convert import load_params, params_from_jax
from mast3r_slam_tpu_torch.models.interface import MASt3RModel

from test_torch_common import CPU, assert_close, f32, n, t

HW = (48, 64)
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def models():
    jparams = JM.init_params(jax.random.PRNGKey(0), JM.VIT_TINY_TEST)
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = MASt3RModel(params_from_jax(tree), TM.VIT_TINY_TEST, HW, device=CPU)
    img = f32(np.random.default_rng(0), 2, 3, *HW)
    return jparams, tmodel, img


@pytest.fixture(scope="module")
def encoded(models):
    jparams, tmodel, img = models
    jfeat, jpos = JM.encode_image(jparams, JM.VIT_TINY_TEST, jnp.asarray(img))
    tfeat, tpos = tmodel.encode(t(img))
    return jfeat, jpos, tfeat, tpos


def test_encode_parity(encoded):
    jfeat, jpos, tfeat, tpos = encoded
    assert tfeat.dtype == torch.float32 and tfeat.shape == (2, 12, 64)
    np.testing.assert_array_equal(n(tpos), np.asarray(jpos))
    assert_close(tfeat, jfeat, RTOL, ATOL)


def test_asymmetric_parity(models, encoded):
    jparams, tmodel, _ = models
    jfeat, jpos, _, _ = encoded
    grid = JM.VIT_TINY_TEST.grid(HW)
    # identical encoder tokens into both decoders
    fi, fj = np.asarray(jfeat[:1]), np.asarray(jfeat[1:])
    pi, pj = np.asarray(jpos[:1]), np.asarray(jpos[1:])
    want = JM.inference_asymmetric(jparams, JM.VIT_TINY_TEST, fi, pi, fj, pj, grid)
    got = tmodel.asymmetric(t(fi), t(pi), t(fj), t(pj))
    for view_w, view_g in zip(want, got):
        Xw, Cw, Dw, Qw = view_w
        Xg, Cg, Dg, Qg = view_g
        assert Xg.shape == (1, *HW, 3) and Dg.shape == (1, *HW, 24)
        assert_close(Xg, Xw, 5e-4, ATOL, "X")
        assert_close(Cg, Cw, RTOL, ATOL, "C")
        assert_close(Dg, Dw, RTOL, ATOL, "D")
        assert_close(Qg, Qw, RTOL, ATOL, "Q")


def test_mono_parity(models, encoded):
    jparams, tmodel, _ = models
    jfeat, jpos, _, _ = encoded
    grid = JM.VIT_TINY_TEST.grid(HW)
    f, p = np.asarray(jfeat[:1]), np.asarray(jpos[:1])
    Xw, Cw = JM.inference_mono(jparams, JM.VIT_TINY_TEST, f, p, grid)
    Xg, Cg = tmodel.mono(t(f), t(p))
    assert_close(Xg, Xw, 5e-4, ATOL, "X")
    assert_close(Cg, Cw, RTOL, ATOL, "C")


def test_npz_round_trip_bf16_trunk(tmp_path, models):
    """A bf16-trunk checkpoint saved by the JAX package loads bit-exactly."""
    cfg = dataclasses.replace(JM.VIT_TINY_TEST, dtype=jnp.bfloat16)
    jparams = JM.init_params(jax.random.PRNGKey(1), cfg)
    path = tmp_path / "tiny.npz"
    jio.save_params(path, jparams)
    tparams = load_params(path)
    w_j = np.asarray(jparams["enc_blocks"]["attn"]["qkv"]["w"][1].astype(jnp.float32))
    w_t = tparams["enc_blocks"][1]["attn"]["qkv"]["w"]
    assert w_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(w_t), w_j)
    # conv weights arrive OIHW, fc2 columns unpermuted
    conv_j = np.asarray(jparams["head1"]["dpt"]["rn1"]["w"])  # HWIO
    np.testing.assert_array_equal(n(tparams["head1"]["dpt"]["rn1"]["w"]),
                                  conv_j.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(n(tparams["head2"]["local_mlp"]["fc2"]["w"]),
                                  np.asarray(jparams["head2"]["local_mlp"]["fc2"]["w"]))


def test_npz_round_trip_same_outputs(tmp_path, models, encoded):
    jparams, tmodel, img = models
    path = tmp_path / "tiny_f32.npz"
    jio.save_params(path, jparams)
    loaded = MASt3RModel.from_npz(path, HW, TM.VIT_TINY_TEST, device=CPU)
    feat, _ = loaded.encode(t(img))
    _, _, tfeat, _ = encoded
    assert_close(feat, tfeat, 0, 0)


def test_port_random_init_shapes():
    """The port's own seeded init: the JAX package's shapes, reproducible."""
    a = TM.init_params(TM.VIT_TINY_TEST, seed=3)
    b = TM.init_params(TM.VIT_TINY_TEST, seed=3)
    jshapes = jax.tree.map(lambda x: x.shape, JM.init_params(jax.random.PRNGKey(0),
                                                             JM.VIT_TINY_TEST))
    blk_j = jshapes["dec_blocks"]["cross_attn"]["q"]["w"]
    assert tuple(a["dec_blocks"][0]["cross_attn"]["q"]["w"].shape) == blk_j[1:]
    assert len(a["dec_blocks"]) == blk_j[0]
    assert tuple(a["head1"]["dpt"]["act1"]["convt"]["w"].shape) == \
        jshapes["head1"]["dpt"]["act1"]["convt"]["w"]
    assert_close(a["enc_blocks"][1]["mlp"]["fc1"]["w"], b["enc_blocks"][1]["mlp"]["fc1"]["w"], 0, 0)
