"""The port's loader of released PyTorch checkpoints against the JAX
package's (``mast3r_slam_tpu/models/convert.py``).

No checkpoint can be fetched, so the test writes one: random-init
``VIT_TINY_TEST`` parameters in the JAX layout taken back to an ``AsymmetricMASt3R`` state
dict under the released key names (the inverse of the loaders' layout
transforms, the local MLP's fc2 columns back in torch's channel-major
order), saved as a ``.pth`` with the released ``args.model`` arch string.
Both loaders must give the same parameters bit for bit (and those of the
tree it came from); the models built on them agree as in
tests/test_torch_model.py (1e-4, the pointmap 5e-4 relative).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import convert as jconvert
from mast3r_slam_tpu.models import io as jio
from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu_torch.models import convert as tconvert
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.models.interface import MASt3RModel

from test_arch_string import RELEASED_ARCH, TINY_ARCH
from test_torch_common import CPU, assert_close, f32, t

HW = (48, 64)


def _linear(sd, key, p):
    sd[key + ".weight"] = p["w"].T
    if "b" in p:
        sd[key + ".bias"] = p["b"]


def _conv(sd, key, p):
    sd[key + ".weight"] = p["w"].transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if "b" in p:
        sd[key + ".bias"] = p["b"]


def _conv_t(sd, key, p):
    cout = p["b"].shape[0]
    cin, cols = p["w"].shape
    k = int(round((cols // cout) ** 0.5))
    sd[key + ".weight"] = p["w"].reshape(cin, k, k, cout).transpose(0, 3, 1, 2)
    sd[key + ".bias"] = p["b"]


def _block(sd, key, p):
    for name in ("norm1", "norm2", "norm3", "norm_y"):
        if name in p:
            _linear(sd, f"{key}.{name}", {"w": p[name]["w"].T, "b": p[name]["b"]})
    _linear(sd, f"{key}.attn.qkv", p["attn"]["qkv"])
    _linear(sd, f"{key}.attn.proj", p["attn"]["proj"])
    if "cross_attn" in p:
        for ours, theirs in (("q", "projq"), ("k", "projk"), ("v", "projv"), ("proj", "proj")):
            _linear(sd, f"{key}.cross_attn.{theirs}", p["cross_attn"][ours])
    _linear(sd, f"{key}.mlp.fc1", p["mlp"]["fc1"])
    _linear(sd, f"{key}.mlp.fc2", p["mlp"]["fc2"])


def state_dict_from_jax(tree, cfg):
    """A JAX parameter tree (numpy) -> an AsymmetricMASt3R state dict."""
    sd = {}
    P = cfg.patch_size
    w = tree["patch_embed"]["w"]
    sd["patch_embed.proj.weight"] = w.reshape(P, P, 3, -1).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = tree["patch_embed"]["b"]
    for name in ("enc_blocks", "dec_blocks", "dec_blocks2"):
        depth = jax.tree.leaves(tree[name])[0].shape[0]
        for i in range(depth):
            _block(sd, f"{name}.{i}", jax.tree.map(lambda a: a[i], tree[name]))
    for name in ("enc_norm", "dec_norm"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = tree[name]["w"], tree[name]["b"]
    _linear(sd, "decoder_embed", tree["decoder_embed"])
    for h in (1, 2):
        hp, head = f"downstream_head{h}", tree[f"head{h}"]
        d, ap, sc = head["dpt"], f"downstream_head{h}.dpt.act_postprocess", \
            f"downstream_head{h}.dpt.scratch"
        _conv(sd, f"{ap}.0.0", d["act1"]["conv"])
        _conv_t(sd, f"{ap}.0.1", d["act1"]["convt"])
        _conv(sd, f"{ap}.1.0", d["act2"]["conv"])
        _conv_t(sd, f"{ap}.1.1", d["act2"]["convt"])
        _conv(sd, f"{ap}.2.0", d["act3"]["conv"])
        _conv(sd, f"{ap}.3.0", d["act4"]["conv"])
        _conv(sd, f"{ap}.3.1", d["act4"]["conv2"])
        for k in (1, 2, 3, 4):
            _conv(sd, f"{sc}.layer{k}_rn", d[f"rn{k}"])
            rp, f = f"{sc}.refinenet{k}", d[f"refine{k}"]
            for u in (1, 2):
                _conv(sd, f"{rp}.resConfUnit{u}.conv1", f[f"res{u}"]["conv1"])
                _conv(sd, f"{rp}.resConfUnit{u}.conv2", f[f"res{u}"]["conv2"])
            _conv(sd, f"{rp}.out_conv", f["out_conv"])
        for k, name in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
            _conv(sd, f"{hp}.dpt.head.{k}", d["head"][name])
        mlp = head["local_mlp"]
        _linear(sd, f"{hp}.head_local_features.fc1", mlp["fc1"])
        C = mlp["fc2"]["w"].shape[1] // (P * P)
        perm = (np.arange(C)[None, :] * P * P + np.arange(P * P)[:, None]).reshape(-1)
        inv = np.argsort(perm)  # pixel-major -> torch's channel-major
        _linear(sd, f"{hp}.head_local_features.fc2",
                {"w": mlp["fc2"]["w"][:, inv], "b": mlp["fc2"]["b"][inv]})
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """Random ``VIT_TINY_TEST`` parameters in the JAX package's layout (the
    port's init, through the npz both packages read: quicker than JAX's
    init, the same tree), as a state dict and as a ``.pth``."""
    d = tmp_path_factory.mktemp("pth")
    tconvert.save_params(d / "p.npz", TM.init_params(TM.VIT_TINY_TEST, seed=0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jio.load_params(d / "p.npz"))
    sd = state_dict_from_jax(tree, JM.VIT_TINY_TEST)
    pth = d / "tiny.pth"
    torch.save({"model": sd, "args": types.SimpleNamespace(model=TINY_ARCH)}, pth)
    return tree, sd, pth


def _assert_same_params(got, want):
    flat_g = dict(_flatten(got))
    flat_w = dict(_flatten(want))
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        assert flat_g[k].dtype == flat_w[k].dtype, k
        assert torch.equal(flat_g[k], flat_w[k]), k


def _flatten(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, node


def test_both_loaders_give_the_same_params(released):
    tree, sd, _ = released
    jparams = jconvert.torch_state_dict_to_params(sd, JM.VIT_TINY_TEST)
    want = tconvert.params_from_jax(jax.tree.map(np.asarray, jparams))
    got = tconvert.torch_state_dict_to_params(sd, TM.VIT_TINY_TEST)
    _assert_same_params(got, want)
    _assert_same_params(got, tconvert.params_from_jax(tree))  # the tree it came from


def test_the_dec_blocks2_fallback(released):
    _, sd, _ = released
    sd1 = {k: v for k, v in sd.items() if not k.startswith("dec_blocks2")}
    got = tconvert.torch_state_dict_to_params(sd1, TM.VIT_TINY_TEST)
    want = tconvert.params_from_jax(jax.tree.map(
        np.asarray, jconvert.torch_state_dict_to_params(sd1, JM.VIT_TINY_TEST)))
    _assert_same_params(got, want)
    _assert_same_params(got["dec_blocks2"], got["dec_blocks"])


def test_the_bf16_trunk_is_cast_as_in_the_jax_package(released):
    _, sd, _ = released
    jcfg = dataclasses.replace(JM.VIT_TINY_TEST, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TM.VIT_TINY_TEST, dtype=torch.bfloat16)
    got = tconvert.torch_state_dict_to_params(sd, tcfg)
    want = tconvert.params_from_jax(jax.tree.map(
        np.asarray, jconvert.torch_state_dict_to_params(sd, jcfg)))
    _assert_same_params(got, want)
    assert got["enc_blocks"][0]["mlp"]["fc1"]["w"].dtype == torch.bfloat16
    assert got["enc_blocks"][0]["norm1"]["w"].dtype == torch.float32


def test_the_pth_file_and_its_model(released):
    tree, _, pth = released
    params, cfg = tconvert.load_torch_checkpoint(pth, TM.VIT_TINY_TEST)
    jparams, jcfg = jconvert.load_torch_checkpoint(str(pth), JM.VIT_TINY_TEST)
    for f in ("enc_embed_dim", "enc_depth", "enc_num_heads", "dec_embed_dim",
              "dec_depth", "dec_num_heads", "patch_size", "rope_base", "desc_dim",
              "conf_offset", "desc_conf_offset"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    _assert_same_params(params, tconvert.params_from_jax(jax.tree.map(np.asarray, jparams)))

    model = MASt3RModel.from_torch_checkpoint(pth, HW, TM.VIT_TINY_TEST, device=CPU)
    img = f32(np.random.default_rng(0), 1, 3, *HW)
    feat, pos = model.encode(t(img))
    jfeat, jpos = JM.encode_image(jparams, jcfg, jnp.asarray(img))
    assert_close(feat, jfeat, 1e-4, 1e-4, "tokens")
    X, C = model.mono(t(np.asarray(jfeat, np.float32)), pos)  # the same tokens in both
    jX, jC = JM.inference_mono(jparams, jcfg, jfeat, jpos, jcfg.grid(HW))
    assert_close(X, jX, 5e-4, 1e-4, "X")
    assert_close(C, jC, 1e-4, 1e-4, "C")


def test_parse_the_released_arch_string():
    parsed = tconvert.parse_arch_string(RELEASED_ARCH)
    assert parsed == jconvert.parse_arch_string(RELEASED_ARCH)
    cfg = tconvert.config_from_arch(RELEASED_ARCH)
    assert (cfg.enc_embed_dim, cfg.enc_depth, cfg.dec_embed_dim, cfg.dec_depth) == (
        1024, 24, 768, 12)
    assert cfg.rope_base == 100.0 and cfg.desc_dim == 24 and cfg.conf_offset == 1.0


@pytest.mark.parametrize("arch,errors", [
    ("AsymmetricMASt3R(x=__import__('os').system('id'))", ValueError),
    ("__import__('os').system('id')", (ValueError, SyntaxError)),
    ("AsymmetricMASt3R(enc_embed_dim=1024+0)", ValueError),
])
def test_parse_refuses_code(arch, errors):
    with pytest.raises(errors):
        tconvert.parse_arch_string(arch)


@pytest.mark.parametrize("arch", ["M(output_mode='pts3d')", "M(conf_mode=('sigmoid', 0, 1))",
                                  "M(pos_embed='cosine')"])
def test_config_from_arch_refuses_unknown_modes(arch):
    with pytest.raises(ValueError):
        tconvert.config_from_arch(arch)
    with pytest.raises(ValueError):
        jconvert.config_from_arch(arch)
