"""The port's vision models (``rten_tpu_torch/models/vit.py``,
``mobilenet.py``, ``resnet.py``, plain kernel versions on the CPU) and
image I/O (``rten_tpu_torch/image/io.py``) against the JAX package's on the
same seeded inputs and parameters, carried across by ``params_from_jax``.

The JAX side runs its TPU branch (``patch_jax_encoders``: ViT's
``flash_attention`` and MobileNet's int8 pointwise convolutions through
``quant_matmul_int8``, in interpret mode). Sizes: ViT at ``VIT_TINY``'s
widths with 32² images, patches of 8 and 2 layers (17 tokens); a MobileNet
with blocks ((1, 16, 1, 1), (6, 24, 2, 2)) at 32², whose second block's
expand convolution has K 24; ResNet as ``tests/test_resnet.py``'s ``TINY``
(bottleneck, stages (1, 1), width 8). Tolerance: f32 outputs within 1e-4
of the output's largest magnitude; equal top-1 classes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.image import io as jimage
from rten_tpu.models import mobilenet as jmb
from rten_tpu.models import resnet as jrn
from rten_tpu.models import vit as jvit
from rten_tpu_torch.image import io as timage
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import ieee
from rten_tpu_torch.models import mobilenet as tmb
from rten_tpu_torch.models import resnet as trn
from rten_tpu_torch.models import vit as tvit
from torch_port_helpers import patch_jax_encoders, rel_err, to_jax, to_numpy, torch_f32

TOL = 1e-4
VIT = dict(image_size=32, patch_size=8, n_layers=2, n_heads=4, d_model=256, d_ff=1024, n_classes=10)
MBN = dict(blocks=((1, 16, 1, 1), (6, 24, 2, 2)), stem_channels=32, last_channels=64, num_classes=10)
RN = dict(block="bottleneck", stage_sizes=(1, 1), num_classes=10, width=8)


def _images(n=2, seed=3):
    return np.random.default_rng(seed).standard_normal((n, 3, 32, 32)).astype(np.float32)


def _jitter(tree, rng):
    """Zero biases and shifts of an init tree made random, unit scales
    jittered (the inits leave those paths untested)."""
    if isinstance(tree, dict):
        return {k: _jitter(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jitter(v, rng) for v in tree]
    arr = np.asarray(tree, np.float32)
    if arr.ndim == 1 and np.all(arr == 0):
        return (rng.standard_normal(arr.shape) * 0.05).astype(np.float32)
    if arr.ndim == 1 and np.all(arr == 1):
        return rng.uniform(0.8, 1.2, arr.shape).astype(np.float32)
    return arr


@pytest.fixture(scope="module")
def runs():
    """The JAX package's outputs under its TPU branch: ViT's hidden states
    and logits, MobileNet's int8 logits, ResNet's logits and feature map;
    with each params tree as numpy."""
    import jax

    key = jax.random.PRNGKey(0)
    vcfg, mcfg, rcfg = jvit.ViTConfig(**VIT), jmb.MobileNetConfig(**MBN), jrn.ResNetConfig(**RN, dtype=jnp.float32)
    rng = np.random.default_rng(9)
    vtree = to_jax(_jitter(to_numpy(jvit.init_params(key, vcfg)), rng))
    mtree = jmb.quantize_params_int8(to_jax(_jitter(to_numpy(jmb.init_params(key, mcfg)), rng)))
    rtree = to_jax(_jitter(to_numpy(jrn.init_params(key, rcfg)), rng))
    img = jnp.asarray(_images())
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_encoders(mp)
        vhidden = jvit.encode(vtree, vcfg, img)
        out = dict(
            vit=(to_numpy(vtree), np.asarray(vhidden), np.asarray(jvit.classify(vtree, vcfg, img)),
                 np.asarray(jvit.feature_map(vhidden, vcfg))),
            mobilenet=(to_numpy(mtree), np.asarray(jmb.forward(mtree, mcfg, img))),
            resnet=(to_numpy(rtree), np.asarray(jrn.forward(rtree, rcfg, img)),
                    np.asarray(jrn.forward(rtree, rcfg, img, features=True))),
        )
    return out


def test_patchify_matches_jax():
    img = _images(2, 4)
    got = tvit.patchify(torch.from_numpy(img), 8).numpy()
    assert np.array_equal(got, np.asarray(jvit.patchify(jnp.asarray(img), 8)))


def test_vit_matches_jax(runs):
    """Hidden states (cls first), logits, feature map; flash attention once
    a layer, no int8 matmul (the ViT has no quantizer)."""
    tree, hidden, logits, fmap = runs["vit"]
    cfg = tvit.ViTConfig(**VIT)
    params = tvit.params_from_jax(tree, cfg, device="cpu")
    dispatch.reset_counters()
    got = tvit.encode(params, cfg, torch.from_numpy(_images()))
    assert dict(dispatch.PLAIN) == {"flash_attention": VIT["n_layers"]}
    assert got.shape == hidden.shape == (2, 17, 256) and rel_err(got.numpy(), hidden) <= TOL
    got_logits = tvit.classify(params, cfg, torch.from_numpy(_images())).numpy()
    assert rel_err(got_logits, logits) <= TOL and np.array_equal(got_logits.argmax(1), logits.argmax(1))
    got_map = tvit.feature_map(got, cfg).numpy()
    assert got_map.shape == fmap.shape == (2, 256, 4, 4) and rel_err(got_map, fmap) <= TOL


def test_mobilenet_matches_jax(runs):
    """Logits of the int8 model: every pointwise convolution (the K-24
    expand included) through quant_matmul_int8."""
    tree, logits = runs["mobilenet"]
    cfg = tmb.MobileNetConfig(**MBN)
    params = tmb.params_from_jax(tree, cfg, device="cpu")
    ks = [b["expand_w"]["qt"].shape[1] for b in params["blocks"] if "expand_w" in b]
    assert ks == [16, 24]
    dispatch.reset_counters()
    got = tmb.forward(params, cfg, torch.from_numpy(_images())).numpy()
    n_pointwise = sum(1 + e for *_, e in tmb.block_layout(cfg)) + 1
    assert dict(dispatch.PLAIN) == {"quant_matmul_int8": n_pointwise}
    assert got.dtype == np.float32 and rel_err(got, logits) <= TOL
    assert np.array_equal(got.argmax(1), logits.argmax(1))


def test_mobilenet_quantizer_and_layout_match_jax():
    """The port's quantizer packs what the JAX package's packs, with its
    codes and scales, at MobileNetV2's layout (two K-24 expands) and the
    test model's."""
    assert tmb.block_layout(tmb.MOBILENET_V2) == jmb.block_layout(jmb.MOBILENET_V2)
    assert tmb.block_layout(tmb.MOBILENET_TINY) == jmb.block_layout(jmb.MOBILENET_TINY)
    v2 = [(cin, hidden) for cin, _o, hidden, _s, e in tmb.block_layout(tmb.MOBILENET_V2) if e]
    assert [kn for kn in v2 if kn[0] == 24] == [(24, 144), (24, 144)]
    import jax

    jtree = to_numpy(jmb.init_params(jax.random.PRNGKey(1), jmb.MobileNetConfig(**MBN)))
    tq = tmb.quantize_params_int8(tmb.params_from_jax(jtree, tmb.MobileNetConfig(**MBN), device="cpu"), device="cpu")
    jq = jmb.quantize_params_int8(to_jax(jtree))
    for tb, jb in zip(tq["blocks"] + [tq], jq["blocks"] + [jq]):
        for name in ("expand_w", "project_w", "head_w"):
            if name in jb:
                assert np.array_equal(tb[name]["qt"].numpy(), np.asarray(jb[name]["q"]).T)
                assert np.array_equal(tb[name]["s"].numpy(), np.asarray(jb[name]["s"]).reshape(-1))
    assert torch.equal(tq["fc_w"], torch_f32(jq["fc_w"]))


def test_resnet_matches_jax(runs):
    """Logits and the backbone feature map (features=True)."""
    tree, logits, fmap = runs["resnet"]
    cfg = trn.ResNetConfig(**RN)
    params = trn.params_from_jax(tree, cfg, device="cpu")
    got = trn.forward(params, cfg, torch.from_numpy(_images())).numpy()
    assert got.dtype == np.float32 and rel_err(got, logits) <= TOL
    assert np.array_equal(got.argmax(1), logits.argmax(1))
    got_map = trn.forward(params, cfg, torch.from_numpy(_images()), features=True).numpy()
    assert got_map.shape == fmap.shape == (2, 64, 4, 4) and rel_err(got_map, fmap) <= TOL


def _torchvision_state(cfg, seed=5):
    """A torchvision-named ResNet state dict at the test widths (random
    weights and BatchNorm statistics)."""
    rng = np.random.default_rng(seed)
    state = {}

    def bn(p, c):
        state.update({f"{p}.weight": rng.uniform(0.5, 1.5, c), f"{p}.bias": rng.standard_normal(c) * 0.1,
                      f"{p}.running_mean": rng.standard_normal(c) * 0.1, f"{p}.running_var": rng.uniform(0.5, 2, c)})

    def conv(name, c_out, c_in, k):
        state[name] = rng.standard_normal((c_out, c_in, k, k)) * np.sqrt(2 / (c_in * k * k))

    conv("conv1.weight", cfg.width, 3, 7)
    bn("bn1", cfg.width)
    c_in = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        c_mid = cfg.width * 2 ** si
        c_out = c_mid * 4
        for bi in range(n_blocks):
            p = f"layer{si + 1}.{bi}"
            conv(f"{p}.conv1.weight", c_mid, c_in, 1)
            bn(f"{p}.bn1", c_mid)
            conv(f"{p}.conv2.weight", c_mid, c_mid, 3)
            bn(f"{p}.bn2", c_mid)
            conv(f"{p}.conv3.weight", c_out, c_mid, 1)
            bn(f"{p}.bn3", c_out)
            if bi == 0:
                conv(f"{p}.downsample.0.weight", c_out, c_in, 1)
                bn(f"{p}.downsample.1", c_out)
            c_in = c_out
    state["fc.weight"] = rng.standard_normal((cfg.num_classes, c_in)) * 0.1
    state["fc.bias"] = rng.standard_normal(cfg.num_classes) * 0.1
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def test_load_torchvision_state_dict_matches_jax():
    """BatchNorm folding and layout: every leaf equals the JAX package's
    (torch tensors in, for the port), and the forwards agree."""
    tcfg, jcfg = trn.ResNetConfig(**RN), jrn.ResNetConfig(**RN, dtype=jnp.float32)
    state = _torchvision_state(tcfg)
    tp = trn.load_torchvision_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, tcfg, device="cpu")
    jp = to_numpy(jrn.load_torchvision_state_dict(state, jcfg))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [np.asarray(tree)]

    assert all(np.array_equal(a, b) for a, b in zip(leaves(_numpy(tp)), leaves(jp)))
    got = trn.forward(tp, tcfg, torch.from_numpy(_images())).numpy()
    want = np.asarray(jrn.forward(to_jax(jp), jcfg, jnp.asarray(_images())))
    assert rel_err(got, want) <= TOL


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def test_ieee_helper_ignores_tf32_flags():
    """The helper switches both TF32 flags off for its call and gives the
    caller's back, whatever they were, and cuDNN stays enabled; the result
    equals plain F.conv2d's on the CPU."""
    x, w = torch.randn(1, 3, 8, 8), torch.randn(4, 3, 3, 3)
    cudnn, cublas = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, cublas.allow_tf32, cudnn.enabled
    seen = []
    real = torch.nn.functional.conv2d
    try:
        for flags in ((True, True), (False, True), (True, False)):
            cudnn.allow_tf32, cublas.allow_tf32 = flags
            torch.nn.functional.conv2d = lambda *a, **k: (seen.append((cudnn.allow_tf32, cublas.allow_tf32,
                                                                        cudnn.enabled)), real(*a, **k))[1]
            got = ieee.conv2d(x, w, padding=1)
            torch.nn.functional.conv2d = real
            assert (cudnn.allow_tf32, cublas.allow_tf32) == flags
            assert torch.equal(got, real(x, w, padding=1))
    finally:
        torch.nn.functional.conv2d = real
        cudnn.allow_tf32, cublas.allow_tf32, cudnn.enabled = saved
    assert seen == [(False, False, saved[2])] * 3


def test_image_io_matches_jax(tmp_path):
    """normalize_image, the layout helpers and a PNG round trip equal the
    JAX package's."""
    rng = np.random.default_rng(8)
    hwc = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    chw = timage.hwc_to_chw(hwc)
    assert np.array_equal(chw, jimage.hwc_to_chw(hwc)) and np.array_equal(timage.chw_to_hwc(chw), hwc)
    assert np.array_equal(timage.hwc_to_chw(hwc[..., 0]), jimage.hwc_to_chw(hwc[..., 0]))
    assert np.array_equal(timage.normalize_image(chw), jimage.normalize_image(chw))
    assert np.array_equal(timage.IMAGENET_MEAN, jimage.IMAGENET_MEAN)
    assert np.array_equal(timage.IMAGENET_STD, jimage.IMAGENET_STD)
    pytest.importorskip("PIL")
    timage.write_image(str(tmp_path / "t.png"), chw)
    jimage.write_image(str(tmp_path / "j.png"), chw)
    assert np.array_equal(timage.read_image(str(tmp_path / "t.png")), jimage.read_image(str(tmp_path / "j.png")))
    assert np.abs(timage.read_image(str(tmp_path / "t.png")) - chw).max() <= 0.5 / 255 + 1e-6


def test_presets_match_jax():
    for t, j in ((tvit.VIT_BASE, jvit.VIT_BASE), (tvit.VIT_TINY, jvit.VIT_TINY)):
        assert (t.image_size, t.patch_size, t.n_layers, t.n_heads, t.d_model, t.d_ff, t.n_classes, t.layer_norm_eps) \
            == (j.image_size, j.patch_size, j.n_layers, j.n_heads, j.d_model, j.d_ff, j.n_classes, j.layer_norm_eps)
    for t, j in ((tmb.MOBILENET_V2, jmb.MOBILENET_V2), (tmb.MOBILENET_TINY, jmb.MOBILENET_TINY)):
        assert (t.blocks, t.stem_channels, t.last_channels, t.num_classes, t.width_mult) \
            == (j.blocks, j.stem_channels, j.last_channels, j.num_classes, j.width_mult)
    for t, j in ((trn.RESNET18, jrn.RESNET18), (trn.RESNET50, jrn.RESNET50)):
        assert (t.block, t.stage_sizes, t.num_classes, t.width) == (j.block, j.stage_sizes, j.num_classes, j.width)
