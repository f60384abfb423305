"""The port's image apps (rten_tpu_torch.examples: imagenet, yolo, deeplab,
detr, depth_anything, segment_anything, trocr, distilvit) on the CPU
against the JAX package's (examples/) on the same files: PNGs, .rten
graphs (the JAX package's tests' builders, written by the port's writer,
whose bytes are the JAX writer's) and a torchvision-named ResNet-18 .npz.
Printed lines equal (numbers within 1e-4 relative / 1e-5 absolute), written
PNGs equal but for at most 0.1% of pixels off by one code. Also: the apps'
own functions against the JAX ones (trocr's ``_square_cfg`` and
``_encode_patches``, detr's ``_block``, ``common.resize_bilinear`` against
``jax.image.resize``), and every ported app's ``--demo --cpu`` at the JAX
demos' widths (``chip_smoke.DEMO_FLAGS``: the 13 of this file's kind,
gpt2.py with and without ``--int8`` and bert_qa.py)."""

import numpy as np
import pytest
import torch
from torch_app_helpers import check_port_app, jax_app, jax_runs, port_app, run

import chip_smoke

APPS = ("imagenet", "yolo", "deeplab", "detr", "depth_anything", "segment_anything", "trocr", "distilvit")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return chip_smoke.write_app_files(tmp_path_factory.mktemp("vision_files"))


@pytest.fixture(scope="module")
def jax_lines(files, tmp_path_factory):
    return jax_runs(APPS, files, tmp_path_factory.mktemp("vision_jax"))


@pytest.mark.parametrize("name", APPS)
def test_app_matches_jax(name, files, jax_lines, tmp_path):
    res = check_port_app(name, files, jax_lines[name], tmp_path)
    assert res  # the port app filled its result


def test_square_cfg_and_encode_patches_match_jax():
    """trocr.py's rectangular ViT encode on the same line image and params
    (carried across by ``vit.params_from_jax``): the same fabricated
    square config, hidden states within 1e-5."""
    import jax
    import jax.numpy as jnp

    from rten_tpu.models import vit as jvit
    from rten_tpu_torch.models import vit

    jtrocr, trocr = jax_app("trocr"), port_app("trocr")
    line = np.random.default_rng(0).random((3, 16, 64)).astype(np.float32)
    jcfg = jvit.ViTConfig(image_size=None, patch_size=8, n_layers=2, n_heads=2, d_model=64, d_ff=128,
                          use_cls_token=False)
    cfg = vit.ViTConfig(image_size=None, patch_size=8, n_layers=2, n_heads=2, d_model=64, d_ff=128,
                        use_cls_token=False)
    jpatches = jvit.patchify(jnp.asarray(line[None]), 8)
    patches = vit.patchify(torch.from_numpy(line[None]), 8)
    jsq, sq = jtrocr._square_cfg(jcfg, jpatches), trocr._square_cfg(cfg, patches)
    assert sq.image_size == jsq.image_size == 32 and sq.n_patches == jsq.n_patches == 16
    jparams = jvit.init_params(jax.random.PRNGKey(0), jsq)
    want = np.asarray(jtrocr._encode_patches(jparams, jcfg, jpatches))
    got = trocr._encode_patches(vit.params_from_jax(jparams, sq, device="cpu"), cfg, patches).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_detr_block_matches_jax():
    """detr.py's encoder block (pre-LN, tanh GELU) on the same input and
    ViT layer params: within 1e-5."""
    import jax

    from rten_tpu.models import vit as jvit
    from rten_tpu_torch.models import vit

    jdetr, detr = jax_app("detr"), port_app("detr")
    kw = dict(image_size=32, patch_size=8, n_layers=1, n_heads=2, d_model=16, d_ff=64, use_cls_token=False)
    jcfg, cfg = jvit.ViTConfig(**kw), vit.ViTConfig(**kw)
    jparams = jvit.init_params(jax.random.PRNGKey(1), jcfg)
    for layer in jparams["layers"]:  # non-trivial norms and biases
        for k in ("bqkv", "bo", "b_up", "b_down"):
            layer[k] = jax.random.normal(jax.random.PRNGKey(len(k)), layer[k].shape) * 0.1
    x = np.random.default_rng(1).standard_normal((1, 16, 16)).astype(np.float32)
    want = np.asarray(jdetr._block(x, jparams["layers"][0], jcfg))
    got = detr._block(torch.from_numpy(x), vit.params_from_jax(jparams, cfg, device="cpu")["layers"][0], cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((3, 97, 131), (64, 64)), ((1, 6, 16, 16), (64, 64)), ((1, 32, 32), (32, 32))],
                         ids=["shrink", "grow", "equal"])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    import jax

    from rten_tpu_torch.examples import common

    x = np.random.default_rng(2).random(src).astype(np.float32)
    want = np.asarray(jax.image.resize(x, src[:-2] + dst, "bilinear"))
    got = common.resize_bilinear(x, dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(chip_smoke.DEMO_FLAGS))
def test_demo_on_cpu_exits_0(name):
    """Each ported app's --demo (seeded weights, the JAX package's
    tests/test_examples.py flags) runs on the CPU."""
    rc, lines = run(port_app(name.split(":")[0]).main, ["--demo", "--cpu", *chip_smoke.DEMO_FLAGS[name]])
    assert rc == 0 and lines
