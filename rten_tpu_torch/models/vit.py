"""ViT-class vision transformer encoder on PyTorch and CUDA.

Counterpart of ``rten_tpu/models/vit.py`` (the backbone of the DistilViT,
Segment Anything and Depth Anything examples), its TPU branch: the patch
embedding as one matmul over flattened patches (``patchify``), a cls token
and learned positions, pre-LN blocks whose attention is
``flash_attention``, not causal, over every patch, and a final LayerNorm.
The JAX module has no quantizer: every matrix is dense and goes through
``ieee.matmul`` (the JAX ``dispatch.matmul``); LayerNorms run in f32 and
round once; GELU is the exact erf.

Heads: ``encode`` (hidden states [B, 1 + N, D], cls first, or [B, N, D]),
``classify`` (logits from the cls token, or the mean of the patch tokens)
and ``feature_map`` (patch tokens as [B, D, gh, gw] for dense heads).
``classify_jit`` (the JAX package's jitted ``classify``) is ``classify``
under ``torch.inference_mode()``. Entry points that make tensors default to
``device="cuda"``; ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rten_tpu_torch.kernels.attention import flash_attention
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import decoder
from rten_tpu_torch.models.bert import _ln_f, _proj
from rten_tpu_torch.models.encoder_decoder import _gelu, _unheads
from rten_tpu_torch.models.ieee import matmul


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The JAX package's ``ViTConfig`` (``vit.py:31``), ViT-B/16 at 224²
    by default."""

    image_size: int = 224
    patch_size: int = 16
    n_channels: int = 3
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    n_classes: int = 1000
    use_cls_token: bool = True
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def patch_dim(self) -> int:
        return self.n_channels * self.patch_size * self.patch_size


VIT_BASE = ViTConfig()
VIT_TINY = ViTConfig(n_layers=4, n_heads=4, d_model=256, d_ff=1024)

_DENSE = ("patch_w", "pos_emb", "head_w", "cls", "wqkv", "wo", "w_up", "w_down")


def init_params(seed: int, cfg: ViTConfig = VIT_BASE, device="cuda") -> dict:
    """Random params from a numpy seed in the JAX package's tree
    (``init_params``, :67): normal 0.02 matrices ``[in, out]``, positions
    and cls token, zero biases, unit norm scales, in ``cfg.dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff

    def dense(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)).to(dev, cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    def ln():
        return {"scale": torch.ones(d, dtype=cfg.dtype, device=dev), "bias": zeros(d)}

    seq = cfg.n_patches + (1 if cfg.use_cls_token else 0)
    params = {"patch_w": dense(cfg.patch_dim, d), "patch_b": zeros(d), "pos_emb": dense(seq, d),
              "final_ln": ln(), "head_w": dense(d, cfg.n_classes), "head_b": zeros(cfg.n_classes), "layers": []}
    if cfg.use_cls_token:
        params["cls"] = dense(1, 1, d)
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": ln(), "wqkv": dense(d, 3 * d), "bqkv": zeros(3 * d), "wo": dense(d, d), "bo": zeros(d),
            "ln2": ln(), "w_up": dense(d, ff), "b_up": zeros(ff), "w_down": dense(ff, d), "b_down": zeros(d),
        })
    return params


def params_from_jax(tree: dict, cfg: ViTConfig, device="cuda") -> dict:
    """Carry a JAX package params tree across: every leaf a tensor in
    ``cfg.dtype`` (matrices, positions and the cls token in their shapes,
    vectors ``[N]``)."""
    return decoder.carry_tree(tree, cfg.dtype, _DENSE, resolve_device(device))


def patchify(images, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)(W/p), C·p·p]: each non-overlapping patch's
    pixels flattened, channel major (the stride-p convolution as one matmul
    operand)."""
    b, c, hgt, wid = images.shape
    gh, gw = hgt // patch, wid // patch
    x = images.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * patch * patch)


def encode(params: dict, cfg: ViTConfig, images) -> torch.Tensor:
    """Hidden states [B, 1 + N, D] (cls first) or [B, N, D] in
    ``cfg.dtype`` of images [B, C, H, W], on their device."""
    b = images.shape[0]
    x = _proj(patchify(images.to(cfg.dtype), cfg.patch_size), params["patch_w"], params["patch_b"])
    if cfg.use_cls_token:
        x = torch.cat([params["cls"].to(x.dtype).expand(b, 1, cfg.d_model), x], 1)
    x = x + params["pos_emb"].to(x.dtype)[None]
    h, hd, t, eps = cfg.n_heads, cfg.head_dim, x.shape[1], cfg.layer_norm_eps
    x = x.reshape(b * t, -1)  # rows [B·T, D]
    for layer in params["layers"]:
        qkv = _proj(_ln_f(x, layer["ln1"], eps), layer["wqkv"], layer["bqkv"]).view(b, t, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = _unheads(flash_attention(q, k, v, causal=False))
        x = x + matmul(attn, layer["wo"]) + layer["bo"]  # the JAX order: (resid + x W) + b
        up = _proj(_ln_f(x, layer["ln2"], eps), layer["w_up"], layer["b_up"])
        up = _gelu(up, up.dtype)
        x = x + matmul(up, layer["w_down"]) + layer["b_down"]
    return _ln_f(x, params["final_ln"], eps).view(b, t, -1)


def classify(params: dict, cfg: ViTConfig, images) -> torch.Tensor:
    """Logits [B, n_classes] in ``cfg.dtype`` from the cls token (or the
    mean of the patch tokens without one)."""
    hidden = encode(params, cfg, images)
    feat = hidden[:, 0] if cfg.use_cls_token else hidden.mean(1)
    return matmul(feat, params["head_w"].to(feat.dtype)) + params["head_b"].to(feat.dtype)


@torch.inference_mode()
def classify_jit(params: dict, cfg: ViTConfig, images) -> torch.Tensor:
    """``classify`` under ``torch.inference_mode()`` (the JAX package's
    ``classify_jit``, ``rten_tpu/models/vit.py:192``)."""
    return classify(params, cfg, images)


def feature_map(hidden, cfg: ViTConfig) -> torch.Tensor:
    """The patch tokens of ``encode``'s hidden states as a [B, D, gh, gw]
    feature map (depth estimation, segmentation heads)."""
    tokens = hidden[:, 1:] if cfg.use_cls_token else hidden
    b, _, d = tokens.shape
    return tokens.reshape(b, cfg.grid, cfg.grid, d).permute(0, 3, 1, 2)
