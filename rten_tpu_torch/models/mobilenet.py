"""MobileNetV2-class CNN with INT8 pointwise convolutions, on PyTorch and
CUDA.

Counterpart of ``rten_tpu/models/mobilenet.py`` (BASELINE's "MobileNet +
DistilBERT INT8"), its TPU branch: the stem and the depthwise 3x3
convolutions as ``ieee.conv2d`` (BatchNorm folded into a bias, ReLU6), and
every pointwise (1x1) convolution as a ``[N·H·W, C_in] @ [C_in, C_out]``
matmul: once ``quantize_params_int8`` made it an int8 pack, through
``quant_matmul_int8`` (its output rounded to the model dtype, then the bias
added and ReLU6 taken, as the JAX ``_pointwise`` does), else through
``ieee.matmul``. The JAX rule quantizes a pointwise convolution whenever
both of its dims are multiples of 8, so MobileNetV2 has two expand
convolutions of K 24; the kernel takes them (``quant_matmul.cu`` brings
such weight rows in 8-byte cp.async pieces).

Layout: activations are kept channels-last (``torch.channels_last``) from
the stem on, so that the pointwise operand ``[N·H·W, C]`` is a view and the
matmul's output is the next NHWC activation without a copy; shapes stay
NCHW, as in the JAX package, and so do the results.

``predict`` (the JAX package's jitted ``forward``) is ``forward`` under
``torch.inference_mode()``. Entry points that make tensors
default to ``device="cuda"``; ``device="cpu"`` runs the kernels' plain
versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.kernels.quant_matmul import int8_pack, quant_matmul_int8, quantize_weights_int8
from rten_tpu_torch.models import decoder
from rten_tpu_torch.models.ieee import conv2d, matmul


@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    """The JAX package's ``MobileNetConfig`` (``mobilenet.py:27``):
    MobileNetV2's table 2 by default, each block row (expansion t, out
    channels c, repeats n, stride s)."""

    blocks: tuple = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                     (6, 320, 1, 1))
    stem_channels: int = 32
    last_channels: int = 1280
    num_classes: int = 1000
    width_mult: float = 1.0
    dtype: torch.dtype = torch.float32


MOBILENET_V2 = MobileNetConfig()
MOBILENET_TINY = MobileNetConfig(blocks=((1, 8, 1, 1), (4, 12, 2, 2), (4, 16, 2, 2)), stem_channels=8,
                                 last_channels=64, num_classes=10)

_DENSE = ("stem_w", "expand_w", "dw_w", "project_w", "head_w", "fc_w")


def _c(ch: int, mult: float) -> int:
    return max(8, int(ch * mult + 4) // 8 * 8)


def block_layout(cfg: MobileNetConfig) -> list[tuple[int, int, int, int, bool]]:
    """Each block's (cin, cout, hidden, stride, has_expand)."""
    layout = []
    cin = _c(cfg.stem_channels, cfg.width_mult)
    for t, c, n, s in cfg.blocks:
        cout = _c(c, cfg.width_mult)
        for i in range(n):
            layout.append((cin, cout, cin * t, s if i == 0 else 1, t != 1))
            cin = cout
    return layout


def init_params(seed: int, cfg: MobileNetConfig = MOBILENET_V2, device="cuda") -> dict:
    """Random params from a numpy seed in the JAX package's tree
    (``init_params``, :77): convolutions ``[out, in, kh, kw]`` at std 0.1,
    the classifier ``[C, classes]`` at 0.05, zero biases, in ``cfg.dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def dense(*shape, scale=0.1):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)).to(dev, cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    stem_c = _c(cfg.stem_channels, cfg.width_mult)
    params = {"stem_w": dense(stem_c, 3, 3, 3), "stem_b": zeros(stem_c), "blocks": []}
    for cin, cout, hidden, _stride, expand in block_layout(cfg):
        block = {}
        if expand:
            block["expand_w"], block["expand_b"] = dense(hidden, cin, 1, 1), zeros(hidden)
        block["dw_w"], block["dw_b"] = dense(hidden, 1, 3, 3), zeros(hidden)
        block["project_w"], block["project_b"] = dense(cout, hidden, 1, 1), zeros(cout)
        params["blocks"].append(block)
    last_c = _c(cfg.last_channels, max(1.0, cfg.width_mult))
    params["head_w"], params["head_b"] = dense(last_c, block_layout(cfg)[-1][1], 1, 1), zeros(last_c)
    params["fc_w"], params["fc_b"] = dense(last_c, cfg.num_classes, scale=0.05), zeros(cfg.num_classes)
    return params


def quantize_params_int8(params: dict, device="cuda") -> dict:
    """INT8 weight-only by the JAX package's rule (``quantize_params_int8``,
    :115): each block's expand and project convolutions whose K and N are
    both multiples of 8, and the head convolution, become ``int8_pack``s of
    their ``[C_in, C_out]`` matrix quantized per output channel; the stem,
    the depthwise convolutions and the classifier stay dense."""
    dev = resolve_device(device)

    def pack(w):
        mat = decoder._np_f32(w)[:, :, 0, 0].T
        return int8_pack(*quantize_weights_int8(mat, axis=-1), device=dev)

    out = {k: v.to(dev) for k, v in params.items() if k != "blocks"}
    out["blocks"] = []
    for block in params["blocks"]:
        b2 = {k: v if isinstance(v, dict) else v.to(dev) for k, v in block.items()}
        for name in ("expand_w", "project_w"):
            w = b2.get(name)
            if w is not None and not isinstance(w, dict) and w.shape[0] % 8 == 0 and w.shape[1] % 8 == 0:
                b2[name] = pack(w)
        out["blocks"].append(b2)
    out["head_w"] = pack(params["head_w"])
    return out


def params_from_jax(tree: dict, cfg: MobileNetConfig, device="cuda") -> dict:
    """Carry a JAX package params tree across: ``{"q", "s"}`` packs as
    ``int8_pack``s, convolutions and the classifier in their shapes in
    ``cfg.dtype``, biases ``[N]`` (f32 in a quantized tree)."""
    return decoder.carry_tree(tree, cfg.dtype, _DENSE, resolve_device(device))


def _pointwise(x, w, b, *, relu6: bool):
    """A 1x1 convolution of the channels-last x [N, C, H, W] as a channel
    matmul, then ``+ b`` in x.dtype and ReLU6: [N, C', H, W], channels-last."""
    n, c, hgt, wid = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(n * hgt * wid, c)  # a view of channels-last x
    if isinstance(w, dict):
        y = quant_matmul_int8(rows, w["qt"], w["s"])
    else:
        y = matmul(rows, w[:, :, 0, 0].t().to(x.dtype))
    y = y + b.to(y.dtype)
    if relu6:
        y = torch.clamp(y, 0.0, 6.0)
    return y.view(n, hgt, wid, -1).permute(0, 3, 1, 2).to(x.dtype)


def _conv_relu6(x, w, b, stride: int, groups: int = 1):
    """A 3x3 convolution (padding 1) in IEEE f32 for f32 x, + b, ReLU6."""
    y = conv2d(x, w.to(x.dtype), stride=stride, padding=1, groups=groups)
    return torch.clamp(y + b.to(y.dtype)[None, :, None, None], 0.0, 6.0)


def forward(params: dict, cfg: MobileNetConfig, images) -> torch.Tensor:
    """Logits [N, num_classes] in f32 of normalized images [N, 3, H, W], on
    their device."""
    x = images.to(cfg.dtype).contiguous(memory_format=torch.channels_last)
    x = _conv_relu6(x, params["stem_w"], params["stem_b"], 2)
    for block, (cin, cout, _hidden, stride, expand) in zip(params["blocks"], block_layout(cfg)):
        y = x
        if expand:
            y = _pointwise(y, block["expand_w"], block["expand_b"], relu6=True)
        y = _conv_relu6(y, block["dw_w"], block["dw_b"], stride, groups=y.shape[1])
        y = _pointwise(y, block["project_w"], block["project_b"], relu6=False)
        x = y + x if stride == 1 and cin == cout else y
    x = _pointwise(x, params["head_w"], params["head_b"], relu6=True)
    x = x.mean((2, 3))  # global average pool
    return (matmul(x, params["fc_w"].to(x.dtype)) + params["fc_b"].to(x.dtype)).float()


@torch.inference_mode()
def predict(params: dict, cfg: MobileNetConfig, images) -> torch.Tensor:
    """``forward`` under ``torch.inference_mode()`` (the JAX package's
    ``predict``, ``rten_tpu/models/mobilenet.py:202``)."""
    return forward(params, cfg, images)
