"""ResNet image classifiers (ResNet-18 / ResNet-50) on PyTorch and CUDA.

Counterpart of ``rten_tpu/models/resnet.py`` (BASELINE's "ResNet-50 fp32
image classification"): NCHW, every convolution ``ieee.conv2d`` with
symmetric ``k // 2`` padding (IEEE f32 for f32 activations, as the JAX
package's ``Precision.HIGHEST``), inference BatchNorm as a per-channel
scale and shift (folded from the running statistics at import), ReLU,
3x3 / 2 max pooling, global average pooling and a dense classifier. The
JAX module writes no Pallas kernel, so neither does this one: its time is
cuDNN's and cuBLAS's.

``forward(..., features=True)`` returns the last stage's feature map
(backbone mode). ``load_torchvision_state_dict`` reads torchvision's
``resnet18`` / ``resnet50`` weights with the BatchNorms folded.
``predict`` (the JAX package's jitted ``forward``) is ``forward`` under
``torch.inference_mode()``. Entry points that make tensors
default to ``device="cuda"``; ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import decoder
from rten_tpu_torch.models.ieee import conv2d, matmul


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """The JAX package's ``ResNetConfig`` (``resnet.py:22``), ResNet-50 by
    default."""

    block: str = "bottleneck"  # "basic" | "bottleneck"
    stage_sizes: tuple = (3, 4, 6, 3)
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.float32


RESNET18 = ResNetConfig(block="basic", stage_sizes=(2, 2, 2, 2))
RESNET50 = ResNetConfig()

_DENSE = ("conv", "conv1", "conv2", "conv3", "proj", "w")


def init_params(seed: int, cfg: ResNetConfig = RESNET50, device="cuda") -> dict:
    """Random params from a numpy seed in the JAX package's tree
    (``init_params``, :44): He-normal convolutions ``[out, in, k, k]``,
    identity BatchNorms (scale 1, shift 0), a normal 0.01 classifier ``[C,
    classes]``, in ``cfg.dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def conv(c_in, c_out, k):
        std = np.float32(np.sqrt(2.0 / (c_in * k * k)))
        return torch.from_numpy(rng.standard_normal((c_out, c_in, k, k), dtype=np.float32) * std).to(dev, cfg.dtype)

    def bn(c):
        return {"scale": torch.ones(c, dtype=cfg.dtype, device=dev), "shift": torch.zeros(c, dtype=cfg.dtype, device=dev)}

    bottleneck = cfg.block == "bottleneck"
    params = {"stem": {"conv": conv(3, cfg.width, 7), "bn": bn(cfg.width)}, "stages": []}
    c_in = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        c_mid = cfg.width * 2 ** si
        c_out = c_mid * (4 if bottleneck else 1)
        stage = []
        for bi in range(n_blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            if bottleneck:
                block = {"conv1": conv(c_in, c_mid, 1), "bn1": bn(c_mid), "conv2": conv(c_mid, c_mid, 3),
                         "bn2": bn(c_mid), "conv3": conv(c_mid, c_out, 1), "bn3": bn(c_out)}
            else:
                block = {"conv1": conv(c_in, c_mid, 3), "bn1": bn(c_mid), "conv2": conv(c_mid, c_out, 3),
                         "bn2": bn(c_out)}
            if stride != 1 or c_in != c_out:
                block["proj"], block["proj_bn"] = conv(c_in, c_out, 1), bn(c_out)
            stage.append(block)
            c_in = c_out
        params["stages"].append(stage)
    w = rng.standard_normal((c_in, cfg.num_classes), dtype=np.float32) * np.float32(0.01)
    params["fc"] = {"w": torch.from_numpy(w).to(dev, cfg.dtype),
                    "b": torch.zeros(cfg.num_classes, dtype=cfg.dtype, device=dev)}
    return params


def params_from_jax(tree: dict, cfg: ResNetConfig, device="cuda") -> dict:
    """Carry a JAX package params tree across: convolutions and the
    classifier in their shapes, BatchNorm scales and shifts ``[C]``, all in
    ``cfg.dtype``."""
    return decoder.carry_tree(tree, cfg.dtype, _DENSE, resolve_device(device))


def load_torchvision_state_dict(state: dict, cfg: ResNetConfig = RESNET50, dtype=None, device="cuda") -> dict:
    """Port params from torchvision ``resnet50`` / ``resnet18`` weights
    (torch tensors or numpy arrays) with each BatchNorm folded into a
    scale and shift (eps 1e-5; a copy of ``rten_tpu/models/resnet.py:155``)."""
    dev, dtype = resolve_device(device), dtype or cfg.dtype

    def tensor(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(dev, dtype)

    def fold_bn(prefix):
        gamma, beta, mean, var = (decoder._np_f32(state[f"{prefix}.{k}"])
                                  for k in ("weight", "bias", "running_mean", "running_var"))
        scale = gamma / np.sqrt(var + 1e-5)
        return {"scale": tensor(scale), "shift": tensor(beta - mean * scale)}

    def conv(name):
        return tensor(decoder._np_f32(state[name]))

    bottleneck = cfg.block == "bottleneck"
    params = {"stem": {"conv": conv("conv1.weight"), "bn": fold_bn("bn1")}, "stages": []}
    for si, n_blocks in enumerate(cfg.stage_sizes):
        stage = []
        for bi in range(n_blocks):
            p = f"layer{si + 1}.{bi}"
            block = {"conv1": conv(f"{p}.conv1.weight"), "bn1": fold_bn(f"{p}.bn1"),
                     "conv2": conv(f"{p}.conv2.weight"), "bn2": fold_bn(f"{p}.bn2")}
            if bottleneck:
                block["conv3"], block["bn3"] = conv(f"{p}.conv3.weight"), fold_bn(f"{p}.bn3")
            if f"{p}.downsample.0.weight" in state:
                block["proj"], block["proj_bn"] = conv(f"{p}.downsample.0.weight"), fold_bn(f"{p}.downsample.1")
            stage.append(block)
        params["stages"].append(stage)
    params["fc"] = {"w": tensor(decoder._np_f32(state["fc.weight"]).T), "b": conv("fc.bias")}
    return params


def _conv(x, w, stride: int = 1):
    """Convolution with symmetric ``k // 2`` padding (torch's), IEEE f32
    for f32 x."""
    return conv2d(x, w.to(x.dtype), stride=stride, padding=w.shape[-1] // 2)


def _bn(x, p):
    return x * p["scale"].to(x.dtype)[None, :, None, None] + p["shift"].to(x.dtype)[None, :, None, None]


def forward(params: dict, cfg: ResNetConfig, images, *, features: bool = False) -> torch.Tensor:
    """Logits [N, num_classes] in f32 of normalized images [N, 3, H, W],
    on their device; with ``features=True`` the last stage's feature map
    [N, C, h, w] in ``cfg.dtype`` instead."""
    x = torch.relu(_bn(_conv(images.to(cfg.dtype), params["stem"]["conv"], 2), params["stem"]["bn"]))
    x = F.max_pool2d(x, 3, 2, padding=1)  # the JAX reduce_window: -inf padding 1
    bottleneck = cfg.block == "bottleneck"
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            stride = 2 if si > 0 and bi == 0 else 1
            if bottleneck:
                y = torch.relu(_bn(_conv(x, block["conv1"]), block["bn1"]))
                y = torch.relu(_bn(_conv(y, block["conv2"], stride), block["bn2"]))
                y = _bn(_conv(y, block["conv3"]), block["bn3"])
            else:
                y = torch.relu(_bn(_conv(x, block["conv1"], stride), block["bn1"]))
                y = _bn(_conv(y, block["conv2"]), block["bn2"])
            resid = _bn(_conv(x, block["proj"], stride), block["proj_bn"]) if "proj" in block else x
            x = torch.relu(resid + y)
    if features:
        return x
    x = x.mean((2, 3))
    return (matmul(x, params["fc"]["w"].to(x.dtype)) + params["fc"]["b"].to(x.dtype)).float()


@torch.inference_mode()
def predict(params: dict, cfg: ResNetConfig, images) -> torch.Tensor:
    """``forward`` under ``torch.inference_mode()`` (the JAX package's
    ``predict``, ``rten_tpu/models/resnet.py:149``)."""
    return forward(params, cfg, images)
