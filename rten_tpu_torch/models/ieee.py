"""IEEE f32 library calls: the convolutions and dense matmuls that the
models make outside the hand-written kernels.

The JAX package computes these with ``lax.conv_general_dilated`` and
``dispatch.matmul``, plain XLA outside any Pallas kernel, at
``Precision.HIGHEST`` for f32 operands (``rten_tpu/models/resnet.py:97``,
``wav2vec2.py:154``, ``kernels/dispatch.py`` ``precision_for``). Their
counterparts here are ``F.conv1d``, ``F.conv2d`` and ``torch.matmul``. On
a CUDA card PyTorch lets cuDNN round f32 convolution operands to TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), and cuBLAS does the
same for matmuls when a caller sets ``torch.backends.cuda.matmul.allow_tf32``:
about 1e-3 relative error in place of about 1e-6. So every call here runs
with both flags off, whatever the caller set, and restores them after. Only
those two flags change: cuDNN stays enabled, with the caller's benchmark and
determinism settings (``torch.backends.cudnn.flags()`` would default them).
bf16 operands are not affected.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_f32():
    """f32 convolutions and matmuls in IEEE f32 (no TF32) inside the block;
    the caller's flags come back after it."""
    cudnn, cublas = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, cublas.allow_tf32
    cudnn.allow_tf32 = cublas.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, cublas.allow_tf32 = saved


def conv1d(x, w, bias=None, **kw):
    """``F.conv1d`` in IEEE f32 (``ieee_f32``)."""
    with ieee_f32():
        return F.conv1d(x, w, bias, **kw)


def conv2d(x, w, bias=None, **kw):
    """``F.conv2d`` in IEEE f32 (``ieee_f32``)."""
    with ieee_f32():
        return F.conv2d(x, w, bias, **kw)


def matmul(a, b):
    """``a @ b`` in IEEE f32 (``ieee_f32``); in bf16 rounded once to bf16,
    as the JAX package's ``dispatch.matmul``."""
    with ieee_f32():
        return torch.matmul(a, b)
