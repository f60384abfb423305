"""Epilogue activations shared by the kernels and their plain versions.

Counterpart of ``rten_tpu/kernels/matmul_pallas.py`` ``_erf_poly``,
``_gelu_erf`` and ``_ACTIVATIONS`` (:48-55): none, relu, gelu, and silu,
sigmoid and tanh in f32 (``jax.nn.silu``, ``jax.nn.sigmoid``,
``jnp.tanh``; the CUDA kernels use ``expf`` and ``tanhf``, ``csrc/common.cuh``
``activate``). GELU is the exact (erf, not tanh) form,
with erf from Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7). The CUDA
kernels evaluate the same polynomial (``csrc/common.cuh`` ``erf_poly``), so a
kernel and its plain version differ only by float rounding; the JAX
package's jnp path uses exact erf instead, which differs by at most 1.5e-7
in erf.

``ACTIVATION_CODES`` is the integer each CUDA entry point takes for the
epilogue activation.
"""

from __future__ import annotations

import torch

_A1, _A2, _A3, _A4, _A5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
_P = 0.3275911


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _P * ax)
    y = 1.0 - (((((_A5 * t + _A4) * t) + _A3) * t + _A2) * t + _A1) * t * torch.exp(-ax * ax)
    return sign * y


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_poly(x * 0.7071067811865475))


ACTIVATIONS = {
    None: lambda x: x,
    "relu": torch.relu,
    "gelu": gelu_erf,
    "silu": lambda x: x * torch.sigmoid(x),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

ACTIVATION_CODES = {None: 0, "gelu": 1, "relu": 2, "silu": 3, "sigmoid": 4, "tanh": 5}


def activation_code(name: str | None) -> int:
    if name not in ACTIVATION_CODES:
        raise NotImplementedError(
            f"activation {name!r} has no kernel epilogue (supported: {sorted(map(str, ACTIVATION_CODES))})"
        )
    return ACTIVATION_CODES[name]
