"""rten_tpu_torch — the PyTorch and CUDA port of rten_tpu for NVIDIA Hopper.

The JAX package ``rten_tpu`` is the reference; this package runs beside it
and imports nothing of it (and never ``jax``). So far it carries the decode
configuration of the main path: GPT-2-class INT8 weight-only greedy decode
over a preallocated KV cache (``models.decoder``, ``generate``), on three
hand-written CUDA kernels for ``sm_90a`` (``kernels``). Entry points run on
the card by default (``device="cuda"``) and run the kernels' plain PyTorch
versions when asked for ``device="cpu"``.
"""

__version__ = "0.1.0"
