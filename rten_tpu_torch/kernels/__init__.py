"""Hand-written CUDA kernels of the prefill and decode paths, each beside its
plain PyTorch version: ``quant_matmul`` (``quant_gemv_int8`` and
``quant_mlp_int8``, each weight-only or W8A8, ``quant_matmul_int8``,
``quant_matmul_w8a8`` with ``quantize_rows_int8``), ``decode_attention``
(``decode_attention``, ``decode_attention_int8``), ``paged_attention``
(``paged_decode_attention``, ``paged_decode_attention_int8``) and
``attention`` (``flash_attention``). ``dispatch`` holds the device rule and
the launch counters; ``_build`` compiles ``csrc/`` with ``nvcc`` on first
use."""
