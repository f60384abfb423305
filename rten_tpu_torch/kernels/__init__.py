"""Hand-written CUDA kernels for the decode path, each beside its plain
PyTorch version: ``quant_matmul`` (``quant_gemv_int8``, ``quant_mlp_int8``)
and ``decode_attention``. ``dispatch`` holds the device rule and the launch
counters; ``_build`` compiles ``csrc/`` with ``nvcc`` on first use."""
