"""C++ native host kernels with ctypes bindings: the port's own copy of
``rten_tpu/native`` (the BPE merge loop, the CTC prefix beam search and the
contour tracer; host code, no CUDA).

Built on first use (or ``python -m rten_tpu_torch.native.build``) with g++
into ``rten_tpu_torch/_build/native-<hash>/``. Every caller has a Python
path, which runs only where ``available()`` is false (no C++ compiler);
parity between the two is tested (tests/test_torch_native.py).
"""

from rten_tpu_torch.native.bindings import (
    available,
    bpe_apply_native,
    ctc_beam_search_native,
    find_contours_native,
    load_library,
)

__all__ = [
    "available",
    "load_library",
    "bpe_apply_native",
    "ctc_beam_search_native",
    "find_contours_native",
]
