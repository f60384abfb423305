"""ctypes bindings for librten_native.so, the port's own copy of the JAX
package's native host library (``rten_tpu/native/bindings.py``), built from
``rten_native.cpp`` by ``rten_tpu_torch.native.build``. The signatures are
the same. The callers' Python paths run only where ``available()`` is false
(no C++ compiler); an error of a built library propagates."""

from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.cache
def load_library(auto_build: bool = True):
    """Load the library, building it on first use; None where there is no
    C++ compiler (or, without ``auto_build``, no library built yet)."""
    from rten_tpu_torch.native import build

    path = build.build() if auto_build else build.lib_path()
    if path is None or not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_new.argtypes = [ctypes.c_int32] + [ctypes.POINTER(ctypes.c_int32)] * 4
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_apply.restype = ctypes.c_int32
    lib.bpe_apply.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ctc_beam_search.restype = ctypes.c_int32
    lib.ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.find_contours.restype = ctypes.c_int32
    lib.find_contours.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    return lib


def available() -> bool:
    return load_library() is not None


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeBpe:
    """Handle to a C++-side merge table; apply() runs the merge loop."""

    def __init__(self, left: np.ndarray, right: np.ndarray, merged: np.ndarray,
                 ranks: np.ndarray):
        self._lib = load_library()
        assert self._lib is not None
        left = np.ascontiguousarray(left, np.int32)
        right = np.ascontiguousarray(right, np.int32)
        merged = np.ascontiguousarray(merged, np.int32)
        ranks = np.ascontiguousarray(ranks, np.int32)
        self._handle = self._lib.bpe_new(
            len(left), _i32p(left), _i32p(right), _i32p(merged), _i32p(ranks)
        )

    def apply(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int32)
        out = np.empty_like(ids)
        n = self._lib.bpe_apply(self._handle, _i32p(ids), len(ids), _i32p(out))
        return out[:n]

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.bpe_free(self._handle)


def bpe_apply_native(bpe: "NativeBpe", ids) -> np.ndarray:
    return bpe.apply(np.asarray(ids, np.int32))


def ctc_beam_search_native(log_probs: np.ndarray, beam_size: int, blank: int = 0):
    """Returns (labels, times, score) of the best hypothesis, or None if the
    native lib is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    lp = np.ascontiguousarray(log_probs, np.float32)
    n_steps, n_classes = lp.shape
    out_labels = np.empty(max(n_steps, 1), np.int32)
    out_times = np.empty(max(n_steps, 1), np.int32)
    score = ctypes.c_double(0.0)
    n = lib.ctc_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_steps, n_classes, beam_size, blank,
        _i32p(out_labels), _i32p(out_times), ctypes.byref(score),
    )
    return out_labels[:n].tolist(), out_times[:n].tolist(), score.value


def find_contours_native(mask: np.ndarray):
    """Returns list of [N_i, 2] (y, x) arrays, or None if the native lib is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = m.shape
    cap_points = int(m.size) * 8 + 16
    cap_contours = int(m.size) + 1
    out_points = np.empty(cap_points, np.int32)
    out_sizes = np.empty(cap_contours, np.int32)
    n = lib.find_contours(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        _i32p(out_points), cap_points, _i32p(out_sizes), cap_contours,
    )
    if n < 0:
        raise RuntimeError(f"find_contours: output capacity exceeded on a {h}x{w} mask")
    contours = []
    cursor = 0
    for i in range(n):
        cnt = int(out_sizes[i])
        pts = out_points[cursor : cursor + 2 * cnt].reshape(cnt, 2).copy()
        contours.append(pts)
        cursor += 2 * cnt
    return contours
