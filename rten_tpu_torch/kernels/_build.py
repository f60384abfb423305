"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into
``librten_torch_kernels.so``. The library lands in ``rten_tpu_torch/_build/
<hash>/``, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing is built when the
package is imported: the first kernel launch builds, and a machine without
``nvcc`` raises there.

Each C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "librten_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point (pointers and the stream as c_void_p, or
# ctypes would pass a 32-bit int and cut them).
SIGNATURES = {
    "rt_max_blocks": [],
    "rt_quant_gemv": [
        _P, _I, _I,                  # x, x_bf16, m
        _P, _P, _I, _I,              # w_t, scales, n, k
        _P, _P, _P, _I, _F,          # bias, norm_scale, norm_bias, norm, eps
        _I, _P, _P, _I,              # act, residual, out, out_bf16
        _I, _P, _P, _P,              # argmax_n, part_max, part_idx, argmax_out
        _P,                          # stream
    ],
    "rt_quant_mlp": [
        _P, _I, _I, _I,              # x, bf16, m, d
        _P, _P, _P, _I,              # w_up_t, s_up, b_up, ff
        _P, _P, _P,                  # w_down_t, s_down, b_down
        _P, _P, _I, _F, _I,          # ln scale, ln bias, norm, eps, act
        _P, _P, _P, _P,              # residual, out, up_buf, h_buf
        _P, _P, _P, _I, _P, _P, _P,  # w_qkv_t, s_qkv, b_qkv, nq, next ln scale, next ln bias, qkv_out
        _P,                          # stream
    ],
    "rt_decode_attention": [
        _P, _I, _I, _I, _I,          # qkv, bf16, b, h, d
        _P, _P, _I, _P,              # k_cache, v_cache, s_max, kv_len
        _P, _P, _P, _P, _I,          # part_m, part_l, part_acc, attn, n_chunks
        _P, _P, _P, _I,              # wo_t, wo_scales, wo_bias, dm
        _P, _P, _F,                  # residual, out, sm_scale
        _P,                          # stream
    ],
}

_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None  # wall time of the build this process ran (None: loaded)


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "kernels are compiled on first use on a machine with the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path."""
    global BUILD_SECONDS
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    tmp = BUILD_ROOT / f"{out_dir.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    exe = nvcc()
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        log = open(tmp / (src.stem + ".log"), "w")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, _obj, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((src.name, (tmp / (src.stem + ".log")).read_text()))
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"--- {name}\n{text}" for name, text in failed)
        )
    link = [exe, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME)]
    link += [str(obj) for _src, obj, _log, _proc in procs]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
    try:
        os.replace(tmp, out_dir)
    except OSError:
        # Another process finished the same build first; use its library.
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of every kernel) from the build of the current sources."""
    out_dir = BUILD_ROOT / source_hash()
    return "\n".join(p.read_text() for p in sorted(out_dir.glob("*.log")))


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        text = library().rt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({text}) at launch")
