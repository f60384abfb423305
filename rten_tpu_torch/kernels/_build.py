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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The leading arguments of the four KV-attention entry points (kv_attention.cuh).
_KV_OPERANDS = [
    _P, _P, _P,                      # q, k_new, v_new
    _L, _L, _L,                      # their row strides (elements)
    _I, _I, _I, _I, _I,              # bf16, b, hq, hk, d
]
# argtypes of every C entry point (pointers and the stream as c_void_p, or
# ctypes would pass a 32-bit int and cut them).
SIGNATURES = {
    "rt_quant_gemv": [
        _P, _I, _I,                  # x, x_bf16, m
        _P, _P, _I, _I, _I,          # w_t, scales, n, k, w8a8
        _P, _P, _P, _I, _F,          # bias, norm_scale, norm_bias, norm, eps
        _I, _P, _P, _I,              # act, residual, out, out_bf16
        _I, _P,                      # argmax_n, argmax_out
        _P, _P, _P,                  # plan (quant_matmul.py gemv_plan), work buffer, stream
    ],
    "rt_quant_mlp": [
        _P, _I, _I, _I,              # x, bf16, m, d
        _P, _P, _P, _I,              # w_up_t, s_up, b_up, ff
        _P, _P, _P,                  # w_down_t, s_down, b_down
        _P, _P, _I, _F, _I,          # ln scale, ln bias, norm, eps, act
        _P, _P, _P, _P,              # residual, out, up_buf, h_buf
        _P, _P, _P, _I, _P, _P, _P,  # w_qkv_t, s_qkv, b_qkv, nq, next ln scale, next ln bias, qkv_out
        _I, _P, _P, _P,              # w8a8, plan, work buffer, stream
    ],
    "rt_decode_attention": [
        *_KV_OPERANDS,
        _P, _P, _I, _P,              # k_cache, v_cache, s_max, kv_len
        _P, _I,                      # attn, split (attention.py kv_plan)
        _P, _P, _P, _I,              # wo_t, wo_scales, wo_bias, dm
        _P, _P, _F,                  # residual, out, sm_scale
        _P, _P, _P,                  # wo plan (quant_matmul.py gemv_plan), work buffer, stream
    ],
    "rt_decode_attention_clusters": [_I, _I, _I, _I, _I],  # bf16, d, gqa, with_wo, split
    "rt_decode_block": [
        _P, _P, _P, _I, _I, _I, _I,  # q, k_new, v_new, bf16, hq, hk, d
        _P, _P, _I, _P,              # k_cache, v_cache, s_max, kv_len
        _P, _I,                      # part (the items' states), n_chunks
        _P, _P, _P, _I,              # wo_t, wo_scales, wo_bias, dm
        _P, _P,                      # residual, h_buf
        _P, _P, _P, _I, _P,          # w_up_t, s_up, b_up, ff, u_buf
        _P, _P, _P,                  # w_down_t, s_down, b_down
        _P, _P, _I, _F, _I,          # ln2 scale, ln2 bias, norm, eps, act
        _P, _P,                      # out, out_f32
        _P, _P, _P, _I,              # w_qkv_t, s_qkv, b_qkv, nq
        _P, _P, _P,                  # next ln scale, next ln bias, qkv_out
        _F, _I, _I, _P, _P,          # sm_scale, grid, weight region bytes (0: all that fit), stamps (null but in decode_block_timed), stream
    ],
    "rt_matmul_fused": [
        _P, _P, _P, _I,              # x, w, bias, route (matmul.py ROUTES)
        _I, _I, _I,                  # m, n, k
        _I, _P, _I, _I, _I,          # act, out, out_bf16, bn, split (matmul.py fused_plan)
        _P,                          # stream
    ],
    "rt_matmul_fused_clusters": [_I, _I, _I],  # route, bn, split
    "rt_quant_matmul": [
        _P, _I, _I, _I,              # x, x_bf16, m, k
        _P, _P, _P, _I,              # w_t, scales, bias, n
        _I, _P, _I,                  # act, out, out_bf16
        _I, _I,                      # tok, split (quant_matmul.py matmul_plan)
        _P,                          # stream
    ],
    "rt_quant_matmul_clusters": [_I, _I],  # tok, split
    "rt_quantize_rows": [
        _P, _I, _I, _I,              # x, x_bf16, m, k
        _P, _P, _P,                  # codes, sx, stream
    ],
    "rt_quant_matmul_w8a8": [
        _P, _P, _I, _I,              # codes, sx, m, k
        _P, _P, _P, _I,              # w_t, scales, bias, n
        _I, _P, _I,                  # act, out, out_bf16
        _I, _I, _I,                  # tok, ch, split (quant_matmul.py w8a8_plan)
        _P,                          # stream
    ],
    "rt_quant_matmul_w8a8_clusters": [_I, _I, _I],  # tok, ch, split
    "rt_quant_matmul_w8a8_fused": [
        _P, _I, _I, _I,              # x, x_bf16, m, k
        _P, _P, _P, _I,              # w_t, scales, bias, n
        _I, _P, _I,                  # act, out, out_bf16
        _I, _I, _I,                  # tok, ch, split (quant_matmul.py w8a8_plan)
        _I, _I,                      # stages, slots (quant_matmul.py w8a8_layout)
        _P,                          # stream
    ],
    "rt_quant_matmul_w8a8_fused_clusters": [_I, _I, _I, _I],  # tok, ch, split, smem
    "rt_quant_matmul_w8a8_fused_smem": [_I, _I, _I, _I, _I],  # tok, ch, stages, slots, x_bf16
    "rt_flash_attention": [
        _P, _L, _L, _L,              # q and its batch, head, position strides
        _P, _L, _L, _L,              # k ...
        _P, _L, _L, _L,              # v ...
        _P, _L, _L, _L,              # out ...
        _P, _P,                      # q_offset, kv_len
        _I, _I, _I, _I, _I, _I, _I,  # bf16, b, hq, hk, tq, s, d
        _I, _F, _I,                  # causal, sm_scale, split (attention.py flash_plan)
        _P,                          # stream
    ],
    "rt_paged_attention": [
        *_KV_OPERANDS,
        _P, _P, _I, _I,              # k_pages, v_pages, n_pages, page
        _P, _I, _P,                  # table, max_pages, kv_len
        _I, _P, _F, _P,              # split, out, sm_scale, stream
    ],
    "rt_decode_attention_int8": [
        *_KV_OPERANDS,
        _P, _P, _P, _P, _I, _P,      # k, v, k_scale, v_scale, s_max, kv_len
        _I, _P, _F, _P,              # split, out, sm_scale, stream
    ],
    "rt_paged_attention_int8": [
        *_KV_OPERANDS,
        _P, _P, _P, _P, _I, _I,      # k_pages, v_pages, k_scale_pages, v_scale_pages, n_pages, page
        _P, _I, _P,                  # table, max_pages, kv_len
        _I, _P, _F, _P,              # split, out, sm_scale, stream
    ],
    # The three entries' cluster capacity: bf16, d, gqa, split.
    "rt_paged_attention_clusters": [_I, _I, _I, _I],
    "rt_decode_attention_int8_clusters": [_I, _I, _I, _I],
    "rt_paged_attention_int8_clusters": [_I, _I, _I, _I],
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
