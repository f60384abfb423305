"""Build the native host library: ``python -m rten_tpu_torch.native.build``.

``g++ -O2 -std=c++17 -shared -fPIC`` compiles ``rten_native.cpp`` into
``rten_tpu_torch/_build/native-<hash>/librten_native.so``, keyed by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one loads at once. Nothing is written into the package's sources. The
library is compiled to a temporary name in that directory and moved into
place with ``os.replace``, so a process that builds beside another one
never loads a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "rten_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "librten_native.so"
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def compiler() -> str | None:
    """The C++ compiler, or None on a machine without one."""
    return shutil.which("g++")


def source_hash() -> str:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_ROOT / f"native-{source_hash()}" / LIB_NAME


def build(force: bool = False) -> Path | None:
    """The library's path, compiled first if this hash has none (or with
    ``force``); None when there is no compiler. A failed compile raises."""
    out = lib_path()
    if out.exists() and not force:
        return out
    cxx = compiler()
    if cxx is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.tmp{os.getpid()}")
    res = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({cxx} exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    path = build(force=True)
    if path is None:
        sys.exit("no C++ compiler (g++) on PATH")
    print(f"built {path}")
