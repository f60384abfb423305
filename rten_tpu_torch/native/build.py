"""Build the native libraries: ``python -m rten_tpu_torch.native.build``.

``g++ -O2 -std=c++17 -shared -fPIC`` compiles ``rten_native.cpp`` into
``rten_tpu_torch/_build/native-<hash>/librten_native.so``, keyed by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one loads at once. ``build_embed`` compiles the C embedding API
(``embed_api.cpp``) against the running CPython's headers and
``libpython`` into ``rten_tpu_torch/_build/embed-<hash>/librten_embed.so``,
keyed by the source, the flags and the Python version. Nothing is written
into the package's sources. A library is compiled to a temporary name in
its directory and moved into place with ``os.replace``, so a process that
builds beside another one never loads a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "rten_native.cpp"
EMBED_SRC = Path(__file__).resolve().parent / "embed_api.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "librten_native.so"
EMBED_NAME = "librten_embed.so"
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


def _compile(cxx: str, out: Path, args: list[str]) -> Path:
    """``cxx args -o <temporary name>``, then the file moved to ``out``; a
    failed compile raises."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    res = subprocess.run([cxx, "-o", str(tmp), *args], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{out.name} build failed ({cxx} exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def build(force: bool = False) -> Path | None:
    """The library's path, compiled first if this hash has none (or with
    ``force``); None when there is no compiler. A failed compile raises."""
    out = lib_path()
    if out.exists() and not force:
        return out
    cxx = compiler()
    if cxx is None:
        return None
    return _compile(cxx, out, [*FLAGS, str(SRC)])


def embed_flags() -> list[str]:
    """The embedding API's compile and link flags: the running CPython's
    headers and ``libpython<LDVERSION>`` from its ``LIBDIR``, found again at
    run time through the rpath."""
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    return [*FLAGS, f"-I{inc}", f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}"]


def embed_lib_path() -> Path:
    h = hashlib.sha256(EMBED_SRC.read_bytes())
    h.update(" ".join(embed_flags()).encode())
    h.update(sys.version.encode())
    return BUILD_ROOT / f"embed-{h.hexdigest()[:16]}" / EMBED_NAME


def build_embed(force: bool = False) -> Path | None:
    """``librten_embed.so`` (the in-process C embedding API, the reference's
    wasm_api analog), compiled first if this hash has none (or with
    ``force``); None when there is no compiler or no ``Python.h``. A failed
    compile raises."""
    import sysconfig

    out = embed_lib_path()
    if out.exists() and not force:
        return out
    cxx = compiler()
    if cxx is None or not (Path(sysconfig.get_paths()["include"]) / "Python.h").exists():
        return None
    return _compile(cxx, out, [*FLAGS, str(EMBED_SRC), *embed_flags()[len(FLAGS):]])


if __name__ == "__main__":
    path = build(force=True)
    if path is None:
        sys.exit("no C++ compiler (g++) on PATH")
    print(f"built {path}")
    epath = build_embed(force=True)
    if epath is None:
        sys.exit("no Python.h for the embedding API")
    print(f"built {epath}")
