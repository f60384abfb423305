"""The port's native host library (rten_tpu_torch/native): it builds from
its own source into rten_tpu_torch/_build/native-<hash>/, and its BPE merge
loop, CTC prefix beam search and contour tracer give the port's Python
paths' results and the JAX package's library's (rten_tpu/native) on seeded
inputs."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from rten_tpu.native import bindings as jnb
from rten_tpu_torch import ctc
from rten_tpu_torch.image import contours
from rten_tpu_torch.native import available, bindings, build
from rten_tpu_torch.text.models import ByteLevelBPE

REPO = Path(__file__).resolve().parent.parent
README = (REPO / "README.md").read_text(encoding="utf-8")


def python_paths(monkeypatch):
    monkeypatch.setattr(bindings, "load_library", lambda auto_build=True: None)


def test_library_builds_into_build_dir():
    path = build.build()
    assert available() and path.exists()
    assert path.parent.parent == REPO / "rten_tpu_torch" / "_build"
    assert path.parent.name == f"native-{build.source_hash()}" and path.name == "librten_native.so"
    assert not list(path.parent.glob("*.tmp*"))
    assert Path(jnb.__file__).parent not in path.parents  # never the JAX package's library


def test_two_processes_build_at_once(tmp_path):
    """Two processes building into one empty directory at the same time
    each load a whole library (each compiles to its own temporary name and
    moves it into place)."""
    child = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from rten_tpu_torch.native import build\n"
        f"build.BUILD_ROOT = Path({str(tmp_path)!r})\n"
        "lib = ctypes.CDLL(str(build.build()))\n"
        "lib.bpe_apply.restype = ctypes.c_int32\n"
        "print('loaded', lib.bpe_new is not None and lib.find_contours is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", child], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "loaded True"
    built = list(tmp_path.glob("native-*/*"))
    assert [p.name for p in built] == ["librten_native.so"]


def _bpe_pair():
    merges = chip_smoke.train_bpe(README, 400)
    spec = chip_smoke.bpe_tokenizer_spec(merges)["model"]
    return spec["vocab"], spec["merges"]


@pytest.mark.parametrize("seed", range(3))
def test_bpe_native_matches_python_and_jax(monkeypatch, seed):
    """Seeded words of README's byte units (and units no merge names)
    through the port's native merge loop, its Python loop and the JAX
    package's ByteLevelBPE with its library."""
    from rten_tpu.text.models import ByteLevelBPE as JaxBPE

    vocab, merges = _bpe_pair()
    lib, jax_bpe = ByteLevelBPE(vocab, merges), JaxBPE(vocab, merges)
    rng = np.random.default_rng(seed)
    units = sorted({c for m in merges for c in m.replace(" ", "")}) + ["Ω", "中"]
    words = ["".join(rng.choice(units, int(rng.integers(1, 16)))) for _ in range(200)]
    words += [w for w in README.split()[seed::7]]
    got = [lib._bpe(w) for w in words]
    assert lib._get_native() is not None and jax_bpe._get_native() is not None
    python_paths(monkeypatch)
    py = ByteLevelBPE(vocab, merges)
    assert py._get_native() is None
    assert got == [py._bpe(w) for w in words] == [jax_bpe._bpe(w) for w in words]


def test_bpe_native_handle_equals_jax_handle():
    """NativeBpe.apply on interned ids: the port's library against the JAX
    package's, on a seeded merge table."""
    rng = np.random.default_rng(3)
    n = 300
    left, right = rng.integers(0, 64, n), rng.integers(0, 64, n)
    merged, ranks = np.arange(64, 64 + n), rng.permutation(n)
    mine, theirs = bindings.NativeBpe(left, right, merged, ranks), jnb.NativeBpe(left, right, merged, ranks)
    for _ in range(50):
        ids = rng.integers(0, 64, int(rng.integers(1, 40)))
        np.testing.assert_array_equal(bindings.bpe_apply_native(mine, ids), jnb.bpe_apply_native(theirs, ids))


@pytest.mark.parametrize("seed,steps,classes,beam", [(0, 40, 8, 6), (1, 120, 32, 8), (2, 12, 6, 8), (3, 60, 5, 3)])
def test_ctc_native_matches_python_and_jax(monkeypatch, seed, steps, classes, beam):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((steps, classes)) * 3.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels, times, score = bindings.ctc_beam_search_native(lp.astype(np.float32), beam)
    want = jnb.ctc_beam_search_native(lp.astype(np.float32), beam)
    assert (labels, times, score) == want
    lib = ctc.CtcDecoder().decode_beam(lp, beam)
    assert (lib.labels, [t for _, t in lib.steps], lib.log_prob) == (labels, times, score)
    python_paths(monkeypatch)
    py = ctc.CtcDecoder().decode_beam(lp, beam)
    assert py == ctc.CtcDecoder().decode_beam_nbest(lp, beam, 1)[0]
    assert py.steps == lib.steps and abs(py.log_prob - lib.log_prob) < 1e-6


def _masks():
    rng = np.random.default_rng(0)
    m = np.zeros((12, 12), bool)
    m[2:6, 3:9] = True
    m[8:11, 1:4] = True
    yield m
    for shape, p in (((16, 16), 0.6), ((64, 48), 0.5), ((33, 70), 0.8), ((1, 9), 0.3)):
        yield rng.random(shape) > p
    yield np.ones((5, 7), bool)
    yield np.zeros((4, 4), bool)


@pytest.mark.parametrize("case", range(7))
def test_contours_native_match_python_and_jax(monkeypatch, case):
    mask = list(_masks())[case]
    got = contours.find_contours(mask)
    want = jnb.find_contours_native(mask)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.as_array(), b.astype(np.float64))
    python_paths(monkeypatch)
    py = contours.find_contours(mask)
    assert len(py) == len(got)
    for a, b in zip(got, py):
        np.testing.assert_array_equal(a.as_array(), b.as_array())


def test_error_of_a_built_library_propagates(monkeypatch):
    """No hidden fallback: with the library built, an error it raises
    reaches the caller instead of turning into the Python path."""
    def broken(*args, **kwargs):
        raise OSError("broken library")

    monkeypatch.setattr(bindings, "find_contours_native", broken)
    with pytest.raises(OSError, match="broken library"):
        contours.find_contours(np.ones((3, 3), bool))
    monkeypatch.setattr(bindings, "ctc_beam_search_native", broken)
    with pytest.raises(OSError, match="broken library"):
        ctc.CtcDecoder().decode_beam(np.log(np.full((4, 3), 1 / 3)), 2)
