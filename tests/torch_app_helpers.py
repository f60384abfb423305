"""Helpers of the port's example-app tests (tests/test_torch_examples_*.py):
the apps' files written once a module (``chip_smoke.write_app_files``, the
builders the card's phase 17 reuses), each JAX app run once a module on
them, and the port's app held against it."""

import contextlib
import importlib
import io
import sys
from pathlib import Path

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-5  # each printed number (or one unit of its last printed place)


def run(main, argv, result=None):
    """``main(argv)``'s exit code and printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv) if result is None else main(argv, result=result)
    return rc, buf.getvalue().splitlines()


def jax_app(name):
    """The JAX package's app module ``examples.<name>``."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module(f"examples.{name}")


def port_app(name):
    return importlib.import_module(f"rten_tpu_torch.examples.{name}")


def jax_runs(names, files, tmp: Path) -> dict:
    """Each JAX app's (printed lines, output directory) on its file route;
    a written PNG or WAV in the directory."""
    out = {}
    for name in names:
        out_dir = tmp / f"jax_{name}"
        out_dir.mkdir()
        rc, lines = run(jax_app(name).main, chip_smoke.app_argv(name, files, out_dir))
        assert rc == 0, name
        out[name] = (lines, out_dir)
    return out


def check_port_app(name, files, jax_run, tmp: Path) -> dict:
    """The port's app on the same files with ``--cpu``: its printed lines
    equal the JAX app's (numbers within RTOL / ATOL), each file it writes
    the JAX app's but for at most 0.1% of values off by one code. Returns
    the port app's result dict."""
    want, jax_dir = jax_run
    out_dir = tmp / f"port_{name}"
    out_dir.mkdir()
    res = {}
    rc, lines = run(port_app(name).main, [*chip_smoke.app_argv(name, files, out_dir), "--cpu"], res)
    assert rc == 0
    got = [line.replace(str(out_dir), "OUT") for line in lines]
    diff = chip_smoke.lines_differ(got, [line.replace(str(jax_dir), "OUT") for line in want], RTOL, ATOL)
    assert diff is None, diff
    written = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in out_dir.iterdir()) == written
    for fname in written:
        diff = chip_smoke.written_differ(str(out_dir / fname), str(jax_dir / fname))
        assert diff is None, f"{fname}: {diff}"
    return res
