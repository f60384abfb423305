"""rten_tpu_torch stands alone: it imports neither ``jax`` nor anything of
``rten_tpu``, and its entry points do not fall back to the CPU on a
machine without CUDA."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p for p in (REPO / "rten_tpu_torch").rglob("*.py") if "_build" not in p.parts  # build outputs
) + [REPO / "chip_smoke.py"]

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["rten_tpu"] = None     # and so does any import of the JAX package
import numpy as np, torch
import rten_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rten_tpu_torch.__path__, "rten_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from rten_tpu_torch.models import decoder
cfg = decoder.DecoderConfig(vocab_size=300, n_layers=1, n_heads=4, d_model=256, d_ff=512,
                            max_seq=32, dtype=torch.float32)
params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cpu"), device="cpu")
cache = decoder.init_cache(cfg, 1, device="cpu")
tok = torch.tensor([[3]], dtype=torch.int32)
for _ in range(2):
    tok, cache = decoder.forward(params, cfg, tok, cache, lm_head_mode="argmax")
assert int(cache["len"][0]) == 2
assert not any(m == "jax" or m.startswith(("jax.", "rten_tpu.")) or m == "rten_tpu"
               for m, mod in sys.modules.items() if mod is not None)
print("OK", len(names))
"""


def test_imports_and_decodes_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK"), res.stdout


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|rten_tpu)\b(?!_torch)|from\s+(?:jax|rten_tpu)\b(?!_torch))",
    re.MULTILINE,
)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, hits


def test_scan_regex_catches_imports():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from rten_tpu.kernels import dispatch", "import rten_tpu", "    import jax"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("from rten_tpu_torch.kernels import dispatch", "import rten_tpu_torch",
               "# rten_tpu/kernels/quant_matmul.py"):
        assert not _FORBIDDEN.search(ok), ok


def test_entry_points_refuse_without_cuda(monkeypatch):
    from rten_tpu_torch.generate import NativeBackend
    from rten_tpu_torch.models import decoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = decoder.DecoderConfig(vocab_size=300, n_layers=1, n_heads=4, d_model=256, d_ff=512,
                                max_seq=32, dtype=torch.float32)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cpu"), device="cpu")
    calls = [
        lambda: decoder.init_params(0, cfg),
        lambda: decoder.quantize_params_int8(params),
        lambda: decoder.init_cache(cfg, 1),
        lambda: decoder.params_from_jax({"layers": []}, cfg),
        lambda: decoder.from_hf_gpt2({}, cfg),
        lambda: NativeBackend(params, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
