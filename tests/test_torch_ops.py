"""The port's graph ops against the JAX package's, op by op.

Every case of the JAX package's execute-every-op gate
(``tests/test_all_ops_execute.py``: its ``SPECS`` and ``build_model``,
imported, not copied) goes through that gate's wire round trip, is copied
into a port ``Graph`` and runs on the CPU in both of the port's modes
against the JAX package's interpret mode: the same shapes and dtypes,
floats within the gate's own rtol 1e-4 / atol 1e-5, integers and bools
exactly, and the port's compile mode equal to its interpret mode bit for
bit. Random ops (``nd``) compare shape and dtype only; data-dependent ops
(``dd``) raise ``CompileError`` in compile mode (or a ``RunError`` caused by
one), as in the JAX package.
"""

import numpy as np
import pytest

import rten_tpu.optimize.quantize  # noqa: F401 — registers QuantMatMul
import rten_tpu_torch.optimize.quantize  # noqa: F401 — registers QuantMatMul
from rten_tpu.format import fbs
from rten_tpu.format.rten_io import load_rten, save_rten
from rten_tpu.ops.registry import all_ops as jax_all_ops
from rten_tpu.runtime.session import Model as JModel
from rten_tpu.runtime.session import ModelOptions as JModelOptions
from rten_tpu.runtime.session import RunOptions as JRunOptions
from rten_tpu_torch.ops.registry import CompileError, all_ops
from rten_tpu_torch.runtime.executor import RunError
from rten_tpu_torch.runtime.session import Model, ModelOptions, RunOptions
from test_all_ops_execute import SPECS, build_model
from torch_port_helpers import host, port_graph


def test_port_registry_matches_jax():
    assert all_ops() == jax_all_ops()
    assert len(all_ops()) == 111


@pytest.mark.parametrize("op_type", sorted(SPECS))
def test_op_matches_jax(op_type):
    spec = SPECS[op_type]
    g, inputs = build_model(op_type, spec)
    if op_type in fbs.OPERATOR_TYPES:
        g, _ = load_rten(save_rten(g))  # the gate's wire round trip
    jmodel = JModel(g, options=JModelOptions(enable_optimization=False))
    want = [np.asarray(o) for o in jmodel.run(inputs, opts=JRunOptions(mode="interpret", seed=0))]

    model = Model(port_graph(g), options=ModelOptions(enable_optimization=False), device="cpu")
    got_i = [host(o) for o in model.run(inputs, opts=RunOptions(mode="interpret", seed=0))]
    assert len(got_i) == len(want) == spec.get("n_outputs", 1)
    if spec.get("dd"):
        with pytest.raises((CompileError, RunError)) as exc:
            model.run(inputs, opts=RunOptions(mode="compile", seed=0))
        err = exc.value
        assert isinstance(err, CompileError) or isinstance(err.__cause__, CompileError)
        runs = [got_i]
    else:
        got_c = [host(o) for o in model.run(inputs, opts=RunOptions(mode="compile", seed=0))]
        runs = [got_i, got_c]
        if not spec.get("nd"):
            for a, b in zip(got_i, got_c):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)  # compile equals interpret bit for bit
    for got in runs:
        for a, b in zip(got, want):
            assert a.shape == b.shape, f"{op_type}: {a.shape} vs {b.shape}"
            assert a.dtype == b.dtype, f"{op_type}: {a.dtype} vs {b.dtype}"
            if spec.get("nd"):
                continue
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
            else:
                np.testing.assert_array_equal(a, b)
