"""The port's graph runtime (``Model``, the executors, the optimizer)
against the JAX package's: twins of ``tests/test_runtime.py`` and
``tests/test_optimize.py`` on the CPU.

Graphs come from those files' own graph functions (``mlp_graph``,
``build_layernorm_graph``), copied into port graphs; each twin gives both
packages the same inputs and holds the port's outputs against the JAX
package's at rtol 1e-5 / atol 1e-6 (the source tests' bound), and the port's
optimized graphs to the op types JAX's optimizer leaves. ``QuantMatMul`` is
held against the JAX package's TPU branch (``dispatch.on_tpu`` forced, the
Pallas kernels interpreted) within 1e-4 relative RMS.
"""

import math

import numpy as np
import pytest
import torch

from rten_tpu.graph import Graph as JGraph
from rten_tpu.runtime.session import Model as JModel
from rten_tpu.runtime.session import ModelOptions as JModelOptions
from rten_tpu.runtime.session import RunOptions as JRunOptions
from rten_tpu_torch.graph import ConstantNode, Graph
from rten_tpu_torch.ops.registry import CompileError, OpContext, OpError, get_op
from rten_tpu_torch.optimize.quantize import quantize_graph_int8
from rten_tpu_torch.runtime.executor import RunError
from rten_tpu_torch.runtime.session import Model, ModelOptions, RunOptions
from test_optimize import build_layernorm_graph
from test_runtime import _ref_mlp, mlp_graph
from torch_port_helpers import host, port_graph


def both(jgraph, **opts):
    """(JAX model, port model on the CPU) of one JAX-package graph."""
    tgraph = port_graph(jgraph)  # before the JAX optimizer rewrites it in place
    return JModel(jgraph, options=JModelOptions(**opts)), Model(tgraph, options=ModelOptions(**opts), device="cpu")


def op_types(graph):
    return sorted(op.op_type for _, op in graph.operator_nodes())


@pytest.mark.parametrize("mode", ["interpret", "compile"])
def test_mlp_both_modes(mode, rng):
    jm, tm = both(mlp_graph(), mode=mode)
    x = rng.standard_normal((1, 8)).astype(np.float32)
    (got,) = tm.run([x])
    (want,) = jm.run([x])
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(host(got), _ref_mlp(mlp_graph(), x), rtol=1e-4, atol=1e-5)


def test_modes_agree_bit_for_bit(rng):
    model = Model(port_graph(mlp_graph()), device="cpu")
    x = rng.standard_normal((3, 8)).astype(np.float32)
    (compiled,) = model.run([x], opts=RunOptions(mode="compile"))
    (interp,) = model.run([x], opts=RunOptions(mode="interpret"))
    np.testing.assert_array_equal(host(compiled), host(interp))


def test_run_one_and_named_inputs(rng):
    model = Model(port_graph(mlp_graph()), device="cpu")
    x = rng.standard_normal((1, 8)).astype(np.float32)
    out1 = model.run_one(x)
    (out2,) = model.run({"x": x})
    (out3,) = model.run({"x": torch.from_numpy(x)})
    np.testing.assert_array_equal(host(out1), host(out2))
    np.testing.assert_array_equal(host(out1), host(out3))
    assert isinstance(out1, torch.Tensor) and out1.device.type == "cpu"


def test_intermediate_outputs(rng):
    jm, tm = both(mlp_graph())
    x = rng.standard_normal((1, 8)).astype(np.float32)
    for mode in ("interpret", "compile"):
        (h,) = tm.run({"x": x}, outputs=["mm1_out"], opts=RunOptions(mode=mode))
        (jh,) = jm.run({"x": x}, outputs=["mm1_out"], opts=JRunOptions(mode="interpret"))
        np.testing.assert_allclose(host(h), np.asarray(jh), rtol=1e-5, atol=1e-6)


def _shape_math_graph(graph_cls, from_input: bool = False):
    """Shape → Slice → Concat → Reshape; with ``from_input`` the leading
    dim comes from a second graph input instead (dynamic)."""
    g = graph_cls()
    x = g.add_value("x")
    shp = g.add_simple_op("Shape", [x], name="shape")
    minus1 = g.add_constant("m1", np.array([-1], dtype=np.int32))
    first = g.add_simple_op(
        "Slice", [shp,
                  g.add_constant("s0", np.array([0], np.int32)),
                  g.add_constant("s1", np.array([1], np.int32)),
                  g.add_constant("sa", np.array([0], np.int32))],
        name="first_dim",
    )
    if from_input:
        first = g.add_value("lead")
    newshape = g.add_simple_op("Concat", [first, minus1], {"axis": 0}, name="newshape")
    out = g.add_simple_op("Reshape", [x, newshape], name="reshape")
    g.inputs, g.outputs = ([x, first] if from_input else [x]), [out]
    return g


def test_shape_math_folds_in_compile_mode(rng):
    model = Model(_shape_math_graph(Graph), options=ModelOptions(mode="compile"), device="cpu")
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    (out,) = model.run([x])
    assert tuple(out.shape) == (2, 12)
    np.testing.assert_array_equal(host(out), x.reshape(2, 12))
    # The same target from a graph input is dynamic: interpret reads it,
    # compile refuses it, as under jax.jit.
    dyn = Model(_shape_math_graph(Graph, from_input=True), options=ModelOptions(enable_optimization=False),
                device="cpu")
    lead = np.array([2], np.int32)
    (out,) = dyn.run([x, lead], opts=RunOptions(mode="interpret"))
    assert tuple(out.shape) == (2, 12)
    with pytest.raises(RunError) as exc:
        dyn.run([x, lead], opts=RunOptions(mode="compile"))
    assert isinstance(exc.value.__cause__, CompileError)
    jdyn = JModel(_shape_math_graph(JGraph, from_input=True), options=JModelOptions(enable_optimization=False))
    with pytest.raises(Exception):
        jdyn.run([x, lead], opts=JRunOptions(mode="compile"))


def _partial_graph(graph_cls):
    g = graph_cls()
    a = g.add_value("a")
    b = g.add_value("b")
    a2 = g.add_simple_op("Mul", [a, a], name="a_sq")
    both_ = g.add_simple_op("Add", [a2, b], name="sum")
    g.inputs, g.outputs = [a, b], [both_]
    return g


def test_partial_run_frontier_matches_jax():
    jm = JModel(_partial_graph(JGraph), options=JModelOptions(enable_optimization=False))
    tm = Model(_partial_graph(Graph), options=ModelOptions(enable_optimization=False), device="cpu")
    av = np.array([2.0, 3.0], dtype=np.float32)
    for outputs in (["sum_out"], ["a_sq_out"]):
        got = tm.partial_run({"a": av}, outputs)
        want = jm.partial_run({"a": av}, outputs)
        assert [nid for nid, _ in got] == [nid for nid, _ in want]
        assert [tm.graph.node_name(nid) for nid, _ in got] == ["a_sq_out"]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(host(g), np.asarray(w))


def _if_graph(graph_cls, static_cond=None, mismatched=False):
    """If(cond): then 2·x, else -x (``mismatched``: else returns x[:1]).
    ``static_cond`` makes the condition a constant."""
    then_g = graph_cls()
    tx = then_g.add_value("x")
    then_g.captures = [tx]
    then_g.outputs = [then_g.add_simple_op("Mul", [tx, then_g.add_constant("two", np.float32(2.0))],
                                           name="then_mul")]
    else_g = graph_cls()
    ex = else_g.add_value("x")
    else_g.captures = [ex]
    if mismatched:
        e_out = else_g.add_simple_op("Slice", [ex, else_g.add_constant("z", np.array([0], np.int32)),
                                               else_g.add_constant("o", np.array([1], np.int32))], name="else_slice")
    else:
        e_out = else_g.add_simple_op("Neg", [ex], name="else_neg")
    else_g.outputs = [e_out]
    g = graph_cls()
    cond = g.add_constant("cond", np.int32(static_cond)) if static_cond is not None else g.add_value("cond")
    x = g.add_value("x")
    out = g.add_value("out")
    g.add_operator("if", "If", {"then_branch": then_g, "else_branch": else_g}, [cond], [out])
    g.inputs, g.outputs = ([x] if static_cond is not None else [cond, x]), [out]
    return g


@pytest.mark.parametrize("mode", ["interpret", "compile"])
def test_if_with_dynamic_condition(mode):
    tm = Model(_if_graph(Graph), options=ModelOptions(enable_optimization=False, mode=mode), device="cpu")
    jm = JModel(_if_graph(JGraph), options=JModelOptions(enable_optimization=False, mode=mode))
    xv = np.array([1.0, 2.0], dtype=np.float32)
    for c in (1, 0):
        (got,) = tm.run({"cond": np.int32(c), "x": xv})
        (want,) = jm.run({"cond": np.int32(c), "x": xv})
        np.testing.assert_array_equal(host(got), np.asarray(want))
        np.testing.assert_array_equal(host(got), xv * 2 if c else -xv)


def test_if_static_condition_runs_the_taken_branch_only():
    xv = np.array([1.0, 2.0], dtype=np.float32)
    for c in (1, 0):
        tm = Model(_if_graph(Graph, static_cond=c, mismatched=True),
                   options=ModelOptions(enable_optimization=False, mode="compile"), device="cpu")
        (got,) = tm.run({"x": xv})
        np.testing.assert_array_equal(host(got), xv * 2 if c else xv[:1])
    # A dynamic condition takes both branches in compile mode (lax.cond's
    # rule): branches of different shapes run in interpret mode only.
    tm = Model(_if_graph(Graph, mismatched=True), options=ModelOptions(enable_optimization=False), device="cpu")
    (got,) = tm.run({"cond": np.int32(0), "x": xv}, opts=RunOptions(mode="interpret"))
    np.testing.assert_array_equal(host(got), xv[:1])
    with pytest.raises(RunError):
        tm.run({"cond": np.int32(0), "x": xv}, opts=RunOptions(mode="compile"))


def test_constant_folding_at_load():
    def build(graph_cls):
        g = graph_cls()
        x = g.add_value("x")
        c1 = g.add_constant("c1", np.array([1.0, 2.0], np.float32))
        c2 = g.add_constant("c2", np.array([3.0, 4.0], np.float32))
        folded = g.add_simple_op("Add", [c1, c2], name="c_sum")
        out = g.add_simple_op("Mul", [x, folded], name="out_mul")
        g.inputs, g.outputs = [x], [out]
        return g, folded

    g, folded = build(Graph)
    model = Model(g, device="cpu")
    jg, _ = build(JGraph)
    jmodel = JModel(jg)
    assert isinstance(model.graph.nodes[folded], ConstantNode)
    np.testing.assert_array_equal(model.graph.nodes[folded].value, jmodel.graph.nodes[folded].value)
    assert op_types(model.graph) == op_types(jmodel.graph)
    (out,) = model.run([np.array([2.0, 2.0], np.float32)])
    np.testing.assert_allclose(host(out), [8.0, 12.0])


def _silu_graph(graph_cls):
    g = graph_cls()
    x = g.add_value("x")
    sig = g.add_simple_op("Sigmoid", [x], name="sig")
    g.inputs, g.outputs = [x], [g.add_simple_op("Mul", [x, sig], name="mul")]
    return g


def _gelu_graph(graph_cls):
    g = graph_cls()
    x = g.add_value("x")
    d = g.add_simple_op("Div", [x, g.add_constant("sqrt2", np.float32(math.sqrt(2.0)))], name="div")
    e = g.add_simple_op("Erf", [d], name="erf")
    a = g.add_simple_op("Add", [e, g.add_constant("one", np.float32(1.0))], name="add1")
    m1 = g.add_simple_op("Mul", [x, a], name="mul_x")
    m2 = g.add_simple_op("Mul", [m1, g.add_constant("half", np.float32(0.5))], name="mul_half")
    g.inputs, g.outputs = [x], [m2]
    return g


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activation_fusion_matches_jax(name):
    build = {"silu": _silu_graph, "gelu": _gelu_graph}[name]
    jm, tm = JModel(build(JGraph)), Model(build(Graph), device="cpu")
    assert op_types(tm.graph) == op_types(jm.graph) == [name.capitalize()]
    xv = np.linspace(-3, 3, 13).astype(np.float32)
    for mode in ("interpret", "compile"):
        (got,) = tm.run([xv], opts=RunOptions(mode=mode))
        (want,) = jm.run([xv], opts=JRunOptions(mode="interpret"))
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("square_via", ["pow", "mul"])
@pytest.mark.parametrize("with_affine", [True, False])
def test_layer_norm_fusion_matches_jax(square_via, with_affine):
    jm, tm = both(build_layernorm_graph(with_affine, square_via)[0])
    assert op_types(tm.graph) == op_types(jm.graph)
    assert ("LayerNormalization" in op_types(tm.graph)) == with_affine
    x = np.random.default_rng(1).standard_normal((2, 5, 8)).astype(np.float32)
    (got,) = tm.run([x], opts=RunOptions(mode="interpret"))
    (want,) = jm.run([x], opts=JRunOptions(mode="interpret"))
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    unfused = Model(port_graph(build_layernorm_graph(with_affine, square_via)[0]),
                    options=ModelOptions(enable_optimization=False), device="cpu")
    (plain,) = unfused.run([x], opts=RunOptions(mode="interpret"))
    np.testing.assert_allclose(host(got), host(plain), rtol=1e-5, atol=1e-5)


def _transpose_graph(graph_cls, case):
    rng = np.random.default_rng(0)
    g = graph_cls()
    a = g.add_value("a")
    if case == "batched":
        w = g.add_constant("w", rng.standard_normal((3, 5)).astype(np.float32))
        at = g.add_simple_op("Transpose", [a], {"perm": [0, 2, 1]}, name="at")
    else:
        w = g.add_constant("w", rng.standard_normal((8, 3)).astype(np.float32))
        at = g.add_simple_op("Transpose", [a], name="at")
    mm = g.add_simple_op("MatMul", [at, w], name="mm")
    g.inputs, g.outputs = [a], ([mm, at] if case == "escapes" else [mm])
    return g


@pytest.mark.parametrize("case", ["reverse", "batched", "escapes"])
def test_transpose_absorption_matches_jax(case):
    jm, tm = JModel(_transpose_graph(JGraph, case)), Model(_transpose_graph(Graph, case), device="cpu")
    assert op_types(tm.graph) == op_types(jm.graph)
    assert ("Transpose" in op_types(tm.graph)) == (case == "escapes")
    av = np.random.default_rng(3).standard_normal((2, 3, 4) if case == "batched" else (8, 4)).astype(np.float32)
    (want, *_) = jm.run([av], opts=JRunOptions(mode="interpret"))
    for mode in ("interpret", "compile"):
        (got, *_) = tm.run([av], opts=RunOptions(mode=mode))
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_captured_constants_fold_like_jax():

    def build(graph_cls):
        then_g = graph_cls()
        tx, tw = then_g.add_value("x"), then_g.add_value("w")
        then_g.captures = [tx, tw]
        then_g.outputs = [then_g.add_simple_op("Mul", [tx, tw], name="then_mul")]
        else_g = graph_cls()
        ex = else_g.add_value("x")
        else_g.captures = [ex]
        else_g.outputs = [else_g.add_simple_op("Neg", [ex], name="else_neg")]
        g = graph_cls()
        cond, x = g.add_value("cond"), g.add_value("x")
        g.add_constant("w", np.array([2.0, 3.0], np.float32))
        out = g.add_value("out")
        g.add_operator("if", "If", {"then_branch": then_g, "else_branch": else_g}, [cond], [out])
        g.inputs, g.outputs = [cond, x], [out]
        return g

    tm, jm = Model(build(Graph), device="cpu"), JModel(build(JGraph))
    tb = next(op for _, op in tm.graph.operator_nodes() if op.op_type == "If").attrs["then_branch"]
    assert [tb.node_name(c) for c in tb.captures] == ["x"]
    assert isinstance(tb.nodes[tb.get_node_id("w")], ConstantNode)
    xv = np.array([1.0, 2.0], np.float32)
    for c in (1, 0):
        for mode in ("interpret", "compile"):
            (got,) = tm.run({"cond": np.int32(c), "x": xv}, opts=RunOptions(mode=mode))
            (want,) = jm.run({"cond": np.int32(c), "x": xv}, opts=JRunOptions(mode="interpret"))
            np.testing.assert_array_equal(host(got), np.asarray(want))


def test_quant_fusion_not_constant_folded():
    rng = np.random.default_rng(0)
    g = Graph()
    x = g.add_value("x")
    w = g.add_constant("w", rng.standard_normal((256, 128)).astype(np.float32))
    g.inputs, g.outputs = [x], [g.add_simple_op("MatMul", [x, w], name="mm")]
    g, n = quantize_graph_int8(g)
    assert n == 1
    model = Model(g, device="cpu")
    assert not [nd for nd in model.graph.nodes if isinstance(nd, ConstantNode)
                and nd.value.dtype == np.float32 and nd.value.size >= 256 * 128]
    assert op_types(model.graph) == ["QuantMatMul"]


@pytest.fixture
def jax_tpu_branch(monkeypatch):
    """The JAX package's QuantMatMul on its TPU branch, the Pallas kernels
    interpreted (``patch_jax_encoders``' rule for ``on_tpu``)."""
    import rten_tpu.kernels.dispatch as jdispatch
    import rten_tpu.kernels.quant_matmul as jqm
    import rten_tpu.optimize.quantize  # noqa: F401 — registers QuantMatMul
    from rten_tpu.ops.registry import OpContext as JOpContext
    from rten_tpu.ops.registry import get_op as jget_op

    monkeypatch.setattr(jdispatch, "on_tpu", lambda: True)
    for name in ("quant_matmul_int8", "quant_gemv_int8"):
        fn = getattr(jqm, name)
        monkeypatch.setattr(jqm, name, lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
    return lambda *args: np.asarray(jget_op("QuantMatMul").fn(JOpContext(), {}, *args))


@pytest.mark.parametrize("m", [2, 8, 64])
@pytest.mark.parametrize("k", [8, 20, 24, 768])
def test_quant_matmul_matches_jax_tpu_branch(jax_tpu_branch, m, k):
    rng = np.random.default_rng(m * 1000 + k)
    n = 72
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.01 + 0.001).astype(np.float32)
    want = jax_tpu_branch(x, w, s)
    from rten_tpu_torch.kernels import dispatch

    dispatch.reset_counters()
    got = host(get_op("QuantMatMul").fn(OpContext(), {}, torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(s)))
    assert got.shape == want.shape == (m, n) and got.dtype == want.dtype
    assert np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)) < 1e-4
    # The plain versions of the TPU branch's kernels: the GEMV at M ≤ 8.
    assert dispatch.PLAIN == {"quant_gemv_int8" if m <= 8 else "quant_matmul_int8": 1}


def test_quant_matmul_packs_each_weight_once():
    from rten_tpu_torch.kernels import dispatch

    rng = np.random.default_rng(0)
    g = Graph()
    x = g.add_value("x")
    w = g.add_constant("w", rng.standard_normal((200, 128)).astype(np.float32))  # K 200: padded to 208
    g.inputs, g.outputs = [x], [g.add_simple_op("MatMul", [x, w], name="mm")]
    g, _ = quantize_graph_int8(g)
    model = Model(g, device="cpu")
    xs = rng.standard_normal((3, 200)).astype(np.float32)
    (first,) = model.run([xs], opts=RunOptions(mode="interpret"))
    packs = [getattr(t, "_rten_pack", None) for t in model._consts._cache.values()]
    (pack,) = [p for p in packs if p is not None]
    assert tuple(pack.shape) == (128, 208) and pack.dtype == torch.int8
    dispatch.reset_counters()
    (second,) = model.run([xs], opts=RunOptions(mode="compile"))
    assert [p for p in (getattr(t, "_rten_pack", None) for t in model._consts._cache.values())
            if p is not None] == [pack]
    np.testing.assert_array_equal(host(first), host(second))
    assert dispatch.PLAIN["quant_gemv_int8"] == 1


def test_timing_table(rng, capsys):
    model = Model(port_graph(mlp_graph()), device="cpu")
    x = rng.standard_normal((1, 8)).astype(np.float32)
    model.run([x], opts=RunOptions(timing=True))
    out = capsys.readouterr().out
    assert "MatMul" in out and "total" in out


def test_rten_timing_env_var(monkeypatch, capsys, rng):
    model = Model(port_graph(mlp_graph()), device="cpu")
    monkeypatch.setenv("RTEN_TIMING", "sort=name by-shape=1")
    model.run([rng.standard_normal((1, 8)).astype(np.float32)])
    out = capsys.readouterr().out
    assert "MatMul" in out and "total" in out and "[1, 8]" in out
    assert not model._compiled  # timing runs interpret


def test_one_compiled_entry_per_signature(rng):
    model = Model(port_graph(mlp_graph()), device="cpu")
    x = rng.standard_normal((1, 8)).astype(np.float32)
    model.run([x])
    model.run([x + 1])
    assert len(model._compiled) == 1
    model.run([rng.standard_normal((2, 8)).astype(np.float32)])
    assert len(model._compiled) == 2
    model.run([x], opts=RunOptions(seed=3))
    assert len(model._compiled) == 3


def test_random_ops_repeat_with_one_seed():
    g = Graph()
    x = g.add_value("x")
    n1 = g.add_simple_op("RandomNormalLike", [x], name="n1")
    n2 = g.add_simple_op("RandomUniformLike", [x], name="n2")
    n3 = g.add_simple_op("RandomNormalLike", [x], {"seed": 5.0}, name="n3")
    g.inputs, g.outputs = [x], [n1, n2, n3]
    model = Model(g, options=ModelOptions(enable_optimization=False), device="cpu")
    xv = np.zeros((4, 3), np.float32)
    runs = [[host(o) for o in model.run([xv], opts=RunOptions(mode=mode, seed=7))]
            for mode in ("interpret", "compile", "interpret", "compile")]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][0], runs[0][2])  # n1 and n3 draw from different generators
    other = [host(o) for o in model.run([xv], opts=RunOptions(mode="compile", seed=8))]
    assert not np.array_equal(other[0], runs[0][0]) and np.array_equal(other[2], runs[0][2])
    with pytest.raises(RunError, match="seed"):
        model.run([xv], opts=RunOptions(mode="interpret"))


def test_unregistered_op_rejected():
    g = Graph()
    x = g.add_value("x")
    g.inputs, g.outputs = [x], [g.add_simple_op("TotallyFakeOp", [x])]
    with pytest.raises(OpError):
        Model(g, options=ModelOptions(enable_optimization=False), device="cpu")


def test_allowed_ops_subset():
    with pytest.raises(OpError):
        Model(port_graph(mlp_graph()), options=ModelOptions(allowed_ops={"MatMul"}, enable_optimization=False),
              device="cpu")
    Model(port_graph(mlp_graph()), options=ModelOptions(allowed_ops={"MatMul", "Gelu", "Add"},
                                                       enable_optimization=False), device="cpu")


def test_total_params():
    model = Model(port_graph(mlp_graph()), options=ModelOptions(enable_optimization=False), device="cpu")
    assert model.total_params() == 8 * 16 + 16 * 4 + 4 == JModel(
        mlp_graph(), options=JModelOptions(enable_optimization=False)).total_params()
