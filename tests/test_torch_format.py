"""The port's `.rten` files (``rten_tpu_torch.format``) against the JAX
package's (``rten_tpu.format``): twins of ``tests/test_format.py`` and
``tests/test_format_fuzz.py`` on the CPU.

A file written by either package loads into the other to the same graph
(``assert_graphs_equal``: names, dtypes, bits, attrs, inputs, outputs,
captures); the port's writer, which builds the FlatBuffer on ``struct``
without the ``flatbuffers`` package, writes the JAX package's bytes; its
save is byte-stable. The fuzz's graphs run in both packages' ``Model.run``
from each other's files: f32 results within 1e-5, integer ones equal.
"""

import mmap

import numpy as np
import pytest

from rten_tpu.format import fbs as jfbs
from rten_tpu.format import rten_io as jio
from rten_tpu.format.header import Header as JHeader
from rten_tpu.format.header import HeaderError as JHeaderError
from rten_tpu.graph import Graph as JGraph
from rten_tpu.ops.registry import all_ops as jax_ops
from rten_tpu.runtime.session import Model as JModel
from rten_tpu.runtime.session import ModelOptions as JModelOptions
from rten_tpu.runtime.session import RunOptions as JRunOptions
from rten_tpu_torch.format import fbs, rten_io
from rten_tpu_torch.format.header import Header, HeaderError, is_v1
from rten_tpu_torch.graph import Graph
from rten_tpu_torch.ops.registry import all_ops
from rten_tpu_torch.runtime.session import Model, ModelOptions, RunOptions
from test_format import make_graph
from test_format_fuzz import _random_graph
from torch_port_helpers import assert_graphs_equal, host, port_graph

NO_OPT = dict(enable_optimization=False)


def test_schema_tables_are_the_jax_packages():
    assert fbs.OPERATOR_TYPES == jfbs.OPERATOR_TYPES and fbs.UNIONS == jfbs.UNIONS
    assert fbs.TABLES == jfbs.TABLES and rten_io.OP_ATTRS.keys() == jio.OP_ATTRS.keys()


_GOOD = JHeader(2, 32, 100, 192).to_bytes() + b"\0" * 200
HEADER_CASES = {
    "round_trip": _GOOD,
    "bad_magic": b"XTEN" + _GOOD[4:],
    "bad_version": _GOOD[:4] + b"\x03\x00\x00\x00" + _GOOD[8:],
    "too_short": _GOOD[:20],
    "model_past_end": JHeader(2, 32, 400, 0).to_bytes() + b"\0" * 200,
    "tensor_data_inside_model": JHeader(2, 32, 100, 64).to_bytes() + b"\0" * 200,
}


@pytest.mark.parametrize("case", HEADER_CASES)
def test_header_parses_as_jax_does(case):
    buf = HEADER_CASES[case]
    try:
        want = JHeader.from_buf(buf)
    except JHeaderError as e:
        with pytest.raises(HeaderError, match=str(e)):
            Header.from_buf(buf)
        return
    got = Header.from_buf(buf)
    assert (got.version, got.model_offset, got.model_len, got.tensor_data_offset) == (
        want.version, want.model_offset, want.model_len, want.tensor_data_offset)
    assert got.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("inline", [False, True])
def test_files_cross_both_ways(inline):
    jg = make_graph()
    md = {"description": "test", "license": "MIT"}
    jbytes = jio.save_rten(jg, md, inline_constants=inline)
    tbytes = rten_io.save_rten(port_graph(jg), md, inline_constants=inline)
    assert tbytes == jbytes  # the struct writer lays out the bytes flatbuffers.Builder does
    from_jax, md_t = rten_io.load_rten(jbytes)
    from_port, md_j = jio.load_rten(tbytes)
    assert md_t == md_j == md
    assert_graphs_equal(from_jax, from_port)
    assert from_jax.nodes[0].shape == [1, "seq", 4] and from_jax.nodes[7].attrs == {"axis": -1}
    assert [n.value.dtype for n in from_jax.nodes[1:4]] == [np.float32, np.int32, np.int8]
    assert Header.from_buf(tbytes).tensor_data_offset % 64 == 0  # 0 when inline: no segment


def test_save_is_byte_stable():
    g = port_graph(make_graph())
    data = rten_io.save_rten(g, {"description": "stable"})
    assert rten_io.save_rten(g, {"description": "stable"}) == data
    loaded, md = rten_io.load_rten(data)
    assert rten_io.save_rten(loaded, md) == data


def test_v1_file_reads_in_both():
    """A bare FlatBuffer (V1: no header, "RTEN" at bytes 4..8) with inline
    constants."""
    data = rten_io.save_rten(port_graph(make_graph()), inline_constants=True)
    h = Header.from_buf(data)
    v1 = data[h.model_offset : h.model_offset + h.model_len]
    assert is_v1(v1) and not is_v1(data)
    assert_graphs_equal(rten_io.load_rten(v1)[0], jio.load_rten(v1)[0])


def _attr_sample(op_type, field, kind, graph_cls):
    """A non-default value for one attr field of ``rten_io.OP_ATTRS``."""
    table = dict((n, k) for n, k, _ in fbs.TABLES[rten_io.OP_ATTRS[op_type][0]])
    if kind == "scalar":
        return {"int": 3, "uint": 3, "ubyte": 1, "float": 0.25, "bool": True, "string": "ij,jk->ik"}[table[field]]
    if kind in ("intlist", "intlist_opt"):
        return [1, 2, 0, 3]
    if kind.startswith("enum:"):  # a non-default member (AutoPad's NotSet reads back absent)
        values = rten_io._ENUMS[kind[5:]]
        return rten_io._SNAKE_CACHE[values[0] if kind == "enum:AutoPad" else values[-1]]
    if kind == "graph":
        sub = graph_cls()
        c = sub.add_constant("one", np.float32(1.0))
        sub.outputs = [c]
        return sub
    return np.float32(1.5)  # scalar_union


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_every_registered_op_crosses_with_its_attrs(direction):
    """Every op both registries hold that the schema carries, each attr
    field of its table set to a non-default value (If's branches, enums,
    int lists, the ConstantOfShape scalar union), saved by one package and
    loaded by the other to the same graph."""
    ops = [op for op in all_ops() if op in fbs.OPERATOR_TYPES and op in jax_ops()]
    assert len(ops) > 100
    save, load, graph_cls = ((rten_io.save_rten, jio.load_rten, Graph) if direction == "port_to_jax"
                             else (jio.save_rten, rten_io.load_rten, JGraph))
    g = graph_cls()
    x = g.add_value("x")
    for op_type in ops:
        fields = rten_io.OP_ATTRS.get(op_type, ("", {}))[1]
        attrs = {f: _attr_sample(op_type, f, k, graph_cls) for f, k in fields.items()}
        g.add_operator(f"op_{op_type}", op_type, attrs, [x, None], [g.add_value(f"{op_type}_out")])
    g.inputs, g.outputs = [x], []
    data = save(g)
    there, _ = load(data)
    back, _ = (rten_io.load_rten if load is jio.load_rten else jio.load_rten)(data)
    assert_graphs_equal(there, back)
    assert [n.op_type for n in there.nodes if type(n).__name__ == "OperatorNode"] == ops


def test_subgraph_captures_and_optional_inputs_cross():
    then_g, else_g = JGraph(), JGraph()
    cap = then_g.add_value("y")
    then_g.captures = [cap]
    then_g.outputs = [then_g.add_simple_op("Neg", [cap], name="neg")]
    else_g.outputs = [else_g.add_constant("two", np.float32(2.0))]
    g = JGraph()
    cond, y = g.add_value("cond"), g.add_value("y")
    mx = g.add_constant("max", np.float32(1.0))
    out, clipped = g.add_value("out"), g.add_value("clipped")
    g.add_operator("if", "If", {"then_branch": then_g, "else_branch": else_g}, [cond], [out])
    g.add_operator("clip", "Clip", {}, [y, None, mx], [clipped])
    g.inputs, g.outputs = [cond, y], [out, clipped]
    ported, _ = rten_io.load_rten(jio.save_rten(g))
    assert ported.nodes[5].attrs["then_branch"].captures == [0] and ported.nodes[6].inputs == [1, None, 2]
    assert_graphs_equal(ported, jio.load_rten(rten_io.save_rten(ported))[0])


def test_malformed_data_and_runtime_attrs_refused():
    with pytest.raises(rten_io.ModelLoadError):
        rten_io.load_rten(b"\x08\x00\x00\x00RTEN" + b"\xff" * 8)
    g = Graph()
    x = g.add_value("x")
    g.add_operator("mm", "MatMul", {"perm_a": [1, 0]}, [x, x], [g.add_value("y")])
    with pytest.raises(rten_io.ModelLoadError, match="runtime-only"):
        rten_io.save_rten(g)


def test_load_load_file_and_load_mmap(tmp_path, rng):
    """The three loaders give the same model; under ``load_mmap`` the
    constants are read-only views of the mapping, which stays open while
    the model lives, and a run copies them before they become tensors."""
    jg = make_graph()
    data = rten_io.save_rten(port_graph(jg), {"description": "loaders"})
    path = tmp_path / "m.rten"
    path.write_bytes(data)
    x = rng.standard_normal((1, 3, 4)).astype(np.float32)
    want = host(JModel(jg, options=JModelOptions(**NO_OPT)).run([x])[0])
    models = [Model.load(data, ModelOptions(**NO_OPT), device="cpu"),
              Model.load_file(path, ModelOptions(**NO_OPT), device="cpu"),
              Model.load_mmap(path, ModelOptions(**NO_OPT), device="cpu")]
    mapped = models[2].graph.nodes[1].value
    assert not mapped.flags.writeable and isinstance(models[2]._mapping, mmap.mmap)
    before = mapped.copy()
    for model in models:
        assert model.metadata == {"description": "loaders"}
        for mode in ("interpret", "compile"):
            np.testing.assert_allclose(host(model.run([x], opts=RunOptions(mode=mode))[0]), want, rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_array_equal(mapped, before)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_files_run_alike_in_both(seed):
    rng = np.random.default_rng(seed)
    jg, xv = _random_graph(rng)
    (ref,) = JModel(jg, options=JModelOptions(**NO_OPT)).run([xv], opts=JRunOptions(mode="interpret"))
    ref = host(ref)
    jbytes, tbytes = jio.save_rten(jg), rten_io.save_rten(port_graph(jg))
    assert tbytes == jbytes
    port_model = Model.load(jbytes, ModelOptions(**NO_OPT), device="cpu")
    (got,) = port_model.run([xv], opts=RunOptions(mode="interpret"))
    (back,) = JModel(jio.load_rten(tbytes)[0], options=JModelOptions(**NO_OPT)).run(
        [xv], opts=JRunOptions(mode="interpret"))
    np.testing.assert_array_equal(host(back), ref)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(host(got), ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(host(got), ref)
