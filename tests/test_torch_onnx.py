"""The port's ONNX import and ``convert`` (``rten_tpu_torch.format.
onnx_reader``, ``onnx_builder``, ``rten_tpu_torch.convert``) against the JAX
package's: the cases of ``tests/test_onnx_import.py`` on the CPU.

Each model is ONNX bytes from the port's ``onnx_builder`` (equal to the JAX
package's builder's bytes), imported by both packages to the same graph
(``assert_graphs_equal``) and run by both ``Model``s: f32 results within
1e-5 relative to the largest, integer results equal. ``convert`` writes the
JAX converter's file, with and without ``--quantize``.
"""

import numpy as np
import pytest
import torch

from rten_tpu.convert.__main__ import main as jax_convert
from rten_tpu.format import onnx_builder as job
from rten_tpu.format.onnx_reader import OnnxImportError as JOnnxImportError
from rten_tpu.format.onnx_reader import load_onnx as jload_onnx
from rten_tpu.format.onnx_reader import tensor_to_numpy as jtensor_to_numpy
from rten_tpu.runtime.session import Model as JModel
from rten_tpu.runtime.session import ModelOptions as JModelOptions
from rten_tpu_torch.convert.__main__ import main as convert
from rten_tpu_torch.format import onnx_builder as ob
from rten_tpu_torch.format.onnx_reader import OnnxImportError, load_onnx, tensor_to_numpy
from rten_tpu_torch.format.protobuf import decode, encode
from rten_tpu_torch.graph import ConstantNode
from rten_tpu_torch.runtime.session import Model, ModelOptions
from torch_port_helpers import assert_graphs_equal, host


def both(data: bytes):
    """(JAX graph, port graph) of the ONNX bytes."""
    jg, jinfo = jload_onnx(data)
    tg, tinfo = load_onnx(data)
    assert jinfo == tinfo
    assert_graphs_equal(jg, tg)
    return jg, tg


def run_both(data: bytes, feed, mode="interpret", **opts):
    """Both packages' outputs of the ONNX model on ``feed``, checked alike."""
    jg, tg = both(data)
    want = [host(o) for o in JModel(jg, options=JModelOptions(mode=mode, **opts)).run(feed)]
    got = [host(o) for o in Model(tg, options=ModelOptions(mode=mode, **opts), device="cpu").run(feed)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g, w)
    return got


def model_bytes(nodes, inputs, outputs, inits=()):
    """ONNX bytes from the port's builder, equal to the JAX builder's."""
    def build(b):
        return b.make_model(b.make_graph(
            [b.make_node(*n[:3], **n[3]) for n in nodes],
            inputs=[b.make_value_info(*v) for v in inputs],
            outputs=[b.make_value_info(*v) for v in outputs],
            initializers=[b.make_tensor(name, arr) for name, arr in inits],
        ))

    data = build(ob)
    assert data == build(job)
    return data


def mlp_bytes(rng):
    w1, b1 = rng.standard_normal((16, 8)).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    w2, b2 = rng.standard_normal((4, 16)).astype(np.float32), rng.standard_normal(4).astype(np.float32)
    gemm = dict(transB=1, alpha=1.0, beta=1.0)
    return model_bytes(
        [("Gemm", ["x", "w1", "b1"], ["h"], gemm), ("Relu", ["h"], ["h_act"], {}),
         ("Gemm", ["h_act", "w2", "b2"], ["logits"], gemm), ("Softmax", ["logits"], ["probs"], {"axis": -1})],
        [("x", ["batch", 8])], [("probs", ["batch", 4])], [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)])


@pytest.mark.parametrize("mode", ["interpret", "compile"])
def test_mlp(mode, rng):
    data = mlp_bytes(rng)
    (out,) = run_both(data, [rng.standard_normal((3, 8)).astype(np.float32)], mode)
    graph, _ = load_onnx(data)
    assert graph.nodes[graph.inputs[0]].shape == ["batch", 8]
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)


def test_conv_pool(rng):
    data = model_bytes(
        [("Conv", ["x", "w", "b"], ["c"], dict(pads=[1, 1, 1, 1], strides=[1, 1], dilations=[1, 1], group=1,
                                               kernel_shape=[3, 3])),
         ("Relu", ["c"], ["r"], {}), ("MaxPool", ["r"], ["p"], dict(kernel_shape=[2, 2], strides=[2, 2])),
         ("GlobalAveragePool", ["p"], ["g"], {})],
        [("x", [1, 3, 8, 8])], [("g", [1, 8, 1, 1])],
        [("w", rng.standard_normal((8, 3, 3, 3)).astype(np.float32)),
         ("b", rng.standard_normal(8).astype(np.float32))])
    run_both(data, [rng.standard_normal((1, 3, 8, 8)).astype(np.float32)])


def test_shape_reshape_chain_folds_in_compile_mode(rng):
    data = model_bytes(
        [("Shape", ["x"], ["shp"], {}), ("Gather", ["shp", "zero"], ["b_dim"], {"axis": 0}),
         ("Unsqueeze", ["b_dim", "zero_axes"], ["b_vec"], {}),
         ("Concat", ["b_vec", "minus1"], ["new_shape"], {"axis": 0}), ("Reshape", ["x", "new_shape"], ["flat"], {})],
        [("x", ["batch", 4, 5])], [("flat", ["batch", 20])],
        [("zero", np.array(0, np.int64)), ("zero_axes", np.array([0], np.int64)),
         ("minus1", np.array([-1], np.int64))])
    (out,) = run_both(data, [rng.standard_normal((2, 4, 5)).astype(np.float32)], "compile")
    assert out.shape == (2, 20)


def test_int64_initializers_clamped():
    data = model_bytes([("Add", ["x", "c"], ["y"], {})], [("x", [2], 6)], [("y", [2], 6)],
                       [("c", np.array([1, 2**40], np.int64))])
    _, tg = both(data)
    const = tg.nodes[tg.get_node_id("c")]
    assert const.value.dtype == np.int32 and const.value[1] == 2**31 - 1  # clamped, not wrapped
    (out,) = run_both(data, [np.array([5, -5], np.int32)])
    np.testing.assert_array_equal(out, [6, 2**31 - 6])


def test_tensor_to_numpy_dtypes():
    """Raw and typed tensor payloads, bf16 raw data upcast to f32."""
    bf16 = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    raw = ob.o.TENSOR
    cases = [
        (encode({"dims": [2], "data_type": 16, "raw_data": bf16.view(torch.int16).numpy().tobytes()}, raw),
         np.array([1.5, -2.25], np.float32)),
        (encode({"dims": [3], "data_type": 7, "int64_data": [1, -2, 3]}, raw), np.array([1, -2, 3], np.int64)),
        (encode({"dims": [2], "data_type": 1, "float_data": [0.5, 2.0]}, raw), np.array([0.5, 2.0], np.float32)),
    ]
    for payload, want in cases:
        got = tensor_to_numpy(decode(payload, raw))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == jtensor_to_numpy(decode(payload, raw)).dtype


def test_constant_node_becomes_constant():
    data = model_bytes([("Constant", [], ["c"], {"value": np.array([3.0], np.float32)}),
                        ("Mul", ["x", "c"], ["y"], {})], [("x", [1])], [("y", [1])])
    _, tg = both(data)
    assert isinstance(tg.nodes[tg.get_node_id("c")], ConstantNode)
    (out,) = run_both(data, [np.array([2.0], np.float32)])
    np.testing.assert_allclose(out, [6.0])


def test_unsupported_op_raises():
    data = model_bytes([("TotallyMadeUpOp", ["x"], ["y"], {})], [("x", [1])], [("y", [1])])
    with pytest.raises(JOnnxImportError):
        jload_onnx(data)
    with pytest.raises(OnnxImportError, match="TotallyMadeUpOp"):
        load_onnx(data)


def test_if_subgraph_with_outer_captures():
    def branches(b):
        then_b = b.make_graph([b.make_node("Mul", ["x", "two"], ["then_out"])], name="then",
                              outputs=[b.make_value_info("then_out", None)],
                              initializers=[b.make_tensor("two", np.float32(2.0).reshape(()))])
        else_b = b.make_graph([b.make_node("Neg", ["x"], ["else_out"])], name="else",
                              outputs=[b.make_value_info("else_out", None)])
        return b.make_model(b.make_graph(
            [b.make_node("If", ["cond"], ["y"], then_branch=then_b, else_branch=else_b)],
            inputs=[b.make_value_info("cond", [], elem_type=9), b.make_value_info("x", [2])],
            outputs=[b.make_value_info("y", [2])]))

    data = branches(ob)
    assert data == branches(job)
    _, tg = both(data)
    then_g = tg.nodes[-1].attrs["then_branch"]
    assert [then_g.node_name(c) for c in then_g.captures] == ["x"]
    x = np.array([1.0, -2.0], np.float32)
    for cond, want in ((1, x * 2), (0, -x)):
        (out,) = run_both(data, {"cond": np.int32(cond), "x": x}, enable_optimization=False)
        np.testing.assert_allclose(out, want)


@pytest.mark.parametrize("quantize", [False, True])
def test_convert_writes_the_jax_converters_file(quantize, rng, tmp_path):
    """``python -m rten_tpu_torch.convert`` (with and without
    ``--quantize``) writes the file the JAX converter writes; the port's
    model loaded from it runs as the JAX one does (``--quantize``: the
    DequantizeLinear pairs fused into QuantMatMul at load)."""
    w1 = (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((128, 128)) * 0.1).astype(np.float32)
    data = model_bytes([("MatMul", ["x", "w1"], ["h"], {}), ("Gelu", ["h"], ["g"], {}),
                        ("MatMul", ["g", "w2"], ["y"], {})],
                       [("x", ["batch", 256])], [("y", ["batch", 128])], [("w1", w1), ("w2", w2)])
    onnx_path = tmp_path / "m.onnx"
    onnx_path.write_bytes(data)
    flags = ["--quantize"] if quantize else []
    assert convert([str(onnx_path), str(tmp_path / "t.rten"), *flags]) == 0
    assert jax_convert([str(onnx_path), str(tmp_path / "j.rten"), *flags]) == 0
    assert (tmp_path / "t.rten").read_bytes() == (tmp_path / "j.rten").read_bytes()
    model = Model.load_file(tmp_path / "t.rten", ModelOptions(mode="interpret"), device="cpu")
    jmodel = JModel.load_file(tmp_path / "j.rten", JModelOptions(mode="interpret"))
    assert len(model.metadata["onnx_hash"]) == 64 and model.metadata == jmodel.metadata
    ops = [op.op_type for _, op in model.graph.operator_nodes()]
    assert ops.count("QuantMatMul") == (2 if quantize else 0)
    for m in (1, 12):  # the GEMV's rows and the matmul's
        x = rng.standard_normal((m, 256)).astype(np.float32)
        got, want = host(model.run([x])[0]), host(jmodel.run([x])[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
