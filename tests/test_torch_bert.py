"""The port's BERT-class encoder (``rten_tpu_torch/models/bert.py``, plain
kernel versions on the CPU) against the JAX package's
(``rten_tpu/models/bert.py``) on the same seeded parameters, carried across
by ``params_from_jax``.

The JAX side runs its TPU branch (``patch_jax_encoders``: the int8
projections through ``quant_matmul_int8`` with the bias in its epilogue,
non-causal ``flash_attention`` with per-row ``kv_len``, both Pallas kernels
in interpret mode). Sizes: 2 layers, d_model 256 (4 heads of 64), d_ff 512,
vocab 500 (every projection has ≥ 2^16 elements and dims that are multiples
of 128, so the quantizer packs all twelve), 3 sequences padded to T 48 with
lengths 48, 31 and 9. Tolerances: f32 outputs within 1e-4 of the output's
largest magnitude, bf16 within 2e-2, over valid positions only (padded
positions' hidden states are unspecified); equal QA argmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.models import bert as jbert
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import bert as tbert
from torch_port_helpers import jax_cast, patch_jax_encoders, rel_err, to_jax, to_numpy, torch_f32

CFG = dict(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=512, max_seq=64)
LENGTHS = np.array([48, 31, 9], np.int32)
F32_TOL, BF16_TOL = 1e-4, 2e-2


def bert_tree(seed: int = 0) -> dict:
    """Dense numpy params in the JAX package's layout, with random biases
    and norms (the inits make them zeros and ones)."""
    rng = np.random.default_rng(seed)
    d, ff = CFG["d_model"], CFG["d_ff"]

    def w(*shape, scale=0.06):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln():
        return {"scale": rng.uniform(0.8, 1.2, d).astype(np.float32), "bias": w(d, scale=0.05)}

    tree = {"tok_emb": w(CFG["vocab_size"], d, scale=0.5), "pos_emb": w(CFG["max_seq"], d, scale=0.2),
            "seg_emb": w(2, d, scale=0.2), "emb_ln": ln(), "layers": []}
    for _ in range(CFG["n_layers"]):
        tree["layers"].append({
            "wq": w(d, d), "bq": w(d, scale=0.05), "wk": w(d, d), "bk": w(d, scale=0.05),
            "wv": w(d, d), "bv": w(d, scale=0.05), "wo": w(d, d), "bo": w(d, scale=0.05), "attn_ln": ln(),
            "w_up": w(d, ff), "b_up": w(ff, scale=0.05), "w_down": w(ff, d, scale=0.04), "b_down": w(d, scale=0.05),
            "ffn_ln": ln(),
        })
    return tree


def _inputs():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, CFG["vocab_size"], (len(LENGTHS), 48)).astype(np.int32)
    seg = (np.arange(48)[None, :] >= LENGTHS[:, None] // 2).astype(np.int32)
    head = {"w": (rng.standard_normal((CFG["d_model"], 2)) * 0.3).astype(np.float32),
            "b": np.array([0.1, -0.2], np.float32)}
    return ids, seg, head


def _valid():
    return np.arange(48)[None, :] < LENGTHS[:, None]


@pytest.fixture(scope="module")
def runs():
    """The JAX package's TPU branch on the int8 params, in f32 and bf16
    (every float leaf cast), and on the dense params in f32: (hidden, pool
    mean, pool cls, QA start, QA end) each, with the params carried."""
    ids, seg, head = _inputs()
    dense = to_jax(bert_tree(0))
    quant = jbert.quantize_params_int8(dense)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_encoders(mp)
        for name, tree, dtype in (("int8_f32", quant, jnp.float32), ("int8_bf16", quant, jnp.bfloat16),
                                  ("dense_f32", dense, jnp.float32)):
            jtree = jax_cast(tree, dtype)
            lens = jnp.asarray(LENGTHS)
            hidden = jbert.encode(jtree, _cfg(jnp, dtype), jnp.asarray(ids), lengths=lens,
                                  segment_ids=jnp.asarray(seg))
            jhead = jax_cast(to_jax(head), dtype)
            start, end = jbert.qa_logits(hidden, jhead, lens)
            out[name] = dict(tree=to_numpy(jtree), hidden=np.asarray(hidden, np.float32),
                             mean=np.asarray(jbert.pool(hidden, lens), np.float32),
                             cls=np.asarray(jbert.pool(hidden, lens, mode="cls"), np.float32),
                             start=np.asarray(start, np.float32), end=np.asarray(end, np.float32))
    return out


def _cfg(mod, dtype):
    if mod is jnp:
        return jbert.BertConfig(**CFG, dtype=dtype)
    return tbert.BertConfig(**CFG, dtype=dtype)


def _port(run: dict, dtype):
    cfg = _cfg(torch, dtype)
    params = tbert.params_from_jax(run["tree"], cfg, device="cpu")
    ids, seg, head = _inputs()
    lens = torch.from_numpy(LENGTHS)
    dispatch.reset_counters()
    hidden = tbert.encode(params, cfg, torch.from_numpy(ids), lengths=lens, segment_ids=torch.from_numpy(seg))
    counts = dict(dispatch.PLAIN)
    thead = {"w": torch.from_numpy(head["w"]).to(dtype), "b": torch.from_numpy(head["b"]).to(dtype)}
    start, end = tbert.qa_logits(hidden, thead, lens)
    return hidden, counts, tbert.pool(hidden, lens), tbert.pool(hidden, lens, mode="cls"), start, end


CASES = [("int8_f32", torch.float32, F32_TOL), ("int8_bf16", torch.bfloat16, BF16_TOL),
         ("dense_f32", torch.float32, F32_TOL)]


@pytest.mark.parametrize("name,dtype,tol", CASES, ids=[c[0] for c in CASES])
def test_encode_matches_jax(runs, name, dtype, tol):
    """Hidden states at valid positions; the int8 params take the plain
    quant_matmul_int8 six times a layer and flash attention once."""
    run = runs[name]
    hidden, counts, *_ = _port(run, dtype)
    assert hidden.shape == (3, 48, CFG["d_model"]) and hidden.dtype == dtype
    valid = _valid()
    assert rel_err(hidden.float().numpy(), run["hidden"], valid) <= tol
    assert counts["flash_attention"] == CFG["n_layers"]
    assert counts.get("quant_matmul_int8", 0) == (6 * CFG["n_layers"] if name.startswith("int8") else 0)


@pytest.mark.parametrize("name,dtype,tol", CASES, ids=[c[0] for c in CASES])
def test_pool_and_qa_match_jax(runs, name, dtype, tol):
    """Mean and cls pooling, and the QA start / end logits at valid
    positions (padding exactly -1e30) with equal argmax."""
    run = runs[name]
    _hidden, _counts, mean, cls, start, end = _port(run, dtype)
    assert rel_err(mean.float().numpy(), run["mean"]) <= tol
    assert rel_err(cls.float().numpy(), run["cls"]) <= tol
    valid = _valid()
    for got, want in ((start, run["start"]), (end, run["end"])):
        got = got.float().numpy()
        assert rel_err(got, want, valid) <= tol
        assert np.all(got[~valid] == np.float32(torch.tensor(-1e30, dtype=dtype).float()))
        assert np.array_equal(got.argmax(1), want.argmax(1))


def test_quantize_params_matches_jax():
    """The port's quantizer on dense port params packs the same matrices
    with the same codes and scales as the JAX package's, and leaves the
    rest dense."""
    tree = bert_tree(3)
    cfg = _cfg(torch, torch.float32)
    tq = tbert.quantize_params_int8(tbert.params_from_jax(tree, cfg, device="cpu"), device="cpu")
    jq = jbert.quantize_params_int8(to_jax(tree))
    for tl, jl in zip(tq["layers"], jq["layers"]):
        for key in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
            assert np.array_equal(tl[key]["qt"].numpy(), np.asarray(jl[key]["q"]).T)
            assert np.array_equal(tl[key]["s"].numpy(), np.asarray(jl[key]["s"]).reshape(-1))
        assert torch.equal(tl["bq"], torch_f32(jl["bq"]))
    assert torch.equal(tq["tok_emb"], torch_f32(jq["tok_emb"]))
    # Below the size rule nothing is packed (d_model 128: 2^14-element matrices).
    small = tbert.BertConfig(vocab_size=50, n_layers=1, n_heads=2, d_model=128, d_ff=256, max_seq=8)
    sq = tbert.quantize_params_int8(tbert.init_params(0, small, device="cpu"), device="cpu")
    assert not any(isinstance(v, dict) and "qt" in v for v in sq["layers"][0].values())


def _hf_state(seed: int = 4):
    """A HuggingFace ``BertModel`` at the test widths, in eval mode, seeded."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    hf_cfg = transformers.BertConfig(vocab_size=CFG["vocab_size"], hidden_size=CFG["d_model"],
                                     num_hidden_layers=CFG["n_layers"], num_attention_heads=CFG["n_heads"],
                                     intermediate_size=CFG["d_ff"], max_position_embeddings=CFG["max_seq"],
                                     type_vocab_size=2, hidden_act="gelu", layer_norm_eps=1e-12,
                                     attn_implementation="eager")
    model = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_from_hf_bert_matches_jax_and_transformers():
    """``from_hf_bert`` on a HuggingFace BertModel's state dict: every leaf
    equals the JAX package's ``from_hf_bert``, and ``encode`` equals the
    model's own last hidden state at valid positions (f32, 1e-4)."""
    model, state = _hf_state()
    cfg = _cfg(torch, torch.float32)
    tp = tbert.from_hf_bert(state, cfg, device="cpu")
    jp = jbert.from_hf_bert({k: v.numpy() for k, v in state.items()}, _cfg(jnp, jnp.float32))
    flat_t, flat_j = [], []

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            flat_t.append(a.numpy())
            flat_j.append(np.asarray(b))

    walk(tp, jp)
    assert all(np.array_equal(a, b) for a, b in zip(flat_t, flat_j))
    ids, seg, _ = _inputs()
    mask = torch.from_numpy(_valid().astype(np.int64))
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids).long(), attention_mask=mask,
                     token_type_ids=torch.from_numpy(seg).long()).last_hidden_state.numpy()
    got = tbert.encode(tp, cfg, torch.from_numpy(ids), lengths=torch.from_numpy(LENGTHS),
                       segment_ids=torch.from_numpy(seg)).numpy()
    assert rel_err(got, want, _valid()) <= F32_TOL


def test_presets_match_jax():
    for name in ("BERT_BASE", "DISTILBERT_BASE", "JINA_SMALL"):
        t, j = getattr(tbert, name), getattr(jbert, name)
        for field in ("vocab_size", "n_layers", "n_heads", "d_model", "d_ff", "max_seq", "n_segments",
                      "layer_norm_eps"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert t.dtype == torch.float32


@pytest.mark.parametrize("name,dtype,tol", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_encode_at_head_dim_32_matches_jax(name, dtype, tol):
    """8 heads of 32 (all-MiniLM-L6-v2's head dim) over the same int8
    params: hidden states at valid positions against the JAX package's TPU
    branch (its flash attention at head dim 32, interpreted)."""
    ids, seg, _head = _inputs()
    cfg = dict(CFG, n_heads=8)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jtree = jax_cast(jbert.quantize_params_int8(to_jax(bert_tree(0))), jdtype)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_encoders(mp)
        want = jbert.encode(jtree, jbert.BertConfig(**cfg, dtype=jdtype), jnp.asarray(ids),
                            lengths=jnp.asarray(LENGTHS), segment_ids=jnp.asarray(seg))
    tcfg = tbert.BertConfig(**cfg, dtype=dtype)
    params = tbert.params_from_jax(to_numpy(jtree), tcfg, device="cpu")
    dispatch.reset_counters()
    got = tbert.encode(params, tcfg, torch.from_numpy(ids), lengths=torch.from_numpy(LENGTHS),
                       segment_ids=torch.from_numpy(seg))
    assert tcfg.head_dim == 32 and dispatch.PLAIN["flash_attention"] == CFG["n_layers"]
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32), _valid()) <= tol
