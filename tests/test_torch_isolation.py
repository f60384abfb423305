"""rten_tpu_torch stands alone: it imports neither ``jax`` nor anything of
``rten_tpu`` or of the repo-level ``examples`` package (nor ``flatbuffers``:
its `.rten` writer is its own), its C++ / CUDA sources name neither, and
its entry points do not fall back to the CPU on a machine without CUDA."""

import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p for p in (REPO / "rten_tpu_torch").rglob("*.py") if "_build" not in p.parts  # build outputs
) + [REPO / "chip_smoke.py"]
PORT_NATIVE = sorted(
    p for pat in ("*.cpp", "*.cu*") for p in (REPO / "rten_tpu_torch").rglob(pat) if "_build" not in p.parts
)

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["rten_tpu"] = None     # and so does any import of the JAX package
sys.modules["flatbuffers"] = None  # the port writes .rten files without it
sys.modules["examples"] = None     # the repo-level apps: the port has its own
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
prompt = torch.arange(12, dtype=torch.int32)[None]  # one prefill forward of 12 rows
logits, cache = decoder.prefill(params, cfg, prompt, cache, last_only=True)
assert int(cache["len"][0]) == 14 and logits.shape == (1, 1, 300)
import dataclasses
cfg8 = dataclasses.replace(cfg, w8a8=True)  # the W8A8 prefill and decode structures
logits, cache = decoder.prefill(params, cfg8, prompt, decoder.init_cache(cfg8, 1, device="cpu"))
tok, cache = decoder.forward(params, cfg8, prompt[:, -1:], cache, lm_head_mode="argmax")
assert int(cache["len"][0]) == 13 and logits.shape == (1, 12, 300)
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels.matmul import matmul_fused
dispatch.reset_counters()
cfgm = dataclasses.replace(cfg, mega=True, activation="silu")  # the whole-block decode kernel
tok, cache = decoder.forward(params, cfgm, tok, cache, lm_head_mode="argmax")
assert dispatch.PLAIN["decode_block"] == 1 and "decode_attention" not in dispatch.PLAIN
assert matmul_fused(torch.ones(3, 5), torch.ones(5, 2), activation="tanh").shape == (3, 2)
from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine
for engine in (ServingEngine(params, cfg, max_batch=2, steps_per_tick=2, device="cpu"),
               PagedServingEngine(params, cfg, max_batch=2, n_pages=4, page_size=64, int8_kv=True,
                                  device="cpu")):
    reqs = [engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=3)) for _ in range(3)]
    engine.run()
    assert all(len(r.output) == 3 for r in reqs)
llama = dataclasses.replace(decoder.LLAMA_TINY, vocab_size=300, n_layers=1, d_model=256, n_heads=4, n_kv_heads=2,
                            d_ff=344, max_seq=32, dtype=torch.float32)  # RoPE, GQA, SwiGLU, untied lm_head
lparams = decoder.quantize_params_int8(decoder.init_params(0, llama, device="cpu"), device="cpu")
dispatch.reset_counters()
logits, cache = decoder.prefill(lparams, llama, prompt, decoder.init_cache(llama, 1, device="cpu"), last_only=True)
tok, cache = decoder.forward(lparams, llama, logits.argmax(-1).to(torch.int32), cache, lm_head_mode="argmax")
assert dispatch.PLAIN["decode_attention:gqa"] == 1 and int(cache["len"][0]) == 13
for engine in (ServingEngine(lparams, dataclasses.replace(llama, int8_kv=True), max_batch=2, device="cpu"),
               PagedServingEngine(lparams, llama, max_batch=2, n_pages=4, page_size=64, device="cpu")):
    reqs = [engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=3)) for _ in range(3)]
    engine.run()
    assert all(len(r.output) == 3 for r in reqs)
from rten_tpu_torch.models import encoder_decoder as ed  # the Whisper-class encoder-decoder
wcfg = ed.EncDecConfig(n_mels=16, n_audio_ctx=16, vocab_size=300, d_model=256, n_heads=4, n_audio_layers=1,
                       n_text_layers=1, d_ff=512, max_text_ctx=16, dtype=torch.float32, int8_kv=True)
wparams = ed.quantize_params_int8(ed.init_params(0, wcfg, device="cpu"), device="cpu")
enc = ed.encode(wparams, wcfg, torch.randn(1, 16, 32))
state = ed.init_decoder_state(wparams, wcfg, enc)
tok = torch.tensor([[1]], dtype=torch.int32)
for _ in range(2):
    tok, state = ed.decode(wparams, wcfg, tok, state, lm_head_mode="argmax")
assert enc.shape == (1, 16, 256) and int(state["len"][0]) == 2 and tok.shape == (1, 1)
from rten_tpu_torch.serve import checkpoint
engine = ServingEngine(params, cfg, max_batch=2, device="cpu")
engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
engine.step()
checkpoint.restore_engine(ServingEngine(params, cfg, max_batch=2, device="cpu"), checkpoint.snapshot_engine(engine))
from rten_tpu_torch.models import bert, mobilenet, resnet, vit, wav2vec2  # the encoders and vision models
from rten_tpu_torch import audio, ctc, image
bcfg = bert.BertConfig(vocab_size=300, n_layers=1, n_heads=4, d_model=256, d_ff=512, max_seq=32)
bparams = bert.quantize_params_int8(bert.init_params(0, bcfg, device="cpu"), device="cpu")
hidden = bert.encode(bparams, bcfg, torch.ones(2, 12, dtype=torch.int32), lengths=torch.tensor([12, 5]))
assert bert.pool(hidden, torch.tensor([12, 5])).shape == (2, 256)
wcfg2 = wav2vec2.Wav2Vec2Config(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), d_model=256, n_layers=1,
                                n_heads=4, d_ff=512)
w2v = wav2vec2.quantize_params_int8(wav2vec2.init_params(0, wcfg2, device="cpu"), device="cpu")
logits = wav2vec2.ctc_logits(w2v, wcfg2, torch.randn(1, 490))
assert logits.shape == (1, 48, 32) and isinstance(ctc.CtcDecoder().decode_greedy(logits[0].numpy()).labels, list)
vcfg = vit.ViTConfig(image_size=32, patch_size=8, n_layers=1, n_heads=4, d_model=256, d_ff=512, n_classes=10)
assert vit.classify(vit.init_params(0, vcfg, device="cpu"), vcfg, torch.randn(1, 3, 32, 32)).shape == (1, 10)
mcfg = mobilenet.MobileNetConfig(blocks=((1, 16, 1, 1), (6, 24, 2, 2)), last_channels=64, num_classes=10)
mparams = mobilenet.quantize_params_int8(mobilenet.init_params(0, mcfg, device="cpu"), device="cpu")
assert mobilenet.forward(mparams, mcfg, torch.randn(1, 3, 32, 32)).shape == (1, 10)
rcfg = resnet.ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=8)
assert resnet.forward(resnet.init_params(0, rcfg, device="cpu"), rcfg, torch.randn(1, 3, 32, 32)).shape == (1, 10)
assert image.normalize_image(np.zeros((3, 2, 2), np.float32)).shape == (3, 2, 2) and audio.resample
from rten_tpu_torch.graph import Graph  # the graph runtime: build, optimize, run in both modes
from rten_tpu_torch.models.gpt2_graph import Gpt2GraphConfig, build_gpt2_graph
from rten_tpu_torch.optimize.quantize import quantize_graph_int8
from rten_tpu_torch.runtime.session import Model, RunOptions
from rten_tpu_torch.generate import Generator, GeneratorConfig, GraphBackend
gcfg = Gpt2GraphConfig(vocab_size=300, n_positions=64, d_model=128, n_layers=1, n_heads=2, d_ff=256)
graph, n_q = quantize_graph_int8(build_gpt2_graph(Graph, gcfg))
gmodel = Model(graph, device="cpu")
assert n_q == 5 and sum(op.op_type == "QuantMatMul" for _, op in gmodel.graph.operator_nodes()) == 5
feed = {"input_ids": np.array([[1, 2, 3]], np.int32), "attention_mask": np.ones((1, 3), np.int32),
        "position_ids": np.arange(3, dtype=np.int32)[None],
        **{f"past_key_values.0.{k}": np.zeros((1, 2, 0, 64), np.float32) for k in ("key", "value")}}
runs = [gmodel.run(feed, ["logits"], RunOptions(mode=mode))[0] for mode in ("interpret", "compile")]
assert runs[0].shape == (1, 3, 300) and torch.equal(runs[0], runs[1])
toks = [int(t[0]) for t in Generator(GraphBackend(gmodel), GeneratorConfig(max_tokens=4)).with_prompt([1, 2, 3])]
assert len(toks) == 4 and len(gmodel._compiled) == 3  # the feed, the prompt bucket, one decode bucket
from rten_tpu_torch.format import load_rten, save_rten  # model files: save, load, run, lift
from rten_tpu_torch.generate import NativeBackend, backend_for_model
data = save_rten(build_gpt2_graph(Graph, gcfg, tied=True), {"description": "isolated"})
fmodel = Model.load(data, device="cpu")
assert save_rten(*load_rten(data)) == data and fmodel.metadata == {"description": "isolated"}
assert fmodel.run(feed, ["logits"])[0].shape == (1, 3, 300)
native = backend_for_model(fmodel, n_heads=2, device="cpu")
assert isinstance(native, NativeBackend) and native.prefill(np.array([[1, 2, 3]], np.int32)).shape == (1, 300)
from rten_tpu_torch import native  # the host toolkit: tokenizers, geometry, the native library, utils
from rten_tpu_torch.image import find_contours
from rten_tpu_torch.runtime.profiler import StepTimer
from rten_tpu_torch.text.models import ByteLevelBPE
from rten_tpu_torch.utils import env_int, run_bench
assert ByteLevelBPE({"a": 0, "b": 1, "ab": 2}, ["a b"])._bpe("abab") == ["ab", "ab"]
assert len(find_contours(np.eye(4, dtype=bool))) == 1 and isinstance(native.available(), bool)
assert env_int("RTEN_UNSET_FOR_TEST", 3) == 3 and len(run_bench(2, "x", lambda: 1).times_s) == 2 and StepTimer()
import tempfile  # parallel/ and ring attention on a one-rank gloo world
import torch.distributed as dist
from rten_tpu_torch.kernels.ring_attention import ring_attention_sharded
from rten_tpu_torch.parallel import init_cache, make_mesh, shard_decoder_params
from rten_tpu_torch.parallel.multihost import ServingSupervisor, init_distributed
from rten_tpu_torch.parallel.overlap import matmul_allreduce
from rten_tpu_torch.parallel.pp import pp_forward, stack_layer_params
from rten_tpu_torch.parallel.tp import sp_prefill, tp_decode_step
assert init_distributed()["num_processes"] == 1 and not dist.is_initialized()
dist.init_process_group("gloo", store=dist.FileStore(tempfile.mkdtemp() + "/store", 1), rank=0, world_size=1)
mesh = make_mesh(1, 1, device="cpu")
tcache = init_cache(cfg, 1, 32, mesh)
tok, tcache = tp_decode_step(shard_decoder_params(params, cfg, mesh), cfg, torch.tensor([[3]], dtype=torch.int32),
                             tcache, mesh=mesh, lm_head_mode="argmax")
assert tok.shape == (1, 1) and int(tcache["len"][0]) == 1
assert sp_prefill(params, cfg, prompt[:, :4], mesh=mesh)[0].shape == (1, 4, 300)
dense = decoder.init_params(0, cfg, device="cpu")
pipe = type(mesh)({"pipe": 1}, device="cpu")
assert pp_forward(stack_layer_params(dense), cfg, prompt[:, :4], mesh=pipe).shape == (1, 4, 300)
assert matmul_allreduce(torch.ones(2, 4), torch.ones(4, 3), mesh).shape == (2, 3)
assert ring_attention_sharded(mesh, *[torch.randn(1, 2, 8, 16)] * 3).shape == (1, 2, 8, 16)
sup = ServingSupervisor(lambda: ServingEngine(params, cfg, max_batch=2, mesh=mesh), mesh=mesh)
sup.submit(Request(prompt=[1, 2], max_new_tokens=3))
assert [len(r.output) for r in sup.run()] == [3]
dist.destroy_process_group()
import contextlib, io  # the example apps: every --demo on the CPU
from rten_tpu_torch.examples import common
demos = {"imagenet": [], "yolo": [], "deeplab": [], "detr": [], "depth_anything": [], "segment_anything": [],
         "distilvit": ["-n", "2"], "trocr": ["-n", "2"], "jina_similarity": [], "qwen2_chat": ["-n", "2"],
         "piper": [], "silero": [], "wav2vec2": ["--beam", "2"], "gpt2": ["-n", "2"], "bert_qa": []}
for app in demos:
    with contextlib.redirect_stdout(io.StringIO()):
        assert importlib.import_module(f"rten_tpu_torch.examples.{app}").main(["--demo", "--cpu", *demos[app]]) == 0
assert common.resize_bilinear(np.zeros((1, 4, 4), np.float32), (2, 2)).shape == (1, 2, 2)
assert not any(m == "jax" or m.startswith(("jax.", "rten_tpu.", "examples.")) or m in ("rten_tpu", "examples")
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


# In a C++ / CUDA source: a Python module named in a string (an import
# through the C API, or Python code run from a string).
_NATIVE_FORBIDDEN = re.compile(r'"(?:jax|rten_tpu|examples)(?:[."]|\\n)|\b(?:import|from)\s+(?:jax|rten_tpu)\b(?!_torch)')


@pytest.mark.parametrize("path", PORT_NATIVE, ids=lambda p: str(p.relative_to(REPO)))
def test_native_source_names_no_jax(path):
    hits = _NATIVE_FORBIDDEN.findall(path.read_text())
    assert not hits, hits


def test_native_scan_catches_the_jax_embed_api():
    """The JAX package's embed_api.cpp imports rten_tpu.runtime.session and
    runs ``import jax`` from a string: the scan finds both; the port's
    copy names neither."""
    hits = _NATIVE_FORBIDDEN.findall((REPO / "rten_tpu" / "native" / "embed_api.cpp").read_text())
    assert '"rten_tpu.' in hits and any("jax" in h for h in hits)
    assert REPO / "rten_tpu_torch" / "native" / "embed_api.cpp" in PORT_NATIVE
    assert not _NATIVE_FORBIDDEN.search('PyImport_ImportModule("rten_tpu_torch.runtime.session")')


def test_scan_regex_catches_imports():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from rten_tpu.kernels import dispatch", "import rten_tpu", "    import jax"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("from rten_tpu_torch.kernels import dispatch", "import rten_tpu_torch",
               "# rten_tpu/kernels/quant_matmul.py"):
        assert not _FORBIDDEN.search(ok), ok


def test_entry_points_refuse_without_cuda(monkeypatch):
    from rten_tpu_torch.format import save_rten
    from rten_tpu_torch.generate import EncDecBackend, NativeBackend, backend_for_model
    from rten_tpu_torch.models.lift import lift_decoder
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.runtime.session import Model
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.models import bert, mobilenet, resnet, vit, wav2vec2
    from rten_tpu_torch.models import encoder_decoder as ed
    from rten_tpu_torch.serve import PagedServingEngine, ServingEngine
    from rten_tpu_torch.examples import bert_qa, gpt2
    from rten_tpu_torch.kernels.quant_matmul import int8_pack
    from rten_tpu_torch.parallel import World, make_mesh, run_ranks

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
        lambda: decoder.from_hf_llama({}, cfg),
        lambda: decoder.from_hf_opt({}, cfg),
        lambda: NativeBackend(params, cfg),
        lambda: ServingEngine(params, cfg),
        lambda: PagedServingEngine(params, cfg, page_size=64),
        lambda: ed.init_params(0, ed.WHISPER_TINY),
        lambda: ed.quantize_params_int8({}),
        lambda: ed.params_from_jax({}, ed.WHISPER_TINY),
        lambda: ed.from_hf_whisper({}, ed.WHISPER_TINY),
        lambda: EncDecBackend({}, ed.WHISPER_TINY, [[[0.0]]]),
        lambda: bert.init_params(0, bert.BertConfig(n_layers=1)),
        lambda: bert.quantize_params_int8({}),
        lambda: bert.params_from_jax({}, bert.BERT_BASE),
        lambda: bert.from_hf_bert({}, bert.BERT_BASE),
        lambda: wav2vec2.init_params(0, wav2vec2.Wav2Vec2Config(n_layers=1)),
        lambda: wav2vec2.quantize_params_int8({}),
        lambda: wav2vec2.params_from_jax({}, wav2vec2.WAV2VEC2_BASE),
        lambda: wav2vec2.from_hf_wav2vec2({}, wav2vec2.WAV2VEC2_BASE),
        lambda: vit.init_params(0, vit.ViTConfig(n_layers=1)),
        lambda: vit.params_from_jax({}, vit.VIT_BASE),
        lambda: mobilenet.init_params(0, mobilenet.MOBILENET_TINY),
        lambda: mobilenet.quantize_params_int8({"blocks": [], "head_w": None}),
        lambda: mobilenet.params_from_jax({}, mobilenet.MOBILENET_V2),
        lambda: resnet.init_params(0, resnet.RESNET18),
        lambda: resnet.params_from_jax({}, resnet.RESNET50),
        lambda: resnet.load_torchvision_state_dict({}, resnet.RESNET50),
        lambda: Model(Graph()),
        lambda: Model.load(save_rten(Graph())),
        lambda: lift_decoder({"wte.weight": np.zeros((4, 4), np.float32)}),
        lambda: backend_for_model(Graph()),
        lambda: int8_pack(np.zeros((4, 2), np.int8), np.ones(2, np.float32)),
        lambda: gpt2.main(["--demo", "-n", "2"]),
        lambda: bert_qa.main(["--demo"]),
        *(lambda app=app: importlib.import_module(f"rten_tpu_torch.examples.{app}").main(["--demo"])
          for app in ("imagenet", "yolo", "deeplab", "detr", "depth_anything", "segment_anything", "distilvit",
                      "trocr", "jina_similarity", "qwen2_chat", "piper", "silero", "wav2vec2")),
        lambda: make_mesh(1, 2),
        lambda: World(2),
        lambda: run_ranks(print, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
