#!/usr/bin/env python3
"""Build, check and drive rten_tpu_torch (the PyTorch / CUDA port) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --prefill [LABEL] [--package DIR]
                                     # phases 1-2, the prefill kernels' and matmul_fused's
                                     # checks, and one prefill forward's device time by
                                     # kernel and launches, weight-only and W8A8, of this
                                     # tree's package or DIR's (see prefill_only); its
                                     # last line is marked partial
    python3 chip_smoke.py --kv LABEL [--package DIR]
                                     # phases 1-2 and the KV kernels' and decode_block's
                                     # checks, of this tree's package or DIR's (see
                                     # kv_only); its last line is marked partial
    python3 chip_smoke.py --encoders LABEL [--package DIR]
                                     # phases 1-2, the encoders' kernel modes of phase 3
                                     # and phase 12 alone (see encoders_only), of this
                                     # tree's package or DIR's; its last line is marked
                                     # partial
    python3 chip_smoke.py --graph LABEL
                                     # phases 1-2, QuantMatMul's kernel calls at the GPT-2
                                     # graph's widths and phase 13 alone (see graph_only);
                                     # its last line is marked partial
    python3 chip_smoke.py --files LABEL [--package DIR]
                                     # phases 1-2, the lifted path's f32 kernel modes of
                                     # phase 3 and phase 14 alone (see files_only), of
                                     # this tree's package or DIR's; its last line is
                                     # marked partial
    python3 chip_smoke.py --text LABEL
                                     # phases 1-2 and phase 15 alone (see text_only); its
                                     # last line is marked partial
    python3 chip_smoke.py --parallel LABEL
                                     # phases 1-2 and phase 16 alone (see parallel_only);
                                     # its last line is marked partial
    python3 chip_smoke.py --apps LABEL
                                     # phases 1-2 and phase 17 alone (see apps_only); its
                                     # last line is marked partial
    python3 chip_smoke.py --gemv LABEL [--package DIR]
                                     # phases 1-2 and the decode GEMV's, MLP's and fused
                                     # wo's checks at 1 and 8 rows, and decode_block's
                                     # output digest, of this tree's package or DIR's
                                     # (see gemv_only); its last line is marked partial

Phases, each of which raises on failure (the script then exits non-zero):

1. device  — the card's name and power limit from nvidia-smi;
2. build   — nvcc builds the kernels from rten_tpu_torch/kernels/csrc, and g++
   the native host library from rten_tpu_torch/native/rten_native.cpp;
3. kernels — each kernel (the three decode kernels, the prefill matmul and
   flash attention, the serving path's int8 and paged decode attentions,
   the W8A8 ones: the w8a8 modes of the decode GEMV and MLP,
   quantize_rows_int8 and quant_matmul_w8a8; decode_block, the whole
   layer in one kernel, at GPT-2-small's and tiny_starcoder_py's blocks,
   beside the two kernels it replaces and with its grid-wide waits' cost;
   matmul_fused on its wgmma, ragged and f32 routes; the silu / sigmoid /
   tanh epilogues; decode_attention at 8 rows of mixed lengths) at
   GPT-2-small's shapes (bf16 activations, int8 weights), the prefill
   matmuls (weight-only and W8A8) and flash attention at the Qwen2-0.5B
   shape's too (each with its split-K or split-KV plan and its wrapper's
   host µs a call; the W8A8 matmul, one launch with its rows quantized
   inside, also against the two-launch pair bit for bit and beside the
   pair's time and its matmul launch alone), the
   decode GEMV (its argmax included) and MLP at 1 and 8 rows and the
   GEMV at the Qwen2-0.5B shape's qkv, w_gu, w_down and lm_head + argmax
   (each with its plan and its launches a call, which must be one), and
   the KV kernels' Llama/Qwen2-class
   modes (unpacked q / k_new / v_new with 14 query heads over 2 kv heads,
   decode_attention with and without its fused wo, the int8 and paged
   kernels) at Qwen2-0.5B's attention shapes, each against its plain
   PyTorch version on the same inputs, with its device time, its plain
   version's time, the least time the card could take for the same work,
   and one PyTorch library call as a yardstick; every KV case (also
   decode_attention without wo at GPT-2's 12 heads) with its plan's
   cluster size, its wrapper's host µs and the kernels a call launches,
   which must be one attention launch (two with the fused wo); and the
   encoder-decoder's kernels at Whisper-tiny's shapes (flash_attention not
   causal over 1500 audio positions at Tq 1500 and Tq 1, quant_matmul_int8
   at 1500 rows, the GEMV at K 384 with the lm_head's argmax bounded to
   51865 of 51968 columns, the MLP at D 384 / FF 1536, decode_attention
   without wo and decode_attention_int8 at S 448), and the four KV kernels
   at 16 rows of mixed lengths; the attention kernels at the head dims and
   pages beside 64 and 128 (check_head_dims_and_pages: the four KV kernels
   and decode_block at 24 heads of 32 over S 768, pages of 16 at the Qwen2
   shape and at Llama-3-8B's 32 / 8 heads of 128, int8 pages of 32;
   flash_attention at all-MiniLM-L6-v2's 12 heads of 32, at 24 heads of
   16, and at Phi-3-mini's 96 and Phi-2's 80 on the 128 instance);
4. serve   — full-width GPT-2-small (12 layers, random int8 weights from a
   seed) served through Generator(NativeBackend(..., device="cuda")): a
   64-token prompt as one prefill forward and 512 greedy tokens in a
   768-position cache (each decode step one replay of NativeBackend's
   captured step), with every launch counter read around the run; the
   step captured against its eager forward, greedy and logits, 56 steps
   each, bit for bit with equal launches, host and device ms a step of
   both (capture_check); the prefill's time to first token at prompts of
   64 and 512; then the first 32 steps teacher-forced token by token
   through the kernels (the served path), and as one prefill forward
   through the kernels and through the plain versions;
5. serving — the same model behind the continuous-batching engines: 16
   seeded requests (prompts 16-320 tokens, 32-128 new tokens) queued at
   once through ServingEngine (8 slots, 8 forwards a tick; run and
   run_pipelined), PagedServingEngine (pages of 128; a pool that holds them
   all, then one small enough to preempt; then pages of 16, their streams
   against the solo streams), both again with int8 KV, and 4
   concurrent POST /generate to a ServingServer on loopback; each stream
   held against its solo Generator(NativeBackend) stream (a difference
   passes only where the solo top-2 logit gap is below 0.05), every page
   back in its pool, each run's launch counters read around it; then ms
   per forward at 8 active rows and the device's idle share per engine;
   both engines' captured tick / step against their eager forwards on
   bf16 and int8 KV (8 requests, 56 forwards; capture_check);
   then both engines at max_batch 16 on bf16 and int8 KV with 32 seeded
   requests (16-48 new tokens), each stream against its solo stream, ms
   per forward at 16 active rows, the idle share, and one step's launches
   (the KV kernel once a layer a forward, no plain version); the slot
   engine's checkpoint (bf16 and int8 KV, greedy and TemperatureSampler(0.8)
   from a seed: half the ticks, snapshot_engine, save_snapshot to a file,
   load_snapshot, restore_engine into a fresh engine, every stream equal to
   the uninterrupted run's) and a NativeBackend's (snapshot_backend after
   phase 4's prompt, the same 32 greedy steps after restore_backend);
6. w8a8    — the same model and int8 weights with DecoderConfig(w8a8=True):
   phase 4's path (every W8A8 kernel launched, no plain call), the accuracy
   gate (the relative RMS difference of the 32 teacher-forced steps' logits
   from the weight-only path's, at most W8A8_GATE), phase 5's 16 requests
   through the slot engine, each stream equal to its solo W8A8 Generator
   stream, and ms per forward at 8 active rows;
7. mega    — the same model and weights with DecoderConfig(mega=True):
   phase 4's path with decode_block launched 12 times a decode step and
   neither decode_attention nor quant_mlp_int8 (tokens/s, ms/step, device
   time by kernel and idle share beside phase 4's two-kernel numbers),
   phase 4's 32 teacher-forced steps through the mega path's kernels and
   plain versions against the two-kernel logits (relative RMS at most
   MEGA_GATE, the top-2 gap rule), and a short W8A8 + mega run;
8. starcoder — a tiny_starcoder_py-shaped model (20 layers, d_model 768,
   12 query heads over 1 kv head, d_ff 3072, vocab 49152, learned
   positions; random int8 weights from seed 0) through phase 4's path with
   a 64-token prompt and 256 tokens in a 1024-position cache, two-kernel
   (decode_attention:gqa + quant_mlp_int8) and with DecoderConfig(mega=True)
   (decode_block:gqa 20 times a decode step, neither of the two), side by
   side, and the two-kernel path's 32 teacher-forced steps through the mega
   kernels and plain versions against its logits (MEGA_GATE, top-2 rule);
9. qwen2   — a Qwen2-0.5B-shaped model (24 layers, d_model 896, 14 query
   heads over 2 kv heads, d_ff 4864, vocab 151936, RoPE θ 1e6, q/k/v
   biases, the tied head as an lm_head copy; random int8 weights from seed
   0): phase 4's path with a 64-token prompt and 256 tokens in a
   1024-position cache (decode_attention in its unpacked GQA mode 24 times
   a decode step), its 32 teacher-forced steps through the kernels and the
   plain versions, 8 seeded requests through the slot and paged engines on
   bf16 and int8 KV (the three GQA KV kernels; each stream against its solo
   stream), the captured step, tick and paged step against eager
   (capture_check), and one decode step at 12 rows on a bf16 cache
   (decode_attention without its wo) against the plain versions;
10. generation — GPT-2-small (seed 0) through decoder.generate_scan, greedy
   and with TemperatureSampler(0.8), TopKSampler(50, 0.8) and
   TopPSampler(0.9, 0.8) (seed 1): 256 steps after phase 4's prompt in a
   768-position cache, captured as one CUDA graph and replayed, each equal
   to the same steps run eagerly with the same seed, with host ms a step
   and tokens/s captured and eager, device ms a step (profiler) and the
   idle share, and 32 teacher-forced steps in which the card's choice on
   the logits and noise equals the stream and the host's choice; the
   Qwen2-0.5B shape with TopPSampler(0.9, 0.7), 128 steps; speculative
   decoding with K 4 against the target itself (every round K+1 until the
   stream leaves the plain greedy one) and a 2-layer draft at GPT-2's
   widths (seed 2), greedy and at temperature 1e-4, each against the plain
   greedy stream under the top-2 rule, with acceptance and host ms per
   emitted token, the rounds (8 a call, one graph replay) captured against
   eager (capture_check), and Generator.with_draft; phase 5's 16 requests through
   the slot and paged engines with TemperatureSampler(0.8): one seed gives
   the same streams twice, temperature 1e-4 the greedy streams;
11. whisper — Whisper-tiny at full width (WHISPER_TINY: random int8 weights
   from seed 0, bf16 activations) through Generator(EncDecBackend(...,
   device="cuda")), int8 KV then bf16 KV: a seeded 30-second mel (1500
   encoder positions) encoded once, the 4 start-of-transcript tokens as
   one prefill, 200 greedy steps in the 448-position cache; time to first
   token, the encoder's device time by kernel, host and device ms a step,
   tokens/s (host ms a step from the backend's second run, reset: each
   step a replay of its captured step), the idle share, one step's
   launches (four GEMVs, the KV kernel, flash attention and the MLP kernel
   a layer, the lm_head GEMV), the step captured against eager
   (capture_check);
   the encoder states and 32 teacher-forced steps through the kernels
   against the plain versions (relative RMS at most WHISPER_GATE, the
   top-2 rule);
12. encoders — the encoders and vision models at full width (random
   weights from seed 0): DistilBERT-base INT8 (8 sequences of seeded
   lengths 32-384 padded to 384; encode, qa_logits, pool) in f32 and in
   bf16, all-MiniLM-L6-v2's widths INT8 (6 layers, 12 heads of 32; 8
   sequences of 32-256 tokens; encode and pool) in f32 and in bf16,
   wav2vec2-base INT8 (4 waveforms of 3-10 s at 16 kHz padded to
   10 s; ctc_logits and the greedy CtcDecoder), ViT-B/16 (classify and
   feature_map), MobileNetV2 INT8 (its two K-24 expands on the kernel)
   and ResNet-50 fp32, 8 images of 224² each: each forward's launches
   by kernel equal to its layers' count with no plain version, host ms
   (median of 7), device ms by kernel, idle share and items a second, its
   output against the same forward through the plain versions (relative
   RMS at most ENCODER_GATE_F32, ENCODER_GATE_BF16 in bf16; QA argmax,
   CTC frames and top-1 classes under the top-2 rule), and ResNet-50's
   and wav2vec2's conv stack's f32 output with both TF32 flags on against
   f64 (ENCODER_F64_GATE); phase 3 adds the kernel modes these take
   (check_encoder_kernels);
13. graph   — the graph runtime: a GPT-2-small decoder graph at full width
   (models.gpt2_graph: 12 layers, d 768, vocab 50257, 1024 positions,
   seed 0, HF-Optimum inputs and outputs, LayerNorm and GELU as the
   primitive patterns the optimizer fuses) through quantize_graph_int8,
   Model(graph) on the card (49 QuantMatMul, 25 LayerNormalization, 12
   Gelu) and GraphBackend in compiled mode: a 64-token prompt and 200
   greedy steps, twice (the first run captures one CUDA graph a bucket:
   the prompt's 64 and the decode buckets 128, 256 and 512), the second
   timed (time to first token, host ms a step, device ms a step and the
   idle share, launches: 49 quant_matmul_int8 for the prompt and 49
   quant_gemv_int8 a step, no plain call); 16 teacher-forced steps through
   the legacy interpret path against the compiled path's logits and
   through the plain versions against the kernels' (relative RMS at most
   GRAPH_GATE, the top-2 rule); a 512-token Model.run forward compiled
   against interpret; phase 3 adds QuantMatMul's kernel calls at the
   graph's widths (check_graph_kernels);
14. files   — model files at full width (drive_files): (a) phase 13's
   int8 graph with its dead f32 constants swept, saved with save_rten and
   loaded by Model.load_file and Model.load_mmap: GraphBackend compiled on
   the file (64-token prompt, 200 greedy steps; 49 quant_matmul_int8, 49
   quant_gemv_int8 a step), its tokens phase 13's, 16 teacher-forced steps
   of logits bit-equal to the in-memory Model's from both loaders; (b) the
   same graph in f32 with the tied head, saved, loaded and lifted by
   backend_for_model(model, n_heads=12) onto NativeBackend (the dense-weight
   route: 12 f32 causal flash_attention at the prompt, 12 decode_attention
   without wo a step, no int8 kernel, no plain call), 200 greedy steps in a
   1024-position cache against GraphBackend on the same file (top-2 rule,
   gap GRAPH_TOP2), 16 teacher-forced steps within GRAPH_GATE of the
   graph's and of the plain versions', time to first token, host and device
   ms a step, the idle share, generate_scan captured for 200 steps equal to
   the eager stream; (c) a two-layer MLP at GPT-2's MLP widths as ONNX
   through python -m rten_tpu_torch.convert --quantize, QuantMatMul on
   quant_matmul_int8 at 64 rows and quant_gemv_int8 at 1 within 1e-4 of
   the plain versions; (d) python -m rten_tpu_torch.cli on (a)'s file, -n 3
   and --mode interpret -t --mmap; (e) a Whisper-tiny-named state lifted by
   backend_for_model onto EncDecBackend (dense f32; a 30-second mel, 4
   start tokens, 32 greedy steps) against the plain versions (GRAPH_GATE,
   top-2 rule); phase 3 adds the lifted path's f32 kernel modes
   (check_file_kernels);
15. text    — text in, text out (drive_text): (a) a GPT-2-style byte-level
   BPE tokenizer of 2000 merges learned from README.md and a WordPiece one
   of 30522 ids over its words, README encoded by the native library and
   the Python path (equal ids), tokens a second; (b) python -m
   rten_tpu_torch.examples.gpt2 --model x.npz --int8 --top-k 1 -n 64 on an
   HF-named GPT-2-small state (seed 0) with README's first paragraph as the
   prompt, through main(argv): its tokens phase 4's greedy stream on the
   same params and ids, its text their decode, the prefill and decode
   kernels launched and no plain call, time to first token, host ms a step
   (the app's and marginal_step_time's), device ms a step, the tokenizer's
   share; (c) gpt2.py on phase 14 (b)'s f32 file: its tokens the lifted
   NativeBackend's; (d) python -m rten_tpu_torch.examples.bert_qa on an
   HF-named BERT-base QA state (seed 0) with the WordPiece tokenizer:
   flash_attention 12 times (f32, not causal), span and answer equal to the
   plain versions', logits within GRAPH_GATE; (e) runtime.profiler.trace
   around (b)'s warm-up: its trace.json names all five kernels of (b); (f)
   the native contour tracer and CTC beam search against the Python paths
   (a 512 x 512 mask, a 500 x 32 matrix);
16. parallel — the Qwen2-0.5B shape (unfused random int8 packs from seed
   0 made on the card) over 2 ranks of parallel.launch.run_ranks (NCCL with
   a card a rank, else gloo, both ranks on one card and every collective
   staged through host memory), after the kernels at the per-rank shapes
   (check_tp_kernels: 7 / 1 heads, q 448, k 64, gate 2432, the f32 wo and
   down partials, the lm_head's 76288 columns; sp_prefill's 512 rows;
   pp_forward's microbatch): (a) a 64-token prompt through tp_prefill and
   63 greedy tp_decode_steps in a 1024-position cache on bf16 KV, then 31
   on int8 KV (each step 24 decode_attention without wo, or
   decode_attention_int8, and 169 GEMVs a rank, no plain call), host and
   device ms a step, and 32
   teacher-forced steps' logits against the one-rank port path on the same
   packs (PAR_GATE, the top-2 rule); (b) phase 9's 8 requests through
   ServingEngine(mesh, tp_mode="shard_map") on bf16 and int8 KV and
   PagedServingEngine(mesh) with bf16 and int8 pages, each stream against
   the one-rank engine's (top-2 rule), ms a forward at 8 rows; (c)
   sp_prefill of 1024 tokens through ring attention against the one-rank
   prefill (logits and every layer's k / v); (d) pp_forward, 2 stages of
   12 layers, dense bf16 weights, 4 x 128 tokens in 2 microbatches, against
   the one-rank dense forward; (e) matmul_allreduce, matmul_reducescatter
   and allgather_matmul at M 64, K 3072 over 2, N 768 (f32) against the
   unfused pair (PAR_OVERLAP_GATE) and ring attention at H 12, D 64, T 1024
   against one-rank causal attention (PAR_RING_GATE); (f) a
   ServingSupervisor over (b)'s bf16 slot engine with a failure on rank 1
   at step 20 and snapshots every 8 steps, its streams (b)'s. One line a
   part: backend, each collective's route, numbers, the card. Two ranks
   share one card here: no time of this phase is a scaling figure;
17. apps    — the example apps and the C embedding API (drive_apps): (a)
   python -m rten_tpu_torch.examples.qwen2_chat --model q.npz --int8 -n 64
   on an HF-named state at Qwen2-0.5B's widths (24 layers, d_model 896, 14
   query heads over 2 kv heads, d_ff 4864, vocab 151936, q/k/v biases, the
   tied embedding as lm_head.weight; seed 0) with a README BPE, 2 turns
   through Generator.append_prompt: as shipped (TopKSampler(20, 0.8):
   tokens/s, host and device ms a step, the idle share) and with the
   sampler pinned to TopKSampler(1), whose turns equal a greedy
   Generator(NativeBackend) stream; the decode GEMV, decode_attention:gqa
   (24 a step), quant_matmul_int8 and flash_attention launched, no plain
   call; the first turn teacher-forced through the kernels and the plain
   versions under phase 9's top-2 rule; (b) imagenet.py on a
   torchvision-named ResNet-50 and a 224² PNG against its --cpu run; (c)
   the other 11 apps on their file routes (the tier-1 tests' files) against
   their --cpu runs, then every app's --demo at the JAX demos' widths
   (heads of 16 and 32; gpt2.py also with --int8), none with --cpu; (d) a
   C program through
   librten_embed.so with RTEN_TORCH_DEVICE=cuda against the in-process
   Model and its CPU run;
18. the line {"kernels": [...]} (the launches summed over phases 4-17 and
   phase 16's ranks, a
   captured graph's launches counted at each replay, the
   split-K and split-KV launches also under their own names;
   matmul_fused, which no model calls, launches in phase 3 only, its
   ragged route also under its own name; the head dims other than 64 and
   128 and the pages under 64 positions under name:d<D> and
   name:page<P>), the
   nvidia-smi line, and last the line {"ok": true, "device": {...}}.

Details (every case, the compiler's register report) go to
chiprun_out/chip_smoke.json and chiprun_out/build_log.txt.

Times: a kernel's and the library call's are device times from CUDA events
around replays of a CUDA graph that calls them on enough copies of their
inputs to exceed the 50 MB L2 (each call finds its weights cold, as in the
decode loop and a prefill forward); the plain version's is eager (host time
included). Time to first token is on the host clock, around one
NativeBackend.prefill call and the copy of its token to the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Data-sheet rates by card (NVIDIA): memory bytes/s, dense bf16 tensor-core
# FLOP/s, dense int8 tensor-core OP/s and f32 FLOP/s on the CUDA cores. The
# weight-only kernels' operands are bf16 activations against int8 weights
# (exact in bf16), so bf16 is the type whose peak bounds their operations;
# the W8A8 kernels' are int8; matmul_fused's f32 mode runs f32 FMA, not TF32.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 756e12, 1513e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 1671e12, 60e12),
    ("H200", 4.8e12, 989e12, 1979e12, 67e12),
    ("H100", 3.35e12, 989e12, 1979e12, 67e12),  # SXM (HBM3)
)

N_PROMPT, N_NEW, CACHE_LEN, N_FORCED = 64, 512, 768, 32
TTFT_PROMPTS = (64, 512)


def log(*args):
    print(*args, flush=True)


def card_rates(name: str):
    for key, mem, bf16, int8, f32 in CARD_RATES:
        if key in name:
            return key, mem, bf16, int8, f32
    raise RuntimeError(f"no data-sheet rates for card {name!r}")


class Bound:
    """Least time for a call: max(bytes / memory rate, ops / peak rate), the
    bf16 tensor-core rate, or (``int8``) the int8 one, or (``f32``) the f32
    CUDA-core one."""

    def __init__(self, mem_rate: float, op_rate: float, int8_rate: float, f32_rate: float):
        self.mem_rate, self.op_rate, self.int8_rate, self.f32_rate = mem_rate, op_rate, int8_rate, f32_rate

    def __call__(self, nbytes: float, ops: float, int8: bool = False, f32: bool = False):
        t_mem = nbytes / self.mem_rate * 1e3
        t_ops = ops / (self.int8_rate if int8 else self.f32_rate if f32 else self.op_rate) * 1e3
        return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def graph_ms(torch, calls, reps: int = 20) -> float:
    """Device ms per call: ``calls`` (one closure per input copy) captured
    into one CUDA graph, replayed ``reps`` times between CUDA events."""
    for fn in calls:  # warm-up outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def eager_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def copies_for(per_call_bytes: int, cap: int = 256) -> int:
    """Input copies that make one graph replay touch > 256 MB (5x the L2)."""
    return max(2, min(cap, math.ceil(256e6 / max(per_call_bytes, 1))))


@contextlib.contextmanager
def plain_decoder(decoder):
    """Route the decoder's seven kernel calls to their plain versions, and
    the captured decode paths to their eager steps (the plain versions read
    lengths on the host, which a capture cannot)."""
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import quant_matmul as qm

    plain = dict(quant_gemv_int8=qm.quant_gemv_int8_ref, quant_mlp_int8=qm.quant_mlp_int8_ref,
                 quant_matmul_int8=qm.quant_matmul_int8_ref, quant_matmul_w8a8=qm.quant_matmul_w8a8_ref,
                 decode_attention=da.decode_attention_ref, decode_block=da.decode_block_ref,
                 flash_attention=at.flash_attention_ref, _capturable=lambda *args: False)
    saved = {name: getattr(decoder, name) for name in plain}
    for name, fn in plain.items():
        setattr(decoder, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(decoder, name, fn)


def profile_by_kernel(torch, fn, n: int) -> tuple[dict, dict]:
    """(device µs per call, launches per call) of ``fn`` by kernel name,
    from torch.profiler over ``n`` calls (device-side events: kernels,
    copies, fills)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_kernel, calls = {}, {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
            name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / n
            calls[name] = calls.get(name, 0.0) + evt.count / n
    return by_kernel, calls


def device_us_by_kernel(torch, fn, n: int) -> dict:
    """Device µs per call of ``fn`` by kernel name (``profile_by_kernel``)."""
    return profile_by_kernel(torch, fn, n)[0]


def same_bits(torch, a, b) -> bool:
    """Whether two results (tensors, numbers, nested lists or tuples of
    them) are equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(same_bits(torch, x, y) for x, y in zip(a, b))
    return a == b


# Steps of a captured-against-eager check (capture_check): warm-up (the
# capture), host-timed, then profiled.
CAPTURE_WARM, CAPTURE_TIMED, CAPTURE_PROF = 8, 32, 16


def capture_check(torch, label: str, make, forwards: int = 1, steps=(CAPTURE_WARM, CAPTURE_TIMED, CAPTURE_PROF)):
    """A captured path against its eager run on the same inputs (phases 4,
    5, 9, 10 and 11). ``make()`` sets up a fresh run and returns ``(step,
    result)``: ``step()`` runs one step of it (``forwards`` decode forwards)
    and ``result()`` gives what it produced (tokens, logits, counts). Each
    side runs warm-up steps (on the captured side the capture), then
    host-timed steps, then steps under the profiler (device time); the
    eager side with ``decoder._capturable`` off. The results must be equal
    bit for bit, and the timed steps' launches by kernel mode. Returns
    host and device ms a forward, captured and eager, and the idle shares."""
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder

    warm, timed, prof = steps

    def measure():
        step, result = make()
        for _ in range(warm):
            step()
        torch.cuda.synchronize()
        dispatch.reset_counters()
        t0 = time.perf_counter()
        for _ in range(timed):
            step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / (timed * forwards)
        launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        if any(plain.values()):
            raise AssertionError(f"{label}: plain versions ran: {plain}")
        dev_us = sum(device_us_by_kernel(torch, step, prof).values())
        dev = dev_us / 1e3 / forwards if dev_us > 0 else None
        return result(), launches, host, dev

    got, launches, host_c, dev_c = measure()
    saved = decoder._capturable
    decoder._capturable = lambda *args: False
    try:
        want, eager_launches, host_e, dev_e = measure()
    finally:
        decoder._capturable = saved
    if not same_bits(torch, got, want):
        raise AssertionError(f"{label}: the captured run's results differ from the eager run's")
    if launches != eager_launches:
        raise AssertionError(f"{label}: captured launches {launches} differ from eager {eager_launches}")

    def idle(dev, host):
        return max(0.0, 1.0 - dev / host) if dev else None

    res = dict(host_ms=host_c, device_ms=dev_c, idle_share=idle(dev_c, host_c), eager_host_ms=host_e,
               eager_device_ms=dev_e, eager_idle_share=idle(dev_e, host_e), forwards_per_step=forwards,
               steps=sum(steps), launches=launches)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"  # noqa: E731
    log(f"  {label}: captured = eager bit for bit over {sum(steps)} steps, launches equal; host / device ms a forward "
        f"captured {host_c:.4f} / {fmt(dev_c)} (idle {fmt(res['idle_share'])}), eager {host_e:.4f} / {fmt(dev_e)} "
        f"(idle {fmt(res['eager_idle_share'])})")
    return res


def backend_steps(torch, make_backend, prompt, greedy: bool):
    """``capture_check``'s ``make`` of a backend (``NativeBackend`` or
    ``EncDecBackend``): the prompt as one prefill, then one decode step a
    ``step()``, each fed the last token (greedy: the fused argmax; logits:
    their argmax); ``result()`` is every step's tokens and (logits mode)
    logits."""
    import numpy as np

    def make():
        backend = make_backend()
        first = backend.prefill(np.asarray(prompt, np.int32), greedy=greedy)
        outs = [first]

        def step():
            last = outs[-1] if greedy else outs[-1].argmax(-1).to(torch.int32)
            outs.append(backend.decode(last.cpu().numpy()[:, None], greedy=greedy))

        return step, lambda: torch.stack(outs).cpu()

    return make


def engine_steps(torch, make_engine, specs):
    """``capture_check``'s ``make`` of a serving engine: ``specs`` submitted
    at once, one ``engine.step()`` a ``step()``; ``result()`` is every
    request's stream so far."""
    from rten_tpu_torch.serve import Request

    def make():
        engine = make_engine()
        reqs = [engine.submit(Request(**s)) for s in specs]
        return engine.step, lambda: [list(r.output) for r in reqs]

    return make


def kv_launch_info(torch, fn, entry: str, q, hk: int, cap: int, with_wo: bool = False) -> dict:
    """What a KV kernel case records beside its times: the plan's cluster
    size (``decode_attention.kv_device_plan`` on these operands; None for a
    package without the plan), the wrapper's host µs a call, and the device
    kernels a call launches (profiler over 16 calls; the attention launch,
    with wo also the GEMV: ``expect_launches``). The profiler misses about
    one record in eight of a cluster launch (measured on the H100:
    ``rt::kv_attention_kernel`` at 7 of 8 calls, the GEMV launched beside it
    at 8 of 8; once at fewer than 8 of 16), so
    each kernel's count a call is rounded. A profile whose rounded count is
    not the expected one, while the case's outputs had just matched the
    plain version, is taken again, at most three times; the attempts are
    recorded (``profile_attempts``) and the last profile's count stands, so
    a kernel that launches a wrong number of times in every profile (or has
    none recorded) fails ``one_launch_a_call``."""
    from rten_tpu_torch.kernels import decode_attention as da

    plan = getattr(da, "kv_device_plan", None)
    extra = (int(with_wo),) if entry == "rt_decode_attention" else ()
    expect = 2 if with_wo else 1
    for attempts in range(1, 4):
        _us, calls = profile_by_kernel(torch, fn, 16)
        if sum(round(n) for n in calls.values()) == expect:
            break
    return dict(split=plan(entry, q, hk, cap, *extra) if plan is not None else None, host_us=host_us(torch, fn),
                profile_attempts=attempts,
                launches_per_call=sum(round(n) for n in calls.values()), expect_launches=expect,
                kernel_names=sorted({name.split("<")[0] for name in calls}))


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_tools(torch):
    """Seeded input makers and the case recorder of phase 3: (randn, pack,
    norm_vecs, bf16_err, record, cases)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def pack(n, k):
        qt = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        s = torch.rand(n, generator=gen, device=dev) * (0.04 / 127) + 0.01 / 127
        return qt, s

    def norm_vecs(k):
        return 1.0 + 0.1 * randn(k, dtype=torch.float32), 0.1 * randn(k, dtype=torch.float32)

    def bf16_err(out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-2 * max(1.0, ref.float().abs().max().item())  # one bf16 rounding of the output
        return err, tol

    cases = []

    def record(kernel, shape, err, tol, ms, plain, bnd, library=None, note="", **extra):
        if not (err <= tol):
            raise AssertionError(f"{kernel} {shape}: max |kernel - plain| {err:.3g} > {tol:.3g}")
        t_bound, by = bnd
        case = dict(kernel=kernel, shape=shape, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                    bound_ms=t_bound, bound_by=by, library_ms=library, **extra)
        cases.append(case)
        lib = f"{library:.4f}" if library is not None else "null"
        more = "".join(f"  {k} {v:.2f}" if isinstance(v, float) else f"  {k} {v}" for k, v in extra.items())
        log(f"  {kernel:17s} {shape:28s} err {err:.3g} (tol {tol:.3g})  kernel {ms:.4f} ms  "
            f"plain {plain:.4f} ms  bound {t_bound:.4f} ms ({by})  library {lib} ms{more} {note}")

    return randn, pack, norm_vecs, bf16_err, record, cases


def check_kernels(torch, bound, cfg):
    randn, pack, norm_vecs, bf16_err, record, cases = check_tools(torch)

    check_gemv_kernels(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record)
    torch.cuda.empty_cache()
    check_decode_attention(torch, bound, cfg, randn, pack, bf16_err, record)
    torch.cuda.empty_cache()
    check_prefill_kernels(torch, bound, cfg, randn, pack, bf16_err, record)
    torch.cuda.empty_cache()
    check_kv_kernels(torch, bound, cfg, randn, record)
    torch.cuda.empty_cache()
    check_w8a8_kernels(torch, bound, cfg, randn, pack, norm_vecs, record)
    torch.cuda.empty_cache()
    check_block_kernels(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record)
    torch.cuda.empty_cache()
    check_gqa_kernels(torch, bound, randn, pack, record)
    torch.cuda.empty_cache()
    # The KV kernels at Whisper-tiny's self attention and at phase 5's 16 rows.
    check_kv_kernels(torch, bound, cfg, randn, record, kinds=("decode_attention", "decode_attention_int8"),
                     lens_cases=WHISPER_KV_LENS, h=WHISPER["n_heads"], s_max=WHISPER_TEXT)
    torch.cuda.empty_cache()
    check_kv_kernels(torch, bound, cfg, randn, record, kinds=("decode_attention", *KV_KINDS), lens_cases=KV_LENS_16)
    torch.cuda.empty_cache()
    check_head_dims_and_pages(torch, bound, cfg, randn, pack, record)
    torch.cuda.empty_cache()
    check_encoder_kernels(torch, bound, randn, pack, record)
    torch.cuda.empty_cache()
    check_graph_kernels(torch, bound, randn, pack, record)
    torch.cuda.empty_cache()
    check_file_kernels(torch, bound, randn, record)
    torch.cuda.empty_cache()
    return cases


def check_head_dims_and_pages(torch, bound, cfg, randn, pack, record):
    """The KV kernels' other head dims and pages, each against its plain
    version, timed, with its bound and SDPA, recorded under name:d32 or
    name:page<P>: the four KV kernels at 24 heads of 32 over S 768 (a
    synthetic shape at GPT-2's d_model: the 32 instance; decode_attention
    with its fused wo and without); pages of 16 positions at the Qwen2-0.5B
    shape's 14 / 2 heads of 64 and at Llama-3-8B's 32 / 8 heads of 128, and
    int8 pages of 32 at the latter (the JAX rules' smallest); flash_attention
    above head dim 256 (check_wide_flash). decode_block's 32 instance and
    its narrow rows (8, 4, 2, 1), and flash_attention's at 16, 32, 80 and
    96 are in check_decode_block, check_encoder_kernels and
    check_prefill_kernels."""
    check_wide_flash(torch, bound, randn, record)
    torch.cuda.empty_cache()
    tag = "synthetic 24x32 "
    check_kv_kernels(torch, bound, cfg, randn, record, kinds=("decode_attention", *KV_KINDS),
                     lens_cases=KV_LENS_MODES, h=24, hd=32, suffix=":d32", tag=tag)
    torch.cuda.empty_cache()
    check_gqa_kernels(torch, bound, randn, pack, record, heads=(24, 24), hd=32, kinds=("decode_attention:gqa",),
                      lens_cases=KV_LENS_MODES, tag=tag, suffix=":d32")
    torch.cuda.empty_cache()
    for kind, page in (("paged_decode_attention:gqa", SMALL_PAGE), ("paged_decode_attention_int8:gqa", 32)):
        for heads, hd, tag in (((14, 2), 64, "qwen2 "), ((32, 8), 128, "llama-3-8b ")):
            if kind.startswith("paged_decode_attention_int8") and hd != 128:
                continue  # the JAX int8 rule takes pages of 64 and more at head dim 64
            check_gqa_kernels(torch, bound, randn, pack, record, heads=heads, hd=hd, kinds=(kind,),
                              lens_cases=KV_LENS_MODES, tag=tag, page=page, suffix=f":page{page}")
            torch.cuda.empty_cache()


# flash_attention above head dim 256 (labelled synthetic: no model of the
# repository has such heads; the JAX kernel takes any d): (name, b, hq, hk,
# tq, s, causal, q_offset, per-row kv_len, head dim). Causal GQA at a
# q_offset with kv_len, and not causal with per-row lengths, at 320 and
# 512 (two slices of 256 output columns), and an odd 300.
WIDE_FLASH = [
    (f"synthetic GQA 8/2 Tq=64 q_offset=100 kv_len=164 d={d}", 2, 8, 2, 64, 256, True, 100, (164, 164), d)
    for d in (320, 512)
] + [
    (f"synthetic B=4 Tq=S=197 per-row kv_len d={d}", 4, 8, 8, 197, 197, False, 0, (197, 150, 97, 20), d)
    for d in (320, 512)
] + [("synthetic GQA 8/2 Tq=64 q_offset=100 kv_len=164 d=300", 2, 8, 2, 64, 256, True, 100, (164, 164), 300)]


def check_wide_flash(torch, bound, randn, record):
    """flash_attention at head dims 300, 320 and 512 (WIDE_FLASH) in f32
    and bf16, each against its plain version (own-max tolerance: 1e-4 f32,
    1e-2 bf16), timed, with its bound (the function's work: every block of
    a row tile computes the scores over the whole d again, which the bound
    does not count; f32's six passes at the bf16 rate, f32_flash_extra
    adding the CUDA-core bound, the plan's split and the f64 check) and
    SDPA with the same mask, recorded under flash_attention:d<D>."""
    from rten_tpu_torch.kernels import attention as at

    dev = torch.device("cuda", 0)
    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, hq, hk, tq, s, causal, q_off, lens, hd in WIDE_FLASH:
            def make(i, b=b, hq=hq, hk=hk, tq=tq, s=s, causal=causal, q_off=q_off, lens=lens, hd=hd):
                q = randn(b, hq, tq, hd, scale=1.5, dtype=dtype)
                kc, vc = randn(b, hk, s, hd, scale=1.5, dtype=dtype), randn(b, hk, s, hd, dtype=dtype)
                kw = dict(causal=causal, kv_len=torch.tensor(lens, dtype=torch.int32, device=dev))
                if causal:
                    kw["q_offset"] = torch.full((b,), q_off, dtype=torch.int32, device=dev)
                return (q, kc, vc), kw

            args, kw = make(0)
            out = at.flash_attention(*args, **kw)
            ref = at.flash_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            if not causal:  # query rows past a row's length are padding, unspecified
                valid = torch.arange(tq, device=dev)[None, :] < kw["kv_len"][:, None].long()
                diff = diff.transpose(1, 2)[valid]
            err = diff.max().item()
            tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.float().abs().max().item()
            r = torch.arange(tq)
            pairs = sum(int(torch.clamp(r + q_off + 1, max=n).sum()) if causal else tq * n for n in lens)
            per_call = 2 * nbytes(args[0]) + 2 * hk * sum(lens) * hd * args[0].element_size() + 8 * b
            ops = 4 * hd * hq * pairs
            copies = [make(i) for i in range(copies_for(per_call, cap=32))]
            ms = graph_ms(torch, [lambda a=a, kw=kw: at.flash_attention(*a, **kw) for a, kw in copies])
            plain = eager_ms(torch, lambda: at.flash_attention_ref(*args, **kw))
            col = torch.arange(s, device=dev)
            mask = col[None, None, :] < kw["kv_len"][:, None, None].long()  # [B, 1, S]
            if causal:
                mask = mask & (col[None, None, :] <= torch.arange(tq, device=dev)[None, :, None] + q_off)
            lib_kw = dict(attn_mask=mask[:, None], enable_gqa=hq != hk)
            library = graph_ms(torch, [lambda a=a: F.scaled_dot_product_attention(*a, **lib_kw) for a, _ in copies])
            if dtype == torch.float32:
                slices = f32_flash_plan(torch, at, b, hq, hk, tq, s, hd)[0]
                extra = f32_flash_extra(torch, bound, args, kw, out, per_call, ops)
                bnd = bound(per_call, 6 * ops)
            else:
                slices = at.flash_slices(hd)
                extra = dict(route="bf16", split=at.flash_plan(b, hq, hk, tq, s, sms, slices)[1])
                bnd = bound(per_call, ops)
            record("flash_attention", f"{extra['route']} {name} H={hq}/{hk}", err, tol, ms, plain, bnd, library,
                   head_dim=hd, slices=slices, **extra)
            del copies


def gemv_launch_info(torch, fn, m: int, dot: str, phases: tuple, coop: bool = False) -> dict:
    """What a GEMV or MLP case records beside its times: its plan (grid,
    ring slots, resident or not, each phase's K pieces and team; None for a
    package without ``gemv_plan``), the kernels a call launches: the
    launch calls the profiler sees on the host over 16 calls (its device
    records can miss a kernel), which must be one a call, and the device
    kernels' names; and the wrapper's host µs a call."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    plan = None
    if hasattr(qm, "gemv_plan"):
        p = qm.gemv_plan(m, dot, phases, qm.sm_count(0), coop)
        plan = dict(grid=p.grid, slots=p.slots, resident=p.resident, smem=p.smem, cluster=getattr(p, "split", 1),
                    pieces_team=[list(r[:2]) for r in p.phases])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(16):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunch")) / 16
    names = {e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0].split("<")[0]
             for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
    return dict(plan=plan, launches_per_call=round(launches), expect_launches=1, kernel_names=sorted(names),
                host_us=host_us(torch, fn))


def check_gemv_kernels(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record, shapes=None, mlp=True):
    """quant_gemv_int8 and quant_mlp_int8 at 1 and 8 rows: GPT-2-small's
    layer-0 qkv + ln1, lm_head logits and lm_head + argmax, its MLP with the
    next layer's qkv and without (the last layer); the Qwen2-0.5B shape's
    qkv + rmsnorm + bias, w_gu + rmsnorm, w_down + residual and lm_head +
    argmax (N 152576, K 896); Whisper-tiny's at K 384: q|k|v with LayerNorm
    and bias (N 1152), wo with the residual, the lm_head with dec_ln and its
    argmax bounded to 51865 of 51968 columns, and its MLP (D 384, FF 1536,
    no next qkv). Each against its plain version, with its
    bound, its plain time, the time of F.linear on the dequantized bf16
    weights (the MLP: none, no single call), its plan and its launches a
    call (one). ``shapes`` (name, K, N, norm, mode, vocab) replace the
    GEMV cases and ``mlp`` False leaves out the MLP's (phase 16's per-rank
    shapes)."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    bf16, f32 = torch.bfloat16, torch.float32
    F = torch.nn.functional
    d, ff = cfg.d_model, cfg.d_ff
    n_vocab_pad = -(-cfg.vocab_size // 1024) * 1024
    qw, qff, q_vocab = QWEN2["d_model"], QWEN2_CFG["d_ff"], QWEN2_CFG["vocab_size"]
    qkv_n = (QWEN2["n_heads"] + 2 * QWEN2["n_kv_heads"]) * (qw // QWEN2["n_heads"])
    wd = WHISPER["d_model"]
    shapes = shapes or [("qkv+ln1", d, 3 * d, "layernorm", "bias", None),
                  ("lm_head_logits", d, n_vocab_pad, "layernorm", "logits", None),
                  ("lm_head_argmax", d, n_vocab_pad, "layernorm", "argmax", cfg.vocab_size),
                  ("qwen2 qkv+rms", qw, qkv_n, "rmsnorm", "bias", None),
                  ("qwen2 w_gu+rms", qw, 2 * qff, "rmsnorm", "", None),
                  ("qwen2 w_down+res", qff, qw, None, "residual", None),
                  ("qwen2 lm_head_argmax", qw, -(-q_vocab // 1024) * 1024, "rmsnorm", "argmax", q_vocab),
                  ("qwen2 lm_head_logits", qw, -(-q_vocab // 1024) * 1024, "rmsnorm", "logits", None),
                  ("whisper qkv+ln", wd, 3 * wd, "layernorm", "bias", None),
                  ("whisper wo+res", wd, wd, None, "residual", None),
                  ("whisper lm_head_argmax", wd, -(-WHISPER["vocab_size"] // 128) * 128, "layernorm", "argmax",
                   WHISPER["vocab_size"])]
    for m in (1, 8):
        for name, k, n, norm, mode, vocab in shapes:
            def make(i, m=m, k=k, n=n, norm=norm, mode=mode, vocab=vocab):
                qt, s = pack(n, k)
                kw = {}
                if norm:
                    ns, nb = norm_vecs(k)
                    kw.update(norm=norm, norm_scale=ns, norm_bias=nb if norm == "layernorm" else None)
                if mode == "argmax":
                    kw["argmax_n"] = vocab
                if mode == "logits":
                    kw["out_dtype"] = f32
                if mode == "residual":
                    kw["residual"] = randn(m, n)
                bias = 0.1 * randn(n, dtype=f32) if mode == "bias" else None
                return (randn(m, k), qt, s, bias), kw

            args, kw = make(0)
            out = qm.quant_gemv_int8(*args, **kw)
            torch.cuda.synchronize()
            note = ""
            if mode == "argmax":
                logits = qm.quant_gemv_int8_ref(*args, out_dtype=f32, **{a: v for a, v in kw.items()
                                                                        if a != "argmax_n"})[:, :vocab]
                top = logits.max(1).values
                # Kernel and plain sum in other orders: a different token is
                # right only when its plain logit ties the maximum to f32 order.
                err = (top - logits.gather(1, out.long()[:, None])[:, 0]).max().item()
                tol = 1e-5 * max(1.0, top.abs().max().item())
                note = f"(tokens {out.tolist()}, plain {logits.argmax(1).tolist()})"
            else:
                ref = qm.quant_gemv_int8_ref(*args, **kw)
                if mode == "logits":  # f32 logits: a flipped bf16 rounding of one normalised input element
                    err, tol = (out - ref).abs().max().item(), 2e-3 * max(1.0, ref.abs().max().item())
                else:
                    err, tol = bf16_err(out, ref)
            x, qt, s, bias = args
            per_call = nbytes(x, qt, s, bias, kw.get("norm_scale"), kw.get("norm_bias"), kw.get("residual")) + (
                4 * m if mode == "argmax" else m * n * (4 if mode == "logits" else 2))
            copies = [make(i) for i in range(copies_for(per_call))]
            ms = graph_ms(torch, [lambda a=a, k=k: qm.quant_gemv_int8(*a, **k) for a, k in copies])
            plain = eager_ms(torch, lambda: qm.quant_gemv_int8_ref(*args, **kw))
            w_deq = [(c[0][1].float() * c[0][2][:, None]).to(bf16) for c in copies[:copies_for(2 * n * k)]]
            library = graph_ms(torch, [lambda w=w: F.linear(x, w) for w in w_deq])
            record("quant_gemv_int8", f"{name} M={m} N={n} K={k}", err, tol, ms, plain,
                   bound(per_call, 2 * m * n * k), library, note,
                   **gemv_launch_info(torch, lambda: qm.quant_gemv_int8(*args, **kw), m, "bf16",
                                      ((n, k, norm is not None, 2),)))
            del copies, w_deq
        if not mlp:
            continue

        # -- quant_mlp_int8: with the next layer's qkv (layers 0-10) and without
        # -- quant_mlp_int8: with the next layer's qkv (layers 0-10) and
        # without (the last layer); Whisper-tiny's (D 384, FF 1536, never a
        # next qkv).
        for name, md, mff, with_next in (("mlp+next_qkv", d, ff, True), ("mlp (last layer)", d, ff, False),
                                         ("whisper mlp", wd, WHISPER["d_ff"], False)):
            def make(i, m=m, d=md, ff=mff, with_next=with_next):
                wu, su = pack(ff, d)
                wd, sd = pack(d, ff)
                ns, nb = norm_vecs(d)
                nxt = None
                if with_next:
                    wq, sq = pack(3 * d, d)
                    qns, qnb = norm_vecs(d)
                    nxt = (wq, sq, 0.1 * randn(3 * d, dtype=f32), qns, qnb)
                args = (randn(m, d), wu, su, wd, sd, 0.1 * randn(ff, dtype=f32), 0.1 * randn(d, dtype=f32))
                kw = dict(activation="gelu", norm="layernorm", norm_scale=ns, norm_bias=nb,
                          residual=randn(m, d), next_qkv=nxt)
                return args, kw

            args, kw = make(0)
            out, ref = qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw)
            torch.cuda.synchronize()
            outs, refs = (out, ref) if with_next else ((out,), (ref,))
            errs = [bf16_err(o, r) for o, r in zip(outs, refs)]
            err = max(e for e, _ in errs)
            tol = min(t for _, t in errs)
            nxt = kw["next_qkv"] or ()
            per_call = nbytes(*args, kw["norm_scale"], kw["norm_bias"], kw["residual"], *nxt) + 2 * m * (
                md + (3 * md if with_next else 0))
            ops = 2 * m * (2 * md * mff + (3 * md * md if with_next else 0))
            copies = [make(i) for i in range(copies_for(per_call))]
            ms = graph_ms(torch, [lambda a=a, k=k: qm.quant_mlp_int8(*a, **k) for a, k in copies])
            plain = eager_ms(torch, lambda: qm.quant_mlp_int8_ref(*args, **kw))
            phases = ((mff, md, True, 2), (md, mff, False, 4)) + (((3 * md, md, True, 4),) if with_next else ())
            record("quant_mlp_int8", f"{name} M={m} D={md} FF={mff}", err, tol, ms, plain, bound(per_call, ops),
                   **gemv_launch_info(torch, lambda: qm.quant_mlp_int8(*args, **kw), m, "bf16", phases, True))
            del copies


def check_decode_attention(torch, bound, cfg, randn, pack, bf16_err, record):
    """decode_attention at GPT-2-small's attention (12 heads, D 64, S 768),
    kv_len 1 / 300 / 767: the packed-qkv call with its fused wo, and the same
    attention without wo ("decode_attention:no_wo", like for like with
    SDPA), each against its plain version, timed as check_kernels times the
    others, with the plan's cluster size, the wrapper's host µs and the
    kernels a call launches (kv_launch_info)."""
    from rten_tpu_torch.kernels import decode_attention as da

    dev = torch.device("cuda", 0)
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    F = torch.nn.functional
    # q and k at std 1.5 give scores q.k/sqrt(64) of std ~2.3, so the
    # softmax is peaked and a wrong chunk max, combine rescale or dropped
    # chunk moves the output by O(1). Three checks per kv_len: the fused
    # call the decoder makes (bias and residual included); its attention
    # part alone (no bias, no residual), tolerance from that part's own
    # max; and the f32 attention vector itself (an identity W_o at scale 1,
    # so the output is that vector unrounded) against the plain einsum and
    # softmax in f64.
    s_max = CACHE_LEN
    eye_w = torch.eye(d, h * hd, device=dev).to(torch.int8)
    eye_s = torch.ones(d, device=dev)
    for kv_len in (1, 300, 767):
        def make(i, kv_len=kv_len):
            kc = randn(1, h, s_max, hd, scale=1.5)
            vc = randn(1, h, s_max, hd)
            qkv = randn(1, 3, h, 1, hd, scale=1.5)
            wo, wos = pack(d, h * hd)
            lens = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
            return (qkv, kc, vc, lens, wo, wos, 0.1 * randn(d, dtype=torch.float32)), dict(residual=randn(1, d))

        args, kw = make(0)
        qkv, kc, vc, lens, wo, wos, bo = args
        kc0, vc0 = kc.clone(), vc.clone()
        caches = [(kc0.clone(), vc0.clone()) for _ in range(4)]
        out = da.decode_attention(*args, **kw)
        ref = da.decode_attention_ref(qkv, *caches[0], *args[3:], **kw)
        torch.cuda.synchronize()
        if not (torch.equal(kc, caches[0][0]) and torch.equal(vc, caches[0][1])):
            raise AssertionError(f"decode_attention kv_len={kv_len}: caches differ from the plain append")
        err, tol = bf16_err(out, ref)
        part = da.decode_attention(qkv, *caches[1], lens, wo, wos)
        part_ref = da.decode_attention_ref(qkv, *caches[2], lens, wo, wos)
        part_err = (part.float() - part_ref.float()).abs().max().item()
        part_tol = 1e-2 * part_ref.float().abs().max().item()
        if not (part_err <= part_tol):
            raise AssertionError(f"decode_attention kv_len={kv_len}: attention part differs from plain "
                                 f"by {part_err:.3g} > {part_tol:.3g}")
        attn = da.decode_attention(qkv.float(), caches[3][0].float(), caches[3][1].float(), lens,
                                   eye_w, eye_s).double()
        q64 = qkv[0, 0, :, 0].double()
        k64 = torch.cat([kc0[0, :, :kv_len], qkv[0, 1]], 1).double()
        v64 = torch.cat([vc0[0, :, :kv_len], qkv[0, 2]], 1).double()
        p64 = torch.softmax(torch.einsum("hd,hsd->hs", q64, k64) / math.sqrt(hd), -1)
        attn_ref = torch.einsum("hs,hsd->hd", p64, v64).reshape(1, -1)
        attn_err = (attn - attn_ref).abs().max().item()
        attn_tol = 1e-5 * max(1.0, attn_ref.abs().max().item())  # f32 sums in another order
        if not (attn_err <= attn_tol):
            raise AssertionError(f"decode_attention kv_len={kv_len}: f32 attention vector differs from "
                                 f"the f64 softmax by {attn_err:.3g} > {attn_tol:.3g}")
        note = (f"(attention part err {part_err:.3g} tol {part_tol:.3g}; f32 attention vector err "
                f"{attn_err:.3g} tol {attn_tol:.3g}; score std "
                f"{(torch.einsum('hd,hsd->hs', q64, k64) / math.sqrt(hd)).std().item():.2f})")
        prefix = 2 * h * kv_len * hd * 2  # k and v rows < kv_len, read once
        per_call = prefix + nbytes(qkv, wo, wos, bo, kw["residual"], lens) + 2 * h * hd * 2 + d * 2
        ops = 4 * h * (kv_len + 1) * hd + 2 * h * hd * d
        copies = [make(i) for i in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda a=a, k=k: da.decode_attention(*a, **k) for a, k in copies])
        plain_args = (qkv, kc0.clone(), vc0.clone(), *args[3:])
        plain = eager_ms(torch, lambda: da.decode_attention_ref(*plain_args, **kw))
        lib_inputs = [(c[0][0][:, 0].view(1, h, 1, hd), c[0][1][:, :, : kv_len + 1],
                       c[0][2][:, :, : kv_len + 1]) for c in copies]
        library = graph_ms(torch, [lambda t=t: F.scaled_dot_product_attention(*t) for t in lib_inputs])
        record("decode_attention", f"kv_len={kv_len} S={s_max} H={h} D={hd}", err, tol, ms, plain,
               bound(per_call, ops), library, note,
               **kv_launch_info(torch, lambda: da.decode_attention(*args, **kw), "rt_decode_attention",
                                qkv[:, 0, :, 0], h, s_max, with_wo=True))
        # The same attention without wo: the attention vector, like for like with SDPA.
        nw_args = (qkv, kc0.clone(), vc0.clone(), lens)
        nw_plain_args = (qkv, kc0.clone(), vc0.clone(), lens)
        nw = da.decode_attention(*nw_args)
        nw_ref = da.decode_attention_ref(*nw_plain_args)
        torch.cuda.synchronize()
        if not (torch.equal(nw_args[1], nw_plain_args[1]) and torch.equal(nw_args[2], nw_plain_args[2])):
            raise AssertionError(f"decode_attention:no_wo kv_len={kv_len}: caches differ from the plain append")
        nw_err = (nw.float() - nw_ref.float()).abs().max().item()
        nw_tol = 1e-2 * nw_ref.float().abs().max().item()  # one bf16 rounding of the output
        nw_ms = graph_ms(torch, [lambda c=c: da.decode_attention(*c[0][:4]) for c in copies])
        nw_plain = eager_ms(torch, lambda: da.decode_attention_ref(*nw_plain_args))
        nw_per_call = prefix + nbytes(qkv, lens) + 2 * h * hd * 2 + h * hd * 2
        record("decode_attention:no_wo", f"MHA kv_len={kv_len} S={s_max} H={h} D={hd}", nw_err, nw_tol, nw_ms,
               nw_plain, bound(nw_per_call, 4 * h * (kv_len + 1) * hd), library,
               **kv_launch_info(torch, lambda: da.decode_attention(*nw_args), "rt_decode_attention",
                                qkv[:, 0, :, 0], h, s_max))
        del copies, lib_inputs, caches


def w8_err(out, ref, code=0.0):
    """A W8A8 kernel's output against its plain version's: both sum the
    same codes exactly and round after each epilogue product, so they agree
    to one bf16 rounding of the output (2^-7 of its max) and 1e-6 of it
    (GELU's exp), plus ``code`` where a norm runs first."""
    import torch

    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return err, (2.0**-7 * top if out.dtype == torch.bfloat16 else 0.0) + 1e-6 * max(1.0, top) + code


def check_w8a8_kernels(torch, bound, cfg, randn, pack, norm_vecs, record):
    """The W8A8 kernels against their plain versions at GPT-2-small's shapes
    (bf16 activations), timed as check_kernels times the others, bounded at
    the int8 tensor-core rate. The codes and scales of quantize_rows_int8
    must equal the plain version's bit for bit. The outputs: both sum the
    same codes exactly and round after each epilogue product, so they agree
    to one bf16 rounding of the output (2^-7 of its max) and 1e-6 of it
    (GELU's exp), plus, where a norm runs first, one activation code's
    contribution (max(scale) · absmax of the normalized rows), since the
    kernel's norm and PyTorch's round in other orders and may move a code
    by one. The library yardstick is torch._int_mm on the same codes (the
    s32 product alone, which needs M > 16); none for the GEMV and MLP."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    d = cfg.d_model

    # -- quantize_rows_int8: the prefill's activations, codes bit for bit ---
    for m in (64, 512):
        x = randn(m, d)
        codes, sx = qm.quantize_rows_int8(x)
        ref_codes, ref_sx = qm.quantize_rows_int8_ref(x)
        torch.cuda.synchronize()
        if not (torch.equal(codes, ref_codes) and torch.equal(sx, ref_sx)):
            raise AssertionError(f"quantize_rows_int8 M={m}: codes or sx differ from the plain version's")
        per_call = nbytes(x) + m * d + 4 * m
        copies = [randn(m, d) for _ in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda c=c: qm.quantize_rows_int8(c) for c in copies])
        plain = eager_ms(torch, lambda: qm.quantize_rows_int8_ref(x))
        record("quantize_rows_int8", f"M={m} K={d}", 0.0, 0.0, ms, plain, bound(per_call, 0), None,
               "(codes and sx bit for bit)")
        del copies

    check_w8a8_decode(torch, bound, cfg, randn, pack, norm_vecs, record)
    check_w8a8_matmul(torch, bound, cfg, randn, pack, record)


def check_w8a8_decode(torch, bound, cfg, randn, pack, norm_vecs, record):
    """The W8A8 modes of the decode GEMV and MLP at GPT-2-small's shapes
    and 1 and 8 rows, as check_w8a8_kernels holds them (tolerances there),
    each with its plan and launches a call (one)."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    f32 = torch.float32
    d, ff = cfg.d_model, cfg.d_ff
    n_vocab_pad = -(-cfg.vocab_size // 1024) * 1024

    def code(scales, rows):  # one activation code's largest contribution
        return scales.max().item() * rows.float().abs().max().item()

    def normed(x, kw):
        return qm._norm_rows_f32(x.float(), kw["norm"], 1e-5, kw["norm_scale"], kw["norm_bias"])

    # -- quant_gemv_int8 w8a8: layer-0 qkv + ln1, wo + residual, lm_head + argmax
    for m in (1, 8):
        for name, n, mode in (("qkv+ln1", 3 * d, "qkv"), ("wo+residual", d, "wo"),
                              ("lm_head_argmax", n_vocab_pad, "argmax")):
            def make(i, m=m, n=n, mode=mode):
                qt, s = pack(n, d)
                kw = dict(w8a8=True)
                if mode != "wo":
                    ns, nb = norm_vecs(d)
                    kw.update(norm="layernorm", norm_scale=ns, norm_bias=nb)
                if mode == "wo":
                    kw["residual"] = randn(m, n)
                if mode == "argmax":
                    kw["argmax_n"] = cfg.vocab_size
                bias = None if mode == "argmax" else 0.1 * randn(n, dtype=f32)
                return (randn(m, d), qt, s, bias), kw

            args, kw = make(0)
            out = qm.quant_gemv_int8(*args, **kw)
            torch.cuda.synchronize()
            c = code(args[2], normed(args[0], kw)) if mode != "wo" else 0.0
            note = ""
            if mode == "argmax":
                logits = qm.quant_gemv_int8_ref(*args, out_dtype=f32, **{k: v for k, v in kw.items()
                                                                         if k != "argmax_n"})
                valid = logits[:, : cfg.vocab_size]
                top = valid.max(1).values
                # A different token is right only where its plain logit is
                # within one code's contribution of the maximum.
                err = (top - valid.gather(1, out.long()[:, None])[:, 0]).max().item()
                tol = c + 1e-5 * max(1.0, top.abs().max().item())
                note = f"(tokens {out.tolist()}, plain {valid.argmax(1).tolist()})"
            else:
                err, tol = w8_err(out, qm.quant_gemv_int8_ref(*args, **kw), c)
            x, qt, s, bias = args
            per_call = nbytes(x, qt, s, bias, kw.get("norm_scale"), kw.get("norm_bias"), kw.get("residual")) + (
                4 * m if mode == "argmax" else 2 * m * n)
            copies = [make(i) for i in range(copies_for(per_call))]
            ms = graph_ms(torch, [lambda a=a, k=k: qm.quant_gemv_int8(*a, **k) for a, k in copies])
            plain = eager_ms(torch, lambda: qm.quant_gemv_int8_ref(*args, **kw))
            record("quant_gemv_int8:w8a8", f"{name} M={m} N={n} K={d}", err, tol, ms, plain,
                   bound(per_call, 2 * m * n * d, int8=True), None, note,
                   **gemv_launch_info(torch, lambda: qm.quant_gemv_int8(*args, **kw), m, "s8",
                                      ((n, d, mode != "wo", 2),)))
            del copies

    # -- quant_mlp_int8 w8a8: with the next layer's qkv and without ---------
    for m in (1, 8):
        for name, with_next in (("mlp+next_qkv", True), ("mlp (last layer)", False)):
            def make(i, m=m, with_next=with_next):
                wu, su = pack(ff, d)
                wd, sd = pack(d, ff)
                ns, nb = norm_vecs(d)
                nxt = None
                if with_next:
                    wq, sq = pack(3 * d, d)
                    qns, qnb = norm_vecs(d)
                    nxt = (wq, sq, 0.1 * randn(3 * d, dtype=f32), qns, qnb)
                args = (randn(m, d), wu, su, wd, sd, 0.1 * randn(ff, dtype=f32), 0.1 * randn(d, dtype=f32))
                kw = dict(activation="gelu", norm="layernorm", norm_scale=ns, norm_bias=nb,
                          residual=randn(m, d), next_qkv=nxt, w8a8=True)
                return args, kw

            args, kw = make(0)
            out, ref = qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw)
            torch.cuda.synchronize()
            x, wu, su, wd, sd, bu, bd = args
            xn = normed(x, kw)
            up = qm.quant_gemv_int8_ref(xn, wu, su, bu, activation="gelu", w8a8=True)
            c = code(su, xn) + code(sd, up)
            if with_next:
                wq, sq, _bq, qns, qnb = kw["next_qkv"]
                c_qkv = 2 * c + code(sq, qm._norm_rows_f32(ref[0].float(), "layernorm", 1e-5, qns, qnb))
                errs = [w8_err(out[0], ref[0], c), w8_err(out[1], ref[1], c_qkv)]
            else:
                errs = [w8_err(out, ref, c)]
            worst = max(errs, key=lambda et: et[0] / et[1])
            nxt = kw["next_qkv"] or ()
            per_call = nbytes(*args, kw["norm_scale"], kw["norm_bias"], kw["residual"], *nxt) + 2 * m * (
                d + (3 * d if with_next else 0))
            ops = 2 * m * (2 * d * ff + (3 * d * d if with_next else 0))
            copies = [make(i) for i in range(copies_for(per_call))]
            ms = graph_ms(torch, [lambda a=a, k=k: qm.quant_mlp_int8(*a, **k) for a, k in copies])
            plain = eager_ms(torch, lambda: qm.quant_mlp_int8_ref(*args, **kw))
            phases = ((ff, d, True, 2), (d, ff, False, 4)) + (((3 * d, d, True, 4),) if with_next else ())
            record("quant_mlp_int8:w8a8", f"{name} M={m} D={d} FF={ff}", *worst, ms, plain,
                   bound(per_call, ops, int8=True),
                   **gemv_launch_info(torch, lambda: qm.quant_mlp_int8(*args, **kw), m, "s8", phases, True))
            del copies



def check_w8a8_matmul(torch, bound, cfg, randn, pack, record):
    """quant_matmul_w8a8 at the prefill projections of GPT-2-small (a
    layer's four, with GELU on the up one) and of the Qwen2-0.5B shape (qkv
    with its bias, w_gu, w_down) at 64 and 512 prompt rows, and 2048^3,
    against its plain version and bit for bit against the two-launch pair
    (quantize_rows_int8, then quant_matmul_w8a8_codes). Its time (ms) is one
    call of the wrapper (one launch; a parent package's wrapper, under
    --package, launched the pair); ``pair_ms`` is the pair's two launches;
    ``matmul_ms`` the pair's matmul launch alone on the same codes, the
    like-for-like time beside torch._int_mm's; with the plan (split-K, and
    the one-launch layout), the launches a call by kernel and the wrapper's
    host µs a call."""
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.kernels import quant_matmul as qm

    f32 = torch.float32
    d, ff = cfg.d_model, cfg.d_ff
    qw = QWEN2["d_model"]
    qkv_n = (QWEN2["n_heads"] + 2 * QWEN2["n_kv_heads"]) * (qw // QWEN2["n_heads"])
    shapes = []
    for m in (64, 512):
        shapes += [(f"qkv M={m}", m, 3 * d, d, None, True), (f"wo M={m}", m, d, d, None, True),
                   (f"up+gelu M={m}", m, ff, d, "gelu", True), (f"down M={m}", m, d, ff, None, True)]
    shapes.append(("2048^3", 2048, 2048, 2048, None, False))
    for m in (64, 512):
        shapes += [(f"qwen2 qkv M={m}", m, qkv_n, qw, None, True), (f"qwen2 w_gu M={m}", m, 10240, qw, None, False),
                   (f"qwen2 w_down M={m}", m, qw, QWEN2_CFG["d_ff"], None, False)]
    for name, m, n, k, act, with_bias in shapes:
        def make(i, m=m, n=n, k=k, act=act, with_bias=with_bias):
            qt, s = pack(n, k)
            return (randn(m, k), qt, s, 0.1 * randn(n, dtype=f32) if with_bias else None), dict(activation=act)

        args, kw = make(0)
        x, qt, s, bias = args

        def pair(a, kw):
            return qm.quant_matmul_w8a8_codes(*qm.quantize_rows_int8(a[0]), *a[1:], out_dtype=a[0].dtype, **kw)

        before = dict(dispatch.LAUNCHES)
        out = qm.quant_matmul_w8a8(*args, **kw)
        per_call_launches = {key: v - before.get(key, 0) for key, v in dispatch.LAUNCHES.items()
                             if key in ("quant_matmul_w8a8", "quantize_rows_int8") and v != before.get(key, 0)}
        torch.cuda.synchronize()
        if not torch.equal(out, pair(args, kw)):
            raise AssertionError(f"quant_matmul_w8a8 {name}: the one call differs from the two-launch pair's bits")
        err, tol = w8_err(out, qm.quant_matmul_w8a8_ref(*args, **kw))
        per_call = nbytes(x, qt, s, bias) + 2 * m * n
        copies = [make(i) for i in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda a=a, kw=kw: qm.quant_matmul_w8a8(*a, **kw) for a, kw in copies])
        pair_ms = graph_ms(torch, [lambda a=a, kw=kw: pair(a, kw) for a, kw in copies])
        plain = eager_ms(torch, lambda: qm.quant_matmul_w8a8_ref(*args, **kw))
        codes = [qm.quantize_rows_int8(c[0][0]) for c in copies]
        matmul_ms = graph_ms(torch, [lambda c=c, a=a: qm.quant_matmul_w8a8_codes(*c, *a[0][1:], out_dtype=x.dtype,
                                                                                 **kw)
                                     for c, a in zip(codes, copies)])
        lib_in = [(c[0], a[0][1].t()) for c, a in zip(codes, copies)]
        library = graph_ms(torch, [lambda t=t: torch._int_mm(*t) for t in lib_in])
        plan = qm.w8a8_device_plan(x, n)
        layout = dict(stages=plan.stages, slots=plan.slots, resident=plan.resident) if hasattr(plan, "slots") else {}
        record("quant_matmul_w8a8", f"{name} N={n} K={k}", err, tol, ms, plain,
               bound(per_call, 2 * m * n * k, int8=True), library, pair_ms=pair_ms, matmul_ms=matmul_ms,
               split=plan[2], **layout, launches_a_call=per_call_launches,
               host_us=host_us(torch, lambda: qm.quant_matmul_w8a8(*args, **kw)))
        del copies, codes, lib_in


# decode_block's blocks: (query heads, kv heads) at d_model 768, FF 3072,
# head dim 64; GPT-2-small's (packed q|k|v) and tiny_starcoder_py's (MQA,
# unpacked; the next qkv N (12 + 2) x 64 = 896).
# (query heads, kv heads[, head dim]): GPT-2-small's and tiny_starcoder_py's
# blocks at head dim 64, and (labelled synthetic) 24 heads of 32 at GPT-2's
# d_model, decode_block's 32 instance, and 16 query heads of 8, 4, 2 and 1
# (over 4 or 16 kv heads), its narrow rows on the 16 instance.
BLOCK_SHAPES = {"gpt2": (12, 12), "starcoder": (12, 1), "synthetic 24x32": (24, 24, 32),
                "synthetic 16/4x8": (16, 4, 8), "synthetic 16/4x4": (16, 4, 4), "synthetic 16x2": (16, 16, 2),
                "synthetic 16x1": (16, 16, 1)}


def block_waits(torch, fn, grid: int, reps: int = 5) -> dict:
    """decode_block's %globaltimer stamps (``decode_block_timed``; their order in
    csrc/decode_block.cu decode_block_kernel), in us, the median over
    blocks and then over ``reps`` launches: each grid-wide wait's cost
    (from the last block's arrival to each block's release), the attention
    phase (entry to done) and its first item's arrival, and for each GEMV
    phase (wo, up, down, next qkv) its operand row's time after the wait,
    its first weights' arrival after entry, and its dots and epilogue once
    both are in. A phase the launch does not run reads 0."""
    from rten_tpu_torch.kernels import decode_attention as da

    stamps = torch.zeros((grid, da.BLOCK_STAMPS), dtype=torch.int64, device="cuda")
    runs = []
    for _ in range(reps):
        stamps.zero_()
        fn(stamps)
        torch.cuda.synchronize()
        s = stamps.cpu().double() / 1e3
        rel = s - s[:, :1]

        def med(values):
            values = [v for v in values if v == v]
            return statistics.median(values) if values else 0.0

        def ok(col):
            return s[:, col] > 0

        r = dict(attention_us=med(rel[:, 2].tolist()), first_item_us=med(rel[ok(1), 1].tolist()))
        r["waits_us"] = [med((s[ok(i + 1), i + 1] - s[:, i].max()).tolist()) if bool(ok(i + 1).any()) else 0.0
                         for i in (2, 6, 10, 14)]
        r["row_us"] = [med((s[ok(b + 1), b + 1] - s[ok(b + 1), b]).tolist()) for b in (3, 7, 11, 15)]
        r["weights_at_us"] = [med(rel[ok(b + 2), b + 2].tolist()) for b in (3, 7, 11, 15)]
        r["dots_us"] = [med((s[ok(b + 2), b + 3] - torch.maximum(s[ok(b + 2), b + 1], s[ok(b + 2), b + 2])).tolist())
                        for b in (3, 7, 11, 15)]
        runs.append(r)
    out = {}
    for key, val in runs[0].items():
        if isinstance(val, list):
            out[key] = [round(statistics.median(r[key][i] for r in runs), 3) for i in range(len(val))]
        else:
            out[key] = round(statistics.median(r[key] for r in runs), 3)
    return out


def check_decode_block(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record, shapes=tuple(BLOCK_SHAPES)):
    """decode_block at the blocks of BLOCK_SHAPES (kv_len 1 / 300 / 767 of S
    768, with and without the next qkv) against its plain version, beside
    the time of the two kernels it replaces on the same inputs
    (decode_attention with its fused wo, then quant_mlp_int8), and, where
    the package has ``decode_block_timed``, the cost of its grid-wide
    waits (block_waits)."""
    import inspect

    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import quant_matmul as qm

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    d, ff, hd, s_max = cfg.d_model, cfg.d_ff, cfg.head_dim, CACHE_LEN
    params = inspect.signature(da.decode_block).parameters
    stamped = hasattr(da, "decode_block_timed")
    if "qkv" not in params:  # an older package's decode_block: packed MHA only
        shapes = [sh for sh in shapes if BLOCK_SHAPES[sh][0] == BLOCK_SHAPES[sh][1]]

    # -- decode_block: the whole layer (and the next layer's qkv) in one launch
    for shape in shapes:
        h, hk, *rest = BLOCK_SHAPES[shape]
        hd = rest[0] if rest else cfg.head_dim
        name = ("decode_block" if h == hk else "decode_block:gqa") if hd == 64 else f"decode_block:d{hd}"
        nq = (h + 2 * hk) * hd
        for kv_len in (1, 300, 767) if hd == 64 else (300, 767):
            for with_next in (True, False) if hd == 64 else (True,):
                def make(i, kv_len=kv_len, with_next=with_next):
                    kc, vc = randn(1, hk, s_max, hd, scale=1.5), randn(1, hk, s_max, hd)
                    if h == hk:
                        ops = randn(1, 3, h, 1, hd, scale=1.5)
                    else:
                        ops = (randn(1, h, hd, scale=1.5), randn(1, hk, hd, scale=1.5), randn(1, hk, hd))
                    wo, wos = pack(d, h * hd)
                    wu, su = pack(ff, d)
                    wd, sd = pack(d, ff)
                    ns, nb = norm_vecs(d)
                    mlp = (wu, su, wd, sd, 0.1 * randn(ff, dtype=f32), 0.1 * randn(d, dtype=f32), ns, nb)
                    nxt = None
                    if with_next:
                        wq, sq = pack(nq, d)
                        qns, qnb = norm_vecs(d)
                        nxt = (wq, sq, 0.1 * randn(nq, dtype=f32), qns, qnb)
                    lens = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
                    return (ops, kc, vc, lens, wo, wos, 0.1 * randn(d, dtype=f32), randn(1, d), mlp, nxt)

                kw = dict(activation="gelu", norm="layernorm")
                args = make(0)
                p_args = (args[0], args[1].clone(), args[2].clone(), *args[3:])
                out = da.decode_block(*args, **kw)
                ref = da.decode_block_ref(*p_args, **kw)
                torch.cuda.synchronize()
                if not (torch.equal(args[1], p_args[1]) and torch.equal(args[2], p_args[2])):
                    raise AssertionError(f"{name} kv_len={kv_len}: caches differ from the plain append")
                outs, refs = (out, ref) if with_next else ((out,), (ref,))
                errs = [bf16_err(o, r) for o, r in zip(outs, refs)]
                worst = max(errs, key=lambda et: et[0] / et[1])
                ops, kc, vc, lens, wo, wos, bo, resid, mlp, nxt = args
                operands = ops if isinstance(ops, tuple) else (ops,)
                prefix = 2 * hk * kv_len * hd * 2  # k and v rows < kv_len, read once
                per_call = (prefix + nbytes(*operands, lens, wo, wos, bo, resid, *mlp, *(nxt or ()))
                            + 2 * hk * hd * 2 + 2 * d + (2 * nq if with_next else 0))
                ops_n = 4 * h * (kv_len + 1) * hd + 2 * (h * hd * d + 2 * d * ff + (nq * d if with_next else 0))
                copies = [make(i) for i in range(copies_for(per_call, cap=64))]
                ms = graph_ms(torch, [lambda a=a: da.decode_block(*a, **kw) for a in copies])

                def two_kernels(a):  # what the decoder runs without mega: decode_attention, then quant_mlp_int8
                    x = da.decode_attention(*a[:7], residual=a[7])
                    wu, su, wd, sd, bu, bd, ns, nb = a[8]
                    return qm.quant_mlp_int8(x, wu, su, wd, sd, bu, bd, activation="gelu", norm="layernorm",
                                             norm_scale=ns, norm_bias=nb, residual=x, next_qkv=a[9])

                two_ms = graph_ms(torch, [lambda a=a: two_kernels(a) for a in copies])
                plain = eager_ms(torch, lambda: da.decode_block_ref(*p_args, **kw))
                extra = dict(two_kernel_ms=two_ms)
                if stamped and hd == 64:  # the measurement build: bf16, head dim 64
                    extra.update(block_waits(torch, lambda st: da.decode_block_timed(st, *args, **kw),
                                             da.block_grid(0)))
                record(name, f"{'' if hd == 64 else shape + ' '}kv_len={kv_len} "
                       f"{'+next_qkv' if with_next else 'last layer'} S={s_max} Hq={h} Hk={hk} D={d} FF={ff}"
                       + ("" if hd == 64 else f" head_dim={hd}"), *worst, ms, plain, bound(per_call, ops_n), None,
                       f"(decode_attention + quant_mlp_int8 on the same inputs {two_ms:.4f} ms)", **extra)
                del copies


def check_decode_attention_b8(torch, bound, cfg, randn, pack, bf16_err, record):
    """decode_attention at B 8 with mixed lengths (the port's counterpart of
    the TPU kernel's batched mode: one launch for all rows), GPT-2-small's
    attention and wo, against its plain version."""
    from rten_tpu_torch.kernels import decode_attention as da

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    d, h, hd, s_max = cfg.d_model, cfg.n_heads, cfg.head_dim, CACHE_LEN
    F = torch.nn.functional

    # -- decode_attention at B 8, mixed lengths: all rows in one launch ----
    lens_list = KV_LENS["B=8 mixed"]
    b = len(lens_list)

    def make_b8(i):
        wo, wos = pack(d, h * hd)
        return (randn(b, 3, h, 1, hd, scale=1.5), randn(b, h, s_max, hd, scale=1.5), randn(b, h, s_max, hd),
                torch.tensor(lens_list, dtype=torch.int32, device=dev), wo, wos,
                0.1 * randn(d, dtype=f32)), dict(residual=randn(b, d))

    args, kw = make_b8(0)
    p_args = (args[0], args[1].clone(), args[2].clone(), *args[3:])
    out = da.decode_attention(*args, **kw)
    ref = da.decode_attention_ref(*p_args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(args[1], p_args[1]) and torch.equal(args[2], p_args[2])):
        raise AssertionError("decode_attention B=8: caches differ from the plain append")
    err, tol = bf16_err(out, ref)
    prefix = sum(lens_list)
    per_call = 2 * h * prefix * hd * 2 + nbytes(*args, kw["residual"]) - nbytes(args[1], args[2]) + b * d * 2 + (
        2 * b * h * hd * 2)
    ops = sum(4 * h * (n + 1) * hd for n in lens_list) + 2 * b * h * hd * d
    copies = [make_b8(i) for i in range(copies_for(per_call, cap=64))]
    ms = graph_ms(torch, [lambda a=a, k=k: da.decode_attention(*a, **k) for a, k in copies])
    plain = eager_ms(torch, lambda: da.decode_attention_ref(*p_args, **kw))
    valid = max(lens_list) + 1
    mask = (torch.arange(valid, device=dev)[None, :] <= torch.tensor(lens_list, device=dev)[:, None])[:, None, None, :]
    lib_in = [(c[0][0][:, 0], c[0][1][:, :, :valid], c[0][2][:, :, :valid]) for c in copies[:8]]
    library = graph_ms(torch, [lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=mask) for t in lib_in])
    record("decode_attention", f"B=8 mixed (1-767) S={s_max} H={h} D={hd}", err, tol, ms, plain,
           bound(per_call, ops), library, "(the TPU kernel's batched mode: one launch for all rows)",
           **kv_launch_info(torch, lambda: da.decode_attention(*args, **kw), "rt_decode_attention",
                            args[0][:, 0, :, 0], h, s_max, with_wo=True))
    del copies, lib_in


def check_block_kernels(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record):
    """The whole-block kernel, the dense matmul and the later epilogue and
    attention cases against their plain versions, timed as check_kernels
    times the others: decode_block (check_decode_block), matmul_fused
    (check_matmul_fused), the silu / sigmoid / tanh epilogues of
    quant_matmul_int8 and quant_matmul_w8a8 at the up shape, M 64, and
    decode_attention at B 8 with mixed lengths (check_decode_attention_b8)."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    bf16, f32 = torch.bfloat16, torch.float32
    d, ff = cfg.d_model, cfg.d_ff
    F = torch.nn.functional

    check_decode_block(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record)
    check_decode_attention_b8(torch, bound, cfg, randn, pack, bf16_err, record)

    # -- the silu / sigmoid / tanh epilogues at the up shape, M 64 ---------
    m = 64
    for act in ("silu", "sigmoid", "tanh"):
        for name, fn, ref_fn in (("quant_matmul_int8", qm.quant_matmul_int8, qm.quant_matmul_int8_ref),
                                 ("quant_matmul_w8a8", qm.quant_matmul_w8a8, qm.quant_matmul_w8a8_ref)):
            def make_up(i):
                qt, sc = pack(ff, d)
                return randn(m, d), qt, sc, 0.1 * randn(ff, dtype=f32)

            args = make_up(0)
            out, ref = fn(*args, activation=act), ref_fn(*args, activation=act)
            torch.cuda.synchronize()
            w8 = name.endswith("w8a8")
            if w8:  # the same codes summed exactly; one bf16 rounding and the epilogue's exp apart
                top = ref.float().abs().max().item()
                err, tol = (out.float() - ref.float()).abs().max().item(), 2.0**-7 * top + 1e-6 * max(1.0, top)
            else:
                err, tol = bf16_err(out, ref)
            per_call = nbytes(*args) + 2 * m * ff
            copies = [make_up(i) for i in range(copies_for(per_call))]
            ms = graph_ms(torch, [lambda a=a: fn(*a, activation=act) for a in copies])
            plain = eager_ms(torch, lambda: ref_fn(*args, activation=act))
            if w8:
                lib_in = [(qm.quantize_rows_int8(c[0])[0], c[1].t()) for c in copies]
                library = graph_ms(torch, [lambda t=t: torch._int_mm(*t) for t in lib_in])
            else:
                lib_in = [(c[0], (c[1].float() * c[2][:, None]).to(bf16), c[3].to(bf16)) for c in copies[:4]]
                library = graph_ms(torch, [lambda t=t: F.linear(*t) for t in lib_in])
            record(name, f"up+{act} M={m} N={ff} K={d}", err, tol, ms, plain,
                   bound(per_call, 2 * m * ff * d, int8=w8), library,
                   **({} if w8 else {"split": qm.device_plan(args[0], ff)[1]}))
            del copies, lib_in

    check_matmul_fused(torch, bound, cfg, randn, bf16_err, record)


def check_matmul_fused(torch, bound, cfg, randn, bf16_err, record):
    """matmul_fused against its plain version on its three routes: the
    wgmma route (512 x 768 x 3072 bf16 + GELU, the up projection's shape
    dense; 2048^3 bf16), the ragged route (the same two with N 3070 and K
    2046, rows TMA cannot address) and the f32 route (1024^3, against the
    f32 CUDA-core rate); library yardstick torch.addmm (torch.mm without a
    bias), without the activation; with each call's route, split-K plan and
    the wrapper's host µs a call."""
    from rten_tpu_torch.kernels import matmul as mf

    bf16, f32 = torch.bfloat16, torch.float32
    d, ff = cfg.d_model, cfg.d_ff
    for label, mm, kk, nn, dtype, act, with_bias in (
            ("512x768x3072 bf16+gelu", 512, d, ff, bf16, "gelu", True),
            ("2048^3 bf16", 2048, 2048, 2048, bf16, None, False),
            ("1024^3 f32", 1024, 1024, 1024, f32, None, False),
            ("512x768x3070 bf16+gelu", 512, d, ff - 2, bf16, "gelu", True),
            ("2048x2046x2048 bf16", 2048, 2046, 2048, bf16, None, False)):
        def make_mf(i, mm=mm, kk=kk, nn=nn, dtype=dtype, with_bias=with_bias):
            x = randn(mm, kk, dtype=dtype)
            w = randn(kk, nn, scale=kk**-0.5, dtype=dtype)
            return x, w, 0.1 * randn(nn, dtype=f32) if with_bias else None

        args = make_mf(0)
        out = mf.matmul_fused(*args, activation=act)
        ref = mf.matmul_fused_ref(*args, activation=act)
        torch.cuda.synchronize()
        if dtype == f32:  # exact f32 products (no TF32), f32 sums in another order
            err, tol = (out - ref).abs().max().item(), 1e-5 * max(1.0, ref.abs().max().item())
        else:
            err, tol = bf16_err(out, ref)
        per_call = nbytes(*args) + mm * nn * out.element_size()
        copies = [make_mf(i) for i in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda a=a: mf.matmul_fused(*a, activation=act) for a in copies])
        plain = eager_ms(torch, lambda: mf.matmul_fused_ref(*args, activation=act))
        lib_in = [(c[0], c[1], c[2].to(dtype) if c[2] is not None else None) for c in copies]
        library = graph_ms(torch, [lambda t=t: torch.addmm(t[2], t[0], t[1]) if t[2] is not None
                                   else torch.mm(t[0], t[1]) for t in lib_in])
        route, _bn, split = mf.device_fused_plan(args[0], args[1])
        record("matmul_fused", f"{label} M={mm} K={kk} N={nn}", err, tol, ms, plain,
               bound(per_call, 2 * mm * nn * kk, f32=dtype == f32), library, route=route, split=split,
               host_us=host_us(torch, lambda: mf.matmul_fused(*args, activation=act)))
        del copies, lib_in


KV_LENS = {"B=1 kv_len=1": [1], "B=1 kv_len=300": [300], "B=1 kv_len=767": [767],
           "B=8 mixed": [1, 100, 200, 300, 400, 500, 640, 767]}
# The 16-row engines' decode step (phase 5): 16 rows of mixed lengths.
KV_LENS_16 = {"B=16 mixed": [0, 1, 50, 100, 127, 128, 200, 255, 300, 400, 447, 500, 600, 640, 700, 767]}
# The KV kernels' cases at the head dims and pages beside 64 and 128 (phase
# 3's check_head_dims_and_pages): rows at 300, and 8 rows of mixed lengths.
KV_LENS_MODES = {k: KV_LENS[k] for k in ("B=1 kv_len=300", "B=8 mixed")}
KV_ENTRIES = {"decode_attention": "rt_decode_attention", "decode_attention_int8": "rt_decode_attention_int8",
              "paged_decode_attention": "rt_paged_attention",
              "paged_decode_attention_int8": "rt_paged_attention_int8"}  # each KV kernel's C entry point


KV_KINDS = ("decode_attention_int8", "paged_decode_attention", "paged_decode_attention_int8")


def check_kv_kernels(torch, bound, cfg, randn, record, kinds=KV_KINDS, lens_cases=None, h=None, s_max=CACHE_LEN,
                     hd=None, suffix="", tag=""):
    """The serving path's KV kernels (decode_attention_int8 over an int8
    [B, H, S, D] cache; paged_decode_attention and its int8 twin over pools
    of 128-position pages, each row's pages scattered through the pool; with
    ``"decode_attention"`` in ``kinds``, decode_attention without its wo
    over a bf16 cache) at S ``s_max`` (768) and ``h`` heads of ``hd`` (cfg's)
    for the rows of each of ``lens_cases`` (KV_LENS), against their plain
    versions (recorded under the mode's name plus ``suffix``, each label
    after ``tag``):
    the attention vector (tolerance from its own max), the caches after the
    append bit for bit. Timed as check_kernels times the others; the bound
    counts the valid prefix's payload and scales, the packed qkv and the
    output; the library yardstick is scaled_dot_product_attention over the
    same prefix made contiguous (bf16; a bf16 dequantized copy for int8),
    rows masked to their lengths."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    h, hd, page = h or cfg.n_heads, hd or cfg.head_dim, 128
    per_row = s_max // page
    F = torch.nn.functional
    table = {"decode_attention": (da.decode_attention, da.decode_attention_ref),
             "decode_attention_int8": (da.decode_attention_int8, da.decode_attention_int8_ref),
             "paged_decode_attention": (pa.paged_decode_attention, pa.paged_decode_attention_ref),
             "paged_decode_attention_int8": (pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_ref)}
    for name in kinds:
        kernel, plain = table[name]
        int8, paged = name.endswith("int8"), name.startswith("paged")
        for case, lens_list in (lens_cases or KV_LENS).items():
            b = len(lens_list)

            def make(i, b=b, lens_list=lens_list, int8=int8, paged=paged):
                shape = (b * per_row + 1, h, page, hd) if paged else (b, h, s_max, hd)
                if int8:
                    cache = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                             for _ in range(2)]
                    cache += [0.005 + 0.015 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
                else:
                    cache = [randn(*shape, scale=1.5), randn(*shape)]
                lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
                args = [randn(b, 3, h, 1, hd, scale=1.5), *cache]
                if paged:  # each row's pages scattered through the pool; the last page is spare
                    perm = torch.randperm(b * per_row, generator=gen, device=dev).to(torch.int32)
                    args.append(perm.view(b, per_row).contiguous())
                return args + [lens]

            args = make(0)
            k_args, p_args = [a.clone() for a in args], [a.clone() for a in args]
            out = kernel(*k_args)
            ref = plain(*p_args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-2 * ref.float().abs().max().item()  # one bf16 rounding of the output
            n_cache = 4 if int8 else 2
            if not all(torch.equal(a, p) for a, p in zip(k_args[1 : 1 + n_cache], p_args[1 : 1 + n_cache])):
                raise AssertionError(f"{name} {case}: the caches after the append differ from the plain version's")
            # The contiguous prefix (dequantized to bf16 for int8) per row, for the yardstick.
            lens_t = torch.tensor(lens_list, device=dev)
            valid = int(lens_t.max()) + 1

            def contiguous(args, which):
                kv = args[1 + which]
                if paged:
                    table = args[-2].long()
                    kv = kv[table].permute(0, 2, 1, 3, 4).reshape(b, h, -1, hd)
                    sc = args[3 + which][table].permute(0, 2, 1, 3).reshape(b, h, -1) if int8 else None
                else:
                    sc = args[3 + which] if int8 else None
                kv = kv[:, :, :valid]
                return da.dequantize_kv(kv, sc[:, :, :valid], torch.bfloat16) if int8 else kv

            elt = 1 if int8 else 2
            prefix = sum(lens_list)  # positions read from the cache (the new token comes from qkv)
            per_call = (2 * h * prefix * hd * elt + (2 * h * prefix * 4 if int8 else 0)
                        + nbytes(args[0]) + b * h * hd * 2 + 2 * h * b * hd * elt + 4 * b
                        + (nbytes(args[-2]) if paged else 0))
            ops = sum(4 * h * (n + 1) * hd for n in lens_list)
            copies = [make(i) for i in range(copies_for(per_call, cap=64))]
            ms = graph_ms(torch, [lambda a=a: kernel(*a) for a in copies])
            plain_ms = eager_ms(torch, lambda: plain(*p_args))  # the append is idempotent
            lib_in = []
            for c in copies[:8]:
                q = c[0][:, 0]  # [B, H, 1, D]
                mask = (torch.arange(valid, device=dev)[None, :] <= lens_t[:, None])[:, None, None, :]
                lib_in.append((q, contiguous(c, 0), contiguous(c, 1), mask))
            library = graph_ms(torch, [lambda t=t: F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=t[3])
                                       for t in lib_in])
            record(name + (suffix or (":no_wo" if name == "decode_attention" else "")),
                   f"{tag}{case} S={s_max} H={h} D={hd}" + (f" page={page}" if paged else ""), err, tol, ms,
                   plain_ms, bound(per_call, ops), library,
                   **kv_launch_info(torch, lambda: kernel(*k_args), KV_ENTRIES[name], args[0][:, 0, :, 0], h, s_max))
            del copies, lib_in


QWEN2 = dict(n_heads=14, n_kv_heads=2, d_model=896)  # Qwen2-0.5B's attention (its config.json)


def check_gqa_kernels(torch, bound, randn, pack, record, heads=None, kinds=None, lens_cases=None, tag="", hd=64,
                      page=128, suffix=""):
    """The KV kernels' Llama/Qwen2-class modes at Qwen2-0.5B's attention
    (14 query heads over 2 kv heads, head dim 64, wo 896 x 896) and S 768,
    kv_len 1 / 300 / 767 and 8 rows of mixed lengths: decode_attention on
    unpacked q / k_new / v_new with the fused wo ("decode_attention:gqa")
    and without it ("decode_attention:no_wo"), decode_attention_int8 and
    the paged pair (pages of 128) in their GQA modes, each against its
    plain version (the output, tolerance from its own max; the caches or
    pages after the append bit for bit), timed as check_kernels times the
    others. The bound counts the valid prefix of the 2 kv heads once, the
    operands, the appended token and the output (and W_o); the library
    yardstick is scaled_dot_product_attention(enable_gqa=True) over the
    same prefix made contiguous (a bf16 dequantized copy for int8), rows
    masked to their lengths, without wo. ``heads`` (query heads, kv heads
    at head dim ``hd``), ``kinds`` (a subset of the names), ``lens_cases``
    and ``tag`` (put before each shape label) give phase 16's per-rank
    cases; ``page`` the pages' positions; ``suffix`` replaces the mode's
    ``:gqa`` in the recorded name (the small pages' cases)."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6161)
    hq, hk, dm = QWEN2["n_heads"], QWEN2["n_kv_heads"], QWEN2["d_model"]
    s_max = CACHE_LEN
    if heads is not None:
        hq, hk = heads
    dm = hq * hd
    per_row = s_max // page
    F = torch.nn.functional
    all_kinds = {"decode_attention:gqa": (da.decode_attention, da.decode_attention_ref),
                 "decode_attention:no_wo": (da.decode_attention, da.decode_attention_ref),
                 "decode_attention_int8:gqa": (da.decode_attention_int8, da.decode_attention_int8_ref),
                 "paged_decode_attention:gqa": (pa.paged_decode_attention, pa.paged_decode_attention_ref),
                 "paged_decode_attention_int8:gqa": (pa.paged_decode_attention_int8,
                                                     pa.paged_decode_attention_int8_ref)}
    for name, (kernel, plain) in all_kinds.items():
        if kinds is not None and name not in kinds:
            continue
        int8, paged, with_wo = "int8" in name, name.startswith("paged"), name == "decode_attention:gqa"
        for case, lens_list in (lens_cases or KV_LENS).items():
            b = len(lens_list)

            def make(i, b=b, lens_list=lens_list, int8=int8, paged=paged, with_wo=with_wo):
                shape = (b * per_row + 1, hk, page, hd) if paged else (b, hk, s_max, hd)
                if int8:
                    cache = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                             for _ in range(2)]
                    cache += [0.005 + 0.015 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
                else:
                    cache = [randn(*shape, scale=1.5), randn(*shape)]
                q, kv = randn(b, hq, hd, scale=1.5), randn(b, 2 * hk, hd, scale=1.5)
                args = [(q, kv[:, :hk], kv[:, hk:]), *cache]  # k_new and v_new: views of one tensor
                if paged:  # each row's pages scattered through the pool; the last page is spare
                    perm = torch.randperm(b * per_row, generator=gen, device=dev).to(torch.int32)
                    args.append(perm.view(b, per_row).contiguous())
                args.append(torch.tensor(lens_list, dtype=torch.int32, device=dev))
                kw = {}
                if with_wo:
                    args += [*pack(dm, hq * hd), 0.1 * randn(dm, dtype=torch.float32)]
                    kw["residual"] = randn(b, dm)
                return args, kw

            args, kw = make(0)
            n_cache = 4 if int8 else 2

            def cloned(a):
                return [a[0], *(t.clone() for t in a[1 : 1 + n_cache]), *a[1 + n_cache :]]

            k_args, p_args = cloned(args), cloned(args)
            out = kernel(*k_args, **kw)
            ref = plain(*p_args, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-2 * max(1.0 if with_wo else 0.0, ref.float().abs().max().item())  # one bf16 rounding
            if not all(torch.equal(a, p) for a, p in zip(k_args[1 : 1 + n_cache], p_args[1 : 1 + n_cache])):
                raise AssertionError(f"{name} {case}: the caches after the append differ from the plain version's")
            lens_t = torch.tensor(lens_list, device=dev)
            valid = int(lens_t.max()) + 1

            def contiguous(a, which):
                kv = a[1 + which]
                if paged:
                    table = a[1 + n_cache].long()
                    kv = kv[table].permute(0, 2, 1, 3, 4).reshape(b, hk, -1, hd)
                    sc = a[3 + which][table].permute(0, 2, 1, 3).reshape(b, hk, -1) if int8 else None
                else:
                    sc = a[3 + which] if int8 else None
                kv = kv[:, :, :valid]
                return da.dequantize_kv(kv, sc[:, :, :valid], torch.bfloat16) if int8 else kv

            elt = 1 if int8 else 2
            prefix = sum(lens_list)  # positions read from the cache (the new token comes from the operands)
            per_call = (2 * hk * prefix * hd * elt + (2 * hk * prefix * 4 if int8 else 0) + 2 * b * hq * hd
                        + 2 * 2 * b * hk * hd + 2 * b * hk * hd * elt + 4 * b
                        + (nbytes(args[1 + n_cache]) if paged else 0))
            ops = sum(4 * hq * (n + 1) * hd for n in lens_list)
            if with_wo:
                per_call += nbytes(*args[-3:], kw["residual"]) + 2 * b * dm
                ops += 2 * b * hq * hd * dm
            else:
                per_call += 2 * b * hq * hd
            copies = [make(i) for i in range(copies_for(per_call, cap=64))]
            ms = graph_ms(torch, [lambda a=a, k=k: kernel(*a, **k) for a, k in copies])
            plain_ms = eager_ms(torch, lambda: plain(*p_args, **kw))  # the append is idempotent
            mask = (torch.arange(valid, device=dev)[None, :] <= lens_t[:, None])[:, None, None, :]
            lib_in = [(c[0][0][0][:, :, None], contiguous(c[0], 0), contiguous(c[0], 1)) for c in copies[:8]]
            library = graph_ms(torch, [lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=mask, enable_gqa=True)
                                       for t in lib_in])
            label = f"{tag}{case} S={s_max} Hq={hq} Hk={hk} D={hd}" + (f" page={page}" if paged else "")
            record(name.split(":")[0] + suffix if suffix else name, label, err, tol,
                   ms, plain_ms, bound(per_call, ops), library, "(SDPA without wo)" if with_wo else "",
                   **kv_launch_info(torch, lambda: kernel(*k_args, **kw), KV_ENTRIES[name.split(":")[0]],
                                    args[0][0], hk, s_max, with_wo=with_wo))
            del copies, lib_in


def host_us(torch, fn, n: int = 100) -> float:
    """Host µs a call of ``fn`` (the wrapper's Python, ctypes and launch
    enqueue; the device runs behind), after a synchronised warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def check_prefill_kernels(torch, bound, cfg, randn, pack, bf16_err, record, shapes=None, fa_cases=None):
    """quant_matmul_int8 and flash_attention against their plain versions at
    the prefill paths' shapes (GPT-2-small's, the Qwen2-0.5B shape's and
    Whisper-tiny's encoder and cross attention),
    timed as check_kernels times the others, with each call's launch plan
    (split-K or split-KV cluster size) and the wrapper's host µs a call.
    ``shapes`` and ``fa_cases`` replace the two lists (phase 16's per-rank
    shapes)."""
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import quant_matmul as qm

    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32
    d, ff, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    n_vocab_pad = -(-cfg.vocab_size // 1024) * 1024
    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # -- quant_matmul_int8: a layer's four projections and the f32 lm_head at
    # 64 and 512 prompt rows, a ragged 9 rows, the JAX package's own prefill
    # yardstick, 2048^3 (bench.py:328-362), and the Qwen2-0.5B shape's qkv
    # (with its bias), w_gu (SwiGLU's gate | up, N 9728 padded to 10240) and
    # w_down at 64 and 512 rows.
    qw = QWEN2["d_model"]
    qkv_n = (QWEN2["n_heads"] + 2 * QWEN2["n_kv_heads"]) * (qw // QWEN2["n_heads"])
    if shapes is None:
        shapes = []
        for m in (64, 512):
            shapes += [(f"qkv M={m}", m, 3 * d, d, None, True, bf16),
                       (f"wo M={m}", m, d, d, None, True, bf16),
                       (f"up+gelu M={m}", m, ff, d, "gelu", True, bf16),
                       (f"down M={m}", m, d, ff, None, True, bf16),
                       (f"lm_head_logits M={m}", m, n_vocab_pad, d, None, False, f32)]
        shapes += [("qkv M=9 (ragged)", 9, 3 * d, d, None, True, bf16),
                   ("2048^3", 2048, 2048, 2048, None, False, bf16)]
        for m in (64, 512):
            shapes += [(f"qwen2 qkv M={m}", m, qkv_n, qw, None, True, bf16),
                       (f"qwen2 w_gu M={m}", m, 10240, qw, None, False, bf16),
                       (f"qwen2 w_down M={m}", m, qw, QWEN2_CFG["d_ff"], None, False, bf16)]
        wd, wff, m = WHISPER["d_model"], WHISPER["d_ff"], WHISPER_AUDIO  # Whisper-tiny's encoder, 1500 positions
        shapes += [(f"whisper enc wq M={m}", m, wd, wd, None, True, bf16),
                   (f"whisper enc up+gelu M={m}", m, wff, wd, "gelu", True, bf16),
                   (f"whisper enc down M={m}", m, wd, wff, None, True, bf16)]
    for name, m, n, k, act, with_bias, out_dtype in shapes:
        def make(i, m=m, n=n, k=k, act=act, with_bias=with_bias, out_dtype=out_dtype):
            qt, s = pack(n, k)
            bias = 0.1 * randn(n, dtype=f32) if with_bias else None
            return (randn(m, k), qt, s, bias), dict(activation=act, out_dtype=out_dtype)

        args, kw = make(0)
        out = qm.quant_matmul_int8(*args, **kw)
        ref = qm.quant_matmul_int8_ref(*args, **kw)
        torch.cuda.synchronize()
        if out_dtype == f32:  # exact bf16 x int8 products, f32 sums in another order
            err, tol = (out - ref).abs().max().item(), 1e-4 * max(1.0, ref.abs().max().item())
        else:
            err, tol = bf16_err(out, ref)
        x, qt, s, bias = args
        per_call = nbytes(x, qt, s, bias) + m * n * out.element_size()
        copies = [make(i) for i in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda a=a, kw=kw: qm.quant_matmul_int8(*a, **kw) for a, kw in copies])
        plain = eager_ms(torch, lambda: qm.quant_matmul_int8_ref(*args, **kw))
        lib_w = [((c[0][1].float() * c[0][2][:, None]).to(bf16), None if bias is None else bias.to(bf16))
                 for c in copies[:copies_for(2 * n * k)]]
        library = graph_ms(torch, [lambda w=w: F.linear(x, *w) for w in lib_w])
        record("quant_matmul_int8", f"{name} N={n} K={k}", err, tol, ms, plain,
               bound(per_call, 2 * m * n * k), library,
               split=qm.device_plan(torch.empty(m, k, device=dev, dtype=bf16), n)[1],
               host_us=host_us(torch, lambda: qm.quant_matmul_int8(*args, **kw)))
        del copies, lib_w

    # -- flash_attention: causal over a 768-position cache at the prompts of
    # phase 4 (64 and 512 tokens), a follow-up prompt (24 tokens at q_offset
    # 300) and a chunk of 8; the Qwen2-0.5B shape's GQA (14 query heads over
    # 2 kv heads) over a 1024-position cache at 64, 512 and 24 at 300; GQA
    # and non-causal at small sizes. q and k at std 1.5 give scores of std
    # ~2.3, so the softmax is peaked and a wrong running max, rescale or
    # dropped tile moves the output by O(1). The output is checked alone
    # against its own max; the f32 kernel (the same values in f32) against
    # the softmax in f64.
    qh, qk, wh = QWEN2["n_heads"], QWEN2["n_kv_heads"], WHISPER["n_heads"]
    fa_cases = fa_cases or [  # name, b, hq, hk, tq, s, causal, q_offset, kv_len[, head dim (cfg's)]
        ("Tq=64 kv_len=64", 1, h, h, 64, CACHE_LEN, True, 0, 64),
        ("Tq=512 kv_len=512", 1, h, h, 512, CACHE_LEN, True, 0, 512),
        ("Tq=24 q_offset=300 kv_len=324", 1, h, h, 24, CACHE_LEN, True, 300, 324),
        ("Tq=8 q_offset=300 kv_len=308", 1, h, h, 8, CACHE_LEN, True, 300, 308),
        (f"verify Tq={SPEC_K + 1} q_offset=300 kv_len={300 + SPEC_K + 1}", 1, h, h, SPEC_K + 1, CACHE_LEN, True, 300,
         300 + SPEC_K + 1),
        ("qwen2 Tq=64 kv_len=64", 1, qh, qk, 64, QWEN2_CACHE, True, 0, 64),
        ("qwen2 Tq=512 kv_len=512", 1, qh, qk, 512, QWEN2_CACHE, True, 0, 512),
        ("qwen2 Tq=24 q_offset=300 kv_len=324", 1, qh, qk, 24, QWEN2_CACHE, True, 300, 324),
        ("GQA Hq=12 Hk=4 Tq=100 q_offset=20", 2, h, 4, 100, 256, True, 20, 120),
        ("non-causal Tq=77 kv_len=200", 2, h, h, 77, 256, False, 0, 200),
        # Whisper-tiny: the encoder (not causal over 1500 audio positions, 23
        # tiles of 64 and one of 28) and a decoder token's cross attention.
        ("whisper encoder Tq=1500", 1, wh, wh, WHISPER_AUDIO, WHISPER_AUDIO, False, 0, WHISPER_AUDIO),
        ("whisper cross Tq=1", 1, wh, wh, 1, WHISPER_AUDIO, False, 0, WHISPER_AUDIO),
        ("whisper cross B=8 Tq=1", 8, wh, wh, 1, WHISPER_AUDIO, False, 0, WHISPER_AUDIO),
        # Head dims that run the next instance up with their columns past d
        # zero: Phi-3-mini's 32 heads of 96 and Phi-2's 32 of 80 (their
        # config.json files), a 512-token causal prompt in a 1024-position cache.
        ("phi-3-mini Tq=512 kv_len=512", 1, 32, 32, 512, 1024, True, 0, 512, 96),
        ("phi-2 Tq=512 kv_len=512", 1, 32, 32, 512, 1024, True, 0, 512, 80),
    ]
    cfg_hd = hd
    for name, b, hq, hk, tq, s, causal, q_off, kv_len, *case_hd in fa_cases:
        hd = case_hd[0] if case_hd else cfg_hd

        def make(i, b=b, hq=hq, hk=hk, tq=tq, s=s, causal=causal, q_off=q_off, kv_len=kv_len, hd=hd):
            q = randn(b, hq, tq, hd, scale=1.5)
            kc, vc = randn(b, hk, s, hd, scale=1.5), randn(b, hk, s, hd)
            kw = dict(causal=causal, q_offset=torch.full((b,), q_off, dtype=torch.int32, device=dev),
                      kv_len=torch.full((b,), kv_len, dtype=torch.int32, device=dev))
            # Views of the S-position cache up to the prefix known on the
            # host, as decoder._attention passes them (the plan reads S).
            return (q, kc[:, :, :kv_len], vc[:, :, :kv_len]), kw

        args, kw = make(0)
        q, kc, vc = args
        out = at.flash_attention(*args, **kw)
        ref = at.flash_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-2 * ref.float().abs().max().item()  # one bf16 rounding of P and of the output
        # The f32 kernel against the f64 softmax.
        out32 = at.flash_attention(q.float(), kc.float(), vc.float(), **kw).double()
        g = hq // hk
        k64 = kc[:, :, :kv_len].double().repeat_interleave(g, 1)
        v64 = vc[:, :, :kv_len].double().repeat_interleave(g, 1)
        sc = torch.einsum("bhqd,bhsd->bhqs", q.double(), k64) / math.sqrt(hd)
        score_std = sc.std().item()
        if causal:
            rows = torch.arange(tq, device=dev)[:, None] + q_off
            sc = sc.masked_fill(torch.arange(kv_len, device=dev)[None, :] > rows, -math.inf)
        ref64 = torch.einsum("bhqs,bhsd->bhqd", torch.softmax(sc, -1), v64)
        err64 = (out32 - ref64).abs().max().item()
        tol64 = 1e-5 * ref64.abs().max().item()
        if not (err64 <= tol64):
            raise AssertionError(f"flash_attention {name}: f32 kernel differs from the f64 softmax by "
                                 f"{err64:.3g} > {tol64:.3g}")
        # Work this run's data needs: valid (query, key) pairs, and the K/V
        # prefix read once per KV head.
        r = torch.arange(tq)
        pairs = int(torch.clamp(r + q_off + 1, max=kv_len).sum()) if causal else tq * kv_len
        per_call = 2 * nbytes(q) + 2 * b * hk * kv_len * hd * 2 + 8 * b
        ops = 4 * hd * b * hq * pairs
        copies = [make(i) for i in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda a=a, kw=kw: at.flash_attention(*a, **kw) for a, kw in copies])
        plain = eager_ms(torch, lambda: at.flash_attention_ref(*args, **kw))
        if causal and q_off == 0 and tq == kv_len:
            lib_kw = dict(is_causal=True)
        elif causal:
            lib_kw = dict(attn_mask=torch.arange(kv_len, device=dev)[None, :]
                          <= torch.arange(tq, device=dev)[:, None] + q_off)
        else:
            lib_kw = {}
        lib_kw["enable_gqa"] = hq != hk
        lib_in = [(c[0][0], c[0][1][:, :, :kv_len], c[0][2][:, :, :kv_len]) for c in copies]
        library = graph_ms(torch, [lambda t=t: F.scaled_dot_product_attention(*t, **lib_kw) for t in lib_in])
        record("flash_attention", f"{name} S={s} H={hq}/{hk} D={hd}", err, tol, ms, plain,
               bound(per_call, ops), library,
               f"(f32 kernel vs f64 softmax err {err64:.3g} tol {tol64:.3g}; score std {score_std:.2f})",
               split=at.flash_plan(b, hq, hk, tq, kv_len, sms)[1],
               host_us=host_us(torch, lambda: at.flash_attention(*args, **kw)), head_dim=hd)
        del copies, lib_in


# The encoders' and vision models' kernel modes (phase 3, check_encoder_kernels):
# DistilBERT-base's projections at 8 sequences of 384 tokens (M 3072),
# MobileNetV2's K-24 expand at 8 images of 56² and its largest-M expand (16 ->
# 96 channels at 112²), and the non-causal attentions at Tq = S: DistilBERT's
# 8 x 384 with per-row lengths, ViT-B/16's 197 tokens, wav2vec2-base's 499
# frames of 10 s with per-row lengths.
ENC_D, ENC_FF, ENC_HEADS, ENC_T, ENC_B = 768, 3072, 12, 384, 8
ENC_LENS = (384, 301, 250, 177, 120, 96, 64, 32)  # the per-row lengths of the attention case


def f32_route_extra(torch, bound, x, qt, s, bias, out, per_call: int) -> dict:
    """What an f32 quant_matmul_int8 case records beside its times: its
    plan (block channels, split), the bound at the f32 CUDA-core rate (the
    first design's, for comparison with older rows), and its error against
    an f64 product (relative to the product's largest value; the route's
    products are exact, so only the sums' order moves it), which must stay
    within F32_ROUTE_F64_GATE."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    m, k = x.shape
    n = qt.shape[0]
    exact = (x.double() @ qt.double().t()) * s.double() + (0 if bias is None else bias.double())
    rel = ((out.double() - exact).abs().max() / exact.abs().max()).item()
    if not (rel <= F32_ROUTE_F64_GATE):
        raise AssertionError(f"quant_matmul_int8 f32 M={m} N={n} K={k}: {rel:.3g} from the f64 product "
                             f"> {F32_ROUTE_F64_GATE}")
    bn, split = qm.f32_device_plan(x, n)
    return dict(route="f32", bn=bn, split=split, f64_rel_err=rel,
                cuda_core_bound_ms=bound(per_call, 2 * m * n * k, f32=True)[0])


# The f32 route's error against an f64 product, relative to the product's
# largest value, at phase 3's seeded normal inputs (the sums' order alone:
# the products are exact).
F32_ROUTE_F64_GATE = 1e-5
# The f32 flash kernel's error against the softmax in f64, relative to the
# output's largest value (tests/test_torch_cuda.py F32_FLASH_F64_TOL, whose
# inputs put every lo part of the split near its largest).
F32_FLASH_F64_GATE = 1e-5


def flash_f64(torch, q, k, v, causal, q_offset=None, kv_len=None):
    """The attention of q, k, v in f64: GQA, the causal bound at each row's
    q_offset, each row's kv_len (every row here sees a column)."""
    b, hq, tq, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    k64, v64 = (x.double().repeat_interleave(hq // hk, 1) for x in (k, v))
    scores = torch.einsum("bhqd,bhsd->bhqs", q.double(), k64) / math.sqrt(d)
    col = torch.arange(s, device=q.device)
    lens = torch.full((b,), s, device=q.device) if kv_len is None else kv_len.long()
    mask = (col[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        off = torch.zeros(b, device=q.device, dtype=torch.long) if q_offset is None else q_offset.long()
        rows = torch.arange(tq, device=q.device)[None, :] + off[:, None]  # [B, Tq]
        mask = mask & (col[None, None, :] <= rows[:, :, None])[:, None]
    return torch.einsum("bhqs,bhsd->bhqd", torch.softmax(scores.masked_fill(~mask, -math.inf), -1), v64)


def f32_flash_plan(torch, at, b: int, hq: int, hk: int, tq: int, s: int, d: int) -> tuple[int, int]:
    """(slices, split) of an f32 flash_attention launch on this card: f32's
    output slices (its widest instance FLASH_F32_WIDEST columns) and
    flash_plan's split-KV cluster over them. A package without
    FLASH_F32_WIDEST (``--package`` of a tree whose f32 kernel ran on the
    CUDA cores) slices at bf16's widest and launches f32 unsplit."""
    if not hasattr(at, "FLASH_F32_WIDEST"):
        return at.flash_slices(d), 1
    slices = at.flash_slices(d, False)
    return slices, at.flash_plan(b, hq, hk, tq, s, torch.cuda.get_device_properties(0).multi_processor_count, slices)[1]


def f32_flash_extra(torch, bound, args, kw, out, per_call: int, ops: int) -> dict:
    """What an f32 flash_attention case records beside its times: its split
    (flash_plan on this card, f32's slices), the bound at the f32 CUDA-core
    rate (the first design's, for comparison with older rows), and its
    error against the softmax in f64 (relative to the output's largest
    value), which must stay within F32_FLASH_F64_GATE. The case's own bound
    is the six passes' at the bf16 tensor-core rate (6 · ops)."""
    from rten_tpu_torch.kernels import attention as at

    q, k, v = args
    b, hq, tq, d = q.shape
    ref = flash_f64(torch, q, k, v, kw.get("causal", True), kw.get("q_offset"), kw.get("kv_len"))
    rel = ((out.double() - ref).abs().max() / ref.abs().max()).item()
    if not (rel <= F32_FLASH_F64_GATE):
        raise AssertionError(f"flash_attention f32 B={b} H={hq} Tq={tq} D={d}: {rel:.3g} from the f64 softmax "
                             f"> {F32_FLASH_F64_GATE}")
    split = f32_flash_plan(torch, at, b, hq, k.shape[1], tq, k.shape[2], d)[1]
    return dict(route="f32", split=split, f64_rel_err=rel, cuda_core_bound_ms=bound(per_call, ops, f32=True)[0])


def f32_flash_splits(torch, shapes) -> int:
    """The f32 flash_attention launches among ``shapes`` ((b, hq, hk, tq, s,
    d) each, as the calls pass them) that flash_plan splits on this card:
    what a path's ``flash_attention:split_kv`` count must be."""
    from rten_tpu_torch.kernels import attention as at

    return sum(f32_flash_plan(torch, at, *shape)[1] > 1 for shape in shapes)


def check_encoder_kernels(torch, bound, randn, pack, record):
    """quant_matmul_int8 with f32 activations (the route the f32 presets
    take: three bf16 passes on the tensor cores) and flash_attention in f32
    and bf16 at the encoders' and vision models' shapes, each against its
    plain version, timed as check_kernels times the others; the
    yardsticks are F.linear in f32 (TF32 off, the weights dequantized) and
    F.scaled_dot_product_attention with a key mask. f32 cases bound their
    passes at the bf16 tensor-core rate, the matmul's three and flash's six
    (f32_route_extra and f32_flash_extra add the f32 CUDA-core bound and
    the f64 check)."""
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import quant_matmul as qm

    dev = torch.device("cuda", 0)
    f32, bf16 = torch.float32, torch.bfloat16
    F = torch.nn.functional
    m_bert = ENC_B * ENC_T
    shapes = [(f"distilbert wq M={m_bert}", m_bert, ENC_D, ENC_D, True),
              (f"distilbert wo M={m_bert}", m_bert, ENC_D, ENC_D, True),
              (f"distilbert up M={m_bert}", m_bert, ENC_FF, ENC_D, True),
              (f"distilbert down M={m_bert}", m_bert, ENC_D, ENC_FF, True),
              (f"mobilenet expand K=24 M={8 * 56 * 56}", 8 * 56 * 56, 144, 24, False),
              (f"mobilenet expand K=16 M={8 * 112 * 112}", 8 * 112 * 112, 96, 16, False)]
    for name, m, n, k, with_bias in shapes:
        def make(i, m=m, n=n, k=k, with_bias=with_bias):
            qt, s = pack(n, k)
            return (randn(m, k, dtype=f32), qt, s, 0.1 * randn(n, dtype=f32) if with_bias else None)

        args = make(0)
        out = qm.quant_matmul_int8(*args)
        ref = qm.quant_matmul_int8_ref(*args)
        torch.cuda.synchronize()
        err, tol = (out - ref).abs().max().item(), 1e-4 * max(1.0, ref.abs().max().item())
        x, qt, s, bias = args
        per_call = nbytes(x, qt, s, bias) + m * n * 4
        copies = [make(i) for i in range(copies_for(per_call, cap=64))]
        ms = graph_ms(torch, [lambda a=a: qm.quant_matmul_int8(*a) for a in copies])
        plain = eager_ms(torch, lambda: qm.quant_matmul_int8_ref(*args))
        lib_w = [(c[1].float() * c[2][:, None], c[3]) for c in copies[:copies_for(4 * n * k, cap=64)]]
        library = graph_ms(torch, [lambda w=w: F.linear(x, *w) for w in lib_w])
        record("quant_matmul_int8", f"f32 {name} N={n} K={k}", err, tol, ms, plain,
               bound(per_call, 3 * 2 * m * n * k), library,
               host_us=host_us(torch, lambda: qm.quant_matmul_int8(*args)),
               **f32_route_extra(torch, bound, x, qt, s, bias, out, per_call))
        del copies, lib_w

    w2v_frames = (499, 380, 255, 149)  # 10, ~7.6, ~5.1 and ~3 s of 16 kHz audio
    minilm_lens = (256, 230, 201, 160, 128, 97, 64, 32)
    fa_cases = [  # name, b, t, per-row lengths, heads, head dim
        (f"distilbert B={ENC_B} Tq=S={ENC_T} per-row kv_len", ENC_B, ENC_T, ENC_LENS, ENC_HEADS, 64),
        ("vit-b/16 B=8 Tq=S=197", 8, 197, None, ENC_HEADS, 64),
        ("wav2vec2 B=4 Tq=S=499 per-row kv_len", 4, 499, w2v_frames, ENC_HEADS, 64),
        # all-MiniLM-L6-v2's 12 heads of 32 (phase 12's MiniLM run), and
        # (labelled synthetic) 24 heads of 16 over the same rows: the 32 and
        # 16 instances.
        (f"minilm B=8 Tq=S={MINILM_T} per-row kv_len", 8, MINILM_T, minilm_lens, 12, 32),
        (f"synthetic 24x16 B=8 Tq=S={MINILM_T} per-row kv_len", 8, MINILM_T, minilm_lens, 24, 16)]
    for dtype in (f32, bf16):
        for name, b, t, lens, n_heads, hd in fa_cases:
            def make(i, b=b, t=t, lens=lens, dtype=dtype, n_heads=n_heads, hd=hd):
                def heads(scale):  # [B, H, T, D] views of [B·T, H·D] projections, as the models pass them
                    return randn(b * t, n_heads * hd, scale=scale, dtype=dtype).view(b, t, n_heads, hd).transpose(1, 2)

                kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
                return (heads(1.5), heads(1.5), heads(1.0)), dict(causal=False, kv_len=kv)

            args, kw = make(0)
            out = at.flash_attention(*args, **kw)
            ref = at.flash_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            valid = None if lens is None else (torch.arange(t, device=dev)[None, :] < kw["kv_len"][:, None].long())
            diff = (out.float() - ref.float()).abs()
            if valid is not None:  # query rows past a row's length are padding, unspecified
                diff = diff.transpose(1, 2)[valid]
            err = diff.max().item()
            tol = (1e-4 if dtype == f32 else 1e-2) * ref.float().abs().max().item()
            pairs = t * (sum(lens) if lens is not None else b * t)
            kv_rows = sum(lens) if lens is not None else b * t
            per_call = 2 * nbytes(args[0]) + 2 * n_heads * kv_rows * hd * args[0].element_size() + 4 * b
            ops = 4 * hd * n_heads * pairs
            copies = [make(i) for i in range(copies_for(per_call, cap=32))]
            ms = graph_ms(torch, [lambda a=a, kw=kw: at.flash_attention(*a, **kw) for a, kw in copies])
            plain = eager_ms(torch, lambda: at.flash_attention_ref(*args, **kw))
            lib_kw = {}
            if lens is not None:
                lib_kw["attn_mask"] = (torch.arange(t, device=dev)[None, :] < kw["kv_len"][:, None].long())[
                    :, None, None, :]
            library = graph_ms(torch, [lambda a=a: F.scaled_dot_product_attention(*a, **lib_kw) for a, _ in copies])
            extra = f32_flash_extra(torch, bound, args, kw, out, per_call, ops) if dtype == f32 else dict(route="bf16")
            record("flash_attention", f"{extra['route']} {name} H={n_heads} D={hd}", err, tol, ms, plain,
                   bound(per_call, 6 * ops if dtype == f32 else ops), library,
                   host_us=host_us(torch, lambda: at.flash_attention(*args, **kw)), head_dim=hd, **extra)
            del copies

# Whisper-tiny (huggingface.co/openai/whisper-tiny config.json: d_model 384,
# 4 encoder and 4 decoder layers of 6 heads, FFN 1536, vocab 51865, 80 mel
# bins, 1500 audio and 448 text positions): encoder_decoder.WHISPER_TINY.
WHISPER = dict(d_model=384, n_heads=6, d_ff=1536, vocab_size=51865)
WHISPER_AUDIO, WHISPER_TEXT = 1500, 448
WHISPER_KV_LENS = {"whisper B=1 kv_len=1": [1], "whisper B=1 kv_len=100": [100], "whisper B=1 kv_len=447": [447]}


# ---------------------------------------------------------------------------
# Phase 4: full-width GPT-2-small through Generator / NativeBackend
# ---------------------------------------------------------------------------


def stream_bytes(node, exclude=("tok_emb", "pos_emb")) -> int:
    """Bytes a decode step streams from a params subtree (bench.py's
    _quant_stream_bytes for the port's layout): every int8 pack and every
    per-channel vector; embeddings are gathered one row, not streamed."""
    if isinstance(node, dict):
        return sum(stream_bytes(v, exclude) for k, v in node.items() if k not in exclude)
    if isinstance(node, list):
        return sum(stream_bytes(v, exclude) for v in node)
    return node.numel() * node.element_size() if hasattr(node, "numel") else 0  # a pack's "tiled" flag: none


def prefill_device_us(torch, cfg, params, ids, cache_len, reps: int = 4) -> dict:
    """Device µs by kernel of one prefill forward of ``ids`` [1, T] into a
    fresh cache (the lm_head on the last position, its argmax), from the
    profiler over ``reps`` forwards."""
    from rten_tpu_torch.models import decoder

    caches = [decoder.init_cache(cfg, 1, cache_len, device="cuda") for _ in range(reps)]
    return device_us_by_kernel(torch, lambda: decoder.prefill(
        params, cfg, ids, caches.pop(), lm_head_mode="argmax", last_only=True), reps)


def drive_serve(torch, cfg, params, mem_rate, op_rate, out, key="", required=None, n_new=None, cache_len=None,
                check_capture=False):
    """Phase 4 (and, with cfg.w8a8, key "w8a8_" and the W8A8 kernels
    required, phase 6's first part; phases 8's and 9's first parts at
    ``n_new`` tokens in a ``cache_len`` cache): the main path through Generator, time to
    first token, the device time per decode step, and the teacher-forced
    checks; with ``check_capture`` (phases 4 and 9), NativeBackend's
    captured decode step against its eager forward, greedy and logits
    (``capture_check``). The Generator runs on one backend, reset between
    runs, so the timed run replays the step the warm-up captured. Returns
    the main path's launches and the teacher-forced sequence with its
    logits."""
    n_new = n_new or N_NEW
    cache_len = cache_len or CACHE_LEN
    from rten_tpu_torch.generate import Generator, GeneratorConfig, Metrics, NativeBackend
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder

    prompt_gen = torch.Generator().manual_seed(0)
    prompts = {n: torch.randint(0, cfg.vocab_size, (1, n), generator=prompt_gen).to(torch.int32).numpy()
               for n in sorted({N_PROMPT, *TTFT_PROMPTS})}
    prompt = prompts[N_PROMPT]

    served_by = NativeBackend(params, cfg, max_len=cache_len, device="cuda")

    def serve(n_new, metrics=None):
        served_by.reset()
        gen = Generator(served_by, GeneratorConfig(max_tokens=n_new)).with_prompt(prompt)
        if metrics is not None:
            gen.profile(metrics)
        return [int(t[0]) for t in gen]

    serve(8)  # warm-up: allocator, library load and the step's capture, outside the counted run

    # The main path: the prompt as one prefill forward, then n_new - 1 decode steps.
    dispatch.reset_counters()
    metrics = Metrics()
    t0 = time.perf_counter()
    tokens = serve(n_new, metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    forwards = 1 + (n_new - 1)
    log(f"  served {len(tokens)} tokens after a {N_PROMPT}-token prompt in {wall:.3f} s; "
        f"launches {launches}; plain {plain or '{}'}")
    for name in required or ENGINE_KERNELS["slot"]:  # the kernels of generation at batch 1
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    if len(tokens) != n_new or not all(0 <= t < cfg.vocab_size for t in tokens):
        raise AssertionError("the served stream has the wrong length or out-of-vocabulary ids")

    step_ms = metrics.mean_step_ms()
    del served_by
    captured = None
    if check_capture:
        captured = {mode: capture_check(
            torch, f"{key}NativeBackend decode step ({mode})",
            backend_steps(torch, lambda: NativeBackend(params, cfg, max_len=cache_len, device="cuda"), prompt,
                          mode == "greedy")) for mode in ("greedy", "logits")}
    weight = stream_bytes(params)
    avg_prefix = N_PROMPT + (n_new - 1) / 2
    kv = 2 * cfg.n_layers * cfg.kv_heads * avg_prefix * cfg.head_dim * 2
    bound_ms = (weight + kv) / mem_rate * 1e3
    log(f"  decode: {metrics.tokens_per_second():.1f} tokens/s, {step_ms:.4f} ms/step (host clock, "
        f"steady steps); bound {bound_ms:.4f} ms/step ({weight} weight + {kv:.0f} KV bytes) -> "
        f"{bound_ms / step_ms:.4f} of the memory-rate bound")

    # Prefill: time to first token for one row on the host clock (one
    # NativeBackend.prefill call and its token's copy to the host, after a
    # warm-up), against max(weight bytes / memory rate, 2 * non-lm_head
    # weights * T / bf16 rate), with its launches and device time by kernel.
    n_body = sum(pack["qt"].numel() for layer in params["layers"] for pack in layer.values()
                 if isinstance(pack, dict) and "qt" in pack)
    backend = NativeBackend(params, cfg, max_len=cache_len, device="cuda")
    prefill_stats = {}
    for n in TTFT_PROMPTS:
        def first_token(p=prompts[n]):
            backend.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok = int(backend.prefill(p, greedy=True).cpu()[0])
            return (time.perf_counter() - t) * 1e3, tok

        first_token()
        times = [first_token()[0] for _ in range(7)]
        ttft = statistics.median(times)
        backend.reset()
        dispatch.reset_counters()
        backend.prefill(prompts[n], greedy=True)
        per_prefill, per_prefill_plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        need = ("flash_attention",) if cfg.w8a8 else ("quant_matmul_int8", "flash_attention")
        if any(per_prefill_plain.values()) or not all(per_prefill.get(k) for k in need):
            raise AssertionError(f"prefill {n}: launches {per_prefill}, plain {per_prefill_plain}")

        by_kernel = prefill_device_us(torch, cfg, params, torch.from_numpy(prompts[n]).cuda(), cache_len)
        dev_ms = sum(by_kernel.values()) / 1e3
        t_bytes, t_ops = weight / mem_rate * 1e3, 2 * n_body * n / op_rate * 1e3
        p_bound = max(t_bytes, t_ops)
        prefill_stats[n] = dict(
            ttft_ms=ttft, ttft_ms_all=times, tokens_per_s=n / ttft * 1e3, bound_ms=p_bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations", bound_share=p_bound / ttft,
            device_ms=dev_ms, idle_share=max(0.0, 1.0 - dev_ms / ttft), launches=per_prefill,
            device_us_by_kernel=by_kernel,
        )
        log(f"  prefill {n} tokens: time to first token {ttft:.4f} ms (host clock, median of 7), "
            f"{n / ttft * 1e3:.1f} prompt tokens/s; bound {p_bound:.4f} ms "
            f"({prefill_stats[n]['bound_by']}) -> {p_bound / ttft:.4f} of it; device {dev_ms:.4f} ms "
            f"(profiler) -> idle share {max(0.0, 1.0 - dev_ms / ttft):.4f}; launches {per_prefill}; "
            f"by kernel (us):")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
            log(f"    {us:9.3f}  {name[:90]}")

    # The prompt path one prefill forward replaces, timed in the same call:
    # the N_PROMPT tokens fed one at a time through the T = 1 forward (the
    # decode kernels), the first token from the last step's fused argmax.
    # Every step runs the lm_head, which the old loop skipped on all but
    # the last token (~0.03 ms of device time a step).
    ids = torch.from_numpy(prompt).cuda()

    def token_by_token_ms():
        c = decoder.init_cache(cfg, 1, cache_len, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(N_PROMPT):
            tok, c = decoder.forward(params, cfg, ids[:, i : i + 1], c, lm_head_mode="argmax")
        int(tok.cpu()[0, 0])
        return (time.perf_counter() - t) * 1e3

    token_by_token_ms()
    tbt_ms = statistics.median(token_by_token_ms() for _ in range(3))
    prefill_stats[N_PROMPT]["token_by_token_ms"] = tbt_ms
    log(f"  prefill {N_PROMPT} tokens one at a time through the T = 1 forward: {tbt_ms:.4f} ms "
        f"(host clock, median of 3) -> one forward takes {prefill_stats[N_PROMPT]['ttft_ms'] / tbt_ms:.4f} "
        f"of it")

    # Device time per decode step (profiler) against the host step time.
    cache = decoder.init_cache(cfg, 1, cache_len, device="cuda")
    _, cache = decoder.prefill(params, cfg, ids, cache, lm_head_mode="argmax", last_only=True)
    last = torch.tensor([[tokens[0]]], dtype=torch.int32, device="cuda")
    n_prof = 32
    decoder.generate_scan(params, cfg, cache, last, n_steps=n_prof)  # captures (warm-up, capture, one replay)
    torch.cuda.synchronize()
    by_kernel = device_us_by_kernel(torch, lambda: decoder.generate_scan(params, cfg, cache, last, n_steps=n_prof), 1)
    by_kernel = {k: v / n_prof for k, v in by_kernel.items()}
    dev_us = sum(by_kernel.values())
    device_ms = dev_us / 1e3 if dev_us > 0 else None
    if device_ms is None:
        log("  device busy time: not measured (the profiler reported no device time)")
        idle = None
    else:
        idle = max(0.0, 1.0 - device_ms / step_ms)
        log(f"  device time {device_ms:.4f} ms/step (profiler, a replay of {n_prof} greedy steps) -> idle share "
            f"{idle:.4f} of the {step_ms:.4f} ms host step; by kernel (us/step):")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
            log(f"    {us:9.3f}  {name[:90]}")

    # Teacher-forced over the first N_FORCED served tokens. (1) The served
    # path itself: the prompt as one prefill forward, then the served tokens
    # one at a time through the T = 1 forward; the argmax of those logits
    # must equal the stream exactly (same kernels, same sums; only the
    # lm_head's fused argmax is swapped for its logits). (2) The prompt and
    # the served tokens as one prefill forward, through the kernels and
    # through the plain versions: each may prefer another token only where
    # its own top-2 gap to the served token is below the tolerance.
    served = torch.tensor(tokens[:N_FORCED], device="cuda")
    c = decoder.init_cache(cfg, 1, cache_len, device="cuda")
    lg, c = decoder.prefill(params, cfg, ids, c, last_only=True)
    step_logits = [lg[0, -1]]
    for i in range(N_FORCED - 1):
        lg, c = decoder.forward(params, cfg, served[i].view(1, 1).to(torch.int32), c)
        step_logits.append(lg[0, -1])
    tbt_logits = torch.stack(step_logits)
    if not torch.equal(tbt_logits.argmax(-1), served.to(torch.int64)):
        raise AssertionError("fused argmax stream differs from the argmax of the same path's logits")

    seq = torch.tensor([list(prompt[0]) + tokens[: N_FORCED - 1]], dtype=torch.int32, device="cuda")

    def one_forward_logits():
        lg, _ = decoder.prefill(params, cfg, seq, decoder.init_cache(cfg, 1, cache_len, device="cuda"))
        return lg[0, N_PROMPT - 1:]  # logits that chose served tokens 0..N_FORCED-1

    k_logits = one_forward_logits()
    with plain_decoder(decoder):
        p_logits = one_forward_logits()
    torch.cuda.synchronize()
    gap_tol = 0.05  # bf16 activations through 12 layers, rounded at other sums

    def gaps(logits):
        return logits.max(-1).values - logits.gather(1, served[:, None].to(torch.int64))[:, 0]

    p_gaps, k_gaps = gaps(p_logits), gaps(k_logits)
    for what, g in (("the plain one-forward prefill", p_gaps), ("the kernels' one-forward prefill", k_gaps)):
        if bool((g > gap_tol).any()):
            raise AssertionError(f"served token loses to the argmax of {what} by > {gap_tol}: {g.tolist()}")
    logit_err = (k_logits - p_logits).abs().max().item()
    tbt_err = (k_logits - tbt_logits).abs().max().item()
    log(f"  teacher-forced {N_FORCED} steps: token-by-token argmax equals the stream; argmax of the "
        f"one-forward prefill agrees at {int((k_gaps == 0).sum())}/{N_FORCED} (kernels) and "
        f"{int((p_gaps == 0).sum())}/{N_FORCED} (plain), worst gap to the served token "
        f"{k_gaps.max().item():.4g} / {p_gaps.max().item():.4g} (tol {gap_tol}); max |logit| difference "
        f"one-forward kernels - plain {logit_err:.4g}, - token by token {tbt_err:.4g}")
    if not bool(torch.isfinite(k_logits).all() and torch.isfinite(tbt_logits).all()):
        raise AssertionError("non-finite logits")
    out[key + "decode"] = dict(
        tokens_per_s=metrics.tokens_per_second(), ms_per_step=step_ms, bound_ms_per_step=bound_ms,
        bound_share=bound_ms / step_ms, weight_bytes=weight, kv_bytes=kv, device_ms_per_step=device_ms,
        idle_share=idle, device_us_by_kernel=by_kernel, launches=launches,
        launches_per_forward={k: v / forwards for k, v in launches.items()}, forwards=forwards,
        plain_calls=plain, served_head=tokens[:16], captured_against_eager=captured,
    )
    out[key + "prefill"] = {str(n): v for n, v in prefill_stats.items()}
    out[key + "forced"] = dict(
        one_forward_agree_kernels=int((k_gaps == 0).sum()), one_forward_agree_plain=int((p_gaps == 0).sum()),
        max_gap_kernels=k_gaps.max().item(), max_gap_plain=p_gaps.max().item(),
        logit_err_kernels_plain=logit_err, logit_err_one_forward_token_by_token=tbt_err,
    )
    return launches, dict(seq=seq, served=served, one_forward=k_logits, token_by_token=tbt_logits)


# ---------------------------------------------------------------------------
# Phase 5: continuous-batching serving at full width
# ---------------------------------------------------------------------------

# New tokens a request: 32-128 (32-256, then 32-160 before; cut to keep the
# script within its time limit on a slow host).
N_REQUESTS, PROMPT_RANGE, NEW_RANGE, SERVE_PAGE, GAP_TOL = 16, (16, 320), (32, 128), 128, 0.05
ENGINE_KERNELS = {  # the kernels each engine run must launch (the prefill ones with them)
    "slot": ("quant_gemv_int8", "quant_mlp_int8", "decode_attention", "quant_matmul_int8", "flash_attention"),
    "paged": ("quant_gemv_int8", "quant_mlp_int8", "paged_decode_attention", "quant_matmul_int8",
              "flash_attention"),
    "slot_int8": ("quant_gemv_int8", "quant_mlp_int8", "decode_attention_int8", "quant_matmul_int8",
                  "flash_attention"),
    "paged_int8": ("quant_gemv_int8", "quant_mlp_int8", "paged_decode_attention_int8", "quant_matmul_int8",
                   "flash_attention"),
    # Pages of 16 positions, the JAX rule's smallest at head dim 64: a
    # 64-position chunk of the KV engine spans four pages.
    "paged16": ("quant_gemv_int8", "quant_mlp_int8", "paged_decode_attention", "paged_decode_attention:page16",
                "quant_matmul_int8", "flash_attention"),
}
SMALL_PAGE = 16  # phase 5's pages under 64 positions


class GapArgMax:
    """Greedy sampler over the logits that records, per step, the gap
    between the top two logits (the solo reference's tie margin)."""

    def __init__(self):
        self.gaps: list[float] = []

    def sample(self, rng, logits):
        import torch

        top = torch.topk(logits.float(), 2, dim=-1).values
        self.gaps.append(float(top[0, 0] - top[0, 1]))
        return torch.argmax(logits, dim=-1).to(torch.int32)


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def check_streams(what, streams, refs, gaps):
    """Each stream equals its reference, or first differs where the solo
    logits' top-2 gap is below GAP_TOL. Returns the number that differ."""
    n_diff = 0
    for i, (s, r) in enumerate(zip(streams, refs)):
        if len(s) != len(r):
            raise AssertionError(f"{what}: request {i} has {len(s)} tokens, its reference {len(r)}")
        at = first_difference(s, r)
        if at is None:
            continue
        n_diff += 1
        if not gaps[i][at] < GAP_TOL:
            raise AssertionError(f"{what}: request {i} differs at token {at}, where the solo top-2 gap is "
                                 f"{gaps[i][at]:.4g} >= {GAP_TOL}")
        log(f"    {what}: request {i} differs from its reference at token {at} (solo gap {gaps[i][at]:.4g})")
    return n_diff


def serving_specs(cfg):
    """The N_REQUESTS seeded requests of the serving phases."""
    import random

    rnd = random.Random(7)
    specs = []
    for _ in range(N_REQUESTS):
        n, m = rnd.randint(*PROMPT_RANGE), rnd.randint(*NEW_RANGE)
        specs.append(dict(prompt=[rnd.randrange(cfg.vocab_size) for _ in range(n)], max_new_tokens=m))
    return specs


def solo_streams(params, cfg, specs, dev):
    """Each request alone through Generator(NativeBackend): its stream and
    each step's top-2 logit gap. One backend, reset between requests, so
    its decode step is captured once: as long as the longest request and
    at least 512 positions, where the KV kernels' plan takes its full 8
    virtual ranks, as in the engines' caches."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend

    longest = max(len(s["prompt"]) + s["max_new_tokens"] for s in specs)
    backend = NativeBackend(params, cfg, max_len=min(cfg.max_seq, max(512, longest)), device=dev)
    streams, gaps = [], []
    for s in specs:
        sampler = GapArgMax()
        backend.reset()
        gen = Generator(backend, GeneratorConfig(max_tokens=s["max_new_tokens"])).with_prompt(s["prompt"])
        streams.append([int(t[0]) for t in gen.with_sampler(sampler)])
        gaps.append(sampler.gaps)
    return streams, gaps


def at_rows(torch, kind, make, specs, rows: int = 8, kv_kernel: str | None = None, n_layers: int = 0):
    """ms per engine forward with ``rows`` active rows (host clock) and the
    device's time by kernel and idle share (profiler) over the same window:
    the first ``rows`` requests' prompts cut to 64 tokens, 256 new tokens
    each. With ``kv_kernel``, one more step's launches are read: every
    forward of it must launch ``kv_kernel`` once a layer and no plain
    version may run."""
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.serve import Request

    engine = make()
    for s in specs[:rows]:
        engine.submit(Request(prompt=s["prompt"][:64], max_new_tokens=256))
    forwards_per_step = engine.steps_per_tick if kind.startswith("slot") else 1
    n_steps = max(2, 64 // forwards_per_step)  # 64 forwards timed, 64 profiled (of 256)
    for _ in range(max(1, n_steps // 4)):  # admission, then the first steps at full rows
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / (n_steps * forwards_per_step)
    if engine.n_active != rows:
        raise AssertionError(f"{kind}: {engine.n_active} rows active in the timed window, not {rows}")
    by_kernel = device_us_by_kernel(torch, engine.step, n_steps)
    dev_ms = sum(by_kernel.values()) / 1e3 / forwards_per_step
    launches = None
    if kv_kernel is not None:
        dispatch.reset_counters()
        engine.step()
        launches = {k: v / forwards_per_step for k, v in dispatch.LAUNCHES.items()}
        if dispatch.PLAIN or launches.get(kv_kernel) != n_layers:
            raise AssertionError(f"{kind} at {rows} rows: launches a forward {launches}, plain {dict(dispatch.PLAIN)}; "
                                 f"{kv_kernel} must launch {n_layers} times a forward and no plain version run")
    log(f"  {kind} at {rows} active rows: {host_ms:.4f} ms per forward (host clock) -> {rows * 1e3 / host_ms:.1f} "
        f"tokens/s; device {dev_ms:.4f} ms (profiler) -> idle share {max(0.0, 1.0 - dev_ms / host_ms):.4f}"
        + (f"; launches a forward {launches}" if launches else "") + "; top kernels (us):")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {us / forwards_per_step:9.3f}  {name[:90]}")
    del engine
    torch.cuda.empty_cache()
    return dict(ms_per_forward=host_ms, device_ms_per_forward=dev_ms, idle_share=max(0.0, 1.0 - dev_ms / host_ms),
                tokens_per_s=rows * 1e3 / host_ms, launches_per_forward=launches,
                device_us_by_kernel={k: v / forwards_per_step for k, v in by_kernel.items()})


def drive_serving(torch, cfg, params, out):
    """16 seeded requests, all queued at once, through the slot engine
    (run and run_pipelined), the paged engine (a pool that holds them all,
    then one small enough to preempt, then pages of SMALL_PAGE positions),
    both again with int8_kv, and four concurrent POST /generate to a
    ServingServer on loopback. Each stream is held against its solo
    Generator(NativeBackend) stream (the paged runs of 128-position pages
    against the slot run's); every run's launch counters are read around
    it."""
    import dataclasses
    import threading
    import urllib.request

    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine, ServingServer

    dev = torch.device("cuda", 0)
    cfg8 = dataclasses.replace(cfg, int8_kv=True)
    specs = serving_specs(cfg)
    total_new = sum(s["max_new_tokens"] for s in specs)
    log(f"  {N_REQUESTS} requests: prompts {min(len(s['prompt']) for s in specs)}-"
        f"{max(len(s['prompt']) for s in specs)} tokens, {total_new} new tokens in all")

    # Solo references through Generator(NativeBackend), with each step's top-2 gap.
    solo, solo_gaps = {}, {}
    t0 = time.perf_counter()
    for key, c in (("bf16", cfg), ("int8", cfg8)):
        solo[key], solo_gaps[key] = solo_streams(params, c, specs, dev)
    log(f"  solo references (bf16 and int8 KV): {time.perf_counter() - t0:.1f} s")

    pages_all = sum(-(-(len(s["prompt"]) + s["max_new_tokens"]) // SERVE_PAGE) for s in specs)
    # Half of what the first 8 requests (admitted together) grow to: rows
    # run out of pages mid-decode, so some are preempted and re-prefilled.
    needs = [-(-(len(s["prompt"]) + s["max_new_tokens"]) // SERVE_PAGE) for s in specs]
    pages_small = max(max(needs), sum(needs[:8]) // 2)
    pages_16 = sum(-(-(len(s["prompt"]) + s["max_new_tokens"]) // SMALL_PAGE) for s in specs)
    runs = [
        ("slot run", "slot", lambda: ServingEngine(params, cfg, max_batch=8, steps_per_tick=8, device=dev), "run"),
        ("slot run_pipelined", "slot",
         lambda: ServingEngine(params, cfg, max_batch=8, steps_per_tick=8, device=dev), "pipelined"),
        (f"paged {pages_all} pages", "paged",
         lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages_all, page_size=SERVE_PAGE, device=dev),
         "run"),
        (f"paged {pages_small} pages (preempts)", "paged",
         lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages_small, page_size=SERVE_PAGE,
                                    device=dev), "run"),
        (f"paged {pages_16} pages of {SMALL_PAGE}", "paged16",
         lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages_16, page_size=SMALL_PAGE, device=dev),
         "run"),
        ("slot int8_kv run", "slot_int8",
         lambda: ServingEngine(params, cfg8, max_batch=8, steps_per_tick=8, device=dev), "run"),
        (f"paged int8_kv {pages_all} pages", "paged_int8",
         lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages_all, page_size=SERVE_PAGE,
                                    int8_kv=True, device=dev), "run"),
    ]
    results, launches_total = {}, {}
    for label, kind, make, mode in runs:
        engine = make()
        peak_pages = [0]
        if kind.startswith("paged"):
            step = engine.step

            def counted_step(step=step, engine=engine):
                done = step()
                peak_pages[0] = max(peak_pages[0], engine.pages_in_use())
                return done

            engine.step = counted_step
        reqs = [engine.submit(Request(**s)) for s in specs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_counters()
        t0 = time.perf_counter()
        engine.run_pipelined() if mode == "pipelined" else engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        for name, n in launches.items():
            launches_total[name] = launches_total.get(name, 0) + n
        missing = [k for k in ENGINE_KERNELS[kind] if launches.get(k, 0) == 0]
        if missing or any(plain.values()):
            raise AssertionError(f"{label}: kernels not launched {missing}, plain calls {plain}")
        if not all(r.finished and len(r.output) == s["max_new_tokens"] for r, s in zip(reqs, specs)):
            raise AssertionError(f"{label}: a request did not finish with its budget of tokens")
        kv_bytes = (engine.pool.nbytes() // (engine.pool.n_pages + 1) * peak_pages[0] if kind.startswith("paged")
                    else sum(nbytes(*v) for k, v in engine.cache.items() if isinstance(v, list)))
        res = dict(kind=kind, wall_s=wall, tokens_per_s=total_new / wall, steps=engine.steps, launches=launches,
                   kv_bytes_held=kv_bytes, max_memory_allocated=torch.cuda.max_memory_allocated(),
                   streams=[r.output for r in reqs])
        if kind.startswith("paged"):
            if engine.pool.n_free != engine.pool.n_pages:
                raise AssertionError(f"{label}: {engine.pool.n_pages - engine.pool.n_free} pages not returned")
            res.update(preemptions=engine.preemptions, peak_pages=peak_pages[0])
            if "preempts" in label and engine.preemptions == 0:
                raise AssertionError(f"{label}: no request was preempted")
        results[label] = res
        log(f"  {label}: {total_new} tokens in {wall:.3f} s -> {total_new / wall:.1f} generated tokens/s; "
            f"{engine.steps} forwards; KV bytes held {kv_bytes} (peak pages {peak_pages[0]}); peak device "
            f"memory {torch.cuda.max_memory_allocated()} B; preemptions {res.get('preemptions', '-')}; "
            f"launches {launches}")
        del engine
        torch.cuda.empty_cache()

    labels = list(results)
    refs = {"slot": solo["bf16"], "slot_int8": solo["int8"], "paged16": solo["bf16"]}
    diffs = {}
    for label in labels:
        kind = results[label]["kind"]
        if kind in refs:
            ref, gaps, against = refs[kind], solo_gaps["int8" if kind.endswith("int8") else "bf16"], "solo"
        else:  # paged against slot, int8 paged against int8 slot
            slot_label = labels[0] if kind == "paged" else next(x for x in labels if results[x]["kind"] == "slot_int8")
            ref, gaps = results[slot_label]["streams"], solo_gaps["int8" if kind.endswith("int8") else "bf16"]
            against = slot_label
        diffs[label] = check_streams(f"{label} vs {against}", results[label]["streams"], ref, gaps)
    log(f"  streams: differing requests (top-2 gap rule {GAP_TOL}) {diffs}")

    # Four concurrent POST /generate to a ServingServer on loopback.
    server = ServingServer(ServingEngine(params, cfg, max_batch=8, steps_per_tick=8, device=dev))
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        replies = [None] * 4

        def post(i):
            body = json.dumps({"prompt": specs[i]["prompt"], "max_new_tokens": specs[i]["max_new_tokens"]}).encode()
            req = urllib.request.Request(f"{url}/generate", data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                replies[i] = json.loads(r.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.stop()
    slot_streams = results[labels[0]]["streams"]
    for i, reply in enumerate(replies):
        if reply is None or set(reply) != {"request_id", "tokens", "finished"} or not reply["finished"]:
            raise AssertionError(f"HTTP request {i}: bad reply {reply}")
        if reply["tokens"] != slot_streams[i]:
            raise AssertionError(f"HTTP request {i}: reply differs from the engine's output")
    if health.get("status") != "ok" or stats.get("max_batch") != 8:
        raise AssertionError(f"HTTP /healthz or /stats: {health} {stats}")
    log(f"  HTTP: 4 concurrent POST /generate equal the slot engine's outputs; /healthz {health}; /stats {stats}")

    # ms per engine forward with 8 active rows, and the device's idle share
    # (profiler) over the same window.
    step_stats = {}
    for kind, make in (("slot", lambda: ServingEngine(params, cfg, max_batch=8, steps_per_tick=8, device=dev)),
                       ("paged", lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages_all,
                                                            page_size=SERVE_PAGE, device=dev)),
                       ("slot_int8", lambda: ServingEngine(params, cfg8, max_batch=8, steps_per_tick=8, device=dev)),
                       ("paged_int8", lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages_all,
                                                                 page_size=SERVE_PAGE, int8_kv=True, device=dev))):
        step_stats[kind] = at_rows(torch, kind, make, specs)

    # The slot engine's tick (8 forwards) and the paged step captured against
    # eager: the first 8 requests' prompts cut to 64 tokens, 64 new tokens.
    short = [dict(prompt=s["prompt"][:64], max_new_tokens=64) for s in specs[:8]]
    captured = {}
    for kind, make in (("slot", lambda: ServingEngine(params, cfg, max_batch=8, steps_per_tick=8, device=dev)),
                       ("slot_int8", lambda: ServingEngine(params, cfg8, max_batch=8, steps_per_tick=8, device=dev)),
                       ("paged", lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=16, page_size=SERVE_PAGE,
                                                            device=dev)),
                       ("paged_int8", lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=16,
                                                                 page_size=SERVE_PAGE, int8_kv=True, device=dev))):
        slot = kind.startswith("slot")  # a tick of 8 forwards a step: 1 + 4 + 2 ticks, else 8 + 32 + 16 steps
        captured[kind] = capture_check(torch, f"{kind} engine at 8 rows", engine_steps(torch, make, short),
                                       forwards=8 if slot else 1,
                                       steps=(1, 4, 2) if slot else (CAPTURE_WARM, CAPTURE_TIMED, CAPTURE_PROF))
    torch.cuda.empty_cache()

    for res in results.values():
        del res["streams"]
    out["serving"] = dict(requests=[dict(prompt_len=len(s["prompt"]), max_new_tokens=s["max_new_tokens"])
                                    for s in specs], runs=results, differing=diffs, at_8_rows=step_stats,
                          http=dict(health=health, stats=stats), captured_against_eager=captured)
    for more in (drive_serving_16(torch, cfg, params, out), drive_checkpoints(torch, cfg, params, out)):
        for name, n in more.items():
            launches_total[name] = launches_total.get(name, 0) + n
    return launches_total


N_REQUESTS_16, NEW_RANGE_16 = 32, (16, 48)
KV_KERNEL_16 = {"slot": "decode_attention:no_wo", "slot_int8": "decode_attention_int8",
                "paged": "paged_decode_attention", "paged_int8": "paged_decode_attention_int8"}


def serving_specs_16(cfg):
    """The 32 seeded requests of the 16-row runs: prompts of 16-320 tokens
    as phase 5's, 16-48 new tokens each (phase 5's 32-128 cut to keep the
    run short: these runs test the row count, which stays 16)."""
    import random

    rnd = random.Random(16)
    specs = []
    for _ in range(N_REQUESTS_16):
        n, m = rnd.randint(*PROMPT_RANGE), rnd.randint(*NEW_RANGE_16)
        specs.append(dict(prompt=[rnd.randrange(cfg.vocab_size) for _ in range(n)], max_new_tokens=m))
    return specs


def drive_serving_16(torch, cfg, params, out) -> dict:
    """Phase 5's 16-row runs: ServingEngine (8 forwards a tick) and
    PagedServingEngine (a pool that holds every request) at max_batch 16,
    on a bf16 and an int8 KV cache, each with 32 seeded requests queued at
    once; each stream against its solo Generator(NativeBackend) stream
    (top-2 rule), each run's launch counters read around it (its KV kernel
    launched, no plain version); then ms per forward at 16 active rows, the
    device's idle share, and one step's launches: the KV kernel once a layer
    at every forward. Returns the runs' launches."""
    import dataclasses

    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine

    dev = torch.device("cuda", 0)
    cfg8 = dataclasses.replace(cfg, int8_kv=True)
    specs = serving_specs_16(cfg)
    total_new = sum(s["max_new_tokens"] for s in specs)
    t0 = time.perf_counter()
    solo = {key: solo_streams(params, c, specs, dev) for key, c in (("bf16", cfg), ("int8", cfg8))}
    log(f"  16 rows: {N_REQUESTS_16} requests (prompts {min(len(s['prompt']) for s in specs)}-"
        f"{max(len(s['prompt']) for s in specs)} tokens, {total_new} new tokens in all); solo references "
        f"{time.perf_counter() - t0:.1f} s")
    pages = sum(-(-(len(s["prompt"]) + s["max_new_tokens"]) // SERVE_PAGE) for s in specs)
    makes = {
        "slot": lambda: ServingEngine(params, cfg, max_batch=16, steps_per_tick=8, device=dev),
        "paged": lambda: PagedServingEngine(params, cfg, max_batch=16, n_pages=pages, page_size=SERVE_PAGE, device=dev),
        "slot_int8": lambda: ServingEngine(params, cfg8, max_batch=16, steps_per_tick=8, device=dev),
        "paged_int8": lambda: PagedServingEngine(params, cfg, max_batch=16, n_pages=pages, page_size=SERVE_PAGE,
                                                 int8_kv=True, device=dev),
    }
    runs, launches_total = {}, {}
    for kind, make in makes.items():
        engine = make()
        reqs = [engine.submit(Request(**s)) for s in specs]
        torch.cuda.synchronize()
        dispatch.reset_counters()
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        for name, n in launches.items():
            launches_total[name] = launches_total.get(name, 0) + n
        if any(plain.values()) or not launches.get(KV_KERNEL_16[kind]):
            raise AssertionError(f"16 rows {kind}: launches {launches}, plain calls {plain}")
        if not all(r.finished and len(r.output) == s["max_new_tokens"] for r, s in zip(reqs, specs)):
            raise AssertionError(f"16 rows {kind}: a request did not finish with its budget of tokens")
        ref, gaps = solo["int8" if kind.endswith("int8") else "bf16"]
        diff = check_streams(f"16 rows {kind} vs solo", [r.output for r in reqs], ref, gaps)
        runs[kind] = dict(wall_s=wall, tokens_per_s=total_new / wall, forwards=engine.steps, launches=launches,
                          differing=diff)
        log(f"  16 rows {kind}: {total_new} tokens in {wall:.3f} s -> {total_new / wall:.1f} generated tokens/s; "
            f"{engine.steps} forwards; {diff} streams differ from their solo streams (top-2 rule); launches {launches}")
        del engine
        torch.cuda.empty_cache()
    at_16 = {kind: at_rows(torch, kind, make, specs, rows=16, kv_kernel=KV_KERNEL_16[kind], n_layers=cfg.n_layers)
             for kind, make in makes.items()}
    out["serving_16"] = dict(requests=[dict(prompt_len=len(s["prompt"]), max_new_tokens=s["max_new_tokens"])
                                       for s in specs], runs=runs, at_16_rows=at_16)
    return launches_total


def drive_checkpoints(torch, cfg, params, out) -> dict:
    """Phase 5's checkpoint checks. The slot engine (8 slots of 512
    positions, 8 forwards a tick) on phase 5's first 12 requests with at most 64 new tokens each,
    bf16 then int8 KV, greedy then TemperatureSampler(0.8) from seed 5:
    run through; then again for half the ticks the uninterrupted run took,
    snapshot_engine, save_snapshot to a temporary file, load_snapshot,
    restore_engine into a fresh engine that runs to the end: every stream
    must equal the uninterrupted run's token for token. Then a NativeBackend
    after phase 4's 64-token prompt: snapshot_backend, 32 greedy decode
    steps, restore_backend into a fresh backend, the same 32 steps: equal
    tokens. Returns the launches of the restored runs."""
    import dataclasses
    import tempfile

    import numpy as np

    from rten_tpu_torch.generate import NativeBackend, TemperatureSampler
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.serve import (Request, ServingEngine, load_snapshot, restore_backend, restore_engine,
                                      save_snapshot, snapshot_backend, snapshot_engine)

    dev = torch.device("cuda", 0)
    specs = [dict(prompt=s["prompt"], max_new_tokens=min(64, s["max_new_tokens"])) for s in serving_specs(cfg)[:12]]
    results, launches_total = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for kv in ("bf16", "int8"):
            run_cfg = dataclasses.replace(cfg, int8_kv=kv == "int8")
            for mode in ("greedy", "temperature 0.8"):
                def make(run_cfg=run_cfg, mode=mode):
                    kw = dict(sampler=TemperatureSampler(0.8), seed=5) if mode != "greedy" else {}
                    return ServingEngine(params, run_cfg, max_batch=8, max_len=512, steps_per_tick=8, device=dev,
                                         **kw)

                engine = make()
                for s in specs:
                    engine.submit(Request(**s))
                done, ticks = [], 0
                while engine.has_work():
                    done.extend(engine.step())
                    ticks += 1
                want = {r.request_id: r.output for r in done}
                engine = make()
                for s in specs:
                    engine.submit(Request(**s))
                done = []
                for _ in range(ticks // 2):
                    done.extend(engine.step())
                path = f"{tmp}/{kv}_{mode.split()[0]}.npz"
                save_snapshot(snapshot_engine(engine), path)
                restored = make()
                restore_engine(restored, load_snapshot(path))
                dispatch.reset_counters()
                done.extend(restored.run())
                for name, n in dispatch.LAUNCHES.items():
                    launches_total[name] = launches_total.get(name, 0) + n
                got = {r.request_id: r.output for r in done}
                if got != want:
                    bad = [i for i in want if got.get(i) != want[i]]
                    raise AssertionError(f"checkpoint {kv} {mode}: requests {bad} differ after the restore")
                results[f"{kv} {mode}"] = dict(ticks=ticks, snapshot_at=ticks // 2, bytes=os.path.getsize(path),
                                               restored_launches=dict(dispatch.LAUNCHES))
                log(f"  checkpoint {kv} KV {mode}: snapshot after {ticks // 2} of {ticks} ticks "
                    f"({os.path.getsize(path)} bytes), restored into a fresh engine: all {len(specs)} streams equal "
                    "the uninterrupted run's")

    prompt = torch.randint(0, cfg.vocab_size, (1, N_PROMPT), generator=torch.Generator().manual_seed(0))
    prompt = prompt.to(torch.int32).numpy()  # phase 4's prompt (the first draw of its seed)

    def steps(backend, tok):
        out_toks = []
        for _ in range(N_FORCED):
            tok = int(backend.decode(np.array([[tok]], np.int32), greedy=True)[0])
            out_toks.append(tok)
        return out_toks

    backend = NativeBackend(params, cfg, max_len=CACHE_LEN, device=dev)
    first = int(backend.prefill(prompt, greedy=True)[0])
    snap = snapshot_backend(backend)
    before = steps(backend, first)
    fresh = NativeBackend(params, cfg, max_len=CACHE_LEN, device=dev)
    restore_backend(fresh, snap)
    after = steps(fresh, first)
    if after != before or fresh.length != backend.length:
        raise AssertionError(f"backend checkpoint: the decode after the restore differs: {before} vs {after}")
    log(f"  backend checkpoint: NativeBackend after the {N_PROMPT}-token prompt, {N_FORCED} greedy steps after "
        "restore_backend equal those after snapshot_backend")
    out["checkpoint"] = dict(engine=results, backend=dict(steps=N_FORCED, equal=True, length=fresh.length))
    return launches_total


# ---------------------------------------------------------------------------
# Phase 6: W8A8 (DecoderConfig(w8a8=True)) at full width
# ---------------------------------------------------------------------------

W8A8_KERNELS = ("quant_gemv_int8:w8a8", "quant_mlp_int8:w8a8", "quant_matmul_w8a8", "decode_attention",
                "flash_attention", "quant_matmul_int8")  # the last: the tiled packs
W8A8_GATE = 0.10  # relative RMS of W8A8 against weight-only logits: the bound PERF.md states


def rel_rms(a, b) -> float:
    return ((a.double() - b.double()).pow(2).mean() / b.double().pow(2).mean()).sqrt().item()


def drive_w8a8(torch, cfg, params, mem_rate, int8_rate, out):
    """GPT-2-small with the same int8 weights in W8A8: phase 4's path
    (Generator, time to first token, the teacher-forced checks), the
    accuracy gate against the weight-only path on the same 32 teacher-forced
    steps, then phase 5's 16 requests through the slot engine, each stream
    equal to its solo W8A8 Generator stream, and ms per forward at 8 rows."""
    import dataclasses

    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.serve import Request, ServingEngine

    dev = torch.device("cuda", 0)
    cfg8 = dataclasses.replace(cfg, w8a8=True)
    launches, forced = drive_serve(torch, cfg8, params, mem_rate, int8_rate, out, key="w8a8_", required=W8A8_KERNELS)

    # The accuracy gate: the same teacher-forced steps through the
    # weight-only path, as one forward and token by token.
    seq, served = forced["seq"], forced["served"]
    lg, _ = decoder.prefill(params, cfg, seq, decoder.init_cache(cfg, 1, CACHE_LEN, device="cuda"))
    wo_one = lg[0, N_PROMPT - 1:]
    c = decoder.init_cache(cfg, 1, CACHE_LEN, device="cuda")
    lg, c = decoder.prefill(params, cfg, seq[:, :N_PROMPT], c, last_only=True)
    steps = [lg[0, -1]]
    for i in range(N_FORCED - 1):
        lg, c = decoder.forward(params, cfg, served[i].view(1, 1).to(torch.int32), c)
        steps.append(lg[0, -1])
    wo_tbt = torch.stack(steps)
    gate = dict(one_forward=rel_rms(forced["one_forward"], wo_one),
                token_by_token=rel_rms(forced["token_by_token"], wo_tbt),
                per_step_max=max(rel_rms(a, b) for a, b in zip(forced["token_by_token"], wo_tbt)),
                argmax_agree=int((forced["token_by_token"].argmax(-1) == wo_tbt.argmax(-1)).sum()), bound=W8A8_GATE)
    log(f"  accuracy gate: W8A8 against weight-only logits over the {N_FORCED} teacher-forced steps, relative RMS "
        f"{gate['one_forward']:.5f} (one forward) and {gate['token_by_token']:.5f} (token by token; worst step "
        f"{gate['per_step_max']:.5f}), bound {W8A8_GATE}; the same argmax at {gate['argmax_agree']}/{N_FORCED}")
    if not max(gate["one_forward"], gate["token_by_token"]) <= W8A8_GATE:
        raise AssertionError(f"W8A8 logits differ from the weight-only ones by more than the gate: {gate}")

    # Phase 5's requests through the slot engine in W8A8, against their solo streams.
    specs = serving_specs(cfg)
    total_new = sum(s["max_new_tokens"] for s in specs)
    t0 = time.perf_counter()
    solo, _gaps = solo_streams(params, cfg8, specs, dev)
    log(f"  solo W8A8 references: {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(params, cfg8, max_batch=8, steps_per_tick=8, device=dev)
    reqs = [engine.submit(Request(**s)) for s in specs]
    torch.cuda.synchronize()
    dispatch.reset_counters()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    missing = [k for k in W8A8_KERNELS if run_launches.get(k, 0) == 0]
    if missing or any(plain.values()):
        raise AssertionError(f"W8A8 slot run: kernels not launched {missing}, plain calls {plain}")
    equal = sum(r.output == ref for r, ref in zip(reqs, solo))
    log(f"  W8A8 slot run: {total_new} tokens in {wall:.3f} s -> {total_new / wall:.1f} generated tokens/s; "
        f"{engine.steps} forwards; streams equal to their solo streams {equal}/{N_REQUESTS}; launches {run_launches}")
    if equal != N_REQUESTS:
        raise AssertionError(f"W8A8 slot run: {N_REQUESTS - equal} streams differ from their solo streams")
    del engine
    torch.cuda.empty_cache()
    at_8 = at_rows(torch, "slot_w8a8", lambda: ServingEngine(params, cfg8, max_batch=8, steps_per_tick=8,
                                                           device=dev), specs)
    out["w8a8_gate"] = gate
    out["w8a8_serving"] = dict(wall_s=wall, tokens_per_s=total_new / wall, launches=run_launches,
                               streams_equal=equal, at_8_rows=at_8, streams=[r.output for r in reqs])
    for name, n in run_launches.items():
        launches[name] = launches.get(name, 0) + n
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the whole-block decode (DecoderConfig(mega=True)) at full width
# ---------------------------------------------------------------------------

MEGA_KERNELS = ("quant_gemv_int8", "decode_block", "quant_matmul_int8", "flash_attention")
MEGA_GATE = 0.05  # relative RMS of mega against two-kernel logits: the bound PERF.md states
N_MEGA_W8A8 = 32  # tokens of the short W8A8 + mega run


def mega_gate(torch, cfgm, params, forced, cache_len) -> dict:
    """The two-kernel path's teacher-forced steps (``forced``, from
    drive_serve) token by token through the mega path's kernels and its
    plain versions (``cfgm``), held against the two-kernel logits: relative
    RMS at most MEGA_GATE, and an argmax that differs from the served token
    only where its top-2 gap is below GAP_TOL. Returns the gate's numbers."""
    from rten_tpu_torch.models import decoder

    seq, served = forced["seq"], forced["served"]

    def token_by_token():
        c = decoder.init_cache(cfgm, 1, cache_len, device="cuda")
        lg, c = decoder.prefill(params, cfgm, seq[:, :N_PROMPT], c, last_only=True)
        rows = [lg[0, -1]]
        for i in range(N_FORCED - 1):
            lg, c = decoder.forward(params, cfgm, served[i].view(1, 1).to(torch.int32), c)
            rows.append(lg[0, -1])
        return torch.stack(rows)

    mega_k = token_by_token()
    with plain_decoder(decoder):
        mega_p = token_by_token()
    torch.cuda.synchronize()
    two = forced["token_by_token"]

    def gaps(logits):
        return logits.max(-1).values - logits.gather(1, served[:, None].to(torch.int64))[:, 0]

    k_gaps, p_gaps = gaps(mega_k), gaps(mega_p)
    for what, g in (("the mega kernels", k_gaps), ("the mega plain versions", p_gaps)):
        if bool((g > GAP_TOL).any()):
            raise AssertionError(f"a served token loses to the argmax of {what} by > {GAP_TOL}: {g.tolist()}")
    gate = dict(mega_vs_two_kernel=rel_rms(mega_k, two), per_step_max=max(rel_rms(a, b) for a, b in zip(mega_k, two)),
                kernels_vs_plain=rel_rms(mega_k, mega_p), argmax_agree_kernels=int((k_gaps == 0).sum()),
                argmax_agree_plain=int((p_gaps == 0).sum()), max_gap_kernels=k_gaps.max().item(),
                max_gap_plain=p_gaps.max().item(), bound=MEGA_GATE)
    log(f"  teacher-forced {N_FORCED} steps through the mega path: relative RMS against the two-kernel logits "
        f"{gate['mega_vs_two_kernel']:.5f} (worst step {gate['per_step_max']:.5f}; bound {MEGA_GATE}), kernels "
        f"against plain {gate['kernels_vs_plain']:.5f}; the served token is the argmax at "
        f"{gate['argmax_agree_kernels']}/{N_FORCED} (kernels) and {gate['argmax_agree_plain']}/{N_FORCED} (plain), "
        f"worst gap {gate['max_gap_kernels']:.4g} / {gate['max_gap_plain']:.4g} (tol {GAP_TOL})")
    if not (gate["mega_vs_two_kernel"] <= MEGA_GATE and bool(torch.isfinite(mega_k).all())):
        raise AssertionError(f"mega logits differ from the two-kernel ones by more than the bound: {gate}")
    return gate


def drive_mega(torch, cfg, params, mem_rate, op_rate, out, forced):
    """GPT-2-small with the same int8 weights and DecoderConfig(mega=True):
    phase 4's path (Generator, time to first token, device time per step by
    kernel, the teacher-forced checks) with decode_block launched 12 times a
    decode step and neither decode_attention nor quant_mlp_int8; then phase
    4's 32 teacher-forced steps (``forced``: the two-kernel path's tokens and
    logits) through the mega path's kernels and its plain versions, held
    against the two-kernel logits (relative RMS at most MEGA_GATE; an argmax
    that differs from the served token only where its top-2 gap is below
    GAP_TOL); and a short W8A8 + mega run that launches."""
    import dataclasses

    from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder

    cfgm = dataclasses.replace(cfg, mega=True)
    launches, _mega_forced = drive_serve(torch, cfgm, params, mem_rate, op_rate, out, key="mega_",
                                         required=MEGA_KERNELS)
    steps = N_NEW - 1
    if launches.get("decode_block", 0) != cfg.n_layers * steps or launches.get("decode_attention", 0) \
            or launches.get("quant_mlp_int8", 0):
        raise AssertionError(f"mega decode: decode_block must launch {cfg.n_layers} times a step and the two "
                             f"kernels it replaces never: {launches}")

    gate = mega_gate(torch, cfgm, params, forced, CACHE_LEN)
    base, mega = out["decode"], out["mega_decode"]
    log(f"  beside the two-kernel path of this call: {mega['tokens_per_s']:.1f} against {base['tokens_per_s']:.1f} "
        f"tokens/s; host {mega['ms_per_step']:.4f} against {base['ms_per_step']:.4f} ms/step; device "
        f"{mega['device_ms_per_step']} against {base['device_ms_per_step']} ms/step; idle share "
        f"{mega['idle_share']} against {base['idle_share']}; launches a forward "
        f"{sum(mega['launches_per_forward'].values()):.2f} against {sum(base['launches_per_forward'].values()):.2f}")

    # A short W8A8 + mega run: the block stays weight-only, layer 0's qkv and
    # the lm_head run the w8a8 GEMV, the prompt quant_matmul_w8a8.
    cfg8 = dataclasses.replace(cfgm, w8a8=True)
    prompt = forced["seq"][:, :N_PROMPT].cpu().numpy()
    stream = iter(Generator(NativeBackend(params, cfg8, max_len=CACHE_LEN, device="cuda"),
                            GeneratorConfig(max_tokens=N_MEGA_W8A8)).with_prompt(prompt))
    dispatch.reset_counters()
    toks = [int(next(stream)[0])]  # the prompt's prefill forward
    prefill_launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    dispatch.reset_counters()
    toks += [int(t[0]) for t in stream]  # the decode steps
    torch.cuda.synchronize()
    w8_launches = dict(dispatch.LAUNCHES)
    plain.update({k: v for k, v in dispatch.PLAIN.items() if v})
    want = {"decode_block": cfg.n_layers * (N_MEGA_W8A8 - 1), "quant_gemv_int8:w8a8": 2 * (N_MEGA_W8A8 - 1)}
    if w8_launches != want or not prefill_launches.get("quant_matmul_w8a8") or any(plain.values()) \
            or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"W8A8 + mega run: decode launches {w8_launches} (want {want}), prefill "
                             f"{prefill_launches}, plain {plain}")
    log(f"  W8A8 + mega: {len(toks)} tokens; the prompt's launches {prefill_launches}; the decode steps' {w8_launches}")
    out["mega_forced"] = gate
    out["mega_w8a8"] = dict(prefill_launches=prefill_launches, decode_launches=w8_launches, tokens=toks[:16])
    for counts in (prefill_launches, w8_launches):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return launches


# ---------------------------------------------------------------------------
# Phase 8: a tiny_starcoder_py-shaped model (MQA) with the whole-block decode
# ---------------------------------------------------------------------------

# huggingface.co/bigcode/tiny_starcoder_py config.json (GPTBigCode): 20 layers,
# n_embd 768, 12 heads over one kv head (multi_query), n_inner 3072, vocab
# 49152, n_positions 8192, layer_norm_epsilon 1e-5, learned positions, biases,
# a tied head. Its gelu_pytorch_tanh runs as the erf GELU, the one the JAX
# package has.
STARCODER_CFG = dict(vocab_size=49152, n_layers=20, n_heads=12, n_kv_heads=1, d_model=768, d_ff=3072, max_seq=8192,
                     layer_norm_eps=1e-5)
N_STARCODER_NEW, STARCODER_CACHE = 256, 1024
STARCODER_KERNELS = ("quant_gemv_int8", "decode_block:gqa", "quant_matmul_int8", "flash_attention")
STARCODER_TWO_KERNEL = ("quant_gemv_int8", "quant_mlp_int8", "decode_attention:gqa", "quant_matmul_int8",
                        "flash_attention")


def drive_starcoder(torch, mem_rate, op_rate, out):
    """Phase 8: the tiny_starcoder_py-shaped model (random int8 weights from
    seed 0, bf16) through phase 4's path (Generator(NativeBackend): a
    64-token prompt, then 255 greedy steps in a 1024-position cache) twice:
    the two-kernel decode (decode_attention:gqa with its wo, then
    quant_mlp_int8) and DecoderConfig(mega=True), whose every decode step
    launches decode_block:gqa 20 times and neither decode_attention nor
    quant_mlp_int8; then the two-kernel path's 32 teacher-forced steps
    through the mega kernels and plain versions (mega_gate)."""
    import dataclasses

    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(**STARCODER_CFG, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"  params: tiny_starcoder_py shape int8, seed 0, {time.perf_counter() - t0:.1f} s to make and quantize; "
        f"{stream_bytes(params)} bytes a decode step streams; wqkv {tuple(params['layers'][0]['wqkv']['qt'].shape)}")
    kw = dict(n_new=N_STARCODER_NEW, cache_len=STARCODER_CACHE)
    launches, forced = drive_serve(torch, cfg, params, mem_rate, op_rate, out, key="starcoder_",
                                   required=STARCODER_TWO_KERNEL, **kw)
    cfgm = dataclasses.replace(cfg, mega=True)
    mega_launches, _ = drive_serve(torch, cfgm, params, mem_rate, op_rate, out, key="starcoder_mega_",
                                   required=STARCODER_KERNELS, **kw)
    steps = N_STARCODER_NEW - 1
    if mega_launches.get("decode_block:gqa", 0) != cfg.n_layers * steps or any(
            mega_launches.get(k, 0) for k in ("decode_attention", "decode_attention:gqa", "quant_mlp_int8")):
        raise AssertionError(f"tiny_starcoder_py mega decode: decode_block:gqa must launch {cfg.n_layers} times a "
                             f"step and the two kernels it replaces never: {mega_launches}")
    gate = mega_gate(torch, cfgm, params, forced, STARCODER_CACHE)
    base, mega = out["starcoder_decode"], out["starcoder_mega_decode"]
    log(f"  beside the two-kernel path of this call: {mega['tokens_per_s']:.1f} against {base['tokens_per_s']:.1f} "
        f"tokens/s; host {mega['ms_per_step']:.4f} against {base['ms_per_step']:.4f} ms/step; device "
        f"{mega['device_ms_per_step']} against {base['device_ms_per_step']} ms/step; idle share "
        f"{mega['idle_share']} against {base['idle_share']}; launches a forward "
        f"{sum(mega['launches_per_forward'].values()):.2f} against {sum(base['launches_per_forward'].values()):.2f}")
    out["starcoder_mega_forced"] = gate
    for name, n in mega_launches.items():
        launches[name] = launches.get(name, 0) + n
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 9: a Qwen2-0.5B-shaped model (RoPE, GQA, SwiGLU) at full width
# ---------------------------------------------------------------------------

# huggingface.co/Qwen/Qwen2-0.5B config.json: 24 layers, hidden 896, 14 heads
# over 2 kv heads (head dim 64), intermediate 4864, vocab 151936, RMSNorm eps
# 1e-6, rope_theta 1e6, q/k/v biases, tied embeddings.
QWEN2_CFG = dict(vocab_size=151936, n_layers=24, d_ff=4864, max_seq=1024, pos_encoding="rope", norm="rmsnorm",
                 activation="swiglu", rope_theta=1e6, layer_norm_eps=1e-6, **QWEN2)
N_QWEN2_NEW, QWEN2_CACHE, N_QWEN2_REQUESTS, QWEN2_NEW_RANGE = 256, 1024, 8, (16, 64)
QWEN2_KERNELS = ("quant_gemv_int8", "decode_attention:gqa", "quant_matmul_int8", "flash_attention")
QWEN2_ENGINE_KERNELS = {"slot": "decode_attention:gqa", "slot_int8": "decode_attention_int8:gqa",
                        "paged": "paged_decode_attention:gqa", "paged_int8": "paged_decode_attention_int8:gqa"}


@functools.lru_cache(maxsize=1)
def qwen2_params(torch, cfg):
    """Random int8 params of the Qwen2-0.5B shape from seed 0: the port's
    ``init_params`` (tied), seeded q/k/v biases, and the tied head as
    ``from_hf_llama`` writes it (an ``lm_head`` copy of the embedding), then
    ``quantize_params_int8`` (``w_gu`` fuses: 2 x 4864 is a multiple of 128,
    its N 9728 pads to 10240; the lm_head's N 151936 to 152576). Made once
    for phases 9 and 10 (~15 s on the card); phase 10 drops it."""
    import numpy as np

    from rten_tpu_torch.models import decoder

    dense = decoder.init_params(0, cfg, device="cuda")
    rng = np.random.default_rng(1)
    widths = {"bq": cfg.n_heads * cfg.head_dim, "bk": cfg.kv_heads * cfg.head_dim, "bv": cfg.kv_heads * cfg.head_dim}
    for layer in dense["layers"]:
        for key, n in widths.items():
            layer[key] = torch.from_numpy(rng.standard_normal(n, dtype=np.float32) * np.float32(0.02)).to(
                dense["tok_emb"].device, cfg.dtype)
    dense["lm_head"] = dense["tok_emb"].t().contiguous()
    return decoder.quantize_params_int8(dense, device="cuda")


def drive_qwen2(torch, mem_rate, op_rate, out):
    """Phase 9: the Qwen2-0.5B-shaped model through phase 4's path
    (Generator(NativeBackend): a 64-token prompt in one prefill, then 255
    greedy steps in a 1024-position cache, each launching decode_attention
    24 times in its unpacked GQA mode and no plain version; time to first
    token at 64 and 512; device time by kernel; 32 teacher-forced steps
    through the kernels and the plain versions under the top-2 rule), then
    8 seeded requests through the slot and paged engines, each on bf16 and
    int8 KV, each stream held against its solo stream (the three GQA KV
    kernels), and one decode step at 12 rows on a bf16 cache
    (decode_attention without its wo) against the plain versions."""
    import dataclasses
    import random

    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine

    dev = torch.device("cuda", 0)
    cfg = decoder.DecoderConfig(**QWEN2_CFG, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = qwen2_params(torch, cfg)
    torch.cuda.synchronize()
    weight = stream_bytes(params)
    log(f"  params: Qwen2-0.5B shape int8, seed 0, {time.perf_counter() - t0:.1f} s to make and quantize; "
        f"{weight} bytes a decode step streams; w_gu {tuple(params['layers'][0]['w_gu']['qt'].shape)}, "
        f"lm_head {tuple(params['lm_head']['qt'].shape)}")
    launches, _forced = drive_serve(torch, cfg, params, mem_rate, op_rate, out, key="qwen2_", required=QWEN2_KERNELS,
                                    n_new=N_QWEN2_NEW, cache_len=QWEN2_CACHE, check_capture=True)
    steps = N_QWEN2_NEW - 1
    if launches.get("decode_attention:gqa", 0) != cfg.n_layers * steps or launches.get("decode_attention", 0) \
            or launches.get("quant_mlp_int8", 0):
        raise AssertionError(f"Qwen2 decode: decode_attention:gqa must launch {cfg.n_layers} times a step: {launches}")
    launches = dict(launches)  # the phase's sum; out["qwen2_decode"] keeps the served path's own
    per_forward = out["qwen2_decode"]["launches_per_forward"]
    log(f"  launches a forward {sum(per_forward.values()):.2f}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per_forward.items())))

    # Serving: 8 seeded requests through both engines, bf16 and int8 KV.
    rnd = random.Random(8)
    specs = []
    for _ in range(N_QWEN2_REQUESTS):
        n, m = rnd.randint(*PROMPT_RANGE), rnd.randint(*QWEN2_NEW_RANGE)
        specs.append(dict(prompt=[rnd.randrange(cfg.vocab_size) for _ in range(n)], max_new_tokens=m))
    cfg8 = dataclasses.replace(cfg, int8_kv=True)
    t0 = time.perf_counter()
    solo = {key: solo_streams(params, c, specs, dev) for key, c in (("bf16", cfg), ("int8", cfg8))}
    log(f"  {N_QWEN2_REQUESTS} requests, prompts {min(len(s['prompt']) for s in specs)}-"
        f"{max(len(s['prompt']) for s in specs)} tokens; solo references (bf16 and int8 KV) "
        f"{time.perf_counter() - t0:.1f} s")
    pages = sum(-(-(len(s["prompt"]) + s["max_new_tokens"]) // SERVE_PAGE) for s in specs)
    runs = {"slot": lambda: ServingEngine(params, cfg, max_batch=8, steps_per_tick=8, device=dev),
            "slot_int8": lambda: ServingEngine(params, cfg8, max_batch=8, steps_per_tick=8, device=dev),
            "paged": lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages, page_size=SERVE_PAGE,
                                                device=dev),
            "paged_int8": lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages, page_size=SERVE_PAGE,
                                                     int8_kv=True, device=dev)}
    serving = {}
    total_new = sum(s["max_new_tokens"] for s in specs)
    for kind, make in runs.items():
        engine = make()
        reqs = [engine.submit(Request(**s)) for s in specs]
        torch.cuda.synchronize()
        dispatch.reset_counters()
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        if not run_launches.get(QWEN2_ENGINE_KERNELS[kind]) or any(plain.values()):
            raise AssertionError(f"Qwen2 {kind}: {QWEN2_ENGINE_KERNELS[kind]} not launched or plain calls: "
                                 f"{run_launches} {plain}")
        ref, gaps = solo["int8" if kind.endswith("int8") else "bf16"]
        n_diff = check_streams(f"Qwen2 {kind} vs solo", [r.output for r in reqs], ref, gaps)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        serving[kind] = dict(wall_s=wall, tokens_per_s=total_new / wall, forwards=engine.steps, differing=n_diff,
                             launches=run_launches)
        log(f"  Qwen2 {kind}: {total_new} tokens in {wall:.3f} s -> {total_new / wall:.1f} generated tokens/s; "
            f"{engine.steps} forwards; streams differing from solo (top-2 rule) {n_diff}; launches {run_launches}")
        del engine
        torch.cuda.empty_cache()

    # The slot engine's tick and the paged step captured against eager: the
    # 8 requests' prompts cut to 64 tokens, 64 new tokens, bf16 KV.
    short = [dict(prompt=s["prompt"][:64], max_new_tokens=64) for s in specs]
    serving["captured_against_eager"] = {
        "slot": capture_check(torch, "Qwen2 slot engine at 8 rows",
                              engine_steps(torch, runs["slot"], short), forwards=8, steps=(1, 4, 2)),
        "paged": capture_check(torch, "Qwen2 paged engine at 8 rows", engine_steps(
            torch, lambda: PagedServingEngine(params, cfg, max_batch=8, n_pages=16, page_size=SERVE_PAGE, device=dev),
            short))}
    torch.cuda.empty_cache()

    # One decode step at 12 rows on a bf16 cache: decode_attention without
    # its fused wo, then the prefill projections; kernels against plain.
    b = 12
    gen = torch.Generator().manual_seed(9)
    lens = torch.randint(8, 600, (b,), generator=gen, dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, dtype=torch.int32).to(dev)
    cache = decoder.init_cache(cfg, b, QWEN2_CACHE, device="cuda")
    for li in range(cfg.n_layers):
        for key in ("k", "v"):
            cache[key][li].normal_(generator=torch.Generator(device=dev).manual_seed(li))
    cache["len"].copy_(lens.to(dev))
    cache["host_len"][:] = lens.numpy()

    def step():
        c = {k: ([t.clone() for t in v] if isinstance(v, list) else v.copy() if k == "host_len" else v.clone())
             for k, v in cache.items()}
        return decoder.forward(params, cfg, toks, c)[0][:, 0]

    dispatch.reset_counters()
    k_logits = step()
    torch.cuda.synchronize()
    b12 = dict(dispatch.LAUNCHES)
    if b12.get("decode_attention:no_wo") != cfg.n_layers or any(dispatch.PLAIN.values()):
        raise AssertionError(f"12-row step: decode_attention:no_wo must launch {cfg.n_layers} times: {b12}")
    with plain_decoder(decoder):
        p_logits = step()
    top = p_logits.argmax(-1)
    gap = (k_logits.max(-1).values - k_logits.gather(1, top[:, None])[:, 0]).max().item()
    if not (gap <= GAP_TOL and bool(torch.isfinite(k_logits).all())):
        raise AssertionError(f"12-row step: the plain argmax loses to the kernels' by {gap} > {GAP_TOL}")
    log(f"  12-row decode step: launches {b12}; kernels against plain max |logit| difference "
        f"{(k_logits - p_logits).abs().max().item():.4g}, argmax agree {int((k_logits.argmax(-1) == top).sum())}/{b}")
    for name, n in b12.items():
        launches[name] = launches.get(name, 0) + n
    out["qwen2_serving"] = serving
    out["qwen2_b12"] = dict(launches=b12, argmax_agree=int((k_logits.argmax(-1) == top).sum()), worst_gap=gap)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 10: sampled generation — generate_scan captured as one CUDA graph,
# speculative decoding, sampled serving
# ---------------------------------------------------------------------------

N_SCAN, N_QWEN2_SCAN, SPEC_K, SPEC_NEW, SPEC_ROUNDS = 256, 128, 4, 128, 8
SCAN_SAMPLERS = (("greedy", None, ()), ("temperature 0.8", "TemperatureSampler", (0.8,)),
                 ("top-k 50 at 0.8", "TopKSampler", (50, 0.8)), ("top-p 0.9 at 0.8", "TopPSampler", (0.9, 0.8)))


def make_sampler(cls, args):
    from rten_tpu_torch.generate import sampler as sm

    return None if cls is None else getattr(sm, cls)(*args)


def scan_case(torch, cfg, params, prompt, cache_len, n_steps, sampler, attn, label):
    """``generate_scan`` at batch 1 after ``prompt`` [1, P], generator seed
    1 for a sampler: eager (``decoder._scan_steps``, one forward at a
    time), then captured (the first call captures and replays, and must
    give the eager tokens), then 3 replays after rewinding the cache's
    lengths to P and reseeding (the same tokens again). Host ms a step of
    the eager steps and of the replays (median), device ms a step from the
    profiler over N_FORCED eager steps and one replay, and the idle shares; each
    step must launch ``attn`` once a layer and nothing run a plain version.
    With a sampler, N_FORCED teacher-forced steps: on each step's logits
    and the noise ``sample`` draws, the card's ``choose`` equals the
    stream and ``choose`` on the host. Returns (numbers, the captured
    call's launches)."""
    from rten_tpu_torch.generate.sampler import gumbel
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder

    ids = torch.from_numpy(prompt).cuda()
    n_prompt = ids.shape[1]

    def fresh():
        cache = decoder.init_cache(cfg, 1, cache_len, device="cuda")
        first, cache = decoder.prefill(params, cfg, ids, cache, lm_head_mode="argmax", last_only=True)
        return cache, first, torch.Generator(device="cuda").manual_seed(1)

    def rewind(cache, rng):
        cache["len"].fill_(n_prompt)
        cache["host_len"][:] = n_prompt
        rng.manual_seed(1)

    cache, first, rng = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = decoder._scan_steps(params, cfg, cache, first, rng, n_steps, sampler).cpu()
    eager_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    rewind(cache, rng)
    eager_dev = device_us_by_kernel(torch, lambda: decoder._scan_steps(params, cfg, cache, first, rng, N_FORCED,
                                                                         sampler), 1)
    eager_dev_ms = sum(eager_dev.values()) / 1e3 / N_FORCED

    cache, first, rng = fresh()
    torch.cuda.synchronize()
    dispatch.reset_counters()
    t0 = time.perf_counter()
    toks, cache = decoder.generate_scan(params, cfg, cache, first, rng, n_steps=n_steps, sampler=sampler)
    toks = toks.cpu()
    first_call_s = time.perf_counter() - t0
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    if len(decoder._GRAPHS.get(cache["len"], ())) != 1:
        raise AssertionError(f"{label}: generate_scan did not capture one graph")
    if not torch.equal(toks, eager):
        at = first_difference(toks[0].tolist(), eager[0].tolist())
        raise AssertionError(f"{label}: captured tokens differ from eager at step {at}")
    if any(plain.values()) or launches.get(attn, 0) != cfg.n_layers * n_steps:
        raise AssertionError(f"{label}: {attn} must launch {cfg.n_layers} times a step, no plain call: "
                             f"{launches} {plain}")
    if int(cache["len"][0]) != n_prompt + n_steps or int(cache["host_len"][0]) != n_prompt + n_steps:
        raise AssertionError(f"{label}: cache lengths {cache['len'].tolist()} / {cache['host_len']} after the replay")
    times = []
    for _ in range(3):
        rewind(cache, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, cache = decoder.generate_scan(params, cfg, cache, first, rng, n_steps=n_steps, sampler=sampler)
        again = again.cpu()
        times.append((time.perf_counter() - t0) * 1e3 / n_steps)
        if not torch.equal(again, toks):
            raise AssertionError(f"{label}: a replay from the same lengths and seed gave other tokens")
    captured_ms = statistics.median(times)
    rewind(cache, rng)
    dev = device_us_by_kernel(torch, lambda: decoder.generate_scan(params, cfg, cache, first, rng, n_steps=n_steps,
                                                                     sampler=sampler), 1)
    dev_ms = sum(dev.values()) / 1e3 / n_steps

    forced = None
    if sampler is not None:  # teacher-forced: the card's choice on the stream's own logits and noise
        cache, first, rng = fresh()
        tok, agree_host = first, 0
        for i in range(N_FORCED):
            logits, cache = decoder.forward(params, cfg, tok, cache)
            lg = logits[:, -1]
            noise = gumbel(rng, sampler.noise_shape(lg), lg.device)
            card = int(sampler.choose(lg, noise)[0])
            host = int(sampler.choose(lg.cpu(), noise.cpu())[0])
            if card != int(eager[0, i]) or host != card:
                raise AssertionError(f"{label}: teacher-forced step {i}: card {card}, host {host}, stream "
                                     f"{int(eager[0, i])}")
            agree_host += 1
            tok = toks[:, i : i + 1].cuda()
        forced = agree_host
    distinct = len(set(toks[0].tolist()))
    res = dict(n_steps=n_steps, eager_ms_per_step=eager_ms, captured_ms_per_step=captured_ms,
               captured_ms_all=times, eager_tokens_per_s=1e3 / eager_ms, captured_tokens_per_s=1e3 / captured_ms,
               first_call_s=first_call_s, device_ms_per_step=dev_ms or None,
               eager_device_ms_per_step=eager_dev_ms or None,
               idle_share=max(0.0, 1.0 - dev_ms / captured_ms) if dev_ms else None,
               eager_idle_share=max(0.0, 1.0 - eager_dev_ms / eager_ms) if eager_dev_ms else None,
               device_us_by_kernel={k: v / n_steps for k, v in dev.items()}, distinct_tokens=distinct,
               forced_agree=forced, launches=launches, tokens=toks[0].tolist())
    dev_txt = f"{dev_ms:.4f}" if dev_ms else "not measured"
    log(f"  {label}: captured equals eager over {n_steps} steps ({distinct} distinct tokens); host "
        f"{captured_ms:.4f} ms/step captured ({1e3 / captured_ms:.1f} tokens/s) against {eager_ms:.4f} eager "
        f"({1e3 / eager_ms:.1f} tokens/s); device {dev_txt} ms/step captured, {eager_dev_ms:.4f} eager (profiler) "
        f"-> idle share {res['idle_share'] if res['idle_share'] is None else round(res['idle_share'], 4)} captured, "
        f"{res['eager_idle_share'] if res['eager_idle_share'] is None else round(res['eager_idle_share'], 4)} eager; "
        f"first call (warm-up, capture, replay) {first_call_s:.3f} s"
        + (f"; teacher-forced {forced}/{N_FORCED} card choice = stream = host choice" if forced else ""))
    return res, launches


def spec_stream(torch, cfg, params, dcfg, dparams, prompt, sampler=None):
    """GPT-2 speculative decoding at batch 1 through ``speculative_scan``
    (greedy) or ``speculative_sample_scan`` (a TemperatureSampler, seed 3)
    after ``prompt``, SPEC_ROUNDS rounds a call, until SPEC_NEW tokens:
    (tokens, each round's count, host ms per emitted token, launches)."""
    from rten_tpu_torch.generate import speculative
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder

    ids = torch.from_numpy(prompt).cuda()
    max_len = CACHE_LEN  # ≥ prompt + SPEC_NEW + SPEC_ROUNDS (K + 1) + K + 2; Generator.with_draft's too
    rng = torch.Generator(device="cuda").manual_seed(3)
    # One pair of caches, emptied for each run: the timed run replays the
    # rounds' graph the warm-up captured.
    cache_t = decoder.init_cache(cfg, 1, max_len, device="cuda")
    cache_d = decoder.init_cache(dcfg, 1, max_len, device="cuda")

    def run():
        for cache in (cache_t, cache_d):
            cache["len"].zero_()
            cache["host_len"][:] = 0
        logits, _ = decoder.prefill(params, cfg, ids, cache_t, last_only=True)
        decoder.prefill(dparams, dcfg, ids, cache_d, lm_head_mode="argmax", last_only=True)
        first = sampler.sample(rng, logits[:, -1]) if sampler else logits[:, -1].argmax(-1)
        last = first.view(1, 1).to(torch.int32)
        out, counts = [int(last[0, 0])], []
        while len(out) < SPEC_NEW:
            if sampler is None:
                toks, cnt, _, _, last = speculative.speculative_scan(
                    params, cfg, cache_t, dparams, dcfg, cache_d, last, k=SPEC_K, n_rounds=SPEC_ROUNDS)
            else:
                toks, cnt, _, _, last = speculative.speculative_sample_scan(
                    params, cfg, cache_t, dparams, dcfg, cache_d, last, rng, sampler.temperature, k=SPEC_K,
                    n_rounds=SPEC_ROUNDS)
            for r in range(cnt.shape[0]):
                out.extend(int(t) for t in toks[r, 0, : cnt[r, 0]])
                counts.append(int(cnt[r, 0]))
        return out[:SPEC_NEW], counts

    run()  # warm-up
    rng.manual_seed(3)
    dispatch.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, counts = run()
    ms = (time.perf_counter() - t0) * 1e3 / SPEC_NEW
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    if any(plain.values()) or not launches.get("flash_attention"):
        raise AssertionError(f"speculative: the verify's flash_attention not launched, or plain calls: {launches} "
                             f"{plain}")
    return out, counts, ms, launches


def spec_steps(torch, cfg, params, dcfg, dparams, prompt, sampler=None):
    """``capture_check``'s ``make`` of speculative decoding at batch 1 after
    ``prompt``: both caches prefilled, the target's first token, then one
    call of SPEC_ROUNDS rounds (K SPEC_K) a ``step()``, greedy or at the
    sampler's temperature (seed 3); ``result()`` is every call's tokens,
    counts and next token."""
    from rten_tpu_torch.generate import speculative

    def make():
        rng = torch.Generator(device="cuda").manual_seed(3)
        cache_t, cache_d, logits = speculative._prefill_both(params, cfg, dparams, dcfg, prompt, SPEC_NEW, SPEC_K,
                                                             CACHE_LEN, "cuda")
        first = sampler.sample(rng, logits) if sampler else logits.argmax(-1)
        state = dict(last=first.view(1, 1).to(torch.int32), calls=[])

        def step():
            common = (params, cfg, cache_t, dparams, dcfg, cache_d, state["last"])
            if sampler is None:
                toks, counts, _, _, last = speculative.speculative_scan(*common, k=SPEC_K, n_rounds=SPEC_ROUNDS)
            else:
                toks, counts, _, _, last = speculative.speculative_sample_scan(
                    *common, rng, sampler.temperature, k=SPEC_K, n_rounds=SPEC_ROUNDS)
            state["last"] = last
            state["calls"].append((toks.tolist(), counts.tolist(), last.tolist()))

        return step, lambda: state["calls"]

    return make


def forced_gaps(torch, cfg, params, prompt, stream):
    """The target's own verdict on a stream: one prefill forward of the
    prompt and the stream (phase 4's one-forward check); at each position,
    the gap from the maximum logit to the stream token's, and the top-2
    gap."""
    from rten_tpu_torch.models import decoder

    seq = torch.tensor([list(prompt[0]) + stream[:-1]], dtype=torch.int32, device="cuda")
    lg, _ = decoder.prefill(params, cfg, seq, decoder.init_cache(cfg, 1, CACHE_LEN, device="cuda"))
    lg = lg[0, prompt.shape[1] - 1:]  # the logits that chose stream[0], stream[1], ...
    top2 = torch.topk(lg, 2, dim=-1).values
    loss = top2[:, 0] - lg.gather(1, torch.tensor(stream, device="cuda")[:, None])[:, 0]
    return loss.tolist(), (top2[:, 0] - top2[:, 1]).tolist()


def short_rounds(counts, n: int) -> list:
    """The stream positions of the corrections of rounds that accepted
    fewer than K drafts, within the stream's first ``n`` tokens (the first
    token comes from the prefill)."""
    pos, out = 1, []
    for c in counts:
        if c != SPEC_K + 1 and pos + c - 1 < n:
            out.append(pos + c - 1)
        pos += c
    return out


def drive_generation(torch, mem_rate, out):
    """Phase 10: GPT-2-small (seed 0) through ``generate_scan`` greedy and
    with each sampler (``scan_case``: 256 steps after the 64-token prompt in
    a 768-position cache), the Qwen2-0.5B shape with top-p 0.9 at 0.7 (128
    steps in 1024); speculative decoding with K 4 against the target itself
    (every round K+1 until the stream leaves the plain one) and a 2-layer
    draft at GPT-2's widths (seed 2), greedy and at temperature 1e-4 (each
    stream against the plain greedy stream under the top-2 rule), and the
    same through ``Generator.with_draft``; then phase 5's 16 requests
    through the slot and paged engines with TemperatureSampler(0.8): two
    runs with one seed give the same streams, and temperature 1e-4 the
    greedy engine's streams (top-2 rule against the solo gaps)."""
    import dataclasses

    import numpy as np

    from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend
    from rten_tpu_torch.generate.sampler import TemperatureSampler
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine

    dev = torch.device("cuda", 0)
    launches: dict = {}

    def add(run):
        for name, n in run.items():
            launches[name] = launches.get(name, 0) + n

    cfg = decoder.DecoderConfig(dtype=torch.bfloat16, max_seq=1024)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cuda"), device="cuda")
    prompt_gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, N_PROMPT), generator=prompt_gen).to(torch.int32).numpy()
    scan = {}
    t_phase = time.perf_counter()
    for label, cls, args in SCAN_SAMPLERS:
        scan[label], run = scan_case(torch, cfg, params, prompt, CACHE_LEN, N_SCAN, make_sampler(cls, args),
                                     "decode_attention", f"GPT-2 {label}")
        add(run)

    log(f"  ({time.perf_counter() - t_phase:.1f} s)")
    t_phase = time.perf_counter()
    # Speculative decoding: the plain greedy stream with each step's top-2 gap, then K 4 rounds.
    solo = GapArgMax()
    plain = [int(t[0]) for t in Generator(NativeBackend(params, cfg, max_len=CACHE_LEN, device=dev),
                                          GeneratorConfig(max_tokens=SPEC_NEW)).with_prompt(prompt).with_sampler(solo)]
    if plain[1:] != scan["greedy"]["tokens"][: SPEC_NEW - 1]:  # plain[0] is the prefill's token
        raise AssertionError("the logits path's greedy stream differs from generate_scan's")
    dcfg = dataclasses.replace(cfg, n_layers=2)
    dparams = decoder.quantize_params_int8(decoder.init_params(2, dcfg, device="cuda"), device="cuda")
    spec = {}
    for label, dc, dp, sampler in (("draft = target", cfg, params, None), ("2-layer draft", dcfg, dparams, None),
                                   ("2-layer draft, temperature 1e-4", dcfg, dparams, TemperatureSampler(1e-4))):
        toks, counts, ms, run = spec_stream(torch, cfg, params, dc, dp, prompt, sampler)
        add(run)
        diff = check_streams(f"speculative, {label}", [toks], [plain], [solo.gaps])
        at = first_difference(toks, plain)
        # Every token the target's near-argmax given the stream before it;
        # a draft that is the target loses a round only at a near-tie.
        loss, top2 = forced_gaps(torch, cfg, params, prompt, toks)
        if max(loss) > GAP_TOL:
            raise AssertionError(f"speculative, {label}: token {loss.index(max(loss))} loses to the target's argmax "
                                 f"by {max(loss):.4g} > {GAP_TOL}")
        ties = [top2[i] for i in short_rounds(counts, len(toks))]
        if dc is cfg and any(g >= GAP_TOL for g in ties):
            raise AssertionError(f"speculative, {label}: a round short of K+1 where the target's top-2 gap is "
                                 f"{max(ties):.4g} >= {GAP_TOL}: {counts}")
        acc = (sum(counts) - len(counts)) / (SPEC_K * len(counts))
        spec[label] = dict(ms_per_token=ms, tokens_per_s=1e3 / ms, rounds=len(counts),
                           mean_count=sum(counts) / len(counts), acceptance=acc, counts=counts,
                           differs_from_plain_at=at, worst_loss=max(loss), short_round_gaps=ties if dc is cfg else None,
                           launches=run, tokens=toks)
        log(f"  speculative K {SPEC_K}, {label}: {SPEC_NEW} tokens in {len(counts)} rounds, mean "
            f"{sum(counts) / len(counts):.3f} tokens a round (acceptance {acc:.4f}); host {ms:.4f} ms per emitted "
            f"token ({1e3 / ms:.1f} tokens/s); first difference from the plain greedy stream {at} ({diff} differing); "
            f"every token within {max(loss):.4g} of the target's argmax given its prefix (one forward)"
            + (f"; short rounds' top-2 gaps {[round(g, 4) for g in ties]}" if dc is cfg else ""))
    # The rounds captured against eager (the 2-layer draft, greedy and at
    # temperature 1e-4): a call of SPEC_ROUNDS rounds a step.
    spec_captured = {}
    for label, sampler in (("greedy", None), ("temperature 1e-4", TemperatureSampler(1e-4))):
        spec_captured[label] = capture_check(
            torch, f"speculative rounds, 2-layer draft, {label}", spec_steps(torch, cfg, params, dcfg, dparams, prompt,
                                                                            sampler),
            forwards=SPEC_ROUNDS, steps=(1, 4, 1))
    # The same through Generator.with_draft (greedy): its stream equals spec_stream's.
    gen = Generator(NativeBackend(params, cfg, max_len=CACHE_LEN, device=dev), GeneratorConfig(max_tokens=SPEC_NEW))
    gen.with_prompt(prompt).with_draft(NativeBackend(dparams, dcfg, max_len=CACHE_LEN, device=dev), k=SPEC_K,
                                       rounds_per_call=SPEC_ROUNDS)
    dispatch.reset_counters()
    drafted = [int(t[0]) for t in gen]
    add(dict(dispatch.LAUNCHES))
    if drafted != spec["2-layer draft"]["tokens"]:
        raise AssertionError("Generator.with_draft's stream differs from speculative_scan's")
    log(f"  Generator.with_draft (2-layer draft, K {SPEC_K}): its {len(drafted)} tokens equal speculative_scan's")
    del dparams
    log(f"  ({time.perf_counter() - t_phase:.1f} s)")
    t_phase = time.perf_counter()

    # Qwen2-0.5B shape, top-p.
    qcfg = decoder.DecoderConfig(**QWEN2_CFG, dtype=torch.bfloat16)
    qparams = qwen2_params(torch, qcfg)
    qprompt = torch.randint(0, qcfg.vocab_size, (1, N_PROMPT), generator=torch.Generator().manual_seed(0)).to(
        torch.int32).numpy()
    qwen2, run = scan_case(torch, qcfg, qparams, qprompt, QWEN2_CACHE, N_QWEN2_SCAN,
                           make_sampler("TopPSampler", (0.9, 0.7)), "decode_attention:gqa", "Qwen2 top-p 0.9 at 0.7")
    add(run)
    del qparams
    qwen2_params.cache_clear()
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t_phase:.1f} s)")
    t_phase = time.perf_counter()

    # Sampled serving: phase 5's requests.
    specs = serving_specs(cfg)
    t0 = time.perf_counter()
    _, solo_gaps = solo_streams(params, cfg, specs, dev)
    log(f"  serving: {N_REQUESTS} requests; solo gaps {time.perf_counter() - t0:.1f} s")
    pages = sum(-(-(len(s["prompt"]) + s["max_new_tokens"]) // SERVE_PAGE) for s in specs)
    makers = {"slot": lambda **kw: ServingEngine(params, cfg, max_batch=8, steps_per_tick=8, device=dev, **kw),
              "paged": lambda **kw: PagedServingEngine(params, cfg, max_batch=8, n_pages=pages, page_size=SERVE_PAGE,
                                                       device=dev, **kw)}
    total_new = sum(s["max_new_tokens"] for s in specs)
    serving = {}
    for kind, make in makers.items():
        streams = {}
        for label, kw in (("greedy", {}), ("temperature 0.8 seed 5", dict(sampler=TemperatureSampler(0.8), seed=5)),
                          ("temperature 0.8 seed 5 again", dict(sampler=TemperatureSampler(0.8), seed=5)),
                          ("temperature 1e-4", dict(sampler=TemperatureSampler(1e-4), seed=6))):
            engine = make(**kw)
            reqs = [engine.submit(Request(**s)) for s in specs]
            torch.cuda.synchronize()
            dispatch.reset_counters()
            t0 = time.perf_counter()
            engine.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run, plain_calls = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
            if any(plain_calls.values()) or not all(run.get(k) for k in ENGINE_KERNELS[kind]):
                raise AssertionError(f"sampled {kind} {label}: launches {run}, plain {plain_calls}")
            if not all(r.finished and len(r.output) == s["max_new_tokens"] for r, s in zip(reqs, specs)):
                raise AssertionError(f"sampled {kind} {label}: a request did not finish with its budget")
            add(run)
            streams[label] = [r.output for r in reqs]
            serving[f"{kind} {label}"] = dict(wall_s=wall, tokens_per_s=total_new / wall, forwards=engine.steps)
            log(f"  {kind} engine, {label}: {total_new} tokens in {wall:.3f} s -> {total_new / wall:.1f} generated "
                f"tokens/s")
            del engine
        if streams["temperature 0.8 seed 5"] != streams["temperature 0.8 seed 5 again"]:
            raise AssertionError(f"sampled {kind}: two runs with one seed gave other streams")
        if streams["temperature 0.8 seed 5"] == streams["greedy"]:
            raise AssertionError(f"sampled {kind}: temperature 0.8 drew the greedy streams")
        n_diff = check_streams(f"{kind} temperature 1e-4 vs greedy", streams["temperature 1e-4"], streams["greedy"],
                               solo_gaps)
        serving[f"{kind} differing at 1e-4"] = n_diff
        log(f"  {kind} engine: one seed, the same streams; temperature 1e-4 equals greedy ({n_diff} differ, top-2 "
            f"rule)")
    log(f"  ({time.perf_counter() - t_phase:.1f} s)")
    out["generation"] = dict(gpt2_scan=scan, qwen2_scan=qwen2, speculative=spec, serving=serving,
                             speculative_captured_against_eager=spec_captured)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 11: Whisper-tiny through Generator(EncDecBackend)
# ---------------------------------------------------------------------------

# Whisper's start of transcript: <|startoftranscript|> <|en|> <|transcribe|>
# <|notimestamps|> (the multilingual vocabulary of whisper-tiny).
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
N_WHISPER_NEW, WHISPER_GATE = 200, 0.05
WHISPER_STEP = {"quant_gemv_int8": 4, "flash_attention": 1, "quant_mlp_int8": 1}  # launches a layer a step
WHISPER_KV = {True: "decode_attention_int8", False: "decode_attention:no_wo"}


@contextlib.contextmanager
def plain_encdec(ed):
    """Route the encoder-decoder's kernel calls (and the decoder module's
    flash_attention, which its prompt's attention reaches) to their plain
    versions, and EncDecBackend's step to its eager forward."""
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import quant_matmul as qm
    from rten_tpu_torch.models import decoder

    plain = {ed: dict(quant_gemv_int8=qm.quant_gemv_int8_ref, quant_mlp_int8=qm.quant_mlp_int8_ref,
                      quant_matmul_int8=qm.quant_matmul_int8_ref, decode_attention=da.decode_attention_ref,
                      decode_attention_int8=da.decode_attention_int8_ref, flash_attention=at.flash_attention_ref),
             decoder: dict(flash_attention=at.flash_attention_ref, _capturable=lambda *args: False)}
    saved = {(mod, name): getattr(mod, name) for mod, names in plain.items() for name in names}
    for mod, names in plain.items():
        for name, fn in names.items():
            setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def drive_whisper(torch, mem_rate, out) -> dict:
    """Phase 11: Whisper-tiny at full width (WHISPER_TINY: random weights
    from seed 0, int8 by quantize_params_int8, bf16 activations) through
    Generator(EncDecBackend(..., device="cuda")), with int8 KV (BASELINE's
    configuration), then a bf16 cache: a seeded [1, 80, 3000] mel (30 s,
    1500 encoder positions) encoded once, the 4 start-of-transcript tokens
    as one prefill, then N_WHISPER_NEW greedy steps in the 448-position
    cache. Records the time to first token (encode and prompt, host clock),
    the encoder's device µs by kernel, host ms a step and tokens/s, device
    ms a step and the idle share (profiler), and one decode step's launches,
    which must be WHISPER_STEP a layer, the KV kernel once a layer and the
    lm_head GEMV, with no plain version. Then the encoder states and
    N_FORCED teacher-forced steps (the prompt, then the served tokens one at
    a time) through the kernels against the plain versions on the same
    inputs: relative RMS at most WHISPER_GATE, the served token the argmax
    of the kernels' logits, and another plain argmax only where its top-2
    gap is below GAP_TOL. Returns the main runs' launches."""
    import dataclasses

    import numpy as np

    from rten_tpu_torch.generate import EncDecBackend, Generator, GeneratorConfig, Metrics
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import encoder_decoder as ed

    t0 = time.perf_counter()
    base = ed.WHISPER_TINY
    params = ed.quantize_params_int8(ed.init_params(0, base, device="cuda"), device="cuda")
    mel = torch.randn(1, base.n_mels, 2 * base.n_audio_ctx, generator=torch.Generator().manual_seed(11))
    torch.cuda.synchronize()
    n_layers = base.n_text_layers
    log(f"  params: Whisper-tiny int8, seed 0, {time.perf_counter() - t0:.1f} s to make and quantize; mel "
        f"{tuple(mel.shape)} from seed 11")
    weight = stream_bytes(params["dec_layers"]) + stream_bytes(params["lm_head_q"])
    cross_bytes = 2 * n_layers * base.n_audio_ctx * base.d_model * 2
    launches_total, results = {}, {}
    for int8 in (True, False):
        cfg = dataclasses.replace(base, int8_kv=int8)
        key = "int8_kv" if int8 else "bf16_kv"

        warm = EncDecBackend(params, cfg, mel, device="cuda")  # plans and the allocator, outside the counted run
        list(Generator(warm, GeneratorConfig(max_tokens=4)).with_prompt([list(WHISPER_PROMPT)]))
        del warm
        torch.cuda.synchronize()
        dispatch.reset_counters()
        metrics = Metrics()
        t_start = time.perf_counter()
        backend = EncDecBackend(params, cfg, mel, device="cuda")
        gen = Generator(backend, GeneratorConfig(max_tokens=N_WHISPER_NEW + 1)).with_prompt([list(WHISPER_PROMPT)])
        it = iter(gen.profile(metrics))
        tokens = [int(next(it)[0])]
        ttft = (time.perf_counter() - t_start) * 1e3
        tokens += [int(t[0]) for t in it]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        for name, n in launches.items():
            launches_total[name] = launches_total.get(name, 0) + n
        if any(plain.values()):
            raise AssertionError(f"whisper {key}: plain versions ran on the main path: {plain}")
        if len(tokens) != N_WHISPER_NEW + 1 or not all(0 <= t < base.vocab_size for t in tokens):
            raise AssertionError(f"whisper {key}: the stream has the wrong length or out-of-vocabulary ids")
        # The host step time from the same backend again, reset: its first
        # run's first decode step captured the graph its steps replay.
        backend.reset()
        metrics = Metrics()
        again = [int(t[0]) for t in Generator(backend, GeneratorConfig(max_tokens=N_WHISPER_NEW + 1)).with_prompt(
            [list(WHISPER_PROMPT)]).profile(metrics)]
        if again != tokens:
            raise AssertionError(f"whisper {key}: the reset backend's stream differs from the first run's")
        step_ms = metrics.mean_step_ms()
        captured = capture_check(torch, f"whisper {key} EncDecBackend decode step",
                                 backend_steps(torch, lambda: EncDecBackend(params, cfg, mel, device="cuda"),
                                               [list(WHISPER_PROMPT)], True))

        # One decode step's launches.
        dispatch.reset_counters()
        backend.decode(np.array([[tokens[-1]]], np.int32), greedy=True)
        step_launches, step_plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        want = {name: n * n_layers for name, n in WHISPER_STEP.items()}
        want["quant_gemv_int8"] += 1  # the lm_head
        want[WHISPER_KV[int8]] = n_layers
        kernels = {name: n for name, n in step_launches.items() if ":split" not in name}  # split launches twice
        if kernels != want or step_plain:
            raise AssertionError(f"whisper {key}: a decode step launched {step_launches} (plain {step_plain}), "
                                 f"not {want}")

        # Device time of the encoder and of a decode step (profiler).
        enc_us = device_us_by_kernel(torch, lambda: ed.encode(params, cfg, mel.cuda()), 3)
        decode_us = device_us_by_kernel(
            torch, lambda: backend.decode(np.array([[tokens[1]]], np.int32), greedy=True), 16)
        dev_ms = sum(decode_us.values()) / 1e3
        idle = max(0.0, 1.0 - dev_ms / step_ms) if dev_ms > 0 else None
        avg_prefix = len(WHISPER_PROMPT) + N_WHISPER_NEW / 2
        kv = 2 * n_layers * avg_prefix * base.d_model * (1 + 4 / base.head_dim if int8 else 2)
        bound_ms = (weight + cross_bytes + kv) / mem_rate * 1e3
        results[key] = dict(
            ttft_ms=ttft, wall_s=wall, tokens_per_s=metrics.tokens_per_second(), ms_per_step=step_ms,
            device_ms_per_step=dev_ms, idle_share=idle, bound_ms_per_step=bound_ms, weight_bytes=weight,
            cross_kv_bytes=cross_bytes, kv_bytes=kv, launches=launches, launches_per_step=step_launches,
            encoder_device_us_by_kernel=enc_us, encoder_device_ms=sum(enc_us.values()) / 1e3,
            decode_device_us_by_kernel=decode_us, served_head=tokens[:16], captured_against_eager=captured,
        )
        log(f"  whisper {key}: time to first token {ttft:.4f} ms (encode + {len(WHISPER_PROMPT)}-token prompt, host "
            f"clock); {N_WHISPER_NEW} steps at {step_ms:.4f} ms/step (host clock, the reset backend's run) -> "
            f"{metrics.tokens_per_second():.1f} tokens/s; device {dev_ms:.4f} ms/step (profiler) -> idle share "
            f"{idle if idle is None else round(idle, 4)}; bound {bound_ms:.4f} ms/step ({weight} weight + "
            f"{cross_bytes} cross K/V + {kv:.0f} KV bytes); launches a step {step_launches}")
        log(f"    encoder device {results[key]['encoder_device_ms']:.4f} ms (profiler); by kernel (us):")
        for name, us in sorted(enc_us.items(), key=lambda kv_: -kv_[1])[:8]:
            log(f"      {us:9.3f}  {name[:90]}")
        log("    decode step by kernel (us):")
        for name, us in sorted(decode_us.items(), key=lambda kv_: -kv_[1])[:8]:
            log(f"      {us:9.3f}  {name[:90]}")

        # Teacher-forced: the encoder states and N_FORCED steps through the
        # kernels and through the plain versions on the same inputs.
        served = tokens[:N_FORCED]

        def forced():
            enc = ed.encode(params, cfg, mel.cuda())
            state = ed.init_decoder_state(params, cfg, enc)
            ids = torch.tensor([list(WHISPER_PROMPT)], dtype=torch.int32, device="cuda")
            lg, state = ed.decode(params, cfg, ids, state, last_only=True)
            rows = [lg[0, -1]]
            for tok in served[:-1]:
                lg, state = ed.decode(params, cfg, torch.tensor([[tok]], dtype=torch.int32, device="cuda"), state)
                rows.append(lg[0, -1])
            return enc, torch.stack(rows)

        enc_k, k_logits = forced()
        with plain_encdec(ed):
            enc_p, p_logits = forced()
        torch.cuda.synchronize()
        served_t = torch.tensor(served, device="cuda")
        if not torch.equal(k_logits.argmax(-1), served_t):
            raise AssertionError(f"whisper {key}: the served stream differs from the argmax of its kernels' logits")
        p_gaps = p_logits.max(-1).values - p_logits.gather(1, served_t[:, None])[:, 0]
        if bool((p_gaps > GAP_TOL).any()):
            raise AssertionError(f"whisper {key}: a served token loses to the plain argmax by > {GAP_TOL}: "
                                 f"{p_gaps.tolist()}")
        gate = dict(logits_rel_rms=rel_rms(k_logits, p_logits), encoder_rel_rms=rel_rms(enc_k, enc_p),
                    encoder_max_abs=(enc_k.float() - enc_p.float()).abs().max().item(),
                    argmax_agree_plain=int((p_gaps == 0).sum()), max_gap_plain=p_gaps.max().item(),
                    bound=WHISPER_GATE)
        results[key]["forced"] = gate
        log(f"    teacher-forced {N_FORCED} steps: logits relative RMS kernels against plain "
            f"{gate['logits_rel_rms']:.5f} (bound {WHISPER_GATE}); the plain argmax is the served token at "
            f"{gate['argmax_agree_plain']}/{N_FORCED}, worst gap {gate['max_gap_plain']:.4g} (tol {GAP_TOL}); "
            f"encoder states relative RMS {gate['encoder_rel_rms']:.5f}, max |diff| {gate['encoder_max_abs']:.4g}")
        if not (gate["logits_rel_rms"] <= WHISPER_GATE and gate["encoder_rel_rms"] <= WHISPER_GATE
                and bool(torch.isfinite(k_logits).all())):
            raise AssertionError(f"whisper {key}: kernels and plain versions differ beyond the bound: {gate}")
        del backend, gen
        torch.cuda.empty_cache()
    out["whisper"] = results
    del params
    torch.cuda.empty_cache()
    return launches_total


# Phase 12: the encoders and vision models at full width (random weights
# from seed 0, nothing cut).
ENCODER_GATE_F32, ENCODER_GATE_BF16 = 1e-4, 0.05  # relative RMS of kernels against plain versions
ENCODER_F64_GATE = 1e-4  # relative RMS of the f32 forward against f64 (TF32 would give ~1e-3)
ENCODER_REPS = 7  # host-timed forwards (median)
W2V_RATE, W2V_SECONDS = 16000, (10.0, 7.7, 5.2, 3.1)  # 4 waveforms, padded to 10 s
ENCODER_LAUNCHES = {  # a forward's launches by kernel, by the JAX quantizer's rules
    "distilbert f32": {"quant_matmul_int8": 36, "flash_attention": 6},
    "distilbert bf16": {"quant_matmul_int8": 36, "flash_attention": 6},
    "minilm f32": {"quant_matmul_int8": 36, "flash_attention": 6},
    "minilm bf16": {"quant_matmul_int8": 36, "flash_attention": 6},
    "wav2vec2": {"quant_matmul_int8": 72, "flash_attention": 12},
    "vit": {"flash_attention": 12},
    "mobilenet": {"quant_matmul_int8": 34},
    "resnet50": {},
}


@contextlib.contextmanager
def plain_encoders():
    """Route the encoders' and vision models' kernel calls (BERT's, which
    wav2vec2's layers share, and MobileNet's quant_matmul_int8; BERT's and
    ViT's flash_attention) to their plain versions."""
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import quant_matmul as qm
    from rten_tpu_torch.models import bert, mobilenet, vit

    plain = [(bert, "quant_matmul_int8", qm.quant_matmul_int8_ref),
             (mobilenet, "quant_matmul_int8", qm.quant_matmul_int8_ref)]
    plain += [(mod, "flash_attention", at.flash_attention_ref) for mod in (bert, vit)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in plain]
    for mod, name, fn in plain:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def tf32_defaults(torch):
    """Both TF32 flags on (cuDNN's default; cuBLAS's set too) inside the
    block, the process's flags back after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def top1_check(what: str, k_logits, p_logits) -> dict:
    """The kernels' argmax along the last axis against the plain versions':
    a different choice passes only where the plain top-2 gap is below
    GAP_TOL (the plain logits of the two choices that close)."""
    k_arg, p_arg = k_logits.float().argmax(-1), p_logits.float().argmax(-1)
    p = p_logits.float()
    gaps = p.gather(-1, p_arg[..., None])[..., 0] - p.gather(-1, k_arg[..., None])[..., 0]
    differ = int((k_arg != p_arg).sum())
    worst = gaps.max().item()
    if worst > GAP_TOL:
        raise AssertionError(f"{what}: the kernels' argmax loses to the plain one by {worst:.4g} > {GAP_TOL}")
    return dict(argmax_differ=differ, of=int(k_arg.numel()), worst_gap=worst)


def encoder_run(torch, key: str, fn, outputs, n_items: int, unit: str, out, launches_total):
    """One model of phase 12: ``fn()`` (a forward through the port's entry
    points) once with the launch counters read around it, which must equal
    ENCODER_LAUNCHES[key] with no plain call; ENCODER_REPS host-timed
    forwards (median); the device time by kernel (profiler) and the idle
    share; then ``outputs(result)`` of the kernels' forward against the
    same forward with the plain versions: relative RMS at most the gate of
    the model's dtype. Returns (kernel result, plain result)."""
    from rten_tpu_torch.kernels import dispatch

    fn()  # plans, cuDNN's algorithm choice and the allocator, outside the counted run
    torch.cuda.synchronize()
    dispatch.reset_counters()
    result = fn()
    torch.cuda.synchronize()
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    if plain:
        raise AssertionError(f"{key}: plain versions ran on the main path: {plain}")
    if {k: v for k, v in launches.items() if ":" not in k} != ENCODER_LAUNCHES[key]:
        raise AssertionError(f"{key}: a forward launched {launches}, not {ENCODER_LAUNCHES[key]}")
    for name, n in launches.items():
        launches_total[name] = launches_total.get(name, 0) + n
    times = []
    for _ in range(ENCODER_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(times)
    by_kernel = device_us_by_kernel(torch, fn, 3)
    dev_ms = sum(by_kernel.values()) / 1e3
    idle = max(0.0, 1.0 - dev_ms / host_ms) if dev_ms > 0 else None
    with plain_encoders():
        ref = fn()
    torch.cuda.synchronize()
    got, want = outputs(result), outputs(ref)
    gate = ENCODER_GATE_BF16 if "bf16" in key else ENCODER_GATE_F32
    rms = rel_rms(got, want)
    if not (rms <= gate and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{key}: kernels against plain versions relative RMS {rms:.3g} > {gate}")
    rec = dict(launches_per_forward=launches, host_ms=host_ms, host_ms_all=times, device_ms=dev_ms, idle_share=idle,
               per_s=n_items / (host_ms / 1e3), unit=unit, device_us_by_kernel=by_kernel, rel_rms_plain=rms,
               gate=gate)
    out[key] = rec
    log(f"  {key}: {host_ms:.4f} ms a forward (host clock, median of {ENCODER_REPS}) -> "
        f"{rec['per_s']:.2f} {unit}/s; device {dev_ms:.4f} ms (profiler) -> idle share "
        f"{idle if idle is None else round(idle, 4)}; launches {launches}; kernels against plain relative RMS "
        f"{rms:.3g} (gate {gate})")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"      {us:10.3f} us  {name[:90]}")
    return result, ref


def f64_check(torch, what: str, f32_fn, f64_fn) -> dict:
    """``f32_fn()`` with both TF32 flags on against ``f64_fn()``: relative
    RMS at most ENCODER_F64_GATE (the IEEE-f32 helper's proof)."""
    with tf32_defaults(torch):
        got = f32_fn()
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    want = f64_fn()
    torch.cuda.synchronize()
    rms = rel_rms(got, want)
    log(f"    {what}: f32 (TF32 flags {flags}) against f64 relative RMS {rms:.3g} (gate {ENCODER_F64_GATE})")
    if not rms <= ENCODER_F64_GATE:
        raise AssertionError(f"{what}: f32 against f64 relative RMS {rms:.3g} > {ENCODER_F64_GATE}")
    return dict(rel_rms_f64=rms, tf32_flags=list(flags), gate=ENCODER_F64_GATE)


def features_f64(torch, params, cfg, wav):
    """wav2vec2's conv stack in f64, written out here (the port's casts its
    convolutions to f32): the reference of its f32 check."""
    F = torch.nn.functional
    x = wav.double()[:, None, :]
    for i, layer in enumerate(params["convs"]):
        x = F.conv1d(x, layer["conv"].double(), stride=cfg.conv_stride[i])
        if "gn" in layer:
            x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, keepdim=True, unbiased=False)
                                                           + cfg.layer_norm_eps)
            x = x * layer["gn"]["scale"].double()[None, :, None] + layer["gn"]["bias"].double()[None, :, None]
        x = F.gelu(x)
    return x.transpose(1, 2)


def to_f64(torch, tree):
    if isinstance(tree, dict):
        return {k: to_f64(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f64(torch, v) for v in tree]
    return tree.double()


# all-MiniLM-L6-v2's widths (huggingface.co/sentence-transformers/
# all-MiniLM-L6-v2 config.json: 6 layers, d_model 384, 12 heads of 32, FF
# 1536, vocab 30522, 512 positions, 2 token types, LayerNorm eps 1e-12;
# bert.BertConfig's defaults give the last four), 8 sequences of seeded
# lengths 32-256 padded to 256: flash_attention at head dim 32.
MINILM = dict(n_layers=6, d_model=384, n_heads=12, d_ff=1536)
MINILM_B, MINILM_T = 8, 256


def drive_encoders(torch, out) -> tuple[dict, dict]:
    """Phase 12: the encoders and vision models at full width, random
    weights from seed 0 (encoder_run for each): DistilBERT-base INT8
    (8 sequences of seeded lengths 32-384 padded to 384; encode, qa_logits,
    pool) in f32 and then bf16; all-MiniLM-L6-v2's widths INT8 (MINILM: 8
    sequences of seeded lengths 32-256 with token types; encode and the
    mean pool, its sentence embeddings) in f32 and then bf16; wav2vec2-base INT8 (4 seeded 16 kHz
    waveforms of 3-10 s padded to 10 s, frame lengths from
    feat_extract_output_length; ctc_logits then the greedy CtcDecoder);
    ViT-B/16 (8 images of 224², classify and feature_map); MobileNetV2
    INT8 and ResNet-50 fp32 (8 images of 224² each). The QA start / end,
    the CTC frames and the top-1 classes against the plain versions'
    (top1_check); ResNet-50 and wav2vec2's conv stack in f32 with both TF32
    flags on against f64 (f64_check). Returns (the phase's launches, the
    f32 runs' launches)."""
    import numpy as np

    from rten_tpu_torch import ctc
    from rten_tpu_torch.models import bert, mobilenet, resnet, vit, wav2vec2

    dev = torch.device("cuda", 0)
    res, launches, f32_launches = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(21)
    t_phase = time.perf_counter()

    # DistilBERT-base INT8, f32 then bf16.
    rng = np.random.default_rng(0)
    lens = np.sort(rng.integers(32, ENC_T + 1, ENC_B))[::-1].copy()
    lens[0] = ENC_T
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
    ids = torch.randint(0, bert.DISTILBERT_BASE.vocab_size, (ENC_B, ENC_T), generator=gen, device=dev)
    valid = torch.arange(ENC_T, device=dev)[None, :] < lengths[:, None].long()
    qa_head = {"w": torch.randn(ENC_D, 2, generator=gen, device=dev) * 0.05, "b": torch.zeros(2, device=dev)}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(bert.DISTILBERT_BASE, dtype=dtype)
        key = f"distilbert {'f32' if dtype == torch.float32 else 'bf16'}"
        params = bert.quantize_params_int8(bert.init_params(0, cfg, device=dev), device=dev)

        def fn(params=params, cfg=cfg):
            hidden = bert.encode(params, cfg, ids, lengths=lengths)
            start, end = bert.qa_logits(hidden, qa_head, lengths)
            return hidden, start, end, bert.pool(hidden, lengths)

        def outputs(r):
            hidden, start, end, pooled = r
            return torch.cat([hidden[valid].float().reshape(-1), start[valid].float(), end[valid].float(),
                              pooled.float().reshape(-1)])

        (hidden, start, end, _), (_, p_start, p_end, _) = encoder_run(
            torch, key, fn, outputs, ENC_B, "sequences", res, launches)
        res[key]["qa_start"] = top1_check(f"{key} QA start", start, p_start)  # padding at -1e30 on both sides
        res[key]["qa_end"] = top1_check(f"{key} QA end", end, p_end)
        res[key]["lengths"] = lens.tolist()
        if dtype == torch.float32:
            for name, n in res[key]["launches_per_forward"].items():
                f32_launches[name] = f32_launches.get(name, 0) + n
        del params, hidden
        torch.cuda.empty_cache()

    # all-MiniLM-L6-v2's widths INT8, f32 then bf16: sentence embeddings.
    m_lens = np.sort(rng.integers(32, MINILM_T + 1, MINILM_B))[::-1].copy()
    m_lens[0] = MINILM_T
    m_lengths = torch.from_numpy(m_lens.astype(np.int32)).to(dev)
    m_ids = torch.randint(0, bert.BertConfig().vocab_size, (MINILM_B, MINILM_T), generator=gen, device=dev)
    m_seg = (torch.arange(MINILM_T, device=dev)[None, :] >= m_lengths[:, None].long() // 2).to(torch.int32)
    m_valid = torch.arange(MINILM_T, device=dev)[None, :] < m_lengths[:, None].long()
    for dtype in (torch.float32, torch.bfloat16):
        cfg = bert.BertConfig(**MINILM, dtype=dtype)
        key = f"minilm {'f32' if dtype == torch.float32 else 'bf16'}"
        params = bert.quantize_params_int8(bert.init_params(0, cfg, device=dev), device=dev)

        def fn(params=params, cfg=cfg):
            hidden = bert.encode(params, cfg, m_ids, lengths=m_lengths, segment_ids=m_seg)
            return hidden, bert.pool(hidden, m_lengths)

        def outputs(r):
            hidden, pooled = r
            return torch.cat([hidden[m_valid].float().reshape(-1), pooled.float().reshape(-1)])

        encoder_run(torch, key, fn, outputs, MINILM_B, "sequences", res, launches)
        res[key].update(lengths=m_lens.tolist(), head_dim=cfg.head_dim)
        if dtype == torch.float32:
            for name, n in res[key]["launches_per_forward"].items():
                f32_launches[name] = f32_launches.get(name, 0) + n
        del params
        torch.cuda.empty_cache()

    # wav2vec2-base INT8: 4 waveforms, CTC logits and the greedy decode.
    cfg = wav2vec2.WAV2VEC2_BASE
    params = wav2vec2.quantize_params_int8(wav2vec2.init_params(0, cfg, device=dev), device=dev)
    n_max = int(W2V_SECONDS[0] * W2V_RATE)
    wav = torch.zeros(len(W2V_SECONDS), n_max, device=dev)
    samples = [int(s * W2V_RATE) for s in W2V_SECONDS]
    for i, n in enumerate(samples):
        wav[i, :n] = torch.randn(n, generator=gen, device=dev) * 0.1
    frames = torch.tensor([wav2vec2.feat_extract_output_length(cfg, n) for n in samples], dtype=torch.int32,
                          device=dev)
    t_max = wav2vec2.feat_extract_output_length(cfg, n_max)
    fvalid = torch.arange(t_max, device=dev)[None, :] < frames[:, None].long()

    def w2v_fn():
        return wav2vec2.ctc_logits(params, cfg, wav, lengths=frames)

    logits, p_logits = encoder_run(torch, "wav2vec2", w2v_fn, lambda r: r[fvalid].reshape(-1),
                                   sum(W2V_SECONDS), "audio seconds", res, launches)
    res["wav2vec2"]["ctc_frames"] = top1_check("wav2vec2 CTC frames", logits[fvalid], p_logits[fvalid])
    texts, p_texts = [], []
    alphabet = "".join(chr(ord("a") + i) for i in range(26)) + "' .,-"
    for row, n in enumerate(frames.tolist()):
        lp = torch.log_softmax(logits[row, :n].double(), -1).cpu().numpy()
        plp = torch.log_softmax(p_logits[row, :n].double(), -1).cpu().numpy()
        texts.append(ctc.CtcDecoder().decode_greedy(lp).text(alphabet))
        p_texts.append(ctc.CtcDecoder().decode_greedy(plp).text(alphabet))
    if res["wav2vec2"]["ctc_frames"]["argmax_differ"] == 0 and texts != p_texts:
        raise AssertionError("wav2vec2: the CTC texts differ while every frame's argmax agrees")
    res["wav2vec2"].update(frames=frames.tolist(), texts_equal=texts == p_texts, text_head=[t[:40] for t in texts])
    log(f"    CTC greedy text equal to the plain versions' for {sum(a == b for a, b in zip(texts, p_texts))}/"
        f"{len(texts)} waveforms (frames {frames.tolist()}); head {texts[0][:40]!r}")
    res["wav2vec2"]["conv_stack_f64"] = f64_check(
        torch, "wav2vec2 conv stack", lambda: wav2vec2.extract_features(params, cfg, wav),
        lambda: features_f64(torch, params, cfg, wav))
    for name, n in res["wav2vec2"]["launches_per_forward"].items():
        f32_launches[name] = f32_launches.get(name, 0) + n
    del params, logits, p_logits
    torch.cuda.empty_cache()

    # The vision models: 8 seeded images of 224² each.
    images = torch.randn(8, 3, 224, 224, generator=gen, device=dev)
    vcfg = vit.VIT_BASE
    vparams = vit.init_params(0, vcfg, device=dev)

    v_logits, vp_logits = encoder_run(torch, "vit", lambda: vit.classify(vparams, vcfg, images),
                                      lambda r: r.reshape(-1), 8, "images", res, launches)
    res["vit"]["top1"] = top1_check("vit top-1", v_logits, vp_logits)
    fmap = vit.feature_map(vit.encode(vparams, vcfg, images), vcfg)  # the dense heads' input
    with plain_encoders():
        p_fmap = vit.feature_map(vit.encode(vparams, vcfg, images), vcfg)
    res["vit"]["feature_map_rel_rms_plain"] = rel_rms(fmap, p_fmap)
    if tuple(fmap.shape) != (8, vcfg.d_model, vcfg.grid, vcfg.grid) or not rel_rms(fmap, p_fmap) <= ENCODER_GATE_F32:
        raise AssertionError(f"vit: feature map of shape {tuple(fmap.shape)}, relative RMS against plain "
                             f"{rel_rms(fmap, p_fmap):.3g}")
    for name, n in res["vit"]["launches_per_forward"].items():
        f32_launches[name] = f32_launches.get(name, 0) + n
    del vparams
    torch.cuda.empty_cache()

    mcfg = mobilenet.MOBILENET_V2
    mparams = mobilenet.quantize_params_int8(mobilenet.init_params(0, mcfg, device=dev), device=dev)
    k24 = [b["expand_w"]["qt"].shape for b in mparams["blocks"] if "expand_w" in b and b["expand_w"]["qt"].shape[1] == 24]
    if len(k24) != 2:
        raise AssertionError(f"mobilenet: {len(k24)} int8 expand convolutions of K 24, not 2")
    m_logits, mp_logits = encoder_run(torch, "mobilenet", lambda: mobilenet.forward(mparams, mcfg, images),
                                      lambda r: r.reshape(-1), 8, "images", res, launches)
    res["mobilenet"]["top1"] = top1_check("mobilenet top-1", m_logits, mp_logits)
    res["mobilenet"]["k24_expands"] = [list(s) for s in k24]
    for name, n in res["mobilenet"]["launches_per_forward"].items():
        f32_launches[name] = f32_launches.get(name, 0) + n
    del mparams
    torch.cuda.empty_cache()

    rcfg = resnet.RESNET50
    rparams = resnet.init_params(0, rcfg, device=dev)
    r_logits, rp_logits = encoder_run(torch, "resnet50", lambda: resnet.forward(rparams, rcfg, images),
                                      lambda r: r.reshape(-1), 8, "images", res, launches)
    res["resnet50"]["top1"] = top1_check("resnet50 top-1", r_logits, rp_logits)
    r64 = to_f64(torch, rparams)
    c64 = dataclasses.replace(rcfg, dtype=torch.float64)
    res["resnet50"]["f64"] = f64_check(
        torch, "resnet50 features", lambda: resnet.forward(rparams, rcfg, images, features=True),
        lambda: resnet.forward(r64, c64, images.double(), features=True))
    res["resnet50"]["f64_logits"] = f64_check(
        torch, "resnet50 logits", lambda: resnet.forward(rparams, rcfg, images),
        lambda: resnet.forward(r64, c64, images.double()))
    del rparams, r64
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    out["encoders"] = res
    log(f"  ({res['seconds']:.1f} s)")
    return launches, f32_launches

# ---------------------------------------------------------------------------
# Phase 13: the graph runtime — a GPT-2-small graph through GraphBackend
# ---------------------------------------------------------------------------

# The graph's QuantMatMul calls at GPT-2-small's widths, f32 activations: the
# GEMV at one row (each decode step) and the f32 route at the 64-token
# prompt: (name, N, K).
GRAPH_PROJ = (("c_attn", 2304, 768), ("c_fc", 3072, 768), ("mlp c_proj", 768, 3072), ("lm_head", 50257, 768))
GRAPH_PROMPT, GRAPH_STEPS, GRAPH_GATE_STEPS, GRAPH_FORWARD = 64, 200, 16, 512
GRAPH_GATE = 1e-4  # relative RMS: f32 logits, the sums' order alone
GRAPH_TOP2 = 1e-3  # a token may differ only where the reference's top-2 gap is below this


def graph_prompt_launches(torch, cfg, m: int = GRAPH_PROMPT) -> dict:
    """The launch counts of a GPT-2 graph's prompt of ``m`` rows through
    QuantMatMul's f32 route: one quant_matmul_int8 a projection (4 a layer
    and the lm_head), and ``quant_matmul_int8:split_k`` for each whose
    ``f32_plan`` splits K on this card."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    d, ff = cfg.d_model, cfg.d_ff
    x = {k: torch.empty(m, k, device="cuda") for k in (d, ff)}
    layer = ((3 * d, d), (d, d), (ff, d), (d, ff))  # c_attn, attn c_proj, c_fc, mlp c_proj: (N, K)
    splits = cfg.n_layers * sum(qm.f32_device_plan(x[k], n)[1] > 1 for n, k in layer)
    splits += qm.f32_device_plan(x[d], cfg.vocab_size)[1] > 1
    out = {"quant_matmul_int8": 4 * cfg.n_layers + 1}
    if splits:
        out["quant_matmul_int8:split_k"] = int(splits)
    return out


def graph_op_counts(cfg) -> dict:
    """The fused ops the optimizer leaves in a GPT-2 graph of ``cfg``: four
    projections a layer and the lm_head, two LayerNorms a layer and the
    final one, one GELU a layer (49, 25, 12 at GPT-2-small)."""
    return {"QuantMatMul": 4 * cfg.n_layers + 1, "LayerNormalization": 2 * cfg.n_layers + 1, "Gelu": cfg.n_layers}


def check_graph_kernels(torch, bound, randn, pack, record):
    """QuantMatMul's kernel calls at the GPT-2 graph's widths with f32
    activations (``optimize.quantize.quant_matmul_op``: x [M, K] f32 against
    the [N, K] int8 pack): the GEMV at M 1 and quant_matmul_int8's f32
    route at M 64 (its three passes bounded at the bf16 tensor-core rate,
    f32_route_extra), each against its plain version, timed as phase 3
    times the others; the yardstick is F.linear in IEEE f32 on the
    dequantized weights."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    f32 = torch.float32
    F = torch.nn.functional
    for m in (1, GRAPH_PROMPT):
        for name, n, k in GRAPH_PROJ:
            def make(i, m=m, n=n, k=k):
                qt, s = pack(n, k)
                return randn(m, k, dtype=f32), qt, s

            args = make(0)
            out = qm.quant_matmul_int8(*args)
            ref = (qm.quant_gemv_int8_ref if m <= qm.MAX_ROWS else qm.quant_matmul_int8_ref)(*args)
            torch.cuda.synchronize()
            err, tol = (out - ref).abs().max().item(), 1e-4 * max(1.0, ref.abs().max().item())
            x, qt, s = args
            per_call = nbytes(x, qt, s) + m * n * 4
            copies = [make(i) for i in range(copies_for(per_call, cap=64))]
            ms = graph_ms(torch, [lambda a=a: qm.quant_matmul_int8(*a) for a in copies])
            plain = eager_ms(torch, lambda: (qm.quant_gemv_int8_ref if m <= qm.MAX_ROWS
                                             else qm.quant_matmul_int8_ref)(*args))
            lib_w = [c[1].float() * c[2][:, None] for c in copies[:copies_for(4 * n * k, cap=64)]]
            library = graph_ms(torch, [lambda w=w: F.linear(x, w) for w in lib_w])
            kernel = "quant_gemv_int8" if m <= qm.MAX_ROWS else "quant_matmul_int8"
            extra = (dict(route="f32") if m <= qm.MAX_ROWS
                     else f32_route_extra(torch, bound, x, qt, s, None, out, per_call))
            record(kernel, f"graph {name} M={m} N={n} K={k}", err, tol, ms, plain,
                   bound(per_call, (1 if m <= qm.MAX_ROWS else 3) * 2 * m * n * k), library,
                   host_us=host_us(torch, lambda: qm.quant_matmul_int8(*args)), **extra)
            del copies, lib_w
            torch.cuda.empty_cache()


def teacher_forced(torch, backend, prompt, tokens, n, times=None):
    """The f32 logits [n, vocab] of ``backend`` fed ``prompt`` then
    ``tokens[:n - 1]`` one at a time; each decode step's host ms (to its
    logits on the host) appended to ``times``."""
    import numpy as np

    rows = [backend.prefill(prompt[None]).cpu()]
    for t in tokens[: n - 1]:
        t0 = time.perf_counter()
        rows.append(backend.decode(np.asarray([[t]], np.int32)).cpu())
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    return torch.cat([r.float() for r in rows])


def top2_gap(logits) -> float:
    top = logits.double().topk(2).values
    return (top[0] - top[1]).item()


def drive_graph(torch, out) -> dict:
    """Phase 13: the GPT-2-small graph (``models.gpt2_graph``, seed 0, full
    width) quantized by ``quantize_graph_int8`` and run by ``Model`` on the
    card through ``GraphBackend`` in compiled mode: a 64-token prompt and
    200 greedy steps twice (the first run captures one CUDA graph a bucket:
    the prompt's 64 and the decode buckets 128, 256 and 512), the second
    timed with every launch counter read around it; device ms a step by
    kernel (profiler) and the idle share; the gates (the legacy interpret
    path's logits against the compiled path's, the kernels against their
    plain versions, each over 16 teacher-forced steps); one 512-token
    ``Model.run`` forward compiled against interpret. Returns the timed
    run's launches."""
    import collections

    import numpy as np

    from rten_tpu_torch.generate import Generator, GeneratorConfig, GraphBackend
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.kernels import quant_matmul as qm
    from rten_tpu_torch.models.gpt2_graph import GPT2_SMALL, build_gpt2_graph
    from rten_tpu_torch.optimize import quantize
    from rten_tpu_torch.runtime.session import Model, RunOptions

    t_phase = time.perf_counter()
    res = {}
    graph, n_quantized = quantize.quantize_graph_int8(build_gpt2_graph(Graph, GPT2_SMALL, seed=0))
    model = Model(graph, device="cuda")
    kinds = collections.Counter(op.op_type for _, op in model.graph.operator_nodes())
    res["ops"] = dict(kinds)
    expect_ops = graph_op_counts(GPT2_SMALL)
    n_proj = expect_ops["QuantMatMul"]
    counts = {k: kinds[k] for k in expect_ops}
    log(f"  graph: {sum(kinds.values())} ops after the optimizer, {n_quantized} matrices quantized; {counts} "
        f"({time.perf_counter() - t_phase:.1f} s to build, quantize and optimize)")
    if counts != expect_ops:
        raise AssertionError(f"optimized GPT-2 graph holds {counts}, expected {expect_ops}")
    backend = GraphBackend(model)
    if backend.mode != "compiled":
        raise AssertionError(f"GraphBackend picked {backend.mode!r} for the GPT-2 graph, expected 'compiled'")
    prompt = np.random.default_rng(0).integers(0, GPT2_SMALL.vocab_size, GRAPH_PROMPT).astype(np.int32)

    def generate():
        backend.reset()
        steps = iter(Generator(backend, GeneratorConfig(max_tokens=GRAPH_STEPS + 1)).with_prompt(prompt))
        tokens, times = [], []
        while True:
            t0 = time.perf_counter()
            try:
                tok = next(steps)
            except StopIteration:
                return tokens, times
            times.append((time.perf_counter() - t0) * 1e3)
            tokens.append(int(tok[0]))

    t0 = time.perf_counter()
    first, first_times = generate()
    res["first_run_s"] = time.perf_counter() - t0
    dispatch.reset_counters()
    tokens, times = generate()
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    expect = {**graph_prompt_launches(torch, GPT2_SMALL), "quant_gemv_int8": n_proj * GRAPH_STEPS}
    if launches != expect or plain:
        raise AssertionError(f"GraphBackend run launched {launches} (expected {expect}), plain versions {plain}")
    if tokens != first:
        raise AssertionError("the captured replays' tokens differ from the capturing run's")
    entries = len(model._compiled)
    if entries != 4:
        raise AssertionError(f"{entries} captured entries, expected 4 (prompt bucket 64, decode 128, 256, 512)")
    step_ms = statistics.median(times[1:])
    res.update(first_run_ms_per_step=statistics.median(first_times[1:]), ttft_ms=times[0], host_ms_step=step_ms,
               tokens_per_s=1e3 / step_ms, launches=launches, entries=entries, tokens=tokens)
    tok = np.asarray([[tokens[-1]]], np.int32)
    by_kernel, calls = profile_by_kernel(torch, lambda: backend.decode(tok, greedy=True), 20)
    device_ms = sum(by_kernel.values()) / 1e3
    dispatch.reset_counters()
    backend.decode(tok, greedy=True)
    step_launches = dict(dispatch.LAUNCHES)
    res.update(device_ms_step=device_ms, idle_share=max(0.0, 1 - device_ms / step_ms), step_launches=step_launches,
               device_us_by_kernel=by_kernel, device_calls_a_step=calls)
    log(f"  compiled: time to first token {times[0]:.2f} ms (first run, capturing: {first_times[0]:.1f} ms); "
        f"host {step_ms:.4f} ms a step (median of {GRAPH_STEPS}; {1e3 / step_ms:.1f} tokens/s); device "
        f"{device_ms:.4f} ms a step (profiler, 20 steps at bucket 512); idle share {res['idle_share']:.3f}; "
        f"launches a decode step {step_launches}, the prompt's {expect['quant_matmul_int8']} quant_matmul_int8; "
        f"captured entries {entries}; first run {res['first_run_s']:.1f} s")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {us:9.3f} us  x{calls.get(name, 0):.0f}  {name[:90]}")

    # The gates: 16 teacher-forced steps on the compiled stream's tokens.
    n = GRAPH_GATE_STEPS
    backend.reset()
    compiled = teacher_forced(torch, backend, prompt, tokens, n)
    interp_times = []
    legacy = teacher_forced(torch, GraphBackend(model, mode="interpret"), prompt, tokens, n, interp_times)
    rel = rel_rms(legacy, compiled)
    diffs = [i for i in range(n) if int(legacy[i].argmax()) != tokens[i]]
    bad = [i for i in diffs if top2_gap(legacy[i]) >= GRAPH_TOP2]
    res["interpret_host_ms_step"] = statistics.median(interp_times)
    log(f"  gate compiled / interpret: relative RMS {rel:.3g} (gate {GRAPH_GATE}); token differences {diffs}; "
        f"interpret (legacy, exact shapes) {res['interpret_host_ms_step']:.3f} host ms a step (median of {n - 1})")
    if not rel <= GRAPH_GATE or bad:
        raise AssertionError(f"compiled against interpret: relative RMS {rel:.3g}, differences past the top-2 "
                             f"rule at steps {bad}")
    saved = quantize.quant_matmul_int8
    quantize.quant_matmul_int8 = qm.quant_matmul_int8_ref
    try:
        dispatch.reset_counters()
        plain_logits = teacher_forced(torch, GraphBackend(model, mode="interpret"), prompt, tokens, n)
        plain_counts, kernel_counts = dict(dispatch.PLAIN), dict(dispatch.LAUNCHES)
    finally:
        quantize.quant_matmul_int8 = saved
    rel_plain = rel_rms(legacy, plain_logits)
    log(f"  gate kernels / plain versions: relative RMS {rel_plain:.3g} (gate {GRAPH_GATE}); plain calls "
        f"{plain_counts}, kernel launches {kernel_counts}")
    if not rel_plain <= GRAPH_GATE or kernel_counts or plain_counts != {"quant_matmul_int8": n_proj * n}:
        raise AssertionError(f"kernels against plain versions: relative RMS {rel_plain:.3g}, plain {plain_counts}, "
                             f"kernels {kernel_counts}")
    res.update(gate_interpret=rel, gate_plain=rel_plain, token_differences=diffs)

    # One 512-token forward, compiled (captured, replayed) against interpret.
    gen = np.random.default_rng(1)
    t = GRAPH_FORWARD
    feed = {"input_ids": gen.integers(0, GPT2_SMALL.vocab_size, (1, t)).astype(np.int32),
            "attention_mask": np.ones((1, t), np.int32), "position_ids": np.arange(t, dtype=np.int32)[None]}
    for name in backend.cache_inputs:
        feed[name] = backend._empty_cache_value(name, 1)

    def forward(mode):
        out_ = model.run(feed, ["logits"], RunOptions(mode=mode))[0]
        torch.cuda.synchronize()
        return out_

    compiled_out = forward("compile")  # the capture
    dispatch.reset_counters()
    forward("compile")
    fwd_launches = dict(dispatch.LAUNCHES)
    fwd_compiled = statistics.median(host_ms(lambda: forward("compile")) for _ in range(7))
    interp_out = forward("interpret")
    fwd_interpret = statistics.median(host_ms(lambda: forward("interpret")) for _ in range(3))
    rel_fwd = rel_rms(compiled_out, interp_out)
    log(f"  Model.run forward of {t} tokens: compiled {fwd_compiled:.3f} ms, interpret {fwd_interpret:.3f} ms "
        f"(host, median); relative RMS {rel_fwd:.3g}; launches {fwd_launches}")
    if not rel_fwd <= GRAPH_GATE or fwd_launches != graph_prompt_launches(torch, GPT2_SMALL, t):
        raise AssertionError(f"the {t}-token forward: relative RMS {rel_fwd:.3g}, launches {fwd_launches}")
    res.update(forward_tokens=t, forward_compiled_ms=fwd_compiled, forward_interpret_ms=fwd_interpret,
               forward_rel_rms=rel_fwd, forward_launches=fwd_launches)
    del model, backend, graph
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    out["graph"] = res
    log(f"  ({res['seconds']:.1f} s)")
    return launches


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def graph_only(torch, bound, detail, kind, smi, label: str) -> int:
    """``--graph LABEL``: QuantMatMul's kernel calls at the graph's widths
    (check_graph_kernels) and phase 13 (drive_graph), written to
    chiprun_out/graph_LABEL.json; its last line is marked partial."""
    randn, pack, _norm_vecs, _bf16_err, record, cases = check_tools(torch)
    log("[3/4] QuantMatMul's kernel calls at the GPT-2 graph's widths against their plain versions")
    check_graph_kernels(torch, bound, randn, pack, record)
    detail["cases"] = cases
    log("[4/4] the GPT-2-small graph through GraphBackend")
    launches = drive_graph(torch, detail)
    (OUT_DIR / f"graph_{label}.json").write_text(json.dumps(detail, indent=1))
    print(smi)
    print(json.dumps({"partial": "graph", "kind": kind, "label": label, "launches": launches,
                      "seconds": detail["graph"]["seconds"]}))
    return 0


# ---------------------------------------------------------------------------
# Phase 14: model files — .rten save / load, ONNX convert, the CLI, lifting
# ---------------------------------------------------------------------------

FILE_KV_LENS = (GRAPH_PROMPT, GRAPH_PROMPT + GRAPH_STEPS - 1, 1023)  # the lifted path's cache lengths, and S's end
WHISPER_FILE_STEPS = 32


def check_file_kernels(torch, bound, randn, record):
    """The kernel modes the lifted dense GPT-2-small takes (phase 14 (b)),
    f32 at its attention shapes (12 heads of 64): causal flash_attention of
    the 64-token prompt (q a view of the [B, T, H, D] projection, k and v
    views of the first 64 positions of a 1024-position cache, as
    ``decoder._attention`` passes them) and, in the lifted Whisper's f32,
    one decoder token's cross attention over the 1500 audio positions (6
    heads; split over KV), and decode_attention without its wo over a
    1024-position f32 cache at the path's lengths, each against its plain
    version, timed as check_kernels times the others; the yardstick is
    F.scaled_dot_product_attention (causal, or over the valid prefix).
    flash's f32 operations are bounded as six bf16 passes (f32_flash_extra:
    the CUDA-core bound, the split, the f64 check), decode_attention's at
    the f32 CUDA-core rate."""
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import decode_attention as da

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    F = torch.nn.functional
    h, hd, s_max, t = 12, 64, 1024, GRAPH_PROMPT

    def make_flash(i):
        q = randn(t, h * hd, scale=1.5, dtype=f32).view(1, t, h, hd).transpose(1, 2)
        caches = [randn(1, h, s_max, hd, scale=s, dtype=f32) for s in (1.5, 1.0)]
        zero, n = torch.zeros(1, dtype=torch.int32, device=dev), torch.full((1,), t, dtype=torch.int32, device=dev)
        return (q, caches[0][:, :, :t], caches[1][:, :, :t]), dict(causal=True, q_offset=zero, kv_len=n)

    args, kw = make_flash(0)
    out, ref = at.flash_attention(*args, **kw), at.flash_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err, tol = (out - ref).abs().max().item(), 1e-4 * ref.abs().max().item()
    per_call = 4 * nbytes(args[0])
    ops = 4 * hd * h * t * (t + 1) // 2
    copies = [make_flash(i) for i in range(copies_for(per_call, cap=32))]
    ms = graph_ms(torch, [lambda a=a, kw=kw: at.flash_attention(*a, **kw) for a, kw in copies])
    plain = eager_ms(torch, lambda: at.flash_attention_ref(*args, **kw))
    lib = [(a[0].contiguous(), a[1].contiguous(), a[2].contiguous()) for a, _ in copies]
    library = graph_ms(torch, [lambda a=a: F.scaled_dot_product_attention(*a, is_causal=True) for a in lib])
    record("flash_attention", f"f32 lift causal Tq={t} S={t} of {s_max} H={h} D={hd}", err, tol, ms, plain,
           bound(per_call, 6 * ops), library, host_us=host_us(torch, lambda: at.flash_attention(*args, **kw)),
           **f32_flash_extra(torch, bound, args, kw, out, per_call, ops))
    del copies, lib

    wh, s_audio = WHISPER["n_heads"], WHISPER_AUDIO

    def make_cross(i):
        def heads(n, scale):  # [1, H, n, D] views of [n, H·D] projections, as encoder_decoder passes them
            return randn(n, wh * hd, scale=scale, dtype=f32).view(1, n, wh, hd).transpose(1, 2)

        return (heads(1, 1.5), heads(s_audio, 1.5), heads(s_audio, 1.0)), dict(causal=False)

    args, kw = make_cross(0)
    out, ref = at.flash_attention(*args, **kw), at.flash_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err, tol = (out - ref).abs().max().item(), 1e-4 * ref.abs().max().item()
    per_call = nbytes(*args) + nbytes(out)
    ops = 4 * hd * wh * s_audio
    copies = [make_cross(i) for i in range(copies_for(per_call, cap=32))]
    ms = graph_ms(torch, [lambda a=a, kw=kw: at.flash_attention(*a, **kw) for a, kw in copies])
    plain = eager_ms(torch, lambda: at.flash_attention_ref(*args, **kw))
    library = graph_ms(torch, [lambda a=a: F.scaled_dot_product_attention(*a) for a, _ in copies])
    record("flash_attention", f"f32 whisper cross Tq=1 S={s_audio} H={wh} D={hd}", err, tol, ms, plain,
           bound(per_call, 6 * ops), library, host_us=host_us(torch, lambda: at.flash_attention(*args, **kw)),
           **f32_flash_extra(torch, bound, args, kw, out, per_call, ops))
    del copies

    for kv_len in FILE_KV_LENS:
        def make(i, kv_len=kv_len):
            ops_ = (randn(1, h, hd, scale=1.5, dtype=f32), randn(1, h, hd, scale=1.5, dtype=f32),
                    randn(1, h, hd, dtype=f32))
            return [ops_, randn(1, h, s_max, hd, scale=1.5, dtype=f32), randn(1, h, s_max, hd, dtype=f32),
                    torch.full((1,), kv_len, dtype=torch.int32, device=dev)]

        args = make(0)
        k_args, p_args = [a if i == 0 else a.clone() for i, a in enumerate(args)], [
            a if i == 0 else a.clone() for i, a in enumerate(args)]
        out, ref = da.decode_attention(*k_args), da.decode_attention_ref(*p_args)
        torch.cuda.synchronize()
        if not (torch.equal(k_args[1], p_args[1]) and torch.equal(k_args[2], p_args[2])):
            raise AssertionError(f"decode_attention f32 kv_len={kv_len}: the caches after the append differ")
        err, tol = (out - ref).abs().max().item(), 1e-4 * ref.abs().max().item()
        per_call = 2 * h * kv_len * hd * 4 + 3 * h * hd * 4 + h * hd * 4 + 2 * h * hd * 4 + 4
        ops = 4 * h * (kv_len + 1) * hd
        copies = [make(i) for i in range(copies_for(per_call, cap=64))]
        ms = graph_ms(torch, [lambda a=a: da.decode_attention(*a) for a in copies])
        plain = eager_ms(torch, lambda: da.decode_attention_ref(*p_args))  # the append is idempotent
        lib = [(c[0][0][:, :, None], c[1][:, :, : kv_len + 1], c[2][:, :, : kv_len + 1]) for c in copies[:8]]
        library = graph_ms(torch, [lambda a=a: F.scaled_dot_product_attention(*a) for a in lib])
        record("decode_attention:no_wo", f"f32 lift kv_len={kv_len} S={s_max} H={h} D={hd}", err, tol, ms, plain,
               bound(per_call, ops, f32=True), library, route="f32",
               **kv_launch_info(torch, lambda: da.decode_attention(*k_args), "rt_decode_attention",
                                k_args[0][0], h, s_max))
        del copies, lib


def whisper_tiny_state(seed: int = 0) -> dict:
    """A Whisper-tiny-named HF state (``model.encoder.*`` / ``model.decoder.*``,
    nn.Linear weights [out, in], ``WHISPER_TINY``'s widths: 4 + 4 layers of
    6 heads, d 384, FF 1536, vocab 51865, 80 mel bins, 1500 audio and 448
    text positions) with random weights from ``seed``: normal 0.02
    matrices and embeddings, biases 0.02, LayerNorm scales near 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, ff, vocab, mels = WHISPER["d_model"], WHISPER["d_ff"], WHISPER["vocab_size"], 80

    def w(*shape, std=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    st = {"model.encoder.conv1.weight": w(d, mels, 3), "model.encoder.conv1.bias": w(d),
          "model.encoder.conv2.weight": w(d, d, 3), "model.encoder.conv2.bias": w(d),
          "model.decoder.embed_tokens.weight": w(vocab, d), "model.decoder.embed_positions.weight": w(WHISPER_TEXT, d)}
    for side in ("encoder", "decoder"):
        st[f"model.{side}.layer_norm.weight"], st[f"model.{side}.layer_norm.bias"] = 1 + w(d, std=0.1), w(d)
        for i in range(4):
            p = f"model.{side}.layers.{i}."
            for attn in ("self_attn",) + (("encoder_attn",) if side == "decoder" else ()):
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    st[f"{p}{attn}.{proj}.weight"] = w(d, d)
                    if proj != "k_proj":
                        st[f"{p}{attn}.{proj}.bias"] = w(d)
                st[f"{p}{attn}_layer_norm.weight"], st[f"{p}{attn}_layer_norm.bias"] = 1 + w(d, std=0.1), w(d)
            st[p + "fc1.weight"], st[p + "fc1.bias"] = w(ff, d), w(ff)
            st[p + "fc2.weight"], st[p + "fc2.bias"] = w(d, ff), w(d)
            st[p + "final_layer_norm.weight"], st[p + "final_layer_norm.bias"] = 1 + w(d, std=0.1), w(d)
    return st


def mlp_onnx(seed: int = 0) -> bytes:
    """A two-layer MLP at GPT-2's MLP widths (768 → 3072, Gelu, → 768;
    MatMul and Add with biases, weights normal 0.02 from ``seed``) as ONNX
    bytes from the port's onnx_builder."""
    import numpy as np

    from rten_tpu_torch.format import onnx_builder as ob

    rng = np.random.default_rng(seed)
    d, ff = 768, 3072

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    nodes = [ob.make_node("MatMul", ["x", "w1"], ["h"]), ob.make_node("Add", ["h", "b1"], ["h1"]),
             ob.make_node("Gelu", ["h1"], ["g"]), ob.make_node("MatMul", ["g", "w2"], ["y0"]),
             ob.make_node("Add", ["y0", "b2"], ["y"])]
    inits = [ob.make_tensor("w1", w(d, ff)), ob.make_tensor("b1", w(ff)), ob.make_tensor("w2", w(ff, d)),
             ob.make_tensor("b2", w(d))]
    return ob.make_model(ob.make_graph(nodes, inputs=[ob.make_value_info("x", ["batch", d])],
                                       outputs=[ob.make_value_info("y", ["batch", d])], initializers=inits))


def stream_check(what, got, want, want_logits_at):
    """``got`` equals ``want`` token for token, or first differs where the
    reference's top-2 gap (``want_logits_at(i)``, its logits at step i) is
    below GRAPH_TOP2. Returns the first difference or None."""
    at = first_difference(got, want)
    if at is not None:
        gap = top2_gap(want_logits_at(at))
        log(f"    {what}: first differs at token {at} (reference top-2 gap {gap:.4g})")
        if not gap < GRAPH_TOP2:
            raise AssertionError(f"{what}: differs at token {at}, where the reference's top-2 gap is {gap:.4g} "
                                 f">= {GRAPH_TOP2}")
    return at


def drive_files(torch, out) -> dict:
    """Phase 14: the model-file paths at full width, each file written to
    and read from a temporary directory.

    (a) GPT-2-small as phase 13's graph (``models.gpt2_graph``, seed 0)
    through ``quantize_graph_int8``, its dead f32 constants swept, saved by
    ``format.save_rten`` and loaded by ``Model.load_file`` and
    ``Model.load_mmap``: GraphBackend compiled on the file's model (a
    64-token prompt, 200 greedy steps twice, the second timed: 49
    quant_matmul_int8 for the prompt and 49 quant_gemv_int8 a step, no
    plain call), its tokens phase 13's in-memory run's, 16 teacher-forced
    steps of logits from each loader bit-equal to the in-memory Model's.
    (b) The same graph in f32 with the tied head (``tied=True``), saved,
    loaded, lifted by ``backend_for_model(model, n_heads=12)`` onto a
    ``NativeBackend`` (the dense-weight route): the same prompt and 200
    greedy steps in a 1024-position cache (12 f32 causal flash_attention at
    the prompt, 12 decode_attention without wo a step, nothing else of the
    kernels, no plain call); its tokens against GraphBackend's on the same
    loaded file (top-2 rule, gap GRAPH_TOP2), 16 teacher-forced steps of
    logits within GRAPH_GATE of the graph's and of its own plain versions';
    time to first token, host and device ms a step, the idle share; then
    ``generate_scan`` captured for 200 steps, equal to the eager stream.
    (c) A two-layer MLP at GPT-2's MLP widths as ONNX through ``python -m
    rten_tpu_torch.convert --quantize``, loaded on the card: QuantMatMul
    through quant_matmul_int8 at 64 rows and quant_gemv_int8 at 1, within
    1e-4 of the plain versions (the same file on the CPU).
    (d) ``python -m rten_tpu_torch.cli`` on (a)'s file, ``-n 3`` and
    ``--mode interpret -t --mmap``, each exiting 0 (run beside (c)).
    (e) A Whisper-tiny-named state as a graph of constants:
    ``backend_for_model`` gives an EncDecBackendFactory; EncDecBackend
    (dense f32) on a seeded 30-second mel, the 4 start tokens and 32 greedy
    steps; the encoder states and the teacher-forced logits through the
    kernels against the plain versions (relative RMS at most GRAPH_GATE),
    the tokens under the top-2 rule. Returns the phase's launches."""
    import collections
    import tempfile

    import numpy as np

    from rten_tpu_torch.format import save_rten
    from rten_tpu_torch.generate import (EncDecBackend, EncDecBackendFactory, Generator, GeneratorConfig,
                                         GraphBackend, NativeBackend, backend_for_model)
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.models import encoder_decoder as ed
    from rten_tpu_torch.models.gpt2_graph import GPT2_SMALL, build_gpt2_graph
    from rten_tpu_torch.optimize import passes, quantize
    from rten_tpu_torch.runtime.session import Model

    t_phase = time.perf_counter()
    res, total = {}, collections.Counter()
    prompt = np.random.default_rng(0).integers(0, GPT2_SMALL.vocab_size, GRAPH_PROMPT).astype(np.int32)
    n_proj = graph_op_counts(GPT2_SMALL)["QuantMatMul"]
    n_layers = GPT2_SMALL.n_layers
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)

    def stream(backend, n=GRAPH_STEPS):
        """Greedy tokens of ``backend`` after the prompt, and each token's host ms."""
        backend.reset()
        steps = iter(Generator(backend, GeneratorConfig(max_tokens=n + 1)).with_prompt(prompt))
        tokens, times = [], []
        while True:
            t0 = time.perf_counter()
            try:
                tok = next(steps)
            except StopIteration:
                return tokens, times
            times.append((time.perf_counter() - t0) * 1e3)
            tokens.append(int(tok[0]))

    def timed(fn):
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    def forced(backend, tokens, n):
        """``teacher_forced`` from an empty cache."""
        backend.reset()
        return teacher_forced(torch, backend, prompt, tokens, n)

    # (a) The quantized graph through a file.
    graph, _ = quantize.quantize_graph_int8(build_gpt2_graph(Graph, GPT2_SMALL, seed=0))
    graph = passes.sweep_dead_constants(graph)
    data, save_s = timed(lambda: save_rten(graph, {"description": "GPT-2-small, seed 0, int8"}))
    path_a = tmp / "gpt2_int8.rten"
    path_a.write_bytes(data)
    memory = Model(graph, device="cuda")
    file_model, load_s = timed(lambda: Model.load_file(path_a, device="cuda"))
    mmap_model, mmap_s = timed(lambda: Model.load_mmap(path_a, device="cuda"))
    backend = GraphBackend(file_model)
    first, _ = stream(backend)
    dispatch.reset_counters()
    tokens_a, times = stream(backend)
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    total.update(launches)
    expect = {**graph_prompt_launches(torch, GPT2_SMALL), "quant_gemv_int8": n_proj * GRAPH_STEPS}
    if launches != expect or plain:
        raise AssertionError(f"(a) GraphBackend on the file launched {launches} (expected {expect}), plain {plain}")
    ref_tokens = out.get("graph", {}).get("tokens")
    if ref_tokens is None:  # phase 13 did not run (--files): the in-memory model's own stream
        ref_tokens, _ = stream(GraphBackend(memory))
    if tokens_a != first or tokens_a != ref_tokens:
        raise AssertionError("(a) the file's tokens differ from the in-memory graph's (or between its runs)")
    n = GRAPH_GATE_STEPS
    want = forced(GraphBackend(memory), tokens_a, n)
    for what, model in (("load_file", file_model), ("load_mmap", mmap_model)):
        got = forced(GraphBackend(model), tokens_a, n)
        if not torch.equal(got, want):
            raise AssertionError(f"(a) {what}: teacher-forced logits differ from the in-memory Model's "
                                 f"(max {(got - want).abs().max().item():.3g})")
    step_ms = statistics.median(times[1:])
    res["a"] = dict(file_bytes=len(data), save_s=save_s, load_file_s=load_s, load_mmap_s=mmap_s,
                    ttft_ms=times[0], host_ms_step=step_ms, launches=launches)
    log(f"  (a) int8 file {len(data) / 1e6:.1f} MB: save {save_s:.2f} s, load_file {load_s:.2f} s, load_mmap "
        f"{mmap_s:.2f} s (with the optimizer); GraphBackend compiled: time to first token {times[0]:.2f} ms, host "
        f"{step_ms:.4f} ms a step; tokens = phase 13's; 16 teacher-forced steps bit-equal (file, mmap); {launches}")
    del memory, file_model, mmap_model, backend, graph, data
    torch.cuda.empty_cache()

    # (b) The dense f32 file lifted onto NativeBackend.
    path_b = tmp / "gpt2_f32.rten"
    data, save_s = timed(lambda: save_rten(build_gpt2_graph(Graph, GPT2_SMALL, seed=0, tied=True)))
    path_b.write_bytes(data)
    model_b, load_s = timed(lambda: Model.load_file(path_b, device="cuda"))
    native, lift_s = timed(lambda: backend_for_model(model_b, n_heads=GPT2_SMALL.n_heads, device="cuda"))
    if not isinstance(native, NativeBackend) or "lm_head" in native.params or native.cfg.max_seq != 1024:
        raise AssertionError(f"(b) backend_for_model gave {type(native).__name__} (cfg {getattr(native, 'cfg', None)})")
    graph_b = GraphBackend(model_b)
    g_tokens, _ = stream(graph_b)  # captures the buckets
    g_tokens, g_times = stream(graph_b)
    stream(native)  # builds and plans the kernels at these shapes
    dispatch.reset_counters()
    tokens_b, times = stream(native)
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    total.update(launches)
    expect = {"flash_attention": n_layers, "decode_attention:no_wo": n_layers * GRAPH_STEPS}
    hd = GPT2_SMALL.d_model // GPT2_SMALL.n_heads
    splits = f32_flash_splits(torch, [(1, GPT2_SMALL.n_heads, GPT2_SMALL.n_heads, GRAPH_PROMPT, native.max_len, hd)]
                              * n_layers)  # the prompt's split plan sizes for the cache's S (decoder._attention)
    if splits:
        expect["flash_attention:split_kv"] = splits
    if launches != expect or plain:
        raise AssertionError(f"(b) the lifted NativeBackend launched {launches} (expected {expect}), plain {plain}")
    n = GRAPH_GATE_STEPS
    g_logits, n_logits = forced(graph_b, tokens_b, n), forced(native, tokens_b, n)
    with plain_decoder(decoder):
        p_logits = forced(native, tokens_b, n)
    at = stream_check("(b) lifted / GraphBackend", tokens_b, g_tokens, lambda i: forced(graph_b, g_tokens, i + 1)[i])
    rel_graph, rel_plain = rel_rms(n_logits, g_logits), rel_rms(n_logits, p_logits)
    if not (rel_graph <= GRAPH_GATE and rel_plain <= GRAPH_GATE):
        raise AssertionError(f"(b) lifted logits: relative RMS {rel_graph:.3g} from the graph's, {rel_plain:.3g} "
                             f"from the plain versions' (gate {GRAPH_GATE})")
    step_ms = statistics.median(times[1:])
    tok = np.asarray([[tokens_b[-1]]], np.int32)
    by_kernel, calls = profile_by_kernel(torch, lambda: native.decode(tok, greedy=True), 20)
    device_ms = sum(by_kernel.values()) / 1e3
    # generate_scan captured on the lifted params: the eager stream's tokens.
    params, cfg = native.params, native.cfg
    cache = decoder.init_cache(cfg, 1, 1024, device="cuda")
    ids = torch.from_numpy(prompt[None]).cuda()

    def scan():
        """The prompt, then generate_scan's steps, into ``cache`` from empty."""
        cache["len"].zero_()
        cache["host_len"][:] = 0
        first_tok, _ = decoder.prefill(params, cfg, ids, cache, lm_head_mode="argmax", last_only=True)
        dispatch.reset_counters()
        steps, _ = decoder.generate_scan(params, cfg, cache, first_tok, n_steps=GRAPH_STEPS)
        return [int(first_tok[0, 0])] + steps[0].tolist()

    scan_tokens, capture_s = timed(scan)
    scan_launches = dict(dispatch.LAUNCHES)
    total.update(scan_launches)
    replay_tokens, replay_s = timed(scan)  # the same cache: the captured graph replayed
    total.update(dispatch.LAUNCHES)
    if scan_tokens != tokens_b or replay_tokens != tokens_b or scan_launches != {
            "decode_attention:no_wo": n_layers * GRAPH_STEPS}:
        raise AssertionError(f"(b) generate_scan: capture / replay equal the eager stream: {scan_tokens == tokens_b}"
                             f" / {replay_tokens == tokens_b}; launches {scan_launches}")
    res["b"] = dict(file_bytes=len(data), save_s=save_s, load_file_s=load_s, lift_s=lift_s, ttft_ms=times[0],
                    host_ms_step=step_ms, device_ms_step=device_ms, idle_share=max(0.0, 1 - device_ms / step_ms),
                    graph_host_ms_step=statistics.median(g_times[1:]), graph_ttft_ms=g_times[0],
                    rel_rms_graph=rel_graph, rel_rms_plain=rel_plain, first_difference=at, launches=launches,
                    device_us_by_kernel=by_kernel, device_calls_a_step=calls, scan_capture_s=capture_s,
                    scan_host_ms_step=replay_s * 1e3 / GRAPH_STEPS)
    log(f"  (b) f32 file {len(data) / 1e6:.1f} MB: save {save_s:.2f} s, load_file {load_s:.2f} s, lift "
        f"{lift_s:.2f} s; NativeBackend (dense f32): time to first token {times[0]:.2f} ms, host {step_ms:.4f} ms a "
        f"step, device {device_ms:.4f} ms (profiler, 20 steps), idle share {res['b']['idle_share']:.3f}; "
        f"GraphBackend on the same file {res['b']['graph_host_ms_step']:.4f} ms a step; relative RMS "
        f"{rel_graph:.3g} from the graph, {rel_plain:.3g} from the plain versions; first token difference {at}; "
        f"generate_scan captured {GRAPH_STEPS} steps ({capture_s:.2f} s with the capture, replay "
        f"{res['b']['scan_host_ms_step']:.4f} ms a step) = eager; {launches}")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us:9.3f} us  x{calls.get(name, 0):.0f}  {name[:90]}")
    del native, graph_b, model_b, params, cache, data
    torch.cuda.empty_cache()

    # (c) ONNX → convert --quantize, and (d) the CLI, as subprocesses side by side.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    onnx_path, rten_path = tmp / "mlp.onnx", tmp / "mlp.rten"
    onnx_path.write_bytes(mlp_onnx(0))
    commands = {"convert": ["-m", "rten_tpu_torch.convert", str(onnx_path), str(rten_path), "--quantize"],
                "cli": ["-m", "rten_tpu_torch.cli", str(path_a), "-n", "3"],
                "cli interpret": ["-m", "rten_tpu_torch.cli", str(path_a), "--mode", "interpret", "-t", "--mmap"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, *c], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for k, c in commands.items()}
    outputs = {}
    for k, proc in procs.items():
        try:
            outputs[k] = proc.communicate(timeout=300)[0]
        finally:
            proc.kill()
        res[k] = dict(rc=proc.returncode, tail=outputs[k][-600:])
    cli_s = time.perf_counter() - t0
    bad = {k: res[k]["rc"] for k in procs if res[k]["rc"] != 0}
    if bad:
        raise AssertionError(f"(c)/(d) subprocesses failed: {bad}; {[res[k]['tail'] for k in bad]}")
    mlp = Model.load_file(rten_path, device="cuda")
    mlp_cpu = Model.load_file(rten_path, device="cpu")
    ops = collections.Counter(op.op_type for _, op in mlp.graph.operator_nodes())
    if ops["QuantMatMul"] != 2:
        raise AssertionError(f"(c) the converted MLP holds {dict(ops)}, expected 2 QuantMatMul")
    errs = {}
    for m, kernel in ((GRAPH_PROMPT, "quant_matmul_int8"), (1, "quant_gemv_int8")):
        x = np.random.default_rng(m).standard_normal((m, 768)).astype(np.float32)
        mlp.run([x])  # the capture
        dispatch.reset_counters()
        got = mlp.run([x])[0]
        launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
        total.update(launches)
        want = mlp_cpu.run([x])[0]
        errs[m] = (got.cpu() - want).abs().max().item() / want.abs().max().item()
        if {k: v for k, v in launches.items() if ":" not in k} != {kernel: 2} or plain or not errs[m] <= 1e-4:
            raise AssertionError(f"(c) M={m}: launches {launches} (expected {kernel} twice), plain {plain}, "
                                 f"relative error {errs[m]:.3g} from the plain versions")
    res["c"] = dict(ops=dict(ops), rel_err=errs, file_bytes=rten_path.stat().st_size)
    log(f"  (c) convert --quantize: {rten_path.stat().st_size / 1e6:.2f} MB, {dict(ops)}; against the plain versions "
        f"{errs[GRAPH_PROMPT]:.3g} at M {GRAPH_PROMPT} (quant_matmul_int8), {errs[1]:.3g} at M 1 (quant_gemv_int8)")
    log(f"  (d) cli -n 3 and --mode interpret -t --mmap exit 0 ({cli_s:.1f} s with (c)'s convert): "
        f"{outputs['cli'].strip().splitlines()[-1]}")
    del mlp, mlp_cpu

    # (e) Whisper-tiny lifted from a graph of constants.
    wg = Graph()
    for name, arr in whisper_tiny_state(0).items():
        wg.add_constant(name, arr)
    make = backend_for_model(wg, n_heads=WHISPER["n_heads"], device="cuda")
    if not isinstance(make, EncDecBackendFactory):
        raise AssertionError(f"(e) backend_for_model gave {type(make).__name__}")
    mel = torch.randn(1, 80, 2 * WHISPER_AUDIO, generator=torch.Generator().manual_seed(11))
    dispatch.reset_counters()
    backend = make(mel)
    steps = iter(Generator(backend, GeneratorConfig(max_tokens=WHISPER_FILE_STEPS + 1)).with_prompt(
        list(WHISPER_PROMPT)))
    tokens_e = [int(t[0]) for t in steps]
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    total.update(launches)
    n_text = make.cfg.n_text_layers
    expect = {"flash_attention": make.cfg.n_audio_layers + 2 * n_text + n_text * WHISPER_FILE_STEPS,
              "decode_attention:no_wo": n_text * WHISPER_FILE_STEPS}
    # The encoder over the audio positions; the prompt's self attention over
    # its own tokens and its cross attention; a token's cross attention.
    wh, n_p, hd = WHISPER["n_heads"], len(WHISPER_PROMPT), WHISPER["d_model"] // WHISPER["n_heads"]
    splits = f32_flash_splits(torch, [(1, wh, wh, WHISPER_AUDIO, WHISPER_AUDIO, hd)] * make.cfg.n_audio_layers
                              + [(1, wh, wh, n_p, make.cfg.max_text_ctx, hd), (1, wh, wh, n_p, WHISPER_AUDIO, hd)]
                              * n_text
                              + [(1, wh, wh, 1, WHISPER_AUDIO, hd)] * n_text * WHISPER_FILE_STEPS)
    if splits:
        expect["flash_attention:split_kv"] = splits
    if launches != expect or plain:
        raise AssertionError(f"(e) EncDecBackend (dense f32) launched {launches} (expected {expect}), plain {plain}")
    forced = list(WHISPER_PROMPT) + tokens_e[:-1]

    def whisper_logits():
        be = EncDecBackend(make.params, make.cfg, mel, device="cuda")
        rows = [be.prefill(np.asarray([list(WHISPER_PROMPT)], np.int32)).cpu()]
        rows += [be.decode(np.asarray([[t]], np.int32)).cpu() for t in forced[len(WHISPER_PROMPT):]]
        return be.enc_states.float().cpu(), torch.cat(rows)

    enc_k, logits_k = whisper_logits()
    with plain_encdec(ed):
        enc_p, logits_p = whisper_logits()
    rel_enc, rel_logits = rel_rms(enc_k, enc_p), rel_rms(logits_k, logits_p)
    at = stream_check("(e) whisper kernels / plain", [int(r.argmax()) for r in logits_k],
                      [int(r.argmax()) for r in logits_p], lambda i: logits_p[i])
    if not (rel_enc <= GRAPH_GATE and rel_logits <= GRAPH_GATE) or tokens_e != [int(r.argmax()) for r in logits_k]:
        raise AssertionError(f"(e) relative RMS encoder {rel_enc:.3g}, logits {rel_logits:.3g} (gate {GRAPH_GATE}); "
                             "or the stream is not the argmax of its own logits")
    res["e"] = dict(launches=launches, rel_rms_encoder=rel_enc, rel_rms_logits=rel_logits, first_difference=at,
                    tokens=tokens_e)
    log(f"  (e) Whisper-tiny lifted (dense f32): EncDecBackendFactory; {WHISPER_FILE_STEPS} greedy steps; "
        f"against the plain versions: encoder {rel_enc:.3g}, logits {rel_logits:.3g} (gate {GRAPH_GATE}); {launches}")
    del make, backend, wg
    tmp_dir.cleanup()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    out["files"] = res
    log(f"  ({res['seconds']:.1f} s)")
    return dict(total)


def files_only(torch, bound, detail, kind, smi, label: str) -> int:
    """``--files LABEL``: the lifted path's kernel modes (check_file_kernels)
    and phase 14 (drive_files), written to chiprun_out/files_LABEL.json; its
    last line is marked partial."""
    randn, pack, _norm_vecs, _bf16_err, record, cases = check_tools(torch)
    log("[3/4] the lifted path's kernel modes (f32) against their plain versions")
    check_file_kernels(torch, bound, randn, record)
    one_launch_a_call(cases)
    detail["cases"] = cases
    log("[4/4] model files: .rten, ONNX convert, the CLI, lifting")
    launches = drive_files(torch, detail)
    (OUT_DIR / f"files_{label}.json").write_text(json.dumps(detail, indent=1))
    print(smi)
    print(json.dumps({"partial": "files", "kind": kind, "label": label, "launches": launches,
                      "seconds": detail["files"]["seconds"]}))
    return 0


# ---------------------------------------------------------------------------
# Phase 15: text in, text out (the host toolkit and the example apps)
# ---------------------------------------------------------------------------

TEXT_MERGES = 2000  # byte-level BPE merges learned from README.md
TEXT_WP_VOCAB = 30522  # the WordPiece vocabulary's size, BERT-base's
TEXT_NEW, TEXT_SHORT = 64, 16  # gpt2.py's new tokens; the short stream of the marginal step time
TEXT_GPT2 = dict(vocab=50257, n_layers=12, d=768, ff=3072, n_pos=1024)  # GPT-2-small
TEXT_BERT = dict(vocab=30522, n_layers=12, d=768, ff=3072, n_pos=512)  # BERT-base
TEXT_MASK, TEXT_CTC, TEXT_BEAM = (512, 512), (500, 32), 8  # (f): the contour mask, the CTC matrix, its beam
# The device kernels of each kernel wrapper on phase 15 (b)'s path, as the
# profiler names them (gemv_kernel<DOT, PH>: PH 1 a GEMV, 3 the MLP).
TRACE_NAMES = {"quant_gemv_int8": r"gemv_kernel<\d+, 1>", "quant_mlp_int8": r"gemv_kernel<\d+, 3>",
               "decode_attention": r"kv_attention_kernel", "quant_matmul_int8": r"qmm_(wgmma|f32)_kernel",
               "flash_attention": r"flash_mma_kernel"}


def readme_paragraphs(text: str) -> list[str]:
    """README's prose paragraphs (blocks between blank lines that are not a
    heading, list, table, quote or code, of 100 characters or more), each
    joined into one line."""
    paras = []
    for block in text.split("\n\n"):
        lines = [line.strip() for line in block.strip().splitlines()]
        if lines and not lines[0].startswith(("#", "-", "*", "|", ">", "`", "```")) and len(" ".join(lines)) >= 100:
            paras.append(" ".join(lines))
    return paras


def train_bpe(text: str, n_merges: int, pre_tokenizer=None) -> list[tuple[str, str]]:
    """Byte-level BPE merges learned from ``text`` by counting, as GPT-2's
    were: the GPT-2 pre-tokenization (the port's ``ByteLevel``, or
    ``pre_tokenizer``) splits it into words of units, and each of
    ``n_merges`` rounds merges the most frequent adjacent pair of units in
    every word (ties: the pair that sorts first)."""
    import collections
    import heapq

    from rten_tpu_torch.text.pretokenizer import ByteLevel

    pre = pre_tokenizer or ByteLevel(add_prefix_space=False)
    counts = collections.Counter(piece for piece, _ in pre.split(text))
    words, freq = [list(w) for w in counts], list(counts.values())
    pairs, where = collections.Counter(), collections.defaultdict(set)
    for i, w in enumerate(words):
        for pair in zip(w, w[1:]):
            pairs[pair] += freq[i]
            where[pair].add(i)
    heap = [(-n, pair) for pair, n in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while len(merges) < n_merges and heap:
        n, best = heapq.heappop(heap)
        if pairs.get(best, 0) != -n:
            continue  # a stale count
        merges.append(best)
        a, b = best
        touched = set()
        for i in sorted(where.pop(best)):
            w, out, j = words[i], [], 0
            while j < len(w):
                if j + 1 < len(w) and w[j] == a and w[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            for pair in zip(w, w[1:]):
                pairs[pair] -= freq[i]
                touched.add(pair)
            for pair in zip(out, out[1:]):
                pairs[pair] += freq[i]
                where[pair].add(i)
                touched.add(pair)
            words[i] = out
        for pair in touched:
            if pairs[pair] > 0:
                heapq.heappush(heap, (-pairs[pair], pair))
            else:
                del pairs[pair]
    return merges


def bpe_tokenizer_spec(merges) -> dict:
    """A GPT-2-style ``tokenizer.json`` (as a dict) over ``merges``: the 256
    byte units (id = the byte), one id a merge, then ``<|endoftext|>``;
    ByteLevel pre-tokenizer and decoder."""
    from rten_tpu_torch.text.models import bytes_to_unicode

    units = bytes_to_unicode()
    vocab = {units[b]: b for b in range(256)}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    eos = vocab.setdefault("<|endoftext|>", len(vocab))
    return {"normalizer": None, "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
            "decoder": {"type": "ByteLevel"},
            "model": {"type": "BPE", "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
            "added_tokens": [{"id": eos, "content": "<|endoftext|>", "special": True}]}


def wordpiece_tokenizer_spec(text: str, size: int = TEXT_WP_VOCAB) -> dict:
    """A BERT-style WordPiece ``tokenizer.json`` (as a dict) over ``text``'s
    lower-cased words (BertNormalizer, BertPreTokenizer): [PAD] [UNK] [CLS]
    [SEP] [MASK], the words seen twice or more, every character alone and as
    a ``##`` continuation, and the ``##`` suffixes of up to 4 characters of
    those words, padded with ``[unusedN]`` to ``size`` ids; the [CLS] $A
    [SEP] ($B [SEP]) template."""
    import collections

    from rten_tpu_torch.text.normalizer import BertNormalizer
    from rten_tpu_torch.text.pretokenizer import BertPreTokenizer

    counts = collections.Counter(w for w, _ in BertPreTokenizer().split(BertNormalizer(lowercase=True).normalize(text)))
    common = sorted(w for w, n in counts.items() if n >= 2)
    chars = sorted({c for w in counts for c in w})
    suffixes = sorted({w[k:] for w in common for k in range(max(1, len(w) - 4), len(w))})
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *common, *chars, *("##" + c for c in chars),
              *("##" + s for s in suffixes)]
    vocab = {}
    for t in tokens:
        vocab.setdefault(t, len(vocab))
    if len(vocab) > size:
        raise ValueError(f"{len(vocab)} WordPiece tokens do not fit in {size} ids")
    for i in range(size - len(vocab)):
        vocab[f"[unused{i}]"] = len(vocab)

    def special(t, type_id=0):
        return {"SpecialToken": {"id": t, "type_id": type_id}}

    def seq(s, type_id=0):
        return {"Sequence": {"id": s, "type_id": type_id}}

    return {"normalizer": {"type": "BertNormalizer", "lowercase": True},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "model": {"type": "WordPiece", "vocab": vocab, "unk_token": "[UNK]", "continuing_subword_prefix": "##"},
            "post_processor": {"type": "TemplateProcessing",
                               "single": [special("[CLS]"), seq("A"), special("[SEP]")],
                               "pair": [special("[CLS]"), seq("A"), special("[SEP]"), seq("B", 1),
                                        special("[SEP]", 1)]},
            "added_tokens": [{"id": vocab[t], "content": t, "special": True}
                             for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")]}


def _normal(rng, *shape, std=0.02):
    import numpy as np

    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def gpt2_hf_state(seed: int, vocab: int, n_layers: int, d: int, ff: int, n_pos: int) -> dict:
    """An HF ``GPT2Model``-named state (Conv1D weights ``[in, out]``) with
    random weights from ``seed``: normal 0.02 matrices, embeddings and
    biases, LayerNorm scales near 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    st = {"wte.weight": _normal(rng, vocab, d), "wpe.weight": _normal(rng, n_pos, d)}
    for i in range(n_layers):
        p = f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            st[f"{p}{ln}.weight"], st[f"{p}{ln}.bias"] = 1 + _normal(rng, d, std=0.1), _normal(rng, d)
        st[p + "attn.c_attn.weight"], st[p + "attn.c_attn.bias"] = _normal(rng, d, 3 * d), _normal(rng, 3 * d)
        st[p + "attn.c_proj.weight"], st[p + "attn.c_proj.bias"] = _normal(rng, d, d), _normal(rng, d)
        st[p + "mlp.c_fc.weight"], st[p + "mlp.c_fc.bias"] = _normal(rng, d, ff), _normal(rng, ff)
        st[p + "mlp.c_proj.weight"], st[p + "mlp.c_proj.bias"] = _normal(rng, ff, d), _normal(rng, d)
    st["ln_f.weight"], st["ln_f.bias"] = 1 + _normal(rng, d, std=0.1), _normal(rng, d)
    return st


def bert_qa_hf_state(seed: int, vocab: int, n_layers: int, d: int, ff: int, n_pos: int) -> dict:
    """An HF ``BertForQuestionAnswering``-named state (``bert.`` prefix,
    nn.Linear weights ``[out, in]``, the ``qa_outputs`` span head) with
    random weights from ``seed``: normal 0.02 matrices, embeddings and
    biases, LayerNorm scales near 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    st = {}

    def ln(p):
        st[p + "weight"], st[p + "bias"] = 1 + _normal(rng, d, std=0.1), _normal(rng, d)

    def linear(p, n_out, n_in):
        st[p + "weight"], st[p + "bias"] = _normal(rng, n_out, n_in), _normal(rng, n_out)

    st["bert.embeddings.word_embeddings.weight"] = _normal(rng, vocab, d)
    st["bert.embeddings.position_embeddings.weight"] = _normal(rng, n_pos, d)
    st["bert.embeddings.token_type_embeddings.weight"] = _normal(rng, 2, d)
    ln("bert.embeddings.LayerNorm.")
    for i in range(n_layers):
        p = f"bert.encoder.layer.{i}."
        for proj in ("query", "key", "value"):
            linear(f"{p}attention.self.{proj}.", d, d)
        linear(p + "attention.output.dense.", d, d)
        ln(p + "attention.output.LayerNorm.")
        linear(p + "intermediate.dense.", ff, d)
        linear(p + "output.dense.", d, ff)
        ln(p + "output.LayerNorm.")
    linear("qa_outputs.", 2, d)
    return st


def trace_kernel_names(path) -> set:
    """The wrappers of TRACE_NAMES whose device kernels a Chrome trace
    (``runtime.profiler.trace``'s ``trace.json``) names."""
    import re

    names = {e.get("name", "") for e in json.loads(Path(path).read_text()).get("traceEvents", [])}
    return {k for k, pat in TRACE_NAMES.items() if any(re.search(pat, n) for n in names)}


def drive_text(torch, out) -> tuple[dict, dict]:
    """Phase 15: text in, text out, through the port's host toolkit and its
    example apps, the models' files written to a temporary directory.

    (a) Tokenizers from README.md: 2000 byte-level BPE merges learned by
    ``train_bpe`` into a GPT-2-style tokenizer.json (``bpe_tokenizer_spec``)
    and a WordPiece one of 30522 ids (``wordpiece_tokenizer_spec``); README
    encoded in full by the BPE through the native library and through the
    Python path (the ids must be equal), and by the WordPiece; tokens a
    second of each on this host.
    (b) ``python -m rten_tpu_torch.examples.gpt2 --model gpt2.npz --int8
    --tokenizer tok.json --top-k 1 -n 64 --prompt <README's first
    paragraph>`` through ``main(argv)`` on an HF-named GPT-2-small state
    from seed 0: its prompt ids are (a)'s, its 64 tokens the greedy stream
    of phase 4's path (Generator over NativeBackend) on the params
    ``from_hf_gpt2`` and ``quantize_params_int8`` make of the same state,
    its text ``decode`` of them; quant_matmul_int8 and flash_attention at
    the prompt, quant_gemv_int8, decode_attention and quant_mlp_int8 each
    decode step, no plain call. Time to first token and host ms a step
    (the app's Metrics; ``utils.bench.marginal_step_time`` over streams of
    16 and 64 tokens), device ms a step (profiler), the tokenizer's share
    of the app's host time.
    (c) gpt2.py on phase 14 (b)'s file (GPT-2-small as an f32 graph, tied
    head, seed 0) with the same prompt: its tokens equal backend_for_model's
    NativeBackend greedy stream on the file (the dense-weight route: f32
    causal flash_attention at the prompt, decode_attention without wo).
    (d) ``python -m rten_tpu_torch.examples.bert_qa`` on an HF-named
    BERT-base QA state from seed 0 with (a)'s WordPiece tokenizer, a README
    sentence as the question and another as the context: flash_attention
    12 times (f32, not causal), no plain call; its span and answer equal
    the same run's through the plain versions, its start and end logits
    within GRAPH_GATE of theirs.
    (e) ``runtime.profiler.trace`` around (b)'s warm-up run: the
    ``trace.json`` names the device kernels of all five wrappers of (b).
    (f) The native contour tracer and CTC beam search against the Python
    paths on a seeded 512 x 512 mask and a 500 x 32 log-probability matrix:
    equal results.

    Returns the phase's launches and those of them on the f32 routes."""
    import collections
    import tempfile

    import numpy as np

    from rten_tpu_torch import ctc, native
    from rten_tpu_torch.examples import bert_qa as qa_app
    from rten_tpu_torch.examples import gpt2 as gpt2_app
    from rten_tpu_torch.format import save_rten
    from rten_tpu_torch.generate import (Generator, GeneratorConfig, NativeBackend, TopKSampler,
                                         backend_for_model)
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.image import contours
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.models.gpt2_graph import GPT2_SMALL, build_gpt2_graph
    from rten_tpu_torch.runtime import profiler
    from rten_tpu_torch.runtime.session import Model
    from rten_tpu_torch.text import Tokenizer
    from rten_tpu_torch.utils.bench import marginal_step_time

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("the native library is not available (phase 2 builds it)")
    res, total, f32 = {}, collections.Counter(), collections.Counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    text = (ROOT / "README.md").read_text(encoding="utf-8")
    paras = readme_paragraphs(text)
    prompt = paras[0]

    # (a) Tokenizers from README.md.
    t0 = time.perf_counter()
    merges = train_bpe(text, TEXT_MERGES)
    train_s = time.perf_counter() - t0
    specs = {"bpe": bpe_tokenizer_spec(merges), "wordpiece": wordpiece_tokenizer_spec(text)}
    paths = {k: tmp / f"{k}_tokenizer.json" for k in specs}
    for k, spec in specs.items():
        paths[k].write_text(json.dumps(spec), encoding="utf-8")
    n_ids = {k: len(spec["model"]["vocab"]) for k, spec in specs.items()}

    def encode_timed(spec, python: bool):
        tok = Tokenizer.from_json(spec)
        if python:
            tok.model._native, tok.model._native_tried = None, True  # the Python merge loop
        t = time.perf_counter()
        ids = tok.encode(text, add_special_tokens=False).ids
        return ids, time.perf_counter() - t

    ids_lib, lib_s = encode_timed(specs["bpe"], python=False)
    ids_py, py_s = encode_timed(specs["bpe"], python=True)
    ids_wp, wp_s = encode_timed(specs["wordpiece"], python=False)
    if ids_lib != ids_py:
        raise AssertionError(f"(a) README's BPE ids differ between the native library and the Python path at "
                             f"{first_difference(ids_lib, ids_py)}")
    if n_ids["bpe"] > TEXT_GPT2["vocab"] or max(ids_lib) >= n_ids["bpe"]:
        raise AssertionError(f"(a) the BPE has {n_ids['bpe']} ids")
    res["a"] = dict(merges=len(merges), train_s=train_s, ids=n_ids, readme_chars=len(text),
                    tokens=dict(bpe=len(ids_lib), wordpiece=len(ids_wp)),
                    tokens_per_s=dict(bpe_native=len(ids_lib) / lib_s, bpe_python=len(ids_py) / py_s,
                                      wordpiece=len(ids_wp) / wp_s))
    log(f"  (a) {len(merges)} BPE merges from README.md in {train_s:.2f} s ({n_ids['bpe']} ids; WordPiece "
        f"{n_ids['wordpiece']} ids); README ({len(text)} chars) encoded: BPE {len(ids_lib)} tokens, native = Python; "
        f"tokens/s on this host (a fresh tokenizer, one pass): BPE native {len(ids_lib) / lib_s:.0f}, BPE Python "
        f"{len(ids_py) / py_s:.0f}, WordPiece {len(ids_wp) / wp_s:.0f}")

    # (b) gpt2.py at GPT-2-small's width, int8 weights; (e) the trace of its warm-up run.
    g = TEXT_GPT2
    state = gpt2_hf_state(0, g["vocab"], g["n_layers"], g["d"], g["ff"], g["n_pos"])
    npz = tmp / "gpt2.npz"
    np.savez(npz, **state)
    argv = ["--model", str(npz), "--int8", "--tokenizer", str(paths["bpe"]), "--top-k", "1", "--prompt", prompt]
    trace_dir = OUT_DIR / "text_trace"
    with profiler.trace(str(trace_dir)):
        gpt2_app.main([*argv, "-n", "8"])
    traced = trace_kernel_names(trace_dir / "trace.json")
    trace_bytes = (trace_dir / "trace.json").stat().st_size
    (trace_dir / "trace.json").unlink()  # too large to keep
    if traced != set(TRACE_NAMES):
        raise AssertionError(f"(e) the trace names the kernels of {sorted(traced)}, not all of {sorted(TRACE_NAMES)}")
    dispatch.reset_counters()
    app = {}
    t0 = time.perf_counter()
    gpt2_app.main([*argv, "-n", str(TEXT_NEW)], result=app)
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    total.update(launches)
    steps, n_layers = TEXT_NEW - 1, g["n_layers"]
    need = {"quant_matmul_int8": 1, "flash_attention": n_layers, "quant_gemv_int8": steps,
            "decode_attention": n_layers * steps, "quant_mlp_int8": steps}
    if plain or any(launches.get(k, 0) < n for k, n in need.items()) or launches.get("flash_attention") != n_layers:
        raise AssertionError(f"(b) gpt2.py launched {launches} (at least {need}; flash_attention only at the "
                             f"prompt), plain {plain}")
    tok = Tokenizer.from_json(specs["bpe"])
    if app["prompt_ids"] != tok.encode(prompt).ids:
        raise AssertionError("(b) gpt2.py's prompt ids are not (a)'s")
    cfg = gpt2_app.infer_gpt2_config(state, decoder)
    params = decoder.quantize_params_int8(decoder.from_hf_gpt2(state, cfg, device="cuda"), device="cuda")
    del state
    backend = NativeBackend(params, cfg, device="cuda")
    ref = [int(t[0]) for t in Generator(backend, GeneratorConfig(max_tokens=TEXT_NEW)).with_prompt(app["prompt_ids"])]
    if app["tokens"] != ref or app["text"] != tok.decode(ref):
        raise AssertionError(f"(b) gpt2.py's tokens differ from phase 4's greedy stream at "
                             f"{first_difference(app['tokens'], ref)}, or its text from decode of them")

    def run_at(n):
        backend.reset()
        gen = Generator(backend, GeneratorConfig(max_tokens=n)).with_prompt(app["prompt_ids"])
        return [t for t in gen.with_sampler(TopKSampler(1, temperature=0.8))]

    host_ms = marginal_step_time(run_at, TEXT_SHORT, TEXT_NEW, trials=3) * 1e3
    last = np.asarray([[ref[-1]]], np.int32)
    by_kernel, calls = profile_by_kernel(torch, lambda: backend.decode(last), 16)
    device_ms = sum(by_kernel.values()) / 1e3
    t0 = time.perf_counter()
    tok2 = Tokenizer.from_json(paths["bpe"].read_text(encoding="utf-8"))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok2.encode(prompt)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok2.decode(app["tokens"])
    dec_s = time.perf_counter() - t0
    m = app["metrics"]
    gen_s = sum(m.step_times_s)
    phase4 = out.get("decode")
    in_vocab = sum(t < n_ids["bpe"] for t in ref)  # the rest decode to nothing: random weights, 50257 logits
    res["b"] = dict(prompt_tokens=len(app["prompt_ids"]), in_vocab=in_vocab, launches=launches,
                    ttft_ms=m.warmup_time_s * 1e3,
                    app_ms_step=m.mean_step_ms(), marginal_host_ms_step=host_ms, device_ms_step=device_ms,
                    idle_share=max(0.0, 1 - device_ms / host_ms), device_us_by_kernel=by_kernel,
                    device_calls_a_step=calls, app_s=app_s, tokenizer_load_ms=load_s * 1e3,
                    encode_ms=enc_s * 1e3, decode_ms=dec_s * 1e3,
                    tokenizer_share=(enc_s + dec_s) / gen_s, text=app["text"],
                    phase4_ms_step=phase4 and phase4["ms_per_step"],
                    phase4_ttft_ms=out.get("prefill", {}).get(str(N_PROMPT), {}).get("ttft_ms"))
    log(f"  (b) gpt2.py --int8 --top-k 1 -n {TEXT_NEW}: a {len(app['prompt_ids'])}-token README prompt -> "
        f"{app['text'][:60]!r} ({in_vocab} of the {TEXT_NEW} tokens among the tokenizer's {n_ids['bpe']} ids); "
        f"tokens = phase 4's greedy stream; time to first token {m.warmup_time_s * 1e3:.3f} "
        f"ms, host {m.mean_step_ms():.4f} ms a step (the app's Metrics), {host_ms:.4f} ms (marginal, streams of "
        f"{TEXT_SHORT} and {TEXT_NEW}), device {device_ms:.4f} ms a step (profiler, 16 steps) -> idle share "
        f"{res['b']['idle_share']:.4f}; phase 4: {res['b']['phase4_ms_step']} ms a step, time to first token "
        f"{res['b']['phase4_ttft_ms']} ms (64-token prompt); tokenizer: from_json {load_s * 1e3:.2f} ms, encode "
        f"{enc_s * 1e3:.3f} ms, decode {dec_s * 1e3:.3f} ms = {res['b']['tokenizer_share']:.5f} of the "
        f"{gen_s * 1e3:.1f} ms of generation; {launches}")
    log(f"  (e) profiler.trace around the warm-up run: trace.json ({trace_bytes / 1e6:.1f} MB) names "
        f"{sorted(traced)}")
    res["e"] = dict(trace_bytes=trace_bytes, kernels=sorted(traced))
    del params, backend
    torch.cuda.empty_cache()

    # (c) gpt2.py on phase 14 (b)'s f32 file.
    path_c = tmp / "gpt2_f32.rten"
    path_c.write_bytes(save_rten(build_gpt2_graph(Graph, GPT2_SMALL, seed=0, tied=True)))
    lifted = backend_for_model(Model.load_file(path_c, device="cuda"), n_heads=GPT2_SMALL.n_heads, device="cuda")
    ref_c = [int(t[0]) for t in Generator(lifted, GeneratorConfig(max_tokens=TEXT_NEW)).with_prompt(app["prompt_ids"])]
    del lifted
    dispatch.reset_counters()
    app_c = {}
    gpt2_app.main(["--model", str(path_c), "--heads", str(GPT2_SMALL.n_heads), "--tokenizer", str(paths["bpe"]),
                   "--top-k", "1", "-n", str(TEXT_NEW), "--prompt", prompt], result=app_c)
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    total.update(launches)
    f32.update(launches)
    expect = {"flash_attention": GPT2_SMALL.n_layers, "decode_attention:no_wo": GPT2_SMALL.n_layers * steps}
    n_p, hd = len(app["prompt_ids"]), GPT2_SMALL.d_model // GPT2_SMALL.n_heads
    splits = f32_flash_splits(torch, [(1, GPT2_SMALL.n_heads, GPT2_SMALL.n_heads, n_p, GPT2_SMALL.n_positions, hd)]
                              * GPT2_SMALL.n_layers)  # the prompt's plan sizes for the cache's S
    if splits:
        expect["flash_attention:split_kv"] = splits
    if launches != expect or plain:
        raise AssertionError(f"(c) gpt2.py on the f32 file launched {launches} (expected {expect}), plain {plain}")
    if app_c["tokens"] != ref_c:
        raise AssertionError(f"(c) gpt2.py's tokens on the f32 file differ from the lifted NativeBackend's greedy "
                             f"stream at {first_difference(app_c['tokens'], ref_c)}")
    res["c"] = dict(launches=launches, ttft_ms=app_c["metrics"].warmup_time_s * 1e3,
                    app_ms_step=app_c["metrics"].mean_step_ms(), text=app_c["text"])
    log(f"  (c) gpt2.py --model gpt2_f32.rten (lifted, dense f32): tokens = the lifted NativeBackend's greedy "
        f"stream; time to first token {res['c']['ttft_ms']:.3f} ms, host {res['c']['app_ms_step']:.4f} ms a step; "
        f"{launches}")
    torch.cuda.empty_cache()

    # (d) bert_qa.py at BERT-base's width, f32.
    b = TEXT_BERT
    npz_qa = tmp / "bert_qa.npz"
    np.savez(npz_qa, **bert_qa_hf_state(0, b["vocab"], b["n_layers"], b["d"], b["ff"], b["n_pos"]))
    question, context = paras[1].split(". ")[0], paras[0].split(". ")[0]
    argv_qa = ["--model", str(npz_qa), "--tokenizer", str(paths["wordpiece"]), "--question", question,
               "--context", context]
    qa_app.main(argv_qa)  # warm-up
    dispatch.reset_counters()
    kern = {}
    t0 = time.perf_counter()
    qa_app.main(argv_qa, result=kern)
    torch.cuda.synchronize()
    qa_s = time.perf_counter() - t0
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    total.update(launches)
    f32.update(launches)
    t_qa, heads = len(kern["ids"]), b["d"] // 64
    splits = f32_flash_splits(torch, [(1, heads, heads, t_qa, t_qa, 64)] * b["n_layers"])
    expect = {"flash_attention": b["n_layers"], **({"flash_attention:split_kv": splits} if splits else {})}
    if launches != expect or plain:
        raise AssertionError(f"(d) bert_qa.py launched {launches} (expected {expect}), plain {plain}")
    ref_qa = {}
    with plain_encoders():
        qa_app.main(argv_qa, result=ref_qa)
    rel = {k: rel_rms(torch.from_numpy(kern[k]), torch.from_numpy(ref_qa[k])) for k in ("start", "end")}
    if kern["span"] != ref_qa["span"] or kern["answer"] != ref_qa["answer"] or not max(rel.values()) <= GRAPH_GATE:
        raise AssertionError(f"(d) bert_qa.py kernels / plain: span {kern['span']} / {ref_qa['span']}, answer "
                             f"{kern['answer']!r} / {ref_qa['answer']!r}, relative RMS {rel} (gate {GRAPH_GATE})")
    res["d"] = dict(tokens=len(kern["ids"]), span=kern["span"], answer=kern["answer"], rel_rms=rel, launches=launches,
                    app_s=qa_s)
    log(f"  (d) bert_qa.py (BERT-base, f32): {len(kern['ids'])} tokens, span {kern['span']} {kern['answer']!r} = the "
        f"plain versions'; start / end logits relative RMS {rel['start']:.3g} / {rel['end']:.3g} (gate "
        f"{GRAPH_GATE}); {qa_s * 1e3:.1f} ms a run (host clock, with the file's load); {launches}")

    # (f) The native contour tracer and CTC beam search against the Python paths.
    rng = np.random.default_rng(15)
    mask = rng.random(TEXT_MASK) > 0.6
    logits = rng.standard_normal(TEXT_CTC) * 3.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    t0 = time.perf_counter()
    lib_contours = contours.find_contours(mask)
    lib_beam = ctc.CtcDecoder().decode_beam(lp, TEXT_BEAM)
    lib_s = time.perf_counter() - t0
    saved = native.bindings.load_library
    native.bindings.load_library = lambda auto_build=True: None  # the Python paths
    try:
        t0 = time.perf_counter()
        py_contours = contours.find_contours(mask)
        py_beam = ctc.CtcDecoder().decode_beam(lp, TEXT_BEAM)
        py_s = time.perf_counter() - t0
    finally:
        native.bindings.load_library = saved
    same = len(lib_contours) == len(py_contours) and all(
        np.array_equal(a.as_array(), b.as_array()) for a, b in zip(lib_contours, py_contours))
    if not same or lib_beam.steps != py_beam.steps or not abs(lib_beam.log_prob - py_beam.log_prob) < 1e-6:
        raise AssertionError(f"(f) native / Python: contours equal {same}, CTC labels "
                             f"{lib_beam.labels == py_beam.labels}, log-probs {lib_beam.log_prob} / {py_beam.log_prob}")
    res["f"] = dict(contours=len(lib_contours), ctc_labels=len(lib_beam.labels), native_s=lib_s, python_s=py_s)
    log(f"  (f) native = Python: {len(lib_contours)} contours of a {TEXT_MASK[0]}x{TEXT_MASK[1]} mask, "
        f"{len(lib_beam.labels)} CTC labels of {TEXT_CTC[0]}x{TEXT_CTC[1]} (beam {TEXT_BEAM}); {lib_s:.3f} s native, "
        f"{py_s:.3f} s Python (host)")
    tmp_dir.cleanup()
    res["seconds"] = time.perf_counter() - t_phase
    out["text"] = res
    log(f"  ({res['seconds']:.1f} s)")
    return dict(total), dict(f32)


def text_only(torch, detail, kind, smi, label: str) -> int:
    """``--text LABEL``: phase 15 (drive_text) alone after phases 1-2,
    written to chiprun_out/text_LABEL.json; its last line is marked
    partial."""
    log("[3/3] text in, text out: tokenizers, gpt2.py, bert_qa.py, the trace, the native library")
    launches, _f32 = drive_text(torch, detail)
    (OUT_DIR / f"text_{label}.json").write_text(json.dumps(detail, indent=1, default=str))
    print(smi)
    print(json.dumps({"partial": "text", "kind": kind, "label": label, "launches": launches,
                      "seconds": detail["text"]["seconds"]}))
    return 0


# ---------------------------------------------------------------------------
# Phase 16: parallel/ — tensor, sequence and pipeline parallelism over 2 ranks
# ---------------------------------------------------------------------------

# Two ranks (parallel.launch.run_ranks): NCCL where the host has a card a
# rank, else gloo with both ranks on card 0, every collective staged through
# host memory (parallel.mesh). The Qwen2-0.5B shape over a model axis of 2:
# 7 query heads over 1 kv head a rank, q 448 / k and v 64 / gate and up 2432
# columns, wo K 448, down K 2432, the lm_head's 152576 (padded) columns
# split into 76288.
# (a) runs 64 greedy steps on the bf16 cache and 32 on the int8 one (the
# same path but for its KV kernel), cut from 256 to keep the script inside
# its time limit: over gloo a step takes 0.14-0.30 s on the card's hosts.
PAR_RANKS, PAR_FORCED, PAR_SP_TOKENS, PAR_TIMEOUT = 2, 32, 1024, 600
PAR_STEPS = {"bf16": 64, "int8": 32}
PAR_NEW_RANGE = (20, 32)  # (b) and (f): new tokens a request (phase 9's 16-64, cut for time; (f) fails at step 20)
PAR_PP = dict(stages=2, batch=4, tokens=128, microbatches=2)
PAR_TICK_FAIL, PAR_SNAPSHOT = 20, 8  # (f): rank 1 fails at step 20, snapshots every 8 steps
PAR_OVERLAP = dict(m=64, k=3072, n=768)  # GPT-2's MLP widths, K over the 2 ranks
PAR_RING = dict(h=12, d=64, t=1024)
PAR_GATE, PAR_OVERLAP_GATE, PAR_RING_GATE = 0.05, 1e-6, 1e-5
TP_LOCAL = dict(hq=7, hk=1, q=448, kv=64, ff=2432, vocab=76288)  # one rank's share of the Qwen2 shape


def check_tp_kernels(torch, bound):
    """The kernels of phase 16's path at the per-rank shapes no earlier case
    launches, against their plain versions, timed as phase 3 times them:
    the GEMV at 1 and 8 rows (q and k with their bias, gate, the f32 wo and
    down partials, the f32 lm_head slice), quant_matmul_int8 at the 64-token
    prompt (the same per-rank projections) and at sp_prefill's 512 rows a
    rank (the whole weights), flash_attention at the prompt's 7 query heads
    over 1 kv head and at pp_forward's microbatch (2 x 128 tokens, 14 / 2
    heads), and the KV kernels' modes at 7 / 1 heads. Returns the cases
    (shapes labelled "tp", "sp" or "pp")."""
    from rten_tpu_torch.models import decoder

    randn, pack, norm_vecs, bf16_err, record, cases = check_tools(torch)
    cfg = decoder.DecoderConfig(dtype=torch.bfloat16)  # head dim 64; the shape lists below name every width
    bf16, f32 = torch.bfloat16, torch.float32
    d, t = QWEN2["d_model"], TP_LOCAL
    check_gemv_kernels(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record, mlp=False, shapes=[
        ("tp q+bias", d, t["q"], None, "bias", None), ("tp k+bias", d, t["kv"], None, "bias", None),
        ("tp gate", d, t["ff"], None, "", None), ("tp wo partial f32", t["q"], d, None, "logits", None),
        ("tp down partial f32", t["ff"], d, None, "logits", None),
        ("tp lm_head f32", d, t["vocab"], None, "logits", None)])
    torch.cuda.empty_cache()
    ff, vocab = QWEN2_CFG["d_ff"], 2 * t["vocab"]
    shapes = [("tp q M=64", 64, t["q"], d, None, True, bf16), ("tp k M=64", 64, t["kv"], d, None, True, bf16),
              ("tp gate M=64", 64, t["ff"], d, None, False, bf16),
              ("tp wo partial M=64", 64, d, t["q"], None, False, f32),
              ("tp down partial M=64", 64, d, t["ff"], None, False, f32),
              ("sp q M=512", 512, d, d, None, True, bf16), ("sp k M=512", 512, 128, d, None, True, bf16),
              ("sp gate M=512", 512, ff, d, None, False, bf16), ("sp down M=512", 512, d, ff, None, False, bf16),
              ("sp lm_head M=512", 512, vocab, d, None, False, f32)]
    fa = [("tp Tq=64 kv_len=64", 1, t["hq"], t["hk"], 64, QWEN2_CACHE, True, 0, 64),
          ("pp B=2 Tq=128", 2, QWEN2["n_heads"], QWEN2["n_kv_heads"], 128, 128, True, 0, 128)]
    check_prefill_kernels(torch, bound, cfg, randn, pack, bf16_err, record, shapes=shapes, fa_cases=fa)
    torch.cuda.empty_cache()
    check_gqa_kernels(torch, bound, randn, pack, record, heads=(t["hq"], t["hk"]), tag="tp ",
                      kinds=("decode_attention:no_wo", "decode_attention_int8:gqa", "paged_decode_attention:gqa",
                             "paged_decode_attention_int8:gqa"),
                      lens_cases={k: KV_LENS[k] for k in ("B=1 kv_len=300", "B=8 mixed")})
    torch.cuda.empty_cache()
    return cases


def qwen2_par_params(torch, cfg, dev, dense: bool = False, seed: int = 0) -> dict:
    """The Qwen2-0.5B shape's params made on the card from one seed, the
    same on every rank: unfused int8 packs (random codes and per-column
    scales, as phase 3's ``pack``; the lm_head, a tied head's copy, padded
    to 152576 columns as ``quantize_params_int8`` pads it) with f32 vectors,
    or (``dense``) bf16 matrices of std 0.02; q/k/v biases, RMSNorm scales
    near 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    vec_dtype = bf16 if dense else f32

    def vec(n, scale=0.02, base=0.0):
        return (base + scale * torch.randn(n, generator=gen, device=dev)).to(vec_dtype)

    def mat(k, n, pad_n=0):
        if dense:
            return (0.02 * torch.randn(k, n, generator=gen, device=dev)).to(bf16)
        qt = torch.randint(-127, 128, (n + pad_n, k), generator=gen, device=dev, dtype=torch.int8)
        qt[n:] = 0
        s = torch.rand(n + pad_n, generator=gen, device=dev) * (0.04 / 127) + 0.01 / 127
        return {"qt": qt, "s": s, "tiled": False}

    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    q, kv = cfg.n_heads * hd, cfg.kv_heads * hd
    params = {"tok_emb": (0.02 * torch.randn(cfg.vocab_size, d, generator=gen, device=dev)).to(bf16),
              "final_norm": {"scale": vec(d, 0.05, 1.0)}, "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": {"scale": vec(d, 0.05, 1.0)}, "ln2": {"scale": vec(d, 0.05, 1.0)},
            "wq": mat(d, q), "wk": mat(d, kv), "wv": mat(d, kv), "bq": vec(q), "bk": vec(kv), "bv": vec(kv),
            "wo": mat(q, d), "w_gate": mat(d, ff), "w_up": mat(d, ff), "w_down": mat(ff, d)})
    if dense:
        params["lm_head"] = params["tok_emb"].t().contiguous()
    else:
        params["lm_head"] = mat(d, cfg.vocab_size, -cfg.vocab_size % 1024)
    return params


def logits_gate(torch, what: str, got, ref) -> dict:
    """The phase's accuracy gate on f32 logits [rows, vocab]: relative RMS
    at most PAR_GATE, and each row's argmax the reference's or, where not,
    the reference's top-2 gap below GAP_TOL."""
    got, ref = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    rel = (torch.sqrt(((got - ref) ** 2).mean()) / torch.sqrt((ref ** 2).mean())).item()
    top2 = torch.topk(ref, 2, dim=-1).values
    differ = got.argmax(-1) != ref.argmax(-1)
    worst = float((top2[:, 0] - top2[:, 1])[differ].max()) if bool(differ.any()) else 0.0
    if not (rel <= PAR_GATE and worst < GAP_TOL and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{what}: relative RMS {rel:.4g} (gate {PAR_GATE}); argmax differs at "
                             f"{int(differ.sum())} rows, largest reference top-2 gap there {worst:.4g} (< {GAP_TOL})")
    return dict(rel_rms=rel, argmax_differ=int(differ.sum()), rows=int(got.shape[0]), worst_gap=worst)


def par_tp(torch, mesh, cfg, full, local, kv: str) -> dict:
    """(a): the 64-token prompt through tp_prefill, then PAR_STEPS[kv] - 1
    greedy tp_decode_steps in a 1024-position cache (kv "bf16" or "int8"):
    host ms a step, device ms a step by kernel (profiler), launches a step;
    then PAR_FORCED teacher-forced steps' logits, and on rank 0 the same
    through the one-rank port path on the whole tree against them."""
    import collections
    import dataclasses

    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.parallel import init_cache
    from rten_tpu_torch.parallel.tp import tp_decode_step, tp_prefill

    dev = mesh.device
    c = dataclasses.replace(cfg, int8_kv=kv == "int8")
    gen = torch.Generator().manual_seed(16)
    prompt = torch.randint(0, cfg.vocab_size, (1, N_PROMPT), generator=gen, dtype=torch.int32).to(dev)
    cache = init_cache(c, 1, QWEN2_CACHE, mesh)
    torch.cuda.synchronize()
    dispatch.reset_counters()
    mesh.routes.clear()
    t0 = time.perf_counter()
    tok, cache = tp_prefill(local, c, prompt, cache, mesh=mesh, lm_head_mode="argmax", last_only=True)
    stream = [int(tok.view(-1)[0])]
    ttft = (time.perf_counter() - t0) * 1e3
    launches = collections.Counter(dispatch.LAUNCHES)
    dispatch.reset_counters()
    mesh.seconds.clear()
    tok = tok.view(1, 1)
    toks = [tok]
    t1 = time.perf_counter()
    steps = PAR_STEPS[kv] - 1
    for _ in range(steps):
        tok, cache = tp_decode_step(local, c, tok.view(1, 1), cache, mesh=mesh, lm_head_mode="argmax")
        toks.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    host_ms = wall * 1e3 / steps
    collective_share = sum(mesh.seconds.values()) / wall  # staging copies and gloo waits inside the collectives
    per_step = {k: v / steps for k, v in dispatch.LAUNCHES.items()}
    plain = dict(dispatch.PLAIN)
    launches.update(dispatch.LAUNCHES)
    stream = [int(t.view(-1)[0]) for t in toks]
    attn = "decode_attention_int8:gqa" if kv == "int8" else "decode_attention:no_wo"
    gemvs = cfg.n_layers * 7 + 1  # q, k, v, wo, gate, up, down a layer, the lm_head
    if plain or per_step.get(attn) != cfg.n_layers or per_step.get("quant_gemv_int8") != gemvs:
        raise AssertionError(f"(a) {kv}: a decode step must launch {attn} {cfg.n_layers} times and the GEMV "
                             f"{gemvs} times, no plain version: {per_step} plain {plain}")
    routes = dict(mesh.routes)

    def one_step():
        nonlocal tok, cache
        tok, cache = tp_decode_step(local, c, tok.view(1, 1), cache, mesh=mesh, lm_head_mode="argmax")

    by_kernel, _calls = profile_by_kernel(torch, one_step, 8)
    device_ms = sum(by_kernel.values()) / 1e3
    copies_ms = sum(v for k, v in by_kernel.items() if "Memcpy" in k or "memcpy" in k) / 1e3

    # Teacher-forced: the prompt, then the stream's first PAR_FORCED - 1 tokens.
    forced = torch.tensor(stream[: PAR_FORCED - 1], dtype=torch.int32, device=dev).view(-1, 1, 1)
    cache = init_cache(c, 1, QWEN2_CACHE, mesh)
    rows = [tp_prefill(local, c, prompt, cache, mesh=mesh, last_only=True)[0][:, -1]]
    for t in forced:
        rows.append(tp_decode_step(local, c, t, cache, mesh=mesh)[0][:, -1])
    got = torch.cat(rows)
    out = dict(stream=stream, ttft_ms=ttft, host_ms=host_ms, device_ms=device_ms, copies_ms=copies_ms,
               collective_share=collective_share, device_by_kernel=by_kernel, launches=dict(launches),
               launches_per_step=per_step, routes=routes)
    if mesh.axis_index(None) == 0:
        ref_cache = decoder.init_cache(c, 1, QWEN2_CACHE, device=dev)
        rows = [decoder.forward(full, c, prompt, ref_cache, last_only=True)[0][:, -1]]
        for t in forced:
            rows.append(decoder.forward(full, c, t, ref_cache)[0][:, -1])
        out["gate"] = logits_gate(torch, f"(a) {kv} teacher-forced", got, torch.cat(rows))
    return out


def par_engines(torch, mesh, cfg, full) -> dict:
    """(b): 8 seeded requests (phase 9's seed and prompts, PAR_NEW_RANGE new
    tokens) through ServingEngine(mesh,
    tp_mode="shard_map") on bf16 and int8 KV and PagedServingEngine(mesh)
    with bf16 and int8 pages: streams, launches and ms a forward at 8 rows
    (the run's steps that start with all 8 rows active: no admission in
    them); on rank 0 each stream against the one-rank engine's
    (solo_streams on the whole tree), the top-2 rule."""
    import dataclasses
    import random

    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine

    rnd = random.Random(8)
    specs = []
    for _ in range(N_QWEN2_REQUESTS):
        n, m = rnd.randint(*PROMPT_RANGE), rnd.randint(*PAR_NEW_RANGE)
        specs.append(dict(prompt=[rnd.randrange(cfg.vocab_size) for _ in range(n)], max_new_tokens=m))
    pages = sum(-(-(len(s["prompt"]) + s["max_new_tokens"]) // SERVE_PAGE) for s in specs)
    cfg8 = dataclasses.replace(cfg, int8_kv=True)
    makers = {
        "slot": lambda: ServingEngine(full, cfg, max_batch=8, steps_per_tick=8, mesh=mesh, tp_mode="shard_map"),
        "slot_int8": lambda: ServingEngine(full, cfg8, max_batch=8, steps_per_tick=8, mesh=mesh,
                                           tp_mode="shard_map"),
        "paged": lambda: PagedServingEngine(full, cfg, max_batch=8, n_pages=pages, page_size=SERVE_PAGE, mesh=mesh),
        "paged_int8": lambda: PagedServingEngine(full, cfg, max_batch=8, n_pages=pages, page_size=SERVE_PAGE,
                                                 int8_kv=True, mesh=mesh)}
    out = {}
    for kind, make in makers.items():
        engine = make()
        reqs = [engine.submit(Request(**s)) for s in specs]
        torch.cuda.synchronize()
        dispatch.reset_counters()
        mesh.routes.clear()
        t0 = time.perf_counter()
        full_s, full_fwd = 0.0, 0
        while engine.has_work():
            at_8, before, t_step = engine.n_active == 8, engine.steps, time.perf_counter()
            engine.step()  # ends in its tokens' copy to the host
            if at_8:
                full_s += time.perf_counter() - t_step
                full_fwd += engine.steps - before
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kv_kernel = "decode_attention:no_wo" if kind == "slot" else QWEN2_ENGINE_KERNELS[kind]
        if not dispatch.LAUNCHES.get(kv_kernel) or dispatch.PLAIN:
            raise AssertionError(f"(b) {kind}: {kv_kernel} not launched or plain calls: {dict(dispatch.LAUNCHES)} "
                                 f"{dict(dispatch.PLAIN)}")
        out[kind] = dict(streams=[r.output for r in reqs], wall_s=wall, forwards=engine.steps,
                         ms_per_forward_8_rows=full_s * 1e3 / max(full_fwd, 1), forwards_at_8_rows=full_fwd,
                         launches=dict(dispatch.LAUNCHES), routes=dict(mesh.routes))
        del engine
    if mesh.axis_index(None) == 0:
        solo = {key: solo_streams(full, c, specs, mesh.device) for key, c in (("bf16", cfg), ("int8", cfg8))}
        for kind, res in out.items():
            ref, gaps = solo["int8" if kind.endswith("int8") else "bf16"]
            res["differing"] = check_streams(f"(b) {kind} vs one-rank", res["streams"], ref, gaps)
    return out


def par_sp(torch, mesh, cfg, full) -> dict:
    """(c): sp_prefill of 1024 seeded tokens (512 a rank) through ring
    attention; on rank 0 the logits and every layer's k / v against the
    one-rank prefill's."""
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.parallel.tp import sp_prefill

    dev = mesh.device
    gen = torch.Generator().manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (1, PAR_SP_TOKENS), generator=gen, dtype=torch.int32).to(dev)
    torch.cuda.synchronize()
    dispatch.reset_counters()
    mesh.routes.clear()
    t0 = time.perf_counter()
    logits, ks, vs = sp_prefill(full, cfg, tokens, mesh=mesh)
    torch.cuda.synchronize()
    out = dict(ms=(time.perf_counter() - t0) * 1e3, launches=dict(dispatch.LAUNCHES), plain=dict(dispatch.PLAIN),
               routes=dict(mesh.routes))
    if dispatch.PLAIN or not dispatch.LAUNCHES.get("quant_matmul_int8"):
        raise AssertionError(f"(c): plain calls or no quant_matmul_int8: {out['launches']} {out['plain']}")
    if mesh.axis_index(None) == 0:
        cache = decoder.init_cache(cfg, 1, PAR_SP_TOKENS, device=dev)
        ref, cache = decoder.prefill(full, cfg, tokens, cache)
        out["gate"] = logits_gate(torch, "(c) sp_prefill logits", logits, ref)
        kv_rel = max((torch.sqrt(((a.float() - b.float()) ** 2).mean()) / torch.sqrt((b.float() ** 2).mean())).item()
                     for got, want in ((ks, cache["k"]), (vs, cache["v"])) for a, b in zip(got, want))
        if not kv_rel <= PAR_GATE:
            raise AssertionError(f"(c): per-layer k / v relative RMS {kv_rel:.4g} > {PAR_GATE}")
        out["kv_rel_rms"] = kv_rel
    return out


def par_pp(torch, cfg, dev) -> dict:
    """(d): pp_forward over a 2-stage pipe axis (12 layers a stage), dense
    bf16 weights of the Qwen2 shape (seed 1), 4 sequences of 128 tokens in 2
    microbatches; on rank 0 against the one-rank dense forward."""
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.parallel.mesh import Mesh
    from rten_tpu_torch.parallel.pp import pp_forward, stack_layer_params

    pipe = Mesh({"pipe": PAR_PP["stages"]}, device=dev)
    dense = qwen2_par_params(torch, cfg, dev, dense=True, seed=1)
    stacked = stack_layer_params(dense)
    gen = torch.Generator().manual_seed(18)
    tokens = torch.randint(0, cfg.vocab_size, (PAR_PP["batch"], PAR_PP["tokens"]), generator=gen,
                           dtype=torch.int32).to(dev)
    torch.cuda.synchronize()
    dispatch.reset_counters()
    t0 = time.perf_counter()
    logits = pp_forward(stacked, cfg, tokens, mesh=pipe, n_microbatches=PAR_PP["microbatches"])
    torch.cuda.synchronize()
    out = dict(ms=(time.perf_counter() - t0) * 1e3, launches=dict(dispatch.LAUNCHES), plain=dict(dispatch.PLAIN),
               routes=dict(pipe.routes))
    if dispatch.PLAIN or dispatch.LAUNCHES.get("flash_attention") != cfg.n_layers // PAR_PP["stages"] * PAR_PP[
            "microbatches"]:
        raise AssertionError(f"(d): each stage must launch flash_attention once a layer a microbatch: {out}")
    if pipe.axis_index(None) == 0:
        ref, _ = decoder.forward(dense, cfg, tokens, None)
        out["gate"] = logits_gate(torch, "(d) pp_forward logits", logits, ref)
    return out


def par_overlap(torch, mesh) -> dict:
    """(e): the three overlapped collective matmuls at GPT-2's MLP widths
    (f32, K over the ranks) against the unfused pair, and ring attention
    (H 12, D 64, T 1024, f32, causal) against one-rank attention."""
    from rten_tpu_torch.kernels.ring_attention import ring_attention_sharded
    from rten_tpu_torch.models import ieee
    from rten_tpu_torch.parallel import overlap

    dev, i, p = mesh.device, mesh.axis_index("model"), mesh.axis_size("model")
    gen = torch.Generator(device=dev).manual_seed(19)
    m, k, n = PAR_OVERLAP["m"], PAR_OVERLAP["k"], PAR_OVERLAP["n"]
    x, w = torch.randn(m, k, generator=gen, device=dev), torch.randn(k, n, generator=gen, device=dev)
    kc, mc, nc = k // p, m // p, n // p
    xs, ws, xr = x[:, i * kc:(i + 1) * kc], w[i * kc:(i + 1) * kc], x[i * mc:(i + 1) * mc]

    def rel(a, b):
        return (torch.sqrt(((a.double() - b.double()) ** 2).mean()) / torch.sqrt((b.double() ** 2).mean())).item()

    full = mesh.psum(ieee.matmul(xs, ws), "model")  # the unfused pair
    runs = {"matmul_allreduce": (lambda: overlap.matmul_allreduce(xs, ws, mesh), full),
            "matmul_reducescatter": (lambda: overlap.matmul_reducescatter(xs, ws, mesh), full[:, i * nc:(i + 1) * nc]),
            "allgather_matmul": (lambda: overlap.allgather_matmul(xr, w, mesh),
                                 ieee.matmul(mesh.all_gather(xr, "model", dim=0), w))}
    out = {}
    for name, (fn, want) in runs.items():
        got = fn()
        err = rel(got, want)
        if not err <= PAR_OVERLAP_GATE:
            raise AssertionError(f"(e) {name}: relative RMS {err:.3g} from the unfused pair > {PAR_OVERLAP_GATE}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        out[name] = dict(rel_rms=err, ms=(time.perf_counter() - t0) * 1e2)
    h, d, t = PAR_RING["h"], PAR_RING["d"], PAR_RING["t"]
    q, kk, v = (torch.randn(1, h, t, d, generator=gen, device=dev) for _ in range(3))
    got = ring_attention_sharded(mesh, q, kk, v, causal=True)
    with ieee.ieee_f32():
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / math.sqrt(d)
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=dev).triu(1), -math.inf)
        want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    err = rel(got, want)
    if not err <= PAR_RING_GATE:
        raise AssertionError(f"(e) ring_attention: relative RMS {err:.3g} from one-rank attention > {PAR_RING_GATE}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring_attention_sharded(mesh, q, kk, v, causal=True)
    torch.cuda.synchronize()
    out["ring_attention"] = dict(rel_rms=err, ms=(time.perf_counter() - t0) * 1e3)
    out["routes"] = dict(mesh.routes)
    # Where a staged collective's time goes: an all-reduce of one 896-wide
    # f32 row (a decode step's) on host tensors (the transport alone), on a
    # card tensor, and on one a kernel has just written; a blocking copy of
    # it to the host alone. ms each, the median of 5 runs of 20.
    row = torch.ones(1, QWEN2["d_model"], device=dev)
    host_row = row.cpu()
    cases = {"all_reduce host": lambda: mesh.psum(host_row, "model"),
             "all_reduce card": lambda: mesh.psum(row, "model"),
             "all_reduce card after a kernel": lambda: mesh.psum(row.add_(0.0), "model"),
             "copy to host after a kernel": lambda: row.add_(0.0).cpu()}
    lat = {}
    for name, fn in cases.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / 20)
        lat[name] = statistics.median(runs)
    out["latency_ms"] = lat
    return out


def par_supervisor(torch, mesh, cfg, full, want) -> dict:
    """(f): (b)'s requests through a ServingSupervisor over the bf16 slot
    engine (one forward a step), a failure injected on rank 1 after step
    PAR_TICK_FAIL, snapshots every PAR_SNAPSHOT steps: the streams equal
    ``want``, (b)'s uninterrupted ones."""
    import random

    from rten_tpu_torch.parallel.multihost import ServingSupervisor
    from rten_tpu_torch.serve import Request, ServingEngine

    armed = [True]

    class Failing(ServingEngine):
        def step(self, n_steps=None):
            out = super().step(n_steps)
            if armed[0] and mesh.axis_index(None) == 1 and self.steps >= PAR_TICK_FAIL:
                armed[0] = False
                raise RuntimeError("injected failure on rank 1")
            return out

    rnd = random.Random(8)
    specs = []
    for _ in range(N_QWEN2_REQUESTS):
        n, m = rnd.randint(*PROMPT_RANGE), rnd.randint(*PAR_NEW_RANGE)
        specs.append(dict(prompt=[rnd.randrange(cfg.vocab_size) for _ in range(n)], max_new_tokens=m))
    sup = ServingSupervisor(lambda: Failing(full, cfg, max_batch=8, mesh=mesh, tp_mode="shard_map"),
                            snapshot_every=PAR_SNAPSHOT, max_restarts=2, mesh=mesh)
    for i, s in enumerate(specs):
        sup.submit(Request(**s, request_id=i))
    t0 = time.perf_counter()
    done = sup.run()
    got = {r.request_id: r.output for r in done}
    if sup.restarts != 1 or [got.get(i) for i in range(len(specs))] != want:
        raise AssertionError(f"(f): {sup.restarts} restarts; streams equal to the uninterrupted run's: "
                             f"{[got.get(i) == w for i, w in enumerate(want)]}")
    return dict(restarts=sup.restarts, wall_s=time.perf_counter() - t0, requests=len(done))


def parallel_rank(device="cuda") -> dict:
    """One rank of phase 16: (a)-(f) in turn on this rank's card. Returns
    each part's results (rank 0 with the gates against the one-rank path)."""
    import torch

    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.parallel import make_mesh, shard_decoder_params

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, PAR_RANKS, device=device)
    dev = mesh.device
    cfg = decoder.DecoderConfig(**QWEN2_CFG, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    full = qwen2_par_params(torch, cfg, dev)
    local = shard_decoder_params(full, cfg, mesh)
    torch.cuda.synchronize()
    out = dict(rank=mesh.axis_index(None), device=str(dev), backend=mesh.backend,
               params_s=time.perf_counter() - t0,
               local_shapes={k: tuple(v["qt"].shape) for k, v in local["layers"][0].items() if isinstance(v, dict)
                             and "qt" in v} | {"lm_head": tuple(local["lm_head"]["qt"].shape)})
    out["a"] = {kv: par_tp(torch, mesh, cfg, full, local, kv) for kv in ("bf16", "int8")}
    out["b"] = par_engines(torch, mesh, cfg, full)
    out["c"] = par_sp(torch, mesh, cfg, full)
    out["d"] = par_pp(torch, cfg, dev)
    out["e"] = par_overlap(torch, mesh)
    out["f"] = par_supervisor(torch, mesh, cfg, full, out["b"]["slot"]["streams"])
    return out


def drive_parallel(torch, bound, smi, out) -> tuple[dict, list]:
    """Phase 16: the per-rank kernel checks in this process, then
    parallel_rank on PAR_RANKS ranks (parallel.launch.run_ranks, the kernels
    already built: each rank loads the library). Prints one line a part
    and returns (the launches of (a)-(d) summed over the ranks, the kernel
    cases)."""
    from rten_tpu_torch.parallel import run_ranks

    t_phase = time.perf_counter()
    cases = check_tp_kernels(torch, bound)
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ran = run_ranks(parallel_rank, PAR_RANKS, device="cuda", timeout_s=PAR_TIMEOUT)
    ranks = ran.results
    r0 = ranks[0]
    log(f"  {PAR_RANKS} ranks, backend {ran.backend}, devices {ran.devices}; the per-rank kernel checks "
        f"{t_ranks - t_phase:.1f} s, the ranks {time.perf_counter() - t_ranks:.1f} s; params {r0['params_s']:.1f} s "
        f"a rank; rank 0's shapes {r0['local_shapes']}; card {smi}")
    launches: dict = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    for kv in ("bf16", "int8"):
        a = [r["a"][kv] for r in ranks]
        for r in a:
            add(r["launches"])
        if any(r["stream"] != a[0]["stream"] for r in a):
            raise AssertionError(f"(a) {kv}: the ranks' streams differ")
        log(f"  (a) tp {kv} KV [{ran.backend}] routes {a[0]['routes']}; time to first token {a[0]['ttft_ms']:.2f} ms; "
            f"host ms a step {a[0]['host_ms']:.3f} ({1e3 / a[0]['host_ms']:.1f} tokens/s); device ms a step by rank "
            f"{[round(r['device_ms'], 4) for r in a]} (host-device copies {[round(r['copies_ms'], 4) for r in a]}); "
            f"the collectives' share of the host step {a[0]['collective_share']:.3f}; "
            f"launches a step {a[0]['launches_per_step']}; gate {r0['a'][kv]['gate']}; {smi}")
    b0 = r0["b"]
    for kind, res in b0.items():
        for r in ranks:
            add(r["b"][kind]["launches"])
            if r["b"][kind]["streams"] != res["streams"]:
                raise AssertionError(f"(b) {kind}: the ranks' streams differ")
        log(f"  (b) {kind} [{ran.backend}] routes {res['routes']}; {res['forwards']} forwards in "
            f"{res['wall_s']:.3f} s; ms a forward at 8 rows {res['ms_per_forward_8_rows']:.3f} (over "
            f"{res['forwards_at_8_rows']}); streams differing from the one-rank engine's "
            f"(top-2 rule) {res['differing']}; launches {res['launches']}; {smi}")
    for part, what in (("c", "sp_prefill 1024 tokens"), ("d", "pp_forward 2 stages x 12 layers")):
        for r in ranks:
            add(r[part]["launches"])
        log(f"  ({part}) {what} [{ran.backend}] routes {r0[part]['routes']}; {r0[part]['ms']:.2f} ms; gate "
            f"{r0[part]['gate']}" + (f"; k / v relative RMS {r0[part]['kv_rel_rms']:.4g}" if part == "c" else "")
            + f"; launches {r0[part]['launches']}; {smi}")
    e = r0["e"]
    log(f"  (e) overlap and ring [{ran.backend}] routes {e['routes']}; "
        + "; ".join(f"{k} rel RMS {v['rel_rms']:.3g} {v['ms']:.3f} ms" for k, v in e.items()
                    if k not in ("routes", "latency_ms"))
        + "; collective ms " + ", ".join(f"{k} {v:.4f}" for k, v in e["latency_ms"].items()) + f"; {smi}")
    log(f"  (f) supervisor [{ran.backend}] restarts {r0['f']['restarts']}, {r0['f']['requests']} requests in "
        f"{r0['f']['wall_s']:.2f} s, streams equal to (b)'s uninterrupted run; {smi}")
    out["parallel"] = dict(backend=ran.backend, devices=ran.devices, ranks=ranks, launches=launches,
                           seconds=time.perf_counter() - t_phase)
    return launches, cases


def parallel_only(torch, bound, detail, kind, smi, label: str) -> int:
    """``--parallel LABEL``: phase 16 (drive_parallel) alone after phases
    1-2, written to chiprun_out/parallel_LABEL.json; its last line is
    marked partial."""
    log("[3/3] parallel: per-rank kernel shapes, then tp / engines / sp / pp / overlap / supervisor on 2 ranks")
    launches, cases = drive_parallel(torch, bound, smi, detail)
    detail["cases"] = cases
    (OUT_DIR / f"parallel_{label}.json").write_text(json.dumps(detail, indent=1, default=str))
    print(smi)
    print(json.dumps({"partial": "parallel", "kind": kind, "label": label, "launches": launches,
                      "seconds": detail["parallel"]["seconds"]}))
    return 0


# ---------------------------------------------------------------------------
# Phase 17: the example apps, the C embedding API
# ---------------------------------------------------------------------------

# The files the apps take (write_app_files): the tier-1 tests' widths, which
# the card's phase 17 (c) reuses. Head dims are 64, the kernels' smallest.
APP_QWEN2 = dict(vocab=500, n_layers=2, d=256, heads=4, kv=2, ff=384, tied=False)  # LLAMA_SLICE_CFG-like
APP_BERT = dict(vocab=3000, n_layers=2, d=256, ff=512, n_pos=128)
APP_W2V = dict(conv_dim=(32, 32), conv_kernel=(10, 3), d=256, n_layers=2, ff=512, vocab=32, pos_k=16, pos_groups=4)
APP_TOKENS = 16  # qwen2_chat.py's new tokens a turn in the tests
QWEN2_APP = dict(vocab=151936, n_layers=24, d=896, heads=14, kv=2, ff=4864)  # Qwen/Qwen2-0.5B config.json
APP_QWEN2_NEW = 64  # phase 17 (a)'s new tokens a turn
RESIDUAL_BN = (0.1, 0.3)  # resnet_tv_state: the scales of each residual branch's last BatchNorm
# Every app but qwen2_chat and imagenet (phase 17 (a) and (b)) on its file route.
FILE_APPS = ("yolo", "deeplab", "detr", "depth_anything", "segment_anything", "jina_similarity", "wav2vec2",
             "silero", "piper", "trocr", "distilvit")
# Each app's --demo flags (the JAX package's tests/test_examples.py), at the
# JAX demos' widths: heads of 32 (gpt2, qwen2_chat, the ViTs and the
# encoder-decoders) and of 16 (bert_qa, jina_similarity, piper). A label
# "app:variant" is a second run of the app.
DEMO_FLAGS = {"imagenet": [], "yolo": [], "deeplab": [], "detr": [], "depth_anything": [], "segment_anything": [],
              "distilvit": ["-n", "3"], "trocr": ["-n", "4"], "jina_similarity": [],
              "qwen2_chat": ["-n", "3", "--turns", "2"], "piper": [], "silero": [], "wav2vec2": ["--beam", "2"],
              "gpt2": ["-n", "8"], "gpt2:int8": ["-n", "8", "--int8"], "bert_qa": []}
DEMO_BF16 = ("qwen2_chat", "gpt2", "gpt2:int8")  # demos whose models are bf16 (the rest f32)


def qwen2_hf_state(seed: int, vocab: int, n_layers: int, d: int, heads: int, kv: int, ff: int,
                   tied: bool = True) -> dict:
    """An HF ``Qwen2ForCausalLM``-named state (``model.`` prefix, nn.Linear
    weights ``[out, in]``, q/k/v biases) with random weights from ``seed``:
    normal 0.02 matrices, embeddings and biases, RMSNorm scales near 1;
    ``lm_head.weight`` is the tied embedding, as ``state_dict()`` of the
    tied HF model gives it, or with ``tied=False`` a matrix of its own
    (whose greedy stream does not just repeat the last token)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hd = d // heads
    st = {"model.embed_tokens.weight": _normal(rng, vocab, d)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        st[p + "input_layernorm.weight"] = 1 + _normal(rng, d, std=0.1)
        st[p + "post_attention_layernorm.weight"] = 1 + _normal(rng, d, std=0.1)
        for proj, n_out in (("q_proj", heads * hd), ("k_proj", kv * hd), ("v_proj", kv * hd)):
            st[f"{p}self_attn.{proj}.weight"], st[f"{p}self_attn.{proj}.bias"] = _normal(rng, n_out, d), \
                _normal(rng, n_out)
        st[p + "self_attn.o_proj.weight"] = _normal(rng, d, heads * hd)
        st[p + "mlp.gate_proj.weight"], st[p + "mlp.up_proj.weight"] = _normal(rng, ff, d), _normal(rng, ff, d)
        st[p + "mlp.down_proj.weight"] = _normal(rng, d, ff)
    st["model.norm.weight"] = 1 + _normal(rng, d, std=0.1)
    st["lm_head.weight"] = st["model.embed_tokens.weight"] if tied else _normal(rng, vocab, d)
    return st


def resnet_tv_state(seed: int, bottleneck: bool, stage_sizes=None, width: int = 64, num_classes: int = 1000) -> dict:
    """A torchvision ``resnet50`` (``bottleneck``) or ``resnet18``-named
    state with random weights from ``seed``: He-normal convolutions,
    BatchNorms with scales and variances in [0.5, 1.5] and means and shifts
    near 0 (each residual branch's last scale in RESIDUAL_BN, so that 16
    blocks do not grow the activations a thousandfold), a normal 0.01
    classifier."""
    import numpy as np

    rng = np.random.default_rng(seed)
    stage_sizes = stage_sizes or ((3, 4, 6, 3) if bottleneck else (2, 2, 2, 2))
    st = {}

    def conv(name, c_out, c_in, k):
        st[name] = rng.standard_normal((c_out, c_in, k, k), dtype=np.float32) * np.float32(np.sqrt(2 / (c_in * k * k)))

    def bn(p, c, scale=None):
        st[p + "weight"] = rng.uniform(*(scale or (0.5, 1.5)), c).astype(np.float32)
        st[p + "bias"] = _normal(rng, c, std=0.1)
        st[p + "running_mean"] = _normal(rng, c, std=0.1)
        st[p + "running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        st[p + "num_batches_tracked"] = np.asarray(0, np.int64)

    conv("conv1.weight", width, 3, 7)
    bn("bn1.", width)
    c_in, exp = width, (4 if bottleneck else 1)
    for si, n_blocks in enumerate(stage_sizes):
        c_mid = width * 2 ** si
        for bi in range(n_blocks):
            p, stride = f"layer{si + 1}.{bi}.", (2 if si > 0 and bi == 0 else 1)
            if bottleneck:
                conv(p + "conv1.weight", c_mid, c_in, 1)
                conv(p + "conv2.weight", c_mid, c_mid, 3)
                conv(p + "conv3.weight", c_mid * exp, c_mid, 1)
                bn(p + "bn3.", c_mid * exp, RESIDUAL_BN)
            else:
                conv(p + "conv1.weight", c_mid, c_in, 3)
                conv(p + "conv2.weight", c_mid, c_mid, 3)
            bn(p + "bn1.", c_mid)
            bn(p + "bn2.", c_mid, None if bottleneck else RESIDUAL_BN)
            if stride != 1 or c_in != c_mid * exp:
                conv(p + "downsample.0.weight", c_mid * exp, c_in, 1)
                bn(p + "downsample.1.", c_mid * exp)
            c_in = c_mid * exp
    st["fc.weight"], st["fc.bias"] = _normal(rng, num_classes, c_in, std=0.01), _normal(rng, num_classes, std=0.01)
    return st


def wav2vec2_hf_state(seed: int, conv_dim, conv_kernel, d: int, n_layers: int, ff: int, vocab: int, pos_k: int,
                      pos_groups: int) -> dict:
    """An HF ``Wav2Vec2ForCTC``-named state (group-norm feature extractor
    without conv biases, post-LN layers, the positional convolution as
    ``weight_g`` / ``weight_v``) with random weights from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    st = {}

    def ln(p, n):
        st[p + "weight"], st[p + "bias"] = 1 + _normal(rng, n, std=0.1), _normal(rng, n)

    def linear(p, n_out, n_in):
        st[p + "weight"], st[p + "bias"] = _normal(rng, n_out, n_in, std=0.05), _normal(rng, n_out)

    c_in = 1
    for i, (c, k) in enumerate(zip(conv_dim, conv_kernel)):
        st[f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight"] = _normal(rng, c, c_in, k, std=0.2)
        c_in = c
    ln("wav2vec2.feature_extractor.conv_layers.0.layer_norm.", conv_dim[0])
    ln("wav2vec2.feature_projection.layer_norm.", conv_dim[-1])
    linear("wav2vec2.feature_projection.projection.", d, conv_dim[-1])
    pos = "wav2vec2.encoder.pos_conv_embed.conv."
    st[pos + "weight_g"] = 1 + _normal(rng, 1, 1, pos_k, std=0.1)
    st[pos + "weight_v"] = _normal(rng, d, d // pos_groups, pos_k, std=0.05)
    st[pos + "bias"] = _normal(rng, d)
    ln("wav2vec2.encoder.layer_norm.", d)
    for i in range(n_layers):
        p = f"wav2vec2.encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{p}attention.{proj}.", d, d)
        ln(p + "layer_norm.", d)
        linear(p + "feed_forward.intermediate_dense.", ff, d)
        linear(p + "feed_forward.output_dense.", d, ff)
        ln(p + "final_layer_norm.", d)
    linear("lm_head.", vocab, d)
    return st


def _save_graph(g, path: Path) -> str:
    from rten_tpu_torch.format import save_rten

    path.write_bytes(save_rten(g))
    return str(path)


def conv_graph(path: Path, size: int, out_ch: int, kernel: int, stride: int, head=None, seed: int = 0) -> str:
    """A .rten file: image [1, 3, size, size] → Conv(out_ch, kernel,
    stride) → ``head(g, conv)``'s outputs (the conv alone without one)."""
    import numpy as np

    from rten_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    g = Graph()
    x = g.add_value("image", shape=[1, 3, size, size])
    w = g.add_constant("w", (rng.standard_normal((out_ch, 3, kernel, kernel)) * 0.3).astype(np.float32))
    conv = g.add_simple_op("Conv", [x, w], attrs={"strides": [stride, stride]})
    g.inputs, g.outputs = [x], (head(g, conv) if head else [conv])
    return _save_graph(g, path)


def _yolo_head(g, conv):
    """[1, 8, 8, 8] → [1, 64, 8]: 64 candidates of (4 box + 1 obj + 3
    classes), the box channels scaled into pixels."""
    import numpy as np

    r = g.add_simple_op("Reshape", [conv, g.add_constant("sh", np.asarray([1, 8, 64], np.int32))])
    t = g.add_simple_op("Transpose", [r], attrs={"perm": [0, 2, 1]})
    scale = g.add_constant("scale", np.asarray([32, 32, 16, 16, 1, 1, 1, 1], np.float32))
    return [g.add_simple_op("Mul", [t, scale])]


def _detr_head(g, conv):
    """[1, 9, 4, 4] → logits [1, 16, 5] (4 classes + no-object) and
    sigmoid boxes [1, 16, 4]."""
    import numpy as np

    r = g.add_simple_op("Reshape", [conv, g.add_constant("sh", np.asarray([1, 9, 16], np.int32))])
    t = g.add_simple_op("Transpose", [r], attrs={"perm": [0, 2, 1]})

    def cut(i, a, b):
        return g.add_simple_op("Slice", [t, g.add_constant(f"s{i}", np.asarray([a], np.int32)),
                                         g.add_constant(f"e{i}", np.asarray([b], np.int32)),
                                         g.add_constant(f"a{i}", np.asarray([2], np.int32))])

    return [cut(0, 0, 5), g.add_simple_op("Sigmoid", [cut(1, 5, 9)])]


def vad_graph(path: Path, d_in: int = 9, d_h: int = 16, seed: int = 0) -> str:
    """A GRU → MatMul → Sigmoid VAD .rten: feats [T, 1, d_in] → [T, 1]."""
    import numpy as np

    from rten_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    g = Graph()
    x = g.add_value("feats", shape=["T", 1, d_in])
    w = g.add_constant("w", (rng.standard_normal((1, 3 * d_h, d_in)) * 0.5).astype(np.float32))
    r = g.add_constant("r", (rng.standard_normal((1, 3 * d_h, d_h)) * 0.5).astype(np.float32))
    b = g.add_constant("b", np.zeros((1, 6 * d_h), np.float32))
    gru = g.add_simple_op("GRU", [x, w, r, b], attrs={"direction": "forward", "hidden_size": d_h}, n_outputs=2)
    flat = g.add_simple_op("Reshape", [gru, g.add_constant("sh", np.asarray([-1, d_h], np.int32))])
    w_cls = g.add_constant("w_cls", (rng.standard_normal((d_h, 1)) * 0.8).astype(np.float32))
    g.inputs, g.outputs = [x], [g.add_simple_op("Sigmoid", [g.add_simple_op("MatMul", [flat, w_cls])])]
    return _save_graph(g, path)


def tts_graph(path: Path, vocab: int = 27, feat: int = 160, seed: int = 0) -> str:
    """A Gather → Reshape → Tanh TTS .rten: ids [1, N] → N · feat samples."""
    import numpy as np

    from rten_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    g = Graph()
    ids = g.add_value("ids", shape=[1, "N"], dtype="int32")
    emb = g.add_constant("emb", (rng.standard_normal((vocab, feat)) * 0.7).astype(np.float32))
    gathered = g.add_simple_op("Gather", [emb, ids], attrs={"axis": 0})
    flat = g.add_simple_op("Reshape", [gathered, g.add_constant("sh", np.asarray([-1], np.int32))])
    g.inputs, g.outputs = [ids], [g.add_simple_op("Tanh", [flat])]
    return _save_graph(g, path)


def patch_encoder_graph(path: Path, h: int, w: int, d: int) -> tuple[str, int]:
    """A line / image encoder .rten: [1, 3, h, w] → Conv(d, 8x8/8) → [1, N,
    d] memory; returns (path, N)."""
    import numpy as np

    from rten_tpu_torch.graph import Graph

    rng = np.random.default_rng(1)
    g = Graph()
    x = g.add_value("image", shape=[1, 3, h, w])
    wconv = g.add_constant("wconv", (rng.standard_normal((d, 3, 8, 8)) * 0.2).astype(np.float32))
    conv = g.add_simple_op("Conv", [x, wconv], attrs={"strides": [8, 8]})
    n = (h // 8) * (w // 8)
    r = g.add_simple_op("Reshape", [conv, g.add_constant("sh", np.asarray([1, d, n], np.int32))])
    g.inputs, g.outputs = [x], [g.add_simple_op("Transpose", [r], attrs={"perm": [0, 2, 1]})]
    return _save_graph(g, path), n


def encdec_decoder_graph(path: Path, enc_n: int, d: int, v: int, seed: int = 2, max_pos: int = 256) -> str:
    """A Whisper / TrOCR-class decoder .rten with HF-Optimum inputs: masked
    self-attention over past_key_values.0.decoder.*, cross-attention
    recomputed from encoder_hidden_states each call (GraphBackend hoists
    it), logits and the present K / V (the JAX package's
    ``tests/test_graph_backend.py`` ``build_encdec_decoder_graph``)."""
    import numpy as np

    from rten_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    g = Graph()
    ids = g.add_value("input_ids", ["batch", None])
    mask = g.add_value("attention_mask", ["batch", None])
    pos = g.add_value("position_ids", ["batch", None])
    enc = g.add_value("encoder_hidden_states", ["batch", enc_n, d])
    pk_in = g.add_value("past_key_values.0.decoder.key", ["batch", None, d])
    pv_in = g.add_value("past_key_values.0.decoder.value", ["batch", None, d])
    g.inputs = [ids, mask, pos, enc, pk_in, pv_in]

    def c(name, arr):
        return g.add_constant(name, np.asarray(arr))

    def mat(name, *shape, std):
        return c(name, rng.standard_normal(shape).astype(np.float32) * std)

    wte, wpe = mat("wte", v, d, std=0.5), mat("wpe", max_pos, d, std=0.1)
    wq, wk, wv, wq2, wk2, wv2 = (mat(n, d, d, std=0.3) for n in ("wq", "wk", "wv", "wq2", "wk2", "wv2"))
    wlm = mat("wlm", d, v, std=0.5)
    op = g.add_simple_op
    x = op("Add", [op("Gather", [wte, ids], {"axis": 0}, name="emb"), op("Gather", [wpe, pos], {"axis": 0},
                                                                         name="pemb")], name="x")
    q, k, vv = (op("MatMul", [x, wm], name=n) for wm, n in ((wq, "q"), (wk, "k"), (wv, "v")))
    pk, pv = g.add_value("present.0.decoder.key"), g.add_value("present.0.decoder.value")
    g.add_operator("concat_k", "Concat", {"axis": 1}, [pk_in, k], [pk])
    g.add_operator("concat_v", "Concat", {"axis": 1}, [pv_in, vv], [pv])
    raw = op("MatMul", [q, op("Transpose", [pk], {"perm": [0, 2, 1]}, name="pk_t")], name="scores_raw")
    scale = c("scale", np.float32(1.0 / np.sqrt(d)))
    scores = op("Mul", [raw, scale], name="scores")
    onef = c("onef", np.float32(1.0))
    kpos = op("Sub", [op("CumSum", [op("Cast", [mask], {"to": "float"}, name="mf"), c("one_ax", np.int32(1))],
                         name="csum"), onef], name="kpos")
    qposf = op("Cast", [pos], {"to": "float"}, name="qposf")
    ax1, ax2 = c("ax1", np.int32([1])), c("ax2", np.int32([2]))
    causal = op("LessOrEqual", [op("Unsqueeze", [kpos, ax1], name="kpos_b"),
                                op("Unsqueeze", [qposf, ax2], name="qpos_b")], name="causal")
    valid = op("Mul", [causal, op("Unsqueeze", [mask, ax1], name="mask_b")], name="valid")
    vm1 = op("Sub", [op("Cast", [valid], {"to": "float"}, name="validf"), onef], name="vm1")
    masked = op("Add", [scores, op("Mul", [vm1, c("big", np.float32(1e9))], name="sbias")], name="masked")
    h1 = op("Add", [op("MatMul", [op("Softmax", [masked], {"axis": -1}, name="probs"), pv], name="ctx"), x],
            name="h1")
    q2 = op("MatMul", [h1, wq2], name="q2")
    k_enc, v_enc = op("MatMul", [enc, wk2], name="k_enc"), op("MatMul", [enc, wv2], name="v_enc")
    raw2 = op("MatMul", [q2, op("Transpose", [k_enc], {"perm": [0, 2, 1]}, name="k_enc_t")], name="raw2")
    probs2 = op("Softmax", [op("Mul", [raw2, scale], name="scores2")], {"axis": -1}, name="probs2")
    h2 = op("Add", [op("MatMul", [probs2, v_enc], name="ctx2"), h1], name="h2")
    logits = g.add_value("logits")
    g.add_operator("lm", "MatMul", {}, [h2, wlm], [logits])
    g.outputs = [logits, pk, pv]
    return _save_graph(g, path)


def write_app_files(tmp: Path, qwen2: dict | None = None) -> dict:
    """Every file the apps' file routes take, written into ``tmp`` from
    seeds with numpy: PNGs (64² and 32² scenes, a 16 x 64 text line), .wav
    files (1 s at 16 kHz; 0.6 s at 8 kHz, which wav2vec2.py resamples), the
    .rten graphs (the five vision heads, the VAD, the TTS, two encoder /
    decoder pairs), seeded HF-named states (a BERT at APP_BERT, a
    wav2vec2 at APP_W2V, a ResNet-18, and with ``qwen2`` a Qwen2 at those
    widths), README tokenizers (200 BPE merges, APP_BERT's WordPiece) and
    a documents file. Returns the paths and the texts by name."""
    import numpy as np

    from rten_tpu_torch.audio import write_wav
    from rten_tpu_torch.examples import common
    from rten_tpu_torch.image.io import write_image

    text = (ROOT / "README.md").read_text(encoding="utf-8")
    paras = readme_paragraphs(text)
    f = {}
    for name, (hw, seed) in {"scene64": ((64, 64), 3), "scene32": ((32, 32), 3)}.items():
        f[name] = str(tmp / f"{name}.png")
        write_image(f[name], common.synthetic_image(*hw, seed=seed))
    rng = np.random.default_rng(3)
    f["line"] = str(tmp / "line.png")
    write_image(f["line"], np.clip(0.9 - 0.8 * (rng.random((3, 16, 64)) < 0.2), 0, 1).astype(np.float32))
    for name, (sec, sr) in {"wav16k": (1.0, 16000), "wav8k": (0.6, 8000)}.items():
        f[name] = str(tmp / f"{name}.wav")
        write_wav(f[name], common.synthetic_audio(sec, sr=sr, seed=0)[0], sr)
    f["yolo"] = conv_graph(tmp / "yolo.rten", 64, 8, 8, 8, _yolo_head)
    f["detr"] = conv_graph(tmp / "detr.rten", 64, 9, 16, 16, _detr_head)
    f["deeplab"] = conv_graph(tmp / "deeplab.rten", 64, 6, 8, 8)
    f["sam"] = conv_graph(tmp / "sam.rten", 32, 16, 4, 4)
    f["depth"] = conv_graph(tmp / "depth.rten", 32, 1, 8, 8)
    f["vad"], f["tts"] = vad_graph(tmp / "vad.rten"), tts_graph(tmp / "tts.rten")
    for app, (h, w) in {"trocr": (16, 64), "distilvit": (32, 32)}.items():
        f[app + "_enc"], n = patch_encoder_graph(tmp / f"{app}_enc.rten", h, w, 16)
        f[app + "_dec"] = encdec_decoder_graph(tmp / f"{app}_dec.rten", n, 16, 32)
    b, w2 = APP_BERT, APP_W2V
    f["bert"], f["w2v"], f["resnet18"] = (str(tmp / n) for n in ("bert.npz", "w2v.npz", "resnet18.npz"))
    np.savez(f["bert"], **bert_qa_hf_state(0, b["vocab"], b["n_layers"], b["d"], b["ff"], b["n_pos"]))
    np.savez(f["w2v"], **wav2vec2_hf_state(0, **{k: w2[k] for k in ("conv_dim", "conv_kernel", "d", "n_layers",
                                                                    "ff", "vocab", "pos_k", "pos_groups")}))
    np.savez(f["resnet18"], **resnet_tv_state(0, bottleneck=False, num_classes=10))
    if qwen2:
        f["qwen2"] = str(tmp / "qwen2.npz")
        np.savez(f["qwen2"], **qwen2_hf_state(0, **qwen2))
    f["bpe"], f["wordpiece"], f["docs"] = (str(tmp / n) for n in ("bpe.json", "wordpiece.json", "docs.txt"))
    Path(f["bpe"]).write_text(json.dumps(bpe_tokenizer_spec(train_bpe(text, 200))), encoding="utf-8")
    Path(f["wordpiece"]).write_text(json.dumps(wordpiece_tokenizer_spec(text, b["vocab"])), encoding="utf-8")
    sentences = [" ".join(s.split()[:16]) for p in paras for s in p.split(". ")]  # 16 words each
    Path(f["docs"]).write_text("\n".join(sentences[1:6]), encoding="utf-8")
    f["query"] = sentences[0]
    return f


def app_argv(name: str, f: dict, out_dir: Path | None = None) -> list[str]:
    """The flags of app ``name``'s file route on ``write_app_files``' files
    (the JAX package's tests' flags); a PNG or WAV the app writes goes to
    ``out_dir``."""
    out = {"yolo": "boxes.png", "deeplab": "mask.png", "depth_anything": "depth.png", "piper": "speech.wav"}
    argv = {
        "imagenet": ["--image", f["scene64"], "--model", f["resnet18"]],
        "yolo": ["--image", f["scene64"], "--model", f["yolo"], "--conf", "0.1"],
        "deeplab": ["--image", f["scene64"], "--model", f["deeplab"]],
        "detr": ["--image", f["scene64"], "--model", f["detr"], "--threshold", "0.1"],
        "depth_anything": ["--image", f["scene32"], "--model", f["depth"]],
        "segment_anything": ["--image", f["scene32"], "--model", f["sam"], "--point", "20,10"],
        "jina_similarity": ["--model", f["bert"], "--tokenizer", f["wordpiece"], "--docs", f["docs"], "--query",
                            f["query"]],
        "wav2vec2": ["--audio", f["wav8k"], "--model", f["w2v"], "--heads", str(APP_W2V["d"] // 64), "--beam", "4"],
        "silero": ["--audio", f["wav16k"], "--model", f["vad"], "--on", "0.5", "--off", "0.4"],
        "piper": ["--model", f["tts"], "--text", "hello world"],
        "trocr": ["--image", f["line"], "--encoder", f["trocr_enc"], "--decoder", f["trocr_dec"], "-n", "6"],
        "distilvit": ["--image", f["scene32"], "--encoder", f["distilvit_enc"], "--decoder", f["distilvit_dec"],
                      "-n", "5"],
        "qwen2_chat": ["--model", f.get("qwen2", ""), "--tokenizer", f["bpe"], "-n", str(APP_TOKENS)],
    }[name]
    if name in out and out_dir is not None:
        argv += ["--out", str(Path(out_dir) / out[name])]
    return argv


_NUMBER = r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?"


def lines_differ(got: list[str], want: list[str], rtol: float, atol: float) -> str | None:
    """None when the printed lines agree: the same text around the numbers,
    and each number within ``rtol`` relative or ``atol`` absolute, or one
    unit in the last decimal place it was printed with (a rounding); else
    the first difference."""
    import re

    if len(got) != len(want):
        return f"{len(got)} lines, not {len(want)}"
    for a, b in zip(got, want):
        if re.split(_NUMBER, a) != re.split(_NUMBER, b):
            return f"{a!r} != {b!r}"
        for x, y in zip(re.findall(_NUMBER, a), re.findall(_NUMBER, b)):
            unit = 10.0 ** -len(y.split(".")[1].split("e")[0].split("E")[0]) if "." in y else 0.0
            if abs(float(x) - float(y)) > max(atol, rtol * abs(float(y)), unit * 1.0001):
                return f"{a!r} != {b!r} ({x} / {y})"
    return None


def written_differ(got: str, want: str) -> str | None:
    """None when a written PNG or WAV equals the other but for at most
    0.1% of its pixels or samples, each off by one code; else why not."""
    import numpy as np

    if got.endswith(".wav"):
        from rten_tpu_torch.audio.io import _parse_riff

        (*meta_a, data_a), (*meta_b, data_b) = _parse_riff(got), _parse_riff(want)
        if meta_a != meta_b:
            return f"WAV formats {meta_a} / {meta_b}"
        a, b = np.frombuffer(data_a, np.int16).astype(np.int64), np.frombuffer(data_b, np.int16).astype(np.int64)
    else:
        from PIL import Image

        a, b = (np.asarray(Image.open(p), np.int64) for p in (got, want))
    if a.shape != b.shape:
        return f"shapes {a.shape} / {b.shape}"
    off = np.abs(a - b)
    if off.max(initial=0) > 1 or (off > 0).mean() > 1e-3:
        return f"{int((off > 0).sum())} of {off.size} values differ, by up to {off.max()}"
    return None


EMBED_DRIVER_C = r"""
#include <stdio.h>
#include <stdlib.h>

/* librten_embed.so ABI */
#ifdef __cplusplus
extern "C" {
#endif
extern int rten_init(const char *python_path);
extern const char *rten_last_error(void);
extern void *rten_model_load_file(const char *path);
extern int rten_model_input_count(void *m);
extern int rten_model_output_count(void *m);
extern const char *rten_model_input_name(void *m, int i);
extern void *rten_tensor_f32(const float *data, const int *shape, int ndim);
extern int rten_model_run(void *m, void *const *in, int n_in, void **out, int max_out);
extern int rten_tensor_ndim(void *t);
extern void rten_tensor_shape(void *t, int *out);
extern const float *rten_tensor_data_f32(void *t);
extern void rten_tensor_free(void *t);
extern void rten_model_free(void *m);
#ifdef __cplusplus
}
#endif

int main(int argc, char **argv) {
  if (rten_init(argv[2]) != 0) {
    fprintf(stderr, "init failed: %s\n", rten_last_error());
    return 1;
  }
  void *model = rten_model_load_file(argv[1]);
  if (!model) {
    fprintf(stderr, "load failed: %s\n", rten_last_error());
    return 3;
  }
  printf("inputs=%d outputs=%d first_input=%s\n",
         rten_model_input_count(model), rten_model_output_count(model),
         rten_model_input_name(model, 0));

  float data[8];
  for (int i = 0; i < 8; ++i) data[i] = (float)i - 3.0f;
  int shape[2] = {2, 4};
  void *x = rten_tensor_f32(data, shape, 2);
  void *outs[4];
  int n = rten_model_run(model, &x, 1, outs, 4);
  if (n < 0) {
    fprintf(stderr, "run failed: %s\n", rten_last_error());
    return 1;
  }
  int oshape[8];
  int nd = rten_tensor_ndim(outs[0]);
  rten_tensor_shape(outs[0], oshape);
  const float *od = rten_tensor_data_f32(outs[0]);
  printf("n_out=%d ndim=%d shape=%d,%d\n", n, nd, oshape[0], oshape[1]);
  long total = 1;
  for (int i = 0; i < nd; ++i) total *= oshape[i];
  for (long i = 0; i < total; ++i) printf("%.9g ", od[i]);
  printf("\n");
  rten_tensor_free(x);
  rten_tensor_free(outs[0]);
  rten_model_free(model);
  return 0;
}
"""
EMBED_INPUT_SHAPE = (2, 4)


def embed_model(path: Path, seed: int = 0):
    """The embedding check's .rten: relu(x @ w) + 1 over x [2, 4], w [4, 3]
    from ``seed``; returns w."""
    import numpy as np

    from rten_tpu_torch.graph import Graph

    wv = np.random.default_rng(seed).standard_normal((4, 3)).astype(np.float32)
    g = Graph()
    x = g.add_value("x", list(EMBED_INPUT_SHAPE))
    mm = g.add_simple_op("MatMul", [x, g.add_constant("w", wv)], name="mm")
    out = g.add_simple_op("Add", [g.add_simple_op("Relu", [mm], name="relu"), g.add_constant("one", np.float32(1.0))],
                          name="plus1")
    g.inputs, g.outputs = [x], [out]
    _save_graph(g, path)
    return wv


def embed_input():
    """The C driver's input: x[i] = i - 3, shape EMBED_INPUT_SHAPE."""
    import numpy as np

    return (np.arange(8, dtype=np.float32) - 3.0).reshape(EMBED_INPUT_SHAPE)


def build_embed_driver(tmp: Path) -> Path:
    """``librten_embed.so`` built by ``native.build.build_embed`` and the C
    driver (EMBED_DRIVER_C) compiled and linked against it with g++;
    returns the driver's path."""
    from rten_tpu_torch.native import build as native_build

    lib = native_build.build_embed()
    if lib is None:
        raise RuntimeError("the embedding API did not build: no g++ or no Python.h")
    src, exe = tmp / "embed_driver.c", tmp / "embed_driver"
    src.write_text(EMBED_DRIVER_C)
    subprocess.run(["g++", "-o", str(exe), str(src), str(lib), f"-Wl,-rpath,{lib.parent}"], check=True,
                   capture_output=True, text=True, timeout=120)
    return exe


def run_embed_driver(exe: Path, model: str, device: str, timeout: float = 300):
    """The C driver run on ``model`` with RTEN_TORCH_DEVICE=``device``, the
    embedded interpreter given this one's import path: the completed
    process."""
    env = dict(os.environ, RTEN_TORCH_DEVICE=device, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    return subprocess.run([str(exe), model, str(ROOT)], capture_output=True, text=True, env=env, timeout=timeout)


def embed_output(proc):
    """The driver's output values [2, 3] from its printed lines."""
    import numpy as np

    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or lines[:2] != ["inputs=1 outputs=1 first_input=x", "n_out=1 ndim=2 shape=2,3"]:
        raise AssertionError(f"the embedding driver: exit {proc.returncode}, {proc.stdout!r} {proc.stderr[-2000:]!r}")
    return np.asarray([float(v) for v in lines[2].split()], np.float32).reshape(2, 3)



APP_CARD_RTOL, APP_CARD_ATOL = 1e-3, 1e-4  # the card's apps against their --cpu runs (printed numbers)
IMAGENET_PROB_TOL = 1e-3  # (b): ResNet-50's top-5 probabilities, card against --cpu


def app_run(torch, name: str, argv: list[str], result: dict | None = None) -> dict:
    """One run of app ``name``'s ``main(argv)`` with the launch counters
    set to 0 before it and read after: its printed lines, exit code, host
    seconds and launches (and plain calls) by kernel mode."""
    import contextlib
    import importlib
    import io

    from rten_tpu_torch.kernels import dispatch

    main = importlib.import_module(f"rten_tpu_torch.examples.{name}").main
    buf = io.StringIO()
    torch.cuda.synchronize()
    dispatch.reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv) if result is None else main(argv, result=result)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(rc=rc, lines=buf.getvalue().splitlines(), seconds=seconds, launches=dict(dispatch.LAUNCHES),
                plain=dict(dispatch.PLAIN))


def qwen2_chat_app(torch, f: dict, out) -> dict:
    """Phase 17 (a): qwen2_chat.py --model q.npz --int8 at Qwen2-0.5B's
    widths, as shipped (TopKSampler(20, 0.8)) and with the sampler pinned
    to TopKSampler(1); returns the launches of both runs."""
    import itertools

    import numpy as np

    from rten_tpu_torch import generate
    from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend, TopKSampler
    from rten_tpu_torch.models import decoder

    argv = ["--model", f["qwen2"], "--int8", "--tokenizer", f["bpe"], "-n", str(APP_QWEN2_NEW)]
    n_layers, steps = QWEN2_APP["n_layers"], 2 * (APP_QWEN2_NEW - 1)  # each turn's first token: its prompt's
    runs, launches = {}, {}
    for kind in ("sampled", "pinned"):
        res = {}
        if kind == "pinned":
            generate.TopKSampler = lambda k, temperature=1.0: TopKSampler(1, temperature)
        try:
            run = app_run(torch, "qwen2_chat", argv, res)
        finally:
            generate.TopKSampler = TopKSampler
        got = run["launches"]
        if run["rc"] != 0 or run["plain"] or any(not got.get(k) for k in QWEN2_KERNELS) \
                or got.get("decode_attention:gqa") != n_layers * steps:
            raise AssertionError(f"(a) qwen2_chat.py {kind}: exit {run['rc']}, launched {got} (each of "
                                 f"{QWEN2_KERNELS}; decode_attention:gqa {n_layers} x {steps}), plain {run['plain']}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        times = res["metrics"].step_times_s
        decode = [t for i, t in enumerate(times) if i % APP_QWEN2_NEW]  # a turn's first step is its prompt's
        runs[kind] = dict(run, res=res, tokens_per_s=len(times) / sum(times), host_ms_step=1e3 * sum(decode) / len(decode),
                          prompt_ms=[1e3 * times[i] for i in range(0, len(times), APP_QWEN2_NEW)])
    params, cfg, pinned = runs["pinned"]["res"]["params"], runs["pinned"]["res"]["cfg"], runs["pinned"]["res"]
    if cfg.d_model != QWEN2_APP["d"] or cfg.n_kv_heads != QWEN2_APP["kv"] or cfg.vocab_size != QWEN2_APP["vocab"]:
        raise AssertionError(f"(a) the app inferred {cfg}")

    # The pinned turns against a greedy Generator over the same appended prompt ids.
    gen = Generator(NativeBackend(params, cfg, device="cuda"), GeneratorConfig(max_tokens=10**9))
    ref = []
    for prompt in pinned["prompts"]:
        gen.append_prompt(prompt)
        ref.append([int(t[0]) for t in itertools.islice(gen, APP_QWEN2_NEW)])
    if pinned["turns"] != ref:
        raise AssertionError(f"(a) the pinned turns differ from the greedy Generator's: {pinned['turns']} / {ref}")

    # Device time a step: the sampled path's step (decode + TopKSampler(20, 0.8)) after the first turn.
    backend = NativeBackend(params, cfg, device="cuda")
    backend.prefill(np.asarray([pinned["prompts"][0]], np.int32))
    last = np.asarray([[pinned["turns"][0][-1]]], np.int32)
    sampler, rng = TopKSampler(20, temperature=0.8), torch.Generator(device=backend.device).manual_seed(0)
    by_kernel, calls = profile_by_kernel(torch, lambda: sampler.sample(rng, backend.decode(last)), 16)
    device_ms = sum(by_kernel.values()) / 1e3
    sampled = runs["sampled"]

    # The first turn's prompt and answer, teacher-forced: kernels and plain versions (phase 9's rule).
    prompt, answer = pinned["prompts"][0], pinned["turns"][0]
    seq = torch.tensor([prompt + answer[:-1]], dtype=torch.int32, device=backend.device)
    served = torch.tensor(answer, dtype=torch.int64, device=backend.device)

    def one_forward_logits():
        lg, _ = decoder.prefill(params, cfg, seq, decoder.init_cache(cfg, 1, cfg.max_seq, device="cuda"))
        return lg[0, len(prompt) - 1:].float()

    k_logits = one_forward_logits()
    with plain_decoder(decoder):
        p_logits = one_forward_logits()
    gaps = {what: (lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]) for what, lg in
            (("kernels", k_logits), ("plain", p_logits))}
    if any(bool((g > GAP_TOL).any()) for g in gaps.values()) or not bool(torch.isfinite(k_logits).all()):
        raise AssertionError(f"(a) a pinned token loses to the argmax of the one-forward prefill by > {GAP_TOL}: "
                             f"{ {k: g.max().item() for k, g in gaps.items()} }")
    rel = rel_rms(k_logits, p_logits)
    res = dict(
        tokens_per_s=sampled["tokens_per_s"], host_ms_step=sampled["host_ms_step"], device_ms_step=device_ms,
        idle_share=max(0.0, 1 - device_ms / sampled["host_ms_step"]), device_us_by_kernel=by_kernel,
        device_calls_a_step=calls, prompt_ms=sampled["prompt_ms"], app_s=sampled["seconds"],
        pinned_tokens_per_s=runs["pinned"]["tokens_per_s"], pinned_host_ms_step=runs["pinned"]["host_ms_step"],
        pinned_app_s=runs["pinned"]["seconds"], prompts=[len(p) for p in pinned["prompts"]],
        sampled_texts=sampled["res"]["texts"], launches={k: r["launches"] for k, r in runs.items()},
        max_gap={k: g.max().item() for k, g in gaps.items()}, agree={k: int((g == 0).sum()) for k, g in gaps.items()},
        rel_rms_kernels_plain=rel)
    log(f"  (a) qwen2_chat.py --int8, Qwen2-0.5B widths (tied head), 2 turns of {APP_QWEN2_NEW} (prompts "
        f"{res['prompts']} tokens): sampled {res['tokens_per_s']:.1f} tokens/s, host {res['host_ms_step']:.4f} ms a "
        f"decode step, device {device_ms:.4f} ms (profiler, 16 steps) -> idle share {res['idle_share']:.4f}; "
        f"prompt steps {[round(t, 3) for t in res['prompt_ms']]} ms; the app {sampled['seconds']:.1f} s with the "
        f"file's load; pinned to TopKSampler(1): turns = the greedy Generator's; teacher-forced turn 0: kernels / "
        f"plain agree with it at {res['agree']} of {len(answer)}, worst gap {res['max_gap']} (tol {GAP_TOL}), "
        f"relative RMS {rel:.4g}; launches {runs['sampled']['launches']}")
    out["qwen2_chat"] = res
    del params, backend, gen, runs
    torch.cuda.empty_cache()
    return launches


def drive_apps(torch, out) -> dict:
    """Phase 17: the port's example apps and its C embedding API on the
    card, through ``main(argv)`` as ``python -m
    rten_tpu_torch.examples.<app>`` runs them, the files in a temporary
    directory.

    (a) ``qwen2_chat.py --model q.npz --int8 --tokenizer bpe.json -n 64``
    on a seeded HF-named state at Qwen2-0.5B's widths (QWEN2_APP; the tied
    embedding written as ``lm_head.weight``, 2.5 GB in f32) with 2000 BPE
    merges from README: 2 turns through ``Generator.append_prompt``, as
    shipped (TopKSampler(20, 0.8): tokens/s, host ms a decode step, device
    ms a step and the idle share) and with the sampler pinned to
    TopKSampler(1), whose turns must equal a greedy
    ``Generator(NativeBackend)`` stream over the same appended prompt ids;
    each run launches quant_gemv_int8, quant_matmul_int8, flash_attention
    and decode_attention:gqa (24 a decode step) and no plain version; the
    first turn's prompt and answer teacher-forced through the kernels and
    the plain versions under phase 9's top-2 rule.
    (b) ``imagenet.py`` on a torchvision-named ResNet-50 (seed 0) and a
    224² PNG: its top-5 classes those of its ``--cpu`` run, probabilities
    within IMAGENET_PROB_TOL.
    (c) Every other app (FILE_APPS) on its file route, on the files of the
    tier-1 tests (``write_app_files``): printed lines those of its ``--cpu``
    run (numbers within APP_CARD_RTOL / APP_CARD_ATOL), written PNG / WAV
    files equal but for 0.1% off by one code, launches by kernel mode and
    host seconds; then each of the 15 apps' ``--demo`` at the JAX demos'
    widths (DEMO_FLAGS; gpt2 also with ``--int8``) exits 0 with no plain
    call.
    (d) The C embedding API: a C program built against ``build_embed``'s
    library runs a .rten with RTEN_TORCH_DEVICE=cuda; its output within
    1e-5 of ``Model.load_file(device="cuda")``'s and 1e-4 of its own run
    with RTEN_TORCH_DEVICE=cpu.

    Returns the phase's launches and those of them on the f32 routes (every
    app of (c) and every demo but qwen2_chat's, whose models are f32)."""
    import collections
    import tempfile

    import numpy as np

    from rten_tpu_torch.examples import common
    from rten_tpu_torch.image.io import write_image
    from rten_tpu_torch.runtime.session import Model

    t_phase = time.perf_counter()
    res, launches, f32 = {}, collections.Counter(), collections.Counter()

    def add(got, f32_route=False):
        launches.update(got)
        if f32_route:
            f32.update(got)

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        f = write_app_files(tmp)
        text = (ROOT / "README.md").read_text(encoding="utf-8")
        Path(f["bpe"]).write_text(json.dumps(bpe_tokenizer_spec(train_bpe(text, TEXT_MERGES))), encoding="utf-8")
        t0 = time.perf_counter()
        f["qwen2"] = str(tmp / "qwen2_05b.npz")
        np.savez(f["qwen2"], **qwen2_hf_state(0, **QWEN2_APP))
        log(f"  files written in {time.perf_counter() - t0:.1f} s (the Qwen2 state "
            f"{Path(f['qwen2']).stat().st_size / 1e9:.2f} GB)")
        add(qwen2_chat_app(torch, f, res))
        Path(f["qwen2"]).unlink()

        # (b) imagenet.py at ResNet-50's width.
        f["resnet50"], f["image224"] = str(tmp / "resnet50.npz"), str(tmp / "image224.png")
        np.savez(f["resnet50"], **resnet_tv_state(0, bottleneck=True))
        write_image(f["image224"], common.synthetic_image(224, 224, seed=3))
        argv = ["--image", f["image224"], "--model", f["resnet50"]]
        card, cpu = {}, {}
        run = app_run(torch, "imagenet", argv, card)
        app_run(torch, "imagenet", [*argv, "--cpu"], cpu)
        err = float(np.abs(card["probs"] - cpu["probs"]).max())
        if run["rc"] != 0 or card["top"] != cpu["top"] or not err <= IMAGENET_PROB_TOL:
            raise AssertionError(f"(b) imagenet.py: top-5 {card['top']} / --cpu {cpu['top']}, max |p| difference "
                                 f"{err} (tol {IMAGENET_PROB_TOL})")
        add(run["launches"])
        res["imagenet"] = dict(top=card["top"], max_prob_err=err, seconds=run["seconds"], launches=run["launches"])
        log(f"  (b) imagenet.py, ResNet-50 (seed 0), 224²: top-5 {card['top']} = --cpu's, probabilities within "
            f"{err:.3g}; {run['seconds']:.2f} s with the file's load; launches {run['launches']}")

        # (c) every other app on its file route, then each app's --demo.
        apps = {}
        for name in FILE_APPS:
            out_card, out_cpu = tmp / f"card_{name}", tmp / f"cpu_{name}"
            out_card.mkdir()
            out_cpu.mkdir()
            run = app_run(torch, name, app_argv(name, f, out_card))
            ref = app_run(torch, name, [*app_argv(name, f, out_cpu), "--cpu"])
            diff = lines_differ([line.replace(str(out_card), "OUT") for line in run["lines"]],
                                [line.replace(str(out_cpu), "OUT") for line in ref["lines"]], APP_CARD_RTOL,
                                APP_CARD_ATOL)
            written = sorted(p.name for p in out_cpu.iterdir())
            diff = diff or next((f"{w}: {d}" for w in written
                                 if (d := written_differ(str(out_card / w), str(out_cpu / w)))), None)
            if run["rc"] != 0 or ref["rc"] != 0 or diff or run["plain"]:
                raise AssertionError(f"(c) {name}: exit {run['rc']} / --cpu {ref['rc']}; {diff}; plain "
                                     f"{run['plain']}")
            add(run["launches"], f32_route=True)
            apps[name] = dict(seconds=run["seconds"], cpu_seconds=ref["seconds"], launches=run["launches"],
                              lines=run["lines"][-3:])
            log(f"  (c) {name}: = --cpu; {run['seconds']:.3f} s (--cpu {ref['seconds']:.3f} s); "
                f"launches {run['launches']}")
        demos = {}
        for name, flags in DEMO_FLAGS.items():
            run = app_run(torch, name.split(":")[0], ["--demo", *flags])
            if run["rc"] != 0 or not run["lines"] or run["plain"]:
                raise AssertionError(f"(c) {name} --demo: exit {run['rc']}, plain {run['plain']}")
            add(run["launches"], f32_route=name not in DEMO_BF16)
            demos[name] = dict(seconds=run["seconds"], launches=run["launches"])
        log(f"  (c) every --demo exits 0: " + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in demos.items()))
        res["apps"], res["demos"] = apps, demos

        # (d) The C embedding API on the card.
        model = tmp / "embed.rten"
        embed_model(model)
        t0 = time.perf_counter()
        exe = build_embed_driver(tmp)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = embed_output(run_embed_driver(exe, str(model), "cuda"))
        card_s = time.perf_counter() - t0
        want = common.to_numpy(Model.load_file(model, device="cuda").run([embed_input()])[0])
        host = embed_output(run_embed_driver(exe, str(model), "cpu"))
        e_card, e_cpu = float(np.abs(got - want).max()), float(np.abs(got - host).max())
        if not (e_card <= 1e-5 and e_cpu <= 1e-4):
            raise AssertionError(f"(d) the embedding API on the card: {e_card} from Model (tol 1e-5), {e_cpu} from "
                                 f"its CPU run (tol 1e-4)")
        res["embed"] = dict(max_err_model=e_card, max_err_cpu=e_cpu, build_s=build_s, run_s=card_s)
        log(f"  (d) C program through librten_embed.so, RTEN_TORCH_DEVICE=cuda: within {e_card:.3g} of the "
            f"in-process Model on the card, {e_cpu:.3g} of RTEN_TORCH_DEVICE=cpu; built in {build_s:.2f} s, "
            f"{card_s:.2f} s a run (process start and the embedded interpreter's imports)")
    res["seconds"] = time.perf_counter() - t_phase
    out["apps"] = res
    log(f"  ({res['seconds']:.1f} s)")
    return dict(launches), dict(f32)


def apps_only(torch, detail, kind, smi, label: str) -> int:
    """``--apps LABEL``: phase 17 (drive_apps) alone after phases 1-2,
    written to chiprun_out/apps_LABEL.json; its last line is marked
    partial."""
    log("[3/3] the example apps and the C embedding API")
    launches, _f32 = drive_apps(torch, detail)
    (OUT_DIR / f"apps_{label}.json").write_text(json.dumps(detail, indent=1, default=str))
    print(smi)
    print(json.dumps({"partial": "apps", "kind": kind, "label": label, "launches": launches,
                      "seconds": detail["apps"]["seconds"]}))
    return 0

KERNELS = {
    "quant_gemv_int8": dict(source="rten_tpu_torch/kernels/csrc/quant_gemv.cu",
                            replaces="rten_tpu/kernels/quant_matmul.py:339", timed="lm_head_argmax"),
    "quant_mlp_int8": dict(source="rten_tpu_torch/kernels/csrc/quant_mlp.cu",
                           replaces="rten_tpu/kernels/quant_matmul.py:935", timed="mlp+next_qkv"),
    "decode_attention": dict(source="rten_tpu_torch/kernels/csrc/decode_attention.cu",
                             replaces="rten_tpu/kernels/decode_attention.py:734", timed="kv_len=300"),
    "quant_matmul_int8": dict(source="rten_tpu_torch/kernels/csrc/quant_matmul.cu",
                              replaces="rten_tpu/kernels/quant_matmul.py:590", timed="up+gelu M=64"),
    "flash_attention": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                            replaces="rten_tpu/kernels/attention.py:117", timed="Tq=512 kv_len=512"),
    # The split modes (a launch of the same kernel as a cluster that splits
    # K, or the KV axis, and sums its partials through distributed shared
    # memory): their cases are the kernel's cases whose plan splits.
    # The f32 routes the encoders' and vision models' f32 presets take
    # (phase 12): quant_matmul_int8's three exact bf16 passes (qmm_f32_kernel;
    # f32 activations) and flash_attention's six (flash_mma_kernel on f32
    # tiles split in registers). Their launches are the wrappers' counts
    # read around the f32 forwards of phases 12-17.
    "quant_matmul_int8:f32": dict(source="rten_tpu_torch/kernels/csrc/quant_matmul.cu",
                                  replaces="rten_tpu/kernels/quant_matmul.py:590", timed="f32 distilbert up",
                                  cases_of="quant_matmul_int8", select=lambda c: c.get("route") == "f32"),
    "flash_attention:f32": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                                replaces="rten_tpu/kernels/attention.py:117", timed="f32 distilbert",
                                cases_of="flash_attention", select=lambda c: c.get("route") == "f32"),
    "quant_matmul_int8:split_k": dict(source="rten_tpu_torch/kernels/csrc/quant_matmul.cu",
                                      replaces="rten_tpu/kernels/quant_matmul.py:590", timed="down M=64",
                                      cases_of="quant_matmul_int8", select=lambda c: c.get("split", 1) > 1),
    "flash_attention:split_kv": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                                     replaces="rten_tpu/kernels/attention.py:117", timed="Tq=24 q_offset=300",
                                     cases_of="flash_attention", select=lambda c: c.get("split", 1) > 1),
    "decode_attention_int8": dict(source="rten_tpu_torch/kernels/csrc/decode_attention_int8.cu",
                                  replaces="rten_tpu/kernels/decode_attention.py:1667", timed="B=1 kv_len=300"),
    "paged_decode_attention": dict(source="rten_tpu_torch/kernels/csrc/paged_attention.cu",
                                   replaces="rten_tpu/kernels/paged_attention.py:592", timed="B=1 kv_len=300"),
    "paged_decode_attention_int8": dict(source="rten_tpu_torch/kernels/csrc/paged_attention_int8.cu",
                                        replaces="rten_tpu/kernels/paged_attention.py:413", timed="B=1 kv_len=300"),
    "quant_gemv_int8:w8a8": dict(source="rten_tpu_torch/kernels/csrc/quant_gemv.cu",
                                 replaces="rten_tpu/kernels/quant_matmul.py:224", timed="lm_head_argmax M=1"),
    "quant_mlp_int8:w8a8": dict(source="rten_tpu_torch/kernels/csrc/quant_mlp.cu",
                                replaces="rten_tpu/kernels/quant_matmul.py:895", timed="mlp+next_qkv M=1"),
    "quant_matmul_w8a8": dict(source="rten_tpu_torch/kernels/csrc/quant_matmul_w8a8.cu",
                              replaces="rten_tpu/kernels/quant_matmul.py:760", timed="up+gelu M=64"),
    "quant_matmul_w8a8:split_k": dict(source="rten_tpu_torch/kernels/csrc/quant_matmul_w8a8.cu",
                                      replaces="rten_tpu/kernels/quant_matmul.py:760", timed="down M=64",
                                      cases_of="quant_matmul_w8a8", select=lambda c: c.get("split", 1) > 1),
    # The row quantizer runs inside quant_matmul_w8a8's one launch; its own
    # kernel, with quant_matmul_w8a8_codes the two-launch pair that launch
    # must equal, is checked in phase 3 and launches on no main path.
    "quantize_rows_int8": dict(source="rten_tpu_torch/kernels/csrc/quant_matmul_w8a8.cu",
                               replaces="rten_tpu/kernels/quant_matmul.py:792", timed="M=64", on_path=False),
    "decode_block": dict(source="rten_tpu_torch/kernels/csrc/decode_block.cu",
                         replaces="rten_tpu/kernels/decode_attention.py:118", timed="kv_len=300 +next_qkv"),
    "decode_block:gqa": dict(source="rten_tpu_torch/kernels/csrc/decode_block.cu",
                             replaces="rten_tpu/kernels/decode_attention.py:118", timed="kv_len=300 +next_qkv"),
    "decode_attention:gqa": dict(source="rten_tpu_torch/kernels/csrc/decode_attention.cu",
                                 replaces="rten_tpu/kernels/decode_attention.py:734", timed="B=1 kv_len=300"),
    "decode_attention:no_wo": dict(source="rten_tpu_torch/kernels/csrc/decode_attention.cu",
                                   replaces="rten_tpu/kernels/decode_attention.py:734", timed="B=1 kv_len=300"),
    "decode_attention_int8:gqa": dict(source="rten_tpu_torch/kernels/csrc/decode_attention_int8.cu",
                                      replaces="rten_tpu/kernels/decode_attention.py:1667", timed="B=1 kv_len=300"),
    "paged_decode_attention:gqa": dict(source="rten_tpu_torch/kernels/csrc/paged_attention.cu",
                                       replaces="rten_tpu/kernels/paged_attention.py:592", timed="B=1 kv_len=300"),
    "paged_decode_attention_int8:gqa": dict(source="rten_tpu_torch/kernels/csrc/paged_attention_int8.cu",
                                            replaces="rten_tpu/kernels/paged_attention.py:413",
                                            timed="B=1 kv_len=300"),
    # No model calls matmul_fused (the JAX package's tests alone do): it is
    # held against its plain version in phase 3 and launches on no main
    # path. Its ragged route (bf16 rows TMA cannot address) likewise.
    "matmul_fused": dict(source="rten_tpu_torch/kernels/csrc/matmul_fused.cu",
                         replaces="rten_tpu/kernels/matmul_pallas.py:102", timed="512x768x3072", on_path=False),
    "matmul_fused:ragged": dict(source="rten_tpu_torch/kernels/csrc/matmul_fused.cu",
                                replaces="rten_tpu/kernels/matmul_pallas.py:102", timed="512x768x3070",
                                on_path=False, cases_of="matmul_fused", select=lambda c: c.get("route") == "ragged"),
    # Head dims beside 64 and 128, and pages under 64 positions: each
    # wrapper also counts a launch at head dim D under name:d<D> and over
    # pages of P (not a multiple of 64) under name:page<P>. On the main
    # paths: flash at 32 (phase 12's MiniLM, the demos) and 16 (bert_qa.py,
    # jina_similarity.py and piper.py --demo), decode_attention at 32
    # (gpt2.py --demo, with and without --int8), pages of 16 (phase 5).
    # The other modes are checked in phase 3 and launch on no main path.
    "flash_attention:d16": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                                replaces="rten_tpu/kernels/attention.py:117", timed="bf16 synthetic 24x16",
                                cases_of="flash_attention", select=lambda c: c.get("head_dim") == 16),
    "flash_attention:d32": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                                replaces="rten_tpu/kernels/attention.py:117", timed="bf16 minilm",
                                cases_of="flash_attention", select=lambda c: c.get("head_dim") == 32),
    "flash_attention:d80": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                                replaces="rten_tpu/kernels/attention.py:117", timed="phi-2", on_path=False,
                                cases_of="flash_attention", select=lambda c: c.get("head_dim") == 80),
    "flash_attention:d96": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                                replaces="rten_tpu/kernels/attention.py:117", timed="phi-3-mini", on_path=False,
                                cases_of="flash_attention", select=lambda c: c.get("head_dim") == 96),
    "decode_attention:d32": dict(source="rten_tpu_torch/kernels/csrc/decode_attention.cu",
                                 replaces="rten_tpu/kernels/decode_attention.py:734",
                                 timed="synthetic 24x32 B=1 kv_len=300"),
    "decode_attention_int8:d32": dict(source="rten_tpu_torch/kernels/csrc/decode_attention_int8.cu",
                                      replaces="rten_tpu/kernels/decode_attention.py:1667",
                                      timed="synthetic 24x32 B=1 kv_len=300", on_path=False),
    "paged_decode_attention:d32": dict(source="rten_tpu_torch/kernels/csrc/paged_attention.cu",
                                       replaces="rten_tpu/kernels/paged_attention.py:592",
                                       timed="synthetic 24x32 B=1 kv_len=300", on_path=False),
    "paged_decode_attention_int8:d32": dict(source="rten_tpu_torch/kernels/csrc/paged_attention_int8.cu",
                                            replaces="rten_tpu/kernels/paged_attention.py:413",
                                            timed="synthetic 24x32 B=1 kv_len=300", on_path=False),
    "decode_block:d32": dict(source="rten_tpu_torch/kernels/csrc/decode_block.cu",
                             replaces="rten_tpu/kernels/decode_attention.py:118",
                             timed="synthetic 24x32 kv_len=300", on_path=False),
    # Head dims above 256 (flash_attention's 256 instance in slices) and
    # decode_block's narrow rows (8, 4, 2, 1 on its 16 instance): checked in
    # phase 3; no model of the main paths has such heads.
    **{f"flash_attention:d{d}": dict(source="rten_tpu_torch/kernels/csrc/flash_attention.cu",
                                     replaces="rten_tpu/kernels/attention.py:117", timed="bf16 synthetic GQA",
                                     on_path=False, cases_of="flash_attention",
                                     select=lambda c, d=d: c.get("head_dim") == d) for d in (300, 320, 512)},
    **{f"decode_block:d{d}": dict(source="rten_tpu_torch/kernels/csrc/decode_block.cu",
                                  replaces="rten_tpu/kernels/decode_attention.py:118",
                                  timed=f"{shape} kv_len=300", on_path=False)
       for shape, (_h, _hk, *hd) in BLOCK_SHAPES.items() for d in hd if d < 16},
    "paged_decode_attention:page16": dict(source="rten_tpu_torch/kernels/csrc/paged_attention.cu",
                                          replaces="rten_tpu/kernels/paged_attention.py:592",
                                          timed="qwen2 B=1 kv_len=300"),
    "paged_decode_attention_int8:page32": dict(source="rten_tpu_torch/kernels/csrc/paged_attention_int8.cu",
                                               replaces="rten_tpu/kernels/paged_attention.py:413",
                                               timed="llama-3-8b B=1 kv_len=300", on_path=False),
}


def prefill_only(torch, bound, cfg, detail, kind, smi, label: str = "") -> int:
    """``--prefill [LABEL]``: the prefill kernels at both models' shapes
    (phase 3's check_prefill_kernels and check_w8a8_matmul), matmul_fused on
    its three routes (check_matmul_fused), and the device µs by kernel and
    the launches of one prefill forward of GPT-2-small and of the
    Qwen2-0.5B shape at prompts 64 and 512, weight-only and W8A8, written
    to chiprun_out/prefill.json (prefill_LABEL.json). A timing mode, not
    the check: its last line is marked partial, never the full run's ok
    line, and it holds no launch count to the one-launch rule, so that
    ``--package`` can time a parent commit's package with the same checks
    in the same call: parent, tree, tree, parent."""
    import dataclasses

    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder

    randn, pack, _norm_vecs, bf16_err, record, cases = check_tools(torch)
    log("[3/4] prefill kernels and matmul_fused against their plain versions (GPT-2-small and Qwen2-0.5B shapes)")
    check_prefill_kernels(torch, bound, cfg, randn, pack, bf16_err, record)
    check_w8a8_matmul(torch, bound, cfg, randn, pack, record)
    check_matmul_fused(torch, bound, cfg, randn, bf16_err, record)
    detail["cases"] = cases
    log("[4/4] device us by kernel and launches of one prefill forward, weight-only and W8A8")
    forwards, launches = {}, {}
    gen = torch.Generator().manual_seed(0)
    for key, make_cfg, cache_len in (("gpt2", lambda: cfg, CACHE_LEN),
                                     ("qwen2", lambda: decoder.DecoderConfig(**QWEN2_CFG, dtype=torch.bfloat16),
                                      QWEN2_CACHE)):
        mcfg = make_cfg()
        params = (decoder.quantize_params_int8(decoder.init_params(0, mcfg, device="cuda"), device="cuda")
                  if key == "gpt2" else qwen2_params(torch, mcfg))
        for n in TTFT_PROMPTS:
            ids = torch.randint(0, mcfg.vocab_size, (1, n), generator=gen).to(torch.int32).cuda()
            for mode, run_cfg in (("", mcfg), (" w8a8", dataclasses.replace(mcfg, w8a8=True))):
                by_kernel = prefill_device_us(torch, run_cfg, params, ids, cache_len)
                forwards[f"{key}{mode} {n}"] = by_kernel
                dispatch.reset_counters()
                cache = decoder.init_cache(run_cfg, 1, cache_len, device="cuda")
                decoder.prefill(params, run_cfg, ids, cache, lm_head_mode="argmax", last_only=True)
                launches[f"{key}{mode} {n}"] = dict(dispatch.LAUNCHES)
                log(f"  {key}{mode} prefill {n}: device {sum(by_kernel.values()) / 1e3:.4f} ms; launches a "
                    f"forward {sum(dispatch.LAUNCHES.values())} {dict(dispatch.LAUNCHES)}; by kernel (us):")
                for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
                    log(f"    {us:9.3f}  {name[:90]}")
        del params
        torch.cuda.empty_cache()
    detail["prefill_forward_us"] = forwards
    detail["prefill_forward_launches"] = launches
    (OUT_DIR / (f"prefill_{label}.json" if label else "prefill.json")).write_text(json.dumps(detail, indent=1))
    print(smi)
    print(json.dumps({"partial": "prefill", "kind": kind, "label": label,
                      "prefill_ms": {k: sum(v.values()) / 1e3 for k, v in forwards.items()},
                      "launches_a_forward": {k: sum(v.values()) for k, v in launches.items()}}))
    return 0


def encoders_only(torch, bound, detail, kind, smi, label: str) -> int:
    """``--encoders LABEL``: phase 3's encoder kernel modes
    (check_encoder_kernels) and phase 12 (drive_encoders), written to
    chiprun_out/encoders_LABEL.json; its last line is marked partial."""
    randn, pack, _norm_vecs, _bf16_err, record, cases = check_tools(torch)
    log("[3/4] the encoders' kernel modes against their plain versions")
    check_encoder_kernels(torch, bound, randn, pack, record)
    detail["cases"] = cases
    log("[4/4] encoders and vision at full width")
    launches, f32_runs = drive_encoders(torch, detail)
    (OUT_DIR / f"encoders_{label}.json").write_text(json.dumps(detail, indent=1))
    print(smi)
    print(json.dumps({"partial": "encoders", "kind": kind, "label": label, "launches": launches,
                      "f32_launches": f32_runs, "seconds": detail["encoders"]["seconds"]}))
    return 0


def kv_only(torch, bound, cfg, detail, kind, smi, label: str) -> int:
    """``--kv LABEL``: the four KV kernels in every mode and decode_block at
    the shapes phase 3 times them (check_decode_attention, check_kv_kernels,
    check_gqa_kernels, check_decode_block, check_decode_attention_b8,
    check_head_dims_and_pages), each
    with its plan, host µs and launches a call, written to
    chiprun_out/kv_LABEL.json. A timing mode: its last line is marked
    partial, never the full run's ok line, and it holds no launch count to
    the one-launch rule, so that ``--package`` can time a parent commit's
    package (unpacked under rten_tpu_torch/_build/, git-ignored) with the
    same checks in the same call: parent, tree, tree, parent."""
    randn, pack, norm_vecs, bf16_err, record, cases = check_tools(torch)
    log("[3/3] KV kernels and decode_block against their plain versions (GPT-2-small and Qwen2-0.5B shapes)")
    check_decode_attention(torch, bound, cfg, randn, pack, bf16_err, record)
    torch.cuda.empty_cache()
    check_kv_kernels(torch, bound, cfg, randn, record)
    torch.cuda.empty_cache()
    check_gqa_kernels(torch, bound, randn, pack, record)
    torch.cuda.empty_cache()
    check_decode_block(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record)
    check_decode_attention_b8(torch, bound, cfg, randn, pack, bf16_err, record)
    from rten_tpu_torch.kernels import decode_attention as da

    if hasattr(da, "kv_head_dim_supported"):  # a package with the KV kernels' other head dims and pages
        check_head_dims_and_pages(torch, bound, cfg, randn, pack, record)
    detail["cases"] = cases
    (OUT_DIR / f"kv_{label}.json").write_text(json.dumps(detail, indent=1))
    print(smi)
    print(json.dumps({"partial": "kv", "kind": kind, "label": label}))
    return 0


def decode_block_digest(torch, cfg) -> str:
    """A digest of decode_block's outputs (out, next qkv, both caches) at
    GPT-2-small's block, kv_len 300 of S 768, on inputs made on the host
    from seed 7: the same digest from two packages shows that a change left
    the kernel's bits alone."""
    import hashlib

    from rten_tpu_torch.kernels import decode_attention as da

    gen = torch.Generator().manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    d, ff, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim

    def rand(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).cuda()

    def pack(n, k):
        return (torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).cuda(),
                (torch.rand(n, generator=gen) * (0.04 / 127) + 0.01 / 127).cuda())

    kc, vc = rand(1, h, CACHE_LEN, hd, scale=1.5), rand(1, h, CACHE_LEN, hd)
    wo, wos = pack(d, h * hd)
    wu, su = pack(ff, d)
    wd, sd = pack(d, ff)
    wq, sq = pack(3 * d, d)
    mlp = (wu, su, wd, sd, 0.1 * rand(ff, dtype=f32), 0.1 * rand(d, dtype=f32), 1 + 0.1 * rand(d, dtype=f32),
           0.1 * rand(d, dtype=f32))
    nxt = (wq, sq, 0.1 * rand(3 * d, dtype=f32), 1 + 0.1 * rand(d, dtype=f32), 0.1 * rand(d, dtype=f32))
    lens = torch.full((1,), 300, dtype=torch.int32, device="cuda")
    out, qkv = da.decode_block(rand(1, 3, h, 1, hd, scale=1.5), kc, vc, lens, wo, wos, 0.1 * rand(d, dtype=f32),
                               rand(1, d), mlp, nxt, activation="gelu", norm="layernorm")
    digest = hashlib.sha256()
    for t in (out, qkv, kc, vc):
        digest.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def gemv_only(torch, bound, cfg, detail, kind, smi, label: str) -> int:
    """``--gemv LABEL``: the decode GEMV and MLP at 1 and 8 rows, weight-only
    at GPT-2-small's and the Qwen2-0.5B shape's widths (check_gemv_kernels)
    and W8A8 (check_w8a8_decode), decode_attention with its fused wo at B 1
    (MHA: check_decode_attention; GQA, and GQA without wo:
    check_gqa_kernels) and B 8 (check_decode_attention_b8), decode_block
    beside the two kernels it replaces (check_decode_block), and
    decode_block's output digest (decode_block_digest), written to
    chiprun_out/gemv_LABEL.json. A timing
    mode like ``--kv``: its last line is marked partial, and it holds no
    launch count to the one-launch rule, so that ``--package`` can time a
    parent commit's package in the same call: parent, tree, tree, parent."""
    randn, pack, norm_vecs, bf16_err, record, cases = check_tools(torch)
    log("[3/3] the decode GEMV, MLP and fused wo against their plain versions (GPT-2-small and Qwen2-0.5B shapes)")
    check_gemv_kernels(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record)
    torch.cuda.empty_cache()
    check_w8a8_decode(torch, bound, cfg, randn, pack, norm_vecs, record)
    torch.cuda.empty_cache()
    check_decode_attention(torch, bound, cfg, randn, pack, bf16_err, record)
    check_gqa_kernels(torch, bound, randn, pack, record)
    torch.cuda.empty_cache()
    check_decode_block(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record)
    check_decode_attention_b8(torch, bound, cfg, randn, pack, bf16_err, record)
    detail["decode_block_digest"] = decode_block_digest(torch, cfg)
    log(f"  decode_block digest {detail['decode_block_digest']}")
    detail["cases"] = cases
    (OUT_DIR / f"gemv_{label}.json").write_text(json.dumps(detail, indent=1))
    print(smi)
    print(json.dumps({"partial": "gemv", "kind": kind, "label": label}))
    return 0


def one_launch_w8a8(cases) -> None:
    """quant_matmul_w8a8 above 8 rows: one launch of its own a call and
    none of quantize_rows_int8."""
    wrong = [f"{c['shape']}: {c['launches_a_call']}" for c in cases
             if c["kernel"] == "quant_matmul_w8a8" and "launches_a_call" in c
             and c["launches_a_call"] != {"quant_matmul_w8a8": 1}]
    if wrong:
        raise AssertionError("quant_matmul_w8a8 not one launch a call: " + "; ".join(wrong))


def one_launch_a_call(cases) -> None:
    """Each case's launches a call: the KV kernels one attention launch (two
    with the fused wo, the GEMV its own launch) and no combine kernel; the
    decode GEMV (its argmax included) and MLP one launch."""
    wrong = [f"{c['kernel']} {c['shape']}: {c['launches_per_call']} launches a call {c['kernel_names']}"
             f" (profiles taken: {c.get('profile_attempts', 1)})"
             for c in cases if "launches_per_call" in c
             and (c["launches_per_call"] != c["expect_launches"] or any("combine" in n for n in c["kernel_names"]))]
    if wrong:
        raise AssertionError("kernels not at their launches a call: " + "; ".join(wrong))


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Build, check and drive rten_tpu_torch on one NVIDIA card.")
    parser.add_argument("--prefill", nargs="?", const="", metavar="LABEL",
                        help="the prefill kernels' timing mode (prefill_only); LABEL names its output file")
    parser.add_argument("--kv", metavar="LABEL", help="the KV kernels' timing mode (kv_only)")
    parser.add_argument("--gemv", metavar="LABEL", help="the decode GEMV's and MLP's timing mode (gemv_only)")
    parser.add_argument("--encoders", metavar="LABEL",
                        help="the encoders' kernel modes and phase 12 alone (encoders_only)")
    parser.add_argument("--graph", metavar="LABEL",
                        help="QuantMatMul's kernel calls and phase 13 alone (graph_only)")
    parser.add_argument("--files", metavar="LABEL",
                        help="the lifted path's kernel modes and phase 14 alone (files_only)")
    parser.add_argument("--text", metavar="LABEL",
                        help="phase 15 alone: tokenizers, the example apps, the trace (text_only)")
    parser.add_argument("--parallel", metavar="LABEL",
                        help="phase 16 alone: per-rank kernel shapes and the 2-rank parallel paths (parallel_only)")
    parser.add_argument("--apps", metavar="LABEL",
                        help="phase 17 alone: the example apps and the C embedding API (apps_only)")
    parser.add_argument("--package", metavar="DIR",
                        help="with --prefill, --kv, --gemv, --encoders or --files: import rten_tpu_torch from DIR")
    opts = parser.parse_args()
    if opts.package and not (opts.kv or opts.gemv or opts.encoders or opts.files or opts.prefill is not None):
        parser.error("--package times another package's kernels: it needs --prefill, --kv, --gemv, --encoders or "
                     "--files")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    root = Path(opts.package).resolve() if opts.package else ROOT
    if not (root / "rten_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: rten_tpu_torch is not in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from rten_tpu_torch.kernels import _build
    from rten_tpu_torch.models import decoder

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32 products
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    log(f"[1/18] ({time.perf_counter() - t_start:.1f} s) device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card, mem_rate, op_rate, int8_rate, f32_rate = card_rates(kind)
    log(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"rates used: {mem_rate / 1e12} TB/s, {op_rate / 1e12} TFLOP/s bf16, {int8_rate / 1e12} TOP/s int8, "
        f"{f32_rate / 1e12} TFLOP/s f32 ({card} data sheet, dense)")
    bound = Bound(mem_rate, op_rate, int8_rate, f32_rate)
    detail = dict(device=dict(kind=kind, nvidia_smi=smi, mem_rate=mem_rate, bf16_rate=op_rate, int8_rate=int8_rate,
                              f32_rate=f32_rate))

    log(f"[2/18] ({time.perf_counter() - t_start:.1f} s) build")
    t0 = time.perf_counter()
    _build.library()
    built = _build.BUILD_SECONDS
    log(f"  kernels {'built' if built is not None else 'loaded'} in {time.perf_counter() - t0:.2f} s "
        f"({_build.source_hash()})")
    from rten_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    native_lib = native_build.build()
    if native_lib is None:
        raise RuntimeError("the native host library did not build: no C++ compiler (g++) on PATH")
    log(f"  native host library {native_lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    ptxas = _build.build_log()
    (OUT_DIR / "build_log.txt").write_text(ptxas)
    regs = [line.split("Used")[1].split(",")[0].strip() for line in ptxas.splitlines() if "Used" in line]
    spills = [line.strip() for line in ptxas.splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    log(f"  ptxas: {len(regs)} kernels, registers {sorted(set(regs))}; spilling: {spills or 'none'}")
    detail["build_seconds"] = built

    cfg = decoder.DecoderConfig(dtype=torch.bfloat16, max_seq=1024)
    if opts.prefill is not None:
        return prefill_only(torch, bound, cfg, detail, kind, smi, opts.prefill)
    if opts.kv:
        return kv_only(torch, bound, cfg, detail, kind, smi, opts.kv)
    if opts.gemv:
        return gemv_only(torch, bound, cfg, detail, kind, smi, opts.gemv)
    if opts.encoders:
        return encoders_only(torch, bound, detail, kind, smi, opts.encoders)
    if opts.graph:
        return graph_only(torch, bound, detail, kind, smi, opts.graph)
    if opts.files:
        return files_only(torch, bound, detail, kind, smi, opts.files)
    if opts.text:
        return text_only(torch, detail, kind, smi, opts.text)
    if opts.parallel:
        return parallel_only(torch, bound, detail, kind, smi, opts.parallel)
    if opts.apps:
        return apps_only(torch, detail, kind, smi, opts.apps)
    log(f"[3/18] ({time.perf_counter() - t_start:.1f} s) "
        "kernels against their plain versions (GPT-2-small shapes, bf16)")
    cases = check_kernels(torch, bound, cfg)
    one_launch_a_call(cases)
    detail["cases"] = cases

    t0 = time.perf_counter()
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"  params: GPT-2-small int8, seed 0, {time.perf_counter() - t0:.1f} s to make and quantize")
    log(f"[4/18] ({time.perf_counter() - t_start:.1f} s) "
        "GPT-2-small prefill and decode through Generator(NativeBackend(device='cuda'))")
    launches, forced = drive_serve(torch, cfg, params, mem_rate, op_rate, detail, check_capture=True)

    log(f"[5/18] ({time.perf_counter() - t_start:.1f} s) "
        "continuous-batching serving: slot and paged engines, int8 KV, HTTP (GPT-2-small)")
    for name, n in drive_serving(torch, cfg, params, detail).items():
        launches[name] = launches.get(name, 0) + n

    log(f"[6/18] ({time.perf_counter() - t_start:.1f} s) "
        "W8A8: GPT-2-small through Generator and the slot engine, the accuracy gate")
    for name, n in drive_w8a8(torch, cfg, params, mem_rate, int8_rate, detail).items():
        launches[name] = launches.get(name, 0) + n
    log(f"[7/18] ({time.perf_counter() - t_start:.1f} s) "
        "mega: GPT-2-small with DecoderConfig(mega=True), the whole block in one kernel a layer")
    for name, n in drive_mega(torch, cfg, params, mem_rate, op_rate, detail, forced).items():
        launches[name] = launches.get(name, 0) + n
    del params
    torch.cuda.empty_cache()
    log(f"[8/18] ({time.perf_counter() - t_start:.1f} s) "
        "tiny_starcoder_py shape (MQA 12/1): Generator two-kernel and mega, the mega gate")
    for name, n in drive_starcoder(torch, mem_rate, op_rate, detail).items():
        launches[name] = launches.get(name, 0) + n
    log(f"[9/18] ({time.perf_counter() - t_start:.1f} s) "
        "Qwen2-0.5B shape (RoPE, GQA 14/2, SwiGLU): Generator, the engines, a 12-row step")
    for name, n in drive_qwen2(torch, mem_rate, op_rate, detail).items():
        launches[name] = launches.get(name, 0) + n

    log(f"[10/18] ({time.perf_counter() - t_start:.1f} s) "
        "generation: generate_scan captured and eager with each sampler (GPT-2-small, Qwen2-0.5B "
        "shape), speculative decoding, sampled serving")
    for name, n in drive_generation(torch, mem_rate, detail).items():
        launches[name] = launches.get(name, 0) + n
    log(f"[11/18] ({time.perf_counter() - t_start:.1f} s) "
        "whisper: Whisper-tiny through Generator(EncDecBackend(device='cuda')), int8 and bf16 KV")
    for name, n in drive_whisper(torch, mem_rate, detail).items():
        launches[name] = launches.get(name, 0) + n
    log(f"[12/18] ({time.perf_counter() - t_start:.1f} s) "
        "encoders and vision: DistilBERT INT8 (f32, bf16), all-MiniLM-L6-v2's widths INT8 (f32, bf16), wav2vec2 "
        "INT8 + CTC, ViT-B/16, MobileNetV2 INT8, ResNet-50 fp32")
    phase12, f32_runs = drive_encoders(torch, detail)
    for name, n in phase12.items():
        launches[name] = launches.get(name, 0) + n
    for name in ("quant_matmul_int8", "flash_attention"):
        launches[f"{name}:f32"] = f32_runs.get(name, 0)
    log(f"[13/18] ({time.perf_counter() - t_start:.1f} s) "
        "the graph runtime: a GPT-2-small graph through GraphBackend(Model(graph)) compiled, "
        "one CUDA graph a bucket")
    for name, n in drive_graph(torch, detail).items():
        launches[name] = launches.get(name, 0) + n
        if name in ("quant_matmul_int8", "flash_attention"):
            launches[f"{name}:f32"] += n  # f32 activations: the matmul's three-pass route
    if launches.get("quantize_rows_int8", 0):
        raise AssertionError(f"quantize_rows_int8 launched {launches['quantize_rows_int8']} times on the main "
                             "paths: quant_matmul_w8a8 quantizes inside its one launch")
    one_launch_w8a8(cases)
    log(f"[14/18] ({time.perf_counter() - t_start:.1f} s) "
        "model files: .rten save / load / mmap, ONNX convert --quantize, the CLI, lifting onto the "
        "dense-weight route (GPT-2-small, Whisper-tiny)")
    for name, n in drive_files(torch, detail).items():
        launches[name] = launches.get(name, 0) + n
        if name in ("quant_matmul_int8", "flash_attention"):
            launches[f"{name}:f32"] += n  # f32 activations: the matmul's three passes, flash's six
    log(f"[15/18] ({time.perf_counter() - t_start:.1f} s) "
        "text in, text out: README tokenizers, gpt2.py (GPT-2-small int8 and its f32 file), bert_qa.py "
        "(BERT-base), the profiler's trace, the native library")
    phase15, f32_text = drive_text(torch, detail)
    for name, n in phase15.items():
        launches[name] = launches.get(name, 0) + n
    for name in ("quant_matmul_int8", "flash_attention"):
        launches[f"{name}:f32"] += f32_text.get(name, 0)  # (c) and (d): the f32 routes
    torch.cuda.empty_cache()
    log(f"[16/18] ({time.perf_counter() - t_start:.1f} s) "
        "parallel: the Qwen2-0.5B shape over 2 ranks (tensor parallelism through tp_decode_step and the "
        "engines, sp_prefill, pp_forward, the overlapped matmuls and ring attention, the supervisor)")
    phase16, tp_cases = drive_parallel(torch, bound, smi, detail)
    one_launch_a_call(tp_cases)
    cases += tp_cases
    for name, n in phase16.items():
        launches[name] = launches.get(name, 0) + n
    log(f"[17/18] ({time.perf_counter() - t_start:.1f} s) "
        "apps: qwen2_chat.py at Qwen2-0.5B's widths, imagenet.py at ResNet-50's, the other apps against their "
        "--cpu runs, every --demo, the C embedding API")
    phase17, f32_apps = drive_apps(torch, detail)
    for name, n in phase17.items():
        launches[name] = launches.get(name, 0) + n
    for name in ("quant_matmul_int8", "flash_attention"):
        launches[f"{name}:f32"] += f32_apps.get(name, 0)  # (c) and the demos: the f32 routes
    missing = [name for name, meta in KERNELS.items() if meta.get("on_path", True) and launches.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    log(f"[18/18] ({time.perf_counter() - t_start:.1f} s) summary")
    entries = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == meta.get("cases_of", name) and meta.get("select", bool)(c)]
        timed = next(c for c in mine if c["shape"].startswith(meta["timed"]))
        entries.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches.get(name, 0), max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=timed["ms"], plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"],
            bound_by=timed["bound_by"], library_ms=timed["library_ms"], shape=timed["shape"],
        ))
    detail["kernels"] = entries
    detail["seconds"] = time.perf_counter() - t_start
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"  total {detail['seconds']:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
