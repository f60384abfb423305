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
    python3 chip_smoke.py --gemv LABEL [--package DIR]
                                     # phases 1-2 and the decode GEMV's, MLP's and fused
                                     # wo's checks at 1 and 8 rows, and decode_block's
                                     # output digest, of this tree's package or DIR's
                                     # (see gemv_only); its last line is marked partial

Phases, each of which raises on failure (the script then exits non-zero):

1. device  — the card's name and power limit from nvidia-smi;
2. build   — nvcc builds the kernels from rten_tpu_torch/kernels/csrc;
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
   which must be one attention launch (two with the fused wo);
4. serve   — full-width GPT-2-small (12 layers, random int8 weights from a
   seed) served through Generator(NativeBackend(..., device="cuda")): a
   64-token prompt as one prefill forward and 512 greedy tokens in a
   768-position cache, with every launch counter read around the run; the
   prefill's time to first token at prompts of 64 and 512; then the first
   32 steps teacher-forced token by token through the kernels (the served
   path), and as one prefill forward through the kernels and through the
   plain versions;
5. serving — the same model behind the continuous-batching engines: 16
   seeded requests (prompts 16-320 tokens, 32-256 new tokens) queued at
   once through ServingEngine (8 slots, 8 forwards a tick; run and
   run_pipelined), PagedServingEngine (pages of 128; a pool that holds them
   all, then one small enough to preempt), both again with int8 KV, and 4
   concurrent POST /generate to a ServingServer on loopback; each stream
   held against its solo Generator(NativeBackend) stream (a difference
   passes only where the solo top-2 logit gap is below 0.05), every page
   back in its pool, each run's launch counters read around it; then ms
   per forward at 8 active rows and the device's idle share per engine;
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
   stream), and one decode step at 12 rows on a bf16 cache (decode_attention
   without its wo) against the plain versions;
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
   emitted token, and Generator.with_draft; phase 5's 16 requests through
   the slot and paged engines with TemperatureSampler(0.8): one seed gives
   the same streams twice, temperature 1e-4 the greedy streams;
11. the line {"kernels": [...]} (the launches summed over phases 4-10, a
   captured graph's launches counted at each replay, the
   split-K and split-KV launches also under their own names;
   matmul_fused, which no model calls, launches in phase 3 only, its
   ragged route also under its own name), the
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
import json
import math
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
    """Route the decoder's seven kernel calls to their plain versions."""
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import quant_matmul as qm

    plain = dict(quant_gemv_int8=qm.quant_gemv_int8_ref, quant_mlp_int8=qm.quant_mlp_int8_ref,
                 quant_matmul_int8=qm.quant_matmul_int8_ref, quant_matmul_w8a8=qm.quant_matmul_w8a8_ref,
                 decode_attention=da.decode_attention_ref, decode_block=da.decode_block_ref,
                 flash_attention=at.flash_attention_ref)
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


def kv_launch_info(torch, fn, entry: str, q, hk: int, cap: int, with_wo: bool = False) -> dict:
    """What a KV kernel case records beside its times: the plan's cluster
    size (``decode_attention.kv_device_plan`` on these operands; None for a
    package without the plan), the wrapper's host µs a call, and the device
    kernels a call launches (profiler over 16 calls; the attention launch,
    with wo also the GEMV: ``expect_launches``). The profiler misses about
    one record in eight of a cluster launch (measured on the H100:
    ``rt::kv_attention_kernel`` at 7 of 8 calls, the GEMV launched beside it
    at 8 of 8), so each kernel's count a call is rounded. A profile that
    recorded no device event at all, while the case's outputs had just
    matched the plain version, is taken again, at most three times; the
    attempts are recorded (``profile_attempts``), and three empty profiles
    read 0 launches a call, which fails ``one_launch_a_call``."""
    from rten_tpu_torch.kernels import decode_attention as da

    plan = getattr(da, "kv_device_plan", None)
    extra = (int(with_wo),) if entry == "rt_decode_attention" else ()
    for attempts in range(1, 4):
        _us, calls = profile_by_kernel(torch, fn, 16)
        if calls:
            break
    return dict(split=plan(entry, q, hk, cap, *extra) if plan is not None else None, host_us=host_us(torch, fn),
                profile_attempts=attempts,
                launches_per_call=sum(round(n) for n in calls.values()), expect_launches=2 if with_wo else 1,
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
    return cases


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


def check_gemv_kernels(torch, bound, cfg, randn, pack, norm_vecs, bf16_err, record):
    """quant_gemv_int8 and quant_mlp_int8 at 1 and 8 rows: GPT-2-small's
    layer-0 qkv + ln1, lm_head logits and lm_head + argmax, its MLP with the
    next layer's qkv and without (the last layer); the Qwen2-0.5B shape's
    qkv + rmsnorm + bias, w_gu + rmsnorm, w_down + residual and lm_head +
    argmax (N 152576, K 896). Each against its plain version, with its
    bound, its plain time, the time of F.linear on the dequantized bf16
    weights (the MLP: none, no single call), its plan and its launches a
    call (one)."""
    from rten_tpu_torch.kernels import quant_matmul as qm

    bf16, f32 = torch.bfloat16, torch.float32
    F = torch.nn.functional
    d, ff = cfg.d_model, cfg.d_ff
    n_vocab_pad = -(-cfg.vocab_size // 1024) * 1024
    qw, qff, q_vocab = QWEN2["d_model"], QWEN2_CFG["d_ff"], QWEN2_CFG["vocab_size"]
    qkv_n = (QWEN2["n_heads"] + 2 * QWEN2["n_kv_heads"]) * (qw // QWEN2["n_heads"])
    shapes = [("qkv+ln1", d, 3 * d, "layernorm", "bias", None),
              ("lm_head_logits", d, n_vocab_pad, "layernorm", "logits", None),
              ("lm_head_argmax", d, n_vocab_pad, "layernorm", "argmax", cfg.vocab_size),
              ("qwen2 qkv+rms", qw, qkv_n, "rmsnorm", "bias", None),
              ("qwen2 w_gu+rms", qw, 2 * qff, "rmsnorm", "", None),
              ("qwen2 w_down+res", qff, qw, None, "residual", None),
              ("qwen2 lm_head_argmax", qw, -(-q_vocab // 1024) * 1024, "rmsnorm", "argmax", q_vocab),
              ("qwen2 lm_head_logits", qw, -(-q_vocab // 1024) * 1024, "rmsnorm", "logits", None)]
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

        # -- quant_mlp_int8: with the next layer's qkv (layers 0-10) and without
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
                d + (3 * d if with_next else 0))
            ops = 2 * m * (2 * d * ff + (3 * d * d if with_next else 0))
            copies = [make(i) for i in range(copies_for(per_call))]
            ms = graph_ms(torch, [lambda a=a, k=k: qm.quant_mlp_int8(*a, **k) for a, k in copies])
            plain = eager_ms(torch, lambda: qm.quant_mlp_int8_ref(*args, **kw))
            phases = ((ff, d, True, 2), (d, ff, False, 4)) + (((3 * d, d, True, 4),) if with_next else ())
            record("quant_mlp_int8", f"{name} M={m} D={d} FF={ff}", err, tol, ms, plain, bound(per_call, ops),
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
BLOCK_SHAPES = {"gpt2": (12, 12), "starcoder": (12, 1)}


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
        h, hk = BLOCK_SHAPES[shape]
        name = "decode_block" if h == hk else "decode_block:gqa"
        nq = (h + 2 * hk) * hd
        for kv_len in (1, 300, 767):
            for with_next in (True, False):
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
                if stamped:
                    extra.update(block_waits(torch, lambda st: da.decode_block_timed(st, *args, **kw),
                                             da.block_grid(0)))
                record(name, f"kv_len={kv_len} {'+next_qkv' if with_next else 'last layer'} S={s_max} "
                       f"Hq={h} Hk={hk} D={d} FF={ff}", *worst, ms, plain, bound(per_call, ops_n), None,
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
KV_ENTRIES = {"decode_attention": "rt_decode_attention", "decode_attention_int8": "rt_decode_attention_int8",
              "paged_decode_attention": "rt_paged_attention",
              "paged_decode_attention_int8": "rt_paged_attention_int8"}  # each KV kernel's C entry point


def check_kv_kernels(torch, bound, cfg, randn, record):
    """The serving path's KV kernels (decode_attention_int8 over an int8
    [B, H, S, D] cache; paged_decode_attention and its int8 twin over pools
    of 128-position pages, each row's 6 pages scattered through the pool) at
    S 768, against their plain versions: the attention vector (tolerance
    from its own max), the caches after the append bit for bit. Timed as
    check_kernels times the others; the bound counts the valid prefix's
    payload and scales, the packed qkv and the output; the library yardstick
    is scaled_dot_product_attention over the same prefix made contiguous
    (bf16; a bf16 dequantized copy for int8), rows masked to their lengths."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    h, hd, s_max, page = cfg.n_heads, cfg.head_dim, CACHE_LEN, 128
    per_row = s_max // page
    F = torch.nn.functional
    kinds = {"decode_attention_int8": (da.decode_attention_int8, da.decode_attention_int8_ref),
             "paged_decode_attention": (pa.paged_decode_attention, pa.paged_decode_attention_ref),
             "paged_decode_attention_int8": (pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_ref)}
    for name, (kernel, plain) in kinds.items():
        int8, paged = name.endswith("int8"), name.startswith("paged")
        for case, lens_list in KV_LENS.items():
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
            record(name, f"{case} S={s_max} H={h} D={hd}" + (f" page={page}" if paged else ""), err, tol, ms,
                   plain_ms, bound(per_call, ops), library,
                   **kv_launch_info(torch, lambda: kernel(*k_args), KV_ENTRIES[name], args[0][:, 0, :, 0], h, s_max))
            del copies, lib_in


QWEN2 = dict(n_heads=14, n_kv_heads=2, d_model=896)  # Qwen2-0.5B's attention (its config.json)


def check_gqa_kernels(torch, bound, randn, pack, record):
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
    masked to their lengths, without wo."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6161)
    hq, hk, dm = QWEN2["n_heads"], QWEN2["n_kv_heads"], QWEN2["d_model"]
    hd, s_max, page = dm // hq, CACHE_LEN, 128
    per_row = s_max // page
    F = torch.nn.functional
    kinds = {"decode_attention:gqa": (da.decode_attention, da.decode_attention_ref),
             "decode_attention:no_wo": (da.decode_attention, da.decode_attention_ref),
             "decode_attention_int8:gqa": (da.decode_attention_int8, da.decode_attention_int8_ref),
             "paged_decode_attention:gqa": (pa.paged_decode_attention, pa.paged_decode_attention_ref),
             "paged_decode_attention_int8:gqa": (pa.paged_decode_attention_int8,
                                                 pa.paged_decode_attention_int8_ref)}
    for name, (kernel, plain) in kinds.items():
        int8, paged, with_wo = "int8" in name, name.startswith("paged"), name == "decode_attention:gqa"
        for case, lens_list in KV_LENS.items():
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
            record(name, f"{case} S={s_max} Hq={hq} Hk={hk} D={hd}" + (f" page={page}" if paged else ""), err, tol,
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


def check_prefill_kernels(torch, bound, cfg, randn, pack, bf16_err, record):
    """quant_matmul_int8 and flash_attention against their plain versions at
    the prefill paths' shapes (GPT-2-small's and the Qwen2-0.5B shape's),
    timed as check_kernels times the others, with each call's launch plan
    (split-K or split-KV cluster size) and the wrapper's host µs a call."""
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
    qh, qk = QWEN2["n_heads"], QWEN2["n_kv_heads"]
    fa_cases = [  # name, b, hq, hk, tq, s, causal, q_offset, kv_len
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
    ]
    for name, b, hq, hk, tq, s, causal, q_off, kv_len in fa_cases:
        def make(i, b=b, hq=hq, hk=hk, tq=tq, s=s, causal=causal, q_off=q_off, kv_len=kv_len):
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
               host_us=host_us(torch, lambda: at.flash_attention(*args, **kw)))
        del copies, lib_in


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


def drive_serve(torch, cfg, params, mem_rate, op_rate, out, key="", required=None, n_new=None, cache_len=None):
    """Phase 4 (and, with cfg.w8a8, key "w8a8_" and the W8A8 kernels
    required, phase 6's first part; phases 8's and 9's first parts at
    ``n_new`` tokens in a ``cache_len`` cache): the main path through Generator, time to
    first token, the device time per decode step, and the teacher-forced
    checks. Returns the main path's launches and the teacher-forced
    sequence with its logits."""
    n_new = n_new or N_NEW
    cache_len = cache_len or CACHE_LEN
    from rten_tpu_torch.generate import Generator, GeneratorConfig, Metrics, NativeBackend
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.models import decoder

    prompt_gen = torch.Generator().manual_seed(0)
    prompts = {n: torch.randint(0, cfg.vocab_size, (1, n), generator=prompt_gen).to(torch.int32).numpy()
               for n in sorted({N_PROMPT, *TTFT_PROMPTS})}
    prompt = prompts[N_PROMPT]

    def serve(n_new, metrics=None):
        gen = Generator(NativeBackend(params, cfg, max_len=cache_len, device="cuda"),
                        GeneratorConfig(max_tokens=n_new)).with_prompt(prompt)
        if metrics is not None:
            gen.profile(metrics)
        return [int(t[0]) for t in gen]

    serve(8)  # warm-up: allocator and library load, outside the counted run

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
        plain_calls=plain, served_head=tokens[:16],
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

N_REQUESTS, PROMPT_RANGE, NEW_RANGE, SERVE_PAGE, GAP_TOL = 16, (16, 320), (32, 256), 128, 0.05
ENGINE_KERNELS = {  # the kernels each engine run must launch (the prefill ones with them)
    "slot": ("quant_gemv_int8", "quant_mlp_int8", "decode_attention", "quant_matmul_int8", "flash_attention"),
    "paged": ("quant_gemv_int8", "quant_mlp_int8", "paged_decode_attention", "quant_matmul_int8",
              "flash_attention"),
    "slot_int8": ("quant_gemv_int8", "quant_mlp_int8", "decode_attention_int8", "quant_matmul_int8",
                  "flash_attention"),
    "paged_int8": ("quant_gemv_int8", "quant_mlp_int8", "paged_decode_attention_int8", "quant_matmul_int8",
                   "flash_attention"),
}


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
    each step's top-2 logit gap."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend

    streams, gaps = [], []
    for s in specs:
        sampler = GapArgMax()
        gen = Generator(NativeBackend(params, cfg, max_len=len(s["prompt"]) + s["max_new_tokens"], device=dev),
                        GeneratorConfig(max_tokens=s["max_new_tokens"])).with_prompt(s["prompt"])
        streams.append([int(t[0]) for t in gen.with_sampler(sampler)])
        gaps.append(sampler.gaps)
    return streams, gaps


def at_8_rows(torch, kind, make, specs):
    """ms per engine forward with 8 active rows (host clock) and the
    device's time by kernel and idle share (profiler) over the same window:
    the first 8 requests' prompts cut to 64 tokens, 256 new tokens each."""
    from rten_tpu_torch.serve import Request

    engine = make()
    for s in specs[:8]:
        engine.submit(Request(prompt=s["prompt"][:64], max_new_tokens=256))
    forwards_per_step = engine.steps_per_tick if kind.startswith("slot") else 1
    n_steps = max(2, 64 // forwards_per_step)  # 64 forwards timed, 64 profiled (of 256)
    for _ in range(max(1, n_steps // 4)):  # admission, then the first steps at 8 rows
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / (n_steps * forwards_per_step)
    if engine.n_active != 8:
        raise AssertionError(f"{kind}: {engine.n_active} rows active in the timed window, not 8")
    by_kernel = device_us_by_kernel(torch, engine.step, n_steps)
    dev_ms = sum(by_kernel.values()) / 1e3 / forwards_per_step
    log(f"  {kind} at 8 active rows: {host_ms:.4f} ms per forward (host clock) -> {8e3 / host_ms:.1f} tokens/s; "
        f"device {dev_ms:.4f} ms (profiler) -> idle share {max(0.0, 1.0 - dev_ms / host_ms):.4f}; top kernels (us):")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {us / forwards_per_step:9.3f}  {name[:90]}")
    del engine
    torch.cuda.empty_cache()
    return dict(ms_per_forward=host_ms, device_ms_per_forward=dev_ms, idle_share=max(0.0, 1.0 - dev_ms / host_ms),
                tokens_per_s=8e3 / host_ms,
                device_us_by_kernel={k: v / forwards_per_step for k, v in by_kernel.items()})


def drive_serving(torch, cfg, params, out):
    """16 seeded requests, all queued at once, through the slot engine
    (run and run_pipelined), the paged engine (a pool that holds them all,
    then one small enough to preempt), both again with int8_kv, and four
    concurrent POST /generate to a ServingServer on loopback. Each stream is
    held against its solo Generator(NativeBackend) stream; every run's
    launch counters are read around it."""
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
    refs = {"slot": solo["bf16"], "slot_int8": solo["int8"]}
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
        step_stats[kind] = at_8_rows(torch, kind, make, specs)

    for res in results.values():
        del res["streams"]
    out["serving"] = dict(requests=[dict(prompt_len=len(s["prompt"]), max_new_tokens=s["max_new_tokens"])
                                    for s in specs], runs=results, differing=diffs, at_8_rows=step_stats,
                          http=dict(health=health, stats=stats))
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
    at_8 = at_8_rows(torch, "slot_w8a8", lambda: ServingEngine(params, cfg8, max_batch=8, steps_per_tick=8,
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


def qwen2_params(torch, cfg):
    """Random int8 params of the Qwen2-0.5B shape from seed 0: the port's
    ``init_params`` (tied), seeded q/k/v biases, and the tied head as
    ``from_hf_llama`` writes it (an ``lm_head`` copy of the embedding), then
    ``quantize_params_int8`` (``w_gu`` fuses: 2 x 4864 is a multiple of 128,
    its N 9728 pads to 10240; the lm_head's N 151936 to 152576)."""
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
                                    n_new=N_QWEN2_NEW, cache_len=QWEN2_CACHE)
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

    def run():
        cache_t = decoder.init_cache(cfg, 1, max_len, device="cuda")
        cache_d = decoder.init_cache(dcfg, 1, max_len, device="cuda")
        logits, cache_t = decoder.prefill(params, cfg, ids, cache_t, last_only=True)
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
    out["generation"] = dict(gpt2_scan=scan, qwen2_scan=qwen2, speculative=spec, serving=serving)
    del params
    torch.cuda.empty_cache()
    return launches


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


def kv_only(torch, bound, cfg, detail, kind, smi, label: str) -> int:
    """``--kv LABEL``: the four KV kernels in every mode and decode_block at
    the shapes phase 3 times them (check_decode_attention, check_kv_kernels,
    check_gqa_kernels, check_decode_block, check_decode_attention_b8), each
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
    parser.add_argument("--package", metavar="DIR",
                        help="with --prefill, --kv or --gemv: import rten_tpu_torch from DIR")
    opts = parser.parse_args()
    if opts.package and not (opts.kv or opts.gemv or opts.prefill is not None):
        parser.error("--package times another package's kernels: it needs --prefill, --kv or --gemv")
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

    log("[1/11] device")
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

    log("[2/11] build")
    t0 = time.perf_counter()
    _build.library()
    built = _build.BUILD_SECONDS
    log(f"  kernels {'built' if built is not None else 'loaded'} in {time.perf_counter() - t0:.2f} s "
        f"({_build.source_hash()})")
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
    log("[3/11] kernels against their plain versions (GPT-2-small shapes, bf16)")
    cases = check_kernels(torch, bound, cfg)
    one_launch_a_call(cases)
    detail["cases"] = cases

    t0 = time.perf_counter()
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"  params: GPT-2-small int8, seed 0, {time.perf_counter() - t0:.1f} s to make and quantize")
    log("[4/11] GPT-2-small prefill and decode through Generator(NativeBackend(device='cuda'))")
    launches, forced = drive_serve(torch, cfg, params, mem_rate, op_rate, detail)

    log("[5/11] continuous-batching serving: slot and paged engines, int8 KV, HTTP (GPT-2-small)")
    for name, n in drive_serving(torch, cfg, params, detail).items():
        launches[name] = launches.get(name, 0) + n

    log("[6/11] W8A8: GPT-2-small through Generator and the slot engine, the accuracy gate")
    for name, n in drive_w8a8(torch, cfg, params, mem_rate, int8_rate, detail).items():
        launches[name] = launches.get(name, 0) + n
    log("[7/11] mega: GPT-2-small with DecoderConfig(mega=True), the whole block in one kernel a layer")
    for name, n in drive_mega(torch, cfg, params, mem_rate, op_rate, detail, forced).items():
        launches[name] = launches.get(name, 0) + n
    del params
    torch.cuda.empty_cache()
    log("[8/11] tiny_starcoder_py shape (MQA 12/1): Generator two-kernel and mega, the mega gate")
    for name, n in drive_starcoder(torch, mem_rate, op_rate, detail).items():
        launches[name] = launches.get(name, 0) + n
    log("[9/11] Qwen2-0.5B shape (RoPE, GQA 14/2, SwiGLU): Generator, the engines, a 12-row step")
    for name, n in drive_qwen2(torch, mem_rate, op_rate, detail).items():
        launches[name] = launches.get(name, 0) + n

    log("[10/11] generation: generate_scan captured and eager with each sampler (GPT-2-small, Qwen2-0.5B "
        "shape), speculative decoding, sampled serving")
    for name, n in drive_generation(torch, mem_rate, detail).items():
        launches[name] = launches.get(name, 0) + n
    missing = [name for name, meta in KERNELS.items() if meta.get("on_path", True) and launches.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    if launches.get("quantize_rows_int8", 0):
        raise AssertionError(f"quantize_rows_int8 launched {launches['quantize_rows_int8']} times on the main "
                             "paths: quant_matmul_w8a8 quantizes inside its one launch")
    one_launch_w8a8(cases)
    log("[11/11] summary")
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
