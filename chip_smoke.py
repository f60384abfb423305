#!/usr/bin/env python3
"""Build, check and drive rten_tpu_torch (the PyTorch / CUDA port) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device  — the card's name and power limit from nvidia-smi;
2. build   — nvcc builds the kernels from rten_tpu_torch/kernels/csrc;
3. kernels — each decode kernel at GPT-2-small's shapes (bf16 activations,
   int8 weights) against its plain PyTorch version on the same inputs, with
   its device time, its plain version's time, the least time the card could
   take for the same work, and one PyTorch library call as a yardstick;
4. decode  — full-width GPT-2-small (12 layers, random int8 weights from a
   seed) served through Generator(NativeBackend(..., device="cuda")): a
   64-token prompt and 512 greedy tokens in a 768-position cache, with every
   launch counter read around the run; then the first 32 steps
   teacher-forced through the kernels and through the plain versions;
5. the line {"kernels": [...]}, the nvidia-smi line, and last the line
   {"ok": true, "device": {...}}.

Details (every case, the compiler's register report) go to
chiprun_out/chip_smoke.json and chiprun_out/build_log.txt.

Times: a kernel's and the library call's are device times from CUDA events
around replays of a CUDA graph that calls them on enough copies of their
inputs to exceed the 50 MB L2 (each call finds its weights cold, as in the
decode loop); the plain version's is eager (host time included).
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

# Data-sheet rates by card (NVIDIA): memory bytes/s and dense bf16 tensor-core
# FLOP/s. The kernels' operands are bf16 activations against int8 weights
# (exact in bf16), so bf16 is the type whose peak bounds their operations.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H200", 4.8e12, 989e12),
    ("H100", 3.35e12, 989e12),  # SXM (HBM3)
)

N_PROMPT, N_NEW, CACHE_LEN, N_FORCED = 64, 512, 768, 32


def log(*args):
    print(*args, flush=True)


def card_rates(name: str):
    for key, mem, f32 in CARD_RATES:
        if key in name:
            return key, mem, f32
    raise RuntimeError(f"no data-sheet rates for card {name!r}")


class Bound:
    """Least time for a call: max(bytes / memory rate, ops / bf16 rate)."""

    def __init__(self, mem_rate: float, op_rate: float):
        self.mem_rate, self.op_rate = mem_rate, op_rate

    def __call__(self, nbytes: float, ops: float):
        t_mem, t_ops = nbytes / self.mem_rate * 1e3, ops / self.op_rate * 1e3
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
def plain_decoder(decoder, qm, da):
    """Route the decoder's three kernel calls to their plain versions."""
    saved = (decoder.quant_gemv_int8, decoder.quant_mlp_int8, decoder.decode_attention)
    decoder.quant_gemv_int8 = qm.quant_gemv_int8_ref
    decoder.quant_mlp_int8 = qm.quant_mlp_int8_ref
    decoder.decode_attention = da.decode_attention_ref
    try:
        yield
    finally:
        decoder.quant_gemv_int8, decoder.quant_mlp_int8, decoder.decode_attention = saved


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernels(torch, bound, cfg):
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import quant_matmul as qm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    d, ff, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    n_vocab_pad = -(-cfg.vocab_size // 1024) * 1024
    F = torch.nn.functional

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

    def record(kernel, shape, err, tol, ms, plain, bnd, library=None, note=""):
        if not (err <= tol):
            raise AssertionError(f"{kernel} {shape}: max |kernel - plain| {err:.3g} > {tol:.3g}")
        t_bound, by = bnd
        case = dict(kernel=kernel, shape=shape, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                    bound_ms=t_bound, bound_by=by, library_ms=library)
        cases.append(case)
        lib = f"{library:.4f}" if library is not None else "null"
        log(f"  {kernel:17s} {shape:28s} err {err:.3g} (tol {tol:.3g})  kernel {ms:.4f} ms  "
            f"plain {plain:.4f} ms  bound {t_bound:.4f} ms ({by})  library {lib} ms {note}")

    # -- quant_gemv_int8: layer-0 qkv, lm_head logits, lm_head argmax -------
    for name, n, mode in (("qkv", 3 * d, "qkv"), ("lm_head_logits", n_vocab_pad, "logits"),
                          ("lm_head_argmax", n_vocab_pad, "argmax")):
        def make(i, n=n, mode=mode):
            qt, s = pack(n, d)
            ns, nb = norm_vecs(d)
            bias = 0.1 * randn(n, dtype=torch.float32) if mode == "qkv" else None
            kw = dict(norm="layernorm", norm_scale=ns, norm_bias=nb)
            if mode == "argmax":
                kw["argmax_n"] = cfg.vocab_size
            if mode == "logits":
                kw["out_dtype"] = torch.float32
            return (randn(1, d), qt, s, bias), kw

        args, kw = make(0)
        out = qm.quant_gemv_int8(*args, **kw)
        torch.cuda.synchronize()
        if mode == "argmax":
            kw_logits = {k: v for k, v in kw.items() if k != "argmax_n"}
            logits = qm.quant_gemv_int8_ref(*args, out_dtype=torch.float32, **kw_logits)[0]
            valid = logits[: cfg.vocab_size]
            top = valid.max().item()
            ref = qm.quant_gemv_int8_ref(*args, **kw)
            # Kernel and plain sum in other orders: a different token is
            # right only when its plain logit ties the maximum to f32 order.
            err = top - valid[int(out[0])].item()
            tol = 1e-5 * max(1.0, abs(top))
            note = f"(token {int(out[0])}, plain {int(ref[0])})"
        else:
            ref = qm.quant_gemv_int8_ref(*args, **kw)
            if mode == "qkv":
                err, tol = bf16_err(out, ref)
            else:  # f32 logits: a flipped bf16 rounding of one normalised input element
                err, tol = (out - ref).abs().max().item(), 2e-3 * max(1.0, ref.abs().max().item())
            note = ""
        x, qt, s, bias = args
        per_call = nbytes(x, qt, s, bias, kw["norm_scale"], kw["norm_bias"]) + (
            4 if mode == "argmax" else n * (4 if mode == "logits" else 2))
        copies = [make(i) for i in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda a=a, k=k: qm.quant_gemv_int8(*a, **k) for a, k in copies])
        plain = eager_ms(torch, lambda: qm.quant_gemv_int8_ref(*args, **kw))
        w_deq = [(c[0][1].float() * c[0][2][:, None]).to(bf16) for c in copies[:copies_for(2 * n * d)]]
        library = graph_ms(torch, [lambda w=w: F.linear(x, w) for w in w_deq])
        record("quant_gemv_int8", f"{name} N={n} K={d}", err, tol, ms, plain,
               bound(per_call, 2 * n * d), library, note)
        del copies, w_deq

    # -- quant_mlp_int8: with the next layer's qkv (layers 0-10) and without -
    for name, with_next in (("mlp+next_qkv", True), ("mlp (last layer)", False)):
        def make(i, with_next=with_next):
            wu, su = pack(ff, d)
            wd, sd = pack(d, ff)
            ns, nb = norm_vecs(d)
            nxt = None
            if with_next:
                wq, sq = pack(3 * d, d)
                qns, qnb = norm_vecs(d)
                nxt = (wq, sq, 0.1 * randn(3 * d, dtype=torch.float32), qns, qnb)
            args = (randn(1, d), wu, su, wd, sd, 0.1 * randn(ff, dtype=torch.float32),
                    0.1 * randn(d, dtype=torch.float32))
            kw = dict(activation="gelu", norm="layernorm", norm_scale=ns, norm_bias=nb,
                      residual=randn(1, d), next_qkv=nxt)
            return args, kw

        args, kw = make(0)
        out, ref = qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw)
        torch.cuda.synchronize()
        outs, refs = (out, ref) if with_next else ((out,), (ref,))
        errs = [bf16_err(o, r) for o, r in zip(outs, refs)]
        err = max(e for e, _ in errs)
        tol = min(t for _, t in errs)
        nxt = kw["next_qkv"] or ()
        per_call = nbytes(*args, kw["norm_scale"], kw["norm_bias"], kw["residual"], *nxt) + 2 * (
            d + (3 * d if with_next else 0))
        ops = 2 * (2 * d * ff + (3 * d * d if with_next else 0))
        copies = [make(i) for i in range(copies_for(per_call))]
        ms = graph_ms(torch, [lambda a=a, k=k: qm.quant_mlp_int8(*a, **k) for a, k in copies])
        plain = eager_ms(torch, lambda: qm.quant_mlp_int8_ref(*args, **kw))
        record("quant_mlp_int8", f"{name} D={d} FF={ff}", err, tol, ms, plain, bound(per_call, ops))
        del copies

    # -- decode_attention: packed qkv, append at kv_len, fused wo -----------
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
               bound(per_call, ops), library, note)
        del copies, lib_inputs, caches
    torch.cuda.empty_cache()
    return cases


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
    return node.numel() * node.element_size()


def drive_decode(torch, cfg, mem_rate, out):
    from rten_tpu_torch.generate import Generator, GeneratorConfig, Metrics, NativeBackend
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import dispatch
    from rten_tpu_torch.kernels import quant_matmul as qm
    from rten_tpu_torch.models import decoder

    t0 = time.perf_counter()
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"  params: GPT-2-small int8, seed 0, {time.perf_counter() - t0:.1f} s to make and quantize")
    prompt = torch.randint(0, cfg.vocab_size, (1, N_PROMPT), generator=torch.Generator().manual_seed(0))
    prompt = prompt.to(torch.int32).numpy()

    def serve(n_new, metrics=None):
        gen = Generator(NativeBackend(params, cfg, max_len=CACHE_LEN, device="cuda"),
                        GeneratorConfig(max_tokens=n_new)).with_prompt(prompt)
        if metrics is not None:
            gen.profile(metrics)
        return [int(t[0]) for t in gen]

    serve(8)  # warm-up: allocator and library load, outside the counted run

    dispatch.reset_counters()
    metrics = Metrics()
    t0 = time.perf_counter()
    tokens = serve(N_NEW, metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    forwards = N_PROMPT + N_NEW - 1
    log(f"  served {len(tokens)} tokens after a {N_PROMPT}-token prompt in {wall:.3f} s; "
        f"launches {launches}; plain {plain or '{}'}")
    for name in ("quant_gemv_int8", "quant_mlp_int8", "decode_attention"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    if len(tokens) != N_NEW or not all(0 <= t < cfg.vocab_size for t in tokens):
        raise AssertionError("the served stream has the wrong length or out-of-vocabulary ids")

    step_ms = metrics.mean_step_ms()
    weight = stream_bytes(params)
    avg_prefix = N_PROMPT + (N_NEW - 1) / 2
    kv = 2 * cfg.n_layers * cfg.n_heads * avg_prefix * cfg.head_dim * 2
    bound_ms = (weight + kv) / mem_rate * 1e3
    log(f"  decode: {metrics.tokens_per_second():.1f} tokens/s, {step_ms:.4f} ms/step (host clock, "
        f"steady steps); bound {bound_ms:.4f} ms/step ({weight} weight + {kv:.0f} KV bytes) -> "
        f"{bound_ms / step_ms:.4f} of the memory-rate bound")
    per_step = {k: v / forwards for k, v in launches.items()}

    # Device time per decode step (profiler) against the host step time.
    cache = decoder.init_cache(cfg, 1, CACHE_LEN, device="cuda")
    ids = torch.from_numpy(prompt).cuda()
    _, cache = decoder.prefill(params, cfg, ids, cache, lm_head_mode="argmax", last_only=True)
    last = torch.tensor([[tokens[0]]], dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    n_prof = 32
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decoder.generate_greedy(params, cfg, cache, last, n_prof)
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.key_averages():  # device-side events: kernels, copies, fills
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
            name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / n_prof
    dev_us = sum(by_kernel.values())
    device_ms = dev_us / 1e3 if dev_us > 0 else None
    if device_ms is None:
        log("  device busy time: not measured (the profiler reported no device time)")
        idle = None
    else:
        idle = max(0.0, 1.0 - device_ms / step_ms)
        log(f"  device time {device_ms:.4f} ms/step (profiler, {n_prof} greedy steps) -> idle share "
            f"{idle:.4f} of the {step_ms:.4f} ms host step; by kernel (us/step):")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
            log(f"    {us:9.3f}  {name[:90]}")

    # Teacher-forced: the prompt plus the first N_FORCED served tokens, through
    # the kernels and through the plain versions, logits at each position.
    seq = torch.tensor([list(prompt[0]) + tokens[: N_FORCED - 1]], dtype=torch.int32, device="cuda")

    def forced_logits():
        c = decoder.init_cache(cfg, 1, CACHE_LEN, device="cuda")
        lg, _ = decoder.prefill(params, cfg, seq, c)
        return lg[0, N_PROMPT - 1:]  # logits that chose served tokens 0..N_FORCED-1

    k_logits = forced_logits()
    with plain_decoder(decoder, qm, da):
        p_logits = forced_logits()
    torch.cuda.synchronize()
    served = torch.tensor(tokens[:N_FORCED], device="cuda")
    if not torch.equal(k_logits.argmax(-1).to(torch.int64), served.to(torch.int64)):
        raise AssertionError("fused argmax stream differs from the argmax of the kernel logits")
    gap_tol = 0.05  # bf16 activations through 12 layers, rounded at other sums
    p_top = p_logits.max(-1).values
    p_at = p_logits.gather(1, served[:, None].to(torch.int64))[:, 0]
    gaps = (p_top - p_at)
    agree = int((gaps == 0).sum())
    if bool((gaps > gap_tol).any()):
        raise AssertionError(f"served token loses to the plain path's argmax by > {gap_tol}: {gaps.tolist()}")
    logit_err = (k_logits - p_logits).abs().max().item()
    log(f"  teacher-forced {N_FORCED} steps: plain argmax agrees at {agree}/{N_FORCED}, worst plain "
        f"gap to the served token {gaps.max().item():.4g} (tol {gap_tol}); max |logit kernel - plain| "
        f"{logit_err:.4g}")
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("non-finite logits")
    out.update(decode=dict(
        tokens_per_s=metrics.tokens_per_second(), ms_per_step=step_ms, bound_ms_per_step=bound_ms,
        bound_share=bound_ms / step_ms, weight_bytes=weight, kv_bytes=kv, device_ms_per_step=device_ms,
        idle_share=idle, device_us_by_kernel=by_kernel, launches=launches, launches_per_forward=per_step, forwards=forwards,
        plain_calls=plain, forced_agree=agree, forced_max_gap=gaps.max().item(),
        forced_logit_err=logit_err, served_head=tokens[:16],
    ))
    return launches


KERNELS = {
    "quant_gemv_int8": dict(source="rten_tpu_torch/kernels/csrc/quant_gemv.cu",
                            replaces="rten_tpu/kernels/quant_matmul.py:339", timed="lm_head_argmax"),
    "quant_mlp_int8": dict(source="rten_tpu_torch/kernels/csrc/quant_mlp.cu",
                           replaces="rten_tpu/kernels/quant_matmul.py:935", timed="mlp+next_qkv"),
    "decode_attention": dict(source="rten_tpu_torch/kernels/csrc/decode_attention.cu",
                             replaces="rten_tpu/kernels/decode_attention.py:734", timed="kv_len=300"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "rten_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: rten_tpu_torch is not beside {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rten_tpu_torch.kernels import _build
    from rten_tpu_torch.models import decoder

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32 products
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    log("[1/5] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card, mem_rate, op_rate = card_rates(kind)
    log(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"rates used: {mem_rate / 1e12} TB/s, {op_rate / 1e12} TFLOP/s bf16 ({card} data sheet)")
    bound = Bound(mem_rate, op_rate)
    detail = dict(device=dict(kind=kind, nvidia_smi=smi, mem_rate=mem_rate, bf16_rate=op_rate))

    log("[2/5] build")
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
    log("[3/5] kernels against their plain versions (GPT-2-small shapes, bf16)")
    cases = check_kernels(torch, bound, cfg)
    detail["cases"] = cases

    log("[4/5] GPT-2-small decode through Generator(NativeBackend(device='cuda'))")
    launches = drive_decode(torch, cfg, mem_rate, detail)

    log("[5/5] summary")
    entries = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
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
