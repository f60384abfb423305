"""Speculative decoding: a small draft model proposes K tokens a round, the
target verifies them in one (K+1)-token forward.

Counterpart of ``rten_tpu/generate/speculative.py`` (``speculative_scan``
:42, ``speculative_sample_scan`` :132, ``speculative_sample_generate``
:242, ``_unpack_rounds`` :296, ``speculative_generate`` :315). A round is
K one-token draft forwards, one fill forward that appends the last draft's
k/v, then the target's verify forward of ``[last, d_1..d_K]`` (the decode
GEMVs at 8 rows or fewer, ``flash_attention`` at each row's own offset).
Greedy acceptance is token-exact against plain greedy decoding of the
target; temperature acceptance (accept d with probability min(1, p/q),
resample the first rejection from max(p - q, 0)) gives every emitted
token the target's own temperature marginal.

Rejecting draft tokens is writing a smaller ``cache["len"]`` (in place, on
the device): the stale entries past it are never read and the next round
overwrites them. The host mirror ``cache["host_len"]`` must never be below
the device length: each forward adds its full token count to it, a round
clamps it at the same limit the device clamps at, and after the rounds it
is set equal again from their counts, which reach the host with the tokens
in one copy.

On the card a call's ``n_rounds`` rounds, each with its K draft forwards,
its fill forward and its verify, are one replay of a CUDA graph captured
once for the params, configs, batch, K, ``n_rounds``, the sampler and the
two caches (the JAX package's nested ``lax.scan``s); the verify forward's
attention then reads the cache's whole S (``decoder._attention``), bounded
by each row's device length. On the CPU, and where the installed torch
cannot advance a sampled graph's generator, the rounds run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from rten_tpu_torch.generate.sampler import TemperatureSampler, gumbel
from rten_tpu_torch.models import decoder

_EPS = 1e-20


def _limit(cache: dict, k: int) -> int:
    """The length a row saturates at: a row the host stopped reading keeps
    running, and its appends must stay inside the cache (a row still read
    never gets there: its cache holds prompt + max_new + k + 2)."""
    return cache["k"][0].shape[2] - (k + 2)


def _clamp_host(caches, limit: int) -> None:
    for cache in caches:
        np.minimum(cache["host_len"], limit, out=cache["host_len"])


def _finish(caches, len0: np.ndarray, toks, counts, limit: int):
    """One copy of the rounds' tokens [R, B, K+1] and counts [R, B] to the
    host, and each cache's ``host_len`` set to the device lengths they
    imply (each round's ``min(len + count, limit)`` from the lengths at
    the start)."""
    both = torch.cat([toks, counts[..., None]], dim=-1).cpu().numpy()
    toks_np, counts_np = both[..., :-1], both[..., -1]
    lens = len0.copy()
    for c in counts_np:
        lens = np.minimum(lens + c, limit)
    for cache in caches:
        cache["host_len"][:] = lens
    return toks_np, counts_np


def _run_rounds(rounds, key: tuple, cache_t, cache_d, last, rng, n_rounds: int, keep):
    """``rounds(cache_t, cache_d, last, rng, n)`` (the device tensors: tokens
    [n, B, K+1], counts [n, B], the next last tokens [B, 1]) of
    ``n_rounds`` rounds: on the card (``decoder._capturable``; sampled
    rounds need a torch that advances a graph's generator) one replay of a
    graph of all of them, captured once for ``key``, the generator and the
    two caches (the JAX package's nested ``lax.scan``s), else eagerly."""
    if not decoder._capturable(last.device, rng is not None):
        return rounds(cache_t, cache_d, last, rng, n_rounds)

    def capture_fn():
        def warm():
            warm_rng = None if rng is None else torch.Generator(device=last.device).manual_seed(0)
            rounds(decoder.scratch_like(cache_t), decoder.scratch_like(cache_d), last.clone(), warm_rng, 1)

        return decoder.capture(lambda tok: rounds(cache_t, cache_d, tok, rng, n_rounds), (last,), warm, rng=rng,
                               states=(cache_t, cache_d), keep=(*keep, rng))

    entry = decoder.graph_for(cache_t["len"], (*key, n_rounds, id(rng)),
                              decoder.state_tensors(cache_t) + decoder.state_tensors(cache_d), capture_fn)
    return tuple(t.clone() for t in entry.replay(last))


def speculative_scan(params_t, cfg_t, cache_t, params_d, cfg_d, cache_d, last_tokens, *, k: int, n_rounds: int):
    """``n_rounds`` greedy speculative rounds. Both caches hold the same
    prefix (the same ``len``) for the tokens consumed so far; ``last_tokens``
    [B, 1] int32 is emitted but not consumed.

    Returns (tokens [R, B, K+1], counts [R, B], cache_t, cache_d,
    last_tokens [B, 1]); tokens and counts are numpy arrays on the host:
    per round and row the first ``counts[r, b]`` (1 to K+1) tokens are
    emitted. The caches advance in place. On the card the rounds are one
    replay of a captured graph (``_run_rounds``)."""
    limit = _limit(cache_t, k)
    len0 = cache_t["host_len"].copy()

    def rounds(cache_t, cache_d, last, rng, n_rounds):
        toks, counts = [], []
        for _ in range(n_rounds):
            start = cache_t["len"].clone()
            drafts, tok = [], last
            for _ in range(k):
                tok, cache_d = decoder.forward(params_d, cfg_d, tok, cache_d, lm_head_mode="argmax")
                drafts.append(tok)
            d = torch.cat(drafts, dim=1)  # [B, K]
            _, cache_d = decoder.forward(params_d, cfg_d, d[:, -1:], cache_d, lm_head_mode="argmax")  # the fill step
            logits, cache_t = decoder.forward(params_t, cfg_t, torch.cat([last, d], dim=1), cache_t)
            t = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, K+1]
            n_acc = torch.cumprod((d == t[:, :k]).to(torch.int32), dim=1).sum(dim=1)  # [B]
            m = (n_acc + 1).to(torch.int32)
            new_len = torch.clamp(start + m, max=limit)
            cache_t["len"].copy_(new_len)
            cache_d["len"].copy_(new_len)
            _clamp_host((cache_t, cache_d), limit)
            last = torch.gather(t, 1, n_acc[:, None].long())  # t_{n_acc}
            toks.append(t)
            counts.append(m)
        return torch.stack(toks), torch.stack(counts), last

    key = ("greedy", id(params_t), cfg_t, id(params_d), cfg_d, k)
    toks, counts, last = _run_rounds(rounds, key, cache_t, cache_d, last_tokens, None, n_rounds,
                                     (params_t, params_d))
    toks_np, counts_np = _finish((cache_t, cache_d), len0, toks, counts, limit)
    return toks_np, counts_np, cache_t, cache_d, last


def speculative_sample_scan(params_t, cfg_t, cache_t, params_d, cfg_d, cache_d, last_tokens, rng: torch.Generator,
                            temperature: float, *, k: int, n_rounds: int):
    """``n_rounds`` rounds of speculative sampling at ``temperature``: the
    drafts are sampled from the draft's distribution q, each accepted with
    probability min(1, p/q) against the target's p, the first rejection
    resampled from ``normalize(max(p - q, 0))``; a round that accepts all K
    adds a token sampled from p_K. The draws come from ``rng`` (a
    ``torch.Generator`` on the caches' device): per draft step Gumbel noise
    [B, V], then the acceptance uniforms [B, K], then the resample's noise
    [B, V].

    Returns (tokens [R, B, K+1], counts [R, B], cache_t, cache_d,
    last_tokens [B, 1]), tokens and counts on the host as in
    ``speculative_scan``; on the card one replay, as there, with ``rng``
    registered with the graph."""
    limit = _limit(cache_t, k)
    len0 = cache_t["host_len"].copy()
    dev = last_tokens.device

    def rounds(cache_t, cache_d, last, rng, n_rounds):
        inv_t = 1.0 / torch.clamp(torch.full((), temperature, dtype=torch.float32, device=dev), min=1e-6)
        toks, counts = [], []
        for _ in range(n_rounds):
            start = cache_t["len"].clone()
            drafts, q_logits, tok = [], [], last
            for _ in range(k):
                logits, cache_d = decoder.forward(params_d, cfg_d, tok, cache_d)
                lg = logits[:, -1].float() * inv_t  # [B, V]
                tok = torch.argmax(lg + gumbel(rng, lg.shape, dev), dim=-1, keepdim=True).to(torch.int32)
                drafts.append(tok)
                q_logits.append(lg)
            d = torch.cat(drafts, dim=1)  # [B, K]
            q = torch.softmax(torch.stack(q_logits, dim=1), dim=-1)  # [B, K, V]
            _, cache_d = decoder.forward(params_d, cfg_d, d[:, -1:], cache_d, lm_head_mode="argmax")  # the fill step

            # p_j is the target's distribution after chunk[0..j]: it pairs with
            # d_{j+1}; p_K is the bonus.
            logits, cache_t = decoder.forward(params_t, cfg_t, torch.cat([last, d], dim=1), cache_t)
            p = torch.softmax(logits.float() * inv_t, dim=-1)  # [B, K+1, V]
            idx = d.long()[..., None]
            p_d = torch.gather(p[:, :k], 2, idx)[..., 0]
            q_d = torch.gather(q, 2, idx)[..., 0]
            u = torch.rand(d.shape, generator=rng, device=dev)
            accept = (u * torch.clamp(q_d, min=_EPS) < p_d).to(torch.int32)
            n_acc = torch.cumprod(accept, dim=1).sum(dim=1)  # [B]

            # The residual at the first rejected position (q padded with a zero
            # row at K: a full accept samples from p_K itself).
            q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
            row = n_acc.long()[:, None, None].expand(-1, 1, p.shape[-1])
            p_row = torch.gather(p, 1, row)[:, 0]  # [B, V]
            q_row = torch.gather(q_pad, 1, row)[:, 0]
            res = torch.clamp(p_row - q_row, min=0.0)
            res = torch.where(res.sum(-1, keepdim=True) > _EPS, res, p_row)  # an all-zero residual (rounding)
            res_logits = torch.log(torch.clamp(res, min=_EPS))
            extra = torch.argmax(res_logits + gumbel(rng, res.shape, dev), dim=-1).to(torch.int32)  # [B]

            m = (n_acc + 1).to(torch.int32)
            d_pad = torch.cat([d, d[:, -1:]], dim=1)  # [B, K+1]
            pos = torch.arange(k + 1, device=dev)[None, :]
            toks.append(torch.where(pos < n_acc[:, None], d_pad, extra[:, None]))
            counts.append(m)
            new_len = torch.clamp(start + m, max=limit)
            cache_t["len"].copy_(new_len)
            cache_d["len"].copy_(new_len)
            _clamp_host((cache_t, cache_d), limit)
            last = extra[:, None]
        return torch.stack(toks), torch.stack(counts), last

    key = ("sample", id(params_t), cfg_t, id(params_d), cfg_d, k, temperature)
    toks, counts, last = _run_rounds(rounds, key, cache_t, cache_d, last_tokens, rng, n_rounds,
                                     (params_t, params_d))
    toks_np, counts_np = _finish((cache_t, cache_d), len0, toks, counts, limit)
    return toks_np, counts_np, cache_t, cache_d, last


def _prefill_both(params_t, cfg_t, params_d, cfg_d, prompt, max_new_tokens: int, k: int, max_len, device):
    """Both caches (prompt + max_new_tokens + k + 2 positions at least),
    the prompt fed into each; the target's last-position f32 logits [B, V]."""
    prompt = torch.as_tensor(np.asarray(prompt, np.int32), device=device)
    b, p = prompt.shape
    max_len = max(max_len or 0, p + max_new_tokens + k + 2)
    cache_t = decoder.init_cache(cfg_t, b, max_len, device)
    cache_d = decoder.init_cache(cfg_d, b, max_len, device)
    logits, cache_t = decoder.prefill(params_t, cfg_t, prompt, cache_t, last_only=True)
    _, cache_d = decoder.prefill(params_d, cfg_d, prompt, cache_d, lm_head_mode="argmax", last_only=True)
    return cache_t, cache_d, logits[:, -1]


def _first(last: torch.Tensor, eos_token):
    """The rows' host lists holding their first token, and which are done."""
    out = [[int(t)] for t in last.view(-1).cpu().numpy()]
    return out, [eos_token is not None and row[0] == eos_token for row in out]


def _live(out, done, max_new_tokens: int) -> bool:
    return any(len(row) < max_new_tokens and not d for row, d in zip(out, done))


def speculative_sample_generate(params_t, cfg_t, params_d, cfg_d, prompt, *, rng: torch.Generator, k: int = 4,
                                max_new_tokens: int = 64, temperature: float = 1.0, rounds_per_call: int = 8,
                                eos_token: int | None = None, max_len: int | None = None,
                                device="cuda") -> list[list[int]]:
    """Host driver of ``speculative_sample_scan``: prefill both models,
    sample the first token from the target at ``temperature``, then run
    rounds ``rounds_per_call`` at a time until every row has
    ``max_new_tokens`` tokens (or its ``eos_token``)."""
    cache_t, cache_d, logits = _prefill_both(params_t, cfg_t, params_d, cfg_d, prompt, max_new_tokens, k, max_len,
                                             device)
    last = TemperatureSampler(temperature).sample(rng, logits)[:, None]
    out, done = _first(last, eos_token)
    while _live(out, done, max_new_tokens):
        toks, counts, _, _, last = speculative_sample_scan(
            params_t, cfg_t, cache_t, params_d, cfg_d, cache_d, last, rng, temperature,
            k=k, n_rounds=rounds_per_call)
        _unpack_rounds(out, done, toks, counts, eos_token, max_new_tokens)
    return [row[:max_new_tokens] for row in out]


def _unpack_rounds(out, done, toks, counts, eos_token, max_new_tokens):
    """Append each round's valid tokens to the rows' host lists in place."""
    toks_np, counts_np = np.asarray(toks), np.asarray(counts)  # [R, B, K+1], [R, B]
    for r in range(toks_np.shape[0]):
        for i in range(toks_np.shape[1]):
            if done[i] or len(out[i]) >= max_new_tokens:
                continue
            for j in range(int(counts_np[r, i])):
                tok = int(toks_np[r, i, j])
                out[i].append(tok)
                if eos_token is not None and tok == eos_token:
                    done[i] = True
                    break
                if len(out[i]) >= max_new_tokens:
                    break


def speculative_generate(params_t, cfg_t, params_d, cfg_d, prompt, *, k: int = 4, max_new_tokens: int = 64,
                         rounds_per_call: int = 8, eos_token: int | None = None, max_len: int | None = None,
                         device="cuda") -> list[list[int]]:
    """Host driver of ``speculative_scan``: prefill both models, take the
    target's greedy first token, then run rounds ``rounds_per_call`` at a
    time until every row has ``max_new_tokens`` tokens (or its
    ``eos_token``). Token-exact against greedy decoding of the target."""
    cache_t, cache_d, logits = _prefill_both(params_t, cfg_t, params_d, cfg_d, prompt, max_new_tokens, k, max_len,
                                             device)
    last = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    out, done = _first(last, eos_token)
    while _live(out, done, max_new_tokens):
        toks, counts, _, _, last = speculative_scan(
            params_t, cfg_t, cache_t, params_d, cfg_d, cache_d, last, k=k, n_rounds=rounds_per_call)
        _unpack_rounds(out, done, toks, counts, eos_token, max_new_tokens)
    return [row[:max_new_tokens] for row in out]
