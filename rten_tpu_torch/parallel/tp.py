"""Explicit tensor parallelism for the decoder, and sequence-parallel
prefill.

Counterpart of ``rten_tpu/parallel/tp.py``. The JAX package runs the body
``tp_forward`` under ``shard_map`` over a ``("data", "model")`` mesh; here
every rank runs it on its own shard (SPMD), with the same hand-placed
collectives through ``parallel.mesh.Mesh``:

- embedding: the vocab-sharded table, a masked local gather, ``psum``;
- q / k / v and up / gate: column-parallel, this rank's heads or d_ff slice,
  no communication; attention fully local (the kv heads sit with their
  query group);
- wo and down: row-parallel, this rank's K slice, then the all-reduce (or,
  with ``overlap`` on dense weights, ``overlap.matmul_allreduce``, the ring
  of the JAX package's ``overlap=True``); the bias and residual come after
  the reduction, once;
- lm_head: column-parallel over the vocab, the logits gathered along it.

Each projection runs the same kernels as the one-rank per-projection route
(``decoder._dense_proj``): a pack through ``quant_matmul_int8``, the GEMV at
≤ 8 rows; a dense matrix through ``ieee.matmul``. Attention is the cache's
KV kernel for one token a row (``decode_attention`` without its wo,
``decode_attention_int8``, the paged pair), else causal ``flash_attention``
(``decoder._attention``). No fused epilogue crosses a reduction: the wo
fused into ``decode_attention``, the MLP kernel and ``decode_block`` would
each add the bias and residual once a rank, so the body, like the JAX one,
never takes them.

The reductions run in f32: each rank's wo / down partial leaves its kernel
as f32, the all-reduce sums f32, and the bias and residual are added in f32
before the one rounding to the model dtype, as the one-rank GEMV's
epilogue rounds once. The JAX body psums partials in the activation dtype.
In f32 the two are the same; in bf16 the port rounds once where JAX rounds
the partials, their sum and the residual add.

``sp_prefill`` is the sequence-parallel prefill: weights replicated, the
prompt split on its sequence over a mesh axis, attention through
``kernels.ring_attention``.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.kernels.decode_attention import decode_attention
from rten_tpu_torch.models import decoder as D
from rten_tpu_torch.parallel.mesh import Mesh, local_config


def _row_proj(x, w, mesh: Mesh, axis: str, *, bias=None, residual=None, overlap: bool = False):
    """Row-parallel projection of the rows x [M, K/m]: the local partial,
    the all-reduce over ``axis`` in f32 (or, with ``overlap`` on a dense
    weight, the ring ``matmul_allreduce``), then ``bias`` and ``residual``
    in f32 and one rounding to the residual's dtype. Column-parallel
    projections need no communication: ``decoder._dense_proj`` on this
    rank's slice."""
    if overlap and not D._is_pack(w):
        from rten_tpu_torch.parallel.overlap import matmul_allreduce

        out = matmul_allreduce(x.float(), w.float(), mesh, axis)
    else:
        out = mesh.psum(D._dense_proj(x, w, out_dtype=torch.float32), axis)
    if bias is not None:
        out = out + bias.float()
    if residual is None:
        return out.to(x.dtype)
    return (out + residual.float()).to(residual.dtype)


def _embed(table, tokens, mesh: Mesh, axis: str):
    """Vocab-sharded embedding of the flat tokens: the rows this rank holds,
    zero elsewhere, summed over ``axis`` (the Megatron parallel
    embedding); exact, one rank contributes each row."""
    v_local = table.shape[0]
    lo = mesh.axis_index(axis) * v_local
    mine = (tokens >= lo) & (tokens < lo + v_local)
    emb = table.index_select(0, (tokens - lo).clamp(0, v_local - 1))
    emb = torch.where(mine[:, None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
    return mesh.psum(emb.float(), axis).to(table.dtype)


def _lm_head(params: dict, cfg: D.DecoderConfig, x, mesh: Mesh, axis: str, mode: str):
    """The final norm and the column-parallel head of the rows x: the f32
    logits [M, vocab] gathered over ``axis``, or (``mode="argmax"``) the
    greedy tokens int32 [M]: each rank's maximum and its lowest index among
    its real vocab columns, gathered, the largest taken (the lowest rank on
    ties, whose columns come first): the lowest index among equal maxima."""
    local = D.head_logits(params, D._norm(x, params["final_norm"], cfg))
    if mode == "logits":
        return mesh.all_gather(local, axis, dim=-1)[:, : cfg.vocab_size]
    n = local.shape[1]
    lo = mesh.axis_index(axis) * n
    real = max(0, min(n, cfg.vocab_size - lo))
    if real < n:
        local = local.clone()
        local[:, real:] = float("-inf")
    best, idx = local.max(-1)
    both = mesh.all_gather(torch.stack([best, (idx + lo).float()], -1), axis, dim=-1, tiled=False)  # [M, 2, p]
    winner = both[:, 0].argmax(-1, keepdim=True)
    return both[:, 1].gather(1, winner)[:, 0].to(torch.int32)


def _tp_mlp(x, layer, cfg: D.DecoderConfig, mesh: Mesh, axis: str, overlap: bool):
    """The MLP half of a layer: ln2, the column-parallel up (bias and
    activation) or ``silu(gate) · up``, the row-parallel down with its bias
    and the residual after the reduction."""
    xn = D._norm(x, layer["ln2"], cfg)
    if cfg.activation == "swiglu":
        gate, up = D._dense_proj(xn, layer["w_gate"]), D._dense_proj(xn, layer["w_up"])
        hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    else:
        hidden = D._dense_proj(xn, layer["w_up"], layer.get("b_up"), cfg.activation)
    return _row_proj(hidden, layer["w_down"], mesh, axis, bias=layer.get("b_down"), residual=x, overlap=overlap)


def tp_forward(params: dict, cfg: D.DecoderConfig, tokens, cache: dict | None, *, mesh: Mesh,
               axis: str = "model", overlap: bool = False, lm_head_mode: str = "logits", last_only: bool = False):
    """One decoder forward of this rank's rows ``tokens`` [b, T] on its
    shard: ``params`` from ``shard_decoder_params``, ``cache`` this rank's
    (``mesh.init_cache``, or a paged pool's state at its kv heads), None
    for a plain full-sequence forward. Returns ``(result, cache)``, the
    cache updated in place, ``result`` as ``decoder.forward``'s: f32 logits
    [b, T, vocab] or (``lm_head_mode="argmax"``) int32 tokens [b, T], or
    with ``last_only`` the last position's [b, 1, …]; the same on every
    rank of ``axis``. The JAX package's ``shard_map`` body."""
    if lm_head_mode not in ("logits", "argmax"):
        raise ValueError(f"lm_head_mode must be 'logits' or 'argmax', got {lm_head_mode!r}")
    lcfg = local_config(cfg, mesh, axis)
    b, t = tokens.shape
    h, hk, hd = lcfg.n_heads, lcfg.kv_heads, cfg.head_dim
    paged = cache is not None and "k_pages" in cache
    one_token = t == 1 and cache is not None
    kv_decode = one_token and (paged or "k_scale" in cache)
    decode = one_token and not paged and "k_scale" not in cache
    if paged and not kv_decode:
        raise ValueError(f"a paged cache takes one token per row, got {b}x{t}")
    q_offset = kv_len = None
    if cache is not None:
        D._check_room(cache, t)
        start = cache["len"]
        positions = start[:, None] + torch.arange(t, device=start.device)
        if not decode:
            q_offset, kv_len = start, start + t
    else:
        positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = _embed(params["tok_emb"], tokens.reshape(-1), mesh, axis)
    rope = None
    if cfg.pos_encoding == "learned":
        x = x + params["pos_emb"].index_select(0, positions.reshape(-1) + cfg.pos_offset)
    else:
        rope = D._rope_tables(positions, hd, cfg.rope_theta)
    x = x.to(cfg.dtype)

    for li, layer in enumerate(params["layers"]):
        xn = D._norm(x, layer["ln1"], cfg)
        q, k, v = (D._dense_proj(xn, layer[w], layer.get(bias), n=n * hd).view(b, t, n, hd)
                   for w, bias, n in (("wq", "bq", h), ("wk", "bk", hk), ("wv", "bv", hk)))
        if rope is not None:
            q, k = D._rope(q, rope), D._rope(k, rope)
        ops = (q[:, 0], k[:, 0], v[:, 0]) if one_token else None
        if decode:
            attn = decode_attention(ops, cache["k"][li], cache["v"][li], cache["len"])
        elif kv_decode:
            attn = D._kv_decode_attention(ops, cache, li)
        else:
            attn = D._attention(q, k, v, cache, li, q_offset, kv_len)
        x = _row_proj(attn, layer["wo"], mesh, axis, bias=layer.get("bo"), residual=x, overlap=overlap)
        x = _tp_mlp(x, layer, cfg, mesh, axis, overlap)

    head_in = (x.view(b, t, -1)[:, -1] if last_only and t > 1 else x).contiguous()
    result = _lm_head(params, cfg, head_in, mesh, axis, lm_head_mode)
    result = result.reshape(b, 1 if last_only else t, *result.shape[1:])
    if cache is not None:
        cache["len"].add_(t)
        if not paged:
            cache["host_len"] += t
    return result, cache


def data_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (all of them without a
    data axis)."""
    d = mesh.shape.get("data", 1)
    if n % d:
        raise ValueError(f"batch {n} is not a multiple of the data axis ({d})")
    i = mesh.axis_index("data") if d > 1 else 0
    return slice(i * n // d, (i + 1) * n // d)


def tp_decode_step(params: dict, cfg: D.DecoderConfig, tokens, cache: dict, *, mesh: Mesh, overlap: bool = False,
                   lm_head_mode: str = "logits", last_only: bool = False):
    """One forward of the global ``tokens`` [B, T] (the same on every rank)
    over the mesh: this rank's ``data`` rows through ``tp_forward`` on its
    cache, the result gathered over ``data``. Returns ``(result [B, …],
    cache)``, the result on every rank. The JAX package's
    ``tp_decode_step``; ``tp_prefill`` is the same call at T > 1."""
    rows = data_rows(mesh, tokens.shape[0])
    out, cache = tp_forward(params, cfg, tokens[rows], cache, mesh=mesh, overlap=overlap,
                            lm_head_mode=lm_head_mode, last_only=last_only)
    if mesh.shape.get("data", 1) > 1:
        out = mesh.all_gather(out, "data", dim=0)
    return out, cache


tp_prefill = tp_decode_step


def tp_paged_decode(params: dict, cfg: D.DecoderConfig, tokens, pool_state: dict, page_table, lens, *, mesh: Mesh,
                    lm_head_mode: str = "logits"):
    """One paged decode step with the pool's pages at this rank's kv heads:
    ``pool_state`` ``{"k_pages", "v_pages"[, "k_scale_pages",
    "v_scale_pages"]}``, the page table and lengths the same on every rank.
    The mesh's data axis must be 1 (a paged batch is scheduled on the host,
    not sharded). Returns ``(result, pool_state)``, the pages written in
    place; ``lens`` is left as it was (the caller advances it)."""
    if mesh.shape.get("data", 1) != 1:
        raise ValueError("paged tensor parallelism shards the model axis only (data axis 1)")
    cache = {**pool_state, "page_table": page_table, "len": lens.clone()}
    out, _ = tp_forward(params, cfg, tokens, cache, mesh=mesh, lm_head_mode=lm_head_mode)
    return out, pool_state


def tp_sample(params: dict, cfg: D.DecoderConfig, tokens, cache: dict, sampler, rng, *, mesh: Mesh,
              overlap: bool = False, local: bool = False):
    """The engines' step under a mesh: one forward of ``tokens`` and each
    row's next token at its last position, int32 [B, 1] on every rank of
    the mesh. Greedy takes the gathered argmax; another sampler draws from
    the gathered f32 logits with ``rng``. The tokens are then broadcast from
    the mesh's first rank, so that every rank takes the same host decisions
    (admission, EOS, budget). ``local``: the rows are this rank's data
    group's alone (admission): no data gather, and the broadcast from the
    group's model-rank 0."""
    from rten_tpu_torch.generate.sampler import ArgMaxSampler

    greedy = isinstance(sampler, ArgMaxSampler)
    mode = "argmax" if greedy else "logits"
    if local:
        out, _ = tp_forward(params, cfg, tokens, cache, mesh=mesh, overlap=overlap, lm_head_mode=mode,
                            last_only=True)
    else:
        out, _ = tp_decode_step(params, cfg, tokens, cache, mesh=mesh, overlap=overlap, lm_head_mode=mode,
                                last_only=True)
    nxt = out[:, -1:] if greedy else sampler.sample(rng, out[:, -1])[:, None].to(torch.int32)
    return mesh.broadcast(nxt.contiguous(), "model" if local else None, 0)


# ---------------------------------------------------------------------------
# Sequence-parallel prefill
# ---------------------------------------------------------------------------


def sp_prefill(params: dict, cfg: D.DecoderConfig, tokens, *, mesh: Mesh, axis: str = "model"):
    """Sequence-parallel (context-parallel) prefill of the global
    ``tokens`` [B, T] (T a multiple of the axis size, the same on every
    rank): weights replicated (the whole tree on every rank), each rank the
    T/p positions at its index, attention through ``ring_attention`` (the
    kv blocks rotating around ``axis`` with the online-softmax correction
    carried across ranks). Returns ``(logits [B, T, vocab] f32, per-layer
    k, v [B, Hk, T, D])`` gathered on every rank: what a decode cache is
    seeded with. The JAX package's ``sp_prefill``."""
    from rten_tpu_torch.kernels.ring_attention import ring_attention

    b, t = tokens.shape
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    if t % p:
        raise ValueError(f"{t} tokens do not split over {p} ranks")
    tl = t // p
    tok = tokens[:, idx * tl:(idx + 1) * tl].reshape(-1)
    positions = (idx * tl + torch.arange(tl, device=tokens.device)).expand(b, tl)
    x = params["tok_emb"].index_select(0, tok)
    rope = None
    if cfg.pos_encoding == "learned":
        x = x + params["pos_emb"].index_select(0, positions.reshape(-1) + cfg.pos_offset)
    else:
        rope = D._rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = x.to(cfg.dtype)
    h, hk, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    ks, vs = [], []
    for layer in params["layers"]:
        q, k, v = D._dense_qkv(layer, cfg, x, b, tl, rope)  # [b, tl, H(k), D]
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        if hk != h:  # the ring is MHA-shaped: expand the GQA groups
            k_r, v_r = k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1)
        else:
            k_r, v_r = k, v
        attn = ring_attention(q, k_r, v_r, mesh, axis, causal=True)
        ks.append(k)
        vs.append(v)
        attn = attn.transpose(1, 2).reshape(b * tl, h * hd)
        x = x + D._dense_proj(attn, layer["wo"], layer.get("bo"), n=cfg.d_model)
        x = D._dense_mlp(layer, cfg, x)  # replicated weights: every rank owns whole rows
    logits = D._dense_lm_head(params, cfg, x, "logits").view(b, tl, -1)
    logits = mesh.all_gather(logits, axis, dim=1)
    ks = [mesh.all_gather(k.contiguous(), axis, dim=2) for k in ks]
    vs = [mesh.all_gather(v.contiguous(), axis, dim=2) for v in vs]
    return logits, ks, vs
