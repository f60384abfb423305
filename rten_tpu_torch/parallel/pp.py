"""Pipeline parallelism: the microbatched (GPipe fill-drain) inference
forward of the decoder over a mesh axis of stages.

Counterpart of ``rten_tpu/parallel/pp.py``. The layers are stacked along a
leading layer axis (``stack_layer_params``) and stage s runs layers
[s·L/p, (s+1)·L/p). The batch splits into m microbatches; at tick t, stage
s runs microbatch t - s, so after m + p - 1 ticks every microbatch has
crossed every stage. Activations go to the next stage point to point
(``Mesh.send`` / ``recv``); where the JAX package computes the idle ticks
on garbage and masks them, a stage here skips them. The embedding runs on
stage 0 and the head on the last stage, whose logits reach every rank by
a broadcast (the JAX package's psum masked to the last stage). Each layer
is the decoder's per-projection route (``decoder._dense_qkv``, causal
``flash_attention``, ``_dense_proj``, ``_dense_mlp``).

Full-sequence forwards only (prefill and encoder work): a decode step's
one-token chain gains nothing from stages and keeps tensor parallelism.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.models import decoder as D


def stack_layer_params(params: dict) -> dict:
    """The per-layer list as leading-layer-axis tensors under
    ``stacked_layers`` (every leaf ``torch.stack``ed; the layers must have
    the same keys and shapes, dense and unfused as the JAX package's)."""
    layers = params["layers"]

    def stack(nodes, where):
        first = nodes[0]
        if isinstance(first, dict):
            if any(sorted(n) != sorted(first) for n in nodes):
                raise ValueError(f"pipeline stages need homogeneous layers ({where or 'layer'} keys differ)")
            return {k: stack([n[k] for n in nodes], f"{where}.{k}") for k in first}
        return torch.stack(nodes)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["stacked_layers"] = stack(layers, "")
    return out


def _unstack(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _unstack(v, i) for k, v in stacked.items()}
    return stacked[i]


def _one_layer(layer: dict, cfg: D.DecoderConfig, x, b: int, t: int, rope):
    """One decoder layer, full sequence and no cache, on the rows x [b·t, D]."""
    q, k, v = D._dense_qkv(layer, cfg, x, b, t, rope)
    attn = D._attention(q, k, v, None, 0, None, None)
    x = x + D._dense_proj(attn, layer["wo"], layer.get("bo"), n=cfg.d_model)
    return D._dense_mlp(layer, cfg, x)


def pp_forward(params: dict, cfg: D.DecoderConfig, tokens, *, mesh, axis: str = "pipe",
               n_microbatches: int | None = None):
    """Logits f32 [B, T, vocab] of the full-sequence forward of ``tokens``
    [B, T] (the same on every rank; B a multiple of ``n_microbatches``,
    default the number of stages) under pipeline parallelism over ``axis``:
    ``params`` from ``stack_layer_params``, the whole tree on every rank, of
    which each stage runs its own layers. The result is on every rank of
    ``axis``: ``decoder.forward(tokens, None)``'s logits."""
    p, s = mesh.axis_size(axis), mesh.axis_index(axis)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.n_layers} layers do not split over {p} stages")
    m = n_microbatches or p
    b, t = tokens.shape
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    mb = b // m
    per_stage = cfg.n_layers // p
    stacked = params["stacked_layers"]
    layers = [_unstack(stacked, i) for i in range(s * per_stage, (s + 1) * per_stage)]
    positions = torch.arange(t, device=tokens.device).expand(mb, t)
    rope = D._rope_tables(positions, cfg.head_dim, cfg.rope_theta) if cfg.pos_encoding == "rope" else None

    def embed(i):
        ids = tokens[i * mb:(i + 1) * mb].reshape(-1)
        x = params["tok_emb"].index_select(0, ids)
        if cfg.pos_encoding == "learned":
            x = x + params["pos_emb"].index_select(0, positions.reshape(-1) + cfg.pos_offset)
        return x.to(cfg.dtype)

    out = torch.empty((m, mb * t, cfg.vocab_size), dtype=torch.float32, device=tokens.device)
    sends = []
    for tick in range(m + p - 1):
        i = tick - s  # the microbatch this stage runs at this tick
        if not 0 <= i < m:
            continue  # a fill or drain tick: idle
        x = embed(i) if s == 0 else mesh.recv((mb * t, cfg.d_model), cfg.dtype, axis, s - 1)
        for layer in layers:
            x = _one_layer(layer, cfg, x, mb, t, rope)
        if s < p - 1:
            sends.append(mesh.send(x, axis, s + 1))
        else:
            out[i] = D._dense_lm_head(params, cfg, x, "logits")
    for pending in sends:
        pending.wait()
    out = mesh.broadcast(out, axis, p - 1)
    return out.view(b, t, cfg.vocab_size)
