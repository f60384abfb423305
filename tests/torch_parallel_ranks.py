"""What the ranks of the ``test_torch_parallel`` / ``_overlap`` /
``_multihost`` tests run: module-level functions that
``parallel.launch.World`` pickles by name and calls on every rank.

This module imports neither JAX nor the JAX package (the ranks must not:
``ranks_import_no_jax`` checks it), only torch, numpy and the port. Inputs
come from the tests as numpy arrays; each function returns numpy arrays (or
plain values) from the mesh's first rank and None from the others, unless
it says otherwise.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.parallel import mesh as pmesh


def _mesh(shape, axes=("data", "model")):
    """A mesh of ``shape`` over the first ranks of the world (collective:
    every rank makes it), or None on a rank outside it."""
    mesh = pmesh.Mesh(dict(zip(axes, shape)), device="cpu")
    return mesh if mesh.member else None


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy() if t.is_floating_point() else t.detach().cpu().numpy()


def ranks_import_no_jax():
    """Whether this rank's process has imported JAX or the JAX package."""
    return [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "rten_tpu.")) or m == "rten_tpu"]


def tp_run(shape, cfg, tree, prompt, n_steps, cache_kind="bf16", overlap=False, max_len=64):
    """``tp_prefill`` of ``prompt`` then ``n_steps`` greedy ``tp_decode_step``s
    (argmax of each step's logits fed back), on a mesh of ``shape``: every
    step's f32 logits, and each layer's cache gathered to the logical
    ``[B, Hk, S, D]`` layout (codes and scales for an int8 cache), the
    ranks' head slices in rank order and rows in data order."""
    import dataclasses

    from rten_tpu_torch.parallel.tp import tp_decode_step, tp_prefill

    mesh = _mesh(shape)
    if mesh is None:
        return None
    cfg = dataclasses.replace(cfg, int8_kv=cache_kind == "int8")
    params = pmesh.shard_decoder_params(tdec.params_from_jax(tree, cfg, device="cpu"), cfg, mesh)
    cache = pmesh.init_cache(cfg, prompt.shape[0], max_len, mesh)
    tok = torch.from_numpy(prompt)
    dispatch.reset_counters()
    logits, cache = tp_prefill(params, cfg, tok, cache, mesh=mesh, overlap=overlap)
    outs = [logits]
    for _ in range(n_steps):
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        logits, cache = tp_decode_step(params, cfg, tok, cache, mesh=mesh, overlap=overlap)
        outs.append(logits)
    plain = dict(dispatch.PLAIN)
    kv = {}
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:
            per_layer = []
            for t in cache[key]:
                heads = mesh.all_gather(t.contiguous(), "model", dim=1)
                per_layer.append(_np(mesh.all_gather(heads, "data", dim=0)))
            kv[key] = per_layer
    if mesh.axis_index(None):
        return None
    return dict(logits=[_np(o) for o in outs], cache=kv, plain=plain, routes=dict(mesh.routes))


def tp_paged_run(shape, cfg, tree, pages, table, lens, tokens, n_steps):
    """``n_steps`` greedy ``tp_paged_decode`` steps from ``tokens`` [B, 1]
    over a pool given whole (``pages``: port layout ``[P, H, page, D]``
    k / v per layer, with ``k_scale`` / ``v_scale`` ``[P, H, page]`` for an
    int8 pool), each rank holding its kv heads of it; the lengths advance a
    step at a time. Every step's logits and the pool gathered back whole."""
    from rten_tpu_torch.parallel.tp import tp_paged_decode

    mesh = _mesh(shape)
    if mesh is None:
        return None
    params = pmesh.shard_decoder_params(tdec.params_from_jax(tree, cfg, device="cpu"), cfg, mesh)
    hk = cfg.kv_heads // shape[1]
    i = mesh.axis_index("model")
    names = {"k": "k_pages", "v": "v_pages", "k_scale": "k_scale_pages", "v_scale": "v_scale_pages"}
    state = {names[key]: [torch.from_numpy(np.ascontiguousarray(p[:, i * hk:(i + 1) * hk])) for p in layers]
             for key, layers in pages.items()}
    table, lens, tok = torch.from_numpy(table), torch.from_numpy(lens.copy()), torch.from_numpy(tokens)
    outs = []
    for _ in range(n_steps):
        logits, state = tp_paged_decode(params, cfg, tok, state, table, lens, mesh=mesh)
        outs.append(logits)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        lens = lens + 1
    pool = {key: [_np(mesh.all_gather(t, "model", dim=1)) for t in state[names[key]]] for key in pages}
    if mesh.axis_index(None):
        return None
    return dict(logits=[_np(o) for o in outs], pool=pool)


def sp_run(shape, cfg, tree, prompt):
    """``sp_prefill`` of ``prompt`` over the mesh's model axis: the logits
    and each layer's k / v, as every rank holds them."""
    from rten_tpu_torch.parallel.tp import sp_prefill

    mesh = _mesh(shape)
    if mesh is None:
        return None
    params = tdec.params_from_jax(tree, cfg, device="cpu")
    logits, ks, vs = sp_prefill(params, cfg, torch.from_numpy(prompt), mesh=mesh)
    if mesh.axis_index(None):
        return None
    return dict(logits=_np(logits), k=[_np(k) for k in ks], v=[_np(v) for v in vs])


def pp_run(stages, cfg, tree, prompt, n_microbatches):
    """``pp_forward`` of ``prompt`` over ``stages`` ranks on a ``pipe``
    axis: the logits of every rank (all must hold the same)."""
    from rten_tpu_torch.parallel.pp import pp_forward, stack_layer_params

    mesh = _mesh((stages,), ("pipe",))
    if mesh is None:
        return None
    params = stack_layer_params(tdec.params_from_jax(tree, cfg, device="cpu"))
    return _np(pp_forward(params, cfg, torch.from_numpy(prompt), mesh=mesh, n_microbatches=n_microbatches))


def engine_run(shape, cfg, tree, kind, specs, tp_mode="pjit", int8_kv=False, page=64, n_pages=8):
    """``specs`` (dicts of Request fields) through the slot (``kind``
    "slot") or paged engine on a mesh of ``shape``: every request's output
    from every rank, and the launch and plain counters of the run."""
    import dataclasses

    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine

    mesh = _mesh(shape)
    if mesh is None:
        return None
    params = tdec.params_from_jax(tree, cfg, device="cpu")
    dispatch.reset_counters()
    if kind == "slot":
        engine = ServingEngine(params, dataclasses.replace(cfg, int8_kv=int8_kv), max_batch=2, mesh=mesh,
                               tp_mode=tp_mode)
    else:
        engine = PagedServingEngine(params, cfg, max_batch=2, n_pages=n_pages, page_size=page, int8_kv=int8_kv,
                                    mesh=mesh)
    reqs = [engine.submit(Request(**spec)) for spec in specs]
    engine.run()
    return dict(outputs=[r.output for r in reqs], plain=dict(dispatch.PLAIN), routes=dict(mesh.routes))


def row_proj_bf16(x, w, bias, residual):
    """The row-parallel projection of bf16 rows over a 2-rank model axis
    (each rank its half of K), and what its f32 reduction must give: the
    f32 partials summed, the bias and residual added in f32, one rounding."""
    from rten_tpu_torch.parallel.tp import _row_proj

    mesh = _mesh((1, 2))
    if mesh is None:
        return None
    i, half = mesh.axis_index("model"), x.shape[1] // 2
    xb, wb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    rb = torch.from_numpy(residual).to(torch.bfloat16)
    out = _row_proj(xb[:, i * half:(i + 1) * half], wb[i * half:(i + 1) * half], mesh, "model",
                    bias=torch.from_numpy(bias), residual=rb)
    parts = [xb[:, j * half:(j + 1) * half].float() @ wb[j * half:(j + 1) * half].float() for j in range(2)]
    want = ((parts[0] + parts[1]) + torch.from_numpy(bias) + rb.float()).to(torch.bfloat16)
    return bool(torch.equal(out, want)) and out.dtype == torch.bfloat16


def overlap_run(p, name, x, w):
    """``overlap.<name>`` over a ``model`` axis of ``p`` ranks, each with
    its shard of ``x`` and ``w`` as the JAX test's ``in_specs`` cut them
    (allgather_matmul: x by rows, w whole; the other two: x by columns, w
    by rows); the result of every rank, and the ring's routes."""
    from rten_tpu_torch.parallel import overlap

    mesh = _mesh((1, p))
    if mesh is None:
        return None
    i = mesh.axis_index("model")
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    if name == "allgather_matmul":
        m = x.shape[0] // p
        out = overlap.allgather_matmul(x[i * m:(i + 1) * m], w, mesh)
    else:
        k = x.shape[1] // p
        out = getattr(overlap, name)(x[:, i * k:(i + 1) * k], w[i * k:(i + 1) * k], mesh)
    return dict(out=_np(out), routes=dict(mesh.routes))


def ring_run(p, q, k, v, causal):
    """``ring_attention_sharded`` over a ``model`` axis of ``p`` ranks: the
    gathered result of every rank."""
    from rten_tpu_torch.kernels.ring_attention import ring_attention_sharded

    mesh = _mesh((1, p))
    if mesh is None:
        return None
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    return _np(ring_attention_sharded(mesh, q, k, v, causal=causal))


class _FailOnce:
    """Arms a failure: the engine ``fail_rank`` builds raises once, after
    the step that brings it to ``fail_step`` (after that step's
    collectives, as a host-side fault would)."""

    def __init__(self, fail_rank, fail_step):
        self.rank, self.step, self.armed = fail_rank, fail_step, True


def _supervised_engine(params, cfg, mesh, fault):
    from rten_tpu_torch.serve import ServingEngine

    class Engine(ServingEngine):
        def step(self, n_steps=None):
            out = super().step(n_steps)
            mine = mesh is None or mesh.axis_index(None) == fault.rank
            if fault.armed and mine and self.steps >= fault.step:
                fault.armed = False
                raise RuntimeError("injected failure")
            return out

    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return Engine(params, cfg, max_batch=2, **kw)


def supervised_run(shape, cfg, tree, specs, fail_rank, fail_step, snapshot_every, snapshot_path=None):
    """``specs`` through a ``ServingSupervisor`` over the slot engine on a
    mesh of ``shape`` (None: one rank, no mesh), a failure injected on
    ``fail_rank`` at ``fail_step`` (None: no failure): every request's
    output by id and the restarts, from every rank of the mesh."""
    from rten_tpu_torch.parallel.multihost import ServingSupervisor
    from rten_tpu_torch.serve import Request

    mesh = _mesh(shape) if shape is not None else None
    if shape is not None and mesh is None:
        return None
    params = tdec.params_from_jax(tree, cfg, device="cpu")
    fault = _FailOnce(fail_rank, fail_step if fail_step is not None else 1 << 30)
    sup = ServingSupervisor(lambda: _supervised_engine(params, cfg, mesh, fault), snapshot_every=snapshot_every,
                            max_restarts=2, snapshot_path=snapshot_path, mesh=mesh)
    for i, spec in enumerate(specs):
        sup.submit(Request(**spec, request_id=i))
    done = sup.run()
    return dict(outputs={r.request_id: r.output for r in done}, n_done=len(done), restarts=sup.restarts)


def card_collectives(shift):
    """Each collective of a ``(1, 2)`` mesh on the card (gloo with both
    ranks on one card: staged through host memory; NCCL with a card each),
    on CUDA tensors a kernel has just written, against what it must give:
    (psum, all_gather, ppermute's arrival, broadcast from rank 1) as
    booleans, and the routes taken."""
    mesh = pmesh.make_mesh(1, 2)
    dev, i = mesh.device, mesh.axis_index("model")
    base = torch.arange(4096, dtype=torch.float32, device=dev).view(64, 64)
    x = base * (i + 1) + shift  # written by a kernel on this rank's stream just now
    want = [base * (j + 1) + shift for j in range(2)]
    ok = [bool(torch.equal(mesh.psum(x, "model"), want[0] + want[1])),
          bool(torch.equal(mesh.all_gather(x, "model", dim=0), torch.cat(want))),
          bool(torch.equal(mesh.ppermute(x, "model").wait(), want[1 - i])),
          bool(torch.equal(mesh.broadcast(x, "model", 1), want[1]))]
    return dict(ok=ok, routes=dict(mesh.routes), backend=mesh.backend, device=str(dev))


def card_mesh_engines(specs):
    """Both serving engines on a ``(1, 1)`` mesh on the card (the tiny bf16
    config, params from seed 0): each request's output, and the graphs
    captured on the engines' states, which must be none (under a mesh the
    tick and the step run eagerly, their collectives through the host)."""
    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine

    mesh = pmesh.make_mesh(1, 1)
    cfg = tdec.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024, max_seq=256,
                             dtype=torch.bfloat16)
    params = tdec.quantize_params_int8(tdec.init_params(0, cfg, device=mesh.device), device=mesh.device)
    out = {}
    for kind, cls, kw in (("slot", ServingEngine, dict(max_len=96, steps_per_tick=4)),
                          ("paged", PagedServingEngine, dict(n_pages=10, page_size=16))):
        engine = cls(params, cfg, max_batch=2, mesh=mesh, **kw)
        reqs = [engine.submit(Request(**spec)) for spec in specs]
        engine.run()
        anchor = engine.cache["len"] if kind == "slot" else engine.pool.k_pages[0]
        out[kind] = dict(outputs=[r.output for r in reqs], graphs=len(tdec._GRAPHS.get(anchor, ())))
    return out
