"""The device mesh over ``torch.distributed`` ranks, and the decoder's
weight sharding on it.

Counterpart of ``rten_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process holds a ``jax.sharding.Mesh`` and
``shard_map`` bodies name their collectives by mesh axis. The port is SPMD:
one process a rank (``parallel.launch``), every rank running the same
Python, and a ``Mesh`` object that gives each rank its coordinates and the
same collectives by axis name: ``psum``, tiled ``all_gather``, ``ppermute``
around a ring, ``broadcast``, point-to-point ``send`` / ``recv``, and
``axis_index``. Ranks take mesh positions in row-major order (rank
``d·model + m`` is at ``data`` d, ``model`` m), as ``make_mesh`` reshapes
the JAX device list.

**Routes.** NCCL takes the tensors where they lie. Gloo on the CPU takes
them as they are. Gloo with ranks that share a card (NCCL refuses two ranks
on one device) stages every collective through host memory: a blocking
copy of the CUDA tensor to the host (it waits for the kernels that produced
it on the current stream), the collective there, and a copy back. Each call
counts under ``mesh.routes["<collective>:<route>"]`` (route ``nccl``,
``gloo``, or ``gloo-host`` for the staged one), so a run shows which way
every collective went, and adds the host seconds it held the caller
(staging included; a point-to-point transfer's start and its wait) to
``mesh.seconds["<collective>"]``.

**Weights.** ``shard_decoder_params`` returns this rank's tree in the
Megatron layout of the JAX package's ``decoder_param_specs`` (``:34-80``)
over the ``model`` axis: q / k / v, up and gate column-parallel (this
rank's heads or d_ff slice; biases follow their columns), wo and down
row-parallel (their K slice; scales and biases whole), norms and
``pos_emb`` replicated, ``tok_emb`` split by vocab rows and the lm_head
(``lm_head`` / ``lm_head_q``) by columns. The JAX package's ``slabs`` have
no port counterpart. Params are replicated over ``data``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import decoder


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _Pending:
    """A point-to-point transfer in flight: ``wait()`` returns what arrived
    (None for a send), on the mesh's device, its wait clocked under
    ``clock``."""

    def __init__(self, reqs, recv, back, keep, clock=contextlib.nullcontext):
        self._reqs, self._recv, self._back, self._keep, self._clock = reqs, recv, back, keep, clock

    def wait(self):
        with self._clock():
            for req in self._reqs:
                req.wait()
            self._keep = None
            return None if self._recv is None else self._back(self._recv)


class Mesh:
    """A mesh of named axes over the first ``prod(axes)`` ranks of the
    initialised world. Building one is collective: every
    rank of the world makes it, members or not (``torch.distributed``'s
    ``new_group`` rule); a rank outside it has ``member`` False and takes
    part in none of its collectives. ``device`` is this rank's device
    (``"cuda"``: the current card)."""

    def __init__(self, axes: dict, device="cuda") -> None:
        import torch.distributed as dist

        self.device = _rank_device(device)
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised process group (parallel.launch or init_distributed)")
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        n = math.prod(self.shape.values())
        world, me = dist.get_world_size(), dist.get_rank()
        self.ranks = list(range(n))
        if n > world:
            raise ValueError(f"a mesh of {self.shape} needs {n} ranks; the world has {world}")
        self.member = me in self.ranks
        self.backend = dist.get_backend()
        self.routes: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()
        self._groups: dict = {}
        self._peers: dict = {}
        self.coords: dict = {}
        grid = np.asarray(self.ranks).reshape([self.shape[a] for a in self.axis_names])
        for ai, axis in enumerate(self.axis_names):
            for line in np.moveaxis(grid, ai, -1).reshape(-1, self.shape[axis]).tolist():
                group = dist.new_group(line) if len(line) > 1 else None  # every rank enters, in one order
                if me in line:
                    self._groups[axis], self._peers[axis], self.coords[axis] = group, line, line.index(me)
        if n == world:
            self._groups[None] = dist.group.WORLD
        else:
            group = dist.new_group(self.ranks) if n > 1 else None
            if self.member:
                self._groups[None] = group
        if self.member:
            self._peers[None] = self.ranks
            self.coords[None] = self.ranks.index(me)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, backend={self.backend})"

    # -- coordinates -----------------------------------------------------------

    def axis_size(self, axis: str | None) -> int:
        """The size of ``axis`` (None: the whole mesh)."""
        return len(self.ranks) if axis is None else self.shape[axis]

    def axis_index(self, axis: str | None) -> int:
        """This rank's index along ``axis`` (None: its index in the mesh)."""
        return self.coords[axis]

    # -- collectives -----------------------------------------------------------

    @contextlib.contextmanager
    def _clock(self, op: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[op] += time.perf_counter() - t0

    def _stage(self, x, op: str):
        """(the tensor the backend takes, the way back to ``x``'s device),
        counting the route under ``routes``."""
        if self.backend == "nccl" or x.device.type == "cpu":
            self.routes[f"{op}:{self.backend}"] += 1
            return x.contiguous(), lambda t: t
        self.routes[f"{op}:gloo-host"] += 1
        dev = x.device
        return x.detach().to("cpu"), lambda t: t.to(dev)

    def psum(self, x, axis: str | None):
        """The sum of ``x`` over ``axis`` on every rank of it (a new tensor)."""
        return self._all_reduce(x, axis, "SUM")

    def pmax(self, x, axis: str | None):
        """The elementwise maximum of ``x`` over ``axis`` (a new tensor)."""
        return self._all_reduce(x, axis, "MAX")

    def _all_reduce(self, x, axis: str | None, op: str):
        import torch.distributed as dist

        if self.axis_size(axis) == 1:
            return x
        with self._clock("all_reduce"):
            buf, back = self._stage(x, "all_reduce")
            buf = buf.clone() if buf.data_ptr() == x.data_ptr() else buf  # all_reduce writes in place
            dist.all_reduce(buf, op=getattr(dist.ReduceOp, op), group=self._groups[axis])
            return back(buf)

    def all_gather(self, x, axis: str | None, dim: int = -1, tiled: bool = True):
        """The ranks' ``x`` along ``axis`` in index order: concatenated on
        ``dim`` (``tiled``) or stacked on a new ``dim``."""
        import torch.distributed as dist

        p = self.axis_size(axis)
        if p == 1:
            return x if tiled else x.unsqueeze(dim)
        with self._clock("all_gather"):
            buf, back = self._stage(x, "all_gather")
            parts = [torch.empty_like(buf) for _ in range(p)]
            dist.all_gather(parts, buf, group=self._groups[axis])
            return back(torch.cat(parts, dim) if tiled else torch.stack(parts, dim))

    def broadcast(self, x, axis: str | None, src: int = 0):
        """``x`` of the rank at index ``src`` along ``axis``, on every rank
        of it (a new tensor; the others' ``x`` gives the shape and dtype)."""
        import torch.distributed as dist

        if self.axis_size(axis) == 1:
            return x
        with self._clock("broadcast"):
            buf, back = self._stage(x, "broadcast")
            buf = buf.clone() if buf.data_ptr() == x.data_ptr() else buf
            dist.broadcast(buf, src=self._peers[axis][src], group=self._groups[axis])
            return back(buf)

    def ppermute(self, x, axis: str, shift: int = 1) -> _Pending:
        """Start sending ``x`` to the rank ``shift`` places on along
        ``axis`` (around the ring) and receiving the one from ``shift``
        places back; ``.wait()`` on the result returns what arrived. The
        caller computes meanwhile: the transfer is in flight."""
        import torch.distributed as dist

        p, i = self.axis_size(axis), self.axis_index(axis)
        if p == 1:
            return _Pending([], x, lambda t: t, None)
        with self._clock("ppermute"):
            buf, back = self._stage(x, "ppermute")
            recv = torch.empty_like(buf)
            peers, group = self._peers[axis], self._groups[axis]
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, peers[(i + shift) % p], group),
                                           dist.P2POp(dist.irecv, recv, peers[(i - shift) % p], group)])
        return _Pending(reqs, recv, back, buf, lambda: self._clock("ppermute"))

    def send(self, x, axis: str, to: int) -> _Pending:
        """Start sending ``x`` to the rank at index ``to`` along ``axis``."""
        import torch.distributed as dist

        with self._clock("send"):
            buf, _back = self._stage(x, "send")
            req = dist.isend(buf, self._peers[axis][to], group=self._groups[axis])
        return _Pending([req], None, None, buf, lambda: self._clock("send"))

    def recv(self, shape, dtype, axis: str, frm: int):
        """A tensor of ``shape`` and ``dtype`` from the rank at index ``frm``
        along ``axis``, on this rank's device."""
        import torch.distributed as dist

        with self._clock("recv"):
            on_host = self.backend != "nccl" and self.device.type == "cuda"
            self.routes[f"recv:{'gloo-host' if on_host else self.backend}"] += 1
            buf = torch.empty(shape, dtype=dtype, device="cpu" if on_host else self.device)
            dist.recv(buf, self._peers[axis][frm], group=self._groups[axis])
            return buf.to(self.device)


def make_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh over the first ``data · model`` ranks
    (the JAX package's ``make_mesh``). Collective: every rank calls it."""
    return Mesh({"data": data, "model": model}, device)


# ---------------------------------------------------------------------------
# Sharding the decoder
# ---------------------------------------------------------------------------


def local_config(cfg: decoder.DecoderConfig, mesh: Mesh, axis: str = "model") -> decoder.DecoderConfig:
    """``cfg`` at this rank's heads: ``n_heads``, ``n_kv_heads`` and
    ``d_model`` over the axis size (the head dim is unchanged). ValueError
    unless both head counts divide."""
    m = mesh.axis_size(axis)
    if cfg.n_heads % m or cfg.kv_heads % m:
        raise ValueError(f"heads must divide the {axis} axis: {cfg.n_heads}/{cfg.kv_heads} over {m}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // m, n_kv_heads=cfg.kv_heads // m,
                               d_model=cfg.d_model // m)


def _cols(w, lo: int, hi: int):
    """Output columns [lo, hi) of a dense [K, N] matrix or an int8 pack
    (its ``qt`` rows and scales)."""
    if decoder._is_pack(w):
        return {"qt": w["qt"][lo:hi].contiguous(), "s": w["s"][lo:hi].contiguous(), "tiled": False}
    return w[:, lo:hi].contiguous()


def _rows(w, lo: int, hi: int):
    """Input rows (K) [lo, hi) of a dense [K, N] matrix or an int8 pack,
    scales whole; a pack's K slice is zero-padded to a multiple of 16 (the
    kernels' K rule; the rows are padded with zeros as ``_dense_proj`` pads
    the activations)."""
    if not decoder._is_pack(w):
        return w[lo:hi].contiguous()
    qt = w["qt"][:, lo:hi]
    pad = -qt.shape[1] % 16
    if pad:
        qt = torch.cat([qt, qt.new_zeros(qt.shape[0], pad)], 1)
    return {"qt": qt.contiguous(), "s": w["s"], "tiled": False}


def _vec(v, lo: int, hi: int):
    return None if v is None else v[lo:hi].contiguous()


def _pad_cols(w, multiple: int):
    """A head padded with zero output columns to a multiple of ``multiple``."""
    n = w["qt"].shape[0] if decoder._is_pack(w) else w.shape[1]
    pad = -n % multiple
    if not pad:
        return w
    if decoder._is_pack(w):
        return {"qt": torch.cat([w["qt"], w["qt"].new_zeros(pad, w["qt"].shape[1])]),
                "s": torch.cat([w["s"], w["s"].new_ones(pad)]), "tiled": False}
    return torch.cat([w, w.new_zeros(w.shape[0], pad)], 1)


def split_fused(layer: dict, cfg: decoder.DecoderConfig) -> dict:
    """A layer with its fused ``wqkv`` / ``bqkv`` cut back into ``wq``,
    ``wk``, ``wv`` (and biases) and ``w_gu`` into ``w_gate`` / ``w_up``: the
    fused N layout interleaves q|k|v across column shards. Slicing a pack's
    columns equals quantizing the slice (scales are per output column), so
    the pieces are the packs ``fuse=False`` would have made."""
    out = dict(layer)
    q, kv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    if "wqkv" in out:
        w, b = out.pop("wqkv"), out.pop("bqkv", None)
        for name, lo, hi in (("q", 0, q), ("k", q, q + kv), ("v", q + kv, q + 2 * kv)):
            out["w" + name] = _cols(w, lo, hi)
            if b is not None:
                out["b" + name] = _vec(b, lo, hi)
    if "w_gu" in out:
        w, ff = out.pop("w_gu"), cfg.d_ff
        out["w_gate"], out["w_up"] = _cols(w, 0, ff), _cols(w, ff, 2 * ff)
    return out


def shard_decoder_params(params: dict, cfg: decoder.DecoderConfig, mesh: Mesh, axis: str = "model") -> dict:
    """This rank's tree of ``params`` (the port's decoder tree, dense,
    int8 or mixed, fused or not) in the Megatron layout over ``axis``.

    Column-parallel: ``wq`` / ``wk`` / ``wv`` (this rank's query and kv
    heads), ``w_up`` / ``w_gate`` (its d_ff slice), their biases with them;
    row-parallel: ``wo`` and ``w_down`` (the matching K slice), their scales
    and biases whole; replicated: norms and ``pos_emb``; ``tok_emb`` by
    vocab rows and the head (``lm_head`` / ``lm_head_q``) by columns, each
    zero-padded to a multiple of the axis size first. Fused ``wqkv`` /
    ``w_gu`` are cut apart first (``split_fused``).

    An int8 pack ``{"qt": int8 [N, K], "s": f32 [N]}`` is sliced logically
    as the ``[K, N]`` codes it holds: columns are ``qt`` rows with their
    scales, K rows are ``qt`` columns. Because a scale belongs to an output
    column, the slice of the quantized matrix equals the quantized slice."""
    m, i = mesh.axis_size(axis), mesh.axis_index(axis)
    local_config(cfg, mesh, axis)  # the heads divide
    if cfg.d_ff % m:
        raise ValueError(f"d_ff {cfg.d_ff} is not a multiple of the {axis} axis ({m})")
    hd = cfg.head_dim
    q, kv, ff = cfg.n_heads * hd // m, cfg.kv_heads * hd // m, cfg.d_ff // m
    col_width = {"wq": q, "wk": kv, "wv": kv, "w_up": ff, "w_gate": ff}
    bias_of = {"bq": "wq", "bk": "wk", "bv": "wv", "b_up": "w_up"}
    row_width = {"wo": q, "w_down": ff}

    def layer_shard(layer):
        out = {}
        for key, val in split_fused(layer, cfg).items():
            if key in col_width:
                out[key] = _cols(val, i * col_width[key], (i + 1) * col_width[key])
            elif key in bias_of:
                n = col_width[bias_of[key]]
                out[key] = _vec(val, i * n, (i + 1) * n)
            elif key in row_width:
                out[key] = _rows(val, i * row_width[key], (i + 1) * row_width[key])
            else:  # norms, bo, b_down
                out[key] = val
        return out

    emb = params["tok_emb"]
    pad = -emb.shape[0] % m
    if pad:
        emb = torch.cat([emb, emb.new_zeros(pad, emb.shape[1])])
    v = emb.shape[0] // m
    out = {k: val for k, val in params.items() if k not in ("layers", "tok_emb", "lm_head", "lm_head_q", "slabs")}
    out["tok_emb"] = emb[i * v:(i + 1) * v].contiguous()
    for key in ("lm_head", "lm_head_q"):
        if key in params:
            head = _pad_cols(params[key], m)
            n = (head["qt"].shape[0] if decoder._is_pack(head) else head.shape[1]) // m
            out[key] = _cols(head, i * n, (i + 1) * n)
    out["layers"] = [layer_shard(layer) for layer in params["layers"]]
    return out


def init_cache(cfg: decoder.DecoderConfig, batch: int, max_len: int | None, mesh: Mesh) -> dict:
    """This rank's KV cache (``decoder.init_cache``'s kinds): its ``batch /
    data`` rows and ``kv_heads / model`` heads, on the mesh's device; the
    JAX package's ``shard_cache`` of a whole cache."""
    d = mesh.shape.get("data", 1)
    if batch % d:
        raise ValueError(f"batch {batch} is not a multiple of the data axis ({d})")
    return decoder.init_cache(local_config(cfg, mesh), batch // d, max_len, device=mesh.device)
