"""Collective matmuls with the collective overlapped, as rings of
point-to-point transfers.

Counterpart of ``rten_tpu/parallel/overlap.py``: the whole-tensor
collective around a sharded matmul becomes ``p`` ring steps, each step's
chunk matmul running while the next chunk's transfer is in flight
(``Mesh.ppermute``: ``batch_isend_irecv``, waited after the matmul). Every
rank of ``axis`` calls them with its own shard (SPMD). The results equal
the unfused collective and matmul pair; the products are plain matmuls in
IEEE f32 (``ieee.matmul``), as the JAX package leaves them to XLA.

- ``allgather_matmul``: X sharded on rows, W replicated; ``all_gather(X) @ W``.
- ``matmul_reducescatter``: X and W sharded on the contraction dim; this
  rank's column chunk of ``psum(X_p @ W_p)``.
- ``matmul_allreduce``: the reduce-scatter ring, then an all-gather of the
  chunks: ``psum(X_p @ W_p)`` on every rank.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.models import ieee


def allgather_matmul(x_shard, w, mesh, axis: str = "model"):
    """``all_gather(x, rows) @ w`` with the gather overlapped. x_shard:
    [M/p, K], this rank's rows; w: [K, N], the same on every rank. Returns
    [M, N], rows in rank order."""
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    mc = x_shard.shape[0]
    out = torch.empty((mc * p, w.shape[1]), dtype=torch.promote_types(x_shard.dtype, w.dtype),
                      device=x_shard.device)
    x_cur = x_shard.contiguous()
    for i in range(p):
        src = (idx - i) % p  # the chunk in hand came from rank idx - i
        pending = mesh.ppermute(x_cur, axis) if i < p - 1 else None
        out[src * mc:(src + 1) * mc] = ieee.matmul(x_cur, w)
        if pending is not None:
            x_cur = pending.wait()
    return out


def matmul_reducescatter(x_shard, w_shard, mesh, axis: str = "model"):
    """This rank's column chunk of ``psum(x_shard @ w_shard)``, the
    reduction a ring. x_shard: [M, K/p]; w_shard: [K/p, N] (N a multiple of
    p). Returns [M, N/p], chunk ``idx`` — the JAX package's
    ``psum_scatter(..., scatter_dimension=1, tiled=True)``.

    Ring invariant: after step i the sum in hand holds the partials of
    ranks idx-i..idx for chunk (idx + p-1-i) mod p; each step sends it on
    while the next chunk's matmul runs."""
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    n = w_shard.shape[1]
    if n % p:
        raise ValueError(f"N {n} is not a multiple of the {axis} axis ({p})")
    chunk = n // p

    def col(j):
        return ieee.matmul(x_shard, w_shard[:, j * chunk:(j + 1) * chunk])

    acc = col((idx - 1) % p)
    for i in range(1, p):
        pending = mesh.ppermute(acc.contiguous(), axis)
        local = col((idx + 2 * p - 1 - i) % p)
        acc = pending.wait() + local
    return acc


def matmul_allreduce(x_shard, w_shard, mesh, axis: str = "model"):
    """``psum(x_shard @ w_shard)`` on every rank: the reduce-scatter ring,
    then a tiled all-gather of the chunks — the overlapped replacement for
    the row-parallel all-reduce."""
    return mesh.all_gather(matmul_reducescatter(x_shard, w_shard, mesh, axis), axis, dim=1)
