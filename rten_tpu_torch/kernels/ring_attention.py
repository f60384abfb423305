"""Ring attention: attention with the sequence split over a mesh axis,
the kv blocks passed around the ring while each rank attends to the block
in hand.

Counterpart of ``rten_tpu/kernels/ring_attention.py`` (plain jnp with
``ppermute``; it has no Pallas kernel, and neither has this: PyTorch
products in f32 with the ring of transfers, ``Mesh.ppermute``). Each rank
holds q [B, H, Tq/p, D] and k, v [B, H, Tkv/p, D] at its index along the
axis; the online-softmax carry (running max ``m``, sum ``l``, f32 ``acc``)
crosses the ranks as the flash-attention correction crosses tiles, and
after p steps every query has seen every kv position. Step i's block
arrives while step i-1 computes: the transfer starts before the step's
products and is waited after them. The result equals full causal (or
full) attention over the gathered sequence.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.models.ieee import ieee_f32

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def ring_attention(q, k, v, mesh, axis: str = "model", *, causal: bool = True, sm_scale: float | None = None):
    """This rank's [B, H, Tq/p, D] rows of attention over the whole
    sequence, in q's dtype. Masked scores are ``DEFAULT_MASK_VALUE`` (the
    JAX package's, finite), and a row whose sum ``l`` stays 0 divides by 1."""
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    dev = q.device
    q_pos = idx * tq + torch.arange(tq, device=dev)
    qf = q.float()
    m = torch.full((b, h, tq, 1), float("-inf"), device=dev)
    l = torch.zeros((b, h, tq, 1), device=dev)
    acc = torch.zeros((b, h, tq, d), device=dev)
    kv = torch.stack([k, v])  # one transfer a step carries both
    with ieee_f32():  # IEEE f32 products whatever the caller's TF32 flags
        for i in range(p):
            pending = mesh.ppermute(kv, axis) if i < p - 1 else None
            src = (idx - i) % p  # the block in hand came from rank idx - i
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kv[0].float()) * sm_scale
            if causal:
                kv_pos = src * tkv + torch.arange(tkv, device=dev)
                s = torch.where(kv_pos[None, :] <= q_pos[:, None], s, DEFAULT_MASK_VALUE)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            prob = torch.exp(s - m_next)
            l = alpha * l + prob.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", prob, kv[1].float())
            m = m_next
            if pending is not None:
                kv = pending.wait()
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype)


def ring_attention_sharded(mesh, q, k, v, *, axis: str = "model", causal: bool = True):
    """q, k, v [B, H, T, D] (the same on every rank of ``axis``) split on
    the sequence over ``axis``, ``ring_attention`` on each rank's slice, and
    the result gathered: [B, H, T, D] on every rank."""
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    t = q.shape[2]
    if t % p or k.shape[2] % p:
        raise ValueError(f"sequence {t} does not split over {p} ranks")

    def mine(x):
        n = x.shape[2] // p
        return x[:, :, idx * n:(idx + 1) * n]

    out = ring_attention(mine(q), mine(k), mine(v), mesh, axis, causal=causal)
    return mesh.all_gather(out.contiguous(), axis, dim=2)
