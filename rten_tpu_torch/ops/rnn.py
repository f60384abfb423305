"""LSTM / GRU: counterpart of ``rten_tpu/ops/rnn.py``.

The input projection X·W^T of the whole sequence is one matmul before the
time loop; the recurrent H·R^T runs a step at a time, both in IEEE f32
(``models.ieee``), in the JAX package's order. Gate orders follow ONNX:
LSTM [i,o,f,c], GRU [z,r,h]. Forward, reverse and bidirectional.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.models.ieee import ieee_f32
from rten_tpu_torch.ops.registry import OpError, register


def _directions(attrs) -> list[bool]:
    d = attrs.get("direction", "forward")
    if d == "forward":
        return [False]
    if d == "reverse":
        return [True]
    if d == "bidirectional":
        return [False, True]
    raise OpError(f"unknown RNN direction {d!r}")


def _input_gates(xs, wd):
    """``einsum("sbi,gi->sbg")`` of the whole sequence."""
    return torch.einsum("sbi,gi->sbg", xs, wd)


@register("LSTM")
def lstm(ctx, attrs, x, w, r, b=None, seq_lens=None, initial_h=None, initial_c=None):
    if seq_lens is not None:
        raise OpError("LSTM sequence_lens input is not supported")
    hidden = int(attrs.get("hidden_size") or r.shape[-1])
    seq, batch, _ = x.shape

    ys, hs, cs = [], [], []
    with ieee_f32():
        for di, reverse in enumerate(_directions(attrs)):
            wd, rd = w[di], r[di]
            wb = rb = 0.0
            if b is not None:
                wb, rb = b[di][: 4 * hidden], b[di][4 * hidden:]
            h = initial_h[di] if initial_h is not None else torch.zeros((batch, hidden), dtype=x.dtype, device=x.device)
            c = initial_c[di] if initial_c is not None else torch.zeros((batch, hidden), dtype=x.dtype, device=x.device)
            xs = torch.flip(x, dims=(0,)) if reverse else x
            gates_x = _input_gates(xs, wd) + wb
            y = []
            for step in range(seq):
                g = gates_x[step] + h @ rd.t() + rb
                i, o, f, c_hat = torch.chunk(g, 4, dim=-1)
                i, o, f = torch.sigmoid(i), torch.sigmoid(o), torch.sigmoid(f)
                c = f * c + i * torch.tanh(c_hat)
                h = o * torch.tanh(c)
                y.append(h)
            y = torch.stack(y, dim=0) if y else gates_x.new_zeros((0, batch, hidden))
            if reverse:
                y = torch.flip(y, dims=(0,))
            ys.append(y)
            hs.append(h)
            cs.append(c)
    return torch.stack(ys, dim=1), torch.stack(hs, dim=0), torch.stack(cs, dim=0)


@register("GRU")
def gru(ctx, attrs, x, w, r, b=None, seq_lens=None, initial_h=None):
    if seq_lens is not None:
        raise OpError("GRU sequence_lens input is not supported")
    hidden = int(attrs.get("hidden_size") or r.shape[-1])
    linear_before_reset = bool(attrs.get("linear_before_reset", False))
    seq, batch, _ = x.shape

    ys, hs = [], []
    with ieee_f32():
        for di, reverse in enumerate(_directions(attrs)):
            wd, rd = w[di], r[di]
            wb = torch.zeros((3 * hidden,), dtype=x.dtype, device=x.device)
            rb = torch.zeros((3 * hidden,), dtype=x.dtype, device=x.device)
            if b is not None:
                wb, rb = b[di][: 3 * hidden], b[di][3 * hidden:]
            h = initial_h[di] if initial_h is not None else torch.zeros((batch, hidden), dtype=x.dtype, device=x.device)
            xs = torch.flip(x, dims=(0,)) if reverse else x
            gates_x = _input_gates(xs, wd) + wb
            rz, rr, rh = rd[:hidden], rd[hidden: 2 * hidden], rd[2 * hidden:]
            rbz, rbr, rbh = rb[:hidden], rb[hidden: 2 * hidden], rb[2 * hidden:]
            y = []
            for step in range(seq):
                gxz, gxr, gxh = torch.chunk(gates_x[step], 3, dim=-1)
                z = torch.sigmoid(gxz + h @ rz.t() + rbz)
                rt = torch.sigmoid(gxr + h @ rr.t() + rbr)
                if linear_before_reset:
                    h_hat = torch.tanh(gxh + rt * (h @ rh.t() + rbh))
                else:
                    h_hat = torch.tanh(gxh + (rt * h) @ rh.t() + rbh)
                h = (1.0 - z) * h_hat + z * h
                y.append(h)
            y = torch.stack(y, dim=0) if y else gates_x.new_zeros((0, batch, hidden))
            if reverse:
                y = torch.flip(y, dims=(0,))
            ys.append(y)
            hs.append(h)
    return torch.stack(ys, dim=1), torch.stack(hs, dim=0)
