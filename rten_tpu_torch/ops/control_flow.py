"""Control flow: If (counterpart of ``rten_tpu/ops/control_flow.py``).

With a static condition, and with any condition in interpret mode, only
the taken branch runs. With a condition that derives from a graph input in
compile mode both branches run and ``torch.where`` selects on the device,
as ``lax.cond`` does under jit: both branches must produce the same shapes
and dtypes.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.ops.registry import OpError, is_static, register, require_static


@register("If")
def if_(ctx, attrs, cond):
    then_branch = attrs.get("then_branch")
    else_branch = attrs.get("else_branch")
    if then_branch is None or else_branch is None:
        raise OpError("If requires then/else subgraphs")
    if ctx.run_subgraph is None:
        raise OpError("If requires a subgraph-capable executor")

    if ctx.mode == "eager" or is_static(cond):
        taken = then_branch if require_static(cond, "If condition").reshape(()).item() else else_branch
        return tuple(ctx.run_subgraph(taken))

    take = cond.reshape(()) != 0
    outs = []
    for t, e in zip(ctx.run_subgraph(then_branch, on_device=True), ctx.run_subgraph(else_branch, on_device=True)):
        if t.shape != e.shape or t.dtype != e.dtype:
            raise OpError(f"If branches differ: {tuple(t.shape)} {t.dtype} and {tuple(e.shape)} {e.dtype}")
        outs.append(torch.where(take, t, e))
    return tuple(outs)
