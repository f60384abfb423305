"""Token samplers: logits [B, vocab] → token ids int32 [B].

Counterpart of ``rten_tpu/generate/sampler.py`` (``Sampler``,
``ArgMaxSampler``). The other samplers (temperature, top-k, top-p) are not
ported yet. A sampler takes a ``torch.Generator`` for its randomness.
"""

from __future__ import annotations

import torch


class Sampler:
    """Base of the samplers: ``sample(rng, logits [B, vocab]) -> int32 [B]``."""

    def sample(self, rng: torch.Generator | None, logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ArgMaxSampler(Sampler):
    """Greedy decoding. ``Generator`` hands it to the backend, whose lm_head
    kernel takes the argmax itself (``lm_head_mode="argmax"``); ``sample``
    is the same rule on logits: the first index among equal maxima."""

    def sample(self, rng, logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
