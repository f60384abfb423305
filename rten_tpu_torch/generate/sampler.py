"""Token samplers: logits [B, vocab] → token ids int32 [B].

Counterpart of ``rten_tpu/generate/sampler.py`` (``Sampler`` :13,
``ArgMaxSampler`` :30, ``TemperatureSampler`` :35, ``TopKSampler`` :53,
``TopPSampler`` :74). A sampler takes an explicit ``torch.Generator`` for
its randomness and is hashable on its configuration (``_key``), so that a
captured generation graph can be cached on it (``decoder.generate_scan``).

The random samplers draw as ``jax.random.categorical`` does (Gumbel-max),
split in two parts:

- ``choose(logits, gumbel)``, a deterministic rule: the argmax of
  ``scores(logits, gumbel)``, the sampler's scaled (and cut) f32 logits
  plus the Gumbel noise, whose shape ``noise_shape(logits)`` gives ([B, V],
  or [B, k] over the top-k values, scattered back to their columns);
- ``sample(rng, logits)``: ``gumbel = -log(-log(u))`` with ``u`` uniform
  from ``rng`` on the logits' device, clamped below at f32's ``tiny``, then
  ``choose``.

The noise is f32 whatever the model dtype (the port's logits are f32);
the JAX package's TopK and TopP draw theirs in the logits' dtype.
"""

from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


def gumbel(rng: torch.Generator, shape, device) -> torch.Tensor:
    """f32 Gumbel noise ``-log(-log(u))``, ``u`` uniform in [tiny, 1) from
    ``rng`` (``jax.random.gumbel``'s "low" mode)."""
    u = torch.rand(shape, generator=rng, device=device, dtype=torch.float32).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


def _scaled(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """f32 logits over ``max(temperature, 1e-6)``, an IEEE division by a
    device scalar (CUDA's division by a host scalar multiplies by its
    reciprocal)."""
    t = torch.full((), max(temperature, 1e-6), dtype=torch.float32, device=logits.device)
    return logits.float() / t


class Sampler:
    """Base of the samplers: ``sample(rng, logits [B, vocab]) -> int32 [B]``."""

    def _key(self) -> tuple:
        return (type(self).__name__,)

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, Sampler) and self._key() == other._key()

    def sample(self, rng: torch.Generator | None, logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ArgMaxSampler(Sampler):
    """Greedy decoding. ``Generator`` hands it to the backend, whose lm_head
    kernel takes the argmax itself (``lm_head_mode="argmax"``); ``sample``
    is the same rule on logits: the first index among equal maxima."""

    def sample(self, rng, logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)


class _GumbelSampler(Sampler):
    """A random sampler: ``sample`` draws the noise and calls ``choose``."""

    def noise_shape(self, logits: torch.Tensor) -> tuple:
        return tuple(logits.shape)

    def scores(self, logits: torch.Tensor, gumbel_noise: torch.Tensor) -> torch.Tensor:
        """The perturbed f32 scores [B, V] whose argmax is the choice."""
        raise NotImplementedError

    def choose(self, logits: torch.Tensor, gumbel_noise: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.scores(logits, gumbel_noise), dim=-1).to(torch.int32)

    def sample(self, rng, logits):
        if rng is None:
            raise ValueError(f"{type(self).__name__} requires an rng (a torch.Generator)")
        return self.choose(logits, gumbel(rng, self.noise_shape(logits), logits.device))


class TemperatureSampler(_GumbelSampler):
    """Temperature sampling over the full vocabulary: the one random sampler
    speculative decoding verifies exactly (``Generator.with_draft``)."""

    def __init__(self, temperature: float = 1.0):
        self.temperature = temperature

    def _key(self):
        return (type(self).__name__, self.temperature)

    def scores(self, logits, gumbel_noise):
        return _scaled(logits, self.temperature) + gumbel_noise


class TopKSampler(_GumbelSampler):
    """Sample among the k largest logits with temperature: noise [B, k] over
    the top-k values (sorted descending), scattered back to their columns
    (the others score -inf)."""

    def __init__(self, k: int = 50, temperature: float = 1.0):
        self.k = k
        self.temperature = temperature

    def _key(self):
        return (type(self).__name__, self.k, self.temperature)

    def noise_shape(self, logits):
        return (*logits.shape[:-1], self.k)

    def scores(self, logits, gumbel_noise):
        vals, idx = torch.topk(logits.float(), self.k, dim=-1, sorted=True)
        out = torch.full(logits.shape, float("-inf"), dtype=torch.float32, device=logits.device)
        return out.scatter_(-1, idx, _scaled(vals, self.temperature) + gumbel_noise)


class TopPSampler(_GumbelSampler):
    """Nucleus sampling: the tokens whose logit reaches the cutoff, the
    smallest logit of the sorted prefix in which each token's preceding
    cumulative mass is below p (ties at the cutoff kept)."""

    def __init__(self, p: float = 0.9, temperature: float = 1.0):
        self.p = p
        self.temperature = temperature

    def _key(self):
        return (type(self).__name__, self.p, self.temperature)

    def scores(self, logits, gumbel_noise):
        scaled = _scaled(logits, self.temperature)
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < self.p
        inf = torch.full((), float("inf"), device=logits.device)
        cutoff = torch.where(keep, sorted_logits, inf).min(dim=-1, keepdim=True).values
        return torch.where(scaled >= cutoff, scaled, -inf) + gumbel_noise
