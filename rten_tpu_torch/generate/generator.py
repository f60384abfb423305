"""The autoregressive generation loop over the port's decoder.

Counterpart of ``rten_tpu/generate/generator.py`` (``GeneratorConfig``,
``NativeBackend``, ``Generator``): the iterator keeps ``with_prompt``,
``append_prompt``, ``with_sampler``, ``on_token``, ``profile``, EOS and
``max_tokens``. Speculative decoding (``with_draft``), ``GraphBackend`` and
``EncDecBackend`` are not ported yet.

A prompt, and every follow-up chunk of ``append_prompt``, goes into the
cache as one ``decoder.prefill`` forward (the prefill kernels above 8 rows);
each later token is one decode step. With the default ``ArgMaxSampler`` the
backend returns the greedy token from the lm_head kernel's fused argmax,
so no logits row leaves the card; other samplers get the f32 logits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from rten_tpu_torch.generate.metrics import Metrics
from rten_tpu_torch.generate.sampler import ArgMaxSampler, Sampler
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import decoder


@dataclasses.dataclass
class GeneratorConfig:
    max_tokens: int = 128
    eos_tokens: tuple[int, ...] = ()
    seed: int = 0


class NativeBackend:
    """Backend over ``rten_tpu_torch.models.decoder`` (params, cfg) with its
    own KV cache on ``device``."""

    def __init__(self, params, cfg, batch: int = 1, max_len: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len or cfg.max_seq
        self.reset()

    def reset(self) -> None:
        self.cache = decoder.init_cache(self.cfg, self.batch, self.max_len, self.device)
        self.length = 0  # tokens in the cache, every row

    def _step(self, tokens: np.ndarray, greedy: bool) -> torch.Tensor:
        """All of ``tokens`` [B, T] in one forward; the lm_head runs on the
        last position only."""
        tokens = np.asarray(tokens, np.int32)
        if self.length + tokens.shape[1] > self.max_len:
            raise ValueError(
                f"KV cache full: {self.length} + {tokens.shape[1]} tokens > max_len {self.max_len}"
            )
        ids = torch.from_numpy(tokens).to(self.device)
        out, self.cache = decoder.prefill(
            self.params, self.cfg, ids, self.cache,
            lm_head_mode="argmax" if greedy else "logits", last_only=True,
        )
        self.length += tokens.shape[1]
        return out[:, -1]

    def prefill(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed a prompt [B, T]; returns the last position's f32 logits
        [B, vocab], or its greedy tokens int32 [B] with ``greedy``."""
        return self._step(tokens, greedy)

    def decode(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed the next tokens [B, T ≥ 1]; returns as ``prefill``."""
        return self._step(tokens, greedy)


class Generator:
    """Iterator over generated token ids (one int32 [B] array per step).

        gen = Generator(backend).with_prompt(prompt_ids).profile(metrics)
        for token in itertools.islice(gen, 50): ...
    """

    def __init__(self, backend, config: GeneratorConfig | None = None):
        self.backend = backend
        self.config = config or GeneratorConfig()
        self.sampler: Sampler = ArgMaxSampler()
        self.metrics: Metrics | None = None
        self._pending: np.ndarray | None = None
        self._rng = torch.Generator(device=backend.device).manual_seed(self.config.seed)
        self._emitted = 0
        self._finished = False
        self._first = True
        self._on_token: Callable[[np.ndarray], None] | None = None

    def with_prompt(self, prompt) -> "Generator":
        arr = np.asarray(prompt, np.int32)
        if arr.ndim == 1:
            arr = arr[None, :]
        self._pending = arr
        return self

    def append_prompt(self, prompt) -> "Generator":
        """Add follow-up prompt tokens mid-conversation. The not-yet-fed last
        sampled token is prepended so the model sees the full history."""
        arr = np.asarray(prompt, np.int32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if self._pending is None and not self._first:
            self._pending = np.concatenate([self._last[:, None], arr], axis=1)
        elif self._pending is not None:
            self._pending = np.concatenate([self._pending, arr], axis=1)
        else:
            self._pending = arr
        self._finished = False
        return self

    def with_sampler(self, sampler: Sampler) -> "Generator":
        self.sampler = sampler
        return self

    def profile(self, metrics: Metrics) -> "Generator":
        self.metrics = metrics
        return self

    def on_token(self, cb: Callable[[np.ndarray], None]) -> "Generator":
        self._on_token = cb
        return self

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._finished or self._emitted >= self.config.max_tokens:
            raise StopIteration
        if self.metrics:
            self.metrics.start_step()
        if self._pending is not None:
            tokens, self._pending = self._pending, None
        else:
            tokens = self._last[:, None]
        greedy = isinstance(self.sampler, ArgMaxSampler)
        step = self.backend.prefill if self._first else self.backend.decode
        out = step(tokens, greedy=greedy)
        self._first = False
        if not greedy:
            out = self.sampler.sample(self._rng, out)
        next_tokens = out.cpu().numpy().astype(np.int32)  # waits for the device
        if self.metrics:
            self.metrics.end_step()
        self._last = next_tokens
        self._emitted += 1
        if self.config.eos_tokens and bool(np.all(np.isin(next_tokens, self.config.eos_tokens))):
            self._finished = True
        if self._on_token:
            self._on_token(next_tokens)
        return next_tokens
