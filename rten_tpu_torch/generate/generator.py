"""The autoregressive generation loop over the port's decoder.

Counterpart of ``rten_tpu/generate/generator.py`` (``GeneratorConfig``,
``NativeBackend``, ``Generator``): the iterator keeps ``with_prompt``,
``append_prompt``, ``with_sampler``, ``with_draft``, ``on_token``,
``profile``, EOS and ``max_tokens``. ``EncDecBackend`` drives the
Whisper-class encoder-decoder (``models.encoder_decoder``) through the same
iterator; ``GraphBackend`` and ``backend_for_model`` are not ported yet.

A prompt, and every follow-up chunk of ``append_prompt``, goes into the
cache as one ``decoder.prefill`` forward (the prefill kernels above 8 rows);
each later token is one decode step. With the default ``ArgMaxSampler`` the
backend returns the greedy token from the lm_head kernel's fused argmax,
so no logits row leaves the card; any other sampler gets the f32 logits
and draws from the generator's ``torch.Generator`` (seeded from
``GeneratorConfig.seed``, on the backend's device).

``with_draft`` turns on speculative decoding (``generate/speculative.py``):
a draft ``NativeBackend`` proposes k tokens a round, the target verifies
them in one forward, and the iterator serves one token per ``__next__``
from per-row buffers refilled ``rounds_per_call`` rounds at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from rten_tpu_torch.generate import speculative
from rten_tpu_torch.generate.metrics import Metrics
from rten_tpu_torch.generate.sampler import ArgMaxSampler, Sampler, TemperatureSampler
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import decoder, encoder_decoder


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


class EncDecBackendFactory:
    """Carries an encoder-decoder's params and cfg; called with an
    utterance's encoder input (audio features) it makes the
    ``EncDecBackend`` for it (the JAX package's ``backend_for_model``
    returns one for a lifted encoder-decoder graph)."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg

    def __call__(self, encoder_input, max_len: int | None = None, device="cuda"):
        return EncDecBackend(self.params, self.cfg, encoder_input, max_len=max_len, device=device)


class EncDecBackend:
    """Backend over ``rten_tpu_torch.models.encoder_decoder`` (params, cfg):
    ``encode`` once per utterance (the mel ``encoder_input`` [B, n_mels,
    T_audio], here in the constructor), the cross K/V with it, then
    prefill / decode over the self-attention cache of ``max_len`` (default
    ``max_text_ctx``) positions on ``device``. ``reset`` starts the text
    anew over the same utterance."""

    def __init__(self, params, cfg, encoder_input, max_len: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        mel = encoder_input if isinstance(encoder_input, torch.Tensor) else torch.from_numpy(
            np.asarray(encoder_input, np.float32))
        mel = mel.to(self.device)
        self.enc_states = encoder_decoder.encode(params, cfg, mel)
        self.batch = self.enc_states.shape[0]
        self.max_len = max_len or cfg.max_text_ctx
        self.reset()

    def reset(self) -> None:
        self.state = encoder_decoder.init_decoder_state(self.params, self.cfg, self.enc_states, self.max_len)
        self.length = 0  # tokens in the self-attention cache, every row

    def _step(self, tokens: np.ndarray, greedy: bool) -> torch.Tensor:
        tokens = np.asarray(tokens, np.int32)
        if self.length + tokens.shape[1] > self.max_len:
            raise ValueError(f"KV cache full: {self.length} + {tokens.shape[1]} tokens > max_len {self.max_len}")
        ids = torch.from_numpy(tokens).to(self.device)
        out, self.state = encoder_decoder.decode(self.params, self.cfg, ids, self.state,
                                                 lm_head_mode="argmax" if greedy else "logits", last_only=True)
        self.length += tokens.shape[1]
        return out[:, -1]

    def prefill(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed the decoder prompt [B, T] as one forward; returns the last
        position's f32 logits [B, vocab], or its greedy tokens int32 [B]
        with ``greedy``."""
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
        self._draft: NativeBackend | None = None

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

    def with_draft(self, draft: NativeBackend, *, k: int = 4, rounds_per_call: int = 4) -> "Generator":
        """Speculative decoding: ``draft`` (a smaller ``NativeBackend`` of
        the same batch) proposes ``k`` tokens a round and the backend
        verifies them in one forward. One token per ``__next__`` as before,
        served from per-row buffers refilled ``rounds_per_call`` rounds at
        a time. The stream is exact: token-exact under ``ArgMaxSampler``,
        distribution-exact under ``TemperatureSampler``; any other sampler
        raises ValueError at the first refill."""
        if not isinstance(self.backend, NativeBackend) or not isinstance(draft, NativeBackend):
            raise TypeError("with_draft needs a NativeBackend target and draft (speculative rollback rewrites "
                            "the native cache's per-row lengths)")
        if draft.batch != self.backend.batch:
            raise ValueError("the draft's batch must equal the target backend's")
        self._draft = draft
        self._spec_k = k
        self._spec_rounds = rounds_per_call
        self._spec_buf: list[list[int]] | None = None
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
        if self._draft is not None:
            next_tokens = self._spec_next()
        else:
            if self._pending is not None:
                tokens, self._pending = self._pending, None
            else:
                tokens = self._last[:, None]
            step = self.backend.prefill if self._first else self.backend.decode
            self._first = False
            next_tokens = self._choose(step(tokens, greedy=self._greedy()))
        if self.metrics:
            self.metrics.end_step()
        self._last = next_tokens
        self._emitted += 1
        if self.config.eos_tokens and bool(np.all(np.isin(next_tokens, self.config.eos_tokens))):
            self._finished = True
        if self._on_token:
            self._on_token(next_tokens)
        return next_tokens

    def _greedy(self) -> bool:
        return isinstance(self.sampler, ArgMaxSampler)

    def _choose(self, out: torch.Tensor) -> np.ndarray:
        """The step's tokens on the host (waits for the device): the
        backend's greedy tokens, or the sampler's draw from its logits."""
        if not self._greedy():
            out = self.sampler.sample(self._rng, out)
        return out.cpu().numpy().astype(np.int32)

    # -- speculative decoding (with_draft) -----------------------------------

    def _spec_next(self) -> np.ndarray:
        """One step in draft mode: a prompt chunk feeds both caches (they
        stay prefix-aligned) and samples the next token from the target;
        otherwise the next buffered token, refilling the buffers when any
        row runs dry."""
        bk, dk = self.backend, self._draft
        if self._pending is not None:
            tokens, self._pending = self._pending, None
            if self._first:
                # Headroom: a refill may run rounds·(k+1) tokens past what
                # was emitted, and keeps k+2 in reserve; a cache sized for
                # plain decoding (prompt + max_tokens) would let the rounds'
                # length clamp bind mid-stream. Grow both caches up front.
                need = tokens.shape[1] + self.config.max_tokens + self._spec_rounds * (self._spec_k + 1) \
                    + self._spec_k + 2
                for nb in (bk, dk):
                    if nb.max_len < need:
                        nb.max_len = need
                        nb.reset()
                out = bk.prefill(tokens, greedy=self._greedy())
                dk.prefill(tokens, greedy=True)
                self._first = False
            else:
                # Mid-conversation: the caches hold verified tokens the
                # iterator has not emitted (still buffered). The cache holds
                # prompt + every produced token but the last, so dropping u
                # buffered tokens rolls each row's length back by u.
                if self._spec_buf is not None and any(self._spec_buf):
                    u = np.array([len(b) for b in self._spec_buf], np.int64)
                    u_dev = torch.from_numpy(u.astype(np.int32)).to(bk.device)
                    for nb in (bk, dk):
                        nb.cache["len"].sub_(u_dev)
                        nb.cache["host_len"] -= u
                        nb.length = int(nb.cache["host_len"].max())
                out = bk.decode(tokens, greedy=self._greedy())
                dk.decode(tokens, greedy=True)
            toks = self._choose(out)
            self._spec_buf = [[] for _ in range(bk.batch)]
            self._spec_last = toks
            return toks
        if any(not b for b in self._spec_buf):
            self._spec_refill()
        return np.asarray([b.pop(0) for b in self._spec_buf], np.int32)

    def _spec_refill(self) -> None:
        bk, dk = self.backend, self._draft
        # The rounds' length clamp keeps rows the host stopped reading
        # inside the cache; a live row reaching it would corrupt the
        # verified prefix, so a refill without rounds·(k+1) + k+2 positions
        # of room is refused.
        need = int(bk.cache["host_len"].max()) + self._spec_rounds * (self._spec_k + 1) + self._spec_k + 2
        if bk.max_len < need or dk.max_len < need:
            raise ValueError(
                f"speculative refill needs cache headroom {need} but max_len is {min(bk.max_len, dk.max_len)}; "
                "construct the NativeBackends with a larger max_len (or lower max_tokens / rounds_per_call)"
            )
        last = torch.from_numpy(self._spec_last[:, None].astype(np.int32)).to(bk.device)
        common = (bk.params, bk.cfg, bk.cache, dk.params, dk.cfg, dk.cache, last)
        if self._greedy():
            toks, counts, _, _, last = speculative.speculative_scan(*common, k=self._spec_k,
                                                                    n_rounds=self._spec_rounds)
        elif isinstance(self.sampler, TemperatureSampler):
            toks, counts, _, _, last = speculative.speculative_sample_scan(
                *common, self._rng, self.sampler.temperature, k=self._spec_k, n_rounds=self._spec_rounds)
        else:
            raise ValueError(
                "speculative decoding verifies ArgMaxSampler and TemperatureSampler exactly; "
                f"{type(self.sampler).__name__} would change the target distribution"
            )
        for nb in (bk, dk):
            nb.length = int(nb.cache["host_len"].max())
        for r in range(toks.shape[0]):
            for i in range(bk.batch):
                self._spec_buf[i].extend(int(t) for t in toks[r, i, : counts[r, i]])
        self._spec_last = last.view(-1).cpu().numpy().astype(np.int32)
