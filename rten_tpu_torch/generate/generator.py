"""The autoregressive generation loop over the port's decoder.

Counterpart of ``rten_tpu/generate/generator.py`` (``GeneratorConfig``,
``NativeBackend``, ``Generator``): the iterator keeps ``with_prompt``,
``append_prompt``, ``with_sampler``, ``with_draft``, ``on_token``,
``profile``, EOS and ``max_tokens``. ``EncDecBackend`` drives the
Whisper-class encoder-decoder (``models.encoder_decoder``) through the same
iterator; ``GraphBackend`` drives a graph ``Model`` (``runtime.session``)
that follows HF-Optimum naming. ``backend_for_model`` picks the backend for
a loaded graph model: ``NativeBackend`` on the params ``models.lift`` lifts
from it, an ``EncDecBackendFactory``, or ``GraphBackend``.

A prompt, and every follow-up chunk of ``append_prompt``, goes into the
cache as one ``decoder.prefill`` forward (the prefill kernels above 8 rows);
each later token is one decode step, on the card one replay of the
backend's captured graph of it (``decoder.step_graph``; the JAX package
jits its ``decode_step``). With the default ``ArgMaxSampler`` the
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
import re
import warnings
from typing import Any, Callable, Iterator

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
    own KV cache on ``device``.

    On the card a one-token ``decode`` is one replay of a captured CUDA
    graph of ``decoder.forward`` (the JAX package jits ``decode_step``),
    captured at first use for the params, cfg, batch, mode (greedy or
    logits) and cache; a prompt (T > 1) runs eagerly, as the JAX package
    compiles a prefill per prompt shape. ``decoder._capturable`` decides;
    on the CPU every step runs eagerly."""

    def __init__(self, params, cfg, batch: int = 1, max_len: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len or cfg.max_seq
        self.reset()

    def reset(self) -> None:
        """An empty cache: the old one zeroed in place where its shape is
        still ``max_len`` (its captured steps stay valid), else a new one."""
        cache = getattr(self, "cache", None)
        if cache is not None and cache["k"][0].shape[2] == self.max_len:
            _zero_cache(cache)
        else:
            self.cache = decoder.init_cache(self.cfg, self.batch, self.max_len, self.device)
        self.length = 0  # tokens in the cache, every row

    def _step(self, tokens: np.ndarray, greedy: bool) -> torch.Tensor:
        """All of ``tokens`` [B, T] in one forward; the lm_head runs on the
        last position only."""
        return _backend_step(self, decoder.forward, self.cache, tokens, greedy)

    def prefill(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed a prompt [B, T]; returns the last position's f32 logits
        [B, vocab], or its greedy tokens int32 [B] with ``greedy``."""
        return self._step(tokens, greedy)

    def decode(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed the next tokens [B, T ≥ 1]; returns as ``prefill``, a copy
        the caller may keep (a captured step's static output is copied)."""
        return self._step(tokens, greedy)


def _zero_cache(state: dict) -> None:
    """Zero a cache's self-attention leaves and lengths in place (an
    encoder-decoder state keeps its cross K/V: the same utterance's)."""
    for key, leaf in state.items():
        if isinstance(leaf, list) and key not in ("cross_k", "cross_v"):
            for t in leaf:
                t.zero_()
    state["len"].zero_()
    state["host_len"][:] = 0


def _backend_step(backend, fn, state: dict, tokens, greedy: bool) -> torch.Tensor:
    """``fn`` (the decoder's forward or the encoder-decoder's decode) of
    ``tokens`` [B, T] on ``state``, the lm_head on the last position only:
    one token a row on the card through ``decoder.step_graph``, else one
    eager forward. Advances ``backend.length``; returns [B(, vocab)]."""
    tokens = np.asarray(tokens, np.int32)
    if backend.length + tokens.shape[1] > backend.max_len:
        raise ValueError(f"KV cache full: {backend.length} + {tokens.shape[1]} tokens > max_len {backend.max_len}")
    ids = torch.from_numpy(tokens).to(backend.device)
    mode = "argmax" if greedy else "logits"
    if tokens.shape[1] == 1 and decoder._capturable(backend.device, False):
        out = decoder.step_graph(fn, backend.params, backend.cfg, ids, state, mode)
    else:
        out, _ = fn(backend.params, backend.cfg, ids, state, lm_head_mode=mode, last_only=True)
    backend.length += tokens.shape[1]
    return out[:, -1]


class EncDecBackendFactory:
    """Carries an encoder-decoder's params and cfg; called with an
    utterance's encoder input (audio features) it makes the
    ``EncDecBackend`` for it, on ``device`` (the factory's own unless the
    call names one; ``backend_for_model`` returns one for a lifted
    encoder-decoder graph)."""

    def __init__(self, params, cfg, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.device = device

    def __call__(self, encoder_input, max_len: int | None = None, device=None):
        return EncDecBackend(self.params, self.cfg, encoder_input, max_len=max_len, device=device or self.device)


class EncDecBackend:
    """Backend over ``rten_tpu_torch.models.encoder_decoder`` (params, cfg):
    ``encode`` once per utterance (the mel ``encoder_input`` [B, n_mels,
    T_audio], here in the constructor), the cross K/V with it, then
    prefill / decode over the self-attention cache of ``max_len`` (default
    ``max_text_ctx``) positions on ``device``. ``reset`` starts the text
    anew over the same utterance.

    On the card a one-token ``decode`` replays a captured CUDA graph of
    ``encoder_decoder.decode`` (the JAX package jits Whisper's
    ``decode_step``), one for the params, cfg, batch, mode and decoder
    state; a prompt runs eagerly, as ``NativeBackend``'s does."""

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
        """An empty self-attention cache over the same utterance: zeroed in
        place after the first (its captured steps stay valid)."""
        if getattr(self, "state", None) is not None:
            _zero_cache(self.state)
        else:
            self.state = encoder_decoder.init_decoder_state(self.params, self.cfg, self.enc_states, self.max_len)
        self.length = 0  # tokens in the self-attention cache, every row

    def _step(self, tokens: np.ndarray, greedy: bool) -> torch.Tensor:
        return _backend_step(self, encoder_decoder.decode, self.state, tokens, greedy)

    def prefill(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed the decoder prompt [B, T] as one forward; returns the last
        position's f32 logits [B, vocab], or its greedy tokens int32 [B]
        with ``greedy``."""
        return self._step(tokens, greedy)

    def decode(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed the next tokens [B, T ≥ 1]; returns as ``prefill``, a copy
        the caller may keep."""
        return self._step(tokens, greedy)


def backend_for_model(model, n_heads: int | None = None, batch: int = 1, device="cuda"):
    """The backend for a loaded graph model (the JAX package's
    ``backend_for_model``, ``rten_tpu/generate/generator.py:660``): lift its
    HF-named weights onto the native decoder (``models.lift.lift_decoder``:
    a ``NativeBackend`` on the dense-weight route), else onto the
    encoder-decoder (an ``EncDecBackendFactory``, to be called with each
    utterance's audio features), else the generic ``GraphBackend``. Only a
    ``LiftError`` (a graph that is not such a model) falls through; a
    lifted model that the decoder cannot run raises."""
    from rten_tpu_torch.models.lift import LiftError, lift_decoder, lift_encoder_decoder

    try:
        cfg, params = lift_decoder(model, n_heads=n_heads, device=device)
        return NativeBackend(params, cfg, batch=batch, device=device)
    except LiftError:
        pass
    try:
        cfg, params = lift_encoder_decoder(model, n_heads=n_heads, device=device)
        return EncDecBackendFactory(params, cfg, device=device)
    except LiftError:
        return GraphBackend(model)


def _len_bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


class GraphBackend:
    """Backend over a graph ``Model`` using HF-Optimum naming conventions
    (``input_ids`` / ``attention_mask`` / ``position_ids`` /
    ``past_key_values.N.key|value`` → ``logits`` / ``present.N.*``): the
    counterpart of the JAX package's ``GraphBackend``, on the model's device.

    Compiled mode: the KV state lives in PREALLOCATED padded buffers of a
    bucketed length P (one set a bucket, kept across ``reset``); every
    decode step feeds the whole buffer plus an attention_mask that marks
    [0, len) and the new tail positions valid, and runs the graph in compile
    mode (on the card: one captured CUDA graph a bucket that reads the
    buffers in place, ``RunOptions.donate_inputs``); the appended K/V are
    copied into the buffers in place. The prompt runs padded to a length
    bucket. Exact for any graph that honors attention_mask for K/V validity
    (the HF Optimum export contract); graphs without a mask input run the
    legacy exact-shape interpret path.

    ``constant_inputs`` are loop-invariant inputs (e.g. encoder states); on
    the first step the backend hoists everything derivable from them via
    ``Model.partial_run`` and feeds the frontier values back as extra inputs
    on every later run.
    """

    CACHE_PATTERNS = (
        re.compile(r"^past_key_values\.(\d+)\.(key|value)$"),
        re.compile(r"^past_key_values\.(\d+)\.(decoder|encoder)\.(key|value)$"),
    )

    def __init__(self, model, *, mode: str | None = None, constant_inputs=None):
        from rten_tpu_torch.runtime.session import RunOptions

        self.model = model
        self.device = model.device
        names = model.input_names()
        self.input_ids_name = "input_ids"
        self.attention_mask_name = "attention_mask" if "attention_mask" in names else None
        self.position_ids_name = "position_ids" if "position_ids" in names else None
        # Optimum MERGED decoder exports take an explicit branch selector:
        # 0 → compute caches fresh (first step), 1 → reuse the past inputs.
        self.use_cache_branch_name = "use_cache_branch" if "use_cache_branch" in names else None
        self.cache_inputs: list[str] = [n for n in names if any(p.match(n) for p in self.CACHE_PATTERNS)]
        out_names = model.output_names()
        if not out_names:
            raise ValueError(
                "graph declares no outputs — not a runnable generation "
                "model (note: load-time optimization sweeps constants "
                "unreachable from outputs, so a weights-only graph also "
                "loses its lift-able initializers)"
            )
        self.logits_name = "logits" if "logits" in out_names else out_names[0]
        # present.N[.decoder|.encoder].key|value → the matching past input
        # name; the .decoder/.encoder segments are kept (enc-dec exports
        # tell growing self-attention caches from static cross ones by them).
        self.cache_outputs = {
            n: n.replace("present", "past_key_values", 1) for n in out_names if n.startswith("present")
        }
        # Cross-attention (encoder) caches: computed once, never appended.
        self.static_cache = frozenset(n for n in self.cache_inputs if ".encoder." in n)
        if mode is None:
            # Compiled when the graph takes explicit position_ids, or when its
            # positions provably come from a CumSum over the attention_mask
            # (exact under the bucketed mask); a graph that derives positions
            # from the past-KV SHAPE would read the padded length.
            mode = (
                "compiled"
                if self.attention_mask_name
                and self.cache_inputs
                and (self.position_ids_name or self._positions_from_mask())
                else "interpret"
            )
            if mode == "interpret":
                why = (
                    "no attention_mask input"
                    if self.attention_mask_name is None
                    else "positions not derivable from the attention_mask "
                    "(no position_ids input and no CumSum-over-mask pattern)"
                )
                warnings.warn(
                    f"GraphBackend: falling back to EXACT-SHAPE INTERPRET "
                    f"execution ({why}) — one op-by-op dispatch per token, "
                    f"orders of magnitude slower than the compiled bucketed "
                    f"path. Re-export the graph with attention_mask/"
                    f"position_ids inputs, or pass mode='compiled' if the "
                    f"graph is mask-exact anyway.",
                    stacklevel=2,
                )
        if mode == "compiled" and self.attention_mask_name is None:
            raise ValueError(
                "GraphBackend(mode='compiled') requires the graph to take an "
                "attention_mask input (HF Optimum export contract); this "
                "graph has none — use mode='interpret'"
            )
        self.mode = mode
        self.opts = RunOptions(mode="compile", donate_inputs=True) if mode == "compiled" else RunOptions(
            mode="interpret")
        self.constant_inputs: dict[str, Any] = dict(constant_inputs or {})
        self._hoisted: dict[int, Any] | None = None
        # KV state: name → padded buffer (compiled) / exact tensor (legacy).
        self.cache: dict[str, Any] = {}
        self._buffers: dict[tuple, torch.Tensor] = {}  # (name, seq len) → a reused padded buffer
        self.seq_len = 0
        self._bucket = 0
        self._kv_meta = {name: self.model.input_shape(self.model.node_id(name)) or [] for name in self.cache_inputs}

    def _positions_from_mask(self) -> bool:
        """True when the graph's positions provably derive from the
        attention_mask: some CumSum consumes a value reachable from the mask
        input, and no Shape op reads a past-KV input."""
        from rten_tpu_torch.graph import OperatorNode

        graph = self.model.graph
        ops = [n for n in graph.nodes if isinstance(n, OperatorNode)]
        kv_ids = {self.model.node_id(n) for n in self.cache_inputs}
        if any(op.op_type == "Shape" and any(i in kv_ids for i in op.inputs if i is not None) for op in ops):
            return False
        reachable = {self.model.node_id(self.attention_mask_name)}
        changed = True
        found_cumsum = False
        while changed and not found_cumsum:
            changed = False
            for op in ops:
                ins = [i for i in op.inputs if i is not None]
                if any(i in reachable for i in ins):
                    if op.op_type == "CumSum":
                        found_cumsum = True
                        break
                    for o in op.outputs:
                        if o is not None and o not in reachable:
                            reachable.add(o)
                            changed = True
        return found_cumsum

    def reset(self) -> None:
        self.cache = {}
        self.seq_len = 0
        self._bucket = 0

    def _empty_cache_value(self, name: str, batch: int) -> np.ndarray:
        shape = list(self._kv_meta.get(name) or [])
        dims = [batch if isinstance(d, str) and "batch" in d else d for d in shape]
        dims = [0 if isinstance(d, str) or d is None else int(d) for d in dims]
        # Zero-length sequence axis: assume axis -2 is the sequence.
        if len(dims) >= 2:
            dims[-2] = 0
        return np.zeros(dims, dtype=np.float32)

    def _base_inputs(self) -> dict[Any, Any]:
        inputs: dict[Any, Any] = dict(self.constant_inputs)
        if self.constant_inputs and self._hoisted is None:
            # One-time loop-invariant hoist: partial_run evaluates everything
            # reachable from the constant inputs and hands back the frontier.
            self._hoisted = dict(self.model.partial_run(self.constant_inputs, [self.logits_name]))
        if self._hoisted:
            inputs.update(self._hoisted)
        return inputs

    # -- legacy exact-shape interpret path -----------------------------------

    def _step_legacy(self, tokens: np.ndarray) -> torch.Tensor:
        batch, t = tokens.shape
        inputs = self._base_inputs()
        inputs[self.input_ids_name] = tokens.astype(np.int32)
        new_len = self.seq_len + t
        if self.attention_mask_name:
            inputs[self.attention_mask_name] = np.ones((batch, new_len), np.int32)
        if self.position_ids_name:
            inputs[self.position_ids_name] = np.arange(self.seq_len, new_len, dtype=np.int32)[None, :].repeat(batch, 0)
        if self.use_cache_branch_name:
            inputs[self.use_cache_branch_name] = np.asarray([0 if self.seq_len == 0 else 1], np.int32)
        for name in self.cache_inputs:
            inputs[name] = self.cache.get(name)
            if inputs[name] is None:
                inputs[name] = self._empty_cache_value(name, batch)
        wanted = [self.logits_name, *self.cache_outputs.keys()]
        outs = self.model.run(inputs, wanted, self.opts)
        for out_name, vals in zip(list(self.cache_outputs.keys()), outs[1:]):
            self.cache[self.cache_outputs[out_name]] = vals
        self.seq_len = new_len
        return outs[0][:, -1, :]

    # -- compiled bucketed path ----------------------------------------------

    def _buffer(self, name: str, like: torch.Tensor, length: int) -> torch.Tensor:
        """The reused zeroed buffer of ``name`` with ``length`` positions on
        the sequence axis (-2), ``like``'s other dims and dtype."""
        shape = list(like.shape)
        shape[-2] = length
        buf = self._buffers.get((name, length))
        if buf is None or list(buf.shape) != shape or buf.dtype != like.dtype:
            buf = self._buffers[(name, length)] = torch.zeros(shape, dtype=like.dtype, device=self.device)
        else:
            buf.zero_()
        return buf

    def _grow_cache(self, target: int) -> None:
        """Move every GROWING KV buffer into its buffer of the next bucket;
        static cross-attention caches keep the encoder length."""
        for name, buf in self.cache.items():
            if name in self.static_cache:
                continue
            grown = self._buffer(name, buf, target)
            grown.narrow(-2, 0, buf.shape[-2]).copy_(buf)
            self.cache[name] = grown
        self._bucket = target

    def _step_compiled(self, tokens: np.ndarray) -> torch.Tensor:
        batch, t = tokens.shape
        L = self.seq_len

        if not self.cache:
            # Bucketed prefill: input_ids padded to a length bucket, pad
            # positions masked off; past arrives with a zero-length seq axis.
            tb = _len_bucket(t)
            ids = np.zeros((batch, tb), np.int32)
            ids[:, :t] = tokens
            mask = np.zeros((batch, tb), np.int32)
            mask[:, :t] = 1
            inputs = self._base_inputs()
            inputs[self.input_ids_name] = ids
            inputs[self.attention_mask_name] = mask
            if self.position_ids_name:
                pos = np.minimum(np.arange(tb), t - 1).astype(np.int32)
                inputs[self.position_ids_name] = pos[None, :].repeat(batch, 0)
            if self.use_cache_branch_name:
                inputs[self.use_cache_branch_name] = np.asarray([0], np.int32)
            for name in self.cache_inputs:
                inputs[name] = self._empty_cache_value(name, batch)
            wanted = [self.logits_name, *self.cache_outputs.keys()]
            outs = self.model.run(inputs, wanted, self.opts)
            self._bucket = _len_bucket(t + 1)
            for out_name, present in zip(list(self.cache_outputs.keys()), outs[1:]):
                key = self.cache_outputs[out_name]
                if key in self.static_cache:
                    # Cross-attn cache: encoder-length seq axis, stored exactly.
                    buf = self._buffer(key, present, present.shape[-2])
                    buf.copy_(present)
                    self.cache[key] = buf
                    continue
                # Only the first t seq entries are real; the padding beyond
                # stays masked until overwritten by decode appends.
                buf = self._buffer(key, present, self._bucket)
                buf.narrow(-2, 0, present.shape[-2]).copy_(present)
                self.cache[key] = buf
            self.seq_len = t
            return outs[0][:, t - 1, :]

        if L + t > self._bucket:
            self._grow_cache(_len_bucket(L + t))
        P = self._bucket

        # Valid columns: the real prefix [0, L) plus the t new tail positions.
        mask = np.zeros((batch, P + t), np.int32)
        mask[:, :L] = 1
        mask[:, P:] = 1
        inputs = self._base_inputs()
        inputs[self.input_ids_name] = tokens.astype(np.int32)
        inputs[self.attention_mask_name] = mask
        if self.position_ids_name:
            inputs[self.position_ids_name] = np.arange(L, L + t, dtype=np.int32)[None, :].repeat(batch, 0)
        if self.use_cache_branch_name:
            inputs[self.use_cache_branch_name] = np.asarray([1], np.int32)
        for name in self.cache_inputs:
            inputs[name] = self.cache[name]
        # Static cross-attn presents are identical every step — don't ask the
        # program to rematerialize them after prefill.
        growing_outs = [n for n in self.cache_outputs if self.cache_outputs[n] not in self.static_cache]
        wanted = [self.logits_name, *growing_outs]
        outs = self.model.run(inputs, wanted, self.opts)
        for out_name, present in zip(growing_outs, outs[1:]):
            # The in-place append: the new tail into [L, L + t) of the buffer.
            key = self.cache_outputs[out_name]
            self.cache[key].narrow(-2, L, t).copy_(present.narrow(-2, P, t))
        self.seq_len = L + t
        return outs[0][:, -1, :]

    def _step(self, tokens: np.ndarray, greedy: bool) -> torch.Tensor:
        tokens = np.asarray(tokens, np.int32)
        logits = self._step_compiled(tokens) if self.mode == "compiled" else self._step_legacy(tokens)
        # The greedy token: the lowest index among equal maxima.
        return torch.argmax(logits, dim=-1).to(torch.int32) if greedy else logits

    def prefill(self, tokens: np.ndarray, *, greedy: bool = False) -> torch.Tensor:
        """Feed a prompt [B, T]; returns the last position's logits [B,
        vocab] on the model's device, or its greedy tokens int32 [B] with
        ``greedy``."""
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
