"""Continuous-batching inference engine over the port's decoder.

Counterpart of ``rten_tpu/serve/engine.py`` (``Request`` :39,
``_decode_k_steps`` :89, ``ServingEngine`` :152): a fixed batch of KV-cache
slots; requests are admitted into free slots (a prefill writes the slot's
row of the engine cache), every tick runs ``steps_per_tick`` batched decode
forwards across all slots, and finished requests retire and free their
slot at once.

- **Admission** prefills the prompt at its exact length, as one forward on
  a batch-1 view of the slot's row (``decoder.row_view``), so the k/v go
  straight into the engine cache. (The JAX package pads to a bucket to
  compile once, then splices a batch-1 cache into the slot.) Under W8A8
  that forward takes the prefill structure at any length, as the JAX
  engine's does (``prefill_first_token``).
- **Sampling.** Greedy (``ArgMaxSampler``, the default) takes each token
  from the lm_head kernel's fused argmax. Any other sampler gets the f32
  logits, of the prompt's last position at admission and of each tick
  forward, and draws from the engine's ``torch.Generator`` (seeded from
  ``seed``), so one seed gives the same streams.
- **A tick** is ``steps_per_tick`` forwards, each sampled on the device;
  EOS, the token budget and the active mask are decided on the device,
  and the tick's tokens and active flags reach the host in one copy at its
  end. On the card the tick is one replay of a CUDA graph captured once a
  (cache, K, EOS width, sampler): the counterpart of the JAX engine's one
  ``lax.scan`` program. An inactive row's device length is pinned to 0, so
  its append lands at position 0 of a dead slot; the host mirror of the
  lengths (``cache["host_len"]``) is pinned by the same rule less EOS,
  which the host does not see until the tick ends: it stays at least the
  device's.
- ``run_pipelined`` dispatches the next tick from the device-side carry
  (last token, active mask, budget) before the host reads this one.

Any number of slots: a tick's forwards take the fused decode structure
up to 8 rows and the prefill structure above, each with its cache's KV
kernel.

**Under a mesh** (``mesh=``, a ``parallel.mesh.Mesh`` with ``data`` and
``model`` axes) the engine is SPMD: every rank of the mesh builds it with
the same params, config and requests, and drives it the same way. The
params are sharded (``parallel.shard_decoder_params``, which cuts fused
q|k|v and gate|up apart itself), each rank's cache holds its ``max_batch /
data`` slots at its ``kv_heads / model`` heads, and every forward runs
``parallel.tp``'s explicit tensor-parallel path: ``tp_mode="shard_map"``
with the overlapped ring on dense weights, as the JAX engine's, and
``"pjit"`` (the JAX engine's GSPMD propagation, which PyTorch has no
counterpart of) without it. A slot's admission prefills on its data
group's ranks. The tokens of each forward reach every rank from one
(``parallel.tp.tp_sample``), so the ranks' host decisions (admission, EOS,
budget) cannot part. The sharded path runs eagerly, each collective as it
comes (staged through the host, so no graph can hold it).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable

import numpy as np
import torch

from rten_tpu_torch.generate.sampler import ArgMaxSampler, Sampler
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import decoder


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 64
    eos_tokens: tuple[int, ...] = ()
    request_id: int | None = None
    on_token: Callable[[int], None] | None = None
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    finished: bool = False


def check_engine_options(max_batch: int, mesh, tp_mode: str = "pjit", cfg=None) -> None:
    """The JAX engine's rules (``rten_tpu/serve/engine.py:176-180``): a
    known ``tp_mode``, a mesh for ``"shard_map"``; and the port's:
    ``max_batch`` ≥ 1 (up to 8 rows a step takes the fused decode
    structure, more the prefill one), a multiple of the mesh's data axis,
    and under a mesh neither W8A8 nor the whole-block decode (the
    tensor-parallel path, as the JAX package's, has neither). ValueError
    otherwise."""
    if tp_mode not in ("pjit", "shard_map"):
        raise ValueError(f"unknown tp_mode {tp_mode!r}")
    if tp_mode == "shard_map" and mesh is None:
        raise ValueError("tp_mode='shard_map' requires a mesh")
    if max_batch < 1:
        raise ValueError(f"max_batch must be at least 1, got {max_batch}")
    if mesh is None:
        return
    if max_batch % mesh.shape.get("data", 1):
        raise ValueError(f"max_batch {max_batch} is not a multiple of the mesh's data axis "
                         f"{mesh.shape.get('data', 1)}")
    if cfg is not None and (cfg.w8a8 or cfg.mega):
        raise ValueError("the tensor-parallel path has no W8A8 or whole-block (mega) mode")


def sample_step(params, cfg, tokens, cache, sampler: Sampler, rng, **kw):
    """One forward of ``tokens`` and its last position's token per row,
    int32 [B, 1] on the device: the lm_head kernel's fused argmax under
    ``ArgMaxSampler``, else ``sampler`` over the f32 logits with ``rng``."""
    if isinstance(sampler, ArgMaxSampler):
        tok, _ = decoder.forward(params, cfg, tokens, cache, lm_head_mode="argmax", last_only=True, **kw)
        return tok[:, -1:]
    logits, _ = decoder.forward(params, cfg, tokens, cache, last_only=True, **kw)
    return sampler.sample(rng, logits[:, -1])[:, None]


def prefill_first_token(params, cfg, cache: dict, prompt, sampler: Sampler, rng) -> int:
    """Feed ``prompt`` into a batch-1 cache as one forward; the first token
    (``sample_step`` at the last position), on the host.

    Under W8A8 the forward takes the prefill structure at any length, as
    the JAX engines' admission at a bucket of ≥ 32 rows does: there the
    structure decides which projections quantize their activations, so a
    prompt of ≤ 8 tokens would otherwise run layer 0's qkv and the lm_head
    in W8A8 where the JAX engine keeps those tiled packs weight-only."""
    dev = cache["len"].device
    ids = torch.as_tensor(np.asarray(prompt, np.int32)[None], device=dev)
    tok = sample_step(params, cfg, ids, cache, sampler, rng, fuse=not cfg.w8a8)
    return int(tok.view(-1)[0])  # waits for the device


class ServingEngine:
    def __init__(
        self,
        params,
        cfg: decoder.DecoderConfig,
        *,
        max_batch: int = 8,
        max_len: int | None = None,
        sampler: Sampler | None = None,
        seed: int = 0,
        mesh=None,
        tp_mode: str = "pjit",
        steps_per_tick: int = 1,
        device="cuda",
    ) -> None:
        """``cfg.int8_kv`` gives the slots an int8 cache with per-(token,
        head) scales. ``mesh``: see the module docstring; the engine then
        lives on the mesh's device."""
        check_engine_options(max_batch, mesh, tp_mode, cfg)
        self.mesh = mesh
        self.tp_mode = tp_mode
        self.max_len = max_len or cfg.max_seq
        if mesh is None:
            self.device = resolve_device(device)
            self._rows = slice(0, max_batch)
            self.cache = decoder.init_cache(cfg, max_batch, self.max_len, self.device)
        else:
            from rten_tpu_torch.parallel.mesh import init_cache, shard_decoder_params
            from rten_tpu_torch.parallel.tp import data_rows

            self.device = mesh.device
            params = shard_decoder_params(params, cfg, mesh)
            self._rows = data_rows(mesh, max_batch)
            self.cache = init_cache(cfg, max_batch, self.max_len, mesh)
        self.sampler = sampler or ArgMaxSampler()
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.steps_per_tick = steps_per_tick
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self._last_tokens = np.zeros((max_batch,), np.int32)
        # Forwards each slot may still take by its budget: the device rule
        # without EOS, which keeps the host lengths at least the device's.
        self._mirror_budget = np.zeros((max_batch,), np.int64)
        self._ids = itertools.count()
        self.steps = 0
        self._eos_width = 4
        self._last_admitted: list[int] = []

    # -- public API -----------------------------------------------------------

    def submit(self, request: Request) -> Request:
        if request.request_id is None:
            request.request_id = next(self._ids)
        if len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {len(request.prompt) + request.max_new_tokens} "
                f"cache slots, engine max_len is {self.max_len}"
            )
        self.queue.append(request)
        return request

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return self.n_active > 0 or bool(self.queue)

    def run(self) -> list[Request]:
        """Drive until all submitted requests finish; returns them."""
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    def run_pipelined(self) -> list[Request]:
        """Like ``run``, but the next tick is dispatched from the device-side
        carry (last token, active mask, remaining budget per slot) before
        this tick's tokens are read on the host, so the host's bookkeeping
        overlaps the device's work. Streaming and retirement run one tick
        behind the device; admission takes effect on the tick after the
        slot frees. Token-exact against ``run`` (greedy)."""
        done: list[Request] = []
        pending = None
        carry = None
        while True:
            done.extend(self._admit())
            carry = self._sync_carry(carry)
            if self.n_active > 0:
                pending_next, carry = self._dispatch_tick(carry)
            else:
                pending_next = None
            if pending is not None:
                done.extend(self._process_tick(*pending))
            pending = pending_next
            if pending is None and not self.has_work():
                return done

    # -- engine step ------------------------------------------------------------

    def step(self, n_steps: int | None = None) -> list[Request]:
        """Admit waiting requests, run ``n_steps`` batched decode forwards
        (default ``steps_per_tick``) with one copy to the host, retire the
        finished requests."""
        finished_at_admission = self._admit()
        if self.n_active == 0:
            return finished_at_admission
        carry = self._sync_carry(None)
        pending, _carry = self._dispatch_tick(carry, n_steps or self.steps_per_tick)
        return finished_at_admission + self._process_tick(*pending)

    def _eos(self) -> torch.Tensor:
        """[B, E] int32 EOS ids of the live slots, -1 padded (E at least 4
        and never shrinking, as in the JAX engine)."""
        self._eos_width = max([len(s.eos_tokens) for s in self.slots if s is not None] + [self._eos_width])
        eos = np.full((self.max_batch, self._eos_width), -1, np.int32)
        for slot, req in enumerate(self.slots):
            if req is not None:
                eos[slot, : len(req.eos_tokens)] = req.eos_tokens
        return torch.from_numpy(eos).to(self.device)

    def _decode_tick(self, tok, act, budget, eos, k: int):
        """``k`` decode forwards on the device (counterpart of
        ``_decode_k_steps``): tok [B, 1] int32, act [B] bool, budget [B]
        int32 (tokens each slot may still emit). Returns (the tick's tokens
        and active flags stacked as int32 [2, k, B], the next carry).

        On the card (``decoder._capturable``; a sampled tick needs a torch
        that advances a graph's generator) the k forwards, their sampling,
        the EOS and budget masks and the length pinning are one replay of a
        graph captured once for the engine's cache, k, the EOS width and
        the sampler; the host mirror (``_mirror_budget``, ``host_len``)
        then takes its k steps after it by the same rule. Under a mesh the
        tick runs eagerly (its collectives go through the host), as it does
        on the CPU."""
        sampled = not isinstance(self.sampler, ArgMaxSampler)
        if self.mesh is not None or not decoder._capturable(self.device, sampled):
            return self._tick_steps(self.cache, self._rng, self._mirror_budget, tok, act, budget, eos, k)
        host_len, mirror = self.cache["host_len"].copy(), self._mirror_budget.copy()
        self._mirror_steps(host_len, mirror, k)  # IndexError here, before the replay, where an eager step would raise

        def capture_fn():
            def warm():
                self._tick_steps(decoder.scratch_like(self.cache), torch.Generator(device=self.device).manual_seed(0),
                                 self._mirror_budget.copy(), tok.clone(), act.clone(), budget.clone(), eos.clone(), 1)

            def run(*carry):
                out, nxt = self._tick_steps(self.cache, self._rng, self._mirror_budget.copy(), *carry, k)
                return out, *nxt

            return decoder.capture(run, (tok, act, budget, eos), warm, rng=self._rng if sampled else None,
                                   states=(self.cache,), keep=(self.params, self._rng))

        key = ("tick", id(self.params), self.cfg, k, tuple(eos.shape), self.sampler, id(self._rng))
        graph = decoder.graph_for(self.cache["len"], key, decoder.state_tensors(self.cache), capture_fn)
        out, *carry = (t.clone() for t in graph.replay(tok, act, budget, eos))
        self.cache["host_len"][:] = host_len
        self._mirror_budget[:] = mirror
        return out, tuple(carry)

    def _mirror_steps(self, host_len, mirror, k: int) -> None:
        """The host mirror of ``k`` forwards of a tick, in place: each adds
        one position to every row (IndexError when a row would pass the
        cache, as the forward's own check raises), then one step of budget
        pins the rows without any left to 0, as the device pins inactive
        rows (less EOS, which the host does not see until the tick ends)."""
        rows, room = self._rows, {"k": self.cache["k"], "host_len": host_len}
        host_len[mirror[rows] <= 0] = 0
        for _ in range(k):
            decoder._check_room(room, 1)
            host_len += 1
            mirror -= 1
            host_len[mirror[rows] <= 0] = 0

    def _tick_steps(self, cache, rng, mirror, tok, act, budget, eos, k: int):
        """The tick's k forwards on ``cache``, drawing from ``rng``, as
        ``_decode_tick`` describes them, with the host mirror's steps on
        ``mirror`` (a budget array) and the cache's ``host_len`` between
        them, as each forward checks room."""
        lens, rows = cache["len"], self._rows  # this rank's slots of the batch
        lens.mul_(act[rows])  # inactive slots attend to nothing and append at 0
        host_len = cache["host_len"]
        host_len[mirror[rows] <= 0] = 0
        toks, actives = [], []
        for i in range(k):
            nxt = self._sample(tok, cache, rng)
            hit_eos = (nxt == eos).any(1)
            act_next = act & ~hit_eos & (budget > i + 1)
            lens.mul_(act_next[rows])
            mirror -= 1
            host_len[mirror[rows] <= 0] = 0
            toks.append(nxt[:, 0])
            actives.append(act)
            tok, act = nxt, act_next
        out = torch.stack([torch.stack(toks), torch.stack(actives).to(torch.int32)])
        budget_left = budget - out[1].sum(0, dtype=torch.int32)
        return out, (tok, act, budget_left)

    def _sample(self, tok, cache, rng):
        """One forward of the batch's last tokens [B, 1] on ``cache``; the
        next tokens [B, 1] (under a mesh, the same on every rank)."""
        if self.mesh is None:
            return sample_step(self.params, self.cfg, tok, cache, self.sampler, rng)
        from rten_tpu_torch.parallel.tp import tp_sample

        return tp_sample(self.params, self.cfg, tok, cache, self.sampler, rng, mesh=self.mesh,
                         overlap=self.tp_mode == "shard_map")

    def _dispatch_tick(self, carry, k: int | None = None):
        """Launch one tick from the device-side carry; returns ((the tick's
        device output, k, slots snapshot), next carry) without reading the
        device."""
        k = k or self.steps_per_tick
        tok, act, budget = carry
        out, carry_out = self._decode_tick(tok, act, budget, self._eos(), k)
        return (out, k, list(self.slots)), carry_out

    def _process_tick(self, out, k, reqs) -> list[Request]:
        """Host bookkeeping of a tick (``.cpu()`` waits for it): stream
        tokens, retire finished requests, free their slots."""
        toks, actives = out.cpu().numpy()  # the tick's one copy to the host
        self.steps += k
        finished: list[Request] = []
        for slot, req in enumerate(reqs):
            if req is None or req.finished:
                continue
            for s in range(k):
                if not actives[s, slot]:
                    break
                tok = int(toks[s, slot])
                req.output.append(tok)
                if req.on_token:
                    req.on_token(tok)
                self._last_tokens[slot] = tok
                if tok in req.eos_tokens or len(req.output) >= req.max_new_tokens:
                    req.finished = True
                    finished.append(req)
                    if self.slots[slot] is req:
                        self.slots[slot] = None
                        self._mirror_budget[slot] = 0
                    break
        return finished

    # -- admission ---------------------------------------------------------------

    def _admit(self) -> list[Request]:
        finished: list[Request] = []
        self._last_admitted = []
        while self.queue and self.n_active < self.max_batch:
            req = self.queue.popleft()
            slot = self.slots.index(None)
            self._prefill_into_slot(req, slot)
            first = req.output[-1]
            if first in req.eos_tokens or len(req.output) >= req.max_new_tokens:
                req.finished = True
                finished.append(req)
                local = self._local(slot)
                if local is not None:
                    self.cache["len"][local] = 0
                    self.cache["host_len"][local] = 0
            else:
                self.slots[slot] = req
                self._mirror_budget[slot] = req.max_new_tokens - len(req.output)
                self._last_admitted.append(slot)
        return finished

    def _local(self, slot: int) -> int | None:
        """The row of this rank's cache that holds ``slot``, or None when
        another data group holds it."""
        rows = self._rows
        return slot - rows.start if rows.start <= slot < rows.stop else None

    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        local = self._local(slot)
        if local is not None:
            self.cache["len"][local] = 0
            self.cache["host_len"][local] = 0
        if self.mesh is None:
            first = prefill_first_token(self.params, self.cfg, decoder.row_view(self.cache, slot), req.prompt,
                                        self.sampler, self._rng)
        else:
            first = self._mesh_first_token(req.prompt, slot, local)
        req.output.append(first)
        if req.on_token:
            req.on_token(first)
        self._last_tokens[slot] = first

    def _mesh_first_token(self, prompt, slot: int, local: int | None) -> int:
        """Admission under a mesh: the slot's data group prefills the prompt
        into its row (``tp_sample`` of the prompt on the row's view); the
        first token then reaches every data group from the owner's."""
        from rten_tpu_torch.parallel.tp import tp_sample

        tok = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
        if local is not None:
            ids = torch.as_tensor(np.asarray(prompt, np.int32)[None], device=self.device)
            tok = tp_sample(self.params, self.cfg, ids, decoder.row_view(self.cache, local), self.sampler,
                            self._rng, mesh=self.mesh, overlap=self.tp_mode == "shard_map", local=True)
        if self.mesh.shape.get("data", 1) > 1:
            tok = self.mesh.broadcast(tok, "data", slot // (self._rows.stop - self._rows.start))
        return int(tok.view(-1)[0])  # waits for the device

    # -- pipelined ticking -------------------------------------------------------

    def _sync_carry(self, carry):
        """The device-side tick carry with host events folded in: built from
        the host state when ``carry`` is None; otherwise the newly admitted
        slots are spliced in (continuing slots' values live on the device,
        one tick ahead of the host's bookkeeping)."""
        if self.n_active == 0 and not self._last_admitted:
            return carry

        def budget_of(req):
            return req.max_new_tokens - len(req.output) if req is not None else 0

        budget = torch.tensor([budget_of(s) for s in self.slots], dtype=torch.int32, device=self.device)
        tokens = torch.from_numpy(self._last_tokens.copy()).to(self.device)
        if carry is None:
            act = torch.tensor([s is not None for s in self.slots], device=self.device)
            return tokens[:, None], act, budget
        if not self._last_admitted:
            return carry
        adm = torch.zeros(self.max_batch, dtype=torch.bool)
        adm[self._last_admitted] = True
        adm = adm.to(self.device)
        tok, act, bud = carry
        return (torch.where(adm[:, None], tokens[:, None], tok), act | adm, torch.where(adm, budget, bud))
