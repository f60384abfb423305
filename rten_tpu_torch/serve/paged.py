"""Paged KV-cache serving: a page-pool allocator and a continuous-batching
engine over it.

Counterpart of ``rten_tpu/serve/paged.py`` (``PagePool`` :36,
``PagedServingEngine`` :141, ``_paged_decode`` :427): fixed-size pages from
a shared pool are allocated on demand, so the device holds Σ ceil(len_i /
page) pages instead of a max_len × max_batch rectangle. Each decode step is
one forward over the pool state, whose attention is
``paged_decode_attention`` (``paged_decode_attention_int8`` with
``int8_kv``) through a ``[B, max_pages]`` page table, ``max_pages`` the
most a row can hold (the JAX engine's table grows with its rows and
recompiles at each width); the kernel appends the new token into the page
that holds each row's length. On the card the step is one replay of a CUDA
graph captured once for the pool, the batch and the sampler, the tokens,
table and lengths copied into it.

Host side: a free-list allocator; admission (one prefill forward of prompt
plus output into a contiguous batch-1 cache, copied into fresh pages); a
coverage check before each step that allocates the page a row's next token
needs, or preempts the row (its pages released, its request requeued at
the front and re-prefilled later) when the pool is empty; retirement
(pages back to the free list at once). Inactive rows point their table at
the pool's scratch page, so their append lands in memory no row reads.

Under a mesh (``mesh=``, model axis only: a paged batch is scheduled on
the host, not sharded) every rank builds the engine alike (SPMD): its pool
holds its ``kv_heads / model`` heads (scale pages beside the payload), the
page tables and the free list are the same on every rank, and each decode
is ``parallel.tp.tp_paged_decode``'s forward with the tokens broadcast from
one rank (``parallel.tp.tp_sample``); admission prefills through
``tp_prefill`` into a batch-1 cache at the local heads.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from rten_tpu_torch.generate.sampler import ArgMaxSampler, Sampler
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.kernels.paged_attention import paged_attention_int8_supported, paged_attention_supported
from rten_tpu_torch.models import decoder
from rten_tpu_torch.serve.engine import Request, check_engine_options, prefill_first_token, sample_step


class PagePool:
    """Free-list page allocator over per-layer device page arrays: k/v pages
    ``[n_pages + 1, H, page, D]`` in the model dtype or int8 (with f32 scale
    pages ``[n_pages + 1, H, page]``); page ``n_pages`` is the scratch page."""

    def __init__(self, cfg: decoder.DecoderConfig, n_pages: int, page_size: int = 128, int8: bool = False,
                 device="cuda") -> None:
        # The JAX PagePool's rules (rten_tpu/serve/paged.py:47-60).
        if not (paged_attention_int8_supported if int8 else paged_attention_supported)(cfg.head_dim, page_size):
            raise ValueError(f"page_size {page_size} unsupported for {'int8 ' if int8 else ''}head_dim "
                             f"{cfg.head_dim}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.n_pages = n_pages
        self.page_size = page_size
        self.int8 = int8
        dtype = torch.int8 if int8 else cfg.dtype
        shape = (n_pages + 1, cfg.kv_heads, page_size, cfg.head_dim)
        self.k_pages = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(cfg.n_layers)]
        self.v_pages = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(cfg.n_layers)]
        if int8:
            self.k_scales = [torch.zeros(shape[:3], dtype=torch.float32, device=dev) for _ in range(cfg.n_layers)]
            self.v_scales = [torch.zeros(shape[:3], dtype=torch.float32, device=dev) for _ in range(cfg.n_layers)]
        self.scratch_page = n_pages
        self.free: deque[int] = deque(range(n_pages))

    @property
    def n_free(self) -> int:
        return len(self.free)

    def tensors(self) -> list:
        """The pool's device tensors: payload pages, then scale pages."""
        return self.k_pages + self.v_pages + (self.k_scales + self.v_scales if self.int8 else [])

    def nbytes(self) -> int:
        """Device bytes of the pool (payload and scales, scratch page included)."""
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def alloc(self, n: int) -> list[int]:
        if n > len(self.free):
            raise MemoryError(f"page pool exhausted: need {n}, have {len(self.free)}")
        return [self.free.popleft() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        self.free.extend(int(p) for p in pages)

    def write_prefix(self, li: int, pages: list[int], cache: dict, n_tokens: int) -> None:
        """Copy the first ``n_tokens`` positions of layer ``li`` of a batch-1
        contiguous ``cache`` (``decoder.init_cache`` layout, int8 with
        scales for an int8 pool) into ``pages``, one page per ``page_size``
        positions; pages past the prefix (decode room) are left alone."""
        psz = self.page_size
        n_full = -(-n_tokens // psz)
        idx = torch.tensor(pages[:n_full], device=self.k_pages[li].device)
        pairs = [(self.k_pages, cache["k"]), (self.v_pages, cache["v"])]
        if self.int8:
            pairs += [(self.k_scales, cache["k_scale"]), (self.v_scales, cache["v_scale"])]
        for pool, src in pairs:
            chunk = src[li][0, :, : n_full * psz]  # [H, n·page(, D)]
            chunk = chunk.reshape(chunk.shape[0], n_full, psz, *chunk.shape[2:]).transpose(0, 1)
            pool[li].index_copy_(0, idx, chunk)


@dataclasses.dataclass
class _Seq:
    req: Request
    pages: list[int]
    length: int


class PagedServingEngine:
    """Continuous batching over a shared page pool. Same Request/step/run
    surface as ServingEngine; admission is bounded by free pages rather
    than a fixed slot rectangle. One decode forward per ``step``."""

    def __init__(
        self,
        params,
        cfg: decoder.DecoderConfig,
        *,
        max_batch: int = 8,
        n_pages: int = 64,
        page_size: int = 128,
        sampler: Sampler | None = None,
        seed: int = 0,
        int8_kv: bool = False,
        mesh=None,
        device="cuda",
    ) -> None:
        """``int8_kv``: int8 page payloads with per-(token, head) scale
        pages; the admission prefill then runs on an int8 cache too, so the
        deeper layers see the same quantized-KV attention the contiguous
        int8 engine computes."""
        check_engine_options(max_batch, mesh, cfg=cfg)
        self.mesh = mesh
        pool_cfg = cfg
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from rten_tpu_torch.parallel.mesh import local_config, shard_decoder_params

            if mesh.shape.get("data", 1) != 1:
                raise ValueError("a paged engine's mesh shards the model axis only (data axis 1)")
            self.device = mesh.device
            params = shard_decoder_params(params, cfg, mesh)
            pool_cfg = local_config(cfg, mesh)
        self.sampler = sampler or ArgMaxSampler()
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.int8_kv = int8_kv
        self._prefill_cfg = dataclasses.replace(cfg, int8_kv=int8_kv)
        self._cache_cfg = dataclasses.replace(pool_cfg, int8_kv=int8_kv)  # admission's cache, at the local heads
        self.pool = PagePool(pool_cfg, n_pages, page_size, int8=int8_kv, device=self.device)
        self.seqs: list[_Seq | None] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self._last_tokens = np.zeros((max_batch,), np.int32)
        self.steps = 0
        self.preemptions = 0
        self._rid = 0

    # -- public API ----------------------------------------------------------

    def submit(self, request: Request) -> Request:
        if request.request_id is None:
            request.request_id = self._rid
            self._rid += 1
        need = request.max_new_tokens + len(request.prompt)
        if need > self.pool.n_pages * self.pool.page_size:
            raise ValueError("request larger than entire page pool")
        if need > self.cfg.max_seq:
            raise ValueError(f"request needs {need} positions, the model has {self.cfg.max_seq}")
        self.queue.append(request)
        return request

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.seqs if s is not None)

    def has_work(self) -> bool:
        return self.n_active > 0 or bool(self.queue)

    def run(self) -> list[Request]:
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    # -- engine step ----------------------------------------------------------

    def step(self) -> list[Request]:
        finished = self._admit()
        if self.n_active == 0:
            return finished

        # A row whose next token falls past its pages gets one more page,
        # or is preempted (pages released, request requeued at the front;
        # admission later re-prefills prompt + output) when none is free.
        psz = self.pool.page_size
        for i, seq in enumerate(self.seqs):
            if seq is None or seq.length // psz < len(seq.pages):
                continue
            if self.pool.n_free == 0:
                self.pool.release(seq.pages)
                self.seqs[i] = None
                self.queue.appendleft(seq.req)
                self.preemptions += 1
                continue
            seq.pages.extend(self.pool.alloc(1))
        if self.n_active == 0:
            return finished

        table = np.full((self.max_batch, self._table_width()), self.pool.scratch_page, np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        for i, seq in enumerate(self.seqs):
            if seq is not None:
                table[i, : len(seq.pages)] = seq.pages
                lens[i] = seq.length
        inputs = [torch.from_numpy(a).to(self.device) for a in (self._last_tokens[:, None].copy(), table, lens)]
        sampled = self._decode(*inputs).view(-1).cpu().numpy()  # the step's one copy to the host
        self.steps += 1

        for i, seq in enumerate(self.seqs):
            if seq is None:
                continue
            tok = int(sampled[i])
            seq.req.output.append(tok)
            if seq.req.on_token:
                seq.req.on_token(tok)
            self._last_tokens[i] = tok
            seq.length += 1
            if tok in seq.req.eos_tokens or len(seq.req.output) >= seq.req.max_new_tokens:
                seq.req.finished = True
                finished.append(seq.req)
                self.pool.release(seq.pages)
                self.seqs[i] = None
        return finished

    def _table_width(self) -> int:
        """The page table's width: the most pages a row can hold (its
        ``max_seq`` positions, at most the pool), whatever the rows hold
        now. One width keeps one captured graph for every step, and a row's
        attention plan (sized for the table's positions) independent of the
        other rows'; the kernels read a row's pages only up to its length,
        and the entries past its pages name the scratch page."""
        return min(self.pool.n_pages, -(-self.cfg.max_seq // self.pool.page_size))

    def _state(self, table, lens) -> dict:
        """The pool's decode state over ``table`` [B, W] and ``lens`` [B]."""
        state = {"k_pages": self.pool.k_pages, "v_pages": self.pool.v_pages, "page_table": table, "len": lens}
        if self.int8_kv:
            state["k_scale_pages"], state["v_scale_pages"] = self.pool.k_scales, self.pool.v_scales
        return state

    def _decode(self, tokens, table, lens):
        """One decode forward of ``tokens`` [B, 1] over the pool, each row's
        page table and length given: the next tokens [B, 1] on the device.
        On the card (``decoder._capturable``; a sampled step needs a torch
        that advances a graph's generator) a replay of one graph captured
        for the pool, the sampler and the batch (the JAX engine jits
        ``_paged_decode``), its result valid until the next step; under a
        mesh, and on the CPU, eagerly."""
        sampled = not isinstance(self.sampler, ArgMaxSampler)
        if self.mesh is not None:
            from rten_tpu_torch.parallel.tp import tp_sample

            return tp_sample(self.params, self.cfg, tokens, self._state(table, lens), self.sampler, self._rng,
                             mesh=self.mesh)
        if not decoder._capturable(self.device, sampled):
            return sample_step(self.params, self.cfg, tokens, self._state(table, lens), self.sampler, self._rng)

        def step(tok, tab, n, rng):
            return sample_step(self.params, self.cfg, tok, self._state(tab, n), self.sampler, rng)

        def capture_fn():
            def warm():  # every row on the scratch page at length 0: its writes land where no row reads
                step(tokens.clone(), torch.full_like(table, self.pool.scratch_page), torch.zeros_like(lens),
                     torch.Generator(device=self.device).manual_seed(0))

            return decoder.capture(lambda *t: step(*t, self._rng), (tokens, table, lens), warm,
                                   rng=self._rng if sampled else None, keep=(self.params, self._rng))

        key = ("paged", id(self.params), self.cfg, tuple(table.shape), self.sampler, id(self._rng))
        graph = decoder.graph_for(self.pool.k_pages[0], key, self.pool.tensors(), capture_fn)
        return graph.replay(tokens, table, lens)

    def pages_in_use(self) -> int:
        return self.pool.n_pages - self.pool.n_free

    # -- admission -------------------------------------------------------------

    def _admit(self) -> list[Request]:
        finished: list[Request] = []
        psz = self.pool.page_size
        while self.queue and self.n_active < self.max_batch:
            req = self.queue[0]
            # A preempted request re-prefills prompt + output and continues
            # from the next token (output is empty for a fresh one).
            ctx = list(req.prompt) + list(req.output)
            need = -(-(len(ctx) + 1) // psz)  # the context and the first decode token
            if need > self.pool.n_pages:
                self.queue.popleft()
                req.finished = True
                raise MemoryError(f"request {req.request_id} needs {need} pages, pool has {self.pool.n_pages}")
            if need > self.pool.n_free:
                break  # wait for pages to free up
            self.queue.popleft()
            pages = self.pool.alloc(need)
            slot = self.seqs.index(None)

            tmp = decoder.init_cache(self._cache_cfg, 1, need * psz, self.device)
            if self.mesh is None:
                first = prefill_first_token(self.params, self._prefill_cfg, tmp, ctx, self.sampler, self._rng)
            else:
                from rten_tpu_torch.parallel.tp import tp_sample

                ids = torch.as_tensor(np.asarray(ctx, np.int32)[None], device=self.device)
                first = int(tp_sample(self.params, self._prefill_cfg, ids, tmp, self.sampler, self._rng,
                                      mesh=self.mesh).view(-1)[0])
            for li in range(self.cfg.n_layers):
                self.pool.write_prefix(li, pages, tmp, len(ctx))
            req.output.append(first)
            if req.on_token:
                req.on_token(first)
            self._last_tokens[slot] = first
            if first in req.eos_tokens or len(req.output) >= req.max_new_tokens:
                req.finished = True
                finished.append(req)
                self.pool.release(pages)
            else:
                self.seqs[slot] = _Seq(req=req, pages=pages, length=len(ctx))
        return finished
