"""The host-side launch plan of the decode attention engine on the CPU:
``attention.kv_plan``, the cluster size C of the one launch the four KV
kernels (``csrc/kv_attention.cuh``) make.

The kernel gives each (kv head, head tile, row) a cluster of C ranks. A
row's chunks belong to V = min(8, chunks of the capacity) virtual ranks,
virtual rank v walking chunks v, v + V, ..., and rank r of the cluster runs
virtual ranks r, r + C, ... (``virtual_chunks`` and ``rank_virtuals`` below
copy that arithmetic; the card tests at chunk, page and rank edges and at
every C, bit for bit across C, hold the kernel to it). Checked here: every
chunk of every kv_len up to the row's capacity belongs to exactly one
virtual rank and every virtual rank to exactly one rank, whatever C; one
rank appends the new token; no rank walks past the capacity; C is at most
8 and at most the chunks of the capacity, fits the given cluster capacity
(every cluster of the launch resident at once) and is the largest that
does; the grid's limits; and C pinned at the decoders' shapes.
"""

import pytest

from rten_tpu_torch.kernels import attention as at

CHUNK = 64
H100_SMS = 132
# A model of an H100's cluster capacity: eight GPCs of uneven size (132 SMs
# in all), a cluster living in one GPC, ``per_sm`` blocks of the kernel an SM.
H100_GPCS = (18, 18, 18, 18, 16, 16, 14, 14)


def _fits(per_sm: int) -> tuple[int, ...]:
    return tuple(sum(g * per_sm // c for g in H100_GPCS) for c in range(1, 9))


def virtual_ranks(cap: int) -> int:
    """V: the virtual ranks a row's sums are ordered by (kv_attention.cuh:
    min(8, chunks of cap)), the same for every C and batch."""
    return min(8, -(-cap // CHUNK))


def virtual_chunks(kv_len: int, cap: int, v: int) -> list[int]:
    """The chunks virtual rank v walks for a row holding kv_len positions
    before the new token: v, v + V, ... while c * 64 <= kv_len."""
    return list(range(v, (kv_len + CHUNK) // CHUNK, virtual_ranks(cap)))


def rank_virtuals(cap: int, split: int, rank: int) -> list[int]:
    """The virtual ranks rank ``rank`` of ``split`` runs: rank, rank + split, ..."""
    return list(range(rank, virtual_ranks(cap), split))


# (b, hk, group, cap): GPT-2-small (12 heads, S 768) at 1 and 8 rows,
# Qwen2-0.5B (14 query heads over 2 kv heads) at S 768 and 1024 and at the
# 12-row step, the paged engines' rows of 6 pages of 128, the card tests'
# small shapes, a group past one head tile, and ragged capacities.
SHAPES = [
    (1, 12, 1, 768), (8, 12, 1, 768), (1, 2, 7, 768), (8, 2, 7, 768), (1, 2, 7, 1024), (8, 2, 7, 1024),
    (12, 2, 7, 1024), (5, 4, 1, 192), (9, 2, 7, 384), (9, 2, 1, 384), (5, 2, 2, 192), (2, 4, 16, 256),
    (3, 1, 71, 2048), (1, 8, 8, 4096), (1, 1, 1, 64), (1, 1, 1, 1), (2, 3, 1, 100), (4, 2, 12, 130),
]
SMS = [132, 114, 78, 16, 8]
FITS = [None, _fits(1), _fits(2), _fits(4)]


def _clusters(b, hk, group):
    return b * hk * at.kv_tiles(group)


@pytest.mark.parametrize("fits", FITS, ids=["no_fits", "fits1", "fits2", "fits4"])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,hk,group,cap", SHAPES)
def test_kv_plan_limits_and_maximal(b, hk, group, cap, sms, fits):
    """C in [1, 8], at most the chunks of cap; every cluster resident at
    once (fits[C - 1], or one block an SM without fits) unless C is 1; and
    no larger C would do."""
    split = at.kv_plan(b, hk, group, cap, sms, fits)
    chunks = -(-cap // CHUNK)
    clusters = _clusters(b, hk, group)

    def room(c):
        return fits[c - 1] if fits is not None else sms // c

    assert 1 <= split <= min(8, chunks)
    if split > 1:
        assert clusters <= room(split)
    for bigger in range(split + 1, min(8, chunks) + 1):
        assert clusters > room(bigger)


@pytest.mark.parametrize("b,hk,group,cap", SHAPES)
def test_kv_plan_every_chunk_one_rank(b, hk, group, cap):
    """For every kv_len below cap and every C the kernel may be given (the
    plan's, and 1-8, as the card tests force): the virtual ranks' chunks
    cover the row's valid chunks exactly once, none at or past the chunks
    of cap, and the ranks' virtual ranks cover 0..V-1 exactly once (a rank
    past V has none); one virtual rank, so one rank, holds chunk kv_len //
    64 and appends."""
    V = virtual_ranks(cap)
    for split in sorted({at.kv_plan(b, hk, group, cap, H100_SMS, _fits(2)), *range(1, 9)}):
        owned = sorted(v for r in range(split) for v in rank_virtuals(cap, split, r))
        assert owned == list(range(V))
    for kv_len in range(cap):
        walked = [c for v in range(V) for c in virtual_chunks(kv_len, cap, v)]
        assert sorted(walked) == list(range(kv_len // CHUNK + 1))
        assert max(walked) < -(-cap // CHUNK)
        holders = [v for v in range(V) if kv_len // CHUNK in virtual_chunks(kv_len, cap, v)]
        assert holders == [(kv_len // CHUNK) % V]


@pytest.mark.parametrize("group,tiles", [(1, 1), (2, 1), (7, 1), (8, 1), (9, 2), (16, 2), (17, 3), (71, 9)])
def test_kv_tiles(group, tiles):
    """A head tile is up to 8 query heads of a kv head's group (one warp
    each in the kernel's softmax and P.V)."""
    assert at.kv_tiles(group) == tiles


@pytest.mark.parametrize("b,hk,group,cap", SHAPES)
def test_kv_plan_grid_limits(b, hk, group, cap):
    """The grid (C, Hk · tiles, B) within the hardware's limits (y and z at
    most 65535) and every rank's first chunk inside the row (rank < chunks
    of cap, so its early request stays in the cache)."""
    split = at.kv_plan(b, hk, group, cap, H100_SMS, _fits(2))
    assert hk * at.kv_tiles(group) <= 65535 and b <= 65535
    assert split <= -(-cap // CHUNK)


# Pinned: (b, hk, group, cap, sms, fits) -> C.
PINNED = [
    ((1, 12, 1, 768, H100_SMS, None), 8),           # GPT-2 at batch 1: 96 blocks
    ((8, 12, 1, 768, H100_SMS, None), 1),           # 96 clusters already fill 132 SMs one block each
    ((8, 12, 1, 768, H100_SMS, _fits(2)), 2),
    ((8, 12, 1, 768, H100_SMS, _fits(4)), 5),       # four blocks an SM: 96 clusters of 5 fit
    ((1, 2, 7, 768, H100_SMS, None), 8),            # Qwen2-0.5B at batch 1: 16 blocks
    ((1, 2, 7, 1024, H100_SMS, _fits(2)), 8),
    ((8, 2, 7, 768, H100_SMS, None), 8),            # 16 clusters of 8
    ((8, 2, 7, 1024, H100_SMS, _fits(1)), 7),       # 16 clusters of 8 do not fit one block an SM's GPCs
    ((12, 2, 7, 1024, H100_SMS, None), 5),          # the 12-row step: 24 clusters
    ((12, 2, 7, 1024, H100_SMS, _fits(2)), 8),
    ((8, 2, 7, 6 * 128, H100_SMS, _fits(2)), 8),    # the paged engines' rows: 6 pages of 128
    ((8, 12, 1, 6 * 128, H100_SMS, _fits(2)), 2),
    ((1, 2, 7, 128, H100_SMS, None), 2),            # two chunks: no rank idle on a full row
    ((1, 12, 1, 768, 16, None), 1),                 # a 16-SM card
    ((1, 12, 1, 768, 114, None), 8),                # an H100 PCIe
    ((8, 12, 1, 768, 114, _fits(4)), 5),
]


@pytest.mark.parametrize("args,split", PINNED)
def test_kv_plan_pinned(args, split):
    assert at.kv_plan(*args) == split


@pytest.mark.parametrize("cap,v", [(1, 1), (64, 1), (128, 2), (384, 6), (512, 8), (768, 8), (4096, 8)])
def test_virtual_ranks(cap, v):
    """V, which orders a row's sums, depends on the row's capacity alone."""
    assert virtual_ranks(cap) == v
