"""The host-side launch plan of the decode GEMV engine on the CPU:
``quant_matmul.gemv_split`` and ``quant_matmul.gemv_plan``, the plan of the
one launch that ``quant_gemv_int8`` and ``quant_mlp_int8`` make
(``csrc/gemv.cuh``).

The kernel cuts an [N, K] matrix into tiles of 16 columns, a tile's K (in
64-byte chunks) into ``pieces`` contiguous ranges (a unit: one tile's
piece), gives block b of G the tiles [b T / G, (b + 1) T / G) of each
phase with all their pieces, or, in a GEMV of its own with P > 1 pieces,
gives cluster c of G / P blocks the tiles [c T / (G / P), ...) and its rank
r piece r of each, and sums a unit with a team of ``team`` warps, member s
taking the s-th contiguous share of the unit's chunks (``range_lo`` below
copies that arithmetic; the card tests at tile, chunk and split edges hold
the kernel to it). A split piece goes to the inbox of the tile's owner,
rank (tile - first tile) % P, at slot (tile - first tile) // P. Checked
here: every output column belongs to exactly one unit of a piece range and
every unit to exactly one block; every piece to one inbox slot of its
cluster; a tile's pieces, and a unit's members, cover K once and in order;
the split depends on (N, K) alone, never on the rows, the dot or the SM
count; shared memory within a block's limit (and two blocks' where the
plan puts two on an SM); one mbarrier for every unit of a block; and every
MLP that ``decoder.mlp_fused_supported`` admits resident (its whole weight
stream issued at kernel entry), at 114 and 132 SMs.
"""

import itertools

import pytest

from rten_tpu_torch.kernels import quant_matmul as qm
from rten_tpu_torch.models import decoder

TILE, CHUNK, WARPS = 16, 64, 8
BLOCK_SMEM = 232448  # an sm_90 block's shared memory, static included
SM_SMEM = 233472
STATIC_SMEM = 2048  # the kernel's static arrays (896 bytes on the H100) and their rounding
SMS = (114, 132)  # an H100 PCIe's and an H100 SXM's SMs

GPT2 = [(2304, 768), (3072, 768), (768, 3072), (768, 768), (51200, 768)]
QWEN2 = [(1152, 896), (9728, 896), (896, 4864), (896, 896), (152576, 896)]
RAGGED = [(7, 48), (333, 272), (1000, 784), (2309, 768), (40, 4880), (1, 16), (17, 1040), (4096, 11008)]
SHAPES = GPT2 + QWEN2 + RAGGED


def range_lo(i: int, total: int, parts: int) -> int:
    """Start of part i of ``total`` things cut into ``parts`` (gemv.cuh
    range_lo)."""
    return i * total // parts


def block_units(plan, phase: int, b: int) -> list[int]:
    """The units block b runs of a phase (gemv.cuh gemv_kernel's range)."""
    pieces = plan.phases[phase][0]
    tiles = plan.units[phase] // pieces
    parts, part = plan.grid // plan.split, b // plan.split
    own = range(range_lo(part, tiles, parts), range_lo(part + 1, tiles, parts))
    if plan.split > 1:
        return [t * pieces + b % plan.split for t in own]
    return [t * pieces + q for t in own for q in range(pieces)]


def piece_chunks(k: int, pieces: int, piece: int) -> range:
    chunks = -(-k // CHUNK)
    return range(range_lo(piece, chunks, pieces), range_lo(piece + 1, chunks, pieces))


def member_chunks(k: int, pieces: int, piece: int, team: int, s: int) -> range:
    pc = piece_chunks(k, pieces, piece)
    n = len(pc)
    return range(pc.start + range_lo(s, n, team), pc.start + range_lo(s + 1, n, team))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("n,k", SHAPES)
def test_every_column_once(n, k, m, sms):
    """The blocks' unit ranges cover the units once; the units cover every
    (tile, piece) once; the tiles cover the columns once."""
    plan = qm.gemv_plan(m, "bf16", ((n, k, True, 2),), sms)
    pieces, _team, _row, _xrow = plan.phases[0]
    units = plan.units[0]
    tiles = -(-n // TILE)
    assert units == tiles * pieces
    seen = sorted(u for b in range(plan.grid) for u in block_units(plan, 0, b))
    assert seen == list(range(units))
    pairs = sorted((u // pieces, u % pieces) for u in seen)
    assert pairs == list(itertools.product(range(tiles), range(pieces)))
    cols = [c for t in range(tiles) for c in range(t * TILE, min(n, (t + 1) * TILE))]
    assert cols == list(range(n))


@pytest.mark.parametrize("n,k", SHAPES)
@pytest.mark.parametrize("mlp", [False, True])
def test_k_pieces_and_members_cover_k_in_order(n, k, mlp):
    """A tile's pieces cover its chunks once, in order, none empty; each
    piece's members cover it once, in order, none empty; a piece is at most
    48 chunks (a 48 KB slot)."""
    pieces, team = qm.gemv_split(n, k, mlp)
    chunks = -(-k // CHUNK)
    assert team in (1, 2, 4, 8) and 1 <= pieces <= chunks
    got = [c for p in range(pieces) for c in piece_chunks(k, pieces, p)]
    assert got == list(range(chunks))
    for p in range(pieces):
        pc = piece_chunks(k, pieces, p)
        assert 1 <= len(pc) <= 48
        members = [c for s in range(team) for c in member_chunks(k, pieces, p, team, s)]
        assert members == list(pc)
        assert all(len(member_chunks(k, pieces, p, team, s)) >= 1 for s in range(team))


@pytest.mark.parametrize("n,k", SHAPES)
def test_split_depends_on_n_and_k_alone(n, k):
    """The pieces and the team (a column's sum order) are the same for
    every row count, dot and card: a row alone and among 8 sum alike (in
    the MLP's launch too, by gemv_split(n, k, mlp=True))."""
    split = qm.gemv_split(n, k)
    for m, dot, sms in itertools.product(range(1, 9), ("bf16", "f32", "s8"), SMS + (80, 144)):
        try:
            plan = qm.gemv_plan(m, dot, ((n, k, True, 2),), sms)
        except ValueError:
            continue  # a shape whose operand rows do not fit at this m
        assert plan.phases[0][:2] == split
    mlp = qm.gemv_split(n, k, True)
    for m, sms in itertools.product(range(1, 9), SMS):
        try:
            plan = qm.gemv_plan(m, "bf16", ((n, 256, True, 2), (256, 256, False, 4), (n, k, True, 4)), sms, True)
        except ValueError:
            continue
        assert plan.phases[2][:2] == mlp


@pytest.mark.parametrize("dot", ["bf16", "f32", "s8"])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n,k", SHAPES)
def test_shared_memory_and_scratch_within_limits(n, k, m, sms, dot):
    """Shared memory within a block's limit, or two blocks' where the grid
    exceeds the SMs; one mbarrier for every unit a block runs; a slot holds
    every unit; split tiles and the grid within the work buffer. Rows that
    alone outgrow a block's shared memory (8 f32 rows of K 11008) raise."""
    if m * qm.gemv_x_row(k, dot) + qm.GEMV_TEAM_BYTES > qm.GEMV_SMEM:
        with pytest.raises(ValueError):
            qm.gemv_plan(m, dot, ((n, k, True, 2),), sms)
        return
    plan = qm.gemv_plan(m, dot, ((n, k, True, 2),), sms)
    assert plan.smem + STATIC_SMEM <= BLOCK_SMEM
    if plan.grid > sms:
        assert 2 * (plan.smem + STATIC_SMEM + 1024) <= SM_SMEM
    pieces, _team, row, xrow = plan.phases[0]
    assert plan.slot_bytes >= TILE * row >= TILE * min(k, -(-(-(-k // CHUNK)) // pieces) * CHUNK)
    assert plan.x_bytes >= m * xrow and 1 <= plan.slots <= plan.block_units
    assert plan.bars >= plan.block_units == max(len(block_units(plan, 0, b)) for b in range(plan.grid))
    assert plan.smem == qm.gemv_smem(plan.ring_bytes, plan.x_bytes, plan.stage_bytes, plan.inbox_bytes, plan.bars)
    assert plan.ring_bytes >= (plan.slots * plan.slot_bytes if not plan.resident else
                               max(len(block_units(plan, 0, b)) for b in range(plan.grid)) * TILE * row)
    assert plan.grid <= qm.GEMV_MAX_GRID
    assert plan.split == (pieces if qm.gemv_clustered(n, k) else 1) and plan.grid % plan.split == 0
    if pieces > 1 and plan.split == 1:
        assert plan.phases[0][1] == WARPS  # one team runs a tile's pieces in order
    ints = list(plan.ints)
    assert ints[:11] == [plan.grid, plan.slots, plan.slot_bytes, plan.ring_bytes, plan.x_bytes, plan.stage_bytes,
                         plan.bars, plan.smem, 0, plan.split, plan.inbox_bytes]
    assert ints[11:] == list(plan.phases[0])


# (d, ff, n_qkv) of MLPs the decoder runs fused: GPT-2-small / OPT-125m,
# OPT-350m's widths, the tests' tiny configs, and others at or near the
# budget (d * ff * 2 + d * n_qkv <= 8 MiB).
MLPS = [(768, 3072, 2304), (768, 3072, 0), (1024, 4096, 0), (256, 1024, 768), (256, 344, 0), (512, 2048, 1536),
        (640, 2560, 1920), (768, 4096, 2304), (1024, 3072, 1024), (896, 4096, 1152)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dot", ["bf16", "s8"])
@pytest.mark.parametrize("d,ff,nq", MLPS)
def test_every_admitted_mlp_is_resident(d, ff, nq, dot, sms):
    """Every MLP within the budget, at every row count up to 8, bf16 or
    W8A8, has its whole weight stream in shared memory from kernel entry:
    one slot for every unit of every block, one block an SM."""
    assert decoder.mlp_fused_supported(d, ff, nq)
    phases = ((ff, d, True, 2), (d, ff, False, 4)) + (((nq, d, True, 4),) if nq else ())
    for m in range(1, 9):
        plan = qm.gemv_plan(m, dot, phases, sms, coop=True)
        assert plan.grid == sms and plan.resident, (m, plan.slots, plan.block_units)
        assert plan.smem + STATIC_SMEM <= BLOCK_SMEM
        assert plan.split == 1 and plan.inbox_bytes == 0
        most = max(sum(len(block_units(plan, p, b)) for p in range(len(phases))) for b in range(sms))
        assert plan.block_units == most <= plan.bars
        weights = max(sum(len(block_units(plan, p, b)) * TILE * r[2] for p, r in enumerate(plan.phases))
                      for b in range(sms))
        assert plan.ring_bytes == weights


def test_mlp_past_the_budget_streams():
    """An MLP past the budget is still planned: its later units stream
    through the ring (fewer slots than units); its down projection's tiles
    (K 8192: three pieces) each stay in one block, summed by one team of
    all 8 warps, piece after piece."""
    assert not decoder.mlp_fused_supported(1024, 8192, 3072)
    for m in (1, 8):
        plan = qm.gemv_plan(m, "bf16", ((8192, 1024, True, 2), (1024, 8192, False, 4), (3072, 1024, True, 4)), 132,
                            coop=True)
        assert 1 <= plan.slots < plan.block_units
        assert plan.phases[1][:2] == (3, WARPS) and plan.split == 1
        for b in range(plan.grid):
            units = block_units(plan, 1, b)
            assert units == list(range(units[0], units[0] + len(units))) if units else True
            assert len(units) % 3 == 0 and all(u % 3 == i % 3 for i, u in enumerate(units))


@pytest.mark.parametrize("sms", SMS + (80,))
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n,k", SHAPES)
def test_split_clusters_and_inboxes(n, k, m, sms):
    """A GEMV of its own with P > 1 pieces launches clusters of P <= 8
    blocks, every block with at least one tile; each tile's P pieces are
    summed by the P ranks of one cluster and land in distinct slots of one
    owner's inbox, within the inbox's bytes; an unsplit launch has no
    cluster and no inbox."""
    plan = qm.gemv_plan(m, "bf16", ((n, k, True, 2),), sms)
    pieces = plan.phases[0][0]
    if not qm.gemv_clustered(n, k):
        assert plan.split == 1 and plan.inbox_bytes == 0
        return
    assert plan.split == pieces <= 8
    tiles = -(-n // TILE)
    delivered = {}
    for b in range(plan.grid):
        units = block_units(plan, 0, b)
        assert units
        first = units[0] // pieces
        for u in units:
            tile, piece = divmod(u, pieces)
            assert piece == b % pieces
            owner = (b // pieces) * pieces + (tile - first) % pieces
            slot = (tile - first) // pieces * pieces + piece
            assert (slot + 1) * qm.GEMV_PIECE_BYTES <= plan.inbox_bytes
            assert (owner, slot) not in delivered
            delivered[(owner, slot)] = (tile, piece)
    assert sorted(delivered.values()) == list(itertools.product(range(tiles), range(pieces)))


def test_plan_pinned_at_the_decoders_shapes():
    """The split at the decode path's shapes: GPT-2's lm_head and Qwen2's
    w_gu unsplit (one warp or two a unit), the down projections split in 3
    over all 8 warps (in the MLP's launch GPT-2's unsplit; its up and next
    qkv over 4 warps a unit), the wo unsplit over 8, the
    qkv unsplit over 8 warps; a split GEMV launches clusters of 3."""
    assert qm.gemv_split(768, 3072, mlp=True) == (1, 8)
    assert qm.gemv_split(51200, 768) == (1, 1)
    assert qm.gemv_split(152576, 896) == (1, 1)
    assert qm.gemv_split(9728, 896) == (1, 2)
    assert qm.gemv_split(768, 3072) == (3, 8)
    assert qm.gemv_split(896, 4864) == (3, 8)
    assert qm.gemv_split(2304, 768) == (1, 8)
    assert qm.gemv_split(1152, 896) == (1, 8)
    assert qm.gemv_split(768, 768) == (1, 8)
    assert qm.gemv_split(3072, 768, mlp=True) == (1, 4) and qm.gemv_split(2304, 768, mlp=True) == (1, 4)
    assert qm.gemv_plan(1, "f32", ((768, 768, False, 4),), 132).split == 1
    for n, k in ((896, 4864), (768, 3072)):
        plan = qm.gemv_plan(1, "f32", ((n, k, False, 4),), 132)
        assert plan.split == 3 and plan.grid == 3 * (n // TILE)


def test_bad_plans_raise():
    """No rows, too many rows, several phases without the cooperative
    launch, or operand rows that leave no room for a slot: ValueError."""
    with pytest.raises(ValueError):
        qm.gemv_plan(0, "bf16", ((64, 64, False, 2),), 132)
    with pytest.raises(ValueError):
        qm.gemv_plan(9, "bf16", ((64, 64, False, 2),), 132)
    with pytest.raises(ValueError):
        qm.gemv_plan(1, "bf16", ((64, 64, False, 2), (64, 64, False, 2)), 132)
    with pytest.raises(ValueError):
        qm.gemv_plan(8, "f32", ((64, 1 << 14, False, 4),), 132)
