"""The host-side launch plans of the Hopper prefill kernels, on the CPU:
``quant_matmul.matmul_plan`` (tokens a block, split-K cluster size of
``csrc/quant_matmul.cu`` and of ``csrc/quant_matmul_w8a8.cu``, each with its
own cluster capacity), ``matmul.fused_plan`` (route and split-K of
``csrc/matmul_fused.cu``) and ``attention.flash_plan`` (row tiles, split-KV
cluster size of ``csrc/flash_attention.cu``).

Each plan is checked for coverage (every K step and every KV tile a row
needs is walked by exactly one rank, and no tile a row cannot see, with
each rank's range as the kernels compute it on the device: ``split_ranges``
and ``flash_tile_ranges`` below copy that arithmetic, so the card tests at
split and tile edges are what hold the kernels to it), for the hardware's
limits (a cluster of at most 8 blocks, grid y and z at most
65535, the K steps or KV tiles at least the split), and for where the split
turns on: exactly where the output tiles alone would leave most of the SMs
idle, and (given the device's cluster capacity, modelled here on an
H100's GPCs) only as far as every cluster runs at once.
"""

import random

import numpy as np
import pytest

import torch

from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import matmul as mf
from rten_tpu_torch.kernels import quant_matmul as qm

H100_SMS = 132
# A model of an H100's cluster capacity for the matmul's blocks: eight GPCs
# of uneven size (132 SMs in all); a cluster lives in one GPC, and a
# 128-token block fills its SM (a 64-token one takes half).
H100_GPCS = (18, 18, 18, 18, 16, 16, 14, 14)


def _fits(per_sm: int) -> tuple[int, ...]:
    return tuple(sum(g * per_sm // c for g in H100_GPCS) for c in range(1, qm.MAX_SPLIT + 1))


FITS = {64: _fits(2), 128: _fits(1)}
# The one-launch W8A8 kernel plans its 64-token block at two a SM
# (w8a8_base_smem) and its 128-token blocks at one; matmul_fused's wgmma
# blocks (192 KB rings) and its f32 block (165 registers a thread) fill an
# SM each.
FITS_W8A8 = {(64, 64): _fits(2), (128, 64): _fits(1), (128, 128): _fits(1)}
FITS_FUSED = _fits(1)

# The prefill projections of GPT-2-small (d 768, d_ff 3072, vocab padded to
# 51200) and of the Qwen2-0.5B shape (d 896, qkv 1152, w_gu 10240, d_ff
# 4864), at the prompts the chip check runs, and ragged shapes.
MATMUL_SHAPES = [
    (m, n, k)
    for m in (9, 20, 64, 65, 512)
    for n, k in ((2304, 768), (768, 768), (3072, 768), (768, 3072), (51200, 768),
                 (1152, 896), (896, 896), (10240, 896), (896, 4864))
] + [(2048, 2048, 2048), (9, 200, 16), (40, 131, 400), (64, 72, 1040), (300, 1000, 528)]


def split_ranges(n: int, split: int) -> list[tuple[int, int]]:
    """The ``[begin, end)`` of each of ``split`` ranks over ``n`` steps, as
    both kernels divide K steps and KV tiles: rank r takes
    ``[r n / split, (r + 1) n / split)``."""
    return [(r * n // split, (r + 1) * n // split) for r in range(split)]


def flash_tile_ranges(row_tile, tq, group, q_offset, kv_len, s, causal, split):
    """The KV tiles each rank of a split cluster walks for one row tile, as
    ``flash_mma_kernel`` computes them: kv_len clamped to [0, S]; the tiles
    up to the block's last query's diagonal (causal) or kv_len."""
    kv_len = min(max(kv_len, 0), s)
    last_q = min(row_tile * at.FB_ROWS + at.FB_ROWS - 1, tq * group - 1) // group
    kv_end = min(kv_len, q_offset + last_q + 1) if causal else kv_len
    return split_ranges(-(-kv_end // at.FB_KV) if kv_end > 0 else 0, split)


def _covered_once(ranges, n):
    steps = [i for lo, hi in ranges for i in range(lo, hi)]
    return sorted(steps) == list(range(n))


@pytest.mark.parametrize("n,split", [(0, 1), (5, 8), (7, 3), (24, 8), (97, 6)])
def test_split_ranges_cover_each_step_once(n, split):
    ranges = split_ranges(n, split)
    assert len(ranges) == split
    assert _covered_once(ranges, n)
    assert all(lo <= hi for lo, hi in ranges)
    if split <= n:  # no rank idle
        assert all(hi > lo for lo, hi in ranges)


@pytest.mark.parametrize("m,n,k", MATMUL_SHAPES)
def test_matmul_plan_limits_and_coverage(m, n, k):
    fits = FITS[qm.matmul_tokens(m)]
    tok, split = qm.matmul_plan(m, n, k, H100_SMS, fits)
    steps = -(-k // qm.QW_BK)
    tiles = -(-n // tok) * -(-m // tok)
    assert tok in (64, 128) and (tok == 64) == (m <= 64)
    assert 1 <= split <= qm.MAX_SPLIT and split <= steps
    assert split == 1 or tiles <= fits[split - 1]  # every cluster runs at once
    assert -(-m // tok) <= 65535
    # every K step once, and the steps cover [0, K)
    ranges = split_ranges(steps, split)
    assert _covered_once(ranges, steps)
    assert ranges[-1][1] * qm.QW_BK >= k > (ranges[-1][1] - 1) * qm.QW_BK
    # the split turns on exactly where the tiles leave most SMs idle (and a
    # cluster of two fits them all), and then never puts more blocks on the
    # card than it has SMs
    assert (split > 1) == (2 * tiles < H100_SMS and steps > 1 and tiles <= fits[1])
    if split > 1:
        assert tiles * split <= H100_SMS


def test_matmul_plan_main_path_splits():
    """The few-tile projections split K; the wide ones do not (at 64 rows
    GPT-2 down 12 tiles x 8, wo 12 x 6, Qwen2 w_down 14 x 8; at 512 rows,
    128 x 128 tiles, GPT-2 down 24 x 4, Qwen2 qkv 36 x 3)."""
    def plan(m, n, k):
        return qm.matmul_plan(m, n, k, H100_SMS, FITS[qm.matmul_tokens(m)])

    assert plan(64, 768, 3072) == (64, 8)
    assert plan(64, 768, 768) == (64, 6)
    assert plan(64, 896, 4864) == (64, 8)
    assert plan(64, 10240, 896) == (64, 1)
    assert plan(512, 768, 3072) == (128, 4)  # 24 clusters of 5 do not fit 8 GPCs at once
    assert plan(512, 1152, 896) == (128, 3)
    assert plan(512, 10240, 896) == (128, 1)
    assert plan(2048, 2048, 2048) == (128, 1)
    # without the device's capacity, as many as fill the SMs
    assert qm.matmul_plan(512, 768, 3072, H100_SMS) == (128, 5)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
def test_matmul_plan_other_cards(sms):
    rnd = random.Random(sms)
    for _ in range(200):
        m, n, k = rnd.randint(9, 4096), rnd.randint(1, 20000), 16 * rnd.randint(1, 400)
        tok, split = qm.matmul_plan(m, n, k, sms)
        tiles = -(-n // tok) * -(-m // tok)
        assert 1 <= split <= min(qm.MAX_SPLIT, -(-k // qm.QW_BK))
        assert (split > 1) == (2 * tiles < sms and k > qm.QW_BK)
        assert split == 1 or tiles * split <= sms


FLASH_SHAPES = [  # b, hq, hk, tq, s
    (1, 12, 12, tq, 768) for tq in (1, 2, 5, 8, 24, 64, 100, 512)
] + [(1, 14, 2, tq, 1024) for tq in (1, 8, 24, 64, 512)] + [
    (2, 4, 4, 24, 512), (2, 4, 4, 8, 512), (1, 4, 4, 16, 1024), (2, 14, 2, 100, 256), (8, 12, 12, 1, 768),
    (1, 32, 8, 3000, 4096), (4, 2, 1, 9, 64),
]


@pytest.mark.parametrize("b,hq,hk,tq,s", FLASH_SHAPES)
def test_flash_plan_limits(b, hq, hk, tq, s):
    row_tiles, split = at.flash_plan(b, hq, hk, tq, s, H100_SMS)
    group = hq // hk
    assert (row_tiles - 1) * at.FB_ROWS < tq * group <= row_tiles * at.FB_ROWS
    kv_tiles = -(-s // at.FB_KV)
    assert 1 <= split <= min(qm.MAX_SPLIT, kv_tiles)
    assert hk <= 65535 and b <= 65535
    base = row_tiles * hk * b
    assert (split > 1) == (2 * base < H100_SMS and kv_tiles > 1)
    if split > 1:
        assert base * split <= H100_SMS


def test_flash_plan_main_path_splits():
    """Short prompts and the <= 8-row chunks split KV; 512-token prompts
    (96 and 112 blocks) do not."""
    assert at.flash_plan(1, 12, 12, 24, 768, H100_SMS) == (1, 8)
    assert at.flash_plan(1, 12, 12, 64, 768, H100_SMS) == (1, 8)
    assert at.flash_plan(1, 14, 2, 64, 1024, H100_SMS) == (7, 8)
    assert at.flash_plan(1, 14, 2, 8, 1024, H100_SMS) == (1, 8)
    assert at.flash_plan(1, 12, 12, 512, 768, H100_SMS) == (8, 1)
    assert at.flash_plan(1, 14, 2, 512, 1024, H100_SMS) == (56, 1)


def _needed_tiles(row_tile, tq, group, q_offset, kv_len, s, causal):
    """KV tiles holding a column some row of the tile may attend to."""
    kv_len = min(max(kv_len, 0), s)
    rows = range(row_tile * at.FB_ROWS, min((row_tile + 1) * at.FB_ROWS, tq * group))
    cols = set()
    for r in rows:
        hi = min(kv_len, q_offset + r // group + 1) if causal else kv_len
        cols.update(range(hi))
    return sorted({c // at.FB_KV for c in cols})


@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiles_cover_each_needed_tile_once(causal):
    """Every KV tile some row of a block may see is walked by exactly one
    rank of its cluster; no tile wholly past kv_len or above the block's
    diagonal is read (kv_len clamped to [0, S])."""
    for b, hq, hk, tq, s in FLASH_SHAPES[:16]:
        row_tiles, split = at.flash_plan(b, hq, hk, tq, s, H100_SMS)
        group = hq // hk
        rnd = random.Random(tq * 1000 + s)
        for q_offset, kv_len in [(0, tq), (0, 0), (s - tq, s), (300 % s, 300 % s + tq), (0, s + 50), (7, -3)] + [
                (rnd.randint(0, s), rnd.randint(-5, s + 5)) for _ in range(6)]:
            for rt in range(row_tiles):
                ranges = flash_tile_ranges(rt, tq, group, q_offset, kv_len, s, causal, split)
                walked = sorted(i for lo, hi in ranges for i in range(lo, hi))
                assert len(ranges) == split
                assert walked == _needed_tiles(rt, tq, group, q_offset, kv_len, s, causal), \
                    (b, hq, hk, tq, s, rt, q_offset, kv_len)


@pytest.mark.parametrize("m,n,k", MATMUL_SHAPES)
def test_w8a8_plan_limits_and_coverage(m, n, k):
    """The W8A8 matmul's plan: every K step once, the split at most 8, the
    steps and what the chosen block's cluster capacity fits."""
    tok, ch, _ = qm.w8a8_plan(m, n, k, H100_SMS)
    fits = FITS_W8A8[tok, ch]
    tok, ch, split = qm.w8a8_plan(m, n, k, H100_SMS, fits)
    steps = -(-k // qm.QW_BK)
    tiles = -(-n // (ch * tok // 64)) * -(-m // tok)
    assert tok == qm.matmul_tokens(m) and ch in (64, 128) and (ch == 64 or tok == 128)
    assert 1 <= split <= min(qm.MAX_SPLIT, steps)
    assert split == 1 or (tiles <= fits[split - 1] and tiles * split <= H100_SMS)
    assert _covered_once(split_ranges(steps, split), steps)
    assert (split > 1) == (2 * tiles < H100_SMS and steps > 1 and tiles <= fits[1])


def test_w8a8_plan_main_path_splits():
    """The W8A8 blocks and splits at both models' projections at 64 and 512
    rows (GPT-2 qkv, wo, up, down; Qwen2-0.5B qkv, w_gu, w_down) and
    2048^3: the wide block (128 channels a warpgroup) wherever a block has
    128 tokens, split-K where its tiles are few."""
    def plan(m, n, k):
        tok, ch, _ = qm.w8a8_plan(m, n, k, H100_SMS)
        return qm.w8a8_plan(m, n, k, H100_SMS, FITS_W8A8[tok, ch])[1:]

    gpt2 = [(2304, 768), (768, 768), (3072, 768), (768, 3072)]
    qwen2 = [(1152, 896), (10240, 896), (896, 4864)]
    assert [plan(64, n, k) for n, k in gpt2] == [(64, 3), (64, 6), (64, 2), (64, 8)]
    assert [plan(64, n, k) for n, k in qwen2] == [(64, 7), (64, 1), (64, 8)]
    assert [plan(512, n, k) for n, k in gpt2] == [(128, 3), (128, 6), (128, 2), (128, 8)]
    assert [plan(512, n, k) for n, k in qwen2] == [(128, 6), (128, 1), (128, 7)]
    assert plan(2048, 2048, 2048) == (128, 1)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
def test_w8a8_plan_other_cards(sms):
    """On other SM counts (a fraction of each GPC's SMs): the wide block
    wherever a block has 128 tokens, within the capacity, no more blocks
    than SMs where the split is on."""
    rnd = random.Random(sms + 1)
    for _ in range(200):
        m, n, k = rnd.randint(9, 4096), rnd.randint(1, 20000), 16 * rnd.randint(1, 400)
        tok, ch, _ = qm.w8a8_plan(m, n, k, sms)
        fits = tuple(max(1, f * sms // H100_SMS) for f in FITS_W8A8[tok, ch])
        tok, ch, split = qm.w8a8_plan(m, n, k, sms, fits)
        assert (ch == 128) == (tok == 128)
        tiles = -(-n // (ch * tok // 64)) * -(-m // tok)
        assert 1 <= split <= min(qm.MAX_SPLIT, -(-k // qm.QW_BK))
        assert split == 1 or (tiles * split <= sms and tiles <= fits[split - 1])


def _w8a8_full_plan(m, n, k, act_bytes, sms=H100_SMS):
    """What ``w8a8_device_plan`` computes on a card of ``sms`` SMs, with
    the modelled capacities: (tok, ch, split, stages, slots, resident,
    smem, budget)."""
    tok, ch, _ = qm.w8a8_plan(m, n, k, sms)
    tok, ch, split = qm.w8a8_plan(m, n, k, sms, FITS_W8A8[tok, ch])
    tiles = -(-n // (ch * tok // 64)) * -(-m // tok)
    budget = qm.w8a8_budget(tok, tiles, split, sms, _fits(1) if tok == 64 else None)
    lay = qm.w8a8_layout(tok, ch, k, split, act_bytes, budget)
    return tok, ch, split, lay.stages, lay.slots, lay.resident, lay.smem, budget


@pytest.mark.parametrize("m,n,k", MATMUL_SHAPES)
def test_w8a8_layout_limits(m, n, k):
    """The one-launch W8A8 block's shared memory, for f32 and bf16 rows:
    within its budget and the 227 KB a block may have (two 64-token blocks
    an SM unless every block has an SM of its own), a slot a K step where
    resident, at least two slots where the rows arrive twice, at least two
    ring stages for a rank of two steps or more, none more than the rank's
    steps; room for the epilogue's int32 sums; and w8a8_smem's count."""
    for act_bytes in (2, 4):
        tok, ch, split, stages, slots, resident, smem, budget = _w8a8_full_plan(m, n, k, act_bytes)
        most = -(-(-(-k // qm.QW_BK)) // split)
        bn = ch * tok // 64
        assert smem == qm.w8a8_smem(tok, ch, stages, slots, act_bytes) <= budget <= 232448
        tiles = -(-n // bn) * -(-m // tok)
        alone = tiles * split <= H100_SMS and tiles <= _fits(1)[split - 1]  # every cluster at once, a block an SM
        assert budget == (232448 if tok == 128 or alone else 233472 // 2 - 1024)
        assert min(most, 2) <= stages <= min(most, qm.W8A8_STAGES_MAX[tok, ch])
        assert resident == (slots == most) and (resident or 2 <= slots < most)
        assert smem - 1024 - 8 * (2 * stages + slots) - 12 * tok >= tok * (bn + 4) * 4


def test_w8a8_layout_main_path():
    """The one-launch blocks at both models' projections (bf16 rows): at 64
    rows every GPT-2 projection and the Qwen2-0.5B shape's qkv and w_down
    keep their rank's K range resident (w_down's 5 steps with a block an
    SM: 112 blocks), Qwen2 w_gu (160 blocks, two an SM) reads its rows
    twice; at 512 rows (128 x 256 blocks, split-K) every GPT-2 projection
    and Qwen2 qkv are resident, Qwen2 w_gu (160 blocks), w_down (6 steps a
    rank) and 2048^3 read their rows twice, three ring stages beside two
    slots."""
    def plan(m, n, k, act_bytes=2):
        return _w8a8_full_plan(m, n, k, act_bytes)[:6]

    gpt2 = [(2304, 768), (768, 768), (3072, 768), (768, 3072)]
    qwen2 = [(1152, 896), (10240, 896), (896, 4864)]
    assert [plan(64, n, k) for n, k in gpt2] == [
        (64, 64, 3, 2, 2, True), (64, 64, 6, 1, 1, True), (64, 64, 2, 3, 3, True), (64, 64, 8, 3, 3, True)]
    assert [plan(64, n, k) for n, k in qwen2] == [
        (64, 64, 7, 1, 1, True), (64, 64, 1, 3, 3, False), (64, 64, 8, 4, 5, True)]
    assert [plan(512, n, k) for n, k in gpt2] == [
        (128, 128, 3, 2, 2, True), (128, 128, 6, 1, 1, True), (128, 128, 2, 2, 3, True), (128, 128, 8, 2, 3, True)]
    assert [plan(512, n, k) for n, k in qwen2] == [
        (128, 128, 6, 2, 2, True), (128, 128, 1, 3, 2, False), (128, 128, 7, 3, 2, False)]
    assert plan(2048, 2048, 2048) == (128, 128, 1, 3, 2, False)
    assert plan(2048, 2048, 2048, 4) == (128, 128, 1, 2, 2, False)  # f32 rows: 64 KB slots


def _convert_schedule(n, slots):
    """The converting warpgroup's activation loads and reads over a rank of
    ``n`` K steps, as csrc/quant_matmul_w8a8.cu Q8Convert numbers them:
    load l < n is pass 1's step l, load l >= n pass 2's step l - n; load l
    goes to slot l % slots; pass 2's i-th step is (i + max(n - slots, 0)) %
    n, read from the slot pass 1 left it in (i < slots) or from load n + i
    - slots. Checks that every read finds the load it waits for in its slot
    (the load's phase l // slots is the slot's next), and returns pass 2's
    steps."""
    held, loads = {}, {}  # slot -> (load, step) it holds; slot -> loads issued to it

    def load(l):
        slot = l % slots
        loads.setdefault(slot, []).append(l)
        assert len(loads[slot]) - 1 == l // slots  # the slot's phases in load order
        held[slot] = (l, l if l < n else l - n)

    for l in range(min(slots, n)):
        load(l)
    for l in range(n):  # pass 1
        assert held[l % slots] == (l, l)
        if l + slots < n:
            load(l + slots)
    order = []
    for i in range(n):  # pass 2
        step = (i + max(n - slots, 0)) % n
        if i < slots:
            assert held[step % slots][1] == step
        else:
            assert held[(n + i - slots) % slots] == (n + i - slots, step)
        order.append(step)
        if i + slots < n:
            load(n + i)
    return order, sum(len(v) for v in loads.values())


@pytest.mark.parametrize("slots", [1, 2, 3, 4, 5])
def test_w8a8_convert_schedule(slots):
    """Every K step of a rank reaches pass 2 once; the steps pass 1 leaves
    in their slots are not loaded again, so a rank loads n + max(n -
    slots, 0) slots in all (resident: n)."""
    for n in range(1, 25):
        order, n_loads = _convert_schedule(n, slots)
        assert sorted(order) == list(range(n))
        assert n_loads == n + max(n - slots, 0)


def _codes_without_division(x, scale):
    """csrc/common.cuh quantize16 in numpy f32: q = x * (1 / scale), rounded
    by adding 1.5 * 2^23; values within 2^-14 of a half-integer, and NaN,
    are marked for x / scale (rows whose scale is below 2^-126: None)."""
    x = x.astype(np.float32)
    scale = np.float32(scale)
    if not scale >= np.float32(2.0**-126):
        return None
    magic = np.float32(12582912.0)
    with np.errstate(invalid="ignore"):
        q = x * (np.float32(1) / scale)
        u = q + magic
        near = ~(np.abs(q - (u - magic)) <= np.float32(0.5) - np.float32(2.0**-14))
    codes = (u.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    return codes, near


def test_w8a8_codes_without_division_equal_ieee():
    """The one-launch kernel's codes (a product by 1 / scale, exact division
    only near a half-integer) equal clip(rint(x / scale), ±127) with IEEE
    division, over wide random rows, bf16-rounded rows, rows of exact
    half-integers and rows whose absmax is tiny or huge."""
    rng = np.random.default_rng(0)
    random_rows = [rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30) for _ in range(64)]
    random_rows += [torch.tensor(rng.standard_normal(768)).to(torch.bfloat16).float().numpy() for _ in range(64)]
    base = rng.integers(-127, 128, 4096).astype(np.float32)
    rows = [(base + np.float32(0.5)) * np.float32(s) for s in (1.0, 0.37, 3.0e-20, 7.1e25)]
    rows += [np.concatenate([[127.0], rng.integers(-254, 255, 4095) / 2.0]).astype(np.float32)]
    marked = []
    for i, row in enumerate(random_rows + rows):
        x = row.astype(np.float32)
        amax = np.abs(x).max()
        scale = np.float32(1.0) if amax == 0 else np.float32(amax) / np.float32(127.0)
        want = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        codes, near = _codes_without_division(x, scale)
        assert np.array_equal(codes[~near], want[~near])
        if i < len(random_rows):
            marked.append(near.mean())
    assert np.mean(marked) < 0.002  # the exact division stays rare (in bf16 rows a value at absmax / 2 is a tie)


# (m, k, n) of matmul_fused: the chip check's shapes, the card tests' ragged
# and swizzle-crossing ones, and few-tile shapes that split.
FUSED_SHAPES = [(512, 768, 3072), (2048, 2048, 2048), (1024, 1024, 1024), (64, 3072, 768), (77, 136, 200),
                (129, 1040, 520), (300, 4864, 896), (1, 64, 64), (1, 7, 8), (3, 300, 200), (130, 64, 256),
                (4096, 4096, 4096)]


@pytest.mark.parametrize("route", ["wgmma", "f32"])
@pytest.mark.parametrize("m,k,n", FUSED_SHAPES)
def test_fused_plan_limits_and_coverage(route, m, k, n):
    bn, split = mf.fused_plan(route, m, n, k, H100_SMS, FITS_FUSED)
    steps = -(-k // mf.FUSED_BK[route])
    tiles = -(-m // mf.FUSED_BM) * -(-n // bn)
    assert bn in ((128, 256) if route == "wgmma" else (128,))
    assert 1 <= split <= min(qm.MAX_SPLIT, steps)
    assert split == 1 or (tiles <= FITS_FUSED[split - 1] and tiles * split <= H100_SMS)
    ranges = split_ranges(steps, split)
    assert _covered_once(ranges, steps)
    assert ranges[-1][1] * mf.FUSED_BK[route] >= k > (ranges[-1][1] - 1) * mf.FUSED_BK[route]
    assert (split > 1) == (2 * tiles < H100_SMS and steps > 1 and tiles <= FITS_FUSED[1])


def test_fused_plan_pinned_splits():
    """The timed shapes: 512 x 768 x 3072 (96 tiles of 128 columns) does
    not split; 2048^3 and 4096^3 take 256-column blocks (128 and 512 of
    them: at least 7/8 of the SMs) unsplit; 1024^3 f32 (64 tiles) splits
    in two; the up projection's transpose at 64 rows (6 tiles) eight ways;
    the ragged route never."""
    def plan(route, m, k, n):
        return mf.fused_plan(route, m, n, k, H100_SMS, FITS_FUSED)

    assert plan("wgmma", 512, 768, 3072) == (128, 1)
    assert plan("wgmma", 2048, 2048, 2048) == (256, 1)
    assert plan("wgmma", 4096, 4096, 4096) == (256, 1)
    assert plan("f32", 1024, 1024, 1024) == (128, 2)
    assert plan("f32", 4096, 4096, 4096) == (128, 1)
    assert plan("wgmma", 64, 3072, 768) == (128, 8)
    assert plan("ragged", 64, 3070, 768) == (128, 1)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
def test_fused_plan_other_cards(sms):
    rnd = random.Random(sms + 2)
    for _ in range(200):
        route = rnd.choice(["wgmma", "f32"])
        m, k, n = rnd.randint(1, 4096), rnd.randint(1, 6000), rnd.randint(1, 6000)
        bn, split = mf.fused_plan(route, m, n, k, sms)
        assert (bn == 256) == (route == "wgmma" and 8 * -(-m // mf.FUSED_BM) * -(-n // 256) >= 7 * sms)
        tiles = -(-m // mf.FUSED_BM) * -(-n // bn)
        assert 1 <= split <= min(qm.MAX_SPLIT, -(-k // mf.FUSED_BK[route]))
        assert split == 1 or tiles * split <= sms
@pytest.mark.parametrize("dtype,k,n,aligned,route", [
    (torch.float32, 7, 8, True, "f32"), (torch.float32, 1024, 1024, False, "f32"),
    (torch.bfloat16, 768, 3072, True, "wgmma"), (torch.bfloat16, 8, 8, True, "wgmma"),
    (torch.bfloat16, 3070, 768, True, "ragged"), (torch.bfloat16, 768, 3070, True, "ragged"),
    (torch.bfloat16, 768, 3072, False, "ragged"),
])
def test_fused_route_by_shape(dtype, k, n, aligned, route):
    """bf16 rows TMA can address (16-byte multiples on aligned bases) take
    the wgmma route, other bf16 the ragged one, f32 the f32 one."""
    assert mf.fused_route(dtype, k, n, aligned) == route
