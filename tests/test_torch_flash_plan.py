"""How the port's flash attention picks its kernel family and cuts the work
of the ``wgmma`` family, on the CPU: the rule and the plan are plain Python
that the card's launches follow (``ops/flash_attention.py``), checked here
without a tensor on the card."""

import pytest

from k8s_operator_libs_tpu_torch.ops import flash_attention as port

SMS = 132  # an H100 SXM's SMs
TILE = 128  # BQ = BKV of the wgmma family


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _c_scratch(bh: int, seq: int, head_dim: int, split: int) -> int:
    """``scratch_elems(hopper::BQ, ...)`` in ``csrc/flash_attention.cu``,
    transcribed: each chunk's partial O and (m, l) rows, or 0 where one
    chunk covers the longest range."""
    n_q = _cdiv(seq, TILE)
    chunks = _cdiv(n_q, split) if split > 0 else 1
    return 0 if chunks == 1 else bh * n_q * chunks * TILE * (head_dim + 2)


@pytest.mark.parametrize("seq", [1, 63, 64, 65, 127, 128, 129, 1000, 1024, 4096])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_wgmma_plan_covers_every_key_tile_once(seq, causal, head_dim):
    """The chunks of each Q tile cover its K/V tiles (those up to the
    diagonal when causal) without overlap, as the kernel cuts them, and the
    blocks add up; a split grid fits the card in one wave."""
    bh = 3
    split, blocks, scratch = port.wgmma_plan(bh, seq, head_dim, causal, SMS)
    n = _cdiv(seq, TILE)
    kv = [min(n, iq + 1) if causal else n for iq in range(n)]
    assert 0 <= split < max(n, 2)
    if split == 0:
        assert blocks == bh * n and scratch == 0
        return
    assert blocks <= SMS
    chunks = [_cdiv(t, split) for t in kv]
    assert blocks == bh * sum(chunks)
    for t, c in zip(kv, chunks):
        bounds = [i * t // c for i in range(c + 1)]  # t0, t1 of each chunk
        assert bounds[0] == 0 and bounds[-1] == t
        assert all(0 < hi - lo <= split for lo, hi in zip(bounds, bounds[1:]))


@pytest.mark.parametrize(
    "bh,seq,head_dim,causal,split,blocks",
    [
        (4, 1024, 128, True, 2, 80),  # the gate's probe: 32 Q tiles of 128 rows
        (4, 1024, 128, False, 2, 128),
        (4, 1024, 64, True, 2, 80),
        (32, 4096, 128, True, 0, 1024),  # (2, 16, 4096, 128): enough Q tiles
        (32, 4096, 128, False, 0, 1024),
        (1, 4096, 128, True, 5, 119),
        (2, 200, 128, True, 0, 4),  # two K/V tiles at most: never split
    ],
)
def test_wgmma_plan_at_named_shapes(bh, seq, head_dim, causal, split, blocks):
    got = port.wgmma_plan(bh, seq, head_dim, causal, SMS)
    assert got == (split, blocks, _c_scratch(bh, seq, head_dim, split))


@pytest.mark.parametrize("bh,seq", [(1, 1), (3, 129), (4, 1024), (2, 1000), (1, 4096), (32, 4096)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_wgmma_plan_scratch_is_the_c_formula(bh, seq, causal, head_dim):
    """The plan's scratch is what ``k2_wgmma_scratch_elems`` asks for at the
    plan's split (the card test compares it with the C entry itself)."""
    split, _, scratch = port.wgmma_plan(bh, seq, head_dim, causal, SMS)
    assert scratch == _c_scratch(bh, seq, head_dim, split)
    if split:
        n = _cdiv(seq, TILE)
        assert scratch == bh * n * _cdiv(n, split) * TILE * (head_dim + 2)


@pytest.mark.parametrize(
    "offsets,aligned",
    [((0, 0, 0), True), ((16, 4096, 32), True), ((2, 0, 0), False), ((0, 0, 8), False),
     ((0, 14, 0), False)],
)
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_kernel_family_rule(head_dim, offsets, aligned):
    """``wgmma`` exactly when head_dim is 64 or 128 and q, k and v all start
    on 16 bytes (TMA's need); ``mma_sync`` for every other call, so head_dim
    16 and 32 (the burn-in's and the entry's widths) and misaligned views."""
    base = 0x7F0000000000
    ptrs = tuple(base + off for off in offsets)
    want = "wgmma" if head_dim in (64, 128) and aligned else "mma_sync"
    assert port.kernel_family(head_dim, ptrs) == want


def test_wgmma_head_dims_are_kernel_head_dims():
    assert set(port.WGMMA_HEAD_DIMS) <= set(port.KERNEL_HEAD_DIMS)
    assert port.WGMMA_TILE == TILE
