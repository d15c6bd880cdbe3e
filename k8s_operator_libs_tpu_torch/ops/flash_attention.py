"""Flash attention on the card: a hand-written CUDA kernel and its probe.

:func:`flash_attention` wraps the forward kernels of
``csrc/flash_attention.cu``: tiled softmax attention over (batch, heads,
seq, head_dim) with an online-softmax accumulator, so memory stays
O(tile * seq) instead of O(seq²), and causally dead K/V tiles above the
diagonal skipped outright. Two kernel families compute it: the ``wgmma``
family (TMA, warp-specialised, 128-row tiles) at head_dim 64 and 128 on
16-byte aligned operands, the ``mma_sync`` family (64-row tiles) at every
other call (:func:`kernel_family`). :func:`flash_attention_reference` is
its plain PyTorch version, which a tensor on the CPU takes.
:func:`flash_attention_probe` is the gate's numerics-checked throughput
probe of the tensor cores and the memory-to-shared-memory tile pipeline
together.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import tracing
from ..utils.device import DeviceLike, resolve_device
from ..utils.log import get_logger
from . import _build
from .probe_harness import ProbeReport, host_qkv, quantize, run_checked_probe
from .ring_attention import reference_attention

log = get_logger("ops.flash_attention")

_MASKED = -1e30

#: head_dim values the CUDA kernel is built for: the gate's burn-in (16),
#: ``BurninConfig()`` (32), a common width (64) and the probe (128).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

#: Query rows and keys in one tile of the ``mma_sync`` family (BQ = BKV in
#: ``csrc/flash_attention.cu``'s ``mma`` namespace).
KERNEL_TILE = 64

#: K/V tiles a chunk holds at most when a Q tile's K/V range is split over
#: several blocks (``split_plan``).
SPLIT_TILES = 4

#: head_dim values the ``wgmma`` family is built for.
WGMMA_HEAD_DIMS = (64, 128)

#: Query rows and keys in one tile of the ``wgmma`` family (BQ = BKV in
#: ``csrc/flash_attention.cu``'s ``hopper`` namespace).
WGMMA_TILE = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(batch_heads: int, seq: int, causal: bool, sms: int) -> tuple[int, int]:
    """How the ``mma_sync`` family cuts its work: ``(split, blocks)``.

    The kernel runs one block per (batch*head, Q tile) when that grid alone
    gives every one of the card's ``sms`` SMs two blocks, or when no Q
    tile sees more than ``SPLIT_TILES`` K/V tiles (``split`` 0). Otherwise
    each Q tile's K/V range is cut into chunks of at most ``SPLIT_TILES``
    tiles, one block each, and a second kernel combines them. ``blocks``
    counts the blocks that do work.
    """
    n_q = _cdiv(seq, KERNEL_TILE)

    def kv_tiles(iq: int) -> int:
        return min(n_q, iq + 1) if causal else n_q

    split = 0 if batch_heads * n_q >= 2 * sms or n_q <= SPLIT_TILES else SPLIT_TILES
    per_head = sum(_cdiv(kv_tiles(iq), split) if split else 1 for iq in range(n_q))
    return split, batch_heads * per_head


def wgmma_plan(
    batch_heads: int, seq: int, head_dim: int, causal: bool, sms: int
) -> tuple[int, int, int]:
    """How the ``wgmma`` family cuts its work: ``(split, blocks, scratch)``.

    One block per (batch*head, Q tile of ``WGMMA_TILE`` rows), and one
    block fits an SM. That grid runs as it is (``split`` 0) when it has a
    block for every SM, or when no Q tile sees more than two K/V tiles.
    Otherwise each Q tile's K/V range is cut into chunks of at most
    ``split`` tiles: the smallest ``split`` whose blocks still fit the
    card in one wave, and ``split`` 0 again where one chunk would cover
    every range. ``blocks`` counts the blocks that do work, ``scratch``
    the f32 elements of the chunks' partial outputs and (m, l) rows that
    the combine kernel reads (``k2_wgmma_scratch_elems``; 0 without one).
    """
    n_q = _cdiv(seq, WGMMA_TILE)
    kv = [min(n_q, iq + 1) if causal else n_q for iq in range(n_q)]

    def blocks(split: int) -> int:
        return batch_heads * sum(_cdiv(t, split) if split else 1 for t in kv)

    split = 0
    if batch_heads * n_q < sms and n_q > 2:
        split = next(s for s in range(1, n_q + 1) if blocks(s) <= sms)
        if split >= n_q:
            split = 0
    scratch = 0
    if split:
        scratch = batch_heads * n_q * _cdiv(n_q, split) * WGMMA_TILE * (head_dim + 2)
    return split, blocks(split), scratch


def kernel_family(head_dim: int, data_ptrs) -> str:
    """The kernel family a call on the card takes: ``wgmma`` when head_dim
    is in ``WGMMA_HEAD_DIMS`` and every base address in ``data_ptrs`` (q,
    k and v) is 16-byte aligned, as TMA needs; ``mma_sync`` otherwise."""
    if head_dim in WGMMA_HEAD_DIMS and all(ptr % 16 == 0 for ptr in data_ptrs):
        return "wgmma"
    return "mma_sync"


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The plain version of :func:`flash_attention`: q scaled by
    head_dim^-0.5 in f32, scores masked with -1e30, softmax and the
    weighted sum in f32, the result cast to q's dtype."""
    d = q.shape[-1]
    scores = torch.matmul(q.float() * d**-0.5, k.float().transpose(-1, -2))
    if causal:
        s = q.shape[2]
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _MASKED)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Attention over (batch, heads, seq, head_dim), forward only.

    A CUDA tensor goes through a kernel (bf16, contiguous, head_dim in
    ``KERNEL_HEAD_DIMS``, any seq) on the current stream, of the family
    :func:`kernel_family` picks (:func:`flash_path` says which; a view
    not 16-byte aligned takes the ``mma_sync`` family on an aligned
    copy). Each call that runs adds one to ``flash_attention.launches``,
    whether the work takes one kernel or two (``split_plan``,
    ``wgmma_plan``), and a call captured into a CUDA graph adds nothing.
    A CPU tensor takes :func:`flash_attention_reference`.
    """
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention needs q, k, v of one (batch, heads, seq, head_dim) "
            f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if len({q.device, k.device, v.device}) != 1 or len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("flash_attention operands must share device and dtype")
    if q.device.type != "cuda":
        return flash_attention_reference(q, k, v, causal=causal)
    b, h, s, d = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA flash kernel takes bf16, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA flash kernel is built for head_dim {KERNEL_HEAD_DIMS}, got {d}"
        )
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("the CUDA flash kernel takes contiguous operands")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the CUDA flash kernel is forward-only")
    family = kernel_family(d, (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    # The mma_sync family reads q, k and v 16 aligned bytes at a time
    # (cp.async): a view that starts between goes in as an aligned copy.
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    split, elems = _plan(family, b * h, s, d, causal, q.device.index)
    out = torch.empty_like(q)
    scratch = None
    if elems:
        scratch = torch.empty(elems, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    launch = (
        lib.k2_flash_attention_wgmma_bf16 if family == "wgmma" else lib.k2_flash_attention_bf16
    )
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b * h, s, d, int(causal), split, _build.stream_handle(q),
        )
    _build.check(lib, rc, "flash attention kernel launch")
    if not torch.cuda.is_current_stream_capturing():
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_path(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> str:
    """The path :func:`flash_attention` takes for these CUDA operands: the
    kernel family, with ``_split`` after it where the K/V ranges are split
    over several blocks and a combine kernel follows."""
    b, h, s, d = q.shape
    family = kernel_family(d, (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    split = _plan(family, b * h, s, d, causal, q.device.index)[0]
    return f"{family}_split" if split else family


@functools.lru_cache(maxsize=256)
def _plan(
    family: str, batch_heads: int, seq: int, head_dim: int, causal: bool, device_index: int
) -> tuple[int, int]:
    """``(split, scratch)`` for a call of ``family``: its plan's split at
    the card's SM count, and the f32 elements of scratch the C side asks
    for at that split (0: none). Worked out once a shape, off the per-call
    path."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    if family == "wgmma":
        split = wgmma_plan(batch_heads, seq, head_dim, causal, sms)[0]
        entry = "k2_wgmma_scratch_elems"
    else:
        split = split_plan(batch_heads, seq, causal, sms)[0]
        entry = "k2_scratch_elems"
    lib = _build.load("flash_attention")
    elems = ctypes.c_longlong()
    rc = getattr(lib, entry)(batch_heads, seq, head_dim, split, ctypes.byref(elems))
    _build.check(lib, rc, "flash attention scratch size")
    return split, elems.value

# Field-compatible alias kept for the public API (tpu.health report types).
FlashAttentionReport = ProbeReport


def flash_attention_probe(
    *,
    batch: int = 1,
    heads: int = 4,
    seq: int = 1024,
    head_dim: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    tol: float = 2e-2,
    device: DeviceLike = None,
) -> ProbeReport:
    """Numerics-checked causal flash attention throughput on one device
    (default ``cuda``). A crash inside the probe becomes a failed report;
    asking for ``cuda`` without a card raises. The operands' making and
    copy to the device are a ``flash.inputs`` span, the host oracle a
    ``flash.oracle`` span and the checked call a ``flash.check`` span
    (category ``probe``)."""
    dev = resolve_device(device)
    try:
        with tracing.span("flash.inputs", "probe"):
            q_host, k_host, v_host = host_qkv((batch, heads, seq, head_dim), seed=2)
            q, k, v = (
                torch.from_numpy(t).to(dtype).to(dev) for t in (q_host, k_host, v_host)
            )
        with tracing.span("flash.oracle", "probe"):
            expected = reference_attention(
                quantize(q_host, dtype),
                quantize(k_host, dtype),
                quantize(v_host, dtype),
                causal=True,
            )
        return run_checked_probe(
            "flash attention",
            lambda: flash_attention(q, k, v),
            expected,
            tokens=batch * seq,
            tol=tol,
        )
    except Exception as e:  # noqa: BLE001 - a broken kernel is a failed probe
        return ProbeReport(ok=False, error=str(e))
