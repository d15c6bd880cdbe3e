"""The card's peaks and the work each probe asks of it.

The least time the card could take for a piece of work is the larger of
its operations over the peak rate and its bytes over the peak bandwidth
(``bound``; the arithmetic of the port's ``chip_smoke.py``, frozen here).
A probe's work is counted from the shapes it asks for, each input byte
read once and each output byte written once, whatever kernel does it, so
a share reads the same work whoever implements it.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data-sheet peaks, dense, at a 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds the card could take, and what sets it."""
    compute_s = flops / PEAK_BF16_FLOPS
    memory_s = nbytes / PEAK_BYTES_PER_S
    if memory_s >= compute_s:
        return memory_s, "bytes"
    return compute_s, "operations"


def matmul_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(FLOPs, bytes) of C[m,n] = A[m,k] @ B[k,n], bf16 in and f32 out."""
    return 2.0 * m * k * n, 2.0 * (m * k + k * n) + 4.0 * m * n


def attention_work(batch: int, heads: int, seq: int, head_dim: int,
                   causal: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of softmax attention in bf16: Q K^T and P V over the
    (query, key) pairs it needs, s(s+1)/2 of them when causal; q, k and v
    read once, the output written once."""
    pairs = seq * (seq + 1) / 2 if causal else seq * seq
    flops = 4.0 * batch * heads * head_dim * pairs
    return flops, 2.0 * 4 * batch * heads * seq * head_dim


def mxu_probe_products(size: int, chain: int, iters: int) -> int:
    """The products one warm ``mxu_probe`` call asks for: the checked one,
    then ``iters`` timed chains of ``chain`` links and the one warm-up
    chain its runner replays first."""
    return 1 + (iters + 1) * chain


def mxu_probe_work(size: int, chain: int, iters: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one warm matmul probe at ``size``."""
    flops, nbytes = matmul_work(size, size, size)
    calls = mxu_probe_products(size, chain, iters)
    return flops * calls, nbytes * calls


def flash_probe_work(shape: tuple, causal: bool, calls: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash probe: ``calls`` attentions of
    ``shape`` (the checked one and the timed ones)."""
    flops, nbytes = attention_work(*shape, causal=causal)
    return flops * calls, nbytes * calls


def share_percent(work: tuple[float, float], seconds: float) -> float:
    """The work's bound over the time it took, in percent."""
    return 100.0 * bound(*work)[0] / seconds
