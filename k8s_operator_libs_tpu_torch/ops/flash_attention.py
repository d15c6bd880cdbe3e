"""Flash attention on the card: a hand-written CUDA kernel and its probe.

:func:`flash_attention` wraps the forward kernel of
``csrc/flash_attention.cu``: tiled softmax attention over (batch, heads,
seq, head_dim) with an online-softmax accumulator, so memory stays
O(tile * seq) instead of O(seq²), and causally dead K/V tiles above the
diagonal skipped outright. :func:`flash_attention_reference` is its plain
PyTorch version, which a tensor on the CPU takes.
:func:`flash_attention_probe` is the gate's numerics-checked throughput
probe of the tensor cores and the memory-to-shared-memory tile pipeline
together.
"""

from __future__ import annotations

import torch

from ..utils.device import DeviceLike, resolve_device
from ..utils.log import get_logger
from . import _build
from .probe_harness import ProbeReport, host_qkv, quantize, run_checked_probe
from .ring_attention import reference_attention

log = get_logger("ops.flash_attention")

_MASKED = -1e30

#: head_dim values the CUDA kernel is built for.
KERNEL_HEAD_DIMS = (128,)


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

    A CUDA tensor goes through the kernel (bf16, contiguous, head_dim 128, any
    seq) on the current stream; each launch adds one to
    ``flash_attention.launches``. A CPU tensor takes
    :func:`flash_attention_reference`.
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
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.k2_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, s, d, int(causal), _build.stream_handle(q),
        )
    _build.check(lib, rc, "flash attention kernel launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

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
    asking for ``cuda`` without a card raises."""
    dev = resolve_device(device)
    try:
        q_host, k_host, v_host = host_qkv((batch, heads, seq, head_dim), seed=2)
        q, k, v = (
            torch.from_numpy(t).to(dtype).to(dev) for t in (q_host, k_host, v_host)
        )
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
