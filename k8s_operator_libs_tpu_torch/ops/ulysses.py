"""Ulysses attention's per-device core.

Only :func:`local_causal_attention` so far: the plain causal attention the
burn-in model trains through. The all-to-all sequence parallelism comes
with the multi-GPU slice.
"""

from __future__ import annotations

import torch

from .probe_harness import ProbeReport


def local_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain causal softmax attention on (b, h, s, d), f32 core."""
    s = q.shape[2]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum(
        "bhqd,bhkd->bhqk", q.float() * scale, k.float()
    )
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


# Field-compatible alias kept for the public API (tpu.health report types).
UlyssesReport = ProbeReport
