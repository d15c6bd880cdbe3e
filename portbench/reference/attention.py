"""The flash probe's attention, plain.

Softmax attention over (b, h, s, d), scores scaled by d^-0.5, causal. The
probe takes bf16 operands and gives a bf16 result (the configuration's
precision). The reference takes the operands' bf16 values and computes in
float64; the control computes with float8 (e4m3) operands and weights,
the precision below bf16, and f32 sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .matmul import bf16_values


def attention(q: np.ndarray, k: np.ndarray, v: np.ndarray, causal: bool = True) -> np.ndarray:
    """Attention of the bf16 values of q, k and v, in float64."""
    q, k, v = (bf16_values(t).astype(np.float64) for t in (q, k, v))
    scores = np.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
    if causal:
        s = scores.shape[-1]
        scores = np.where(np.tril(np.ones((s, s), dtype=bool)), scores, -np.inf)
    scores -= scores.max(axis=-1, keepdims=True)
    probs = np.exp(scores)
    probs /= probs.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", probs, v)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).float()


def control(q: np.ndarray, k: np.ndarray, v: np.ndarray, causal: bool = True,
            device: str = "cpu") -> np.ndarray:
    """The control: q, k, v and the softmax weights in float8 e4m3, sums
    in f32 (TF32 off), the result in bf16, on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tq, tk, tv = (_fp8(torch.from_numpy(np.ascontiguousarray(t)).to(device)) for t in (q, k, v))
    scores = torch.matmul(tq * tq.shape[-1] ** -0.5, tk.transpose(-1, -2))
    if causal:
        s = scores.shape[-1]
        keep = torch.ones((s, s), dtype=torch.bool, device=scores.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = _fp8(torch.softmax(scores, dim=-1))
    return torch.matmul(probs, tv).to(torch.bfloat16).float().cpu().numpy()
