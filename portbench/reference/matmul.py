"""The matmul probe's products, plain.

The probe multiplies bf16 operands into an f32 result (the configuration's
precision): once as its checked product A @ B, and in its timed chain,
whose links each cast the previous f32 result to bf16 and multiply it by
B / sqrt(n) (cast to bf16), starting from A. The reference takes the
operands' bf16 values and multiplies them in float64, rounding each link's
result to f32 and then to bf16 where the probe does. The controls are the
same in the precision below: the checked product with a bf16 result, and
the chain with float8 (e4m3, scaled per tensor) operands, the step below
the bf16 that the chain carries between its links.
"""

from __future__ import annotations

import numpy as np


def bf16_values(x: np.ndarray) -> np.ndarray:
    """The values a bf16 cast keeps, in f32."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float().numpy()


def product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A @ B of the bf16 values of ``a`` and ``b``, in float64."""
    return bf16_values(a).astype(np.float64) @ bf16_values(b).astype(np.float64)


def control(a: np.ndarray, b: np.ndarray, device: str = "cpu") -> np.ndarray:
    """The control: the same product with a bf16 result, on ``device``."""
    import torch

    ta = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).to(device)
    tb = torch.from_numpy(np.ascontiguousarray(b)).to(torch.bfloat16).to(device)
    return torch.matmul(ta, tb).float().cpu().numpy()


def chain_operands(a: np.ndarray, b: np.ndarray, device: str):
    """The chain's start and multiplier as the probe makes them (A, and B
    scaled by 1/sqrt(n), each cast to bf16), in float64 on ``device``."""
    import torch

    start = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    step = torch.from_numpy(np.ascontiguousarray(b / np.sqrt(b.shape[0]))).to(torch.bfloat16)
    return start.to(device).double(), step.to(device).double()


def chain(a: np.ndarray, b: np.ndarray, links: int, device: str = "cpu") -> np.ndarray:
    """The chain's last link, f32: each link the bf16 value of the last
    result times the bf16 step in float64, rounded to f32."""
    import torch

    acc, step = chain_operands(a, b, device)
    for _ in range(links):
        acc = (acc.float().to(torch.bfloat16).double() @ step).float().double()
    return acc.cpu().numpy()


def _fp8(t):
    """``t`` through float8 e4m3 with a per-tensor scale, back in float64."""
    import torch

    scale = t.abs().max().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).double() * scale


def chain_control(a: np.ndarray, b: np.ndarray, links: int, device: str = "cpu") -> np.ndarray:
    """The control: the chain with each link's operands in float8 e4m3."""
    acc, step = chain_operands(a, b, device)
    step = _fp8(step)
    for _ in range(links):
        acc = (_fp8(acc) @ step).float().double()
    return acc.cpu().numpy()
