"""Shared harness for numerics-checked attention probes.

A probe runs the op on the device, compares it with the host oracle
(``reference_attention``) on the same quantized inputs, then times three
runs after the first. The quick battery of the JAX package waits for the
collectives slice of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils.device import synchronize
from ..utils.log import get_logger

log = get_logger("ops.probe")


@dataclass
class ProbeReport:
    ok: bool
    max_abs_err: float = 0.0
    elapsed_s: float = 0.0
    tokens_per_s: float = 0.0
    error: str = ""


def host_qkv(shape: tuple[int, ...], seed: int) -> tuple[np.ndarray, ...]:
    """Host-generated q/k/v: the same seed gives the same operands here and
    in the JAX package."""
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape, dtype=np.float32) for _ in range(3)
    )


def quantize(t: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The values the device actually saw, back in f32 for the oracle."""
    return torch.from_numpy(np.ascontiguousarray(t)).to(dtype).float().numpy()


def run_checked_probe(
    name: str,
    run: Callable[[], torch.Tensor],
    expected: np.ndarray,
    *,
    tokens: int,
    tol: float,
) -> ProbeReport:
    """Execute, verify against ``expected``, then time 3 further runs."""
    out = run()
    synchronize(out.device)
    max_err = float(np.max(np.abs(out.float().cpu().numpy() - expected)))
    if not np.isfinite(max_err) or max_err > tol:
        return ProbeReport(
            ok=False,
            max_abs_err=max_err,
            error=f"numerics mismatch: max_abs_err={max_err:.4f} > {tol}",
        )
    samples = []
    for _ in range(3):
        start = time.perf_counter()
        synchronize(run().device)
        samples.append(time.perf_counter() - start)
    elapsed = float(np.median(samples))
    report = ProbeReport(
        ok=True,
        max_abs_err=max_err,
        elapsed_s=elapsed,
        tokens_per_s=tokens / elapsed if elapsed > 0 else 0.0,
    )
    log.info(
        "%s probe: ok, %.0f tok/s, max_abs_err %.2e",
        name, report.tokens_per_s, max_err,
    )
    return report
