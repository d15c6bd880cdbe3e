"""MXU probe on the card: a hand-written CUDA matmul and a throughput
measurement.

The compute half of the post-upgrade health gate: after the driver is
swapped, the tensor cores must still deliver — a mis-installed driver
typically shows up as wrong numerics or a collapse in sustained TFLOP/s.
:func:`matmul` wraps the CUDA kernel of ``csrc/matmul.cu`` (bf16 inputs,
f32 accumulation and output); :func:`matmul_reference` is its plain
PyTorch version, which a tensor on the CPU takes. The names keep the JAX
package's, where the probe drives the TPU's matrix unit (MXU).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device, synchronize
from ..utils.log import get_logger
from . import _build

log = get_logger("ops.matmul")


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`matmul`: the product in f32.

    bf16 products are exact in f32, so this differs from the kernel only in
    the order of the f32 sums. On the card it needs
    ``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default).
    """
    return torch.matmul(a.float(), b.float())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with f32 output.

    A CUDA tensor goes through the kernel (bf16, contiguous, any shape: the
    kernel masks ragged edges) on the current stream; each launch adds one
    to ``matmul.launches``. A CPU tensor takes :func:`matmul_reference`.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul needs (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError("matmul operands must share device and dtype")
    if a.device.type != "cuda":
        return matmul_reference(a, b)
    if a.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA matmul kernel takes bf16, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA matmul kernel takes contiguous operands")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _build.load("matmul")
    with torch.cuda.device(a.device):
        rc = lib.k1_matmul_bf16_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            _build.stream_handle(a),
        )
    _build.check(lib, rc, "matmul kernel launch")
    matmul.launches += 1
    return out


matmul.launches = 0


@dataclass
class MxuReport:
    ok: bool
    tflops: float = 0.0
    max_abs_err: float = 0.0
    error: str = ""


#: FLOPs per timed chain when auto-chaining on the card. A chain is timed
#: with CUDA events, so it need only be long enough that the launch of its
#: first link and the event pair are small beside it: 2.5e12 FLOP is 1164
#: links at 1024, some 40 ms on an H100 (PERF.md).
_CHAIN_FLOP_BUDGET = 2.5e12

#: Auto-chain upper bound, so that small probe sizes stay bounded in wall
#: clock instead of chasing the FLOP budget with many thousand launches.
_CHAIN_MAX = 4096

#: (size, dtype, device) -> (a_lp, b_lp, b_scaled, reference). The probe's
#: inputs are fixed (seeded), so the host reference product — the expensive
#: part of a repeat run — never changes, and the gate re-probes on every
#: validation.
_PROBE_CACHE: dict[tuple, tuple] = {}


def _chained_matmul(
    a: torch.Tensor, b: torch.Tensor, chain: int, use_pallas: bool
) -> torch.Tensor:
    """``chain`` dependent matmuls, reduced to one element.

    Each link casts the previous f32 result to the input dtype and
    multiplies it by ``b`` (pre-scaled by 1/sqrt(K), so magnitudes stay
    O(1)), so no link can be skipped or overlapped with the next.
    ``use_pallas`` keeps the JAX package's name: True takes the CUDA
    kernel, False the plain product.
    """
    product = matmul if use_pallas else matmul_reference
    acc = a.float()
    for _ in range(chain):
        acc = product(acc.to(a.dtype), b)
    return acc[0, 0]


def _auto_chain(size: int, on_accel: bool) -> int:
    """Links per timed chain: FLOP-budgeted on the card (capped, see
    _CHAIN_MAX), one matmul elsewhere."""
    if not on_accel:
        return 1
    return max(16, min(_CHAIN_MAX, round(_CHAIN_FLOP_BUDGET / (2.0 * size**3))))


def mxu_probe(
    size: int = 2048,
    dtype: torch.dtype = torch.bfloat16,
    use_pallas: bool = True,
    iters: int = 3,
    chain: int = 0,
    device: DeviceLike = None,
) -> MxuReport:
    """Numerics-checked matmul throughput on one device (default ``cuda``).

    ``use_pallas=True`` runs every product through the CUDA kernel (at any
    size: the kernel masks ragged edges); ``False`` runs the plain product.
    ``chain`` sets how many dependent matmuls each timed run holds (0 =
    auto: FLOP-budgeted on the card, 1 on the CPU). A crash inside the probe
    becomes a failed report; asking for ``cuda`` without a card raises.
    """
    dev = resolve_device(device)
    try:
        return _mxu_probe_on_default_device(size, dtype, use_pallas, iters, chain, dev)
    except Exception as e:  # noqa: BLE001 - a dead tensor core is a failed probe
        return MxuReport(ok=False, error=str(e))


def _probe_inputs(size: int, dtype: torch.dtype, device: torch.device) -> tuple:
    cache_key = (size, str(dtype), str(device))
    cached = _PROBE_CACHE.get(cache_key)
    if cached is None:
        rng = np.random.default_rng(0)
        a = rng.standard_normal((size, size), dtype=np.float32)
        b = rng.standard_normal((size, size), dtype=np.float32)
        a_lp = torch.from_numpy(a).to(dtype).to(device)
        b_lp = torch.from_numpy(b).to(dtype).to(device)
        # Independent reference: host numpy on the SAME quantized inputs.
        # A reference computed on the device under test would agree with
        # its own wrong answer.
        reference = (
            a_lp.float().cpu().numpy() @ b_lp.float().cpu().numpy()
        )
        b_scaled = torch.from_numpy(b / np.sqrt(size)).to(dtype).to(device)
        cached = (a_lp, b_lp, b_scaled, reference)
        _PROBE_CACHE[cache_key] = cached
    return cached


def _mxu_probe_on_default_device(
    size: int,
    dtype: torch.dtype,
    use_pallas: bool,
    iters: int,
    chain: int,
    device: torch.device,
) -> MxuReport:
    on_accel = device.type == "cuda"
    if chain <= 0:
        chain = _auto_chain(size, on_accel)
    a_lp, b_lp, b_scaled, reference = _probe_inputs(size, dtype, device)
    product = matmul if use_pallas else matmul_reference

    # The numerics check runs on every probe — it is the probe.
    out = product(a_lp, b_lp)
    synchronize(device)
    max_err = float(np.max(np.abs(out.cpu().numpy() - reference)))
    # bf16 products are exact in f32, so device and host differ only in
    # f32 summation order; the tolerance covers that ordering noise.
    tol = 1e-2 * size**0.5
    if not np.isfinite(max_err) or max_err > tol:
        return MxuReport(
            ok=False, max_abs_err=max_err,
            error=f"numerics mismatch: max_abs_err={max_err:.4f} > {tol:.4f}",
        )

    def timed() -> float:
        """Seconds one chain takes on the device."""
        if on_accel:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _chained_matmul(a_lp, b_scaled, chain, use_pallas)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        start_s = time.perf_counter()
        float(_chained_matmul(a_lp, b_scaled, chain, use_pallas))
        return time.perf_counter() - start_s

    timed()  # warm-up outside the timed samples
    elapsed = float(np.median([timed() for _ in range(iters)]))
    flops = 2.0 * size**3 * chain
    report = MxuReport(ok=True, tflops=flops / elapsed / 1e12, max_abs_err=max_err)
    log.info(
        "MXU probe: %.2f TFLOP/s over %d-link chains (max_abs_err %.2e)",
        report.tflops, chain, max_err,
    )
    return report
