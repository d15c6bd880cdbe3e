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

import ctypes
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..utils import tracing
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

    A CUDA tensor goes through one of the kernels of ``csrc/matmul.cu``
    (bf16, contiguous, any shape: :func:`matmul_path` says which) on the
    current stream. Each launch that runs adds one to ``matmul.launches``
    and to its kernel's entry of ``matmul.path_launches``; a launch
    captured into a CUDA graph adds to ``matmul.captured`` instead, and
    each replay of the graph adds what its capture counted
    (:func:`_replay_chain`). A CPU tensor takes :func:`matmul_reference`.
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
    path = ctypes.c_int(-1)
    with torch.cuda.device(a.device):
        rc = lib.k1_matmul_bf16_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            _build.stream_handle(a), ctypes.byref(path),
        )
    _build.check(lib, rc, "matmul kernel launch")
    if torch.cuda.is_current_stream_capturing():
        matmul.captured[MATMUL_PATHS[path.value]] += 1
    else:
        _count_launches(Counter({MATMUL_PATHS[path.value]: 1}))
    return out


#: The kernels of ``csrc/matmul.cu``, by the number its ``k1_matmul_path``
#: returns: the masked WMMA kernel for operands TMA cannot describe
#: (K or N not a multiple of 8, a base not 16-byte aligned), and the
#: ``wgmma`` kernel with 128x64 or 128x256 output tiles.
MATMUL_PATHS = ("wmma_masked", "wgmma_128x64", "wgmma_128x256")

matmul.launches = 0
matmul.path_launches = Counter()
matmul.captured = Counter()


def _count_launches(by_path: Counter) -> None:
    """Count kernel launches that ran on the card, by kernel."""
    matmul.launches += sum(by_path.values())
    matmul.path_launches.update(by_path)


def matmul_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel :func:`matmul` takes for these CUDA operands."""
    m, k = a.shape
    lib = _build.load("matmul")
    with torch.cuda.device(a.device):
        code = lib.k1_matmul_path(a.data_ptr(), b.data_ptr(), m, b.shape[1], k)
    _build.check(lib, max(0, -code), "matmul path")
    return MATMUL_PATHS[code]


@dataclass
class MxuReport:
    ok: bool
    tflops: float = 0.0
    max_abs_err: float = 0.0
    error: str = ""


#: FLOPs per timed chain when auto-chaining on the card. A chain is one
#: CUDA graph replay timed with CUDA events, so it need only be long enough
#: that the replay's launch and the event pair are small beside it: 2.5e12
#: FLOP is 1164 links at 1024, about 10 ms on an H100 (PERF.md).
_CHAIN_FLOP_BUDGET = 2.5e12

#: Auto-chain upper bound, so that small probe sizes stay bounded in wall
#: clock instead of chasing the FLOP budget with many thousand launches.
_CHAIN_MAX = 4096


@dataclass
class _ChainGraph:
    """A timed chain captured into a CUDA graph, with the kernel launches
    the wrapper counted while capturing it (the launches one replay runs)."""

    graph: torch.cuda.CUDAGraph
    launches: Counter


@dataclass
class _ProbeEntry:
    """The probe's inputs for one (size, dtype, device): ``inputs`` is
    (a_lp, b_lp, b_scaled, reference). ``chains`` holds the chains
    captured over these very tensors, by (length, ``use_pallas``), so the
    graphs live as long as the memory they read."""

    inputs: tuple
    chains: dict[tuple[int, bool], _ChainGraph] = field(default_factory=dict)


#: (size, dtype, device) -> _ProbeEntry. The probe's inputs are fixed
#: (seeded), so the host reference product — the expensive part of a
#: repeat run — never changes, and the gate re-probes on every validation.
_PROBE_CACHE: dict[tuple, _ProbeEntry] = {}


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


def _replay_chain(chain_graph: _ChainGraph) -> None:
    """One replay of a captured chain: the launches its capture counted
    run, and are counted."""
    chain_graph.graph.replay()
    _count_launches(chain_graph.launches)


def _chain_graph(
    entry: _ProbeEntry, chain: int, use_pallas: bool
) -> tuple[_ChainGraph, bool]:
    """The ``chain`` links of :func:`_chained_matmul`, through the kernel or
    the plain product, as one CUDA graph, so that each timed run is one
    launch from the host and the host's dispatch stays out of the rate, as
    the JAX package's single compiled ``fori_loop`` keeps it out. Captured
    at the first call for an entry, a chain length and a product, after
    one run of the chain outside the capture (the warm-up: it loads the
    kernel and does the library's one-time set-up), and kept in
    ``entry``; the second value says whether this call captured."""
    key = (chain, use_pallas)
    cached = entry.chains.get(key)
    if cached is not None:
        return cached, False
    a, _, b, _ = entry.inputs
    _chained_matmul(a, b, chain, use_pallas)
    torch.cuda.synchronize(a.device)
    graph = torch.cuda.CUDAGraph()
    before = Counter(matmul.captured)
    with torch.cuda.graph(graph):
        _chained_matmul(a, b, chain, use_pallas)
    cached = _ChainGraph(graph, matmul.captured - before)
    entry.chains[key] = cached
    return cached, True


def _chain_runner(
    entry: _ProbeEntry, chain: int, use_pallas: bool, on_accel: bool
) -> Callable[[], object]:
    """What one timed run executes, warmed up once. On the card: a replay
    of the captured chain (the capture's own warm-up run, or one replay,
    is the warm-up). On the CPU: the plain loop."""
    if on_accel:
        chain_graph, captured = _chain_graph(entry, chain, use_pallas)

        def replay() -> None:
            _replay_chain(chain_graph)

        if not captured:
            replay()
        return replay

    a, _, b, _ = entry.inputs

    def loop() -> torch.Tensor:
        return _chained_matmul(a, b, chain, use_pallas)

    loop()
    return loop


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
    becomes a failed report; asking for ``cuda`` without a card raises. The
    checked product, its copy to the host and the compare are a
    ``mxu.check`` span (category ``probe``).
    """
    dev = resolve_device(device)
    try:
        return _mxu_probe_on_default_device(size, dtype, use_pallas, iters, chain, dev)
    except Exception as e:  # noqa: BLE001 - a dead tensor core is a failed probe
        return MxuReport(ok=False, error=str(e))


def _probe_entry(size: int, dtype: torch.dtype, device: torch.device) -> _ProbeEntry:
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
        cached = _ProbeEntry((a_lp, b_lp, b_scaled, reference))
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
    entry = _probe_entry(size, dtype, device)
    a_lp, b_lp, _, reference = entry.inputs
    product = matmul if use_pallas else matmul_reference

    # The numerics check runs on every probe — it is the probe.
    with tracing.span("mxu.check", "probe"):
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

    run = _chain_runner(entry, chain, use_pallas, on_accel)

    def timed() -> float:
        """Seconds one chain takes on the device."""
        if on_accel:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        start_s = time.perf_counter()
        float(run())
        return time.perf_counter() - start_s

    elapsed = float(np.median([timed() for _ in range(iters)]))
    flops = 2.0 * size**3 * chain
    report = MxuReport(ok=True, tflops=flops / elapsed / 1e12, max_abs_err=max_err)
    log.info(
        "MXU probe: %.2f TFLOP/s over %d-link chains (max_abs_err %.2e)",
        report.tflops, chain, max_err,
    )
    return report
