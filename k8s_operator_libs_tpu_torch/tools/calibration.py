"""The calibration line: one full-battery gate run on the cards, as one
JSON line, the record the gate's floors are set from.

    python -m k8s_operator_libs_tpu_torch.tools.calibration

No module of the JAX package has this name; the counterpart is the JAX
harness's ``bench.py`` ``run_calibration``. It does that function's work on
the port's gate: one :class:`IciHealthGate` run (4 MB collectives, a
2048³ matmul through the CUDA kernel K1, the flash probe through K2, the
burn-in, and the ring and Ulysses probes when there is more than one
card), then the library's bf16 product at the same size on the same
device, the yardstick for K1.

The keys are the JAX function's, with the meaning it gives them, and four
renamed because their JAX names name TPU things:

* ``links_exercised`` (JAX ``ici_links_exercised``): the links a ring over
  the world's devices crosses; 0 on one device, whose ring is a
  self-permute and no evidence about any link;
* ``torch_matmul_tflops`` (JAX ``xla_dot_tflops``): the library's bf16
  product's TFLOP/s at the gate's size;
* ``kernel_vs_torch_matmul`` (JAX ``pallas_vs_xla``): K1's TFLOP/s over
  the library's;
* ``matmul_kernel_launched`` (JAX ``pallas_matmul_compiled``): whether the
  gate's matmul probe launched K1, read from K1's launch count, not
  assumed from the platform.

The JAX function times XLA's own dot on the probe's bf16 operands; the
port's yardstick is the same, ``torch.matmul`` on bf16 operands (cuBLAS on
a card), timed as the gate's probe times K1. It is not
``mxu_probe(use_pallas=False)``: the port's plain product multiplies in
f32, which on a card runs off the tensor cores.

The rest keep their JAX names: ``platform`` (``gpu`` on the cards,
``cpu``), ``n_devices``, ``ok``, ``failures``, ``mxu_tflops``,
``ring_gbytes_per_s``, ``flash_attention_ok`` and ``elapsed_s``.

The default device is every visible card; without one it raises, and
nothing falls back to the CPU. ``device="cpu"`` runs the battery on one CPU
rank with the plain versions (the CPU tests hold it to the JAX function
there).
"""

from __future__ import annotations

import json
import time
from typing import Optional

import torch

from ..ops.matmul import _auto_chain, matmul
from ..parallel.mesh import available_devices
from ..tpu.health import IciHealthGate
from ..utils.device import DeviceLike

#: The gate's matmul and the plain product's size (the JAX function's).
CALIBRATION_MATMUL_SIZE = 2048


def library_matmul_tflops(size: int, device: torch.device, iters: int = 3) -> Optional[float]:
    """TFLOP/s of ``torch.matmul`` on bf16 ``size`` x ``size`` operands on
    ``device``, timed as the gate's probe times K1: a chain of dependent
    products (the probe's chain length), captured in one CUDA graph on a
    card, a plain loop on the CPU; the median of ``iters`` runs. ``None``
    when the chain's result is not finite."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(size, size, generator=gen).to(torch.bfloat16).to(device)
    # Scaled by 1/sqrt(K), so each link keeps its magnitude.
    b = (torch.randn(size, size, generator=gen) / size**0.5).to(torch.bfloat16).to(device)
    on_card = device.type == "cuda"
    chain = _auto_chain(size, on_card)

    def run() -> torch.Tensor:
        acc = a
        for _ in range(chain):
            acc = torch.matmul(acc, b)
        return acc

    if not bool(torch.isfinite(run()).all()):
        return None
    if on_card:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()

        def timed() -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:

        def timed() -> float:
            start = time.perf_counter()
            run()
            return time.perf_counter() - start

    seconds = sorted(timed() for _ in range(iters))[iters // 2]
    return 2.0 * size**3 * chain / seconds / 1e12


def run_calibration(device: DeviceLike = "cuda") -> dict:
    """One full-battery gate run on ``device``'s devices and the library's
    product beside it; the module docstring names the keys."""
    devices = available_devices(device)
    on_card = devices[0].type == "cuda"
    n_devices = len(devices)
    gate = IciHealthGate(
        payload_mb=4.0,
        matmul_size=CALIBRATION_MATMUL_SIZE,
        use_pallas_matmul=on_card,
        run_burnin=True,
        run_seq_parallel_probes=n_devices > 1,
        run_flash_attention=on_card,
        device=device,
    )
    launches_before = matmul.launches
    try:
        report = gate.run()
    finally:
        gate.close()
    kernel_launched = matmul.launches > launches_before
    ring = next((c for c in report.collectives if c.op == "ppermute_ring"), None)
    library = library_matmul_tflops(CALIBRATION_MATMUL_SIZE, devices[0])
    return {
        "platform": "gpu" if on_card else devices[0].type,
        "n_devices": n_devices,
        # A ring over n > 1 devices crosses n links; one device has none.
        "links_exercised": n_devices if n_devices > 1 else 0,
        "ok": report.ok,
        "failures": report.failures,
        "mxu_tflops": round(report.mxu.tflops, 3) if report.mxu else None,
        "torch_matmul_tflops": round(library, 3) if library else None,
        "kernel_vs_torch_matmul": round(report.mxu.tflops / library, 3)
        if report.mxu and library
        else None,
        "matmul_kernel_launched": kernel_launched,
        "ring_gbytes_per_s": round(ring.gbytes_per_s, 3) if ring else None,
        "flash_attention_ok": report.flash.ok if report.flash is not None else None,
        "elapsed_s": round(report.elapsed_s, 2),
    }


def main() -> int:
    print(json.dumps(run_calibration()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
