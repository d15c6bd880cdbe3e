#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit;
2. build both CUDA kernels from ``k8s_operator_libs_tpu_torch/ops/csrc``
   (one ``nvcc`` a source, all at once) and show ``-Xptxas -v``;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes, with the tolerance stated, and timed beside
   the plain version, one PyTorch library call (a yardstick the port never
   calls) and the least time the card could take;
4. gate phase (the main path): ``IciHealthGate.tpu_defaults().run()`` on
   the card with every launch count set to 0 just before; the report must
   be ok and both kernels must have been launched;
5. the burn-in at ``BurninConfig()`` width: three train steps, the loss
   finite and falling;
6. the CLI payload in a subprocess: its report must parse and be ok.

The last lines are the kernel table as one JSON object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Without a card,
or run from a directory that holds only this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks (dense), at a 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: K1 vs its plain version: bf16 products are exact in f32, so the two
#: differ only in the order of the f32 sums.
K1_ATOL_PER_SQRT_K = 1e-3
#: K2 vs its plain version, elementwise |kernel - plain| <= atol + rtol*|plain|:
#: the kernel rounds P to bf16 before P.V (the plain version keeps f32), and
#: both round the output to bf16, which may differ by one bf16 step (2^-7
#: relative) between two nearly equal values.
K2_ATOL = 2e-2
K2_RTOL = 2.0**-7

MATMUL_SIZES = (1024, 2048, 4096)
FLASH_SHAPE = (1, 4, 1024, 128)
CLI_TIMEOUT_S = 600


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms of one ``fn()`` on the card: CUDA events around ``reps``
    calls after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least ms the card could take, and what sets it."""
    compute_ms = flops / PEAK_BF16_FLOPS * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    if memory_ms >= compute_ms:
        return memory_ms, "bytes"
    return compute_ms, "operations"


def kernel_phase() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from k8s_operator_libs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from k8s_operator_libs_tpu_torch.ops.matmul import matmul, matmul_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n in MATMUL_SIZES:
        a = torch.randn((n, n), generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((n, n), generator=gen, device="cuda").to(torch.bfloat16)
        got = matmul(a, b)
        want = matmul_reference(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = K1_ATOL_PER_SQRT_K * math.sqrt(n)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"matmul {n}^3: max_abs_err {err} > {tol}")
        flops = 2.0 * n**3
        bound_ms, bound_by = bound(flops, 2 * (2 * n * n) + 4 * n * n)
        reps = max(10, int(2e12 / flops))
        rows.append({
            "name": "matmul",
            "route": "cuda",
            "source": "k8s_operator_libs_tpu_torch/ops/csrc/matmul.cu",
            "replaces": "k8s_operator_libs_tpu/ops/matmul.py:32",
            "shape": [n, n, n],
            "max_abs_err": err,
            "tol": tol,
            "ms": time_ms(lambda: matmul(a, b), reps),
            "plain_ms": time_ms(lambda: matmul_reference(a, b), reps),
            "library_ms": time_ms(lambda: torch.matmul(a, b), reps),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    b_, h, s, d = FLASH_SHAPE
    q, k, v = (
        torch.randn(FLASH_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    )
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal).float()
        want = flash_attention_reference(q, k, v, causal=causal).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        excess = float((diff - (K2_ATOL + K2_RTOL * want.abs())).max())
        if not math.isfinite(err) or excess > 0:
            raise AssertionError(
                f"flash attention causal={causal}: max_abs_err {err} beyond "
                f"{K2_ATOL} + {K2_RTOL}*|plain|"
            )
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4.0 * d * pairs * b_ * h
        bound_ms, bound_by = bound(flops, 4 * b_ * h * s * d * 2)
        rows.append({
            "name": "flash_attention_causal" if causal else "flash_attention",
            "route": "cuda",
            "source": "k8s_operator_libs_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "k8s_operator_libs_tpu/ops/flash_attention.py:44",
            "shape": list(FLASH_SHAPE),
            "max_abs_err": err,
            "tol": f"{K2_ATOL} + {K2_RTOL}*|plain|",
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal), 200),
            "plain_ms": time_ms(
                lambda: flash_attention_reference(q, k, v, causal=causal), 50
            ),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                200,
            ),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    for row in rows:
        row["kernel_ms"] = row["ms"]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return rows


def gate_phase(kernel_ms_at_gate_size: float) -> dict:
    import torch

    from k8s_operator_libs_tpu_torch.ops import matmul as matmul_mod
    from k8s_operator_libs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_probe,
    )
    from k8s_operator_libs_tpu_torch.ops.matmul import matmul, mxu_probe
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate

    gate = IciHealthGate.tpu_defaults(device="cuda")
    matmul.launches = 0
    flash_attention.launches = 0
    report = gate.run()
    launches = {"matmul": matmul.launches, "flash_attention": flash_attention.launches}
    print(json.dumps({"gate_report": dataclasses.asdict(report)}), flush=True)
    if not report.ok:
        raise AssertionError(f"gate failed: {report.failures}")
    if not (report.mxu and report.mxu.tflops > 0):
        raise AssertionError("gate: no matmul throughput")
    if not (report.flash and report.flash.tokens_per_s > 0):
        raise AssertionError("gate: no flash-attention throughput")
    if not report.burnin_ok:
        raise AssertionError("gate: burn-in did not pass")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"gate: the {name} kernel was never launched")
    n = gate.matmul_size
    chain = matmul_mod._auto_chain(n, True)

    # Where a warm gate run's wall time goes: each probe again, alone.
    device = torch.device("cuda")
    breakdown = {}
    for name, probe in (
        ("mxu_probe", lambda: mxu_probe(size=n, use_pallas=True, device=device)),
        ("burnin", lambda: gate._burnin(device)),
        ("flash_attention_probe", lambda: flash_attention_probe(device=device)),
    ):
        start = time.perf_counter()
        probe()
        torch.cuda.synchronize()
        breakdown[name] = time.perf_counter() - start

    # Is the timed chain bound by the host's launches? Compare the time to
    # enqueue one chain with the time until it has run.
    a_lp, _, b_scaled, _ = matmul_mod._probe_inputs(n, torch.bfloat16, device)
    torch.cuda.synchronize()
    start = time.perf_counter()
    matmul_mod._chained_matmul(a_lp, b_scaled, chain, True)
    enqueued = time.perf_counter() - start
    torch.cuda.synchronize()
    finished = time.perf_counter() - start
    info = {
        "chain_host_enqueue_us_per_link": enqueued / chain * 1e6,
        "chain_wall_us_per_link": finished / chain * 1e6,
        "kernel_us": kernel_ms_at_gate_size * 1e3,
        "launches": launches,
        "matmul_chain_links": chain,
        "matmul_expected_launches": 1 + 4 * chain,
        "chain_tflops": report.mxu.tflops,
        "kernel_tflops": 2.0 * n**3 / (kernel_ms_at_gate_size * 1e-3) / 1e12,
        "flash_tokens_per_s": report.flash.tokens_per_s,
        "elapsed_s": report.elapsed_s,
        "warm_probe_seconds": breakdown,
    }
    print(json.dumps({"gate": info}), flush=True)
    return launches


def burnin_phase() -> list[float]:
    import torch

    from k8s_operator_libs_tpu_torch.models.burnin import (
        BurninConfig,
        init_params,
        synthetic_batch,
        train_step,
    )

    cfg = BurninConfig()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, "cuda")
    losses = []
    start = time.perf_counter()
    for _ in range(3):
        params, loss = train_step(params, batch, cfg)
        losses.append(float(loss))
    elapsed = time.perf_counter() - start
    print(json.dumps({"burnin": {"losses": losses, "seconds": elapsed}}), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"burn-in loss not finite and falling: {losses}")
    return losses


def cli_phase() -> None:
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.health",
         "--pallas-matmul", "--flash-attention", "--matmul-size", "1024"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(
            f"CLI printed no report (rc {proc.returncode}): {proc.stderr[-2000:]}"
        )
    report = HealthReport.from_dict(json.loads(lines[-1]))
    print(json.dumps({"cli": {"rc": proc.returncode, "summary": report.summary()}}),
          flush=True)
    if proc.returncode != 0 or not report.ok:
        raise AssertionError(f"CLI gate failed: {report.failures}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from k8s_operator_libs_tpu_torch.ops import _build

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    start = time.perf_counter()
    seconds = _build.build()
    print(f"build: {time.perf_counter() - start:.1f} s wall, per source "
          f"{json.dumps(seconds)}", flush=True)
    for lib in _build.SIGNATURES:
        for line in _build.ptxas_report(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)

    rows = kernel_phase()
    launches = gate_phase(
        next(r["ms"] for r in rows if r["name"] == "matmul" and r["shape"][0] == 1024)
    )
    burnin_phase()
    cli_phase()

    for row in rows:
        row["launches"] = launches[
            "matmul" if row["name"] == "matmul" else "flash_attention"
        ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
