#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit;
2. build both CUDA kernels from ``k8s_operator_libs_tpu_torch/ops/csrc``
   (one ``nvcc`` a source, all at once) and show ``-Xptxas -v``;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes and at the burn-in's head_dims, with the
   tolerance stated, and timed beside the plain version, one PyTorch
   library call (a yardstick the port never calls) and the least time the
   card could take. Each matmul row (``shape`` is M, K, N) asserts and
   names the kernel it took: ``wgmma`` at the gate's and larger sizes, the
   masked WMMA kernel at a shape TMA cannot describe. ``ms`` and
   ``library_ms`` time a CUDA graph of back-to-back calls (the card's
   time); ``call_ms`` and ``plain_ms`` time calls made one by one from
   Python (the host's cost per call included);
4. gate phase (the main path): ``IciHealthGate.tpu_defaults().run()`` on
   the card with every launch count set to 0 just before; the report must
   be ok, both kernels must have been launched, the chain's CUDA graph
   must hold ``chain`` matmul launches by the wrapper's own count, and the
   matmul kernel must have run exactly ``1 + 4 * chain`` times (one
   numerics call, then the chain run once outside its graph and replayed
   three times). The gate forms a world of one NCCL rank process per card
   for its collective battery and its sharded burn-in; neither launches a
   kernel of the port, so the counts are the parent's;
5. collectives phase, on an NCCL world of ``torch.cuda.device_count()``
   ranks: the collective battery (``run_ici_probes``, all four ops ok, each
   op's ``elapsed_s`` and the time of its call from here), the quick
   battery twice, first and warm (checks ok, ``mxu_tflops`` and
   ``probe_latency_s`` in its metrics), and the gate at ``tpu_defaults()``
   twice (first and warm ``elapsed_s``: what forming the world costs, with
   the world's own split of it into spawn and import, device context,
   process-group join and first all-reduce), its
   collectives ok. With two or more cards the per-link tier, the sharded
   burn-in and the ring and Ulysses probes must be ok too; with one card a
   line says they were not run;
6. the burn-in at ``BurninConfig()`` width: three train steps, the loss
   finite and falling;
7. the burn-in's forward at ``BurninConfig()`` width with the flash core
   (head_dim 32), counts set to 0 just before: the kernel runs once a
   layer and the logits match the plain core's;
8. the CLI payload in a subprocess: its report must parse and be ok.

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

#: Burn-in logits with the flash core vs the plain core: the two cores
#: round their bf16 outputs at different places, and one bf16 step of
#: difference there reaches the logits through the bf16 residual stream.
BURNIN_ATOL = 5e-2
BURNIN_RTOL = 2e-2

#: ((M, K, N), the kernel family it must take): the gate's size and two
#: larger ones through ``wgmma``, and a shape TMA cannot describe (K and N
#: not multiples of 8) through the masked WMMA kernel.
MATMUL_CASES = (
    ((1024, 1024, 1024), "wgmma"),
    ((2048, 2048, 2048), "wgmma"),
    ((4096, 4096, 4096), "wgmma"),
    ((129, 77, 257), "wmma_masked"),
)
#: (shape, causal): the probe's shape both ways, ``BurninConfig()`` with the
#: flash core, a common head_dim, and a size where the bound, not launch
#: latency, sets the goal.
FLASH_CASES = (
    ((1, 4, 1024, 128), True),
    ((1, 4, 1024, 128), False),
    ((8, 4, 128, 32), True),
    ((1, 4, 1024, 64), True),
    ((2, 16, 4096, 128), True),
)
CLI_TIMEOUT_S = 600


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int, graph: bool = True) -> float:
    """Mean ms of one ``fn()`` on the card, from CUDA events after a
    warm-up. With ``graph``, the ``reps`` calls are captured into one CUDA
    graph and its replay is timed: the card's time for back-to-back calls,
    the host's cost per call left out. Without, the calls are made from
    Python one by one, host included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = None
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(reps):
                fn()
        captured.replay()
        torch.cuda.synchronize()
        run = captured.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if run is not None:
        run()
    else:
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
        split_plan,
    )
    from k8s_operator_libs_tpu_torch.ops.matmul import (
        matmul,
        matmul_path,
        matmul_reference,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (m, k, n), family in MATMUL_CASES:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
        path = matmul_path(a, b)
        if not path.startswith(family):
            raise AssertionError(f"matmul {(m, k, n)} took {path}, not {family}")
        got = matmul(a, b)
        want = matmul_reference(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = K1_ATOL_PER_SQRT_K * math.sqrt(k)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"matmul {(m, k, n)}: max_abs_err {err} > {tol}")
        flops = 2.0 * m * k * n
        bound_ms, bound_by = bound(flops, 2 * (m * k + k * n) + 4 * m * n)
        reps = max(10, min(1000, int(2e12 / flops)))
        rows.append({
            "name": "matmul",
            "route": "cuda",
            "source": "k8s_operator_libs_tpu_torch/ops/csrc/matmul.cu",
            "replaces": "k8s_operator_libs_tpu/ops/matmul.py:32",
            "shape": [m, k, n],
            "path": path,
            "max_abs_err": err,
            "tol": tol,
            "ms": time_ms(lambda: matmul(a, b), reps),
            "call_ms": time_ms(lambda: matmul(a, b), reps, graph=False),
            "plain_ms": time_ms(lambda: matmul_reference(a, b), reps, graph=False),
            "library_ms": time_ms(lambda: torch.matmul(a, b), reps),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    for shape, causal in FLASH_CASES:
        b_, h, s, d = shape
        q, k, v = (
            torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)
        )
        got = flash_attention(q, k, v, causal=causal).float()
        want = flash_attention_reference(q, k, v, causal=causal).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        excess = float((diff - (K2_ATOL + K2_RTOL * want.abs())).max())
        if not math.isfinite(err) or excess > 0:
            raise AssertionError(
                f"flash attention {shape} causal={causal}: max_abs_err {err} "
                f"beyond {K2_ATOL} + {K2_RTOL}*|plain|"
            )
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4.0 * d * pairs * b_ * h
        bound_ms, bound_by = bound(flops, 4 * b_ * h * s * d * 2)
        split, blocks = split_plan(b_ * h, s, causal, sms)
        reps = max(20, min(200, int(2e11 / flops)))
        rows.append({
            "name": "flash_attention_causal" if causal else "flash_attention",
            "route": "cuda",
            "source": "k8s_operator_libs_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "k8s_operator_libs_tpu/ops/flash_attention.py:44",
            "shape": list(shape),
            "split": split,
            "blocks": blocks,
            "max_abs_err": err,
            "tol": f"{K2_ATOL} + {K2_RTOL}*|plain|",
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal), reps),
            "call_ms": time_ms(
                lambda: flash_attention(q, k, v, causal=causal), reps, graph=False
            ),
            "plain_ms": time_ms(
                lambda: flash_attention_reference(q, k, v, causal=causal),
                max(5, reps // 4),
                graph=False,
            ),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                reps,
            ),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
        del q, k, v, got, want, diff
    for row in rows:
        row["kernel_ms"] = row["ms"]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return rows


def counts() -> dict:
    """Every launch count of the port, by wrapper, and K1's by kernel."""
    from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention
    from k8s_operator_libs_tpu_torch.ops.matmul import matmul

    return {
        "matmul": matmul.launches,
        "flash_attention": flash_attention.launches,
        "matmul_by_path": dict(matmul.path_launches),
    }


def reset_counts() -> None:
    from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention
    from k8s_operator_libs_tpu_torch.ops.matmul import matmul

    matmul.launches = 0
    matmul.path_launches.clear()
    flash_attention.launches = 0


def gate_phase(kernel_ms_at_gate_size: float) -> dict:
    import torch

    from k8s_operator_libs_tpu_torch.ops import matmul as matmul_mod
    from k8s_operator_libs_tpu_torch.ops.collectives import run_ici_probes
    from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention_probe
    from k8s_operator_libs_tpu_torch.ops.matmul import mxu_probe
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate

    gate = IciHealthGate.tpu_defaults(device="cuda")
    reset_counts()
    report = gate.run()
    launches = counts()
    print(json.dumps({"gate_report": dataclasses.asdict(report)}), flush=True)
    if not report.ok:
        raise AssertionError(f"gate failed: {report.failures}")
    if not (report.mxu and report.mxu.tflops > 0):
        raise AssertionError("gate: no matmul throughput")
    if not (report.flash and report.flash.tokens_per_s > 0):
        raise AssertionError("gate: no flash-attention throughput")
    if not report.burnin_ok:
        raise AssertionError("gate: burn-in did not pass")
    for name in ("matmul", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"gate: the {name} kernel was never launched")
    n = gate.matmul_size
    chain = matmul_mod._auto_chain(n, True)

    # Where a warm gate run's wall time goes: each probe again, alone, on
    # the gate's own device (the matmul probe's inputs are cached by it).
    device = gate.world_devices()[0]
    world = gate._world
    breakdown = {}
    for name, probe in (
        ("collective_battery", lambda: run_ici_probes(world, payload_mb=gate.payload_mb)),
        ("mxu_probe", lambda: mxu_probe(size=n, use_pallas=True, device=device)),
        ("burnin", lambda: gate._burnin(world)),
        ("flash_attention_probe", lambda: flash_attention_probe(device=device)),
    ):
        start = time.perf_counter()
        probe()
        torch.cuda.synchronize()
        breakdown[name] = time.perf_counter() - start
    gate.close()

    # Is the timed chain bound by the host? Compare the time to enqueue one
    # replay of the captured chain with the time until it has run.
    entry = matmul_mod._probe_entry(n, torch.bfloat16, device)
    chain_graph, _ = matmul_mod._chain_graph(entry, chain, use_pallas=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    matmul_mod._replay_chain(chain_graph)
    enqueued = time.perf_counter() - start
    torch.cuda.synchronize()
    finished = time.perf_counter() - start
    info = {
        "chain_host_enqueue_us_per_link": enqueued / chain * 1e6,
        "chain_wall_us_per_link": finished / chain * 1e6,
        "kernel_us": kernel_ms_at_gate_size * 1e3,
        "launches": launches,
        "matmul_chain_links": chain,
        "matmul_launches_in_the_chain_graph": dict(chain_graph.launches),
        "matmul_expected_launches": 1 + 4 * chain,
        "chain_tflops": report.mxu.tflops,
        "kernel_tflops": 2.0 * n**3 / (kernel_ms_at_gate_size * 1e-3) / 1e12,
        "flash_tokens_per_s": report.flash.tokens_per_s,
        "elapsed_s": report.elapsed_s,
        "warm_probe_seconds": breakdown,
    }
    print(json.dumps({"gate": info}), flush=True)
    if sum(chain_graph.launches.values()) != chain:
        raise AssertionError(
            f"gate: the chain's graph holds {dict(chain_graph.launches)} launches, "
            f"not {chain}"
        )
    if launches["matmul"] != info["matmul_expected_launches"]:
        raise AssertionError(
            f"gate: matmul kernel launched {launches['matmul']} times, "
            f"expected {info['matmul_expected_launches']}"
        )
    return launches


def collectives_phase(card: str) -> dict:
    """The collective battery, the quick battery and the gate's collectives
    on an NCCL world of every card. Every line printed carries the card's
    name and power limit."""
    import torch

    from k8s_operator_libs_tpu_torch.ops import collectives
    from k8s_operator_libs_tpu_torch.ops.probe_harness import quick_battery
    from k8s_operator_libs_tpu_torch.parallel.mesh import World, available_devices
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate

    def show(key: str, value) -> None:
        print(json.dumps({key: value, "card": card}), flush=True)

    n = torch.cuda.device_count()
    version = torch.cuda.nccl.version()
    show("nccl", {
        "version": ".".join(map(str, version)) if isinstance(version, tuple) else version,
        "world_size": n,
    })
    world = World(available_devices())
    if world.backend != "nccl":
        raise AssertionError(f"a world of cards joined through {world.backend}")
    try:
        start = time.perf_counter()
        world.start()
        form_s = time.perf_counter() - start
        reports, ops = [], []
        for check in (
            collectives.psum_check,
            collectives.all_gather_check,
            collectives.reduce_scatter_check,
            collectives.ppermute_ring,
            collectives.psum_bandwidth,
        ):
            start = time.perf_counter()
            reports.append(check(world, "x"))
            ops.append({
                **dataclasses.asdict(reports[-1]),
                "call_s": time.perf_counter() - start,
            })
        show("collective_ops", {
            "world_form_s": form_s, "world_form_phases_s": world.form_times, "ops": ops,
        })
        battery = collectives.run_ici_probes(world)
        if [r.op for r in battery] != ["psum", "all_gather", "reduce_scatter", "ppermute_ring"]:
            raise AssertionError(f"battery ops: {[r.op for r in battery]}")
        failed = [f"{r.op}: {r.error}" for r in reports + battery if not r.ok]
        if failed:
            raise AssertionError(f"collective battery failed: {failed}")
        # First and warm: the first builds the 256^2 matmul probe's inputs
        # and host reference, as the first run of a periodic loop does.
        for run in ("first", "warm"):
            quick = quick_battery(world)
            show("quick_battery", {"run": run, **dataclasses.asdict(quick)})
            if not quick.ok or not {"mxu_tflops", "probe_latency_s"} <= set(quick.metrics):
                raise AssertionError(f"quick battery: {quick}")
    finally:
        world.close()

    gate = IciHealthGate.tpu_defaults()
    try:
        first, warm = gate.run(), gate.run()
        form_phases = gate._world.form_times
    finally:
        gate.close()
    info = {
        "first_elapsed_s": first.elapsed_s,
        "warm_elapsed_s": warm.elapsed_s,
        "world_form_phases_s": form_phases,
        "collectives": [dataclasses.asdict(c) for c in warm.collectives],
        "links": [dataclasses.asdict(h) for h in warm.links],
        "burnin_ok": warm.burnin_ok,
        "ring_attention": warm.ring_attention and dataclasses.asdict(warm.ring_attention),
        "ulysses": warm.ulysses and dataclasses.asdict(warm.ulysses),
    }
    show("gate_collectives", info)
    for report in (first, warm):
        if not report.ok:
            raise AssertionError(f"gate failed: {report.failures}")
        if not report.collectives or not all(c.ok for c in report.collectives):
            raise AssertionError(f"gate collectives: {report.collectives}")
    if n < 2:
        show("not_run", "the per-link tier, the ring floor, the dp x tp sharding of "
             "the burn-in (dp 1 x tp 1 here) and the ring and Ulysses probes need "
             "two or more cards; this machine has one")
    else:
        if len(warm.links) != n or not all(h.ok for h in warm.links):
            raise AssertionError(f"per-link tier: {warm.links}")
        if not (warm.ring_attention and warm.ring_attention.ok
                and warm.ulysses and warm.ulysses.ok and warm.burnin_ok):
            raise AssertionError("sharded burn-in or sequence-parallel probes failed")
    return info


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


def burnin_flash_phase() -> dict:
    import torch

    from k8s_operator_libs_tpu_torch.models.burnin import (
        BurninConfig,
        forward,
        init_params,
        synthetic_batch,
    )
    cfg = BurninConfig(use_flash_attention=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    tokens = synthetic_batch(torch.Generator().manual_seed(1), cfg, "cuda")["tokens"]
    reset_counts()
    got = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = counts()
    want = forward(params, tokens, BurninConfig())
    diff = (got - want).abs()
    excess = float((diff - (BURNIN_ATOL + BURNIN_RTOL * want.abs())).max())
    info = {
        "head_dim": cfg.head_dim,
        "logits_shape": list(got.shape),
        "max_abs_err": float(diff.max()),
        "tol": f"{BURNIN_ATOL} + {BURNIN_RTOL}*|plain|",
        "launches": launches,
    }
    print(json.dumps({"burnin_flash_forward": info}), flush=True)
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise AssertionError(f"burn-in flash forward disagrees with the plain core: {info}")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"burn-in flash forward: kernel launches {launches}")
    return launches


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
    collectives_phase(card)
    burnin_phase()
    burnin_launches = burnin_flash_phase()
    cli_phase()

    for row in rows:
        kernel = "matmul" if row["name"] == "matmul" else "flash_attention"
        row["launches"] = launches[kernel]
        row["launches_burnin_flash_forward"] = burnin_launches[kernel]
        if kernel == "matmul":
            row["path_launches"] = launches["matmul_by_path"].get(row["path"], 0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
