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
8. entry phase, the flagship model (``entry.ENTRY_CFG``: vocab 1024,
   d_model 256, 8 heads, d_ff 1024, 4 layers, seq 256, batch 4) on the
   card: ``entry()``'s forward, first and warm, its logits finite and its
   loss within ``CARD_VS_CPU_REL`` of the same parameters' f32 loss on the
   CPU; the same widths with four experts a layer, three train steps, the
   loss finite, falling and first within ``CARD_VS_CPU_REL`` of the CPU's;
   and that MoE forward with the flash core, counts set to 0 just before:
   the flash kernel runs once a layer (4 times), the matmul kernel never,
   and the logits match the plain core's;
9. dryrun phase, on an NCCL world of every card: ``dryrun_multichip``,
   the JAX dry run's programs for the world's size, two steps each (mesh,
   loss, each step's seconds), every loss finite; then the MoE flagship's
   sharded step over the world's layouts (one card: dp 1; four cards:
   {ep2, tp2}, {tp2, sp2} with ring and with Ulysses, {dp2, pp2}), its
   first loss within ``SHARDED_REL`` of the unsharded step's on the card
   and equal on every rank. With one card a line says which axes were
   not exercised;
10. the CLI payload in a subprocess: its report must parse and be ok;
11. device-class phase (the GPU node roll's probe pod): the node's GPU
    Feature Discovery labels built from the card's own facts must make the
    node detector see a GPU node of ``torch.cuda.device_count()`` cards;
    the validation pod built for it with the default spec must ask for
    that many ``nvidia.com/gpu`` (the node's own count); and its container
    command runs as a kubelet would (``python`` is this interpreter, the
    container's environment applies with the kernel-cache host path mapped
    to a temporary directory, the ready file lies in a temporary
    directory), twice on one cache: cold (``nvcc`` runs inside the pod)
    and warm. Each run must write its ready file within
    ``POD_READY_TIMEOUT_S``, print an ok report with the matmul and flash
    probes ok, launch each kernel as often as the gate phase did (the
    payload's own counts, from its stderr line) and still be alive
    (parked) after; then it is stopped. The line ``{"device_class": ...}``
    gives the seconds to Ready, the report's ``elapsed_s``,
    ``mxu_tflops``, flash ok and the build seconds of each;
12. monitor phase: ``TpuHealthMonitor.check_once()`` on a node labelled
    from the card, against a dict-backed client (``DictClient``: Node,
    Pod, Event, NodeHealthReport), its gate the port's
    ``SubprocessHealthGate`` at ``tpu_defaults()``, so each cycle is the
    card's payload with both kernels. A passing cycle must write
    ``TpuIciHealthy=True`` and, through ``ReportPublisher``, a
    NodeHealthReport whose ``mxu_tflops`` is the report's; its payload must
    launch each kernel as often as the gate phase (the child's own counts,
    from its stderr line). A cycle with ``--min-mxu-tflops 1e9`` and
    ``failure_threshold=1`` must write ``False`` and one Warning Event. A
    live pod holding ``nvidia.com/gpu`` on the node must skip the cycle
    without running the gate. One quick-tier cycle,
    ``run_quick_probe_loop(once=True)``, forms a world of every card and
    publishes a report. ``{"monitor": ...}`` gives each cycle's wall seconds
    (the child included) and the payload's launches;
13. gang phase: the payload as a slice gang pod, a child process with
    ``--coordinator 127.0.0.1:<free port> --num-processes 1 --process-id 0
    --publish-report`` (``NODE_NAME`` set, the kubeconfig pointing at
    ``ApiStub``, an HTTP front of the same kind of dict-backed client). Its
    ranks join through the TCP store; its report must say
    ``process_count`` 1, ``slice_devices_total`` = the cards, and
    ``slice=`` in its summary and ready file, be published as the node's
    NodeHealthReport, and launch each kernel as often as the gate phase.
    With two or more cards, two such children, each with its own half of
    the cards in ``CUDA_VISIBLE_DEVICES`` and ``--num-processes 2``: both
    ready files must read ``slice=N/N over 2 hosts`` and each report's
    hop to the other child must name the other member's node.
    ``{"gang": ...}`` gives each child's world formation split as
    ``World.form_times`` does, the TCP join included.

The last lines are the kernel table as one JSON object (each row with the
launches of the gate, the burn-in forward, the flagship MoE flash
forward, the probe pod, the monitor's payload and the gang's payload),
the card's name and power limit, and
``{"ok": true, "device": {...}}``. Without a card,
or run from a directory that holds only this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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

#: A loss on the card (bf16) against the same parameters' loss in f32 on
#: the CPU: bf16 rounds at other places (``tests/test_torch_cuda.py``).
CARD_VS_CPU_REL = 5e-3
#: A sharded step's first loss against the unsharded step's on the same
#: parameters: the JAX package's own tolerance for its sharded step in bf16.
SHARDED_REL = 2e-2

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
#: Seconds a probe pod's payload may take to write its ready file.
POD_READY_TIMEOUT_S = 600
#: The monitored node and the gang's nodes.
MONITOR_NODE = "gpu-node-0"
GANG_NODES = ("gang-node-0", "gang-node-1")


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


def entry_phase(card: str) -> dict:
    """The flagship model (``entry.ENTRY_CFG``) on the card: ``entry()``'s
    forward, three train steps of its widths with four experts a layer,
    and that MoE forward through the flash core, counts set to 0 just
    before. The kernel is held to its stated tolerance on each layer's
    operands; after 4 bf16 layers the logits differ from the plain core's
    by more than one kernel call's rounding, so the forward as a whole is
    held by its loss against the f32 loss on the CPU."""
    import torch

    from k8s_operator_libs_tpu_torch.ops import flash_attention as flash_mod
    from k8s_operator_libs_tpu_torch.entry import ENTRY_CFG, entry
    from k8s_operator_libs_tpu_torch.models.burnin import (
        _leaves,
        _rebuild,
        forward,
        init_params,
        loss_fn,
        synthetic_batch,
        train_step,
    )

    def cpu_f32_loss(params, batch, cfg) -> float:
        """The reference: the same parameters and tokens in f32 on the CPU."""
        host = _rebuild(params, [p.float().cpu() for p in _leaves(params)])
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        return float(loss_fn(host, {k: t.cpu() for k, t in batch.items()}, f32))

    fn, (params, tokens) = entry()
    forward_s = []
    for _ in range(2):
        start = time.perf_counter()
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        forward_s.append(time.perf_counter() - start)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=-1)}
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, ENTRY_CFG.vocab), batch["targets"].reshape(-1)
    )
    entry_loss, entry_ref = float(nll), cpu_f32_loss(params, batch, ENTRY_CFG)

    moe = dataclasses.replace(ENTRY_CFG, n_experts=4)
    params = init_params(torch.Generator().manual_seed(0), moe, "cuda")
    batch = synthetic_batch(torch.Generator().manual_seed(1), moe, "cuda")
    moe_ref = cpu_f32_loss(params, batch, moe)
    losses, step_s, p = [], [], params
    for _ in range(3):
        start = time.perf_counter()
        p, loss = train_step(p, batch, moe)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)

    # The MoE forward through the flash kernel; each call's inputs and
    # output are kept, to hold the kernel against its plain version on the
    # very operands this path gives it. The model finds the wrapper by the
    # module's name, and the wrapper counts its launches under that name,
    # so the name is the wrapper's own while it runs.
    flash = dataclasses.replace(moe, use_flash_attention=True)
    kernel, calls = flash_mod.flash_attention, []

    def recorded(q, k, v, causal=True):
        flash_mod.flash_attention = kernel
        try:
            out = kernel(q, k, v, causal)
        finally:
            flash_mod.flash_attention = recorded
        calls.append((q, k, v, out))
        return out

    reset_counts()
    flash_mod.flash_attention = recorded
    try:
        start = time.perf_counter()
        got = forward(params, batch["tokens"], flash)
        torch.cuda.synchronize()
        flash_s = time.perf_counter() - start
    finally:
        flash_mod.flash_attention = kernel
    launches = counts()
    layer_errs, layer_excess = [], []
    for q, k, v, out in calls:
        ref = flash_mod.flash_attention_reference(q, k, v).float()
        err = (out.float() - ref).abs()
        layer_errs.append(float(err.max()))
        layer_excess.append(float((err - (K2_ATOL + K2_RTOL * ref.abs())).max()))
    want = forward(params, batch["tokens"], moe)
    diff = (got - want).abs()
    flash_nll = torch.nn.functional.cross_entropy(
        got.reshape(-1, moe.vocab), batch["targets"].reshape(-1)
    )
    flash_loss = float(flash_nll)
    info = {
        "cfg": {k: getattr(ENTRY_CFG, k) for k in
                ("vocab", "d_model", "n_heads", "d_ff", "n_layers", "seq_len", "batch")},
        "forward_s": forward_s,
        "logits_shape": list(logits.shape),
        "loss": entry_loss,
        "cpu_f32_loss": entry_ref,
        "moe": {"n_experts": moe.n_experts, "losses": losses, "cpu_f32_loss": moe_ref,
                "step_s": step_s},
        "flash_forward": {"seconds": flash_s, "launches": launches,
                          "kernel_max_abs_err_by_layer": layer_errs,
                          "kernel_tol": f"{K2_ATOL} + {K2_RTOL}*|plain|",
                          "loss": flash_loss,
                          "logits_max_abs_diff_to_plain_core": float(diff.max())},
    }
    print(json.dumps({"entry": info, "card": card}), flush=True)
    if tuple(logits.shape) != (ENTRY_CFG.batch, ENTRY_CFG.seq_len, ENTRY_CFG.vocab) or not bool(
        torch.isfinite(logits).all()
    ):
        raise AssertionError(f"entry forward: logits {tuple(logits.shape)} not finite or shaped")
    for name, ours, ref in (("entry", entry_loss, entry_ref), ("moe", losses[0], moe_ref)):
        if not abs(ours - ref) <= CARD_VS_CPU_REL * abs(ref):
            raise AssertionError(f"{name} loss {ours} on the card, {ref} in f32 on the CPU")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE train step loss not finite and falling: {losses}")
    if not bool(torch.isfinite(got).all()) or any(x > 0 for x in layer_excess):
        raise AssertionError(f"MoE flash forward: the kernel is off its plain version: {info}")
    if not abs(flash_loss - moe_ref) <= CARD_VS_CPU_REL * abs(moe_ref):
        raise AssertionError(f"MoE flash forward loss {flash_loss}, {moe_ref} in f32 on the CPU")
    if len(calls) != moe.n_layers or launches["flash_attention"] != moe.n_layers \
            or launches["matmul"] != 0:
        raise AssertionError(f"MoE flash forward: kernel launches {launches}")
    return info


def flagship_layouts(n: int) -> list[dict]:
    """The MoE flagship's sharded layouts over a world of ``n`` cards: the
    one card's own, else the expert and tensor axes, tensor and sequence
    (ring and Ulysses), and the pipeline with dp."""
    if n == 1:
        return [{"axes": {"dp": 1}}]
    if n % 4 == 0:
        dp = n // 4
        return [
            {"axes": {"dp": dp, "ep": 2, "tp": 2}},
            {"axes": {"dp": dp, "tp": 2, "sp": 2}, "sp_impl": "ring"},
            {"axes": {"dp": dp, "tp": 2, "sp": 2}, "sp_impl": "ulysses"},
            {"axes": {"dp": n // 2, "pp": 2}, "n_microbatches": 2},
        ]
    dp = n // 2
    return [
        {"axes": {"dp": dp, "ep": 2}},
        {"axes": {"dp": dp, "sp": 2}, "sp_impl": "ring"},
        {"axes": {"dp": dp, "sp": 2}, "sp_impl": "ulysses"},
        {"axes": {"dp": dp, "pp": 2}, "n_microbatches": 2},
    ]


def dryrun_phase(card: str) -> dict:
    """``dryrun_multichip`` on an NCCL world of every card, two steps each
    program, then the MoE flagship's sharded step over the world's layouts,
    its first loss held against the unsharded step's on the card."""
    import torch

    from k8s_operator_libs_tpu_torch.entry import ENTRY_CFG, dryrun_multichip, timed_steps
    from k8s_operator_libs_tpu_torch.models.burnin import init_params, loss_fn, synthetic_batch
    from k8s_operator_libs_tpu_torch.parallel.mesh import World, available_devices

    def show(key: str, value) -> None:
        print(json.dumps({key: value, "card": card}), flush=True)

    n = torch.cuda.device_count()
    moe = dataclasses.replace(ENTRY_CFG, n_experts=4)
    unsharded = float(loss_fn(
        init_params(torch.Generator().manual_seed(0), moe, "cuda"),
        synthetic_batch(torch.Generator().manual_seed(1), moe, "cuda"),
        moe,
    ))
    world = World(available_devices())
    if world.backend != "nccl":
        raise AssertionError(f"a world of cards joined through {world.backend}")
    try:
        start = time.perf_counter()
        world.start()
        form_s = time.perf_counter() - start
        programs = dryrun_multichip(world, steps=2)
        show("dryrun_multichip", {"world_size": n, "world_form_s": form_s, "programs": programs})
        flagship = []
        for layout in flagship_layouts(n):
            per_rank = world.run(
                timed_steps, layout["axes"], moe, 2, layout.get("sp_impl", "ring"),
                layout.get("n_microbatches"),
            )
            result = {
                **layout,
                "losses": per_rank[0]["losses"],
                "seconds": [max(r["seconds"][i] for r in per_rank) for i in range(2)],
                "same_on_every_rank": all(r["losses"] == per_rank[0]["losses"] for r in per_rank),
            }
            flagship.append(result)
            show("dryrun_flagship", {"unsharded_loss": unsharded, **result})
    finally:
        world.close()
    for program in programs:
        if not all(math.isfinite(x) for x in program["losses"]):
            raise AssertionError(f"dryrun program {program['name']}: {program['losses']}")
    for result in flagship:
        first = result["losses"][0]
        if not (result["same_on_every_rank"] and all(math.isfinite(x) for x in result["losses"])
                and abs(first - unsharded) <= SHARDED_REL * abs(unsharded)):
            raise AssertionError(f"MoE flagship sharded step: {result}, unsharded {unsharded}")
    if n < 2:
        show("not_run", "the ep, tp, sp and pp axes and dp > 1 need two or more cards, "
             "and the dry run's expert and pipeline programs four and two; this machine "
             "has one card, so each program ran at every axis 1")
    return {"programs": programs, "flagship": flagship}


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


def _last_json(path: str, key: str = "") -> dict:
    with open(path) as f:
        for line in reversed(f.read().splitlines()):
            if line.startswith("{") and (not key or key in json.loads(line)):
                return json.loads(line)
    raise AssertionError(f"no JSON line{' with ' + key if key else ''} in {path}")


def run_probe_pod(container: dict, host_paths: dict, workdir: str, label: str) -> dict:
    """Run the pod's container command as the kubelet would, until its ready
    file appears; check it parked; stop it. ``host_paths`` maps a hostPath
    the pod mounts to the directory that stands for it here."""
    import signal

    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    argv = list(container["command"])
    argv[0] = sys.executable
    ready = os.path.join(workdir, f"{label}.ready")
    argv[argv.index("--ready-file") + 1] = ready
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for item in container["env"]:
        env[item["name"]] = host_paths.get(item["value"], item["value"])
    out_path = os.path.join(workdir, f"{label}.out")
    err_path = os.path.join(workdir, f"{label}.err")
    with open(out_path, "w") as out, open(err_path, "w") as err:
        start = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=workdir, env=env, stdout=out, stderr=err,
                                start_new_session=True)
        try:
            while not os.path.exists(ready):
                if proc.poll() is not None:
                    with open(err_path) as f:
                        tail = f.read()[-3000:]
                    raise AssertionError(
                        f"{label} probe pod exited {proc.returncode} before Ready: {tail}"
                    )
                if time.perf_counter() - start > POD_READY_TIMEOUT_S:
                    raise AssertionError(
                        f"{label} probe pod not Ready within {POD_READY_TIMEOUT_S} s"
                    )
                time.sleep(0.05)
            seconds_to_ready = time.perf_counter() - start
            time.sleep(1.0)
            parked = proc.poll() is None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
    report = HealthReport.from_dict(_last_json(out_path))
    kernels = _last_json(err_path, "kernels")["kernels"]
    if not parked:
        raise AssertionError(f"{label} probe pod did not park after its pass")
    if not (report.ok and report.mxu and report.mxu.ok and report.flash and report.flash.ok):
        raise AssertionError(f"{label} probe pod report: {report.summary()}")
    return {
        "seconds_to_ready": seconds_to_ready,
        "elapsed_s": report.elapsed_s,
        "mxu_tflops": report.mxu.tflops,
        "flash_ok": report.flash.ok,
        "flash_tokens_per_s": report.flash.tokens_per_s,
        "build_s": kernels["build_s"],
        "launches": kernels["launches"],
    }


def device_class_phase(card: str, gate_launches: dict) -> dict:
    """The GPU node's labels, detection and probe pod, and the pod's
    payload run cold and warm on one kernel cache."""
    import tempfile

    import torch

    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.detector import TpuNodeDetector
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
        ValidationPodManager,
        ValidationPodSpec,
    )

    count = torch.cuda.device_count()
    node = Node.new("gpu-node-0", labels=local_gpu_labels())
    info = TpuNodeDetector().detect(node)
    if info is None or info.chips != count:
        raise AssertionError(f"detector on {node.labels}: {info}")
    # The default spec: the pod asks for the node's own count, not the
    # spec's 8 cards.
    spec = ValidationPodSpec()
    manager = ValidationPodManager(None, spec)
    (container,) = manager.build_pod(node.name, manager.cards(node)).spec["containers"]
    limits = container["resources"]["limits"]
    if limits != {"nvidia.com/gpu": str(count)}:
        raise AssertionError(f"probe pod limits: {limits}")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="probe-pod-") as workdir:
        host_paths = {spec.compile_cache_dir: os.path.join(workdir, "kernel-cache")}
        for label in ("cold", "warm"):
            runs[label] = run_probe_pod(container, host_paths, workdir, label)
    result = {
        "node_labels": node.labels,
        "product": info.topology.accelerator,
        "chips": info.chips,
        "slice_id": info.slice_id,
        "limits": limits,
        "command": container["command"],
        **runs,
    }
    print(json.dumps({"device_class": result, "card": card}), flush=True)
    cold, warm = runs["cold"], runs["warm"]
    if not all(cold["build_s"].get(lib, 0.0) > 0 for lib in ("matmul", "flash_attention")):
        raise AssertionError(f"the cold pod did not build both kernels: {cold['build_s']}")
    if any(warm["build_s"].values()):
        raise AssertionError(f"the warm pod built again: {warm['build_s']}")
    for label, run in runs.items():
        for lib in ("matmul", "flash_attention"):
            if run["launches"][lib] != gate_launches[lib]:
                raise AssertionError(
                    f"{label} probe pod launched {lib} {run['launches'][lib]} times, "
                    f"the gate phase {gate_launches[lib]}"
                )
    return result


# ----------------------------------------------------------------------
# The monitor and the slice gang.
# ----------------------------------------------------------------------

class DictClient:
    """The operator's client, as far as the monitor and the report
    publisher use it, over dicts: Node, Pod, Event and NodeHealthReport,
    resourceVersions checked on update, errors with the API's reasons."""

    CLUSTER_SCOPED = ("Node", "NodeHealthReport")

    def __init__(self) -> None:
        self.objects: dict[tuple, dict] = {}
        self.version = 0
        self.lock = threading.Lock()

    def _key(self, kind: str, name: str, namespace: str) -> tuple:
        return (kind, "" if kind in self.CLUSTER_SCOPED else namespace or "default", name)

    def _stored(self, key: tuple) -> dict:
        from k8s_operator_libs_tpu_torch.kube.client import NotFoundError

        if key not in self.objects:
            raise NotFoundError(f"{key[0]} {key[2]} not found")
        return self.objects[key]

    def _put(self, key: tuple, raw: dict):
        from k8s_operator_libs_tpu_torch.kube.objects import wrap

        self.version += 1
        raw["metadata"]["resourceVersion"] = str(self.version)
        self.objects[key] = raw
        return wrap(json.loads(json.dumps(raw)))

    def get(self, kind: str, name: str, namespace: str = ""):
        from k8s_operator_libs_tpu_torch.kube.objects import wrap

        with self.lock:
            return wrap(json.loads(json.dumps(self._stored(self._key(kind, name, namespace)))))

    def list(self, kind: str, namespace: str = "", label_selector=None, field_selector=None):
        from k8s_operator_libs_tpu_torch.kube.objects import wrap

        wanted = dict(p.split("=", 1) for p in (label_selector or "").split(",") if p)
        fields = dict(p.split("=", 1) for p in (field_selector or "").split(",") if p)
        out = []
        with self.lock:
            for (k, ns, _), raw in sorted(self.objects.items()):
                labels = raw["metadata"].get("labels") or {}
                if k != kind or (namespace and ns != namespace):
                    continue
                if any(labels.get(a) != b for a, b in wanted.items()):
                    continue
                node = (raw.get("spec") or {}).get("nodeName")
                if "spec.nodeName" in fields and node != fields["spec.nodeName"]:
                    continue
                out.append(wrap(json.loads(json.dumps(raw))))
        return out

    def create(self, obj):
        from k8s_operator_libs_tpu_torch.kube.client import AlreadyExistsError

        raw = json.loads(json.dumps(obj.raw))
        key = self._key(raw["kind"], raw["metadata"]["name"], raw["metadata"].get("namespace", ""))
        with self.lock:
            if key in self.objects:
                raise AlreadyExistsError(f"{key[0]} {key[2]} already exists")
            raw["metadata"]["uid"] = f"uid-{self.version + 1}"
            return self._put(key, raw)

    def _replace(self, obj, status_only: bool):
        from k8s_operator_libs_tpu_torch.kube.client import ConflictError

        raw = json.loads(json.dumps(obj.raw))
        key = self._key(raw["kind"], raw["metadata"]["name"], raw["metadata"].get("namespace", ""))
        with self.lock:
            stored = self._stored(key)
            rv = raw["metadata"].get("resourceVersion")
            if rv and rv != stored["metadata"]["resourceVersion"]:
                raise ConflictError(f"{key[0]} {key[2]}: stale resourceVersion {rv}")
            if status_only:
                stored = json.loads(json.dumps(stored))
                stored["status"] = raw.get("status") or {}
                raw = stored
            return self._put(key, raw)

    def update(self, obj):
        return self._replace(obj, status_only=False)

    def update_status(self, obj):
        return self._replace(obj, status_only=True)

    def patch(self, kind: str, name: str, namespace: str = "", patch=None, patch_type="merge"):
        def merge(target: dict, change: dict) -> None:
            for k, v in change.items():
                if v is None:
                    target.pop(k, None)
                elif isinstance(v, dict) and isinstance(target.get(k), dict):
                    merge(target[k], v)
                else:
                    target[k] = v

        key = self._key(kind, name, namespace)
        with self.lock:
            raw = json.loads(json.dumps(self._stored(key)))
            merge(raw, patch or {})
            return self._put(key, raw)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        key = self._key(kind, name, namespace)
        with self.lock:
            self._stored(key)
            del self.objects[key]


class ApiStub(ThreadingHTTPServer):
    """A ``DictClient`` behind the API's REST paths on 127.0.0.1, for the
    port's ``RestClient`` in a child process (the payload's
    ``--publish-report``)."""

    daemon_threads = True
    PATH = re.compile(
        r"^/(?:api/v1|apis/[^/]+/[^/]+)(?:/namespaces/(?P<ns>[^/]+))?"
        r"/(?P<plural>[^/?]+)(?:/(?P<name>[^/?]+))?(?:/(?P<sub>status))?"
    )

    def __init__(self, client: DictClient) -> None:
        from k8s_operator_libs_tpu_torch.kube.rest import RESOURCES

        kinds = {plural: kind for kind, (_, plural, _) in RESOURCES.items()}
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def _serve(self) -> None:
                from k8s_operator_libs_tpu_torch.kube.objects import wrap

                m = stub.PATH.match(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length)) if length else None
                try:
                    kind = kinds[m.group("plural")]
                    ns, name = m.group("ns") or "", m.group("name") or ""
                    if self.command == "GET" and name:
                        out = client.get(kind, name, ns).raw
                    elif self.command == "GET":
                        out = {"items": [o.raw for o in client.list(kind, ns)]}
                    elif self.command == "POST":
                        out = client.create(wrap(body)).raw
                    elif self.command == "PUT":
                        out = client._replace(wrap(body), m.group("sub") == "status").raw
                    else:
                        raise ValueError(f"{self.command} is not served here")
                    code = 200
                except Exception as e:  # noqa: BLE001 - answered as the API does
                    reason = getattr(e, "reason", "BadRequest")
                    code = {"NotFound": 404, "AlreadyExists": 409, "Conflict": 409}.get(reason, 400)
                    out = {"kind": "Status", "reason": reason, "message": str(e), "code": code}
                data = json.dumps(out).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = _serve

            def log_message(self, fmt, *args):  # noqa: D102
                pass

        super().__init__(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}"

    def __enter__(self) -> "ApiStub":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def payload_lines(stderr: str) -> dict:
    """The payload's stderr line of kernel builds, launches and world."""
    for line in reversed(stderr.splitlines()):
        if line.startswith("{") and "kernels" in line:
            return json.loads(line)
    raise AssertionError(f"no kernels line on the payload's stderr: {stderr[-2000:]}")


def check_launches(label: str, launches: dict, gate_launches: dict) -> None:
    for lib in ("matmul", "flash_attention"):
        if launches[lib] != gate_launches[lib]:
            raise AssertionError(
                f"{label} launched {lib} {launches[lib]} times, the gate phase "
                f"{gate_launches[lib]}"
            )


def monitor_phase(card: str, gate_launches: dict) -> dict:
    """Monitor cycles on the card: pass, fail, busy, quick tier."""
    from k8s_operator_libs_tpu_torch.kube.events import EventRecorder
    from k8s_operator_libs_tpu_torch.kube.objects import Node, Pod, condition_status
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate, SubprocessHealthGate
    from k8s_operator_libs_tpu_torch.tpu.monitor import (
        ICI_HEALTHY_CONDITION,
        ReportPublisher,
        TpuHealthMonitor,
        make_quick_probe_guard,
        run_quick_probe_loop,
    )

    client = DictClient()
    node = Node.new(MONITOR_NODE, labels=local_gpu_labels())
    node.set_ready(True)
    client.create(node)

    def condition() -> str:
        return condition_status(client.get("Node", MONITOR_NODE).status, ICI_HEALTHY_CONDITION)

    def cycle(gate) -> tuple:
        monitor = TpuHealthMonitor(
            client, MONITOR_NODE, gate=gate, failure_threshold=1, success_threshold=1,
            recorder=EventRecorder(client), report_publisher=ReportPublisher(client, MONITOR_NODE),
        )
        start = time.perf_counter()
        report = monitor.check_once()
        return report, time.perf_counter() - start

    def subprocess_gate(**overrides):
        return SubprocessHealthGate(
            cli_args=IciHealthGate.tpu_defaults(**overrides).to_cli_args(),
            timeout_seconds=CLI_TIMEOUT_S, env=child_env(), cwd=REPO,
        )

    info: dict = {"node_labels": node.labels}
    gate = subprocess_gate()
    report, info["pass_wall_s"] = cycle(gate)
    payload = payload_lines(gate.last_stderr)
    info["pass_launches"] = payload["kernels"]["launches"]
    info["pass_world_form_times"] = payload["world"]["form_times"]
    info["pass_elapsed_s"] = report.elapsed_s if report else None
    info["pass_condition"] = condition()
    published = client.get("NodeHealthReport", MONITOR_NODE).raw
    info["report_mxu_tflops"] = published["status"]["metrics"].get("mxu_tflops")
    info["report_score"] = published["status"]["score"]
    if report is None or not report.ok:
        raise AssertionError(f"monitor: the passing cycle failed: {report and report.failures}")
    if info["pass_condition"] != "True":
        raise AssertionError(f"monitor: condition {info['pass_condition']} after a pass")
    if info["report_mxu_tflops"] != report.mxu.tflops:
        raise AssertionError(
            f"monitor: NodeHealthReport mxu_tflops {info['report_mxu_tflops']}, "
            f"the card's {report.mxu.tflops}"
        )

    gate = subprocess_gate(min_mxu_tflops=1e9)
    report, info["fail_wall_s"] = cycle(gate)
    info["fail_launches"] = payload_lines(gate.last_stderr)["kernels"]["launches"]
    info["fail_condition"] = condition()
    warnings = [e.raw for e in client.list("Event") if e.raw["type"] == "Warning"]
    info["warning_events"] = [e["message"] for e in warnings]
    if report is None or report.ok or info["fail_condition"] != "False" or len(warnings) != 1:
        raise AssertionError(f"monitor: the failing cycle: {info}")

    class Counted:
        runs = 0

        def run(self):
            Counted.runs += 1
            raise AssertionError("the gate ran on a busy node")

    busy = Pod.new("trainer", namespace="default")
    busy.node_name = MONITOR_NODE
    busy.spec["containers"] = [{"name": "t", "resources": {"limits": {"nvidia.com/gpu": "1"}}}]
    busy.raw["status"] = {"phase": "Running"}
    client.create(busy)
    skipped, _ = cycle(Counted())
    info["busy_skipped"] = skipped is None and Counted.runs == 0
    client.delete("Pod", "trainer", "default")
    if not info["busy_skipped"]:
        raise AssertionError("monitor: a busy node was probed")

    start = time.perf_counter()
    # A heartbeat of 0 writes every cycle: the full tier's report is fresh,
    # and the quick tier's healthy checks would otherwise be debounced.
    rc = run_quick_probe_loop(
        ReportPublisher(client, MONITOR_NODE, source="quick-probe", heartbeat_seconds=0.0),
        once=True,
        skip_cycle=make_quick_probe_guard(client, MONITOR_NODE),
    )
    info["quick_wall_s"] = time.perf_counter() - start
    quick = client.get("NodeHealthReport", MONITOR_NODE).raw
    info["quick_report"] = {k: quick["status"][k] for k in ("checks", "metrics")}
    print(json.dumps({"monitor": info, "card": card}), flush=True)
    # The quick battery's own checks (the report's spec keeps the source
    # that created it: a status write leaves the spec).
    if rc != 0 or quick["status"]["checks"] != {"ring_allreduce": True, "mxu": True}:
        raise AssertionError(f"monitor: quick tier rc {rc}: {quick['status']}")
    check_launches("monitor payload", info["pass_launches"], gate_launches)
    return info


def gang_phase(card: str, gate_launches: dict) -> dict:
    """The payload as a slice gang pod: one child on every card, then (with
    two or more cards) two children on half the cards each."""
    import tempfile

    import torch

    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    n = torch.cuda.device_count()
    client = DictClient()
    for name in GANG_NODES:
        client.create(Node.new(name))
    info: dict = {}
    with ApiStub(client) as stub, tempfile.TemporaryDirectory(prefix="gang-") as work:
        kubeconfig = os.path.join(work, "kubeconfig")
        with open(kubeconfig, "w") as f:
            json.dump({
                "current-context": "c",
                "clusters": [{"name": "c", "cluster": {"server": stub.url}}],
                "users": [{"name": "u", "user": {}}],
                "contexts": [{"name": "c", "context": {"cluster": "c", "user": "u"}}],
            }, f)

        def run_gang(label: str, cards: list[list[int]]) -> list[dict]:
            coordinator = f"127.0.0.1:{free_port()}"
            procs = []
            start = time.perf_counter()
            for i, visible in enumerate(cards):
                ready = os.path.join(work, f"{label}-{i}.ready")
                out = open(os.path.join(work, f"{label}-{i}.out"), "w")
                err = open(os.path.join(work, f"{label}-{i}.err"), "w")
                argv = [
                    sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.health",
                    "--coordinator", coordinator, "--num-processes", str(len(cards)),
                    "--process-id", str(i), "--link-peers", ",".join(GANG_NODES[:len(cards)]),
                    "--publish-report", "--ready-file", ready,
                ]
                env = child_env(
                    KUBECONFIG=kubeconfig, NODE_NAME=GANG_NODES[i],
                    CUDA_VISIBLE_DEVICES=",".join(map(str, visible)),
                )
                procs.append((subprocess.Popen(argv, cwd=REPO, env=env, stdout=out,
                                               stderr=err), out, err, ready))
            results = []
            for proc, out, err, ready in procs:
                try:
                    rc = proc.wait(timeout=CLI_TIMEOUT_S)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait(30)
                    out.close()
                    err.close()
                with open(out.name) as f:
                    lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
                with open(err.name) as f:
                    stderr = f.read()
                if not lines:
                    raise AssertionError(f"gang {label}: no report (rc {rc}): {stderr[-3000:]}")
                report = HealthReport.from_dict(json.loads(lines[-1]))
                payload = payload_lines(stderr)
                results.append({
                    "rc": rc,
                    "report": report,
                    "summary": report.summary(),
                    "ready": open(ready).read().strip() if os.path.exists(ready) else None,
                    "launches": payload["kernels"]["launches"],
                    "world_form_times": payload["world"]["form_times"],
                    "links": [(h.src, h.dst, h.peer, h.ok) for h in report.links],
                })
            wall = time.perf_counter() - start
            for r in results:
                r["wall_s"] = wall
            return results

        (one,) = run_gang("one-pod", [list(range(n))])
        report = one.pop("report")
        published = client.get("NodeHealthReport", GANG_NODES[0]).raw
        info["one_pod"] = {**one, "process_count": report.process_count,
                           "slice_devices_total": report.slice_devices_total,
                           "published_source": published["spec"]["source"]}
        if not (one["rc"] == 0 and report.ok and report.process_count == 1
                and report.slice_devices_total == n and "slice=" in report.summary()
                and one["ready"] and "slice=" in one["ready"]
                and published["spec"]["source"] == "gate"):
            raise AssertionError(f"gang of one pod: {info['one_pod']} {report.failures}")
        check_launches("gang payload", one["launches"], gate_launches)
        if n >= 2:
            k = n // 2
            pods = run_gang("two-pod", [list(range(k)), list(range(k, 2 * k))])
            info["two_pods"] = []
            for i, pod in enumerate(pods):
                report = pod.pop("report")
                info["two_pods"].append(pod)
                want = f"slice={2 * k}/{2 * k} over 2 hosts"
                other = GANG_NODES[1 - i]
                if pod["rc"] != 0 or not pod["ready"] or want not in pod["ready"]:
                    raise AssertionError(f"gang of two pods, pod {i}: {pod} {report.failures}")
                if not any(peer == other for _, _, peer, ok in pod["links"] if ok):
                    raise AssertionError(f"gang pod {i}: no hop to {other}: {pod['links']}")
        else:
            info["two_pods"] = "not run: a gang of two pods needs two or more cards"
    print(json.dumps({"gang": info, "card": card}), flush=True)
    return info


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
    flagship = entry_phase(card)
    dryrun_phase(card)
    cli_phase()
    pod = device_class_phase(card, launches)
    monitor = monitor_phase(card, launches)
    gang = gang_phase(card, launches)

    for row in rows:
        kernel = "matmul" if row["name"] == "matmul" else "flash_attention"
        row["launches"] = launches[kernel]
        row["launches_burnin_flash_forward"] = burnin_launches[kernel]
        row["launches_entry_flash_forward"] = flagship["flash_forward"]["launches"][kernel]
        row["launches_validation_pod"] = pod["cold"]["launches"][kernel]
        row["launches_monitor"] = monitor["pass_launches"][kernel]
        row["launches_gang"] = gang["one_pod"]["launches"][kernel]
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
