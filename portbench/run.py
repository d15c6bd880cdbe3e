"""Run one cell of ``BENCHMARK.json`` once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's cards. Prints one
JSON line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers are
the last lines on standard error. Exits 3 without a result where CUDA is
not available or the host has fewer cards than the cell asks for, and 4
where the JAX package or JAX was imported.

The port's kernel build directory and Triton's cache are fixed
directories of the checkout (``build/portbench/``), so only a cell's first
run in a checkout builds. Spawned rank processes import this module, so
it does nothing when imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

#: Top-level module names that must not be loaded in a run: JAX and the
#: JAX package the port was made from (compared whole: the port's name
#: begins with the JAX package's).
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "k8s_operator_libs_tpu"})

#: Where the port's kernels and every compiler cache go, in the checkout.
CACHE_DIR = Path("build") / "portbench"

#: Entries of ``breakdown``'s lists, and the characters kept of a kernel's
#: name there.
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 120


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {name.partition(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN_MODULES)


def set_caches(root: Path) -> None:
    """Point the port's kernel build and the compilers' caches at fixed
    directories of the checkout, keep libraries from loading JAX, and give
    each process of the run (the world's spawned ranks inherit it) one
    thread for torch's CPU operations unless the environment names a
    number: a pod shares its node's cores, and parallel regions whose
    threads wait on one another swing with every other load on the host."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    cache = (Path(root) / CACHE_DIR).resolve()
    os.environ["K8S_OPERATOR_LIBS_TORCH_KERNEL_DIR"] = str(cache / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_age_s() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@dataclass
class Context:
    """One run's settings, and the trace's start and stop, for a driver."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    cards: int
    #: None on the cards; ``"cpu"`` runs the gate's plain versions on CPU
    #: ranks (the tests).
    device: Optional[str] = None
    #: What the driver's ``before_torch`` made, and its notes.
    prepared: object = None
    notes: dict = field(default_factory=dict)

    def setup_seconds(self) -> float:
        return process_age_s()

    def start_trace(self, world):
        """Start the profilers of this process and of ``world``'s ranks."""
        if not self.trace:
            return None
        from . import devtrace

        world.run(devtrace.rank_start)
        return devtrace.start()

    @contextlib.contextmanager
    def window(self, run):
        """The measured window: its garbage collections and what the host
        did besides (``record.host_clock``) counted into ``run.notes``; a
        profiler range with tracing on."""
        from .record import gc_clock, host_clock

        with gc_clock(run.notes), host_clock(run.notes):
            if not self.trace:
                yield
                return
            import torch

            from .devtrace import WINDOW_RANGE

            with torch.profiler.record_function(WINDOW_RANGE):
                yield

    def stop_trace(self, prof, world, run) -> None:
        """Stop the profilers and put the merged trace on ``run``."""
        if prof is None:
            return
        from . import devtrace

        main = devtrace.collect(prof)
        ranks = world.run(devtrace.rank_stop)
        run.device = devtrace.merge(main, ranks, self.cards)
        run.notes["device_events"] = {"traced": [len(t["device"]) for t in [main, *ranks]],
                                      "in_window": run.device.in_window}


def stop_resource_tracker() -> None:
    """Stop multiprocessing's resource tracker, which the world's spawned
    ranks started, and wait for it: otherwise it outlives this process by
    a moment."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def _number(value) -> Optional[float]:
    return float(value) if value is not None and math.isfinite(value) else None


def result_line(bench: dict, cell: dict, outcome, trace: bool, device: dict) -> dict:
    """The result line for ``outcome`` (a driver's ``Outcome``)."""
    from . import checks, spec

    correct, table = checks.verdict(outcome.numbers, outcome.limits)
    metrics = {}
    for metric in spec.cell_metrics(bench, cell, trace):
        name = metric["name"]
        if trace:
            value = spec.reader(name)(outcome.run)
        elif name == "setup_s":
            value = outcome.setup_s
        else:
            value = outcome.end_to_end.get(name)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": metric["unit"]}
    line = {
        "correct": bool(correct),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": dict(device, memory_peak_bytes=int(outcome.memory_peak_bytes)),
    }
    trace_data = outcome.run.device
    if trace and trace_data is not None:
        line["device"]["busy_s"] = trace_data.busy_s
        line["device"]["window_s"] = trace_data.window_s
        line["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in trace_data.ops[:BREAKDOWN_ENTRIES]],
            "idle_gaps": [[n, s] for n, s in trace_data.idle_gaps[:BREAKDOWN_ENTRIES]],
        }
    line["checks"] = {
        name: {"value": _number(row["value"]), "limit": row["limit"]}
        for name, row in table.items()
    }
    return line


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m portbench.run", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True,
                        help="the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    from . import spec

    set_caches(spec.ROOT)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cards = int(cell["chips"])
    config = spec.config(bench, cell)
    ctx = Context(cell=cell, config=config, traffic=spec.traffic(cell["traffic"]),
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace), cards=cards)
    driver = spec.driver(config["system"])
    # What a driver must make before torch loads (drivers/roll.py).
    before_torch = getattr(driver, "before_torch", None)
    if before_torch is not None:
        before_torch(ctx)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"portbench: the cell asks for {cards} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    try:
        outcome = driver.run_cell(ctx)
    finally:
        stop_resource_tracker()
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cards}
    line = result_line(bench, cell, outcome, ctx.trace, device)
    print("portbench: notes " + json.dumps(outcome.run.notes), file=sys.stderr)
    for name, row in line["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
