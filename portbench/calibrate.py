"""The two readings each gate limit is set from, on the card.

    python -m portbench.calibrate --config gpu_node_gate --seeds 1-12 \\
        --control-seeds 101-103 [--batteries 2]

For each of ``--seeds`` it runs the shipped gate on that seed's inputs at
the cell's own size (a warm battery, then ``--batteries`` recorded ones,
as a run's window would) and prints the numbers ``checks.py`` compares:
the lower readings. For each of ``--control-seeds`` it puts the control in
the port's place (``drivers.gate.control_battery``: the reference in the
precision below the configuration's) and prints the same numbers: the
upper readings. One world serves every seed. The last line holds, for each
number, the largest port reading and the smallest control reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional


def seeds(text: str) -> list[int]:
    """``"1-3,7"`` -> [1, 2, 3, 7]."""
    out: list[int] = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi) + 1) if hi else [int(lo)])
    return out


def _finite(value: float) -> Optional[float]:
    return value if math.isfinite(value) else None


def calibrate(config: dict, port_seeds: list, control_seeds: list, batteries: int,
              cards: int = 1, device: Optional[str] = None, emit=print) -> dict:
    from .drivers import gate as gate_driver
    from .record import Run

    conf = config["gate"]
    card = device or "cuda:0"
    gate = gate_driver.make_gate(conf, cards, device)
    readings: dict = {"port": {}, "control": {}}
    burnin_batch = None
    links = 1
    try:
        gate.run()
        for seed in port_seeds:
            probes = gate_driver.GateProbes(gate, conf, seed, Run(), sample=batteries)
            probes.install()
            try:
                probes.battery(record=False)
                for _ in range(batteries):
                    probes.battery()
                probes.host_outputs()
            finally:
                probes.uninstall()
            burnin_batch = probes.burnin_batch
            links = probes.chain_links_expected()
            numbers = probes.numbers()
            readings["port"][seed] = numbers
            emit(json.dumps({"side": "port", "seed": seed,
                             **{k: _finite(v) for k, v in numbers.items()}}))
    finally:
        gate.close()
    for seed in control_seeds:
        battery = gate_driver.control_battery(conf, seed, burnin_batch or 2, links, card)
        numbers = gate_driver.gate_numbers(conf, seed, [battery], [0], burnin_batch or 2,
                                           links, card)
        readings["control"][seed] = numbers
        emit(json.dumps({"side": "control", "seed": seed,
                         **{k: _finite(v) for k, v in numbers.items()}}))
    summary = {}
    names = next(iter(readings["port"].values()), {}).keys()
    for name in names:
        lower = max(r[name] for r in readings["port"].values())
        upper = min((r[name] for r in readings["control"].values()), default=math.nan)
        summary[name] = {"lower": _finite(lower), "upper": _finite(upper)}
    emit(json.dumps({"summary": summary}))
    return summary


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench.calibrate",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--seeds", required=True, type=seeds)
    parser.add_argument("--control-seeds", required=True, type=seeds)
    parser.add_argument("--batteries", type=int, default=2)
    parser.add_argument("--device", default=None, help="cpu: the plain versions on CPU ranks")
    args = parser.parse_args(argv)
    from . import run, spec

    run.set_caches(spec.ROOT)
    bench = spec.load_benchmark()
    entry = next(c for c in bench["workloads"] if c["config"] == args.config)
    config = spec.config(bench, entry)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("portbench.calibrate: no CUDA card", file=sys.stderr)
            return 3
    try:
        calibrate(config, args.seeds, args.control_seeds, args.batteries, device=args.device)
    finally:
        run.stop_resource_tracker()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
