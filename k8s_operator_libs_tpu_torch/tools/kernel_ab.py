"""Time this checkout's CUDA kernels beside another checkout's, on one card.

    python -m k8s_operator_libs_tpu_torch.tools.kernel_ab --other DIR

``DIR`` is the root of another checkout of the repo, for example the
parent commit unpacked with ``git archive``. Each checkout's kernels are
built from its own sources and called through its own wrappers, on the same
inputs, at the kernel rows of ``chip_smoke.py`` that both versions take.
Every row runs other, this, this, other, and each side's time is the mean
of its two runs: ``ms`` from a CUDA graph of back-to-back calls (the card's
time), ``call_ms`` from the same calls made one by one from Python (the
host's cost per call included). A shape one version does not take is
reported as raising there. Prints the card's name and power limit, then one
JSON line per row. Needs an NVIDIA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

MATMUL_SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (4096, 4096, 4096), (129, 77, 257))
FLASH_CASES = (
    ((1, 4, 1024, 128), True),
    ((1, 4, 1024, 128), False),
    ((8, 4, 128, 32), True),
    ((1, 4, 1024, 64), True),
    ((2, 16, 4096, 128), True),
)


def _load_port(root: Path, alias: str):
    """The port package of the checkout at ``root``, imported as ``alias``
    (its modules import one another relatively, so two copies coexist)."""
    pkg = root / "k8s_operator_libs_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)]
    )
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (
        importlib.import_module(f"{alias}.ops.matmul").matmul,
        importlib.import_module(f"{alias}.ops.flash_attention").flash_attention,
    )


def _time_ms(fn, reps: int, graph: bool) -> float:
    """Mean ms of one ``fn()`` from CUDA events after a warm-up: a replay
    of ``reps`` captured calls with ``graph``, else ``reps`` calls from
    Python."""
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


def _compare(row: dict, sides: dict, reps: int) -> dict:
    """Time each side's call (other, this, this, other) and check that the
    two agree."""
    outs = {}
    for name, fn in sides.items():
        try:
            outs[name] = fn().float()
        except NotImplementedError as e:
            row[name] = {"raises": str(e)}
    runs: dict[str, list] = {name: [] for name in outs}
    for name in ("other", "this", "this", "other"):
        if name in outs:
            runs[name].append((_time_ms(sides[name], reps, True),
                               _time_ms(sides[name], reps, False)))
    for name, pairs in runs.items():
        row[name] = {
            "ms": sum(p[0] for p in pairs) / len(pairs),
            "call_ms": sum(p[1] for p in pairs) / len(pairs),
            "runs": pairs,
        }
    if len(outs) == 2:
        row["max_abs_diff"] = float((outs["this"] - outs["other"]).abs().max())
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="root of the other checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    this_root = Path(__file__).resolve().parents[2]
    this_mm, this_fa = _load_port(this_root, "this_port")
    other_mm, other_fa = _load_port(args.other.resolve(), "other_port")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in MATMUL_SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
        reps = max(10, min(1000, int(2e12 / (2.0 * m * k * n))))
        row = _compare({"kernel": "matmul", "shape_mkn": [m, k, n]},
                       {"other": lambda: other_mm(a, b), "this": lambda: this_mm(a, b)},
                       reps)
        print(json.dumps(row), flush=True)
    for shape, causal in FLASH_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        b_, h, s, d = shape
        pairs = s * (s + 1) // 2 if causal else s * s
        reps = max(20, min(200, int(2e11 / (4.0 * d * pairs * b_ * h))))
        row = _compare(
            {"kernel": "flash_attention", "shape": list(shape), "causal": causal},
            {"other": lambda: other_fa(q, k, v, causal=causal),
             "this": lambda: this_fa(q, k, v, causal=causal)},
            reps,
        )
        print(json.dumps(row), flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
