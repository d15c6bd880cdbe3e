"""Entry points: the flagship forward and the multi-card dry run.

No module of the JAX package sits at this path: its counterparts are the
repository's driver entry points, ``entry()`` and ``dryrun_multichip(n)``
(``__graft_entry__.py``), which this module follows in torch's terms.

* :func:`entry` gives the burn-in transformer's forward at the flagship
  width, with its arguments, on the card (or ``device``).
* :func:`dryrun_multichip` runs the JAX dry run's three programs, one train
  step each, over a :class:`~.parallel.mesh.World` the caller forms and
  closes: the sharded step over dp × ep × tp × sp with the mixture of
  experts, then an expert-parallel program and a pipeline program where
  the world's size allows them. The axes come from the world's size as in
  the JAX program; the world is NCCL over cards or gloo over CPU ranks.

    from k8s_operator_libs_tpu_torch.entry import dryrun_multichip
    from k8s_operator_libs_tpu_torch.parallel.mesh import World

    if __name__ == "__main__":      # the world's ranks import the main module
        world = World(["cpu"] * 4)  # or World(available_devices()) on cards
        try:
            dryrun_multichip(world)
        finally:
            world.close()
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from .models.burnin import (
    BurninConfig,
    forward,
    init_params,
    make_sharded_train_step,
    synthetic_batch,
)
from .models.pipeline import make_pipeline_train_step
from .utils.device import DeviceLike, resolve_device, synchronize

#: The flagship model's widths (the JAX entry point's own config).
ENTRY_CFG = BurninConfig(
    vocab=1024,
    d_model=256,
    n_heads=8,
    d_ff=1024,
    n_layers=4,
    seq_len=256,
    batch=4,
)


def entry(device: DeviceLike = None):
    """``(fn, args)``: the forward step of the flagship model and its
    parameters and tokens (seeds 0 and 1) on ``device`` (default ``cuda``);
    ``fn(*args)`` gives the logits."""
    cfg = ENTRY_CFG
    dev = resolve_device(device)
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    tokens = synthetic_batch(torch.Generator().manual_seed(1), cfg, dev)["tokens"]

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def timed_steps(
    axes: dict[str, int],
    cfg: BurninConfig,
    steps: int = 1,
    sp_impl: str = "ring",
    n_microbatches: Optional[int] = None,
) -> dict:
    """``steps`` train steps on a ``build_mesh(axes)`` mesh (inside a rank):
    the sharded step, or with ``n_microbatches`` the pipeline step. The
    loss before each step and each step's seconds on this rank, the card
    synchronised."""
    from .parallel.mesh import build_mesh

    mesh = build_mesh(axes)
    if n_microbatches is None:
        step, p, b = make_sharded_train_step(mesh, cfg, sp_impl=sp_impl)
    else:
        step, p, b = make_pipeline_train_step(mesh, cfg, n_microbatches)
    losses, seconds = [], []
    for _ in range(steps):
        start = time.perf_counter()
        p, loss = step(p, b)
        losses.append(float(loss))
        synchronize(mesh.device)  # the update too
        seconds.append(time.perf_counter() - start)
    return {"losses": losses, "seconds": seconds}


def dryrun_programs(n: int) -> list[dict]:
    """The JAX dry run's programs for a world of ``n`` ranks, in its order:
    each a dict of ``name`` (``sharded``, ``expert`` or ``pipeline``),
    ``axes``, ``cfg`` and, for the pipeline, ``n_microbatches``."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 else 1
    rem //= sp
    # dp keeps priority over ep; ep joins this program with 16+ ranks.
    ep = 2 if rem % 2 == 0 and rem >= 4 else 1
    dp = rem // ep
    programs = [{
        "name": "sharded",
        "axes": {"dp": dp, "ep": ep, "tp": tp, "sp": sp},
        "cfg": BurninConfig(
            vocab=128, d_model=32, n_heads=2 * tp, d_ff=64, n_layers=2,
            seq_len=16 * sp, batch=max(2, dp * 2), n_experts=2 * ep,
        ),
    }]
    if ep == 1 and n % 4 == 0:
        programs.append({
            "name": "expert",
            "axes": {"dp": n // 4, "ep": 2, "tp": 2},
            "cfg": BurninConfig(
                vocab=128, d_model=32, n_heads=4, d_ff=64, n_layers=1,
                seq_len=16, batch=2 * (n // 4), n_experts=2,
            ),
        })
    if n % 2 == 0:
        programs.append({
            "name": "pipeline",
            "axes": {"dp": n // 2, "pp": 2},
            "cfg": BurninConfig(
                vocab=128, d_model=32, n_heads=2, d_ff=64, n_layers=2,
                seq_len=16, batch=2 * (n // 2) * 2,
            ),
            "n_microbatches": 2,
        })
    return programs


def dryrun_multichip(world, steps: int = 1) -> list[dict]:
    """Run the JAX dry run's programs over ``world``, ``steps`` train steps
    each, and print one line a program, ``dryrun_multichip: [expert |
    pipeline ]mesh={...} loss=... ok``. Returns, by program, its ``name``,
    ``mesh``, ``loss`` (before the first step), ``losses`` (before each)
    and each step's ``seconds`` (the slowest rank's).
    Raises on a loss that is not finite."""
    results = []
    for program in dryrun_programs(world.size):
        per_rank = world.run(
            timed_steps, program["axes"], program["cfg"], steps, "ring",
            program.get("n_microbatches"),
        )
        losses, name = per_rank[0]["losses"], program["name"]
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"dryrun_multichip: non-finite {name} loss {losses}")
        prefix = "" if name == "sharded" else name + " "
        print(
            f"dryrun_multichip: {prefix}mesh={program['axes']} loss={losses[0]:.4f} ok",
            flush=True,
        )
        results.append({
            "name": name,
            "mesh": program["axes"],
            "loss": losses[0],
            "losses": losses,
            "seconds": [max(r["seconds"][i] for r in per_rank) for i in range(steps)],
        })
    return results
