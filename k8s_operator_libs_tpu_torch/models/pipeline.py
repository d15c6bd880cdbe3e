"""Pipeline parallelism for the burn-in model: GPipe over a ``pp`` axis of a
world, the counterpart of the JAX package's ``models/pipeline.py``.

The layers are stacked into leaves with a leading ``n_layers`` dim and
split over ``pp``: each stage (a rank) holds ``n_layers/pp`` consecutive
layers. Microbatches flow through the stages on a fixed schedule of
``M + pp - 1`` ticks: every tick, every stage runs its layers and hands its
activations to the next stage with one neighbour rotation
(``parallel.mesh.rotate``). Bubble ticks compute values that never reach
the loss, masked by tensors rather than skipped by Python branches, so
every stage runs the same program and every rotation lies in every stage's
autograd graph.

Autograd through the schedule is the backward pipeline: each rotation's
backward sends the activations' gradient back one stage. ``embed`` and
``ln_f`` are used on the first and last stage, so their gradients are
summed over ``pp`` (JAX's ``shard_map`` transpose does this implicitly);
the stacked layers' over ``dp``, an optional axis that splits each
microbatch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .burnin import (
    BurninConfig,
    Params,
    _all_reduce_flat,
    _block,
    _full_batch,
    _logits,
    _nll,
    _sgd,
    _split,
    init_params,
    synthetic_batch,
)


def stack_layers(layers: list[Params]) -> Params:
    """[{leaf: (...)}, ...] -> {leaf: (n_layers, ...)} for pp sharding."""
    return {name: torch.stack([layer[name] for layer in layers]) for name in layers[0]}


def _leaves(params: Params) -> list[torch.Tensor]:
    """The embedding and ln_f first, then the stacked layers' leaves."""
    stacked = params["stacked"]
    return [params["embed"], params["ln_f"]] + [stacked[k] for k in sorted(stacked)]


def _rebuild(params: Params, leaves: list[torch.Tensor]) -> Params:
    keys = sorted(params["stacked"])
    return {
        "embed": leaves[0],
        "ln_f": leaves[1],
        "stacked": dict(zip(keys, leaves[2:])),
    }


def _pipeline_loss_fn(mesh, cfg: BurninConfig, n_microbatches: int):
    """loss(params, batch) of this stage under the GPipe schedule (inside a
    rank): its share of the mean loss over every microbatch, nonzero on the
    last stage only. Summed over pp and dp it is the step's loss. params =
    {"embed", "ln_f", "stacked"} with this stage's layers; batch tokens and
    targets are (M, microbatch / dp, seq)."""
    from ..parallel.mesh import rotate

    pp, stage = mesh.shape["pp"], mesh.coords["pp"]
    dp = mesh.shape.get("dp", 1)
    M = n_microbatches
    last = pp - 1
    ticks = M + pp - 1
    scale = 1.0 / (M * dp)

    def loss(params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        embed, ln_f, stacked = params["embed"], params["ln_f"], params["stacked"]
        layers = [
            {name: w[i] for name, w in stacked.items()}
            for i in range(next(iter(stacked.values())).shape[0])
        ]
        tokens, targets = batch["tokens"], batch["targets"]
        device = tokens.device
        is_first = torch.tensor(stage == 0, device=device)
        is_last = torch.tensor(stage == last, device=device)
        carry = torch.zeros(
            (tokens.shape[1], tokens.shape[2], cfg.d_model), dtype=cfg.dtype, device=device
        )
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(ticks):
            # Stage 0 takes microbatch t (clamped: the ticks after the last
            # one run it again, and their outputs never reach the loss).
            x = torch.where(is_first, embed[tokens[min(t, M - 1)]], carry)
            for layer in layers:
                x = _block(layer, x, cfg)
            out_mb = t - last  # the microbatch the last stage finishes now
            if 0 <= out_mb < M:
                nll = _nll(_logits(x, {"embed": embed, "ln_f": ln_f}), targets[out_mb])
                loss_sum = loss_sum + torch.where(is_last, nll.mean(), 0.0)
            if t < ticks - 1:  # the last tick's hand-off would go unused
                carry = rotate(mesh, "pp", x)
        return loss_sum * scale

    return loss


def _pipeline_setup(mesh, cfg: BurninConfig, n_microbatches: int, params, batch):
    """(value_and_grad, local params, local batch) of a pipeline step."""
    from ..parallel.mesh import group_over

    if "pp" not in mesh.shape:
        raise ValueError("a pipeline mesh needs a 'pp' axis")
    pp, dp = mesh.shape["pp"], mesh.shape.get("dp", 1)
    if cfg.n_layers % pp:
        raise ValueError(f"pp axis size {pp} must divide n_layers ({cfg.n_layers})")
    M = n_microbatches
    if cfg.batch % (M * dp):
        raise ValueError(f"batch ({cfg.batch}) must split into {M} microbatches x dp={dp}")
    mb = cfg.batch // M
    if params is None:
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    if batch is None:
        batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, "cpu")
    stage, dp_index = mesh.coords["pp"], mesh.coords.get("dp", 0)
    stacked = stack_layers(params["layers"])
    local_params = {
        "embed": params["embed"].to(mesh.device),
        "ln_f": params["ln_f"].to(mesh.device),
        "stacked": {
            name: _split(w, 0, stage, pp).to(mesh.device) for name, w in stacked.items()
        },
    }
    local_batch = {
        name: _split(t.reshape(M, mb, cfg.seq_len), 1, dp_index, dp).to(mesh.device)
        for name, t in batch.items()
    }
    loss_fn = _pipeline_loss_fn(mesh, cfg, M)
    dp_group, pp_group = group_over(mesh, ("dp",)), group_over(mesh, ("pp",))

    def value_and_grad(p: Params, b: dict[str, torch.Tensor]):
        leaves = [x.detach().requires_grad_(True) for x in _leaves(p)]
        share = loss_fn(_rebuild(p, leaves), b)
        grads = list(torch.autograd.grad(share, leaves))
        loss = share.detach()
        # Every gradient and the loss: summed over dp (the scale holds 1/dp).
        if dp_group is not None:
            *grads, loss = _all_reduce_flat(grads + [loss], dp_group)
        # The embedding's, ln_f's and the loss: summed over the stages too.
        if pp_group is not None:
            *grads[:2], loss = _all_reduce_flat(grads[:2] + [loss], pp_group)
        return loss, grads

    return value_and_grad, local_params, local_batch


def make_pipeline_train_step(
    mesh,
    cfg: BurninConfig,
    n_microbatches: int = 4,
    lr: float = 1e-2,
    params: Optional[Params] = None,
    batch: Optional[dict[str, torch.Tensor]] = None,
):
    """A pipeline-parallel train step over a mesh with a ``pp`` axis and
    optionally ``dp`` (``parallel.mesh.build_mesh``, inside a rank). Full
    ``params`` (``init_params``' tree) and ``batch`` default to seeds 0 and
    1, as ``burnin.make_sharded_train_step``'s do. Returns ``(step,
    local_params, local_batch)``: the embedding and ``ln_f`` whole, this
    stage's layers stacked, this dp rank's part of each microbatch;
    ``step(p, b)`` gives ``(new p, loss before the step)`` on every rank."""
    value_and_grad, local_params, local_batch = _pipeline_setup(
        mesh, cfg, n_microbatches, params, batch
    )

    def step(p: Params, b: dict[str, torch.Tensor]) -> tuple[Params, torch.Tensor]:
        loss, grads = value_and_grad(p, b)
        with torch.no_grad():
            new = _rebuild(p, _sgd(_leaves(p), grads, lr))
        return new, loss

    return step, local_params, local_batch


def pipeline_losses(
    axes: dict[str, int],
    cfg: BurninConfig,
    steps: int = 2,
    n_microbatches: int = 4,
    params: Optional[Params] = None,
    tokens: Optional[np.ndarray] = None,
) -> list[float]:
    """Run ``steps`` pipeline train steps on a ``build_mesh(axes)`` mesh
    (inside a rank) and return the loss before each; ``params`` and
    ``tokens`` as ``burnin.sharded_losses`` takes them."""
    from ..parallel.mesh import build_mesh

    step, p, b = make_pipeline_train_step(
        build_mesh(axes), cfg, n_microbatches, params=params, batch=_full_batch(tokens)
    )
    losses = []
    for _ in range(steps):
        p, loss = step(p, b)
        losses.append(float(loss))
    return losses


def pipeline_grads(
    axes: dict[str, int],
    cfg: BurninConfig,
    n_microbatches: int = 4,
    params: Optional[Params] = None,
    tokens: Optional[np.ndarray] = None,
) -> Params:
    """This stage's gradients of the first pipeline step, after the step's
    own sums over dp and pp (inside a rank), as f32 numpy arrays in the
    local params' tree: what the SGD update is given."""
    from ..parallel.mesh import build_mesh

    value_and_grad, p, b = _pipeline_setup(
        build_mesh(axes), cfg, n_microbatches, params, _full_batch(tokens)
    )
    _, grads = value_and_grad(p, b)
    return _rebuild(p, [g.float().cpu().numpy() for g in grads])
