"""Burn-in workload: a small transformer LM train step, on one device or
sharded over the ranks of a world.

The full-stack half of the post-upgrade health gate: if a freshly upgraded
driver can train this — matmuls, attention, a backward pass, the
collectives of a sharded step and an SGD update — the node is healthy end
to end.

The parameters are a plain dict with the JAX package's tree (``embed``,
``ln_f``, ``layers[i]`` with ``ln1``, ``wqkv``, ``wo``, ``ln2``, ``w_up``,
``w_down``) and its layout, ``x @ W`` with ``W`` shaped (d_in, d_out), so
:func:`params_from_jax` turns the JAX package's parameters into these and
both packages compute the same thing.

Sharding (:func:`make_sharded_train_step`, inside a rank) over two axes:

* ``tp`` — Megatron tensor parallelism: ``wqkv`` and ``w_up`` split by
  columns, ``wo`` and ``w_down`` by rows, an all-reduce over tp after each
  row-split product. Each tp rank holds whole heads: its own heads' q, k
  and v columns (:func:`shard_params`);
* ``dp`` — the batch split, the gradients averaged over dp;
* embeddings and norms replicated.

The sequence (``sp``) and expert (``ep``) axes and the mixture-of-experts
MLP are not ported yet (ROADMAP queue A, item A3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.device import DeviceLike, resolve_device

Params = dict[str, Any]


@dataclass(frozen=True)
class BurninConfig:
    vocab: int = 512
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    n_layers: int = 2
    seq_len: int = 128
    batch: int = 8
    dtype: torch.dtype = torch.bfloat16
    # Use the CUDA flash kernel (ops.flash_attention) as the attention core
    # instead of the plain softmax attention. Forward-only: a train step
    # with it on the card raises rather than drop the attention gradients.
    use_flash_attention: bool = False
    # >0 replaces the dense MLP with a soft mixture-of-experts in the JAX
    # package; here only 0 is supported until the multi-GPU slice.
    n_experts: int = 0

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def _check_config(cfg: BurninConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts burn-in (n_experts > 0) is not ported yet "
            "(ROADMAP queue A, item A3: sharded burn-in)"
        )


def init_params(
    generator: torch.Generator, cfg: BurninConfig, device: DeviceLike = None
) -> Params:
    """Random parameters from ``generator`` (a CPU generator, so one seed
    gives the same parameters on every device), placed on ``device``
    (default ``cuda``)."""
    _check_config(cfg)
    dev = resolve_device(device)
    scale = cfg.d_model**-0.5

    def dense(*shape: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator) * scale
        return w.to(cfg.dtype).to(dev)

    def ones() -> torch.Tensor:
        return torch.ones(cfg.d_model, dtype=torch.float32, device=dev)

    layers = [
        {
            "ln1": ones(),
            "wqkv": dense(cfg.d_model, 3 * cfg.d_model),
            "wo": dense(cfg.d_model, cfg.d_model),
            "ln2": ones(),
            "w_up": dense(cfg.d_model, cfg.d_ff),
            "w_down": dense(cfg.d_ff, cfg.d_model),
        }
        for _ in range(cfg.n_layers)
    ]
    return {"embed": dense(cfg.vocab, cfg.d_model), "ln_f": ones(), "layers": layers}


def params_from_jax(tree: Params, device: DeviceLike = None) -> Params:
    """The JAX package's ``init_params`` tree, with every leaf as a numpy
    array (``jax.tree.map(np.asarray, params)``), as this module's params
    on ``device`` (default ``cuda``). bf16 leaves stay bf16, bit for bit."""
    dev = resolve_device(device)

    def leaf(x: np.ndarray) -> torch.Tensor:
        x = np.asarray(x)
        if str(x.dtype) == "bfloat16":
            t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(x))
        return t.to(dev)

    return {
        "embed": leaf(tree["embed"]),
        "ln_f": leaf(tree["ln_f"]),
        "layers": [{k: leaf(w) for k, w in layer.items()} for layer in tree["layers"]],
    }


def _rms_norm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    norm = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * norm * gain).to(x.dtype)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, added in f32, in ``x``'s dtype."""
    total = x.to(torch.float32, copy=True)
    dist.all_reduce(total, group=group)
    return total.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: partial products summed over the group forward,
    gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _copy_to(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _CopyToGroup.apply(x, tp)


def _reduce_from(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _ReduceFromGroup.apply(x, tp)


def _attention(layer: Params, x: torch.Tensor, cfg: BurninConfig, tp=None) -> torch.Tensor:
    """Attention over the heads this rank holds (all of them without
    ``tp``, the tensor-parallel group)."""
    b, s, _ = x.shape
    width = layer["wqkv"].shape[1] // 3
    q, k, v = (_copy_to(x, tp) @ layer["wqkv"]).split(width, dim=-1)

    def heads(t: torch.Tensor) -> torch.Tensor:
        return (
            t.reshape(b, s, width // cfg.head_dim, cfg.head_dim)
            .transpose(1, 2).contiguous()
        )

    if cfg.use_flash_attention:
        from ..ops.flash_attention import flash_attention

        out = flash_attention(heads(q), heads(k), heads(v))
    else:
        from ..ops.ulysses import local_causal_attention

        out = local_causal_attention(heads(q), heads(k), heads(v))
    out = out.transpose(1, 2).reshape(b, s, width)
    return _reduce_from(out @ layer["wo"], tp)


def _mlp(layer: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    up = F.gelu(_copy_to(x, tp) @ layer["w_up"], approximate="tanh")
    return _reduce_from(up @ layer["w_down"], tp)


def forward(
    params: Params, tokens: torch.Tensor, cfg: BurninConfig, tp=None
) -> torch.Tensor:
    """Token ids (b, s) -> logits (b, s, vocab), in f32. With ``tp`` (a
    process group), ``params`` are this rank's tensor-parallel share."""
    _check_config(cfg)
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = x + _attention(layer, _rms_norm(x, layer["ln1"]), cfg, tp)
        x = x + _mlp(layer, _rms_norm(x, layer["ln2"]), tp)
    x = _rms_norm(x, params["ln_f"])
    return (x @ params["embed"].T).float()


def loss_fn(
    params: Params, batch: dict[str, torch.Tensor], cfg: BurninConfig, tp=None
) -> torch.Tensor:
    logits = forward(params, batch["tokens"], cfg, tp)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["targets"].unsqueeze(-1))
    return nll.mean()


def _leaves(params: Params) -> list[torch.Tensor]:
    out = [params["embed"], params["ln_f"]]
    for layer in params["layers"]:
        out.extend(layer[k] for k in sorted(layer))
    return out


def _rebuild(params: Params, leaves: list[torch.Tensor]) -> Params:
    it = iter(leaves)
    new: Params = {"embed": next(it), "ln_f": next(it), "layers": []}
    for layer in params["layers"]:
        new["layers"].append({k: next(it) for k in sorted(layer)})
    return new


def sgd_update(params: Params, grads: Params, lr: float) -> Params:
    """The one SGD rule every train step shares (f32 update, param dtype
    storage). Returns new tensors; ``params`` is left as it was."""
    return _rebuild(
        params,
        [
            (p.float() - lr * g.float()).to(p.dtype)
            for p, g in zip(_leaves(params), _leaves(grads))
        ],
    )


def train_step(
    params: Params,
    batch: dict[str, torch.Tensor],
    cfg: BurninConfig,
    lr: float = 1e-2,
) -> tuple[Params, torch.Tensor]:
    """One SGD step: (new params, loss before the step)."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    loss = loss_fn(_rebuild(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = sgd_update(params, _rebuild(params, list(grads)), lr)
    return new, loss.detach()


def synthetic_batch(
    generator: torch.Generator, cfg: BurninConfig, device: Optional[DeviceLike] = None
) -> dict[str, torch.Tensor]:
    """Random tokens from ``generator`` (CPU) on ``device`` (default
    ``cuda``); the targets are the tokens shifted by one."""
    dev = resolve_device(device)
    tokens = torch.randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len), generator=generator
    ).to(dev)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=-1)}


# ----------------------------------------------------------------------
# Sharding, inside a rank of a world.
# ----------------------------------------------------------------------

def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A, item A3: sharded burn-in)"
    )


def param_specs(
    cfg: BurninConfig,
    tp_axis: Optional[str] = "tp",
    ep_axis: Optional[str] = None,
) -> Params:
    """Which dim of each parameter is split over which mesh axis, as a
    tuple with one entry per dim (the JAX package's PartitionSpecs): ``tp``
    splits ``wqkv`` and ``w_up`` by columns and ``wo`` and ``w_down`` by
    rows; ``None`` for an axis replicates its weights. ``wqkv``'s columns
    are split by heads (:func:`shard_params`)."""
    if cfg.n_experts or ep_axis is not None:
        raise _not_ported("the mixture-of-experts burn-in (ep axis)")
    tp = tp_axis
    layer_spec = {
        "ln1": (),
        "wqkv": (None, tp),
        "wo": (tp, None),
        "ln2": (),
        "w_up": (None, tp),
        "w_down": (tp, None),
    }
    return {"embed": (), "ln_f": (), "layers": [layer_spec] * cfg.n_layers}


def batch_spec(
    seq_axis: Optional[str] = None, batch_axis: Optional[str] = "dp"
) -> dict[str, tuple]:
    return {"tokens": (batch_axis, seq_axis), "targets": (batch_axis, seq_axis)}


def _split(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    return t.chunk(parts, dim=dim)[index].contiguous()


def shard_params(
    params: Params, cfg: BurninConfig, tp_index: int = 0, tp_size: int = 1
) -> Params:
    """Tensor-parallel rank ``tp_index``'s share of full ``params``, as
    :func:`param_specs` lays it out. ``wqkv``'s q, k and v thirds are each
    split by heads, so the rank holds its own heads' q, k and v columns:
    contiguous thirds would give it q of some heads beside k of others."""
    if cfg.n_heads % tp_size or cfg.d_ff % tp_size:
        raise ValueError(
            f"tp {tp_size} must divide n_heads {cfg.n_heads} and d_ff {cfg.d_ff}"
        )
    spec = param_specs(cfg)["layers"][0]

    def share(name: str, w: torch.Tensor) -> torch.Tensor:
        if "tp" not in spec[name]:
            return w
        dim = spec[name].index("tp")
        if name == "wqkv":
            return torch.cat(
                [_split(t, dim, tp_index, tp_size) for t in w.chunk(3, dim=dim)],
                dim=dim,
            )
        return _split(w, dim, tp_index, tp_size)

    return {
        "embed": params["embed"],
        "ln_f": params["ln_f"],
        "layers": [
            {name: share(name, w) for name, w in layer.items()}
            for layer in params["layers"]
        ],
    }


def make_sharded_train_step(
    mesh,
    cfg: BurninConfig,
    lr: float = 1e-2,
    params: Optional[Params] = None,
    batch: Optional[dict[str, torch.Tensor]] = None,
):
    """The train step sharded over ``mesh`` (``parallel.mesh.build_mesh``,
    inside a rank): ``dp`` splits the batch and averages the gradients,
    ``tp`` is Megatron tensor parallelism. Full ``params`` and ``batch``
    default to :func:`init_params` at seed 0 and :func:`synthetic_batch` at
    seed 1. Returns ``(step, local_params, local_batch)``, this rank's
    shares on its device; ``step(p, b)`` gives ``(new p, loss before the
    step)``, the loss of the whole batch on every rank. The ``sp`` and
    ``ep`` axes wait for ROADMAP queue A, item A3."""
    for axis in ("sp", "ep"):
        if mesh.shape.get(axis, 1) > 1:
            raise _not_ported(f"the {axis} axis of the sharded burn-in")
    _check_config(cfg)
    dp, tp = mesh.shape.get("dp", 1), mesh.shape.get("tp", 1)
    dp_group = mesh.groups["dp"] if dp > 1 else None
    tp_group = mesh.groups["tp"] if tp > 1 else None
    if cfg.batch % dp:
        raise ValueError(f"dp {dp} must divide batch {cfg.batch}")
    if params is None:
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    if batch is None:
        batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, "cpu")
    share = shard_params(params, cfg, mesh.coords.get("tp", 0), tp)
    local_params = _rebuild(share, [p.to(mesh.device) for p in _leaves(share)])
    dp_index, specs = mesh.coords.get("dp", 0), batch_spec()
    local_batch = {
        name: _split(t, specs[name].index("dp"), dp_index, dp).to(mesh.device)
        for name, t in batch.items()
    }

    def step(p: Params, b: dict[str, torch.Tensor]) -> tuple[Params, torch.Tensor]:
        leaves = [x.detach().requires_grad_(True) for x in _leaves(p)]
        loss = loss_fn(_rebuild(p, leaves), b, cfg, tp_group)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if dp_group is not None:
            # One all-reduce for every gradient and the loss: the means
            # over the dp ranks' equal shares of the batch.
            flat = torch.cat(
                [g.float().reshape(-1) for g in grads] + [loss.reshape(1)]
            )
            dist.all_reduce(flat, group=dp_group)
            flat /= dp
            parts = flat.split([g.numel() for g in grads] + [1])
            grads = [
                part.reshape(g.shape).to(g.dtype) for part, g in zip(parts, grads)
            ]
            loss = parts[-1].reshape(())
        with torch.no_grad():
            new = sgd_update(p, _rebuild(p, grads), lr)
        return new, loss

    return step, local_params, local_batch


def sharded_losses(
    axes: dict[str, int],
    cfg: BurninConfig,
    steps: int = 2,
    params: Optional[Params] = None,
    tokens: Optional[np.ndarray] = None,
) -> list[float]:
    """Run ``steps`` sharded train steps on a ``build_mesh(axes)`` mesh
    (inside a rank) and return the loss before each. ``params`` (full, on
    the CPU: ``params_from_jax`` carries the JAX package's) and ``tokens``
    (targets are the tokens shifted by one) default to seeds 0 and 1."""
    from ..parallel.mesh import build_mesh

    batch = None
    if tokens is not None:
        t = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
        batch = {"tokens": t, "targets": torch.roll(t, -1, dims=-1)}
    step, p, b = make_sharded_train_step(
        build_mesh(axes), cfg, params=params, batch=batch
    )
    losses = []
    for _ in range(steps):
        p, loss = step(p, b)
        losses.append(float(loss))
    return losses
