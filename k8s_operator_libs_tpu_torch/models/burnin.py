"""Burn-in workload: a small transformer LM train step, on one device or
sharded over the ranks of a world.

The full-stack half of the post-upgrade health gate: if a freshly upgraded
driver can train this — matmuls, attention, a backward pass, the
collectives of a sharded step and an SGD update — the node is healthy end
to end.

The parameters are a plain dict with the JAX package's tree (``embed``,
``ln_f``, ``layers[i]`` with ``ln1``, ``wqkv``, ``wo``, ``ln2`` and either
``w_up``, ``w_down`` or, with ``n_experts > 0``, ``w_router``,
``experts_up``, ``experts_down``) and its layout, ``x @ W`` with ``W``
shaped (d_in, d_out), so :func:`params_from_jax` turns the JAX package's
parameters into these and both packages compute the same thing.

Sharding (:func:`make_sharded_train_step`, inside a rank) over four axes:

* ``tp`` — Megatron tensor parallelism: ``wqkv`` and ``w_up`` split by
  columns, ``wo`` and ``w_down`` by rows, an all-reduce over tp after each
  row-split product. Each tp rank holds whole heads: its own heads' q, k
  and v columns (:func:`shard_params`); each expert's ffn splits the same
  way;
* ``dp`` — the batch split;
* ``sp`` — the sequence split: attention runs as ring attention
  (``ops.ring_attention``) or Ulysses (``ops.ulysses``). Each rank's loss
  is the mean over its equal block of (batch, sequence), so the loss and
  every gradient are averaged over dp and sp together;
* ``ep`` — expert parallelism: the experts split over ep, the soft combine
  one all-reduce over ep and tp together. Each rank back-propagates only
  through its own experts' columns of the router's softmax, so the
  router's gradient is summed over that group;
* embeddings, norms and the router replicated.

The pipeline over ``pp`` is ``models.pipeline``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

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
    # >0 replaces the dense MLP with a soft mixture-of-experts: every
    # expert runs, the router's softmax weights combine them; the experts
    # split over the ``ep`` axis of a sharded step.
    n_experts: int = 0

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(
                f"n_heads {self.n_heads} must divide d_model {self.d_model}"
            )
        return self.d_model // self.n_heads


def init_params(
    generator: torch.Generator, cfg: BurninConfig, device: DeviceLike = None
) -> Params:
    """Random parameters from ``generator`` (a CPU generator, so one seed
    gives the same parameters on every device), placed on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    scale = cfg.d_model**-0.5

    def dense(*shape: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator) * scale
        return w.to(cfg.dtype).to(dev)

    def ones() -> torch.Tensor:
        return torch.ones(cfg.d_model, dtype=torch.float32, device=dev)

    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"ln1": ones(), "wqkv": dense(d, 3 * d), "wo": dense(d, d), "ln2": ones()}
        if e:
            layer["w_router"] = dense(d, e)
            layer["experts_up"] = dense(e, d, f)
            layer["experts_down"] = dense(e, f, d)
        else:
            layer["w_up"] = dense(d, f)
            layer["w_down"] = dense(f, d)
        layers.append(layer)
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


def _copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def _reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


@dataclass(frozen=True)
class Placement:
    """A rank's part in a sharded step (the default: the whole model on
    one device)."""

    #: The tensor-parallel group (Megatron's f and g around each product).
    tp: Any = None
    #: The group the experts' combine sums over: ep and tp together.
    moe: Any = None
    #: The global index of the first of this rank's experts.
    first_expert: int = 0
    #: The sequence-parallel attention core, q, k, v -> out, in place of
    #: the flash or plain core.
    attn_core: Optional[Callable] = None


UNSHARDED = Placement()


def _attention(
    layer: Params, x: torch.Tensor, cfg: BurninConfig, place: Placement = UNSHARDED
) -> torch.Tensor:
    """Attention over the heads this rank holds (all of them without a
    tensor-parallel group)."""
    b, s, _ = x.shape
    tp = place.tp
    width = layer["wqkv"].shape[1] // 3
    q, k, v = (_copy_to(x, tp) @ layer["wqkv"]).split(width, dim=-1)

    def heads(t: torch.Tensor) -> torch.Tensor:
        return (
            t.reshape(b, s, width // cfg.head_dim, cfg.head_dim)
            .transpose(1, 2).contiguous()
        )

    if place.attn_core is not None:
        out = place.attn_core(heads(q), heads(k), heads(v))
    elif cfg.use_flash_attention:
        from ..ops.flash_attention import flash_attention

        out = flash_attention(heads(q), heads(k), heads(v))
    else:
        from ..ops.ulysses import local_causal_attention

        out = local_causal_attention(heads(q), heads(k), heads(v))
    out = out.transpose(1, 2).reshape(b, s, width)
    return _reduce_from(out @ layer["wo"], tp)


def _mlp(layer: Params, x: torch.Tensor, place: Placement = UNSHARDED) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    up = F.gelu(_copy_to(x, place.tp) @ layer["w_up"], approximate="tanh")
    return _reduce_from(up @ layer["w_down"], place.tp)


def _moe(layer: Params, x: torch.Tensor, place: Placement = UNSHARDED) -> torch.Tensor:
    """Soft mixture of experts: the router's softmax (in f32, cast to the
    dtype) weighs every expert's output. A rank runs its own experts (and
    its tp share of each) with their columns of the softmax; the combine is
    one all-reduce over ``place.moe``."""
    x = _copy_to(x, place.moe)
    probs = torch.softmax((x @ layer["w_router"]).float(), dim=-1).to(x.dtype)
    local = layer["experts_up"].shape[0]
    probs = probs[..., place.first_expert:place.first_expert + local]
    up = torch.einsum("bsd,edf->besf", x, layer["experts_up"])
    out = torch.einsum(
        "besf,efd->besd", F.gelu(up, approximate="tanh"), layer["experts_down"]
    )
    return _reduce_from(torch.einsum("bse,besd->bsd", probs, out), place.moe)


def _block(
    layer: Params, x: torch.Tensor, cfg: BurninConfig, place: Placement = UNSHARDED
) -> torch.Tensor:
    """One transformer layer: attention, then the MLP or the experts."""
    mlp = _moe if cfg.n_experts > 0 else _mlp
    x = x + _attention(layer, _rms_norm(x, layer["ln1"]), cfg, place)
    return x + mlp(layer, _rms_norm(x, layer["ln2"]), place)


def _logits(x: torch.Tensor, params: Params) -> torch.Tensor:
    return (_rms_norm(x, params["ln_f"]) @ params["embed"].T).float()


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.unsqueeze(-1))


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: BurninConfig,
    place: Placement = UNSHARDED,
) -> torch.Tensor:
    """Token ids (b, s) -> logits (b, s, vocab), in f32. In a sharded step
    ``params`` are this rank's share and ``place`` says how it is placed."""
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = _block(layer, x, cfg, place)
    return _logits(x, params)


def loss_fn(
    params: Params,
    batch: dict[str, torch.Tensor],
    cfg: BurninConfig,
    place: Placement = UNSHARDED,
) -> torch.Tensor:
    return _nll(forward(params, batch["tokens"], cfg, place), batch["targets"]).mean()


def _named_leaves(params: Params) -> list[tuple[str, torch.Tensor]]:
    out = [("embed", params["embed"]), ("ln_f", params["ln_f"])]
    for layer in params["layers"]:
        out.extend((k, layer[k]) for k in sorted(layer))
    return out


def _leaves(params: Params) -> list[torch.Tensor]:
    return [t for _, t in _named_leaves(params)]


def _rebuild(params: Params, leaves: list[torch.Tensor]) -> Params:
    it = iter(leaves)
    new: Params = {"embed": next(it), "ln_f": next(it), "layers": []}
    for layer in params["layers"]:
        new["layers"].append({k: next(it) for k in sorted(layer)})
    return new


def _sgd(leaves: list[torch.Tensor], grads: list[torch.Tensor], lr: float) -> list[torch.Tensor]:
    return [(p.float() - lr * g.float()).to(p.dtype) for p, g in zip(leaves, grads)]


def sgd_update(params: Params, grads: Params, lr: float) -> Params:
    """The one SGD rule every train step shares (f32 update, param dtype
    storage). Returns new tensors; ``params`` is left as it was."""
    return _rebuild(params, _sgd(_leaves(params), _leaves(grads), lr))


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

def param_specs(
    cfg: BurninConfig,
    tp_axis: Optional[str] = "tp",
    ep_axis: Optional[str] = None,
) -> Params:
    """Which dim of each parameter is split over which mesh axis, as a
    tuple with one entry per dim (the JAX package's PartitionSpecs): ``tp``
    splits ``wqkv`` and ``w_up`` by columns and ``wo`` and ``w_down`` by
    rows, ``ep`` the experts, and each expert's ffn splits over ``tp``;
    ``None`` for an axis replicates its weights. ``wqkv``'s columns are
    split by heads (:func:`shard_params`)."""
    tp = tp_axis
    layer_spec = {"ln1": (), "wqkv": (None, tp), "wo": (tp, None), "ln2": ()}
    if cfg.n_experts > 0:
        layer_spec["w_router"] = ()
        layer_spec["experts_up"] = (ep_axis, None, tp)
        layer_spec["experts_down"] = (ep_axis, tp, None)
    else:
        layer_spec["w_up"] = (None, tp)
        layer_spec["w_down"] = (tp, None)
    return {"embed": (), "ln_f": (), "layers": [layer_spec] * cfg.n_layers}


def batch_spec(
    seq_axis: Optional[str] = None, batch_axis: Optional[str] = "dp"
) -> dict[str, tuple]:
    return {"tokens": (batch_axis, seq_axis), "targets": (batch_axis, seq_axis)}


def _split(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    return t.chunk(parts, dim=dim)[index].contiguous()


def shard_params(
    params: Params,
    cfg: BurninConfig,
    tp_index: int = 0,
    tp_size: int = 1,
    ep_index: int = 0,
    ep_size: int = 1,
) -> Params:
    """Rank (``tp_index``, ``ep_index``)'s share of full ``params``, as
    :func:`param_specs` lays it out. ``wqkv``'s q, k and v thirds are each
    split by heads, so the rank holds its own heads' q, k and v columns:
    contiguous thirds would give it q of some heads beside k of others."""
    if cfg.n_heads % tp_size or cfg.d_ff % tp_size:
        raise ValueError(
            f"tp {tp_size} must divide n_heads {cfg.n_heads} and d_ff {cfg.d_ff}"
        )
    if ep_size > 1 and (cfg.n_experts <= 0 or cfg.n_experts % ep_size):
        raise ValueError(
            f"ep axis size {ep_size} needs n_experts divisible by it "
            f"(got {cfg.n_experts})"
        )
    spec = param_specs(cfg, "tp", "ep")["layers"][0]
    where = {"tp": (tp_index, tp_size), "ep": (ep_index, ep_size)}

    def share(name: str, w: torch.Tensor) -> torch.Tensor:
        for dim, axis in enumerate(spec[name]):
            if axis is None or where[axis][1] == 1:
                continue
            index, size = where[axis]
            if name == "wqkv":
                w = torch.cat(
                    [_split(t, dim, index, size) for t in w.chunk(3, dim=dim)], dim=dim
                )
            else:
                w = _split(w, dim, index, size)
        return w

    return {
        "embed": params["embed"],
        "ln_f": params["ln_f"],
        "layers": [
            {name: share(name, w) for name, w in layer.items()}
            for layer in params["layers"]
        ],
    }


def _all_reduce_flat(
    tensors: list[torch.Tensor], group, divisor: int = 1
) -> list[torch.Tensor]:
    """The sums of ``tensors`` over ``group``, over ``divisor``, in one
    all-reduce added in f32; each in its own dtype and shape."""
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat /= divisor
    parts = flat.split([t.numel() for t in tensors])
    return [part.reshape(t.shape).to(t.dtype) for part, t in zip(parts, tensors)]


def _sharded_setup(mesh, cfg: BurninConfig, params, batch, sp_impl: str):
    """(value_and_grad, local params, local batch) of a sharded step; full
    ``params`` and ``batch`` default to seeds 0 and 1."""
    from ..parallel.mesh import group_over

    if params is None:
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    if batch is None:
        batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, "cpu")

    dp, tp, sp, ep = (mesh.shape.get(a, 1) for a in ("dp", "tp", "sp", "ep"))
    if cfg.batch % dp:
        raise ValueError(f"dp {dp} must divide batch {cfg.batch}")
    if cfg.seq_len % sp:
        raise ValueError(f"sp axis size {sp} must divide seq_len ({cfg.seq_len})")
    attn_core = None
    if sp > 1:
        from ..ops.ring_attention import ring_attention
        from ..ops.ulysses import ulysses_attention

        cores = {"ring": ring_attention, "ulysses": ulysses_attention}
        if sp_impl not in cores:
            raise ValueError(f"unknown sp_impl {sp_impl!r}")
        attn_core = partial(cores[sp_impl], mesh=mesh, axis="sp", causal=True)
    coords = {a: mesh.coords.get(a, 0) for a in ("dp", "tp", "sp", "ep")}
    share = shard_params(params, cfg, coords["tp"], tp, coords["ep"], ep)
    place = Placement(
        tp=group_over(mesh, ("tp",)),
        moe=group_over(mesh, ("ep", "tp")) if cfg.n_experts > 0 else None,
        first_expert=coords["ep"] * (cfg.n_experts // ep),
        attn_core=attn_core,
    )
    # The ranks that hold the same shares of the parameters and equal
    # blocks of (batch, sequence): the loss and gradients are their means.
    batch_group, blocks = group_over(mesh, ("dp", "sp")), dp * sp
    local_params = _rebuild(share, [p.to(mesh.device) for p in _leaves(share)])
    local_batch = {
        name: _split(_split(t, 0, coords["dp"], dp), 1, coords["sp"], sp).to(mesh.device)
        for name, t in batch.items()
    }

    def value_and_grad(p: Params, b: dict[str, torch.Tensor]):
        named = _named_leaves(p)
        leaves = [x.detach().requires_grad_(True) for _, x in named]
        loss = loss_fn(_rebuild(p, leaves), b, cfg, place)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if place.moe is not None:
            router = [i for i, (name, _) in enumerate(named) if name == "w_router"]
            for i, g in zip(router, _all_reduce_flat([grads[i] for i in router], place.moe)):
                grads[i] = g
        if batch_group is not None:
            *grads, loss = _all_reduce_flat(grads + [loss], batch_group, blocks)
        return loss, grads

    return value_and_grad, local_params, local_batch


def make_sharded_train_step(
    mesh,
    cfg: BurninConfig,
    lr: float = 1e-2,
    params: Optional[Params] = None,
    batch: Optional[dict[str, torch.Tensor]] = None,
    sp_impl: str = "ring",
):
    """The train step sharded over ``mesh`` (``parallel.mesh.build_mesh``,
    inside a rank), each axis used if present: ``dp`` splits the batch,
    ``tp`` is Megatron tensor parallelism, ``sp`` splits the sequence with
    ``sp_impl`` (``"ring"`` or ``"ulysses"``) as the attention core, ``ep``
    splits the experts (``n_experts`` divisible by it). Full ``params``
    and ``batch`` default to :func:`init_params` at seed 0 and
    :func:`synthetic_batch` at seed 1. Returns ``(step, local_params,
    local_batch)``, this rank's shares on its device; ``step(p, b)`` gives
    ``(new p, loss before the step)``, the loss of the whole batch on every
    rank."""
    value_and_grad, local_params, local_batch = _sharded_setup(
        mesh, cfg, params, batch, sp_impl
    )

    def step(p: Params, b: dict[str, torch.Tensor]) -> tuple[Params, torch.Tensor]:
        loss, grads = value_and_grad(p, b)
        with torch.no_grad():
            new = sgd_update(p, _rebuild(p, grads), lr)
        return new, loss

    return step, local_params, local_batch


def _full_batch(tokens: Optional[np.ndarray]) -> Optional[dict[str, torch.Tensor]]:
    if tokens is None:
        return None
    t = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
    return {"tokens": t, "targets": torch.roll(t, -1, dims=-1)}


def sharded_losses(
    axes: dict[str, int],
    cfg: BurninConfig,
    steps: int = 2,
    params: Optional[Params] = None,
    tokens: Optional[np.ndarray] = None,
    sp_impl: str = "ring",
) -> list[float]:
    """Run ``steps`` sharded train steps on a ``build_mesh(axes)`` mesh
    (inside a rank) and return the loss before each. ``params`` (full, on
    the CPU: ``params_from_jax`` carries the JAX package's) and ``tokens``
    (targets are the tokens shifted by one) default to seeds 0 and 1."""
    from ..parallel.mesh import build_mesh

    step, p, b = make_sharded_train_step(
        build_mesh(axes), cfg, params=params, batch=_full_batch(tokens), sp_impl=sp_impl
    )
    losses = []
    for _ in range(steps):
        p, loss = step(p, b)
        losses.append(float(loss))
    return losses


def sharded_grads(
    axes: dict[str, int],
    cfg: BurninConfig,
    params: Optional[Params] = None,
    tokens: Optional[np.ndarray] = None,
    sp_impl: str = "ring",
) -> Params:
    """This rank's gradients of the first sharded step, after the step's
    own reductions (inside a rank), as f32 numpy arrays in the params'
    tree: what the SGD update is given."""
    from ..parallel.mesh import build_mesh

    value_and_grad, p, b = _sharded_setup(
        build_mesh(axes), cfg, params, _full_batch(tokens), sp_impl
    )
    _, grads = value_and_grad(p, b)
    return _rebuild(p, [g.float().cpu().numpy() for g in grads])
