"""Burn-in workload: a small transformer LM train step, on one device.

The full-stack half of the post-upgrade health gate: if a freshly upgraded
driver can train this — matmuls, attention, a backward pass and an SGD
update — the node is healthy end to end.

The parameters are a plain dict with the JAX package's tree (``embed``,
``ln_f``, ``layers[i]`` with ``ln1``, ``wqkv``, ``wo``, ``ln2``, ``w_up``,
``w_down``) and its layout, ``x @ W`` with ``W`` shaped (d_in, d_out), so
:func:`params_from_jax` turns the JAX package's parameters into these and
both packages compute the same thing. The sharded step (dp/tp/sp) and the
mixture-of-experts MLP come with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
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


def _attention(layer: Params, x: torch.Tensor, cfg: BurninConfig) -> torch.Tensor:
    b, s, d = x.shape
    q, k, v = (x @ layer["wqkv"]).split(d, dim=-1)

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2).contiguous()

    if cfg.use_flash_attention:
        from ..ops.flash_attention import flash_attention

        out = flash_attention(heads(q), heads(k), heads(v))
    else:
        from ..ops.ulysses import local_causal_attention

        out = local_causal_attention(heads(q), heads(k), heads(v))
    out = out.transpose(1, 2).reshape(b, s, d)
    return out @ layer["wo"]


def _mlp(layer: Params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x @ layer["w_up"], approximate="tanh") @ layer["w_down"]


def forward(params: Params, tokens: torch.Tensor, cfg: BurninConfig) -> torch.Tensor:
    """Token ids (b, s) -> logits (b, s, vocab), in f32."""
    _check_config(cfg)
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = x + _attention(layer, _rms_norm(x, layer["ln1"]), cfg)
        x = x + _mlp(layer, _rms_norm(x, layer["ln2"]))
    x = _rms_norm(x, params["ln_f"])
    return (x @ params["embed"].T).float()


def loss_fn(params: Params, batch: dict[str, torch.Tensor], cfg: BurninConfig) -> torch.Tensor:
    logits = forward(params, batch["tokens"], cfg)
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
