"""The gate's burn-in, plain: a one-block transformer LM, its loss and
SGD steps.

The port's burn-in trains ``steps`` SGD steps of a pre-norm transformer
(RMS norm with eps 1e-6, causal softmax attention, tanh-GELU MLP, the
embedding tied to the output head, mean next-token NLL) and gives the loss
before each step. Its weights are stored in bf16 (an update below half a
bf16 step is lost, as the configuration states), its activations are bf16
and its sums f32. The reference runs the same steps in float64, the
weights stored in bf16 between steps; the control rounds to float8 (e4m3)
where the port rounds to bf16: the stored weights, each product and norm,
the attention's output, the residual stream and the gradients.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _exact(t: torch.Tensor) -> torch.Tensor:
    return t


def _rounding(dtype: torch.dtype):
    def rnd(t: torch.Tensor) -> torch.Tensor:
        # Straight through: the value rounded, the gradient passed unchanged.
        rounded = t.to(dtype).to(t.dtype)
        return t + (rounded - t).detach()

    return rnd


_bf16 = _rounding(torch.bfloat16)
_fp8 = _rounding(torch.float8_e4m3fn)


def _leaves(params: dict) -> list[tuple[str, torch.Tensor]]:
    out = [("embed", params["embed"]), ("ln_f", params["ln_f"])]
    for i, layer in enumerate(params["layers"]):
        out.extend((f"layers.{i}.{k}", layer[k]) for k in sorted(layer))
    return out


def _tree(named: dict, n_layers: int) -> dict:
    return {
        "embed": named["embed"],
        "ln_f": named["ln_f"],
        "layers": [
            {k.split(".", 2)[2]: v for k, v in named.items() if k.startswith(f"layers.{i}.")}
            for i in range(n_layers)
        ],
    }


def _loss(p: dict, tokens: torch.Tensor, n_heads: int, rnd) -> torch.Tensor:
    def norm(x, gain):
        return rnd(x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * gain)

    b, s = tokens.shape
    x = rnd(p["embed"][tokens])
    for layer in p["layers"]:
        d = x.shape[-1]
        hd = d // n_heads
        q, k, v = rnd(norm(x, layer["ln1"]) @ layer["wqkv"]).split(d, dim=-1)
        q, k, v = (t.reshape(b, s, n_heads, hd).transpose(1, 2) for t in (q, k, v))
        scores = (q * hd**-0.5) @ k.transpose(-1, -2)
        keep = torch.ones((s, s), dtype=torch.bool).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
        attn = rnd(torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, s, d)
        x = rnd(x + rnd(attn @ layer["wo"]))
        up = rnd(F.gelu(rnd(norm(x, layer["ln2"]) @ layer["w_up"]), approximate="tanh"))
        x = rnd(x + rnd(up @ layer["w_down"]))
    logits = rnd(norm(x, p["ln_f"]) @ p["embed"].T)
    targets = torch.roll(tokens, -1, dims=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.unsqueeze(-1)).mean()


def losses(params: dict, tokens: np.ndarray, n_heads: int, steps: int = 2,
           lr: float = 1e-2, control: bool = False) -> list[float]:
    """The loss before each of ``steps`` SGD steps from ``params`` (the
    port's tree, on the CPU) on ``tokens``: in float64 with the weights
    stored in bf16, or with ``control`` rounded to float8 where the port
    rounds to bf16."""
    rnd = _fp8 if control else _exact
    store = _fp8 if control else _bf16
    dtype = torch.float64
    # The norm gains are f32 in the port; they stay as they are.
    stored = {name for name, t in _leaves(params) if t.dtype == torch.bfloat16}
    named = {name: t.to(dtype) for name, t in _leaves(params)}
    named = {name: store(t) if name in stored else t for name, t in named.items()}
    toks = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
    out = []
    for _ in range(steps):
        leaves = {name: t.detach().requires_grad_(True) for name, t in named.items()}
        loss = _loss(_tree(leaves, len(params["layers"])), toks, n_heads, rnd)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append(float(loss.detach()))
        with torch.no_grad():
            named = {name: t - lr * rnd(g) for (name, t), g in zip(leaves.items(), grads)}
            named = {name: store(t) if name in stored else t for name, t in named.items()}
    if not all(math.isfinite(v) for v in out):
        raise ValueError(f"reference burn-in losses not finite: {out}")
    return out
