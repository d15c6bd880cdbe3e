"""The gate's inputs, made from the run's seed.

The port's probes fix their own seeds; the benchmark puts these in their
place (``drivers/gate.py`` says how) and hands the same to the reference.
Each input has its own stream, derived from the run's seed and a name, so
one input never shifts another. NumPy and torch are imported where they
are used: the roll's cluster is placed from the seed before either loads
(``drivers/roll.py``).
"""

from __future__ import annotations

import hashlib


def stream(seed: int, name: str) -> int:
    """A 63-bit seed for input ``name`` of run ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def matmul_operands(seed: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """A and B of the matmul probe, standard normal f32 (the port casts
    them to bf16)."""
    import numpy as np

    rng = np.random.default_rng(stream(seed, "matmul"))
    return (rng.standard_normal((size, size), dtype=np.float32),
            rng.standard_normal((size, size), dtype=np.float32))


def attention_operands(seed: int, shape: tuple) -> tuple[np.ndarray, ...]:
    """q, k and v of the flash probe, standard normal f32 of ``shape``
    (b, h, s, d)."""
    import numpy as np

    rng = np.random.default_rng(stream(seed, "attention"))
    return tuple(rng.standard_normal(tuple(shape), dtype=np.float32) for _ in range(3))


def burnin_params(seed: int, vocab: int, d_model: int, d_ff: int, n_layers: int) -> dict:
    """The burn-in's parameters on the CPU, in the port's tree: dense
    weights N(0, 1/d_model) in bf16, norm gains 1 in f32."""
    import torch

    gen = torch.Generator().manual_seed(stream(seed, "burnin.params"))
    scale = d_model**-0.5

    def dense(*shape: int) -> torch.Tensor:
        return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16)

    def ones() -> torch.Tensor:
        return torch.ones(d_model, dtype=torch.float32)

    layers = [
        {"ln1": ones(), "wqkv": dense(d_model, 3 * d_model), "wo": dense(d_model, d_model),
         "ln2": ones(), "w_up": dense(d_model, d_ff), "w_down": dense(d_ff, d_model)}
        for _ in range(n_layers)
    ]
    return {"embed": dense(vocab, d_model), "ln_f": ones(), "layers": layers}


def burnin_tokens(seed: int, vocab: int, batch: int, seq: int) -> np.ndarray:
    """Token ids (batch, seq), int64; the targets are these shifted by one."""
    import numpy as np

    rng = np.random.default_rng(stream(seed, "burnin.tokens"))
    return rng.integers(0, vocab, size=(batch, seq), dtype=np.int64)
