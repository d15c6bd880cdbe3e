"""Ring attention's host oracle.

Only :func:`reference_attention` so far: the independent numpy oracle the
attention probes are checked against. The sequence-parallel ring itself
comes with the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np

from .probe_harness import ProbeReport


def reference_attention(q, k, v, causal: bool = True) -> np.ndarray:
    """Host-side (numpy) attention over the full sequence, in f32."""
    qn = np.asarray(q, dtype=np.float32)
    kn = np.asarray(k, dtype=np.float32)
    vn = np.asarray(v, dtype=np.float32)
    scale = qn.shape[-1] ** -0.5
    scores = np.einsum("bhqd,bhkd->bhqk", qn * scale, kn)
    if causal:
        s = scores.shape[-1]
        mask = np.tril(np.ones((s, s), dtype=bool))
        scores = np.where(mask, scores, -np.inf)
    scores -= scores.max(axis=-1, keepdims=True)
    probs = np.exp(scores)
    probs /= probs.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", probs, vn)


# Field-compatible alias kept for the public API (tpu.health report types).
RingAttentionReport = ProbeReport
