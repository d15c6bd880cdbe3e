"""Ring attention: sequence-parallel attention around a ring of ranks.

The sequence is split over a mesh axis; each rank keeps its queries while
the K/V blocks rotate one hop per step (``batch_isend_irecv``), and each
rank folds every block into its output with a flash-style online softmax.
After n steps every query has attended to the whole sequence, and every
neighbor link has carried n-1 rotations: as a health probe this pushes
payload across every link of the ring, and the result is checked against
the host oracle (:func:`reference_attention`).

The fold is plain PyTorch, as it is plain ``jnp`` in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .probe_harness import (
    ProbeReport,
    host_qkv,
    quantize,
    run_checked_probe,
    run_world_probe,
)

# Finite stand-in for -inf: with -inf a fully masked block would give nan
# through exp(-inf - (-inf)); finite, it underflows to 0. Correctness rests
# on step 0 folding the rank's own K/V block, whose diagonal is never
# masked, so the running max is real before a fully masked block arrives.
_MASKED = -1e30


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Sequence-parallel attention, inside a rank: q/k/v are this rank's
    (batch, heads, seq_local, head_dim) blocks of a sequence split over
    ``axis`` in rank order. Returns this rank's block of the output."""
    from ..parallel.mesh import exchange

    n, my = mesh.shape[axis], mesh.coords[axis]
    s_q, s_k = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    rows = my * s_q + torch.arange(s_q, device=q.device)

    def fold(carry, k_blk, v_blk, src):
        """Fold one K/V block into the online-softmax accumulators."""
        m, l, acc = carry
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float())
        if causal:
            cols = src * s_k + torch.arange(s_k, device=q.device)
            scores = scores.masked_fill(rows[:, None] < cols[None, :], _MASKED)
        new_m = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - new_m[..., None])
        corr = torch.exp(m - new_m)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_blk.float()
        )
        return new_m, l, acc

    m0 = torch.full(q.shape[:3], _MASKED, dtype=torch.float32, device=q.device)
    carry = (m0, torch.zeros_like(m0), torch.zeros_like(qf))
    # Step 0 is the rank's own block: no rotation.
    carry = fold(carry, k, v, my)
    for t in range(1, n):
        # Rotate first, then fold: n-1 rotations in all; a rotation after
        # the last fold would ship every block one extra, unused hop.
        k_next, v_next = torch.empty_like(k), torch.empty_like(v)
        exchange(
            mesh, axis,
            [(k, (my + 1) % n), (v, (my + 1) % n)],
            [(k_next, (my - 1) % n), (v_next, (my - 1) % n)],
        )
        k, v = k_next, v_next
        carry = fold(carry, k, v, (my - t) % n)
    _, l, acc = carry
    return (acc / l[..., None]).to(q.dtype)


def reference_attention(q, k, v, causal: bool = True) -> np.ndarray:
    """Host-side (numpy) attention over the full sequence, in f32: the
    independent oracle the attention probes are checked against."""
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


def seq_block(mesh, axis: str, seq: int) -> tuple:
    """The index of this rank's block of a (b, h, seq, d) array split over
    ``axis``."""
    size = seq // mesh.shape[axis]
    start = mesh.coords[axis] * size
    return (slice(None), slice(None), slice(start, start + size))


def local_blocks(mesh, axis: str, arrays, dtype: torch.dtype) -> tuple:
    """This rank's blocks of full host (b, h, seq, d) arrays, as ``dtype``
    tensors on its device, and the blocks' index in the whole."""
    block = seq_block(mesh, axis, arrays[0].shape[2])
    tensors = tuple(
        torch.from_numpy(np.ascontiguousarray(t[block])).to(dtype).to(mesh.device)
        for t in arrays
    )
    return tensors, block


def _on_host_arrays_rank(attention, axis: str, q, k, v, causal: bool) -> np.ndarray:
    from ..parallel.mesh import single_axis_mesh

    mesh = single_axis_mesh(axis)
    (qb, kb, vb), _ = local_blocks(mesh, axis, (q, k, v), torch.from_numpy(q).dtype)
    return attention(qb, kb, vb, mesh, axis, causal=causal).cpu().numpy()


def on_host_arrays(world, attention, q, k, v, axis: str = "sp",
                   causal: bool = True) -> np.ndarray:
    """Run a sequence-parallel ``attention`` (:func:`ring_attention` or
    ``ulysses.ulysses_attention``) over ``world`` on full host
    (b, h, seq, d) arrays, each rank taking its block of the sequence, and
    return the whole output."""
    parts = world.run(_on_host_arrays_rank, attention, axis, q, k, v, causal)
    return np.concatenate(parts, axis=2)


def _ring_probe_rank(axis: str, batch: int, heads: int, seq_per_device: int,
                     head_dim: int, dtype: torch.dtype, tol: float) -> ProbeReport:
    from ..parallel.mesh import single_axis_mesh

    try:
        mesh = single_axis_mesh(axis)
        seq = seq_per_device * mesh.shape[axis]
        qkv = host_qkv((batch, heads, seq, head_dim), seed=0)
        (q, k, v), block = local_blocks(mesh, axis, qkv, dtype)
        expected = reference_attention(
            *(quantize(t, dtype) for t in qkv), causal=True
        )
        return run_checked_probe(
            "ring attention",
            lambda: ring_attention(q, k, v, mesh, axis, causal=True),
            expected,
            tokens=batch * seq,
            tol=tol,
            index=block,
            mesh=mesh,
            axis=axis,
        )
    except Exception as e:  # noqa: BLE001 - a failed link is a failed probe
        return ProbeReport(ok=False, error=str(e))


def ring_attention_probe(
    world,
    axis: str = "sp",
    *,
    batch: int = 2,
    heads: int = 4,
    seq_per_device: int = 128,
    head_dim: int = 64,
    dtype: torch.dtype = torch.bfloat16,
    tol: float = 2e-2,
) -> ProbeReport:
    """Numerics-checked ring attention across the world's links: every
    neighbor link carries n-1 K/V rotations, and each rank's block of the
    output is compared elementwise with the host oracle on the same
    quantized inputs. A failure is a failed report."""
    return run_world_probe(
        world, _ring_probe_rank, axis, batch, heads, seq_per_device,
        head_dim, dtype, tol,
    )
