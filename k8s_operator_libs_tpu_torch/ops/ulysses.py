"""Ulysses sequence parallelism: an all-to-all head/sequence exchange.

The complement of ``ops.ring_attention``: one ``all_to_all_single`` turns
q/k/v from split by sequence into split by heads, each rank computes plain
full-sequence attention for its heads, and a second one restores the split
by sequence. Two collectives, each moving payload between every pair of
ranks, which makes it the all-to-all probe where the ring probe exercises
neighbor links. It needs the head count divisible by the axis size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .probe_harness import (
    ProbeReport,
    host_qkv,
    quantize,
    run_checked_probe,
    run_world_probe,
)
from .ring_attention import local_blocks, reference_attention


def local_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain causal softmax attention on (b, h, s, d), f32 core."""
    s = q.shape[2]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum(
        "bhqd,bhkd->bhqk", q.float() * scale, k.float()
    )
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk ``i`` of ``t``'s first dim goes to the group's rank ``i``;
    chunk ``i`` of the result came from it."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Sequence-parallel attention by head/sequence all-to-all, inside a
    rank: q/k/v are this rank's (batch, heads, seq_local, head_dim) blocks
    of a sequence split over ``axis`` in rank order; ``heads`` must be
    divisible by the axis size. Returns this rank's block of the output."""
    if not causal:
        raise NotImplementedError("ulysses probe is causal-only")
    n, group = mesh.shape[axis], mesh.groups[axis]
    b, h, s_local, d = q.shape
    if h % n != 0:
        raise ValueError(
            f"ulysses needs per-shard heads ({h}) divisible by mesh axis "
            f"'{axis}' ({n})"
        )

    def seq_to_heads(t: torch.Tensor) -> torch.Tensor:
        # (b, h, s/n, d) -> (b, h/n, s, d): head group i to rank i, and the
        # sequence blocks that come back concatenated in rank order.
        chunks = t.reshape(b, n, h // n, s_local, d).transpose(0, 1).contiguous()
        got = _all_to_all(chunks, group)
        return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s_local, d)

    def heads_to_seq(t: torch.Tensor) -> torch.Tensor:
        # (b, h/n, s, d) -> (b, h, s/n, d): sequence block i to rank i, and
        # the head groups that come back concatenated in rank order.
        chunks = (
            t.reshape(b, h // n, n, s_local, d).permute(2, 0, 1, 3, 4).contiguous()
        )
        got = _all_to_all(chunks, group)
        return got.transpose(0, 1).reshape(b, h, s_local, d)

    out = local_causal_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))
    return heads_to_seq(out)


# Field-compatible alias kept for the public API (tpu.health report types).
UlyssesReport = ProbeReport


def _ulysses_probe_rank(axis: str, batch: int, heads: int, seq_per_device: int,
                        head_dim: int, dtype: torch.dtype, tol: float) -> ProbeReport:
    from ..parallel.mesh import single_axis_mesh

    try:
        mesh = single_axis_mesh(axis)
        n = mesh.shape[axis]
        if heads % n != 0:
            heads = n  # one head per rank keeps the probe runnable
        seq = seq_per_device * n
        qkv = host_qkv((batch, heads, seq, head_dim), seed=1)
        (q, k, v), block = local_blocks(mesh, axis, qkv, dtype)
        expected = reference_attention(
            *(quantize(t, dtype) for t in qkv), causal=True
        )
        return run_checked_probe(
            "ulysses",
            lambda: ulysses_attention(q, k, v, mesh, axis, causal=True),
            expected,
            tokens=batch * seq,
            tol=tol,
            index=block,
            mesh=mesh,
            axis=axis,
        )
    except Exception as e:  # noqa: BLE001 - a failed link is a failed probe
        return ProbeReport(ok=False, error=str(e))


def ulysses_probe(
    world,
    axis: str = "sp",
    *,
    batch: int = 2,
    heads: int = 8,
    seq_per_device: int = 128,
    head_dim: int = 64,
    dtype: torch.dtype = torch.bfloat16,
    tol: float = 2e-2,
) -> ProbeReport:
    """Numerics-checked all-to-all attention across every pair of ranks;
    each rank's block of the output is compared with the host oracle on
    the same quantized inputs. A head count the axis does not divide
    becomes one head per rank. A failure is a failed report."""
    return run_world_probe(
        world, _ulysses_probe_rank, axis, batch, heads, seq_per_device,
        head_dim, dtype, tol,
    )
