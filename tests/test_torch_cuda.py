"""The port's CUDA kernels on the card, against their plain versions, and
its NCCL worlds.

A CUDA kernel has no CPU mode and NCCL needs cards, so every test here
needs an NVIDIA card (and ``nvcc`` for the kernels); elsewhere each one
skips (decided inside the fixture, never at import). The tests of a world
of two or more cards skip, inside their fixture, on a one-card machine. On
the card:

    python -m pytest tests/test_torch_cuda.py -q

This file imports no JAX, so it runs where only PyTorch is installed. The
GPU node roll (``-k roll``) drives the JAX package's in-memory cluster,
rolled by the JAX package's state machine and by the port's; the
monitor's cycle drives that cluster too. Their control plane imports no
JAX either (``tests/test_torch_roll.py``). The slice gang runs as one pod on
every card (``-k gang``) and, with two or more cards, as two pods on half
the cards each (``-k between_cards``). The requestor roll (``-k
requestor``) runs the post-maintenance warm-up hook on the card in this
process. The checkpoint roll's trainer (``-k trainer``) saves, restores
and trains again the flagship model on the card. The NodeHealthReport
informer over ``chip_smoke.py``'s ``DictClient`` (``-k informer``) sees the
report of a monitor cycle that ran the card's payload. The payload publishes
its report to the port's own API server (``-k publishes``).
"""

import ctypes
import importlib.util
import json
import math
import os
import time
from pathlib import Path

import pytest
import torch

from k8s_operator_libs_tpu_torch import entry as port_entry
from k8s_operator_libs_tpu_torch.models import burnin
from k8s_operator_libs_tpu_torch.ops import collectives
from k8s_operator_libs_tpu_torch.ops import matmul as matmul_mod
from k8s_operator_libs_tpu_torch.ops import _build
from k8s_operator_libs_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_probe,
    flash_attention_reference,
    flash_path,
    split_plan,
    wgmma_plan,
)
from k8s_operator_libs_tpu_torch.ops.matmul import (
    matmul,
    matmul_path,
    matmul_reference,
    mxu_probe,
)
from k8s_operator_libs_tpu_torch.ops.probe_harness import quick_battery
from k8s_operator_libs_tpu_torch.ops import ring_attention as ring_mod
from k8s_operator_libs_tpu_torch.ops.ring_attention import ring_attention_probe
from k8s_operator_libs_tpu_torch.ops.ulysses import ulysses_attention, ulysses_probe
from k8s_operator_libs_tpu_torch.parallel.mesh import World
from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate

pytestmark = pytest.mark.cuda

#: Kernel vs plain flash attention: P is rounded to bf16 before P.V and
#: both round the output to bf16 (one bf16 step, 2^-7 relative, apart).
FLASH_ATOL, FLASH_RTOL = 2e-2, 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


@pytest.mark.parametrize(
    "m,k,n,path",
    [
        (1, 1, 1, "wmma_masked"),
        (300, 200, 130, "wmma_masked"),
        (129, 77, 257, "wmma_masked"),
        (128, 1024, 128, "wgmma_128x64"),
        (200, 72, 136, "wgmma_128x64"),
        (1024, 1024, 1024, "wgmma_128x64"),
        (1000, 136, 2056, "wgmma_128x256"),
        (2048, 2048, 2048, "wgmma_128x256"),
    ],
)
def test_matmul_matches_plain_version(cuda, m, k, n, path):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _randn((m, k), gen, cuda), _randn((k, n), gen, cuda)
    assert matmul_path(a, b) == path
    before, before_path = matmul.launches, matmul.path_launches[path]
    got = matmul(a, b)
    assert matmul.launches == before + 1
    assert matmul.path_launches[path] == before_path + 1
    want = matmul_reference(a, b)
    torch.cuda.synchronize()
    # bf16 products are exact in f32; only the summation order differs.
    assert float((got - want).abs().max()) <= 1e-3 * math.sqrt(k)


def test_matmul_takes_unaligned_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    flat = _randn((64 * 64 + 1,), gen, cuda)
    a = flat[1:].view(64, 64)  # 2 bytes past a 16-byte boundary
    b = _randn((64, 64), gen, cuda)
    assert matmul_path(a, b) == "wmma_masked"
    got = matmul(a, b)
    assert float((got - matmul_reference(a, b)).abs().max()) <= 1e-3 * 8


def test_matmul_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(16, 16, device=cuda)
    with pytest.raises(TypeError):
        matmul(x, x)
    y = torch.zeros(16, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        matmul(y.t(), y)


@pytest.mark.parametrize(
    "shape,split",
    [
        ((1, 4, 1024, 128), True),
        ((2, 3, 100, 128), False),
        ((1, 1, 1, 128), False),
        ((1, 2, 200, 128), False),
        ((1, 2, 1000, 16), True),
        ((1, 2, 1000, 32), True),
        ((1, 2, 1000, 64), True),
        ((1, 2, 1000, 128), True),
        ((2, 4, 77, 16), False),
        ((8, 4, 128, 32), False),
        ((2, 4, 77, 64), False),
        ((1, 4, 1024, 64), True),
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_plain_version(cuda, shape, split, causal):
    b, h, s, _ = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (split_plan(b * h, s, causal, sms)[0] > 0) == split
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (_randn(shape, gen, cuda) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal).float()
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    excess = (got - want).abs() - (FLASH_ATOL + FLASH_RTOL * want.abs())
    assert float(excess.max()) <= 0


def test_flash_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 1, 64, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q)
    f = torch.zeros(1, 1, 64, 128, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(f, f, f)
    g = torch.zeros(1, 1, 64, 128, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attention(g, g, g)


def _flash_ok(got, q, k, v, causal):
    want = flash_attention_reference(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    excess = (got.float() - want).abs() - (FLASH_ATOL + FLASH_RTOL * want.abs())
    return float(excess.max()) <= 0


@pytest.mark.parametrize(
    "shape,split",
    [
        ((1, 1, 1, 0), False),
        ((2, 3, 77, 0), False),
        ((1, 2, 100, 0), False),
        ((1, 2, 128, 0), False),
        ((2, 2, 129, 0), False),
        ((1, 2, 1000, 0), True),
        ((1, 4, 1024, 0), True),
        ((8, 4, 1024, 0), False),
        ((1, 2, 4096, 0), True),
        ((2, 16, 4096, 0), False),
    ],
)
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_family_matches_plain_version(cuda, shape, split, head_dim, causal):
    """The wgmma family through the wrapper: ragged and whole tiles, one
    row to 4096, one head to 32, the plan splitting the K/V ranges or not."""
    b, h, s, _ = shape
    shape = (b, h, s, head_dim)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (wgmma_plan(b * h, s, head_dim, causal, sms)[0] > 0) == split
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (_randn(shape, gen, cuda) for _ in range(3))
    assert flash_path(q, k, v, causal) == ("wgmma_split" if split else "wgmma")
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert _flash_ok(got, q, k, v, causal)


@pytest.mark.parametrize("shape", [(1, 4, 1024, 128), (1, 2, 1000, 64), (3, 1, 700, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_family_at_every_split(cuda, shape, causal):
    """The C entry at splits the plan would not pick, down to one tile a
    chunk and up to one chunk a range: each agrees with the plain version."""
    b, h, s, d = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (_randn(shape, gen, cuda) for _ in range(3))
    lib = _build.load("flash_attention")
    for split in (0, 1, 2, 3, 8):
        elems = ctypes.c_longlong()
        _build.check(lib, lib.k2_wgmma_scratch_elems(b * h, s, d, split, ctypes.byref(elems)),
                     "scratch")
        scratch = torch.empty(max(1, elems.value), dtype=torch.float32, device=cuda)
        out = torch.empty_like(q)
        rc = lib.k2_flash_attention_wgmma_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b * h, s, d, int(causal), split, _build.stream_handle(q))
        _build.check(lib, rc, "wgmma flash launch")
        assert _flash_ok(out, q, k, v, causal), split


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_misaligned_view_takes_the_mma_sync_family(cuda, head_dim):
    """q two bytes past a 16-byte boundary (storage_offset 1, not a multiple
    of 8 elements): TMA cannot describe it, so the call takes the first
    family, whose ``cp.async`` cannot read it either: the wrapper hands it
    an aligned copy, and the result matches."""
    shape = (1, 2, 300, head_dim)
    gen = torch.Generator(device=cuda).manual_seed(head_dim)
    flat = _randn((math.prod(shape) + 1,), gen, cuda)
    q = flat[1:].view(shape)
    k, v = (_randn(shape, gen, cuda) for _ in range(2))
    assert q.is_contiguous() and q.storage_offset() % 8 != 0
    assert flash_path(q, k, v, True).startswith("mma_sync")
    assert flash_path(k, k, v, True).startswith("wgmma" if head_dim >= 64 else "mma_sync")
    got = flash_attention(q, k, v, causal=True)
    assert _flash_ok(got, q, k, v, True)


@pytest.mark.parametrize("shape", [(1, 4, 1024, 128), (2, 16, 512, 64), (8, 4, 128, 32)])
def test_flash_graph_replay_equals_eager(cuda, shape):
    """A call captured into a CUDA graph (tensor maps and all) replays to the
    eager call's output, bit for bit, and the capture counts no launch."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (_randn(shape, gen, cuda) for _ in range(3))
    eager = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = flash_attention.launches
    with torch.cuda.graph(graph):
        captured = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.parametrize(
    "bh,seq,head_dim",
    [(4, 1024, 128), (4, 1024, 64), (2, 1000, 128), (1, 4096, 64), (32, 4096, 128), (1, 1, 64)],
)
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_scratch_is_the_plans(cuda, bh, seq, head_dim, causal):
    """``k2_wgmma_scratch_elems`` at the plan's split asks for what
    ``wgmma_plan`` says."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split, _, scratch = wgmma_plan(bh, seq, head_dim, causal, sms)
    lib = _build.load("flash_attention")
    elems = ctypes.c_longlong()
    _build.check(lib, lib.k2_wgmma_scratch_elems(bh, seq, head_dim, split, ctypes.byref(elems)),
                 "scratch")
    assert elems.value == scratch


def test_burnin_step_on_card_matches_cpu(cuda):
    cfg = burnin.BurninConfig(d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32, batch=2)
    losses = {}
    for dev in ("cpu", cuda):
        params = burnin.init_params(torch.Generator().manual_seed(0), cfg, dev)
        batch = burnin.synthetic_batch(torch.Generator().manual_seed(1), cfg, dev)
        params, l1 = burnin.train_step(params, batch, cfg)
        _, l2 = burnin.train_step(params, batch, cfg)
        losses[str(dev)] = (float(l1), float(l2))
    (c1, c2), (g1, g2) = losses["cpu"], losses["cuda"]
    assert g2 < g1 and c2 < c1
    # bf16 rounds at other places on the two devices.
    assert g1 == pytest.approx(c1, rel=5e-3) and g2 == pytest.approx(c2, rel=5e-3)


def test_burnin_flash_forward_on_card_matches_plain_core(cuda):
    """``BurninConfig()`` width (head_dim 32) with the flash core: the
    forward runs through the kernel, once a layer."""
    cfg = burnin.BurninConfig(use_flash_attention=True)
    plain_cfg = burnin.BurninConfig()
    params = burnin.init_params(torch.Generator().manual_seed(0), cfg, cuda)
    batch = burnin.synthetic_batch(torch.Generator().manual_seed(1), cfg, cuda)
    before = flash_attention.launches
    got = burnin.forward(params, batch["tokens"], cfg)
    assert flash_attention.launches == before + cfg.n_layers
    want = burnin.forward(params, batch["tokens"], plain_cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # The two cores round their bf16 outputs at different places (P is bf16
    # in the kernel); one bf16 step of difference there reaches the logits
    # through the bf16 residual stream.
    excess = (got - want).abs() - (5e-2 + 2e-2 * want.abs())
    assert float(excess.max()) <= 0
    with pytest.raises(NotImplementedError, match="forward-only"):
        burnin.train_step(params, batch, cfg)


def test_entry_forward_on_the_card(cuda):
    fn, (params, tokens) = port_entry.entry()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    assert logits.device.type == "cuda" and tuple(logits.shape) == (4, 256, 1024)
    assert torch.isfinite(logits).all()


def test_moe_step_on_card_matches_cpu(cuda):
    cfg = burnin.BurninConfig(
        d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32, batch=2, n_experts=4,
    )
    losses = {}
    for dev in ("cpu", cuda):
        params = burnin.init_params(torch.Generator().manual_seed(0), cfg, dev)
        batch = burnin.synthetic_batch(torch.Generator().manual_seed(1), cfg, dev)
        params, l1 = burnin.train_step(params, batch, cfg)
        _, l2 = burnin.train_step(params, batch, cfg)
        losses[str(dev)] = (float(l1), float(l2))
    (c1, c2), (g1, g2) = losses["cpu"], losses["cuda"]
    assert g2 < g1 and c2 < c1
    assert g1 == pytest.approx(c1, rel=5e-3) and g2 == pytest.approx(c2, rel=5e-3)


def test_dryrun_multichip_on_one_card(cuda, capsys):
    world = World(["cuda:0"])
    try:
        (result,) = port_entry.dryrun_multichip(world)
    finally:
        world.close()
    assert result["mesh"] == {"dp": 1, "ep": 1, "tp": 1, "sp": 1}
    assert math.isfinite(result["loss"])
    assert capsys.readouterr().out.strip().endswith("ok")


def test_probe_chain_is_one_graph_replay(cuda):
    size, iters = 1024, 3
    chain = matmul_mod._auto_chain(size, True)
    for _ in range(2):  # the first probe captures the chain, the second reuses it
        before = matmul.launches
        report = mxu_probe(size=size, iters=iters, device=cuda)
        assert report.ok, report.error
        assert report.tflops > 0
        assert matmul.launches - before == 1 + (iters + 1) * chain
    entry = matmul_mod._probe_entry(size, torch.bfloat16, cuda)
    assert sum(entry.chains[(chain, True)].launches.values()) == chain


def test_plain_probe_chain_is_one_graph_replay(cuda):
    """The quick battery's plain 256^2 chain is captured too, so its rate is
    the card's: the plain product launches no kernel of ours."""
    size = 256
    chain = matmul_mod._auto_chain(size, True)
    before = matmul.launches
    report = mxu_probe(size=size, use_pallas=False, device=cuda)
    assert report.ok, report.error
    assert matmul.launches == before
    entry = matmul_mod._probe_entry(size, torch.bfloat16, cuda)
    assert (chain, False) in entry.chains
    assert not entry.chains[(chain, False)].launches


def test_gate_on_card_launches_both_kernels(cuda):
    matmul.launches = flash_attention.launches = 0
    report = IciHealthGate.tpu_defaults(device=cuda, matmul_size=256).run()
    assert report.ok, report.failures
    assert matmul.launches == 1 + 4 * matmul_mod._auto_chain(256, True)
    assert flash_attention.launches == 4


def test_flash_probe_rate_is_timed_on_the_card_clock(cuda, monkeypatch):
    from k8s_operator_libs_tpu_torch.ops import probe_harness

    class NoHostClock:
        @staticmethod
        def perf_counter():
            raise AssertionError("the probe timed a call on the card with the host clock")

    monkeypatch.setattr(probe_harness, "time", NoHostClock)
    report = flash_attention_probe(device=cuda)
    assert report.ok, report.error
    assert 0 < report.elapsed_s < 1 and report.tokens_per_s == 1024 / report.elapsed_s


def test_flash_probe_takes_its_second_oracle_from_the_cache(cuda, monkeypatch):
    import numpy as np

    from k8s_operator_libs_tpu_torch.ops import flash_attention as flash_mod
    from k8s_operator_libs_tpu_torch.ops.probe_harness import host_qkv, quantize
    from k8s_operator_libs_tpu_torch.ops.ring_attention import reference_attention

    cache = {}
    monkeypatch.setattr(flash_mod, "_ORACLE_CACHE", cache)
    first = flash_attention_probe(device=cuda)
    hits = flash_attention_probe.oracle_hits
    second = flash_attention_probe(device=cuda)
    assert first.ok, first.error
    assert second.ok, second.error
    assert flash_attention_probe.oracle_hits == hits + 1
    (entry,) = cache.values()
    fresh = reference_attention(
        *(quantize(t, torch.bfloat16) for t in host_qkv((1, 4, 1024, 128), seed=2)),
        causal=True,
    )
    assert np.array_equal(entry.expected, fresh)


def test_calibration_line_on_the_cards(cuda):
    from k8s_operator_libs_tpu_torch.tools.calibration import run_calibration

    line = run_calibration()
    assert line["platform"] == "gpu"
    assert line["n_devices"] == torch.cuda.device_count()
    assert line["ok"], line["failures"]
    assert line["matmul_kernel_launched"] is True
    assert line["flash_attention_ok"] is True
    assert line["kernel_vs_torch_matmul"] > 0


# ----------------------------------------------------------------------
# NCCL worlds.
# ----------------------------------------------------------------------

BATTERY_OPS = ["psum", "all_gather", "reduce_scatter", "ppermute_ring"]


@pytest.fixture(scope="module")
def one_card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL runs between cards")
    world = World(["cuda:0"])
    yield world
    world.close()


@pytest.fixture(scope="module")
def cards_world():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards: links run between cards")
    world = World([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    yield world
    world.close()


def test_nccl_battery_on_one_card(one_card_world):
    assert one_card_world.backend == "nccl"
    reports = collectives.run_ici_probes(one_card_world)
    assert [r.op for r in reports] == BATTERY_OPS
    assert all(r.ok for r in reports), [r.error for r in reports]
    assert reports[-1].error == "single device"
    assert collectives.slice_agreement(one_card_world, "x", True) == (1, 1)


def test_quick_battery_on_one_card(one_card_world):
    report = quick_battery(one_card_world)
    assert report.ok, report.error
    assert report.checks == {"ring_allreduce": True, "mxu": True}
    assert {"mxu_tflops", "probe_latency_s"} <= set(report.metrics)
    assert report.links is None


def test_gate_collectives_on_one_card(cuda):
    gate = IciHealthGate.tpu_defaults(devices=["cuda:0"], matmul_size=256)
    try:
        first, warm = gate.run(), gate.run()
    finally:
        gate.close()
    for report in (first, warm):
        assert report.ok, report.failures
        assert [c.op for c in report.collectives] == BATTERY_OPS
        assert report.burnin_ok is True and report.links == []
    assert warm.elapsed_s < first.elapsed_s


def test_links_between_cards(cards_world):
    hops = collectives.ppermute_per_link(cards_world, payload_mb=1.0)
    n = cards_world.size
    assert [(h.src, h.dst) for h in hops] == [(i, (i + 1) % n) for i in range(n)]
    assert all(h.ok and h.gbytes_per_s > 0 for h in hops), [h.error for h in hops]
    assert collectives.psum_bandwidth(cards_world).ok


def test_sharded_burnin_between_cards(cards_world):
    n = cards_world.size
    tp = 2 if n % 2 == 0 else 1
    cfg = burnin.BurninConfig(
        d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32,
        batch=max(2, (n // tp) * 2),
    )
    per_rank = cards_world.run(burnin.sharded_losses, {"dp": n // tp, "tp": tp}, cfg)
    l1, l2 = per_rank[0]
    assert all(losses == per_rank[0] for losses in per_rank)
    assert math.isfinite(l1) and l2 < l1


def test_seq_parallel_probes_between_cards(cards_world):
    for probe in (ring_attention_probe, ulysses_probe):
        report = probe(cards_world, "x", seq_per_device=64, head_dim=32)
        assert report.ok and report.tokens_per_s > 0, report.error


def test_dryrun_multichip_between_cards(cards_world):
    results = port_entry.dryrun_multichip(cards_world, steps=2)
    programs = port_entry.dryrun_programs(cards_world.size)
    assert [r["mesh"] for r in results] == [p["axes"] for p in programs]
    for result in results:
        assert all(math.isfinite(x) for x in result["losses"]), result


@pytest.mark.parametrize("axis", ["sp-ring", "sp-ulysses", "ep"])
def test_sequence_and_expert_steps_between_cards_match_one_card(cards_world, axis):
    """Half the cards on dp, two on sp or ep: the first loss is the
    unsharded step's on one card, and the loss falls."""
    dp = cards_world.size // 2
    name, _, sp_impl = axis.partition("-")
    cfg = burnin.BurninConfig(
        d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32, batch=2 * dp, n_experts=2,
    )
    one = burnin.train_step(
        burnin.init_params(torch.Generator().manual_seed(0), cfg, "cuda"),
        burnin.synthetic_batch(torch.Generator().manual_seed(1), cfg, "cuda"), cfg,
    )[1]
    per_rank = cards_world.run(
        burnin.sharded_losses, {"dp": dp, name: 2}, cfg, 2, None, None, sp_impl or "ring"
    )
    l1, l2 = per_rank[0]
    assert all(losses == per_rank[0] for losses in per_rank)
    assert l1 == pytest.approx(float(one), rel=2e-2) and l2 < l1


def _plain_attention_grads(q, k, v, dout):
    """dq, dk, dv of plain causal attention over the whole sequence, f32
    on the CPU."""
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
    s = scores.shape[-1]
    scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", scores.softmax(-1), v)
    return torch.autograd.grad(out, (q, k, v), torch.from_numpy(dout))


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_sequence_parallel_gradients_between_cards(cards_world, attention):
    import numpy as np

    n = cards_world.size
    rng = np.random.default_rng(0)
    q, k, v, dout = (
        rng.standard_normal((2, 2 * n, 16 * n, 32), dtype=np.float32) for _ in range(4)
    )
    fn = ring_mod.ring_attention if attention == "ring" else ulysses_attention
    got = ring_mod.grads_on_host_arrays(cards_world, fn, q, k, v, dout, axis="sp")
    for ours, theirs in zip(got, _plain_attention_grads(q, k, v, dout)):
        np.testing.assert_allclose(ours, theirs.numpy(), atol=1e-4, rtol=0)


def test_gate_between_cards(cards_world):
    gate = IciHealthGate.tpu_defaults(matmul_size=256)
    try:
        report = gate.run()
    finally:
        gate.close()
    assert report.ok, report.failures
    assert len(report.links) == torch.cuda.device_count()
    assert report.ring_attention.ok and report.ulysses.ok and report.burnin_ok


def test_gpu_node_roll_on_the_card(cuda, tmp_path):
    """One GPU node, labelled from the card's own facts, rolled to a new
    driver by the JAX package's state machine; the probe pod's payload runs
    on the card with a fresh kernel cache (so ``nvcc`` runs inside the pod)
    and lets the node back in."""
    _roll_one_node_on_the_card(tmp_path, "jax")


def test_gpu_node_roll_on_the_card_through_the_port_machine(cuda, tmp_path):
    """The same roll by the port's own state machine: the node reaches
    ``upgrade-done`` and the payload launched K1 and K2 on the card."""
    _roll_one_node_on_the_card(tmp_path, "port")


def _roll_one_node_on_the_card(tmp_path, machine):
    from test_torch_roll import NS, GpuRoll

    from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    env[KERNEL_DIR_ENV] = str(tmp_path / "kernel-cache")
    spec = ValidationPodSpec(tpu_chips=torch.cuda.device_count())
    with GpuRoll(spec, {"gpu-0": local_gpu_labels()}, tmp_path, env=env,
                 extra_args=[], payload_timeout_s=600.0, machine=machine) as roll:
        done = roll.drive(GpuRoll.all_done, 600.0)
        states = roll.states()
        history = dict(roll.executor.history)
    assert done, states
    assert states == {"gpu-0": "upgrade-done"}
    assert not roll.node("gpu-0").unschedulable
    assert history == {roll.pod_name("gpu-0"): True}
    report = HealthReport.from_dict(roll.report("gpu-0"))
    assert report.ok, report.failures
    assert report.mxu.ok and report.mxu.tflops > 0
    assert report.flash is not None and report.flash.ok
    kernels = roll.kernel_line("gpu-0")
    assert kernels["launches"]["matmul"] > 0 and kernels["launches"]["flash_attention"] > 0
    assert all(kernels["build_s"][lib] > 0 for lib in ("matmul", "flash_attention"))
    assert sorted(p.name.split("-")[0] for p in (tmp_path / "kernel-cache").glob("*.so")) == [
        "flash_attention", "matmul",
    ]
    assert not roll.cluster.list("Pod", namespace=NS, label_selector=spec.pod_selector)


def test_requestor_roll_with_the_warmup_hook_on_the_card(cuda, tmp_path):
    """One GPU node rolled by the port's machine in the requestor mode: the
    maintenance operator's stand-in cordons and drains it, the
    post-maintenance hook runs the gate on the card in this process (both
    kernels launched), the probe pod's payload validates it, and the
    operator's finalizer uncordons it once the requestor released its
    NodeMaintenance."""
    from test_torch_roll import NS, GpuRoll

    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.kube.sim import MaintenanceOperatorSimulator
    from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.health import cache_warmup_hook
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec
    from k8s_operator_libs_tpu_torch.upgrade import RequestorOptions, enable_requestor_mode

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    env[KERNEL_DIR_ENV] = str(tmp_path / "kernel-cache")
    spec = ValidationPodSpec(tpu_chips=torch.cuda.device_count())
    gate = IciHealthGate.tpu_defaults(device=cuda, matmul_size=256)
    warmup = cache_warmup_hook(gate)
    calls = []

    def hook(node):
        before = (matmul.launches, flash_attention.launches)
        done = warmup(node)
        calls.append((node.name, Node(node.raw).unschedulable,
                      matmul.launches - before[0], flash_attention.launches - before[1]))
        return done

    try:
        with GpuRoll(spec, {"gpu-0": local_gpu_labels()}, tmp_path, env=env,
                     extra_args=[], payload_timeout_s=600.0, machine="port") as roll:
            enable_requestor_mode(roll.mgr, RequestorOptions(
                use_maintenance_operator=True, use_post_maintenance=True, namespace=NS,
                post_maintenance_hook=hook,
            ))
            operator = MaintenanceOperatorSimulator(roll.cluster, namespace=NS)
            seen = set()

            def finished(r) -> bool:
                operator.step()
                seen.update(s for s in r.states().values() if s)
                return (GpuRoll.all_done(r) and not r.node("gpu-0").unschedulable
                        and not r.cluster.list("NodeMaintenance", namespace=NS))

            done = roll.drive(finished, 600.0)
            states = roll.states()
            kernels = roll.kernel_line("gpu-0")
    finally:
        gate.close()
    assert done, states
    assert {"node-maintenance-required", "post-maintenance-required", "upgrade-done"} <= seen
    ((name, cordoned, k1, k2),) = calls
    assert name == "gpu-0" and cordoned and k1 > 0 and k2 > 0
    assert kernels["launches"]["matmul"] > 0 and kernels["launches"]["flash_attention"] > 0


def test_one_pool_fleet_roll_on_the_card(cuda, tmp_path):
    """One GPU pool (one node, labelled from the card's facts) rolled by a
    fleet ``ShardWorker`` over the port's machine under a FleetRollout's
    grant; the probe pod's payload runs the gate on the card, and the pool
    is reported done in the ledger."""
    from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    env[KERNEL_DIR_ENV] = str(tmp_path / "kernel-cache")
    kernels = fleet_roll_one_pool(tmp_path, env, extra_args=[],
                                  tpu_chips=torch.cuda.device_count())
    assert kernels["launches"]["matmul"] > 0 and kernels["launches"]["flash_attention"] > 0


def test_one_node_roll_through_a_relay_on_the_card(cuda, tmp_path):
    """One GPU node rolled by the port's ``upgrade_controller`` command
    (``--watch --validation-pod``) whose informers watch through a port
    ``WatchRelay`` over the JAX ``LocalApiServer``: the probe pod's payload
    runs on the card (K1 launched), the node is let back in, and every
    watch of the command went through the relay."""
    import signal
    import subprocess
    import sys
    import threading

    from test_torch_roll import NS, GpuRoll

    from k8s_operator_libs_tpu.kube import LocalApiServer
    from k8s_operator_libs_tpu_torch.kube.relay import WatchRelay
    from k8s_operator_libs_tpu_torch.kube.rest import RestConfig
    from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    env[KERNEL_DIR_ENV] = str(tmp_path / "kernel-cache")
    spec = ValidationPodSpec(tpu_chips=torch.cuda.device_count())
    with GpuRoll(spec, {"gpu-0": local_gpu_labels()}, tmp_path, env=env, extra_args=[],
                 payload_timeout_s=600.0, machine="port") as roll, \
            LocalApiServer(cluster=roll.cluster) as server:
        relay = WatchRelay(RestConfig(server=server.url)).start()
        policy = tmp_path / "policy.json"
        policy.write_text(json.dumps({"autoUpgrade": True, "maxParallelUpgrades": 1,
                                      "maxUnavailable": "100%"}))
        stats = tmp_path / "stats.json"
        env["KUBECONFIG"] = server.write_kubeconfig(str(tmp_path / "kubeconfig"))
        selector = ",".join(f"{k}={v}" for k, v in roll.installer.match_labels.items())
        proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller", "--watch",
             "--interval", "600", "--validation-pod", "--namespace", NS, "--selector", selector,
             "--policy", str(policy), "--watch-relay", relay.url, "--stats-json", str(stats)],
            cwd=str(repo), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        output: list = []
        drainer = threading.Thread(target=lambda: output.extend(proc.stdout), daemon=True)
        drainer.start()
        try:
            deadline = time.monotonic() + 600
            while not (roll.states() == {"gpu-0": "upgrade-done"}
                       and not roll.node("gpu-0").unschedulable
                       and roll.sim.all_pods_ready_and_current()):
                assert time.monotonic() < deadline, (roll.states(), "".join(output[-40:]))
                assert proc.poll() is None, "".join(output[-40:])
                roll.sim.step()
                roll.pods.step()
                time.sleep(0.2)
            relay_stats = relay.stats()
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0, "".join(output[-40:])
        finally:
            if proc.poll() is None:
                proc.kill()
            relay.stop()
            drainer.join(timeout=10)
        (pod_name,) = roll.executor.history
        assert roll.executor.history[pod_name]
        kernels = roll.kernel_line("gpu-0")
    assert kernels["launches"]["matmul"] > 0
    assert relay_stats["streams_total"] >= 4 and relay_stats["frames_fanned_out"] > 0
    scopes = relay_stats["hub"]["scopes"].values()
    assert all(scope["upstream_watches_opened"] == 1 for scope in scopes)
    recorded = json.loads(stats.read_text())
    assert recorded["relay"]["fallbacks_to_direct"] == 0
    assert recorded["transport"]["server_speaks_compact"]


def fleet_roll_one_pool(tmp_path, env, extra_args, tpu_chips=1) -> dict:
    """The pool ``gpu-fleet`` rolled by a ShardWorker and a FleetOrchestrator
    ticked in turn; the probe pod's kernels line."""
    from test_torch_roll import NS, GpuRoll

    from k8s_operator_libs_tpu.kube.objects import KubeObject
    from k8s_operator_libs_tpu_torch.api import make_fleet_rollout, pool_phase
    from k8s_operator_libs_tpu_torch.fleet import (
        FleetOrchestrator,
        FleetWorkerConfig,
        ShardWorker,
    )
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec

    spec = ValidationPodSpec(tpu_chips=tpu_chips)
    with GpuRoll(spec, {"gpu-fleet-h0": local_gpu_labels()}, tmp_path, env=env,
                 extra_args=extra_args, payload_timeout_s=600.0, machine="port") as roll:
        roll.cluster.create(KubeObject(make_fleet_rollout("roll", ["gpu-fleet"], 1)))
        worker = ShardWorker(roll.cluster, FleetWorkerConfig(
            identity="w", shards=1, namespace=NS, driver_labels=roll.installer.match_labels,
            pool_of=lambda name: name.rsplit("-", 1)[0], rollout_name="roll",
            lease_namespace=NS,
        ), manager=roll.mgr).start()
        orchestrator = FleetOrchestrator(roll.cluster, "roll")
        try:
            deadline = time.monotonic() + 600
            while pool_phase(roll.cluster.get("FleetRollout", "roll").raw, "gpu-fleet") != "done":
                assert time.monotonic() < deadline, roll.states()
                roll.sim.step()
                roll.pods.step()
                orchestrator.tick()
                worker.tick(roll.policy)
                roll.sim.step()
                time.sleep(0.5)
            passes = worker.passes
        finally:
            worker.stop()
        history = dict(roll.executor.history)
        assert roll.states() == {"gpu-fleet-h0": "upgrade-done"}
        assert not roll.node("gpu-fleet-h0").unschedulable
        assert roll.sim.all_pods_ready_and_current()
        assert history == {roll.pod_name("gpu-fleet-h0"): True}
        assert orchestrator.grant_order == ["gpu-fleet"] and worker.pools_reported_done == 1
        assert passes > 0 and roll.cluster.get("Lease", "fleet-shard-00", NS).holder_identity == ""
        report = HealthReport.from_dict(roll.report("gpu-fleet-h0"))
        assert report.ok, report.failures
        return roll.kernel_line("gpu-fleet-h0")


def chip_smoke_module():
    """``chip_smoke.py`` as a module, loaded once."""
    import sys

    name = "chip_smoke_for_tests"
    if name not in sys.modules:
        path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def save_restore_replay(device, cfg, directory):
    """``chip_smoke.py``'s ``Trainer`` behind one simulated training pod:
    the pod made and three steps, a checkpoint asked for and acked at step
    4, two steps more, the pod evicted, made again from step 4 and trained
    on to step 7. The simulator and the trainer."""
    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.kube.sim import CheckpointingWorkloadSimulator
    from k8s_operator_libs_tpu_torch.upgrade import DeviceClass, UpgradeKeys

    smoke = chip_smoke_module()
    keys = UpgradeKeys(DeviceClass.nvidia("gpu"))
    client = smoke.DictClient()
    client.create(Node.new("node-0"))
    workload = CheckpointingWorkloadSimulator(client, keys, namespace=smoke.TRAINING_NS,
                                              name="trainer")
    trainer = smoke.Trainer(client, workload, keys, cfg, device, seed=7,
                            directory=str(directory), nodes=["node-0"])
    pod = workload.workload("node-0").pod_name

    def tick(n: int) -> None:
        for _ in range(n):
            workload.step()
            trainer.sync()

    tick(4)
    client.patch("Pod", pod, smoke.TRAINING_NS, patch={"metadata": {"annotations": {
        keys.checkpoint_request_annotation: "1"}}})
    tick(3)
    client.delete("Pod", pod, smoke.TRAINING_NS)
    tick(4)
    return workload, trainer


def check_save_restore_replay(workload, trainer) -> None:
    assert workload.lost_steps() == trainer.retrained() == 2
    assert workload.total_steps() == 7
    (restore,) = trainer.restores
    assert (restore["restored_step"], restore["stopped_at"]) == (4, 6)
    assert restore["params_equal"], restore
    assert restore["first_loss"] == restore["loss_at_save"] == restore["loss_before_eviction"]
    assert len(trainer.save_s) == len(trainer.load_s) == 1


def test_trainer_saves_restores_and_replays_on_the_card(cuda, tmp_path):
    """The checkpoint roll's trainer at the flagship width on the card:
    the parameters loaded at the restore equal those saved, and the first
    loss after it equals the loss of that step before the eviction."""
    workload, trainer = save_restore_replay("cuda", port_entry.ENTRY_CFG, tmp_path)
    check_save_restore_replay(workload, trainer)


# ----------------------------------------------------------------------
# The monitor and the slice gang on the card.
# ----------------------------------------------------------------------

def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _payload_env(**extra):
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env, str(repo)


def test_monitor_cycle_on_the_card(cuda):
    """One monitor cycle whose subprocess gate runs the card's payload with
    both kernels: the condition, the Event and the NodeHealthReport."""
    from k8s_operator_libs_tpu_torch.kube.events import EventRecorder
    from k8s_operator_libs_tpu_torch.kube.fake import FakeCluster
    from k8s_operator_libs_tpu_torch.kube.objects import Node, condition_status
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.health import SubprocessHealthGate
    from k8s_operator_libs_tpu_torch.tpu.monitor import (
        ICI_HEALTHY_CONDITION,
        ReportPublisher,
        TpuHealthMonitor,
    )

    cluster = FakeCluster()
    node = Node.new("gpu-0", labels=local_gpu_labels())
    node.set_ready(True)
    cluster.create(node)
    env, repo = _payload_env()
    gate = SubprocessHealthGate(
        cli_args=IciHealthGate.tpu_defaults(matmul_size=512).to_cli_args(),
        timeout_seconds=600, env=env, cwd=repo,
    )
    monitor = TpuHealthMonitor(
        cluster, "gpu-0", gate=gate, failure_threshold=1, success_threshold=1,
        recorder=EventRecorder(cluster), report_publisher=ReportPublisher(cluster, "gpu-0"),
    )
    report = monitor.check_once()
    assert report is not None and report.ok, report and report.failures
    assert report.flash is not None and report.flash.ok
    status = Node(cluster.get("Node", "gpu-0").raw).status
    assert condition_status(status, ICI_HEALTHY_CONDITION) == "True"
    assert [e.raw["type"] for e in cluster.list("Event")] == ["Normal"]
    published = cluster.get("NodeHealthReport", "gpu-0").raw["status"]
    assert published["metrics"]["mxu_tflops"] == report.mxu.tflops
    line = next(
        json.loads(ln) for ln in reversed(gate.last_stderr.splitlines())
        if ln.startswith("{") and "kernels" in ln
    )
    assert line["kernels"]["launches"]["matmul"] > 0
    assert line["kernels"]["launches"]["flash_attention"] > 0


def test_payload_publishes_its_report_to_the_ports_server(cuda, tmp_path):
    """The probe payload on the card with ``--publish-report`` against the
    port's ``LocalApiServer`` (bearer token, default priority and fairness):
    the stored NodeHealthReport reads back as the payload's
    ``HealthReport.observation()``, the telemetry flow admitted its writes
    and shed none, and both kernels ran."""
    import subprocess
    import sys

    from k8s_operator_libs_tpu_torch.kube.apiserver import LocalApiServer
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    node = "gpu-report-0"
    with LocalApiServer(token="publish-token") as server:
        kubeconfig = server.write_kubeconfig(str(tmp_path / "kubeconfig"))
        env, repo = _payload_env(KUBECONFIG=kubeconfig, NODE_NAME=node, HOME=str(tmp_path))
        env.pop("KUBERNETES_SERVICE_HOST", None)
        proc = subprocess.run(
            [sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.health",
             "--publish-report", "--ready-file", str(tmp_path / "ready")],
            env=env, cwd=repo, capture_output=True, text=True, timeout=900,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        report = HealthReport.from_dict(json.loads(proc.stdout.strip().splitlines()[-1]))
        stored = server.cluster.get("NodeHealthReport", node).raw
        flows = server.apf_stats()
    checks, metrics = report.observation()
    assert (stored["status"]["checks"], stored["status"]["metrics"]) == (checks, metrics)
    assert stored["spec"] == {"nodeName": node, "source": "gate"}
    assert flows["telemetry"]["admitted_total"] >= 1
    assert all(flow["shed_429_total"] == 0 for flow in flows.values())
    line = next(json.loads(ln) for ln in reversed(proc.stderr.splitlines())
                if ln.startswith("{") and "kernels" in ln)
    assert line["kernels"]["launches"]["matmul"] > 0
    assert line["kernels"]["launches"]["flash_attention"] > 0


def test_report_informer_over_dict_client_sees_the_gate_report(cuda):
    """The port's NodeHealthReport informer over ``chip_smoke.py``'s
    ``DictClient`` (its journal-backed watch): a monitor cycle whose
    subprocess gate runs the card's payload publishes the report, and the
    informer's copy equals it, the card's ``mxu_tflops`` included."""
    from k8s_operator_libs_tpu_torch.kube.informer import Informer
    from k8s_operator_libs_tpu_torch.tpu.health import SubprocessHealthGate
    from k8s_operator_libs_tpu_torch.tpu.monitor import ReportPublisher, TpuHealthMonitor

    smoke = chip_smoke_module()
    client = smoke.monitor_client()
    env, repo = _payload_env()
    gate = SubprocessHealthGate(
        cli_args=IciHealthGate.tpu_defaults(matmul_size=512).to_cli_args(),
        timeout_seconds=600, env=env, cwd=repo,
    )
    monitor = TpuHealthMonitor(
        client, smoke.MONITOR_NODE, gate=gate, failure_threshold=1, success_threshold=1,
        report_publisher=ReportPublisher(client, smoke.MONITOR_NODE),
    )
    seen = []
    with Informer(client, "NodeHealthReport", watch_timeout_seconds=1) as reports:
        reports.add_event_handler(lambda event_type, obj, old: seen.append((event_type, obj.name)))
        assert reports.wait_for_sync(10)
        report = monitor.check_once()
        assert report is not None and report.ok, report and report.failures
        published = client.get("NodeHealthReport", smoke.MONITOR_NODE).raw
        deadline = time.monotonic() + 10
        while reports.get(smoke.MONITOR_NODE) is None or (
            reports.get(smoke.MONITOR_NODE).resource_version
            != published["metadata"]["resourceVersion"]
        ):
            assert time.monotonic() < deadline, "the informer never saw the report"
            time.sleep(0.05)
        cached = reports.get(smoke.MONITOR_NODE).raw
    assert cached == published
    assert cached["status"]["metrics"]["mxu_tflops"] == report.mxu.tflops
    assert ("ADDED", smoke.MONITOR_NODE) in seen


def test_one_pod_gang_through_the_tcp_rendezvous(cuda):
    gate = IciHealthGate.tpu_defaults(
        matmul_size=256, coordinator=f"127.0.0.1:{_free_port()}", num_processes=1,
    )
    try:
        report = gate.run()
        form_times = dict(gate._world.form_times)
    finally:
        gate.close()
    n = torch.cuda.device_count()
    assert report.ok, report.failures
    assert report.process_count == 1
    assert (report.slice_devices_passed, report.slice_devices_total) == (n, n)
    assert f"slice={n}/{n} over 1 hosts" in report.summary()
    assert "tcp_join" in form_times


def test_two_pod_gang_between_cards(cards_world, tmp_path):
    """Two payload processes, each with half the cards, joined into one
    world through the TCP store: both pass the shared agreement."""
    import subprocess
    import sys

    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    k = torch.cuda.device_count() // 2
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for i, cards in enumerate((range(k), range(k, 2 * k))):
        env, repo = _payload_env(CUDA_VISIBLE_DEVICES=",".join(map(str, cards)))
        argv = [
            sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.health",
            "--matmul-size", "256", "--coordinator", coordinator, "--num-processes", "2",
            "--process-id", str(i), "--link-peers", "node-a,node-b",
            "--ready-file", str(tmp_path / f"{i}.ready"),
        ]
        procs.append(subprocess.Popen(argv, env=env, cwd=repo, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=600) for p in procs]
    for i, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, err[-3000:]
        report = HealthReport.from_dict(json.loads(out.strip().splitlines()[-1]))
        assert report.ok and report.process_count == 2
        assert f"slice={2 * k}/{2 * k} over 2 hosts" in (tmp_path / f"{i}.ready").read_text()
        other = ("node-a", "node-b")[1 - i]
        assert any(h.peer == other and h.ok for h in report.links), report.links


def test_demo_rolls_on_the_card(cuda):
    """``upgrade_controller --demo`` with its in-process gate on the card
    (the default ``--gate-device``): the JAX demo's 33 passes, and every
    node of the demo pool passed the gate."""
    import re
    import subprocess
    import sys

    env, repo = _payload_env()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller", "--demo"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == "demo: rolling upgrade complete in 33 passes"
    verdicts = re.findall(r"^demo gate: node=(\S+) ok=(\w+) ", proc.stdout, re.M)
    assert sorted(verdicts) == [(f"h100-pool-{i}", "True") for i in range(4)]
