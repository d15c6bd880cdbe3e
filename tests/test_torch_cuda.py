"""The port's CUDA kernels on the card, against their plain versions, and
its NCCL worlds.

A CUDA kernel has no CPU mode and NCCL needs cards, so every test here
needs an NVIDIA card (and ``nvcc`` for the kernels); elsewhere each one
skips (decided inside the fixture, never at import). The tests of a world
of two or more cards skip, inside their fixture, on a one-card machine. On
the card:

    python -m pytest tests/test_torch_cuda.py -q

This file imports no JAX, so it runs where only PyTorch is installed.
"""

import math

import pytest
import torch

from k8s_operator_libs_tpu_torch.models import burnin
from k8s_operator_libs_tpu_torch.ops import collectives
from k8s_operator_libs_tpu_torch.ops import matmul as matmul_mod
from k8s_operator_libs_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    split_plan,
)
from k8s_operator_libs_tpu_torch.ops.matmul import (
    matmul,
    matmul_path,
    matmul_reference,
    mxu_probe,
)
from k8s_operator_libs_tpu_torch.ops.probe_harness import quick_battery
from k8s_operator_libs_tpu_torch.ops.ring_attention import ring_attention_probe
from k8s_operator_libs_tpu_torch.ops.ulysses import ulysses_probe
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


def test_gate_between_cards(cards_world):
    gate = IciHealthGate.tpu_defaults(matmul_size=256)
    try:
        report = gate.run()
    finally:
        gate.close()
    assert report.ok, report.failures
    assert len(report.links) == torch.cuda.device_count()
    assert report.ring_attention.ok and report.ulysses.ok and report.burnin_ok
