"""The port's flash attention and attention helpers against the JAX
package's, on the CPU (the CUDA kernel itself: tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models.burnin import BurninConfig as JaxBurninConfig
from k8s_operator_libs_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from k8s_operator_libs_tpu.ops.flash_attention import (
    flash_attention_probe as jax_flash_probe,
)
from k8s_operator_libs_tpu.ops.probe_harness import host_qkv as jax_host_qkv
from k8s_operator_libs_tpu.ops.probe_harness import quantize as jax_quantize
from k8s_operator_libs_tpu.ops.ring_attention import (
    reference_attention as jax_reference_attention,
)
from k8s_operator_libs_tpu.ops.ulysses import (
    local_causal_attention as jax_local_causal_attention,
)
from k8s_operator_libs_tpu_torch.models.burnin import BurninConfig
from k8s_operator_libs_tpu_torch.ops import flash_attention as port
from k8s_operator_libs_tpu_torch.ops.probe_harness import host_qkv, quantize
from k8s_operator_libs_tpu_torch.ops.ring_attention import reference_attention
from k8s_operator_libs_tpu_torch.ops.ulysses import local_causal_attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from a thread per core, and the suite runs
    several workers side by side with timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed=7):
    return host_qkv(shape, seed)


@pytest.mark.parametrize("head_dim", [16, 32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_interpret_f32(causal, head_dim):
    q, k, v = _qkv((2, 2, 64, head_dim))
    want = np.asarray(
        jax_flash_attention(
            *(jnp.asarray(t) for t in (q, k, v)),
            block_q=16, block_k=16, causal=causal, interpret=True,
        )
    )
    got = port.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    # The JAX package's own tolerance for its kernel vs the oracle.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("head_dim", [16, 32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_interpret_bf16(causal, head_dim):
    q, k, v = _qkv((2, 2, 64, head_dim))
    want = np.asarray(
        jax_flash_attention(
            *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
            block_q=16, block_k=16, causal=causal, interpret=True,
        ),
        np.float32,
    )
    got = port.flash_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), causal=causal
    )
    assert got.dtype == torch.bfloat16
    # Both round the f32 result to bf16; the probe's tolerance.
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_kernel_takes_the_burn_in_head_dims():
    """The JAX package runs its flash core at the burn-in's own head_dim:
    ``BurninConfig()`` width and the health gate's burn-in
    (k8s_operator_libs_tpu/tpu/health.py, d_model 64 over 4 heads)."""
    gate_burnin = JaxBurninConfig(d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32)
    for head_dim in (JaxBurninConfig().head_dim, BurninConfig().head_dim, gate_burnin.head_dim):
        assert head_dim in port.KERNEL_HEAD_DIMS
    assert 128 in port.KERNEL_HEAD_DIMS  # the probe's


@pytest.mark.parametrize(
    "bh,seq,causal,want",
    [
        (4, 1024, True, (4, 160)),  # the probe's shape: 64 blocks unsplit
        (4, 1024, False, (4, 256)),
        (32, 128, True, (0, 64)),  # BurninConfig() with the flash core
        (32, 4096, True, (0, 2048)),  # enough Q tiles to fill the card
        (2, 200, True, (0, 8)),  # one chunk would cover every range
    ],
)
def test_split_plan(bh, seq, causal, want):
    assert port.split_plan(bh, seq, causal, sms=132) == want


@pytest.mark.parametrize("seq", [1, 63, 64, 65, 700, 1000, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_split_plan_counts_every_key_tile_once(seq, causal):
    """The chunks of each Q tile cover its K/V tiles (those up to the
    diagonal when causal) without overlap: the blocks' tiles add up."""
    tile = port.KERNEL_TILE
    split, blocks = port.split_plan(3, seq, causal, sms=132)
    n = -(-seq // tile)
    kv = [min(n, iq + 1) if causal else n for iq in range(n)]
    if split == 0:
        assert blocks == 3 * n
        return
    chunks = [-(-t // split) for t in kv]
    assert blocks == 3 * sum(chunks)
    for t, c in zip(kv, chunks):
        bounds = [i * t // c for i in range(c + 1)]
        assert bounds[0] == 0 and bounds[-1] == t
        assert all(0 < hi - lo <= split for lo, hi in zip(bounds, bounds[1:]))


def test_cpu_tensor_counts_no_launch():
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 1, 8, 4)))
    before = port.flash_attention.launches
    port.flash_attention(q, k, v)
    assert port.flash_attention.launches == before


def test_wrapper_rejects_mismatched_operands():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError):
        port.flash_attention(q, torch.zeros(1, 2, 8, 8), q)
    with pytest.raises(ValueError):
        port.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        port.flash_attention(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4), torch.zeros(2, 8, 4))


def test_probe_ok_on_cpu_and_agrees_with_jax():
    ours = port.flash_attention_probe(batch=1, heads=2, seq=64, head_dim=16, device="cpu")
    theirs = jax_flash_probe(batch=1, heads=2, seq=64, head_dim=16, interpret=True)
    assert ours.ok, ours.error
    assert theirs.ok, theirs.error
    assert ours.tokens_per_s > 0
    # Same host inputs, same oracle, both round to bf16.
    assert ours.max_abs_err <= 2e-2 and theirs.max_abs_err <= 2e-2
    assert set(vars(ours)) == set(vars(theirs))


def test_probe_crash_is_a_failed_report(monkeypatch):
    def boom(q, k, v, causal=True):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(port, "flash_attention", boom)
    report = port.flash_attention_probe(batch=1, heads=1, seq=16, head_dim=8, device="cpu")
    assert not report.ok and "kernel fault" in report.error


def test_probe_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.flash_attention_probe(seq=16, head_dim=8)


def test_host_qkv_and_quantize_match_jax():
    ours = host_qkv((2, 3, 5), seed=11)
    theirs = jax_host_qkv((2, 3, 5), seed=11)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            quantize(a, torch.bfloat16), jax_quantize(b, jnp.bfloat16)
        )


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv((1, 2, 16, 8))
    np.testing.assert_array_equal(
        reference_attention(q, k, v, causal=causal),
        jax_reference_attention(q, k, v, causal=causal),
    )


@pytest.mark.parametrize(
    "dtype,jdtype,tol", [(torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 2e-2)]
)
def test_local_causal_attention_matches_jax(dtype, jdtype, tol):
    q, k, v = _qkv((2, 2, 32, 8), seed=4)
    want = np.asarray(
        jax_local_causal_attention(*(jnp.asarray(t).astype(jdtype) for t in (q, k, v))),
        np.float32,
    )
    got = local_causal_attention(*(torch.from_numpy(t).to(dtype) for t in (q, k, v)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)

