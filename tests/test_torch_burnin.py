"""The port's burn-in model against the JAX package's, on the CPU.

Both packages start from the JAX package's ``init_params`` (through
``params_from_jax``) and the same numpy-made tokens, so they compute the
same thing and may differ only by rounding: the dense model and the soft
mixture of experts (``n_experts``), each in f32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import burnin as jax_burnin
from k8s_operator_libs_tpu_torch.models import burnin as port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from a thread per core, and the suite runs
    several workers side by side with timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=2, seq_len=16, batch=2)

# (jax dtype, torch dtype, logits atol, loss rtol, updated-param atol).
# f32: the two differ only in summation order (measured ~2e-6 on logits).
# bf16: the frameworks round intermediates to bf16 at different places; the
# logits (|x| < 4) may differ by a few bf16 steps (2^-6 at that magnitude),
# the loss by ~1e-4 relative, an updated bf16 weight by a step or so.
DTYPES = [
    pytest.param(jnp.float32, torch.float32, 1e-5, 1e-5, 1e-6, id="f32"),
    pytest.param(jnp.bfloat16, torch.bfloat16, 6.25e-2, 2e-3, 4e-3, id="bf16"),
]


def _setup(jdtype, tdtype, **overrides):
    kw = {**SMALL, **overrides}
    jcfg = jax_burnin.BurninConfig(dtype=jdtype, **kw)
    pcfg = port.BurninConfig(dtype=tdtype, **kw)
    jparams = jax_burnin.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = port.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, kw["vocab"], (kw["batch"], kw["seq_len"]))
    targets = np.roll(tokens, -1, axis=-1)
    jbatch = {
        "tokens": jnp.asarray(tokens, jnp.int32),
        "targets": jnp.asarray(targets, jnp.int32),
    }
    pbatch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    return jcfg, pcfg, jparams, pparams, jbatch, pbatch


#: The mixture of experts at the small widths: four experts a layer.
EXPERTS = dict(n_experts=4)


@pytest.mark.parametrize("jdtype,tdtype,logits_atol,loss_rtol,param_atol", DTYPES)
def test_logits_match_jax(jdtype, tdtype, logits_atol, loss_rtol, param_atol):
    _check_logits(jdtype, tdtype, logits_atol)


@pytest.mark.parametrize("jdtype,tdtype,logits_atol,loss_rtol,param_atol", DTYPES)
def test_moe_logits_match_jax(jdtype, tdtype, logits_atol, loss_rtol, param_atol):
    _check_logits(jdtype, tdtype, logits_atol, **EXPERTS)


def _check_logits(jdtype, tdtype, logits_atol, **overrides):
    jcfg, pcfg, jparams, pparams, jbatch, pbatch = _setup(jdtype, tdtype, **overrides)
    want = np.asarray(jax_burnin.forward(jparams, jbatch["tokens"], jcfg))
    got = port.forward(pparams, pbatch["tokens"], pcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=logits_atol, rtol=0)


@pytest.mark.parametrize("jdtype,tdtype,logits_atol,loss_rtol,param_atol", DTYPES)
def test_two_train_steps_match_jax(jdtype, tdtype, logits_atol, loss_rtol, param_atol):
    _check_two_steps(jdtype, tdtype, loss_rtol, param_atol)


@pytest.mark.parametrize("jdtype,tdtype,logits_atol,loss_rtol,param_atol", DTYPES)
def test_moe_two_train_steps_match_jax(jdtype, tdtype, logits_atol, loss_rtol, param_atol):
    _check_two_steps(jdtype, tdtype, loss_rtol, param_atol, **EXPERTS)


def _check_two_steps(jdtype, tdtype, loss_rtol, param_atol, **overrides):
    jcfg, pcfg, jparams, pparams, jbatch, pbatch = _setup(jdtype, tdtype, **overrides)
    jparams, jl1 = jax_burnin.train_step(jparams, jbatch, jcfg)
    jparams, jl2 = jax_burnin.train_step(jparams, jbatch, jcfg)
    pparams, pl1 = port.train_step(pparams, pbatch, pcfg)
    pparams, pl2 = port.train_step(pparams, pbatch, pcfg)
    for ours, theirs in ((pl1, jl1), (pl2, jl2)):
        assert float(ours) == pytest.approx(float(theirs), rel=loss_rtol)
    # The gate's own rule, in both packages.
    assert float(jl2) < float(jl1) and float(pl2) < float(pl1)
    for name in ("embed", "ln_f"):
        np.testing.assert_allclose(
            pparams[name].float().numpy(),
            np.asarray(jparams[name], np.float32),
            atol=param_atol, rtol=0,
        )
    for ours, theirs in zip(pparams["layers"], jparams["layers"]):
        assert set(ours) == set(theirs)
        for name in ours:
            assert ours[name].dtype == (torch.float32 if name.startswith("ln") else tdtype)
            np.testing.assert_allclose(
                ours[name].float().numpy(), np.asarray(theirs[name], np.float32),
                atol=param_atol, rtol=0,
            )


def test_params_from_jax_keeps_bf16_bits():
    jcfg = jax_burnin.BurninConfig(**SMALL)
    jparams = jax_burnin.init_params(jax.random.PRNGKey(3), jcfg)
    pparams = port.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert pparams["embed"].dtype == torch.bfloat16
    assert pparams["ln_f"].dtype == torch.float32
    np.testing.assert_array_equal(
        pparams["layers"][1]["wqkv"].float().numpy(),
        np.asarray(jparams["layers"][1]["wqkv"], np.float32),
    )


def test_params_from_jax_keeps_the_experts_bits():
    jcfg = jax_burnin.BurninConfig(**SMALL, **EXPERTS)
    jparams = jax_burnin.init_params(jax.random.PRNGKey(3), jcfg)
    pparams = port.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    for name in ("w_router", "experts_up", "experts_down"):
        ours, theirs = pparams["layers"][1][name], jparams["layers"][1][name]
        assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == theirs.shape
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(theirs, np.float32))


def test_init_params_has_the_jax_tree():
    _check_tree()


def test_init_params_has_the_jax_moe_tree():
    _check_tree(**EXPERTS)


def _check_tree(**experts):
    cfg = port.BurninConfig(**SMALL, **experts)
    ours = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    theirs = jax_burnin.init_params(
        jax.random.PRNGKey(0), jax_burnin.BurninConfig(**SMALL, **experts)
    )
    assert set(ours) == set(theirs)
    assert len(ours["layers"]) == len(theirs["layers"])
    for name in ("embed", "ln_f"):
        assert tuple(ours[name].shape) == theirs[name].shape
    for mine, ref in zip(ours["layers"], theirs["layers"]):
        assert {k: tuple(v.shape) for k, v in mine.items()} == {
            k: v.shape for k, v in ref.items()
        }
        assert mine["wqkv"].dtype == torch.bfloat16 and mine["ln1"].dtype == torch.float32


def test_init_params_is_seeded():
    cfg = port.BurninConfig(**SMALL)
    a = port.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    b = port.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["layers"][0]["w_up"], b["layers"][0]["w_up"])


def test_synthetic_batch_targets_are_shifted_tokens():
    cfg = port.BurninConfig(**SMALL)
    batch = port.synthetic_batch(torch.Generator().manual_seed(1), cfg, device="cpu")
    assert tuple(batch["tokens"].shape) == (cfg.batch, cfg.seq_len)
    assert torch.equal(batch["targets"], torch.roll(batch["tokens"], -1, dims=-1))
    assert int(batch["tokens"].max()) < cfg.vocab


def test_gate_config_loss_falls_on_cpu():
    cfg = port.BurninConfig(d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32, batch=2)
    params = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = port.synthetic_batch(torch.Generator().manual_seed(1), cfg, device="cpu")
    params, l1 = port.train_step(params, batch, cfg)
    _, l2 = port.train_step(params, batch, cfg)
    assert np.isfinite(float(l1)) and float(l2) < float(l1)


def test_flash_core_matches_plain_core_on_cpu():
    jcfg, pcfg, _, pparams, _, pbatch = _setup(jnp.float32, torch.float32)
    flash_cfg = port.BurninConfig(dtype=torch.float32, use_flash_attention=True, **SMALL)
    np.testing.assert_allclose(
        port.forward(pparams, pbatch["tokens"], flash_cfg).numpy(),
        port.forward(pparams, pbatch["tokens"], pcfg).numpy(),
        atol=1e-5,
    )


def test_moe_loss_falls_on_cpu():
    cfg = port.BurninConfig(
        d_model=32, n_heads=2, d_ff=64, n_layers=1, seq_len=16, batch=4, **EXPERTS
    )
    params = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = port.synthetic_batch(torch.Generator().manual_seed(1), cfg, device="cpu")
    params, l1 = port.train_step(params, batch, cfg)
    for _ in range(4):
        params, l2 = port.train_step(params, batch, cfg)
    assert np.isfinite(float(l1)) and float(l2) < float(l1)


def test_heads_must_divide_the_model_width():
    cfg = port.BurninConfig(**{**SMALL, "n_heads": 3})
    params = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = port.synthetic_batch(torch.Generator().manual_seed(1), cfg, device="cpu")["tokens"]
    with pytest.raises(ValueError, match="must divide d_model"):
        port.forward(params, tokens, cfg)


def test_init_params_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.init_params(torch.Generator().manual_seed(0), port.BurninConfig(**SMALL))
