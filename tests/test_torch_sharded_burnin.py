"""The port's sharded burn-in against the JAX package's, on the CPU.

Two sharded train steps at dp x tp in {1 x 2, 2 x 2}: the JAX package's
``make_sharded_train_step`` on a mesh of ``jax.devices()[:n]``, and the
port's on a gloo world of n CPU ranks, from the same parameters (JAX's,
carried over by ``params_from_jax`` and split by ``shard_params``) and the
same tokens. The losses must agree within the tolerances of
``test_torch_burnin.py``, and with the port's own unsharded step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import burnin as jax_burnin
from k8s_operator_libs_tpu.parallel.mesh import build_mesh as jax_build_mesh
from k8s_operator_libs_tpu_torch.models import burnin as port
from k8s_operator_libs_tpu_torch.parallel.mesh import Mesh, World

#: The gate's burn-in widths (``IciHealthGate._burnin``).
WIDTHS = dict(d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32)

#: (jax dtype, torch dtype, loss rel tol): ``test_torch_burnin.DTYPES``.
DTYPES = [
    pytest.param(jnp.float32, torch.float32, 1e-5, id="f32"),
    pytest.param(jnp.bfloat16, torch.bfloat16, 2e-3, id="bf16"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=lambda a: f"dp{a[0]}xtp{a[1]}")
def layout(request):
    """(axes, world of dp*tp CPU ranks)."""
    dp, tp = request.param
    world = World(["cpu"] * (dp * tp))
    yield {"dp": dp, "tp": tp}, world
    world.close()


def _jax_run(axes, jcfg):
    n = axes["dp"] * axes["tp"]
    mesh = jax_build_mesh(axes, devices=jax.devices()[:n])
    step, params, batch = jax_burnin.make_sharded_train_step(mesh, jcfg)
    params, l1 = step(params, batch)
    _, l2 = step(params, batch)
    return [float(l1), float(l2)]


def _inputs(jcfg):
    """JAX's initial params and tokens, as the port takes them."""
    jparams = jax_burnin.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.asarray(jax_burnin.synthetic_batch(jax.random.PRNGKey(1), jcfg)["tokens"])
    return port.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"), tokens


@pytest.mark.parametrize("jdtype,tdtype,rel", DTYPES)
def test_sharded_losses_match_jax(layout, jdtype, tdtype, rel):
    axes, world = layout
    batch = max(2, axes["dp"] * 2)
    jcfg = jax_burnin.BurninConfig(dtype=jdtype, batch=batch, **WIDTHS)
    pcfg = port.BurninConfig(dtype=tdtype, batch=batch, **WIDTHS)
    params, tokens = _inputs(jcfg)
    per_rank = world.run(port.sharded_losses, axes, pcfg, 2, params, tokens)
    assert all(losses == per_rank[0] for losses in per_rank)
    theirs = _jax_run(axes, jcfg)
    assert per_rank[0] == pytest.approx(theirs, rel=rel)
    assert per_rank[0][1] < per_rank[0][0]


def test_sharded_losses_match_the_unsharded_step(layout):
    axes, world = layout
    batch = max(2, axes["dp"] * 2)
    jcfg = jax_burnin.BurninConfig(dtype=jnp.float32, batch=batch, **WIDTHS)
    pcfg = port.BurninConfig(dtype=torch.float32, batch=batch, **WIDTHS)
    params, tokens = _inputs(jcfg)
    sharded = world.run(port.sharded_losses, axes, pcfg, 2, params, tokens)[0]
    t = torch.from_numpy(tokens.astype(np.int64))
    full = {"tokens": t, "targets": torch.roll(t, -1, dims=-1)}
    p, l1 = port.train_step(params, full, pcfg)
    _, l2 = port.train_step(p, full, pcfg)
    assert sharded == pytest.approx([float(l1), float(l2)], rel=1e-5)


def test_gate_defaults_give_a_falling_loss(layout):
    axes, world = layout
    cfg = port.BurninConfig(batch=max(2, axes["dp"] * 2), **WIDTHS)
    l1, l2 = world.run(port.sharded_losses, axes, cfg)[0]
    assert np.isfinite(l1) and l2 < l1


def test_each_tp_rank_holds_its_own_heads_q_k_and_v():
    cfg = port.BurninConfig(dtype=torch.float32, batch=2, **WIDTHS)
    params = port.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    full = params["layers"][0]
    d, tp = cfg.d_model, 2
    q, k, v = full["wqkv"].split(d, dim=1)
    for rank in range(tp):
        cols = slice(rank * d // tp, (rank + 1) * d // tp)
        ff = slice(rank * cfg.d_ff // tp, (rank + 1) * cfg.d_ff // tp)
        share = port.shard_params(params, cfg, rank, tp)["layers"][0]
        assert torch.equal(share["wqkv"], torch.cat([q[:, cols], k[:, cols], v[:, cols]], 1))
        assert torch.equal(share["wo"], full["wo"][cols])
        assert torch.equal(share["w_up"], full["w_up"][:, ff])
        assert torch.equal(share["w_down"], full["w_down"][ff])
        assert share["ln1"] is full["ln1"]


def test_specs_follow_the_jax_package():
    cfg = port.BurninConfig(**WIDTHS)
    ours = port.param_specs(cfg)["layers"][0]
    theirs = jax_burnin.param_specs(jax_burnin.BurninConfig(**WIDTHS))["layers"][0]
    assert {k: tuple(v) for k, v in theirs.items()} == ours
    assert {k: tuple(v) for k, v in jax_burnin.batch_spec().items()} == port.batch_spec()


def _mesh(**shape):
    return Mesh(
        shape=shape, coords={a: 0 for a in shape}, groups={}, ranks={},
        device=torch.device("cpu"),
    )


@pytest.mark.parametrize("axis", ["sp", "ep"])
def test_sequence_and_expert_axes_name_the_roadmap_item(axis):
    cfg = port.BurninConfig(**WIDTHS)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item A3"):
        port.make_sharded_train_step(_mesh(dp=1, **{axis: 2}), cfg)


def test_mixture_of_experts_specs_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item A3"):
        port.param_specs(port.BurninConfig(n_experts=2, **WIDTHS), ep_axis="ep")
