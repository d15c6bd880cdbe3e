"""The port's sharded burn-in against the JAX package's, on the CPU.

Two sharded train steps: the JAX package's ``make_sharded_train_step`` on a
mesh of ``jax.devices()[:n]``, and the port's on a gloo world of n CPU
ranks, from the same parameters (JAX's, carried over by
``params_from_jax`` and split by ``shard_params``) and the same tokens.

* dp x tp in {1 x 2, 2 x 2}: the losses agree within the tolerances of
  ``test_torch_burnin.py``, and with the port's own unsharded step.
* The sequence and expert axes, in worlds of 2 ({dp1, sp2} with ring and
  with Ulysses, {dp1, ep2}) and 4 ({dp2, sp2}, {tp2, sp2} both ways,
  {ep2, tp2}); the four axes together need a world of 8 and are ``slow``:
  the losses agree in f32 within rel 1e-5 and in bf16 within rel 2e-2, the
  tolerance the JAX package holds its own sharded step to against its
  unsharded model; and each rank's gradients after the step's reductions
  are its share of JAX's unsharded gradients, the router's included.
"""

import math

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


@pytest.fixture(scope="module")
def worlds():
    """A gloo world of n CPU ranks, formed at its first use and shared by
    every test of this module."""
    made = {}

    def world(n):
        if n not in made:
            made[n] = World(["cpu"] * n)
        return made[n]

    yield world
    for w in made.values():
        w.close()


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=lambda a: f"dp{a[0]}xtp{a[1]}")
def layout(request, worlds):
    """(axes, world of dp*tp CPU ranks)."""
    dp, tp = request.param
    return {"dp": dp, "tp": tp}, worlds(dp * tp)


def _jax_run(axes, jcfg, sp_impl="ring"):
    n = math.prod(axes.values())
    mesh = jax_build_mesh(axes, devices=jax.devices()[:n])
    step, params, batch = jax_burnin.make_sharded_train_step(mesh, jcfg, sp_impl=sp_impl)
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


# ----------------------------------------------------------------------
# The sequence and expert axes.
# ----------------------------------------------------------------------

#: (axes, sp_impl, n_experts) by id. The MoE layouts hold two experts a
#: layer (at tp 2 alone each rank holds half of every expert); the
#: four-axis layout needs a world of 8.
SP_EP = {
    "dp1xsp2-ring": ({"dp": 1, "sp": 2}, "ring", 0),
    "dp1xsp2-ulysses": ({"dp": 1, "sp": 2}, "ulysses", 0),
    "dp1xep2": ({"dp": 1, "ep": 2}, "ring", 2),
    "dp2xsp2": ({"dp": 2, "sp": 2}, "ring", 0),
    "tp2xsp2-ring": ({"tp": 2, "sp": 2}, "ring", 0),
    "tp2xsp2-ulysses": ({"tp": 2, "sp": 2}, "ulysses", 0),
    "ep2xtp2": ({"ep": 2, "tp": 2}, "ring", 2),
    "tp2-moe": ({"tp": 2}, "ring", 2),
    "dp1xep2xtp2xsp2": ({"dp": 1, "ep": 2, "tp": 2, "sp": 2}, "ring", 2),
}
LAYOUTS = [
    pytest.param(name, marks=pytest.mark.slow) if math.prod(SP_EP[name][0].values()) > 4
    else name
    for name in SP_EP
]
#: (jax dtype, torch dtype, loss rel tol): the JAX package's own tolerance
#: for a sharded step against its unsharded model in bf16
#: (``tests/test_jax_stack.py``).
SP_EP_DTYPES = [
    pytest.param(jnp.float32, torch.float32, 1e-5, id="f32"),
    pytest.param(jnp.bfloat16, torch.bfloat16, 2e-2, id="bf16"),
]


def _configs(name, jdtype, tdtype):
    axes, sp_impl, experts = SP_EP[name]
    shape = dict(WIDTHS, batch=max(2, axes.get("dp", 1) * 2), n_experts=experts)
    return (
        axes, sp_impl,
        jax_burnin.BurninConfig(dtype=jdtype, **shape),
        port.BurninConfig(dtype=tdtype, **shape),
    )


@pytest.mark.parametrize("jdtype,tdtype,rel", SP_EP_DTYPES)
@pytest.mark.parametrize("name", LAYOUTS)
def test_sequence_and_expert_losses_match_jax(worlds, name, jdtype, tdtype, rel):
    axes, sp_impl, jcfg, pcfg = _configs(name, jdtype, tdtype)
    params, tokens = _inputs(jcfg)
    world = worlds(math.prod(axes.values()))
    per_rank = world.run(port.sharded_losses, axes, pcfg, 2, params, tokens, sp_impl)
    assert all(losses == per_rank[0] for losses in per_rank)
    assert per_rank[0] == pytest.approx(_jax_run(axes, jcfg, sp_impl), rel=rel)
    assert per_rank[0][1] < per_rank[0][0]


def _rank_coords(axes, rank):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


@pytest.mark.parametrize("name", LAYOUTS)
def test_sharded_gradients_are_shares_of_jax_gradients(worlds, name):
    """Each rank's gradients, after the step's reductions over dp, sp and
    the experts' group, are its share of the unsharded model's gradients
    in JAX. A router gradient not summed over ep (and tp) is a part of
    the whole and fails here."""
    axes, sp_impl, jcfg, pcfg = _configs(name, jnp.float32, torch.float32)
    params, tokens = _inputs(jcfg)
    jparams = jax_burnin.init_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.roll(jnp.asarray(tokens), -1, axis=-1)}
    jgrads = jax.grad(jax_burnin.loss_fn)(jparams, batch, jcfg)
    full = port.params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    world = worlds(math.prod(axes.values()))
    per_rank = world.run(port.sharded_grads, axes, pcfg, params, tokens, sp_impl)
    for rank, ours in enumerate(per_rank):
        at = _rank_coords(axes, rank)
        want = port.shard_params(
            full, pcfg, at.get("tp", 0), axes.get("tp", 1), at.get("ep", 0), axes.get("ep", 1)
        )
        for key in ("embed", "ln_f"):
            np.testing.assert_allclose(ours[key], want[key].numpy(), rtol=1e-4, atol=1e-6)
        for mine, theirs in zip(ours["layers"], want["layers"]):
            assert set(mine) == set(theirs)
            for key in mine:
                np.testing.assert_allclose(
                    mine[key], theirs[key].numpy(), rtol=1e-4, atol=1e-6, err_msg=key
                )


def test_expert_specs_follow_the_jax_package():
    cfg = dict(WIDTHS, n_experts=4)
    for tp_axis, ep_axis in (("tp", "ep"), ("tp", None), (None, "ep")):
        ours = port.param_specs(port.BurninConfig(**cfg), tp_axis, ep_axis)["layers"][0]
        theirs = jax_burnin.param_specs(
            jax_burnin.BurninConfig(**cfg), tp_axis, ep_axis
        )["layers"][0]
        assert {k: tuple(v) for k, v in theirs.items()} == ours
    sp = {k: tuple(v) for k, v in jax_burnin.batch_spec("sp").items()}
    assert sp == port.batch_spec("sp")


def test_each_ep_rank_holds_its_own_experts():
    cfg = port.BurninConfig(dtype=torch.float32, batch=2, n_experts=4, **WIDTHS)
    params = port.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    full = params["layers"][0]
    for ep in range(2):
        for tp in range(2):
            share = port.shard_params(params, cfg, tp, 2, ep, 2)["layers"][0]
            experts = slice(ep * 2, ep * 2 + 2)
            ff = slice(tp * cfg.d_ff // 2, (tp + 1) * cfg.d_ff // 2)
            assert torch.equal(share["experts_up"], full["experts_up"][experts][:, :, ff])
            assert torch.equal(share["experts_down"], full["experts_down"][experts][:, ff])
            assert share["w_router"] is full["w_router"]


def test_expert_axis_must_divide_the_experts():
    for experts in (0, 3):
        cfg = port.BurninConfig(n_experts=experts, **WIDTHS)
        params = port.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        with pytest.raises(ValueError, match="n_experts divisible"):
            port.shard_params(params, cfg, ep_index=0, ep_size=2)


def test_sequence_axis_must_divide_the_sequence_and_name_its_core():
    cfg = port.BurninConfig(**WIDTHS)
    with pytest.raises(ValueError, match="must divide seq_len"):
        port.make_sharded_train_step(_mesh(dp=1, sp=3), cfg)
    with pytest.raises(ValueError, match="unknown sp_impl"):
        port.make_sharded_train_step(_mesh(dp=1, sp=2), cfg, sp_impl="tree")
