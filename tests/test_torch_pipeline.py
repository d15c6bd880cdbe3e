"""The port's GPipe pipeline against the JAX package's, on the CPU.

The JAX package's ``make_pipeline_train_step`` on a mesh of
``jax.devices()[:n]`` and the port's on a gloo world of n CPU ranks, from
the same parameters (JAX's ``init_params``, carried over by
``params_from_jax``) and the same tokens, as ``tests/test_pipeline.py``
holds the JAX pipeline: its loss equals the unpipelined model's at pp 2
and 4 (rtol 2e-2), training lowers it, it composes with dp, the stacked
layers are split over pp, pp must divide the layers, and MoE layers run
inside the stages. In f32 the port's two pipelined losses also equal
JAX's within rel 1e-5, so the backward pipeline is held too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import burnin as jax_burnin
from k8s_operator_libs_tpu.models import pipeline as jax_pipeline
from k8s_operator_libs_tpu.parallel.mesh import build_mesh as jax_build_mesh
from k8s_operator_libs_tpu_torch.models import burnin as port
from k8s_operator_libs_tpu_torch.models import pipeline as port_pipeline
from k8s_operator_libs_tpu_torch.parallel.mesh import Mesh, World

#: ``tests/test_pipeline.py``'s config.
SHAPE = dict(d_model=32, n_heads=2, d_ff=64, n_layers=4, seq_len=16, batch=8)
MOE = dict(SHAPE, n_layers=2, batch=4, n_experts=2)


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


def _inputs(shape, jdtype):
    jcfg = jax_burnin.BurninConfig(dtype=jdtype, **shape)
    jparams = jax_burnin.init_params(jax.random.PRNGKey(0), jcfg)
    batch = jax_burnin.synthetic_batch(jax.random.PRNGKey(1), jcfg)
    params = port.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    unpipelined = float(jax_burnin.loss_fn(jparams, batch, jcfg))
    return jcfg, params, np.asarray(batch["tokens"]), unpipelined


def _jax_losses(axes, jcfg, microbatches, steps=2):
    n = int(np.prod(list(axes.values())))
    mesh = jax_build_mesh(axes, devices=jax.devices()[:n])
    step, params, batch = jax_pipeline.make_pipeline_train_step(
        mesh, jcfg, n_microbatches=microbatches
    )
    losses = []
    for _ in range(steps):
        params, loss = step(params, batch)
        losses.append(float(loss))
    return losses


def _ours(worlds, axes, shape, tdtype, microbatches, params, tokens, steps=2):
    cfg = port.BurninConfig(dtype=tdtype, **shape)
    world = worlds(int(np.prod(list(axes.values()))))
    per_rank = world.run(
        port_pipeline.pipeline_losses, axes, cfg, steps, microbatches, params, tokens
    )
    assert all(losses == per_rank[0] for losses in per_rank)
    return per_rank[0]


@pytest.mark.parametrize(
    "axes,shape,microbatches",
    [
        ({"pp": 2}, SHAPE, 4),
        ({"pp": 4}, SHAPE, 4),
        ({"dp": 2, "pp": 2}, SHAPE, 2),
        ({"pp": 2}, MOE, 2),
    ],
    ids=["pp2", "pp4", "dp2xpp2", "pp2-moe"],
)
def test_losses_match_jax_pipelined_and_unpipelined(worlds, axes, shape, microbatches):
    jcfg, params, tokens, unpipelined = _inputs(shape, jnp.float32)
    ours = _ours(worlds, axes, shape, torch.float32, microbatches, params, tokens)
    assert ours == pytest.approx(_jax_losses(axes, jcfg, microbatches), rel=1e-5)
    np.testing.assert_allclose(ours[0], unpipelined, rtol=2e-2)


@pytest.mark.parametrize("pp", [2, 4])
def test_bf16_loss_matches_the_unpipelined_model(worlds, pp):
    """At the JAX pipeline tests' own dtype (bf16) and tolerance."""
    _, params, tokens, unpipelined = _inputs(SHAPE, jnp.bfloat16)
    ours = _ours(worlds, {"pp": pp}, SHAPE, torch.bfloat16, 4, params, tokens, steps=1)
    np.testing.assert_allclose(ours[0], unpipelined, rtol=2e-2)


@pytest.mark.parametrize(
    "axes,shape,microbatches",
    [({"pp": 2}, SHAPE, 4), ({"dp": 2, "pp": 2}, SHAPE, 2)],
    ids=["pp2", "dp2xpp2"],
)
def test_stage_gradients_are_shares_of_the_unpipelined_gradients(worlds, axes, shape, microbatches):
    """Each stage's gradients, after the step's sums over dp and pp, are
    its layers' share of JAX's unpipelined gradients, and the embedding's
    and ln_f's whole on every stage: a stage that kept only its own part
    of the embedding's gradient fails here."""
    jcfg, params, tokens, _ = _inputs(shape, jnp.float32)
    jparams = jax_burnin.init_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.roll(jnp.asarray(tokens), -1, axis=-1)}
    jgrads = jax.grad(jax_burnin.loss_fn)(jparams, batch, jcfg)
    stacked = jax_pipeline.stack_layers(jgrads["layers"])
    cfg = port.BurninConfig(dtype=torch.float32, **shape)
    world = worlds(int(np.prod(list(axes.values()))))
    per_rank = world.run(port_pipeline.pipeline_grads, axes, cfg, microbatches, params, tokens)
    per_stage = shape["n_layers"] // axes["pp"]
    for rank, ours in enumerate(per_rank):
        stage = rank % axes["pp"]
        for name in ("embed", "ln_f"):
            np.testing.assert_allclose(ours[name], np.asarray(jgrads[name]), rtol=1e-4, atol=1e-6)
        for name, grad in ours["stacked"].items():
            want = np.asarray(stacked[name])[stage * per_stage:(stage + 1) * per_stage]
            np.testing.assert_allclose(grad, want, rtol=1e-4, atol=1e-6, err_msg=name)


def test_training_decreases_loss(worlds):
    cfg = port.BurninConfig(**SHAPE)
    losses = worlds(2).run(port_pipeline.pipeline_losses, {"pp": 2}, cfg, 4, 2)[0]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]


def _mesh(**shape):
    return Mesh(
        shape=shape, coords={a: 0 for a in shape}, groups={}, ranks={},
        device=torch.device("cpu"),
    )


def test_layer_stack_split_over_pp():
    cfg = port.BurninConfig(dtype=torch.float32, **SHAPE)
    params = port.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    stacked = port_pipeline.stack_layers(params["layers"])
    assert stacked["wqkv"].shape == (4, 32, 96)
    for stage in range(2):
        mesh = Mesh(
            shape={"pp": 2}, coords={"pp": stage}, groups={"pp": None}, ranks={},
            device=torch.device("cpu"),
        )
        _, local, batch = port_pipeline.make_pipeline_train_step(mesh, cfg, n_microbatches=2)
        assert torch.equal(local["stacked"]["wqkv"], stacked["wqkv"][2 * stage:2 * stage + 2])
        assert torch.equal(local["embed"], params["embed"])
        assert batch["tokens"].shape == (2, 4, 16)


def test_pp_must_divide_layers():
    with pytest.raises(ValueError, match="n_layers"):
        port_pipeline.make_pipeline_train_step(_mesh(pp=3), port.BurninConfig(**SHAPE), 2)


def test_microbatches_must_split_the_batch():
    with pytest.raises(ValueError, match="microbatches"):
        port_pipeline.make_pipeline_train_step(
            _mesh(dp=2, pp=2), port.BurninConfig(**SHAPE), n_microbatches=3
        )


def test_stack_layers_matches_jax():
    jcfg = jax_burnin.BurninConfig(**MOE)
    layers = jax_burnin.init_params(jax.random.PRNGKey(0), jcfg)["layers"]
    theirs = jax_pipeline.stack_layers(layers)
    ours = port_pipeline.stack_layers(
        port.params_from_jax(jax.tree.map(np.asarray, {"embed": 0, "ln_f": 0, "layers": layers}),
                             device="cpu")["layers"]
    )
    assert set(ours) == set(theirs)
    for name in ours:
        np.testing.assert_array_equal(
            ours[name].float().numpy(), np.asarray(theirs[name], np.float32)
        )
