"""The port's matmul probe against the JAX package's, on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py); here the
wrapper takes its plain version, which is held against the Pallas kernel in
interpret mode on the same numpy inputs.
"""

import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.ops.matmul import matmul as jax_matmul
from k8s_operator_libs_tpu.ops.matmul import mxu_probe as jax_mxu_probe
from k8s_operator_libs_tpu_torch.ops import _build
from k8s_operator_libs_tpu_torch.ops import matmul as port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from a thread per core, and the suite runs
    several workers side by side with timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(m, k, n, seed=3):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((m, k), dtype=np.float32),
        rng.standard_normal((k, n), dtype=np.float32),
    )


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (256, 512, 256)])
def test_plain_version_matches_pallas_interpret(m, k, n):
    a, b = _operands(m, k, n)
    want = np.asarray(
        jax_matmul(
            jnp.asarray(a).astype(jnp.bfloat16),
            jnp.asarray(b).astype(jnp.bfloat16),
            interpret=True,
        )
    )
    got = port.matmul(
        torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    # bf16 products are exact in f32; only the summation order differs.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.sqrt(k))


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    a, b = _operands(32, 48, 16)
    before = port.matmul.launches
    got = port.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert port.matmul.launches == before
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "a_shape,b_shape",
    [((4, 5), (6, 7)), ((4,), (4, 2)), ((2, 3, 4), (4, 2))],
)
def test_wrapper_rejects_bad_shapes(a_shape, b_shape):
    with pytest.raises(ValueError):
        port.matmul(torch.zeros(a_shape), torch.zeros(b_shape))


def test_wrapper_rejects_mixed_dtypes():
    with pytest.raises(ValueError):
        port.matmul(torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_probe_ok_on_cpu(use_pallas):
    report = port.mxu_probe(device="cpu", size=256, iters=1, use_pallas=use_pallas)
    assert report.ok, report.error
    assert report.tflops > 0
    assert report.max_abs_err <= 1e-2 * 256**0.5


def test_probe_verdict_matches_jax():
    ours = port.mxu_probe(device="cpu", size=256, iters=1)
    theirs = jax_mxu_probe(size=256, use_pallas=True, interpret=True, iters=1)
    assert ours.ok and theirs.ok
    assert set(vars(ours)) == set(vars(theirs))


def test_probe_takes_the_wrapper_at_sizes_that_do_not_tile(monkeypatch):
    """The JAX probe drops to the XLA dot for sizes that are not multiples
    of 256; the port's kernel masks ragged edges, so the wrapper runs."""
    calls = []
    real = port.matmul

    def spy(a, b):
        calls.append(tuple(a.shape))
        return real(a, b)

    monkeypatch.setattr(port, "matmul", spy)
    report = port.mxu_probe(device="cpu", size=200, iters=1)
    assert report.ok, report.error
    assert calls and all(shape == (200, 200) for shape in calls)


def test_probe_reports_wrong_numerics(monkeypatch):
    monkeypatch.setattr(port, "matmul", lambda a, b: port.matmul_reference(a, b) + 1.0)
    report = port.mxu_probe(device="cpu", size=64, iters=1)
    assert not report.ok and "numerics mismatch" in report.error


def test_probe_crash_is_a_failed_report(monkeypatch):
    def boom(a, b):
        raise RuntimeError("tensor cores on fire")

    monkeypatch.setattr(port, "matmul", boom)
    report = port.mxu_probe(device="cpu", size=64, iters=1)
    assert not report.ok and "on fire" in report.error


def test_probe_cache_is_keyed_by_size_dtype_device():
    port.mxu_probe(device="cpu", size=96, iters=1)
    port.mxu_probe(device="cpu", size=96, iters=1, use_pallas=False)
    keys = [k for k in port._PROBE_CACHE if k[0] == 96]
    assert keys == [(96, str(torch.bfloat16), "cpu")]


def test_probe_inputs_follow_the_numpy_seed():
    entry = port._probe_entry(64, torch.bfloat16, torch.device("cpu"))
    a_lp, b_lp, b_scaled, reference = entry.inputs
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64), dtype=np.float32)
    b = rng.standard_normal((64, 64), dtype=np.float32)
    np.testing.assert_array_equal(a_lp.float().numpy(), np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(b_lp.float().numpy(), np.asarray(jnp.asarray(b).astype(jnp.bfloat16), np.float32))
    np.testing.assert_allclose(reference, a_lp.float().numpy() @ b_lp.float().numpy(), rtol=1e-6)
    assert b_scaled.dtype == torch.bfloat16


@pytest.mark.parametrize("size", [16, 64, 256, 1024, 2048, 4096, 16384])
def test_auto_chain_stays_bounded(size):
    chain = port._auto_chain(size, on_accel=True)
    assert 16 <= chain <= port._CHAIN_MAX
    assert port._auto_chain(size, on_accel=False) == 1


def test_chain_keeps_its_data_dependency():
    a, b = _operands(32, 32, 32, seed=5)
    a_t = torch.from_numpy(a).to(torch.bfloat16)
    b_t = torch.from_numpy(b / np.sqrt(32)).to(torch.bfloat16)
    acc = a_t.float()
    for _ in range(3):
        acc = acc.to(torch.bfloat16).float() @ b_t.float()
    got = port._chained_matmul(a_t, b_t, chain=3, use_pallas=True)
    assert float(got) == pytest.approx(float(acc[0, 0]), rel=1e-5, abs=1e-6)


def test_chain_length_at_the_gate_size():
    # 2.5e12 FLOP over 2 * 1024^3 a link.
    assert port._auto_chain(1024, on_accel=True) == 1164


def test_cpu_probe_runs_the_plain_loop_and_captures_no_graph(monkeypatch):
    def no_graph(*args):
        raise AssertionError("the CPU path captures no CUDA graph")

    runs = []
    real = port._chained_matmul

    def spy(a, b, chain, use_pallas):
        runs.append(chain)
        return real(a, b, chain, use_pallas)

    monkeypatch.setattr(port, "_chain_graph", no_graph)
    monkeypatch.setattr(port, "_chained_matmul", spy)
    report = port.mxu_probe(device="cpu", size=64, iters=3)
    assert report.ok, report.error
    assert runs == [1] * 4  # the warm-up and three timed runs, one link each
    assert port._PROBE_CACHE[(64, str(torch.bfloat16), "cpu")].chains == {}


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_counts_the_launches_the_graph_holds():
    graph = _FakeGraph()
    before, before_path = port.matmul.launches, port.matmul.path_launches["wgmma_128x64"]
    port._replay_chain(port._ChainGraph(graph, Counter(wgmma_128x64=7)))
    assert graph.replays == 1 and port.matmul.launches == before + 7
    assert port.matmul.path_launches["wgmma_128x64"] == before_path + 7


@pytest.mark.parametrize("held", [5, 3])
def test_capture_keeps_the_count_the_wrapper_made(monkeypatch, held):
    """A captured chain holds what the wrapper counted while capturing, not
    the chain length it was asked for: a graph that took a different number
    of launches replays that number."""

    class _Capture:
        def __init__(self, graph):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    capturing = []

    def fake_chain(a, b, chain, use_pallas):
        if capturing:
            port.matmul.captured["wgmma_128x64"] += held
        capturing.append(True)

    monkeypatch.setattr(port, "_chained_matmul", fake_chain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    entry = port._ProbeEntry((torch.zeros(2, 2), None, torch.zeros(2, 2), None))
    chain_graph, captured = port._chain_graph(entry, chain=5, use_pallas=True)
    assert captured and capturing == [True, True]  # warm-up, then the capture
    assert chain_graph.launches == Counter(wgmma_128x64=held)
    assert port._chain_graph(entry, chain=5, use_pallas=True) == (chain_graph, False)
    assert entry.chains == {(5, True): chain_graph}


@pytest.mark.parametrize("captured", [True, False])
def test_chain_runner_on_the_card_replays_the_captured_chain(monkeypatch, captured):
    """Through the kernel on the card each timed run is one replay. The
    warm-up is the run outside the capture when this call captured, else
    one replay, so a probe adds 1 + (iters + 1) * chain launches."""
    graph = _FakeGraph()
    chain_graph = port._ChainGraph(graph, Counter(wgmma_128x64=5))
    monkeypatch.setattr(
        port, "_chain_graph", lambda entry, chain, use_pallas: (chain_graph, captured)
    )
    a = torch.zeros(4, 4, dtype=torch.bfloat16)
    entry = port._ProbeEntry((a, a, a, None))
    before = port.matmul.launches
    run = port._chain_runner(entry, chain=5, use_pallas=True, on_accel=True)
    warm = 0 if captured else 1
    assert graph.replays == warm and port.matmul.launches == before + 5 * warm
    for _ in range(3):
        run()
    assert graph.replays == warm + 3 and port.matmul.launches == before + 5 * (warm + 3)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_chain_runner_keeps_the_plain_loop_without_the_kernel(monkeypatch, use_pallas):
    """Off the card there is no graph to capture: each timed run is the
    loop itself, through the kernel's plain version or the plain product."""

    def no_graph(*args):
        raise AssertionError("the CPU captures no CUDA graph")

    monkeypatch.setattr(port, "_chain_graph", no_graph)
    a, b = _operands(16, 16, 16, seed=6)
    a_t = torch.from_numpy(a).to(torch.bfloat16)
    b_t = torch.from_numpy(b / 4).to(torch.bfloat16)
    entry = port._ProbeEntry((a_t, None, b_t, None))
    run = port._chain_runner(entry, chain=3, use_pallas=use_pallas, on_accel=False)
    want = port._chained_matmul(a_t, b_t, 3, use_pallas=False)
    assert float(run()) == float(want)


def test_chain_runner_on_the_card_captures_the_plain_chain_too(monkeypatch):
    """The plain product's chain is one graph replay on the card as well, so
    the quick battery's rate is the card's and not the host's dispatch."""
    graph = _FakeGraph()
    asked = []

    def fake_graph(entry, chain, use_pallas):
        asked.append((chain, use_pallas))
        return port._ChainGraph(graph, Counter()), True

    monkeypatch.setattr(port, "_chain_graph", fake_graph)
    a = torch.zeros(4, 4, dtype=torch.bfloat16)
    entry = port._ProbeEntry((a, a, a, None))
    before = port.matmul.launches
    run = port._chain_runner(entry, chain=7, use_pallas=False, on_accel=True)
    run()
    assert asked == [(7, False)] and graph.replays == 1
    # The plain product launches no kernel of ours, so nothing is counted.
    assert port.matmul.launches == before


def test_probe_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.mxu_probe(size=64)


def test_build_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        _build.build()
    with pytest.raises(RuntimeError):
        _build.load("matmul")


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_c_entry_points_match_their_ctypes_signatures(lib):
    """What ctypes declares is what the source exports: the name and the
    number of arguments of each entry point, plus the error-string hook."""
    source = (_build.CSRC / f"{lib}.cu").read_text()
    for name, argtypes in _build.SIGNATURES[lib].items():
        match = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
        assert match, f"{name} missing from {lib}.cu"
        assert len(match.group(1).split(",")) == len(argtypes)
    assert 'extern "C" const char* kernel_error_string(int' in source


def test_library_path_follows_the_source_digest():
    path = _build.library_path("matmul")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("matmul-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
