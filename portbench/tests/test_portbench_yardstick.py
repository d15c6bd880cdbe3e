"""The frozen yardstick: the roofline counts against hand-worked shapes,
the plain reference against the port at small sizes on the CPU, the
control against the limits, the device trace's arithmetic and the import
guard."""

from __future__ import annotations

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import checks, devtrace, roofline, run, spec
from portbench.reference import attention, burnin, inputs, matmul


def test_bound_by_bytes_and_by_operations():
    # 1024^3, bf16 in and f32 out: 2+2+4 MiB = 8388608 bytes over 3.35 TB/s
    # (2.504 us) against 2.147e9 FLOPs over 989 TFLOP/s (2.171 us).
    flops, nbytes = roofline.matmul_work(1024, 1024, 1024)
    assert flops == 2 * 1024**3 and nbytes == 8 * 1024 * 1024
    seconds, by = roofline.bound(flops, nbytes)
    assert by == "bytes" and seconds == pytest.approx(8388608 / 3.35e12)
    flops, nbytes = roofline.matmul_work(4096, 4096, 4096)
    seconds, by = roofline.bound(flops, nbytes)
    assert by == "operations" and seconds == pytest.approx(2 * 4096**3 / 989e12)


def test_attention_and_probe_work():
    # (1, 4, 1024, 128) causal: 1024*1025/2 pairs, 4*d FLOPs a pair and
    # head; q, k, v and the output once in bf16: 4 MiB.
    flops, nbytes = roofline.attention_work(1, 4, 1024, 128, causal=True)
    assert flops == 4 * 4 * 128 * 1024 * 1025 / 2 and nbytes == 4 * 4 * 1024 * 128 * 2
    assert roofline.attention_work(1, 4, 1024, 128, causal=False)[0] == 4 * 4 * 128 * 1024**2
    # The shipped probe: the checked product and 3 timed chains of 1164
    # links after one warm-up chain: 4657 products.
    assert roofline.mxu_probe_products(1024, 1164, 3) == 4657
    flops, nbytes = roofline.mxu_probe_work(1024, 1164, 3)
    assert flops == 4657 * 2 * 1024**3
    assert roofline.share_percent((flops, nbytes), roofline.bound(flops, nbytes)[0]) == (
        pytest.approx(100.0))


def test_reference_matmul_against_the_ports_plain_product():
    from k8s_operator_libs_tpu_torch.ops.matmul import matmul as port_matmul

    a, b = inputs.matmul_operands(7, 128)
    port = port_matmul(torch.from_numpy(a).to(torch.bfloat16),
                       torch.from_numpy(b).to(torch.bfloat16))
    assert checks.rel_err(port.numpy(), matmul.product(a, b)) < 1e-5


def test_reference_attention_against_the_ports_plain_attention():
    from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = inputs.attention_operands(7, (1, 2, 128, 64))
    port = flash_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert checks.rel_err(port.float().numpy(), attention.attention(q, k, v)) < 0.015


def test_reference_burnin_against_the_ports_train_step():
    from k8s_operator_libs_tpu_torch.models.burnin import BurninConfig, train_step

    cfg = BurninConfig(d_model=64, n_heads=4, d_ff=128, n_layers=1, seq_len=32, batch=2)
    for seed in (1, 2**31 + 9):
        params = inputs.burnin_params(seed, 512, 64, 128, 1)
        tokens = inputs.burnin_tokens(seed, 512, 2, 32)
        t = torch.from_numpy(tokens)
        batch = {"tokens": t, "targets": torch.roll(t, -1, dims=-1)}
        port, p = [], params
        for _ in range(2):
            p, loss = train_step(p, batch, cfg)
            port.append(float(loss))
        loss_err, drop_err = checks.loss_errs(port, burnin.losses(params, tokens, 4))
        assert loss_err < 1.5e-3 and drop_err < 0.2


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_reference_chain_against_the_ports_chain_and_its_control(seed):
    """The matmul probe's chain, through the port's own chain function
    (its plain product, 200 links at n 128), against the float64 chain;
    the float8 control reads far above the limit."""
    from k8s_operator_libs_tpu_torch.ops import matmul as port_matmul

    limits = spec.config(spec.load_benchmark(), {"config": "gpu_node_gate"})["limits"]
    a, b = inputs.matmul_operands(seed, 128)
    ref = matmul.chain(a, b, 200)
    a_lp = torch.from_numpy(a).to(torch.bfloat16)
    step = torch.from_numpy(b / np.sqrt(128)).to(torch.bfloat16)
    port = float(port_matmul._chained_matmul(a_lp, step, 200, use_pallas=False))
    assert abs(port - ref[0, 0]) / np.max(np.abs(ref)) < 1e-3
    assert checks.rel_err(matmul.chain_control(a, b, 200), ref) > limits["k1_chain_rel_err"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails_the_limits(seed):
    """The reference in the precision below the configuration's, in the
    port's place, reads above each limit (at small sizes here; the card's
    readings at the cell's size are in PERF.md)."""
    limits = spec.config(spec.load_benchmark(), {"config": "gpu_node_gate"})["limits"]
    a, b = inputs.matmul_operands(seed, 256)
    assert checks.rel_err(matmul.control(a, b), matmul.product(a, b)) > limits["k1_rel_err"]
    q, k, v = inputs.attention_operands(seed, (1, 4, 256, 128))
    assert (checks.rel_err(attention.control(q, k, v), attention.attention(q, k, v))
            > limits["k2_rel_err"])
    params = inputs.burnin_params(seed, 512, 64, 128, 1)
    tokens = inputs.burnin_tokens(seed, 512, 2, 32)
    loss_err, drop_err = checks.loss_errs(burnin.losses(params, tokens, 4, control=True),
                                          burnin.losses(params, tokens, 4))
    assert loss_err > limits["burnin_loss_err"] or drop_err > limits["burnin_drop_err"]


def test_inputs_follow_the_seed_alone():
    big = 2**31 + 12345
    assert np.array_equal(inputs.matmul_operands(big, 64)[0], inputs.matmul_operands(big, 64)[0])
    assert not np.array_equal(inputs.matmul_operands(1, 64)[0], inputs.matmul_operands(2, 64)[0])
    assert inputs.stream(big, "a") != inputs.stream(big, "b")


def test_verdict_and_missing_outputs():
    ok, table = checks.verdict({"x": 1.0, "y": 0.0}, {"x": 2.0, "y": 0})
    assert ok and table["x"] == {"value": 1.0, "limit": 2.0}
    assert not checks.verdict({"x": math.inf}, {"x": 2.0})[0]
    assert checks.rel_err(None, np.ones(3)) == math.inf
    assert checks.loss_errs(None, [1.0, 0.5]) == (math.inf, math.inf)
    assert checks.loss_errs([1.0, 1.0], [1.0, 0.5])[1] == 1.0
    with pytest.raises(KeyError):
        checks.verdict({"z": 1.0}, {})


def test_device_trace_union_gaps_and_kernel_time():
    s = 1_000_000_000
    main = {
        "ranges": [("portbench.window", 0, 10 * s), ("portbench.probe.mxu", 1 * s, 4 * s),
                   ("portbench.probe.flash", 5 * s, 9 * s)],
        "device": [("k1", 1 * s, 3 * s, 0), ("cast", 2 * s, 4 * s, 0),
                   ("Memcpy HtoD", 5 * s, 6 * s, 0)],
    }
    rank = {"ranges": [], "device": [("burnin", 19 * s // 2, 12 * s, 0)]}
    trace = devtrace.merge(main, [rank], cards=1)
    # Busy: 1-4, 5-6 and 9.5-10 (clipped to the window).
    assert trace.window_s == 10 and trace.busy_s == pytest.approx(4.5)
    assert trace.idle_share() == pytest.approx(0.55)
    assert trace.kernel_s_in("probe.mxu") == 4.0
    assert trace.kernel_s_in("probe.flash") == 0.0  # the copy is no kernel
    assert trace.kernel_s_in("probe.burnin") is None
    # Each gap goes whole to the range around its middle: 0-1 and 4-5 lie
    # outside the probes' ranges, 6-9.5 in the flash one.
    assert dict(trace.idle_gaps) == {"outside_spans": 2.0, "probe.flash": 3.5}
    assert [name for name, _ in trace.ops] == ["k1", "cast", "Memcpy HtoD", "burnin"]


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["k8s_operator_libs_tpu_torch.ops", "numpy"]) == []
    assert run.forbidden_modules(["k8s_operator_libs_tpu.ops.matmul"]) == ["k8s_operator_libs_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_the_harness_loads_no_jax():
    """Everything a run imports, in a fresh interpreter: no JAX, no JAX
    package."""
    code = (
        "import sys, portbench.run, portbench.drivers.gate, portbench.drivers.roll, "
        "portbench.calibrate, portbench.devtrace\n"
        "import k8s_operator_libs_tpu_torch.tpu.health, k8s_operator_libs_tpu_torch.upgrade\n"
        "import k8s_operator_libs_tpu_torch.kube.fake, k8s_operator_libs_tpu_torch.kube.cache\n"
        "from portbench import spec\n"
        "bench = spec.load_benchmark()\n"
        "[spec.reader(m['name']) for m in bench['per_layer']]\n"
        "print(portbench.run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_cards(tmp_path):
    """No result and a non-zero exit where CUDA has no card, and in a
    directory that holds only BENCHMARK.json and the benchmark's files."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "gpu_node_gate.revalidate", "--seed", "1", "--seconds", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil

    shutil.copytree(spec.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "gpu_node_gate.revalidate", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
