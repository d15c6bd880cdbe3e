"""The port's kernel A/B script, on the CPU: what it can do without a card."""

from pathlib import Path

import pytest
import torch

from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention_reference
from k8s_operator_libs_tpu_torch.ops.matmul import matmul_reference
from k8s_operator_libs_tpu_torch.tools import kernel_ab

REPO = Path(__file__).resolve().parents[1]


def test_a_second_copy_of_the_port_loads_beside_the_first():
    """The other checkout's wrappers come from its own files under an alias,
    and on CPU tensors they compute what this checkout's plain versions do."""
    other_mm, other_fa = kernel_ab._load_port(REPO, "ab_test_port")
    assert other_mm.__module__ == "ab_test_port.ops.matmul"
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(8, 16, generator=gen), torch.randn(16, 4, generator=gen)
    torch.testing.assert_close(other_mm(a, b), matmul_reference(a, b))
    q = torch.randn(1, 2, 8, 4, generator=gen)
    torch.testing.assert_close(other_fa(q, q, q), flash_attention_reference(q, q, q))


def test_without_a_card_it_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--other", str(REPO)]) == 1
    assert capsys.readouterr().out == ""


def test_it_needs_the_other_checkout():
    with pytest.raises(SystemExit):
        kernel_ab.main([])
