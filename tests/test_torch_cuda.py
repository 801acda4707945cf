"""Card-only tests of repro_torch: the CUDA order-statistics kernel
against its plain version, and the slice on the card against the slice on
the CPU. Each test decides inside itself whether a card is present and
skips where there is none. This file imports neither jax nor repro, so it
also runs where JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.agg import kernel
from repro_torch.configs.base import ProtocolConfig
from repro_torch.core.losses import get_problem
from repro_torch.core.protocol import DPQNProtocol, transmission_names
from repro_torch.data.synthetic import make_shards

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ostat kernel has no CPU form")
    return torch.device("cuda")


def _p999_rel(got, ref):
    """99.9th percentile of |err| / max(1, |ref|) (CQ knot ties flip
    single indicators, so the sum-based ops are gated on it)."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    return float(np.quantile(np.abs(got - ref) / np.maximum(1.0, np.abs(ref)),
                             0.999))


@pytest.mark.parametrize("op", kernel.OPS)
def test_kernel_matches_plain_version(cuda, op):
    g = torch.Generator(device=cuda).manual_seed(0)
    # ragged p, odd and even m, and an m whose slab exceeds shared memory
    for shape in ((320, 8, 10), (20, 51, 10), (1, 8, 4099), (2, 1000, 130)):
        v = torch.randn(shape, generator=g, device=cuda)
        sc = torch.rand((shape[0], shape[2]), generator=g, device=cuda) + 0.1
        sc = sc if op == "dcq" else None
        before = kernel.launches
        got = kernel.ostat(v, op, sc, kth=2)
        assert kernel.launches == before + 1
        ref = kernel.ostat_plain(v, op, sc, kth=2)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(got, ref):
            if op in ("kth", "median"):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
            else:
                assert _p999_rel(a, b) <= 1e-5


def test_kernel_keeps_dtype_and_layout(cuda):
    v = torch.randn((2, 3, 7, 5), device=cuda, dtype=torch.float64)
    out = kernel.ostat(v, "median")
    assert out.dtype == torch.float64 and out.shape == (2, 3, 5)
    torch.testing.assert_close(out, kernel.ostat_plain(v, "median"),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="scale on"):
        kernel.ostat(v, "dcq", torch.ones((2, 3, 5), dtype=torch.float64))


def test_slice_on_the_card_matches_the_cpu(cuda):
    m, n, p, reps = 7, 200, 5, 3
    gen = torch.Generator().manual_seed(4)
    X, y = make_shards(gen, "logistic", m, n, p)
    cfg = ProtocolConfig()
    noise = {name: torch.randn((reps, m + 1, p), generator=gen)
             for name in transmission_names(cfg)}
    prob = get_problem("logistic")
    before = kernel.launches
    card = DPQNProtocol(prob, cfg).run_monte_carlo(reps, X, y, noise=noise)
    assert kernel.launches == before + 8
    cpu = DPQNProtocol(prob, cfg, device="cpu").run_monte_carlo(
        reps, X, y, noise=noise)
    for f in ("theta_cq", "theta_os", "theta_qn"):
        torch.testing.assert_close(getattr(card, f).cpu(), getattr(cpu, f),
                                   atol=1e-4, rtol=1e-4)
