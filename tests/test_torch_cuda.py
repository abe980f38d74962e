"""The CUDA Gauss-Jordan kernel against its plain PyTorch version, on the
card. Marked ``cuda``: skipped where ``torch.cuda.is_available()`` is
False (the decision is made inside the fixture, never at import). Run on a
GPU machine with ``python -m pytest tests/test_torch_cuda.py``;
``python3 chip_smoke.py`` runs the same checks and more.
"""

import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_torch.ops import spd_solve  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 2e-4


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k", [(5, 10), (300, 32), (130, 7), (1, 1),
                                 (513, 16), (40, 80), (24, 128), (9, 100),
                                 (511, 8), (513, 8), (1025, 8)])
def test_kernel_matches_plain(card, n, k):
    g = torch.Generator(device=card).manual_seed(n + k)
    m = torch.randn((n, k, k), generator=g, device=card)
    a = torch.bmm(m, m.transpose(1, 2)) + torch.eye(k, device=card)
    b = torch.randn((n, k), generator=g, device=card)
    before = spd_solve.gauss_jordan_launches.count
    x = spd_solve.batched_spd_solve(a, b)
    torch.cuda.synchronize()
    assert spd_solve.gauss_jordan_launches.count == before + 1
    torch.testing.assert_close(x, spd_solve.gauss_jordan_plain(a, b),
                               rtol=TOL, atol=TOL)
