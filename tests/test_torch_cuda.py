"""The CUDA Gauss-Jordan kernels against their plain PyTorch version, on the
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
#: every K the wide kernel is built for, each at batches around its grid
WIDE_CASES = [(n, k) for k in range(40, 129, 8) for n in (1, 511, 513, 4096)]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _random_spd(card, n, k):
    g = torch.Generator(device=card).manual_seed(n + k)
    m = torch.randn((n, k, k), generator=g, device=card)
    a = torch.bmm(m, m.transpose(1, 2)) + torch.eye(k, device=card)
    b = torch.randn((n, k), generator=g, device=card)
    return a, b


@pytest.mark.parametrize("n,k", [(5, 10), (300, 32), (130, 7), (1, 1),
                                 (513, 16), (40, 80), (24, 128), (9, 100),
                                 (511, 8), (513, 8), (1025, 8)] + WIDE_CASES)
def test_kernel_matches_plain(card, n, k):
    a, b = _random_spd(card, n, k)
    before = spd_solve.gauss_jordan_launches.count
    x = spd_solve.batched_spd_solve(a, b)
    torch.cuda.synchronize()
    assert spd_solve.gauss_jordan_launches.count == before + 1
    torch.testing.assert_close(x, spd_solve.gauss_jordan_plain(a, b),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,kernel", [(8, "warp"), (32, "warp"),
                                      (40, "wide"), (100, "wide"),
                                      (128, "wide")])
def test_launch_counters_name_the_kernel(card, k, kernel):
    """k ≤ 32 ticks the warp kernel's counter, 32 < k ≤ 128 the wide
    kernel's; the total counts both."""
    a, b = _random_spd(card, 64, k)
    counters = {"warp": spd_solve.gauss_jordan_warp_launches,
                "wide": spd_solve.gauss_jordan_wide_launches}
    before = {name: c.count for name, c in counters.items()}
    total = spd_solve.gauss_jordan_launches.count
    spd_solve.batched_spd_solve(a, b)
    torch.cuda.synchronize()
    for name, c in counters.items():
        assert c.count == before[name] + (name == kernel)
    assert spd_solve.gauss_jordan_launches.count == total + 1
