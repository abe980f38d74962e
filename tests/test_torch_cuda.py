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


def _fold_in_batch(k, rows=600, n=400):
    import numpy as np

    rng = np.random.default_rng(k)
    y = rng.standard_normal((n, k)).astype(np.float32) / k ** 0.5
    idx = [rng.choice(n, int(rng.integers(0, 2 * k)), replace=False)
           for _ in range(rows)]
    val = [(rng.integers(1, 11, len(ix)) / 2.0).astype(np.float32)
           for ix in idx]
    anchor = rng.standard_normal((rows, k)).astype(np.float32) / k ** 0.5
    return y, idx, val, anchor


@pytest.mark.parametrize("k,kernel", [(32, "warp"), (128, "wide")])
@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_launches_the_kernel(card, k, kernel, implicit):
    """A fold-in on the card is one launch of the kernel for k, and agrees
    with the CPU's plain solve."""
    import numpy as np

    from incubator_predictionio_torch.ops import als

    y, idx, val, anchor = _fold_in_batch(k)
    kw = dict(reg=0.1, lambda_scaling="nratings", implicit_prefs=implicit,
              alpha=0.5, anchor=anchor, anchor_weight=1.0)
    counter = {"warp": spd_solve.gauss_jordan_warp_launches,
               "wide": spd_solve.gauss_jordan_wide_launches}[kernel]
    before, total = counter.count, spd_solve.gauss_jordan_launches.count
    on_card = als.fold_in_factors(y, idx, val, device=card, **kw)
    assert counter.count == before + 1
    assert spd_solve.gauss_jordan_launches.count == total + 1
    on_cpu = als.fold_in_factors(y, idx, val, device="cpu", **kw)
    np.testing.assert_allclose(on_card, on_cpu, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("binary", [False, True])
def test_implicit_als_card_matches_cpu(card, binary):
    """Implicit ALS (the shared YᵀY term and the confidence weights) on the
    card against the CPU's plain solve."""
    import numpy as np

    from incubator_predictionio_torch.ops import als

    rng = np.random.default_rng(3)
    u = rng.integers(0, 300, 6000).astype(np.int32)
    i = np.minimum((200 * rng.random(6000) ** 2).astype(np.int32), 199)
    r = (np.ones(6000, np.float32) if binary
         else rng.integers(1, 6, 6000).astype(np.float32))
    params = als.ALSParams(rank=32, num_iterations=3, reg=0.05,
                           implicit_prefs=True, alpha=1.0)
    before = spd_solve.gauss_jordan_warp_launches.count
    f_card = als.train_als(u, i, r, 300, 200, params, device=card)
    assert spd_solve.gauss_jordan_warp_launches.count > before
    f_cpu = als.train_als(u, i, r, 300, 200, params, device="cpu")
    np.testing.assert_allclose(f_card.user_factors, f_cpu.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(f_card.item_factors, f_cpu.item_factors,
                               rtol=TOL, atol=TOL)
