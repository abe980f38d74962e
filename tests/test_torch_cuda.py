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


@pytest.mark.parametrize("n_items", [10_003, 1_000_000])
def test_host_sharded_single_query_bit_identical_on_the_card(card, n_items):
    """Host-sharded serving on the card: single-query answers
    bit-identical to the flat catalog's, batched answers index-identical
    (8 shards, rank 32)."""
    import numpy as np

    from incubator_predictionio_torch.ops import sharded_topk, topk

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n_items)
    items = rng.normal(size=(n_items, 32)).astype(np.float32)
    flat = torch.from_numpy(items).to(card)
    cat = sharded_topk.put_host_sharded_catalog(items, -(-n_items // 8),
                                                card)
    assert cat.n_shards == 8
    for j in range(10):
        uv = rng.normal(size=32).astype(np.float32)
        exclude = rng.random(n_items) < 0.3 if j % 2 else None
        s0, i0 = topk.top_k_items(uv, flat, 50, exclude=exclude)
        s1, i1 = sharded_topk.host_sharded_top_k_items(uv, cat, 50,
                                                       exclude=exclude)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(s0, s1)
    uvs = rng.normal(size=(64, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        topk.batch_top_k(uvs, flat, 10)[1],
        sharded_topk.host_sharded_batch_top_k(uvs, cat, 10)[1])


@pytest.mark.parametrize("where", ["item_rows", "user_vector"])
def test_host_sharded_nan_on_the_card(card, monkeypatch, where):
    """NaN under the host layout on the card: NaN item rows (more than
    ``k`` in one shard) and a NaN user vector give the flat answer, and a
    NaN Recommendation model deployed host-sharded is refused by the swap
    gate for its non-finite values. No device-side assert: the card keeps
    answering afterwards."""
    import numpy as np

    from incubator_predictionio_torch.controller import EngineParams
    from incubator_predictionio_torch.controller.engine import Deployment
    from incubator_predictionio_torch.data.bimap import BiMap
    from incubator_predictionio_torch.models import recommendation as rec
    from incubator_predictionio_torch.ops import sharded_topk, topk
    from incubator_predictionio_torch.workflow.context import (
        WorkflowContext,
    )
    from incubator_predictionio_torch.workflow.create_server import (
        EngineServer, SwapValidationError,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    n_items, rank = 10_003, 32
    rng = np.random.default_rng(5)
    items = rng.normal(size=(n_items, rank)).astype(np.float32)
    users = rng.normal(size=(6, rank)).astype(np.float32)
    if where == "item_rows":
        items[1200:1260] = np.nan  # a NaN threshold in shard 0
        items[[3, 7000]] = np.nan
    else:
        users[0] = np.nan
    cat = sharded_topk.put_host_sharded_catalog(items, -(-n_items // 8),
                                                card)
    flat = torch.from_numpy(items).to(card)
    for uv in users:
        for exclude in (None, rng.random(n_items) < 0.3):
            got = sharded_topk.host_sharded_top_k_items(uv, cat, 50,
                                                        exclude=exclude)
            want = topk.top_k_items(uv, flat, 50, exclude=exclude)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        sharded_topk.host_sharded_batch_top_k(users, cat, 10)[1],
        topk.batch_top_k(users, flat, 10)[1])

    monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", str(-(-n_items // 8)))
    stored = {"user_factors": users, "item_factors": items,
              "users": BiMap({f"u{j}": j for j in range(6)}).to_persisted(),
              "items": BiMap({f"i{j}": j
                              for j in range(n_items)}).to_persisted()}
    good = dict(stored, user_factors=np.nan_to_num(users),
                item_factors=np.nan_to_num(items))
    _, _, algos, serving = rec.RecommendationEngine()().make_components(
        EngineParams.from_json({"datasource": {"params": {
            "app_name": "app"}}, "algorithms": [{"name": "als", "params": {
                "rank": rank, "numIterations": 1, "lambda": 0.01}}]}))
    algo = algos[0][1]
    ctx = WorkflowContext(device=str(card))
    live = algo.restore_model(good, ctx)
    server = EngineServer(deployment=Deployment(algos, [live], serving),
                          device=str(card))
    nan_dep = Deployment(algos, [algo.restore_model(stored, ctx)], serving)
    with pytest.raises(SwapValidationError) as refused:
        server._prepare(nan_dep, "nan-instance", None)
    assert "non-finite" in refused.value.reason
    assert "warm-up failed" not in refused.value.reason
    assert nan_dep.models[0].catalog().layout == "host"
    torch.cuda.synchronize()
    assert algo.predict(live, {"user": "u1", "num": 5})["itemScores"]
