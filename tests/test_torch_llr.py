"""The port's CCO module (``incubator_predictionio_torch/ops/llr.py``) and the
codec's ``pair_dedupe`` / ``cco_partition`` on the CPU, against the JAX
reference (``incubator_predictionio_tpu/ops/llr.py``) on the same numpy
inputs made from a seed, at N ≤ 2,000 users:

- ``llr_scores`` on the reference test's known values and on random
  contingency tables, within ``tol = 2e-6·N·ln N`` of the reference's;
- the layout: ``_partition_by_user``, and the codec's dedupe and partition
  against the reference's numpy paths, including the int32 layout past
  65,535 items, and no fallback when the codec cannot be built;
- the counts, exact against ``_full_cooccurrence`` and
  ``_cooccurrence_stripe``, with a ragged stripe and with the heavy-user
  path triggered (tests/test_linear_ops.py's bots);
- the top-k rule for ``cco_indicators`` and ``cco_indicators_multi``, and
  the full, striped, fused and per-pair paths bit-identical in the port;
- a tie row: equal (count, n_j) pairs keep the lower index first;
- ``score_user`` against the reference's;
- the device rule, the accumulator budget knob and the exactness bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cco_parity import dense_counts, g2_tol, hold_topk, reference_g2  # noqa: E402
from incubator_predictionio_tpu import native as ref_native  # noqa: E402
from incubator_predictionio_tpu.ops import llr as R  # noqa: E402
from incubator_predictionio_torch import native  # noqa: E402
from incubator_predictionio_torch.ops import llr as P  # noqa: E402


def _events(seed, n_users, n_items, n, skew=True):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n).astype(np.int32)
    i = (n_items * rng.random(n) ** (2 if skew else 1)).astype(np.int32)
    return u, np.minimum(i, n_items - 1)


def _bots(n_users=200, n_items=400):
    """tests/test_linear_ops.py:172's skewed setup: three bots with 900
    events each, far past heavy_cap."""
    rng = np.random.default_rng(7)
    pu = rng.integers(0, n_users, 2000).astype(np.int32)
    pi = rng.integers(0, n_items, 2000).astype(np.int32)
    for bot in (5, 50, 199):
        pu = np.concatenate([pu, np.full(900, bot, np.int32)])
        pi = np.concatenate([pi, rng.integers(0, n_items, 900)
                             .astype(np.int32)])
    su, si = pu[::-1].copy(), ((pi + 3) % n_items)[::-1].copy()
    return pu, pi, su, si, n_users, n_items


# -- G² ------------------------------------------------------------------------


def test_llr_scores_known_values():
    """tests/test_linear_ops.py:64: independence → 0, strong association
    → large, scipy's G-test on a table; each also equal to the reference
    within tol."""
    from scipy.stats import chi2_contingency

    assert float(P.llr_scores(25, 25, 25, 25)) < 1e-3
    assert float(P.llr_scores(50, 5, 5, 1000)) > 100
    table = np.array([[13.0, 7.0], [4.0, 76.0]])
    g, _, _, _ = chi2_contingency(table, correction=False,
                                  lambda_="log-likelihood")
    ours = float(P.llr_scores(*table.flatten()))
    np.testing.assert_allclose(ours, g, rtol=1e-5)
    for cells in ((25, 25, 25, 25), (50, 5, 5, 1000), tuple(table.flatten())):
        want = float(R.llr_scores(*[jnp.float32(v) for v in cells]))
        assert abs(float(P.llr_scores(*cells)) - want) <= g2_tol(sum(cells))


@pytest.mark.parametrize("n", [50, 500, 2000])
def test_llr_scores_random_counts_within_tol(n):
    rng = np.random.default_rng(n)
    n_i = rng.integers(0, n + 1, 4000)
    n_j = rng.integers(0, n + 1, 4000)
    lo = np.maximum(n_i + n_j - n, 0)
    k11 = (lo + rng.random(4000) * (np.minimum(n_i, n_j) - lo)).astype(int)
    cells = [k11, n_i - k11, n_j - k11, n - n_i - n_j + k11]
    cells = [np.asarray(c, np.float32) for c in cells]
    got = P.llr_scores(*[torch.from_numpy(c) for c in cells]).numpy()
    want = np.asarray(R.llr_scores(*[jnp.asarray(c) for c in cells]))
    assert np.abs(got - want).max() <= g2_tol(n)
    assert (got >= 0).all()


# -- layout --------------------------------------------------------------------


@pytest.mark.parametrize("u_chunk,n_items,assume_sorted", [
    (32, 90, False), (2048, 400, True), (7, 70_000, False),
    (70_000, 50, True)])
def test_partition_by_user_equals_reference(u_chunk, n_items, assume_sorted):
    n_users = 150 if u_chunk < 1000 else 140_000
    u, i = _events(1, n_users, n_items, 3000, skew=False)
    u[:3] = (-1, n_users + 5, 10 ** 7)  # out of range: dropped
    if assume_sorted:
        order = np.argsort(u, kind="stable")
        u, i = u[order], i[order]
    n_ranges = max((n_users + u_chunk - 1) // u_chunk, 1)
    got = P._partition_by_user(u, i, u_chunk, n_ranges, n_items,
                               assume_sorted=assume_sorted)
    want = R._partition_by_user(u, i, u_chunk, n_ranges, n_items,
                                assume_sorted=assume_sorted)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[1].dtype == (np.uint16 if n_items <= 0xFFFF else np.int32)


def _reference_numpy_dedupe(monkeypatch, u, i, n_users, n_items):
    def unavailable(*a, **k):
        raise ref_native.NativeUnavailable("the reference's numpy path")

    monkeypatch.setattr(ref_native, "pair_dedupe", unavailable)
    return R._dedupe_pair(u, i, n_users, n_items)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_pair_dedupe_equals_the_reference_numpy_path(monkeypatch, dtype):
    u, i = _events(2, 300, 120, 5000)
    u, i = u.astype(dtype), i.astype(dtype)
    u[:4] = (-1, 300, 2 ** 33 if dtype == np.int64 else 299, 4)
    i[:4] = (3, 3, 3, -7)
    got = native.pair_dedupe(u, i, 300, 120)
    want = _reference_numpy_dedupe(monkeypatch, u, i, 300, 120)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[0].dtype == np.int32 and got[2].dtype == np.int64
    empty = native.pair_dedupe(np.zeros(0, np.int32), np.zeros(0, np.int32),
                               5, 5)
    assert [len(a) for a in empty] == [0, 0, 5]
    with pytest.raises(ValueError, match="pair_dedupe"):
        native.pair_dedupe(u[:10], i[:9], 300, 120)


@pytest.mark.parametrize("heavy", [False, True])
def test_cco_partition_equals_the_reference_numpy_layout(heavy):
    pu, pi, _, _, n_users, n_items = _bots()
    du, di, per_user = native.pair_dedupe(pu, pi, n_users, n_items)
    rank, n_heavy = P._heavy_split(per_user, n_users)
    if not heavy:
        rank, n_heavy = None, 0
    assert (n_heavy > 0) == heavy
    u_chunk, n_ranges = 32, (n_users + 31) // 32
    h_ranges = max((n_heavy + 15) // 16, 1)
    light, hv, counts = native.cco_partition(
        du, di, rank, n_users, u_chunk, n_ranges, n_items, 16, h_ranges)
    lu, li, hu, hi = P._split_heavy(rank, du, di)
    want = R._partition_by_user(lu, li, u_chunk, n_ranges, n_items,
                                assume_sorted=True)
    for g, w in zip(light, want):
        assert g.dtype == w.dtype == np.uint16 and np.array_equal(g, w)
    if heavy:
        want_h = R._partition_by_user(hu, hi, 16, h_ranges, n_items,
                                      assume_sorted=True)
        for g, w in zip(hv, want_h):
            assert np.array_equal(g, w)
    else:
        assert hv is None
    assert np.array_equal(counts, np.bincount(di, minlength=n_items))
    with pytest.raises(ValueError, match="rank"):
        native.cco_partition(du, di, np.zeros(3, np.int32), n_users,
                             u_chunk, n_ranges, n_items, 16, h_ranges)
    with pytest.raises(ValueError, match="cco_partition"):
        native.cco_partition(du, di[:-1], None, n_users, u_chunk, n_ranges,
                             n_items, 16, h_ranges)


def test_int32_layout_past_65535_items():
    """Past the uint16 layout the fused path takes the int32 numpy layout
    (chosen on the shape before any call), equal to the reference's."""
    n_users, n_items = 300, 70_000
    u, i = _events(3, n_users, n_items, 4000, skew=False)
    i[:50] = 65_535 + np.arange(50)
    du, di, _ = native.pair_dedupe(u, i, n_users, n_items)
    assert not P._fits_uint16(64, n_items) and P._fits_uint16(64, 65_535)
    with pytest.raises(ValueError, match="uint16"):
        native.cco_partition(du, di, None, n_users, 64, 5, n_items, 16, 1)
    light, heavy, counts = P._partition_put(du, di, None, n_users, 64, 5,
                                            n_items, 1, torch.device("cpu"))
    assert heavy is None
    eu, ei = R._partition_by_user(du, di, 64, 5, n_items, assume_sorted=True)
    assert ei.dtype == np.int32
    want = eu.astype(np.int64) * n_items + ei.astype(np.int64)
    assert np.array_equal(light.flat.numpy(), want) and light.rows == 64
    assert np.array_equal(counts, np.bincount(di, minlength=n_items))


def test_no_fallback_when_the_codec_cannot_be_built(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    u, i = _events(4, 50, 20, 200)
    with pytest.raises(native.NativeUnavailable):
        native.pair_dedupe(u, i, 50, 20)
    with pytest.raises(native.NativeUnavailable):
        native.cco_partition(u, i, None, 50, 32, 2, 20, 16, 1)
    with pytest.raises(native.NativeUnavailable):
        P.cco_indicators(u, i, u, i, 50, 20, device="cpu")


# -- counts --------------------------------------------------------------------


def _reference_layout(pu, pi, su, si, n_users, n_items, u_chunk):
    """The reference cco_indicators' prep (llr.py:612-653): its light and
    heavy (eu, ei, eu, ei) slabs as jnp arrays."""
    pu, pi, cnt_p = R._dedupe_pair(pu, pi, n_users, n_items)
    su, si, cnt_s = R._dedupe_pair(su, si, n_users, n_items)
    n_ranges = max((n_users + u_chunk - 1) // u_chunk, 1)
    per_user = cnt_p + cnt_s
    cap = max(int(16 * max(float(per_user.sum()) / n_users, 1.0)), 256)
    heavy_users = np.nonzero(per_user > cap)[0]
    heavy = None
    if len(heavy_users):
        rank = np.full(n_users, -1, np.int64)
        rank[heavy_users] = np.arange(len(heavy_users))
        h_ranges = max((len(heavy_users) + 15) // 16, 1)

        def split(u, i):
            hm = rank[u] >= 0
            return u[~hm], i[~hm], rank[u[hm]].astype(np.int32), i[hm]

        pu, pi, hpu, hpi = split(pu, pi)
        su, si, hsu, hsi = split(su, si)
        heavy = tuple(jnp.asarray(a) for u, i in ((hpu, hpi), (hsu, hsi))
                      for a in R._partition_by_user(u, i, 16, h_ranges,
                                                    n_items,
                                                    assume_sorted=True))
    light = tuple(jnp.asarray(a) for u, i in ((pu, pi), (su, si)) for a in
                  R._partition_by_user(u, i, u_chunk, n_ranges, n_items,
                                       assume_sorted=True))
    return light, heavy


@pytest.mark.parametrize("data", ["random", "bots"])
def test_full_counts_exact_against_the_reference(data):
    if data == "bots":
        pu, pi, su, si, n_users, n_items = _bots()
    else:
        n_users, n_items = 900, 250
        pu, pi = _events(5, n_users, n_items, 6000)
        su, si = _events(6, n_users, n_items, 20000)
    u_chunk = 32
    light, heavy = _reference_layout(pu, pi, su, si, n_users, n_items,
                                     u_chunk)
    assert (heavy is not None) == (data == "bots")
    want = np.asarray(R._full_cooccurrence(
        light, heavy, n_items=n_items, u_chunk=u_chunk, h_chunk=16))
    got = P.cooccurrence_counts(pu, pi, {"s": (su, si), "self": (pu, pi)},
                                n_users, n_items, u_chunk, device="cpu")
    assert np.array_equal(got["s"].numpy(), want)
    c, _, _ = dense_counts(pu, pi, su, si, n_users, n_items)
    assert np.array_equal(got["s"].numpy(), c)
    c_self, _, _ = dense_counts(pu, pi, pu, pi, n_users, n_items)
    assert np.array_equal(got["self"].numpy(), c_self)


@pytest.mark.parametrize("data", ["random", "bots"])
def test_stripe_counts_exact_against_the_reference(data):
    """A ragged last stripe (its effective origin pulled back to the
    catalog edge) and the heavy ranges added to the light ones."""
    if data == "bots":
        pu, pi, su, si, n_users, n_items = _bots()
    else:
        n_users, n_items = 700, 230
        pu, pi = _events(7, n_users, n_items, 5000)
        su, si = _events(8, n_users, n_items, 9000)
    u_chunk, block = 64, 96
    light, heavy = _reference_layout(pu, pi, su, si, n_users, n_items,
                                     u_chunk)
    prim, secs, n_heavy, _ = P._fused_layout(
        pu, pi, {"s": (su, si)}, n_users, n_items, u_chunk,
        torch.device("cpu"), P._Clock(torch.device("cpu"), None))
    assert (n_heavy > 0) == (heavy is not None)
    _, _, lo_effs = P._stripes(n_items, block)
    assert lo_effs[-1] == n_items - block  # ragged
    for lo in lo_effs:
        want = np.asarray(R._cooccurrence_stripe(
            *light, lo, n_items=n_items, u_chunk=u_chunk, block=block))
        if heavy is not None:
            want = want + np.asarray(R._cooccurrence_stripe(
                *heavy, lo, n_items=n_items, u_chunk=16, block=block))
        c = torch.zeros((block, n_items))
        for part in (0, 1):
            if prim[part] is not None:
                P._accumulate([c], prim[part], [secs[0][part]], n_items, lo,
                              block)
        assert np.array_equal(c.numpy(), want), lo


# -- indicators ----------------------------------------------------------------


def _hold(ind, ref, pu, pi, su, si, n_users, n_items, thr=0.0):
    c, n_i, n_j = dense_counts(pu, pi, su, si, n_users, n_items)
    g = reference_g2(c, n_i, n_j, n_users)
    hold_topk(ind.idx, ind.score, np.where(ref.idx >= 0, ref.score, 0), g,
              g2_tol(n_users), thr)
    assert ind.idx.dtype == np.int32 and ind.score.dtype == np.float32
    assert ind.idx.shape == ref.idx.shape
    assert ((ind.idx >= 0) == (ind.score > 0)).all()


@pytest.mark.parametrize("case", ["random", "bots", "threshold", "ragged"])
def test_cco_indicators_meet_the_topk_rule(case):
    thr, block, k = 0.0, 4096, 8
    if case == "bots":
        pu, pi, su, si, n_users, n_items = _bots()
    else:
        n_users, n_items = 2000, 300
        pu, pi = _events(9, n_users, n_items, 8000)
        su, si = _events(10, n_users, n_items, 30000)
    if case == "threshold":
        thr = 3.0
    if case == "ragged":
        block, k = 128, 12
    kw = dict(max_correlators=k, llr_threshold=thr, u_chunk=128,
              item_block=block)
    ind = P.cco_indicators(pu, pi, su, si, n_users, n_items, device="cpu",
                           **kw)
    ref = R.cco_indicators(pu, pi, su, si, n_users, n_items, **kw)
    _hold(ind, ref, pu, pi, su, si, n_users, n_items, thr)
    if case == "threshold":
        assert (ind.score[ind.idx >= 0] >= thr).all()


def test_cco_indicators_multi_meets_the_topk_rule():
    n_users, n_items = 1500, 260
    pu, pi = _events(11, n_users, n_items, 6000)
    su, si = _events(12, n_users, n_items, 25000)
    secs = {"buy": (pu, pi), "view": (su, si)}
    tm = {}
    got = P.cco_indicators_multi(pu, pi, secs, n_users, n_items,
                                 max_correlators=10, u_chunk=256,
                                 device="cpu", timings=tm)
    want = R.cco_indicators_multi(pu, pi, secs, n_users, n_items,
                                  max_correlators=10, u_chunk=256)
    assert tm["path"] == "fused" and tm["gemms"] == 2 * 6
    assert {"dedupe_s", "partition_upload_s", "counts_ms",
            "g2_topk_ms"} <= set(tm)
    _hold(got["buy"], want["buy"], pu, pi, pu, pi, n_users, n_items)
    _hold(got["view"], want["view"], pu, pi, su, si, n_users, n_items)
    assert P.cco_indicators_multi(pu, pi, {}, n_users, n_items,
                                  device="cpu") == {}


@pytest.mark.parametrize("data", ["random", "bots"])
def test_full_striped_fused_and_per_pair_paths_are_bit_identical(
        monkeypatch, data):
    if data == "bots":
        pu, pi, su, si, n_users, n_items = _bots()
    else:
        n_users, n_items = 1200, 230
        pu, pi = _events(13, n_users, n_items, 7000)
        su, si = _events(14, n_users, n_items, 20000)
    tu, ti = _events(15, n_users, n_items, 9000)
    secs = {"buy": (pu, pi), "view": (su, si), "cart": (tu, ti)}
    kw = dict(max_correlators=9, u_chunk=64, item_block=100, device="cpu")
    runs = {}
    for cap, path in ((10 ** 9, "fused"), (n_items * n_items,
                                           "per_pair_full"),
                      (n_items * n_items - 1, "per_pair_striped")):
        monkeypatch.setenv("PIO_UR_FULL_MATRIX_ELEMS", str(cap))
        tm = {}
        runs[path] = P.cco_indicators_multi(pu, pi, secs, n_users, n_items,
                                            timings=tm, **kw)
        assert tm["path"] == path
    for name in secs:
        for path in ("per_pair_full", "per_pair_striped"):
            assert np.array_equal(runs[path][name].idx,
                                  runs["fused"][name].idx), (name, path)
            assert np.array_equal(runs[path][name].score,
                                  runs["fused"][name].score), (name, path)
    ref = R.cco_indicators(pu, pi, su, si, n_users, n_items,
                           max_correlators=9, u_chunk=64, item_block=100)
    _hold(runs["fused"]["view"], ref, pu, pi, su, si, n_users, n_items)


def test_equal_counts_keep_the_lower_index_first():
    """Item 0 co-occurs 3 times with each of 12 items that all have the
    same n_j, spread over the row (the last ones in the stripe buffer's
    tail): their G² bits are equal, so they come out in ascending index
    order, as the reference's top-k orders them."""
    n_users, n_items = 400, 61
    tied = [2, 5, 9, 17, 23, 31, 40, 47, 55, 58, 59, 60]
    pu, pi, su, si = [], [], [], []
    for j_pos, j in enumerate(tied):
        for r in range(5):  # n_j = 5 for each tied item
            user = 10 * j_pos + r
            su.append(user)
            si.append(j)
            if r < 3:  # 3 of them bought item 0
                pu.append(user)
                pi.append(0)
    rng = np.random.default_rng(16)
    nu = rng.integers(200, n_users, 3000)
    ni = rng.integers(1, n_items, 3000)
    ni = np.where(np.isin(ni, tied), 1, ni)  # keep the tied n_j at 5
    pu, pi = np.concatenate([pu, nu]), np.concatenate([pi, ni])
    su = np.concatenate([su, nu[::-1]])
    si = np.concatenate([si, np.where(np.isin(ni, tied), 1, ni)[::-1]])
    pu, pi, su, si = (np.asarray(a, np.int32) for a in (pu, pi, su, si))
    for block in (61, 16):
        ind = P.cco_indicators(pu, pi, su, si, n_users, n_items,
                               max_correlators=12, u_chunk=64,
                               item_block=block, device="cpu")
        row = ind.idx[0]
        assert sorted(row.tolist()) == tied
        assert row.tolist() == tied, row
        assert len(set(ind.score[0].tolist())) == 1
    ref = R.cco_indicators(pu, pi, su, si, n_users, n_items,
                           max_correlators=12, u_chunk=64)
    assert ref.idx[0].tolist() == tied


# -- serving -------------------------------------------------------------------


def test_score_user_matches_the_reference():
    n_users, n_items = 1000, 200
    pu, pi = _events(17, n_users, n_items, 5000)
    su, si = _events(18, n_users, n_items, 15000)
    inds = R.cco_indicators_multi(pu, pi, {"buy": (pu, pi),
                                           "view": (su, si)},
                                  n_users, n_items, max_correlators=10)
    port = {n: P.Indicators(idx=np.asarray(v.idx), score=np.asarray(v.score))
            for n, v in inds.items()}
    rng = np.random.default_rng(19)
    for trial in range(8):
        mb = (rng.random(n_items) < 0.05).astype(np.float32)
        mv = (rng.random(n_items) < 0.1).astype(np.float32)
        boost = np.where(rng.random(n_items) < 0.2, 2.0, 1.0).astype(
            np.float32) if trial % 2 else None
        exclude = (rng.random(n_items) < 0.1) if trial % 3 else None
        k = (5, 20, 300)[trial % 3]
        got_s, got_i = P.score_user(
            [(port["buy"], mb, 1.0), (port["view"], mv, 0.5)], k,
            exclude=exclude, item_boost=boost, device="cpu")
        want_s, want_i = R.score_user(
            [(inds["buy"], mb, 1.0), (inds["view"], mv, 0.5)], k,
            exclude=exclude, item_boost=boost)
        want_s, want_i = np.asarray(want_s), np.asarray(want_i)
        assert got_s.shape == want_s.shape == (min(k, n_items),)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
        # indices equal wherever the neighbouring scores differ
        fin = np.isfinite(want_s)
        distinct = np.ones(len(want_s), bool)
        close = np.isclose(want_s[1:], want_s[:-1], rtol=1e-5, atol=1e-5) \
            | ~fin[1:]
        distinct[1:] &= ~close
        distinct[:-1] &= ~close
        assert np.array_equal(got_i[distinct], want_i[distinct])
    assert port["buy"].on(torch.device("cpu"))[0] is \
        port["buy"].on(torch.device("cpu"))[0]  # resident once


# -- rules ---------------------------------------------------------------------


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u, i = _events(20, 30, 10, 100)
    ind = P.Indicators(idx=np.zeros((10, 2), np.int32),
                       score=np.ones((10, 2), np.float32))
    for call in (lambda: P.cco_indicators(u, i, u, i, 30, 10),
                 lambda: P.cco_indicators_multi(u, i, {"a": (u, i)}, 30, 10),
                 lambda: P.cooccurrence_counts(u, i, {"a": (u, i)}, 30, 10),
                 lambda: P.score_user([(ind, np.ones(10, np.float32), 1.0)],
                                      3)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_full_matrix_elem_cap(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.delenv("PIO_UR_FULL_MATRIX_ELEMS", raising=False)
    assert P._full_matrix_elem_cap(cpu) == 4 * 1024 ** 3 // 16
    monkeypatch.setenv("PIO_UR_FULL_MATRIX_ELEMS", "1e3")
    assert P._full_matrix_elem_cap(cpu) == 1000
    monkeypatch.setenv("PIO_UR_FULL_MATRIX_ELEMS", "12345")
    assert P._full_matrix_elem_cap(cpu) == 12345
    for bad in ("lots", "-5", "nan"):
        monkeypatch.setenv("PIO_UR_FULL_MATRIX_ELEMS", bad)
        with pytest.warns(UserWarning, match="PIO_UR_FULL_MATRIX_ELEMS"):
            assert P._full_matrix_elem_cap(cpu) == 4 * 1024 ** 3 // 16


def test_counts_beyond_float32_exactness_raise_and_tf32_is_restored():
    u, i = _events(21, 30, 10, 100)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        P.cco_indicators(u, i, u, i, 1 << 24, 10, device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*24"):
        P.cco_indicators_multi(u, i, {"a": (u, i), "b": (i, u)}, 1 << 24,
                               10, device="cpu")
    before = torch.backends.cuda.matmul.allow_tf32
    P.cco_indicators(u, i, u, i, 30, 10, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 == before
