"""The port's ALS fold-in (``ops/als.py`` ``fold_in_factors``,
``ALSAlgorithm.fold_in``) on the CPU against the JAX reference: the same
solved rows at 2e-4 for explicit/implicit × plain/nratings × with/without an
anchor (new rows, empty rows and the edge cases included), the hand-solved
ridge of ``tests/test_online_foldin.py``, and the template's fold-in with
identical id maps and an untouched input model. On the CPU the solve is the
plain Gauss-Jordan that the card's kernel repeats.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from incubator_predictionio_tpu.controller.base import doer as ref_doer  # noqa: E402
from incubator_predictionio_tpu.data.storage.bimap import BiMap as RefBiMap  # noqa: E402
from incubator_predictionio_tpu.models import recommendation as ref_rec  # noqa: E402
from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_torch.controller.base import doer  # noqa: E402
from incubator_predictionio_torch.data.bimap import BiMap  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.ops import spd_solve  # noqa: E402

TOL = 2e-4
K = 8


def _batch(seed=0, n=30, rows=12, empty=(3,)):
    """Counterpart factors [n, K] and ``rows`` observation lists of 1..6
    counterpart indices each (``empty`` rows have none)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, K)).astype(np.float32) / np.sqrt(K)
    idx, val = [], []
    for r in range(rows):
        m = 0 if r in empty else int(rng.integers(1, 7))
        idx.append(rng.choice(n, m, replace=False).astype(np.int64))
        val.append((rng.integers(1, 11, m) / 2.0).astype(np.float32))
    anchor = rng.standard_normal((rows, K)).astype(np.float32) / np.sqrt(K)
    anchor[-2:] = 0.0  # two brand-new rows: zero anchor, μ = 0
    mu = np.ones(rows, np.float32)
    mu[-2:] = 0.0
    return y, idx, val, anchor, mu


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("scaling", ["plain", "nratings"])
@pytest.mark.parametrize("anchored", [False, True])
def test_fold_in_factors_matches_reference(implicit, scaling, anchored):
    y, idx, val, anchor, mu = _batch(seed=int(implicit) + 2 * anchored)
    kw = dict(reg=0.1, lambda_scaling=scaling, implicit_prefs=implicit,
              alpha=0.7)
    if anchored:
        kw.update(anchor=anchor, anchor_weight=mu)
    ref = ref_als.fold_in_factors(y, idx, val, **kw)
    out = port_als.fold_in_factors(y, idx, val, device="cpu", **kw)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    if implicit:  # a cached YᵀY gives the same rows
        yty = port_als.fold_in_factors(y, idx, val, device="cpu",
                                       yty=y.T @ y, **kw)
        np.testing.assert_allclose(yty, out, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["no-rows", "all-empty", "all-empty-anchor",
                                  "empty-counterpart", "scalar-weight"])
def test_fold_in_factors_edge_cases(case):
    y, idx, val, anchor, _ = _batch(rows=4, empty=())
    kw = dict(reg=0.1)
    if case == "no-rows":
        idx, val = [], []
    elif case.startswith("all-empty"):
        idx = [np.zeros(0, np.int64)] * 4
        val = [np.zeros(0, np.float32)] * 4
        if case.endswith("anchor"):
            kw.update(anchor=anchor)
    elif case == "empty-counterpart":
        y = np.zeros((0, K), np.float32)
        idx = [np.zeros(0, np.int64)] * 4
        val = [np.zeros(0, np.float32)] * 4
    else:
        kw.update(anchor=anchor, anchor_weight=2.5)
    ref = ref_als.fold_in_factors(y, idx, val, **kw)
    out = port_als.fold_in_factors(y, idx, val, device="cpu", **kw)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_fold_in_matches_hand_solved_ridge():
    """tests/test_online_foldin.py's hand-built normal equations."""
    rng = np.random.default_rng(7)
    k = 4
    Y = rng.normal(size=(6, k)).astype(np.float32)
    obs, rat = [np.array([1, 3])], [np.array([5.0, 2.0], np.float32)]
    ys = Y[[1, 3]]
    out = port_als.fold_in_factors(Y, obs, rat, reg=0.1,
                                   anchor=np.zeros((1, k)), anchor_weight=1.0,
                                   device="cpu")
    ref = np.linalg.solve(ys.T @ ys + (0.1 + 1.0) * np.eye(k, dtype=np.float32),
                          ys.T @ rat[0])
    assert np.allclose(out[0], ref, atol=1e-5)
    # no anchor = no proximal term: the plain ridge
    bare = port_als.fold_in_factors(Y, obs, rat, reg=0.1, device="cpu")
    ref_bare = np.linalg.solve(ys.T @ ys + 0.1 * np.eye(k, dtype=np.float32),
                               ys.T @ rat[0])
    assert np.allclose(bare[0], ref_bare, atol=1e-5)
    # implicit mode carries the shared YᵀY and the confidence weights
    out_i = port_als.fold_in_factors(Y, obs, rat, reg=0.1, implicit_prefs=True,
                                     alpha=2.0, anchor_weight=0.0, device="cpu")
    cw = 1 + 2.0 * rat[0]
    a_i = Y.T @ Y + (ys * (cw - 1)[:, None]).T @ ys + 0.1 * np.eye(k)
    assert np.allclose(out_i[0], np.linalg.solve(a_i, ys.T @ cw), atol=1e-4)


def test_fold_in_solves_in_one_call(monkeypatch):
    """Every row of one fold-in goes through one batched SPD solve (the
    kernel launch on the card)."""
    calls = []
    real = port_als.batched_spd_solve

    def counting(a, b):
        calls.append(tuple(a.shape))
        return real(a, b)

    monkeypatch.setattr(port_als, "batched_spd_solve", counting)
    y, idx, val, anchor, mu = _batch(rows=40)
    before = spd_solve.gauss_jordan_launches.count
    port_als.fold_in_factors(y, idx, val, reg=0.1, anchor=anchor,
                             anchor_weight=mu, device="cpu")
    assert calls == [(40, K, K)]
    # no kernel on the CPU (a delta: the counter is process-wide)
    assert spd_solve.gauss_jordan_launches.count == before


def _models(implicit=False):
    rng = np.random.default_rng(3)
    nu, ni = 5, 7
    uf = rng.standard_normal((nu, K)).astype(np.float32) / np.sqrt(K)
    itf = rng.standard_normal((ni, K)).astype(np.float32) / np.sqrt(K)
    users = [f"u{j}" for j in range(nu)]
    items = [f"i{j}" for j in range(ni)]
    params = {"rank": K, "lambda": 0.1, "implicitPrefs": implicit,
              "alpha": 0.5}
    ref_model = ref_rec.ALSModel(
        factors=ref_als.ALSFactors(uf.copy(), itf.copy(), nu, ni),
        users=RefBiMap.string_int(users), items=RefBiMap.string_int(items))
    model = port_rec.ALSModel(
        factors=port_als.ALSFactors(uf.copy(), itf.copy(), nu, ni),
        users=BiMap.string_int(users), items=BiMap.string_int(items),
        device=torch.device("cpu"))
    return (ref_doer(ref_rec.ALSAlgorithm, params), ref_model,
            doer(port_rec.ALSAlgorithm, params), model)


def _ev(name, u, i=None, rating=None):
    e = {"event": name, "entityType": "user", "entityId": u}
    if i is not None:
        e.update(targetEntityType="item", targetEntityId=i)
    if rating is not None:
        e["properties"] = {"rating": rating}
    return e


EVENTS = [
    _ev("rate", "u1", "i2", 4.0),
    _ev("rate", "u1", "i2", 2.0),        # last write wins
    _ev("rate", "u3", "i0", "3.5"),      # a string rating
    _ev("buy", "u2", "i6"),              # buy: the default 4.0
    _ev("rate", "new1", "i1", 5.0),      # a new user on a known item
    _ev("rate", "u4", "newi", 1.0),      # a new item from a known user
    _ev("rate", "new2", "newj", 3.0),    # both new
    _ev("rate", "new2", "i3", "bad"),    # unusable rating: 1.0
    _ev("view", "u0", "i0"),             # not a selected event
    _ev("rate", "u0"),                   # no target
    "not an event",
]


@pytest.mark.parametrize("implicit", [False, True])
def test_template_fold_in_matches_reference(implicit):
    ref_algo, ref_model, algo, model = _models(implicit)
    before = (model.factors.user_factors.copy(),
              model.factors.item_factors.copy())
    model.catalog()  # a warm served model
    ref_out = ref_algo.fold_in(ref_model, EVENTS, None)
    out = algo.fold_in(model, EVENTS)
    assert list(out.users.to_dict().items()) == list(
        ref_out.users.to_dict().items())
    assert list(out.items.to_dict().items()) == list(
        ref_out.items.to_dict().items())
    assert (out.factors.n_users, out.factors.n_items) == (
        ref_out.factors.n_users, ref_out.factors.n_items)
    np.testing.assert_allclose(out.factors.user_factors,
                               ref_out.factors.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.factors.item_factors,
                               ref_out.factors.item_factors,
                               rtol=TOL, atol=TOL)
    # the served model is never mutated; the new one starts cold
    np.testing.assert_array_equal(model.factors.user_factors, before[0])
    np.testing.assert_array_equal(model.factors.item_factors, before[1])
    assert len(model.users) == 5 and len(model.items) == 7
    assert out.device == model.device and out._sharded_cat is None
    assert [u for u, _ in out.recommend_products("new2", 3)] == [
        u for u, _ in ref_out.recommend_products("new2", 3)]


def test_template_fold_in_without_applicable_events():
    _, _, algo, model = _models()
    assert algo.fold_in(model, [_ev("view", "u0", "i0"), _ev("rate", "u1")]) \
        is None
