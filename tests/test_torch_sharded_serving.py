"""The port's host-sharded serving (``ops/sharded_topk.py``,
``models/_sharded_serving.py``) on the CPU, held against the JAX package's
host-sharded functions on the same numpy inputs — the 1,003 × 16 catalog of
``tests/test_sharded_serving.py`` at 1, 2 and 4 shards:

- single query with and without exclude, and similarity: bit-identical to
  the port's flat scorer, and indices equal to the reference's;
- an all-filtered shard, ``k`` larger than a shard's rows, duplicate
  scores across shard boundaries (the flat order: lowest index first);
- the batched path: identical indices;
- the UR's ``score_user``: bit-identical to the flat scorer;
- the layout selection of ``ShardedCatalog`` and ``ShardedIndicators``;
- the serving policy against the reference's ``should_shard_serving``
  over a grid of sizes, ranks, modes, ``PIO_SHARDED_SERVING_BYTES`` values
  and meshes of 1 and 8 CPU devices;
- Recommendation, Similar-Product, E-Commerce and the UR: answers with
  ``PIO_SERVE_SHARD_ITEMS`` set equal the answers without it, and the
  reference's on the same persisted model; ``shardedServing: always``
  trains on both packages (F5).

The card's version of the bit-identity check is in ``test_torch_cuda.py``.
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.models import ecommerce as ref_ec  # noqa: E402
from incubator_predictionio_tpu.models import recommendation as ref_rec  # noqa: E402
from incubator_predictionio_tpu.models import similar_product as ref_sp  # noqa: E402
from incubator_predictionio_tpu.models import universal_recommender as ref_ur  # noqa: E402
from incubator_predictionio_tpu.ops import llr as ref_llr  # noqa: E402
from incubator_predictionio_tpu.ops import sharded_topk as ref_st  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import mesh_from_devices  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.bimap import BiMap  # noqa: E402
from incubator_predictionio_torch.models import _sharded_serving as facade  # noqa: E402
from incubator_predictionio_torch.models import ecommerce as port_ec  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.models import similar_product as port_sp  # noqa: E402
from incubator_predictionio_torch.models import universal_recommender as port_ur  # noqa: E402
from incubator_predictionio_torch.ops import llr as port_llr  # noqa: E402
from incubator_predictionio_torch.ops import sharded_topk as st  # noqa: E402
from incubator_predictionio_torch.ops import topk as port_topk  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(7)
    return rng.normal(size=(1003, 16)).astype(np.float32)


def _rows_for(n_items: int, shards: int) -> int:
    return -(-n_items // shards)


def _flat(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _both(catalog, shards):
    rows = _rows_for(len(catalog), shards)
    cat = st.put_host_sharded_catalog(catalog, rows, CPU)
    ref = ref_st.put_host_sharded_catalog(catalog, rows)
    assert cat.n_shards == ref.n_shards == shards
    return cat, ref


def _same(got, flat, ref):
    """bit-identical to the port's flat answer; the reference's indices."""
    np.testing.assert_array_equal(got[1], flat[1])
    np.testing.assert_array_equal(got[0], flat[0])  # bitwise
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5)


# -- kernel-level identity --------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("with_exclude", [False, True])
def test_single_query_bit_identical(catalog, shards, with_exclude):
    cat, ref = _both(catalog, shards)
    rng = np.random.default_rng(11 + shards)
    for k in (1, 10, 37):
        uv = rng.normal(size=(catalog.shape[1],)).astype(np.float32)
        exclude = (rng.random(len(catalog)) < 0.5) if with_exclude else None
        got = st.host_sharded_top_k_items(uv, cat, k, exclude=exclude)
        flat = port_topk.top_k_items(uv, _flat(catalog), k, exclude=exclude)
        _same(got, flat, ref_st.host_sharded_top_k_items(
            uv, ref, k, exclude=exclude))
        if exclude is not None:
            assert not exclude[got[1]].any()


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_nan_scores_take_the_flat_order(catalog, shards):
    """NaN ranks above every number, as in the flat path's stable sort:
    a shard with more NaN rows than ``k`` (a NaN threshold), a shard with
    one NaN row, and a NaN user vector all give the flat answer, and no
    pick lands past a shard's last row."""
    items = catalog.copy()
    rows = _rows_for(len(items), shards)
    items[rows - 12:rows] = np.nan
    items[[3, 700]] = np.nan
    cat = st.put_host_sharded_catalog(items, rows, CPU)
    rng = np.random.default_rng(17 + shards)
    queries = [rng.normal(size=16).astype(np.float32),
               np.full(16, np.nan, np.float32)]
    for uv in queries:
        for k in (1, 10, 37):
            for exclude in (None, rng.random(len(items)) < 0.3):
                got = st.host_sharded_top_k_items(uv, cat, k,
                                                  exclude=exclude)
                flat = port_topk.top_k_items(uv, _flat(items), k,
                                             exclude=exclude)
                np.testing.assert_array_equal(got[1], flat[1])
                np.testing.assert_array_equal(got[0], flat[0])  # NaN too
                got = st.host_sharded_similar_items(uv, cat, k,
                                                    exclude=exclude)
                flat = port_topk.similar_items(uv, _flat(items), k,
                                               exclude=exclude)
                np.testing.assert_array_equal(got[1], flat[1])
                np.testing.assert_array_equal(got[0], flat[0])
    np.testing.assert_array_equal(
        st.host_sharded_batch_top_k(np.stack(queries), cat, 10)[1],
        port_topk.batch_top_k(np.stack(queries), _flat(items), 10)[1])


def test_all_filtered_shard(catalog):
    """A fully excluded shard gives only -inf fillers; the merge still
    reproduces the flat answer."""
    cat, ref = _both(catalog, 4)
    rows = cat.rows_per_shard
    uv = np.random.default_rng(13).normal(size=16).astype(np.float32)
    exclude = np.zeros(len(catalog), bool)
    exclude[rows:2 * rows] = True
    got = st.host_sharded_top_k_items(uv, cat, 10, exclude=exclude)
    _same(got, port_topk.top_k_items(uv, _flat(catalog), 10,
                                     exclude=exclude),
          ref_st.host_sharded_top_k_items(uv, ref, 10, exclude=exclude))
    # everything but 3 items excluded: the answer's tail is -inf in the
    # flat order (lowest indices first) in both layouts
    exclude = np.ones(len(catalog), bool)
    exclude[[5, 600, 1001]] = False
    got = st.host_sharded_top_k_items(uv, cat, 8, exclude=exclude)
    flat = port_topk.top_k_items(uv, _flat(catalog), 8, exclude=exclude)
    np.testing.assert_array_equal(got[1], flat[1])
    np.testing.assert_array_equal(got[0], flat[0])
    assert np.isfinite(got[0]).sum() == 3


def test_k_larger_than_shard_rows(catalog):
    cat = st.put_host_sharded_catalog(catalog, 7, CPU)  # 144 shards of 7
    ref = ref_st.put_host_sharded_catalog(catalog, 7)
    assert cat.n_shards == 144
    uv = np.random.default_rng(14).normal(size=16).astype(np.float32)
    got = st.host_sharded_top_k_items(uv, cat, 50)
    _same(got, port_topk.top_k_items(uv, _flat(catalog), 50),
          ref_st.host_sharded_top_k_items(uv, ref, 50))


@pytest.mark.parametrize("shards", [2, 4])
def test_duplicate_scores_tie_break(shards):
    """Equal scores across shard boundaries: lowest global index first,
    the flat order, also where the threshold value is shared by more rows
    than a shard keeps."""
    items = np.ones((64, 4), np.float32)
    items[[3, 40]] = 2.0  # two winners, then 62 exact ties
    uv = np.ones(4, np.float32)
    rows = _rows_for(64, shards)
    cat = st.put_host_sharded_catalog(items, rows, CPU)
    ref = ref_st.put_host_sharded_catalog(items, rows)
    for k in (1, 2, 9, 33):
        got = st.host_sharded_top_k_items(uv, cat, k)
        _same(got, port_topk.top_k_items(uv, _flat(items), k),
              ref_st.host_sharded_top_k_items(uv, ref, k))
    got = st.host_sharded_batch_top_k(np.stack([uv, 2 * uv]), cat, 9)
    flat = port_topk.batch_top_k(np.stack([uv, 2 * uv]), _flat(items), 9)
    np.testing.assert_array_equal(got[1], flat[1])


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_similarity_bit_identical(catalog, shards):
    normed = port_topk.normalize_rows(catalog)
    rows = _rows_for(len(catalog), shards)
    cat = st.put_host_sharded_catalog(normed, rows, CPU)
    ref = ref_st.put_host_sharded_catalog(normed, rows)
    rng = np.random.default_rng(15)
    qvecs = catalog[rng.integers(0, len(catalog), size=3)]
    exclude = np.zeros(len(catalog), bool)
    exclude[:5] = True
    got = st.host_sharded_similar_items(qvecs, cat, 10, exclude=exclude)
    _same(got, port_topk.similar_items(qvecs, _flat(normed), 10,
                                       exclude=exclude),
          ref_st.host_sharded_similar_items(qvecs, ref, 10, exclude=exclude))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_batch_identical_indices(catalog, shards):
    cat, ref = _both(catalog, shards)
    rng = np.random.default_rng(16)
    uvecs = rng.normal(size=(5, catalog.shape[1])).astype(np.float32)
    got = st.host_sharded_batch_top_k(uvecs, cat, 10)
    flat = port_topk.batch_top_k(uvecs, _flat(catalog), 10)
    want = ref_st.host_sharded_batch_top_k(uvecs, ref, 10)
    np.testing.assert_array_equal(got[1], flat[1])
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], flat[0], rtol=0, atol=4e-6)


def _toy_indicators(rng, n_items: int, kc: int = 6):
    idx = rng.integers(-1, n_items, size=(n_items, kc)).astype(np.int32)
    score = rng.random((n_items, kc)).astype(np.float32)
    return idx, score


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("rules", [False, True])
def test_ur_score_user_bit_identical(shards, rules):
    rng = np.random.default_rng(17)
    n_items = 101
    rows = _rows_for(n_items, shards)
    raw = {"view": _toy_indicators(rng, n_items),
           "buy": _toy_indicators(rng, n_items, kc=3)}
    membership = {n: (rng.random(n_items) < 0.3).astype(np.float32)
                  for n in raw}
    boost = (np.where(rng.random(n_items) < 0.1, 2.0, 1.0).astype(np.float32)
             if rules else None)
    exclude = rng.random(n_items) < 0.2 if rules else None
    order = (("view", 1.0), ("buy", 2.0))
    port_inds = {n: port_llr.Indicators(idx=i, score=s)
                 for n, (i, s) in raw.items()}
    ref_inds = {n: ref_llr.Indicators(idx=i, score=s)
                for n, (i, s) in raw.items()}
    flat = port_llr.score_user([(port_inds[n], membership[n], b)
                                for n, b in order], 10, exclude=exclude,
                               item_boost=boost, device="cpu")
    got = st.host_sharded_score_user(
        [(st.put_host_sharded_indicators(port_inds[n], rows, CPU),
          membership[n], b) for n, b in order], 10, n_items, exclude, boost)
    want = ref_st.host_sharded_score_user(
        [(ref_st.put_host_sharded_indicators(ref_inds[n], rows),
          membership[n], b) for n, b in order], 10, n_items, exclude, boost)
    _same(got, flat, want)


# -- the facades and the policy ---------------------------------------------


def test_sharded_catalog_layout_selection(catalog, monkeypatch):
    monkeypatch.delenv("PIO_SERVE_SHARD_ITEMS", raising=False)
    cat = facade.ShardedCatalog(catalog, CPU)
    assert cat.layout == "flat" and cat.n_shards == 1
    assert tuple(cat.resident.shape) == catalog.shape
    uv = np.ones(catalog.shape[1], np.float32)
    flat = cat.top_k(uv, 10)
    monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", "100")
    cat = facade.ShardedCatalog(catalog, CPU)
    ref = ref_st.put_host_sharded_catalog(catalog, 100)
    assert cat.layout == "host" and cat.n_shards == ref.n_shards == 11
    assert tuple(cat.resident.shape) == (11, 100, 16)
    got = cat.top_k(uv, 10)
    np.testing.assert_array_equal(got[0], flat[0])
    np.testing.assert_array_equal(got[1], flat[1])
    monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", str(len(catalog)))
    assert facade.ShardedCatalog(catalog, CPU).layout == "flat"
    monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", "junk")
    assert facade.ShardedCatalog(catalog, CPU).layout == "flat"


def test_sharded_indicators_layout_selection(monkeypatch):
    rng = np.random.default_rng(18)
    idx, score = _toy_indicators(rng, 40)
    inds = {"view": port_llr.Indicators(idx=idx, score=score)}
    m = (rng.random(40) < 0.4).astype(np.float32)
    monkeypatch.delenv("PIO_SERVE_SHARD_ITEMS", raising=False)
    flat = facade.ShardedIndicators(inds, 40, CPU)
    assert flat.layout == "flat"
    want = flat.score_user([("view", m, 1.0)], 5, None, None)
    monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", "16")
    si = facade.ShardedIndicators(inds, 40, CPU)
    assert si.layout == "host"
    got = si.score_user([("view", m, 1.0)], 5, None, None)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("budget", [None, "1000000", "1e9", "junk"])
def test_policy_matches_reference(monkeypatch, budget):
    if budget is None:
        monkeypatch.delenv("PIO_SHARDED_SERVING_BYTES", raising=False)
    else:
        monkeypatch.setenv("PIO_SHARDED_SERVING_BYTES", budget)
    meshes = {1: mesh_from_devices(devices=jax.devices()[:1]),
              8: mesh_from_devices()}
    assert meshes[8].size == 8
    for n_items in (100, 26_744, 10**6, 10**8):
        for rank in (4, 32, 128):
            for mode in ("auto", "always", "never"):
                for n_dev, mesh in meshes.items():
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        want = ref_st.should_shard_serving(
                            n_items, rank, mesh, mode)
                        got = st.should_shard_serving(
                            n_items, rank, n_dev, mode, "cpu")
                        assert got == want, (n_items, rank, mode, n_dev)
                        if got:
                            with pytest.raises(NotImplementedError,
                                               match="item 7"):
                                st.serving_mesh_for("cpu", n_items, rank,
                                                    mode, n_devices=n_dev)
                        else:
                            assert st.serving_mesh_for(
                                "cpu", n_items, rank, mode, n_dev) is None
    if budget == "junk":  # a malformed budget warns, as the reference's
        with pytest.warns(UserWarning, match="not a positive"):
            st.should_shard_serving(10**6, 64, 8, "auto", "cpu")
    for bad in ("sometimes", "ALWAYS"):
        with pytest.raises(ValueError):
            st.validate_serving_mode(bad)
        with pytest.raises(ValueError):
            ref_st.validate_serving_mode(bad)


# -- the templates ------------------------------------------------------------


def _persisted_als(rng, n_users=30, n_items=57, rank=8) -> dict:
    users = BiMap({f"u{j}": j for j in range(n_users)})
    items = BiMap({f"i{j}": j for j in range(n_items)})
    itf = rng.normal(size=(n_items, rank)).astype(np.float32)
    itf[[10, 30]] = itf[5]  # exact ties across shards
    return {"user_factors": rng.normal(size=(n_users, rank)).astype(
                np.float32),
            "item_factors": itf,
            "users": users.to_persisted(), "items": items.to_persisted()}


def _memory_env() -> dict:
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}


def _answers(serve, queries, monkeypatch):
    """{knob: answers} from fresh models, without and with the knob (7
    rows per shard)."""
    out = {}
    for knob in (None, "7"):
        if knob is None:
            monkeypatch.delenv("PIO_SERVE_SHARD_ITEMS", raising=False)
        else:
            monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", knob)
        out[knob] = serve(queries, knob)
    return out


def _hold(port, ref, approx=True):
    """Port: the knob changes nothing, bit for bit. Reference: the same
    items in the same order, scores close."""
    assert port[None] == port["7"]
    for knob in (None, "7"):
        for a, b in zip(port[knob], ref[knob]):
            a, b = a["itemScores"], b["itemScores"]
            assert [x["item"] for x in a] == [x["item"] for x in b]
            np.testing.assert_allclose([x["score"] for x in a],
                                       [x["score"] for x in b],
                                       rtol=1e-5, atol=1e-5)


def test_recommendation_knob_and_reference(monkeypatch):
    rng = np.random.default_rng(21)
    stored = _persisted_als(rng)
    queries = [{"user": f"u{j}", "num": n} for j, n in
               ((0, 4), (3, 10), (7, 57), (11, 1))] + [
        {"user": "nobody", "num": 3}]
    port_algo = port_rec.ALSAlgorithm(port_rec.AlgorithmParams(
        sharded_serving="always"))
    ref_algo = ref_rec.ALSAlgorithm(ref_rec.AlgorithmParams())

    def port(qs, knob):
        model = port_algo.restore_model(stored, WorkflowContext(device="cpu"))
        assert model.catalog().layout == ("host" if knob else "flat")
        return ([port_algo.predict(model, q) for q in qs]
                + port_algo.batch_predict(model, qs))

    def ref(qs, knob):
        model = ref_algo.restore_model(stored, None)
        return ([ref_algo.predict(model, q) for q in qs]
                + ref_algo.batch_predict(model, qs))

    _hold(_answers(port, queries, monkeypatch),
          _answers(ref, queries, monkeypatch))


@pytest.mark.parametrize("where", ["item_row", "user_vector"])
def test_nan_model_refused_by_the_swap_gate_host_sharded(monkeypatch, where):
    """A NaN model deployed host-sharded: the warm-up query answers as the
    flat catalog does (no exception), and the swap gate refuses the model
    for its non-finite values, as it does for a flat one."""
    import torch_serving as ts
    from incubator_predictionio_torch.controller import EngineParams
    from incubator_predictionio_torch.controller.engine import Deployment
    from incubator_predictionio_torch.workflow.create_server import (
        EngineServer, SwapValidationError,
    )

    good = _persisted_als(np.random.default_rng(26))
    bad = _persisted_als(np.random.default_rng(26))
    if where == "item_row":
        bad["item_factors"][[2, 40, 41, 42]] = np.nan
    else:
        bad["user_factors"][0] = np.nan
    _, _, algos, serving = port_rec.RecommendationEngine()().make_components(
        EngineParams.from_json(ts.ENGINE_JSON))
    algo = algos[0][1]
    answers = {}
    for knob in (None, "7"):
        if knob is None:
            monkeypatch.delenv("PIO_SERVE_SHARD_ITEMS", raising=False)
        else:
            monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", knob)
        model = algo.restore_model(bad, WorkflowContext(device="cpu"))
        model.warm_up()
        assert model.catalog().layout == ("host" if knob else "flat")
        answers[knob] = [algo.predict(model, {"user": f"u{j}", "num": 10})
                         for j in range(4)]
        answers[knob].append(algo.batch_predict(
            model, [{"user": f"u{j}", "num": 10} for j in range(4)]))
    # NaN scores compare equal as JSON text
    assert json.dumps(answers[None]) == json.dumps(answers["7"])
    server = EngineServer(deployment=Deployment(
        algos, [algo.restore_model(good, WorkflowContext(device="cpu"))],
        serving), device="cpu")
    nan_dep = Deployment(
        algos, [algo.restore_model(bad, WorkflowContext(device="cpu"))],
        serving)
    with pytest.raises(SwapValidationError) as refused:
        server._prepare(nan_dep, "nan-instance", None)
    assert "non-finite" in refused.value.reason
    assert "warm-up failed" not in refused.value.reason
    assert nan_dep.models[0].catalog().layout == "host"


def test_similar_product_knob_and_reference(monkeypatch):
    rng = np.random.default_rng(22)
    stored = _persisted_als(rng)
    del stored["users"]
    stored["item_categories"] = {f"i{j}": ["even" if j % 2 else "odd"]
                                 for j in range(57)}
    queries = [{"items": ["i3"], "num": 5},
               {"items": ["i1", "i40"], "num": 12, "categories": ["even"]},
               {"items": ["i5"], "num": 6, "blackList": ["i10", "i2"]},
               {"items": ["i9"], "num": 4,
                "whiteList": [f"i{j}" for j in range(20, 50)]}]
    port_algo = port_sp.SimilarProductAlgorithm(
        port_sp.SimilarProductAlgoParams(sharded_serving="always"))
    ref_algo = ref_sp.SimilarProductAlgorithm(ref_sp.SimilarProductAlgoParams())

    def port(qs, knob):
        model = port_algo.restore_model(stored, WorkflowContext(device="cpu"))
        assert model.catalog().layout == ("host" if knob else "flat")
        return [port_algo.predict(model, q) for q in qs]

    def ref(qs, knob):
        model = ref_algo.restore_model(stored, None)
        return [ref_algo.predict(model, q) for q in qs]

    _hold(_answers(port, queries, monkeypatch),
          _answers(ref, queries, monkeypatch))


def test_ecommerce_knob_and_reference(monkeypatch):
    rng = np.random.default_rng(23)
    stored = _persisted_als(rng)
    stored["item_categories"] = {f"i{j}": ["c%d" % (j % 3)]
                                 for j in range(57)}
    stored["app_name"] = "ecapp"
    stored["seen_event_names"] = ["view", "buy"]
    port_store = port_pkg.Storage(_memory_env())
    ref_store = ref_storage.Storage(_memory_env())
    for pkg, s in ((port_pkg, port_store), (ref_storage, ref_store)):
        app_id = s.get_meta_data_apps().insert(pkg.App(0, "ecapp"))
        s.get_l_events().init(app_id)
        # u1 viewed i4 and i31: both excluded by unseenOnly
        s.get_l_events().insert_batch([
            pkg.Event.from_json({"event": "view", "entityType": "user",
                                 "entityId": "u1", "targetEntityType":
                                 "item", "targetEntityId": it})
            for it in ("i4", "i31")], app_id)
    queries = [{"user": "u1", "num": 10},
               {"user": "u2", "num": 7, "categories": ["c1"]},
               {"user": "u3", "num": 5, "blackList": ["i5", "i10"]},
               {"user": "u1", "num": 9, "unseenOnly": False}]
    port_algo = port_ec.ECommerceAlgorithm(
        port_ec.ECommerceAlgoParams(sharded_serving="always"))
    ref_algo = ref_ec.ECommerceAlgorithm(ref_ec.ECommerceAlgoParams())

    def port(qs, knob):
        model = port_algo.restore_model(stored, WorkflowContext(
            device="cpu", storage=port_store))
        assert model.catalog().layout == ("host" if knob else "flat")
        return [port_algo.predict(model, q) for q in qs]

    def ref(qs, knob):
        model = ref_algo.restore_model(stored, RefContext(storage=ref_store))
        return [ref_algo.predict(model, q) for q in qs]

    port_ans = _answers(port, queries, monkeypatch)
    assert {"i4", "i31"}.isdisjoint(
        x["item"] for x in port_ans["7"][0]["itemScores"])
    _hold(port_ans, _answers(ref, queries, monkeypatch))


def test_universal_recommender_knob_and_reference(monkeypatch):
    rng = np.random.default_rng(24)
    n_items = 45
    items = BiMap({f"i{j}": j for j in range(n_items)})
    raw = {"buy": _toy_indicators(rng, n_items),
           "view": _toy_indicators(rng, n_items, kc=3)}
    model = port_ur.URModel(
        indicators={n: port_llr.Indicators(idx=i, score=s)
                    for n, (i, s) in raw.items()},
        users=BiMap({"u0": 0}), items=items,
        item_categories={f"i{j}": {"c%d" % (j % 2)} for j in range(n_items)},
        app_name="urapp", event_names=("buy", "view"), device=CPU,
        popularity=rng.random(n_items).astype(np.float32))
    stored = port_ur.model_to_persisted(model)
    ref_store = ref_storage.Storage(_memory_env())
    queries = [dict(items=["i3"], num=8),
               dict(items=["i1", "i20"], num=12,
                    blacklist_items=["i2", "i30"]),
               dict(items=["i7"], num=6, fields=[
                   {"name": "categories", "values": ["c1"], "bias": -1}]),
               dict(items=["i8"], num=9, fields=[
                   {"name": "categories", "values": ["c0"], "bias": 3.0}])]

    def port(qs, knob):
        m = port_ur.model_from_persisted(stored, "cpu", None)
        assert m.indicator_catalog().layout == ("host" if knob else "flat")
        return [{"itemScores": [{"item": i, "score": s} for i, s in
                                m.recommend(None, **q)]} for q in qs]

    def ref(qs, knob):
        m = ref_ur.URAlgorithm(ref_ur.URAlgorithmParams()).restore_model(
            stored, RefContext(storage=ref_store))
        return [{"itemScores": [{"item": i, "score": s} for i, s in
                                m.recommend(None, **q)]} for q in qs]

    _hold(_answers(port, queries, monkeypatch),
          _answers(ref, queries, monkeypatch))


def test_sharded_serving_always_trains_on_both_packages(monkeypatch):
    """F5: an engine.json with "shardedServing": "always" trains (and
    serves) on the reference and on the port, for the three ALS
    templates."""
    monkeypatch.setenv("PIO_SERVE_SHARD_ITEMS", "5")
    rng = np.random.default_rng(25)
    n_users, n_items = 20, 23
    u = rng.integers(0, n_users, 300).astype(np.int32)
    i = rng.integers(0, n_items, 300).astype(np.int32)
    r = rng.integers(1, 6, 300).astype(np.float32)
    maps = ({f"u{j}": j for j in range(n_users)},
            {f"i{j}": j for j in range(n_items)})
    common = {"rank": 4, "numIterations": 3, "lambda": 0.1,
              "shardedServing": "always"}
    cases = [
        (port_rec.RecommendationEngine, ref_rec.RecommendationEngine,
         lambda pkg_td, bm: pkg_td(u, i, r, bm(maps[0]), bm(maps[1])),
         (port_rec.TrainingData, ref_rec.TrainingData),
         {"user": "u1", "num": 5}),
        (port_sp.SimilarProductEngine, ref_sp.SimilarProductEngine,
         lambda pkg_td, bm: pkg_td(u, i, np.ones_like(r), bm(maps[0]),
                                   bm(maps[1]), {}),
         (port_sp.TrainingData, ref_sp.TrainingData),
         {"items": ["i1"], "num": 5}),
    ]
    from incubator_predictionio_tpu.controller import EngineParams as RefEP
    from incubator_predictionio_tpu.data.storage.bimap import BiMap as RefBiMap
    from incubator_predictionio_torch.controller import EngineParams

    for port_f, ref_f, make_td, (p_td, r_td), q in cases:
        ej = {"algorithms": [{"name": "", "params": common}]}
        _, _, algos, _ = port_f()().make_components(EngineParams.from_json(ej))
        algo = algos[0][1]
        assert algo.params.sharded_serving == "always"
        model = algo.train(WorkflowContext(device="cpu"),
                           make_td(p_td, BiMap))
        assert model.catalog().layout == "host"
        _, _, ralgos, _ = ref_f()().make_components(RefEP.from_json(ej))
        rmodel = ralgos[0][1].train(RefContext(), make_td(r_td, RefBiMap))
        assert rmodel is not None
        assert algo.predict(model, q)["itemScores"]
    # E-Commerce: the same TrainingData as Similar-Product
    ej = {"algorithms": [{"name": "", "params": common | {
        "appName": "ecapp"}}]}
    _, _, algos, _ = port_ec.ECommerceEngine()().make_components(
        EngineParams.from_json(ej))
    model = algos[0][1].train(
        WorkflowContext(device="cpu", storage=port_pkg.Storage(
            _memory_env())),
        port_sp.TrainingData(u, i, np.ones_like(r), BiMap(maps[0]),
                             BiMap(maps[1]), {}))
    assert model.catalog().layout == "host" and model.catalog().n_shards == 5
    _, _, ralgos, _ = ref_ec.ECommerceEngine()().make_components(
        RefEP.from_json(ej))
    assert ralgos[0][1].train(RefContext(storage=ref_storage.Storage(
        _memory_env())), ref_sp.TrainingData(
            u, i, np.ones_like(r), RefBiMap(maps[0]), RefBiMap(maps[1]),
            {})) is not None
