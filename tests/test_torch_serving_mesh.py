"""The port's serving mesh (``ops/sharded_topk.py`` ``ShardedCatalog``,
``put_sharded_catalog``, ``sharded_*``; ``parallel/mesh.py``
``default_mesh``; the context's ``mesh``; the ``mesh`` layout of
``models/_sharded_serving.py``) on the CPU, a mesh being a list of torch
devices (``["cpu"] * n``): tests/test_sharded_serving.py:50-139,199-219 of
the reference, with the port's flat scorer as the bit-level yardstick and
the JAX package's ``sharded_*`` functions on its 8-device CPU mesh as the
reference:

- single query with and without exclude, similarity, ``k`` past a
  shard's rows, ties across shards: bit-identical to the port's flat
  scorer at 2, 3 and 8 shards (the catalog padded), the reference's
  indices equal;
- the batched path: identical indices to the flat GEMM and to the
  reference;
- the context's mesh: every visible card for a CUDA context (one device
  on the CPU), or the caller's list;
- Recommendation, Similar-Product and E-Commerce trained in process and
  restored with a 4-device context mesh and ``shardedServing: always``:
  the train's and the restore's models pick the mesh through
  ``serving_mesh_for``, answer single queries bit for bit like the flat
  deployment, and batches with identical items.
"""

import datetime as dt

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.ops import sharded_topk as ref_st  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import mesh_from_devices  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.models import ecommerce as port_ec  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.models import similar_product as port_sp  # noqa: E402
from incubator_predictionio_torch.ops import sharded_topk as st  # noqa: E402
from incubator_predictionio_torch.ops import topk as port_topk  # noqa: E402
from incubator_predictionio_torch.parallel import mesh as port_mesh  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402

CPU = torch.device("cpu")
SHARDS = [2, 3, 8]


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(7)
    return rng.normal(size=(1003, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_mesh8():
    return mesh_from_devices()  # the 8 virtual CPU devices


def _flat(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])  # bit for bit


def _ref_indices(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


# -- the layout and the kernels ------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_layout_pads_rows_and_places_one_shard_per_device(catalog, n):
    cat = st.put_sharded_catalog(catalog, ["cpu"] * n)
    assert cat.n_shards == n and cat.mesh == [CPU] * n
    assert cat.padded_rows % n == 0 and cat.padded_rows >= 1003
    assert cat.padded_rows - 1003 < n and cat.rank == 16
    joined = torch.cat(cat.shards).numpy()
    np.testing.assert_array_equal(joined[:1003], catalog)
    assert not joined[1003:].any()
    assert [int(p.sum()) for p in cat.pad] == \
        [0] * (n - 1) + [cat.padded_rows - 1003]


@pytest.mark.parametrize("n", SHARDS)
def test_single_query_bit_identical(catalog, ref_mesh8, n):
    cat = st.put_sharded_catalog(catalog, ["cpu"] * n)
    ref_cat = ref_st.put_sharded_catalog(catalog, ref_mesh8)
    rng = np.random.default_rng(1)
    for _ in range(3):
        uv = rng.normal(size=(16,)).astype(np.float32)
        got = st.sharded_top_k_items(uv, cat, 10)
        _same(got, port_topk.top_k_items(uv, _flat(catalog), 10))
        _ref_indices(got, ref_st.sharded_top_k_items(uv, ref_cat, 10))


@pytest.mark.parametrize("n", SHARDS)
def test_single_query_with_exclude_bit_identical(catalog, ref_mesh8, n):
    cat = st.put_sharded_catalog(catalog, ["cpu"] * n)
    rng = np.random.default_rng(2)
    uv = rng.normal(size=(16,)).astype(np.float32)
    excl = np.zeros(1003, bool)
    excl[rng.integers(0, 1003, 300)] = True
    excl[cat.rows_per_shard:2 * cat.rows_per_shard] = True  # a whole shard
    got = st.sharded_top_k_items(uv, cat, 25, exclude=excl)
    _same(got, port_topk.top_k_items(uv, _flat(catalog), 25, exclude=excl))
    _ref_indices(got, ref_st.sharded_top_k_items(
        uv, ref_st.put_sharded_catalog(catalog, ref_mesh8), 25,
        exclude=excl))


@pytest.mark.parametrize("n", SHARDS)
def test_similarity_bit_identical(catalog, ref_mesh8, n):
    normed = port_topk.normalize_rows(catalog)
    cat = st.put_sharded_catalog(normed, ["cpu"] * n)
    qv = catalog[[3, 77, 500]]
    excl = np.zeros(1003, bool)
    excl[[3, 77, 500]] = True
    got = st.sharded_similar_items(qv, cat, 9, exclude=excl)
    _same(got, port_topk.similar_items(qv, _flat(normed), 9, exclude=excl))
    _ref_indices(got, ref_st.sharded_similar_items(
        qv, ref_st.put_sharded_catalog(normed, ref_mesh8), 9, exclude=excl))


@pytest.mark.parametrize("n", SHARDS)
def test_batch_identical_selection(catalog, ref_mesh8, n):
    cat = st.put_sharded_catalog(catalog, ["cpu"] * n)
    rng = np.random.default_rng(3)
    uvs = rng.normal(size=(13, 16)).astype(np.float32)
    s1, i1 = st.sharded_batch_top_k(uvs, cat, 7)
    s0, i0 = port_topk.batch_top_k(uvs, _flat(catalog), 7)
    np.testing.assert_array_equal(i1, i0)  # same items, same order
    np.testing.assert_allclose(s1, s0, rtol=0, atol=4e-6)
    s2, i2 = ref_st.sharded_batch_top_k(
        uvs, ref_st.put_sharded_catalog(catalog, ref_mesh8), 7)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=0, atol=4e-6)


def test_k_larger_than_shard_rows(ref_mesh8):
    """k past a shard's row count: every shard gives all of its rows and
    the merge is still exact."""
    rng = np.random.default_rng(5)
    items = rng.normal(size=(40, 4)).astype(np.float32)  # 5 rows a shard
    cat = st.put_sharded_catalog(items, ["cpu"] * 8)
    uv = rng.normal(size=(4,)).astype(np.float32)
    got = st.sharded_top_k_items(uv, cat, 20)
    _same(got, port_topk.top_k_items(uv, _flat(items), 20))
    _ref_indices(got, ref_st.sharded_top_k_items(
        uv, ref_st.put_sharded_catalog(items, ref_mesh8), 20))


def test_tie_break_matches_the_flat_order(ref_mesh8):
    """Equal scores across shards: the lowest global index first, as the
    flat scorer and ``lax.top_k`` order them."""
    items = np.zeros((64, 2), np.float32)
    items[:, 0] = np.repeat([5.0, 4.0, 3.0, 2.0], 16)
    uv = np.array([1.0, 0.0], np.float32)
    for n in (3, 8):
        got = st.sharded_top_k_items(
            uv, st.put_sharded_catalog(items, ["cpu"] * n), 24)
        _same(got, port_topk.top_k_items(uv, _flat(items), 24))
        _same(got, ref_st.sharded_top_k_items(
            uv, ref_st.put_sharded_catalog(items, ref_mesh8), 24))


def test_the_context_mesh(monkeypatch):
    """``get_mesh``: the caller's list, else every visible card for a
    CUDA context and the one device of a CPU context."""
    assert WorkflowContext(device="cpu").get_mesh() == [CPU]
    assert WorkflowContext(device="cpu", mesh=["cpu"] * 4).get_mesh() == \
        [CPU] * 4
    assert port_mesh.default_mesh("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert port_mesh.default_mesh("cuda") == [
        torch.device("cuda", i) for i in range(3)]
    # the policy over that mesh: "always" picks it, "never" and one
    # device do not
    ctx = WorkflowContext(device="cpu", mesh=["cpu"] * 3)
    assert st.serving_mesh_for(ctx, 50, 4, "always") == [CPU] * 3
    assert st.serving_mesh_for(ctx, 50, 4, "never") is None
    assert st.serving_mesh_for(WorkflowContext(device="cpu"), 50, 4,
                               "always") is None
    assert st.serving_mesh_for(None, 50, 4, "always") is None


# -- the templates ---------------------------------------------------------------


T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
MESH4 = ["cpu"] * 4


def _storage(events) -> object:
    s = port_pkg.Storage({
        f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
        for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
    app_id = s.get_meta_data_apps().insert(port_pkg.App(0, "mesh"))
    s.get_l_events().init(app_id)
    s.get_l_events().insert_batch(events, app_id)
    return s


def _events(name: str, n: int, n_users: int, n_items: int, seed: int,
            rated: bool = False) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        u, i = int(rng.integers(0, n_users)), int(rng.integers(0, n_items))
        props = (port_pkg.DataMap({"rating": float(1 + (u * i) % 5)})
                 if rated else port_pkg.DataMap())
        out.append(port_pkg.Event(name, "user", str(u), "item", str(i),
                                  properties=props,
                                  event_time=T0 + dt.timedelta(seconds=j)))
    for i in range(n_items):  # categories for the filters
        out.append(port_pkg.Event(
            "$set", "item", str(i),
            properties=port_pkg.DataMap(
                {"categories": ["even" if i % 2 == 0 else "odd"]}),
            event_time=T0 + dt.timedelta(seconds=n + i)))
    return out


def _deployments(factory, storage, algo_params: dict, algo="als"):
    """{mode: (train model, deployment)}: trained in process and restored
    with a 4-device context mesh, ``shardedServing`` never and always."""
    engine = factory()()
    out = {}
    for mode in ("never", "always"):
        params = EngineParams.from_json({
            "datasource": {"params": {"appName": "mesh"}},
            "algorithms": [{"name": algo, "params": {
                **algo_params, "shardedServing": mode}}]})
        ctx = WorkflowContext(app_name="mesh", storage=storage,
                              device="cpu", mesh=MESH4)
        ds, prep, algos, _ = engine.make_components(params)
        trained = algos[0][1].train(
            ctx, prep.prepare(ctx, ds.read_training(ctx)))
        iid = core_workflow.run_train(engine, params, ctx,
                                      engine_factory_name=f"mesh-{mode}")
        dep, _, _ = core_workflow.load_deployment(
            engine, iid, WorkflowContext(storage=storage, device="cpu",
                                         mesh=MESH4),
            engine_factory_name=f"mesh-{mode}")
        out[mode] = (trained, dep)
    for model in (out["always"][0], out["always"][1].models[0]):
        assert model.serving_mesh == [CPU] * 4
        assert model.catalog().layout == "mesh"
        assert model.catalog().n_shards == 4
    for model in (out["never"][0], out["never"][1].models[0]):
        assert model.serving_mesh is None
        assert model.catalog().layout == "flat"
    return out["never"][1], out["always"][1]


def test_recommendation_mesh_deployment_answers_like_flat():
    storage = _storage(_events("rate", 600, 40, 61, 11, rated=True))
    flat, mesh = _deployments(
        port_rec.RecommendationEngine, storage,
        {"rank": 8, "numIterations": 3, "computeDtype": "float32"})
    for user in ("1", "7", "23", "unknown-user"):
        q = {"user": user, "num": 5}
        assert mesh.query(q) == flat.query(q)  # bit for bit
    qs = [{"user": str(u), "num": 4} for u in (0, 3, 9, 31, 39)]
    for a, b in zip(mesh.batch_query(qs), flat.batch_query(qs)):
        assert [x["item"] for x in a["itemScores"]] == \
            [x["item"] for x in b["itemScores"]]
        np.testing.assert_allclose(
            [x["score"] for x in a["itemScores"]],
            [x["score"] for x in b["itemScores"]], rtol=0, atol=4e-6)


def test_similar_product_mesh_deployment_answers_like_flat():
    storage = _storage(_events("view", 400, 30, 51, 13))
    flat, mesh = _deployments(
        port_sp.SimilarProductEngine, storage,
        {"rank": 8, "numIterations": 3, "computeDtype": "float32"})
    for q in ({"items": ["1"], "num": 5},
              {"items": ["2", "9"], "num": 7},
              {"items": ["3"], "num": 5, "blackList": ["4", "5"]},
              {"items": ["6"], "num": 6, "categories": ["even"]}):
        assert mesh.query(q) == flat.query(q)


def test_ecommerce_mesh_deployment_answers_like_flat():
    storage = _storage(_events("view", 500, 30, 53, 17)
                       + _events("buy", 80, 30, 53, 19))
    flat, mesh = _deployments(
        port_ec.ECommerceEngine, storage,
        {"appName": "mesh", "rank": 8, "numIterations": 3,
         "computeDtype": "float32"}, algo="ecomm")
    for q in ({"user": "1", "num": 5},
              {"user": "4", "num": 8, "categories": ["odd"]},
              {"user": "9", "num": 6, "blackList": ["2", "3"]},
              {"user": "stranger", "num": 4}):
        assert mesh.query(q) == flat.query(q)
