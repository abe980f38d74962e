"""The CCO templates' gangs on the CPU (``ops/llr.py`` with
``collectives=``; the Universal Recommender and Complementary Purchase
under ``pio train --num-workers 2``), held against the JAX package and
against one process of the port:

- real gloo gangs of 2 and 3 ranks (tests/torch_cco_worker.py), every rank
  given the same events with three heavy users: the full, striped
  (``PIO_UR_FULL_MATRIX_ELEMS``), fused and per-pair paths, and the fused
  counts. At 3 ranks one rank's block of the light ranges is padding only
  (and two ranks' heavy blocks). Every rank's indicators equal the
  single-process port's bit for bit; the summed counts equal the dense
  counts exactly; the indicators meet tests/cco_parity.py's rule (G²
  within 2e-6·N·ln N, the top-k rule) against the JAX ``cco_indicators`` /
  ``cco_indicators_multi`` on a 2- or 4-device CPU mesh; every rank makes
  the same all-reduces;
- ``pio train --num-workers 2`` of the Universal Recommender (fused, full
  path) and of Complementary Purchase (the striped path, forced) on a
  JSONL log: the persisted indicators equal the single-process ``pio
  train``'s bit for bit, and each worker's report carries its share.
"""

import datetime as dt
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from cco_parity import dense_counts, g2_tol, hold_topk, reference_g2  # noqa: E402
from incubator_predictionio_tpu.ops import llr as R  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import mesh_from_devices  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage.base import App  # noqa: E402
from incubator_predictionio_torch.data.storage.datamap import DataMap  # noqa: E402
from incubator_predictionio_torch.data.storage.event import Event  # noqa: E402
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.persist import (  # noqa: E402
    models_from_bytes,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_cco_worker as W  # noqa: E402

pytestmark = [pytest.mark.gang]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
MODELS = "incubator_predictionio_torch.models."
CASES = ",".join(W.CASES)


def _reference(case: str, world: int, monkeypatch) -> dict:
    """The JAX package's indicators of ``case`` on a CPU mesh of 2 devices
    (a gang of 2) or 4 (a gang of 3: the reference pads to its devices)."""
    call, cap = W.CASES[case]
    if cap:
        monkeypatch.setenv("PIO_UR_FULL_MATRIX_ELEMS", cap)
    else:
        monkeypatch.delenv("PIO_UR_FULL_MATRIX_ELEMS", raising=False)
    mesh = mesh_from_devices(devices=jax.devices()[:2 if world == 2 else 4])
    pu, pi, su, si = W.events()
    kw = dict(max_correlators=W.K, u_chunk=W.U_CHUNK, item_block=32,
              mesh=mesh)
    if call == "pair":
        ind = R.cco_indicators(pu, pi, su, si, W.N_USERS, W.N_ITEMS, **kw)
        return {"view": ind}
    return R.cco_indicators_multi(
        pu, pi, {"buy": (pu, pi), "view": (su, si)}, W.N_USERS, W.N_ITEMS,
        **kw)


@pytest.mark.parametrize("world", [2, 3])
def test_cco_gang_equals_one_process_and_the_jax_mesh(tmp_path, world,
                                                      monkeypatch):
    got = W.run_gang(world, str(tmp_path / "g"), CASES)
    for rc, out, err in got:
        assert rc == 0, out[-2000:] + err[-3000:]
    reports = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in got]
    ranks = [np.load(tmp_path / f"g.{r}.npz") for r in range(world)]
    pu, pi, su, si = W.events()
    secs = {"buy": (pu, pi), "view": (su, si)}
    n = W.N_USERS
    for case, (call, _) in W.CASES.items():
        monkeypatch.delenv("PIO_UR_FULL_MATRIX_ELEMS", raising=False)
        single = W.run_case(case)
        if case == "counts":
            for name, c in single.items():
                want = dense_counts(pu, pi, *secs[name], n, W.N_ITEMS)[0]
                assert np.array_equal(c, want)
                for r in ranks:
                    assert np.array_equal(r[f"counts:{name}"], want), name
            continue
        ref = _reference(case, world, monkeypatch)
        for name, (idx, score) in single.items():
            for r in ranks:  # every rank: the single process bit for bit
                assert np.array_equal(r[f"{case}:{name}:idx"], idx)
                assert np.array_equal(r[f"{case}:{name}:score"], score)
            c, n_i, n_j = dense_counts(pu, pi, *secs[name], n, W.N_ITEMS)
            want = ref[name]
            hold_topk(idx, score, np.where(want.idx >= 0, want.score, 0.0),
                      reference_g2(c, n_i, n_j, n), g2_tol(n))
        timings = [rep[case] for rep in reports]
        assert {t["world"] for t in timings} == {world}
        assert [t["rank"] for t in timings] == list(range(world))
        assert all(t["heavy_users"] == len(W.BOTS) for t in timings)
        # every rank sums alike: the same calls and bytes
        assert len({(t["allreduce_calls"], t["allreduce_bytes"])
                    for t in timings}) == 1
        pairs = 1 if call == "pair" else 2
        if case in ("full", "fused"):
            assert timings[0]["allreduce_calls"] == pairs
            assert timings[0]["allreduce_bytes"] == \
                pairs * 4 * W.N_ITEMS ** 2
        else:  # one [block, I] stripe at a time, every stripe
            assert timings[0]["path"].endswith("striped")
            assert timings[0]["allreduce_calls"] == \
                pairs * -(-W.N_ITEMS // 32)
        # the range axis padded to the gang: one block per rank
        assert [t["local_ranges"] for t in timings] == \
            [-(-timings[0]["n_ranges"] // world)] * world
    assert reports[0]["fused"]["path"] == "fused"
    assert reports[0]["per_pair"]["path"] == "per_pair_striped"


# -- pio train --num-workers 2 ------------------------------------------------


T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


def _store_env(tmp_path) -> dict:
    base = str(tmp_path / "store")
    os.makedirs(base, exist_ok=True)
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(base, "pio.sqlite"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
            "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(base, "events")}


def _cli_env(tmp_path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(_store_env(tmp_path),
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               PIO_FS_BASEDIR=str(tmp_path / "store"),
               PIO_WORKER_HEARTBEAT_MS="100", PIO_SUPERVISOR_POLL_MS="25",
               PIO_WORKER_INIT_GRACE_MS="40000", **extra)
    return env


def _write_log(tmp_path, app: str, events: list) -> None:
    store = Storage(_store_env(tmp_path))
    try:
        app_id = store.get_meta_data_apps().insert(App(0, app))
        store.get_l_events().init(app_id)
        store.get_l_events().insert_batch(events, app_id)
    finally:
        store.close()


def _ur_events(n_users=300, n_items=400, seed=4) -> list:
    """buy and view events of two taste groups, three heavy viewers, and
    item ``$set``s of categories."""
    rng = np.random.default_rng(seed)
    evs, t = [], 0

    def add(name, u, i):
        nonlocal t
        evs.append(Event(event=name, entity_type="user", entity_id=f"u{u}",
                         target_entity_type="item",
                         target_entity_id=f"i{i}",
                         event_time=T0 + dt.timedelta(seconds=t)))
        t += 1

    for u in range(n_users):
        lo = 0 if u % 2 else n_items // 2
        for i in rng.integers(lo, lo + n_items // 2, 3):
            add("buy", u, i)
        views = 600 if u in (3, 150, 299) else 6
        for i in rng.integers(0, n_items, views):
            add("view", u, i)
    for j in range(n_items):
        evs.append(Event(event="$set", entity_type="item", entity_id=f"i{j}",
                         properties=DataMap({"categories": [f"c{j % 3}"]}),
                         event_time=T0 + dt.timedelta(seconds=t + j)))
    return evs


def _basket_events(n_shoppers=300, seed=6) -> list:
    """One basket per shopper (a combo and noise, minutes apart), a later
    basket for every third."""
    rng = np.random.default_rng(seed)
    evs = []
    for s in range(n_shoppers):
        base = T0 + dt.timedelta(hours=3 * s)
        combo = (["burger", "bun", "ketchup"] if s % 2
                 else ["pasta", "sauce"])
        basket = combo + [f"n{rng.integers(30)}" for _ in range(2)]
        if s % 3 == 0:
            basket.append(f"n{rng.integers(30)}")
        for j, item in enumerate(basket):
            evs.append(Event(event="buy", entity_type="user",
                             entity_id=f"s{s}", target_entity_type="item",
                             target_entity_id=item,
                             event_time=base + dt.timedelta(minutes=j)))
    return evs


def _engine(tmp_path, factory: str, app: str, algo: str, params: dict,
            datasource: dict) -> None:
    with open(tmp_path / "engine.json", "w", encoding="utf-8") as fh:
        json.dump({"id": "default", "engineFactory": MODELS + factory,
                   "datasource": {"params": {"appName": app, **datasource}},
                   "algorithms": [{"name": algo, "params": params}]}, fh)


def _train(env, tmp_path, *extra) -> dict:
    out = subprocess.run(CONSOLE + ["train", "--device", "cpu", *extra],
                         env=env, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    if "--num-workers" in extra:
        assert report["state"] == "completed" and report["restarts"] == 0
        assert len(report["workers"]) == 2 and all(report["workers"])
    return report


def _persisted(env, iid: str) -> dict:
    store = Storage({k: v for k, v in env.items()
                     if k.startswith("PIO_STORAGE_")})
    try:
        _, persisted = models_from_bytes(model_artifact.read_model(store,
                                                                   iid))
    finally:
        store.close()
    return persisted[0]


def _leaves(v, prefix=""):
    """Every numpy leaf of a persisted model (nested dicts flattened)."""
    if isinstance(v, dict):
        for k in sorted(v):
            yield from _leaves(v[k], f"{prefix}/{k}")
    elif isinstance(v, np.ndarray):
        yield prefix, v


def _hold_gang(env, tmp_path, path: str) -> list:
    """The gang's persisted model equal to one process's, leaf for leaf;
    returns the workers' timings."""
    gang = _train(env, tmp_path, "--num-workers", "2")
    single = _train(env, tmp_path)
    got = dict(_leaves(_persisted(env, gang["engineInstanceId"])))
    want = dict(_leaves(_persisted(env, single["engineInstanceId"])))
    assert got.keys() == want.keys() and any("score" in k for k in got)
    for name, v in want.items():
        assert np.array_equal(got[name], v), name
    workers = [w["timings"] for w in gang["workers"]]
    assert [t["rank"] for t in workers] == [0, 1]
    assert all(t["world"] == 2 and t["path"] == path for t in workers)
    assert len({(t["allreduce_calls"], t["allreduce_bytes"])
                for t in workers}) == 1
    assert single["timings"]["path"] == path
    assert "allreduce_calls" not in single["timings"]
    return workers


def test_universal_recommender_gang_equals_one_process(tmp_path):
    """Both ranks read the merged log and count their block of the user
    ranges (user_chunk 64: 5 ranges), the fused path's two [I, I] pairs
    all-reduced; the persisted indicators equal one process's."""
    env = _cli_env(tmp_path)
    _write_log(tmp_path, "ur", _ur_events())
    _engine(tmp_path, "universal_recommender.UniversalRecommenderEngine",
            "ur", "ur", {"appName": "ur", "maxCorrelatorsPerItem": 8,
                         "user_chunk": 64},
            {"eventNames": ["buy", "view"]})
    workers = _hold_gang(env, tmp_path, "fused")
    assert all(t["allreduce_calls"] == 2 and t["local_ranges"] == 3
               and t["heavy_users"] == 3 for t in workers)


def test_complementary_purchase_gang_on_the_striped_path(tmp_path):
    """The baskets are formed alike on both ranks; with the accumulator
    cap below I² the counts go stripe by stripe, each stripe all-reduced;
    the persisted indicators equal one process's."""
    env = _cli_env(tmp_path, PIO_UR_FULL_MATRIX_ELEMS="100")
    _write_log(tmp_path, "shop", _basket_events())
    _engine(tmp_path, "complementary_purchase.ComplementaryPurchaseEngine",
            "shop", "cooccurrence",
            {"basketWindowSecs": 3600, "maxCorrelatorsPerItem": 6}, {})
    workers = _hold_gang(env, tmp_path, "striped")
    assert all(t["allreduce_calls"] >= 1 for t in workers)
