"""``pio train --num-workers N --feed merged`` end to end on the CPU: every
worker reads the merged view and the gang trains on the port's slab loop
(``ops.als.train_als`` in a gang). The persisted model is held against the
JAX package's ``train_als`` on a CPU mesh of the gang's shape at the
reference's tolerances (1-D: tests/test_multihost.py:127; 2-D:
tests/test_als_model_axis.py:55):

- Recommendation on a SQLite event store (a gang on a store that is not
  the JSONL log reads the merged view), 2 workers;
- E-Commerce on the JSONL log, 2 workers;
- Recommendation with ``PIO_MESH_SHAPE=2x2`` and 4 workers (the 2-D ALX
  layout), then one query of that model through ``batchpredict``;
- a mesh shape that is not the gang is refused before anything spawns.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.parallel import mesh as ref_mesh  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage.datamap import DataMap  # noqa: E402
from incubator_predictionio_torch.data.storage.event import Event  # noqa: E402
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.persist import (  # noqa: E402
    models_from_bytes,
)

pytestmark = [pytest.mark.gang]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
ITERS = 4
MODELS = "incubator_predictionio_torch.models."


def _env(tmp_path, events: str) -> dict:
    base = str(tmp_path / "store")
    os.makedirs(base, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update({
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        "PIO_FS_BASEDIR": base,
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": events,
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(base, "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(base, "events"),
        "PIO_WORKER_HEARTBEAT_MS": "100", "PIO_SUPERVISOR_POLL_MS": "25",
        "PIO_WORKER_INIT_GRACE_MS": "40000"})
    return env


def _storage(env) -> Storage:
    return Storage({k: v for k, v in env.items()
                    if k.startswith("PIO_STORAGE_")})


def _seed(env, names) -> None:
    """App "slab" with seeded events of ``names`` (a rating on "rate")."""
    out = subprocess.run(CONSOLE + ["app", "new", "slab"], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    store = _storage(env)
    app_id = store.get_meta_data_apps().get_by_name("slab").id
    rng = np.random.default_rng(8)
    evs = []
    for j in range(500):
        name = names[j % len(names)]
        props = ({"rating": float(rng.integers(1, 6))} if name == "rate"
                 else {})
        evs.append(Event(event=name, entity_type="user",
                         entity_id=f"u{rng.integers(0, 35)}",
                         target_entity_type="item",
                         target_entity_id=f"i{rng.integers(0, 25)}",
                         properties=DataMap(props)))
    evs += [Event(event="$set", entity_type="item", entity_id=f"i{j}",
                  properties=DataMap({"categories": [f"c{j % 3}"]}))
            for j in range(25)]
    store.get_l_events().insert_batch(evs, app_id)
    store.close()


def _engine(tmp_path, factory: str, names, algo: dict,
            name: str = "als") -> None:
    with open(tmp_path / "engine.json", "w", encoding="utf-8") as fh:
        json.dump({"id": "default", "engineFactory": MODELS + factory,
                   "datasource": {"params": {"appName": "slab",
                                             "eventNames": names}},
                   "algorithms": [{"name": name, "params": dict(
                       algo, rank=4, numIterations=ITERS, seed=5)}]}, fh)


def _gang(env, tmp_path, workers: int, mesh: str = "") -> dict:
    run_env = dict(env, PIO_MESH_SHAPE=mesh) if mesh else env
    out = subprocess.run(
        CONSOLE + ["train", "--num-workers", str(workers), "--feed", "merged",
                   "--device", "cpu"], env=run_env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=90)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["state"] == "completed" and report["restarts"] == 0
    assert len(report["workers"]) == workers
    return report


def _hold(env, report, names, shape, tol, explicit: bool, **params):
    """The persisted model against the reference's train_als on a mesh of
    ``shape`` over the merged read (the gang's id maps are that read's)."""
    store = _storage(env)
    iid = report["engineInstanceId"]
    rows = [i.id for i in store.get_meta_data_engine_instances().get_all()
            if i.status == "COMPLETED"]
    assert rows == [iid]  # only rank 0 persisted
    _, persisted = models_from_bytes(model_artifact.read_model(store, iid))
    stored = persisted[0]
    u, i, r, users, items = PEventStore.find_ratings(
        "slab", event_names=names, rating_from_props=explicit, storage=store)
    store.close()
    for w in report["workers"]:
        t = w["timings"]
        assert t["feed"] == "merged" and t["local_ratings"] == len(u)
        assert t["half_steps"] == 2 * ITERS
        assert t["mesh"] == list(shape) + [1] * (2 - len(shape))
    devices = jax.devices("cpu")[:int(np.prod(shape))]
    mesh = (ref_mesh.mesh_from_devices(devices=devices) if len(shape) == 1
            else ref_mesh.mesh_from_devices(
                shape=shape, axis_names=(ref_mesh.DATA_AXIS,
                                         ref_mesh.MODEL_AXIS),
                devices=devices))
    want = ref_als.train_als(u, i, r, len(users), len(items),
                             ref_als.ALSParams(rank=4, num_iterations=ITERS,
                                               seed=5, compute_dtype="float32",
                                               **params), mesh=mesh)
    np.testing.assert_allclose(stored["item_factors"], want.item_factors,
                               **tol)
    if "user_factors" in stored:
        np.testing.assert_allclose(stored["user_factors"], want.user_factors,
                                   **tol)
    return stored


def test_recommendation_merged_gang_on_sqlite(tmp_path):
    env = _env(tmp_path, "DB")
    _seed(env, ["rate"])
    _engine(tmp_path, "recommendation.RecommendationEngine", ["rate"],
            {"lambda": 0.05, "lambdaScaling": "nratings"})
    report = _gang(env, tmp_path, 2)
    _hold(env, report, ["rate"], (2,), dict(rtol=2e-4, atol=2e-5), True,
          reg=0.05, lambda_scaling="nratings")


def test_ecommerce_merged_gang_on_jsonl(tmp_path):
    env = _env(tmp_path, "LOG")
    _seed(env, ["view", "buy"])
    _engine(tmp_path, "ecommerce.ECommerceEngine", ["view", "buy"],
            {"lambda": 0.05, "alpha": 1.0, "appName": "slab"}, "ecomm")
    report = _gang(env, tmp_path, 2)
    stored = _hold(env, report, ["view", "buy"], (2,),
                   dict(rtol=2e-4, atol=2e-5), False, reg=0.05,
                   implicit_prefs=True, alpha=1.0)
    assert stored["item_categories"]


def test_recommendation_alx_gang_of_four(tmp_path):
    env = _env(tmp_path, "DB")
    _seed(env, ["rate"])
    _engine(tmp_path, "recommendation.RecommendationEngine", ["rate"],
            {"lambda": 0.05, "lambdaScaling": "nratings"})
    report = _gang(env, tmp_path, 4, mesh="2x2")
    assert [w["timings"]["coords"] for w in report["workers"]] == [
        [0, 0], [0, 1], [1, 0], [1, 1]]
    assert all(w["timings"]["allreduce_bytes"] > 0
               for w in report["workers"])
    stored = _hold(env, report, ["rate"], (2, 2),
                   dict(rtol=5e-4, atol=5e-5), True, reg=0.05,
                   lambda_scaling="nratings")
    # the 2-D gang's model serves like any other
    queries = tmp_path / "q.jsonl"
    queries.write_text(json.dumps({"user": "u1", "num": 3}) + "\n")
    served = subprocess.run(
        CONSOLE + ["batchpredict", "--device", "cpu", "--input",
                   str(queries), "--output", str(tmp_path / "p.jsonl")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=60)
    assert served.returncode == 0, served.stderr
    pred = json.loads(open(tmp_path / "p.jsonl").readline())["prediction"]
    from incubator_predictionio_torch.data.bimap import BiMap

    users = BiMap.from_persisted(stored["users"])
    items = BiMap.from_persisted(stored["items"])
    scores = stored["item_factors"] @ stored["user_factors"][users("u1")]
    want = [items.inverse(int(j)) for j in
            np.argsort(-scores, kind="stable")[:3]]
    assert [s["item"] for s in pred["itemScores"]] == want


def test_mesh_shape_not_the_gang_is_refused(tmp_path):
    env = _env(tmp_path, "DB")
    _engine(tmp_path, "recommendation.RecommendationEngine", ["rate"], {})
    out = subprocess.run(
        CONSOLE + ["train", "--num-workers", "2", "--feed", "merged",
                   "--device", "cpu"], env=dict(env, PIO_MESH_SHAPE="2x2"),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
    assert out.returncode == 1, out.stderr
    assert "product must be the number of workers" in out.stderr
    assert not os.path.isdir(tmp_path / "store" / "gang")  # nothing spawned
