"""The port's gang supervisor (``parallel/supervisor.py``, the gang half)
on the CPU, mirroring the reference's tests/test_gang_supervisor.py:305,
:418 and :487:

- a two-rank gloo gang of the data-parallel ALS (``--device cpu``) is
  within 2e-4 of the JAX reference's ``train_als`` on the union triple,
  explicit (λ·n_ratings), implicit and binary;
- the gang loses worker 1 to a SIGKILL (``train.sweep:crash``) after its
  first checkpoint; the supervisor records one gang restart, relaunches
  with ``--resume``, and the factors equal the uninterrupted gang's bit
  for bit;
- a stop mid-train drains the gang: every rank checkpoints at the same
  sweep boundary and exits with the drain code, nothing restarts, and a
  fresh ``--resume`` gang completes with the uninterrupted factors;
- ``pio train --num-workers 2`` end to end on a partitioned JSONL log, for
  the Recommendation and Similar-Product templates: each worker read only
  its own shards (disjoint, covering the log), the leader alone wrote the
  one COMPLETED instance, the model's factors are within 2e-4 of the
  reference's ``train_als`` on the union triple in the gang's indices, and
  the model serves;
- the same ``Supervisor`` still runs ``restart_scope="worker"`` services.

Every gang runs under a time limit of at most 60 s.
"""

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.parallel import mesh as ref_mesh  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage import jsonl  # noqa: E402
from incubator_predictionio_torch.data.storage.datamap import DataMap  # noqa: E402
from incubator_predictionio_torch.data.storage.event import Event  # noqa: E402
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402
from incubator_predictionio_torch.parallel.supervisor import (  # noqa: E402
    COMPLETED, DRAIN_EXIT_CODE, DRAINED, GangConfig, Supervisor,
)
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.persist import (  # noqa: E402
    models_from_bytes,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_worker as W  # noqa: E402

pytestmark = [pytest.mark.gang]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
N_ITERS = 6
TOL = 2e-4


def _reference(u, i, r, n_users, n_items, **params):
    mesh1 = ref_mesh.mesh_from_devices(devices=jax.devices()[:1])
    return ref_als.train_als(
        u, i, r, n_users, n_items,
        ref_als.ALSParams(compute_dtype="float32", **params), mesh=mesh1)


MODES = ("explicit", "implicit", "binary")


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """One uninterrupted gang's factors for every mode (the explicit one
    checkpointing every 2 iterations)."""
    tmp = tmp_path_factory.mktemp("plain")
    out = str(tmp / "f.npz")
    sup, outcome = W.supervise(tmp, out, str(tmp / "ckpt"), N_ITERS,
                               ",".join(MODES))
    assert outcome == COMPLETED and sup.restarts == 0, sup.events
    return dict(np.load(out))


@pytest.mark.parametrize("mode", MODES)
def test_gang_matches_reference_train_als(uninterrupted, mode):
    """A REAL two-process gloo gang (``--device cpu``), each rank holding
    half of a seeded triple in global indices: within 2e-4 of the
    reference's ``train_als`` on the union triple, explicit (λ·n_ratings),
    implicit and binary."""
    u, i, r = W.data(mode)
    p = W.params(mode, N_ITERS)
    want = _reference(u, i, r, W.N_USERS, W.N_ITEMS, **{
        f: getattr(p, f) for f in ("rank", "num_iterations", "reg",
                                   "lambda_scaling", "implicit_prefs",
                                   "alpha", "seed")})
    np.testing.assert_allclose(uninterrupted[f"{mode}_user"],
                               want.user_factors, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(uninterrupted[f"{mode}_item"],
                               want.item_factors, rtol=TOL, atol=TOL)


def test_sigkill_gang_restart_resumes_from_checkpoint(tmp_path,
                                                      uninterrupted):
    out, ckpt = str(tmp_path / "f.npz"), str(tmp_path / "ckpt")

    def chaos(attempt, idx):
        # worker 1 dies at its 2nd sweep: after the step-2 snapshot
        return ({"PIO_FAULT_SPEC": "train.sweep:crash:2"}
                if attempt == 0 and idx == 1 else {})

    sup, outcome = W.supervise(tmp_path, out, ckpt, N_ITERS, "explicit",
                               per_worker_env=chaos)
    assert outcome == COMPLETED, sup.events
    assert sup.restarts == 1
    failures = [e for e in sup.events if e["type"] == "failure"]
    assert [(f["reason"], f["worker"]) for f in failures] == [("exit", 1)]
    starts = [e for e in sup.events if e["type"] == "gangStart"]
    assert [(s["attempt"], s["resume"]) for s in starts] == [
        (0, False), (1, True)]
    assert starts[0]["port"] != starts[1]["port"]  # a fresh rendezvous
    got = np.load(out)
    assert np.array_equal(got["explicit_user"],
                          uninterrupted["explicit_user"])
    assert np.array_equal(got["explicit_item"],
                          uninterrupted["explicit_item"])
    doc = json.load(open(os.path.join(sup.run_dir, "supervisor.json")))
    assert doc["state"] == "completed" and doc["restarts"] == 1
    assert doc["restartScope"] == "gang"


def test_stop_drains_the_gang_then_resume_completes(tmp_path,
                                                   uninterrupted):
    out, ckpt = str(tmp_path / "f.npz"), str(tmp_path / "ckpt")

    def stop_after_first_sweep(sup):
        hb0 = os.path.join(sup.run_dir, "worker_0.hb")
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline and not os.path.exists(hb0):
            time.sleep(0.02)
        sup.request_stop()

    # every sweep of worker 0 sleeps 1.5 s (its peer waits in the
    # all-reduce), so the stop lands with sweeps still ahead even on a
    # loaded host
    sup, outcome = W.supervise(
        tmp_path, out, ckpt, N_ITERS, "explicit",
        per_worker_env=lambda a, i: (
            {"PIO_FAULT_SPEC": "train.sweep:latency:100:1.5"} if i == 0
            else {}),
        on_start=stop_after_first_sweep)
    assert outcome == DRAINED, sup.events
    assert sup.restarts == 0 and not os.path.exists(out)
    done = [e for e in sup.events if e["type"] == "drainDone"]
    assert done and not done[0]["stragglers"], sup.events
    assert set(done[0]["rcs"].values()) == {DRAIN_EXIT_CODE}
    steps = sorted(int(n.split(".")[0]) for n in os.listdir(ckpt))
    assert steps and steps[-1] < N_ITERS
    doc = json.load(open(os.path.join(sup.run_dir, "supervisor.json")))
    assert doc["state"] == "drained"

    sup2, outcome2 = W.supervise(tmp_path, out, ckpt, N_ITERS, "explicit",
                                 extra=("--resume",))
    assert outcome2 == COMPLETED, sup2.events
    got = np.load(out)
    assert np.array_equal(got["explicit_user"],
                          uninterrupted["explicit_user"])
    assert np.array_equal(got["explicit_item"],
                          uninterrupted["explicit_item"])


_SERVICE = r"""
import os, signal, sys, time
hb = os.environ["PIO_WORKER_HEARTBEAT_FILE"]
assert "PIO_GANG_WORKER" not in os.environ
signal.signal(signal.SIGTERM, lambda s, f: sys.exit(3))
while True:
    with open(hb, "a"):
        os.utime(hb, None)
    time.sleep(0.05)
"""


def test_worker_scope_still_supervises_services(tmp_path):
    import threading

    sup = Supervisor(
        [sys.executable, "-c", _SERVICE], 2,
        config=GangConfig(num_workers=2, heartbeat_ms=50, stall_ms=20_000,
                          init_grace_ms=20_000, max_restarts=2,
                          drain_ms=10_000, poll_ms=25),
        run_dir=str(tmp_path / "svc"), restart_scope="worker")
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and sup.worker_pid(1) is None:
        time.sleep(0.02)
    first = sup.worker_pid(1)
    os.kill(first, 9)
    while time.monotonic() < deadline and sup.worker_pid(1) in (None, first):
        time.sleep(0.02)
    assert sup.worker_restarts == [0, 1] and sup.worker_pid(0) is not None
    sup.request_stop()
    t.join(30)
    assert not t.is_alive() and sup.state == DRAINED


# ---------------------------------------------------------------------------
# pio train --num-workers 2, end to end
# ---------------------------------------------------------------------------

def _store_env(tmp_path) -> dict:
    base = str(tmp_path / "store")
    os.makedirs(base, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update({
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        "PIO_FS_BASEDIR": base,
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
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


def _seed_partitions(env, monkeypatch) -> None:
    """App "gangapp" and three .p<i> shards of rate, view and item $set
    events (seeded)."""
    out = subprocess.run(CONSOLE + ["app", "new", "gangapp"], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    store = _storage(env)
    app_id = store.get_meta_data_apps().get_by_name("gangapp").id
    events_dir = store.get_l_events().events_dir
    store.close()
    rng = np.random.default_rng(4)
    t0 = 1_767_225_600
    import datetime as dt

    def at(s):
        return dt.datetime.fromtimestamp(t0 + int(s), dt.timezone.utc)

    for part in range(3):
        monkeypatch.setenv("PIO_EVENT_PARTITION", str(part))
        st = jsonl.JSONLEvents(events_dir)
        monkeypatch.delenv("PIO_EVENT_PARTITION")
        evs = []
        for j in range(150):
            name = "view" if j % 3 == 0 else "rate"
            props = ({} if name == "view"
                     else {"rating": float(rng.integers(1, 6))})
            evs.append(Event(
                event=name, entity_type="user",
                entity_id=f"u{rng.integers(0, 30)}",
                target_entity_type="item",
                target_entity_id=f"i{rng.integers(0, 20)}",
                properties=DataMap(props), event_time=at(rng.integers(0, 9e4))))
        evs += [Event(event="$set", entity_type="item", entity_id=f"i{j}",
                      properties=DataMap({"categories": [f"c{j % 3}"]}),
                      event_time=at(1e5 + j))
                for j in range(part, 20, 3)]
        st.insert_batch(evs, app_id)


ENGINES = {
    "recommendation": ("incubator_predictionio_torch.models.recommendation."
                       "RecommendationEngine", ["rate"],
                       dict(implicit_prefs=False, lambda_scaling="nratings",
                            reg=0.05)),
    "similar_product": ("incubator_predictionio_torch.models."
                        "similar_product.SimilarProductEngine", ["view"],
                        dict(implicit_prefs=True, alpha=1.0, reg=0.05)),
}


@pytest.mark.parametrize("template", sorted(ENGINES))
def test_pio_train_num_workers_cli_e2e(tmp_path, monkeypatch, template):
    factory, names, algo = ENGINES[template]
    env = _store_env(tmp_path)
    _seed_partitions(env, monkeypatch)
    algo_json = {"rank": 4, "numIterations": N_ITERS, "lambda": algo["reg"],
                 "seed": 5}
    if template == "recommendation":
        algo_json.update(lambdaScaling="nratings")
    with open(tmp_path / "engine.json", "w") as fh:
        json.dump({"id": "default", "engineFactory": factory,
                   "datasource": {"params": {"appName": "gangapp",
                                             "eventNames": names}},
                   "algorithms": [{"name": "als", "params": algo_json}]}, fh)
    out = subprocess.run(
        CONSOLE + ["train", "--num-workers", "2", "--checkpoint-every", "2",
                   "--device", "cpu"], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Gang training completed" in out.stdout
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["state"] == "completed" and report["restarts"] == 0
    iid = report["engineInstanceId"]
    workers = report["workers"]
    assert [w["timings"]["rank"] for w in workers] == [0, 1]
    assert all(w["engineInstanceId"] == iid for w in workers)
    store = _storage(env)
    canonical = jsonl.shard_paths(store.get_l_events().events_dir, 1)
    assert len(canonical) == 4  # the base log and .p0-.p2
    # canonical position j → worker j mod 2: disjoint, covering the log
    assert [w["timings"]["shards"] for w in workers] == [canonical[0::2],
                                                        canonical[1::2]]
    assert all(w["timings"]["half_steps"] == 2 * N_ITERS for w in workers)
    assert all(w["timings"]["allreduce_bytes"] > 0 for w in workers)

    rows = [i for i in store.get_meta_data_engine_instances().get_all()
            if i.status == "COMPLETED"]
    assert [r.id for r in rows] == [iid]  # the followers wrote nothing
    _, persisted = models_from_bytes(model_artifact.read_model(store, iid))
    stored = persisted[0]
    u, i, r, users, items = PEventStore.find_ratings(
        "gangapp", event_names=names,
        rating_from_props=template == "recommendation", storage=store)
    assert sum(w["timings"]["local_ratings"] for w in workers) == len(u)
    from incubator_predictionio_torch.data.bimap import BiMap

    gang_items = BiMap.from_persisted(stored["items"])
    if template == "recommendation":
        gang_users = BiMap.from_persisted(stored["users"])
        gu = np.asarray([gang_users(users.inverse(int(x))) for x in u])
    else:  # the model keeps no user map: rows follow the merged read's
        gu = None
    gi = np.asarray([gang_items(items.inverse(int(x))) for x in i])
    assert sorted(gang_items.keys()) == sorted(items.keys())
    want = _reference(u if gu is None else gu, gi, r, len(users), len(items),
                      rank=4, num_iterations=N_ITERS, seed=5, **algo)
    np.testing.assert_allclose(stored["item_factors"], want.item_factors,
                               rtol=TOL, atol=TOL)
    if template == "similar_product":
        cats = {k: set(v) for k, v in stored["item_categories"].items()}
        merged = PEventStore.aggregate_properties("gangapp", "item",
                                                  storage=store)
        assert cats == {k: set(pm.get("categories")) for k, pm in
                        merged.items()}
        store.close()
        return
    np.testing.assert_allclose(stored["user_factors"], want.user_factors,
                               rtol=TOL, atol=TOL)
    store.close()
    # the gang's model serves like a single-process one
    queries = tmp_path / "q.jsonl"
    queries.write_text("".join(json.dumps({"user": f"u{j}", "num": 3}) + "\n"
                               for j in range(3)))
    served = subprocess.run(
        CONSOLE + ["batchpredict", "--device", "cpu", "--input",
                   str(queries), "--output", str(tmp_path / "p.jsonl")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=60)
    assert served.returncode == 0, served.stderr
    preds = [json.loads(line) for line in open(tmp_path / "p.jsonl")]
    assert [len(p["prediction"]["itemScores"]) for p in preds] == [3, 3, 3]
    assert collections.Counter(
        it["item"] for p in preds for it in p["prediction"]["itemScores"])
