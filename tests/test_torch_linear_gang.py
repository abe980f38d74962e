"""The linear templates' gang trainers on the CPU, held against the JAX
package (tolerances: NB bit for bit; LR by the rule of
tests/test_torch_linear.py — final loss within 1e-5 relative, iterations
within ±2 of the reference's, the same argmax wherever the top two logits
differ by more than 1e-3):

- ``train_feed._examples_from_map`` equal to the reference's for (worker,
  W) ∈ {(0, 2), (1, 2), (2, 3)} on one seeded entity map;
- ``train_feed.partition_examples`` of both workers of a gang of 2 (and of
  3) on a partitioned JSONL log (the all-gathers answered in this process
  with every worker's payload) equal to the reference's, their union equal
  to the merged read;
- gloo gangs of 2 and 3 processes (tests/torch_gang_worker.py ``linear``):
  the process-local NB and COO NB bit-equal to the JAX trainers on the
  union, the process-local LR at reg 0.1 by the LR rule against the JAX
  ``train_logistic_regression`` on the union (a regularizer counted once
  per rank would miss it), the blocks widely skewed and one rank empty;
  every rank ends with the same models after the same number of sums;
- ``pio train --num-workers 2`` end to end: Classification NB on the
  partition feed and Text-Classification NB on the merged corpus, each
  persisting the single-process ``pio train``'s model bit for bit;
  Classification LR with ``--feed merged`` by the LR rule against the JAX
  trainer on the merged read;
- the Universal Recommender and Complementary Purchase on the partition
  feed: refused before anything spawns under a 2-D ``PIO_MESH_SHAPE``,
  else every rank reads the merged view and the gang persists one
  process's model bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.ops import linear as ref  # noqa: E402
from incubator_predictionio_tpu.workflow import train_feed as ref_feed  # noqa: E402
from incubator_predictionio_tpu.workflow.input_pipeline import (  # noqa: E402
    PipelineConfig as RefPipelineConfig,
)
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage.base import App  # noqa: E402
from incubator_predictionio_torch.data.storage.datamap import DataMap  # noqa: E402
from incubator_predictionio_torch.data.storage.event import Event  # noqa: E402
from incubator_predictionio_torch.data.storage.jsonl import JSONLEvents  # noqa: E402
from incubator_predictionio_torch.data.storage.jsonl import (  # noqa: E402
    shard_paths as jsonl_shard_paths,
)
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402
from incubator_predictionio_torch.workflow import (  # noqa: E402
    model_artifact, train_feed,
)
from incubator_predictionio_torch.workflow.persist import (  # noqa: E402
    models_from_bytes,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_worker as W  # noqa: E402
from lbfgs_stop import ref_stop  # noqa: E402

pytestmark = [pytest.mark.gang]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
MODELS = "incubator_predictionio_torch.models."
SERIAL = RefPipelineConfig(mode="off")
LOSS_RTOL, ITER_SLACK, MARGIN = 1e-5, 2, 1e-3
ATTRS = ["attr0", "attr1", "attr2"]


# -- the LR rule ---------------------------------------------------------------


def _loss(x, y, w, b, reg):
    z = x.astype(np.float64) @ w + b
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return (-logp[np.arange(len(y)), y].mean()
            + 0.5 * reg * float((w.astype(np.float64) ** 2).sum()))


def _ref_lr(x, y, c, reg, max_iters=100):
    m = ref.train_logistic_regression(x, y, c, reg=reg, max_iters=max_iters,
                                      pipeline=SERIAL)
    return m.weights, m.intercept


def _ref_stop(x, y, c, reg):
    """The reference's iteration count: the least max_iters whose fit
    equals the uncapped one's (None when it runs all 100), read where the
    fits repeat bit for bit (tests/lbfgs_stop.py)."""
    return ref_stop(x, y, c, reg)


def _hold_lr(x, y, c, reg, w, b, iterations):
    w_ref, b_ref = _ref_lr(x, y, c, reg)
    want = _loss(x, y, w_ref, b_ref, reg)
    got = _loss(x, y, w, b, reg)
    assert abs(got - want) <= LOSS_RTOL * want, (got, want)
    stop = _ref_stop(x, y, c, reg)
    assert stop is not None and abs(iterations - stop) <= ITER_SLACK, \
        (iterations, stop)
    z_got, z_ref = x @ w + b, x @ w_ref + b_ref

    def margin(z):
        top2 = np.sort(z, axis=1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    held = (margin(z_got) > MARGIN) & (margin(z_ref) > MARGIN)
    assert held.sum() > len(y) // 2
    assert np.array_equal(z_got.argmax(1)[held], z_ref.argmax(1)[held])


# -- the feed's labeled examples ----------------------------------------------


def _entity_map(seed=5):
    rng = np.random.default_rng(seed)
    merged = {}
    for j in rng.permutation(40):
        props = {a: int(rng.integers(0, 6)) for a in ATTRS}
        if j % 7 != 3:          # some entities carry no label
            props["plan"] = float(rng.integers(0, 3))
        if j % 11 == 5:         # some lack an attribute
            del props["attr1"]
        merged[f"u{j}"] = props
    return merged


@pytest.mark.parametrize("worker,world", [(0, 2), (1, 2), (2, 3)])
def test_examples_from_map_matches_reference(worker, world):
    merged = _entity_map()
    got = train_feed._examples_from_map(merged, ATTRS, "plan", worker, world)
    want = ref_feed._examples_from_map(merged, ATTRS, "plan", worker, world)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3]
    assert got[0].shape == (len(got[1]), len(ATTRS)) and len(got[0]) > 0


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


def _write_partitions(store_env: dict, parts: list) -> int:
    """App "lin" and one ``.p<i>`` shard per list of events; its id."""
    store = Storage(store_env)
    app_id = store.get_meta_data_apps().insert(App(0, "lin"))
    events_dir = store.get_l_events().events_dir
    store.close()
    for part, evs in enumerate(parts):
        os.environ["PIO_EVENT_PARTITION"] = str(part)
        try:
            log = JSONLEvents(events_dir)
        finally:
            del os.environ["PIO_EVENT_PARTITION"]
        log.insert_batch(evs, app_id)
    return app_id


def _labeled_events(n=90, seed=6, scale=1.0):
    """Two partitions of ``$set`` events: an entity's events in one
    partition (a partial $set, then the full one for some), labels 3
    classes, a few entities without a label; the attributes are Poisson
    counts times ``scale``."""
    rng = np.random.default_rng(seed)
    centers = rng.random((3, 3)) * 3 + 0.5
    parts = [[], []]
    for j in range(n):
        y = int(rng.integers(0, 3))
        x = [v * scale if scale != 1.0 else v
             for v in rng.poisson(centers[y]).tolist()]
        props = dict(zip(ATTRS, x))
        if j % 13 != 4:
            props["plan"] = float(y)
        evs = parts[int(rng.integers(0, 2))]
        if j % 5 == 0:
            evs.append(Event(event="$set", entity_type="user",
                             entity_id=f"u{j}",
                             properties=DataMap({"attr0": 99})))
        evs.append(Event(event="$set", entity_type="user", entity_id=f"u{j}",
                         properties=DataMap(props)))
    return parts


def _gang_in_process(monkeypatch, mod, world: int, fn):
    """fn(worker) for every worker of a gang of ``world`` in this process,
    ``mod._allgather_payload`` answering each all-gather with every
    worker's payload (JSON round-tripped, as the wire does). The payloads
    are collected in rounds until each call's are the gang's."""
    known: dict = {}
    for _round in range(3):
        docs: dict = {}
        results = []
        for w in range(world):
            monkeypatch.setenv("PIO_NUM_PROCESSES", str(world))
            monkeypatch.setenv("PIO_PROCESS_ID", str(w))
            calls = iter(range(100))

            def gather(doc, w=w, calls=calls):
                k = next(calls)
                doc = json.loads(json.dumps(doc))
                docs.setdefault(k, [None] * world)[w] = doc
                return known.get(k, [doc])

            monkeypatch.setattr(mod, "_allgather_payload", gather)
            results.append(fn(w))
        known = docs
    return results


@pytest.mark.parametrize("world", [2, 3])
def test_partition_examples_union_is_the_merged_read(tmp_path, monkeypatch,
                                                     world):
    from incubator_predictionio_tpu.data.storage import Storage as RefStorage

    env = _store_env(tmp_path)
    _write_partitions(env, _labeled_events())
    port, refs = Storage(env), RefStorage(env)
    try:
        got = _gang_in_process(
            monkeypatch, train_feed, world, lambda w: train_feed.
            partition_examples("lin", "user", ATTRS, "plan", storage=port,
                               report={}))
        want = _gang_in_process(
            monkeypatch, ref_feed, world, lambda w: ref_feed.
            partition_examples("lin", "user", ATTRS, "plan", storage=refs))
        props = PEventStore.aggregate_properties(
            "lin", "user", required=ATTRS + ["plan"], storage=port)
    finally:
        port.close()
        refs.close()
    for g, r in zip(got, want):
        for a, b in zip(g[:3], r[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert g[3] == r[3]
    # the union, interleaved back into the sorted entity order, is the
    # merged read's
    ids = sorted(props)
    n = len(ids)
    assert all(g[3] == n for g in got) and n > 60
    label_values = got[0][2]
    assert all(np.array_equal(g[2], label_values) for g in got)
    x = np.zeros((n, len(ATTRS)), np.float32)
    y = np.zeros(n, np.int64)
    for w, (feats, labels, _lv, _n) in enumerate(got):
        x[w::world], y[w::world] = feats, labels
    assert np.array_equal(x, np.asarray(
        [[float(props[e][a]) for a in ATTRS] for e in ids], np.float32))
    assert np.array_equal(label_values[y],
                          np.asarray([props[e]["plan"] for e in ids]))


# -- gloo gangs ---------------------------------------------------------------


@pytest.mark.parametrize("world,split", [(2, "skewed"), (3, "skewed"),
                                         (2, "empty")])
def test_process_local_trainers_in_a_gloo_gang(tmp_path, world, split):
    out = str(tmp_path / "m")
    runs = W.run_linear(world, out, split)
    for rank, (rc, _o, e) in enumerate(runs):
        assert rc == 0, f"rank {rank}: {e[-3000:]}"
    reports = [json.loads(o.strip().splitlines()[-1]) for _rc, o, _e in runs]
    models = [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]
    # every rank holds the same models after the same number of sums
    for m in models[1:]:
        assert all(np.array_equal(m[k], models[0][k]) for k in m)
    lr = [r["lr"] for r in reports]
    assert len({(s["iterations"], s["loss_evals"], s["collectives"])
                for s in lr}) == 1, lr
    # every f, the first g, one g per iteration, the last f
    assert lr[0]["collectives"] == lr[0]["loss_evals"] + \
        lr[0]["iterations"] + 2
    assert [s["local_rows"] for s in lr] == [
        hi - lo for lo, hi in W.LINEAR_SPLITS[split][world]]
    assert all(s["n_global"] == W.LINEAR[0] for s in lr)
    assert all(r["nb"]["allreduce_calls"] == 1 for r in reports)
    x, y, (doc_ptr, feat, cnt, y_doc) = W.linear_data()
    c = W.LINEAR[2]
    m = models[0]
    nb = ref.train_naive_bayes(x, y, c, pipeline=SERIAL)
    for key, want in (("nb_log_prior", nb.log_prior),
                      ("nb_log_likelihood", nb.log_likelihood),
                      ("nb_feat", nb.feat_counts),
                      ("nb_counts", nb.class_counts)):
        assert np.array_equal(m[key], np.asarray(want)), key
    coo = ref.train_naive_bayes_coo(doc_ptr, feat, cnt, y_doc,
                                    W.LINEAR_COO[2], W.LINEAR_COO[1],
                                    pipeline=SERIAL)
    assert np.array_equal(m["coo_log_prior"], coo.log_prior)
    assert np.array_equal(m["coo_log_likelihood"], coo.log_likelihood)
    _hold_lr(x * np.float32(0.1), y, c, W.LINEAR_REG, m["lr_weights"],
             m["lr_intercept"], lr[0]["iterations"])


# -- pio train --num-workers 2 ------------------------------------------------


def _cli_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(_store_env(tmp_path),
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               PIO_FS_BASEDIR=str(tmp_path / "store"),
               PIO_WORKER_HEARTBEAT_MS="100", PIO_SUPERVISOR_POLL_MS="25",
               PIO_WORKER_INIT_GRACE_MS="40000")
    return env


def _engine(tmp_path, factory: str, algo: str, params: dict, **extra):
    ds = {"appName": "lin", **extra.pop("datasource", {})}
    with open(tmp_path / "engine.json", "w", encoding="utf-8") as fh:
        json.dump({"id": "default", "engineFactory": MODELS + factory,
                   "datasource": {"params": ds}, **extra,
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


def _same_persisted(got: dict, want: dict, names) -> None:
    for name in names:
        assert np.array_equal(np.asarray(got[name]), np.asarray(want[name])), \
            name


def test_classification_gang_on_the_partition_feed(tmp_path):
    """Naive Bayes: each rank replays its own partition, the statistics
    summed over the gang; the persisted model is one process's, bit for
    bit."""
    env = _cli_env(tmp_path)
    app_id = _write_partitions(_store_env(tmp_path), _labeled_events(n=120))
    _engine(tmp_path, "classification.ClassificationEngine", "naive",
            {"lambda": 1.0}, datasource={"attributes": ATTRS})
    gang = _train(env, tmp_path, "--num-workers", "2")
    single = _train(env, tmp_path)
    workers = [w["timings"] for w in gang["workers"]]
    assert [t["rank"] for t in workers] == [0, 1]
    assert sum(t["local_rows"] for t in workers) == workers[0]["n_global"]
    assert all(t["allreduce_calls"] == 1 for t in workers)
    shards = [p for t in workers for p in t["shards"]]
    assert sorted(shards) == sorted(jsonl_shard_paths(
        str(tmp_path / "store" / "events" / "pio_eventdata"), app_id))
    _same_persisted(_persisted(env, gang["engineInstanceId"]),
                    _persisted(env, single["engineInstanceId"]),
                    ("log_prior", "log_likelihood", "feat_counts",
                     "class_counts", "label_values"))


def test_classification_lr_gang_on_the_merged_view(tmp_path):
    """LR with ``--feed merged``: every rank reads the merged view and
    trains its contiguous row block, the gradient summed at every step;
    held by the LR rule to the JAX trainer on the merged read."""
    from incubator_predictionio_torch.models.classification import (
        ClassificationDataSource, DataSourceParams,
    )
    from incubator_predictionio_torch.workflow.context import WorkflowContext

    env = _cli_env(tmp_path)
    # counts scaled by 0.1: the fit stops before 100 iterations
    _write_partitions(_store_env(tmp_path),
                      _labeled_events(n=150, seed=8, scale=0.1))
    _engine(tmp_path, "classification.ClassificationEngine", "lr",
            {"regParam": 0.1, "maxIterations": 100},
            datasource={"attributes": ATTRS})
    gang = _train(env, tmp_path, "--num-workers", "2", "--feed", "merged")
    workers = [w["timings"] for w in gang["workers"]]
    assert len({(t["iterations"], t["collectives"]) for t in workers}) == 1
    stored = _persisted(env, gang["engineInstanceId"])
    store = Storage(_store_env(tmp_path))
    try:
        td = ClassificationDataSource(DataSourceParams(
            app_name="lin", attributes=tuple(ATTRS))).read_training(
            WorkflowContext(device="cpu", storage=store))
    finally:
        store.close()
    assert [t["local_rows"] for t in workers] == [
        -(-len(td.labels) // 2), len(td.labels) // 2]
    assert np.array_equal(stored["label_values"], td.label_values)
    _hold_lr(td.features, td.labels, len(td.label_values), 0.1,
             stored["weights"], stored["intercept"],
             workers[0]["iterations"])


def test_text_classification_gang_equals_one_process(tmp_path):
    """Every rank reads the merged corpus and fits the same vectorizer,
    scatters its block of documents, and the [C·D] sums are all-reduced:
    the single-process model bit for bit."""
    env = _cli_env(tmp_path)
    rng = np.random.default_rng(12)
    parts = [[], []]
    for j in range(160):
        label = int(rng.integers(0, 4))
        words = " ".join(f"w{(int(v) + 7 * label) % 90}"
                         for v in rng.integers(0, 90, 20))
        parts[j % 2].append(Event(
            event="documents", entity_type="content", entity_id=f"d{j}",
            properties=DataMap({"text": words, "label": f"c{label}"})))
    _write_partitions(_store_env(tmp_path), parts)
    _engine(tmp_path, "text_classification.TextClassificationEngine", "nb",
            {"lambda": 1.0},
            preparator={"params": {"numFeatures": 256, "nGram": 1}})
    gang = _train(env, tmp_path, "--num-workers", "2")
    single = _train(env, tmp_path)
    workers = [w["timings"] for w in gang["workers"]]
    assert [t["local_rows"] for t in workers] == [80, 80]
    assert all(t["allreduce_bytes"] == 4 * 256 * 4 for t in workers)
    _same_persisted(_persisted(env, gang["engineInstanceId"]),
                    _persisted(env, single["engineInstanceId"]),
                    ("log_prior", "log_likelihood", "vectorizer_idf",
                     "label_values"))


def _cco_parts(seed=9):
    """Two ``.p<i>`` partitions of buy and view events, a user's events
    split over both, one basket window apart per user."""
    import datetime as dt

    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    parts = [[], []]
    for u in range(120):
        for j, (name, i) in enumerate(
                [("buy", rng.integers(0, 30)) for _ in range(3)]
                + [("view", rng.integers(0, 30)) for _ in range(4)]):
            parts[int(rng.integers(0, 2))].append(Event(
                event=name, entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                event_time=t0 + dt.timedelta(hours=3 * u, minutes=j)))
    return parts


@pytest.mark.parametrize("factory", [
    "universal_recommender.UniversalRecommenderEngine",
    "complementary_purchase.ComplementaryPurchaseEngine"])
def test_cco_gangs_are_refused_before_anything_spawns(tmp_path, factory):
    """The CCO templates train in a gang (tests/test_torch_cco_gang.py).
    What is still refused before anything spawns is the partition feed
    under a 2-D ``PIO_MESH_SHAPE``; without one, a gang on the partition
    feed reads the merged view (the data sources have no partition
    branch, as the reference's) and persists one process's model bit for
    bit."""
    env = _cli_env(tmp_path)
    _write_partitions(_store_env(tmp_path), _cco_parts())
    algo = "ur" if factory.startswith("universal") else "cooccurrence"
    params = ({"appName": "lin", "maxCorrelatorsPerItem": 6}
              if algo == "ur" else {"maxCorrelatorsPerItem": 6})
    _engine(tmp_path, factory, algo, params,
            datasource={"eventNames": ["buy", "view"]} if algo == "ur"
            else {})
    out = subprocess.run(
        CONSOLE + ["train", "--num-workers", "2", "--feed", "partition",
                   "--device", "cpu"], env=dict(env, PIO_MESH_SHAPE="1x2"),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
    assert out.returncode == 1, out.stderr
    assert "the 2-D layout" in out.stderr
    assert not os.path.isdir(tmp_path / "store" / "gang")
    gang = _train(env, tmp_path, "--num-workers", "2", "--feed", "partition")
    single = _train(env, tmp_path)
    got = _persisted(env, gang["engineInstanceId"])
    want = _persisted(env, single["engineInstanceId"])
    names = ("idx", "score") if algo == "cooccurrence" else tuple(
        k for k in want if k.startswith("indicators"))
    assert names
    _same_persisted(got, want, names)
    assert [w["timings"]["world"] for w in gang["workers"]] == [2, 2]
