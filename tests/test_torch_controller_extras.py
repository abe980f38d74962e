"""The rest of the port's controller API on the CPU against the JAX
reference's: ``controller/persistent_model.py`` (wired into ``run_train``
and ``load_deployment``), ``controller/self_cleaning.py`` with ``app
data-delete --clean``, ``workflow/fake_workflow.py`` and ``e2/engine.py``.

- A LocalFileSystemPersistentModel saves itself where the reference's does,
  with the same arrays; the model blob holds only the marker naming its
  class; a deploy loads it back; a marker naming the JAX package is refused
  before any import.
- Self-cleaning (TTL age-out, dedupe of re-imported events, the
  ``$set``/``$unset``/``$delete`` compaction) leaves the same events as the
  reference's pass on memory, SQLite and JSONL stores, and returns the
  same count; the verb runs it.
- The fake workflow trains, persists and deploys through the port's
  ``run_train``; the e2 helpers give the reference's results.
"""

import datetime as dt
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from incubator_predictionio_tpu.controller import self_cleaning as ref_sc  # noqa: E402
from incubator_predictionio_tpu.controller import persistent_model as ref_pm  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.e2 import engine as ref_e2  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch import controller  # noqa: E402
from incubator_predictionio_torch.controller import (  # noqa: E402
    Algorithm, Engine, EngineParams, LocalFileSystemPersistentModel,
)
from incubator_predictionio_torch.controller import self_cleaning  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.e2 import engine as port_e2  # noqa: E402
from incubator_predictionio_torch.tools.commands import app as app_verb  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow, fake_workflow  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.persist import models_from_bytes  # noqa: E402

NOW = dt.datetime.now(dt.timezone.utc)


def _mem_env():
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEM"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"}


# -- PersistentModel ---------------------------------------------------------


class Centroids(LocalFileSystemPersistentModel):
    def __init__(self, centers, names):
        self.centers, self.names = centers, names

    def to_arrays(self):
        return {"centers": self.centers, "names": self.names}

    @classmethod
    def from_arrays(cls, arrays):
        return cls(arrays["centers"], arrays["names"])


class RefCentroids(ref_pm.LocalFileSystemPersistentModel):
    def __init__(self, centers, names):
        self.centers, self.names = centers, names

    def to_arrays(self):
        return {"centers": self.centers, "names": self.names}


class _DS(controller.DataSource):
    def read_training(self, ctx):
        return np.arange(6, dtype=np.float32).reshape(3, 2)


class _CentroidAlgo(Algorithm):
    def train(self, ctx, pd):
        return Centroids(pd.mean(axis=0, keepdims=True),
                         np.asarray(["c0"]))

    def predict(self, model, query):
        return {"name": str(model.names[0]),
                "center": model.centers[0].tolist()}


def test_a_persistent_model_saves_and_loads_itself(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    storage = port_storage.Storage(_mem_env())
    engine = Engine(_DS, algorithm_class_map={"": _CentroidAlgo})
    factory = f"{__name__}.Centroids"
    iid = core_workflow.run_train(
        engine, EngineParams(), WorkflowContext(storage=storage,
                                                device="cpu"),
        engine_factory_name="centroids")
    blob = storage.get_model_data_models().get(iid).models
    from incubator_predictionio_torch.workflow import model_artifact

    stored = models_from_bytes(model_artifact.read_model(storage, iid))[1]
    assert stored == [{"__persistent__": factory}]
    assert blob
    # the same file as the reference's LocalFileSystemPersistentModel
    path = tmp_path / "persistent_models" / iid / "Centroids.npz"
    RefCentroids(np.asarray([[2.0, 3.0]], np.float32),
                 np.asarray(["c0"])).save("ref-" + iid, None)
    ref_path = tmp_path / "persistent_models" / ("ref-" + iid) / \
        "RefCentroids.npz"
    with np.load(path) as got, np.load(ref_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in got.files:
            assert np.array_equal(got[k], want[k])
    deployment, _, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=storage, device="cpu"),
        engine_factory_name="centroids")
    assert deployment.query({}) == {"name": "c0", "center": [2.0, 3.0]}
    # a class of the JAX package is refused before anything is imported
    with pytest.raises(ValueError, match="JAX package"):
        core_workflow.load_persistent_models(
            [{"__persistent__": "incubator_predictionio_tpu.no_such.Model"}],
            iid, None)


def test_the_controller_exports_every_reference_name():
    from incubator_predictionio_tpu import controller as ref_controller

    assert set(ref_controller.__all__) <= set(controller.__all__)
    assert controller.PersistentModelLoader.load.__name__ == "load"
    with pytest.raises(NotImplementedError):
        controller.PersistentModel().save("x", None)


# -- SelfCleaningDataSource ----------------------------------------------------


def _clean_events(pkg):
    """Property streams to compact, a TTL victim, re-imported duplicates
    and near-duplicates that differ only in prId or tags."""
    E, D = pkg.Event, pkg.DataMap
    t = NOW - dt.timedelta(days=60)
    out = [
        E("$set", "item", "i1", properties=D({"a": 1}),
          event_time=NOW - dt.timedelta(days=30)),
        E("$set", "item", "i1", properties=D({"b": 2}),
          event_time=NOW - dt.timedelta(days=20)),
        E("$unset", "item", "i1", properties=D({"a": 0}),
          event_time=NOW - dt.timedelta(days=10)),
        E("$set", "item", "i2", properties=D({"c": [1, 2]}),
          event_time=NOW - dt.timedelta(days=5)),
        E("$set", "user", "u9", properties=D({"x": 1}),
          event_time=NOW - dt.timedelta(days=3)),
        E("$delete", "user", "u9", event_time=NOW - dt.timedelta(days=2)),
        E("view", "user", "u1", "item", "i1",
          event_time=NOW - dt.timedelta(days=40)),
        E("view", "user", "u1", "item", "i1",
          event_time=NOW - dt.timedelta(hours=1)),
    ]
    base = dict(event="buy", entity_type="user", entity_id="u2",
                target_entity_type="item", target_entity_id="i2",
                event_time=t)
    out += [E(**base, pr_id="A"), E(**base, pr_id="B"),
            E(**base, tags=["promo"]), E(**base, tags=["promo"]),
            E(**base), E(**base), E(**base)]
    return out


def _content(events):
    """Events without their ids, in a canonical order."""
    rows = []
    for e in events:
        d = e.to_json()
        for k in ("eventId", "creationTime"):
            d.pop(k, None)
        rows.append(json.dumps(d, sort_keys=True))
    return sorted(rows)


def _clean_stores(kind, tmp_path):
    if kind == "memory":
        return _mem_env(), _mem_env()
    envs = []
    for side in ("port", "ref"):
        d = tmp_path / side
        env = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "DB"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(d / "pio.sqlite")}
        if kind == "jsonl":
            env |= {"PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
                    "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
                    "PIO_STORAGE_SOURCES_LOG_PATH": str(d / "events")}
        d.mkdir()
        envs.append(env)
    return envs


@pytest.mark.parametrize("ttl", [None, 7])
@pytest.mark.parametrize("kind", ["memory", "sqlite", "jsonl"])
def test_self_cleaning_leaves_the_references_events(kind, ttl, tmp_path):
    port_env, ref_env = _clean_stores(kind, tmp_path)
    port = port_storage.Storage(port_env)
    ref = ref_storage.Storage(ref_env)
    for s, pkg in ((port, port_storage), (ref, ref_storage)):
        app_id = s.get_meta_data_apps().insert(pkg.App(0, "cleanapp"))
        s.get_l_events().init(app_id)
        s.get_l_events().insert_batch(_clean_events(pkg), app_id)

    ds = self_cleaning.SelfCleaningDataSource()
    rds = ref_sc.SelfCleaningDataSource()
    if ttl is not None:
        for d in (ds, rds):
            d.event_window_duration = dt.timedelta(days=ttl)
            d.event_window_remove = True
    got = ds.clean_persisted_data(
        WorkflowContext(storage=port, device="cpu"), "cleanapp")
    want = rds.clean_persisted_data(RefContext(storage=ref), "cleanapp")
    assert got == want == (12 if ttl else 7)
    pid = port.get_meta_data_apps().get_by_name("cleanapp").id
    rid = ref.get_meta_data_apps().get_by_name("cleanapp").id
    assert _content(port.get_l_events().find(pid)) == \
        _content(ref.get_l_events().find(rid))
    props = port.get_l_events().aggregate_properties(pid, "item")
    assert {k: v.to_dict() for k, v in props.items()} == {
        "i1": {"b": 2}, "i2": {"c": [1, 2]}}
    # a second pass has nothing left to clean
    assert ds.clean_persisted_data(
        WorkflowContext(storage=port, device="cpu"), "cleanapp") == 0
    with pytest.raises(ValueError, match="does not exist"):
        ds.clean_persisted_data(WorkflowContext(storage=port, device="cpu"),
                                "nope")
    port.close()
    ref.close()


def test_data_delete_clean_runs_the_pass(monkeypatch, capsys):
    storage = port_storage.Storage(_mem_env())
    app_id = storage.get_meta_data_apps().insert(port_storage.App(0, "a"))
    storage.get_l_events().init(app_id)
    storage.get_l_events().insert_batch(_clean_events(port_storage), app_id)
    monkeypatch.setattr(app_verb, "_storage", lambda: storage)
    assert app_verb.app_cmd(["data-delete", "a", "--clean",
                             "--channel", "c"]) == 1
    assert app_verb.app_cmd(["data-delete", "a", "--clean",
                             "--ttl-days", "7"]) == 1   # needs -f
    assert app_verb.app_cmd(["data-delete", "a", "--clean"]) == 0
    assert "removed 7 events" in capsys.readouterr().out
    assert app_verb.app_cmd(["data-delete", "a", "--clean", "--ttl-days",
                             "7", "-f"]) == 0
    assert "removed 5 events" in capsys.readouterr().out
    assert len(list(storage.get_l_events().find(app_id))) == 3


# -- FakeWorkflow ------------------------------------------------------------


def test_fake_workflow_trains_persists_and_deploys():
    storage = port_storage.Storage(_mem_env())
    iid = fake_workflow.fake_run(WorkflowContext(storage=storage,
                                                 device="cpu"))
    inst = storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == "COMPLETED"
    assert storage.get_model_data_models().get(iid) is not None
    deployment, _, _ = core_workflow.load_deployment(
        fake_workflow.fake_engine(), iid,
        WorkflowContext(storage=storage, device="cpu"),
        engine_factory_name="fake")
    assert deployment.query({"q": 5}) == {"echo": 5, "total": 6}
    ds = fake_workflow.FakeDataSource({"values": [4, 5]})
    (td, info, qa), = ds.read_eval(None)
    assert td.values == [4, 5] and qa == [({"q": 4}, {"a": 4}),
                                          ({"q": 5}, {"a": 5})]
    assert ds.read_count == 1


# -- e2 helpers ----------------------------------------------------------------


def test_e2_helpers_give_the_references_results():
    rng = np.random.default_rng(0)
    vals = ["a", "b", "c", "d"]
    points = [(str(rng.integers(0, 3)), [vals[j] for j in
                                         rng.integers(0, 4, 3)])
              for _ in range(60)]
    got = port_e2.CategoricalNaiveBayes.train(points)
    want = ref_e2.CategoricalNaiveBayes.train(points)
    assert got.log_priors == want.log_priors
    assert got.log_likelihoods == want.log_likelihoods
    for feats in (["a", "b", "c"], ["d", "d", "d"], ["z", "a", "b"]):
        assert got.predict(feats) == want.predict(feats)
        for lab in ("0", "1", "2", "9"):
            assert got.log_score(feats, lab) == want.log_score(feats, lab)
    with pytest.raises(ValueError):
        port_e2.CategoricalNaiveBayes.train([])

    vec = port_e2.BinaryVectorizer.fit(f for _, f in points)
    rvec = ref_e2.BinaryVectorizer.fit(f for _, f in points)
    assert vec.index == rvec.index and vec.n_features == rvec.n_features
    assert np.array_equal(vec.transform(["a", "q", "c"]),
                          rvec.transform(["a", "q", "c"]))

    counts = rng.integers(0, 5, (6, 6)).astype(np.float64)
    counts[2] = 0
    assert port_e2.markov_chain(counts, 3) == ref_e2.markov_chain(counts, 3)
