"""The port's train/deploy workflow over the stores
(``incubator_predictionio_torch/workflow/core_workflow.py``, the resume
discovery of ``workflow/checkpoint.py`` and the ``pio`` verbs of
``tools/commands``) on the CPU, held against the JAX package's.

- ``run_train`` of both packages over one SQLite store: factors within
  2e-4 (the well-conditioned λ·n_ratings setting) and identical id maps;
  each package deploys only its own instances.
- The engine-instance row: RUNNING while training, COMPLETED with a
  verified model, ABORTED on a failure (the error surfaces) and on
  ``--stop-after-read`` / ``--stop-after-prepare`` (no model).
- ``--resume`` finds the interrupted instance, reuses its id and checkpoint
  directory and ends bit-identical to an uninterrupted train; changed
  parameters or data discard the stale snapshots.
- ``load_deployment`` picks the newest COMPLETED instance, walks back past
  a corrupt or unloadable blob, and raises for an explicit corrupt id.
- The verbs ``app new`` → ``import`` → ``train`` → ``deploy`` in
  subprocesses with ``--device cpu``, and the other verbs in process.
"""

import http.client
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.models import recommendation as ref_rec  # noqa: E402
from incubator_predictionio_tpu.workflow import core_workflow as ref_core  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_tpu.workflow.workflow_params import (  # noqa: E402
    WorkflowParams as RefWorkflowParams,
)
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data.storage import (  # noqa: E402
    Event, Model, Storage,
)
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.models import similar_product  # noqa: E402
from incubator_predictionio_torch.tools import console  # noqa: E402
from incubator_predictionio_torch.workflow import checkpoint, core_workflow  # noqa: E402
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.persist import models_from_bytes  # noqa: E402
from incubator_predictionio_torch.workflow.workflow_params import WorkflowParams  # noqa: E402

TOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
PORT_FACTORY = ("incubator_predictionio_torch.models.recommendation."
                "RecommendationEngine")
REF_FACTORY = ("incubator_predictionio_tpu.models.recommendation."
               "RecommendationEngine")
ALGO = {"rank": 4, "numIterations": 5, "lambda": 0.05,
        "lambdaScaling": "nratings", "seed": 7}


def _engine_json(factory=PORT_FACTORY, app="wfapp", **algo):
    return {"id": "default", "engineFactory": factory,
            "datasource": {"params": {"appName": app}},
            "algorithms": [{"name": "als", "params": {**ALGO, **algo}}]}


def _wire_events(n_users=25, n_items=15, seed=0):
    rng = np.random.default_rng(seed)
    evs = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < 0.4:
                evs.append({
                    "event": "rate", "entityType": "user", "entityId": f"u{u}",
                    "targetEntityType": "item", "targetEntityId": f"i{i}",
                    "properties": {"rating": float(rng.integers(1, 11)) / 2},
                    "eventTime": f"2024-01-01T00:0{int(rng.integers(10))}"
                                 f":00.000Z"})
    evs.append({"event": "buy", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i14",
                "eventTime": "2024-01-01T00:05:00.000Z"})
    return evs


def _env(tmp_path):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "pio.sqlite")}


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """A SQLite store with the app "wfapp" and its events, written by the
    JAX package; checkpoints under this test's PIO_FS_BASEDIR."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    ref = ref_storage.Storage(_env(tmp_path))
    app_id = ref.get_meta_data_apps().insert(ref_storage.App(0, "wfapp"))
    ref.get_l_events().insert_batch(
        [ref_storage.Event.from_json(e) for e in _wire_events()], app_id)
    ref.close()
    s = Storage(_env(tmp_path))
    yield s
    s.close()


def _port_train(storage, wp=None, engine_json=None, app="wfapp"):
    ej = engine_json or _engine_json()
    engine = port_rec.RecommendationEngine()()
    ctx = WorkflowContext(app_name=app, storage=storage, device="cpu")
    iid = core_workflow.run_train(engine, EngineParams.from_json(ej), ctx,
                                  wp, engine_factory_name=ej["engineFactory"])
    return iid, ctx


def _port_deploy(storage, instance_id=None, **kw):
    engine = port_rec.RecommendationEngine()()
    return core_workflow.load_deployment(
        engine, instance_id, WorkflowContext(storage=storage, device="cpu"),
        engine_factory_name=PORT_FACTORY, **kw)


def _factors(deployment):
    m = deployment.models[0]
    return m.factors.user_factors, m.factors.item_factors, m.users, m.items


def test_run_train_matches_the_reference_over_one_store(store, tmp_path):
    iid, _ = _port_train(store)
    ref = ref_storage.Storage(_env(tmp_path))
    ref_ej = _engine_json(REF_FACTORY)
    ref_iid = ref_core.run_train(
        ref_rec.RecommendationEngine()(), RefEngineParams.from_json(ref_ej),
        RefContext(app_name="wfapp", storage=ref),
        RefWorkflowParams(device="cpu"), engine_factory_name=REF_FACTORY)
    deployment, instance, _ = _port_deploy(store)
    assert instance.id == iid  # the reference's newer row is not the port's
    ref_dep, ref_instance, _ = ref_core.load_deployment(
        ref_rec.RecommendationEngine()(), None, RefContext(storage=ref),
        engine_factory_name=REF_FACTORY)
    assert ref_instance.id == ref_iid
    uf, itf, users, items = _factors(deployment)
    ref_model = ref_dep.models[0]
    np.testing.assert_allclose(uf, ref_model.factors.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(itf, ref_model.factors.item_factors,
                               rtol=TOL, atol=TOL)
    assert list(users.to_dict().items()) == list(ref_model.users.to_dict().items())
    assert list(items.to_dict().items()) == list(ref_model.items.to_dict().items())
    row = store.get_meta_data_engine_instances().get(iid)
    assert (row.status, row.engine_id, row.env["appName"]) == \
        ("COMPLETED", PORT_FACTORY, "wfapp")
    assert json.loads(row.algorithms_params) == [{"name": "als", "params": ALGO}]
    assert model_artifact.describe(
        store.get_model_data_models().get(iid).models)["ok"]
    ref.close()


def test_instance_row_lifecycle(store, monkeypatch):
    seen = []
    real_train = port_rec.ALSAlgorithm.train

    def spying_train(self, ctx, pd):
        seen.append(store.get_meta_data_engine_instances()
                    .get(ctx.engine_instance_id).status)
        return real_train(self, ctx, pd)

    monkeypatch.setattr(port_rec.ALSAlgorithm, "train", spying_train)
    iid, _ = _port_train(store)
    row = store.get_meta_data_engine_instances().get(iid)
    assert seen == ["RUNNING"] and row.status == "COMPLETED"
    assert row.end_time is not None and row.end_time >= row.start_time
    engine_json, stored = models_from_bytes(
        model_artifact.read_model(store, iid))
    assert engine_json["engineFactory"] == PORT_FACTORY
    assert set(stored[0]) == {"user_factors", "item_factors", "users", "items"}

    for flag in ("stop_after_read", "stop_after_prepare"):
        iid, _ = _port_train(store, WorkflowParams(**{flag: True}))
        assert store.get_meta_data_engine_instances().get(iid).status == "ABORTED"
        assert not store.get_model_data_models().exists(iid)

    def failing_train(self, ctx, pd):
        raise RuntimeError("injected training failure")

    monkeypatch.setattr(port_rec.ALSAlgorithm, "train", failing_train)
    before = {i.id for i in store.get_meta_data_engine_instances().get_all()}
    with pytest.raises(RuntimeError, match="injected training failure"):
        _port_train(store)
    (new,) = [i for i in store.get_meta_data_engine_instances().get_all()
              if i.id not in before]
    assert new.status == "ABORTED" and not store.get_model_data_models().exists(new.id)


def test_unknown_app_aborts_with_the_error(store):
    with pytest.raises(ValueError, match="does not exist"):
        _port_train(store, engine_json=_engine_json(app="ghost"), app="ghost")
    assert {i.status for i in
            store.get_meta_data_engine_instances().get_all()} == {"ABORTED"}


class _Crash(RuntimeError):
    pass


def _crash_after_step_2(monkeypatch):
    real = checkpoint.CheckpointHook.save

    def crashing_save(self, step, tree):
        real(self, step, tree)
        if step == 2:
            raise _Crash("injected crash after the step-2 snapshot")

    monkeypatch.setattr(checkpoint.CheckpointHook, "save", crashing_save)
    return real


def test_resume_reuses_the_interrupted_instance(store, monkeypatch):
    whole_iid, _ = _port_train(store)
    whole = models_from_bytes(model_artifact.read_model(store, whole_iid))[1][0]
    real = _crash_after_step_2(monkeypatch)
    with pytest.raises(_Crash):
        _port_train(store, WorkflowParams(checkpoint_every=1))
    (crashed,) = [i for i in store.get_meta_data_engine_instances().get_all()
                  if i.status == "ABORTED"]
    snapshots = Path(checkpoint.instance_checkpoint_dir(crashed.id))
    assert sorted(os.listdir(snapshots / "algo_0_als")) == ["1.npz", "2.npz"]
    assert checkpoint.find_resumable_instance(
        store, PORT_FACTORY, data_source_params=crashed.data_source_params,
        preparator_params=crashed.preparator_params).id == crashed.id
    monkeypatch.setattr(checkpoint.CheckpointHook, "save", real)

    iid, ctx = _port_train(store, WorkflowParams(resume=True))
    assert iid == crashed.id == ctx.engine_instance_id
    row = store.get_meta_data_engine_instances().get(iid)
    assert row.status == "COMPLETED" and row.start_time == crashed.start_time
    assert not snapshots.exists()
    resumed = models_from_bytes(model_artifact.read_model(store, iid))[1][0]
    for k in ("user_factors", "item_factors"):
        np.testing.assert_array_equal(resumed[k], whole[k])
    # nothing left to resume: a fresh instance
    iid2, _ = _port_train(store, WorkflowParams(resume=True))
    assert iid2 not in (iid, whole_iid)


def test_resume_with_changed_params_or_data_starts_over(store, monkeypatch,
                                                        tmp_path):
    real = _crash_after_step_2(monkeypatch)
    with pytest.raises(_Crash):
        _port_train(store, WorkflowParams(checkpoint_every=1))
    (crashed,) = store.get_meta_data_engine_instances().get_all()
    monkeypatch.setattr(checkpoint.CheckpointHook, "save", real)
    # other hyperparameters: the snapshots are dropped, a new instance trains
    iid, _ = _port_train(store, WorkflowParams(resume=True),
                         engine_json=_engine_json(rank=3))
    assert iid != crashed.id
    assert not Path(checkpoint.instance_checkpoint_dir(crashed.id)).exists()
    assert store.get_meta_data_engine_instances().get(iid).status == "COMPLETED"

    # other data under the same parameters: the snapshot's fingerprint is
    # refused, the stale snapshots are discarded and the instance retrains
    _crash_after_step_2(monkeypatch)
    with pytest.raises(_Crash):
        _port_train(store, WorkflowParams(checkpoint_every=1))
    monkeypatch.setattr(checkpoint.CheckpointHook, "save", real)
    crashed = max((i for i in store.get_meta_data_engine_instances().get_all()
                   if i.status == "ABORTED"), key=lambda i: i.start_time)
    store.get_l_events().insert(Event.from_json(
        {"event": "rate", "entityType": "user", "entityId": "late",
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": 5}}), 1)
    iid, _ = _port_train(store, WorkflowParams(resume=True))
    assert iid == crashed.id
    assert store.get_meta_data_engine_instances().get(iid).status == "COMPLETED"
    assert not Path(checkpoint.instance_checkpoint_dir(iid)).exists()
    users = models_from_bytes(model_artifact.read_model(store, iid))[1][0]["users"]
    assert "late" in users


def test_load_deployment_walks_back(store):
    first, _ = _port_train(store)
    time.sleep(0.01)
    second, _ = _port_train(store)
    assert _port_deploy(store)[1].id == second
    models = store.get_model_data_models()
    good = models.get(second).models
    blob = bytearray(good)
    blob[len(blob) // 2] ^= 0x01
    models.insert(Model(second, bytes(blob)))
    rejected = []
    deployment, instance, _ = _port_deploy(
        store, on_reject=lambda i, k: rejected.append((i, k)))
    assert instance.id == first and rejected == [(second, "checksum")]
    assert deployment.query({"user": "u1", "num": 3})["itemScores"]
    assert models.get(second).models == bytes(blob)  # kept for forensics
    with pytest.raises(model_artifact.ModelIntegrityError, match="checksum"):
        _port_deploy(store, second)
    # verified but not loadable (a pickle is never loaded): walked back too
    models.insert(Model(second, model_artifact.wrap(pickle.dumps({"x": 1}))))
    rejected.clear()
    _, instance, _ = _port_deploy(
        store, on_reject=lambda i, k: rejected.append((i, k)))
    assert instance.id == first and rejected == [(second, "deserialize")]
    assert _port_deploy(store, exclude_ids=[second])[1].id == first
    models.delete(first)
    models.delete(second)
    with pytest.raises(RuntimeError, match="No deployable"):
        _port_deploy(store)
    with pytest.raises(RuntimeError, match="not found"):
        _port_deploy(store, "nope")


def test_no_completed_instance_is_a_clear_error(store):
    with pytest.raises(RuntimeError, match="No COMPLETED engine instance"):
        _port_deploy(store)


def test_similar_product_reads_the_store(store):
    """The Similar-Product template from the store: views + categories."""
    app_id = store.get_meta_data_apps().get_by_name("wfapp").id
    le = store.get_l_events()
    rng = np.random.default_rng(1)
    le.insert_batch([Event.from_json({
        "event": "view", "entityType": "user", "entityId": f"v{int(rng.integers(20))}",
        "targetEntityType": "item", "targetEntityId": f"i{int(rng.integers(10))}",
        "eventTime": "2024-01-01T00:00:00.000Z"}) for _ in range(200)], app_id)
    le.insert_batch([Event.from_json({
        "event": "$set", "entityType": "item", "entityId": f"i{j}",
        "properties": {"categories": [f"c{j % 2}"]}}) for j in range(10)], app_id)
    engine = similar_product.SimilarProductEngine()()
    ej = {"datasource": {"params": {"appName": "wfapp"}},
          "algorithms": [{"name": "als", "params": {"rank": 4,
                                                    "numIterations": 2}}]}
    model = engine.train(WorkflowContext(storage=store, device="cpu"),
                         EngineParams.from_json(ej))[0]
    assert model.item_categories["i3"] == {"c1"}
    assert len(model.items) == 10
    assert all(x[0] in {"i1", "i3", "i5", "i7", "i9"} for x in
               model.similar(["i2"], 4, categories=["c1"]))


# -- the verbs -----------------------------------------------------------------


@pytest.fixture()
def basedir(tmp_path, monkeypatch):
    """An empty default store at $PIO_FS_BASEDIR/pio.sqlite, as the verbs
    find it in a fresh process."""
    base = tmp_path / "base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    Storage.reset_instance()
    yield base
    Storage.reset_instance()


def _verb(args, capsys):
    rc = console.main(args)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_app_and_accesskey_verbs(basedir, capsys, tmp_path):
    rc, out, _ = _verb(["app", "new", "myapp", "--description", "d"], capsys)
    assert rc == 0 and "Access Key:" in out
    key = out.split("Access Key:")[1].split()[0]
    assert _verb(["app", "new", "myapp"], capsys)[0] == 1  # duplicate
    rc, out, _ = _verb(["app", "list"], capsys)
    assert "myapp" in out and key in out
    assert _verb(["app", "channel-new", "myapp", "side"], capsys)[0] == 0
    assert _verb(["app", "channel-new", "myapp", "bad name"], capsys)[0] == 1
    rc, out, _ = _verb(["accesskey", "new", "myapp", "--events", "view"],
                       capsys)
    limited = out.split("Access Key:")[1].split()[0]
    rc, out, _ = _verb(["app", "show", "myapp"], capsys)
    assert "side" in out and f"{limited} | view" in out
    rc, out, _ = _verb(["accesskey", "list", "myapp"], capsys)
    assert key in out and limited in out
    assert _verb(["accesskey", "delete", limited], capsys)[0] == 0
    assert limited not in _verb(["accesskey", "list"], capsys)[1]

    events = tmp_path / "ev.jsonl"
    events.write_text("\n".join(json.dumps(e) for e in _wire_events()[:30])
                      + "\n{broken\n\n")
    rc, out, err = _verb(["import", "--app-name", "myapp", "--input",
                          str(events)], capsys)
    assert rc == 0 and "Imported 30 events (1 skipped)" in out
    assert "record 31" in err
    assert _verb(["import", "--app-name", "myapp", "--channel", "side",
                  "--input", str(events)], capsys)[0] == 0
    exported = tmp_path / "out.jsonl"
    assert _verb(["export", "--app-name", "myapp", "--output",
                  str(exported)], capsys)[0] == 0
    back = [json.loads(x) for x in exported.read_text().splitlines()]
    assert len(back) == 30
    assert sorted((e["entityId"], e["targetEntityId"]) for e in back) == \
        sorted((e["entityId"], e["targetEntityId"])
               for e in _wire_events()[:30])
    with pytest.raises(SystemExit, match="does not exist"):
        console.main(["import", "--app-name", "ghost", "--input", str(events)])
    capsys.readouterr()

    rc, out, _ = _verb(["status"], capsys)
    assert rc == 0 and "METADATA: SQLITE" in out and "Solve kernels:" in out
    assert (basedir / "pio.sqlite").is_file()
    assert _verb(["app", "data-delete", "myapp"], capsys)[0] == 1  # needs -f
    assert _verb(["app", "data-delete", "myapp", "-f"], capsys)[0] == 0
    s = Storage.instance()
    app = s.get_meta_data_apps().get_by_name("myapp")
    assert list(s.get_l_events().find(app.id)) == []
    assert _verb(["app", "channel-delete", "myapp", "side"], capsys)[0] == 0
    assert _verb(["app", "delete", "myapp", "-f"], capsys)[0] == 0
    assert s.get_meta_data_apps().get_by_name("myapp") is None
    assert _verb(["nosuchverb"], capsys)[0] == 1
    assert _verb(["help"], capsys)[1].count("\n") > 8


def test_build_verb(tmp_path, capsys):
    (tmp_path / "engine.json").write_text(json.dumps(_engine_json()))
    rc, out, _ = _verb(["build", "--engine-dir", str(tmp_path)], capsys)
    assert rc == 0 and PORT_FACTORY in out
    (tmp_path / "engine.json").write_text(json.dumps(_engine_json(REF_FACTORY)))
    rc, _, err = _verb(["build", "--engine-dir", str(tmp_path)], capsys)
    assert rc == 1 and "not a factory of this package" in err


def _run(args, env, cwd):
    return subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
        + args, capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_app_import_train_deploy_in_subprocesses(tmp_path):
    """The user's path, each verb its own process, on the CPU: the store
    is the default $PIO_FS_BASEDIR/pio.sqlite, training without
    ``--device cpu`` raises here (no card), and the deployed answers are
    the trained model's."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(tmp_path / "base"))
    out = _run(["app", "new", "cliapp"], env, tmp_path)
    assert out.returncode == 0, out.stderr
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(json.dumps(e) for e in _wire_events()) + "\n")
    out = _run(["import", "--app-name", "cliapp", "--input", str(events)],
               env, tmp_path)
    assert out.returncode == 0 and f"Imported {len(_wire_events())} events" \
        in out.stdout, out.stderr
    (tmp_path / "engine.json").write_text(json.dumps(_engine_json(app="cliapp")))
    out = _run(["train"], env, tmp_path)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" \
        in out.stderr
    out = _run(["train", "--device", "cpu"], env, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    trained = json.loads(out.stdout.strip().splitlines()[-1])
    assert trained["device"] == "cpu"
    assert trained["timings"]["ratings_read"] == len(_wire_events())
    iid = trained["engineInstanceId"]

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "deploy", "--device", "cpu", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp_path)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/")
                info = json.loads(conn.getresponse().read())
                break
            except OSError:
                assert time.time() < deadline
                time.sleep(0.2)
        assert info["engineInstanceId"] == iid
        assert info["lifecycle"]["integrityFailures"] == {}
        conn.request("POST", "/queries.json",
                     body=json.dumps({"user": "u1", "num": 3}))
        answer = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0
    s = Storage({"PIO_FS_BASEDIR": str(tmp_path / "base")} | _default_env(tmp_path))
    deployment, instance, _ = _port_deploy(s)
    assert instance.id == iid
    assert answer == json.loads(json.dumps(
        deployment.query({"user": "u1", "num": 3})))
    s.close()


def _default_env(tmp_path):
    """The verbs' default store, named explicitly."""
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "base" / "pio.sqlite")}
