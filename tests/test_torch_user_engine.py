"""User engines in the port: an ``engineFactory`` resolved from
``--engine-dir`` (``workflow/json_extractor.py``), and the port's copy of
the vanilla scaffold (``incubator_predictionio_torch/templates/vanilla``).

- A user engine's module in the engine directory trains and deploys (the
  directory goes first on ``sys.path``); the factory must build an Engine
  of the port, and a factory of the JAX package is refused with a clear
  error.
- The vanilla copy, placed in ``tmp_path`` with its engine.json, goes
  through ``train --engine-dir``, ``deploy --engine-dir`` and ``eval
  --engine-dir ... vanilla_engine.VanillaEvaluation
  vanilla_engine.ParamsList``, each verb its own process, ``--device cpu``.
- Its popularity scores equal the reference vanilla engine's
  (``templates/vanilla/vanilla_engine.py``) on the same events, exactly
  (every weight is a multiple of 0.5, so the sums are exact in float32
  whatever their order).
"""

import datetime as dt
import http.client
import importlib.util
import json
import os
import shutil
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
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow, json_extractor  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_VANILLA = ROOT / "incubator_predictionio_torch" / "templates" / "vanilla"
REF_VANILLA = ROOT / "templates" / "vanilla"
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)

#: a user engine of its own module: the port's Recommendation components
#: bound by the user's factory function
_MY_ENGINE = '''
from incubator_predictionio_torch.controller import Engine
from incubator_predictionio_torch.models.recommendation import (
    ALSAlgorithm, RecommendationDataSource)


def my_engine():
    return Engine(data_source_class=RecommendationDataSource,
                  algorithm_class_map={"als": ALSAlgorithm})


def not_an_engine():
    return object()
'''


def _events(n_users=12, n_items=9, seed=0):
    """view, rate (ratings in halves) and buy events, distinct times."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(n_users):
        for i in range(n_items):
            x = rng.random()
            if x < 0.35:
                e = {"event": "view"}
            elif x < 0.6:
                e = {"event": "rate",
                     "properties": {"rating": float(rng.integers(1, 11)) / 2}}
            elif x < 0.7:
                e = {"event": "buy"}
            else:
                continue
            e.update(entityType="user", entityId=f"u{u}",
                     targetEntityType="item", targetEntityId=f"i{i}",
                     eventTime=(T0 + dt.timedelta(seconds=len(out)))
                     .isoformat().replace("+00:00", "Z"))
            out.append(e)
    return out


def _default_env(base):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(base / "pio.sqlite")}


@pytest.fixture()
def store(tmp_path):
    """The verbs' default store ($PIO_FS_BASEDIR/pio.sqlite) holding the
    app "userapp" and its events, written by the JAX package."""
    base = tmp_path / "base"
    base.mkdir()
    ref = ref_storage.Storage(_default_env(base))
    app_id = ref.get_meta_data_apps().insert(ref_storage.App(0, "userapp"))
    ref.get_l_events().insert_batch(
        [ref_storage.Event.from_json(e) for e in _events()], app_id)
    ref.close()
    return base


def test_user_engine_from_the_engine_directory_trains_and_deploys(
        tmp_path, store, monkeypatch):
    engine_dir = tmp_path / "myproject"
    engine_dir.mkdir()
    (engine_dir / "my_user_engine.py").write_text(_MY_ENGINE)
    monkeypatch.setattr(sys, "path", list(sys.path))
    engine_json = {"engineFactory": "my_user_engine.my_engine",
                   "datasource": {"params": {"appName": "userapp"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 4, "numIterations": 3, "lambda": 0.1}}]}
    engine, params, factory = json_extractor.engine_and_params_from_json(
        engine_json, str(engine_dir))
    assert sys.path[0] == str(engine_dir) and factory == "my_user_engine.my_engine"
    storage = port_storage.Storage(_default_env(store))
    try:
        iid = core_workflow.run_train(
            engine, params, WorkflowContext(app_name="userapp",
                                            storage=storage, device="cpu"),
            engine_factory_name=factory)
        deployment, instance, _ = core_workflow.load_deployment(
            engine, None, WorkflowContext(storage=storage, device="cpu"),
            engine_factory_name=factory)
        assert instance.id == iid
        assert len(deployment.query({"user": "u1", "num": 3})["itemScores"]) == 3
    finally:
        storage.close()
    with pytest.raises(TypeError, match="did not produce an Engine of "
                                        "incubator_predictionio_torch"):
        json_extractor.engine_and_params_from_json(
            {"engineFactory": "my_user_engine.not_an_engine"}, str(engine_dir))


@pytest.mark.parametrize("dotted", [
    "incubator_predictionio_tpu.models.recommendation.RecommendationEngine",
    "incubator_predictionio_tpu.models.recommendation_eval.ParamsList",
])
def test_a_factory_of_the_jax_package_is_refused(dotted):
    with pytest.raises(ValueError, match="names the JAX package"):
        json_extractor.resolve_engine_factory(dotted)
    with pytest.raises(ValueError, match="not a factory of this package"):
        json_extractor.engine_and_params_from_json({"engineFactory": dotted})


def _load(path: Path, name: str):
    """A template module under a name of its own (both packages' vanilla
    modules are called vanilla_engine)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("weight", [0.5, 1.0, 2.0])
def test_vanilla_popularity_equals_the_reference_exactly(store, weight):
    port_ve = _load(PORT_VANILLA / "vanilla_engine.py", "port_vanilla_engine")
    ref_ve = _load(REF_VANILLA / "vanilla_engine.py", "ref_vanilla_engine")
    obj = {"datasource": {"params": {"appName": "userapp"}},
           "algorithms": [{"name": "popularity",
                           "params": {"ratingWeight": weight}}]}
    storage = port_storage.Storage(_default_env(store))
    ref = ref_storage.Storage(_default_env(store))
    try:
        model = port_ve.VanillaEngine()().train(
            WorkflowContext(app_name="userapp", storage=storage, device="cpu"),
            EngineParams.from_json(obj))[0]
        rmodel = ref_ve.VanillaEngine()().train(
            RefContext(app_name="userapp", storage=ref),
            RefEngineParams.from_json(obj))[0]
    finally:
        storage.close()
        ref.close()
    assert model.item_ids == rmodel.item_ids
    assert model.scores.dtype == np.float32
    assert np.array_equal(model.scores, np.asarray(rmodel.scores))
    assert model.top(5) == rmodel.top(5)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(args, env, cwd):
    return subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
        + args, capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_vanilla_copy_trains_deploys_and_evaluates_through_the_verbs(
        tmp_path, store):
    project = tmp_path / "vanilla"
    project.mkdir()
    shutil.copy(PORT_VANILLA / "vanilla_engine.py", project)
    engine_json = json.loads((PORT_VANILLA / "engine.json").read_text())
    assert engine_json["engineFactory"] == "vanilla_engine.VanillaEngine"
    engine_json["datasource"]["params"]["appName"] = "userapp"
    (project / "engine.json").write_text(json.dumps(engine_json))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(store))

    out = _run(["train", "--device", "cpu", "--engine-dir", str(project)],
               env, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    trained = json.loads(out.stdout.strip().splitlines()[-1])
    assert trained["kernel_launches"] == {"warp": 0, "wide": 0}

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "deploy", "--device", "cpu", "--engine-dir", str(project), "--port",
         str(port)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=env, cwd=tmp_path)
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
        assert info["engineInstanceId"] == trained["engineInstanceId"]
        conn.request("POST", "/queries.json", body=json.dumps({"num": 4}))
        answer = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    ve = _load(project / "vanilla_engine.py", "copied_vanilla_engine")
    storage = port_storage.Storage(_default_env(store))
    try:
        model = ve.VanillaEngine()().train(
            WorkflowContext(app_name="userapp", storage=storage, device="cpu"),
            EngineParams.from_json(engine_json))[0]
    finally:
        storage.close()
    assert answer == {"itemScores": [{"item": i, "score": s}
                                     for i, s in model.top(4)]}

    out = _run(["eval", "vanilla_engine.VanillaEvaluation",
                "vanilla_engine.ParamsList", "--engine-dir", str(project),
                "--app-name", "userapp", "--device", "cpu"], env, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[MetricEvaluator] candidates ranked by NDCG@10" in out.stdout
    evaluated = json.loads(out.stdout.strip().splitlines()[-1])
    assert evaluated["candidates"] == 3 and evaluated["device"] == "cpu"
    assert evaluated["metricHeader"] == "NDCG@10"
    assert all(0.0 < s <= 1.0 for s in evaluated["scores"])
    assert evaluated["ranking_metrics"]["calls"] > 0
    s = port_storage.Storage(_default_env(store))
    try:
        row = s.get_meta_data_evaluation_instances().get(
            evaluated["evaluationInstanceId"])
        assert row.status == "EVALCOMPLETED"
        assert row.evaluation_class == "vanilla_engine.VanillaEvaluation"
    finally:
        s.close()
