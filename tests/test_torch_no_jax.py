"""The port never imports JAX or the JAX package.

Statically: no file of ``incubator_predictionio_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib``, ``orbax`` or
``incubator_predictionio_tpu``. At run time: a fresh interpreter trains
(checkpointed and NaN-guarded), persists, deploys over HTTP and queries on
the CPU, folds events in and trains the Similar-Product template, and
neither ``jax``, ``orbax`` nor the JAX package is loaded after; and each
``pio`` verb (``app``, ``import``, ``status``, ``train --device cpu``,
``deploy --device cpu``, ``eventserver``, and on a JSONL event log
``import``, ``eventlog compact`` and ``train --window``, ``batchpredict``,
``models list``, ``deploy`` with micro-batching, the result cache and
the refresh loop armed, and on a JSONL log ``deploy --online-foldin
--quality-eval --multitenant``) runs in a fresh interpreter of its own that
loads none of them; so do the front and both replicas of ``deploy --replicas
2`` (each process reports its modules at exit through a ``sitecustomize``),
whose answers equal a single server's on the same persisted model; so do
host-sharded serving (``PIO_SERVE_SHARD_ITEMS``: the ALS catalog and the
UR's indicators) and the front and both workers of ``eventserver
--workers 2 --stats`` with the write-ahead log (and the ``wal`` and
``eventlog archive|restore`` verbs), and the supervisor and both gloo ranks of ``train
--num-workers 2`` off a partitioned JSONL log and with ``--feed merged``
(the slab gang), and of the linear templates' gangs (Classification's
Naive Bayes off the partition feed, Text-Classification's LR on the
merged corpus).
The same holds for the E-Commerce template and the evaluations (the
``eval`` and ``dashboard`` verbs, and the vanilla copy's evaluation from
its engine directory), and for the Classification and Text-Classification
templates (Naive Bayes and L-BFGS LR, the codec's tokenizer) with the
fake workflow, self-cleaning and a self-persisted model, and for the
Universal Recommender and Complementary Purchase templates (train → persist
→ serve, with the codec's CCO layout), for ``pio storageserver``, and for a
``train`` whose metadata and events are read over a storage server (HTTP)
and whose model lands in PostgreSQL (``tests/pg_mock.py``), and for a
``train`` over Elasticsearch (metadata and events) into S3 and a
``deploy`` that restores that model from S3 (the stand-ins
``tests/torch_es_server.py`` and ``tests/torch_s3_server.py``, which the
static check covers with the other stand-ins ``chip_smoke.py`` loads). (This pytest process has JAX loaded by
tests/conftest.py, so the run-time check needs its own process.)
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "orbax", "optax", "incubator_predictionio_tpu")


#: the stand-in servers ``chip_smoke.py`` loads on the card host
STAND_INS = ("torch_s3_server.py", "torch_es_server.py",
             "torch_hbase_server.py", "torch_hbase_rpc_server.py",
             "torch_hdfs_server.py")


def _port_files():
    files = sorted((ROOT / "incubator_predictionio_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + [ROOT / "tests" / name
                                               for name in STAND_INS]


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            yield node.args[0].value


def test_port_files_exist():
    names = {p.name for p in _port_files()}
    assert {"spd_solve.py", "als.py", "recommendation.py", "chip_smoke.py",
            "nan_guard.py", "checkpoint.py", "workflow_params.py",
            "similar_product.py", "_filters.py", "datamap.py", "event.py",
            "base.py", "memory.py", "sqlite.py", "localfs.py", "registry.py",
            "p_event_store.py", "l_event_store.py", "model_artifact.py",
            "json_extractor.py", "core_workflow.py", "app.py", "engine.py",
            "management.py", "event_server.py", "console.py",
            "envknobs.py", "faultinject.py", "train_window.py", "jsonl.py",
            "event_log.py", "log_tail.py", "ecommerce.py", "template_evals.py",
            "recommendation_eval.py", "evaluation_workflow.py",
            "dashboard.py", "metric.py", "metric_evaluator.py",
            "evaluation.py", "cross_validation.py", "eval.py",
            "vanilla_engine.py", "linear.py", "tfidf.py",
            "classification.py", "text_classification.py",
            "persistent_model.py", "self_cleaning.py", "fake_workflow.py",
            "llr.py", "universal_recommender.py", "complementary_purchase.py",
            "deadline.py", "resilience.py", "plugins.py", "create_server.py",
            "models.py", "online.py", "quality.py", "multitenant.py",
            "holdout.py", "splice.py", "supervisor.py", "fleet.py",
            "elastic.py", "sharded_topk.py", "_sharded_serving.py",
            "distributed.py", "mesh.py", "partition_feed.py",
            "train_feed.py", "input_pipeline.py", "telemetry.py",
            "stats.py", "ingest_wal.py", "ingest_buffer.py", "segmentio.py",
            "mailchimp.py", "ssl_config.py", "storage_server.py",
            "http_backend.py", "pgwire.py", "postgres.py", "mysqlwire.py",
            "mysql.py", "s3.py", "hdfs.py", "elasticsearch.py", "hbase.py",
            "hbase_rpc.py", *STAND_INS,
            } <= names
    assert (ROOT / "incubator_predictionio_torch" / "e2"
            / "engine.py").is_file()
    assert (ROOT / "incubator_predictionio_torch" / "native"
            / "__init__.py").is_file()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_SCRIPT = r"""
import http.client, json, sys
import numpy as np
from incubator_predictionio_torch.controller import EngineParams
from incubator_predictionio_torch.models import similar_product
from incubator_predictionio_torch.tools import console
from incubator_predictionio_torch.workflow.context import WorkflowContext
from incubator_predictionio_torch.workflow.create_server import EngineServer
from incubator_predictionio_torch.workflow.workflow_params import WorkflowParams

rng = np.random.default_rng(0)
events = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
           "targetEntityType": "item", "targetEntityId": f"i{i}",
           "properties": {"rating": float(rng.integers(1, 6))},
           "eventTime": "2024-01-01T00:00:00.000Z"}
          for u in range(12) for i in range(9) if rng.random() < 0.5]
engine_json = {"algorithms": [{"name": "als", "params": {
    "rank": 4, "numIterations": 3, "lambda": 0.1}}]}
path = sys.argv[1]
console.train(engine_json, events, path, device="cpu",
              workflow_params=WorkflowParams(checkpoint_every=1,
                                             nan_guard=True))
deployment, _ = console.load_deployment(path, device="cpu")
server = EngineServer(deployment=deployment, device="cpu")
_, port = server.start()
conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
conn.request("POST", "/queries.json", body=json.dumps({"user": "u1", "num": 3}))
resp = conn.getresponse()
body = json.loads(resp.read())
conn.close()
server.stop()
assert resp.status == 200 and len(body["itemScores"]) == 3, body
folded = deployment.algo_list[0][1].fold_in(
    deployment.models[0], [{"event": "rate", "entityId": "new",
                            "targetEntityId": "i1",
                            "properties": {"rating": 4.0}}])
assert len(folded.recommend_products("new", 3)) == 3
views = [{"event": "view", "entityType": "user", "entityId": f"u{u}",
          "targetEntityType": "item", "targetEntityId": f"i{i}"}
         for u in range(12) for i in range(9) if rng.random() < 0.5]
views += [{"event": "$set", "entityType": "item", "entityId": "i1",
           "properties": {"categories": ["c"]}}]
sp = similar_product.SimilarProductEngine()()
model = sp.train(WorkflowContext(events=views, device="cpu"),
                 EngineParams.from_json({"algorithms": [{"name": "als",
                     "params": {"rank": 4, "numIterations": 2}}]}))[0]
assert model.similar(["i2"], 3, categories=["c"])[0][0] == "i1"
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "orbax", "incubator_predictionio_tpu"))
print(json.dumps({"loaded": loaded}))
"""


def test_train_and_serve_in_a_process_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path / "model.npz")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


_EVAL_SCRIPT = r"""
import json, sys
from incubator_predictionio_torch.controller import EngineParams
from incubator_predictionio_torch.data.storage import App, Event, Storage
from incubator_predictionio_torch.models import ecommerce, template_evals
from incubator_predictionio_torch.workflow import core_workflow
from incubator_predictionio_torch.workflow.context import WorkflowContext
from incubator_predictionio_torch.workflow.evaluation_workflow import run_evaluation
from incubator_predictionio_torch.workflow.json_extractor import resolve_engine_factory

base, vanilla_dir = sys.argv[1], sys.argv[2]
storage = Storage({"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
                   "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
                   "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S",
                   "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
                   "PIO_STORAGE_SOURCES_S_PATH": base + "/pio.sqlite"})
app_id = storage.get_meta_data_apps().insert(App(0, "ec"))
storage.get_l_events().insert_batch(
    [Event.from_json({"event": ["view", "buy"][(u + k) % 5 == 0],
                      "entityType": "user", "entityId": f"u{u}",
                      "targetEntityType": "item",
                      "targetEntityId": f"i{(u * 3 + k) % 11}"})
     for u in range(16) for k in range(5)]
    + [Event.from_json({"event": "$set", "entityType": "constraint",
                        "entityId": "unavailableItems",
                        "properties": {"items": ["i1"]}})], app_id)
factory = "incubator_predictionio_torch.models.ecommerce.ECommerceEngine"
engine = ecommerce.ECommerceEngine()()
iid = core_workflow.run_train(
    engine, EngineParams.from_json({"algorithms": [{"name": "ecomm",
        "params": {"rank": 4, "numIterations": 2}}]}),
    WorkflowContext(app_name="ec", storage=storage, device="cpu"),
    engine_factory_name=factory)
deployment, _, _ = core_workflow.load_deployment(
    engine, iid, WorkflowContext(storage=storage, device="cpu"),
    engine_factory_name=factory)
answer = [e["item"] for e in deployment.query({"user": "u2", "num": 4})["itemScores"]]
assert len(answer) == 4 and "i1" not in answer, answer
gen = template_evals.ECommerceParamsList("ec")
gen.engine_params_list = gen.engine_params_list[:1]
ctx = WorkflowContext(app_name="ec", storage=storage, device="cpu")
result, _ = run_evaluation(template_evals.ECommerceEvaluation(device="cpu"),
                           gen, ctx)
assert result.metric_header == "NDCG@10"
evaluation = resolve_engine_factory("vanilla_engine.VanillaEvaluation",
                                    vanilla_dir)(device="cpu")
result, _ = run_evaluation(evaluation, resolve_engine_factory(
    "vanilla_engine.ParamsList", vanilla_dir)("ec"), ctx)
assert len(result.all_results) == 3
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "orbax", "incubator_predictionio_tpu"))
print(json.dumps({"loaded": loaded}))
"""


def test_ecommerce_and_eval_in_a_process_without_jax(tmp_path):
    """E-Commerce train → deploy → query with an unavailable item, its
    evaluation, and the vanilla copy's evaluation from its engine
    directory."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    vanilla = ROOT / "incubator_predictionio_torch" / "templates" / "vanilla"
    out = subprocess.run(
        [sys.executable, "-c", _EVAL_SCRIPT, str(tmp_path), str(vanilla)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


_CLS_SCRIPT = r"""
import json, sys
import numpy as np
from incubator_predictionio_torch import controller
from incubator_predictionio_torch.controller import EngineParams
from incubator_predictionio_torch.controller.self_cleaning import SelfCleaningDataSource
from incubator_predictionio_torch.data.storage import App, Event, Storage
from incubator_predictionio_torch.models import classification, text_classification
from incubator_predictionio_torch.workflow import core_workflow, fake_workflow
from incubator_predictionio_torch.workflow.context import WorkflowContext

storage = Storage({"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
                   "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
                   "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
                   "PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
app_id = storage.get_meta_data_apps().insert(App(0, "c"))
rng = np.random.default_rng(0)
wire = [{"event": "$set", "entityType": "user", "entityId": f"u{n}",
         "properties": {"attr0": int(a), "attr1": int(b), "attr2": 1,
                        "plan": int(a >= 2)}}
        for n, (a, b) in enumerate(rng.integers(0, 4, (60, 2)))]
wire += [{"event": "documents", "entityType": "content", "entityId": f"d{j}",
          "properties": {"text": ["fast motor ride", "code cpu screen"][j % 2]
                         + f" w{j % 7}", "label": ["moto", "comp"][j % 2]}}
         for j in range(30)]
storage.get_l_events().insert_batch([Event.from_json(e) for e in wire], app_id)
ctx = WorkflowContext(app_name="c", storage=storage, device="cpu")
answers = []
for factory, algos, query in (
        ("classification.ClassificationEngine", ("naive", "lr"),
         {"attr0": 3, "attr1": 0, "attr2": 1}),
        ("text_classification.TextClassificationEngine", ("nb", "lr"),
         {"text": "a fast motor"})):
    dotted = "incubator_predictionio_torch.models." + factory
    module, cls = factory.split(".")
    engine = getattr({"classification": classification,
                      "text_classification": text_classification}[module], cls)()()
    for algo in algos:
        params = EngineParams.from_json({"algorithms": [{"name": algo, "params": {}}]})
        iid = core_workflow.run_train(engine, params, ctx,
                                      engine_factory_name=dotted + algo)
        dep, _, _ = core_workflow.load_deployment(
            engine, iid, WorkflowContext(storage=storage, device="cpu"),
            engine_factory_name=dotted + algo)
        answers.append(dep.query(query))
assert [a.get("label", a.get("category")) for a in answers] == \
    [1.0, 1.0, "moto", "moto"], answers
assert fake_workflow.fake_run(WorkflowContext(storage=storage, device="cpu"))
assert SelfCleaningDataSource().clean_persisted_data(ctx, "c") == 0
assert "PersistentModel" in controller.__all__
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "orbax", "optax", "incubator_predictionio_tpu"))
print(json.dumps({"loaded": loaded}))
"""


def test_classification_templates_in_a_process_without_jax(tmp_path):
    """Both new templates train (NB and LR) and deploy, with the fake
    workflow and the self-cleaning pass, and neither JAX, optax nor the
    JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CLS_SCRIPT],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


_CCO_SCRIPT = r"""
import json, sys
import numpy as np
from incubator_predictionio_torch.controller import EngineParams
from incubator_predictionio_torch.data.storage import App, Event, Storage
from incubator_predictionio_torch.models import (
    complementary_purchase, universal_recommender)
from incubator_predictionio_torch.workflow import core_workflow
from incubator_predictionio_torch.workflow.context import WorkflowContext

storage = Storage({"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
                   "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
                   "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
                   "PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
app_id = storage.get_meta_data_apps().insert(App(0, "shop"))
rng = np.random.default_rng(0)
wire = []
for u in range(30):
    group = ("a", "b", "c") if u % 2 else ("x", "y")
    for k, item in enumerate(group + (f"n{rng.integers(0, 9)}",)):
        wire.append({"event": "buy", "entityType": "user",
                     "entityId": f"u{u}", "targetEntityType": "item",
                     "targetEntityId": item,
                     "eventTime": f"2024-01-{1 + u % 28:02d}T10:{k:02d}:00Z"})
        wire.append({"event": "view", "entityType": "user",
                     "entityId": f"u{u}", "targetEntityType": "item",
                     "targetEntityId": group[(k + 1) % len(group)],
                     "eventTime": f"2024-01-{1 + u % 28:02d}T11:{k:02d}:00Z"})
wire.append({"event": "$set", "entityType": "item", "entityId": "b",
             "properties": {"categories": ["cat"]}})
storage.get_l_events().insert_batch([Event.from_json(e) for e in wire], app_id)
ctx = WorkflowContext(app_name="shop", storage=storage, device="cpu")
answers = []
for module, cls, algo, query in (
        (universal_recommender, "UniversalRecommenderEngine",
         {"name": "ur", "params": {"appName": "shop"}},
         {"item": "a", "num": 2}),
        (complementary_purchase, "ComplementaryPurchaseEngine",
         {"name": "cooccurrence", "params": {}}, {"items": ["a"], "num": 2})):
    engine = getattr(module, cls)()()
    params = EngineParams.from_json({
        "datasource": {"params": {"appName": "shop"}}, "algorithms": [algo]})
    iid = core_workflow.run_train(engine, params, ctx,
                                  engine_factory_name=cls)
    dep, _, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=storage, device="cpu"),
        engine_factory_name=cls)
    answers.append(sorted(e["item"] for e in dep.query(query)["itemScores"]))
assert answers == [["b", "c"], ["b", "c"]], answers
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "orbax", "optax", "incubator_predictionio_tpu"))
print(json.dumps({"loaded": loaded}))
"""


def test_cco_templates_in_a_process_without_jax(tmp_path):
    """The Universal Recommender and the Complementary Purchase template
    train (the codec's dedupe and layout, the CCO counts and LLR
    indicators), persist, deploy and answer, and neither JAX nor the JAX
    package is loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CCO_SCRIPT],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


#: runs one verb through the console; ``PROBE_PORT`` set: a thread waits for
#: the verb's server to answer ``GET /`` and stops it with SIGTERM. The
#: modules loaded are printed at exit.
_VERB = r"""
import atexit, http.client, json, os, signal, sys, threading, time
from incubator_predictionio_torch.tools import console

def report():
    print(json.dumps({"loaded": sorted(
        m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "orbax", "incubator_predictionio_tpu"))}),
        flush=True)

atexit.register(report)
port = os.environ.get("PROBE_PORT")
if port:
    def probe():
        for _ in range(600):
            try:
                c = http.client.HTTPConnection("127.0.0.1", int(port), timeout=5)
                c.request("GET", "/")
                c.getresponse().read()
                break
            except OSError:
                time.sleep(0.1)
        os.kill(os.getpid(), signal.SIGTERM)
    threading.Thread(target=probe, daemon=True).start()
sys.exit(console.main(sys.argv[1:]))
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def verb_store(tmp_path_factory):
    """A default store ($PIO_FS_BASEDIR/pio.sqlite) holding the app "nojax"
    with its events and one COMPLETED instance, an events file and an
    engine.json: every verb below runs on its own against it."""
    import json

    from incubator_predictionio_torch.controller import EngineParams
    from incubator_predictionio_torch.data.storage import App, Event, Storage
    from incubator_predictionio_torch.models.recommendation import (
        RecommendationEngine,
    )
    from incubator_predictionio_torch.workflow.context import WorkflowContext
    from incubator_predictionio_torch.workflow.core_workflow import run_train

    base = tmp_path_factory.mktemp("verbs")
    wire = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item", "targetEntityId": f"i{(u * 7 + k) % 9}",
             "properties": {"rating": float(1 + (u + k) % 5)}}
            for u in range(12) for k in range(4)]
    (base / "events.jsonl").write_text(
        "\n".join(json.dumps(e) for e in wire) + "\n")
    engine_json = {
        "engineFactory": "incubator_predictionio_torch.models."
                         "recommendation.RecommendationEngine",
        "datasource": {"params": {"appName": "nojax"}},
        "algorithms": [{"name": "als", "params": {"rank": 4,
                                                  "numIterations": 2}}]}
    (base / "engine.json").write_text(json.dumps(engine_json))
    (base / "queries.jsonl").write_text(
        "".join(json.dumps({"user": f"u{u}", "num": 3}) + "\n"
                for u in range(5)))
    storage = Storage({
        f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
        for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(base / "base" / "pio.sqlite")})
    app_id = storage.get_meta_data_apps().insert(App(0, "nojax"))
    storage.get_l_events().insert_batch([Event.from_json(e) for e in wire],
                                        app_id)
    run_train(RecommendationEngine()(), EngineParams.from_json(engine_json),
              WorkflowContext(app_name="nojax", storage=storage, device="cpu"),
              engine_factory_name=engine_json["engineFactory"])
    storage.close()
    return base


@pytest.mark.parametrize("verb", [
    ["app", "new", "another"],
    ["import", "--app-name", "nojax", "--input", "events.jsonl"],
    ["status"],
    ["train", "--device", "cpu"],
    ["deploy", "--device", "cpu", "--port", "{port}"],
    ["eventserver", "--ip", "127.0.0.1", "--port", "{port}"],
    ["eval", "--device", "cpu", "--app-name", "nojax",
     "incubator_predictionio_torch.models.recommendation_eval."
     "RecommendationEvaluation",
     "incubator_predictionio_torch.models.recommendation_eval.ParamsList"],
    ["dashboard", "--ip", "127.0.0.1", "--port", "{port}"],
    ["batchpredict", "--device", "cpu", "--input", "queries.jsonl",
     "--output", "predictions.jsonl"],
    ["models", "list"],
    ["storageserver", "--port", "{port}"],
], ids=lambda v: v[0])
def test_verb_in_a_process_without_jax(verb, verb_store):
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(verb_store / "base"))
    if "{port}" in verb:
        env["PROBE_PORT"] = port
    out = subprocess.run(
        [sys.executable, "-c", _VERB] + [a.replace("{port}", port) for a in verb],
        capture_output=True, text=True, env=env, cwd=str(verb_store),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


def test_armed_deploy_in_a_process_without_jax(verb_store):
    """``deploy --device cpu`` with micro-batching, the result cache and
    the refresh loop armed serves, drains on SIGTERM and exits 0 without
    loading JAX or the JAX package."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(verb_store / "base"),
               PROBE_PORT=port)
    out = subprocess.run(
        [sys.executable, "-c", _VERB, "deploy", "--device", "cpu",
         "--port", port, "--batch-window-ms", "2", "--max-batch", "8",
         "--query-cache-size", "100", "--model-refresh-ms", "200"],
        capture_output=True, text=True, env=env, cwd=str(verb_store),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


@pytest.fixture(scope="module")
def jsonl_verb_store(tmp_path_factory, verb_store):
    """The same app and events file, with the events on a JSONL log
    ($PIO_FS_BASEDIR/events) and the metadata and models on SQLite."""
    import json

    from incubator_predictionio_torch.data.storage import App, Event, Storage

    base = tmp_path_factory.mktemp("jsonl_verbs")
    for name in ("events.jsonl", "engine.json"):
        (base / name).write_text((verb_store / name).read_text())
    env = _jsonl_env(base)
    storage = Storage(env)
    app_id = storage.get_meta_data_apps().insert(App(0, "nojax"))
    wire = [json.loads(line) for line in
            (base / "events.jsonl").read_text().splitlines()]
    storage.get_l_events().insert_batch(
        [Event.from_json(e) for e in wire], app_id)
    storage.close()
    return base


def _jsonl_env(base):
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(base / "base" / "pio.sqlite"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(base / "base" / "events")}


@pytest.mark.parametrize("verb", [
    ["import", "--app-name", "nojax", "--input", "events.jsonl"],
    ["eventlog", "compact"],
    ["train", "--device", "cpu", "--window", "36500d"],
], ids=lambda v: v[0])
def test_jsonl_verb_in_a_process_without_jax(verb, jsonl_verb_store):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(_jsonl_env(jsonl_verb_store), PYTHONPATH=str(ROOT),
               PIO_FS_BASEDIR=str(jsonl_verb_store / "base"))
    out = subprocess.run([sys.executable, "-c", _VERB] + verb,
                         capture_output=True, text=True, env=env,
                         cwd=str(jsonl_verb_store), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


@pytest.mark.parametrize("verb", [
    ["eventlog", "compact"],
    ["eventlog", "archive", "--log", "events_1.jsonl", "--generation", "1"],
    ["eventlog", "restore", "--log", "events_1.jsonl", "--generation", "1"],
    ["wal", "inspect"],
    ["wal", "replay"],
], ids=lambda v: "-".join(v[:2]))
def test_wal_and_archive_verbs_in_a_process_without_jax(verb, tmp_path,
                                                        jsonl_verb_store):
    """``eventlog archive|restore`` (to a localfs cold source) and ``wal
    inspect|replay`` (over a WAL holding one uncommitted event) load no
    JAX."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_WAL", "PIO_EVENT"))}
    env.update(_jsonl_env(jsonl_verb_store), PYTHONPATH=str(ROOT),
               PIO_FS_BASEDIR=str(jsonl_verb_store / "base"),
               PIO_STORAGE_SOURCES_COLD_TYPE="LOCALFS",
               PIO_STORAGE_SOURCES_COLD_PATH=str(jsonl_verb_store / "cold"),
               PIO_EVENT_ARCHIVE_SOURCE="COLD", PIO_WAL="1",
               PIO_WAL_DIR=str(tmp_path / "wal"))
    if verb[0] == "wal":
        from incubator_predictionio_torch.data.api import ingest_wal

        wal = ingest_wal.IngestWal(ingest_wal.WalConfig(
            enabled=True, dir=str(tmp_path / "wal")))
        wal.append_events((1, None), (
            '{"eventId": "%032x", "event": "view", "entityType": "user", '
            '"entityId": "w", "eventTime": "2024-01-01T00:00:00.000Z"}\n'
            % 7).encode(), 1)
        wal.close()
    out = subprocess.run([sys.executable, "-c", _VERB] + verb,
                         capture_output=True, text=True, env=env,
                         cwd=str(jsonl_verb_store), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert {"archive": "tier archived", "restore": "tier hot",
            "inspect": "1 uncommitted event(s)",
            "replay": "1 event(s) replayed"}.get(verb[1], "") in out.stdout
    last = out.stdout.strip().splitlines()[-1]
    assert '"loaded": []' in last, last


def test_online_deploy_in_a_process_without_jax(jsonl_verb_store):
    """``deploy --device cpu --online-foldin --quality-eval --multitenant``
    on the JSONL store arms the fold-in, quality and tenant loops (their
    modules imported), serves, drains on SIGTERM and exits 0 without
    loading JAX or the JAX package."""
    import json

    from incubator_predictionio_torch.controller import EngineParams
    from incubator_predictionio_torch.data.storage import Storage
    from incubator_predictionio_torch.models.recommendation import (
        RecommendationEngine,
    )
    from incubator_predictionio_torch.workflow.context import WorkflowContext
    from incubator_predictionio_torch.workflow.core_workflow import run_train

    engine_json = json.loads((jsonl_verb_store / "engine.json").read_text())
    storage = Storage(_jsonl_env(jsonl_verb_store))
    run_train(RecommendationEngine()(), EngineParams.from_json(engine_json),
              WorkflowContext(app_name="nojax", storage=storage, device="cpu"),
              engine_factory_name=engine_json["engineFactory"])
    storage.close()
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(_jsonl_env(jsonl_verb_store), PYTHONPATH=str(ROOT),
               PIO_FS_BASEDIR=str(jsonl_verb_store / "base"), PROBE_PORT=port,
               PIO_FOLDIN_MS="100", PIO_QUALITY_MS="100")
    script = _VERB.replace("atexit.register(report)", """atexit.register(report)
def armed():
    print(json.dumps({"armed": sorted(
        m for m in sys.modules if m.endswith(
            ("workflow.online", "workflow.quality", "workflow.multitenant",
             "api.holdout")))}), flush=True)
atexit.register(armed)""")
    out = subprocess.run(
        [sys.executable, "-c", script, "deploy", "--device", "cpu",
         "--port", port, "--online-foldin", "--quality-eval",
         "--multitenant"],
        capture_output=True, text=True, env=env, cwd=str(jsonl_verb_store),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert '"loaded": []' in lines[-1], lines[-1]
    assert json.loads(lines[-2])["armed"] == [
        "incubator_predictionio_torch.data.api.holdout",
        "incubator_predictionio_torch.workflow.multitenant",
        "incubator_predictionio_torch.workflow.online",
        "incubator_predictionio_torch.workflow.quality"], lines[-2]


_SITECUSTOMIZE = r"""
import atexit, json, os, sys

def _report():
    out = os.environ.get("PIO_TEST_MODULES_DIR")
    if not out:
        return
    with open(os.path.join(out, f"{os.getpid()}.json"), "w") as fh:
        json.dump({"argv": sys.argv,
                   "replica": os.environ.get("PIO_FLEET_REPLICA"),
                   "loaded": sorted(m for m in sys.modules
                                    if m.split(".")[0] in (
                                        "jax", "jaxlib", "orbax",
                                        "incubator_predictionio_tpu"))}, fh)

atexit.register(_report)
"""


def test_fleet_deploy_in_processes_without_jax(verb_store, tmp_path):
    """``deploy --device cpu --replicas 2``: the front and both replicas
    load no JAX; every answer through the front is index-identical to an
    in-process single server's on the same persisted model; SIGTERM to the
    front drains every replica (each writes its kernel-launch record) and
    exits 0."""
    import http.client
    import json
    import shutil
    import signal
    import time

    from incubator_predictionio_torch.data.storage import Storage
    from incubator_predictionio_torch.models.recommendation import (
        RecommendationEngine,
    )
    from incubator_predictionio_torch.workflow.create_server import EngineServer

    store = tmp_path / "store"
    shutil.copytree(verb_store, store)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    reports = tmp_path / "modules"
    reports.mkdir()
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_FLEET", "PIO_FAULT"))}
    env.update(PYTHONPATH=os.pathsep.join([str(site), str(ROOT)]),
               PIO_FS_BASEDIR=str(store / "base"),
               PIO_TEST_MODULES_DIR=str(reports), PIO_FLEET_SYNC_MS="200",
               PIO_FLEET_READY_MS="150")
    front = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "deploy", "--device", "cpu", "--replicas", "2", "--ip",
         "127.0.0.1", "--port", str(port)],
        env=env, cwd=str(store), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("POST", "/queries.json", body=json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        deadline = time.monotonic() + 180
        health = {}
        while time.monotonic() < deadline:
            assert front.poll() is None, front.stdout.read()[-3000:]
            try:
                health = get("/healthz")[1]
                if health.get("readyReplicas") == 2:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert health.get("readyReplicas") == 2, health
        fleet_answers = {}
        for u in range(12):
            status, body = post({"user": f"u{u}", "num": 3})
            assert status == 200, body
            fleet_answers[f"u{u}"] = body
        served_by = set()
        for _ in range(4):   # fresh connections round-robin the replicas
            served_by.add(get("/status")[1]["fleet"]["replica"])
        assert served_by == {0, 1}
    finally:
        if front.poll() is None:
            front.send_signal(signal.SIGTERM)
        try:
            rc = front.wait(timeout=90)
        except subprocess.TimeoutExpired:
            front.kill()
            raise
    out = front.stdout.read()
    assert rc == 0, out[-3000:]
    storage = Storage({
        f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
        for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(store / "base" / "pio.sqlite")})
    engine_json = json.loads((store / "engine.json").read_text())
    single = EngineServer(RecommendationEngine()(),
                          engine_factory_name=engine_json["engineFactory"],
                          storage=storage, device="cpu")
    for user, body in fleet_answers.items():
        want = single.deployment.query({"user": user, "num": 3})
        assert [x["item"] for x in body["itemScores"]] == \
            [x["item"] for x in want["itemScores"]], user
    single.close()
    storage.close()
    docs = [json.loads(p.read_text()) for p in reports.glob("*.json")]
    fronts = [d for d in docs if "--replicas" in d["argv"]]
    replicas = sorted(d["replica"] for d in docs if d["replica"] is not None)
    assert len(fronts) == 1 and replicas == ["0", "1"], docs
    assert all(d["loaded"] == [] for d in docs), docs
    logs = list((store / "base" / "gang").rglob("worker_*.log"))
    assert len(logs) == 2
    for log in logs:
        assert '"kernel_launches": {"warp": 0, "wide": 0}' in \
            log.read_text(), log.read_text()[-2000:]


_SHARDED_SCRIPT = r"""
import json, os, sys
import numpy as np
os.environ["PIO_SERVE_SHARD_ITEMS"] = "3"
from incubator_predictionio_torch.models import _sharded_serving
from incubator_predictionio_torch.ops import llr
from incubator_predictionio_torch.tools import console

rng = np.random.default_rng(0)
events = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
           "targetEntityType": "item", "targetEntityId": f"i{i}",
           "properties": {"rating": float(rng.integers(1, 6))},
           "eventTime": "2024-01-01T00:00:00.000Z"}
          for u in range(12) for i in range(9) if rng.random() < 0.5]
engine_json = {"algorithms": [{"name": "als", "params": {
    "rank": 4, "numIterations": 3, "lambda": 0.1,
    "shardedServing": "always"}}]}
path = sys.argv[1]
console.train(engine_json, events, path, device="cpu")
deployment, _ = console.load_deployment(path, device="cpu")
model = deployment.models[0]
assert model.catalog().layout == "host" and model.catalog().n_shards == 3
assert len(deployment.query({"user": "u1", "num": 3})["itemScores"]) == 3
inds = {"buy": llr.Indicators(idx=rng.integers(-1, 9, (9, 4)).astype(
    np.int32), score=rng.random((9, 4)).astype(np.float32))}
si = _sharded_serving.ShardedIndicators(inds, 9, "cpu")
assert si.layout == "host"
s, i = si.score_user([("buy", np.ones(9, np.float32), 1.0)], 4, None, None)
assert len(i) == 4
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "orbax", "incubator_predictionio_tpu"))
print(json.dumps({"loaded": loaded}))
"""


def test_host_sharded_serving_in_a_process_without_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _SHARDED_SCRIPT,
                          str(tmp_path / "m.npz")],
                         capture_output=True, text=True, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"loaded": []' in out.stdout.strip().splitlines()[-1]


def test_partitioned_event_server_in_processes_without_jax(tmp_path):
    """``eventserver --workers 2 --stats`` with the write-ahead log on a
    JSONL log: the front and both workers load no JAX (each reports its
    modules at exit), every worker ready on the front's /healthz, SIGTERM
    drains with exit 0."""
    import json
    import signal
    import time

    import requests

    from incubator_predictionio_torch.data.storage import (
        AccessKey, App, Storage,
    )

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    reports = tmp_path / "modules"
    reports.mkdir()
    store_env = {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "meta.sqlite"),
        "PIO_STORAGE_SOURCES_EV_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / "events")}
    storage = Storage(store_env)
    app_id = storage.get_meta_data_apps().insert(App(0, "nojax"))
    storage.get_meta_data_access_keys().insert(AccessKey("k", app_id, ()))
    storage.close()
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_EVENT", "PIO_FAULT"))}
    env.update(store_env, PYTHONPATH=os.pathsep.join([str(site), str(ROOT)]),
               PIO_FS_BASEDIR=str(tmp_path / "base"),
               PIO_TEST_MODULES_DIR=str(reports), PIO_WAL="1",
               PIO_WAL_DIR=str(tmp_path / "wal"))
    front = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "eventserver", "--workers", "2", "--stats", "--ip", "127.0.0.1",
         "--port", str(port)], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        health = {}
        while time.monotonic() < deadline and health.get(
                "readyWorkers") != 2:
            assert front.poll() is None, front.stdout.read()[-3000:]
            try:
                health = requests.get(base + "/healthz", timeout=5).json()
            except (requests.RequestException, ValueError):
                pass
            time.sleep(0.1)
        assert health.get("readyWorkers") == 2, health
        r = requests.post(f"{base}/events.json?accessKey=k", json={
            "event": "view", "entityType": "user", "entityId": "u",
            "targetEntityType": "item", "targetEntityId": "i"}, timeout=30)
        assert r.status_code == 201, r.text
    finally:
        if front.poll() is None:
            front.send_signal(signal.SIGTERM)
        try:
            rc = front.wait(timeout=90)
        except subprocess.TimeoutExpired:
            front.kill()
            raise
    assert rc == 0, front.stdout.read()[-3000:]
    docs = [json.loads(p.read_text()) for p in reports.glob("*.json")]
    assert sum("--workers" in d["argv"] for d in docs) == 1, docs
    assert sum("--worker" in d["argv"] for d in docs) == 2, docs
    assert all(d["loaded"] == [] for d in docs), docs


def test_gang_train_in_processes_without_jax(tmp_path):
    """``train --num-workers 2 --device cpu`` off a partitioned JSONL log:
    the supervisor and both gang ranks (a gloo process group) load no JAX
    (each reports its modules at exit), and the gang completes."""
    _gang_train_without_jax(tmp_path, [])


def test_merged_gang_train_in_processes_without_jax(tmp_path):
    """``train --num-workers 2 --feed merged --device cpu``: the slab gang
    (``ops.als`` ``SlabGangALS``, ``parallel.mesh`` groups,
    ``parallel.distributed`` ``HostCollectives``) — the supervisor and
    both ranks load no JAX, and the gang completes."""
    _gang_train_without_jax(tmp_path, ["--feed", "merged"])


@pytest.mark.parametrize("kind,extra", [("classification", []),
                                        ("text", ["--feed", "merged"])])
def test_linear_gang_train_in_processes_without_jax(tmp_path, kind, extra):
    """``train --num-workers 2`` of the linear templates: Classification's
    Naive Bayes off the partition feed (``train_feed.partition_examples``,
    ``ops.linear`` process-local NB) and Text-Classification's LR on the
    merged corpus (the codec's tokenizer, the process-local L-BFGS) — the
    supervisor and both ranks load no JAX, and the gang completes."""
    _gang_train_without_jax(tmp_path, extra, kind)


def test_ur_gang_train_in_processes_without_jax(tmp_path):
    """``train --num-workers 2`` of the Universal Recommender on the
    partitioned log (read as the merged view): each rank counts its block
    of the user ranges (``ops.llr`` with ``HostCollectives``) — the
    supervisor and both ranks load no JAX, and the gang completes."""
    _gang_train_without_jax(tmp_path, [], "ur")


def _gang_events(kind: str, part: int) -> list:
    from incubator_predictionio_torch.data.storage.datamap import DataMap
    from incubator_predictionio_torch.data.storage.event import Event

    if kind == "classification":
        return [Event(event="$set", entity_type="user", entity_id=f"u{j}",
                      properties=DataMap({"attr0": j % 3, "attr1": j % 5,
                                          "attr2": 1, "plan": j % 2}))
                for j in range(part, 40, 2)]
    if kind == "ur":
        return [Event(event=("buy", "view")[j % 2], entity_type="user",
                      entity_id=f"u{(j * 7) % 13}",
                      target_entity_type="item",
                      target_entity_id=f"i{(j * 3) % 11}")
                for j in range(part, 80, 2)]
    if kind == "text":
        return [Event(event="documents", entity_type="content",
                      entity_id=f"d{j}", properties=DataMap({
                          "text": f"w{j % 7} w{j % 3} common",
                          "label": f"c{j % 2}"}))
                for j in range(part, 40, 2)]
    return [Event(
        event="rate", entity_type="user", entity_id=f"u{(j * 7) % 11}",
        target_entity_type="item", target_entity_id=f"i{j % 5}",
        properties=DataMap({"rating": float(1 + j % 5)}))
        for j in range(part, 60, 2)]


_GANG_ENGINES = {
    "als": {"engineFactory": "incubator_predictionio_torch.models."
                             "recommendation.RecommendationEngine",
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "numIterations": 2, "lambda": 0.1}}]},
    "classification": {
        "engineFactory": "incubator_predictionio_torch.models."
                         "classification.ClassificationEngine",
        "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}]},
    "ur": {"engineFactory": "incubator_predictionio_torch.models."
                            "universal_recommender."
                            "UniversalRecommenderEngine",
           "algorithms": [{"name": "ur", "params": {
               "appName": "nojax", "maxCorrelatorsPerItem": 4,
               "user_chunk": 4}}]},
    "text": {"engineFactory": "incubator_predictionio_torch.models."
                              "text_classification.TextClassificationEngine",
             "preparator": {"params": {"numFeatures": 64}},
             "algorithms": [{"name": "lr", "params": {
                 "regParam": 0.1, "max_iters": 5}}]},
}


def _gang_train_without_jax(tmp_path, extra: list, kind: str = "als") -> None:
    import json

    from incubator_predictionio_torch.data.storage import App, Storage
    from incubator_predictionio_torch.data.storage.jsonl import JSONLEvents

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    reports = tmp_path / "modules"
    reports.mkdir()
    store_env = {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "meta.sqlite"),
        "PIO_STORAGE_SOURCES_EV_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / "events")}
    storage = Storage(store_env)
    app_id = storage.get_meta_data_apps().insert(App(0, "nojax"))
    events_dir = storage.get_l_events().events_dir
    storage.close()
    for part in (0, 1):
        os.environ["PIO_EVENT_PARTITION"] = str(part)
        try:
            log = JSONLEvents(events_dir)
        finally:
            del os.environ["PIO_EVENT_PARTITION"]
        log.insert_batch(_gang_events(kind, part), app_id)
    ds = {"appName": "nojax"}
    if kind == "ur":
        ds["eventNames"] = ["buy", "view"]
    (tmp_path / "engine.json").write_text(json.dumps({
        **_GANG_ENGINES[kind], "datasource": {"params": ds}}))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(store_env, PYTHONPATH=os.pathsep.join([str(site), str(ROOT)]),
               PIO_FS_BASEDIR=str(tmp_path / "base"),
               PIO_TEST_MODULES_DIR=str(reports),
               PIO_WORKER_HEARTBEAT_MS="100", PIO_SUPERVISOR_POLL_MS="25")
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "train", "--num-workers", "2", "--device", "cpu", *extra], env=env,
        cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["state"] == \
        "completed"
    docs = [json.loads(p.read_text()) for p in reports.glob("*.json")]
    assert sum("--num-workers" in d["argv"] for d in docs) == 1, docs
    assert len(docs) == 3, docs  # the supervisor and its two ranks
    assert all(d["loaded"] == [] for d in docs), docs


def test_network_store_train_in_a_process_without_jax(tmp_path):
    """``train`` on the network stores: apps, keys and events over the
    port's storage server (TYPE=HTTP), the model into PostgreSQL."""
    import json

    from pg_mock import MockPGServer

    from incubator_predictionio_torch.data.api.storage_server import (
        StorageServer,
    )
    from incubator_predictionio_torch.data.storage import App, Event, Storage

    backing = Storage({
        f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
        for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "backing.sqlite")})
    app_id = backing.get_meta_data_apps().insert(App(0, "netapp"))
    backing.get_l_events().insert_batch([Event.from_json({
        "event": "rate", "entityType": "user", "entityId": f"u{u}",
        "targetEntityType": "item", "targetEntityId": f"i{(u * 7 + k) % 9}",
        "properties": {"rating": float(1 + (u + k) % 5)}})
        for u in range(12) for k in range(4)], app_id)
    (tmp_path / "engine.json").write_text(json.dumps({
        "engineFactory": "incubator_predictionio_torch.models."
                         "recommendation.RecommendationEngine",
        "datasource": {"params": {"appName": "netapp"}},
        "algorithms": [{"name": "als", "params": {"rank": 4,
                                                  "numIterations": 2}}]}))
    srv = StorageServer(backing, "127.0.0.1", 0, secret="tok")
    port = srv.start()[1]
    try:
        with MockPGServer(user="pio", password="pw") as pg:
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("PIO_STORAGE_")}
            env.update({
                "PYTHONPATH": str(ROOT),
                "PIO_FS_BASEDIR": str(tmp_path / "base"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "PG",
                "PIO_STORAGE_SOURCES_NET_TYPE": "HTTP",
                "PIO_STORAGE_SOURCES_NET_HOSTS": "127.0.0.1",
                "PIO_STORAGE_SOURCES_NET_PORTS": str(port),
                "PIO_STORAGE_SOURCES_NET_SECRET": "tok",
                "PIO_STORAGE_SOURCES_PG_TYPE": "PGSQL",
                "PIO_STORAGE_SOURCES_PG_HOST": "127.0.0.1",
                "PIO_STORAGE_SOURCES_PG_PORT": str(pg.port),
                "PIO_STORAGE_SOURCES_PG_USERNAME": "pio",
                "PIO_STORAGE_SOURCES_PG_PASSWORD": "pw"})
            out = subprocess.run(
                [sys.executable, "-c", _VERB, "train", "--device", "cpu"],
                capture_output=True, text=True, env=env, cwd=str(tmp_path),
                timeout=300)
            assert out.returncode == 0, out.stderr[-3000:]
            assert '"loaded": []' in out.stdout.strip().splitlines()[-1]
            iid = json.loads(out.stdout.strip().splitlines()[-2])[
                "engineInstanceId"]
            models = Storage({k: v for k, v in env.items()
                              if k.startswith("PIO_STORAGE_")})
            assert models.get_model_data_models().get(iid) is not None
            assert models.get_meta_data_engine_instances().get(
                iid).status == "COMPLETED"
            models.close()
    finally:
        srv.stop()
        backing.close()


def test_object_store_train_and_deploy_in_a_process_without_jax(tmp_path):
    """``train`` with metadata and events on Elasticsearch and the model
    into S3, then ``deploy`` restoring that model from S3 (the stand-in
    servers in this process)."""
    import json

    from torch_es_server import ESServer
    from torch_s3_server import S3Server

    from incubator_predictionio_torch.data.storage import App, Event, Storage

    (tmp_path / "engine.json").write_text(json.dumps({
        "engineFactory": "incubator_predictionio_torch.models."
                         "recommendation.RecommendationEngine",
        "datasource": {"params": {"appName": "objapp"}},
        "algorithms": [{"name": "als", "params": {"rank": 4,
                                                  "numIterations": 2}}]}))
    with ESServer() as es, S3Server("AKNOJAX", "sk") as s3:
        store_env = {
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "ES",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ES",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "OBJ",
            "PIO_STORAGE_SOURCES_ES_TYPE": "ELASTICSEARCH",
            "PIO_STORAGE_SOURCES_ES_HOSTS": "127.0.0.1",
            "PIO_STORAGE_SOURCES_ES_PORTS": str(es.port),
            "PIO_STORAGE_SOURCES_OBJ_TYPE": "S3",
            "PIO_STORAGE_SOURCES_OBJ_ENDPOINT": s3.endpoint,
            "PIO_STORAGE_SOURCES_OBJ_BUCKET": "models",
            "PIO_STORAGE_SOURCES_OBJ_ACCESS_KEY": "AKNOJAX",
            "PIO_STORAGE_SOURCES_OBJ_SECRET_KEY": "sk"}
        storage = Storage(store_env)
        app_id = storage.get_meta_data_apps().insert(App(0, "objapp"))
        storage.get_l_events().insert_batch([Event.from_json({
            "event": "rate", "entityType": "user", "entityId": f"u{u}",
            "targetEntityType": "item",
            "targetEntityId": f"i{(u * 7 + k) % 9}",
            "properties": {"rating": float(1 + (u + k) % 5)}})
            for u in range(12) for k in range(4)], app_id)
        storage.close()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PIO_STORAGE_")}
        env.update(store_env, PYTHONPATH=str(ROOT),
                   PIO_FS_BASEDIR=str(tmp_path / "base"))
        out = subprocess.run(
            [sys.executable, "-c", _VERB, "train", "--device", "cpu"],
            capture_output=True, text=True, env=env, cwd=str(tmp_path),
            timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert '"loaded": []' in out.stdout.strip().splitlines()[-1]
        iid = json.loads(out.stdout.strip().splitlines()[-2])[
            "engineInstanceId"]
        assert [k for k in s3.objects if iid in k], sorted(s3.objects)
        port = str(_free_port())
        out = subprocess.run(
            [sys.executable, "-c", _VERB, "deploy", "--device", "cpu",
             "--ip", "127.0.0.1", "--port", port],
            capture_output=True, text=True, env=env | {"PROBE_PORT": port},
            cwd=str(tmp_path), timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert '"loaded": []' in out.stdout.strip().splitlines()[-1]
