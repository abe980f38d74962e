"""The port's operator tools held to the reference's on the CPU:
``pypio`` (``incubator_predictionio_torch/pypio``), ``pio train
--profile-dir`` (``workflow/core_workflow.py`` ``profiled``), the verbs
``shell``, ``run``, ``upgrade`` and ``template`` (``tools/commands/
management.py``) with the port's template bundle, the admin server
(``tools/admin.py``) over HTTP and HTTPS, and Parquet ``export`` /
``import`` both ways between the packages, and without pyarrow.
"""

import http.client
import json
import os
import ssl
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from incubator_predictionio_tpu import pypio as ref_pypio  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_torch import pypio  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.tools import console  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow  # noqa: E402
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.persist import models_from_bytes  # noqa: E402
from incubator_predictionio_torch.workflow.workflow_params import WorkflowParams  # noqa: E402

TOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
TLS_DIR = ROOT / "tests" / "fixtures" / "torch_tls"
PORT_FACTORY = ("incubator_predictionio_torch.models.recommendation."
                "RecommendationEngine")
REF_FACTORY = ("incubator_predictionio_tpu.models.recommendation."
               "RecommendationEngine")
#: well conditioned (λ·n_ratings), so two float32 solvers agree to 2e-4
ALGO = {"rank": 4, "numIterations": 5, "lambda": 0.05,
        "lambdaScaling": "nratings", "seed": 7}


def _wire_events(n_users=20, n_items=12, seed=0):
    rng = np.random.default_rng(seed)
    evs = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < 0.45:
                evs.append({
                    "event": "rate", "entityType": "user",
                    "entityId": f"u{u}", "targetEntityType": "item",
                    "targetEntityId": f"i{i}",
                    "properties": {"rating": float(rng.integers(1, 11)) / 2},
                    "eventTime": f"2024-01-01T00:0{int(rng.integers(10))}"
                                 f":00.000Z"})
    evs.append({"event": "buy", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i3",
                "properties": {}, "eventTime": "2024-01-01T00:05:00.000Z"})
    evs.append({"event": "rate", "entityType": "user", "entityId": "tagged",
                "targetEntityType": "item", "targetEntityId": "i0",
                "properties": {"rating": 5}, "tags": ["a", "b"],
                "prId": "pr-77", "eventTime": "2024-02-01T00:00:00.000Z"})
    return evs


def _sqlite_env(path):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(path)}


def _events_file(tmp_path):
    path = tmp_path / "events.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in _wire_events()) + "\n")
    return path


def _engine_dir(tmp_path, factory, name):
    d = tmp_path / name
    d.mkdir()
    (d / "engine.json").write_text(json.dumps({
        "id": "default", "engineFactory": factory,
        "datasource": {"params": {"appName": "pyapp"}},
        "algorithms": [{"name": "als", "params": ALGO}]}))
    return str(d)


# -- pypio ---------------------------------------------------------------------


@pytest.fixture()
def both_pypio(tmp_path):
    """Each package's pypio bound to a SQLite store of its own holding the
    app "pyapp" with the same events, imported through pypio."""
    port = Storage(_sqlite_env(tmp_path / "port.sqlite"))
    ref = ref_storage.Storage(_sqlite_env(tmp_path / "ref.sqlite"))
    pypio.init(port)
    ref_pypio.init(ref)
    events = _events_file(tmp_path)
    counts = []
    for mod in (pypio, ref_pypio):
        app_id, key = mod.new_app("pyapp")
        assert app_id > 0 and key
        counts.append(mod.import_events("pyapp", str(events)))
    yield counts
    port.close()
    ref.close()


def test_pypio_reads_equal_the_reference(both_pypio):
    assert both_pypio[0] == both_pypio[1] == len(_wire_events())
    got = pypio.find_events("pyapp")
    want = ref_pypio.find_events("pyapp")
    assert len(got) == len(want) == len(_wire_events())
    for col in ("event", "entity_type", "entity_id", "target_entity_id",
                "properties"):
        assert getattr(got, col) == getattr(want, col), col
    np.testing.assert_array_equal(got.event_time_us, want.event_time_us)
    only_buy = pypio.find_events("pyapp", event_names=["buy"])
    assert only_buy.event == ref_pypio.find_events(
        "pyapp", event_names=["buy"]).event == ["buy"]
    u, i, r, users, items = pypio.find_ratings("pyapp")
    ru, ri, rr, rusers, ritems = ref_pypio.find_ratings("pyapp")
    np.testing.assert_array_equal(u, ru)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(r, rr)
    assert list(users.to_dict().items()) == list(rusers.to_dict().items())
    assert list(items.to_dict().items()) == list(ritems.to_dict().items())


def test_pypio_train_matches_the_reference(both_pypio, tmp_path):
    iid = pypio.train(_engine_dir(tmp_path, PORT_FACTORY, "port_engine"),
                      device="cpu")
    ref_iid = ref_pypio.train(_engine_dir(tmp_path, REF_FACTORY,
                                          "ref_engine"))
    store = pypio._require_storage()
    assert store.get_meta_data_engine_instances().get(iid).status \
        == "COMPLETED"
    dep, instance, _ = core_workflow.load_deployment(
        port_rec.RecommendationEngine()(), None,
        WorkflowContext(storage=store, device="cpu"),
        engine_factory_name=PORT_FACTORY)
    assert instance.id == iid
    from incubator_predictionio_tpu.models import recommendation as ref_rec
    from incubator_predictionio_tpu.workflow import core_workflow as ref_core
    from incubator_predictionio_tpu.workflow.context import (
        WorkflowContext as RefContext,
    )

    ref_dep, ref_instance, _ = ref_core.load_deployment(
        ref_rec.RecommendationEngine()(), None,
        RefContext(storage=ref_pypio._require_storage()),
        engine_factory_name=REF_FACTORY)
    assert ref_instance.id == ref_iid
    m, rm = dep.models[0], ref_dep.models[0]
    np.testing.assert_allclose(m.factors.user_factors,
                               rm.factors.user_factors, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(m.factors.item_factors,
                               rm.factors.item_factors, rtol=TOL, atol=TOL)
    assert list(m.users.to_dict().items()) == \
        list(rm.users.to_dict().items())


def test_pypio_train_defaults_to_the_card(both_pypio, tmp_path):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pypio.train(_engine_dir(tmp_path, PORT_FACTORY, "card_engine"))


def test_pypio_delete_and_errors(both_pypio):
    with pytest.raises(ValueError):
        pypio.new_app("pyapp")
    pypio.delete_app("pyapp")
    with pytest.raises(ValueError):
        pypio.delete_app("pyapp")
    with pytest.raises(ValueError):
        pypio.import_events("pyapp", "/nonexistent")


# -- train --profile-dir -------------------------------------------------------


def _blob_arrays(store, iid):
    _, stored = models_from_bytes(model_artifact.read_model(store, iid))
    return stored[0]


def test_profile_dir_writes_a_trace_and_keeps_the_factors(tmp_path):
    store = Storage(_sqlite_env(tmp_path / "p.sqlite"))
    pypio.init(store)
    pypio.new_app("pyapp")
    pypio.import_events("pyapp", str(_events_file(tmp_path)))
    ej = {"id": "default", "engineFactory": PORT_FACTORY,
          "datasource": {"params": {"appName": "pyapp"}},
          "algorithms": [{"name": "als", "params": ALGO}]}

    def train(wp):
        ctx = WorkflowContext(app_name="pyapp", storage=store, device="cpu")
        return core_workflow.run_train(
            port_rec.RecommendationEngine()(), EngineParams.from_json(ej),
            ctx, wp, engine_factory_name=PORT_FACTORY)

    plain = train(WorkflowParams())
    traced = train(WorkflowParams(profile_dir=str(tmp_path / "trace")))
    path = Path(core_workflow.trace_path(str(tmp_path / "trace"), traced))
    assert path.is_file() and list((tmp_path / "trace").iterdir()) == [path]
    doc = json.loads(path.read_text())
    assert doc["traceEvents"]
    # the CPU run has no kernel events; the ALS ops are there
    assert core_workflow.trace_kernels(str(path)) == {}
    assert any("aten::" in (ev.get("name") or "")
               for ev in doc["traceEvents"])
    a, b = _blob_arrays(store, plain), _blob_arrays(store, traced)
    for k in ("user_factors", "item_factors"):
        assert np.array_equal(a[k], b[k]), k
    store.close()


def test_trace_paths_are_per_rank_and_per_train(tmp_path):
    p0 = core_workflow.trace_path(str(tmp_path), "iid", "0")
    p1 = core_workflow.trace_path(str(tmp_path), "iid", "1")
    q0 = core_workflow.trace_path(str(tmp_path), "other", "0")
    assert len({p0, p1, q0}) == 3
    assert all(p.startswith(str(tmp_path)) for p in (p0, p1, q0))


def test_profile_on_the_card_refuses_a_cpu_only_trace(monkeypatch, tmp_path):
    """No quiet fall back: a card run whose torch cannot trace CUDA
    raises before training."""
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})

    class Ctx:
        device = "cuda"
        engine_instance_id = "iid"

    with pytest.raises(RuntimeError, match="CUDA"):
        with core_workflow.profiled(Ctx(), WorkflowParams(
                profile_dir=str(tmp_path / "t"))):
            pytest.fail("the body must not run")
    assert not (tmp_path / "t").exists()
    with core_workflow.profiled(Ctx(), WorkflowParams()) as path:
        assert path is None


@pytest.fixture()
def basedir(tmp_path, monkeypatch):
    """An empty default store at $PIO_FS_BASEDIR/pio.sqlite for the verbs
    in process."""
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


def test_train_verb_profile_dir(basedir, tmp_path, capsys, monkeypatch):
    assert _verb(["app", "new", "pyapp"], capsys)[0] == 0
    events = _events_file(tmp_path)
    assert _verb(["import", "--app-name", "pyapp", "--input", str(events)],
                 capsys)[0] == 0
    _engine_dir(tmp_path, PORT_FACTORY, "eng")
    monkeypatch.chdir(tmp_path / "eng")
    rc, out, err = _verb(["train", "--device", "cpu", "--profile-dir",
                          str(tmp_path / "trace")], capsys)
    assert rc == 0, err
    iid = json.loads(out.strip().splitlines()[-1])["engineInstanceId"]
    assert Path(core_workflow.trace_path(str(tmp_path / "trace"),
                                         iid)).is_file()


# -- the verbs -----------------------------------------------------------------


def test_shell_runs_one_statement(basedir, capsys):
    rc, out, _ = _verb(["shell", "-c",
                        "aid, key = pypio.new_app('shellapp'); "
                        "print('created', aid, type(np).__name__, "
                        "type(storage).__name__)"], capsys)
    assert rc == 0 and out.split() == ["created", "1", "module", "Storage"]
    rc, out, _ = _verb(["app", "list"], capsys)
    assert "shellapp" in out


def test_shell_starts_without_torch(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(tmp_path / "b"))
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "shell", "-c", "import sys; print('torch' in sys.modules, "
                        "'jax' in sys.modules)"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "False"]


def test_run_calls_a_dotted_callable(basedir, capsys):
    rc, out, _ = _verb(["run", "os.path.basename", "/a/b/c"], capsys)
    assert (rc, out.strip()) == (0, "c")
    rc, out, _ = _verb(["run", "os.getpid"], capsys)
    assert rc == 0 and int(out) == os.getpid()


def test_run_refuses_a_jax_package_path(basedir, capsys):
    rc, _, err = _verb(["run", "incubator_predictionio_tpu.pypio.init"],
                       capsys)
    assert rc == 1 and "JAX package" in err


def test_run_from_the_engine_dir(basedir, tmp_path, capsys):
    (tmp_path / "myjob.py").write_text("def main(x='0'):\n"
                                       "    return 'ran ' + x\n")
    rc, out, _ = _verb(["run", "myjob.main", "--engine-dir", str(tmp_path),
                        "7"], capsys)
    assert (rc, out.strip()) == (0, "ran 7")


def test_upgrade_message_equals_the_reference(capsys):
    from incubator_predictionio_tpu.tools.commands.management import (
        upgrade_cmd as ref_upgrade,
    )
    from incubator_predictionio_torch.tools.commands.management import (
        upgrade_cmd,
    )

    assert upgrade_cmd([]) == 0
    port = capsys.readouterr().out
    assert ref_upgrade([]) == 0
    assert port == capsys.readouterr().out and "Nothing to do" in port


def test_template_list_is_the_bundle(capsys):
    rc, out, _ = _verb(["template", "list"], capsys)
    assert rc == 0
    assert out.split() == sorted(p.name for p in (ROOT / "templates").iterdir()
                                 if p.is_dir())


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "templates").iterdir() if p.is_dir()))
def test_bundled_engine_json_equals_the_reference(name, monkeypatch):
    """Each of the port's engine.json files is the reference's, but for an
    engineFactory that names the port's class (the user's own module for
    vanilla), which resolves to a factory of the port. Both packages'
    vanilla modules are called ``vanilla_engine``: the port's is resolved
    with the name free and removed afterwards, so neither package's test
    gets the other's cached module."""
    from incubator_predictionio_torch.workflow.json_extractor import (
        engine_from_factory, resolve_engine_factory,
    )

    ref = json.loads((ROOT / "templates" / name / "engine.json").read_text())
    tdir = ROOT / "incubator_predictionio_torch" / "templates" / name
    port = json.loads((tdir / "engine.json").read_text())
    assert {k: v for k, v in port.items() if k != "engineFactory"} == \
        {k: v for k, v in ref.items() if k != "engineFactory"}
    assert port["engineFactory"] == ref["engineFactory"].replace(
        "incubator_predictionio_tpu.", "incubator_predictionio_torch.")
    assert not port["engineFactory"].startswith("incubator_predictionio_tpu")
    saved = sys.modules.pop("vanilla_engine", None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    try:
        engine = engine_from_factory(resolve_engine_factory(
            port["engineFactory"], str(tdir)))
    finally:
        sys.modules.pop("vanilla_engine", None)
        if saved is not None:
            sys.modules["vanilla_engine"] = saved
    assert type(engine).__module__.startswith("incubator_predictionio_torch")


def test_template_get_copies_the_bundle(tmp_path, capsys):
    dest = tmp_path / "rec"
    rc, out, _ = _verb(["template", "get", "recommendation", str(dest)],
                       capsys)
    assert rc == 0 and "copied" in out
    src = ROOT / "incubator_predictionio_torch" / "templates" / "recommendation"
    assert (dest / "engine.json").read_text() == \
        (src / "engine.json").read_text()
    rc, out, _ = _verb(["template", "get", "vanilla", str(tmp_path / "v")],
                       capsys)
    assert rc == 0 and (tmp_path / "v" / "vanilla_engine.py").is_file()
    rc, _, err = _verb(["template", "get", "nope", str(tmp_path / "n")],
                       capsys)
    assert rc == 1 and "unknown template" in err
    assert not (tmp_path / "n").exists()


# -- the admin server ----------------------------------------------------------


def _mem_env():
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEM"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"}


def _admin_sequence(port: int, context=None) -> list:
    """tests/test_eval_and_ops_servers.py's test_admin_server sequence:
    (method, path, status, body) with each access key masked."""
    out = []
    key = None

    def call(method, path, body=None):
        nonlocal key
        conn = (http.client.HTTPSConnection("127.0.0.1", port, timeout=10,
                                            context=context)
                if context else
                http.client.HTTPConnection("127.0.0.1", port, timeout=10))
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        text = json.dumps(doc)
        if isinstance(doc, dict) and doc.get("accessKey"):
            key = doc["accessKey"]
        if key:
            text = text.replace(key, "<key>")
        out.append((method, path, r.status, json.loads(text)))

    call("GET", "/")
    call("POST", "/cmd/app", {"name": "adminapp"})
    call("POST", "/cmd/app", {"name": "adminapp"})
    call("POST", "/cmd/app", {})
    call("GET", "/cmd/app")
    call("DELETE", "/cmd/app/adminapp/data")
    call("DELETE", "/cmd/app/adminapp")
    call("DELETE", "/cmd/app/adminapp")
    call("GET", "/cmd/app")
    return out


@pytest.fixture(scope="module")
def ref_admin_sequence():
    pytest.importorskip("aiohttp")
    sys.path.insert(0, str(ROOT / "tests"))
    from server_utils import ServerThread

    from incubator_predictionio_tpu.tools.admin import AdminServer as RefAdmin

    with ServerThread(RefAdmin(ref_storage.Storage(_mem_env())).app) as st:
        return _admin_sequence(st.port)


def test_admin_server_equals_the_reference(ref_admin_sequence):
    from incubator_predictionio_torch.tools.admin import AdminServer

    server = AdminServer(Storage(_mem_env()), port=0)
    _, port = server.start()
    try:
        got = _admin_sequence(port)
    finally:
        server.stop()
    assert got == ref_admin_sequence
    codes = [c for _, _, c, _ in got]
    assert codes == [200, 201, 409, 400, 200, 200, 200, 404, 200]
    assert got[4][3][0]["accessKeys"] == ["<key>"]


def test_admin_server_over_tls(ref_admin_sequence, monkeypatch):
    from incubator_predictionio_torch.common.ssl_config import (
        loopback_client_context,
    )
    from incubator_predictionio_torch.tools.admin import AdminServer

    monkeypatch.setenv("PIO_SSL_CERTFILE", str(TLS_DIR / "cert.pem"))
    monkeypatch.setenv("PIO_SSL_KEYFILE", str(TLS_DIR / "key.pem"))
    server = AdminServer(Storage(_mem_env()), port=0)
    _, port = server.start()
    try:
        assert _admin_sequence(port, loopback_client_context()) == \
            ref_admin_sequence
        # plaintext is refused on the HTTPS port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        with pytest.raises((http.client.HTTPException, OSError)):
            conn.request("GET", "/")
            conn.getresponse().read()
        conn.close()
    finally:
        server.stop()
    monkeypatch.setenv("PIO_SSL_KEYFILE", str(TLS_DIR / "missing.pem"))
    with pytest.raises((OSError, ssl.SSLError)):
        AdminServer(Storage(_mem_env()), port=0)


def test_adminserver_verb_serves_and_stops(tmp_path):
    import signal
    import socket
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(tmp_path / "b"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "adminserver", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.time() + 60
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("POST", "/cmd/app",
                             body=json.dumps({"name": "viaverb"}))
                r = conn.getresponse()
                assert r.status == 201, r.read()
                r.read()
                conn.close()
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.time() < deadline
                time.sleep(0.1)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    assert proc.returncode == 0
    s = Storage(_sqlite_env(tmp_path / "b" / "pio.sqlite"))
    assert [a.name for a in s.get_meta_data_apps().get_all()] == ["viaverb"]
    s.close()


# -- Parquet -------------------------------------------------------------------


def _ref_verb(fn_name, args, base, monkeypatch):
    from incubator_predictionio_tpu.tools.commands import management as m

    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    ref_storage.Storage.reset_instance()
    try:
        return getattr(m, fn_name)(args)
    finally:
        ref_storage.Storage.instance().close()
        ref_storage.Storage.reset_instance()


def _port_verb(args, base, monkeypatch, capsys):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    Storage.reset_instance()
    try:
        return _verb(args, capsys)
    finally:
        Storage.instance().close()
        Storage.reset_instance()


def _docs(path):
    return [json.loads(line) for line in open(path, encoding="utf-8")]


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_parquet_between_the_packages(direction, tmp_path, monkeypatch,
                                      capsys):
    pytest.importorskip("pyarrow")
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    src, dst = tmp_path / "src", tmp_path / "dst"
    events = _events_file(tmp_path)
    pq_file = tmp_path / "events.parquet"
    port_first = direction == "port-to-reference"
    # the source store: the events imported from JSON lines, exported as
    # Parquet (the format read from the extension)
    if port_first:
        assert _port_verb(["app", "new", "PqApp"], src, monkeypatch,
                          capsys)[0] == 0
        assert _port_verb(["import", "--app-name", "PqApp", "--input",
                           str(events)], src, monkeypatch, capsys)[0] == 0
        rc, out, _ = _port_verb(["export", "--app-name", "PqApp",
                                 "--output", str(pq_file)], src,
                                monkeypatch, capsys)
        assert rc == 0 and "(parquet)" in out
        _port_verb(["export", "--app-name", "PqApp", "--output",
                    str(tmp_path / "orig.jsonl")], src, monkeypatch, capsys)
        from incubator_predictionio_tpu.tools.commands import app as ref_app

        monkeypatch.setenv("PIO_FS_BASEDIR", str(dst))
        ref_storage.Storage.reset_instance()
        ref_app.app_cmd(["new", "PqApp"])
        ref_storage.Storage.reset_instance()
        assert _ref_verb("import_cmd", ["--app-name", "PqApp", "--input",
                                        str(pq_file)], dst, monkeypatch) == 0
        assert _ref_verb("export_cmd", ["--app-name", "PqApp", "--output",
                                        str(tmp_path / "back.jsonl")],
                         dst, monkeypatch) == 0
    else:
        from incubator_predictionio_tpu.tools.commands import app as ref_app

        monkeypatch.setenv("PIO_FS_BASEDIR", str(src))
        ref_storage.Storage.reset_instance()
        ref_app.app_cmd(["new", "PqApp"])
        ref_storage.Storage.reset_instance()
        assert _ref_verb("import_cmd", ["--app-name", "PqApp", "--input",
                                        str(events)], src, monkeypatch) == 0
        assert _ref_verb("export_cmd", ["--app-name", "PqApp", "--output",
                                        str(pq_file)], src, monkeypatch) == 0
        assert _ref_verb("export_cmd", ["--app-name", "PqApp", "--output",
                                        str(tmp_path / "orig.jsonl")],
                         src, monkeypatch) == 0
        assert _port_verb(["app", "new", "PqApp"], dst, monkeypatch,
                          capsys)[0] == 0
        rc, out, _ = _port_verb(["import", "--app-name", "PqApp", "--input",
                                 str(pq_file), "--format", "parquet"], dst,
                                monkeypatch, capsys)
        assert rc == 0 and f"Imported {len(_wire_events())} events" in out
        _port_verb(["export", "--app-name", "PqApp", "--output",
                    str(tmp_path / "back.jsonl"), "--format", "jsonl"], dst,
                   monkeypatch, capsys)
    orig, back = _docs(tmp_path / "orig.jsonl"), _docs(tmp_path / "back.jsonl")
    assert len(orig) == len(_wire_events())
    assert back == orig
    tagged = [d for d in back if d["entityId"] == "tagged"]
    assert tagged[0]["tags"] == ["a", "b"] and tagged[0]["prId"] == "pr-77"


def test_parquet_files_of_both_packages_are_equal(tmp_path, monkeypatch,
                                                 capsys):
    """The same events exported by each package: the same schema and the
    same rows."""
    pq = pytest.importorskip("pyarrow.parquet")
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    events = _events_file(tmp_path)
    base = tmp_path / "shared"
    assert _port_verb(["app", "new", "PqApp"], base, monkeypatch,
                      capsys)[0] == 0
    _port_verb(["import", "--app-name", "PqApp", "--input", str(events)],
               base, monkeypatch, capsys)
    _port_verb(["export", "--app-name", "PqApp", "--output",
                str(tmp_path / "port.parquet")], base, monkeypatch, capsys)
    assert _ref_verb("export_cmd", ["--app-name", "PqApp", "--output",
                                    str(tmp_path / "ref.parquet")], base,
                     monkeypatch) == 0
    a = pq.read_table(tmp_path / "port.parquet")
    b = pq.read_table(tmp_path / "ref.parquet")
    assert a.schema.equals(b.schema)
    assert a.to_pylist() == b.to_pylist()


_BLOCKED = r"""
import sys
sys.modules["pyarrow"] = None          # `import pyarrow` raises ImportError
sys.modules["pyarrow.parquet"] = None
from incubator_predictionio_torch.tools import console
sys.exit(console.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("verb", ["export", "import"])
def test_parquet_without_pyarrow_fails_clearly(verb, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(tmp_path / "b"))
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-c", _BLOCKED, *a], capture_output=True,
        text=True, env=env, timeout=120, cwd=str(tmp_path))
    assert run("app", "new", "PqApp").returncode == 0
    target = tmp_path / "events.parquet"
    if verb == "export":
        out = run("export", "--app-name", "PqApp", "--output", str(target))
        assert not target.exists()
    else:
        target.write_bytes(b"PAR1")
        out = run("import", "--app-name", "PqApp", "--input", str(target),
                  "--format", "parquet")
    assert out.returncode != 0
    assert "pyarrow" in out.stderr
    # explicit --format parquet fails the same way, and writes nothing
    other = tmp_path / "other.bin"
    if verb == "export":
        out = run("export", "--app-name", "PqApp", "--output", str(other),
                  "--format", "parquet")
        assert out.returncode != 0 and "pyarrow" in out.stderr
        assert not other.exists()
