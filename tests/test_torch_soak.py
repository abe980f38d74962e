"""The port's production-day soak (``incubator_predictionio_torch/workflow/
soak.py``, ``tools/commands/soak.py``) held to the reference's
(``incubator_predictionio_tpu/workflow/soak.py``) on the CPU.

- The planner: for the same ``SoakConfig`` both packages resolve the same
  scenario (apps, zipf weights, fault offsets and targets, per-process
  fault specs, notes, SLO bounds, the connection budget, the elastic ramp)
  and print the same ``describe()``.
- The exactly-once ledger: ``reconcile_ledger`` of both packages over one
  JSONL event log gives the same census.
- The SLO evaluator: ``evaluate_slos`` of both packages gives the same SLO
  and fault-evidence rows on the reference tests' green fixture and on
  each of its red paths.
- The CLI: ``pio soak --dry-run`` prints the reference's plan, and
  ``pio status``'s soak one-liner is the reference's.
- The reference's three live soaks on the real topology, with ``--device
  cpu`` and ``tests/torch_soak_engine.py``, slow-marked as the
  reference's are: the scaled-down smoke soak, the multi-tenant soak (also
  at the default 250 ms fold-in) and the headline full-menu soak on a
  2-replica fleet (``-m slow -k soak``).
"""

import json
import os
import shutil
import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from incubator_predictionio_tpu.workflow import soak as ref_soak  # noqa: E402
from incubator_predictionio_torch.workflow import soak  # noqa: E402

pytestmark = [pytest.mark.soak]

HERE = os.path.dirname(os.path.abspath(__file__))


def _template(tmp_path, app_name="soakapp"):
    """A template dir of the port's soak engine: `pio train` / `pio deploy
    --engine-dir` load it like any user engine."""
    tpl = tmp_path / "template"
    tpl.mkdir()
    shutil.copy(os.path.join(HERE, "torch_soak_engine.py"), tpl)
    (tpl / "engine.json").write_text(json.dumps({
        "id": "default",
        "engineFactory": "torch_soak_engine.engine_factory",
        "datasource": {"params": {"appName": app_name}},
        "algorithms": [{"name": "", "params": {}}],
    }))
    return str(tpl)


def _cfgs(mod, tmp_path, **kw):
    kw.setdefault("engine_dir", str(tmp_path / "nope"))
    kw.setdefault("workdir", str(tmp_path / "wd"))
    return mod.SoakConfig(**kw)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

PLANS = {
    "default": {},
    "seed7": {"seed": 7},
    "one-worker-single-process": {"event_workers": 1, "replicas": 0},
    "three-workers-four-replicas": {"event_workers": 3, "replicas": 4,
                                    "seed": 11},
    "tenants": {"apps": 3, "tenant_apps": 8},
    "tenants-bounded": {"tenant_apps": 6, "tenant_max_resident": 3,
                        "seed": 5},
    "elastic": {"elastic": True, "elastic_max": 4, "duration_s": 90.0},
    "unknown-fault": {"faults": ("worker_kill", "zap", "good_retrain")},
    "chip-phase": {"duration_s": 30.0, "faults": (
        "enospc_shed", "worker_kill", "replica_kill", "good_retrain",
        "compact_crash")},
    "no-cache": {"query_cache_size": 0, "catalog_items": 5000},
    # chip_smoke.py's soak_full_menu: `pio soak --faults full`, every other
    # flag at the CLI's default
    "card-full-menu": {"duration_s": 60.0, "event_workers": 2,
                       "replicas": 2, "apps": 3, "ingest_rps": 50.0,
                       "query_rps": 20.0, "foldin_ms": 250.0,
                       "swap_watch_ms": 2500.0, "quality_sample": 1.0,
                       "faults": soak.FAULT_MENU},
    # chip_smoke.py's soak_tenants: the multi-tenant soak at 250 ms
    "card-tenants": {"seed": 45, "duration_s": 16.0, "event_workers": 1,
                     "replicas": 0, "apps": 2, "tenant_apps": 5,
                     "ingest_rps": 12.0, "query_rps": 12.0,
                     "faults": ("enospc_shed", "poison_foldin"),
                     "quality_sample": 0.0, "foldin_ms": 250.0,
                     "swap_watch_ms": 2500.0, "rollback_deadline_s": 25.0},
}


def _plan_view(plan):
    return {
        "app_names": plan.app_names, "app_weights": plan.app_weights,
        "user_weights": plan.user_weights,
        "item_weights": plan.item_weights,
        "faults": [(f.name, f.kind, f.at_s, f.point, f.target, f.spec,
                    f.detail) for f in plan.faults],
        "worker_specs": plan.worker_specs,
        "replica_specs": plan.replica_specs, "notes": plan.notes,
        "slos": plan.slos, "conn_budget": plan.conn_budget,
        "ramp": plan.ramp, "describe": plan.describe(),
    }


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_equals_the_reference(name, tmp_path):
    kw = PLANS[name]
    tpl = _template(tmp_path, app_name="myprimary")
    port = soak.plan_scenario(_cfgs(soak, tmp_path, engine_dir=tpl, **kw))
    ref = ref_soak.plan_scenario(_cfgs(ref_soak, tmp_path, engine_dir=tpl,
                                       **kw))
    assert _plan_view(port) == _plan_view(ref)
    assert port.app_names[0] == "myprimary"


def test_registries_equal_the_reference():
    assert soak.FAULT_MENU == ref_soak.FAULT_MENU
    assert soak.FAULT_POINTS == ref_soak.FAULT_POINTS
    assert soak.SLO_METRICS == ref_soak.SLO_METRICS
    ref_fields = {f.name: f.default for f in
                  ref_soak.dataclasses.fields(ref_soak.SoakConfig)}
    port_fields = {f.name: f.default for f in
                   soak.dataclasses.fields(soak.SoakConfig)}
    # the port adds only the device, the card by default
    assert port_fields.pop("device") == "cuda"
    assert {k: v for k, v in port_fields.items()
            if k != "env_extra"} == {k: v for k, v in ref_fields.items()
                                     if k != "env_extra"}


def test_fault_points_exist_in_the_port():
    """Every spec-armed fault names a fault point the port fires."""
    root = os.path.join(os.path.dirname(HERE), "incubator_predictionio_torch")
    text = ""
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    text += fh.read()
    for point in soak.FAULT_POINTS.values():
        assert f'fault_point("{point}")' in text, point


# ---------------------------------------------------------------------------
# the exactly-once ledger
# ---------------------------------------------------------------------------

def _jsonl_env(tmp_path):
    return {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
        "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_JL_PATH": str(tmp_path / "events"),
    }


def _ledger(mod, acked, unacked):
    led = mod._Ledger()
    led.acked = list(acked)
    led.unacked = list(unacked)
    return led


@pytest.mark.parametrize("case", ["mixed", "clean", "all-lost"])
def test_reconcile_ledger_equals_the_reference(case, tmp_path):
    from incubator_predictionio_tpu.data import storage as ref_storage
    from incubator_predictionio_torch.data.storage import (
        App, DataMap, Event, Storage,
    )

    port_store = Storage(_jsonl_env(tmp_path))
    app_id = port_store.get_meta_data_apps().insert(App(0, "recapp"))
    le = port_store.get_l_events()

    def put(marker, n=1):
        for _ in range(n):
            le.insert(Event(event="rate", entity_type="user", entity_id="u",
                            target_entity_type="item", target_entity_id="i",
                            properties=DataMap({"marker": marker})), app_id)

    acked = [("recapp", "m-ok", "e1", "commit"),
             ("recapp", "m-dup", "e2", "enqueue"),
             ("recapp", "m-lost", "e3", "batch")]
    unacked = [("recapp", "m-amb", "conn-error"),
               ("recapp", "m-gone", "conn-error")]
    if case == "mixed":
        put("m-ok")
        put("m-dup", 2)
        put("m-amb")
    elif case == "clean":
        for mk in ("m-ok", "m-dup", "m-lost"):
            put(mk)
    # all-lost: the store holds no marker at all
    ref_store = ref_storage.Storage(_jsonl_env(tmp_path))
    port = soak.reconcile_ledger(port_store, _ledger(soak, acked, unacked),
                                 {"recapp": app_id}, {})
    ref = ref_soak.reconcile_ledger(ref_store,
                                    _ledger(ref_soak, acked, unacked),
                                    {"recapp": app_id}, {})
    assert port == ref
    if case == "mixed":
        assert port["lostAcked"] == [("recapp", "m-lost")]
        assert port["duplicatedCount"] == 1
        assert port["ambiguousSends"] == 2 and port["ambiguousLanded"] == 1
    port_store.close()
    ref_store.close()


# ---------------------------------------------------------------------------
# the SLO evaluator: the reference tests' green fixture and its red paths
# ---------------------------------------------------------------------------

def _green_fixture(mod, tmp_path, **cfg_kw):
    """tests/test_soak.py's green fixture (full menu, 2 + 2 topology), built
    with ``mod``'s classes."""
    cfg = _cfgs(mod, tmp_path, event_workers=2, replicas=2,
                rollback_deadline_s=30.0, **cfg_kw)
    plan = mod.plan_scenario(cfg)
    at = {f.name: f.at_s for f in plan.faults}
    ledger = mod._Ledger()
    ledger.acked = [("a", f"m{i}", f"e{i}", "commit") for i in range(10)]
    ledger.ingest_codes = {201: 10}
    ledger.query_codes = {200: 50}
    ledger.latencies = [0.01 * i for i in range(1, 51)]
    samples = mod._Samples()
    samples.metric_max = {
        'pio_ingest_append_errors_total{kind="enospc"}': 1.0,
        'pio_foldin_rollbacks_total{reason="error-rate"}': 1.0,
        'pio_fleet_rollbacks_total{reason="error-rate"}': 2.0,
        "pio_engine_quality_samples_total": 40.0,
        "pio_engine_quality_breaches_total": 1.0,
        "pio_query_cache_hits_total": 30.0,
        "pio_query_cache_misses_total": 20.0,
        'pio_query_cache_invalidations_total{reason="foldin"}': 9.0,
        'pio_query_cache_invalidations_total{reason="swap"}': 2.0,
        'pio_query_cache_invalidations_total{reason="rollback"}': 3.0,
    }
    samples.restarts = {"replica:1": 1}
    samples.served = [(1.0, "iid-initial"),
                      (at["good_retrain"] + 6, "iid-good")]
    samples.rollback_seen = [
        (at["poison_foldin"] + 3, "fleet:iid-pf", "directive pin error-rate"),
        (at["poison_retrain"] + 7, "fleet:iid-pr",
         "directive pin error-rate"),
        (at["poison_quality"] + 4, "fleet:iid-pq", "directive pin quality"),
    ]
    samples.foldin_publishes = 5
    fault_log = [
        {"name": "poison_foldin", "atS": at["poison_foldin"],
         "firedAtS": at["poison_foldin"], "ok": True},
        {"name": "good_retrain", "atS": at["good_retrain"],
         "firedAtS": at["good_retrain"], "ok": True,
         "instance": "iid-good"},
        {"name": "poison_retrain", "atS": at["poison_retrain"],
         "firedAtS": at["poison_retrain"], "ok": True,
         "instance": "iid-poison"},
        {"name": "poison_quality", "atS": at["poison_quality"],
         "firedAtS": at["poison_quality"], "ok": True},
    ]
    return dict(
        plan=plan, ledger=ledger, samples=samples,
        reconciliation={"ackedEvents": 10, "storeMarkers": 10,
                        "lostAcked": [], "lostAckedCount": 0,
                        "duplicated": [], "duplicatedCount": 0,
                        "ambiguousSends": 0, "ambiguousLanded": 0,
                        "walReplay": None},
        freshness={"finalLagS": 0.1, "boundS": 0.5},
        drain={"engine": 0, "eventserver": 0},
        supervisor_doc={"workers": [{"worker": 0, "restarts": 1},
                                    {"worker": 1, "restarts": 1}]},
        fault_log=fault_log)


def _tenant(fx):
    for app in fx["plan"].app_names:
        fx["ledger"].tenant_codes[app] = {200: 5, 503: 1}
    fx["samples"].tenants = {"evictions": 7, "resident": 3,
                             "maxResident": 3, "coldLoads": 13}


def _del_cache_metrics(fx, prefix="pio_query_cache"):
    for k in list(fx["samples"].metric_max):
        if k.startswith(prefix):
            del fx["samples"].metric_max[k]


def _at(fx, name):
    return {f.name: f.at_s for f in fx["plan"].faults}[name]


#: each red (or deliberately green) path of tests/test_soak.py's evaluator
#: tests: (config keywords, perturbation of the green fixture)
PERTURB = {
    "green": ({}, lambda fx: None),
    "lost-acked": ({}, lambda fx: fx["reconciliation"].update(
        lostAckedCount=2)),
    "duplicated": ({}, lambda fx: fx["reconciliation"].update(
        duplicatedCount=1)),
    "ingest-500": ({}, lambda fx: setattr(fx["ledger"], "ingest_codes",
                                          {201: 9, 500: 1})),
    "query-502": ({}, lambda fx: setattr(fx["ledger"], "query_codes",
                                         {200: 49, 502: 1})),
    "overload-codes": ({}, lambda fx: (
        setattr(fx["ledger"], "ingest_codes", {201: 9, 503: 5}),
        setattr(fx["ledger"], "query_codes", {200: 40, 503: 5, 504: 5}))),
    "p99-over": ({}, lambda fx: setattr(fx["ledger"], "latencies",
                                        [0.01] * 95 + [9.0] * 5)),
    "no-accepts": ({}, lambda fx: setattr(fx["ledger"], "latencies", [])),
    "rollback-missing": ({}, lambda fx: setattr(
        fx["samples"], "rollback_seen", fx["samples"].rollback_seen[:1])),
    "rollback-late": ({}, lambda fx: setattr(
        fx["samples"], "rollback_seen", [
            fx["samples"].rollback_seen[0],
            (_at(fx, "poison_retrain") + 100, "fleet:iid-pr", "late pin"),
            (_at(fx, "poison_quality") + 100, "fleet:iid-pq",
             "late directive pin quality")])),
    "one-rollback-two-poisons": ({}, lambda fx: (
        setattr(fx["samples"], "rollback_seen",
                [fx["samples"].rollback_seen[0]]),
        fx["fault_log"][2].update(firedAtS=fx["fault_log"][0]["firedAtS"]))),
    "stale-freshness": ({}, lambda fx: fx.update(
        freshness={"finalLagS": 2.0, "boundS": 0.5})),
    "never-produced": ({}, lambda fx: fx.update(
        freshness={"finalLagS": None, "boundS": 0.5})),
    "conn-errors": ({}, lambda fx: setattr(fx["ledger"],
                                           "ingest_conn_errors", 10 ** 6)),
    "drain-rc": ({}, lambda fx: fx.update(
        drain={"engine": 0, "eventserver": 1})),
    "drain-missing": ({}, lambda fx: fx.update(drain={"engine": 0})),
    "quality-as-error-rate": ({}, lambda fx: setattr(
        fx["samples"], "rollback_seen", [
            (t, k, d.replace("quality", "error-rate"))
            for t, k, d in fx["samples"].rollback_seen])),
    "dead-scorer": ({}, lambda fx: fx["samples"].metric_max.pop(
        "pio_engine_quality_samples_total")),
    "quality-late": ({}, lambda fx: setattr(
        fx["samples"], "rollback_seen", [
            (t, k, d) for t, k, d in fx["samples"].rollback_seen
            if "quality" not in d] + [
            (_at(fx, "poison_quality") + 31, "fleet:iid-pq",
             "directive pin quality")])),
    "cache-invalidations-short": ({}, lambda fx: (
        _del_cache_metrics(fx, "pio_query_cache_invalidations_total"),
        fx["samples"].metric_max.update({
            'pio_query_cache_invalidations_total{reason="rollback"}':
                2.0}))),
    "dead-cache": ({}, lambda fx: (
        fx["samples"].metric_max.pop("pio_query_cache_hits_total"),
        fx["samples"].metric_max.pop("pio_query_cache_misses_total"))),
    "cache-from-status": ({}, lambda fx: (
        _del_cache_metrics(fx),
        setattr(fx["samples"], "query_cache",
                {"hits": 12, "misses": 4, "invalidations": 5}))),
    "cache-disabled": ({"query_cache_size": 0}, _del_cache_metrics),
    "no-breach-counter": ({}, lambda fx: fx["samples"].metric_max.pop(
        "pio_engine_quality_breaches_total")),
    "no-enospc-counter": ({}, lambda fx: fx["samples"].metric_max.pop(
        'pio_ingest_append_errors_total{kind="enospc"}')),
    "no-worker-restart": ({}, lambda fx: fx.update(supervisor_doc={
        "workers": [{"worker": 0, "restarts": 0},
                    {"worker": 1, "restarts": 1}]})),
    "no-replica-restart": ({}, lambda fx: setattr(fx["samples"],
                                                  "restarts", {})),
    "retrain-never-served": ({}, lambda fx: setattr(
        fx["samples"], "served", [(1.0, "iid-initial")])),
    "tenants-green": ({"tenant_apps": 6}, _tenant),
    "tenant-hot-shed": ({"tenant_apps": 6}, lambda fx: (
        _tenant(fx), fx["ledger"].tenant_codes.update({
            fx["plan"].app_names[0]: {200: 2, 503: 400},
            fx["plan"].app_names[1]: {200: 3}}))),
    "tenant-500": ({"tenant_apps": 6}, lambda fx: (
        _tenant(fx), fx["ledger"].tenant_codes.update({
            fx["plan"].app_names[0]: {200: 4, 500: 1}}))),
    "tenant-unoffered": ({"tenant_apps": 6}, lambda fx: (
        _tenant(fx), fx["ledger"].tenant_codes.pop(
            fx["plan"].app_names[-1]))),
    "tenant-starved": ({"tenant_apps": 6}, lambda fx: (
        _tenant(fx), fx["ledger"].tenant_codes.update({
            fx["plan"].app_names[2]: {503: 9}}))),
    "tenant-no-churn": ({"tenant_apps": 6}, lambda fx: (
        _tenant(fx), setattr(fx["samples"], "tenants", {
            "evictions": 0, "resident": 3, "maxResident": 3,
            "coldLoads": 6}))),
    "elastic-grew-and-shrank": ({"elastic": True}, lambda fx: setattr(
        fx["samples"], "fleet_size", [
            (fx["plan"].ramp["upAtS"] + 5.0, 2, 2, 2),
            (fx["plan"].ramp["downAtS"] + 9.0, 1, 1, 1)])),
    "elastic-never-grew": ({"elastic": True}, lambda fx: setattr(
        fx["samples"], "fleet_size", [
            (fx["plan"].ramp["upAtS"] + 5.0, 1, 1, 1)])),
}


def _evaluate(mod, fx):
    return mod.evaluate_slos(fx["plan"], fx["ledger"], fx["samples"],
                             fx["reconciliation"], fx["freshness"],
                             fx["drain"], fx["supervisor_doc"],
                             fx["fault_log"])


@pytest.mark.parametrize("case", sorted(PERTURB))
def test_slo_rows_equal_the_reference(case, tmp_path):
    kw, perturb = PERTURB[case]
    rows = []
    for mod in (soak, ref_soak):
        fx = _green_fixture(mod, tmp_path, **kw)
        perturb(fx)
        rows.append(_evaluate(mod, fx))
    port, ref = rows
    assert port == ref
    slos, faults = port
    bad = [s["name"] for s in slos if not s["ok"]]
    if case in ("green", "overload-codes", "cache-from-status",
                "cache-disabled", "tenants-green", "tenant-hot-shed",
                "elastic-grew-and-shrank"):
        assert not bad, (case, bad)
    else:
        assert bad, case


# ---------------------------------------------------------------------------
# scorecards and the CLI
# ---------------------------------------------------------------------------

def test_write_and_read_scorecard_equal_the_reference(tmp_path):
    card = {"verdict": "PASS", "seed": 3, "wallS": 1.5,
            "topology": {"eventWorkers": 2}, "faults": [{"fired": True}],
            "slos": [{"name": "query-p99", "ok": True}],
            "traffic": {"acked": 4},
            "host": {"loopMops": 9.0, "note": "n"}}
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    soak.write_scorecard(card, str(tmp_path / "p" / "SOAK.json"), "k")
    ref_soak.write_scorecard(card, str(tmp_path / "r" / "SOAK.json"), "k")
    for name in ("SOAK.json", "BASELINE.json"):
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "r" / name).read_text()
    assert soak.read_scorecard(str(tmp_path / "p" / "SOAK.json")) == card
    assert soak.read_scorecard(str(tmp_path / "missing.json")) is None


@pytest.mark.parametrize("argv", [
    ["--seed", "99", "--duration-s", "30"],
    ["--seed", "7", "--duration-s", "30", "--tenant-apps", "8",
     "--tenant-max-resident", "3"],
    ["--elastic", "--elastic-max", "4", "--faults", "none"],
    ["--event-workers", "1", "--replicas", "0", "--faults",
     "enospc_shed,poison_foldin,worker_kill"],
    ["--faults", "full"],
    ["--seed", "45", "--duration-s", "16", "--event-workers", "1",
     "--replicas", "0", "--apps", "2", "--tenant-apps", "5",
     "--ingest-rps", "12", "--query-rps", "12", "--faults",
     "enospc_shed,poison_foldin", "--quality-sample", "0", "--foldin-ms",
     "250", "--watch-ms", "2500", "--rollback-deadline-s", "25"],
], ids=["default", "tenants", "elastic", "smoke", "card-full-menu",
        "card-tenants"])
def test_dry_run_prints_the_reference_plan(argv, tmp_path, capsys):
    from incubator_predictionio_tpu.tools.commands.soak import (
        soak_cmd as ref_soak_cmd,
    )
    from incubator_predictionio_torch.tools.commands.soak import soak_cmd

    tpl = _template(tmp_path)
    args = ["--engine-dir", tpl, "--dry-run", *argv]
    assert soak_cmd(args) == 0
    port = capsys.readouterr().out
    assert ref_soak_cmd(args) == 0
    ref = capsys.readouterr().out
    assert port == ref
    assert "fault timeline:" in port and "(dry run: nothing launched)" in port
    assert not (tmp_path / "wd").exists()


def test_dry_run_accepts_the_device(tmp_path, capsys):
    from incubator_predictionio_torch.tools.commands.soak import soak_cmd

    tpl = _template(tmp_path)
    assert soak_cmd(["--engine-dir", tpl, "--dry-run", "--device", "cpu"]) \
        == 0
    assert "(dry run: nothing launched)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        soak_cmd(["--engine-dir", tpl, "--dry-run", "--device", "tpu"])


SCORECARDS = {
    "pass": {"verdict": "PASS", "seed": 77, "startedAt": 3600.0,
             "slos": [{"name": "acked-event-loss", "ok": True},
                      {"name": "query-p99", "ok": True}],
             "faults": [{"name": "worker_kill", "fired": True},
                        {"name": "enospc_shed", "fired": True}]},
    "fail": {"verdict": "FAIL", "seed": 78, "startedAt": 0.0,
             "slos": [{"name": "acked-event-loss", "ok": False},
                      {"name": "query-p99", "ok": True}],
             "faults": [{"name": "worker_kill", "fired": True}]},
    "no-verdict": {"seed": 1},
    "absent": None,
}


@pytest.mark.parametrize("case", sorted(SCORECARDS))
def test_status_one_liner_equals_the_reference(case, tmp_path, capsys,
                                               monkeypatch):
    from incubator_predictionio_tpu.tools.commands.management import (
        _print_soak_verdict as ref_line,
    )
    from incubator_predictionio_torch.tools.commands.management import (
        _print_soak_verdict,
    )

    monkeypatch.chdir(tmp_path)
    # a fixed clock: the line carries the scorecard's age
    monkeypatch.setattr(time, "time", lambda: 7200.0)
    if SCORECARDS[case] is not None:
        (tmp_path / "SOAK.json").write_text(json.dumps(SCORECARDS[case]))
    _print_soak_verdict()
    port = capsys.readouterr().out
    ref_line()
    assert port == capsys.readouterr().out
    if case == "pass":
        assert "[info] Last soak" in port and "2/2 SLO(s) green" in port
    elif case == "fail":
        assert "VIOLATED: acked-event-loss" in port
        assert "pio soak --seed 78" in port
    else:
        assert port == ""


def test_http_session_reuses_and_replaces_connections():
    """The driver's keep-alive client: one connection for back-to-back
    requests, a fresh one after the server closed it, and a connection
    error (never an HTTP code) when nobody listens."""
    import http.server
    import socket
    import threading

    seen = []

    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):  # noqa: N802
            n = int(self.headers["Content-Length"])
            body = json.loads(self.rfile.read(n))
            seen.append((self.client_address[1], body))
            out = json.dumps({"ok": body}).encode()
            self.send_response(201)
            self.send_header("Content-Length", str(len(out)))
            if body.get("close"):
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    sess = soak._Session(base)
    try:
        r1 = sess.post(base + "/e?k=1", json={"a": 1})
        r2 = sess.post(base + "/e", json={"a": 2, "close": True})
        r3 = sess.post(base + "/e", json={"a": 3})
        assert (r1.status_code, r1.json()) == (201, {"ok": {"a": 1}})
        assert r3.json() == {"ok": {"a": 3}}
        assert r2.text.startswith("{")
        assert seen[0][0] == seen[1][0] != seen[2][0]
    finally:
        sess.close()
        srv.shutdown()
        srv.server_close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    with pytest.raises(soak._ConnError):
        soak._Session(f"http://127.0.0.1:{dead}").post(
            f"http://127.0.0.1:{dead}/x", json={}, timeout=2)


# ---------------------------------------------------------------------------
# the real topology, scaled down (slow, as the reference's)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_smoke_soak_scaled_down_topology_on_the_cpu(tmp_path, monkeypatch):
    """The reference smoke test's scenario (tests/test_soak.py:734-769) on
    the port: a partitioned event server with one worker and a single
    engine process with refresh and fold-in, under mixed zipfian load, a
    scheduled ENOSPC, a poisoned fold-in increment and a worker SIGKILL
    mid-commit; every SLO asserted, the scorecard persisted, the ledger
    reconciled. Every process runs with --device cpu."""
    monkeypatch.chdir(os.path.dirname(HERE))
    cfg = soak.SoakConfig(
        engine_dir=_template(tmp_path), workdir=str(tmp_path / "wd"),
        seed=42, duration_s=14.0, event_workers=1, replicas=0, apps=2,
        ingest_rps=12.0, query_rps=6.0,
        faults=("enospc_shed", "poison_foldin", "worker_kill"),
        foldin_ms=150.0, refresh_ms=400.0, swap_watch_ms=1500.0,
        rollback_deadline_s=25.0, freshness_settle_s=15.0,
        out_path=str(tmp_path / "SOAK.json"), device="cpu")
    scorecard = soak.run_soak(soak.plan_scenario(cfg))
    assert scorecard["verdict"] == "PASS", json.dumps(
        {"slos": scorecard["slos"], "faults": scorecard["faults"],
         "traffic": scorecard["traffic"],
         "planNotes": scorecard["planNotes"]}, indent=1, default=str)
    assert [f["name"] for f in scorecard["faults"]] == [
        "enospc_shed", "poison_foldin", "worker_kill"]
    assert all(f["fired"] and f["evidence"] for f in scorecard["faults"])
    t = scorecard["traffic"]
    assert t["acked"] > 50 and t["acceptedQueries"] > 20
    assert scorecard["reconciliation"]["ackedEvents"] == t["acked"]
    assert scorecard["topology"]["device"] == "cpu"
    assert [tr["label"] for tr in scorecard["trains"]] == ["initial"]
    on_disk = soak.read_scorecard(str(tmp_path / "SOAK.json"))
    assert on_disk and on_disk["verdict"] == "PASS"
    assert not (tmp_path / "wd").exists()


def _run(cfg):
    scorecard = soak.run_soak(soak.plan_scenario(cfg))
    assert scorecard["verdict"] == "PASS", json.dumps(
        {"slos": scorecard["slos"], "faults": scorecard["faults"],
         "traffic": scorecard["traffic"],
         "planNotes": scorecard["planNotes"]}, indent=1, default=str)
    return scorecard


@pytest.mark.slow
@pytest.mark.multitenant
@pytest.mark.parametrize("foldin_ms", [1200.0, 250.0],
                         ids=["foldin-1200ms", "foldin-250ms"])
def test_multitenant_soak_per_tenant_slo_rows(tmp_path, monkeypatch,
                                              foldin_ms):
    """The reference's multi-tenant soak (tests/test_soak.py:773-809) on
    the port: one mux-armed engine process serves the whole app universe,
    per-app instances trained up front, zipfian X-Pio-App traffic after a
    guaranteed-coverage sweep, the resident LRU churning below the app
    count, and a poisoned fold-in rolled back while every tenant's
    availability row stays green. The reference runs the fold-in at
    1,200 ms, slower than its one-step watch can trip; the second case
    runs it at the default 250 ms, where increments land inside each
    other's watch windows and the chain rule has to hold."""
    monkeypatch.chdir(os.path.dirname(HERE))
    cfg = soak.SoakConfig(
        engine_dir=_template(tmp_path), workdir=str(tmp_path / "wd"),
        seed=45, duration_s=16.0, event_workers=1, replicas=0,
        apps=2, tenant_apps=5, ingest_rps=12.0, query_rps=12.0,
        faults=("enospc_shed", "poison_foldin"),
        quality_sample=0.0,
        foldin_ms=foldin_ms, refresh_ms=300.0, swap_watch_ms=2500.0,
        rollback_deadline_s=25.0, freshness_settle_s=15.0,
        out_path=str(tmp_path / "SOAK.json"), device="cpu")
    scorecard = _run(cfg)
    assert scorecard["topology"]["tenantApps"] == 5
    assert scorecard["topology"]["tenantMaxResident"] == 2
    row = next(s for s in scorecard["slos"]
               if s["name"] == "tenant-isolation")
    per = row["value"]["perTenant"]
    assert len(per) == 5
    assert all(r["offered"] >= 1 and r["accepted"] >= 1 for r in per)
    # the LRU actually churned: 4 mux tenants through 2 resident slots
    assert (row["value"]["evictions"] or 0) >= 1
    # the scorecard keeps the scraped tenants table for post-mortems
    assert scorecard["tenants"]["maxResident"] == 2


@pytest.mark.slow
def test_headline_soak_full_menu_fleet_topology(tmp_path, monkeypatch):
    """The reference's headline soak (tests/test_soak.py:812-830) on the
    port: 2 fenced event workers and a 2-replica engine fleet with staged
    canary and fold-in producer, the full fault menu (replica SIGKILL
    mid-flood, compaction crash, poisoned retrain under a deploy freeze,
    a poisoned fold-in and a quality poison among them): a green
    scorecard, no acknowledged event lost, the rollback windows held."""
    monkeypatch.chdir(os.path.dirname(HERE))
    cfg = soak.SoakConfig(
        engine_dir=_template(tmp_path), workdir=str(tmp_path / "wd"),
        seed=20260804, duration_s=70.0, event_workers=2, replicas=2,
        apps=3, ingest_rps=40.0, query_rps=16.0,
        foldin_ms=250.0, swap_watch_ms=2500.0, fleet_sync_ms=200.0,
        rollback_deadline_s=30.0, freshness_settle_s=20.0,
        out_path=str(tmp_path / "SOAK.json"), device="cpu")
    scorecard = _run(cfg)
    fired = [f["name"] for f in scorecard["faults"] if f["fired"]]
    assert len(fired) >= 5 and set(fired) == set(soak.FAULT_MENU)
    assert scorecard["traffic"]["acked"] > 500
