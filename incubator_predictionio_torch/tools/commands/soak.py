"""`pio soak`: the "production day" scenario driver.

Port of ``incubator_predictionio_tpu/tools/commands/soak.py``. Launches
the real topology (partitioned event server + engine fleet) as
subprocesses of the port's console, floods it with zipfian multi-app
traffic while a seeded fault timeline fires, and grades the run against
end-to-end SLOs (``workflow/soak.py``). ``--device`` (the card unless
``cpu`` is asked for) goes to every train and deploy it spawns.
``--dry-run`` prints the resolved scenario (topology, fault timeline, SLO
thresholds) without launching anything, so an operator can read exactly
what a seed will do before spending the wall budget. The driver process
imports neither torch nor jax: ``tools/console.py`` dispatches this verb
first."""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from . import verb


def _parse_faults(text: str):
    from ...workflow.soak import FAULT_MENU

    if text == "full":
        return FAULT_MENU
    if text == "none":
        return ()
    return tuple(t.strip() for t in text.split(",") if t.strip())


@verb("soak", "production-day soak: real topology, zipfian load, "
              "fault timeline, end-to-end SLOs")
def soak_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio soak")
    p.add_argument("--engine-dir", default=".",
                   help="template directory (with engine.json); "
                        "trains + deploys ride the normal CLI paths")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where every spawned train and deploy runs: the "
                        "card (default) or, only when asked, the CPU")
    p.add_argument("--seed", type=int, default=20260804,
                   help="ONE seed drives the zipfian generators AND "
                        "the fault timeline — a red soak replays")
    p.add_argument("--duration-s", type=float, default=60.0)
    p.add_argument("--event-workers", type=int, default=2)
    p.add_argument("--replicas", type=int, default=2,
                   help="engine fleet size (0 = single process with "
                        "--model-refresh-ms)")
    p.add_argument("--elastic", action="store_true",
                   help="deploy the engine fleet with --replicas auto "
                        "and arm the RAMP phase: offered query load "
                        "steps 10x up (~30%% of the wall budget) and "
                        "back down (~65%%), grading scale-up-within-"
                        "bound and drain-on-quiet SLO rows")
    p.add_argument("--elastic-max", type=int, default=3,
                   help="PIO_FLEET_MAX_REPLICAS for --elastic "
                        "(floor is 1)")
    p.add_argument("--scale-up-bound-s", type=float, default=30.0,
                   help="scale-up-within-bound SLO bound: a replica "
                        "beyond the floor must be READY this soon "
                        "after the load step")
    p.add_argument("--scale-down-bound-s", type=float, default=45.0,
                   help="drain-on-quiet SLO bound: fleet back at the "
                        "floor this soon after the step-down")
    p.add_argument("--apps", type=int, default=3)
    p.add_argument("--ingest-rps", type=float, default=50.0)
    p.add_argument("--query-rps", type=float, default=20.0)
    p.add_argument("--faults", default="full",
                   help="'full', 'none', or a comma list from the "
                        "menu: enospc_shed, poison_foldin, "
                        "worker_kill, replica_kill, good_retrain, "
                        "compact_crash, poison_retrain, "
                        "poison_quality")
    p.add_argument("--quality-sample", type=float, default=1.0,
                   help="shadow-scorer sampling rate armed on the "
                        "deployed engine (0 disables the quality "
                        "vertical; the quality-regression SLO row "
                        "then only asserts the rollback leg)")
    p.add_argument("--catalog-items", type=int, default=None,
                   help="item universe the floods rate against "
                        "(default 50; raise it for a large-catalog "
                        "scenario — the zipf head keeps the quality "
                        "signal, and catalogs past the host-shard "
                        "threshold serve through the sharded path)")
    p.add_argument("--tenant-apps", type=int, default=0, metavar="N",
                   help="arm the multi-tenant serving scenario: "
                        "serve N apps through ONE engine process "
                        "behind the tenant mux (zipfian per-tenant "
                        "traffic, per-tenant SLO rows); 0 keeps the "
                        "classic single-app topology")
    p.add_argument("--tenant-max-resident", type=int, default=0,
                   metavar="N",
                   help="resident-model LRU bound for --tenant-apps "
                        "(default: half the app count, min 2 — below "
                        "the app count so the soak observes evictions)")
    p.add_argument("--query-cache", type=int, default=None, metavar="N",
                   help="served-result cache entries per engine "
                        "process (default 256; 0 disables the cache "
                        "and the cache-freshness SLO row reports it)")
    p.add_argument("--p99-ms", type=float, default=4000.0)
    p.add_argument("--rollback-deadline-s", type=float, default=30.0)
    p.add_argument("--foldin-ms", type=float, default=250.0)
    p.add_argument("--watch-ms", type=float, default=2500.0)
    p.add_argument("--out", default=None,
                   help="scorecard path (default ./SOAK.json)")
    p.add_argument("--baseline-key", default=None, metavar="KEY",
                   help="also publish a measured_soak_<KEY> summary "
                        "row into BASELINE.json next to the scorecard")
    p.add_argument("--workdir", default=None,
                   help="scenario workspace (default: a temp dir, "
                        "removed unless --keep-workdir; an explicit "
                        "workdir is ALWAYS kept — the driver never "
                        "rmtrees a directory the operator named)")
    p.add_argument("--keep-workdir", action="store_true")
    p.add_argument("--dry-run", action="store_true",
                   help="print the resolved scenario plan and exit "
                        "without launching anything")
    ns = p.parse_args(args)

    from ...workflow.soak import SoakConfig, plan_scenario, run_soak

    # --dry-run never touches the workspace: only reserve a temp dir
    # when a real run will use (and clean up) the directory
    if ns.workdir:
        workdir = ns.workdir
    elif ns.dry_run:
        workdir = os.path.join(tempfile.gettempdir(), "pio_soak_dry")
    else:
        workdir = tempfile.mkdtemp(prefix="pio_soak_")
    serving_kw = {}
    if ns.catalog_items is not None:
        serving_kw["catalog_items"] = max(1, ns.catalog_items)
    if ns.query_cache is not None:
        serving_kw["query_cache_size"] = max(0, ns.query_cache)
    cfg = SoakConfig(
        engine_dir=os.path.abspath(ns.engine_dir),
        workdir=workdir,
        seed=ns.seed,
        duration_s=ns.duration_s,
        event_workers=max(1, ns.event_workers),
        replicas=max(0, ns.replicas),
        apps=max(1, ns.apps),
        ingest_rps=ns.ingest_rps,
        query_rps=ns.query_rps,
        faults=_parse_faults(ns.faults),
        quality_sample=max(0.0, min(1.0, ns.quality_sample)),
        tenant_apps=max(0, ns.tenant_apps),
        tenant_max_resident=max(0, ns.tenant_max_resident),
        elastic=ns.elastic,
        elastic_max=max(2, ns.elastic_max),
        scale_up_bound_s=ns.scale_up_bound_s,
        scale_down_bound_s=ns.scale_down_bound_s,
        p99_ms=ns.p99_ms,
        rollback_deadline_s=ns.rollback_deadline_s,
        foldin_ms=ns.foldin_ms,
        swap_watch_ms=ns.watch_ms,
        keep_workdir=ns.keep_workdir or bool(ns.workdir),
        out_path=os.path.abspath(ns.out) if ns.out else None,
        baseline_key=ns.baseline_key,
        device=ns.device,
        **serving_kw,
    )
    plan = plan_scenario(cfg)
    if ns.dry_run:
        print(plan.describe())
        print("(dry run: nothing launched)")
        return 0
    print(f"[info] soak workspace: {workdir} (device {ns.device})")
    try:
        scorecard = run_soak(plan, progress=lambda s: print(
            "\n".join(f"[info] {ln}" for ln in s.splitlines())))
    except Exception as e:  # noqa: BLE001 — operator-facing
        print(f"[error] soak run failed before grading: {e}",
              file=sys.stderr)
        return 2
    ok = scorecard["verdict"] == "PASS"
    marker = "[info]" if ok else "[warn]"
    for s in scorecard["slos"]:
        m = "[info]" if s["ok"] else "[warn]"
        print(f"{m}   SLO {s['name']}: "
              f"{'ok' if s['ok'] else 'VIOLATED'} "
              f"(value {s['value']}, bound {s['bound']})")
    fired = sum(1 for f in scorecard["faults"] if f.get("fired"))
    print(f"{marker} Soak {scorecard['verdict']}: {fired} fault(s) "
          f"injected over {scorecard['wallS']:.0f}s, seed "
          f"{scorecard['seed']} (replay with --seed)")
    return 0 if ok else 1
