"""``train`` and ``deploy`` for the port.

    python -m incubator_predictionio_torch.tools.console train \\
        --engine-json engine.json --events events.jsonl --model-out model.npz \\
        [--device cpu]
    python -m incubator_predictionio_torch.tools.console deploy \\
        --model model.npz --port 8000 [--host 127.0.0.1] [--device cpu]

``train`` reads a JSON-lines events file (the ``pio import`` format), trains
the engine that engine.json names and writes the persisted models with the
engine.json beside them. ``deploy`` restores them and serves
``POST /queries.json`` until SIGTERM or Ctrl-C. Both run on the card unless
``--device cpu`` is given. The metadata and event stores and the rest of
the ``pio`` commands wait for a later slice.
"""

from __future__ import annotations

import argparse
import importlib
import json
import signal
import sys
import time

from ..controller import EngineParams
from ..data.events import read_events
from ..workflow.context import WorkflowContext
from ..workflow.create_server import EngineServer
from ..workflow.persist import load_models, save_models

_PACKAGE = "incubator_predictionio_torch."
_DEFAULT_FACTORY = _PACKAGE + "models.recommendation.RecommendationEngine"


def engine_from_json(engine_json: dict):
    """The Engine that engine.json's ``engineFactory`` names (a factory of
    this package; the Recommendation engine when absent)."""
    path = engine_json.get("engineFactory") or _DEFAULT_FACTORY
    if not path.startswith(_PACKAGE):
        raise ValueError(
            f"engineFactory {path!r} is not a factory of this package "
            f"(expected {_PACKAGE}...)")
    module, _, name = path.rpartition(".")
    factory = getattr(importlib.import_module(module), name)
    return factory()()


def train(engine_json: dict, events: list[dict], model_out: str,
          device: str = "cuda") -> float:
    """Train and persist; returns the training seconds."""
    engine = engine_from_json(engine_json)
    params = EngineParams.from_json(engine_json)
    ctx = WorkflowContext(events=events, device=device)
    t0 = time.perf_counter()
    models = engine.train(ctx, params)
    seconds = time.perf_counter() - t0
    _, _, algo_list, _ = engine.make_components(params)
    stored = [algo.prepare_model_for_persistence(m)
              for (_, algo), m in zip(algo_list, models)]
    save_models(model_out, engine_json, stored)
    return seconds


def load_deployment(model_path: str, device: str = "cuda"):
    """Restore persisted models into a live Deployment on ``device``."""
    engine_json, stored = load_models(model_path)
    engine = engine_from_json(engine_json)
    ctx = WorkflowContext(device=device)
    deployment = engine.prepare_deployment(
        ctx, EngineParams.from_json(engine_json), stored)
    for model in deployment.models:
        warm = getattr(model, "warm_up", None)
        if warm is not None:
            warm()
    return deployment, ctx


def _raise_exit(signum, frame):
    raise SystemExit(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m incubator_predictionio_torch.tools.console")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train an engine from an events file")
    t.add_argument("--engine-json", required=True)
    t.add_argument("--events", required=True, help="JSON-lines events file")
    t.add_argument("--model-out", required=True)
    t.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    d = sub.add_parser("deploy", help="serve a trained model over HTTP")
    d.add_argument("--model", required=True)
    d.add_argument("--host", default="127.0.0.1")
    d.add_argument("--port", type=int, default=8000)
    d.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.cmd == "train":
        with open(args.engine_json, encoding="utf-8") as fh:
            engine_json = json.load(fh)
        events = read_events(args.events)
        seconds = train(engine_json, events, args.model_out, args.device)
        print(json.dumps({"trained": args.model_out, "events": len(events),
                          "seconds": seconds, "device": args.device}),
              flush=True)
        return 0

    deployment, ctx = load_deployment(args.model, args.device)
    server = EngineServer(deployment, args.host, args.port,
                          info={"model": args.model, "device": str(ctx.device)})
    signal.signal(signal.SIGTERM, _raise_exit)
    host, port = server.address
    print(f"listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
