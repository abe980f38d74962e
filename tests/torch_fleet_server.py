"""One fleet replica of the port for the fleet tests (the port's copy of
tests/fleet_server.py): no JAX, the port's lifecycle engine
(tests/torch_serving.py) on the CPU.

Spawned by the fleet supervisor (through tests/torch_fleet_front.py): its
identity, listen port, heartbeat file and fleet knobs arrive in the
environment, as `pio deploy --replica-worker` receives them. The
``fleet.spawn`` fault point fires before the engine loads.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s %(message)s")
    from incubator_predictionio_torch.workflow.fleet import (
        replica_worker_entry,
    )

    port = replica_worker_entry()
    if port <= 0:
        return 1
    import torch_serving

    from incubator_predictionio_torch.data.storage import Storage
    from incubator_predictionio_torch.workflow.create_server import (
        EngineServer, run_engine_server,
    )

    server = EngineServer(torch_serving.lifecycle_engine(),
                          engine_factory_name="lifecycle",
                          storage=Storage.instance(), device="cpu")
    run_engine_server(server, "127.0.0.1", port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
