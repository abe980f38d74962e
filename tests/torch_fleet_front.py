"""The fleet front of the port's fleet tests (the port's copy of
tests/fleet_front.py): the port's `run_fleet` (supervisor, splice front,
readiness poller, staged-rollout coordinator) over
tests/torch_fleet_server.py replicas.

Usage: python torch_fleet_front.py <port> <replicas> [elastic]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s %(message)s")
    port = int(sys.argv[1])
    replicas = int(sys.argv[2])
    from incubator_predictionio_torch.workflow.fleet import run_fleet

    elastic = len(sys.argv) > 3 and sys.argv[3] == "elastic"
    worker_argv = [sys.executable, os.path.join(HERE, "torch_fleet_server.py")]
    return run_fleet(worker_argv, replicas, "127.0.0.1", port,
                     engine_factory_name="lifecycle",
                     engine_variant="default", elastic=elastic)


if __name__ == "__main__":
    raise SystemExit(main())
