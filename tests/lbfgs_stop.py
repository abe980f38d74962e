"""The reference L-BFGS's iteration count, for the tests that hold the
port's count to it (``tests/test_torch_linear*.py``,
``tests/test_torch_input_pipeline.py``).

The count is the least ``max_iters`` whose fit equals the uncapped fit bit
for bit: where the reference stops by its rule (``incubator_predictionio_
tpu/ops/linear.py`` ``_lr_fit`` :586-587), and where it stalls (its float32
line search no longer moves the parameters), the step after which it
does not move. That reading needs fits that repeat bit for bit. In a test
process they do not: XLA runs the fit over eight virtual CPU devices on a
thread pool, and under load the float32 sums come out in another order, so
two fits of the same data differ in their last bits and can take other
trajectories (one stalls above the gradient-norm stop where another meets
it). So the fits run here in a child process with one CPU device, XLA's
CPU threading pinned to one thread and the process to one core: its count
is the same in every run.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys
os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from incubator_predictionio_tpu.ops import linear as ref
from incubator_predictionio_tpu.workflow.input_pipeline import PipelineConfig

args = json.loads(sys.argv[2])
data = np.load(sys.argv[1])
x, y = data["x"], data["y"]
cfg = PipelineConfig(**args["pipeline"])


def fit(k):
    m = ref.train_logistic_regression(x, y, args["c"], reg=args["reg"],
                                      max_iters=k, pipeline=cfg)
    return m.weights, m.intercept


cap = args["max_iters"]
full = fit(cap)
stop = next((k for k in range(1, cap)
             if all(np.array_equal(a, b) for a, b in zip(fit(k), full))),
            None)
print(json.dumps({"stop": stop}))
"""


def ref_stop(x, y, n_classes: int, reg: float, pipeline=None,
             max_iters: int = 100, timeout_s: float = 120.0):
    """The reference's iteration count on (x, y) (None when it moves at
    every one of its ``max_iters`` steps), read in a pinned child process.
    ``pipeline``: the reference ``PipelineConfig``'s fields (default
    ``mode="off"``)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    args = {"c": int(n_classes), "reg": float(reg),
            "max_iters": int(max_iters),
            "pipeline": dict(pipeline or {"mode": "off"})}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "xy.npz")
        np.savez(path, x=np.asarray(x, np.float32),
                 y=np.asarray(y, np.int32))
        out = subprocess.run([sys.executable, "-c", _CHILD, path,
                              json.dumps(args)], env=env, cwd=ROOT,
                             capture_output=True, text=True,
                             timeout=timeout_s)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])["stop"]
