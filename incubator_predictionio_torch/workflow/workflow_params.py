"""WorkflowParams: the flags of one train run.

Port of ``incubator_predictionio_tpu/workflow/workflow_params.py`` with the
fields this package honors. The profiler and placement fields are not
ported (ROADMAP Queue 1, item 9; placement is not to port).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WorkflowParams:
    # free-form label stamped on the engine-instance row (``pio train --batch``)
    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    # snapshot algorithm state every N iterations (0: no snapshots);
    # ``resume`` continues from the latest snapshot
    checkpoint_every: int = 0
    resume: bool = False
    # check every stage's output for NaN/Inf with stage attribution;
    # iterative trainers run one iteration at a time to name the iteration
    nan_guard: bool = False
    # the streamed input pipeline (workflow/input_pipeline.py): "" defers
    # to PIO_PIPELINE (default auto), else auto/on/off for this run; the
    # 0 values defer to PIO_PIPELINE_{CHUNK,DEPTH,WORKERS} or the defaults
    pipeline: str = ""
    pipeline_chunk: int = 0
    pipeline_depth: int = 0
    pipeline_workers: int = 0
