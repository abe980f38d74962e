"""What a train or deploy run hands its DASE components."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import torch

from ..device import resolve_device
from .workflow_params import WorkflowParams


@dataclasses.dataclass
class WorkflowContext:
    """``events``: the wire-format events a data source reads (the port's
    stand-in for the event store); ``device``: where models train and
    serve — the card unless the caller asks for the CPU.

    The rest has the reference context's names, so algorithms read them as
    there: ``workflow_params`` (set by ``Engine.train``), ``checkpoint_hook``
    (a :class:`..workflow.checkpoint.CheckpointHook` when snapshots are on;
    ``Engine.train`` scopes it per algorithm), ``stage_label`` (the stage
    the NaN guard names) and ``bench_timings`` (a dict a benchmark plants
    to receive ``train_als``'s phase times; None in normal training).
    """

    events: Optional[Sequence[Mapping]] = None
    device: "str | torch.device" = "cuda"
    workflow_params: WorkflowParams = dataclasses.field(
        default_factory=WorkflowParams)
    checkpoint_hook: Any = None
    stage_label: str = "algorithm[als]"
    bench_timings: Optional[dict] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
