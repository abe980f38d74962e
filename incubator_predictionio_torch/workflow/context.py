"""What a train or deploy run hands its DASE components."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import torch

from ..device import resolve_device
from .workflow_params import WorkflowParams


@dataclasses.dataclass
class WorkflowContext:
    """``device``: where models train and serve — the card unless the
    caller asks for the CPU.

    Where the data sources read: with ``events`` (wire-format event dicts,
    the file-based console's input) they read those; otherwise they read
    the event store, ``storage`` (a :class:`..data.storage.Storage`, else
    the process's ``Storage.instance()``), for the app ``app_name`` (the
    data-source params' ``appName`` wins) and channel ``channel_name``.

    The rest has the reference context's names, so algorithms read them as
    there: ``engine_instance_id`` (set by ``run_train`` and
    ``load_deployment``), ``workflow_params`` (set by ``Engine.train``),
    ``checkpoint_hook`` (a :class:`..workflow.checkpoint.CheckpointHook`
    when snapshots are on; ``Engine.train`` scopes it per algorithm),
    ``stage_label`` (the stage the NaN guard names) and ``bench_timings``
    (a dict a benchmark plants to receive ``train_als``'s phase times; None
    in normal training). ``read_timings``: a dict a caller plants to
    receive the data source's read (``read_seconds``, events → triple, and
    ``ratings_read``); None in normal training. ``input_pipeline``: the
    run's :class:`..workflow.input_pipeline.PipelineConfig`, resolved once
    by :meth:`get_input_pipeline`. ``mesh``: the serving mesh, a list of
    torch devices the ALS-family templates may split a large catalog over
    (``ops/sharded_topk.py``); :meth:`get_mesh` defaults it to every
    visible card (``parallel/mesh.py`` ``default_mesh``), or to the one
    device of a CPU context.
    """

    events: Optional[Sequence[Mapping]] = None
    device: "str | torch.device" = "cuda"
    app_name: str = ""
    channel_name: Optional[str] = None
    storage: Any = None
    engine_instance_id: Optional[str] = None
    workflow_params: WorkflowParams = dataclasses.field(
        default_factory=WorkflowParams)
    checkpoint_hook: Any = None
    stage_label: str = "algorithm[als]"
    bench_timings: Optional[dict] = None
    read_timings: Optional[dict] = None
    input_pipeline: Any = None
    mesh: Optional[Sequence] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def get_mesh(self) -> list:
        """The serving mesh as a list of torch devices (made once)."""
        if self.mesh is None:
            from ..parallel.mesh import default_mesh

            self.mesh = default_mesh(self.device)
        return [torch.device(d) for d in self.mesh]

    def record_read(self, seconds: float, ratings: int) -> None:
        """A data source's read (events → triple), into a planted
        ``read_timings``."""
        if self.read_timings is not None:
            self.read_timings["read_seconds"] = seconds
            self.read_timings["ratings_read"] = int(ratings)

    def get_input_pipeline(self):
        """The streaming configuration of this run, resolved once: the
        workflow params' fields win over the ``PIO_PIPELINE*`` environment,
        which wins over the defaults."""
        if self.input_pipeline is None:
            from .input_pipeline import PipelineConfig

            wp = self.workflow_params
            cfg = PipelineConfig.from_env(mode=wp.pipeline or None)
            over = {}
            if wp.pipeline_chunk > 0:
                over["chunk_rows"] = wp.pipeline_chunk
            if wp.pipeline_depth > 0:
                over["depth"] = wp.pipeline_depth
            if wp.pipeline_workers > 0:
                over["workers"] = wp.pipeline_workers
            self.input_pipeline = dataclasses.replace(cfg, **over)
        return self.input_pipeline

    def get_storage(self):
        if self.storage is None:
            from ..data.storage.registry import Storage

            return Storage.instance()
        return self.storage
