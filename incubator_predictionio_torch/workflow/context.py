"""What a train or deploy run hands its DASE components."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch

from ..device import resolve_device


@dataclasses.dataclass
class WorkflowContext:
    """``events``: the wire-format events a data source reads (the port's
    stand-in for the event store); ``device``: where models train and
    serve — the card unless the caller asks for the CPU."""

    events: Optional[Sequence[Mapping]] = None
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
