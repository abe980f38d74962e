"""Storage layer: the event, metadata and model repositories.

The port's own copy of ``incubator_predictionio_tpu/data/storage`` with the
embedded backends (SQLITE, the default; MEMORY; LOCALFS for models; JSONL
for events).
"""

from .base import (
    AccessKey,
    AccessKeys,
    App,
    Apps,
    BaseStorageClient,
    Channel,
    Channels,
    EngineInstance,
    EngineInstances,
    EvaluationInstance,
    EvaluationInstances,
    LEvents,
    Model,
    Models,
    PEvents,
    StorageClientConfig,
    aggregate_property_events,
)
from .datamap import DataMap, DataMapError, PropertyMap
from .event import (
    SPECIAL_EVENTS,
    Event,
    EventValidationError,
    format_event_time,
    new_event_id,
    parse_event_time,
    validate_event,
)
from .registry import Storage, StorageError, base_dir

__all__ = [
    "AccessKey", "AccessKeys", "App", "Apps", "BaseStorageClient",
    "Channel", "Channels", "DataMap", "DataMapError", "EngineInstance",
    "EngineInstances", "EvaluationInstance", "EvaluationInstances", "Event",
    "EventValidationError", "LEvents", "Model", "Models", "PEvents",
    "PropertyMap", "SPECIAL_EVENTS", "Storage", "StorageClientConfig",
    "StorageError", "aggregate_property_events", "base_dir",
    "format_event_time", "new_event_id", "parse_event_time",
    "validate_event",
]
