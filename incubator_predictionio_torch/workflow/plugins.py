"""Engine/Event server plugin interfaces.

The port's own copy of ``incubator_predictionio_tpu/workflow/plugins.py``
(reference: core/.../workflow/EngineServerPlugin.scala, the outputblocker
and outputsniffer hooks, and data/.../data/api/EventServerPlugin.scala).
Plugins are registered explicitly or named by dotted paths in
``PIO_ENGINE_SERVER_PLUGINS`` / ``PIO_EVENT_SERVER_PLUGINS`` (comma
separated). The engine server runs :class:`EngineServerPluginContext`;
the event server's group commit calls :class:`EventServerPluginContext`
for every committed event.
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Optional

from ..common import envknobs

log = logging.getLogger("pio.torch.plugins")


class EngineServerPlugin:
    """Hooks around the query path. ``process`` may transform the result
    (outputblocker role); ``sniff`` observes (outputsniffer role)."""

    name: str = "plugin"

    def start(self, context: "EngineServerPluginContext") -> None:
        pass

    def before_query(self, query: Any) -> Any:
        return query

    def process(self, query: Any, result: Any) -> Any:
        return result


class EventServerPlugin:
    name: str = "plugin"

    def on_event(self, event_json: dict) -> None:
        pass


def _from_env(var: str, kind: str) -> list:
    """Instances of the classes that ``var`` names (a bad entry is logged
    and skipped)."""
    out = []
    for dotted in filter(None, envknobs.env_str(var, "", lower=False)
                         .split(",")):
        try:
            module, _, cls = dotted.strip().rpartition(".")
            out.append(getattr(importlib.import_module(module), cls)())
        except Exception:  # noqa: BLE001 - a bad env entry
            log.exception("failed to load %s plugin %s", kind, dotted)
    return out


class EventServerPluginContext:
    """Reference: EventServerPluginContext — plugins observing ingested
    events: an explicit list or dotted paths in
    ``PIO_EVENT_SERVER_PLUGINS``."""

    def __init__(self, plugins: Optional[list[EventServerPlugin]] = None):
        self.plugins = list(plugins or [])
        self.plugins += _from_env("PIO_EVENT_SERVER_PLUGINS", "event server")

    def plugin_names(self) -> list[str]:
        return [p.name for p in self.plugins]

    def on_event(self, event_json: dict) -> None:
        for p in self.plugins:
            try:
                p.on_event(event_json)
            except Exception:  # noqa: BLE001 - never break ingestion
                log.exception("event server plugin %s failed", p.name)


class EngineServerPluginContext:
    def __init__(self, plugins: Optional[list[EngineServerPlugin]] = None):
        self.plugins = list(plugins or [])
        self.plugins += _from_env("PIO_ENGINE_SERVER_PLUGINS", "engine server")
        for p in self.plugins:
            p.start(self)

    def plugin_names(self) -> list[str]:
        return [p.name for p in self.plugins]

    def before_query(self, query: Any) -> Any:
        for p in self.plugins:
            query = p.before_query(query)
        return query

    def after_query(self, query: Any, result: Any) -> Any:
        for p in self.plugins:
            result = p.process(query, result)
        return result
