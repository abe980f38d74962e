"""Connector contracts (reference: webhooks/{JsonConnector,FormConnector}.scala)."""

from __future__ import annotations

from typing import Any, Mapping


class ConnectorError(ValueError):
    pass


class JsonConnector:
    """JSON POST → PredictionIO event JSON."""

    def to_event_json(self, payload: Mapping[str, Any]) -> dict:
        raise NotImplementedError


class FormConnector:
    """Form-encoded POST → PredictionIO event JSON."""

    def to_event_json(self, payload: Mapping[str, str]) -> dict:
        raise NotImplementedError
