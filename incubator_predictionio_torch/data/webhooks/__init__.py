"""Webhook connectors — adapt third-party POSTs into Events.

Reference: data/.../data/webhooks/{JsonConnector,FormConnector,
ConnectorUtil}.scala + segmentio/mailchimp connectors. The port's own
copy of ``incubator_predictionio_tpu/data/webhooks/``; the event server
serves them at ``POST /webhooks/<connector>.json``.
"""

from __future__ import annotations

from typing import Optional

from .base import FormConnector, JsonConnector
from .segmentio import SegmentIOConnector
from .mailchimp import MailChimpConnector

_CONNECTORS = {
    "segmentio": SegmentIOConnector(),
    "mailchimp": MailChimpConnector(),
}


def get_connector(name: str):
    return _CONNECTORS.get(name)


def register_connector(name: str, connector) -> None:
    _CONNECTORS[name] = connector


__all__ = [
    "FormConnector", "JsonConnector", "MailChimpConnector",
    "SegmentIOConnector", "get_connector", "register_connector",
]
