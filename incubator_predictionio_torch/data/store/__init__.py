"""Engine-facing event read APIs (reference: data/.../data/store/)."""

from .l_event_store import LEventStore
from .p_event_store import EventBatch, PEventStore, ratings_matrix

__all__ = ["EventBatch", "LEventStore", "PEventStore", "ratings_matrix"]
