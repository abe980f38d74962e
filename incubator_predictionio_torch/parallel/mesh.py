"""The gang's data axis.

What the data-parallel trainer needs of
``incubator_predictionio_tpu/parallel/mesh.py``: each rank of a gang
drives one device, so the data axis is the gang (its size the world size),
``PIO_MESH_SHAPE`` is parsed as there ("D" or "DxM"), and :func:`pad_rows`
pads a row count to a multiple of the axis. The port has no model axis
yet (the 2-D ALX layout is ROADMAP Queue 1, item 7.6): a shape that names
one is refused by :func:`data_axis_size`, as the reference's
partition-local trainer refuses it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..common import envknobs
from .distributed import process_count

__all__ = ["data_axis_size", "local_device_count", "mesh_shape_from_env",
           "pad_rows"]


def local_device_count() -> int:
    """Devices one rank drives: always one (a card, or the CPU)."""
    return 1


def mesh_shape_from_env() -> Optional[tuple[int, ...]]:
    """``PIO_MESH_SHAPE``: "8" → a data axis of 8; "4x2" → (d, m) = (4, 2).
    Unset → None. Malformed raises."""
    spec = envknobs.env_str("PIO_MESH_SHAPE", "")
    if not spec:
        return None
    try:
        dims = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"PIO_MESH_SHAPE={spec!r}: expected D or DxM")
    if len(dims) > 2 or any(d < 1 for d in dims):
        raise ValueError(f"PIO_MESH_SHAPE={spec!r}: expected D or DxM")
    return dims


def data_axis_size() -> int:
    """The gang's data axis: world size × one device per rank. A
    ``PIO_MESH_SHAPE`` with a model axis, or whose data axis is not the
    gang, raises."""
    d = process_count() * local_device_count()
    shape = mesh_shape_from_env()
    if shape is None:
        return d
    if len(shape) == 2 and shape[1] != 1:
        raise ValueError(
            "partition-local training needs a 1-D data mesh (factor blocks "
            "shard over 'd'); unset PIO_MESH_SHAPE's model axis")
    if shape[0] != d:
        raise ValueError(
            f"PIO_MESH_SHAPE={shape}: the data axis is the gang, one device "
            f"per rank ({d} here)")
    return d


def pad_rows(x: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """Pad dim 0 up to a multiple of ``multiple``."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    pad_width = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)
