"""The gang's mesh: a data axis, and for the slab trainer a model axis.

What the gang trainers need of ``incubator_predictionio_tpu/parallel/
mesh.py``: each rank of a gang drives one device, ``PIO_MESH_SHAPE`` is
parsed as there ("D" or "DxM"), and :func:`pad_rows` pads a row count to a
multiple of the axis.

- The data-parallel trainer's mesh is the data axis alone (its size the
  world size): :func:`data_axis_size` refuses a shape that names a model
  axis, as the reference's ``_make_dp_train_fn`` does.
- The serving mesh (:func:`default_mesh`, the reference's
  ``default_mesh``) is an explicit list of torch devices, one catalog
  shard per entry (``ops/sharded_topk.py``): every visible card by
  default. A caller may name a device more than once (``["cuda:0"] * 4``,
  ``["cpu"] * 8``).
- The slab trainer's mesh is ``(d, m)`` with ``d·m`` = the world size
  (:func:`mesh_dims`): rank ``r`` sits at ``(r // m, r % m)``
  (:func:`mesh_coords`), the reference's row-major device order of
  ``mesh_from_devices``. :func:`mesh_groups` gives this rank's two gloo
  subgroups: the ``m`` ranks of its data row (the model group, over which
  the 2-D ALX layout sums its partial grams) and the ``d`` ranks of its
  model column (the data group).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..common import envknobs
from .distributed import process_count, process_index

__all__ = ["data_axis_size", "default_mesh", "local_device_count",
           "mesh_coords", "mesh_dims", "mesh_groups", "mesh_shape_from_env",
           "pad_rows"]


def default_mesh(device="cuda") -> list:
    """The serving mesh of a model on ``device``: every visible card for a
    CUDA device, else ``[device]`` (the CPU is one device)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


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


def mesh_dims(world: Optional[int] = None) -> tuple[int, int]:
    """``(d, m)`` of the slab trainer's mesh over ``world`` ranks (default:
    this gang's), one device each: ``(world, 1)`` without
    ``PIO_MESH_SHAPE``; a shape whose product is not the world raises."""
    world = (process_count() if world is None else int(world)) \
        * local_device_count()
    shape = mesh_shape_from_env()
    if shape is None:
        return world, 1
    d, m = (shape + (1,))[:2]
    if d * m != world:
        raise ValueError(
            f"PIO_MESH_SHAPE={'x'.join(map(str, shape))} names {d * m} "
            f"devices but the gang has {world} (one device per rank): "
            "the shape's product must be the number of workers")
    return d, m


def mesh_coords(rank: Optional[int] = None,
                dims: Optional[tuple[int, int]] = None) -> tuple[int, int]:
    """``(di, mi)`` of ``rank`` (default: this process's) on a ``(d, m)``
    mesh: row-major, as the reference orders its devices."""
    rank = process_index() if rank is None else int(rank)
    m = (dims or mesh_dims())[1]
    return rank // m, rank % m


#: (d, m) → (model group, data group) of this process: gloo subgroups are
#: made once per process and shape (every rank makes every group)
_GROUPS: dict = {}


def mesh_groups(dims: tuple[int, int]) -> tuple:
    """This rank's ``(model_group, data_group)`` on a ``(d, m)`` mesh: the
    ranks of its data row and of its model column, as gloo subgroups
    (``None`` for a group of one rank: nothing to exchange). Collective:
    every rank makes every group, rows first, in the same order, or the
    groups' rendezvous hangs."""
    d, m = dims
    if process_count() <= 1:
        return None, None
    if dims not in _GROUPS:
        import torch.distributed as dist

        di, mi = mesh_coords(dims=dims)
        model = data = None
        if m > 1:
            for row in range(d):
                g = dist.new_group([row * m + j for j in range(m)],
                                   backend="gloo")
                if row == di:
                    model = g
        if d > 1:
            for col in range(m):
                g = dist.new_group([j * m + col for j in range(d)],
                                   backend="gloo")
                if col == mi:
                    data = g
        _GROUPS[dims] = (model, data)
    return _GROUPS[dims]


def pad_rows(x: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """Pad dim 0 up to a multiple of ``multiple``."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    pad_width = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)
