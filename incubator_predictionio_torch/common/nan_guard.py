"""NaN guard: fail a train at the stage that produced non-finite values.

Port of ``incubator_predictionio_tpu/common/nan_guard.py`` (``NaNGuardError``,
``check_finite``): the same walk over dataclasses, dicts, lists and tuples,
the same messages. Torch tensors are checked where they live: a tensor on
the card is reduced there and one scalar is read back; its elements are
counted on the host only when the check fails. Enabled by
``console train --nan-guard`` (``WorkflowParams.nan_guard``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class NaNGuardError(RuntimeError):
    """A stage produced non-finite values (message carries the stage)."""


class _TooDeep(Exception):
    pass


def _iter_arrays(obj, _depth: int = 0):
    """Yield (path, array) for every numpy array or torch tensor reachable
    from obj. A container nested deeper than the cap raises instead of
    being skipped: an unverified subtree must not report as clean."""
    if obj is None:
        return
    if _depth > 6:
        if (isinstance(obj, (np.ndarray, np.generic, torch.Tensor, dict,
                             list, tuple))
                or (dataclasses.is_dataclass(obj) and not isinstance(obj, type))):
            raise _TooDeep
        return
    if isinstance(obj, torch.Tensor):
        yield "", obj
        return
    if isinstance(obj, (np.ndarray, np.generic)):
        # bare numpy scalars check as 0-d arrays
        yield "", np.asarray(obj)
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.name.startswith("_"):
                continue  # caches (device buffers, indexes): not model state
            for path, arr in _iter_arrays(getattr(obj, f.name), _depth + 1):
                yield f"{f.name}.{path}".rstrip("."), arr
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            for path, arr in _iter_arrays(v, _depth + 1):
                yield f"{k}.{path}".rstrip("."), arr
        return
    if isinstance(obj, (list, tuple)):
        for j, v in enumerate(obj):
            for path, arr in _iter_arrays(v, _depth + 1):
                yield f"[{j}].{path}".rstrip("."), arr


def _bad_count(arr) -> "int | None":
    """Non-finite elements of a float array or tensor, None when clean or
    not floating point."""
    if isinstance(arr, torch.Tensor):
        if not arr.is_floating_point() or arr.numel() == 0:
            return None
        with torch.no_grad():
            if bool(torch.isfinite(arr).all()):  # one scalar read back
                return None
            return int(arr.numel() - torch.isfinite(arr).sum().item())
    if arr.dtype.kind != "f" or not arr.size or np.isfinite(arr).all():
        return None
    return int(np.size(arr) - np.isfinite(arr).sum())


def check_finite(obj, stage: str) -> None:
    """Raise NaNGuardError naming ``stage`` and the offending field if any
    float array or tensor reachable from ``obj`` contains NaN/Inf."""
    try:
        for path, arr in _iter_arrays(obj):
            bad = _bad_count(arr)
            if bad is not None:
                size = arr.numel() if isinstance(arr, torch.Tensor) else arr.size
                raise NaNGuardError(
                    f"stage: {stage}: non-finite values in "
                    f"{path or 'array'} ({bad}/{size} elements); "
                    "rerun with --nan-guard off to persist anyway, or fix the "
                    "input data / regularization")
    except _TooDeep:
        raise NaNGuardError(
            f"stage: {stage}: object nests containers deeper than the "
            "guard traverses (6 levels) — cannot verify finiteness; "
            "flatten the model state or disable --nan-guard") from None
