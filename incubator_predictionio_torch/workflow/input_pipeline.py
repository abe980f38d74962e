"""Background prefetch of host work items.

What the partition feed needs of
``incubator_predictionio_tpu/workflow/input_pipeline.py``:
:class:`PipelineConfig` from its ``PIO_PIPELINE*`` knobs and
:func:`prefetch`, which computes ``fn(item)`` on worker threads ahead of
the consumer (``workflow/train_feed.py`` overlaps the scan of shard N+1
with the extraction of shard N; the native codec's parse releases the
GIL). The streaming host → device ring of the reference waits for the
port's pipelined trainers.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Any, Callable, Iterable, Iterator, Optional

from ..common import envknobs

__all__ = ["PipelineConfig", "PipelineWorkerError", "prefetch"]

DEFAULT_DEPTH = 2
DEFAULT_WORKERS = 2


class PipelineWorkerError(RuntimeError):
    """A prefetch worker raised; the original exception is __cause__."""


def _env_int(name: str, default: int, lo: int = 1, hi: int = 1 << 30) -> int:
    return min(hi, envknobs.env_int(name, default, lo=lo))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Resolved knobs (the reference's chunk sizes belong to its streaming
    ring and are not read here). ``mode`` ∈ {'auto', 'on', 'off'}: ``off``
    reads every shard in the calling thread."""

    mode: str = "auto"
    depth: int = DEFAULT_DEPTH
    workers: int = DEFAULT_WORKERS

    @classmethod
    def from_env(cls, mode: Optional[str] = None) -> "PipelineConfig":
        raw = (mode or envknobs.env_str("PIO_PIPELINE", "auto")).strip().lower()
        if raw in ("1", "on", "true", "yes"):
            raw = "on"
        elif raw in ("0", "off", "false", "no"):
            raw = "off"
        elif raw != "auto":
            warnings.warn(
                f"PIO_PIPELINE={raw!r}: expected auto/on/off; using auto",
                stacklevel=2)
            raw = "auto"
        return cls(
            mode=raw,
            depth=_env_int("PIO_PIPELINE_DEPTH", DEFAULT_DEPTH, lo=1, hi=64),
            workers=_env_int("PIO_PIPELINE_WORKERS", DEFAULT_WORKERS,
                             lo=1, hi=64),
        )


def prefetch(items: Iterable[Any], fn: Callable[[Any], Any],
             workers: int = DEFAULT_WORKERS,
             lookahead: int = DEFAULT_DEPTH) -> Iterator[Any]:
    """Yield ``fn(item)`` in order, computed by background threads.

    At most ``lookahead`` results are completed-or-running ahead of the
    consumer (a slow consumer stalls the workers instead of piling up
    results). A worker exception is re-raised at its yield point as
    :class:`PipelineWorkerError` (original as ``__cause__``) and the rest
    of the work is cancelled. Closing the generator mid-stream cancels
    pending work and joins the pool."""
    from concurrent.futures import ThreadPoolExecutor

    items = iter(items)
    bound = max(1, int(lookahead))
    pool = ThreadPoolExecutor(max_workers=max(1, int(workers)),
                              thread_name_prefix="pio-prefetch")
    pending: collections.deque = collections.deque()
    try:
        exhausted = False
        while True:
            while not exhausted and len(pending) < bound:
                try:
                    item = next(items)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(pool.submit(fn, item))
            if not pending:
                break
            fut = pending.popleft()
            try:
                result = fut.result()
            except Exception as e:  # noqa: BLE001 - re-raised with context
                raise PipelineWorkerError(
                    f"prefetch worker failed: {e}") from e
            yield result
    finally:
        for fut in pending:
            fut.cancel()
        pool.shutdown(wait=True, cancel_futures=True)
