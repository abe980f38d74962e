"""The streamed host → device input pipeline.

Port of ``incubator_predictionio_tpu/workflow/input_pipeline.py``. A
trainer whose input is large enough overlaps three stages instead of
running them one after the other:

- **featurize**: :func:`prefetch` computes host chunks on worker threads
  (a slice of a feature matrix, a block of tokenized documents, the scan
  of a shard of the partition feed) ahead of the consumer;
- **upload**: :class:`DeviceRing` copies each chunk from pinned host
  buffers to the card on a side stream (``non_blocking=True``); the
  consume stream waits on the copy's event, and a pinned buffer is reused
  only after its copy's event has completed;
- **consume**: the per-chunk device work (a statistics pass, a copy into
  the resident matrix) runs for chunk N while chunk N+1 uploads and chunk
  N+2 featurizes.

:func:`run_pipeline` bounds the ring: before it uploads chunk N it waits
for the token of chunk N − depth (a ``torch.cuda.Event`` recorded after
that chunk's consume) and only then drops the chunk's device tensors, so
at most ``depth`` chunks are on the card at once beside the trainer's
accumulator (the reference bounds its ring at ``depth + 1``).

Knobs (environment; a workflow's params override them, see
``WorkflowContext.get_input_pipeline``):

- ``PIO_PIPELINE``: ``auto`` (default: stream on the card when the input
  is at least two chunks long), ``on``/``1`` (stream any input, on any
  device; the CPU tests use it), ``off``/``0`` (the single-shot path);
- ``PIO_PIPELINE_CHUNK``: rows (or COO entries) per chunk, 1,000,000;
- ``PIO_PIPELINE_CHUNK_DOCS``: documents per tokenizer chunk, 16,384;
- ``PIO_PIPELINE_DEPTH``: the ring's depth, 2;
- ``PIO_PIPELINE_WORKERS``: featurize threads, 2.

A rank of a training gang never streams (the reference's rule for a
multi-process run). The last streamed run's decomposition goes to the
process registry (``pio_pipeline_stage_seconds{stage}``,
``pio_pipeline_chunks``, ``pio_pipeline_overlap_efficiency``) and, through
:class:`PipelineStats`, into the train report's ``timings.pipeline``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from ..common import envknobs, telemetry

__all__ = ["DeviceRing", "PipelineConfig", "PipelineStats",
           "PipelineWorkerError", "chunk_ranges", "pipeline_of", "prefetch",
           "run_pipeline", "stats_into"]

DEFAULT_CHUNK_ROWS = 1_000_000
DEFAULT_CHUNK_DOCS = 16_384
DEFAULT_DEPTH = 2
DEFAULT_WORKERS = 2


class PipelineWorkerError(RuntimeError):
    """A prefetch worker raised; the original exception is __cause__."""


def _env_int(name: str, default: int, lo: int = 1, hi: int = 1 << 30) -> int:
    return min(hi, envknobs.env_int(name, default, lo=lo))


def pipeline_of(ctx) -> Optional["PipelineConfig"]:
    """The run's streaming configuration from a workflow context (None
    when the context has none: the trainer then reads the environment)."""
    getter = getattr(ctx, "get_input_pipeline", None) if ctx else None
    return getter() if callable(getter) else None


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Resolved knobs. ``mode`` ∈ {'auto', 'on', 'off'}; ``chunk_docs`` is
    the chunk of an input whose rows are documents (tokenizing one costs
    about a thousand times an attribute row)."""

    mode: str = "auto"
    chunk_rows: int = DEFAULT_CHUNK_ROWS
    chunk_docs: int = DEFAULT_CHUNK_DOCS
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
            chunk_rows=_env_int("PIO_PIPELINE_CHUNK", DEFAULT_CHUNK_ROWS),
            chunk_docs=_env_int("PIO_PIPELINE_CHUNK_DOCS",
                                DEFAULT_CHUNK_DOCS),
            depth=_env_int("PIO_PIPELINE_DEPTH", DEFAULT_DEPTH, lo=1, hi=64),
            workers=_env_int("PIO_PIPELINE_WORKERS", DEFAULT_WORKERS,
                             lo=1, hi=64),
        )

    def enabled_for(self, n_rows: int, chunk: Optional[int] = None,
                    device=None) -> bool:
        """Whether an input of ``n_rows`` streams to ``device``. ``off``
        never streams; ``on`` streams any non-empty input on any device;
        ``auto`` streams only to a CUDA device and only when the input is
        at least two chunks (``chunk``, else ``chunk_rows``) long. A rank
        of a gang of more than one process never streams."""
        from ..parallel.distributed import process_count

        if self.mode == "off" or process_count() > 1:
            return False
        if self.mode == "on":
            return n_rows > 0
        if not str(device).startswith("cuda"):
            return False
        return n_rows >= 2 * (self.chunk_rows if chunk is None else chunk)


# last-run stage gauges (training is episodic: "the most recent run's
# decomposition", not a histogram of runs)
_M_STAGE = telemetry.registry().gauge(
    "pio_pipeline_stage_seconds",
    "Input-pipeline stage busy seconds for the most recent streamed "
    "train (featurize/upload/consume are per-stage sums, wall is "
    "end-to-end)", ("stage",))
_M_CHUNKS = telemetry.registry().gauge(
    "pio_pipeline_chunks",
    "Chunks streamed by the most recent pipelined train")
_M_EFFICIENCY = telemetry.registry().gauge(
    "pio_pipeline_overlap_efficiency",
    "wall / max(stage) for the most recent streamed train (1.0 = "
    "perfect stage overlap, higher = serialization waste)")


@dataclasses.dataclass
class PipelineStats:
    """One streamed run's accounting. ``featurize_seconds`` sums the time
    inside the featurize calls (worker busy time, not wall);
    ``upload_seconds`` the host side of the uploads (the copy into pinned
    memory and the enqueue); ``consume_seconds`` the consume calls (their
    enqueue); ``wall_seconds`` the run end to end. With perfect overlap
    wall ≈ the largest stage (:attr:`overlap_efficiency` 1.0).
    ``ring_peak_bytes``: on the card, the most device memory the ring's
    chunks held at once above what was allocated when it started (the
    accumulator and the resident matrix)."""

    n_chunks: int = 0
    featurize_seconds: float = 0.0
    upload_seconds: float = 0.0
    consume_seconds: float = 0.0
    wall_seconds: float = 0.0
    max_inflight: int = 0
    ring_peak_bytes: int = 0
    chunk_bytes_max: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def _add_featurize(self, dt: float) -> None:
        with self._lock:  # the workers add concurrently
            self.featurize_seconds += dt

    @property
    def overlap_efficiency(self) -> Optional[float]:
        """wall / the largest stage (1.0: the stages overlap perfectly)."""
        top = max(self.featurize_seconds, self.upload_seconds,
                  self.consume_seconds)
        return self.wall_seconds / top if top > 0 else None

    def publish(self) -> None:
        """Export this run's decomposition to the registry's gauges (the
        last run wins)."""
        _M_STAGE.labels("featurize").set(self.featurize_seconds)
        _M_STAGE.labels("upload").set(self.upload_seconds)
        _M_STAGE.labels("consume").set(self.consume_seconds)
        _M_STAGE.labels("wall").set(self.wall_seconds)
        _M_CHUNKS.labels().set(self.n_chunks)
        if self.overlap_efficiency is not None:
            _M_EFFICIENCY.labels().set(self.overlap_efficiency)

    def as_dict(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        out["overlap_efficiency"] = self.overlap_efficiency
        return out


@contextlib.contextmanager
def stats_into(timings: Optional[dict]):
    """A :class:`PipelineStats` for one trainer call (None when
    ``timings`` is None), written into ``timings["pipeline"]`` after the
    call when it streamed."""
    stats = PipelineStats() if timings is not None else None
    yield stats
    if stats is not None and stats.n_chunks:
        timings["pipeline"] = stats.as_dict()


def chunk_ranges(n_rows: int, chunk_rows: int) -> list[tuple[int, int]]:
    """[(start, stop), ...] covering [0, n_rows) in chunk_rows steps."""
    if n_rows <= 0:
        return []
    step = max(1, int(chunk_rows))
    return [(s, min(s + step, n_rows)) for s in range(0, n_rows, step)]


def prefetch(items: Iterable[Any], fn: Callable[[Any], Any],
             workers: int = DEFAULT_WORKERS,
             lookahead: int = DEFAULT_DEPTH,
             stats: Optional[PipelineStats] = None) -> Iterator[Any]:
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

    def timed_fn(item):
        t0 = time.perf_counter()
        out = fn(item)
        if stats is not None:
            stats._add_featurize(time.perf_counter() - t0)
        return out

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
                pending.append(pool.submit(timed_fn, item))
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


def run_pipeline(host_chunks: Iterable[Any], upload: Callable[[Any], Any],
                 consume: Callable[[Any], Any], depth: int = DEFAULT_DEPTH,
                 stats: Optional[PipelineStats] = None) -> int:
    """Drive the upload → consume ring; returns the number of chunks.

    ``upload(host_chunk)`` starts the chunk's copy to the device and returns
    the device chunk; ``consume(dev_chunk)`` enqueues its device work and
    returns a token (a ``torch.cuda.Event`` recorded after that work, or
    None on the CPU). Before chunk N uploads, the loop waits on the token
    of chunk N − depth and then releases that chunk's device tensors, so at
    most ``depth`` chunks are held at once. An exception from the
    chunk iterator, an upload or a consume propagates after the tokens in
    flight are waited on; the ``host_chunks`` generator is closed either
    way, which stops :func:`prefetch`'s workers mid-stream."""
    inflight: collections.deque = collections.deque()
    bound = max(1, int(depth))
    n = 0
    t_start = time.perf_counter()
    try:
        for hc in host_chunks:
            while len(inflight) >= bound:
                _block_on(inflight.popleft()[0])
            t0 = time.perf_counter()
            dev = upload(hc)
            if stats is not None:
                stats.upload_seconds += time.perf_counter() - t0
            del hc
            t0 = time.perf_counter()
            token = consume(dev)
            if stats is not None:
                stats.consume_seconds += time.perf_counter() - t0
            inflight.append((token, dev))
            del dev
            n += 1
            if stats is not None:
                stats.n_chunks = n
                stats.max_inflight = max(stats.max_inflight, len(inflight))
    finally:
        try:
            while inflight:
                _block_on(inflight.popleft()[0])
        finally:
            close = getattr(host_chunks, "close", None)
            if callable(close):
                close()
            if stats is not None:
                stats.wall_seconds = time.perf_counter() - t_start
                stats.publish()
    return n


def _block_on(token) -> None:
    """Wait for a ring token: a CUDA event is synchronized; None (a CPU
    chunk, whose work ran when it was enqueued) is ready."""
    sync = getattr(token, "synchronize", None)
    if callable(sync):
        sync()


#: numpy wire dtypes → torch's (uint16 travels as its int16 bits: see
#: :func:`widen_u16`)
_TORCH_OF = {"float32": "float32", "float64": "float64", "int64": "int64",
             "int32": "int32", "int16": "int16", "uint8": "uint8"}


def widen_u16(t):
    """An int16 tensor holding uint16 bits → int32 values (torch's uint16
    is a storage type on the card, not an arithmetic one)."""
    import torch

    return t.to(torch.int32) & 0xFFFF


class _Pinned:
    __slots__ = ("buf", "event", "seq")

    def __init__(self, buf):
        self.buf, self.event, self.seq = buf, None, 0


class DeviceRing:
    """The upload side of the ring on ``device``.

    On the card: a side stream for the copies and a pool of pinned host
    buffers (at most ``(depth + 1) × arrays`` of them). :meth:`upload`
    stages each array in a free pinned buffer (one whose last copy's event
    has completed; else it waits for the oldest), copies it to the card
    with ``non_blocking=True`` on the side stream, records the copy's
    event, and makes the consume stream (the current one) wait on it.
    :meth:`token` records the event after a chunk's consume. On the CPU
    the arrays become tensors without a copy and the token is None.

    ``stats.ring_peak_bytes``: the device memory allocated above the
    construction-time level, sampled after every upload (the chunks in
    flight and the new one; a consume's own temporaries are gone by
    then)."""

    def __init__(self, device, depth: int = DEFAULT_DEPTH,
                 stats: Optional[PipelineStats] = None):
        import torch

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stats = stats
        self._seq = 0
        self._pool: list[_Pinned] = []
        self._cap = 0
        self._depth = max(1, int(depth))
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            # memory the consume stream freed before this point may be
            # handed out again: the copies start after its work
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            self._base = torch.cuda.memory_allocated(self.device)

    def _stage(self, a: np.ndarray, busy: set) -> "object":
        """A pinned tensor holding ``a``'s bytes, in ``a``'s shape."""
        import torch

        nbytes = max(1, a.nbytes)
        free = [p for p in self._pool if id(p) not in busy
                and (p.event is None or p.event.query())]
        fit = [p for p in free if p.buf.numel() >= nbytes]
        if fit:
            slot = fit[0]
        elif len(self._pool) < self._cap:
            slot = _Pinned(torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=True))
            self._pool.append(slot)
        else:
            # the pool is full: wait for the oldest copy, then reuse (and
            # grow) its buffer
            slot = min((p for p in self._pool if id(p) not in busy),
                       key=lambda p: p.seq)
            if slot.event is not None:
                slot.event.synchronize()
            if slot.buf.numel() < nbytes:
                slot.buf = torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=True)
        busy.add(id(slot))
        dtype = getattr(torch, _TORCH_OF[a.dtype.name])
        view = slot.buf[:a.nbytes].view(dtype).view(a.shape)
        np.copyto(view.numpy(), a)
        return slot, view

    def upload(self, arrays, into=None) -> tuple:
        """Copy each numpy array of ``arrays`` to the device, into the
        matching tensor of ``into`` when given (a slice of a resident
        matrix), else into a new tensor; returns the device tensors."""
        import torch

        arrays = [np.ascontiguousarray(a) for a in arrays]
        arrays = [a.view(np.int16) if a.dtype == np.uint16 else a
                  for a in arrays]
        if self.stats is not None:
            self.stats.chunk_bytes_max = max(self.stats.chunk_bytes_max,
                                             sum(a.nbytes for a in arrays))
        if not self.cuda:
            out = [torch.from_numpy(a) for a in arrays]
            if into is not None:
                for dst, src in zip(into, out):
                    dst.copy_(src)
                return tuple(into)
            return tuple(out)
        self._cap = max(self._cap, (self._depth + 1) * len(arrays))
        busy: set = set()
        staged = [self._stage(a, busy) for a in arrays]
        out = []
        with torch.cuda.stream(self.stream):
            for j, (_slot, src) in enumerate(staged):
                dst = (into[j] if into is not None else
                       torch.empty(src.shape, dtype=src.dtype,
                                   device=self.device))
                dst.copy_(src, non_blocking=True)
                out.append(dst)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._seq += 1
        for slot, _src in staged:
            slot.event, slot.seq = event, self._seq
        torch.cuda.current_stream(self.device).wait_event(event)
        if self.stats is not None:
            self.stats.ring_peak_bytes = max(
                self.stats.ring_peak_bytes,
                torch.cuda.memory_allocated(self.device) - self._base)
        return tuple(out)

    def token(self):
        """The ring token of the chunk whose consume was just enqueued."""
        if not self.cuda:
            return None
        import torch

        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event
