"""Correlated cross-occurrence (CCO) with log-likelihood-ratio scoring.

Port of ``incubator_predictionio_tpu/ops/llr.py``; the functions take
``device=`` where the reference takes a device, and ``collectives=`` (the
gang's :class:`..parallel.distributed.HostCollectives`) where it takes a
multi-device ``mesh=``. The Universal Recommender and the Complementary
Purchase template train through it: for a pair of event types, the co-occurrence counts
C = Σ_ranges A_pᵀ A_s over binary user × item membership slabs, Dunning's
G² over each 2×2 contingency of distinct-user counts, and the top-k
correlators of every item as static [I, K] arrays (:class:`Indicators`).
Serving scores a user's history by a gather+dot per event type and a
top-k (:func:`score_user`).

Layout, on the host: the (user, item) pairs are deduped and sorted by the
event codec (``native.pair_dedupe``) and laid out by user range as
[n_ranges, E] slabs of local user offsets and item ids
(:func:`_partition_by_user`, or the codec's ``cco_partition`` on the fused
path); users far more active than the mean are renumbered onto 16-user
"heavy" ranges, so one range's slab width stays near the mean.

Counts, on the device: a range's membership slab is a flat 1-D
``index_put_`` of ones into a [(u_chunk + 1)·I] buffer (the pairs are
deduped, so a set is exact; the padding lands on the sentinel row, which
is sliced off), and the product is a float32 GEMM with TF32 on inside the
op: 0 and 1 are exact in TF32 and the accumulation is float32, so every
count is an exact integer while it stays below 2²⁴ (``n_users`` beyond
that raises). Two strategies, as in the reference: the whole [I, I]
matrix when it fits a quarter of the card's memory
(:func:`_full_matrix_elem_cap`), else [block, I] stripes with the slabs
rebuilt per stripe. The G² and the top-k run on the same [block, I]
stripes either way, so the full, striped, fused and per-pair paths give
the same indicators bit for bit.

In a gang (``collectives`` given and more than one rank: the reference's
``_full_cco_topk_sharded``, ``_full_cco_topk_multi_sharded`` and
``_all_stripes_sharded``), every rank lays out the same deduped data, pads
the range axis (the light ranges, and the heavy ranges separately) to a
multiple of the gang with sentinel-only ranges (:func:`_pad_ranges`) and
counts only its own contiguous block of it, as ``P(DATA_AXIS)`` splits it
over the reference's devices. The partial float32 counts are all-reduced
through the host: on the full path each pair's [I, I] matrix in turn, on
the striped path each [block, I] stripe. The G² and the top-k then run on
every rank. The counts are exact integers, so every rank's indicators equal
the single process's bit for bit. A rank whose block is all padding still
takes part in every all-reduce.

G², on the device: float32 in the reference's operation order. ``x·ln x``
is ``torch.xlogy``, whose CPU kernel has no vectorized branch: the CPU's
vectorized ``torch.log`` rounds some integers differently in a buffer's
tail than in its body, and equal counts must give equal G² bits wherever
they sit, or the stable top-k (score descending, then the lower index, as
``lax.top_k`` orders them) could not keep the lower index first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import native
from ..common import envknobs
from ..device import resolve_device
from .topk import _ordered_top_k

#: Heavy-user rank-range width: the heavy layout's range height, so a
#: heavy slab is [16, I]
_HEAVY_RANGE = 16
#: float32 holds every integer below this exactly: the counts' bound
_EXACT_F32 = 1 << 24


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.xlogy(x, x.clamp_min(1e-30)), 0.0)


def _entropy2(a, b):
    return _xlogx(a + b) - _xlogx(a) - _xlogx(b)


def llr_scores(k11, k12, k21, k22) -> torch.Tensor:
    """Dunning's G² over contingency counts (elementwise, float32):
    2·(H(row) + H(col) − H(matrix)) in the xlogx formulation (Mahout's
    ``LogLikelihood.logLikelihoodRatio``)."""
    k11, k12, k21, k22 = (torch.as_tensor(k, dtype=torch.float32)
                          for k in (k11, k12, k21, k22))
    row = _entropy2(k11 + k12, k21 + k22)
    col = _entropy2(k11 + k21, k12 + k22)
    mat = (_xlogx(k11 + k12 + k21 + k22)
           - _xlogx(k11) - _xlogx(k12) - _xlogx(k21) - _xlogx(k22))
    g2 = 2.0 * (row + col - mat)
    return g2.clamp_min(0.0)  # tiny negatives from cancellation


def _partition_by_user(u: np.ndarray, i: np.ndarray, u_chunk: int,
                       n_ranges: int, n_items: int,
                       assume_sorted: bool = False):
    """Host layout: (user, item) pairs by user range as [n_ranges, E] slabs
    (eu: the user's offset within its range, padding = u_chunk; ei: the
    item, padding 0). A range is never split, so each range's product
    counts every cross pair. uint16 while the values fit (u_chunk < 0xFFFF,
    n_items ≤ 0xFFFF), else int32. Users outside [0, n_ranges·u_chunk)
    are dropped."""
    valid = (u >= 0) & (u < n_ranges * u_chunk)
    u, i = u[valid], i[valid]
    if assume_sorted:
        us, is_ = u, i
    else:
        order = np.argsort(u, kind="stable")
        us, is_ = u[order], i[order]
    chunk_of = (us // u_chunk).astype(np.int64)
    counts = np.bincount(chunk_of, minlength=n_ranges)
    e = max(int(counts.max()), 1) if counts.size else 1

    starts = np.zeros(n_ranges + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(us)) - starts[chunk_of]
    u_dtype = np.uint16 if u_chunk < 0xFFFF else np.int32
    i_dtype = np.uint16 if n_items <= 0xFFFF else np.int32
    eu = np.full((n_ranges, e), u_chunk, u_dtype)
    ei = np.zeros((n_ranges, e), i_dtype)
    eu[chunk_of, pos] = (us - chunk_of * u_chunk).astype(u_dtype)
    ei[chunk_of, pos] = is_.astype(i_dtype)
    return eu, ei


def _pad_ranges(arrs, mult: int, u_chunk: int):
    """Pad the leading (range) axis of (eu, ei, eu, ei, ...) to a multiple
    of ``mult`` with sentinel-only ranges (offset ``u_chunk``: an empty
    slab, which adds nothing)."""
    n = arrs[0].shape[0]
    target = -(-n // mult) * mult
    if target == n:
        return tuple(arrs)
    out = []
    for j, a in enumerate(arrs):
        fill = u_chunk if j % 2 == 0 else 0  # (eu, ei) alternating
        pad = np.full((target - n, a.shape[1]), fill, a.dtype)
        out.append(np.concatenate([np.asarray(a), pad], axis=0))
    return tuple(out)


def _gang(collectives) -> tuple[int, int]:
    """(world, rank) the counts are split over: the gang's when
    ``collectives`` is given, else one process."""
    if collectives is None:
        return 1, 0
    from ..parallel.distributed import process_count, process_index

    return process_count(), process_index()


def _rank_block(arrs, rows: int, world: int, rank: int):
    """This rank's contiguous block of the range axis of every layout
    array in ``arrs`` (eu, ei alternating), the axis padded to a multiple
    of ``world`` first. The arrays unchanged for one process."""
    if world == 1:
        return tuple(arrs)
    arrs = _pad_ranges(arrs, world, rows)
    per = arrs[0].shape[0] // world
    return tuple(a[rank * per:(rank + 1) * per] for a in arrs)


def _fits_uint16(u_chunk: int, n_items: int) -> bool:
    """The codec's ``cco_partition`` writes the uint16 layout only."""
    return u_chunk < 0xFFFF and n_items <= 0xFFFF


def _widen(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A layout array on the device as int64; a uint16 array goes up as
    its int16 bits (half the bytes of int32) and is widened there."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).to(dev)
        return t.to(torch.int64) & 0xFFFF
    return torch.from_numpy(a.astype(np.int64, copy=False)).to(dev)


@dataclasses.dataclass
class _Ranges:
    """One event type's layout on the device: per range, the flat indices
    [n_ranges, E] of its pairs in a [(rows + 1)·I] slab buffer (the
    sentinel offset ``rows`` lands on the scratch row)."""

    flat: torch.Tensor
    rows: int

    @staticmethod
    def upload(eu: np.ndarray, ei: np.ndarray, rows: int, n_items: int,
               dev: torch.device) -> "_Ranges":
        return _Ranges(_widen(eu, dev) * n_items + _widen(ei, dev), rows)


def _slab(buf: torch.Tensor, flat: torch.Tensor, rows: int,
          n_items: int) -> torch.Tensor:
    """One range's binary membership slab [rows, I] in ``buf``."""
    buf.zero_()
    buf[flat] = 1.0
    return buf[:rows * n_items].view(rows, n_items)


@contextlib.contextmanager
def _tf32():
    """TF32 GEMMs for the duration of the counts only: 0/1 inputs are
    exact in TF32 and the accumulation is float32. The caller's setting
    is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _accumulate(cs: list, primary: _Ranges, secondaries: list,
                n_items: int, lo: Optional[int] = None,
                block: Optional[int] = None) -> int:
    """cs[s] += Σ_ranges slab_p[:, stripe]ᵀ @ slab_s for every secondary
    (``None`` = the self-pair: the primary's own slab), the primary slab
    built once per range. ``lo``/``block``: the stripe of primary items
    (the whole catalog when None). Returns the GEMMs launched."""
    rows = primary.rows
    dev = primary.flat.device
    bp = torch.empty((rows + 1) * n_items, dtype=torch.float32, device=dev)
    bs = (torch.empty_like(bp) if any(s is not None for s in secondaries)
          else None)
    gemms = 0
    with _tf32():
        for r in range(primary.flat.shape[0]):
            ap = _slab(bp, primary.flat[r], rows, n_items)
            a_p = ap if lo is None else ap[:, lo:lo + block]
            for c, sec in zip(cs, secondaries):
                a_s = (ap if sec is None
                       else _slab(bs, sec.flat[r], rows, n_items))
                c.addmm_(a_p.t(), a_s)
                gemms += 1
    return gemms


def _stripe_topk(counts: torch.Tensor, n_i_stripe: torch.Tensor,
                 n_j: torch.Tensor, lo_item: int, n_total: float, k: int,
                 llr_threshold: float):
    """G² and the top-k of one [block, I] stripe of counts. Dunning's
    contingency over distinct users (Mahout's semantics): n_i users did
    the primary event on item i, n_j the secondary on item j, of N."""
    block, _ = counts.shape
    k11 = counts
    k12 = (n_i_stripe[:, None] - counts).clamp_min(0.0)
    k21 = (n_j[None, :] - counts).clamp_min(0.0)
    k22 = (n_total - k11 - k12 - k21).clamp_min(0.0)
    llr = llr_scores(k11, k12, k21, k22)
    del k12, k21, k22
    # no score without counts and none on the diagonal
    llr = torch.where(counts > 0, llr, 0.0)
    ar = torch.arange(block, device=counts.device)
    llr[ar, ar + lo_item] = 0.0
    if llr_threshold > 0:
        llr = torch.where(llr >= llr_threshold, llr, 0.0)
    return _ordered_top_k(llr, k)


def _full_matrix_elem_cap(device: torch.device) -> int:
    """Element budget of one [I, I] accumulator: an explicit
    ``PIO_UR_FULL_MATRIX_ELEMS`` wins (a malformed value warns and falls
    back); otherwise a quarter of the card's memory over 4 bytes, leaving
    the rest to the slabs and the G² temporaries. On the CPU, the
    reference's fallback of 4 GiB."""
    if envknobs.env_str("PIO_UR_FULL_MATRIX_ELEMS", ""):
        explicit = envknobs.env_int("PIO_UR_FULL_MATRIX_ELEMS", 0,
                                    float_ok=True)
        if explicit > 0:
            return explicit
        warnings.warn(
            "PIO_UR_FULL_MATRIX_ELEMS is not a positive number; using the "
            "device-derived default", stacklevel=2)
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = 4 * 1024 ** 3
    return limit // 4 // 4


@dataclasses.dataclass
class Indicators:
    """Top-K LLR correlators per primary item (static shapes). ``on``
    keeps a copy resident on a device for serving."""

    idx: np.ndarray  # [I, K] int32, -1 = empty slot
    score: np.ndarray  # [I, K] float32 LLR
    _resident: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def max_correlators(self) -> int:
        return self.idx.shape[1]

    def on(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(idx int64, score float32) resident on ``device`` (made once)."""
        got = self._resident.get(device)
        if got is None:
            got = self._resident[device] = (
                torch.from_numpy(np.asarray(self.idx, np.int64)).to(device),
                torch.from_numpy(np.ascontiguousarray(
                    self.score, np.float32)).to(device))
        return got


class _Clock:
    """Phase times into a caller's ``timings`` dict (nothing when it is
    None), summed over calls: host phases in seconds since the previous
    mark; device phases in ms, by CUDA events on the card (read once, in
    :meth:`finish`), by the host clock on the CPU."""

    def __init__(self, dev: torch.device, timings: Optional[dict]):
        self.timings = timings
        self.cuda = dev.type == "cuda"
        self.t = time.perf_counter()
        self.events: list = []

    def _add(self, key: str, value) -> None:
        self.timings[key] = self.timings.get(key, 0) + value

    def host(self, key: str) -> None:
        now = time.perf_counter()
        if self.timings is not None:
            self._add(key, now - self.t)
        self.t = now

    @contextlib.contextmanager
    def device(self, key: str):
        if self.timings is None:
            yield
        elif self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            self.events.append((key, e0, e1))
        else:
            t0 = time.perf_counter()
            yield
            self._add(key, (time.perf_counter() - t0) * 1e3)

    def note(self, path: str, gemms: int, **layout) -> None:
        """The path taken, the GEMMs launched (summed over calls) and the
        layout's sizes."""
        if self.timings is not None:
            self._add("gemms", gemms)
            self.timings.update(path=path, **layout)

    def gang(self, coll, world: int, rank: int, local_ranges: int) -> None:
        """A gang rank's share: its rank, the light ranges it counted and
        its all-reduces' calls, bytes and seconds."""
        if self.timings is not None and world > 1:
            self.timings.update(
                rank=rank, world=world, local_ranges=local_ranges,
                allreduce_calls=coll.calls["allreduce"],
                allreduce_bytes=coll.bytes["allreduce"],
                allreduce_seconds=coll.seconds["allreduce"])

    def finish(self) -> None:
        """Read the CUDA events (waits for the card)."""
        if self.events:
            torch.cuda.synchronize()
            for key, e0, e1 in self.events:
                self._add(key, e0.elapsed_time(e1))
            self.events = []


def _check_exact(n_users: int) -> None:
    if n_users >= _EXACT_F32:
        raise ValueError(
            f"n_users = {n_users}: the float32 co-occurrence counts are exact "
            f"only below 2**24 = {_EXACT_F32} users")


def _stripes(n_items: int, item_block: int):
    """(block, stripe origins, effective origins): the last stripe may be
    ragged, so it is computed as a full block ending at the catalog edge
    and its overlap is sliced off afterwards."""
    block = min(item_block, n_items)
    los = list(range(0, n_items, block))
    lo_effs = [min(lo, n_items - block) for lo in los]
    return block, los, lo_effs


def _topk_stripes(c: torch.Tensor, n_i: torch.Tensor, n_j: torch.Tensor,
                  lo_effs: list, block: int, n_total: float, k: int,
                  llr_threshold: float) -> tuple[list, list]:
    """G² + top-k of every stripe of a full [I, I] count matrix."""
    ss, ixs = [], []
    for lo in lo_effs:
        s, ix = _stripe_topk(c[lo:lo + block], n_i[lo:lo + block], n_j, lo,
                             n_total, k, llr_threshold)
        ss.append(s)
        ixs.append(ix)
    return ss, ixs


def _gather_indicators(ss, ixs, los, lo_effs, block, n_items) -> Indicators:
    """Per-stripe results → host [I, K] Indicators (the ragged last
    stripe's overlap sliced off; zero-score slots → -1)."""
    ss = torch.stack(ss).cpu().numpy()
    ixs = torch.stack(ixs).cpu().numpy()
    idx_parts, score_parts = [], []
    for j, lo in enumerate(los):
        b = min(block, n_items - lo)
        skip = lo - int(lo_effs[j])
        score_parts.append(ss[j][skip:skip + b])
        idx_parts.append(ixs[j][skip:skip + b])
    score = np.concatenate(score_parts, axis=0)
    idx = np.concatenate(idx_parts, axis=0).astype(np.int32)
    idx[score <= 0] = -1
    return Indicators(idx=idx, score=score.astype(np.float32))


def _heavy_split(per_user: np.ndarray, n_users: int):
    """(rank per user, -1 for light users, or None; heavy-user count):
    users with more than max(16 × mean, 256) pairs."""
    mean_pu = max(float(per_user.sum()) / max(n_users, 1), 1.0)
    heavy_cap = max(int(16 * mean_pu), 256)
    heavy_users = np.nonzero(per_user > heavy_cap)[0]
    if not len(heavy_users):
        return None, 0
    rank = np.full(n_users, -1, np.int64)
    rank[heavy_users] = np.arange(len(heavy_users))
    return rank, int(len(heavy_users))


def _split_heavy(rank, u, i):
    if rank is None:
        return u, i, None, None
    hm = rank[u] >= 0
    return (u[~hm], i[~hm],
            rank[u[hm]].astype(np.int32), i[hm].astype(np.int32))


def cco_indicators(
    primary_u: np.ndarray,
    primary_i: np.ndarray,
    secondary_u: np.ndarray,
    secondary_i: np.ndarray,
    n_users: int,
    n_items: int,
    max_correlators: int = 50,
    llr_threshold: float = 0.0,
    u_chunk: int = 2048,
    item_block: int = 4096,
    device="cuda",
    timings: Optional[dict] = None,
    collectives=None,
) -> Indicators:
    """The LLR-thresholded cross-occurrence indicators between a primary
    event's items and a secondary event's items (one item-id space;
    self-co-occurrence when they are the same events), on ``device``: the
    full [I, I] accumulator when it fits :func:`_full_matrix_elem_cap`,
    else item stripes. ``timings``: a dict that receives the phase times
    (host seconds, device ms), the path and the GEMM count.
    ``collectives``: the gang's, when every rank of a gang passes the same
    events: each counts its block of the user ranges and the counts are
    all-reduced (in a gang of one, or without it, this process counts
    them all)."""
    dev = resolve_device(device)
    _check_exact(n_users)
    world, rank = _gang(collectives)
    clock = _Clock(dev, timings)
    pu, pi, cnt_p = native.pair_dedupe(primary_u, primary_i, n_users,
                                       n_items)
    su, si, cnt_s = native.pair_dedupe(secondary_u, secondary_i, n_users,
                                       n_items)
    clock.host("dedupe_s")
    n_ranges = max((n_users + u_chunk - 1) // u_chunk, 1)
    hrank, n_heavy = _heavy_split(cnt_p + cnt_s, n_users)
    pu_l, pi_l, hp_u, hp_i = _split_heavy(hrank, pu, pi)
    su_l, si_l, hs_u, hs_i = _split_heavy(hrank, su, si)
    # (eu, ei) of the primary, then of the secondary, per part: the light
    # ranges, then (with heavy users) the heavy ranges; this rank's block
    parts = [(_rank_block(
        _partition_by_user(pu_l, pi_l, u_chunk, n_ranges, n_items,
                           assume_sorted=True)
        + _partition_by_user(su_l, si_l, u_chunk, n_ranges, n_items,
                             assume_sorted=True), u_chunk, world, rank),
        u_chunk)]
    if n_heavy:
        h_ranges = max((n_heavy + _HEAVY_RANGE - 1) // _HEAVY_RANGE, 1)
        parts.append((_rank_block(
            _partition_by_user(hp_u, hp_i, _HEAVY_RANGE, h_ranges, n_items,
                               assume_sorted=True)
            + _partition_by_user(hs_u, hs_i, _HEAVY_RANGE, h_ranges,
                                 n_items, assume_sorted=True),
            _HEAVY_RANGE, world, rank), _HEAVY_RANGE))
    n_i = np.bincount(pi, minlength=n_items).astype(np.float32)
    n_j = np.bincount(si, minlength=n_items).astype(np.float32)
    clock.host("partition_s")

    scans = [(_Ranges.upload(peu, pei, h, n_items, dev),
              _Ranges.upload(seu, sei, h, n_items, dev))
             for (peu, pei, seu, sei), h in parts]
    n_i_dev = torch.from_numpy(n_i).to(dev)
    n_j_dev = torch.from_numpy(n_j).to(dev)
    clock.host("upload_s")

    k = min(max_correlators, n_items)
    block, los, lo_effs = _stripes(n_items, item_block)
    full = n_items * n_items <= _full_matrix_elem_cap(dev)
    gemms = 0
    with torch.no_grad():
        if full:
            c = torch.zeros((n_items, n_items), dtype=torch.float32,
                            device=dev)
            with clock.device("counts_ms"):
                for p, s in scans:
                    gemms += _accumulate([c], p, [s], n_items)
            if world > 1:
                collectives.all_reduce(c)
            with clock.device("g2_topk_ms"):
                ss, ixs = _topk_stripes(c, n_i_dev, n_j_dev, lo_effs, block,
                                        float(n_users), k, llr_threshold)
            del c
        else:
            ss, ixs = [], []
            for lo in lo_effs:
                c = torch.zeros((block, n_items), dtype=torch.float32,
                                device=dev)
                with clock.device("counts_ms"):
                    for p, s in scans:
                        gemms += _accumulate([c], p, [s], n_items, lo, block)
                if world > 1:
                    collectives.all_reduce(c)
                with clock.device("g2_topk_ms"):
                    s, ix = _stripe_topk(c, n_i_dev[lo:lo + block], n_j_dev,
                                         lo, float(n_users), k,
                                         llr_threshold)
                ss.append(s)
                ixs.append(ix)
                del c
    clock.note(path="full" if full else "striped", gemms=gemms,
               n_ranges=n_ranges, heavy_users=n_heavy)
    clock.gang(collectives, world, rank, parts[0][0][0].shape[0])
    clock.finish()
    return _gather_indicators(ss, ixs, los, lo_effs, block, n_items)


def _partition_put(u, i, hrank, n_users: int, u_chunk: int, n_ranges: int,
                   n_items: int, h_ranges: int, dev: torch.device,
                   world: int = 1, rank: int = 0):
    """One event type's layout (the codec's one-pass ``cco_partition`` on
    the uint16 wire, else the int32 layout of :func:`_partition_by_user`;
    ``hrank``: the heavy users' ranks), this gang rank's block of it
    uploaded: (light _Ranges, heavy _Ranges or None, item counts)."""
    if _fits_uint16(u_chunk, n_items):
        light, heavy, counts = native.cco_partition(
            u, i, hrank, n_users, u_chunk, n_ranges, n_items, _HEAVY_RANGE,
            h_ranges)
    else:
        lu, li, hu, hi = _split_heavy(hrank, u, i)
        light = _partition_by_user(lu, li, u_chunk, n_ranges, n_items,
                                   assume_sorted=True)
        heavy = None
        if hrank is not None:
            heavy = _partition_by_user(hu, hi, _HEAVY_RANGE, h_ranges,
                                       n_items, assume_sorted=True)
        counts = np.bincount(i, minlength=n_items)
    light_dev = _Ranges.upload(*_rank_block(light, u_chunk, world, rank),
                               u_chunk, n_items, dev)
    heavy_dev = (None if heavy is None else _Ranges.upload(
        *_rank_block(heavy, _HEAVY_RANGE, world, rank), _HEAVY_RANGE,
        n_items, dev))
    return light_dev, heavy_dev, counts.astype(np.float32)


def _fused_layout(primary_u, primary_i, secondaries: dict, n_users: int,
                  n_items: int, u_chunk: int, dev: torch.device,
                  clock: _Clock, world: int = 1, rank: int = 0):
    """The fused path's prep: the primary deduped and laid out once, each
    secondary that is not the primary itself (by identity) likewise, the
    heavy users chosen over the combined activity; only this gang rank's
    block of the ranges is uploaded. Returns (primary (light, heavy,
    n_i), [per secondary: None for the self-pair, else (light, heavy,
    n_j)], heavy-user count, range count)."""
    pu, pi, per_user = native.pair_dedupe(primary_u, primary_i, n_users,
                                          n_items)
    per_user = per_user.astype(np.int64, copy=True)
    deduped = {}
    for name, (su, si) in secondaries.items():
        if su is primary_u and si is primary_i:
            deduped[name] = None  # self-pair: the primary's slabs
        else:
            du, di, cnt = native.pair_dedupe(su, si, n_users, n_items)
            deduped[name] = (du, di)
            # the threshold shapes the layout only, never the counts
            per_user += cnt
    clock.host("dedupe_s")
    hrank, n_heavy = _heavy_split(per_user, n_users)
    n_ranges = max((n_users + u_chunk - 1) // u_chunk, 1)
    h_ranges = max((n_heavy + _HEAVY_RANGE - 1) // _HEAVY_RANGE, 1)
    prim = _partition_put(pu, pi, hrank, n_users, u_chunk, n_ranges,
                          n_items, h_ranges, dev, world, rank)
    secs = [None if pair is None else
            _partition_put(*pair, hrank, n_users, u_chunk, n_ranges,
                           n_items, h_ranges, dev, world, rank)
            for pair in deduped.values()]
    clock.host("partition_upload_s")
    return prim, secs, n_heavy, n_ranges


def _fused_counts(prim, secs, n_items: int, dev: torch.device) -> tuple:
    """Every pair's [I, I] counts in one scan over the user ranges (then
    the heavy ranges), each range's primary slab built once."""
    cs = [torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
          for _ in secs]
    gemms = 0
    for part in (0, 1):  # light ranges, then heavy ranges
        if prim[part] is None:
            continue
        gemms += _accumulate(cs, prim[part],
                             [None if s is None else s[part] for s in secs],
                             n_items)
    return cs, gemms


def cooccurrence_counts(primary_u, primary_i, secondaries: dict,
                        n_users: int, n_items: int, u_chunk: int = 2048,
                        device="cuda", collectives=None) -> dict:
    """name → the [I, I] float32 count matrix (exact integers) of every
    pair, on ``device``, by the fused path's own layout and scan (summed
    over the gang with ``collectives``): what :func:`cco_indicators_multi`
    ranks. For holding the counts to a reference."""
    dev = resolve_device(device)
    _check_exact(n_users)
    world, rank = _gang(collectives)
    prim, secs, _, _ = _fused_layout(primary_u, primary_i, secondaries,
                                     n_users, n_items, u_chunk, dev,
                                     _Clock(dev, None), world, rank)
    with torch.no_grad():
        cs, _ = _fused_counts(prim, secs, n_items, dev)
        if world > 1:
            for c in cs:
                collectives.all_reduce(c)
    return dict(zip(secondaries, cs))


def cco_indicators_multi(
    primary_u: np.ndarray,
    primary_i: np.ndarray,
    secondaries: dict,
    n_users: int,
    n_items: int,
    max_correlators: int = 50,
    llr_threshold: float = 0.0,
    u_chunk: int = 2048,
    item_block: int = 4096,
    device="cuda",
    timings: Optional[dict] = None,
    collectives=None,
) -> dict:
    """All cross-occurrence indicators of one primary event at once
    (``secondaries``: name → (u, i); the primary's own arrays, by
    identity, mark the self-pair, which reuses the primary's slabs): the
    pairs share the primary's dedupe, layout, upload and per-range slab.
    When the fused accumulators would not fit twice
    :func:`_full_matrix_elem_cap` (or there is one pair), each pair goes
    through :func:`cco_indicators`. Bit-identical either way.
    ``collectives``: the gang's, as for :func:`cco_indicators`; the fused
    path all-reduces each pair's [I, I] counts in turn."""
    dev = resolve_device(device)
    names = list(secondaries)
    if not names:
        return {}
    fused = len(names) * n_items * n_items <= 2 * _full_matrix_elem_cap(dev)
    if not fused or len(names) == 1:
        out = {
            name: cco_indicators(
                primary_u, primary_i, su, si, n_users, n_items,
                max_correlators=max_correlators,
                llr_threshold=llr_threshold, u_chunk=u_chunk,
                item_block=item_block, device=dev, timings=timings,
                collectives=collectives)
            for name, (su, si) in secondaries.items()}
        if timings is not None:
            timings["path"] = "per_pair_" + timings["path"]
        return out

    _check_exact(n_users)
    world, rank = _gang(collectives)
    clock = _Clock(dev, timings)
    prim, secs, n_heavy, n_ranges = _fused_layout(
        primary_u, primary_i, secondaries, n_users, n_items, u_chunk, dev,
        clock, world, rank)
    n_i = torch.from_numpy(prim[2]).to(dev)
    n_js = [n_i if s is None else torch.from_numpy(s[2]).to(dev)
            for s in secs]
    clock.host("upload_s")
    k = min(max_correlators, n_items)
    block, los, lo_effs = _stripes(n_items, item_block)
    out = {}
    with torch.no_grad():
        with clock.device("counts_ms"):
            cs, gemms = _fused_counts(prim, secs, n_items, dev)
        for name, c, n_j in zip(names, cs, n_js):
            if world > 1:  # pair by pair: one [I, I] staged at a time
                collectives.all_reduce(c)
            with clock.device("g2_topk_ms"):
                out[name] = _topk_stripes(c, n_i, n_j, lo_effs, block,
                                          float(n_users), k, llr_threshold)
        del cs
    clock.note(path="fused", gemms=gemms, n_ranges=n_ranges,
               heavy_users=n_heavy)
    clock.gang(collectives, world, rank, prim[0].flat.shape[0])
    clock.finish()
    return {name: _gather_indicators(ss, ixs, los, lo_effs, block, n_items)
            for name, (ss, ixs) in out.items()}


def _score_history(idx: torch.Tensor, score: torch.Tensor,
                   membership: torch.Tensor, boost: float) -> torch.Tensor:
    """score_i = Σ_slots score[i, s]·membership[idx[i, s]] (gather+dot):
    the replacement of the reference UR's search-engine query.
    ``membership``: the [I] 0/1 history of one event type."""
    m = torch.where(idx >= 0, membership[idx.clamp_min(0)], 0.0)
    return (score * m).sum(dim=1) * boost


def score_user(indicator_list: list, k: int,
               exclude: Optional[np.ndarray] = None,
               item_boost: Optional[np.ndarray] = None,
               device="cuda"):
    """One user's history scored against the indicators, on ``device``
    (each :class:`Indicators` made resident there once).

    ``indicator_list``: [(Indicators, membership [I] float32, boost)] per
    event type; ``item_boost`` [I] multiplies the scores before the top-k,
    so boosted items can enter the result; ``exclude`` [I] bool scores
    -inf. Returns host (scores[k], idx[k]), score descending then index
    ascending."""
    dev = resolve_device(device)
    with torch.no_grad():
        total = None
        for ind, membership, boost in indicator_list:
            idx, score = ind.on(dev)
            m = torch.from_numpy(np.ascontiguousarray(
                membership, np.float32)).to(dev)
            s = _score_history(idx, score, m, float(np.float32(boost)))
            total = s if total is None else total + s
        if item_boost is not None:
            total = total * torch.from_numpy(np.ascontiguousarray(
                item_boost, np.float32)).to(dev)
        if exclude is not None:
            total = total.masked_fill(
                torch.from_numpy(np.asarray(exclude, bool)).to(dev),
                float("-inf"))
        vals, idx = _ordered_top_k(total, min(k, total.shape[0]))
    return vals.cpu().numpy(), idx.cpu().numpy()
