"""Alternating Least Squares on one device (the card, or the CPU when asked).

Port of the single-device path of ``incubator_predictionio_tpu/ops/als.py``
(``train_als`` :725 on a one-device mesh, replicated mode). The math and the
data layout are the reference's:

- Ratings are laid out as length-bucketed dense row slabs
  (:mod:`.rowblocks`, the same slot order as the reference), so the per-row
  normal equations fall straight out of a batched [R, C, k] product.
- One half-step solves (YᵀY·[implicit] + Σ_c y_c y_cᵀ + λ·c·I) x = Yᵀr per
  row. The gather of the counterpart rows (``index_select``) and the
  grams and right-hand sides (``bmm``) go 512 rows at a time
  (``_FUSED_CHUNK_ROWS``), written into one bucket-wide solve buffer of at
  most ``_SOLVE_BUFFER_BYTES`` of grams; the ridge is added there and the
  buffer is solved in one :func:`.spd_solve.batched_spd_solve` call — one
  launch of the hand-written CUDA Gauss-Jordan kernel on the card. The
  cap bounds live memory as the reference's chunking does (at rank 128 a
  whole side's grams would be ~11 GB).
- Rows longer than the overflow length (the heavy bucket) materialize their
  grams, take the virtual rows' grams in a fixed order and are solved in
  one call: pass j adds every parent's j-th virtual row
  (:func:`overflow_merge_passes`), so each pass has distinct targets and
  the sum is the same, bit for bit, on the card (where ``index_add_``
  over repeated targets uses atomics) as on the CPU.

- A side whose counterpart has at most 65,535 slots (its sentinel
  included) keeps its column slabs as 16-bit indices on the device and
  widens them per gathered chunk (the reference's ``_side_flat``).

The gather, grams and right-hand sides are plain torch: the JAX package
left them to XLA. ``compute_dtype="auto"`` resolves to float32 (the
reference's rule off a TPU); ``"bfloat16"`` takes the reference's rounding
points as its CPU computes them: the counterpart factors (the sentinel row
too) rounded to bfloat16 once per half-step and gathered as bfloat16 rows,
every weight rounded before it multiplies, every product and sum formed in
float32 (:func:`_grams_rows_bf16`); the factors, the grams and the solve
stay float32, so both kernels serve either dtype unchanged.

:func:`train_als` also carries the reference's checkpoint/resume, NaN
guard and ``timings`` hooks, and the gang hooks of a supervised worker
(``fault_point("train.sweep")`` before each dispatch, a heartbeat after
each dispatch and save, the gang-wide drain flag at chunk boundaries);
:func:`fold_in_factors` is the closed-form fold-in, one half-step for the
touched rows, solved by the same kernels.

:func:`train_als_partition_local` is the data-parallel trainer of a gang
(the reference's ``train_als_partition_local`` :1436 and
``_make_dp_train_fn`` :1282): each rank holds only its event-log
partitions' events; per half-step it sums per-event outer products into
per-row normal equations for EVERY row (an ordered scatter-add,
:func:`_sum_rows_`), all-reduces them over the gang's gloo group, solves
its own row block in solve buffers of
``_SOLVE_BUFFER_BYTES`` (one launch of the warp kernel per buffer on the
card at rank ≤ 32), and re-assembles the replicated factor matrix with one
more all-reduce of a zero-filled matrix (exact: the other ranks' rows are
0).

:class:`SlabGangALS` is the multi-process slab trainer (the reference's
``_make_train_fn`` :417 on a multi-process mesh): the layout planned for
the ``d`` data shards of a ``(d, m)`` mesh, each rank solving its shard
with the single-process bucket loop, on the 2-D ALX layout against its
model block of the counterpart with the partial grams summed over its
model group. :func:`train_als` runs on it in a gang (every rank passes
the whole triple: the merged feed), and :func:`train_als_process_sharded`
when each rank passes only its :func:`process_row_ranges` rows.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ..common.faultinject import fault_point
from ..common.nan_guard import NaNGuardError
from ..device import resolve_device
from ..parallel import supervisor as gang
from ..parallel.distributed import (
    HostCollectives, all_gather_int64s, process_count, process_index,
)
from ..workflow.checkpoint import CheckpointIncompatibleError
from .rowblocks import (
    LADDER_GROWTH, OVERFLOW_LEN, BucketArrays, LayoutPlan, fill_buckets,
    plan_and_fill_both, plan_layout,
)
from .spd_solve import MAX_GJ_K, batched_spd_solve, build_kernel


@dataclasses.dataclass(frozen=True)
class ALSParams:
    rank: int = 10
    num_iterations: int = 10
    reg: float = 0.01  # "lambda" in engine.json
    lambda_scaling: str = "plain"  # 'plain' | 'nratings'
    implicit_prefs: bool = False
    alpha: float = 1.0  # implicit-feedback confidence weight
    seed: int = 3
    # engine.json blockLen: only scales an explicit chunk_tiles budget
    block_len: int = 32
    # "auto" → float32 (the reference's rule off a TPU); "float32" or
    # "bfloat16" (the gathered rows and the weights, _grams_rows_bf16)
    compute_dtype: str = "auto"
    # ≤ 0: 512-row chunks (byte-capped); > 0: chunk_tiles × block_len
    # gathered entries per step bound the chunk too
    chunk_tiles: int = -1
    # all-ones ratings: no value slab is built. None = detect from the data
    binary_ratings: "bool | None" = None


@dataclasses.dataclass
class ALSFactors:
    user_factors: np.ndarray  # [n_users, k] f32
    item_factors: np.ndarray  # [n_items, k]
    n_users: int
    n_items: int


#: gathered entries per step of the heavy bucket's gram build
_AUTO_ENTRIES_PER_STEP = 1 << 17
#: rows per fused gather→gram→solve step (the reference's chunk)
_FUSED_CHUNK_ROWS = 512
#: cap on the gathered [chunk, C, k] slab bytes per fused step
_FUSED_SLAB_BYTES = 512 * 1024 * 1024
#: cap on the [n, k, k] gram bytes of one solve buffer (one kernel launch):
#: 131,072 systems at rank 32, 8,192 at rank 128
_SOLVE_BUFFER_BYTES = _FUSED_SLAB_BYTES
#: a side's column slabs are kept as 16-bit indices when the counterpart's
#: sentinel slot is at most this (the reference's uint16 narrowing)
_NARROW_COL_MAX = int(np.iinfo(np.uint16).max)
#: layout generation, the seed of the resume fingerprint (the reference's
#: ``_LAYOUT_TAG``: a snapshot resumes only a run with the same slot plan)
_LAYOUT_TAG = 0x70_10_00_02


def _resolve_params(params: ALSParams) -> tuple[ALSParams, int]:
    """Materialize 'auto' knobs; returns (params, entries_per_step)."""
    if params.compute_dtype == "auto":
        params = dataclasses.replace(params, compute_dtype="float32")
    if params.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype {params.compute_dtype!r} is not supported; "
            "use 'auto', 'float32' or 'bfloat16'")
    if params.lambda_scaling not in ("plain", "nratings"):
        raise ValueError(f"lambda_scaling must be 'plain' or 'nratings', got "
                         f"{params.lambda_scaling!r}")
    if params.chunk_tiles > 0:
        entries = max(params.chunk_tiles * max(params.block_len, 1), 8)
    else:
        entries = _AUTO_ENTRIES_PER_STEP
    return params, entries


def _grams_rows(p: torch.Tensor, val: Optional[torch.Tensor], *,
                implicit: bool, alpha: float, out=None):
    """Per-row normal-equation contributions from gathered counterpart rows
    p [R, C, k]: grams [R, k, k], rhs [R, k] (float32), written into
    ``out`` = (grams, rhs) when given (contiguous views of a solve buffer).

    Padding slots must already be zero rows in p (the sentinel row), so
    they contribute nothing. ``val=None``: binary ratings — every real
    entry is 1.0 and the per-entry weights collapse to scalars.
    """
    R, _, k = p.shape
    if out is None:
        out = (torch.empty((R, k, k), dtype=p.dtype, device=p.device),
               torch.empty((R, k), dtype=p.dtype, device=p.device))
    grams, rhs = out
    pt = p.transpose(1, 2)  # [R, k, C]
    if implicit:
        # Hu-Koren-Volinsky: A = YᵀY + Yᵀ(C-I)Y + λ·c·I, b = YᵀCp, with
        # C-I = alpha·r on observed entries only (YᵀY is added later).
        if val is None:
            torch.bmm(pt * alpha, p, out=grams)
            torch.mul(p.sum(dim=1), 1.0 + alpha, out=rhs)
        else:
            torch.bmm(pt * (alpha * val)[:, None, :], p, out=grams)
            torch.bmm(pt, (1.0 + alpha * val)[:, :, None], out=rhs[:, :, None])
    else:
        torch.bmm(pt, p, out=grams)
        if val is None:
            torch.sum(p, dim=1, out=rhs)
        else:
            torch.bmm(pt, val[:, :, None], out=rhs[:, :, None])
    return grams, rhs


def _grams_rows_bf16(p: torch.Tensor, w: Optional[torch.Tensor], *,
                     implicit: bool, alpha: float, out=None):
    """:func:`_grams_rows` under ``compute_dtype="bfloat16"``, from gathered
    bfloat16 rows p [R, C, k] and the side's weights as :func:`_bf16_weights`
    rounded them: the reference's ``_grams_rows`` with
    ``compute_dtype=bfloat16`` (als.py:129-168) as its CPU computes it.
    The rows are upcast and every product and sum is formed in float32:
    ``p·weight`` is NOT rounded back (XLA keeps it in float32), and a
    product of bfloat16 values, or of one with a bfloat16 weight, is exact
    in float32, so only the float32 summation order differs from the
    reference. Grams and rhs are float32."""
    pf = p.float()
    if not implicit:
        return _grams_rows(pf, w, implicit=False, alpha=alpha, out=out)
    R, _, k = p.shape
    if out is None:
        out = (torch.empty((R, k, k), dtype=torch.float32, device=p.device),
               torch.empty((R, k), dtype=torch.float32, device=p.device))
    grams, rhs = out
    pt = pf.transpose(1, 2)
    if w is None:
        torch.bmm(pt * _bf16(alpha), pf, out=grams)
        torch.mul(pf.sum(dim=1), 1.0 + alpha, out=rhs)
    else:
        torch.bmm(pt * w[:, 0, None, :], pf, out=grams)
        torch.bmm(pt, w[:, 1, :, None], out=rhs[:, :, None])
    return grams, rhs


def _bf16(x):
    """``x`` (a float or a float32 tensor) rounded to bfloat16, as float32."""
    if isinstance(x, float):
        return float(torch.tensor(x).to(torch.bfloat16))
    return x.to(torch.bfloat16).float()


def _bf16_weights(v: np.ndarray, params: ALSParams) -> torch.Tensor:
    """A value slab [R, C] as :func:`_grams_rows_bf16` takes it, rounded
    once when the side is built: ``val`` → bfloat16 (explicit), or
    ``alpha·val`` and ``1 + alpha·val`` → bfloat16 stacked [R, 2, C] (the
    implicit grams' and right-hand side's weights)."""
    v = torch.from_numpy(np.ascontiguousarray(v))
    if not params.implicit_prefs:
        return _bf16(v)
    return torch.stack([_bf16(params.alpha * v),
                        _bf16(1.0 + params.alpha * v)], dim=1)


def _compute_rows(y: torch.Tensor, params: ALSParams):
    """(the rows a half-step gathers, YᵀY of implicit feedback or None)
    from the counterpart ``y`` (its zero sentinel row included): float32
    as stored, or under bfloat16 rounded once (the reference's ``y_cd``,
    als.py:456-473), YᵀY then summed in float32 from the rounded rows."""
    if params.compute_dtype != "bfloat16":
        return y, (y.T @ y) if params.implicit_prefs else None
    y_cd = y.to(torch.bfloat16)
    if not params.implicit_prefs:
        return y_cd, None
    yf = y_cd.float()
    return y_cd, yf.T @ yf


def _elem_bytes(params: ALSParams) -> int:
    """Bytes of one gathered element (the reference's ``cd_bytes``)."""
    return 2 if params.compute_dtype == "bfloat16" else 4


def _ridge_solve(a: torch.Tensor, b: torch.Tensor, lam: torch.Tensor,
                 yty: Optional[torch.Tensor]) -> torch.Tensor:
    """(+YᵀY) → +λ on the diagonal → batched SPD solve. Updates ``a`` in
    place (it is a temporary of the caller)."""
    if yty is not None:
        a += yty[None, :, :]  # shared YᵀY term (implicit feedback)
    a.diagonal(dim1=1, dim2=2).add_(lam[:, None])
    return batched_spd_solve(a, b)


def _fused_chunk_rows(C: int, k: int, entries_budget: Optional[int],
                      elem_bytes: int = 4) -> int:
    chunk_r = _FUSED_CHUNK_ROWS
    while chunk_r > 64 and chunk_r * C * k * elem_bytes > _FUSED_SLAB_BYTES:
        chunk_r //= 2
    if entries_budget is not None:
        chunk_r = max(1, min(chunk_r, entries_budget // max(C, 1) or 1))
    return chunk_r


def _solve_buffer_rows(R: int, chunk_r: int, k: int) -> int:
    """Rows of one bucket's solve buffer: whole chunks, as many as
    ``_SOLVE_BUFFER_BYTES`` of [k, k] grams hold (at least one chunk), and
    no more than the bucket has."""
    cap = _SOLVE_BUFFER_BYTES // (k * k * 4)
    return min(max(chunk_r, cap // chunk_r * chunk_r), max(R, 1))


def solve_calls_per_half_step(plan: LayoutPlan, params: ALSParams,
                              shards: Optional[int] = None) -> int:
    """SPD-solve calls one half-step makes on this side: the solve buffers
    of every non-heavy bucket plus one for the heavy bucket. On the card
    with rank ≤ 128 each call is one launch of a Gauss-Jordan kernel.
    ``shards``: how many of the plan's shards one process solves (default
    all of them; 1 on a rank of the slab gang)."""
    params, entries = _resolve_params(params)
    budget = entries if params.chunk_tiles > 0 else None
    n_fused = len(plan.lengths) - (1 if plan.has_heavy_bucket else 0)
    calls = 0
    for bi in range(n_fused):
        R = int(plan.bucket_rows[bi]) * (plan.n_shards if shards is None
                                         else int(shards))
        chunk_r = min(_fused_chunk_rows(int(plan.lengths[bi]), params.rank,
                                        budget, _elem_bytes(params)),
                      max(R, 1))
        calls += -(-R // _solve_buffer_rows(R, chunk_r, params.rank))
    return calls + (1 if plan.has_heavy_bucket else 0)


def _host_lam(plan: LayoutPlan, params: ALSParams) -> np.ndarray:
    """Per-slot ridge weights (+1e-6 keeps empty rows well-conditioned)."""
    counts = plan.counts_slot.astype(np.float32)
    if params.lambda_scaling == "nratings":
        lam = params.reg * np.maximum(counts, 1.0)
    else:
        lam = np.full(counts.shape, params.reg, dtype=np.float32)
    return (lam + np.where(counts == 0, 1e-6, 0.0)).astype(np.float32)


def _fresh_init(params: ALSParams, plan_u: LayoutPlan, plan_i: LayoutPlan,
                n_users: int, n_items: int):
    """MLlib-style init (scaled standard normal) drawn in global row order
    from numpy ``default_rng(seed)`` and placed into layout slots — the
    reference's exact draw, so both packages start from the same factors."""
    k = params.rank
    rng = np.random.default_rng(params.seed)
    x0 = np.zeros((plan_u.total_slots, k), np.float32)
    y0 = np.zeros((plan_i.total_slots, k), np.float32)
    x0[plan_u.slot_of_row] = (
        rng.standard_normal((n_users, k)) / np.sqrt(k)).astype(np.float32)
    y0[plan_i.slot_of_row] = (
        rng.standard_normal((n_items, k)) / np.sqrt(k)).astype(np.float32)
    return x0, y0


def _sync(device: torch.device) -> None:
    """Wait for the device (the barrier of every timed region)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _widen(cols: torch.Tensor) -> torch.Tensor:
    """A gathered chunk's column indices as an ``index_select`` index."""
    return cols.to(torch.int32) if cols.dtype == torch.uint16 else cols


def layout_fingerprint(plan_u: LayoutPlan, plan_i: LayoutPlan, user_idx,
                       item_idx, rating) -> int:
    """The reference's resume fingerprint (``train_als``, als.py:789-808):
    a crc32 chain seeded with :data:`_LAYOUT_TAG` over both slot
    permutations, then the raw user and item index bytes and the ratings
    as float32. A snapshot resumes only the identical data and layout."""
    layout_fp = zlib.crc32(plan_i.slot_of_row.tobytes(),
                           zlib.crc32(plan_u.slot_of_row.tobytes(),
                                      _LAYOUT_TAG))
    return zlib.crc32(
        np.asarray(rating, np.float32).tobytes(),
        zlib.crc32(np.asarray(item_idx).tobytes(),
                   zlib.crc32(np.asarray(user_idx).tobytes(), layout_fp)))


class _Side:
    """One side's slabs and ridge weights, resident on the device.
    ``col_sentinel`` is the counterpart's sentinel slot: when it is at most
    :data:`_NARROW_COL_MAX` the column slabs are kept as uint16. Under
    ``compute_dtype="bfloat16"`` the value slabs are held as
    :func:`_bf16_weights`. ``v_parent``: the heavy rows' parent slots when
    ``arrs`` holds one shard of a multi-shard plan (that shard's part of
    ``plan.v_parent``)."""

    def __init__(self, plan: LayoutPlan, arrs: BucketArrays,
                 lam: np.ndarray, params: ALSParams, device: torch.device,
                 col_sentinel: int, v_parent: Optional[np.ndarray] = None):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        binary = bool(params.binary_ratings)
        if params.compute_dtype == "bfloat16":
            def put_vals(v):
                return _bf16_weights(v, params).to(device)
        else:
            put_vals = put

        self.narrow = col_sentinel <= _NARROW_COL_MAX

        def put_cols(c):
            return put(c.astype(np.uint16) if self.narrow else c)

        self.plan = plan
        self.cols = [put_cols(c) for c in arrs.cols]
        self.vals = None if binary else [put_vals(v) for v in arrs.vals]
        self.lam = put(lam)
        self.v_cols = self.v_vals = None
        self.v_passes = []
        if plan.has_heavy_bucket:
            self.v_cols = put_cols(arrs.v_cols)
            self.v_vals = None if binary else put_vals(arrs.v_vals)
            self.v_passes = [(put(src), put(dst)) for src, dst
                             in overflow_merge_passes(
                                 plan.v_parent if v_parent is None
                                 else v_parent)]


def overflow_merge_passes(parent: np.ndarray) -> list:
    """The merge of virtual rows into their parents as passes with
    distinct targets: pass j is (positions, parents) of every parent's
    j-th virtual row in position order. Adding the passes in turn adds each
    parent's rows in the order ``index_add_`` takes on the CPU, so the
    result equals it bit for bit and does not depend on thread timing."""
    parent = np.asarray(parent, np.int64)
    order = np.argsort(parent, kind="stable")
    sorted_parent = parent[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_parent)) + 1]
    group_len = np.diff(np.r_[starts, len(parent)])
    rank = np.arange(len(parent)) - np.repeat(starts, group_len)
    return [(order[rank == j], sorted_parent[rank == j])
            for j in range(int(rank.max()) + 1 if len(parent) else 0)]


def _bucket_loop(side: _Side, params: ALSParams, entries_per_step: int,
                 entries_budget: Optional[int], gather, solve,
                 device: torch.device) -> None:
    """One half-step's bucket loop over a side's slabs in slot order:
    ``gather(cols)`` → [R, C, k] counterpart rows, then per-row grams and
    right-hand sides written 512 rows at a time into bucket-wide solve
    buffers; ``solve(a, b, lo)`` takes each buffer's systems, whose rows
    start at slot ``lo`` of the side. The heavy bucket materializes its
    grams, adds its virtual rows' in the fixed passes of
    :func:`overflow_merge_passes` and is solved in one call."""
    k = params.rank
    rows_fn = (_grams_rows_bf16 if params.compute_dtype == "bfloat16"
               else _grams_rows)

    def grams(cols, vals, out=None):
        return rows_fn(gather(cols), vals, implicit=params.implicit_prefs,
                       alpha=params.alpha, out=out)

    def slab_normal_eq(colb, valb):
        # grams/rhs of a whole slab, chunked so the gather stays bounded
        R, C = colb.shape
        step = max(1, min(R, entries_per_step // max(C, 1)))
        parts = [grams(colb[s:s + step],
                       None if valb is None else valb[s:s + step])
                 for s in range(0, R, step)]
        return (torch.cat([a for a, _ in parts]),
                torch.cat([b for _, b in parts]))

    plan = side.plan
    n_fused = len(plan.lengths) - (1 if plan.has_heavy_bucket else 0)
    base = 0
    for bi in range(n_fused):
        colb = side.cols[bi]
        valb = None if side.vals is None else side.vals[bi]
        R, C = colb.shape
        chunk_r = min(_fused_chunk_rows(C, k, entries_budget,
                                        _elem_bytes(params)), max(R, 1))
        buf_r = _solve_buffer_rows(R, chunk_r, k)
        if R:
            a_buf = torch.empty((buf_r, k, k), dtype=torch.float32,
                                device=device)
            b_buf = torch.empty((buf_r, k), dtype=torch.float32,
                                device=device)
        for s0 in range(0, R, buf_r):
            m = min(buf_r, R - s0)
            for s in range(s0, s0 + m, chunk_r):
                e = min(s + chunk_r, s0 + m)
                grams(colb[s:e], None if valb is None else valb[s:e],
                      out=(a_buf[s - s0:e - s0], b_buf[s - s0:e - s0]))
            solve(a_buf[:m], b_buf[:m], base + s0)
        base += R

    if plan.has_heavy_bucket:
        colb = side.cols[n_fused]
        valb = None if side.vals is None else side.vals[n_fused]
        a, b = slab_normal_eq(colb, valb)
        vg, vr = slab_normal_eq(side.v_cols, side.v_vals)
        # merge overflow chunks into their parent rows (all in this, the
        # last, bucket: re-base the slots), one pass per chunk rank
        for src, dst in side.v_passes:
            a.index_add_(0, dst - base, vg.index_select(0, src))
            b.index_add_(0, dst - base, vr.index_select(0, src))
        solve(a, b, base)


class ALSTrainer:
    """The training state of one ALS run: layout, slabs and both factor
    matrices on ``device``. :func:`train_als` is the one-call form.

    ``upload_seconds``: the host → device copies of the slabs and the
    initial factors, the device synchronized (the layout is not in it).
    """

    def __init__(self, user_idx, item_idx, rating, n_users: int,
                 n_items: int, params: ALSParams,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        if params.binary_ratings is None:
            params = dataclasses.replace(
                params,
                binary_ratings=bool(np.all(np.asarray(rating) == 1.0)))
        self.params, self.entries_per_step = _resolve_params(params)
        self.entries_budget = (self.entries_per_step
                               if self.params.chunk_tiles > 0 else None)
        self.binary = bool(self.params.binary_ratings)
        self.n_users, self.n_items = int(n_users), int(n_items)
        plan_u, plan_i, arrs_u, arrs_i = plan_and_fill_both(
            user_idx, item_idx, rating, self.n_users, self.n_items,
            fill_vals=not self.binary)
        self.plan_u, self.plan_i = plan_u, plan_i
        x0, y0 = _fresh_init(self.params, plan_u, plan_i, self.n_users,
                             self.n_items)
        lam_u = _host_lam(plan_u, self.params)
        lam_i = _host_lam(plan_i, self.params)
        t0 = time.perf_counter()
        self.side_u = _Side(plan_u, arrs_u, lam_u, self.params, self.device,
                            col_sentinel=plan_i.total_slots)
        self.side_i = _Side(plan_i, arrs_i, lam_i, self.params, self.device,
                            col_sentinel=plan_u.total_slots)
        k = self.params.rank
        # one trailing all-zero sentinel row: padding slot indices gather 0s
        self.x = torch.zeros((plan_u.total_slots + 1, k), dtype=torch.float32,
                             device=self.device)
        self.y = torch.zeros((plan_i.total_slots + 1, k), dtype=torch.float32,
                             device=self.device)
        self.set_slot_factors(x0, y0)
        _sync(self.device)
        self.upload_seconds = time.perf_counter() - t0

    def set_slot_factors(self, x0: np.ndarray, y0: np.ndarray) -> None:
        """Load slot-order factors (no sentinel row) onto the device."""
        self.x[:-1] = torch.from_numpy(np.ascontiguousarray(x0)).to(self.device)
        self.y[:-1] = torch.from_numpy(np.ascontiguousarray(y0)).to(self.device)

    def slot_factors(self) -> tuple[np.ndarray, np.ndarray]:
        """Both factor matrices in slot order, on the host (no sentinel)."""
        return self.x[:-1].cpu().numpy(), self.y[:-1].cpu().numpy()

    def finite(self) -> bool:
        """Whether both factor matrices are finite: reduced on the device,
        one scalar read back."""
        with torch.no_grad():
            return bool(torch.isfinite(self.x).all()
                        & torch.isfinite(self.y).all())

    def solve_calls_per_iteration(self) -> int:
        """SPD-solve calls (kernel launches on the card, rank ≤ 128) per
        iteration: both half-steps."""
        return (solve_calls_per_half_step(self.plan_u, self.params)
                + solve_calls_per_half_step(self.plan_i, self.params))

    def _half_step(self, y: torch.Tensor, side: _Side, out: torch.Tensor):
        """Solve one side's factors against ``y`` (counterpart + sentinel
        row) into ``out[:total_slots]``, bucket by bucket in slot order."""
        k = self.params.rank
        y_cd, yty = _compute_rows(y, self.params)

        def gather(cols):
            R, C = cols.shape
            return y_cd.index_select(0, _widen(cols).reshape(-1)).view(R, C, k)

        def solve(a, b, lo):
            out[lo:lo + a.shape[0]] = _ridge_solve(
                a, b, side.lam[lo:lo + a.shape[0]], yty)

        _bucket_loop(side, self.params, self.entries_per_step,
                     self.entries_budget, gather, solve, y.device)

    def iterate(self, n: int) -> None:
        """Run ``n`` ALS iterations (user half-step, then item half-step)."""
        with torch.no_grad():
            for _ in range(int(n)):
                self._half_step(self.y, self.side_u, self.x)
                self._half_step(self.x, self.side_i, self.y)

    def factors(self) -> ALSFactors:
        x, y = self.slot_factors()
        return ALSFactors(
            user_factors=x[self.plan_u.slot_of_row],
            item_factors=y[self.plan_i.slot_of_row],
            n_users=self.n_users, n_items=self.n_items)


def _restore(trainer: ALSTrainer, hook, fingerprint: int) -> int:
    """The reference's resume rules (als.py:810-842): restore the latest
    snapshot below ``num_iterations`` into the trainer; returns the
    iteration to start from."""
    n_iters = trainer.params.num_iterations
    step = hook.latest_step()
    if step is None:
        return 0
    if step >= n_iters:
        # snapshots are never written at the final iteration, so a step at
        # or past it means num_iterations was lowered since that run
        raise CheckpointIncompatibleError(
            f"latest checkpoint is at iteration {step} but only "
            f"{n_iters} iterations were requested; the "
            "snapshot is from a run with more iterations — retrain from "
            "scratch or raise num_iterations")
    k = trainer.params.rank
    x_shape = (trainer.plan_u.total_slots, k)
    y_shape = (trainer.plan_i.total_slots, k)
    start, tree = hook.restore(step)
    rx, ry = tree["user_factors"], tree["item_factors"]
    if rx.shape != x_shape or ry.shape != y_shape:
        raise CheckpointIncompatibleError(
            f"checkpoint shapes {rx.shape}/{ry.shape} do not match the "
            f"current data layout {x_shape}/{y_shape}; the event data "
            "changed since the interrupted run — retrain from scratch")
    if int(np.asarray(tree.get("fingerprint", -1))) != fingerprint:
        raise CheckpointIncompatibleError(
            "checkpoint was written against different rating data "
            "(fingerprint mismatch); the event store changed since "
            "the interrupted run — retrain from scratch")
    t0 = time.perf_counter()
    trainer.set_slot_factors(rx, ry)
    _sync(trainer.device)
    trainer.upload_seconds += time.perf_counter() - t0
    return start


def train_als(user_idx: np.ndarray, item_idx: np.ndarray, rating: np.ndarray,
              n_users: int, n_items: int, params: ALSParams,
              device: "str | torch.device" = "cuda",
              checkpoint_hook=None, resume: bool = False,
              timings: Optional[dict] = None, nan_guard: bool = False,
              nan_guard_stage: str = "algorithm[als]") -> ALSFactors:
    """Train explicit/implicit ALS from a COO rating triple on ``device``.

    ``checkpoint_hook`` (:class:`..workflow.checkpoint.CheckpointHook`):
    when enabled, the loop runs in ``every_n``-iteration chunks and saves
    the slot-order factors (and the data :func:`layout_fingerprint`) at
    each chunk boundary but the last; the math is that of one unchunked
    run. ``resume=True`` restores the latest snapshot and runs only the
    remaining iterations; a snapshot of other data, another shape, or at or
    past ``num_iterations`` raises ``CheckpointIncompatibleError``.

    ``nan_guard``: one iteration at a time, with one scalar read back per
    iteration (both factor matrices finite), raising ``NaNGuardError``
    naming ``nan_guard_stage`` and the iteration. Snapshots keep their
    chunk schedule.

    In a gang (a process group of more than one rank) every rank passes
    the same whole triple and the train runs on the slab gang
    (:func:`_train_als_merged`, the reference's multi-process ``train_als``).

    ``timings``: a dict that receives ``upload_seconds`` (host → device
    copies of the slabs and initial factors), ``compile_seconds`` (the
    counterpart of the reference's XLA compile: building or loading the
    CUDA kernel library at first use, near zero once it is loaded, and 0
    on the CPU) and ``device_train_seconds`` (every iteration, the device
    synchronized after the last). Filled only without the NaN guard and
    with at most one chunk left, as in the reference.
    """
    if process_count() > 1:
        return _train_als_merged(
            user_idx, item_idx, rating, n_users, n_items, params,
            device=device, checkpoint_hook=checkpoint_hook, resume=resume,
            timings=timings, nan_guard=nan_guard,
            nan_guard_stage=nan_guard_stage)
    trainer = ALSTrainer(user_idx, item_idx, rating, n_users, n_items,
                         params, device=device)
    n_iters = trainer.params.num_iterations
    fingerprint = None
    start = 0
    if checkpoint_hook is not None:
        fingerprint = layout_fingerprint(trainer.plan_u, trainer.plan_i,
                                         user_idx, item_idx, rating)
        if resume:
            start = _restore(trainer, checkpoint_hook, fingerprint)

    def save(step: int) -> None:
        x, y = trainer.slot_factors()
        checkpoint_hook.save(step, {"user_factors": x, "item_factors": y,
                                    "fingerprint": np.int64(fingerprint)})

    chunk = (checkpoint_hook.every_n
             if checkpoint_hook is not None and checkpoint_hook.enabled else 0)
    if nan_guard or (chunk and n_iters - start > chunk):
        _checkpointed_loop(trainer, start, chunk, save, nan_guard,
                           nan_guard_stage)
    elif timings is None:
        trainer.iterate(n_iters - start)
        gang.beat()
    else:
        timings["upload_seconds"] = trainer.upload_seconds
        t0 = time.perf_counter()
        if trainer.device.type == "cuda" and trainer.params.rank <= MAX_GJ_K:
            build_kernel()
        timings["compile_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trainer.iterate(n_iters - start)
        _sync(trainer.device)
        timings["device_train_seconds"] = time.perf_counter() - t0
        gang.beat()
    return trainer.factors()


def _checkpointed_loop(trainer, start: int, chunk: int, save, nan_guard: bool,
                       nan_guard_stage: str) -> None:
    """The NaN-guarded (one iteration per dispatch) or chunked
    (``chunk`` iterations per dispatch) training loop of both trainers,
    with the reference's gang hooks (als.py:925-983): the ``train.sweep``
    fault point before each dispatch, a heartbeat after each dispatch and
    each save, and at each boundary before the last the gang-wide drain
    flag — a drain saves (when this boundary has no snapshot yet) and
    raises :class:`..parallel.supervisor.GangDrainRequested`. Every rank
    of a gang takes the same branches at the same iterations."""
    n_iters = trainer.params.num_iterations
    if nan_guard:
        for it in range(start, n_iters):
            fault_point("train.sweep")
            trainer.iterate(1)
            gang.beat()  # after the dispatch: the first sweep is the slowest
            if not trainer.finite():
                raise NaNGuardError(
                    f"stage: {nan_guard_stage}, iteration {it + 1}: "
                    "non-finite factors (check input ratings for NaN/Inf "
                    "or raise the regularization)")
            done = it + 1
            saved = False
            if chunk and done % chunk == 0 and done < n_iters:
                save(done)
                saved = True
                gang.beat()
            # one dispatch per iteration: a drain honours EVERY boundary;
            # one off the snapshot cadence writes its own snapshot
            if done < n_iters and gang.drain_requested_global():
                if chunk and not saved:
                    save(done)
                raise gang.GangDrainRequested(done)
        return
    it = start
    while it < n_iters:
        fault_point("train.sweep")
        n = min(chunk, n_iters - it)
        trainer.iterate(n)
        gang.beat()
        it += n
        if it < n_iters:
            save(it)
            gang.beat()  # a save (and its barrier) can be slow too
            if gang.drain_requested_global():
                raise gang.GangDrainRequested(it)


class SlabGangALS:
    """One rank of the multi-process slab trainer on a ``(d, m)`` mesh of
    one device per rank (the reference's ``_make_train_fn`` :417 with
    ``_half_step_local`` :297 on a multi-process mesh).

    The layout is planned for ``d`` data shards with rows per shard
    divisible by ``m``; rank ``(di, mi)`` holds data shard ``di``'s slabs of
    both sides (``arrs_u``/``arrs_i``: one shard each) and solves that
    shard's slots with the single-process bucket loop (:func:`_bucket_loop`:
    the same 512-row chunks, solve buffers and heavy-bucket merge passes).

    - 1-D (``m = 1``): the counterpart is replicated (its slot matrix plus
      the zero sentinel row).
    - 2-D (the ALX layout): the counterpart is held as model block ``mi``,
      ``total_slots / m`` rows, plus one zero row that every slot outside
      the block (the sentinel too) gathers. The partial grams and
      right-hand sides are all-reduced over the model group (the ``m``
      ranks of data row ``di``) once per solve buffer, before the ridge and
      the solve; YᵀY of implicit feedback is the model group's sum of the
      blocks' YᵀY.

    After each half-step every rank gives its ``1/m`` part of its shard's
    solution to one all-gather over the gang: in rank order the parts are
    the slot matrix, which every rank keeps on the host (the snapshots,
    the NaN probe and the result read it) and uploads its block of (all of
    it when ``m = 1``). Every rank makes the same collectives in the same
    order: the bucket rows per shard, the solve buffers and the heavy
    bucket are the plan's, identical on every shard, and nothing in a
    rank's own data changes them.
    """

    def __init__(self, plan_u: LayoutPlan, plan_i: LayoutPlan,
                 arrs_u: BucketArrays, arrs_i: BucketArrays,
                 n_users: int, n_items: int, params: ALSParams,
                 dims: tuple[int, int],
                 device: "str | torch.device" = "cuda"):
        from ..parallel.mesh import mesh_coords, mesh_groups

        self.device = resolve_device(device)
        self.params, self.entries_per_step = _resolve_params(params)
        self.entries_budget = (self.entries_per_step
                               if self.params.chunk_tiles > 0 else None)
        self.binary = bool(self.params.binary_ratings)
        self.n_users, self.n_items = int(n_users), int(n_items)
        self.plan_u, self.plan_i = plan_u, plan_i
        self.d, self.m = dims
        self.rank = process_index()
        self.di, self.mi = mesh_coords(self.rank, dims)
        self.model_group, _ = mesh_groups(dims)
        self.coll = HostCollectives()
        di = self.di

        def local(plan: LayoutPlan, arrs, cp: LayoutPlan) -> _Side:
            rps, rv = plan.rows_per_shard, plan.v_rows_per_shard
            lam = _host_lam(plan, self.params)[di * rps:(di + 1) * rps]
            # this shard's virtual rows: its real ones first, then padding
            # up to the busiest shard's count (all-sentinel rows whose
            # zero grams merge nowhere)
            mine = plan.shard_of_row(np.arange(plan.n_rows)) == di
            n_real = int(plan.v_chunks_of_row[mine].sum())
            return _Side(plan, arrs, lam, self.params, self.device,
                         col_sentinel=cp.total_slots,
                         v_parent=plan.v_parent[di * rv:di * rv + n_real])

        t0 = time.perf_counter()
        self.side_u = local(plan_u, arrs_u, plan_i)
        self.side_i = local(plan_i, arrs_i, plan_u)
        k = self.params.rank
        # the device's factor storage: this rank's block of each slot
        # matrix (all of it when m = 1) and a trailing zero row
        self.x = torch.zeros((plan_u.total_slots // self.m + 1, k),
                             dtype=torch.float32, device=self.device)
        self.y = torch.zeros((plan_i.total_slots // self.m + 1, k),
                             dtype=torch.float32, device=self.device)
        self.x_host = np.zeros((plan_u.total_slots, k), np.float32)
        self.y_host = np.zeros((plan_i.total_slots, k), np.float32)
        _sync(self.device)
        self.upload_seconds = time.perf_counter() - t0
        self.half_steps = 0
        self.gram_seconds = self.solve_seconds = 0.0

    @property
    def factor_bytes_resident(self) -> int:
        """Bytes of factor storage on this rank's device (both sides)."""
        return (self.x.numel() + self.y.numel()) * 4

    def _upload(self, dev: torch.Tensor, host: np.ndarray) -> None:
        rows = dev.shape[0] - 1
        lo = self.mi * rows
        dev[:rows] = torch.from_numpy(
            np.ascontiguousarray(host[lo:lo + rows])).to(self.device)

    def set_slot_factors(self, x0: np.ndarray, y0: np.ndarray) -> None:
        """Load slot-order factors (every rank the same) onto the device."""
        self.x_host = np.array(x0, np.float32, copy=True)
        self.y_host = np.array(y0, np.float32, copy=True)
        self._upload(self.x, self.x_host)
        self._upload(self.y, self.y_host)

    def slot_factors(self) -> tuple[np.ndarray, np.ndarray]:
        """Both slot matrices as the last all-gathers left them (host)."""
        return self.x_host, self.y_host

    def finite(self) -> bool:
        """Whether both factor matrices are finite: every rank holds the
        same host copies, so every rank answers alike."""
        return bool(np.isfinite(self.x_host).all()
                    and np.isfinite(self.y_host).all())

    def solve_calls_per_iteration(self) -> int:
        """SPD-solve calls (kernel launches on the card, rank ≤ 128) of
        this rank per iteration: its shard of both sides."""
        return (solve_calls_per_half_step(self.plan_u, self.params, 1)
                + solve_calls_per_half_step(self.plan_i, self.params, 1))

    def _model_sum(self, t: torch.Tensor) -> None:
        if self.m > 1:
            self.coll.all_reduce(t, self.model_group)

    def _half_step(self, y: torch.Tensor, side: _Side) -> np.ndarray:
        """Solve this rank's shard of one side against its counterpart
        storage ``y``; returns the side's slot matrix (host, all-gathered)."""
        k = self.params.rank
        rps = side.plan.rows_per_shard
        dev = y.device
        cp_rows = y.shape[0] - 1  # the counterpart block's slot rows
        cp_lo = self.mi * cp_rows
        y_cd, yty = _compute_rows(y, self.params)
        if yty is not None:
            self._model_sum(yty)

        def gather(cols):
            R, C = cols.shape
            idx = _widen(cols).reshape(-1)
            if self.m > 1:
                # slots outside this block (the sentinel too) → the zero row
                lc = idx - cp_lo
                idx = torch.where((lc >= 0) & (lc < cp_rows), lc, cp_rows)
            return y_cd.index_select(0, idx).view(R, C, k)

        clock = [time.perf_counter()]

        def solve(a, b, lo):
            # the clocks split the half-step: gram build | sums | solve
            _sync(dev)
            t1 = time.perf_counter()
            self.gram_seconds += t1 - clock[0]
            self._model_sum(a)
            self._model_sum(b)
            t2 = time.perf_counter()
            x[lo:lo + a.shape[0]] = _ridge_solve(
                a, b, side.lam[lo:lo + a.shape[0]], yty)
            _sync(dev)
            clock[0] = time.perf_counter()
            self.solve_seconds += clock[0] - t2

        x = torch.empty((rps, k), dtype=torch.float32, device=dev)
        _bucket_loop(side, self.params, self.entries_per_step,
                     self.entries_budget, gather, solve, dev)
        # the re-shard: rank (di, mi) gives rows [mi·rps/m, (mi+1)·rps/m)
        # of shard di; in rank order the parts are the slot matrix
        part = rps // self.m
        self.half_steps += 1
        return self.coll.all_gather(
            x[self.mi * part:(self.mi + 1) * part]).numpy()

    def iterate(self, n: int) -> None:
        """Run ``n`` ALS iterations (user half-step, then item half-step).
        Collective."""
        with torch.no_grad():
            for _ in range(int(n)):
                self.x_host = self._half_step(self.y, self.side_u)
                self._upload(self.x, self.x_host)
                self.y_host = self._half_step(self.x, self.side_i)
                self._upload(self.y, self.y_host)

    def factors(self) -> ALSFactors:
        return ALSFactors(
            user_factors=self.x_host[self.plan_u.slot_of_row],
            item_factors=self.y_host[self.plan_i.slot_of_row],
            n_users=self.n_users, n_items=self.n_items)

    def collective_report(self) -> dict:
        """The half-steps' collectives (the model group's all-reduces of
        the partial grams and the all-gather of the solution: calls, bytes
        and seconds, in total and per half-step), the gram build and the
        ridge + solves (each to a synchronized device), and this rank's
        place on the mesh."""
        n = max(self.half_steps, 1)
        return {"world": self.d * self.m, "rank": self.rank,
                "mesh": [self.d, self.m], "coords": [self.di, self.mi],
                "half_steps": self.half_steps,
                "gram_seconds_per_half_step": self.gram_seconds / n,
                "solve_seconds_per_half_step": self.solve_seconds / n,
                **self.coll.report(self.half_steps),
                "factor_bytes_resident": self.factor_bytes_resident,
                "upload_seconds": self.upload_seconds,
                "solve_calls_per_iteration": self.solve_calls_per_iteration()}


def _plan_signature(plan: LayoutPlan) -> tuple:
    """What a rank's collectives depend on for one side (the reference's
    ``_plan_signature``, als.py:546)."""
    return (tuple(int(x) for x in plan.lengths),
            tuple(int(x) for x in plan.bucket_rows),
            plan.rows_per_shard, plan.n_shards, plan.v_rows_per_shard,
            plan.overflow_len, plan.total_slots)


def _crc_of(values) -> int:
    return zlib.crc32(repr(tuple(values)).encode("ascii"))


def _disagree(what: str, got: np.ndarray) -> None:
    """Raise when the all-gathered rows (one per rank) differ."""
    if not (got == got[:1]).all():
        raise ValueError(
            f"the gang's ranks disagree on {what}: "
            + "; ".join(f"rank {r}: {[int(v) for v in row]}"
                        for r, row in enumerate(got))
            + " — every rank must run the same code on the same event "
            "store with the same PIO_MESH_SHAPE")


#: what :func:`_header` covers, for the error that names a disagreement
_HEADER_WHAT = ("the plan signature's inputs (n_users, n_items, d, m, rank, "
                "overflow length, ladder growth, params)")


def _header(n_users: int, n_items: int, dims, params: ALSParams) -> list:
    """The inputs every rank's plan and program depend on. The port fixes
    the ladder growth, so the reference's PIO_ALS_LADDER_GROWTH check
    (als.py:1092-1109) becomes a part of this signature."""
    growth = int(np.frombuffer(np.float64(LADDER_GROWTH).tobytes(),
                               np.int64)[0])
    return [int(n_users), int(n_items), int(dims[0]), int(dims[1]),
            int(params.rank), OVERFLOW_LEN, growth,
            _crc_of(dataclasses.astuple(params))]


def _plan_crc(plan_u: LayoutPlan, plan_i: LayoutPlan) -> list:
    return [_crc_of(_plan_signature(plan_u) + _plan_signature(plan_i))]


def _gang_loop(trainer, checkpoint_hook, resume: bool, fingerprint,
               nan_guard: bool, nan_guard_stage: str,
               timings: Optional[dict], extra: dict) -> ALSFactors:
    """Resume, then the chunked, NaN-guarded or single-dispatch loop of a
    slab gang with the reference's gang hooks; rank 0 writes the
    snapshots (:class:`..workflow.checkpoint.CheckpointHook` in a gang).
    ``timings`` receives the trainer's collective report, ``extra`` and
    the loop's seconds and snapshots."""
    n_iters = trainer.params.num_iterations
    start = 0
    if checkpoint_hook is not None and resume:
        start = _restore(trainer, checkpoint_hook, fingerprint)
    saves = [0, 0.0]

    def save(step: int) -> None:
        t = time.perf_counter()
        x, y = trainer.slot_factors()
        checkpoint_hook.save(step, {"user_factors": x, "item_factors": y,
                                    "fingerprint": np.int64(fingerprint)})
        saves[0] += 1
        saves[1] += time.perf_counter() - t

    chunk = (checkpoint_hook.every_n
             if checkpoint_hook is not None and checkpoint_hook.enabled else 0)
    t0 = time.perf_counter()
    if nan_guard or (chunk and n_iters - start > chunk):
        _checkpointed_loop(trainer, start, chunk, save, nan_guard,
                           nan_guard_stage)
    else:
        fault_point("train.sweep")
        trainer.iterate(n_iters - start)
        gang.beat()
    _sync(trainer.device)
    if timings is not None:
        timings.update(trainer.collective_report(), **extra,
                       device_train_seconds=time.perf_counter() - t0,
                       checkpoint_saves=saves[0],
                       checkpoint_save_seconds=saves[1])
    return trainer.factors()


def _train_als_merged(user_idx, item_idx, rating, n_users: int, n_items: int,
                      params: ALSParams, device="cuda", checkpoint_hook=None,
                      resume: bool = False, timings: Optional[dict] = None,
                      nan_guard: bool = False,
                      nan_guard_stage: str = "algorithm[als]") -> ALSFactors:
    """:func:`train_als` on a gang (the merged feed): every rank passes the
    same whole triple, as every process of the reference's multi-process
    ``train_als`` holds it (als.py:853-867). The layout is planned for the
    ``(d, m)`` mesh of :func:`..parallel.mesh.mesh_dims`; each rank fills
    and uploads only its data shard's slabs and holds its share of the
    counterpart (:class:`SlabGangALS`). The resume fingerprint is the
    single-process one (:func:`layout_fingerprint`), which every rank
    computes from the same triple."""
    from ..parallel.mesh import mesh_coords, mesh_dims

    dims = mesh_dims()
    di, _ = mesh_coords(dims=dims)
    if params.binary_ratings is None:
        params = dataclasses.replace(
            params, binary_ratings=bool(np.all(np.asarray(rating) == 1.0)))
    _disagree(_HEADER_WHAT, all_gather_int64s(
        _header(n_users, n_items, dims, params)))
    t0 = time.perf_counter()
    plan_u, plan_i, arrs_u, arrs_i = plan_and_fill_both(
        user_idx, item_idx, rating, int(n_users), int(n_items),
        fill_vals=not params.binary_ratings, n_shards=dims[0],
        m_div=dims[1], shard=di)
    layout_s = time.perf_counter() - t0
    _disagree("the plan signature",
              all_gather_int64s(_plan_crc(plan_u, plan_i)))
    trainer = SlabGangALS(plan_u, plan_i, arrs_u, arrs_i, n_users, n_items,
                          params, dims, device=device)
    trainer.set_slot_factors(*_fresh_init(trainer.params, plan_u, plan_i,
                                          int(n_users), int(n_items)))
    fingerprint = (layout_fingerprint(plan_u, plan_i, user_idx, item_idx,
                                      rating)
                   if checkpoint_hook is not None else None)
    return _gang_loop(trainer, checkpoint_hook, resume, fingerprint,
                      nan_guard, nan_guard_stage, timings,
                      {"layout_seconds": layout_s, "feed": "merged",
                       "local_ratings": int(len(rating))})


def process_row_ranges(n_rows: int, dims: Optional[tuple[int, int]] = None
                       ) -> tuple[int, int]:
    """``[row0, row1)`` of the rows this rank owns on the data axis of the
    ``(d, m)`` mesh (default :func:`..parallel.mesh.mesh_dims`): each rank
    of a process-sharded train range-reads only the events whose solved-
    side row falls in its range (one range per side). The reference's
    rule (als.py:996) gives each process ``d / processes`` consecutive
    shards; with one device per rank the ``m`` ranks of data row ``di``
    share shard ``di``'s range. Logical row ids; ``row1`` may pass
    ``n_rows`` on the last shard."""
    from ..parallel.mesh import mesh_coords, mesh_dims

    dims = dims or mesh_dims()
    di, _ = mesh_coords(dims=dims)
    rpl = -(-int(n_rows) // dims[0])
    return di * rpl, (di + 1) * rpl


def train_als_process_sharded(
    user_slice: tuple, item_slice: tuple, n_users: int, n_items: int,
    params: ALSParams, device: "str | torch.device" = "cuda",
    checkpoint_hook=None, resume: bool = False, nan_guard: bool = False,
    nan_guard_stage: str = "algorithm[als]",
    timings: Optional[dict] = None,
) -> ALSFactors:
    """Gang ALS where each rank ingests ONLY its shard (the reference's
    ``train_als_process_sharded``, als.py:1022): ``user_slice`` =
    ``(user_idx, item_idx, rating)`` of exactly the events whose USER row
    this rank owns (:func:`process_row_ranges` of ``n_users``),
    ``item_slice`` the same tuple order for the ITEM rows it owns.

    One fixed-size all-gather first checks that the ranks agree on what
    the plan depends on and that every rank's rows lie in its range: a
    rank fed other rows raises the reference's message, its peers raise
    naming it, before any exchange whose size depends on the data. The
    layout is a pure function of the per-row counts: the data group's
    all-gather of each side's local counts gives every rank the identical
    global plan, whose signature is checked once more; each rank fills
    only its data shard. All-ones ratings are the gang's AND of the
    ranks' verdicts. The fingerprint chains the all-gathered per-rank
    crc32s with both count vectors (als.py:1179-1201). Factors match
    :func:`train_als` of the union triple up to float32 summation order."""
    from ..parallel.mesh import mesh_coords, mesh_dims, mesh_groups

    dims = mesh_dims()
    d, m = dims
    di, _ = mesh_coords(dims=dims)
    _, data_group = mesh_groups(dims)
    u_rows = np.asarray(user_slice[0], np.int64)
    i_rows = np.asarray(item_slice[1], np.int64)
    ranges = {"user": (u_rows, int(n_users)), "item": (i_rows, int(n_items))}
    ok = {}
    for side, (rows, n_rows) in ranges.items():
        lo, hi = process_row_ranges(n_rows, dims)
        ok[side] = not rows.size or (rows.min() >= lo and rows.max() < hi)
    local_bin = bool(np.all(np.asarray(user_slice[2]) == 1.0)
                     and np.all(np.asarray(item_slice[2]) == 1.0))
    head = _header(n_users, n_items, dims,
                   dataclasses.replace(params, binary_ratings=None))
    got = all_gather_int64s(head + [int(ok["user"]), int(ok["item"]),
                                    int(local_bin)])
    for side, (rows, n_rows) in ranges.items():
        if not ok[side]:
            lo, hi = process_row_ranges(n_rows, dims)
            raise ValueError(
                "sharded ingest: got rows outside this process's range "
                f"[{lo}, {hi}) — the caller must range-read only owned "
                f"rows (process_row_ranges); got rows in [{rows.min()}, "
                f"{rows.max()}] (n_rows={n_rows}, p={process_index()}, "
                f"n_local=1, d={d}; {side} side)")
    bad = [r for r, row in enumerate(got) if not (row[-3] and row[-2])]
    if bad:
        raise ValueError(f"sharded ingest: rank(s) {bad} got rows outside "
                         "their range (process_row_ranges)")
    _disagree(_HEADER_WHAT, got[:, :len(head)])
    if params.binary_ratings is None:
        params = dataclasses.replace(params,
                                     binary_ratings=bool(got[:, -1].all()))
    binary = bool(params.binary_ratings)
    coll = HostCollectives()
    t0 = time.perf_counter()

    def global_counts(side: str) -> np.ndarray:
        rows, n_rows = ranges[side]
        lo, hi = process_row_ranges(n_rows, dims)
        local = torch.from_numpy(np.bincount(
            rows - lo, minlength=hi - lo)[:hi - lo].astype(np.int64))
        if d > 1:
            local = coll.all_gather(local, data_group)
        return local.numpy()[:n_rows]

    counts_u, counts_i = global_counts("user"), global_counts("item")
    plan_u = plan_layout(counts_u, d, m_div=m)
    plan_i = plan_layout(counts_i, d, m_div=m)
    _disagree("the plan signature",
              all_gather_int64s(_plan_crc(plan_u, plan_i)))
    arrs_u = fill_buckets(plan_u, user_slice[0], user_slice[1], user_slice[2],
                          col_slot_map=plan_i.slot_of_row,
                          sentinel=plan_i.total_slots, fill_vals=not binary,
                          shard0=di, n_local_shards=1)
    arrs_i = fill_buckets(plan_i, item_slice[1], item_slice[0], item_slice[2],
                          col_slot_map=plan_u.slot_of_row,
                          sentinel=plan_u.total_slots, fill_vals=not binary,
                          shard0=di, n_local_shards=1)
    layout_s = time.perf_counter() - t0
    trainer = SlabGangALS(plan_u, plan_i, arrs_u, arrs_i, n_users, n_items,
                          params, dims, device=device)
    trainer.set_slot_factors(*_fresh_init(trainer.params, plan_u, plan_i,
                                          int(n_users), int(n_items)))
    fingerprint = None
    if checkpoint_hook is not None:
        layout_fp = zlib.crc32(plan_i.slot_of_row.tobytes(), zlib.crc32(
            plan_u.slot_of_row.tobytes(), _LAYOUT_TAG))
        local_fp = zlib.crc32(
            np.asarray(user_slice[2], np.float32).tobytes(),
            zlib.crc32(np.asarray(user_slice[1], np.int64).tobytes(),
                       zlib.crc32(u_rows.tobytes(), layout_fp)))
        all_fp = all_gather_int64s([local_fp]).reshape(-1)
        fingerprint = zlib.crc32(all_fp.tobytes(), zlib.crc32(
            np.asarray(counts_u).tobytes(),
            zlib.crc32(np.asarray(counts_i).tobytes(), layout_fp)))
    return _gang_loop(trainer, checkpoint_hook, resume, fingerprint,
                      nan_guard, nan_guard_stage, timings,
                      {"layout_seconds": layout_s, "feed": "process_sharded",
                       "counts_allgather_bytes": coll.bytes["allgather"],
                       "local_ratings": [int(len(user_slice[2])),
                                         int(len(item_slice[2]))]})


#: layout generation of the data-parallel trainer's resume fingerprint
#: (the reference's ``_DP_LAYOUT_TAG``): a snapshot of one trainer is
#: refused by the other even when the factor shapes coincide
_DP_LAYOUT_TAG = 0x70_10_10_01
#: cap on one chunk's [CH, k, k] per-event outer products
_DP_CHUNK_BYTES = 64 * 1024 * 1024


def _dp_chunk(n_events: int, k: int) -> int:
    """Events per gram chunk: the [CH, k, k] float32 outer products stay
    under ``_DP_CHUNK_BYTES``."""
    ch = max(512, _DP_CHUNK_BYTES // max(k * k * 4, 1))
    return min(ch, max(n_events, 1))


def dp_solve_calls_per_half_step(rows_per_rank: int, k: int) -> int:
    """SPD-solve calls ONE rank of the data-parallel trainer makes per
    half-step: its row block, in solve buffers of at most
    ``_SOLVE_BUFFER_BYTES`` of grams. On the card with k ≤ 128 each call is
    one launch of a Gauss-Jordan kernel."""
    buf = max(1, _SOLVE_BUFFER_BYTES // (k * k * 4))
    return -(-int(rows_per_rank) // buf)


def _sum_rows_(out: torch.Tensor, rows: torch.Tensor,
               vals: torch.Tensor) -> None:
    """``out[rows] += vals`` with repeated rows summed in a fixed order, so
    a resumed gang equals an uninterrupted one bit for bit. On the card
    ``index_add_`` sums repeated targets with atomics, in an order that
    varies from run to run; ``index_put_(accumulate=True)`` sorts the
    targets and sums each run in order (the kernel PyTorch's deterministic
    mode routes ``index_add_`` to, without that mode's global switch, whose
    first use imports ``torch._inductor``: seconds a process). On the CPU
    ``index_add_`` is the ordered one."""
    if out.device.type == "cuda":
        out.index_put_((rows,), vals, accumulate=True)
    else:
        out.index_add_(0, rows, vals)


class DataParallelALS:
    """The training state of one rank of the data-parallel trainer: this
    rank's events and the replicated (row-padded) factor matrices on
    ``device``. Every rank of the gang constructs it with its own triple
    and the same ``n_users``, ``n_items`` and ``params``; every call that
    follows is collective.

    Rows are padded to a multiple of the gang (``n_pad``); rank r solves
    rows ``[r·rps, (r+1)·rps)``. The ridge is the slab trainer's:
    λ (× the row's gang-wide count under ``nratings``) + 1e-6 on empty
    rows, plus YᵀY for implicit feedback. The init is drawn in global row
    order with the seed, as :func:`_fresh_init` draws it, so the gang
    tracks :func:`train_als` on the union triple row for row. There is no
    event padding: the torch loop has no static shapes, and no collective
    runs inside the chunk loop, so ranks with more or fewer events (or
    none) still take the same collectives in the same order."""

    def __init__(self, user_idx, item_idx, rating, n_users: int,
                 n_items: int, params: ALSParams,
                 device: "str | torch.device" = "cuda"):
        from ..parallel.mesh import data_axis_size, pad_rows

        self.device = resolve_device(device)
        self.world = data_axis_size()
        self.rank = process_index()
        # the gang must agree on one program: no per-rank detection of
        # all-ones ratings (the reference pins it the same way)
        if params.binary_ratings is None:
            params = dataclasses.replace(params, binary_ratings=False)
        self.params, _ = _resolve_params(params)
        self.n_users, self.n_items = int(n_users), int(n_items)
        u = np.asarray(user_idx, np.int64)
        i = np.asarray(item_idx, np.int64)
        r = np.asarray(rating, np.float32)
        if not len(u) == len(i) == len(r):
            raise ValueError("user, item and rating arrays differ in length")
        if u.size and (u.min() < 0 or u.max() >= self.n_users):
            raise ValueError("user_idx outside [0, n_users)")
        if i.size and (i.min() < 0 or i.max() >= self.n_items):
            raise ValueError("item_idx outside [0, n_items)")
        self.local = (u, i, r)
        k = self.params.rank
        w = self.world
        # the init, drawn in global row order, padded to the gang's rows
        rng = np.random.default_rng(self.params.seed)
        x0 = pad_rows((rng.standard_normal((self.n_users, k))
                       / np.sqrt(k)).astype(np.float32), w)
        y0 = pad_rows((rng.standard_normal((self.n_items, k))
                       / np.sqrt(k)).astype(np.float32), w)
        self.n_u_pad, self.n_i_pad = x0.shape[0], y0.shape[0]
        self.rps_u, self.rps_i = self.n_u_pad // w, self.n_i_pad // w
        self.chunk = _dp_chunk(len(u), k)
        self.coll = HostCollectives()

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.u, self.i = put(u), put(i)
        if self.params.implicit_prefs:
            # Hu-Koren-Volinsky per-entry weights (the slab trainer's)
            self.gw = put(self.params.alpha * r)
            self.bw = put(1.0 + self.params.alpha * r)
        else:
            self.gw, self.bw = None, put(r)
        if self.params.compute_dtype == "bfloat16":
            # the weights rounded once, as the reference rounds each
            # chunk's (als.py:1338-1363)
            self.gw, self.bw = (None if w is None else _bf16(w)
                                for w in (self.gw, self.bw))
        # per-row gang-wide observation counts, one all-reduce each
        cnt_u = self.coll.all_reduce(torch.bincount(
            self.u, minlength=self.n_u_pad).to(torch.float32))
        cnt_i = self.coll.all_reduce(torch.bincount(
            self.i, minlength=self.n_i_pad).to(torch.float32))
        self.lam_u = put(self._lam(cnt_u.cpu().numpy()))
        self.lam_i = put(self._lam(cnt_i.cpu().numpy()))
        self.set_factors(x0, y0)
        # the per-half-step accounting starts after the set-up exchange
        self.coll = HostCollectives()
        self.half_steps = 0
        self.gram_seconds = self.solve_seconds = 0.0

    def _lam(self, counts: np.ndarray) -> np.ndarray:
        """Per-row ridge weights from gang-wide counts (``_host_lam``)."""
        if self.params.lambda_scaling == "nratings":
            lam = self.params.reg * np.maximum(counts, 1.0)
        else:
            lam = np.full(counts.shape, self.params.reg, dtype=np.float32)
        return (lam + np.where(counts == 0, 1e-6, 0.0)).astype(np.float32)

    def fingerprint(self) -> int:
        """The gang-wide resume fingerprint (reference als.py:1547-1561):
        each rank's crc32 chain over its triple, all-gathered, chained with
        the matrix sizes. Collective."""
        u, i, r = self.local
        local_fp = zlib.crc32(r.tobytes(), zlib.crc32(
            i.tobytes(), zlib.crc32(u.tobytes(), _DP_LAYOUT_TAG)))
        all_fp = all_gather_int64s([local_fp]).reshape(-1)
        return zlib.crc32(all_fp.tobytes(), zlib.crc32(
            np.int64(self.n_users).tobytes(),
            zlib.crc32(np.int64(self.n_items).tobytes(), _DP_LAYOUT_TAG)))

    def set_factors(self, x0: np.ndarray, y0: np.ndarray) -> None:
        self.x = torch.from_numpy(np.ascontiguousarray(x0)).to(self.device)
        self.y = torch.from_numpy(np.ascontiguousarray(y0)).to(self.device)

    def padded_factors(self) -> tuple[np.ndarray, np.ndarray]:
        return self.x.cpu().numpy(), self.y.cpu().numpy()

    def finite(self) -> bool:
        """Whether both (replicated) factor matrices are finite: every rank
        holds the same bits, so every rank answers alike."""
        with torch.no_grad():
            return bool(torch.isfinite(self.x).all()
                        & torch.isfinite(self.y).all())

    def solve_calls_per_iteration(self) -> int:
        """SPD-solve calls (kernel launches on the card, rank ≤ 128) of
        this rank per iteration: both half-steps."""
        k = self.params.rank
        return (dp_solve_calls_per_half_step(self.rps_u, k)
                + dp_solve_calls_per_half_step(self.rps_i, k))

    def _half_step(self, y: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, lam: torch.Tensor, n_pad: int,
                   rps: int) -> torch.Tensor:
        """Solve one side against the replicated counterpart ``y``; returns
        the replicated solution [n_pad, k]."""
        k = self.params.rank
        dev = y.device
        t0 = time.perf_counter()
        y_cd, yty = _compute_rows(y, self.params)
        grams = torch.zeros((n_pad, k, k), dtype=torch.float32, device=dev)
        rhs = torch.zeros((n_pad, k), dtype=torch.float32, device=dev)
        ch = self.chunk
        for s in range(0, rows.shape[0], ch):
            e = min(s + ch, rows.shape[0])
            # [CH, k]; bfloat16 rows upcast: products of them are exact
            p = y_cd.index_select(0, cols[s:e]).float()
            pw = p if self.gw is None else p * self.gw[s:e, None]
            _sum_rows_(grams, rows[s:e], pw[:, :, None] * p[:, None, :])
            _sum_rows_(rhs, rows[s:e], p * self.bw[s:e, None])
        # (the all-reduce synchronizes the device anyway: these clocks
        # split the half-step at no cost)
        _sync(dev)
        t1 = time.perf_counter()
        # partition partials sum to the full normal equations
        self.coll.all_reduce(grams)
        self.coll.all_reduce(rhs)
        t2 = time.perf_counter()
        lo = self.rank * rps
        a, b = grams[lo:lo + rps], rhs[lo:lo + rps]
        if yty is not None:
            a += yty[None, :, :]  # shared YᵀY term
        a.diagonal(dim1=1, dim2=2).add_(lam[lo:lo + rps, None])
        out = torch.zeros((n_pad, k), dtype=torch.float32, device=dev)
        buf = max(1, _SOLVE_BUFFER_BYTES // (k * k * 4))
        for s in range(0, rps, buf):
            e = min(s + buf, rps)
            out[lo + s:lo + e] = batched_spd_solve(a[s:e], b[s:e])
        _sync(dev)
        self.gram_seconds += t1 - t0
        self.solve_seconds += time.perf_counter() - t2
        # the other ranks' rows are 0 here: the sum is the replicated
        # factor matrix, exactly
        self.half_steps += 1
        return self.coll.all_reduce(out)

    def iterate(self, n: int) -> None:
        """Run ``n`` ALS iterations (user half-step, then item half-step).
        Collective."""
        with torch.no_grad():
            for _ in range(int(n)):
                self.x = self._half_step(self.y, self.u, self.i, self.lam_u,
                                         self.n_u_pad, self.rps_u)
                self.y = self._half_step(self.x, self.i, self.u, self.lam_i,
                                         self.n_i_pad, self.rps_i)

    def factors(self) -> ALSFactors:
        x, y = self.padded_factors()
        return ALSFactors(user_factors=x[:self.n_users],
                          item_factors=y[:self.n_items],
                          n_users=self.n_users, n_items=self.n_items)

    def collective_report(self) -> dict:
        """What the half-steps so far moved over the gang — all-reduce bytes
        and seconds in total and per half-step — and where the rest of
        their time went: the gram build (gather, outer products,
        ``index_add_``) and the ridge + solves, each to a synchronized
        device."""
        n = max(self.half_steps, 1)
        return {"world": self.world, "rank": self.rank,
                "half_steps": self.half_steps,
                "gram_seconds_per_half_step": self.gram_seconds / n,
                "solve_seconds_per_half_step": self.solve_seconds / n,
                **self.coll.report(self.half_steps),
                "solve_calls_per_iteration": self.solve_calls_per_iteration()}


def train_als_partition_local(
    user_idx: np.ndarray, item_idx: np.ndarray, rating: np.ndarray,
    n_users: int, n_items: int, params: ALSParams,
    device: "str | torch.device" = "cuda",
    checkpoint_hook=None, resume: bool = False, nan_guard: bool = False,
    nan_guard_stage: str = "algorithm[als]", force_dp: bool = False,
    timings: Optional[dict] = None,
) -> ALSFactors:
    """ALS over PARTITION-LOCAL events: each rank of the gang passes only
    the triple its event-log partitions hold — any rows, any order,
    already mapped to the GLOBAL indices of the all-gathered id maps
    (``workflow/train_feed.py``). Per-row normal equations are linear in
    per-event contributions, so the partials all-reduce to the exact
    full-data equations (:class:`DataParallelALS`).

    One process calls :func:`train_als` (its data is complete locally)
    unless ``force_dp=True``, as in the reference (als.py:1470-1475).

    ``checkpoint_hook``/``resume``/``nan_guard``: the contracts of
    :func:`train_als` (snapshots of the padded replicated factors and the
    gang-wide fingerprint, written by rank 0 with a barrier after each
    save; every rank restores the same step; a snapshot of other data
    raises ``CheckpointIncompatibleError`` on every rank), plus the gang
    hooks. ``timings`` receives :meth:`DataParallelALS.collective_report`,
    ``device_train_seconds`` (the iterations and snapshots, the device
    synchronized) and the snapshots' count and seconds."""
    if process_count() == 1 and not force_dp:
        return train_als(user_idx, item_idx, rating, n_users, n_items,
                         params, device=device,
                         checkpoint_hook=checkpoint_hook, resume=resume,
                         timings=timings, nan_guard=nan_guard,
                         nan_guard_stage=nan_guard_stage)
    trainer = DataParallelALS(user_idx, item_idx, rating, n_users, n_items,
                              params, device=device)
    n_iters = trainer.params.num_iterations
    fingerprint = None
    start = 0
    if checkpoint_hook is not None:
        fingerprint = trainer.fingerprint()
        if resume:
            step = checkpoint_hook.latest_step()
            if step is not None and step < n_iters:
                start, tree = checkpoint_hook.restore(step)
                rx, ry = tree["user_factors"], tree["item_factors"]
                if (rx.shape != trainer.x.shape
                        or ry.shape != trainer.y.shape
                        or int(np.asarray(tree.get("fingerprint", -1)))
                        != fingerprint):
                    raise CheckpointIncompatibleError(
                        "checkpoint does not match the current partition-"
                        "local layout/data — retrain from scratch")
                trainer.set_factors(rx, ry)

    saves = [0, 0.0]

    def save(step: int) -> None:
        t = time.perf_counter()
        x, y = trainer.padded_factors()
        checkpoint_hook.save(step, {"user_factors": x, "item_factors": y,
                                    "fingerprint": np.int64(fingerprint)})
        saves[0] += 1
        saves[1] += time.perf_counter() - t

    chunk = (checkpoint_hook.every_n
             if checkpoint_hook is not None and checkpoint_hook.enabled else 0)
    t0 = time.perf_counter()
    if nan_guard or (chunk and n_iters - start > chunk):
        _checkpointed_loop(trainer, start, chunk, save, nan_guard,
                           nan_guard_stage)
    else:
        fault_point("train.sweep")
        trainer.iterate(n_iters - start)
        gang.beat()
    _sync(trainer.device)
    if timings is not None:
        timings.update(trainer.collective_report(),
                       device_train_seconds=time.perf_counter() - t0,
                       checkpoint_saves=saves[0],
                       checkpoint_save_seconds=saves[1])
    return trainer.factors()


def fold_in_factors(y, obs_idx, obs_val, *, reg: float,
                    lambda_scaling: str = "plain",
                    implicit_prefs: bool = False, alpha: float = 1.0,
                    anchor=None, anchor_weight=1.0, yty=None,
                    device: "str | torch.device" = "cuda") -> np.ndarray:
    """Closed-form ridge fold-in: solve R rows against the fixed
    counterpart factors ``y`` [n, k] — one ALS half-step for the touched
    rows only (the reference's ``fold_in_factors``, als.py:1673).

    ``obs_idx``: R arrays of counterpart row indices; ``obs_val``: R
    matching arrays of ratings. The rows are padded to the longest one
    with the index of a zero sentinel row, so the grams come out of
    :func:`_grams_rows` as in training, on ``device``; every system is then
    solved in one :func:`.spd_solve.batched_spd_solve` call (the CUDA
    kernel on the card, its plain version on the CPU).

    λ (× the row's count under ``lambda_scaling='nratings'``) + μ goes on
    the diagonal and μ·anchor on the right-hand side, μ =
    ``anchor_weight`` (scalar or per row, clipped at 0), only when an
    ``anchor`` [R, k] is given: without one there is no proximal term at
    all. ``implicit_prefs`` adds the whole counterpart's YᵀY (``yty`` [k, k]
    when the caller has it) with confidence weights 1 + α·r.

    Returns the solved rows, [R, k] float32 on the host.
    """
    dev = resolve_device(device)
    y_host = np.asarray(y, np.float32)
    n, k = y_host.shape
    R = len(obs_idx)
    if R == 0:
        return np.zeros((0, k), np.float32)
    lens = np.fromiter((len(ix) for ix in obs_idx), np.int64, count=R)
    C = int(lens.max(initial=0))
    if C == 0 or n == 0:
        return (np.asarray(anchor, np.float32).reshape(R, k)
                if anchor is not None else np.zeros((R, k), np.float32))
    # [R, C] index and value slabs, padding at the sentinel row n
    row = np.repeat(np.arange(R), lens)
    col = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    cols = np.full((R, C), n, np.int64)
    cols[row, col] = np.concatenate([np.asarray(ix, np.int64)
                                     for ix in obs_idx])
    vals = np.zeros((R, C), np.float32)
    vals[row, col] = np.concatenate([np.asarray(v, np.float32)
                                     for v in obs_val])
    lam = np.full(R, float(reg), np.float32)
    if lambda_scaling == "nratings":
        lam *= np.maximum(lens.astype(np.float32), 1.0)
    if anchor is None:
        mu = np.zeros(R, np.float32)
    else:
        mu = np.maximum(np.broadcast_to(
            np.asarray(anchor_weight, np.float32), (R,)), 0.0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with torch.no_grad():
        y_dev = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
        y_dev[:n] = put(y_host)
        cols_dev, vals_dev = put(cols), put(vals)
        a = torch.empty((R, k, k), dtype=torch.float32, device=dev)
        b = torch.empty((R, k), dtype=torch.float32, device=dev)
        step = _fused_chunk_rows(C, k, None)
        for s in range(0, R, step):
            e = min(s + step, R)
            p = y_dev.index_select(0, cols_dev[s:e].reshape(-1)).view(
                e - s, C, k)
            _grams_rows(p, vals_dev[s:e], implicit=implicit_prefs,
                        alpha=alpha, out=(a[s:e], b[s:e]))
        if implicit_prefs:
            a += (y_dev.T @ y_dev if yty is None
                  else put(np.asarray(yty, np.float32)))[None, :, :]
        a.diagonal(dim1=1, dim2=2).add_(put(lam + mu)[:, None])
        if anchor is not None:
            b += put(mu)[:, None] * put(
                np.asarray(anchor, np.float32).reshape(R, k))
        return batched_spd_solve(a, b).cpu().numpy()


def predict_rmse(factors: ALSFactors, user_idx, item_idx, rating) -> float:
    """Host-side RMSE over a COO triple (eval helper)."""
    x = factors.user_factors[np.asarray(user_idx)]
    y = factors.item_factors[np.asarray(item_idx)]
    pred = np.sum(x * y, axis=1)
    err = pred - np.asarray(rating, dtype=np.float32)
    return float(np.sqrt(np.mean(err**2)))
