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
left them to XLA. Only float32 compute is ported (``compute_dtype="auto"``
resolves to float32, the reference's rule off a TPU).

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
from ..workflow.checkpoint import CheckpointIncompatibleError
from .rowblocks import BucketArrays, LayoutPlan, plan_and_fill_both
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
    # "auto" → float32 (the reference's rule off a TPU); only float32 is ported
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
    if params.compute_dtype != "float32":
        raise ValueError(
            f"compute_dtype {params.compute_dtype!r} is not supported here; "
            "use 'auto' or 'float32'")
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


def _ridge_solve(a: torch.Tensor, b: torch.Tensor, lam: torch.Tensor,
                 yty: Optional[torch.Tensor]) -> torch.Tensor:
    """(+YᵀY) → +λ on the diagonal → batched SPD solve. Updates ``a`` in
    place (it is a temporary of the caller)."""
    if yty is not None:
        a += yty[None, :, :]  # shared YᵀY term (implicit feedback)
    a.diagonal(dim1=1, dim2=2).add_(lam[:, None])
    return batched_spd_solve(a, b)


def _fused_chunk_rows(C: int, k: int, entries_budget: Optional[int]) -> int:
    chunk_r = _FUSED_CHUNK_ROWS
    while chunk_r > 64 and chunk_r * C * k * 4 > _FUSED_SLAB_BYTES:
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


def solve_calls_per_half_step(plan: LayoutPlan, params: ALSParams) -> int:
    """SPD-solve calls one half-step makes on this side: the solve buffers
    of every non-heavy bucket plus one for the heavy bucket. On the card
    with rank ≤ 128 each call is one launch of a Gauss-Jordan kernel."""
    params, entries = _resolve_params(params)
    budget = entries if params.chunk_tiles > 0 else None
    n_fused = len(plan.lengths) - (1 if plan.has_heavy_bucket else 0)
    calls = 0
    for bi in range(n_fused):
        R = int(plan.bucket_rows[bi]) * plan.n_shards
        chunk_r = min(_fused_chunk_rows(int(plan.lengths[bi]), params.rank,
                                        budget), max(R, 1))
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
    :data:`_NARROW_COL_MAX` the column slabs are kept as uint16."""

    def __init__(self, plan: LayoutPlan, arrs: BucketArrays,
                 lam: np.ndarray, binary: bool, device: torch.device,
                 col_sentinel: int):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.narrow = col_sentinel <= _NARROW_COL_MAX

        def put_cols(c):
            return put(c.astype(np.uint16) if self.narrow else c)

        self.plan = plan
        self.cols = [put_cols(c) for c in arrs.cols]
        self.vals = None if binary else [put(v) for v in arrs.vals]
        self.lam = put(lam)
        self.v_cols = self.v_vals = None
        self.v_passes = []
        if plan.has_heavy_bucket:
            self.v_cols = put_cols(arrs.v_cols)
            self.v_vals = None if binary else put(arrs.v_vals)
            self.v_passes = [(put(src), put(dst)) for src, dst
                             in overflow_merge_passes(plan.v_parent)]


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
        self.side_u = _Side(plan_u, arrs_u, lam_u, self.binary, self.device,
                            col_sentinel=plan_i.total_slots)
        self.side_i = _Side(plan_i, arrs_i, lam_i, self.binary, self.device,
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
        p = self.params
        k = p.rank
        plan = side.plan
        yty = (y.T @ y) if p.implicit_prefs else None

        def gather(cols):
            R, C = cols.shape
            return y.index_select(0, _widen(cols).reshape(-1)).view(R, C, k)

        def grams(cols, vals):
            return _grams_rows(gather(cols), vals, implicit=p.implicit_prefs,
                               alpha=p.alpha)

        def slab_normal_eq(colb, valb):
            # grams/rhs of a whole slab, chunked so the gather stays bounded
            R, C = colb.shape
            step = max(1, min(R, self.entries_per_step // max(C, 1)))
            parts = [grams(colb[s:s + step],
                           None if valb is None else valb[s:s + step])
                     for s in range(0, R, step)]
            return (torch.cat([a for a, _ in parts]),
                    torch.cat([b for _, b in parts]))

        n_buckets = len(plan.lengths)
        n_fused = n_buckets - (1 if plan.has_heavy_bucket else 0)
        base = 0
        for bi in range(n_fused):
            colb = side.cols[bi]
            valb = None if side.vals is None else side.vals[bi]
            R, C = colb.shape
            chunk_r = min(_fused_chunk_rows(C, k, self.entries_budget),
                          max(R, 1))
            buf_r = _solve_buffer_rows(R, chunk_r, k)
            if R:
                a_buf = torch.empty((buf_r, k, k), dtype=torch.float32,
                                    device=y.device)
                b_buf = torch.empty((buf_r, k), dtype=torch.float32,
                                    device=y.device)
            for s0 in range(0, R, buf_r):
                m = min(buf_r, R - s0)
                for s in range(s0, s0 + m, chunk_r):
                    e = min(s + chunk_r, s0 + m)
                    _grams_rows(gather(colb[s:e]),
                                None if valb is None else valb[s:e],
                                implicit=p.implicit_prefs, alpha=p.alpha,
                                out=(a_buf[s - s0:e - s0],
                                     b_buf[s - s0:e - s0]))
                out[base + s0:base + s0 + m] = _ridge_solve(
                    a_buf[:m], b_buf[:m],
                    side.lam[base + s0:base + s0 + m], yty)
            base += R

        if plan.has_heavy_bucket:
            colb = side.cols[n_fused]
            valb = None if side.vals is None else side.vals[n_fused]
            R_h = colb.shape[0]
            a, b = slab_normal_eq(colb, valb)
            vg, vr = slab_normal_eq(side.v_cols, side.v_vals)
            # merge overflow chunks into their parent rows (all in this,
            # the last, bucket: re-base the slots), one pass per chunk rank
            for src, dst in side.v_passes:
                a.index_add_(0, dst - base, vg.index_select(0, src))
                b.index_add_(0, dst - base, vr.index_select(0, src))
            out[base:base + R_h] = _ridge_solve(
                a, b, side.lam[base:base + R_h], yty)

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

    ``timings``: a dict that receives ``upload_seconds`` (host → device
    copies of the slabs and initial factors), ``compile_seconds`` (the
    counterpart of the reference's XLA compile: building or loading the
    CUDA kernel library at first use, near zero once it is loaded, and 0
    on the CPU) and ``device_train_seconds`` (every iteration, the device
    synchronized after the last). Filled only without the NaN guard and
    with at most one chunk left, as in the reference.
    """
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


class _GangSums:
    """The trainer's all-reduces (SUM) over the gang's gloo group, with the
    bytes they move and the seconds they take. Gloo reduces host memory:
    a tensor on the card is staged through the host explicitly (the device
    synchronized before the clock starts, so the seconds are the
    collective's and its copies', not the gram build's)."""

    def __init__(self, world: int):
        self.world = world
        self.bytes = 0
        self.seconds = 0.0
        self.calls = 0

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.world <= 1:
            return t
        import torch.distributed as dist

        _sync(t.device)
        t0 = time.perf_counter()
        if t.device.type == "cpu":
            dist.all_reduce(t)
        else:
            host = t.cpu()
            dist.all_reduce(host)
            t.copy_(host)
            _sync(t.device)
        self.seconds += time.perf_counter() - t0
        self.bytes += t.numel() * t.element_size()
        self.calls += 1
        return t


def _gang_int64s(v: int, world: int) -> np.ndarray:
    """All-gather one int64 per rank (rank order)."""
    if world <= 1:
        return np.asarray([v], np.int64)
    import torch.distributed as dist

    parts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(parts, torch.tensor([v], dtype=torch.int64))
    return np.asarray([int(p.item()) for p in parts], np.int64)


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
        from ..parallel.distributed import process_index
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
        self.sums = _GangSums(w)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.u, self.i = put(u), put(i)
        if self.params.implicit_prefs:
            # Hu-Koren-Volinsky per-entry weights (the slab trainer's)
            self.gw = put(self.params.alpha * r)
            self.bw = put(1.0 + self.params.alpha * r)
        else:
            self.gw, self.bw = None, put(r)
        # per-row gang-wide observation counts, one all-reduce each
        cnt_u = self.sums(torch.bincount(
            self.u, minlength=self.n_u_pad).to(torch.float32))
        cnt_i = self.sums(torch.bincount(
            self.i, minlength=self.n_i_pad).to(torch.float32))
        self.lam_u = put(self._lam(cnt_u.cpu().numpy()))
        self.lam_i = put(self._lam(cnt_i.cpu().numpy()))
        self.set_factors(x0, y0)
        # the per-half-step accounting starts after the set-up exchange
        self.sums = _GangSums(w)
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
        all_fp = _gang_int64s(local_fp, self.world)
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
        grams = torch.zeros((n_pad, k, k), dtype=torch.float32, device=dev)
        rhs = torch.zeros((n_pad, k), dtype=torch.float32, device=dev)
        ch = self.chunk
        for s in range(0, rows.shape[0], ch):
            e = min(s + ch, rows.shape[0])
            p = y.index_select(0, cols[s:e])                      # [CH, k]
            pw = p if self.gw is None else p * self.gw[s:e, None]
            _sum_rows_(grams, rows[s:e], pw[:, :, None] * p[:, None, :])
            _sum_rows_(rhs, rows[s:e], p * self.bw[s:e, None])
        # (the all-reduce synchronizes the device anyway: these clocks
        # split the half-step at no cost)
        _sync(dev)
        t1 = time.perf_counter()
        # partition partials sum to the full normal equations
        self.sums(grams)
        self.sums(rhs)
        t2 = time.perf_counter()
        lo = self.rank * rps
        a, b = grams[lo:lo + rps], rhs[lo:lo + rps]
        if self.params.implicit_prefs:
            a += (y.T @ y)[None, :, :]  # shared YᵀY term
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
        return self.sums(out)

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
                "allreduce_calls": self.sums.calls,
                "allreduce_bytes": self.sums.bytes,
                "allreduce_seconds": self.sums.seconds,
                "allreduce_bytes_per_half_step": self.sums.bytes / n,
                "allreduce_seconds_per_half_step": self.sums.seconds / n,
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
    from ..parallel.distributed import process_count

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
