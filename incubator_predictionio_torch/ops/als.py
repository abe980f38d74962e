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
  grams, take the virtual rows' grams by ``index_add_`` and are solved in
  one call.

The gather, grams and right-hand sides are plain torch: the JAX package
left them to XLA. Only float32 compute is ported (``compute_dtype="auto"``
resolves to float32, the reference's rule off a TPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .rowblocks import BucketArrays, LayoutPlan, plan_and_fill_both
from .spd_solve import batched_spd_solve


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


class _Side:
    """One side's slabs and ridge weights, resident on the device."""

    def __init__(self, plan: LayoutPlan, arrs: BucketArrays,
                 lam: np.ndarray, binary: bool, device: torch.device):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.plan = plan
        self.cols = [put(c) for c in arrs.cols]
        self.vals = None if binary else [put(v) for v in arrs.vals]
        self.lam = put(lam)
        self.v_cols = self.v_vals = self.v_parent = None
        if plan.has_heavy_bucket:
            self.v_cols = put(arrs.v_cols)
            self.v_vals = None if binary else put(arrs.v_vals)
            self.v_parent = put(plan.v_parent.astype(np.int64))


class ALSTrainer:
    """The training state of one ALS run: layout, slabs and both factor
    matrices on ``device``. :func:`train_als` is the one-call form."""

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
        self.side_u = _Side(plan_u, arrs_u, _host_lam(plan_u, self.params),
                            self.binary, self.device)
        self.side_i = _Side(plan_i, arrs_i, _host_lam(plan_i, self.params),
                            self.binary, self.device)
        x0, y0 = _fresh_init(self.params, plan_u, plan_i, self.n_users,
                             self.n_items)
        k = self.params.rank
        # one trailing all-zero sentinel row: padding slot indices gather 0s
        self.x = torch.zeros((plan_u.total_slots + 1, k), dtype=torch.float32,
                             device=self.device)
        self.y = torch.zeros((plan_i.total_slots + 1, k), dtype=torch.float32,
                             device=self.device)
        self.x[:-1] = torch.from_numpy(x0).to(self.device)
        self.y[:-1] = torch.from_numpy(y0).to(self.device)

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
            return y.index_select(0, cols.reshape(-1)).view(R, C, k)

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
            # the last, bucket: re-base the slots)
            vp = side.v_parent - base
            a.index_add_(0, vp, vg)
            b.index_add_(0, vp, vr)
            out[base:base + R_h] = _ridge_solve(
                a, b, side.lam[base:base + R_h], yty)

    def iterate(self, n: int) -> None:
        """Run ``n`` ALS iterations (user half-step, then item half-step)."""
        with torch.no_grad():
            for _ in range(int(n)):
                self._half_step(self.y, self.side_u, self.x)
                self._half_step(self.x, self.side_i, self.y)

    def factors(self) -> ALSFactors:
        x = self.x[:-1].cpu().numpy()
        y = self.y[:-1].cpu().numpy()
        return ALSFactors(
            user_factors=x[self.plan_u.slot_of_row],
            item_factors=y[self.plan_i.slot_of_row],
            n_users=self.n_users, n_items=self.n_items)


def train_als(user_idx: np.ndarray, item_idx: np.ndarray, rating: np.ndarray,
              n_users: int, n_items: int, params: ALSParams,
              device: "str | torch.device" = "cuda") -> ALSFactors:
    """Train explicit/implicit ALS from a COO rating triple on ``device``."""
    trainer = ALSTrainer(user_idx, item_idx, rating, n_users, n_items,
                         params, device=device)
    trainer.iterate(trainer.params.num_iterations)
    return trainer.factors()


def predict_rmse(factors: ALSFactors, user_idx, item_idx, rating) -> float:
    """Host-side RMSE over a COO triple (eval helper)."""
    x = factors.user_factors[np.asarray(user_idx)]
    y = factors.item_factors[np.asarray(item_idx)]
    pred = np.sum(x * y, axis=1)
    err = pred - np.asarray(rating, dtype=np.float32)
    return float(np.sqrt(np.mean(err**2)))
