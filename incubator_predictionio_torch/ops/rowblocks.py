"""Length-bucketed row layout: ragged ratings → gather-minimal dense slabs.

The port's own copy of ``incubator_predictionio_tpu/ops/rowblocks.py``
(numpy only), so that the slot order ("π") is identical to the reference's
and factors compare row for row:

- Each row's entries live in ONE dense slab row [C_b] whose capacity C_b
  comes from a geometric ladder of 8-multiples, so the per-row normal
  equations fall straight out of a batched [R_b, C_b, k] product with no
  segment reduction.
- Rows longer than ``overflow_len`` split into full-width *virtual* rows
  plus a ladder remainder; virtual grams merge into their parent row in a
  fixed order (``ops/als.py`` ``overflow_merge_passes``).

Storage order: solved-side factor rows live at *slots* laid out
shard-major, bucket-major within a shard, ascending row id within a bucket
(then filler slots). Column indices are pre-mapped into the counterpart's
slot space on the host. The layout is a pure function of the per-row
counts (``plan_layout``).

The fill is the reference's numpy path (its native C++ scatter is
bit-identical to it and is not carried over).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Rows longer than this split into full-width virtual rows.
OVERFLOW_LEN = 2048

#: Geometric growth of the capacity ladder past 64 (the reference's
#: default; its ``PIO_ALS_LADDER_GROWTH`` override is not carried over).
LADDER_GROWTH = 1.05


def length_ladder(max_len: int, overflow_len: int = OVERFLOW_LEN,
                  growth: float = LADDER_GROWTH) -> np.ndarray:
    """Row-capacity ladder: multiples of 8 up to 64, then ~×growth steps
    (rounded up to a multiple of 8), capped at ``overflow_len``."""
    target = max(8, min(int(max_len), overflow_len))
    caps = []
    v = 0
    while v < target:
        if v < 64:
            v += 8
        else:
            v = min(max(-(-int(v * growth) // 8) * 8, v + 8), overflow_len)
        caps.append(v)
    return np.asarray(caps, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """Deterministic bucket layout derived from per-row counts alone."""

    lengths: np.ndarray        # [n_buckets] int64 — slab width per bucket
    bucket_rows: np.ndarray    # [n_buckets] int64 — rows per SHARD per bucket
    rows_per_shard: int        # Σ bucket_rows (incl. m-divisibility filler)
    n_shards: int
    n_rows: int                # logical rows
    overflow_len: int
    slot_of_row: np.ndarray    # [n_rows] int64 — global storage slot
    counts_slot: np.ndarray    # [n_shards*rows_per_shard] int64 (filler=0)
    bucket_of_row: np.ndarray  # [n_rows] int64
    v_rows_per_shard: int      # virtual rows per shard (max, padded)
    v_chunks_of_row: np.ndarray  # [n_rows] int64 — # full-width chunks
    v_base_of_row: np.ndarray  # [n_rows] int64 — row's first LOCAL v-slot
    v_parent: np.ndarray       # [n_shards*v_rows_per_shard] int64 LOCAL slot

    @property
    def has_heavy_bucket(self) -> bool:
        """True → the LAST bucket holds exactly the overflow parents."""
        return self.v_rows_per_shard > 0

    @property
    def total_slots(self) -> int:
        return self.n_shards * self.rows_per_shard

    def shard_of_row(self, row: np.ndarray) -> np.ndarray:
        rpl = -(-self.n_rows // self.n_shards)
        return np.minimum(np.asarray(row) // rpl, self.n_shards - 1)


def plan_layout(counts: np.ndarray, n_shards: int = 1, m_div: int = 1,
                overflow_len: int = OVERFLOW_LEN) -> LayoutPlan:
    """Plan the bucket layout for one side from its per-row nnz counts
    (rows owned by shards in contiguous ranges of ceil(n_rows / n_shards);
    rows_per_shard rounded up to divide ``m_div``)."""
    counts = np.asarray(counts, dtype=np.int64)
    n_rows = counts.shape[0]
    S = int(n_shards)
    rpl = -(-n_rows // S)
    row_ids = np.arange(n_rows, dtype=np.int64)
    shard_of_row = np.minimum(row_ids // rpl, S - 1)

    # overflow split: full-width virtual chunks + a non-empty remainder
    v_chunks = np.where(counts > overflow_len, counts // overflow_len, 0)
    rem = counts - v_chunks * overflow_len
    fix = (v_chunks > 0) & (rem == 0)
    v_chunks[fix] -= 1
    rem[fix] = overflow_len

    ladder = length_ladder(int(rem.max()) if n_rows else 8, overflow_len)
    bucket_of_row = np.searchsorted(ladder, np.maximum(rem, 1))
    n_buckets = len(ladder)
    # rows with virtual chunks go to a dedicated LAST bucket (their normal
    # equations need the scatter-add before the solve)
    heavy_mask = v_chunks > 0
    if heavy_mask.any():
        heavy_cap = ladder[np.searchsorted(
            ladder, max(int(rem[heavy_mask].max()), 1))]
        bucket_of_row = np.where(heavy_mask, n_buckets, bucket_of_row)
        ladder = np.append(ladder, heavy_cap)
        n_buckets += 1

    per_sb = np.bincount(
        shard_of_row * n_buckets + bucket_of_row, minlength=S * n_buckets
    ).reshape(S, n_buckets)
    bucket_rows = per_sb.max(axis=0)

    # drop empty buckets, keep bucket 0 (filler target) if ladder nonempty
    keep = np.nonzero(bucket_rows > 0)[0]
    if keep.size == 0:
        keep = np.array([0])
    new_idx = np.full(n_buckets, -1, dtype=np.int64)
    new_idx[keep] = np.arange(keep.size)
    lengths = ladder[keep]
    bucket_rows = bucket_rows[keep].astype(np.int64)
    bucket_of_row = new_idx[bucket_of_row]
    n_buckets = keep.size

    rows_per_shard = int(bucket_rows.sum())
    pad_m = (-rows_per_shard) % int(m_div)
    if rows_per_shard + pad_m < 1:
        pad_m = 1
    bucket_rows[0] += pad_m  # filler rows take the cheapest slab width
    rows_per_shard += pad_m

    # slot of each row: shard-major, bucket blocks, rank within bucket
    bucket_base = np.zeros(n_buckets + 1, dtype=np.int64)
    np.cumsum(bucket_rows, out=bucket_base[1:])
    order = np.lexsort((row_ids, bucket_of_row, shard_of_row))
    sb_sorted = (shard_of_row * n_buckets + bucket_of_row)[order]
    group_start = np.zeros(len(order), dtype=np.int64)
    if len(order):
        new_group = np.empty(len(order), dtype=bool)
        new_group[0] = True
        new_group[1:] = sb_sorted[1:] != sb_sorted[:-1]
        starts = np.nonzero(new_group)[0]
        group_start = starts[np.cumsum(new_group) - 1]
    rank = np.arange(len(order), dtype=np.int64) - group_start
    slot_sorted = (
        shard_of_row[order] * rows_per_shard
        + bucket_base[bucket_of_row[order]]
        + rank
    )
    slot_of_row = np.empty(n_rows, dtype=np.int64)
    slot_of_row[order] = slot_sorted

    counts_slot = np.zeros(S * rows_per_shard, dtype=np.int64)
    counts_slot[slot_of_row] = counts

    # virtual rows: grouped per shard, ordered by (row, chunk)
    v_per_shard_real = np.bincount(
        shard_of_row, weights=v_chunks.astype(np.float64), minlength=S
    ).astype(np.int64)
    Rv = int(v_per_shard_real.max()) if n_rows else 0
    v_base_of_row = np.zeros(n_rows, dtype=np.int64)
    v_parent = np.zeros(S * Rv, dtype=np.int64)
    if Rv:
        cum = np.cumsum(v_chunks)
        shard_first = np.searchsorted(shard_of_row, np.arange(S))
        prev_total = np.zeros(S, dtype=np.int64)
        for s in range(1, S):
            prev_total[s] = cum[shard_first[s] - 1] if shard_first[s] > 0 else 0
        v_base_of_row = cum - v_chunks - prev_total[shard_of_row]
        for r in np.nonzero(v_chunks > 0)[0]:  # heavy rows are few
            s = shard_of_row[r]
            base = s * Rv + v_base_of_row[r]
            v_parent[base:base + v_chunks[r]] = (
                slot_of_row[r] - s * rows_per_shard)
    return LayoutPlan(
        lengths=lengths,
        bucket_rows=bucket_rows,
        rows_per_shard=rows_per_shard,
        n_shards=S,
        n_rows=n_rows,
        overflow_len=overflow_len,
        slot_of_row=slot_of_row,
        counts_slot=counts_slot,
        bucket_of_row=bucket_of_row,
        v_rows_per_shard=Rv,
        v_chunks_of_row=v_chunks,
        v_base_of_row=v_base_of_row,
        v_parent=v_parent,
    )


@dataclasses.dataclass(frozen=True)
class BucketArrays:
    """Dense per-bucket entry slabs. cols hold COUNTERPART slot indices;
    padding slots hold the sentinel (= counterpart total slots, a zero
    factor row). ``fill_vals=False`` (binary ratings): vals is empty and
    v_vals zero-size."""

    cols: tuple[np.ndarray, ...]   # per bucket [S*R_b, C_b] int32
    vals: tuple[np.ndarray, ...]   # per bucket [S*R_b, C_b] f32
    v_cols: np.ndarray             # [S*Rv, overflow_len] int32
    v_vals: np.ndarray             # [S*Rv, overflow_len] f32


def fill_buckets(plan: LayoutPlan, row: np.ndarray, col: np.ndarray,
                 val: np.ndarray, col_slot_map: np.ndarray, sentinel: int,
                 fill_vals: bool = True, shard0: int = 0,
                 n_local_shards: "int | None" = None) -> BucketArrays:
    """Scatter entries into the planned slabs of shards ``[shard0,
    shard0 + n_local_shards)`` (default: from ``shard0`` to the last).
    ``row`` must hold only rows those shards own (the range-read contract
    of a process-sharded train); ``col`` is global counterpart row ids,
    mapped through ``col_slot_map``; each row's entries keep their
    original order (stable), as in the reference."""
    S = (plan.n_shards - shard0 if n_local_shards is None
         else int(n_local_shards))
    if fill_vals:
        val = np.asarray(val, dtype=np.float32)
    n_buckets = len(plan.lengths)
    Rv, OV = plan.v_rows_per_shard, plan.overflow_len

    sizes = [S * int(plan.bucket_rows[b]) * int(plan.lengths[b])
             for b in range(n_buckets)]
    offsets = np.zeros(n_buckets + 2, dtype=np.int64)
    np.cumsum(np.asarray(sizes + [S * Rv * OV], dtype=np.int64),
              out=offsets[1:])
    flat_cols = np.full(int(offsets[-1]), sentinel, dtype=np.int32)
    flat_vals = (np.zeros(int(offsets[-1]), dtype=np.float32)
                 if fill_vals else None)

    if len(row):
        if plan.n_rows > 2**31 - 1:
            raise NotImplementedError(
                "fill_buckets: row ids beyond int32 are not supported")
        row64 = np.asarray(row, np.int64)
        col64 = np.asarray(col, np.int64)
        if row64.min() < 0 or row64.max() >= plan.n_rows:
            raise ValueError("fill_buckets: row ids outside the plan")
        s_lo, s_hi = (int(x) for x in plan.shard_of_row(
            np.array([row64.min(), row64.max()], np.int64)))
        if s_lo < shard0 or s_hi >= shard0 + S:
            raise ValueError(
                "fill_buckets: entries reference rows outside shards "
                f"[{shard0}, {shard0 + S}) — range-read only owned rows")
        if col64.min() < 0 or col64.max() >= len(col_slot_map):
            raise ValueError(
                "fill_buckets: column ids outside the counterpart slot map")
        shard_r = plan.shard_of_row(np.arange(plan.n_rows, dtype=np.int64))
        bucket_base = np.zeros(n_buckets + 1, dtype=np.int64)
        np.cumsum(plan.bucket_rows, out=bucket_base[1:])
        b_r = plan.bucket_of_row
        rib = (plan.slot_of_row - shard_r * plan.rows_per_shard
               - bucket_base[b_r])
        # (garbage for rows of other shards: the range check above keeps
        # them unreferenced)
        prim_base = (offsets[b_r]
                     + ((shard_r - shard0) * plan.bucket_rows[b_r] + rib)
                     * plan.lengths[b_r])
        vc_r = plan.v_chunks_of_row
        # a row's virtual chunks are consecutive v-slots, so its first
        # vc*OV entries land contiguously at v_base + pos
        v_base = (offsets[n_buckets]
                  + ((shard_r - shard0) * Rv + plan.v_base_of_row) * OV)

        order = np.argsort(np.asarray(row, np.int32), kind="stable")
        rs = row64[order]
        cs = np.asarray(col_slot_map, np.int64)[col64[order]].astype(np.int32)
        rmin = int(rs[0])
        cnt = np.bincount((rs - rmin).astype(np.int64))
        starts = np.zeros(len(cnt), dtype=np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        pos = np.arange(len(rs), dtype=np.int64) - starts[rs - rmin]
        vc_e = vc_r[rs] * OV
        dest = np.where(pos < vc_e, v_base[rs] + pos,
                        prim_base[rs] + pos - vc_e)
        flat_cols[dest] = cs
        if fill_vals:
            flat_vals[dest] = val[order]

    cols, vals = [], []
    for b in range(n_buckets):
        R, C = S * int(plan.bucket_rows[b]), int(plan.lengths[b])
        cols.append(flat_cols[offsets[b]:offsets[b + 1]].reshape(R, C))
        if fill_vals:
            vals.append(flat_vals[offsets[b]:offsets[b + 1]].reshape(R, C))
    v_cols = flat_cols[offsets[n_buckets]:offsets[n_buckets + 1]].reshape(
        S * Rv, OV)
    v_vals = (flat_vals[offsets[n_buckets]:offsets[n_buckets + 1]].reshape(
        S * Rv, OV) if fill_vals else np.zeros((0, OV), np.float32))
    return BucketArrays(cols=tuple(cols), vals=tuple(vals), v_cols=v_cols,
                        v_vals=v_vals)


def plan_and_fill_both(user_idx, item_idx, rating, n_users: int,
                       n_items: int, fill_vals: bool = True,
                       n_shards: int = 1, m_div: int = 1,
                       shard: "int | None" = None):
    """Plan and fill BOTH sides' slabs: ``(plan_u, plan_i, arrs_u,
    arrs_i)``, planned for ``n_shards`` data shards with rows per shard
    divisible by ``m_div`` (the reference's :275). ``shard``: fill only
    that shard's slabs, from the entries of the rows it owns (each side
    filters the full triple in order, so the slabs equal that shard's
    part of a fill of every shard). The two sides run on two threads
    (numpy's sorts and scatters release the GIL); nothing is shared but
    read-only inputs, so the results are those of a serial run."""
    counts_u = np.bincount(np.asarray(user_idx, np.int64), minlength=n_users)
    counts_i = np.bincount(np.asarray(item_idx, np.int64), minlength=n_items)

    def run(*thunks):
        with ThreadPoolExecutor(max_workers=len(thunks)) as pool:
            futs = [pool.submit(t) for t in thunks]
            return [f.result() for f in futs]

    plan_u, plan_i = run(lambda: plan_layout(counts_u, n_shards, m_div),
                         lambda: plan_layout(counts_i, n_shards, m_div))

    def fill(plan, row, col, cp_plan):
        if shard is None:
            return fill_buckets(plan, row, col, rating,
                                col_slot_map=cp_plan.slot_of_row,
                                sentinel=cp_plan.total_slots,
                                fill_vals=fill_vals)
        keep = plan.shard_of_row(np.asarray(row, np.int64)) == shard
        return fill_buckets(plan, np.asarray(row)[keep],
                            np.asarray(col)[keep],
                            np.asarray(rating)[keep] if fill_vals else None,
                            col_slot_map=cp_plan.slot_of_row,
                            sentinel=cp_plan.total_slots,
                            fill_vals=fill_vals, shard0=shard,
                            n_local_shards=1)

    arrs_u, arrs_i = run(lambda: fill(plan_u, user_idx, item_idx, plan_i),
                         lambda: fill(plan_i, item_idx, user_idx, plan_u))
    return plan_u, plan_i, arrs_u, arrs_i
