"""The parity rules for the port's CCO indicators (``incubator_predictionio_
torch/ops/llr.py``) against the JAX reference, shared by the CCO tests.

With N the user count the reference is given (the basket count for the
Complementary Purchase template), ``tol = 2e-6·N·ln N``: the float32 G²
sums about ten ``x·ln x`` terms of size up to N·ln N that cancel, so two
correct float32 implementations differ by up to ≈ 6.5e-7·N·ln N. Counts are
exact; G² is held within ``tol``; indicators are held by the top-k rule.
"""

import math

import numpy as np


def g2_tol(n: int) -> float:
    return 2e-6 * n * math.log(max(n, 2))


def dense_counts(pu, pi, su, si, n_users: int, n_items: int):
    """(C, n_i, n_j): distinct-user co-occurrence counts and marginals, in
    float64, from dense 0/1 matrices (ids out of range dropped)."""
    def member(u, i):
        u, i = np.asarray(u, np.int64), np.asarray(i, np.int64)
        ok = (u >= 0) & (u < n_users) & (i >= 0) & (i < n_items)
        m = np.zeros((n_users, n_items))
        m[u[ok], i[ok]] = 1.0
        return m

    a, b = member(pu, pi), member(su, si)
    return a.T @ b, a.sum(axis=0), b.sum(axis=0)


def reference_g2(c, n_i, n_j, n_total: int):
    """The reference's float32 G² of dense counts (its ``llr_scores``), with
    its masks: no score without counts, none on the diagonal."""
    import jax.numpy as jnp

    from incubator_predictionio_tpu.ops.llr import llr_scores

    c = c.astype(np.float32)
    k12 = np.maximum(n_i[:, None].astype(np.float32) - c, 0)
    k21 = np.maximum(n_j[None, :].astype(np.float32) - c, 0)
    k22 = np.maximum(np.float32(n_total) - c - k12 - k21, 0)
    g = np.asarray(llr_scores(*(jnp.asarray(x, jnp.float32)
                                for x in (c, k12, k21, k22))))
    g = np.where(c > 0, g, 0.0)
    np.fill_diagonal(g, 0.0)
    return g


def hold_topk(idx, score, ref_score, g_ref, tol: float,
              threshold: float = 0.0) -> None:
    """The top-k rule, a -1 slot counting as score 0: the port's sorted
    scores within ``tol`` of the reference's (``ref_score``, its
    indicators' scores with -1 slots zeroed), and every index the port
    keeps scored by the reference (``g_ref``, the dense G² before the
    threshold) at least the reference's k-th score minus ``tol``. With an
    LLR ``threshold``, a score within ``tol`` of it may be kept on one side
    and dropped on the other, so scores below threshold + tol count as 0
    in the first comparison."""
    k = idx.shape[1]
    got = np.where(idx >= 0, score, 0.0)
    want = np.asarray(ref_score, np.float64)
    if threshold > 0:
        got = np.where(got >= threshold + tol, got, 0.0)
        want = np.where(want >= threshold + tol, want, 0.0)
    got = np.sort(got, axis=1)[:, ::-1]
    want = np.sort(want, axis=1)[:, ::-1]
    gap = float(np.abs(got - want).max())
    assert gap <= tol, f"sorted scores differ by {gap} > {tol}"
    kth = -np.sort(-np.where(g_ref >= threshold, g_ref, 0.0),
                   axis=1)[:, k - 1]
    rows, slots = np.nonzero(idx >= 0)
    kept = g_ref[rows, idx[rows, slots]]
    assert (kept >= kth[rows] - tol).all(), \
        "a kept index scores below the reference's k-th"


def host_scores(indicators: dict, memberships: dict, boost=None,
                exclude=None) -> np.ndarray:
    """The host scorer of served answers: per event type the gather+dot of
    the persisted ``indicators`` (name → (idx, score)) against the
    membership, summed in float64, times ``boost``; ``exclude`` → -inf."""
    total = 0.0
    for name, (idx, score) in indicators.items():
        m = np.asarray(memberships[name], np.float64)
        gathered = np.where(idx >= 0, m[np.maximum(idx, 0)], 0.0)
        total = total + (np.asarray(score, np.float64) * gathered).sum(axis=1)
    total = np.asarray(total, np.float64)
    if boost is not None:
        total = total * boost
    if exclude is not None:
        total = np.where(exclude, -np.inf, total)
    return total


def hold_served(got_idx, got_scores, total, num: int, rtol: float = 1e-5):
    """A served answer (item indices and scores, the positive finite ones
    of a top-``num``) against the host's ``total``: the same count, the
    scores within ``rtol`` relative, and the indices identical wherever the
    host's neighbouring scores differ by more than ``rtol`` relative."""
    order = np.lexsort((np.arange(len(total)), -total))[:num]
    want = order[np.isfinite(total[order]) & (total[order] > 0)]
    got_idx = np.asarray(got_idx, np.int64)
    assert len(got_idx) == len(want), (len(got_idx), len(want))
    if not len(want):
        return
    np.testing.assert_allclose(got_scores, total[got_idx], rtol=rtol)
    np.testing.assert_allclose(got_scores, total[want], rtol=rtol)
    s = total[order]
    close = np.isclose(s[1:], s[:-1], rtol=rtol, atol=0)
    distinct = np.ones(len(s), bool)
    distinct[1:] &= ~close
    distinct[:-1] &= ~close
    distinct = distinct[:len(want)]
    assert np.array_equal(got_idx[distinct], want[distinct])
