"""The chain of unobserved swaps of one serving lifecycle.

The engine server's default deployment (``create_server.py``) and each
tenant of the mux (``multitenant.py``) own one :class:`SwapChain`: the
previous deployment kept resident for an instant rollback, the post-swap
watch of the live instance, and the ids swapped in since the previous
deployment went out.

The rule (the port's, not the reference's, which swaps one step at a
time): an automatic publish (the refresh loop, the online fold-in) that
lands while the outgoing instance's watch is still open keeps the
previous deployment on the last instance OBSERVED healthy, whose watch
closed without tripping, and appends the new instance to the chain; the
outgoing one is released. Each link gets a whole window of its own, and
the watch trips when the live link alone, or with the links before it
counted back from it, has ≥ 2 failures above the error rate: a poisoned
increment poisons every increment folded from it, and the links before it
must not dilute it. A rollback pins every link and restores the previous
deployment. Once a chain of two or more began a whole window ago and the
live watch is open, automatic publishes wait (:meth:`SwapChain.full`), so
the previous deployment is at most two windows older than the live one.
Any other swap (an operator reload, a fleet directive) makes the outgoing
instance the previous one and starts a new chain.

The owner holds its own lock around every call and passes the clock
reading in, so one swap is decided on one reading.
"""

from __future__ import annotations

import logging
from typing import Optional

log = logging.getLogger("pio.torch.swap_chain")

__all__ = ["SwapChain"]


class SwapChain:
    """One lifecycle's previous deployment, post-swap watch and chain of
    unobserved swaps. Not locked itself: every call runs under the
    owner's lock."""

    def __init__(self, label: str = ""):
        self.label = label                  # log prefix ("tenant 'a': ")
        self.previous: Optional[tuple] = None   # (deployment, instance)
        # instance ids swapped in since ``previous`` went out, the live
        # one last; more than one only while automatic publishes outran
        # the watch, and every one is pinned by a rollback
        self.links: list[str] = []
        self.since = 0.0                    # monotonic swap-in of links[0]
        self.watch: Optional[dict] = None   # the live instance's window

    def swap(self, prev_dep, prev_inst, instance, now: float, *,
             chain: bool, watch_ms: float, arm: bool = False) -> bool:
        """Record that ``instance`` replaced ``prev_inst`` at ``now``;
        True when it is a swap (a different instance). ``chain`` (the
        automatic publishes) extends the chain while the outgoing watch
        is open; a watch whose window has passed at ``now`` closed clean
        and its instance becomes the previous deployment. A swap arms a
        watch of ``watch_ms`` (> 0) on the new instance, and so does any
        load with ``arm``."""
        swapped = prev_inst is not None and prev_inst.id != instance.id
        w = self.watch
        extend = (chain and swapped and w is not None
                  and w["instance"] == prev_inst.id
                  and now <= w["until"]
                  and self.previous is not None
                  and self.previous[1].id != instance.id)
        if extend:
            self.links.append(instance.id)
        elif swapped:
            self.previous = (prev_dep, prev_inst)
            self.links = [instance.id]
            self.since = now
        if (swapped or arm) and watch_ms > 0:
            # each instance gets a whole window of its own; the chain's
            # earlier links keep their counts for the trip
            self.watch = {
                "until": now + watch_ms / 1e3,
                "total": 0, "errors": 0, "instance": instance.id,
                "links": ([*w["links"], (w["total"], w["errors"])]
                          if extend else []),
            }
        return swapped

    def close_stale(self, w: dict, live_id: Optional[str],
                    now: float) -> bool:
        """Clear watch ``w`` when a newer swap or rollback superseded it
        or its window closed at ``now``; True when it was cleared."""
        if live_id is None or w["instance"] != live_id:
            if self.watch is w:
                self.watch = None
            return True
        if now > w["until"]:
            log.info("%spost-swap watch for %s closed clean (%d queries, "
                     "%d errors)", self.label, w["instance"], w["total"],
                     w["errors"])
            if self.watch is w:
                self.watch = None
            return True
        return False

    def note(self, ok: bool, live_id: Optional[str], now: float,
             max_error_rate: float) -> bool:
        """Count one query outcome of the live instance against its
        watch. True when the watch tripped: ≥ 2 failures AND a failure
        fraction above ``max_error_rate``, for the live link alone or
        with the links before it, counted back from it."""
        w = self.watch
        if w is None or self.close_stale(w, live_id, now):
            return False
        w["total"] += 1
        if ok:
            return False
        w["errors"] += 1
        total, errors = w["total"], w["errors"]
        for t, e in [(0, 0), *reversed(w["links"])]:
            total, errors = total + t, errors + e
            if errors >= 2 and errors / total > max_error_rate:
                return True
        return False

    def full(self, live_id: Optional[str], now: float,
             watch_ms: float) -> bool:
        """Whether an automatic publish must wait: the live instance's
        watch is open and the chain (two or more: a chain of one is
        bounded by its own window) began a whole watch window ago. The
        wait ends when that watch closes (clean: the live instance
        becomes the previous deployment at the next swap) or trips."""
        w = self.watch
        return (len(self.links) > 1 and w is not None
                and live_id is not None and w["instance"] == live_id
                and now <= w["until"]
                and now - self.since >= watch_ms / 1e3)

    def rollback(self, bad_id: str) -> tuple[Optional[tuple], list[str]]:
        """Take the previous deployment out for a rollback from
        ``bad_id``: (the previous (deployment, instance) or None, the ids
        to pin: every link of the chain, ``bad_id`` last). The chain and
        the watch end here."""
        prev = self.previous
        pins = [*(i for i in self.links if i != bad_id), bad_id]
        self.reset()
        return prev, pins

    def reset(self) -> None:
        """Forget the previous deployment, the chain and the watch."""
        self.previous = None
        self.links = []
        self.watch = None
