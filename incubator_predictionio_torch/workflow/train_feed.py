"""Gang training feeds: partition-local reads, agreed over the gang's
process group.

The port's own copy of ``incubator_predictionio_tpu/workflow/train_feed.py``
(:61-192, :333-386). ``pio train --num-workers N`` runs N processes; with
the partition feed armed (``PIO_TRAIN_FEED=partition``, the gang default)
gang worker *i* reads ONLY the event-log shards assigned to it
(``data/api/partition_feed.py``: shard *j* of the canonical order belongs
to worker ``j mod N``), and the gang agrees on the global view by
all-gathering *derived* artifacts — never raw events — over its gloo
process group:

1. the tombstoned event ids (every worker applies the merged view's
   id-global delete rule to its own shards),
2. the entity-id vocabularies (per-partition first-seen lists, merged in
   worker-then-shard order into ONE deterministic global BiMap on every
   rank), and for templates that read entity properties,
3. the per-entity property aggregates (per-shard ``$set`` replays merged
   in last-update order).

The mapped partition-local triple then trains through
``ops.als.train_als_partition_local`` (per-row normal equations
all-reduced, factor row blocks solved per rank), and the Classification
template's labeled examples (:func:`partition_examples`: this worker's
strided slice of the agreed entity table, the global label vocabulary)
through ``ops.linear``'s process-local Naive Bayes and L-BFGS LR.

With ``--feed merged``, and on an event store that is not the JSONL log
(the reference's warning, then the merged read), every worker reads the
whole merged view: the ALS templates train on the multi-process slab loop
(``ops.als.train_als`` in a gang), the linear templates on each rank's
contiguous row block. The Universal Recommender and Complementary
Purchase read the merged view whatever the feed (their data sources have
no partition branch, as the reference's) and sum the CCO counts of each
rank's block of users (``ops.llr``).
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Sequence

import numpy as np

from ..common import envknobs
from ..data.api import partition_feed as pfeed
from ..data.bimap import BiMap

log = logging.getLogger("pio.torch.trainfeed")

__all__ = [
    "feed_identity", "feed_mode", "open_feed", "partition_examples",
    "partition_feed_active", "partition_properties", "partition_ratings",
]

_TIME_ABSENT = np.iinfo(np.int64).min


def feed_mode() -> str:
    """Resolved PIO_TRAIN_FEED: '' (unset → merged), 'merged', or
    'partition'."""
    raw = envknobs.env_str("PIO_TRAIN_FEED", "").strip().lower()
    if raw and raw not in ("partition", "merged"):
        log.warning("PIO_TRAIN_FEED=%r: expected partition/merged; "
                    "using merged", raw)
        return "merged"
    return raw


def feed_identity() -> tuple[int, int]:
    """(worker, num_workers) of this training process — the gang wiring
    the supervisor provides (PIO_PROCESS_ID / PIO_NUM_PROCESSES); (0, 1)
    outside a gang, where one worker owns every shard."""
    n = envknobs.env_int("PIO_NUM_PROCESSES", 1, lo=1)
    w = envknobs.env_int("PIO_PROCESS_ID", 0, lo=0)
    if w >= n:
        raise ValueError(f"PIO_PROCESS_ID={w} outside the gang size {n}")
    return w, n


def partition_feed_active(storage) -> bool:
    """Whether training reads feed partition-local: True only when the
    knob says so AND the event store is the JSONL log (anything else has
    no shard files: the merged read is all there is, warned, as in the
    reference). A pure function of the environment and the storage
    config, so every rank of a gang answers alike."""
    if feed_mode() != "partition":
        return False
    le = storage.get_l_events()
    if getattr(le, "events_dir", None) is None:
        log.warning("PIO_TRAIN_FEED=partition but the event backend (%s) is "
                    "not the JSONL log; falling back to the merged read",
                    type(le).__name__)
        return False
    return True


# ---------------------------------------------------------------------------
# gang exchange (derived artifacts only — never raw events)
# ---------------------------------------------------------------------------


def _allgather_payload(doc) -> list:
    """All-gather one JSON-serializable payload per rank; returns the list
    in rank order (``[doc]`` in one process). Two gloo all-gathers of host
    tensors — the sizes, then the padded UTF-8 bytes — so no rank unpickles
    another's bytes."""
    from ..parallel.distributed import process_count

    n = process_count()
    if n <= 1:
        return [doc]
    import torch
    import torch.distributed as dist

    blob = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([len(blob)], dtype=torch.int64))
    width = max(int(s.item()) for s in sizes)
    mine = torch.zeros(width, dtype=torch.uint8)
    mine[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    parts = [torch.zeros(width, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(parts, mine)
    return [json.loads(bytes(p[:int(s.item())].numpy()).decode("utf-8"))
            for p, s in zip(parts, sizes)]


def _scan_assigned(feed: "pfeed.PartitionFeed",
                   start_us: Optional[int] = None,
                   until_us: Optional[int] = None) -> list:
    """Scan this worker's shards, overlapped through ``prefetch`` workers
    (the native parse releases the GIL). With an event-time window each
    scan skips the generations its manifest proves disjoint."""
    from .input_pipeline import PipelineConfig, prefetch

    def scan_one(p: str):
        return pfeed.scan_shard(p, start_us, until_us)

    cfg = PipelineConfig.from_env()
    paths = feed.shard_list()
    if cfg.mode == "off" or len(paths) <= 1:
        return [scan_one(p) for p in paths]
    return list(prefetch(paths, scan_one, workers=cfg.workers,
                         lookahead=max(2, cfg.depth)))


def open_feed(app_name: str, storage=None,
              channel_name: Optional[str] = None,
              start_us: Optional[int] = None,
              until_us: Optional[int] = None) -> tuple:
    """Scan this worker's assigned shards ONCE and run the tombstone
    exchange: ``(feed, shards, global_tombstones)``. A template that needs
    both the rating feed and a property aggregate passes the result as
    ``feed_ctx`` to both, so the scan and the exchange are paid once (such
    a shared context stays unwindowed: the property replay needs the whole
    history). Collective: every rank calls this, and the extractions after
    it, in the same order."""
    from ..data.store.p_event_store import _resolve_app

    s, app_id, channel_id = _resolve_app(app_name, storage, channel_name)
    worker, num_workers = feed_identity()
    feed = pfeed.PartitionFeed(s.get_l_events().events_dir, app_id,
                               channel_id, worker, num_workers)
    shards = _scan_assigned(feed, start_us, until_us)
    tombs = _allgather_payload(feed.local_tombstones(shards))
    return feed, shards, frozenset(t for part in tombs for t in part)


def partition_ratings(
    app_name: str,
    event_names: Optional[Sequence[str]] = None,
    rating_from_props: bool = True,
    default_rating: float = 1.0,
    event_default_ratings: Optional[dict] = None,
    storage=None,
    channel_name: Optional[str] = None,
    start_time=None,
    until_time=None,
    feed_ctx: Optional[tuple] = None,
    report: Optional[dict] = None,
):
    """Partition-local mirror of ``PEventStore.find_ratings`` →
    ``(u, i, r, users, items)``: the triple holds ONLY this worker's
    shards' events, mapped onto the all-gathered GLOBAL id maps (identical
    on every rank; built in worker-then-shard first-seen order, so the
    indices differ from the merged read's time order — the maps, the event
    multiset and the factors per id are what match).

    An all-``None`` time range takes the ambient training window
    (``pio train --window``); when this call opens its own feed the window
    reaches the shard scans. ``report`` (a dict) receives this worker's
    ``rank``, ``world``, ``shards`` (paths) and ``local_ratings``."""
    from ..common import train_window

    worker, num_workers = feed_identity()
    start_time, until_time = train_window.apply_window(start_time,
                                                       until_time)
    s_us = pfeed.to_epoch_us(start_time)
    u_us = pfeed.to_epoch_us(until_time)
    feed, shards, global_tombs = (
        feed_ctx if feed_ctx is not None
        else open_feed(app_name, storage, channel_name,
                       start_us=s_us, until_us=u_us))
    user_ids: list = []
    item_ids: list = []
    u_index: dict = {}
    i_index: dict = {}
    u_parts, i_parts, r_parts = [], [], []

    def remap(ids, index, store):
        lut = np.empty(len(ids), np.int32)
        for j, eid in enumerate(ids):
            code = index.get(eid)
            if code is None:
                code = index[eid] = len(store)
                store.append(eid)
            lut[j] = code
        return lut

    for shard in shards:
        sr = pfeed.PartitionFeed.shard_ratings(
            shard, event_names, global_tombs,
            rating_from_props=rating_from_props,
            default_rating=default_rating,
            event_default_ratings=event_default_ratings,
            start_us=s_us, until_us=u_us)
        lut_u = remap(sr.user_ids, u_index, user_ids)
        lut_i = remap(sr.item_ids, i_index, item_ids)
        if len(sr.u):
            u_parts.append(lut_u[sr.u])
            i_parts.append(lut_i[sr.i])
            r_parts.append(sr.rating)
    u_loc = np.concatenate(u_parts) if u_parts else np.empty(0, np.int32)
    i_loc = np.concatenate(i_parts) if i_parts else np.empty(0, np.int32)
    r_loc = np.concatenate(r_parts) if r_parts else np.empty(0, np.float32)
    # exchange 2: per-worker vocabularies → ONE deterministic global BiMap
    # (worker order, first seen wins)
    vocabs = _allgather_payload({"u": user_ids, "i": item_ids})
    users = BiMap.string_int(uid for part in vocabs for uid in part["u"])
    items = BiMap.string_int(iid for part in vocabs for iid in part["i"])
    if len(user_ids):
        glut_u = np.fromiter((users(x) for x in user_ids), np.int32,
                             count=len(user_ids))
        glut_i = np.fromiter((items(x) for x in item_ids), np.int32,
                             count=len(item_ids))
        u_loc = glut_u[u_loc]
        i_loc = glut_i[i_loc]
    log.info("partition feed: worker %d/%d read %d shard(s), %d local "
             "rating event(s); global vocab %d users / %d items", worker,
             num_workers, len(shards), len(r_loc), len(users), len(items))
    if report is not None:
        report.update(rank=worker, world=num_workers,
                      shards=[sh.path for sh in shards],
                      local_ratings=int(len(r_loc)))
    return u_loc, i_loc, r_loc, users, items


def partition_examples(
    app_name: str,
    entity_type: str,
    attributes: Sequence[str],
    label: str,
    storage=None,
    channel_name: Optional[str] = None,
    report: Optional[dict] = None,
):
    """Partition-local mirror of the Classification read (the aggregated
    properties → labeled examples): the per-shard ``$set`` replays are
    all-gathered as per-entity partial aggregates and merged
    (:func:`partition_properties`), so every rank computes the identical
    entity table, label vocabulary and example order; each then keeps its
    strided slice (:func:`_examples_from_map`). Returns ``(features,
    labels, label_values, n_entities)``: this worker's example block, the
    GLOBAL label vocabulary and the global labeled-entity count. Exact
    whenever each entity's property events live in one partition (the
    import shape); the feed's caveats of :func:`partition_properties`
    hold. ``report`` (a dict) receives ``rank``, ``world``, ``shards`` and
    ``local_rows``."""
    feed_ctx = open_feed(app_name, storage, channel_name)
    merged = partition_properties(app_name, entity_type, storage=storage,
                                  channel_name=channel_name,
                                  feed_ctx=feed_ctx)
    worker, num_workers = feed_identity()
    features, y_local, label_values, kept = _examples_from_map(
        merged, attributes, label, worker, num_workers)
    log.info("partition feed: worker %d/%d holds %d of %d labeled "
             "entit(ies), %d class(es)", worker, num_workers, len(features),
             kept, len(label_values))
    if report is not None:
        report.update(rank=worker, world=num_workers,
                      shards=[sh.path for sh in feed_ctx[1]],
                      local_rows=int(len(features)))
    return features, y_local, label_values, kept


def _examples_from_map(merged: dict, attributes: Sequence[str], label: str,
                       worker: int, num_workers: int):
    """The global entity map → (this worker's strided example block, the
    GLOBAL label vocabulary, the global kept-entity count). Entities sort
    by id, so every worker sees one order; the label vocabulary covers ALL
    kept entities (``np.unique``: sorted, identical everywhere) while the
    feature rows are the ``kept_index % num_workers == worker`` slice."""
    required = set(attributes) | {label}
    feats, labels, kept = [], [], 0
    for eid in sorted(merged):
        props = merged[eid]
        if not required.issubset(props):
            continue
        if kept % num_workers == worker:
            feats.append([float(props[a]) for a in attributes])
        else:
            feats.append(None)
        labels.append(props[label])  # the global vocabulary needs them all
        kept += 1
    label_values, y_all = np.unique(np.asarray(labels), return_inverse=True)
    mine = [j for j, f in enumerate(feats) if f is not None]
    features = np.asarray([feats[j] for j in mine], np.float32)
    if features.size == 0:
        features = features.reshape(0, len(attributes))
    y_local = np.asarray(y_all).reshape(-1)[mine].astype(np.int32)
    return features, y_local, label_values, kept


def partition_properties(
    app_name: str,
    entity_type: str,
    storage=None,
    channel_name: Optional[str] = None,
    feed_ctx: Optional[tuple] = None,
) -> dict:
    """Partition-local mirror of ``aggregate_properties`` →
    ``{entity_id: props}``: per-shard replays all-gathered and merged by
    last-update order (:func:`_merge_property_parts`), the identical map on
    every rank. Exact whenever each entity's property events live in one
    partition; interleaved partial updates of ONE entity across partitions
    resolve by whole-map last-write order (the documented caveat)."""
    feed, shards, global_tombs = (
        feed_ctx if feed_ctx is not None
        else open_feed(app_name, storage, channel_name))
    my_positions = feed.canonical_positions()
    local = []
    for shard in shards:
        rep = pfeed.PartitionFeed.shard_properties(shard, entity_type,
                                                   global_tombs)
        local.append((my_positions.get(shard.path, -1), {
            eid: [props, int(first), int(last)]
            for eid, (props, first, last) in rep.items()}))
    return _merge_property_parts(_allgather_payload(local))


def _merge_property_parts(gathered) -> dict:
    """{entity: merged props} from every worker's per-shard replays
    (``gathered`` = list over workers of ``[(canonical shard position,
    {entity: [props, first_us, last_us]}), ...]``): per entity, the partial
    maps apply in ascending last-update order (absent times last — the
    replay's "now" rule), ties broken by canonical shard position, so every
    rank computes the identical merge."""
    by_entity: dict = {}
    for part in gathered:
        for pos, rep in part:
            for eid, (props, _first, last) in rep.items():
                by_entity.setdefault(eid, []).append(
                    (int(last), int(pos), props))
    big = np.iinfo(np.int64).max
    merged: dict = {}
    for eid, pieces in by_entity.items():
        pieces.sort(key=lambda p: (big if p[0] == _TIME_ABSENT else p[0],
                                   p[1]))
        props: dict = {}
        for _last, _pos, piece in pieces:
            props.update(piece)
        merged[eid] = props
    return merged
