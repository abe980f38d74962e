"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py            # needs one CUDA card, nvcc for sm_90a

Phases (any failure exits non-zero; nothing is caught):

0. device: the card's name and power limit (nvidia-smi).
1. build: every CUDA kernel of the path, from the sources in the checkout;
   beside it, one process warms a Python bytecode cache (build/pycache)
   that every process the script starts reads and writes: the card host
   sets PYTHONDONTWRITEBYTECODE and its torch ships no .pyc files, so
   each process compiled torch's sources again (≈ 6 s of a verb's start).
2. kernel vs plain: both Gauss-Jordan SPD solve kernels (the warp kernel,
   k ≤ 32, and the wide kernel, 32 < k ≤ 128, every K it is built for)
   against their plain PyTorch version at the reference's test shapes and
   at the paths' shapes, rtol = atol = 2e-4 (the reference's tolerance);
   nearly singular ALS-like systems are reported with their relative-norm
   gap. Device times (torch.profiler) and back-to-back loop times (CUDA
   events) of the kernel, the plain version and torch's batched Cholesky
   (the yardstick; the port never calls it) beside the kernel's bound.
3. ALS on the card vs on the CPU (plain solve), ML-100K shape, rank 32 and
   rank 128, explicit and implicit (binary and weighted).
3a. als_bf16_card_vs_cpu: the same in bfloat16 (compute_dtype
   "bfloat16"): rank 32 λ 0.01·n explicit, implicit binary and weighted,
   rank 128 λ 0.1·n; each within a relative norm of 1e-2 of the CPU's, its
   training RMSE within 0.1 %, launches = the layout's under bf16 sizing;
   after one iteration within 2e-4 of the CPU's bfloat16 factors, at most
   a fifth of the CPU's bfloat16-vs-float32 gap on the same inputs (held
   ≥ 1e-3), so only a bfloat16 train on the card passes.
4. main path at full width: ML-20M-shaped synthetic ratings (138,493 users
   × 26,744 items × 20,000,263 ratings), rank 32, trained through the
   Recommendation engine's ALSAlgorithm; warp-kernel launches must equal
   the solve calls the layout implies; persist → restore → HTTP server →
   ≥ 50 POST /queries.json; the train's ``timings`` hook (upload, kernel
   load, device seconds: ``train_timings``); steady seconds per iteration
   with the uint16 column narrowing and without it, in turns; one steady
   iteration profiled.
4a. train_bf16: the main path with "computeDtype": "bfloat16" through
   the same engine: warp launches = implied, finite factors, training
   RMSE within 0.1 % of the float32 main path's (the reference's 0.05 ×
   scale rule reported), factors at least 1e-3 (relative norm) from the
   float32 main path's, 20 served queries held to the host top-k; a
   float32 and a bfloat16 trainer's steady iterations in turns and one
   profiled iteration each (device-busy ms, the gather's share).
5. train_checkpointed / train_resumed: the same ratings with a snapshot
   every iteration (factors within 2e-4 of the main path's), then a crash
   after the step-2 snapshot and a resumed train whose factors equal the
   uninterrupted checkpointed train's bit for bit (launches equal to the
   implied counts), then a changed rating that must be refused.
6. train_nan_guard: the guarded train (one iteration at a time) and a
   small triple with a NaN rating that must fail naming the iteration.
7. fold_in: a batch of 20,000 events (2,000 new users, 500 new items)
   folded into the main path's model: 2 warp launches, card vs CPU at
   2e-4, seconds per fold-in, the folded model served over HTTP.
7a. serving_sharded_catalog / _fold_in / _always: host-sharded serving
   (PIO_SERVE_SHARD_ITEMS) against the flat catalog — bench_query.py's
   million-item bracket (10,000, 100,000 and 1,000,000 items × rank 32,
   500 users, 8 shards) deployed over HTTP once flat and once sharded,
   120 queries each, every sharded answer index- and score-identical to
   the flat one, a batch of 64 index-identical with its peak memory; the
   main path's model with 7 shards held to flat, the fold-in batch folded
   into it (2 warp launches) and the rebuilt catalog held to the host
   top-k; an engine.json with "shardedServing": "always" trained at the
   ML-100K shape and served.
7b. serving_mesh: the serving mesh on the one card (4 shards, each named
   cuda:0): the main path's model and the 10^6-item catalog flat and
   split, 200 single queries (a third with an exclusion mask) and 50
   similarity queries bit-identical, a batch of 64 index-identical, p50
   per query; the Recommendation template trained with a 4-device context
   mesh and "shardedServing": "always", restored with it, its answers
   equal to the flat deployment's (its train's warp launches are this
   path's).
8. console: train → deploy → query; a checkpointed console train that
   crashes and its ``--resume``; the Similar-Product template's own
   engine.json values through train → deploy → query. Beside it, lint:
   ``pio lint --json`` over the checkout (a parse pass that imports
   neither torch nor jax) exits 0 with no finding and runs every rule.
9. similar_product: bench_templates.py's config 3 (100,000 users × 20,000
   items × 5,000,000 views, rank 32, 10 iterations, implicit) through the
   Similar-Product engine, 20 item categories from $set events; persist →
   restore → ≥ 50 filtered POST /queries.json held to a host cosine top-k.
10. pio_workflow: the pio verbs on an SQLite store at ML-1M (its first
   25,000 events, cut for the script's time; app new →
   import → 2,000 live events through the event server → train → deploy
   → queries → a corrupted blob walked back past).
11. codec_vs_plain: the event codec (native/src/event_codec.cc, built with
   g++ beside nvcc in phase 1) and its plain parser on the first 100,000
   lines of the ML-20M log: every column and table equal; MB/s of both.
12. pio_workflow_jsonl: the pio_workflow scenario with the events on a
   JSONL log (the first 75,000 ML-1M events, cut from 1,000,209 for the
   script's time): two generations compacted, the live batches through the
   codec's one-pass path, a train --window whose read skips generation 1
   and equals a numpy filter of the generated events, the full train
   (read count, first-seen id maps, warp launches = implied), deploy, 50
   queries held to a host top-k; import, read, train and ingest/query
   latencies beside the SQLite phase's. Then engine_server_lifecycle on
   that store: pio deploy --model-refresh-ms 500 → a further pio train
   (λ 0.05, 5 iterations; its warp launches recorded under this path) →
   the refresh swap within 10 s with answers equal to the new instance's
   host top-k → POST /rollback restores the old answers and pins the new
   instance across ≥ 2 refresh polls → pio models list, verify, gc --keep
   1 --engine-url (the deployed and pinned models kept) →
   /reload?instance=<new> removes the pin.
12a. eventserver_partitioned: pio eventserver --workers 2 (and --workers 1
   beside it, the rounds interleaved as bench_ingest.py's bracket) on
   JSONL stores: the first 100,000 ML-1M events in batches of 50 from 16
   clients, both .p<i> shards non-empty, the merged read equal to the
   acknowledged events as a multiset; worker 1 SIGKILLed mid-flood
   (20,000 more events), relaunched, no acknowledged event lost; pio
   eventlog fence --partition 0 (the live worker's next write 503, its
   shard unchanged), worker 0 relaunched with a fresh epoch; pio
   eventserver scale 3, then scale 2 (partition 2's lease parked on the
   front, epoch bumped); pio train off the merged log (warp launches =
   implied, factors within 2e-4 of train_als on the triple read back).
12b. gang_train (inside 12a, on its store): pio train --num-workers 2
   --checkpoint-every 2, two ranks of a gloo process group on the card,
   each reading only its own shards (disjoint, covering the log), the
   grams all-reduced, each rank's row block solved by the warp kernel
   (launches = implied; factors within 2e-4 of train_als on the union
   triple in the gang's indices); a worker crash after the first snapshot
   (one gang restart, the factors equal the uninterrupted gang's); a
   SIGTERM drain at a sweep boundary, then --resume on the same instance;
   a Similar-Product gang (categories as $set events) served through
   pio deploy.
12c. gang_train_merged / gang_train_alx (inside 12a, on its store): pio
   train --num-workers 2 --feed merged (the slab gang: every rank reads
   the merged view and solves its data shard with the warp kernel), then
   PIO_MESH_SHAPE=2x2 pio train --num-workers 4 --feed merged (the 2-D
   ALX layout: four ranks on the card, each holding half of each factor
   matrix and summing its partial grams over its model group), factors
   within 2e-4 of the in-process train_als of the merged triple, warp
   launches = the plan's; the 2-D model served through pio deploy, one
   query held to the host top-k; then gang_train_alx_bf16: the 2-D gang
   with "computeDtype": "bfloat16", within a relative norm of 1e-2 of the
   in-process bfloat16 train_als and at least 1e-3 from the float32 one,
   launches = the plan's, one query served.
12d. als_process_sharded: train_als_process_sharded at the main path's
   width (the ML-20M-shaped triple, rank 32, 3 iterations, λ 0.01·n) on a
   (2, 2) mesh of four ranks (this script re-invoked as each rank), each
   range-reading only its rows; factors within 2e-4 of train_als of the
   same triple in this process, warp launches = the plan's.
12e. eventserver_wal (after 12a): the single-event sweep (1, 8, 32
   clients, 1,000 ML-1M events a point; group commit off, on, on with the
   WAL), an ack=enqueue flood killed inside a group commit and replayed
   (every acknowledged id once), archive and a restoring windowed train.
12f. network_storage (after 12e): pio storageserver (HTTP) for metadata
   and events, tests/pg_mock.py's PostgreSQL for models; import and train
   of 20,000 ML-1M events (launches = implied, bit-equal to the same
   train over SQLite, within 2e-4 of train_als); a TLS deploy (200
   queries held to the host top-k, p50 beside a plaintext deploy's,
   /metrics, a traced query's spans) and a TLS event server; the storage
   server SIGKILLed (503 + Retry-After, /readyz 503 naming the breaker)
   and restarted (ready again, every acknowledged event once).
12g. object_search_storage (after 12f, on its events and its SQLite
   twin): the stand-in servers of tests/ as threads of this process;
   Elasticsearch metadata and events with S3 models, and HBase events
   over the native RPC (two regions) with HDFS models; in-process app new
   and import, both pio trains at once (launches = implied, bit-equal to
   the twin, within 2e-4 of train_als), the same events through the HBase
   REST gateway read equal to the RPC read, pio deploy restoring from S3
   (200 queries held to the host top-k).
12h. operator_tools (after 12f, on its SQLite twin; in a thread beside
   12g and 13): pio template get recommendation (the port's bundle) at
   the twin's rank 32, λ and iterations → pio train --profile-dir (the
   torch.profiler trace names the warp kernel as often as the counter and
   the layout imply; factors bit-equal to the twin's unprofiled train);
   pio shell -c running pypio.train of the same directory (launches =
   implied, bit-equal); pio adminserver through the reference test's
   sequence; pio export --format parquet with pyarrow unimportable (exit
   1 naming it, no file) and, where the host has pyarrow, with it; pio
   soak of the template on the card (2 event workers, 2 replicas, 30 s of
   the reference's default traffic, the faults enospc_shed, worker_kill,
   replica_kill, good_retrain, compact_crash): verdict PASS, every fault
   fired with evidence, every acknowledged event reconciled once, its
   trains' warp launches counted.
13. pio_workflow_jsonl_ml20m: the first 312,500 of the ML-20M ratings
   as the log (byte for byte insert_batch's lines; cut from 20,000,263
   for the script's time, ``reduced``) → eventlog compact → the read held
   exactly to the generated arrays → train at rank 32, 10 iterations
   (warp launches = implied) → deploy → 20 queries; the compaction, read
   and train times and events/s end to end and steady. df and free -g
   first. Then engine_server_load on that store: pio deploy
   --probe-latency (the probe's split from /status), one keep-alive
   client × 200 queries, 8 and 32 keep-alive clients without and with
   micro-batching (--batch-window-ms 2 --max-batch 64), batched answers
   against unbatched ones, X-Pio-Deadline-Ms 0.001 → 504, pio undeploy;
   SIGTERM with 16 clients in flight (accepted queries 200, /readyz 503
   in the drain, exit 0); --query-cache-size 10000 hits and misses; pio
   batchpredict of 10,000 queries against the served answers. Every
   answer is held to the host top-k over the persisted factors. Then
   engine_server_online on that store: pio deploy --online-foldin
   --quality-eval with a keep-alive client throughout; the fold-in
   batch of phase 7 appended to the log, the seconds until its new users
   are served, the increments against the CPU fold-in of the same log
   bytes and their answers against the host top-k, exactly 2 warp
   launches per increment (counted in the deploy process); a NaN batch
   refused by the gate and pinned, a clean batch served after it; an
   instance with negated item factors rolled back by the quality watch
   (reason quality) with every client query 200; the pio_foldin_* and
   pio_engine_quality_* families of /metrics equal to /status's counts;
   pio status and status --engine-url; SIGTERM, exit 0, no fold-in
   thread left. (engine_server_fleet checks each replica's
   pio_fleet_divergence on its /metrics.)
14. engine_server_tenants: 8 apps on one JSONL store, each an
   ML-100K-shaped log trained in process on the card (rank 10, 5
   iterations), served by one pio deploy --multitenant --online-foldin
   (4 resident, a budget of 2 per tenant): one client per app over the
   four routing keys, every answer its own app's host top-k, evictions
   and no query lost; a hot app shedding 503 while two others answer 200;
   a poisoned tenant rolled back alone; a poisoned fold-in chain of one
   tenant (two increments inside one watch window, the second folded
   through the poisoned first) rolled back to the tenant's last observed
   instance with both links pinned, every other tenant on its own
   instance, the two increments' warp launches recorded as
   engine_server_tenants_chain; one tenant's fold-in increment
   evicting only its own cached results; the pio_tenant_* families of
   /metrics equal to /status's counts.
15. similar_product (phase 9 above, run here).
16. ecommerce_jsonl: bench_templates.py's config 6 (100,000 users ×
   20,000 items × 5,000,000 view/buy events, 10 % buys, 20 categories;
   its first 312,500 events, cut for the script's time)
   written as an uncompacted JSONL log → pio train with the E-Commerce
   template's engine.json (rank 32, 10 iterations; warp launches =
   implied) → pio eventserver + pio deploy → 60 queries → a $set of
   constraint/unavailableItems through the event server → 12 queries;
   every answer held to a host top-k with the seen and unavailable items
   computed from the generated arrays; query latency split into the
   LEventStore reads, the top-k and the rest.
17. pio_eval: pio eval on the ML-100K shape as one JSONL app (the first
   12,500 of its ratings and 125 views, cut for the script's time):
   RecommendationEvaluation + ParamsList and ECommerceEvaluation +
   ECommerceParamsList (4 candidates × 3 folds each) on the card (warp
   launches = the folds' implied count), the E-Commerce sweep again on
   the CPU (same candidates, scores within 0.02, same best where the top
   two differ by more than 0.05); seconds per candidate and the K7
   ranking_metrics calls and ms per call.
18. classification_jsonl: bench_templates.py's config 2 (4 Poisson
   attributes × 3 classes; 125,000 of its 2,000,000 entities, cut for the
   script's time) as $set events on a JSONL
   log → pio train (the Classification template's values: naive, lambda
   1.0) → the model equal to a host numpy NB of the generated arrays →
   pio deploy → 60 queries held to it; in process, the NB statistics card
   == CPU bit for bit, and LR (regParam 0.01, 100 iterations) card vs CPU: final loss
   within 1e-5 relative, the same argmax wherever the top two logits
   differ by more than 1e-3; iterations, loss evaluations and host syncs.
18a. classification_gang: phase 18's events (byte for byte) as two
   partitions (.p0, .p1) of a new store → pio train --num-workers 2 of
   the NB engine on the partition feed (each rank replays its own
   partition, one gloo all-reduce of the statistics) → the persisted
   model equal to phase 18's bit for bit → pio deploy of it, 20 queries
   held to the host NB; pio train --num-workers 2 --feed merged of the LR
   engine on phase 18's log (each rank's row block, the loss and gradient
   all-reduced at every evaluation) held to the single-process card LR by
   the rule of phase 18; each rank's read, statistics, all-reduce and
   L-BFGS seconds and bytes.
19. text_classification_jsonl: bench_templates.py's config 4 (18,846
   documents, 120-200 tokens over 3,000 words, 20 classes) as documents
   events → pio train (numFeatures 4096, nb, lambda 1.0) → the model
   equal to a host NB of the Python tokenizer's COO → pio deploy → 60 new
   documents held to it; in process the codec's tokenize timed and equal
   to the Python loop, the COO statistics card == CPU bit for bit, and
   TextLRAlgorithm's L-BFGS card vs CPU under the rule of phase 18.
   Neither template launches a solve kernel (their paths are read as 0).
19a. text_classification_gang: pio train --num-workers 2 on phase 19's
   log (every rank reads the merged corpus and fits the same vectorizer,
   scatters its block of documents, one all-reduce of the [C·D] sums):
   the persisted model equal to phase 19's bit for bit.
19b. linear_streams: in process, the streamed input pipeline: config 2 at
   its full 2,000,000 × 4 × 3 through Naive Bayes under PIO_PIPELINE=auto
   (2 chunks) and on (chunks of 250,000), each equal to the single-shot
   statistics bit for bit, and LR (regParam 0.01, 100 iterations) on the
   streamed matrix equal to LR on the single-shot upload bit for bit;
   config 4's 18,846 documents through TextPreparator + TextNBAlgorithm
   under auto with chunk_docs 2,048, equal to the one-shot prepare + train
   bit for bit; each run's stage seconds, wall, chunks, in-flight chunks,
   overlap efficiency and the ring's peak device bytes (at most depth + 1
   chunks).
   None of 18a–19b launches a solve kernel (their paths are read as 0).
20. universal_recommender: bench_templates.py's config 5 (100,000 users ×
   20,000 items, 2,000,000 buys + 8,000,000 views, seed 4) through the
   Universal Recommender's URAlgorithm.train on the card (the fused CCO
   path: buy → buy and buy → view, 50 correlators), twice; 64 items of
   each pair whose count rows equal scipy's products of the deduped pairs
   and whose indicators meet the top-k rule against a float64 G²
   (tolerance 2e-6·N·ln N); the striped path bit-identical; the card
   against the CPU at 10,000 × 2,000 × 1,000,000 events; the counts' TF32
   route against int8 ``torch._int_mm``; dedupe, upload, counts and G² +
   top-k times, and score_user's; the indicators served host-sharded
   (4,096 rows a shard: 5 shards) for 200 users with history, every
   answer bit-identical to the flat score_user's.
21. universal_recommender_jsonl: config 5's first 12,500 buys and
   50,000 views (0.625 % of its events) and one $set per item (20 categories, an
   available/expire window on 5 % of the items) as a JSONL log → pio
   train with templates/universal-recommender/engine.json (factory
   rewritten) → pio eventserver + pio deploy → 60 queries (user-based,
   item-based, user + item, category filter and boost, blacklistItems,
   currentDate inside and before the window, cold users) held to a host
   scorer of the persisted model; latency split into the history read,
   the scoring and the rest.
21a. ur_gang: pio train --num-workers 2 on the same log (started while
   the servers boot): every rank reads the merged log and counts its
   block of the user ranges, both pairs' [I, I] counts all-reduced
   through the host; the persisted model equal to the single-process
   train's bit for bit; each rank's counts, all-reduce and G² + top-k
   times and bytes.
22. complementary_purchase: bench_templates.py's config 7 (200,000
   shoppers × 10,000 items × 2,000,000 buys over 30 days, 1 h baskets, 20
   correlators) in process on the card (basket count = the host's,
   sampled count rows exact, the top-k rule); the first 100,000 buys
   through pio train → pio deploy → 30 basket queries held to the host
   scorer; pio eval of ComplementaryEvaluation + ComplementaryParamsList
   on ≈ 500 basket buys on the card and on the CPU (scores within 0.02,
   the same best where the top two differ by more than 0.05). Neither
   template launches a solve kernel.
22a. cp_gang: pio train --num-workers 2 of the verbs' log with
   PIO_UR_FULL_MATRIX_ELEMS below I² (started while the server boots):
   the striped path, each [4,096, I] stripe all-reduced; the persisted
   model equal to the single-process (full path) train's bit for bit.
23. train_rank128: the main path's ratings at rank 128 through the same
   engine, 2 iterations: wide-kernel launches equal to the implied count
   and no warp-kernel launch, the RMSE check, steady seconds per
   iteration, one iteration profiled; one fold-in batch (2 wide launches,
   card vs CPU).
24. soak_full_menu (in a thread beside 4–7b): the reference's headline
   soak, pio soak --device cuda --faults full of tests/torch_soak_engine.py
   with every other flag at the CLI's default (60 s, 2 event workers, a
   2-replica fleet, 3 apps, ingest 50/s, queries 20/s, fold-in 250 ms,
   watch 2,500 ms, quality sample 1.0): PASS, all eight faults fired with
   evidence, every acknowledged event reconciled once, an observed
   rollback-window row for each of the three poisoned publishes.
25. soak_tenants (in a thread beside 8–10): the reference's multi-tenant
   soak (seed 45, 16 s, 1 worker, one engine process, 5 apps through 2
   resident slots, ENOSPC and a poisoned fold-in) with the fold-in at
   250 ms: PASS, a row per tenant offered and answered, evictions ≥ 1,
   the poisoned increment rolled back within its window.
   Neither soak's engine launches a solve kernel.

Five overlaps keep the script inside its time: phases 15–19b run in a
second process (this script with --tail-group) while the main one runs
14 and 20–23, 12d runs in a thread beside 12g, 12h in a thread beside
12g and 13, 24 beside 4–7b and 25 beside 8–10 (none launches a kernel
that a path of this process counts). Each pair is bound by process starts
and the host, so it takes about as long as its longer half. The second
process's phase lines are printed when both groups are done; its paths'
launches join the kernels line.

Each path runs with every launch counter at 0 just before it and is read
just after; the kernels line sums the paths' launches per kernel.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Every printed line carries the card's name
and power limit.
"""

from __future__ import annotations

import calendar
import contextlib
import dataclasses
import datetime as _dt
import http.client
import importlib.util
import io
import json
import os
import resource
import shutil
import signal
import socket
import sqlite3
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib

import numpy as np
import torch

from incubator_predictionio_torch import native
from incubator_predictionio_torch.common.nan_guard import NaNGuardError
from incubator_predictionio_torch.controller import Engine, EngineParams
from incubator_predictionio_torch.data.bimap import BiMap, IdentityBiMap
from incubator_predictionio_torch.data.api import event_log
from incubator_predictionio_torch.data.storage import App, Event, Storage
from incubator_predictionio_torch.data.storage.event import new_event_id
from incubator_predictionio_torch.data.storage.jsonl import JSONLEvents
from incubator_predictionio_torch.data.storage.jsonl import (
    shard_paths as jsonl_shard_paths,
)
from incubator_predictionio_torch.data.store import PEventStore, p_event_store
from incubator_predictionio_torch.device import resolve_device
from incubator_predictionio_torch.data.events import (
    aggregate_properties, find_ratings, read_events,
)
from incubator_predictionio_torch.models import (
    complementary_purchase, similar_product, universal_recommender,
)
from incubator_predictionio_torch.models.recommendation import (
    ALSModel, RecommendationEngine, TrainingData, model_to_persisted,
)
from incubator_predictionio_torch.ops import _build, als, llr, spd_solve
from incubator_predictionio_torch.ops.als import (
    ALSFactors, ALSParams, ALSTrainer, predict_rmse,
    solve_calls_per_half_step, train_als,
)
from incubator_predictionio_torch.ops.rowblocks import plan_layout
from incubator_predictionio_torch.workflow import model_artifact
from incubator_predictionio_torch.workflow.checkpoint import (
    CheckpointHook, CheckpointIncompatibleError,
)
from incubator_predictionio_torch.workflow.context import WorkflowContext
from incubator_predictionio_torch.workflow.create_server import EngineServer
from incubator_predictionio_torch.workflow.persist import (
    load_models, models_from_bytes, save_models,
)
from incubator_predictionio_torch.workflow.workflow_params import WorkflowParams

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-4  # tests/test_pallas_kernels.py:41
RANK = 32
ITERS = 3  # ALS iterations of the main path (10 in BASELINE.json; cut for time)
WIDE_RANK = 128  # the top of the Gauss-Jordan range: the wide kernel's path
WIDE_ITERS = 2
CHUNKED_LAUNCHES_PER_ITERATION = 348  # one solve launch per 512-row chunk
ML20M = (138_493, 26_744, 20_000_263)  # bench.py SCALES["ml20m"]
ML100K = (943, 1682, 100_000)  # bench.py SCALES["ml100k"]
#: bench_templates.py config 3 (Similar-Product): users, items, views
SIMILAR = (100_000, 20_000, 5_000_000)
SIMILAR_CATEGORIES = 20
#: fold-in batches (new users, new items, events) at rank 32 and rank 128
FOLD_IN = (2_000, 500, 20_000)
FOLD_IN_RANK128 = (200, 50, 2_000)
CARD = ""  # "name, power limit" from nvidia-smi, set in phase 0
#: each path's kernel launches, counted from 0 over that path's run
PATH_LAUNCHES: dict = {}
START = time.perf_counter()
#: held while a line is printed, and while a verb called in process has
#: stdout redirected: a phase that runs beside another (_Beside) neither
#: splits a line nor loses one into the verb's capture
STDOUT_LOCK = threading.Lock()


def emit(phase: str, **fields) -> None:
    """One phase line, with the seconds since the script started."""
    line = json.dumps({"phase": phase, "card": CARD,
                       "elapsed_s": time.perf_counter() - START, **fields})
    with STDOUT_LOCK:
        print(line, flush=True)


def peak_rates() -> tuple[float, float, str]:
    """(bytes/s, float32 FLOP/s outside the tensor cores, part) from the
    data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s; PCIe 2.0 TB/s and
    51 TFLOP/s; NVL 3.9 TB/s and 60 TFLOP/s."""
    name = torch.cuda.get_device_name(0)
    if "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe"
    if "NVL" in name:
        return 3.9e12, 60e12, "H100 NVL"
    return 3.35e12, 67e12, "H100 SXM"


def solve_bound_ms(n: int, k: int) -> tuple[float, str]:
    """Least time for n k×k solves: each of A, b read once and x written
    once, (k² + 2k)·4 bytes; ≈ k³ float32 operations (the elimination of
    columns > j only, k³/2 multiply-adds)."""
    bw, flops, _ = peak_rates()
    t_bytes = n * (k * k + 2 * k) * 4 / bw
    t_ops = n * k ** 3 / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def loop_ms(fn, reps: int) -> float:
    """Per-call time of a loop of reps calls, CUDA events around it, after
    a warm-up: what a caller that launches back to back waits, host work
    included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def cuda_kernels(prof) -> list:
    """The profiler's per-name averages of what ran on the card."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def profiled_ms(kernels, reps: int, symbol: str = "",
                launches: int = 0) -> tuple:
    """(device ms per call, records it rests on) from one profile's
    per-name kernel averages (``key``, ``count``, ``self_device_time_total``
    in µs). The profiler can drop records of a kernel (one of five
    launches seen at 8,192 × 128), so each name's time is divided by its
    own record count, never by ``reps``. With ``symbol``: that kernel's
    rows only, times the launches per call that its wrapper's counter saw
    in the window (``launches`` / ``reps``; 1 without a count). Without:
    each name's time per record times its records per call (rounded, at
    least 1). (None, 0) when the profile holds no such record."""
    rows = [e for e in kernels if e.count > 0
            and (not symbol or symbol in e.key)]
    records = sum(e.count for e in rows)
    if not records:
        return None, 0
    if symbol:
        per_call = launches / reps if launches else 1.0
        us = sum(e.self_device_time_total for e in rows) / records * per_call
    else:
        us = sum(e.self_device_time_total / e.count
                 * max(1, round(e.count / reps)) for e in rows)
    return us / 1e3, records


def device_profile(fn, reps: int, symbol: str = "", counter=None) -> dict:
    """Device time per call of ``fn`` (torch.profiler over reps calls,
    :func:`profiled_ms`), the profiler's records of it and the launches
    ``counter`` (a wrapper's launch counter) saw in the window. Host time
    between launches is left out, so this is what the work itself costs
    the card. A profile with no record is taken once more; ``ms`` is
    None when the second one has none either."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        before = counter.count if counter is not None else 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = counter.count - before if counter is not None else None
        ms, records = profiled_ms(cuda_kernels(prof), reps, symbol,
                                  launched or 0)
        if ms is not None:
            break
    return {"ms": ms, "records": records, "launched": launched,
            "profiles": attempt}


def device_ms(fn, reps: int, required: bool = True):
    """:func:`device_profile`'s ms per call of every kernel ``fn``
    launches. When two profiles saw no device time: fails, or, not
    ``required``, None (not measured)."""
    ms = device_profile(fn, reps)["ms"]
    if ms is None:
        check(not required, "the profiler saw no device time in two "
              "profiles")
    return ms


def random_spd(n: int, k: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference test's systems (M Mᵀ + I), made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    m = torch.randn((n, k, k), generator=g, device=device)
    a = torch.bmm(m, m.transpose(1, 2)) + torch.eye(k, device=device)
    b = torch.randn((n, k), generator=g, device=device)
    return a, b


def als_like_spd(n: int, k: int, rows: int, seed: int, device):
    """Nearly singular systems as ALS makes them for a row with fewer
    ratings than the rank: the gram of ``rows`` < k counterpart factors
    (standard normal / √k, the trainer's init) plus a 0.01 ridge."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn((n, rows, k), generator=g, device=device) / k ** 0.5
    a = torch.bmm(y.transpose(1, 2), y) + 0.01 * torch.eye(k, device=device)
    r = torch.randint(1, 11, (n, rows), generator=g, device=device) / 2.0
    b = torch.bmm(y.transpose(1, 2), r[:, :, None])[..., 0]
    return a, b


def reset_launches() -> None:
    for counter in (spd_solve.gauss_jordan_launches,
                    spd_solve.gauss_jordan_warp_launches,
                    spd_solve.gauss_jordan_wide_launches):
        counter.reset()


def launches() -> dict:
    return {"total": spd_solve.gauss_jordan_launches.count,
            "warp": spd_solve.gauss_jordan_warp_launches.count,
            "wide": spd_solve.gauss_jordan_wide_launches.count}


def record(path: str, got: dict) -> None:
    """Keep one path's launches (counted from 0 over its run); a path that
    launched no kernel fails."""
    check(got["warp"] + got["wide"] > 0, f"path {path} launched no kernel")
    PATH_LAUNCHES[path] = {"warp": got["warp"], "wide": got["wide"]}


def implied_launches(u, i, n_users: int, n_items: int, params: ALSParams,
                     iterations: int) -> tuple[int, int, int]:
    """(launches, user calls, item calls per iteration) the layout implies."""
    calls_u = solve_calls_per_half_step(
        plan_layout(np.bincount(u, minlength=n_users)), params)
    calls_i = solve_calls_per_half_step(
        plan_layout(np.bincount(i, minlength=n_items)), params)
    return iterations * (calls_u + calls_i), calls_u, calls_i


def max_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def within(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.allclose(a, b, rtol=TOL, atol=TOL))


def als_engine(rank: int, iterations: int, lam: float,
               scaling: str = "plain", dtype: str = ""):
    """(engine, engine.json, ALSAlgorithm) of the Recommendation template
    (``dtype``: its ``computeDtype``, when given)."""
    engine_json = {
        "engineFactory": "incubator_predictionio_torch.models.recommendation."
                         "RecommendationEngine",
        "datasource": {"params": {"appName": "ml20m-synth"}},
        "algorithms": [{"name": "als", "params": {
            "rank": rank, "numIterations": iterations, "lambda": lam,
            "lambdaScaling": scaling,
            **({"computeDtype": dtype} if dtype else {})}}],
    }
    engine = RecommendationEngine()()
    _, _, algo_list, _ = engine.make_components(
        EngineParams.from_json(engine_json))
    return engine, engine_json, algo_list[0][1]


def synth_ratings(n_users: int, n_items: int, nnz: int, seed: int = 7):
    """bench.py's synth_ratings: Zipf-ish items, ratings 0.5..5.0."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = (n_items * rng.random(nnz) ** 2).astype(np.int32)
    i = np.minimum(i, n_items - 1)
    r = rng.integers(1, 11, nnz).astype(np.float32) / 2.0
    return u, i, r


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phases -----------------------------------------------------------------


def phase_device() -> None:
    global CARD
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD = out.stdout.strip().splitlines()[0]
    print(out.stdout.strip(), flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), peak_part=peak_rates()[2])
    # the port's parity rests on full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


#: where the Python processes this script starts keep their compiled
#: bytecode: the card host sets PYTHONDONTWRITEBYTECODE and its torch has
#: no .pyc files, so without it every process compiled torch's sources
#: again (≈ 6 s of each verb's start)
PYCACHE = os.path.join(ROOT, "build", "pycache")
#: what the bytecode cache is warmed with (the verbs' imports)
PYCACHE_WARM = (
    "import torch, torch.distributed, torch.profiler; "
    "import incubator_predictionio_torch.tools.console, "
    "incubator_predictionio_torch.tools.commands.engine, "
    "incubator_predictionio_torch.workflow.core_workflow, "
    "incubator_predictionio_torch.workflow.create_server, "
    "incubator_predictionio_torch.workflow.evaluation_workflow, "
    "incubator_predictionio_torch.parallel.supervisor, "
    "incubator_predictionio_torch.models.recommendation, "
    "incubator_predictionio_torch.models.similar_product, "
    "incubator_predictionio_torch.models.ecommerce, "
    "incubator_predictionio_torch.models.classification, "
    "incubator_predictionio_torch.models.text_classification, "
    "incubator_predictionio_torch.models.universal_recommender, "
    "incubator_predictionio_torch.models.complementary_purchase, "
    "incubator_predictionio_torch.models.template_evals")


def _warm_first_use(out: dict) -> None:
    """The process's first profile (CUPTI's set-up) and its first cuBLAS
    and cuSOLVER calls (the libraries' load) cost seconds once; made here
    on a tiny input they stay out of kernel_time's first timed shape.
    Called on the main thread: CUPTI registers its client on the thread
    of the first profile, and every later profile (:func:`device_ms`)
    is taken on the main thread."""
    t0 = time.perf_counter()
    try:
        a, b = random_spd(1, 4, seed=0, device=torch.device("cuda"))
        spd_solve.cholesky_solve(a, b)
        device_ms(lambda: torch.mm(a[0], a[0]), 1, required=False)
        torch.cuda.synchronize()
    except BaseException as e:  # noqa: BLE001 - checked by the caller
        out["error"] = repr(e)
    out["seconds"] = time.perf_counter() - t0


def phase_build() -> None:
    t0 = time.perf_counter()
    # nvcc builds in a helper thread (it only waits on the compiler's
    # process) while the main thread makes the first-use set-up of the
    # profiler and the solver libraries: the profiler's first use stays on
    # the thread that takes every later profile
    nvcc: dict = {}

    def build_nvcc():
        try:
            spd_solve.build_kernel()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            nvcc["error"] = e

    nvcc_thread = threading.Thread(target=build_nvcc, name="nvcc")
    nvcc_thread.start()
    first_use: dict = {}
    # every process started from here on reads and writes compiled
    # bytecode under PYCACHE; one process warms it beside nvcc
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    warm = subprocess.Popen([sys.executable, "-c", PYCACHE_WARM],
                            env=_console_env(), cwd=ROOT,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    # the event codec (g++, host code) builds beside nvcc
    codec: dict = {}
    thread = threading.Thread(
        target=lambda: codec.update(line=native.status(),
                                    seconds=native.build_seconds))
    thread.start()
    try:
        _warm_first_use(first_use)
        nvcc_thread.join()
        thread.join()
        _, warm_err = warm.communicate(timeout=600)
    finally:
        if warm.poll() is None:
            warm.kill()
            warm.wait()
        warm_s = time.perf_counter() - t0
        nvcc_thread.join()
    if "error" in nvcc:
        raise nvcc["error"]
    check("error" not in first_use,
          f"the first-use warm-up failed: {first_use.get('error')}")
    check(warm.returncode == 0,
          f"warming the bytecode cache failed: {warm_err[-2000:]}")
    check("line" in codec, "the event codec did not build")
    info = _build.build_info["gauss_jordan"]
    log = info["log"].splitlines()
    # "Compiling entry function '<mangled name>'" lines name each kernel;
    # the registers and spill lines follow it
    emit("build", kernel="gauss_jordan", seconds=time.perf_counter() - t0,
         nvcc_seconds=info["seconds"],
         ptxas=[ln.strip() for ln in log if "Compiling entry" in ln
                or "registers" in ln or "spill" in ln],
         codec=codec["line"], codec_seconds=codec["seconds"],
         bytecode_cache=PYCACHE, bytecode_warm_seconds=warm_s,
         first_use_warm_seconds=first_use["seconds"])


WIDE_KS = tuple(range(40, 129, 8))  # every K the wide kernel is built for
#: the kernels' symbols, as a profile or a trace names them
WARP_SYMBOL = "gauss_jordan_warp_kernel"
WIDE_SYMBOL = "gauss_jordan_wide_kernel"
#: (n, k, reps) of each timed shape (reps halved for the script's time
#: when the CCO gang and serving-mesh phases came)
TIMED = ((512, 32, 100), (ML20M[0], 32, 5), (512, 64, 25), (512, 96, 25),
         (512, 128, 25), (8192, 128, 5))


def phase_kernel_vs_plain() -> dict:
    dev = torch.device("cuda")
    cases = [(5, 10), (300, 32), (130, 7), (1, 1), (513, 16), (40, 80),
             (24, 128), (9, 100), (511, 8), (513, 8), (1025, 8),
             (512, 32), (ML20M[0], 32), (8192, 128)]
    cases += [(n, k) for k in WIDE_KS for n in (1, 511, 513, 4096)]
    worst = {"warp": 0.0, "wide": 0.0}
    for n, k in cases:
        a, b = random_spd(n, k, seed=n + k, device=dev)
        x = spd_solve.batched_spd_solve(a, b)
        torch.cuda.synchronize()
        x_plain = spd_solve.gauss_jordan_plain(a, b)
        err = (x - x_plain).abs().max().item()
        ok = torch.allclose(x, x_plain, rtol=TOL, atol=TOL)
        kind = "warp" if k <= spd_solve.MAX_WARP_K else "wide"
        emit("kernel_vs_plain", n=n, k=k, kernel=kind, max_abs_err=err, ok=ok)
        check(ok, f"kernel disagrees with plain at n={n} k={k}: {err}")
        check(bool(torch.isfinite(x).all()), f"non-finite x at n={n} k={k}")
        worst[kind] = max(worst[kind], err)

    # nearly singular ALS-like systems (fewer ratings than the rank): held
    # to a relative-norm gap of 1e-2, as the plain-λ ALS parity is
    near_singular = []
    for k in (32, 64, 96, 128):
        a, b = als_like_spd(4096, k, rows=k // 4, seed=k, device=dev)
        x = spd_solve.batched_spd_solve(a, b)
        torch.cuda.synchronize()
        x_plain = spd_solve.gauss_jordan_plain(a, b)
        err = (x - x_plain).abs().max().item()
        rel = ((x - x_plain).norm() / x_plain.norm()).item()
        ok = torch.allclose(x, x_plain, rtol=TOL, atol=TOL)
        case = dict(n=4096, k=k, counterpart_rows=k // 4, ridge=0.01,
                    max_abs_err=err, rel_norm_err=rel, within_2e4=ok)
        emit("kernel_vs_plain_near_singular", **case)
        check(bool(torch.isfinite(x).all()), f"non-finite x at k={k}")
        check(rel < 1e-2, f"near-singular gap {rel} at k={k}")
        near_singular.append(case)

    timings = {}
    for n, k, reps in TIMED:
        a, b = random_spd(n, k, seed=1, device=dev)
        kernel = lambda: spd_solve.batched_spd_solve(a, b)  # noqa: E731
        plain = lambda: spd_solve.gauss_jordan_plain(a, b)  # noqa: E731
        library = lambda: spd_solve.cholesky_solve(a, b)  # noqa: E731
        bound_ms, bound_by = solve_bound_ms(n, k)
        prof = device_profile(kernel, reps, symbol=(
            WARP_SYMBOL if k <= spd_solve.MAX_WARP_K else WIDE_SYMBOL),
            counter=spd_solve.gauss_jordan_launches)
        check(prof["ms"] is not None, f"the profiler saw no record of the "
              f"kernel at n={n} k={k} in two profiles")
        timings[(n, k)] = dict(
            ms=prof["ms"], profiled_records=prof["records"],
            counted_launches=prof["launched"], profiles=prof["profiles"],
            plain_ms=device_ms(plain, max(1, reps // 10)),
            library_ms=device_ms(library, reps),
            bound_ms=bound_ms, bound_by=bound_by,
            loop_ms=loop_ms(kernel, reps),
            plain_loop_ms=loop_ms(plain, max(1, reps // 10)),
            library_loop_ms=loop_ms(library, reps))
        emit("kernel_time", n=n, k=k, **timings[(n, k)])
        del a, b
    return {"max_abs_err": worst, "near_singular": near_singular,
            "timings": timings}


def phase_als_card_vs_cpu() -> None:
    """Held at 2e-4 with ALS-WR scaling (λ·n_ratings), whose systems are
    well conditioned. With plain λ = 0.01 (the main path's setting) items
    with fewer ratings than the rank solve nearly singular systems (ridge
    0.01), where two correct float32 solvers (the reference's Cholesky and
    the port's Gauss-Jordan, both on the CPU) already drift apart by more
    than 2e-4 over 3 iterations; that case is reported and held to a
    relative-norm gap of 1e-2.

    Rank 128 (the wide kernel) runs with λ = 0.1·n_ratings, 2 iterations:
    most items have fewer ratings than the rank, and at 0.01·n_ratings two
    correct float32 solvers part by ~1e-3 already on the CPU
    (tests/test_torch_als.py).

    Implicit ALS (the Similar-Product path: the shared YᵀY term and the
    confidence weights 1 + α·r) is held at 2e-4 at the main path's plain
    λ = 0.01, binary (every rating 1, as views) and weighted: the full YᵀY
    keeps every system well conditioned."""
    u, i, r = synth_ratings(*ML100K, seed=11)
    ones = np.ones_like(r)
    for rank, iters, reg, scaling, strict, implicit, ratings in (
            (RANK, 3, 0.01, "nratings", True, False, r),
            (RANK, 3, 0.01, "plain", False, False, r),
            (WIDE_RANK, 2, 0.1, "nratings", True, False, r),
            (RANK, 3, 0.01, "plain", True, True, ones),
            (RANK, 3, 0.01, "plain", True, True, r)):
        params = ALSParams(rank=rank, num_iterations=iters, reg=reg, seed=3,
                           lambda_scaling=scaling, implicit_prefs=implicit,
                           alpha=1.0)
        reset_launches()
        t0 = time.perf_counter()
        f_gpu = train_als(u, i, ratings, ML100K[0], ML100K[1], params,
                          device="cuda")
        gpu_s = time.perf_counter() - t0
        got = launches()
        check(got["total"] > 0, f"ALS on the card launched no kernel: {got}")
        f_cpu = train_als(u, i, ratings, ML100K[0], ML100K[1], params,
                          device="cpu")
        err_u = float(np.abs(f_gpu.user_factors - f_cpu.user_factors).max())
        err_i = float(np.abs(f_gpu.item_factors - f_cpu.item_factors).max())
        rel = max(
            float(np.linalg.norm(a - b) / np.linalg.norm(b))
            for a, b in ((f_gpu.user_factors, f_cpu.user_factors),
                         (f_gpu.item_factors, f_cpu.item_factors)))
        ok = (np.allclose(f_gpu.user_factors, f_cpu.user_factors, rtol=TOL,
                          atol=TOL)
              and np.allclose(f_gpu.item_factors, f_cpu.item_factors,
                              rtol=TOL, atol=TOL))
        emit("als_card_vs_cpu", shape=ML100K, rank=rank, iterations=iters,
             reg=reg, lambda_scaling=scaling, implicit=implicit,
             binary=bool(implicit and ratings is ones), kernel_launches=got,
             max_abs_err_user=err_u,
             max_abs_err_item=err_i, rel_norm_err=rel, within_2e4=ok,
             held_to="rtol=atol=2e-4" if strict else "rel_norm_err<1e-2",
             card_train_seconds=gpu_s)
        if strict:
            check(ok, f"ALS factors on the card differ from the CPU's: "
                      f"{err_u}, {err_i}")
        else:
            check(rel < 1e-2, f"ALS factors drift {rel} (relative norm)")


#: bfloat16 against the CPU: the relative-norm gap and the training RMSE's
#: relative difference a case is held to
BF16_REL_NORM = 1e-2
BF16_RMSE_REL = 1e-3
#: bfloat16 after one iteration against the CPU's, relative norm: the
#: roundings have not yet compounded, so at most a fifth of the
#: bfloat16-vs-float32 gap after one iteration (held ≥ BF16_ONE_ITER_GAP
#: on the same inputs)
BF16_ONE_ITER = 2e-4
BF16_ONE_ITER_GAP = 5 * BF16_ONE_ITER
#: a bfloat16 train's factors against the float32 train's of the same
#: inputs, relative norm, at least: a card dispatch that ignored
#: compute_dtype would land within float32 noise (~1e-6) of them
BF16_MIN_GAP = 1e-3


def rel_norm(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def phase_als_bf16_card_vs_cpu() -> None:
    """``compute_dtype="bfloat16"`` on the card against the same on the CPU
    at the ML-100K shape: rank 32 λ 0.01·n explicit, implicit binary and
    implicit weighted at λ 0.01, and rank 128 at λ 0.1·n, 2 iterations (the
    wide kernel). Both devices round the same factors to bfloat16, but
    their float32 sums run in another order, so a few roundings of the
    counterpart rows flip and add up over the iterations: each case is
    held to a relative-norm gap of 1e-2 and a training RMSE within 0.1 %
    of the CPU's, not to 2e-4 elementwise. Launches equal the solve calls
    of the layout under bfloat16 chunk sizing. After one iteration the
    flips have not compounded: there the card is held to the CPU's
    bfloat16 factors within BF16_ONE_ITER, at most a fifth of the
    bfloat16-vs-float32 gap of the same inputs on the CPU, which a float32
    train on the card would not meet."""
    u, i, r = synth_ratings(*ML100K, seed=11)
    ones = np.ones_like(r)
    for rank, iters, reg, scaling, implicit, ratings in (
            (RANK, 3, 0.01, "nratings", False, r),
            (RANK, 3, 0.01, "plain", True, ones),
            (RANK, 3, 0.01, "plain", True, r),
            (WIDE_RANK, 2, 0.1, "nratings", False, r)):
        params = ALSParams(rank=rank, num_iterations=iters, reg=reg, seed=3,
                           lambda_scaling=scaling, implicit_prefs=implicit,
                           alpha=1.0, compute_dtype="bfloat16")
        expected, _, _ = implied_launches(u, i, ML100K[0], ML100K[1], params,
                                          iters)
        reset_launches()
        t0 = time.perf_counter()
        f_gpu = train_als(u, i, ratings, ML100K[0], ML100K[1], params,
                          device="cuda")
        gpu_s = time.perf_counter() - t0
        got = launches()
        f_cpu = train_als(u, i, ratings, ML100K[0], ML100K[1], params,
                          device="cpu")
        rel = max(rel_norm(f_gpu.user_factors, f_cpu.user_factors),
                  rel_norm(f_gpu.item_factors, f_cpu.item_factors))
        rmse_gpu = predict_rmse(f_gpu, u, i, ratings)
        rmse_cpu = predict_rmse(f_cpu, u, i, ratings)
        kind = "wide" if rank > 32 else "warp"
        emit("als_bf16_card_vs_cpu", shape=ML100K, rank=rank,
             iterations=iters, reg=reg, lambda_scaling=scaling,
             implicit=implicit, binary=bool(implicit and ratings is ones),
             kernel_launches=got, expected_launches=expected,
             rel_norm_err=rel, max_abs_err_user=max_err(
                 f_gpu.user_factors, f_cpu.user_factors),
             max_abs_err_item=max_err(f_gpu.item_factors,
                                      f_cpu.item_factors),
             train_rmse_card=rmse_gpu, train_rmse_cpu=rmse_cpu,
             held_to=f"rel_norm_err<={BF16_REL_NORM}, RMSE within "
                     f"{BF16_RMSE_REL:.1%}", card_train_seconds=gpu_s)
        check(got[kind] == expected == got["total"] > 0,
              f"bf16 launches {got} != implied {expected} {kind}")
        check(rel <= BF16_REL_NORM,
              f"bf16 factors on the card drift {rel} (relative norm)")
        check(abs(rmse_gpu / rmse_cpu - 1) <= BF16_RMSE_REL,
              f"bf16 RMSE card {rmse_gpu} vs CPU {rmse_cpu}")
        one = dataclasses.replace(params, num_iterations=1)
        f1 = [train_als(u, i, ratings, ML100K[0], ML100K[1],
                        dataclasses.replace(one, compute_dtype=dt),
                        device=dev)
              for dev, dt in (("cuda", "bfloat16"), ("cpu", "bfloat16"),
                              ("cpu", "float32"))]
        rel1 = max(rel_norm(f1[0].user_factors, f1[1].user_factors),
                   rel_norm(f1[0].item_factors, f1[1].item_factors))
        gap1 = max(rel_norm(f1[1].user_factors, f1[2].user_factors),
                   rel_norm(f1[1].item_factors, f1[2].item_factors))
        emit("als_bf16_card_vs_cpu_one_iteration", rank=rank,
             lambda_scaling=scaling, implicit=implicit,
             binary=bool(implicit and ratings is ones), rel_norm_err=rel1,
             cpu_bf16_vs_float32=gap1,
             held_to=f"rel_norm_err<={BF16_ONE_ITER}, cpu_bf16_vs_float32"
                     f">={BF16_ONE_ITER_GAP}")
        check(gap1 >= BF16_ONE_ITER_GAP,
              f"bf16 vs float32 after one iteration only {gap1}: the "
              f"one-iteration hold cannot tell them apart")
        check(rel1 <= BF16_ONE_ITER,
              f"bf16 after one iteration, card vs CPU: {rel1} (relative "
              f"norm; bf16 vs float32 {gap1})")


def _post(conn: http.client.HTTPConnection, obj) -> tuple[int, dict, float]:
    body = json.dumps(obj)
    t0 = time.perf_counter()
    conn.request("POST", "/queries.json", body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, json.loads(data), (time.perf_counter() - t0) * 1e3


def serve_checks(deployment, queries, check_answer) -> dict:
    """Serve ``deployment`` over HTTP on a free port, POST every query on
    one keep-alive connection, hold each answer to ``check_answer(query,
    result)``; returns the latency percentiles (the first query, which
    opens the connection, left out)."""
    server = EngineServer(deployment=deployment)
    host, port = server.start()
    conn = http.client.HTTPConnection(host, port, timeout=30)
    lat = []
    try:
        for q in queries:
            status, res, ms = _post(conn, q)
            check(status == 200, f"query status {status}: {res}")
            check_answer(q, res)
            lat.append(ms)
    finally:
        conn.close()
        server.stop()
    lat_s = np.sort(np.asarray(lat[1:]))
    return {"queries": len(queries), "p50_ms": float(np.percentile(lat_s, 50)),
            "p99_ms": float(np.percentile(lat_s, 99))}


def check_user_answer(uf: np.ndarray, itf: np.ndarray, user: int,
                      res: dict, num: int = 10) -> None:
    """Against the host: the served scores are the dot products and no
    item outside the answer scores higher."""
    s = itf @ uf[user]
    got = [int(e["item"]) for e in res["itemScores"]]
    scores = [e["score"] for e in res["itemScores"]]
    check(len(got) == num and scores == sorted(scores, reverse=True),
          f"bad answer {res}")
    check(np.allclose(s[got], scores, rtol=1e-4, atol=1e-4),
          "served scores differ from the host's")
    check(np.sort(s)[::-1][num - 1] <= scores[-1] + 1e-4,
          "served top-k misses a better item")


def phase_main_path(workdir: str) -> dict:
    n_users, n_items, nnz = ML20M
    u, i, r = synth_ratings(n_users, n_items, nnz)
    engine, engine_json, algo = als_engine(RANK, ITERS, 0.01)
    # the product path with a benchmark's timings dict planted on it
    ctx = WorkflowContext(device="cuda")
    ctx.bench_timings = {}
    td = TrainingData(u, i, r, IdentityBiMap(n_users), IdentityBiMap(n_items))

    # the launches the layout implies: fused chunks + heavy bucket, per side
    als_params = algo.als_params(algo.params)
    plan_u = plan_layout(np.bincount(u, minlength=n_users))
    plan_i = plan_layout(np.bincount(i, minlength=n_items))
    calls_u = solve_calls_per_half_step(plan_u, als_params)
    calls_i = solve_calls_per_half_step(plan_i, als_params)
    expected = ITERS * (calls_u + calls_i)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches_train = launches()
    record("main", launches_train)

    uf, itf = model.factors.user_factors, model.factors.item_factors
    check(uf.shape == (n_users, RANK) and itf.shape == (n_items, RANK),
          f"factor shapes {uf.shape} {itf.shape}")
    check(bool(np.isfinite(uf).all() and np.isfinite(itf).all()),
          "non-finite factors")
    sample = np.random.default_rng(0).choice(nnz, min(nnz, 1_000_000), replace=False)
    rmse = predict_rmse(model.factors, u[sample], i[sample], r[sample])
    check(rmse < float(np.std(r)), f"train RMSE {rmse} not below std")
    emit("train", events=nnz, iterations=ITERS, rank=RANK,
         train_seconds=train_s,
         train_events_per_s_end_to_end=nnz * ITERS / train_s,
         kernel_launches=launches_train, expected_launches=expected,
         solve_calls_per_iteration={"user": calls_u, "item": calls_i},
         chunked_launches_per_iteration=CHUNKED_LAUNCHES_PER_ITERATION,
         buckets={"user": len(plan_u.lengths), "item": len(plan_i.lengths)},
         heavy_bucket={"user": plan_u.has_heavy_bucket,
                       "item": plan_i.has_heavy_bucket},
         train_rmse_1m_sample=rmse)
    check(launches_train["warp"] == expected == launches_train["total"],
          f"kernel launches {launches_train} != implied {expected}")
    check(calls_u + calls_i < CHUNKED_LAUNCHES_PER_ITERATION,
          f"{calls_u + calls_i} launches per iteration, not fewer than "
          f"one per chunk")
    tm = ctx.bench_timings
    check(set(tm) == {"upload_seconds", "compile_seconds",
                      "device_train_seconds"}, f"timings keys {sorted(tm)}")
    emit("train_timings", **tm, iterations=ITERS,
         train_events_per_s_device=nnz * ITERS / tm["device_train_seconds"],
         seconds_per_iteration=tm["device_train_seconds"] / ITERS)

    # persist → restore → serve
    path = os.path.join(workdir, "ml20m_model.npz")
    save_models(path, engine_json, [algo.prepare_model_for_persistence(model)])
    engine_json2, stored = load_models(path)
    deployment = engine.prepare_deployment(
        WorkflowContext(device="cuda"), EngineParams.from_json(engine_json2),
        stored)
    deployment.models[0].warm_up()
    check(np.array_equal(deployment.models[0].factors.item_factors, itf),
          "restored factors differ")
    rng = np.random.default_rng(1)
    users = [int(rng.integers(0, n_users)) for _ in range(200)]
    checked = iter(range(5))

    def answer(q, res):
        if "items" in q:  # ranking mode: the given candidates, reordered
            check(len(res["itemScores"]) == 3, f"ranking {res}")
        elif next(checked, None) is not None:  # the first five: the host's
            check_user_answer(uf, itf, int(q["user"]), res)

    lat = serve_checks(deployment, [{"user": str(x), "num": 10}
                                    for x in users]
                       + [{"user": "0", "items": ["5", "nope", "3"]}], answer)
    emit("serve", **lat, catalog=n_items)

    # steady state: the same training state, timed iterations only; the
    # user side's columns (26,744 item slots) as uint16 and as int32, in
    # turns
    trainer = ALSTrainer(u, i, r, n_users, n_items, als_params, device="cuda")
    check(trainer.side_u.narrow and not trainer.side_i.narrow,
          "uint16 narrowing: the user side only at ML-20M")
    narrow_max = als._NARROW_COL_MAX
    als._NARROW_COL_MAX = -1
    try:
        trainer_int32 = ALSTrainer(u, i, r, n_users, n_items, als_params,
                                   device="cuda")
    finally:
        als._NARROW_COL_MAX = narrow_max
    check(not trainer_int32.side_u.narrow, "int32 trainer narrowed")
    runs = {"uint16": [], "int32": []}
    for t in (trainer, trainer_int32):
        t.iterate(1)
    for _ in range(2):
        for name, t in (("uint16", trainer), ("int32", trainer_int32)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.iterate(ITERS)
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t0) / ITERS)
    del trainer_int32
    steady_s = runs["uint16"][0] * ITERS
    emit("train_steady", events=nnz, iterations=ITERS,
         seconds=steady_s, train_events_per_s=nnz * ITERS / steady_s,
         seconds_per_iteration=steady_s / ITERS,
         seconds_per_iteration_uint16_columns=runs["uint16"],
         seconds_per_iteration_int32_columns=runs["int32"],
         train_events_per_s_device_timings=nnz * ITERS
         / tm["device_train_seconds"])
    profiled = profile_iteration(trainer)
    del trainer
    return {"launches": launches_train["warp"], "expected": expected,
            "rmse": rmse, "steady_ms": [1e3 * x for x in runs["uint16"]],
            "profile": profiled,
            "ratings": (u, i, r), "als_params": als_params,
            "calls_per_iteration": calls_u + calls_i, "model": model,
            "engine": engine, "engine_json": engine_json, "algo": algo}


def phase_train_bf16(workdir: str, main: dict) -> None:
    """The main path in bfloat16: the ML-20M triple through the
    Recommendation engine with ``"computeDtype": "bfloat16"`` (rank 32, 3
    iterations, λ 0.01) on ``WorkflowContext(device="cuda")``. Held: warp
    launches equal to the implied count; finite factors; training RMSE
    within 0.1 % of the float32 main path's, and factors at least
    BF16_MIN_GAP from its (relative norm), which a float32 train would not
    meet; 20 served queries held to the host top-k. Reported, not held:
    the reference's rule (max |bf16 − float32| < 0.05 × the
    largest float32 factor). Then a float32 and a bfloat16 trainer of the
    same triple, steady iterations in turns and one profiled iteration
    each: device-busy ms and the gather's share, beside the main path's."""
    n_users, n_items, nnz = ML20M
    u, i, r = main["ratings"]
    engine, engine_json, algo = als_engine(RANK, ITERS, 0.01,
                                           dtype="bfloat16")
    params = algo.als_params(algo.params)
    check(params.compute_dtype == "bfloat16", f"params {params}")
    expected, calls_u, calls_i = implied_launches(u, i, n_users, n_items,
                                                  params, ITERS)
    td = TrainingData(u, i, r, IdentityBiMap(n_users), IdentityBiMap(n_items))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(WorkflowContext(device="cuda"), td)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = launches()
    record("train_bf16", got)
    check(got["warp"] == expected == got["total"],
          f"bf16 launches {got} != implied {expected}")
    uf, itf = model.factors.user_factors, model.factors.item_factors
    check(uf.shape == (n_users, RANK) and itf.shape == (n_items, RANK)
          and uf.dtype == np.float32, f"factors {uf.shape} {itf.shape}")
    check(bool(np.isfinite(uf).all() and np.isfinite(itf).all()),
          "non-finite bf16 factors")
    sample = np.random.default_rng(0).choice(nnz, min(nnz, 1_000_000),
                                             replace=False)
    rmse = predict_rmse(model.factors, u[sample], i[sample], r[sample])
    f32 = main["model"].factors
    scale = float(np.abs(f32.user_factors).max())
    gap = max_err(uf, f32.user_factors)
    rule = {"max_abs_gap_user": gap, "scale": scale,
            "gap_over_scale": gap / scale, "held": False,
            "within_0.05_scale": gap < 0.05 * scale,
            "rel_norm_vs_float32": max(
                rel_norm(uf, f32.user_factors),
                rel_norm(itf, f32.item_factors))}
    emit("train_bf16", events=nnz, iterations=ITERS, rank=RANK,
         train_seconds=train_s, kernel_launches=got,
         expected_launches=expected, float32_expected=main["expected"],
         solve_calls_per_iteration={"user": calls_u, "item": calls_i},
         train_rmse_1m_sample=rmse, float32_rmse_1m_sample=main["rmse"],
         reference_rule=rule)
    check(abs(rmse / main["rmse"] - 1) <= BF16_RMSE_REL,
          f"bf16 RMSE {rmse} vs float32 {main['rmse']}")
    check(rule["rel_norm_vs_float32"] >= BF16_MIN_GAP,
          f"bf16 factors within {rule['rel_norm_vs_float32']} of the "
          f"float32 main path's: not a bfloat16 train")

    path = os.path.join(workdir, "ml20m_bf16_model.npz")
    save_models(path, engine_json, [algo.prepare_model_for_persistence(model)])
    engine_json2, stored = load_models(path)
    deployment = engine.prepare_deployment(
        WorkflowContext(device="cuda"), EngineParams.from_json(engine_json2),
        stored)
    deployment.models[0].warm_up()
    users = [int(x) for x in np.random.default_rng(2).integers(0, n_users, 20)]
    lat = serve_checks(
        deployment, [{"user": str(x), "num": 10} for x in users],
        lambda q, res: check_user_answer(uf, itf, int(q["user"]), res))
    del deployment, model
    emit("train_bf16_serve", **lat, catalog=n_items)

    trainers = {"float32": ALSTrainer(u, i, r, n_users, n_items,
                                      main["als_params"], device="cuda"),
                "bfloat16": ALSTrainer(u, i, r, n_users, n_items, params,
                                       device="cuda")}
    steady = {name: [] for name in trainers}
    for t in trainers.values():
        t.iterate(1)
    for _ in range(2):
        for name, t in trainers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.iterate(ITERS)
            torch.cuda.synchronize()
            steady[name].append(1e3 * (time.perf_counter() - t0) / ITERS)
    profiled = {name: profile_iteration(t, f"train_bf16_profile_{name}")
                for name, t in trainers.items()}
    del trainers
    emit("train_bf16_steady", events=nnz, iterations=ITERS,
         ms_per_iteration=steady, profile=profiled,
         main_path_float32={"ms_per_iteration": main["steady_ms"],
                            "profile": main["profile"]})


class _InjectedCrash(RuntimeError):
    pass


class _CrashAfterStep2(CheckpointHook):
    """A hook whose run dies right after its step-2 snapshot is on disk."""

    def save(self, step, tree):
        super().save(step, tree)
        if step == 2:
            raise _InjectedCrash("crash after the step-2 snapshot")


def phase_train_checkpointed(workdir: str, main: dict) -> None:
    """A snapshot every iteration, then a crash and a resume, then data
    that changed. The checkpointed train is held to the main path's
    factors at 2e-4 (the largest gap reported); the resumed train must
    equal the uninterrupted checkpointed one bit for bit (the heavy
    bucket's overflow rows merge in a fixed order, ops/als.py
    overflow_merge_passes)."""
    n_users, n_items, _ = ML20M
    u, i, r = main["ratings"]
    params = main["als_params"]
    per_iter = main["calls_per_iteration"]
    ref = main["model"].factors

    full_dir = os.path.join(workdir, "ckpt_full")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = train_als(u, i, r, n_users, n_items, params, device="cuda",
                     checkpoint_hook=CheckpointHook(full_dir, every_n=1,
                                                    max_to_keep=ITERS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches()
    record("train_checkpointed", got)
    steps = sorted(os.listdir(full_dir))
    err = max(max_err(full.user_factors, ref.user_factors),
              max_err(full.item_factors, ref.item_factors))
    ok = (within(full.user_factors, ref.user_factors)
          and within(full.item_factors, ref.item_factors))
    emit("train_checkpointed", iterations=ITERS, every_n=1,
         kernel_launches=got, expected_launches=ITERS * per_iter,
         snapshots=steps, train_seconds=seconds,
         max_abs_err_vs_unchunked=err, within_2e4=ok)
    check(got["warp"] == ITERS * per_iter == got["total"],
          f"checkpointed launches {got} != implied {ITERS * per_iter}")
    check(steps == [f"{s}.npz" for s in range(1, ITERS)],
          f"snapshots {steps}")
    check(ok, f"checkpointed factors differ from the unchunked: {err}")

    crash_dir = os.path.join(workdir, "ckpt_crash")
    try:
        train_als(u, i, r, n_users, n_items, params, device="cuda",
                  checkpoint_hook=_CrashAfterStep2(crash_dir, every_n=1))
        crashed = False
    except _InjectedCrash:
        crashed = True
    check(crashed, "the injected crash did not happen")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = train_als(u, i, r, n_users, n_items, params, device="cuda",
                        checkpoint_hook=CheckpointHook(crash_dir, every_n=1),
                        resume=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches()
    record("train_resumed", got)
    expected = (ITERS - 2) * per_iter
    err = max(max_err(resumed.user_factors, full.user_factors),
              max_err(resumed.item_factors, full.item_factors))
    emit("train_resumed", resumed_from_step=2, iterations=ITERS,
         kernel_launches=got, expected_launches=expected,
         train_seconds=seconds, max_abs_err_vs_uninterrupted=err,
         bit_identical=err == 0.0)
    check(got["warp"] == expected == got["total"],
          f"resumed launches {got} != implied {expected}")
    check(err == 0.0,
          f"resumed factors differ from the uninterrupted: max |d| {err}")

    changed = r.copy()
    changed[0] += 0.5
    try:
        train_als(u, i, changed, n_users, n_items, params, device="cuda",
                  checkpoint_hook=CheckpointHook(crash_dir, every_n=1),
                  resume=True)
        refused = ""
    except CheckpointIncompatibleError as e:
        refused = str(e)
    emit("train_resume_changed_data", refused=refused)
    check("fingerprint" in refused, f"changed data was not refused: {refused!r}")


def phase_train_nan_guard(main: dict) -> None:
    n_users, n_items, nnz = ML20M
    u, i, r = main["ratings"]
    algo = main["algo"]
    ref = main["model"].factors
    ctx = WorkflowContext(device="cuda")
    ctx.workflow_params = WorkflowParams(nan_guard=True)
    td = TrainingData(u, i, r, IdentityBiMap(n_users), IdentityBiMap(n_items))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launches()
    record("train_nan_guard", got)
    expected = ITERS * main["calls_per_iteration"]
    err = max(max_err(model.factors.user_factors, ref.user_factors),
              max_err(model.factors.item_factors, ref.item_factors))
    ok = (within(model.factors.user_factors, ref.user_factors)
          and within(model.factors.item_factors, ref.item_factors))

    rng = np.random.default_rng(4)
    su = rng.integers(0, 300, 5000).astype(np.int32)
    si = rng.integers(0, 200, 5000).astype(np.int32)
    sr = (rng.integers(1, 11, 5000) / 2.0).astype(np.float32)
    sr[17] = np.nan
    try:
        algo.train(ctx, TrainingData(su, si, sr, IdentityBiMap(300),
                                     IdentityBiMap(200)))
        raised = ""
    except NaNGuardError as e:
        raised = str(e)
    emit("train_nan_guard", iterations=ITERS, kernel_launches=got,
         expected_launches=expected, train_seconds=seconds,
         train_events_per_s_end_to_end=nnz * ITERS / seconds,
         max_abs_err_vs_unguarded=err, within_2e4=ok, nan_input_error=raised)
    check(got["warp"] == expected == got["total"],
          f"guarded launches {got} != implied {expected}")
    check(ok, f"guarded factors differ from the unguarded: {err}")
    check("stage: algorithm[als], iteration 1:" in raised,
          f"NaN rating not caught at iteration 1: {raised!r}")


def fold_in_events(n_users: int, n_items: int, new_users: int,
                   new_items: int, existing: int, seed: int) -> list:
    """One fold-in batch: ``new_users`` new users with 5 events each on
    known items, ``new_items`` new items with 4 events each from known
    users, and ``existing`` events between known users and items. New ids
    are the next consecutive integers, so the identity maps extend."""
    rng = np.random.default_rng(seed)

    def rate(user, item):
        return {"event": "rate", "entityType": "user", "entityId": str(user),
                "targetEntityType": "item", "targetEntityId": str(item),
                "properties": {"rating": float(rng.integers(1, 11)) / 2.0}}

    def known_item():
        return min(int(n_items * rng.random() ** 2), n_items - 1)

    events = [rate(n_users + j, known_item())
              for j in range(new_users) for _ in range(5)]
    events += [rate(int(rng.integers(n_users)), n_items + j)
               for j in range(new_items) for _ in range(4)]
    events += [rate(int(rng.integers(n_users)), known_item())
               for _ in range(existing)]
    return events


def fold_in_gap(algo, model, events) -> tuple:
    """Fold ``events`` into ``model`` on the card and on the CPU (plain
    solve): (card's folded model, max abs gaps, relative-norm gap, within
    2e-4)."""
    folded = algo.fold_in(model, events)
    on_cpu = algo.fold_in(ALSModel(model.factors, model.users, model.items,
                                   device=torch.device("cpu")), events)
    pairs = [(folded.factors.user_factors, on_cpu.factors.user_factors),
             (folded.factors.item_factors, on_cpu.factors.item_factors)]
    err = {"user": max_err(*pairs[0]), "item": max_err(*pairs[1])}
    rel = max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
              for a, b in pairs)
    return folded, err, rel, all(within(a, b) for a, b in pairs)


def phase_fold_in(phase: str, algo, model, events, kernel: str,
                  new_users: int, new_items: int, held_algo=None,
                  timed_runs: int = 3):
    """One batch folded into ``model`` on the card (2 launches of
    ``kernel``: items, then users), then ``timed_runs`` timed fold-ins.
    Card vs CPU (plain solve): held at 2e-4 under ``algo``, or, where
    ``algo``'s λ leaves the new rows' cold-start systems nearly singular
    (λ = 0.01 with 4-5 events against rank 32), reported and held to a
    relative-norm gap of 1e-2 as the plain-λ ALS case is, with the same
    batch under ``held_algo`` (λ = 0.1·n_ratings) held at 2e-4."""
    n_users, n_items = len(model.users), len(model.items)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    folded = algo.fold_in(model, events)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = launches()
    record(phase, got)
    check(got[kernel] == 2 == got["total"],
          f"fold-in launches {got}, not 2 of the {kernel} kernel")
    check(len(folded.users) == n_users + new_users
          and len(folded.items) == n_items + new_items,
          f"folded maps {len(folded.users)} users, {len(folded.items)} items")
    check(folded.device.type == "cuda" and folded._sharded_cat is None,
          "the folded model is not a cold model on the card")
    check(bool(np.isfinite(folded.factors.user_factors).all()
               and np.isfinite(folded.factors.item_factors).all()),
          "non-finite folded factors")
    runs = []
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        algo.fold_in(model, events)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    profile_call(lambda: algo.fold_in(model, events), phase + "_profile")
    _, err, rel, ok = fold_in_gap(algo, model, events)
    p = algo.params
    gaps = {"reg": p.reg, "lambda_scaling": p.lambda_scaling,
            "max_abs_err_card_vs_cpu": err, "rel_norm_err": rel,
            "within_2e4": ok}
    if held_algo is not None:
        _, h_err, h_rel, h_ok = fold_in_gap(held_algo, model, events)
        held = {"reg": held_algo.params.reg,
                "lambda_scaling": held_algo.params.lambda_scaling,
                "max_abs_err_card_vs_cpu": h_err, "rel_norm_err": h_rel,
                "within_2e4": h_ok}
    emit(phase, events=len(events), new_users=new_users, new_items=new_items,
         rank=folded.factors.user_factors.shape[1], kernel_launches=got,
         seconds_first=first_s, seconds_runs=runs, card_vs_cpu=gaps,
         **({} if held_algo is None else {"card_vs_cpu_held": held}))
    if held_algo is None:
        check(ok, f"fold-in on the card differs from the CPU's: {err}")
    else:
        check(rel < 1e-2, f"fold-in drift {rel} (relative norm)")
        check(h_ok, f"fold-in on the card differs from the CPU's at "
                    f"λ = 0.1·n_ratings: {h_err}")
    return folded


def phase_fold_in_main(workdir: str, main: dict) -> None:
    """The main path's rank-32 model folds 20,000 events; the folded model
    is persisted, restored and served, and new users get answers."""
    n_users, n_items, _ = ML20M
    new_users, new_items, n_events = FOLD_IN
    events = fold_in_events(n_users, n_items, new_users, new_items,
                            n_events - 5 * new_users - 4 * new_items, seed=8)
    algo, engine = main["algo"], main["engine"]
    folded = phase_fold_in("fold_in", algo, main["model"], events, "warp",
                           new_users, new_items,
                           held_algo=als_engine(RANK, ITERS, 0.1,
                                                "nratings")[2])
    path = os.path.join(workdir, "ml20m_folded.npz")
    save_models(path, main["engine_json"],
                [algo.prepare_model_for_persistence(folded)])
    engine_json, stored = load_models(path)
    deployment = engine.prepare_deployment(
        WorkflowContext(device="cuda"), EngineParams.from_json(engine_json),
        stored)
    deployment.models[0].warm_up()
    uf, itf = folded.factors.user_factors, folded.factors.item_factors
    queries = [{"user": str(n_users + j), "num": 10}
               for j in range(0, new_users, max(1, new_users // 20))]
    lat = serve_checks(deployment, queries, lambda q, res: check_user_answer(
        uf, itf, int(q["user"]), res))
    emit("fold_in_serve", new_user_queries=len(queries), **lat,
         catalog=len(folded.items))


def _cosine_answer_check(itf_normed: np.ndarray, item_factors: np.ndarray,
                         cats: np.ndarray):
    """A host cosine top-k for a Similar-Product answer: the query items'
    normalized vectors summed, scored against the normalized catalog, the
    category / whiteList / blackList / query-item rules applied."""

    def check_answer(q, res):
        qidx = [int(x) for x in q["items"]]
        qv = item_factors[qidx]
        qv = qv / (np.linalg.norm(qv, axis=1, keepdims=True) + 1e-9)
        s = itf_normed @ qv.sum(axis=0)
        allowed = np.isin(cats, [int(c[1:]) for c in q["categories"]])
        if q.get("whiteList"):
            white = np.zeros(len(s), bool)
            white[[int(x) for x in q["whiteList"] if x.isdigit()]] = True
            allowed &= white
        for x in q.get("blackList", []):
            allowed[int(x)] = False
        allowed[qidx] = False
        got = [int(e["item"]) for e in res["itemScores"]]
        scores = [e["score"] for e in res["itemScores"]]
        check(len(got) == min(q["num"], int(allowed.sum())),
              f"{len(got)} answers for {int(allowed.sum())} allowed items")
        check(bool(allowed[got].all()), f"an excluded item was returned: {q}")
        check(not set(got) & set(qidx), "a query item was returned")
        check(scores == sorted(scores, reverse=True), "answer not ordered")
        check(np.allclose(s[got], scores, rtol=1e-4, atol=1e-4),
              "served scores differ from the host's cosine")
        best = np.sort(s[allowed])[::-1]
        check(len(got) == 0 or best[len(got) - 1] <= scores[-1] + 1e-4,
              "served top-k misses a better allowed item")

    return check_answer


def phase_similar_product(workdir: str) -> None:
    """bench_templates.py config 3 through the Similar-Product engine's
    algorithm: the views drawn as there (seed 2), the categories replayed
    from one $set event per item; the engine's data source is the port's
    event reader, so this phase hands the drawn triple to the algorithm as
    the benchmark does."""
    n_users, n_items, nnz = SIMILAR
    rng = np.random.default_rng(2)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = np.minimum((n_items * rng.random(nnz) ** 2).astype(np.int32),
                   n_items - 1)
    r = np.ones(nnz, np.float32)
    cats = np.random.default_rng(3).integers(0, SIMILAR_CATEGORIES, n_items)
    set_events = [{"event": "$set", "entityType": "item", "entityId": str(j),
                   "properties": {"categories": [f"c{cats[j]}"]}}
                  for j in range(n_items)]

    class ViewsSource(similar_product.SimilarProductDataSource):
        def read_training(self, ctx):
            categories = {k: set(v["categories"]) for k, v in
                          aggregate_properties(ctx.events, "item").items()}
            return similar_product.TrainingData(
                u, i, r, IdentityBiMap(n_users), IdentityBiMap(n_items),
                categories)

    sp_engine = similar_product.SimilarProductEngine()()
    engine = Engine(data_source_class=ViewsSource,
                    algorithm_class_map=sp_engine.algorithm_class_map)
    engine_json = {
        "engineFactory": "incubator_predictionio_torch.models."
                         "similar_product.SimilarProductEngine",
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": 10, "lambda": 0.01,
            "alpha": 1.0}}]}
    params = EngineParams.from_json(engine_json)
    # the algorithm's ALS parameters (its default seed 3)
    als_params = ALSParams(rank=RANK, num_iterations=10, reg=0.01,
                           implicit_prefs=True, alpha=1.0, seed=3)
    expected, calls_u, calls_i = implied_launches(u, i, n_users, n_items,
                                                  als_params, 10)
    ctx = WorkflowContext(events=set_events, device="cuda")
    ctx.bench_timings = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = engine.train(ctx, params)[0]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = launches()
    record("similar_product", got)
    itf = model.factors.item_factors
    check(itf.shape == (n_items, RANK)
          and model.factors.user_factors.shape == (n_users, RANK),
          f"factor shapes {model.factors.user_factors.shape} {itf.shape}")
    check(bool(np.isfinite(itf).all()
               and np.isfinite(model.factors.user_factors).all()),
          "non-finite Similar-Product factors")
    tm = ctx.bench_timings
    emit("similar_product_train", shape=SIMILAR, rank=RANK, iterations=10,
         implicit=True, kernel_launches=got, expected_launches=expected,
         solve_calls_per_iteration={"user": calls_u, "item": calls_i},
         train_seconds=train_s, timings=tm,
         seconds_per_iteration=tm["device_train_seconds"] / 10,
         train_events_per_s_device=nnz * 10 / tm["device_train_seconds"],
         categories=len(model.item_categories))
    check(got["warp"] == expected == got["total"],
          f"Similar-Product launches {got} != implied {expected}")
    check(len(model.item_categories) == n_items, "categories not replayed")
    trainer = ALSTrainer(u, i, r, n_users, n_items, als_params, device="cuda")
    trainer.iterate(1)
    profile_iteration(trainer, "similar_product_profile")
    del trainer

    algo = engine.make_components(params)[2][0][1]
    path = os.path.join(workdir, "similar_model.npz")
    save_models(path, engine_json, [algo.prepare_model_for_persistence(model)])
    engine_json2, stored = load_models(path)
    deployment = sp_engine.prepare_deployment(
        WorkflowContext(device="cuda"), EngineParams.from_json(engine_json2),
        stored)
    deployment.models[0].warm_up()
    check(np.array_equal(deployment.models[0].factors.item_factors, itf),
          "restored Similar-Product factors differ")
    qrng = np.random.default_rng(9)
    head = min(5_000, n_items)  # query items from the viewed head
    queries = []
    for j in range(60):
        q = {"items": [str(int(x)) for x in qrng.integers(0, head,
                                                           1 + j % 3)],
             "num": 10,
             "categories": [f"c{int(c)}" for c in qrng.choice(
                 SIMILAR_CATEGORIES, 1 + j % 2, replace=False)]}
        if j % 3 == 1:
            q["whiteList"] = [str(int(x)) for x in
                              qrng.integers(0, n_items, 300)] + ["nope"]
        if j % 4 == 2:
            q["blackList"] = [str(int(x)) for x in
                              qrng.integers(0, head, 100)]
        queries.append(q)
    itf_normed = itf / (np.linalg.norm(itf, axis=1, keepdims=True) + 1e-9)
    lat = serve_checks(deployment, queries,
                       _cosine_answer_check(itf_normed, itf, cats))
    emit("similar_product_serve", **lat, catalog=n_items,
         with_white_list=sum("whiteList" in q for q in queries),
         with_black_list=sum("blackList" in q for q in queries))


def phase_train_rank128(ratings) -> dict:
    """The wide kernel's path: the main path's ratings at rank 128 through
    the same engine. Order: launches, RMSE, steady time, profile, then one
    fold-in batch (held card vs CPU at λ = 0.1·n_ratings: a new user's 5
    events against rank 128 make a nearly singular system at λ = 0.01,
    where two correct float32 solvers part by more than 2e-4, as in the
    rank-128 ALS check)."""
    n_users, n_items, nnz = ML20M
    u, i, r = ratings
    _, _, algo = als_engine(WIDE_RANK, WIDE_ITERS, 0.01)
    als_params = algo.als_params(algo.params)
    expected, calls_u, calls_i = implied_launches(u, i, n_users, n_items,
                                                  als_params, WIDE_ITERS)
    td = TrainingData(u, i, r, IdentityBiMap(n_users), IdentityBiMap(n_items))

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(WorkflowContext(device="cuda"), td)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = launches()
    record("train_rank128", got)
    emit("train_rank128_launches", rank=WIDE_RANK, iterations=WIDE_ITERS,
         kernel_launches=got, expected_launches=expected,
         solve_calls_per_iteration={"user": calls_u, "item": calls_i},
         train_seconds=train_s)
    check(got["wide"] == expected == got["total"] and got["warp"] == 0,
          f"rank-128 launches {got} != implied {expected} wide, 0 warp")

    uf, itf = model.factors.user_factors, model.factors.item_factors
    check(uf.shape == (n_users, WIDE_RANK) and itf.shape == (n_items, WIDE_RANK),
          f"factor shapes {uf.shape} {itf.shape}")
    check(bool(np.isfinite(uf).all() and np.isfinite(itf).all()),
          "non-finite rank-128 factors")
    sample = np.random.default_rng(0).choice(nnz, min(nnz, 1_000_000), replace=False)
    rmse = predict_rmse(model.factors, u[sample], i[sample], r[sample])
    emit("train_rank128_rmse", train_rmse_1m_sample=rmse,
         ratings_std=float(np.std(r)))
    check(rmse < float(np.std(r)), f"rank-128 train RMSE {rmse} not below std")

    trainer = ALSTrainer(u, i, r, n_users, n_items, als_params, device="cuda")
    trainer.iterate(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.iterate(WIDE_ITERS)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    emit("train_rank128_steady", events=nnz, iterations=WIDE_ITERS,
         seconds=steady_s, train_events_per_s=nnz * WIDE_ITERS / steady_s,
         seconds_per_iteration=steady_s / WIDE_ITERS)
    profile_iteration(trainer, "train_rank128_profile")
    del trainer

    _, _, fold_algo = als_engine(WIDE_RANK, WIDE_ITERS, 0.1, "nratings")
    new_users, new_items, n_events = FOLD_IN_RANK128
    events = fold_in_events(n_users, n_items, new_users, new_items,
                            n_events - 5 * new_users - 4 * new_items, seed=12)
    phase_fold_in("fold_in_rank128", fold_algo, model, events, "wide",
                  new_users, new_items, timed_runs=1)
    return {"launches": got["wide"], "expected": expected}


def profile_iteration(trainer: ALSTrainer,
                      phase: str = "profile_iteration") -> dict:
    """Where one steady-state iteration's device time goes."""
    return profile_call(lambda: trainer.iterate(1), phase)


#: the gather's kernels: ``index_select`` of the counterpart rows (the
#: vectorized gather on torch 2.11's CUDA build) and of the heavy
#: bucket's merge passes
GATHER_SYMBOLS = ("vectorized_gather_kernel", "indexSelect")


def profile_call(fn, phase: str) -> dict:
    """Where one call's device time goes: torch.profiler kernel times by
    name, the gather's share, and the device's busy share of the call's
    wall time. Returns the emitted numbers."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = cuda_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    gather_ms = sum(e.self_device_time_total for e in kernels
                    if any(g in e.key for g in GATHER_SYMBOLS)) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    got = {"wall_ms_profiled": wall_ms,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "idle_share": (1 - busy_ms / wall_ms) if kernels
           else "not measured",
           "gather_ms": gather_ms if kernels else "not measured",
           "gather_share": gather_ms / busy_ms if kernels
           else "not measured"}
    emit(phase, **got,
         top=[{"name": e.key[:90], "calls": e.count,
               "device_ms": e.self_device_time_total / 1e3} for e in top])
    return got


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
#: ``console train`` whose run dies right after its step-2 snapshot
_CRASHING_CONSOLE = r"""
import sys
from incubator_predictionio_torch.tools import console
from incubator_predictionio_torch.workflow import checkpoint

real = checkpoint.CheckpointHook.save

def crashing_save(self, step, tree):
    real(self, step, tree)
    if step == 2:
        raise RuntimeError("injected crash after the step-2 snapshot")

checkpoint.CheckpointHook.save = crashing_save
sys.exit(console.main(sys.argv[1:]))
"""


def _console_env() -> dict:
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def console_train(args: list, path: str, crash: bool = False) -> dict:
    """``console train`` in a subprocess; returns its JSON line, with the
    run's kernel launches recorded under ``path``."""
    cmd = [sys.executable, "-c", _CRASHING_CONSOLE] if crash else CONSOLE
    out = subprocess.run(cmd + ["train"] + args, capture_output=True,
                         text=True, env=_console_env(), cwd=ROOT, timeout=300)
    if crash:
        check(out.returncode != 0 and "injected crash" in out.stderr,
              f"the crashing console train did not crash: {out.returncode}")
        return {}
    check(out.returncode == 0, f"console train failed: {out.stderr[-2000:]}")
    trained = json.loads(out.stdout.strip().splitlines()[-1])
    record(path, trained["kernel_launches"])
    return trained


class _Served:
    """A verb that serves (eventserver / deploy) in its own process, up
    once ``GET /`` answers; stopped with SIGTERM on exit."""

    def __init__(self, args: list, env: dict, cwd: str, console=None):
        self.port = _free_port()
        self.proc = subprocess.Popen(
            (console or CONSOLE) + args + ["--port", str(self.port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=env, cwd=cwd)

    def __enter__(self):
        deadline = time.time() + 180
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"server exited: {self.proc.stderr.read()[-2000:]}")
            try:
                self.info = self.request("GET", "/")[1]
                return self
            except OSError:
                check(time.time() < deadline, "server never came up")
                time.sleep(0.25)

    def connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)

    def request(self, method, path, body=None, conn=None):
        return self.request_h(method, path, body, {}, conn)[:3]

    def request_h(self, method, path, body, headers: dict, conn=None):
        """(status, JSON, client ms, response headers)"""
        own = conn is None
        conn = conn or self.connect()
        try:
            t0 = time.perf_counter()
            conn.request(method, path, body=None if body is None
                         else json.dumps(body),
                         headers={"Content-Type": "application/json",
                                  **headers})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            return (resp.status, data, (time.perf_counter() - t0) * 1e3,
                    dict(resp.getheaders()))
        finally:
            if own:
                conn.close()

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.stderr = self.proc.stderr.read()
        self.proc.stderr.close()


def console_queries(model: str, queries: list) -> list:
    """``console deploy`` in a subprocess; POST the queries; stop it.
    Returns [(status, result, ms)]."""
    with _Served(["deploy", "--model", model], _console_env(), ROOT) as srv:
        conn = srv.connect()
        answers = [srv.request("POST", "/queries.json", q, conn)
                   for q in queries]
        conn.close()
    return answers


def _event_time(j: int) -> str:
    return (f"2024-01-01T00:{j // 3600 % 60:02d}:{j // 60 % 60:02d}."
            f"{j % 60:03d}Z")


def phase_console(workdir: str) -> None:
    """The entry points themselves: console train → deploy → query; a
    checkpointed console train that crashes, then ``--resume``."""
    rng = np.random.default_rng(5)
    n_users, n_items, n = 500, 300, 20_000
    events = os.path.join(workdir, "events.jsonl")
    with open(events, "w", encoding="utf-8") as fh:
        for j in range(n):
            ev = "buy" if j % 10 == 0 else "rate"
            e = {"event": ev, "entityType": "user",
                 "entityId": f"u{int(rng.integers(n_users))}",
                 "targetEntityType": "item",
                 "targetEntityId": f"i{int(n_items * rng.random() ** 2)}",
                 "eventTime": _event_time(j)}
            if ev == "rate":
                e["properties"] = {"rating": float(rng.integers(1, 6))}
            fh.write(json.dumps(e) + "\n")
    engine_json = os.path.join(workdir, "engine.json")
    iterations = 5
    with open(engine_json, "w", encoding="utf-8") as fh:
        json.dump({"engineFactory": "incubator_predictionio_torch.models."
                                    "recommendation.RecommendationEngine",
                   "datasource": {"params": {"appName": "smoke"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": RANK, "numIterations": iterations,
                       "lambda": 0.05}}]},
                  fh)
    model = os.path.join(workdir, "console_model.npz")
    trained = console_train(["--engine-json", engine_json, "--events", events,
                             "--model-out", model], "console")
    users = ("u1", "u2", "u3", "nobody")
    answers = []
    for user, (status, res, ms) in zip(users, console_queries(
            model, [{"user": x, "num": 5} for x in users])):
        check(status == 200, f"console query {status} {res}")
        answers.append((user, len(res["itemScores"]), ms))
    check(answers[0][1] == 5 and answers[-1][1] == 0,
          f"console answers {answers}")
    emit("console", events=n, train_seconds=trained["seconds"],
         device=trained["device"], kernel_launches=trained["kernel_launches"],
         answers=answers)

    # --checkpoint-every 1, a crash after the step-2 snapshot, --resume
    u, i, _, users, items = find_ratings(
        read_events(events), event_names=["rate", "buy"],
        event_default_ratings={"buy": 4.0})
    per_iter = implied_launches(u, i, len(users), len(items),
                                ALSParams(rank=RANK, reg=0.05), 1)[0]
    resumed = os.path.join(workdir, "console_resumed.npz")
    snapshots = resumed + ".checkpoints"
    base = ["--engine-json", engine_json, "--events", events, "--model-out",
            resumed]
    console_train(base + ["--checkpoint-every", "1"], "", crash=True)
    left = sorted(os.listdir(os.path.join(snapshots, "algo_0_als")))
    check(left == ["1.npz", "2.npz"] and not os.path.exists(resumed),
          f"after the crash: snapshots {left}")
    out = console_train(base + ["--resume"], "console_resume")
    check(not os.path.exists(snapshots), "snapshots left after --resume")
    _, whole = load_models(model)
    _, part = load_models(resumed)
    err = max(max_err(part[0][k], whole[0][k])
              for k in ("user_factors", "item_factors"))
    ok = all(within(part[0][k], whole[0][k])
             for k in ("user_factors", "item_factors"))
    expected = (iterations - 2) * per_iter
    emit("console_resume", snapshots_after_crash=left,
         kernel_launches=out["kernel_launches"], expected_launches=expected,
         train_seconds=out["seconds"], max_abs_err_vs_uninterrupted=err,
         within_2e4=ok)
    check(out["kernel_launches"]["warp"] == expected,
          f"resumed console launches {out['kernel_launches']} != {expected}")
    check(ok, f"resumed console model differs: {err}")


def phase_console_similar_product(workdir: str) -> None:
    """The Similar-Product template's own engine.json values (rank 10, 20
    iterations, λ 0.01), its factory set to the port's, through console
    train → deploy → query on a small view-events file."""
    with open(os.path.join(ROOT, "templates", "similar-product",
                           "engine.json"), encoding="utf-8") as fh:
        engine_json = json.load(fh)
    engine_json["engineFactory"] = ("incubator_predictionio_torch.models."
                                    "similar_product.SimilarProductEngine")
    params = engine_json["algorithms"][0]["params"]
    rng = np.random.default_rng(6)
    n_users, n_items, n = 400, 250, 15_000
    cats = {j: f"c{j % 5}" for j in range(n_items)}
    events = os.path.join(workdir, "views.jsonl")
    with open(events, "w", encoding="utf-8") as fh:
        for j in range(n_items):
            fh.write(json.dumps({
                "event": "$set", "entityType": "item", "entityId": f"i{j}",
                "properties": {"categories": [cats[j]]},
                "eventTime": _event_time(j)}) + "\n")
        for j in range(n):
            fh.write(json.dumps({
                "event": "view", "entityType": "user",
                "entityId": f"u{int(rng.integers(n_users))}",
                "targetEntityType": "item",
                "targetEntityId": f"i{int(n_items * rng.random() ** 2)}",
                "eventTime": _event_time(n_items + j)}) + "\n")
    path = os.path.join(workdir, "similar_engine.json")
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(engine_json, fh)
    model = os.path.join(workdir, "similar_console.npz")
    u, i, _, users, items = find_ratings(read_events(events),
                                         event_names=["view"],
                                         rating_from_props=False)
    expected = implied_launches(
        u, i, len(users), len(items),
        ALSParams(rank=params["rank"], reg=params["lambda"],
                  implicit_prefs=True), params["numIterations"])[0]
    trained = console_train(["--engine-json", path, "--events", events,
                             "--model-out", model], "console_similar_product")
    check(trained["kernel_launches"]["warp"] == expected,
          f"console Similar-Product launches {trained['kernel_launches']} "
          f"!= implied {expected}")
    queries = [{"items": ["i1", "i2"], "num": 5, "categories": ["c3"]},
               {"items": ["i7"], "num": 4, "blackList": ["i0", "i1"]},
               {"items": ["i3"], "num": 3, "whiteList": ["i4", "i9", "i3"]},
               {"items": ["nope"], "num": 3}]
    answers = console_queries(model, queries)
    for q, (status, res, _) in zip(queries, answers):
        got = [e["item"] for e in res["itemScores"]]
        check(status == 200, f"console Similar-Product query {status} {res}")
        check(not set(got) & set(q["items"]), f"a query item returned: {got}")
        check(not set(got) & set(q.get("blackList", [])), f"blackList {got}")
        check(all(cats[int(x[1:])] in q.get("categories", [cats[int(x[1:])]])
                  for x in got), f"categories not held: {got}")
        if q.get("whiteList"):
            check(set(got) <= set(q["whiteList"]), f"whiteList {got}")
    counts = [len(res["itemScores"]) for _, res, _ in answers]
    check(counts == [5, 4, 2, 0], f"console Similar-Product answers {counts}")
    emit("console_similar_product", engine_json=engine_json, events=n,
         items=n_items, kernel_launches=trained["kernel_launches"],
         expected_launches=expected, train_seconds=trained["seconds"],
         answers=counts)


ML1M = (6_040, 3_706, 1_000_209)  # bench.py SCALES["ml1m"]
#: the live events of the pio_workflow phase: single POSTs, batches of 50,
#: new users (10 events each) and new items
LIVE = (1_000, 20, 200, 50)
#: events the SQLite pio_workflow phase imports (of ML-1M's 1,000,209;
#: 100,000 until the slab-gang phases needed the time, 50,000 until the
#: linear gang and stream phases did)
SQLITE_IMPORT = 25_000
#: events the JSONL pio_workflow phase imports (of ML-1M's 1,000,209; all
#: of them until the partitioned event server's phase needed the time,
#: 300,000 until the slab-gang phases did, 150,000 until the CCO gang and
#: serving-mesh phases did)
JSONL_IMPORT = 75_000
PIO_RANK, PIO_ITERS, PIO_LAMBDA = 32, 10, 0.01
T0_MS = 1_704_067_200_000  # 2024-01-01T00:00:00Z


def _iso_ms(ms: int) -> str:
    sec, milli = divmod(int(ms), 1000)
    t = time.gmtime(sec)
    return time.strftime("%Y-%m-%dT%H:%M:%S", t) + f".{milli:03d}Z"


def _pio_env(base: str) -> dict:
    env = {k: v for k, v in _console_env().items()
           if not k.startswith("PIO_STORAGE_")}
    env["PIO_FS_BASEDIR"] = base
    return env


def _verb(args: list, env: dict, cwd: str, timeout: int = 900):
    """One console verb in its own process; (completed process, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run(CONSOLE + args, capture_output=True, text=True,
                         env=env, cwd=cwd, timeout=timeout)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0,
          f"verb {args[0]} failed ({out.returncode}): {out.stderr[-2000:]}")
    return out, seconds


def _import_seconds(stdout: str, count: int, what: str) -> float:
    """The seconds an ``import`` verb reports, once it is checked to have
    imported ``count`` events and skipped none."""
    line = [ln for ln in stdout.splitlines() if "Imported" in ln][-1]
    check(f"Imported {count} events (0 skipped)" in line, f"{what}: {line}")
    return float(line.rsplit(" in ", 1)[1].rstrip("s."))


def _percentiles(ms: list) -> dict:
    a = np.asarray(ms)
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "n": len(ms)}


def _write_ml1m_jsonl(path: str, limit=None) -> tuple:
    """ML-1M-shaped rate events (bench.py's synth_ratings at SCALES["ml1m"])
    as a `pio import` file, each with a distinct eventTime, shuffled (the
    first ``limit`` of them when given); returns (users, items, ratings,
    event times in ms)."""
    n_users, n_items, nnz = ML1M
    u, i, r = synth_ratings(n_users, n_items, nnz, seed=21)
    times = T0_MS + np.random.default_rng(22).permutation(nnz)
    u, i, r, times = (a[:limit] for a in (u, i, r, times))
    with open(path, "w", encoding="utf-8") as fh:
        for a, b, c, t in zip(u.tolist(), i.tolist(), r.tolist(),
                              times.tolist()):
            fh.write('{"event": "rate", "entityType": "user", "entityId": '
                     f'"u{a}", "targetEntityType": "item", "targetEntityId": '
                     f'"i{b}", "properties": {{"rating": {c}}}, '
                     f'"eventTime": "{_iso_ms(t)}"}}\n')
    return u, i, r, times


def _expected_triple(imported: tuple, live: list) -> dict:
    """The plain reference of the store read, from the generated events
    themselves: every event in time order (all times are distinct), users
    and items indexed in first-seen order."""
    u, i, r, times = imported
    ids = lambda key: np.array([int(e[key][1:]) for e in live],  # noqa: E731
                               np.int64)
    order = np.argsort(np.concatenate(
        [times, np.array([_ms(e["eventTime"]) for e in live], np.int64)]),
        kind="stable")

    def first_seen(seq: np.ndarray, prefix: str):
        seq = seq[order]
        keys, first = np.unique(seq, return_index=True)
        keys = keys[np.argsort(first)]
        dense = np.empty(keys.max() + 1, np.int64)
        dense[keys] = np.arange(len(keys))
        return [f"{prefix}{k}" for k in keys], dense[seq].astype(np.int32)

    users, uidx = first_seen(np.concatenate([u, ids("entityId")]), "u")
    items, iidx = first_seen(np.concatenate([i, ids("targetEntityId")]), "i")
    rating = np.concatenate([r, [e["properties"]["rating"] for e in live]])
    return {"users": users, "items": items, "u": uidx, "i": iidx,
            "r": rating[order].astype(np.float32)}


def _ms(iso: str) -> int:
    """Inverse of :func:`_iso_ms`."""
    t = time.strptime(iso[:19], "%Y-%m-%dT%H:%M:%S")
    return (int(calendar.timegm(t)) * 1000 + int(iso[20:23]))


def _live_events() -> list:
    """2,000 events after the imported ones: 200 new users with 10 events
    each; every fourth event rates one of 50 new items."""
    n_users, n_items, nnz = ML1M
    singles, batches, new_users, new_items = LIVE
    rng = np.random.default_rng(23)
    out = []
    for k in range(singles + 50 * batches):
        item = (n_items + (k // 4) % new_items if k % 4 == 0
                else min(int(n_items * rng.random() ** 2), n_items - 1))
        out.append({"event": "rate", "entityType": "user",
                    "entityId": f"u{n_users + k % new_users}",
                    "targetEntityType": "item", "targetEntityId": f"i{item}",
                    "properties": {"rating": float(rng.integers(1, 11)) / 2},
                    "eventTime": _iso_ms(T0_MS + nnz + k)})
    return out


def _ingest_live(env: dict, workdir: str, key: str, live: list) -> tuple:
    """The live events through ``pio eventserver``: the first LIVE[0] as
    single POSTs, the rest as batches of 50, each acknowledged after its
    commit. Returns (acknowledged ids, single ms, batch ms)."""
    singles, batches = LIVE[0], LIVE[1]
    acked, single_ms, batch_ms = [], [], []
    with _Served(["eventserver", "--ip", "127.0.0.1"], env, workdir) as srv:
        conn = srv.connect()
        for e in live[:singles]:
            status, res, ms = srv.request(
                "POST", f"/events.json?accessKey={key}", e, conn)
            check(status == 201, f"event POST {status}: {res}")
            acked.append(res["eventId"])
            single_ms.append(ms)
        for j in range(batches):
            chunk = live[singles + 50 * j: singles + 50 * (j + 1)]
            status, res, ms = srv.request(
                "POST", f"/batch/events.json?accessKey={key}", chunk, conn)
            check(status == 200 and [x["status"] for x in res] == [201] * 50,
                  f"batch POST {status}: {res}")
            acked += [x["eventId"] for x in res]
            batch_ms.append(ms)
        conn.close()
    check(len(set(acked)) == len(live), "duplicate event ids")
    return acked, single_ms, batch_ms


def phase_pio_workflow(workdir: str) -> None:
    """The user's path through the port's verbs, each in its own process,
    on one SQLite store ($PIO_FS_BASEDIR/pio.sqlite): app new → import of
    an ML-1M-shaped file → 2,000 live events through the event server →
    train (rank 32, 10 iterations, λ 0.01, the warp kernel) → deploy →
    50 queries held to a host top-k → a second train whose blob is
    corrupted in the SQLite file, and a deploy that walks back past it.
    Cut to the first SQLITE_IMPORT events of the ML-1M file so the JSONL
    phases fit the script's 1,200 s: on an H100 host the whole script takes
    679–791 s with a cut to 100,000, the phase ≈ 74 s there against
    ≈ 280 s at all 1,000,209, and the ML-20M phase alone varies by ≈ 100 s
    from host to host, so the full import would leave under 100 s of
    margin. The JSONL lines label the numbers they quote from this phase
    with its store's size (``imported_events``)."""
    n_users, n_items, _ = ML1M
    nnz = SQLITE_IMPORT
    new_users, new_items = LIVE[2:]
    base = os.path.join(workdir, "pio_base")
    env = _pio_env(base)
    out, _ = _verb(["app", "new", "ml1m"], env, workdir)
    key = out.stdout.split("Access Key:")[1].split()[0]

    # bulk import
    events_path = os.path.join(workdir, "ml1m.jsonl")
    t0 = time.perf_counter()
    imported = _write_ml1m_jsonl(events_path, nnz)
    write_s = time.perf_counter() - t0
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    out, wall_s = _verb(["import", "--app-name", "ml1m", "--input",
                         events_path], env, workdir)
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    import_s = _import_seconds(out.stdout, nnz, "import")
    SQLITE_NUMBERS.update(events=nnz, import_events_per_s=nnz / import_s)
    emit("pio_workflow_import", events=nnz, reduced=(
        f"first {nnz} of the {ML1M[2]} ML-1M events (time budget)"),
         file_write_seconds=write_s,
         import_seconds=import_s, events_per_s=nnz / import_s,
         verb_wall_seconds=wall_s, events_per_s_wall=nnz / wall_s,
         verb_cpu_user_seconds=cpu1.ru_utime - cpu0.ru_utime,
         verb_cpu_sys_seconds=cpu1.ru_stime - cpu0.ru_stime,
         store_bytes=os.path.getsize(os.path.join(base, "pio.sqlite")))
    os.unlink(events_path)

    # live events through the event server: acknowledged = committed
    live = _live_events()
    acked, single_ms, batch_ms = _ingest_live(env, workdir, key, live)
    SQLITE_NUMBERS["ingest"] = {"single": _percentiles(single_ms[1:]),
                                "batch_of_50": _percentiles(batch_ms)}
    emit("pio_workflow_ingest", events=len(live), new_users=new_users,
         new_items=new_items, single=_percentiles(single_ms[1:]),
         batch_of_50=_percentiles(batch_ms))

    store = Storage({f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
                     for r in ("METADATA", "EVENTDATA", "MODELDATA")}
                    | {"PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
                       "PIO_STORAGE_SOURCES_S_PATH":
                           os.path.join(base, "pio.sqlite")})
    app_id = store.get_meta_data_apps().get_by_name("ml1m").id
    missing = [eid for eid in acked
               if store.get_l_events().get(eid, app_id) is None]
    check(not missing, f"{len(missing)} acknowledged events not in the store")
    # what the train must read, from the generated events themselves
    ref = _expected_triple(imported, live)
    u, i, users, items = ref["u"], ref["i"], ref["users"], ref["items"]
    total = nnz + len(live)
    check(len(u) == total, f"reference triple {len(u)}")

    # train through the verb (the card, the warp kernel)
    _write_engine_json(workdir, "ml1m")
    _, calls_u, calls_i = implied_launches(
        u, i, len(users), len(items),
        ALSParams(rank=PIO_RANK, num_iterations=PIO_ITERS, reg=PIO_LAMBDA),
        PIO_ITERS)

    def train(path: str) -> dict:
        trained = _train_verb(env, workdir, path)
        _hold_train(trained, ref, path)
        row = store.get_meta_data_engine_instances().get(
            trained["engineInstanceId"])
        check(row.status == "COMPLETED", f"{path} instance {row.status}")
        return trained

    first = train("pio_workflow")
    first_id = first["engineInstanceId"]
    _, persisted = models_from_bytes(model_artifact.read_model(store, first_id))
    stored = persisted[0]
    m_users, m_items = stored["users"], stored["items"]
    check(list(m_users) == users and list(m_items) == items,
          "the model's id maps differ from the events' first-seen order")
    check(all(f"u{n_users + j}" in m_users for j in range(new_users))
          and all(f"i{n_items + j}" in m_items for j in range(new_items)),
          "a live user or item is not in the model")
    uf, itf = stored["user_factors"], stored["item_factors"]
    check(uf.shape == (len(users), PIO_RANK)
          and bool(np.isfinite(uf).all() and np.isfinite(itf).all()),
          f"bad factors {uf.shape}")
    tm = first["timings"]
    reads = [tm["read_seconds"]]
    steady_ms = _steady_ms(ref)
    SQLITE_NUMBERS.update(
        read_seconds=tm["read_seconds"],
        train_seconds_end_to_end=first["wall_seconds"],
        steady_iteration_ms=steady_ms)
    emit("pio_workflow_train", events=total, rank=PIO_RANK,
         iterations=PIO_ITERS, reg=PIO_LAMBDA,
         train_seconds_end_to_end=first["wall_seconds"],
         train_seconds_run_train=first["seconds"], timings=tm,
         read_share_of_run_train=tm["read_seconds"] / first["seconds"],
         device_share_of_run_train=tm["device_train_seconds"] / first["seconds"],
         steady_iteration_ms=steady_ms, kernel_launches=first["kernel_launches"],
         expected_launches=first["expected_launches"],
         solve_calls_per_iteration={"user": calls_u, "item": calls_i})

    # deploy the newest COMPLETED; 25 live users, 25 imported ones
    rng = np.random.default_rng(24)
    queried = ([f"u{n_users + j}" for j in range(0, new_users, new_users // 25)]
               + [users[int(x)]
                  for x in rng.integers(0, len(users) - new_users, 25)])

    def answer(res, user):
        check_user_answer(uf, itf, m_users[user], {"itemScores": [
            {"item": m_items[x["item"]], "score": x["score"]}
            for x in res["itemScores"]]})

    SQLITE_NUMBERS["query"] = _serve_and_check(env, workdir, first_id,
                                               stored, queried)
    emit("pio_workflow_serve", queries=len(queried),
         live_user_queries=sum(int(q[1:]) >= n_users for q in queried),
         **SQLITE_NUMBERS["query"])

    # a second train, its blob corrupted in the SQLite file before deploy
    second = train("pio_workflow_retrain")
    second_id = second["engineInstanceId"]
    reads.append(second["timings"]["read_seconds"])
    emit("pio_workflow_read", events=total, seconds=reads,
         seconds_per_million_events=[x / total * 1e6 for x in reads],
         where="the train's own read (timings.read_seconds), two trains")
    db = sqlite3.connect(os.path.join(base, "pio.sqlite"))
    (blob,) = db.execute("SELECT models FROM pio_modeldata_models WHERE id=?",
                         (second_id,)).fetchone()
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0x01
    with db:
        db.execute("UPDATE pio_modeldata_models SET models=? WHERE id=?",
                   (bytes(flipped), second_id))
    db.close()
    with _Served(["deploy"], env, workdir) as srv:
        info = srv.info
        status, res, _ = srv.request("POST", "/queries.json",
                                     {"user": queried[0], "num": 10})
        check(status == 200, f"query after walk-back {status}: {res}")
        answer(res, queried[0])
    check(info["engineInstanceId"] == first_id
          and info["lifecycle"]["integrityFailures"] == {"checksum": 1},
          f"walk-back: {info}")
    check(f"{second_id} is not deployable (checksum)" in srv.stderr,
          "deploy did not report the walked-back instance and its kind")
    store.close()
    emit("pio_workflow_walk_back", corrupt=second_id, deployed=first_id,
         integrity_failures=info["lifecycle"]["integrityFailures"],
         retrain_seconds_end_to_end=second["wall_seconds"],
         retrain_timings=second["timings"])


# -- the JSONL event log: the pio workflow on TYPE=JSONL ---------------------

#: the numbers of the SQLite pio_workflow phase, printed beside the JSONL ones
SQLITE_NUMBERS: dict = {}


def _sqlite_beside(numbers: dict | None) -> dict:
    """The SQLite phase's numbers for a JSONL line, labelled with the
    number of events that phase imported (SQLITE_IMPORT, not ML-1M's
    1,000,209)."""
    return {"imported_events": SQLITE_NUMBERS.get("events"),
            **(numbers or {})}
#: lines of the ML-20M log the codec_vs_plain phase parses both ways
#: (200,000 until the CCO gang and serving-mesh phases needed the time)
CODEC_SLICE = 100_000
#: the ML-20M log's event times (a permutation of nnz milliseconds) and ids
ML20M_TIME_SEED, ML20M_ID_SEED = 8, 7
CREATED_ISO = "2024-06-01T00:00:00.000Z"
#: the events of the ML-20M log, cut from 20,000,263 for the script's
#: time: a whole run took 1,288 s with the full log on one H100 host (the
#: phase 449 s of it, 246 s of that the compaction); 216 s at 10,000,000,
#: cut again to 5,000,000 for the two linear-template phases (≈ 116 s for
#: classification_jsonl alone on one H100 host), and to 2,500,000 when the
#: host-sharded and partitioned-ingest phases took the script to 1,177 s
#: on a slow host (the phase 111 s there, 44 s of it the compaction), and
#: to 1,250,000 when the slab-gang phases needed the time, to 625,000
#: when the linear gang and stream phases did, and to 312,500 when the CCO
#: gang and serving-mesh phases did
ML20M_LOG_EVENTS = 312_500
ML20M_QUERIES = 20


def _ml20m_times(nnz: int) -> np.ndarray:
    return T0_MS + np.random.default_rng(ML20M_TIME_SEED).permutation(nnz)


def _log_lines(u, i, r, times_ms, first: int) -> bytes:
    """Rate events as JSONL lines, byte for byte what
    ``JSONLEvents.insert_batch`` writes for them (``Event.to_json`` with
    its ``eventId`` set, ``json.dumps``): event ids derived from the seed
    and the row, one fixed creation time."""
    iso = np.datetime_as_string(np.asarray(times_ms).astype("datetime64[ms]"),
                                unit="ms").tolist()
    rating = [json.dumps(k / 2) for k in range(11)]
    halves = (np.asarray(r) * 2).astype(np.int64).tolist()
    return "".join([
        f'{{"eventId": "{ML20M_ID_SEED:08x}{first + k:024x}", "event": '
        f'"rate", "entityType": "user", "entityId": "u{a}", '
        f'"targetEntityType": "item", "targetEntityId": "i{b}", '
        f'"properties": {{"rating": {rating[c]}}}, "eventTime": "{t}Z", '
        f'"creationTime": "{CREATED_ISO}"}}\n'
        for k, (a, b, c, t) in enumerate(zip(
            np.asarray(u).tolist(), np.asarray(i).tolist(), halves, iso))
    ]).encode()


_LOG_ARRAYS: tuple = ()


def _write_part(job: tuple) -> int:
    lo, hi, path = job
    lines, arrays = _LOG_ARRAYS
    with open(path, "wb") as fh:
        for a in range(lo, hi, 1_000_000):
            b = min(a + 1_000_000, hi)
            fh.write(lines(*(x[a:b] for x in arrays), a))
    return hi - lo


def _write_log(path: str, u, i, r, times, lines=_log_lines) -> None:
    """The log in parts, one process per core, concatenated in order:
    ``lines(u, i, r, times, first row)`` gives each part's bytes."""
    global _LOG_ARRAYS
    import multiprocessing

    _LOG_ARRAYS = (lines, (u, i, r, times))
    n, procs = len(u), os.cpu_count() or 1
    step = -(-n // procs)
    jobs = [(lo, min(lo + step, n), f"{path}.part{k}")
            for k, lo in enumerate(range(0, n, step))]
    with multiprocessing.get_context("fork").Pool(len(jobs)) as pool:
        check(sum(pool.map(_write_part, jobs)) == n, "log parts short")
    with open(path, "wb") as out:
        for _, _, part in jobs:
            with open(part, "rb") as fh:
                shutil.copyfileobj(fh, out, 64 << 20)
            os.unlink(part)
    _LOG_ARRAYS = ()


def _same_columns(a, b) -> None:
    for f in ("event", "etype", "eid", "tetype", "teid", "event_id",
              "time_us", "props", "span", "tombstone_pos"):
        x, y = getattr(a, f), getattr(b, f)
        check(x.dtype == y.dtype and np.array_equal(x, y),
              f"codec column {f} differs from the plain parser's")
    check(np.array_equal(a.rating, b.rating, equal_nan=True),
          "codec ratings differ from the plain parser's")
    check(a.tables == b.tables and a.tombstones == b.tombstones,
          "codec tables differ from the plain parser's")


def phase_codec_vs_plain(ratings) -> None:
    """The event codec (native/src/event_codec.cc, g++) and its plain
    Python parser on the first CODEC_SLICE lines of the ML-20M log: every
    column and table equal; MB/s of both."""
    u, i, r = (a[:CODEC_SLICE] for a in ratings)
    buf = _log_lines(u, i, r, _ml20m_times(len(ratings[0]))[:CODEC_SLICE], 0)
    t0 = time.perf_counter()
    native.status()  # build (or load) the library outside the timing
    load_s = time.perf_counter() - t0
    codec_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = native.parse_events_jsonl(buf)
        codec_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = native.parse_events_jsonl_py(buf)
    plain_s = time.perf_counter() - t0
    _same_columns(got, plain)
    check(len(got) == CODEC_SLICE and got.table(got.TABLE_EID)[0]
          == f"u{u[0]}", "codec parsed the wrong rows")
    mb = len(buf) / 1e6
    emit("codec_vs_plain", lines=CODEC_SLICE, bytes=len(buf),
         codec_seconds=codec_s, plain_seconds=plain_s,
         codec_mb_per_s=mb / min(codec_s), plain_mb_per_s=mb / plain_s,
         speedup=plain_s / min(codec_s), build_or_load_seconds=load_s,
         build=native.status(), host_cpus=os.cpu_count())


def _jsonl_env(base: str) -> dict:
    """The pio verbs' environment with the events on a JSONL log and the
    metadata and models on SQLite (bench_ingest.py's split)."""
    return _pio_env(base) | {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(base, "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(base, "events")}


def _storage_of(env: dict) -> Storage:
    return Storage({k: v for k, v in env.items()
                    if k.startswith("PIO_STORAGE_")})


def _write_engine_json(workdir: str, app: str,
                       variant: str = "default") -> None:
    with open(os.path.join(workdir, "engine.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"id": variant,
                   "engineFactory": "incubator_predictionio_torch.models."
                                    "recommendation.RecommendationEngine",
                   "datasource": {"params": {"appName": app}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": PIO_RANK, "numIterations": PIO_ITERS,
                       "lambda": PIO_LAMBDA}}]}, fh)


def _first_seen_filter(ref: dict, keep: np.ndarray) -> dict:
    """The plain triple of the events ``keep`` selects (in time order):
    users and items re-indexed in first-seen order."""
    def dense(idx, names):
        idx = idx[keep]
        keys, first = np.unique(idx, return_index=True)
        keys = keys[np.argsort(first)]
        lut = np.empty(len(names), np.int64)
        lut[keys] = np.arange(len(keys))
        return [names[k] for k in keys], lut[idx].astype(np.int32)

    users, u = dense(ref["u"], ref["users"])
    items, i = dense(ref["i"], ref["items"])
    return {"users": users, "items": items, "u": u, "i": i,
            "r": ref["r"][keep]}


def _hold_triple(got: tuple, want: dict, what: str) -> None:
    u, i, r, users, items = got
    check(np.array_equal(u, want["u"]) and np.array_equal(i, want["i"])
          and np.array_equal(r, want["r"]),
          f"{what}: the read's triple differs from the generated events")
    check(list(users.keys()) == want["users"]
          and list(items.keys()) == want["items"],
          f"{what}: the id maps are not in first-seen order")


def _train_verb(env: dict, workdir: str, path: str, extra=()) -> dict:
    """``pio train`` in its own process (the card, the warp kernel); its
    JSON line with ``wall_seconds``, its launches recorded under
    ``path``."""
    out, wall = _verb(["train", *extra], env, workdir, timeout=1200)
    trained = json.loads(out.stdout.strip().splitlines()[-1])
    record(path, trained["kernel_launches"])
    trained["wall_seconds"] = wall
    return trained


def _hold_train(trained: dict, want: dict, path: str) -> None:
    """The train read exactly ``want`` and launched the warp kernel the
    number of times its layout implies."""
    expected, _, _ = implied_launches(
        want["u"], want["i"], len(want["users"]), len(want["items"]),
        ALSParams(rank=PIO_RANK, num_iterations=PIO_ITERS, reg=PIO_LAMBDA),
        PIO_ITERS)
    got = trained["kernel_launches"]
    check(got["warp"] == expected and got["wide"] == 0,
          f"{path} launches {got} != implied {expected} warp")
    check(trained["timings"]["ratings_read"] == len(want["u"]),
          f"{path} read {trained['timings']['ratings_read']} ratings, "
          f"want {len(want['u'])}")
    trained["expected_launches"] = expected


def _hold_model(store: Storage, trained: dict, want: dict, path: str) -> dict:
    _, persisted = models_from_bytes(
        model_artifact.read_model(store, trained["engineInstanceId"]))
    stored = persisted[0]
    check(list(stored["users"]) == want["users"]
          and list(stored["items"]) == want["items"],
          f"{path}: the model's id maps differ from the events' "
          "first-seen order")
    uf, itf = stored["user_factors"], stored["item_factors"]
    check(uf.shape == (len(want["users"]), PIO_RANK)
          and bool(np.isfinite(uf).all() and np.isfinite(itf).all()),
          f"{path}: bad factors {uf.shape}")
    return stored


def _steady_ms(want: dict, params: ALSParams = ALSParams(
        rank=PIO_RANK, num_iterations=PIO_ITERS, reg=PIO_LAMBDA)) -> float:
    """Seconds per steady ALS iteration on the card, on the read's
    triple (ms)."""
    trainer = ALSTrainer(want["u"], want["i"], want["r"], len(want["users"]),
                         len(want["items"]), params, device="cuda")
    trainer.iterate(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.iterate(PIO_ITERS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / PIO_ITERS * 1e3
    del trainer
    torch.cuda.empty_cache()
    return ms


def _serve_and_check(env: dict, workdir: str, instance_id: str,
                     stored: dict, queried: list) -> dict:
    """``pio deploy`` of the newest instance; every query held to the
    host's top-k over the persisted factors."""
    m_users, m_items = stored["users"], stored["items"]
    uf, itf = stored["user_factors"], stored["item_factors"]
    query_ms = []
    with _Served(["deploy"], env, workdir) as srv:
        check(srv.info["engineInstanceId"] == instance_id
              and not srv.info["lifecycle"]["integrityFailures"],
              f"deployed {srv.info}")
        conn = srv.connect()
        for user in queried:
            status, res, ms = srv.request("POST", "/queries.json",
                                          {"user": user, "num": 10}, conn)
            check(status == 200, f"query {status}: {res}")
            check_user_answer(uf, itf, m_users[user], {"itemScores": [
                {"item": m_items[x["item"]], "score": x["score"]}
                for x in res["itemScores"]]})
            query_ms.append(ms)
        conn.close()
    return _percentiles(query_ms[1:])


def phase_pio_workflow_jsonl(workdir: str) -> None:
    """The pio_workflow scenario with EVENTDATA on a JSONL log: app new →
    import, split by event time into its older and newer half → eventlog
    compact after the older half (generation 1) → 2,000 live events
    through the event server (single POSTs, and batches of 50 through the
    codec's one-pass path) → eventlog compact (generation 2) → train
    --window leaving out the older half (generation 1 skipped by its
    bounds) → train (rank 32, 10 iterations, λ 0.01, the warp kernel) →
    deploy → 50 queries held to a host top-k."""
    n_users, n_items, _ = ML1M
    nnz = JSONL_IMPORT
    new_users, new_items = LIVE[2:]
    base = os.path.join(workdir, "pio_jsonl")
    env = _jsonl_env(base)
    out, _ = _verb(["app", "new", "ml1m"], env, workdir)
    key = out.stdout.split("Access Key:")[1].split()[0]
    events_path = os.path.join(workdir, "ml1m.jsonl")
    imported = _write_ml1m_jsonl(events_path, nnz)
    times = imported[3]
    mid_ms = int(np.sort(times)[nnz // 2])
    with open(events_path, "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    os.unlink(events_path)
    halves = []
    for k, sel in enumerate((times < mid_ms, times >= mid_ms)):
        part = os.path.join(workdir, f"ml1m.{k}.jsonl")
        with open(part, "wb") as fh:
            fh.writelines(ln for ln, keep in zip(lines, sel.tolist()) if keep)
        halves.append((part, int(sel.sum())))
    del lines
    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    import_s, compact_s = [], []
    for k, (part, count) in enumerate(halves):
        out, _ = _verb(["import", "--app-name", "ml1m", "--input", part],
                       env, workdir)
        import_s.append(_import_seconds(out.stdout, count, "import"))
        os.unlink(part)
        if k == 0:
            out, wall = _verb(["eventlog", "compact"], env, workdir)
            check("generation 1," in out.stdout, out.stdout)
            compact_s.append(wall)
    emit("pio_workflow_jsonl_import", events=nnz, import_seconds=import_s,
         events_per_s=nnz / sum(import_s),
         sqlite_events_per_s=SQLITE_NUMBERS.get("import_events_per_s"),
         sqlite_import_events=SQLITE_NUMBERS.get("events"),
         log_bytes=os.path.getsize(log_path))

    live = _live_events()
    acked, single_ms, batch_ms = _ingest_live(env, workdir, key, live)
    out, wall = _verb(["eventlog", "compact"], env, workdir)
    check("generation 2," in out.stdout, out.stdout)
    compact_s.append(wall)
    store = _storage_of(env)
    missing = [eid for eid in acked
               if store.get_l_events().get(eid, 1) is None]
    check(not missing, f"{len(missing)} acknowledged events not in the log")
    emit("pio_workflow_jsonl_ingest", events=len(live),
         single=_percentiles(single_ms[1:]),
         batch_of_50=_percentiles(batch_ms),
         sqlite=_sqlite_beside(SQLITE_NUMBERS.get("ingest")),
         compact_verb_seconds=compact_s)

    ref = _expected_triple(imported, live)
    total = nnz + len(live)
    seen = [len(set(imported[k].tolist())
                | {int(e[key][1:]) for e in live})
            for k, key in ((0, "entityId"), (1, "targetEntityId"))]
    check(len(ref["u"]) == total and len(ref["users"]) == seen[0]
          and len(ref["items"]) == seen[1],
          f"reference triple {len(ref['u'])}")
    all_times = np.sort(np.concatenate(
        [times, np.array([_ms(e["eventTime"]) for e in live], np.int64)]))
    _write_engine_json(workdir, "ml1m")

    # the windowed train: its bound leaves out the older half
    dur_s = int(time.time() - mid_ms / 1000)
    windowed = _train_verb(env, workdir, "pio_workflow_jsonl_window",
                           ["--window", f"{dur_s}s"])
    start_us = windowed["window"]["startUs"]
    keep = all_times * 1000 >= start_us
    want_w = _first_seen_filter(ref, keep)
    _hold_train(windowed, want_w, "pio_workflow_jsonl_window")
    chain = event_log.load_chain(log_path, start_us, None)
    check(chain["skipped"] == 1 and chain["pieces"][0][0] == "skip",
          f"windowed chain load skipped {chain['skipped']} generation(s)")
    t0 = time.perf_counter()
    got = PEventStore.find_ratings(
        "ml1m", storage=_storage_of(env),
        start_time=_dt.datetime.fromtimestamp(start_us / 1e6,
                                              _dt.timezone.utc))
    window_read_s = time.perf_counter() - t0
    _hold_triple(got, want_w, "windowed read")
    _hold_model(store, windowed, want_w, "pio_workflow_jsonl_window")

    # the full train, deployed
    first = _train_verb(env, workdir, "pio_workflow_jsonl")
    _hold_train(first, ref, "pio_workflow_jsonl")
    stored = _hold_model(store, first, ref, "pio_workflow_jsonl")
    check(all(f"u{n_users + j}" in stored["users"] for j in range(new_users))
          and all(f"i{n_items + j}" in stored["items"]
                  for j in range(new_items)),
          "a live user or item is not in the model")
    steady_ms = _steady_ms(ref)
    tm = first["timings"]
    emit("pio_workflow_jsonl_train", events=total, rank=PIO_RANK,
         iterations=PIO_ITERS, reg=PIO_LAMBDA,
         train_seconds_end_to_end=first["wall_seconds"],
         train_seconds_run_train=first["seconds"], timings=tm,
         read_seconds=tm["read_seconds"],
         read_share_of_run_train=tm["read_seconds"] / first["seconds"],
         events_per_s_end_to_end=total / first["wall_seconds"],
         steady_iteration_ms=steady_ms,
         kernel_launches=first["kernel_launches"],
         expected_launches=first["expected_launches"],
         sqlite=_sqlite_beside({k: SQLITE_NUMBERS.get(k) for k in (
             "read_seconds", "train_seconds_end_to_end",
             "steady_iteration_ms")}),
         window={"start_us": start_us, "events": int(keep.sum()),
                 "skipped_generations": chain["skipped"],
                 "decoded_bytes": chain["decodedBytes"],
                 "train_seconds_end_to_end": windowed["wall_seconds"],
                 "read_seconds": windowed["timings"]["read_seconds"],
                 "in_process_read_seconds": window_read_s,
                 "kernel_launches": windowed["kernel_launches"],
                 "expected_launches": windowed["expected_launches"]})

    rng = np.random.default_rng(24)
    queried = ([f"u{n_users + j}" for j in range(0, new_users, new_users // 25)]
               + [f"u{int(x)}" for x in rng.choice(imported[0], 25)])
    emit("pio_workflow_jsonl_serve", queries=len(queried),
         **_serve_and_check(env, workdir, first["engineInstanceId"], stored,
                            queried),
         sqlite=_sqlite_beside(SQLITE_NUMBERS.get("query")))
    store.close()
    phase_engine_server_lifecycle(workdir, env, first["engineInstanceId"])


def _ml20m_workdir(workdir: str) -> str:
    """The work directory with the most free disk of the temporary
    directory and the checkout's build directory."""
    candidates = [workdir, os.path.join(ROOT, "build")]
    os.makedirs(candidates[1], exist_ok=True)
    free = {d: shutil.disk_usage(d).free / 2**30 for d in candidates}
    best = max(candidates, key=free.get)
    with open("/proc/meminfo", encoding="ascii") as fh:
        meminfo = dict(ln.split(":", 1) for ln in fh)
    ram_gb = int(meminfo["MemAvailable"].split()[0]) / 2**20
    df = subprocess.run(["df", "-h", *candidates], capture_output=True,
                        text=True).stdout
    mem = subprocess.run(["free", "-g"], capture_output=True, text=True).stdout
    emit("pio_workflow_jsonl_ml20m_host", df=df, free_g=mem,
         free_gb=free, available_ram_gb=ram_gb, workdir=best)
    return best


def _timed_read(read, parts: dict):
    """Run ``read`` (a columnar find_ratings) with the snapshot load's
    steps timed into ``parts``: the CRC checks, ``_deserialize_cols``
    (and, measured again on the same blob after it, the ``raw`` member's
    load and the eventId table's JSON decode alone, which the training
    read never needs) and the numpy triple; ``other`` is the rest (file
    reads, the live mask)."""
    deserialize, crc32 = event_log._deserialize_cols, zlib.crc32
    ratings = p_event_store._columnar_ratings
    for k in ("crc32", "deserialize", "ratings"):
        parts[k] = 0.0

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                parts[name] += time.perf_counter() - t0
        return run

    def deserialize_and_split(blob):
        cols = timed("deserialize", deserialize)(blob)
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            t0 = time.perf_counter()
            bytes(z["raw"])
            parts["raw_member_alone"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            json.loads(bytes(z["table_5"]).decode("utf-8"))
            parts["event_id_table_alone"] = time.perf_counter() - t0
        return cols

    event_log._deserialize_cols = deserialize_and_split
    event_log.zlib = types.SimpleNamespace(crc32=timed("crc32", crc32))
    p_event_store._columnar_ratings = timed("ratings", ratings)
    t0 = time.perf_counter()
    try:
        return read()
    finally:
        total = time.perf_counter() - t0
        event_log._deserialize_cols = deserialize
        event_log.zlib = zlib
        p_event_store._columnar_ratings = ratings
        parts["other"] = total - sum(
            parts[k] for k in ("crc32", "deserialize", "ratings",
                               "raw_member_alone", "event_id_table_alone"))


def phase_pio_workflow_jsonl_ml20m(workdir: str, ratings) -> None:
    """The BASELINE metric's ratings through the verbs: the first
    ML20M_LOG_EVENTS of the ML-20M ratings (bench.py SCALES["ml20m"],
    synth_ratings seed 7, distinct shuffled event times) written as the
    JSONL store itself, byte for byte what
    insert_batch writes (a 10,000-line sample checked) → eventlog compact
    → the read held exactly to the generated arrays → train (rank 32, 10
    iterations, the warp kernel) → deploy → 20 queries held to a host
    top-k over the persisted factors."""
    n_users, n_items, _ = ML20M
    wdir, nnz = _ml20m_workdir(workdir), ML20M_LOG_EVENTS
    reduced = (f"first {nnz} of {ML20M[2]} events: the script's time "
               "(1,200 s)")
    cwd = tempfile.mkdtemp(dir=wdir)
    base = os.path.join(cwd, "pio_ml20m")
    env = _jsonl_env(base)
    _verb(["app", "new", "ml20m"], env, cwd)
    _write_engine_json(cwd, "ml20m")
    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    u, i, r = (a[:nnz] for a in ratings)
    times = _ml20m_times(ML20M[2])[:nnz]
    t0 = time.perf_counter()
    _write_log(log_path, u, i, r, times)
    write_s = time.perf_counter() - t0
    log_bytes = os.path.getsize(log_path)

    # a sample of lines, byte for byte what insert_batch writes
    rows = np.sort(np.random.default_rng(25).choice(nnz, 10_000,
                                                    replace=False))
    sample = b"".join(_log_lines(u[k:k + 1], i[k:k + 1], r[k:k + 1],
                                 times[k:k + 1], int(k)) for k in rows)
    scratch = tempfile.mkdtemp(dir=wdir)
    le = JSONLEvents(scratch)
    le.insert_batch([Event.from_json(json.loads(ln))
                     for ln in sample.splitlines()], 1)
    with open(os.path.join(scratch, "events_1.jsonl"), "rb") as fh:
        check(fh.read() == sample, "the log's lines differ from insert_batch's")
    le.close()
    shutil.rmtree(scratch)

    out, compact_s = _verb(["eventlog", "compact"], env, cwd,
                           timeout=1200)
    check(f"generation 1, {nnz} event(s)" in out.stdout, out.stdout)
    snap_bytes = os.path.getsize(log_path + ".g1.colseg")

    want = _expected_triple((u, i, r, times), [])
    read_parts: dict = {}
    t0 = time.perf_counter()
    got = _timed_read(lambda: PEventStore.find_ratings(
        "ml20m", storage=_storage_of(env)), read_parts)
    read_s = time.perf_counter() - t0
    _hold_triple(got, want, "ML-20M read")
    del got

    trained = _train_verb(env, cwd, "pio_workflow_jsonl_ml20m")
    _hold_train(trained, want, "pio_workflow_jsonl_ml20m")
    store = _storage_of(env)
    stored = _hold_model(store, trained, want, "pio_workflow_jsonl_ml20m")
    steady_ms = _steady_ms(want)
    tm = trained["timings"]
    rng = np.random.default_rng(26)
    queried = [want["users"][int(k)]
               for k in rng.integers(0, len(want["users"]), ML20M_QUERIES)]
    serve = _serve_and_check(env, cwd, trained["engineInstanceId"],
                             stored, queried)
    store.close()
    emit("pio_workflow_jsonl_ml20m", events=nnz, reduced=reduced,
         users=len(want["users"]), items=len(want["items"]),
         rank=PIO_RANK, iterations=PIO_ITERS, reg=PIO_LAMBDA,
         log_write_seconds=write_s, log_bytes=log_bytes,
         snapshot_bytes=snap_bytes, compact_verb_seconds=compact_s,
         in_process_read_seconds=read_s, in_process_read_parts=read_parts,
         train_seconds_end_to_end=trained["wall_seconds"],
         train_seconds_run_train=trained["seconds"],
         read_seconds=tm["read_seconds"], timings=tm,
         events_per_s_end_to_end=nnz / trained["wall_seconds"],
         steady_iteration_ms=steady_ms,
         events_per_s_steady=nnz / (steady_ms * PIO_ITERS / 1e3),
         kernel_launches=trained["kernel_launches"],
         expected_launches=trained["expected_launches"],
         queries=serve)
    single = phase_engine_server_load(env, cwd, trained["engineInstanceId"],
                                      stored, want)
    phase_engine_server_online(env, cwd, trained["engineInstanceId"], stored,
                               want)
    phase_engine_server_fleet(env, cwd, trained["engineInstanceId"], stored,
                              want, single)
    shutil.rmtree(cwd)


# -- the engine server: load and lifecycle ---------------------------------

#: queries of engine_server_load: one client's, and per client at 8 and at
#: 32 keep-alive clients; pio batchpredict's
#: CLIENT_QUERIES: each load client's queries (100 until the linear gang
#: and stream phases needed the time)
SERVE_QUERIES, CLIENT_QUERIES, BATCHPREDICT_QUERIES = 200, 50, 10_000
#: clients in flight at the SIGTERM of engine_server_load
DRAIN_CLIENTS = 16


def _hold_als_answer(stored: dict, user: str, res: dict) -> list:
    """One served answer held to the host top-k over the persisted
    factors; returns its item names."""
    check_user_answer(stored["user_factors"], stored["item_factors"],
                      stored["users"][user], {"itemScores": [
                          {"item": stored["items"][x["item"]],
                           "score": x["score"]}
                          for x in res["itemScores"]]})
    return [x["item"] for x in res["itemScores"]]


def _clients(srv: "_Served", users: list, n_clients: int, stored: dict,
             headers=None) -> dict:
    """``n_clients`` keep-alive clients, each POSTing its share of
    ``users`` back to back after one warm-up query; every answer held to
    the host top-k. Queries/s over the wall time, p50/p99 per query."""
    shares = [users[c::n_clients] for c in range(n_clients)]
    lat: list = []
    answers: dict = {}
    errors: list = []
    lock = threading.Lock()
    start = threading.Barrier(n_clients + 1)

    def client(share):
        conn = srv.connect()
        try:
            srv.request("POST", "/queries.json",
                        {"user": share[0], "num": 10}, conn)
            start.wait()
            mine = []
            for user in share:
                status, res, ms = srv.request(
                    "POST", "/queries.json", {"user": user, "num": 10}, conn)
                check(status == 200, f"query {status}: {res}")
                mine.append((user, res, ms))
            with lock:
                for user, res, ms in mine:
                    lat.append(ms)
                    answers[user] = res
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))
            start.abort()
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(sh,)) for sh in shares]
    for t in threads:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass  # a client failed before the start: its error is reported
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"{n_clients} clients: {errors[:3]}")
    for user, res in answers.items():
        _hold_als_answer(stored, user, res)
    return {"clients": n_clients, "queries": len(lat),
            "queries_per_s": len(lat) / wall, "wall_seconds": wall,
            **_percentiles(lat), "answers": answers}


def _load_runs(srv, users, stored) -> dict:
    """8 and 32 keep-alive clients, CLIENT_QUERIES each."""
    out = {}
    for n in (8, 32):
        out[n] = _clients(srv, users[:n * CLIENT_QUERIES], n, stored)
    return out


def _sigterm_drain(srv: "_Served") -> dict:
    """SIGTERM while DRAIN_CLIENTS keep-alive clients query back to back:
    every accepted query is answered 200, later ones shed 503 (each
    client stops at its first 503), /readyz answers 503 during the drain
    and the process exits 0."""
    users = [f"u{k}" for k in range(DRAIN_CLIENTS)]
    codes: list = []
    lost: list = []
    sent_sigterm = threading.Event()
    lock = threading.Lock()

    def client(user):
        conn = srv.connect()
        try:
            while True:
                try:
                    status, _, _ = srv.request(
                        "POST", "/queries.json", {"user": user, "num": 10},
                        conn)
                except (OSError, http.client.HTTPException) as e:
                    with lock:
                        lost.append((sent_sigterm.is_set(), repr(e)))
                    return
                with lock:
                    codes.append((sent_sigterm.is_set(), status))
                if status != 200:
                    return
        finally:
            conn.close()

    readyz = srv.connect()
    check(srv.request("GET", "/readyz", conn=readyz)[0] == 200,
          "not ready before the SIGTERM")
    threads = [threading.Thread(target=client, args=(u,)) for u in users]
    for t in threads:
        t.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    sent_sigterm.set()
    srv.proc.send_signal(signal.SIGTERM)
    ready_codes = []
    while time.perf_counter() - t0 < 10:
        try:
            ready_codes.append(srv.request("GET", "/readyz", conn=readyz)[0])
        except (OSError, http.client.HTTPException):
            break
        if ready_codes[-1] == 503:
            break
    readyz.close()
    for t in threads:
        t.join(timeout=60)
    rc = srv.proc.wait(timeout=60)
    exit_s = time.perf_counter() - t0
    statuses = {st for _, st in codes}
    check(statuses <= {200, 503} and all(st == 200 for after, st in codes
                                         if not after),
          f"drain: statuses {sorted(statuses)}")
    check(not [e for after, e in lost if not after],
          f"drain: connections lost before the SIGTERM {lost[:3]}")
    check(503 in ready_codes, f"/readyz during the drain: {ready_codes}")
    check(rc == 0, f"deploy exited {rc} after SIGTERM")
    return {"clients": DRAIN_CLIENTS,
            "answered_200": sum(st == 200 for _, st in codes),
            "answered_200_after_sigterm": sum(st == 200 for a, st in codes
                                              if a),
            "shed_503": sum(st == 503 for _, st in codes),
            "connections_closed_after_sigterm": len(lost),
            "readyz_after_sigterm": ready_codes, "exit_code": rc,
            "sigterm_to_exit_seconds": exit_s}


def _undeploy(srv: "_Served", env: dict, cwd: str) -> dict:
    out, seconds = _verb(["undeploy", "--ip", "127.0.0.1", "--port",
                          str(srv.port)], env, cwd)
    check("Shutting down." in out.stdout, f"undeploy: {out.stdout}")
    rc = srv.proc.wait(timeout=60)
    check(rc == 0, f"deploy exited {rc} after pio undeploy")
    return {"undeploy_seconds": seconds, "exit_code": rc}


def _same_answers(a: dict, b: dict) -> dict:
    """Two answers per user (each already held to the host top-k): how
    many are index-identical, and the largest score gap at equal rank
    (two float32 reductions of other orders may swap a near tie)."""
    same = sum(_items(a[u]) == _items(b[u]) for u in a)
    gap = max(abs(x["score"] - y["score"]) for u in a
              for x, y in zip(a[u]["itemScores"], b[u]["itemScores"]))
    check(gap <= 1e-4, f"answers differ by {gap} at equal rank")
    return {"users": len(a), "index_identical": same, "max_score_gap": gap}


def _items(res: dict) -> list:
    return [x["item"] for x in res["itemScores"]]


def phase_engine_server_load(env: dict, cwd: str, instance_id: str,
                             stored: dict, want: dict) -> dict:
    """The engine server on the ML-20M-shaped store (pio_workflow_jsonl_ml20m's
    312,500 events, rank 32): pio deploy --probe-latency (the probe's
    split from /status), one keep-alive client × SERVE_QUERIES, then 8 and
    32 clients without and with micro-batching (--batch-window-ms 2
    --max-batch 64), the result cache (hits and misses), a 504 deadline,
    pio batchpredict of BATCHPREDICT_QUERIES, SIGTERM with clients in
    flight and pio undeploy. Every answer is held to the host top-k."""
    rng = np.random.default_rng(27)
    users = [want["users"][int(k)] for k in
             rng.integers(0, len(want["users"]), BATCHPREDICT_QUERIES)]
    load_users = [want["users"][int(k)] for k in
                  rng.integers(0, len(want["users"]), 32 * CLIENT_QUERIES)]
    reset_launches()
    out: dict = {}
    with _Served(["deploy", "--probe-latency"], env, cwd) as srv:
        check(srv.info["engineInstanceId"] == instance_id,
              f"deployed {srv.info}")
        probe = None
        t_end = time.time() + 120
        while probe is None and time.time() < t_end:
            probe = srv.request("GET", "/status")[1].get("probeLatency")
            time.sleep(0.2)
        check(probe is not None, "no probeLatency on /status")
        single = _clients(srv, users[:SERVE_QUERIES], 1, stored)
        plain = _load_runs(srv, load_users, stored)
        status, res, _, _ = srv.request_h("POST", "/queries.json",
                                          {"user": users[0], "num": 10},
                                          {"X-Pio-Deadline-Ms": "0.001"})
        check(status == 504, f"X-Pio-Deadline-Ms 0.001 gave {status}: {res}")
        overload = srv.request("GET", "/status")[1]["overload"]
        check(overload["deadlineExceeded"] == 1, f"overload {overload}")
        out["undeploy"] = _undeploy(srv, env, cwd)
    served = single.pop("answers")
    out.update(probe=probe, single_client=single, deadline_504=True,
               overload=overload,
               unbatched={n: {k: v for k, v in r.items() if k != "answers"}
                          for n, r in plain.items()})
    with contextlib.ExitStack() as stack:
        # the batched and the caching deploy start together (after the
        # probe's, whose split a concurrent start would disturb); the
        # caching one idles while the batched one is measured
        booting = []
        for flags in (["--batch-window-ms", "2", "--max-batch", "64"],
                      ["--query-cache-size", "10000"]):
            booting.append(_Served(["deploy"] + flags, env, cwd))
            stack.push(booting[-1].__exit__)
        srv, cache_srv = (s.__enter__() for s in booting)
        batched = _load_runs(srv, load_users, stored)
        out["drain"] = _sigterm_drain(srv)
        out["batched"] = {n: {k: v for k, v in r.items() if k != "answers"}
                          for n, r in batched.items()}
        out["batched_vs_unbatched"] = {
            n: _same_answers(plain[n]["answers"], batched[n]["answers"])
            for n in (8, 32)}
        srv = cache_srv
        miss = _clients(srv, users[:SERVE_QUERIES], 1, stored)
        hit = _clients(srv, users[:SERVE_QUERIES], 1, stored)
        cache = srv.request("GET", "/status")[1]["queryCache"]
        check(cache["hits"] >= SERVE_QUERIES and cache["misses"] >= 1,
              f"query cache {cache}")
        check(_same_answers(miss["answers"], hit["answers"])[
            "index_identical"] == len(hit["answers"]), "cache hits differ")
        out["cache"] = {**cache, "miss_pass_p50_ms": miss["p50_ms"],
                        "hit_pass_p50_ms": hit["p50_ms"],
                        "hit_pass_p99_ms": hit["p99_ms"]}
        out["cache"]["undeploy"] = _undeploy(srv, env, cwd)
    qpath, opath = (os.path.join(cwd, n) for n in
                    ("bp_queries.jsonl", "bp_out.jsonl"))
    with open(qpath, "w", encoding="utf-8") as fh:
        fh.writelines(json.dumps({"user": u, "num": 10}) + "\n"
                      for u in users)
    bp, bp_wall = _verb(["batchpredict", "--input", qpath, "--output",
                         opath], env, cwd)
    bp_s = float(bp.stdout.rsplit(" in ", 1)[1].split("s")[0])
    with open(opath, encoding="utf-8") as fh:
        lines = [json.loads(ln) for ln in fh]
    check([ln["query"]["user"] for ln in lines] == users,
          "batchpredict's queries differ from its input")
    predicted = {}
    for ln in lines:
        _hold_als_answer(stored, ln["query"]["user"], ln["prediction"])
        predicted[ln["query"]["user"]] = ln["prediction"]
    out["batchpredict"] = {
        "queries": len(lines), "verb_wall_seconds": bp_wall,
        "predict_seconds": bp_s,
        "us_per_query": bp_s / len(lines) * 1e6,
        "vs_served": _same_answers(
            served, {u: predicted[u] for u in served})}
    PATH_LAUNCHES["engine_server_load"] = {"warp": 0, "wide": 0}
    emit("engine_server_load", instance=instance_id,
         users=len(want["users"]), items=len(want["items"]),
         launches=launches(), **out)
    return out["unbatched"]


def phase_engine_server_lifecycle(workdir: str, env: dict,
                                  deployed_id: str) -> None:
    """The model lifecycle on the ML-1M log store that pio_workflow_jsonl
    leaves: pio deploy --model-refresh-ms 500 → a further pio train (the
    warp kernel; λ and iterations changed so the answers move) → the
    refresh swap within 10 s, answers equal the new instance's host top-k
    → POST /rollback brings the old answers back and pins the new
    instance across ≥ 2 refresh polls → pio models list / verify / gc
    --keep 1 --engine-url (the deployed and pinned instances kept) →
    /reload?instance=<new> removes the pin → gc --dry-run keeps the
    deployed and previous ones."""
    store = _storage_of(env)
    rng = np.random.default_rng(29)
    old = _persisted(env, deployed_id)
    users = [list(old["users"])[int(k)]
             for k in rng.integers(0, len(old["users"]), 25)]
    out: dict = {}
    with _Served(["deploy", "--model-refresh-ms", "500"], env,
                 workdir) as srv:
        check(srv.info["engineInstanceId"] == deployed_id,
              f"deployed {srv.info}")
        conn = srv.connect()

        def answers(model):
            got = {}
            for u in users:
                status, res, _ = srv.request(
                    "POST", "/queries.json", {"user": u, "num": 10}, conn)
                check(status == 200, f"query {status}: {res}")
                got[u] = _hold_als_answer(model, u, res)
            return got

        before = answers(old)
        with open(os.path.join(workdir, "engine.json"), "w",
                  encoding="utf-8") as fh:
            json.dump({"id": "default",
                       "engineFactory": "incubator_predictionio_torch."
                                        "models.recommendation."
                                        "RecommendationEngine",
                       "datasource": {"params": {"appName": "ml1m"}},
                       "algorithms": [{"name": "als", "params": {
                           "rank": PIO_RANK, "numIterations": 5,
                           "lambda": 0.05}}]}, fh)
        trained = _train_verb(env, workdir, "engine_server_lifecycle")
        _write_engine_json(workdir, "ml1m")
        new_id = trained["engineInstanceId"]
        t0 = time.perf_counter()
        lc = {}
        while time.perf_counter() - t0 < 10:
            lc = srv.request("GET", "/status", conn=conn)[1]["lifecycle"]
            if lc["refreshSwaps"] >= 1:
                break
            time.sleep(0.05)
        swap_s = time.perf_counter() - t0
        check(lc["refreshSwaps"] == 1 and lc["instance"] == new_id
              and lc["previous"] == deployed_id,
              f"no refresh swap within 10 s: {lc}")
        new = _persisted(env, new_id)
        after = answers(new)
        moved = sum(before[u] != after[u] for u in users)
        check(moved > 0, "the retrain changed no answer")
        status, res, _ = srv.request("POST", "/rollback", conn=conn)
        check(status == 200 and res["engineInstanceId"] == deployed_id,
              f"/rollback {status}: {res}")
        check(answers(old) == before, "rollback did not restore the answers")
        time.sleep(1.2)  # ≥ 2 refresh polls at 500 ms
        doc = srv.request("GET", "/status", conn=conn)[1]
        lc = doc["lifecycle"]
        check(doc["engineInstanceId"] == deployed_id
              and lc["pinned"] == {new_id: "manual"}
              and lc["refreshSwaps"] == 1, f"pin did not hold: {lc}")
        check(answers(old) == before, "answers moved while pinned")
        url = f"http://127.0.0.1:{srv.port}"
        listed, _ = _verb(["models", "list"], env, workdir)
        verified, _ = _verb(["models", "verify"], env, workdir)
        gc, _ = _verb(["models", "gc", "--keep", "1", "--engine-url", url],
                      env, workdir)
        check("protected=2" in gc.stdout
              and model_artifact.model_exists(store, deployed_id)
              and model_artifact.model_exists(store, new_id),
              f"gc removed a served model: {gc.stdout}")
        status, res, _ = srv.request(
            "GET", f"/reload?instance={new_id}", conn=conn)
        check(status == 200 and res["engineInstanceId"] == new_id,
              f"/reload?instance= {status}: {res}")
        lc = srv.request("GET", "/status", conn=conn)[1]["lifecycle"]
        check(lc["pinned"] == {} and lc["previous"] == deployed_id,
              f"reload kept the pin: {lc}")
        check(answers(new) == after, "reload did not restore the new answers")
        dry, _ = _verb(["models", "gc", "--keep", "1", "--dry-run",
                        "--engine-url", url], env, workdir)
        check("would delete 0" in dry.stdout and "protected=2" in dry.stdout,
              f"gc --dry-run: {dry.stdout}")
        conn.close()
        out.update(lifecycle=lc, swap_seconds_after_train=swap_s,
                   answers_moved=moved, users=len(users),
                   models_list=listed.stdout.strip().splitlines(),
                   models_verify=verified.stdout.strip().splitlines()[-1],
                   models_gc=gc.stdout.strip().splitlines())
    check(srv.proc.returncode == 0, f"deploy exited {srv.proc.returncode}")
    store.close()
    emit("engine_server_lifecycle", deployed=deployed_id, retrained=new_id,
         train_seconds_end_to_end=trained["wall_seconds"],
         kernel_launches=trained["kernel_launches"], **out)


# -- the engine server online: fold-in, the quality watch, tenants ----------

#: ``pio deploy`` with the fold-in runner's kernel launches counted per fold
#: (the warp and wide counters' deltas across each ``_fold_and_commit``),
#: the process's totals and the threads still alive at exit, written as
#: JSON to $PIO_COUNTS_OUT. With $PIO_POISON_FOLDIN_FILE set, a poisoned
#: chain: once that file names an app, the app's next increment is
#: committed with its user factors cut to one row (the golden query
#: passes, every other user fails), the file is removed, and every later
#: increment folded through a poisoned one is cut the same way
_COUNTED_DEPLOY = r"""
import atexit, dataclasses, json, os, sys, threading
import numpy as np
from incubator_predictionio_torch.ops import spd_solve
from incubator_predictionio_torch.tools import console
from incubator_predictionio_torch.workflow import online

calls = []
poisoned = set()
real = online.FoldInRunner._fold_and_commit
real_commit = online.FoldInRunner._commit_increment
trigger = os.environ.get("PIO_POISON_FOLDIN_FILE")

def counted(self, *a, **kw):
    warp = spd_solve.gauss_jordan_warp_launches.count
    wide = spd_solve.gauss_jordan_wide_launches.count
    iid = real(self, *a, **kw)
    calls.append({"instance": iid, "app": self._app_name,
                  "poisoned": iid in poisoned,
                  "warp": spd_solve.gauss_jordan_warp_launches.count - warp,
                  "wide": spd_solve.gauss_jordan_wide_launches.count - wide})
    return iid

def cut(model):
    f = model.factors
    return dataclasses.replace(model, factors=dataclasses.replace(
        f, user_factors=np.asarray(f.user_factors)[:1]))

def commit(self, instance, algo_list, models, n_events, cursor, ancestors,
           users):
    poison = bool(poisoned & set(ancestors))
    if not poison and trigger and os.path.exists(trigger):
        with open(trigger) as fh:
            poison = fh.read().strip() == self._app_name
        if poison:
            os.remove(trigger)
    if poison:
        models = [cut(m) for m in models]
    iid = real_commit(self, instance, algo_list, models, n_events, cursor,
                      ancestors, users)
    if poison:
        poisoned.add(iid)
    return iid

online.FoldInRunner._fold_and_commit = counted
online.FoldInRunner._commit_increment = commit

@atexit.register
def dump():
    with open(os.environ["PIO_COUNTS_OUT"], "w") as fh:
        json.dump({"calls": calls,
                   "warp": spd_solve.gauss_jordan_warp_launches.count,
                   "wide": spd_solve.gauss_jordan_wide_launches.count,
                   "threads": sorted(t.name for t in threading.enumerate()
                                     if t.is_alive())}, fh)

sys.exit(console.main(sys.argv[1:]))
"""
#: the knobs of engine_server_online: a fold-in tick every 250 ms, every
#: answered query sampled, samples resolved after 300 ms, a breach after 20
#: graded samples, a quality watch open for the whole phase
ONLINE_ENV = {"PIO_FOLDIN_MS": "250", "PIO_QUALITY_SAMPLE": "1.0",
              "PIO_QUALITY_RESOLVE_MS": "300", "PIO_QUALITY_MS": "200",
              "PIO_QUALITY_MIN_SAMPLES": "20",
              "PIO_QUALITY_WATCH_MS": "300000"}
#: new users of the cold-start batch whose first answers are waited for;
#: users graded by the quality step; new users of the gate's clean batch
COLD_USERS, QUALITY_USERS, CLEAN_USERS = 20, 40, 50
#: engine_server_tenants: apps, each an ML-100K-shaped log trained in
#: process at rank 10 × 5 iterations; resident deployments; one tenant's
#: budget; queries per client
TENANTS, TENANT_RANK, TENANT_ITERS = 8, 10, 5
TENANT_RESIDENT, TENANT_PENDING, TENANT_QUERIES = 4, 2, 60
FACTORY = ("incubator_predictionio_torch.models.recommendation."
           "RecommendationEngine")


def _prefixed(events: list) -> list:
    """fold_in_events' ids in the ML-20M log's spelling (u<n>, i<n>)."""
    return [{**e, "entityId": "u" + e["entityId"],
             "targetEntityId": "i" + e["targetEntityId"]} for e in events]


def _counted_serve(args: list, env: dict, cwd: str, counts: str) -> _Served:
    return _Served(args, env | {"PIO_COUNTS_OUT": counts}, cwd,
                   console=[sys.executable, "-c", _COUNTED_DEPLOY])


def _counted(counts: str, path: str, extra_warp: int = 0,
             split: dict | None = None) -> dict:
    """The deploy process's launch counts after its exit: every fold that
    committed an increment launched the warp kernel exactly twice and the
    wide kernel never, a fold that committed nothing launched nothing, and
    no fold-in or quality thread outlived the drain. Recorded under
    ``path`` (with ``extra_warp`` launches of the phase's own process),
    except the folds of the increments ``split`` names (path → instance
    ids), which are recorded under their own path."""
    with open(counts, encoding="utf-8") as fh:
        doc = json.load(fh)
    for c in doc["calls"]:
        want = (2, 0) if c["instance"] else (0, 0)
        check((c["warp"], c["wide"]) == want,
              f"fold-in {c}: launches are not {want}")
    committed = sum(1 for c in doc["calls"] if c["instance"])
    check(doc["warp"] == 2 * committed and doc["wide"] == 0,
          f"the deploy launched {doc['warp']} warp / {doc['wide']} wide "
          f"kernels for {committed} increment(s)")
    check(not {"pio-foldin", "pio-quality"} & set(doc["threads"]),
          f"threads left at exit: {doc['threads']}")
    rest = doc["warp"]
    out = {"increments": committed, "folds": len(doc["calls"]),
           "warp": doc["warp"], "wide": doc["wide"],
           "threads_at_exit": doc["threads"]}
    for own, ids in (split or {}).items():
        calls = [c for c in doc["calls"] if c["instance"] in set(ids)]
        check(len(calls) == len(ids), f"{own}: folds {calls} of {ids}")
        warp = sum(c["warp"] for c in calls)
        record(own, {"warp": warp, "wide": 0})
        rest -= warp
        out[own] = {"warp": warp, "folds": calls}
    record(path, {"warp": rest + extra_warp, "wide": doc["wide"]})
    return out


class _Pump(threading.Thread):
    """One keep-alive client querying ``users`` back to back until
    ``finish``: (time, status, ms) per query."""

    def __init__(self, srv: _Served, users: list, headers=None):
        super().__init__(daemon=True)
        self.srv, self.users, self.headers = srv, users, headers or {}
        self.halt = threading.Event()
        self.log: list = []
        self.errors: list = []

    def run(self):
        conn = self.srv.connect()
        k = 0
        try:
            while not self.halt.is_set():
                user = self.users[k % len(self.users)]
                k += 1
                try:
                    status, _, ms, _ = self.srv.request_h(
                        "POST", "/queries.json", {"user": user, "num": 10},
                        self.headers, conn)
                except (OSError, http.client.HTTPException) as e:
                    self.errors.append(repr(e))
                    return
                self.log.append((time.perf_counter(), status, ms))
        finally:
            conn.close()

    def window(self, t0: float, t1: float) -> dict:
        ms = [m for t, _, m in self.log if t0 <= t <= t1]
        return _percentiles(ms) if ms else {"n": 0}

    def finish(self) -> dict:
        self.halt.set()
        self.join(60)
        codes = sorted({s for _, s, _ in self.log})
        check(not self.errors and codes == [200],
              f"keep-alive client: statuses {codes}, errors {self.errors[:3]}")
        return {"queries": len(self.log), "statuses": codes}


def _settled(read, timeout: float = 10.0):
    """``read()`` → (from /metrics, from /status, page) until the two agree
    or ``timeout`` passes; the last reading."""
    t_end = time.perf_counter() + timeout
    while True:
        got, want, text = read()
        if got == want or time.perf_counter() > t_end:
            return got, want, text
        time.sleep(0.2)


def _wait_status(srv: _Served, what: str, pred, timeout: float = 120.0):
    """Poll /status until ``pred(doc)`` is truthy; its value."""
    t_end = time.perf_counter() + timeout
    doc: dict = {}
    while time.perf_counter() < t_end:
        doc = srv.request("GET", "/status")[1]
        got = pred(doc)
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"{what} within {timeout:.0f} s: {doc}")


def _increments(store: Storage, base_id: str) -> list:
    """The fold-in increments committed since ``base_id``, in log order:
    [(instance id, marker)]."""
    rows = store.get_meta_data_engine_instances().get_completed(
        FACTORY, "1", "default")
    base = next(r for r in rows if r.id == base_id)
    out = [(r.id, json.loads(r.runtime_conf["foldin"])) for r in rows
           if r.start_time > base.start_time
           and (r.runtime_conf or {}).get("foldin")]
    return sorted(out, key=lambda x: x[1]["lsn"])


def _log_events(log_path: str, lo: int, hi: int) -> list:
    with open(log_path, "rb") as fh:
        fh.seek(lo)
        return [json.loads(ln) for ln in fh.read(hi - lo).splitlines()]


def _cpu_fold_chain(stored: dict, log_path: str, start: int, incs: list):
    """The CPU fold-in (plain solve) of every increment's log bytes, one
    after the other, from the persisted base ``stored``."""
    from incubator_predictionio_torch.models.recommendation import (
        model_from_persisted,
    )

    algo = als_engine(PIO_RANK, PIO_ITERS, PIO_LAMBDA)[2]
    model = model_from_persisted(stored, "cpu")
    lo = start
    for _, marker in incs:
        out = algo.fold_in(model, _log_events(log_path, lo, marker["lsn"]))
        model = out if out is not None else model
        lo = marker["lsn"]
    return model


def _known_answer(srv: _Served, conn, user: str):
    status, res, _ = srv.request("POST", "/queries.json",
                                 {"user": user, "num": 10}, conn)
    check(status == 200, f"query {user}: {status} {res}")
    return res if res["itemScores"] else None


def _wait_known(srv: _Served, users: list, timeout: float = 120.0) -> dict:
    """Query ``users`` until each gets a non-empty answer; their answers."""
    conn = srv.connect()
    answers: dict = {}
    t_end = time.perf_counter() + timeout
    try:
        while len(answers) < len(users) and time.perf_counter() < t_end:
            for u in users:
                if u not in answers:
                    res = _known_answer(srv, conn, u)
                    if res is not None:
                        answers[u] = res
            if len(answers) < len(users):
                time.sleep(0.05)
    finally:
        conn.close()
    check(len(answers) == len(users),
          f"{len(users) - len(answers)} new user(s) never served")
    return answers


def _commit_instance(store: Storage, like_id: str, stored: dict) -> str:
    """A COMPLETED instance like ``like_id`` (its params and app, no
    fold-in marker) whose model is ``stored``, committed as a train
    commits: row RUNNING → artifact → COMPLETED."""
    import dataclasses

    from incubator_predictionio_torch.workflow.persist import (
        engine_json_from_bytes, models_to_bytes,
    )

    instances = store.get_meta_data_engine_instances()
    like = instances.get(like_id)
    now = _dt.datetime.now(_dt.timezone.utc)
    conf = {k: v for k, v in (like.runtime_conf or {}).items()
            if k != "foldin"}
    row = dataclasses.replace(like, id=new_event_id(), status="RUNNING",
                              start_time=now, end_time=None,
                              runtime_conf=conf)
    instances.insert(row)
    engine_json = engine_json_from_bytes(model_artifact.read_model(store,
                                                                   like_id))
    model_artifact.write_model(store, row.id,
                               models_to_bytes(engine_json, [stored]))
    instances.update(row.with_status(
        "COMPLETED", _dt.datetime.now(_dt.timezone.utc)))
    return row.id


def phase_engine_server_online(env: dict, cwd: str, instance_id: str,
                               stored: dict, want: dict) -> None:
    """pio deploy --online-foldin --quality-eval on the ML-20M-shaped store
    (pio_workflow_jsonl_ml20m's instance, no retrain), one keep-alive
    client querying known users throughout:

    1. cold start: the FOLD_IN batch (2,000 new users × 5, 500 new items ×
       4, 20,000 events, seed 8) appended through the event storage; the
       seconds until COLD_USERS sampled new users are served; the served
       increments' factors against the CPU fold-in of the same log bytes
       (relative norm 1e-2 at λ 0.01, as phase_fold_in); their answers held
       to the host top-k of the persisted increment; the client's p50/p99
       while the increments land;
    2. the gate: a batch with a NaN rating is folded, refused by the gate
       and pinned while the last-good serves, then a clean batch is folded
       into the last-good and served;
    3. quality: a hand-committed instance with negated item factors
       (reversed rankings, no error) is loaded through /reload; the users'
       next events are their good top-1 items; the quality watch rolls it
       back with reason quality, every client query answered 200;
    4. pio status (the cursor row, the freshness lag) and status
       --engine-url (the fold-in and quality lines); /metrics's fold-in and
   quality families equal to /status's counts;
    5. SIGTERM: exit 0, no fold-in or quality thread left, exactly 2 warp
       launches per committed increment."""
    n_users, n_items, _ = ML20M
    new_users, new_items, n_events = FOLD_IN
    counts = os.path.join(cwd, "online_counts.json")
    store = _storage_of(env)
    app = store.get_meta_data_apps().get_by_name("ml20m")
    le = store.get_l_events()
    log_path = os.path.join(le.events_dir, f"events_{app.id}.jsonl")
    rng = np.random.default_rng(31)
    known = [want["users"][int(k)]
             for k in rng.integers(0, len(want["users"]), 200)]
    batch = _prefixed(fold_in_events(
        n_users, n_items, new_users, new_items,
        n_events - 5 * new_users - 4 * new_items, seed=8))
    cold = [f"u{n_users + j}"
            for j in range(0, new_users, new_users // COLD_USERS)]
    reset_launches()
    out: dict = {}
    with _counted_serve(["deploy", "--online-foldin", "--quality-eval"],
                        env | ONLINE_ENV, cwd, counts) as srv:
        check(srv.info["engineInstanceId"] == instance_id,
              f"deployed {srv.info}")
        pump = _Pump(srv, known)
        pump.start()
        time.sleep(2.0)  # the client's baseline, no increment landing

        # 1. cold start
        size0 = os.path.getsize(log_path)
        t_in = time.perf_counter()
        le.insert_batch([Event.from_json(e) for e in batch], app.id)
        t_written = time.perf_counter()
        size1 = os.path.getsize(log_path)
        _wait_known(srv, cold)
        t_known = time.perf_counter()
        incs = _wait_status(srv, "the batch's last increment published",
                            lambda d: (lambda i: i if i and i[-1][1]["lsn"]
                                       == size1 and d["engineInstanceId"]
                                       == i[-1][0] else None)(
                                _increments(store, instance_id)))
        t_published = time.perf_counter()
        last_id = incs[-1][0]
        inc = _persisted(env, last_id)
        cpu = _cpu_fold_chain(stored, log_path, size0, incs)
        check(list(inc["users"]) == list(cpu.users.keys())
              and list(inc["items"]) == list(cpu.items.keys()),
              "the increment's id maps differ from the CPU fold-in's")
        pairs = [(inc["user_factors"], cpu.factors.user_factors),
                 (inc["item_factors"], cpu.factors.item_factors)]
        rel = max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
                  for a, b in pairs)
        check(rel < 1e-2, f"served increment vs CPU fold-in: relative "
                          f"norm {rel}")
        conn = srv.connect()
        held = 0
        for u in cold + known[:20]:
            res = _known_answer(srv, conn, u)
            check(res is not None, f"{u} got no answer")
            _hold_als_answer(inc, u, res)
            held += 1
        out["cold_start"] = {
            "events": len(batch), "new_users": new_users,
            "new_items": new_items, "sampled_new_users": len(cold),
            "insert_seconds": t_written - t_in,
            "freshness_seconds": t_known - t_in,
            "published_seconds": t_published - t_in,
            "increments": len(incs),
            "events_per_increment": [m["events"] for _, m in incs],
            "max_abs_err_vs_cpu": {"user": max_err(*pairs[0]),
                                   "item": max_err(*pairs[1])},
            "rel_norm_err_vs_cpu": rel, "answers_held": held,
            "client_before": pump.window(t_in - 2.0, t_in),
            "client_while_landing": pump.window(t_in, t_published)}

        # 2. the gate: a NaN increment refused and pinned, then a clean one
        nan_users = known[:10]
        le.insert_batch([Event.from_json({
            "event": "rate", "entityType": "user", "entityId": u,
            "targetEntityType": "item",
            "targetEntityId": want["items"][k % len(want["items"])],
            "properties": {"rating": "nan"}})
            for k, u in enumerate(nan_users)], app.id)
        lc = _wait_status(srv, "the NaN increment pinned",
                          lambda d: d["lifecycle"] if "validate" in
                          d["lifecycle"]["pinned"].values() else None)
        nan_id = next(i for i, r in lc["pinned"].items() if r == "validate")
        check(lc["instance"] == last_id, f"the NaN increment went live: {lc}")
        for u in nan_users:
            _hold_als_answer(inc, u, _known_answer(srv, conn, u))
        fresh = [f"u{n_users + new_users + j}" for j in range(CLEAN_USERS)]
        clean = [{"event": "rate", "entityType": "user", "entityId": u,
                  "targetEntityType": "item",
                  "targetEntityId":
                      want["items"][(7 * j + k) % len(want["items"])],
                  "properties": {"rating": float(1 + (j + k) % 5)}}
                 for j, u in enumerate(fresh) for k in range(5)]
        le.insert_batch([Event.from_json(e) for e in clean], app.id)
        _wait_known(srv, fresh)
        clean_id = _wait_status(srv, "the clean increment published",
                                lambda d: d["engineInstanceId"]
                                if d["engineInstanceId"] != last_id
                                else None)
        marker = dict(_increments(store, instance_id))[clean_id]
        check(marker["of"] == last_id and nan_id not in marker["bases"],
              f"the clean increment folded through the pinned one: {marker}")
        healed = _persisted(env, clean_id)
        for u in fresh[:10]:
            _hold_als_answer(healed, u, _known_answer(srv, conn, u))
        out["gate"] = {"nan_instance": nan_id, "pinned": lc["pinned"],
                       "validate_failures": lc["validateFailures"],
                       "clean_instance": clean_id,
                       "clean_new_users": len(fresh)}

        # 3. quality: a reversed-rank instance rolled back by the watch
        bad = dict(healed, item_factors=-healed["item_factors"])
        bad_id = _commit_instance(store, clean_id, bad)
        status, res, _ = srv.request("POST", "/reload", conn=conn)
        check(status == 200 and res["engineInstanceId"] == bad_id,
              f"/reload {status}: {res}")
        graded = known[20:20 + QUALITY_USERS]
        uf, itf = healed["user_factors"], healed["item_factors"]
        t_q = time.perf_counter()
        for u in graded:
            _known_answer(srv, conn, u)
        names = list(healed["items"])
        top1 = [names[int(np.argmax(itf @ uf[healed["users"][u]]))]
                for u in graded]
        le.insert_batch([Event.from_json({
            "event": "view", "entityType": "user", "entityId": u,
            "targetEntityType": "item", "targetEntityId": it})
            for u, it in zip(graded, top1)], app.id)
        lc = _wait_status(srv, "the quality rollback",
                          lambda d: d["lifecycle"] if d["lifecycle"][
                              "rollbacks"].get("quality") else None)
        rollback_s = time.perf_counter() - t_q
        check(lc["instance"] == clean_id
              and lc["pinned"].get(bad_id) == "quality",
              f"quality rollback: {lc}")
        doc = srv.request("GET", "/status", conn=conn)[1]
        q, fold = doc["quality"], doc["foldin"]
        check(q["breaches"] >= 1 and q["live"]["ndcg"] < q["shadow"]["ndcg"],
              f"quality view {q}")
        check(fold["lastError"] is None and fold["tickErrors"] == 0
              and fold["publishes"] >= len(incs) + 2,
              f"fold-in view {fold}")
        conn.close()
        client = pump.finish()
        # the registry's families read the same counts as /status (once
        # the last answered queries' quality offers, which the server
        # takes after the answer is written, have landed)
        def families():
            doc = srv.request("GET", "/status")[1]
            text = _metrics_text(srv.port)
            q, fold = doc["quality"], doc["foldin"]
            want_f = {
                "pio_foldin_events_total": fold["events"],
                "pio_foldin_publishes_total": fold["publishes"],
                "pio_engine_quality_samples_total": q["sampled"],
                "pio_engine_quality_breaches_total": q["breaches"],
                "pio_engine_rollbacks_total{reason=quality}":
                    doc["lifecycle"]["rollbacks"]["quality"]}
            for reason, n in fold["rollbacks"].items():
                want_f[f"pio_foldin_rollbacks_total{{reason={reason}}}"] = n
            got_f = {name: _metric(text, name.split("{")[0], **(
                {"reason": name.split("=")[1][:-1]} if "{" in name else {}))
                for name in want_f}
            return got_f, want_f, text

        got, fams, text = _settled(families)
        check(got == fams and "pio_engine_quality_delta{" in text,
              f"/metrics {got} vs /status {fams}")
        out["metrics_vs_status"] = fams
        out["quality"] = {"bad_instance": bad_id,
                          "seconds_to_rollback": rollback_s,
                          "graded_users": len(graded), "view": q}
        out["foldin"] = fold
        out["client"] = client

        # 4. pio status
        url = f"http://127.0.0.1:{srv.port}"
        st, _ = _verb(["status", "--engine-url", url], env, cwd)
        lines = st.stdout.splitlines()
        cursor_line = [ln for ln in lines if "Online fold-in: app 'ml20m'"
                       in ln]
        check(cursor_line and "freshness lag" in cursor_line[0],
              f"pio status has no cursor row: {st.stdout[-2000:]}")
        for needle in ("fold-in: every 250ms", "quality: sampling 100.0%"):
            check(any(needle in ln for ln in lines),
                  f"status --engine-url lacks {needle!r}")
        out["pio_status"] = [ln for ln in lines
                             if "fold-in" in ln or "quality" in ln]

        # 5. SIGTERM
        srv.proc.send_signal(signal.SIGTERM)
        rc = srv.proc.wait(timeout=120)
        check(rc == 0, f"deploy exited {rc} after SIGTERM")
    store.close()
    out["launches"] = _counted(counts, "engine_server_online")
    emit("engine_server_online", instance=instance_id,
         users=len(want["users"]), items=len(want["items"]),
         knobs=ONLINE_ENV, **out)


# -- the serving fleet ------------------------------------------------------

#: the fleet's knobs in engine_server_fleet: the directive and status rows
#: every 250 ms, readiness probes every 200 ms, a 1 s post-swap watch (the
#: canary's window), a fold-in tick every 250 ms
FLEET_ENV = {"PIO_FLEET_SYNC_MS": "250", "PIO_FLEET_READY_MS": "200",
             "PIO_SWAP_WATCH_MS": "1000", "PIO_FOLDIN_MS": "250"}
#: clients of the SIGKILL flood, each query on a fresh connection
FLOOD_CLIENTS = 4


class _Fleet(_Served):
    """``pio deploy --replicas N`` (the front) in its own process, its output
    in a file; up once the front's own /healthz counts N ready replicas."""

    def __init__(self, replicas: int, extra: list, env: dict, cwd: str):
        self.replicas = replicas
        self.port = _free_port()
        self.log_path = os.path.join(cwd, f"fleet_front_{self.port}.log")
        self._log = open(self.log_path, "wb")
        self.t_start = time.perf_counter()
        self.proc = subprocess.Popen(
            CONSOLE + ["deploy", "--replicas", str(replicas), *extra,
                       "--ip", "127.0.0.1", "--port", str(self.port)],
            stdout=self._log, stderr=subprocess.STDOUT, env=env, cwd=cwd)

    def tail(self) -> str:
        with open(self.log_path, "rb") as fh:
            return fh.read()[-3000:].decode(errors="replace")

    def healthz(self) -> dict:
        return self.request("GET", "/healthz")[1]

    def view(self) -> dict:
        """The fleet view of whichever replica answers /status."""
        return self.request("GET", "/status")[1].get("fleet") or {}

    def __enter__(self):
        deadline = time.time() + 300
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"fleet front exited: {self.tail()}")
            try:
                doc = self.healthz()
                if doc.get("readyReplicas") == self.replicas and all(
                        b["alive"] for b in doc["backends"]):
                    self.up_seconds = time.perf_counter() - self.t_start
                    return self
            except (OSError, http.client.HTTPException, ValueError):
                pass
            check(time.time() < deadline,
                  f"the fleet never came up: {self.tail()}")
            time.sleep(0.25)

    def replicas_at(self) -> list:
        """One endpoint per live replica (queried directly, not spliced)."""
        return [_Endpoint(b["port"]) for b in self.healthz()["backends"]]

    def __exit__(self, *exc):
        if self.proc.poll() is None:   # a failed phase: drain what is left
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()


class _Endpoint(_Served):
    """One replica's own port."""

    def __init__(self, port: int):
        self.port = port


class _Busy:
    """The card's busy share over a window: nvidia-smi's utilization.gpu
    (the share of each 100 ms sample in which a kernel ran), sampled by one
    nvidia-smi process for the window."""

    def __enter__(self):
        self.samples: list = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            if line.strip().isdigit():
                self.samples.append(int(line.strip()))

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)

    def share(self):
        return (float(np.mean(self.samples)) / 100.0 if self.samples
                else None)


def _cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of a process (/proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat", encoding="utf-8") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _cuda_contexts(fleet: "_Fleet", pids: list) -> dict:
    """The processes nvidia-smi lists as holding a CUDA context, against
    the fleet's: the replicas and this script hold one each, the front
    none. (Where nvidia-smi lists every process as pid 1, a container's
    pid namespace, the count is the evidence.)"""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    apps = [int(x) for x in out.stdout.split() if x.strip().isdigit()]
    check(fleet.proc.pid not in apps and len(apps) <= len(pids) + 1,
          f"{len(apps)} CUDA contexts for {len(pids)} replicas and this "
          "script: the fleet front holds one")
    return {"contexts": len(apps), "replicas": len(pids),
            "pids_listed": apps, "front_pid": fleet.proc.pid,
            "replica_pids": pids}


def _fleet_load(fleet: _Fleet, users: list, served: dict) -> dict:
    """8 and 32 keep-alive clients through the front (each connection stays
    on one replica), every answer held to the host top-k of ``served``;
    the card's busy share and the front's CPU seconds beside each run."""
    out = {}
    for n in (8, 32):
        cpu0 = _cpu_seconds(fleet.proc.pid)
        with _Busy() as busy:
            run = _clients(fleet, users[:n * CLIENT_QUERIES], n, served)
        run.pop("answers")
        out[n] = {**run, "busy_share": busy.share(),
                  "busy_samples": len(busy.samples),
                  "front_cpu_seconds": _cpu_seconds(fleet.proc.pid) - cpu0}
    return out


def _fleet_holds(fleet: _Fleet, users: list, served: dict) -> int:
    """Every replica, queried on its own port, answers ``users`` with the
    host top-k of ``served``; the answers held."""
    held = 0
    for ep in fleet.replicas_at():
        conn = ep.connect()
        try:
            for u in users:
                status, res, _ = ep.request("POST", "/queries.json",
                                            {"user": u, "num": 10}, conn)
                check(status == 200, f"replica {ep.port}: {status} {res}")
                _hold_als_answer(served, u, res)
                held += 1
        finally:
            conn.close()
    return held


def _wait_fleet(fleet: _Fleet, what: str, pred, timeout: float = 120.0):
    """Poll the fleet view until ``pred(view)`` is truthy; (value, s)."""
    t0 = time.perf_counter()
    view: dict = {}
    while time.perf_counter() - t0 < timeout:
        try:
            view = fleet.view()
        except (OSError, http.client.HTTPException):
            view = {}
        got = pred(view)
        if got:
            return got, time.perf_counter() - t0
        time.sleep(0.05)
    raise AssertionError(f"{what} within {timeout:.0f} s: {view}")


def _all_on(instance: str, n: int):
    """A fleet-view predicate: steady on ``instance``, n peers serving it."""
    def pred(v):
        d = v.get("directive") or {}
        peers = v.get("peers") or []
        return (d.get("state") == "steady" and d.get("instance") == instance
                and len(peers) == n
                and all(p.get("instance") == instance for p in peers)
                and not v.get("divergence")) and v
    return pred


class _FleetPump(_Pump):
    """A keep-alive client through the front that first asks /status on its
    own connection which replica it landed on."""

    def run(self):
        conn = self.srv.connect()
        k = 0
        try:
            self.replica = self.srv.request(
                "GET", "/status", conn=conn)[1]["fleet"]["replica"]
            while not self.halt.is_set():
                user = self.users[k % len(self.users)]
                k += 1
                try:
                    status, _, ms = self.srv.request(
                        "POST", "/queries.json", {"user": user, "num": 10},
                        conn)
                except (OSError, http.client.HTTPException) as e:
                    self.errors.append(repr(e))
                    return
                self.log.append((time.perf_counter(), status, ms))
        finally:
            conn.close()


def _flood(fleet: _Fleet, users: list, halt: threading.Event) -> dict:
    """FLOOD_CLIENTS clients, a fresh connection per query, until ``halt``:
    HTTP statuses and connection errors."""
    codes: list = []
    errors: list = []

    def client(k):
        j = k
        while not halt.is_set():
            try:
                codes.append(fleet.request("POST", "/queries.json", {
                    "user": users[j % len(users)], "num": 10})[0])
            except (OSError, http.client.HTTPException) as e:
                errors.append(repr(e))
            j += FLOOD_CLIENTS

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(FLOOD_CLIENTS)]
    for t in threads:
        t.start()
    return {"codes": codes, "errors": errors, "threads": threads}


def _shifted(events: list, n_users: int, n_items: int, du: int,
             di: int) -> list:
    """New users and items of a FOLD_IN batch moved past ``du`` / ``di``
    (a second batch of the same shape whose users are all new)."""
    def move(x: str, n: int, d: int) -> str:
        return x[0] + str(int(x[1:]) + d) if int(x[1:]) >= n else x
    return [{**e, "entityId": move(e["entityId"], n_users, du),
             "targetEntityId": move(e["targetEntityId"], n_items, di)}
            for e in events]


def _exit_records(run_dir: str) -> dict:
    """Replica i → the exit records (kernel launches) its processes wrote
    into the supervisor's worker_<i>.log; a SIGKILLed process writes none."""
    out: dict = {}
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("worker_") and name.endswith(".log"):
            with open(os.path.join(run_dir, name), encoding="utf-8",
                      errors="replace") as fh:
                out[int(name[7:-4])] = [json.loads(ln) for ln in fh
                                        if ln.startswith('{"kernel_launches"')]
    return out


def _sigterm_fleet(fleet: _Fleet, pids: list) -> dict:
    """SIGTERM the front: every replica drains and exits, the front exits
    0 and no replica pid survives."""
    t0 = time.perf_counter()
    fleet.proc.send_signal(signal.SIGTERM)
    rc = fleet.proc.wait(timeout=120)
    seconds = time.perf_counter() - t0
    survivors = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            survivors.append(pid)
        except OSError:
            pass
    check(rc == 0, f"fleet front exited {rc}: {fleet.tail()}")
    check(not survivors, f"replica pid(s) {survivors} survived the front")
    return {"exit_code": rc, "sigterm_to_exit_seconds": seconds,
            "replica_pids": pids, "survivors": survivors}


def phase_engine_server_fleet(env: dict, cwd: str, instance_id: str,
                              stored: dict, want: dict,
                              single: dict) -> None:
    """pio deploy --replicas on the ML-20M-shaped store (no retrain): each
    replica a `pio deploy --replica-worker` process with its own CUDA
    context on the one card, the front a process that never touches it.

    The served base is a COMPLETED copy of the trained instance committed
    here (the online phase left newer instances in the store). Fleet A,
    `--replicas 2 --online-foldin`: (1) 8 and 32 keep-alive clients, every
    answer held to the host top-k, beside ``single`` (this run's
    engine_server_load unbatched rows), the card's busy share and the
    front's CPU seconds; (2) a valid instance (user factors × 2) staged on
    the canary, promoted, both replicas serving it, then a NaN instance
    refused by the canary's gate with the fleet on last-good; (3) POST
    /rollback on one replica rolls the whole fleet back; (4) replica 1
    SIGKILLed under a fresh-connection flood and relaunched; (5) two
    FOLD_IN-shaped batches appended, with 1 and then 8 keep-alive clients
    querying: the freshness until both replicas serve every sampled new
    user, replica 0 alone producing (2 warp launches per increment,
    replica 1 none), the clients' p50 / p99 while each lands; (6) pio
    undeploy refused (409) and SIGTERM: every replica drains, no pid
    survives. Fleet B, `--replicas 4`: the load of (1), and which pids
    hold a CUDA context."""
    n_users, n_items, _ = ML20M
    new_users, new_items, n_events = FOLD_IN
    store = _storage_of(env)
    app = store.get_meta_data_apps().get_by_name("ml20m")
    le = store.get_l_events()
    log_path = os.path.join(le.events_dir, f"events_{app.id}.jsonl")
    rng = np.random.default_rng(27)
    rng.integers(0, len(want["users"]), BATCHPREDICT_QUERIES)
    load_users = [want["users"][int(k)] for k in
                  rng.integers(0, len(want["users"]), 32 * CLIENT_QUERIES)]
    known = load_users[:200]
    fenv = env | FLEET_ENV
    reset_launches()
    out: dict = {"knobs": FLEET_ENV, "single_process": single}
    base_id = _commit_instance(store, instance_id, stored)
    with _Fleet(2, ["--online-foldin"], fenv, cwd) as fleet:
        _, adopt_s = _wait_fleet(fleet, "bootstrap adoption",
                                 _all_on(base_id, 2))
        pids = [b["pid"] for b in fleet.healthz()["backends"]]
        out["cuda_contexts_2"] = _cuda_contexts(fleet, pids)
        out["fleet_2"] = {"up_seconds": fleet.up_seconds,
                          "adopt_seconds": adopt_s,
                          **_fleet_load(fleet, load_users, stored)}
        check(_increments(store, base_id) == [],
              "an increment was staged before any batch was appended")

        # 2. the staged canary, then a poisoned instance
        pumps = [_FleetPump(fleet, known) for _ in range(2)]
        for p in pumps:
            p.start()
        t0 = time.perf_counter()
        doubled = dict(stored, user_factors=stored["user_factors"] * 2)
        good_id = _commit_instance(store, base_id, doubled)
        commit_s = time.perf_counter() - t0
        canary, _ = _wait_fleet(fleet, "the canary staged", lambda v: (
            v if (v.get("directive") or {}).get("target") == good_id
            else None))
        staged = canary["directive"]
        _wait_fleet(fleet, "the canary promoted", _all_on(good_id, 2))
        t_promoted = time.perf_counter()
        held = _fleet_holds(fleet, known[:10], doubled)
        nan_id = _commit_instance(
            store, base_id, dict(stored, user_factors=np.full_like(
                stored["user_factors"], np.nan)))
        refused, refuse_s = _wait_fleet(fleet, "the NaN canary refused",
                                        lambda v: v if (
            (v.get("directive") or {}).get("pinned", {}).get(nan_id)
            == "validate" and _all_on(good_id, 2)(v)) else None)
        held += _fleet_holds(fleet, known[10:20], doubled)
        out["canary"] = {
            "good_instance": good_id, "commit_seconds": commit_s,
            "canary_replica": staged["canaryReplica"],
            "commit_to_promoted_seconds": t_promoted - t0,
            "nan_instance": nan_id, "nan_refused_seconds": refuse_s,
            "pinned": refused["directive"]["pinned"], "answers_held": held}

        # 3. a fleet-wide rollback through one replica
        t0 = time.perf_counter()
        status, res, _ = fleet.request("POST", "/rollback")
        check(status == 200 and res.get("fleet") is True
              and res["engineInstanceId"] == base_id,
              f"/rollback {status}: {res}")
        back, converge_s = _wait_fleet(fleet, "the fleet rolled back",
                                       _all_on(base_id, 2))
        out["rollback"] = {
            "seconds_to_all_replicas": time.perf_counter() - t0,
            "poll_seconds": converge_s,
            "fleet_fresh_s": model_artifact.fleet_fresh_s(
                float(FLEET_ENV["PIO_FLEET_SYNC_MS"])),
            "pinned": back["directive"]["pinned"],
            "answers_held": _fleet_holds(fleet, known[20:30], stored)}
        out["client_through_canary"] = [
            {**p.finish(), "replica": p.replica} for p in pumps]

        # 4. replica 1 SIGKILLed mid-flood, relaunched by the supervisor
        halt = threading.Event()
        flood = _flood(fleet, known, halt)
        time.sleep(1.0)
        victim = next(b for b in fleet.healthz()["backends"]
                      if b["replica"] == 1)
        t0 = time.perf_counter()
        os.kill(victim["pid"], signal.SIGKILL)
        while True:
            h = fleet.healthz()
            if (h["readyReplicas"] == 2
                    and all(b["alive"] for b in h["backends"])
                    and any(b["restarts"] >= 1 for b in h["backends"])):
                break
            check(time.perf_counter() - t0 < 180, f"no relaunch: {h}")
            time.sleep(0.1)
        relaunch_s = time.perf_counter() - t0
        time.sleep(1.0)
        halt.set()
        for t in flood["threads"]:
            t.join(60)
        codes = flood["codes"]
        check(set(codes) == {200}, f"flood statuses {sorted(set(codes))}")
        check(len(flood["errors"]) <= 12,
              f"flood connection errors {flood['errors'][:3]}")
        _, rejoin_s = _wait_fleet(fleet, "the relaunched replica rejoined",
                                  _all_on(base_id, 2))
        out["sigkill"] = {"victim_pid": victim["pid"],
                          "relaunch_seconds": relaunch_s,
                          "rejoin_poll_seconds": rejoin_s,
                          "flood_answered_200": len(codes),
                          "flood_connection_errors": len(flood["errors"]),
                          "restarts": {b["replica"]: b["restarts"] for b in
                                       fleet.healthz()["backends"]}}

        # 5. online fold-in: replica 0 produces, the canary stages
        first = _prefixed(fold_in_events(
            n_users, n_items, new_users, new_items,
            n_events - 5 * new_users - 4 * new_items, seed=8))
        second = _shifted(first, n_users, n_items, 3 * new_users,
                          2 * new_items)
        served, landed = stored, []
        for clients, batch, shift in ((1, first, 0),
                                      (8, second, 3 * new_users)):
            cold = [f"u{n_users + shift + j}"
                    for j in range(0, new_users, new_users // COLD_USERS)]
            pumps = [_FleetPump(fleet, known) for _ in range(clients)]
            for p in pumps:
                p.start()
            time.sleep(1.0)   # the clients' baseline
            t_in = time.perf_counter()
            le.insert_batch([Event.from_json(e) for e in batch], app.id)
            size1 = os.path.getsize(log_path)
            eps = fleet.replicas_at()
            conns = [ep.connect() for ep in eps]
            pending = [(ep, c, u) for ep, c in zip(eps, conns) for u in cold]
            while pending:
                check(time.perf_counter() - t_in < 180,
                      f"{len(pending)} (replica, new user) pairs unserved")
                pending = [(ep, c, u) for ep, c, u in pending
                           if _known_answer(ep, c, u) is None]
                if pending:
                    time.sleep(0.05)
            t_known = time.perf_counter()
            while True:
                incs = _increments(store, base_id)
                if incs and incs[-1][1]["lsn"] == size1:
                    break
                check(time.perf_counter() - t_in < 180,
                      "no increment reaches the batch's end")
                time.sleep(0.05)
            last = incs[-1][0]
            _wait_fleet(fleet, "the increment promoted", _all_on(last, 2))
            t_published = time.perf_counter()
            served = _persisted(env, last)
            held = 0
            for ep, c in zip(eps, conns):
                for u in cold + known[:10]:
                    _hold_als_answer(served, u, _known_answer(ep, c, u))
                    held += 1
                c.close()
            landed.append({
                "clients": clients, "events": len(batch),
                "sampled_new_users": len(cold),
                "freshness_seconds": t_known - t_in,
                "published_seconds": t_published - t_in,
                "increments_so_far": len(incs), "answers_held": held,
                "client_replicas": [p.replica for p in pumps],
                "client_before": [p.window(t_in - 1.0, t_in)
                                  for p in pumps],
                "client_while_landing": [p.window(t_in, t_published)
                                         for p in pumps],
                "clients_total": [p.finish() for p in pumps]})
        out["foldin"] = landed
        increments = len(_increments(store, base_id))

        # 6. pio undeploy is refused by a replica; SIGTERM stops the fleet
        und = subprocess.run(
            CONSOLE + ["undeploy", "--ip", "127.0.0.1", "--port",
                       str(fleet.port)], capture_output=True, text=True,
            env=env, cwd=cwd, timeout=300)
        check(und.returncode == 1 and "shrink the fleet" in und.stderr,
              f"pio undeploy against the fleet: {und.returncode} "
              f"{und.stderr[-500:]}")
        run_dir = fleet.healthz()["runDir"]
        pids_now = [b["pid"] for b in fleet.healthz()["backends"]]
        out["undeploy"] = {"exit_code": und.returncode, "refused": True}
        out["shutdown"] = _sigterm_fleet(fleet, pids_now)
    records = _exit_records(run_dir)
    r0 = records.get(0, [])
    r1 = records.get(1, [])
    check(len(r0) == 1 and r0[0]["kernel_launches"] == {
        "warp": 2 * increments, "wide": 0},
          f"replica 0's launches {r0} for {increments} increment(s)")
    check(r1 and all(r["kernel_launches"] == {"warp": 0, "wide": 0}
                     for r in r1), f"replica 1's launches {r1}")
    record("engine_server_fleet", {
        "warp": sum(r["kernel_launches"]["warp"] for r in r0 + r1),
        "wide": sum(r["kernel_launches"]["wide"] for r in r0 + r1)})
    out["launches"] = {"increments": increments,
                       "replica_0": [r["kernel_launches"] for r in r0],
                       "replica_1": [r["kernel_launches"] for r in r1],
                       "replica_1_processes": 2,
                       "counted": "replicas that exited cleanly; the "
                                  "SIGKILLed replica 1 wrote none"}

    # fleet B: 4 replicas on the fleet's last instance
    with _Fleet(4, [], fenv, cwd) as fleet:
        pids = [b["pid"] for b in fleet.healthz()["backends"]]
        view, _ = _wait_fleet(fleet, "four replicas on one instance",
                              lambda v: v if len(v.get("peers") or []) == 4
                              and not v.get("divergence") else None)
        on = view["directive"]["instance"]
        served = _persisted(env, on)
        # each replica's /metrics carries its own divergence flag
        div = {}
        for ep in fleet.replicas_at():
            flag = ep.request("GET", "/status")[1]["fleet"]["divergence"]
            text = _metrics_text(ep.port)
            check("# TYPE pio_fleet_divergence gauge" in text
                  and _metric(text, "pio_fleet_divergence") == int(flag),
                  f"replica {ep.port}: pio_fleet_divergence vs {flag}")
            div[ep.port] = int(flag)
        out["fleet_divergence_metric"] = div
        out["cuda_contexts_4"] = _cuda_contexts(fleet, pids)
        out["fleet_4"] = {"up_seconds": fleet.up_seconds, "instance": on,
                          **_fleet_load(fleet, load_users, served)}
        out["shutdown_4"] = _sigterm_fleet(fleet, pids)
    store.close()
    emit("engine_server_fleet", instance=instance_id, base=base_id,
         users=len(want["users"]), items=len(want["items"]), **out)


def _tenant_route(a: int, name: str) -> tuple:
    """Tenant ``a``'s routing key, one of the four in turn: (path,
    headers)."""
    return [("/queries.json", {"X-Pio-App": name}),
            (f"/queries.json?app={name}", {}),
            (f"/queries.json?accessKey=KEY-{name}", {}),
            ("/queries.json", {"X-Pio-Access-Key": f"KEY-{name}"})][a % 4]


def _tenant_client(srv: _Served, route: tuple, users: list, stored: dict,
                   codes: list, lock: threading.Lock) -> None:
    """One keep-alive client of one tenant: every 200 answer held to that
    app's host top-k; its statuses (or its error) appended to ``codes``."""
    path, headers = route
    conn = srv.connect()
    try:
        for user in users:
            status, res, _, _ = srv.request_h(
                "POST", path, {"user": user, "num": 10}, headers, conn)
            with lock:
                codes.append(status)
            if status == 200:
                _hold_als_answer(stored, user, res)
    except BaseException as e:  # noqa: BLE001 - the caller checks codes
        with lock:
            codes.append(repr(e))
    finally:
        conn.close()


def _tenant_rows(srv: _Served) -> dict:
    return {r["app"]: r for r in
            srv.request("GET", "/status")[1]["tenants"]["tenants"]}


def _tenant_chain(srv: _Served, store: Storage, poison_file: str,
                  tenant: str, stored: dict, users: dict, iids: dict,
                  app_ids: dict) -> dict:
    """Step 3b of :func:`phase_engine_server_tenants`: ``tenant``'s
    fold-in runner commits increment B, poisoned by the counted deploy
    (:data:`_COUNTED_DEPLOY`), and, inside B's watch window, increment C
    folded through B. B never answered a query, so the tenant's chain keeps
    its last observed instance A as the previous deployment; C's failures,
    counted back with B's, trip the tenant's watch, which restores A and
    pins both links. Every other tenant keeps its instance."""
    path, headers = _tenant_route(0, tenant)
    # users no client asked for: no cached answer hides the model
    fresh = [u for u in stored[tenant]["users"]
             if stored[tenant]["users"][u] != 0
             and u not in users[tenant]][:3]
    status, res, _, _ = srv.request_h("POST", path,
                                      {"user": fresh[0], "num": 10}, headers)
    check(status == 200, f"chain tenant {tenant}: {status} {res}")
    _hold_als_answer(stored[tenant], fresh[0], res)
    rows = _tenant_rows(srv)
    a = rows[tenant]["instance"]
    check(a == iids[tenant] and rows[tenant]["resident"],
          f"chain tenant row {rows[tenant]}")
    before = {n: (r["instance"], dict(r["pinned"])) for n, r in rows.items()}
    items = list(stored[tenant]["items"])
    le = store.get_l_events()

    def increment(batch: int, after: set) -> tuple:
        fold = [{"event": "rate", "entityType": "user",
                 "entityId": f"chain{batch}-{j}", "targetEntityType": "item",
                 "targetEntityId": items[(7 * j + k) % len(items)],
                 "properties": {"rating": float(1 + (j + k) % 5)}}
                for j in range(4) for k in range(3)]
        le.insert_batch([Event.from_json(e) for e in fold], app_ids[tenant])
        return _wait_status(srv, f"{tenant}'s increment {batch} published",
                            lambda d: (lambda r: r if r["instance"] not in
                                       after else None)(
                                {x["app"]: x for x in
                                 d["tenants"]["tenants"]}[tenant]), 60)

    with open(poison_file, "w", encoding="utf-8") as fh:
        fh.write(tenant)
    t0 = time.perf_counter()
    row_b = increment(1, {a})
    b = row_b["instance"]
    row_c = increment(2, {a, b})
    c = row_c["instance"]
    landed_s = time.perf_counter() - t0
    check(not os.path.exists(poison_file), "the poison was not consumed")
    check(row_b["previous"] == a and row_c["previous"] == a,
          f"the chain's previous deployment: B {row_b}, C {row_c}")
    first = srv.request_h("POST", path, {"user": fresh[1], "num": 10},
                          headers)
    second = srv.request_h("POST", path, {"user": fresh[2], "num": 10},
                           headers)
    check(first[0] == 500 and second[0] == 200,
          f"poisoned chain: {first[:2]}, {second[:2]}")
    _hold_als_answer(stored[tenant], fresh[2], second[1])
    rows = _tenant_rows(srv)
    row = rows[tenant]
    check(row["instance"] == a and row["previous"] is None
          and row["pinned"] == {b: "error-rate", c: "error-rate"}
          and row["rollbacks"] == {"error-rate": 1},
          f"chain tenant row after the rollback {row}")
    for n, r in rows.items():
        if n != tenant:
            check(r["instance"] in (before[n][0], None)
                  and r["pinned"] == before[n][1],
                  f"tenant {n} changed with the chain: {r}")
    inc = model_artifact.read_model(store, c)
    check(inc is not None, f"increment {c} has no artifact")
    marker = json.loads(store.get_meta_data_engine_instances().get(c)
                        .runtime_conf["foldin"])
    check(marker["of"] == b and b in marker.get("bases", [b]),
          f"C was not folded through B: {marker}")
    return {"tenant": tenant, "last_observed": a, "links": [b, c],
            "c_marker_of": marker["of"], "two_links_seconds": landed_s,
            "first_status": first[0], "second_status": second[0],
            "row": row}


def phase_engine_server_tenants(workdir: str) -> None:
    """pio deploy --multitenant --online-foldin on TENANTS apps, each an
    ML-100K-shaped log (bench.py SCALES["ml100k"], synth_ratings seed 40 +
    app) trained in process on the card at rank 10 × 5 iterations, with
    PIO_TENANT_MAX_RESIDENT 4 and a per-tenant budget of 2:

    1. one keep-alive client per app, each routing by one of the four keys
       in turn (X-Pio-App, app, accessKey, X-Pio-Access-Key): every answer
       equals its own app's host top-k, evictions happen, no query fails;
    2. 16 clients on one hot app: it sheds 503 past its budget while two
       other apps' clients get 200 only;
    3. a poisoned instance of an evicted tenant (its user factors cut to
       one row: the golden query passes, every other user fails) rolls
       back alone on the tenant's watch; every other tenant keeps its
       instance; then a poisoned fold-in chain of another tenant: two
       increments land inside one watch window, the first poisoned (cut
       the same way, in the deploy process) and the second folded through
       it; the tenant rolls back to its last observed instance with both
       links pinned, every other tenant keeps its instance, and the two
       increments' warp launches are recorded as
       ``engine_server_tenants_chain``;
    4. one tenant's fold-in increment (2 warp launches) is published and
       evicts only that tenant's touched users from the result cache."""
    from incubator_predictionio_torch.data.storage import AccessKey, App
    from incubator_predictionio_torch.workflow.core_workflow import run_train

    n_users, n_items, nnz = ML100K
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio_tenants")
    poison_file = os.path.join(cwd, "poison_foldin")
    env = _jsonl_env(base) | {
        "PIO_TENANT_MAX_RESIDENT": str(TENANT_RESIDENT),
        "PIO_TENANT_MAX_PENDING": str(TENANT_PENDING),
        "PIO_FOLDIN_MS": "250", "PIO_POISON_FOLDIN_FILE": poison_file}
    os.makedirs(base, exist_ok=True)
    names = [f"tenant{a}" for a in range(TENANTS)]
    store = _storage_of(env)
    for name in names:
        app_id = store.get_meta_data_apps().insert(App(0, name))
        store.get_meta_data_access_keys().insert(
            AccessKey(f"KEY-{name}", app_id))
    events_dir = store.get_l_events().events_dir
    app_ids = {n: store.get_meta_data_apps().get_by_name(n).id for n in names}
    store.close()
    t0 = time.perf_counter()
    for a, name in enumerate(names):
        u, i, r = synth_ratings(n_users, n_items, nnz, seed=40 + a)
        _write_log(os.path.join(events_dir, f"events_{app_ids[name]}.jsonl"),
                   u, i, r, T0_MS + np.arange(nnz))
    write_s = time.perf_counter() - t0
    store = _storage_of(env)
    reset_launches()
    t0 = time.perf_counter()
    iids, stored = {}, {}
    for name in names:
        ej = {"id": "default", "engineFactory": FACTORY,
              "datasource": {"params": {"appName": name}},
              "algorithms": [{"name": "als", "params": {
                  "rank": TENANT_RANK, "numIterations": TENANT_ITERS,
                  "lambda": 0.1}}]}
        iids[name] = run_train(
            RecommendationEngine()(), EngineParams.from_json(ej),
            WorkflowContext(app_name=name, storage=store, device="cuda"),
            engine_factory_name=FACTORY)
        stored[name] = _persisted(env, iids[name])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = launches()
    check(trained["warp"] > 0 and trained["wide"] == 0,
          f"the tenants' trains launched {trained}")
    default = names[-1]   # the newest instance: the process's default
    with open(os.path.join(cwd, "engine.json"), "w", encoding="utf-8") as fh:
        json.dump(ej, fh)
    counts = os.path.join(cwd, "tenant_counts.json")
    out: dict = {"log_write_seconds": write_s,
                 "train_seconds_in_process": train_s,
                 "train_launches": trained}
    rng = np.random.default_rng(33)
    lock = threading.Lock()
    with _counted_serve(["deploy", "--multitenant", "--online-foldin",
                         "--query-cache-size", "10000"], env, cwd,
                        counts) as srv:
        check(srv.info["engineInstanceId"] == iids[default],
              f"deployed {srv.info}")

        # 1. one client per app, four routing keys
        users = {n: [list(stored[n]["users"])[int(k)] for k in rng.integers(
            0, len(stored[n]["users"]), TENANT_QUERIES)] for n in names}
        codes: list = []
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_tenant_client, args=(
            srv, _tenant_route(a, n), users[n], stored[n], codes, lock))
            for a, n in enumerate(names)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        check(codes == [200] * len(codes) and len(codes) == len(names)
              * TENANT_QUERIES, f"tenant clients: {sorted(set(codes))}")
        t = srv.request("GET", "/status")[1]["tenants"]
        check(t["evictions"] > 0 and t["resident"] <= TENANT_RESIDENT,
              f"tenants {t}")
        # one query of an evicted tenant (a cold load inside) and one of a
        # resident tenant, each for a user no cache holds
        rows = _tenant_rows(srv)
        timed = {}
        for label, want_resident in (("cold", False), ("warm", True)):
            n = next(x for x in names[:-1]
                     if rows[x]["resident"] == want_resident)
            user = [u for u in stored[n]["users"] if u not in users[n]][-1]
            path, headers = _tenant_route(0, n)
            status, res, ms, _ = srv.request_h("POST", path,
                                               {"user": user, "num": 10},
                                               headers)
            check(status == 200, f"{label} tenant query {status}: {res}")
            _hold_als_answer(stored[n], user, res)
            timed[label + "_query_ms"] = ms
        out["routing"] = {"queries": len(codes), "wall_seconds": wall,
                          "evictions": t["evictions"],
                          "cold_loads": t["coldLoads"],
                          "loads": t["loads"], "resident": t["resident"],
                          **timed}

        # 2. a hot app sheds past its budget, the others serve
        hot, calm = names[1], names[2:4]
        hot_codes: list = []
        calm_codes: list = []
        hot_users = list(stored[hot]["users"])
        for _ in range(5):   # rounds until the budget is exceeded
            threads = [threading.Thread(target=_tenant_client, args=(
                srv, _tenant_route(0, hot), [hot_users[int(k)] for k in
                                             rng.integers(0, len(hot_users),
                                                          TENANT_QUERIES)],
                stored[hot], hot_codes, lock)) for _ in range(16)]
            threads += [threading.Thread(target=_tenant_client, args=(
                srv, _tenant_route(0, n), users[n], stored[n], calm_codes,
                lock)) for n in calm]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            if 503 in hot_codes:
                break
        shed = hot_codes.count(503)
        check(shed > 0 and set(hot_codes) <= {200, 503},
              f"hot tenant: {sorted(set(hot_codes))}, {shed} shed")
        check(calm_codes == [200] * len(calm_codes),
              f"calm tenants: {sorted(set(calm_codes))}")
        row = _tenant_rows(srv)[hot]
        check(row["shed"] == shed, f"hot tenant row {row}")
        out["shed"] = {"hot_queries": len(hot_codes), "hot_503": shed,
                       "calm_queries": len(calm_codes)}

        # 3. a poisoned tenant rolls back alone
        rows = _tenant_rows(srv)
        victim = next(n for n in names[1:-1]
                      if not rows[n]["resident"] and n not in (hot, *calm))
        before = {n: r["instance"] for n, r in rows.items()}
        poison = dict(stored[victim],
                      user_factors=stored[victim]["user_factors"][:1])
        poison_id = _commit_instance(store, iids[victim], poison)
        path, headers = _tenant_route(0, victim)
        # users not queried before: a cached answer would not reach the model
        vusers = [u for u in stored[victim]["users"]
                  if stored[victim]["users"][u] != 0
                  and u not in users[victim]][:2]
        first = srv.request_h("POST", path, {"user": vusers[0], "num": 10},
                              headers)
        second = srv.request_h("POST", path, {"user": vusers[1], "num": 10},
                               headers)
        check(first[0] == 500 and second[0] == 200,
              f"poisoned tenant: {first[:2]}, {second[:2]}")
        _hold_als_answer(stored[victim], vusers[1], second[1])
        rows = _tenant_rows(srv)
        check(rows[victim]["pinned"] == {poison_id: "error-rate"}
              and rows[victim]["rollbacks"] == {"error-rate": 1}
              and rows[victim]["instance"] == iids[victim],
              f"victim row {rows[victim]}")
        for n, r in rows.items():
            if n != victim:
                check(not r["pinned"] and not r["rollbacks"]
                      and r["instance"] in (before.get(n), None),
                      f"tenant {n} changed with the victim: {r}")
        out["poison"] = {"tenant": victim, "instance": poison_id,
                         "row": rows[victim]}

        # 3b. a poisoned fold-in chain of one tenant
        chain = _tenant_chain(srv, store, poison_file, next(
            n for n in names[4:-1] if n != victim), stored, users, iids,
            app_ids)
        out["chain"] = chain

        # 4. one tenant's increment evicts only its own cached results
        t1, t2 = calm
        for _ in range(2):
            for n in (t1, t2):
                _tenant_client(srv, _tenant_route(0, n), users[n][:20],
                               stored[n], codes, lock)
        cache0 = srv.request("GET", "/status")[1]["queryCache"]
        touched = users[t1][:10]
        new = [f"new{j}" for j in range(5)]
        items = list(stored[t1]["items"])
        fold = [{"event": "rate", "entityType": "user", "entityId": u,
                 "targetEntityType": "item",
                 "targetEntityId": items[(11 * j + k) % len(items)],
                 "properties": {"rating": float(1 + (j + k) % 5)}}
                for j, u in enumerate(touched + new) for k in range(3)]
        le = store.get_l_events()
        le.insert_batch([Event.from_json(e) for e in fold], app_ids[t1])
        row = _wait_status(srv, f"{t1}'s increment published",
                           lambda d: (lambda r: r if r["foldinPublishes"]
                                      and r["instance"] != iids[t1]
                                      else None)(
                               {x["app"]: x for x in
                                d["tenants"]["tenants"]}[t1]), 60)
        inc = _persisted(env, row["instance"])
        cache1 = srv.request("GET", "/status")[1]["queryCache"]
        _tenant_client(srv, _tenant_route(0, t2), users[t2][:20], stored[t2],
                       codes, lock)
        cache2 = srv.request("GET", "/status")[1]["queryCache"]
        _tenant_client(srv, _tenant_route(0, t1), touched + new, inc, codes,
                       lock)
        cache3 = srv.request("GET", "/status")[1]["queryCache"]
        t2_distinct = len(set(users[t2][:20]))
        check(cache2["hits"] - cache1["hits"] == 20
              and cache2["misses"] == cache1["misses"],
              f"{t2}'s cache entries did not survive: {cache1} → {cache2}")
        check(cache1["invalidatedEntries"] - cache0["invalidatedEntries"]
              == len(set(touched)),
              f"{t1}'s increment invalidated {cache0} → {cache1}")
        check(cache3["misses"] - cache2["misses"] == len(set(touched + new)),
              f"{t1}'s touched users were not recomputed: {cache3}")
        rows = _tenant_rows(srv)
        check(rows[t2]["foldinPublishes"] == 0
              and rows[t2]["instance"] == iids[t2], f"{t2} moved: {rows[t2]}")
        out["foldin"] = {"tenant": t1, "increment": row["instance"],
                         "events": len(fold), "row": row,
                         "other_distinct_users": t2_distinct,
                         "cache_before": cache0, "cache_after": cache3}
        out["tenants"] = srv.request("GET", "/status")[1]["tenants"]
        # the registry's pio_tenant_* families read /status's counts
        def families():
            t = srv.request("GET", "/status")[1]["tenants"]
            text = _metrics_text(srv.port)
            want_m = {"pio_tenant_evictions_total": t["evictions"],
                      "pio_tenant_loads_total": t["loads"],
                      "pio_tenant_resident": t["resident"]}
            got_m = {k: _metric(text, k) for k in want_m}
            for r in t["tenants"]:
                for fam, n in (("pio_tenant_queries_total", r["queries"]),
                               ("pio_tenant_shed_total", r["shed"]),
                               ("pio_tenant_rollbacks_total",
                                sum(r["rollbacks"].values()))):
                    want_m[f"{fam}{{app={r['app']}}}"] = n
                    got_m[f"{fam}{{app={r['app']}}}"] = _metric(
                        text, fam, app=r["app"])
            return got_m, want_m, text

        got_m, want_m, _ = _settled(families)
        check(got_m == want_m, f"/metrics {got_m} vs /status {want_m}")
        out["metrics_vs_status"] = want_m
        srv.proc.send_signal(signal.SIGTERM)
        rc = srv.proc.wait(timeout=120)
        check(rc == 0, f"deploy exited {rc} after SIGTERM")
    store.close()
    out["launches"] = _counted(
        counts, "engine_server_tenants", trained["warp"],
        split={"engine_server_tenants_chain": chain["links"]})
    check(all(c["poisoned"] for c in
              out["launches"]["engine_server_tenants_chain"]["folds"]),
          f"the chain's increments were not both poisoned: "
          f"{out['launches']['engine_server_tenants_chain']}")
    check(out["launches"]["increments"] >= 1,
          "no tenant fold-in increment was committed")
    shutil.rmtree(cwd)
    emit("engine_server_tenants", apps=TENANTS, shape=list(ML100K),
         rank=TENANT_RANK, iterations=TENANT_ITERS,
         max_resident=TENANT_RESIDENT, max_pending=TENANT_PENDING, **out)


# -- the E-Commerce template on the JSONL log ------------------------------

#: bench_templates.py config 6 (bench_ecommerce): users, items, view/buy
#: events, drawn with seed 6; rank 32 × 10 iterations
ECOMMERCE = (100_000, 20_000, 5_000_000)
#: the first events of config 6 the phase writes: cut from 5,000,000 for
#: the script's time, to 2,500,000, then (with the gang phases) 1,250,000,
#: then (with the slab-gang phases) 625,000, then (with the linear gang and
#: stream phases) 312,500: the query users are drawn from the log's
ECOMMERCE_LOG_EVENTS = 312_500
ECOMMERCE_CATEGORIES = 20
ECOMMERCE_BUY_SHARE = 0.1
#: queries before and after the constraint/unavailableItems $set
ECOMMERCE_QUERIES = (60, 12)
ECOMMERCE_ID_SEED = 6
ECOMMERCE_ENGINE = os.path.join(ROOT, "templates", "ecommerce", "engine.json")
#: ``pio deploy`` with parts of a template's predict timed per query: the
#: JSON in $PIO_QUERY_SPLIT_SPEC names the template module, its algorithm
#: class and, per record key, the module attribute to time (a function, or
#: a method or static method of a class in it); the records go to
#: $PIO_QUERY_SPLIT_OUT at exit
_TIMED_DEPLOY = r"""
import atexit, importlib, inspect, json, os, sys, time
from incubator_predictionio_torch.tools import console

spec = json.loads(os.environ["PIO_QUERY_SPLIT_SPEC"])
module = importlib.import_module(spec["module"])
records = []

def timed(fn, key):
    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            if records:
                records[-1][key] += time.perf_counter() - t0
                records[-1][key + "_calls"] += 1
    return run

for key, dotted in spec["timed"].items():
    # "Owner.attr" in the template's module, or "pkg.module:Owner.attr"
    where, _, dotted = dotted.rpartition(":")
    *path, name = dotted.split(".")
    owner = importlib.import_module(where) if where else module
    for part in path:
        owner = getattr(owner, part)
    fn = timed(getattr(owner, name), key)
    static = isinstance(inspect.getattr_static(owner, name), staticmethod)
    setattr(owner, name, staticmethod(fn) if static else fn)

algorithm = getattr(module, spec["algorithm"])
real_predict = algorithm.predict

def predict(self, model, query):
    records.append({k: 0 for key in spec["timed"]
                    for k in (key, key + "_calls")})
    t0 = time.perf_counter()
    try:
        return real_predict(self, model, query)
    finally:
        records[-1]["predict_s"] = time.perf_counter() - t0

algorithm.predict = predict

@atexit.register
def dump():
    with open(os.environ["PIO_QUERY_SPLIT_OUT"], "w") as fh:
        json.dump(records, fh)

sys.exit(console.main(sys.argv[1:]))
"""


def _timed_deploy(env: dict, cwd: str, out: str, module: str,
                  algorithm: str, timed: dict) -> _Served:
    """``pio deploy`` through _TIMED_DEPLOY, its records to ``out``."""
    spec = json.dumps({"module": "incubator_predictionio_torch.models."
                       + module, "algorithm": algorithm, "timed": timed})
    return _Served(["deploy"], env | {"PIO_QUERY_SPLIT_OUT": out,
                                      "PIO_QUERY_SPLIT_SPEC": spec}, cwd,
                   console=[sys.executable, "-c", _TIMED_DEPLOY])


def _ecommerce_events() -> tuple:
    """bench_ecommerce's draws (seed 6: users uniform, items skewed to low
    ids), a seed-derived 10 % of them buys and the rest views, distinct
    shuffled event times, one of 20 categories per item; the first
    ECOMMERCE_LOG_EVENTS of them."""
    n_users, n_items, nnz = ECOMMERCE
    rng = np.random.default_rng(6)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = np.minimum((n_items * rng.random(nnz) ** 2).astype(np.int32),
                   n_items - 1)
    buy = np.random.default_rng(61).random(nnz) < ECOMMERCE_BUY_SHARE
    times = T0_MS + np.random.default_rng(62).permutation(nnz)
    cats = np.random.default_rng(63).integers(0, ECOMMERCE_CATEGORIES, n_items)
    n = ECOMMERCE_LOG_EVENTS
    return u[:n], i[:n], buy[:n], times[:n], cats


def _ecommerce_lines(u, i, buy, times_ms, first: int) -> bytes:
    """view / buy events (``buy`` True) as JSONL lines, byte for byte what
    ``JSONLEvents.insert_batch`` writes for them."""
    iso = np.datetime_as_string(np.asarray(times_ms).astype("datetime64[ms]"),
                                unit="ms").tolist()
    names = ("view", "buy")
    return "".join([
        f'{{"eventId": "{ECOMMERCE_ID_SEED:08x}{first + k:024x}", "event": '
        f'"{names[b]}", "entityType": "user", "entityId": "u{a}", '
        f'"targetEntityType": "item", "targetEntityId": "i{c}", '
        f'"properties": {{}}, "eventTime": "{t}Z", '
        f'"creationTime": "{CREATED_ISO}"}}\n'
        for k, (a, c, b, t) in enumerate(zip(
            np.asarray(u).tolist(), np.asarray(i).tolist(),
            np.asarray(buy).tolist(), iso))
    ]).encode()


def _category_lines(cats, items) -> bytes:
    """One ``$set`` of ``categories`` per item of ``items``, before every
    view and buy."""
    times = T0_MS - len(cats) + np.asarray(items)
    iso = np.datetime_as_string(times.astype("datetime64[ms]"),
                                unit="ms").tolist()
    return "".join([
        f'{{"eventId": "{ECOMMERCE_ID_SEED + 1:08x}{j:024x}", "event": '
        f'"$set", "entityType": "item", "entityId": "i{j}", "properties": '
        f'{{"categories": ["c{cats[j]}"]}}, "eventTime": "{t}Z", '
        f'"creationTime": "{CREATED_ISO}"}}\n'
        for j, t in zip(np.asarray(items).tolist(), iso)]).encode()


def _hold_lines(sample: bytes, wdir: str) -> None:
    """``sample`` is byte for byte what insert_batch writes for its
    events."""
    scratch = tempfile.mkdtemp(dir=wdir)
    le = JSONLEvents(scratch)
    le.insert_batch([Event.from_json(json.loads(ln))
                     for ln in sample.splitlines()], 1)
    with open(os.path.join(scratch, "events_1.jsonl"), "rb") as fh:
        check(fh.read() == sample, "the log's lines differ from insert_batch's")
    le.close()
    shutil.rmtree(scratch)


def _dense(x: np.ndarray) -> tuple:
    """(dense labels, count): the ids of ``x`` relabelled 0..count-1 (the
    per-row counts, and so the layout's solve calls, are those of the
    read's first-seen labels)."""
    keys, labels = np.unique(x, return_inverse=True)
    return labels.astype(np.int32), len(keys)


def _latest_items(u, i, times, users, limit=200) -> dict:
    """user id → the items of its ``limit`` latest events (the serve-time
    seen-items read, from the generated arrays)."""
    out = {}
    for a in users:
        rows = np.flatnonzero(u == a)
        rows = rows[np.argsort(times[rows])[::-1][:limit]]
        out[int(a)] = set(i[rows].tolist())
    return out


def _ecommerce_queries(users, head: int) -> list:
    """The query mix, one per user: default, categories, whiteList,
    blackList, ``unseenOnly: false`` with and without categories."""
    n_items = ECOMMERCE[1]
    rng = np.random.default_rng(65)
    out = []
    for j, a in enumerate(users):
        q = {"user": f"u{a}", "num": 20 if j % 5 == 0 else 10}
        kind = j % 6
        if kind in (1, 5):
            q["categories"] = [f"c{int(c)}" for c in rng.choice(
                ECOMMERCE_CATEGORIES, 1 + j % 2, replace=False)]
        if kind == 2:
            q["whiteList"] = [f"i{int(x)}" for x in
                              rng.integers(0, n_items, 300)] + ["nope"]
        if kind == 3:
            q["blackList"] = [f"i{int(x)}" for x in
                              rng.integers(0, head, 100)]
        if kind in (4, 5):
            q["unseenOnly"] = False
        out.append(q)
    return out


def _ecommerce_check(stored: dict, cats, seen: dict):
    """A host numpy top-k for an E-Commerce answer: the float64 scores of
    the persisted factors; seen items (the user's 200 latest view/buy
    events, from the generated arrays), the unavailable items and the
    category / whiteList / blackList rules applied; order score
    descending, index ascending. The card's float32 scores may order two
    items whose scores tie to 1e-5 the other way; such swaps are counted,
    anything else fails."""
    users, items = stored["users"], stored["items"]
    uf = np.asarray(stored["user_factors"], np.float64)
    itf = np.asarray(stored["item_factors"], np.float64)
    item_of = np.empty(len(items), np.int64)
    item_of[list(items.values())] = [int(k[1:]) for k in items]
    counts = {"exact": 0, "tie_swaps": 0}

    def check_answer(q, res, unavailable):
        a = int(q["user"][1:])
        s = itf @ uf[users[q["user"]]]
        allowed = np.ones(len(s), bool)
        if q.get("categories"):
            allowed &= np.isin(cats[item_of],
                               [int(c[1:]) for c in q["categories"]])
        if q.get("whiteList"):
            allowed &= np.isin(item_of, [int(x[1:]) for x in q["whiteList"]
                                         if x[1:].isdigit()])
        excluded = set(unavailable) | {int(x[1:]) for x in
                                       q.get("blackList", [])}
        if q.get("unseenOnly", True):
            excluded |= seen[a]
        allowed &= ~np.isin(item_of, list(excluded))
        cand = np.flatnonzero(allowed)
        want = cand[np.lexsort((cand, -s[cand]))][:q["num"]]
        got = np.array([items[e["item"]] for e in res["itemScores"]], np.int64)
        check(len(got) == len(want), f"{len(got)} answers, want {len(want)}")
        check(bool(allowed[got].all()), f"an excluded item was returned: {q}")
        check(np.allclose([e["score"] for e in res["itemScores"]], s[got],
                          rtol=1e-4, atol=1e-4),
              "served scores differ from the host's")
        if np.array_equal(got, want):
            counts["exact"] += 1
        else:
            check(np.allclose(s[got], s[want], rtol=0, atol=1e-5),
                  f"answer {got.tolist()} != host top-k {want.tolist()}")
            counts["tie_swaps"] += 1

    return check_answer, counts


def _split(client_ms: list, records: list, parts: dict) -> dict:
    """Query latency split per query, percentiles over the queries: each
    timed part (name → its record key), and the rest (HTTP, JSON, the
    masks); with each part's calls and ms per call."""
    check(len(records) == len(client_ms),
          f"{len(records)} timed predicts for {len(client_ms)} queries")
    total = np.asarray(client_ms)
    out, rest = {"total": _percentiles(total)}, total.copy()
    for name, key in parts.items():
        ms = np.array([r[key] for r in records]) * 1e3
        calls = sum(r[key + "_calls"] for r in records)
        out[name] = _percentiles(ms)
        out[f"{name}_calls"] = calls
        out[f"ms_per_{name}_call"] = float(ms.sum() / max(calls, 1))
        rest = rest - ms
    out["rest"] = _percentiles(rest)
    return out


def phase_ecommerce_jsonl(workdir: str) -> None:
    """bench_templates.py config 6 through the E-Commerce template and the
    verbs, on a JSONL log: the first ECOMMERCE_LOG_EVENTS (312,500 of
    5,000,000) view/buy events (100,000 users × 20,000 items, 10 % buys)
    and one category $set per item written as
    the log itself (not compacted: the train and the serve-time reads
    parse it with the codec) → pio train (templates/ecommerce/engine.json,
    factory rewritten to the port, rank 32 and 10 iterations as the bench
    sets them; warp launches = implied) → pio eventserver + pio deploy →
    60 queries (default, categories, whiteList, blackList, unseenOnly
    false) → a $set of constraint/unavailableItems through the event
    server → 12 more queries; every answer held to a host top-k with the
    exclusions computed from the generated arrays. Query latency split
    into the LEventStore reads, the top-k and the rest."""
    _, n_items, _ = ECOMMERCE
    nnz = ECOMMERCE_LOG_EVENTS
    u, i, buy, times, cats = _ecommerce_events()
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio_ecom")
    env = _jsonl_env(base)
    out, _ = _verb(["app", "new", "ecom"], env, cwd)
    key = out.stdout.split("Access Key:")[1].split()[0]
    with open(ECOMMERCE_ENGINE, encoding="utf-8") as fh:
        engine_json = json.load(fh)
    engine_json["engineFactory"] = ("incubator_predictionio_torch.models."
                                    "ecommerce.ECommerceEngine")
    engine_json["datasource"]["params"]["appName"] = "ecom"
    algo = engine_json["algorithms"][0]["params"]
    algo.update(appName="ecom", rank=RANK, numIterations=10)
    with open(os.path.join(cwd, "engine.json"), "w", encoding="utf-8") as fh:
        json.dump(engine_json, fh)

    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    t0 = time.perf_counter()
    _write_log(log_path, u, i, buy, times, lines=_ecommerce_lines)
    with open(log_path, "ab") as fh:
        fh.write(_category_lines(cats, np.arange(n_items)))
    write_s = time.perf_counter() - t0
    rows = np.sort(np.random.default_rng(66).choice(nnz, 2_000, replace=False))
    _hold_lines(b"".join(_ecommerce_lines(u[k:k + 1], i[k:k + 1],
                                          buy[k:k + 1], times[k:k + 1], int(k))
                         for k in rows)
                + _category_lines(cats, np.arange(0, n_items, 97)), cwd)

    ud, nu = _dense(u)
    idn, ni = _dense(i)
    params = ALSParams(rank=RANK, num_iterations=10, reg=algo["lambda"],
                       implicit_prefs=True, alpha=1.0, seed=3)
    expected, calls_u, calls_i = implied_launches(ud, idn, nu, ni, params, 10)
    trained = _train_verb(env, cwd, "ecommerce_jsonl")
    got = trained["kernel_launches"]
    check(got["warp"] == expected and got["wide"] == 0,
          f"E-Commerce launches {got} != implied {expected} warp")
    tm = trained["timings"]
    check(tm["ratings_read"] == nnz, f"read {tm['ratings_read']} events")
    store = _storage_of(env)
    _, persisted = models_from_bytes(
        model_artifact.read_model(store, trained["engineInstanceId"]))
    store.close()
    stored = persisted[0]
    check(stored["user_factors"].shape == (nu, RANK)
          and stored["item_factors"].shape == (ni, RANK)
          and bool(np.isfinite(stored["user_factors"]).all()
                   and np.isfinite(stored["item_factors"]).all()),
          "bad E-Commerce factors")
    check(len(stored["item_categories"]) == n_items
          and stored["app_name"] == "ecom"
          and list(stored["seen_event_names"]) == ["view", "buy"],
          "the persisted E-Commerce model lacks its serve-time state")
    steady_ms = _steady_ms({"u": ud, "i": idn, "r": np.ones(nnz, np.float32),
                            "users": range(nu), "items": range(ni)}, params)

    n_before, n_after = ECOMMERCE_QUERIES
    # the query users have events in the log (not every one of the
    # 100,000 does in its first ECOMMERCE_LOG_EVENTS)
    qusers = np.random.default_rng(64).choice(np.unique(u),
                                              n_before + n_after,
                                              replace=False)
    seen = _latest_items(u, i, times, qusers)
    head = 2_000
    queries = _ecommerce_queries(qusers, head)
    check_answer, counts = _ecommerce_check(stored, cats, seen)
    split_out = os.path.join(cwd, "query_split.json")
    unavailable: list = []
    answered, client_ms = [], []
    t0 = time.perf_counter()
    # both servers start at once; the deploy's first store read parses
    # the whole log
    events = _Served(["eventserver", "--ip", "127.0.0.1"], env, cwd)
    srv = _timed_deploy(env, cwd, split_out, "ecommerce",
                        "ECommerceAlgorithm",
                        {"store_s": "LEventStore.find_by_entity",
                         "topk_s": "incubator_predictionio_torch.models."
                                   "_sharded_serving:ShardedCatalog.top_k"})
    try:
        with events, srv:
            ready_s = time.perf_counter() - t0
            check(srv.info["engineInstanceId"] == trained["engineInstanceId"],
                  f"deployed {srv.info}")
            conn = srv.connect()
            for j, q in enumerate(queries):
                if j == n_before:
                    # the top answers of the default queries, and some head
                    # items, made unavailable through the event server
                    unavailable = sorted(
                        {int(res["itemScores"][0]["item"][1:])
                         for q0, res in answered if "unseenOnly" not in q0}
                        | set(np.random.default_rng(67).integers(0, head, 20)
                              .tolist()))
                    status, res, _ = events.request(
                        "POST", f"/events.json?accessKey={key}",
                        {"event": "$set", "entityType": "constraint",
                         "entityId": "unavailableItems",
                         "properties": {"items": [f"i{x}"
                                                  for x in unavailable]},
                         "eventTime": _iso_ms(T0_MS + nnz + 1_000)})
                    check(status == 201, f"$set POST {status}: {res}")
                status, res, ms = srv.request("POST", "/queries.json", q,
                                              conn)
                check(status == 200, f"query {status}: {res}")
                check_answer(q, res, unavailable)
                answered.append((q, res))
                client_ms.append(ms)
            conn.close()
    finally:  # a server whose start failed is stopped here
        for proc in (events.proc, srv.proc):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(split_out, encoding="utf-8") as fh:
        records = json.load(fh)
    banned = {f"i{x}" for x in unavailable}
    check(all(not banned & {e["item"] for e in res["itemScores"]}
              for _, res in answered[n_before:]),
          "an unavailable item was served after the $set")
    # the first query opens the connection; its time is left out
    split = _split(client_ms[1:], records[1:],
                   {"store_read": "store_s", "topk": "topk_s"})
    emit("ecommerce_jsonl", events=nnz, users=nu, items=ni,
         reduced=(f"first {nnz} of config 6's {ECOMMERCE[2]} events: the "
                  "script's time (1,200 s)"),
         buys=int(buy.sum()), categories=ECOMMERCE_CATEGORIES,
         compacted=False, log_bytes=os.path.getsize(log_path),
         log_write_seconds=write_s, rank=RANK, iterations=10,
         reg=algo["lambda"], train_seconds_end_to_end=trained["wall_seconds"],
         train_seconds_run_train=trained["seconds"],
         read_seconds=tm["read_seconds"], timings=tm,
         events_per_s_end_to_end=nnz / trained["wall_seconds"],
         steady_iteration_ms=steady_ms,
         events_per_s_steady=nnz / (steady_ms * 10 / 1e3),
         kernel_launches=got, expected_launches=expected,
         solve_calls_per_iteration={"user": calls_u, "item": calls_i},
         deploy_ready_seconds=ready_s, queries_before_set=n_before,
         queries_after_set=n_after, unavailable_items=len(unavailable),
         answers=counts, query_ms=split)
    shutil.rmtree(cwd)


# -- pio eval ------------------------------------------------------------------

ML100K_SEED = 11
#: the Recommendation sweep's rate events: the first EVAL_RATES of
#: ML-100K's ratings (all 100,000 until the gang phases needed the time,
#: 50,000 until the slab-gang phases did, 25,000 until the linear gang and
#: stream phases did)
EVAL_RATES = 12_500
#: the E-Commerce sweep's events: view events of the first EVAL_VIEWS
#: ML-100K pairs (see phase_pio_eval for the cut; 500 until the gang
#: phases needed the time, 250 until the linear gang and stream phases did)
EVAL_VIEWS = 125
EVAL_MODULES = {
    "recommendation": (
        "incubator_predictionio_torch.models.recommendation_eval."
        "RecommendationEvaluation",
        "incubator_predictionio_torch.models.recommendation_eval.ParamsList"),
    "ecommerce": (
        "incubator_predictionio_torch.models.template_evals."
        "ECommerceEvaluation",
        "incubator_predictionio_torch.models.template_evals."
        "ECommerceParamsList"),
    "complementary": (
        "incubator_predictionio_torch.models.template_evals."
        "ComplementaryEvaluation",
        "incubator_predictionio_torch.models.template_evals."
        "ComplementaryParamsList"),
}
#: the ALS sweeps' candidates (ParamsList, ECommerceParamsList): rank ×
#: lambda, 10 iterations, 3 folds (ComplementaryParamsList also has 4)
EVAL_GRID = [(r, lam) for r in (8, 16) for lam in (0.01, 0.1)]


def _sweep_launches(u, i, implicit: bool) -> int:
    """The warp launches of a sweep: per candidate and fold of
    ``k_fold_indices(n, 3, seed 0)`` over the read's time-ordered rows,
    the solve calls the fold's training layout implies."""
    from incubator_predictionio_torch.e2 import k_fold_indices

    ud, nu = _dense(u)
    idn, ni = _dense(i)
    total = 0
    for rank, lam in EVAL_GRID:
        params = ALSParams(rank=rank, num_iterations=10, reg=lam,
                           implicit_prefs=implicit)
        for train_sel, _ in k_fold_indices(len(u), 3, 0):
            total += implied_launches(ud[train_sel], idn[train_sel], nu, ni,
                                      params, 10)[0]
    return total


class _EvalRun:
    """``pio eval`` of one sweep, started at once in its own process (so a
    CPU sweep can run beside a card sweep); :meth:`result` waits for it
    and returns its JSON line with the leaderboard text, the wall seconds
    and the per-candidate and per-call times. Leaving the ``with`` block
    stops it if it still runs."""

    def __init__(self, name: str, env: dict, cwd: str, device: str,
                 app: str = "ml100k"):
        evaluation, generator = EVAL_MODULES[name]
        self.name = name
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            CONSOLE + ["eval", evaluation, generator, "--app-name", app,
                       "--device", device], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)

    def __enter__(self):
        return self

    def result(self) -> dict:
        out, err = self.proc.communicate(timeout=900)
        wall = time.perf_counter() - self.t0
        check(self.proc.returncode == 0,
              f"verb eval failed ({self.proc.returncode}): {err[-2000:]}")
        lines = out.strip().splitlines()
        result = json.loads(lines[-1])
        result["wall_seconds"] = wall
        result["leaderboard"] = lines[:lines.index(
            "[MetricEvaluator] best engine params:")]
        check(result["candidates"] == len(EVAL_GRID),
              f"{self.name} sweep ran {result['candidates']} candidates")
        check(all(0.0 <= s <= 1.0 for s in result["scores"]),
              f"{self.name} scores out of range: {result['scores']}")
        rm = result["ranking_metrics"]
        result["seconds_per_candidate"] = (result["seconds"]
                                           / result["candidates"])
        result["ranking_metrics_ms_per_call"] = (
            rm["seconds"] / rm["calls"] * 1e3 if rm["calls"] else None)
        return result

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _eval_verb(name: str, env: dict, cwd: str, device: str,
               app: str = "ml100k") -> dict:
    """``pio eval`` of one sweep, waited for (:class:`_EvalRun`)."""
    with _EvalRun(name, env, cwd, device, app) as run:
        return run.result()


def phase_pio_eval(workdir: str) -> None:
    """pio eval on the ML-100K shape (bench.py SCALES["ml100k"],
    synth_ratings seed 11) as one JSONL app: the first EVAL_RATES of its
    100,000 ratings as rate events, and the first EVAL_VIEWS of the same
    (user, item) pairs as
    view events. The Recommendation sweep (RecommendationEvaluation +
    ParamsList: 4 candidates × 3 folds, HitRate@10) reads the rates, the
    E-Commerce sweep (ECommerceEvaluation + ECommerceParamsList: 4 × 3,
    NDCG@10 and @5 by one ranking_metrics call per query and metric) the
    views, on the card; the E-Commerce sweep runs again with --device cpu
    and must agree (the same candidates, scores within 0.02, the same
    best where the top two differ by more than 0.05). Warp launches = the
    folds' implied solve calls.

    The E-Commerce sweep is cut to EVAL_VIEWS events: each of its queries
    runs predict with a serve-time store read and two ranking_metrics
    calls, one after another on the host, so all 100,000 events (400,000
    queries per sweep) would take the phase's time many times over, on
    the card and again on the CPU; ``reduced`` carries the measured time
    per query. The CPU sweep runs beside the card's E-Commerce sweep
    (both processes at once), for the script's time."""
    n_users, n_items, full = ML100K
    u, i, r = (a[:EVAL_RATES] for a in synth_ratings(
        n_users, n_items, full, seed=ML100K_SEED))
    nnz = EVAL_RATES
    t_rate = T0_MS + np.random.default_rng(12).permutation(nnz)
    t_view = T0_MS + nnz + np.random.default_rng(13).permutation(EVAL_VIEWS)
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio_eval")
    env = _jsonl_env(base)
    _verb(["app", "new", "ml100k"], env, cwd)
    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    with open(log_path, "wb") as fh:
        fh.write(_log_lines(u, i, r, t_rate, 0))
        fh.write(_ecommerce_lines(u[:EVAL_VIEWS], i[:EVAL_VIEWS],
                                  np.zeros(EVAL_VIEWS, bool), t_view, nnz))

    rate_order = np.argsort(t_rate, kind="stable")
    view_order = np.argsort(t_view, kind="stable")
    expected = {
        "recommendation": _sweep_launches(u[rate_order], i[rate_order], False),
        "ecommerce": _sweep_launches(u[:EVAL_VIEWS][view_order],
                                     i[:EVAL_VIEWS][view_order], True)}
    sweeps = {"recommendation": _eval_verb("recommendation", env, cwd,
                                           "cuda")}
    # the E-Commerce sweep on the CPU runs beside the card's
    with _EvalRun("ecommerce", env, cwd, "cpu") as cpu_run:
        sweeps["ecommerce"] = _eval_verb("ecommerce", env, cwd, "cuda")
        cpu = sweeps["ecommerce_cpu"] = cpu_run.result()
    for name in ("recommendation", "ecommerce"):
        res = sweeps[name]
        got = res["kernel_launches"]
        check(got["warp"] == expected[name] and got["wide"] == 0,
              f"{name} sweep launches {got} != implied {expected[name]} warp")
        res["expected_launches"] = expected[name]
    check(sweeps["ecommerce"]["ranking_metrics"]["calls"] > 0,
          "the E-Commerce sweep made no ranking_metrics call")
    record("pio_eval", {
        "warp": sum(sweeps[name]["kernel_launches"]["warp"]
                    for name in ("recommendation", "ecommerce")),
        "wide": 0})
    card = sweeps["ecommerce"]
    top = sorted(card["scores"], reverse=True)
    check(cpu["candidates"] == card["candidates"],
          "the card and CPU sweeps differ in their candidates")
    check(all(abs(a - b) <= 0.02
              for a, b in zip(card["scores"], cpu["scores"])),
          f"card scores {card['scores']} vs CPU {cpu['scores']}")
    check(top[0] - top[1] <= 0.05 or card["bestIndex"] == cpu["bestIndex"],
          f"best candidate {card['bestIndex']} on the card, "
          f"{cpu['bestIndex']} on the CPU")
    ms_per_query = card["seconds"] * 1e3 / (len(EVAL_GRID) * EVAL_VIEWS)
    emit("pio_eval", events=nnz, users=n_users, items=n_items,
         ecommerce_events=EVAL_VIEWS, reduced=(
             f"the Recommendation sweep on the first {nnz} of ML-100K's "
             f"{full} ratings; the E-Commerce sweep on {EVAL_VIEWS} of "
             f"them: {ms_per_query:.3f} ms per eval query on the card "
             "(predict with a store read, two ranking_metrics calls) × "
             f"{len(EVAL_GRID) * full} queries at the full count"),
         ecommerce_ms_per_query=ms_per_query, sweeps=sweeps)
    shutil.rmtree(cwd)


# -- the Classification and Text-Classification templates ---------------------

#: bench_templates.py:69 config 2: labeled entities × attributes × classes
CLASSIFICATION = (2_000_000, 4, 3)
#: the entities classification_jsonl writes, cut from config 2's 2,000,000
#: for the script's time: the whole script took 1,110 s on one H100 host
#: with all of them, this phase 114 s; 500,000 until the slab-gang phases
#: needed the time, 250,000 until the CCO gang and serving-mesh phases did
CLASSIFICATION_ENTITIES = 125_000
CLASSIFICATION_ID_SEED = 9
CLASSIFICATION_ENGINE = os.path.join(ROOT, "templates", "classification",
                                     "engine.json")
#: bench_templates.py:144 config 4: documents × classes × vocabulary
TEXT = (18_846, 20, 3_000)
TEXT_ID_SEED = 10
TEXT_ENGINE = os.path.join(ROOT, "templates", "text-classification",
                           "engine.json")
#: LR as bench_templates.py:105 sets it (regParam 0.01, 100 iterations)
LR_REG, LR_ITERS = 0.01, 100
#: card vs CPU LR: the final loss within this relative gap, and the same
#: argmax on every row whose top two logits differ by more than the margin
LR_LOSS_RTOL, LR_MARGIN = 1e-5, 1e-3
LINEAR_QUERIES = 60


def _classification_data(n: int = 0) -> tuple:
    """bench_classification's draws: Poisson attributes around seeded
    class centres (default_rng(1)), ``n`` entities (default
    CLASSIFICATION_ENTITIES)."""
    _, d, c = CLASSIFICATION
    n = n or CLASSIFICATION_ENTITIES
    rng = np.random.default_rng(1)
    centers = rng.random((c, d)) * 3 + 0.5
    y = rng.integers(0, c, n).astype(np.int32)
    x = rng.poisson(centers[y]).astype(np.float32)
    return x, y


def _classification_lines(x, y, times_ms, _unused, first: int) -> bytes:
    """One ``$set`` of the attributes and the "plan" label per entity, byte
    for byte what insert_batch writes (``_write_log``'s four arrays: x, y
    and the times twice)."""
    iso = np.datetime_as_string(np.asarray(times_ms).astype("datetime64[ms]"),
                                unit="ms").tolist()
    attrs = np.asarray(x).astype(np.int64).tolist()
    return "".join([
        f'{{"eventId": "{CLASSIFICATION_ID_SEED:08x}{first + k:024x}", '
        f'"event": "$set", "entityType": "user", "entityId": "u{first + k}", '
        f'"properties": {{'
        + "".join(f'"attr{j}": {v}, ' for j, v in enumerate(a))
        + f'"plan": {p}}}, "eventTime": "{t}Z", '
        f'"creationTime": "{CREATED_ISO}"}}\n'
        for k, (a, p, t) in enumerate(zip(attrs, np.asarray(y).tolist(), iso))
    ]).encode()


def _text_docs(n_docs: int, seed: int) -> tuple:
    """bench_text's generator: 120-200 tokens per document over a 3,000
    word vocabulary, skewed to low ids and shifted per class."""
    _, n_classes, vocab = TEXT
    rng = np.random.default_rng(seed)
    words = np.array([f"w{j}" for j in range(vocab)])
    y = rng.integers(0, n_classes, n_docs).astype(np.int32)
    texts = []
    for j in range(n_docs):
        length = 120 + int(80 * rng.random())
        base = (vocab * rng.random(length) ** 2).astype(np.int64)
        shift = (y[j] * 131) % vocab
        texts.append(" ".join(words[(base + shift) % vocab]))
    return texts, y


def _text_lines(texts, y, times_ms, first: int) -> bytes:
    """One ``documents`` event per text, its label the class id as a
    string, byte for byte what insert_batch writes."""
    iso = np.datetime_as_string(np.asarray(times_ms).astype("datetime64[ms]"),
                                unit="ms").tolist()
    return "".join([
        f'{{"eventId": "{TEXT_ID_SEED:08x}{first + k:024x}", "event": '
        f'"documents", "entityType": "content", "entityId": "d{first + k}", '
        f'"properties": {{"text": {json.dumps(t)}, "label": "{c}"}}, '
        f'"eventTime": "{s}Z", "creationTime": "{CREATED_ISO}"}}\n'
        for k, (t, c, s) in enumerate(zip(texts, np.asarray(y).tolist(), iso))
    ]).encode()


def _template_engine(path: str, factory: str, app: str, workdir: str,
                     **datasource) -> dict:
    """The template's engine.json with the port's factory and the app."""
    with open(path, encoding="utf-8") as fh:
        engine_json = json.load(fh)
    engine_json["engineFactory"] = factory
    engine_json["datasource"]["params"].update(appName=app, **datasource)
    with open(os.path.join(workdir, "engine.json"), "w",
              encoding="utf-8") as fh:
        json.dump(engine_json, fh)
    return engine_json


def _linear_train_verb(env: dict, cwd: str, path: str) -> dict:
    """``pio train`` of a template that solves nothing (the linear and the
    CCO templates): its JSON line and wall seconds; no solve kernel may
    launch."""
    out, wall = _verb(["train"], env, cwd, timeout=1200)
    trained = json.loads(out.stdout.strip().splitlines()[-1])
    trained["wall_seconds"] = wall
    check(trained["kernel_launches"] == {"warp": 0, "wide": 0},
          f"{path}: pio train launched {trained['kernel_launches']}")
    return trained


def _persisted(env: dict, instance_id: str) -> dict:
    store = _storage_of(env)
    _, persisted = models_from_bytes(model_artifact.read_model(store,
                                                               instance_id))
    store.close()
    return persisted[0]


def _same_arrays(got: dict, want, names, what: str) -> None:
    for name in names:
        a, b = got.get(name), getattr(want, name)
        check((a is None) == (b is None)
              and (b is None or np.array_equal(a, b)),
              f"{what}: the persisted {name} differs from the host's")


def _timed(fn):
    """(result, seconds) of fn() with the card synchronized around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _lr_card_vs_cpu(x, y, n_classes: int, what: str) -> dict:
    """LR trained on the same data on the card and on the CPU: the final
    loss (float64 on the host, the same function for both) within
    LR_LOSS_RTOL, the same argmax wherever both models' top two logits
    differ by more than LR_MARGIN; times, iterations, loss evaluations
    and host syncs of both, and the card's device ms per iteration."""
    from incubator_predictionio_torch.ops.linear import (
        train_logistic_regression,
    )

    def fit(device, stats):
        return train_logistic_regression(x, y, n_classes, reg=LR_REG,
                                         max_iters=LR_ITERS, device=device,
                                         stats=stats)

    card_stats, cpu_stats = {}, {}
    card, card_s = _timed(lambda: fit("cuda", card_stats))
    t0 = time.perf_counter()
    cpu = fit("cpu", cpu_stats)
    cpu_s = time.perf_counter() - t0

    def loss_and_logits(m):
        z = x.astype(np.float64) @ m.weights + m.intercept
        zs = z - z.max(axis=1, keepdims=True)
        logp = zs - np.log(np.exp(zs).sum(axis=1, keepdims=True))
        nll = -logp[np.arange(len(y)), y].mean()
        return nll + 0.5 * LR_REG * float(
            (m.weights.astype(np.float64) ** 2).sum()), z

    loss_card, z_card = loss_and_logits(card)
    loss_cpu, z_cpu = loss_and_logits(cpu)

    def margin(z):
        top2 = np.sort(z, axis=1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    held = (margin(z_card) > LR_MARGIN) & (margin(z_cpu) > LR_MARGIN)
    same = z_card.argmax(axis=1) == z_cpu.argmax(axis=1)
    rel = abs(loss_card - loss_cpu) / loss_cpu
    check(rel <= LR_LOSS_RTOL,
          f"{what}: LR loss {loss_card} on the card, {loss_cpu} on the CPU")
    check(bool(same[held].all()),
          f"{what}: {int((~same[held]).sum())} rows past the margin differ")
    fit_ms = device_ms(lambda: fit("cuda", {}), 1, False)
    per_iter = (None if fit_ms is None
                else fit_ms / card_stats["iterations"])
    return {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_gap": rel,
            "rows_held": int(held.sum()), "rows_total": len(y),
            "rows_differing_within_margin": int((~same).sum()),
            "card": card_stats, "cpu": cpu_stats, "card_seconds": card_s,
            "cpu_seconds": cpu_s,
            "card_ms_per_iteration": card_s * 1e3 / card_stats["iterations"],
            "card_device_ms_per_iteration": per_iter,
            "host_syncs_per_iteration":
                card_stats["host_syncs"] / card_stats["iterations"],
            "weight_rel_gap": float(np.linalg.norm(card.weights - cpu.weights)
                                    / np.linalg.norm(cpu.weights))}


def _op_times(fn, n_bytes: int) -> dict:
    """A K6 op on the card: wall ms per call (CUDA events around 5 calls
    after a warm-up, host work included), device ms per call (the
    profiler: its kernels and copies; None where it saw none) and the
    bytes bound."""
    bw, _, _ = peak_rates()
    return {"ms": loop_ms(fn, 5), "device_ms": device_ms(fn, 3, False),
            "bound_ms": n_bytes / bw * 1e3, "bound_by": "bytes"}


def phase_classification_jsonl(workdir: str) -> dict:
    """bench_templates.py config 2 through the Classification template and
    the verbs, on a JSONL log: CLASSIFICATION_ENTITIES ``$set`` events
    (user u<n>,
    attr0..attr3 Poisson around seeded class centres, a "plan" label of 3
    classes) → pio train (the template's values, naive, lambda 1.0; its
    attributes widened to the config's four) → its model equal to a host
    numpy NB of the generated arrays (its exact class statistics) → pio
    deploy → 60 queries held to that host NB. In process, on the same
    training data: the NB statistics on the card equal the CPU's bit for
    bit, and LR (regParam 0.01, 100 iterations) on the card against the
    CPU (_lr_card_vs_cpu). Neither solve kernel launches. Returns the
    store, the arrays and the models classification_gang holds its gangs
    to (it removes the phase's directory)."""
    from incubator_predictionio_torch.models import classification
    from incubator_predictionio_torch.ops.linear import (
        nb_model_from_counts, nb_stats,
    )

    _, d, c = CLASSIFICATION
    n = CLASSIFICATION_ENTITIES
    x, y = _classification_data()
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio_cls")
    env = _jsonl_env(base)
    _verb(["app", "new", "cls"], env, cwd)
    attributes = [f"attr{j}" for j in range(d)]
    engine_json = _template_engine(
        CLASSIFICATION_ENGINE, "incubator_predictionio_torch.models."
        "classification.ClassificationEngine", "cls", cwd,
        attributes=attributes)
    smoothing = engine_json["algorithms"][0]["params"]["lambda"]
    times = T0_MS + np.arange(n)
    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    t0 = time.perf_counter()
    _write_log(log_path, x, y, times, times, lines=_classification_lines)
    write_s = time.perf_counter() - t0
    rows = np.sort(np.random.default_rng(71).choice(n, 500, replace=False))
    _hold_lines(b"".join(_classification_lines(x[k:k + 1], y[k:k + 1],
                                               times[k:k + 1], None, int(k))
                         for k in rows), cwd)

    reset_launches()
    trained = _linear_train_verb(env, cwd, "classification_jsonl")
    tm = trained["timings"]
    check(tm["ratings_read"] == n, f"read {tm['ratings_read']} entities")
    feat = np.stack([x[y == k].sum(axis=0, dtype=np.float64)
                     for k in range(c)]).astype(np.float32)
    counts = np.bincount(y, minlength=c).astype(np.float32)
    host = nb_model_from_counts(feat, counts, c, smoothing)
    stored = _persisted(env, trained["engineInstanceId"])
    _same_arrays(stored, host, ("log_prior", "log_likelihood", "feat_counts",
                                "class_counts"), "classification")
    check(stored["label_values"].tolist() == list(range(c)),
          f"labels {stored['label_values']}")

    # in process, on the training data the read gave (the generated
    # arrays: the model above holds their exact statistics): the card's
    # statistics against the CPU's, LR card vs CPU
    td = classification.TrainingData(x, y, tuple(attributes),
                                     stored["label_values"])
    (f_card, c_card), nb_card_s = _timed(
        lambda: nb_stats(td.features, td.labels, c, "cuda"))
    f_cpu, c_cpu = nb_stats(td.features, td.labels, c, "cpu")
    check(np.array_equal(f_card, f_cpu) and np.array_equal(c_card, c_cpu)
          and np.array_equal(f_card, feat),
          "classification NB statistics: the card's differ from the CPU's")
    stats_op = _op_times(lambda: nb_stats(td.features, td.labels, c, "cuda"),
                         td.features.nbytes + td.labels.nbytes * 2)
    lr = _lr_card_vs_cpu(td.features, td.labels, c, "classification")
    launched = launches()
    check(launched["total"] == 0, f"classification launched {launched}")
    PATH_LAUNCHES["classification_jsonl"] = {"warp": 0, "wide": 0}

    qrows = np.random.default_rng(72).choice(n, LINEAR_QUERIES - 10,
                                             replace=False)
    queries = [dict(zip(attributes, x[k].tolist())) for k in qrows] + [
        dict(zip(attributes, v)) for v in
        np.random.default_rng(73).integers(0, 12, (10, d)).tolist()]
    query_ms, correct = [], 0
    with _Served(["deploy"], env, cwd) as srv:
        check(srv.info["engineInstanceId"] == trained["engineInstanceId"],
              f"deployed {srv.info}")
        conn = srv.connect()
        for j, q in enumerate(queries):
            status, res, ms = srv.request("POST", "/queries.json", q, conn)
            check(status == 200, f"query {status}: {res}")
            xq = np.asarray([[float(q[a]) for a in attributes]], np.float32)
            want = float(np.argmax(host.predict_log_joint(xq)[0]))
            check(res == {"label": want}, f"answer {res}, host {want}")
            correct += j < len(qrows) and want == y[qrows[j]]
            query_ms.append(ms)
        conn.close()
    emit("classification_jsonl", entities=n, attributes=d, classes=c,
         reduced=(f"{n} of config 2's {CLASSIFICATION[0]} entities, for "
                  "the script's time"),
         log_bytes=os.path.getsize(log_path), log_write_seconds=write_s,
         train_seconds_end_to_end=trained["wall_seconds"],
         train_seconds_run_train=trained["seconds"],
         read_seconds=tm["read_seconds"],
         nb_stats_card_seconds=nb_card_s, nb_stats_op=stats_op,
         lr=lr, queries=len(queries), query_ms=_percentiles(query_ms[1:]),
         host_nb_accuracy_on_training_rows=correct / len(qrows),
         kernel_launches=launched)
    return {"cwd": cwd, "env": env, "x": x, "y": y, "times": times,
            "attributes": attributes, "host": host, "stored": stored,
            "lr": lr, "trained": trained, "smoothing": smoothing}


def phase_text_classification_jsonl(workdir: str) -> dict:
    """bench_templates.py config 4 through the Text-Classification template
    and the verbs, on a JSONL log: 18,846 ``documents`` events (120-200
    tokens over 3,000 words, 20 classes) → pio train (the template's
    values: numFeatures 4096, nb, lambda 1.0) → its model equal to a host
    NB of the Python tokenizer's COO (which equals the codec's) → pio
    deploy → 60 new documents held to that host NB. In process: the
    codec's tokenize timed, the COO statistics on the card equal the
    CPU's bit for bit, and TextLRAlgorithm's fit (regParam 0.01, 100
    iterations, dense TF-IDF 18,846 × 4,096) on the card against the CPU.
    Neither solve kernel launches. Returns the store, the corpus and the
    persisted model text_classification_gang and linear_streams use (the
    gang phase removes the phase's directory)."""
    from incubator_predictionio_torch.models import text_classification
    from incubator_predictionio_torch.ops.linear import (
        _nb_model_from_stats, nb_stats_coo,
    )
    from incubator_predictionio_torch.ops.tfidf import TfIdfVectorizer

    n_docs, n_classes, _ = TEXT
    texts, y = _text_docs(n_docs, 3)
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio_text")
    env = _jsonl_env(base)
    _verb(["app", "new", "text"], env, cwd)
    engine_json = _template_engine(
        TEXT_ENGINE, "incubator_predictionio_torch.models."
        "text_classification.TextClassificationEngine", "text", cwd)
    n_features = engine_json["preparator"]["params"]["numFeatures"]
    ngram = engine_json["preparator"]["params"]["nGram"]
    smoothing = engine_json["algorithms"][0]["params"]["lambda"]
    times = T0_MS + np.arange(n_docs)
    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    with open(log_path, "wb") as fh:
        fh.write(_text_lines(texts, y, times, 0))
    _hold_lines(_text_lines(texts[:300], y[:300], times[:300], 0), cwd)

    # the host NB: the Python tokenizer's COO, float64 bincounts
    label_values, yl = np.unique(np.asarray([str(v) for v in y]),
                                 return_inverse=True)
    host_vec = TfIdfVectorizer(n_features=n_features, ngram=ngram)
    (doc_ptr, feat, cnt), py_tok_s = _timed(
        lambda: host_vec.fit_tf_coo(texts, use_native=False))
    cls = np.repeat(yl, np.diff(doc_ptr))
    host_feat = np.bincount(cls * n_features + feat, weights=cnt,
                            minlength=n_classes * n_features).reshape(
        n_classes, n_features).astype(np.float32)
    host = _nb_model_from_stats(host_feat, yl, n_classes, smoothing,
                                host_vec.idf)

    reset_launches()
    trained = _linear_train_verb(env, cwd, "text_classification_jsonl")
    tm = trained["timings"]
    check(tm["ratings_read"] == n_docs, f"read {tm['ratings_read']} docs")
    stored = _persisted(env, trained["engineInstanceId"])
    _same_arrays(stored, host, ("log_prior", "log_likelihood"), "text")
    check("feat_counts" not in stored, "a col-scaled NB kept its counts")
    check(np.array_equal(stored["vectorizer_idf"], host_vec.idf)
          and stored["label_values"].tolist() == label_values.tolist(),
          "the persisted vectorizer or labels differ from the host's")

    ctx = WorkflowContext(app_name="text", storage=_storage_of(env))
    ds = text_classification.TextDataSource(
        text_classification.DataSourceParams(app_name="text"))
    td, read_s = _timed(lambda: ds.read_training(ctx))
    ctx.storage.close()
    check(td.texts == texts and np.array_equal(td.labels, yl),
          "the read's documents differ from the generated ones")
    vec = TfIdfVectorizer(n_features=n_features, ngram=ngram)
    coo, tok_s = _timed(lambda: vec.fit_tf_coo(td.texts))
    check(all(np.array_equal(a, b) for a, b in zip(coo, (doc_ptr, feat, cnt)))
          and np.array_equal(vec.idf, host_vec.idf),
          "the codec's tokenizer differs from the Python loop")
    args = (cls, feat, cnt, n_classes, n_features)
    s_card, stats_s = _timed(lambda: nb_stats_coo(*args, "cuda"))
    s_cpu = nb_stats_coo(*args, "cpu")
    check(np.array_equal(s_card, s_cpu) and np.array_equal(s_card, host_feat),
          "text NB statistics: the card's differ from the CPU's")
    stats_op = _op_times(lambda: nb_stats_coo(*args, "cuda"),
                         cls.size * 4 * 2 + cnt.nbytes
                         + n_classes * n_features * 4)
    pd = text_classification.PreparedData(None, yl, label_values, vec,
                                          features_are_tf=True, coo=coo)
    dense = pd.dense_tf() * vec.idf
    lr = _lr_card_vs_cpu(dense, yl.astype(np.int32), n_classes, "text")
    del dense
    launched = launches()
    check(launched["total"] == 0, f"text classification launched {launched}")
    PATH_LAUNCHES["text_classification_jsonl"] = {"warp": 0, "wide": 0}

    q_texts, q_y = _text_docs(LINEAR_QUERIES, 33)
    query_ms, correct = [], 0
    with _Served(["deploy"], env, cwd) as srv:
        check(srv.info["engineInstanceId"] == trained["engineInstanceId"],
              f"deployed {srv.info}")
        conn = srv.connect()
        for text, truth in zip(q_texts, q_y):
            status, res, ms = srv.request("POST", "/queries.json",
                                          {"text": text}, conn)
            check(status == 200, f"query {status}: {res}")
            scores = host.predict_log_joint(host_vec.transform([text]))[0]
            z = scores - scores.max()
            probs = np.exp(z) / np.exp(z).sum()
            k = int(np.argmax(probs))
            want = {"category": str(label_values[k]),
                    "confidence": float(probs[k])}
            check(res == want, f"answer {res}, host {want}")
            correct += want["category"] == str(truth)
            query_ms.append(ms)
        conn.close()
    emit("text_classification_jsonl", documents=n_docs, classes=n_classes,
         features=n_features, coo_entries=int(cnt.size),
         tokens=int(cnt.sum()), log_bytes=os.path.getsize(log_path),
         train_seconds_end_to_end=trained["wall_seconds"],
         train_seconds_run_train=trained["seconds"],
         read_seconds=tm["read_seconds"], in_process_read_seconds=read_s,
         tokenize_seconds_native=tok_s, tokenize_seconds_python=py_tok_s,
         nb_stats_card_seconds=stats_s, nb_stats_op=stats_op, lr=lr,
         queries=len(q_texts), query_ms=_percentiles(query_ms[1:]),
         host_nb_accuracy_on_new_documents=correct / len(q_texts),
         kernel_launches=launched)
    return {"cwd": cwd, "env": env, "texts": texts, "y": y,
            "stored": stored, "trained": trained, "n_features": n_features,
            "ngram": ngram, "host": host}


# -- the linear templates' gangs and streams ----------------------------------

#: the linear gangs' ranks (sharing the one card) and the queries held to
#: the gang's deployed NB model
LINEAR_GANG_WORKERS = 2
LINEAR_GANG_QUERIES = 20
#: linear_streams: the dense chunk of the forced stream (rows) and the text
#: stream's documents per tokenizer chunk
STREAM_CHUNK_ON = 250_000
STREAM_CHUNK_DOCS = 2_048
NB_ARRAYS = ("log_prior", "log_likelihood", "feat_counts", "class_counts")
#: a linear gang worker's train report: what linear_*_gang prints per rank
LINEAR_RANK_KEYS = (
    "rank", "world", "read_seconds", "ratings_read", "local_rows",
    "local_entries", "n_global", "stats_seconds", "allreduce_calls",
    "allreduce_bytes", "allreduce_seconds", "lbfgs_seconds", "iterations",
    "loss_evals", "host_syncs", "collectives", "loss")


class _GangTrain:
    """``pio train --num-workers 2`` of an engine that solves nothing (the
    linear and the CCO templates), started at once in its own process (so
    a server can boot meanwhile); :meth:`result` waits for it and returns its last JSON line
    with ``wall_seconds`` (from the start), every worker completed without
    a restart and launched no solve kernel. Leaving the ``with`` block
    stops it if it still runs."""

    def __init__(self, env: dict, cwd: str, extra=()):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            CONSOLE + ["train", "--num-workers", str(LINEAR_GANG_WORKERS),
                       *extra], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env | GANG_KNOBS,
            cwd=cwd)

    def __enter__(self):
        return self

    def result(self, timeout: float = 600) -> dict:
        out, err = self.proc.communicate(timeout=timeout)
        wall = time.perf_counter() - self.t0
        check(self.proc.returncode == 0,
              f"gang train failed ({self.proc.returncode}): {err[-2000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        got["wall_seconds"] = wall
        check(_gang_launches(got) == {"warp": 0, "wide": 0},
              f"a gang launched {_gang_launches(got)}")
        return got

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _linear_gang_verb(env: dict, cwd: str, extra=()) -> dict:
    """``pio train --num-workers 2`` of a linear engine (the ranks share
    the card over gloo; no snapshots: the linear trainers take none),
    waited for (:class:`_GangTrain`)."""
    with _GangTrain(env, cwd, extra) as run:
        return run.result()


#: what a CCO gang rank reports (_cco_gang)
CCO_RANK_KEYS = (
    "rank", "world", "read_seconds", "ratings_read", "path", "n_ranges",
    "local_ranges", "gemms", "counts_ms", "g2_topk_ms", "allreduce_calls",
    "allreduce_bytes", "allreduce_seconds")


def _cco_gang(env: dict, gang: dict, stored: dict, single: dict, path: str,
              calls: int, call_bytes: int, what: str) -> dict:
    """A CCO gang held to its single-process ``pio train``: every
    persisted array equal bit for bit, every rank on ``path`` with
    ``calls`` all-reduces of ``call_bytes`` each; returns its numbers."""
    got = _persisted(env, gang["engineInstanceId"])
    check(sorted(got) == sorted(stored), f"{what}: persisted keys differ")
    for name, want in stored.items():
        check(np.array_equal(np.asarray(got[name]), np.asarray(want))
              if isinstance(want, np.ndarray) else got[name] == want,
              f"{what}: the gang's {name} differs from the single-process "
              "pio train's")
    ranks = [w["timings"] for w in gang["workers"]]
    check([t["rank"] for t in ranks] == list(range(LINEAR_GANG_WORKERS))
          and all(t["path"] == path and t["allreduce_calls"] == calls
                  and t["allreduce_bytes"] == calls * call_bytes
                  for t in ranks),
          f"{what}: the ranks' counts {ranks}")
    seconds = [t["allreduce_seconds"] for t in ranks]
    return {"seconds_end_to_end": gang["wall_seconds"],
            "single_seconds_end_to_end": single["wall_seconds"],
            "restarts": gang["restarts"], "equal_to_single": "bit for bit",
            "allreduce_bytes_per_rank": calls * call_bytes,
            "allreduce_gb_per_s": [calls * call_bytes / 1e9 / max(x, 1e-9)
                                   for x in seconds],
            "workers": [{"train_seconds": w["seconds"],
                         **{k: w["timings"][k] for k in CCO_RANK_KEYS
                            if k in w["timings"]}}
                        for w in gang["workers"]]}


def _linear_gang_numbers(got: dict) -> dict:
    return {"seconds_end_to_end": got["wall_seconds"],
            "restarts": got["restarts"],
            "workers": [{"train_seconds": w["seconds"],
                         **{k: w["timings"][k] for k in LINEAR_RANK_KEYS
                            if k in w["timings"]}}
                        for w in got["workers"]]}


def _lr_rule(x, y, got, got_iters: int, want, want_iters: int,
             what: str) -> dict:
    """The LR rule of tests/test_torch_linear.py for two models on the
    same examples: the final loss (float64 on the host) within
    LR_LOSS_RTOL relative, the iterations within ±2, the same argmax
    wherever both models' top two logits differ by more than LR_MARGIN."""
    def loss_and_logits(m):
        z = x.astype(np.float64) @ m.weights + m.intercept
        zs = z - z.max(axis=1, keepdims=True)
        logp = zs - np.log(np.exp(zs).sum(axis=1, keepdims=True))
        return (-logp[np.arange(len(y)), y].mean() + 0.5 * LR_REG * float(
            (np.asarray(m.weights, np.float64) ** 2).sum())), z

    def margin(z):
        top2 = np.sort(z, axis=1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    loss_got, z_got = loss_and_logits(got)
    loss_want, z_want = loss_and_logits(want)
    rel = abs(loss_got - loss_want) / loss_want
    held = (margin(z_got) > LR_MARGIN) & (margin(z_want) > LR_MARGIN)
    differ = int((z_got.argmax(1) != z_want.argmax(1))[held].sum())
    check(rel <= LR_LOSS_RTOL, f"{what}: loss {loss_got} against {loss_want}")
    check(abs(got_iters - want_iters) <= 2,
          f"{what}: {got_iters} iterations against {want_iters}")
    check(differ == 0, f"{what}: {differ} rows past the margin differ")
    return {"loss": loss_got, "loss_single": loss_want, "loss_rel_gap": rel,
            "iterations": got_iters, "iterations_single": want_iters,
            "rows_held": int(held.sum()), "rows_total": len(y)}


def phase_classification_gang(cls: dict) -> None:
    """classification_gang, on classification_jsonl's entities: the same
    ``$set`` events (byte for byte) written as two partitions
    (``events_1.p0.jsonl``, ``.p1``: the partitioned log's layout) of a
    new store → pio train --num-workers 2 of the NB engine on the
    partition feed (each rank replays its own partition, the entity table
    agreed by all-gather, the statistics summed by one gloo all-reduce) →
    the persisted model equal to classification_jsonl's single-process one
    bit for bit → pio deploy of the gang's model, 20 queries held to the
    host NB (the server boots while the next gang trains). pio train
    --num-workers 2 --feed merged of the LR engine (regParam 0.01, 100
    iterations) on classification_jsonl's own log: every rank reads the
    merged view and trains its contiguous row block, the loss and the
    gradient all-reduced at every evaluation; held to the single-process
    LR on the card by the LR rule (:func:`_lr_rule`). Each rank's read,
    statistics, all-reduce and L-BFGS seconds and bytes are printed. No
    solve kernel launches."""
    from incubator_predictionio_torch.ops.linear import (
        LogisticRegressionModel, train_logistic_regression,
    )

    x, y, times = cls["x"], cls["y"], cls["times"]
    attributes, n = cls["attributes"], len(cls["y"])
    c = CLASSIFICATION[2]
    factory = ("incubator_predictionio_torch.models.classification."
               "ClassificationEngine")
    reset_launches()
    gdir = tempfile.mkdtemp(dir=cls["cwd"])
    env = _jsonl_env(os.path.join(gdir, "pio_cls_gang"))
    _verb(["app", "new", "cls"], env, gdir)
    _template_engine(CLASSIFICATION_ENGINE, factory, "cls", gdir,
                     attributes=attributes)
    store = _storage_of(env)
    app_id = store.get_meta_data_apps().get_by_name("cls").id
    events_dir = store.get_l_events().events_dir
    store.close()
    os.makedirs(events_dir, exist_ok=True)
    half = -(-n // LINEAR_GANG_WORKERS)
    t0 = time.perf_counter()
    for part, lo in enumerate(range(0, n, half)):
        hi = min(lo + half, n)
        _write_log(os.path.join(events_dir, f"events_{app_id}.p{part}.jsonl"),
                   x[lo:hi], y[lo:hi], times[lo:hi], times[lo:hi],
                   lines=lambda a, b, t, _u, first, lo=lo:
                   _classification_lines(a, b, t, None, lo + first))
    write_s = time.perf_counter() - t0

    nb = _linear_gang_verb(env, gdir)
    stored = _persisted(env, nb["engineInstanceId"])
    for name in NB_ARRAYS + ("label_values",):
        check(np.array_equal(stored[name], cls["stored"][name]),
              f"classification_gang: the gang's {name} differs from the "
              "single-process pio train's")
    workers = [w["timings"] for w in nb["workers"]]
    check(sorted(p for t in workers for p in t["shards"])
          == sorted(jsonl_shard_paths(events_dir, app_id))
          and sum(t["local_rows"] for t in workers) == n
          and all(t["n_global"] == n and t["allreduce_calls"] == 1
                  for t in workers),
          f"classification_gang: the ranks' blocks {workers}")
    # the gang's NB model boots in a server while the LR gang trains (a
    # server's start is seconds of the script's time)
    srv = _Served(["deploy"], env, gdir)
    try:
        ldir = tempfile.mkdtemp(dir=cls["cwd"])
        engine_json = _template_engine(CLASSIFICATION_ENGINE, factory, "cls",
                                       ldir, attributes=attributes)
        engine_json["algorithms"] = [{"name": "lr", "params": {
            "regParam": LR_REG, "maxIterations": LR_ITERS}}]
        with open(os.path.join(ldir, "engine.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(engine_json, fh)
        lr = _linear_gang_verb(cls["env"], ldir, ["--feed", "merged"])
        lr_workers = [w["timings"] for w in lr["workers"]]
        check(len({(t["iterations"], t["loss_evals"], t["collectives"])
                   for t in lr_workers}) == 1
              and [t["local_rows"] for t in lr_workers] == [half, n - half],
              f"classification_gang LR: the ranks disagree: {lr_workers}")
        lr_stored = _persisted(cls["env"], lr["engineInstanceId"])
        single_stats: dict = {}
        single, single_s = _timed(lambda: train_logistic_regression(
            x, y, c, reg=LR_REG, max_iters=LR_ITERS, device="cuda",
            stats=single_stats))
        rule = _lr_rule(
            x, y, LogisticRegressionModel(lr_stored["weights"],
                                          lr_stored["intercept"], c),
            lr_workers[0]["iterations"], single, single_stats["iterations"],
            "classification_gang LR")
    except BaseException:
        srv.__exit__(None, None, None)
        raise
    qrows = np.random.default_rng(74).choice(n, LINEAR_GANG_QUERIES,
                                             replace=False)
    query_ms = []
    with srv:
        check(srv.info["engineInstanceId"] == nb["engineInstanceId"],
              f"deployed {srv.info}")
        conn = srv.connect()
        for k in qrows:
            q = dict(zip(attributes, x[k].tolist()))
            status, res, ms = srv.request("POST", "/queries.json", q, conn)
            want = float(np.argmax(cls["host"].predict_log_joint(
                x[k:k + 1])[0]))
            check(status == 200 and res == {"label": want},
                  f"gang NB answer {status} {res}, host {want}")
            query_ms.append(ms)
        conn.close()
    launched = launches()
    check(launched["total"] == 0, f"classification_gang launched {launched}")
    PATH_LAUNCHES["classification_gang"] = {"warp": 0, "wide": 0}
    emit("classification_gang", entities=n, partitions=LINEAR_GANG_WORKERS,
         workers=LINEAR_GANG_WORKERS, partition_write_seconds=write_s,
         nb=_linear_gang_numbers(nb),
         nb_single_train_seconds_end_to_end=cls["trained"]["wall_seconds"],
         nb_equal_to_single="bit for bit", queries=len(qrows),
         query_ms=_percentiles(query_ms[1:]),
         lr_merged=_linear_gang_numbers(lr), lr_rule=rule,
         lr_single_card_seconds=single_s,
         lr_single_lbfgs_seconds=single_stats["lbfgs_seconds"],
         kernel_launches=launched)
    shutil.rmtree(cls["cwd"])


def phase_text_classification_gang(text: dict) -> None:
    """text_classification_gang, on text_classification_jsonl's log: pio
    train --num-workers 2 of the NB engine (every rank reads the merged
    corpus and fits the same vectorizer, scatter-adds its contiguous block
    of documents on the card, the [C·D] sums all-reduced once); the
    persisted model equal to text_classification_jsonl's single-process
    one bit for bit. Each rank's read, statistics and all-reduce seconds
    and bytes are printed. No solve kernel launches."""
    reset_launches()
    got = _linear_gang_verb(text["env"], text["cwd"])
    stored = _persisted(text["env"], got["engineInstanceId"])
    for name in ("log_prior", "log_likelihood", "vectorizer_idf",
                 "label_values"):
        check(np.array_equal(stored[name], text["stored"][name]),
              f"text_classification_gang: the gang's {name} differs from "
              "the single-process pio train's")
    workers = [w["timings"] for w in got["workers"]]
    n_docs = len(text["texts"])
    check(sum(t["local_rows"] for t in workers) == n_docs
          and all(t["allreduce_bytes"] == TEXT[1] * text["n_features"] * 4
                  for t in workers),
          f"text_classification_gang: the ranks' blocks {workers}")
    launched = launches()
    check(launched["total"] == 0, f"text gang launched {launched}")
    PATH_LAUNCHES["text_classification_gang"] = {"warp": 0, "wide": 0}
    emit("text_classification_gang", documents=n_docs,
         workers=LINEAR_GANG_WORKERS, nb=_linear_gang_numbers(got),
         single_train_seconds_end_to_end=text["trained"]["wall_seconds"],
         equal_to_single="bit for bit", kernel_launches=launched)
    shutil.rmtree(text["cwd"])


def _ring_bound(stats, cfg, what: str) -> dict:
    """The ring's peak device bytes above the accumulator, held to
    (depth + 1) chunks of the largest chunk."""
    bound = (cfg.depth + 1) * stats.chunk_bytes_max
    check(stats.ring_peak_bytes <= bound,
          f"{what}: the ring held {stats.ring_peak_bytes} bytes, more than "
          f"{cfg.depth + 1} chunks ({bound})")
    return {**stats.as_dict(), "ring_bound_bytes": bound}


def phase_linear_streams(text: dict) -> None:
    """linear_streams, in process on the card: bench_templates.py config 2
    at its full 2,000,000 entities × 4 Poisson attributes × 3 classes —
    Naive Bayes under PIO_PIPELINE's default ``auto`` (2 chunks of
    1,000,000 rows) and forced ``on`` in chunks of 250,000, each equal to
    the single-shot statistics bit for bit; LR (regParam 0.01, 100
    iterations) on the streamed matrix equal to LR on the single-shot
    upload bit for bit. Config 4 (text_classification_jsonl's 18,846
    documents, numFeatures 4096) through TextPreparator + TextNBAlgorithm
    under ``auto`` with chunk_docs 2,048 (the featurization deferred into
    the stream), equal to the one-shot prepare + train bit for bit. Each
    run's stage seconds, wall, chunks, in-flight chunks, overlap efficiency
    and the ring's peak device bytes above the accumulator (at most
    depth + 1 chunks). No solve kernel launches."""
    from incubator_predictionio_torch.models import text_classification as tc
    from incubator_predictionio_torch.ops.linear import (
        train_logistic_regression, train_naive_bayes,
    )
    from incubator_predictionio_torch.workflow.input_pipeline import (
        PipelineConfig, PipelineStats,
    )

    n, d, c = CLASSIFICATION
    x, y = _classification_data(n)
    off = PipelineConfig(mode="off")
    auto = PipelineConfig.from_env(mode="auto")  # 1,000,000-row chunks
    forced = PipelineConfig(mode="on", chunk_rows=STREAM_CHUNK_ON)
    check(auto.enabled_for(n, device="cuda")
          and not auto.enabled_for(n, device="cpu")
          and not auto.enabled_for(2 * auto.chunk_rows - 1, device="cuda"),
          "PIO_PIPELINE=auto: the gate")
    reset_launches()
    single, single_s = _timed(lambda: train_naive_bayes(
        x, y, c, device="cuda", pipeline=off))
    nb_runs = {"single_shot_seconds": single_s}
    for name, cfg in (("auto", auto), ("on", forced)):
        st = PipelineStats()
        got, secs = _timed(lambda: train_naive_bayes(
            x, y, c, device="cuda", pipeline=cfg, pipeline_stats=st))
        _same_arrays({k: getattr(got, k) for k in NB_ARRAYS}, single,
                     NB_ARRAYS, f"linear_streams NB {name}")
        check(st.n_chunks == -(-n // cfg.chunk_rows),
              f"linear_streams NB {name}: {st.n_chunks} chunks")
        nb_runs[name] = {"seconds": secs, "chunk_rows": cfg.chunk_rows,
                         **_ring_bound(st, cfg, f"NB {name}")}
    lr_single_stats, lr_stream_stats, st = {}, {}, PipelineStats()
    lr0, lr0_s = _timed(lambda: train_logistic_regression(
        x, y, c, reg=LR_REG, max_iters=LR_ITERS, device="cuda",
        stats=lr_single_stats, pipeline=off))
    lr1, lr1_s = _timed(lambda: train_logistic_regression(
        x, y, c, reg=LR_REG, max_iters=LR_ITERS, device="cuda",
        stats=lr_stream_stats, pipeline=auto, pipeline_stats=st))
    check(np.array_equal(lr0.weights, lr1.weights)
          and np.array_equal(lr0.intercept, lr1.intercept)
          and st.n_chunks == -(-n // auto.chunk_rows),
          "linear_streams: LR on the streamed matrix differs from LR on the "
          "single-shot upload")
    lr = {"single_shot_seconds": lr0_s, "streamed_seconds": lr1_s,
          "iterations": lr_stream_stats["iterations"],
          "lbfgs_seconds": lr_stream_stats["lbfgs_seconds"],
          "single_shot_lbfgs_seconds": lr_single_stats["lbfgs_seconds"],
          **_ring_bound(st, auto, "LR")}

    texts = text["texts"]
    label_values, yl = np.unique(np.asarray([str(v) for v in text["y"]]),
                                 return_inverse=True)
    td = tc.TrainingData(texts, yl.astype(np.int32), label_values)
    text_cfg = PipelineConfig(chunk_rows=auto.chunk_rows,
                              chunk_docs=STREAM_CHUNK_DOCS)
    check(text_cfg.enabled_for(len(texts), chunk=STREAM_CHUNK_DOCS,
                               device="cuda"), "the text stream's gate")

    def text_run(cfg, timings):
        ctx = WorkflowContext(app_name="text", device="cuda",
                              input_pipeline=cfg, bench_timings=timings)
        prep = tc.TextPreparator(tc.PreparatorParams(
            n_features=text["n_features"], ngram=text["ngram"]))
        pd = prep.prepare(ctx, td)
        return pd, tc.TextNBAlgorithm(tc.TextAlgorithmParams()).train(ctx, pd)

    (pd0, m0), text0_s = _timed(lambda: text_run(off, {}))
    timings: dict = {}
    (pd1, m1), text1_s = _timed(lambda: text_run(text_cfg, timings))
    check(pd0.coo is not None and pd1.coo is None and pd1.texts is not None,
          "the streamed text preparation did not defer its featurization")
    check(all(np.array_equal(getattr(m0.inner, k), getattr(m1.inner, k))
              for k in ("log_prior", "log_likelihood"))
          and np.array_equal(m0.vectorizer.idf, m1.vectorizer.idf),
          "linear_streams: the streamed text model differs from the "
          "one-shot prepare + train's")
    tst = PipelineStats(**{k: v for k, v in timings["pipeline"].items()
                           if k != "overlap_efficiency"})
    text_run_numbers = {"one_shot_seconds": text0_s,
                        "streamed_seconds": text1_s,
                        "chunk_docs": STREAM_CHUNK_DOCS,
                        "chunk_entries": text_cfg.chunk_rows,
                        **_ring_bound(tst, text_cfg, "text NB")}
    launched = launches()
    check(launched["total"] == 0, f"linear_streams launched {launched}")
    PATH_LAUNCHES["linear_streams"] = {"warp": 0, "wide": 0}
    emit("linear_streams", entities=n, attributes=d, classes=c,
         documents=len(texts), depth=auto.depth, workers=auto.workers,
         nb=nb_runs, lr=lr, text_nb=text_run_numbers,
         equal_to_single_shot="bit for bit", kernel_launches=launched)


# -- the Universal Recommender and Complementary Purchase templates ----------

#: bench_templates.py:184 config 5: users × items × buys × views
UR = (100_000, 20_000, 2_000_000, 8_000_000)
UR_ENGINE = os.path.join(ROOT, "templates", "universal-recommender",
                         "engine.json")
UR_FACTORY = ("incubator_predictionio_torch.models.universal_recommender."
              "UniversalRecommenderEngine")
#: the card-vs-CPU shape: users × items × events (a fifth of them buys)
UR_SMALL = (10_000, 2_000, 1_000_000)
#: the items of each pair whose count rows and indicators are held to
#: scipy and a float64 G²
CCO_SAMPLE = 64
#: the verbs' buys and views (config 5's first ones, over the full id
#: space; 2.5 % of its events), cut for the script's time: pio train reads
#: the log through find_batch, a Python object per event (2,000,000 events
#: took 66.9 s end to end on one H100 host, 55.3 s of it the read); half
#: that (1.25 %) since the slab-gang phases needed the time, half again
#: (0.625 %) since the CCO gang and serving-mesh phases did
UR_LOG = (12_500, 50_000)
UR_CATEGORIES = 20
#: the share of items with an availableDate / expireDate window (the
#: window below; before it, after it and without a currentDate they are
#: hidden)
UR_DATED_SHARE = 0.05
UR_AVAILABLE, UR_EXPIRE = "2024-06-01T00:00:00Z", "2024-09-01T00:00:00Z"
UR_QUERIES = 56
UR_ID_SEED = 12
#: bench_templates.py:262 config 7: shoppers × items × buys over 30 days
CP = (200_000, 10_000, 2_000_000)
CP_ENGINE = os.path.join(ROOT, "templates", "complementary-purchase",
                         "engine.json")
CP_FACTORY = ("incubator_predictionio_torch.models.complementary_purchase."
              "ComplementaryPurchaseEngine")
#: the verbs' buys (the first of config 7's; 200,000 before the script's
#: time needed a cut; at 50,000 fewer than CP_QUERIES baskets hold two
#: items), and the basket queries
CP_LOG_BUYS = 100_000
CP_QUERIES = 30
#: pio eval's shoppers: 4 buys each in one basket (≈ 500 buys; 250
#: shoppers until the linear gang and stream phases needed the time)
CP_EVAL_SHOPPERS = 125
#: cp_gang's PIO_UR_FULL_MATRIX_ELEMS: below I² of the verbs' catalog
#: (≈ 10,000 items), so the gang takes the striped path
CP_GANG_CAP = 10_000_000


def tf32_peak() -> float:
    """Dense TF32 tensor-core FLOP/s from the data sheets (half the
    sparse rates): H100 SXM 494.7 T, PCIe 378 T, NVL 417.5 T."""
    return {"H100 PCIe": 378e12, "H100 NVL": 417.5e12}.get(
        peak_rates()[2], 494.7e12)


def _ur_events() -> dict:
    """bench_ur's draws (seed 4): users uniform, items skewed to low ids,
    the buys first, then the views."""
    n_users, n_items, n_buy, n_view = UR
    rng = np.random.default_rng(4)

    def synth(n):
        uu = rng.integers(0, n_users, n).astype(np.int32)
        ii = (n_items * rng.random(n) ** 2).astype(np.int32)
        return uu, np.minimum(ii, n_items - 1)

    return {"buy": synth(n_buy), "view": synth(n_view)}


def _binary(u, i, n_rows: int, n_items: int):
    """The 0/1 row × item matrix of (u, i) pairs (scipy CSR)."""
    import scipy.sparse as sp

    m = sp.csr_matrix((np.ones(len(u)), (u, i)), shape=(n_rows, n_items))
    m.data[:] = 1.0  # duplicates were summed
    return m


def _host_g2(c: np.ndarray, n_i, n_j, n_total: int, rows) -> np.ndarray:
    """Dunning's G² in float64 of count rows ``c`` [r, I] (``rows``: their
    item ids), with the reference's masks: no score without counts, none
    on the diagonal."""
    def xlogx(x):
        return np.where(x > 0, x * np.log(np.maximum(x, 1e-300)), 0.0)

    def ent(a, b):
        return xlogx(a + b) - xlogx(a) - xlogx(b)

    k11 = c
    k12 = np.maximum(np.asarray(n_i)[rows][:, None] - c, 0)
    k21 = np.maximum(np.asarray(n_j)[None, :] - c, 0)
    k22 = np.maximum(n_total - k11 - k12 - k21, 0)
    g = 2 * (ent(k11 + k12, k21 + k22) + ent(k11 + k21, k12 + k22)
             - (xlogx(k11 + k12 + k21 + k22) - xlogx(k11) - xlogx(k12)
                - xlogx(k21) - xlogx(k22)))
    g = np.where(c > 0, np.maximum(g, 0), 0.0)
    g[np.arange(len(rows)), rows] = 0.0
    return g


def g2_tol(n: int) -> float:
    """The G² tolerance of the CCO parity rule: 2e-6·N·ln N (the float32
    G² of N users differs between two correct implementations by up to
    ≈ 6.5e-7·N·ln N)."""
    return 2e-6 * n * np.log(max(n, 2))


def _topk_rule(idx, score, g: np.ndarray, tol: float, what: str) -> float:
    """The top-k rule against host G² rows ``g`` (a -1 slot scores 0): the
    sorted scores within ``tol`` of the host's top-k, and every kept index
    scored by the host at least the host's k-th minus ``tol``. Returns the
    largest sorted-score gap."""
    k = idx.shape[1]
    got = np.sort(np.where(idx >= 0, score, 0.0), axis=1)[:, ::-1]
    want = -np.sort(-g, axis=1)[:, :k]
    gap = float(np.abs(got - want).max())
    check(gap <= tol, f"{what}: sorted scores {gap} from the host's > {tol}")
    rows, slots = np.nonzero(idx >= 0)
    check(bool((g[rows, idx[rows, slots]] >= want[rows, k - 1] - tol).all()),
          f"{what}: a kept index scores below the host's k-th")
    return gap


def _sampled_counts(counts: torch.Tensor, primary, secondary, n_rows: int,
                    n_items: int, rows, model_ind, what: str) -> dict:
    """Count rows ``rows`` of the card's [I, I] ``counts`` against the
    scipy product of the deduped pairs, exactly, and the model's
    indicator rows against a float64 G² of those counts (top-k rule)."""
    a = _binary(*primary, n_rows, n_items)
    b = a if secondary is primary else _binary(*secondary, n_rows, n_items)
    want = (a[:, rows].T @ b).toarray()
    got = counts[torch.from_numpy(rows).to(counts.device)].cpu().numpy()
    check(np.array_equal(got, want), f"{what}: sampled counts differ "
          f"from scipy's by {float(np.abs(got - want).max())}")
    g = _host_g2(want, np.asarray(a.sum(axis=0))[0],
                 np.asarray(b.sum(axis=0))[0], n_rows, rows)
    gap = _topk_rule(model_ind.idx[rows], model_ind.score[rows], g,
                     g2_tol(n_rows), what)
    return {"rows": len(rows), "max_count": float(want.max()),
            "topk_score_gap": gap, "tol": g2_tol(n_rows)}


def _counts_bound(timings: dict, n_items: int, u_chunk: int) -> dict:
    """The counts' operations (one dense [u_chunk, I]ᵀ × [u_chunk, I] GEMM
    per range and pair, as the port runs them), achieved rate and bound at
    the dense TF32 peak."""
    ops = 2.0 * n_items * n_items * u_chunk * timings["gemms"]
    peak = tf32_peak()
    return {"ops": ops, "ops_per_s": ops / (timings["counts_ms"] / 1e3),
            "tf32_peak": peak,
            "share_of_peak": ops / peak / (timings["counts_ms"] / 1e3),
            "bound_ms": ops / peak * 1e3, "bound_by": "operations"}


def _g2_bound(timings: dict, pairs: int, n_items: int, k: int) -> dict:
    """G² + top-k bytes bound: each pair's [I, I] float32 counts and n_i,
    n_j read once, the [I, K] scores and indices written once."""
    bw = peak_rates()[0]
    n_bytes = pairs * (n_items * n_items * 4 + 2 * n_items * 4
                       + n_items * k * 8)
    return {"bytes": n_bytes, "bound_ms": n_bytes / bw * 1e3,
            "bound_by": "bytes",
            "share_of_bound": n_bytes / bw * 1e3 / timings["g2_topk_ms"]}


def _counts_route_ab(events: dict, n_users: int, n_items: int,
                     dev=torch.device("cuda")) -> dict:
    """One pair's counts (buy → view) by the port's route (float32 slabs,
    TF32 GEMMs into the float32 accumulator) and by int8 slabs through
    ``torch._int_mm`` into int32, one product per range added to an int32
    accumulator: device ms of each, in turns (tf32, int8, int8, tf32), and
    the two equal."""
    prim, secs, _, _ = llr._fused_layout(
        *events["buy"], {"view": events["view"]}, n_users, n_items, 2048,
        dev, llr._Clock(dev, None))
    p, s = prim[0], secs[0][0]

    def tf32():
        c = torch.zeros((n_items, n_items), device=dev)
        llr._accumulate([c], p, [s], n_items)
        return c

    def int8():
        c = torch.zeros((n_items, n_items), dtype=torch.int32, device=dev)
        bp = torch.empty((p.rows + 1) * n_items, dtype=torch.int8,
                         device=dev)
        bs = torch.empty_like(bp)
        for r in range(p.flat.shape[0]):
            ap = llr._slab(bp, p.flat[r], p.rows, n_items)
            a2 = llr._slab(bs, s.flat[r], s.rows, n_items)
            c += torch._int_mm(ap.t().contiguous(), a2)
        return c

    times: dict = {"tf32": [], "int8": []}
    got = {}
    with torch.no_grad():
        for route in ("tf32", "int8", "int8", "tf32"):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            got[route] = (tf32 if route == "tf32" else int8)()
            e1.record()
            torch.cuda.synchronize()
            times[route].append(e0.elapsed_time(e1))
    check(torch.equal(got["tf32"], got["int8"].to(torch.float32)),
          "the int8 and TF32 counts differ")
    ops = 2.0 * n_items * n_items * p.rows * p.flat.shape[0]
    return {"pair": "buy->view", "ms": times,
            "tf32_ops_per_s": ops / (min(times["tf32"]) / 1e3),
            "int8_ops_per_s": ops / (min(times["int8"]) / 1e3)}


def _ur_train(events: dict, n_users: int, n_items: int) -> tuple:
    """URAlgorithm.train at maxCorrelatorsPerItem 50 on the card (the
    engine's own params parsing): (model, seconds, timings)."""
    engine = universal_recommender.UniversalRecommenderEngine()()
    _, _, algos, _ = engine.make_components(EngineParams.from_json(
        {"algorithms": [{"name": "ur", "params": {
            "appName": "bench", "maxCorrelatorsPerItem": 50}}]}))
    td = universal_recommender.TrainingData(
        events, IdentityBiMap(n_users), IdentityBiMap(n_items), {})
    ctx = WorkflowContext(app_name="bench")
    ctx.bench_timings = {}
    model, seconds = _timed(lambda: algos[0][1].train(ctx, td))
    return model, seconds, ctx.bench_timings


def phase_universal_recommender() -> None:
    """bench_templates.py config 5 through the Universal Recommender's
    URAlgorithm.train on the card (the fused path: buy → buy, the
    self-pair, and buy → view), twice: CCO_SAMPLE items of each pair whose
    count rows equal scipy's products of the deduped pairs and whose
    indicators meet the top-k rule against a float64 G²; the striped path
    (PIO_UR_FULL_MATRIX_ELEMS below 20,000²) bit-identical; the card
    against the CPU at UR_SMALL (equal counts, both under the top-k rule);
    the counts' TF32 route against int8; score_user's time. No solve
    kernel launches."""
    n_users, n_items, n_buy, n_view = UR
    events = _ur_events()
    reset_launches()
    model, cold_s, cold = _ur_train(events, n_users, n_items)
    model, warm_s, tm = _ur_train(events, n_users, n_items)
    launched = launches()
    check(launched["total"] == 0, f"the UR train launched {launched}")
    PATH_LAUNCHES["universal_recommender"] = {"warp": 0, "wide": 0}
    check(tm["path"] == cold["path"] == "fused" and tm["heavy_users"] == 0,
          f"the UR train took the {tm['path']} path")

    secs = {"buy": events["buy"], "view": events["view"]}
    counts = llr.cooccurrence_counts(*events["buy"], secs, n_users, n_items,
                                     device="cuda")
    rows = np.sort(np.random.default_rng(41).choice(n_items, CCO_SAMPLE,
                                                    replace=False))
    sampled = {name: _sampled_counts(counts[name], events["buy"],
                                     events[name], n_users, n_items, rows,
                                     model.indicators[name], f"UR {name}")
               for name in secs}
    del counts

    os.environ["PIO_UR_FULL_MATRIX_ELEMS"] = str(n_items * n_items - 1)
    striped_tm: dict = {}
    striped, striped_s = _timed(lambda: llr.cco_indicators_multi(
        *events["buy"], secs, n_users, n_items, 50, device="cuda",
        timings=striped_tm))
    del os.environ["PIO_UR_FULL_MATRIX_ELEMS"]
    check(striped_tm["path"] == "per_pair_striped",
          f"the capped UR train took {striped_tm['path']}")
    for name in secs:
        check(np.array_equal(striped[name].idx, model.indicators[name].idx)
              and np.array_equal(striped[name].score,
                                 model.indicators[name].score),
              f"UR {name}: the striped path differs from the fused")

    ab = _counts_route_ab(events, n_users, n_items)

    # the card against the CPU at a reduced shape
    su, si, sn = UR_SMALL
    rng = np.random.default_rng(43)
    u = rng.integers(0, su, sn).astype(np.int32)
    i = np.minimum((si * rng.random(sn) ** 2).astype(np.int32), si - 1)
    nb = sn // 5
    small = {"buy": (u[:nb], i[:nb]), "view": (u[nb:], i[nb:])}
    small_counts = {dev: llr.cooccurrence_counts(*small["buy"], small, su,
                                                 si, device=dev)
                    for dev in ("cuda", "cpu")}
    small_ind = {dev: llr.cco_indicators_multi(*small["buy"], small, su, si,
                                               50, device=dev)
                 for dev in ("cuda", "cpu")}
    all_rows = np.arange(si)
    card_vs_cpu = {}
    for name in small:
        check(torch.equal(small_counts["cuda"][name].cpu(),
                          small_counts["cpu"][name]),
              f"UR {name}: the card's counts differ from the CPU's")
        c = small_counts["cpu"][name].numpy().astype(np.float64)
        a = _binary(*small["buy"], su, si)
        b = _binary(*small[name], su, si)
        g = _host_g2(c, np.asarray(a.sum(axis=0))[0],
                     np.asarray(b.sum(axis=0))[0], su, all_rows)
        gaps = {dev: _topk_rule(ind[name].idx, ind[name].score, g,
                                g2_tol(su), f"UR small {name} {dev}")
                for dev, ind in small_ind.items()}
        card_vs_cpu[name] = {
            "counts_equal": True, "topk_score_gap": gaps,
            "same_indices": float((small_ind["cuda"][name].idx
                                   == small_ind["cpu"][name].idx).mean()),
            "max_score_diff": float(np.abs(small_ind["cuda"][name].score
                                           - small_ind["cpu"][name].score)
                                    .max())}
    del small_counts

    membership = {n: (np.random.default_rng(44).random(n_items) < 1e-3)
                  .astype(np.float32) for n in secs}
    boost = np.ones(n_items, np.float32)
    exclude = np.zeros(n_items, bool)

    def score():
        return llr.score_user([(model.indicators[n], membership[n], 1.0)
                               for n in secs], 20, exclude=exclude,
                              item_boost=boost, device="cuda")

    score_ms = loop_ms(score, 50)
    sharded = _ur_sharded_check(model, events, n_items)
    n_events = n_buy + n_view
    emit("universal_recommender", users=n_users, items=n_items, buys=n_buy,
         views=n_view, max_correlators=50, pairs=list(secs),
         train_seconds={"cold": cold_s, "warm": warm_s},
         events_per_s=n_events / warm_s, timings={"cold": cold, "warm": tm},
         counts=_counts_bound(tm, n_items, 2048),
         g2_topk=_g2_bound(tm, len(secs), n_items, 50),
         sampled=sampled, striped_bit_identical=True,
         striped_seconds=striped_s, striped_timings=striped_tm,
         counts_route_ab=ab, card_vs_cpu={"shape": UR_SMALL, **card_vs_cpu},
         score_user_ms=score_ms, serving_sharded=sharded,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         kernel_launches=launched)


def _ur_sharded_check(model, events: dict, n_items: int) -> dict:
    """Config 5's indicators served host-sharded (UR_SHARD_ROWS rows per
    shard) for UR_SHARDED_USERS users with history: every answer
    bit-identical to the flat score_user's, under the query rules (the
    user's buys excluded, a boost on a fifth of the items)."""
    from incubator_predictionio_torch.models._sharded_serving import (
        ShardedIndicators,
    )

    _shard_rows(UR_SHARD_ROWS)
    try:
        si = ShardedIndicators(model.indicators, n_items, model.device)
    finally:
        _shard_rows(None)
    check(si.layout == "host", "UR: not host-sharded")
    n_shards = next(iter(si._sharded.values())).n_shards
    rng = np.random.default_rng(64)
    buyers = np.unique(events["buy"][0])
    users = rng.choice(buyers, UR_SHARDED_USERS, replace=False)
    boost = np.where(rng.random(n_items) < 0.2, 2.0, 1.0).astype(np.float32)
    host_ms, flat_ms = [], []
    for user in users:
        member = {}
        for name, (uu, ii) in events.items():
            m = np.zeros(n_items, np.float32)
            m[ii[uu == user]] = 1.0
            member[name] = m
        exclude = member["buy"] > 0
        entries = [(n, member[n], 1.0) for n in ("buy", "view")]
        t0 = time.perf_counter()
        want = llr.score_user([(model.indicators[n], m, b)
                               for n, m, b in entries], 20, exclude=exclude,
                              item_boost=boost, device="cuda")
        flat_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        got = si.score_user(entries, 20, exclude, boost)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(got[1], want[1])
              and np.array_equal(got[0], want[0]),
              f"UR user {user}: the host-sharded answer differs from flat")
    return {"users": len(users), "shards": n_shards,
            "rows_per_shard": UR_SHARD_ROWS, "bit_identical": len(users),
            "flat_ms": _percentiles(flat_ms), "host_ms": _percentiles(host_ms)}


def _ur_item_lines(cats, dated) -> bytes:
    """One ``$set`` per item id before every buy and view: its category,
    and on the dated items the availableDate / expireDate window, byte for
    byte what insert_batch writes."""
    times = T0_MS - len(cats) + np.arange(len(cats))
    iso = np.datetime_as_string(times.astype("datetime64[ms]"),
                                unit="ms").tolist()
    window = (f', "availableDate": "{UR_AVAILABLE}", '
              f'"expireDate": "{UR_EXPIRE}"')
    return "".join([
        f'{{"eventId": "{UR_ID_SEED:08x}{j:024x}", "event": "$set", '
        f'"entityType": "item", "entityId": "i{j}", "properties": '
        f'{{"categories": ["c{c}"]{window if d else ""}}}, '
        f'"eventTime": "{t}Z", "creationTime": "{CREATED_ISO}"}}\n'
        for j, (c, d, t) in enumerate(zip(np.asarray(cats).tolist(),
                                          np.asarray(dated).tolist(), iso))
    ]).encode()


def _epoch_s(iso: str) -> float:
    return calendar.timegm(time.strptime(iso[:19], "%Y-%m-%dT%H:%M:%S"))


def _host_served(inds: dict, memberships: dict, boost, exclude):
    """The host scorer of a served answer: per event type the gather+dot
    of the persisted indicators against the membership, float64, times
    the boost, the excluded items at -inf."""
    total = np.zeros(len(boost))
    for name, (idx, score) in inds.items():
        m = memberships[name].astype(np.float64)
        total += (np.asarray(score, np.float64)
                  * np.where(idx >= 0, m[np.maximum(idx, 0)], 0.0)).sum(1)
    return np.where(exclude, -np.inf, total * boost)


def _hold_served(res: dict, items: dict, total, num: int,
                 counts: dict) -> None:
    """An answer against the host's scores: the same count, each score
    within 1e-5 relative of the host's for that item and for that rank,
    and the host's order wherever its neighbouring scores differ by more
    than 1e-5 relative (the answers at a near tie are counted)."""
    order = np.lexsort((np.arange(len(total)), -total))[:num]
    want = order[np.isfinite(total[order]) & (total[order] > 0)]
    got = np.array([items[e["item"]] for e in res["itemScores"]], np.int64)
    scores = np.array([e["score"] for e in res["itemScores"]])
    check(len(got) == len(want), f"{len(got)} answers, the host {len(want)}")
    if not len(want):
        counts["empty"] += 1
        return
    check(np.allclose(scores, total[got], rtol=1e-5, atol=0)
          and np.allclose(scores, total[want], rtol=1e-5, atol=0),
          "served scores differ from the host's")
    s = total[order][:len(want)]
    close = np.isclose(s[1:], s[:-1], rtol=1e-5, atol=0)
    distinct = np.ones(len(s), bool)
    distinct[1:] &= ~close
    distinct[:-1] &= ~close
    check(np.array_equal(got[distinct], want[distinct]),
          f"answer {got.tolist()} != host {want.tolist()}")
    counts["exact" if np.array_equal(got, want) else "near_ties"] += 1


def _ur_queries(users, head_items, cold: int) -> list:
    """The query mix: user-based; item-based; user + item; a category
    filter (bias -1) and a category boost (bias 2); blacklistItems; a
    currentDate inside the dated items' window and one before it; and
    cold users (the popularity backfill), one with a category filter."""
    rng = np.random.default_rng(45)
    out = []
    for j, a in enumerate(users):
        item = f"i{int(rng.choice(head_items))}"
        cat = f"c{int(rng.integers(0, UR_CATEGORIES))}"
        q = {"user": f"u{a}", "num": 20 if j % 4 == 0 else 10}
        kind = j % 8
        if kind == 1:
            q = {"item": item, "num": 10}
        if kind == 2:
            q["item"] = item
        if kind in (3, 4):
            q["fields"] = [{"name": "categories", "values": [cat],
                            "bias": -1 if kind == 3 else 2}]
        if kind == 5:
            q["blacklistItems"] = [f"i{int(x)}" for x in
                                   rng.choice(head_items, 50)]
        if kind == 6:
            q["currentDate"] = "2024-07-01T00:00:00Z"
        if kind == 7:
            q["currentDate"] = "2024-03-01T00:00:00Z"
        out.append(q)
    for j in range(cold):
        q = {"user": f"nobody{j}", "num": 10}
        if j == 0:
            q["fields"] = [{"name": "categories", "values": ["c3"],
                            "bias": -1}]
        out.append(q)
    return out


def _ur_check(stored: dict, history: dict, cats, dated):
    """A host check of a UR answer on the persisted model: the user's
    history from the generated arrays, the query items, the exclusions
    (blacklistItems, the query items, the user's buys, the dated items
    outside their window at currentDate or now), the category rules; the
    popularity ranking (numpy's argsort, as the template) for a user with
    neither."""
    stored = universal_recommender.nest(stored)
    items = stored["items"]
    n = len(items)
    item_of = np.empty(n, np.int64)
    item_of[list(items.values())] = [int(k[1:]) for k in items]
    cat_of, dated_of = np.asarray(cats)[item_of], np.asarray(dated)[item_of]
    inds = {name: (v["idx"], v["score"])
            for name, v in stored["indicators"].items()}
    pop = np.asarray(stored["popularity"], np.float32)
    counts = {"exact": 0, "near_ties": 0, "popularity": 0, "empty": 0}

    def check_answer(q: dict, res: dict) -> None:
        mem = {name: np.zeros(n, np.float32) for name in inds}
        for name, its in history.get(q.get("user"), {}).items():
            for x in its:
                j = items.get(f"i{x}")
                if j is not None:
                    mem[name][j] = 1.0
        q_items = [x for x in [q.get("item")] if x]
        for x in q_items:
            for name in mem:
                if x in items:
                    mem[name][items[x]] = 1.0
        exclude = mem["buy"] > 0
        for x in q_items + q.get("blacklistItems", []):
            if x in items:
                exclude[items[x]] = True
        now = (_epoch_s(q["currentDate"]) if "currentDate" in q
               else time.time())
        exclude |= dated_of & ((now < _epoch_s(UR_AVAILABLE))
                               | (now > _epoch_s(UR_EXPIRE)))
        boost = np.ones(n, np.float32)
        for f in q.get("fields", []):
            match = np.isin(cat_of, [int(c[1:]) for c in f["values"]])
            if f["bias"] < 0:
                exclude |= ~match
            else:
                boost = np.where(match, boost * f["bias"], boost)
        if not any(m.any() for m in mem.values()):
            scores = np.where(exclude, -np.inf, pop * boost)
            order = np.argsort(-scores)[:q["num"]]
            want = [{"item": f"i{item_of[j]}", "score": float(scores[j])}
                    for j in order
                    if np.isfinite(scores[j]) and scores[j] > 0]
            check(res["itemScores"] == want,
                  f"cold answer {res} != host popularity {want}")
            counts["popularity"] += 1
            return
        _hold_served(res, items, _host_served(inds, mem, boost, exclude),
                     q["num"], counts)

    return check_answer, counts


def phase_universal_recommender_jsonl(workdir: str) -> None:
    """UR_LOG of config 5's buys and views (its first ones, on the full
    id space, distinct shuffled times) and one $set per item
    (UR_CATEGORIES categories; an availableDate / expireDate window on
    UR_DATED_SHARE of the items) written as a JSONL log → pio app new →
    pio train with templates/universal-recommender/engine.json, its
    factory rewritten to the port → pio eventserver + pio deploy →
    UR_QUERIES queries and cold users, every answer held to a host scorer
    on the persisted model with the history from the generated arrays;
    query latency split into the history read, the scoring and the
    rest."""
    n_users, n_items, n_buy, n_view = UR
    events = _ur_events()
    nb, nv = UR_LOG
    u = np.concatenate([events["buy"][0][:nb], events["view"][0][:nv]])
    i = np.concatenate([events["buy"][1][:nb], events["view"][1][:nv]])
    buy = np.arange(nb + nv) < nb
    times = T0_MS + np.random.default_rng(46).permutation(nb + nv)
    cats = np.random.default_rng(47).integers(0, UR_CATEGORIES, n_items)
    dated = np.random.default_rng(48).random(n_items) < UR_DATED_SHARE
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio_ur")
    env = _jsonl_env(base)
    _verb(["app", "new", "ur"], env, cwd)
    engine_json = _template_engine(UR_ENGINE, UR_FACTORY, "ur", cwd)
    engine_json["algorithms"][0]["params"]["appName"] = "ur"
    with open(os.path.join(cwd, "engine.json"), "w", encoding="utf-8") as fh:
        json.dump(engine_json, fh)
    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    t0 = time.perf_counter()
    _write_log(log_path, u, i, buy, times, lines=_ecommerce_lines)
    with open(log_path, "ab") as fh:
        fh.write(_ur_item_lines(cats, dated))
    write_s = time.perf_counter() - t0
    rows = np.sort(np.random.default_rng(49).choice(nb + nv, 1_000,
                                                    replace=False))
    _hold_lines(b"".join(_ecommerce_lines(u[k:k + 1], i[k:k + 1],
                                          buy[k:k + 1], times[k:k + 1],
                                          int(k)) for k in rows)
                + _ur_item_lines(cats[:300], dated[:300]), cwd)

    reset_launches()
    trained = _linear_train_verb(env, cwd, "universal_recommender_jsonl")
    PATH_LAUNCHES["universal_recommender_jsonl"] = {"warp": 0, "wide": 0}
    tm = trained["timings"]
    check(tm["ratings_read"] == nb + nv and tm["path"] == "fused",
          f"the UR train read {tm['ratings_read']} events ({tm['path']})")
    stored = _persisted(env, trained["engineInstanceId"])
    check(stored["indicator_names"] == ["buy", "view"]
          and stored["indicators/0/idx"].shape == (
              len(stored["items"]), 50)
          and len(stored["item_dates"]) == int(dated.sum()),
          "the persisted UR model lacks its indicators or dates")

    qusers = np.random.default_rng(50).choice(np.unique(u), UR_QUERIES,
                                              replace=False)
    history = {}
    for a in qusers:
        sel = u == a
        history[f"u{a}"] = {"buy": set(i[sel & buy].tolist()),
                            "view": set(i[sel & ~buy].tolist())}
    queries = _ur_queries(qusers, np.arange(n_items // 10), 4)
    check_answer, counts = _ur_check(stored, history, cats, dated)
    split_out = os.path.join(cwd, "query_split.json")
    client_ms = []
    # ur_gang: the same train by a gang of two on the same log, started
    # before the servers so that it trains while they boot; the queries
    # wait for it to end
    gang_run = _GangTrain(env, cwd)
    t0 = time.perf_counter()
    events_srv = _Served(["eventserver", "--ip", "127.0.0.1"], env, cwd)
    srv = _timed_deploy(env, cwd, split_out, "universal_recommender",
                        "URAlgorithm", {"history_s": "URModel._history",
                                        "score_s": "incubator_predictionio_"
                                        "torch.models._sharded_serving:"
                                        "ShardedIndicators.score_user"})
    try:
        with gang_run, events_srv, srv:
            ready_s = time.perf_counter() - t0
            gang = gang_run.result()
            check(srv.info["engineInstanceId"] == trained["engineInstanceId"],
                  f"deployed {srv.info}")
            conn = srv.connect()
            for q in queries:
                status, res, ms = srv.request("POST", "/queries.json", q,
                                              conn)
                check(status == 200, f"query {status}: {res}")
                check_answer(q, res)
                client_ms.append(ms)
            conn.close()
    finally:  # a process whose start failed is stopped here
        for proc in (events_srv.proc, srv.proc, gang_run.proc):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(split_out, encoding="utf-8") as fh:
        records = json.load(fh)
    check(counts["popularity"] == 4 and counts["exact"] > 0,
          f"UR answers {counts}")
    emit("universal_recommender_jsonl", events=nb + nv, buys=nb, views=nv,
         users=len(stored["users"]), items=len(stored["items"]),
         categories=UR_CATEGORIES, dated_items=int(dated.sum()),
         reduced=(f"the first {nb} buys and {nv} views of config 5's "
                  f"{n_buy + n_view} events: pio train reads the log "
                  "through find_batch, a Python object per event"),
         log_bytes=os.path.getsize(log_path), log_write_seconds=write_s,
         train_seconds_end_to_end=trained["wall_seconds"],
         train_seconds_run_train=trained["seconds"],
         read_seconds=tm["read_seconds"], timings=tm,
         events_per_s_end_to_end=(nb + nv) / trained["wall_seconds"],
         deploy_ready_seconds=ready_s, queries=len(queries), answers=counts,
         query_ms=_split(client_ms[1:], records[1:],
                         {"history_read": "history_s",
                          "scoring": "score_s"}),
         kernel_launches=trained["kernel_launches"],
         deploy_booted_beside="the ur_gang train")
    n_ur = len(stored["items"])
    PATH_LAUNCHES["ur_gang"] = {"warp": 0, "wide": 0}
    emit("ur_gang", events=nb + nv, items=n_ur,
         **_cco_gang(env, gang, stored, trained, "fused", 2,
                     4 * n_ur * n_ur, "ur_gang"),
         reckoned=("two pairs x I^2 x 4 B all-reduced per rank, each "
                   "[I, I] in turn; every rank reads the merged log"),
         booted_beside="the universal_recommender_jsonl servers")
    shutil.rmtree(cwd)


def _cp_events() -> tuple:
    """bench_complementary's draws (seed 7): shoppers uniform, items skewed
    to low ids, times uniform over 30 days (µs)."""
    n_shoppers, n_items, nnz = CP
    rng = np.random.default_rng(7)
    u = rng.integers(0, n_shoppers, nnz).astype(np.int32)
    i = np.minimum((n_items * rng.random(nnz) ** 2).astype(np.int32),
                   n_items - 1)
    t = rng.integers(0, 30 * 86_400 * 1_000_000, nnz, dtype=np.int64)
    return u, i, t


def _cp_eval_lines(first: int) -> tuple:
    """pio eval's buys: CP_EVAL_SHOPPERS shoppers, each one basket of three
    items of one of 25 groups and a noise item, a minute apart (as
    tests/test_complementary_purchase.py's baskets)."""
    rng = np.random.default_rng(51)
    u, i, t = [], [], []
    for s in range(CP_EVAL_SHOPPERS):
        group = s % 25
        basket = list(rng.choice(4, 3, replace=False) + 4 * group)
        basket.append(100 + int(rng.integers(0, 200)))
        for k, item in enumerate(basket):
            u.append(s)
            i.append(int(item))
            t.append(T0_MS + s * 3_600_000 + k * 60_000)
    u, i, t = (np.asarray(a) for a in (u, i, t))
    return _ecommerce_lines(u, i, np.ones(len(u), bool), t, first), len(u)


def phase_complementary_purchase(workdir: str) -> None:
    """bench_templates.py config 7 through the Complementary Purchase
    template: in process at full width (ComplementaryAlgorithm.train on
    the card, basketWindowSecs 3600, 20 correlators): the basket count
    equal to the host's form_baskets, CCO_SAMPLE count rows equal to
    scipy's, their indicators under the top-k rule against a float64 G²;
    then the first CP_LOG_BUYS buys as a JSONL log → pio train (the
    template's engine.json, factory rewritten) → pio deploy → CP_QUERIES
    basket queries held to a host scorer of the persisted indicators; then
    pio eval of ComplementaryEvaluation / ComplementaryParamsList on
    ≈ 500 basket buys on the card and, beside it, on the CPU (scores
    within 0.02, the same best where the top two differ by more than
    0.05). cp_gang's train starts while the deploy boots. No solve kernel
    launches."""
    n_shoppers, n_items, nnz = CP
    u, i, t = _cp_events()
    engine = complementary_purchase.ComplementaryPurchaseEngine()()
    with open(CP_ENGINE, encoding="utf-8") as fh:
        cp_params = json.load(fh)["algorithms"][0]
    _, _, algos, _ = engine.make_components(EngineParams.from_json(
        {"algorithms": [cp_params]}))
    td = complementary_purchase.TrainingData(
        u, i, t, IdentityBiMap(n_shoppers), IdentityBiMap(n_items))
    reset_launches()
    ctx = WorkflowContext(app_name="bench")
    ctx.bench_timings = {}
    model, train_s = _timed(lambda: algos[0][1].train(ctx, td))
    tm = ctx.bench_timings
    baskets, form_s = _timed(lambda: complementary_purchase.form_baskets(
        u, t, cp_params["params"]["basketWindowSecs"] * 1_000_000))
    n_baskets = int(baskets.max()) + 1
    check(tm["baskets"] == n_baskets and tm["path"] == "full",
          f"CP trained {tm['baskets']} baskets ({tm['path']}), the host "
          f"formed {n_baskets}")
    counts = llr.cooccurrence_counts(baskets, i, {"b": (baskets, i)},
                                     n_baskets, n_items, device="cuda")["b"]
    rows = np.sort(np.random.default_rng(52).choice(n_items, CCO_SAMPLE,
                                                    replace=False))
    pair = (baskets, i)
    sampled = _sampled_counts(counts, pair, pair, n_baskets, n_items, rows,
                              model.indicators, "CP")
    del counts
    k = model.indicators.max_correlators

    # through the verbs
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio_cp")
    env = _jsonl_env(base)
    _verb(["app", "new", "cp"], env, cwd)
    _template_engine(CP_ENGINE, CP_FACTORY, "cp", cwd)
    n_log = CP_LOG_BUYS
    times = T0_MS + t[:n_log] // 1_000
    log_path = os.path.join(base, "events", "pio_eventdata", "events_1.jsonl")
    with open(log_path, "wb") as fh:
        fh.write(_ecommerce_lines(u[:n_log], i[:n_log],
                                  np.ones(n_log, bool), times, 0))
    trained = _linear_train_verb(env, cwd, "complementary_purchase")
    vt = trained["timings"]
    check(vt["ratings_read"] == n_log and vt["path"] == "full",
          f"the CP train read {vt['ratings_read']} buys ({vt['path']})")
    stored = _persisted(env, trained["engineInstanceId"])
    items = stored["items"]
    inds = {"buy": (stored["idx"], stored["score"])}
    log_baskets = complementary_purchase.form_baskets(
        u[:n_log], times * 1_000, 3_600 * 1_000_000)
    answered = {"exact": 0, "near_ties": 0, "empty": 0}
    query_ms = []
    multi = np.random.default_rng(53).choice(
        np.flatnonzero(np.bincount(log_baskets) >= 2), CP_QUERIES,
        replace=False)
    # cp_gang: the same train by a gang of two with the accumulator capped
    # below I² (the striped path), training while the server boots
    n_cp = len(items)
    cap = CP_GANG_CAP
    check(n_cp * n_cp > cap, f"cp_gang: {n_cp}² items fit the cap {cap}")
    gang_run = _GangTrain(env | {"PIO_UR_FULL_MATRIX_ELEMS": str(cap)}, cwd)
    with gang_run, _Served(["deploy"], env, cwd) as srv:
        gang = gang_run.result()
        check(srv.info["engineInstanceId"] == trained["engineInstanceId"],
              f"deployed {srv.info}")
        conn = srv.connect()
        for b in multi:
            basket = sorted({f"i{x}" for x in i[:n_log][log_baskets == b]})
            q = {"items": basket[:-1], "num": 10}
            status, res, ms = srv.request("POST", "/queries.json", q, conn)
            check(status == 200, f"query {status}: {res}")
            known = [items[x] for x in q["items"] if x in items]
            member = np.zeros(len(items), np.float32)
            member[known] = 1.0
            _hold_served(res, items, _host_served(
                inds, {"buy": member}, np.ones(len(items)), member > 0),
                q["num"], answered)
            query_ms.append(ms)
        conn.close()
    check(answered["exact"] > 0, f"CP answers {answered}")

    # pio eval on the card and on the CPU
    eval_base = os.path.join(cwd, "pio_cp_eval")
    eval_env = _jsonl_env(eval_base)
    _verb(["app", "new", "cpeval"], eval_env, cwd)
    lines, n_eval = _cp_eval_lines(0)
    with open(os.path.join(eval_base, "events", "pio_eventdata",
                           "events_1.jsonl"), "wb") as fh:
        fh.write(lines)
    # the CPU sweep runs beside the card's, for the script's time
    with _EvalRun("complementary", eval_env, cwd, "cpu", "cpeval") as run:
        card = _eval_verb("complementary", eval_env, cwd, "cuda", "cpeval")
        cpu = run.result()
    check(card["kernel_launches"] == {"warp": 0, "wide": 0}
          and card["ranking_metrics"]["calls"] > 0,
          f"the CP sweep launched {card['kernel_launches']}")
    top = sorted(card["scores"], reverse=True)
    check(all(abs(a - b) <= 0.02 for a, b in zip(card["scores"],
                                                  cpu["scores"])),
          f"CP eval card {card['scores']} vs CPU {cpu['scores']}")
    check(top[0] - top[1] <= 0.05 or card["bestIndex"] == cpu["bestIndex"],
          f"CP best candidate {card['bestIndex']} on the card, "
          f"{cpu['bestIndex']} on the CPU")
    launched = launches()
    check(launched["total"] == 0, f"the CP phase launched {launched}")
    PATH_LAUNCHES["complementary_purchase"] = {"warp": 0, "wide": 0}
    emit("complementary_purchase", shoppers=n_shoppers, items=n_items,
         buys=nnz, baskets=n_baskets, max_correlators=k,
         train_seconds=train_s, form_baskets_seconds=form_s,
         events_per_s=nnz / train_s, timings=tm,
         counts=_counts_bound(tm, n_items, 2048),
         g2_topk=_g2_bound(tm, 1, n_items, k), sampled=sampled,
         verbs={"buys": n_log, "train_seconds_end_to_end":
                trained["wall_seconds"], "read_seconds": vt["read_seconds"],
                "timings": vt, "queries": len(multi), "answers": answered,
                "query_ms": _percentiles(query_ms[1:])},
         reduced=(f"the verbs on the first {n_log} of the {nnz} buys; pio "
                  f"eval on {n_eval} basket buys"),
         eval={"buys": n_eval, "card": card, "cpu": cpu},
         kernel_launches=launched, deploy_booted_beside="the cp_gang train")
    block = min(4096, n_cp)  # the template's item_block
    stripes = -(-n_cp // block)
    PATH_LAUNCHES["cp_gang"] = {"warp": 0, "wide": 0}
    emit("cp_gang", buys=n_log, items=n_cp, full_matrix_elems=cap,
         stripes=stripes,
         **_cco_gang(env, gang, stored, trained, "striped", stripes,
                     4 * block * n_cp, "cp_gang"),
         single_path=vt["path"],
         reckoned=("one [block, I] stripe all-reduced at a time; the "
                   "single-process train took the full path"),
         booted_beside="the complementary_purchase server")
    shutil.rmtree(cwd)


# -- host-sharded serving (ROADMAP item 4) -----------------------------------

#: the reference's million-item bracket (bench_query.py:461-497): catalog
#: sizes at rank 32, users and queries per point
SHARDED_SIZES = (10_000, 100_000, 1_000_000)
SHARDED_USERS, SHARDED_QUERIES = 500, 120
#: PIO_SERVE_SHARD_ITEMS = min(SHARD_ROWS_MAX, n_items // 8): 8 shards
SHARD_ROWS_MAX = 131_072
SHARDED_BATCH = 64
#: rows per shard for the ML-20M fold-in (7 shards) and config 5's UR
#: indicators (5 shards)
FOLD_IN_SHARD_ROWS = 4_096
UR_SHARD_ROWS = 4_096
UR_SHARDED_USERS = 200


def _shard_rows(rows) -> None:
    if rows:
        os.environ["PIO_SERVE_SHARD_ITEMS"] = str(rows)
    else:
        os.environ.pop("PIO_SERVE_SHARD_ITEMS", None)


def _als_deployment(uf: np.ndarray, itf: np.ndarray, rows, mode="auto"):
    """A Recommendation deployment of these factors on the card, its
    catalog made resident under PIO_SERVE_SHARD_ITEMS=rows (None: flat)."""
    engine, engine_json, _ = als_engine(RANK, ITERS, 0.01)
    engine_json["algorithms"][0]["params"]["shardedServing"] = mode
    model = ALSModel(ALSFactors(uf, itf, uf.shape[0], itf.shape[0]),
                     IdentityBiMap(uf.shape[0]), IdentityBiMap(itf.shape[0]),
                     device=resolve_device("cuda"))
    _shard_rows(rows)
    try:
        deployment = engine.prepare_deployment(
            WorkflowContext(device="cuda"), EngineParams.from_json(
                engine_json), [model_to_persisted(model)])
        deployment.models[0].warm_up()
    finally:
        _shard_rows(None)
    return deployment


def _http_answers(deployment, queries) -> tuple:
    """Every query over HTTP on one keep-alive connection: (answers,
    latencies ms without the first)."""
    server = EngineServer(deployment=deployment)
    host, port = server.start()
    conn = http.client.HTTPConnection(host, port, timeout=60)
    answers, lat = [], []
    try:
        for q in queries:
            status, res, ms = _post(conn, q)
            check(status == 200, f"query status {status}: {res}")
            answers.append(res)
            lat.append(ms)
    finally:
        conn.close()
        server.stop()
    return answers, lat[1:]


def _batch_peak(cat, uvs: np.ndarray, k: int):
    """(scores, indices, peak bytes above what was allocated before) of
    one batched call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s, i = cat.batch_top_k(uvs, k)
    torch.cuda.synchronize()
    return s, i, torch.cuda.max_memory_allocated() - base


def phase_serving_sharded_catalog(main: dict) -> None:
    """Host-sharded serving (PIO_SERVE_SHARD_ITEMS) against the flat
    catalog on the card: the reference's million-item bracket (10,000,
    100,000 and 1,000,000 items × rank 32, 500 users, 8 shards each)
    deployed through the engine server over HTTP once flat and once
    host-sharded, every host answer index- and score-identical to the flat
    one, the batch of 64 index-identical with its peak memory; then the
    main path's ML-20M model served with 7 shards, held to flat, the
    FOLD_IN batch folded into it (2 warp launches) and the rebuilt host
    catalog's answers held to the host top-k over the new factors; then
    an engine.json with "shardedServing": "always" trained and served."""
    rng = np.random.default_rng(61)
    points = []
    for n_items in SHARDED_SIZES:
        rows = min(SHARD_ROWS_MAX, n_items // 8)
        uf = rng.normal(size=(SHARDED_USERS, RANK)).astype(np.float32)
        itf = rng.normal(size=(n_items, RANK)).astype(np.float32)
        users = rng.integers(0, SHARDED_USERS, SHARDED_QUERIES)
        queries = [{"user": str(int(u)), "num": 10} for u in users]
        flat_dep = _als_deployment(uf, itf, None)
        host_dep = _als_deployment(uf, itf, rows)
        flat_cat = flat_dep.models[0].catalog()
        host_cat = host_dep.models[0].catalog()
        check(flat_cat.layout == "flat" and host_cat.layout == "host"
              and host_cat.n_shards == 8,
              f"layouts {flat_cat.layout} / {host_cat.layout} "
              f"({host_cat.n_shards} shards)")
        flat_ans, flat_ms = _http_answers(flat_dep, queries)
        host_ans, host_ms = _http_answers(host_dep, queries)
        check(host_ans == flat_ans,
              f"{n_items} items: a host-sharded answer differs from flat")
        for q, res in list(zip(queries, flat_ans))[:5]:
            check_user_answer(uf, itf, int(q["user"]), res)
        uv = uf[0]
        dev = {name: device_ms(lambda c=cat: c.top_k(uv, 10), 20)
               for name, cat in (("flat", flat_cat), ("host", host_cat))}
        loop = {name: loop_ms(lambda c=cat: c.top_k(uv, 10), 50)
                for name, cat in (("flat", flat_cat), ("host", host_cat))}
        uvs = uf[rng.integers(0, SHARDED_USERS, SHARDED_BATCH)]
        _, fi, flat_peak = _batch_peak(flat_cat, uvs, 10)
        _, hi, host_peak = _batch_peak(host_cat, uvs, 10)
        check(np.array_equal(fi, hi),
              f"{n_items} items: batched indices differ between layouts")
        points.append({
            "items": n_items, "rank": RANK, "shards": host_cat.n_shards,
            "rows_per_shard": rows, "queries": len(queries),
            "identical_answers": len(queries),
            "flat": {**_percentiles(flat_ms), "device_ms": dev["flat"],
                     "call_ms": loop["flat"],
                     "batch64_peak_bytes": flat_peak},
            "host": {**_percentiles(host_ms), "device_ms": dev["host"],
                     "call_ms": loop["host"],
                     "batch64_peak_bytes": host_peak}})
        del flat_dep, host_dep, flat_cat, host_cat
        torch.cuda.empty_cache()
    # NaN under the host layout at 10^6 items: NaN ranks above every
    # number, as in the flat sort (one shard with more NaN rows than k, a
    # NaN user vector); a pick past a shard's end would be a device-side
    # assert here
    from incubator_predictionio_torch.models._sharded_serving import (
        ShardedCatalog,
    )

    nan_rng = np.random.default_rng(62)
    n_items = SHARDED_SIZES[-1]
    itf = nan_rng.normal(size=(n_items, RANK)).astype(np.float32)
    itf[1000:1100] = np.nan
    itf[[7, n_items - 3]] = np.nan
    uvs = nan_rng.normal(size=(4, RANK)).astype(np.float32)
    uvs[1] = np.nan
    card = resolve_device("cuda")
    flat_cat = ShardedCatalog(itf, card)
    _shard_rows(min(SHARD_ROWS_MAX, n_items // 8))
    try:
        host_cat = ShardedCatalog(itf, card)
    finally:
        _shard_rows(None)
    check(host_cat.layout == "host", "the NaN catalog is not host-sharded")
    for uv in uvs:
        (hs, hi), (fs, fi) = host_cat.top_k(uv, 10), flat_cat.top_k(uv, 10)
        check(np.array_equal(hi, fi) and np.array_equal(hs, fs,
                                                        equal_nan=True),
              f"NaN scores: host {hi} {hs} vs flat {fi} {fs}")
    check(np.array_equal(host_cat.batch_top_k(uvs, 10)[1],
                         flat_cat.batch_top_k(uvs, 10)[1]),
          "NaN scores: batched indices differ between layouts")
    torch.cuda.synchronize()
    del flat_cat, host_cat
    torch.cuda.empty_cache()
    emit("serving_sharded_catalog", points=points,
         nan_rows={"items": n_items, "nan_rows": 102, "nan_users": 1,
                   "identical": True},
         source="bench_query.py:461-497 (10^4-10^6 items x rank 32, "
                "random factors, seed 61)")

    # the main path's ML-20M model, 7 shards, then a fold-in into it
    n_users, n_items, _ = ML20M
    model, algo = main["model"], main["algo"]
    flat = ALSModel(model.factors, model.users, model.items,
                    device=model.device)
    _shard_rows(FOLD_IN_SHARD_ROWS)
    try:
        host = ALSModel(model.factors, model.users, model.items,
                        device=model.device)
        shards = -(-n_items // FOLD_IN_SHARD_ROWS)  # 7 at ML-20M
        check(host.catalog().layout == "host"
              and host.catalog().n_shards == shards,
              f"ML-20M: {host.catalog().n_shards} shards")
        sample = np.random.default_rng(62).integers(0, n_users, 200)
        for u in sample:
            check(host.recommend_products(str(u), 10)
                  == flat.recommend_products(str(u), 10),
                  f"ML-20M user {u}: host answer differs from flat")
        new_users, new_items, n_events = FOLD_IN
        events = fold_in_events(n_users, n_items, new_users, new_items,
                                n_events - 5 * new_users - 4 * new_items,
                                seed=8)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folded = algo.fold_in(host, events)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
        got = launches()
        record("fold_in_sharded", got)
        check(got["warp"] == 2 == got["total"],
              f"sharded fold-in launches {got}")
        check(folded._sharded_cat is None, "the folded model kept a catalog")
        t0 = time.perf_counter()
        cat = folded.catalog()
        rebuild_s = time.perf_counter() - t0
        check(cat.layout == "host" and cat.n_items == n_items + new_items
              and cat.n_shards == -(-(n_items + new_items)
                                    // FOLD_IN_SHARD_ROWS),
              f"rebuilt catalog {cat.layout}, {cat.n_items} items, "
              f"{cat.n_shards} shards")
    finally:
        _shard_rows(None)
    uf, itf = folded.factors.user_factors, folded.factors.item_factors
    held = 0
    for user in ([n_users + j for j in range(0, new_users, 100)]
                 + [int(x) for x in sample[:20]]):
        res = {"itemScores": [{"item": it, "score": sc} for it, sc in
                              folded.recommend_products(str(user), 10)]}
        check_user_answer(uf, itf, user, res)
        held += 1
    new_item_hits = sum(
        int(it) >= n_items for j in range(0, new_users, 100)
        for it, _ in folded.recommend_products(str(n_users + j), 10))
    emit("serving_sharded_fold_in", items=n_items, shards=shards,
         rows_per_shard=FOLD_IN_SHARD_ROWS, users_held_to_flat=len(sample),
         fold_in_events=len(events), kernel_launches=got,
         fold_in_seconds=fold_s, catalog_rebuild_seconds=rebuild_s,
         items_after=cat.n_items, shards_after=cat.n_shards,
         answers_held_to_host_topk=held, new_items_in_answers=new_item_hits)

    # "shardedServing": "always" at ML-100K: train → serve
    n_u, n_i, nnz = ML100K
    u, i, r = synth_ratings(n_u, n_i, nnz, seed=63)
    engine, engine_json, _ = als_engine(RANK, ITERS, 0.1, "nratings")
    engine_json["algorithms"][0]["params"]["shardedServing"] = "always"
    params = EngineParams.from_json(engine_json)
    _, _, algos, _ = engine.make_components(params)
    always = algos[0][1]
    check(always.params.sharded_serving == "always", "shardedServing parse")
    expected, _, _ = implied_launches(u, i, n_u, n_i,
                                      always.als_params(always.params), ITERS)
    reset_launches()
    trained = always.train(WorkflowContext(device="cuda"), TrainingData(
        u, i, r, IdentityBiMap(n_u), IdentityBiMap(n_i)))
    got = launches()
    record("sharded_always", got)
    check(got["warp"] == expected, f"always: launches {got} != {expected}")
    dep = _als_deployment(trained.factors.user_factors,
                          trained.factors.item_factors, 256, mode="always")
    check(dep.models[0].catalog().layout == "host", "always: layout")
    queries = [{"user": str(x), "num": 10} for x in range(0, n_u, 19)]
    answers, ms = _http_answers(dep, queries)
    for q, res in zip(queries, answers):
        check_user_answer(trained.factors.user_factors,
                          trained.factors.item_factors, int(q["user"]), res)
    emit("serving_sharded_always", ratings=nnz, kernel_launches=got,
         expected_launches=expected, shards=dep.models[0].catalog().n_shards,
         queries=len(queries), **_percentiles(ms))


# -- the serving mesh (ROADMAP item 7.4) ---------------------------------------

#: the serving mesh on the one card: 4 shards, each on MESH_DEVICE
MESH_SHARDS, MESH_DEVICE = 4, "cuda:0"
MESH_USERS, MESH_SIMILAR = 200, 50


def _mesh_vs_flat(itf: np.ndarray, uf: np.ndarray, users, mesh: list,
                  what: str) -> dict:
    """One catalog resident flat and split over ``mesh`` on the card:
    every user's top 10 (a third of them with 1 % of the items excluded)
    and MESH_SIMILAR similarity queries on the row-normalized catalog
    bit-identical, a batch of SHARDED_BATCH index-identical; each layout's
    per-query p50 (host clock: the call to the answer on the host)."""
    from incubator_predictionio_torch.models._sharded_serving import (
        ShardedCatalog,
    )
    from incubator_predictionio_torch.ops.topk import normalize_rows

    card = resolve_device("cuda")
    rng = np.random.default_rng(65)
    cats = {"flat": ShardedCatalog(itf, card),
            "mesh": ShardedCatalog(itf, card, mesh)}
    check(cats["flat"].layout == "flat" and cats["mesh"].layout == "mesh"
          and cats["mesh"].n_shards == len(mesh),
          f"{what}: layouts {cats['flat'].layout} / {cats['mesh'].layout}")
    excl = rng.random(len(itf)) < 0.01
    ms = {"flat": [], "mesh": []}
    for j, u in enumerate(users):
        got = {}
        for name, cat in cats.items():
            t0 = time.perf_counter()
            got[name] = cat.top_k(uf[u], 10,
                                  exclude=excl if j % 3 == 0 else None)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(got["mesh"][1], got["flat"][1])
              and np.array_equal(got["mesh"][0], got["flat"][0]),
              f"{what}: user {u}'s mesh answer differs from flat")
    uvs = uf[rng.integers(0, len(uf), SHARDED_BATCH)]
    check(np.array_equal(cats["mesh"].batch_top_k(uvs, 10)[1],
                         cats["flat"].batch_top_k(uvs, 10)[1]),
          f"{what}: batched indices differ between flat and the mesh")
    del cats
    normed = normalize_rows(itf)
    sims = {"flat": ShardedCatalog(normed, card),
            "mesh": ShardedCatalog(normed, card, mesh)}
    for q in rng.integers(0, len(itf), (MESH_SIMILAR, 2)):
        got = {name: cat.similar(itf[q], 10, exclude=excl)
               for name, cat in sims.items()}
        check(np.array_equal(got["mesh"][1], got["flat"][1])
              and np.array_equal(got["mesh"][0], got["flat"][0]),
              f"{what}: a similarity answer differs between the layouts")
    del sims
    torch.cuda.empty_cache()
    return {"items": len(itf), "rank": itf.shape[1], "shards": len(mesh),
            "queries": len(users), "similarity_queries": MESH_SIMILAR,
            "batch": SHARDED_BATCH, "identical": True,
            "flat": _percentiles(ms["flat"][1:]),
            "mesh": _percentiles(ms["mesh"][1:])}


def phase_serving_mesh(main: dict) -> None:
    """The serving mesh on the one card: MESH_SHARDS shards, each on
    cuda:0. The main path's ML-20M model and the million-item catalog
    (rank 32, random, seed 64) resident flat and split over the mesh:
    single queries (some with an exclusion mask) and similarity
    bit-identical, a batch of 64 index-identical, p50 per query beside
    flat's. Then the Recommendation template at the ML-100K shape with
    "shardedServing": "always": trained with a 4-device context mesh
    (the model picks the mesh through serving_mesh_for), persisted,
    restored with the same context (the mesh again), every query's answer
    equal to the flat deployment's bit for bit and a batch's items equal.
    The train's warp launches are this path's. Multi-card times are not
    measured: the host has one card."""
    mesh = [MESH_DEVICE] * MESH_SHARDS
    model = main["model"]
    uf, itf = model.factors.user_factors, model.factors.item_factors
    users = np.random.default_rng(64).integers(0, len(uf), MESH_USERS)
    points = [_mesh_vs_flat(itf, uf, users, mesh, "ML-20M")]
    rng = np.random.default_rng(64)
    big = rng.normal(size=(SHARDED_SIZES[-1], RANK)).astype(np.float32)
    buf = rng.normal(size=(SHARDED_USERS, RANK)).astype(np.float32)
    points.append(_mesh_vs_flat(big, buf, rng.integers(0, SHARDED_USERS,
                                                       MESH_USERS),
                                mesh, "10^6 items"))
    del big

    n_u, n_i, nnz = ML100K
    u, i, r = synth_ratings(n_u, n_i, nnz, seed=66)
    engine, engine_json, _ = als_engine(RANK, ITERS, 0.1, "nratings")
    deployments = {}
    reset_launches()
    for mode in ("never", "always"):
        engine_json["algorithms"][0]["params"]["shardedServing"] = mode
        params = EngineParams.from_json(engine_json)
        _, _, algos, _ = engine.make_components(params)
        ctx = WorkflowContext(device="cuda", mesh=mesh)
        trained = algos[0][1].train(ctx, TrainingData(
            u, i, r, IdentityBiMap(n_u), IdentityBiMap(n_i)))
        check((trained.serving_mesh is not None) == (mode == "always"),
              f"serving_mesh: the {mode} train's mesh "
              f"{trained.serving_mesh}")
        dep = engine.prepare_deployment(
            WorkflowContext(device="cuda", mesh=mesh), params,
            [model_to_persisted(trained)])
        dep.models[0].warm_up()
        layout = dep.models[0].catalog().layout
        check(layout == ("mesh" if mode == "always" else "flat"),
              f"serving_mesh: the restored {mode} model serves {layout}")
        deployments[mode] = dep
    got = launches()
    record("serving_mesh", got)
    queries = [{"user": str(x), "num": 10} for x in range(0, n_u, 7)]
    for q in queries:
        check(deployments["always"].query(q) == deployments["never"].query(q),
              f"serving_mesh: {q}'s mesh answer differs from flat")
    batch = deployments["always"].batch_query(queries[:SHARDED_BATCH])
    flat = deployments["never"].batch_query(queries[:SHARDED_BATCH])
    check([[x["item"] for x in a["itemScores"]] for a in batch]
          == [[x["item"] for x in a["itemScores"]] for a in flat],
          "serving_mesh: a batch's items differ between the layouts")
    emit("serving_mesh", points=points, mesh=mesh,
         template={"ratings": nnz, "queries": len(queries),
                   "batch": min(SHARDED_BATCH, len(queries)),
                   "identical": True, "kernel_launches": got},
         not_measured="multi-card times: the host has one card")


# -- the partitioned event log's write side (ROADMAP item 3.1.1) ------------

#: ML-1M events through `pio eventserver --workers 2`, then the ones the
#: SIGKILL flood sends; bench_ingest.py's bracket: 16 clients, 3,000
#: events a round, the topologies interleaved round by round
PART_EVENTS, PART_KILL_EVENTS = 100_000, 20_000
PART_CLIENTS, PART_ROUND, PART_ROUNDS, PART_BATCH = 16, 3_000, 5, 50


class _Front(_Served):
    """``pio eventserver --workers N`` in its own process; ready once the
    front's /healthz counts every worker ready."""

    def __init__(self, env: dict, cwd: str, workers: int):
        self.workers = workers
        super().__init__(["eventserver", "--workers", str(workers), "--ip",
                          "127.0.0.1"], env, cwd)

    def __enter__(self):
        self.wait_health(f"{self.workers} ready workers", lambda h: (
            h["readyWorkers"] == self.workers
            and len(h["workers"]) == self.workers))
        return self

    def health(self) -> dict:
        return self.request("GET", "/healthz")[1]

    def wait_health(self, what: str, pred, timeout: float = 120.0) -> dict:
        deadline = time.time() + timeout
        last = None
        while time.time() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"front exited: {self.proc.stderr.read()[-2000:]}")
            try:
                last = self.health()
                if pred(last):
                    return last
            except (OSError, ValueError):
                pass
            time.sleep(0.1)
        raise AssertionError(f"front: {what} not reached: {last}")

    def pid_of(self, worker: int):
        return next(b["pid"] for b in self.health()["backends"]
                    if b["worker"] == worker)

    def port_of(self, worker: int):
        return next(b["port"] for b in self.health()["backends"]
                    if b["worker"] == worker)


def _drive(port: int, key: str, bodies: list, on_acked=None) -> tuple:
    """POST every pre-encoded batch body to /batch/events.json from
    PART_CLIENTS keep-alive connections; a batch whose connection fails is
    sent again on a new connection (not acknowledged, so nothing is lost).
    Returns (acknowledged ids, seconds, batches sent again)."""
    import queue

    work: queue.Queue = queue.Queue()
    for b in bodies:
        work.put(b)
    acked, retries, errors = [], [0], []
    lock = threading.Lock()
    path = f"/batch/events.json?accessKey={key}"

    def client():
        conn = None
        try:
            while True:
                try:
                    body = work.get_nowait()
                except queue.Empty:
                    return
                for attempt in range(20):
                    try:
                        if conn is None:
                            conn = http.client.HTTPConnection(
                                "127.0.0.1", port, timeout=60)
                        conn.request("POST", path, body=body, headers={
                            "Content-Type": "application/json"})
                        resp = conn.getresponse()
                        res = json.loads(resp.read())
                        check(resp.status == 200, f"batch {resp.status}")
                        check(all(x["status"] == 201 for x in res),
                              f"batch items {res[:2]}")
                        break
                    except (OSError, http.client.HTTPException,
                            ValueError):
                        if conn is not None:
                            conn.close()
                        conn = None
                        with lock:
                            retries[0] += 1
                        time.sleep(0.05 * (attempt + 1))
                else:
                    raise AssertionError("a batch failed 20 times")
                with lock:
                    acked.extend(x["eventId"] for x in res)
                    n = len(acked)
                if on_acked is not None:
                    on_acked(n)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            if conn is not None:
                conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(PART_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    check(not errors, f"ingest clients failed: {errors[:1]}")
    return acked, seconds, retries[0]


def _bodies(events: list) -> list:
    return [json.dumps(events[j:j + PART_BATCH]).encode()
            for j in range(0, len(events), PART_BATCH)]


def _event_key(e: dict) -> tuple:
    return (e["entityId"], e["targetEntityId"],
            float(e["properties"]["rating"]), _ms(e["eventTime"]))


def _log_view(env: dict, app: str = "part") -> tuple:
    """(eventId → count, content multiset) of the merged read."""
    import collections

    store = _storage_of(env)
    app_id = store.get_meta_data_apps().get_by_name(app).id
    ids, content = collections.Counter(), collections.Counter()
    for e in store.get_l_events().find(app_id, limit=None):
        ids[e.event_id] += 1
        content[(e.entity_id, e.target_entity_id,
                 float(e.properties.get_or_else("rating", "nan")),
                 int(e.event_time.timestamp() * 1000 + 0.5))] += 1
    store.close()
    return ids, content


def phase_eventserver_partitioned(workdir: str) -> None:
    """`pio eventserver --workers 2` (and `--workers 1` beside it, for the
    bracket) on JSONL stores: the first PART_EVENTS ML-1M events in
    batches of 50 from 16 clients, the two topologies interleaved for
    PART_ROUNDS rounds of 3,000 events (bench_ingest.py:354-380); both
    .p<i> shards non-empty and the merged read equal to the acknowledged
    events as a multiset; a SIGKILL of worker 1 mid-flood (PART_KILL_EVENTS
    more), relaunched, no acknowledged event lost; `pio eventlog fence
    --partition 0` on the live worker 0 (its next write 503, the shard's
    size unchanged), worker 0 killed and relaunched with a fresh epoch;
    `pio eventserver scale 3` then `scale 2` (partition 2's lease parked
    on the front, epoch bumped); then `pio train` off the merged log:
    warp launches = implied, factors within 2e-4 of train_als on the
    triple read back. Both topologies run with the write-ahead log
    (PIO_WAL=1, PIO_WAL_FSYNC=group, bench_ingest.py's _mw_env): the
    relaunched worker 1 replays its <wal>/p1 after its lease claim, and
    the scale-down replays p2 on the front; neither leaves an uncommitted
    record."""
    from incubator_predictionio_torch.data.api import ingest_wal

    cwd = tempfile.mkdtemp(dir=workdir)
    envs, keys = {}, {}
    for w in (1, 2):
        envs[w] = _jsonl_env(os.path.join(cwd, f"pio_w{w}")) | {
            "PIO_SUPERVISOR_POLL_MS": "50", "PIO_WAL": "1",
            "PIO_WAL_FSYNC": "group",
            "PIO_WAL_DIR": os.path.join(cwd, f"wal_w{w}")}
        for k in ("PIO_INGEST_ACK", "PIO_INGEST_GROUP"):
            envs[w].pop(k, None)
        out, _ = _verb(["app", "new", "part"], envs[w], cwd)
        keys[w] = out.stdout.split("Access Key:")[1].split()[0]
    path = os.path.join(cwd, "ml1m.jsonl")
    _write_ml1m_jsonl(path, PART_EVENTS + PART_KILL_EVENTS)
    with open(path, encoding="utf-8") as fh:
        events = [json.loads(line) for line in fh]
    os.unlink(path)
    main_ev, flood_ev = events[:PART_EVENTS], events[PART_EVENTS:]
    ev_dir = os.path.join(cwd, "pio_w2", "events", "pio_eventdata")
    t0 = time.perf_counter()
    one, two = _Front(envs[1], cwd, 1), _Front(envs[2], cwd, 2)
    with one, two:
        up_s = time.perf_counter() - t0
        rates = {1: [], 2: []}
        acked = []
        for r in range(PART_ROUNDS):
            chunk = _bodies(main_ev[r * PART_ROUND:(r + 1) * PART_ROUND])
            for w, front in ((1, one), (2, two)):
                ids, sec, _ = _drive(front.port, keys[w], chunk)
                rates[w].append(PART_ROUND / sec)
                if w == 2:
                    acked += ids
        rest = main_ev[PART_ROUNDS * PART_ROUND:]
        ids, rest_s, _ = _drive(two.port, keys[2], _bodies(rest))
        acked += ids
        shards = {n: os.path.getsize(os.path.join(ev_dir, n))
                  for n in os.listdir(ev_dir) if n.endswith(".jsonl")}
        check(shards.get("events_1.p0.jsonl", 0) > 0
              and shards.get("events_1.p1.jsonl", 0) > 0,
              f"shards {shards}")
        read_ids, read_content = _log_view(envs[2])
        import collections

        check(read_ids == collections.Counter(acked)
              and len(acked) == PART_EVENTS,
              f"merged read {sum(read_ids.values())} events, "
              f"{len(acked)} acknowledged")
        check(read_content == collections.Counter(
            _event_key(e) for e in main_ev),
              "the merged read's events differ from the posted ones")
        emit("eventserver_partitioned_ingest", events=PART_EVENTS,
             configuration="PIO_WAL=1, PIO_WAL_FSYNC=group, group commit "
                           "(earlier runs of this phase: no WAL, a store "
                           "write per request)",
             clients=PART_CLIENTS, batch=PART_BATCH, round_events=PART_ROUND,
             events_per_s_rounds={f"workers_{w}": v
                                  for w, v in rates.items()},
             events_per_s_median={f"workers_{w}": float(np.median(v))
                                  for w, v in rates.items()},
             rest_events=len(rest), rest_events_per_s=len(rest) / rest_s,
             shard_bytes=shards, fronts_up_seconds=up_s)

        # SIGKILL of worker 1 mid-flood
        pid1 = two.pid_of(1)
        killed = threading.Event()
        bodies = _bodies(flood_ev)

        def kill_at(n):
            if n >= len(flood_ev) // 3 and not killed.is_set():
                killed.set()
                os.kill(pid1, signal.SIGKILL)

        t0 = time.perf_counter()
        flood_ids, flood_s, retried = _drive(two.port, keys[2], bodies,
                                             on_acked=kill_at)
        check(killed.is_set(), "worker 1 was not killed")
        health = two.wait_health("worker 1 relaunched", lambda h: any(
            b["worker"] == 1 and b["ready"] and b["pid"] not in (None, pid1)
            for b in h["backends"]))
        back_s = time.perf_counter() - t0
        restarts = {b["worker"]: b["restarts"] for b in health["backends"]}
        acked += flood_ids
        read_ids, _ = _log_view(envs[2])
        lost = [eid for eid in flood_ids if eid not in read_ids]
        check(not lost, f"{len(lost)} acknowledged events lost")
        check(max(read_ids.values()) == 1, "an event id landed twice")
        check(restarts[1] == 1, f"restarts {restarts}")
        # the relaunched worker replayed its WAL subdirectory
        w1_replayed = _metric(_metrics_text(two.port_of(1)),
                              "pio_wal_replayed_events_total")
        p1 = [r for r in ingest_wal.inspect(ingest_wal.WalConfig(
            enabled=True, dir=envs[2]["PIO_WAL_DIR"])) if r["partition"] == 1]
        check(not any(r["uncommittedEvents"] for r in p1),
              f"worker 1's WAL after its relaunch: {p1}")
        emit("eventserver_partitioned_sigkill", events=len(flood_ev),
             acknowledged=len(flood_ids), lost=0, batches_sent_again=retried,
             landed_unacknowledged=sum(read_ids.values()) - len(acked),
             seconds_until_relaunched_ready=back_s, flood_seconds=flood_s,
             restarts=restarts, wal_replayed_by_relaunch=w1_replayed)

        # fence partition 0 under its live worker
        p0 = os.path.join(ev_dir, "events_1.p0.jsonl")
        epoch0 = event_log.lease_info(ev_dir, 0)["epoch"]
        out, _ = _verb(["eventlog", "fence", "--partition", "0"], envs[2],
                       cwd)
        check(f"new epoch {epoch0 + 1} (FORCED" in out.stdout, out.stdout)
        size = os.path.getsize(p0)
        w0 = _Endpoint(two.port_of(0))
        status, res, _ = w0.request(
            "POST", f"/batch/events.json?accessKey={keys[2]}",
            flood_ev[:PART_BATCH])
        check(status == 503 and "fenced" in res["message"],
              f"fenced worker answered {status}: {res}")
        check(os.path.getsize(p0) == size, "the fenced worker wrote")
        pid0 = two.pid_of(0)
        os.kill(pid0, signal.SIGKILL)
        two.wait_health("worker 0 relaunched", lambda h: any(
            b["worker"] == 0 and b["ready"] and b["pid"] not in (None, pid0)
            for b in h["backends"]))
        epoch_back = event_log.lease_info(ev_dir, 0)["epoch"]
        check(epoch_back == epoch0 + 2, f"worker 0 epoch {epoch_back}")
        w0 = _Endpoint(two.port_of(0))
        status, res, _ = w0.request(
            "POST", f"/batch/events.json?accessKey={keys[2]}",
            flood_ev[:PART_BATCH])
        check(status == 200 and all(x["status"] == 201 for x in res),
              f"relaunched worker 0 answered {status}")
        acked += [x["eventId"] for x in res]

        # scale 3 → scale 2: partition 2's lease parked on the front
        t0 = time.perf_counter()
        _verb(["eventserver", "scale", "3"], envs[2], cwd)
        two.wait_health("3 ready workers", lambda h: (
            h["readyWorkers"] == 3 and len(h["workers"]) == 3))
        up3_s = time.perf_counter() - t0
        owned = event_log.lease_info(ev_dir, 2)
        w2 = _Endpoint(two.port_of(2))
        for b in range(2):
            status, res, _ = w2.request(
                "POST", f"/batch/events.json?accessKey={keys[2]}",
                flood_ev[PART_BATCH * (b + 1):PART_BATCH * (b + 2)])
            check(status == 200 and all(x["status"] == 201 for x in res),
                  f"worker 2 answered {status}")
            acked += [x["eventId"] for x in res]
        t0 = time.perf_counter()
        _verb(["eventserver", "scale", "2"], envs[2], cwd)
        two.wait_health("partition 2 parked", lambda h: (
            h["parkedPartitions"] == [2] and h["workers"] == [0, 1]))
        down_s = time.perf_counter() - t0
        parked = event_log.lease_info(ev_dir, 2)
        check(parked["held"] and parked["pid"] == two.proc.pid
              and parked["epoch"] == owned["epoch"] + 1,
              f"partition 2: owned {owned}, parked {parked}")
        p2 = [r for r in ingest_wal.inspect(ingest_wal.WalConfig(
            enabled=True, dir=envs[2]["PIO_WAL_DIR"])) if r["partition"] == 2]
        check(not any(r["uncommittedEvents"] for r in p2),
              f"partition 2's WAL after the scale-down: {p2}")
        read_ids, _ = _log_view(envs[2])
        lost = [eid for eid in acked if eid not in read_ids]
        check(not lost and max(read_ids.values()) == 1,
              f"{len(lost)} acknowledged events lost after the scale-down")
        emit("eventserver_partitioned_fence_scale", fence_epoch=epoch0 + 1,
             fenced_status=503, shard_bytes_unchanged=True,
             relaunch_epoch=epoch_back, scale_up_seconds=up3_s,
             scale_down_seconds=down_s, parked={
                 "partition": 2, "epoch_owned": owned["epoch"],
                 "epoch_parked": parked["epoch"]})
    check(one.proc.returncode == 0 and two.proc.returncode == 0,
          f"fronts exited {one.proc.returncode}, {two.proc.returncode}")

    # pio train off the merged log
    _write_engine_json(cwd, "part")
    trained = _train_verb(envs[2], cwd, "eventserver_partitioned")
    store = _storage_of(envs[2])
    u, i, r, users, items = PEventStore.find_ratings("part", storage=store)
    want = {"u": u, "i": i, "r": r, "users": list(users.keys()),
            "items": list(items.keys())}
    final_ids, _ = _log_view(envs[2])
    check(len(u) == sum(final_ids.values()) and set(acked) <= set(final_ids),
          f"read {len(u)} ratings; the log holds {sum(final_ids.values())}, "
          f"{len(acked)} acknowledged")
    _hold_train(trained, want, "eventserver_partitioned")
    stored = _hold_model(store, trained, want, "eventserver_partitioned")
    store.close()
    algo = als_engine(PIO_RANK, PIO_ITERS, PIO_LAMBDA)[2]
    ref = train_als(u, i, r, n_users=len(users), n_items=len(items),
                    params=algo.als_params(algo.params), device="cuda")
    err = {"user": max_err(stored["user_factors"], ref.user_factors),
           "item": max_err(stored["item_factors"], ref.item_factors)}
    check(within(stored["user_factors"], ref.user_factors)
          and within(stored["item_factors"], ref.item_factors),
          f"pio train vs train_als: {err}")
    emit("eventserver_partitioned_train", ratings=len(u),
         kernel_launches=trained["kernel_launches"],
         expected_launches=trained["expected_launches"],
         train_seconds_end_to_end=trained["wall_seconds"],
         read_seconds=trained["timings"]["read_seconds"],
         max_abs_err_vs_train_als=err)
    phase_gang_train(cwd, envs[2], trained["wall_seconds"])
    phase_gang_train_merged(cwd, envs[2])
    shutil.rmtree(cwd)


# -- the event tier's durable write path (ROADMAP items 3.1.2, 3.2, 3.3) ----

#: bench_ingest.py's single-event sweep (its 128 clients cut for time):
#: keep-alive connections, 1,000 events a point (PIO_INGEST_N_SINGLE's
#: default 2,000 until the network_storage phase needed the time), each
#: point with group commit off, on, and on with the WAL
WAL_SWEEP_CLIENTS = (1, 8, 32)
WAL_SWEEP_EVENTS = 1_000
WAL_SWEEP_MODES = {
    "group_off": {"PIO_INGEST_GROUP": "off"},
    "group_on": {"PIO_INGEST_GROUP": "on"},
    "group_wal": {"PIO_INGEST_GROUP": "on", "PIO_WAL": "1",
                  "PIO_WAL_FSYNC": "group"},
}
#: the ack=enqueue flood the server is killed in, and the group commit it
#: dies inside (a group holds up to 256 events, so 20,000 events take at
#: least 79 commits: the 78th always comes mid-flood)
WAL_FLOOD_EVENTS, WAL_FLOOD_CLIENTS, WAL_CRASH_COMMIT = 20_000, 32, 78
#: the window of the archive train: every generation of the log
WAL_TRAIN_WINDOW = "36500d"


def _lockstep(port: int, path: str, bodies: list, conc: int,
              headers=None) -> dict:
    """bench_ingest.py's run_single_sweep: ``conc`` keep-alive connections
    driven by at most 8 threads, each thread sending one request on every
    one of its connections, then reading every answer (one request in
    flight per connection). Every answer must be 201; returns events/s,
    the ack's p50 / p99 and the ids."""
    import concurrent.futures

    threads = max(t for t in range(1, min(8, conc) + 1) if conc % t == 0)
    per_thread = conc // threads
    per_conn = len(bodies) // conc
    hdrs = {"Content-Type": "application/json", **(headers or {})}

    def worker(w):
        conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                 for _ in range(per_thread)]
        lat, ids = [], []
        try:
            for j in range(per_conn):
                t0s = []
                for c, conn in enumerate(conns):
                    body = bodies[((w * per_thread + c) * per_conn) + j]
                    t0s.append(time.perf_counter())
                    conn.request("POST", path, body=body, headers=hdrs)
                for conn, t0 in zip(conns, t0s):
                    resp = conn.getresponse()
                    doc = json.loads(resp.read())
                    lat.append((time.perf_counter() - t0) * 1e3)
                    check(resp.status == 201, f"single POST {resp.status}: "
                          f"{doc}")
                    ids.append(doc["eventId"])
        finally:
            for conn in conns:
                conn.close()
        return lat, ids

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        got = list(pool.map(worker, range(threads)))
    seconds = time.perf_counter() - t0
    lat = [x for g in got for x in g[0]]
    return {"events_per_s": len(lat) / seconds, **_percentiles(lat),
            "ids": [x for g in got for x in g[1]]}


def _metrics_text(at) -> str:
    """``GET /metrics`` of a ``_Served`` (over its own scheme) or of a
    plain-HTTP port."""
    conn = (at.connect() if isinstance(at, _Served) else
            http.client.HTTPConnection("127.0.0.1", at, timeout=60))
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        check(resp.status == 200, f"/metrics {resp.status}")
        return text
    finally:
        conn.close()


def _metric(text: str, name: str, **labels) -> float:
    """The sum of a family's samples whose labels include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        if not (line.startswith(name + "{") or line.startswith(name + " ")):
            continue
        if all(f'{k}="{v}"' in line for k, v in labels.items()):
            total += float(line.rsplit(" ", 1)[1])
    return total


def _wal_rows(env: dict) -> list:
    """The rows `pio wal inspect` prints for ``env``'s WAL dir."""
    from incubator_predictionio_torch.data.api import ingest_wal

    return ingest_wal.inspect(ingest_wal.WalConfig(
        enabled=True, dir=env["PIO_WAL_DIR"]))


def _crash_flood(port: int, key: str, bodies: list, acked: list,
                 lock) -> None:
    """ack=enqueue single POSTs from WAL_FLOOD_CLIENTS keep-alive clients
    until the bodies run out or the server dies; each 201 read lands in
    ``acked`` as (body index, eventId)."""
    import queue

    work: queue.Queue = queue.Queue()
    for j in range(len(bodies)):
        work.put(j)
    path = f"/events.json?accessKey={key}"
    errors = []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while True:
                try:
                    j = work.get_nowait()
                except queue.Empty:
                    return
                conn.request("POST", path, body=bodies[j], headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                if resp.status != 201:
                    errors.append((resp.status, doc))
                    return
                with lock:
                    acked.append((j, doc["eventId"]))
        except (OSError, http.client.HTTPException, ValueError):
            return  # the server died under this client
        finally:
            conn.close()

    threads = [threading.Thread(target=client)
               for _ in range(WAL_FLOOD_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"enqueue POSTs refused: {errors[:2]}")


def phase_eventserver_wal(workdir: str) -> None:
    """`pio eventserver` on a JSONL store with the durable write path:
    (1) bench_ingest.py's single-event sweep (1, 8, 32 keep-alive clients,
    1,000 ML-1M events a point) with group commit off, on, and on with the
    WAL (PIO_WAL_FSYNC=group); (2) an ack=enqueue flood of 20,000 events
    from 32 clients killed inside a mid-flood group commit (PIO_FAULT_SPEC
    ingest.commit:crash:N), the restart's WAL replay, the unacknowledged
    rest sent again in batches of 50: every acknowledged id exactly once
    in the merged
    read, `pio wal inspect` with nothing uncommitted, /metrics and
    /stats.json equal to the events the restarted server acknowledged or
    replayed; (3) the background compaction loop seals the log, `pio
    eventlog archive` moves its first generation to a localfs cold source,
    a windowed `pio train` refuses it (ArchivedGenerationError), the same
    train with PIO_EVENT_RESTORE_ON_DEMAND=1 restores it: warp launches =
    implied, factors equal bit for bit to the train before the archive and
    within 2e-4 of train_als on the triples read back."""
    import collections

    t_phase = time.perf_counter()
    cwd = tempfile.mkdtemp(dir=workdir)
    base = os.path.join(cwd, "pio")
    env = _jsonl_env(base) | {
        "PIO_WAL_DIR": os.path.join(cwd, "wal"),
        "PIO_STORAGE_SOURCES_COLD_TYPE": "LOCALFS",
        "PIO_STORAGE_SOURCES_COLD_PATH": os.path.join(cwd, "cold"),
        "PIO_EVENT_ARCHIVE_SOURCE": "COLD"}
    for k in ("PIO_WAL", "PIO_INGEST_GROUP", "PIO_INGEST_ACK",
              "PIO_FAULT_SPEC", "PIO_EVENT_RESTORE_ON_DEMAND"):
        env.pop(k, None)
    out, _ = _verb(["app", "new", "walapp"], env, cwd)
    key = out.stdout.split("Access Key:")[1].split()[0]
    n_sweep = len(WAL_SWEEP_MODES) * len(WAL_SWEEP_CLIENTS) * WAL_SWEEP_EVENTS
    path = os.path.join(cwd, "ml1m.jsonl")
    _write_ml1m_jsonl(path, n_sweep + WAL_FLOOD_EVENTS)
    with open(path, encoding="utf-8") as fh:
        bodies = [line.strip().encode() for line in fh]
    os.unlink(path)
    posted = collections.Counter()

    # (1) the sweep: one server per mode, the client counts in turn
    sweep, at, swept = {}, 0, 0
    for mode, knobs in WAL_SWEEP_MODES.items():
        menv = dict(env, **knobs)
        with _Served(["eventserver", "--ip", "127.0.0.1"], menv, cwd) as srv:
            sweep[mode] = {}
            for conc in WAL_SWEEP_CLIENTS:
                chunk = bodies[at:at + WAL_SWEEP_EVENTS]
                at += WAL_SWEEP_EVENTS
                chunk = chunk[:len(chunk) - len(chunk) % conc]
                got = _lockstep(srv.port, f"/events.json?accessKey={key}",
                                chunk, conc)
                posted.update(chunk)
                swept += len(chunk)
                check(len(set(got.pop("ids"))) == len(chunk),
                      f"{mode} x{conc}: ids not distinct")
                sweep[mode][f"clients_{conc}"] = got
            _, root, _ = srv.request("GET", "/")
            sweep[mode]["ingest"] = {
                k: root["ingest"][k] for k in ("groupsCommitted",
                                                "eventsCommitted",
                                                "maxGroup")}
        check(srv.proc.returncode == 0, f"{mode} server exited "
              f"{srv.proc.returncode}: {srv.stderr[-2000:]}")
    check(not any(r["uncommittedEvents"] for r in _wal_rows(env)),
          "the sweep left uncommitted WAL records")
    emit("eventserver_wal_sweep", events_per_point=WAL_SWEEP_EVENTS,
         clients=list(WAL_SWEEP_CLIENTS), modes=sweep,
         cut="bench_ingest.py's 128-client point (time)")

    # (2) the crash: ack=enqueue, killed inside a mid-flood group commit
    flood = bodies[at:at + WAL_FLOOD_EVENTS]
    crash_env = dict(env, PIO_WAL="1", PIO_WAL_FSYNC="group",
                     PIO_INGEST_ACK="enqueue",
                     PIO_FAULT_SPEC=f"ingest.commit:crash:{WAL_CRASH_COMMIT}")
    acked, lock = [], threading.Lock()
    srv = _Served(["eventserver", "--ip", "127.0.0.1", "--stats"], crash_env,
                  cwd)
    with srv:
        t0 = time.perf_counter()
        _crash_flood(srv.port, key, flood, acked, lock)
        flood_s = time.perf_counter() - t0
        rc = srv.proc.wait(timeout=60)
    check(rc == -signal.SIGKILL, f"the server exited {rc}, not killed")
    acked_at_crash = len(acked)
    check(0 < acked_at_crash < WAL_FLOOD_EVENTS,
          f"{acked_at_crash} of {WAL_FLOOD_EVENTS} acknowledged at the crash")
    rows = _wal_rows(env)
    pending = sum(r["uncommittedEvents"] for r in rows)
    check(pending > 0, f"no uncommitted WAL record after the crash: {rows}")
    # the restart replays, then the rest is sent again (ack=commit) while
    # the background compaction loop seals the log
    restart_env = dict(env, PIO_WAL="1", PIO_WAL_FSYNC="group",
                       PIO_COMPACT_INTERVAL_MS="250",
                       PIO_COMPACT_MIN_BYTES="0")
    t0 = time.perf_counter()
    with _Served(["eventserver", "--ip", "127.0.0.1", "--stats"],
                 restart_env, cwd) as srv:
        up_s = time.perf_counter() - t0
        replayed = _metric(_metrics_text(srv.port),
                           "pio_wal_replayed_events_total")
        deduped = _metric(_metrics_text(srv.port),
                          "pio_wal_replay_deduped_events_total")
        done = {j for j, _ in acked}
        rest = [json.loads(flood[j]) for j in range(len(flood))
                if j not in done]
        resent_ids, resent_s, _ = _drive(srv.port, key, _bodies(rest))
        posted.update(flood)
        text = _metrics_text(srv.port)
        _, stats, _ = srv.request("GET", f"/stats.json?accessKey={key}")
        stat_201 = sum(c["count"] for c in stats["counts"]
                       if c["status"] == 201)
        metric_201 = _metric(text, "pio_ingest_events_total", status="201")
        expect = int(replayed) + len(resent_ids)
        check(stat_201 == metric_201 == expect,
              f"/stats.json {stat_201}, /metrics {metric_201}, want "
              f"{expect} (replayed {replayed} + resent {len(resent_ids)})")
        # the background loop has sealed every byte of the log
        log_path = os.path.join(base, "events", "pio_eventdata",
                                "events_1.jsonl")
        deadline = time.time() + 60
        while True:
            manifest = event_log._read_manifest(log_path)
            if manifest is not None and manifest.get("covered") == \
                    os.path.getsize(log_path):
                break
            check(time.time() < deadline, "background compaction stalled")
            time.sleep(0.1)
        compactions = _metric(_metrics_text(srv.port),
                              "pio_eventlog_compactions_total")
    check(srv.proc.returncode == 0, f"restarted server exited "
          f"{srv.proc.returncode}: {srv.stderr[-2000:]}")
    out, _ = _verb(["wal", "inspect"], env | {"PIO_WAL": "1"}, cwd)
    check("No WAL segments on disk" in out.stdout
          or all(r["uncommittedEvents"] == 0 for r in _wal_rows(env)),
          f"pio wal inspect: {out.stdout[-1500:]}")
    ids, content = _log_view(env, "walapp")
    acked_ids = [eid for _, eid in acked] + resent_ids
    check(all(ids[eid] == 1 for eid in acked_ids),
          "an acknowledged event is missing or doubled")
    check(max(ids.values()) == 1, "an event id landed twice")
    want_content = collections.Counter(_event_key(json.loads(b))
                                       for b in posted)
    check(all(content[k] >= 1 for k in want_content),
          "a posted event is missing from the merged read")
    emit("eventserver_wal_crash", events=WAL_FLOOD_EVENTS,
         clients=WAL_FLOOD_CLIENTS, crash_commit=WAL_CRASH_COMMIT,
         acknowledged_at_crash=acked_at_crash, flood_seconds=flood_s,
         uncommitted_at_crash=pending, replayed=replayed, deduped=deduped,
         restart_seconds=up_s, resent=len(resent_ids),
         resent_events_per_s=len(resent_ids) / resent_s,
         landed_unacknowledged=sum(ids.values()) - swept
         - len(acked_ids),
         stats_201=stat_201, metrics_201=metric_201,
         background_compactions=compactions, lost=0, doubled=0)

    # (3) archive the first generation; the windowed train restores it
    _write_engine_json(cwd, "walapp")
    window = ["--window", WAL_TRAIN_WINDOW]
    before = _train_verb(env, cwd, "eventserver_wal_train_before", window)
    store = _storage_of(env)
    u, i, r, users, items = PEventStore.find_ratings("walapp", storage=store)
    want = {"u": u, "i": i, "r": r, "users": list(users.keys()),
            "items": list(items.keys())}
    check(len(u) == sum(ids.values()), f"read {len(u)} ratings, the log "
          f"holds {sum(ids.values())}")
    _hold_train(before, want, "eventserver_wal_train_before")
    first = manifest["generations"][0]
    snap = os.path.join(os.path.dirname(log_path), first["file"])
    t0 = time.perf_counter()
    out, _ = _verb(["eventlog", "archive", "--log", "events_1.jsonl",
                    "--generation", str(first["generation"])], env, cwd)
    archive_s = time.perf_counter() - t0
    check("tier archived" in out.stdout and not os.path.exists(snap),
          f"archive: {out.stdout[-500:]}")
    refused = subprocess.run(CONSOLE + ["train", *window], env=env, cwd=cwd,
                             capture_output=True, text=True, timeout=600)
    check(refused.returncode != 0 and "are archived" in refused.stderr,
          f"a windowed train over an archived generation ran "
          f"({refused.returncode}): {refused.stderr[-1500:]}")
    restored = _train_verb(env | {"PIO_EVENT_RESTORE_ON_DEMAND": "1"}, cwd,
                           "eventserver_wal_train_restored", window)
    check(os.path.exists(snap) and event_log._read_manifest(log_path)[
        "generations"][0].get("tier", "hot") == "hot",
          "the train did not restore the archived generation")
    _hold_train(restored, want, "eventserver_wal_train_restored")
    a = _hold_model(store, before, want, "eventserver_wal_train_before")
    stored = _hold_model(store, restored, want,
                         "eventserver_wal_train_restored")
    store.close()
    check(all(np.array_equal(a[k], stored[k])
              for k in ("user_factors", "item_factors")),
          "the restored train's factors differ from the train before the "
          "archive")
    algo = als_engine(PIO_RANK, PIO_ITERS, PIO_LAMBDA)[2]
    ref = train_als(u, i, r, n_users=len(users), n_items=len(items),
                    params=algo.als_params(algo.params), device="cuda")
    err = {"user": max_err(stored["user_factors"], ref.user_factors),
           "item": max_err(stored["item_factors"], ref.item_factors)}
    check(within(stored["user_factors"], ref.user_factors)
          and within(stored["item_factors"], ref.item_factors),
          f"restored train vs train_als: {err}")
    emit("eventserver_wal_archive_train", ratings=len(u),
         generations=len(manifest["generations"]),
         archived_generation=first["generation"],
         archive_verb_seconds=archive_s,
         read_seconds_before=before["timings"]["read_seconds"],
         read_seconds_restored=restored["timings"]["read_seconds"],
         train_seconds_before=before["wall_seconds"],
         train_seconds_restored=restored["wall_seconds"],
         kernel_launches=restored["kernel_launches"],
         expected_launches=restored["expected_launches"],
         bit_equal_to_before=True, max_abs_err_vs_train_als=err,
         phase_seconds=time.perf_counter() - t_phase, card=CARD)
    shutil.rmtree(cwd)


# -- network stores, TLS, breakers: the network_storage phase ----------------

#: ML-1M-shaped events the network_storage phase imports (of 1,000,209)
NET_IMPORT = 20_000
#: queries per deploy (TLS and plaintext) in network_storage
NET_QUERIES = 200
#: single event POSTs before the storage server's SIGKILL and after its
#: restart
NET_POSTS = 100
TLS_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_tls")
TLS_CERT = os.path.join(TLS_DIR, "cert.pem")
TLS_KEY = os.path.join(TLS_DIR, "key.pem")
#: the breaker's knobs, through the reference's source properties
#: (breaker_from_props, policy_from_props): it trips after 2 consecutive
#: connectivity failures and half-opens 2 s later
NET_BREAKER = {"BREAKER_THRESHOLD": "2", "BREAKER_RESET": "2",
               "RETRY_ATTEMPTS": "2", "RETRY_BASE": "0.05",
               "RETRY_MAX": "0.1", "RETRY_DEADLINE": "2",
               "CONNECT_DEADLINE": "20"}


class _TLSServed(_Served):
    """A serving verb under PIO_SSL_CERTFILE / PIO_SSL_KEYFILE: its client
    speaks HTTPS and trusts only the test certificate."""

    def connect(self) -> http.client.HTTPConnection:
        import ssl

        return http.client.HTTPSConnection(
            "127.0.0.1", self.port, timeout=60,
            context=ssl.create_default_context(cafile=TLS_CERT))


class _StoreNode:
    """`pio storageserver` in its own process over its node's SQLite file,
    on a fixed port (a restart binds the same one)."""

    def __init__(self, env: dict, cwd: str, port: int):
        self.env, self.cwd, self.port = env, cwd, port
        self.proc = None

    def start(self) -> "_StoreNode":
        self.proc = subprocess.Popen(
            CONSOLE + ["storageserver", "--port", str(self.port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=self.env, cwd=self.cwd)
        deadline = time.time() + 60
        while True:
            if self.proc.poll() is not None:
                # read the pipe only once the process is gone
                raise AssertionError("storageserver exited: "
                                     + self.proc.stderr.read()[-2000:])
            try:
                conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                  timeout=5)
                conn.request("GET", "/health")
                ok = json.loads(conn.getresponse().read())["status"] == "ok"
                conn.close()
                if ok:
                    return self
            except OSError:
                pass
            check(time.time() < deadline, "storageserver never came up")
            time.sleep(0.05)

    def kill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait()
        self.proc.stderr.close()

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            self.proc.wait(timeout=30)
        if self.proc is not None and not self.proc.stderr.closed:
            self.proc.stderr.close()


def _query_run(srv: _Served, users: list, stored: dict) -> dict:
    """NET_QUERIES queries on one keep-alive connection, every answer held
    to the host top-k over the persisted factors; percentiles of the
    client's milliseconds (the first, the connection's, dropped)."""
    m_users, m_items = stored["users"], stored["items"]
    uf, itf = stored["user_factors"], stored["item_factors"]
    conn = srv.connect()
    ms = []
    try:
        for user in users:
            status, res, t = srv.request("POST", "/queries.json",
                                         {"user": user, "num": 10}, conn)
            check(status == 200, f"query {status}: {res}")
            check_user_answer(uf, itf, m_users[user], {"itemScores": [
                {"item": m_items[x["item"]], "score": x["score"]}
                for x in res["itemScores"]]})
            ms.append(t)
    finally:
        conn.close()
    return _percentiles(ms[1:])


def phase_network_storage(workdir: str) -> dict:
    """The port's network stores on the card host: ``pio storageserver``
    (a subprocess over its own SQLite file, bearer token) holds METADATA
    and EVENTDATA (TYPE=HTTP), tests/pg_mock.py's PostgreSQL server in this
    process holds MODELDATA (TYPE=PGSQL; standard library only). ``pio app
    new``, ``pio import`` of NET_IMPORT ML-1M-shaped events, ``pio train``
    (rank 32, 10 iterations, λ 0.01, the warp kernel; launches = implied):
    its factors bit-equal to the same train (run_train in this process)
    over a plain SQLite store holding the same events, and within 2e-4 of
    train_als on the triple.
    ``pio deploy`` under PIO_SSL_CERTFILE/KEYFILE (the throwaway pair of
    tests/fixtures/torch_tls): NET_QUERIES queries over HTTPS held to the
    host top-k, a plaintext request refused, p50/p99 beside a plaintext
    deploy's on the same model; ``GET /metrics`` over HTTPS (the stage
    histograms, the engine gauges, the storage transport and breaker
    families) and one traced query's query.* spans in the sink. Then
    ``pio eventserver`` (TLS) on the same stores takes single POSTs; the
    storage server is SIGKILLed: POSTs shed 503 with an integer
    Retry-After once the breaker opens, the engine server's /readyz
    answers 503 naming it after a /reload reaches the dead store; the
    storage server restarts on its port: after the reset time /readyz
    answers 200 and POSTs are accepted; every acknowledged event is read
    back exactly once.

    Returns what ``object_search_storage`` and ``operator_tools`` reuse:
    the events file, the plain triple, the SQLite twin's persisted model,
    its store (kept in ``workdir``) and train seconds, train_als's factors
    on the triple and the SQLite read seconds."""
    # tests/pg_mock.py by its path (the standard library only): tests/ never
    # joins sys.path, where its other helpers would shadow later imports
    spec = importlib.util.spec_from_file_location(
        "pg_mock", os.path.join(ROOT, "tests", "pg_mock.py"))
    pg_mock = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pg_mock)

    t_phase = time.perf_counter()
    cwd = tempfile.mkdtemp(dir=workdir)
    node = _StoreNode(_pio_env(os.path.join(cwd, "store_node"))
                      | {"PIO_STORAGESERVER_SECRET": "net-token"}, cwd,
                      _free_port())
    pg = pg_mock.MockPGServer(user="pio", password="pg-secret").__enter__()
    sinks = os.path.join(cwd, "trace.jsonl")
    try:
        node.start()
        env = _pio_env(os.path.join(cwd, "pio")) | {
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "PG",
            "PIO_STORAGE_SOURCES_NET_TYPE": "HTTP",
            "PIO_STORAGE_SOURCES_NET_HOSTS": "127.0.0.1",
            "PIO_STORAGE_SOURCES_NET_PORTS": str(node.port),
            "PIO_STORAGE_SOURCES_NET_SECRET": "net-token",
            "PIO_STORAGE_SOURCES_PG_TYPE": "PGSQL",
            "PIO_STORAGE_SOURCES_PG_HOST": "127.0.0.1",
            "PIO_STORAGE_SOURCES_PG_PORT": str(pg.port),
            "PIO_STORAGE_SOURCES_PG_USERNAME": "pio",
            "PIO_STORAGE_SOURCES_PG_PASSWORD": "pg-secret",
            **{f"PIO_STORAGE_SOURCES_NET_{k}": v
               for k, v in NET_BREAKER.items()}}
        for k in ("PIO_SSL_CERTFILE", "PIO_SSL_KEYFILE", "PIO_TRACE",
                  "PIO_TRACE_SINK", "PIO_FAULT_SPEC"):
            env.pop(k, None)
        events_path = os.path.join(cwd, "ml1m.jsonl")
        imported = _write_ml1m_jsonl(events_path, NET_IMPORT)
        import_s = {}
        _verb(["app", "new", "netapp"], env, cwd)
        out, _ = _verb(["import", "--app-name", "netapp", "--input",
                        events_path], env, cwd)
        import_s["http"] = _import_seconds(out.stdout, NET_IMPORT,
                                           "import over HTTP")
        out, _ = _verb(["app", "new", "netlive"], env, cwd)
        live_key = out.stdout.split("Access Key:")[1].split()[0]
        # the twin: the same file into a plain SQLite store, in this process
        # (the import verb's loop: parse, Event.from_json, insert_batch)
        sqlite_store = Storage({
            f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
            "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_S_PATH": os.path.join(cwd, "plain.sqlite")})
        twin_app = sqlite_store.get_meta_data_apps().insert(
            App(0, "netapp"))
        t0 = time.perf_counter()
        with open(events_path, encoding="utf-8") as fh:
            sqlite_store.get_l_events().insert_batch(
                [Event.from_json(json.loads(ln)) for ln in fh], twin_app)
        import_s["sqlite_in_process"] = time.perf_counter() - t0

        # train over the network stores, and over plain SQLite
        want = _expected_triple(imported, [])
        _write_engine_json(cwd, "netapp")
        net = _train_verb(env, cwd, "network_storage")
        _hold_train(net, want, "network_storage")
        # the same train (engine.json, code, card) over the SQLite twin, in
        # this process
        from incubator_predictionio_torch.workflow.core_workflow import (
            run_train,
        )

        with open(os.path.join(cwd, "engine.json"), encoding="utf-8") as fh:
            engine_json = json.load(fh)
        ctx = WorkflowContext(app_name="netapp", storage=sqlite_store,
                              device="cuda")
        ctx.read_timings, ctx.bench_timings = {}, {}
        reset_launches()
        t0 = time.perf_counter()
        plain = {"engineInstanceId": run_train(
            RecommendationEngine()(), EngineParams.from_json(engine_json),
            ctx, engine_factory_name=engine_json["engineFactory"])}
        torch.cuda.synchronize()
        plain.update(seconds=time.perf_counter() - t0,
                     kernel_launches=launches(),
                     timings={**ctx.read_timings, **ctx.bench_timings})
        record("network_storage_sqlite", plain["kernel_launches"])
        _hold_train(plain, want, "network_storage_sqlite")
        store = _storage_of(env)
        stored = _hold_model(store, net, want, "network_storage")
        twin = _hold_model(sqlite_store, plain, want,
                           "network_storage_sqlite")
        sqlite_store.close()
        # the twin's store outlives this phase: operator_tools trains the
        # Recommendation template over it
        twin_path = os.path.join(workdir, "network_storage_twin.sqlite")
        for name in os.listdir(cwd):
            if name.startswith("plain.sqlite"):
                shutil.move(os.path.join(cwd, name), os.path.join(
                    workdir, name.replace("plain.sqlite",
                                          "network_storage_twin.sqlite")))
        check(all(np.array_equal(stored[k], twin[k]) for k in
                  ("user_factors", "item_factors", "users", "items")),
              "the train over HTTP + PGSQL differs from the SQLite train")
        algo = als_engine(PIO_RANK, PIO_ITERS, PIO_LAMBDA)[2]
        ref = train_als(want["u"], want["i"], want["r"],
                        n_users=len(want["users"]),
                        n_items=len(want["items"]),
                        params=algo.als_params(algo.params), device="cuda")
        err = {"user": max_err(stored["user_factors"], ref.user_factors),
               "item": max_err(stored["item_factors"], ref.item_factors)}
        check(within(stored["user_factors"], ref.user_factors)
              and within(stored["item_factors"], ref.item_factors),
              f"network_storage train vs train_als: {err}")

        # deploy under TLS and plaintext, the event server under TLS
        tls = {"PIO_SSL_CERTFILE": TLS_CERT, "PIO_SSL_KEYFILE": TLS_KEY}
        rng = np.random.default_rng(41)
        users = [want["users"][int(k)]
                 for k in rng.integers(0, len(want["users"]), NET_QUERIES)]
        t_up = time.perf_counter()
        with contextlib.ExitStack() as stack:
            # the three processes start together (Popen in the
            # constructors) and are then waited for, so their start-ups
            # overlap; each is stopped on the way out whatever happens
            booting = []
            for cls, args, server_env in (
                    (_TLSServed, ["deploy"], env | tls | {
                        "PIO_TRACE": "0.000001", "PIO_TRACE_SINK": sinks}),
                    (_Served, ["deploy"], env),
                    (_TLSServed, ["eventserver"], env | tls)):
                booting.append(cls(args + ["--ip", "127.0.0.1"], server_env,
                                   cwd))
                stack.push(booting[-1].__exit__)
            srv, plain_srv, es = (s.__enter__() for s in booting)
            up_s = time.perf_counter() - t_up
            check(srv.info["engineInstanceId"] == net["engineInstanceId"],
                  f"TLS deploy serves {srv.info}")
            tls_q = _query_run(srv, users, stored)
            plain_q = _query_run(plain_srv, users, stored)
            refused = False
            try:
                plain_conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                        timeout=10)
                plain_conn.request("GET", "/")
                plain_conn.getresponse().read()
            except (OSError, http.client.HTTPException):
                refused = True
            check(refused, "the TLS deploy answered a plaintext request")

            # /metrics over HTTPS, one traced query
            status, _, _, _ = srv.request_h(
                "POST", "/queries.json", {"user": users[0], "num": 10},
                {"X-Pio-Trace-Id": "net-trace-1"})
            check(status == 200, f"traced query {status}")
            text = _metrics_text(srv)
            doc = srv.request("GET", "/status")[1]
            for stage in ("featurize", "predict", "serve"):
                check(_metric(text, "pio_query_stage_seconds_count",
                              stage=stage, batched="0") >= NET_QUERIES,
                      f"pio_query_stage_seconds{{stage={stage}}} missing")
            check(_metric(text, "pio_engine_query_count")
                  == doc["queryCount"] >= NET_QUERIES + 1,
                  f"pio_engine_query_count vs /status {doc['queryCount']}")
            check(_metric(text, "pio_storage_op_seconds_count",
                          backend="http.call") > 0,
                  "pio_storage_op_seconds{backend=http.call} missing")
            breaker = f"http:http://127.0.0.1:{node.port}"
            check(f'pio_storage_breaker_state{{endpoint="{breaker}"}} 0'
                  in text, "pio_storage_breaker_state missing or not 0")
            with open(sinks, encoding="utf-8") as fh:
                spans = [json.loads(ln) for ln in fh if ln.strip()]
            names = {s["span"] for s in spans
                     if s["traceId"] == "net-trace-1"}
            check({"query.featurize", "query.predict", "query.serve"}
                  <= names, f"trace spans {sorted(names)}")

            # single POSTs; SIGKILL the storage server; restart it
            live_store = _storage_of(env)
            conn = es.connect()
            acked = []

            def post(n: int, tag: str):
                codes = []
                for j in range(n):
                    code, body, _, headers = es.request_h(
                        "POST", f"/events.json?accessKey={live_key}", {
                            "event": "buy", "entityType": "user",
                            "entityId": f"{tag}{j}",
                            "targetEntityType": "item",
                            "targetEntityId": f"i{j % 50}"}, {}, conn)
                    if 200 <= code < 300:
                        acked.append(body["eventId"])
                    codes.append((code, body, headers))
                return codes

            check(all(c == 201 for c, _, _ in post(NET_POSTS, "before")),
                  "a POST before the outage was not acknowledged")
            node.kill()
            t_kill = time.perf_counter()
            shed = None
            outage_codes = []
            while shed is None:
                check(time.perf_counter() - t_kill < 30,
                      f"no 503 within 30 s of the kill: {outage_codes[-3:]}")
                code, body, headers = post(1, "outage")[0]
                outage_codes.append(code)
                if code == 503:
                    shed = (body, headers)
            open_s = time.perf_counter() - t_kill
            retry_after = int(shed[1]["Retry-After"])
            check(1 <= retry_after <= 2 * float(NET_BREAKER["BREAKER_RESET"])
                  + 1 and "temporarily unavailable" in shed[0]["message"],
                  f"shed answer {shed}")
            srv.request("GET", "/reload")
            code, ready, _ = srv.request("GET", "/readyz")
            check(code == 503 and ready["openBreakers"] == [breaker],
                  f"/readyz with the store dead: {code} {ready}")
            t_restart = time.perf_counter()  # the restart's boot included
            node.start()
            boot_s = time.perf_counter() - t_restart
            while True:
                check(time.perf_counter() - t_restart < 60,
                      "not ready within 60 s of the restart")
                code, ready, _ = srv.request("GET", "/readyz")
                if code == 200:
                    post_code = post(1, "recovered")[0][0]
                    if post_code == 201:
                        break
                time.sleep(0.05)
            ready_s = time.perf_counter() - t_restart
            srv.request("GET", "/reload")  # the half-open probe succeeds
            check('pio_storage_breaker_state{endpoint="%s"} 0' % breaker
                  in _metrics_text(srv), "the breaker did not close")
            check(all(c == 201 for c, _, _ in post(NET_POSTS, "after")),
                  "a POST after the restart was not acknowledged")
            conn.close()
            app_id = live_store.get_meta_data_apps().get_by_name("netlive").id
            got = [e.event_id for e in live_store.get_l_events().find(app_id)]
            # POSTs run one at a time and the kill falls between two, so
            # the store holds exactly the acknowledged events, each once
            check(sorted(got) == sorted(acked),
                  f"{len(acked)} acknowledged, {len(got)} read back, "
                  f"{len(set(acked) - set(got))} of them missing")
            live_store.close()
        store.close()
        emit("network_storage", events=NET_IMPORT, reduced=(
            f"first {NET_IMPORT} of the {ML1M[2]} ML-1M events (time budget)"),
             stores={"METADATA": "HTTP (pio storageserver over SQLite)",
                     "EVENTDATA": "HTTP", "MODELDATA": "PGSQL (pg_mock)"},
             import_events_per_s={k: NET_IMPORT / v
                                  for k, v in import_s.items()},
             read_seconds={"http": net["timings"]["read_seconds"],
                           "sqlite": plain["timings"]["read_seconds"]},
             train_seconds_run_train={"http": net["seconds"],
                                      "sqlite": plain["seconds"]},
             train_seconds_end_to_end_http=net["wall_seconds"],
             kernel_launches=net["kernel_launches"],
             expected_launches=net["expected_launches"],
             bit_equal_to_sqlite=True, max_abs_err_vs_train_als=err,
             servers_up_seconds=up_s, query_https=tls_q,
             query_plaintext=plain_q,
             breaker={"threshold": NET_BREAKER["BREAKER_THRESHOLD"],
                      "reset_s": NET_BREAKER["BREAKER_RESET"],
                      "seconds_kill_to_open": open_s,
                      "posts_until_503": len(outage_codes),
                      "retry_after": retry_after,
                      "seconds_restart_to_ready": ready_s,
                      "storage_server_boot_seconds": boot_s},
             acknowledged=len(acked),
             phase_seconds=time.perf_counter() - t_phase)
        # the events file outlives this phase's directory
        kept = os.path.join(workdir, "network_storage_events.jsonl")
        shutil.move(events_path, kept)
        return {"events_path": kept, "imported": imported,
                "want": want, "twin": twin, "ref": ref,
                "sqlite_read_seconds": plain["timings"]["read_seconds"],
                "sqlite_import_seconds": import_s["sqlite_in_process"],
                "twin_path": twin_path, "twin_seconds": plain["seconds"]}
    finally:
        node.stop()
        pg.__exit__(None, None, None)
        shutil.rmtree(cwd, ignore_errors=True)


# -- the object and search stores ----------------------------------------

#: the stand-in servers of tests/ (standard library; the RPC one on the
#: port's own hbase_rpc codec), loaded by path as tests/pg_mock.py is
STAND_INS = {"es": "torch_es_server", "s3": "torch_s3_server",
             "hbase_rest": "torch_hbase_server",
             "hbase_rpc": "torch_hbase_rpc_server",
             "hdfs": "torch_hdfs_server"}
OBJ_S3_KEYS = ("AKCHIPSMOKE", "chip-smoke-secret")
OBJ_PATHS = ("object_search_es_s3", "object_search_hbase_hdfs")


def _load_test_module(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _process_store(env: dict):
    """This process's Storage singleton on ``env``'s stores while a verb
    function runs in process (the verbs read ``Storage.instance()``);
    the previous singleton back after."""
    prev = Storage._singleton
    Storage._singleton = _storage_of(env)
    try:
        yield Storage._singleton
    finally:
        Storage._singleton.close()
        Storage._singleton = prev


def _in_process_verb(fn, args: list, env: dict) -> str:
    """A ``pio`` verb's function called in this process; its stdout."""
    buf = io.StringIO()
    with STDOUT_LOCK, _process_store(env), contextlib.redirect_stdout(buf):
        rc = fn(args)
    check(rc == 0, f"{fn.__name__} {args} returned {rc}: "
          f"{buf.getvalue()[-500:]}")
    return buf.getvalue()


def _sources(name: str, props: dict) -> dict:
    return {f"PIO_STORAGE_SOURCES_{name}_{k}": v for k, v in props.items()}


def _repos(meta: str, events: str, models: str) -> dict:
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": meta,
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": events,
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": models}


def _same_triples(a: tuple, b: tuple) -> bool:
    return (all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
            and list(a[3].to_dict().items()) == list(b[3].to_dict().items())
            and list(a[4].to_dict().items()) == list(b[4].to_dict().items()))


def phase_object_search_storage(workdir: str, net: dict) -> None:
    """The object and search stores on the card host, on the stand-in
    servers of tests/ (tests/torch_{es,s3,hbase,hbase_rpc,hdfs}_server.py)
    run as threads of this process, over network_storage's NET_IMPORT
    ML-1M-shaped events (the same file).

    Path A: METADATA and EVENTDATA on ELASTICSEARCH, MODELDATA on S3
    (SigV4 checked by the server): ``pio app new`` and ``pio import``
    through the verbs' functions in this process, then ``pio train``
    (rank 32, 10 iterations, λ 0.01; the ES read is the sliced PIT scan)
    and ``pio deploy``, which restores the model from S3; NET_QUERIES
    queries held to the host top-k. Path B: EVENTDATA on HBASE over the
    native RPC (each event table in two regions, split at the events'
    median time), MODELDATA on HDFS (WebHDFS, the 307 redirect), METADATA
    on the same Elasticsearch; its ``pio train`` starts together with
    path A's. Meanwhile, in this process, the same events through the
    HBase REST gateway and ``PEventStore.find_ratings`` over REST held
    equal to the one over RPC. Both trains: warp launches = implied, the
    factors bit-equal to network_storage's SQLite twin of the same events
    and within 2e-4 of its train_als."""
    from concurrent.futures import ThreadPoolExecutor

    from incubator_predictionio_torch.data.storage.hbase import HBLEvents
    from incubator_predictionio_torch.tools.commands.app import app_cmd
    from incubator_predictionio_torch.tools.commands.management import (
        import_cmd,
    )

    mods = {k: _load_test_module(v) for k, v in STAND_INS.items()}
    t_phase = time.perf_counter()
    cwd = tempfile.mkdtemp(dir=workdir)
    want, twin, ref = net["want"], net["twin"], net["ref"]
    events = net["events_path"]
    # each event table in two regions, split at the events' median time
    split = HBLEvents._data_key(int(np.median(net["imported"][3])) * 1000, 0)
    with contextlib.ExitStack() as stack:
        es = stack.enter_context(mods["es"].ESServer())
        s3 = stack.enter_context(mods["s3"].S3Server(*OBJ_S3_KEYS))
        rest = stack.enter_context(mods["hbase_rest"].HBaseRestServer())
        rpc = stack.enter_context(
            mods["hbase_rpc"].HBaseRpcServer(default_split=split))
        hdfs = stack.enter_context(mods["hdfs"].HDFSServer())
        base = _pio_env(os.path.join(cwd, "pio"))
        for k in ("PIO_SSL_CERTFILE", "PIO_SSL_KEYFILE", "PIO_TRACE",
                  "PIO_TRACE_SINK", "PIO_FAULT_SPEC", "PIO_ES_SLICES"):
            base.pop(k, None)
        es_src = _sources("ES", {"TYPE": "ELASTICSEARCH",
                                 "HOSTS": "127.0.0.1", "PORTS": str(es.port)})
        env_a = base | _repos("ES", "ES", "OBJ") | es_src | _sources("OBJ", {
            "TYPE": "S3", "ENDPOINT": f"http://127.0.0.1:{s3.port}",
            "BUCKET": "pio-models", "ACCESS_KEY": OBJ_S3_KEYS[0],
            "SECRET_KEY": OBJ_S3_KEYS[1]})
        env_b = base | _repos("ES", "HB", "DFS") | es_src | _sources("HB", {
            "TYPE": "HBASE", "HOSTS": "127.0.0.1", "PORTS": str(rpc.port),
            "PROTOCOL": "rpc"}) | _sources("DFS", {
                "TYPE": "HDFS", "HOSTS": "127.0.0.1",
                "PORTS": str(hdfs.port), "PATH": "/pio/models"})
        env_rest = env_b | _sources("HB", {
            "TYPE": "HBASE", "HOSTS": "127.0.0.1", "PORTS": str(rest.port),
            "PROTOCOL": "rest"})

        # app new + import through the verbs' functions, in this process
        import_s = {}
        for name, env, app in (("elasticsearch", env_a, "objapp"),
                               ("hbase_rpc", env_b, "hbapp")):
            _in_process_verb(app_cmd, ["new", app], env)
            import_s[name] = _import_seconds(_in_process_verb(
                import_cmd, ["--app-name", app, "--input", events], env),
                NET_IMPORT, f"import into {name}")
        meta = _storage_of(env_b)
        hb_app = meta.get_meta_data_apps().get_by_name("hbapp").id
        meta.close()
        table = rpc.tables[f"pio_eventdata_{hb_app}"]
        rows_by_region = [
            sum(1 for k in table.region_rows(name) if k.startswith(b"t:"))
            for _s, _e, name in table.regions]
        check(len(rows_by_region) == 2 and min(rows_by_region) > 0
              and sum(rows_by_region) == NET_IMPORT,
              f"hbase_rpc data rows by region {rows_by_region}")

        # both trains at once, each in its own process
        dirs = {path: os.path.join(cwd, path) for path in OBJ_PATHS}
        for (path, app, variant) in zip(OBJ_PATHS, ("objapp", "hbapp"),
                                        ("default", "hbase-hdfs")):
            os.makedirs(dirs[path])
            _write_engine_json(dirs[path], app, variant)
        # the two processes share the host's cores: each takes half for
        # its host-side torch threads (two at full width oversubscribe)
        half = {"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))}
        envs = dict(zip(OBJ_PATHS, (env_a | half, env_b | half)))
        pool = stack.enter_context(ThreadPoolExecutor(2))
        futures = {path: pool.submit(_train_verb, envs[path], dirs[path],
                                     path) for path in OBJ_PATHS}

        # meanwhile, in this process: the same events through the REST
        # gateway
        import_s["hbase_rest"] = _import_seconds(_in_process_verb(
            import_cmd, ["--app-name", "hbapp", "--input", events],
            env_rest), NET_IMPORT, "import into hbase_rest")

        trained, stored, err = {}, {}, {}
        for path in OBJ_PATHS:
            trained[path] = futures[path].result()
            _hold_train(trained[path], want, path)
            store = _storage_of(envs[path])
            stored[path] = _hold_model(store, trained[path], want, path)
            store.close()
            check(all(np.array_equal(stored[path][k], twin[k]) for k in
                      ("user_factors", "item_factors", "users", "items")),
                  f"{path}: the factors differ from the SQLite twin's")
            got_u, got_i = (stored[path]["user_factors"],
                            stored[path]["item_factors"])
            err[path] = {"user": max_err(got_u, ref.user_factors),
                         "item": max_err(got_i, ref.item_factors)}
            check(within(got_u, ref.user_factors)
                  and within(got_i, ref.item_factors),
                  f"{path} vs train_als: {err[path]}")
            if path == OBJ_PATHS[0]:
                # pio deploy of path A's model (restored from S3) boots
                # while path B still trains
                t_up = time.perf_counter()
                booting = _Served(["deploy", "--ip", "127.0.0.1"], env_a,
                                  dirs[path])
                stack.push(booting.__exit__)
        iid_a, iid_b = (trained[p]["engineInstanceId"] for p in OBJ_PATHS)
        check(any(iid_a in k for k in s3.objects),
              f"no S3 object holds {iid_a}: {sorted(s3.objects)}")
        check(any(iid_b in k for k in hdfs.files) and hdfs.redirects > 0,
              f"no HDFS file holds {iid_b} through a 307: "
              f"{sorted(hdfs.files)}")
        check(es.stats["sliced_search"] > 0 and es.stats["pit_open"] > 0,
              f"the ES training read took no sliced PIT scan: {es.stats}")
        store = _storage_of(env_a)
        t0 = time.perf_counter()
        model_artifact.read_model(store, iid_a)
        s3_restore_s = time.perf_counter() - t0
        store.close()

        # while the deploy boots: the training read over HBase REST and
        # over RPC, in this process (after the trains: the stand-ins share
        # this process's interpreter lock with the reads)
        reads, triples = {}, {}
        for name, env in (("hbase_rest", env_rest), ("hbase_rpc", env_b)):
            store = _storage_of(env)
            t0 = time.perf_counter()
            triples[name] = PEventStore.find_ratings("hbapp", storage=store)
            reads[name] = time.perf_counter() - t0
            store.close()
            _hold_triple(triples[name], want, f"find_ratings over {name}")
        check(_same_triples(triples["hbase_rest"], triples["hbase_rpc"]),
              "find_ratings over HBase REST differs from the one over RPC")
        del triples

        # the deploy restored path A's model from S3
        rng = np.random.default_rng(43)
        users = [want["users"][int(k)]
                 for k in rng.integers(0, len(want["users"]), NET_QUERIES)]
        srv = booting.__enter__()
        up_s = time.perf_counter() - t_up
        check(srv.info["engineInstanceId"] == iid_a,
              f"the deploy serves {srv.info}")
        queries = _query_run(srv, users, stored[OBJ_PATHS[0]])
    os.unlink(events)
    emit("object_search_storage", events=NET_IMPORT, reduced=(
        f"network_storage's first {NET_IMPORT} of the {ML1M[2]} ML-1M "
        "events (time budget)"),
        stores={"A": {"METADATA": "ELASTICSEARCH",
                      "EVENTDATA": "ELASTICSEARCH", "MODELDATA": "S3"},
                "B": {"METADATA": "ELASTICSEARCH",
                      "EVENTDATA": "HBASE (rpc, 2 regions)",
                      "MODELDATA": "HDFS"},
                "in_process": "HBASE (rest) beside HBASE (rpc)"},
        servers="tests/torch_*_server.py, threads of this process",
        import_events_per_s={k: NET_IMPORT / v for k, v in import_s.items()}
        | {"sqlite_in_process": NET_IMPORT / net["sqlite_import_seconds"]},
        read_seconds={
            "elasticsearch": trained[OBJ_PATHS[0]]["timings"]["read_seconds"],
            "hbase_rpc": trained[OBJ_PATHS[1]]["timings"]["read_seconds"],
            "hbase_rest_in_process": reads["hbase_rest"],
            "hbase_rpc_in_process": reads["hbase_rpc"],
            "sqlite": net["sqlite_read_seconds"]},
        train_seconds_end_to_end={p: trained[p]["wall_seconds"]
                                  for p in OBJ_PATHS},
        kernel_launches={p: trained[p]["kernel_launches"] for p in OBJ_PATHS},
        expected_launches={p: trained[p]["expected_launches"]
                           for p in OBJ_PATHS},
        bit_equal_to_sqlite=True, max_abs_err_vs_train_als=err,
        es_requests=dict(es.stats),
        hbase_rpc_data_rows_by_region=rows_by_region,
        hdfs_create_redirects=hdfs.redirects,
        s3_restore_seconds=s3_restore_s,
        deploy_up_seconds_from_train_a_end=up_s,
        query=queries, phase_seconds=time.perf_counter() - t_phase)
    shutil.rmtree(cwd, ignore_errors=True)


#: the gang's size: two ranks of a gloo process group on the one card
GANG_WORKERS = 2
#: the Similar-Product gang's category count ($set events on the items)
GANG_CATEGORIES = 20
#: λ of the gang's engines (× n_ratings for Recommendation; Spark ALS's
#: default regParam): at PIO_LAMBDA = 0.01 the per-user systems of this
#: log are conditioned so poorly that the float32 summation order alone
#: (a per-event scatter-add against per-row bmm) moves the factors past
#: TOL
GANG_LAMBDA = 0.1
GANG_KNOBS = {"PIO_SUPERVISOR_POLL_MS": "50", "PIO_WORKER_HEARTBEAT_MS": "200",
              "PIO_TRAIN_FEED": "partition"}


def _gang_engine(gdir: str, factory: str, app: str, extra_ds=None,
                 extra_algo=None) -> None:
    os.makedirs(gdir, exist_ok=True)
    with open(os.path.join(gdir, "engine.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"id": "default", "engineFactory": factory,
                   "datasource": {"params": {"appName": app,
                                             **(extra_ds or {})}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": PIO_RANK, "numIterations": PIO_ITERS,
                       "lambda": GANG_LAMBDA, **(extra_algo or {})}}]}, fh)


def _gang_verb(env: dict, gdir: str, extra=(), timeout: int = 300) -> dict:
    """``pio train --num-workers 2 --checkpoint-every 2`` (the card, gloo);
    its last JSON line with ``wall_seconds``."""
    out, wall = _verb(["train", "--num-workers", str(GANG_WORKERS),
                       "--checkpoint-every", "2", *extra], env, gdir,
                      timeout=timeout)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["wall_seconds"] = wall
    return got


def _gang_launches(got: dict) -> dict:
    """The warp and wide launches every worker of a gang that completed
    without a restart reported (each counted from 0 in its own
    process)."""
    check(got["state"] == "completed" and all(got["workers"])
          and got["restarts"] == 0,
          f"gang ended {got['state']} after {got['restarts']} restart(s): "
          f"{got.get('runDir')}")
    return {kind: sum(w["kernel_launches"][kind] for w in got["workers"])
            for kind in ("warp", "wide")}


def _gang_factors(store: Storage, iid: str) -> dict:
    _, persisted = models_from_bytes(model_artifact.read_model(store, iid))
    return persisted[0]


def _hold_gang(got: dict, store: Storage, app: str, names: list,
               implicit: bool, path: str, users=None) -> tuple:
    """A completed gang on the card: the workers' shards disjoint and
    covering the log, every rating read once, the warp launches those the
    row blocks and the solve buffer imply, and the factors within TOL of
    the port's train_als (device="cuda") on the union triple mapped into
    the gang's indices. Returns (stored model, launches, max |err|)."""
    launches = _gang_launches(got)
    app_id = store.get_meta_data_apps().get_by_name(app).id
    canonical = jsonl_shard_paths(store.get_l_events().events_dir, app_id)
    shards = [w["timings"]["shards"] for w in got["workers"]]
    check(shards == [canonical[w::GANG_WORKERS]
                     for w in range(GANG_WORKERS)],
          f"{path}: shards {shards}, canonical {canonical}")
    stored = _gang_factors(store, got["engineInstanceId"])
    u, i, r, m_users, m_items = PEventStore.find_ratings(
        app, event_names=names, rating_from_props=not implicit,
        storage=store)
    check(sum(w["timings"]["local_ratings"] for w in got["workers"])
          == len(u), f"{path}: the workers read {len(u)} ratings between "
          "them?")
    g_items = BiMap.from_persisted(stored["items"])
    g_users = BiMap.from_persisted(users if users is not None
                                   else stored["users"])
    check(sorted(g_items.keys()) == sorted(m_items.keys())
          and len(g_users) == len(m_users), f"{path}: id maps differ")
    iu = np.asarray([g_users(x) for x in
                     (m_users.inverse(int(v)) for v in u)], np.int32)
    ii = np.asarray([g_items(x) for x in
                     (m_items.inverse(int(v)) for v in i)], np.int32)
    params = ALSParams(rank=PIO_RANK, num_iterations=PIO_ITERS,
                       reg=GANG_LAMBDA, implicit_prefs=implicit,
                       lambda_scaling="plain" if implicit else "nratings")
    t0 = time.perf_counter()
    ref = train_als(iu, ii, r, len(g_users), len(g_items), params,
                    device="cuda")
    train_als_s = time.perf_counter() - t0
    # the same data-parallel trainer as one rank alone in this process
    # (one CUDA context on the card): what the gang's two contexts cost
    alone: dict = {}
    t0 = time.perf_counter()
    als.train_als_partition_local(iu, ii, r, len(g_users), len(g_items),
                                  params, device="cuda", force_dp=True,
                                  timings=alone)
    alone = {"seconds": time.perf_counter() - t0,
             "train_als_seconds": train_als_s,
             **{k: alone[k] for k in (
                 "device_train_seconds", "gram_seconds_per_half_step",
                 "solve_seconds_per_half_step")}}
    err = max(max_err(stored["user_factors"], ref.user_factors),
              max_err(stored["item_factors"], ref.item_factors))
    check(within(stored["user_factors"], ref.user_factors)
          and within(stored["item_factors"], ref.item_factors),
          f"{path}: gang vs train_als max |err| {err}")
    per_rank = (als.dp_solve_calls_per_half_step(
        -(-len(g_users) // GANG_WORKERS), PIO_RANK)
        + als.dp_solve_calls_per_half_step(
            -(-len(g_items) // GANG_WORKERS), PIO_RANK))
    expected = GANG_WORKERS * PIO_ITERS * per_rank
    check(launches == {"warp": expected, "wide": 0},
          f"{path}: launches {launches} != implied {expected} warp")
    check(all(w["timings"]["solve_calls_per_iteration"] == per_rank
              for w in got["workers"]), f"{path}: solve calls per rank")
    record(path, launches)
    return stored, launches, err, expected, alone


def _gang_numbers(got: dict) -> dict:
    return {"seconds_end_to_end": got["wall_seconds"],
            "restarts": got["restarts"],
            "workers": [{
                "rank": w["timings"]["rank"],
                "shards": [os.path.basename(p) for p in w["timings"]["shards"]],
                "local_ratings": w["timings"]["local_ratings"],
                "read_seconds": w["timings"]["read_seconds"],
                "device_train_seconds": w["timings"]["device_train_seconds"],
                "train_seconds": w["seconds"],
                "half_steps": w["timings"]["half_steps"],
                "gram_seconds_per_half_step":
                    w["timings"]["gram_seconds_per_half_step"],
                "solve_seconds_per_half_step":
                    w["timings"]["solve_seconds_per_half_step"],
                "checkpoint_save_seconds":
                    w["timings"]["checkpoint_save_seconds"],
                "allreduce_bytes_per_half_step":
                    w["timings"]["allreduce_bytes_per_half_step"],
                "allreduce_seconds_per_half_step":
                    w["timings"]["allreduce_seconds_per_half_step"],
                "kernel_launches": w["kernel_launches"]}
                for w in got["workers"]]}


def _gang_crash_restart(env: dict, gdir: str) -> dict:
    """The gang under the port's supervisor with worker 1 armed to die
    (``train.sweep:crash:2``: after the step-2 snapshot) on the first
    attempt only; the seconds from the failure to the relaunched gang's
    first heartbeats are watched while it runs."""
    from incubator_predictionio_torch.parallel.supervisor import (
        GangConfig, Supervisor,
    )

    gang_id = new_event_id()
    run_dir = os.path.join(env["PIO_FS_BASEDIR"], "gang", gang_id)
    sup = Supervisor(
        CONSOLE + ["train", "--engine-dir", gdir, "--checkpoint-every", "2"],
        GANG_WORKERS,
        env=env, per_worker_env=lambda a, i: (
            {"PIO_FAULT_SPEC": "train.sweep:crash:2"} if a == 0 and i == 1
            else {}),
        config=GangConfig(num_workers=GANG_WORKERS, heartbeat_ms=200.0,
                          poll_ms=50.0, max_restarts=1),
        run_dir=run_dir, gang_instance_id=gang_id)
    box: dict = {}
    t = threading.Thread(target=lambda: box.update(outcome=sup.run()),
                         daemon=True)
    t0 = time.perf_counter()
    t.start()
    failed_at = back_at = None
    while t.is_alive() and time.perf_counter() - t0 < 300:
        if failed_at is None and any(e["type"] == "failure"
                                     for e in list(sup.events)):
            failed_at = time.perf_counter()
        if failed_at is not None and back_at is None and any(
                e["type"] == "gangStart" and e["attempt"] == 1
                for e in list(sup.events)) and all(
                os.path.exists(os.path.join(run_dir, f"worker_{w}.hb"))
                for w in range(GANG_WORKERS)):
            back_at = time.perf_counter()
        time.sleep(0.02)
    t.join(30)
    check(not t.is_alive() and box.get("outcome") == "completed",
          f"crashed gang ended {box} {sup.events[-3:]}")
    failures = [e for e in sup.events if e["type"] == "failure"]
    check(sup.restarts == 1 and [(f["reason"], f["worker"])
                                 for f in failures] == [("exit", 1)],
          f"restarts {sup.restarts}, failures {failures}")
    check(back_at is not None, "the relaunched gang never beat")
    backoff = next(e["backoff_s"] for e in sup.events
                   if e["type"] == "restart")
    return {"gang_id": gang_id, "seconds": time.perf_counter() - t0,
            "restarts": sup.restarts, "failure": failures[0],
            "seconds_crash_to_back_at_work": back_at - failed_at,
            "restart_backoff_s": backoff}


def _gang_drain_resume(env: dict, gdir: str) -> dict:
    """SIGTERM to ``pio train --num-workers 2`` mid-train (every sweep
    slowed by 0.5 s so the signal lands with sweeps ahead): the gang drains
    at a sweep boundary with a snapshot, exit 0 and ``supervisor.json``
    ``drained`` as in the reference; then ``--resume`` completes the same
    instance."""
    slow = env | {"PIO_FAULT_SPEC": "train.sweep:latency:100:0.5"}
    proc = subprocess.Popen(
        CONSOLE + ["train", "--num-workers", str(GANG_WORKERS),
                   "--checkpoint-every", "2"], env=slow, cwd=gdir,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        check("Gang training:" in first, f"gang start line {first!r}")
        gang_id = first.split("instance ")[1].split(",")[0]
        run_dir = first.split("run dir ")[1].strip()
        hb = os.path.join(run_dir, "worker_0.hb")
        deadline = time.time() + 240
        while not os.path.exists(hb):
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError(
                    f"gang never beat: {proc.stderr.read()[-2000:]}")
            time.sleep(0.02)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        drain_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"drained gang exited {proc.returncode}: "
          f"{err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    with open(os.path.join(run_dir, "supervisor.json"),
              encoding="utf-8") as fh:
        doc = json.load(fh)
    done = [e for e in doc["events"] if e["type"] == "drainDone"]
    check(got["state"] == "drained" and doc["state"] == "drained"
          and done and not done[0]["stragglers"]
          and set(done[0]["rcs"].values()) == {3},
          f"drain: {got['state']}, {doc['state']}, {done}, events "
          f"{[e['type'] for e in doc['events']]}, SIGTERM {drain_s:.2f} s "
          f"before the exit; stdout {out[-1500:]}")
    ckpt = os.path.join(env["PIO_FS_BASEDIR"], "checkpoints", gang_id,
                        "algo_0_als")
    steps = sorted(int(n.split(".")[0]) for n in os.listdir(ckpt)
                   if n.endswith(".npz"))
    check(steps and steps[-1] < PIO_ITERS, f"drain snapshots {steps}")
    resumed = _gang_verb(env, gdir, ["--resume"])
    check(resumed["engineInstanceId"] == gang_id,
          f"--resume trained {resumed['engineInstanceId']}, not {gang_id}")
    return {"gang_id": gang_id, "seconds_sigterm_to_exit": drain_s,
            "snapshot_steps": steps, "resume": resumed}


def phase_gang_train(cwd: str, env: dict, single_train_s: float) -> None:
    """``pio train --num-workers 2`` on the card off the partitioned ML-1M
    log of ``eventserver_partitioned`` (rank 32, GANG_LAMBDA·n_ratings):
    two ranks of
    a gloo process group share the card, each reads only its own shards,
    the grams are all-reduced and each rank solves its row block with the
    warp kernel. Then a worker crash (one gang restart from the snapshot),
    a SIGTERM drain and ``--resume``, and a Similar-Product gang whose
    model serves through ``deploy``."""
    env = env | GANG_KNOBS
    store = _storage_of(env)
    factory = ("incubator_predictionio_torch.models.recommendation."
               "RecommendationEngine")
    gdir = os.path.join(cwd, "gang_rec")
    _gang_engine(gdir, factory, "part",
                 extra_algo={"lambdaScaling": "nratings"})
    got = _gang_verb(env, gdir)
    stored, launches, err, expected, alone = _hold_gang(
        got, store, "part", ["rate", "buy"], False, "gang_train")
    emit("gang_train", **_gang_numbers(got),
         single_process_train_seconds_end_to_end=single_train_s,
         one_rank_alone_in_process=alone,
         kernel_launches=launches, expected_launches=expected,
         max_abs_err_vs_train_als=err)

    crash = _gang_crash_restart(env, gdir)
    crashed = _gang_factors(store, crash.pop("gang_id"))
    delta = max(max_err(crashed["user_factors"], stored["user_factors"]),
                max_err(crashed["item_factors"], stored["item_factors"]))
    check(within(crashed["user_factors"], stored["user_factors"])
          and within(crashed["item_factors"], stored["item_factors"]),
          f"restarted gang vs uninterrupted: {delta}")
    emit("gang_train_crash_restart", **crash,
         max_abs_delta_vs_uninterrupted=delta)

    drain = _gang_drain_resume(env, gdir)
    resumed = drain.pop("resume")
    final = _gang_factors(store, drain.pop("gang_id"))
    delta = max(max_err(final["user_factors"], stored["user_factors"]),
                max_err(final["item_factors"], stored["item_factors"]))
    check(within(final["user_factors"], stored["user_factors"])
          and within(final["item_factors"], stored["item_factors"]),
          f"drained and resumed gang vs uninterrupted: {delta}")
    emit("gang_train_drain_resume", **drain,
         resume_seconds_end_to_end=resumed["wall_seconds"],
         max_abs_delta_vs_uninterrupted=delta)

    # Similar-Product: implicit ALS on the same rate events, the item
    # categories as $set events in the base log (canonical position 0)
    _, _, _, _, m_items = PEventStore.find_ratings("part", storage=store)
    cats = {item: f"c{j % GANG_CATEGORIES}"
            for j, item in enumerate(m_items.keys())}
    store.get_l_events().insert_batch([Event.from_json({
        "event": "$set", "entityType": "item", "entityId": item,
        "properties": {"categories": [c]}, "eventTime": CREATED_ISO})
        for item, c in cats.items()],
        store.get_meta_data_apps().get_by_name("part").id)
    sdir = os.path.join(cwd, "gang_sp")
    _gang_engine(sdir, "incubator_predictionio_torch.models.similar_product."
                 "SimilarProductEngine", "part",
                 extra_ds={"eventNames": ["rate"]})
    sp = _gang_verb(env, sdir)
    sp_stored, sp_launches, sp_err, sp_expected, sp_alone = _hold_gang(
        sp, store, "part", ["rate"], True, "gang_train_similar_product",
        users=stored["users"])
    check({k: set(v) for k, v in sp_stored["item_categories"].items()}
          == {k: {v} for k, v in cats.items()}, "gang categories differ")
    store.close()
    itf = sp_stored["item_factors"]
    normed = itf / (np.linalg.norm(itf, axis=1, keepdims=True) + 1e-9)
    items = BiMap.from_persisted(sp_stored["items"])
    first = next(iter(cats))
    with _Served(["deploy"], env, sdir) as srv:
        check(srv.info["engineInstanceId"] == sp["engineInstanceId"],
              f"deployed {srv.info}")
        q = {"items": [first], "num": 4, "categories": [cats[first]]}
        status, res, query_ms = srv.request("POST", "/queries.json", q)
    check(status == 200, f"similar-product query {status}: {res}")
    allowed = np.asarray([cats[items.inverse(j)] == cats[first]
                          for j in range(len(items))])
    allowed[items(first)] = False
    host = normed @ normed[items(first)]
    want = [items.inverse(int(j)) for j in
            np.argsort(-np.where(allowed, host, -np.inf), kind="stable")[:4]]
    got_items = [x["item"] for x in res["itemScores"]]
    check(got_items == want and np.allclose(
        [x["score"] for x in res["itemScores"]],
        [host[items(x)] for x in want], rtol=1e-4, atol=1e-4),
          f"similar-product answer {got_items} != host {want}")
    emit("gang_train_similar_product", **_gang_numbers(sp),
         one_rank_alone_in_process=sp_alone,
         kernel_launches=sp_launches, expected_launches=sp_expected,
         max_abs_err_vs_train_als=sp_err, query=q, answer=got_items,
         query_ms=query_ms)


#: the slab gang's 2-D layout: PIO_MESH_SHAPE (d, m) = (2, 2), four ranks
#: on the one card
ALX_MESH = (2, 2)


def _slab_calls(u, i, n_users: int, n_items: int, params: ALSParams,
                dims: tuple) -> int:
    """Solve calls ONE rank of a slab gang on a (d, m) mesh makes per
    iteration: its data shard of both sides' plans."""
    return sum(solve_calls_per_half_step(plan_layout(
        np.bincount(rows, minlength=n), dims[0], dims[1]), params, 1)
        for rows, n in ((u, n_users), (i, n_items)))


def _slab_verb(env: dict, gdir: str, workers: int, mesh: str = "") -> dict:
    """``pio train --num-workers N --feed merged --checkpoint-every 2`` (the
    card, gloo; ``PIO_MESH_SHAPE`` when given); its last JSON line with
    ``wall_seconds``."""
    out, wall = _verb(["train", "--num-workers", str(workers), "--feed",
                       "merged", "--checkpoint-every", "2"],
                      env | ({"PIO_MESH_SHAPE": mesh} if mesh else {}), gdir,
                      timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["wall_seconds"] = wall
    return got


def _hold_slab(got: dict, store: Storage, dims: tuple, path: str,
               ref: ALSFactors, want: dict, params: ALSParams,
               max_rel_norm: float = 0.0) -> tuple:
    """A completed merged gang: every rank read the whole merged view, the
    persisted id maps are that read's, the warp launches those the (d, m)
    plan implies, the factors within TOL of the in-process train_als of
    the merged triple (with ``max_rel_norm``: within that relative-norm
    gap instead). Returns (stored model, launches, max |err|, expected
    launches)."""
    world = dims[0] * dims[1]
    launches = _gang_launches(got)
    check(len(got["workers"]) == world, f"{path}: {len(got['workers'])} "
          "workers reported")
    stored = _gang_factors(store, got["engineInstanceId"])
    check(list(BiMap.from_persisted(stored["users"]).keys()) == want["users"]
          and list(BiMap.from_persisted(stored["items"]).keys())
          == want["items"], f"{path}: id maps differ from the merged read")
    for w in got["workers"]:
        t = w["timings"]
        check(t["feed"] == "merged" and t["local_ratings"] == len(want["u"])
              and t["mesh"] == list(dims), f"{path}: worker timings {t}")
    err = max(max_err(stored["user_factors"], ref.user_factors),
              max_err(stored["item_factors"], ref.item_factors))
    if max_rel_norm:
        rel = max(rel_norm(stored["user_factors"], ref.user_factors),
                  rel_norm(stored["item_factors"], ref.item_factors))
        check(rel <= max_rel_norm, f"{path}: gang vs train_als relative "
                                   f"norm {rel}, max |err| {err}")
    else:
        check(within(stored["user_factors"], ref.user_factors)
              and within(stored["item_factors"], ref.item_factors),
              f"{path}: gang vs train_als max |err| {err}")
    per_rank = _slab_calls(want["u"], want["i"], len(want["users"]),
                           len(want["items"]), params, dims)
    expected = world * params.num_iterations * per_rank
    check(launches == {"warp": expected, "wide": 0},
          f"{path}: launches {launches} != implied {expected} warp")
    check(all(w["timings"]["solve_calls_per_iteration"] == per_rank
              for w in got["workers"]), f"{path}: solve calls per rank")
    record(path, launches)
    return stored, launches, err, expected


def _slab_numbers(got: dict) -> dict:
    keys = ("rank", "coords", "read_seconds", "layout_seconds",
            "upload_seconds", "device_train_seconds", "half_steps",
            "gram_seconds_per_half_step", "solve_seconds_per_half_step",
            "allreduce_bytes_per_half_step",
            "allreduce_seconds_per_half_step",
            "allgather_bytes_per_half_step",
            "allgather_seconds_per_half_step", "factor_bytes_resident",
            "checkpoint_save_seconds")
    return {"seconds_end_to_end": got["wall_seconds"],
            "restarts": got["restarts"],
            "workers": [dict({k: w["timings"].get(k) for k in keys},
                             train_seconds=w["seconds"],
                             kernel_launches=w["kernel_launches"])
                        for w in got["workers"]]}


def phase_gang_train_merged(cwd: str, env: dict) -> None:
    """The slab gang on eventserver_partitioned's store (ROADMAP items 7.1
    and 7.6): ``pio train --num-workers 2 --feed merged`` for the
    Recommendation template (rank 32, 10 iterations, GANG_LAMBDA·n), every
    rank reading the merged view, each solving its data shard with the
    warp kernel against the replicated counterpart; then
    ``PIO_MESH_SHAPE=2x2 pio train --num-workers 4 --feed merged``, the 2-D
    ALX layout (four ranks, four CUDA contexts on the card: each holds half
    of each factor matrix and sums its partial grams over its model
    group), whose model serves one query through ``deploy`` held to the
    host top-k. Both within TOL of the in-process train_als of the merged
    triple, warp launches = the plan's."""
    env = env | GANG_KNOBS
    store = _storage_of(env)
    factory = ("incubator_predictionio_torch.models.recommendation."
               "RecommendationEngine")
    gdir = os.path.join(cwd, "gang_merged")
    _gang_engine(gdir, factory, "part",
                 extra_algo={"lambdaScaling": "nratings"})
    u, i, r, users, items = PEventStore.find_ratings(
        "part", event_names=["rate", "buy"], storage=store)
    want = {"u": u, "i": i, "users": list(users.keys()),
            "items": list(items.keys())}
    params = ALSParams(rank=PIO_RANK, num_iterations=PIO_ITERS,
                       reg=GANG_LAMBDA, lambda_scaling="nratings")
    t0 = time.perf_counter()
    ref = train_als(u, i, r, len(users), len(items), params, device="cuda")
    ref_s = time.perf_counter() - t0
    got = _slab_verb(env, gdir, GANG_WORKERS)
    _, launches, err, expected = _hold_slab(
        got, store, (GANG_WORKERS, 1), "gang_train_merged", ref, want,
        params)
    one_d = _slab_numbers(got)
    emit("gang_train_merged", **one_d, train_als_seconds=ref_s,
         kernel_launches=launches, expected_launches=expected,
         max_abs_err_vs_train_als=err)

    world = ALX_MESH[0] * ALX_MESH[1]
    alx = _slab_verb(env, gdir, world, mesh="x".join(map(str, ALX_MESH)))
    stored, launches, err, expected = _hold_slab(
        alx, store, ALX_MESH, "gang_train_alx", ref, want, params)
    store.close()
    resident = {"alx": [w["timings"]["factor_bytes_resident"]
                        for w in alx["workers"]],
                "one_d": [w["timings"]["factor_bytes_resident"]
                          for w in got["workers"]]}
    check(all(abs(2 * b / resident["one_d"][0] - 1) < 0.01
              for b in resident["alx"]),
          f"the 2-D layout keeps half of each matrix per rank: {resident}")
    user = want["users"][0]
    with _Served(["deploy"], env, gdir) as srv:
        check(srv.info["engineInstanceId"] == alx["engineInstanceId"],
              f"deployed {srv.info}")
        q = {"user": user, "num": 10}
        status, res, query_ms = srv.request("POST", "/queries.json", q)
    check(status == 200, f"alx query {status}: {res}")
    answer = _hold_als_answer(stored, user, res)
    emit("gang_train_alx", **_slab_numbers(alx), mesh=list(ALX_MESH),
         factor_bytes_resident=resident,
         kernel_launches=launches, expected_launches=expected,
         max_abs_err_vs_train_als=err, query=q, answer=answer,
         query_ms=query_ms)

    # the same 2-D gang with "computeDtype": "bfloat16", held to the
    # in-process bfloat16 train by the relative norm (als_bf16_card_vs_cpu)
    bdir = os.path.join(cwd, "gang_merged_bf16")
    _gang_engine(bdir, factory, "part", extra_algo={
        "lambdaScaling": "nratings", "computeDtype": "bfloat16"})
    bparams = dataclasses.replace(params, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    bref = train_als(u, i, r, len(users), len(items), bparams, device="cuda")
    bref_s = time.perf_counter() - t0
    bf16 = _slab_verb(env, bdir, world, mesh="x".join(map(str, ALX_MESH)))
    store = _storage_of(env)
    stored, launches, err, expected = _hold_slab(
        bf16, store, ALX_MESH, "gang_train_alx_bf16", bref, want, bparams,
        max_rel_norm=BF16_REL_NORM)
    store.close()
    rel = max(rel_norm(stored["user_factors"], bref.user_factors),
              rel_norm(stored["item_factors"], bref.item_factors))
    rel_f32 = max(rel_norm(stored["user_factors"], ref.user_factors),
                  rel_norm(stored["item_factors"], ref.item_factors))
    check(rel_f32 >= BF16_MIN_GAP,
          f"gang_train_alx_bf16 within {rel_f32} of the float32 train_als: "
          f"not a bfloat16 train")
    with _Served(["deploy"], env, bdir) as srv:
        check(srv.info["engineInstanceId"] == bf16["engineInstanceId"],
              f"deployed {srv.info}")
        status, res, query_ms = srv.request("POST", "/queries.json", q)
    check(status == 200, f"alx bf16 query {status}: {res}")
    answer = _hold_als_answer(stored, user, res)
    emit("gang_train_alx_bf16", **_slab_numbers(bf16), mesh=list(ALX_MESH),
         kernel_launches=launches, expected_launches=expected,
         rel_norm_vs_train_als=rel, max_abs_err_vs_train_als=err,
         rel_norm_vs_float32_train_als=rel_f32,
         held_to=f"rel_norm<={BF16_REL_NORM}, rel_norm_vs_float32>="
                 f"{BF16_MIN_GAP}", train_als_seconds=bref_s,
         query=q, answer=answer, query_ms=query_ms)


#: the process-sharded trainer's run: the main path's ML-20M triple at
#: rank 32, 3 iterations, λ 0.01·n_ratings (at plain λ 0.01 two correct
#: float32 solvers differ by ≈ 1e-3 on nearly singular rows), on a (2, 2)
#: mesh of four ranks on the one card
SHARDED_PARAMS = ALSParams(rank=RANK, num_iterations=ITERS, reg=0.01,
                           lambda_scaling="nratings")
SHARDED_RANK_FLAG = "--als-process-sharded-rank"
TAIL_FLAG = "--tail-group"


def tail_group(out_dir: str, elapsed_at_spawn: str) -> int:
    """The tail's second group of phases (this script re-invoked with
    :data:`TAIL_FLAG` by :class:`_TailGroup`), beside the main process's
    CCO and rank-128 phases: similar_product, ecommerce_jsonl, pio_eval,
    the linear phases and their gangs. Its ``elapsed_s`` continues the
    main process's clock; its paths' launches go to ``out_dir``."""
    global START
    START = time.perf_counter() - float(elapsed_at_spawn)
    phase_device()
    with tempfile.TemporaryDirectory() as workdir:
        phase_similar_product(workdir)
        phase_ecommerce_jsonl(workdir)
        phase_pio_eval(workdir)
        phase_classification_gang(phase_classification_jsonl(workdir))
        text = phase_text_classification_jsonl(workdir)
        phase_text_classification_gang(text)
        phase_linear_streams(text)
    with open(os.path.join(out_dir, "launches.json"), "w",
              encoding="utf-8") as fh:
        json.dump(PATH_LAUNCHES, fh)
    return 0


#: the rules ``pio lint`` runs (its catalog)
LINT_RULES = 23


def phase_lint() -> None:
    """``pio lint --json`` over this checkout, on the card host: a parse
    pass that imports neither torch nor jax and touches no card. It must
    exit 0 with no finding and run every rule; its seconds are printed."""
    t0 = time.perf_counter()
    out = subprocess.run(CONSOLE + ["lint", "--json"], capture_output=True,
                         text=True, env=_console_env(), cwd=ROOT,
                         timeout=300)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0,
          f"pio lint exited {out.returncode}: {out.stdout[-3000:]}"
          f"{out.stderr[-1000:]}")
    doc = json.loads(out.stdout)
    check(doc["clean"] and not doc["findings"],
          f"pio lint found {len(doc['findings'])} finding(s)")
    check(len(doc["rules"]) == LINT_RULES,
          f"pio lint ran {len(doc['rules'])} rules, not {LINT_RULES}")
    emit("lint", seconds=seconds, rules=len(doc["rules"]),
         modules=doc["modules"], findings=len(doc["findings"]),
         suppressed=doc["suppressed"])


class _Beside:
    """``fn(*args)`` in a thread while the ``with`` body runs (both bound
    by process starts: the pair takes ≈ the longer one); joined on exit,
    its exception re-raised. Only for a phase that launches no kernel in
    this process that a path counts (the counters are per process) and
    prints only through :func:`emit`."""

    def __init__(self, fn, *args):
        self.error: list = []

        def run():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised on exit
                self.error.append(e)

        self.thread = threading.Thread(target=run, name=fn.__name__)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, exc_type, *exc):
        self.thread.join()
        if self.error and exc_type is None:
            raise self.error[0]


class _TailGroup:
    """:func:`tail_group` in a process of its own while the ``with`` body
    runs: the two groups are independent and each is bound by process
    starts and the host, so together they take ≈ the longer one. On exit
    its phase lines are printed, its paths' launches join
    ``PATH_LAUNCHES``, and a failure of either fails the run (the child
    is killed if the body raised)."""

    def __enter__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_tail_")
        self.out = open(os.path.join(self.dir, "stdout"), "w+",
                        encoding="utf-8")
        self.err = open(os.path.join(self.dir, "stderr"), "w+",
                        encoding="utf-8")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), TAIL_FLAG, self.dir,
             str(time.perf_counter() - START)],
            stdout=self.out, stderr=self.err, env=_console_env(), cwd=ROOT)
        return self

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is not None:
                self.proc.kill()
            rc = self.proc.wait()
            self.out.seek(0)
            sys.stdout.write(self.out.read())
            sys.stdout.flush()
            if exc_type is None:
                self.err.seek(0)
                check(rc == 0, f"the tail group failed ({rc}): "
                      f"{self.err.read()[-3000:]}")
                with open(os.path.join(self.dir, "launches.json"),
                          encoding="utf-8") as fh:
                    PATH_LAUNCHES.update(json.load(fh))
        finally:
            self.out.close()
            self.err.close()
            shutil.rmtree(self.dir, ignore_errors=True)


def als_process_sharded_rank(out_dir: str) -> int:
    """One rank of ``als_process_sharded`` (this script re-invoked with
    :data:`SHARDED_RANK_FLAG` and the gang's ``PIO_*`` wiring): build the
    seeded ML-20M triple, keep only the rows ``process_row_ranges`` gives
    this rank on each side, train, and write this rank's report (rank 0
    also the factors) into ``out_dir``."""
    from incubator_predictionio_torch.parallel.distributed import (
        initialize_distributed, process_index, rank_device,
    )

    initialize_distributed()
    torch.cuda.set_device(rank_device("cuda"))
    rank = process_index()
    t0 = time.perf_counter()
    u, i, r = synth_ratings(*ML20M)
    lo_u, hi_u = als.process_row_ranges(ML20M[0])
    lo_i, hi_i = als.process_row_ranges(ML20M[1])
    su = (u >= lo_u) & (u < hi_u)
    si = (i >= lo_i) & (i < hi_i)
    user_slice = (u[su], i[su], r[su])
    item_slice = (u[si], i[si], r[si])
    del u, i, r
    read_s = time.perf_counter() - t0
    reset_launches()
    timings: dict = {}
    t0 = time.perf_counter()
    f = als.train_als_process_sharded(user_slice, item_slice, ML20M[0],
                                      ML20M[1], SHARDED_PARAMS,
                                      device="cuda", timings=timings)
    timings.update(read_seconds=read_s,
                   train_seconds=time.perf_counter() - t0,
                   kernel_launches=launches())
    if rank == 0:
        np.savez(os.path.join(out_dir, "factors.npz"), user=f.user_factors,
                 item=f.item_factors)
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w",
              encoding="utf-8") as fh:
        json.dump(timings, fh)
    return 0


def phase_als_process_sharded(ratings) -> None:
    """``train_als_process_sharded`` at the main path's full width: the
    ML-20M-shaped triple (seed 7) on a (2, 2) mesh of four ranks on the
    card, each rank range-reading only its rows of each side (the m ranks
    of a data row share it), the global plan from all-gathered counts,
    each rank's shard solved with the warp kernel after the model group's
    sum of its partial grams. Factors within TOL of the in-process
    train_als of the same triple and params; warp launches = the plan's.
    The reference train runs while the ranks start."""
    u, i, r = ratings
    world = ALX_MESH[0] * ALX_MESH[1]
    out_dir = tempfile.mkdtemp()
    env = _console_env() | {
        "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
        "PIO_NUM_PROCESSES": str(world),
        "PIO_MESH_SHAPE": "x".join(map(str, ALX_MESH))}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), SHARDED_RANK_FLAG,
         out_dir], env=env | {"PIO_PROCESS_ID": str(rank)}, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    try:
        t1 = time.perf_counter()
        ref = train_als(u, i, r, ML20M[0], ML20M[1], SHARDED_PARAMS,
                        device="cuda")
        ref_s = time.perf_counter() - t1
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          "process-sharded ranks exited "
          f"{[p.returncode for p in procs]}: {[e[-1500:] for e in errs]}")
    reports = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank_{rank}.json"),
                  encoding="utf-8") as fh:
            reports.append(json.load(fh))
    got = np.load(os.path.join(out_dir, "factors.npz"))
    err = max(max_err(got["user"], ref.user_factors),
              max_err(got["item"], ref.item_factors))
    check(within(got["user"], ref.user_factors)
          and within(got["item"], ref.item_factors),
          f"process-sharded vs train_als max |err| {err}")
    shutil.rmtree(out_dir)
    launches_got = {k: sum(w["kernel_launches"][k] for w in reports)
                    for k in ("warp", "wide")}
    per_rank = _slab_calls(u, i, ML20M[0], ML20M[1], SHARDED_PARAMS,
                           ALX_MESH)
    expected = world * ITERS * per_rank
    check(launches_got == {"warp": expected, "wide": 0},
          f"als_process_sharded: launches {launches_got} != implied "
          f"{expected} warp")
    record("als_process_sharded", launches_got)
    keys = ("rank", "coords", "local_ratings", "read_seconds",
            "layout_seconds", "upload_seconds", "device_train_seconds",
            "train_seconds", "counts_allgather_bytes",
            "gram_seconds_per_half_step", "solve_seconds_per_half_step",
            "allreduce_bytes_per_half_step",
            "allreduce_seconds_per_half_step",
            "allgather_bytes_per_half_step",
            "allgather_seconds_per_half_step", "factor_bytes_resident",
            "solve_calls_per_iteration")
    emit("als_process_sharded", mesh=list(ALX_MESH), ratings=int(len(r)),
         seconds_end_to_end=wall_s, train_als_seconds=ref_s,
         kernel_launches=launches_got, expected_launches=expected,
         max_abs_err_vs_train_als=err,
         workers=[{k: w.get(k) for k in keys} for w in reports])


# -- the operator tools: the operator_tools phase ------------------------------

#: the soak of operator_tools: the reference's default traffic (3 apps, 400
#: users, ingest 50/s, queries 20/s) for 30 s on 2 event workers and 2
#: replicas, with the menu's faults that need no poison controls
SOAK_ARGS = ["--device", "cuda", "--duration-s", "30", "--event-workers",
             "2", "--replicas", "2", "--seed", "20260804", "--faults",
             "enospc_shed,worker_kill,replica_kill,good_retrain,"
             "compact_crash"]
#: pypio.train under ``pio shell -c``: the instance, its seconds and this
#: process's solve-kernel launches as one JSON line
SHELL_TRAIN = (
    "import json, time, torch\n"
    "from incubator_predictionio_torch.ops import spd_solve\n"
    "t0 = time.perf_counter()\n"
    "iid = pypio.train('.')\n"
    "torch.cuda.synchronize()\n"
    "print(json.dumps({'engineInstanceId': iid, "
    "'seconds': time.perf_counter() - t0, 'kernel_launches': {"
    "'warp': spd_solve.gauss_jordan_warp_launches.count, "
    "'wide': spd_solve.gauss_jordan_wide_launches.count}}))\n")


def _admin_sequence(srv: _Served) -> dict:
    """tests/test_eval_and_ops_servers.py's admin sequence against a
    running ``pio adminserver``: new, 409 on a duplicate, list, data
    delete, delete, then 404; the client ms of each call."""
    ms = []

    def call(method, path, body=None):
        status, doc, t = srv.request(method, path, body)
        ms.append(t)
        return status, doc

    st, doc = call("POST", "/cmd/app", {"name": "opsapp"})
    check(st == 201 and doc["name"] == "opsapp" and doc["accessKey"],
          f"admin new: {st} {doc}")
    key = doc["accessKey"]
    st, _ = call("POST", "/cmd/app", {"name": "opsapp"})
    check(st == 409, f"admin duplicate: {st}")
    st, listing = call("GET", "/cmd/app")
    check(st == 200 and [a["name"] for a in listing] == ["opsapp"]
          and listing[0]["accessKeys"] == [key], f"admin list: {listing}")
    st, doc = call("DELETE", "/cmd/app/opsapp/data")
    check(st == 200 and "deleted" in doc["message"], f"admin data: {doc}")
    st, _ = call("DELETE", "/cmd/app/opsapp")
    check(st == 200, f"admin delete: {st}")
    st, _ = call("DELETE", "/cmd/app/opsapp")
    check(st == 404, f"admin delete again: {st}")
    st, listing = call("GET", "/cmd/app")
    check(st == 200 and listing == [], f"admin list after: {listing}")
    return {"calls": len(ms), **_percentiles(ms)}


#: the console with pyarrow made unimportable (``import pyarrow`` raises
#: ImportError), whether or not the host has it
_NO_PYARROW = [sys.executable, "-c",
               "import sys\n"
               "sys.modules['pyarrow'] = sys.modules['pyarrow.parquet'] = None\n"
               "from incubator_predictionio_torch.tools import console\n"
               "sys.exit(console.main(sys.argv[1:]))"]


def _parquet_export(env: dict, cwd: str) -> dict:
    """``pio export --format parquet`` of the twin's app without pyarrow:
    a non-zero exit naming pyarrow and no file. Where the host has
    pyarrow, the same export then writes every event."""
    import importlib.util

    out_file = os.path.join(cwd, "netapp.parquet")
    args = ["export", "--app-name", "netapp", "--output", out_file,
            "--format", "parquet"]
    t0 = time.perf_counter()
    out = subprocess.run(_NO_PYARROW + args, capture_output=True, text=True,
                         env=env, cwd=cwd, timeout=300)
    seconds = time.perf_counter() - t0
    check(out.returncode != 0 and "pyarrow" in out.stderr
          and not os.path.exists(out_file),
          f"parquet export without pyarrow: rc {out.returncode}, "
          f"file {os.path.exists(out_file)}, {out.stderr[-500:]}")
    got = {"without_pyarrow": {
        "returncode": out.returncode, "seconds": seconds,
        "message": out.stderr.strip().splitlines()[-1:],
        "file_written": os.path.exists(out_file)}}
    got["pyarrow_on_host"] = importlib.util.find_spec("pyarrow") is not None
    if got["pyarrow_on_host"]:
        t0 = time.perf_counter()
        out = subprocess.run(CONSOLE + args, capture_output=True, text=True,
                             env=env, cwd=cwd, timeout=300)
        check(out.returncode == 0 and f"Exported {NET_IMPORT} events"
              in out.stdout, f"parquet export: {out.stderr[-1000:]}")
        got["with_pyarrow"] = {"seconds": time.perf_counter() - t0,
                               "bytes": os.path.getsize(out_file)}
    return got


def phase_operator_tools(workdir: str, net: dict) -> None:
    """The operator tools on the card, over network_storage's SQLite twin
    (its 20,000 ML-1M events; rank 32, λ and iterations the twin's):

    (a) ``pio template get recommendation`` (the port's bundle), its
        engine.json pointed at the twin's app, then ``pio train
        --profile-dir``: the Chrome trace names the warp kernel as often
        as the launch counter counted and the layout implies, and the
        factors are bit-equal to the twin's unprofiled train;
    (b) ``pio shell -c`` running ``pypio.train`` of the same directory:
        launches = implied, factors bit-equal to (a)'s;
    (c) ``pio adminserver``: the reference test's sequence;
    (d) ``pio export --format parquet`` with pyarrow made unimportable: a
        non-zero exit naming it and no file (and, where the host has
        pyarrow, the export of every event);
    (e) ``pio soak`` of (a)'s template on the card (:data:`SOAK_ARGS`):
        verdict PASS, every fault fired with evidence, every acknowledged
        event reconciled once; its trains launched the warp kernel.

    Every verb runs in a process of its own (nothing launches a kernel in
    this one, and nothing swaps its Storage singleton), so the phase runs
    in a thread beside others (:class:`_Beside`)."""
    from incubator_predictionio_torch.tools.commands.management import (
        template_cmd,
    )

    t_phase = time.perf_counter()
    cwd = tempfile.mkdtemp(dir=workdir)
    want = net["want"]
    env = _pio_env(os.path.join(cwd, "pio")) | {
        f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
        for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": net["twin_path"]}
    for k in ("PIO_SSL_CERTFILE", "PIO_SSL_KEYFILE", "PIO_FAULT_SPEC"):
        env.pop(k, None)

    # (a) the template, then the profiled train
    tpl = os.path.join(cwd, "recommendation")
    buf = io.StringIO()
    with STDOUT_LOCK, contextlib.redirect_stdout(buf):
        rc = template_cmd(["get", "recommendation", tpl])
    check(rc == 0, f"template get: {buf.getvalue()[-500:]}")
    path = os.path.join(tpl, "engine.json")
    with open(path, encoding="utf-8") as fh:
        engine_json = json.load(fh)
    check(engine_json["engineFactory"].startswith(
        "incubator_predictionio_torch."), f"the bundle's factory: {engine_json}")
    engine_json["datasource"]["params"]["appName"] = "netapp"
    engine_json["algorithms"][0]["params"].update(
        rank=PIO_RANK, numIterations=PIO_ITERS, **{"lambda": PIO_LAMBDA})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(engine_json, fh)
    trace_dir = os.path.join(cwd, "trace")
    profiled = _train_verb(env, tpl, "operator_tools_profiled_train",
                           extra=["--profile-dir", trace_dir])
    template_to_trained_s = time.perf_counter() - t_phase
    _hold_train(profiled, want, "operator_tools_profiled_train")
    from incubator_predictionio_torch.workflow.core_workflow import (
        trace_kernels, trace_path,
    )

    trace = trace_path(trace_dir, profiled["engineInstanceId"])
    check(os.path.isfile(trace), f"no trace at {trace}: "
          f"{os.listdir(trace_dir) if os.path.isdir(trace_dir) else None}")
    kernels = trace_kernels(trace)
    traced_warp = sum(n for name, n in kernels.items() if WARP_SYMBOL in name)
    check(traced_warp == profiled["kernel_launches"]["warp"]
          == profiled["expected_launches"],
          f"the trace names the warp kernel {traced_warp} times; counter "
          f"{profiled['kernel_launches']}, implied "
          f"{profiled['expected_launches']}")
    store = Storage({k: v for k, v in env.items()
                     if k.startswith("PIO_STORAGE_")})
    got = _hold_model(store, profiled, want, "operator_tools_profiled_train")
    keys = ("user_factors", "item_factors", "users", "items")
    check(all(np.array_equal(got[k], net["twin"][k]) for k in keys),
          "the profiled train differs from the twin's unprofiled train")

    # (b) pypio.train under pio shell -c
    out, shell_wall = _verb(["shell", "-c", SHELL_TRAIN], env, tpl,
                            timeout=900)
    shell = json.loads(out.stdout.strip().splitlines()[-1])
    record("operator_tools_shell_train", shell["kernel_launches"])
    check(shell["kernel_launches"] == {
        "warp": profiled["expected_launches"], "wide": 0},
        f"shell train launches {shell['kernel_launches']} != implied "
        f"{profiled['expected_launches']}")
    via_shell = _hold_model(store, shell, want, "operator_tools_shell_train")
    store.close()
    check(all(np.array_equal(via_shell[k], got[k]) for k in keys),
          "pypio.train under pio shell -c differs from pio train's")

    # (c) the admin server on a store of its own, (d) Parquet
    with _Served(["adminserver", "--ip", "127.0.0.1"],
                 _pio_env(os.path.join(cwd, "admin")), cwd) as admin:
        admin_ms = _admin_sequence(admin)
    parquet = _parquet_export(env, cwd)

    # (e) the soak, on (a)'s template
    card, soak_s = _soak(tpl, cwd, SOAK_ARGS, "operator_tools soak")
    check(all(f["fired"] and f.get("evidence") for f in card["faults"]),
          f"soak faults: {card['faults']}")
    check(card["reconciliation"]["ackedEvents"] == card["traffic"]["acked"],
          f"soak ledger: {card['reconciliation']} vs {card['traffic']}")
    soak_launches = {k: sum(t["kernelLaunches"][k] for t in card["trains"])
                     for k in ("warp", "wide")}
    check(soak_launches["warp"] > 0 and soak_launches["wide"] == 0
          and len(card["trains"]) == 2,
          f"the soak's trains: {card['trains']}")
    record("operator_tools_soak", soak_launches)
    fresh = next(s for s in card["slos"] if s["name"] == "foldin-freshness")
    emit("operator_tools",
         template_to_trained_seconds=template_to_trained_s,
         profiled_train={"seconds": profiled["seconds"],
                         "wall_seconds": profiled["wall_seconds"],
                         "kernel_launches": profiled["kernel_launches"],
                         "trace_warp_kernels": traced_warp,
                         "trace_kernel_names": len(kernels),
                         "trace_bytes": os.path.getsize(trace)},
         expected_launches=profiled["expected_launches"],
         shell_train={"seconds": shell["seconds"],
                      "wall_seconds": shell_wall,
                      "kernel_launches": shell["kernel_launches"]},
         twin_train_seconds_in_process=net["twin_seconds"],
         profiler_overhead=profiled["seconds"] / shell["seconds"],
         bit_equal_to_twin=True, shell_bit_equal=True,
         admin_ms=admin_ms, parquet=parquet,
         soak={"seconds": soak_s, "verdict": card["verdict"],
               "wallS": card["wallS"], "traffic": card["traffic"],
               "faults_fired": [f["name"] for f in card["faults"]
                                if f["fired"]],
               "slos": {s["name"]: s["value"] for s in card["slos"]},
               "foldin": fresh["detail"],
               "recovery": card["recovery"], "trains": card["trains"],
               "reconciliation": {k: card["reconciliation"][k] for k in (
                   "ackedEvents", "storeMarkers", "ambiguousSends",
                   "ambiguousLanded", "walReplay")},
               "kernel_launches": soak_launches},
         phase_seconds=time.perf_counter() - t_phase)
    shutil.rmtree(cwd, ignore_errors=True)


# -- the reference's headline and multi-tenant soaks: soak_full_menu, ------------
# -- soak_tenants ----------------------------------------------------------------

#: the port's soak engine: numpy, with the poison controls every fault of
#: the menu needs (tests/torch_soak_engine.py)
SOAK_ENGINE = os.path.join(ROOT, "tests", "torch_soak_engine.py")
#: soak_full_menu: every fault of the menu, every other flag at the CLI's
#: default (60 s, 2 event workers, 2 replicas, 3 apps, ingest 50/s,
#: queries 20/s, fold-in 250 ms, watch 2,500 ms, quality sample 1.0)
SOAK_FULL_ARGS = ["--device", "cuda", "--faults", "full"]
#: soak_tenants: the reference's multi-tenant soak (tests/test_soak.py:
#: 790-795: seed 45, 16 s, 1 worker, no replica, 2 apps + 5 tenant apps,
#: 12/12 per second, ENOSPC and a poisoned fold-in, no quality sampling),
#: with the fold-in at the CLI's default 250 ms instead of the test's
#: 1,200 ms; refresh poll and settle are the CLI's (500 ms, 20 s)
SOAK_TENANT_ARGS = ["--device", "cuda", "--seed", "45", "--duration-s", "16",
                    "--event-workers", "1", "--replicas", "0", "--apps", "2",
                    "--tenant-apps", "5", "--ingest-rps", "12",
                    "--query-rps", "12", "--faults",
                    "enospc_shed,poison_foldin", "--quality-sample", "0",
                    "--foldin-ms", "250", "--watch-ms", "2500",
                    "--rollback-deadline-s", "25"]
POISON_FAULTS = ("poison_foldin", "poison_retrain", "poison_quality")


def _soak_template(cwd: str) -> str:
    """A template directory of the port's soak engine, as the port's soak
    tests build it: ``pio train`` / ``pio deploy --engine-dir`` load it like
    any user engine."""
    tpl = os.path.join(cwd, "template")
    os.makedirs(tpl)
    shutil.copy(SOAK_ENGINE, tpl)
    with open(os.path.join(tpl, "engine.json"), "w", encoding="utf-8") as fh:
        json.dump({"id": "default",
                   "engineFactory": "torch_soak_engine.engine_factory",
                   "datasource": {"params": {"appName": "soakapp"}},
                   "algorithms": [{"name": "", "params": {}}]}, fh)
    return tpl


def _soak(tpl: str, cwd: str, args: list, what: str) -> tuple:
    """``pio soak`` of ``tpl`` with ``args`` (``--device cuda`` among them:
    every train and deploy it spawns runs on the card) in a workspace under
    ``cwd``: (the scorecard, seconds). A run that exits non-zero or ends
    without PASS fails the phase, with its red SLO rows and the tail of
    every process's log."""
    check("--device" in args and args[args.index("--device") + 1] == "cuda",
          f"{what}: the soak must run on the card: {args}")
    t0 = time.perf_counter()
    path = os.path.join(cwd, "SOAK.json")
    wd = os.path.join(cwd, "soak")
    out = subprocess.run(
        CONSOLE + ["soak", "--engine-dir", tpl, "--out", path,
                   "--workdir", wd, *args],
        capture_output=True, text=True, env=_console_env(), cwd=cwd,
        timeout=900)
    seconds = time.perf_counter() - t0
    card = None
    if os.path.isfile(path):
        with open(path, encoding="utf-8") as fh:
            card = json.load(fh)
    if out.returncode != 0 or card is None or card["verdict"] != "PASS":
        logs = os.path.join(wd, "logs")
        tails = {}
        for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
            with open(os.path.join(logs, name), encoding="utf-8",
                      errors="replace") as fh:
                tails[name] = fh.read()[-1500:]
        red = ([(x["name"], x["value"], x.get("detail"))
                for x in card["slos"] if not x["ok"]] if card else None)
        check(False, f"{what}: rc {out.returncode}, verdict "
              f"{card and card['verdict']}, red SLO rows {red}; "
              f"{out.stdout[-1500:]} {out.stderr[-1500:]}; logs: {tails}")
    check(card["topology"]["device"] == "cuda",
          f"{what}: ran on {card['topology']['device']}")
    return card, seconds


def _soak_numbers(card: dict, seconds: float) -> dict:
    """A scorecard's numbers for the phase line."""
    slos = {x["name"]: x for x in card["slos"]}
    return {"verdict": card["verdict"], "seconds": seconds,
            "wallS": card["wallS"], "traffic": card["traffic"],
            "faults": [{k: f.get(k) for k in ("name", "fired", "evidence")}
                       for f in card["faults"]],
            "slos": {n: x["value"] for n, x in slos.items()},
            "rollbacks": [{"fault": r["fault"], "firedAtS": r["firedAtS"],
                           "afterS": (r["observed"] or {}).get("afterS")}
                          for r in slos["rollback-window"]["value"]],
            "recovery": card["recovery"], "trains": card["trains"],
            "reconciliation": {k: card["reconciliation"].get(k) for k in (
                "ackedEvents", "storeMarkers", "ambiguousSends",
                "ambiguousLanded", "walReplay")},
            "planNotes": card["planNotes"], "host": card["host"]}


def _hold_poison_rollbacks(card: dict, what: str) -> list:
    """A rollback-window row, observed, for every poisoned publish."""
    rows = next(x for x in card["slos"]
                if x["name"] == "rollback-window")
    poisons = [f for f in card["faults"] if f["name"] in POISON_FAULTS]
    check(rows["ok"] and len(rows["value"]) == len(poisons)
          and all(r["observed"] for r in rows["value"]),
          f"{what}: rollback-window {rows} for {poisons}")
    return rows["value"]


def phase_soak_full_menu(workdir: str) -> None:
    """The reference's headline soak on the card: ``pio soak --device cuda
    --faults full`` of the port's soak engine, every other flag at the
    CLI's default (:data:`SOAK_FULL_ARGS`): 2 fenced event workers, a
    2-replica engine fleet with staged canary, fold-in and the quality
    watch (K7's ranking_metrics on the card), all eight faults of the
    menu. Held to: PASS; all eight faults fired with evidence; every
    acknowledged event reconciled once; an observed rollback-window row
    for each of the three poisoned publishes. Every process is the soak's
    own (nothing launches a kernel in this one), so it runs beside other
    phases (:class:`_Beside`)."""
    from incubator_predictionio_torch.workflow.soak import FAULT_MENU

    t_phase = time.perf_counter()
    cwd = tempfile.mkdtemp(dir=workdir)
    card, seconds = _soak(_soak_template(cwd), cwd, SOAK_FULL_ARGS,
                          "soak_full_menu")
    names = [f["name"] for f in card["faults"]]
    check(sorted(names) == sorted(FAULT_MENU)
          and all(f["fired"] and f.get("evidence") for f in card["faults"]),
          f"soak_full_menu faults: {card['faults']}")
    slos = {x["name"]: x for x in card["slos"]}
    check(slos["acked-event-loss"]["ok"]
          and card["reconciliation"]["ackedEvents"]
          == card["traffic"]["acked"] > 0,
          f"soak_full_menu ledger: {slos['acked-event-loss']}, "
          f"{card['reconciliation']} vs {card['traffic']}")
    _hold_poison_rollbacks(card, "soak_full_menu")
    emit("soak_full_menu", args=SOAK_FULL_ARGS,
         **_soak_numbers(card, seconds),
         phase_seconds=time.perf_counter() - t_phase)
    shutil.rmtree(cwd, ignore_errors=True)


def phase_soak_tenants(workdir: str) -> None:
    """The reference's multi-tenant soak on the card with the fold-in at
    250 ms (:data:`SOAK_TENANT_ARGS`): one mux-armed engine process serves
    the primary app and 4 tenant apps through 2 resident slots. Held to:
    PASS; a per-tenant row for each of the 5 apps, each offered and
    answered; evictions ≥ 1; both faults fired with evidence and the
    poisoned increment rolled back within its window; every acknowledged
    event reconciled once. Runs beside other phases (:class:`_Beside`)."""
    t_phase = time.perf_counter()
    cwd = tempfile.mkdtemp(dir=workdir)
    card, seconds = _soak(_soak_template(cwd), cwd, SOAK_TENANT_ARGS,
                          "soak_tenants")
    check(all(f["fired"] and f.get("evidence") for f in card["faults"])
          and [f["name"] for f in card["faults"]]
          == ["enospc_shed", "poison_foldin"],
          f"soak_tenants faults: {card['faults']}")
    row = next(x for x in card["slos"] if x["name"] == "tenant-isolation")
    per = row["value"]["perTenant"]
    check(row["ok"] and len(per) == 5
          and all(r["offered"] >= 1 and r["accepted"] >= 1 for r in per)
          and (row["value"]["evictions"] or 0) >= 1
          and card["tenants"]["maxResident"] == 2,
          f"soak_tenants isolation: {row}")
    check(card["reconciliation"]["ackedEvents"] == card["traffic"]["acked"]
          > 0, f"soak_tenants ledger: {card['reconciliation']}")
    _hold_poison_rollbacks(card, "soak_tenants")
    emit("soak_tenants", args=SOAK_TENANT_ARGS,
         **_soak_numbers(card, seconds), tenant_isolation=row["value"],
         tenants={k: card["tenants"].get(k) for k in (
             "maxResident", "evictions", "coldLoads", "loads")},
         phase_seconds=time.perf_counter() - t_phase)
    shutil.rmtree(cwd, ignore_errors=True)


def main() -> int:
    phase_device()
    phase_build()
    kv = phase_kernel_vs_plain()
    phase_als_card_vs_cpu()
    phase_als_bf16_card_vs_cpu()
    with tempfile.TemporaryDirectory() as workdir:
        # the headline soak's late faults (a poisoned retrain, then the
        # quality poison) need their retrain published inside its 60 s: it
        # runs beside the in-process phases, whose host load is one thread,
        # and not beside the verbs' process starts
        with _Beside(phase_soak_full_menu, workdir):
            main_path = phase_main_path(workdir)
            phase_train_bf16(workdir, main_path)
            phase_train_checkpointed(workdir, main_path)
            phase_train_nan_guard(main_path)
            phase_fold_in_main(workdir, main_path)
            phase_serving_sharded_catalog(main_path)
            phase_serving_mesh(main_path)
        with _Beside(phase_soak_tenants, workdir):
            with _Beside(phase_lint):
                phase_console(workdir)
            phase_console_similar_product(workdir)
            phase_pio_workflow(workdir)
        phase_codec_vs_plain(main_path["ratings"])
        phase_pio_workflow_jsonl(workdir)
        phase_eventserver_partitioned(workdir)
        phase_eventserver_wal(workdir)
        net = phase_network_storage(workdir)
        with _Beside(phase_operator_tools, workdir, net):
            with _Beside(phase_als_process_sharded, main_path["ratings"]):
                phase_object_search_storage(workdir, net)
            del net
            phase_pio_workflow_jsonl_ml20m(workdir, main_path["ratings"])
        with _TailGroup():
            phase_engine_server_tenants(workdir)
            phase_universal_recommender()
            phase_universal_recommender_jsonl(workdir)
            phase_complementary_purchase(workdir)
            ratings = main_path.pop("ratings")
            main_path.clear()
            phase_train_rank128(ratings)
            del ratings
    t = kv["timings"]

    def entry(name, kind, replaces, serves, shape, extra_shapes):
        n, k = shape
        row = t[shape]
        by_path = {path: got[kind] for path, got in PATH_LAUNCHES.items()
                   if got[kind]}
        return {
            "name": name, "route": "cuda",
            "source": "incubator_predictionio_torch/ops/csrc/gauss_jordan.cu",
            "replaces": replaces, "serves": serves,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": kv["max_abs_err"][kind],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"n={n}, k={k}",
            "other_shapes": {f"n={sn}, k={sk}": t[(sn, sk)]
                             for sn, sk in extra_shapes},
            "card": CARD,
        }

    kernels = [
        entry("gauss_jordan_warp", "warp",
              "incubator_predictionio_tpu/ops/pallas_kernels.py:137",
              "k <= 32 (of _solve_lanes' k <= 96)",
              (ML20M[0], 32), [(512, 32)]),
        entry("gauss_jordan_wide", "wide",
              "incubator_predictionio_tpu/ops/pallas_kernels.py:173",
              "32 < k <= 128 (_solve_slabs_wide's 96 < k <= 128, and "
              "_solve_lanes' 32 < k <= 96, pallas_kernels.py:137)",
              (8192, 128), [(512, 64), (512, 96), (512, 128)]),
    ]
    for e in kernels:
        check(e["launches"] > 0, f"{e['name']} ran on no path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [SHARDED_RANK_FLAG]:
        sys.exit(als_process_sharded_rank(sys.argv[2]))
    if sys.argv[1:2] == [TAIL_FLAG]:
        sys.exit(tail_group(sys.argv[2], sys.argv[3]))
    sys.exit(main())
