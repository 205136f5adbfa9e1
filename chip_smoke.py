#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ingest, read, query, aggregation,
durability, cluster, coordinator and networked aggregation paths, its
service binaries as child processes, its drills and its multi-device
layer, on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--parent DIR]
                                  python3 chip_smoke.py --churn-witness N
(the second form builds the kernels and runs only phase 17 (b)'s churn
drill N times in one process under the lockdep witness, its reads
traced, printing each run's p99s, its churn ops by step, where the
slowest reads waited, the interpreter stalls and the locks that parked
longest; it prints no kernels line)

Phases (each synchronises the device and fails the run on any error):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile the four CUDA kernels from m3_tpu_torch/csrc; beside
              it, one `nvcc -Xptxas=-v` per source prints each kernel's
              registers, spills and shared memory
  3. kernels  hold each codec kernel bit for bit against its plain PyTorch
              version on the card, at the shapes the main path gives it,
              plus hostile codec rows and edge-length IDs; time both.
              The window kernel (K4) against its plain version for all six
              stats at the query path's two grids of bench_promql's
              corpus ([10,000, 119], W 10, stride 1 and [10,000, 358],
              W 31, stride 3) and a hostile shard-sized grid
              ([100,000, 438], W 30, stride 3): count, min, max and last
              bit-identical, sum and m2 within the reorder bound; times
              beside the nearest single PyTorch pooling call. Every kernel
              and library time is taken twice: `call_ms` (CUDA events
              around a Python loop of calls, host enqueue included) and
              `device_ms` (the same calls captured in one CUDA graph, its
              replay timed by CUDA events: device time alone)
  3b. parent  with --parent DIR only: DIR holds the parent commit's
              m3_tpu_torch/ (git archive); its decode and window wrappers
              and kernels, built as a second extension, are timed against
              this checkout's in turns (parent, change, change, parent) at
              the main path's shapes
  4. slice    route 100,000 series IDs to 4096 shards, group the block's
              rows by shard, ingest_step_raw (encode + 1m rollup) on the
              100,000 x 120 block, decode_plane the words back; the round
              trip must be exact, bytes/datapoint 1.429, the aggregates
              must agree with an independent plain computation, and every
              kernel must have launched during this phase
  5. small    the same slice on 512 hostile rows, on the card and with
              the plain versions on the CPU: identical results
  6. query    bench_promql's storage (10,000 counters x 360 points at
              10 s, seed 11), bench_promql_plan_agg's (10,000 over 200
              hosts, seed 17) and a mixed-sign gauge grid (10,000 series,
              normal x 10, 20% NaN, seed 13, the same grid) through
              Engine(storage) on the card and
              Engine(storage, device="cpu"), both on the default route,
              the compiled plan (one CUDA graph per plan shape on the
              card, the window kernel inside it; each query's route,
              fallback reason and window launches printed; every query
              whose plan lowers must report `compiled`): the rate family,
              *_over_time, a 5m10s window, a packed subquery, grouped
              aggregations, and deriv, predict_linear, holt_winters,
              changes, resets and quantile_over_time over the counters and
              the gauges (with sum/avg_over_time) at step 30 s must agree:
              same tags and order, same NaN cells; changes, resets and
              quantile_over_time equal; deriv within rtol 1e-3, atol 1e-4,
              predict_linear and holt_winters within rtol 2e-3, atol 1e-2;
              the other gauge queries within rtol 2e-5, atol
              max(1e-8, 1e-6 max|ref|) (the reference's own bounds,
              tests/test_plan_compile.py:170-185); the rest within rtol
              1e-5, atol 1e-8. The window kernel must have launched for
              each *_over_time query and for no other (quantile_over_time
              sorts instead). The same queries through execute_range_ref
              on the card (the interpreter): every compiled answer within
              the reference's plan bounds of it (tests/test_plan_compile.py
              _tol: the family bounds for deriv, predict_linear,
              holt_winters and a rate of a rate, else rtol 2e-5 with atol
              max(1e-8, 1e-6 max|ref|)). Then a host-clock breakdown of
              the interpreter's steps for one rate + sum_over_time pair,
              and
              the pair 3 times warm, 3 times cold (new grids of known
              content: a content-hash hit) and 3 times missing (new
              content each run) (cut from 5 each; medians, full GC pauses set apart,
              derived-input cache hits and misses, the host clock spent
              hashing, in host prep and in H2D); last, every cached
              executable a captured graph whose replay equals its eager
              body bit for bit, each one's build wall, graph pool and
              static input bytes, the `plan` tenant of the budget beside
              torch.cuda.memory_allocated(), and then the plan cache
              dropped (phase 7 (b) does the same at its end), so the
              next phase's tenants have the budget they had before
  7. storage  the storage node's write -> seal -> read path on the card.
              (a) bench_hot_set_read's build at the north star's series
              count: 100,000 series in Database(ShardSet(4)) (index and
              commit log off), two 2 h blocks of 120 points per series
              (seed 53), one write_batch per step (the hash kernel each
              time), a tick past the second block + buffer_past seals 8
              blocks (the pack kernel each time; the seal's word tensors
              stay on the card in the block cache); the seal's words equal
              the plain pack of the same chunks, and the decode kernel
              equals its plain version at the storage path's shapes; the
              2,000-read mix (90% from a 5% hot set) once cold and 3 times
              warm (reads/s, p99, cache stats); 50 cached reads equal the
              same reads with the cache bypassed; read_all of every block
              equals the written planes bit for bit; the budget's total
              beside torch.cuda.memory_allocated().
              (b) the query phase's three corpora written through
              write_batch with tags into Database(ShardSet(16)) with the
              namespace index, sealed, and ten of phase 6's queries (one
              of each kind of plan, STORED_QUERIES; cut from all 32)
              through Engine(LocalStorage(db)) on the card (the default
              route):
              equal to phase 6's Engine(DictStorage) answers under phase
              6's bounds, the window kernel launched for each window
              query, and within the plan bounds of execute_range_ref over
              the same store; then the rate + sum_over_time breakdown and
              pair runs over LocalStorage
  8. flush    the storage node's flush merge and the compute-fault guard.
              (a) bench_flush_merge at its full size (BASELINE config #5):
              make_example_raw(100,000, 120, seed 17) split into two
              half-blocks of 60 points, both sealed (the pack kernel),
              merged by merge_adjacent (the scan-free concat on the
              eligible rows, decode + re-encode on the rest: the decode
              and pack kernels), the merged words decoded back (the decode
              kernel); every series must decode to the raw points, int-mode
              concat rows must equal a direct encode of the full window,
              and 2,000 concat rows and 2,000 recode rows must equal the
              same strategy on the CPU word for word; the merge's time
              (CUDA events) split into concat, recode and the host
              partition. (b) each shard's two sealed blocks of phase 7 (a)
              merged by merge_sealed_blocks to window 256; every merged
              block's read_all equals the two source blocks' reads side by
              side, bit for bit. (c) the guard on the card: a seeded
              campaign of all five fault kinds over codec.encode,
              codec.decode, codec.hash, block.decode and temporal.over_time
              (every call the exact clean answer or a typed ComputeError),
              a breaker trip (dispatches then raise at once) and its
              half-open recovery, and one real CUDA out-of-memory error
              inside a guarded primary, reclaimed by reclaim_pass and
              retried to the exact answer
  9. graphite (a) 10,000 carbon series (bench.host{0..199}.metric{0..49},
              360 points at 10 s, seed 29, positive levels) written with
              their __gN__ tags through Database(ShardSet(16)) with the
              namespace index (the hash kernel once a write_batch) and
              sealed (the pack kernel once a block); moving{Average,Sum,
              Max,Min,Median}, stdev, sumSeries, groupByNode, perSecond,
              summarize and highestCurrent rendered through
              GraphiteEngine(LocalStorage(db)) on the card (cold reads
              through the decode kernel, moving* and stdev through the
              window kernel) equal the device="cpu" renders over the same
              store: same names and order, same NaN cells, rtol 1e-5,
              atol 1e-8. (b) the opt-in query placement (QueryPlacement,
              the reference's "auto"): the probe's
              RTT and D2H bandwidth, choose() at four grid sizes, and the
              decisions over 20 repeat rate evaluations at bench_promql's
              shape through execute_range_ref (the compiled route ignores
              placement), each answer equal to that of the side that
              served it
  10. plan    the compiled plan at bench_promql_plan_agg's shape
              (bench.py:370-455), from an empty plan cache:
              `sum by (host) (rate(bench_requests[5m]))`
              over 10,000 counters on 200 hosts (360 points at 10 s, seed
              17) from t[30] to t[-1] at step 30 s: one miss (warm-up +
              capture), the median of 5 warm replays (ms and datapoints/s),
              the interpreter's median of 5 on the same engine, a cProfile
              split of one replayed query; 200 series within rtol 1e-5,
              atol 1e-8 of execute_range_ref (the bench's own assertion)
              and of the CPU plan route
  11. aggregator  the aggregator tier and the standing rules engine on the
              card, each number printed beside the card's name and power
              limit. (a) bench_counter_gauge (BASELINE config #2): 50,000
              metrics (half counters, half gauges, seed 23) at 1m:40h and
              5m:40h, 5 minutes of 10 s values, MetricList.flush with a
              columnar handler: windows/s and datapoints/s, median of 3
              rounds. (b) bench_agg_rollup_10x: _agg10x_build's 500,000
              metrics (40/40/20, 10% piped gauges into 500 rollup ids, seed
              31), two 1m windows of 6 values and the second-stage flush:
              the round (median of 3), a cProfile split, the quantile
              tile's shape and bytes, the rank selection's device time
              and its H2D and D2H; the 20,000-metric mirror's emissions on
              the card equal the CPU's and reduce_and_emit_ref's bit for
              bit (bench.py:732-783); the rank selection equals its plain
              version at widths 128, 256 and 1024 on hostile rows; a fault
              injected on the agg_flush route raises typed, counted once.
              (c) Aggregator: 64 shards, one million samples through
              add_untimed_batch, one flush with an election: every window
              emitted, the flush times of all shards in one kv
              transaction, counter sums and timer quantiles equal to numpy.
              (d) RulesEngine over phase 10's corpus, 4 rounds at step 30 s
              on the default compiled route: two recording rules (a grouped
              rate sum; max_over_time, the window kernel inside its plan
              graph), 16 `>` alert rules on avg_over_time (the compare on
              the card) and a for_steps=3 rule; the recorded rows written
              into a Database(ShardSet(16)) (the hash kernel) and read back
              through LocalStorage; rows and transitions equal the same
              rounds on Engine(device="cpu") (the compiled route's bounds;
              transitions as sets). The window and hash kernels must launch.
  12. durability  the storage node's durable path on the card, in a
              temporary directory the phase removes; each step's seconds
              and launches printed beside the card's name and power limit.
              (a) BASELINE config #12 (bench.py:1440-1571) at its size:
              100,000 series in 8 shards, index off, commit log on, seed
              83: write, tick (the pack kernel), flush (the blooms through
              the hash kernel), 4 WAL waves, Mediator.snapshot, abandoned
              without close(); fresh card databases bootstrapped with the
              filesystem and commit-log chain (a warm pass, 2 timed, one
              traced: series/s, the filesystem / snapshot install / WAL
              replay split, device busy); every series' read over both
              blocks equals its acknowledged points bit for bit (5,000 of
              them also the pre-kill db's reads), the batched
              replay equals replay_ref (500,000 entries), and a
              device="cpu" bootstrap gives the same registries and sealed
              words. (b) config #8's shape as phase 7 (a) writes it (its
              series cut to 25,000 for the script's time), with
              the index and the commit log (WRITE_BEHIND) on: tick, flush
              (8 filesets + index segments; ms per fileset), evict, the
              2,000-read mix through the BlockRetriever twice (reads/s,
              p99; each read equal to its pre-eviction read; the second
              pass hits the WiredList with fewer decode launches), a
              restart (the index from its segments) and four queries over
              LocalStorage on the default route equal to the pre-restart
              answers under the query bound. (c) one byte flipped in one
              of (b)'s data.bin files: every serve path raises typed or
              serves the right data, the quarantine-only scrubber
              quarantines exactly that fileset, and a restart leaves its
              range to the commit log, whose replay restores it (sealed
              by a tick, flushed again clean) bit for bit
  13. cluster  the client and the replicated cluster on the card, in a
              temporary directory the phase removes; each step's seconds
              and launches printed beside the card's name and power limit.
              (a) BASELINE config #9 (bench.py:1310-1437) at its size:
              100,000 series x 4 points in 8 shards (index and commit log
              off, seed 61) written (K3) and ticked (K1) on a donor served
              by a NodeServer; fresh joiners on the card run the peers
              bootstrap through a Session (a warm pass, 2 timed, one
              traced: series/s, the metadata / plan / tile fetch / apply
              split); every migrated block equals the donor's, the batched
              apply equals apply_peer_tiles_ref on shard 0's tiles, and a
              mixed-unit tile (half of shard 0's rows re-sealed at
              millisecond ticks) goes through _apply_mixed_unit_rows (K2,
              then K1) and reads back equal to the donor's. (b) a 3-node,
              replication-factor-3 ClusterHarness of 16 shards on the card
              behind fault proxies, a Session at MAJORITY writes and reads:
              bench_promql's counters (10,000 series, seed 11) cut to 12
              points at 10 s, written with tags through Session.write_batch
              (writes/s), ticked (K1), 2 more points into the buffers; a
              fetch_tagged of every series (the sealed tiles through K2,
              plus the buffer sidecar) equals each node's Database.read;
              three rate / *_over_time / sum queries over
              SessionStorage(session) equal the same queries over node0's
              LocalStorage (K4 inside the plan graphs); one of them again
              from an empty plan cache (a CUDA-graph capture) while a
              second thread writes through the session; node2 taken away
              through its FaultProxy: MAJORITY writes acknowledge,
              MAJORITY reads equal node0's reads, a read at ALL raises
              ConsistencyError. (c) one value overwritten on node0's sealed
              block (K1): a ShardRepairer heals it (the peers' tiles
              through K2, the rebuilt block through K1): the three nodes'
              rows of that block equal, the series reads back bit for bit.
              Before the cluster stops, phase 14 (g): a run_clustered
              coordinator on its Session answers two of the queries over
              HTTP equal to (b)'s answers over SessionStorage
  14. coordinator  the embedded coordinator on the card, over HTTP on
              127.0.0.1: run_embedded over Database(ShardSet(16)) with the
              index (M3's single-node deployment with the embedded
              coordinator), every number beside the card's name and power
              limit. (a) bench_query_serve_e2e's corpus at its size
              (10,000 counters x 240 points at 10 s, 200 hosts, seed 61;
              2.4 M samples) as snappy protobuf remote writes of 500 series
              x 24 points (one DownsamplerAndWriter.write_request and one
              K3 routing a request), samples/s and the decode's share; the
              seal (K1); 200 series read back bit for bit. (e) between
              the writes and the seal, Coordinator.rules_engine(): two
              recording rules and an alert rule for 5 steps (2 rounds),
              the rows it wrote back equal to a device="cpu" run under the
              rules bounds, transitions equal as sets, the recorded rate
              sum read over HTTP after the seal. (b) the bench's serve mix
              (rate and max_over_time matrices, sum by host, an instant
              vector): each shape once on this thread (the cold reads
              and the plan captures), within the compiled-route bounds of
              a device="cpu" engine over the same corpus, its
              render_result_ref bytes what every HTTP response must
              equal; over HTTP 3 rounds of replays (p50, p99, wire
              bytes), a traced round (the card's busy share), 4 threads
              sending the instant vector at once; K2, K4 launches and
              graph replays. (c) 10,000 carbon paths x 15 points through
              the carbon listener; 4 Graphite renders over HTTP equal to
              GraphiteEngine on the card and the CPU (rtol 1e-5, atol
              1e-8), 2 finds. (d) bench_downsample_rules' rule set (801
              mapping and 200 rollup rules with a DROP_MUST class) over
              50,000 of its metrics (cut from 100,000), published through the KV
              RuleSetStore, a cold and a warm pass through
              DownsamplerAndWriter.write_batch (metrics/s), the flush into
              agg_1m and agg_5m (agg_flush, K3); the write_ref oracle on
              4,000 metrics equal bit for bit; a rollup series over HTTP.
              (f) an injected ComputeError on
              the plan route answers 503, 200 after guard.reset()
  15. pipeline  config #2 (the upstream docker/m3aggregator deployment)
              over the network, every part on 127.0.0.1 in this process,
              every number beside the card's name and power limit. (a) the
              metadata plane: a KVServer; the coordinator's
              Database(ShardSet(16)) on the card with the index watches the
              namespace registry through a RemoteStore; agg_1m (1m:40h) and
              agg_5m (5m:40h) added through the registry are served on the
              card; a runtime option folds from KV; an HTTPJSONServer over
              the db's NodeService: one write_batch of 10,000 samples (K3),
              every series fetched back bit for bit, /debug/vars with the
              guard's snapshot, 429 from a held gate. (b) two Aggregators on
              the card, each behind a RawTCPServer and an admin sidecar, 64
              shards split by a placement in KV (RF 1), elections and flush
              times over RemoteStores, each flushing through a
              ProducerHandler over a Producer of the KV topic
              aggregated_metrics to a Consumer(M3MsgIngester) that writes 1m
              rows to agg_1m and 5m rows to agg_5m; a collector Reporter over
              a Matcher on KV rules and an AggregatorClient of TCPTransports
              sends bench_counter_gauge's traffic (its 50,000 tagged metrics
              cut to 8,000 for the script's time: half Poisson(5) counters,
              half N(0,1) gauges, seed 23, 30 points at 10 s on the
              settable clock) and 5,000 batch
              timers of 30 values (p50/p95/p99: the agg_flush route); the
              windows close, both aggregators flush, the producers drain;
              every stored row equals a device="cpu" Aggregator's fed the
              same samples in process, bit for bit; samples/s, rows/s, the
              last sample to the last row readable, the card's busy share of
              the traced (b); then the seal (K1), 1,000 sampled series read
              back from the sealed blocks (K2), and
              sum_over_time(bench_cg_counter[5m]) over agg_1m on the
              compiled route (K4 in its graph) within "compiled query
              answers" of a device="cpu" engine. (c) a leader/follower pair
              on one shard set at 1,000 metrics: the leader flushes a
              window, /resign, the follower flushes the next: the stored
              rows have no gap and no duplicate window
  16. services the port's CLIs as child processes on the card, started
              through em.Operator (python -m m3_tpu_torch.services ...,
              JSON configs, the node's two ports picked free up front
              (its restart keeps them), every other listener on port 0;
              each child's spawn to its
              listen line printed), their data under a temporary
              directory the phase removes; the children load the build of
              phase 2 and must not rebuild it. (a) a dbnode child with an
              embedded coordinator (4 shards; one namespace of 1m blocks,
              buffer_past 10 s; write_wait commit log; bootstrap on; a
              mediator tick every 2 s): on the card (its PID among
              nvidia-smi's compute apps where the PID namespace shows it,
              else one CUDA context fewer when it stops, in (b));
              bench_query_serve_e2e's 10,000 counters x 30 points
              (0.5 s apart on the wall clock) as snappy protobuf remote
              writes; the same bodies to an in-process device="cpu"
              oracle (run_embedded); the mediator's seal and flush; a
              rate and a sum by (host) over max_over_time over HTTP
              within "compiled query answers" of the oracle's; the
              child's /debug/vars guard primaries on codec.hash,
              codec.encode, codec.decode and plan. (d) meanwhile a kv
              and an aggregator child (placement_key, flush_log): 1,000
              metrics x 30 points from run_collector's Reporter over a
              TCPTransport; the flush log equals a device="cpu"
              Aggregator fed the same samples. (b) SIGTERM, the node
              under Panicmon(restart_on_crash=True), SIGKILL, the
              restart's serving-ready line (kill to serving-ready
              printed), every acknowledged point read back bit for bit
              through a Session on the card and through query_range;
              (d) a standalone coordinator child finds the node through
              a placement the parent publishes to the kv child and
              answers a query as the embedded coordinator does. (c)
              after a SIGTERM, the tools as CLI children at once:
              verify_index_files exits 0 and read_data_files' rows equal
              the acknowledged points on each shard, verify_index_files
              exits 1 naming the fileset of a clone with a flipped byte
  17. harness  the drills of m3_tpu_torch/testing/scenario.py on the card,
              each held to its own verify(), their data under a temporary
              directory the phase removes. (a) the kill -9 drill (base
              variant, seed 7): a dbnode child (python -m
              m3_tpu_torch.services, no --device) under M3_TPU_LOCKDEP and
              M3_TPU_RACEWATCH, 150 writes/s open loop, SIGKILLed at its
              seeded moment, a torn WAL tail and a checkpoint-less
              fileset injected, restarted: every acked point served,
              nothing fabricated, the restart within 30 s; the fresh
              child's first-write latency, the spawn walls and
              bootstrap_s printed; the restarted child stopped with
              SIGTERM so that its witnesses dump, both held to the static
              model by m3_tpu_torch.analysis.witness: zero lockdep
              cycles, every witnessed edge in the static lock graph or
              the reconcile ledger (the edges through card-only locks
              printed), racy pairs only on lock-free-ledger attributes,
              the observed access profiles printed. (b)
              the churn drill at its defaults (4 nodes, RF=3, 16 shards,
              48 series, 60 requests/s for 4 s, add/repair/remove/
              replace under seeded network chaos): every SLO (no acked
              write lost, no critical probe shed, p99 2 s, bounded gate
              and queues, converged placement, replica-equal checksums),
              the GC's tracked objects and the live threads before it,
              its full GC pauses and each op's seconds printed. (c) the
              disk-fault drill (seed 7): bit rot quarantined,
              scrub and peer repair, a full disk's read-only posture and
              its recovery. (d) the compute-fault churn drill (seed 19):
              faults injected on the guarded seam, every guarded
              dispatch's outcome explained by its own decisions
  18. mesh     the multi-device layer on the card split four ways
              (device.attach([cuda:0] * 4), a (2, 2) shard x time mesh),
              each split held against the single-device call: (a) the
              sharded ingest step on the north star's shard as two
              60-point chunks (words and nbits per chunk bit-equal to
              ingest_step's, the whole-window stats against a plain
              reduction, every chunk decoded back); (b) a seal of 32,768
              series x 256 points through Shard.tick (mesh_encode once,
              words bit-equal to one device's with nothing attached,
              the block read back); (c) quantile_rank_rows on phase 11 (b)'s timer tile;
              (d) sum_rate and agg_rate's five ops on bench_promql's
              10,000 counters against the host reference; (e) five mesh_ok
              plans of the plan corpus, one CUDA graph over the four
              slices, against the interpreter and one device; (f)
              dryrun_multichip, query.sharded_agg firing over HTTP
  19. lint     m3lint over the checkout's m3_tpu_torch/ (python -m
              m3_tpu_torch.analysis m3_tpu_torch/ --jobs 0 --no-cache),
              host only: zero findings; the files analyzed and the wall
              time printed
  20. robustness  the port's robustness tier (m3_tpu_torch/scripts) on the
              card. Started before phase 18, as child processes (python -m
              m3_tpu_torch.scripts.<name>, no --device): the dbnode soak
              (a services dbnode child with its coordinator, 3 HTTP
              writers and the reference's query mix with
              avg_over_time(soak_metric[2m:30s]) for 30 s: 0 write or query
              errors, RSS growth under 256 MB, its device memory beside
              RSS), the aggregator soak (30 s of timed counters over raw
              TCP: flush progress, every closed window exact, RSS growth
              under 192 MB) and the integration smoke (kv, two dbnodes, a
              standalone coordinator, two aggregators and an HA pair as
              services children: scatter-gather writes and queries, a
              placement change through a KV watch, remote write, carbon,
              the leader's SIGKILL and the follower's flushes, each step's
              verdict printed). After phase 19, in this process through
              each module's main(): fuzz_codec at 8 rounds (every bucket
              twice: the pack kernel bit-equal to its plain version, the
              decode's round trip, the scalar oracle, the concat/recode
              merge), fuzz_index and fuzz_durability at 10 rounds,
              fuzz_cluster at 1 round of 6 ops (seed 7: add, replace and
              remove), every campaign at seed 7 with 0 invariant failures;
              then the three services waited for, each exiting 0

Every kernel's launches are counted per path (slice, query, storage,
flush, graphite, plan, aggregator, durability, cluster, coordinator,
pipeline, services, harness, mesh (its mesh calls alone), robustness (the
campaigns in this process and the launches phase 20's service children
printed);
phase 14 (g) counts in cluster), each count set to 0 just before its
path is driven and read just after. A compiled plan's
kernels are recorded once in its CUDA graph and launched by each replay:
the window kernel's count adds its warm-up launch and, per replay, the
launches its graph holds. A service or tools child counts its own
launches the same way, from 0 at its start, and prints them as it closes
("... kernel launches {...}"); the phase adds what each child printed,
read after its stop. The SIGKILLed node's launches die with it, in phase
16 and in phase 17's kill drill.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

N, W, FACTOR, SEED = 100_000, 120, 6, 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
REPLACES = {
    "pack": ("m3_tpu_torch/csrc/pack.cu", "m3_tpu/ops/pallas_codec.py:116"),
    "decode": ("m3_tpu_torch/csrc/decode.cu", "m3_tpu/ops/pallas_codec.py:187"),
    "hash": ("m3_tpu_torch/csrc/hash.cu", "m3_tpu/ops/pallas_codec.py:298"),
    "window": ("m3_tpu_torch/csrc/window.cu", "m3_tpu/ops/pallas_window.py:75"),
}
Q_SERIES, Q_HOSTS = 10_000, 200          # bench_promql(_plan_agg)'s sizes
# bench_hot_set_read's build at the north star's series count: 4 shards,
# two 2 h blocks of 120 points per series, a 2,000-read mix, seed 53.
STORE_SERIES, STORE_SHARDS, STORE_PPB, STORE_SEED = 100_000, 4, 120, 53
HOT_READS, HOT_FRAC, HOT_WEIGHT, WARM_PASSES = 2_000, 0.05, 0.9, 3
BLOCK_NS, MINUTE_NS = 2 * 3600 * 10**9, 60 * 10**9
SHARD_ROWS = 100_000                     # the hostile window grid's rows
STEP_NS = 30_000_000_000
QUERIES = tuple(
    [f"{f}(bench_metric[5m])" for f in ("rate", "increase", "irate", "delta")]
    + [f"{k}_over_time(bench_metric[5m])" for k in (
        "sum", "avg", "min", "max", "count", "last", "stddev", "stdvar",
        "present")]
    + ["sum_over_time(bench_metric[5m10s])",
       "max_over_time(rate(bench_metric[5m])[30m:1m])",
       "sum by (host) (rate(bench_requests[5m]))",
       "max by (host) (rate(bench_requests[5m]))",
       "topk(5, rate(bench_requests[5m]))"])
# The range functions of the query path's last slice, over the counters
# and over a mixed-sign gauge grid (10,000 series, normal x 10, 20% NaN,
# seed GAUGE_SEED, on the counters' 360-point grid) with the summed kinds.
SIX = ("deriv({x}[5m])", "predict_linear({x}[5m], 600)",
       "holt_winters({x}[5m], 0.3, 0.6)", "changes({x}[5m])",
       "resets({x}[5m])", "quantile_over_time(0.9, {x}[5m])")
QUERIES += tuple(q.format(x="bench_metric") for q in SIX)
GAUGE_QUERIES = tuple(q.format(x="bench_gauge") for q in SIX + (
    "sum_over_time({x}[5m])", "avg_over_time({x}[5m])"))
ALL_QUERIES = QUERIES + GAUGE_QUERIES
GAUGE_SEED = 13
# Card-against-CPU bounds. changes, resets and quantile_over_time compare
# and index the same f32 residuals: equal. The regression family and
# holt_winters: the reference's family bounds, and mixed-sign gauges its
# scale-aware bound for windows that cancel (tests/test_plan_compile.py:
# 170-185). Everything else: rtol 1e-5, atol 1e-8 (bench.py:441-446).
EXACT = ("changes(", "resets(", "quantile_over_time(")
FAMILY_TOL = {"deriv": dict(rtol=1e-3, atol=1e-4),
              "predict_linear": dict(rtol=2e-3, atol=1e-2),
              "holt_winters": dict(rtol=2e-3, atol=1e-2)}
# Runs of each way of the rate + sum_over_time pair (cut from 5 for the
# script's time, PERF.md §4).
PAIR_RUNS = 3
# Phase 7 (b)'s queries over LocalStorage: one of each kind of plan that
# phase 6 runs over DictStorage (cut from all of ALL_QUERIES for the
# script's time, PERF.md §4): a counter function, K4's plain and strided
# windows, a two-moment window, a subquery, two aggregations, the
# regression family, an exact compare, and the gauges' quantile.
STORED_QUERIES = ("rate(bench_metric[5m])",
                  "sum_over_time(bench_metric[5m])",
                  "stddev_over_time(bench_metric[5m])",
                  "sum_over_time(bench_metric[5m10s])",
                  "max_over_time(rate(bench_metric[5m])[30m:1m])",
                  "sum by (host) (rate(bench_requests[5m]))",
                  "topk(5, rate(bench_requests[5m]))",
                  "deriv(bench_gauge[5m])",
                  "changes(bench_metric[5m])",
                  "quantile_over_time(0.9, bench_gauge[5m])")
# Start offsets, in steps, of the miss pair runs: each run takes a new one.
_MISS_SHIFTS = itertools.count(1)
# The query path's input caches and the compiled plans' graphs, tenants of
# the same shared budget as the block cache (ops/temporal.py,
# parallel/compile.py): not the database's bytes.
QUERY_CACHE_TENANTS = ("upload", "derived", "derived_id", "plan")
# The compiled route against the interpreter: the reference's own bounds
# (tests/test_plan_compile.py _tol): the regression family, holt_winters
# and a rate of a rate loose; everything else rtol 2e-5 with atol
# max(1e-8, 1e-6 max|ref|). The plan computes on f32 planes.
PLAN_LOOSE = {"predict_linear": dict(rtol=2e-3, atol=1e-2),
              "holt_winters": dict(rtol=2e-3, atol=1e-2),
              "deriv": dict(rtol=1e-3, atol=1e-4),
              "rate(rate": dict(rtol=2e-3, atol=1e-5)}
# Phase 10: bench_promql_plan_agg's query (bench.py:370-455), its warm
# replays and the interpreter's runs on the same engine.
PLAN_AGG_QUERY = "sum by (host) (rate(bench_requests[5m]))"
PLAN_RUNS = 5
# The steps of a query pair that _instrumented times (cProfile).
QUERY_STEPS = {
    "fetch (dict)": ("testing/__init__.py", "fetch_raw"),
    "fetch (store)": ("query/storage.py", "fetch_raw"),
    "grid cache + consolidate": ("query/executor.py", "_consolidate_cached"),
    "derived inputs": ("ops/temporal.py", "_derived"),
    "tag strip": ("query/executor.py", "_strip_name"),
    "result fetch": ("query/executor.py", "observed_fetch"),
    "plan bind": ("query/plan.py", "bind"),
    "plan program (copy-in, replay, clone)": ("parallel/compile.py",
                                              "__call__"),
    "plan host finish": ("parallel/compile.py", "fetch"),
}
# The steps of one compiled query that phase 10 times (cProfile).
PLAN_STEPS = {
    "parse + lower": ("query/plan.py", "lower_and_collect"),
    "bind (fetch, grid, tag algebra)": ("query/plan.py", "bind"),
    "of which fetch + grid": ("query/executor.py", "_consolidate_cached"),
    "stage inputs (derived cache)": ("parallel/compile.py", "_stage_fetch"),
    "aux index arrays": ("parallel/compile.py", "_aux_arrays"),
    "guard dispatch": ("parallel/guard.py", "dispatch"),
    "of which copy-in, replay, clone": ("parallel/compile.py", "__call__"),
    "host finish (D2H wait, f64 finish)": ("parallel/compile.py", "fetch"),
}
EPS = 1.2e-7  # 2^-23
# Phase 11: bench_counter_gauge's and bench_agg_rollup_10x's sizes, the
# reference bench's 20,000-metric oracle mirror, the end-to-end
# Aggregator's ids and samples, timed rounds, and the rules' recordings.
AGG_CG_SERIES, AGG_10X_SERIES, AGG_MIRROR_SERIES = 50_000, 500_000, 20_000
AGG_E2E_IDS, AGG_E2E_SAMPLES, AGG_ROUNDS = 50_000, 1_000_000, 3
RULE_RECORDS = ("sum by (host) (rate(bench_requests[5m]))",
                "max_over_time(bench_requests[5m])")
# The steps of one agg10x round that phase 11 times (cProfile).
AGG_STEPS = {
    "collect (collect_into)": ("aggregator/list.py", "collect_into"),
    "host moments (_columnar_moments)": ("aggregator/list.py",
                                         "_columnar_moments"),
    "quantile tile build": ("parallel/agg_flush.py", "build_quantile_tile"),
    "quantile ordering (H2D, argsort, D2H) through the guard": (
        "parallel/guard.py", "dispatch"),
    "exact quantile values (tile, ordering, gather)": (
        "parallel/agg_flush.py", "exact_quantile_values"),
    "pipelines (rollup forwards)": ("aggregator/elem.py",
                                    "_process_pipeline"),
    "forward delivery (second-stage elems)": ("testing/__init__.py",
                                              "forward_fn"),
    "columnar handler": ("chip_smoke.py", "handle_columnar"),
    "emit_batch (all of the reduce and emit)": ("aggregator/list.py",
                                                "emit_batch"),
}
CARD_LINE = ""
# Phase 11 (b)'s quantile tile (tile, counts, qs), ordered again over the
# mesh in phase 18 (c).
AGG_TILE = None


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


START = time.perf_counter()


def phase(name: str) -> None:
    print(f"phase t+{time.perf_counter() - START:7.1f}s {name}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls from a Python loop,
    by CUDA events: the call time, host enqueue included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call: `iters` calls captured into one
    CUDA graph, its replay timed by CUDA events. No Python and no enqueue
    is in the time, only the kernels and the gaps between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int) -> dict:
    """A wrapper's call time (`ms` and `call_ms`, the earlier measure) and
    its device time (`device_ms`)."""
    call = cuda_ms(fn, iters)
    return dict(ms=call, call_ms=call, device_ms=device_ms(fn, iters))


def times_text(r: dict) -> str:
    return f"call {r['call_ms']!r} ms, device {r['device_ms']!r} ms"


def u32_err(a, b) -> int:
    """Largest |a - b| of two int32 bit-pattern tensors read as u32."""
    import torch

    if a.numel() == 0:
        return 0
    return int(((a.to(torch.int64) & 0xFFFFFFFF)
                - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())


def int_err(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(b.dtype) - b).abs().max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", metavar="DIR",
        help="a checkout (or archive) of the parent commit: also time its "
             "decode and window wrappers against this checkout's, in turns")
    parser.add_argument(
        "--churn-witness", metavar="N", type=int, default=0,
        help="only run phase 17 (b)'s churn drill N times in one process "
             "under the lockdep witness (no kernels line)")
    args = parser.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if args.churn_witness:
        # Installed at the package's import, before any lock is made.
        os.environ["M3_TPU_LOCKDEP"] = "1"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from m3_tpu_torch.ops import codec_kernels as ck
        from m3_tpu_torch.ops import tsz
        from m3_tpu_torch.parallel import ingest
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.testing import (gauge_corpus, hostile_block,
                                          hostile_residuals, prometheus_ids,
                                          promql_corpus)
        from m3_tpu_torch.utils.hashing import pad_ids
    except ImportError as err:
        print(f"chip_smoke: run from the root of a checkout ({err})",
              file=sys.stderr)
        return 2

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    global CARD_LINE
    CARD_LINE = card_line
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(card_line, flush=True)
    phase(f"device {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    if args.churn_witness:
        ck.build()
        return _churn_witness(args.churn_witness)

    # -- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    ptxas = _start_ptxas(here)
    try:
        ck.build()
    finally:
        ptxas_text = {src: p.communicate()[0] for src, p in ptxas.items()}
    phase(f"build: {sorted(ck.KERNELS) + ['window']} in "
          f"{time.perf_counter() - t:.1f}s")
    _print_ptxas(ptxas, ptxas_text)

    # -- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(SEED)
    ts_np, vals_np, npts_np = ingest.make_example_raw(N, W, rng)
    ids = prometheus_ids(N, np.random.default_rng(SEED))
    id_lens = np.fromiter(map(len, ids), np.int64, len(ids))
    mw = tsz.max_words_for(W)
    check(mw == 446, f"max_words_for({W}) = {mw}")
    raw = ingest.make_raw_batch(ts_np, vals_np, npts_np)
    prep, ok = tsz.prepare_on_device_math(
        raw.ts, raw.values.view(torch.int64), raw.npoints)
    check(bool(ok), "range_ok false on the example block")
    chunks = tsz.encode_chunks(**prep)
    h_ts, h_vals, h_npts = hostile_block(SEED, 4096, W)
    hostile = tsz.prepare_encode_inputs(h_ts, h_vals, h_npts)
    h_chunks = tsz.encode_chunks(**hostile)
    torch.cuda.synchronize()
    check(chunks[0].shape == (N, 2 * W), f"slot planes {tuple(chunks[0].shape)}")
    phase(f"inputs: block {N}x{W}, {len(ids)} IDs of {id_lens.min()}-"
          f"{id_lens.max()} bytes, 4096 hostile rows")

    results = {}

    # K1 pack
    words = ck.pack_chunks(*chunks, mw)
    words_plain = ck.pack_chunks_plain(*chunks, mw)
    h_words = ck.pack_chunks(*h_chunks, mw)
    torch.cuda.synchronize()
    err = max(u32_err(words, words_plain),
              u32_err(h_words, ck.pack_chunks_plain(*h_chunks, mw)))
    check(err == 0, f"pack kernel differs from its plain version: {err}")
    pack_bytes = 4 * chunks[0].numel() * 4 + words.numel() * 4
    results["pack"] = dict(
        max_abs_err=err, bytes=pack_bytes,
        **kernel_times(lambda: ck.pack_chunks(*chunks, mw), 20),
        plain_ms=cuda_ms(lambda: ck.pack_chunks_plain(*chunks, mw), 3))
    phase(f"pack: bit-identical (kernel {times_text(results['pack'])}, "
          f"plain {results['pack']['plain_ms']!r} ms)")

    # K2 decode
    npts = raw.npoints
    h_npts_t = torch.from_numpy(h_npts).to(dev)
    got = ck.decode_points(words, npts, W)
    want = ck.decode_points_plain(words, npts, W)
    h_got = ck.decode_points(h_words, h_npts_t, W)
    h_want = ck.decode_points_plain(h_words, h_npts_t, W)
    torch.cuda.synchronize()
    err = max(int_err(a, b) for a, b in zip(got + h_got, want + h_want))
    check(all(torch.equal(a, b) for a, b in zip(got + h_got, want + h_want)),
          f"decode kernel differs from its plain version: {err}")
    # The point loop reads each row only up to its stream's end.
    stream_bytes = int(chunks[3].sum()) // 8
    dec_bytes = stream_bytes + npts.numel() * 4 + N * W * (4 + 8 + 8) + N * 4
    results["decode"] = dict(
        max_abs_err=err, bytes=dec_bytes,
        **kernel_times(lambda: ck.decode_points(words, npts, W), 20),
        plain_ms=cuda_ms(lambda: ck.decode_points_plain(words, npts, W), 2))
    phase(f"decode: bit-identical (kernel {times_text(results['decode'])}, "
          f"plain {results['decode']['plain_ms']!r} ms)")

    # K3 hash
    hw_np, hl_np = pad_ids(ids)
    hw = torch.from_numpy(np.ascontiguousarray(hw_np)).to(dev)
    hl = torch.from_numpy(hl_np).to(dev)
    edge = [bytes(range(n)) for n in range(8)] + [b"m" * 2100] + ids[:64]
    ew_np, el_np = pad_ids(edge)
    ew = torch.from_numpy(np.ascontiguousarray(ew_np)).to(dev)
    el = torch.from_numpy(el_np).to(dev)
    err = max(u32_err(ck.hash_words(hw, hl), ck.hash_words_plain(hw, hl)),
              u32_err(ck.hash_words(ew, el), ck.hash_words_plain(ew, el)))
    torch.cuda.synchronize()
    check(err == 0, f"hash kernel differs from its plain version: {err}")
    results["hash"] = dict(
        max_abs_err=err, bytes=int(id_lens.sum()) + hl.numel() * 4 + N * 4,
        **kernel_times(lambda: ck.hash_words(hw, hl), 50),
        plain_ms=cuda_ms(lambda: ck.hash_words_plain(hw, hl), 3))
    phase(f"hash: bit-identical on {hw.shape[1]} cols and edge lengths 0-7, "
          f"2100 (kernel {times_text(results['hash'])}, plain "
          f"{results['hash']['plain_ms']!r} ms)")
    del got, want, h_got, h_want, words_plain, chunks, prep
    torch.cuda.empty_cache()

    # K4 window, at the query path's grids and a hostile shard-sized one
    corpus, t_q = promql_corpus(Q_SERIES, 11)
    window_cases = _query_grids(corpus, t_q)
    window_cases.append((hostile_residuals(SEED, SHARD_ROWS, 438), 30, 3))
    window_rows, results["window"] = _check_window(window_cases, dev)
    for r in window_rows:
        print(f"window {r['shape']} W={r['W']} stride={r['stride']} "
              f"{r['stat']}: kernel {times_text(r)}, plain {r['plain_ms']!r} "
              f"ms, library call {r['library_ms']!r} ms, device "
              f"{r['library_device_ms']!r} ms, bound {r['bound_ms']!r} ms, "
              f"max_abs_err {r['max_abs_err']!r}")
    torch.cuda.empty_cache()
    if args.parent:
        _parent_turns(args.parent, here, words, npts, window_cases, dev)
    del window_cases
    torch.cuda.empty_cache()

    # -- 4. the slice, through the entry points ----------------------------
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    steps = [time.perf_counter()]
    shards = ShardSet().lookup_batch(ids)
    order = torch.argsort(shards, stable=True)
    block = ingest.RawIngestBatch(raw.ts[order], raw.values[order],
                                  raw.npoints[order])
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    words, nbits, roll, blk, qs, range_ok = ingest.ingest_step_raw(
        block, rollup_factor=FACTOR, max_words=mw)
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    dts, dvals = tsz.decode_plane(words, block.npoints, window=W)
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    launches = ck.launch_counts()
    route_s, ingest_s, decode_s = np.diff(steps)
    phase(f"slice: {steps[-1] - steps[0]:.3f}s host clock (route + group "
          f"{route_s:.3f}s, ingest_step_raw {ingest_s:.3f}s, decode_plane "
          f"{decode_s:.3f}s), launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    check(bool(range_ok), "range_ok false")
    check(words.shape == (N, mw) and nbits.shape == (N,), "output shapes")
    check(torch.equal(dts, block.ts), "decoded timestamps differ from the block")
    check(torch.equal(dvals.view(torch.int64), block.values.view(torch.int64)),
          "decoded values differ from the block bit for bit")
    bpd = int(nbits.sum()) / 8.0 / (N * W)
    print(f"bytes_per_datapoint {bpd:.6f}")
    check(round(bpd, 3) == 1.429, f"bytes_per_datapoint {bpd}")
    check(torch.equal(shards.cpu(), ShardSet().lookup_batch(ids, device="cpu")),
          "shard ids differ from the plain hash")
    _check_aggregates(block, roll, blk, qs)
    phase("slice: exact round trip; rollup, block stats and quantiles agree "
          "with the plain computation")

    # -- 5. small input: the card against the plain versions on the CPU ----
    s_ts, s_vals, s_npts = hostile_block(SEED + 1, 512, W)
    for devname in ("cuda", "cpu"):
        sb = ingest.make_raw_batch(s_ts, s_vals, s_npts, device=devname)
        out = ingest.ingest_step_raw(sb, rollup_factor=FACTOR, max_words=mw,
                                     device=devname)
        dec = tsz.decode_plane(out[0], sb.npoints, window=W, with_f32=True,
                               device=devname)
        if devname == "cuda":
            ref = (out, dec)
    for a, b in ((ref[0][0], out[0]), (ref[0][1], out[1]), (ref[0][4], out[4]),
                 (ref[1][0], dec[0]), (ref[1][1].view(torch.int64),
                                       dec[1].view(torch.int64)),
                 (ref[1][2].view(torch.int32), dec[2].view(torch.int32))):
        check(torch.equal(a.cpu(), b), "card and CPU disagree on the small input")
    torch.cuda.synchronize()
    phase("small: card == plain CPU path on 512 hostile rows")

    # -- 6. the query path, through Engine.execute_range --------------------
    plan_corpus, _ = promql_corpus(Q_SERIES, 17, hosts=Q_HOSTS,
                                   metric=b"bench_requests")
    gauges, _ = gauge_corpus(Q_SERIES, GAUGE_SEED)
    query_launches, card_out = _query_phase(corpus, plan_corpus, gauges, t_q)
    by_path = {name: {"slice": launches.get(name, 0)} for name in REPLACES}
    for name in REPLACES:
        by_path[name]["query"] = query_launches[name]

    # -- 7. the storage node: write -> seal -> read, PromQL from it ---------
    storage_launches, block_pairs = _storage_phase(corpus, plan_corpus,
                                                   gauges, t_q, card_out)
    del gauges
    for name, n in storage_launches.items():
        by_path[name]["storage"] = n

    # -- 8. the flush merge and the compute-fault guard --------------------
    for name, n in _flush_phase(block_pairs).items():
        by_path[name]["flush"] = n
    del block_pairs
    _guard_phase()

    # -- 9. Graphite over stored carbon series, and query placement -------
    for name, n in _graphite_phase(t_q).items():
        by_path[name]["graphite"] = n
    _placement_phase(corpus, t_q)

    # -- 10. the compiled plan: bench_promql_plan_agg's query ---------------
    for name, n in _plan_phase(plan_corpus, t_q).items():
        by_path[name]["plan"] = n

    # -- 11. the aggregator tier and the standing rules engine ---------------
    for name, n in _aggregator_phase(plan_corpus, t_q).items():
        by_path[name]["aggregator"] = n

    # -- 12. the storage node's durability ----------------------------------
    for name, n in _durability_phase().items():
        by_path[name]["durability"] = n

    # -- 13. the client and the replicated cluster --------------------------
    for name, n in _cluster_phase().items():
        by_path[name]["cluster"] = n

    # -- 14. the coordinator -----------------------------------------------
    for name, n in _coordinator_phase().items():
        by_path[name]["coordinator"] = n

    # -- 15. config #2 over the network: KV, TCP, m3msg --------------------
    for name, n in _pipeline_phase().items():
        by_path[name]["pipeline"] = n

    # -- 16. the service binaries as child processes ------------------------
    for name, n in _services_phase().items():
        by_path[name]["services"] = n

    # -- 17. the harnesses: the drills and the witnesses --------------------
    for name, n in _harness_phase().items():
        by_path[name]["harness"] = n

    # -- 20 (started). the robustness tier's services: the two soaks and the
    # integration smoke as child processes, beside phases 18 and 19 (their
    # children count their own launches; nothing in this process does)
    robust = _robustness_start(here)
    try:
        # -- 18. the shard x time mesh on one card split four ways ---------
        for name, n in _mesh_phase(corpus, plan_corpus, t_q).items():
            by_path[name]["mesh"] = n
        del plan_corpus

        # -- 19. m3lint over the checkout's port ----------------------------
        _lint_phase(here)

        # -- 20. the robustness tier: the campaigns, then the services ------
        for name, n in _robustness_phase(robust).items():
            by_path[name]["robustness"] = n
    finally:
        _robustness_stop(robust)

    kernels = []
    for name in ("pack", "decode", "hash", "window"):
        r = results[name]
        src, rep = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "call_ms": r["call_ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": r.get("library_ms"),
            "library_device_ms": r.get("library_device_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def _query_grids(series, t):
    """The window kernel's inputs on the query path: the centred residual
    grids that [5m] (W 10, stride 1) and [5m10s] (W 31, stride 3)
    selectors give at step 30 s over t[30]..t[359]."""
    from m3_tpu_torch.ops.temporal import center
    from m3_tpu_torch.query.block import BlockMeta, consolidate_series

    start, end = int(t[30]), int(t[-1])
    steps = (end - start) // STEP_NS + 1
    grids = []
    for range_ns in (300_000_000_000, 310_000_000_000):
        wgrid = math.gcd(STEP_NS, range_ns)
        w, stride = range_ns // wgrid, STEP_NS // wgrid
        meta = BlockMeta(start - (w - 1) * wgrid, wgrid,
                         (w - 1) + (steps - 1) * stride + 1)
        grids.append((center(consolidate_series(series, meta, wgrid)[1])[0],
                      w, stride))
    return grids


def _check_window(cases, dev):
    """K4 against its plain version on the card for every stat at each
    (grid, W, stride) of `cases`: the query path's two grids and a hostile
    shard-sized grid. Returns the
    per-(shape, stat) rows and the kernels-line entry (the [5m] grid,
    `sum`, as sum_over_time runs it)."""
    import torch
    import torch.nn.functional as F

    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.testing import window_reorder_bounds

    rows, worst = [], 0.0
    for x_np, w, stride in cases:
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
        s, k = x.shape
        t_out = (k - w) // stride + 1
        sum_b, m2_b = window_reorder_bounds(x, w, stride)
        finite = torch.isfinite(x)
        premasked = {
            "count": finite.float(), "sum": torch.where(finite, x, 0.0),
            "max": torch.where(finite, x, float("-inf")),
            "min": torch.where(finite, -x, float("-inf"))}
        for stat in wk.STATS:
            got, got_c = wk.window_stat(x, w, stride, stat)
            want, want_c = wk.window_stat_plain(x, w, stride, stat)
            torch.cuda.synchronize()
            check(torch.equal(got_c, want_c),
                  f"window {stat} {s}x{k}: counts differ")
            if stat in ("count", "min", "max", "last"):
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"window {stat} {s}x{k}: not bit-identical")
                err = 0.0
            else:
                diff = (got.double() - want.double()).abs()
                bound = (sum_b if stat == "sum" else m2_b) + 1e-12
                check(bool((diff <= bound).all()),
                      f"window {stat} {s}x{k}: beyond the reorder bound by "
                      f"{float((diff - bound).max())}")
                err = float(diff.max())
            worst = max(worst, err)
            lib = premasked.get(stat)
            pool = F.max_pool1d if stat in ("min", "max") else F.avg_pool1d
            row = dict(
                shape=[s, k], W=w, stride=stride, stat=stat, max_abs_err=err,
                **kernel_times(lambda: wk.window_stat(x, w, stride, stat), 20),
                plain_ms=cuda_ms(
                    lambda: wk.window_stat_plain(x, w, stride, stat), 3),
                library_ms=None, library_device_ms=None,
                bytes=(s * k + 2 * s * t_out) * 4)
            if lib is not None:
                lt = kernel_times(lambda: pool(lib[:, None, :], w, stride), 20)
                row.update(library_ms=lt["call_ms"],
                           library_device_ms=lt["device_ms"])
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            rows.append(row)
        if s == SHARD_ROWS:
            copy = device_ms(lambda: x.clone())
            print(f"window yardstick: clone of the [{s}, {k}] grid, device "
                  f"{copy!r} ms, {2 * x.numel() * 4 / copy / 1e9!r} TB/s")
        del x, sum_b, m2_b, finite, premasked, got, want
        torch.cuda.empty_cache()
    phase(f"window: count/min/max/last bit-identical, sum/m2 within the "
          f"reorder bound at {len(cases)} grids x 6 stats (largest sum/m2 "
          f"difference {worst!r})")
    head = dict(rows[1], max_abs_err=worst)
    return rows, head


def _start_ptxas(here):
    """One `nvcc -Xptxas=-v` per kernel source, started beside the
    extension's build: each kernel's registers, spills and shared memory."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = os.path.join(here, "build", "ptxas")
    os.makedirs(out, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    csrc = os.path.join(here, "m3_tpu_torch", "csrc")
    return {src: subprocess.Popen(
        [nvcc, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas=-v", "-c", os.path.join(csrc, src),
         "-o", os.path.join(out, src + ".o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sorted(os.listdir(csrc)) if src.endswith(".cu")}


def _print_ptxas(procs, texts) -> None:
    for src, proc in procs.items():
        check(proc.returncode == 0, f"nvcc -Xptxas=-v {src}: {texts[src][-2000:]}")
        fn = ""
        for line in texts[src].splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "Used" in line or "spill" in line:
                print(f"ptxas {src} {fn}: {line.split(':', 1)[-1].strip()}")


def _load_parent(root, here):
    """The parent checkout's codec and window wrappers, as the package
    m3_tpu_torch_parent, bound to its own kernels built as a second
    extension under build/parent_kernels."""
    import importlib
    import importlib.util

    from torch.utils.cpp_extension import load

    pkg = os.path.join(os.path.abspath(root), "m3_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "m3_tpu_torch_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    pck = importlib.import_module("m3_tpu_torch_parent.ops.codec_kernels")
    pwk = importlib.import_module("m3_tpu_torch_parent.ops.window_kernels")
    build_dir = os.path.join(here, "build", "parent_kernels")
    os.makedirs(build_dir, exist_ok=True)
    ext = load(name="m3_tpu_torch_parent_kernels",
               sources=[str(pck.CSRC / src) for src in pck.SOURCES],
               extra_cflags=["-O3"],
               extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
               build_directory=build_dir)
    pck.build = pwk.build = lambda: ext
    return pck, pwk


def _parent_turns(root, here, words, npts, window_cases, dev) -> None:
    """The parent's decode and window wrappers against this checkout's at
    the main path's shapes, in turns parent, change, change, parent, each
    turn a call time and a device time (kernel_times); the outputs must
    agree (counts exactly, decode bit for bit)."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    t = time.perf_counter()
    pck, pwk = _load_parent(root, here)
    phase(f"parent: built {root} in {time.perf_counter() - t:.1f}s")
    cases = [("decode", f"[{N}, {W}]", (pck, ck),
              lambda m: (lambda: m.decode_points(words, npts, W)))]
    for x_np, w, stride in window_cases:
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
        for stat in wk.STATS:
            cases.append((
                "window", f"{list(x.shape)} W={w} stride={stride} {stat}",
                (pwk, wk), lambda m, x=x, w=w, stride=stride, stat=stat: (
                    lambda: m.window_stat(x, w, stride, stat))))
    for name, label, (old, new), make in cases:
        a, b = make(old)(), make(new)()
        torch.cuda.synchronize()
        same = (all(torch.equal(u, v) for u, v in zip(a, b)) if name == "decode"
                else torch.equal(a[1], b[1]))
        check(same, f"parent and change differ: {name} {label}")
        del a, b
        turns = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            turns[side].append(kernel_times(make(
                old if side == "parent" else new), 20))
        print(f"turns {name} {label}: " + "; ".join(
            f"{side} call_ms {[r['call_ms'] for r in rs]!r} device_ms "
            f"{[r['device_ms'] for r in rs]!r}" for side, rs in turns.items()))
    phase(f"parent: {len(cases)} cases timed in turns")


def _metric_of(q: str) -> bytes:
    """The corpus a query reads: bench_requests, bench_gauge or
    bench_metric."""
    for metric in (b"bench_requests", b"bench_gauge"):
        if metric.decode() in q:
            return metric
    return b"bench_metric"


def _window_wanted(queries) -> int:
    """The window kernel's launches for `queries`: one per *_over_time
    (quantile_over_time sorts instead)."""
    return sum("_over_time" in q and not q.startswith("quantile_over_time")
               for q in queries)


def _query_tol(q: str, exp):
    """None (equal) or the allclose bounds of query q's check."""
    if q.startswith(EXACT):
        return None
    for fn, tol in FAMILY_TOL.items():
        if q.startswith(fn):
            return tol
    if "bench_gauge" in q:
        finite = exp[np.isfinite(exp)]
        scale = float(np.abs(finite).max()) if finite.size else 1.0
        return dict(rtol=2e-5, atol=max(1e-8, 1e-6 * scale))
    return dict(rtol=1e-5, atol=1e-8)


def _check_query(q, blk, ref, what: str) -> float:
    """blk against ref under q's bounds: same tags and order, same NaN
    cells, values equal or within the bounds. Returns the largest
    relative and absolute differences."""
    got, exp = np.asarray(blk.values), np.asarray(ref.values)
    check([x.id() for x in blk.series_tags]
          == [x.id() for x in ref.series_tags], f"{q}: tags differ ({what})")
    check(got.shape == exp.shape and bool(
        (np.isnan(got) == np.isnan(exp)).all()),
        f"{q}: NaN cells differ ({what})")
    tol = _query_tol(q, exp)
    if tol is None:
        check(bool(np.array_equal(got, exp, equal_nan=True)),
              f"{q}: values differ ({what}, expected equal)")
    else:
        check(bool(np.allclose(got, exp, equal_nan=True, **tol)),
              f"{q}: values differ ({what}, {tol})")
    fin = np.isfinite(exp)
    if not fin.any():
        return 0.0, 0.0
    diff = np.abs(got - exp)[fin]
    return (float((diff / np.maximum(np.abs(exp[fin]), 1e-30)).max()),
            float(diff.max()))


def _query_phase(corpus, plan_corpus, gauges, t):
    """The query path on the card against device="cpu", bench_metric
    queries over bench_promql's storage, bench_requests queries over
    bench_promql_plan_agg's, and bench_gauge queries over the gauge grid.
    The card's engines are the default one (no placement), so every
    query takes the default route: the compiled plan (one CUDA graph per
    plan shape, the window kernel inside it) wherever its plan lowers,
    which here is every query. Then the same queries through
    execute_range_ref on the card, the compiled answers held to the
    interpreter's. Returns the kernels' launches during the default-route
    card run and the card's answers."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.testing import DictStorage

    storages = {b"bench_metric": DictStorage(corpus),
                b"bench_requests": DictStorage(plan_corpus),
                b"bench_gauge": DictStorage(gauges)}
    engines = {m: (Engine(st), Engine(st, device="cpu"))
               for m, st in storages.items()}

    def engine(q, on_card):
        return engines[_metric_of(q)][0 if on_card else 1]

    start, end = int(t[30]), int(t[-1])
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_out = _default_route_run(lambda q: engine(q, True), start, end,
                                  "query")
    card_s = time.perf_counter() - t0
    launches = wk.window_stat.launches
    codec = ck.launch_counts()
    query_launches = dict(codec, window=launches)
    phase(f"query: {len(ALL_QUERIES)} queries on the card in {card_s:.3f}s "
          f"(plan builds included), window launches {launches} (a build "
          f"launches once in its warm-up, a replay once a window query), "
          f"codec {codec}")
    check(launches > 0, "the window kernel did not launch on the query path")
    for q in ALL_QUERIES:
        blk, secs = card_out[q]
        tq = time.perf_counter()
        ref = engine(q, False).execute_range(q, start, end, STEP_NS)
        cpu_s = time.perf_counter() - tq
        rel, diff = _check_query(q, blk, ref, "card against device=cpu")
        print(f"query {q!r}: {np.asarray(blk.values).shape}, card "
              f"{secs:.4f}s, cpu {cpu_s:.4f}s, max rel diff {rel!r}, max "
              f"abs diff {diff!r}, bound "
              f"{_query_tol(q, np.asarray(ref.values))}")
    phase("query: every query on the card equals its device=\"cpu\" run")
    ref_out = _against_interpreter(lambda q: engine(q, True), card_out,
                                   start, end, "query")
    _function_times(corpus, t)
    _breakdown(engines[b"bench_metric"][0], storages[b"bench_metric"], t,
               ref_out)
    with _instrumented(QUERY_STEPS) as pair:
        for q in ("rate(bench_metric[5m])", "sum_over_time(bench_metric[5m])"):
            engine(q, True).execute_range(q, start, end, STEP_NS).values
    print(f"pair through Engine.execute_range, traced: "
          f"{pair['wall'] * 1e3:.3f} ms; {_split_text(pair)}")
    _check_replays("query")
    return query_launches, card_out


def _lowers(q: str, start: int, end: int) -> bool:
    """True when q's plan lowers (the route the reference compiles, past
    the 4,096-cell floor that every query of this script clears)."""
    from m3_tpu_torch.query import plan as qplan
    from m3_tpu_torch.query import promql
    from m3_tpu_torch.query.executor import DEFAULT_LOOKBACK_NS, QueryParams

    plan, _, _ = qplan.lower_and_collect(
        promql.parse(q), QueryParams(start, end, STEP_NS),
        DEFAULT_LOOKBACK_NS)
    return plan is not None


def _default_route_run(engine_for, start: int, end: int, label: str,
                       queries=ALL_QUERIES) -> dict:
    """`queries` once each through the default route on the card
    (execute_range, materialized, synchronised). Prints each query's
    route, fallback reason and window kernel launches; a query whose plan
    lowers must report `compiled`, and the window kernel must launch for
    a window query (every *_over_time but quantile_over_time) and only
    for one, and a compiled query's executable must be a captured graph
    whose replay equals its eager body bit for bit (checked after the
    timing; those runs count as no launch). Returns {query: (block,
    seconds)}."""
    import torch

    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel import compile as pcompile

    out = {}
    for q in queries:
        eng = engine_for(q)
        before = wk.window_stat.launches
        tq = time.perf_counter()
        blk = eng.execute_range(q, start, end, STEP_NS)
        blk.values
        torch.cuda.synchronize()
        out[q] = (blk, time.perf_counter() - tq)
        k4 = wk.window_stat.launches - before
        route = eng.last_route()
        print(f"{label} route {q!r}: {route['route']}, fallback "
              f"{route['fallback_reason']}, window launches {k4}, "
              f"{out[q][1]:.4f}s")
        if _lowers(q, start, end):
            check(route["route"] == "compiled",
                  f"{q}: took {route} though its plan lowers")
        if route["route"] == "compiled":
            # The executable just replayed is the cache's most recent.
            key, exe = pcompile.executables()[-1]
            check(exe.graph is not None and exe.replay_matches_eager(),
                  f"{q}: {key} is no captured graph whose replay equals "
                  f"its eager body")
        check((k4 > 0) == bool(_window_wanted([q])),
              f"{q}: window kernel launched {k4} times")
    return out


def _plan_tol(q: str, ref):
    """The compiled route's bounds against the interpreter (PLAN_LOOSE,
    else the scale-aware rtol 2e-5)."""
    for fn, tol in PLAN_LOOSE.items():
        if q.startswith(fn):
            return tol
    finite = ref[np.isfinite(ref)]
    scale = float(np.abs(finite).max()) if finite.size else 1.0
    return dict(rtol=2e-5, atol=max(1e-8, 1e-6 * scale))


def _check_plan(q, blk, ref, what: str) -> float:
    """A compiled answer against the interpreter's: the same series set,
    the same NaN cells, values within _plan_tol. Returns the largest
    relative difference."""
    gtags = [bytes(x.id()) for x in blk.series_tags]
    rtags = [bytes(x.id()) for x in ref.series_tags]
    check(sorted(gtags) == sorted(rtags), f"{q}: series set differs ({what})")
    order = {k: i for i, k in enumerate(rtags)}
    got = np.asarray(blk.values, np.float64)
    exp = np.asarray(ref.values, np.float64)[[order[k] for k in gtags]]
    check(bool((np.isnan(got) == np.isnan(exp)).all()),
          f"{q}: NaN cells differ ({what})")
    tol = _plan_tol(q, exp)
    check(bool(np.allclose(got, exp, equal_nan=True, **tol)),
          f"{q}: values differ ({what}, {tol})")
    fin = np.isfinite(exp)
    if not fin.any():
        return 0.0
    return float((np.abs(got - exp)[fin]
                  / np.maximum(np.abs(exp[fin]), 1e-30)).max())


def _against_interpreter(engine_for, out: dict, start: int, end: int,
                         label: str) -> dict:
    """The queries of `out` through execute_range_ref on the card: each
    default-route answer held to the interpreter's (_check_plan).
    Returns {query: interpreter block}."""
    import torch

    refs = {}
    for q in out:
        tq = time.perf_counter()
        ref = engine_for(q).execute_range_ref(q, start, end, STEP_NS)
        ref.values
        torch.cuda.synchronize()
        secs = time.perf_counter() - tq
        rel = _check_plan(q, out[q][0], ref, "compiled against interpreter")
        refs[q] = ref
        print(f"{label} interpreter {q!r}: {secs:.4f}s on the card, "
              f"compiled max rel diff {rel!r}, bound "
              f"{_plan_tol(q, np.asarray(ref.values))}")
    phase(f"{label}: every compiled answer equals the card interpreter's "
          f"within the reference's plan bounds")
    return refs


def _check_replays(label: str) -> None:
    """Every cached executable on the card is a captured CUDA graph whose
    replay equals its body run eagerly on the card, bit for bit. Prints
    each one's build wall, graph pool and static input bytes, warm-up
    growth, window launches a replay and replays, and the `plan` tenant
    beside torch.cuda.memory_allocated(); then drops them all, so the
    next phase starts with the budget its own tenants had before this
    slice (the plan tenant would otherwise evict their entries)."""
    import torch

    from m3_tpu_torch.parallel import compile as pcompile
    from m3_tpu_torch.utils import hbm

    cached = [(k, e) for k, e in pcompile.executables()
              if k.endswith(":cuda")]
    check(bool(cached), "no executable on the card")
    for key, exe in cached:
        check(exe.graph is not None, f"{key}: no captured graph")
        check(exe.replay_matches_eager(),
              f"{key}: replay differs from the eager body")
        print(f"{label} executable {key}: build {exe.build_s * 1e3:.3f} ms, "
              f"pool {exe.pool_bytes} bytes, static inputs "
              f"{exe.input_bytes} bytes, warm-up growth {exe.warmup_bytes} "
              f"bytes, window launches a replay {exe.k4_launches}, replays "
              f"{exe.replays}")
    budget = hbm.shared_budget()
    print(f"{label} plan tenant: {budget.usage().get('plan', 0)} bytes over "
          f"{len(cached)} executables; budget total {budget.total()} of "
          f"{budget.limit} bytes; torch.cuda.memory_allocated() "
          f"{torch.cuda.memory_allocated()} bytes, memory_reserved() "
          f"{torch.cuda.memory_reserved()} bytes")
    phase(f"{label}: {len(cached)} executables are captured CUDA graphs; "
          f"each replay equals its eager body bit for bit")
    pcompile.clear()
    torch.cuda.empty_cache()


def _function_times(corpus, t) -> None:
    """Call time (CUDA events around a loop of calls, host enqueue
    included) of the four torch-op device functions that the six range
    functions run, at the [5m] grid of bench_promql's corpus ([10,000,
    119] f32 residuals, W 10, stride 1), beside K4's `sum` at the same
    grid."""
    import torch

    from m3_tpu_torch.ops import temporal as tp

    resid = torch.from_numpy(np.ascontiguousarray(
        _query_grids(corpus, t)[0][0])).to(torch.device("cuda"))
    calls = {
        "quantile_idx (quantile_over_time)":
            lambda: tp._quantile_idx_fn(10)(resid, 0.9),
        "changes_resets (changes)":
            lambda: tp._changes_resets_fn(10, False)(resid),
        "regression (deriv)":
            lambda: tp._regression_fn(10, 30.0, 0.0, True)(resid),
        "holt_winters": lambda: tp._holt_winters_fn(10, 0.3, 0.6)(resid),
        "over_time (K4 sum)": lambda: tp._over_time_fn(10, "sum")(resid),
    }
    for name, fn in calls.items():
        print(f"function {name} at {tuple(resid.shape)} W 10: call "
              f"{cuda_ms(fn, 20)!r} ms")


def _breakdown(card, storage, t, ref_out, label: str = "") -> None:
    """Host clock of one rate + sum_over_time pair on the interpreter's
    steps, each step ending in torch.cuda.synchronize(): fetch +
    consolidate_series, host prep (_host_diff_grid / center), the H2D
    copy, the device kernels, the D2H copy plus finish. The results must
    equal the interpreter's (execute_range_ref). Then the pair's warm,
    cold and missing runs on the default route (_pair_runs)."""
    import torch

    from m3_tpu_torch.ops import temporal as tp
    from m3_tpu_torch.query import promql
    from m3_tpu_torch.query.block import BlockMeta, consolidate_series

    dev = torch.device("cuda")
    start, end = int(t[30]), int(t[-1])
    steps = (end - start) // STEP_NS + 1
    wgrid, w = STEP_NS, 10
    meta = BlockMeta(start - (w - 1) * wgrid, wgrid, (w - 1) + steps)
    split = {}
    for q in ("rate(bench_metric[5m])", "sum_over_time(bench_metric[5m])"):
        sel = promql.parse(q).args[0]
        marks = [time.perf_counter()]
        series = storage.fetch_raw(promql.selector_matchers(sel),
                                   meta.start_ns - wgrid, end + 1)
        grid = consolidate_series(series, meta, wgrid)[1]
        marks.append(time.perf_counter())
        if q.startswith("rate"):
            host = tp.rate_inputs(grid, True)
            marks.append(time.perf_counter())
            args = [tp._put(a, dev) for a in host]
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            out = tp.rate_math(*args, W=w, step_s=wgrid / 1e9, range_s=300.0,
                               is_counter=True, is_rate=True)
        else:
            resid, base = tp.center(grid)
            marks.append(time.perf_counter())
            args = [tp._put(resid, dev), tp._put(base.astype(np.float32), dev)]
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            out = tp.over_time_math(*args, W=w, kind="sum")
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        res = tp._fetch(out)
        marks.append(time.perf_counter())
        check(np.array_equal(res, np.asarray(ref_out[q].values),
                             equal_nan=True), f"breakdown of {q} differs")
        split[q.split("(")[0]] = np.diff(marks)
    names = ("fetch+consolidate", "host prep", "H2D", "kernels", "D2H+finish")
    for q, d in split.items():
        print(f"breakdown{label} {q}: " + ", ".join(
            f"{n} {x * 1e3:.3f} ms" for n, x in zip(names, d))
            + f"; total {d.sum() * 1e3:.3f} ms")
    _pair_runs(card, storage, t, label)


def _pair_runs(card, storage, t, label: str) -> None:
    """The rate + sum_over_time pair, PAIR_RUNS times each way:
    warm: the engine whose grid cache and derived-input id path hold the
    grids; cold: a new engine each run, so its grids are new objects with
    the content of earlier runs, and the derived-input cache's content
    tier hashes them and hits; miss: a new engine and a start later by a
    number of steps no earlier miss run of the script used (phase 7 (b)'s
    store grids the same content as phase 6's dict), so the grids'
    content is new and the content tier hashes, misses, runs the host
    prep and uploads. Prints the median and
    each run with the full GC pauses inside it set apart, the
    derived-input cache's hits and misses, and the host clock spent
    hashing, in host prep and in the H2D copies."""
    import torch

    from m3_tpu_torch.ops import temporal as tp
    from m3_tpu_torch.query.executor import Engine

    start, end = int(t[30]), int(t[-1])
    counter = tp._DERIVED_METRICS.counter
    for which in ("warm", "cold", "miss"):
        runs = []
        for i in range(PAIR_RUNS):
            eng = card if which == "warm" else Engine(storage)
            first = (start + next(_MISS_SHIFTS) * STEP_NS if which == "miss"
                     else start)
            hits, misses = counter("hits").value(), counter("misses").value()
            with _host_clock() as spent, _gc_pauses() as pauses:
                t0 = time.perf_counter()
                blocks = [eng.execute_range(q, first, end, STEP_NS)
                          for q in ("rate(bench_metric[5m])",
                                    "sum_over_time(bench_metric[5m])")]
                for blk in blocks:
                    blk.values
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            runs.append(dict(ms=ms, pauses=pauses,
                             **{k: v * 1e3 for k, v in spent.items()},
                             hits=counter("hits").value() - hits,
                             misses=counter("misses").value() - misses))
        med = float(np.median([r["ms"] for r in runs]))
        med_gc = float(np.median([r["ms"] - sum(r["pauses"]) for r in runs]))
        print(f"pair through Engine.execute_range{label}, {which}: median of "
              f"{PAIR_RUNS} {med!r} ms ({med_gc!r} ms with full GC pauses "
              f"taken out); runs " + "; ".join(
                  f"{r['ms']!r} ms, GC pauses {r['pauses']}, derived cache "
                  f"hits {r['hits']} misses {r['misses']}, hashing "
                  f"{r['hash']!r} ms, host prep {r['prep']!r} ms, H2D "
                  f"{r['h2d']!r} ms" for r in runs))


@contextlib.contextmanager
def _host_clock():
    """The host clock (seconds) spent inside the block in ops/temporal's
    blake2b calls ("hash"), in its host prep, rate_inputs and center
    ("prep"), and in its H2D copies, _put with a synchronize after each
    ("h2d"), in the dict it yields."""
    import hashlib

    import torch

    from m3_tpu_torch.ops import temporal as tp

    spent = {"hash": 0.0, "prep": 0.0, "h2d": 0.0}

    def timed(key, fn, sync=False):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return call

    class _Timed:
        def __getattr__(self, name):
            return getattr(hashlib, name)

        blake2b = staticmethod(timed("hash", hashlib.blake2b))

    saved = {n: getattr(tp, n)
             for n in ("hashlib", "rate_inputs", "center", "_put")}
    tp.hashlib = _Timed()
    tp.rate_inputs = timed("prep", saved["rate_inputs"])
    tp.center = timed("prep", saved["center"])
    tp._put = timed("h2d", saved["_put"], sync=True)
    try:
        yield spent
    finally:
        for n, v in saved.items():
            setattr(tp, n, v)


@contextlib.contextmanager
def _gc_pauses():
    """The durations (ms) of the full (generation 2) garbage collections
    that ran inside the block: a single timed run of a Python-bound step
    can hold one, and it can cost a fifth of the step."""
    import gc

    pauses, began = [], {}

    def note(stage, info):
        if info["generation"] != 2:
            return
        if stage == "start":
            began["t"] = time.perf_counter()
        elif "t" in began:
            pauses.append(round((time.perf_counter() - began.pop("t")) * 1e3,
                                3))

    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


def _storage_phase(corpus, plan_corpus, gauges, t, card_out):
    """Phase 7: the storage node on the card. Returns each kernel's
    launches over the phase's two paths (the counts set to 0 before each
    and read after), and each shard's pair of sealed blocks of (a) for
    phase 8's merge."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.storage import block_cache

    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db, hot = _write_seal_read()
    launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
    secs = time.perf_counter() - t0
    phase(f"storage (a): write -> seal -> hot-set read in {secs:.1f}s host "
          f"clock, launches {launches}")
    check(launches["hash"] == hot["write_calls"],
          f"hash kernel launched {launches['hash']} times for "
          f"{hot['write_calls']} write_batch calls")
    check(launches["pack"] == hot["sealed"],
          f"pack kernel launched {launches['pack']} times for "
          f"{hot['sealed']} seals")
    check(launches["decode"] > 0, "the decode kernel did not launch")
    _check_sealed_planes(db)
    pairs = [tuple(blk for _, blk in sorted(shard.blocks.items()))
             for shard in db.namespace(b"bench").shards.values()]
    db.close()
    left = {k: v for k, v in block_cache.get_cache().budget.usage().items()
            if v and k not in QUERY_CACHE_TENANTS}
    check(not left, f"the closed database left bytes charged to the budget: "
          f"{left}")
    del db
    torch.cuda.empty_cache()

    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    query_launches = _stored_promql(corpus, plan_corpus, gauges, t, card_out)
    for name, n in query_launches.items():
        launches[name] += n
    return launches, pairs


def _write_seal_read():
    """bench_hot_set_read on the card at STORE_SERIES series: the writes,
    the seal and the 2,000-read mix, cold once and warm WARM_PASSES times.
    Returns the database and the counts the checks need."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.storage import block_cache
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    rng = np.random.default_rng(STORE_SEED)
    t0 = (1_700_000_000 * 10**9 // BLOCK_NS) * BLOCK_NS
    step_ns = BLOCK_NS // STORE_PPB
    now = {"t": t0}
    db = Database(ShardSet(num_shards=STORE_SHARDS), clock=lambda: now["t"])
    db.ensure_namespace(b"bench", NamespaceOptions(
        index_enabled=False, snapshot_enabled=False,
        retention_ns=4 * 24 * 3600 * 10**9, writes_to_commitlog=False))
    ids = [b"hot-%06d" % i for i in range(STORE_SERIES)]
    ones = np.ones(STORE_SERIES)
    vals_by_step = rng.standard_normal((2 * STORE_PPB,))
    with _instrumented(WRITE_STEPS) as write:
        for step in range(2 * STORE_PPB):
            ts_i = t0 + step * step_ns
            now["t"] = ts_i
            db.write_batch(b"bench", ids,
                           np.full(STORE_SERIES, ts_i, np.int64),
                           ones * vals_by_step[step])
    write_s = write["wall"]
    points = STORE_SERIES * 2 * STORE_PPB
    print(f"storage write: {2 * STORE_PPB} write_batch calls of "
          f"{STORE_SERIES} points in {write_s:.3f}s host clock, "
          f"{points / write_s:.1f} datapoints/s; {_split_text(write)}")
    now["t"] = t0 + 2 * BLOCK_NS + 11 * MINUTE_NS
    with _instrumented(SEAL_STEPS) as seal:
        stats = db.tick()
    seal_s = seal["wall"]
    check(stats["sealed"] == 2 * STORE_SHARDS, f"tick sealed {stats}")
    cache = block_cache.get_cache()
    print(f"storage seal split: {_split_text(seal)}")
    print(f"storage seal: {stats['sealed']} blocks in {seal_s:.3f}s host "
          f"clock, {seal_s / stats['sealed'] * 1e3:.3f} ms per block; "
          f"retained {cache.stats()['retained']} word tensors, "
          f"{cache.resident_bytes()} bytes; budget total "
          f"{cache.budget.total()} bytes, torch.cuda.memory_allocated() "
          f"{torch.cuda.memory_allocated()} bytes")
    check(cache.stats()["retained"] == stats["sealed"],
          "the seal's word tensors were not retained")
    counts = ck.launch_counts()
    _check_storage_kernels(db)
    for name, fn in ck.KERNELS.items():  # comparisons do not count
        fn.launches = counts[name]

    n_hot = max(1, int(STORE_SERIES * HOT_FRAC))
    hot_ids = rng.permutation(STORE_SERIES)[:n_hot]
    draws = rng.random(HOT_READS)
    pick_hot = hot_ids[rng.integers(0, n_hot, HOT_READS)]
    pick_cold = rng.integers(0, STORE_SERIES, HOT_READS)
    mix = np.where(draws < HOT_WEIGHT, pick_hot, pick_cold)
    start, end = t0, t0 + 2 * BLOCK_NS

    def run_pass():
        durs = np.empty(HOT_READS)
        total = 0
        for i, sidx in enumerate(mix):
            r0 = time.perf_counter()
            ts, _ = db.read(b"bench", ids[int(sidx)], start, end)
            durs[i] = time.perf_counter() - r0
            total += len(ts)
        return durs, total

    decode_before = ck.decode_points.launches
    cold, n_points = run_pass()
    cold_decodes = ck.decode_points.launches - decode_before
    check(n_points == HOT_READS * 2 * STORE_PPB, f"cold pass read {n_points}")
    print(f"storage hot-set read, cold: {HOT_READS / cold.sum():.1f} reads/s, "
          f"p99 {np.quantile(cold, 0.99) * 1e3:.4f} ms, mean "
          f"{cold.mean() * 1e3:.4f} ms, slowest {cold.max() * 1e3:.3f} ms, "
          f"{cold_decodes} decode launches; {cache.stats()}")
    for k in range(WARM_PASSES):
        decode_before = ck.decode_points.launches
        warm, got = run_pass()
        check(got == n_points, f"warm pass read {got}")
        print(f"storage hot-set read, warm {k + 1}: "
              f"{HOT_READS / warm.sum():.1f} reads/s, p99 "
              f"{np.quantile(warm, 0.99) * 1e3:.4f} ms, mean "
              f"{warm.mean() * 1e3:.4f} ms, "
              f"{ck.decode_points.launches - decode_before} decode launches")
    stats = cache.stats()
    hit_rate = stats["hits"] / max(1, stats["hits"] + stats["misses"])
    print(f"storage block cache: {stats}, hit rate {hit_rate!r}")
    sample = mix[rng.integers(0, HOT_READS, 50)]
    cached = [db.read(b"bench", ids[int(i)], start, end) for i in sample]
    uncached, durs = [], np.empty(len(sample))
    with block_cache.disabled():
        for j, i in enumerate(sample):
            r0 = time.perf_counter()
            uncached.append(db.read(b"bench", ids[int(i)], start, end))
            durs[j] = time.perf_counter() - r0
    print(f"storage read, cache bypassed (two cold one-row decodes a read): "
          f"mean {durs.mean() * 1e3:.4f} ms, p99 "
          f"{np.quantile(durs, 0.99) * 1e3:.4f} ms")
    for (ct, cv), (ut, uv) in zip(cached, uncached):
        check(ct.tobytes() == ut.tobytes() and cv.tobytes() == uv.tobytes(),
              "a cached read differs from the bypassed decode")
    phase("storage (a): 50 cached reads equal the bypassed decode bit for bit")
    return db, {"write_calls": 2 * STORE_PPB, "sealed": 2 * STORE_SHARDS}


# The steps of a write_batch and of a seal that _instrumented times:
# label -> (source file suffix, function name) as cProfile records them.
_D2H = ("~", "<method 'cpu' of 'torch._C.TensorBase' objects>")
WRITE_STEPS = {
    "hash_batch (ID padding, H2D, K3)": ("utils/hashing.py", "hash_batch"),
    "of which pad_ids": ("utils/hashing.py", "pad_ids"),
    "shard ids D2H": _D2H,
    "Shard.write_batch": ("storage/shard.py", "write_batch"),
    "of which registry resolve": ("storage/series.py", "lookup_batch"),
    "of which buffer append": ("storage/buffer.py", "write_batch"),
    "of which new-series inserts": ("storage/insert_queue.py", "insert"),
}
SEAL_STEPS = {
    "buffer drain (dedup + to_dense)": ("storage/buffer.py", "drain"),
    "encode_block": ("storage/block.py", "encode_block"),
    "of which host prep": ("ops/tsz.py", "prepare_encode_inputs"),
    "of which encode enqueue": ("ops/tsz.py", "encode_prepared"),
    "of which D2H (waits for the encode)": _D2H,
    "of which boundary metadata": ("ops/tsz.py", "boundary_metadata"),
    "of which time unit": ("storage/block.py", "choose_time_unit"),
}


@contextlib.contextmanager
def _instrumented(steps):
    """Host clock of the block (ending in a synchronise), the cumulative
    seconds of the functions `steps` names (cProfile), and the device's
    busy seconds (torch.profiler, CUDA activity only: kernels and copies),
    in the dict it yields. cProfile counts Python calls, which these
    steps make few of, so the overhead is small."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    res = {}
    prof = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        prof.enable()
        yield res
        torch.cuda.synchronize()
        prof.disable()
        res["wall"] = time.perf_counter() - t0
    split = dict.fromkeys(steps, 0.0)
    for (path, _line, func), row in pstats.Stats(prof).stats.items():
        for label, (suffix, name) in steps.items():
            if func == name and path.endswith(suffix):
                split[label] += row[3]
    res["split"] = split
    res["device"] = _device_seconds(trace)


def _device_seconds(trace):
    """Busy seconds of the device in a torch.profiler trace (kernel and
    copy durations summed), or None when the trace holds no device time."""
    total = 0.0
    for evt in trace.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            total += evt.time_range.elapsed_us()
    if total == 0.0:
        total = sum(getattr(e, "self_device_time_total", 0) or 0
                    for e in trace.key_averages())
    return total / 1e6 if total > 0 else None


def _split_text(res) -> str:
    dev = res["device"]
    busy = ("device busy not measured (no device time in the trace)"
            if dev is None else f"device busy {dev * 1e3:.3f} ms "
            f"({dev / res['wall'] * 100:.3f}% of the host clock)")
    return "; ".join([f"{k} {v * 1e3:.3f} ms" for k, v in res["split"].items()]
                     + [busy])


def _sealed_blocks(db):
    for shard in db.namespace(b"bench").shards.values():
        for bs, blk in sorted(shard.blocks.items()):
            yield shard, bs, blk


ENCODE_KEYS = ("dt", "t0", "v", "int_mode", "k", "npoints", "ts_regular",
               "delta0")


def _check_storage_kernels(db) -> None:
    """The kernels at the storage path's shapes against their plain
    versions on the card, before any read: the pack of one seal's chunks
    (the seal's own words must equal it), the decode of one block's
    retained word tensor (an admission) and of one row (a cold read)."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import tsz
    from m3_tpu_torch.storage import block_cache

    shard, bs, blk = next(_sealed_blocks(db))
    words, npoints = block_cache.get_cache().encoded(blk)
    with block_cache.disabled():
        ts, vals, npts = blk.read_all()
    s = blk.num_series
    sp = words.shape[0]
    pad = np.arange(sp) % s
    inp = tsz.prepare_encode_inputs(
        ts[pad] // blk.time_unit.nanos, vals[pad], npts[pad])
    chunks = tsz.encode_chunks(**{k: inp[k] for k in ENCODE_KEYS})
    mw = words.shape[1]
    got = ck.pack_chunks(*chunks, mw)
    want = ck.pack_chunks_plain(*chunks, mw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "pack kernel differs from its plain "
          "version at the seal's shape")
    check(torch.equal(got[:s].cpu(), torch.from_numpy(
        blk.words.view(np.int32))), "the sealed words differ from the pack "
          "of the same block's chunks")
    for w_in, n_in in ((words, npoints), (words[:1], npoints[:1])):
        got = ck.decode_points(w_in, n_in, blk.window)
        want = ck.decode_points_plain(w_in, n_in, blk.window)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"decode kernel differs from its plain version at "
              f"{list(w_in.shape)}")
        r = kernel_times(lambda: ck.decode_points(w_in, n_in, blk.window), 50)
        print(f"storage decode kernel at {list(w_in.shape)}, window "
              f"{blk.window}: {times_text(r)}")
    r = kernel_times(lambda: ck.pack_chunks(*chunks, mw), 20)
    print(f"storage pack kernel at [{sp}, {chunks[0].shape[1]}] slots: "
          f"{times_text(r)}")
    phase(f"storage kernels: pack at [{sp}, {chunks[0].shape[1]}] slots and "
          f"decode at {list(words.shape)} and [1, {mw}] equal their plain "
          f"versions; the seal's words equal the plain pack")


def _check_sealed_planes(db) -> None:
    """read_all of every sealed block, through the cache and bypassing it,
    equals the written planes bit for bit."""
    from m3_tpu_torch.storage import block_cache

    t0 = (1_700_000_000 * 10**9 // BLOCK_NS) * BLOCK_NS
    step_ns = BLOCK_NS // STORE_PPB
    vals_by_step = np.random.default_rng(STORE_SEED).standard_normal(
        (2 * STORE_PPB,))
    n_blocks = 0
    for shard, bs, blk in _sealed_blocks(db):
        k = (bs - t0) // BLOCK_NS
        want_t = bs + np.arange(STORE_PPB, dtype=np.int64) * step_ns
        want_v = vals_by_step[k * STORE_PPB:(k + 1) * STORE_PPB]
        for cached in (True, False):
            if cached:
                ts, vals, npts = blk.read_all()
            else:
                with block_cache.disabled():
                    ts, vals, npts = blk.read_all()
            check(bool((npts == STORE_PPB).all()), "npoints differ")
            check(bool((ts[:, :STORE_PPB] == want_t).all()),
                  f"block {bs} of shard {shard.shard_id}: timestamps differ")
            check(bool((vals[:, :STORE_PPB].view(np.uint64)
                        == want_v.view(np.uint64)).all()),
                  f"block {bs} of shard {shard.shard_id}: values differ")
        n_blocks += 1
    phase(f"storage (a): read_all of all {n_blocks} blocks equals the written "
          f"planes bit for bit, cached and bypassed")


def _stored_promql(corpus, plan_corpus, gauges, t, card_out) -> dict:
    """Phase 7 (b): the three query corpora written with tags into a
    16-shard Database with the namespace index, sealed, and
    STORED_QUERIES through Engine(LocalStorage(db)) on the card, held
    against phase 6's Engine(DictStorage) answers.
    Returns the kernels' launches."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.storage import LocalStorage
    from m3_tpu_torch.storage import block_cache
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.testing import write_corpus

    now = {"t": int(t[0])}
    db = Database(ShardSet(num_shards=16), clock=lambda: now["t"])
    db.ensure_namespace(b"default")
    w0 = time.perf_counter()
    calls = 0
    for series in (corpus, plan_corpus, gauges):
        calls += write_corpus(db, b"default", series, t, now)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - w0
    points = (len(corpus) + len(plan_corpus) + len(gauges)) * len(t)
    now["t"] = int(t[-1]) - int(t[-1]) % BLOCK_NS + BLOCK_NS + 11 * MINUTE_NS
    s0 = time.perf_counter()
    sealed = db.tick()["sealed"]
    torch.cuda.synchronize()
    print(f"storage (b) write: {calls} tagged write_batch calls, {points} "
          f"points in {write_s:.3f}s host clock ({points / write_s:.1f} "
          f"datapoints/s); seal of {sealed} blocks in "
          f"{time.perf_counter() - s0:.3f}s")
    check(sealed == 16, f"tick sealed {sealed} blocks, expected 16")
    storage = LocalStorage(db, b"default")
    card = Engine(storage)
    start, end = int(t[30]), int(t[-1])
    q0 = time.perf_counter()
    out = _default_route_run(lambda q: card, start, end, "storage (b)",
                             STORED_QUERIES)
    query_s = time.perf_counter() - q0
    launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
    phase(f"storage (b): {len(out)} queries over LocalStorage on the card "
          f"in {query_s:.3f}s, launches {launches}; block cache "
          f"{block_cache.get_cache().stats()}")
    check(launches["window"] > 0, "the window kernel did not launch")
    for q in STORED_QUERIES:
        blk, secs = out[q]
        ref = card_out[q][0]
        _check_query(q, blk, ref, "LocalStorage against DictStorage")
        got, exp = np.asarray(blk.values), np.asarray(ref.values)
        print(f"stored query {q!r}: {got.shape}, card {secs:.4f}s, DictStorage "
              f"card {card_out[q][1]:.4f}s, identical "
              f"{bool(np.array_equal(got, exp, equal_nan=True))}")
    phase("storage (b): every query over LocalStorage equals the DictStorage "
          "answer")
    ref_out = _against_interpreter(lambda q: card, out, start, end,
                                   "storage (b)")
    _fetch_split(db, t)
    _breakdown(card, storage, t, ref_out, " LocalStorage")
    with _instrumented(QUERY_STEPS) as pair:
        for q in ("rate(bench_metric[5m])", "sum_over_time(bench_metric[5m])"):
            card.execute_range(q, start, end, STEP_NS).values
    print(f"pair through Engine.execute_range LocalStorage, traced: "
          f"{pair['wall'] * 1e3:.3f} ms; {_split_text(pair)}")
    _check_replays("storage (b)")
    db.close()
    return launches


def _fetch_split(db, t) -> None:
    """Host clock of one bench_metric fetch through LocalStorage, split
    into the index query and the per-series shard reads (block cache
    hits once the blocks are admitted)."""
    from m3_tpu_torch.query import promql
    from m3_tpu_torch.query.model import matchers_to_index_query
    from m3_tpu_torch.storage import block_cache

    start, end = int(t[30]), int(t[-1])
    lo = start - 10 * STEP_NS
    sel = promql.parse("rate(bench_metric[5m])").args[0]
    cache = block_cache.get_cache()
    before = cache.stats()
    f0 = time.perf_counter()
    ids = db.query_ids(b"default", matchers_to_index_query(
        promql.selector_matchers(sel)), lo, end + 1)
    f1 = time.perf_counter()
    ns = db.namespace(b"default")
    for sid in ids:
        ns.shards[db.shard_set.lookup(sid)].read(sid, lo, end + 1)
    f2 = time.perf_counter()
    after = cache.stats()
    print(f"LocalStorage fetch of bench_metric: index query {len(ids)} ids "
          f"{(f1 - f0) * 1e3:.3f} ms, {len(ids)} shard reads "
          f"{(f2 - f1) * 1e3:.3f} ms ({(f2 - f1) / max(1, len(ids)) * 1e6:.2f} "
          f"us each); cache hits +{after['hits'] - before['hits']}, misses "
          f"+{after['misses'] - before['misses']}, admissions "
          f"+{after['admitted'] - before['admitted']}")


# bench_flush_merge's shard (BASELINE config #5): two half-blocks of 60
# points per series, seed 17; CPU samples of each merge strategy.
FLUSH_SERIES, FLUSH_HALF, FLUSH_SEED = 100_000, 60, 17
FLUSH_SAMPLE, FLUSH_ITERS = 2_000, 5
# The guard campaign: rows of its card inputs, its plan's seed and rates,
# rounds over the five routes.
GUARD_ROWS, GUARD_SEED, GUARD_ROUNDS = 2_048, 23, 16
GUARD_RATES = dict(compile_fail=0.1, dispatch_raise=0.15, oom=0.1,
                   delay=0.1, corrupt=0.15, delay_s=0.3)
GUARD_TIMEOUT_S, GUARD_COOLDOWN_S = 0.25, 1000.0
GUARD_OVERHEAD_CALLS = 20_000


def _flush_phase(pairs) -> dict:
    """Phase 8 (a) and (b). Returns each kernel's launches over the two
    merge paths (the counts set to 0 before each and read after)."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    launches = dict.fromkeys(REPLACES, 0)
    for path in (_flush_merge, lambda: _merge_stored(pairs)):
        ck.reset_launch_counts()
        wk.window_stat.launches = 0
        torch.cuda.synchronize()
        counts = dict(path(), window=wk.window_stat.launches)
        for name, n in counts.items():
            launches[name] += n
    check(launches["pack"] > 0 and launches["decode"] > 0,
          f"a kernel of the flush path did not launch: {launches}")
    return launches


def _half_inputs(full, raw_ts, lo, half):
    """bench_flush_merge's half-block encode inputs: one column range of
    the full block's prepared inputs (so both halves keep the full
    block's encoding epoch), its first delta zeroed."""
    n = raw_ts.shape[0]
    dt = full["dt"][:, lo:lo + half].copy()
    dt[:, 0] = 0
    return dict(dt=dt, t0=raw_ts[:, lo].copy(), v=full["v"][:, lo:lo + half],
                int_mode=full["int_mode"], k=full["k"],
                npoints=np.full(n, half, np.int32),
                ts_regular=(dt[:, 1:] == dt[:, 1:2]).all(axis=1),
                delta0=dt[:, 1].copy())


def _flush_merge() -> dict:
    """Phase 8 (a): bench_flush_merge on the card through the entry
    points (seal both halves, merge_adjacent, decode), then its checks and
    the timing split. Returns the main path's launches."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import tsz, tsz_concat
    from m3_tpu_torch.parallel import ingest

    dev = torch.device("cuda")
    n, half = FLUSH_SERIES, FLUSH_HALF
    w = 2 * half
    raw_ts, raw_vals, npoints = ingest.make_example_raw(
        n, w, np.random.default_rng(FLUSH_SEED))
    full = tsz.prepare_encode_inputs(raw_ts, raw_vals, npoints)
    h1 = _half_inputs(full, raw_ts, 0, half)
    h2 = _half_inputs(full, raw_ts, half, half)
    meta = tsz.boundary_metadata(h1)
    mw_half, mw_full = tsz.max_words_for(half), tsz.max_words_for(w)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    last_v = put(meta["last_v_bits"].view(np.int64))
    last_vd = put(meta["last_vdelta_bits"].view(np.int64))
    boundary = put((raw_ts[:, half] - raw_ts[:, half - 1]).astype(np.int32))
    npts_half = torch.full((n,), half, dtype=torch.int32, device=dev)
    kw = dict(half_window=half, max_words=mw_full)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    steps = [time.perf_counter()]
    w1, nb1 = tsz.encode_prepared(h1, mw_half, device=dev)
    w2, nb2 = tsz.encode_prepared(h2, mw_half, device=dev)
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    args = (w1, nb1, npts_half, w2, nb2, npts_half, boundary, last_v, last_vd)
    merged, mnb = tsz_concat.merge_adjacent(*args, **kw)
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    dts, dvals = tsz.decode(merged, torch.full_like(npts_half, w), w,
                            device=dev)
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    launches = ck.launch_counts()
    seal_s, merge_s, decode_s = np.diff(steps)
    phase(f"flush (a): {n} series x {w} points: seal of both halves "
          f"{seal_s:.3f}s, merge_adjacent {merge_s:.3f}s, decode "
          f"{decode_s:.3f}s host clock (first calls), launches {launches}")
    check(torch.equal(dts.cpu(), torch.from_numpy(raw_ts)),
          "flush: merged timestamps differ from the raw block")
    check(torch.equal(dvals.cpu().view(torch.int64),
                      torch.from_numpy(raw_vals.view(np.int64))),
          "flush: merged values differ from the raw block bit for bit")
    del dts, dvals
    # K1 at the half-block seal's shape and K2 at the merged block's,
    # each against its plain version on the same inputs (launched after
    # the path's counts were read: these do not count).
    chunks = tsz.encode_chunks(**{k: h1[k] for k in ENCODE_KEYS},
                               device=dev)
    got = ck.pack_chunks(*chunks, mw_half)
    check(torch.equal(got, ck.pack_chunks_plain(*chunks, mw_half))
          and torch.equal(got, w1), "flush: pack kernel differs from its "
          "plain version at the half-block seal's shape")
    npts_full = torch.full_like(npts_half, w)
    got = ck.decode_points(merged, npts_full, w)
    want = ck.decode_points_plain(merged, npts_full, w)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"flush: decode kernel differs from its plain version at "
          f"{list(merged.shape)}, window {w}")
    del chunks, got, want
    phase(f"flush (a): pack at [{n}, {2 * half}] slots (the half-block "
          f"seal) and decode at {list(merged.shape)}, window {w}, equal "
          f"their plain versions bit for bit")

    hd1, hd2 = tsz_concat.parse_header(w1), tsz_concat.parse_header(w2)
    ok = tsz_concat.concat_eligible(hd1, hd2, npts_half, npts_half,
                                    boundary).cpu().numpy()
    fast, slow = np.flatnonzero(ok), np.flatnonzero(~ok)
    check(fast.size > 0 and slow.size > 0, f"flush: eligible {fast.size}/{n}")
    ref_w, ref_nb = tsz.encode_prepared(full, mw_full, device=dev)
    int_fast = torch.from_numpy(fast[full["int_mode"][fast]]).to(dev)
    check(int_fast.numel() > 0, "flush: no int-mode concat rows")
    check(torch.equal(merged[int_fast], ref_w[int_fast])
          and torch.equal(mnb[int_fast], ref_nb[int_fast]),
          "flush: int-mode concat rows differ from a direct encode of the "
          "full window")
    del ref_w, ref_nb
    rng = np.random.default_rng(FLUSH_SEED)
    for strategy, rows in (("concat", fast), ("recode", slow)):
        pick = np.sort(rng.choice(rows, min(FLUSH_SAMPLE, rows.size),
                                  replace=False))
        idx = torch.from_numpy(pick).to(dev)
        cw, cnb = tsz_concat.merge_adjacent(
            *(a[idx].cpu() for a in args), strategy=strategy, device="cpu",
            **kw)
        check(torch.equal(merged[idx].cpu(), cw)
              and torch.equal(mnb[idx].cpu(), cnb),
              f"flush: the card's {strategy} rows differ from the CPU's")
    phase(f"flush (a): every series decodes to the raw points; "
          f"{int_fast.numel()} int-mode concat rows equal a direct encode; "
          f"{min(FLUSH_SAMPLE, fast.size)} concat and "
          f"{min(FLUSH_SAMPLE, slow.size)} recode rows equal the CPU's")

    fast_t = torch.from_numpy(fast).to(dev)
    slow_t = torch.from_numpy(slow).to(dev)
    fa = [a[fast_t] for a in (w1, nb1, npts_half, w2, nb2, npts_half, last_v,
                              last_vd)]
    sa = [a[slow_t] for a in (w1, npts_half, w2, npts_half, boundary)]

    def partition():
        p1, p2 = tsz_concat.parse_header(w1), tsz_concat.parse_header(w2)
        e = tsz_concat.concat_eligible(p1, p2, npts_half, npts_half,
                                       boundary).cpu()
        return torch.nonzero(e)

    merge_ms = cuda_ms(lambda: tsz_concat.merge_adjacent(*args, **kw),
                       FLUSH_ITERS)
    concat_ms = cuda_ms(lambda: tsz_concat.concat_regular_batch(
        *fa, max_words=mw_full), FLUSH_ITERS)
    recode_ms = cuda_ms(lambda: tsz_concat._merge_by_recode(
        *sa, half_window=half, max_words=mw_full), FLUSH_ITERS)
    partition_ms = cuda_ms(partition, FLUSH_ITERS)
    tail = torch.nn.functional.pad(fa[3].to(torch.int64) & 0xFFFFFFFF,
                                   (0, mw_full - mw_half))
    shift = torch.randint(0, 32 * mw_half, (fast.size,), device=dev)
    place_ms = cuda_ms(lambda: tsz_concat._place_at(tail, shift, mw_full + 8),
                       FLUSH_ITERS)
    with _instrumented(MERGE_STEPS) as prof:
        tsz_concat.merge_adjacent(*args, **kw)
    print(f"flush merge, one merge_adjacent traced: {prof['wall'] * 1e3!r} "
          f"ms host clock; {_split_text(prof)}")
    # The concat's least time: both half-blocks' words, nbits, npoints
    # and metadata read once, the merged words and nbits written once.
    concat_bytes = fast.size * (2 * mw_half * 4 + 4 * 4 + 2 * 8
                                + mw_full * 4 + 4)
    print(f"flush merge: eligible {fast.size}/{n} "
          f"({fast.size / n!r}); merge_adjacent {merge_ms!r} ms "
          f"({n * w / (merge_ms / 1e3)!r} datapoints/s): concat of "
          f"{fast.size} rows {concat_ms!r} ms (bytes bound "
          f"{concat_bytes / HBM_BYTES_PER_S * 1e3!r} ms), recode of "
          f"{slow.size} rows "
          f"{recode_ms!r} ms, host partition (two header parses, "
          f"eligibility, D2H) {partition_ms!r} ms; one _place_at (gather "
          f"form) over [{fast.size}, {mw_full + 8}] {place_ms!r} ms; CUDA "
          f"events, {FLUSH_ITERS} calls each")
    return launches


def _merge_stored(pairs) -> dict:
    """Phase 8 (b): each shard's two sealed blocks of phase 7 (a) merged
    by merge_sealed_blocks on the card, then read back through read_all
    (the decode kernel at window 256). Returns the path's launches."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import tsz_concat
    from m3_tpu_torch.storage.block import merge_sealed_blocks

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    secs = []
    with _instrumented(MERGE_STEPS) as prof:
        merged = []
        for b1, b2 in pairs:
            m0 = time.perf_counter()
            merged.append(merge_sealed_blocks(b1, b2))
            secs.append(time.perf_counter() - m0)
    r0 = time.perf_counter()
    reads = [m.read_all() for m in merged]
    torch.cuda.synchronize()
    read_s = time.perf_counter() - r0
    launches = ck.launch_counts()
    eligible = []
    for b1, b2 in pairs:
        h1 = tsz_concat.parse_header(b1.words, device=b1.device)
        h2 = tsz_concat.parse_header(b2.words, device=b1.device)
        gap = (h2["t0"].cpu().numpy()
               - b1.boundary["last_ticks"]).astype(np.int32)
        eligible.append(int(tsz_concat.concat_eligible(
            h1, h2, b1.npoints, b2.npoints, gap).sum()))
    print(f"storage merge: {len(pairs)} merges of [{pairs[0][0].num_series}, "
          f"{pairs[0][0].words.shape[1]}] + [{pairs[0][1].num_series}, "
          f"{pairs[0][1].words.shape[1]}] words to window "
          f"{merged[0].window}, [{merged[0].num_series}, "
          f"{merged[0].words.shape[1]}]: {[round(x * 1e3, 3) for x in secs]} "
          f"ms each (host clock, ends in the D2H), mean "
          f"{float(np.mean(secs)) * 1e3!r} ms; concat rows {eligible}, recode rows "
          f"{[b1.num_series - e for (b1, _), e in zip(pairs, eligible)]}; "
          f"{_split_text(prof)}; read_all of the merged blocks "
          f"{read_s:.3f}s; launches {launches}")
    for (b1, b2), m, (tm, vm, nm) in zip(pairs, merged, reads):
        check(m.window == b1.window + b2.window == 256
              and m.words.shape[1] == 947, f"merged geometry {m.window}, "
              f"{m.words.shape}")
        check(bool((m.series_indices == b1.series_indices).all()
                   and (m.series_indices == b2.series_indices).all()),
              "merged series differ from the source blocks'")
        t1, v1, n1 = b1.read_all()
        t2, v2, n2 = b2.read_all()
        check(bool((nm == n1 + n2).all()), "merged npoints differ")
        j = np.arange(m.window)[None, :]
        from1 = j < n1[:, None]
        idx2 = np.clip(j - n1[:, None], 0, b2.window - 1)
        rows = np.arange(m.num_series)[:, None]
        live = j < (n1 + n2)[:, None]
        pad = ((0, 0), (0, m.window - b1.window))
        for got, a, b in ((tm, t1, t2), (vm.view(np.int64), v1.view(np.int64),
                                         v2.view(np.int64))):
            want = np.where(from1, np.pad(a, pad), b[rows, idx2])
            check(bool((got[live] == want[live]).all()),
                  f"merged block {m.block_start} reads back differently")
    # K2 at the merged block's read shape (rows padded to a power of two
    # as read_all pads them, window 256) against its plain version.
    m = merged[0]
    sp = 1 << (m.num_series - 1).bit_length()
    pad = np.arange(sp) % m.num_series
    words = torch.from_numpy(m.words[pad].view(np.int32)).cuda()
    npts = torch.from_numpy(m.npoints[pad].astype(np.int32)).cuda()
    got = ck.decode_points(words, npts, m.window)
    want = ck.decode_points_plain(words, npts, m.window)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"flush (b): decode kernel differs from its plain version at "
          f"{list(words.shape)}, window {m.window}")
    phase(f"flush (b): all {len(merged)} merged blocks read back equal to "
          f"their two source blocks, bit for bit; decode at "
          f"{list(words.shape)}, window {m.window}, equals its plain version")
    return launches


MERGE_STEPS = {
    "merge_adjacent": ("ops/tsz_concat.py", "merge_adjacent"),
    "of which header parses": ("ops/tsz_concat.py", "parse_header"),
    "of which concat enqueue": ("ops/tsz_concat.py", "concat_regular_batch"),
    "of which recode": ("ops/tsz_concat.py", "_merge_by_recode"),
    "of which recode's chunk build": ("ops/tsz.py", "encode_chunks"),
    "D2H (waits for the merge)": _D2H,
}


def _same(a, b) -> bool:
    """Bit equality of two results: tensors, arrays, tuples and dicts."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype and a.device
                == b.device and bool((a.cpu().numpy().tobytes()
                                      == b.cpu().numpy().tobytes())))
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _guard_phase() -> None:
    """Phase 8 (c): the compute-fault guard on the card."""
    import torch

    from m3_tpu_torch.ops import temporal, tsz
    from m3_tpu_torch.parallel import guard, ingest
    from m3_tpu_torch.storage import block as sblock
    from m3_tpu_torch.storage import block_cache
    from m3_tpu_torch.testing import faultcomp, prometheus_ids
    from m3_tpu_torch.utils import hashing
    from m3_tpu_torch.utils.retry import Breaker, BreakerOptions

    dev = torch.device("cuda")
    rng = np.random.default_rng(GUARD_SEED)
    n, w = GUARD_ROWS, W
    ts, vals, npts = ingest.make_example_raw(n, w, rng)
    prep = tsz.prepare_encode_inputs(ts, vals, npts)
    mw = tsz.max_words_for(w)
    words, _ = tsz.encode_prepared(prep, mw, device=dev)
    npts_t = torch.from_numpy(npts).to(dev)
    ids = prometheus_ids(n, rng)
    grid = np.cumsum(rng.poisson(5.0, (n, w)), axis=1).astype(np.float64)
    grid[rng.random(grid.shape) < 0.05] = np.nan
    blk = sblock.encode_block(0, np.arange(n, dtype=np.int32),
                              ts * 10**9, vals, npts, device=dev)

    def block_decode():
        with block_cache.disabled():
            return blk.read_all()

    calls = {
        "codec.encode": lambda: tsz.encode_prepared(prep, mw, device=dev),
        "codec.decode": lambda: tsz.decode_plane(words, npts_t, window=w,
                                                 device=dev),
        "codec.hash": lambda: hashing.hash_batch(ids, device=dev),
        "block.decode": block_decode,
        "temporal.over_time": lambda: temporal.over_time(grid, 10, "max",
                                                         device=dev),
    }
    clean = {route: call() for route, call in calls.items()}
    torch.cuda.synchronize()

    # What a clean dispatch adds to a call (no seam installed: the lock,
    # the breaker grant and settle, the telemetry counts), on the host
    # clock against the bare call of the same no-op primary.
    def noop():
        return None

    reps = GUARD_OVERHEAD_CALLS
    t0 = time.perf_counter()
    for _ in range(reps):
        noop()
    bare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        guard.dispatch("guard.overhead", noop)
    guarded_s = time.perf_counter() - t0
    print(f"guard: a clean dispatch adds {(guarded_s - bare_s) / reps * 1e6!r}"
          f" us host clock ({reps} dispatches of a no-op primary in "
          f"{guarded_s!r} s, bare calls {bare_s!r} s)")

    # The breakers' clock: the real one plus an offset the campaign moves
    # past the cooldown between rounds, so an open breaker half-opens at a
    # round boundary whatever the card's speed; the timeout stays real.
    offset = [0.0]
    clock = lambda: time.monotonic() + offset[0]  # noqa: E731
    opts = BreakerOptions(window=8, failure_ratio=0.5, min_samples=4,
                          cooldown_s=GUARD_COOLDOWN_S)
    guard.reset()
    for route in calls:
        guard.configure(route, opts=opts, clock=clock,
                        timeout_s=GUARD_TIMEOUT_S)
    plan = faultcomp.ComputeFaultPlan(seed=GUARD_SEED, **GUARD_RATES)
    outcomes = {route: {"exact": 0} for route in calls}
    g0 = time.perf_counter()
    with faultcomp.injected(plan) as seam:
        for _ in range(GUARD_ROUNDS):
            for route, call in calls.items():
                # Every outcome must be the one the decisions drawn during
                # the call imply: a real fault of the card would be a raise
                # the schedule does not explain.
                mark = seam.mark()
                try:
                    out = call()
                except guard.ComputeError as err:
                    bad = faultcomp.unexplained(seam.since(mark), err)
                    check(bad is None, f"guard: {route}: {bad}")
                    key = ("BreakerOpen" if err.detail == "breaker open"
                           else type(err).__name__)
                    outcomes[route][key] = outcomes[route].get(key, 0) + 1
                    continue
                torch.cuda.synchronize()
                bad = faultcomp.unexplained(seam.since(mark), None)
                check(bad is None, f"guard: {route}: {bad}")
                check(_same(out, clean[route]),
                      f"guard: {route} returned a corrupted answer")
                outcomes[route]["exact"] += 1
            offset[0] += GUARD_COOLDOWN_S + 1
    kinds = {}
    for decisions in seam.decisions.values():
        for d in decisions:
            kinds[d] = kinds.get(d, 0) + 1
    print(f"guard campaign: {GUARD_ROUNDS} rounds over {sorted(calls)} in "
          f"{time.perf_counter() - g0:.3f}s; injected {kinds}; outcomes "
          f"{outcomes}")
    check(all(kinds.get(k, 0) > 0 for k in (
        "compile_fail", "dispatch_raise", "oom", "delay", "corrupt")),
        f"guard: the campaign did not inject every kind: {kinds}")
    check(all(o["exact"] > 0 and len(o) > 1 for o in outcomes.values()),
          f"guard: a route never answered or never raised: {outcomes}")
    snap = guard.debug_snapshot()
    for route in sorted(snap):
        print(f"guard route {route}: {snap[route]}")

    # A breaker trip: dispatches raise at once (the seam sees none of
    # them), and after the cooldown the half-open probe closes it again.
    guard.configure("codec.decode", opts=opts, clock=clock)
    with faultcomp.injected(faultcomp.ComputeFaultPlan(
            seed=GUARD_SEED, dispatch_raise=1.0)) as seam:
        for _ in range(opts.min_samples):
            try:
                calls["codec.decode"]()
                check(False, "guard: an injected fault returned")
            except guard.KernelFault:
                pass
    check(guard.debug_snapshot()["codec.decode"]["state"] == Breaker.OPEN,
          "guard: the breaker did not trip")
    with faultcomp.injected(faultcomp.ComputeFaultPlan(seed=0)) as benign:
        try:
            calls["codec.decode"]()
            check(False, "guard: an open breaker let a dispatch through")
        except guard.ComputeError as err:
            check("breaker open" in str(err), f"guard: {err}")
        check(not benign.decisions, "guard: an open breaker reached the seam")
        offset[0] += GUARD_COOLDOWN_S + 1
        check(_same(calls["codec.decode"](), clean["codec.decode"]),
              "guard: the half-open probe's answer differs")
    check(guard.debug_snapshot()["codec.decode"]["state"]
          == Breaker.CLOSED,
          "guard: the half-open probe did not close the breaker")
    phase(f"guard (c): campaign exact-or-typed on {len(calls)} routes; "
          f"breaker tripped after {len(seam.decisions['codec.decode'])} "
          f"faults, raised at once while open, closed by the half-open probe")
    _real_oom(words, npts_t, w, clean["codec.decode"])
    guard.reset()


def _real_oom(words, npts, w, want) -> None:
    """One real CUDA out-of-memory error inside a guarded primary: a
    ballast tensor fills all but 2 GiB of the card's free memory, charged
    to no ledger (a budget tenant reporting 0 bytes, so reclaim() frees
    nothing), and the primary asks for 4 GiB of scratch before it
    decodes. The guard must type the error DeviceOOM, free the ballast
    through reclaim_pass, and retry once to the exact answer."""
    import torch

    from m3_tpu_torch.ops import tsz
    from m3_tpu_torch.parallel import guard
    from m3_tpu_torch.utils import hbm
    from m3_tpu_torch.utils.instrument import ROOT

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    ballast = {"t": torch.empty(free - (2 << 30), dtype=torch.uint8,
                                device="cuda")}

    def evict():
        t = ballast.pop("t", None)
        if t is None:
            return 0
        n = t.numel()
        del t
        torch.cuda.empty_cache()
        return n

    budget = hbm.shared_budget()
    passes = []
    real_pass = budget.reclaim_pass

    def counted_pass():
        passes.append(1)
        return real_pass()

    budget.reclaim_pass = counted_pass
    budget.register("chip-smoke-ballast", lambda: 0, evict)
    attempts = []

    def primary():
        attempts.append(1)
        scratch = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")
        out = tsz.decode_plane(words, npts, window=w, device=words.device)
        del scratch
        return out

    before = ROOT.snapshot()
    try:
        guard.configure("block.decode")
        got = guard.dispatch("block.decode", primary)
        torch.cuda.synchronize()
    finally:
        budget.unregister("chip-smoke-ballast")
        del budget.reclaim_pass
        ballast.clear()
    after = ROOT.snapshot()
    oom_key = "telemetry.compute.faults{kind=oom,route=block.decode}"
    reclaims = "telemetry.compute.oom_reclaims{route=block.decode}"
    freed = (after.get("telemetry.compute.oom_reclaimed_bytes", 0)
             - before.get("telemetry.compute.oom_reclaimed_bytes", 0))
    check(len(attempts) == 2 and len(passes) == 1
          and after.get(oom_key, 0) - before.get(oom_key, 0) == 1
          and after.get(reclaims, 0) - before.get(reclaims, 0) == 1,
          f"guard: the real OOM was not reclaimed and retried once "
          f"(attempts {len(attempts)}, passes {len(passes)})")
    check(_same(got, want), "guard: the retried decode's answer differs")
    phase(f"guard (c): a real CUDA out-of-memory error ({free} bytes free, "
          f"ballast of {free - (2 << 30)}) typed DeviceOOM, reclaim_pass "
          f"freed {freed} bytes, the retry returned the exact answer")


# Phase 9: carbon series bench.host{0..199}.metric{0..49}, positive
# levels on the query corpora's 360-point 10 s grid (seed 29), and the
# render targets over them.
CARBON_HOSTS, CARBON_METRICS, CARBON_SEED = 200, 50, 29
GRAPHITE_TARGETS = (
    "movingAverage(bench.host*.metric0, '5min')",
    "movingSum(bench.host*.metric0, '5min')",
    "movingMax(bench.host*.metric0, '5min')",
    "movingMin(bench.host*.metric0, '5min')",
    "movingMedian(bench.host*.metric0, '5min')",
    "stdev(bench.host*.metric0, 30)",
    "sumSeries(bench.*.metric*)",
    "groupByNode(bench.*.metric1, 1, 'sum')",
    "perSecond(bench.host*.metric0)",
    "summarize(bench.host*.metric0, '1min', 'sum')",
    "highestCurrent(bench.host*.metric0, 5)",
)
# The window kernel's launches: one per moving{Average,Sum,Max,Min}, two
# for stdev (its stddev and count passes); movingMedian sorts instead.
GRAPHITE_WINDOW_LAUNCHES = 6
PLACEMENT_RUNS = 20


def _carbon_corpus(t) -> dict:
    """{path: {tags, t, v}}: CARBON_HOSTS x CARBON_METRICS carbon series
    (tags from metrics.carbon.path_to_tags), each a positive level
    exp(normal(3, 1)) drifting by a 1% log random walk."""
    from m3_tpu_torch.metrics import carbon

    rng = np.random.default_rng(CARBON_SEED)
    n = CARBON_HOSTS * CARBON_METRICS
    vals = np.exp(rng.normal(3.0, 1.0, (n, 1))
                  + np.cumsum(rng.normal(0.0, 0.01, (n, len(t))), axis=1))
    out = {}
    for i in range(n):
        path = b"bench.host%d.metric%d" % (i // CARBON_METRICS,
                                           i % CARBON_METRICS)
        out[path] = {"tags": carbon.path_to_tags(path), "t": t, "v": vals[i]}
    return out


def _graphite_phase(t) -> dict:
    """Phase 9 (a): the carbon corpus written through a 16-shard Database
    with the namespace index (the hash kernel once a write_batch) and
    sealed (the pack kernel once a block), then GRAPHITE_TARGETS rendered
    through GraphiteEngine(LocalStorage(db)) on the card (cold reads
    decode through the decode kernel; moving* and stdev run the window
    kernel) and held against device="cpu" renders over the same store:
    same names and order, same NaN cells, rtol 1e-5, atol 1e-8. Returns
    the kernels' launches over the write, the seal and the card renders."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.query.graphite import GraphiteEngine, series_name
    from m3_tpu_torch.query.storage import LocalStorage
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.testing import write_corpus

    series = _carbon_corpus(t)
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    now = {"t": int(t[0])}
    db = Database(ShardSet(num_shards=16), clock=lambda: now["t"])
    db.ensure_namespace(b"default")
    w0 = time.perf_counter()
    calls = write_corpus(db, b"default", series, t, now)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - w0
    now["t"] = int(t[-1]) - int(t[-1]) % BLOCK_NS + BLOCK_NS + 11 * MINUTE_NS
    s0 = time.perf_counter()
    sealed = db.tick()["sealed"]
    torch.cuda.synchronize()
    points = len(series) * len(t)
    print(f"graphite store: {len(series)} carbon series, {calls} write_batch "
          f"calls, {points} points in {write_s:.3f}s host clock "
          f"({points / write_s:.1f} datapoints/s); seal of {sealed} blocks "
          f"in {time.perf_counter() - s0:.3f}s")
    check(sealed == 16, f"tick sealed {sealed} blocks, expected 16")
    storage = LocalStorage(db, b"default")
    card = GraphiteEngine(storage)
    cpu = GraphiteEngine(storage, device="cpu")
    start, end = int(t[60]), int(t[-1])
    out = {}
    r0 = time.perf_counter()
    for target in GRAPHITE_TARGETS:
        tq = time.perf_counter()
        blk = card.render(target, start, end)
        torch.cuda.synchronize()
        out[target] = (blk, time.perf_counter() - tq)
    render_s = time.perf_counter() - r0
    launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
    phase(f"graphite: {len(GRAPHITE_TARGETS)} renders over LocalStorage on "
          f"the card in {render_s:.3f}s, launches {launches}")
    check(launches["hash"] == calls, f"hash kernel launched "
          f"{launches['hash']} times for {calls} write_batch calls")
    check(launches["pack"] == sealed, f"pack kernel launched "
          f"{launches['pack']} times for {sealed} seals")
    check(launches["decode"] > 0, "the decode kernel did not launch")
    check(launches["window"] == GRAPHITE_WINDOW_LAUNCHES, f"window kernel "
          f"launched {launches['window']} times, expected "
          f"{GRAPHITE_WINDOW_LAUNCHES}")
    for target in GRAPHITE_TARGETS:
        blk, secs = out[target]
        tq = time.perf_counter()
        ref = cpu.render(target, start, end)
        cpu_s = time.perf_counter() - tq
        got, exp = np.asarray(blk.values), np.asarray(ref.values)
        check([series_name(x) for x in blk.series_tags]
              == [series_name(x) for x in ref.series_tags],
              f"{target}: names differ")
        check(got.shape == exp.shape and bool(
            (np.isnan(got) == np.isnan(exp)).all()),
            f"{target}: NaN cells differ")
        check(bool(np.allclose(got, exp, rtol=1e-5, atol=1e-8,
                               equal_nan=True)), f"{target}: values differ")
        print(f"graphite {target!r}: {got.shape}, card {secs:.4f}s, cpu "
              f"{cpu_s:.4f}s, identical "
              f"{bool(np.array_equal(got, exp, equal_nan=True))}")
    phase("graphite: every render on the card equals its device=\"cpu\" "
          "render")
    db.close()
    return launches


def _placement_phase(corpus, t) -> None:
    """Phase 9 (b): the opt-in placement model (the reference's "auto")
    on the card: the
    probe's RTT and D2H bandwidth, choose() at four grid sizes (a result
    plane of cells / 447 series x 110 steps of f32, bench_promql's shape),
    and the decisions over PLACEMENT_RUNS repeat rate evaluations at
    bench_promql's shape, with the model after each 5, through
    execute_range_ref (the compiled route ignores placement, so the
    default route would place nothing). A host-served answer must equal
    the device="cpu" interpreter's, a card-served one the card
    interpreter's."""
    import torch

    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.placement import QueryPlacement
    from m3_tpu_torch.testing import DictStorage

    probe = QueryPlacement("cuda")
    probe._probe_link()
    snap = probe.snapshot()
    print(f"placement probe: rtt {snap['rtt_ms']!r} ms, D2H "
          f"{snap['d2h_bw_mb_s']!r} MiB/s")
    for cells in (10**2, 10**4, 10**6, 4_470_000):
        result = max(1, cells // 447) * 110 * 4
        side = "host" if probe.choose(cells, result) is not None else "device"
        print(f"placement choose({cells} cells, {result} result bytes): "
              f"{side}")
    q = "rate(bench_metric[5m])"
    start, end = int(t[30]), int(t[-1])
    storage = DictStorage(corpus)
    eng = Engine(storage, placement=QueryPlacement("cuda"))
    host_want = Engine(storage, device="cpu").execute_range_ref(
        q, start, end, STEP_NS).values
    card_want = Engine(storage).execute_range_ref(
        q, start, end, STEP_NS).values
    sides = []
    for i in range(PLACEMENT_RUNS):
        before = eng.placement_snapshot()["placed_host"]
        t0 = time.perf_counter()
        got = eng.execute_range_ref(q, start, end, STEP_NS).values
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        side = ("host" if eng.placement_snapshot()["placed_host"] > before
                else "device")
        sides.append(side)
        want = host_want if side == "host" else card_want
        check(bool(np.array_equal(got, want, equal_nan=True)),
              f"placement run {i + 1} ({side}) differs from the {side} "
              f"answer")
        print(f"placement run {i + 1}: {side}, {ms:.3f} ms")
        if (i + 1) % 5 == 0:
            print(f"placement model after {i + 1}: "
                  f"{eng.placement_snapshot()}")
    phase(f"placement: {PLACEMENT_RUNS} rate evaluations under the model "
          f"served by {sides}; each equals the answer of the side that "
          f"served it")


def _plan_phase(plan_corpus, t) -> dict:
    """Phase 10: the compiled plan at bench_promql_plan_agg's shape
    (bench.py:370-455): 10,000 bench_requests counters over 200 hosts, 360
    points at 10 s (seed 17), `sum by (host) (rate(bench_requests[5m]))`
    from t[30] to t[-1] at step 30 s. From an empty plan cache (phases 6
    and 7 (b) print their executables, _check_replays): one
    miss (the warm-up and the capture), PLAN_RUNS warm replays and
    PLAN_RUNS interpreter runs on the same engine, a cProfile split of one
    replayed query, and the checks: 200 series, within rtol 1e-5, atol
    1e-8 of execute_range_ref (the bench's own assertion) and of the CPU
    plan route. Returns the kernels' launches during the compiled runs."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel import compile as pcompile
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.testing import DictStorage
    from m3_tpu_torch.utils import hbm

    pcompile.clear()
    torch.cuda.empty_cache()
    budget = hbm.shared_budget()

    q = PLAN_AGG_QUERY
    start, end = int(t[30]), int(t[-1])
    storage = DictStorage(plan_corpus)
    eng = Engine(storage)
    points = len(plan_corpus) * len(t)
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.execute_range(q, start, end, STEP_NS)
    first.values
    torch.cuda.synchronize()
    miss_ms = (time.perf_counter() - t0) * 1e3
    check(eng.last_route()["route"] == "compiled",
          f"{q}: took {eng.last_route()}")
    ((key, exe),) = pcompile.executables()
    print(f"plan miss: {miss_ms!r} ms host clock (of it the executable's "
          f"warm-up + capture + first replay {exe.build_s * 1e3!r} ms); pool "
          f"{exe.pool_bytes} bytes, static inputs {exe.input_bytes} bytes, "
          f"charged to the plan tenant {exe.charged} bytes; warm-up growth "
          f"{exe.warmup_bytes} bytes; {key}")
    runs = []
    for _ in range(PLAN_RUNS):
        t0 = time.perf_counter()
        out = eng.execute_range(q, start, end, STEP_NS)
        out.values
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
    med = float(np.median(runs))
    print(f"plan replays: median of {PLAN_RUNS} {med!r} ms, "
          f"{points / (med / 1e3)!r} datapoints/s ({points} points); runs "
          f"{runs}; graph window launches a replay {exe.k4_launches}, "
          f"replays {exe.replays}; launches {launches}")
    check(exe.graph is not None and exe.replays == PLAN_RUNS + 1,
          f"replays {exe.replays}")
    interp = []
    for _ in range(PLAN_RUNS):
        t0 = time.perf_counter()
        ref = eng.execute_range_ref(q, start, end, STEP_NS)
        ref.values
        torch.cuda.synchronize()
        interp.append((time.perf_counter() - t0) * 1e3)
    imed = float(np.median(interp))
    print(f"plan interpreter on the same engine: median of {PLAN_RUNS} "
          f"{imed!r} ms, {points / (imed / 1e3)!r} datapoints/s; runs "
          f"{interp}")
    check(out.n_series == Q_HOSTS, f"{out.n_series} series, expected "
          f"{Q_HOSTS}")
    order = {bytes(x.id()): i for i, x in enumerate(ref.series_tags)}
    got = np.asarray(out.values)
    want = np.asarray(ref.values)[[order[bytes(x.id())]
                                   for x in out.series_tags]]
    check(bool(np.allclose(got, want, rtol=1e-5, atol=1e-8, equal_nan=True)),
          "the compiled plan differs from execute_range_ref")
    check(bool(np.array_equal(got, np.asarray(first.values), equal_nan=True)),
          "a replay differs from the first run")
    cpu = Engine(storage, device="cpu").execute_range(q, start, end, STEP_NS)
    check([x.id() for x in cpu.series_tags] == [
        x.id() for x in out.series_tags], "CPU plan route: tags differ")
    check(bool(np.allclose(got, np.asarray(cpu.values), rtol=1e-5, atol=1e-8,
                           equal_nan=True)),
          "the card's plan differs from the CPU plan route")
    check(exe.replay_matches_eager(), "phase 10's replay differs from its "
          "eager body")
    rel = float(np.nanmax(np.abs(got - want) / np.maximum(np.abs(want),
                                                          1e-30)))
    with _instrumented(PLAN_STEPS) as one:
        eng.execute_range(q, start, end, STEP_NS).values
    print(f"plan query traced: {one['wall'] * 1e3:.3f} ms; "
          f"{_split_text(one)}")
    print(f"plan tenant after phase 10: {budget.usage().get('plan', 0)} "
          f"bytes; torch.cuda.memory_allocated() "
          f"{torch.cuda.memory_allocated()} bytes")
    phase(f"plan: {q} compiled on the card: {Q_HOSTS} series, max rel diff "
          f"to execute_range_ref {rel!r} (rtol 1e-5, atol 1e-8), equal to "
          f"the CPU plan route; replay median {med!r} ms against the "
          f"interpreter's {imed!r} ms")
    return launches


class _ColumnarSink:
    """A flush handler of the production shape (Handler.handle_columnar,
    bench.py _ColumnarCapture): a round's emissions arrive as columnar
    groups in ONE call; it keeps the values."""

    def __init__(self):
        self.values = []

    def __call__(self, mid, t, v, pol):
        self.values.append(v)

    def handle_columnar(self, groups):
        for _ids, _ts, vs, _pol in groups:
            self.values.extend(vs.tolist())


def _card(text: str) -> None:
    """Print one phase 11 number beside the card's name and power limit."""
    print(f"[{CARD_LINE}] {text}", flush=True)


def _aggregator_phase(plan_corpus, t) -> dict:
    """Phase 11: the aggregator tier and the standing rules engine on the
    card. (a) bench_counter_gauge's population (BASELINE config #2); (b)
    the agg_rollup_10x population, its 20,000-metric mirror against the
    CPU and reduce_and_emit_ref, the rank selection against its plain
    version at widths 128, 256 and 1024, a fault on the `agg_flush` route;
    (c) Aggregator end to end; (d) a RulesEngine over phase 10's corpus
    with its write-back into a Database. Returns the kernels' launches
    over the phase (the counts set to 0 just before it)."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _agg_counter_gauge()
    _agg_rollup_10x()
    _agg_end_to_end()
    _rules_phase(plan_corpus, t)
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
    phase(f"aggregator: phase 11 in {time.perf_counter() - t0:.1f}s, "
          f"launches {launches}")
    check(launches["window"] > 0 and launches["hash"] > 0,
          f"phase 11 did not launch the window and hash kernels: {launches}")
    return launches


def _median_rounds(stage, flush, rounds: int):
    """`rounds` timed flushes (stage() before each, untimed): the host
    clock of each, synchronised, in ms, with the full GC pauses inside."""
    import torch

    runs, gcs = [], []
    for _ in range(rounds):
        stage()
        torch.cuda.synchronize()
        with _gc_pauses() as pauses:
            t0 = time.perf_counter()
            flush()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        gcs.append(pauses)
    return runs, gcs


def _agg_counter_gauge() -> None:
    """(a) bench_counter_gauge (bench.py:507, BASELINE config #2): 50,000
    metrics (half counters, half gauges, seed 23) at 1m:40h and 5m:40h,
    5 minutes of 10 s values, flushed through MetricList.flush on the
    card with a columnar handler; a warm-up flush through the
    per-datapoint sink checks the windows and a counter's sum."""
    from m3_tpu_torch.testing import counter_gauge_population

    n = AGG_CG_SERIES
    t0 = time.perf_counter()
    lists, stage, target = counter_gauge_population(n)
    build_s = time.perf_counter() - t0
    emitted = []
    stage()
    w = [lists[60].flush(target, lambda m, t, v, p: emitted.append((m, t, v))),
         lists[300].flush(target, lambda m, t, v, p: emitted.append((m, t, v)))]
    check(w == [n * 5, n] and len(emitted) == n * 6,
          f"config #2 flushed {w} windows, {len(emitted)} rows")
    rng = np.random.default_rng(23)
    c0 = rng.poisson(5.0, (n // 2, 30)).astype(np.float64)[0]
    first = {(m, t): v for m, t, v in emitted}
    check(first[(b"bench.cg.0", 1_700_000_000 * 10**9 - (1_700_000_000 * 10**9)
                 % (60 * 10**9) + 60 * 10**9)] == float(c0[:6].sum()),
          "config #2: a counter window's sum differs")
    sink = _ColumnarSink()

    def flush():
        sink.values.clear()
        check(lists[60].flush(target, sink) + lists[300].flush(target, sink)
              == n * 6 and len(sink.values) == n * 6, "config #2 round")

    runs, gcs = _median_rounds(stage, flush, AGG_ROUNDS)
    med = float(np.median(runs))
    _card(f"aggregator (a) config #2 counter_gauge_rollup: {n} metrics x 2 "
          f"policies, build {build_s:.3f}s; {n * 6} windows a round, median "
          f"of {AGG_ROUNDS} {med!r} ms ({n * 30 * 2 / (med / 1e3)!r} "
          f"datapoints/s, {n * 6 / (med / 1e3)!r} windows/s); runs {runs}; "
          f"full GC pauses {gcs}")


def _agg_rollup_10x() -> None:
    """(b) bench_agg_rollup_10x (bench.py:652): _agg10x_build's 500,000
    metrics (40/40/20, 10% piped gauges into 500 rollup ids, seed 31), two
    1m windows of 6 values, the second-stage flush; the round's quantile
    tile, its rank selection's device time and its H2D/select/D2H split;
    a cProfile split of one round; then the 20,000-metric mirror (card
    against the CPU and against reduce_and_emit_ref, bit for bit), the
    rank selection against its plain version, and a fault."""
    import torch

    from m3_tpu_torch.aggregator import list as list_mod
    from m3_tpu_torch.aggregator.flush import plan_jobs
    from m3_tpu_torch.ops import aggregation as agg
    from m3_tpu_torch.parallel import agg_flush
    from m3_tpu_torch.testing import (AGG_BASE_NS, agg10x_build, agg10x_planes,
                                      agg10x_stage, loopback_forward)

    n = AGG_10X_SERIES
    t1, t2 = AGG_BASE_NS + 120 * 10**9, AGG_BASE_NS + 180 * 10**9
    t0 = time.perf_counter()
    lists, elems, n_piped, n_ids = agg10x_build(n)
    build_s = time.perf_counter() - t0
    planes = agg10x_planes(n)
    lst = lists.for_resolution(60 * 10**9)
    fwd = loopback_forward(lst)
    tiles = []
    rank_rows = agg_flush.quantile_rank_rows

    def recording(tile, counts, qs, device=None):
        tiles.append((tile.shape, tile.nbytes, qs))
        return rank_rows(tile, counts, qs, device)

    agg_flush.quantile_rank_rows = recording
    try:
        t0 = time.perf_counter()
        agg10x_stage(elems, planes)
        stage_s = time.perf_counter() - t0
        emitted = []
        cap = lambda m, t, v, p: emitted.append(v)  # noqa: E731
        w_a, w_b = lst.flush(t1, cap, fwd), lst.flush(t2, cap, fwd)
        check((w_a, w_b) == (n * 2, 2 * n_ids),
              f"agg10x flushed {w_a} + {w_b} windows")
        check(all(math.isfinite(v) for v in emitted), "agg10x: a value is "
              "not finite")
        sink = _ColumnarSink()

        def flush():
            sink.values.clear()
            check((lst.flush(t1, sink, fwd), lst.flush(t2, sink, fwd))
                  == (n * 2, 2 * n_ids), "agg10x round")

        runs, gcs = _median_rounds(lambda: agg10x_stage(elems, planes),
                                   flush, AGG_ROUNDS)
        agg10x_stage(elems, planes)
        with _instrumented(AGG_STEPS) as one:
            flush()
    finally:
        agg_flush.quantile_rank_rows = rank_rows
    med = float(np.median(runs))
    shape, nbytes, qs = tiles[-1]
    _card(f"aggregator (b) agg_rollup_10x: {n} metrics ({n_piped} piped "
          f"gauges into {n_ids} rollup ids), build {build_s:.3f}s, staging "
          f"{stage_s:.3f}s; round (both windows + second stage) median of "
          f"{AGG_ROUNDS} {med!r} ms ({n * 12 / (med / 1e3)!r} datapoints/s);"
          f" runs {runs}; full GC pauses {gcs}")
    _card(f"aggregator (b) quantile tile {shape} f32 = {nbytes} bytes, qs "
          f"{qs}, {len(tiles)} tiles over the warm-up and rounds")
    _card(f"aggregator (b) one round traced: {one['wall'] * 1e3:.3f} ms; "
          f"{_split_text(one)}")
    # The round's tile again, its parts timed alone.
    tile, counts = _timer_tile(elems, planes, shape)
    global AGG_TILE
    AGG_TILE = (tile, counts, qs)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    tile_d = torch.from_numpy(tile).to("cuda")
    cnt_d = torch.from_numpy(counts).to("cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - h0) * 1e3
    sel_ms = cuda_ms(lambda: agg.quantile_rank_select(tile_d, cnt_d, qs), 5)
    idx = agg.quantile_rank_select(tile_d, cnt_d, qs)
    torch.cuda.synchronize()
    d0 = time.perf_counter()
    idx_h = idx.cpu().numpy()
    d2h_ms = (time.perf_counter() - d0) * 1e3
    p0 = time.perf_counter()
    plain = agg.quantile_rank_select(torch.from_numpy(tile),
                                     torch.from_numpy(counts), qs)
    plain_ms = (time.perf_counter() - p0) * 1e3
    check(np.array_equal(idx_h, plain.numpy()), "the card's rank selection "
          "differs from its plain version on the round's tile")
    # bytes: the tile read once, the counts, the indices written; the
    # sort's passes are not counted (the least any ordering must move).
    bound_ms = (tile.nbytes + counts.nbytes + idx_h.nbytes) / HBM_BYTES_PER_S * 1e3
    _card(f"aggregator (b) rank selection at {shape}: device {sel_ms!r} ms "
          f"(CUDA events, 5 calls), H2D of tile + counts {h2d_ms!r} ms, D2H "
          f"of the indices {d2h_ms!r} ms, plain on the host CPU {plain_ms!r} "
          f"ms, byte bound {bound_ms!r} ms; indices equal the plain version")
    del tile_d, cnt_d, idx, lists, elems, lst
    torch.cuda.empty_cache()
    _agg_mirror(planes, list_mod, plan_jobs)
    _rank_select_widths()
    _agg_flush_fault()


def _timer_tile(elems, planes, shape):
    """The tile of one agg10x round (both windows of every timer, in flush
    order: window-major within each timer) built as the flush builds it."""
    from m3_tpu_torch.parallel import agg_flush

    rows = [planes["timer"][i] for _e, kind, i in elems if kind == "timer"]
    buckets = [r[k * 6:(k + 1) * 6] for r in rows for k in (0, 1)]
    counts = np.full(len(buckets), 6, np.int64)
    tile = agg_flush.build_quantile_tile(buckets, counts)[0]
    check(tile.shape == shape, f"the rebuilt tile {tile.shape} is not the "
          f"round's {shape}")
    return tile, counts.astype(np.int32)


def _agg_mirror(planes, list_mod, plan_jobs) -> None:
    """The reference bench's oracle protocol (bench.py:732-783) at its
    20,000-metric mirror (the first rows of the 500,000-metric values):
    the card's flush, the CPU's flush and reduce_and_emit_ref on the card
    emit the same rows bit for bit."""
    from m3_tpu_torch.testing import (AGG_BASE_NS, agg10x_build, agg10x_stage,
                                      loopback_forward)

    n = AGG_MIRROR_SERIES
    out = {}
    for who, dev in (("card", None), ("cpu", "cpu"), ("oracle", None)):
        lists, elems, _, _ = agg10x_build(n, dev)
        lst = lists.for_resolution(60 * 10**9)
        agg10x_stage(elems, planes)
        rows = []
        cap = lambda m, t, v, p, _r=rows: _r.append((m, t, v))  # noqa: E731
        fwd = loopback_forward(lst)
        t0 = time.perf_counter()
        for tt in (120, 180):
            target = AGG_BASE_NS + tt * 10**9
            if who == "oracle":
                list_mod.reduce_and_emit_ref(
                    plan_jobs(lists, target, 0, cap, fwd)[0], device=dev)
            else:
                lst.flush(target, cap, fwd)
        out[who] = (sorted(rows), (time.perf_counter() - t0) * 1e3)
    rows = out["card"][0]
    check(rows == out["cpu"][0], "agg10x mirror: the card's emissions differ "
          "from the CPU's")
    check(rows == out["oracle"][0], "agg10x mirror: the card's emissions "
          "differ from reduce_and_emit_ref")
    _card(f"aggregator (b) mirror of {n} metrics: {len(rows)} rows, card == "
          f"CPU == reduce_and_emit_ref bit for bit (flush ms: card "
          f"{out['card'][1]!r}, CPU {out['cpu'][1]!r}, oracle "
          f"{out['oracle'][1]!r})")


def _rank_select_widths() -> None:
    """The rank selection on the card against its plain version on the
    CPU at widths 128, 256 and 1024 (rows with NaN of both signs, -0.0 and
    +0.0, ties, infinities, empty and full rows)."""
    import torch

    from m3_tpu_torch.ops import aggregation as agg
    from m3_tpu_torch.testing import hostile_rank_rows

    qs = (0.0, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)
    for w, b in ((128, 20_000), (256, 20_000), (1024, 20_000)):
        v, c = hostile_rank_rows(w, b, w)
        got = agg.quantile_rank_select(torch.from_numpy(v).to("cuda"),
                                       torch.from_numpy(c).to("cuda"), qs)
        want = agg.quantile_rank_select(torch.from_numpy(v),
                                        torch.from_numpy(c), qs)
        check(torch.equal(got.cpu(), want), f"rank selection at width {w}: "
              "the card differs from the plain version")
    phase("aggregator (b): the rank selection equals its plain version at "
          "widths 128, 256 and 1024 on hostile rows")


def _agg_flush_fault() -> None:
    """A fault injected on the `agg_flush` route on the card raises a
    typed KernelFault and is counted once."""
    from m3_tpu_torch.parallel import agg_flush, guard
    from m3_tpu_torch.testing import faultcomp
    from m3_tpu_torch.utils.instrument import ROOT

    buckets = [np.arange(k, dtype=np.float64) for k in (3, 0, 200)]
    counts = np.array([3, 0, 200])
    key = "telemetry.compute.faults{kind=kernel,route=agg_flush}"
    guard.reset()
    before = ROOT.snapshot().get(key, 0)
    try:
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=1, dispatch_raise=1.0, route_filter="agg_flush")):
            agg_flush.exact_quantile_values(buckets, counts, (0.5,))
        raised = None
    except guard.KernelFault as err:
        raised = err
    finally:
        guard.reset()
    counted = ROOT.snapshot().get(key, 0) - before
    check(raised is not None and raised.route == "agg_flush" and counted == 1,
          f"agg_flush fault: raised {raised!r}, counted {counted}")
    vals = agg_flush.exact_quantile_values(buckets, counts, (0.5,))
    check(vals[:, 0].tolist() == [1.0, 0.0, 99.0], "agg_flush after reset")
    phase("aggregator (b): an injected fault on agg_flush raised "
          f"{type(raised).__name__} on the card, counted once")


def _agg_end_to_end() -> None:
    """(c) Aggregator end to end: 64 shards, AGG_E2E_IDS metric ids (40%
    counters, 40% gauges, 20% timers of 5 values), one sample per id
    every 6 s for 2 minutes (one million samples) through
    add_untimed_batch, then one flush with an election and a
    FlushTimesManager: every window emitted, the flush times committed
    once, counter sums and timer quantiles equal to an independent numpy
    computation."""
    import torch

    from m3_tpu_torch.aggregator import Aggregator, CaptureHandler
    from m3_tpu_torch.aggregator.election import ElectionManager
    from m3_tpu_torch.aggregator.flush import FlushTimesManager
    from m3_tpu_torch.cluster.kv import MemStore
    from m3_tpu_torch.cluster.services import LeaderService
    from m3_tpu_torch.metrics.metric import MetricUnion
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.testing import AGG_BASE_NS

    n, k = AGG_E2E_IDS, AGG_E2E_SAMPLES // AGG_E2E_IDS
    rng = np.random.default_rng(37)
    cvals = rng.poisson(5.0, (k, n))
    gvals = rng.standard_normal((k, n))
    tvals = rng.lognormal(0.0, 1.0, (k, n, 5))
    ids = [b"agg.e2e.%d" % i for i in range(n)]
    kinds = np.arange(n) % 5  # 0-1 counter, 2-3 gauge, 4 timer
    store = MemStore()
    commits = []
    set_many = store.set_many
    store.set_many = lambda items: (commits.append(len(items)),
                                    set_many(items))[1]
    clock = {"t": AGG_BASE_NS}
    handler = CaptureHandler()
    agg = Aggregator(num_shards=64, clock=lambda: clock["t"],
                     flush_handler=handler,
                     election=ElectionManager(LeaderService(
                         store, "agg", "i-0", lease_ttl_ns=3600 * 10**9,
                         clock=lambda: clock["t"])),
                     flush_times=FlushTimesManager(store, "ss-0"),
                     default_policies=(StoragePolicy.parse("1m:40h"),))
    ingest_s = 0.0
    for j in range(k):
        clock["t"] = AGG_BASE_NS + j * 6 * 10**9
        mus = [MetricUnion.counter(m, int(cvals[j, i])) if kinds[i] < 2 else
               MetricUnion.gauge(m, float(gvals[j, i])) if kinds[i] < 4 else
               MetricUnion.batch_timer(m, tvals[j, i].tolist())
               for i, m in enumerate(ids)]
        t0 = time.perf_counter()
        ok = agg.add_untimed_batch(mus)
        ingest_s += time.perf_counter() - t0
        check(all(ok), "add_untimed_batch refused a sample")
    clock["t"] = AGG_BASE_NS + 3 * 60 * 10**9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    windows = agg.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    n_t = int((kinds == 4).sum())
    check(windows == 2 * n, f"Aggregator.flush: {windows} windows")
    check(len(handler.metrics) == 2 * (n - n_t) + 2 * n_t * 11,
          f"Aggregator.flush: {len(handler.metrics)} rows")
    check(commits == [64], f"flush times committed as {commits}")
    got = {(m.id, m.time_nanos): m.value for m in handler.metrics}
    half = k // 2  # samples per 1m window
    for w in (0, 1):
        end = AGG_BASE_NS + (w + 1) * 60 * 10**9
        sl = slice(w * half, (w + 1) * half)
        csum = cvals[sl].sum(axis=0)
        tw = np.sort(tvals[sl].transpose(1, 0, 2).reshape(n, -1), axis=1)
        cnt = tw.shape[1]
        for i in range(0, n, 97):
            if kinds[i] < 2:
                check(got[(ids[i], end)] == float(csum[i]),
                      f"counter {ids[i]} window {w}")
            elif kinds[i] == 4:
                name = ids[i]
                for q, suffix in ((0.5, b".p50"), (0.99, b".p99")):
                    r = int(np.ceil(np.float32(q) * np.float32(cnt))) - 1
                    check(got[(name + suffix, end)] == tw[i, r],
                          f"timer {name} {suffix} window {w}")
    _card(f"aggregator (c) Aggregator: 64 shards, {n} ids, {n * k} samples "
          f"through add_untimed_batch in {ingest_s:.3f}s "
          f"({n * k / ingest_s!r} samples/s); flush with election of "
          f"{windows} windows, {len(handler.metrics)} rows in "
          f"{flush_s * 1e3!r} ms; flush times of 64 shards in "
          f"{len(commits)} kv transaction")


def _rules_phase(plan_corpus, t) -> None:
    """(d) RulesEngine over phase 10's corpus (10,000 counters over 200
    hosts, seed 17) on the default compiled route: 4 rounds at step 30 s
    on an advancing clock (1, 2, 3 and 4 new steps): two recording rules
    (a grouped rate sum; max_over_time, the window kernel inside its plan
    graph), a class of 16 `>` alert rules on avg_over_time at thresholds
    near quantiles of the data (the compare on the card: 160,000 cells a
    step) and a for_steps=3 rule. The recorded rows go through
    write_output into a Database(ShardSet(16)) (the hash kernel) and are
    read back through LocalStorage; rows and transitions equal the same
    rounds on Engine(device="cpu") (rows within the compiled route's
    bounds, transitions as sets)."""
    import torch

    from m3_tpu_torch.coordinator.rules_engine import (AlertRule,
                                                       RecordingRule,
                                                       RulesEngine)
    from m3_tpu_torch.parallel import compile as pcompile
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.model import Tags
    from m3_tpu_torch.query.storage import LocalStorage
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.testing import DictStorage, gap_thresholds

    storage = DictStorage(plan_corpus)
    avg = "avg_over_time(bench_requests[5m])"
    base = int(t[200])
    clocks = [base + j * STEP_NS for j in (0, 2, 5, 9)]
    ref = Engine(storage, device="cpu").execute_range_ref(
        avg, base, clocks[-1], STEP_NS)
    ths = gap_thresholds(np.asarray(ref.values), 16)
    recs = [RecordingRule(b"rules:%d" % i, q, labels=((b"rule", b"r%d" % i),))
            for i, q in enumerate(RULE_RECORDS)]
    alerts = [AlertRule(b"hot:%02d" % i, avg, ">", th)
              for i, th in enumerate(ths)]
    alerts.append(AlertRule(b"sticky", avg, ">", ths[8], for_steps=3))
    now = {"t": base}
    db = Database(ShardSet(num_shards=16), clock=lambda: now["t"])
    db.ensure_namespace(b"default")

    def write_output(rows):
        ids = [Tags.of(tags).id() for tags, _t, _v in rows]
        db.write_batch(b"default", ids,
                       np.array([r[1] for r in rows], np.int64),
                       np.array([r[2] for r in rows], np.float64),
                       tags=[r[0] for r in rows])

    out = {}
    for who, eng in (("card", Engine(storage)),
                     ("cpu", Engine(storage, device="cpu"))):
        written = []

        def sink(rows, _w=written):
            _w.extend(rows)
            if who == "card":
                write_output(rows)

        re = RulesEngine(eng, sink, step_ns=STEP_NS)
        for r in recs:
            re.add_recording(r)
        for a in alerts:
            re.add_alert(a)
        rounds = []
        for c in clocks:
            now["t"] = c
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = re.evaluate(c)
            torch.cuda.synchronize()
            rounds.append(((time.perf_counter() - t0) * 1e3, res))
        out[who] = (rounds, written, re)
    card_rounds, card_rows, card_re = out["card"]
    cpu_rounds, cpu_rows, _ = out["cpu"]
    for (_, a), (_, b) in zip(card_rounds, cpu_rounds):
        check((a.steps, a.exprs_evaluated, a.recorded_rows) ==
              (b.steps, b.exprs_evaluated, b.recorded_rows),
              f"rules round differs: {a} against {b}")
        check({(x.rule, x.series, x.kind, x.time_nanos) for x in
               a.transitions} == {(x.rule, x.series, x.kind, x.time_nanos)
                                  for x in b.transitions},
              "rules: the card's transitions differ from the CPU's")
    key = lambda r: (tuple(sorted(r[0].items())), r[1])  # noqa: E731
    gk = {key(r): r[2] for r in card_rows}
    ck_ = {key(r): r[2] for r in cpu_rows}
    check(gk.keys() == ck_.keys(), "rules: recorded rows differ in keys")
    worst = 0.0
    for i, q in enumerate(RULE_RECORDS):
        keys = [k for k in ck_ if dict(k[0])[b"__name__"] == b"rules:%d" % i]
        a = np.array([gk[k] for k in keys])
        b = np.array([ck_[k] for k in keys])
        tol = _plan_tol(q, b)
        check(bool(np.allclose(a, b, equal_nan=True, **tol)),
              f"rules: recorded {q} beyond {tol}")
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
            np.abs(b), 1e-30))))
    n_trans = sum(len(r.transitions) for _, r in card_rounds)
    check(n_trans > 0, "rules: no transition in 4 rounds")
    # read the recorded series back from the store
    want = {(dict(k[0])[b"host"], k[1]): v for k, v in gk.items()
            if dict(k[0])[b"__name__"] == b"rules:0"}
    times = [tt for _h, tt in want]
    local = Engine(LocalStorage(db, b"default"))
    blk = local.execute_range('rules:0{rule="r0"}', min(times), max(times),
                              STEP_NS)
    got = {(x.get(b"host"), int(tt)): float(v)
           for x, row in zip(blk.series_tags, np.asarray(blk.values))
           for tt, v in zip(blk.meta.times(), row) if np.isfinite(v)}
    check(got.keys() == want.keys() and all(
        abs(got[k] - want[k]) <= 1e-6 * abs(want[k]) for k in want),
        "rules: the stored recorded series do not read back")
    db.close()
    pcompile.clear()
    torch.cuda.empty_cache()
    card_ms = [round(ms, 3) for ms, _ in card_rounds]
    cpu_ms = [round(ms, 3) for ms, _ in cpu_rounds]
    _card(f"rules (d): 4 rounds of {[r.steps for _, r in card_rounds]} steps "
          f"over {len(plan_corpus)} series: card ms {card_ms}, CPU ms "
          f"{cpu_ms}; {len(card_rows)} recorded rows (max rel diff to the "
          f"CPU {worst!r}), {n_trans} transitions (equal sets), firing "
          f"{len(card_re.firing())}; the recorded rate sum read back through "
          f"LocalStorage ({len(got)} cells)")


# ---------------------------------------------------------------------------
# Phase 12: the storage node's durability
# ---------------------------------------------------------------------------

# Config #12 (bench.py:bench_bootstrap_replay, 1440-1571) at the bench's
# own size, and config #8's shape (phase 7 (a)) flushed, evicted, read
# cold and restarted.
BOOT_SERIES, BOOT_SHARDS, BOOT_WAVES, BOOT_SEED, BOOT_RUNS = (
    100_000, 8, 4, 83, 2)
# Phase 12 (a) holds every recovered series to its acknowledged points and
# this many (seeded) to the pre-kill database's own reads: a read of the
# pre-kill warm block scans its shard's whole buffer bucket (about 140 us
# a read at this size on the host of an H100 machine, so all 100,000
# would take 27 s).
BOOT_PREKILL_SAMPLE = 5_000
# Phase 12 (b)'s series: config #8's 100,000 cut to 25,000 for the
# script's time (PERF.md section 4); the grp tag puts 250 in each group.
DUR_SERIES = 25_000
DUR_GROUPS = 100
DUR_QUERIES = ('rate(bench_hot{grp="g07"}[5m])',
               'sum_over_time(bench_hot{grp="g07"}[5m])',
               'sum by (grp) (rate(bench_hot{grp=~"g1."}[5m]))',
               'bench_hot{grp=~"g2[0-4]"}')
# The bootstrap steps that phase 12 (a) times (cProfile).
BOOT_STEPS = {
    "bootstrappers (filesystem + commitlog)": ("storage/bootstrap.py",
                                               "bootstrap"),
    "of which fileset open (digests, index)": ("persist/fs.py", "__init__"),
    "of which verify_rows (row adlers, bloom through K3)": (
        "persist/fs.py", "verify_rows"),
    "of which install (load_block)": ("storage/shard.py", "load_block"),
    "snapshot install (load_snapshots)": ("storage/bootstrap.py",
                                          "load_snapshots"),
    "WAL replay (replay_wal)": ("storage/bootstrap.py", "replay_wal"),
    "of which chunk decode": ("persist/commitlog.py", "replay_batches"),
    "of which routing (hash_batch: pad, H2D, K3, D2H)": (
        "utils/hashing.py", "hash_batch"),
    "of which buffer append": ("storage/buffer.py", "write_batch"),
}


def _durability_phase() -> dict:
    """Phase 12: the storage node's durable path on the card, in a
    temporary directory the phase removes. (a) config #12 at its own size:
    seed, abandon, bootstrap; (b) config #8's shape with the index and the
    commit log: flush, evict, cold reads through the BlockRetriever,
    restart, queries; (c) one flipped byte in one of (b)'s data.bin files:
    the quarantine-only scrubber, detect-or-serve reads, a restart that
    leaves the range to the commit log. Returns the kernels' launches over
    the phase (the counts set to 0 just before it)."""
    import shutil
    import tempfile

    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    root = tempfile.mkdtemp(prefix="chip_smoke_durability_")
    try:
        ck.reset_launch_counts()
        wk.window_stat.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _boot_config12(os.path.join(root, "c12"))
        state = _flush_evict_restart(os.path.join(root, "c8"))
        _scrub_fallthrough(state)
        torch.cuda.synchronize()
        launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
        del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase(f"durability: phase 12 in {time.perf_counter() - t0:.1f}s, "
          f"launches {launches}")
    check(all(launches[k] > 0 for k in ("pack", "decode", "hash")),
          f"phase 12 did not launch the pack, decode and hash kernels: "
          f"{launches}")
    torch.cuda.empty_cache()
    return launches


class _Steps:
    """Host-clock seconds of a phase's steps (each ends in a
    synchronise), printed as they end beside the card, and the kernels'
    launches each step made."""

    def __init__(self, label: str):
        self.label = label

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        from m3_tpu_torch.ops import codec_kernels as ck
        from m3_tpu_torch.ops import window_kernels as wk

        before = dict(ck.launch_counts(), window=wk.window_stat.launches)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = dict(ck.launch_counts(), window=wk.window_stat.launches)
        moved = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        _card(f"{self.label} {name}: {secs!r} s host clock, launches {moved}")


def _read_all_series(db, ns: bytes, ids, start: int, end: int):
    return [db.read(ns, sid, start, end) for sid in ids]


def _same_reads(got, want) -> bool:
    return all(a[0].tobytes() == b[0].tobytes()
               and np.asarray(a[1], np.float64).tobytes()
               == np.asarray(b[1], np.float64).tobytes()
               for a, b in zip(got, want)) and len(got) == len(want)


def _boot_config12(root: str) -> None:
    """Phase 12 (a): config #12 at the bench's size (bench.py:1477-1515)
    with the commit log on: BOOT_SERIES series in BOOT_SHARDS shards, index
    off, a flushed 2 h block, BOOT_WAVES WAL waves into the next block (one
    checksummed chunk each), Mediator.snapshot, abandoned without close();
    then fresh card databases bootstrapped with the filesystem and
    commit-log chain: a warm pass, BOOT_RUNS timed recoveries and a traced
    one. Every series' read over both blocks equals its acknowledged points
    bit for bit, and BOOT_PREKILL_SAMPLE of them the pre-kill db's reads;
    the batched replay equals replay_ref; a device="cpu"
    bootstrap of the same dir gives the same registries and sealed words."""
    import torch

    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.persist import commitlog as cl
    from m3_tpu_torch.persist.fs import PersistManager
    from m3_tpu_torch.storage.bootstrap import (BootstrapContext,
                                                BootstrapProcess)
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.mediator import Mediator
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    step = _Steps("durability (a)")
    ns = b"bench"
    n = BOOT_SERIES
    acked_t, acked_v = [], []
    t0 = (1_700_000_000 * 10**9 // BLOCK_NS) * BLOCK_NS
    now = {"t": t0}
    cl_dir = os.path.join(root, "commitlog")
    opts = NamespaceOptions(index_enabled=False)
    pm = PersistManager(os.path.join(root, "data"))
    ids = [b"boot-%07d" % i for i in range(n)]
    rng = np.random.default_rng(BOOT_SEED)
    with step("seed: write the old block (K3)"):
        log = cl.CommitLog(cl_dir)
        db = Database(ShardSet(BOOT_SHARDS), commitlog=log,
                      clock=lambda: now["t"])
        db.ensure_namespace(ns, opts)
        now["t"] = t0 + MINUTE_NS
        acked_t.append(np.full(n, t0, np.int64))
        acked_v.append(rng.standard_normal(n))
        db.write_batch(ns, ids, acked_t[-1], acked_v[-1])
    with step("seed: tick (K1 seals)"):
        now["t"] = t0 + BLOCK_NS + 11 * MINUTE_NS
        sealed = db.tick()["sealed"]
    check(sealed == BOOT_SHARDS, f"tick sealed {sealed}")
    with step("seed: flush (8 filesets, blooms through K3)"):
        flushed = db.flush(pm)
    check(flushed == BOOT_SHARDS, f"flushed {flushed}")
    bs1 = t0 + BLOCK_NS
    gap = BLOCK_NS // (BOOT_WAVES + 2)
    with step(f"seed: {BOOT_WAVES} WAL waves"):
        for wv in range(BOOT_WAVES):
            ts_w = bs1 + wv * gap + 11 * MINUTE_NS + 12 * MINUTE_NS
            now["t"] = ts_w
            acked_t.append(np.full(n, ts_w, np.int64))
            acked_v.append(rng.standard_normal(n))
            db.write_batch(ns, ids, acked_t[-1], acked_v[-1])
            log.flush()
    with step("seed: Mediator.snapshot (K1)"):
        snaps = Mediator(db, pm).snapshot(now["t"])
    check(snaps == BOOT_SHARDS, f"snapshotted {snaps}")
    # Abandoned without close(): the disk as a SIGKILL leaves it.

    def recover(device=None):
        fresh = Database(ShardSet(BOOT_SHARDS), clock=lambda: now["t"],
                         device=device)
        fresh.ensure_namespace(ns, opts)
        res = BootstrapProcess(
            chain=("filesystem", "commitlog"),
            ctx=BootstrapContext(persist=pm, commitlog_dir=cl_dir,
                                 shard_lookup=fresh.shard_set.lookup)
        ).run(fresh, now_ns=now["t"])
        if fresh.device.type == "cuda":
            torch.cuda.synchronize()
        return fresh, res

    with step("bootstrap, warm pass"):
        got, res = recover()
    recovered = sum(s.num_series() for s in got.namespace(ns).shards.values())
    check(recovered == n, f"recovered {recovered}/{n} series")
    check(res[ns].notes == [] and res[ns].unfulfilled.is_empty(),
          f"bootstrap notes {res[ns].notes}, unfulfilled "
          f"{res[ns].unfulfilled}")
    dts = []
    for _ in range(BOOT_RUNS):
        t1 = time.perf_counter()
        recover()
        dts.append(time.perf_counter() - t1)
    with _instrumented(BOOT_STEPS) as traced:
        recover()
    split = traced["split"]
    fs_s = (split["bootstrappers (filesystem + commitlog)"]
            - split["snapshot install (load_snapshots)"]
            - split["WAL replay (replay_wal)"])
    _card(f"durability (a) recovery to serving-ready: {n} series, "
          f"{BOOT_SHARDS} shards, {BOOT_WAVES} WAL waves; runs {dts} s, "
          f"{n / min(dts)!r} series/s (best of {BOOT_RUNS}); traced run "
          f"{traced['wall']!r} s: filesystem {fs_s!r} s, snapshot install "
          f"{split['snapshot install (load_snapshots)']!r} s, WAL replay "
          f"{split['WAL replay (replay_wal)']!r} s; {_split_text(traced)}")
    end = now["t"] + BLOCK_NS
    with step(f"reads of all {n} recovered series (K2) against their "
              f"acknowledged points"):
        have = _read_all_series(got, ns, ids, 0, end)
    acked_t = np.stack(acked_t, axis=1)
    acked_v = np.stack(acked_v, axis=1)
    check(_same_reads(have, list(zip(acked_t, acked_v))),
          "a recovered series differs from its acknowledged points")
    sample = np.random.default_rng(BOOT_SEED).choice(
        n, BOOT_PREKILL_SAMPLE, replace=False)
    with step(f"reads of {BOOT_PREKILL_SAMPLE} series from the pre-kill db"):
        want = _read_all_series(db, ns, [ids[i] for i in sample], 0, end)
    check(_same_reads([have[i] for i in sample], want),
          "a recovered series differs from the pre-kill db's read")
    with step("oracle: replay_batches against replay_ref"):
        ref = list(cl.replay_ref(cl_dir))
        new = [(a, b, int(c), float(d)) for bt in cl.replay_batches(cl_dir)
               for a, b, c, d in zip(bt.namespaces, bt.ids, bt.t_ns,
                                     bt.values)]
    check(len(ref) == n * (1 + BOOT_WAVES) and new == ref,
          f"the batched replay differs from replay_ref ({len(ref)} entries)")
    with step("bootstrap on the CPU (the plain versions)"):
        host, _ = recover("cpu")
    for sid, shard in got.namespace(ns).shards.items():
        other = host.namespace(ns).shards[sid]
        check(shard.registry.all_ids() == other.registry.all_ids(),
              f"shard {sid}: the card's registry differs from the CPU's")
        check(sorted(shard.blocks) == sorted(other.blocks),
              f"shard {sid}: block starts differ")
        for bstart, blk in shard.blocks.items():
            oblk = other.blocks[bstart]
            check(np.asarray(blk.words).tobytes()
                  == np.asarray(oblk.words).tobytes()
                  and np.array_equal(blk.nbits, oblk.nbits)
                  and np.array_equal(blk.npoints, oblk.npoints),
                  f"shard {sid} block {bstart}: sealed words differ")
    phase(f"durability (a): {n} series recovered on the card, every read "
          f"equal to its acknowledged points ({BOOT_PREKILL_SAMPLE} to the "
          f"pre-kill db's reads), the batched replay equal to "
          f"replay_ref ({len(ref)} entries), registries and sealed words "
          f"equal to a CPU bootstrap")
    del db, got, host, want, have, ref, new


def _flush_evict_restart(root: str) -> dict:
    """Phase 12 (b): config #8's shape as phase 7 (a) writes it (its
    100,000 series cut to DUR_SERIES, in 4 shards, two 2 h blocks of 120 points, seed 53; each
    series' value the step's draw plus its index, so rows differ) with the
    namespace index on (tags on the first write) and the commit log on
    (WRITE_BEHIND); tick, flush (8 filesets + index segments), evict, the
    2,000-read hot-set mix through the BlockRetriever twice, then a
    restart from the filesystem and commit-log chain and four queries
    over LocalStorage equal to the pre-restart answers (taken before the
    eviction). Returns what (c) needs."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.persist import commitlog as cl
    from m3_tpu_torch.persist.fs import PersistManager
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.storage import LocalStorage
    from m3_tpu_torch.storage.bootstrap import (BootstrapContext,
                                                BootstrapProcess)
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions
    from m3_tpu_torch.storage.retriever import BlockRetriever

    step = _Steps("durability (b)")
    ns = b"bench"
    n = DUR_SERIES
    rng = np.random.default_rng(STORE_SEED)
    t0 = (1_700_000_000 * 10**9 // BLOCK_NS) * BLOCK_NS
    step_ns = BLOCK_NS // STORE_PPB
    now = {"t": t0}
    opts = NamespaceOptions(index_enabled=True, snapshot_enabled=False,
                            retention_ns=4 * 24 * 3600 * 10**9)
    cl_dir = os.path.join(root, "commitlog")
    pm = PersistManager(os.path.join(root, "data"))
    retr = BlockRetriever(pm)
    db = Database(ShardSet(STORE_SHARDS), commitlog=cl.CommitLog(cl_dir),
                  clock=lambda: now["t"], retriever=retr)
    db.ensure_namespace(ns, opts)
    ids = [b"hot-%06d" % i for i in range(n)]
    tags = [{b"__name__": b"bench_hot", b"grp": b"g%02d" % (i % DUR_GROUPS)}
            for i in range(n)]
    offsets = np.arange(n, dtype=np.float64)
    vals_by_step = rng.standard_normal((2 * STORE_PPB,))
    with step(f"write {2 * STORE_PPB} batches of {n} (K3, WAL)"):
        for s in range(2 * STORE_PPB):
            ts_i = t0 + s * step_ns
            now["t"] = ts_i
            db.write_batch(ns, ids, np.full(n, ts_i, np.int64),
                           offsets + vals_by_step[s],
                           tags=tags if s == 0 else None)
    with step("tick (K1 seals)"):
        now["t"] = t0 + 2 * BLOCK_NS + 11 * MINUTE_NS
        sealed = db.tick()["sealed"]
    check(sealed == 2 * STORE_SHARDS, f"tick sealed {sealed}")
    n_sets = 2 * STORE_SHARDS
    before = ck.launch_counts()["hash"]
    f0 = time.perf_counter()
    flushed = db.flush(pm)
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - f0
    bloom_launches = ck.launch_counts()["hash"] - before
    segments = flushed - n_sets
    _card(f"durability (b) flush: {n_sets} filesets + {segments} index "
          f"segments in {flush_s!r} s, {flush_s / n_sets * 1e3!r} ms per "
          f"fileset; {bloom_launches} hash launches (two a bloom)")
    check(segments >= 1 and bloom_launches == 2 * n_sets,
          f"flush wrote {flushed}, blooms launched {bloom_launches}")

    n_hot = max(1, int(n * HOT_FRAC))
    hot_ids = rng.permutation(n)[:n_hot]
    draws = rng.random(HOT_READS)
    mix = np.where(draws < HOT_WEIGHT,
                   hot_ids[rng.integers(0, n_hot, HOT_READS)],
                   rng.integers(0, n, HOT_READS))
    start, end = t0, t0 + 2 * BLOCK_NS
    mix_ids = [ids[int(i)] for i in mix]
    with step("the read mix before eviction"):
        want = _read_all_series(db, ns, mix_ids, start, end)
    q_start, q_end = t0 + 30 * MINUTE_NS, t0 + 2 * BLOCK_NS - MINUTE_NS
    before_ans = {}
    with step("the four queries before the restart"):
        eng = Engine(LocalStorage(db, ns))
        for q in DUR_QUERIES:
            before_ans[q] = eng.execute_range(q, q_start, q_end, STEP_NS)
            before_ans[q].values
    with step("evict_flushed"):
        evicted = db.evict_flushed()
    check(evicted == n_sets, f"evicted {evicted}")

    def cold_pass():
        durs = np.empty(HOT_READS)
        out = []
        d0 = ck.launch_counts()["decode"]
        for i, sid in enumerate(mix_ids):
            r0 = time.perf_counter()
            out.append(db.read(ns, sid, start, end))
            durs[i] = time.perf_counter() - r0
        return out, durs, ck.launch_counts()["decode"] - d0

    passes = []
    for k in range(2):
        got, durs, launches = cold_pass()
        check(_same_reads(got, want),
              f"cold pass {k + 1}: a read differs from its pre-eviction "
              f"read")
        passes.append(launches)
        _card(f"durability (b) cold reads through the BlockRetriever, pass "
              f"{k + 1}: {float(HOT_READS / durs.sum())!r} reads/s, p99 "
              f"{float(np.quantile(durs, 0.99)) * 1e3!r} ms, mean "
              f"{float(durs.mean()) * 1e3!r} ms per read; {launches} decode "
              f"launches; retriever {dict(retr.stats)}, WiredList "
              f"{len(retr.wired)} rows")
    check(retr.stats["wired_hits"] > 0 and passes[1] < passes[0],
          f"the second pass did not hit the WiredList: {passes}, "
          f"{retr.stats}")

    log_dir = db.commitlog.directory
    # The restart: a fresh database from the disk (the old one stays
    # unclosed, as after a SIGKILL).
    with step("restart: bootstrap (filesystem + commitlog)"):
        db2 = Database(ShardSet(STORE_SHARDS), clock=lambda: now["t"])
        db2.ensure_namespace(ns, opts)
        res = BootstrapProcess(
            chain=("filesystem", "commitlog"),
            ctx=BootstrapContext(persist=pm, commitlog_dir=log_dir,
                                 shard_lookup=db2.shard_set.lookup)
        ).run(db2, now_ns=now["t"])
    check(res[ns].notes == [], f"restart notes {res[ns].notes}")
    check(sum(s.num_series() for s in db2.namespace(ns).shards.values())
          == n, "the restart lost series")
    eng2 = Engine(LocalStorage(db2, ns))
    for q in DUR_QUERIES:
        w0 = wk.window_stat.launches
        q0 = time.perf_counter()
        blk = eng2.execute_range(q, q_start, q_end, STEP_NS)
        blk.values
        torch.cuda.synchronize()
        secs = time.perf_counter() - q0
        route = eng2.last_route()
        rel, absd = _check_query(q, blk, before_ans[q], "after the restart")
        check(blk.values.shape[0] > 0, f"{q}: no series after the restart")
        if q.startswith("sum_over_time"):
            check(route["route"] == "compiled"
                  and wk.window_stat.launches > w0,
                  f"{q}: the window kernel did not run in its plan graph "
                  f"({route})")
        _card(f"durability (b) query after the restart {q!r}: "
              f"{tuple(blk.values.shape)}, {secs!r} s, route "
              f"{route['route']}, window launches "
              f"{wk.window_stat.launches - w0}, max rel diff {rel!r}, abs "
              f"{absd!r} to the pre-restart answer")
    phase("durability (b): flush, evict, 2 cold passes equal to the "
          "pre-eviction reads, restart with the index from its segments, "
          "4 queries equal to the pre-restart answers")
    return {"db": db2, "pm": pm, "ids": ids, "now": now, "t0": t0,
            "log_dir": log_dir, "opts": opts}


def _scrub_fallthrough(state: dict) -> None:
    """Phase 12 (c): one byte flipped in one of (b)'s data.bin files (shard
    0's first block). Every serve path either raises typed or returns the
    written data; the quarantine-only scrubber quarantines exactly that
    fileset (and re-schedules the resident block's flush); a restart of
    shard 0 from the disk leaves the range to the commit log, whose replay
    restores it: sealed by a tick and flushed to a clean fileset, its
    reads equal the pre-corruption reads bit for bit."""
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.persist import fs as pfs
    from m3_tpu_torch.persist.diskio import CorruptionError
    from m3_tpu_torch.storage.bootstrap import (BootstrapContext,
                                                BootstrapProcess)
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.scrub import DatabaseScrubber, ScrubOptions
    from m3_tpu_torch.storage.shard import FlushState

    step = _Steps("durability (c)")
    db, pm, ids, now, t0 = (state[k] for k in ("db", "pm", "ids", "now",
                                               "t0"))
    ns = b"bench"
    shard0 = [sid for sid in ids if db.shard_set.lookup(sid) == 0]
    start, end = t0, t0 + 2 * BLOCK_NS
    with step(f"reads of shard 0's {len(shard0)} series before the flip"):
        want = _read_all_series(db, ns, shard0, start, end)
    path = dict(pm.list_filesets(ns, 0))[t0]
    reader = pfs.FilesetReader(path)
    clean = np.array(reader._words)
    entries = list(reader.entries)
    del reader
    with open(os.path.join(path, pfs.DATA_FILE), "rb+") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 0x10]))
    with step("serve paths over the rotten fileset"):
        try:
            pfs.FilesetReader(path, verify=False).to_block()[0].read_all()
            check(False, "a block read of the rotten fileset served")
        except CorruptionError as err:
            check(err.rows == [0], f"rotten rows {err.rows}")
        seeker = pfs.Seeker(path)
        typed = served = 0
        for e in entries:
            try:
                got = seeker.seek(e.id)
            except CorruptionError:
                typed += 1
                continue
            check(got is not None and got[0].tobytes()
                  == clean[e.row].tobytes(),
                  f"the Seeker served a wrong row for {e.id!r}")
            served += 1
    check(typed == 1 and served == len(entries) - 1,
          f"seeks: {typed} typed errors, {served} right rows")
    quarantined = []
    real_quarantine = pfs.quarantine_fileset

    def record(p, *a, **k):
        quarantined.append(p)
        return real_quarantine(p, *a, **k)

    pfs.quarantine_fileset = record
    try:
        with step("DatabaseScrubber.run (quarantine-only)"):
            st = DatabaseScrubber(db, pm, opts=ScrubOptions(
                seed=1, max_bytes_per_s=0)).run(now_ns=now["t"])[ns]
    finally:
        pfs.quarantine_fileset = real_quarantine
    check(st.corrupt_found == 1 and st.quarantined == 1
          and quarantined == [path],
          f"the scrubber quarantined {quarantined}, stats {st}")
    check(st.unquarantined == 1 and db.namespace(ns).shards[0]
          .flush_states[t0] == FlushState.FAILED,
          "the resident block was not re-scheduled for flush")
    left = [(s, b) for s in range(STORE_SHARDS)
            for b, _p in pm.list_filesets(ns, s)]
    check(len(left) == 2 * STORE_SHARDS - 1 and (0, t0) not in left,
          f"filesets left {left}")
    _card(f"durability (c) scrub: {st}")
    with step("reads of shard 0 after the scrub"):
        check(_same_reads(_read_all_series(db, ns, shard0, start, end), want),
              "a read after the scrub differs")
    with step("restart of shard 0: filesystem, then the commit log"):
        db3 = Database(ShardSet(STORE_SHARDS), clock=lambda: now["t"])
        db3.ensure_namespace(ns, state["opts"])
        res = BootstrapProcess(
            chain=("filesystem", "commitlog"),
            ctx=BootstrapContext(persist=pm, commitlog_dir=state["log_dir"],
                                 shard_lookup=db3.shard_set.lookup)
        ).run(db3, now_ns=now["t"], shard_ids=[0])[ns]
    fs_ranges = res.claimed["filesystem"].ranges(0)
    check(not any(s <= t0 < e for s, e in fs_ranges)
          and any(s <= t0 < e for s, e in res.claimed["commitlog"].ranges(0)),
          f"claims {res.claimed}")
    with step("tick (K1 seals the replayed range) and flush"):
        sealed = db3.tick()["sealed"]
        flushed = db3.flush(pm)
    check(sealed == 1 and flushed == 1,
          f"the replayed range sealed {sealed}, flushed {flushed}")
    pfs.FilesetReader(dict(pm.list_filesets(ns, 0))[t0]).verify_rows()
    with step("reads of shard 0 after the restart"):
        got = _read_all_series(db3, ns, shard0, start, end)
    check(_same_reads(got, want),
          "the commit log's replay did not restore the quarantined range")
    phase(f"durability (c): the flipped fileset detected on every serve "
          f"path, quarantined alone by the scrubber; after a restart the "
          f"commit log restored its {len(shard0)} series bit for bit")


# Phase 13: the replicated cluster. (a) BASELINE config #9 at its size
# (bench.py:1310-1437): 100,000 series x 4 points in 8 shards on a donor,
# streamed into a joiner through a Session, seed 61; (b) a 3-node,
# replication-factor-3 cluster of 16 shards (tests/test_rpc_client.py:
# 145-149), written through a Session with bench_promql's counter corpus
# (seed 11) cut to RF3_POINTS points; (c) repair of one diverged replica.
PEER_SERIES, PEER_POINTS, PEER_SHARDS, PEER_SEED, PEER_ITERS = (
    100_000, 4, 8, 61, 2)
RF3_SERIES, RF3_POINTS, RF3_SHARDS, RF3_SEED = 10_000, 12, 16, 11
# Three query shapes over the session, cut from six for the script's
# time (six took 50.4 s on a slow host of the H100, PERF.md §4): a
# rate, a `*_over_time` (K4) and an aggregation.
CLUSTER_QUERIES = ("rate(bench_metric[5m])",
                   "max_over_time(bench_metric[5m])",
                   "sum(rate(bench_metric[5m]))")
# One of the queries runs again from an empty plan cache (a capture)
# while a second thread writes through the session (four took 68 s of the
# script's 1,200 on the H100's host, two 40.1 s, PERF.md §4).
CONCURRENT_QUERIES = CLUSTER_QUERIES[1:2]
# The peer-streaming steps that phase 13 (a) times (cProfile; on Python
# 3.12 it records every thread, the donor's handler threads included, so
# the split is indicative only).
PEER_STEPS = {
    "metadata (fetch_block_metadata_tiles_from_peers)": (
        "client/session.py", "fetch_block_metadata_tiles_from_peers"),
    "plan (plan_block_majority)": ("client/session.py",
                                   "plan_block_majority"),
    "tile fetch (fetch_block_tiles)": ("client/session.py",
                                       "fetch_block_tiles"),
    "apply (apply_peer_tiles)": ("storage/bootstrap.py", "apply_peer_tiles"),
}


def _cluster_phase() -> dict:
    """Phase 13: the client and the replicated cluster on the card, in a
    temporary directory the phase removes. (a) config #9: peer streaming
    of 100,000 series from a donor NodeServer into a joiner; (b) a 3-node
    RF=3 cluster: quorum writes through the Session, fetch_tagged against
    every node's reads, PromQL over SessionStorage against LocalStorage,
    queries while a second thread writes, one node taken away; (c) a
    diverged replica healed by the repairer; phase 14 (g), a
    run_clustered coordinator, on the cluster before it stops. Returns
    the kernels' launches over the phase (the counts set to 0 just before
    it)."""
    import shutil
    import tempfile

    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        ck.reset_launch_counts()
        wk.window_stat.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _peer_migration()
        cluster = _rf3_cluster(os.path.join(root, "rf3"))
        try:
            _repair_divergence(cluster)
            _clustered_coordinator(cluster)
        finally:
            cluster["session"].close()
            cluster["harness"].close()
        torch.cuda.synchronize()
        launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
        del cluster
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _card(f"cluster: phase 13 in {time.perf_counter() - t0!r} s, launches "
          f"{launches}")
    check(all(launches[k] > 0 for k in ("pack", "decode", "hash", "window")),
          f"phase 13 did not launch every kernel: {launches}")
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _time_unit(unit):
    """encode_block seals at `unit` instead of the coarsest lossless one
    (a replica that sealed the same points at another tick scale)."""
    from m3_tpu_torch.storage import block as block_mod

    real = block_mod.choose_time_unit
    block_mod.choose_time_unit = lambda ts: unit
    try:
        yield
    finally:
        block_mod.choose_time_unit = real


def _same_block(a, b) -> bool:
    return (np.array_equal(a.series_indices, b.series_indices)
            and np.asarray(a.words).tobytes() == np.asarray(b.words).tobytes()
            and np.array_equal(a.nbits, b.nbits)
            and np.array_equal(a.npoints, b.npoints)
            and a.window == b.window and a.time_unit == b.time_unit)


def _peer_migration() -> None:
    """Phase 13 (a): config #9 at its size (bench.py:1310-1437): a donor
    Database on the card (8 shards, index and commit log off) written
    (K3) and ticked (K1), served by a NodeServer; fresh joiner Databases
    on the card run BootstrapProcess(chain=("peers",)) through a Session
    (tiles decoded nowhere: installed as streamed): a warm pass, then
    PEER_ITERS timed passes and a traced one. Every migrated block equals
    the donor's; apply_peer_tiles equals apply_peer_tiles_ref on shard
    0's tiles; a mixed-unit tile (half of shard 0's rows re-sealed at
    millisecond ticks) goes through _apply_mixed_unit_rows (K2, then K1)
    and reads back equal to the donor."""
    from m3_tpu_torch.client import Session, SessionOptions
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.cluster.topology import StaticTopology
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.rpc import NodeServer, NodeService
    from m3_tpu_torch.storage import bootstrap as bs
    from m3_tpu_torch.storage.block import encode_block
    from m3_tpu_torch.storage.buffer import to_dense
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions
    from m3_tpu_torch.storage.shard import Shard
    from m3_tpu_torch.utils import xtime

    step = _Steps("cluster (a)")
    ns = b"bench"
    n = PEER_SERIES
    t0 = (1_700_000_000 * 10**9 // BLOCK_NS) * BLOCK_NS
    now = {"t": t0}
    opts = NamespaceOptions(index_enabled=False, snapshot_enabled=False,
                            writes_to_commitlog=False)
    ids = [b"mig-%07d" % i for i in range(n)]
    rng = np.random.default_rng(PEER_SEED)
    step_ns = BLOCK_NS // (PEER_POINTS + 1)
    with step(f"donor: write {n} x {PEER_POINTS} (K3)"):
        donor = Database(ShardSet(PEER_SHARDS), clock=lambda: now["t"])
        donor.ensure_namespace(ns, opts)
        for s in range(PEER_POINTS):
            now["t"] = t0 + s * step_ns
            donor.write_batch(ns, ids, np.full(n, now["t"], np.int64),
                              rng.standard_normal(n))
    with step("donor: tick (K1 seals)"):
        now["t"] = t0 + BLOCK_NS + 11 * MINUTE_NS
        sealed = donor.tick()["sealed"]
    check(sealed >= PEER_SHARDS, f"donor tick sealed {sealed}")
    donor.mark_bootstrapped()
    srv = NodeServer(NodeService(donor)).start()
    placement = initial_placement([Instance(id="donor", endpoint=srv.endpoint)],
                                  PEER_SHARDS, 1)
    session = Session(StaticTopology(placement), SessionOptions(timeout_s=120))
    try:
        def migrate():
            db = Database(ShardSet(PEER_SHARDS), clock=lambda: now["t"])
            db.ensure_namespace(ns, opts)
            res = bs.BootstrapProcess(chain=("peers",), ctx=bs.BootstrapContext(
                session=session, placement=placement, host_id="joiner")
            ).run(db, now_ns=now["t"])
            return db, res

        with step("joiner: peers bootstrap, warm pass"):
            db, res = migrate()
        check(res[ns].unfulfilled.is_empty(),
              f"unfulfilled after the peers bootstrap: {res[ns].unfulfilled}")
        got = sum(s.num_series() for s in db.namespace(ns).shards.values())
        check(got == n, f"migrated {got}/{n} series")
        dts = []
        for _ in range(PEER_ITERS):
            t1 = time.perf_counter()
            migrate()
            dts.append(time.perf_counter() - t1)
        with _instrumented(PEER_STEPS) as traced:
            migrate()
        _card(f"cluster (a) peer migration (config #9): {n} series x "
              f"{PEER_POINTS} points, {PEER_SHARDS} shards; runs {dts} s, "
              f"{n / min(dts)!r} series/s (best of {PEER_ITERS}); traced "
              f"run {traced['wall']!r} s: {_split_text(traced)}")
        blocks = 0
        for sid, shard in donor.namespace(ns).shards.items():
            mine = db.namespace(ns).shards[sid]
            check(mine.registry.all_ids() == shard.registry.all_ids(),
                  f"shard {sid}: the joiner's registry differs")
            check(sorted(mine.blocks) == sorted(shard.blocks),
                  f"shard {sid}: block starts differ")
            for bstart, blk in shard.blocks.items():
                check(_same_block(mine.blocks[bstart], blk),
                      f"shard {sid} block {bstart}: migrated block differs")
                blocks += 1
        with step("oracle: apply_peer_tiles against apply_peer_tiles_ref "
                  "on shard 0's tiles"):
            tiles, tags, failed = session.fetch_block_tiles_from_peers(
                ns, 0, t0, now["t"], exclude_host="joiner")
            sopts = opts.shard_options()
            sh_new, sh_ref = Shard(0, sopts), Shard(0, sopts)
            bs.apply_peer_tiles(sh_new, tiles, tags)
            bs.apply_peer_tiles_ref(sh_ref, tiles, tags)
        check(not failed and sorted(sh_new.blocks) == sorted(sh_ref.blocks)
              and all(_same_block(b, sh_ref.blocks[k])
                      for k, b in sh_new.blocks.items()),
              "apply_peer_tiles differs from apply_peer_tiles_ref")
        src = donor.namespace(ns).shards[0]
        (bstart, blk), = src.blocks.items()
        with step("mixed units: half of shard 0 re-sealed at ms ticks, "
                  "_apply_mixed_unit_rows (K2, then K1)"):
            ts, vs, npts = blk.read_all()
            half = blk.num_series // 2
            mask = np.arange(ts.shape[1]) < npts[half:, None]
            series, td, vd, cnt = to_dense(
                np.repeat(np.arange(blk.num_series - half, dtype=np.int32),
                          npts[half:]), ts[half:][mask], vs[half:][mask])
            with _time_unit(xtime.Unit.MILLISECOND):
                ms_blk = encode_block(bstart, series, td, vd, cnt)
            all_ids = src.registry.all_ids()
            row_ids = [all_ids[i] for i in blk.series_indices.tolist()]
            mixed = {bstart: [
                {"ids": row_ids[:half], "words": blk.words[:half],
                 "nbits": blk.nbits[:half], "npoints": blk.npoints[:half],
                 "window": blk.window, "time_unit": int(blk.time_unit)},
                {"ids": row_ids[half:], "words": ms_blk.words,
                 "nbits": ms_blk.nbits, "npoints": ms_blk.npoints,
                 "window": ms_blk.window,
                 "time_unit": int(ms_blk.time_unit)}]}
            check(ms_blk.time_unit != blk.time_unit,
                  "the re-sealed half kept the donor's tick scale")
            sh_mixed = Shard(0, sopts)
            bs.apply_peer_tiles(sh_mixed, mixed, {})
            m_ts, m_vs, m_np = sh_mixed.blocks[bstart].read_all()
        got_rows = {sid: (m_ts[r, :m_np[r]].tobytes(), m_vs[r, :m_np[r]]
                          .tobytes()) for r, sid in enumerate(
                              sh_mixed.registry.all_ids()[i] for i in
                              sh_mixed.blocks[bstart].series_indices.tolist())}
        want_rows = {sid: (ts[r, :npts[r]].tobytes(), vs[r, :npts[r]]
                           .tobytes()) for r, sid in enumerate(row_ids)}
        check(got_rows == want_rows, "the mixed-unit merge's reads differ "
              "from the donor's")
        phase(f"cluster (a): {n} series migrated, {blocks} blocks equal to "
              f"the donor's (series_indices, words, nbits, npoints); "
              f"apply_peer_tiles == apply_peer_tiles_ref on "
              f"{len(sh_new.blocks)} blocks of shard 0; a mixed-unit tile "
              f"of {blk.num_series} rows re-encoded at "
              f"{sh_mixed.blocks[bstart].time_unit.name} reads equal to the "
              f"donor's")
    finally:
        session.close()
        srv.close()
    donor.close()


def _barrier(session, ns: bytes, t_ns: int) -> None:
    """Every write the session has queued has reached every replica:
    one write at ALL (each host's queue is FIFO, so its acknowledgement
    follows every earlier batch on that host)."""
    import dataclasses

    from m3_tpu_torch.cluster.topology import ConsistencyLevel

    opts = session.opts
    session.opts = dataclasses.replace(
        opts, write_consistency=ConsistencyLevel.ALL)
    try:
        session.write(ns, b"barrier", t_ns, 0.0)
    finally:
        session.opts = opts


def _rf3_cluster(root: str) -> dict:
    """Phase 13 (b): a 3-node, replication-factor-3 cluster of RF3_SHARDS
    shards on the card behind fault proxies, written and read through a
    Session at MAJORITY (writes and reads). bench_promql's counter corpus
    (RF3_SERIES series, seed 11) cut to RF3_POINTS points at 10 s is
    written with tags, one write_batch a step (writes/s), the nodes
    ticked (K1), 2 more points written into the buffers; a fetch_tagged
    of every series (sealed tiles through K2, plus the buffer sidecar)
    equals each node's own Database.read; CLUSTER_QUERIES over
    SessionStorage(session) equal the same queries over node0's
    LocalStorage (the query answers' bound; K4 inside the plan graphs);
    CONCURRENT_QUERIES again from an empty plan cache while a second
    thread writes through the session; then node2 taken away through its
    FaultProxy: MAJORITY writes acknowledge, MAJORITY reads equal node0's
    reads, a read at ALL raises ConsistencyError. Returns the cluster for
    (c)."""
    import threading

    import torch

    from m3_tpu_torch.client import ConsistencyError, Session, SessionOptions
    from m3_tpu_torch.cluster.topology import (ConsistencyLevel,
                                               ReadConsistencyLevel)
    from m3_tpu_torch.index import query as iq
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel import compile as pcompile
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.storage import LocalStorage, SessionStorage
    from m3_tpu_torch.storage import block_cache
    from m3_tpu_torch.testing import promql_corpus
    from m3_tpu_torch.testing.cluster import ClusterHarness
    from m3_tpu_torch.testing.faultnet import FaultPlan
    from m3_tpu_torch.utils import hbm

    step = _Steps("cluster (b)")
    ns = b"default"
    series, t_full = promql_corpus(RF3_SERIES, RF3_SEED)
    t = t_full[:RF3_POINTS]
    sids = list(series)
    tags = [series[s]["tags"] for s in sids]
    vals = np.stack([series[s]["v"][:RF3_POINTS] for s in sids], axis=1)
    h = ClusterHarness(n_nodes=3, replica_factor=3, num_shards=RF3_SHARDS,
                       start_ns=int(t[0]), data_root=root,
                       fault_plan=FaultPlan())
    session = Session(h.topology, SessionOptions(
        write_consistency=ConsistencyLevel.MAJORITY,
        read_consistency=ReadConsistencyLevel.MAJORITY, timeout_s=120))
    cluster = {"harness": h, "session": session, "ns": ns, "t": t,
               "series": series}
    n_dp = RF3_SERIES * RF3_POINTS
    with step(f"write {RF3_SERIES} x {RF3_POINTS} with tags through "
              f"Session.write_batch (MAJORITY; K3 on each node)"):
        t1 = time.perf_counter()
        for k in range(RF3_POINTS):
            h.clock.now_ns = int(t[k])
            session.write_batch(ns, sids, np.full(RF3_SERIES, t[k]), vals[k],
                                tags)
        w_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        _barrier(session, ns, int(t[-1]))
        b_s = time.perf_counter() - t1
    _card(f"cluster (b) writes: {n_dp} datapoints ({3 * n_dp} replica "
          f"writes) acknowledged at MAJORITY in {w_s!r} s: {n_dp / w_s!r} "
          f"datapoints/s; the ALL barrier after them {b_s!r} s")
    with step("tick all nodes (K1 seals)"):
        h.clock.advance(BLOCK_NS + 11 * MINUTE_NS)
        h.tick_all()
    now = h.clock.now_ns
    with step("2 more points into the buffers"):
        for k in (1, 0):
            session.write_batch(ns, sids, np.full(RF3_SERIES, now - k * 10**9),
                                vals[-1] + 10 * (2 - k), tags)
        _barrier(session, ns, now)
    budget = hbm.shared_budget()
    cache = block_cache.get_cache()
    _card(f"cluster (b) residency: 3 replicas, {cache.resident_bytes()} "
          f"bytes in the block cache; budget total {budget.total()} of "
          f"{budget.limit} bytes; torch.cuda.memory_allocated() "
          f"{torch.cuda.memory_allocated()} bytes")
    q_all = iq.TermQuery(b"__name__", b"bench_metric")
    end = now + 1
    with step("fetch_tagged of every series (tiles through K2)"):
        got = session.fetch_tagged(ns, q_all, 0, end)
    check(sorted(got) == sorted(sids), f"fetch_tagged gave {len(got)} series")
    for host, node in sorted(h.nodes.items()):
        with step(f"{host}: Database.read of every series"):
            for sid in sids:
                rt, rv = node.db.read(ns, sid, 0, end)
                e = got[sid]
                check(rt.tobytes() == e["t"].tobytes()
                      and np.asarray(rv, np.float64).tobytes()
                      == e["v"].tobytes() and len(rt) == RF3_POINTS + 2,
                      f"{host} {sid!r}: fetch_tagged differs from the read")
    start, q_end = int(t[0]), now
    local = LocalStorage(h.nodes["node0"].db, ns)
    want = {}
    for q in CLUSTER_QUERIES:
        want[q] = Engine(local).execute_range(q, start, q_end, STEP_NS)
    remote = Engine(SessionStorage(session, ns))
    before = wk.window_stat.launches
    # Phase 14 (g) holds a run_clustered coordinator to these answers.
    cluster["answers"] = {}
    cluster["range"] = (start, q_end)
    with step(f"{len(CLUSTER_QUERIES)} queries over SessionStorage"):
        for q in CLUSTER_QUERIES:
            blk = remote.execute_range(q, start, q_end, STEP_NS)
            cluster["answers"][q] = blk
            route = remote.last_route()["route"]
            rel, ab = _check_query(q, blk, want[q], "SessionStorage against "
                                   "node0's LocalStorage")
            same = (np.asarray(blk.values).tobytes()
                    == np.asarray(want[q].values).tobytes())
            _card(f"cluster (b) {q}: route {route}, {blk.values.shape}, max "
                  f"rel {rel!r}, abs {ab!r}, bit-equal {same}")
    window = wk.window_stat.launches - before
    check(window > 0, "the window kernel did not launch for the queries over "
          "SessionStorage")
    writes = {"n": 0}
    stop = threading.Event()
    errors = []

    side = [b"bench_side{i=%d}" % j for j in range(20)]

    def writer():
        # 20 side series, one point each every 10 ms or so: a steady
        # write load through every node's write path (K3) while the
        # queries capture, not a flood that starves them of the GIL.
        k = 0
        try:
            while not stop.wait(0.01):
                session.write_batch(ns, side, np.full(20, now + k * 1000),
                                    np.full(20, float(k)),
                                    [{b"__name__": b"bench_side"}] * 20)
                writes["n"] += 20
                k += 1
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    pcompile.clear()
    th = threading.Thread(target=writer)
    with step(f"{len(CONCURRENT_QUERIES)} queries from an empty plan cache "
              f"(a capture each) while a second thread writes"):
        th.start()
        try:
            for q in CONCURRENT_QUERIES:
                blk = remote.execute_range(q, start, q_end, STEP_NS)
                _check_query(q, blk, want[q], "under concurrent writes")
                check(remote.last_route()["route"] == "compiled",
                      f"{q}: route {remote.last_route()}")
        finally:
            stop.set()
            th.join()
    check(not errors and writes["n"] > 0,
          f"the concurrent writer: {writes['n']} writes, errors {errors}")
    _card(f"cluster (b) concurrent: {len(CONCURRENT_QUERIES)} captures and "
          f"queries equal while {writes['n']} datapoints were written")
    pcompile.clear()
    h.nodes["node2"].proxy.plan = FaultPlan(refuse=1.0, reset=1.0)
    with step("node2 away: MAJORITY write of 1,000 points"):
        part = sids[:1000]
        session.write_batch(ns, part, np.full(1000, now + 10**9),
                            np.full(1000, 7.0), tags[:1000])
    with step("node2 away: MAJORITY fetch_tagged against node0's reads"):
        got = session.fetch_tagged(ns, q_all, 0, end + 10**9)
        node0 = h.nodes["node0"].db
        for sid in sids[::10]:
            rt, rv = node0.read(ns, sid, 0, end + 10**9)
            check(rt.tobytes() == got[sid]["t"].tobytes()
                  and np.asarray(rv, np.float64).tobytes()
                  == got[sid]["v"].tobytes(),
                  f"{sid!r}: a read with node2 away differs from node0's")
    check(all(len(got[s]["t"]) == RF3_POINTS + 3 for s in part),
          "a MAJORITY write with node2 away is missing")
    strict = Session(h.topology, SessionOptions(
        read_consistency=ReadConsistencyLevel.ALL, timeout_s=10))
    try:
        try:
            strict.fetch_tagged(ns, q_all, 0, end)
            check(False, "a read at ALL with node2 away did not raise")
        except ConsistencyError as err:
            _card(f"cluster (b) node2 away: a read at ALL raised "
                  f"ConsistencyError ({str(err)[:120]})")
    finally:
        strict.close()
    h.nodes["node2"].proxy.plan = FaultPlan()
    phase(f"cluster (b): {n_dp} datapoints written at MAJORITY; every "
          f"series' fetch_tagged equal to each node's reads; "
          f"{len(CLUSTER_QUERIES)} queries over SessionStorage equal to "
          f"LocalStorage ({window} window launches); concurrent captures "
          f"and writes; quorum with node2 away")
    return cluster


def _repair_divergence(cluster: dict) -> None:
    """Phase 13 (c): one value of one series overwritten on node0's sealed
    block (read_all, change, re-encode through K1, install): node0's
    replica diverges. A ShardRepairer over a fresh Session heals it (the
    peers' tiles through K2, the rebuilt block through K1): after the
    repair the three nodes' rows of that block are equal and the series
    reads back bit for bit."""
    from m3_tpu_torch.client import Session, SessionOptions
    from m3_tpu_torch.storage import block_cache
    from m3_tpu_torch.storage.block import encode_block
    from m3_tpu_torch.storage.buffer import to_dense
    from m3_tpu_torch.storage.repair import ShardRepairer

    step = _Steps("cluster (c)")
    h, ns, t = cluster["harness"], cluster["ns"], cluster["t"]
    sid = next(iter(cluster["series"]))
    node0 = h.nodes["node0"].db
    shard_id = node0.shard_set.lookup(sid)
    shard = node0.namespace(ns).shards[shard_id]
    bstart = (int(t[0]) // BLOCK_NS) * BLOCK_NS
    with step("diverge node0: overwrite one value, re-encode (K1)"):
        blk = shard.blocks[bstart]
        ts, vs, npts = blk.read_all()
        vs = np.array(vs)
        vs[blk.row_of(shard.registry.get(sid)), 4] += 1000.0
        mask = np.arange(ts.shape[1]) < npts[:, None]
        series_i, td, vd, cnt = to_dense(
            np.repeat(blk.series_indices, npts), ts[mask], vs[mask])
        bad = encode_block(bstart, series_i, td, vd, cnt)
        with shard.write_lock:
            block_cache.get_cache().invalidate_block(blk)
            shard.blocks[bstart] = bad
    session = Session(h.topology, SessionOptions(timeout_s=60))
    try:
        with step("ShardRepairer.repair_shard (K2 tiles, K1 rebuild)"):
            stats = ShardRepairer(session, host_id="node0").repair_shard(
                node0.namespace(ns), shard_id, bstart, bstart + BLOCK_NS)
    finally:
        session.close()
    check(stats.checksum_mismatches == 1 and stats.blocks_rebuilt == 1
          and stats.peer_errors == 0 and stats.rows_unfetched == 0,
          f"repair stats {stats}")

    def rows(db):
        sh = db.namespace(ns).shards[shard_id]
        b = sh.blocks[bstart]
        all_ids = sh.registry.all_ids()
        return {all_ids[i]: (np.asarray(b.words[r]).tobytes(),
                             int(b.nbits[r]), int(b.npoints[r]))
                for r, i in enumerate(b.series_indices.tolist())}

    healed = rows(node0)
    for host in ("node1", "node2"):
        check(rows(h.nodes[host].db) == healed,
              f"after the repair node0's rows differ from {host}'s")
    end = h.clock.now_ns + 1
    a = node0.read(ns, sid, 0, end)
    b = h.nodes["node1"].db.read(ns, sid, 0, end)
    check(a[0].tobytes() == b[0].tobytes()
          and np.asarray(a[1], np.float64).tobytes()
          == np.asarray(b[1], np.float64).tobytes(),
          "the healed series reads differently from node1's")
    phase(f"cluster (c): the diverged replica healed ({stats}); all three "
          f"nodes' rows of shard {shard_id}'s block equal, the series "
          f"reads back bit for bit")


# ---------------------------------------------------------------------------
# Phase 14: the coordinator
# ---------------------------------------------------------------------------

# An embedded coordinator (run_embedded over Database(ShardSet(16)) with
# the index, M3's documented single-node deployment) driven over HTTP on
# 127.0.0.1. (a) bench_query_serve_e2e's corpus (bench.py:1574-1712):
# 10,000 counters x 240 points at 10 s over 200 hosts, seed 61, as
# snappy protobuf remote writes of COORD_REQUEST (series, points) each;
# (b) the bench's serve mix; (c) phase 9's carbon shape, CARBON_POINTS_14
# points; (d) bench_downsample_rules' corpus (bench.py:1843-2017) at
# DS_METRICS metrics, 800 + 1 mapping and 200 rollup rules, its oracle on
# the first DS_ORACLE metrics; (e) two recording rules and an alert rule
# for sum(COORD_RULE_ROUNDS) steps.
COORD_SERIES, COORD_HOSTS, COORD_SEED = 10_000, 200, 61
COORD_REQUEST = (500, 24)
SERVE_ROUNDS, SERVE_THREADS = 3, 4   # rounds cut from 6 (PERF.md §4)
SERVE_MIX = (
    ("rate_matrix", "rate(bench_requests[5m])", False),
    ("max_over_time_matrix", "max_over_time(bench_requests[10m])", False),
    ("sum_by_host", "sum by (host) (rate(bench_requests[5m]))", False),
    ("instant_vector", "sum by (host) (bench_requests)", True),
)
CARBON_POINTS_14 = 15
CARBON_TARGETS_14 = ("sumSeries(bench.*.metric*)",
                     "movingAverage(bench.host*.metric0, '5min')",
                     "groupByNode(bench.*.metric1, 1, 'sum')",
                     "highestCurrent(bench.host*.metric0, 5)")
# DS_METRICS cut from the bench's 100,000 for the script's time (PERF.md §4).
DS_METRICS, DS_MAPPING, DS_ROLLUP, DS_ORACLE = 50_000, 800, 200, 4_000
COORD_RULE_ROUNDS = (1, 4)   # steps a round (a first round evaluates one)
# (e) runs after this many of (a)'s chunks of COORD_REQUEST[1] points (at
# t[23]): standing rules evaluate as the data arrives, and every buffered
# series read then scans a shorter buffer.
RULES_AFTER_CHUNKS = 1
COORD_RECORDS = ("sum by (host) (rate(bench_requests[5m]))",
                 "max_over_time(bench_requests[5m])")
# The alert watches what the second recording rule records, so a round
# fetches two expressions, not three.
COORD_ALERT = ("max_over_time(bench_requests[5m])", ">", 2.5e9)


def _http(url: str, body=None):
    """(status, bytes) of a GET, or of a POST of a protobuf body; an
    error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=body, method="GET" if body is None else "POST",
        headers={} if body is None else {
            "Content-Type": "application/x-protobuf"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _serve_url(base: str, t, shape) -> str:
    """The bench's request of one mix shape: the matrices from t[60] to
    t[-1] at step 30 s, the instant vector at t[-1]."""
    import urllib.parse

    _name, q, instant = shape
    if instant:
        return (f"{base}/api/v1/query?" + urllib.parse.urlencode(
            {"query": q, "time": int(t[-1]) / 1e9}))
    return (f"{base}/api/v1/query_range?" + urllib.parse.urlencode(
        {"query": q, "start": int(t[60]) / 1e9, "end": int(t[-1]) / 1e9,
         "step": "30"}))


def _coordinator_phase() -> dict:
    """Phase 14: the coordinator on the card, over real HTTP. The steps
    run in this order: (a) the remote write, with (e) the rules engine
    between its chunks (the rules' outputs must land inside the buffer's
    acceptance window), (a) the seal, (b) the serve mix (each shape
    first on this thread: the cold reads and the plan captures), the
    read-backs of (a) and (e), (c) carbon and Graphite, (d) the
    downsampler, (f) a compute
    error answered 503 ((g), run_clustered, runs inside phase 13 while
    its cluster is up). Returns the kernels' launches over the phase
    (the counts set to 0 just before it)."""
    import gc

    import torch

    from m3_tpu_torch.cluster.kv import MemStore
    from m3_tpu_torch.coordinator import run_embedded
    from m3_tpu_torch.index.namespace_index import NamespaceIndex
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel import compile as pcompile
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions
    from m3_tpu_torch.testing import serve_corpus

    series, t = serve_corpus(COORD_SERIES, COORD_HOSTS, COORD_SEED)
    now = {"t": int(t[0])}
    clock = lambda: now["t"]  # noqa: E731
    pols = {StoragePolicy.parse("1m:40h"): b"agg_1m",
            StoragePolicy.parse("5m:40h"): b"agg_5m"}
    b0 = time.perf_counter()
    chunks = _remote_write_bodies(series, t)
    build_s = time.perf_counter() - b0
    pcompile.clear()
    # The earlier phases' live objects leave the collector's scans, as in
    # a coordinator process of its own.
    gc.collect()
    gc.freeze()
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = Database(ShardSet(num_shards=16), clock=clock)
    for ns in (b"default", *pols.values()):
        db.create_namespace(ns, NamespaceOptions(),
                            index=NamespaceIndex(clock=clock))
    kv = MemStore()
    coord = run_embedded(db, kv_store=kv, aggregated_namespaces=pols,
                         clock=clock)
    try:
        recorded = {}
        _coord_remote_write(
            coord, chunks, build_s, series, t, now,
            lambda k: recorded.update(
                _coord_rules(coord, db, series, t[:k + 1], now)))
        _coord_seal(db, now, t)
        serial = _coord_serve(coord, series, t)
        _coord_read_back(coord, db, series, t, recorded)
        _coord_carbon(coord, db, now)
        _coord_downsample(coord, db, kv, pols, now)
        _coord_compute_error(coord, t, serial)
    finally:
        coord.close()
        db.close()
        gc.unfreeze()
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
    secs = time.perf_counter() - t0
    pcompile.clear()
    torch.cuda.empty_cache()
    _card(f"coordinator: phase 14 in {secs!r} s, launches {launches}")
    check(all(launches[k] > 0 for k in ("pack", "decode", "hash", "window")),
          f"phase 14 did not launch every kernel: {launches}")
    return launches


def _remote_write_bodies(series, t):
    """The corpus as snappy WriteRequest bodies of COORD_REQUEST (series,
    points), chunk by chunk in time order, through promremote's
    encode_write_request: [(last timestamp of the chunk, [(body,
    samples), ...]), ...]. Built before the phase clock starts: encoding
    the 2.4 M samples is the sender's work, not the coordinator's."""
    from m3_tpu_torch.coordinator import promremote as pr

    per, pts = COORD_REQUEST
    sids = list(series)
    t_ms = (t // 1_000_000).tolist()
    chunks = []
    for k0 in range(0, len(t), pts):
        k1 = min(k0 + pts, len(t))
        bodies = []
        for g0 in range(0, len(sids), per):
            group = sids[g0:g0 + per]
            req = [(series[s]["tags"],
                    list(zip(t_ms[k0:k1], series[s]["v"][k0:k1].tolist())))
                   for s in group]
            bodies.append((pr.snappy_compress(pr.encode_write_request(req)),
                           len(group) * (k1 - k0)))
        chunks.append((int(t[k1 - 1]), bodies))
    return chunks


def _coord_remote_write(coord, chunks, build_s, series, t, now,
                        rules) -> None:
    """(a) The corpus as snappy protobuf WriteRequests of COORD_REQUEST
    (series, points) each, in time order (the clock at each chunk's last
    point), to /api/v1/prom/remote/write: one
    DownsamplerAndWriter.write_request a request, one K3 routing a
    request. Samples/s over the posts, and
    the decode's share: the handler's promremote.snappy_decompress and
    decode_write_request, timed where they run. After
    RULES_AFTER_CHUNKS chunks, rules(index of the last point written)
    runs (e), outside the timed posts."""
    from m3_tpu_torch.coordinator import promremote

    step = _Steps("coordinator (a)")
    pts = COORD_REQUEST[1]
    n = len(series) * len(t)
    n_req = sum(len(b) for _, b in chunks)
    wire = sum(len(x) for _, b in chunks for x, _n in b)
    url = coord.endpoint + "/api/v1/prom/remote/write"
    decode = {"s": 0.0}
    real = {name: getattr(promremote, name)
            for name in ("snappy_decompress", "decode_write_request")}

    def timed(fn):
        def call(*a, **kw):
            d0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                decode["s"] += time.perf_counter() - d0
        return call

    post_s = 0.0
    for name, fn in real.items():
        setattr(promremote, name, timed(fn))
    try:
        with step(f"{n_req} remote-write requests, {n} samples (and (e))"):
            for c, (t_last, bodies) in enumerate(chunks):
                if c == RULES_AFTER_CHUNKS:
                    rules(c * pts - 1)
                now["t"] = t_last
                w0 = time.perf_counter()
                for body, n_body in bodies:
                    code, out = _http(url, body)
                    check(code == 200 and json.loads(out)["wrote"] == n_body,
                          f"remote write answered {code}: {out[:200]!r}")
                post_s += time.perf_counter() - w0
    finally:
        for name, fn in real.items():
            setattr(promremote, name, fn)
    _card(f"coordinator (a) remote write: {n} samples in {n_req} requests "
          f"({wire} bytes snappy; encoded before the phase in {build_s!r} "
          f"s) in {post_s!r} s: "
          f"{n / post_s!r} samples/s; the handlers' snappy + protobuf "
          f"decode {decode['s']!r} s ({decode['s'] / post_s * 100!r}% of "
          f"the posts)")


def _coord_rules(coord, db, series, t, now) -> dict:
    """(e) Coordinator.rules_engine(): two recording rules (a grouped rate
    sum; max_over_time, K4 inside its plan graph) and one alert rule over
    the corpus written so far (`t`, its grid up to now), the steps of
    COORD_RULE_ROUNDS at 30 s ending at its last point;
    the recorded rows go back through the coordinator's
    DownsamplerAndWriter.write_batch (K3). The same rounds on
    Engine(DictStorage of the same points, device="cpu") with a sink:
    the rows the card wrote (read back from the store) within the rules
    answers' bounds (PERF.md §2) of the CPU's, transitions equal as
    sets. Returns the CPU's rows, {(tags, time): value}, for the read
    over HTTP after the seal."""
    import torch

    from m3_tpu_torch.coordinator.rules_engine import (AlertRule,
                                                       RecordingRule,
                                                       RulesEngine)
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.model import METRIC_NAME, Matcher, MatchType
    from m3_tpu_torch.query.storage import LocalStorage
    from m3_tpu_torch.testing import DictStorage

    written = DictStorage({s: dict(e, t=t, v=e["v"][:len(t)])
                           for s, e in series.items()})
    n_steps = sum(COORD_RULE_ROUNDS)
    clocks = [int(t[-1]) - (n_steps - int(j)) * STEP_NS
              for j in np.cumsum(COORD_RULE_ROUNDS)]
    recs = [RecordingRule(b"coord:%d" % i, q, labels=((b"rule", b"r%d" % i),))
            for i, q in enumerate(COORD_RECORDS)]
    alert = AlertRule(b"coord:hot", *COORD_ALERT)
    cpu_rows = []
    engines = {"card": coord.rules_engine(step_ns=STEP_NS),
               "cpu": RulesEngine(Engine(written, device="cpu"),
                                  cpu_rows.extend, step_ns=STEP_NS)}
    for re in engines.values():
        for r in recs:
            re.add_recording(r)
        re.add_alert(alert)
    rounds = {"card": [], "cpu": []}
    for c in clocks:
        now["t"] = c
        for who, re in engines.items():
            torch.cuda.synchronize()
            r0 = time.perf_counter()
            res = re.evaluate(c)
            torch.cuda.synchronize()
            rounds[who].append(((time.perf_counter() - r0) * 1e3, res))
    for (_, a), (_, b) in zip(rounds["card"], rounds["cpu"]):
        check((a.steps, a.exprs_evaluated, a.recorded_rows) ==
              (b.steps, b.exprs_evaluated, b.recorded_rows),
              f"coordinator (e): round differs: {a} against {b}")
        check({(x.rule, x.series, x.kind, x.time_nanos) for x in
               a.transitions} == {(x.rule, x.series, x.kind, x.time_nanos)
                                  for x in b.transitions},
              "coordinator (e): the card's transitions differ from the CPU's")
    key = lambda r: (tuple(sorted(r[0].items())), r[1])  # noqa: E731
    ck_ = {key(r): r[2] for r in cpu_rows}
    gk = {}
    store = LocalStorage(db, b"default")
    for i in range(len(COORD_RECORDS)):
        got = store.fetch_raw([Matcher(MatchType.EQUAL, METRIC_NAME,
                                       b"coord:%d" % i)], 0, now["t"] + 1)
        for e in got.values():
            for tt, v in zip(e["t"].tolist(), e["v"].tolist()):
                gk[key((e["tags"], tt, v))] = v
    check(gk.keys() == ck_.keys() and len(gk) > 0,
          "coordinator (e): recorded rows differ in keys")
    worst = 0.0
    for i, q in enumerate(COORD_RECORDS):
        keys = [k for k in ck_ if dict(k[0])[b"__name__"] == b"coord:%d" % i]
        a = np.array([gk[k] for k in keys])
        b = np.array([ck_[k] for k in keys])
        tol = _plan_tol(q, b)
        check(bool(np.allclose(a, b, equal_nan=True, **tol)),
              f"coordinator (e): recorded {q} beyond {tol}")
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
            np.abs(b), 1e-30))))
    n_trans = sum(len(r.transitions) for _, r in rounds["card"])
    check(n_trans > 0, "coordinator (e): no transition")
    steps = [r.steps for _, r in rounds["card"]]
    check(steps == list(COORD_RULE_ROUNDS), f"rule steps {steps}")
    _card(f"coordinator (e) rules: {steps} steps a round, card ms "
          f"{[round(ms, 3) for ms, _ in rounds['card']]}, CPU ms "
          f"{[round(ms, 3) for ms, _ in rounds['cpu']]}; {len(gk)} "
          f"recorded rows written back and read from the store (max rel "
          f"diff to the CPU {worst!r}), {n_trans} transitions (equal sets)")
    return ck_


def _coord_seal(db, now, t) -> None:
    """(a) The clock past the block's end and buffer_past: the node ticks
    and seals (K1)."""
    step = _Steps("coordinator (a)")
    now["t"] = int(t[-1]) - int(t[-1]) % BLOCK_NS + BLOCK_NS + 11 * MINUTE_NS
    with step("tick: seal (K1)"):
        sealed = db.tick()["sealed"]
    check(sealed >= 16, f"tick sealed {sealed} blocks")
    _card(f"coordinator (a) seal: {sealed} blocks")


def _coord_read_back(coord, db, series, t, recorded) -> None:
    """(a) 200 series read back from the sealed blocks equal to the
    corpus bit for bit; (e) the recorded grouped rate sum, sealed now,
    over /api/v1/query_range: every (host, time) cell the CPU's rounds
    recorded, within the rules answers' bounds."""
    import urllib.parse

    from m3_tpu_torch.metrics import id as metric_id

    for s in list(series)[::50]:
        e = series[s]
        tags = {k: v for k, v in e["tags"].items() if k != b"__name__"}
        sid = metric_id.encode(e["tags"][b"__name__"], tags)
        rt, rv = db.read(b"default", sid, int(t[0]), int(t[-1]) + 1)
        check(rt.tobytes() == t.tobytes() and np.asarray(
            rv, np.float64).tobytes() == e["v"].tobytes(),
            f"{sid!r}: the stored series differs from what was written")
    _card("coordinator (a) 200 series read back from the sealed blocks bit "
          "for bit")

    want = {(dict(k[0])[b"host"].decode(), k[1]): v
            for k, v in recorded.items()
            if dict(k[0])[b"__name__"] == b"coord:0"}
    times = sorted({tt for _h, tt in want})
    q = urllib.parse.urlencode({
        "query": 'coord:0{rule="r0"}', "start": times[0] / 1e9,
        "end": times[-1] / 1e9, "step": "30"})
    code, body = _http(f"{coord.endpoint}/api/v1/query_range?{q}")
    check(code == 200, f"recorded series over HTTP: {code}")
    got = {(r["metric"]["host"], round(float(tt) * 1e9)): float(v)
           for r in json.loads(body)["data"]["result"]
           for tt, v in r["values"]}
    check(got.keys() == want.keys(), f"recorded series over HTTP: "
          f"{len(got)} cells, {len(want)} recorded")
    exp = np.array([want[k] for k in want])
    tol = _plan_tol(COORD_RECORDS[0], exp)
    check(bool(np.allclose([got[k] for k in want], exp, **tol)),
          f"recorded series over HTTP beyond {tol}")
    _card(f"coordinator (e) the recorded {COORD_RECORDS[0]!r}: {len(got)} "
          f"cells over HTTP from the sealed block, equal to the CPU's "
          f"rounds")


def _coord_serve(coord, series, t) -> dict:
    """(b) The bench's serve mix against the sealed data. On this thread
    first, each shape once through the coordinator's engine (the cold
    reads and the plan captures) and through Engine(DictStorage of the
    same corpus, device="cpu"): within the compiled route's bounds; its
    render_result_ref bytes are what every HTTP response of the shape
    must equal. Then over HTTP: SERVE_ROUNDS rounds (p50, p99 and wire
    bytes a shape; every request a replay), one traced round (the card's
    busy share), and SERVE_THREADS threads sending the instant vector at
    once (one executable replayed from every thread). Returns the
    expected bytes by shape."""
    import threading

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel import compile as pcompile
    from m3_tpu_torch.query import render
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.testing import DictStorage

    base = coord.endpoint
    step = _Steps("coordinator (b)")

    def replays():
        return sum(exe.replays for _k, exe in pcompile.executables())

    before = dict(ck.launch_counts(), window=wk.window_stat.launches)
    r_before = replays()
    eng, cpu = coord.engine, Engine(DictStorage(series), device="cpu")
    start, end = int(t[60]), int(t[-1])
    serial, rels, routes = {}, {}, {}
    v0 = time.perf_counter()
    for name, q, instant in SERVE_MIX:
        if instant:
            blk = eng.execute_instant(q, end)
            ref = cpu.execute_instant(q, end)
        else:
            blk = eng.execute_range(q, start, end, STEP_NS)
            ref = cpu.execute_range(q, start, end, STEP_NS)
        routes[name] = eng.last_route()["route"]
        serial[name] = render.render_result_ref(blk, instant=instant)
        rels[name] = _check_plan(q, blk, ref, "coordinator (b) against the "
                                 "CPU")
    verify_s = time.perf_counter() - v0
    walls = {s[0]: [] for s in SERVE_MIX}
    with step(f"{SERVE_ROUNDS} timed rounds"):
        for _ in range(SERVE_ROUNDS):
            for shape in SERVE_MIX:
                r0 = time.perf_counter()
                code, body = _http(_serve_url(base, t, shape))
                walls[shape[0]].append(time.perf_counter() - r0)
                check(code == 200 and body == serial[shape[0]],
                      f"{shape[0]}: {code}, the response differs from "
                      f"render_result_ref of the engine's answer")
    with step("a traced round"), _instrumented({}) as traced:
        for shape in SERVE_MIX:
            _http(_serve_url(base, t, shape))
    after = dict(ck.launch_counts(), window=wk.window_stat.launches)
    moved = {k: after[k] - before[k] for k in after}
    n_replays = replays() - r_before
    for name, _q, _i in SERVE_MIX:
        p50 = float(np.percentile(walls[name], 50)) * 1e3
        p99 = float(np.percentile(walls[name], 99)) * 1e3
        _card(f"coordinator (b) {name}: p50 {p50!r} ms, p99 {p99!r} ms of "
              f"{len(walls[name])} requests (one a round, so the p99 is "
              f"near their largest), {len(serial[name])} wire bytes, "
              f"route {routes[name]}, max rel diff to the CPU "
              f"{rels[name]!r}")
    answers, errors = [], []

    def client():
        try:
            answers.append(_http(_serve_url(base, t, SERVE_MIX[3]))[1])
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    c0 = time.perf_counter()
    threads = [threading.Thread(target=client)
               for _ in range(SERVE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    conc_s = time.perf_counter() - c0
    check(not errors and len(answers) == SERVE_THREADS,
          f"concurrent clients: {errors}")
    check(all(body == serial[SERVE_MIX[3][0]] for body in answers),
          "a concurrent client's answer differs from the serial one")
    n_req = SERVE_ROUNDS * len(SERVE_MIX)
    total = sum(sum(w) for w in walls.values())
    _card(f"coordinator (b) serve mix: {n_req / total!r} responses/s over "
          f"{n_req} requests, {sum(len(b) for b in serial.values())} wire "
          f"bytes a round; launches {moved}, plan graph replays "
          f"{n_replays}; the traced round: {_split_text(traced)}; the "
          f"engine's first runs (cold reads, captures), render_result_ref "
          f"and the CPU's answers {verify_s!r} s; {SERVE_THREADS} threads' "
          f"{SERVE_MIX[3][0]} at once in {conc_s!r} s, equal to the "
          f"serial answer")
    check(moved["decode"] > 0 and moved["window"] > 0 and n_replays > 0,
          f"coordinator (b): K2 {moved['decode']}, K4 {moved['window']}, "
          f"replays {n_replays}")
    return serial


def _coord_carbon(coord, db, now) -> None:
    """(c) phase 9's carbon shape (CARBON_HOSTS x CARBON_METRICS paths, seed
    29) at CARBON_POINTS_14 points at 10 s, as plaintext lines through
    the coordinator's carbon listener (one write a line); then
    CARBON_TARGETS_14 over /api/v1/graphite/render and two finds: each
    render equal (names, timestamps, null cells; values within rtol
    1e-5, atol 1e-8) to GraphiteEngine over the same LocalStorage on the
    card and on the CPU; the finds list every child."""
    import socket
    import urllib.parse

    from m3_tpu_torch.coordinator.carbon_ingest import CarbonServer
    from m3_tpu_torch.query.graphite import GraphiteEngine, series_name
    from m3_tpu_torch.query.storage import LocalStorage

    step = _Steps("coordinator (c)")
    end_s = now["t"] // 10**9
    base_s = end_s - 10 * (CARBON_POINTS_14 - 1)
    tc = (base_s + 10 * np.arange(CARBON_POINTS_14, dtype=np.int64)) * 10**9
    corpus = _carbon_corpus(tc)
    lines = b"".join(
        b"%s %r %d\n" % (path, v, ts // 10**9)
        for path, e in corpus.items() for ts, v in zip(tc.tolist(),
                                                       e["v"].tolist()))
    n = len(corpus) * CARBON_POINTS_14
    now["t"] = int(tc[-1])
    srv = CarbonServer(coord.writer).start()
    try:
        host, port = srv.endpoint.rsplit(":", 1)
        with step(f"{n} carbon lines through the listener"):
            c0 = time.perf_counter()
            with socket.create_connection((host, int(port))) as sock:
                sock.sendall(lines)
            deadline = time.perf_counter() + 300
            while (srv.lines_ingested + srv.lines_malformed < n
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
            carbon_s = time.perf_counter() - c0
    finally:
        srv.close()
    check(srv.lines_ingested == n and srv.lines_malformed == 0,
          f"carbon: {srv.lines_ingested} ingested, {srv.lines_malformed} "
          f"malformed of {n}")
    storage = LocalStorage(db, b"default")
    card = GraphiteEngine(storage)
    cpu = GraphiteEngine(storage, device="cpu")
    for target in CARBON_TARGETS_14:
        r0 = time.perf_counter()
        code, body = _http(f"{coord.endpoint}/api/v1/graphite/render?"
                           + urllib.parse.urlencode(
                               {"target": target, "from": base_s,
                                "until": end_s, "step": "10"}))
        http_s = time.perf_counter() - r0
        check(code == 200, f"{target}: {code} {body[:200]!r}")
        got = json.loads(body)
        for eng, who in ((card, "the card"), (cpu, "the CPU")):
            blk = eng.render(target, base_s * 10**9, end_s * 10**9,
                             10 * 10**9)
            check([s["target"] for s in got]
                  == [series_name(x).decode() for x in blk.series_tags],
                  f"{target}: names differ from {who}'s render")
            times = (blk.meta.times() // 10**9).tolist()
            vals = np.asarray(blk.values, np.float64)
            for s, row in zip(got, vals):
                check([p[1] for p in s["datapoints"]] == times,
                      f"{target}: timestamps differ from {who}'s")
                gv = np.array([np.nan if p[0] is None else p[0]
                               for p in s["datapoints"]])
                check(bool((np.isnan(gv) == ~np.isfinite(row)).all())
                      and bool(np.allclose(gv, row, rtol=1e-5, atol=1e-8,
                                           equal_nan=True)),
                      f"{target}: values differ from {who}'s render")
        _card(f"coordinator (c) render {target!r}: {len(got)} series in "
              f"{http_s!r} s over HTTP, equal to the card's and the CPU's")
    for query, want in (("bench.*", CARBON_HOSTS),
                        ("bench.host7.*", CARBON_METRICS)):
        code, body = _http(f"{coord.endpoint}/api/v1/graphite/find?"
                           + urllib.parse.urlencode(
                               {"query": query, "from": base_s}))
        found = json.loads(body)
        check(code == 200 and len(found) == want,
              f"find {query}: {code}, {len(found)} of {want}")
    _card(f"coordinator (c) carbon: {n} lines in {carbon_s!r} s "
          f"({n / carbon_s!r} lines/s); {len(CARBON_TARGETS_14)} renders "
          f"and 2 finds equal")


def _coord_downsample(coord, db, kv, pols, now) -> None:
    """(d) bench_downsample_rules' corpus (testing.rules_corpus: DS_METRICS
    metrics, DS_MAPPING + 1 mapping rules with the DROP_MUST class,
    DS_ROLLUP rollup rules), its samples timed at the current clock, the
    rule set published through the KV RuleSetStore the coordinator's
    Matcher watches. A cold and a warm pass through
    DownsamplerAndWriter.write_batch (one call per metric type, the
    downsampling leg alone, as the bench times the Downsampler), then the
    flush 6 minutes later (every 1m and 5m window closed, inside
    buffer_past) into agg_1m and agg_5m (the timers' quantile ordering on
    the agg_flush route, the writes routed by K3). The bench's oracle:
    fresh Downsamplers on the card over the first DS_ORACLE samples,
    write_batch against write_ref: equal matched and dropped counts and
    flushed rows bit for bit. One aggregated rollup series read over
    HTTP from a coordinator on agg_1m."""
    import urllib.parse

    from m3_tpu_torch.coordinator import Downsampler, run_embedded
    from m3_tpu_torch.metrics.matcher import Matcher, RuleSetStore
    from m3_tpu_torch.metrics.metric import MetricType
    from m3_tpu_torch.testing import rules_corpus

    step = _Steps("coordinator (d)")
    rs, samples = rules_corpus(DS_METRICS, DS_MAPPING, DS_ROLLUP)
    t_d = now["t"]
    samples = [(tags, t_d, v, mt) for tags, _t, v, mt in samples]
    store = RuleSetStore(kv)
    store.publish(rs)
    by_type = {}
    for tags, ts, v, mt in samples:
        by_type.setdefault(mt, []).append((tags, ts, v))
    check(MetricType.TIMER in by_type, "no timer in the corpus")
    ds = coord.downsampler

    def one_pass():
        m0, d0 = ds.samples_matched, ds.samples_dropped
        p0 = time.perf_counter()
        for mt, rows in by_type.items():
            coord.writer.write_batch(rows, metric_type=mt,
                                     write_unaggregated=False)
        return (time.perf_counter() - p0, ds.samples_matched - m0,
                ds.samples_dropped - d0)

    with step(f"cold pass, {DS_METRICS} metrics (the downsampling leg)"):
        cold_s, matched, dropped = one_pass()
    check(matched > 0.9 * DS_METRICS and dropped > 0,
          f"cold pass matched {matched}, dropped {dropped}")
    with step(f"warm pass, {DS_METRICS} metrics"):
        warm_s, m2, d2 = one_pass()
    check((m2, d2) == (matched, dropped), f"warm pass {m2}, {d2}")
    now["t"] = t_d + 6 * MINUTE_NS
    with step("flush into agg_1m and agg_5m (agg_flush route, K3)"):
        flushed = coord.flush_downsampler()
    check(flushed > 0, "the downsampler flushed nothing")
    sub = samples[:DS_ORACLE]
    sinks = ([], [])
    pair = []
    for sink in sinks:
        pair.append(Downsampler(
            Matcher(store, b"default", clock=lambda: t_d),
            lambda *a, _s=sink: _s.append(a), clock=lambda: now["t"]))
    now["t"] = t_d
    pair[0].write_batch(sub)
    for tags, ts, v, mt in sub:
        pair[1].write_ref(tags, ts, v, mt)
    check((pair[0].samples_matched, pair[0].samples_dropped)
          == (pair[1].samples_matched, pair[1].samples_dropped),
          "downsample oracle: counts differ")
    for d in pair:
        d.flush(t_d + 6 * MINUTE_NS)
    now["t"] = t_d + 6 * MINUTE_NS

    def rows(sink):
        return sorted((m, tuple(sorted(tg.items())), tt,
                       np.float64(v).tobytes(), str(p))
                      for m, tg, tt, v, p in sink)

    check(sinks[0] and rows(sinks[0]) == rows(sinks[1]),
          f"downsample oracle: {len(sinks[0])} rows against "
          f"{len(sinks[1])}")
    agg = run_embedded(db, namespace=b"agg_1m", clock=lambda: now["t"])
    try:
        name = b"rollup_svc000"
        q = urllib.parse.urlencode({
            "query": f'{{__name__=~"{name.decode()}.*"}}',
            "start": t_d / 1e9, "end": now["t"] / 1e9, "step": "60"})
        code, body = _http(f"{agg.endpoint}/api/v1/query_range?{q}")
        res = json.loads(body)["data"]["result"] if code == 200 else []
        check(code == 200 and len(res) > 0,
              f"aggregated {name!r} over HTTP: {code}, {len(res)} series")
    finally:
        agg.close()
    _card(f"coordinator (d) downsample: {DS_METRICS} metrics against "
          f"{DS_MAPPING + 1} mapping and {DS_ROLLUP} rollup rules: cold "
          f"{DS_METRICS / cold_s!r} metrics/s ({cold_s!r} s), warm "
          f"{DS_METRICS / warm_s!r} metrics/s; matched {matched}, dropped "
          f"{dropped}; flush {flushed}; the write_ref oracle on "
          f"{DS_ORACLE}: {len(sinks[0])} rows equal bit for bit; "
          f"{len(res)} aggregated {name.decode()} series over HTTP")


def _coord_compute_error(coord, t, serial) -> None:
    """(f) One injected ComputeError on the `plan` route (the guard's
    fault seam, dispatch_raise on every draw): sum_by_host answers 503
    with errorType KernelFault; after guard.reset() the same request
    answers 200 with (b)'s bytes."""
    from m3_tpu_torch.parallel import guard
    from m3_tpu_torch.testing import faultcomp

    shape = SERVE_MIX[2]
    url = _serve_url(coord.endpoint, t, shape)
    guard.reset()
    try:
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=7, dispatch_raise=1.0, route_filter="plan")):
            code, body = _http(url)
    finally:
        guard.reset()
    err = json.loads(body)
    check(code == 503 and err.get("errorType") == "KernelFault",
          f"compute error answered {code}: {body[:200]!r}")
    code2, body2 = _http(url)
    check(code2 == 200 and body2 == serial[shape[0]],
          f"after guard.reset(): {code2}")
    _card(f"coordinator (f) compute error: 503 {err['error'][:80]!r}; after "
          f"guard.reset() 200 with (b)'s bytes")


def _clustered_coordinator(cluster: dict) -> None:
    """(g) run_clustered(session) on phase 13's 3-node RF=3 cluster before
    it stops: two of CLUSTER_QUERIES over HTTP equal phase 13 (b)'s
    answers over SessionStorage on the card: their rendered bytes, else
    within its bounds. The writes since (b) lie outside the queried
    range."""
    import urllib.parse

    from m3_tpu_torch.coordinator import run_clustered
    from m3_tpu_torch.query import render

    h, ns = cluster["harness"], cluster["ns"]
    start, end = cluster["range"]
    c = run_clustered(cluster["session"], namespace=ns, clock=h.clock)
    try:
        for q in CLUSTER_QUERIES[:1] + CLUSTER_QUERIES[-1:]:
            r0 = time.perf_counter()
            code, body = _http(f"{c.endpoint}/api/v1/query_range?"
                               + urllib.parse.urlencode(
                                   {"query": q, "start": start / 1e9,
                                    "end": end / 1e9, "step": "30"}))
            http_s = time.perf_counter() - r0
            check(code == 200, f"run_clustered {q}: {code} {body[:200]!r}")
            want = cluster["answers"][q]
            same = body == render.prom_matrix_bytes(want)
            got = json.loads(body)["data"]["result"]
            if not same:
                _check_rendered(q, got, want)
            _card(f"coordinator (g) run_clustered {q}: {len(got)} series in "
                  f"{http_s!r} s over HTTP, equal to SessionStorage's "
                  f"answer (bytes equal: {same})")
    finally:
        c.close()


def _check_rendered(q, got, want) -> None:
    """A query_range response's result list against a Block: the same
    series in order, the same timestamps and missing cells, values within
    q's bounds (_query_tol)."""
    labels = [{k.decode(): v.decode() for k, v in x.pairs}
              for x, row in zip(want.series_tags, np.asarray(want.values))
              if np.isfinite(row).any()]
    check([r["metric"] for r in got] == labels, f"{q}: series differ")
    wv = np.asarray(want.values, np.float64)
    wv = wv[np.isfinite(wv).any(axis=1)]
    col = {tt: i for i, tt in enumerate((want.meta.times() / 1e9).tolist())}
    for r, row in zip(got, wv):
        gv = np.full(len(col), np.nan)
        for tt, v in r["values"]:
            gv[col[tt]] = float(v)
        check(bool((np.isnan(gv) == ~np.isfinite(row)).all())
              and bool(np.allclose(gv, row, equal_nan=True,
                                   **_query_tol(q, row))),
              f"{q}: values differ")


def _plain_stats(vv, mm) -> dict:
    """The block moments of `vv` over its last axis where `mm`, by masked
    reductions: the plain computation the ingest step's stats are held
    to."""
    import torch

    cnt = mm.sum(-1)
    idx = torch.arange(vv.shape[-1], device=vv.device)
    last_i = torch.where(mm, idx, -1).amax(-1).clamp(min=0)
    first_i = torch.where(mm, idx, vv.shape[-1]).amin(-1).clamp(
        max=vv.shape[-1] - 1)
    z = torch.where(mm, vv, 0.0)
    mu = z.sum(-1) / cnt.clamp(min=1)
    dev = torch.where(mm, vv - mu[..., None], 0.0)
    return {
        "count": cnt.float(),
        "min": torch.where(mm, vv, float("inf")).amin(-1),
        "max": torch.where(mm, vv, float("-inf")).amax(-1),
        "last": torch.where(cnt > 0, vv.gather(-1, last_i[..., None])[..., 0], 0.0),
        "first": torch.where(cnt > 0, vv.gather(-1, first_i[..., None])[..., 0], 0.0),
        "sum": z.sum(-1), "sumsq": (z * z).sum(-1), "m2": (dev * dev).sum(-1),
    }


def _hold_stats(got: dict, want: dict, what: str) -> None:
    """count/min/max/last/first identical; sum, sumsq and m2 within
    bench.py's reduction-reorder bound |err| <= 2 n eps L1 (eps = 2^-23,
    L1 per plane), m2's bound with the first- and second-order effect of
    the mean's shift, as bench.py has it."""
    import torch

    for key in ("count", "min", "max", "last", "first"):
        check(torch.equal(got[key], want[key]), f"{what} {key} differs")
    cnt = want["count"].double()
    depth = 2.0 * cnt.clamp(min=1) * EPS
    sumsq = want["sumsq"].double()
    m2 = want["m2"].double()
    bound = {"sum": depth * torch.sqrt(cnt * sumsq), "sumsq": depth * sumsq}
    mu_shift = (bound["sum"] + EPS * want["sum"].double().abs()) / cnt.clamp(min=1)
    bound["m2"] = (depth * m2 + 2.0 * torch.sqrt(cnt * m2) * mu_shift
                   + cnt * mu_shift * mu_shift)
    for key, atol in bound.items():
        err = (got[key].double() - want[key].double()).abs()
        check(bool((err <= atol + 1e-12).all()),
              f"{what} {key} beyond the reorder bound: {float(err.max())}")


def _check_aggregates(block, roll, blk, qs) -> None:
    """The rollup (factor 6) and block planes against an independent plain
    computation on the card (_plain_stats: masked reductions over a
    reshaped window) and a sort for the quantiles, under _hold_stats. The
    plain m2 centres on the plain mean, which may differ from the port's
    by the sum's reorder bound over n plus one rounding of the divide."""
    import torch

    from m3_tpu_torch.ops.bits64 import f64_bits_to_f32

    v = f64_bits_to_f32(block.values.view(torch.int64))
    n, w = v.shape
    mask = torch.arange(w, device=v.device) < block.npoints[:, None]
    rv = v.reshape(n, w // FACTOR, FACTOR)
    rm = mask.reshape(n, w // FACTOR, FACTOR)
    for got, vv, mm in ((roll, rv, rm), (blk, v, mask)):
        _hold_stats(got, _plain_stats(vv, mm), "aggregate")
    srt = torch.sort(torch.where(rm, rv, float("inf")), dim=-1).values
    nq = rm.sum(-1)
    for j, q in enumerate((0.5, 0.99)):
        rank = torch.ceil(q * nq.float()).to(torch.int64)
        idx = (rank.clamp(min=1) - 1).clamp(0, FACTOR - 1)
        want = torch.where(nq > 0, srt.gather(-1, idx[..., None])[..., 0], 0.0)
        check(torch.equal(qs[..., j], want), f"quantile {q} differs")


# Phase 15: config #2 (the docker/m3aggregator deployment) over the network.
# bench_counter_gauge's 50,000 metrics cut to 8,000, for the phase's 120 s
# and the script's time with phase 16 after it (at 14,000 the script took
# 1,170 s of its 1,200 on the H100's host, PERF.md §4): every untimed
# sample pays the pure-Python wire codec twice (6,297 samples/s into the
# aggregators at 20,000); the 30 points at 10 s, the two policies and the
# draws stay.
PIPE_METRICS, PIPE_POINTS, PIPE_SEED = 8_000, 30, 23
PIPE_TIMERS, PIPE_TIMER_VALUES, PIPE_TIMER_SEED = 5_000, 30, 29
PIPE_AGG_SHARDS = 64            # m3_tpu/services/config.py:111
PIPE_TOPIC_SHARDS = 64
PIPE_HJ_SERIES, PIPE_HJ_POINTS = 1_000, 10   # the HTTP JSON write_batch
PIPE_READS = 1_000
PIPE_FAILOVER_METRICS = 1_000
PIPE_BATCH = 256                # TCPTransport entries a frame
PIPE_WAIT_S = 120.0             # every wait's deadline
PIPE_QUERY = "sum_over_time(bench_cg_counter[5m])"
PIPE_POLICIES = ("1m:40h", "5m:40h")


def _await(cond, what: str, timeout: float = PIPE_WAIT_S) -> float:
    """Poll `cond` until it holds; fail the run past `timeout`. Returns
    the seconds waited."""
    t0 = time.perf_counter()
    deadline = t0 + timeout
    while not cond():
        check(time.perf_counter() < deadline,
              f"{what} not within {timeout} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


@contextlib.contextmanager
def _traced():
    """Host clock of the block and the device's busy seconds in it
    (torch.profiler, CUDA activity only), in the dict it yields: the
    device half of _instrumented, without its cProfile, whose per-call
    cost would double a block that is all Python calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    res = {}
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        yield res
        torch.cuda.synchronize()
        res["wall"] = time.perf_counter() - t0
    res["device"] = _device_seconds(trace)


class _RowSink:
    """A columnar flush handler keeping every emitted row's columns (a
    piped class's rows arrive one by one through __call__)."""

    def __init__(self):
        self.groups = []

    def __call__(self, mid, t, v, pol):
        self.groups.append(([mid], np.array([t], np.int64),
                            np.array([v], np.float64), pol))

    def handle_columnar(self, groups):
        for ids, ts, vs, pol in groups:
            self.groups.append((list(ids), np.asarray(ts, np.int64),
                                np.asarray(vs, np.float64), pol))

    def series(self, ns_of):
        """{(namespace, id): (times, values)} of the rows, time-sorted."""
        out = {}
        for ids, ts, vs, pol in self.groups:
            ns = ns_of[str(pol)]
            for mid, t, v in zip(ids, ts.tolist(), vs.tolist()):
                out.setdefault((ns, mid), []).append((t, v))
        return {k: (np.array([t for t, _ in sorted(r)], np.int64),
                    np.array([v for _, v in sorted(r)], np.float64))
                for k, r in out.items()}


def _bits(v) -> bytes:
    """f64 bit patterns, every NaN one NaN."""
    v = np.array(v, np.float64)
    v[np.isnan(v)] = np.nan
    return v.tobytes()


def _pipeline_phase() -> dict:
    """Phase 15: config #2 over the network, every part on 127.0.0.1 in
    this process. (a) the metadata plane: a KVServer; the coordinator's
    Database(ShardSet(16)) on the card with the index gets a NamespaceWatch
    over a RemoteStore; agg_1m and agg_5m are added through the registry
    and served; a runtime option folds from KV; an HTTPJSONServer over the
    db's NodeService (write_batch, K3; fetches back; /debug/vars; 429).
    (b) two Aggregators on the card behind RawTCPServers and admin
    sidecars, 64 shards by a placement in KV, elections and flush times
    over RemoteStores, flushing through ProducerHandlers over Producers to
    a Consumer(M3MsgIngester) into agg_1m/agg_5m; a collector Reporter
    over KV rules and an AggregatorClient of TCPTransports sends
    bench_counter_gauge's traffic and 5,000 batch timers; the stored rows
    equal a device="cpu" Aggregator's fed in process; the seal (K1), 1,000
    series read back (K2), a sum_over_time over agg_1m (K4 in the plan
    graph). (c) failover: a leader/follower pair, /resign, no gap and no
    duplicate window. Returns the kernels' launches over the phase (the
    counts set to 0 just before it)."""
    import gc

    import torch

    from m3_tpu_torch.cluster.kv_service import KVServer
    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.parallel import compile as pcompile

    pcompile.clear()
    gc.collect()
    gc.freeze()
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv = KVServer().start()
    closers = [kv.close]
    try:
        now = {"t": 1_700_000_000 * 10**9 - (1_700_000_000 * 10**9)
               % (300 * 10**9)}
        db = _pipe_metadata(kv, now, closers)
        _pipe_httpjson(db, now, closers)
        oracle = _pipe_aggregate(kv, db, now, closers)
        _pipe_failover(kv, db, now, closers)
        _pipe_seal_read_query(db, now, oracle)
    finally:
        for close in reversed(closers):
            close()
        gc.unfreeze()
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts(), window=wk.window_stat.launches)
    secs = time.perf_counter() - t0
    pcompile.clear()
    torch.cuda.empty_cache()
    _card(f"pipeline: phase 15 in {secs!r} s, launches {launches}")
    check(all(launches[k] > 0 for k in ("pack", "decode", "hash", "window")),
          f"phase 15 did not launch every kernel: {launches}")
    return launches


def _pipe_metadata(kv, now, closers):
    """(a) 1-4: the db, its NamespaceWatch over a RemoteStore, agg_1m
    added through the watch and agg_5m published by an admin client (the
    watch push creates it), both on the db's device; one runtime option
    folded from KV."""
    import json as _json

    from m3_tpu_torch.cluster.kv_service import RemoteStore
    from m3_tpu_torch.index.namespace_index import NamespaceIndex
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.storage import runtime
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions
    from m3_tpu_torch.storage.namespace_watch import (REGISTRY_KEY,
                                                      NamespaceWatch)

    clock = lambda: now["t"]  # noqa: E731
    db = Database(ShardSet(num_shards=16), clock=clock)
    closers.append(db.close)
    db.create_namespace(b"default", NamespaceOptions(),
                        index=NamespaceIndex(clock=clock))
    st, admin = RemoteStore(kv.endpoint), RemoteStore(kv.endpoint)
    closers += [st.close, admin.close]
    t0 = time.perf_counter()
    watch = NamespaceWatch(db, st).start()
    closers.append(watch.stop)
    check(watch.device == db.device,
          f"the watch runs on {watch.device}, the db on {db.device}")
    retention = 40 * 3600 * 10**9
    watch.add(b"agg_1m", retention_ns=retention)
    for _ in range(8):
        cur = admin.get(REGISTRY_KEY)
        reg = _json.loads(cur.data)
        reg["agg_5m"] = {"retention_ns": retention,
                         "block_size_ns": NamespaceOptions().block_size_ns,
                         "index_enabled": True}
        try:
            admin.check_and_set(REGISTRY_KEY, cur.version,
                                _json.dumps(reg).encode())
            break
        except ValueError:
            continue
    waited = _await(lambda: b"agg_5m" in db.namespaces,
                    "pipeline: agg_5m served through the watch")
    for ns in (b"agg_1m", b"agg_5m"):
        n = db.namespace(ns)
        check(n.device == db.device and n.index is not None
              and n.opts.retention_ns == retention,
              f"{ns!r}: device {n.device}, retention {n.opts.retention_ns}")
    mgr = runtime.watch_kv_runtime_options(st, runtime.RuntimeOptionsManager())
    admin.set("_kvconfig/" + runtime.CLIENT_WRITE_CONSISTENCY, b'"all"')
    _await(lambda: mgr.get().write_consistency == "all",
           "pipeline: the runtime option folded")
    _card(f"pipeline (a) metadata: agg_1m and agg_5m on {db.device} in "
          f"{time.perf_counter() - t0!r} s (the watch push {waited!r} s); "
          f"runtime write consistency {mgr.get().write_consistency!r} from "
          f"KV; {watch.updates_applied} registry updates applied")
    return db


def _pipe_httpjson(db, now, closers) -> None:
    """(a) 5: an HTTPJSONServer over the db's NodeService: one POST
    write_batch of PIPE_HJ_SERIES x PIPE_HJ_POINTS samples (K3 routing),
    every series fetched back over POST equal bit for bit, /debug/vars
    with the guard's snapshot, 429 from a held gate."""
    import base64
    import json as _json
    import urllib.error
    import urllib.request

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.rpc import HTTPJSONServer, NodeService
    from m3_tpu_torch.utils.health import AdmissionGate

    gate = AdmissionGate(capacity=64, name="pipeline.httpjson")
    srv = HTTPJSONServer(NodeService(db, gate=gate)).start()
    closers.append(srv.close)
    check(srv.device == db.device, f"HTTP JSON on {srv.device}")
    rng = np.random.default_rng(PIPE_SEED)
    n, w = PIPE_HJ_SERIES, PIPE_HJ_POINTS
    ids = [b"hj.%d" % i for i in range(n)]
    ts = now["t"] - (w - np.arange(w, dtype=np.int64)) * 10**10
    vals = rng.standard_normal((n, w))

    def post(method, body):
        req = urllib.request.Request(f"{srv.endpoint}/{method}", method="POST",
                                     data=_json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, _json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, _json.loads(e.read())

    body = {"ns": "default",
            "ids": [{"b64": base64.b64encode(i).decode()}
                    for i in ids for _ in range(w)],
            "ts": np.tile(ts, n).tolist(), "vals": vals.ravel().tolist()}
    hash0 = ck.launch_counts()["hash"]
    t0 = time.perf_counter()
    code, out = post("write_batch", body)
    write_s = time.perf_counter() - t0
    check((code, out) == (200, {"ok": True, "r": n * w}),
          f"HTTP JSON write_batch: {code} {out}")
    check(ck.launch_counts()["hash"] > hash0, "write_batch did not launch K3")
    t0 = time.perf_counter()
    for i, sid in enumerate(ids):
        code, out = post("fetch", {"ns": "default", "id": sid.decode(),
                                   "start_ns": 0, "end_ns": now["t"] + 1})
        check(code == 200 and out["r"]["t"] == ts.tolist()
              and _bits(out["r"]["v"]) == _bits(vals[i]),
              f"HTTP JSON fetch of {sid!r} differs")
    fetch_s = time.perf_counter() - t0
    with urllib.request.urlopen(srv.endpoint + "/debug/vars", timeout=60) as r:
        dv = _json.loads(r.read())
    check("codec.hash" in dv["compute"] and dv["metrics"],
          f"/debug/vars compute routes {sorted(dv['compute'])}")
    gate.admit(64)
    try:
        code, out = post("write", {"ns": "default", "id": "x",
                                   "t_ns": now["t"], "value": 1.0})
    finally:
        gate.release(64)
    check(code == 429 and out["kind"] == "resource_exhausted",
          f"a held gate answered {code}")
    _card(f"pipeline (a) HTTP JSON: write_batch of {n * w} samples in "
          f"{write_s!r} s ({len(_json.dumps(body))} bytes); {n} fetches back "
          f"bit for bit in {fetch_s!r} s; /debug/vars routes "
          f"{sorted(dv['compute'])}; a held gate 429")


def _pipe_rules(store):
    """Two mapping rules published through the KV RuleSetStore: the
    counters and gauges to both policies with their default aggregations,
    the timers to both policies with p50/p95/p99 (config #4's)."""
    from m3_tpu_torch.metrics import aggregation as magg
    from m3_tpu_torch.metrics.filters import TagsFilter
    from m3_tpu_torch.metrics.matcher import RuleSetStore
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.rules import MappingRuleSnapshot, Rule, RuleSet

    pols = tuple(StoragePolicy.parse(p) for p in PIPE_POLICIES)
    qs = magg.AggID.compress([magg.AggType.P50, magg.AggType.P95,
                              magg.AggType.P99])
    RuleSetStore(store).publish(RuleSet(b"default", 1, mapping_rules=[
        Rule([MappingRuleSnapshot("cg", 0, TagsFilter(
            {"__name__": "bench_cg_*"}), 0, pols)]),
        Rule([MappingRuleSnapshot("timers", 0, TagsFilter(
            {"__name__": "bench_timer"}), qs, pols)])]))
    return pols


def _pipe_traffic():
    """bench_counter_gauge's draws (seed 23: Poisson(5) counters, N(0,1)
    gauges, 30 points) over tagged ids, and PIPE_TIMERS batch timers of
    PIPE_TIMER_VALUES lognormal values, timer i sent at point i % 30."""
    from m3_tpu_torch.metrics import id as metric_id

    n = PIPE_METRICS
    rng = np.random.default_rng(PIPE_SEED)
    cvals = rng.poisson(5.0, (n // 2, PIPE_POINTS)).astype(np.int64)
    gvals = rng.standard_normal((n - n // 2, PIPE_POINTS))
    cids = [metric_id.encode(b"bench_cg_counter", {b"instance": b"%d" % i})
            for i in range(n // 2)]
    gids = [metric_id.encode(b"bench_cg_gauge", {b"instance": b"%d" % i})
            for i in range(n - n // 2)]
    trng = np.random.default_rng(PIPE_TIMER_SEED)
    tvals = trng.lognormal(3.0, 1.0, (PIPE_TIMERS, PIPE_TIMER_VALUES))
    tids = [metric_id.encode(b"bench_timer", {b"instance": b"%d" % i})
            for i in range(PIPE_TIMERS)]
    return cids, cvals, gids, gvals, tids, tvals


def _pipe_aggregate(kv, db, now, closers):
    """(b) The aggregation pipeline over TCP and m3msg. Returns the
    oracle's rows {(namespace, id): (times, values)}."""
    from m3_tpu_torch.aggregator import (Aggregator, AggregatorClient,
                                         ElectionManager, FlushTimesManager,
                                         ProducerHandler)
    from m3_tpu_torch.aggregator.server import (HTTPAdminServer, RawTCPServer,
                                                TCPTransport)
    from m3_tpu_torch.cluster.kv_service import RemoteStore
    from m3_tpu_torch.cluster.placement import Instance, PlacementService
    from m3_tpu_torch.cluster.services import LeaderService
    from m3_tpu_torch.collector import Reporter
    from m3_tpu_torch.coordinator.ingest import M3MsgIngester
    from m3_tpu_torch.metrics.matcher import Matcher, RuleSetStore
    from m3_tpu_torch.metrics.metric import MetricUnion
    from m3_tpu_torch.msg import (Consumer, ConsumerService, Producer, Topic,
                                  TopicService)
    from m3_tpu_torch.query.storage import LocalStorage

    clock = lambda: now["t"]  # noqa: E731
    t_start = now["t"]
    admin = RemoteStore(kv.endpoint)
    closers.append(admin.close)
    pols = _pipe_rules(admin)
    ns_of = {str(p): ns for p, ns in zip(pols, (b"agg_1m", b"agg_5m"))}
    storages = {p: LocalStorage(db, ns) for p, ns in zip(
        pols, (b"agg_1m", b"agg_5m"))}
    ingester = M3MsgIngester(storages.get)
    consumer = Consumer(ingester).start()
    closers.append(consumer.close)
    TopicService(admin).upsert(Topic("aggregated_metrics", PIPE_TOPIC_SHARDS,
                                     (ConsumerService("coordinator"),)))
    PlacementService(admin, "_placement/coordinator").init(
        [Instance("coord0", consumer.endpoint)], PIPE_TOPIC_SHARDS, 1)
    aggs, servers, producers = {}, {}, []
    for iid in ("agg0", "agg1"):
        st = RemoteStore(kv.endpoint)
        closers.append(st.close)
        topic = TopicService(st).get("aggregated_metrics")
        coord_pl = PlacementService(st, "_placement/coordinator").get()
        prod = Producer(topic, {"coordinator": lambda p=coord_pl: p},
                        retry_delay_s=0.2)
        closers.append(prod.close)
        producers.append(prod)
        agg = Aggregator(num_shards=PIPE_AGG_SHARDS, clock=clock,
                         flush_handler=ProducerHandler(prod, topic.num_shards),
                         election=ElectionManager(LeaderService(
                             st, f"m3aggregator/{iid}", iid, clock=clock)),
                         flush_times=FlushTimesManager(st, iid))
        raw, side = RawTCPServer(agg).start(), HTTPAdminServer(agg).start()
        closers += [raw.close, side.close]
        check(raw.device == side.device == agg.device == db.device,
              f"aggregator on {agg.device}, its servers on {raw.device}")
        aggs[iid], servers[iid] = agg, (raw, side)
    psvc = PlacementService(admin, "_placement/m3aggregator")
    agg_pl = psvc.init([Instance(iid, servers[iid][0].endpoint)
                        for iid in aggs], PIPE_AGG_SHARDS, 1)
    for iid, agg in aggs.items():
        agg.assign_shards(agg_pl.instances[iid].shard_ids())
    placement = {"p": psvc.get()}
    transports = {iid: TCPTransport(placement["p"].instances[iid].endpoint,
                                    batch_size=PIPE_BATCH) for iid in aggs}
    for tr in transports.values():
        closers.append(tr.close)
    sender_kv = RemoteStore(kv.endpoint)
    closers.append(sender_kv.close)
    matcher = Matcher(RuleSetStore(sender_kv), b"default", clock=clock)
    rep = Reporter(matcher, AggregatorClient(
        PIPE_AGG_SHARDS, lambda: placement["p"], transports))
    oracle_sink = _RowSink()
    oracle = Aggregator(num_shards=PIPE_AGG_SHARDS, clock=clock,
                        flush_handler=oracle_sink, device="cpu")
    cids, cvals, gids, gvals, tids, tvals = _pipe_traffic()
    md_cg = matcher.match(cids[0]).for_existing_id
    md_t = matcher.match(tids[0]).for_existing_id
    raws = [servers[iid][0] for iid in aggs]

    def received():
        return sum(r.frames + r.errors + r.shed for r in raws)

    sent, oracle_s = 0, 0.0
    with _traced() as trace:
        t_send = time.perf_counter()
        for k in range(PIPE_POINTS):
            now["t"] = t_start + k * 10**10
            for mid, v in zip(cids, cvals[:, k].tolist()):
                rep.report_counter(mid, v)
            for mid, v in zip(gids, gvals[:, k].tolist()):
                rep.report_gauge(mid, v)
            timers = range(k, PIPE_TIMERS, PIPE_POINTS)
            for i in timers:
                rep.report_batch_timer(tids[i], tvals[i].tolist())
            for tr in transports.values():
                check(tr.flush(), "a TCPTransport flush failed")
            sent += len(cids) + len(gids) + len(timers)
            o0 = time.perf_counter()
            oracle.add_untimed_batch(
                [MetricUnion.counter(m, v)
                 for m, v in zip(cids, cvals[:, k].tolist())]
                + [MetricUnion.gauge(m, v)
                   for m, v in zip(gids, gvals[:, k].tolist())], md_cg)
            oracle.add_untimed_batch(
                [MetricUnion.batch_timer(tids[i], tvals[i].tolist())
                 for i in timers], md_t)
            oracle_s += time.perf_counter() - o0
            _await(lambda n=sent: received() >= n,
                   f"pipeline: point {k}: {sent} samples at the aggregators")
        t_last = time.perf_counter()
        send_s = t_last - t_send - oracle_s
        errors = sum(r.errors + r.shed for r in raws)
        check(errors == 0 and rep.reported == sent,
              f"ingest: {errors} errors or shed, reported {rep.reported}")
        now["t"] = t_start + 300 * 10**9
        t_flush = time.perf_counter()
        flushed = sum(agg.flush() for agg in aggs.values())
        flush_s = time.perf_counter() - t_flush
        rows = 6 * PIPE_METRICS + 2 * 3 * PIPE_TIMERS
        _await(lambda: all(p.unacked() == 0 for p in producers)
               and ingester.ingested >= rows, "pipeline: the m3msg delivery")
        t_stored = time.perf_counter()
    check(all(a._election.is_leader() for a in aggs.values()),
          "an aggregator did not lead its shard set")
    oracle.flush()
    want = oracle_sink.series(ns_of)
    # At least once: a redelivered payload writes its rows again and
    # storage keeps one; the stored rows are what is compared.
    check(rows == sum(len(t) for t, _ in want.values()),
          f"the oracle flushed {sum(len(t) for t, _ in want.values())} rows, "
          f"not {rows}")
    t0 = time.perf_counter()
    for (ns, mid), (wt, wv) in want.items():
        gt, gv = db.read(ns, mid, 0, 2**62)
        if gt.tobytes() != wt.tobytes() or _bits(gv) != _bits(wv):
            check(False, f"{ns!r} {mid!r}: stored rows differ from the "
                         f"oracle's ({gt.tolist()}, {gv.tolist()} against "
                         f"{wt.tolist()}, {wv.tolist()})")
    compare_s = time.perf_counter() - t0
    dev = trace["device"]
    busy = ("not measured (no device time in the trace)" if dev is None
            else f"{dev * 1e3!r} ms ({dev / trace['wall'] * 100!r}% of "
                 f"{trace['wall']!r} s)")
    frames = {iid: servers[iid][0].frames for iid in aggs}
    _card(f"pipeline (b) config #2 over TCP and m3msg: {PIPE_METRICS} metrics "
          f"x {PIPE_POINTS} points and {PIPE_TIMERS} batch timers of "
          f"{PIPE_TIMER_VALUES} ({sent} samples, records by instance "
          f"{frames}) from the Reporter into 2 aggregators in {send_s!r} s: "
          f"{sent / send_s!r} samples/s (the in-process oracle's adds "
          f"{oracle_s!r} s excluded); flush {flush_s!r} s ({flushed} windows), "
          f"{rows} rows flush to stored in {t_stored - t_flush!r} s: "
          f"{rows / (t_stored - t_flush)!r} rows/s; last sample to last row "
          f"readable {t_stored - t_last!r} s; card busy {busy}; "
          f"{sum(a._flush_handler.publishes for a in aggs.values())} m3msg "
          f"publishes, {ingester.ingested} rows ingested, "
          f"{consumer.duplicates_dropped} duplicate deliveries dropped")
    _card(f"pipeline (b) every stored row of {len(want)} series equals the "
          f"device=\"cpu\" Aggregator's bit for bit ({compare_s!r} s)")
    return want


def _pipe_failover(kv, db, now, closers) -> None:
    """(c) A leader and a follower on one shard set (RF 2 over 64 shards,
    both fed every sample over TCP), elections and flush times over
    RemoteStores, flushing through m3msg into agg_1m: the leader flushes
    one window and resigns over /resign, the follower flushes the next;
    the stored rows equal a device="cpu" Aggregator's (every window once)."""
    import json as _json
    import urllib.request

    from m3_tpu_torch.aggregator import (Aggregator, AggregatorClient,
                                         ElectionManager, FlushTimesManager,
                                         ProducerHandler)
    from m3_tpu_torch.aggregator.server import (HTTPAdminServer, RawTCPServer,
                                                TCPTransport)
    from m3_tpu_torch.cluster.kv_service import RemoteStore
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.cluster.services import LeaderService
    from m3_tpu_torch.coordinator.ingest import M3MsgIngester
    from m3_tpu_torch.metrics import id as metric_id
    from m3_tpu_torch.metrics.metadata import (Metadata, PipelineMetadata,
                                               StagedMetadata)
    from m3_tpu_torch.metrics.metric import MetricUnion
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.msg import Consumer, ConsumerService, Producer, Topic
    from m3_tpu_torch.query.storage import LocalStorage

    clock = lambda: now["t"]  # noqa: E731
    pol = StoragePolicy.parse(PIPE_POLICIES[0])
    md = (StagedMetadata(0, False, Metadata((PipelineMetadata(0, (pol,)),))),)
    ingester = M3MsgIngester({pol: LocalStorage(db, b"agg_1m")}.get)
    consumer = Consumer(ingester).start()
    closers.append(consumer.close)
    cpl = initial_placement([Instance("coord0", consumer.endpoint)],
                            PIPE_TOPIC_SHARDS, 1)
    topic = Topic("aggregated_metrics", PIPE_TOPIC_SHARDS,
                  (ConsumerService("coordinator"),))
    aggs, raws, producers = {}, {}, []
    for iid in ("leader", "follower"):
        st = RemoteStore(kv.endpoint)
        closers.append(st.close)
        prod = Producer(topic, {"coordinator": lambda: cpl}, retry_delay_s=0.2)
        closers.append(prod.close)
        producers.append(prod)
        aggs[iid] = Aggregator(
            num_shards=PIPE_AGG_SHARDS, clock=clock,
            flush_handler=ProducerHandler(prod, PIPE_TOPIC_SHARDS),
            election=ElectionManager(LeaderService(
                st, "m3aggregator/failover", iid, clock=clock)),
            flush_times=FlushTimesManager(st, "failover"))
        raws[iid] = RawTCPServer(aggs[iid]).start()
        closers.append(raws[iid].close)
    side = HTTPAdminServer(aggs["leader"]).start()
    closers.append(side.close)
    agg_pl = initial_placement([Instance(i, raws[i].endpoint) for i in aggs],
                               PIPE_AGG_SHARDS, 2)
    trs = {i: TCPTransport(raws[i].endpoint, batch_size=PIPE_BATCH)
           for i in aggs}
    for tr in trs.values():
        closers.append(tr.close)
    client = AggregatorClient(PIPE_AGG_SHARDS, lambda: agg_pl, trs)
    oracle_sink = _RowSink()
    oracle = Aggregator(num_shards=PIPE_AGG_SHARDS, clock=clock,
                        flush_handler=oracle_sink, device="cpu")
    n = PIPE_FAILOVER_METRICS
    ids = [metric_id.encode(b"bench_failover", {b"instance": b"%d" % i})
           for i in range(n)]
    rng = np.random.default_rng(PIPE_SEED + 1)
    t_start = now["t"]
    sent = [0]

    def window(w):
        now["t"] = t_start + w * 60 * 10**9
        vals = rng.poisson(5.0, n).tolist()
        for mid, v in zip(ids, vals):
            check(client.write_untimed_counter(mid, v, md), "undelivered")
        for tr in trs.values():
            check(tr.flush(), "a TCPTransport flush failed")
        oracle.add_untimed_batch([MetricUnion.counter(m, v)
                                  for m, v in zip(ids, vals)], md)
        sent[0] += 2 * n
        _await(lambda: sum(r.frames for r in raws.values()) == sent[0],
               f"pipeline: failover window {w} at both instances")

    def status():
        with urllib.request.urlopen(side.endpoint + "/status",
                                    timeout=60) as r:
            return _json.loads(r.read())["status"]["flushStatus"]

    window(0)
    now["t"] = t_start + 60 * 10**9
    aggs["leader"].flush()
    aggs["follower"].flush()
    check(status() == {"electionState": "leader", "canLead": True},
          f"the leader's status {status()}")
    window(1)
    req = urllib.request.Request(side.endpoint + "/resign", data=b"",
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        check(_json.loads(r.read()) == {"state": "OK"}, "/resign")
    check(status()["electionState"] == "follower", f"after /resign {status()}")
    now["t"] = t_start + 120 * 10**9
    aggs["follower"].flush()
    aggs["leader"].flush()
    check(aggs["follower"]._election.is_leader()
          and not aggs["leader"]._election.is_leader(),
          "the follower did not take over the flush")
    _await(lambda: all(p.unacked() == 0 for p in producers)
           and ingester.ingested >= 2 * n,
           "pipeline: the failover's m3msg delivery")
    oracle.flush()
    want = oracle_sink.series({str(pol): b"agg_1m"})
    check(sum(len(t) for t, _ in want.values()) == 2 * n,
          "the failover oracle's rows")
    for (ns, mid), (wt, wv) in want.items():
        gt, gv = db.read(ns, mid, 0, 2**62)
        check(gt.tobytes() == wt.tobytes() and _bits(gv) == _bits(wv),
              f"failover: {mid!r} stored {gt.tolist()} against "
              f"{wt.tolist()}")
    _card(f"pipeline (c) failover: {n} metrics, leader flushed window 1, "
          f"/resign, the follower flushed window 2; {ingester.ingested} "
          f"stored rows, no gap and no duplicate window")


def _pipe_seal_read_query(db, now, want) -> None:
    """(b) The seal of agg_1m and agg_5m (K1), PIPE_READS sampled series
    read back from the sealed blocks equal to the oracle (K2), and
    PIPE_QUERY over agg_1m on the plan route (K4 inside its graph) within
    "compiled query answers" of a device="cpu" engine."""
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.storage import LocalStorage

    step = _Steps("pipeline (b)")
    t_end = max(int(t[-1]) for t, _ in want.values())
    now["t"] = t_end - t_end % BLOCK_NS + BLOCK_NS + 11 * MINUTE_NS
    with step("tick: seal agg_1m and agg_5m (K1)"):
        sealed = db.tick()["sealed"]
    check(sealed >= 32, f"tick sealed {sealed} blocks")
    keys = sorted(want)
    pick = np.random.default_rng(PIPE_SEED).choice(len(keys), PIPE_READS,
                                                   replace=False)
    with step(f"{PIPE_READS} series read back from the sealed blocks (K2)"):
        for i in pick.tolist():
            ns, mid = keys[i]
            gt, gv = db.read(ns, mid, 0, 2**62)
            wt, wv = want[keys[i]]
            check(gt.tobytes() == wt.tobytes() and _bits(gv) == _bits(wv),
                  f"sealed {ns!r} {mid!r} differs from the oracle")
    start = min(int(t[0]) for t, _ in want.values())
    end = start + 4 * MINUTE_NS
    card = Engine(LocalStorage(db, b"agg_1m"))
    with step(f"{PIPE_QUERY} over agg_1m (plan route, K4)"):
        blk = card.execute_range(PIPE_QUERY, start, end, MINUTE_NS)
    route = card.last_route()
    check(route["route"] == "compiled", f"{PIPE_QUERY}: route {route}")
    ref = Engine(LocalStorage(db, b"agg_1m"), device="cpu").execute_range(
        PIPE_QUERY, start, end, MINUTE_NS)
    check(blk.values.shape == (PIPE_METRICS // 2, 5),
          f"{PIPE_QUERY}: shape {blk.values.shape}")
    err = _check_plan(PIPE_QUERY, blk, ref, "agg_1m against the CPU")
    _card(f"pipeline (b) seal {sealed} blocks; {PIPE_READS} sealed series "
          f"equal the oracle; {PIPE_QUERY} over agg_1m compiled, "
          f"{blk.values.shape}, within the compiled bounds of the CPU "
          f"engine (max rel {err!r})")


# ---------------------------------------------------------------------------
# Phase 16: the service binaries
# ---------------------------------------------------------------------------

# The port's CLIs as child processes on the card (`python -m
# m3_tpu_torch.services ...` started through em.Operator, and under
# utils.panicmon.Panicmon for the crash), each config JSON text of
# examples/dbnode.yml's shape with a coordinator section (every JSON
# document is YAML, and load_file reads JSON without PyYAML), fixed free
# ports so that a restarted child comes back on its port. Cuts: one
# namespace of 1m blocks with a 10 s buffer_past (the reference's drill
# knobs, m3_tpu/services/config.py:29-33) so that a block seals within the
# phase, and 4 shards (M3's default is 64) so that (c) runs one tools
# child a shard within it. (a) bench_query_serve_e2e's counters (seed 61,
# 10,000 over 200 hosts), their first 30 points retimed to SVC_POINT_MS
# apart on the wall clock (14.5 s: a block has room for them when (a)
# starts in its first 43 s, so (a) seldom waits for the next block), as
# snappy protobuf remote writes of SVC_REQUEST series each; (d) 1,000
# metrics x 30 points (half Poisson(5) counters, half N(0,1) gauges, seed
# 67) from a collector Reporter.
SVC_SERIES, SVC_HOSTS, SVC_POINTS, SVC_SEED = 10_000, 200, 30, 61
SVC_POINT_MS, SVC_SHARDS, SVC_REQUEST = 500, 4, 500
SVC_AGG_METRICS, SVC_AGG_SEED, SVC_AGG_SHARDS = 1_000, 67, 64
SVC_POLICY = "1m:40h"
SVC_BLOCK_S, SVC_BUFFER_PAST_S = 60, 10
# (a) a rate and a sum by (host) (the latter over max_over_time: K4 in its
# plan graph) over the last 5 s at 1 s steps; (b) one host's 50 series
# read back through query_range at each sample: 1,500 cells, below the
# plan floor (4,096), so that the interpreter serves the raw f64 samples
# (past it, a bare selector's compiled planes are f32, in the reference
# too); (d) the query both coordinators answer (2,500 series: the
# standalone one fetches them through its Session).
SVC_QUERIES = ("rate(bench_requests[10s])",
               "sum by (host) (max_over_time(bench_requests[10s]))")
SVC_READ_MATCH = 'bench_requests{host="host-000"}'
SVC_FED_QUERY = ('sum by (host) (rate(bench_requests'
                 '{host=~"host-0[0-4][0-9]"}[10s]))')
SVC_SPAWN_S = 180.0     # a child's spawn to its listen line
SVC_WAIT_S = 240.0      # every other wait's deadline


def _free_ports(n: int):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _svc_spawn(ops) -> dict:
    """Start each (name, Operator) at once, each on a thread; {name:
    seconds from spawn to its listen line}. A failed start fails the
    run."""
    import threading

    out, errs = {}, []

    def start(name, op):
        t0 = time.perf_counter()
        try:
            op.start(timeout_s=SVC_SPAWN_S)
            out[name] = time.perf_counter() - t0
        except Exception as err:  # noqa: BLE001 - reported below
            errs.append(f"{name}: {err!r}")

    threads = [threading.Thread(target=start, args=nop) for nop in ops]
    for th in threads:
        th.start()
    for th in threads:
        th.join(SVC_SPAWN_S + 30)
    check(not errs and len(out) == len(ops), f"services: spawn {errs}")
    return out


def _svc_node_config(data_dir: str, node_port: int, coord_port: int) -> str:
    return json.dumps({
        "host_id": "node0", "listen_address": f"127.0.0.1:{node_port}",
        "data_dir": data_dir, "num_shards": SVC_SHARDS,
        "commitlog_enabled": True, "commitlog_strategy": "write_wait",
        "bootstrap_enabled": True, "tick_interval": "2s",
        "namespaces": [{"name": "default", "retention": "48h",
                        "block_size": f"{SVC_BLOCK_S}s",
                        "buffer_past": f"{SVC_BUFFER_PAST_S}s",
                        "index_enabled": True}],
        "coordinator": {"listen_address": f"127.0.0.1:{coord_port}",
                        "namespace": "default",
                        "rules_namespace": "default"}}, indent=1)


def _svc_compute_apps():
    """[(pid, used memory)] of nvidia-smi's compute apps. Where the
    machine's PID namespace hides the processes' own PIDs (this process is
    not among them), the list still counts the processes holding a CUDA
    context."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return [tuple(x.strip() for x in ln.split(","))
            for ln in smi.stdout.strip().splitlines() if ln.strip()]


def _svc_primaries(endpoint: str) -> dict:
    """The guard's primary dispatches by route in a child (its
    /debug/vars): which device routes its work took."""
    code, out = _http(endpoint + "/debug/vars")
    check(code == 200, f"services: /debug/vars answered {code}")
    return {r: int(v["counts"].get("primary", 0))
            for r, v in json.loads(out)["compute"].items()}


def _svc_launches(lines, what: str) -> dict:
    """A child's kernel launches: the JSON of the "kernel launches" line it
    printed as it closed, its wrappers' own counts."""
    found = [ln for ln in lines if " kernel launches {" in ln]
    check(found, f"services: {what} printed no kernel launches line")
    return json.loads(found[-1].partition(" kernel launches ")[2])


def _svc_tool(name: str, *args) -> list:
    """A tools CLI child's command line."""
    return [sys.executable, "-m", "m3_tpu_torch.tools", name, *args]


def _svc_prom(q: str, got: bytes, want: bytes, what: str) -> float:
    """Two Prometheus JSON answers: the same series (by label set), the
    same timestamps, values within the compiled route's bounds
    (_plan_tol). Returns the largest relative difference."""
    g, w = json.loads(got), json.loads(want)
    check(g["status"] == w["status"] == "success", f"{q}: status ({what})")
    key = lambda r: json.dumps(r["metric"], sort_keys=True)  # noqa: E731
    gs = {key(r): r["values"] for r in g["data"]["result"]}
    ws = {key(r): r["values"] for r in w["data"]["result"]}
    check(sorted(gs) == sorted(ws) and ws, f"{q}: series differ ({what})")
    gt = [p[0] for k in sorted(ws) for p in gs[k]]
    wt = [p[0] for k in sorted(ws) for p in ws[k]]
    check(gt == wt, f"{q}: timestamps differ ({what})")
    gv = np.array([float(p[1]) for k in sorted(ws) for p in gs[k]])
    wv = np.array([float(p[1]) for k in sorted(ws) for p in ws[k]])
    tol = _plan_tol(q, wv)
    check(bool(np.allclose(gv, wv, equal_nan=True, **tol)),
          f"{q}: values beyond {tol} ({what})")
    fin = np.isfinite(wv) & (wv != 0)
    return float((np.abs(gv - wv)[fin] / np.abs(wv[fin])).max()) \
        if fin.any() else 0.0


def _svc_range_url(base: str, q: str, start_s: float, end_s: float,
                   step: str) -> str:
    import urllib.parse

    return (f"{base}/api/v1/query_range?" + urllib.parse.urlencode(
        {"query": q, "start": start_s, "end": end_s, "step": step}))


def _svc_span_s() -> float:
    """Seconds from (a)'s first point to its last."""
    return (SVC_POINTS - 1) * SVC_POINT_MS / 1e3


def _svc_go(now_s: float):
    """(block start, first point) in whole seconds of (a)'s points: all
    SVC_POINTS of them, SVC_POINT_MS apart and a little in the future,
    inside one block of the child's namespace, so that one seal holds
    every point. Waits for the next block when this one has no room
    left."""
    block = int(now_s) // SVC_BLOCK_S * SVC_BLOCK_S
    first = int(now_s) + 2
    if first + _svc_span_s() >= block + SVC_BLOCK_S:
        block += SVC_BLOCK_S
        time.sleep(max(0.0, block - time.time()))
        first = block + 2
    return block, first


def _services_phase() -> dict:
    """Phase 16: the service binaries as child processes on the card, all
    on 127.0.0.1, their data under a temporary directory the phase
    removes. (a) a dbnode child with its embedded coordinator, started
    through em.Operator: its PID on the card, 10,000 counters x 30 points
    as snappy protobuf remote writes, the same bodies to an in-process
    device="cpu" oracle, the mediator's seal and flush, a rate and a sum
    by (host) over HTTP within the compiled bounds of the oracle's, the
    guard's primaries on the codec.* and plan routes; (d) meanwhile a kv
    and an aggregator child, a collector Reporter's 1,000 metrics x 30
    points, the flush log against a device="cpu" Aggregator. (b) SIGTERM,
    the node under Panicmon, SIGKILL, the restart's serving-ready line,
    every acknowledged point read back through a Session and
    query_range; (d) a standalone coordinator child finds the node
    through a placement in the kv child and answers as the embedded one.
    (c) after a SIGTERM the tools CLI children: verify_index_files and
    read_data_files per shard, a flipped byte in a clone. Returns the
    kernels' launches over the phase: what each child printed as it closed
    (its own wrappers' counts, from 0 at its start) and the parent's own
    (K2 in the Session), the parent's counts set to 0 just before."""
    import functools
    import shutil
    import tempfile

    import torch

    from m3_tpu_torch import em
    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    so = ck.BUILD_DIR / "m3_tpu_torch_kernels.so"
    so_mtime = so.stat().st_mtime_ns if so.exists() else None
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="m3-services-")
    # The node keeps its ports across (b)'s restart, so they are picked
    # here; every other child binds port 0 and prints the port it got.
    ports = dict(zip(("node", "coord"), _free_ports(2)))
    ops, stops, children = {}, [], {}
    try:
        for name, service, text in (
                ("node", "dbnode", _svc_node_config(
                    os.path.join(root, "node"), ports["node"],
                    ports["coord"])),
                ("kv", "kv", json.dumps({
                    "listen_address": "127.0.0.1:0"}))):
            op = ops[name] = em.Operator(os.path.join(root, name))
            op.setup(em.ProcessSpec(service, text, op.workdir))
            stops.append(functools.partial(op.stop, grace_s=120))
        spawned = _svc_spawn(list(ops.items()))
        kv_ep = ops["kv"].endpoint
        op = ops["agg"] = em.Operator(os.path.join(root, "agg"))
        op.setup(em.ProcessSpec("aggregator", json.dumps({
            "instance_id": "agg0", "listen_address": "127.0.0.1:0",
            "kv_endpoint": kv_ep,
            "placement_key": "_placement/m3aggregator",
            "flush_log": os.path.join(root, "agg", "flush.log"),
            "flush_interval": "1s"}), op.workdir))
        stops.append(functools.partial(op.stop, grace_s=120))
        spawned.update(_svc_spawn([("agg", op)]))
        _card("services: spawn to listening, seconds by child "
              f"{spawned}")
        acked, state = _svc_single_node(ops, ports, root)
        children["node restarted"] = _svc_crash_restart(
            ops, ports, root, acked, state, stops)
        children["tools"] = _svc_tools(root, acked, state)
    finally:
        errs = []
        for stop in reversed(stops):
            try:
                stop()
            except Exception as err:  # noqa: BLE001 - reach every child
                errs.append(repr(err))
        shutil.rmtree(root, ignore_errors=True)
    check(not errs, f"services: teardown {errs}")
    for name, op in ops.items():
        children[name] = _svc_launches(op.output, f"the {name} child")
    check(so_mtime is None or so.stat().st_mtime_ns == so_mtime,
          "services: a child rebuilt the kernels' extension")
    torch.cuda.synchronize()
    own = dict(ck.launch_counts(), window=wk.window_stat.launches)
    launches = {k: own[k] + sum(c.get(k, 0) for c in children.values())
                for k in own}
    secs = time.perf_counter() - t0
    _card(f"services: phase 16 in {secs!r} s, launches {launches} (each "
          f"child's own count, printed as it closed: {children}; this "
          f"process's {own}; the SIGKILLed node's are not seen)")
    check(all(launches[k] > 0 for k in ("pack", "decode", "hash", "window")),
          f"phase 16 did not launch every kernel: {launches}")
    return launches


def _svc_corpus(first_s: int):
    """(series, t_ns): bench_query_serve_e2e's counters, their first
    SVC_POINTS points retimed to SVC_POINT_MS apart from first_s."""
    from m3_tpu_torch.testing import serve_corpus

    series, _ = serve_corpus(SVC_SERIES, SVC_HOSTS, SVC_SEED)
    t = first_s * 10**9 + np.arange(SVC_POINTS, dtype=np.int64) * (
        SVC_POINT_MS * 10**6)
    return {sid: {"tags": s["tags"], "t": t, "v": s["v"][:SVC_POINTS]}
            for sid, s in series.items()}, t


def _svc_bodies(series, t):
    """Snappy WriteRequest bodies of SVC_REQUEST series x all points."""
    from m3_tpu_torch.coordinator import promremote as pr

    sids = list(series)
    t_ms = (t // 1_000_000).tolist()
    out = []
    for g0 in range(0, len(sids), SVC_REQUEST):
        group = sids[g0:g0 + SVC_REQUEST]
        req = [(series[s]["tags"], list(zip(t_ms, series[s]["v"].tolist())))
               for s in group]
        out.append((pr.snappy_compress(pr.encode_write_request(req)),
                    len(group) * len(t)))
    return out


def _svc_oracle(t):
    """The in-process oracle: run_embedded over a device="cpu" Database
    with the child's shards and namespace, its clock held a second before
    the first point (every point inside the buffer's acceptance
    window)."""
    from m3_tpu_torch.coordinator import run_embedded
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    clock = lambda: int(t[0]) - 10**9  # noqa: E731
    db = Database(ShardSet(SVC_SHARDS), clock=clock, device="cpu")
    db.ensure_namespace(b"default", NamespaceOptions(
        retention_ns=48 * 3600 * 10**9, block_size_ns=SVC_BLOCK_S * 10**9,
        buffer_past_ns=SVC_BUFFER_PAST_S * 10**9,
        buffer_future_ns=120 * 10**9, index_enabled=True))
    return db, run_embedded(db, clock=clock, device="cpu")


def _svc_single_node(ops, ports, root):
    """(a), with (d)'s aggregation between the writes and the seal.
    Returns the acknowledged points {i tag: (t, v)} and what (b) needs."""
    node = ops["node"]
    coord = f"http://127.0.0.1:{ports['coord']}"
    # The node's start-up warm-up (run_dbnode) already dispatched each
    # codec route once: the checks below count what the work added.
    prims0 = _svc_primaries(coord)
    wait_s = time.time()
    block, first = _svc_go(wait_s)
    wait_s = time.time() - wait_s
    series, t = _svc_corpus(first)
    e0 = time.perf_counter()
    bodies = _svc_bodies(series, t)
    encode_s = time.perf_counter() - e0
    n = len(series) * len(t)
    w0 = time.perf_counter()
    for body, n_body in bodies:
        code, out = _http(coord + "/api/v1/prom/remote/write", body)
        check(code == 200 and json.loads(out)["wrote"] == n_body,
              f"services (a): remote write answered {code}: {out[:200]!r}")
    write_s = time.perf_counter() - w0
    acked = {s["tags"][b"i"]: (s["t"], s["v"]) for s in series.values()}
    apps = _svc_compute_apps()
    if str(os.getpid()) in [a[0] for a in apps]:
        check(str(node.pid) in [a[0] for a in apps],
              f"services (a): the dbnode child {node.pid} is not among "
              f"the card's compute apps {apps}")
    db, oracle = _svc_oracle(t)
    try:
        o0 = time.perf_counter()
        for body, n_body in bodies:
            code, out = _http(oracle.endpoint + "/api/v1/prom/remote/write",
                              body)
            check(code == 200 and json.loads(out)["wrote"] == n_body,
                  f"services (a): the oracle answered {code}")
        oracle_s = time.perf_counter() - o0
        _svc_aggregate(ops, root)
        seal_s = _await(lambda: _svc_flushed(root, block),
                        "services (a): the mediator's seal and flush",
                        SVC_WAIT_S)
        sealed_at = time.time() - block
        errs = {}
        for q in SVC_QUERIES:
            q0 = time.perf_counter()
            code, got = _http(_svc_range_url(
                coord, q, first + _svc_span_s() - 5, first + _svc_span_s(),
                "1"))
            q_s = time.perf_counter() - q0
            check(code == 200, f"services (a): {q} answered {code}")
            _, want = _http(_svc_range_url(
                oracle.endpoint, q, first + _svc_span_s() - 5,
                first + _svc_span_s(), "1"))
            errs[q] = (_svc_prom(q, got, want, "the child against the "
                                 "device=\"cpu\" oracle"), q_s, len(got))
    finally:
        oracle.close()
        db.close()
    prims = _svc_primaries(coord)
    for route in ("codec.hash", "codec.encode", "codec.decode", "plan"):
        check(prims.get(route, 0) > prims0.get(route, 0),
              f"services (a): no {route} primary in the child's work: "
              f"{prims0} at the start, {prims} after")
    _card(f"services (a) dbnode child (pid {node.pid}; the card's compute "
          f"apps (pid, memory) {apps}, this process {os.getpid()}): "
          f"{n} samples in "
          f"{len(bodies)} remote writes ({encode_s!r} s to encode) in "
          f"{write_s!r} s: {n / write_s!r} samples/s (the oracle's "
          f"{n / oracle_s!r}); {wait_s!r} s waited for a block with room; "
          f"sealed and flushed {seal_s!r} s after (d), {sealed_at!r} s "
          f"after the block start; queries (max rel diff, s, bytes) "
          f"{errs}; guard primaries {prims}")
    return acked, {"first": first, "block": block}


def _svc_flushed(root: str, block: int) -> bool:
    """Every shard's fileset of (a)'s block is on disk (the mediator's
    flush; a shard without a series of the block has none)."""
    from m3_tpu_torch.persist.fs import PersistManager

    pm = PersistManager(os.path.join(root, "node", "data"))
    have = [bs for s in range(SVC_SHARDS)
            for bs, _ in pm.list_filesets(b"default", s)]
    return have.count(block * 10**9) == SVC_SHARDS


def _svc_aggregate(ops, root) -> None:
    """(d) The aggregator child: a placement in the kv child gives it
    every shard; the rules in KV; run_collector's Reporter sends 1,000
    metrics x 30 points over a TCPTransport, all inside one 1m window;
    the flush log, once the window closes, equals a device="cpu"
    Aggregator fed the same samples at a clock in the same window."""
    from m3_tpu_torch.aggregator import Aggregator, CaptureHandler
    from m3_tpu_torch.aggregator.server import TCPTransport
    from m3_tpu_torch.cluster.kv_service import RemoteStore
    from m3_tpu_torch.cluster.placement import Instance, PlacementService
    from m3_tpu_torch.metrics import id as metric_id
    from m3_tpu_torch.metrics.filters import TagsFilter
    from m3_tpu_torch.metrics.matcher import RuleSetStore
    from m3_tpu_torch.metrics.metric import MetricUnion
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.rules import MappingRuleSnapshot, Rule, RuleSet
    from m3_tpu_torch.services import load_dict
    from m3_tpu_torch.services.run import run_collector

    agg = ops["agg"]
    admin = RemoteStore(ops["kv"].endpoint)
    closers = [admin.close]
    try:
        pol = StoragePolicy.parse(SVC_POLICY)
        RuleSetStore(admin).publish(RuleSet(b"default", 1, mapping_rules=[
            Rule([MappingRuleSnapshot("svc", 0, TagsFilter(
                {"__name__": "svc_cg_*"}), 0, (pol,))])]))
        placement = PlacementService(admin, "_placement/m3aggregator").init(
            [Instance("agg0", agg.endpoint)], SVC_AGG_SHARDS, 1)
        _await(lambda: any("placement update" in ln for ln in agg.output),
               "services (d): the aggregator child's placement update",
               SVC_WAIT_S)
        tr = TCPTransport(agg.endpoint, batch_size=256)
        closers.append(tr.close)
        rep, store = run_collector(load_dict({
            "num_shards": SVC_AGG_SHARDS, "kv_endpoint": ops["kv"].endpoint},
            "collector"), lambda: placement, {"agg0": tr})
        closers.append(store.close)
        n = SVC_AGG_METRICS
        rng = np.random.default_rng(SVC_AGG_SEED)
        cvals = rng.poisson(5.0, (n // 2, SVC_POINTS)).astype(np.int64)
        gvals = rng.standard_normal((n - n // 2, SVC_POINTS))
        cids = [metric_id.encode(b"svc_cg_counter", {b"instance": b"%d" % i})
                for i in range(n // 2)]
        gids = [metric_id.encode(b"svc_cg_gauge", {b"instance": b"%d" % i})
                for i in range(n - n // 2)]
        res = pol.resolution.window_ns
        now = time.time_ns()
        if now % res > res - 20 * 10**9:  # room for the sends in a window
            time.sleep((res - now % res) / 1e9 + 0.5)
        window = time.time_ns() // res
        s0 = time.perf_counter()
        for k in range(SVC_POINTS):
            for mid, v in zip(cids, cvals[:, k].tolist()):
                check(rep.report_counter(mid, v), "services (d): unreported")
            for mid, v in zip(gids, gvals[:, k].tolist()):
                check(rep.report_gauge(mid, v), "services (d): unreported")
        check(tr.flush(), "services (d): the TCPTransport flush failed")
        send_s = time.perf_counter() - s0
        check(time.time_ns() // res == window,
              "services (d): the sends crossed a window boundary")
        cap = CaptureHandler()
        clock = {"t": window * res + 1}
        oracle = Aggregator(num_shards=SVC_AGG_SHARDS,
                            clock=lambda: clock["t"], flush_handler=cap,
                            device="cpu")
        md = rep._matcher.match(cids[0]).for_existing_id
        for k in range(SVC_POINTS):
            oracle.add_untimed_batch(
                [MetricUnion.counter(m, v)
                 for m, v in zip(cids, cvals[:, k].tolist())]
                + [MetricUnion.gauge(m, v)
                   for m, v in zip(gids, gvals[:, k].tolist())], md)
        clock["t"] = (window + 1) * res + 1
        oracle.flush()
        want = sorted(b"%s\t%d\t%r\t%s" % (
            m.id, m.time_nanos, m.value, str(m.storage_policy).encode())
            for m in cap.metrics)
        log = os.path.join(root, "agg", "flush.log")

        def lines():
            if not os.path.exists(log):
                return []
            with open(log, "rb") as f:
                return f.read().splitlines()

        flush_s = _await(lambda: len(lines()) >= len(want),
                         "services (d): the aggregator child's flush log",
                         SVC_WAIT_S)
        got = sorted(lines())
        check(got == want and len(want) == n,
              f"services (d): the flush log's {len(got)} rows differ from "
              f"the device=\"cpu\" Aggregator's {len(want)}")
        _card(f"services (d) aggregator child: {n * SVC_POINTS} samples "
              f"from the Reporter in {send_s!r} s "
              f"({n * SVC_POINTS / send_s!r} samples/s); its flush log's "
              f"{len(got)} rows, {flush_s!r} s after the sends, equal the "
              f"device=\"cpu\" Aggregator's")
    finally:
        for close in reversed(closers):
            close()


def _svc_log_lines(log: str) -> list:
    if not os.path.exists(log):
        return []
    with open(log, errors="replace") as f:
        return f.readlines()


def _svc_log_count(log: str, text: str) -> int:
    return sum(text in ln for ln in _svc_log_lines(log))


def _svc_crash_restart(ops, ports, root, acked, state, stops) -> dict:
    """(b) SIGTERM the (a) child, start the same node under
    Panicmon(restart_on_crash=True) (its output to a log), SIGKILL it;
    the restart's serving-ready line; every acknowledged point read back
    bit for bit through a Session on the card and through query_range;
    then (d)'s standalone coordinator; a SIGTERM ends the node. Returns
    the restarted child's kernel launches, printed as it closed."""
    import shlex
    import signal

    from m3_tpu_torch.client import Session, SessionOptions
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.cluster.topology import StaticTopology
    from m3_tpu_torch.index.query import TermQuery
    from m3_tpu_torch.utils.panicmon import Panicmon

    here = os.path.dirname(os.path.abspath(__file__))
    node = ops["node"]
    coord = f"http://127.0.0.1:{ports['coord']}"
    node_ep = f"127.0.0.1:{ports['node']}"
    proc = node._proc
    apps = _svc_compute_apps()
    s0 = time.perf_counter()
    node.stop(grace_s=120)
    stop_s = time.perf_counter() - s0
    check(proc.returncode == 0,
          f"services (b): SIGTERM ended the node with {proc.returncode}")
    # The only process that stops here is the node child: the card lists
    # one CUDA context fewer, so the child held one.
    after = _svc_compute_apps()
    check(len(after) == len(apps) - 1,
          f"services (b): the card's compute apps {apps} before the node "
          f"child stopped, {after} after")
    log = os.path.join(root, "node", "panicmon.log")
    argv = ["/bin/sh", "-c", f"cd {shlex.quote(here)} && exec "
            f"{shlex.join(node.argv())} >> {shlex.quote(log)} 2>&1"]
    p0 = time.perf_counter()
    mon = Panicmon(argv, restart_on_crash=True, max_restarts=1,
                   backoff_s=0.1).start()
    stops.append(lambda: mon.stop(grace_s=120))
    _await(lambda: _svc_log_count(log, "embedded coordinator on") >= 1,
           "services (b): the node under Panicmon listening", SVC_SPAWN_S)
    first_up = time.perf_counter() - p0
    k0 = time.perf_counter()
    os.kill(mon._proc.pid, signal.SIGKILL)
    fed = _svc_fed_start(ops, ports, root, stops)
    ready = _await(
        lambda: _svc_log_count(log, "dbnode serving-ready") >= 2,
        "services (b): the restarted node's serving-ready line",
        SVC_SPAWN_S)
    _await(lambda: _svc_log_count(log, "embedded coordinator on") >= 2,
           "services (b): the restarted node listening", SVC_SPAWN_S)
    listen = time.perf_counter() - k0
    check(mon.restarts == 1 and mon.exit_codes[:1] == [-signal.SIGKILL],
          f"services (b): Panicmon restarts {mon.restarts}, exit codes "
          f"{mon.exit_codes}")
    with open(log, errors="replace") as f:
        boot = [ln.strip() for ln in f if "dbnode serving-ready" in ln]
    check(f"series={SVC_SERIES} " in boot[-1],
          f"services (b): the restart's {boot[-1]!r}")
    sess = Session(StaticTopology(initial_placement(
        [Instance("node0", node_ep)], SVC_SHARDS, 1)),
        SessionOptions(timeout_s=600))
    try:
        f0 = time.perf_counter()
        got = sess.fetch_tagged(b"default", TermQuery(
            b"__name__", b"bench_requests"), 0, 2**62)
        fetch_s = time.perf_counter() - f0
    finally:
        sess.close()
    id_of = {}
    for sid, e in got.items():
        i = e["tags"][b"i"]
        id_of[sid] = i
        wt, wv = acked[i]
        check(np.asarray(e["t"]).tobytes() == wt.tobytes()
              and _bits(e["v"]) == _bits(wv),
              f"services (b): series i={i!r} reads back otherwise")
    check(len(got) == len(acked) == SVC_SERIES,
          f"services (b): {len(got)} of {len(acked)} series read back")
    first = state["first"]
    code, out = _http(_svc_range_url(coord, SVC_READ_MATCH, first,
                                     first + _svc_span_s(),
                                     str(SVC_POINT_MS / 1e3)))
    check(code == 200, f"services (b): query_range answered {code}")
    res = json.loads(out)["data"]["result"]
    for r in res:
        wt, wv = acked[r["metric"]["i"].encode()]
        check([round(float(p[0]) * 1e3) * 10**6 for p in r["values"]]
              == wt.tolist()
              and _bits([float(p[1]) for p in r["values"]]) == _bits(wv),
              f"services (b): query_range of i={r['metric']['i']} differs")
    check(len(res) == SVC_SERIES // SVC_HOSTS,
          f"services (b): query_range read {len(res)} series")
    _card(f"services (b) crash: SIGTERM closed the node in {stop_s!r} s "
          f"(the card's compute apps {apps} before, one fewer after); "
          f"under Panicmon spawn to listening {first_up!r} s; SIGKILL to "
          f"serving-ready {ready!r} s, to listening {listen!r} s "
          f"({boot[-1]}); {SVC_SERIES * SVC_POINTS} acknowledged points, 0 "
          f"lost: a Session's fetch_tagged on the card in {fetch_s!r} s and "
          f"{len(res)} series through query_range, bit for bit")
    _svc_fed_check(ports, state, fed)
    pid = mon._proc.pid
    mon.stop(grace_s=120)
    check(mon.exit_codes[-1] == 0,
          f"services (b): SIGTERM ended the restarted node {pid} with "
          f"{mon.exit_codes}")
    state["id_of"] = id_of
    return _svc_launches(_svc_log_lines(log), "the restarted node")


def _svc_fed_start(ops, ports, root, stops) -> dict:
    """(d) The parent publishes the node in a placement to the kv child and
    starts a standalone coordinator child on a thread, while the node
    restarts: its Session reaches the node only when it is asked."""
    import functools
    import threading

    from m3_tpu_torch import em
    from m3_tpu_torch.cluster.kv_service import RemoteStore
    from m3_tpu_torch.cluster.placement import Instance, PlacementService

    admin = RemoteStore(ops["kv"].endpoint)
    try:
        PlacementService(admin, "_placement").init(
            [Instance("node0", f"127.0.0.1:{ports['node']}")], SVC_SHARDS, 1)
    finally:
        admin.close()
    op = ops["fed"] = em.Operator(os.path.join(root, "fed"))
    op.setup(em.ProcessSpec("coordinator", json.dumps({
        "listen_address": "127.0.0.1:0",
        "kv_endpoint": ops["kv"].endpoint, "namespace": "default"}),
        op.workdir))
    stops.append(functools.partial(op.stop, grace_s=120))
    out = {"op": op}
    out["thread"] = threading.Thread(
        target=lambda: out.update(_svc_spawn([("coordinator", op)])))
    out["thread"].start()
    return out


def _svc_fed_check(ports, state, fed) -> None:
    """(d) SVC_FED_QUERY through the standalone coordinator (its Session
    fetches from the restarted node) equals the same query through the
    node's embedded coordinator; a SIGTERM ends the child."""
    fed["thread"].join(SVC_SPAWN_S + 60)
    check("coordinator" in fed, "services (d): the standalone coordinator "
                                "did not start")
    op = fed["op"]
    first = state["first"]
    urls = [_svc_range_url(base, SVC_FED_QUERY, first + _svc_span_s() - 5,
                           first + _svc_span_s(), "1")
            for base in (op.endpoint, f"http://127.0.0.1:{ports['coord']}")]
    q0 = time.perf_counter()
    code, got = _http(urls[0])
    fed_s = time.perf_counter() - q0
    check(code == 200, f"services (d): the standalone coordinator "
                       f"answered {code}: {got[:200]!r}")
    code, emb = _http(urls[1])
    check(code == 200, f"services (d): the embedded coordinator {code}")
    err = _svc_prom(SVC_FED_QUERY, got, emb, "standalone against embedded")
    proc = op._proc
    op.stop(grace_s=120)
    check(proc.returncode == 0,
          f"services (d): SIGTERM ended the coordinator with "
          f"{proc.returncode}")
    _card(f"services (d) standalone coordinator child: spawn to listening "
          f"{fed['coordinator']!r} s (beside the node's restart); "
          f"{SVC_FED_QUERY} through its Session in {fed_s!r} s equals the "
          f"embedded coordinator's (max rel diff {err!r}, bytes equal "
          f"{got == emb})")


def _svc_tools(root, acked, state) -> dict:
    """(c) The tools as CLI children on the card after the SIGTERM, all
    started at once: verify_index_files and read_data_files for each shard
    with filesets (exit 0; the rows equal the acknowledged points), and
    verify_index_files on a clone_fileset copy (host only, in this
    process) with one flipped byte (exit 1 naming that fileset). Returns
    the children's kernel launches, summed from their stderr."""
    from m3_tpu_torch.persist.fs import PersistManager
    from m3_tpu_torch.tools import fileset_tools as ft

    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "node", "data")
    shards = [s for s in range(SVC_SHARDS)
              if PersistManager(data).list_filesets(b"default", s)]
    check(shards, "services (c): no fileset on disk")
    clone = os.path.join(root, "clone")

    def common(r, s):
        return ["--root", r, "--namespace", "default", "--shard", str(s)]

    def run_all(cmds):
        """Start every command at once, each writing to its own file;
        {key: (exit code, stdout, stderr)}."""
        procs = {}
        for key, argv in cmds.items():
            out = os.path.join(root, "tool-%s-%d.out" % key)
            with open(out, "w") as fo, open(out + ".err", "w") as fe:
                procs[key] = (subprocess.Popen(argv, cwd=here, stdout=fo,
                                               stderr=fe), out)
        res = {}
        for key, (p, out) in procs.items():
            try:
                p.wait(timeout=SVC_WAIT_S)
            except subprocess.TimeoutExpired:
                for q, _ in procs.values():
                    q.kill()
                check(False, f"services (c): {key} not within {SVC_WAIT_S} s")
            res[key] = (p.returncode, open(out).read(),
                        open(out + ".err").read())
        return res

    t0 = time.perf_counter()
    cmds = {}
    for s in shards:
        cmds[("verify", s)] = _svc_tool("verify_index_files",
                                        *common(data, s))
        cmds[("read", s)] = _svc_tool("read_data_files", *common(data, s))
    path, = ft.clone_fileset(data, clone, b"default", shards[0],
                             state["block"] * 10**9)
    with open(os.path.join(path, "data.bin"), "r+b") as f:
        f.seek(64)
        b = f.read(1)
        f.seek(64)
        f.write(bytes([b[0] ^ 0x10]))
    cmds[("verify-clone", shards[0])] = _svc_tool(
        "verify_index_files", *common(clone, shards[0]))
    res = run_all(cmds)
    tools_s = time.perf_counter() - t0
    launches = {}
    for key, (_, _, err) in res.items():
        for k, n in _svc_launches(err.splitlines(), f"tools {key}").items():
            launches[k] = launches.get(k, 0) + n
    rows = {}
    rc, out, err = res.pop(("verify-clone", shards[0]))
    flipped = json.loads(out) if out else {}
    check(rc == 1 and [p for p, _ in flipped.get("corrupt", [])] == [path],
          f"services (c): the flipped clone: exit {rc}, {out[:300]!r} "
          f"{err[-300:]!r}")
    for key, (rc, out, err) in res.items():
        check(rc == 0, f"services (c): {key} exited {rc}: {err[-500:]}")
        if key[0] == "verify":
            v = json.loads(out)
            check(v["ok"] and not v["corrupt"],
                  f"services (c): shard {key[1]} verify {v}")
        elif key[0] == "read":
            for ln in out.splitlines():
                sid, ts, val = ln.rsplit(" ", 2)
                r = rows.setdefault(sid.encode(), ([], []))
                r[0].append(int(ts))
                r[1].append(float(val))
    id_of = state["id_of"]
    check(len(rows) == SVC_SERIES, f"services (c): read {len(rows)} series")
    for sid, (ts, vals) in rows.items():
        wt, wv = acked[id_of[sid]]
        check(ts == wt.tolist() and _bits(vals) == _bits(wv),
              f"services (c): read_data_files of {sid!r} differs")
    n_rows = sum(len(r[0]) for r in rows.values())
    _card(f"services (c) tools: {len(cmds)} CLI children at once in "
          f"{tools_s!r} s: verify_index_files exits 0 on the {len(shards)} "
          f"shards with filesets, read_data_files' {n_rows} rows equal the "
          f"acknowledged points; one flipped byte in a clone_fileset copy: "
          f"verify_index_files exits 1 naming it "
          f"({flipped['corrupt'][0][1]!r}); their kernel launches "
          f"{launches}")
    return launches


# -- phase 17: the harnesses --------------------------------------------------

HARNESS_KILL_SEED, HARNESS_DISK_SEED, HARNESS_COMPUTE_SEED = 7, 7, 19


def _harness_dumps(directory: str, prefix: str) -> list:
    """The JSON dumps a witness wrote into `directory` (one a process)."""
    names = sorted(f for f in os.listdir(directory)
                   if f.startswith(prefix) and f.endswith(".json")) \
        if os.path.isdir(directory) else []
    out = []
    for name in names:
        with open(os.path.join(directory, name)) as f:
            out.append(json.load(f))
    return out


def _harness_kill(root: str) -> dict:
    """Phase 17 (a): the kill -9 drill at its base variant, its dbnode
    children on the card under both witnesses. Returns the restarted
    child's launches (the SIGKILLed child's die with it)."""
    from m3_tpu_torch.testing import scenario

    ld_dir = os.path.join(root, "lockdep")
    rw_dir = os.path.join(root, "racewatch")
    os.makedirs(os.path.join(root, "drill"))
    t0 = time.perf_counter()
    drill = scenario.KillRestartScenario(scenario.KillRestartOptions(
        seed=HARNESS_KILL_SEED, data_dir=os.path.join(root, "drill"),
        child_env=(("M3_TPU_LOCKDEP", "1"), ("M3_TPU_LOCKDEP_OUT", ld_dir),
                   ("M3_TPU_RACEWATCH", "1"),
                   ("M3_TPU_RACEWATCH_OUT", rw_dir))))
    try:
        res = drill.verify(drill.run())
        child = drill.stop_child(timeout_s=120)
    finally:
        drill.close()
    secs = time.perf_counter() - t0
    check(res.verified_points == res.acked_points > 0,
          f"harness (a): verified {res.verified_points} of "
          f"{res.acked_points} acked points")
    check(res.torn_tail_bytes > 0, "harness (a): no torn tail was injected")
    budget = drill.opts.restart_budget_s
    check(all(w <= budget for w in res.restart_walls_s[1:])
          and all(b <= budget for b in res.bootstrap_s[1:]),
          f"harness (a): restart {res.restart_walls_s}, bootstrap "
          f"{res.bootstrap_s} past {budget} s")
    check(child is not None, "harness (a): the restarted child printed no "
          "kernel launches as it closed")
    locks = _harness_dumps(ld_dir, "lockdep-")
    races = _harness_dumps(rw_dir, "racewatch-")
    check(locks and races, f"harness (a): witness dumps: {len(locks)} "
          f"lockdep, {len(races)} racewatch")
    cycles = [c for d in locks for c in d["cycles"]]
    check(not cycles, f"harness (a): lockdep cycles {cycles}")
    _harness_reconcile(ld_dir, rw_dir)
    edges = sum(len(d["edges"]) for d in locks)
    observed = sum(d["observed"] for d in races)
    racy = {a["attr"]: len(a["racy"]) for d in races for a in d["attrs"]
            if a["racy"]}
    rep = res.report
    _card(f"harness (a) kill-restart drill, seed {HARNESS_KILL_SEED}, "
          f"children on the card: {res.acked_points} points acked, all "
          f"verified after the SIGKILL and a torn WAL tail of "
          f"{res.torn_tail_bytes} bytes; the fresh child's first write "
          f"{res.first_write_s!r} s; spawn to listening "
          f"{res.restart_walls_s!r} s; bootstrap_s {res.bootstrap_s!r}; "
          f"outcomes {rep.outcomes()}; {secs!r} s")
    _card(f"harness (a) witnesses in the restarted child: lockdep "
          f"{len(locks)} dump(s), {edges} edges, 0 cycles; racewatch "
          f"{observed} observed access profiles, racy pairs by attribute "
          f"{racy}; its launches {child}")
    return child


# Locks only the card takes: the kernels' extension build and the query
# path's upload cache (ops/temporal._cached_put puts through it on `cuda`
# only). Phase 17 (a) prints the witnessed edges that touch them.
CARD_ONLY_LOCKS = ("codec_kernels._BUILD_LOCK", "temporal._PUT_CACHE_LOCK")


def _harness_reconcile(ld_dir: str, rw_dir: str) -> None:
    """Phase 17 (a)'s dumps held to the static model: lockdep's edges to
    the static lock graph and the reconcile ledger (no cycle, none
    unreconciled), racewatch's racy pairs to the lock-free ledger and the
    protection model (m3_tpu_torch.analysis.witness)."""
    from m3_tpu_torch.analysis import witness

    print("harness (a) lockdep against the static lock graph:", flush=True)
    rc = witness.lockdep_check([ld_dir], verbose=True)
    check(rc == 0, f"harness (a): witness lockdep exited {rc}")
    print("harness (a) racewatch against the lock-free ledger:", flush=True)
    rc = witness.race_check([rw_dir])
    check(rc == 0, f"harness (a): witness race exited {rc}")
    dumps = witness.load_dumps([ld_dir], "lockdep-*.json")
    seen, _, _ = witness.witnessed_edges(dumps)
    card = sorted(f"{a} -> {b} x{info['count']} ({info['site']})"
                  for (a, b), info in seen.items()
                  if a in CARD_ONLY_LOCKS or b in CARD_ONLY_LOCKS)
    _card(f"harness (a) edges through card-only locks {CARD_ONLY_LOCKS}: "
          f"{card or 'none witnessed'}")


class _StallProbe:
    """A thread that sleeps 1 ms at a time and records every wake-up later
    than `min_stall_s`: while another thread holds the interpreter (a
    long call that does not release the GIL) or the host is starved,
    nothing in the process runs, a read's handler included. Each stall is
    (start on the monotonic clock, seconds, where the churn thread's
    thread stood when the probe woke: its innermost frame in the port)."""

    def __init__(self, min_stall_s: float = 0.02):
        import threading

        self.min_stall_s = min_stall_s
        self.stalls = []
        self.threads = []   # (monotonic time, live threads), every 50 ms
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="churn-witness-probe")

    @staticmethod
    def _driver_frame() -> str:
        import threading

        for t in threading.enumerate():
            if t.name == "churn-driver":
                f = sys._current_frames().get(t.ident)
                while f is not None and "m3_tpu_torch" not in \
                        f.f_code.co_filename:
                    f = f.f_back
                if f is not None:
                    return (f"{f.f_code.co_filename.rsplit('m3_tpu_torch/', 1)[-1]}"
                            f":{f.f_code.co_name}:{f.f_lineno}")
        return "-"

    def _loop(self):
        import threading

        last = sampled = time.monotonic()
        while not self._stop.is_set():
            time.sleep(0.001)
            now = time.monotonic()
            late = now - last - 0.001
            if late > self.min_stall_s:
                self.stalls.append((last, late, self._driver_frame()))
            if now - sampled >= 0.05:
                self.threads.append((now, threading.active_count()))
                sampled = now
            last = now

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def within(self, t0: float, t1: float):
        """The stalls that overlap [t0, t1), longest first."""
        return sorted((s for s in self.stalls if s[0] < t1 and
                       s[0] + s[1] > t0), key=lambda s: -s[1])


def _churn_witness(runs: int) -> int:
    """Phase 17 (b)'s churn drill `runs` times in one process under the
    lockdep witness: each run's read and write p99, its churn ops and
    interpreter stalls, and the five locks that parked longest in it
    (seconds summed over its contended acquires, and the longest park),
    then the verdict against the static model over all runs."""
    import tempfile

    from m3_tpu_torch.analysis import witness
    from m3_tpu_torch.testing import scenario
    from m3_tpu_torch.utils import lockdep

    check(lockdep.installed(), "churn witness: lockdep is not installed")
    graph = lockdep.witness_graph()
    starts = []
    real_run = scenario.LoadGen.run

    def timed_run(self, fn, join_timeout_s=30.0):
        starts.append(time.monotonic())
        return real_run(self, fn, join_timeout_s)

    ops = []
    real_op = scenario.ChurnScenario._churn_op

    def timed_op(self, op):
        t = time.monotonic()
        try:
            return real_op(self, op)
        finally:
            ops.append((op, t, time.monotonic() - t))

    scenario.LoadGen.run = timed_run
    scenario.ChurnScenario._churn_op = timed_op
    out_dir = tempfile.mkdtemp(prefix="m3-churn-witness-")
    reads = []
    for i in range(runs):
        before = graph.snapshot()
        t0 = time.perf_counter()
        drill = scenario.ChurnScenario(scenario.ChurnScenarioOptions(
            trace_reads=True))
        try:
            ops.clear()
            with _gc_pauses() as pauses, _StallProbe() as probe:
                res = drill.run()
            try:
                drill.verify(res)
                verdict = "verify ok"
            except AssertionError as err:
                verdict = f"verify FAILED: {str(err)[:300]}"
        finally:
            drill.close()
        rep = res.report
        slow = sorted(rep.select(kind="read", outcome="ok"),
                      key=lambda r: -r.latency_s)[:5]
        after = graph.snapshot()
        times = witness.block_times([("run", after)])
        for key, (parks, secs, _mx) in witness.block_times(
                [("run", before)]).items():
            times[key][0] -= parks
            times[key][1] -= secs
        top = witness.longest_blocked(
            {k: v for k, v in times.items() if v[0]})
        read_p99 = rep.quantile_latency(0.99, kind="read")
        reads.append(read_p99)
        _card(f"churn witness run {i + 1}/{runs}: read p99 {read_p99!r} s, "
              f"write p99 {rep.quantile_latency(0.99, kind='write')!r} s, "
              f"outcomes {rep.outcomes()}, {verdict}; "
              f"{time.perf_counter() - t0!r} s; longest blocked edges "
              f"(from, to, parks, seconds, longest park) {top}; slowest "
              f"reads (due s, phase, latency s) "
              f"{[(r.t_due_s, r.phase, r.latency_s) for r in slow]}; full "
              f"GC pauses (ms) {pauses}")
        # What ran while the slowest reads were in flight (from the
        # earliest one's due time to the latest one's end): the churn ops
        # and the interpreter stalls, in seconds into the load.
        base = starts[-1]
        lo = min(r.t_due_s for r in slow) if slow else 0.0
        hi = max(r.t_due_s + r.latency_s for r in slow) if slow else 0.0
        stalls = probe.within(base + lo, base + hi)
        _card(f"churn witness run {i + 1}/{runs}: from {lo!r} to {hi!r} s "
              f"into the load: churn ops (op, start s, seconds) "
              f"{[(op, t - base, d) for op, t, d in ops]}; "
              f"{len(stalls)} interpreter stalls over "
              f"{probe.min_stall_s * 1e3:g} ms summing "
              f"{sum(d for _t, d, _f in stalls)!r} s, the longest (start s, "
              f"seconds, the churn thread's frame) "
              f"{[(t - base, d, f) for t, d, f in stalls[:5]]}; every "
              f"stall over 100 ms in the run (start s into the load, "
              f"seconds): {[(t - base, d) for t, d, _f in probe.stalls if d > 0.1]}")
        _churn_split(i + 1, runs, drill, probe, base)
    scenario.ChurnScenario._churn_op = real_op
    scenario.LoadGen.run = real_run
    lockdep.dump_now(os.path.join(out_dir, f"lockdep-{os.getpid()}.json"))
    rc = witness.lockdep_check([out_dir], verbose=True)
    _card(f"churn witness: read p99 over {runs} runs {reads!r}; witness "
          f"lockdep exited {rc}")
    return 0 if rc == 0 else 1


def _churn_split(run: int, runs: int, drill, probe, base: float) -> None:
    """One churn-witness run's op steps (ChurnScenario.op_steps) and the
    served reads each held: per op, each step's count and seconds, the
    reads in flight during it (their number, the slowest latency and
    where their seconds went, ReadTrace.waits, summed) and the
    interpreter stalls inside it; then the five slowest reads, each with
    its waits, the step that ran when it started and the stalls over it.
    Times are seconds into the load."""
    reads = [r for r in drill.read_traces if r.outcome == "ok"]
    ops = []
    for s in drill.op_steps:
        if s.op not in ops:
            ops.append(s.op)
    for op in ops:
        steps = [s for s in drill.op_steps if s.op == op]
        lo = min(s.start for s in steps)
        hi = max(s.start + s.seconds for s in steps)
        parts = []
        for name in dict.fromkeys(s.step for s in steps):
            spans = [(s.start, s.start + s.seconds) for s in steps
                     if s.step == name]
            held = [r for r in reads
                    if any(r.start < b and r.end > a for a, b in spans)]
            waits = {}
            for r in held:
                for k, v in r.waits().items():
                    waits[k] = waits.get(k, 0.0) + v
            stalls = sum(min(t + d, b) - max(t, a) for a, b in spans
                         for t, d, _f in probe.within(a, b))
            threads = max((n for t, n in probe.threads
                           if any(a <= t < b for a, b in spans)), default=0)
            parts.append(
                (name, len(spans), round(sum(b - a for a, b in spans), 4),
                 len(held),
                 round(max((r.end - r.start for r in held), default=0.0), 4),
                 {k: round(v, 4) for k, v in waits.items()},
                 round(stalls, 4), threads))
        _card(f"churn split run {run}/{runs}: {op} from {lo - base!r} to "
              f"{hi - base!r} s (step, times, seconds, reads in flight, "
              f"slowest s, their waits summed s, interpreter stalls s, "
              f"most live threads) {parts}")
    slow = sorted(reads, key=lambda r: r.start - r.end)[:5]
    out = []
    for r in slow:
        running = sorted((s for s in drill.op_steps
                          if s.start <= r.start < s.start + s.seconds),
                         key=lambda s: s.seconds)
        where = f"{running[0].op}: {running[0].step}" if running else "-"
        stall = sum(min(t + d, r.end) - max(t, r.start)
                    for t, d, _f in probe.within(r.start, r.end))
        out.append((round(r.start - base, 4), round(r.end - r.start, 4),
                    {k: round(v, 4) for k, v in r.waits().items()}, where,
                    round(stall, 4)))
    _card(f"churn split run {run}/{runs}: slowest reads (start s, latency "
          f"s, waits s, the step running at its start, interpreter stalls "
          f"over it s) {out}")


def _lint_phase(here: str) -> None:
    """Phase 19: m3lint over the checkout's m3_tpu_torch/, host only;
    zero findings, the files analyzed and the wall time printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "m3_tpu_torch.analysis", "m3_tpu_torch/",
         "--jobs", "0", "--no-cache"],
        cwd=here, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [proc.stderr[-500:]]
    _card(f"lint: phase 19 in {secs!r} s: {tail[0]}")
    check(proc.returncode == 0,
          f"lint: m3lint exited {proc.returncode}: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    phase(f"lint: m3lint clean over m3_tpu_torch/ in {secs:.1f}s")


def _harness_churn() -> dict:
    """Phase 17 (b): ChurnScenario at its defaults on the card, every SLO
    of its verify(). Returns its warm-up's launches."""
    import gc
    import threading

    from m3_tpu_torch.testing import scenario

    t0 = time.perf_counter()
    # What the earlier phases left in the process, and the full GCs inside
    # the drill: each full GC walks every tracked object and holds the
    # interpreter the reads wait on (ROADMAP C2).
    tracked, threads = len(gc.get_objects()), threading.active_count()
    drill = scenario.ChurnScenario(scenario.ChurnScenarioOptions())
    try:
        with _gc_pauses() as pauses:
            res = drill.run()
        ops = {}
        for s in drill.op_steps:
            lo, hi = ops.get(s.op, (s.start, s.start))
            ops[s.op] = (min(lo, s.start), max(hi, s.start + s.seconds))
        _card(f"harness (b) churn drill: {tracked} objects tracked by the "
              f"GC and {threads} threads before it; full GC pauses (ms) "
              f"in it {pauses}; its ops (op, seconds) "
              f"{[(op, round(b - a, 4)) for op, (a, b) in ops.items()]}")
        res = drill.verify(res)
    finally:
        drill.close()
    rep = res.report
    ok = len(rep.select(outcome="ok"))
    _card(f"harness (b) churn drill at its defaults (4 nodes, RF=3, 16 "
          f"shards, 48 series, 60 requests/s for 4 s): write p99 "
          f"{rep.quantile_latency(0.99, kind='write')!r} s, read p99 "
          f"{rep.quantile_latency(0.99, kind='read')!r} s, ok "
          f"{ok}/{len(rep.records)}, outcomes {rep.outcomes()}; churn "
          f"{res.churn_log}; {res.verified_points} acked points verified, "
          f"{res.checksum_blocks_checked} blocks replica-equal; gate depth "
          f"{res.max_gate_depth} of {res.gate_capacity}; "
          f"{time.perf_counter() - t0!r} s")
    return drill.warm_launches


def _harness_disk() -> dict:
    """Phase 17 (c): the disk-fault drill on the card. Returns its
    warm-up's launches."""
    from m3_tpu_torch.testing import scenario

    t0 = time.perf_counter()
    drill = scenario.DiskFaultScenario(scenario.DiskFaultScenarioOptions(
        seed=HARNESS_DISK_SEED))
    try:
        res = drill.verify(drill.run())
    finally:
        drill.close()
    rep = res.report
    _card(f"harness (c) disk-fault drill, seed {HARNESS_DISK_SEED}: "
          f"{res.quarantined_after_faults} filesets quarantined under bit "
          f"rot, scrub {res.scrub_stats}, {res.quarantined_after_scrub} "
          f"left; read-only tripped {res.health_tripped}, NORMAL shed "
          f"{res.normal_shed}, CRITICAL served {res.critical_served}, "
          f"recovered {res.recovered}; {res.verified_points} acked points "
          f"verified, {res.filesets_verified} filesets row-verified; write "
          f"p99 {rep.quantile_latency(0.99, kind='write')!r} s, read p99 "
          f"{rep.quantile_latency(0.99, kind='read')!r} s; "
          f"{time.perf_counter() - t0!r} s")
    return drill.warm_launches


def _harness_compute() -> dict:
    """Phase 17 (d): the compute-fault churn drill on the card: faults
    injected, every guarded outcome explained by its decisions. Returns
    its warm-up's launches."""
    from m3_tpu_torch.testing import scenario

    t0 = time.perf_counter()
    drill = scenario.ComputeFaultChurnScenario(
        scenario.ComputeFaultChurnOptions(seed=HARNESS_COMPUTE_SEED))
    try:
        res = drill.verify(drill.run())
    finally:
        drill.close()
    seam, audit = drill.compute_seam, drill.audit
    check(seam.faults_injected > 0 and audit.calls
          and not audit.unexplained(),
          "harness (d): compute faults not injected or not explained")
    kinds = {}
    for ds in seam.decisions.values():
        for d in ds:
            kinds[d] = kinds.get(d, 0) + 1
    rep = res.report
    _card(f"harness (d) compute-fault churn drill, seed "
          f"{HARNESS_COMPUTE_SEED}: {seam.faults_injected} faults injected "
          f"(decisions {kinds}); {len(audit.calls)} guarded dispatches, "
          f"{audit.raised()} raised typed, every one explained by its "
          f"decisions; outcomes {rep.outcomes()}; churn {res.churn_log}, "
          f"deferred {drill.deferred_log}; {res.verified_points} acked "
          f"points verified; {time.perf_counter() - t0!r} s")
    return drill.warm_launches


def _harness_phase() -> dict:
    """Phase 17: the harnesses on the card. (a) the kill -9 drill with its
    dbnode children on the card under the lockdep and racewatch witnesses;
    (b) the churn drill at its defaults; (c) the disk-fault drill; (d) the
    compute-fault churn drill. Returns the kernels' launches over the
    phase: this process's (the in-process clusters and the drill's
    sessions; counts set to 0 just before), less the drills' warm-ups,
    and the restarted child's from its listen line, printed as it closed
    (the SIGKILLed child's are not seen)."""
    import gc
    import shutil
    import tempfile
    import threading

    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    so = ck.BUILD_DIR / "m3_tpu_torch_kernels.so"
    so_mtime = so.stat().st_mtime_ns if so.exists() else None
    # The earlier phases' live objects leave the collector's scans, as in
    # a process of the drills' own: a full collection over them inside a
    # drill's window would be billed to its p99.
    gc.collect()
    gc.freeze()
    threads = threading.active_count()
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="m3-harness-")
    try:
        child = _harness_kill(root)
        warm = [_harness_churn(), _harness_disk(), _harness_compute()]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.unfreeze()
    check(so_mtime is None or so.stat().st_mtime_ns == so_mtime,
          "harness: a child rebuilt the kernels' extension")
    torch.cuda.synchronize()
    own = dict(ck.launch_counts(), window=wk.window_stat.launches)
    # The in-process drills' warm-ups (one write, seal and read each before
    # the drill's window opens) are start-up work, as a child's are (it
    # counts from its listen line): the path's count leaves them out.
    warm_sum = {k: sum(w.get(k, 0) for w in warm) for k in own}
    launches = {k: own[k] - warm_sum[k] + child.get(k, 0) for k in own}
    secs = time.perf_counter() - t0
    _card(f"harness: phase 17 in {secs!r} s, launches {launches} (this "
          f"process's {own} less its drills' warm-ups {warm_sum}; the "
          f"restarted child's {child}, counted from its listen line; the "
          f"SIGKILLed child's are not seen); {threads} threads alive at "
          f"its start")
    check(all(launches[k] > 0 for k in ("pack", "decode", "hash")),
          f"phase 17 did not launch every kernel of its path: {launches}")
    phase(f"harness: four drills held to their verify on the card in "
          f"{secs:.1f}s")
    return launches


# Phase 18: the mesh. The north star's shard (100,000 series x 120 points,
# seed 7) as a 2-chunk batch; PR 4's storage tile (32,768 series x 256
# points) sealed through Shard.tick; phase 11 (b)'s timer tile;
# bench_promql's 10,000 counters x 360; the plan corpus.
MESH_SPLIT = 4
MESH_SEAL_SERIES, MESH_SEAL_POINTS = 32_768, 256
MESH_RATE_W = 30                      # [5m] at the corpus' 10 s
MESH_PLAN_QUERIES = ("sum by (host) (rate(bench_requests[5m]))",
                     "max by (host) (rate(bench_requests[5m]))",
                     "avg_over_time(bench_requests[5m])",
                     "sum by (host) (max_over_time(bench_requests[5m]))",
                     "stddev(rate(bench_requests[5m]))")


def _mesh_phase(corpus, plan_corpus, t) -> dict:
    """Phase 18: every mesh route on the card split four ways
    (`attach([cuda:0] * 4)`, a (2, 2) shard x time mesh), each held
    against the single-device call on the same inputs. (a) the sharded
    ingest step; (b) a seal through Shard.tick; (c) quantile_rank_rows;
    (d) sum_rate and agg_rate's five ops; (e) compiled plans over the
    query mesh; (f) dryrun_multichip. Returns the kernels' launches over
    the mesh calls alone (each count set to 0 just before a mesh call and
    read just after; the single-device calls they are held against are
    not counted)."""
    import torch

    from m3_tpu_torch import ops
    from m3_tpu_torch.device import attach
    from m3_tpu_torch.utils.instrument import ROOT

    t0 = time.perf_counter()
    launches = dict.fromkeys(REPLACES, 0)

    def on_mesh(fn):
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        out = fn()
        torch.cuda.synchronize()
        for k, n in ops.kernel_launches().items():
            launches[k] += n
        return out

    def dispatches():
        snap = ROOT.snapshot()
        return {k.split("kernel=")[1].rstrip("}"): v for k, v in snap.items()
                if k.startswith("telemetry.mesh.dispatches{")}

    devs = [torch.device("cuda", 0)] * MESH_SPLIT
    with attach(devs):
        _mesh_ingest(on_mesh)
        _mesh_seal(on_mesh)
        _mesh_rank_rows(on_mesh)
        _mesh_rate(on_mesh, corpus)
        _mesh_plans(on_mesh, plan_corpus, t)
    _mesh_dryrun(on_mesh, devs)
    secs = time.perf_counter() - t0
    _card(f"mesh: phase 18 in {secs!r} s, launches {launches}, mesh "
          f"dispatches {dispatches()}")
    check(all(launches[k] > 0 for k in ("pack", "decode", "window")),
          f"phase 18 did not launch every kernel of its path: {launches}")
    phase(f"mesh: every split equals one device, in {secs:.1f}s")
    return launches


def _mesh_ingest(on_mesh) -> None:
    """(a) The sharded ingest step on the north star's shard as a 2-chunk
    batch: each chunk's words and nbits bit-equal to the single-device
    ingest_step of that chunk; the whole-window count/min/max/first/last
    bit-equal, sum/sumsq/m2 within the reorder bound of a plain reduction
    of the [N, T * W] values; every chunk decodes (K2) to its input."""
    import torch

    from m3_tpu_torch.ops import tsz
    from m3_tpu_torch.parallel import ingest

    s0 = time.perf_counter()
    ts, vals, _ = ingest.make_example_raw(N, W, np.random.default_rng(SEED))
    t_n, w = 2, W // 2
    parts = [ingest.make_batch_from_raw(
        ts[:, i * w:(i + 1) * w], vals[:, i * w:(i + 1) * w],
        np.full(N, w, np.int32), device="cpu") for i in range(t_n)]
    batch = ingest.IngestBatch(*(torch.stack(c) for c in zip(*parts)))
    prep_s = time.perf_counter() - s0
    mesh = ingest.make_mesh()
    check(mesh.shape == {"shard": 2, "time": 2}, f"mesh {mesh.shape}")
    mw = tsz.max_words_for(w)
    step = ingest.make_sharded_ingest(mesh, rollup_factor=FACTOR,
                                      max_words=mw)
    s1 = time.perf_counter()
    words, nbits, roll, qtl, whole, total_bits = on_mesh(
        lambda: step(ingest.shard_batch(batch, mesh)))
    step_s = time.perf_counter() - s1
    dec = on_mesh(lambda: [tsz.decode_batch(words[i], batch.npoints[i],
                                            window=w) for i in range(t_n)])
    for i in range(t_n):
        check(torch.equal(dec[i]["dt"].cpu(), batch.dt[i])
              and torch.equal(dec[i]["v"].cpu(), batch.v[i]),
              f"mesh (a): chunk {i} does not decode to its input")
        one = ingest.ingest_step(ingest.IngestBatch(*(a[i] for a in batch)),
                                 rollup_factor=FACTOR, max_words=mw)
        check(torch.equal(one[0], words[i]) and torch.equal(one[1], nbits[i]),
              f"mesh (a): chunk {i}'s words differ from one device's")
    v = batch.values.cuda().permute(1, 0, 2).reshape(N, t_n * w)
    _hold_stats(whole, _plain_stats(v, torch.ones_like(v, dtype=torch.bool)),
                "mesh (a) whole-window")
    check(int(total_bits) == int(nbits.to(torch.int64).sum()),
          "mesh (a): total_bits differs from the nbits' sum")
    torch.cuda.synchronize()
    _card(f"mesh (a) sharded ingest {N} x {t_n} x {w} on {mesh.shape}: "
          f"host prep {prep_s!r} s, the step {step_s!r} s (host clock); "
          f"bytes_per_datapoint {int(total_bits) / 8 / (N * W)!r}")


def _mesh_seal(on_mesh) -> None:
    """(b) A seal through Shard.tick on the storage tile: mesh_encode
    fires once, the words are bit-equal to the same encode on one device
    (nothing attached and M3_TPU_MESH_FLUSH=0, so no mesh route can run),
    and the block reads back (K2)."""
    from m3_tpu_torch.device import attach
    from m3_tpu_torch.parallel import ingest
    from m3_tpu_torch.storage import block as storage_block
    from m3_tpu_torch.storage.shard import Shard, ShardOptions
    from m3_tpu_torch.utils import xtime
    from m3_tpu_torch.utils.instrument import ROOT

    s0 = time.perf_counter()
    n, p = MESH_SEAL_SERIES, MESH_SEAL_POINTS
    _, vals, _ = ingest.make_example_raw(n, p, np.random.default_rng(SEED + 4))
    shard = Shard(0, ShardOptions())
    block = shard.opts.block_size_ns
    bs = (1_700_000_000 * 10**9 // block) * block
    ids = [b"mesh-%06d" % i for i in range(n)]
    for j in range(p):
        tj = bs + xtime.MINUTE + j * 10 * xtime.SECOND
        shard.write_batch(ids, np.full(n, tj, np.int64), vals[:, j], tj)
    write_s = time.perf_counter() - s0
    dense = shard.buffer.snapshot(bs)
    counter = storage_block._FLUSH_METRICS.counter("mesh_encode")
    before = counter.value()
    s1 = time.perf_counter()
    sealed = on_mesh(lambda: shard.tick(bs + block + 11 * xtime.MINUTE))
    tick_s = time.perf_counter() - s1
    check(sealed["sealed"] == 1 and counter.value() == before + 1,
          f"mesh (b): the seal did not take the mesh once ({sealed})")
    blk = shard.blocks[bs]
    flushes = ROOT.snapshot().get(
        "telemetry.mesh.dispatches{kernel=flush_encode}", 0)
    os.environ["M3_TPU_MESH_FLUSH"] = "0"
    try:
        with attach([]):
            one = storage_block.encode_block(bs, *dense)
    finally:
        del os.environ["M3_TPU_MESH_FLUSH"]
    check(counter.value() == before + 1 and ROOT.snapshot().get(
        "telemetry.mesh.dispatches{kernel=flush_encode}", 0) == flushes,
        "mesh (b): the single-device twin took the mesh")
    check(np.array_equal(blk.words, one.words)
          and np.array_equal(blk.nbits, one.nbits)
          and np.array_equal(blk.npoints, one.npoints),
          "mesh (b): the mesh seal's words differ from one device's")
    dt, dv, _ = on_mesh(blk.read_all)
    check(np.array_equal(dt, dense[1]) and np.array_equal(
        dv.view(np.int64), dense[2].view(np.int64)),
        "mesh (b): the mesh-sealed block does not read back")
    _card(f"mesh (b) seal of {n} x {p} through Shard.tick: writes "
          f"{write_s!r} s, tick {tick_s!r} s (host clock), "
          f"{int(blk.nbits.sum()) // 8} bytes")


def _mesh_rank_rows(on_mesh) -> None:
    """(c) quantile_rank_rows over the mesh on phase 11 (b)'s timer tile:
    the indices bit-equal to one device's."""
    from m3_tpu_torch.device import attach
    from m3_tpu_torch.parallel import agg_flush

    check(AGG_TILE is not None, "mesh (c): phase 11 left no timer tile")
    tile, counts, qs = AGG_TILE
    s0 = time.perf_counter()
    got = on_mesh(lambda: agg_flush.quantile_rank_rows(tile, counts, qs))
    mesh_s = time.perf_counter() - s0
    with attach([]):
        one = agg_flush.quantile_rank_rows(tile, counts, qs)
    check(np.array_equal(got, one), "mesh (c): the rank indices differ from "
          "one device's")
    _card(f"mesh (c) rank rows of {tile.shape} over the mesh: {mesh_s!r} s "
          f"(host clock, the H2D of the slices included)")


def _mesh_rate(on_mesh, corpus) -> None:
    """(d) sum_rate and agg_rate's five ops over the mesh on
    bench_promql's counters (its rate window, the corpus' 10 s step),
    each within rtol 1e-5 of the host reference (per-series rate on the
    card, an f64 NaN-excluding host reduce); count, min and max equal."""
    from m3_tpu_torch.ops import temporal
    from m3_tpu_torch.parallel import query as pq
    from m3_tpu_torch.query.executor import _default_query_mesh

    grid = np.stack([e["v"] for e in corpus.values()]).astype(np.float64)
    mesh = _default_query_mesh()
    check(mesh.shape == {"shard": MESH_SPLIT}, f"query mesh {mesh.shape}")
    kw = dict(W=MESH_RATE_W, step_ns=10 * 10**9,
              range_ns=MESH_RATE_W * 10 * 10**9)
    s0 = time.perf_counter()
    got = on_mesh(lambda: pq.sum_rate(grid, mesh, **kw))
    sum_s = time.perf_counter() - s0
    want = pq.sum_rate_host_reference(grid, **kw)
    check(np.allclose(got, want, rtol=1e-5, equal_nan=True),
          "mesh (d): sum_rate differs from its host reference")
    per = temporal.rate(grid, kw["W"], kw["step_ns"], kw["range_ns"])
    fin = np.isfinite(per)
    with np.errstate(all="ignore"):
        host = {"sum": np.nansum(per, 0), "count": fin.sum(0).astype(float),
                "avg": np.nansum(per, 0) / np.maximum(fin.sum(0), 1),
                "min": np.nanmin(per, 0), "max": np.nanmax(per, 0)}
    for op in pq.AGG_OPS:
        out = on_mesh(lambda: pq.agg_rate(grid, mesh, op=op, func="rate",
                                          **kw))
        ref = np.where(fin.any(0), host[op], np.nan)
        exact = op in ("count", "min", "max")
        check(np.allclose(out, ref, rtol=0 if exact else 1e-5, atol=0,
                          equal_nan=True),
              f"mesh (d): {op}(rate) differs from the host reference")
    _card(f"mesh (d) sum_rate over {grid.shape} on {mesh.shape}: {sum_s!r} s "
          f"(host clock, the host prep included); five agg_rate ops equal "
          f"the host reference")


def _mesh_plans(on_mesh, plan_corpus, t) -> None:
    """(e) The plan corpus' mesh_ok queries compiled over the query mesh
    (one CUDA graph over the four slices of the card), a miss and a
    replay each, held to the interpreter and to the single-device
    compiled answer under "compiled query answers"."""
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.testing import DictStorage

    storage = DictStorage(plan_corpus)
    eng = Engine(storage)
    one = Engine(storage, mesh=None)
    start, end = int(t[30]), int(t[-1])
    for q in MESH_PLAN_QUERIES:
        s0 = time.perf_counter()
        on_mesh(lambda: eng.execute_range(q, start, end, STEP_NS).values)
        miss_s = time.perf_counter() - s0
        s1 = time.perf_counter()
        blk = on_mesh(lambda: eng.execute_range(q, start, end, STEP_NS))
        blk.values
        hit_s = time.perf_counter() - s1
        route = eng.last_route()
        check(route["route"] == "compiled" and route.get("mesh") == {
            "shards": MESH_SPLIT, "executable": "graph"},
            f"mesh (e): {q} did not run as one graph over the mesh: {route}")
        err_ref = _check_plan(q, blk, eng.execute_range_ref(
            q, start, end, STEP_NS), "mesh vs interpreter")
        err_one = _check_plan(q, blk, one.execute_range(
            q, start, end, STEP_NS), "mesh vs one device")
        _card(f"mesh (e) {q}: miss {miss_s!r} s, replay {hit_s!r} s (host "
              f"clock); max rel diff {err_ref!r} vs the interpreter, "
              f"{err_one!r} vs one device")


def _mesh_dryrun(on_mesh, devs) -> None:
    """(f) dryrun_multichip over the card split four ways: the sharded
    ingest, the decode round trip, sum_rate and a coordinator whose
    query.sharded_agg fires over HTTP."""
    from m3_tpu_torch.parallel.dryrun import dryrun_multichip

    s0 = time.perf_counter()
    out = on_mesh(lambda: dryrun_multichip(devs))
    check(out["sharded_agg"] == 1, f"mesh (f): {out}")
    _card(f"mesh (f) dryrun_multichip {out} in "
          f"{time.perf_counter() - s0!r} s")


# Phase 20: the robustness tier (m3_tpu_torch/scripts) at the script's
# depth: each fuzz_codec bucket twice, 10 index and durability rounds, one
# cluster round of 6 ops (seed 7 draws add, replace and remove), both
# soaks at the reference's 30 s floor, the integration smoke whole.
ROBUST_SEED = 7
ROBUST_CODEC_ROUNDS = 8
ROBUST_INDEX_ROUNDS = ROBUST_DURABILITY_ROUNDS = 10
ROBUST_CLUSTER_OPS = 6
ROBUST_SOAK_S = 30
ROBUST_SERVICES = ("soak", "soak_aggregator", "integration_smoke")
ROBUST_WAIT_S = 420.0   # each service run's deadline


def _robustness_start(here: str) -> dict:
    """Phase 20's services, started: each of ROBUST_SERVICES as `python -m
    m3_tpu_torch.scripts.<name>` (no --device: the card), its output to a
    file. They run beside phases 18 and 19 and the campaigns; phase 20
    waits for them."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="m3-robustness-")
    env = dict(os.environ, SOAK_SECONDS=str(ROBUST_SOAK_S))
    procs = {}
    for name in ROBUST_SERVICES:
        log = open(os.path.join(out_dir, f"{name}.log"), "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", f"m3_tpu_torch.scripts.{name}"],
            cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT), log)
    return {"dir": out_dir, "procs": procs, "t0": time.perf_counter()}


def _robustness_stop(robust: dict) -> None:
    """Stop whatever of phase 20's services still runs (a failed phase)."""
    import shutil

    for proc, log in robust["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()
    shutil.rmtree(robust["dir"], ignore_errors=True)


def _launches_line(text: str, name: str) -> dict:
    """The JSON of a robustness module's "<name> kernel launches" line."""
    found = [ln for ln in text.splitlines()
             if ln.startswith(f"{name} kernel launches ")]
    check(found, f"robustness: {name} printed no kernel launches line")
    return json.loads(found[-1].partition(" kernel launches ")[2])


def _robustness_phase(robust: dict) -> dict:
    """Phase 20: the four fuzz campaigns in this process through each
    module's main() (the launch counts set to 0 just before them, read
    just after), then phase 20's services (_robustness_start) waited for:
    each exits 0 having printed its checks, and the children's launches
    (each counts its own from its listen line) join the path's. Returns the
    path's launches; every kernel must have launched in it."""
    import torch

    from m3_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from m3_tpu_torch.scripts import (fuzz_cluster, fuzz_codec,
                                      fuzz_durability, fuzz_index)

    seed = ["--seed", str(ROBUST_SEED)]
    campaigns = (
        ("fuzz_codec", fuzz_codec, ["--rounds", str(ROBUST_CODEC_ROUNDS)]),
        ("fuzz_index", fuzz_index, ["--rounds", str(ROBUST_INDEX_ROUNDS)]),
        ("fuzz_durability", fuzz_durability,
         ["--rounds", str(ROBUST_DURABILITY_ROUNDS)]),
        ("fuzz_cluster", fuzz_cluster,
         ["--rounds", "1", "--ops", str(ROBUST_CLUSTER_OPS)]))
    t0 = time.perf_counter()
    reset_kernel_launches()
    torch.cuda.synchronize()
    own = {}
    for name, module, argv in campaigns:
        before = kernel_launches()
        c0 = time.perf_counter()
        rc = module.main(argv + seed)
        torch.cuda.synchronize()
        got = {k: n - before[k] for k, n in kernel_launches().items()}
        check(rc == 0, f"robustness: {name} exited {rc}")
        _card(f"robustness {name}: {' '.join(argv + seed)}, 0 invariant "
              f"failures, launches {got}, {time.perf_counter() - c0!r} s")
        for k, n in got.items():
            own[k] = own.get(k, 0) + n
    campaigns_s = time.perf_counter() - t0
    check(own == kernel_launches(),
          f"robustness: the campaigns' launches {own} differ from the "
          f"counters {kernel_launches()}")
    children = {}
    for name, (proc, log) in robust["procs"].items():
        left = ROBUST_WAIT_S - (time.perf_counter() - robust["t0"])
        try:
            rc = proc.wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
            rc = "killed at its deadline"
        log.seek(0)
        text = log.read()
        for line in text.splitlines():
            if line.startswith(("soak:", "agg soak:", "integration step",
                                "SOAK PASS", "AGG SOAK PASS", "SMOKE PASS")):
                _card(f"robustness {name}: {line}")
        check(rc == 0, f"robustness: {name} exited {rc}: {text[-3000:]}")
        for k, n in _launches_line(text, name).items():
            children[k] = children.get(k, 0) + n
    launches = {k: own.get(k, 0) + children.get(k, 0) for k in own}
    secs = time.perf_counter() - t0
    _card(f"robustness: phase 20 in {secs!r} s (the campaigns "
          f"{campaigns_s!r} s; the services started "
          f"{t0 - robust['t0']!r} s before it), launches {launches} (the "
          f"campaigns' {own}, the services' children's {children})")
    check(all(launches[k] > 0 for k in ("pack", "decode", "hash", "window")),
          f"phase 20 did not launch every kernel of its path: {launches}")
    phase(f"robustness: four campaigns, two soaks and the integration smoke "
          f"held on the card in {secs:.1f}s")
    return launches


if __name__ == "__main__":
    sys.exit(main())
