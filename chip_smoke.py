#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, and then no
result line is printed):

1. build  — compile every hand-written kernel of ``paddlebox_tpu_torch``
   (one ``nvcc`` per source, started together) and print the build time;
2. kernels — each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, for uniform, Zipf-1.2 and
   ``padded`` row ids (the packer's: lengths 1..3 of capacity 3, every
   padding occurrence on row 0 — a third of all positions, one sorted
   run).  The sorted gather and scatter at W = 12, p = 26·3·16384 =
   1,277,952 sorted occurrences over the 1,835,008-row working-set
   bucket of a ~1.6 M-key pass: the gather bit-exact, the scatter within
   rtol 1e-5 plus 1e-5 of each row's sum of |terms| (the plain
   ``index_add_`` adds with atomics in another order).  ``gather_pool``
   at the fast pull's shapes (table [1,835,008, 11], idx [425,984, 3],
   lengths 1..3), on a contiguous table and on the [N, 12] buffer's
   [N, 11] view that the fast path passes: bit-equal to the plain version
   (both sum at most 3 terms in order l = 0, 1, 2).  Two back-to-back
   calls of every kernel must be bit-identical.  The sorted gather and
   scatter run again at W = 20 (3 + 8 + 8 + 1 pull, 8 + 8 + 4 push: an
   expand table with mf_ex width 8), where the scatter stages its 12
   payload columns per round twice, the second round partial (8), under
   the same checks.  Times are device times:
   CUDA events around back-to-back calls that are enqueued behind a
   device-side sleep, so host work between calls leaves no gaps;
3. slice  — train one DeepFM pass (26 slots × capacity 3, mf_dim 8,
   13 dense, MLP 400-400-400, batch 16384, 4 batches, keys from a 2 M
   key space) through ``BoxPSEngine`` → ``SparseTrainer.train_pass`` →
   ``end_pass`` on the streaming mxu lowering; assert finite losses, a
   reported AUC, that every kernel of the path launched at least once
   per batch, and that the first step's loss matches the same step on
   the CPU (``device="cpu"``, same weights and data) within rtol 1e-4;
4. packed — the same model, one pass of 4 × 16384 records through
   ``build_pass_feed`` → ``train_pass(feed)`` → ``end_pass`` on each of
   the ``mxu`` (trimmed plans with static planes), ``fast`` and
   ``ragged`` lowerings, each with every launch counter set to 0 just
   before and read just after: finite losses, a reported AUC, every
   kernel of the lowering launched at least once per batch, the first
   step's loss within rtol 1e-4 of the same step on the CPU, and the
   three lowerings' first-step losses within rtol 1e-4 of each other.
   The fast and ragged passes run a second time from the same state and
   must leave a bit-identical working set (no float atomics).

5. reference — the streaming ``reference`` lowering (gather pull,
   ``fused_seqpool_cvm``, merged push through ``segment_sum``) on the
   slice's data and weights, 4 batches: exactly one ``scatter_add_sorted``
   launch per step and no other kernel; first-step loss = the CPU's
   (rtol 1e-4) and = the streaming mxu slice's (rtol 1e-5); a rerun gives
   bit-identical losses and working set;
6. amp — ``amp=True`` (bf16 model over f32 masters) on the packed ragged
   lowering (the JAX bench's configuration) and on packed mxu, on the
   packed phase's data and weights: steady step ms and
   ``build_pass_feed`` seconds, first-step loss within rtol 1e-2 of the
   same lowering's f32 run, and a bit-identical rerun;
7. rules — ``shared_adam``, ``adam``, ``std_adagrad`` and ``naive`` on
   packed mxu and ``shared_adam`` on ragged, 2 batches of 2048 each on
   the card, each step replayed on the CPU from the card's state before
   it with the card's pooled grads: the step's loss within rtol 1e-4,
   the working set after it within rtol 1e-4 / atol 1e-6, integer fields
   equal (``rules_phase`` says why);
8. models — ``CtrDnn`` (512-256-128) and ``WideDeep`` (256-128-64) on the
   reference lowering, and ``MMoE`` (4 experts, 2 tasks) through
   ``MultiTaskSparseTrainer`` with two label slots, 2 batches each at
   full batch: first-step loss = the CPU's within rtol 1e-4;
9. crossing — packed mxu with FLAGS_mxu_crossing pinned to take, then to
   sort, on the packed phase's data: losses and working set bit-equal;
   prints ``best_mode``'s measured choice and both timings for the pull
   and push crossings at this geometry;
10. lifecycle — the multi-pass day loop: 4 passes × 1 batch of 16384,
   day 1's 3 and day 2's first (fresh keys per pass from the 2 M key
   space, ~0.7 M a pass, so consecutive passes share about a third of
   their keys), a date change between the days, on
   the default lowering (auto → mxu) and on ragged; each first through
   the serial engine lifecycle, then through ``PassPrefetcher`` with
   in-memory loads, from the same data, weights and table seed.  Per-pass
   losses, the final host table (every key, every field), the dense
   weights and Adam's state must be bit-identical between the two, and
   the prefetched run must have re-pulled stale rows.  Then the device
   row cache (``LIFE_CACHE_RUNS``): mxu serial and prefetched with
   2,097,152 rows (the whole key space), mxu prefetched with the flag's
   default 262,144 rows (evicts every pass; key-space heat on), ragged
   prefetched with 2,097,152, over the same 4 passes — each must leave
   the bits of its lowering's cache-off serial run, hit on every warm
   pass, and (262,144) evict.  Every run's pass mapper must have resolved its keys through
   the native hash.  Before the runs, ``host_tier_ab`` times the host
   tier's choices at the day loop's sizes, each against its
   alternative, and checks that both give the same answer: the host
   table's pass pull and write-back on its sorted view and on the native
   hash, ``PassKeyMapper`` on the native hash and on the binary search
   (the packer's calls and one refresh call), and ``build_working_set``'s
   fresh pinned buffers against a reused pinned pool (two working sets
   built back to back must both stay intact).  Prints the day walls, the
   pass walls, the prefetch wait and build seconds, the last pass's
   ``feed.*_hidden_s``, the stale-row refresh, the engine timers, the
   mapper's native and binary-search rows and, per cache run, the
   per-pass hit rate, table rows, refreshed rows, fallback rows and
   evictions, the cache's gather and fold seconds, its row and store
   bytes, the median pass wall beside the cache-off run's over the
   same passes, and the heat summary;
11. recovery — ``fleet.train_passes`` over 3 slot text files of 4 × 16384
   records (one reader thread) with a ``TrainCheckpoint``: the feed's
   parser must be the native one and read a pass file into the Python
   parser's blocks bit for bit (both timed); a fault-free run, then
   seeded kills (``FaultPlan(seed=13).kill_at(point, at=(1,))``) at
   ``end_pass`` (serial and prefetched) and at ``ckpt_commit`` (serial),
   and with the device cache on at the third pass's ``end_pass``
   (prefetched; that pass served hits), each resumed
   (``resume=2``) to the fault-free run's bits with at least one
   auto-resume.  Prints the checkpoint save seconds by kind, the restore
   seconds, the generations kept and their size, and a base save and
   restore of the whole table after the day;
12. rank — ``RankAttentionCTR`` (att_out 32, max_rank 3, MLP 128-64) on
   the page-view feed: the bench widths (26 slots × capacity 3, mf_dim 8,
   13 dense, batch 16384, keys from the 2 M key space), one pass of 4
   pv-aligned batches (page views of 1-4 records with distinct search
   ids, cmatch from {222, 223, 224}, rank 0-3; batches 2-4 a few records
   short, so padded), slot s0's first feasign one of 4,096 user ids and
   named as uid_slot, ``rank_offset`` and ``ads_offset`` on, after
   ``preprocess_instance()``; through the streaming and the packed
   entry point on auto → mxu from the same weights.  Each pass must
   launch ``gather_sorted`` and ``scatter_add_sorted`` exactly once a
   batch (and ``gather_pool`` never), report wuauc over at least one
   user, and its first step must equal the same step on the CPU (rtol
   1e-4); the two passes' losses agree within rtol 1e-4 and their user
   counts equal the data's count of users with both classes; the packed
   feed's rank_offset and ads_offset planes on the card equal the host
   planes bit for bit; a packed rerun from the
   same state (traced, rank_attention's forward annotated) leaves the
   same losses, working set and dense weights bit for bit; and
   ``Fleet.metrics`` fed the packed pass's preds through
   ``MetricGroup.update`` gives an ``auc`` metric equal to the trainer's
   within 1e-6, a ``cmatch_rank_group="222:1,223:2"`` metric over exactly
   those records and a ``wuauc`` metric equal to the trainer's within
   1e-9.  Prints the steady step, the WuAUC host seconds a pass (the
   preds' copy to the host each batch), ``build_pass_feed`` and
   ``plane_build`` seconds, and rank_attention's device ms a step in the
   traced pass and alone (forward + backward at the step's shapes), with
   the GEMMs' ms.
13. options — the rest of the one-card trainer at the bench widths (26
   slots × capacity 3, mf_dim 8, 13 dense, batch 16384, 4 batches, keys
   from the 2 M key space): (a) an expand table (``expand_dim`` 8) under
   ``CtrDnn(emb_width=19)`` (MLP 400-400-400), streaming and packed on
   auto → mxu: ``gather_sorted`` and ``scatter_add_sorted`` exactly once
   a batch, each at W = 20, ``gather_pool`` never; the first step = the
   CPU's (rtol 1e-4); mf_ex trained; a packed rerun (traced) keeps the
   bits; (b) DeepFM on packed mxu with
   ``TrainerConfig(dense_sync_mode="async_table", sync_weight_step=1)``
   beside the same pass with synchronous Adam: finite losses, pushed =
   applied, the module's final params = the table's ``pull()``,
   ``dense_opt`` never stepped, every grads' copy on the main thread and
   the table's updates on its own thread (numpy only); (c) a packed pass
   with ``dump_path`` in a temporary directory over records with
   ``ins_id``s, the last batch short: one line per real record, ids and
   labels in order, preds = the pass's to 6 decimals; (d) the five
   ``fused_seqpool_cvm`` variants forward + backward at [26, 16384, 3, E]
   against the CPU (rtol 1e-5, atol 1e-6) with device ms each; (e)
   ``alias_sample`` of 10^6 draws from a card generator, chi-square
   against the table at p > 1e-3.  Prints the steady steps, the two
   kernels' traced device ms a step, the grads' copy ms, the dump's host
   seconds, the variants' ms and the sampler's.

14. cluster — the PS service tier: DeepFM on auto → mxu at the bench
   widths, over phase 10's 2 M key space, 2 days × 2 passes of 4 × 16384
   records written as slot text files, through ``fleet.train_passes``
   with ``RemoteTableAdapter(PSClient(flt.addrs), delta_mode=True)`` as
   the engine's table over an in-process ``launch.PSFleet`` on loopback:
   (a) N = 1 serial, (b) N = 4 serial, (c) N = 4 prefetched, (d) N = 4
   with the device cache (2,097,152 rows), (e) N = 4 under seeded chaos
   (one shard killed mid push_sparse_delta, one server ack dropped).
   Runs (a)-(e) must leave the same bits (per-batch losses, dense weights
   and Adam state, the union of the shards' tables with no key on two
   shards); (e) must restart a shard and (d) must hit; ``gather_sorted``
   and ``scatter_add_sorted`` launch exactly once a batch in every run;
   (a)'s first step = the CPU's (rtol 1e-4).  Prints per run the median
   pass wall, the ``pull_sparse`` and ``push_sparse_delta`` chunk
   latency medians, wire bytes a pass, ``end_day`` seconds, (d)'s hit
   rate and (e)'s restart seconds; the loopback MB/s and one pull through
   ``ps_streams`` 1 against 4 (4 MiB frames, the same rows); and phase
   10's local-table serial mxu pass wall of the same call.
15. serving — the serving tier over phase 14's pass files, DeepFM at the
   bench widths: (a) a local engine trains 2 days × 2 passes on auto →
   mxu through ``fleet.train_passes`` with a ``TrainCheckpoint`` saving
   every pass, and each day ends with ``save_xbox`` (the native writer;
   the accessor's default base threshold filters the rows); day 1's dump
   is published (``publish_xbox_manifest``) and loaded by a
   ``BoxPSEngine(mode="serving")``, whose table must hold the trained
   rows as the dump's ``%.6g`` text carries them (uncreated mf as zeros,
   mf_size from any(mf != 0)); (b) that engine runs the pass lifecycle
   over the first pass file's keys and ``freeze_for_serving()`` on the
   card: mf becomes int16; ``pull_sparse`` of 65,536 keys keeps columns
   0-2 bit for bit and mf within scale/2; the mxu and fast
   ``pull_pool_cvm`` of the pass's first packed batch, each with the
   launch counters set to 0 just before and read just after, must launch
   ``gather_sorted`` / ``gather_pool`` and stay within 3·scale/2 of the
   f32 pull, their gathers bit-equal to the CPU's over the same frozen
   tensors and their pools within rtol 1e-6; ``end_pass`` and the
   trainer must refuse the frozen set; (c) a ``ServingReplica`` serves
   day 1 to tenants ads and feed through ``ServingRouter``s: queries of
   1,024 samples × 26 slots × 1-3 keys, 10 % of them unseen, answered
   as ``FrozenHostTable.lookup_rows`` / ``_pool_rows`` bit for bit, under
   8 client threads × 50 queries; (d) under the same load
   ``watch_manifest`` hot-swaps to day 2 when it is published: no
   failed query, every answer whole from one day, day 2's rows after;
   (e) 4 shards × 1 replica with 4,096 replicated hot keys answer like
   the single replica bit for bit, then 4 shards × 2 replicas with one
   killed under load: no failed query, every answer the single
   replica's; (f) a replica over the checkpoint chain runs
   ``watch_ckpt``, the trainer runs one more pass with ``save_pass``, the
   replica patches it within its poll interval and serves the trained
   rows exactly (the checkpoint carries f32).  Prints one
   ``serving[<step>]:`` line per step: dump and load rows, MB and
   seconds, the frozen set's bytes, QPS and the tenants' latency p50 and
   p99, the swap's seconds, the fleet's build seconds, the patch's
   staleness and rows.

16. trainer_fleet — the trainer fleet: DeepFM at the bench widths (26
   slots × capacity 3, mf_dim 8, 13 dense, MLP 400-400-400, batch 16384)
   through ``fleet.run_trainer_fleet`` (supervised ranks as threads of
   this process, every rank on the card) over a loopback ``PSFleet`` of
   4 shards, V = 8 virtual slices, 2 days × 1 pass of 65,536 records
   (one phase-11 pass file a pass, keys from the 2 M key space; ~8,192
   records and one batch a slice):
   (a) N = 1 serial, (b) N = 4 serial, (c) N = 4 prefetched, (d) N = 4
   with rank 1's first incarnation killed at ``fleet_allreduce`` of pass
   2 and restarted by its ``TrainerSupervisor``.  Runs (a)-(d) must leave
   the same bits (per-pass loss, AUC and batches, every rank's dense
   weights and Adam state, the union of the shards' tables with no key
   on two shards); every shard's ``end_day`` runs once a day;
   ``gather_sorted`` and ``scatter_add_sorted`` launch once per trained
   batch, (b) exactly as often as (a), and (d) more by exactly the
   batches of rank 1's slices in the replayed pass (counted from the
   data); pass 1 of (a) again with ``device="cpu"`` gives the card's
   mean loss and AUC within rtol 1e-3 (``FLEET_CPU_RTOL`` says why); (e)
   ``python -m paddlebox_tpu_torch.trainer.fleet_main`` over its own spec
   (26 slots of capacity 2, mf_dim 8, 13 dense, the module's DeepFM
   (16, 8)) as one and as two processes on the card: their histories
   bitwise equal.  Prints one ``trainer_fleet[<run>]:`` line per run:
   the pass walls, ``trainer.fleet.shuffle_s``, the straggler gap, the
   shadow replays, the restarts, the PS wire and shuffle bytes a pass,
   and the phase's seconds.

17. sharded — the multi-shard mxu lowering (``mxu_sharded``), one
   controller driving every shard on the card: DeepFM at the bench widths
   on the packed phase's data and weights (one packed pass of 4 × 16384
   records, ~1.6 M keys of the 2 M key space) over three topologies:
   (a) ``MeshConfig(dp=4)``, a flat pool of 4 table shards; (b)
   ``MeshConfig(dp=2, sharding=2)``, the multi-node layout (the table
   split within a node, replicated across the two); (c) as (a) under
   FLAGS_sharded_exchange_bf16.  Each: ``auto`` resolves to mxu_sharded;
   finite losses and an AUC; ``gather_sorted`` and ``scatter_add_sorted``
   exactly once a shard a step (4 in each run: (b)'s 2 table shards in
   each of 2 nodes), ``gather_pool`` never; the first step within rtol
   1e-4 of the packed one-device mxu pass and of the same topology on
   the CPU ((c): 1e-2, the exchanged values rounded to bf16); a second
   pass from the same state leaves the same bits.  Both sorted kernels
   on shard 1 of (a)'s first batch (the sentinel run ~5/6 of the
   gathered domain) against their plain versions, as in phase 2, twice
   bit-identical, with device ms beside phase 2's.  Prints
   ``sharded[<run>]:`` lines (steady step ms, plan and feed bytes,
   ``build_pass_feed`` seconds) and ``sharded[kernels, ...]:`` lines;
   the kernels' times at the sharded shapes ride the ``kernels`` line
   as ``at_sharded``.
18. graph — the graph-learning mode at the system's widths: a
   2,097,152-node graph (the feasigns 1..N of phases 10-11's 2 M key
   space) of 16,777,216 directed edges whose endpoints both follow one
   Zipf-1.2 popularity (out- and in-degrees power-law, mean 8), weights
   U(0.1, 1), built into the CSR on the host and moved to the card; node
   embeddings of mf_dim 8 as PS rows, opened by one pass lifecycle
   (``begin_feed_pass`` / ``add_keys`` / ``end_feed_pass`` /
   ``begin_pass``); 65,536 weighted walks of length 8 from nodes with an
   out-edge, window 2 → skip-gram pairs; one epoch of batches of 16,384
   pairs with K = 5 negatives through ``GraphEmbeddingTrainer.
   train_pairs``, pull by ``gather_sorted`` and push by
   ``scatter_add_sorted`` on one plan a step over its 114,688 rows, then
   ``end_pass``.  Checks: the first step against the same step on the
   CPU (same negatives): the loss within rtol 1e-5, the merged gradient
   within rtol 1e-5 plus 1e-5 of each row's sum of |terms|, mf and
   mf_g2sum updated from it within rtol 1e-5 (``graph_step_vs_cpu`` says
   why the update is replayed); each sorted kernel exactly once a step,
   ``gather_pool`` never; a rerun from the same seed (traced through the
   port's ``utils/profiler.Profiler``) leaves the same losses, mf and
   mf_g2sum bit for bit; ``end_pass`` writes the trained rows to the
   host table; the JAX package's two-community graph separates on the
   card (intra > inter + 0.2).  Both sorted kernels on the first step's
   plan against their plain versions as in phase 2, with ``index_select`` /
   ``index_add_`` and the byte bound; they ride the ``kernels`` line as
   ``at_graph``.  Prints the graph build and CSR seconds, the walk ms,
   the pairs, the median step (CUDA events) and pairs/s, the traced
   device-busy share, and ``graph[kernels, ...]:`` with the plan's
   longest run and hub share.
19. parallel — the parallel layer library, every shard on the card
   (``single_host_topology``), TF32 off, each run held against its dense
   or sequential counterpart on the card within rtol 1e-4 (atol 2e-5):
   the bench MLP's first two layers as a column-parallel 299 → 400 and a
   row-parallel 400 → 400 (batch 16,384, mp 4); a vocab-parallel
   embedding of 1,048,576 × 64 (bit-equal to the dense lookup);
   parallel cross-entropy over 32,768 classes; MoE (d_model 400, hidden
   1,600, 8 experts, ep 4, 16,384 tokens, capacity factor 2.5 so that
   no token is dropped in either layout, which is checked) with both
   gates; ring and Ulysses attention (B 2, T 4,096, H 8, Dh 64, sp 4),
   causal and not; GPipe forward and backward, 1F1B (stash within its
   2·pp slots) and hetero 1F1B over the bench MLP chain 299 → 400 →
   400 → 400 → 1 (pp 4, 8 microbatches of 2,048; stages Linear(400,
   400) + tanh); a ``FleetExecutor`` DAG whose compute nodes run those
   stages against the serial run.  Prints ``parallel[<run>]:`` lines
   with the max error and the ms of each side (CUDA events around a
   call, the median of 3).
20. multicard — ``mxu_sharded`` with its shards on distinct devices, on
   the packed phase's data and weights at the bench widths: (a) dp 2
   over the card and the host; (b) dp 2 × sharding 2, one node on the
   card and one on the host; with two or more cards, (c) both meshes
   over ``cuda:0`` and ``cuda:1``.  The card beside the host is a test
   topology for a one-card machine: the host shards run the kernels'
   plain versions because their tensors live in host memory.  Each run:
   every working-set block, feed plane and plan on its shard's device;
   the working set's and the feed's bytes on the card beside the same
   mesh on one card (and the allocator's growth); ``gather_sorted`` and
   ``scatter_add_sorted`` exactly once a card shard a step,
   ``gather_pool`` never; the losses within rtol 1e-4 and the working set
   within rtol 1e-5 / atol 1e-6 of the same mesh on one card; the dense
   replicas bit-equal after the pass and the nodes' replicas of each
   table block bit-equal after every step; a rerun (traced) leaves the
   same bits; then both sorted kernels on the last card shard's block
   and resident plan against their plain versions, timed (on the
   ``kernels`` line as ``at_multicard`` for (a), ``at_multicard_b`` for
   (b)).  Prints ``multicard[<run>]:`` lines with the device list, the
   step device ms, the device-busy share and the card's name and power
   limit; a run with a host shard is host-bound and says so.

21. multicard_paths — explicit ``fast``, ``mxu`` and ``reference`` and
   ``auto`` on a mesh ``mxu_sharded`` cannot take, with the shards on
   distinct devices, on the packed phase's data and weights at the bench
   widths (its first 2 batches): (d) fast on dp 2 over the card and the
   host; (e) auto on dp 2
   × mp 2 (adagrad → fast), one dp row a device; (f) reference (under
   adagrad, the step ``fast_path=False`` gives) on dp 2; (g) mxu on dp 2; with two or more cards, (d2) and (g2)
   over ``cuda:0`` and ``cuda:1``.  Each run: every block, plane and plan
   on its shard's device; each kernel exactly its predicted launches a
   step for each row block of the working set on a card (fast:
   ``gather_pool`` and the merge's ``scatter_add_sorted``; mxu: both
   sorted kernels; reference: the merge's scatter), none for the host's
   blocks; the losses within rtol 1e-4 and the working set within rtol
   1e-5 / atol 1e-6 of the same mesh on one card; a rerun bit-identical;
   then each kernel of the lowering on the first card row block's
   whole-batch shape against its plain version, timed (on the
   ``kernels`` line as ``at_multicard_paths_<run>``).  (h) a day of 3
   passes × 1 batch on dp 2 over the card and the host (auto →
   ``mxu_sharded``) with the device row cache off, on serially and on
   prefetched: all three bit-equal, the warm passes hit, the hits and
   fold-backs of the host's block cross as copies.  Prints
   ``multicard_paths[<run>]:`` lines; a run with a host shard is
   host-bound and says so.
22. multicard_models — what phases 20-21 left out, with the shards on
   distinct devices at the bench widths, dp 2 over the card and the
   host: (i) ``RankAttentionCTR`` (att_out 32, max_rank 3, MLP 128-64)
   on a page-view pass made as phase 12's (2 pv-aligned batches,
   ``rank_offset`` and ``ads_offset`` on), packed, on ``auto`` (→
   ``mxu_sharded``) and explicit ``fast``; (j) ``MMoE`` (4 experts, 2
   tasks) through ``MultiTaskSparseTrainer`` on 2 batches; (k)
   ``GraphEmbeddingTrainer`` over phase 18's 2,097,152-node graph, 4
   steps of 16,384 pairs (K 5), the working set on dp 2; with two or
   more cards (i2) and (k2) over
   ``cuda:0`` and ``cuda:1``.  Each: every block, plane and plan on its
   shard's device; each kernel exactly its predicted launches a step for
   each card shard (mxu_sharded) or card row block, none for the host's;
   the losses within rtol 1e-4, the working set (the graph: mf and
   mf_g2sum) within rtol 1e-5 / atol 1e-6 and (j)'s task AUCs within
   1e-6 of the same mesh on one card; a rerun bit-identical; (k)'s card
   row block times both sorted kernels on its plan of the first step
   (on the ``kernels`` line as ``at_multicard_graph``).  (l) phase 4's
   pass packed through ``pack_pass(on_plane=PlaneStager(topology, ...))``
   on dp 2: every plane of the staged feed bit-equal to the unstaged
   upload on its shard's device, no staged plane whole on one device.
   Prints ``multicard_models[<run>]:`` lines; a run with a host block is
   host-bound and says so.
23. multiprocess — the dp axis across processes: phase 4's pass at the
   bench widths on dp 2 × sharding 2, one dp coordinate a process.  The
   dense weights and the data seed go to a temporary directory, and two
   ranks start through the port's launcher (``python -m
   paddlebox_tpu_torch.launch --nproc_per_node 2 chip_smoke.py
   --multiprocess-rank <dir>``), each ``launch.init_distributed()`` →
   ``HybridTopology(..., process_group=launch.process_group())`` with
   its 2 shards on ``cuda:0`` → the engine lifecycle → 2 batches through
   ``build_pass_feed`` and 2 streaming (half of each batch's columns a
   rank) → ``end_pass``; the group is gloo over loopback, the exchanged
   tensors staged through host memory.  Checks: the ranks' losses, AUC,
   working set, host table and dense params bit-equal; each rank's
   ``gather_sorted`` and ``scatter_add_sorted`` exactly once a local
   shard a step (2) and ``gather_pool`` never; the losses within rtol
   1e-4 and the working set within rtol 1e-5 / atol 1e-6 of the same mesh
   in this process on the card (one replica over the global batch, so
   the dense fold differs); the first step within rtol 1e-4 of the CPU;
   each rank's two kernels on its first shard's plan of the first step
   against their plain versions (rank 0's times on the ``kernels`` line
   as ``at_multiprocess``).  A rank that exits non-zero, or a run past
   ``MP_TIMEOUT_S``, fails the phase.  Prints ``multiprocess[...]:``
   lines: each rank's steady step, the bytes it sends over the group a
   step (the delta, the slot column, the dense grads), its seconds a
   step in the cross-process tier, and the phase's wall: host- and
   loopback-bound with two ranks on one card, no multi-node speed.
24. multiprocess_split — the table split across processes: phase 4's
   first two batches at the bench widths (the first through
   ``build_pass_feed``, the second streaming, then ``end_pass``), two
   ranks of ``chip_smoke.py --multiprocess-split-rank <dir>`` through
   the launcher on ``cuda:0``, each holding its own row blocks
   (``SPLIT_RUNS``: (m) dp 2, auto → ``mxu_sharded`` on the flat layout;
   (n) dp 2, explicit mxu; (o) dp 2 × mp 2 under adagrad, auto → fast;
   (p) dp 2, explicit reference; (r) dp 2 × sharding 2, explicit fast on
   the multi-node layout, where each rank holds a whole replica and
   reads and steps its own row blocks).  Checks, a run: the ranks' losses,
   AUC, working set (joined over the group), host table after
   ``end_pass`` and dense params bit-equal; each rank's launches a step
   as ``SPLIT_RUNS`` predicts for its row blocks; the losses within rtol
   1e-4 and the working set within rtol 1e-5 / atol 1e-6 of the same
   mesh in this process on the card; (m)'s first step within rtol 1e-4
   of the CPU; (m)'s sorted kernels on each rank's shard plan and (o)'s
   ``gather_pool`` on each rank's first row block over the whole batch
   against their plain versions (rank 0's times on the ``kernels`` line
   as ``at_multiprocess_split``).  Prints ``multiprocess_split[...]``
   lines: each rank's steps, the bytes it puts on the group a step by
   kind, its seconds a step in the cross-process tier, the working-set
   join and ``end_pass`` seconds, and the phase's wall: host- and
   loopback-bound with two ranks on one card, no multi-node speed.

Depth cuts (the widths are the bench model's): phase 10, 4 passes of 4
batches (day 1's 3 and day 2's first); phase 11, a day of 3 passes of 4
batches; phases 14 and 15, 2 days of 2 passes of 4 batches (phase 15
one more pass for (f)); phase 16, 2 days of 1 pass of 4 batches'
records (65,536, one half-full batch a virtual slice; 131,072 took the
phase 265 s); phase 21 (h), one day of 3 passes of 1 batch (2 until
the whole script passed 80 % of its limit); phase 22 (i), 2 of phase
12's 4 batches, and (k), 4 steps of phase 18's epoch (4 and 8 before).

Every phase sets the launch counters to 0 just before its main run and
reads them just after; a kernel of the path that did not launch fails
the run (and a kernel that the reference lowering does not run must not
launch).  The reruns of phases 5, 6 and 12 are traced by torch.profiler, and
last, short traced passes (2 batches; streaming mxu and each packed
lowering) do the same for phases 3-4: device time by kernel, each
hand-written kernel's device time per step, the cuBLAS GEMMs' device
time per step, and the device-busy share of the steps' event windows.

Output: progress lines, a ``detail:`` JSON line, then a
``{"kernels": [...]}`` JSON line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ops import cuda_lib
from paddlebox_tpu_torch.ops import pallas_gather as pg
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps.embedding import size_bucket
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer

N_SLOTS, CAP, MF_DIM, DENSE_DIM = 26, 3, 8, 13
HIDDEN = (400, 400, 400)
BATCH, N_BATCHES, KEY_SPACE = 16384, 4, 2_000_000
P = N_SLOTS * CAP * BATCH                  # 1,277,952 occurrences / step
W_PULL, W_PUSH = 3 + MF_DIM + 1, MF_DIM + 4
EX_DIM = 8                                 # phase 13's expand (mf_ex) width
W_EX = 3 + MF_DIM + EX_DIM + 1             # 20: pull and push with mf_ex
TABLE_ROWS = size_bucket(1_600_001)        # a ~1.6 M-key pass's bucket

R_POOL = N_SLOTS * BATCH                   # 425,984 pooled rows / step
W_POOL = 3 + MF_DIM                        # 11 pooled columns

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                     # H100 SXM, outside tensor cores
KERNELS = {"gather_sorted": sp.gather_sorted,
           "scatter_add_sorted": sp.scatter_add_sorted,
           "gather_pool": pg.gather_pool}
SOURCES = {"gather_sorted": "paddlebox_tpu_torch/csrc/sorted_spmm.cu",
           "scatter_add_sorted": "paddlebox_tpu_torch/csrc/sorted_spmm.cu",
           "gather_pool": "paddlebox_tpu_torch/csrc/gather_pool.cu"}
REPLACES = {"gather_sorted": "paddlebox_tpu/ops/sorted_spmm.py:238",
            "scatter_add_sorted": "paddlebox_tpu/ops/sorted_spmm.py:263",
            "gather_pool": "paddlebox_tpu/ops/pallas_gather.py:82"}
# the CUDA kernels each wrapper launches, as the profiler names them
SYMBOLS = {"gather_sorted": ("gather_sorted_kernel",),
           "scatter_add_sorted": ("scatter_tiles_kernel",
                                  "scatter_combine_kernel"),
           "gather_pool": ("gather_pool_kernel",)}
# cuBLAS GEMM kernels as the profiler names them (the MLP's matmuls)
GEMM_MARKS = ("gemm", "nvjet", "splitK")

LABELS = ("label", "label1")               # MMoE's two label slots
RULES_BATCH = 2048
RULES = (("shared_adam", "mxu"), ("adam", "mxu"), ("std_adagrad", "mxu"),
         ("naive", "mxu"), ("shared_adam", "ragged"))


def make_model(name: str):
    """The models of the run at their widths.  Modules that only later
    slices of the port have are imported here, not at the top, so that
    kernel_ab.py can run the kernel phases on an older checkout."""
    emb = 3 + MF_DIM
    if name == "deepfm":
        return DeepFM(N_SLOTS, emb, DENSE_DIM, HIDDEN)
    if name == "ctr_dnn_ex":    # over an expand table: 3 + D + Dex = 19
        from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
        return CtrDnn(N_SLOTS, emb + EX_DIM, DENSE_DIM, HIDDEN)
    if name == "ctr_dnn":
        from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
        return CtrDnn(N_SLOTS, emb, DENSE_DIM, (512, 256, 128))
    if name == "widedeep":
        from paddlebox_tpu_torch.models.widedeep import WideDeep
        return WideDeep(N_SLOTS, emb, DENSE_DIM, (256, 128, 64))
    if name == "mmoe":
        from paddlebox_tpu_torch.models.mmoe import MMoE
        return MMoE(N_SLOTS, emb, DENSE_DIM, num_experts=4, num_tasks=2)
    raise ValueError(f"unknown model {name!r}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(what: str, fn, iters: int = 20, warmup: int = 3,
            hold_cycles: int = 50_000_000) -> float:
    """Mean device time of one call of ``fn``, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls.  The calls are
    enqueued while a device-side sleep holds the stream, so the host's
    work per call (Python, allocation, launch) leaves no idle gaps between
    them on the device.  If the sleep ran out before the last call was
    enqueued, the timing is taken again behind a 4× longer sleep, three
    times in all; then it raises (``fn`` waits on the device, or its host
    work outlasts every sleep)."""
    tries = 3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        held = not a.query()   # the device had not started the calls yet
        torch.cuda.synchronize()
        if held:
            return a.elapsed_time(b) / iters
        hold_cycles *= 4
    raise AssertionError(
        f"time_ms({what}): the device started the calls before the last "
        f"was enqueued, {tries} times; the last sleep held "
        f"{hold_cycles // 4} cycles")


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: the kernels against their plain versions
# ---------------------------------------------------------------------------

def twice(what: str, fn):
    """fn() twice back to back: the two results must be bit-identical
    (every kernel adds in a fixed order).  Returns the first."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    return a


def padded_rows(rng) -> np.ndarray:
    """The streaming packer's row ids for one step: each of the R_POOL
    (slot, record) rows holds 1..CAP ids and parks the CAP - length
    padding occurrences on row 0, about a third of all P positions."""
    lens = rng.integers(1, CAP + 1, R_POOL)
    ids = rng.integers(1, TABLE_ROWS, (R_POOL, CAP))
    return np.where(np.arange(CAP)[None, :] < lens[:, None], ids,
                    0).reshape(-1)


def kernel_phase(dev: torch.device, seed: int = 0, w_pull: int = W_PULL,
                 w_push: int = W_PUSH):
    """The sorted gather and scatter against their plain versions at
    widths ``w_pull`` / ``w_push`` (12 on the bench table; 20 with an
    expand table, whose scatter runs a second, partial column round).
    Returns {dist: {kernel: numbers}}."""
    rng = np.random.default_rng(seed)
    rows_by_dist = {
        "uniform": rng.integers(1, TABLE_ROWS, P),
        # Zipf-1.2 ranks wrapped onto the table: one very hot row
        "zipf1.2": (rng.zipf(1.2, P) - 1) % (TABLE_ROWS - 1) + 1,
        "padded": padded_rows(rng),
    }
    dims = sp.spmm_dims(P, TABLE_ROWS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((w_pull, dims.n_kernel), generator=gen, device=dev)
    table[:, 0] = 0.0
    table[:, TABLE_ROWS:] = 0.0             # the zero sentinel tile
    results = {}
    for dist, rows_np in rows_by_dist.items():
        rows = torch.as_tensor(rows_np.astype(np.int32), device=dev)
        plan = sp.build_plan(rows, dims)
        rows2d, first_occ = plan[0], plan[7]
        payload = torch.randn((w_push, dims.p_pad), generator=gen,
                              device=dev)
        payload[:, dims.p:] = 0.0            # pad columns carry nothing
        n_unique = int(first_occ.sum().item())

        got = twice(f"gather_sorted ({dist})",
                    lambda: sp.gather_sorted(table, rows2d, dims))
        want = sp.gather_sorted_plain(table, rows2d, dims)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_sorted != plain ({dist})")
        g_err = float((got - want).abs().max())

        got = twice(f"scatter_add_sorted ({dist})",
                    lambda: sp.scatter_add_sorted(payload, rows2d,
                                                  first_occ, dims))
        want = sp.scatter_add_sorted_plain(payload, rows2d, first_occ, dims)
        abs_sum = sp.scatter_add_sorted_plain(payload.abs(), rows2d,
                                              first_occ, dims)
        torch.cuda.synchronize()
        err = (got - want).abs()
        limit = 1e-5 * want.abs() + 1e-5 * abs_sum + 1e-6
        if not bool((err <= limit).all()):
            raise AssertionError(
                f"scatter_add_sorted != plain ({dist}): max err "
                f"{float(err.max())}")
        s_err = float(err.max())

        rows_l = rows2d.reshape(-1).long()
        g = {"ms": time_ms(f"gather_sorted ({dist})",
                           lambda: sp.gather_sorted(table, rows2d, dims)),
             "plain_ms": time_ms(
                 f"gather_sorted_plain ({dist})",
                 lambda: sp.gather_sorted_plain(table, rows2d, dims)),
             "library_ms": time_ms(
                 f"index_select ({dist})",
                 lambda: torch.index_select(table, 1, rows_l)),
             "max_abs_err": g_err}
        # bytes the gather must move: its row ids, the table columns this
        # plan touches, the output
        g["bound_ms"], g["bound_by"] = bound_ms(
            4 * dims.p_pad + 4 * w_pull * n_unique + 4 * w_pull * dims.p_pad,
            0)
        s = {"ms": time_ms(f"scatter_add_sorted ({dist})",
                           lambda: sp.scatter_add_sorted(
                               payload, rows2d, first_occ, dims)),
             "plain_ms": time_ms(f"scatter_add_sorted_plain ({dist})",
                                 lambda: sp.scatter_add_sorted_plain(
                                     payload, rows2d, first_occ, dims)),
             "library_ms": time_ms(f"index_add_ ({dist})", lambda: torch.zeros(
                 (w_push, dims.n_kernel), device=dev).index_add_(
                     1, rows_l, payload)),
             "max_abs_err": s_err}
        # payload + row ids in (the run starts follow from the sorted
        # ids), the whole merged delta out; one add per payload value
        s["bound_ms"], s["bound_by"] = bound_ms(
            4 * w_push * dims.p_pad + 4 * dims.p_pad
            + 4 * w_push * dims.n_kernel, w_push * dims.p)
        results[dist] = {"gather_sorted": g, "scatter_add_sorted": s,
                         "distinct_rows": n_unique,
                         "longest_run": int(torch.unique_consecutive(
                             rows2d.reshape(-1), return_counts=True)[1]
                             .max())}
        log(f"kernels[{dist}, W={w_pull}/{w_push}]: distinct rows "
            f"{n_unique}, longest run "
            f"{results[dist]['longest_run']}; gather "
            f"{g['ms']:.4f} ms (plain {g['plain_ms']:.4f}, bound "
            f"{g['bound_ms']:.4f}); scatter {s['ms']:.4f} ms (plain "
            f"{s['plain_ms']:.4f}, bound {s['bound_ms']:.4f}); max err "
            f"{g_err} / {s_err}")
    return results


def gather_pool_phase(dev: torch.device, seed: int = 0,
                      layouts=("stride12", "stride11")):
    """gather_pool at the fast pull's shapes: table [TABLE_ROWS, 11],
    idx [425,984, 3] (26 slots × 16384 records), lengths 1..3, on two
    layouts of the same values: ``stride12`` (the [N, 12] buffer's
    [N, 11] view that the fast path passes; float4 rows) and ``stride11``
    (a contiguous table; 4-byte loads).  Beside each kernel time stands
    ``index_select`` of the same live rows with no pooling: the cost of
    fetching them.  Returns {dist: {layout: ...}}."""
    rng = np.random.default_rng(seed)
    lengths_np = rng.integers(1, CAP + 1, R_POOL).astype(np.int32)
    ids_by_dist = {
        "uniform": rng.integers(1, TABLE_ROWS, (R_POOL, CAP)),
        "zipf1.2": (rng.zipf(1.2, (R_POOL, CAP)) - 1) % (TABLE_ROWS - 1) + 1,
    }
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = {"stride12": torch.zeros((TABLE_ROWS, W_POOL + 1),
                                      device=dev)[:, :W_POOL]}
    tables["stride12"].copy_(torch.randn((TABLE_ROWS, W_POOL), generator=gen,
                                         device=dev))
    tables["stride12"][0] = 0.0
    tables["stride11"] = tables["stride12"].contiguous()
    lengths = torch.as_tensor(lengths_np, device=dev)
    live = np.arange(CAP)[None, :] < lengths_np[:, None]
    results = {}
    for dist, ids_np in ids_by_dist.items():
        idx = torch.as_tensor(ids_np.astype(np.int32), device=dev)
        mask = torch.as_tensor(live.astype(np.float32), device=dev)
        idx_l = idx.long()
        live_l = torch.as_tensor(ids_np[live], device=dev)
        n_rows = int(np.unique(ids_np[live]).size)
        results[dist] = {}
        for layout in layouts:
            table, what = tables[layout], f"({dist}, {layout})"
            got = twice(f"gather_pool {what}",
                        lambda: pg.gather_pool(table, idx, lengths))
            want = pg.gather_pool_plain(table, idx, lengths)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"gather_pool != plain {what}: max err "
                                     f"{err}")
            dense = tables["stride11"]
            k = {"ms": time_ms(f"gather_pool {what}",
                               lambda: pg.gather_pool(table, idx, lengths)),
                 "plain_ms": time_ms(
                     f"gather_pool_plain {what}",
                     lambda: pg.gather_pool_plain(table, idx, lengths)),
                 "library_ms": time_ms(
                     f"embedding_bag {what}",
                     lambda: torch.nn.functional.embedding_bag(
                         idx_l, dense, mode="sum",
                         per_sample_weights=mask)),
                 "live_rows_index_select_ms": time_ms(
                     f"index_select of the live rows {what}",
                     lambda: torch.index_select(table, 0, live_l)),
                 "max_abs_err": err, "distinct_rows": n_rows}
            # the same work on either layout: ids and lengths read once,
            # each distinct live row's 11 values once, the output written
            # once; one add per live (row, column)
            k["bound_ms"], k["bound_by"] = bound_ms(
                4 * R_POOL * CAP + 4 * R_POOL + 4 * W_POOL * n_rows
                + 4 * W_POOL * R_POOL, W_POOL * int(lengths_np.sum()))
            results[dist][layout] = k
            log(f"gather_pool[{dist}, {layout}]: distinct rows {n_rows}; "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
                f"embedding_bag {k['library_ms']:.4f}, index_select of the "
                f"live rows {k['live_rows_index_select_ms']:.4f}, bound "
                f"{k['bound_ms']:.4f}); bit-equal to plain")
    return results


# ---------------------------------------------------------------------------
# phase 3: one training pass of the slice
# ---------------------------------------------------------------------------

def feed_config(n_labels: int = 1) -> DataFeedConfig:
    return DataFeedConfig(slots=tuple(
        [SlotConfig(name, dtype="float", is_dense=True, dim=1)
         for name in LABELS[:n_labels]]
        + [SlotConfig("dense0", dtype="float", is_dense=True, dim=DENSE_DIM)]
        + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))


def make_block(rng, n: int, n_labels: int = 1,
               cap: int = CAP) -> SlotRecordBlock:
    """n records: 1..cap feasigns per slot from the key space, 0/1 labels
    (one per label slot) and DENSE_DIM normal dense features."""
    blk = SlotRecordBlock(n=n)
    for i in range(N_SLOTS):
        lens = rng.integers(1, cap + 1, size=n)
        offsets = np.zeros((n + 1,), np.int64)
        np.cumsum(lens, out=offsets[1:])
        blk.uint64_slots[f"s{i}"] = (rng.integers(
            1, KEY_SPACE, size=int(offsets[-1])).astype(np.uint64), offsets)
    blk.float_slots["label"] = (rng.integers(0, 2, size=n).astype(np.float32),
                                np.arange(n + 1, dtype=np.int64))
    blk.float_slots["dense0"] = (
        rng.normal(0, 1, size=n * DENSE_DIM).astype(np.float32),
        np.arange(n + 1, dtype=np.int64) * DENSE_DIM)
    for name in LABELS[1:n_labels]:
        blk.float_slots[name] = (rng.integers(0, 2, size=n).astype(
            np.float32), np.arange(n + 1, dtype=np.int64))
    return blk


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def make_trainer(block: SlotRecordBlock, device: str, params=None,
                 path: str = "mxu", model: str = "deepfm", amp: bool = False,
                 optimizer: str = "adagrad", batch: int = 0,
                 trainer_config=None, mesh: dict = None,
                 devices=None, group=None):
    """Engine lifecycle up to begin_pass over ``block``'s keys, and a
    trainer on ``device`` (from ``params`` when given).  model "mmoe"
    trains through MultiTaskSparseTrainer on two label slots (the
    reference lowering); ``path`` names the lowering of the others.
    ``batch``: the batch size, BATCH when 0.  Model "ctr_dnn_ex" trains
    over a table with an EX_DIM-wide expand embedding;
    ``trainer_config``: the trainer's TrainerConfig.  ``mesh``: the
    degrees of a topology (every shard on ``device``, or on ``devices``,
    one a shard) for the engine and the trainer; ``group``: the process
    group its dp axis spans (``devices`` then names this rank's shards'
    devices).  Returns (engine, trainer, a dataset of ``block``, the
    model's initial params)."""
    n_labels = 2 if model == "mmoe" else 1
    cfg = feed_config(n_labels)
    dataset = SlotDataset(cfg)
    dataset._blocks = [block]
    # a topology only when asked, so an older checkout (kernel_ab) takes
    # the same call
    topo = {}
    if mesh is not None:
        from paddlebox_tpu_torch.config import MeshConfig
        from paddlebox_tpu_torch.parallel.topology import HybridTopology
        across = {} if group is None else {"process_group": group}
        topo["topology"] = (
            HybridTopology(MeshConfig(**mesh), device=device)
            if devices is None
            else HybridTopology(MeshConfig(**mesh), devices=devices,
                                **across))
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        expand_dim=EX_DIM if model == "ctr_dnn_ex" else 0,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0, optimizer=optimizer)),
        seed=0, device=device, **topo)
    engine.begin_feed_pass()
    engine.add_keys(block.all_keys())
    engine.end_feed_pass()
    engine.begin_pass()
    if model == "mmoe":
        from paddlebox_tpu_torch.trainer.multitask import \
            MultiTaskSparseTrainer
        trainer = MultiTaskSparseTrainer(
            engine, make_model(model), cfg, batch_size=batch or BATCH,
            label_slots=list(LABELS), seed=0, device=device, **topo)
    else:
        # amp and trainer_config only when asked, so an older checkout's
        # trainer (kernel_ab) takes the same call
        extra = {"amp": True} if amp else {}
        if trainer_config is not None:
            extra["trainer_config"] = trainer_config
        trainer = SparseTrainer(engine, make_model(model), cfg,
                                batch_size=batch or BATCH, seed=0,
                                sparse_path=path, device=device, **extra,
                                **topo)
    if params is not None:
        trainer.model.load_jax_params(params)
    return engine, trainer, dataset, trainer.model.jax_params()


def run_pass(block: SlotRecordBlock, device: str, params=None,
             path: str = "mxu", packed: bool = False,
             keep_ws: bool = False, around_train=contextlib.nullcontext,
             hold: dict = None, **kw):
    """Engine lifecycle + one train_pass + end_pass on ``device``, on the
    streaming entry point or (packed) through build_pass_feed; ``kw``
    goes to :func:`make_trainer`.  Returns (stats, the model's initial
    params, pass keys); stats carries the feed build seconds and, with
    keep_ws, a copy of the trained working set taken before end_pass.
    ``around_train()`` is a context manager entered around the
    train_pass call alone.  ``hold``: a dict that gets the engine, the
    trainer, (packed) the feed and (with keep_ws) the working set before
    training."""
    engine, trainer, dataset, params0 = make_trainer(
        block, device, params, path, **kw)
    if hold is not None:
        hold.update(engine=engine, trainer=trainer)
        if keep_ws:
            hold["ws0"] = {k: v.clone() for k, v in engine.ws.items()}
    n_keys = engine.num_keys
    extra = {}
    if packed:
        t0 = time.perf_counter()
        feed = trainer.build_pass_feed(dataset)
        if device == "cuda":
            torch.cuda.synchronize()
        extra["build_pass_feed_s"] = time.perf_counter() - t0
        if hold is not None:
            hold["feed"] = feed
        if trainer._resolve_path() == "mxu_sharded":
            extra["feed_bytes"] = feed.device_bytes()
            extra["plan_bytes"] = sum(t.numel() * t.element_size()
                                      for t in feed.plans.values())
        if path == "mxu":
            kept = feed.plans["rows2d"].shape[1] * feed.plan_dims.chunk
            extra["mxu_kept_fraction"] = kept / feed.plan_dims.p_pad
            extra["mxu_eff_p_pad"] = kept
        with around_train():
            stats = trainer.train_pass(feed)
    else:
        with around_train():
            stats = trainer.train_pass(dataset, pack_threads=4)
    extra["crossing"] = list(getattr(trainer, "_mxu_crossing", ()))
    extra["path"] = trainer._resolve_path()
    if keep_ws:
        extra["ws"] = {k: v.clone() for k, v in engine.ws.items()}
    engine.end_pass()
    stats.update(extra)
    stats["timers"] = {"trainer": trainer.timers.report(),
                       "engine": engine.print_sync_timers()}
    if engine.table.size() != n_keys:
        raise AssertionError("end_pass did not write every pass key back")
    return stats, params0, n_keys


def check_pass(what: str, stats: dict, launches: dict, per_batch: dict,
               n_batches: int = N_BATCHES, exact: bool = False) -> None:
    """Finite losses, a reported AUC, and each kernel of the path
    launched at least (exact: exactly) ``per_batch[name]`` times per
    batch."""
    losses = stats["losses"]
    if stats["batches"] != n_batches or len(losses) != n_batches:
        raise AssertionError(f"{what}: trained {stats['batches']} batches")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    if not math.isfinite(stats["auc"]):
        raise AssertionError(f"{what}: AUC not reported: {stats['auc']}")
    for name, k in per_batch.items():
        n = launches[name]
        if n != k * n_batches if exact else n < k * n_batches:
            raise AssertionError(
                f"{what}: {name} launched {n} times in a pass of "
                f"{n_batches} batches (want {'' if exact else '>= '}{k} per "
                "batch)")


def check_launches(what: str, launches: dict, per_batch: dict,
                   n_batches: int) -> None:
    """Each kernel of the path launched at least ``per_batch[name]``
    times per batch over ``n_batches`` batches."""
    for name, k in per_batch.items():
        if launches[name] < k * n_batches:
            raise AssertionError(
                f"{what}: {name} launched {launches[name]} times over "
                f"{n_batches} batches (want >= {k} per batch)")


def cpu_first_loss(what: str, block: SlotRecordBlock, card_loss: float,
                   params, rtol: float = 1e-4, **kw) -> float:
    """The first step again on the CPU, from the same weights and data;
    f32 sums run in another order on the two devices: rtol 1e-4."""
    cpu_stats, _, _ = run_pass(block.slice(0, BATCH), "cpu", params=params,
                               **kw)
    cpu_loss = cpu_stats["losses"][0]
    if not math.isclose(cpu_loss, card_loss, rel_tol=rtol):
        raise AssertionError(f"{what}: first-step loss card {card_loss} vs "
                             f"CPU {cpu_loss}")
    log(f"{what}: first-step loss card {card_loss!r} vs CPU {cpu_loss!r} "
        f"(rtol {rtol:g})")
    return cpu_loss


def same_bits(what: str, a: dict, b: dict) -> None:
    """Two runs of one pass: equal losses and a bit-identical working
    set."""
    if a["losses"] != b["losses"]:
        raise AssertionError(f"{what}: rerun losses {b['losses']} != "
                             f"{a['losses']}")
    diff = [k for k in a["ws"] if not torch.equal(a["ws"][k], b["ws"][k])]
    if diff:
        raise AssertionError(f"{what}: two identical passes left different "
                             f"fields {diff}")


def slice_phase(seed: int = 0):
    rng = np.random.default_rng(seed)
    block = make_block(rng, N_BATCHES * BATCH)
    reset_counts()
    t0 = time.perf_counter()
    stats, params0, n_keys = run_pass(block, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check_pass("slice", stats, launches,
               {"gather_sorted": 1, "scatter_add_sorted": 1})
    losses = stats["losses"]
    step_ms = stats["step_ms"]
    steady = float(np.median(step_ms[1:]))
    log(f"slice: {n_keys} pass keys, losses {losses}, auc "
        f"{stats['auc']}, launches {launches}, step device ms {step_ms} "
        f"(steady median {steady:.3f}), pass wall {wall:.2f} s")
    log(f"slice timers:\n{stats['timers']['trainer']}\n"
        f"{stats['timers']['engine']}")
    cpu_loss = cpu_first_loss("slice", block, losses[0], params0)
    return launches, {"losses": losses, "cpu_first_loss": cpu_loss,
                      "auc": stats["auc"], "step_ms": step_ms,
                      "steady_step_ms": steady, "pass_wall_s": wall,
                      "pass_keys": n_keys}, block, params0


# kernels each packed lowering must launch, per batch
PACKED_KERNELS = {"mxu": {"gather_sorted": 1, "scatter_add_sorted": 1},
                  "fast": {"gather_pool": 1, "scatter_add_sorted": 1},
                  "ragged": {"scatter_add_sorted": 2}}


def packed_phase(seed: int = 2):
    """One packed pass per lowering, its CPU first step, the cross-
    lowering check and the fast/ragged determinism reruns."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, N_BATCHES * BATCH)
    params0, launches, out = None, {}, {}
    for path, per_batch in PACKED_KERNELS.items():
        reset_counts()
        t0 = time.perf_counter()
        stats, p0, n_keys = run_pass(block, "cuda", params=params0,
                                     path=path, packed=True,
                                     keep_ws=path != "mxu")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = read_counts()
        params0 = params0 or p0      # every lowering from the same weights
        check_pass(f"packed[{path}]", stats, launches[path], per_batch)
        steady = float(np.median(stats["step_ms"][1:]))
        cpu_loss = cpu_first_loss(f"packed[{path}]", block,
                                  stats["losses"][0], params0, path=path,
                                  packed=True)
        out[path] = {"losses": stats["losses"], "auc": stats["auc"],
                     "cpu_first_loss": cpu_loss, "step_ms": stats["step_ms"],
                     "steady_step_ms": steady,
                     "build_pass_feed_s": stats["build_pass_feed_s"],
                     "pass_wall_s": wall, "pass_keys": n_keys,
                     "launches": launches[path]}
        if path == "mxu":
            out[path]["mxu_kept_fraction"] = stats["mxu_kept_fraction"]
            out[path]["crossing"] = stats["crossing"]
        log(f"packed[{path}]: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[path]}, step device ms {stats['step_ms']} "
            f"(steady median {steady:.3f}), build_pass_feed "
            f"{stats['build_pass_feed_s']:.2f} s, pass wall {wall:.2f} s"
            + (f", mxu plans keep {stats['mxu_kept_fraction']:.4f} of the "
               "sorted domain" if path == "mxu" else ""))
        if path != "mxu":
            # the same pass again from the same state: bit-identical ws
            again, _, _ = run_pass(block, "cuda", params=params0, path=path,
                                   packed=True, keep_ws=True)
            same_bits(f"packed[{path}]", stats, again)
            out[path]["deterministic"] = True
            log(f"packed[{path}]: rerun left a bit-identical working set")
    first = [out[p]["losses"][0] for p in out]
    spread = (max(first) - min(first)) / abs(min(first))
    if spread > 1e-4:
        raise AssertionError(f"first-step losses of the lowerings differ by "
                             f"{spread:.3g} relative: {first}")
    log(f"packed: first-step losses {dict(zip(out, first))} agree within "
        f"{spread:.3g} relative (rtol 1e-4)")
    return launches, out, block, params0


def profiled(what: str, prof, stats: dict, symbols=SYMBOLS) -> dict:
    """Summary of a pass traced by torch.profiler: device time by kernel,
    the device time per step of each wrapper's CUDA kernels (named in
    ``symbols``) and of the cuBLAS GEMMs, and the device-busy share of
    the steps' event windows (the rest is the device waiting for the host
    to launch work)."""
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events only (kernels, memcpys, memsets): an operator's
    # row would count its kernels' time a second time, and so would the
    # device-timeline span of a record_function (a trace with CPU activity
    # has them)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    window_ms = sum(stats["step_ms"])
    n_steps = len(stats["step_ms"])
    per_step = {k: sum(ms for key, ms, _ in rows
                       if any(sym in key for sym in syms)) / n_steps
                for k, syms in symbols.items()}
    gemm = sum(ms for key, ms, _ in rows
               if any(m in key for m in GEMM_MARKS)) / n_steps
    log(f"profile[{what}]: device busy {busy_ms:.2f} ms of the steps' "
        f"{window_ms:.2f} ms event windows ({100 * busy_ms / window_ms:.1f} "
        f"%), step device ms {stats['step_ms']}; device ms per step: "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_step.items())
        + f", GEMMs {gemm:.4f}")
    for key, ms, n in rows[:12]:
        log(f"profile[{what}]: {ms:8.3f} ms  x{n:<4d} {key[:80]}")
    return {"device_busy_ms": busy_ms, "step_window_ms": window_ms,
            "busy_share": busy_ms / window_ms, "step_ms": stats["step_ms"],
            "kernel_ms_per_step": per_step, "gemm_ms_per_step": gemm,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                    for k, ms, n in rows[:12]]}


def tracer(holder: dict):
    """A context-manager factory for run_pass's ``around_train`` that
    traces the device and keeps the profiler in ``holder["prof"]``."""
    from torch.profiler import ProfilerActivity, profile

    def around():
        holder["prof"] = profile(activities=[ProfilerActivity.CUDA],
                                 acc_events=True)
        return holder["prof"]
    return around


# ---------------------------------------------------------------------------
# phases 5-9: the reference lowering, amp, the optimizer rules, the models
# and the sort crossing
# ---------------------------------------------------------------------------

def reference_phase(block: SlotRecordBlock, params0, mxu_first: float):
    """The streaming reference lowering on the slice's data and weights:
    one scatter launch per step and nothing else; first step = the
    CPU's and = the streaming mxu slice's; a rerun (traced) gives the
    same bits."""
    reset_counts()
    stats, _, _ = run_pass(block, "cuda", params=params0, path="reference",
                           keep_ws=True)
    launches = read_counts()
    check_pass("reference", stats, launches,
               {"gather_sorted": 0, "scatter_add_sorted": 1,
                "gather_pool": 0}, exact=True)
    first = stats["losses"][0]
    if not math.isclose(first, mxu_first, rel_tol=1e-5):
        raise AssertionError(f"reference: first-step loss {first} vs the "
                             f"streaming mxu slice's {mxu_first}")
    cpu_loss = cpu_first_loss("reference", block, first, params0,
                              path="reference")
    holder = {}
    again, _, _ = run_pass(block, "cuda", params=params0, path="reference",
                           keep_ws=True, around_train=tracer(holder))
    same_bits("reference", stats, again)
    steady = float(np.median(stats["step_ms"][1:]))
    log(f"reference: losses {stats['losses']}, auc {stats['auc']}, "
        f"launches {launches}, step device ms {stats['step_ms']} (steady "
        f"median {steady:.3f}); first step = mxu's {mxu_first!r} (rtol "
        "1e-5); rerun bit-identical")
    return launches, {"losses": stats["losses"], "auc": stats["auc"],
                      "cpu_first_loss": cpu_loss, "mxu_first_loss": mxu_first,
                      "step_ms": stats["step_ms"], "steady_step_ms": steady,
                      "deterministic": True,
                      "profile": profiled("reference", holder["prof"],
                                          again)}


def amp_phase(block: SlotRecordBlock, params0, packed_out: dict):
    """amp=True on packed ragged and mxu with the packed phase's data and
    weights: first step within rtol 1e-2 of the lowering's f32 run, and a
    (traced) rerun with the same bits."""
    launches, out = {}, {}
    for path in ("ragged", "mxu"):
        reset_counts()
        stats, _, _ = run_pass(block, "cuda", params=params0, path=path,
                               packed=True, keep_ws=True, amp=True)
        launches[path] = read_counts()
        what = f"amp[{path}]"
        check_pass(what, stats, launches[path], PACKED_KERNELS[path])
        f32 = packed_out[path]["losses"][0]
        gap = abs(stats["losses"][0] - f32) / abs(f32)
        if gap > 1e-2:
            raise AssertionError(f"{what}: first-step loss "
                                 f"{stats['losses'][0]} vs f32 {f32}")
        holder = {}
        again, _, _ = run_pass(block, "cuda", params=params0, path=path,
                               packed=True, keep_ws=True, amp=True,
                               around_train=tracer(holder))
        same_bits(what, stats, again)
        steady = float(np.median(stats["step_ms"][1:]))
        log(f"{what}: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[path]}, step device ms {stats['step_ms']} "
            f"(steady median {steady:.3f}, f32 "
            f"{packed_out[path]['steady_step_ms']:.3f}), build_pass_feed "
            f"{stats['build_pass_feed_s']:.2f} s; first step {gap:.3g} "
            "relative from f32 (rtol 1e-2); rerun bit-identical")
        out[path] = {"losses": stats["losses"], "auc": stats["auc"],
                     "f32_first_loss": f32, "first_loss_gap": gap,
                     "step_ms": stats["step_ms"], "steady_step_ms": steady,
                     "build_pass_feed_s": stats["build_pass_feed_s"],
                     "deterministic": True,
                     "profile": profiled(what, holder["prof"], again)}
    return launches, out


def close_ws(what: str, card: dict, cpu: dict) -> None:
    """The card's and the CPU's working set after the same step: integer
    fields equal, float fields within rtol 1e-4 / atol 1e-6."""
    for k, v in card.items():
        got, want = v.cpu(), cpu[k].cpu()
        if got.dtype.is_floating_point:
            ok = torch.allclose(got, want, rtol=1e-4, atol=1e-6)
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(
                f"{what}: field {k} differs between the card and the CPU "
                f"(max abs {float((got.double() - want.double()).abs().max())})")


def pooled_grads(trainer, sink: list, replace=None) -> None:
    """Record the pooled-feature grads that each step of ``trainer``
    hands to its sparse push (the dense half's third result); with
    ``replace``, hand on the next of those tensors instead."""
    half = trainer._pooled_dense_half

    def spy(*args):
        loss, preds, d_pooled = half(*args)
        sink.append(d_pooled.clone())
        if replace is not None:
            d_pooled = replace.pop(0)
        return loss, preds, d_pooled
    trainer._pooled_dense_half = spy


def trainer_state(engine, trainer) -> dict:
    """A copy of everything one step reads and writes but the data: the
    working set, the dense weights and the dense optimizer's state."""
    return {"ws": {k: v.clone() for k, v in engine.ws.items()},
            "model": {k: v.clone()
                      for k, v in trainer.model.state_dict().items()},
            "opt": copy.deepcopy(trainer.dense_opt.state_dict())}


def load_state(engine, trainer, state: dict) -> None:
    for k, v in state["ws"].items():
        engine.ws[k].copy_(v)
    trainer.model.load_state_dict(state["model"])
    trainer.dense_opt.load_state_dict(state["opt"])


def rules_phase(seed: int = 3):
    """Each sparse optimizer rule, 2 batches of RULES_BATCH on the card;
    each step is replayed on the CPU from the card's state before it,
    its sparse push fed the card's pooled grads: the step's loss within
    rtol 1e-4, the working set after it close (close_ws).

    Why the replay, and why the card's pooled grads.  A ReLU unit whose
    input lies within rounding of 0 passes the grad on one device and
    not on the other: the loss does not move, but that record's pooled
    grads do.  And the adam rules' update m1 / (sqrt(m2) + eps) is
    steepest, 1.6e5 times the grad, where a scaled grad lies near
    eps / sqrt(1 - beta2) ~ 3e-7; the dense Adam's first steps amplify
    likewise.  So a pass trained through on two devices drifts apart by
    up to the learning rate without a fault.  The pooled grads' largest
    gap is logged."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * RULES_BATCH)
    halves = [block.slice(i * RULES_BATCH, (i + 1) * RULES_BATCH)
              for i in range(2)]
    launches, out = {}, {}
    for rule, path in RULES:
        what, key = f"rules[{rule}, {path}]", f"{rule}_{path}"
        kw = dict(path=path, optimizer=rule, batch=RULES_BATCH)
        engine, trainer, dataset, params0 = make_trainer(block, "cuda", **kw)
        feed = trainer.build_pass_feed(dataset)
        states, grads = [trainer_state(engine, trainer)], []
        pooled_grads(trainer, grads)
        reset_counts()
        card = trainer.train_pass(feed, progress=lambda _: states.append(
            trainer_state(engine, trainer)))
        launches[key] = read_counts()
        check_pass(what, card, launches[key], PACKED_KERNELS[path],
                   n_batches=2)
        cpu_engine, cpu_trainer, _, _ = make_trainer(block, "cpu", params0,
                                                     **kw)
        cpu_grads = []
        pooled_grads(cpu_trainer, cpu_grads, [g.cpu() for g in grads])
        cpu_losses, grad_gap = [], []
        for i, half in enumerate(halves):
            load_state(cpu_engine, cpu_trainer, states[i])
            one = SlotDataset(dataset.feed_config)
            one._blocks = [half]
            loss = cpu_trainer.train_pass(
                cpu_trainer.build_pass_feed(one))["losses"][0]
            cpu_losses.append(loss)
            if not math.isclose(card["losses"][i], loss, rel_tol=1e-4):
                raise AssertionError(f"{what}: step {i} loss card "
                                     f"{card['losses'][i]} vs CPU {loss}")
            close_ws(f"{what} step {i}", states[i + 1]["ws"], cpu_engine.ws)
            grad_gap.append(float((grads[i].cpu() - cpu_grads[i])
                                  .abs().max()))
        engine.end_pass()
        cpu_engine.end_pass()
        log(f"{what}: losses card {card['losses']} vs CPU {cpu_losses} "
            "(rtol 1e-4); working set after each step within rtol 1e-4 / "
            f"atol 1e-6; pooled grads' largest gap per step {grad_gap}")
        out[key] = {"losses": card["losses"], "cpu_losses": cpu_losses,
                    "pooled_grad_gap": grad_gap, "step_ms": card["step_ms"]}
    return launches, out


def models_phase(seed: int = 4):
    """CtrDnn and WideDeep on the reference lowering and MMoE through
    MultiTaskSparseTrainer, 2 batches at full batch: one scatter launch
    per step, first step = the CPU's."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * BATCH, n_labels=2)
    launches, out = {}, {}
    for model in ("ctr_dnn", "widedeep", "mmoe"):
        reset_counts()
        stats, params0, _ = run_pass(block, "cuda", path="reference",
                                     model=model)
        launches[model] = read_counts()
        check_pass(f"models[{model}]", stats, launches[model],
                   {"gather_sorted": 0, "scatter_add_sorted": 1,
                    "gather_pool": 0}, n_batches=2, exact=True)
        cpu_loss = cpu_first_loss(f"models[{model}]", block,
                                  stats["losses"][0], params0,
                                  path="reference", model=model)
        out[model] = {"losses": stats["losses"], "auc": stats["auc"],
                      "cpu_first_loss": cpu_loss, "step_ms": stats["step_ms"]}
        if model == "mmoe":
            out[model]["task_aucs"] = [stats["task0_auc"],
                                       stats["task1_auc"]]
        log(f"models[{model}]: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[model]}, step device ms {stats['step_ms']}")
    return launches, out


def crossing_phase(block: SlotRecordBlock, params0):
    """Packed mxu with FLAGS_mxu_crossing pinned to take, then to sort:
    the same bits; then best_mode's measured choice at this geometry."""
    from paddlebox_tpu_torch.ops import crossing as cx
    launches, runs = {}, {}
    try:
        for mode in ("take", "sort"):
            flags.set_flags({"mxu_crossing": mode})
            reset_counts()
            runs[mode], _, _ = run_pass(block, "cuda", params=params0,
                                        path="mxu", packed=True, keep_ws=True)
            launches[mode] = read_counts()
            check_pass(f"crossing[{mode}]", runs[mode], launches[mode],
                       PACKED_KERNELS["mxu"])
            if runs[mode]["crossing"] != [mode, mode]:
                raise AssertionError(f"crossing[{mode}]: the step crossed by "
                                     f"{runs[mode]['crossing']}")
    finally:
        flags.set_flags({"mxu_crossing": "auto"})
    same_bits("crossing: sort vs take", runs["take"], runs["sort"])
    p = N_SLOTS * CAP * BATCH
    eff = runs["take"]["mxu_eff_p_pad"]
    # the geometries _crossing_modes asks for with the static planes
    tuned = {"pull": cx.measure(p, p, 3 + MF_DIM, "float32"),
             "push": cx.measure(eff, p, 1 + MF_DIM, "float32")}
    for k, (mode, t_take, t_sort) in tuned.items():
        log(f"crossing[{k}]: best_mode picks {mode} (take {t_take:.4f} ms, "
            f"sort {t_sort:.4f} ms)")
    log("crossing: sort and take leave bit-equal losses and working set; "
        f"step device ms take {runs['take']['step_ms']}, sort "
        f"{runs['sort']['step_ms']}")
    return launches, {
        "losses": runs["take"]["losses"],
        "step_ms": {m: runs[m]["step_ms"] for m in runs},
        "best_mode": {k: {"mode": m, "take_ms": a, "sort_ms": b}
                      for k, (m, a, b) in tuned.items()}}


# ---------------------------------------------------------------------------
# phases 10-11: the multi-pass day loop and crash recovery
# ---------------------------------------------------------------------------

LIFE_DATES = ("20261016", "20261017")      # 2 days
LIFE_PASSES = 3                            # passes of day 1
# batches a pass: N_BATCHES until the whole script reached 91 % of its
# time limit on a slower host; every check of the phase holds at 1 (a
# pass still holds ~0.7 M of the 2 M keys: stale re-pulls, warm hits and
# the small cache's evictions all remain)
LIFE_BATCHES = 1
REC_PASSES, REC_DATE = 3, "20261016"       # recovery: 3 passes, full size
# the lowerings of the day loop: the default (auto → mxu on one card) and
# ragged, whose host CSR build the prefetch exists to hide
LIFE_PATHS = (("mxu", "auto"), ("ragged", "ragged"))
# the device-cache runs of the day loop, each held against the cache-off
# serial run of its lowering: (label, path, prefetch, cache rows, heat).
# 2,097,152 rows hold the whole 2 M key space; 262,144 (the flag's
# default) evicts every pass and makes the prefetched adoption take the
# fallback pull
CACHE_ROWS = 2_097_152
# every run's depth: day 1's passes and day 2's first (the change of date
# drops the cache, so the 4th pass is cold again); day 2 was 3 passes
# until the script's whole run neared its time limit, and its passes 2-3
# repeated what day 1's prove (serial = prefetched, the stale re-pull,
# warm cache hits)
LIFE_CACHE_DEPTH = LIFE_PASSES + 1
LIFE_CACHE_RUNS = (("mxu", "auto", False, CACHE_ROWS, False),
                   ("mxu", "auto", True, CACHE_ROWS, False),
                   ("mxu", "auto", True, 262_144, True),
                   ("ragged", "ragged", True, CACHE_ROWS, False))
# counters the main thread moves, read at every pass end
PASS_COUNTERS = ("ps.cache.hits", "ps.cache.gather_fallback_rows",
                 "ps.cache.evictions", "ps.engine.stale_refresh_rows")
# which index resolved the pass mapper's keys
INDEX_COUNTERS = ("ps.mapper.native_rows", "ps.mapper.sorted_rows")


def day_trainer(device: str, path: str):
    """A fresh engine and trainer of the bench model on ``device``."""
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0, device=device)
    trainer = SparseTrainer(engine, make_model("deepfm"), feed_config(),
                            batch_size=BATCH, seed=0, sparse_path=path,
                            device=device)
    return engine, trainer


@contextlib.contextmanager
def engine_flags(cache_rows: int = 0, heat_on: bool = False):
    """Engines built inside take the device cache (``cache_rows`` > 0)
    and key-space heat; both are off again after."""
    from paddlebox_tpu_torch.ps import heat
    flags.set_flags({"ps_device_cache": cache_rows > 0,
                     "ps_device_cache_rows": cache_rows or CACHE_ROWS,
                     "obs_heat": heat_on})
    try:
        yield
    finally:
        flags.set_flags({"ps_device_cache": False, "obs_heat": False})
        heat.disable()


def one_pass_dataset(block: SlotRecordBlock) -> SlotDataset:
    ds = SlotDataset(feed_config())
    ds._blocks = [block]
    return ds


def stat_delta(before: dict, after: dict, key: str) -> float:
    return after.get(key, 0.0) - before.get(key, 0.0)


def table_state(table):
    """Every key of the host table, sorted, and all its fields."""
    keys = np.sort(table.export_keys())
    return keys, table.bulk_pull(keys)


def same_world(what: str, a: dict, b: dict) -> None:
    """Two runs left bit-identical per-pass losses, host tables (every
    key, every field) and dense weights and optimizer state."""
    if a["losses"] != b["losses"]:
        raise AssertionError(f"{what}: per-pass losses differ: "
                             f"{a['losses']} vs {b['losses']}")
    (ka, ta), (kb, tb) = a["table"], b["table"]
    if not np.array_equal(ka, kb):
        raise AssertionError(f"{what}: the tables hold other keys "
                             f"({len(ka)} vs {len(kb)})")
    diff = [f for f in ta if not np.array_equal(ta[f], tb[f])]
    if diff:
        raise AssertionError(f"{what}: table fields {diff} differ")
    diff = [k for k in a["dense"] if not torch.equal(a["dense"][k],
                                                      b["dense"][k])]
    if diff:
        raise AssertionError(f"{what}: dense tensors {diff} differ")


def dense_state(trainer) -> dict:
    """Copies of the dense weights and the dense optimizer's state."""
    dense = {f"model.{k}": v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    for i, st in trainer.dense_opt.state_dict()["state"].items():
        for k, v in st.items():
            dense[f"opt.{i}.{k}"] = v.clone()
    return dense


def world_of(engine, trainer, losses) -> dict:
    return {"losses": losses, "table": table_state(engine.table),
            "dense": dense_state(trainer)}


def heat_summary() -> dict:
    """What the heat sketches saw of the run: the pull site's working-set
    rows (HLL, since the last change of date) and Zipf fit, the sketches'
    bytes and the device cache's coverage."""
    from paddlebox_tpu_torch.ps import heat
    if heat.ACTIVE is None:
        raise AssertionError("heat was asked for but is off")
    r = heat.ACTIVE.render(topn=100)
    pull = r["sites"]["pull"]
    return {"working_set_rows": pull["working_set_rows"],
            "zipf_exponent": pull["zipf_exponent"],
            "topk_share": pull["topk_share"],
            "sketch_bytes": r["sketch_bytes"],
            "cache_hot_coverage": r["cache_hot_coverage"],
            "sites": sorted(r["sites"])}


def day_loop(blocks, device: str, path: str, prefetch: bool):
    """The passes of ``blocks`` (one list of pass blocks per day of
    LIFE_DATES) through the engine lifecycle, serially or through
    PassPrefetcher.  Returns the world it left and a dict: the time each
    pass's end_pass returned, the loop start, the engine's timers
    {name: (seconds, count)}, the feed seconds hidden under step windows
    summed over the passes, and per pass the keys, the cache hit rate set
    at adoption and the deltas of PASS_COUNTERS; with the cache on, its
    row and store bytes; with heat on, its summary."""
    from paddlebox_tpu_torch.data.prefetch import PassPrefetcher
    from paddlebox_tpu_torch.utils.monitor import stat_get
    engine, trainer = day_trainer(device, path)
    losses, ends, per_pass = [], [], []
    hidden = dict.fromkeys(("pull", "pack", "upload", "write"), 0.0)
    prev = {k: stat_get(k) for k in PASS_COUNTERS}

    def pass_ended():
        ends.append(time.perf_counter())
        for k in hidden:
            hidden[k] += stat_get(f"feed.{k}_hidden_s")
        cur = {k: stat_get(k) for k in PASS_COUNTERS}
        per_pass.append({"keys": engine.num_keys,
                         "hit_rate": stat_get("ps.cache.hit_rate"),
                         **{k.split(".")[-1]: cur[k] - prev[k]
                            for k in PASS_COUNTERS}})
        prev.update(cur)

    t0 = time.perf_counter()
    if not prefetch:
        for date, day in zip(LIFE_DATES, blocks):
            engine.set_date(date)
            for block in day:
                engine.begin_feed_pass()
                engine.add_keys(block.all_keys())
                engine.end_feed_pass()
                engine.begin_pass()
                feed = trainer.build_pass_feed(one_pass_dataset(block))
                losses.append(trainer.train_pass(feed)["losses"])
                engine.end_pass()
                pass_ended()
    else:
        with PassPrefetcher(engine, trainer) as pre:
            for date, day in zip(LIFE_DATES, blocks):
                for block in day:
                    def load(block=block):
                        engine.add_keys(block.all_keys())
                        return one_pass_dataset(block)
                    pre.submit(load, tag=date, date=date)
            for _ in range(sum(len(day) for day in blocks)):
                feed = pre.next_pass()
                losses.append(trainer.train_pass(feed)["losses"])
                pre.end_pass()
                pass_ended()
    if device == "cuda":
        torch.cuda.synchronize()
    info = dict(ends=ends, t0=t0, per_pass=per_pass, hidden=hidden,
                timers={n: (secs, c) for n, secs, c in engine.timers.rows()})
    if engine.cache is not None:
        if engine.cache.device != engine.device:
            raise AssertionError("the cache's store is not on the engine's "
                                 "device")
        info["cache"] = {"row_bytes": engine.cache.row_bytes,
                         "store_bytes": engine.cache.store_bytes,
                         "resident_rows": engine.cache.resident_rows}
    from paddlebox_tpu_torch.ps import heat
    if heat.ACTIVE is not None:
        info["heat"] = heat_summary()
    return world_of(engine, trainer, losses), info


def median_s(fn, reps: int = 3) -> float:
    """Median wall seconds of ``reps`` calls of ``fn`` after one warm
    call (which also fills PyTorch's pinned-memory cache)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# the packer's mapper calls: 4 pack threads → 8 record ranges per slot
# of a 65,536-record pass, 1-3 keys a record (``pass_feed._record_ranges``)
PACK_CALL_KEYS = N_BATCHES * BATCH // 8 * (CAP + 1) // 2


def pooled_build(host_soa: dict, dev: torch.device, pool: dict) -> dict:
    """The staging the port does not keep, timed against its fresh
    buffers: ``build_working_set`` with each field's pinned buffer of the
    last build rewritten in place once that build's copy (a CUDA event)
    has finished; only row 0 and the stale tail are zeroed."""
    n = len(host_soa["show"])
    total, ws = size_bucket(n + 1), {}
    for f, src in host_soa.items():
        if f == "unseen_days":
            continue
        dtype = torch.int32 if src.dtype == np.int32 else torch.float32
        shape = (total,) + src.shape[1:]
        buf, done = pool.get(f, (None, None))
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = torch.zeros(shape, dtype=dtype,
                              pin_memory=dev.type == "cuda")
        else:
            if done is not None:
                done.synchronize()
            host = buf.numpy()
            host[0] = 0
            host[n + 1:] = 0
        buf.numpy()[1:n + 1] = src
        done = None
        if dev.type == "cuda":
            ws[f] = buf.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            ws[f] = buf.clone()
        pool[f] = (buf, done)
    return ws


def native_lookup(shard, keys):
    """``_Shard.lookup`` through the native hash, which the port's host
    table does not use, for the index A/B: the hash takes the keys the
    shard appended since the last call (the A/B never replaces a
    shard's rows), then answers one probe per key."""
    from paddlebox_tpu_torch.native import hash_map
    with shard.lock:
        h = shard.__dict__.get("_ab_hash")
        if h is None:
            h = shard._ab_hash = hash_map.NativeKeyHash(max(shard.size, 1024))
        if len(h) < shard.size:
            h.upsert(shard.keys[len(h):])
        rows = h.find(np.asarray(keys, np.uint64))
        return np.maximum(rows, 0), rows >= 0


def host_tier_ab(seed: int = 12, device: str = "cuda",
                 occurrences: int = N_BATCHES * BATCH * N_SLOTS * (CAP + 1)
                 // 2) -> dict:
    """The host tier's choices, timed at the day loop's sizes on this
    machine's CPU, each against its alternative: the key
    index of the host table's pass pull and write-back (the port's sorted
    view against the native hash, ``native_lookup``), the index of
    ``PassKeyMapper`` at the packer's call size and at a refresh's (the
    port's native hash against the binary search), and the working set's
    staging (fresh pinned buffers, which PyTorch's caching host allocator
    recycles once their copies finish, against ``pooled_build``).  Both
    sides of each must give the same answer, and two working sets built
    back to back must both stay intact."""
    from paddlebox_tpu_torch.native import hash_map
    from paddlebox_tpu_torch.ps import embedding, host_table
    if not hash_map.available():
        raise AssertionError("index: the native library did not build")
    rng = np.random.default_rng(seed)
    occs = [rng.integers(1, KEY_SPACE, size=occurrences).astype(np.uint64)
            for _ in range(3)]
    passes = [np.unique(o) for o in occs]
    cfg = EmbeddingTableConfig(embedding_dim=MF_DIM, shard_num=8,
                               sgd=SparseSGDConfig(mf_create_thresholds=0.0))

    def table_run():
        table, t, pulled = host_table.ShardedHostTable(cfg, seed=0), {}, []
        for i, keys in enumerate(passes):
            t0 = time.perf_counter()
            rows = table.bulk_pull(keys)
            t[f"pull{i}"] = time.perf_counter() - t0
            rows["show"] = rows["show"] + 1.0
            pulled.append(rows)
            t0 = time.perf_counter()
            table.bulk_write(keys, rows)
            t[f"write{i}"] = time.perf_counter() - t0
        return t, pulled

    def mapper_run():
        t0 = time.perf_counter()
        mapper = embedding.PassKeyMapper(passes[2])
        pack = [mapper(occs[2][i:i + PACK_CALL_KEYS])
                for i in range(0, occurrences, PACK_CALL_KEYS)]
        pack_s = time.perf_counter() - t0
        stale = passes[2][np.isin(passes[2], passes[1])]
        t0 = time.perf_counter()
        refresh = mapper(stale)
        return (pack_s, time.perf_counter() - t0, np.concatenate(pack),
                refresh)

    srt_t, srt_rows = table_run()
    real_lookup = host_table._Shard.lookup
    host_table._Shard.lookup = native_lookup
    try:
        nat_t, nat_rows = table_run()
    finally:
        host_table._Shard.lookup = real_lookup
    nat_map = mapper_run()
    real_available = hash_map.available
    hash_map.available = lambda: False
    try:
        srt_map = mapper_run()
    finally:
        hash_map.available = real_available
    for a, b in zip(nat_rows, srt_rows):
        if any(not np.array_equal(a[f], b[f]) for f in a):
            raise AssertionError("index: the native and sorted host-table "
                                 "pulls differ")
    if not (np.array_equal(nat_map[2], srt_map[2])
            and np.array_equal(nat_map[3], srt_map[3])):
        raise AssertionError("index: the native and sorted mappers differ")
    index = {"keys_per_pass": [len(k) for k in passes],
             "table_sorted_s": srt_t, "table_native_s": nat_t,
             "mapper_pack_calls": -(-occurrences // PACK_CALL_KEYS),
             "mapper_pack_keys": occurrences,
             "mapper_pack_s": {"native": nat_map[0], "sorted": srt_map[0]},
             "mapper_refresh_keys": int(len(nat_map[3])),
             "mapper_refresh_s": {"native": nat_map[1],
                                  "sorted": srt_map[1]}}
    log("index: host table pull/write s of passes 2-3, sorted view (the "
        "port's) "
        + " ".join(f"{k}={v:.3f}" for k, v in srt_t.items() if k[-1] != "0")
        + " | native hash "
        + " ".join(f"{k}={v:.3f}" for k, v in nat_t.items() if k[-1] != "0")
        + f"; mapper: {index['mapper_pack_calls']} pack calls of "
        f"{PACK_CALL_KEYS} keys native (the port's, hash build included) "
        f"{nat_map[0]:.3f} s, binary search {srt_map[0]:.3f} s; one refresh "
        f"call of {len(nat_map[3])} keys native {nat_map[1]:.3f} s, binary "
        f"search {srt_map[1]:.3f} s")

    soa = dict(srt_rows[2])
    soa2 = {f: v + 1 for f, v in soa.items()}
    n, dev, pool = len(soa["show"]), torch.device(device), {}

    def build(src, pooled=False):
        ws = (pooled_build(src, dev, pool) if pooled
              else embedding.build_working_set(src, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return ws

    staging = {"rows": n, "fields": len(soa),
               "fresh_s": median_s(lambda: build(soa)),
               "pooled_s": median_s(lambda: build(soa, True))}
    ws1, ws2 = build(soa), build(soa2)
    pooled = build(soa2, True)
    for f in ws1:
        got = ws1[f][1:n + 1].cpu().numpy()
        if not np.array_equal(got, soa[f].astype(got.dtype)):
            raise AssertionError(f"staging: the first working set's {f} "
                                 "was overwritten by the second build")
        if not torch.equal(ws2[f], pooled[f]):
            raise AssertionError(f"staging: the fresh and pooled builds' "
                                 f"{f} differ")
    log(f"staging: build_working_set of {n} rows × {len(ws1)} fields, "
        f"fresh buffers (the port's) {staging['fresh_s']:.4f} s, a reused "
        f"pinned pool {staging['pooled_s']:.4f} s (medians of 3); two "
        "working sets built back to back stay intact")
    return {"index": index, "staging": staging}


def log_run(what: str, r: dict, info: dict) -> None:
    walls = r["pass_wall_s"]
    timers = info["timers"]
    log(f"{what}: day wall s {[round(x, 3) for x in r['day_wall_s']]}"
        f", median pass wall {r['median_pass_wall_s']:.3f} s (passes "
        f"{[round(x, 3) for x in walls]}), prefetch wait "
        f"{r.get('prefetch_wait_s', 0.0):.3f} s, prefetch build "
        f"{r.get('prefetch_build_s', 0.0):.3f} s, hidden s of the "
        f"last pass {r['hidden_s_last_pass']} and of all passes "
        f"{info['hidden']}, refresh_stale {r['refresh_stale_s']:.3f} s for "
        f"{int(r['stale_refresh_rows'])} rows, launches {r['launches']}; "
        f"index rows {r['index_rows']}; engine timers s "
        + " ".join(f"{n}={t:.3f}/{c}" for n, (t, c) in sorted(timers.items())))


def lifecycle_phase(seed: int = 5, device: str = "cuda"):
    """The day loop at the bench model's full width: LIFE_CACHE_DEPTH
    passes of LIFE_BATCHES batches over 2 days (day 1's LIFE_PASSES and day
    2's first), each lowering serial then prefetched from the same data,
    weights and table seed; the two runs must leave the same bits, and
    the prefetched one must have re-pulled stale rows.  Then the
    LIFE_CACHE_RUNS with the device cache on, each of which must leave
    the bits of its lowering's cache-off serial run."""
    from paddlebox_tpu_torch.utils.monitor import stat_get, stat_snapshot
    rng = np.random.default_rng(seed)
    t_data = time.perf_counter()
    blocks = [[make_block(rng, LIFE_BATCHES * BATCH)
               for _ in range(LIFE_PASSES)],
              [make_block(rng, LIFE_BATCHES * BATCH)
               for _ in range(LIFE_CACHE_DEPTH - LIFE_PASSES)]]
    log(f"lifecycle: data for {LIFE_CACHE_DEPTH} passes over "
        f"{len(LIFE_DATES)} days × {LIFE_BATCHES} batches made in "
        f"{time.perf_counter() - t_data:.2f} s")
    n_batches = LIFE_CACHE_DEPTH * LIFE_BATCHES
    launches, out = {}, {"host_ab": host_tier_ab(device=device)}

    def one_run(key, what, label, path, prefetch, cache=False):
        s0 = stat_snapshot("")
        reset_counts()
        world, info = day_loop(blocks, device, path, prefetch)
        launches[key] = read_counts()
        s1 = stat_snapshot("")
        check_launches(what, launches[key], PACKED_KERNELS[label],
                       n_batches)
        flat = [x for p in world["losses"] for x in p]
        if not all(math.isfinite(x) for x in flat):
            raise AssertionError(f"{what}: non-finite loss")
        ends, t0 = info["ends"], info["t0"]
        walls = [float(x) for x in np.diff([t0] + ends)]
        index = {k: stat_delta(s0, s1, k) for k in INDEX_COUNTERS}
        if index["ps.mapper.native_rows"] <= 0 or \
                index["ps.mapper.sorted_rows"] > 0:
            raise AssertionError(f"{what}: the pass mapper did not run "
                                 f"native: {index}")
        r = {"day_wall_s": [ends[LIFE_PASSES - 1] - t0,
                            ends[-1] - ends[LIFE_PASSES - 1]],
             "passes": len(ends),
             "pass_wall_s": walls,
             "median_pass_wall_s": float(np.median(walls)),
             "stale_refresh_rows": stat_delta(
                 s0, s1, "ps.engine.stale_refresh_rows"),
             "refresh_stale_s": info["timers"].get(
                 "refresh_stale", (0.0, 0))[0],
             "build_pull_rows": stat_delta(s0, s1,
                                           "ps.engine.build_pull_rows"),
             "hidden_s_last_pass": {
                 k: stat_get(f"feed.{k}_hidden_s")
                 for k in ("pull", "pack", "upload", "write")},
             "hidden_s_all_passes": info["hidden"],
             "engine_timers": info["timers"],
             "per_pass": info["per_pass"],
             "index_rows": {k.split(".", 1)[1]: v for k, v in index.items()},
             "first_losses": world["losses"][0],
             "launches": launches[key]}
        if prefetch:
            r["prefetch_wait_s"] = stat_delta(s0, s1,
                                              "data.prefetch.wait_s.sum")
            r["prefetch_build_s"] = stat_delta(s0, s1,
                                               "data.prefetch.build_s.sum")
        for k in ("cache", "heat"):
            if k in info:
                r[k] = info[k]
        out[key] = r
        log_run(what, r, info)
        return world, r

    for label, path in LIFE_PATHS:
        worlds = {}
        for mode in ("serial", "prefetch"):
            key, what = f"{label}_{mode}", f"lifecycle[{label},{mode}]"
            worlds[mode], r = one_run(key, what, label, path,
                                      mode == "prefetch")
            if mode == "prefetch" and r["stale_refresh_rows"] <= 0:
                raise AssertionError(f"{what}: the stale-row refresh "
                                     "re-pulled no row")
        same_world(f"lifecycle[{label}] prefetch vs serial",
                   worlds["serial"], worlds["prefetch"])
        log(f"lifecycle[{label}]: prefetched = serial bitwise (per-pass "
            f"losses, {len(worlds['serial']['table'][0])} table keys × "
            "every field, dense weights and Adam state)")
        for c_label, c_path, prefetch, rows, heat_on in LIFE_CACHE_RUNS:
            if c_label != label:
                continue
            mode = "prefetch" if prefetch else "serial"
            key = f"{label}_{mode}_cache{rows}"
            what = f"lifecycle[{label},{mode},cache={rows}]"
            with engine_flags(rows, heat_on):
                world, r = one_run(key, what, label, c_path, prefetch,
                                   cache=True)
            same_world(f"{what} vs cache off", worlds["serial"], world)
            check_cache_run(what, r, prefetch, rows)
            base = float(np.median(out[f"{label}_{mode}"]["pass_wall_s"]))
            pp = r["per_pass"]
            log(f"{what}: = cache off bitwise; median pass wall "
                f"{r['median_pass_wall_s']:.3f} s vs {base:.3f} s cache off "
                f"({mode}); per pass hit_rate "
                f"{[round(p['hit_rate'], 4) for p in pp]}, build_pull_rows "
                f"{[p['keys'] - int(p['hits']) for p in pp]}, "
                f"stale_refresh_rows "
                f"{[int(p['stale_refresh_rows']) for p in pp]}, "
                f"gather_fallback_rows "
                f"{[int(p['gather_fallback_rows']) for p in pp]}, evictions "
                f"{[int(p['evictions']) for p in pp]}; cache_gather "
                f"{r['engine_timers'].get('cache_gather', (0.0, 0))[0]:.3f} s"
                f", cache_fold "
                f"{r['engine_timers'].get('cache_fold', (0.0, 0))[0]:.3f} s;"
                f" row_bytes {r['cache']['row_bytes']}, store "
                f"{r['cache']['store_bytes'] / 2**20:.1f} MiB"
                + (f"; heat {r['heat']}" if "heat" in r else ""))
            del world
        del worlds
    return launches, out


def check_cache_run(what: str, r: dict, prefetch: bool, rows: int) -> None:
    """Passes 1 and 4 are cold (set_date drops the cache).  Serially,
    passes 2 and 3 find the earlier passes' rows resident.  Under the
    prefetcher, pass N+1's snapshot is taken while pass N trains, before
    its fold-back: pass 3 finds pass 1's rows, and whether pass 2 finds
    any races the worker against the fold-back.  The per-pass table rows
    must add up to the run's ``build_pull_rows``, and the 262,144-row
    cache must evict."""
    pp = r["per_pass"]
    warm = (1, 2) if not prefetch else (2,)
    cold = [i + 1 for i in warm if pp[i]["hits"] <= 0]
    if cold or pp[0]["hits"] or pp[LIFE_PASSES]["hits"]:
        raise AssertionError(f"{what}: hits per pass "
                             f"{[p['hits'] for p in pp]}")
    pulled = sum(p["keys"] - p["hits"] for p in pp)
    if pulled != r["build_pull_rows"]:
        raise AssertionError(f"{what}: per-pass pulls {pulled} vs "
                             f"build_pull_rows {r['build_pull_rows']}")
    evictions = sum(p["evictions"] for p in pp)
    if rows < KEY_SPACE and evictions <= 0:
        raise AssertionError(f"{what}: a {rows}-row cache evicted nothing")
    if r["cache"]["store_bytes"] != r["cache"]["row_bytes"] * rows:
        raise AssertionError(f"{what}: store bytes {r['cache']}")


def write_slot_file(path: str, block: SlotRecordBlock) -> None:
    """``block`` as MultiSlot text: per record the label, the dense
    values and each slot's feasigns, each group led by its length.  Built
    column by column (one list of per-record strings per group)."""
    n = block.n
    label = block.float_slots["label"][0].astype(np.int64).tolist()
    dense = np.char.mod("%.6g", block.float_slots["dense0"][0].reshape(
        n, DENSE_DIM)).tolist()
    cols = [[f"1 {x}" for x in label],
            [f"{DENSE_DIM} " + " ".join(row) for row in dense]]
    for i in range(N_SLOTS):
        vals, off = block.uint64_slots[f"s{i}"]
        ids = vals.astype(str).tolist()
        off = off.tolist()
        cols.append([f"{off[r + 1] - off[r]} "
                     + " ".join(ids[off[r]:off[r + 1]]) for r in range(n)])
    with open(path, "w") as f:
        f.write("\n".join(" ".join(parts) for parts in zip(*cols)) + "\n")


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


# (case, kill point, which hit of it kills (0 = the first pass's),
#  prefetch, device-cache rows or 0).  The cache case dies at the third
# pass's write-back: under the prefetcher that pass is the first to find
# rows resident (its snapshot follows pass 1's fold-back), so the kill
# drops a cache that served hits
RECOVERY_CASES = (("fault_free", None, 0, False, 0),
                  ("end_pass_serial", "end_pass", 1, False, 0),
                  ("end_pass_prefetch", "end_pass", 1, True, 0),
                  ("ckpt_commit_serial", "ckpt_commit", 1, False, 0),
                  ("end_pass_prefetch_cache", "end_pass", 2, True,
                   CACHE_ROWS))


def parser_check(path: str) -> dict:
    """The feed's parser on the card is the native one, and it reads one
    pass file into the Python parser's blocks bit for bit; both timed."""
    from paddlebox_tpu_torch.data.data_feed import DataFeed, make_parser
    from paddlebox_tpu_torch.native.slot_parser import NativeSlotParser
    if not isinstance(make_parser(feed_config()), NativeSlotParser):
        raise AssertionError("recovery: make_parser did not return the "
                             "native parser (did the native library build?)")
    feeds = {"native": DataFeed(feed_config()),
             "python": DataFeed(feed_config(), use_native=False)}
    blocks, secs = {}, {}
    for name, feed in feeds.items():
        t0 = time.perf_counter()
        blocks[name] = list(feed.read_file(path))
        secs[name] = time.perf_counter() - t0
    nat, py = blocks["native"], blocks["python"]
    if sum(b.n for b in nat) != N_BATCHES * BATCH or len(nat) != len(py):
        raise AssertionError(f"recovery: parsed {sum(b.n for b in nat)} "
                             f"records in {len(nat)} blocks")
    for a, b in zip(nat, py):
        for kind in ("uint64_slots", "float_slots"):
            ga, gb = getattr(a, kind), getattr(b, kind)
            for name in gb:
                if any(x.dtype != y.dtype or not np.array_equal(x, y)
                       for x, y in zip(ga[name], gb[name])):
                    raise AssertionError(f"recovery: native and Python "
                                         f"parsers differ on {name}")
    log(f"recovery: the native parser reads a pass file ({N_BATCHES * BATCH}"
        f" records) in {secs['native']:.3f} s, the Python parser in "
        f"{secs['python']:.3f} s: the same blocks bitwise")
    return {"native_parse_s": secs["native"],
            "python_parse_s": secs["python"]}


def write_pass_files(work: str, seed: int, n: int) -> list:
    """``n`` slot text files of N_BATCHES × BATCH fresh records each (keys
    from the KEY_SPACE), one a pass, in ``work``."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    paths = []
    for p in range(n):
        paths.append(os.path.join(work, f"pass{p}.txt"))
        write_slot_file(paths[-1], make_block(rng, N_BATCHES * BATCH))
    log(f"files: {n} files of {N_BATCHES * BATCH} records written in "
        f"{time.perf_counter() - t0:.2f} s")
    return paths


def recovery_phase(seed: int = 6, device: str = "cuda", paths=None):
    """fleet.train_passes over slot text files (REC_PASSES passes of
    N_BATCHES × BATCH records, one reader thread, the native parser) with
    a TrainCheckpoint: a fault-free run, then seeded kills at end_pass
    (serial, prefetched, and prefetched with the device cache on) and at
    ckpt_commit (serial), each resumed (resume=2) to the fault-free run's
    bits.  ``paths``: the pass files (written here when None)."""
    from paddlebox_tpu_torch import fleet
    from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
    from paddlebox_tpu_torch.ps import faults
    from paddlebox_tpu_torch.utils import flight
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot
    work = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        if paths is None:
            paths = write_pass_files(work, seed, REC_PASSES)
        files = [[p] for p in paths[:REC_PASSES]]
        launches, out, base = {}, parser_check(files[0][0]), None
        for case, point, hit, prefetch, cache_rows in RECOVERY_CASES:
            what = f"recovery[{case}]"
            with engine_flags(cache_rows):
                engine, trainer = day_trainer(device, "auto")
            ds = fleet.BoxPSDataset(feed_config(), engine=engine,
                                    read_threads=1)
            root = os.path.join(work, case)
            ck = TrainCheckpoint(root)
            s0 = stat_snapshot("")
            m0 = time.monotonic()
            reset_counts()
            if point is not None:
                flags.set_flags({"ps_fault_injection": True})
                faults.install(faults.FaultPlan(seed=13).kill_at(point,
                                                                 at=(hit,)))
            try:
                metrics = fleet.train_passes(trainer, ds, files,
                                             date=REC_DATE,
                                             prefetch=prefetch,
                                             checkpoint=ck, resume=2)
            finally:
                faults.uninstall()
                flags.set_flags({"ps_fault_injection": False})
            if device == "cuda":
                torch.cuda.synchronize()
            launches[case] = read_counts()
            s1 = stat_snapshot("")
            check_launches(what, launches[case], PACKED_KERNELS["mxu"],
                           REC_PASSES * N_BATCHES)
            if any(m is None for m in metrics) or len(metrics) != REC_PASSES:
                raise AssertionError(f"{what}: trained {metrics!r}")
            world = world_of(engine, trainer, [m["losses"] for m in metrics])
            resumes = stat_delta(s0, s1, "ps.fleet.auto_resume")
            if point is not None and resumes < 1:
                raise AssertionError(f"{what}: no auto-resume ran")
            saves = [(e["gen_kind"], e["save_s"])
                     for e in reversed(flight.events(kind="ckpt_commit"))
                     if e["mono"] >= m0]
            gens = sorted(n for n in os.listdir(root)
                          if n.startswith("gen-"))
            r = {"losses": world["losses"], "auto_resume": resumes,
                 "base_save_s": [t for k, t in saves if k == "base"],
                 "delta_save_s": [t for k, t in saves if k == "delta"],
                 "restores": stat_delta(s0, s1, "ckpt.restore_s.count"),
                 "restore_s": stat_delta(s0, s1, "ckpt.restore_s.sum"),
                 "generations_kept": gens, "ckpt_bytes": dir_bytes(root),
                 "table_rows": len(world["table"][0]),
                 "launches": launches[case]}
            if engine.cache is not None:
                r["cache_hits"] = stat_delta(s0, s1, "ps.cache.hits")
                r["cache_invalidations"] = stat_delta(
                    s0, s1, "ps.cache.invalidations")
                if r["cache_invalidations"] < 2 or r["cache_hits"] <= 0:
                    raise AssertionError(
                        f"{what}: {int(r['cache_hits'])} cache hits, "
                        f"{int(r['cache_invalidations'])} invalidations")
            if base is None:
                base = world
                # a base generation of the whole table after the day, the
                # size a day change writes, timed and restored once
                full = TrainCheckpoint(os.path.join(work, "full"))
                t0 = time.perf_counter()
                full.save(engine, trainer)
                r["full_base_save_s"] = time.perf_counter() - t0
                r["full_base_bytes"] = dir_bytes(full.root)
                e2, t2 = day_trainer(device, "auto")
                t0 = time.perf_counter()
                full.resume(e2, t2)
                r["full_base_restore_s"] = time.perf_counter() - t0
                same_world(f"{what} full base restore",
                           world, world_of(e2, t2, world["losses"]))
                del e2, t2
            else:
                same_world(f"{what} vs fault-free", base, world)
            out[case] = r
            log(f"{what}: losses {world['losses']}, auto_resume "
                f"{int(resumes)}, ckpt save s base {r['base_save_s']} delta "
                f"{r['delta_save_s']}, restore {r['restore_s']:.3f} s over "
                f"{int(r['restores'])} restores, generations kept {gens} "
                f"({r['ckpt_bytes'] / 2**20:.1f} MiB), launches "
                f"{launches[case]}"
                + ("" if point is None else "; = fault-free bitwise")
                + (f"; cache hits {int(r['cache_hits'])}, invalidations "
                   f"{int(r['cache_invalidations'])}"
                   if "cache_hits" in r else "")
                + (f"; full-table base ({r['table_rows']} rows) save "
                   f"{r['full_base_save_s']:.2f} s, "
                   f"{r['full_base_bytes'] / 2**20:.1f} MiB, restore "
                   f"{r['full_base_restore_s']:.2f} s"
                   if "full_base_save_s" in r else ""))
            shutil.rmtree(root, ignore_errors=True)
        return launches, out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: the page-view feed, RankAttentionCTR and the per-user metrics
# ---------------------------------------------------------------------------

RANK_WIDTHS = dict(att_out=32, max_rank=3, hidden=(128, 64))
N_USERS = 4096                       # slot s0's first feasign: the user id
# the autograd nodes of rank_attention's backward, as the profiler names
# them (the MLP's are AddmmBackward0): its row-gather, one-hot product and
# GEMM
RANK_BACKWARD = tuple(f"autograd::engine::evaluate_function: {n}"
                      for n in ("IndexBackward0", "BmmBackward0",
                                "MmBackward0"))


def rank_feed_config() -> DataFeedConfig:
    return DataFeedConfig(slots=feed_config().slots, rank_offset=True,
                          ads_offset=True, max_rank=3, uid_slot="s0")


def pv_sizes(rng, total: int) -> np.ndarray:
    """Page-view sizes 1..4 summing to ``total``, the first of size 4."""
    draws = rng.integers(1, 5, total)
    csum = 4 + np.cumsum(draws)
    k = int(np.searchsorted(csum, total))
    return np.concatenate([[4], draws[:k], [total - csum[k - 1]]])


def rank_block(rng, n_batches: int = N_BATCHES) -> SlotRecordBlock:
    """``n_batches`` groups of page views, group k holding BATCH - k records
    (so batches 2-4 are short and padded), each group's search ids above
    the last group's, every group opening with a 4-record pv: after
    preprocess_instance the pv-aligned cuts are exactly the groups.
    cmatch from {222, 223, 224}, rank 0..3, and slot s0's first feasign
    one of N_USERS user ids."""
    groups = [pv_sizes(rng, BATCH - k) for k in range(n_batches)]
    n = sum(int(g.sum()) for g in groups)
    blk = make_block(rng, n)
    vals, offs = blk.uint64_slots["s0"]
    vals[offs[:-1]] = rng.integers(1, N_USERS + 1, n).astype(np.uint64)
    blk.search_ids = np.concatenate([
        np.repeat((k * 10**6 + rng.choice(10**6, len(g), replace=False))
                  .astype(np.uint64), g) for k, g in enumerate(groups)])
    blk.cmatch = rng.choice([222, 223, 224], n).astype(np.int32)
    blk.rank = rng.integers(0, 4, n).astype(np.int32)
    return blk


def rank_trainer(block: SlotRecordBlock, device: str, params=None,
                 path: str = "auto", mesh: dict = None, devices=None):
    """Engine lifecycle over ``block``'s keys and a RankAttentionCTR
    trainer (auto → mxu) on a pv-grouped dataset of it; ``mesh`` /
    ``devices`` as :func:`make_trainer`'s."""
    from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR
    cfg = rank_feed_config()
    dataset = SlotDataset(cfg)
    dataset._blocks = [block]
    dataset.preprocess_instance()
    topo = {}
    if mesh is not None:
        topo["topology"] = models_topology(mesh, device, devices)
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0,
        device=device, **topo)
    engine.begin_feed_pass()
    engine.add_keys(block.all_keys())
    engine.end_feed_pass()
    engine.begin_pass()
    trainer = SparseTrainer(
        engine, RankAttentionCTR(N_SLOTS, 3 + MF_DIM, DENSE_DIM,
                                 **RANK_WIDTHS),
        cfg, batch_size=BATCH, seed=0, device=device, sparse_path=path,
        **topo)
    if params is not None:
        trainer.model.load_jax_params(params)
    return engine, trainer, dataset, trainer.model.jax_params()


def rank_run(block: SlotRecordBlock, device: str, params=None,
             packed: bool = False, around_train=contextlib.nullcontext):
    """One pass of the rank model on the streaming or (packed) the
    pass-resident entry point.  Returns (stats, initial params, extra):
    extra holds each step's preds, the trained working set and dense
    weights, and for a packed pass its host arrays, its feed and the
    build and plane-build seconds."""
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot
    engine, trainer, dataset, params0 = rank_trainer(block, device, params)
    extra = {"preds": []}
    core = trainer._core

    def spy(*args, **kw):
        loss, preds = core(*args, **kw)
        extra["preds"].append(preds.detach().clone())
        return loss, preds
    trainer._core = spy
    key = "data.pass_feed.plane_build_s.sum"
    if packed:
        before = stat_snapshot("data.pass_feed").get(key, 0.0)
        t0 = time.perf_counter()
        arrays = trainer.pack_pass_host(dataset)
        feed = trainer.finish_pass_feed(arrays)
        if device == "cuda":
            torch.cuda.synchronize()
        extra.update(build_pass_feed_s=time.perf_counter() - t0,
                     plane_build_s=stat_snapshot("data.pass_feed").get(
                         key, 0.0) - before,
                     arrays=arrays, feed=feed)
        with around_train():
            stats = trainer.train_pass(feed)
    else:
        with around_train():
            stats = trainer.train_pass(dataset, pack_threads=4)
    extra["ws"] = {k: v.clone() for k, v in engine.ws.items()}
    extra["dense"] = {k: v.clone()
                      for k, v in trainer.model.state_dict().items()}
    extra["auc_table_size"] = trainer.auc_table_size
    engine.end_pass()
    return stats, params0, extra


def rank_attention_profile(prof, n_steps: int) -> float:
    """Device ms per step of rank_attention in a traced pass: its forward
    (a ``rank_attention`` record_function) and its three backward nodes."""
    keys = ("rank_attention",) + RANK_BACKWARD
    cpu = torch.autograd.DeviceType.CPU
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key in keys and e.device_type == cpu) / 1e3 / n_steps


@contextlib.contextmanager
def rank_annotated(holder: dict):
    """Trace CPU and CUDA with rank_attention's forward annotated (its
    backward nodes carry their own names)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddlebox_tpu_torch.models import rank_ctr
    plain = rank_ctr.rank_attention

    def annotated(*args, **kw):
        with record_function("rank_attention"):
            return plain(*args, **kw)
    rank_ctr.rank_attention = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            holder["prof"] = prof
            yield prof
    finally:
        rank_ctr.rank_attention = plain


def rank_attention_time(feed, dev: torch.device, seed: int = 0) -> float:
    """rank_attention forward + backward alone, at the step's shapes, on
    batch 0's rank_offset plane (device ms, time_ms)."""
    from paddlebox_tpu_torch.ops.rank_attention import rank_attention
    gen = torch.Generator(device=dev).manual_seed(seed)
    in_col = N_SLOTS * (3 + MF_DIM)
    x = torch.randn((BATCH, in_col), generator=gen, device=dev,
                    requires_grad=True)
    param = torch.randn((9 * in_col, RANK_WIDTHS["att_out"]), generator=gen,
                        device=dev, requires_grad=True)
    g = torch.randn((BATCH, RANK_WIDTHS["att_out"]), generator=gen,
                    device=dev)
    ro = feed.data["rank_offset"][0]

    def step():
        out, _ = rank_attention(x, ro, param, 3)
        out.backward(g)
    return time_ms("rank_attention fwd+bwd", step)


def rank_metrics(extra: dict, stats: dict, block_sorted: SlotRecordBlock):
    """Fleet.metrics fed the packed pass's preds, batch by batch, through
    MetricGroup.update: an auc metric (must equal the trainer's auc within
    1e-6), a cmatch_rank_group="222:1,223:2" metric and a wuauc metric
    (must equal the trainer's wuauc within 1e-9)."""
    from paddlebox_tpu_torch import fleet
    group = fleet.init().metrics
    group.init_metric("rank_auc", table_size=extra["auc_table_size"])
    group.init_metric("rank_cr", table_size=extra["auc_table_size"],
                      cmatch_rank_group="222:1,223:2")
    group.init_metric("rank_wuauc", metric_type="wuauc")
    h = extra["arrays"]
    nb = h.n_batches * h.batch_size
    cmatch = np.zeros((nb,), np.int32)
    rank = np.zeros((nb,), np.int32)
    for i in range(h.n_batches):
        lo, cnt, base = (i * h.batch_size, int(h.batch_real[i]),
                         int(h.batch_base[i]))
        cmatch[lo:lo + cnt] = block_sorted.cmatch[base:base + cnt]
        rank[lo:lo + cnt] = block_sorted.rank[base:base + cnt]
    for i, preds in enumerate(extra["preds"]):
        sl = slice(i * h.batch_size, (i + 1) * h.batch_size)
        p = preds.cpu().numpy()
        for name in ("rank_auc", "rank_cr", "rank_wuauc"):
            group.update(name, p, h.labels[sl], mask=h.valid[sl],
                         cmatch=cmatch[sl], rank=rank[sl], uid=h.uid[sl])
    msg = {n: group.get_metric_msg(n)
           for n in ("rank_auc", "rank_cr", "rank_wuauc")}
    if abs(msg["rank_auc"]["auc"] - stats["auc"]) > 1e-6:
        raise AssertionError(f"rank: Fleet.metrics auc "
                             f"{msg['rank_auc']['auc']} vs the trainer's "
                             f"{stats['auc']}")
    if abs(msg["rank_wuauc"]["wuauc"] - stats["wuauc"]) > 1e-9:
        raise AssertionError(f"rank: Fleet.metrics wuauc "
                             f"{msg['rank_wuauc']['wuauc']} vs the "
                             f"trainer's {stats['wuauc']}")
    want = int((h.valid & (((cmatch == 222) & (rank == 1))
                           | ((cmatch == 223) & (rank == 2)))).sum())
    if msg["rank_cr"]["size"] != want:
        raise AssertionError(f"rank: the cmatch_rank metric counted "
                             f"{msg['rank_cr']['size']} records, not {want}")
    return msg


def rank_phase(seed: int = 13):
    """RankAttentionCTR on the pv feed, streaming and packed on mxu (see
    the module docstring, phase 12)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    block = rank_block(rng)
    launches, out, runs = {}, {}, {}
    per_batch = {"gather_sorted": 1, "scatter_add_sorted": 1,
                 "gather_pool": 0}
    params0 = None
    for mode in ("streaming", "packed"):
        reset_counts()
        t0 = time.perf_counter()
        stats, p0, extra = rank_run(block, "cuda", params0,
                                    packed=mode == "packed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = read_counts()
        params0 = params0 or p0
        check_pass(f"rank[{mode}]", stats, launches[mode], per_batch,
                   exact=True)
        if not stats["wuauc_users"] > 0:
            raise AssertionError(f"rank[{mode}]: no user with both classes")
        runs[mode] = (stats, extra)
        steady = float(np.median(stats["step_ms"][1:]))
        out[mode] = {"losses": stats["losses"], "auc": stats["auc"],
                     "uauc": stats["uauc"], "wuauc": stats["wuauc"],
                     "wuauc_users": stats["wuauc_users"],
                     "wuauc_s": stats["wuauc_s"],
                     "step_ms": stats["step_ms"], "steady_step_ms": steady,
                     "pass_wall_s": wall, "launches": launches[mode]}
        if mode == "packed":
            out[mode].update(build_pass_feed_s=extra["build_pass_feed_s"],
                             plane_build_s=extra["plane_build_s"])
        log(f"rank[{mode}]: losses {stats['losses']}, auc {stats['auc']}, "
            f"uauc {stats['uauc']}, wuauc {stats['wuauc']} over "
            f"{stats['wuauc_users']:.0f} users, launches {launches[mode]}, "
            f"step device ms {stats['step_ms']} (steady median "
            f"{steady:.3f}), WuAUC host {stats['wuauc_s']:.3f} s a pass, "
            f"pass wall {wall:.2f} s"
            + (f", build_pass_feed {extra['build_pass_feed_s']:.2f} s, "
               f"plane_build {extra['plane_build_s']:.4f} s"
               if mode == "packed" else ""))
    (s_stats, _), (p_stats, p_extra) = runs["streaming"], runs["packed"]
    # the first step on the CPU, from the same weights and batch
    pv = SlotDataset(rank_feed_config())
    pv._blocks = [block]
    pv.preprocess_instance()
    lo, hi = pv.batch_bounds(BATCH)[0]
    first = pv.get_blocks()[0].slice(lo, hi)
    cpu_stats, _, _ = rank_run(first, "cpu", params0)
    cpu_loss = cpu_stats["losses"][0]
    for mode, (stats, _) in runs.items():
        if not math.isclose(stats["losses"][0], cpu_loss, rel_tol=1e-4):
            raise AssertionError(f"rank[{mode}]: first-step loss card "
                                 f"{stats['losses'][0]} vs CPU {cpu_loss}")
    for a, b in zip(s_stats["losses"], p_stats["losses"]):
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"rank: streaming losses "
                                 f"{s_stats['losses']} vs packed "
                                 f"{p_stats['losses']}")
    # users with both classes, counted from the data
    vals, offs = block.uint64_slots["s0"]
    _, user = np.unique(vals[offs[:-1]], return_inverse=True)
    pos = np.bincount(user, weights=block.float_slots["label"][0])
    both = int(((pos > 0) & (pos < np.bincount(user))).sum())
    if not s_stats["wuauc_users"] == p_stats["wuauc_users"] == both:
        raise AssertionError(f"rank: wuauc users streaming "
                             f"{s_stats['wuauc_users']} vs packed "
                             f"{p_stats['wuauc_users']}, {both} in the data")
    # the packed feed's pv planes on the card = the host planes
    h, feed = p_extra["arrays"], p_extra["feed"]
    n, b = h.n_batches, h.batch_size
    planes = {"rank_offset": h.rank_offset.reshape(n, b, -1),
              "ads_offset": h.ads_offset}
    for k, want in planes.items():
        if not np.array_equal(feed.data[k].cpu().numpy(), want):
            raise AssertionError(f"rank: the card's {k} plane differs from "
                                 "the host's")
    if not (h.rank_offset[:, 0] > 0).any() or h.batch_real.min() == b:
        raise AssertionError("rank: no ranked record or no short batch")
    # a packed rerun from the same state, traced: the same bits
    holder = {}
    again, _, a_extra = rank_run(block, "cuda", params0, packed=True,
                                 around_train=lambda: rank_annotated(holder))
    if again["losses"] != p_stats["losses"]:
        raise AssertionError(f"rank: packed rerun losses {again['losses']} "
                             f"!= {p_stats['losses']}")
    for what in ("ws", "dense"):
        diff = [k for k in p_extra[what]
                if not torch.equal(p_extra[what][k], a_extra[what][k])]
        if diff:
            raise AssertionError(f"rank: the packed rerun left different "
                                 f"{what} fields {diff}")
    prof = profiled("rank[packed]", holder["prof"], again)
    prof["rank_attention_ms_per_step"] = rank_attention_profile(
        holder["prof"], len(again["step_ms"]))
    alone = rank_attention_time(feed, dev)
    msg = rank_metrics(p_extra, p_stats, pv.get_blocks()[0])
    log(f"rank: first-step loss CPU {cpu_loss!r} (rtol 1e-4 of both); "
        "streaming = packed within rtol 1e-4; the packed rerun is "
        f"bit-identical; device planes = host planes; rank_attention "
        f"device ms per step {prof['rank_attention_ms_per_step']:.4f} in the "
        f"traced step, {alone:.4f} fwd+bwd alone; GEMMs "
        f"{prof['gemm_ms_per_step']:.4f}; Fleet.metrics auc "
        f"{msg['rank_auc']['auc']!r} (= the trainer's within 1e-6), "
        f"cmatch_rank 222:1,223:2 auc {msg['rank_cr']['auc']!r} over "
        f"{msg['rank_cr']['size']:.0f}, wuauc {msg['rank_wuauc']['wuauc']!r}")
    out.update(cpu_first_loss=cpu_loss, deterministic=True, profile=prof,
               rank_attention_alone_ms=alone,
               fleet_metrics={k: {kk: vv for kk, vv in v.items()}
                              for k, v in msg.items()})
    return launches, out


# ---------------------------------------------------------------------------
# phase 13: the rest of the one-card trainer options
# ---------------------------------------------------------------------------

OPTIONS_KERNELS = {"gather_sorted": 1, "scatter_add_sorted": 1,
                   "gather_pool": 0}


@contextlib.contextmanager
def kernel_widths(seen: dict):
    """Record the width W (rows of the feature-major operand) of each
    sorted-SpMM wrapper call on the card, by name.  A wrapper counts its
    launches on the module-level name it is bound to, so the recording
    stand-in carries the count while it is bound and hands it back to
    the wrapper after."""
    plain = {n: getattr(sp, n) for n in ("gather_sorted",
                                         "scatter_add_sorted")}

    def wrap(name, fn):
        def call(x, *args, **kw):
            if x.is_cuda:
                seen.setdefault(name, []).append(int(x.shape[0]))
            return fn(x, *args, **kw)
        call.launches = fn.launches
        return call
    stand_ins = {n: wrap(n, fn) for n, fn in plain.items()}
    for n, fn in stand_ins.items():
        setattr(sp, n, fn)
    try:
        yield seen
    finally:
        for n, fn in plain.items():
            fn.launches = stand_ins[n].launches
            setattr(sp, n, fn)


def options_expand(block: SlotRecordBlock):
    """(a) CtrDnn over an expand table, streaming and packed on auto:
    both sorted-SpMM kernels once a batch at W = 20, gather_pool never;
    the first step = the CPU's; mf_ex trained; a packed rerun (traced)
    gives the same bits."""
    launches, out, params0 = {}, {}, None
    runs = {}
    for mode in ("streaming", "packed"):
        seen, hold = {}, {}
        reset_counts()
        with kernel_widths(seen):
            stats, p0, _ = run_pass(block, "cuda", params0, path="auto",
                                    packed=mode == "packed", keep_ws=True,
                                    hold=hold, model="ctr_dnn_ex")
        torch.cuda.synchronize()
        what = f"options[expand,{mode}]"
        launches[mode] = read_counts()
        params0 = params0 or p0
        check_pass(what, stats, launches[mode], OPTIONS_KERNELS, exact=True)
        for name in ("gather_sorted", "scatter_add_sorted"):
            if seen.get(name) != [W_EX] * N_BATCHES:
                raise AssertionError(f"{what}: {name} ran at widths "
                                     f"{seen.get(name)}, not {W_EX}")
        if stats["path"] != "mxu":
            raise AssertionError(f"{what}: auto did not resolve to mxu")
        if torch.equal(hold["ws0"]["mf_ex"], stats["ws"]["mf_ex"]):
            raise AssertionError(f"{what}: mf_ex did not train")
        cpu_first_loss(what, block, stats["losses"][0], params0,
                       path="auto", model="ctr_dnn_ex")
        runs[mode] = stats
        steady = float(np.median(stats["step_ms"][1:]))
        out[mode] = {"losses": stats["losses"], "auc": stats["auc"],
                     "step_ms": stats["step_ms"], "steady_step_ms": steady,
                     "launches": launches[mode], "widths": seen}
        log(f"{what}: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[mode]} at W {W_EX}, step device ms "
            f"{stats['step_ms']} (steady median {steady:.3f}); mf_ex moved")
    holder = {}
    again, _, _ = run_pass(block, "cuda", params0, path="auto", packed=True,
                           keep_ws=True, model="ctr_dnn_ex",
                           around_train=tracer(holder))
    same_bits("options[expand,packed]", runs["packed"], again)
    out["profile"] = profiled("options[expand,packed]", holder["prof"],
                              again)
    log("options[expand]: the packed rerun is bit-identical; kernel device "
        "ms per step " + json.dumps(out["profile"]["kernel_ms_per_step"]))
    return launches, out


def options_async(block: SlotRecordBlock):
    """(b) DeepFM on packed mxu with the async dense table (sync every
    batch) beside the same pass with synchronous Adam."""
    from paddlebox_tpu_torch.config import TrainerConfig
    import threading
    launches, out = {}, {}
    calls = []
    plain_step = SparseTrainer._async_dense_step

    def recorded(self, *args, **kw):
        calls.append(threading.current_thread())
        return plain_step(self, *args, **kw)
    params0 = None
    for mode in ("sync", "async"):
        hold = {}
        tc = TrainerConfig(dense_sync_mode="async_table",
                           sync_weight_step=1) if mode == "async" else None
        reset_counts()
        SparseTrainer._async_dense_step = recorded
        try:
            stats, p0, _ = run_pass(block, "cuda", params0, path="mxu",
                                    packed=True, hold=hold,
                                    trainer_config=tc)
        finally:
            SparseTrainer._async_dense_step = plain_step
        torch.cuda.synchronize()
        params0 = params0 or p0
        what = f"options[async,{mode}]"
        launches[mode] = read_counts()
        check_pass(what, stats, launches[mode], OPTIONS_KERNELS, exact=True)
        steady = float(np.median(stats["step_ms"][1:]))
        out[mode] = {"losses": stats["losses"], "step_ms": stats["step_ms"],
                     "steady_step_ms": steady}
        if mode == "async":
            tr = hold["trainer"]
            table = tr.async_dense
            if not table.pushed == table.applied == N_BATCHES:
                raise AssertionError(f"{what}: pushed {table.pushed}, "
                                     f"applied {table.applied}")
            final = table.pull()
            for n, p in tr.model.named_parameters():
                if not np.array_equal(p.detach().cpu().numpy(), final[n]):
                    raise AssertionError(f"{what}: param {n} != pull()")
            if tr.dense_opt.state_dict()["state"]:
                raise AssertionError(f"{what}: dense_opt stepped")
            main = threading.main_thread()
            if len(calls) != N_BATCHES or any(t is not main for t in calls):
                raise AssertionError(f"{what}: the grads' copies ran on "
                                     f"{[t.name for t in calls]}")
            if table.thread is main or not table.thread.is_alive():
                raise AssertionError(f"{what}: no live update thread")
            copy_ms = 1e3 * stats["dense_copy_s"] / N_BATCHES
            out[mode].update(dense_copy_ms_per_step=copy_ms,
                             pushed=table.pushed, applied=table.applied)
            log(f"{what}: losses {stats['losses']} (synchronous Adam "
                f"{out['sync']['losses']}), steady step "
                f"{steady:.3f} ms vs synchronous Adam "
                f"{out['sync']['steady_step_ms']:.3f} ms; grads' copy "
                f"{copy_ms:.3f} ms a step; pushed = applied = "
                f"{table.pushed}; final params = pull(); the copies ran "
                "on the main thread, the table's updates on "
                f"{table.thread.name!r} (numpy only)")
    return launches, out


def options_dump(seed: int = 15):
    """(c) a packed pass with dump_path into a temporary directory, over
    records that carry ins_ids: one line per real record, the step's
    preds to 6 decimals."""
    from paddlebox_tpu_torch.config import TrainerConfig
    rng = np.random.default_rng(seed)
    n = N_BATCHES * BATCH - 1000           # the last batch is short
    block = make_block(rng, n)
    block.ins_ids = [f"ins{i:06d}" for i in range(n)]
    tmp = tempfile.mkdtemp(prefix="pbox_dump_")
    try:
        engine, trainer, dataset, _ = make_trainer(
            block, "cuda", trainer_config=TrainerConfig(dump_path=tmp))
        preds = []
        core = trainer._core

        def spy(*args, **kw):
            loss, p = core(*args, **kw)
            preds.append(p.detach().clone())
            return loss, p
        trainer._core = spy
        reset_counts()
        feed = trainer.build_pass_feed(dataset)
        stats = trainer.train_pass(feed)
        launches = read_counts()
        check_pass("options[dump]", stats, launches, OPTIONS_KERNELS,
                   exact=True)
        path = os.path.join(tmp, f"dump-pass-{engine.pass_id}.txt")
        with open(path) as f:
            lines = [ln.rstrip("\n").split("\t") for ln in f]
        engine.end_pass()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(lines) != n:
        raise AssertionError(f"options[dump]: {len(lines)} lines for {n} "
                             "records")
    if [ln[0] for ln in lines] != block.ins_ids:
        raise AssertionError("options[dump]: ids out of order")
    want = torch.cat(preds).cpu().numpy()[:n]
    if [ln[2] for ln in lines] != [f"{p:.6f}" for p in want]:
        raise AssertionError("options[dump]: preds differ from the pass's")
    labels = block.float_slots["label"][0]
    if [ln[1] for ln in lines] != [f"{x:g}" for x in labels]:
        raise AssertionError("options[dump]: labels differ")
    log(f"options[dump]: {len(lines)} lines (one per real record of a "
        f"{N_BATCHES}-batch pass, the last batch short), preds = the "
        f"pass's to 6 decimals; dump host {stats['dump_s']:.4f} s a pass")
    return launches, {"lines": len(lines), "dump_s": stats["dump_s"],
                      "losses": stats["losses"]}


def seqpool_variants_phase(dev: torch.device, seed: int = 16):
    """(d) the five fused_seqpool_cvm variants forward + backward at
    [26, 16384, 3, E] on the card against the CPU (rtol 1e-5, atol
    1e-6), with device ms each (time_ms of forward + backward)."""
    from paddlebox_tpu_torch.ops import seqpool_cvm_variants as sv
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, CAP + 1, (N_SLOTS, BATCH)).astype(np.int32)

    def ins(w):
        return rng.uniform(0, 2, (BATCH, w)).astype(np.float32)
    thresholds = rng.uniform(0, 1.5, N_SLOTS).astype(np.float32)
    cases = {   # name: (fn, E, [per-instance inputs], attributes(device))
        "tradew": (sv.fused_seqpool_cvm_tradew, 2 + 3 + MF_DIM, [ins(2)],
                   lambda d: (True, 0.0, 2, 1, 3)),
        "with_conv": (sv.fused_seqpool_cvm_with_conv, 3 + MF_DIM, [ins(3)],
                      lambda d: (True, 0.0, True, 0.2, 1.0, 0.96, False, 1)),
        "with_credit": (sv.fused_seqpool_cvm_with_credit, 4 + MF_DIM,
                        [ins(4)], lambda d: (True, 0.0, False)),
        # the per-slot thresholds lie on the device (no upload a call)
        "with_diff_thres": (sv.fused_seqpool_cvm_with_diff_thres,
                            2 + MF_DIM, [ins(2)],
                            lambda d: (True, 0.0, True, 0.2, 1.0, 0.96,
                                       torch.as_tensor(thresholds, device=d),
                                       0, False, True)),
        "with_pcoc": (sv.fused_seqpool_cvm_with_pcoc, 7 + MF_DIM,
                      [ins(7), ins(3)],
                      lambda d: (True, 0.0, False, 0.2, 1.0, 0.96, 7, 7, 0)),
    }
    out = {}
    for name, (fn, e, extra, attrs) in cases.items():
        emb = rng.uniform(0, 2, (N_SLOTS, BATCH, CAP, e)).astype(np.float32)
        runs = {}
        for where in ("cpu", dev):
            x = torch.tensor(emb, device=where, requires_grad=True)
            args = [torch.as_tensor(lengths, device=where)] + [
                torch.as_tensor(a, device=where) for a in extra]
            kw = attrs(where)
            y = fn(x, *args, *kw)
            dy = torch.ones_like(y)
            (g,) = torch.autograd.grad(y, x, dy)
            runs[str(where)] = (y.detach().cpu().numpy(), g.cpu().numpy(),
                                (x, args + list(kw), dy))
        for k, label in ((0, "forward"), (1, "backward")):
            got, want = runs[str(dev)][k], runs["cpu"][k]
            if got.shape != want.shape or not np.allclose(
                    got, want, rtol=1e-5, atol=1e-6):
                raise AssertionError(
                    f"variants[{name}]: {label} on the card differs from the "
                    f"CPU by {float(np.abs(got - want).max())}")
        x, args, dy = runs[str(dev)][2]

        def fwd_bwd():
            return torch.autograd.grad(fn(x, *args), x, dy)
        ms = time_ms(f"variants[{name}]", fwd_bwd)
        out[name] = {"e": e, "ms": ms,
                     "out_shape": list(runs[str(dev)][0].shape)}
        log(f"variants[{name}]: [{N_SLOTS}, {BATCH}, {CAP}, {e}] forward + "
            f"backward {ms:.4f} ms on the card, = the CPU (rtol 1e-5)")
    return out


def alias_phase(dev: torch.device, seed: int = 17,
                n_draws: int = 1_000_000) -> dict:
    """(e) alias_sample of 10^6 draws on the card from a seeded card
    generator: chi-square against the table's probabilities."""
    from scipy import stats as sstats
    from paddlebox_tpu_torch.ops import alias_method as am
    probs = 1.0 / np.arange(1, 1001) ** 1.1       # a Zipf-like negatives
    p = probs / probs.sum()
    accept, alias = am.build_alias_table(probs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a, l = torch.as_tensor(accept, device=dev), torch.as_tensor(alias,
                                                                device=dev)
    draws = am.alias_sample(gen, a, l, (n_draws,))
    if draws.device.type != dev.type or draws.dtype != torch.int32:
        raise AssertionError("alias: the draws are not int32 on the card")
    counts = np.bincount(draws.cpu().numpy(), minlength=len(p))
    chi2, pval = sstats.chisquare(counts, n_draws * p)
    if not pval > 1e-3:
        raise AssertionError(f"alias: chi-square p {pval} over {n_draws} "
                             "draws")
    ms = time_ms("alias_sample", lambda: am.alias_sample(gen, a, l,
                                                         (n_draws,)))
    log(f"alias: {n_draws} draws over {len(p)} outcomes on the card, "
        f"chi-square {chi2:.1f}, p {pval:.4f}; {ms:.4f} ms a call")
    return {"draws": n_draws, "chi2": float(chi2), "p": float(pval),
            "ms": ms}


def options_phase(seed: int = 14, device: str = "cuda"):
    """Phase 13 (see the module docstring)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    block = make_block(rng, N_BATCHES * BATCH)
    ex_launches, ex_out = options_expand(block)
    as_launches, as_out = options_async(block)
    dump_launches, dump_out = options_dump()
    launches = {**{f"expand_{m}": n for m, n in ex_launches.items()},
                **{f"async_{m}": n for m, n in as_launches.items()},
                "dump": dump_launches}
    return launches, {"expand": ex_out, "async": as_out, "dump": dump_out,
                      "variants": seqpool_variants_phase(dev),
                      "alias": alias_phase(dev)}


# ---------------------------------------------------------------------------
# phase 14: the PS service tier under the day loop
# ---------------------------------------------------------------------------

CLUSTER_PASSES = 2                 # passes per day of LIFE_DATES
CLUSTER_WIDE = 4
MICROBENCH_KEYS = 524_288          # the ps_streams 1 vs 4 pull
# (label, PS shards, prefetch, device-cache rows, chaos)
CLUSTER_RUNS = (("a", 1, False, 0, False),
                ("b", CLUSTER_WIDE, False, 0, False),
                ("c", CLUSTER_WIDE, True, 0, False),
                ("d", CLUSTER_WIDE, False, CACHE_ROWS, False),
                ("e", CLUSTER_WIDE, False, 0, True))


def cluster_plan():
    """The chaos run's seeded faults: one server ack dropped (applied,
    unacknowledged: the retry resolves through the dedup window) and one
    shard killed mid push_sparse_delta (its supervisor restarts it on the
    same port with the dead instance's dedup window)."""
    from paddlebox_tpu_torch.ps import faults
    return (faults.FaultPlan(seed=17)
            .drop("send", role="server", at=(2,))
            .kill_server(cmd="push_sparse_delta", at=(5,)))


def fleet_world(tables, dense: dict, losses) -> dict:
    """``world_of`` over a PS fleet: the union of the shards' tables
    (every key, every field), which must hold no key on two shards, and
    ``dense`` (``dense_state``'s names)."""
    keys, rows = [], []
    for t in tables:
        k = np.sort(t.export_keys())
        keys.append(k)
        rows.append(t.bulk_pull(k))
    allk = np.concatenate(keys)
    if len(np.unique(allk)) != len(allk):
        raise AssertionError("a key is held by two PS shards")
    order = np.argsort(allk, kind="stable")
    table = (allk[order], {f: np.concatenate([r[f] for r in rows])[order]
                           for f in rows[0]})
    return {"losses": losses, "table": table, "dense": dense}


def cluster_run(files, n: int, prefetch: bool, cache_rows: int,
                chaos: bool, device: str = "cuda"):
    """``fleet.train_passes`` over ``files`` (one list of pass filelists
    per day of LIFE_DATES) with a delta-mode ``RemoteTableAdapter`` over
    an in-process ``PSFleet(n)`` on loopback as the engine's table.
    Returns the world it left, the engine's initial dense params, the
    parsed first pass's first block and the run's readings."""
    from paddlebox_tpu_torch import fleet
    from paddlebox_tpu_torch.launch import PSFleet
    from paddlebox_tpu_torch.ps import faults
    from paddlebox_tpu_torch.ps.service import PSClient, RemoteTableAdapter
    from paddlebox_tpu_torch.utils import flight
    from paddlebox_tpu_torch.utils.monitor import (StatRegistry,
                                                   stat_snapshot)
    flt = PSFleet(n, config=EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0,
        max_restarts=16)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=300)
    try:
        with engine_flags(cache_rows):
            engine, trainer = day_trainer(device, "auto")
        engine.table = RemoteTableAdapter(client, delta_mode=True)
        params0 = trainer.model.jax_params()
        ds = fleet.BoxPSDataset(feed_config(), engine=engine,
                                read_threads=1)
        StatRegistry.instance().reset()     # per-run latency histograms
        m0 = time.monotonic()
        reset_counts()
        if chaos:
            flags.set_flags({"ps_fault_injection": True})
            faults.install(cluster_plan())
        metrics, day_s = [], []
        try:
            for date, day in zip(LIFE_DATES, files):
                t0 = time.perf_counter()
                metrics += fleet.train_passes(trainer, ds, day, date=date,
                                              prefetch=prefetch)
                day_s.append(time.perf_counter() - t0)
        finally:
            faults.uninstall()
            flags.set_flags({"ps_fault_injection": False})
        if device == "cuda":
            torch.cuda.synchronize()
        launches = read_counts()
        snap = stat_snapshot("")
        ends = sorted(e["mono"] for e in flight.events(kind="pass_end")
                      if e["mono"] >= m0)
        walls = [float(x) for x in np.diff([m0] + ends)]
        restarts = sorted((e["mono"], e["kind"]) for e in flight.events(
            kind="resume_begin,resume_ok")
            if e.get("role") == "ps_server" and e["mono"] >= m0)
        restart_s = [b[0] - a[0] for a, b in zip(restarts, restarts[1:])
                     if a[1] == "resume_begin" and b[1] == "resume_ok"]
        n_pass = len(metrics)
        wire = sum(v for k, v in snap.items()
                   if k.startswith("ps.wire.") and k.endswith(".tx_bytes"))
        hits = snap.get("ps.cache.hits", 0.0)
        miss = snap.get("ps.cache.misses", 0.0)
        timers = {name: (secs, c) for name, secs, c in engine.timers.rows()}
        r = {"shards": n, "prefetch": prefetch, "cache_rows": cache_rows,
             "chaos": chaos, "passes": n_pass, "day_s": day_s,
             "pass_wall_s": walls,
             "median_pass_wall_s": float(np.median(walls)),
             "pull_sparse_p50_s": snap.get(
                 "ps.client.pull_sparse.latency_s.p50"),
             "push_sparse_delta_p50_s": snap.get(
                 "ps.client.push_sparse_delta.latency_s.p50"),
             "wire_bytes_per_pass": wire / max(n_pass, 1),
             "end_day_s": timers.get("end_day", (0.0, 0))[0],
             "supervisor_restarts": snap.get("ps.supervisor.restarts", 0.0),
             "restart_s": restart_s,
             "dedup_hits": snap.get("ps.server.dedup_hit", 0.0),
             "client_retries": snap.get("ps.client.retry", 0.0),
             "launches": launches}
        if cache_rows:
            r["cache_hits"] = hits
            r["cache_hit_rate"] = hits / max(hits + miss, 1.0)
        losses = [m["losses"] for m in metrics]
        world = fleet_world([s.table for s in flt.sups],
                            dense_state(trainer), losses)
        return world, params0, r
    finally:
        client.close()
        stop_fleet(flt)


def wire_microbench(keys: np.ndarray) -> dict:
    """Loopback MB/s of the wire (a 16 MB f64 dense blob pushed and
    pulled, best of 3) and one multi-chunk pull of ``keys`` (4 MiB
    frames) through 1 stream / window 1 against 4 streams / window 8 on
    one server: the same rows either way."""
    from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
    from paddlebox_tpu_torch.ps.service import PSClient, PSServer
    srv = PSServer(ShardedHostTable(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0))
    try:
        client = PSClient(srv.addr)
        blob = np.random.default_rng(0).random(16 << 20 >> 3)
        client.push_dense("blob", blob)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            client.push_dense("blob", blob)
            back = client.pull_dense("blob")
            best = max(best, 2 * blob.nbytes / 1e6
                       / (time.perf_counter() - t0))
        if not np.array_equal(back, blob):
            raise AssertionError("cluster: the loopback blob came back "
                                 "changed")
        client.pull_sparse(keys, create=True)
        out, rows = {"loopback_MBps": best}, {}
        for streams, window in ((1, 1), (4, 8)):
            c = PSClient(srv.addr, max_frame=1 << 24, streams=streams,
                         window=window)
            c.pull_sparse(keys[:1024])          # learn the row width
            t0 = time.perf_counter()
            rows[streams] = c.pull_sparse(keys)
            out[f"pull_streams{streams}_s"] = time.perf_counter() - t0
            c.close()
        for f in rows[1]:
            if not np.array_equal(rows[1][f], rows[4][f]):
                raise AssertionError(f"cluster: the 4-stream pull's {f} "
                                     "differs from the 1-stream pull's")
        out["pull_keys"] = len(keys)
        out["streams4_speedup"] = out["pull_streams1_s"] / \
            out["pull_streams4_s"]
        client.close()
        return out
    finally:
        srv.shutdown()


def cluster_phase(seed: int = 18, device: str = "cuda",
                  local_pass_wall_s: float = None, paths=None):
    """Phase 14 (see the module docstring).  ``paths``: the pass files,
    CLUSTER_PASSES a day (written here when None)."""
    from paddlebox_tpu_torch.data.data_feed import DataFeed
    work = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        n_files = len(LIFE_DATES) * CLUSTER_PASSES
        if paths is None:
            paths = write_pass_files(work, seed, n_files)
        files = [[[p] for p in paths[d * CLUSTER_PASSES:
                                     (d + 1) * CLUSTER_PASSES]]
                 for d in range(len(LIFE_DATES))]
        first = SlotRecordBlock.concat(
            list(DataFeed(feed_config()).read_file(files[0][0][0])))
        n_batches = len(LIFE_DATES) * CLUSTER_PASSES * N_BATCHES
        launches, out, base = {}, {}, None
        for label, n, prefetch, cache_rows, chaos in CLUSTER_RUNS:
            what = (f"cluster[{label}: N={n},"
                    f"{'prefetch' if prefetch else 'serial'}"
                    + (f",cache={cache_rows}" if cache_rows else "")
                    + (",chaos" if chaos else "") + "]")
            world, params0, r = cluster_run(files, n, prefetch, cache_rows,
                                            chaos, device)
            launches[label] = r["launches"]
            for name in ("gather_sorted", "scatter_add_sorted"):
                if r["launches"][name] != n_batches:
                    raise AssertionError(
                        f"{what}: {name} launched {r['launches'][name]} "
                        f"times over {n_batches} batches (want 1 a batch)")
            if r["launches"]["gather_pool"]:
                raise AssertionError(f"{what}: gather_pool launched")
            flat = [x for p in world["losses"] for x in p]
            if len(flat) != n_batches or not all(map(math.isfinite, flat)):
                raise AssertionError(f"{what}: losses {world['losses']}")
            if base is None:
                base = world
                r["cpu_first_loss"] = cpu_first_loss(
                    "cluster", first, flat[0], params0)
                r["microbench"] = wire_microbench(
                    np.unique(first.all_keys())[:MICROBENCH_KEYS])
            else:
                same_world(f"{what} vs cluster[a]", base, world)
            if chaos and r["supervisor_restarts"] < 1:
                raise AssertionError(f"{what}: no shard was restarted")
            if cache_rows and r.get("cache_hits", 0) <= 0:
                raise AssertionError(f"{what}: the device cache never hit")
            del world
            out[label] = r
            log(f"{what}: median pass wall {r['median_pass_wall_s']:.3f} s "
                f"(passes {[round(x, 3) for x in r['pass_wall_s']]}), "
                f"pull_sparse p50 {r['pull_sparse_p50_s']} s, "
                f"push_sparse_delta p50 {r['push_sparse_delta_p50_s']} s, "
                f"wire {r['wire_bytes_per_pass'] / 2**20:.1f} MiB a pass, "
                f"end_day {r['end_day_s']:.3f} s, launches {r['launches']}"
                + ("" if label == "a" else "; = cluster[a] bitwise")
                + (f"; cache hit rate {r['cache_hit_rate']:.4f} "
                   f"({int(r['cache_hits'])} hits)" if cache_rows else "")
                + (f"; shard restarts {int(r['supervisor_restarts'])} in "
                   f"{[round(x, 3) for x in r['restart_s']]} s, dedup hits "
                   f"{int(r['dedup_hits'])}, client retries "
                   f"{int(r['client_retries'])}" if chaos else ""))
        mb = out["a"]["microbench"]
        log(f"cluster: loopback {mb['loopback_MBps']:.1f} MB/s; a pull of "
            f"{mb['pull_keys']} keys in 4 MiB frames: ps_streams 1 "
            f"{mb['pull_streams1_s']:.3f} s, 4 {mb['pull_streams4_s']:.3f} s "
            f"({mb['streams4_speedup']:.2f}×), the same rows")
        if local_pass_wall_s is not None:
            out["local_serial_mxu_pass_wall_s"] = local_pass_wall_s
            log(f"cluster: local-table serial mxu pass wall (phase 10, this "
                f"call, {LIFE_BATCHES} batches a pass) "
                f"{local_pass_wall_s:.3f} s against "
                f"{out['a']['median_pass_wall_s']:.3f} s through N=1 and "
                f"{out['b']['median_pass_wall_s']:.3f} s through N=4 "
                f"({N_BATCHES} batches a pass)")
        log(f"cluster: runs a-e bitwise equal (per-batch losses, dense "
            f"weights and Adam state, {len(base['table'][0])} table keys × "
            "every field over the union of the shards, no key on two)")
        return launches, out
    finally:
        shutil.rmtree(work, ignore_errors=True)


SERVE_TENANTS = ("ads", "feed")
SERVE_SAMPLES = 1024               # a query: samples × N_SLOTS × 1..CAP keys
SERVE_QUERIES = 8                  # distinct queries the clients cycle
SERVE_THREADS, SERVE_PER_THREAD = 8, 50
SERVE_UNSEEN = 0.1                 # share of a query's keys not in the dump
SERVE_PULL_KEYS = 65_536           # (b)'s pull_sparse
SERVE_SHARDS, SERVE_HOT_KEYS = 4, 4096
SERVE_POLL_S = 0.2                 # manifest and checkpoint watch cadence


def g6(a: np.ndarray) -> np.ndarray:
    """The dump's ``%.6g`` text round trip of float32 values, as a
    replica serving the dump reads them back."""
    a = np.asarray(a)
    flat = [float(f"{x:.6g}") for x in a.astype(np.float64).ravel()]
    return np.asarray(flat, np.float32).reshape(a.shape)


def digest(rows) -> str:
    """A short fingerprint of a pull answer (every field's bytes) or of
    a forward answer."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    if isinstance(rows, dict):
        for f in sorted(rows):
            h.update(f.encode())
            h.update(np.ascontiguousarray(rows[f]).tobytes())
    else:
        h.update(np.ascontiguousarray(rows).tobytes())
    return h.hexdigest()


def serve_config() -> EmbeddingTableConfig:
    """The table config of phase 15's trainer and of every serving
    engine and replica (the dump carries no schema: it must match)."""
    return EmbeddingTableConfig(embedding_dim=MF_DIM, shard_num=8,
                                sgd=SparseSGDConfig(mf_create_thresholds=0.0))


def serving_train_dump(files, work: str, device: str):
    """(a) A local engine trains LIFE_DATES × CLUSTER_PASSES passes on
    auto → mxu through ``fleet.train_passes``, a TrainCheckpoint saving
    every pass; each day ends with ``save_xbox``.  Day 1's dump is
    published at once and loaded by a ``mode="serving"`` engine, whose
    table must hold the trained day-1 rows as the dump's text carries
    them.  Returns the trainer side and the readings."""
    from paddlebox_tpu_torch import fleet
    from paddlebox_tpu_torch.io.checkpoint import (TrainCheckpoint,
                                                   load_xbox,
                                                   publish_xbox_manifest,
                                                   save_xbox)
    from paddlebox_tpu_torch.native import dump_writer
    if not dump_writer.available():
        raise AssertionError("serving[a]: the native xbox writer did not "
                             "build")
    engine = BoxPSEngine(serve_config(), seed=0, device=device)
    trainer = SparseTrainer(engine, make_model("deepfm"), feed_config(),
                            batch_size=BATCH, seed=0, sparse_path="auto",
                            device=device)
    ds = fleet.BoxPSDataset(feed_config(), engine=engine, read_threads=1)
    ck = TrainCheckpoint(os.path.join(work, "ckpt"))
    root = os.path.join(work, "xbox")
    out = {"days": []}
    reset_counts()
    dumps = []
    serve_eng = None
    for d, (date, day) in enumerate(zip(LIFE_DATES, files)):
        t0 = time.perf_counter()
        metrics = fleet.train_passes(trainer, ds, day, date=date,
                                     prefetch=False, checkpoint=ck,
                                     resume=0)
        train_s = time.perf_counter() - t0
        losses = [x for m in metrics for x in m["losses"]]
        if not losses or not all(map(math.isfinite, losses)):
            raise AssertionError(f"serving[a]: day {date} losses {losses}")
        path = os.path.join(root, f"xbox-{date}")
        t0 = time.perf_counter()
        rows = save_xbox(engine, path)
        dump_s = time.perf_counter() - t0
        dumps.append((path, date))
        day_out = {"date": date, "train_s": train_s, "dump_rows": rows,
                   "dump_MB": os.path.getsize(path) / 1e6,
                   "dump_s": dump_s, "table_rows": engine.table.size()}
        if d == 0:
            publish_xbox_manifest(root, path, generation=1, day=date)
            serve_eng = BoxPSEngine(serve_config(), seed=0, device=device,
                                    mode="serving")
            t0 = time.perf_counter()
            keys = load_xbox(serve_eng, path)
            day_out["load_s"] = time.perf_counter() - t0
            day_out["load_rows"] = len(keys)
            check_loaded(serve_eng, engine, keys)
        out["days"].append(day_out)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    n_batches = len(LIFE_DATES) * CLUSTER_PASSES * N_BATCHES
    for name in ("gather_sorted", "scatter_add_sorted"):
        if device == "cuda" and launches[name] != n_batches:
            raise AssertionError(f"serving[a]: {name} launched "
                                 f"{launches[name]} times over {n_batches} "
                                 "batches (want 1 a batch)")
    out["checkpoint_generations"] = ck.head()
    for day_out in out["days"]:
        log(f"serving[a]: day {day_out['date']} trained in "
            f"{day_out['train_s']:.2f} s; save_xbox (native writer) "
            f"{day_out['dump_rows']} of {day_out['table_rows']} table rows, "
            f"{day_out['dump_MB']:.1f} MB in {day_out['dump_s']:.3f} s"
            + (f"; load_xbox {day_out['load_rows']} rows in "
               f"{day_out['load_s']:.3f} s into a serving engine: its table "
               "= the trained rows through %.6g key for key"
               if "load_s" in day_out else ""))
    return {"engine": engine, "trainer": trainer, "ds": ds, "ck": ck,
            "root": root, "dumps": dumps, "serve_engine": serve_eng,
            "launches": launches, "out": out}


def check_loaded(serve_eng, engine, keys) -> None:
    """The serving engine's table holds the trained table's rows as the
    dump's ``%.6g`` text carries them: show / click / embed_w / mf (mf
    zero where uncreated) within the text's relative rounding for every
    key and exactly through ``g6`` for a sample, ``mf_size`` from any(mf
    != 0), the fields the dump does not carry zero."""
    keys = np.sort(keys)
    got = serve_eng.table.bulk_pull(keys)
    want = engine.table.bulk_pull(keys)
    want["mf"] = np.where((want["mf_size"] > 0)[:, None], want["mf"],
                          np.float32(0))
    for f in ("show", "click", "embed_w", "mf"):
        w = want[f].astype(np.float64)
        err = np.abs(got[f].astype(np.float64) - w)
        if not np.all(err <= 5.1e-6 * np.abs(w) + 1e-45):
            raise AssertionError(f"serving[a]: loaded {f} is off the "
                                 f"dump's %.6g text by {err.max()}")
    sample = np.random.default_rng(0).choice(len(keys), min(
        len(keys), SERVE_PULL_KEYS), replace=False)
    for f in ("show", "click", "embed_w", "mf"):
        if not np.array_equal(got[f][sample], g6(want[f][sample])):
            raise AssertionError(f"serving[a]: loaded {f} != g6(trained)")
    created = np.any(want["mf"] != 0, axis=1)
    if not np.array_equal(got["mf_size"], np.where(created, MF_DIM, 0)):
        raise AssertionError("serving[a]: loaded mf_size != any(mf != 0)")
    for f in ("embed_g2sum", "mf_g2sum", "delta_score"):
        if f in got and np.any(got[f]):
            raise AssertionError(f"serving[a]: loaded {f} is not zero")


def ws_bytes(ws: dict) -> int:
    return int(sum(t.numel() * t.element_size() for t in ws.values()))


def serving_freeze(serve_eng, block: SlotRecordBlock, device: str):
    """(b) The serving engine runs the pass lifecycle over one pass's
    keys and freezes the working set on the card; its pulls over the
    frozen set are held against the f32 set's and the CPU's."""
    from paddlebox_tpu_torch.data import pass_feed as pf
    from paddlebox_tpu_torch.ps import embedding, fast_path, mxu_path
    ds = one_pass_dataset(block)
    serve_eng.begin_feed_pass()
    serve_eng.add_keys(block.all_keys())
    serve_eng.end_feed_pass()
    serve_eng.begin_pass()
    trainer = SparseTrainer(serve_eng, make_model("deepfm"), feed_config(),
                            batch_size=BATCH, seed=0, sparse_path="mxu",
                            device=device)
    feed = trainer.build_pass_feed(ds)
    bt = pf.slice_batch(feed.data, 0)
    plan = pf.plan_tuple(pf.slice_batch(feed.plans, 0))
    s, l, b = bt["indices"].shape
    dims = mxu_path.make_dims(s * l * b, serve_eng.ws["show"].shape[0])
    rng = np.random.default_rng(0)
    pull_keys = rng.choice(serve_eng.mapper.sorted_keys, min(
        SERVE_PULL_KEYS, serve_eng.num_keys), replace=False)
    pull_idx = torch.as_tensor(serve_eng.mapper(pull_keys).astype(np.int64),
                               device=serve_eng.device)
    f32 = dict(serve_eng.ws)
    before = ws_bytes(f32)
    pull0 = embedding.pull_sparse(f32, pull_idx)
    mxu0 = mxu_path.pull_pool_cvm(f32, plan, dims, (s, l, b))
    fast0 = fast_path.pull_pool_cvm(f32, bt["indices"], bt["lengths"])
    max_mf = float(f32["mf"].abs().max())
    t0 = time.perf_counter()
    serve_eng.freeze_for_serving()
    if device == "cuda":
        torch.cuda.synchronize()
    freeze_s = time.perf_counter() - t0
    ws = serve_eng.ws
    after = ws_bytes(ws)
    if ws["mf"].dtype != torch.int16 or ws["mf_scale"].dim() != 0:
        raise AssertionError("serving[b]: the frozen mf is not int16 with "
                             "a 0-d scale")
    scale = float(ws["mf_scale"])
    pull1 = embedding.pull_sparse(ws, pull_idx)
    if not torch.equal(pull1[:, :3], pull0[:, :3]):
        raise AssertionError("serving[b]: pull_sparse columns 0-2 changed "
                             "at the freeze")
    pull_err = float((pull1[:, 3:] - pull0[:, 3:]).abs().max())
    if pull_err > scale / 2 + 1e-9:
        raise AssertionError(f"serving[b]: frozen pull_sparse mf off by "
                             f"{pull_err} (> scale/2)")
    # the main path of (b): each pull with the counts set to 0 just
    # before and read just after
    launches, pooled = {}, {}
    for name, kern in (("mxu", "gather_sorted"), ("fast", "gather_pool")):
        reset_counts()
        pooled[name] = (
            mxu_path.pull_pool_cvm(ws, plan, dims, (s, l, b))
            if name == "mxu" else
            fast_path.pull_pool_cvm(ws, bt["indices"], bt["lengths"]))
        if device == "cuda":
            torch.cuda.synchronize()
        launches[name] = read_counts()
        if device == "cuda" and launches[name][kern] < 1:
            raise AssertionError(f"serving[b]: the frozen {name} pull did "
                                 f"not launch {kern}")
    errs = {}
    for name, ref in (("mxu", mxu0), ("fast", fast0)):
        err = float((pooled[name] - ref).abs().max())
        errs[name] = err
        if err > 3 * scale / 2 + 1e-6:
            raise AssertionError(f"serving[b]: the frozen {name} pull is "
                                 f"off the f32 pull by {err}")
    # the same calls on the CPU over the same frozen tensors: the gathers
    # bit-equal, the pooled values within rtol 1e-6
    cpu = {f: t.cpu() for f, t in ws.items()}
    plan_cpu = tuple(t.cpu() for t in plan)
    idx_cpu, len_cpu = bt["indices"].cpu(), bt["lengths"].cpu()
    eff = mxu_path.plan_eff_dims(plan, dims) or dims

    def pool_gather(w, idx, lengths):
        rows = idx.permute(0, 2, 1).reshape(s * b, l).to(torch.int32)
        return pg.gather_pool(fast_path._pull_table(w), rows.contiguous(),
                              lengths.reshape(s * b).to(torch.int32)
                              .contiguous())

    on_cpu = {
        "mxu": (sp.gather_sorted(mxu_path._pull_table(ws, dims), plan[0],
                                 eff).cpu(),
                sp.gather_sorted(mxu_path._pull_table(cpu, dims),
                                 plan_cpu[0], eff),
                mxu_path.pull_pool_cvm(cpu, plan_cpu, dims, (s, l, b))),
        "fast": (pool_gather(ws, bt["indices"], bt["lengths"]).cpu(),
                 pool_gather(cpu, idx_cpu, len_cpu),
                 fast_path.pull_pool_cvm(cpu, idx_cpu, len_cpu))}
    for name, (card_g, cpu_g, cpu_pool) in on_cpu.items():
        if not torch.equal(card_g, cpu_g):
            raise AssertionError(f"serving[b]: the frozen {name} gather "
                                 "differs from the CPU's")
        if not torch.allclose(pooled[name].cpu(), cpu_pool, rtol=1e-6,
                              atol=0.0):
            raise AssertionError(f"serving[b]: the frozen {name} pool "
                                 "differs from the CPU's beyond rtol 1e-6")
    try:
        serve_eng.end_pass()
    except RuntimeError as e:
        if "serving-frozen" not in str(e):
            raise
    else:
        raise AssertionError("serving[b]: end_pass wrote back a frozen set")
    try:
        trainer.train_pass(feed)
    except ValueError as e:
        if "serving-frozen" not in str(e):
            raise
    else:
        raise AssertionError("serving[b]: SparseTrainer trained a frozen "
                             "set")
    out = {"pass_keys": serve_eng.num_keys, "ws_bytes_f32": before,
           "ws_bytes_frozen": after, "freeze_s": freeze_s,
           "max_abs_mf": max_mf, "pull_sparse_mf_err": pull_err,
           "pool_err": errs, "launches": launches}
    log(f"serving[b]: froze {serve_eng.num_keys} pass keys in "
        f"{freeze_s:.4f} s: working set {before / 2**20:.1f} MiB → "
        f"{after / 2**20:.1f} MiB (mf int16, max |mf| {max_mf:.4f}); "
        f"pull_sparse of {len(pull_keys)} keys: columns 0-2 bitwise, mf "
        f"within {pull_err:.3g}; mxu pool within {errs['mxu']:.3g}, fast "
        f"within {errs['fast']:.3g} of the f32 pulls, = the CPU's; launches "
        f"mxu {launches['mxu']}, fast {launches['fast']}; end_pass and "
        "SparseTrainer refuse the frozen set")
    serve_eng.ws = None
    return launches, out


def serving_queries(dump_keys: np.ndarray, seed: int):
    """SERVE_QUERIES queries of SERVE_SAMPLES samples × N_SLOTS slots ×
    1..CAP keys (``lod``: each sample's key span), SERVE_UNSEEN of the
    keys outside the dump."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SERVE_QUERIES):
        per_sample = rng.integers(1, CAP + 1, (SERVE_SAMPLES, N_SLOTS)).sum(1)
        lod = np.zeros(SERVE_SAMPLES + 1, np.int64)
        np.cumsum(per_sample, out=lod[1:])
        n = int(lod[-1])
        keys = dump_keys[rng.integers(0, len(dump_keys), n)]
        unseen = rng.random(n) < SERVE_UNSEEN
        keys[unseen] = (KEY_SPACE + rng.integers(
            1, 2 ** 40, int(unseen.sum()))).astype(np.uint64)
        out.append((keys, lod))
    return out


def expected_answers(frozen, queries) -> dict:
    """The digest of every query's pull and forward answer over one
    frozen table."""
    from paddlebox_tpu_torch.ps.serving import _pool_rows
    out = {}
    for qi, (keys, lod) in enumerate(queries):
        rows = frozen.lookup_rows(keys)
        out[("pull", qi)] = digest(rows)
        out[("forward", qi)] = digest(_pool_rows(rows, lod))
    return out


def serving_load(routers, queries, per_thread: int, until=None,
                 after: int = 0):
    """SERVE_THREADS client threads, each on its tenant's router,
    alternating pull_sparse and forward over the queries: ``per_thread``
    queries each, or (``until`` an Event) until it is set and ``after``
    more.  Returns (wall s, queries, failures, [(kind, query, digest)])."""
    answers, errors = [], []
    lock = threading.Lock()

    def client(t: int) -> None:
        router = routers[t % len(routers)]
        j, left = 0, None
        while True:
            if until is None:
                if j >= per_thread:
                    return
            elif left is None and until.is_set():
                left = after
            if left is not None:
                if left <= 0:
                    return
                left -= 1
            qi = (t + j) % len(queries)
            keys, lod = queries[qi]
            kind = "pull" if j % 2 == 0 else "forward"
            try:
                got = (router.pull_sparse(keys) if kind == "pull"
                       else router.forward(keys, lod))
                with lock:
                    answers.append((kind, qi, digest(got)))
            except Exception as e:  # noqa: BLE001 — every failure is counted and fails the phase
                with lock:
                    errors.append(repr(e))
            j += 1

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, len(answers), errors, answers


def latency_line(tenant: str) -> str:
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot
    snap = stat_snapshot(f"serving.{tenant}.latency_s")
    return (f"{tenant} p50 {snap.get(f'serving.{tenant}.latency_s.p50'):.4f}"
            f" s p99 {snap.get(f'serving.{tenant}.latency_s.p99'):.4f} s")


def build_replicas(kw_list):
    """ServingReplicas built in parallel threads (each parses the whole
    dump, numpy and the native parser release the GIL)."""
    from paddlebox_tpu_torch.ps.serving import ServingReplica
    out = [None] * len(kw_list)
    errs = []

    def make(i: int) -> None:
        try:
            out[i] = ServingReplica(**kw_list[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=make, args=(i,))
               for i in range(len(kw_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        for r in out:
            if r is not None:
                r.shutdown(drain_timeout=2.0)
        raise errs[0]
    return out


def shutdown_all(replicas, routers) -> None:
    for r in routers:
        r.close()
    stops = [threading.Thread(target=r.shutdown, kwargs={
        "drain_timeout": 2.0}) for r in replicas if r is not None]
    for t in stops:
        t.start()
    for t in stops:
        t.join()


def serving_replica_swap_fleet(tr: dict, seed: int):
    """(c) one replica over day 1 under load, (d) the hot swap to day 2
    under load, (e) the sharded fleet against the single replica and a
    replica killed under load."""
    from paddlebox_tpu_torch.io.checkpoint import publish_xbox_manifest
    from paddlebox_tpu_torch.ps.serving import (ServingRouter, _pool_rows)
    from paddlebox_tpu_torch.utils.monitor import StatRegistry
    (day1, date1), (day2, date2) = tr["dumps"]
    cfg = serve_config()
    engine = tr["engine"]
    out = {}
    rep = build_replicas([dict(config=cfg, xbox_path=day1, day=date1,
                               generation=1,
                               tenants=list(SERVE_TENANTS))])[0]
    routers = [ServingRouter([rep.addr], tenant=t) for t in SERVE_TENANTS]
    fleet_reps, fleet_routers = [], []
    try:
        frozen1 = rep._gen.tables[f"{SERVE_TENANTS[0]}/embedding"]
        queries = serving_queries(frozen1._keys, seed)
        for keys, lod in queries[:2]:
            rows = routers[0].pull_sparse(keys)
            want = frozen1.lookup_rows(keys)
            if set(rows) != set(want) or any(
                    not np.array_equal(rows[f], want[f]) for f in want):
                raise AssertionError("serving[c]: pull_sparse != "
                                     "FrozenHostTable.lookup_rows")
            if not np.array_equal(routers[1].forward(keys, lod),
                                  _pool_rows(want, lod)):
                raise AssertionError("serving[c]: forward != _pool_rows")
        exp1 = expected_answers(frozen1, queries)
        StatRegistry.instance().reset()
        wall, n, errors, answers = serving_load(routers, queries,
                                                SERVE_PER_THREAD)
        if errors or n != SERVE_THREADS * SERVE_PER_THREAD:
            raise AssertionError(f"serving[c]: {len(errors)} failed "
                                 f"queries: {errors[:3]}")
        bad = [a for a in answers if exp1[a[:2]] != a[2]]
        if bad:
            raise AssertionError(f"serving[c]: {len(bad)} answers differ "
                                 "from the frozen table's")
        n_keys = int(np.mean([len(k) for k, _ in queries]))
        out["c"] = {"rows": frozen1.size(), "queries": n, "wall_s": wall,
                    "qps": n / wall, "keys_per_query": n_keys,
                    "latency": {t: latency_line(t) for t in SERVE_TENANTS}}
        log(f"serving[c]: one replica, {frozen1.size()} rows of day 1, "
            f"tenants {','.join(SERVE_TENANTS)}: {SERVE_THREADS} threads × "
            f"{SERVE_PER_THREAD} queries of {SERVE_SAMPLES} samples "
            f"(~{n_keys} keys, pull_sparse and forward alternating) in "
            f"{wall:.2f} s = {n / wall:.1f} QPS; "
            + "; ".join(out["c"]["latency"].values())
            + "; every answer = lookup_rows / _pool_rows bitwise")

        # (d) the hot swap under the same load
        rep.watch_manifest(tr["root"], poll_s=SERVE_POLL_S)
        swapped = threading.Event()
        holder = {}

        def swap() -> None:
            t0 = time.perf_counter()
            publish_xbox_manifest(tr["root"], day2, generation=2, day=date2)
            while rep._gen.generation != 2:
                time.sleep(0.005)
            holder["swap_s"] = time.perf_counter() - t0
            swapped.set()

        StatRegistry.instance().reset()
        swapper = threading.Timer(1.0, swap)
        swapper.start()
        wall, n, errors, answers = serving_load(
            routers, queries, 0, until=swapped, after=10)
        swapper.join()
        if errors:
            raise AssertionError(f"serving[d]: {len(errors)} failed "
                                 f"queries during the swap: {errors[:3]}")
        frozen2 = rep._gen.tables[f"{SERVE_TENANTS[0]}/embedding"]
        exp2 = expected_answers(frozen2, queries)
        n1 = sum(exp1[a[:2]] == a[2] for a in answers)
        n2 = sum(exp2[a[:2]] == a[2] for a in answers)
        if n1 + n2 != len(answers) or not n1 or not n2:
            raise AssertionError(f"serving[d]: {len(answers)} answers, "
                                 f"{n1} whole from day 1, {n2} from day 2")
        # after the swap: day 2's rows, as the dump's text carries them
        sample = np.sort(np.unique(queries[0][0]))
        sample = sample[np.isin(sample, frozen2._keys)][:4096]
        got = routers[0].pull_sparse(sample)
        want = engine.table.bulk_pull(sample)
        for f in ("show", "click", "embed_w"):
            if not np.array_equal(got[f], g6(want[f])):
                raise AssertionError(f"serving[d]: {f} after the swap is "
                                     "not day 2's")
        out["d"] = {"swap_s": holder["swap_s"], "queries": n,
                    "day1_answers": n1, "day2_answers": n2,
                    "day2_rows": frozen2.size()}
        log(f"serving[d]: watch_manifest swapped to day 2 ({frozen2.size()}"
            f" rows) {holder['swap_s']:.3f} s after the publish, under "
            f"{SERVE_THREADS} threads: {n} queries, 0 failed, {n1} answers "
            f"whole from day 1 and {n2} from day 2; reads after the swap = "
            "day 2's trained rows through %.6g")

        # (e) 4 shards × 1 replica with a replicated hot set, then 4 × 2
        # with one replica killed under load
        uk, counts = np.unique(np.concatenate([k for k, _ in queries]),
                               return_counts=True)
        resident = np.isin(uk, frozen2._keys)
        hot = np.sort(uk[resident][np.argsort(
            -counts[resident], kind="stable")[:SERVE_HOT_KEYS]])
        t0 = time.perf_counter()
        fleet_reps = build_replicas([dict(
            config=cfg, xbox_path=day2, day=date2, generation=2,
            tenants=list(SERVE_TENANTS), shard=k, n_shards=SERVE_SHARDS,
            hot_keys=hot) for k in range(SERVE_SHARDS)])
        build1_s = time.perf_counter() - t0
        fan = ServingRouter(shard_groups=[[r.addr] for r in fleet_reps],
                            tenant=SERVE_TENANTS[0], hot_keys=hot)
        fleet_routers.append(fan)
        for qi, (keys, lod) in enumerate(queries):
            if digest(fan.pull_sparse(keys)) != exp2[("pull", qi)] or \
                    digest(fan.forward(keys, lod)) != exp2[("forward", qi)]:
                raise AssertionError(f"serving[e]: the {SERVE_SHARDS}-shard"
                                     f" fleet answers query {qi} unlike the "
                                     "single replica")
        t0 = time.perf_counter()
        fleet_reps += build_replicas([dict(
            config=cfg, xbox_path=day2, day=date2, generation=2,
            tenants=list(SERVE_TENANTS), shard=k, n_shards=SERVE_SHARDS,
            hot_keys=hot) for k in range(SERVE_SHARDS)])
        build2_s = time.perf_counter() - t0
        groups = [[fleet_reps[k].addr, fleet_reps[SERVE_SHARDS + k].addr]
                  for k in range(SERVE_SHARDS)]
        fans = [ServingRouter(shard_groups=groups, tenant=t, hot_keys=hot)
                for t in SERVE_TENANTS]
        fleet_routers += fans
        killed = threading.Event()
        victim = fleet_reps[1]
        killer = threading.Timer(0.5, lambda: (victim.kill(), killed.set()))
        killer.start()
        wall, n, errors, answers = serving_load(fans, queries, 0,
                                                until=killed, after=6)
        killer.join()
        if errors:
            raise AssertionError(f"serving[e]: {len(errors)} failed queries"
                                 f" with a replica killed: {errors[:3]}")
        bad = [a for a in answers if exp2[a[:2]] != a[2]]
        if bad:
            raise AssertionError(f"serving[e]: {len(bad)} of {n} answers "
                                 "differ from the single replica's")
        out["e"] = {"shards": SERVE_SHARDS, "hot_keys": len(hot),
                    "build_4x1_s": build1_s, "build_more_4_s": build2_s,
                    "queries_under_kill": n, "wall_s": wall}
        log(f"serving[e]: {SERVE_SHARDS} shards × 1 replica ({len(hot)} hot "
            f"keys replicated; built in parallel in {build1_s:.2f} s) = the "
            f"single replica bitwise on {len(queries)} queries, pull_sparse "
            f"and forward; {SERVE_SHARDS} × 2 (4 more in {build2_s:.2f} s) "
            f"with shard 1's primary killed under load: {n} queries, 0 "
            "failed, every answer = the single replica's")
        return out
    finally:
        shutdown_all([rep] + fleet_reps, routers + fleet_routers)


def serving_delta(tr: dict, files, device: str):
    """(f) A replica streams the trainer's checkpoint chain; one more
    pass with save_pass reaches it within its poll interval, and the
    patched rows equal the trained table's exactly."""
    from paddlebox_tpu_torch import fleet
    from paddlebox_tpu_torch.ps.serving import ServingReplica, ServingRouter
    from paddlebox_tpu_torch.utils.monitor import (StatRegistry,
                                                   stat_snapshot)
    ck, engine = tr["ck"], tr["engine"]
    t0 = time.perf_counter()
    rep = ServingReplica(config=serve_config(), ckpt_root=ck.root,
                         tenants=list(SERVE_TENANTS))
    build_s = time.perf_counter() - t0
    router = ServingRouter([rep.addr], tenant=SERVE_TENANTS[0])
    try:
        head0 = rep._gen.generation
        if head0 != ck.head():
            raise AssertionError("serving[f]: the replica did not load the "
                                 "chain's head")
        StatRegistry.instance().reset()
        rep.watch_ckpt(poll_s=SERVE_POLL_S)
        reset_counts()
        t0 = time.perf_counter()
        fleet.train_passes(tr["trainer"], tr["ds"], files, date=LIFE_DATES[-1],
                           prefetch=False, checkpoint=ck, resume=0)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = read_counts()
        saved = time.perf_counter()
        head = ck.head()
        st = ck.gen_state(head)
        if st["kind"] != "delta":
            raise AssertionError(f"serving[f]: the pass saved a {st['kind']}")
        while rep._gen.generation != head:
            if time.perf_counter() - saved > 10 * SERVE_POLL_S + 30:
                raise AssertionError("serving[f]: the replica never patched")
            time.sleep(0.005)
        seen_s = time.perf_counter() - saved
        keys = np.sort(engine._last_written)
        got = router.pull_sparse(keys)
        want = engine.table.bulk_pull(keys)
        diff = [f for f in want if f not in got
                or not np.array_equal(got[f], want[f])]
        if diff:
            raise AssertionError(f"serving[f]: patched fields {diff} differ "
                                 "from the trained table's")
        snap = stat_snapshot("serving.")
        out = {"build_s": build_s, "rows_patched": int(st["rows"]),
               "pass_train_s": saved - t0, "seen_after_save_s": seen_s,
               "staleness_s": snap.get("serving.staleness_s.max"),
               "patch_s": snap.get("serving.patch_s.max"),
               "generation": head, "launches": launches}
        log(f"serving[f]: a replica over the checkpoint chain (gen {head0}, "
            f"built in {build_s:.2f} s) patched gen {head} "
            f"({out['rows_patched']} rows) {seen_s:.3f} s after save_pass "
            f"(poll {SERVE_POLL_S} s): serving.staleness_s "
            f"{out['staleness_s']:.3f} s, patch {out['patch_s']:.3f} s; "
            "every patched row = the trained table's, every field")
        return out
    finally:
        router.close()
        rep.shutdown(drain_timeout=2.0)


def serving_phase(paths, seed: int = 20, device: str = "cuda"):
    """Phase 15 (see the module docstring)."""
    from paddlebox_tpu_torch.data.data_feed import DataFeed
    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        files = [[[p] for p in paths[d * CLUSTER_PASSES:
                                     (d + 1) * CLUSTER_PASSES]]
                 for d in range(len(LIFE_DATES))]
        tr = serving_train_dump(files, work, device)
        block = SlotRecordBlock.concat(
            list(DataFeed(feed_config()).read_file(paths[0])))
        freeze_launches, freeze_out = serving_freeze(tr["serve_engine"],
                                                     block, device)
        tr["serve_engine"] = None
        out = {"a": tr["out"], "b": freeze_out}
        out.update(serving_replica_swap_fleet(tr, seed))
        out["f"] = serving_delta(tr, [[paths[0]]], device)
        launches = {"train": tr["launches"], "mxu": freeze_launches["mxu"],
                    "fast": freeze_launches["fast"],
                    "delta_pass": out["f"]["launches"]}
        return launches, out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 16: the trainer fleet
# ---------------------------------------------------------------------------

FLEET_V = 8                        # virtual slices: one batch each
# one 65,536-record pass file a pass: at 131,072 records (two files) the
# phase took 265 s on an H100 (PERF.md §6), over its ~180 s share
FLEET_FILES_PER_PASS = 1
FLEET_WIDE = 4                     # ranks of runs b-d
# one pass a day of LIFE_DATES (runs a-e): two a day took 190-232 s of
# phase on an H100 (PERF.md §6), and the day's second pass repeated what
# the first proves; the kill still lands past a change of date
FLEET_PASSES = 1
FLEET_KILL_PASS = 2                # (d): rank 1 dies at this pass's fold
# (label, ranks, prefetch, killed rank or None, launches_by_path name)
FLEET_RUNS = (("a", 1, False, None, "fleet_n1"),
              ("b", FLEET_WIDE, False, None, "fleet_n4"),
              ("c", FLEET_WIDE, True, None, "fleet_n4_prefetch"),
              ("d", FLEET_WIDE, False, 1, "fleet_kill"))
# (e): fleet_main processes over their own spec (26 slots of capacity 2,
# mf_dim 8, 13 dense; the module fixes DeepFM (16, 8))
FLEET_MAIN_RECORDS = 16_384        # a pass
FLEET_MAIN_BATCH = 2048            # one batch a slice
# card vs CPU over pass 1 of (a): every slice's first batch starts from
# the same dense state on both devices (first-step agreement is rtol
# 1e-4), but a slice holding more than one batch takes its second after
# an Adam step, whose first update is lr·m/(√v + eps) ≈ lr·sign(g): a
# gradient entry near 0 may step either way on the two devices, so the
# pass means are held to rtol 1e-3
FLEET_CPU_RTOL = 1e-3


def fleet_free_ports(n: int, base: list) -> list:
    """``n`` fixed trainer ports below the ephemeral range: a restarted
    rank re-binds its own address, which no outbound dial may hold."""
    out = []
    while len(out) < n:
        base[0] += 1
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", base[0]))
            out.append(base[0])
        except OSError:
            pass
        finally:
            s.close()
    return out


def fleet_table_config() -> EmbeddingTableConfig:
    return EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0))


def count_end_days(flt) -> list:
    """Wrap every shard table's ``end_day`` with a call count (the
    fleet's exactly-once day rollover, seen from the servers)."""
    counts = []
    for s in flt.sups:
        box, orig = [0], s.table.end_day

        def counted(*a, _orig=orig, _box=box, **kw):
            _box[0] += 1
            return _orig(*a, **kw)

        s.table.end_day = counted
        counts.append(box)
    return counts


def stop_fleet(flt) -> None:
    """Each server's drain waits out its listener's poll: stop the
    shards together."""
    stops = [threading.Thread(target=s.stop) for s in flt.sups]
    for t in stops:
        t.start()
    for t in stops:
        t.join()


def fleet_result_dense(res: dict) -> dict:
    """A rank's final dense weights and Adam state, as ``dense_state``
    names them."""
    dense = {f"model.{k}": v for k, v in res["params"].items()}
    for i, st in res["opt_state"].items():
        for k, v in st.items():
            dense[f"opt.{i}.{k}"] = torch.as_tensor(v)
    return dense


def fleet_slice_batches(files) -> np.ndarray:
    """Batches each virtual slice trains over ``files``: the records
    routed there (``slice_of`` of ``route_keys``), cut into BATCH-record
    batches — counted from the data, independently of the run."""
    from paddlebox_tpu_torch.data.data_feed import DataFeed
    from paddlebox_tpu_torch.data.pass_feed import route_keys
    from paddlebox_tpu_torch.data.shuffle_transport import slice_of
    counts = np.zeros(FLEET_V, np.int64)
    for f in files:
        for block in DataFeed(feed_config()).read_file(f):
            counts += np.bincount(slice_of(route_keys(block), FLEET_V),
                                  minlength=FLEET_V)
    return -(-counts // BATCH)


def fleet_run(days, world: int, prefetch: bool, killed, device: str,
              ports: list):
    """``fleet.run_trainer_fleet`` (ranks as threads, supervised) over a
    loopback ``PSFleet`` of CLUSTER_WIDE shards.  Returns the world it
    left (history, every rank's dense state, the union of the shards'
    tables), the per-rank results and the run's readings."""
    from paddlebox_tpu_torch import fleet
    from paddlebox_tpu_torch.launch import PSFleet
    from paddlebox_tpu_torch.ps import faults
    from paddlebox_tpu_torch.utils import flight
    from paddlebox_tpu_torch.utils.monitor import (StatRegistry,
                                                   stat_snapshot)
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    flt = PSFleet(CLUSTER_WIDE, config=fleet_table_config(), seed=0,
                  max_restarts=16)
    try:
        end_days = count_end_days(flt)
        plans = ({killed: faults.FaultPlan(seed=19).kill_at(
            "fleet_allreduce", at=(FLEET_KILL_PASS - 1,))}
            if killed is not None else None)
        addrs = ([("127.0.0.1", p) for p in fleet_free_ports(world, ports)]
                 if world > 1 else None)
        StatRegistry.instance().reset()
        if device == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        m0 = time.monotonic()
        results = fleet.run_trainer_fleet(
            world, flt.addrs, work, fleet_table_config(),
            lambda: make_model("deepfm"), feed_config(), days,
            batch_size=BATCH, virtual_shards=FLEET_V, table_seed=0,
            trainer_seed=0, prefetch=prefetch, trainer_addrs=addrs,
            fault_plans=plans, max_restarts=3, client_deadline=300.0,
            device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - m0
        launches = read_counts()
        snap = stat_snapshot("")
        # a pass's cursor save may be recorded by more than one rank (a
        # poked duty after a leader's death): one end per pass epoch
        by_epoch = {}
        for e in flight.events(kind="fleet_cursor"):
            if e["mono"] >= m0 and e.get("pass_index", 0) > 0:
                by_epoch[e["epoch"]] = min(by_epoch.get(e["epoch"], 1e30),
                                           e["mono"])
        ends = [by_epoch[k] for k in sorted(by_epoch)]
        walls = [float(x) for x in np.diff([m0] + ends)]
        hist = results[0]["history"]
        n_pass = len(hist)
        wire = sum(v for k, v in snap.items()
                   if k.startswith("ps.wire.") and k.endswith(".tx_bytes"))
        world_state = fleet_world(
            [s.table for s in flt.sups], fleet_result_dense(results[0]),
            [(h["loss"], h["auc"], h["batches"]) for h in hist])
        r = {"ranks": world, "prefetch": prefetch, "killed": killed,
             "wall_s": wall, "pass_wall_s": walls,
             "median_pass_wall_s": float(np.median(walls)) if walls
             else None,
             "history": [{k: h[k] for k in ("loss", "auc", "batches")}
                         for h in hist],
             "batches": int(sum(h["batches"] for h in hist)),
             "shuffle_s_max": snap.get("trainer.fleet.shuffle_s.max"),
             "shuffle_s_sum": snap.get("trainer.fleet.shuffle_s.sum"),
             "shuffle_s_count": snap.get("trainer.fleet.shuffle_s.count"),
             "straggler_gap_s_max": snap.get(
                 "trainer.fleet.straggler_gap_s.max"),
             "straggler_gap_s_p50": snap.get(
                 "trainer.fleet.straggler_gap_s.p50"),
             "shadow_replays": snap.get("trainer.fleet.shadow_replays", 0.0),
             "restarts": snap.get("trainer.supervisor.restarts", 0.0),
             "restart_mttr_s_max": snap.get(
                 "trainer.fleet.restart_mttr_s.max"),
             "ps_wire_bytes_per_pass": wire / max(n_pass, 1),
             "shuffle_tx_bytes_per_pass": snap.get(
                 "trainer.fleet.shuffle_tx_bytes", 0.0) / max(n_pass, 1),
             "end_day_calls": [b[0] for b in end_days],
             "launches": launches}
        return world_state, results, r
    finally:
        stop_fleet(flt)
        shutil.rmtree(work, ignore_errors=True)


def fleet_main_run(spec_path: str, world: int, work: str, ports: list,
                   device: str) -> dict:
    """(e): ``python -m paddlebox_tpu_torch.trainer.fleet_main`` as
    ``world`` rank processes on ``device`` over a loopback PSFleet of
    CLUSTER_WIDE shards with fleet_main's table config; returns each
    rank's FLEETMAIN record and the wall."""
    from paddlebox_tpu_torch.launch import PSFleet
    flt = PSFleet(CLUSTER_WIDE, config=EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=2.0)), seed=1,
        max_restarts=16)
    procs = []
    try:
        ps = ",".join(f"{h}:{p}" for h, p in flt.addrs)
        tr = ",".join(f"127.0.0.1:{p}"
                      for p in fleet_free_ports(world, ports))
        wd = os.path.join(work, f"wd-{world}")
        t0 = time.monotonic()
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "paddlebox_tpu_torch.trainer.fleet_main",
                 "--rank", str(rank), "--world", str(world), "--ps", ps,
                 "--trainer_addrs", tr if world > 1 else "",
                 "--workdir", wd, "--spec", spec_path,
                 "--batch_size", str(FLEET_MAIN_BATCH),
                 "--virtual_shards", str(FLEET_V), "--table_seed", "1",
                 "--device", device],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(
                    f"trainer_fleet[e]: fleet_main rank {rank}/{world} "
                    f"exited {proc.returncode}:\n{err[-3000:]}")
            line = [ln for ln in out.splitlines()
                    if ln.startswith("FLEETMAIN ")]
            if len(line) != 1:
                raise AssertionError(f"trainer_fleet[e]: rank {rank}/"
                                     f"{world} printed {len(line)} "
                                     "FLEETMAIN lines")
            outs.append(json.loads(line[0][len("FLEETMAIN "):]))
        return {"ranks": outs, "wall_s": time.monotonic() - t0}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        stop_fleet(flt)


def fleet_main_phase(seed: int, work: str, ports: list,
                     device: str) -> dict:
    """(e): fleet_main's own spec and files, as one and as two
    processes; the two histories must be bitwise equal."""
    rng = np.random.default_rng(seed)
    days = []
    for d, date in enumerate(LIFE_DATES):
        passes = []
        for p in range(FLEET_PASSES):
            path = os.path.join(work, f"main-d{d}p{p}.txt")
            write_slot_file(path, make_block(rng, FLEET_MAIN_RECORDS,
                                             cap=2))
            passes.append([path])
        days.append([date, passes])
    spec = os.path.join(work, "spec.json")
    with open(spec, "w") as f:
        json.dump({"days": days, "n_slots": N_SLOTS, "mf_dim": MF_DIM,
                   "dense_dim": DENSE_DIM}, f)
    runs = {w: fleet_main_run(spec, w, work, ports, device) for w in (1, 2)}
    solo = runs[1]["ranks"][0]["history"]
    for rank, rec in enumerate(runs[2]["ranks"]):
        if rec["history"] != solo:
            raise AssertionError(
                f"trainer_fleet[e]: 2-process rank {rank}'s history "
                f"{rec['history']} != the 1-process run's {solo}")
    if not solo or not all(math.isfinite(h["loss"]) for h in solo):
        raise AssertionError(f"trainer_fleet[e]: history {solo}")
    return {"history": solo,
            "wall_s": {w: runs[w]["wall_s"] for w in runs},
            "rank_wall_s": {w: [r["wall_s"] for r in runs[w]["ranks"]]
                            for w in runs},
            "restarts": {w: [r["restarts"] for r in runs[w]["ranks"]]
                         for w in runs},
            "shuffle_tx_bytes": [r["stats"].get(
                "trainer.fleet.shuffle_tx_bytes", 0.0)
                for r in runs[2]["ranks"]]}


def trainer_fleet_phase(paths, seed: int = 21, device: str = "cuda"):
    """Phase 16 (see the module docstring).  ``paths``: the pass files,
    FLEET_FILES_PER_PASS a pass, FLEET_PASSES passes a day."""
    t_phase = time.perf_counter()
    per_day = FLEET_FILES_PER_PASS * FLEET_PASSES
    days = [(date, [paths[d * per_day + p * FLEET_FILES_PER_PASS:
                          d * per_day + (p + 1) * FLEET_FILES_PER_PASS]
                    for p in range(FLEET_PASSES)])
            for d, date in enumerate(LIFE_DATES)]
    ports = [27100]
    kill_files = days[(FLEET_KILL_PASS - 1) // FLEET_PASSES][1][
        (FLEET_KILL_PASS - 1) % FLEET_PASSES]
    kill_pass_batches = fleet_slice_batches(kill_files)
    launches, out, base = {}, {}, None
    for label, world, prefetch, killed, name in FLEET_RUNS:
        what = (f"trainer_fleet[{label}: N={world},"
                f"{'prefetch' if prefetch else 'serial'}"
                + (f",rank {killed} killed at fleet_allreduce of pass "
                   f"{FLEET_KILL_PASS}" if killed is not None else "")
                + "]")
        world_state, results, r = fleet_run(days, world, prefetch, killed,
                                            device, ports)
        flat = [x[0] for x in world_state["losses"]]
        if len(flat) != len(LIFE_DATES) * FLEET_PASSES or \
                not all(map(math.isfinite, flat)):
            raise AssertionError(f"{what}: history {r['history']}")
        if r["end_day_calls"] != [len(LIFE_DATES)] * CLUSTER_WIDE:
            raise AssertionError(f"{what}: end_day applied "
                                 f"{r['end_day_calls']} times per shard "
                                 f"over {len(LIFE_DATES)} days")
        for res in results[1:]:
            same_world(f"{what}: rank {res['rank']} vs rank 0",
                       world_state, dict(world_state,
                                         dense=fleet_result_dense(res)))
        if base is None:
            base = world_state
            if r["history"][FLEET_KILL_PASS - 1]["batches"] != \
                    int(kill_pass_batches.sum()):
                raise AssertionError(
                    f"{what}: pass {FLEET_KILL_PASS} trained "
                    f"{r['history'][FLEET_KILL_PASS - 1]['batches']} "
                    f"batches, its slices hold {kill_pass_batches}")
        else:
            same_world(f"{what} vs trainer_fleet[a]", base, world_state)
        if device == "cuda":
            want = r["batches"]
            if killed is not None:
                r["replayed_batches"] = int(kill_pass_batches[
                    killed::world].sum())
                want += r["replayed_batches"]
                if r["restarts"] < 1 or r["shadow_replays"] < 1:
                    raise AssertionError(f"{what}: restarts "
                                         f"{r['restarts']}, shadow replays "
                                         f"{r['shadow_replays']}")
            for k in ("gather_sorted", "scatter_add_sorted"):
                if r["launches"][k] != want:
                    raise AssertionError(
                        f"{what}: {k} launched {r['launches'][k]} times "
                        f"for {want} trained batches")
            if r["launches"]["gather_pool"]:
                raise AssertionError(f"{what}: gather_pool launched")
            if label == "b" and r["launches"] != out["a"]["launches"]:
                raise AssertionError(f"{what}: launches {r['launches']} "
                                     f"!= trainer_fleet[a]'s "
                                     f"{out['a']['launches']}")
        launches[name] = r["launches"]
        out[label] = r
        log(f"{what}: wall {r['wall_s']:.3f} s, pass walls "
            f"{[round(x, 3) for x in r['pass_wall_s']]} s, "
            f"trainer.fleet.shuffle_s max {r['shuffle_s_max']} s (sum "
            f"{r['shuffle_s_sum']} over {r['shuffle_s_count']} samples), "
            f"straggler gap max {r['straggler_gap_s_max']} s, shadow "
            f"replays {int(r['shadow_replays'])}, restarts "
            f"{int(r['restarts'])}, PS wire "
            f"{r['ps_wire_bytes_per_pass'] / 2**20:.1f} MiB a pass, shuffle "
            f"{r['shuffle_tx_bytes_per_pass'] / 2**20:.1f} MiB a pass, "
            f"{r['batches']} batches, launches {r['launches']}"
            + (f" (= {r['batches']} + {r['replayed_batches']} replayed)"
               if killed is not None and device == "cuda" else "")
            + ("" if label == "a" else "; = trainer_fleet[a] bitwise"))
    hist_a = out["a"]["history"]
    # pass 1 of (a) again on the CPU, from the same seeds and data
    cpu_state, _, cpu_r = fleet_run([(LIFE_DATES[0], days[0][1][:1])], 1,
                                    False, None, "cpu", ports)
    cpu_h = cpu_r["history"][0]
    for k in ("loss", "auc"):
        if not math.isclose(cpu_h[k], hist_a[0][k], rel_tol=FLEET_CPU_RTOL):
            raise AssertionError(f"trainer_fleet[cpu]: pass 1 {k} card "
                                 f"{hist_a[0][k]} vs CPU {cpu_h[k]}")
    if cpu_h["batches"] != hist_a[0]["batches"]:
        raise AssertionError("trainer_fleet[cpu]: pass 1 batches differ")
    out["cpu_pass1"] = cpu_h
    log(f"trainer_fleet[cpu]: pass 1 loss card {hist_a[0]['loss']!r} vs "
        f"CPU {cpu_h['loss']!r}, AUC card {hist_a[0]['auc']!r} vs CPU "
        f"{cpu_h['auc']!r} (rtol {FLEET_CPU_RTOL})")
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_main_")
    try:
        out["e"] = fleet_main_phase(seed, work, ports, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    e = out["e"]
    log(f"trainer_fleet[e: fleet_main, 1 and 2 processes]: walls "
        f"{ {w: round(s, 3) for w, s in e['wall_s'].items()} } s (per rank "
        f"{e['rank_wall_s']}), restarts {e['restarts']}, shuffle "
        f"{[round(b / 2**20, 1) for b in e['shuffle_tx_bytes']]} MiB per "
        f"rank; histories bitwise equal ({len(e['history'])} passes)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"trainer_fleet: runs a-d bitwise equal (history, every rank's "
        f"dense weights and Adam state, {len(base['table'][0])} table keys "
        f"× every field over the union of the shards, no key on two); "
        f"end_day once a day on every shard; phase "
        f"{out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 17: the multi-shard mxu lowering, every shard on the card
# ---------------------------------------------------------------------------

# (run, mesh degrees, FLAGS_sharded_exchange_bf16, first-step rtol): the
# bf16 exchange rounds every pulled value and pushed gradient to 8
# mantissa bits (~4e-3 relative), hence (c)'s rtol 1e-2
SHARDED_RUNS = (("a", {"dp": 4}, False, 1e-4),
                ("b", {"dp": 2, "sharding": 2}, False, 1e-4),
                ("c", {"dp": 4}, True, 1e-2))


def sharded_kernels(what: str, block: dict, rows2d: torch.Tensor,
                    first_occ: torch.Tensor, p: int, shard: int,
                    rows_loc: int = 0, w_push: int = W_PUSH,
                    names=("gather_sorted", "scatter_add_sorted")) -> dict:
    """The sorted kernels ``names`` on one shard's plan of the pass's
    first batch (the feed's resident plan ``rows2d``/``first_occ`` over a
    gathered ``p``) against their plain versions, with device times by
    phase 2's method: the gather over the shard's trained feature-major
    block (``block``: its working-set fields; bit-exact, zeros on the
    sentinel run), the scatter over a seeded payload of ``w_push`` rows
    (rtol 1e-5 plus 1e-5 of each row's sum of |terms|), each twice
    bit-identical.  ``rows_loc``: the plan's table height (default the
    block's)."""
    dev = rows2d.device
    rows_loc = rows_loc or block["show"].shape[0]
    dims = sp.spmm_dims(p, rows_loc)
    flat = rows2d.reshape(-1)
    outside = flat == dims.sentinel
    gen = torch.Generator(device=dev).manual_seed(shard)
    payload = torch.randn((w_push, dims.p_pad), generator=gen, device=dev)
    payload[:, dims.p:] = 0.0
    n_unique = int(first_occ.sum().item())
    runs = torch.unique_consecutive(flat, return_counts=True)[1]
    out = {"shard": shard, "rows_loc": rows_loc, "p": dims.p,
           "p_pad": dims.p_pad, "n_kernel": dims.n_kernel,
           "distinct_rows": n_unique, "longest_run": int(runs.max()),
           "sentinel_share": float(outside.float().mean())}

    rows_l = flat.long()
    if "gather_sorted" in names:
        cols = [block["show"], block["click"], block["embed_w"],
                *block["mf"].T, block["mf_size"].to(torch.float32)]
        table = torch.zeros((W_PULL, dims.n_kernel), device=dev)
        table[:, :rows_loc] = torch.stack(cols)
        got = twice(f"{what} gather_sorted",
                    lambda: sp.gather_sorted(table, rows2d, dims))
        want = sp.gather_sorted_plain(table, rows2d, dims)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: gather_sorted != plain")
        if got[:, outside].any():
            raise AssertionError(f"{what}: gather_sorted read nonzero "
                                 "values on the sentinel run")
        g = {"ms": time_ms(f"{what} gather_sorted",
                           lambda: sp.gather_sorted(table, rows2d, dims)),
             "plain_ms": time_ms(f"{what} gather_sorted_plain",
                                 lambda: sp.gather_sorted_plain(
                                     table, rows2d, dims)),
             "library_ms": time_ms(f"{what} index_select",
                                   lambda: torch.index_select(table, 1,
                                                              rows_l)),
             "max_abs_err": float((got - want).abs().max())}
        g["bound_ms"], g["bound_by"] = bound_ms(
            4 * dims.p_pad + 4 * W_PULL * n_unique
            + 4 * W_PULL * dims.p_pad, 0)
        out["gather_sorted"] = g

    got = twice(f"{what} scatter_add_sorted",
                lambda: sp.scatter_add_sorted(payload, rows2d, first_occ,
                                              dims))
    want = sp.scatter_add_sorted_plain(payload, rows2d, first_occ, dims)
    abs_sum = sp.scatter_add_sorted_plain(payload.abs(), rows2d, first_occ,
                                          dims)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 1e-5 * want.abs() + 1e-5 * abs_sum + 1e-6).all()):
        raise AssertionError(f"{what}: scatter_add_sorted != plain: "
                             f"max err {float(err.max())}")
    if got[:, rows_loc:dims.sentinel].any() \
            or got[:, dims.sentinel + 1:].any():
        raise AssertionError(f"{what}: scatter_add_sorted wrote outside "
                             "the owned rows and the sentinel row")
    s = {"ms": time_ms(f"{what} scatter_add_sorted",
                       lambda: sp.scatter_add_sorted(payload, rows2d,
                                                     first_occ, dims)),
         "plain_ms": time_ms(f"{what} scatter_add_sorted_plain",
                             lambda: sp.scatter_add_sorted_plain(
                                 payload, rows2d, first_occ, dims)),
         "library_ms": time_ms(f"{what} index_add_", lambda: torch.zeros(
             (w_push, dims.n_kernel), device=dev).index_add_(
                 1, rows_l, payload)),
         "max_abs_err": float(err.max())}
    s["bound_ms"], s["bound_by"] = bound_ms(
        4 * w_push * dims.p_pad + 4 * dims.p_pad
        + 4 * w_push * dims.n_kernel, w_push * dims.p)
    out["scatter_add_sorted"] = s
    return out


def sharded_phase(block: SlotRecordBlock, params0, mxu_first: float,
                  one_device: dict):
    """The mxu_sharded lowering at the bench widths on the packed phase's
    data and weights, every shard on the card: ``SHARDED_RUNS`` (a) dp 4,
    a flat pool of 4 table shards; (b) dp 2 × sharding 2, the multi-node
    layout; (c) as (a) under FLAGS_sharded_exchange_bf16.  Each: auto
    resolves to mxu_sharded; finite losses and an AUC; gather_sorted and
    scatter_add_sorted exactly once a shard a step (4: (b)'s two nodes
    each hold both table shards), gather_pool never; the first step
    within the run's rtol of the packed one-device mxu pass and of the
    same topology on the CPU; a second pass from the same state (traced)
    leaves the same bits.  Then both kernels on shard 1 of (a)'s
    first batch against their plain versions, timed beside the
    one-device times of phase 2 (``one_device``)."""
    t_phase = time.perf_counter()
    launches, out = {}, {}
    for label, mesh, bf16, rtol in SHARDED_RUNS:
        what = f"sharded[{label}]"
        shards = int(np.prod(list(mesh.values())))
        flags.set_flags({"sharded_exchange_bf16": bf16})
        try:
            reset_counts()
            hold = {}
            t0 = time.perf_counter()
            stats, _, n_keys = run_pass(block, "cuda", params=params0,
                                        path="auto", packed=True,
                                        keep_ws=True, mesh=mesh, hold=hold)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[label] = read_counts()
            if stats["path"] != "mxu_sharded":
                raise AssertionError(f"{what}: auto resolved to "
                                     f"{stats['path']}")
            check_pass(what, stats, launches[label],
                       {"gather_sorted": shards, "scatter_add_sorted": shards,
                        "gather_pool": 0}, exact=True)
            first = stats["losses"][0]
            if not math.isclose(first, mxu_first, rel_tol=rtol):
                raise AssertionError(f"{what}: first-step loss {first} vs "
                                     f"the one-device mxu pass's "
                                     f"{mxu_first} (rtol {rtol:g})")
            cpu_loss = cpu_first_loss(what, block, first, params0,
                                      rtol=rtol, path="auto", packed=True,
                                      mesh=mesh)
            holder = {}
            again, _, _ = run_pass(
                block, "cuda", params=params0, path="auto", packed=True,
                keep_ws=True, mesh=mesh, around_train=tracer(holder))
            same_bits(what, stats, again)
        finally:
            flags.set_flags({"sharded_exchange_bf16": False})
        steady = float(np.median(stats["step_ms"][1:]))
        r = {"mesh": mesh, "bf16": bf16, "rtol": rtol, "shards": shards,
             "losses": stats["losses"], "auc": stats["auc"],
             "first_loss_vs_mxu": first / mxu_first - 1.0,
             "cpu_first_loss": cpu_loss, "step_ms": stats["step_ms"],
             "steady_step_ms": steady, "pass_wall_s": wall,
             "pass_keys": n_keys, "feed_bytes": stats["feed_bytes"],
             "plan_bytes": stats["plan_bytes"],
             "build_pass_feed_s": stats["build_pass_feed_s"],
             "launches": launches[label], "deterministic": True,
             "profile": profiled(what, holder["prof"], again)}
        if label == "a":
            feed, ws, shard = hold["feed"], stats["ws"], 1
            rows_loc = ws["show"].shape[0] // feed.plans["rows2d"].shape[1]
            out["kernels"] = sharded_kernels(
                "sharded", {f: v[shard * rows_loc:(shard + 1) * rows_loc]
                            for f, v in ws.items()},
                feed.plans["rows2d"][0, shard],
                feed.plans["first_occ"][0, shard],
                feed.plans["inv_perm"].shape[2], shard)
        out[label] = r
        log(f"{what}: mesh {mesh}{', bf16 exchange' if bf16 else ''}, "
            f"losses {stats['losses']}, auc {stats['auc']}, launches "
            f"{launches[label]} ({shards} shards x {N_BATCHES} steps), "
            f"step device ms {stats['step_ms']} (steady median "
            f"{steady:.3f}), plans {stats['plan_bytes'] / 2**20:.1f} MiB of "
            f"a {stats['feed_bytes'] / 2**20:.1f} MiB feed, build_pass_feed "
            f"{stats['build_pass_feed_s']:.2f} s, pass wall {wall:.2f} s; "
            f"first step {first!r} vs one-device mxu {mxu_first!r} (rtol "
            f"{rtol:g}); rerun bit-identical")
        del hold
    k = out["kernels"]
    for name in ("gather_sorted", "scatter_add_sorted"):
        x, one = k[name], one_device[name]
        log(f"sharded[kernels, shard {k['shard']} of a]: {name} "
            f"{x['ms']:.4f} ms (plain {x['plain_ms']:.4f}, library "
            f"{x['library_ms']:.4f}, bound {x['bound_ms']:.4f}) at p "
            f"{k['p']}, rows_loc {k['rows_loc']}, sentinel share "
            f"{k['sentinel_share']:.4f}, longest run {k['longest_run']}; "
            f"one-device {one['ms']:.4f} ms (bound {one['bound_ms']:.4f})")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded: runs a-c passed; phase {out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 18: graph-learning mode on the sorted kernels
# ---------------------------------------------------------------------------

GRAPH_NODES = 2_097_152            # feasigns 1..N: phases 10-11's key space
GRAPH_MEAN_DEGREE = 8              # ~16.8 M directed edges
GRAPH_ZIPF = 1.2
GRAPH_WALKS, GRAPH_WALK_LEN = 65_536, 8
GRAPH_WINDOW, GRAPH_NEGATIVES = 2, 5
GRAPH_LR = 0.05
GRAPH_BATCH = BATCH                # 16,384 pairs: the bench batch
GRAPH_RTOL = 1e-5
GRAPH_SYMBOLS = {k: SYMBOLS[k] for k in ("gather_sorted",
                                         "scatter_add_sorted")}


def power_law_graph(rng, n: int, mean_degree: int):
    """n · mean_degree directed edges over nodes 1..n whose endpoints
    are both drawn by one Zipf-1.2 popularity over a seeded permutation
    of the nodes (a Chung-Lu graph): out- and in-degrees follow the
    power law with the given mean, a few hubs hold most edges and most
    nodes have none.  Weights U(0.1, 1)."""
    m = n * mean_degree
    perm = rng.permutation(n).astype(np.int64) + 1
    src = perm[(rng.zipf(GRAPH_ZIPF, m) - 1) % n]
    dst = perm[(rng.zipf(GRAPH_ZIPF, m) - 1) % n]
    return np.stack([src, dst], 1), rng.uniform(0.1, 1.0, m)


def graph_engine(n: int, seed: int, device) -> BoxPSEngine:
    """A pass working set over keys 1..n with mf created (the graph
    table's nodes are the PS's feasigns)."""
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, sgd=SparseSGDConfig(
            mf_create_thresholds=0.0, mf_initial_range=0.1)),
        seed=seed, device=device)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, n + 1, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    eng.ws["mf_size"].fill_(MF_DIM)
    return eng


def graph_step_vs_cpu(mf_fm: torch.Tensor, g2: torch.Tensor,
                      centers: torch.Tensor, contexts: torch.Tensor,
                      negs: torch.Tensor, lr: float) -> dict:
    """One graph step on the card (updating ``mf_fm`` and ``g2``) held
    against the same step on the CPU, piece by piece: the loss within
    rtol 1e-5; the plan equal; the merged gradient (the card's sorted
    scatter of its per-occurrence gradients against the CPU's plain sum
    of its own) within rtol 1e-5 plus 1e-5 of each row's sum of |terms|,
    the sum's rounding bound; and the adagrad update of mf and mf_g2sum
    replayed on the CPU from the card's merged gradient within rtol 1e-5
    (atol 1e-7).  The update is replayed, as phase 7 replays its steps,
    because adagrad's first step divides each row's merged gradient by
    its own rms: a hub row whose thousands of terms cancel carries its
    sum's rounding (tiles on the card, a sequence on the CPU) to the
    update's scale."""
    from paddlebox_tpu_torch.trainer import graph_trainer as gt
    host = [t.to("cpu", copy=True)
            for t in (mf_fm, g2, centers, contexts, negs)]
    loss, pay, (rows2d, first_occ, dims) = gt.skipgram_grad(
        mf_fm, centers, contexts, negs)
    delta = sp.scatter_add_sorted(pay, rows2d, first_occ, dims)
    h_loss, h_pay, (h_rows2d, h_first, _) = gt.skipgram_grad(
        host[0], *host[2:])
    h_delta = sp.scatter_add_sorted_plain(h_pay, h_rows2d, h_first, dims)
    abs_sum = sp.scatter_add_sorted_plain(h_pay.abs(), h_rows2d, h_first,
                                          dims)
    out = {"loss": float(loss), "cpu_loss": float(h_loss)}
    if not math.isclose(out["loss"], out["cpu_loss"], rel_tol=GRAPH_RTOL):
        raise AssertionError(f"graph step: loss card {out['loss']} vs CPU "
                             f"{out['cpu_loss']}")
    if not torch.equal(rows2d.cpu(), h_rows2d):
        raise AssertionError("graph step: the card's plan is not the CPU's")
    err = (delta.cpu() - h_delta).abs()
    if not bool((err <= GRAPH_RTOL * (h_delta.abs() + abs_sum)).all()):
        raise AssertionError(f"graph step: merged gradient card vs CPU: max "
                             f"err {float(err.max())}")
    out["delta_max_err"] = float(err.max())
    gt.adagrad_update(host[0], host[1], delta.cpu(), lr)
    gt.adagrad_update(mf_fm, g2, delta, lr)
    for name, card, want in (("mf", mf_fm, host[0]), ("mf_g2sum", g2,
                                                      host[1])):
        e = (card.cpu() - want).abs()
        if not bool((e <= GRAPH_RTOL * want.abs() + 1e-7).all()):
            raise AssertionError(f"graph step: {name} card vs CPU update: "
                                 f"max err {float(e.max())}")
        out[f"{name}_max_err"] = float(e.max())
    return out


def graph_first_step(eng, rows: np.ndarray, seed: int) -> dict:
    """The epoch's first batch as one step on the card from a copy of the
    pass state, held against the CPU by :func:`graph_step_vs_cpu` with
    the same negatives."""
    from paddlebox_tpu_torch.trainer import graph_trainer as gt
    dev = eng.device
    batch = torch.as_tensor(rows[:GRAPH_BATCH], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    negs = torch.randint(1, eng.num_keys + 1, (GRAPH_BATCH, GRAPH_NEGATIVES),
                         generator=gen, device=dev, dtype=torch.int32)
    mf_fm, g2 = gt.to_feature_major(eng.ws["mf"], eng.ws["mf_g2sum"])
    out = graph_step_vs_cpu(mf_fm, g2, batch[:, 0], batch[:, 1], negs,
                            GRAPH_LR)
    log(f"graph: first step card vs CPU: loss {out['loss']!r} / "
        f"{out['cpu_loss']!r}; merged gradient max err "
        f"{out['delta_max_err']:.3g} (rtol {GRAPH_RTOL:g} + {GRAPH_RTOL:g} "
        f"of the sum of |terms|); update from it: mf max err "
        f"{out['mf_max_err']:.3g}, mf_g2sum {out['mf_g2sum_max_err']:.3g}")
    out["negs"] = negs
    return out


def graph_kernels(table_fm: torch.Tensor, rows: np.ndarray,
                  negs: torch.Tensor, seed: int) -> dict:
    """Both sorted kernels on a graph step's plan (the first batch's
    centers, contexts and negatives, B·(2+K) rows) against their plain
    versions (:func:`graph_plan_kernels`)."""
    dev = table_fm.device
    batch = torch.as_tensor(rows[:GRAPH_BATCH], device=dev)
    ids = torch.cat([batch[:, 0], batch[:, 1], negs.reshape(-1)])
    dims = sp.spmm_dims(ids.numel(), table_fm.shape[1] - sp.TILE)
    return graph_plan_kernels("graph", table_fm, sp.build_plan(ids, dims),
                              dims, seed)


def graph_plan_kernels(what: str, table_fm: torch.Tensor, plan,
                       dims: sp.SpmmDims, seed: int) -> dict:
    """Both sorted kernels on a graph step's ``plan`` over the
    feature-major table ``table_fm`` against their plain versions by
    phase 2's method: the gather over the trained table bit-exact, the
    scatter over a seeded payload within rtol 1e-5 plus 1e-5 of each
    row's sum of |terms|, each twice bit-identical; device times beside
    index_select / index_add_ and the byte bound (the distinct rows this
    plan reads, the sentinel's among them)."""
    dev = table_fm.device
    w = table_fm.shape[0]
    rows2d, first_occ = plan[0], plan[7]
    flat = rows2d.reshape(-1)
    runs = torch.unique_consecutive(flat[:dims.p], return_counts=True)[1]
    n_unique = int(first_occ.sum().item())
    gen = torch.Generator(device=dev).manual_seed(seed)
    payload = torch.randn((w, dims.p_pad), generator=gen, device=dev)
    payload[:, dims.p:] = 0.0
    out = {"p": dims.p, "p_pad": dims.p_pad, "n_kernel": dims.n_kernel,
           "distinct_rows": n_unique, "longest_run": int(runs.max()),
           "hub_share": float(runs.max()) / dims.p}

    got = twice(f"{what} gather_sorted",
                lambda: sp.gather_sorted(table_fm, rows2d, dims))
    want = sp.gather_sorted_plain(table_fm, rows2d, dims)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: gather_sorted != plain")
    rows_l = flat.long()
    g = {"ms": time_ms(f"{what} gather_sorted",
                       lambda: sp.gather_sorted(table_fm, rows2d, dims)),
         "plain_ms": time_ms(f"{what} gather_sorted_plain",
                             lambda: sp.gather_sorted_plain(table_fm, rows2d,
                                                            dims)),
         "library_ms": time_ms(f"{what} index_select",
                               lambda: torch.index_select(table_fm, 1,
                                                          rows_l)),
         "max_abs_err": float((got - want).abs().max())}
    g["bound_ms"], g["bound_by"] = bound_ms(
        4 * dims.p_pad + 4 * w * n_unique + 4 * w * dims.p_pad, 0)

    got = twice(f"{what} scatter_add_sorted",
                lambda: sp.scatter_add_sorted(payload, rows2d, first_occ,
                                              dims))
    want = sp.scatter_add_sorted_plain(payload, rows2d, first_occ, dims)
    abs_sum = sp.scatter_add_sorted_plain(payload.abs(), rows2d, first_occ,
                                          dims)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 1e-5 * want.abs() + 1e-5 * abs_sum + 1e-6).all()):
        raise AssertionError(f"{what}: scatter_add_sorted != plain: max "
                             f"err {float(err.max())}")
    s = {"ms": time_ms(f"{what} scatter_add_sorted",
                       lambda: sp.scatter_add_sorted(payload, rows2d,
                                                     first_occ, dims)),
         "plain_ms": time_ms(f"{what} scatter_add_sorted_plain",
                             lambda: sp.scatter_add_sorted_plain(
                                 payload, rows2d, first_occ, dims)),
         "library_ms": time_ms(f"{what} index_add_", lambda: torch.zeros(
             (w, dims.n_kernel), device=dev).index_add_(1, rows_l, payload)),
         "max_abs_err": float(err.max())}
    s["bound_ms"], s["bound_by"] = bound_ms(
        4 * w * dims.p_pad + 4 * dims.p_pad + 4 * w * dims.n_kernel,
        w * dims.p)
    out["gather_sorted"], out["scatter_add_sorted"] = g, s
    log(f"{what}[kernels, W={w}]: p {dims.p}, distinct rows {n_unique}, "
        f"longest run {out['longest_run']} (hub share "
        f"{out['hub_share']:.4f}); gather {g['ms']:.4f} ms (plain "
        f"{g['plain_ms']:.4f}, index_select {g['library_ms']:.4f}, bound "
        f"{g['bound_ms']:.4f}); scatter {s['ms']:.4f} ms (plain "
        f"{s['plain_ms']:.4f}, index_add_ {s['library_ms']:.4f}, bound "
        f"{s['bound_ms']:.4f}); max err {g['max_abs_err']} / "
        f"{s['max_abs_err']}")
    return out


def graph_communities(device, seed: int = 0) -> dict:
    """The JAX package's two-community test on the card: 40 nodes, 8
    epochs of walks; intra-community cosine must beat inter by 0.2."""
    from paddlebox_tpu_torch.graph.graph_table import GraphTable
    from paddlebox_tpu_torch.trainer.graph_trainer import \
        GraphEmbeddingTrainer
    rng = np.random.default_rng(seed)
    size, n = 20, 40
    edges = [(a, b) for a in range(1, n + 1) for b in range(a + 1, n + 1)
             if rng.random() < (0.6 if (a <= size) == (b <= size) else 0.02)]
    edges = np.asarray(edges + [(b, a) for a, b in edges], np.int64)
    eng = graph_engine(n, seed, device)
    tr = GraphEmbeddingTrainer(eng, GraphTable(edges, num_nodes=n + 1,
                                               device=device),
                               n_negatives=4, learning_rate=0.1, window=2)
    losses = [tr.train_walks(np.tile(np.arange(1, n + 1), 6), length=6,
                             batch_size=2048, seed=s) for s in range(8)]
    emb = eng.ws["mf"].cpu().numpy()[eng.mapper(
        np.arange(1, n + 1, dtype=np.uint64))]
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    sim = emb @ emb.T
    intra = float((sim[:size, :size].mean() + sim[size:, size:].mean()) / 2)
    inter = float(sim[:size, size:].mean())
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and intra > inter + 0.2):
        raise AssertionError(f"graph: communities did not separate: losses "
                             f"{losses}, intra {intra}, inter {inter}")
    log(f"graph[communities]: losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"intra {intra:.4f} > inter {inter:.4f} + 0.2")
    return {"losses": losses, "intra": intra, "inter": inter}


def graph_phase(seed: int = 22, device: str = "cuda", keep: dict = None):
    """Phase 18: the graph-learning mode at the system's widths — a
    2,097,152-node power-law graph (the 2 M key space), node embeddings
    of mf_dim 8 as PS rows, one epoch of skip-gram pairs from 65,536
    walks inside one pass lifecycle, pull and push on the sorted
    kernels.  ``keep``: receives the graph and the first
    MODELS_GRAPH_STEPS batches of pair rows, phase 22's (k) input."""
    from paddlebox_tpu_torch.graph.graph_table import GraphTable
    from paddlebox_tpu_torch.trainer import graph_trainer as gt
    from paddlebox_tpu_torch.utils.profiler import Profiler
    dev = torch.device(device)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    out = {}
    t0 = time.perf_counter()
    edges, weights = power_law_graph(rng, GRAPH_NODES, GRAPH_MEAN_DEGREE)
    out["graph_gen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = GraphTable(edges, weights=weights, num_nodes=GRAPH_NODES + 1,
                       device=dev)
    torch.cuda.synchronize()
    out["csr_build_s"] = time.perf_counter() - t0
    deg = np.diff(graph.indptr.cpu().numpy())
    out["edges"], out["nodes_with_out_edges"] = graph.num_edges, int(
        (deg > 0).sum())
    out["max_out_degree"] = int(deg.max())
    del edges, weights

    t0 = time.perf_counter()
    eng = graph_engine(GRAPH_NODES, seed, dev)
    out["lifecycle_open_s"] = time.perf_counter() - t0
    tr = gt.GraphEmbeddingTrainer(eng, graph, n_negatives=GRAPH_NEGATIVES,
                                  learning_rate=GRAPH_LR,
                                  window=GRAPH_WINDOW, seed=seed)
    starts = rng.choice(np.nonzero(deg > 0)[0], GRAPH_WALKS)
    wgen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walks = graph.random_walk(torch.as_tensor(starts, device=dev),
                              GRAPH_WALK_LEN, wgen)
    torch.cuda.synchronize()
    out["walk_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rows = tr.pair_rows(gt.walk_pairs(walks, GRAPH_WINDOW))
    out["pair_rows_s"] = time.perf_counter() - t0
    out["pairs"] = len(rows)
    if keep is not None:
        keep.update(graph=graph,
                    rows=rows[:MODELS_GRAPH_STEPS * GRAPH_BATCH])
    log(f"graph: {GRAPH_NODES} nodes, {out['edges']} edges "
        f"({out['nodes_with_out_edges']} nodes with an out-edge, max "
        f"out-degree {out['max_out_degree']}); generate "
        f"{out['graph_gen_s']:.2f} s, CSR build {out['csr_build_s']:.2f} s, "
        f"pass lifecycle open {out['lifecycle_open_s']:.2f} s; "
        f"{GRAPH_WALKS} walks of {GRAPH_WALK_LEN} in {out['walk_ms']:.2f} "
        f"ms; {out['pairs']} pairs ({out['pair_rows_s']:.2f} s to pass "
        f"rows)")

    mf0, g20 = eng.ws["mf"].clone(), eng.ws["mf_g2sum"].clone()
    first = graph_first_step(eng, rows, seed + 1)
    # the layout the sorted gather reads: re-laid once an epoch (the
    # trainer's choice) against once a step
    out["feature_major_ms"] = time_ms(
        "graph to_feature_major",
        lambda: gt.to_feature_major(eng.ws["mf"], eng.ws["mf_g2sum"]))

    reset_counts()
    t0 = time.perf_counter()
    loss = tr.train_pairs(rows, batch_size=GRAPH_BATCH)
    torch.cuda.synchronize()
    out["epoch_s"] = time.perf_counter() - t0
    launches = read_counts()
    stats = dict(tr.stats)
    steps = len(stats["losses"])
    if launches != {"gather_sorted": steps, "scatter_add_sorted": steps,
                    "gather_pool": 0}:
        raise AssertionError(f"graph: launches {launches} over {steps} "
                             f"steps (want one of each sorted kernel a "
                             f"step, no gather_pool)")
    if not (np.isfinite(loss) and all(np.isfinite(stats["losses"]))):
        raise AssertionError(f"graph: non-finite losses {stats['losses']}")
    trained = (eng.ws["mf"].clone(), eng.ws["mf_g2sum"].clone())
    step_ms = float(np.median(stats["step_ms"]))
    out.update(steps=steps, mean_loss=loss, losses=stats["losses"],
               step_ms=stats["step_ms"], median_step_ms=step_ms,
               pairs_per_s=GRAPH_BATCH / (step_ms / 1e3),
               epoch_pairs_per_s=out["pairs"] / out["epoch_s"],
               first_step=first)
    if torch.equal(trained[0], mf0):
        raise AssertionError("graph: the epoch left mf as it was")

    # a rerun from the same state and seed, traced through the port's
    # Profiler: the same bits, and the device-busy share of its steps
    eng.ws["mf"].copy_(mf0)
    eng.ws["mf_g2sum"].copy_(g20)
    tr2 = gt.GraphEmbeddingTrainer(eng, graph, n_negatives=GRAPH_NEGATIVES,
                                   learning_rate=GRAPH_LR,
                                   window=GRAPH_WINDOW, seed=seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tdir:
        with Profiler(log_dir=tdir) as prof:
            tr2.train_pairs(rows, batch_size=GRAPH_BATCH)
        out["profile"] = profiled("graph", prof.profile, tr2.stats,
                                  GRAPH_SYMBOLS)
    if tr2.stats["losses"] != stats["losses"] or not (
            torch.equal(eng.ws["mf"], trained[0])
            and torch.equal(eng.ws["mf_g2sum"], trained[1])):
        raise AssertionError("graph: a rerun from the same seed left "
                             "other bits")
    out["kernels"] = graph_kernels(gt.to_feature_major(
        eng.ws["mf"], eng.ws["mf_g2sum"])[0], rows, first.pop("negs"),
        seed + 2)
    log(f"graph: epoch {steps} steps of {GRAPH_BATCH} pairs, mean loss "
        f"{loss:.5f} ({stats['losses'][0]:.5f} -> "
        f"{stats['losses'][-1]:.5f}); median step {step_ms:.4f} ms (CUDA "
        f"events), {out['pairs_per_s']:.0f} pairs/s; epoch "
        f"{out['epoch_s']:.3f} s ({out['epoch_pairs_per_s']:.0f} "
        f"pairs/s); to_feature_major {out['feature_major_ms']:.4f} ms (once "
        f"an epoch, not a step); launches {launches}; rerun bit-identical; "
        f"traced device busy {100 * out['profile']['busy_share']:.1f} %")

    # end_pass writes the trained rows back to the host table
    keys = np.unique(np.concatenate([
        rng.integers(1, GRAPH_NODES + 1, 4096),
        np.nonzero(deg > 0)[0][:64]])).astype(np.uint64)
    want = eng.ws["mf"][torch.as_tensor(eng.mapper(keys).astype(np.int64),
                                        device=dev)].cpu().numpy()
    t0 = time.perf_counter()
    eng.end_pass()
    out["end_pass_s"] = time.perf_counter() - t0
    back = eng.table.bulk_pull(keys)["mf"]
    if not np.array_equal(back, want):
        raise AssertionError("graph: end_pass did not write the trained "
                             "rows back to the host table")
    log(f"graph: end_pass wrote {GRAPH_NODES} rows back in "
        f"{out['end_pass_s']:.2f} s; {len(keys)} sampled keys read back bit "
        f"for bit")
    out["communities"] = graph_communities(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"graph: phase {out['phase_s']:.1f} s")
    return {"graph": launches}, out


# ---------------------------------------------------------------------------
# phase 19: the parallel layer library, every shard on the card
# ---------------------------------------------------------------------------

PAR_MP, PAR_EP, PAR_SP, PAR_PP = 4, 4, 4, 4
MLP_IN = N_SLOTS * (3 + MF_DIM) + DENSE_DIM   # 299: the bench MLP's input
PAR_VOCAB, PAR_EMB, PAR_CLASSES = 1_048_576, 64, 32_768
MOE_HIDDEN, MOE_EXPERTS, MOE_CF = 1600, 8, 2.5
ATTN_SHAPE = (2, 4096, 8, 64)               # B, T, H, Dh
PIPE_MICRO, PIPE_MB = 8, 2048
PAR_RTOL, PAR_ATOL = 1e-4, 2e-5


def event_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` calls of ``fn`` timed by CUDA events around
    each call after one warm call: device time with the host's gaps
    inside the call counted (these runs launch many small ops from
    Python)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def par_check(what: str, got, want, out: dict, rtol: float = PAR_RTOL,
              atol: float = PAR_ATOL, fns=None) -> None:
    """``got`` within rtol / atol of ``want``; records the max error and,
    with ``fns`` ({label: fn}), each one's ms."""
    pairs = (list(zip(got, want)) if isinstance(got, (list, tuple))
             else [(got, want)])
    err = 0.0
    for g, w in pairs:
        e = (g.detach() - w.detach()).abs()
        if not bool((e <= rtol * w.detach().abs() + atol).all()):
            raise AssertionError(f"parallel[{what}]: max err "
                                 f"{float(e.max())} (rtol {rtol:g}, atol "
                                 f"{atol:g})")
        err = max(err, float(e.max()))
    rec = {"max_abs_err": err}
    for label, fn in (fns or {}).items():
        rec[f"{label}_ms"] = event_ms(fn)
    out[what] = rec
    log(f"parallel[{what}]: max err {err:.3g}; " + ", ".join(
        f"{k} {v:.3f}" for k, v in rec.items() if k.endswith("_ms")))


def parallel_tp(dev, gen, out: dict) -> None:
    from paddlebox_tpu_torch.parallel import tp_layers as tp
    from paddlebox_tpu_torch.parallel.topology import (Spec, split_tree,
                                                       single_host_topology)
    topo = single_host_topology(device=dev, mp=PAR_MP)
    # the bench MLP's first two layers, Megatron-paired: 299 → 400 column
    # (output left split), relu, 400 → 400 row (input split)
    col = tp.ColumnParallelLinear(MLP_IN, HIDDEN[0], gather_output=False)
    row = tp.RowParallelLinear(HIDDEN[0], HIDDEN[1], input_is_parallel=True)
    pc, pr = col.init(gen), row.init(gen)
    pc["b"].normal_(generator=gen)
    pr["b"].normal_(generator=gen)
    x = torch.randn((BATCH, MLP_IN), generator=gen, device=dev)
    lc = split_tree(pc, col.param_specs(), topo)
    lr_ = split_tree(pr, row.param_specs(), topo)
    xs = topo.split(x, Spec())

    def sharded():
        hs = [torch.relu(h) for h in col.apply_sharded(lc, xs, topo)]
        return topo.join(row.apply_sharded(lr_, hs, topo), Spec())

    def dense():
        return row.apply(pr, torch.relu(col.apply(pc, x)))
    par_check("tp_mlp", sharded(), dense(), out,
              fns={"sharded": sharded, "dense": dense})

    emb = tp.VocabParallelEmbedding(PAR_VOCAB, PAR_EMB)
    pe = emb.init(gen)
    ids = torch.randint(0, PAR_VOCAB, (BATCH, N_SLOTS), generator=gen,
                        device=dev)
    le = split_tree(pe, emb.param_specs(), topo)
    ids_s = topo.split(ids, Spec())

    def emb_sharded():
        return topo.join(emb.apply_sharded(le, ids_s, topo), Spec())
    got = emb_sharded()
    if not torch.equal(got, emb.apply(pe, ids)):
        raise AssertionError("parallel[vocab_embedding]: the masked sum "
                             "over shards is not the dense lookup's bits")
    par_check("vocab_embedding", got, emb.apply(pe, ids), out, 0.0, 0.0,
              fns={"sharded": emb_sharded,
                   "dense": lambda: emb.apply(pe, ids)})

    logits = torch.randn((BATCH, PAR_CLASSES), generator=gen,
                         device=dev) * 2
    labels = torch.randint(0, PAR_CLASSES, (BATCH,), generator=gen,
                           device=dev)
    lg_s, lb_s = topo.split(logits, Spec(None, "mp")), topo.split(
        labels, Spec())

    def ce_sharded():
        return topo.join(tp.parallel_cross_entropy(lg_s, lb_s, topo), Spec())

    def ce_dense():
        return -torch.log_softmax(logits, -1)[torch.arange(BATCH,
                                                           device=dev),
                                              labels]
    par_check("cross_entropy", ce_sharded(), ce_dense(), out,
              fns={"sharded": ce_sharded, "dense": ce_dense})


def parallel_moe(dev, gen, out: dict) -> None:
    from paddlebox_tpu_torch.parallel import moe
    from paddlebox_tpu_torch.parallel.topology import (Spec, split_tree,
                                                       single_host_topology)
    topo = single_host_topology(device=dev, ep=PAR_EP)
    x = torch.randn((BATCH, HIDDEN[0]), generator=gen, device=dev)
    for gate, k in (("switch", 1), ("gshard", 2)):
        layer = moe.MoELayer(moe.MoEConfig(
            d_model=HIDDEN[0], d_hidden=MOE_HIDDEN, num_experts=MOE_EXPERTS,
            capacity_factor=MOE_CF, gate=gate))
        params = layer.init(gen)
        locs = split_tree(params, layer.param_specs(), topo)
        xs = topo.split(x, Spec("ep"))
        # no token may overflow its bucket in either layout, or the two
        # would drop different tokens
        fn = moe.GATES[gate]
        dense_kept = float(fn(x @ params["gate"],
                              layer.capacity(BATCH, 1))[0].sum())
        shard_kept = sum(float(fn(xx @ params["gate"], layer.capacity(
            xx.shape[0], PAR_EP))[0].sum()) for xx in xs)
        if dense_kept != k * BATCH or shard_kept != k * BATCH:
            raise AssertionError(f"parallel[moe_{gate}]: tokens dropped "
                                 f"(kept {dense_kept} / {shard_kept} of "
                                 f"{k * BATCH})")

        def sharded():
            ys, _ = layer.apply_sharded(locs, xs, topo, ep=PAR_EP)
            return topo.join(ys, Spec("ep"))

        def dense():
            return layer.apply_dense(params, x)[0]
        par_check(f"moe_{gate}", sharded(), dense(), out,
                  fns={"sharded": sharded, "dense": dense})


def parallel_attention(dev, gen, out: dict) -> None:
    from paddlebox_tpu_torch.parallel import ring_attention as ra
    from paddlebox_tpu_torch.parallel import ulysses
    from paddlebox_tpu_torch.parallel.topology import (Spec,
                                                       single_host_topology)
    topo = single_host_topology(device=dev, sp=PAR_SP)
    q, k, v = (torch.randn(ATTN_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    spec = Spec(None, "sp")
    qs, ks, vs = (topo.split(t, spec) for t in (q, k, v))
    for causal in (False, True):
        tag = "causal" if causal else "full"

        def dense():
            return ra.reference_attention(q, k, v, causal=causal)

        def ring():
            return topo.join(ra.ring_attention(qs, ks, vs, topo, "sp",
                                               PAR_SP, causal=causal), spec)

        def uly():
            return topo.join(ulysses.ulysses_attention(
                qs, ks, vs, topo, "sp", causal=causal), spec)
        want = dense()
        par_check(f"ring_{tag}", ring(), want, out,
                  fns={"sharded": ring, "dense": dense})
        par_check(f"ulysses_{tag}", uly(), want, out,
                  fns={"sharded": uly})


def pipe_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def parallel_pipelines(dev, gen, out: dict) -> None:
    from paddlebox_tpu_torch.parallel import pipeline as pl
    from paddlebox_tpu_torch.parallel.topology import (Spec, join_tree,
                                                       split_tree,
                                                       single_host_topology)
    topo = single_host_topology(device=dev, pp=PAR_PP)
    d = HIDDEN[0]
    per_stage = [{"w": torch.randn((d, d), generator=gen, device=dev)
                  * d ** -0.5,
                  "b": torch.randn((d,), generator=gen, device=dev) * 0.1}
                 for _ in range(PAR_PP)]
    micro = torch.randn((PIPE_MICRO, PIPE_MB, d), generator=gen, device=dev)
    tgt = torch.randn((PIPE_MICRO, PIPE_MB, d), generator=gen, device=dev)
    stacked = pl.stack_stage_params(per_stage)
    rep = topo.split(micro, Spec())

    def sequential(params):
        ys = []
        for m in range(PIPE_MICRO):
            y = micro[m]
            for p in params:
                y = pipe_stage(p, y)
            ys.append(y)
        return torch.stack(ys)

    gpipe = pl.PipelineRunner(pipe_stage, PAR_PP)

    def gpipe_fwd(params=stacked):
        return topo.join(gpipe(split_tree(params, Spec("pp"), topo), rep,
                               topo), Spec())
    with torch.no_grad():
        par_check("gpipe_forward", gpipe_fwd(), sequential(per_stage), out,
                  fns={"pipelined": gpipe_fwd,
                       "sequential": lambda: sequential(per_stage)})

    def mse_grads(run):
        params = {n: v.clone().requires_grad_() for n, v in stacked.items()}
        loss = ((run(params) - tgt) ** 2).mean()
        return torch.autograd.grad(loss, list(params.values()))

    def seq_of(params):
        return sequential([{n: v[i] for n, v in params.items()}
                           for i in range(PAR_PP)])
    par_check("gpipe_backward", mse_grads(gpipe_fwd), mse_grads(seq_of), out,
              fns={"pipelined": lambda: mse_grads(gpipe_fwd),
                   "sequential": lambda: mse_grads(seq_of)})

    def mse(y, t):
        return ((y - t) ** 2).mean()
    f1b = pl.PipelineRunner1F1B(pipe_stage, mse, PAR_PP)
    tgt_rep = topo.split(tgt, Spec())

    def run_1f1b():
        losses, grads = f1b(split_tree(stacked, Spec("pp"), topo), rep,
                            tgt_rep, topo)
        g = join_tree(grads, Spec("pp"), topo)
        return [losses[0]] + [g[n] for n in stacked]

    def seq_1f1b():
        params = {n: v.clone().requires_grad_() for n, v in stacked.items()}
        ys = seq_of(params)
        loss = sum(mse(ys[m], tgt[m]) for m in range(PIPE_MICRO)) / PIPE_MICRO
        return [loss.detach()] + list(torch.autograd.grad(
            loss, list(params.values())))
    par_check("1f1b", run_1f1b(), seq_1f1b(), out,
              fns={"pipelined": run_1f1b, "sequential": seq_1f1b})
    if not f1b.peak_stash <= f1b.stash_slots < PIPE_MICRO + 1:
        raise AssertionError(f"parallel[1f1b]: stash peak {f1b.peak_stash}"
                             f" of {f1b.stash_slots} slots")
    out["1f1b"]["peak_stash"] = f1b.peak_stash

    # hetero 1F1B over the bench MLP chain 299 → 400 → 400 → 400 → 1
    widths = [MLP_IN, *HIDDEN, 1]
    hparams = tuple({"w": torch.randn((widths[i], widths[i + 1]),
                                      generator=gen, device=dev)
                     * widths[i] ** -0.5,
                     "b": torch.zeros((widths[i + 1],), device=dev)}
                    for i in range(PAR_PP))

    def mk(i):
        def fn(p, x):
            y = x @ p["w"] + p["b"]
            return torch.relu(y) if i < PAR_PP - 1 else y
        return fn
    fns = [mk(i) for i in range(PAR_PP)]
    hx = torch.randn((PIPE_MICRO, PIPE_MB, widths[0]), generator=gen,
                     device=dev)
    hy = torch.randint(0, 2, (PIPE_MICRO, PIPE_MB, 1), generator=gen,
                       device=dev).float()

    def bce(y, t):
        return torch.nn.functional.binary_cross_entropy_with_logits(y, t)
    hetero = pl.HeteroPipeline1F1B(fns, [(PIPE_MB, w) for w in widths], bce)

    def run_hetero():
        losses, grads = hetero(hparams, topo.split(hx, Spec()),
                               topo.split(hy, Spec()), topo)
        return [losses[0]] + [g[n] for g in grads[0] for n in ("w", "b")]

    def serial_hetero():
        ps = [{n: v.clone().requires_grad_() for n, v in p.items()}
              for p in hparams]
        tot = 0.0
        for m in range(PIPE_MICRO):
            y = hx[m]
            for i in range(PAR_PP):
                y = fns[i](ps[i], y)
            tot = tot + bce(y, hy[m])
        loss = tot / PIPE_MICRO
        return [loss.detach()] + list(torch.autograd.grad(
            loss, [p[n] for p in ps for n in ("w", "b")]))
    par_check("hetero_1f1b", run_hetero(), serial_hetero(), out,
              fns={"pipelined": run_hetero, "sequential": serial_hetero})

    # the fleet executor: a DAG whose compute nodes run the stages
    from paddlebox_tpu_torch.runtime.fleet_executor import (FleetExecutor,
                                                            TaskNode)

    def dag():
        nodes = [TaskNode(0, "source", downstream=[1], max_runs=PIPE_MICRO)]
        for i, p in enumerate(per_stage):
            nodes.append(TaskNode(i + 1, "compute", upstream=[i],
                                  downstream=[i + 2],
                                  fn=lambda x, p=p: pipe_stage(p, x)))
        nodes.append(TaskNode(PAR_PP + 1, "sink", upstream=[PAR_PP]))
        with torch.no_grad():
            res = FleetExecutor(nodes, source_generator=lambda m: micro[m]
                                ).run(timeout=120)
        torch.cuda.synchronize()
        return torch.stack(res)
    with torch.no_grad():
        serial = sequential(per_stage)
    got = dag()
    par_check("fleet_executor", got, serial, out,
              fns={"dag": dag, "serial": lambda: sequential(per_stage)})
    out["fleet_executor"]["bit_equal"] = bool(torch.equal(got, serial))


def parallel_phase(seed: int = 23):
    """Phase 19: the parallel layer library with every shard on the card
    (``single_host_topology``), each run held against its dense or
    sequential counterpart on the card with TF32 off (rtol 1e-4, atol
    2e-5), ms for each."""
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    reset_counts()
    try:
        parallel_tp(dev, gen, out)
        parallel_moe(dev, gen, out)
        parallel_attention(dev, gen, out)
        parallel_pipelines(dev, gen, out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel: {len(out) - 1} runs passed; phase {out['phase_s']:.1f} s")
    return {"parallel": read_counts()}, out


# ---------------------------------------------------------------------------
# phase 20: mxu_sharded with its shards on distinct devices
# ---------------------------------------------------------------------------

# (run, mesh degrees, the shards' devices): the card beside the host is a
# test topology for a machine with one card (the host shards run the
# kernels' plain versions because their tensors live in host memory);
# with two or more cards, (c) repeats both meshes over cuda:0 and cuda:1
MULTICARD_RUNS = (("a", {"dp": 2}, ("cuda:0", "cpu")),
                  ("b", {"dp": 2, "sharding": 2},
                   ("cuda:0", "cuda:0", "cpu", "cpu")))
MULTICARD_TWO = (("c_flat", {"dp": 2}, ("cuda:0", "cuda:1")),
                 ("c_multinode", {"dp": 2, "sharding": 2},
                  ("cuda:0", "cuda:0", "cuda:1", "cuda:1")))


def host_ws(ws: dict) -> dict:
    """The working set on the host, a ``Sharded`` field's blocks joined
    in row order."""
    from paddlebox_tpu_torch.parallel.topology import Sharded
    return {k: torch.as_tensor(np.asarray(v)) if isinstance(v, Sharded)
            else v.cpu() for k, v in ws.items()}


def ws_by_device(ws: dict) -> dict:
    """Bytes of a working set on each device, from the tensors' own
    sizes."""
    from paddlebox_tpu_torch.parallel.topology import Sharded
    out = {}
    for v in ws.values():
        per = (v.bytes_by_device() if isinstance(v, Sharded)
               else {str(v.device): v.numel() * v.element_size()})
        for d, n in per.items():
            out[d] = out.get(d, 0) + n
    return out


def card_bytes(engine, feed) -> dict:
    """Bytes of the working set and of the feed (planes and plans) on
    each device, from the tensors' own sizes."""
    return {"ws": ws_by_device(engine.ws), "feed": feed.bytes_by_device()}


def check_table_replicas(engine) -> None:
    """Under dp × sharding each node holds a replica of each table
    block: the replicas on distinct devices must be bit-equal."""
    from paddlebox_tpu_torch.parallel.topology import Sharded
    for name, v in engine.ws.items():
        if not isinstance(v, Sharded):
            continue
        first = {}
        for k, blk in v.unique():
            row0 = v.rows(k).start
            if row0 not in first:
                first[row0] = blk
            elif not torch.equal(blk.cpu(), first[row0].cpu()):
                raise AssertionError(f"multicard: the replicas of {name}'s "
                                     f"block at row {row0} differ")


def multicard_pass(block, params, mesh, devices=None, around=None,
                   hold=None):
    """One packed mxu_sharded pass over ``devices`` (None: every shard on
    the card), the table blocks' replicas checked bit-equal after every
    step: (stats, the working set on the host before end_pass, bytes by
    device, the card's allocator growth over the engine and the feed,
    build_pass_feed seconds, dense replicas).  ``hold``: receives the
    feed and the trained working set."""
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(0)
    engine, trainer, dataset, _ = make_trainer(
        block, "cuda", params, "auto", mesh=mesh,
        devices=None if devices is None else list(devices))
    t0 = time.perf_counter()
    feed = trainer.build_pass_feed(dataset)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    alloc = torch.cuda.memory_allocated(0) - m0
    nbytes = card_bytes(engine, feed)
    if trainer._resolve_path() != "mxu_sharded":
        raise AssertionError(f"multicard: auto resolved to "
                             f"{trainer._resolve_path()}")
    if devices is not None:
        check_placement(trainer, engine, feed)
    with (around or contextlib.nullcontext)():
        stats = trainer.train_pass(
            feed, progress=(None if devices is None or around is not None
                            else lambda i: check_table_replicas(engine)))
    torch.cuda.synchronize()
    ws = host_ws(engine.ws)
    if hold is not None:
        hold["feed"], hold["ws"] = feed, dict(engine.ws)
    reps = trainer.dense_replicas()
    for r in reps[1:]:
        for a, b in zip(reps[0].parameters(), r.parameters()):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError("multicard: the dense replicas differ")
    engine.end_pass()
    if engine.table.size() != engine.num_keys:
        raise AssertionError("multicard: end_pass did not write every key")
    return stats, ws, nbytes, alloc, build_s, len(reps)


def check_placement(trainer, engine, feed) -> None:
    """Each shard's working-set block, feed planes and plans on its
    shard's device."""
    from paddlebox_tpu_torch.parallel.topology import same_device
    topo = trainer.topology
    for name, v in list(engine.ws.items()) + list(feed.data.items()):
        for k, part in enumerate(v.parts):
            if not same_device(part.device, topo.device_of(k)):
                raise AssertionError(f"multicard: {name} block {k} on "
                                     f"{part.device}, its shard on "
                                     f"{topo.device_of(k)}")
    for name, parts in (feed.plans or {}).items():
        for i, part in enumerate(parts):
            k = i if feed.plan_shards is None else feed.plan_shards[i]
            if not same_device(part.device, topo.device_of(k)):
                raise AssertionError(f"multicard: plan {name} of shard {k} "
                                     f"on {part.device}")


def multicard_close(what: str, got: dict, ws: dict, ref: dict,
                    ws_ref: dict) -> dict:
    """Losses within rtol 1e-4 and the working set within rtol 1e-5 /
    atol 1e-6 of the same mesh on one card (mf_size equal, the slot
    column's touched rows equal)."""
    first = [got["losses"][0], ref["losses"][0]]
    if not np.allclose(got["losses"], ref["losses"], rtol=1e-4, atol=0):
        raise AssertionError(f"{what}: losses {got['losses']} vs one card "
                             f"{ref['losses']}")
    worst = {}
    for k, want in ws_ref.items():
        a, b = ws[k].numpy(), want.numpy()
        if k == "slot":
            ok = np.array_equal(a != 0, b != 0)
        elif b.dtype == np.int32:
            ok = np.array_equal(a, b)
        else:
            ok = np.allclose(a, b, rtol=1e-5, atol=1e-6)
            worst[k] = float(np.abs(a - b).max())
        if not ok:
            raise AssertionError(f"{what}: working-set field {k} differs "
                                 "from the same mesh on one card")
    return {"first_loss": first, "ws_max_abs_diff": worst}


def multicard_phase(block: SlotRecordBlock, params0):
    """mxu_sharded with its shards on distinct devices at the bench
    widths on the packed phase's data and weights: ``MULTICARD_RUNS``
    (a) dp 2 over the card and the host, (b) dp 2 × sharding 2 with one
    node on each, and with two or more cards ``MULTICARD_TWO`` over
    cuda:0 and cuda:1.  Each: every block, plane and plan on its shard's
    device; the card's bytes beside the same mesh on one card; each
    sorted kernel exactly once a card shard a step and gather_pool never;
    the losses and working set within rtol 1e-4 / 1e-5 of the same mesh
    on one card; the dense replicas bit-equal, the table blocks' replicas
    bit-equal after every step; a rerun (traced) leaves the same bits;
    both sorted kernels at the run's shape (:func:`sharded_kernels` on
    the last card shard)."""
    t_phase = time.perf_counter()
    runs = MULTICARD_RUNS
    if torch.cuda.device_count() >= 2:
        runs += MULTICARD_TWO
    launches, out, refs = {}, {"cards": torch.cuda.device_count()}, {}
    for label, mesh, devices in runs:
        what = f"multicard[{label}]"
        key = tuple(sorted(mesh.items()))
        if key not in refs:
            refs[key] = multicard_pass(block, params0, mesh)
        ref, ws_ref, bytes_ref, alloc_ref, _, _ = refs[key]
        card_shards = sum(d.startswith("cuda") for d in devices)
        hold = {}
        reset_counts()
        stats, ws, nbytes, alloc, build_s, n_reps = multicard_pass(
            block, params0, mesh, devices, hold=hold)
        launches[label] = read_counts()
        check_pass(what, stats, launches[label],
                   {"gather_sorted": card_shards,
                    "scatter_add_sorted": card_shards, "gather_pool": 0},
                   exact=True)
        close = multicard_close(what, stats, ws, ref, ws_ref)
        # both kernels at this run's shape: the last shard on cuda:0 (the
        # card the timers read), its block and resident plan of batch 0
        shard = max(k for k, d in enumerate(devices) if d == "cuda:0")
        plans = hold["feed"].plans
        kern = sharded_kernels(
            what, {f: v.parts[shard] for f, v in hold["ws"].items()},
            plans["rows2d"][shard][0], plans["first_occ"][shard][0],
            plans["inv_perm"][shard].shape[1], shard)
        del hold
        holder = {}
        again, ws2, _, _, _, _ = multicard_pass(
            block, params0, mesh, devices, around=tracer(holder))
        if again["losses"] != stats["losses"] or any(
                not torch.equal(ws[k], ws2[k]) for k in ws):
            raise AssertionError(f"{what}: a rerun left other bits")
        steady = float(np.median(stats["step_ms"][1:]))
        prof = profiled(what, holder["prof"], again)
        host = any(d == "cpu" for d in devices)
        out[label] = {
            "mesh": mesh, "devices": list(devices), "replicas": n_reps,
            "losses": stats["losses"], "auc": stats["auc"], **close,
            "step_ms": stats["step_ms"], "steady_step_ms": steady,
            "one_card_steady_step_ms": float(np.median(ref["step_ms"][1:])),
            "bytes": nbytes, "one_card_bytes": bytes_ref,
            "card_alloc_bytes": alloc, "one_card_alloc_bytes": alloc_ref,
            "build_pass_feed_s": build_s, "launches": launches[label],
            "busy_share": prof["busy_share"], "profile": prof,
            "host_bound": host, "deterministic": True, "kernels": kern}
        card = "cuda:0"
        log(f"{what}: devices {list(devices)} (mesh {mesh}, "
            f"{n_reps} dense replicas), losses {stats['losses']} vs one "
            f"card {ref['losses']}, ws max |diff| "
            f"{close['ws_max_abs_diff']}, launches {launches[label]} "
            f"({card_shards} card shards x {N_BATCHES} steps); on {card}: "
            f"working set {nbytes['ws'].get(card, 0) / 2**20:.1f} MiB + "
            f"feed {nbytes['feed'].get(card, 0) / 2**20:.1f} MiB "
            f"(allocator +{alloc / 2**20:.1f} MiB) vs one card "
            f"{bytes_ref['ws'].get(card, 0) / 2**20:.1f} + "
            f"{bytes_ref['feed'].get(card, 0) / 2**20:.1f} MiB (allocator "
            f"+{alloc_ref / 2**20:.1f} MiB); step device ms "
            f"{stats['step_ms']} (steady median {steady:.3f}, one card "
            f"{out[label]['one_card_steady_step_ms']:.3f}), device busy "
            f"{100 * prof['busy_share']:.1f} %, build_pass_feed "
            f"{build_s:.2f} s; rerun bit-identical; {card_line()}"
            + ("; a host shard bounds this step: it is no multi-card "
               "speed" if host else ""))
        for name in ("gather_sorted", "scatter_add_sorted"):
            x = kern[name]
            log(f"{what}[kernels, shard {shard} on {devices[shard]}]: "
                f"{name} {x['ms']:.4f} ms (plain {x['plain_ms']:.4f}, "
                f"library {x['library_ms']:.4f}, bound {x['bound_ms']:.4f}) "
                f"at p {kern['p']}, rows_loc {kern['rows_loc']}, sentinel "
                f"share {kern['sentinel_share']:.4f}, longest run "
                f"{kern['longest_run']}; max |err| {x['max_abs_err']:.3g}; "
                f"{card_line()}")
    if len(runs) == len(MULTICARD_RUNS):
        log("multicard: runs c_flat and c_multinode need two cards; this "
            "machine has 1")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multicard: runs {[r[0] for r in runs]} passed; phase "
        f"{out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 21: the one-device lowerings and the device cache on distinct devices
# ---------------------------------------------------------------------------

# (run, sparse_path, rule, mesh degrees, the shards' devices — "card"
# for the card, "host" for the host — the lowering it resolves to, per
# card row block a step: gather_sorted, scatter_add_sorted, gather_pool
# launches).  (f) is the exact step under adagrad (what fast_path=False
# gives): under Adam a first update is about lr·sign(g), so a gradient
# near 0 that the card and the host round apart steps either way and no
# tolerance holds the host's block against one card (phase 6 replays
# each step for that reason); the CPU tests hold the block rules under
# Adam against the JAX package

PATHS_RUNS = (("d", "fast", "adagrad", {"dp": 2}, ("card", "host"),
               "fast", (0, 1, 1)),
              ("e", "auto", "adagrad", {"dp": 2, "mp": 2},
               ("card", "card", "host", "host"), "fast", (0, 1, 1)),
              ("f", "reference", "adagrad", {"dp": 2}, ("card", "host"),
               "reference", (0, 1, 0)),
              ("g", "mxu", "adagrad", {"dp": 2}, ("card", "host"),
               "mxu", (1, 1, 0)))
PATHS_TWO = (("d2", "fast", "adagrad", {"dp": 2}, ("cuda:0", "cuda:1"),
              "fast", (0, 1, 1)),
             ("g2", "mxu", "adagrad", {"dp": 2}, ("cuda:0", "cuda:1"),
              "mxu", (1, 1, 0)))
# (h): one day of PATHS_DAY_PASSES passes of PATHS_DAY_BATCHES batches on
# dp 2 over the card and the host (auto → mxu_sharded): the cache off,
# then on serially, then on prefetched (pass 3 is the prefetcher's first
# warm pass: pass N + 1's snapshot predates pass N's fold-back)
PATHS_DAY_PASSES, PATHS_DAY_BATCHES = 3, 1
# batches of the packed phase's pass that runs (d)-(g) train: N_BATCHES
# until the whole script reached 91 % of its time limit on a slower host
PATHS_BATCHES = 2


def paths_pass(block, params, mesh, devices, path, optimizer, device):
    """One packed pass of ``path`` over ``mesh`` (``devices``: one a
    shard, None: every shard on ``device``), end_pass included: (stats
    with the bytes of the working set and the feed on each device, the
    working set on the host before end_pass, the engine's working set,
    the feed, the trainer)."""
    engine, trainer, dataset, _ = make_trainer(
        block, device, params, path, optimizer=optimizer, mesh=mesh,
        devices=None if devices is None else list(devices))
    feed = trainer.build_pass_feed(dataset)
    if devices is not None:
        check_placement(trainer, engine, feed)
    stats = trainer.train_pass(feed)
    stats["path"] = trainer._resolve_path()
    stats["bytes"] = card_bytes(engine, feed)
    ws = host_ws(engine.ws)
    held = dict(engine.ws)
    engine.end_pass()
    if engine.table.size() != engine.num_keys:
        raise AssertionError("multicard_paths: end_pass did not write "
                             "every key")
    return stats, ws, held, feed, trainer


def batch_ids(feed, trainer, i: int) -> tuple:
    """Batch ``i``'s whole ids [S, L, B] and lengths [S, B] on the host,
    joined from the batch blocks' columns."""
    owners, _ = trainer._batch_owners()
    idx = torch.cat([feed.data["indices"].parts[k][i].cpu()
                     for k in owners], dim=2)
    lens = torch.cat([feed.data["lengths"].parts[k][i].cpu()
                      for k in owners], dim=1)
    return idx, lens


def block_gather_pool(what: str, block: dict, row0: int, idx, lens,
                      dev) -> dict:
    """gather_pool at a card row block's shape: the block's pull table
    (its rows and the zero row) over the whole batch's ids localized to
    it, against the plain version (bit-equal), timed beside
    ``embedding_bag``."""
    from paddlebox_tpu_torch.ps import embedding as emb
    from paddlebox_tpu_torch.ps import fast_path
    n = block["show"].shape[0]
    table = fast_path._pull_table(block, zero_row=True)
    s, l, b = idx.shape
    local, _ = emb.localize(idx.to(dev), row0, n)
    rows = local.permute(0, 2, 1).reshape(s * b, l).to(torch.int32)
    rows = rows.contiguous()
    lengths = lens.to(dev).reshape(s * b).to(torch.int32).contiguous()
    got = twice(f"{what} gather_pool",
                lambda: pg.gather_pool(table, rows, lengths))
    want = pg.gather_pool_plain(table, rows, lengths)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: gather_pool != plain")
    live = (torch.arange(l, device=dev)[None, :]
            < lengths[:, None].long())
    mask = live.to(torch.float32)
    dense = table.contiguous()
    rows_l = rows.long()
    live_rows = rows_l[live]
    n_rows = int(torch.unique(live_rows).numel())
    k = {"ms": time_ms(f"{what} gather_pool",
                       lambda: pg.gather_pool(table, rows, lengths)),
         "plain_ms": time_ms(f"{what} gather_pool_plain",
                             lambda: pg.gather_pool_plain(table, rows,
                                                          lengths)),
         "library_ms": time_ms(
             f"{what} embedding_bag",
             lambda: torch.nn.functional.embedding_bag(
                 rows_l, dense, mode="sum", per_sample_weights=mask)),
         "max_abs_err": float((got - want).abs().max()),
         "rows": n + 1, "pooled_rows": s * b, "distinct_rows": n_rows,
         "zero_row_share": float((live_rows == n).float().mean())}
    k["bound_ms"], k["bound_by"] = bound_ms(
        4 * s * b * l + 4 * s * b + 4 * W_POOL * n_rows
        + 4 * W_POOL * s * b, W_POOL * int(live.sum()))
    return k


def paths_kernels(what: str, path: str, held: dict, feed, trainer,
                  dev) -> dict:
    """Every kernel of the run's lowering on the first row block of the
    trained working set on ``dev`` (the card), over batch 0, against its
    plain version:
    fast, gather_pool (:func:`block_gather_pool`) and the merge's
    scatter; mxu, both sorted kernels on the block's resident plan;
    reference, the merge's scatter (:func:`sharded_kernels`)."""
    from paddlebox_tpu_torch.parallel.topology import device_key
    from paddlebox_tpu_torch.ps import embedding as emb
    topo = trainer.topology
    k, sl = next((k, sl) for k, sl, _ in held["show"].row_blocks()
                 if device_key(topo.device_of(k)) == device_key(dev))
    block = {f: v.parts[k] for f, v in held.items()}
    n = sl.stop - sl.start
    idx, lens = batch_ids(feed, trainer, 0)
    out = {"shard": k, "row0": sl.start, "rows": n}
    if path == "mxu":
        i = feed.plan_shards.index(k)
        out.update(sharded_kernels(
            what, block, feed.plans["rows2d"][i][0],
            feed.plans["first_occ"][i][0],
            feed.plans["inv_perm"][i].shape[1], k))
        return out
    # the merge's plan as the step builds it: fast parks the ids the
    # block does not hold, and padding, at local row 0 (their values are
    # zero); reference merges them into a spare row n, cut off
    live = (torch.arange(idx.shape[1])[None, :, None] < lens[:, None, :])
    flat = torch.where(live, idx, torch.zeros_like(idx))
    if path == "reference":
        flat = flat.permute(0, 2, 1)
    local, own = emb.localize(flat.reshape(-1).to(dev), sl.start, n)
    n_seg = n + 1
    if path == "fast":
        keep = own & live.reshape(-1).to(dev)
        local, n_seg = torch.where(keep, local, torch.zeros_like(local)), n
    dims = sp.spmm_dims(local.numel(), n_seg)
    plan = sp.build_plan(local.to(torch.int32), dims)
    out.update(sharded_kernels(what, block, plan[0], plan[7], dims.p, k,
                               rows_loc=n_seg, w_push=3 + MF_DIM,
                               names=("scatter_add_sorted",)))
    if path == "fast":
        out["gather_pool"] = block_gather_pool(what, block, sl.start, idx,
                                               lens, dev)
    return out


def multicard_day(blocks, devices, prefetch: bool, device: str):
    """One day of ``blocks`` (one a pass) on dp 2 over ``devices`` through
    the engine lifecycle, serially or through PassPrefetcher: the world
    it left and per pass the cache hits and the rows copied between the
    cache's store and the blocks."""
    from paddlebox_tpu_torch.config import MeshConfig
    from paddlebox_tpu_torch.data.prefetch import PassPrefetcher
    from paddlebox_tpu_torch.parallel.topology import HybridTopology
    from paddlebox_tpu_torch.utils.monitor import stat_get
    topo = HybridTopology(MeshConfig(dp=2), devices=list(devices))
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0,
        device=device, topology=topo)
    trainer = SparseTrainer(engine, make_model("deepfm"), feed_config(),
                            batch_size=BATCH, seed=0, device=device,
                            topology=topo)
    keys = ("ps.cache.hits", "ps.cache.device_copy_rows")
    prev = {k: stat_get(k) for k in keys}
    losses, per_pass = [], []

    def ended():
        cur = {k: stat_get(k) for k in keys}
        per_pass.append({k.split(".")[-1]: cur[k] - prev[k] for k in keys})
        prev.update(cur)

    date = LIFE_DATES[0]
    if not prefetch:
        engine.set_date(date)
        for block in blocks:
            engine.begin_feed_pass()
            engine.add_keys(block.all_keys())
            engine.end_feed_pass()
            engine.begin_pass()
            if trainer._resolve_path() != "mxu_sharded":
                raise AssertionError("multicard_paths[h]: auto resolved to "
                                     f"{trainer._resolve_path()}")
            feed = trainer.build_pass_feed(one_pass_dataset(block))
            losses.append(trainer.train_pass(feed)["losses"])
            engine.end_pass()
            ended()
    else:
        with PassPrefetcher(engine, trainer) as pre:
            for block in blocks:
                def load(block=block):
                    engine.add_keys(block.all_keys())
                    return one_pass_dataset(block)
                pre.submit(load, tag=date, date=date)
            for _ in blocks:
                losses.append(trainer.train_pass(pre.next_pass())["losses"])
                pre.end_pass()
                ended()
    return world_of(engine, trainer, losses), per_pass


def paths_day(block: SlotRecordBlock, device: str, host: str) -> tuple:
    """(h): the day with the cache off, then on serially, then on
    prefetched; all three leave the same bits, the warm passes hit and
    their hits on the host's block cross as copies."""
    rng = np.random.default_rng(24)
    blocks = [make_block(rng, PATHS_DAY_BATCHES * BATCH)
              for _ in range(PATHS_DAY_PASSES)]
    devices = (device, host)
    launches, out, worlds = {}, {}, {}
    for name, rows, prefetch in (("cache_off", 0, False),
                                 ("cache_on", CACHE_ROWS, False),
                                 ("cache_on_prefetch", CACHE_ROWS, True)):
        t0 = time.perf_counter()
        reset_counts()
        with engine_flags(rows):
            worlds[name], per_pass = multicard_day(blocks, devices, prefetch,
                                                   device)
        launches[name] = read_counts()
        want = PATHS_DAY_PASSES * PATHS_DAY_BATCHES
        if device.startswith("cuda") and launches[name] != {
                "gather_sorted": want, "scatter_add_sorted": want,
                "gather_pool": 0}:
            raise AssertionError(f"multicard_paths[h,{name}]: launches "
                                 f"{launches[name]} for {want} steps of "
                                 "one card shard")
        if rows:
            warm = [2] if prefetch else [1, 2]
            if any(per_pass[i]["hits"] <= 0 for i in warm) or \
                    per_pass[0]["hits"]:
                raise AssertionError(f"multicard_paths[h,{name}]: hits per "
                                     f"pass {per_pass}")
            if sum(p["device_copy_rows"] for p in per_pass) <= 0:
                raise AssertionError(f"multicard_paths[h,{name}]: no row "
                                     "crossed between the store and the "
                                     "host's block")
        out[name] = {"per_pass": per_pass, "wall_s": time.perf_counter() - t0,
                     "losses": worlds[name]["losses"]}
    same_world("multicard_paths[h] cache on vs off", worlds["cache_off"],
               worlds["cache_on"])
    same_world("multicard_paths[h] prefetched vs serial", worlds["cache_on"],
               worlds["cache_on_prefetch"])
    return launches, out


def multicard_paths_phase(block: SlotRecordBlock, params0,
                          device: str = "cuda", host: str = "cpu"):
    """Explicit fast, mxu and reference, auto on dp 2 × mp 2 and the
    day loop's device cache with the shards on distinct devices, on the
    packed phase's data and weights at the bench widths (``PATHS_RUNS``
    over the card and the host — a test topology for a one-card machine
    — and with two or more cards ``PATHS_TWO``; then :func:`paths_day`).
    Each run: every block, plane and plan on its shard's device; each
    kernel exactly its predicted launches a step for each row block on a
    card, none for the host's; the losses within rtol 1e-4 and the
    working set within rtol 1e-5 / atol 1e-6 of the same mesh on one
    card; a rerun bit-identical; each kernel of the lowering at the
    first card row block's shape against its plain version
    (:func:`paths_kernels`)."""
    t_phase = time.perf_counter()
    runs = PATHS_RUNS
    if torch.cuda.device_count() >= 2:
        runs += PATHS_TWO
    launches, out = {}, {"cards": torch.cuda.device_count()}
    pass_block = block.slice(0, PATHS_BATCHES * BATCH)
    for label, path, rule, mesh, devices, want, per_block in runs:
        what = f"multicard_paths[{label}]"
        card = device if ":" in device else f"{device}:0"
        devices = tuple({"card": card, "host": host}.get(d, d)
                        for d in devices)
        t0 = time.perf_counter()
        ref, ws_ref, _, _, _ = paths_pass(pass_block, params0, mesh, None,
                                          path, rule, device)
        reset_counts()
        stats, ws, held, feed, trainer = paths_pass(
            pass_block, params0, mesh, devices, path, rule, device)
        launches[label] = read_counts()
        if stats["path"] != want or ref["path"] != want:
            raise AssertionError(f"{what}: {path} resolved to "
                                 f"{stats['path']} / one card {ref['path']}")
        blocks = sum(trainer.topology.device_of(k).type == "cuda"
                     for k, _, _ in held["show"].row_blocks())
        predicted = {name: PATHS_BATCHES * blocks * n for name, n in
                     zip(("gather_sorted", "scatter_add_sorted",
                          "gather_pool"), per_block)}
        if device.startswith("cuda"):
            check_pass(what, stats, launches[label],
                       {k: v // PATHS_BATCHES for k, v in predicted.items()},
                       n_batches=PATHS_BATCHES, exact=True)
        close = multicard_close(what, stats, ws, ref, ws_ref)
        again, ws2, _, _, _ = paths_pass(pass_block, params0, mesh, devices,
                                         path, rule, device)
        if again["losses"] != stats["losses"] or any(
                not torch.equal(ws[k], ws2[k]) for k in ws):
            raise AssertionError(f"{what}: a rerun left other bits")
        kern = (paths_kernels(what, stats["path"], held, feed, trainer,
                              torch.device(device))
                if device.startswith("cuda") else {})
        del held, feed, trainer
        steady = (float(np.median(stats["step_ms"][1:]))
                  if "step_ms" in stats else None)
        out[label] = {
            "path": path, "rule": rule, "mesh": mesh,
            "devices": list(devices), "resolved": stats["path"],
            "card_row_blocks": blocks, "predicted_launches": predicted,
            "launches": launches[label], "losses": stats["losses"],
            "one_card_losses": ref["losses"], **close,
            "step_ms": stats.get("step_ms"), "steady_step_ms": steady,
            "one_card_steady_step_ms": (float(np.median(
                ref["step_ms"][1:])) if "step_ms" in ref else None),
            "bytes": stats["bytes"], "one_card_bytes": ref["bytes"],
            "kernels": kern, "run_s": time.perf_counter() - t0}
        host_bound = host in devices
        log(f"{what}: {path} ({rule}) on {mesh} over {list(devices)} → "
            f"{stats['path']}; losses {stats['losses']} vs one card "
            f"{ref['losses']}, ws max |diff| {close['ws_max_abs_diff']}; "
            f"launches {launches[label]} (predicted {predicted}: "
            f"{blocks} card row blocks × {PATHS_BATCHES} steps); on {card}: "
            f"working set "
            f"{stats['bytes']['ws'].get(card, 0) / 2**20:.1f} MiB + feed "
            f"{stats['bytes']['feed'].get(card, 0) / 2**20:.1f} MiB vs "
            f"one card {ref['bytes']['ws'].get(card, 0) / 2**20:.1f} + "
            f"{ref['bytes']['feed'].get(card, 0) / 2**20:.1f} MiB; step "
            f"device ms {stats.get('step_ms')} (steady median {steady}, one "
            f"card {out[label]['one_card_steady_step_ms']}); rerun "
            f"bit-identical; {time.perf_counter() - t0:.1f} s; {card_line()}"
            + ("; a host shard bounds this step: it is no multi-card speed"
               if host_bound else ""))
        for name in ("gather_sorted", "scatter_add_sorted", "gather_pool"):
            if name in kern:
                x = kern[name]
                log(f"{what}[kernels, row block at {kern['row0']} on "
                    f"{devices[kern['shard']]}]: {name} {x['ms']:.4f} ms "
                    f"(plain {x['plain_ms']:.4f}, library "
                    f"{x['library_ms']:.4f}, bound {x['bound_ms']:.4f} "
                    f"{x['bound_by']}); max |err| {x['max_abs_err']:.3g}; "
                    f"{card_line()}")
    if len(runs) == len(PATHS_RUNS):
        log("multicard_paths: runs d2 and g2 need two cards; this machine "
            "has 1")
    day_launches, out["h"] = paths_day(block, device, host)
    for name, n in day_launches.items():
        launches[f"h_{name}"] = n
    h = out["h"]
    log(f"multicard_paths[h]: a day of {PATHS_DAY_PASSES} passes × "
        f"{PATHS_DAY_BATCHES} batches on dp 2 over [{device}, {host}] "
        f"(auto → mxu_sharded): cache on = off bitwise, prefetched = "
        f"serial bitwise; hits per pass "
        f"{[p['hits'] for p in h['cache_on']['per_pass']]} serial, "
        f"{[p['hits'] for p in h['cache_on_prefetch']['per_pass']]} "
        f"prefetched; rows copied between the store and the host's block "
        f"{[p['device_copy_rows'] for p in h['cache_on']['per_pass']]}; "
        f"walls {[round(h[k]['wall_s'], 2) for k in h]} s; launches "
        f"{day_launches}; {card_line()}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multicard_paths: runs {[r[0] for r in runs] + ['h']} passed; "
        f"phase {out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 22: the page-view model, the multi-task trainer, graph learning and
# the plane stager on distinct devices
# ---------------------------------------------------------------------------

# (run, what trains, sparse_path, the lowering it resolves to, per card
# shard (mxu_sharded) or card row block a step: gather_sorted,
# scatter_add_sorted, gather_pool launches), each on dp 2 over the card
# and the host; with two or more cards the runs of MODELS_TWO go over
# cuda:0 and cuda:1
MODELS_MESH = {"dp": 2}
MODELS_RUNS = (("i_auto", "rank", "auto", "mxu_sharded", (1, 1, 0)),
               ("i_fast", "rank", "fast", "fast", (0, 1, 1)),
               ("j", "mmoe", "auto", "reference", (0, 1, 0)),
               ("k", "graph", None, None, (1, 1, 0)))
MODELS_TWO = {"i_auto": "i2_auto", "k": "k2"}
MODELS_RANK_BATCHES = 2            # of phase 12's 4: a depth cut
MODELS_GRAPH_STEPS = 4             # of phase 18's epoch: a depth cut


def models_topology(mesh: dict, device: str, devices=None):
    """The mesh's topology: every shard on ``device``, or one a shard on
    ``devices``."""
    from paddlebox_tpu_torch.config import MeshConfig
    from paddlebox_tpu_torch.parallel.topology import HybridTopology
    if devices is None:
        return HybridTopology(MeshConfig(**mesh), device=device)
    return HybridTopology(MeshConfig(**mesh), devices=list(devices))


def models_pass(kind: str, block, params, path: str, devices,
                device: str = "cuda"):
    """One packed pass of the rank model or of MMoE through the
    multi-task trainer on dp 2 over ``devices`` (None: every shard on
    ``device``), end_pass included: (stats with the resolved lowering
    and the bytes of the working set and the feed on each device, the
    working set on the host, the initial params)."""
    if kind == "rank":
        engine, trainer, dataset, p0 = rank_trainer(
            block, device, params, path, MODELS_MESH, devices)
    else:
        engine, trainer, dataset, p0 = make_trainer(
            block, device, params, path, model="mmoe", mesh=MODELS_MESH,
            devices=devices)
    feed = trainer.build_pass_feed(dataset)
    if devices is not None:
        check_placement(trainer, engine, feed)
    stats = trainer.train_pass(feed)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    stats["path"] = trainer._resolve_path()
    stats["bytes"] = card_bytes(engine, feed)
    ws = host_ws(engine.ws)
    engine.end_pass()
    if engine.table.size() != engine.num_keys:
        raise AssertionError("multicard_models: end_pass did not write "
                             "every key")
    return stats, ws, p0


def models_graph_data(device: str, seed: int = 22):
    """Phase 18's graph (the same seed: the 2,097,152-node power-law
    graph, its walk starts) and the pairs of its walks' first
    MODELS_GRAPH_STEPS batches, as pass rows of the node keys."""
    from paddlebox_tpu_torch.graph.graph_table import GraphTable
    from paddlebox_tpu_torch.trainer import graph_trainer as gt
    rng = np.random.default_rng(seed)
    edges, weights = power_law_graph(rng, GRAPH_NODES, GRAPH_MEAN_DEGREE)
    graph = GraphTable(edges, weights=weights, num_nodes=GRAPH_NODES + 1,
                       device=torch.device(device))
    del edges, weights
    deg = np.diff(graph.indptr.cpu().numpy())
    starts = rng.choice(np.nonzero(deg > 0)[0], GRAPH_WALKS)
    wgen = torch.Generator(device=device).manual_seed(seed)
    walks = graph.random_walk(torch.as_tensor(starts, device=device),
                              GRAPH_WALK_LEN, wgen)
    pairs = gt.walk_pairs(walks, GRAPH_WINDOW)
    # nodes 1..N are the pass's keys 1..N: row r is key r (rows from 1)
    flat = pairs.reshape(-1)
    ok = (flat >= 1) & (flat <= GRAPH_NODES)
    rows = torch.where(ok, flat, torch.zeros_like(flat)).reshape(pairs.shape)
    rows = rows[(rows > 0).all(1) & (rows[:, 0] != rows[:, 1])]
    return graph, rows[:MODELS_GRAPH_STEPS * GRAPH_BATCH].cpu().numpy()


def models_graph_pass(graph, rows: np.ndarray, devices, device: str = "cuda",
                      seed: int = 22, hold: dict = None):
    """One epoch of ``rows`` through ``GraphEmbeddingTrainer`` over a
    working set of the graph's nodes on dp 2 over ``devices`` (None:
    every shard on ``device``), end_pass included: (stats with the
    losses, the step ms and the working set's bytes on each device, mf
    and mf_g2sum on the host).  ``hold``: receives the trained working
    set."""
    from paddlebox_tpu_torch.parallel.topology import Sharded, same_device
    from paddlebox_tpu_torch.trainer import graph_trainer as gt
    topo = models_topology(MODELS_MESH, device, devices)
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, sgd=SparseSGDConfig(
            mf_create_thresholds=0.0, mf_initial_range=0.1)),
        seed=seed, device=device, topology=topo)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, GRAPH_NODES + 1, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    size = eng.ws["mf_size"]
    for _, blk in (size.unique() if isinstance(size, Sharded)
                   else [(0, size)]):
        blk.fill_(MF_DIM)
    if not np.array_equal(eng.mapper(np.array([1, GRAPH_NODES], np.uint64)),
                          [1, GRAPH_NODES]):
        raise AssertionError("multicard_models[k]: node keys are not their "
                             "own pass rows")
    if devices is not None:
        for f, v in eng.ws.items():
            for k, part in enumerate(v.parts):
                if not same_device(part.device, topo.device_of(k)):
                    raise AssertionError(f"multicard_models[k]: {f} block "
                                         f"{k} on {part.device}")
    tr = gt.GraphEmbeddingTrainer(eng, graph, n_negatives=GRAPH_NEGATIVES,
                                  learning_rate=GRAPH_LR,
                                  window=GRAPH_WINDOW, seed=seed)
    loss = tr.train_pairs(rows, batch_size=GRAPH_BATCH)
    torch.cuda.synchronize()
    stats = dict(tr.stats, loss=loss, batches=len(tr.stats["losses"]))
    ws = host_ws({f: eng.ws[f] for f in ("mf", "mf_g2sum")})
    stats["bytes"] = {"ws": ws_by_device(eng.ws), "feed": {}}
    if hold is not None:
        hold["ws"] = dict(eng.ws)
        hold["num_keys"] = eng.num_keys
    eng.end_pass()
    if eng.table.size() != GRAPH_NODES:
        raise AssertionError("multicard_models[k]: end_pass did not write "
                             "every node")
    return stats, ws


def models_graph_kernels(what: str, held: dict, num_keys: int,
                         rows: np.ndarray, devices, seed: int = 22) -> dict:
    """Both sorted kernels on the first card row block of (k)'s trained
    working set over its plan of the epoch's first step (that batch's
    centers and contexts and the trainer's first negatives, drawn again
    from its seed), against their plain versions."""
    from paddlebox_tpu_torch.ps import mxu_path
    from paddlebox_tpu_torch.trainer import graph_trainer as gt
    mf = held["ws"]["mf"]
    k, sl = next((k, sl) for k, sl, _ in mf.row_blocks()
                 if mf.topo.device_of(k).type == "cuda")
    dev = mf.topo.device_of(k)
    table, _ = gt.to_feature_major(mf.parts[k],
                                   held["ws"]["mf_g2sum"].parts[k])
    gen = torch.Generator(device=dev).manual_seed(seed)
    negs = torch.randint(1, num_keys + 1, (GRAPH_BATCH, GRAPH_NEGATIVES),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = torch.as_tensor(rows[:GRAPH_BATCH], device=dev)
    ids = gt.step_rows(batch[:, 0], batch[:, 1], negs)
    dims, plan = mxu_path.block_plan(ids, sl.start, sl.stop - sl.start)
    out = graph_plan_kernels(what, table, plan, dims, seed + 2)
    out.update(shard=k, device=str(devices[k]), row0=sl.start,
               rows=sl.stop - sl.start,
               sentinel_share=float((plan[0].reshape(-1)[:dims.p]
                                     == dims.sentinel).float().mean()))
    return out


def models_stager(block, params, devices, device: str = "cuda") -> dict:
    """(l): phase 4's pass packed twice on dp 2 over ``devices``: through
    ``pack_pass(on_plane=PlaneStager(topology, BATCH))``, each
    plane's shard columns uploaded to the shard's device as the plane
    becomes final, and plainly, then uploaded.  Every plane of the two
    feeds bit-equal on its shard's device; no staged plane whole on one
    device."""
    from paddlebox_tpu_torch.data import pass_feed as pf
    from paddlebox_tpu_torch.parallel.topology import same_device
    _, trainer, dataset, _ = make_trainer(block, device, params, "auto",
                                          mesh=MODELS_MESH,
                                          devices=devices)
    topo = trainer.topology
    t0 = time.perf_counter()
    arrays = trainer.pack_pass_host(dataset)
    shardings = trainer.pass_shardings(arrays)
    plain = pf.upload_pass(arrays, trainer.device, topology=topo,
                           shardings=shardings)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stager = pf.PlaneStager(topo, BATCH)
    staged_arrays = trainer.pack_pass_host(dataset, on_plane=stager)
    staged = pf.upload_pass(staged_arrays, trainer.device, staged=stager,
                            topology=topo, shardings=shardings)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    n_dp = topo.axis_size(("dp", "sharding"))
    for name, parts in stager.staged.items():
        for k, part in enumerate(parts):
            if not same_device(part.device, topo.device_of(k)):
                raise AssertionError(f"multicard_models[l]: staged {name} "
                                     f"of shard {k} on {part.device}")
            whole = getattr(arrays, name)
            dim = 1 if name in ("indices", "lengths") else 0
            if part.shape[dim] * n_dp != whole.shape[dim]:
                raise AssertionError(f"multicard_models[l]: staged {name} "
                                     f"of shard {k} is not its columns")
    if set(staged.data) != set(plain.data):
        raise AssertionError("multicard_models[l]: the staged feed's planes "
                             f"{sorted(staged.data)} != {sorted(plain.data)}")
    for name in plain.data:
        for k in range(topo.world_size):
            a, b = staged.data[name].parts[k], plain.data[name].parts[k]
            if not same_device(a.device, topo.device_of(k)) or \
                    not torch.equal(a, b):
                raise AssertionError(f"multicard_models[l]: staged {name} "
                                     f"of shard {k} != the unstaged upload")
    return {"devices": [str(d) for d in devices],
            "staged_planes": sorted(stager.staged),
            "pack_upload_s": plain_s, "staged_pack_upload_s": staged_s,
            "bytes": staged.bytes_by_device()}


def multicard_models_phase(block: SlotRecordBlock, params0,
                           device: str = "cuda", host: str = "cpu",
                           graph_data: dict = None):
    """The page-view model, the multi-task trainer and graph learning on
    dp 2 with the shards on distinct devices at the bench widths
    (``MODELS_RUNS`` over the card and the host — a test topology for a
    one-card machine — and with two or more cards ``MODELS_TWO`` over
    cuda:0 and cuda:1), then the plane stager (:func:`models_stager`).
    (i) RankAttentionCTR on MODELS_RANK_BATCHES batches of a page-view
    pass made as phase 12's, auto (→ mxu_sharded) and fast; (j) MMoE
    through MultiTaskSparseTrainer on
    2 batches (phase 8's); (k) GraphEmbeddingTrainer over phase 18's
    graph, MODELS_GRAPH_STEPS steps.  Each run: every block, plane and
    plan on its shard's device; each kernel exactly its predicted
    launches a step for each card shard or card row block, none for the
    host's; the losses within rtol 1e-4, the working set (the graph's mf
    and mf_g2sum) within rtol 1e-5 / atol 1e-6 and (j)'s task AUCs
    within 1e-6 of the same mesh on one card; a rerun bit-identical.
    (k)'s card row block times both sorted kernels
    (:func:`models_graph_kernels`).  ``graph_data``: phase 18's graph and
    pair rows (``graph_phase(keep=)``); None builds them again
    (:func:`models_graph_data`)."""
    t_phase = time.perf_counter()
    card = device if ":" in device else f"{device}:0"
    runs = [((card, host), r[0], r) for r in MODELS_RUNS]
    if torch.cuda.device_count() >= 2:
        runs += [(("cuda:0", "cuda:1"), MODELS_TWO[r[0]], r)
                 for r in MODELS_RUNS if r[0] in MODELS_TWO]
    rng = np.random.default_rng(13)
    rank_data = rank_block(rng, MODELS_RANK_BATCHES)
    mmoe_data = make_block(np.random.default_rng(4), 2 * BATCH, n_labels=2)
    if graph_data is None:
        graph_data = dict(zip(("graph", "rows"), models_graph_data(device)))
    graph, graph_rows = graph_data["graph"], graph_data["rows"]
    launches, out = {}, {"cards": torch.cuda.device_count()}
    refs, params = {}, {}
    for devices, label, (run, kind, path, want, per_block) in runs:
        what = f"multicard_models[{label}]"
        t0 = time.perf_counter()
        # dp 2: each of the two devices holds one shard, its batch block
        # and its table row block
        cards = sum(d.startswith("cuda") for d in devices)
        hold = {}
        if kind == "graph":
            if kind not in refs:
                refs[kind] = models_graph_pass(graph, graph_rows, None,
                                               device)
            ref, ws_ref = refs[kind]
            hold = {}
            reset_counts()
            stats, ws = models_graph_pass(graph, graph_rows, devices, device,
                                          hold=hold)
            launches[label] = read_counts()
            again, ws2 = models_graph_pass(graph, graph_rows, devices, device)
        else:
            data = rank_data if kind == "rank" else mmoe_data
            key = (kind, path)
            if key not in refs:
                refs[key] = models_pass(kind, data, params.get(kind), path,
                                        None, device)
                params.setdefault(kind, refs[key][2])
            ref, ws_ref, _ = refs[key]
            reset_counts()
            stats, ws, _ = models_pass(kind, data, params[kind], path,
                                       devices, device)
            launches[label] = read_counts()
            if stats["path"] != want or ref["path"] != want:
                raise AssertionError(f"{what}: {path} resolved to "
                                     f"{stats['path']} / one card "
                                     f"{ref['path']}")
            again, ws2, _ = models_pass(kind, data, params[kind], path,
                                        devices, device)
        n_steps = stats["batches"]
        predicted = {name: n_steps * cards * n for name, n in
                     zip(("gather_sorted", "scatter_add_sorted",
                          "gather_pool"), per_block)}
        if launches[label] != predicted:
            raise AssertionError(f"{what}: launches {launches[label]}, "
                                 f"predicted {predicted} ({cards} card "
                                 f"blocks × {n_steps} steps)")
        if kind == "graph":
            if not all(math.isfinite(x) for x in stats["losses"]):
                raise AssertionError(f"{what}: non-finite losses "
                                     f"{stats['losses']}")
            if not np.allclose(stats["losses"], ref["losses"], rtol=1e-4,
                               atol=0):
                raise AssertionError(f"{what}: losses {stats['losses']} vs "
                                     f"one card {ref['losses']}")
            close = {"ws_max_abs_diff": {}}
            for f in ws_ref:
                a, b = ws[f].numpy(), ws_ref[f].numpy()
                close["ws_max_abs_diff"][f] = float(np.abs(a - b).max())
                if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"{what}: {f} differs from the same "
                                         "mesh on one card: max |diff| "
                                         f"{close['ws_max_abs_diff'][f]}")
        else:
            check_pass(what, stats, launches[label],
                       {k: v // n_steps for k, v in predicted.items()},
                       n_batches=n_steps, exact=True)
            close = multicard_close(what, stats, ws, ref, ws_ref)
        if kind == "mmoe":
            for t in range(2):
                if abs(stats[f"task{t}_auc"] - ref[f"task{t}_auc"]) > 1e-6:
                    raise AssertionError(
                        f"{what}: task {t} AUC {stats[f'task{t}_auc']} vs "
                        f"one card {ref[f'task{t}_auc']}")
        if again["losses"] != stats["losses"] or any(
                not torch.equal(ws[f], ws2[f]) for f in ws):
            raise AssertionError(f"{what}: a rerun left other bits")
        kern = {}
        if kind == "graph" and devices[1] == host and \
                device.startswith("cuda"):
            kern = models_graph_kernels(what, hold, hold["num_keys"],
                                        graph_rows, devices)
        hold.clear()
        steady = float(np.median(stats["step_ms"][1:] if kind != "graph"
                                 else stats["step_ms"]))
        one_card = float(np.median(ref["step_ms"][1:] if kind != "graph"
                                   else ref["step_ms"]))
        out[label] = {
            "kind": kind, "path": path, "resolved": want,
            "mesh": MODELS_MESH, "devices": list(devices),
            "card_blocks": cards, "predicted_launches": predicted,
            "launches": launches[label], "losses": stats["losses"],
            "one_card_losses": ref["losses"], **close,
            "step_ms": stats["step_ms"], "steady_step_ms": steady,
            "one_card_steady_step_ms": one_card,
            "bytes": stats["bytes"], "one_card_bytes": ref["bytes"],
            "kernels": kern, "run_s": time.perf_counter() - t0}
        if kind == "mmoe":
            out[label]["task_aucs"] = [stats["task0_auc"],
                                       stats["task1_auc"]]
            out[label]["one_card_task_aucs"] = [ref["task0_auc"],
                                                ref["task1_auc"]]
        b = stats["bytes"]
        log(f"{what}: {kind} ({path or 'sorted kernels'}) on "
            f"{MODELS_MESH} over {list(devices)}"
            + (f" → {want}" if want else "")
            + f"; losses {stats['losses']} vs one card {ref['losses']}, ws "
            f"max |diff| {close['ws_max_abs_diff']}"
            + (f", task AUCs {out[label]['task_aucs']} vs one card "
               f"{out[label]['one_card_task_aucs']}" if kind == "mmoe"
               else "")
            + f"; launches {launches[label]} (predicted, {cards} card "
            f"blocks × {n_steps} steps); on {card}: working set "
            f"{b['ws'].get(card, 0) / 2**20:.1f} MiB + feed "
            f"{b['feed'].get(card, 0) / 2**20:.1f} MiB vs one card "
            f"{ref['bytes']['ws'].get(card, 0) / 2**20:.1f} + "
            f"{ref['bytes']['feed'].get(card, 0) / 2**20:.1f} MiB; "
            + ("median step" if kind == "graph" else "steady step")
            + f" {steady:.3f} ms (one card {one_card:.3f}); rerun "
            f"bit-identical; {time.perf_counter() - t0:.1f} s; "
            f"{card_line()}"
            + ("; a host block bounds this step: it is no multi-card speed"
               if host in devices else ""))
        for name in ("gather_sorted", "scatter_add_sorted"):
            if name in kern:
                x = kern[name]
                log(f"{what}[kernels, row block at {kern['row0']} on "
                    f"{kern['device']}]: {name} {x['ms']:.4f} ms (plain "
                    f"{x['plain_ms']:.4f}, library {x['library_ms']:.4f}, "
                    f"bound {x['bound_ms']:.4f} {x['bound_by']}); p "
                    f"{kern['p']}, sentinel share "
                    f"{kern['sentinel_share']:.4f}; max |err| "
                    f"{x['max_abs_err']:.3g}; {card_line()}")
    del graph, graph_data
    t0 = time.perf_counter()
    out["l"] = models_stager(block, params0, (card, host), device)
    out["l"]["run_s"] = time.perf_counter() - t0
    log(f"multicard_models[l]: phase 4's pass staged on dp 2 over "
        f"[{card}, {host}]: planes {out['l']['staged_planes']} each on its "
        f"shards' devices, the feed bit-equal to the unstaged upload; pack + "
        f"upload {out['l']['staged_pack_upload_s']:.2f} s staged vs "
        f"{out['l']['pack_upload_s']:.2f} s after the pack (host seconds); "
        f"{card_line()}")
    if torch.cuda.device_count() < 2:
        log(f"multicard_models: runs {list(MODELS_TWO.values())} need two "
            "cards; this machine has 1")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multicard_models: runs {[r[1] for r in runs] + ['l']} passed; "
        f"phase {out['phase_s']:.1f} s")
    return launches, out

# ---------------------------------------------------------------------------
# phase 23: the dp axis across processes
# ---------------------------------------------------------------------------

MP_MESH = {"dp": 2, "sharding": 2}
MP_PACKED = 2                      # batches of the pass through the feed
MP_STEPS = N_BATCHES               # MP_PACKED packed, the rest streaming
MP_TIMEOUT_S = 300
MP_TAGS = {"delta": "all_reduce_sum", "slot_column": "all_reduce_max",
           "dense_grads": "dense_grads", "count": "count",
           "auc_state": "auc_state"}
MP_ARG = "--multiprocess-rank"


def save_params(path: str, params) -> None:
    """A DeepFM ``jax_params`` pytree as one npz."""
    flat = {"dense_w": params["dense_w"], "bias": params["bias"]}
    for i, layer in enumerate(params["mlp"]):
        flat[f"mlp.{i}.w"], flat[f"mlp.{i}.b"] = layer["w"], layer["b"]
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_params(path: str):
    with np.load(path) as z:
        n = sum(k.startswith("mlp.") and k.endswith(".w") for k in z.files)
        return {"mlp": [{"w": z[f"mlp.{i}.w"], "b": z[f"mlp.{i}.b"]}
                        for i in range(n)],
                "dense_w": z["dense_w"], "bias": z["bias"]}


def mp_pass(block: SlotRecordBlock, params, group=None, devices=None):
    """The phase's pass on ``MP_MESH``: the first ``MP_PACKED`` batches of
    ``block`` through build_pass_feed, the rest streaming, in one pass
    over every batch's keys (end_pass not yet run).  ``group``: the dp
    axis over the launcher's group (``devices``: this rank's shards');
    else every shard on the card.  Returns (engine, trainer, feed, the
    two passes' stats)."""
    engine, trainer, _, _ = make_trainer(block, "cuda", params, "auto",
                                         mesh=MP_MESH, devices=devices,
                                         group=group)
    cut = MP_PACKED * BATCH
    packed, stream = (SlotDataset(feed_config()) for _ in range(2))
    packed._blocks = [block.slice(0, cut)]
    stream._blocks = [block.slice(cut, MP_STEPS * BATCH)]
    feed = trainer.build_pass_feed(packed)
    stats = [trainer.train_pass(feed),
             trainer.train_pass(stream, pack_threads=4)]
    torch.cuda.synchronize()
    if trainer._resolve_path() != "mxu_sharded":
        raise AssertionError(f"multiprocess: auto resolved to "
                             f"{trainer._resolve_path()}")
    return engine, trainer, feed, stats


def multiprocess_rank(work: str) -> int:
    """One rank of phase 23 (``python -m paddlebox_tpu_torch.launch
    --nproc_per_node 2 chip_smoke.py --multiprocess-rank <work>``): joins
    the launcher's group, trains :func:`mp_pass` on its dp coordinate's
    shards (both on ``cuda:0``), holds both sorted kernels on its first
    shard's plan of the first step against their plain versions (the
    ranks one after the other), runs end_pass and writes
    ``<work>/rank<r>.json`` (and, rank 0, its working set)."""
    from paddlebox_tpu_torch import launch
    from paddlebox_tpu_torch.utils.monitor import stat_get
    import torch.distributed as dist
    rank = launch.init_distributed()
    group = launch.process_group()
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    block = make_block(np.random.default_rng(spec["seed"]),
                       MP_STEPS * BATCH)
    params = load_params(os.path.join(work, "params.npz"))
    shards = MP_MESH["sharding"]
    reset_counts()
    t0 = time.perf_counter()
    engine, trainer, feed, stats = mp_pass(block, params, group,
                                           ["cuda:0"] * shards)
    train_s = time.perf_counter() - t0
    launches = read_counts()
    topo = trainer.topology
    ws = host_ws(engine.ws)
    if rank == 0:
        np.savez(os.path.join(work, "ws0.npz"),
                 **{k: v.numpy() for k, v in ws.items()})
    k = topo.local_shards[0]
    kern = {}
    for turn in range(topo.nranks):
        dist.barrier(group)
        if turn == rank:
            kern = sharded_kernels(
                f"multiprocess[rank {rank}, shard {k}]",
                {f: v.parts[k] for f, v in engine.ws.items()},
                feed.plans["rows2d"][k][0], feed.plans["first_occ"][k][0],
                feed.plans["inv_perm"][k].shape[1], k)
            torch.cuda.synchronize()
    dist.barrier(group)
    engine.end_pass()
    keys = np.sort(engine.table.export_keys())
    rows = engine.table.bulk_pull(keys)
    out = {
        "rank": rank, "local_shards": topo.local_shards,
        "losses": [x for st in stats for x in st["losses"]],
        "auc": [st["auc"] for st in stats],
        "step_ms": [x for st in stats for x in st["step_ms"]],
        "train_s": train_s, "launches": launches,
        "ws_digest": digest({f: v.numpy() for f, v in ws.items()}),
        "table_keys": int(len(keys)),
        "table_digest": digest(dict(rows, keys=keys)),
        "params_digest": digest({n: p.detach().cpu().numpy() for n, p in
                                 trainer.model.named_parameters()}),
        "tx_bytes": {name: stat_get(f"parallel.xproc.{tag}.tx_bytes")
                     for name, tag in MP_TAGS.items()},
        "exchange_s": stat_get("parallel.xproc.exchange_s"),
        "kernels": kern}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def mp_launch(work: str, arg: str = MP_ARG) -> float:
    """The two ranks through the port's launcher (``chip_smoke.py <arg>
    <work>``), in a process group of their own (killed whole at the time
    limit); raises unless both exit 0.  Returns the wall seconds."""
    import signal
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "paddlebox_tpu_torch.launch",
           "--nproc_per_node", "2", "--coordinator", f"127.0.0.1:{port}",
           os.path.join(here, "chip_smoke.py"), arg, work]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, start_new_session=True)
    try:
        rc = proc.wait(timeout=MP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError(f"multiprocess: the ranks ran past "
                             f"{MP_TIMEOUT_S} s")
    if rc != 0:
        raise AssertionError(f"multiprocess: the launcher exited {rc}")
    return time.perf_counter() - t0


def multiprocess_phase(block: SlotRecordBlock, params0, seed: int = 2):
    """Phase 23: two ranks, one dp coordinate each, train ``mxu_sharded``
    on dp 2 × sharding 2 over the launcher's gloo group, both on the card
    (``block`` is phase 4's, made from ``seed``; ``params0`` its dense
    weights).  Checks: the ranks' losses, AUC, working set, host table
    and dense params bit-equal; each rank's sorted kernels exactly once a
    local shard a step and gather_pool never; the losses within rtol 1e-4
    and the working set within rtol 1e-5 / atol 1e-6 of the same mesh in
    one process on the card; the first step within rtol 1e-4 of the CPU;
    each rank's kernels on its first shard's plan against their plain
    versions (in the worker)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        save_params(os.path.join(work, "params.npz"), params0)
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump({"seed": seed}, f)
        ranks_wall = mp_launch(work)
        got = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                got.append(json.load(f))
        with np.load(os.path.join(work, "ws0.npz")) as z:
            ws0 = {k: torch.as_tensor(z[k]) for k in z.files}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    a, b = got
    for key in ("losses", "auc", "ws_digest", "table_digest",
                "params_digest", "table_keys"):
        if a[key] != b[key]:
            raise AssertionError(f"multiprocess: the ranks' {key} differ: "
                                 f"{a[key]} vs {b[key]}")
    shards = MP_MESH["sharding"]
    launches = {}
    for r in got:
        want = {"gather_sorted": shards * MP_STEPS,
                "scatter_add_sorted": shards * MP_STEPS, "gather_pool": 0}
        if r["launches"] != want:
            raise AssertionError(f"multiprocess: rank {r['rank']} launched "
                                 f"{r['launches']}, want {want}")
        launches[f"rank{r['rank']}"] = r["launches"]
    engine, _, _, stats = mp_pass(block, params0)
    ref = {"losses": [x for st in stats for x in st["losses"]]}
    close = multicard_close("multiprocess", a, ws0, ref,
                            host_ws(engine.ws))
    engine.end_pass()
    del engine
    cpu_loss = cpu_first_loss("multiprocess", block, a["losses"][0],
                              params0, path="auto", packed=True,
                              mesh=MP_MESH)
    steps = len(a["losses"])
    per_step = {r["rank"]: {k: v / steps for k, v in r["tx_bytes"].items()}
                for r in got}
    for r in got:
        steady = float(np.median(r["step_ms"][1:]))
        log(f"multiprocess[rank {r['rank']}]: shards {r['local_shards']} "
            f"on cuda:0, losses {r['losses']}, auc {r['auc']}, launches "
            f"{r['launches']}, step device ms {r['step_ms']} (steady median "
            f"{steady:.3f}), bytes sent over the group a step "
            f"{per_step[r['rank']]}, cross-process tier "
            f"{r['exchange_s'] / steps:.4f} s a step (host clock, the "
            f"device wait before each copy to the host included), train "
            f"{r['train_s']:.2f} s; host- and loopback-bound with two ranks "
            f"on one card (gloo over loopback, staged through host "
            f"memory): no multi-node speed; {card_line()}")
    out = {"mesh": MP_MESH, "ranks": got, "ranks_wall_s": ranks_wall,
           "tx_bytes_per_step": per_step, "one_process": close,
           "cpu_first_loss": cpu_loss, "kernels": {
               name: a["kernels"][name] | {"max_abs_err": max(
                   r["kernels"][name]["max_abs_err"] for r in got)}
               for name in ("gather_sorted", "scatter_add_sorted")}}
    for name, x in out["kernels"].items():
        log(f"multiprocess[kernels, rank 0 shard {a['kernels']['shard']}]: "
            f"{name} {x['ms']:.4f} ms (plain {x['plain_ms']:.4f}, library "
            f"{x['library_ms']:.4f}, bound {x['bound_ms']:.4f}) at p "
            f"{a['kernels']['p']}, rows_loc {a['kernels']['rows_loc']}, "
            f"sentinel share {a['kernels']['sentinel_share']:.4f}; max abs "
            f"err over both ranks {x['max_abs_err']:.3g}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multiprocess: ranks bit-equal, within rtol 1e-4 / 1e-5 of one "
        f"process on the card (first losses {close['first_loss']}), first "
        f"step = the CPU's; ranks {ranks_wall:.1f} s of a phase "
        f"{out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 24: the table split across processes
# ---------------------------------------------------------------------------

# (run, mesh, sparse_path, the lowering it resolves to, launches of each
# kernel a step for each of the rank's row blocks (mxu_sharded: shards))
SPLIT_RUNS = (
    ("m", {"dp": 2}, "auto", "mxu_sharded",
     {"gather_sorted": 1, "scatter_add_sorted": 1, "gather_pool": 0}),
    ("n", {"dp": 2}, "mxu", "mxu",
     {"gather_sorted": 1, "scatter_add_sorted": 1, "gather_pool": 0}),
    ("o", {"dp": 2, "mp": 2}, "auto", "fast",
     {"gather_sorted": 0, "scatter_add_sorted": 1, "gather_pool": 1}),
    ("p", {"dp": 2}, "reference", "reference",
     {"gather_sorted": 0, "scatter_add_sorted": 1, "gather_pool": 0}),
    # the multi-node layout: each rank reads and steps its own replica
    ("r", {"dp": 2, "sharding": 2}, "fast", "fast",
     {"gather_sorted": 0, "scatter_add_sorted": 1, "gather_pool": 1}))
SPLIT_STEPS = 2                    # one batch packed, one streaming
SPLIT_ARG = "--multiprocess-split-rank"
XPROC = "parallel.xproc."


def split_pass(block: SlotRecordBlock, params, mesh: dict, path: str,
               group=None, devices=None):
    """A run of phase 24 on ``mesh``: the first batch of ``block`` through
    build_pass_feed, the second streaming, in one pass over both batches'
    keys (end_pass not yet run).  ``group``: the dp axis over the
    launcher's group (``devices``: this rank's shards'); else every shard
    on the card.  Returns (engine, trainer, feed, the passes' stats, the
    ``parallel.xproc.*`` counters' growth over the training)."""
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot
    engine, trainer, _, _ = make_trainer(block, "cuda", params, path,
                                         mesh=mesh, devices=devices,
                                         group=group)
    packed, stream = (SlotDataset(feed_config()) for _ in range(2))
    packed._blocks = [block.slice(0, BATCH)]
    stream._blocks = [block.slice(BATCH, SPLIT_STEPS * BATCH)]
    feed = trainer.build_pass_feed(packed)
    x0 = stat_snapshot(XPROC)
    stats = [trainer.train_pass(feed),
             trainer.train_pass(stream, pack_threads=4)]
    torch.cuda.synchronize()
    x1 = stat_snapshot(XPROC)
    grown = {k[len(XPROC):]: v - x0.get(k, 0.0) for k, v in x1.items()
             if v != x0.get(k, 0.0)}
    return engine, trainer, feed, stats, grown


def batch_ids_across(feed, trainer) -> tuple:
    """The first batch's whole ids [S, L, B] and lengths [S, B] on the
    host, each rank's columns gathered onto every rank's first shard over
    the group (a collective: every rank calls it)."""
    from paddlebox_tpu_torch.parallel import collective as col
    topo = trainer.topology
    owners, _ = trainer._batch_owners()
    firsts = [topo.shards_of(r)[0] for r in range(topo.nranks)]
    return tuple(col.gather_onto_shards([feed.data[f].parts[j][0]
                                         if topo.is_local(j) else None
                                         for j in owners], owners, firsts,
                                        topo, dim=d)[topo.rank].cpu()
                 for f, d in (("indices", 2), ("lengths", 1)))


def split_kernels(name: str, rank: int, engine, feed, ids) -> dict:
    """This rank's kernels of run ``name`` on its first row block, against
    their plain versions: (m) both sorted kernels on its shard's resident
    plan of the first batch; (o) gather_pool over the whole first batch's
    ``ids`` (:func:`batch_ids_across`)."""
    k, sl, _ = engine.ws["show"].row_blocks()[0]
    block = {f: v.parts[k] for f, v in engine.ws.items()}
    what = f"multiprocess_split[{name}][rank {rank}, shard {k}]"
    if name == "m":
        return sharded_kernels(what, block, feed.plans["rows2d"][k][0],
                               feed.plans["first_occ"][k][0],
                               feed.plans["inv_perm"][k].shape[1], k)
    return {"gather_pool": block_gather_pool(what, block, sl.start, *ids,
                                             block["show"].device),
            "shard": k, "row0": sl.start, "rows": sl.stop - sl.start}


def split_rank(work: str) -> int:
    """One rank of phase 24 (``python -m paddlebox_tpu_torch.launch
    --nproc_per_node 2 chip_smoke.py --multiprocess-split-rank <work>``):
    joins the launcher's group and trains each of ``SPLIT_RUNS`` on its dp
    coordinate's shards (all on ``cuda:0``), the table's rows split over
    the ranks; holds run (m)'s and (o)'s kernels on its first row block
    against their plain versions (the ranks one after the other); joins
    the working set over the group, runs end_pass and writes
    ``<work>/split<r>.json`` (and, rank 0, each run's joined working
    set)."""
    from paddlebox_tpu_torch import launch
    from paddlebox_tpu_torch.utils.monitor import stat_get
    import torch.distributed as dist
    rank = launch.init_distributed()
    group = launch.process_group()
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    block = make_block(np.random.default_rng(spec["seed"]),
                       N_BATCHES * BATCH).slice(0, SPLIT_STEPS * BATCH)
    params = load_params(os.path.join(work, "params.npz"))
    out = {"rank": rank, "runs": {}}
    for name, mesh, path, want, _ in SPLIT_RUNS:
        shards = int(np.prod(list(mesh.values()))) // 2
        reset_counts()
        t0 = time.perf_counter()
        engine, trainer, feed, stats, grown = split_pass(
            block, params, mesh, path, group, ["cuda:0"] * shards)
        train_s = time.perf_counter() - t0
        launches = read_counts()
        resolved = trainer._resolve_path()
        if resolved != want:
            raise AssertionError(f"multiprocess_split[{name}]: resolved "
                                 f"{resolved}, want {want}")
        ids = None
        if name == "o":
            ids = batch_ids_across(feed, trainer)
        kern = {}
        for turn in range(2):
            dist.barrier(group)
            if turn == rank and name in ("m", "o"):
                kern = split_kernels(name, rank, engine, feed, ids)
                torch.cuda.synchronize()
        dist.barrier(group)
        held = [[k, sl.start, sl.stop]
                for k, sl, _ in engine.ws["show"].row_blocks()]
        t1 = time.perf_counter()
        ws = host_ws(engine.ws)
        join_s = time.perf_counter() - t1
        if rank == 0:
            np.savez(os.path.join(work, f"ws_{name}.npz"),
                     **{k: v.numpy() for k, v in ws.items()})
        x0 = stat_get(XPROC + "join.tx_bytes")
        t1 = time.perf_counter()
        engine.end_pass()
        end_pass_s = time.perf_counter() - t1
        keys = np.sort(engine.table.export_keys())
        rows = engine.table.bulk_pull(keys)
        out["runs"][name] = {
            "mesh": mesh, "path": resolved,
            "local_shards": trainer.topology.local_shards,
            "local_row_blocks": held,
            "losses": [x for st in stats for x in st["losses"]],
            "auc": [st["auc"] for st in stats],
            "step_ms": [x for st in stats for x in st["step_ms"]],
            "train_s": train_s, "launches": launches,
            "xproc_per_step": {k: v / SPLIT_STEPS for k, v in grown.items()},
            "join_s": join_s, "end_pass_s": end_pass_s,
            "end_pass_join_bytes": stat_get(XPROC + "join.tx_bytes") - x0,
            "ws_digest": digest({f: v.numpy() for f, v in ws.items()}),
            "table_keys": int(len(keys)),
            "table_digest": digest(dict(rows, keys=keys)),
            "params_digest": digest({n: p.detach().cpu().numpy() for n, p in
                                     trainer.model.named_parameters()}),
            "kernels": kern}
        del engine, trainer, feed, ws
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"split{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def multiprocess_split_phase(block: SlotRecordBlock, params0,
                             seed: int = 2):
    """Phase 24: two ranks, one dp coordinate each, train ``SPLIT_RUNS``
    over the launcher's gloo group with the table's rows split over the
    ranks, both on the card (``block`` is phase 4's, made from ``seed``;
    ``params0`` its dense weights).  Checks, for each run: the ranks'
    losses, AUC, working set (joined over the group), host table after
    end_pass and dense params bit-equal; each rank's launches a step as
    ``SPLIT_RUNS`` predicts for its row blocks; the losses within rtol
    1e-4 and the working set within rtol 1e-5 / atol 1e-6 of the same
    mesh in one process on the card; (m)'s first step within rtol 1e-4 of
    the CPU; (m)'s sorted kernels and (o)'s gather_pool on each rank's
    first row block against their plain versions (in the worker)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_split_")
    ws0 = {}
    try:
        save_params(os.path.join(work, "params.npz"), params0)
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump({"seed": seed}, f)
        ranks_wall = mp_launch(work, SPLIT_ARG)
        got = []
        for r in range(2):
            with open(os.path.join(work, f"split{r}.json")) as f:
                got.append(json.load(f))
        for name, *_ in SPLIT_RUNS:
            with np.load(os.path.join(work, f"ws_{name}.npz")) as z:
                ws0[name] = {k: torch.as_tensor(z[k]) for k in z.files}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    block = block.slice(0, SPLIT_STEPS * BATCH)
    launches, out = {}, {"ranks_wall_s": ranks_wall, "runs": {}}
    for name, mesh, path, want, per_block in SPLIT_RUNS:
        what = f"multiprocess_split[{name}]"
        a, b = (g["runs"][name] for g in got)
        for key in ("losses", "auc", "ws_digest", "table_digest",
                    "params_digest", "table_keys", "path"):
            if a[key] != b[key]:
                raise AssertionError(f"{what}: the ranks' {key} differ: "
                                     f"{a[key]} vs {b[key]}")
        for g in got:
            r = g["runs"][name]
            n_blocks = len(r["local_row_blocks"])
            predicted = {k: v * n_blocks * SPLIT_STEPS
                         for k, v in per_block.items()}
            if r["launches"] != predicted:
                raise AssertionError(
                    f"{what}: rank {g['rank']} launched {r['launches']}, "
                    f"predicted {predicted} ({n_blocks} row blocks)")
            launches[f"{name}_rank{g['rank']}"] = r["launches"]
        engine, _, _, stats, _ = split_pass(block, params0, mesh, path)
        ref = {"losses": [x for st in stats for x in st["losses"]]}
        close = multicard_close(what, a, ws0.pop(name), ref,
                                host_ws(engine.ws))
        engine.end_pass()
        del engine
        torch.cuda.empty_cache()
        run = {"mesh": mesh, "path": a["path"], "one_process": close,
               "ranks": {g["rank"]: g["runs"][name] for g in got}}
        if name == "m":
            run["cpu_first_loss"] = cpu_first_loss(
                what, block, a["losses"][0], params0, path=path,
                packed=True, mesh=mesh)
        for g in got:
            r = g["runs"][name]
            steady = float(np.median(r["step_ms"][1:]))
            sent = {k[:-len(".tx_bytes")]: v
                    for k, v in r["xproc_per_step"].items()
                    if k.endswith(".tx_bytes")}
            log(f"{what}[rank {g['rank']}]: mesh {mesh}, {a['path']}, "
                f"shards {r['local_shards']} on cuda:0, row blocks "
                f"{r['local_row_blocks']}, losses {r['losses']}, auc "
                f"{r['auc']}, launches {r['launches']}, step device ms "
                f"{r['step_ms']} (steady {steady:.3f}), bytes put on the "
                f"group a step by kind {sent} (total "
                f"{sum(sent.values()):.0f}), cross-process tier "
                f"{r['xproc_per_step'].get('exchange_s', 0.0):.4f} s a step "
                f"(host clock, the device wait before each copy to the "
                f"host included), train {r['train_s']:.2f} s, working-set "
                f"join {r['join_s']:.2f} s, end_pass {r['end_pass_s']:.2f} s "
                f"({r['end_pass_join_bytes']:.0f} B joined); host- and "
                f"loopback-bound with two ranks on one card: no multi-node "
                f"speed; {card_line()}")
        kern = {}
        for kname in ("gather_sorted", "scatter_add_sorted", "gather_pool"):
            per = [g["runs"][name]["kernels"].get(kname) for g in got]
            if per[0] is None:
                continue
            kern[kname] = per[0] | {"max_abs_err": max(
                x["max_abs_err"] for x in per)}
            x = kern[kname]
            log(f"{what}[kernels, rank 0 shard "
                f"{a['kernels']['shard']}]: {kname} {x['ms']:.4f} ms "
                f"(plain {x['plain_ms']:.4f}, library "
                f"{x['library_ms']:.4f}, bound {x['bound_ms']:.4f} by "
                f"{x['bound_by']}); max abs err over both ranks "
                f"{x['max_abs_err']:.3g}")
        run["kernels"] = kern
        out["runs"][name] = run
    out["kernels"] = {k: v for r in out["runs"].values()
                      for k, v in r["kernels"].items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multiprocess_split: runs {[r[0] for r in SPLIT_RUNS]} ranks "
        f"bit-equal, launches as predicted, within rtol 1e-4 / 1e-5 of one "
        f"process on the card, (m)'s first step = the CPU's; ranks "
        f"{ranks_wall:.1f} s of a phase {out['phase_s']:.1f} s")
    return launches, out



def profile_phase(seed: int = 1, symbols=SYMBOLS) -> dict:
    """Short traced passes (2 batches) of the lowerings that phases 3-4
    run once untraced: device time by kernel, per step, and the
    device-busy share (see :func:`profiled`)."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * BATCH)
    out = {}
    for name, path, packed in (("slice_mxu", "mxu", False),
                               ("packed_mxu", "mxu", True),
                               ("packed_fast", "fast", True),
                               ("packed_ragged", "ragged", True)):
        holder = {}
        stats, _, _ = run_pass(block, "cuda", path=path, packed=packed,
                               around_train=tracer(holder))
        out[name] = profiled(name, holder["prof"], stats, symbols)
    return out


def main() -> int:
    if sys.argv[1:2] == [MP_ARG]:
        return multiprocess_rank(sys.argv[2])
    if sys.argv[1:2] == [SPLIT_ARG]:
        return split_rank(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    secs = cuda_lib.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s)")

    phase_s = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        log(f"phase[{name}]: {phase_s[name]:.1f} s")
        return out

    kern = timed("kernels", kernel_phase, dev)
    kern_ex = timed("kernels_w20", kernel_phase, dev, w_pull=W_EX,
                    w_push=W_EX)
    pool = timed("gather_pool", gather_pool_phase, dev)
    for dist in pool:     # the fast path's table layout
        kern[dist]["gather_pool"] = pool[dist]["stride12"]
    slice_launches, slice_out, slice_block, slice_params = timed(
        "slice", slice_phase)
    packed_launches, packed_out, packed_block, packed_params = timed(
        "packed", packed_phase)
    ref_launches, ref_out = timed("reference", reference_phase, slice_block,
                                  slice_params, slice_out["losses"][0])
    amp_launches, amp_out = timed("amp", amp_phase, packed_block,
                                  packed_params, packed_out)
    rules_launches, rules_out = timed("rules", rules_phase)
    models_launches, models_out = timed("models", models_phase)
    cross_launches, cross_out = timed("crossing", crossing_phase,
                                      packed_block, packed_params)
    life_launches, life_out = timed("lifecycle", lifecycle_phase)
    # the pass files of phases 11, 14, 15 and 16 (phase 11 reads the
    # first REC_PASSES of them, phases 14 and 15 one a pass, phase 16
    # FLEET_FILES_PER_PASS a pass), written once
    work = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        paths = timed("files", write_pass_files, work, 6,
                      max(REC_PASSES, len(LIFE_DATES) * CLUSTER_PASSES
                          * FLEET_FILES_PER_PASS))
        rec_launches, rec_out = timed("recovery", recovery_phase,
                                      paths=paths)
        rank_launches, rank_out = timed("rank", rank_phase)
        opt_launches, opt_out = timed("options", options_phase)
        cl_launches, cl_out = timed(
            "cluster", cluster_phase, paths=paths,
            local_pass_wall_s=life_out["mxu_serial"]["median_pass_wall_s"])
        serve_launches, serve_out = timed("serving", serving_phase,
                                          paths=paths)
        fleet_launches, fleet_out = timed("trainer_fleet",
                                          trainer_fleet_phase, paths)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sharded_launches, sharded_out = timed(
        "sharded", sharded_phase, packed_block, packed_params,
        packed_out["mxu"]["losses"][0], kern["uniform"])
    graph_data = {}        # phase 18's graph and pairs, phase 22's (k)
    graph_launches, graph_out = timed("graph", graph_phase, keep=graph_data)
    par_launches, par_out = timed("parallel", parallel_phase)
    mc_launches, mc_out = timed("multicard", multicard_phase, packed_block,
                                packed_params)
    mp_launches, mp_out = timed("multicard_paths", multicard_paths_phase,
                                packed_block, packed_params)
    mm_launches, mm_out = timed("multicard_models", multicard_models_phase,
                                packed_block, packed_params,
                                graph_data=graph_data)
    graph_data.clear()
    mpr_launches, mpr_out = timed("multiprocess", multiprocess_phase,
                                  packed_block, packed_params)
    split_launches, split_out = timed("multiprocess_split",
                                      multiprocess_split_phase,
                                      packed_block, packed_params)
    profile_out = timed("profile", profile_phase)

    by_path = {"slice_mxu": slice_launches,
               **{f"packed_{p}": n for p, n in packed_launches.items()},
               "slice_reference": ref_launches,
               **{f"amp_{p}": n for p, n in amp_launches.items()},
               **{f"rules_{p}": n for p, n in rules_launches.items()},
               **{f"models_{p}": n for p, n in models_launches.items()},
               **{f"crossing_{p}": n for p, n in cross_launches.items()},
               **{f"lifecycle_{p}": n for p, n in life_launches.items()},
               **{f"recovery_{p}": n for p, n in rec_launches.items()},
               **{f"rank_{p}": n for p, n in rank_launches.items()},
               **{f"options_{p}": n for p, n in opt_launches.items()},
               **{f"cluster_{p}": n for p, n in cl_launches.items()},
               **{f"serving_{p}": n for p, n in serve_launches.items()},
               **fleet_launches,
               **{f"sharded_{p}": n for p, n in sharded_launches.items()},
               **graph_launches, **par_launches,
               **{f"multicard_{p}": n for p, n in mc_launches.items()},
               **{f"multicard_paths_{p}": n
                  for p, n in mp_launches.items()},
               **{f"multicard_models_{p}": n
                  for p, n in mm_launches.items()},
               **{f"multiprocess_{p}": n for p, n in mpr_launches.items()},
               **{f"multiprocess_split_{p}": n
                  for p, n in split_launches.items()}}
    line = {"kernels": []}
    for name in KERNELS:
        k = kern["uniform"][name]
        at = {}
        if name in kern_ex["uniform"]:
            # the expand table's width, uniform ids (phase 13's path)
            k20 = kern_ex["uniform"][name]
            at = {"at_w20": {
                f: k20[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")} | {
                "max_abs_err": max(kern_ex[d][name]["max_abs_err"]
                                   for d in kern_ex)}}
        if name in sharded_out["kernels"]:
            # shard 1 of phase 17's run (a): the sentinel-heavy domain
            at["at_sharded"] = {
                f: sharded_out["kernels"][name][f]
                for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err")}
        for run in ("a", "b"):
            # a card shard of phase 20's run: half the table over the
            # run's gathered P
            if name in mc_out[run]["kernels"]:
                at["at_multicard" + ("" if run == "a" else "_b")] = {
                    f: mc_out[run]["kernels"][name][f]
                    for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "max_abs_err")}
        for run, r in mp_out.items():
            # a card row block of phase 21's run: its whole-batch plan
            if isinstance(r, dict) and name in r.get("kernels", {}):
                at[f"at_multicard_paths_{run}"] = {
                    f: r["kernels"][name][f]
                    for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "max_abs_err")}
        if name in mm_out["k"]["kernels"]:
            # the card row block of phase 22's graph run (k): its plan of
            # the epoch's first step, the other block's ids at the sentinel
            at["at_multicard_graph"] = {
                f: mm_out["k"]["kernels"][name][f]
                for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err")}
        if name in mpr_out["kernels"]:
            # a rank's first shard of phase 23, on its plan of the first
            # step (rank 0's times; the error the worse of the two ranks)
            at["at_multiprocess"] = {
                f: mpr_out["kernels"][name][f]
                for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err")}
        if name in split_out["kernels"]:
            # a rank's first row block of phase 24 (the sorted pair on
            # (m)'s shard plan, gather_pool on (o)'s block over the whole
            # batch; rank 0's times, the error the worse of the two ranks)
            at["at_multiprocess_split"] = {
                f: split_out["kernels"][name][f]
                for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err")}
        if name in graph_out["kernels"]:
            # a graph step's plan (phase 18): hub rows and K negatives
            at["at_graph"] = {
                f: graph_out["kernels"][name][f]
                for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err")}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(kern[d][name]["max_abs_err"] for d in kern
                               if name in kern[d]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], **at})
    log("detail: " + json.dumps({"kernels_by_dist": kern,
                                 "kernels_by_dist_w20": kern_ex,
                                 "gather_pool_by_layout": pool,
                                 "slice": slice_out, "packed": packed_out,
                                 "reference": ref_out, "amp": amp_out,
                                 "rules": rules_out, "models": models_out,
                                 "crossing": cross_out,
                                 "lifecycle": life_out, "recovery": rec_out,
                                 "rank": rank_out, "options": opt_out,
                                 "cluster": cl_out,
                                 "serving": serve_out,
                                 "trainer_fleet": fleet_out,
                                 "sharded": sharded_out,
                                 "graph": graph_out,
                                 "parallel": par_out,
                                 "multicard": mc_out,
                                 "multicard_paths": mp_out,
                                 "multicard_models": mm_out,
                                 "multiprocess": mpr_out,
                                 "multiprocess_split": split_out,
                                 "profile": profile_out,
                                 "phase_s": phase_s}))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
