#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-shapes '[["jsd_pairwise", [1, 256, 112, "float64"]], ...]'
    python3 chip_smoke.py --time-shapes '[["apex_threshold", [64, 512, 20], [0, 5]]]'
    python3 chip_smoke.py --approx-only
    python3 chip_smoke.py --mechanisms-only
    python3 chip_smoke.py --filtered-only
    python3 chip_smoke.py --online-only
    python3 chip_smoke.py --sharded-only
    python3 chip_smoke.py --durable-only
    python3 chip_smoke.py --serving-only
    python3 chip_smoke.py --models-only
    python3 chip_smoke.py --train-only
    python3 chip_smoke.py --tools-only
    python3 chip_smoke.py --tune-only
    python3 chip_smoke.py --select-only
    python3 chip_smoke.py --sharded-train-only
    python3 chip_smoke.py --examples-only
    python3 chip_smoke.py --launch-path
    python3 chip_smoke.py --ptxas

It needs a CUDA device and the repository checkout around it, builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` and fails (exit code not
0, no result line) on any fault.  One JSON line per phase:

  1. device   — ``nvidia-smi`` name and power limit, torch/CUDA versions,
                a host-only yardstick's seconds (``host_yardstick``; the
                two single-phase modes below print it at their end too),
                kernel build time, and the FP64 instructions of one IEEE
                ``log`` read from ``cuobjdump -sass`` of a probe kernel (on
                the fast path that K5's positive normal arguments take, and
                in all); K5's bound counts the fast path;
  2. kernels  — each kernel against its plain PyTorch version on the card at
                the main path's shapes: the bound scans at Q = 64 query
                apexes, N = 1,000,000 rows, n = 20 pivots, f32, k = 10,
                cap = 4096, plus smaller calls with ``dims``, ``key="mid"``,
                ``rowmask`` and f64 (K1/K6 within rtol = atol = 2e-5 in f32
                or 1e-12 in f64, K2/K3 exactly equal to a host lexsort and
                count over K1's own f32 matrices); K4 on the table build's
                1M x 20 f64 pivot distances at 1e-12, and in f32 at 3e-4,
                each bit-equal to K4's first design (``_plan="row"``);
                K5 on the build's 1M x 112 rows against the 20 pivots in f64
                at 1e-12 (and exactly 0 for each pivot against itself), the
                refinement shapes 1 x 256 and 1 x 4096 in f64 at 1e-12 and a
                64 x 4096 f32 call at 1e-4; K4 and K5 in f64 at 1e-12 at the
                query shapes, 64 and 1 queries against the 20 pivots and the
                approximate path's 10-pivot prefix.  K4's altitude and K5's
                output are compared squared, before their final sqrt (see
                ``max_err_sq``);
  3. e2e      — the exact path through the public entry points:
                ``build_index(colors_like(n=1_000_000, dim=112), metric,
                n_pivots=20)`` on ``cuda`` for euclidean and jensen_shannon,
                64-query k-NN and range batches, a range batch that overflows
                K3's capacity, 1-D requests, and 256 requests through
                ``SearchService(max_batch=64)``; answers of >= 8 queries per
                task held to a brute-force f64 scan on the card that uses
                the plain JSD, not K5;
  4. approx   — the approximate (truncated-surrogate) path on the same
                corpus: euclidean on the e2e index with ``mode="approx",
                dims=10, refine=64`` queries, jensen_shannon on a fresh
                ``build_index(..., apex_dims=10, refine=64)`` queried in
                ``auto`` mode; per metric 2 x 64-query k-NN and range
                batches, 8 1-D k-NN requests and 256 k-NN requests through
                ``SearchService(max_batch=64)`` (equal to a direct batch).
                After the launch counts are read, >= 8 queries per task are
                checked, with query apexes projected by the plain versions
                (not K4 or K5): k-NN answers are the k smallest (f64 distance, id)
                among the ``refine`` rows a host lexsort of K1's own f32
                mid keys selects, with ``original_calls == dims + refine``;
                range answers keep both sound sides (no row with truncated
                lwb above t(1+eps) + slack, every row with truncated upb
                below t(1-eps) - slack).  Recall@10 and range
                precision/recall against the brute force are printed;
  5. launch_shapes — per kernel, the launches of phases 3 and 4 by shape
                class (``ops.SHAPE_LAUNCHES``, a K2/K3 launch under a row
                mask in its own ``"masked"`` class; each kernel must have
                > 0);
  5a. filtered — filtered search on phase 3's two 1M-row exact indexes with
                a 1M-row ``AttributeStore`` made from ``--seed`` (``shop``
                categorical over 1000 values, Zipf s = 1.1; ``year`` int
                2000-2024; ``price`` lognormal; ``in_stock`` 90% true), the
                launch counts set to 0 before and read after (its own
                ``launch_shapes`` lines, ``launch_phase="filtered"``; each
                kernel must have > 0): per metric and predicate (the most
                common shop, recent years in stock, in stock, the ten
                rarest shops) a 64-query k-NN (k=10) and range batch under
                the planner's choice (its strategy printed; the CPU tests
                hold it to the JAX package's plan at these stats) and under
                each forced strategy (a forced-postfilter k-NN batch: 16
                queries, 8 under the rarest shops), one approximate pushdown batch (dims 10, refine
                64) and 8 1-D pushdown requests; walls, ``original_calls``
                and overflows printed.  After the counts are read every
                exact answer is held to an f64 brute force over the
                matching rows and the approximate ones to their own
                candidates (the matching rows read from the generated
                columns, not from the ``AttributeStore``);
  5b. online — ``build_index(colors-1M, metric, mutable=True,
                compact_threshold=None, attributes=store)``, counts set to
                0 before and read after (``launch_phase="online"``): rounds
                of 2,048 adds with attributes (rows from ``colors_like``
                with another seed), 1,024 removes and 256 upserts, then a
                64-query exact k-NN, range and filtered k-NN batch (the
                filtered one forced to pushdown and under the planner's
                choice); euclidean 3 rounds, jensen_shannon 1, then
                ``compact()`` and one more round with 8 1-D k-NN requests.
                Mutation, materialise and compaction ms, overflowed queries
                and ``original_calls`` printed; every answer held to an f64
                brute force over an oracle's live rows and their generated
                attribute columns, kept apart from the index and its store;
  5c. sharded — colors-1M as ``build_index(..., shards=4)`` (four 250,000-row
                segments on one projector), the launch counts set to 0
                before and read after (``launch_phase="sharded"``; each
                kernel must have > 0): per metric a 64-query exact k-NN
                batch (overflow routes printed per shard), exact range
                batches at query 0's 10th and 100th neighbour distances
                through the device filter (K3 over the 1M-row flat table,
                its class (64, 256, 20) must be launched; the queries whose
                256 slots overflowed printed) and under
                ``device_filter=False``, one range batch under each of the
                layouts ``{"replicas": 2}`` and ``{"rows": "replicated"}``
                (both must clamp to the 1 x 1 grid and answer alike), an
                ``apex_dims=10, refine=64`` sharded batch, 8 1-D k-NN and
                range requests, 128 requests through ``SearchService`` under
                overlapped and sequential fan-out (wall, p50, p99 and
                ``original_calls``), a mutable ``shards=4`` index through
                rounds of 2,048 adds, 1,024 removes and 256 upserts
                (euclidean 2, JSD 1) with k-NN and range batches, then
                ``compact()`` and one more round; euclidean also LAESA with
                ``shards=4`` and a save / load round trip of a 112,682-row
                sharded mutable index (same answers and ``original_calls``).
                After the counts are read every exact answer is held to an
                f64 brute force (the mutable index's over an oracle's live
                rows), the approximate ones to their shards' own candidates;
  5e. durable — colors-1M behind a WAL: ``build_index(colors-1M, metric,
                durable=True, wal_dir=<a fresh directory under build/>,
                fsync_every=8, checkpoint_every=None, drift_threshold=0.25,
                attributes=store)`` (4 GiB free disk checked first; the
                directories removed at the end, on failure too), the
                launch counts set to 0 before and read after
                (``launch_phase="durable"``; each kernel must have > 0):
                rounds of 16 add records of 128 rows with attributes (rows
                from the base's own mixture), 8 remove records of 128 ids
                and 2 upsert records of 128, then a 64-query exact k-NN,
                range and filtered (``shop_top``, the planner's choice)
                batch, the last round also 8 1-D k-NN requests (euclidean 2
                rounds, JSD 1); one more add record, ``flush()`` and two
                copies of the open directory: copy A reopened with
                ``open_durable`` answers bit-equal to the live index (ids,
                distances, ``QueryStats``), copy B, its last record (that
                add) cut in half, replays one record fewer, holds none of
                its ids and answers as the brute force without it; then a
                ``BackgroundCompactor`` and a reader thread looping 64-query
                k-NN batches while a shifted stream (``np.roll(colors_like,
                112 // 3)``, without attributes) raises ``drift_pending``
                and the compactor refits (exactly one refit, the generation
                bumped, no error, no torn reader answer), then ``compact()``
                racing a reader; then ``checkpoint()``, ``save()`` and
                ``load_index`` (equal answers).  Printed: WAL append p50 /
                p99 and fsyncs, mutation ms, WAL bytes, recovery s split
                into checkpoint load, replay and materialisation with the
                records replayed, refit s, the longest swap under the write
                lock, the drift statistic and the shifted queries' bound
                width and candidates before and after the refit, reader
                batch walls, checkpoint / save / load s and bytes.  After
                the counts are read every round's, copy B's and the
                quiesced answers are held to an f64 brute force over an
                oracle's rows (rows without attributes match no predicate);
  5f. serving — the serving stack, the launch counts set to 0 before and
                read after (``launch_phase="serving"``; each kernel must have
                > 0): the CLI's shard_map engine in-process
                (``repro_torch.launch.serve.main(["--n-objects", "1000000",
                "--queries", "64", "--batches", "4", "--metric",
                "jensen_shannon", "--selectivity", "1e-4"])``: K5 pivot
                distances, K4 projection, K3 (64, 256, 20) on the 1 x 1 grid;
                the queries whose candidates overflow the 256 slots
                printed); ``SearchService(max_batch=64, max_queue=256)`` on
                phase 3's two exact indexes, 256 k=10 requests per metric
                through ``run_poisson_open_loop`` at 4x the sequential
                single-request QPS, each equal to a direct ``index.query``;
                ``IndexRegistry(max_concurrent_batches=4, max_batch=64,
                max_queue=256)`` behind the HTTP front end with ``colors``
                (phase 3's euclidean index, queue bound 64), ``colors_half``
                (500,000 rows, seed-1 pivots) and ``colors_durable`` (a
                112,682-row JSD durable directory under build/serving_smoke/
                with 4 WAL records past its checkpoint, added by path, removed
                at the end, on failure too): 192 round-robin requests at half
                ``colors``'s sequential QPS with deadlines of 4x each tenant's
                single-request wall, a burst of 8 threads x 64 concurrent
                ``mode="auto"`` requests (shed and degraded), an HTTP upsert
                of 128 rows and remove of 64 ids, ``registry.close()`` and a
                re-add by path answering as before; then ``python -m
                repro_torch.launch.serve --engine batch --workload frontend``
                as a subprocess.  After the counts are read: the CLI's answers
                against an f64 brute force (overflowing queries a subset;
                rows inside the t(1 +- eps) +- 1e-9 band counted), 8 answers
                per metric and tenant (the durable tenant's over an oracle's
                live rows) against the brute force, every degraded answer
                from its own candidates;
  5d. mechanisms — the paper's other mechanisms, with the launch counts set
                to 0 before and read after (its own ``launch_shapes`` lines,
                ``launch_phase="mechanisms"``; each kernel must have > 0):
                LAESA at colors-1M (``build_index(kind="laesa",
                n_pivots=20)`` on ``cuda``, euclidean and jensen_shannon),
                one 64-query batch each of exact k-NN (k=10) and range and
                of approximate k-NN and range (``mode="approx", dims=10,
                refine=64``) and 8 timed 1-D exact k-NN requests; then
                ``ExactSearchEngine`` over the first 112,682 rows (the
                paper's colors size) with all five mechanisms, per
                mechanism an ``ENGINE_Q``-query (4) range batch (query 0's
                1e-3 distance quantile), a k-NN batch of as many queries
                and ``ENGINE_1D`` (1) 1-D request of each, printing calls
                per query (the paper's Table 3), wall ms per query
                (batched and 1-D) and build seconds.  After
                the counts are read: the card's LAESA ``bounds_batch`` bit-equal
                to a host numpy scan for 8 queries (full and dims=10),
                exact answers equal to the brute force (all engine answers,
                8 LAESA queries per task), approximate LAESA answers from
                their own candidates (as ``verify_approx``), and
                recall@10 and range precision/recall printed;
  6. kernel_shape — one row per (kernel, shape class) holding >= 10% of its
                kernel's launches, plus the kernel's headline shape where the main
                path launched it: the wrapper called as the main path calls
                it, on operands made from the JSD approximate index, held to
                its plain version (K2/K3 exactly, to a selection over K1's
                own matrices), CUDA-event times of wrapper and plain
                version, each launched kernel's device time from
                ``torch.profiler`` (``device_ms``: K3's scan and merge
                apart), the bound at that shape and, for K1/K6, the time of
                the one-call yardstick ``torch.cdist`` (``library_ms``);
                K4 rows also hold the wrapper bit-equal to the first design
                and, where it runs the warp or row plan, carry
                ``launch_floor_ms``, the CUDA-event time of back-to-back
                launches of the library's empty kernel through ctypes.
                K3 rows are also timed at k-NN pass B's thresholds (the
                K-th smallest upb, ``pass_b_ms``: every query overflows at
                1M rows).  K1, K3 and K4 rows are timed again under the
                launch plan that runs their previous design
                (``PREVIOUS_DESIGN``).  Then the same for the mechanisms
                phase's launch counts (``launch_phase="mechanisms"``): each
                of its classes of every kernel, K1-K6, timed and held to its
                plain version on operands made from that phase's
                jensen_shannon engine (its 112,682-row N_seq table and
                projector; raw rows from the 1M-row corpus, which the
                LAESA build's K5 class needs);
  7. ``{"kernels": [...]}`` — those rows with their launches and
                ``table_rows`` (K1, K3 and K4 with ``plan``,
                ``previous_design_ms`` and ``previous_design_device_ms``):
                first the main path's, then the filtered, online, sharded,
                durable, serving and mechanisms phases' (and, after the
                train phase, the tools phase's), tagged with ``launch_phase`` and carrying
                that phase's launches and shares.  The filtered rows are
                timed on the 1M-row JSD index with the most common shop's
                row mask (masked K2 (64, 10, upb, 20) and K3 (64, 512, 20)
                always among them); the online rows on the JSD online
                index's 1M-row base, its K2/K3 rows narrower than 4,096 on
                its delta segment with the predicate's mask, and K4 at the
                add-burst class (2,304, 20, f64) always among them; the
                sharded rows each on the rows its class scans: the device
                filter's K3 (64, 256, 20) on the JSD index's 1M-row flat
                table, every other class on its shard 0 (250,000 rows), and
                a ``device_filter`` line timing the whole filter (K3 and the
                K1 completion of the overflowing queries' histograms) against
                its plain version (``selection="sort"``, bit-equal) and the
                completion alone; the durable rows on the jensen_shannon
                crash copy A (its 1M-row base; K2/K3 narrower than 4,096 on
                its replayed delta under the filtered batch's mask), K4 at
                the replay's materialisation class and K5 at the drift
                witness class (8, 128, 112, f64) always among them;
  8. models — the model half (``repro_torch.configs``, ``models``,
                ``data``), the launch counts set to 0 before and read after
                (the paper's serve step must launch K4 and K3), f32 with no
                TF32 unless a config says bf16: every registry arch at its
                ``smoke_cfg`` on one seed's parameters, on the card against
                the port on the CPU at rtol = atol = 1e-4 (``MODEL_TOL``):
                the five LMs' prefill logits and one decode step (MoE
                drop-free), mixtral's decode from an empty ring past its
                wrap, the RecSys serve scores and 100-candidate retrieval,
                the three GCN forwards, ``nsimplex-colors`` through
                ``build_serve_step`` (equal histograms and candidates, no
                true result lost); qwen2-1.5b at its full config (28 layers,
                bf16, 3.1 GB) at B = 4: chunked against naive prefill at
                S = 2,048, the chunked prefill at S = 4,096 and 32 decode
                steps, the first held to the forward's logits at S;
                mixtral-8x7b at full width cut to 2 of its 32 layers
                (``MODEL_SIZES``): chunked against naive prefill at S =
                4,608 (past the 4,096 window) and 8 decode steps on its
                ring, a drop-free prefill at S = 4,088 whose first decode
                step is held to the forward and whose 16 steps cross the
                ring's wrap; two bf16 paths agree within 5% of the logits'
                largest magnitude (``BF16_REL_TOL``); fm and xdeepfm at
                serve_p99 (batch 512, 16.4M table rows), sasrec and mind at
                retrieval_cand (1 x 1,000,000 candidates), gcn-cora at
                full_graph_sm on ``cora_like``, card against CPU, ms per
                call.  ms per prefill and decode step, tokens per second
                and ``torch.cuda.max_memory_allocated`` per LM cell;
  9. train  — training (``repro_torch.train``, ``launch.steps``,
                ``launch.train``; no kernel of this repo on its path): every
                trainable registry arch at its ``smoke_cfg``, 5 AdamW steps
                on the card and on the CPU (the first step's loss and every
                gradient leaf, each step's loss, the moments within 1e-4 of
                each leaf's largest magnitude, ``TRAIN_TOL``; the parameters
                within that plus 2·Σlr); qwen2-1.5b at its full config through
                the ``train_4k`` cell, global batch cut 256 -> 8 (accum 8 of
                one 4,096-token sequence), bf16 moments: the ``opt=True``
                cell's first loss within 1% of the plain one's, 4 steps with
                the loss falling, step s, tokens/s, the model-FLOPs share of
                989 TFLOP/s, the device busy share of one profiled step, peak
                memory, a checkpoint of params and moments saved and restored
                bit-equal (timed), ``TrainLoop`` recovering one injected
                failure from it (the replayed step's loss equal);
                mixtral-8x7b at full width, 2 of 32 layers, 2 x 4,096 tokens:
                3 steps, the loss falling; fm / xdeepfm / sasrec / mind at
                ``train_batch`` 65,536 (halved while a step runs out of
                memory, printed as a ``cut``); gcn-cora's four cells at their
                published sizes; ``nsimplex-colors``' ``serve_1m`` cell with
                ``opt=True`` on the colors corpus, the launch counts set to 0
                before and read after (K4 and K3 must launch); the train CLI
                as a subprocess (``TRAIN_SIZES``, ``TRAIN_OPT``);
  10. tools — the tooling slice (``repro_torch.core.distortion``,
                ``baselines``, ``launch.dryrun``), the launch counts set to 0
                before and read after (K4 and K5 must launch): the paper's
                Fig. 2 on ``colors_like(n=112,682, dim=112)`` in f64 on the
                card, k in {5, 10, 20, 50}, ``measure_distortion``'s 20,000
                pairs; Euclidean through n-simplex (k random pivots), PCA,
                JL and LMDS (max(k + 2, 2k) landmarks), JSD through n-simplex
                and LMDS; D per (metric, k, method) with each map's fit and
                projection wall ms; every n-simplex ratio true / apex >=
                1 - 1e-9, every D finite, the card's n-simplex and JL D equal
                to the port's on the CPU over the same pairs within 1e-9
                relative; whether n-simplex beats JL printed.  The
                projector's gemm (K4), paper and solve modes on 4,096 rows at
                n = 20 within 1e-10 (altitudes squared).  The dry run, one
                ``python -m repro_torch.launch.dryrun`` process a cell
                (host work, started at the phase's start and waited for
                before anything timed runs; the seconds printed): the
                train phase's two cells on one card (qwen2-1.5b's train_4k
                at full config, 8 microbatches; mixtral-8x7b's at 2 layers,
                2 microbatches), counted FLOPs against ``model_flops``, the
                dominant roofline term and the bound seconds beside the
                train phase's measured step; and qwen2-1.5b's train_4k and
                decode_32k and mixtral-8x7b's train_4k on the reference's
                production meshes (single (16, 16), multi (2, 16, 16))
                through ``--calibrate``'s shallow variants, each record ok
                with a collective term above 0 (hard), its collective bytes
                by kind, terms and walk seconds printed.  Then
                ``{"tools_kernels": [...]}``: each K4 and K5 class with >= 10%
                of the phase's launches (``launch_phase="tools"``), timed and
                held to its plain version on a JSD n-simplex index of 50
                pivots over the Fig. 2 corpus; they join the kernels line;
  11. tune  — the launch-plan tuner (``repro_torch.kernels.tuning``) on the
                e2e build's 1M-row n = 20 table, the launch counts set to 0
                before and read after (K1-K3 must launch): ``autotune`` of
                K1 (Q, dims 20), K2 (Q, k 10, upb, 20) and K3 (Q, cap 512,
                20, k-NN pass B's thresholds) at Q = 1 and 64, each
                candidate validated against its plain version, then timed
                with CUDA events; every candidate's validity and ms, the
                default plan's ms and the winner printed; the default in the
                space and valid, no invalid winner, and with no cache file
                every ``lookup`` the default (hard).  No cache is written;
                the memo is reset at the end.  Each problem's bound (and
                K1's ``torch.cdist`` ms) as the kernel rows compute them;
 12. select — K2/K3 over their whole contract (``phase_select``; the full
                run drives it right after the approx phase, on the e2e
                euclidean index, the launch counts set to 0 before and read
                after): exact k-NN at k = 300 (pass B's K3 at 4,800, past
                the 4,096 of the shared-memory plans), approximate k-NN at
                refine = 8,192 (K2 8,192 wide), the device filter at 8,192
                slots over the 1M-row table, and K2 (64, 10, upb, 20) and
                K3 (64, 512, 20) on the index's 1M x 20 f64 table, K2
                (64, 8,192, upb, 20) and K3 (64, 16,384, 20) on its f32
                one; every class launched (hard), each direct call and the
                filter equal to their plain versions, 8 queries of each
                k-NN batch held to the brute force; its kernel rows
                (``{"select_kernels": [...]}``, tagged ``launch_phase:
                "select"``; f64 classes end in ``"float64"``) join the
                kernels line;
 13. sharded_train — ``python -m repro_torch.launch.process_train`` with one
                NCCL process per visible card on a (cards, 1) mesh (a world
                of one on a one-card machine), the reference's sharded
                test's reduced mixtral, 4 steps, held to the one-process
                step on the card at 1e-5
                (parameters, losses, gradient norms), shards gathering back
                to their leaves, the loss falling (its launcher in the
                background, beside the rest of the phase); one start of two
                gloo ranks on card 0 (``--device cuda``: all-gathers and
                reduce-scatters staged through host memory, the printed
                ``transport``) for three runs (``--then``): on (1, 2),
                tensor-parallel over ``model``, qwen2-1.5b at full width
                cut to 2 of 28 layers (f32), 4 train steps, a prefill at
                B 2 x S 2,048 and 16 decode steps, and mixtral-8x7b at
                full width cut to 1 of 32 layers (f32, 8 experts over
                ``model``), 4 train steps; on (2, 1) the opt train cell of
                the reference's reduced mixtral, each rank dispatching its
                own tokens with per-shard capacity; the ranks' shards
                written under ``build/tp_smoke/`` (removed) and held after
                they exit to the one-process port (parameters 1e-5, or
                1e-4 of each leaf's largest magnitude for the full-width
                mixtral; logits and the cache 1e-4); each run's step,
                prefill and decode ms, every rank's
                ``max_memory_allocated`` and parameter bytes and the
                collective bytes per decode step printed; in the same start
                of the two ranks the other families at full config
                (``CELL_RUNS``): the search serve cell on (2, 1), baseline
                and opt (1,000,000 colors rows under sqrt-JSD padded to
                1,007,616 with rows of altitude +inf, 32 pivots, Q 1,024),
                every rank's histograms and slots equal to the one-process
                grid's, summing to the padded table, no padding row a
                candidate, each rank's K4 / K3 / K1 launches counted from 0
                in the step's first call and its K4, K3 and K1 outputs held
                to their plain versions; fm (the 16,430,080-row table split
                over model) training 2 steps and serving at B 512 and
                sasrec's 1M-candidate retrieval on (1, 2); ogb_products at
                its published size on (2, 1), 1 step; the NCCL world runs
                the search cell's opt variant after its train run; then
                eight ranks for qwen2-1.5b's 12 heads over a model axis of
                8 (1 of 28 layers, f32, 2 steps, a prefill at B 2 x S 512,
                8 decode steps); one more untimed decode step of qwen2 and
                call of the search cell under ``op_walk.CollectiveCounter``
                (``--count-collectives``), printed beside
                ``TensorParallel.moved``, the decode step's bytes equal by
                kind to the dry run's meta walk of that cell on (1, 2)
                (hard); the search cell's K4 (1,024, 32), K3
                (1,024, 8, 32) and K1 classes timed on rank 0's inputs in
                this process join the kernels line; after the train phase;
 14. examples — every walkthrough of ``repro_torch.examples`` (the JAX
                package's ``examples/``, one module each) called in-process
                on the card under its reference run's flags, then
                ``train_lm --full-100m`` (lm-100m, 10 steps), each in a fresh
                temporary directory: its own assertions (exact against brute
                force, bit-identical bursts, recoveries and grids, training
                reduces the loss), its summary held to
                ``src/repro_torch/examples/reference_summaries.json`` (the
                CPU tests keep that file equal to a fresh run of the JAX
                package's scripts; counts within the run's own margins),
                each walkthrough's seconds and kernel launches (the delta of
                ``ops.LAUNCHES``) printed, K1-K6 each launched by some
                walkthrough; after the tune phase;
then the full run's seconds (and each phase's, ``phase_seconds``), the
``kernels`` line, the card's ``nvidia-smi`` line, and last the device
contract line.  The run points the tuning cache
(``REPRO_TORCH_KERNEL_TUNE_CACHE``) at a fresh temporary path, removed at
the end, so no phase reads a tuning file left on the machine.

``--time-shapes`` skips phases 2-5 and 7: it builds the JSD approximate index
and prints ``{"shape_times": [...]}`` for the given (kernel, shape class)
pairs, so two checkouts can be timed in turns on one card; an entry
``[kernel, shape class, plan]`` forces K1's (``"stream"``, ``"tile"``),
K3's (``[G, S]``; G = 0 is the first design, one query per block) or K4's
(``"row"``, the first design, ``"stream"``, ``"warp"``) launch plan; a K1
or K3 class of more queries than the 256 query rows repeats them.
``--approx-only`` runs phase 4 alone, with its checks, so two checkouts'
approximate batch and service wall times can be taken in turns on one
card; ``--mechanisms-only`` runs phase 5d alone, with its checks, and
prints its kernel rows as ``{"mechanisms_kernels": [...]}``;
``--filtered-only``, ``--online-only``, ``--sharded-only``,
``--durable-only`` and ``--serving-only`` run phase 5a, 5b, 5c, 5e or 5f
alone, with their checks, and print ``{"filtered_kernels": [...]}``,
``{"online_kernels": [...]}``, ``{"sharded_kernels": [...]}``,
``{"durable_kernels": [...]}`` or ``{"serving_kernels": [...]}`` (timed on
the 1M-row JSD exact index, the serve step's K3 (64, 256, 20) always among
them).
``--models-only`` runs phase 8 alone, with its checks; ``--train-only``
phase 9; ``--tools-only`` phase 10; ``--tune-only`` phase 11;
``--select-only`` phase 12; ``--sharded-train-only`` phase 13;
``--examples-only`` phase 14.
``--launch-path`` times each step of K4's query path at (1, 20, f64),
and K1's and K5's small calls, alone on the host clock (``launch_path``;
copied into an older checkout it times that checkout's path).  ``--ptxas``
prints the registers, spills and stack of apex_project.cu's kernels from
``nvcc -Xptxas -v`` and that compile's seconds.
"""

from __future__ import annotations

import atexit
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SEED = 20170726
N_ROWS, DIM, N_PIVOTS = 1_000_000, 112, 20
Q, K, CAP = 64, 10, 4096
#: the approximate phase's truncation and re-rank budget
APPROX_DIMS, REFINE = 10, 64
#: the mechanisms phase's engine: the paper's colors size (SISAP colors,
#: 112,682 rows), 4 queries per task and 1 1-D request (16 queries until
#: the tools and tune phases joined the run, 8 until phase 13 ran every
#: family on a ProcessMesh and took 115 s where it had taken 59, 6 until a
#: host 29% slower by the yardstick ran the whole run in 1,206.6 s with the
#: mechanisms phase at 176.4 s: the tree mechanisms' host path takes
#: 0.3-2.6 s a query, ~13 s a query over the engine's tasks, and the full
#: run must stay well inside its time limit; 2 1-D requests until the
#: examples phase joined the run and took 7.40 s of it, where the second
#: request took 9.05 s over the engine's mechanisms and tasks), range at a
#: 1e-3 selectivity
ENGINE_ROWS, ENGINE_Q, ENGINE_1D, ENGINE_SELECTIVITY = 112_682, 4, 1, 1e-3
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 / f64
#: FLOP/s outside the tensor cores and dense bf16 FLOP/s; bound in main()
#: from their one home, ``repro_torch.launch.roofline``
HBM_BPS = F32_FLOPS = F64_FLOPS = BF16_FLOPS = None
F32_TOL, F64_TOL = 2e-5, 1e-12
#: f32 tolerances of K4 and K5 (tests/test_kernels.py:79 and :111)
K4_F32_TOL, K5_F32_TOL = 3e-4, 1e-4
SENTINEL = 2**31 - 1
#: the device the phases build their indexes on
DEVICE = "cuda"
KERNEL_INFO = {
    "apex_bounds_batch": ("K1", "src/repro_torch/kernels/csrc/apex_bounds_batch.cu",
                          "src/repro/kernels/apex_bounds_batch.py:205"),
    "apex_topk": ("K2", "src/repro_torch/kernels/csrc/select_epilogue.cu",
                  "src/repro/kernels/select_epilogue.py:236"),
    "apex_threshold": ("K3", "src/repro_torch/kernels/csrc/select_epilogue.cu",
                       "src/repro/kernels/select_epilogue.py:293"),
    "apex_project": ("K4", "src/repro_torch/kernels/csrc/apex_project.cu",
                     "src/repro/kernels/apex_project.py:47"),
    "jsd_pairwise": ("K5", "src/repro_torch/kernels/csrc/jsd_pairwise.cu",
                     "src/repro/kernels/jsd_distance.py:46"),
    "apex_bounds": ("K6", "src/repro_torch/kernels/csrc/apex_bounds.cu",
                    "src/repro/kernels/apex_bounds.py:45"),
}
#: kernels a search phase need not launch: exact k-NN no longer takes K1
#: (its overflow route re-runs K3), so K1 runs there only where a range query
#: overflows K3's slots, which a phase's traffic need not reach
ROUTE_ONLY = ("apex_bounds_batch",)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_yardstick() -> float:
    """Seconds of a fixed host-only workload (numpy sorts and a Python
    loop).  Host-bound wall times (small wrapper calls, per-query routes)
    move with the host the card shares; two A/B turns whose yardsticks
    differ differ in the host, not only in the program."""
    a = np.random.default_rng(0).random(200_000)
    t0 = time.perf_counter()
    for _ in range(40):
        np.sort(a)
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return time.perf_counter() - t0


def time_ms(torch, fn, reps=10) -> float:
    """Mean CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_events(torch, fn, reps):
    """``torch.profiler``'s host and device events of ``reps`` calls of
    ``fn``, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.events()


def device_ms(torch, fn, reps=10) -> dict:
    """Device time per call of each kernel ``fn`` launches, by kernel name,
    from ``torch.profiler`` (empty where the profiler records no device
    activity): it separates a kernel's own time from the wrapper's host
    path, and the phases of a multi-kernel wrapper (scan, merge)."""
    out = {}
    for e in profiled_events(torch, fn, reps):
        if e.device_type.name == "CUDA":
            bare = re.split(r"[<(]", e.name.replace("(anonymous namespace)::", ""))[0]
            name = re.sub(r"^(void )?.*::", "", bare).removeprefix("void ").strip() or e.name
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def roofline(bytes_, ops, flops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_ / HBM_BPS * 1e3, ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def select_bound(Q_, rows, n_, dims, q_numel, out_bytes, kept, squares=1, mask_bytes=0, itemsize=4):
    """Bound of a fused selection scan (K2, K3; ``itemsize`` 4 for an f32
    table against the f32 peak, 8 for f64 against the f64 peak): the ``rows`` table rows
    the answer needs (every row, or a row mask's allowed rows), the queries
    and the ``mask_bytes`` of a uint8 row mask read once and the selection
    written once, against the operations the answer needs.  Per (query,
    needed row): the head dot product, 2(dims - 1), and the squared bounds
    the key is decided on (3 for the head norm, 3 for each square:
    ``squares`` is 2 for K2's mid key, else 1); no square root, since a
    squared bound decides every row that does not enter.  Per kept row: the
    other square and the two square roots, 6."""
    return roofline(rows * n_ * itemsize + q_numel * itemsize + mask_bytes + out_bytes,
                    Q_ * rows * (2 * (dims - 1) + 3 + 3 * squares) + kept * 6,
                    F64_FLOPS if itemsize == 8 else F32_FLOPS)


def bound(Q_, N_, n_, itemsize, out_bytes, flops_per_s):
    """Bound of a bound scan: bytes moved (inputs read once, outputs written
    once) against ~2(n-1) + 12 operations per pair."""
    return roofline((N_ * n_ + Q_ * n_) * itemsize + out_bytes, Q_ * N_ * (2 * (n_ - 1) + 12), flops_per_s)


_FP64_FLOPS_OF = {"DFMA": 2, "DADD": 1, "DMUL": 1}
_FP64_OPS = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")


def log_cost(build) -> dict:
    """FP64 instructions of one IEEE ``log(double)`` on this card, read from
    ``cuobjdump -sass`` of a one-line probe compiled with the kernels' flags.
    ``fast_path_*`` counts what a positive normal input (every ``log`` that
    K5 takes: its argument is > 1e-12) executes: the FP64 instructions that
    carry no predicate guard on the straight line from the entry to the
    first ``EXIT``.  The guarded ones are the routine's special-value code
    (the subnormal rescale, the result for 0, negatives, inf and NaN, and
    the branch that then skips the polynomial).  ``static_*`` counts every
    FP64 instruction of the probe.  Flops: DFMA 2, DADD and DMUL 1."""
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp) / "log_probe.cu", Path(tmp) / "log_probe.cubin"
        src.write_text('extern "C" __global__ void log_probe(const double* x, double* y) '
                       "{ y[threadIdx.x] = log(x[threadIdx.x]); }\n")
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-cubin", str(src), "-o", str(cubin)],
                       check=True, capture_output=True, timeout=300)
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True, timeout=120).stdout
    code = re.findall(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", sass)
    fp64 = [op for _, op in code if op in _FP64_OPS]
    fast = []
    for guard, op in code:
        if op == "EXIT" and not guard:
            break
        check(guard or op not in ("BRA", "JMP", "CALL", "RET"), "the log probe's fast path is not a straight line")
        if op in _FP64_OPS and not guard:
            fast.append(op)
    check(len(fast) > 0, "no FP64 instruction found on the log probe's fast path")
    return {"static_fp64_instructions": len(fp64), "static_flops": sum(_FP64_FLOPS_OF.get(op, 0) for op in fp64),
            "fast_path_fp64_instructions": len(fast),
            "fast_path_flops": sum(_FP64_FLOPS_OF.get(op, 0) for op in fast), "all_instructions": len(code)}


def ptxas_report(build, source="apex_project.cu") -> dict:
    """Registers, spills and stack of each kernel in one source, from
    ``nvcc -Xptxas -v`` with the kernels' flags, and that compile's seconds.
    Kernels are named (kernel, dtype, head width) from their mangled names."""
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", str(build._CSRC / source),
                              "-o", str(Path(tmp) / "k.cubin")], capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"nvcc -Xptxas -v failed on {source}: {res.stderr[-2000:]}")
    kernels, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        info = kernels.setdefault(name, {}) if name else None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and info is not None:
            info.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and info is not None:
            info["registers"] = int(m.group(1))
    rows = []
    for mangled, info in kernels.items():
        m = re.search(r"(apex_project_(?:stream_|warp_)?kernel|empty_kernel)(?:I([fd])(?:Li(\d+)E)?)?", mangled)
        if m and "registers" in info:
            rows.append(dict(kernel=m.group(1), dtype={"f": "float32", "d": "float64"}.get(m.group(2)),
                             head=int(m.group(3)) if m.group(3) else None, **info))
    return {"source": source, "seconds": seconds, "kernels": sorted(rows, key=lambda r: (r["kernel"], str(r["dtype"]),
                                                                                        r["head"] or 0))}


def launch_path(torch, ops, build, proj, query, reps=10_000) -> list:
    """Host-clock microseconds per call of each step of K4's query path at
    (1, n, f64), each taken alone over ``reps`` back-to-back calls (then one
    synchronise): the steps of the wrapper as it was before its launch path
    was cut, the steps that replaced them, and the whole calls, K1's and
    K5's small calls among them.  A step that launches enqueues ``reps``
    kernels, so it reads the larger of the host cost and the kernel's
    device time."""
    dev = proj.pivots_t.device
    d2 = proj.pivot_distances(query[None]).contiguous()
    d1 = d2[0].clone()
    L, s = proj._Linv_t, proj._sq_norms_t
    B, n = d2.shape
    h = n - 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = build.library().repro_apex_project_f64
    out = torch.empty_like(d2)
    args = [d2.data_ptr(), B, n, L.data_ptr(), s.data_ptr(), out.data_ptr()]
    if len(fn.argtypes) == 9:       # plan and SM count
        args += [ops._K4_PLANS[ops.apex_project_plan(B, n, sms)], sms]
    args.append(ops._stream(dev))

    def import_library():
        from repro_torch.kernels.build import library  # noqa: F401

    # the two other small wrappers that share ``_stream`` and the counters:
    # K1 at Q = 1 against a 1M-row table (device-bound: ~0.03 ms on the card)
    # and K5 at a refinement chunk (host-bound)
    g = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.rand((N_ROWS, n), generator=g, dtype=torch.float32, device=dev)
    q32 = torch.rand((1, n), generator=g, dtype=torch.float32, device=dev)
    xj = torch.rand((1, DIM), generator=g, dtype=torch.float64, device=dev)
    yj = torch.rand((256, DIM), generator=g, dtype=torch.float64, device=dev)

    steps = [
        ("torch.as_tensor of f64 distances on the card", lambda: torch.as_tensor(d1, dtype=torch.float64, device=dev)),
        ("torch.atleast_2d", lambda: torch.atleast_2d(d1)),
        ("index d[None]", lambda: d1[None]),
        ("index out[0]", lambda: d2[0]),
        ("shape checks", lambda: d2.ndim != 2 or d2.shape[1] < 2 or L.shape != (h, h) or s.shape != (h,)),
        ("ops._check_float", lambda: ops._check_float(d2, L, s, what="apex_project")),
        ("dtype checks by identity", lambda: d2.dtype is torch.float64 and L.dtype is d2.dtype and s.dtype is d2.dtype),
        ("ops._on_cuda", lambda: ops._on_cuda(d2, L, s)),
        ("get_device x3", lambda: (d2.get_device(), L.get_device(), s.get_device())),
        ("import of build.library", import_library),
        ("contiguous x3", lambda: (d2.contiguous(), L.contiguous(), s.contiguous())),
        ("is_contiguous x3", lambda: (d2.is_contiguous(), L.is_contiguous(), s.is_contiguous())),
        ("torch.empty_like", lambda: torch.empty_like(d2)),
        ("library() and function lookup", lambda: build.library().repro_apex_project_f64),
        ("torch.cuda.current_stream().cuda_stream", lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("ops._stream", lambda: ops._stream(dev)),
        ("data_ptr x4", lambda: (d2.data_ptr(), L.data_ptr(), s.data_ptr(), out.data_ptr())),
        ("ctypes call (one launch)", lambda: fn(*args)),
        ("ops._counted", lambda: ops._counted("apex_project", B=B, n=n, dtype="float64")),
        ("ops.apex_project (1, n)", lambda: ops.apex_project(d2, L, s)),
        ("project_distances (n,)", lambda: proj.project_distances(d1)),
        ("project_distances (1, n)", lambda: proj.project_distances(d2)),
        ("ops.apex_bounds_batch (1, n) against 1M rows", lambda: ops.apex_bounds_batch(table, q32)),
        ("ops.jsd_pairwise (1, 256, 112) f64", lambda: ops.jsd_pairwise(xj, yj)),
    ]
    rows = []
    for label, step in steps:
        for _ in range(200):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        rows.append({"step": label, "us": (time.perf_counter() - t0) / reps * 1e6})
    ops.reset_launches()
    return rows


def max_err(torch, got, want, tol):
    """max |got - want|, asserting |got - want| <= tol + tol * |want|."""
    diff = (got - want).abs()
    check(bool((diff <= tol + tol * want.abs()).all()), f"kernel disagrees with plain beyond {tol}")
    return float(diff.max())


def max_err_sq(torch, got, want, tol):
    """``max_err`` of the squares: for outputs that end in a sqrt of a
    clamped difference (K4's altitude, K5's distance).  Where that
    difference is 0 up to rounding (a pivot row's altitude, a pivot against
    itself), the sqrt turns the two versions' ~1e-16 rounding into ~1e-8,
    so they are held to each other before the sqrt."""
    return max_err(torch, got * got, want * want, tol)


def check_k4(torch, got, want, tol):
    """K4: the head coordinates directly, the altitude squared."""
    return max(max_err(torch, got[:, :-1], want[:, :-1], tol), max_err_sq(torch, got[:, -1], want[:, -1], tol))


def host_select(keys: np.ndarray, live, width: int) -> np.ndarray:
    """Per query the ``width`` smallest (key, id) among live rows by
    ``np.lexsort``, sentinel-padded: the host reference of K2/K3."""
    out = np.full((keys.shape[0], width), SENTINEL, dtype=np.int64)
    for q in range(keys.shape[0]):
        ids = np.arange(keys.shape[1]) if live is None else np.flatnonzero(live[q])
        kq = keys[q, ids]
        if kq.shape[0] > width:
            keep = kq <= np.partition(kq, width - 1)[width - 1]
            ids, kq = ids[keep], kq[keep]
        order = np.lexsort((ids, kq))[:width]
        out[q, : order.shape[0]] = ids[order]
    return out


def check_selection(ids, lwb, upb, want, L, U):
    """Kernel selection == host selection, bounds == K1's at those ids."""
    ids, lwb, upb = (t.cpu().numpy() for t in (ids, lwb, upb))
    check(np.array_equal(ids.astype(np.int64), want), "selection ids differ from host lexsort")
    real = want != SENTINEL
    rows = np.nonzero(real)
    check(np.array_equal(lwb[real], L[rows[0], want[real]]), "selected lwb differs from K1")
    check(np.array_equal(upb[real], U[rows[0], want[real]]), "selected upb differs from K1")
    check(bool(np.all(np.isinf(lwb[~real]))), "empty slots must carry +inf")


def phase_kernels(torch, ops, ref, tab32, ap32):
    """Each kernel against its plain version at the main path's shapes."""
    dev = tab32.device
    N_, n_ = tab32.shape
    rng = np.random.default_rng(SEED)
    tab64, ap64 = tab32.double(), ap32.double()
    small = ap32[:16]
    mask_np = rng.random(N_) < 0.5
    mask = torch.as_tensor(mask_np, device=dev)

    # K1: the main call, a dims call, an f64 call
    L_t, U_t = ops.apex_bounds_batch(tab32, ap32)
    Lr, Ur = ref.apex_bounds_batch_ref(tab32, ap32, n_)
    err = max(max_err(torch, L_t, Lr, F32_TOL), max_err(torch, U_t, Ur, F32_TOL))
    del Lr, Ur
    for args, dims, tol in (((tab32, small), 7, F32_TOL), ((tab64, ap64[:16]), None, F64_TOL)):
        got = ops.apex_bounds_batch(*args, dims=dims)
        want = ref.apex_bounds_batch_ref(*args, dims or n_)
        err_i = max(max_err(torch, got[0], want[0], tol), max_err(torch, got[1], want[1], tol))
        emit(phase="kernels", kernel="K1", dims=dims, dtype=str(args[0].dtype), max_abs_err=err_i)
    emit(phase="kernels", kernel="K1", dims=None, dtype="torch.float32", max_abs_err=err)

    L, U = L_t.cpu().numpy(), U_t.cpu().numpy()
    del L_t, U_t

    # K2: the main call (key="upb", k=10), then key="mid" with dims and rowmask
    ids, lwb, upb = ops.apex_bounds_topk(tab32, ap32, K, key="upb")
    check_selection(ids, lwb, upb, host_select(U, None, K), L, U)
    Ls, Us = (t.cpu().numpy() for t in ops.apex_bounds_batch(tab32, small, dims=7))
    mid = np.float32(0.5) * (Ls + Us)
    ids, lwb, upb = ops.apex_bounds_topk(tab32, small, 100, key="mid", dims=7, rowmask=mask)
    check_selection(ids, lwb, upb, host_select(mid, np.broadcast_to(mask_np, mid.shape), 100), Ls, Us)
    emit(phase="kernels", kernel="K2", exact=True)

    # K3: thresholds at per-query ranks below, at and above the capacity
    ranks = np.array([100, 2000, CAP, 20000])[np.arange(Q) % 4]
    thr = np.array([np.partition(L[q], r - 1)[r - 1] for q, r in enumerate(ranks)], dtype=np.float32)
    thr_t = torch.as_tensor(thr, device=dev)
    ids, lwb, upb, counts = ops.apex_bounds_threshold(tab32, ap32, thr_t, CAP)
    hit = L <= thr[:, None]
    check(np.array_equal(counts.cpu().numpy(), hit.sum(axis=1)), "K3 counts differ from host count")
    check(bool((counts.cpu().numpy() > CAP).any()), "K3 check must include an overflowing query")
    check_selection(ids, lwb, upb, host_select(L, hit, CAP), L, U)
    thr_s = thr_t[:16]
    ids, lwb, upb, counts = ops.apex_bounds_threshold(tab32, small, thr_s, 512, dims=7, rowmask=mask)
    hit_s = (Ls <= thr[:16, None]) & mask_np[None, :]
    check(np.array_equal(counts.cpu().numpy(), hit_s.sum(axis=1)), "K3 masked counts differ")
    check_selection(ids, lwb, upb, host_select(Ls, hit_s, 512), Ls, Us)
    emit(phase="kernels", kernel="K3", exact=True, overflowing_queries=int((hit.sum(1) > CAP).sum()))
    del L, U, Ls, Us

    # K6: one query, f32 and f64
    errs = []
    for t_, q_, tol in ((tab32, ap32[0], F32_TOL), (tab64, ap64[0], F64_TOL)):
        got, want = ops.apex_bounds(t_, q_), ref.apex_bounds_ref(t_, q_)
        errs.append(max(max_err(torch, got[0], want[0], tol), max_err(torch, got[1], want[1], tol)))
    emit(phase="kernels", kernel="K6", max_abs_err_f32=errs[0], max_abs_err_f64=errs[1])


def phase_kernels_k4_k5(torch, ops, ref, inner, data, queries):
    """K4 and K5 against their plain versions at the table build's shapes
    (the index's own 1M x 20 pivot distances, its corpus and pivots) and at
    the query and refinement shapes."""
    proj = inner.projector
    dist = proj.pivot_distances(data)                            # (1M, 20) f64
    Linv, sq = proj._Linv_t, proj._sq_norms_t
    B, n = dist.shape
    sms = torch.cuda.get_device_properties(dist.device).multi_processor_count
    got = ops.apex_project(dist, Linv, sq)
    check(torch.equal(got, ops.apex_project(dist, Linv, sq, _plan="row")),
          "K4 at the build shape is not bit-equal to the first design (f64)")
    err = check_k4(torch, got, ref.apex_project_ref(dist, Linv, sq), F64_TOL)
    del got
    d32, L32, s32 = dist.float(), Linv.float(), sq.float()
    got = ops.apex_project(d32, L32, s32)
    check(torch.equal(got, ops.apex_project(d32, L32, s32, _plan="row")),
          "K4 at the build shape is not bit-equal to the first design (f32)")
    err32 = check_k4(torch, got, ref.apex_project_ref(d32, L32, s32), K4_F32_TOL)
    del got
    emit(phase="kernels", kernel="K4", shape=[B, n], plan=ops.apex_project_plan(B, n, sms),
         bit_equal_to_first_design=True, max_abs_err_f64=err, max_abs_err_f32=err32)
    del dist, d32

    # K4 and K5 at the query shapes, f64: a 64-query block and one query,
    # against the full projector and the approximate path's dims-prefix one
    qs64 = queries[:Q].double()
    for p in (proj, inner._prefix_projector(APPROX_DIMS)):
        qd = p.pivot_distances(qs64)
        piv = p.pivots_t.double()
        for rows in (Q, 1):
            blk = qd[:rows]
            got = ops.apex_project(blk, p._Linv_t, p._sq_norms_t)
            check(torch.equal(got, ops.apex_project(blk, p._Linv_t, p._sq_norms_t, _plan="row")),
                  "K4 at a query shape is not bit-equal to the first design")
            e4 = check_k4(torch, got, ref.apex_project_ref(blk, p._Linv_t, p._sq_norms_t), F64_TOL)
            a = qs64[:rows]
            e5 = max_err_sq(torch, ops.jsd_pairwise(a, piv),
                            ref.jsd_pairwise_ref(l1_normalise(torch, a), l1_normalise(torch, piv)), F64_TOL)
            emit(phase="kernels", kernel="K4+K5", shape=list(blk.shape), dtype="torch.float64",
                 max_abs_err_k4=e4, max_abs_err_k5=e5)

    # K5 at the build shape: every corpus row against the 20 pivots, f64;
    # a pivot against itself is exactly 0
    X = data.double()
    Y = proj.pivots_t.double()
    Qx, d = X.shape
    err = max_err_sq(torch, ops.jsd_pairwise(X, Y), ref.jsd_pairwise_ref(l1_normalise(torch, X),
                                                                          l1_normalise(torch, Y)), F64_TOL)
    check(bool((torch.diagonal(ops.jsd_pairwise(Y, Y)) == 0).all()), "K5 of a pivot against itself is not 0")
    emit(phase="kernels", kernel="K5", shape=[Qx, Y.shape[0], d], dtype="torch.float64", max_abs_err=err,
         pivot_self_distance_zero=True)
    del X

    # the refinement shapes (one query against 256 and 4096 rows, f64) and a
    # query block against 4096 rows in f32
    for qs, rows, tol, dtype in ((queries[:1], data[:256], F64_TOL, torch.float64),
                                 (queries[:1], data[:4096], F64_TOL, torch.float64),
                                 (queries[:Q], data[:4096], K5_F32_TOL, torch.float32)):
        a, b = qs.to(dtype), rows.to(dtype)
        e = max_err_sq(torch, ops.jsd_pairwise(a, b),
                       ref.jsd_pairwise_ref(l1_normalise(torch, a), l1_normalise(torch, b)), tol)
        emit(phase="kernels", kernel="K5", shape=[a.shape[0], b.shape[0], d], dtype=str(dtype), max_abs_err=e)


def l1_normalise(torch, X):
    """Rows over ``max(sum, 1e-12)``: the JSD wrappers' normalisation."""
    return X / torch.clamp_min(X.sum(dim=-1, keepdim=True), 1e-12)



#: each kernel's headline shape (its main batch call), kept as a row whenever the
#: main path launches it
HEADLINE = {
    "apex_bounds_batch": (Q, N_PIVOTS),
    "apex_topk": (Q, K, "upb", N_PIVOTS),
    "apex_threshold": (Q, CAP, N_PIVOTS),
    "apex_project": (N_ROWS, N_PIVOTS, "float64"),
    "jsd_pairwise": (N_ROWS, N_PIVOTS, DIM, "float64"),
    "apex_bounds": (N_PIVOTS, "float32"),
}
#: a shape class holding at least this share of its kernel's launches gets a row
ROW_SHARE = 0.10
#: kernels redesigned last, with the launch plan of their wrapper that still
#: runs the previous design (K1: the tile plan at every Q; K3: one query per
#: block, with the current merge), timed beside the new one in each row
PREVIOUS_DESIGN = {
    "apex_bounds_batch": ("tile plan", lambda ops, cls, N_, sms: "tile"),
    "apex_threshold": ("one query per block", lambda ops, cls, N_, sms: (0, ops._slices(sms, cls[0], N_))),
    "apex_project": ("one thread per row", lambda ops, cls, N_, sms: "row"),
}


def current_plan(ops, name, cls, N_, sms):
    """The launch plan the wrapper picks at ``cls`` (K1, K3, K4)."""
    if name == "apex_bounds_batch":
        return "stream"
    if name == "apex_threshold":
        kb = 16 if "float64" in cls else 8
        if cls[1] > ops.MAX_SELECT_WIDTH:
            return list(ops.wide_plan(cls[1], cls[0], N_, sms, key_bytes=kb)[:2])
        return list(ops.threshold_plan(cls[1], cls[0], N_, sms, key_bytes=kb))
    return ops.apex_project_plan(cls[0], cls[1], sms)
#: why K2-K5 have no one-call PyTorch counterpart (``library_ms`` null)
NO_LIBRARY = {
    "apex_topk": "no single PyTorch call scans bounds and keeps a per-query top-k by (key, id)",
    "apex_threshold": "no single PyTorch call filters by a per-query threshold, counts and keeps the cap smallest",
    "apex_project": "no single PyTorch call does the three steps (squares, triangular product, altitude)",
    "jsd_pairwise": "PyTorch has no pairwise Jensen-Shannon call",
}


def launch_histogram(shape_launches) -> dict:
    """Per kernel: [(shape class, launches, share)] by launches, largest first."""
    out = {}
    for name, by in shape_launches.items():
        total = sum(by.values())
        out[name] = [(cls, n, n / total) for cls, n in sorted(by.items(), key=lambda kv: (-kv[1], str(kv[0])))]
    return out


def rows_to_time(hist, must=()) -> list:
    """(kernel, shape class) pairs with a row: every class with >= ROW_SHARE
    of its kernel's launches, its headline shape where the main path
    launched it, and each (kernel, class) of ``must`` that was launched."""
    rows = []
    for name in KERNEL_INFO:
        classes = [cls for cls, _, share in hist.get(name, []) if share >= ROW_SHARE]
        launched = {cls for cls, _, _ in hist.get(name, [])}
        for cls in [HEADLINE[name]] + [c for n, c in must if n == name]:
            if cls in launched and cls not in classes:
                classes.append(cls)
        rows.extend((name, cls) for cls in classes)
    return rows


def truncated(torch, ref, a, dims):
    """Apex rows folded to ``dims`` coordinates (the prefix's own width)."""
    if dims == a.shape[1]:
        return a.contiguous()
    head, alt = ref.split_trunc(a, dims)
    return torch.cat([head, alt[:, None]], dim=1).contiguous()


class ShapeInputs:
    """Operands of each kernel at a launch shape class, made from one index's
    own state (table, corpus, projectors) and the query rows; ``corpus``
    (default: the index's) supplies raw rows where a class needs more rows
    than the index holds (the mechanisms phase's 1M-row LAESA table build
    beside its 112,682-row engine); ``mask`` (a uint8 row mask over the
    table, on the card) is the row mask of K2's and K3's masked classes."""

    def __init__(self, torch, ops, ref, index, queries_np, log, corpus=None, mask=None):
        self.torch, self.ops, self.ref, self.log = torch, ops, ref, log
        self.mask = mask
        inner = index._inner
        self.inner = inner
        self.tab = inner._kernel_table()
        self.data = inner.data if corpus is None else corpus
        self.queries = torch.as_tensor(queries_np, device=self.tab.device)
        self.ap64 = inner.query_apex_batch(queries_np).contiguous()
        self.ap = self.ap64.float().contiguous()
        self.sms = torch.cuda.get_device_properties(self.tab.device).multi_processor_count
        self._floor = None

    def select_operands(self, cls, width):
        """(table, class without its dtype tag, itemsize) of a K2/K3 class:
        a class tagged ``"float64"`` runs on the index's own f64 apex table
        (``inner.table``), the others on its f32 kernel table."""
        if cls[-1] == "float64":
            return self.inner.table.contiguous(), tuple(cls[:-1]), 8
        return self.tab, tuple(cls), 4

    def launch_floor_ms(self):
        """CUDA-event ms per launch of the library's empty kernel, called
        back to back through ctypes with the current stream fetched per call
        as the wrappers do: the floor under any small K4 call."""
        if self._floor is None:
            from repro_torch.kernels.build import library

            fn, ops, dev = library().repro_launch_floor, self.ops, self.tab.device
            check(fn(ops._stream(dev)) == 0, "the empty kernel did not launch")
            self._floor = time_ms(self.torch, lambda: fn(ops._stream(dev)), reps=2000)
        return self._floor

    def rows(self, count):
        """``count`` raw corpus-shaped rows: the queries, or corpus rows."""
        check(count <= self.data.shape[0], f"a class of {count} rows needs a larger corpus")
        return self.queries[:count] if count <= self.queries.shape[0] else self.data[:count]

    def apexes(self, Q_, dims, itemsize=4):
        """``Q_`` query apexes folded to ``dims`` (f64 for ``itemsize`` 8);
        above the query rows they repeat (the same work per query)."""
        base = self.ap64 if itemsize == 8 else self.ap
        ap = base.repeat(-(-Q_ // base.shape[0]), 1)
        return truncated(self.torch, self.ref, ap[:Q_], dims)

    def selection_want(self, L, U, keys, live, width):
        """The plain selection over K1's own matrices, in their dtype (packed
        keys in f32, the stable sort in f64)."""
        return self.ref._select(keys, live, L, U, width)

    def time_row(self, name, cls, plan=None) -> dict:
        """The wrapper at ``cls`` as the main path calls it (under launch
        ``plan`` where given, for K1 and K3): max error against the plain
        version (exact for K2/K3: a selection over K1's own f32 matrices),
        CUDA-event times of wrapper and plain version, the bound and, for
        K1/K6, the one-call library yardstick."""
        torch, ops, ref = self.torch, self.ops, self.ref
        kw = {} if plan is None else {"_plan": tuple(plan) if isinstance(plan, list) else plan}
        tab = self.tab
        N_, n_ = tab.shape
        lib_ms = None
        check(plan is None or name in ("apex_bounds_batch", "apex_threshold", "apex_project"),
              f"{name} takes no launch plan")
        extra = {}
        if name == "apex_bounds":
            q = self.ap[0]
            got, want = ops.apex_bounds(tab, q), ref.apex_bounds_ref(tab, q)
            err = max(max_err(torch, got[0], want[0], F32_TOL), max_err(torch, got[1], want[1], F32_TOL))
            run, plain = (lambda: ops.apex_bounds(tab, q)), (lambda: ref.apex_bounds_ref(tab, q))
            lib_ms = self.cdist_ms(q[None, :], n_)
            b = bound(1, N_, n_, 4, 2 * N_ * 4, F32_FLOPS)
        elif name == "apex_bounds_batch":
            Q_, dims = cls
            q = self.apexes(Q_, dims)
            got, want = ops.apex_bounds_batch(tab, q, dims=dims, **kw), ref.apex_bounds_batch_ref(tab, q, dims)
            err = max(max_err(torch, got[0], want[0], F32_TOL), max_err(torch, got[1], want[1], F32_TOL))
            del got, want
            run = lambda: ops.apex_bounds_batch(tab, q, dims=dims, **kw)  # noqa: E731
            plain = lambda: ref.apex_bounds_batch_ref(tab, q, dims)  # noqa: E731
            lib_ms = self.cdist_ms(q, dims)
            b = roofline(N_ * n_ * 4 + q.numel() * 4 + 2 * Q_ * N_ * 4, Q_ * N_ * (2 * (dims - 1) + 12), F32_FLOPS)
        elif name == "apex_topk":
            tab, core, size = self.select_operands(cls, 4)
            Q_, k, key, dims = core[:4]
            mask, allowed = self.class_mask(core, 4)
            q = self.apexes(Q_, dims, size)
            L, U = ops.apex_bounds_batch(tab, q, dims=dims)
            keys = {"lwb": L, "upb": U}.get(key)
            keys = 0.5 * (L + U) if keys is None else keys
            want = self.selection_want(L, U, keys, allowed[None, :].expand_as(L), k)
            got = ops.apex_bounds_topk(tab, q, k, key=key, dims=dims, rowmask=mask)
            check(all(torch.equal(g, w) for g, w in zip(got, want)), f"K2 at {cls} differs from the selection over K1")
            del L, U, keys, want, got
            err = 0.0
            run = lambda: ops.apex_bounds_topk(tab, q, k, key=key, dims=dims, rowmask=mask)  # noqa: E731
            plain = lambda: ref.apex_topk_ref(tab, q, k, key, dims, mask)  # noqa: E731
            b = select_bound(Q_, int(allowed.sum()), n_, dims, q.numel(), Q_ * k * (4 + 2 * size), Q_ * k,
                             squares=2 if key == "mid" else 1, mask_bytes=0 if mask is None else N_, itemsize=size)
        elif name == "apex_threshold":
            tab, core, size = self.select_operands(cls, 3)
            Q_, cap, dims = core[:3]
            mask, allowed = self.class_mask(core, 3)
            q = self.apexes(Q_, dims, size)
            L, U = ops.apex_bounds_batch(tab, q, dims=dims)
            # each query's threshold at rank cap / 2 among the allowed rows
            # (the selection fills half), and k-NN pass B's: the K-th
            # smallest allowed upb, which at 1M rows overflows the cap for
            # every query (+inf where fewer rows are allowed)
            inf = float("inf")
            thr = torch.kthvalue(L.masked_fill(~allowed, inf), min(max(1, cap // 2), N_), dim=1).values.contiguous()
            thr_b = torch.kthvalue(U.masked_fill(~allowed, inf), min(K, N_), dim=1).values.contiguous()
            for t_ in (thr_b, thr):
                hit = allowed[None, :] & (L <= t_[:, None])
                ids, lwb, upb, counts = ops.apex_bounds_threshold(tab, q, t_, cap, dims=dims, rowmask=mask, **kw)
                want = self.selection_want(L, U, L, hit, cap)
                check(torch.equal(counts, hit.sum(dim=1).to(torch.int32)), f"K3 counts at {cls} differ")
                check(all(torch.equal(g, w) for g, w in zip((ids, lwb, upb), want)),
                      f"K3 at {cls} differs from the selection over K1")
                if t_ is thr_b:
                    extra["pass_b_mean_count"] = float(counts.double().mean())
            kept = int(counts.clamp(max=cap).sum())
            n_allowed = int(allowed.sum())
            del L, U, hit, want
            err = 0.0
            run = lambda: ops.apex_bounds_threshold(tab, q, thr, cap, dims=dims, rowmask=mask, **kw)  # noqa: E731
            run_b = lambda: ops.apex_bounds_threshold(tab, q, thr_b, cap, dims=dims, rowmask=mask, **kw)  # noqa: E731
            extra.update(pass_b_ms=time_ms(torch, run_b), pass_b_device_ms=device_ms(torch, run_b))
            plain = lambda: ref.apex_threshold_ref(tab, q, thr, cap, dims, mask)  # noqa: E731
            b = select_bound(Q_, n_allowed, n_, dims, q.numel(), Q_ * (cap * (4 + 2 * size) + 4), kept,
                             mask_bytes=0 if mask is None else N_, itemsize=size)
        elif name == "apex_project":
            B, n, dtype = cls
            p = self.inner.projector if n == self.inner.n_pivots else self.inner._prefix_projector(n)
            dt = getattr(torch, dtype)
            dist = p.pivot_distances(self.rows(B)).to(dt).contiguous()
            Linv, sq = p._Linv_t.to(dt), p._sq_norms_t.to(dt)
            tol = F64_TOL if dt == torch.float64 else K4_F32_TOL
            got = ops.apex_project(dist, Linv, sq, **kw)
            check(torch.equal(got, ops.apex_project(dist, Linv, sq, _plan="row")),
                  f"K4 at {cls} is not bit-equal to the first design")
            err = check_k4(torch, got, ref.apex_project_ref(dist, Linv, sq), tol)
            del got
            run = lambda: ops.apex_project(dist, Linv, sq, **kw)  # noqa: E731
            plain = lambda: ref.apex_project_ref(dist, Linv, sq)  # noqa: E731
            h = n - 1
            size = dist.element_size()
            b = roofline(2 * B * n * size + (h * h + h) * size, B * (2 * h * h + 4 * h + 4),
                         F64_FLOPS if dt == torch.float64 else F32_FLOPS)
            if (plan or ops.apex_project_plan(B, n, self.sms)) != "stream":
                extra["launch_floor_ms"] = self.launch_floor_ms()
        elif name == "jsd_pairwise":
            Q_, P, d, dtype = cls
            dt = getattr(torch, dtype)
            X = self.rows(Q_).to(dt).contiguous()
            Y = (self.inner.projector.pivots_t if P == self.inner.n_pivots and Q_ > self.queries.shape[0]
                 else self.data[1000:1000 + P]).to(dt).contiguous()
            Xn, Yn = l1_normalise(torch, X), l1_normalise(torch, Y)
            tol = F64_TOL if dt == torch.float64 else K5_F32_TOL
            err = max_err_sq(torch, ops.jsd_pairwise(X, Y), ref.jsd_pairwise_ref(Xn, Yn), tol)
            run, plain = (lambda: ops.jsd_pairwise(X, Y)), (lambda: ref.jsd_pairwise_ref(Xn, Yn))
            # per (pair, coordinate): x + y, * 0.5, * log, + acc and one log;
            # per (row, coordinate): the L1 sum and division, one log, * and +
            lf = self.log["fast_path_flops"]
            ops_ = Q_ * P * d * (4 + lf) + (Q_ + P) * d * (4 + lf)
            size = X.element_size()
            b = roofline((Q_ + P) * d * size + Q_ * P * size, ops_, F64_FLOPS if dt == torch.float64 else F32_FLOPS)
        else:
            raise KeyError(name)
        big = b[0] > 1.0
        ms = time_ms(torch, run, reps=10 if big else 50)
        plain_ms = time_ms(torch, plain, reps=2 if big else 10)
        row = dict(shape=list(cls), max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b, library_ms=lib_ms,
                   device_ms=device_ms(torch, run), **extra)
        if plan is not None:
            row["plan"] = plan
        return row

    def class_mask(self, cls, width):
        """(uint8 row mask or None, (N,) bool allowed rows) of a K2/K3 class:
        a class longer than ``width`` is a masked one."""
        N_ = self.tab.shape[0]
        if len(cls) == width:
            return None, self.torch.ones(N_, dtype=self.torch.bool, device=self.tab.device)
        check(cls[width] == "masked" and self.mask is not None and self.mask.shape[0] == N_,
              f"a masked class {cls} needs the phase's row mask over the {N_}-row table")
        return self.mask, self.mask.bool()

    def cdist_ms(self, q, dims):
        """K1/K6's one-call yardstick: ``torch.cdist(q, S)`` with S the
        table truncated to ``dims`` stacked over its copy with the altitude
        negated, so the first N columns are lwb and the last N upb.  S is
        built outside the timing; the port never calls it."""
        torch = self.torch
        T = truncated(torch, self.ref, self.tab, dims)
        S = torch.cat([T, torch.cat([T[:, :-1], -T[:, -1:]], dim=1)]).contiguous()
        q = q.contiguous()
        lwb, upb = self.ops.apex_bounds_batch(self.tab, q, dims=dims)
        got = torch.cdist(q, S)
        N_ = T.shape[0]
        emit(phase="kernels", library="torch.cdist", shape=[q.shape[0], N_, dims],
             max_abs_diff_to_kernel=float(max((got[:, :N_] - lwb).abs().max(), (got[:, N_:] - upb).abs().max())))
        del lwb, upb, got
        ms = time_ms(self.torch, lambda: torch.cdist(q, S), reps=20)
        del S, T
        return ms


def time_shapes(torch, ops, ref, inputs, pairs, **tag) -> list:
    """One timed row per (kernel, shape class) or (kernel, shape class,
    launch plan)."""
    out = []
    for name, cls, *plan in pairs:
        m = inputs.time_row(name, tuple(cls), *plan)
        emit(phase="kernel_shape", kernel=KERNEL_INFO[name][0], name=name, **tag, **m)
        out.append((name, m))
        torch.cuda.empty_cache()
    return out


class BruteForce:
    """Float64 scan of the whole corpus on the card: the e2e reference.  JSD
    is the plain version (``ref.jsd_pairwise_ref``), never the kernel K5 the
    index refines with."""

    def __init__(self, torch, ref, data, metric):
        self.torch, self.ref, self.metric = torch, ref, metric
        self.data64 = data.double()
        if metric.name == "jensen_shannon":
            self.data64 = l1_normalise(torch, self.data64)

    def dists(self, q):
        q = self.torch.as_tensor(q, device=self.data64.device).double()
        if self.metric.name == "jensen_shannon":
            return self.ref.jsd_pairwise_ref(l1_normalise(self.torch, q[None, :]), self.data64)[0]
        return self.metric.one_to_many(q, self.data64)

    def cross(self, qs, rows):
        """(Q, M) float64 distances of query rows to ``rows``, JSD plain."""
        qs = self.torch.as_tensor(qs, device=self.data64.device).double()
        if self.metric.name == "jensen_shannon":
            return self.ref.jsd_pairwise_ref(l1_normalise(self.torch, qs), l1_normalise(self.torch, rows.double()))
        return self.metric.cross(qs, rows)

    def knn(self, q, k):
        d = self.dists(q)
        order = self.torch.sort(d, stable=True).indices[:k]     # ties by ascending id
        return order.cpu().numpy(), d.cpu().numpy()

    def range(self, q, t):
        d = self.dists(q)
        return self.torch.nonzero(d <= t).flatten().cpu().numpy(), d.cpu().numpy()


def refine_tol(torch, metric_name, data):
    """f32 corpus + Euclidean refines in f32: compare at f32 resolution."""
    return 1e-5 if (metric_name == "euclidean" and data.dtype == torch.float32) else F64_TOL


def agree_knn(res, want_ids, d64, tol):
    """Ids and tie order equal to brute force; with a float32 refine
    (Euclidean on a float32 corpus) ids may swap only between rows whose
    f64 distances agree within ``tol``.  Returns the number of such swaps."""
    got = res.ids
    check(len(got) == len(want_ids), "k-NN result has the wrong length")
    check(bool(np.allclose(res.distances, d64[got], rtol=tol, atol=tol)), "k-NN distances differ")
    swaps = int((got != want_ids).sum())
    check(bool(np.allclose(d64[got], d64[want_ids], rtol=tol, atol=tol)), "k-NN ids differ from brute force")
    return swaps


def agree_range(res, want_ids, d64, t, tol):
    diff = np.setxor1d(res.ids, want_ids)
    check(bool(np.all(np.abs(d64[diff] - t) <= tol * max(t, 1.0))), "range ids differ from brute force")
    return int(diff.shape[0])


def phase_e2e(torch, api, metrics_mod, service_mod, ref, data_np, queries_np, metric_name, index=None):
    """The main path for one metric, through the public entry points."""
    report = lambda **f: emit(phase="e2e", metric=metric_name, **f)  # noqa: E731
    if index is None:
        t0 = time.perf_counter()
        index = api.build_index(data_np, metric_name, n_pivots=N_PIVOTS, seed=SEED % 1000, device="cuda")
        torch.cuda.synchronize()
        report(task="build", rows=N_ROWS, wall_s=time.perf_counter() - t0)
    inner = index._inner
    data = inner.data
    brute = BruteForce(torch, ref, data, metrics_mod.get_metric(metric_name))
    tol = refine_tol(torch, metric_name, data)
    swaps = 0

    def run(task, spec, qs):
        before = inner.overflow_queries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = index.query(qs, spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results = [res] if qs.ndim == 1 else list(res)
        report(task=task, queries=len(results), wall_ms=wall * 1e3,
               original_calls_per_query=float(np.mean([r.stats.original_calls for r in results])),
               overflow_queries=inner.overflow_queries - before)
        return results

    api_q = api.Query
    for b in range(2):
        qs = queries_np[b * Q:(b + 1) * Q]
        results = run("knn_batch", api_q.knn(K), qs)
        for q, r in zip(qs[:8], results[:8]):
            ids, d64 = brute.knn(q, K)
            swaps += agree_knn(r, ids, d64, tol)
    sample = brute.dists(queries_np[0]).cpu().numpy()
    t_range = float(np.sort(sample)[99])                         # ~100th-neighbour distance
    t_over = float(np.sort(sample)[3 * CAP])                      # overflows K3's capacity
    for b in range(2):
        qs = queries_np[b * Q:(b + 1) * Q]
        results = run("range_batch", api_q.range(t_range), qs)
        for q, r in zip(qs[:8], results[:8]):
            ids, d64 = brute.range(q, t_range)
            swaps += agree_range(r, ids, d64, t_range, tol)
    qs = queries_np[:8]
    results = run("range_overflow_batch", api_q.range(t_over), qs)
    check(inner.overflow_queries > 0, "the overflow batch must take the per-query K1 route")
    for q, r in zip(qs, results):
        ids, d64 = brute.range(q, t_over)
        swaps += agree_range(r, ids, d64, t_over, tol)
    for q in queries_np[:8]:
        r = run("knn_1d", api_q.knn(K), q)[0]
        ids, d64 = brute.knn(q, K)
        swaps += agree_knn(r, ids, d64, tol)
        r = run("range_1d", api_q.range(t_range), q)[0]
        ids, d64 = brute.range(q, t_range)
        swaps += agree_range(r, ids, d64, t_range, tol)

    served = queries_np[:256]
    spec = api_q.knn(K)
    with service_mod.SearchService(index, max_batch=64, max_wait_s=0.005) as svc:
        svc.warmup(spec, served[0])
        t0 = time.perf_counter()
        futures = [svc.submit(q, spec) for q in served]
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        st = svc.stats()
    direct = index.query(served, spec)
    for r, w in zip(results, direct):
        check(np.array_equal(r.ids, w.ids) and np.array_equal(r.distances, w.distances),
              "served results differ from a direct batch")
    for q, r in zip(served[:8], results[:8]):
        ids, d64 = brute.knn(q, K)
        swaps += agree_knn(r, ids, d64, tol)
    report(task="service_knn", requests=len(served), wall_ms=wall * 1e3,
           latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
           mean_batch_occupancy=st["mean_batch_occupancy"], n_batches=st["n_batches"],
           original_calls_per_query=float(np.mean([r.stats.original_calls for r in results])),
           near_tie_differences=swaps)
    return index


def phase_approx(torch, api, metrics_mod, service_mod, ref, data_np, queries_np, metric_name, index=None):
    """Drive the approximate path for one metric: on ``index`` with explicit
    ``mode="approx"`` queries, or on a fresh ``apex_dims`` build queried in
    ``auto`` mode.  Returns what ``verify_approx`` checks once the launch
    counts are read (its checks launch K1, K4 and K5 themselves)."""
    report = lambda **f: emit(phase="approx", metric=metric_name, **f)  # noqa: E731
    api_q = api.Query
    if index is None:
        t0 = time.perf_counter()
        index = api.build_index(data_np, metric_name, n_pivots=N_PIVOTS, seed=SEED % 1000,
                                apex_dims=APPROX_DIMS, refine=REFINE, device="cuda")
        torch.cuda.synchronize()
        report(task="build", rows=N_ROWS, apex_dims=APPROX_DIMS, refine=REFINE, wall_s=time.perf_counter() - t0)
        kw = {}
    else:
        kw = dict(mode="approx", dims=APPROX_DIMS, refine=REFINE)
    inner = index._inner
    brute = BruteForce(torch, ref, inner.data, metrics_mod.get_metric(metric_name))
    t_range = float(np.sort(brute.dists(queries_np[0]).cpu().numpy())[99])   # ~100th-neighbour distance
    knn_spec, range_spec = api_q.knn(K, **kw), api_q.range(t_range, **kw)
    for spec in (knn_spec, range_spec):
        check(index.plan(spec).approx_cfg == {"dims": APPROX_DIMS, "refine": REFINE},
              "the plan must resolve to the approximate path")
    tasks = []

    def run(task, spec, qs):
        before = inner.overflow_queries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = index.query(qs, spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results = [res] if qs.ndim == 1 else list(res)
        report(task=task, queries=len(results), wall_ms=wall * 1e3,
               original_calls_per_query=float(np.mean([r.stats.original_calls for r in results])),
               overflow_queries=inner.overflow_queries - before)
        return results

    for task, spec in (("knn_batch", knn_spec), ("range_batch", range_spec)):
        for b in range(2):
            qs = queries_np[b * Q:(b + 1) * Q]
            tasks.append((task, spec, qs, run(task, spec, qs)))
    qs = queries_np[:8]
    tasks.append(("knn_1d", knn_spec, qs, [run("knn_1d", knn_spec, q)[0] for q in qs]))

    served = queries_np[:256]
    with service_mod.SearchService(index, max_batch=64, max_wait_s=0.005) as svc:
        svc.warmup(knn_spec, served[0])
        t0 = time.perf_counter()
        futures = [svc.submit(q, knn_spec) for q in served]
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        st = svc.stats()
    direct = index.query(served, knn_spec)
    for r, w in zip(results, direct):
        check(np.array_equal(r.ids, w.ids) and np.array_equal(r.distances, w.distances),
              "served approximate results differ from a direct batch")
    tasks.append(("service_knn", knn_spec, served, results))
    report(task="service_knn", requests=len(served), wall_ms=wall * 1e3,
           latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
           mean_batch_occupancy=st["mean_batch_occupancy"], n_batches=st["n_batches"],
           original_calls_per_query=float(np.mean([r.stats.original_calls for r in results])))
    return dict(metric=metric_name, index=index, brute=brute, tasks=tasks)


def verify_approx(torch, ops, ref, rec):
    """Check >= 8 queries per approximate task.  The query apexes are
    projected by the plain versions (pivot distances of the brute force,
    ``ref.apex_project_ref``), not by K4 or K5.  k-NN: the answer is the k
    smallest (f64 distance, id) among the ``REFINE`` rows a host lexsort of
    K1's own f32 truncated mid keys selects, and ``original_calls`` is
    ``dims + refine``.  Range: both bound sides stay sound against K1's f32
    truncated bounds, with the batch's own slack.  Prints recall@10 and range
    precision/recall against the brute force (not gated on the card)."""
    index, brute, metric = rec["index"], rec["brute"], rec["metric"]
    inner = index._inner
    tab = inner._kernel_table()
    prefix = inner._prefix_projector(APPROX_DIMS)
    tol = refine_tol(torch, metric, inner.data)
    cfg = {"dims": APPROX_DIMS, "refine": REFINE}
    for task, spec, qs, results in rec["tasks"]:
        qpd = brute.cross(np.atleast_2d(qs), prefix.pivots_t)
        apexes = ref.apex_project_ref(qpd, prefix._Linv_t, prefix._sq_norms_t)
        L, U = (t.cpu().numpy() for t in ops.apex_bounds_batch(tab, apexes[:8].float(), dims=APPROX_DIMS))
        scores, swaps = [], 0
        for qi, (q, r) in enumerate(zip(qs[:8], results[:8])):
            check(r.approx == cfg, "an approximate result must carry its config")
            d64 = brute.dists(q).cpu().numpy()
            if spec.task == "knn":
                cand = host_select(np.float32(0.5) * (L[qi:qi + 1] + U[qi:qi + 1]), None, REFINE)[0]
                check(bool(np.isin(r.ids, cand).all()), "approximate k-NN answered outside K2's candidates")
                swaps += agree_knn(r, cand[np.lexsort((cand, d64[cand]))][:K], d64, tol)
                check(r.stats.original_calls == APPROX_DIMS + REFINE, "original_calls must be dims + refine")
                exact = host_select(d64[None, :], None, K)[0]
                scores.append(len(np.intersect1d(r.ids, exact)) / K)
            else:
                t = float(spec.threshold)
                slack = float(inner._kernel_slack(apexes.cpu().numpy(), np.full(len(qs), t))[0])
                t_hi = t * (1.0 + inner.eps) + 1e-12 + slack
                t_lo = t * (1.0 - inner.eps) - 1e-12 - slack
                lwb, upb = L[qi].astype(np.float64), U[qi].astype(np.float64)
                check(bool(np.all(lwb[r.ids] <= t_hi)), "approximate range returned a row its lower bound excludes")
                check(bool(np.isin(np.flatnonzero(upb <= t_lo), r.ids).all()),
                      "approximate range dropped a row its upper bound admits")
                truth = np.flatnonzero(d64 <= t)
                hit = len(np.intersect1d(r.ids, truth))
                scores.append((hit / max(len(r.ids), 1), hit / max(len(truth), 1)))
        if spec.task == "knn":
            emit(phase="approx", metric=metric, task=task, checked=len(scores), recall_at_10=float(np.mean(scores)),
                 near_tie_differences=swaps)
        else:
            emit(phase="approx", metric=metric, task=task, checked=len(scores),
                 range_precision=float(np.mean([p for p, _ in scores])),
                 range_recall=float(np.mean([r_ for _, r_ in scores])))


def host_laesa_bounds(table: np.ndarray, qd: np.ndarray, dims=None):
    """The JAX package's numpy LAESA scan (``repro/index/laesa.py``,
    ``bounds_batch``) restated: a running max of ``|qd_j - T[:, j]|`` and a
    running min of ``qd_j + T[:, j]`` over the first ``dims`` columns."""
    n = table.shape[1] if dims is None else dims
    T = np.ascontiguousarray(table[:, :n].T)
    lwb = np.abs(qd[:, :1] - T[0][None, :])
    upb = qd[:, :1] + T[0][None, :]
    for j in range(1, n):
        np.maximum(lwb, np.abs(qd[:, j:j + 1] - T[j][None, :]), out=lwb)
        np.minimum(upb, qd[:, j:j + 1] + T[j][None, :], out=upb)
    return lwb, upb


def timed(torch, fn):
    """(result, wall seconds) of ``fn`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_laesa(torch, api, metrics_mod, ref, data_np, queries_np, metric_name):
    """LAESA at colors-1M through ``build_index(kind="laesa")``: one 64-query
    batch per task, exact and approximate.  Returns what ``verify_laesa``
    checks once the launch counts are read."""
    report = lambda **f: emit(phase="mechanisms", part="laesa", metric=metric_name, **f)  # noqa: E731
    index, wall = timed(torch, lambda: api.build_index(data_np, metric_name, kind="laesa", n_pivots=N_PIVOTS,
                                                       seed=SEED % 1000, device="cuda"))
    report(task="build", rows=N_ROWS, wall_s=wall)
    brute = BruteForce(torch, ref, index.data, metrics_mod.get_metric(metric_name))
    t_range = float(np.sort(brute.dists(queries_np[0]).cpu().numpy())[99])   # ~100th-neighbour distance
    approx = dict(mode="approx", dims=APPROX_DIMS, refine=REFINE)
    qs = queries_np[:Q]
    tasks = []
    for task, spec in (("knn_batch", api.Query.knn(K)), ("range_batch", api.Query.range(t_range)),
                       ("approx_knn_batch", api.Query.knn(K, **approx)),
                       ("approx_range_batch", api.Query.range(t_range, **approx))):
        res, wall = timed(torch, lambda: list(index.query(qs, spec)))
        report(task=task, queries=len(res), wall_ms=wall * 1e3,
               original_calls_per_query=float(np.mean([r.stats.original_calls for r in res])),
               candidates_per_query=float(np.mean([r.stats.candidates for r in res])))
        tasks.append((task, spec, res))
    # 1-D requests: the one-query exact k-NN, its selection on the card
    spec = api.Query.knn(K)
    res, wall = timed(torch, lambda: [index.query(q, spec) for q in qs[:8]])
    report(task="knn_1d", queries=len(res), wall_ms_per_query=wall * 1e3 / len(res),
           original_calls_per_query=float(np.mean([r.stats.original_calls for r in res])),
           candidates_per_query=float(np.mean([r.stats.candidates for r in res])))
    tasks.append(("knn_1d", spec, res))
    return dict(metric=metric_name, index=index, brute=brute, qs=qs, tasks=tasks)


def verify_laesa(torch, rec):
    """The card's ``bounds_batch`` bit-equal to ``host_laesa_bounds`` for 8
    queries (full and truncated to ``APPROX_DIMS``); exact answers equal to
    the brute force; approximate k-NN answers are the k smallest (f64
    distance, id) among the ``REFINE`` rows of smallest host mean estimate
    (ties by id) with ``original_calls == dims + refine``; approximate range
    answers keep both sound sides of the host bounds.  The host bounds use
    the pivot distances the index measured for the same 64-query block."""
    index, brute, metric, qs = rec["index"], rec["brute"], rec["metric"], rec["qs"]
    inner = index._inner
    table = inner.table.cpu().numpy()
    tol = refine_tol(torch, metric, inner.data)
    qd = inner.query_distances_batch(qs[:8])
    for dims in (None, APPROX_DIMS):
        got = [t.cpu().numpy() for t in inner.bounds_batch(qd, dims=dims)]
        want = host_laesa_bounds(table, qd.cpu().numpy(), dims)
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"LAESA bounds on the card differ from the host scan (dims={dims})")
    qd_approx = inner.query_distances_batch(qs, dims=APPROX_DIMS)[:8].cpu().numpy()
    L, U = host_laesa_bounds(table, qd_approx, APPROX_DIMS)
    swaps, scores = 0, {"knn": [], "range": []}
    for task, spec, results in rec["tasks"]:
        for qi, (q, r) in enumerate(zip(qs[:8], results[:8])):
            d64 = brute.dists(q).cpu().numpy()
            if spec.mode != "approx":
                if spec.task == "knn":
                    ids, _ = brute.knn(q, K)
                    swaps += agree_knn(r, ids, d64, tol)
                else:
                    ids, _ = brute.range(q, float(spec.threshold))
                    swaps += agree_range(r, ids, d64, float(spec.threshold), tol)
            elif spec.task == "knn":
                est = 0.5 * (L[qi] + U[qi])
                cand = np.lexsort((np.arange(est.shape[0]), est))[:REFINE]
                check(bool(np.isin(r.ids, cand).all()), "approximate LAESA k-NN answered outside its candidates")
                swaps += agree_knn(r, cand[np.lexsort((cand, d64[cand]))][:K], d64, tol)
                check(r.stats.original_calls == APPROX_DIMS + REFINE, "original_calls must be dims + refine")
                scores["knn"].append(len(np.intersect1d(r.ids, host_select(d64[None, :], None, K)[0])) / K)
            else:
                t = float(spec.threshold)
                check(bool(np.all(L[qi][r.ids] <= t)),
                      "approximate LAESA range returned a row its lower bound excludes")
                check(bool(np.isin(np.flatnonzero(U[qi] <= t), r.ids).all()),
                      "approximate LAESA range dropped a row its upper bound admits")
                truth = np.flatnonzero(d64 <= t)
                hit = len(np.intersect1d(r.ids, truth))
                scores["range"].append((hit / max(len(r.ids), 1), hit / max(len(truth), 1)))
    emit(phase="mechanisms", part="laesa", metric=metric, checked_per_task=8, bounds_bit_equal=True,
         near_tie_differences=swaps, approx_recall_at_10=float(np.mean(scores["knn"])),
         approx_range_precision=float(np.mean([p for p, _ in scores["range"]])),
         approx_range_recall=float(np.mean([r_ for _, r_ in scores["range"]])))


def phase_engine(torch, search_mod, metrics_mod, ref, data_np, queries_np, metric_name):
    """``ExactSearchEngine`` over the paper's colors size with all five
    mechanisms: per mechanism an ``ENGINE_Q``-query range batch at the 1e-3 selectivity
    of ``benchmarks/bench_batch_search.py`` (query 0's distance quantile),
    a k-NN batch of as many and ``ENGINE_1D`` 1-D requests of each, every
    answer held to the brute force.  Prints the paper's Table 3 per mechanism: calls per
    query, wall ms per query and the build seconds."""
    data, qs = data_np[:ENGINE_ROWS], queries_np[:ENGINE_Q]
    eng, wall = timed(torch, lambda: search_mod.ExactSearchEngine(data, metric_name, n_pivots=N_PIVOTS,
                                                                  seed=SEED % 1000, device="cuda"))
    emit(phase="mechanisms", part="engine", metric=metric_name, task="build", rows=ENGINE_ROWS, wall_s=wall,
         build_s=eng.build_s, tree_build_calls={m: t.build_calls for m, t in eng.trees.items()})
    brute = BruteForce(torch, ref, eng.data, metrics_mod.get_metric(metric_name))
    d0 = np.sort(brute.dists(qs[0]).cpu().numpy())
    t = float(d0[int(ENGINE_SELECTIVITY * ENGINE_ROWS)])
    tol = refine_tol(torch, metric_name, eng.data)
    swaps = 0
    for mech in search_mod.MECHANISMS:
        row = {}
        for task in ("range", "knn"):
            if task == "range":
                reps, wall = timed(torch, lambda: eng.search_batch(mech, qs, t))
                singles, wall_1d = timed(torch, lambda: [eng.search(mech, q, t) for q in qs[:ENGINE_1D]])
            else:
                reps, wall = timed(torch, lambda: eng.knn_batch(mech, qs, K))
                singles, wall_1d = timed(torch, lambda: [eng.knn(mech, q, K) for q in qs[:ENGINE_1D]])
            for q, rep in zip(list(qs) + list(qs[:ENGINE_1D]), reps + singles):
                got = SimpleNamespace(ids=rep.results, distances=rep.distances)
                if task == "range":
                    ids, d64 = brute.range(q, t)
                    swaps += agree_range(got, ids, d64, t, tol)
                else:
                    ids, d64 = brute.knn(q, K)
                    swaps += agree_knn(got, ids, d64, tol)
            row[task] = dict(
                wall_ms_per_query=wall * 1e3 / len(reps),
                wall_ms_per_1d_request=wall_1d * 1e3 / len(singles),
                original_calls_per_query=float(np.mean([r.original_calls for r in reps])),
                surrogate_calls_per_query=float(np.mean([r.surrogate_calls for r in reps])),
                accepted_no_check_per_query=float(np.mean([r.accepted_no_check for r in reps])),
            )
        emit(phase="mechanisms", part="engine", metric=metric_name, mechanism=mech, threshold=t, k=K,
             queries=len(qs), build_s=eng.build_s[mech], **row)
    n = len(qs) + ENGINE_1D
    emit(phase="mechanisms", part="engine", metric=metric_name, checked=f"{n} range + {n} k-NN per mechanism",
         near_tie_differences=swaps)
    return eng


def phase_mechanisms(ops, torch, api, metrics_mod, search_mod, ref, data_np, queries_np) -> dict:
    """The mechanisms phase: LAESA at colors-1M and the five-mechanism engine
    at the paper's colors size, for euclidean and jensen_shannon, with the
    launch counts set to 0 before and read after (every kernel must have
    launched), then the checks.  Returns the phase's launch histogram and
    the jensen_shannon engine's N_seq index, on whose 112,682-row table the
    phase's kernel rows are timed."""
    ops.reset_launches()
    laesa_runs = [phase_laesa(torch, api, metrics_mod, ref, data_np, queries_np, m)
                  for m in ("euclidean", "jensen_shannon")]
    for m in ("euclidean", "jensen_shannon"):
        eng = phase_engine(torch, search_mod, metrics_mod, ref, data_np, queries_np, m)
        torch.cuda.empty_cache()
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        check(launches[name] > 0 or name in ROUTE_ONLY, f"{kid} ({name}) was not launched by the mechanisms phase")
        emit(phase="launch_shapes", launch_phase="mechanisms", kernel=kid, name=name, launches=launches[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    for rec in laesa_runs:
        verify_laesa(torch, rec)
    del laesa_runs
    torch.cuda.empty_cache()
    return hist, eng.indexes["N_seq"]


#: the filtered phase's attribute columns, made from the seed: ``shop``
#: categorical over 1000 values with Zipf s = 1.1 frequencies, ``year`` an
#: int in 2000-2024, ``price`` lognormal, ``in_stock`` true for 90% of rows
SHOPS, ZIPF_S, IN_STOCK_P = 1000, 1.1, 0.9
ATTR_SCHEMA = {"shop": "categorical", "year": "int", "price": "float", "in_stock": "bool"}
FILTER_MODES = (None, "prefilter", "pushdown", "postfilter")
#: the online phase: per round 2,048 rows added, 1,024 ids removed and 256
#: upserted, then the query batches; rounds before the compaction per metric
#: (6 and 2 until the durable phase joined the run, which had to stay in
#: its time limit)
ONLINE_ADD, ONLINE_REMOVE, ONLINE_UPSERT = 2048, 1024, 256
ONLINE_ROUNDS = {"euclidean": 3, "jensen_shannon": 1}
#: queries of the filtered phase's forced-postfilter k-NN batch under the
#: rarest predicate (64 until the durable phase joined the run: 46 s eu and
#: 154 s JSD of per-query doubling fetches, PERF.md section 5), and under
#: the others (64 until the select and sharded_train phases joined the run:
#: 28 s of the baseline's doubling fetches the planner never chooses)
RARE_POSTFILTER_Q, POSTFILTER_Q = 8, 16


def make_attributes(n: int, seed: int) -> dict:
    """``n`` rows of the four attribute columns, from ``seed``."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, SHOPS + 1, dtype=np.float64) ** -ZIPF_S
    names = np.array([f"shop{r:04d}" for r in range(SHOPS)])
    return {
        "shop": names[rng.choice(SHOPS, size=n, p=p / p.sum())],
        "year": rng.integers(2000, 2025, size=n),
        "price": rng.lognormal(3.0, 1.0, size=n),
        "in_stock": rng.random(n) < IN_STOCK_P,
    }


def no_attributes(n: int) -> dict:
    """The oracle's columns for ``n`` rows added without attributes: the
    store holds no row for them, so no predicate matches them (SQL NULL);
    these values match none of ``filter_predicates``."""
    return {"shop": np.full(n, ""), "year": np.full(n, -1), "price": np.full(n, np.nan),
            "in_stock": np.zeros(n, dtype=bool)}


def take_attributes(attrs: dict, rows) -> dict:
    return {name: col[rows] for name, col in attrs.items()}


def filter_predicates(filter_mod, attrs) -> dict:
    """The four predicates over the generated columns ``attrs``: the most
    common shop (~18% of rows at Zipf 1.1 over 1000 values), recent years in
    stock (~18%), in stock (~90%), and the ten rarest shops (~0.1%).  Each
    name maps to (``Predicate``, the same test in numpy over a dict of
    columns): the checks' reference match sets come from the columns, never
    from the ``AttributeStore`` under test."""
    P = filter_mod.Predicate
    shops, counts = np.unique(attrs["shop"], return_counts=True)
    order = np.lexsort((shops, counts))
    top, rare = str(shops[order[-1]]), [str(s) for s in shops[order[:10]]]
    return {
        "shop_top": (P.eq("shop", top), lambda a: a["shop"] == top),
        "recent_in_stock": (P.between("year", 2020, 2024) & P.eq("in_stock", True),
                            lambda a: (a["year"] >= 2020) & (a["year"] <= 2024) & a["in_stock"]),
        "in_stock": (P.eq("in_stock", True), lambda a: a["in_stock"].copy()),
        "shop_rare10": (P.isin("shop", rare), lambda a: np.isin(a["shop"], rare)),
    }


def segments_of(index):
    """The table segments a query of ``index`` scans (base and delta of a
    mutable index, of a durable index's inner one)."""
    if getattr(index, "kind", None) == "durable":
        index = index._inner
    if hasattr(index, "_base"):
        return [s for s in (index._base, index._delta_seg) if s is not None]
    return [index]


def overflow_count(index) -> int:
    return sum(s._inner.overflow_queries for s in segments_of(index))


def run_batch(torch, index, qs, spec):
    """(results, wall s, overflowed queries) of one query call."""
    before = overflow_count(index)
    res, wall = timed(torch, lambda: index.query(qs, spec))
    return ([res] if qs.ndim == 1 else list(res)), wall, overflow_count(index) - before


def calls_per_query(results) -> float:
    return float(np.mean([r.stats.original_calls for r in results]))


def phase_filtered(ops, torch, api, filter_mod, ref, metrics_mod, indexes, queries_np, store, attrs) -> dict:
    """Filtered search on the colors-1M exact indexes (euclidean and
    jensen_shannon) with the 1M-row attribute store attached, the launch
    counts set to 0 before and read after: per metric and predicate a
    64-query exact k-NN (k=10) and range batch under the planner's choice
    and under each forced strategy (a forced-postfilter k-NN batch:
    ``POSTFILTER_Q`` queries, ``RARE_POSTFILTER_Q`` under the ten rarest
    shops), one approximate k-NN batch (dims 10, refine 64)
    under pushdown and 8 1-D k-NN requests under pushdown.
    ``store`` holds ``attrs``, the generated columns.  Returns what
    ``verify_filtered`` checks."""
    Query = api.Query
    tests = filter_predicates(filter_mod, attrs)
    preds = {name: pred for name, (pred, _) in tests.items()}
    qs = queries_np[:Q]
    ops.reset_launches()
    runs = []
    for metric, index in indexes.items():
        index.attach_attributes(store)
        brute = BruteForce(torch, ref, index.data, metrics_mod.get_metric(metric))
        t_range = float(np.sort(brute.dists(queries_np[0]).cpu().numpy())[99])
        tasks = []
        for pname, pred in preds.items():
            sel = store.selectivity(pred)
            for mode in FILTER_MODES:
                for task, spec in (("knn_batch", Query.knn(K, where=pred, filter_mode=mode)),
                                   ("range_batch", Query.range(t_range, where=pred, filter_mode=mode))):
                    strategy = index.plan(spec).filter_strategy
                    n_q = Q
                    if (mode, task) == ("postfilter", "knn_batch"):
                        n_q = RARE_POSTFILTER_Q if pname == "shop_rare10" else POSTFILTER_Q
                    res, wall, over = run_batch(torch, index, qs[:n_q], spec)
                    emit(phase="filtered", metric=metric, predicate=pname, selectivity=sel, mode=mode or "auto",
                         strategy=strategy, task=task, queries=len(res), wall_ms=wall * 1e3,
                         original_calls_per_query=calls_per_query(res), overflow_queries=over)
                    tasks.append((pname, task, spec, qs[:len(res)], res))
        pred = preds["shop_top"]
        spec = Query.knn(K, mode="approx", dims=APPROX_DIMS, refine=REFINE, where=pred, filter_mode="pushdown")
        res, wall, over = run_batch(torch, index, qs, spec)
        emit(phase="filtered", metric=metric, predicate="shop_top", mode="pushdown", task="approx_knn_batch",
             strategy=index.plan(spec).filter_strategy, queries=len(res), wall_ms=wall * 1e3,
             original_calls_per_query=calls_per_query(res), overflow_queries=over)
        tasks.append(("shop_top", "approx_knn_batch", spec, qs, res))
        spec = Query.knn(K, where=pred, filter_mode="pushdown")
        res, wall, over = [], 0.0, 0
        for q in qs[:8]:
            r, w, o = run_batch(torch, index, q, spec)
            res += r
            wall, over = wall + w, over + o
        emit(phase="filtered", metric=metric, predicate="shop_top", mode="pushdown", task="knn_1d", queries=len(res),
             wall_ms_per_query=wall * 1e3 / len(res), original_calls_per_query=calls_per_query(res),
             overflow_queries=over)
        tasks.append(("shop_top", "knn_1d", spec, qs[:8], res))
        runs.append(dict(metric=metric, index=index, brute=brute, t=t_range, tasks=tasks))
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        check(launches[name] > 0 or name in ROUTE_ONLY, f"{kid} ({name}) was not launched by the filtered phase")
        emit(phase="launch_shapes", launch_phase="filtered", kernel=kid, name=name, launches=launches[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    return dict(runs=runs, tests=tests, attrs=attrs, hist=hist)


def allowed_rows(torch, ids: np.ndarray, n: int, device):
    """(allowed row positions as a device tensor, (n,) device bool mask)."""
    pos = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[pos] = True
    return pos, mask


def expect_knn(torch, D, pos, k):
    """Per query the k smallest (f64 distance, id) among rows ``pos``
    (ascending ids), on the card."""
    order = torch.sort(D[:, pos], dim=1, stable=True).indices[:, :k]
    return pos[order].cpu().numpy()


def check_exact(torch, D_row, res, want_ids, allowed, t, tol, what):
    """One exact answer against the brute force: k-NN (``t`` None) ids and
    tie order equal (f32-refined Euclidean may swap rows whose f64
    distances agree within ``tol``), distances within ``tol``; range ids
    equal up to rows within ``tol`` of t; every id a matching row.
    Returns the near-tie swaps."""
    got = np.asarray(res.ids, dtype=np.int64)
    got_t = torch.as_tensor(got, device=D_row.device)
    check(bool(allowed[got_t].all()), f"{what}: answered a row the predicate or a remove excludes")
    if t is None:
        check(len(got) == len(want_ids), f"{what}: k-NN result has the wrong length")
        dg = D_row[got_t].cpu().numpy()
        dw = D_row[torch.as_tensor(want_ids, device=D_row.device)].cpu().numpy()
        check(bool(np.allclose(res.distances, dg, rtol=tol, atol=tol)), f"{what}: k-NN distances differ")
        check(bool(np.allclose(dg, dw, rtol=tol, atol=tol)), f"{what}: k-NN ids differ from brute force")
        return int((got != want_ids).sum())
    diff = np.setxor1d(got, want_ids)
    dd = D_row[torch.as_tensor(diff, device=D_row.device)].cpu().numpy()
    check(bool(np.all(np.abs(dd - t) <= tol * max(t, 1.0))), f"{what}: range ids differ from brute force")
    return int(diff.shape[0])


def brute_matrix(torch, brute, qs):
    return torch.stack([brute.dists(q) for q in qs])


def verify_filtered(torch, ops, ref, rec):
    """Every exact filtered answer against an f64 brute force over the
    matching rows on the card (JSD plain, not K5); the approximate answers
    from their own candidates: the ``REFINE`` smallest f32 truncated mid
    keys of K1 over the matching rows (query apexes projected by the plain
    versions), the k smallest (f64 distance, id) among them, every id
    matching, ``original_calls == dims + refine``.  The matching rows are
    the generated columns' (logical id = row position on a plain index)."""
    for run in rec["runs"]:
        index, brute, metric = run["index"], run["brute"], run["metric"]
        inner = index._inner
        N = inner.n_rows
        tol = refine_tol(torch, metric, inner.data)
        D = brute_matrix(torch, brute, run["tasks"][0][3])
        allowed = {name: allowed_rows(torch, np.flatnonzero(test(rec["attrs"])), N, D.device)
                   for name, (_, test) in rec["tests"].items()}
        want = {name: expect_knn(torch, D, pos, K) for name, (pos, _) in allowed.items()}
        checked, swaps = 0, 0
        for pname, task, spec, qs, results in run["tasks"]:
            pos, mask = allowed[pname]
            if task == "approx_knn_batch":
                verify_filtered_approx(torch, ops, ref, inner, brute, D, mask, qs, results)
                continue
            for qi, r in enumerate(results):
                what = f"filtered {metric} {pname} {task} mode={spec.filter_mode} q{qi}"
                if spec.task == "knn":
                    swaps += check_exact(torch, D[qi], r, want[pname][qi], mask, None, tol, what)
                else:
                    t = float(spec.threshold)
                    ids = pos[D[qi, pos] <= t].cpu().numpy()
                    swaps += check_exact(torch, D[qi], r, ids, mask, t, tol, what)
                checked += 1
        emit(phase="filtered", metric=metric, checked_exact_answers=checked, near_tie_differences=swaps)
        del D
        torch.cuda.empty_cache()


def verify_filtered_approx(torch, ops, ref, inner, brute, D, mask, qs, results):
    prefix = inner._prefix_projector(APPROX_DIMS)
    apexes = ref.apex_project_ref(brute.cross(qs[:8], prefix.pivots_t), prefix._Linv_t, prefix._sq_norms_t)
    L, U = (t.cpu().numpy() for t in ops.apex_bounds_batch(inner._kernel_table(), apexes.float(),
                                                            dims=APPROX_DIMS))
    live = mask.cpu().numpy()
    for qi, r in enumerate(results[:8]):
        cand = host_select(np.float32(0.5) * (L[qi:qi + 1] + U[qi:qi + 1]), live[None, :], REFINE)[0]
        check(bool(live[r.ids].all()), "filtered approximate k-NN answered a row the predicate excludes")
        check(bool(np.isin(r.ids, cand).all()), "filtered approximate k-NN answered outside its candidates")
        d64 = D[qi].cpu().numpy()
        check(np.array_equal(r.ids, cand[np.lexsort((cand, d64[cand]))][:K]),
              "filtered approximate k-NN is not the k nearest of its candidates")
        check(r.stats.original_calls == APPROX_DIMS + REFINE, "original_calls must be dims + refine")


class Oracle:
    """The online phase's reference corpus, kept apart from the index and
    its attribute store: every row ever added on the card and its generated
    attribute row (both append only), each slot's logical id, and which
    slots are live."""

    def __init__(self, torch, rows, ids, attrs):
        self.torch = torch
        self.rows = rows
        self.attrs = dict(attrs)
        self.slot_id = np.asarray(ids, dtype=np.int64)
        self.live = np.ones(len(ids), dtype=bool)
        self.slot_of = np.full(int(self.slot_id.max()) + 1, -1, dtype=np.int64)
        self.slot_of[self.slot_id] = np.arange(len(ids))

    def add(self, ids, rows_np, attrs):
        start = self.rows.shape[0]
        self.rows = self.torch.cat([self.rows, self.torch.as_tensor(rows_np, device=self.rows.device)])
        self.attrs = {name: np.concatenate([col, attrs[name]]) for name, col in self.attrs.items()}
        self.slot_id = np.concatenate([self.slot_id, ids])
        self.live = np.concatenate([self.live, np.ones(len(ids), dtype=bool)])
        if int(ids.max()) >= self.slot_of.shape[0]:
            self.slot_of = np.concatenate([self.slot_of, np.full(int(ids.max()) + 1 - self.slot_of.shape[0], -1)])
        self.slot_of[ids] = np.arange(start, start + len(ids))

    def remove(self, ids):
        slots = self.slot_of[ids]
        check(bool((slots >= 0).all()), "the oracle removes an id it does not hold")
        self.live[slots] = False
        self.slot_of[ids] = -1

    def live_ids(self) -> np.ndarray:
        return np.sort(self.slot_id[self.live])

    def snapshot(self) -> np.ndarray:
        """The live slots in ascending logical-id order."""
        slots = np.flatnonzero(self.live)
        return slots[np.argsort(self.slot_id[slots], kind="stable")]


def phase_online(ops, torch, api, filter_mod, ref, metrics_mod, data_np, queries_np, attrs, seed) -> dict:
    """The online mutable index, the launch counts set to 0 before and read
    after: ``build_index(colors-1M, metric, mutable=True,
    compact_threshold=None, attributes=store)``, then rounds of 2,048 adds
    (new rows from ``colors_like`` with another seed, with attributes),
    1,024 removes and 256 upserts, each followed by a 64-query exact k-NN
    (k=10), range and filtered k-NN (``shop`` = the most common) batch, the
    filtered one forced to pushdown and under the planner's choice; then ``compact()`` and one more round with 8 1-D k-NN requests.
    Euclidean takes 3 rounds before the compaction, jensen_shannon 1.
    Returns what ``verify_online`` checks."""
    from repro_torch.data import colors_like

    Query = api.Query
    qs = queries_np[:Q]
    ops.reset_launches()
    runs = []
    for mi, (metric, rounds) in enumerate(ONLINE_ROUNDS.items()):
        report = lambda **f: emit(phase="online", metric=metric, **f)  # noqa: E731
        store = filter_mod.AttributeStore(ATTR_SCHEMA)
        store.put(np.arange(N_ROWS), attrs)
        pred, test = filter_predicates(filter_mod, attrs)["shop_top"]
        index, wall = timed(torch, lambda: api.build_index(
            data_np, metric, n_pivots=N_PIVOTS, seed=SEED % 1000, mutable=True, compact_threshold=None,
            attributes=store, device=DEVICE))
        report(task="build", rows=N_ROWS, wall_s=wall)
        per_round = ONLINE_ADD + ONLINE_UPSERT
        pool = colors_like(n=(rounds + 1) * per_round, dim=DIM, seed=seed + 1 + mi)
        pool_attrs = make_attributes(len(pool), seed + 11 + mi)
        rng = np.random.default_rng(seed + 21 + mi)
        oracle = Oracle(torch, torch.as_tensor(data_np, device=DEVICE), np.arange(N_ROWS), attrs)
        brute = BruteForce(torch, ref, oracle.rows, metrics_mod.get_metric(metric))
        t_range = float(np.sort(brute.dists(queries_np[0]).cpu().numpy())[99])   # ~100th-neighbour distance
        del brute
        rounds_out = []
        for r in range(rounds + 1):
            out = {"round": r}
            if r == rounds:
                _, wall = timed(torch, index.compact)
                check(index.stats()["delta_rows"] == 0 and index.stats()["tombstones"] == 0,
                      "compact() left a delta or tombstones")
                out["compact_ms"] = wall * 1e3
            block = slice(r * per_round, r * per_round + ONLINE_ADD)
            ids, wall = timed(torch, lambda: index.add(pool[block], attrs=take_attributes(pool_attrs, block)))
            oracle.add(ids, pool[block], take_attributes(pool_attrs, block))
            out["add_ms"] = wall * 1e3
            victims = rng.choice(oracle.live_ids(), size=ONLINE_REMOVE, replace=False)
            _, wall = timed(torch, lambda: index.remove(victims))
            oracle.remove(victims)
            out["remove_ms"] = wall * 1e3
            targets = rng.choice(oracle.live_ids(), size=ONLINE_UPSERT, replace=False)
            block = slice(r * per_round + ONLINE_ADD, (r + 1) * per_round)
            _, wall = timed(torch, lambda: index.upsert(targets, pool[block], attrs=take_attributes(pool_attrs, block)))
            oracle.remove(targets)
            oracle.add(targets, pool[block], take_attributes(pool_attrs, block))
            out["upsert_ms"] = wall * 1e3
            _, wall = timed(torch, index._materialize)
            out["materialize_ms"] = wall * 1e3
            st = index.stats()
            out.update(delta_rows=st["delta_rows"], tombstones=st["tombstones"], live_rows=st["n_objects"])
            snap = oracle.snapshot()
            tasks = []
            specs = [("knn_batch", Query.knn(K)), ("range_batch", Query.range(t_range)),
                     ("filtered_knn_batch", Query.knn(K, where=pred, filter_mode="pushdown")),
                     ("filtered_auto_knn_batch", Query.knn(K, where=pred))]
            for task, spec in specs:
                res, wall, over = run_batch(torch, index, qs, spec)
                out[task] = dict(wall_ms=wall * 1e3, original_calls_per_query=calls_per_query(res),
                                 overflow_queries=over)
                tasks.append((task, spec, qs, res))
            out["filtered_auto_strategy"] = index.plan(Query.knn(K, where=pred)).filter_strategy
            if r == rounds:
                res, wall, over = [], 0.0, 0
                for q in qs[:8]:
                    rr, w, o = run_batch(torch, index, q, Query.knn(K))
                    res += rr
                    wall, over = wall + w, over + o
                out["knn_1d"] = dict(wall_ms_per_query=wall * 1e3 / len(res),
                                     original_calls_per_query=calls_per_query(res), overflow_queries=over)
                tasks.append(("knn_1d", Query.knn(K), qs[:8], res))
            report(**out)
            rounds_out.append(dict(snap=snap, tasks=tasks, store_match=index.attributes.match(pred)))
        check(np.array_equal(index.ids(), oracle.live_ids()), "the index's live ids differ from the oracle's")
        runs.append(dict(metric=metric, index=index, oracle=oracle, rounds=rounds_out, t=t_range))
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        check(launches[name] > 0 or name in ROUTE_ONLY, f"{kid} ({name}) was not launched by the online phase")
        emit(phase="launch_shapes", launch_phase="online", kernel=kid, name=name, launches=launches[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    return dict(runs=runs, hist=hist, pred=pred, test=test)


def verify_online(torch, ref, metrics_mod, rec, phase="online"):
    """Every online (or durable) answer against an f64 brute force over the
    round's live rows (the oracle's, not the index's; JSD plain, not K5):
    k-NN ids and tie order, range ids, and the filtered k-NN over the live
    rows whose generated attribute rows (the oracle's) match the predicate;
    and the index's own store matching exactly those live ids."""
    for run in rec["runs"]:
        metric, oracle = run["metric"], run["oracle"]
        m = metrics_mod.get_metric(metric)
        checked, swaps = 0, 0
        for ri, rnd in enumerate(run["rounds"]):
            snap = rnd["snap"]
            ids = oracle.slot_id[snap]
            rows = oracle.rows[torch.as_tensor(snap, device=oracle.rows.device)]
            tol = refine_tol(torch, metric, rows)
            brute = BruteForce(torch, ref, rows, m)
            D = brute_matrix(torch, brute, rnd["tasks"][0][2])
            everyone = torch.arange(len(ids), device=D.device)
            matching = np.flatnonzero(rec["test"](take_attributes(oracle.attrs, snap)))
            check(np.array_equal(rnd["store_match"], ids[matching]),
                  f"{phase} {metric} round {ri}: the index's attribute store matches other ids than the oracle")
            matching = torch.as_tensor(matching, device=D.device)
            masks = {"all": torch.ones(len(ids), dtype=torch.bool, device=D.device),
                     "match": torch.zeros(len(ids), dtype=torch.bool, device=D.device)}
            masks["match"][matching] = True
            want = {"all": expect_knn(torch, D, everyone, K), "match": expect_knn(torch, D, matching, K)}
            for task, spec, qs, results in rnd["tasks"]:
                key = "match" if spec.where is not None else "all"
                for qi, r in enumerate(results):
                    # logical ids -> positions among the live rows
                    local = SimpleNamespace(ids=np.searchsorted(ids, r.ids), distances=r.distances)
                    check(np.array_equal(ids[np.minimum(local.ids, len(ids) - 1)], r.ids),
                          f"{phase} {metric} {task}: answered an id that is not live")
                    what = f"{phase} {metric} round {ri} {task} q{qi}"
                    if spec.task == "knn":
                        swaps += check_exact(torch, D[qi], local, want[key][qi], masks[key], None, tol, what)
                    else:
                        t = float(spec.threshold)
                        exp = everyone[D[qi] <= t].cpu().numpy()
                        swaps += check_exact(torch, D[qi], local, exp, masks[key], t, tol, what)
                    checked += 1
            del D, brute, rows
            torch.cuda.empty_cache()
        emit(phase=phase, metric=metric, checked_answers=checked, near_tie_differences=swaps)


#: the durable phase: colors-1M behind a WAL (``build_index(durable=True)``);
#: per round 16 add records of 128 rows with attributes, 8 remove records of
#: 128 ids and 2 upsert records of 128 rows, then the query batches; 2
#: euclidean rounds (3 until phase 13's tensor-parallel runs joined the
#: run), so the second mutates and checks an index on top of a checked
#: round; each round's seconds printed
DURABLE_RECORD, DURABLE_ADDS, DURABLE_REMOVES, DURABLE_UPSERTS = 128, 16, 8, 2
DURABLE_ROUNDS = {"euclidean": 2, "jensen_shannon": 1}
DURABLE_FSYNC_EVERY, DURABLE_DRIFT = 8, 0.25
#: the most shifted rows the maintenance writes before drift_pending: the
#: detector pools every row since the fit, so the rounds' rows dilute it
#: (after 3 euclidean rounds' 7,040 rows, 20,000-30,000 shifted rows raise
#: the statistic past 0.25)
DURABLE_SHIFTED = 65_536
#: rows per add record of that shifted stream (128 until the select and
#: sharded_train phases joined the run: at 3 euclidean rounds the stream
#: took 269 records before drift_pending, and an add's cost is mostly per
#: record)
DURABLE_SHIFTED_RECORD = 1024
#: queries of the crash, swap and persistence equality checks (bit-equal
#: answers of two indexes over the same rows)
DURABLE_CHECK_Q = 16
#: free disk asked for under build/: a 1M-row checkpoint is ~0.6 GB, beside
#: it two crash copies, a save and a refit's new checkpoint
DURABLE_DISK_BYTES = 4 << 30


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def percentiles_ms(seconds) -> dict:
    a = np.asarray(seconds, dtype=np.float64) * 1e3
    return dict(n=int(a.size), p50_ms=float(np.percentile(a, 50)), p99_ms=float(np.percentile(a, 99)),
                max_ms=float(a.max()))


class WalProbe:
    """Host-clock times of one log's appends and fsyncs, taken by wrapping
    the two methods on the instance (the program itself is unchanged); an
    append that reaches its batch's fsync includes it."""

    def __init__(self, wal):
        self.append_s, self.fsync_s = [], []
        append, fsync = wal.append, wal._fsync_locked

        def timed_append(*a, **kw):
            t0 = time.perf_counter()
            out = append(*a, **kw)
            self.append_s.append(time.perf_counter() - t0)
            return out

        def timed_fsync():
            t0 = time.perf_counter()
            fsync()
            self.fsync_s.append(time.perf_counter() - t0)

        wal.append, wal._fsync_locked = timed_append, timed_fsync

    def report(self) -> dict:
        return dict(append=percentiles_ms(self.append_s), fsyncs=len(self.fsync_s),
                    fsync_ms_mean=float(np.mean(self.fsync_s) * 1e3) if self.fsync_s else None)


def same_answers(got, want, what):
    """Two indexes' answers bit for bit: ids, distances and the cost ledger."""
    check(len(got) == len(want), f"{what}: different batch sizes")
    for qi, (g, w) in enumerate(zip(got, want)):
        check(np.array_equal(g.ids, w.ids), f"{what} q{qi}: ids differ")
        check((g.distances is None) == (w.distances is None)
              and (g.distances is None or np.array_equal(g.distances, w.distances)), f"{what} q{qi}: distances differ")
        cost = lambda s: (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)  # noqa: E731
        check(cost(g.stats) == cost(w.stats), f"{what} q{qi}: QueryStats differ")


def open_timed(torch, ops, store_mod, path):
    """Recovery of one durable directory on the card, split into the
    checkpoint load, the WAL replay (``apply_record`` timed in place) and the
    first read view's materialisation of the replayed delta (its K5/K4);
    returns (index, timings, K4 classes of the materialisation)."""
    durable_mod = sys.modules[store_mod.DurableIndex.__module__]
    apply_record, spent = durable_mod.apply_record, [0.0, 0]

    def timed_apply(*a, **kw):
        t0 = time.perf_counter()
        apply_record(*a, **kw)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1

    durable_mod.apply_record = timed_apply
    try:
        index, wall = timed(torch, lambda: store_mod.open_durable(path, device=DEVICE))
    finally:
        durable_mod.apply_record = apply_record
    before = dict(ops.SHAPE_LAUNCHES["apex_project"])
    _, mat = timed(torch, index._snapshot)
    k4 = sorted(cls for cls, n in ops.SHAPE_LAUNCHES["apex_project"].items() if n > before.get(cls, 0))
    return index, dict(open_s=wall, checkpoint_load_s=wall - spent[0], replay_s=spent[0], records_replayed=spent[1],
                       materialize_s=mat, recovery_s=wall + mat), k4


def bound_probe(torch, seg, queries) -> dict:
    """The fitted pivot set's tightness for ``queries`` on an n-simplex
    segment: the mean two-sided bound width (upb - lwb; the JAX package's
    ``bench_online._mean_bound_width``) and the k-NN candidates per query
    (rows whose lwb is at most the query's K-th smallest upb), from one
    bound scan (K4, K1) and no refinement."""
    inner = seg._inner
    lwb, upb = inner.bounds_batch(inner.query_apex_batch(queries))
    kth = torch.kthvalue(upb, K, dim=1).values
    return dict(mean_bound_width=float((upb - lwb).double().mean()),
                candidates_per_query=float((lwb <= kth[:, None]).sum(dim=1).double().mean()))


class Reader(threading.Thread):
    """A reader looping 64-query exact k-NN batches against a durable index
    while maintenance swaps generations under it: every answer must hold k
    ids at non-decreasing distances, each id allocated (so live at some
    point of the run).  Keeps (generation before, after, wall s) per batch."""

    def __init__(self, torch, api, index, qs):
        super().__init__(name="durable-reader", daemon=True)
        self.torch, self.index, self.qs, self.spec = torch, index, qs, api.Query.knn(K)
        self.stop, self.batches, self.error, self.answers = threading.Event(), [], None, 0

    def run(self):
        from repro_torch.device import on_device

        try:
            with on_device(self.index.device):
                while not self.stop.is_set():
                    g0 = self.index.generation
                    res, wall = timed(self.torch, lambda: self.index.query(self.qs, self.spec))
                    allocated = self.index._inner._next_id
                    for r in res:
                        check(len(r.ids) == K, "a reader's k-NN answer lost rows during a swap")
                        check(bool(np.all(np.diff(r.distances) >= 0)), "a reader's k-NN distances are not sorted")
                        check(bool(r.ids.min() >= 0 and r.ids.max() < allocated), "a reader saw an unallocated id")
                    self.answers += len(res)
                    self.batches.append((g0, self.index.generation, wall))
        except BaseException as e:  # noqa: BLE001 — raised by the main thread
            self.error = e

    def finish(self, generation):
        """Stop once a batch that started on ``generation`` (the swap's) has
        answered, so the reader straddles the swap; then raise its error."""
        deadline = time.monotonic() + 300
        while (self.error is None and self.is_alive() and time.monotonic() < deadline
               and not any(g0 >= generation for g0, _, _ in self.batches)):
            time.sleep(0.05)
        self.stop.set()
        self.join()
        check(self.error is None, f"the reader failed: {self.error!r}")
        check(any(g0 >= generation for g0, _, _ in self.batches), "the reader answered nothing after the swap")


def durable_record(index, oracle, pool, pool_attrs, cursor, op, rng):
    """One mutation record through the durable index and the oracle; returns
    the new pool cursor."""
    block = slice(cursor, cursor + DURABLE_RECORD)
    if op == "remove":
        victims = rng.choice(oracle.live_ids(), size=DURABLE_RECORD, replace=False)
        index.remove(victims)
        oracle.remove(victims)
        return cursor
    attrs = take_attributes(pool_attrs, block)
    if op == "add":
        ids = index.add(pool[block], attrs=attrs)
    else:
        ids = rng.choice(oracle.live_ids(), size=DURABLE_RECORD, replace=False)
        index.upsert(ids, pool[block], attrs=attrs)
        oracle.remove(ids)
    oracle.add(np.asarray(ids, dtype=np.int64), pool[block], attrs)
    return cursor + DURABLE_RECORD


def durable_checks(torch, api, index, qs, t_range, pred, timing=None) -> list:
    """The three batches on ``qs``: k-NN, range and filtered k-NN (the
    planner's choice), as (task, spec, queries, results); each one's wall,
    calls per query and overflowed queries go into ``timing`` if given."""
    Query = api.Query
    out = []
    for task, spec in (("knn_batch", Query.knn(K)), ("range_batch", Query.range(t_range)),
                       ("filtered_knn_batch", Query.knn(K, where=pred))):
        res, wall, over = run_batch(torch, index, qs, spec)
        if timing is not None:
            timing[task] = dict(wall_ms=wall * 1e3, original_calls_per_query=calls_per_query(res),
                                overflow_queries=over)
        out.append((task, spec, qs, res))
    return out


def phase_durable(ops, torch, api, filter_mod, store_mod, ref, metrics_mod, data_np, queries_np, attrs, seed) -> dict:
    """The durable store, the launch counts set to 0 before and read after:
    ``build_index(colors-1M, metric, durable=True, wal_dir=<under build/>,
    fsync_every=8, checkpoint_every=None, drift_threshold=0.25,
    attributes=store)``; rounds of 16 add records of 128 rows (with
    attributes), 8 remove records of 128 ids and 2 upsert records of 128
    rows, each round followed by a 64-query exact k-NN (k=10), range and
    filtered (``shop_top``, the planner's choice) batch, the last also by 8
    1-D k-NN requests; one more add record, ``flush()``, two copies of the
    open directory: copy A reopened on the card answers bit-equal to the
    live index, copy B with its last record (that add) cut in half replays
    one record fewer; then maintenance under load (a ``BackgroundCompactor``
    and a reader thread while a shifted stream drives the drift detector to
    a refit, then an explicit ``compact()`` racing the reader); then a timed
    ``checkpoint()``, ``save()`` and ``load_index`` with equal answers.
    Euclidean 2 rounds, jensen_shannon 1.  Returns what ``verify_online``
    checks (each round's answers and the quiesced ones against an f64 brute
    force over the oracle's rows) and the kernel-row inputs."""
    from repro_torch.data import colors_like

    Query = api.Query
    root = Path(__file__).resolve().parent / "build" / "durable_smoke"
    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free
    emit(phase="durable", task="disk", free_bytes=free, root=str(root))
    check(free >= DURABLE_DISK_BYTES,
          f"the durable phase needs {DURABLE_DISK_BYTES / 2**30:.0f} GiB free under {root}; "
          f"{free / 2**30:.1f} GiB free")
    work = Path(tempfile.mkdtemp(dir=root))
    qs, cq = queries_np[:Q], queries_np[:DURABLE_CHECK_Q]
    t_phase = time.perf_counter()
    ops.reset_launches()
    runs, keep = [], None
    try:
        for mi, (metric, rounds) in enumerate(DURABLE_ROUNDS.items()):
            report = lambda **f: emit(phase="durable", metric=metric, **f)  # noqa: E731
            store = filter_mod.AttributeStore(ATTR_SCHEMA)
            store.put(np.arange(N_ROWS), attrs)
            pred, _ = filter_predicates(filter_mod, attrs)["shop_top"]
            wal_dir = work / metric / "wal"
            index, wall = timed(torch, lambda: api.build_index(
                data_np, metric, n_pivots=N_PIVOTS, seed=SEED % 1000, durable=True, wal_dir=str(wal_dir),
                fsync_every=DURABLE_FSYNC_EVERY, checkpoint_every=None, drift_threshold=DURABLE_DRIFT,
                attributes=store, device=DEVICE))
            report(task="build", rows=N_ROWS, wall_s=wall, checkpoint_bytes=dir_bytes(wal_dir))
            probe = WalProbe(index._wal)
            per_round = (DURABLE_ADDS + DURABLE_UPSERTS) * DURABLE_RECORD
            # new rows from the base's own mixture (colors_like's seed fixes
            # the mixture: rows of another seed are drift from the first add)
            pool = colors_like(n=(rounds + 1) * per_round + 64 * DURABLE_RECORD + mi, dim=DIM, seed=SEED)
            pool_attrs = make_attributes(len(pool), seed + 41 + mi)
            rng = np.random.default_rng(seed + 51 + mi)
            oracle = Oracle(torch, torch.as_tensor(data_np, device=DEVICE), np.arange(N_ROWS), attrs)
            brute = BruteForce(torch, ref, oracle.rows, metrics_mod.get_metric(metric))
            t_range = float(np.sort(brute.dists(queries_np[0]).cpu().numpy())[99])   # ~100th-neighbour distance
            del brute
            checked, cursor, mut = [], 0, {"add": [], "remove": [], "upsert": []}
            for r in range(rounds):
                out, t_round = {"round": r}, time.perf_counter()
                for op, count in (("add", DURABLE_ADDS), ("remove", DURABLE_REMOVES), ("upsert", DURABLE_UPSERTS)):
                    for _ in range(count):
                        t0 = time.perf_counter()
                        cursor = durable_record(index, oracle, pool, pool_attrs, cursor, op, rng)
                        mut[op].append(time.perf_counter() - t0)
                snap = oracle.snapshot()
                tasks = durable_checks(torch, api, index, qs, t_range, pred, timing=out)
                if r == rounds - 1:
                    res, wall, over = [], 0.0, 0
                    for q in qs[:8]:
                        rr, w, o = run_batch(torch, index, q, Query.knn(K))
                        res += rr
                        wall, over = wall + w, over + o
                    out["knn_1d"] = dict(wall_ms_per_query=wall * 1e3 / len(res), overflow_queries=over)
                    tasks.append(("knn_1d", Query.knn(K), qs[:8], res))
                st = index.stats()
                out.update(delta_rows=st["delta_rows"], tombstones=st["tombstones"], live_rows=st["n_objects"],
                           wal_records=st["wal_records"], wal_bytes=st["wal_bytes"],
                           round_s=time.perf_counter() - t_round)
                report(**out)
                checked.append(dict(snap=snap, tasks=tasks, store_match=index.attributes.match(pred)))
            report(task="mutations", **{f"{op}_ms": percentiles_ms(s) for op, s in mut.items()}, wal=probe.report())

            # -- crash: one more add, flush, two copies of the open directory
            snap_before = oracle.snapshot()
            last = slice(cursor, cursor + DURABLE_RECORD)
            last_ids = index.add(pool[last], attrs=take_attributes(pool_attrs, last))
            oracle.add(np.asarray(last_ids, dtype=np.int64), pool[last], take_attributes(pool_attrs, last))
            cursor += DURABLE_RECORD
            index.flush()
            copies = {}
            for name in ("A", "B"):
                _, wall = timed(torch, lambda: shutil.copytree(wal_dir, work / metric / name))
                copies[name] = (work / metric / name, wall)
            live_check = durable_checks(torch, api, index, cq, t_range, pred)
            live_records = index.stats()["wal_records"]
            a_index, a_times, a_k4 = open_timed(torch, ops, store_mod, copies["A"][0])
            check(a_index.stats()["wal_records"] == live_records, "copy A reopened at another sequence number")
            check(np.array_equal(a_index.ids(), index.ids()), "copy A holds other ids than the live index")
            a_check = durable_checks(torch, api, a_index, cq, t_range, pred)
            for (task, _, _, want), (_, _, _, got) in zip(live_check, a_check):
                same_answers(got, want, f"durable {metric} copy A {task}")
            segs = sorted((copies["B"][0]).glob("wal-*.log"))
            records, _, size = store_mod.scan_segment(str(segs[-1]))
            start, end = records[-2][4], records[-1][4]
            check(records[-1][1] == "add" and end == size, "the newest segment does not end in the last add")
            with open(segs[-1], "r+b") as f:
                f.truncate(start + (end - start) // 2)
            b_index, b_times, _ = open_timed(torch, ops, store_mod, copies["B"][0])
            check(b_times["records_replayed"] == a_times["records_replayed"] - 1,
                  f"the torn copy replayed {b_times['records_replayed']} records, not "
                  f"{a_times['records_replayed'] - 1}")
            check(not any(b_index.has_id(int(i)) for i in last_ids), "the torn add's ids survived recovery")
            b_tasks = durable_checks(torch, api, b_index, cq, t_range, pred)
            checked.append(dict(snap=snap_before, tasks=b_tasks, store_match=b_index.attributes.match(pred)))
            b_index.close()
            report(task="recovery", copy_s=[c[1] for c in copies.values()], copy_A=a_times, copy_B=b_times,
                   replay_k4_classes=[list(c) for c in a_k4], wal_bytes=index.stats()["wal_bytes"],
                   last_record_bytes=end - start)
            for path, _ in copies.values():
                shutil.rmtree(path)
            if metric == "jensen_shannon":
                keep = dict(index=a_index, replay_k4=a_k4, pred=pred)   # kernel-row operands
            else:
                a_index.close()

            # -- maintenance under load: drift refit, then an explicit compaction
            maint = durable_maintenance(torch, api, store_mod, index, oracle, pool, pool_attrs, cursor, qs, pred,
                                        t_range, seed + 61 + mi, report)
            checked += maint.pop("checked")

            # -- persistence
            ckpt, wall = timed(torch, index.checkpoint)
            save_dir = work / metric / "save"
            _, save_s = timed(torch, lambda: index.save(str(save_dir)))
            loaded, load_s = timed(torch, lambda: api.load_index(str(save_dir), device=DEVICE))
            for (task, _, _, want), (_, _, _, got) in zip(durable_checks(torch, api, index, cq, t_range, pred),
                                                         durable_checks(torch, api, loaded, cq, t_range, pred)):
                same_answers(got, want, f"durable {metric} save/load {task}")
            report(task="persistence", checkpoint_s=wall, checkpoint_bytes=dir_bytes(ckpt), save_s=save_s,
                   save_bytes=dir_bytes(save_dir), load_s=load_s, live_rows=index.stats()["n_objects"])
            loaded.close()
            check(np.array_equal(index.ids(), oracle.live_ids()),
                  "the durable index's live ids differ from the oracle's")
            report(task="wal", **probe.report(), wal_records=index.stats()["wal_records"])
            index.close()
            shutil.rmtree(work / metric)
            runs.append(dict(metric=metric, oracle=oracle, rounds=checked, t=t_range))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = dict(ops.LAUNCHES)
    emit(phase="durable", task="phase", wall_s=time.perf_counter() - t_phase)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        check(launches[name] > 0 or name in ROUTE_ONLY, f"{kid} ({name}) was not launched by the durable phase")
        emit(phase="launch_shapes", launch_phase="durable", kernel=kid, name=name, launches=launches[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    return dict(runs=runs, hist=hist, test=filter_predicates(filter_mod, attrs)["shop_top"][1], keep=keep)


def durable_maintenance(torch, api, store_mod, index, oracle, pool, pool_attrs, cursor, qs, pred, t_range, seed,
                        report) -> dict:
    """A ``BackgroundCompactor`` and a reader thread on ``index`` while the
    main thread writes a shifted stream (``np.roll(colors_like, 112 // 3)``,
    as the JAX package's drift tests do) in 1,024-row add records until
    ``drift_pending``, then same-distribution records while the compactor
    refits (fold, new pivots, a 1M-row K5/K4 rebuild off the write lock,
    catch-up replay, swap, checkpoint); then an explicit ``compact()``
    racing the reader.  Returns the quiesced answers for the brute force."""
    from repro_torch.data import colors_like

    rng = np.random.default_rng(seed)
    shifted = np.roll(colors_like(n=DURABLE_SHIFTED + Q, dim=DIM, seed=seed), DIM // 3, axis=1)
    shifted, shifted_q = shifted[:DURABLE_SHIFTED], shifted[DURABLE_SHIFTED:]   # the stream; queries like it

    before = bound_probe(torch, index._snapshot()._base, shifted_q)
    g0, refit_s = index.generation, []
    refit = index.refit

    def timed_refit():
        t0 = time.perf_counter()
        out = refit()
        refit_s.append(time.perf_counter() - t0)
        return out

    index.refit = timed_refit            # the compactor's tick calls it
    bg = store_mod.BackgroundCompactor(index, interval_s=0.02)
    reader = Reader(torch, api, index, qs)
    reader.start()
    bg.start()
    stat_pending, n_shifted, n_catchup = None, 0, 0
    t_drift = None
    try:
        while not index.drift_pending and bg.counters["refits"] == 0:
            check(n_shifted < len(shifted) // DURABLE_SHIFTED_RECORD, "the shifted stream never raised drift_pending")
            block = slice(n_shifted * DURABLE_SHIFTED_RECORD, (n_shifted + 1) * DURABLE_SHIFTED_RECORD)
            # rows with no attribute row (the store's host put would cost
            # ~0.2 s per record at 1M rows): they never match a predicate
            ids = index.add(shifted[block])
            oracle.add(np.asarray(ids, dtype=np.int64), shifted[block], no_attributes(DURABLE_SHIFTED_RECORD))
            n_shifted += 1
            stat_pending = index.drift_stat()
        t_drift = time.perf_counter()
        # same-distribution writes while the refit runs: the swap's catch-up
        deadline = time.monotonic() + 300
        while bg.counters["refits"] == 0 and bg.counters["errors"] == 0 and time.monotonic() < deadline:
            if n_catchup < 16:
                cursor = durable_record(index, oracle, pool, pool_attrs, cursor, "add", rng)
                n_catchup += 1
            else:
                time.sleep(0.01)
        refit_wait = time.perf_counter() - t_drift
    finally:
        bg.stop()
        del index.refit
    check(bg.last_error is None, f"the compactor failed: {bg.last_error!r}")
    check(bg.counters["refits"] == 1 and index.refits == 1, f"expected one refit; counters {bg.counters}")
    check(index.generation > g0, "the refit did not bump the generation")
    swap_gen = index.generation
    reader.finish(swap_gen)
    walls = {k: [w for a, b, w in reader.batches if (b < swap_gen if k == "before" else a >= swap_gen)]
             for k in ("before", "after")}
    after = bound_probe(torch, index._snapshot()._base, shifted_q)
    quiet = durable_checks(torch, api, index, qs, t_range, pred)
    checked = [dict(snap=oracle.snapshot(), tasks=quiet, store_match=index.attributes.match(pred))]
    report(task="refit", drift_stat_at_pending=stat_pending, drift_stat_after=index.drift_stat(),
           shifted_records=n_shifted, catchup_records=n_catchup, refit_s=refit_s, refit_wait_s=refit_wait,
           max_swap_hold_ms=index.max_swap_hold_s * 1e3, generation=index.generation,
           shifted_queries_before=before, shifted_queries_after=after, reader_batches=len(reader.batches),
           reader_answers=reader.answers, compactor=bg.stats(),
           **{f"batch_wall_ms_{k}": percentiles_ms(w) if w else None for k, w in walls.items()})
    # an explicit compaction races the reader the same way
    for _ in range(8):
        cursor = durable_record(index, oracle, pool, pool_attrs, cursor, "add", rng)
    g1 = index.generation
    reader = Reader(torch, api, index, qs)
    reader.start()
    time.sleep(0.5)
    _, compact_s = timed(torch, index.compact)
    reader.finish(g1 + 1)
    check(index.generation == g1 + 1 and index.stats()["delta_rows"] == 0, "compact() did not swap a folded base in")
    quiet = durable_checks(torch, api, index, qs, t_range, pred)
    checked.append(dict(snap=oracle.snapshot(), tasks=quiet, store_match=index.attributes.match(pred)))
    report(task="compact", compact_s=compact_s, max_swap_hold_ms=index.max_swap_hold_s * 1e3,
           reader_batches=len(reader.batches), reader_answers=reader.answers)
    return dict(checked=checked)


def durable_kernel_rows(torch, ops, ref, rec, queries_np, log) -> list:
    """The durable phase's kernel rows, timed on the jensen_shannon crash copy
    A (its 1M-row checkpointed base and its replayed delta), K4 at the
    replay's materialisation class and K5 at the drift witness class (8,
    128, 112, f64) always among them: K2 and K3 narrower than the 4,096 cap
    on the delta with the filtered batch's predicate as the row mask, the
    others on the base."""
    keep = rec["keep"]
    index = keep["index"]._inner
    delta = index._materialize()
    sides = index._sides()
    masks, _ = index._side_masks(sides, keep["index"].attributes.match(keep["pred"]))
    slots = masks[[s.seg for s in sides].index(delta)]
    mask = delta._inner._device_mask(delta._inner._mask_of(slots))
    must = [("apex_project", tuple(c)) for c in keep["replay_k4"]]
    must.append(("jsd_pairwise", (8, DURABLE_RECORD, DIM, "float64")))
    rows = kernel_rows(torch, ops, ShapeInputs(torch, ops, ref, index._base, queries_np, log), rec["hist"], "durable",
                       selection_inputs=ShapeInputs(torch, ops, ref, delta, queries_np, log, mask=mask), must=must)
    keep["index"].close()
    return rows


#: the sharded phase: colors-1M as four segments sharing one pivot set, the
#: distributed filter's slots per device (``build_index``'s default); its
#: online part's rounds before the compaction per metric (then ``compact()``
#: and one more round), and the save / load round trip at the paper's size
SHARDS, MAX_CAND = 4, 256
SHARDED_ROUNDS = {"euclidean": 2, "jensen_shannon": 1}
#: requests through the service under each fan-out policy: 2 batches of 64
#: (256 until the select and sharded_train phases joined the run)
SHARDED_SERVE_REQUESTS = 128
#: the device filter's K3 shape class: every query against the flat table
FILTER_CLASS = (Q, MAX_CAND, N_PIVOTS)


def shard_overflow(index) -> list:
    """Per shard, the queries its n-simplex segments sent to an overflow
    route (LAESA and tree segments have none)."""
    return [sum(getattr(seg._inner, "overflow_queries", 0) for seg in segments_of(s) if hasattr(seg, "_inner"))
            for s in index._shards]


def run_sharded(torch, index, qs, spec):
    """(results, wall s, per-shard overflowed queries, device-filter queries
    whose slots overflowed) of one query call on a sharded index."""
    before, f0 = shard_overflow(index), index.filter_overflow_queries
    res, wall = timed(torch, lambda: index.query(qs, spec))
    over = [a - b for a, b in zip(shard_overflow(index), before)]
    return ([res] if qs.ndim == 1 else list(res)), wall, over, index.filter_overflow_queries - f0


def serve(torch, service_mod, index, qs, spec, workers):
    """``SHARDED_SERVE_REQUESTS`` requests through ``SearchService(max_batch=64)`` under the fan-out
    policy ``workers``: (results, wall s, service stats); the results must
    equal a direct batch's ids and distances."""
    with service_mod.SearchService(index, max_batch=64, max_wait_s=0.005, fanout_workers=workers) as svc:
        svc.warmup(spec, qs[0])
        t0 = time.perf_counter()
        results = [f.result(timeout=900) for f in [svc.submit(q, spec) for q in qs]]
        wall = time.perf_counter() - t0
        st = svc.stats()
    for r, w in zip(results, index.query(qs, spec)):
        check(np.array_equal(r.ids, w.ids) and np.array_equal(r.distances, w.distances),
              "served sharded results differ from a direct batch")
    return results, wall, st


def phase_sharded(ops, torch, api, service_mod, ref, metrics_mod, data_np, queries_np, seed) -> dict:
    """The sharded composite at colors-1M, the launch counts set to 0 before
    and read after: per metric ``build_index(..., shards=4)`` (every shard on
    one projector), a 64-query exact k-NN batch, exact range batches at query
    0's 10th and 100th neighbour distances through the device filter and
    under ``device_filter=False``, one range batch under each of the layouts
    ``{"replicas": 2}`` and ``{"rows": "replicated"}`` (clamped to the 1 x 1
    grid of one card), an approximate k-NN batch of an ``apex_dims=10,
    refine=64`` build, 8 1-D k-NN and range requests, 128 requests through
    ``SearchService`` under overlapped and sequential fan-out; a mutable
    ``shards=4`` index through rounds of 2,048 adds, 1,024 removes and 256
    upserts (euclidean 2, JSD 1), each followed by k-NN and range batches,
    then ``compact()`` and one more round; euclidean only: LAESA with
    ``shards=4`` (k-NN and range batches) and a save / load round trip of a
    112,682-row sharded mutable index.  Returns what ``verify_sharded``
    checks."""
    Query = api.Query
    qs = queries_np[:Q]
    build_kw = dict(n_pivots=N_PIVOTS, seed=SEED % 1000, shards=SHARDS, device=DEVICE)
    ops.reset_launches()
    runs = []
    for mi, metric in enumerate(("euclidean", "jensen_shannon")):
        report = lambda **f: emit(phase="sharded", metric=metric, **f)  # noqa: E731
        index, wall = timed(torch, lambda: api.build_index(data_np, metric, **build_kw))
        check(all(s._inner.projector is index._projector for s in index._shards),
              "every shard must fit its table with the one shared projector")
        report(task="build", rows=N_ROWS, shard_rows=index.stats()["shard_objects"], wall_s=wall)
        brute = BruteForce(torch, ref, index.data, metrics_mod.get_metric(metric))
        sample = np.sort(brute.dists(queries_np[0]).cpu().numpy())
        t10, t100 = float(sample[9]), float(sample[99])       # query 0's 10th / 100th neighbour distance
        tasks = []

        def go(task, spec, q, idx=index, keep=True, **extra):
            res, wall, over, f_over = run_sharded(torch, idx, q, spec)
            report(task=task, queries=len(res), wall_ms=wall * 1e3, original_calls_per_query=calls_per_query(res),
                   shard_overflow_queries=over, filter_overflow_queries=f_over, **extra)
            if keep:
                tasks.append((task, spec, q, res))
            return res

        go("knn_batch", Query.knn(K), qs)
        for name, t in (("range10", t10), ("range100", t100)):
            before = ops.SHAPE_LAUNCHES["apex_threshold"].get(FILTER_CLASS, 0)
            go(f"{name}_batch", Query.range(t), qs, threshold=t)
            check(index._filter_fn is not None and ops.SHAPE_LAUNCHES["apex_threshold"].get(FILTER_CLASS, 0) > before,
                  "a range batch with the device filter on must launch K3 over the flat table")
            check((index._mesh_data, index._mesh_replicas) == (1, 1), "one card is a 1 x 1 grid")
            index.device_filter = False
            go(f"{name}_host_batch", Query.range(t), qs, threshold=t)
            index.device_filter = None
        default = next(res for task, _, _, res in tasks if task == "range100_batch")
        for label, layout in (("replica_groups", {"replicas": 2}), ("replicated_rows", {"rows": "replicated"})):
            lay, wall = timed(torch, lambda: api.build_index(data_np, metric, layout=layout, **build_kw))
            res = go(f"range100_{label}_batch", Query.range(t100), qs, idx=lay, build_s=wall)
            check((lay._mesh_data, lay._mesh_replicas) == (1, 1),
                  f"layout {layout} must clamp to the 1 x 1 grid on one card, as the reference does on one device")
            check(all(np.array_equal(a.ids, b.ids) for a, b in zip(res, default)),
                  f"layout {layout} answers differently from the default layout")
            del lay
        approx, wall = timed(torch, lambda: api.build_index(data_np, metric, apex_dims=APPROX_DIMS, refine=REFINE,
                                                            **build_kw))
        report(task="build_approx", apex_dims=APPROX_DIMS, refine=REFINE, wall_s=wall)
        approx_res = go("approx_knn_batch", Query.knn(K), qs, idx=approx, keep=False)
        for task, spec in (("knn_1d", Query.knn(K)), ("range100_1d", Query.range(t100))):
            res, wall, over, _ = [], 0.0, [0] * SHARDS, 0
            for q in qs[:8]:
                r, w, o, _ = run_sharded(torch, index, q, spec)
                res += r
                wall, over = wall + w, [a + b for a, b in zip(over, o)]
            report(task=task, queries=len(res), wall_ms_per_query=wall * 1e3 / len(res),
                   original_calls_per_query=calls_per_query(res), shard_overflow_queries=over)
            tasks.append((task, spec, qs[:8], res))
        served = queries_np[:SHARDED_SERVE_REQUESTS]
        for label, workers in (("overlapped", SHARDS), ("sequential", 0)):
            res, wall, st = serve(torch, service_mod, index, served, Query.knn(K), workers)
            report(task=f"service_knn_{label}", requests=len(served), fanout_workers=workers, wall_ms=wall * 1e3,
                   latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
                   n_batches=st["n_batches"], original_calls_per_query=calls_per_query(res))
            tasks.append((f"service_knn_{label}", Query.knn(K), served[:8], res[:8]))
        index.configure_fanout(None)
        online = sharded_online(torch, api, metric, report, data_np, qs, t100, seed + 31 + mi, build_kw)
        extra = {}
        if metric == "euclidean":
            laesa, wall = timed(torch, lambda: api.build_index(data_np, metric, kind="laesa", **build_kw))
            report(task="build_laesa", wall_s=wall)
            extra["laesa"] = [(task, spec, qs, go(f"laesa_{task}", spec, qs, idx=laesa, keep=False))
                              for task, spec in (("knn_batch", Query.knn(K)), ("range100_batch", Query.range(t100)))]
            del laesa
            sharded_round_trip(torch, api, report, data_np, qs, t100, seed + 51)
        runs.append(dict(metric=metric, index=index, brute=brute, tasks=tasks, approx=approx,
                         approx_res=approx_res, online=online, **extra))
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        check(launches[name] > 0 or name in ROUTE_ONLY, f"{kid} ({name}) was not launched by the sharded phase")
        emit(phase="launch_shapes", launch_phase="sharded", kernel=kid, name=name, launches=launches[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    return dict(runs=runs, hist=hist)


def sharded_online(torch, api, metric, report, data_np, qs, t, seed, build_kw) -> dict:
    """The mutable ``shards=4`` index: ``SHARDED_ROUNDS[metric]`` rounds of
    2,048 adds (rows from ``colors_like`` with ``seed``), 1,024 removes and 256
    upserts, each followed by a 64-query k-NN and range batch, then
    ``compact()`` and one more round.  Returns the oracle and each round's
    live slots and answers."""
    from repro_torch.data import colors_like

    Query = api.Query
    rounds = SHARDED_ROUNDS[metric]
    index, wall = timed(torch, lambda: api.build_index(data_np, metric, mutable=True, compact_threshold=None,
                                                       **build_kw))
    report(task="build_mutable", wall_s=wall)
    per_round = ONLINE_ADD + ONLINE_UPSERT
    pool = colors_like(n=(rounds + 1) * per_round, dim=DIM, seed=seed)
    rng = np.random.default_rng(seed + 1)
    oracle = Oracle(torch, torch.as_tensor(data_np, device=DEVICE), np.arange(N_ROWS), {})
    out_rounds = []
    for r in range(rounds + 1):
        out = {}
        if r == rounds:
            _, wall = timed(torch, index.compact)
            st = index.stats()
            check(st["delta_rows"] == 0 and st["tombstones"] == 0, "compact() left a delta or tombstones")
            out["compact_ms"] = wall * 1e3
        block = slice(r * per_round, r * per_round + ONLINE_ADD)
        ids, wall = timed(torch, lambda: index.add(pool[block]))
        oracle.add(ids, pool[block], {})
        out["add_ms"] = wall * 1e3
        victims = rng.choice(oracle.live_ids(), size=ONLINE_REMOVE, replace=False)
        _, wall = timed(torch, lambda: index.remove(victims))
        oracle.remove(victims)
        out["remove_ms"] = wall * 1e3
        targets = rng.choice(oracle.live_ids(), size=ONLINE_UPSERT, replace=False)
        block = slice(r * per_round + ONLINE_ADD, (r + 1) * per_round)
        _, wall = timed(torch, lambda: index.upsert(targets, pool[block]))
        oracle.remove(targets)
        oracle.add(targets, pool[block], {})
        out["upsert_ms"] = wall * 1e3
        st = index.stats()
        out.update(shard_objects=st["shard_objects"], delta_rows=st["delta_rows"], tombstones=st["tombstones"])
        tasks = []
        for task, spec in (("knn_batch", Query.knn(K)), ("range100_batch", Query.range(t))):
            res, wall, over, f_over = run_sharded(torch, index, qs, spec)
            out[task] = dict(wall_ms=wall * 1e3, original_calls_per_query=calls_per_query(res),
                             shard_overflow_queries=over, filter_overflow_queries=f_over)
            tasks.append((task, spec, qs, res))
        report(task="online_round", round=r, **out)
        out_rounds.append(dict(snap=oracle.snapshot(), tasks=tasks))
    check(np.array_equal(index.ids(), oracle.live_ids()), "the sharded index's live ids differ from the oracle's")
    return dict(oracle=oracle, rounds=out_rounds)


def sharded_round_trip(torch, api, report, data_np, qs, t, seed):
    """``save`` / ``load_index`` of a 112,682-row sharded mutable euclidean
    index after 2,048 adds and 1,024 removes: the loaded index must answer a
    k-NN and a range batch with the same ids, distances and
    ``original_calls``."""
    from repro_torch.data import colors_like

    index = api.build_index(data_np[:ENGINE_ROWS], "euclidean", n_pivots=N_PIVOTS, seed=SEED % 1000, shards=SHARDS,
                            mutable=True, compact_threshold=None, device=DEVICE)
    index.add(colors_like(n=ONLINE_ADD, dim=DIM, seed=seed))
    index.remove(np.random.default_rng(seed).choice(index.ids(), size=ONLINE_REMOVE, replace=False))
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "build") as tmp:
        _, save_s = timed(torch, lambda: index.save(Path(tmp) / "sharded.idx"))
        loaded, load_s = timed(torch, lambda: api.load_index(Path(tmp) / "sharded.idx", device=DEVICE))
    for spec in (api.Query.knn(K), api.Query.range(t)):
        for a, b in zip(index.query(qs, spec), loaded.query(qs, spec)):
            check(np.array_equal(a.ids, b.ids) and a.stats.original_calls == b.stats.original_calls,
                  "the loaded sharded index answers differently")
            check(a.distances is None or np.array_equal(a.distances, b.distances), "loaded distances differ")
    report(task="save_load", rows=int(index.stats()["n_objects"]), save_s=save_s, load_s=load_s,
           answers_equal=True)


def verify_sharded(torch, ops, ref, metrics_mod, rec):
    """Every exact sharded answer against an f64 brute force on the card
    (JSD plain, not K5): the plain, layout, 1-D, served (first 8) and LAESA
    answers over the corpus, the mutable index's over the oracle's live rows
    each round; the approximate answers from their own candidates: per
    shard the ``REFINE`` smallest f32 truncated mid keys of K1 over its rows
    (query apexes projected by the plain versions), the k smallest (f64
    distance, id) of their union, ``original_calls = dims + shards x
    refine``."""
    for run in rec["runs"]:
        metric, brute = run["metric"], run["brute"]
        m = metrics_mod.get_metric(metric)
        tol = refine_tol(torch, metric, run["index"]._shards[0].data)
        D = brute_matrix(torch, brute, run["tasks"][0][2])
        everyone = torch.arange(D.shape[1], device=D.device)
        allowed = torch.ones(D.shape[1], dtype=torch.bool, device=D.device)
        want = expect_knn(torch, D, everyone, K)
        checked, swaps = 0, 0
        for task, spec, qs, results in run["tasks"] + run.get("laesa", []):
            for qi, r in enumerate(results):
                what = f"sharded {metric} {task} q{qi}"
                if spec.task == "knn":
                    swaps += check_exact(torch, D[qi], r, want[qi], allowed, None, tol, what)
                else:
                    t = float(spec.threshold)
                    swaps += check_exact(torch, D[qi], r, everyone[D[qi] <= t].cpu().numpy(), allowed, t, tol, what)
                checked += 1
        verify_sharded_approx(torch, ops, ref, run, D, tol)
        del D
        torch.cuda.empty_cache()
        online = run["online"]
        oracle = online["oracle"]
        for ri, rnd in enumerate(online["rounds"]):
            snap = rnd["snap"]
            ids = oracle.slot_id[snap]
            rows = oracle.rows[torch.as_tensor(snap, device=oracle.rows.device)]
            Dr = brute_matrix(torch, BruteForce(torch, ref, rows, m), rnd["tasks"][0][2])
            live = torch.arange(len(ids), device=Dr.device)
            every = torch.ones(len(ids), dtype=torch.bool, device=Dr.device)
            want_r = expect_knn(torch, Dr, live, K)
            for task, spec, qs, results in rnd["tasks"]:
                for qi, r in enumerate(results):
                    local = SimpleNamespace(ids=np.searchsorted(ids, r.ids), distances=r.distances)
                    check(np.array_equal(ids[np.minimum(local.ids, len(ids) - 1)], r.ids),
                          f"sharded online {metric} {task}: answered an id that is not live")
                    what = f"sharded online {metric} round {ri} {task} q{qi}"
                    if spec.task == "knn":
                        swaps += check_exact(torch, Dr[qi], local, want_r[qi], every, None, tol, what)
                    else:
                        t = float(spec.threshold)
                        swaps += check_exact(torch, Dr[qi], local, live[Dr[qi] <= t].cpu().numpy(), every, t, tol,
                                             what)
                    checked += 1
            del Dr, rows
            torch.cuda.empty_cache()
        emit(phase="sharded", metric=metric, checked_exact_answers=checked, near_tie_differences=swaps)


def verify_sharded_approx(torch, ops, ref, run, D, tol):
    index, results = run["approx"], run["approx_res"]
    qs8 = run["tasks"][0][2][:8]
    cands = []
    for s, shard in enumerate(index._shards):
        inner = shard._inner
        prefix = inner._prefix_projector(APPROX_DIMS)
        apexes = ref.apex_project_ref(run["brute"].cross(qs8, prefix.pivots_t), prefix._Linv_t, prefix._sq_norms_t)
        L, U = (t.cpu().numpy() for t in ops.apex_bounds_batch(inner._kernel_table(), apexes.float(),
                                                                dims=APPROX_DIMS))
        local = host_select(np.float32(0.5) * (L + U), None, REFINE)
        cands.append(index._shard_ids[s][local])
    cands = np.concatenate(cands, axis=1)
    recall, swaps = [], 0
    for qi, r in enumerate(results[:8]):
        check(r.approx == {"dims": APPROX_DIMS, "refine": REFINE}, "an approximate result must carry its config")
        c = cands[qi]
        d64 = D[qi].cpu().numpy()
        check(bool(np.isin(r.ids, c).all()), "sharded approximate k-NN answered outside its shards' candidates")
        swaps += agree_knn(r, c[np.lexsort((c, d64[c]))][:K], d64, tol)
        check(r.stats.original_calls == APPROX_DIMS + SHARDS * REFINE,
              "sharded approximate original_calls must be dims + shards x refine")
        recall.append(len(np.intersect1d(r.ids, host_select(d64[None, :], None, K)[0])) / K)
    emit(phase="sharded", metric=run["metric"], task="approx_knn_batch", checked=len(recall),
         recall_at_10=float(np.mean(recall)), near_tie_differences=swaps)


def sharded_kernel_rows(torch, ops, ref, rec, data_np, queries_np, log) -> list:
    """The sharded phase's kernel rows, each timed on the rows its class
    scans: the device filter's K3 class on the JSD index's 1M-row flat
    table, every other class on its shard 0 (250,000 rows; raw rows for the
    build and compaction classes from the corpus).  Also the device filter
    itself at the 100th-neighbour range batch: K3 with the K1 completion
    against its plain version (``selection="sort"``: K1 and a stable sort),
    bit-equal, each timed, and the completion alone."""
    from repro_torch.search import distributed

    run = next(r for r in rec["runs"] if r["metric"] == "jensen_shannon")
    index = run["index"]
    table, _, rows, _ = index._flat_state()
    seg0 = index._shards[0]
    flat = SimpleNamespace(_inner=SimpleNamespace(_kernel_table=lambda: table, data=rows,
                                                  query_apex_batch=seg0._inner.query_apex_batch))
    hist = rec["hist"]
    shard_hist = {name: [e for e in by if not (name == "apex_threshold" and e[0] == FILTER_CLASS)]
                  for name, by in hist.items()}
    flat_hist = {"apex_threshold": [e for e in hist["apex_threshold"] if e[0] == FILTER_CLASS]}
    corpus = torch.as_tensor(data_np, device=DEVICE)
    out = kernel_rows(torch, ops, ShapeInputs(torch, ops, ref, seg0, queries_np, log, corpus), shard_hist, "sharded")
    out += kernel_rows(torch, ops, ShapeInputs(torch, ops, ref, flat, queries_np, log), flat_hist, "sharded",
                       must=[("apex_threshold", FILTER_CLASS)])
    # the device filter at the 100th-neighbour batch's bands
    t = next(spec.threshold for task, spec, _, _ in run["tasks"] if task == "range100_batch")
    qs = queries_np[:Q]
    apexes = index._projector.project_distances(index._block_qpd(qs)[0])
    eps_eff = index._eps + index._fp32_slack(index._flat_state()[3], apexes, t) / t
    ap32 = apexes.float().contiguous()
    t_hi = torch.full((Q,), t * (1 + eps_eff), dtype=torch.float32, device=DEVICE)
    t_lo = torch.full((Q,), t * (1 - eps_eff), dtype=torch.float32, device=DEVICE)
    placed = index._device_table(table)
    topk = index._device_filter_fn()
    plain = distributed.build_distributed_filter(index._mesh, max_candidates=MAX_CAND, selection="sort")
    got, want = topk(placed, ap32, t_hi, t_lo), plain(placed, ap32, t_hi, t_lo)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "the device filter's K3 slots differ from its plain version")
    over = torch.nonzero((got[0][:, 1] + got[0][:, 2]) > MAX_CAND).flatten()
    completion = {}
    if over.numel():
        local = placed[0][0]
        completion = dict(completion_queries=int(over.numel()), completion_ms=time_ms(
            torch, lambda: distributed._accepted(local, ap32[over], t_hi[over], t_lo[over]), reps=5))
    emit(phase="sharded", metric="jensen_shannon", task="device_filter", rows=int(table.shape[0]), queries=Q,
         slots=MAX_CAND, ms=time_ms(torch, lambda: topk(placed, ap32, t_hi, t_lo), reps=5),
         plain_ms=time_ms(torch, lambda: plain(placed, ap32, t_hi, t_lo), reps=2), **completion)
    return out


#: the serving phase (the reference README's multi-tenant service over
#: histogram corpora): the CLI's shard_map engine at colors-1M (JSD, 4
#: batches of 64 queries), ``SearchService(max_batch=64, max_queue=256)``
#: per metric, the HTTP front end over three tenants, the CLI as a
#: subprocess
SERVE_CLI = ["--n-objects", str(N_ROWS), "--queries", str(Q), "--batches", "4", "--metric", "jensen_shannon",
             "--selectivity", "1e-4"]
SERVE_REQUESTS = 256
#: the front end: 192 round-robin k-NN requests (384 until a run took
#: 1,101.8 s with them at 31.9 s) at half the sequential QPS
#: of ``colors`` with a deadline of 4x each tenant's single-request wall; a
#: burst of 8 client threads x 64 concurrent ``mode="auto"`` requests to
#: ``colors`` (its queue bound 64, degradation at a quarter of it); 128 rows
#: upserted and 64 ids removed on the durable tenant
FRONTEND_REQUESTS, FRONTEND_RATE_SHARE, FRONTEND_DEADLINE_X = 192, 0.5, 4.0
BURST_THREADS, BURST_PER_THREAD, BURST_MAX_QUEUE = 8, 64, 64
SERVE_UPSERTS, SERVE_REMOVES = 128, 64
#: the durable tenant: the paper's colors size behind a WAL, 4 records past
#: its checkpoint
SERVE_DURABLE_ROWS = ENGINE_ROWS
SERVE_DURABLE_RECORDS = ("add", "remove", "upsert", "add")
#: the re-rank budget of a degraded request (``DEFAULT_DEGRADE_REFINE``)
DEGRADE_REFINE = 32
#: the CLI as a subprocess (the default arrival rate of its front end, one
#: request per second, would take a minute for these 64 requests)
SERVE_SUBPROCESS = ["--engine", "batch", "--workload", "frontend", "--n-objects", str(ENGINE_ROWS), "--queries", "32",
                    "--batches", "2", "--metric", "euclidean", "--arrival-rate", "200"]


def http_result(payload) -> SimpleNamespace:
    """An HTTP k-NN answer in the shape the checks read."""
    return SimpleNamespace(ids=np.asarray(payload["ids"], dtype=np.int64),
                           distances=np.asarray(payload["distances"], dtype=np.float64),
                           stats=SimpleNamespace(**payload["stats"]), approx=payload["approx"])


def serving_cli(torch, report) -> dict:
    """Part 1: ``repro_torch.launch.serve.main`` in-process on the 1 x 1 grid
    (K5 pivot distances, K4 projection, K3 (64, 256, 20) per batch)."""
    from repro_torch.launch import serve as serve_cli

    rec, wall = timed(torch, lambda: serve_cli.main(SERVE_CLI))
    report(task="cli_shard_map", wall_s=wall, queries=len(rec["answers"]), threshold=rec["threshold"],
           ms_per_query=rec["ms_per_query"], rechecks=rec["rechecks"], results=rec["results"],
           overflowing_queries=rec["overflowing"])
    return rec


def serving_service(torch, api, service_mod, indexes, queries_np, report) -> dict:
    """Part 2: per metric 256 exact k=10 requests through
    ``run_poisson_open_loop`` at 4x the measured sequential single-request
    QPS (the reference CLI's rule), every result equal to a direct
    ``index.query`` under the same plan."""
    spec = api.Query.knn(K)
    qs = queries_np[:SERVE_REQUESTS]
    out = {}
    for metric, index in indexes.items():
        index.query(qs[0], spec)
        (_, seq_s) = timed(torch, lambda: [index.query(q, spec) for q in qs[:32]])
        rate = 4.0 * 32 / seq_s
        with service_mod.SearchService(index, max_batch=64, max_queue=256) as svc:
            svc.warmup(spec, qs[0])
            results, wall = timed(torch, lambda: service_mod.run_poisson_open_loop(
                svc, qs, spec, arrival_rate=rate, seed=7))
            est = svc.estimated_wait_s()
            st = svc.stats()
        # ids and distances: the cost counts of the f32 kernel path hang on
        # the block's own slack, so a query counts alike only in equal blocks
        for qi, (r, w) in enumerate(zip(results, index.query(qs, spec, plan=index.plan(spec)))):
            check(np.array_equal(r.ids, w.ids) and np.array_equal(r.distances, w.distances),
                  f"serving service {metric} q{qi}: the served answer differs from a direct index.query")
        report(task="service_knn", metric=metric, requests=len(qs), arrival_rate=rate, sequential_qps=32 / seq_s,
               wall_ms=wall * 1e3, latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
               mean_batch_occupancy=st["mean_batch_occupancy"], n_batches=st["n_batches"],
               estimated_wait_s=est, rejected=st["rejected"], ewma_batch_ms=st["ewma_batch_ms"])
        out[metric] = (qs[:8], results[:8])
    return out


def durable_tenant_dir(torch, api, filter_mod, data_np, wal, seed):
    """The durable tenant's directory: ``SERVE_DURABLE_ROWS`` JSD rows with
    attributes, then the records of ``SERVE_DURABLE_RECORDS`` past its
    checkpoint, closed.  Returns the oracle of its rows."""
    n = SERVE_DURABLE_ROWS
    attrs = make_attributes(n, seed)
    store = filter_mod.AttributeStore(ATTR_SCHEMA)
    store.put(np.arange(n), attrs)
    live = api.build_index(data_np[:n], "jensen_shannon", n_pivots=N_PIVOTS, seed=SEED % 1000, durable=True,
                           wal_dir=str(wal), checkpoint_every=None, attributes=store, device=DEVICE)
    oracle = Oracle(torch, torch.as_tensor(data_np[:n], device=DEVICE), np.arange(n), attrs)
    pool = data_np[n:n + len(SERVE_DURABLE_RECORDS) * DURABLE_RECORD]
    pool_attrs = make_attributes(len(pool), seed + 61)
    rng = np.random.default_rng(seed + 71)
    cursor = 0
    for op in SERVE_DURABLE_RECORDS:
        cursor = durable_record(live, oracle, pool, pool_attrs, cursor, op, rng)
    live.flush()
    live.close()
    return oracle


def round_robin(client, error_cls, names, queries_np, rate, deadline_ms) -> dict:
    """``FRONTEND_REQUESTS`` k-NN requests over the tenants in turn from one
    open-loop client (exponential gaps at ``rate``), each with its tenant's
    deadline; per tenant the served, shed and expired counts, the served
    latencies and the first 8 served (query, answer) pairs."""
    per = {name: dict(sent=0, served=0, shed=0, expired=0, latency_s=[], answers=[]) for name in names}
    gaps = np.random.default_rng(7).exponential(1.0 / rate, size=FRONTEND_REQUESTS)
    t_next = time.perf_counter()
    for i in range(FRONTEND_REQUESTS):
        t_next += gaps[i]
        delay = t_next - time.perf_counter()
        if delay > 0.004:
            time.sleep(delay)
        name, q = names[i % len(names)], queries_np[i % len(queries_np)]
        rec = per[name]
        rec["sent"] += 1
        t0 = time.perf_counter()
        try:
            got = client.query(name, q, k=K, deadline_ms=deadline_ms[name])
        except error_cls as e:
            check(e.status in (429, 504), f"round robin {name}: HTTP {e.status} {e.body}")
            rec["shed" if e.status == 429 else "expired"] += 1
            continue
        rec["latency_s"].append(time.perf_counter() - t0)
        rec["served"] += 1
        if len(rec["answers"]) < 8:
            rec["answers"].append((q, http_result(got)))
    return per


def burst(client, error_cls, queries_np) -> dict:
    """``BURST_THREADS`` client threads each sending ``BURST_PER_THREAD``
    concurrent ``mode="auto"`` k-NN requests to ``colors`` at once."""
    from concurrent.futures import ThreadPoolExecutor

    start = threading.Barrier(BURST_THREADS)

    def one(i):
        q = queries_np[i % len(queries_np)]
        t0 = time.perf_counter()
        try:
            return q, client.query("colors", q, k=K), None, time.perf_counter() - t0
        except error_cls as e:
            check(e.status in (429, 504), f"burst: HTTP {e.status} {e.body}")
            return q, None, e, time.perf_counter() - t0

    def sender(t):
        start.wait()
        with ThreadPoolExecutor(BURST_PER_THREAD) as pool:
            return list(pool.map(one, range(t * BURST_PER_THREAD, (t + 1) * BURST_PER_THREAD)))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(BURST_THREADS) as senders:
        calls = [c for part in senders.map(sender, range(BURST_THREADS)) for c in part]
    wall = time.perf_counter() - t0
    served = [(q, http_result(p), s) for q, p, e, s in calls if p is not None]
    return dict(sent=len(calls), wall_s=wall, served=len(served),
                shed=sum(1 for _, _, e, _ in calls if e is not None and e.status == 429),
                expired=sum(1 for _, _, e, _ in calls if e is not None and e.status == 504),
                exact=[(q, r) for q, r, _ in served if r.approx is None],
                degraded=[(q, r) for q, r, _ in served if r.approx is not None],
                latency_s=[s for _, _, s in served])


def serving_frontend(torch, api, filter_mod, data_np, queries_np, euclid, seed, report) -> dict:
    """Part 3: ``IndexRegistry(max_concurrent_batches=4, max_batch=64,
    max_queue=256)`` behind the HTTP front end with three tenants:
    ``colors`` (the 1M-row euclidean exact index, its queue bound 64),
    ``colors_half`` (its first 500,000 rows under seed-1 pivots, the
    reference's ``data[: len // (t + 1)]`` rule) and ``colors_durable``
    (registered by ``path=``: a 112,682-row JSD durable directory under
    build/serving_smoke/ with 4 WAL records past its checkpoint, recovered
    through ``open_durable``).  Round-robin traffic with deadlines, a burst
    that sheds and degrades, an HTTP upsert and remove on the durable
    tenant, then ``registry.close()`` and a re-add by path that answers as
    before.  The directory is removed at the end, on failure too."""
    from repro_torch.serve import Frontend, FrontendClient, FrontendError, IndexRegistry

    Query = api.Query
    root = Path(__file__).resolve().parent / "build" / "serving_smoke"
    root.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=root))
    wal = work / "colors_durable"
    names = ["colors", "colors_half", "colors_durable"]
    try:
        oracle, wall = timed(torch, lambda: durable_tenant_dir(torch, api, filter_mod, data_np, wal, seed))
        report(task="durable_tenant_dir", rows=SERVE_DURABLE_ROWS, records=len(SERVE_DURABLE_RECORDS), wall_s=wall,
               bytes=dir_bytes(wal))
        half, wall = timed(torch, lambda: api.build_index(data_np[: N_ROWS // 2], "euclidean", n_pivots=N_PIVOTS,
                                                          seed=1, device=DEVICE))
        report(task="build_colors_half", rows=N_ROWS // 2, wall_s=wall)
        registry = IndexRegistry(max_concurrent_batches=4, max_batch=64, max_queue=256, device=DEVICE)
        registry.add("colors", index=euclid, max_queue=BURST_MAX_QUEUE)
        registry.add("colors_half", index=half)
        tenant, wall = timed(torch, lambda: registry.add("colors_durable", path=str(wal)))
        check(tenant.index.kind == "durable" and tenant.index.stats()["n_objects"] == len(oracle.live_ids()),
              "the durable tenant must recover its checkpoint and the WAL records past it")
        report(task="add_by_path", tenant="colors_durable", wall_s=wall, n_objects=tenant.index.stats()["n_objects"])
        spec = Query.knn(K)
        for name in names:
            registry.tenant(name).warmup(spec, queries_np[0])
        out = dict(oracle=oracle, half=half, tenants=names)
        with Frontend(registry, port=0) as fe:
            client = FrontendClient(*fe.address)
            single = {}
            for name in names:
                walls = []
                for q in queries_np[:8]:
                    t0 = time.perf_counter()
                    client.query(name, q, k=K)
                    walls.append(time.perf_counter() - t0)
                single[name] = float(np.median(walls))
            for name in names:
                got = client.query(name, queries_np[8], k=K)
                # the JSON body decodes to float64: the direct call takes the same vector
                want = registry.tenant(name).index.query(np.asarray(queries_np[8], np.float64), spec)
                check(got["ids"] == [int(i) for i in want.ids] and got["distances"] == [float(d) for d in want.distances],
                      f"tenant {name}: the HTTP answer differs from a direct index.query")
            rate = FRONTEND_RATE_SHARE / single["colors"]
            deadline_ms = {name: FRONTEND_DEADLINE_X * single[name] * 1e3 for name in names}
            out["snap"] = oracle.snapshot()
            rr, wall = timed(torch, lambda: round_robin(client, FrontendError, names, queries_np, rate, deadline_ms))
            for name, r in rr.items():
                check(r["served"] + r["shed"] + r["expired"] == r["sent"], f"round robin {name}: counts do not add up")
                check(len(r["answers"]) >= 8, f"round robin {name}: fewer than 8 served answers to check")
                report(task="round_robin", tenant=name, sent=r["sent"], served=r["served"], shed=r["shed"],
                       expired=r["expired"], single_request_ms=single[name] * 1e3, deadline_ms=deadline_ms[name],
                       **({} if not r["latency_s"] else percentiles_ms(r["latency_s"])))
            report(task="round_robin", arrival_rate=rate, wall_s=wall, requests=FRONTEND_REQUESTS)
            out["round_robin"] = rr
            b = burst(client, FrontendError, queries_np)
            check(b["served"] + b["shed"] + b["expired"] == b["sent"], "burst: counts do not add up")
            check(b["shed"] > 0 and len(b["degraded"]) > 0, "the burst must shed some requests and degrade some")
            report(task="burst", tenant="colors", sent=b["sent"], served=b["served"], shed=b["shed"],
                   expired=b["expired"], degraded=len(b["degraded"]), wall_s=b["wall_s"],
                   **percentiles_ms(b["latency_s"]))
            out["burst"] = b
            # writes on the durable tenant, visible in the next query
            fresh = queries_np[SERVE_REQUESTS - SERVE_UPSERTS:SERVE_REQUESTS]
            fresh_attrs = make_attributes(SERVE_UPSERTS, seed + 81)
            t0 = time.perf_counter()
            up = client.upsert("colors_durable", fresh, attrs=fresh_attrs)
            up_ms = (time.perf_counter() - t0) * 1e3
            new_ids = np.asarray(up["ids"], dtype=np.int64)
            oracle.add(new_ids, fresh, fresh_attrs)
            victims = np.asarray(client.query("colors_durable", queries_np[5], k=SERVE_REMOVES)["ids"])
            t0 = time.perf_counter()
            rm = client.remove_rows("colors_durable", victims)
            rm_ms = (time.perf_counter() - t0) * 1e3
            oracle.remove(victims)
            check(rm["n_objects"] == len(oracle.live_ids()), "the remove must leave the oracle's live count")
            after = [http_result(client.query("colors_durable", q, k=K)) for q in queries_np[:8]]
            check(not np.isin(after[5].ids, victims).any(), "a removed id is still answered")
            mine = http_result(client.query("colors_durable", fresh[0], k=K))
            check(int(mine.ids[0]) == int(new_ids[0]) and mine.distances[0] <= 1e-6,
                  "an upserted row must be its own nearest neighbour in the next query")
            report(task="writes", tenant="colors_durable", upserted=len(new_ids), removed=len(victims),
                   upsert_ms=up_ms, remove_ms=rm_ms, n_objects=rm["n_objects"], wal_synced=rm["wal_synced"])
            out["after_snap"] = oracle.snapshot()
            out["after"] = (queries_np[:8], after)
            stats = client.stats()
        for name in names:
            ts = stats["tenants"][name]
            report(task="tenant_stats", tenant=name, requests=ts["service"]["n_requests"],
                   batches=ts["service"]["n_batches"], queue_depth=ts["service"]["queue_depth"],
                   latency_p50_ms=ts["service"]["latency_p50_ms"], latency_p99_ms=ts["service"]["latency_p99_ms"],
                   admission=ts["admission"], telemetry=ts["telemetry"])
        source = euclid.plan(Query.knn(K)).explain()["calibration"]["source"]
        check(source == "telemetry_ewma", f"after the traffic an auto spec on colors must be calibrated; got {source}")
        registry.close()
        tenant.index.close()
        euclid.telemetry = None
        # a new registry takes the tenant again by path and answers as before
        again = IndexRegistry(max_concurrent_batches=4, max_batch=64, max_queue=256, device=DEVICE)
        t_again, wall = timed(torch, lambda: again.add("colors_durable", path=str(wal)))
        with Frontend(again, port=0) as fe:
            client = FrontendClient(*fe.address)
            redo = [http_result(client.query("colors_durable", q, k=K)) for q in queries_np[:8]]
        for qi, (g, w) in enumerate(zip(redo, after)):
            check(np.array_equal(g.ids, w.ids) and np.array_equal(g.distances, w.distances)
                  and vars(g.stats) == vars(w.stats), f"the durable tenant added again by path answers otherwise: q{qi}")
        report(task="re_add_by_path", tenant="colors_durable", wall_s=wall,
               n_objects=t_again.index.stats()["n_objects"])
        again.close()
        t_again.index.close()
        return out
    finally:
        euclid.telemetry = None
        shutil.rmtree(work, ignore_errors=True)


def serving_subprocess(report):
    """Part 4: ``python -m repro_torch.launch.serve`` with the front-end
    workload as a child process, which must exit 0."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *SERVE_SUBPROCESS], capture_output=True,
                         text=True, env=env, cwd=str(root), timeout=600)
    check(out.returncode == 0, f"the serving CLI exited {out.returncode}: {out.stderr[-2000:]}")
    report(task="cli_subprocess", argv=SERVE_SUBPROCESS, wall_s=time.perf_counter() - t0,
           lines=[line for line in out.stdout.splitlines() if line.startswith("[serve] frontend")])


def phase_serving(ops, torch, api, filter_mod, service_mod, data_np, queries_np, indexes, seed) -> dict:
    """The serving phase, the launch counts set to 0 before and read after
    (``launch_phase="serving"``; each kernel must have > 0): the CLI's
    shard_map engine in-process, ``SearchService`` per metric on the exact
    1M-row indexes, the multi-tenant HTTP front end, then the CLI as a
    subprocess.  Returns what ``verify_serving`` checks."""
    report = lambda **f: emit(phase="serving", **f)  # noqa: E731
    t_phase = time.perf_counter()
    ops.reset_launches()
    rec = dict(cli=serving_cli(torch, report))
    rec["service"] = serving_service(torch, api, service_mod, indexes, queries_np, report)
    rec["frontend"] = serving_frontend(torch, api, filter_mod, data_np, queries_np, indexes["euclidean"], seed, report)
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        check(launches[name] > 0 or name in ROUTE_ONLY, f"{kid} ({name}) was not launched by the serving phase")
        emit(phase="launch_shapes", launch_phase="serving", kernel=kid, name=name, launches=launches[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    check(any(tuple(cls) == FILTER_CLASS for cls, _, _ in hist["apex_threshold"]),
          "the CLI's serve step must launch K3 at (64, 256, 20)")
    serving_subprocess(report)
    report(task="phase", wall_s=time.perf_counter() - t_phase)
    return dict(rec, hist=hist, indexes=indexes)


def check_oracle_knn(torch, ref, m, oracle, snap, pairs, what) -> int:
    """Exact k-NN answers (query, result) against an f64 brute force over the
    oracle's live rows ``snap`` (JSD plain, not K5); returns the near-tie
    swaps."""
    ids = oracle.slot_id[snap]
    rows = oracle.rows[torch.as_tensor(snap, device=oracle.rows.device)]
    brute = BruteForce(torch, ref, rows, m)
    D = brute_matrix(torch, brute, [q for q, _ in pairs])
    everyone = torch.arange(len(ids), device=D.device)
    want = expect_knn(torch, D, everyone, K)
    allowed = torch.ones(len(ids), dtype=torch.bool, device=D.device)
    tol, swaps = refine_tol(torch, m.name, rows), 0
    for qi, (_, r) in enumerate(pairs):
        local = SimpleNamespace(ids=np.searchsorted(ids, r.ids), distances=r.distances)
        check(np.array_equal(ids[np.minimum(local.ids, len(ids) - 1)], r.ids), f"{what}: answered an id that is not live")
        swaps += check_exact(torch, D[qi], local, want[qi], allowed, None, tol, f"{what} q{qi}")
    return swaps


def check_brute_knn(torch, ref, m, data, pairs, what) -> int:
    """Exact k-NN answers against an f64 brute force over ``data``."""
    brute = BruteForce(torch, ref, data, m)
    tol, swaps = refine_tol(torch, m.name, data), 0
    for q, r in pairs:
        ids, d64 = brute.knn(q, K)
        swaps += agree_knn(r, ids, d64, tol)
    return swaps


def verify_degraded(torch, ops, ref, index, m, pairs) -> int:
    """Degraded answers from their own candidates, as ``verify_approx``: the
    k smallest (f64 distance, id) among the ``DEGRADE_REFINE`` rows a host
    lexsort of K1's own f32 truncated mid keys selects (query apexes
    projected by the plain versions), ``original_calls == dims + refine``."""
    inner = index._inner
    tab = inner._kernel_table()
    prefix = inner._prefix_projector(APPROX_DIMS)
    brute = BruteForce(torch, ref, inner.data, m)
    tol, swaps = refine_tol(torch, m.name, inner.data), 0
    for lo in range(0, len(pairs), 16):
        chunk = pairs[lo:lo + 16]
        qpd = brute.cross(np.stack([q for q, _ in chunk]), prefix.pivots_t)
        apexes = ref.apex_project_ref(qpd, prefix._Linv_t, prefix._sq_norms_t)
        L, U = (t.cpu().numpy() for t in ops.apex_bounds_batch(tab, apexes.float(), dims=APPROX_DIMS))
        for qi, (q, r) in enumerate(chunk):
            check(r.approx == {"dims": APPROX_DIMS, "refine": DEGRADE_REFINE}, "a degraded answer must carry its config")
            d64 = brute.dists(q).cpu().numpy()
            cand = host_select(np.float32(0.5) * (L[qi:qi + 1] + U[qi:qi + 1]), None, DEGRADE_REFINE)[0]
            check(bool(np.isin(r.ids, cand).all()), "a degraded answer came from outside its own candidates")
            swaps += agree_knn(r, cand[np.lexsort((cand, d64[cand]))][:K], d64, tol)
            check(r.stats.original_calls == APPROX_DIMS + DEGRADE_REFINE, "degraded original_calls must be dims + refine")
    return swaps


def verify_serving(torch, ops, ref, metrics_mod, rec):
    """After the launch counts are read: the CLI's answers against an f64
    brute force over its corpus (a query whose candidates fit the 256 slots
    answers exactly; an overflowing one a subset; rows inside the
    t(1 +- eps) +- 1e-9 band are counted, not failed); 8 service answers per
    metric, 8 round-robin answers per tenant (the durable tenant's over the
    oracle's live rows), 8 burst exact answers and the answers after the
    writes against the brute force; every degraded answer from its own
    candidates."""
    from repro_torch.data import load_or_generate_colors

    cli = rec["cli"]
    X = load_or_generate_colors(n=N_ROWS + len(cli["answers"]), seed=99)
    jsd, eu = metrics_mod.get_metric("jensen_shannon"), metrics_mod.get_metric("euclidean")
    brute = BruteForce(torch, ref, torch.as_tensor(X[:N_ROWS], device=DEVICE), jsd)
    t, eps = cli["threshold"], 1e-5
    lo, hi = t * (1 - eps) - 1e-9, t * (1 + eps) + 1e-9
    over = (cli["hist"][:, 1] + cli["hist"][:, 2]) > cli["max_candidates"]
    band_rows = 0
    for qi, ans in enumerate(cli["answers"]):
        d = brute.dists(X[N_ROWS + qi]).cpu().numpy()
        band = (d > lo) & (d <= hi)
        truth = np.flatnonzero(d <= t)
        wrong = np.setdiff1d(ans, truth) if over[qi] else np.setxor1d(ans, truth)
        check(bool(band[wrong].all()), f"serving CLI q{qi}: the answer differs from the brute force outside the band")
        band_rows += int(band[wrong].sum())
    emit(phase="serving", task="cli_shard_map_checked", queries=len(cli["answers"]), overflowing_queries=int(over.sum()),
         band_differences=band_rows)
    del brute, X
    torch.cuda.empty_cache()
    swaps = 0
    for metric, (qs, results) in rec["service"].items():
        index = rec["indexes"][metric]
        swaps += check_brute_knn(torch, ref, metrics_mod.get_metric(metric), index._inner.data, list(zip(qs, results)),
                                 f"serving service {metric}")
    fe = rec["frontend"]
    colors = rec["indexes"]["euclidean"]
    swaps += check_brute_knn(torch, ref, eu, colors._inner.data, fe["round_robin"]["colors"]["answers"], "colors")
    swaps += check_brute_knn(torch, ref, eu, fe["half"]._inner.data, fe["round_robin"]["colors_half"]["answers"],
                             "colors_half")
    swaps += check_oracle_knn(torch, ref, jsd, fe["oracle"], fe["snap"], fe["round_robin"]["colors_durable"]["answers"],
                              "colors_durable")
    swaps += check_oracle_knn(torch, ref, jsd, fe["oracle"], fe["after_snap"], list(zip(*fe["after"])),
                              "colors_durable after the writes")
    swaps += check_brute_knn(torch, ref, eu, colors._inner.data, fe["burst"]["exact"][:8], "burst exact")
    degraded = fe["burst"]["degraded"]
    swaps += verify_degraded(torch, ops, ref, colors, eu, degraded)
    emit(phase="serving", task="checked", service_answers=8 * len(rec["service"]), tenant_answers=8 * 3 + 8,
         burst_exact=min(8, len(fe["burst"]["exact"])), degraded=len(degraded), near_tie_differences=swaps)


def serving_kernel_rows(torch, ops, ref, rec, queries_np, log) -> list:
    """The serving phase's kernel rows, timed on the 1M-row jensen_shannon
    exact index (its table has the serve step's shape), the serve step's K3
    class (64, 256, 20) and K2's and K3's padded bucket of 8 queries always
    among them."""
    inputs = ShapeInputs(torch, ops, ref, rec["indexes"]["jensen_shannon"], queries_np, log)
    must = [("apex_threshold", FILTER_CLASS), ("apex_topk", (8, K, "upb", N_PIVOTS)),
            ("apex_threshold", (8, 512, N_PIVOTS))]
    return kernel_rows(torch, ops, inputs, rec["hist"], "serving", must=must)


def kernel_rows(torch, ops, inputs, hist, launch_phase=None, selection_inputs=None, must=()) -> list:
    """The kernels line's rows of one launch histogram: each (kernel, shape
    class) of ``rows_to_time(hist, must)`` timed on ``inputs`` (held to its
    plain version there), with that histogram's launches and share, and for
    K1, K3 and K4 the previous design timed beside it.  ``launch_phase``
    tags the rows of a phase other than the main path's;
    ``selection_inputs`` (default ``inputs``) are the operands of K2's and
    K3's rows narrower than the kernels' 4,096 cap, where a phase launches
    those on another table (the online phase's delta)."""
    tag = {} if launch_phase is None else {"launch_phase": launch_phase}
    rows = []
    for pair in rows_to_time(hist, must):
        narrow = pair[0] in ("apex_topk", "apex_threshold") and pair[1][1] < ops.MAX_SELECT_WIDTH
        inp = selection_inputs if selection_inputs and narrow else inputs
        N_ = inp.tab.shape[0]
        (name, m), = time_shapes(torch, ops, inp.ref, inp, [pair], **tag)
        n, share = next((n, share) for cls, n, share in hist[name] if list(cls) == m["shape"])
        row = kernel_row(name, m, n, share)
        wide = pair[0] in ("apex_topk", "apex_threshold") and pair[1][1] > ops.MAX_SELECT_WIDTH
        if name in PREVIOUS_DESIGN and not wide:   # the global-memory plan had no earlier design
            label, plan_of = PREVIOUS_DESIGN[name]
            cls = tuple(m["shape"])
            prev = inp.time_row(name, cls, plan_of(ops, cls, N_, inp.sms))
            emit(phase="kernel_shape", kernel=KERNEL_INFO[name][0], name=name, design=label, **tag, **prev)
            row.update({key: m[key] for key in ("pass_b_ms", "pass_b_device_ms", "pass_b_mean_count",
                                                "launch_floor_ms") if key in m})
            row.update({f"previous_design_{key}": prev[key] for key in ("pass_b_ms", "device_ms") if key in prev})
            row.update(previous_design=label, previous_design_ms=prev["ms"],
                       plan=current_plan(ops, name, cls, N_, inp.sms))
        elif name == "apex_threshold":
            row["plan"] = current_plan(ops, name, tuple(m["shape"]), N_, inp.sms)
        rows.append(dict(row, table_rows=N_, **tag))
    return rows


def filtered_kernel_rows(torch, ops, ref, rec, queries_np, log) -> list:
    """The filtered phase's kernel rows, timed on the 1M-row jensen_shannon
    exact index with the most common shop's row mask (the pushdown mask of
    the phase's K2 and K3 masked classes)."""
    run = next(r for r in rec["runs"] if r["metric"] == "jensen_shannon")
    inner = run["index"]._inner
    mask = torch.as_tensor(rec["tests"]["shop_top"][1](rec["attrs"]).astype(np.uint8), device=inner.data.device)
    inputs = ShapeInputs(torch, ops, ref, run["index"], queries_np, log, mask=mask)
    must = [("apex_topk", (Q, K, "upb", N_PIVOTS, "masked")), ("apex_threshold", (Q, 512, N_PIVOTS, "masked"))]
    return kernel_rows(torch, ops, inputs, rec["hist"], "filtered", must=must)


def online_kernel_rows(torch, ops, ref, rec, queries_np, log) -> list:
    """The online phase's kernel rows, K4 at the add-burst class among them:
    K2 and K3 narrower than the 4,096 cap timed on the delta segment of the
    jensen_shannon online index (where the phase launches them: the base's
    k-NN selections, widened past the cap by its tombstones, overflow to
    K3's wide plan), with the delta's slots of the filtered batch's predicate as the
    row mask; the others (the 4,096-wide range selections mostly on the
    base) on its 1M-row base."""
    run = next(r for r in rec["runs"] if r["metric"] == "jensen_shannon")
    index = run["index"]
    delta = index._materialize()
    sides = index._sides()
    masks, _ = index._side_masks(sides, index.attributes.match(rec["pred"]))
    slots = masks[[s.seg for s in sides].index(delta)]
    mask = delta._inner._device_mask(delta._inner._mask_of(slots))
    return kernel_rows(torch, ops, ShapeInputs(torch, ops, ref, index._base, queries_np, log), rec["hist"], "online",
                       selection_inputs=ShapeInputs(torch, ops, ref, delta, queries_np, log, mask=mask),
                       must=[("apex_project", (ONLINE_ADD + ONLINE_UPSERT, N_PIVOTS, "float64"))])


def kernel_row(name, m, launches, share) -> dict:
    kid, source, replaces = KERNEL_INFO[name]
    row = {
        "name": f"{kid} {name}", "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound"][0], "bound_by": m["bound"][1], "library_ms": m["library_ms"],
        "shape": m["shape"], "launch_share": share, "device_ms": m["device_ms"],
    }
    if name in NO_LIBRARY:
        row["library_none_because"] = NO_LIBRARY[name]
    return row


# -- the models phase (ROADMAP item 11a) --------------------------------------

#: seed of every model phase's parameters and token streams
MODEL_SEED = 2026
#: card against CPU in f32 with no TF32 (rtol = atol): the smoke configs and
#: the RecSys / GCN cells; GCN and embedding sums add with atomics on the card
MODEL_TOL = 1e-4
#: bf16 logits of two paths on the card: max |a - b| over max |b|; bf16 keeps
#: 8 mantissa bits (eps 2^-8 = 0.0039), compounded over the layers
BF16_REL_TOL = 0.05
LM_SMOKE_ARCHS = ("minitron-4b", "yi-6b", "qwen2-1.5b", "arctic-480b", "mixtral-8x7b")
REC_ARCHS = ("fm", "xdeepfm", "mind", "sasrec")
#: full-size cells: qwen2-1.5b (all 28 layers) at B = 4, S = 4096 chunked and
#: 2048 naive, 32 decode steps; mixtral-8x7b at full width cut to 2 layers,
#: a prefill past its 4096 window and a drop-free prefill below it that
#: decodes across the ring's wrap
MODEL_SIZES = SimpleNamespace(
    qwen_batch=4, qwen_seq=4096, qwen_seq_naive=2048, qwen_decode=32,
    mixtral_layers=2, mixtral_seq=4608, mixtral_seq_below=4088, mixtral_wrap_steps=16, mixtral_decode=8,
    rec_batch=512, n_candidates=1_000_000,
)


def card_vs_cpu(torch, got, want, what, tol=MODEL_TOL) -> float:
    """Max |card - CPU| after a hard allclose(rtol = atol = tol)."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} against {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values on the card")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    check(torch.allclose(g, w, rtol=tol, atol=tol), f"{what}: card against CPU beyond {tol} (max abs {err})")
    return err


def bf16_rel(torch, got, want, what) -> float:
    """max |got - want| / max |want| of two bf16 paths, held to BF16_REL_TOL."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()), f"{what}: non-finite logits")
    err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    check(err <= BF16_REL_TOL, f"{what}: relative error {err} > {BF16_REL_TOL}")
    return err


def timed_call(torch, fn):
    """(result, seconds) of one call, synchronised on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_busy(torch, fn, reps):
    """Per call of ``fn``, from ``torch.profiler``: the summed device time
    of the kernels it launches, their number, and the number of top-level
    PyTorch ops the host issues for them."""
    ms = kernels = host_ops = 0
    for e in profiled_events(torch, fn, reps):
        if e.device_type.name == "CUDA":
            ms += e.time_range.elapsed_us() / 1e3
            kernels += 1
        elif e.name.startswith("aten::") and e.cpu_parent is None:
            host_ops += 1
    return dict(ms=ms / reps, kernels=kernels / reps, host_ops=host_ops / reps)


def drop_free(cfg):
    """The MoE capacity at which no token drops (capacity_factor 32, the
    decode oracle's of tests/test_models_smoke.py); dense configs as they are."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=32.0))


def on_both(torch, params_cpu):
    """The CPU parameters and a copy of them on the card."""
    import copy

    return {"cpu": params_cpu, "card": copy.deepcopy(params_cpu).to(DEVICE)}


def models_smoke_lm(torch, mods) -> list:
    """Each LM arch's smoke config, one seed's parameters on the CPU and the
    card: prefill logits and one decode step (drop-free MoE), and for the
    windowed arch a decode from an empty ring past its wrap, teacher-forced
    with the CPU's greedy tokens."""
    tf = mods.tf
    rows = []
    for arch in LM_SMOKE_ARCHS:
        cfg = drop_free(mods.get_arch(arch).smoke_cfg)
        params = on_both(torch, tf.init_params(cfg, torch.Generator().manual_seed(MODEL_SEED), device="cpu"))
        toks, _ = mods.token_stream(2, 13, cfg.vocab, seed=3)
        out = {}
        for side, d in (("cpu", "cpu"), ("card", "cuda")):
            t = torch.as_tensor(toks, device=d)
            logits, cache = tf.prefill(params[side], cfg, t[:, :12])
            cache = tf.extend_cache(cfg, cache, 16)
            dec, _ = tf.decode_step(params[side], cfg, t[:, 12], torch.full((2,), 12, dtype=torch.int32, device=d),
                                    cache)
            out[side] = (logits, dec)
        row = dict(arch=arch, prefill_err=card_vs_cpu(torch, out["card"][0], out["cpu"][0], f"{arch} prefill"),
                   decode_err=card_vs_cpu(torch, out["card"][1], out["cpu"][1], f"{arch} decode"))
        if cfg.window is not None:
            caches = {"cpu": tf.init_cache(cfg, 2, cfg.window, device="cpu"),
                      "card": tf.init_cache(cfg, 2, cfg.window, device="cuda")}
            tok, err = np.zeros(2, np.int32), 0.0
            for pos in range(cfg.window + 5):
                logits = {}
                for side, d in (("cpu", "cpu"), ("card", "cuda")):
                    logits[side], caches[side] = tf.decode_step(
                        params[side], cfg, torch.as_tensor(tok, device=d),
                        torch.full((2,), pos, dtype=torch.int32, device=d), caches[side])
                err = max(err, card_vs_cpu(torch, logits["card"], logits["cpu"], f"{arch} ring decode at {pos}"))
                tok = logits["cpu"].argmax(-1).to(torch.int32).numpy()
            check(caches["card"]["k"].shape[2] == cfg.window, f"{arch}: the ring grew past the window")
            row.update(ring_steps=cfg.window + 5, ring_err=err)
        rows.append(row)
    return rows


def rec_batch(torch, mods, cfg, B, d, seed=0):
    """A serving batch: ``rec_train_batch`` without its labels / targets."""
    batch = rec_train_batch(torch, mods, cfg, B, d, seed)
    batch.pop("labels", None)
    batch.pop("targets", None)
    return batch


def rec_scores(torch, mods, cfg, params, batch, cand):
    """Serve scores (FM, xDeepFM), or the first user's retrieval scores over
    ``cand`` (MIND: max over interests; SASRec)."""
    _, fwd, _ = mods.recsys.get_model_fns(cfg)
    if cfg.interaction in ("fm-2way", "cin"):
        return fwd(params, cfg, batch)
    enc = fwd(params, cfg, batch["seqs"])
    return mods.recsys.score_candidates(params["items"], enc[0], cand)


def models_smoke_other(torch, mods) -> list:
    """RecSys serve and 100-candidate retrieval, the three GCN forwards,
    card against CPU on one seed's smoke parameters."""
    rows = []
    for arch in REC_ARCHS:
        cfg = mods.get_arch(arch).smoke_cfg
        init, _, _ = mods.recsys.get_model_fns(cfg)
        params = on_both(torch, init(cfg, torch.Generator().manual_seed(MODEL_SEED), device="cpu"))
        out = {}
        for side, d in (("cpu", "cpu"), ("card", "cuda")):
            out[side] = rec_scores(torch, mods, cfg, params[side], rec_batch(torch, mods, cfg, 8, d),
                                   torch.arange(1, 101, dtype=torch.int32, device=d))
        rows.append(dict(arch=arch, task="smoke_serve" if cfg.interaction in ("fm-2way", "cin") else "smoke_retrieval_100",
                         err=card_vs_cpu(torch, out["card"], out["cpu"], f"{arch} smoke")))
    cfg = mods.get_arch("gcn-cora").smoke_cfg
    params = on_both(torch, mods.gcn.init_params(cfg, torch.Generator().manual_seed(MODEL_SEED), device="cpu"))
    X, ei, _ = mods.random_graph(500, 4000, cfg.d_feat, cfg.n_classes, seed=1)
    layers = mods.NeighborSampler(ei, 500, seed=0).sample_batch(np.arange(32), [5, 3])
    mol = mods.molecule_batch(batch=8, n_nodes=12, n_edges=20, d_feat=cfg.d_feat)
    out = {}
    for side, d in (("cpu", "cpu"), ("card", "cuda")):
        p, T = params[side], (lambda a: torch.as_tensor(a, device=d))
        out[side] = (
            mods.gcn.forward_full(p, cfg, T(X), T(ei)),
            mods.gcn.forward_sampled(p, cfg, T(X[layers[0]]), [T(X[layers[1]]), T(X[layers[2]])]),
            mods.gcn.forward_molecule(p, cfg, T(mol["feats"]), T(mol["src"]), T(mol["dst"])),
        )
    for i, task in enumerate(("full", "sampled", "molecule")):
        rows.append(dict(arch="gcn-cora", task=f"smoke_{task}",
                         err=card_vs_cpu(torch, out["card"][i], out["cpu"][i], f"gcn-cora {task}")))
    return rows


def models_smoke_nsimplex(torch, mods) -> dict:
    """``nsimplex-colors``'s smoke config through ``build_serve_step`` on a
    one-position grid of the CPU and of the card (K4, K3) on the same f32
    inputs: equal histograms summing to the corpus, equal packed
    candidates, and no true result excluded unless its query overflows."""
    cfg = mods.get_arch("nsimplex-colors").smoke_cfg
    n = cfg.n_objects
    X = mods.colors_like(n=n + cfg.query_batch, seed=5)
    metric = mods.get_metric(cfg.metric)
    data, queries = torch.as_tensor(X[:n]), torch.as_tensor(X[n:])
    proj = mods.NSimplexProjector(mods.select_pivots(X[:n], cfg.n_pivots, seed=1), metric, device="cpu")
    table = proj.project_distances(proj.pivot_distances(data)).to(torch.float32)
    qd = proj.pivot_distances(queries).to(torch.float32)
    consts = [torch.as_tensor(a, dtype=torch.float32) for a in (proj.Linv, proj.sq_norms, proj.sigma)]
    D = metric.cross(queries.double(), data.double())
    t = float(np.quantile(D.numpy(), 1e-3))
    out = {}
    for side, d in (("cpu", torch.device("cpu")), ("card", torch.device("cuda"))):
        serve = mods.build_serve_step(mods.make_scaleout_mesh(devices=[d]), n_pivots=cfg.n_pivots,
                                      max_candidates=cfg.max_candidates)
        out[side] = [o.cpu() for o in serve(table.to(d), *[c.to(d) for c in consts], qd.to(d), t)]
    hist, idx, code = out["card"]
    check(bool((hist.sum(dim=1) == n).all()), "nsimplex-colors: a histogram does not sum to the corpus")
    check(torch.equal(hist, out["cpu"][0]), "nsimplex-colors: card histogram differs from the CPU's")
    overflow = 0
    for qi in range(cfg.query_batch):
        got = sorted((int(a), int(c)) for a, c in zip(idx[:, qi].ravel(), code[:, qi].ravel()) if a >= 0)
        want = sorted((int(a), int(c)) for a, c in zip(out["cpu"][1][:, qi].ravel(), out["cpu"][2][:, qi].ravel())
                      if a >= 0)
        check(got == want, f"nsimplex-colors: query {qi}'s packed candidates differ from the CPU's")
        over = int(hist[qi, 1] + hist[qi, 2]) > cfg.max_candidates
        overflow += over
        missing = set(np.where(D[qi].numpy() <= t)[0].tolist()) - {a for a, _ in got}
        check(not missing or over, f"nsimplex-colors: query {qi} excluded true results {sorted(missing)[:5]}")
    return dict(arch="nsimplex-colors", queries=cfg.query_batch, rows=n, threshold=t, overflowing=overflow)


def models_qwen(torch, mods) -> dict:
    """qwen2-1.5b at its full config (28 layers, bf16, tied head, QKV bias):
    chunked against naive prefill at ``qwen_seq_naive``, the timed chunked
    prefill at ``qwen_seq``, and ``qwen_decode`` greedy decode steps, the
    first held to the full forward's logits at that position."""
    import dataclasses

    tf = mods.tf
    cfg = mods.get_arch("qwen2-1.5b").model_cfg
    ccfg = dataclasses.replace(cfg, attn_impl="chunked")
    B, S, S_n = MODEL_SIZES.qwen_batch, MODEL_SIZES.qwen_seq, MODEL_SIZES.qwen_seq_naive
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(MODEL_SEED), device="cuda")
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    toks, _ = mods.token_stream(B, S + 1, cfg.vocab, seed=MODEL_SEED)
    tk = torch.as_tensor(toks, device="cuda")
    ln, naive_s = timed_call(torch, lambda: tf.prefill(params, cfg, tk[:, :S_n])[0])
    ln, naive_s = timed_call(torch, lambda: tf.prefill(params, cfg, tk[:, :S_n])[0])
    lc = tf.prefill(params, ccfg, tk[:, :S_n])[0]
    chunk_vs_naive = bf16_rel(torch, lc, ln, f"qwen2-1.5b chunked against naive prefill at S = {S_n}")
    del ln, lc
    tf.prefill(params, ccfg, tk[:, :S])
    (logits, cache), prefill_s = timed_call(torch, lambda: tf.prefill(params, ccfg, tk[:, :S]))
    check(bool(torch.isfinite(logits).all()), "qwen2-1.5b: non-finite prefill logits")
    cache = tf.extend_cache(ccfg, cache, S + MODEL_SIZES.qwen_decode)
    hidden, _ = tf.forward(params, ccfg, tk[:, :S + 1])
    want = tf.logits_fn(params, ccfg, hidden[:, -1:])[:, 0].float()
    del hidden
    tok, steps, decode_err = tk[:, S], [], None
    for i in range(MODEL_SIZES.qwen_decode):
        pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
        (dec, cache), s = timed_call(torch, lambda: tf.decode_step(params, ccfg, tok, pos, cache))
        steps.append(s)
        check(bool(torch.isfinite(dec).all()), f"qwen2-1.5b: non-finite decode logits at {S + i}")
        if i == 0:
            decode_err = bf16_rel(torch, dec, want, f"qwen2-1.5b decode against forward at position {S}")
        tok = dec.argmax(-1)
    step_s = float(np.median(steps))
    peak = torch.cuda.max_memory_allocated()
    # one decode step's and one chunked prefill's device time, kernels and
    # host ops (torch.profiler): where the device is idle, the host is issuing
    pos = torch.full((B,), S + MODEL_SIZES.qwen_decode - 1, dtype=torch.int32, device="cuda")
    decode_prof = device_busy(torch, lambda: tf.decode_step(params, ccfg, tok, pos, cache), reps=5)
    prefill_prof = device_busy(torch, lambda: tf.prefill(params, ccfg, tk[:, :S]), reps=1)
    del params, cache
    return dict(arch="qwen2-1.5b", layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
                param_bytes=n_bytes, batch=B, seq=S, prefill_chunked_ms=prefill_s * 1e3,
                prefill_tokens_per_s=B * S / prefill_s, seq_naive=S_n, prefill_naive_ms=naive_s * 1e3,
                prefill_naive_tokens_per_s=B * S_n / naive_s, chunked_vs_naive_rel=chunk_vs_naive,
                decode_steps=MODEL_SIZES.qwen_decode, decode_ms_per_step=step_s * 1e3, decode_ms_first=steps[0] * 1e3,
                decode_tokens_per_s=B / step_s, decode_vs_forward_rel=decode_err, max_memory_allocated=peak,
                decode_device_ms=decode_prof["ms"], decode_kernels_per_step=decode_prof["kernels"],
                decode_host_ops_per_step=decode_prof["host_ops"], prefill_chunked_device_ms=prefill_prof["ms"],
                prefill_chunked_kernels=prefill_prof["kernels"])


def models_mixtral(torch, mods) -> dict:
    """mixtral-8x7b at full width, depth cut to ``mixtral_layers``: chunked
    against naive prefill past the window (capacity factor as configured),
    decode after it; a drop-free prefill below the window whose first
    decode step is held to the forward and whose decode crosses the ring's
    wrap at ``window``."""
    import dataclasses

    tf = mods.tf
    cfg = dataclasses.replace(mods.get_arch("mixtral-8x7b").model_cfg, n_layers=MODEL_SIZES.mixtral_layers)
    ccfg = dataclasses.replace(cfg, attn_impl="chunked")
    W, S, S2 = cfg.window, MODEL_SIZES.mixtral_seq, MODEL_SIZES.mixtral_seq_below
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(MODEL_SEED), device="cuda")
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    toks, _ = mods.token_stream(1, S, cfg.vocab, seed=MODEL_SEED + 1)
    tk = torch.as_tensor(toks, device="cuda")
    (ln, _), naive_s = timed_call(torch, lambda: tf.prefill(params, cfg, tk))
    (lc, cache), chunked_s = timed_call(torch, lambda: tf.prefill(params, ccfg, tk))
    chunk_vs_naive = bf16_rel(torch, lc, ln, f"mixtral-8x7b chunked against naive prefill at S = {S}")
    # the MoE dispatch has no data-dependent shape: one layer's moe_ffn
    # at a decode step's and a prefill's token counts makes no host sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        for T in (1, S):
            mods.layers.moe_ffn(params["layers"][0]["moe"], torch.zeros((T, cfg.d_model), dtype=cfg.torch_dtype,
                                                                         device="cuda"), cfg.moe)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(cache["k"].shape[:3]) == (cfg.n_layers, 1, W), f"mixtral-8x7b: cache {tuple(cache['k'].shape)}")
    want_pos = torch.arange(S - W, S, device="cuda", dtype=torch.int32)
    check(torch.equal(torch.sort(cache["pos"][0, 0]).values, want_pos) and
          torch.equal(cache["pos"][0, 0] % W, torch.arange(W, device="cuda", dtype=torch.int32)),
          "mixtral-8x7b: the prefill ring does not hold the last window positions at slot pos % window")
    del ln
    tok, steps = lc.argmax(-1), []
    for i in range(MODEL_SIZES.mixtral_decode):
        pos = torch.full((1,), S + i, dtype=torch.int32, device="cuda")
        (dec, cache), s = timed_call(torch, lambda: tf.decode_step(params, ccfg, tok, pos, cache))
        steps.append(s)
        check(bool(torch.isfinite(dec).all()), f"mixtral-8x7b: non-finite decode logits at {S + i}")
        tok = dec.argmax(-1)
    del cache
    dcfg = drop_free(ccfg)
    _, cache = tf.prefill(params, dcfg, tk[:, :S2])
    cache = tf.extend_cache(dcfg, cache, W)
    hidden, _ = tf.forward(params, dcfg, tk[:, :S2 + 1])
    want = tf.logits_fn(params, dcfg, hidden[:, -1:])[:, 0].float()
    del hidden
    tok, decode_err = tk[:, S2], None
    for i in range(MODEL_SIZES.mixtral_wrap_steps):
        pos = torch.full((1,), S2 + i, dtype=torch.int32, device="cuda")
        dec, cache = tf.decode_step(params, dcfg, tok, pos, cache)
        check(bool(torch.isfinite(dec).all()), f"mixtral-8x7b: non-finite logits at {S2 + i} (ring of {W})")
        if i == 0:
            decode_err = bf16_rel(torch, dec, want, f"mixtral-8x7b decode against forward at position {S2}")
        tok = dec.argmax(-1)
    check(cache["k"].shape[2] == W and int(cache["pos"].max()) == S2 + MODEL_SIZES.mixtral_wrap_steps - 1
          and S2 + MODEL_SIZES.mixtral_wrap_steps > W, "mixtral-8x7b: the decode did not cross the ring's wrap")
    step_s = float(np.median(steps))
    peak = torch.cuda.max_memory_allocated()
    pos = torch.full((1,), S2 + MODEL_SIZES.mixtral_wrap_steps - 1, dtype=torch.int32, device="cuda")
    decode_prof = device_busy(torch, lambda: tf.decode_step(params, dcfg, tok, pos, cache), reps=5)
    del params, cache
    return dict(arch="mixtral-8x7b", layers=cfg.n_layers, layers_published=mods.get_arch("mixtral-8x7b").model_cfg.n_layers,
                d_model=cfg.d_model, experts=cfg.moe.n_experts, d_ff=cfg.moe.d_ff, window=W, dtype=cfg.dtype,
                param_bytes=n_bytes, seq=S, prefill_naive_ms=naive_s * 1e3, prefill_chunked_ms=chunked_s * 1e3,
                prefill_tokens_per_s=S / chunked_s, chunked_vs_naive_rel=chunk_vs_naive,
                decode_ms_per_step=step_s * 1e3, decode_tokens_per_s=1 / step_s, seq_below_window=S2,
                decode_vs_forward_rel=decode_err, wrap_steps=MODEL_SIZES.mixtral_wrap_steps, max_memory_allocated=peak,
                decode_device_ms=decode_prof["ms"], decode_kernels_per_step=decode_prof["kernels"],
                decode_host_ops_per_step=decode_prof["host_ops"])


def models_cells(torch, mods) -> list:
    """fm and xdeepfm at serve_p99 (batch 512, the 39 default vocabularies
    padded to ROW_PAD), sasrec and mind at retrieval_cand (1 query x 1M
    candidates), gcn-cora at full_graph_sm on cora_like: card against the
    port on the CPU for the same parameters, ms per call on the card."""
    rows = []
    for arch in REC_ARCHS:
        cfg = mods.get_arch(arch).model_cfg
        init, _, _ = mods.recsys.get_model_fns(cfg)
        params = on_both(torch, init(cfg, torch.Generator().manual_seed(MODEL_SEED), device="cpu"))
        serve = cfg.interaction in ("fm-2way", "cin")
        B = MODEL_SIZES.rec_batch if serve else 1
        out, calls = {}, {}
        for side, d in (("cpu", "cpu"), ("card", "cuda")):
            batch = rec_batch(torch, mods, cfg, B, d, seed=MODEL_SEED)
            cand = torch.arange(1, MODEL_SIZES.n_candidates + 1, dtype=torch.int32, device=d)
            calls[side] = (lambda p=params[side], b=batch, c=cand: rec_scores(torch, mods, cfg, p, b, c))
            out[side] = calls[side]()
        rows.append(dict(arch=arch, cell="serve_p99" if serve else "retrieval_cand", batch=B,
                         table_rows=int(params["card"]["table" if serve else "items"].shape[0]),
                         candidates=None if serve else MODEL_SIZES.n_candidates,
                         err=card_vs_cpu(torch, out["card"], out["cpu"], f"{arch} at its cell"),
                         ms=time_ms(torch, calls["card"], reps=20)))
        del params, out, calls
    cfg = mods.get_arch("gcn-cora").model_cfg
    params = on_both(torch, mods.gcn.init_params(cfg, torch.Generator().manual_seed(MODEL_SEED), device="cpu"))
    X, ei, _ = mods.cora_like(seed=MODEL_SEED)
    out, calls = {}, {}
    for side, d in (("cpu", "cpu"), ("card", "cuda")):
        x, e = torch.as_tensor(X, device=d), torch.as_tensor(ei, device=d)
        calls[side] = (lambda p=params[side], x=x, e=e: mods.gcn.forward_full(p, cfg, x, e))
        out[side] = calls[side]()
    rows.append(dict(arch="gcn-cora", cell="full_graph_sm", nodes=int(X.shape[0]), edges=int(ei.shape[1]),
                     err=card_vs_cpu(torch, out["card"], out["cpu"], "gcn-cora at full_graph_sm"),
                     ms=time_ms(torch, calls["card"], reps=20)))
    return rows


def model_modules():
    """The port's model half and what the phase feeds it (no JAX)."""
    from repro_torch import data
    from repro_torch.configs import get_arch
    from repro_torch.core import NSimplexProjector, select_pivots
    from repro_torch.metrics import get_metric
    from repro_torch.models import gcn, layers, recsys, transformer
    from repro_torch.search.distributed import build_serve_step
    from repro_torch.sharding import make_scaleout_mesh

    return SimpleNamespace(
        get_arch=get_arch, tf=transformer, layers=layers, recsys=recsys, gcn=gcn, get_metric=get_metric,
        NSimplexProjector=NSimplexProjector, select_pivots=select_pivots, build_serve_step=build_serve_step,
        make_scaleout_mesh=make_scaleout_mesh, **{name: getattr(data, name) for name in data.__all__},
    )


def phase_models(ops, torch) -> dict:
    """The model half of the port on the card (ROADMAP item 11a): every
    registry arch at its smoke config against the CPU, qwen2-1.5b at full
    size, mixtral-8x7b at full width (2 of 32 layers), and the RecSys and
    GCN archs at their published cells.  The launch counts are set to 0
    before and read after: the paper's serve step launches K4 and K3."""
    from repro_torch.device import pin_precision

    pin_precision()
    mods = model_modules()
    t_phase = time.perf_counter()
    ops.reset_launches()
    for row in models_smoke_lm(torch, mods):
        emit(phase="models", task="smoke_lm", **row)
    for row in models_smoke_other(torch, mods):
        emit(phase="models", **row)
    emit(phase="models", task="smoke_serve_step", **models_smoke_nsimplex(torch, mods))
    launches = dict(ops.LAUNCHES)
    check(launches["apex_project"] > 0 and launches["apex_threshold"] > 0,
          f"the serve step of nsimplex-colors launched no K4 or no K3 on the card: {launches}")
    emit(phase="models", task="launches", launches=launches)
    qwen = models_qwen(torch, mods)
    emit(phase="models", task="qwen2_full", **qwen)
    torch.cuda.empty_cache()
    mixtral = models_mixtral(torch, mods)
    emit(phase="models", task="mixtral_full_width", **mixtral)
    torch.cuda.empty_cache()
    for row in models_cells(torch, mods):
        emit(phase="models", task="cell", **row)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit(phase="models", task="done", seconds=seconds)
    return dict(qwen=qwen, mixtral=mixtral, launches=launches, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 9: training (ROADMAP item 11b)
# ---------------------------------------------------------------------------

#: card against CPU for losses, gradients and AdamW state: within 1e-4 of
#: each leaf's largest magnitude
TRAIN_TOL = 1e-4
#: the phase's AdamW: the reference's cells warm up over 100 steps, during
#: which a short run's bf16 weights would not move at all; at 3e-4 Adam's
#: first, sign-like step over a 4,096-wide model raises the loss before it
#: falls (mixtral-8x7b's 2-layer cut on an H100: 11.26 -> 24.61 -> 17.30)
TRAIN_OPT = dict(lr=3e-5, warmup_steps=0, total_steps=100)
#: mixtral's learning rate: at 3e-5 the first step of its full-width 2-layer
#: cut on an H100 raised the loss (11.26 -> 14.64) before it fell; its
#: router (f32, 4,096 x 8) moves every token's expert logits the same way
#: and the capacity limit drops the overflow
MOE_TRAIN_LR = 3e-6
#: qwen2-1.5b's train_4k at its full config, global batch cut from 256 to 8
#: (accum 8 microsteps of one sequence, as the cell gives on one device);
#: mixtral-8x7b at full width, 2 of 32 layers, 2 sequences of 4,096; the
#: RecSys cells at train_batch 65,536; 3 steps of each cell
TRAIN_SIZES = SimpleNamespace(
    qwen_seq=4096, qwen_batch=8, qwen_steps=4, mixtral_layers=2, mixtral_seq=4096, mixtral_batch=2,
    cell_steps=3, smoke_steps=5, ogb_train_nodes=196_615, serve_checked=64,
)


def fresh_peak(torch):
    """Free what earlier sections left (cycles included) and restart the
    peak-memory count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def leaf_err(torch, got, want, what, tol=TRAIN_TOL, extra=0.0) -> float:
    """max |got - want| over max |want| of one leaf, held to ``tol`` (plus
    ``extra`` absolute)."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} against {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values on the card")
    scale = max(float(w.abs().max()) if w.numel() else 0.0, 1e-30)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    check(err <= tol * scale + extra, f"{what}: card against CPU {err} > {tol} x {scale} + {extra}")
    return err / scale


def tree_err(torch, mods, got, want, what, extra=0.0) -> float:
    gl, wl = mods.tree_leaves(got), mods.tree_leaves(want)
    check(len(gl) == len(wl), f"{what}: {len(gl)} leaves against {len(wl)}")
    return max([leaf_err(torch, g, w, what, extra=extra) for g, w in zip(gl, wl)] or [0.0])


def smoke_train_cases(torch, mods):
    """(name, init(device) -> params, batch(device), loss(params, batch))
    for every trainable registry arch at its smoke config."""
    cases = []
    for arch in LM_SMOKE_ARCHS:
        cfg = mods.get_arch(arch).smoke_cfg
        toks, labs = mods.token_stream(2, 16, cfg.vocab, seed=1)
        cases.append((arch, lambda cfg=cfg: mods.tf.init_params(cfg, torch.Generator().manual_seed(MODEL_SEED),
                                                                device="cpu"),
                      lambda d, t=toks, l=labs: (torch.as_tensor(t, device=d), torch.as_tensor(l, device=d)),
                      lambda p, b, cfg=cfg: mods.tf.loss_fn(p, cfg, *b)[0]))
    for arch in REC_ARCHS:
        cfg = mods.get_arch(arch).smoke_cfg
        init, _, loss = mods.recsys.get_model_fns(cfg)
        cases.append((arch, lambda cfg=cfg, init=init: init(cfg, torch.Generator().manual_seed(MODEL_SEED),
                                                            device="cpu"),
                      lambda d, cfg=cfg: rec_train_batch(torch, mods, cfg, 32, d, seed=1),
                      lambda p, b, cfg=cfg, loss=loss: loss(p, cfg, b)))
    cfg = mods.get_arch("gcn-cora").smoke_cfg
    X, ei, y = mods.random_graph(200, 800, cfg.d_feat, cfg.n_classes, seed=0)
    mask = (np.arange(200) < 50).astype(np.float32)
    layers = mods.NeighborSampler(ei, 200, seed=0).sample_batch(np.arange(32), [5, 3])
    mol = mods.molecule_batch(batch=8, n_nodes=12, n_edges=20, d_feat=cfg.d_feat)
    mol_y = (np.arange(8) % cfg.n_classes).astype(np.int32)
    gcn_init = lambda: mods.gcn.init_params(cfg, torch.Generator().manual_seed(MODEL_SEED), device="cpu")  # noqa: E731
    T = lambda a, d: torch.as_tensor(a, device=d)  # noqa: E731
    cases += [
        ("gcn-cora/full", gcn_init, lambda d: (T(X, d), T(ei, d), T(y, d), T(mask, d)),
         lambda p, b: mods.gcn.loss_full(p, cfg, *b)),
        ("gcn-cora/sampled", gcn_init, lambda d: (T(X[layers[0]], d), [T(X[layers[1]], d), T(X[layers[2]], d)],
                                                  T(y[:32], d)),
         lambda p, b: mods.gcn.loss_sampled(p, cfg, *b)),
        ("gcn-cora/molecule", gcn_init, lambda d: (T(mol["feats"], d), T(mol["src"], d), T(mol["dst"], d),
                                                   T(mol_y, d)),
         lambda p, b: mods.gcn.loss_molecule(p, cfg, *b)),
    ]
    return cases


def rec_train_batch(torch, mods, cfg, B, d, seed=0):
    if cfg.interaction in ("fm-2way", "cin"):
        sizes = None if cfg.vocab_sizes is None else np.asarray(cfg.vocab_sizes)
        dense, sparse, labels = mods.criteo_like_batch(B, n_sparse=cfg.n_sparse, vocab_sizes=sizes, seed=seed)
        return {"dense": torch.as_tensor(dense, device=d), "sparse": torch.as_tensor(sparse, device=d),
                "labels": torch.as_tensor(labels, device=d)}
    seqs, targets = mods.user_history_batch(B, cfg.seq_len, cfg.n_items, seed=seed)
    return {"seqs": torch.as_tensor(seqs, device=d), "targets": torch.as_tensor(targets, device=d)}


def train_smoke(torch, mods) -> list:
    """Every trainable registry arch at its smoke config (nsimplex-colors
    serves and has no loss): ``smoke_steps`` AdamW steps on each side, the
    first step's loss and every gradient leaf on the card against the port
    on the CPU, then every step's loss, the moments and the parameters.  A first AdamW update of an
    element moves it by up to lr whatever its gradient's size against
    eps = 1e-8, so the parameters get 2·Σlr beside the tolerance; the
    moments carry the gradients' agreement."""
    rows = []
    opt_cfg = mods.AdamWConfig(moment_dtype="float32", **TRAIN_OPT)
    for name, init, batch_of, loss_of in smoke_train_cases(torch, mods):
        params = on_both(torch, init())
        out = {}
        for side, d in (("cpu", "cpu"), ("card", DEVICE)):
            b = batch_of(d)
            p = params[side]
            state, losses, grads, lrs = mods.init_state(opt_cfg, p), [], [], []
            for _ in range(TRAIN_SIZES.smoke_steps):
                l, g = mods.value_and_grad(lambda q: loss_of(q, b), p)
                p, state, m = mods.apply_updates(opt_cfg, p, g, state)      # leaves g as it was
                losses.append(l)
                grads = grads or [g]
                lrs.append(float(m["lr"]))
            out[side] = dict(grads=grads[0], losses=torch.stack(losses), params=p, state=state, lr=sum(lrs))
        c, k = out["cpu"], out["card"]
        row = dict(arch=name, loss=float(k["losses"][0]),
                   loss_err=leaf_err(torch, k["losses"][0], c["losses"][0], f"{name} loss"),
                   grad_err=tree_err(torch, mods, k["grads"], c["grads"], f"{name} gradients"),
                   steps=TRAIN_SIZES.smoke_steps,
                   step_loss_err=leaf_err(torch, k["losses"], c["losses"], f"{name} losses over AdamW steps"),
                   moment_err=max(tree_err(torch, mods, k["state"][key], c["state"][key], f"{name} AdamW {key}")
                                  for key in ("m", "v")),
                   param_err=tree_err(torch, mods, k["params"], c["params"], f"{name} parameters after AdamW",
                                      extra=2 * c["lr"]))
        check(float(k["losses"][-1]) < float(k["losses"][0]), f"{name}: the smoke loss did not fall on the card")
        rows.append(row)
    return rows


def run_steps(torch, fn, args, n):
    """``n`` steps of a train cell's fn: (losses, seconds per step, args
    after the last step)."""
    losses, secs = [], []
    for _ in range(n):
        (params, opt, m), s = timed_call(torch, lambda: fn(*args))
        args = (params, opt) + tuple(args[2:])
        losses.append(float(m["loss"]))
        secs.append(s)
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall over {n} steps: {losses}")
    return losses, secs, args


def host_mesh(mods):
    """The (1, 1) mesh of the phase's device."""
    return mods.make_host_mesh(1, 1, devices=None if DEVICE == "cuda" else [DEVICE])


def train_root() -> Path:
    root = Path(__file__).resolve().parent / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    return root


def same_bits(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def train_qwen(torch, mods, root) -> dict:
    """qwen2-1.5b at its full config through the train_4k cell (global batch
    cut 256 -> 8): the opt cell's first loss on a copy, 4 steps on one
    repeated batch, one profiled step, a checkpoint of params and bf16
    moments saved and restored bit-equal, and ``TrainLoop`` recovering
    from one injected failure through that checkpoint."""
    import copy

    tf, S, B = mods.tf, TRAIN_SIZES.qwen_seq, TRAIN_SIZES.qwen_batch
    cfg = mods.get_arch("qwen2-1.5b").model_cfg
    opt_cfg = mods.AdamWConfig(moment_dtype="bfloat16", **TRAIN_OPT)
    mesh = host_mesh(mods)
    plan = mods.steps.build_cell("qwen2-1.5b", "train_4k", mesh, accum_override=B, opt_cfg=opt_cfg)
    plan_opt = mods.steps.build_cell("qwen2-1.5b", "train_4k", mesh, accum_override=B, opt=True, opt_cfg=opt_cfg)
    check(plan.note == f"accum={B} micro=1", f"qwen2-1.5b plan: {plan.note}")
    fresh_peak(torch)
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(MODEL_SEED), device=DEVICE)
    opt = mods.init_state(opt_cfg, params)
    n_params = sum(p.numel() for p in params.parameters())
    toks, labs = mods.token_stream(B, S, cfg.vocab, seed=MODEL_SEED)
    tk = torch.as_tensor(toks, device=DEVICE).reshape(B, 1, S)
    lb = torch.as_tensor(labs, device=DEVICE).reshape(B, 1, S)
    p2 = copy.deepcopy(params)
    out, opt_s = timed_call(torch, lambda: plan_opt.fn(p2, mods.init_state(opt_cfg, p2), tk, lb))
    opt_loss = float(out[2]["loss"])
    del p2, out
    peak_opt = torch.cuda.max_memory_allocated()
    fresh_peak(torch)
    losses, secs, (params, opt, _, _) = run_steps(torch, plan.fn, (params, opt, tk, lb), TRAIN_SIZES.qwen_steps)
    check(abs(opt_loss - losses[0]) <= 0.01 * abs(losses[0]),
          f"qwen2-1.5b: the opt cell's first loss {opt_loss} against the plain cell's {losses[0]}")
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(secs[1:]))
    state = [params, opt]

    def one_step():
        state[0], state[1], _ = plan.fn(state[0], state[1], tk, lb)

    prof = device_busy(torch, one_step, reps=1)
    params, opt = state
    tokens = B * S
    # one checkpoint of params and bf16 moments, saved and restored bit-equal
    mgr = mods.CheckpointManager(str(root / "qwen"), keep=1)
    done = int(opt["step"])                 # the profiler's steps ran too
    check(done > TRAIN_SIZES.qwen_steps, f"qwen2-1.5b: AdamW step {done} after the profiled step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(done, (params, opt))
    save_s = time.perf_counter() - t0
    ckpt_bytes = dir_bytes(root / "qwen")
    t0 = time.perf_counter()
    (rp, ro), step = mgr.restore((params, opt))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == done, f"qwen2-1.5b: restored step {step}")
    pairs = list(zip(mods.tree_leaves((params, opt)), mods.tree_leaves((rp, ro))))
    check(all(b.device.type == torch.device(DEVICE).type and same_bits(torch, a, b) for a, b in pairs),
          "qwen2-1.5b: the restored checkpoint is not bit-equal on the card")
    check(ro["m"]["embed"].dtype == torch.bfloat16 and all(p.requires_grad for p in rp.parameters()),
          "qwen2-1.5b: restored moments are not bf16 or parameters lost requires_grad")
    del rp, ro, pairs
    # TrainLoop: resume from the checkpoint, one injected failure, recovery
    fired = []

    def bomb(step):
        if step == done + 1 and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    def step_fn(state, batch):
        p, o, m = plan.fn(*state, *batch)
        return (p, o), {"loss": m["loss"]}

    loop = mods.TrainLoop(mods.LoopConfig(total_steps=done + 2, checkpoint_every=1000,
                                          checkpoint_dir=str(root / "qwen"), keep_checkpoints=1, max_retries=2),
                          step_fn, lambda step: (tk, lb), (params, opt), failure_hook=bomb)
    del params, opt
    t0 = time.perf_counter()
    lm = loop.run(start_step=done)      # the state in memory is the checkpoint's: no resume read
    loop_s = time.perf_counter() - t0
    check(lm.failures_recovered == 1 and lm.steps_run == 3 and fired, f"qwen2-1.5b TrainLoop: {lm}")
    check(all(np.isfinite(lm.losses)) and lm.losses[0] == lm.losses[1],
          f"qwen2-1.5b TrainLoop: the step replayed from the checkpoint gave another loss: {lm.losses}")
    check(mgr.latest_step() == done + 2, f"qwen2-1.5b TrainLoop did not checkpoint its last step: {mgr.all_steps()}")
    del loop
    torch.cuda.empty_cache()
    return dict(arch="qwen2-1.5b", cell="train_4k", layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
                dtype=cfg.dtype, moment_dtype="bfloat16", params=n_params, seq=S, global_batch=B,
                global_batch_published=256, note=plan.note, losses=losses, opt_first_loss=opt_loss,
                opt_vs_plain_rel=abs(opt_loss - losses[0]) / abs(losses[0]), opt_step_s=opt_s,
                step_s=step_s, step_s_all=secs, tokens_per_s=tokens / step_s,
                model_flops_share=6.0 * n_params * tokens / step_s / BF16_FLOPS,
                device_busy_ms=prof["ms"], device_busy_share=prof["ms"] / 1e3 / step_s,
                kernels_per_step=prof["kernels"], host_ops_per_step=prof["host_ops"], max_memory_allocated=peak,
                max_memory_allocated_opt_cell=peak_opt,
                checkpoint_bytes=ckpt_bytes, checkpoint_save_s=save_s, checkpoint_restore_s=restore_s,
                loop_steps_run=lm.steps_run, loop_failures_recovered=lm.failures_recovered,
                loop_losses=lm.losses, loop_s=loop_s)


def train_mixtral(torch, mods) -> dict:
    """mixtral-8x7b at full width, 2 of 32 layers, through the train_4k cell
    (2 sequences of 4,096, accum 2): 3 steps, the loss falling (the MoE
    backward on the card)."""
    cfg = mods.get_arch("mixtral-8x7b").model_cfg
    L, S, B = TRAIN_SIZES.mixtral_layers, TRAIN_SIZES.mixtral_seq, TRAIN_SIZES.mixtral_batch
    opt_cfg = mods.AdamWConfig(moment_dtype="bfloat16", **dict(TRAIN_OPT, lr=MOE_TRAIN_LR))
    plan = mods.steps.build_cell("mixtral-8x7b", "train_4k", host_mesh(mods), n_layers=L,
                                 accum_override=B, opt_cfg=opt_cfg)
    import dataclasses

    cfg = dataclasses.replace(cfg, n_layers=L)
    fresh_peak(torch)
    allocated_before = torch.cuda.memory_allocated()
    params = mods.tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(MODEL_SEED), device=DEVICE)
    n_params = sum(p.numel() for p in params.parameters())
    toks, labs = mods.token_stream(B, S, cfg.vocab, seed=MODEL_SEED + 1)
    tk = torch.as_tensor(toks, device=DEVICE).reshape(B, 1, S)
    lb = torch.as_tensor(labs, device=DEVICE).reshape(B, 1, S)
    losses, secs, _ = run_steps(torch, plan.fn, (params, mods.init_state(opt_cfg, params), tk, lb),
                                TRAIN_SIZES.cell_steps)
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    step_s = float(np.median(secs[1:]))
    return dict(arch="mixtral-8x7b", cell="train_4k", layers=L, layers_published=32, d_model=cfg.d_model,
                experts=cfg.moe.n_experts, dtype=cfg.dtype, params=n_params, seq=S, global_batch=B,
                note=plan.note, lr=opt_cfg.lr, losses=losses, step_s=step_s, step_s_all=secs,
                tokens_per_s=B * S / step_s, allocated_before=allocated_before, max_memory_allocated=peak)


def rec_cell_batch(torch, mods, cfg, B, accum):
    b = rec_train_batch(torch, mods, cfg, B, DEVICE, seed=MODEL_SEED)
    return {k: v.reshape((accum, -1) + tuple(v.shape[1:])) for k, v in b.items()} if accum > 1 else b


def train_rec_cells(torch, mods) -> list:
    """fm, xdeepfm, sasrec and mind at train_batch (65,536 rows; the sequence
    models in the cell's 16 microbatches): 3 steps each, the batch halved
    until a step fits in memory (printed as a cut)."""
    rows = []
    opt_cfg = mods.AdamWConfig(moment_dtype="float32", **TRAIN_OPT)
    for arch in REC_ARCHS:
        cfg = mods.get_arch(arch).model_cfg
        plan = mods.steps.build_cell(arch, "train_batch", host_mesh(mods), opt_cfg=opt_cfg)
        accum = int(plan.note.split("=")[1])
        B = mods.get_arch(arch).shapes["train_batch"].sizes["batch"]
        init = mods.recsys.get_model_fns(cfg)[0]
        fresh_peak(torch)
        params = init(cfg, torch.Generator(device=DEVICE).manual_seed(MODEL_SEED), device=DEVICE)
        while True:
            batch = rec_cell_batch(torch, mods, cfg, B, accum)
            opt = mods.init_state(opt_cfg, params)
            try:
                losses, secs, _ = run_steps(torch, plan.fn, (params, opt, batch), TRAIN_SIZES.cell_steps)
                break
            except torch.cuda.OutOfMemoryError:
                pass        # retried with half the rows and fresh moments
            # outside the handler, so that the failed step's frames are released
            del batch, opt
            torch.cuda.empty_cache()
            check(B > 1024, f"{arch}: out of memory down to {B} rows")
            B //= 2
            emit(phase="train", task="cut", arch=arch, cell="train_batch", batch=B, reason="out of memory")
        step_s = float(np.median(secs[1:]))
        rows.append(dict(arch=arch, cell="train_batch", batch=B, batch_published=65536, note=plan.note,
                         losses=losses, ms_per_step=step_s * 1e3, rows_per_s=B / step_s,
                         max_memory_allocated=torch.cuda.max_memory_allocated()))
        del params, opt, batch
    torch.cuda.empty_cache()
    return rows


def gcn_cell_args(torch, mods, cfg, name, sizes, g):
    """One GCN cell's batch on the card: cora_like for full_graph_sm, a
    random graph of the published size on the device for ogb_products,
    drawn features for minibatch_lg's sampled hops, molecule_batch."""
    dev = DEVICE
    if name in ("full_graph_sm", "ogb_products"):
        N, E = sizes["n_nodes"], sizes["n_edges"]
        E_pad = ((E + 511) // 512) * 512
        if name == "full_graph_sm":
            X, ei, y = mods.cora_like(seed=MODEL_SEED)
            feats, y = torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)
            ei, E = torch.as_tensor(ei, device=dev), ei.shape[1]
            E_pad = ((E + 511) // 512) * 512
            mask = (torch.arange(N, device=dev) < 140).float()        # cora's 140 training nodes
        else:
            feats = torch.randn((N, sizes["d_feat"]), generator=g, device=dev)
            ei = torch.randint(0, N, (2, E), generator=g, device=dev, dtype=torch.int32)
            y = torch.randint(0, sizes["n_classes"], (N,), generator=g, device=dev, dtype=torch.int32)
            mask = torch.zeros(N, device=dev)
            mask[torch.randperm(N, generator=g, device=dev)[:TRAIN_SIZES.ogb_train_nodes]] = 1.0
        edges = torch.zeros((2, E_pad), dtype=torch.int32, device=dev)
        edges[:, :E] = ei
        weight = (torch.arange(E_pad, device=dev) < E).float()       # 0.0 marks padding edges
        return (feats, edges, weight, y.to(torch.int32), mask), dict(nodes=N, edges=E)
    if name == "minibatch_lg":
        B, f1, f2, F_ = sizes["batch_nodes"], sizes["fanout1"], sizes["fanout2"], sizes["d_feat"]
        hops = [torch.randn((n, F_), generator=g, device=dev) for n in (B, B * f1, B * f1 * f2)]
        y = torch.randint(0, sizes["n_classes"], (B,), generator=g, device=dev, dtype=torch.int32)
        return tuple(hops) + (y,), dict(batch_nodes=B, gathered_rows=B * (1 + f1 + f1 * f2))
    mol = mods.molecule_batch(batch=sizes["batch"], n_nodes=sizes["n_nodes"], n_edges=sizes["n_edges"],
                              d_feat=sizes["d_feat"], seed=MODEL_SEED)
    y = torch.randint(0, sizes["n_classes"], (sizes["batch"],), generator=g, device=dev, dtype=torch.int32)
    return tuple(torch.as_tensor(mol[k], device=dev) for k in ("feats", "src", "dst")) + (y,), dict(
        graphs=sizes["batch"])


def train_gcn_cells(torch, mods) -> list:
    """gcn-cora's four train cells at their published sizes (minibatch_lg's
    sampled features drawn on the card; the sampler over its 114.6M-edge
    graph is host work outside the step): 3 steps each."""
    import dataclasses

    rows = []
    opt_cfg = mods.AdamWConfig(moment_dtype="float32", **TRAIN_OPT)
    arch = mods.get_arch("gcn-cora")
    g = torch.Generator(device=DEVICE).manual_seed(MODEL_SEED)
    for name, shape in arch.shapes.items():
        fresh_peak(torch)
        plan = mods.steps.build_cell("gcn-cora", name, host_mesh(mods), opt_cfg=opt_cfg)
        cfg = dataclasses.replace(arch.model_cfg, d_feat=shape.sizes["d_feat"], n_classes=shape.sizes["n_classes"])
        params = mods.gcn.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(MODEL_SEED), device=DEVICE)
        args, info = gcn_cell_args(torch, mods, cfg, name, shape.sizes, g)
        losses, secs, _ = run_steps(torch, plan.fn, (params, mods.init_state(opt_cfg, params)) + args,
                                    TRAIN_SIZES.cell_steps)
        rows.append(dict(arch="gcn-cora", cell=name, **info, losses=losses, ms_per_step=float(np.median(secs[1:])) * 1e3,
                         max_memory_allocated=torch.cuda.max_memory_allocated()))
        del params, args
    torch.cuda.empty_cache()
    return rows


def train_serve_cell(ops, torch, mods, data_np) -> dict:
    """nsimplex-colors' serve_1m cell with opt=True (K4 projection, K3
    selection) on the card: the colors corpus (1M rows of 112) under JSD,
    32 pivots, the table padded to 1,007,616 rows with sentinel rows, 1,024
    queries.  Every histogram sums to the padded table; for the first 64
    queries every true result within the threshold is among the packed
    candidates unless the query overflows its 8 slots.  The launch counts
    are set to 0 before the step and read after it."""
    arch = mods.get_arch("nsimplex-colors")
    sizes = arch.shapes["serve_1m"].sizes
    N, Q, n = sizes["n_objects"], sizes["query_batch"], sizes["n_pivots"]
    plan = mods.steps.build_cell("nsimplex-colors", "serve_1m", host_mesh(mods), opt=True)
    N_pad = plan.args[0].shape[0]
    X = data_np if data_np is not None and len(data_np) >= N else mods.colors_like(n=N, dim=DIM, seed=SEED)
    data = torch.as_tensor(X[:N], device=DEVICE)
    queries = torch.as_tensor(mods.colors_like(n=Q, dim=DIM, seed=SEED + 1), device=DEVICE)
    metric = mods.get_metric(arch.model_cfg.metric)
    proj = mods.NSimplexProjector(mods.select_pivots(X[:N], n, seed=1), metric, device=DEVICE)
    table = torch.full((N_pad, n), 0.0, dtype=torch.float32, device=DEVICE)
    table[:, -1] = float("inf")                   # sentinel rows: altitude +inf, never a candidate
    table[:N] = proj.project_distances(proj.pivot_distances(data)).to(torch.float32)
    qd = proj.pivot_distances(queries).to(torch.float32)
    consts = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE) for a in (proj.Linv, proj.sq_norms, proj.sigma)]
    checked = TRAIN_SIZES.serve_checked
    D = metric.cross(queries[:checked].double(), data.double())
    t = float(D.kthvalue(3, dim=1).values.median())   # about half the checked queries have <= 3 results
    torch.cuda.synchronize()
    ops.reset_launches()
    (hist, idx, code), serve_s = timed_call(torch, lambda: plan.fn(table, *consts, qd, t))
    launches = dict(ops.LAUNCHES)
    check(launches["apex_project"] > 0 and launches["apex_threshold"] > 0,
          f"the nsimplex-colors serve_1m cell launched no K4 or no K3: {launches}")
    check(bool((hist.sum(dim=1) == N_pad).all()), "nsimplex-colors serve_1m: a histogram does not sum to the table")
    idx, code, hist = idx.cpu(), code.cpu(), hist.cpu()
    overflow = 0
    for qi in range(checked):
        got = {int(a) for a in idx[:, qi].ravel() if a >= 0}
        over = int(hist[qi, 1] + hist[qi, 2]) > idx.shape[-1]
        overflow += over
        missing = set(torch.nonzero(D[qi] <= t).flatten().cpu().tolist()) - got
        check(not missing or over, f"nsimplex-colors serve_1m: query {qi} excluded true results {sorted(missing)[:5]}")
    serve_ms = time_ms(torch, lambda: plan.fn(table, *consts, qd, t), reps=5)
    return dict(arch="nsimplex-colors", cell="serve_1m", note=plan.note, rows=N, rows_padded=N_pad, queries=Q,
                pivots=n, threshold=t, checked=checked, overflowing_checked=overflow, first_call_ms=serve_s * 1e3,
                ms=serve_ms, launches=launches)


def train_cli(torch, root) -> dict:
    """``python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps
    20`` on the card, as a subprocess."""
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-1.5b", "--smoke",
                          "--steps", "20", "--ckpt-dir", str(root / "cli")] + ([] if DEVICE == "cuda" else
                                                                              ["--device", DEVICE]),
                         cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and lines and lines[-1].startswith("[train] done: 20 steps"),
          f"the train CLI failed ({out.returncode}): {out.stdout[-2000:]} {out.stderr[-2000:]}")
    check(f"({DEVICE}" in out.stdout, f"the train CLI did not run on the card: {out.stdout[-500:]}")
    return dict(command="python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 20", wall_s=wall,
                lines=lines)


def train_modules():
    """The port's training half and what the phase feeds it (no JAX)."""
    from repro_torch.launch import mesh, steps
    from repro_torch.models.params import tree_leaves, value_and_grad
    from repro_torch.train import AdamWConfig, CheckpointManager, LoopConfig, TrainLoop, apply_updates, init_state

    return SimpleNamespace(**vars(model_modules()), steps=steps, make_host_mesh=mesh.make_host_mesh,
                           tree_leaves=tree_leaves, value_and_grad=value_and_grad, AdamWConfig=AdamWConfig,
                           CheckpointManager=CheckpointManager, LoopConfig=LoopConfig, TrainLoop=TrainLoop,
                           apply_updates=apply_updates, init_state=init_state)


def phase_train(ops, torch, data_np=None) -> dict:
    """Training on the card (ROADMAP item 11b): every smoke arch's loss,
    gradients and AdamW steps against the CPU; qwen2-1.5b at its full config
    (batch cut 256 -> 8) with a checkpoint round trip and a recovered
    failure; mixtral-8x7b at full width (2 of 32 layers); the RecSys and GCN
    train cells at their published sizes; the paper's serve_1m cell (K4,
    K3); the train CLI.  No kernel of this repo lies on the training path."""
    from repro_torch.device import pin_precision

    pin_precision()
    mods = train_modules()
    t_phase = time.perf_counter()
    root = train_root()
    emit(phase="train", task="disk", free_bytes=shutil.disk_usage(root).free)
    for row in train_smoke(torch, mods):
        emit(phase="train", task="smoke", **row)
    qwen = train_qwen(torch, mods, root)
    emit(phase="train", task="qwen2_full", **qwen)
    shutil.rmtree(root / "qwen", ignore_errors=True)
    mixtral = train_mixtral(torch, mods)
    emit(phase="train", task="mixtral_full_width", **mixtral)
    for row in train_rec_cells(torch, mods) + train_gcn_cells(torch, mods):
        emit(phase="train", task="cell", **row)
    serve = train_serve_cell(ops, torch, mods, data_np)
    emit(phase="train", task="serve_cell", **serve)
    torch.cuda.empty_cache()
    emit(phase="train", task="cli", **train_cli(torch, root))
    shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    emit(phase="train", task="done", seconds=seconds)
    return dict(qwen=qwen, mixtral=mixtral, serve=serve, seconds=seconds)

#: the paper's Fig. 2 at its colors size: output widths, sampled pairs and
#: the methods per metric (PCA and JL need coordinates: Euclidean only)
FIG2_ROWS, FIG2_KS, FIG2_PAIRS = ENGINE_ROWS, (5, 10, 20, 50), 20_000
FIG2_METHODS = {"euclidean": ("nsimplex", "pca", "jl", "lmds"), "jensen_shannon": ("nsimplex", "lmds")}
#: the card's D of n-simplex and JL against the port's on the CPU, same pairs
FIG2_CPU_RTOL = 1e-9
#: every n-simplex ratio true / apex is >= 1 (the apex distance is a lower bound)
RATIO_FLOOR = 1.0 - 1e-9
#: the projector's three modes on this many rows at n pivots, within this
MODES_ROWS, MODES_TOL = 4096, 1e-10
#: the dry run's cells: the two the train phase measures, at its cuts
#: (qwen2-1.5b's global batch 256 -> 8; mixtral-8x7b 2 of 32 layers, batch 2)
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", dict(accum=TRAIN_SIZES.qwen_batch)),
                ("mixtral-8x7b", "train_4k", dict(accum=TRAIN_SIZES.mixtral_batch,
                                                  n_layers=TRAIN_SIZES.mixtral_layers)))
#: the dry run on the production meshes (ROADMAP item 11c.5): these cells
#: through --calibrate's shallow variants on single and multi, one
#: subprocess a cell, within this many seconds
DRYRUN_MESH_CELLS = (("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "decode_32k"), ("mixtral-8x7b", "train_4k"))
DRYRUN_MESH_CHIPS, DRYRUN_MESH_TIMEOUT = {"single": 256, "multi": 512}, 240
#: the tune phase's problems on the e2e phase's 1M-row n = 20 table: K1 at
#: (Q, dims 20), K2 at (Q, k 10, upb, 20), K3 at (Q, cap 512, 20) under
#: k-NN pass B's thresholds (the K-th smallest upb: the serving bucket's)
TUNE_QS, TUNE_KEY, TUNE_CAP = (1, 64), "upb", 512


def tools_modules():
    """The port's Fig. 2 pieces (no JAX)."""
    from repro_torch.baselines import LandmarkMDS, jl_project, pca_project
    from repro_torch.core import NSimplexProjector, distortion_from_ratios, measure_distortion, select_pivots
    from repro_torch.core.distortion import pair_distances, sample_pairs
    from repro_torch.data import colors_like
    from repro_torch.metrics import get_metric

    return SimpleNamespace(colors_like=colors_like, LandmarkMDS=LandmarkMDS, jl_project=jl_project, pca_project=pca_project,
                           NSimplexProjector=NSimplexProjector, distortion_from_ratios=distortion_from_ratios,
                           measure_distortion=measure_distortion, select_pivots=select_pivots,
                           pair_distances=pair_distances, sample_pairs=sample_pairs, get_metric=get_metric)


def fig2_maps(t, metric, X_np, X, method, k, seed=0):
    """(f on the card, f on the CPU or None) of one Fig. 2 method at width
    k: n-simplex on k random pivots, PCA, JL, LMDS on max(k + 2, 2k)
    landmarks (the JAX package's benchmark's choice)."""
    if method == "nsimplex":
        piv = t.select_pivots(X_np, k, seed=seed)
        return (t.NSimplexProjector(piv, metric, device=DEVICE), t.NSimplexProjector(piv, metric, device="cpu"))
    if method == "jl":
        return (t.jl_project(X_np.shape[1], k, seed=seed, device=DEVICE),
                t.jl_project(X_np.shape[1], k, seed=seed, device="cpu"))
    if method == "pca":
        return t.pca_project(X, k, device=DEVICE), None
    return t.LandmarkMDS(t.select_pivots(X_np, max(k + 2, 2 * k), seed=seed + 1), metric, k, device=DEVICE), None


def cpu_distortion(torch, t, metric, X_np, f_cpu, n_pairs, seed=0) -> float:
    """D of ``f_cpu`` on the CPU over ``measure_distortion``'s pairs, the
    projection of the sampled rows only (every map here is row-wise)."""
    i, j = t.sample_pairs(X_np.shape[0], n_pairs, seed)
    A, B = torch.as_tensor(X_np[i]), torch.as_tensor(X_np[j])
    true_d = t.pair_distances(metric, A, B)
    diff = f_cpu(A).double() - f_cpu(B).double()
    return t.distortion_from_ratios(true_d, torch.sqrt(torch.clamp_min((diff * diff).sum(dim=1), 0.0)))


def tools_fig2(torch, t, X_np) -> list:
    """The paper's Fig. 2 on the card: D per (metric, k, method) over
    20,000 pairs of the 112,682-row colors corpus ``X_np`` in f64, each
    map's fit and projection wall ms; n-simplex's ratios all >= 1, every D
    finite, and the card's n-simplex and JL D equal to the port's on the
    CPU."""
    X = torch.as_tensor(X_np, device=DEVICE)
    rows = []
    for metric_name, methods in FIG2_METHODS.items():
        metric = t.get_metric(metric_name)
        for k in FIG2_KS:
            for method in methods:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f, f_cpu = fig2_maps(t, metric, X_np, X, method, k)
                torch.cuda.synchronize()
                fit_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                Xp = f(X)
                torch.cuda.synchronize()
                proj_ms = (time.perf_counter() - t0) * 1e3
                check(tuple(Xp.shape) == (FIG2_ROWS, k) and bool(torch.isfinite(Xp).all()),
                      f"Fig. 2 {metric_name} {method} k={k}: projection {tuple(Xp.shape)} not finite")
                del Xp
                D, true_d, approx_d = t.measure_distortion(metric, X, f, n_pairs=FIG2_PAIRS)
                check(np.isfinite(D), f"Fig. 2 {metric_name} {method} k={k}: D = {D}")
                row = dict(metric=metric_name, k=k, method=method, D=D, fit_ms=fit_ms, projection_ms=proj_ms,
                           pairs=int(true_d.shape[0]))
                if method == "nsimplex":
                    keep = approx_d > 1e-12
                    ratio_min = float((true_d[keep] / approx_d[keep]).min())
                    check(ratio_min >= RATIO_FLOOR,
                          f"Fig. 2 {metric_name} k={k}: an n-simplex apex distance exceeds the true one "
                          f"(ratio {ratio_min})")
                    row["ratio_min"] = ratio_min
                if f_cpu is not None:
                    t0 = time.perf_counter()
                    D_cpu = cpu_distortion(torch, t, metric, X_np, f_cpu, FIG2_PAIRS)
                    row.update(D_cpu=D_cpu, cpu_s=time.perf_counter() - t0)
                    check(abs(D - D_cpu) <= FIG2_CPU_RTOL * abs(D_cpu),
                          f"Fig. 2 {metric_name} {method} k={k}: card D {D!r} != CPU D {D_cpu!r}")
                del true_d, approx_d, f, f_cpu
                emit(phase="tools", task="fig2", **row)
                rows.append(row)
    for k in FIG2_KS:
        by = {r["method"]: r["D"] for r in rows if r["metric"] == "euclidean" and r["k"] == k}
        # printed, not checked: tests/test_system.py asserts it at 1,500 rows
        emit(phase="tools", task="fig2_nsimplex_vs_jl", k=k, nsimplex_D=by["nsimplex"], jl_D=by["jl"],
             nsimplex_below_jl=by["nsimplex"] < by["jl"])
    return rows


def tools_modes(torch, t) -> dict:
    """The projector's gemm (K4), paper and solve modes on MODES_ROWS rows at
    N_PIVOTS pivots on the card agree within MODES_TOL (altitudes, a sqrt
    that is ~0 at a pivot, compared squared)."""
    X_np = t.colors_like(n=MODES_ROWS, dim=DIM, seed=SEED + 1).astype(np.float64)
    X = torch.as_tensor(X_np, device=DEVICE)
    piv = t.select_pivots(X_np, N_PIVOTS, seed=1)
    metric = t.get_metric("euclidean")
    outs, ms = {}, {}
    for mode in ("gemm", "paper", "solve"):
        proj = t.NSimplexProjector(piv, metric, mode=mode, device=DEVICE)
        d = proj.pivot_distances(X)
        outs[mode] = proj.project_distances(d)
        ms[mode] = time_ms(torch, lambda: proj.project_distances(d))
    err = {}
    for mode in ("paper", "solve"):
        a, b = outs[mode], outs["gemm"]
        head = ((a[:, :-1] - b[:, :-1]).abs() / (1.0 + b[:, :-1].abs())).max()
        alt = ((a[:, -1] ** 2 - b[:, -1] ** 2).abs() / (1.0 + b[:, -1] ** 2)).max()
        err[mode] = float(max(head, alt))
        check(err[mode] <= MODES_TOL, f"projector mode {mode} differs from gemm by {err[mode]}")
    return dict(rows=MODES_ROWS, n_pivots=N_PIVOTS, max_rel_err_vs_gemm=err, ms=ms)


def start_dryruns() -> tuple:
    """``python -m repro_torch.launch.dryrun`` in the background, one
    process a cell (host work): ``DRYRUN_CELLS`` on one card at their cuts,
    ``DRYRUN_MESH_CELLS`` on both production meshes through
    ``--calibrate``; records under a fresh temporary directory, stopped and
    removed by ``finish_dryruns`` or at exit.  Returns (the directory,
    [(arch, shape, cut or None, out directory, start, process)])."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + os.environ["PYTHONPATH"]
                                             if os.environ.get("PYTHONPATH") else ""))
    jobs = list(DRYRUN_CELLS) + [(arch, shape, None) for arch, shape in DRYRUN_MESH_CELLS]
    procs = []
    for arch, shape, cut in jobs:
        out = root / f"{arch}__{shape}__{'card' if cut else 'mesh'}"
        argv = ["--arch", arch, "--shape", shape, "--out", str(out)]
        if cut is None:
            argv += ["--mesh", "both", "--calibrate"]
        else:
            argv += ["--mesh", "card", "--accum", str(cut["accum"])]
            argv += ["--layers", str(cut["n_layers"])] if "n_layers" in cut else []
        procs.append((arch, shape, cut, out, time.perf_counter(),
                      subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *argv], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                       start_new_session=True)))
    atexit.register(stop_dryruns, root, procs)
    return root, procs


def stop_dryruns(root: Path, procs) -> None:
    for *_, proc in procs:
        stop_group(proc)
    shutil.rmtree(root, ignore_errors=True)


def finish_dryruns(started, train=None) -> tuple:
    """Waits for ``start_dryruns``' processes (stopping any past their
    limit) and holds each record: status ok; on one card the counted FLOPs
    against model_flops, the dominant roofline term and the bound seconds
    (beside the train phase's measured step where it ran); on the
    production meshes ``n_chips`` the mesh's and a collective term above 0,
    each cell's collective bytes by kind (extrapolated to the full depth
    and accumulation), its roofline terms and walk seconds.  Prints the
    seconds the phase waited.  Returns (card rows, mesh rows)."""
    measured = {"qwen2-1.5b": (train or {}).get("qwen", {}).get("step_s"),
                "mixtral-8x7b": (train or {}).get("mixtral", {}).get("step_s")}
    root, procs = started
    card, mesh_rows, t0 = [], [], time.perf_counter()
    try:
        for arch, shape, cut, out, start, proc in procs:
            _, stderr = proc.communicate(timeout=DRYRUN_MESH_TIMEOUT)
            process_s = time.perf_counter() - start
            check(proc.returncode == 0, f"dry run of {arch}/{shape} ({cut or 'production meshes'}) exited "
                                        f"{proc.returncode}:\n{stderr[-4000:]}")
            if cut is not None:
                rec = json.loads((out / f"{arch}__{shape}__card.json").read_text())
                check(rec["status"] == "ok", f"dry run {arch}/{shape}: {rec.get('error')}")
                r = rec["roofline"]
                row = dict(arch=arch, shape=shape, cut=cut, counted_flops=rec["op_walk"]["flops"],
                           model_flops=rec["model_flops"],
                           counted_over_model=rec["op_walk"]["flops"] / rec["model_flops"],
                           bytes_hbm=rec["op_walk"]["bytes_hbm"], ops=rec["op_walk"]["ops"], dominant=r["dominant"],
                           compute_s=r["compute_s"], memory_s=r["memory_s"], bound_s=max(r["compute_s"], r["memory_s"]),
                           memory=rec["memory"], walk_s=rec["walk_s"], process_s=process_s,
                           measured_step_s=measured.get(arch))
                emit(phase="tools", task="dryrun", **row)
                card.append(row)
                continue
            for mesh, chips in DRYRUN_MESH_CHIPS.items():
                rec = json.loads((out / f"{arch}__{shape}__{mesh}__calib.json").read_text())
                check(rec["status"] == "ok", f"dry run {arch}/{shape}/{mesh}: {rec.get('error')}")
                v3 = rec["roofline_v3"]
                coll = {k[len("coll_"):]: v for k, v in rec["extrapolated"].items() if k.startswith("coll_")}
                check(rec["n_chips"] == chips and coll["total"] > 0 and v3["collective_s"] > 0,
                      f"dry run {arch}/{shape}/{mesh}: {rec['n_chips']} chips, collective bytes {coll}")
                row = dict(arch=arch, shape=shape, mesh=mesh, n_chips=chips, collective_bytes=coll,
                           collective_s=v3["collective_s"], compute_s=v3["compute_s"], memory_s=v3["memory_s"],
                           dominant=v3["dominant"], roofline_fraction=v3["roofline_fraction"],
                           model_flops=rec["model_flops"], walk_s=rec["total_s"], process_s=process_s)
                emit(phase="tools", task="dryrun_mesh", **row)
                mesh_rows.append(row)
    finally:
        stop_dryruns(root, procs)
    emit(phase="tools", task="dryrun_wait", seconds=time.perf_counter() - t0)
    return card, mesh_rows


def phase_tools(ops, torch, api, ref, log, train=None) -> dict:
    """The tooling slice (ROADMAP item 12): first the dry run of the train
    phase's cells and of the production meshes' cells (host processes,
    waited for before anything timed runs: nothing timed runs beside
    them); then the paper's Fig. 2 on the card (K4 and K5 through the
    projector and LMDS), the projector's three modes; the launch counts set
    to 0 before and read after (K4 and K5 must launch).  Then its kernel
    rows: each K4 and K5 class with >= 10% of the phase's launches, timed
    on a JSD n-simplex index of 50 pivots over the Fig. 2 corpus (the
    widest k; narrower classes on its prefix projectors)."""
    t = tools_modules()
    t_phase = time.perf_counter()
    dry, mesh_dry = finish_dryruns(start_dryruns(), train)
    X_np = t.colors_like(n=FIG2_ROWS, dim=DIM, seed=SEED).astype(np.float64)
    ops.reset_launches()
    fig2 = tools_fig2(torch, t, X_np)
    modes = tools_modes(torch, t)
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name in ("apex_project", "jsd_pairwise"):
        check(launches[name] > 0, f"{KERNEL_INFO[name][0]} ({name}) was not launched by the tools phase")
    emit(phase="tools", task="modes", **modes)
    for name in ("apex_project", "jsd_pairwise"):
        emit(phase="launch_shapes", launch_phase="tools", kernel=KERNEL_INFO[name][0], name=name,
             launches=launches[name], classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    torch.cuda.empty_cache()
    index = api.build_index(X_np, "jensen_shannon", n_pivots=max(FIG2_KS), seed=0, device=DEVICE)
    inputs = ShapeInputs(torch, ops, ref, index, X_np[:256], log)
    rows = kernel_rows(torch, ops, inputs, hist, "tools")
    print(json.dumps({"tools_kernels": rows}), flush=True)
    del inputs, index
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit(phase="tools", task="done", seconds=seconds)
    return dict(fig2=fig2, modes=modes, dryrun=dry, dryrun_mesh=mesh_dry, rows=rows, seconds=seconds)


def tune_row(r) -> list:
    return [r["plan"], r["max_group"], r["waves"], r["slice_rows"], r["launch"], r["valid"],
            r["us_per_call"] / 1e3]


def tune_bound(torch, ops, ref, tab, q, kernel, kw) -> tuple:
    """(bound, library ms or None) of a tune problem, as the kernel rows
    compute them: K1 against ``torch.cdist`` on the table stacked over its
    copy with the altitude negated; K2 and K3 by ``select_bound`` (K3's
    kept rows from one call at the problem's thresholds)."""
    (Q_, dims), (N_, n_) = q.shape, tab.shape
    if kernel == "apex_bounds_batch":
        T = truncated(torch, ref, tab, dims)
        S = torch.cat([T, torch.cat([T[:, :-1], -T[:, -1:]], dim=1)]).contiguous()
        lib = time_ms(torch, lambda: torch.cdist(q, S), reps=20)
        del S, T
        return roofline(N_ * n_ * 4 + q.numel() * 4 + 2 * Q_ * N_ * 4, Q_ * N_ * (2 * (dims - 1) + 12),
                        F32_FLOPS), lib
    if kernel == "apex_topk":
        return select_bound(Q_, N_, n_, dims, q.numel(), Q_ * kw["k"] * 12, Q_ * kw["k"]), None
    counts = ops.apex_bounds_threshold(tab, q, kw["thresholds"], kw["cap"], dims=dims)[3]
    kept = int(counts.clamp(max=kw["cap"]).sum())
    return select_bound(Q_, N_, n_, dims, q.numel(), Q_ * (kw["cap"] * 12 + 4), kept), None


def phase_tune(ops, torch, api, ref, data_np, queries_np) -> dict:
    """The launch-plan tuner (``kernels.tuning.autotune``) on the e2e
    phase's 1M-row n = 20 table, K1, K2 and K3 at Q = 1 and 64: every
    candidate validated against the plain version, then timed with CUDA
    events; the default plan's ms and the winner printed.  With no cache
    file every lookup is the default; no cache is written; the memo is
    reset at the end.  Each problem's bound and library ms as the kernel
    rows'."""
    from dataclasses import asdict

    from repro_torch.kernels import tuning

    t_phase = time.perf_counter()
    path = tuning.default_cache_path()
    tuning.reset_lookup_memo()
    check(not os.path.exists(path), f"the tune phase's cache {path} already exists")
    for kernel in tuning.KERNELS:
        check(tuning.lookup(kernel, N_PIVOTS, N_PIVOTS, torch.float32) == tuning.DEFAULT_CONFIG,
              f"{kernel}: lookup without a cache file is not the default")
    index = api.build_index(data_np, "euclidean", n_pivots=N_PIVOTS, seed=SEED % 1000, device=DEVICE)
    inner = index._inner
    tab = inner._kernel_table()
    ap = inner.query_apex_batch(queries_np[:max(TUNE_QS)]).float().contiguous()
    ops.reset_launches()
    sweeps = []
    for kernel in tuning.KERNELS:
        for Q_ in TUNE_QS:
            q = ap[:Q_].contiguous()
            kw = {}
            if kernel == "apex_topk":
                kw = dict(k=K, key=TUNE_KEY)
            elif kernel == "apex_threshold":
                _, U = ref.apex_bounds_batch_ref(tab, q, N_PIVOTS)
                kw = dict(cap=TUNE_CAP, thresholds=torch.kthvalue(U, K, dim=1).values.contiguous())
                del U
            space = tuning.candidate_space(tab.shape[0], Q_, kernel=kernel)
            check(tuning.DEFAULT_CONFIG in space, f"{kernel}: the default is not in the sweep")
            t0 = time.perf_counter()
            winner, rows = tuning.autotune(tab, q, kernel=kernel, dims=N_PIVOTS, candidates=space, cache=None, **kw)
            sweep_s = time.perf_counter() - t0
            by_config = {tuning.KernelConfig(r["plan"], r["max_group"], r["waves"], r["slice_rows"]): r for r in rows}
            default = by_config[tuning.DEFAULT_CONFIG]
            check(default["valid"], f"{kernel} Q={Q_}: the default plan failed validation: {default}")
            check(by_config[winner]["valid"], f"{kernel} Q={Q_}: an invalid candidate won")
            n_invalid = sum(not r["valid"] for r in rows)
            out = dict(kernel=KERNEL_INFO[kernel][0], name=kernel, Q=Q_, N=tab.shape[0], dims=N_PIVOTS,
                       candidates=len(rows), invalid=n_invalid, distinct_plans=len({str(r["launch"]) for r in rows}),
                       default=asdict(tuning.DEFAULT_CONFIG), default_launch=default["launch"],
                       default_ms=default["us_per_call"] / 1e3, winner=asdict(winner),
                       winner_launch=by_config[winner]["launch"], winner_ms=by_config[winner]["us_per_call"] / 1e3,
                       sweep_s=sweep_s, **{k_: v for k_, v in kw.items() if k_ != "thresholds"})
            (out["bound_ms"], out["bound_by"]), out["library_ms"] = tune_bound(torch, ops, ref, tab, q, kernel, kw)
            emit(phase="tune", task="sweep", **out,
                 rows_fields=["plan", "max_group", "waves", "slice_rows", "launch", "valid", "ms"],
                 rows=[tune_row(r) for r in rows])
            sweeps.append(out)
            torch.cuda.empty_cache()
    launches = dict(ops.LAUNCHES)
    for name in tuning.KERNELS:
        check(launches[name] > 0, f"{KERNEL_INFO[name][0]} ({name}) was not launched by the tune phase")
    emit(phase="launch_shapes", launch_phase="tune", launches=launches)
    del index, inner, tab, ap
    torch.cuda.empty_cache()
    tuning.reset_lookup_memo()
    check(not os.path.exists(path), "the tune phase wrote a cache file")
    check(tuning.lookup("apex_topk", N_PIVOTS, N_PIVOTS, torch.float32) == tuning.DEFAULT_CONFIG,
          "lookup after the sweeps is not the default")
    tuning.reset_lookup_memo()
    seconds = time.perf_counter() - t_phase
    emit(phase="tune", task="done", seconds=seconds)
    return dict(sweeps=sweeps, seconds=seconds)


# -- the select phase (K2/K3's whole contract) and the sharded train step ----

#: the select phase: exact k-NN at k = 300 (pass B's K3 at min(N, 16k) =
#: 4,800, past 4,096), approximate k-NN at refine = 8,192 (K2 8,192 wide on
#: the 10-wide prefix), the device filter at 8,192 slots over the 1M-row
#: table (one grid position of the card), and direct calls of K2 and K3 on
#: the index's own 1M x 20 f64 table and 8,192 / 16,384 wide on its f32 one
SELECT_KNN_K, SELECT_REFINE, SELECT_SLOTS = 300, 8192, 8192
SELECT_DIRECT = [
    ("apex_topk", (Q, K, "upb", N_PIVOTS, "float64")),
    ("apex_threshold", (Q, 512, N_PIVOTS, "float64")),
    ("apex_topk", (Q, 8192, "upb", N_PIVOTS)),
    ("apex_threshold", (Q, 16384, N_PIVOTS)),
]


def select_direct(torch, ops, ref, inner, queries_np) -> list:
    """K2 and K3 called as a user calls them, at ``SELECT_DIRECT``'s classes:
    each result held to the plain selection over K1's own matrices (in the
    table's dtype); K3's thresholds at rank cap / 2 for even queries and at
    rank 2 cap (the cap overflows) for odd ones."""
    out = []
    for name, cls in SELECT_DIRECT:
        f64 = cls[-1] == "float64"
        tab = inner.table.contiguous() if f64 else inner._kernel_table()
        ap = inner.query_apex_batch(queries_np[:cls[0]])
        ap = ap.contiguous() if f64 else ap.float().contiguous()
        L, U = ops.apex_bounds_batch(tab, ap)
        if name == "apex_topk":
            got = ops.apex_bounds_topk(tab, ap, cls[1], key=cls[2])
            want = ref.topk_from_bounds(L, U, cls[1], cls[2])
            extra = {}
        else:
            cap = cls[1]
            thr = torch.kthvalue(L, cap // 2, dim=1).values
            thr[1::2] = torch.kthvalue(L, min(2 * cap, L.shape[1]), dim=1).values[1::2]
            got = ops.apex_bounds_threshold(tab, ap, thr, cap)
            want = ref.threshold_from_bounds(L, U, thr, cap)
            extra = dict(overflowing_queries=int((got[3] > cap).sum()))
            check(bool((got[3] > cap).any()) and bool((got[3] <= cap).any()),
                  f"K3 at {cls} must hold queries below and above its cap")
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name} at {cls} differs from the plain selection over K1")
        check(got[1].dtype == tab.dtype, f"{name} at {cls} must answer in the table's dtype")
        emit(phase="select", task="direct", kernel=KERNEL_INFO[name][0], shape=list(cls), exact=True, **extra)
        out.append((name, cls))
        del L, U, got, want
        torch.cuda.empty_cache()
    return out


def phase_select(ops, torch, api, ref, metrics_mod, data_np, queries_np, index) -> dict:
    """Phase 12: K2/K3 at their whole contract through the entry points, the
    launch counts set to 0 before and read after: ``index.query`` exact
    k-NN at k = 300 and approximate k-NN at refine = 8,192 on the e2e
    euclidean index (64 queries each; 8 held to the f64 brute force, the
    approximate answers to the K2 candidates of a plain selection over K1's
    truncated matrices), ``build_distributed_filter`` at 8,192 slots on the
    1M-row f32 table (held bit-equal to its plain version,
    ``selection="sort"``, and its histogram to K1's counts), and the direct
    calls of ``select_direct``."""
    from repro_torch.search import distributed
    from repro_torch.sharding import ShardLayout, make_scaleout_mesh

    report = lambda **f: emit(phase="select", **f)  # noqa: E731
    inner = index._inner
    brute = BruteForce(torch, ref, inner.data, metrics_mod.get_metric("euclidean"))
    tol = refine_tol(torch, "euclidean", inner.data)
    qs = queries_np[:Q]
    ops.reset_launches()

    def run(task, spec):
        before = inner.overflow_queries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = list(index.query(qs, spec))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        report(task=task, queries=len(res), wall_ms=wall * 1e3, overflow_queries=inner.overflow_queries - before,
               original_calls_per_query=float(np.mean([r.stats.original_calls for r in res])))
        return res

    knn = run("knn_k300", api.Query.knn(SELECT_KNN_K))
    approx = run("approx_refine8192", api.Query.knn(K, mode="approx", dims=APPROX_DIMS, refine=SELECT_REFINE))
    # the device filter: per query a threshold at the 4,096th lwb (below the
    # slots) or the 20,000th (above), the filter's own f32 bands
    grid = make_scaleout_mesh(ShardLayout(), [torch.device(DEVICE)])
    tab = inner._kernel_table()
    ap32 = inner.query_apex_batch(qs).float().contiguous()
    L, U = ops.apex_bounds_batch(tab, ap32)
    ranks = torch.tensor([4096 if q % 2 else 20_000 for q in range(Q)], device=DEVICE)
    t_hi = torch.sort(L, dim=1).values.gather(1, ranks[:, None])[:, 0].contiguous()
    t_lo = (t_hi * 0.5).contiguous()
    topk = distributed.build_distributed_filter(grid, max_candidates=SELECT_SLOTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = topk(tab, ap32, t_hi, t_lo)
    torch.cuda.synchronize()
    filter_ms = (time.perf_counter() - t0) * 1e3
    direct = select_direct(torch, ops, ref, inner, queries_np)
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name in ("apex_topk", "apex_threshold"):
        emit(phase="launch_shapes", launch_phase="select", kernel=KERNEL_INFO[name][0], name=name,
             launches=launches[name], classes=[[list(c), n, share] for c, n, share in hist[name]])
    launched = {(name, tuple(c)) for name in hist for c, _, _ in hist[name]}
    cap300 = min(N_ROWS, 16 * SELECT_KNN_K)
    for pair in [("apex_threshold", (Q, cap300, N_PIVOTS)), ("apex_topk", (Q, SELECT_REFINE, "mid", APPROX_DIMS)),
                 ("apex_threshold", (Q, SELECT_SLOTS, N_PIVOTS))] + direct:
        check(pair in launched, f"{pair} was not launched by the select phase")

    # checks (after the counts are read)
    want = distributed.build_distributed_filter(grid, max_candidates=SELECT_SLOTS, selection="sort")(
        tab, ap32, t_hi, t_lo)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "the filter's 8,192 slots differ from its plain version")
    counts = got[0][:, 1] + got[0][:, 2]
    check(torch.equal(counts, (L <= t_hi[:, None]).sum(1)), "the filter's histogram differs from K1's counts")
    check(bool((counts > SELECT_SLOTS).any()) and bool((counts <= SELECT_SLOTS).any()),
          "the filter must hold queries below and above its slots")
    report(task="device_filter_8192", rows=N_ROWS, queries=Q, slots=SELECT_SLOTS, wall_ms=filter_ms,
           overflowing_queries=int((counts > SELECT_SLOTS).sum()))
    del L, U, got, want
    swaps = 0
    for q, r in zip(qs[:8], knn[:8]):
        ids, d64 = brute.knn(q, SELECT_KNN_K)
        swaps += agree_knn(r, ids, d64, tol)
    prefix = inner._prefix_projector(APPROX_DIMS)
    qpd = brute.cross(qs[:8], prefix.pivots_t)
    apexes = ref.apex_project_ref(qpd, prefix._Linv_t, prefix._sq_norms_t).float().contiguous()
    Lt, Ut = ops.apex_bounds_batch(tab, apexes, dims=APPROX_DIMS)
    cand = ref.topk_from_bounds(Lt, Ut, SELECT_REFINE, "mid")[0].cpu().numpy()
    recall = []
    for qi, (q, r) in enumerate(zip(qs[:8], approx[:8])):
        d64 = brute.dists(q).cpu().numpy()
        c = cand[qi].astype(np.int64)
        check(bool(np.isin(r.ids, c).all()), "approximate k-NN answered outside K2's 8,192 candidates")
        swaps += agree_knn(r, c[np.lexsort((c, d64[c]))][:K], d64, tol)
        check(r.stats.original_calls == APPROX_DIMS + SELECT_REFINE, "original_calls must be dims + refine")
        recall.append(len(np.intersect1d(r.ids, host_select(d64[None, :], None, K)[0])) / K)
    report(task="checks", knn_k300_checked=8, approx_checked=8, near_tie_differences=swaps,
           approx_recall_at_10=float(np.mean(recall)))
    del Lt, Ut
    torch.cuda.empty_cache()
    return dict(hist=hist, must=direct)


def select_kernel_rows(torch, ops, ref, rec, index, queries_np, log) -> list:
    """The select phase's kernel rows: every class it launched, timed on the
    e2e euclidean index's tables (f64 classes on its 1M x 20 f64 table)."""
    inputs = ShapeInputs(torch, ops, ref, index, queries_np, log)
    return kernel_rows(torch, ops, inputs, rec["hist"], "select", must=rec["must"])


#: the sharded train step on the card: one NCCL process per visible card on
#: a (cards, 1) mesh, the reference's sharded test's reduced mixtral (d_model
#: 64, d_ff 128, vocab 512, batch 8 x 32), 4 steps, against the one-process
#: step on the card (the qwen2 smoke config too until the run needed its 20 s;
#: the CPU tests run both); then, in the same start of the ranks, the search
#: serve cell's opt variant at full config (a world of one on one card takes
#: the path of many: the histogram all-reduce and the int64 all-gathers)
SHARDED_TRAIN = [
    ("mixtral-8x7b", ["--d-model", "64", "--d-ff", "128", "--vocab", "512"]),
]
NCCL_SEARCH = ["--arch", "nsimplex-colors", "--mode", "search", "--opt", "--steps", "3"]
SHARDED_TRAIN_TOL, SHARDED_TRAIN_TIMEOUT = 1e-5, 300
#: two gloo ranks on the one card (staged collectives), one start for the
#: runs (``--then``): (arch, (data, model), arguments, parameter
#: tolerance).  On (1, 2), tensor-parallel over model: qwen2-1.5b at full
#: width cut to 2 of 28 layers (f32), 4 train steps, a prefill at B 2 x S
#: 2,048 and 16 decode steps; mixtral-8x7b at full width cut to 1 of 32
#: layers (f32, 8 experts over model), 4 train steps, its parameters held
#: within 1e-4 of each leaf's largest magnitude.  On (2, 1) the opt train
#: cell (local dispatch: each rank its own tokens, per-shard capacity) of
#: the reference's reduced mixtral: at full width a (2, 1) mesh gathers the
#: whole 6.85 GB layer over data through host memory every step.  Each
#: checked by the launcher after the ranks exit; logits within 1e-4.
TP_RUNS = [
    ("qwen2-1.5b", (1, 2), ["--n-layers", "2", "--dtype", "float32", "--mode", "train,decode", "--batch", "2",
                            "--seq", "2048", "--decode-steps", "16", "--count-collectives"], ("max_param_diff", 1e-5)),
    ("mixtral-8x7b", (1, 2), ["--n-layers", "1", "--dtype", "float32", "--batch", "4", "--seq", "256"],
     ("max_param_rel_diff", 1e-4)),
    ("mixtral-8x7b", (2, 1), ["--smoke", "--d-model", "64", "--d-ff", "128", "--vocab", "512", "--opt"],
     ("max_param_diff", 1e-5)),
]
TP_LOSS_TOL, TP_LOGIT_TOL = 1e-5, 1e-4
#: the other families' cells on a ProcessMesh (ROADMAP item 11c.4), in the
#: same start of the two ranks after TP_RUNS, at full config: the search
#: serve cell on (2, 1), baseline and opt (1,000,000 colors rows under
#: sqrt-JSD padded to 1,007,616, 32 pivots, f32, Q 1,024, 3 timed calls
#: after the first); fm on (1, 2) (the 16,430,080 x 10 padded table split
#: over model), serve_p99 at B 512 and 2 train steps at B 512 (train_batch's
#: 65,536 cut); sasrec's retrieval_cand on (1, 2) (1M candidates); gcn-cora's
#: ogb_products at its published size on (2, 1) (2,449,029 nodes,
#: 61,859,140 edges over data), 1 train step.  Parameters within 1e-4 of
#: each leaf's largest magnitude of the one-process port on the card (GCN's
#: sums add with atomics there), outputs within 1e-4; the search cell exact
CELL_RUNS = [
    ("nsimplex-colors", (2, 1), ["--mode", "search", "--steps", "3", "--count-collectives"]),
    ("nsimplex-colors", (2, 1), ["--mode", "search", "--opt", "--steps", "3", "--count-collectives"]),
    ("fm", (1, 2), ["--mode", "train,serve", "--size", "batch=512", "--steps", "2"]),
    ("sasrec", (1, 2), ["--mode", "retrieval"]),
    ("gcn-cora", (2, 1), ["--shape", "ogb_products", "--steps", "1"]),
]
CELL_TOL = 1e-4
#: the uneven head split (ROADMAP item 11c.2b) in its own start of eight
#: gloo ranks on the one card: qwen2-1.5b's 12 heads over a model axis of 8
#: (2 heads on ranks 0-5, none on 6-7), full width cut to 1 of 28 layers,
#: f32, 2 train steps, a prefill at B 2 x S 512 and 8 decode steps
UNEVEN_RUN = ("qwen2-1.5b", (1, 8), ["--n-layers", "1", "--dtype", "float32", "--mode", "train,decode",
                                     "--batch", "2", "--seq", "512", "--steps", "2", "--decode-steps", "8"],
              ("max_param_diff", 1e-5))


def start_sharded_train_world(torch) -> list:
    """Phase 13's NCCL runs, each started in the background through the
    launcher's command line (its own process, so that it overlaps the
    tensor-parallel runs): one rank per visible card on a (cards, 1) mesh
    for each ``SHARDED_TRAIN`` config, then (``--then``) the search cell
    (``NCCL_SEARCH``).  Returns (arch, process) pairs."""
    cards = torch.cuda.device_count()
    procs = []
    world = ["--data", str(cards), "--model", "1", "--backend", "nccl", "--check",
             "--timeout", str(SHARDED_TRAIN_TIMEOUT)]
    for arch, over in SHARDED_TRAIN:
        argv = ["--arch", arch, "--smoke", *over, "--steps", "4", *world, "--then", *NCCL_SEARCH, *world]
        procs.append((arch, subprocess.Popen([sys.executable, "-m", "repro_torch.launch.process_train", *argv],
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                             start_new_session=True)))
    return procs


def stop_group(proc) -> None:
    """Kills ``proc``'s process group (a launcher and the ranks it started)
    if it is still running, and reaps it."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_sharded_train_world(procs) -> list:
    """Waits for ``start_sharded_train_world``'s launchers (stopping any
    that outlive their limit) and holds each run: every rank exits 0, the
    shards gather back, the parameters after 4 steps within 1e-5 of the
    one-process step's, the losses and gradient norms agree, int8
    compression of shards equals the whole tree's, the loss falls; the
    search cell as ``check_search``."""
    out = []
    for arch, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=2 * SHARDED_TRAIN_TIMEOUT + 120)
        finally:
            stop_group(proc)
        check(proc.returncode == 0, f"sharded train of {arch}: the launcher exited {proc.returncode}:\n"
                                    f"{stderr[-4000:]}")
        rec, search = [json.loads(x) for x in stdout.strip().splitlines() if x.startswith('{"rank"')]
        check(rec["shards_rebuild_leaves"], f"{arch}: shards do not gather back to their leaves")
        check(rec["max_param_diff"] <= SHARDED_TRAIN_TOL,
              f"{arch}: parameters differ from the one-process step by {rec['max_param_diff']}")
        check(bool(np.allclose(rec["losses"], rec["one_process_losses"], rtol=SHARDED_TRAIN_TOL)),
              f"{arch}: losses differ from the one-process step")
        check(bool(np.allclose(rec["grad_norms"], rec["one_process_grad_norms"], rtol=SHARDED_TRAIN_TOL)),
              f"{arch}: gradient norms differ from the one-process step")
        check(rec["compress_max_diff"] == 0.0, f"{arch}: int8 compression of shards differs")
        check(rec["losses"][-1] < rec["losses"][0], f"{arch}: the loss did not fall")
        emit(phase="sharded_train", arch=arch, **rec)
        check_search("nsimplex-colors nccl opt", True, search)
        emit(phase="sharded_train", arch="nsimplex-colors", **search)
        out += [rec, search]
    return out


def _tp_argv(process_train, runs, backend_args, root) -> list:
    """The launcher's arguments for ``runs`` (arch, mesh, arguments, ...)
    in one start of the ranks, each checked, shards under ``root``."""
    argv = []
    for i, (arch, (data, model), over, *_) in enumerate(runs):
        argv += ([process_train.THEN] if i else []) + [
            "--arch", arch, *over, "--data", str(data), "--model", str(model), *backend_args, "--check",
            "--out", str(root / str(i)), "--timeout", str(SHARDED_TRAIN_TIMEOUT)]
    return argv


def check_tp(arch, mesh, over, key, tol, rec) -> None:
    """A tensor-parallel LM run: every rank exits 0, its shards gather back
    to their leaves (a split leaf 1/|model| of it), the transport is the
    staged one, the parameters after the train steps, the losses and
    gradient norms, the prefill and every decode step's logits and the
    cache agree with the one-process port on the card; an opt cell
    dispatched locally over its batch shards."""
    what = f"{arch} {mesh} {' '.join(over)}"
    check(rec["mesh"] == list(mesh), f"{what}: ran on {rec['mesh']}")
    check(rec["shards_rebuild_leaves"], f"{what}: shards do not gather back to their leaves")
    check(all("staged" in r["transport"] for r in rec["ranks"]), f"{what}: transport {rec['transport']}")
    check(all(r["param_bytes"] < r["whole_param_bytes"] for r in rec["ranks"]),
          f"{what}: a rank holds the whole model")
    check(bool(np.allclose(rec["losses"], rec["one_process_losses"], rtol=TP_LOSS_TOL)),
          f"{what}: losses {rec['losses']} against {rec['one_process_losses']}")
    check(bool(np.allclose(rec["grad_norms"], rec["one_process_grad_norms"], rtol=TP_LOSS_TOL)),
          f"{what}: gradient norms {rec['grad_norms']} against {rec['one_process_grad_norms']}")
    check(rec[key] <= tol, f"{what}: parameters differ by {rec[key]} ({key})")
    check(rec["compress_max_diff"] == 0.0, f"{what}: int8 compression of shards differs")
    if "--opt" in over:
        check(rec["moe_dispatch"] == {"dispatch": "local", "n_batch_shards": mesh[0]},
              f"{what}: dispatch {rec['moe_dispatch']}")
    if "prefill_ms" in rec:
        check(rec["max_prefill_logit_diff"] <= TP_LOGIT_TOL, f"{what}: prefill logits differ")
        check(max(rec["max_decode_logit_diff"]) <= TP_LOGIT_TOL, f"{what}: decode logits differ")
        check(rec["max_cache_diff"] <= TP_LOGIT_TOL and rec["cache_pos_equal"]
              and rec["cache_is_its_spec_shard"], f"{what}: the cache differs")


def check_search(what, opt, rec) -> None:
    """The search serve cell: every rank's histograms and slots equal the
    one-process grid's, summing to the padded table, no padding row a
    candidate; each rank launched K4 and K3 (opt) or K1 (baseline), and
    its K4, K3 and K1 outputs agree with their plain versions."""
    check(rec["search_equal_one_process"], f"{what}: differs from the one-process grid")
    check(rec["hist_sums_to_padded_rows"] and rec["padding_never_candidate"] and rec["padding_excluded"],
          f"{what}: a padding row was counted or picked")
    for r in rec["ranks"]:
        kc, n = r["kernel_checks"], r["launches"]
        if opt:
            check(n.get("apex_project", 0) > 0 and n.get("apex_threshold", 0) > 0, f"{what}: launches {n}")
            check(kc["apex_project"] <= K4_F32_TOL and kc["apex_threshold"]["equal_to_plain_selection"],
                  f"{what}: K4 or K3 differs from its plain version: {kc}")
        else:
            check(n.get("apex_bounds_batch", 0) > 0, f"{what}: launches {n}")
        if "apex_bounds_batch" in kc:
            check(kc["apex_bounds_batch"]["max_abs_err"] <= F32_TOL, f"{what}: K1 differs from plain: {kc}")


def check_cell(arch, mesh, over, rec) -> None:
    """A RecSys or GCN cell: the parameters after the train steps within
    ``CELL_TOL`` of each leaf's largest magnitude, losses and gradient
    norms at 1e-5, serve and retrieval outputs within ``CELL_TOL``; each
    rank's table rows 1/|model| of the whole."""
    what = f"{arch} {mesh} {' '.join(over)}"
    check(rec["mesh"] == list(mesh), f"{what}: ran on {rec['mesh']}")
    if "losses" in rec:
        check(rec["shards_rebuild_leaves"], f"{what}: shards do not gather back to their leaves")
        check(rec["max_param_rel_diff"] <= CELL_TOL, f"{what}: parameters differ by {rec['max_param_rel_diff']}")
        check(bool(np.allclose(rec["losses"], rec["one_process_losses"], rtol=TP_LOSS_TOL)),
              f"{what}: losses {rec['losses']} against {rec['one_process_losses']}")
        check(bool(np.allclose(rec["grad_norms"], rec["one_process_grad_norms"], rtol=TP_LOSS_TOL)),
              f"{what}: gradient norms {rec['grad_norms']} against {rec['one_process_grad_norms']}")
    for mode in ("serve", "retrieval"):
        if f"max_{mode}_rel_diff" in rec:
            check(rec[f"max_{mode}_rel_diff"] <= CELL_TOL, f"{what}: {mode} differs by {rec[f'max_{mode}_rel_diff']}")
    if mesh[1] > 1:
        check(all(r["param_bytes"] < r["whole_param_bytes"] for r in rec["ranks"]), f"{what}: a rank holds it all")


def dryrun_decode_bytes(seq: int, batch: int) -> dict:
    """The dry run's meta walk of qwen2-1.5b's decode step at full width, 2
    layers, f32, B ``batch`` over a ``seq``-token cache on a (1, 2) mesh:
    its collective bytes by kind on rank 0 (a fake process group in this
    process, destroyed on return)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import meta_process_mesh
    from repro_torch.launch.op_walk import walk
    from repro_torch.launch.steps import build_cell

    cfg = dataclasses.replace(get_arch("qwen2-1.5b").model_cfg, n_layers=2, dtype="float32")
    with meta_process_mesh(("data", "model"), (1, 2)) as mesh:
        plan = build_cell("qwen2-1.5b", "decode_32k", mesh, model_cfg=cfg,
                          sizes={"seq_len": seq, "global_batch": batch})
        return walk(plan.fn, *dryrun.rank_args(plan, mesh)).collective_bytes


def check_counted(runs, recs) -> None:
    """The runs under ``--count-collectives``: each rank's counted bytes of
    every mode printed beside ``TensorParallel.moved``; qwen2's counted
    decode step on (1, 2) equal by kind to the dry run's walk of the cell
    (B 2, cache S + 16 = 2,064)."""
    t0 = time.perf_counter()
    for (arch, mesh, over, *_), rec in zip(runs, recs):
        if "--count-collectives" not in over:
            continue
        for r in rec["ranks"]:
            check(bool(r.get("collectives")), f"{arch} {mesh}: rank {r['rank']} counted no collective")
            emit(phase="sharded_train", part="collectives", arch=arch, mesh_shape=list(mesh), rank=r["rank"],
                 note=rec.get("note"), collectives=r["collectives"],
                 moved_per_decode_step=rec.get("model_collective_bytes_per_decode_step"))
        if arch == "qwen2-1.5b":
            seq = int(over[over.index("--seq") + 1]) + int(over[over.index("--decode-steps") + 1])
            dry = dryrun_decode_bytes(seq, int(over[over.index("--batch") + 1]))
            for r in rec["ranks"]:
                live = r["collectives"]["decode"]["counted"]
                check(live == dry, f"{arch} {mesh} rank {r['rank']}: a decode step counted {live}, the dry run {dry}")
            emit(phase="sharded_train", part="collectives_vs_dryrun", arch=arch, mesh_shape=list(mesh), seq=seq,
                 dryrun=dry, equal=True)
    emit(phase="sharded_train", part="collectives_check", seconds=time.perf_counter() - t0)


def sharded_train_tp(torch, process_train) -> tuple:
    """Phase 13's runs on one card: two ranks on card 0 (``--backend gloo
    --device cuda``), started once, for ``TP_RUNS`` and ``CELL_RUNS``; then
    eight for ``UNEVEN_RUN``.  Each run checked (``check_tp``,
    ``check_search``, ``check_cell``).  Returns (the records, the search
    cell's kernel rows)."""
    root = Path(__file__).resolve().parent / "build" / "tp_smoke"
    shutil.rmtree(root, ignore_errors=True)
    gloo = ["--backend", "gloo", "--device", "cuda"]
    fresh_peak(torch)
    t0 = time.perf_counter()
    rc, recs, bad = process_train.launch(_tp_argv(process_train, TP_RUNS + CELL_RUNS, gloo, root))
    wall = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    check(rc == 0, f"two ranks' runs: ranks failed: {bad}")
    for (arch, mesh, over, *tol), rec in zip(TP_RUNS + CELL_RUNS, recs, strict=True):
        if tol:
            check_tp(arch, mesh, over, *tol[0], rec)
        elif arch == "nsimplex-colors":
            check_search(f"{arch} {mesh} {' '.join(over)}", "--opt" in over, rec)
        else:
            check_cell(arch, mesh, over, rec)
        emit(phase="sharded_train", arch=arch, mesh_shape=list(mesh), launch_wall_s=wall, **rec)
    emit(phase="sharded_train", part="tp_launch", runs=len(recs), wall_s=wall,
         chip_smoke_peak=torch.cuda.max_memory_allocated())
    check_counted(TP_RUNS + CELL_RUNS, recs)
    search = [rec for (arch, *_), rec in zip(CELL_RUNS, recs[len(TP_RUNS):]) if arch == "nsimplex-colors"]
    rows = process_search_kernel_rows(torch, process_train, search)
    fresh_peak(torch)
    t0 = time.perf_counter()
    rc, uneven, bad = process_train.launch(_tp_argv(process_train, [UNEVEN_RUN], gloo, root))
    wall = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    check(rc == 0, f"eight ranks' run: ranks failed: {bad}")
    arch, mesh, over, tol = UNEVEN_RUN
    check_tp(arch, mesh, over, *tol, uneven[0])
    emit(phase="sharded_train", arch=arch, mesh_shape=list(mesh), launch_wall_s=wall, **uneven[0])
    return recs + uneven, rows


def process_search_kernel_rows(torch, process_train, recs) -> list:
    """The search cell's kernel rows on a rank: K4 (1,024, 32, f32), K3
    (1,024, 8, 32) over a rank's 503,808 rows, K1 (1,024, 32) on one of
    the baseline's row tiles and K1 at the opt cell's overflow completion,
    on rank 0's inputs (``process_train.search_inputs``, this process's
    copy: the launcher's check drew it), each against its plain version;
    launches: the ranks' first call of the step (``recs``: baseline, opt)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.simplex import apex_addition
    from repro_torch.kernels import ops, ref
    from repro_torch.search.distributed import _TILE_ELEMS, _bands

    base, opt = sorted(recs, key=lambda r: "OPT" in r["note"])
    cfg = get_arch("nsimplex-colors").model_cfg
    sizes = {"n_objects": cfg.n_objects, "query_batch": cfg.query_batch, "n_pivots": cfg.n_pivots}
    table, Linv, sq, sigma, qd, t = process_train.search_inputs(cfg, sizes, torch.device("cuda", 0))
    Q_, n = qd.shape
    local = table[:opt["rows_local"]]
    check(base["rows_local"] == opt["rows_local"], "the two variants split the table alike")

    def launched(rec, name, Q=None):
        return sum(c for r in rec["ranks"] for cls, c in r["shape_launches"].get(name, [])
                   if Q is None or cls[0] == Q)

    def timed(run, plain, err, b, shape, lib=None, plain_reps=None):
        big = b[0] > 1.0
        return dict(shape=shape, max_abs_err=err, ms=time_ms(torch, run, reps=10 if big else 50),
                    plain_ms=time_ms(torch, plain, reps=plain_reps or (2 if big else 10)), bound=b,
                    library_ms=lib, device_ms=device_ms(torch, run))

    rows = []
    # K4: the opt cell's projection of the query block
    proj = ops.apex_project(qd, Linv, sq)
    h = n - 1
    m = timed(lambda: ops.apex_project(qd, Linv, sq), lambda: ref.apex_project_ref(qd, Linv, sq),
              check_k4(torch, proj, ref.apex_project_ref(qd, Linv, sq), K4_F32_TOL),
              roofline(2 * Q_ * n * 4 + (h * h + h) * 4, Q_ * (2 * h * h + 4 * h + 4), F32_FLOPS),
              [Q_, n, "float32"])
    rows.append(kernel_row("apex_project", m, launched(opt, "apex_project"), None))
    # K3: the opt cell's selection over a rank's rows, into 8 slots
    t_hi = _bands(t, None, 1e-5, Q_, local.device)[0]
    cap = 8
    got = ops.apex_bounds_threshold(local, proj, t_hi, cap)
    for lo in range(0, Q_, 64):
        L, U = ops.apex_bounds_batch(local, proj[lo:lo + 64])
        want = ref.threshold_from_bounds(L, U, t_hi[lo:lo + 64], cap)
        check(all(torch.equal(g[lo:lo + 64], w) for g, w in zip(got, want)),
              "K3 on a rank's rows differs from the plain selection over K1's bounds")
    del L, U, want
    counts = got[3].to(torch.int64)
    kept = int(counts.clamp(max=cap).sum())
    chunks = [(lo, min(lo + 256, Q_)) for lo in range(0, Q_, 256)]

    def plain_k3():
        for lo, hi in chunks:
            ref.apex_threshold_ref(local, proj[lo:hi], t_hi[lo:hi], cap, n)

    m = timed(lambda: ops.apex_bounds_threshold(local, proj, t_hi, cap), plain_k3, 0.0,
              select_bound(Q_, local.shape[0], n, n, proj.numel(), Q_ * (cap * 12 + 4), kept),
              [Q_, cap, n], plain_reps=2)
    m["plain_in_chunks_of"] = 256
    m["mean_count"] = float(counts.double().mean())
    rows.append(kernel_row("apex_threshold", m, launched(opt, "apex_threshold"), None))
    # K1: a row tile of the baseline's sort selection (Algorithm 2's
    # queries), and the opt cell's completion for its overflowing queries
    paper = apex_addition(sigma, qd)
    over = torch.nonzero(counts > cap).flatten()
    for rec, q in ((base, paper), (opt, proj[over])):
        tile = local[:max(1, _TILE_ELEMS // max(1, q.shape[0]))]
        if not q.shape[0]:
            continue
        lwb, upb = ops.apex_bounds_batch(tile, q)
        w = ref.apex_bounds_batch_ref(tile, q, n)
        err = max(max_err(torch, lwb, w[0], F32_TOL), max_err(torch, upb, w[1], F32_TOL))
        del lwb, upb, w
        S = torch.cat([tile, torch.cat([tile[:, :-1], -tile[:, -1:]], dim=1)]).contiguous()
        lib = time_ms(torch, lambda: torch.cdist(q, S), reps=20)
        del S
        m = timed(lambda: ops.apex_bounds_batch(tile, q), lambda: ref.apex_bounds_batch_ref(tile, q, n), err,
                  bound(q.shape[0], tile.shape[0], n, 4, 2 * q.shape[0] * tile.shape[0] * 4, F32_FLOPS),
                  [q.shape[0], n], lib)
        m["tile_rows"] = tile.shape[0]
        rows.append(kernel_row("apex_bounds_batch", m, launched(rec, "apex_bounds_batch", q.shape[0]), None))
    for row in rows:
        row["launch_phase"] = "process_search"
        row["rows_local"] = opt["rows_local"]
    emit(phase="sharded_train", part="process_search_kernels", rows=rows)
    return rows


def phase_sharded_train(torch) -> tuple:
    """Phase 13: ``python -m repro_torch.launch.process_train`` with
    ``--check``: the NCCL world (``start_sharded_train_world``) in the
    background beside the runs of two ranks, then eight, on one card
    (``sharded_train_tp``).  Returns (the records, the search cell's kernel
    rows)."""
    from repro_torch.launch import process_train

    src = str(Path(__file__).resolve().parent / "src")
    os.environ["PYTHONPATH"] = src + (os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else "")
    world = start_sharded_train_world(torch)
    try:
        tp, rows = sharded_train_tp(torch, process_train)
    except BaseException:
        for _, proc in world:
            stop_group(proc)
        raise
    recs = finish_sharded_train_world(world) + tp
    process_train._search_inputs.cache_clear()
    return recs, rows


#: ``train_lm --full-100m`` (lm-100m, 12 layers, d_model 768: the
#: walkthrough's full width) on the card: steps
EXAMPLES_FULL_100M_STEPS = 10
#: the examples phase's kernel rows are timed on a sqrt-JSD colors table of
#: this many rows (quickstart's; the walkthroughs' tables hold 2,000-20,000)
EXAMPLES_TABLE_ROWS = 9_000
#: the position in a launch class of the pivots a table needs to serve it:
#: K6's and K4's own width, K1-K3's bound width (dims); K5's need none
CLASS_PIVOTS = {"apex_bounds": 0, "apex_project": 1, "apex_bounds_batch": 1, "apex_topk": 3, "apex_threshold": 2}


def examples_runs(reference) -> list:
    """(walkthrough, flags) of the examples phase: each walkthrough under
    the flags of its reference run, then train_lm at full width."""
    from repro_torch.examples import WALKTHROUGHS

    runs = [(name, list(reference[name]["reference_run"]["argv"])) for name in WALKTHROUGHS]
    return runs + [("train_lm", ["--full-100m", "--steps", str(EXAMPLES_FULL_100M_STEPS)])]


def examples_kernel_rows(torch, ops, api, ref, hist, log) -> list:
    """The kernels line's rows of the examples phase: each kernel's most
    launched class there, held to its plain version and timed
    (``kernel_rows``) on an ``EXAMPLES_TABLE_ROWS``-row sqrt-JSD colors
    index with as many pivots as the class needs (``CLASS_PIVOTS``; 20 for
    K5), its corpus 20,256 rows, a 6.27% row mask (filtered_search's
    predicate's share) for a masked class."""
    from repro_torch.data import colors_like

    X = colors_like(n=20_256, dim=DIM, seed=SEED)
    corpus = torch.as_tensor(X, device="cuda")
    top = {name: hist[name][0] for name in KERNEL_INFO if hist.get(name)}
    by_pivots = {}
    for name, (cls, _, _) in top.items():
        by_pivots.setdefault(cls[CLASS_PIVOTS[name]] if name in CLASS_PIVOTS else N_PIVOTS, []).append(name)
    rows = []
    for n_piv, names in sorted(by_pivots.items()):
        index = api.build_index(X[:EXAMPLES_TABLE_ROWS], "jensen_shannon", n_pivots=n_piv, seed=SEED % 1000,
                                device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        mask = (torch.rand(EXAMPLES_TABLE_ROWS, generator=gen, device="cuda") < 0.0627).to(torch.uint8)
        inputs = ShapeInputs(torch, ops, ref, index, X[EXAMPLES_TABLE_ROWS:EXAMPLES_TABLE_ROWS + 256], log,
                             corpus, mask)
        rows += kernel_rows(torch, ops, inputs, {name: [top[name]] for name in names}, "examples")
        del inputs, index
        torch.cuda.empty_cache()
    return rows


def phase_examples(ops, torch, api, ref, log) -> list:
    """Phase 14: every walkthrough of ``repro_torch.examples`` in-process on
    the card, each in a fresh temporary directory (train_lm's checkpoints):
    its own assertions (exactness against brute force, bit-identical
    bursts and recoveries, training reduces the loss) raise; its summary
    held to ``reference_summaries.json`` (``summary.compare``: exact fields
    equal, f64 values within their relative tolerance, each count within
    the run's margin: the decisions whose f64 bound lies in the f32 slack
    band of its threshold, ``summary.f32_band``; a ``BRIDGED`` walkthrough,
    on its own random parameters, by its exact fields alone); each
    walkthrough's seconds and kernel launches (the delta of
    ``ops.LAUNCHES`` around its ``main``) printed; K1-K6 each launched by
    some walkthrough, K3 by mesh_scaleout's device filter on its four grid
    positions of the card; the phase's launches by shape class printed
    (``launch_shapes``) and its kernel rows returned
    (``examples_kernel_rows``)."""
    import importlib

    from repro_torch.examples import summary as S

    reference = S.load_reference()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    totals = dict.fromkeys(KERNEL_INFO, 0)
    shapes_before = {name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()}
    out = {}
    try:
        for i, (name, argv) in enumerate(examples_runs(reference)):
            flags = ["--device", "cuda", *argv]
            if name == "train_lm":
                flags += ["--ckpt-dir", str(root / f"ckpt_{i}")]
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            got = importlib.import_module(f"repro_torch.examples.{name}").main(flags)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {KERNEL_INFO[k][0]: ops.LAUNCHES[k] - before[k] for k in KERNEL_INFO}
            for k in KERNEL_INFO:
                totals[k] += ops.LAUNCHES[k] - before[k]
            held = []
            if "--full-100m" not in argv:
                held = ["exact"] if name in S.BRIDGED else ["exact", "close", "counts"]
                bad = S.compare(got, reference[name], sections=held)
                check(not bad, f"examples: {name} differs from reference_summaries.json: {bad}")
            emit(phase="examples", walkthrough=name, argv=argv, seconds=seconds, launches=launches, held=held,
                 counts=got["counts"], margins=got["margins"], walls=got["seconds"],
                 losses=got["close"].get("losses"))
            out[name if "--full-100m" not in argv else "train_lm_full_100m"] = dict(seconds=seconds,
                                                                                   launches=launches)
        check(out["mesh_scaleout"]["launches"]["K3"] > 0, "examples: mesh_scaleout's device filter launched no K3")
        for name, (kid, _, _) in KERNEL_INFO.items():
            check(totals[name] > 0, f"examples: no walkthrough launched {kid} ({name})")
        emit(phase="examples", total_launches={KERNEL_INFO[k][0]: v for k, v in totals.items()},
             seconds=sum(r["seconds"] for r in out.values()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    hist = launch_histogram({name: {cls: n - shapes_before[name].get(cls, 0) for cls, n in by.items()
                                    if n > shapes_before[name].get(cls, 0)}
                             for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        emit(phase="launch_shapes", launch_phase="examples", kernel=kid, name=name, launches=totals[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    rows = examples_kernel_rows(torch, ops, api, ref, hist, log)
    emit(phase="examples", kernel_rows_seconds=time.perf_counter() - t0)
    return rows


class Laps:
    """Seconds between successive calls, by the name given at each call."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def __call__(self, name):
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


def bind_peaks():
    """The published H100 peaks from their one home in the port."""
    from repro_torch.launch import roofline as peaks

    global HBM_BPS, F32_FLOPS, F64_FLOPS, BF16_FLOPS
    HBM_BPS, F32_FLOPS, F64_FLOPS, BF16_FLOPS = peaks.HBM_BW, peaks.F32_FLOPS, peaks.F64_FLOPS, peaks.PEAK_FLOPS


def main(argv=None) -> int:
    """Runs ``run`` with the kernel tuning cache pointed at a fresh
    temporary path (no phase reads a tuning file left on the machine),
    removed at the end."""
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TORCH_KERNEL_TUNE_CACHE"] = os.path.join(tune_dir, "kernel_tuning.json")
    try:
        return run(argv)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--time-shapes", metavar="JSON", default=None,
                        help='only time the wrappers at these [[kernel, shape class], ...] on a fresh '
                             'apex_dims=10 JSD build (no e2e phases); prints {"shape_times": [...]}')
    parser.add_argument("--approx-only", action="store_true",
                        help="only run the approximate phase (both metrics) and its checks")
    parser.add_argument("--mechanisms-only", action="store_true",
                        help="only run the mechanisms phase (LAESA at 1M rows, the five-mechanism engine) "
                             "and its checks")
    parser.add_argument("--launch-path", action="store_true",
                        help="only time each step of K4's query path at (1, 20, f64), three rounds")
    parser.add_argument("--ptxas", action="store_true",
                        help="only print registers and spills of apex_project.cu's kernels (nvcc -Xptxas -v)")
    parser.add_argument("--filtered-only", action="store_true",
                        help="only run the filtered phase (both metrics) and its checks")
    parser.add_argument("--online-only", action="store_true",
                        help="only run the online phase (both metrics) and its checks")
    parser.add_argument("--sharded-only", action="store_true",
                        help="only run the sharded phase (both metrics) and its checks")
    parser.add_argument("--durable-only", action="store_true",
                        help="only run the durable phase (both metrics) and its checks")
    parser.add_argument("--serving-only", action="store_true",
                        help="only run the serving phase (the CLI's shard_map engine, SearchService per metric, "
                             "the multi-tenant HTTP front end, the CLI as a subprocess) and its checks")
    parser.add_argument("--models-only", action="store_true",
                        help="only run the models phase (every registry arch at its smoke config, qwen2-1.5b "
                             "at full size, mixtral-8x7b at full width, the RecSys and GCN cells) and its checks")
    parser.add_argument("--train-only", action="store_true",
                        help="only run the train phase (every smoke arch against the CPU, qwen2-1.5b at full "
                             "config, mixtral-8x7b at full width, the RecSys and GCN train cells, the serve_1m "
                             "cell, the train CLI) and its checks")
    parser.add_argument("--tools-only", action="store_true",
                        help="only run the tools phase (the paper's Fig. 2 on the card, the projector's three "
                             "modes, the dry run of the train phase's cells) and its checks")
    parser.add_argument("--tune-only", action="store_true",
                        help="only run the tune phase (the launch-plan tuner over K1, K2 and K3 on the 1M-row "
                             "table at Q = 1 and 64) and its checks")
    parser.add_argument("--select-only", action="store_true",
                        help="only run the select phase (K2/K3 in f64 and wider than 4,096 through exact k-NN at "
                             "k = 300, approximate k-NN at refine = 8,192, the device filter at 8,192 slots and "
                             "direct calls) and its checks")
    parser.add_argument("--sharded-train-only", action="store_true",
                        help="only run the sharded train phase (one NCCL process per visible card on a (cards, 1) "
                             "mesh against the one-process step on the card)")
    parser.add_argument("--examples-only", action="store_true",
                        help="only run the examples phase (every walkthrough of repro_torch.examples on the card, "
                             "held to reference_summaries.json) and its checks")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the attribute columns and of the online phase's rows and mutations")
    args = parser.parse_args(argv)
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    bind_peaks()
    from repro_torch import api, filter as filter_mod, metrics as metrics_mod
    from repro_torch.data import colors_like
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import service as service_mod
    from repro_torch import search as search_mod
    from repro_torch import store as store_mod

    smi = nvidia_smi()
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), host_yardstick_s=host_yardstick())
    if args.ptxas:
        emit(phase="ptxas", **ptxas_report(build))
        print(smi, flush=True)
        return 0
    t0 = time.perf_counter()
    build.library()
    emit(phase="build", seconds=time.perf_counter() - t0, nvcc_flags=list(build.NVCC_FLAGS))
    if args.launch_path:
        from repro_torch.core import NSimplexProjector, select_pivots

        X = colors_like(n=4096, dim=DIM, seed=SEED)
        proj = NSimplexProjector(select_pivots(X[:4000], N_PIVOTS, seed=SEED % 1000),
                                 metrics_mod.get_metric("euclidean"), device="cuda")
        q = torch.as_tensor(X[4000], device="cuda")
        for round_ in range(3):
            emit(phase="launch_path", round=round_, shape=[1, N_PIVOTS, "float64"],
                 steps=launch_path(torch, ops, build, proj, q))
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    if args.models_only:
        phase_models(ops, torch)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    if args.train_only:
        phase_train(ops, torch)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    if args.sharded_train_only:
        print(json.dumps({"process_search_kernels": phase_sharded_train(torch)[1]}), flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    log = log_cost(build)
    emit(phase="build", log_fp64=log)
    if args.examples_only:
        print(json.dumps({"examples_kernels": phase_examples(ops, torch, api, ref, log)}), flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    if args.tools_only:
        phase_tools(ops, torch, api, ref, log)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    X = colors_like(n=N_ROWS + 256, dim=DIM, seed=SEED)
    data_np, queries_np = X[:N_ROWS], X[N_ROWS:]
    emit(phase="data", rows=N_ROWS, dim=DIM, dtype=str(X.dtype), wall_s=time.perf_counter() - t0)
    if args.tune_only:
        phase_tune(ops, torch, api, ref, data_np, queries_np)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0

    if args.time_shapes is not None:
        index = api.build_index(data_np, "jensen_shannon", n_pivots=N_PIVOTS, seed=SEED % 1000,
                                apex_dims=APPROX_DIMS, refine=REFINE, device="cuda")
        inputs = ShapeInputs(torch, ops, ref, index, queries_np, log)
        shape_rows = time_shapes(torch, ops, ref, inputs, json.loads(args.time_shapes))
        print(json.dumps({"shape_times": [dict(name=name, **m) for name, m in shape_rows]}), flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0

    mech_mods = (torch, api, metrics_mod, search_mod, ref, data_np, queries_np)
    if args.mechanisms_only:
        mech_hist, mech_index = phase_mechanisms(ops, *mech_mods)
        corpus = torch.as_tensor(data_np, device="cuda")
        inputs = ShapeInputs(torch, ops, ref, mech_index, queries_np, log, corpus)
        print(json.dumps({"mechanisms_kernels": kernel_rows(torch, ops, inputs, mech_hist, "mechanisms")}),
              flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    sharded_mods = (ops, torch, api, service_mod, ref, metrics_mod, data_np, queries_np, args.seed)
    if args.sharded_only:
        sharded = phase_sharded(*sharded_mods)
        verify_sharded(torch, ops, ref, metrics_mod, sharded)
        print(json.dumps({"sharded_kernels": sharded_kernel_rows(torch, ops, ref, sharded, data_np, queries_np, log)}),
              flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    attrs = make_attributes(N_ROWS, args.seed)
    emit(phase="data", attribute_rows=N_ROWS, wall_s=time.perf_counter() - t0)
    durable_mods = (ops, torch, api, filter_mod, store_mod, ref, metrics_mod, data_np, queries_np, attrs, args.seed)
    if args.durable_only:
        durable = phase_durable(*durable_mods)
        verify_online(torch, ref, metrics_mod, durable, phase="durable")
        print(json.dumps({"durable_kernels": durable_kernel_rows(torch, ops, ref, durable, queries_np, log)}),
              flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    if args.online_only:
        online = phase_online(ops, torch, api, filter_mod, ref, metrics_mod, data_np, queries_np, attrs, args.seed)
        verify_online(torch, ref, metrics_mod, online)
        print(json.dumps({"online_kernels": online_kernel_rows(torch, ops, ref, online, queries_np, log)}),
              flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    euclid = api.build_index(data_np, "euclidean", n_pivots=N_PIVOTS, seed=SEED % 1000, device="cuda")
    torch.cuda.synchronize()
    emit(phase="e2e", metric="euclidean", task="build", rows=N_ROWS, wall_s=time.perf_counter() - t0)
    store = filter_mod.AttributeStore(ATTR_SCHEMA)
    store.put(np.arange(N_ROWS), attrs)
    serving_mods = (ops, torch, api, filter_mod, service_mod, data_np, queries_np)
    if args.serving_only:
        jsd_exact = api.build_index(data_np, "jensen_shannon", n_pivots=N_PIVOTS, seed=SEED % 1000, device="cuda")
        serving = phase_serving(*serving_mods, {"euclidean": euclid, "jensen_shannon": jsd_exact}, args.seed)
        verify_serving(torch, ops, ref, metrics_mod, serving)
        print(json.dumps({"serving_kernels": serving_kernel_rows(torch, ops, ref, serving, queries_np, log)}),
              flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    if args.filtered_only:
        jsd_exact = api.build_index(data_np, "jensen_shannon", n_pivots=N_PIVOTS, seed=SEED % 1000, device="cuda")
        filtered = phase_filtered(ops, torch, api, filter_mod, ref, metrics_mod,
                                  {"euclidean": euclid, "jensen_shannon": jsd_exact}, queries_np, store, attrs)
        verify_filtered(torch, ops, ref, filtered)
        print(json.dumps({"filtered_kernels": filtered_kernel_rows(torch, ops, ref, filtered, queries_np, log)}),
              flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0

    if args.select_only:
        sel = phase_select(ops, torch, api, ref, metrics_mod, data_np, queries_np, euclid)
        print(json.dumps({"select_kernels": select_kernel_rows(torch, ops, ref, sel, euclid, queries_np, log)}),
              flush=True)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0
    mods = (torch, api, metrics_mod, service_mod, ref, data_np, queries_np)
    if args.approx_only:
        approx_runs = [phase_approx(*mods, "euclidean", index=euclid), phase_approx(*mods, "jensen_shannon")]
        for rec in approx_runs:
            verify_approx(torch, ops, ref, rec)
        emit(phase="host", host_yardstick_s=host_yardstick())
        print(smi, flush=True)
        return 0

    lap = Laps()
    inner = euclid._inner
    ap32 = inner.query_apex_batch(queries_np[:Q]).float().contiguous()
    phase_kernels(torch, ops, ref, inner._kernel_table(), ap32)
    phase_kernels_k4_k5(torch, ops, ref, inner, inner.data, torch.as_tensor(queries_np, device="cuda"))
    del inner, ap32
    torch.cuda.empty_cache()

    ops.reset_launches()
    phase_e2e(*mods, "euclidean", index=euclid)
    approx_runs = [phase_approx(*mods, "euclidean", index=euclid)]
    jsd_exact = phase_e2e(*mods, "jensen_shannon")
    approx_runs.append(phase_approx(*mods, "jensen_shannon"))
    launches = dict(ops.LAUNCHES)
    hist = launch_histogram({name: dict(by) for name, by in ops.SHAPE_LAUNCHES.items()})
    for name, (kid, _, _) in KERNEL_INFO.items():
        check(launches[name] > 0, f"{kid} ({name}) was not launched by the e2e and approx phases")
        emit(phase="launch_shapes", kernel=kid, name=name, launches=launches[name],
             classes=[[list(cls), n, share] for cls, n, share in hist[name]])
    for rec in approx_runs:
        verify_approx(torch, ops, ref, rec)
    lap("kernels_e2e_approx")
    # K2/K3 in f64 and wider than 4,096, on the e2e euclidean index
    sel = phase_select(ops, torch, api, ref, metrics_mod, data_np, queries_np, euclid)
    select_rows = select_kernel_rows(torch, ops, ref, sel, euclid, queries_np, log)
    print(json.dumps({"select_kernels": select_rows}), flush=True)
    del sel
    torch.cuda.empty_cache()
    lap("select")
    # filtered search on the same two exact indexes, then the online index
    filtered = phase_filtered(ops, torch, api, filter_mod, ref, metrics_mod,
                              {"euclidean": euclid, "jensen_shannon": jsd_exact}, queries_np, store, attrs)
    verify_filtered(torch, ops, ref, filtered)
    torch.cuda.empty_cache()
    lap("filtered")
    online = phase_online(ops, torch, api, filter_mod, ref, metrics_mod, data_np, queries_np, attrs, args.seed)
    verify_online(torch, ref, metrics_mod, online)
    torch.cuda.empty_cache()
    lap("online")
    sharded = phase_sharded(*sharded_mods)
    verify_sharded(torch, ops, ref, metrics_mod, sharded)
    torch.cuda.empty_cache()
    lap("sharded")
    durable = phase_durable(*durable_mods)
    verify_online(torch, ref, metrics_mod, durable, phase="durable")
    torch.cuda.empty_cache()
    lap("durable")
    serving = phase_serving(*serving_mods, {"euclidean": euclid, "jensen_shannon": jsd_exact}, args.seed)
    verify_serving(torch, ops, ref, metrics_mod, serving)
    del euclid
    torch.cuda.empty_cache()
    lap("serving")
    mech_hist, mech_index = phase_mechanisms(ops, *mech_mods)
    lap("mechanisms")

    rows = kernel_rows(torch, ops, ShapeInputs(torch, ops, ref, approx_runs[-1]["index"], queries_np, log), hist)
    del approx_runs
    torch.cuda.empty_cache()
    rows += filtered_kernel_rows(torch, ops, ref, filtered, queries_np, log)
    del filtered, jsd_exact
    torch.cuda.empty_cache()
    rows += online_kernel_rows(torch, ops, ref, online, queries_np, log)
    del online
    torch.cuda.empty_cache()
    rows += sharded_kernel_rows(torch, ops, ref, sharded, data_np, queries_np, log)
    del sharded
    torch.cuda.empty_cache()
    durable_rows = durable_kernel_rows(torch, ops, ref, durable, queries_np, log)
    print(json.dumps({"durable_kernels": durable_rows}), flush=True)
    rows += durable_rows + select_rows
    del durable
    torch.cuda.empty_cache()
    serving_rows = serving_kernel_rows(torch, ops, ref, serving, queries_np, log)
    print(json.dumps({"serving_kernels": serving_rows}), flush=True)
    rows += serving_rows
    del serving
    torch.cuda.empty_cache()
    # the mechanisms phase's own shape classes, timed on its engine's
    # 112,682-row N_seq table and corpus, with that phase's launches
    corpus = torch.as_tensor(data_np, device="cuda")
    rows += kernel_rows(torch, ops, ShapeInputs(torch, ops, ref, mech_index, queries_np, log, corpus), mech_hist,
                        "mechanisms")
    del corpus, mech_index
    torch.cuda.empty_cache()
    lap("kernel_rows")
    phase_models(ops, torch)
    torch.cuda.empty_cache()
    lap("models")
    train = phase_train(ops, torch, data_np)
    torch.cuda.empty_cache()
    lap("train")
    rows += phase_sharded_train(torch)[1]
    lap("sharded_train")
    rows += phase_tools(ops, torch, api, ref, log, train)["rows"]
    torch.cuda.empty_cache()
    lap("tools")
    phase_tune(ops, torch, api, ref, data_np, queries_np)
    lap("tune")
    examples_rows = phase_examples(ops, torch, api, ref, log)
    print(json.dumps({"examples_kernels": examples_rows}), flush=True)
    rows += examples_rows
    torch.cuda.empty_cache()
    lap("examples")
    emit(phase="run", seconds=time.perf_counter() - t_run, phase_seconds=lap.laps,
         host_yardstick_s=host_yardstick())
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
