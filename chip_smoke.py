#!/usr/bin/env python3
"""Smoke run of the PyTorch and CUDA port (predictionio_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # phases 1-3: build and check the four kernels
    python3 chip_smoke.py --profile  # also device time by kernel (torch.profiler)
                                     # of serving batches and a training iteration
    python3 chip_smoke.py --topk     # phases 1-4 for score_topk alone (no result line)
    python3 chip_smoke.py --ops      # phases 1, 2, 5, 10 and 11: the engine
                                     # server's operations surface and online
                                     # loop alone (no result line)
    python3 chip_smoke.py --templates  # phases 1, 2, 5 and 12: the similar-product
                                       # and e-commerce templates, batchpredict
                                       # and resume alone (no result line)
    python3 chip_smoke.py --ann      # phases 1, 2 and 13: ANN and the two-tower
                                     # template alone (no result line)
    python3 chip_smoke.py --classification  # phases 1, 2 and 14: the classification,
                                            # text and e2 slice alone, with LR's
                                            # one-thread CPU witness (no result line);
                                            # with --profile, each step's busy time
                                            # on the card (torch.profiler)
    python3 chip_smoke.py --universal  # phases 1, 2 and 15: the universal and
                                       # sequential templates alone (no result line)
    python3 chip_smoke.py --eventlog   # phases 1, 2 and 16: the EVENTLOG backend
                                       # alone (no result line)
    python3 chip_smoke.py --storage    # phases 1, 2 and 17: every repository on
                                       # ELASTICSEARCH alone (no result line)
    python3 chip_smoke.py --replication  # phases 1, 2 and 18: the replicated event
                                         # plane and the continuous trainer alone
                                         # (no result line)

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. the card's name and power limit (nvidia-smi);
2. build every kernel (``predictionio_tpu_torch/csrc/*.cu``) for sm_90a,
   one nvcc per source, all started together; print each build time and
   ``-Xptxas -v``;
3. hold each kernel against its plain PyTorch version on the card
   (PyTorch's default f32 matmuls, no TF32): score_topk — equal indices on integer data, values within
   rtol/atol 1e-5 and indices equal up to near-ties on Gaussian data, pad
   rows exact, at k = 16, 128 and 1,024, around the boundary of its
   k <= 32 path (k = 1 … 33 at B = 1 … 65, every rows-per-block
   instantiation, each row alone bitwise equal to the same row in its
   bucket, tie-heavy and constant V, n_valid < k, an unaligned V, catalogs
   of 1 … 2,000 items at d = 10 and 100), and on its k > 32 path (k = 33 …
   1,024 on each side of every power of two at B = 1 … 256, each answer
   bitwise equal on a rerun, at k = 64 and 1,024 each row alone bitwise
   equal to the same row in its bucket, tie-heavy and constant V — more
   keys reach the bar than shared memory holds — n_valid < k, an unaligned
   V, d = 8, 10 and 128, catalogs of 40 … 2,000 items); gather_gram — bitwise equal on integer data, within 1e-5 of
   a float64 reference (relative to max|A64|) on Gaussian data, A exactly
   symmetric, f32 and bf16 factors, repeated indices, pad slots, every
   path of its plan (narrow rows packed, wide rows split), all-zero rows,
   zero runs mid-row, an F off the 16-byte boundary, R = 0; chol_solve — within 1e-4 of
   float64 (relative to max|x64|) on ALS-like SPD systems and on the same
   systems ill-scaled, at every KP boundary of k = 1 … 128, identity
   systems give x = b exactly; rows_gram — bitwise equal on integer data,
   within 1e-5 of a float64 reference on Gaussian data with 20% zero
   weights, pad at the end of each row and runs of zero weights mid-row,
   A exactly symmetric and a rerun bitwise equal, at every width of the
   training layout's ladder, every path of its plan (wide rows split,
   narrow rows packed, all-zero rows, an F_g off the 16-byte boundary),
   f32 and bf16 blocks, R = 0;
4. time score_topk with CUDA events at the serving path's shapes (k = 16,
   every bucket), and at k = 64, 128 and 1,024 at B = 1, 8 and 64 and
   k = 256 and 512 at B = 1 and 64 (the k > 32 path), beside its plain
   version, one library call (torch.topk of the dense scores) and the
   card's bound;
5. full-width training: a synthetic MovieLens-20M-shaped COO (138,493
   users x 26,744 items, 20,000,263 ratings, power-law popularity), the
   host layout (als_prepare), then explicit ALS on the card (rank 64, 10
   iterations, lambda 0.01, weighted lambda) with TF32 turned on for the
   process, so that the port's own guard is what keeps the dense head's
   matmuls at full f32, and with the launch counters zeroed just before
   and read just after; the final factors are held against their
   float64 normal equations built from the raw COO (64 items given the
   final U, 64 users given the second-to-last V), and the final U
   half-step, rerun without TF32, must equal the final U bitwise; two
   controls rerun the last iteration with less precision (bf16 gathers;
   TF32 in the dense head with the guard taken out) and must fail the
   float64 check and move U, which shows those checks can tell them from
   the f32 run;
6. time gather_gram for every bucket of that layout (with its padded,
   rated and modelled multiplied slots and its plan; each result within
   1e-5 of float64 and exactly symmetric, and a packed bucket also timed
   with one row a block, which must give the same bits) and chol_solve at
   both sides' N, beside the plain versions, one library call and the
   bound (the larger of the bytes and the operations the function needs,
   per launch, summed over the launches); then drive rows_gram's path,
   its op entry point, over every bucket pre-gathered as F[idx] in row
   chunks (launch counters zeroed just before and read just after, each
   result within 1e-5 of a float64 reference on the same inputs and
   exactly symmetric, the plain version's distance from it printed
   beside), and time it the same way, with each chunk's plan, beside
   gather_gram on the same rows;
7. the quickstart through the port's CLI and HTTP alone, in one
   temporary PIO_HOME: ``app new``; ``eventserver --ingest-batching``
   taking 25,000 rate events (2,000 single POSTs from 64 clients, the
   rest in batches of 50 from 16; cut from 200,000, then 50,000, to keep
   the whole run in its time), every one answered 201, and a few
   users' events read back as posted; ``export`` (25,000 lines),
   ``import`` into a second app and its ``export``, equal lines; ``train``
   on the card (it must launch gather_gram and chol_solve); ``deploy
   --batching --aot-buckets auto`` on the card, 20 HTTP answers checked
   against the plain reference and equal to the same instance served in
   this process, where score_topk's counter must grow; ``eval`` of the
   template's RecEvaluation over its DefaultGrid (ranks 8 and 16 x lambda
   0.01 and 0.1, 8 iterations, two folds) serially and ``--distributed``
   on the card: both instances EVALCOMPLETED, equal leaderboard digests,
   every score within 1e-5 relative across the two, compiles <= buckets;
   then ``eval leaderboard``, ``evals list`` and ``evals show``;
   ``status``, which must name the card. Each step prints its wall time;
8. the factors phase 5 trained, written as a COMPLETED Recommendation
   engine instance into a temporary PIO_HOME through the port's storage,
   deployed with the port's EngineServer (micro-batching, AOT ladder);
   sequential and concurrent POST /queries.json, every answer checked
   against the plain reference on the card; the launch counters are
   zeroed just before the queries and score_topk must have grown; the
   serving dispatches per bucket (pio_aot_dispatch_total) and what the
   kernel loses on them, each at its bucket's phase-4 time less its bound.
   Then a sequential sub-run of 96 queries with num 50, 100 and 1,000
   (k = 64, 128 and 1,024, the k > 32 path), counters zeroed again just
   before it: every answer checked at its own num, one launch a query,
   its dispatches per (bucket, k, path), p50 and loss;
9. ``pio eval`` at ML-20M width: the first 6,000,000 of phase 5's
   ratings (cut from all 20,000,263 to keep the whole run in its time;
   the vocabularies stay ML-20M's) as the template's training
   data, ``run_evaluation(distributed=True)`` on the card over evalK 2,
   rank 64, 10 iterations, lambda 0.01 and 0.1 (cut from four lambdas to
   keep the whole run in its time; one bucket a fold); every fold score held against a float64 recomputation, the
   launch counters (zeroed just before) against candidates x iterations
   x (buckets + parts) of the fold layouts, the best candidate's fold-0
   factors against their float64 normal equations; the walls of
   ``read_eval``, each fold's ``als_prepare`` and each dispatch, the
   phase's wall and the host's peak RSS. The serial path runs in phase 7
   only (see ``eval_full_width``);
10. the engine server's operations surface at ML-20M width, in a
   temporary PIO_HOME: phase 8's instance and a second COMPLETED one of
   the same geometry (phase 5's final U with its second-to-last V), the
   first deployed with micro-batching, the AOT ladder, max_inflight 32,
   query_timeout_ms 2,000, a 0.2 s history scrape and the tracer on with
   a span file. ``/health`` answers 503 not-ready with Retry-After and a
   warmup block while the ladder warms (the warm-up starts once the
   server listens, every program built anew), then 200 ok, with one
   instance id throughout; ``/reload`` swaps to the second instance under
   64 closed-loop clients of num 10 (the cap lifted for it): every answer
   200 and equal to score_topk_ref of the old or the new factors, every
   query sent after the reload's 200 equal to the new ones',
   reloadGeneration 1, lastSwap promoted, score_topk launched, the
   reload's wall, its candidate's warm time and the launches it made,
   counted on the threads of the candidate's warm-up and of its probe
   (the probe must launch once, and the load's launches with the
   reload's must make the counter's total); a second ``/reload``
   with a ``serving.reload`` fault answers 500 rolled_back, later answers
   equal the serving instance's reference and
   pio_engine_reloads_total{result="rolled_back"} grows by 1; with a 3 s
   ``serving.query`` fault a query answers 504 within the 2 s deadline
   (plus 0.5 s) and with ``X-PIO-Deadline-Ms: 500`` within 0.5 s (plus
   0.5 s); 64 one-shot clients over the cap of 32 under the same fault:
   shed 503s with Retry-After, pio_engine_shed_total equal to the sheds
   the clients saw, ``/health`` degraded "at inflight capacity" while the
   cap is full; 200 sequential queries with the tracer on, then off
   (p50/p99 printed, no limit); ``/metrics`` parsed with the port's
   parse_prom_text, pio_engine_queries_total{status} equal to the
   clients' counts; ``/metrics/history`` has samples; ``/traces`` holds
   engine.query spans with a serving.device span under the serving.batch
   span of their dispatch, each serving.batch span links as many traces
   as its size, the span file is not empty and ``pio trace --tree``
   prints one such trace. Phase 7 also
   reads the event server's ``/health``, ``/metrics`` (its
   pio_events_ingested_total must count the 25,000 events) and
   ``/traces``.
11. the engine server's online loop at ML-20M width, in a temporary
   PIO_HOME: phase 10's two instances registered as model-registry
   generations 1 and 2, generation 1 promoted through ``models promote``;
   the port's event server (``eventserver --ingest-batching`` in a
   subprocess) with a feedback app and an EventServerPlugin from
   PIO_PLUGINS that refuses ``blocked`` events and writes a line per
   committed one; an EngineServer with variants champion:9,challenger:1,
   micro-batching, the AOT ladder, feedback to that event server, an
   incident directory and a counting EngineServerPlugin. Checks: the
   challenger's warm-up adopts the champion's programs and builds none;
   2,000 distinct users from 16 clients all 200, X-PIO-Variant equal to
   ``weighted_assign`` for each, every answer equal to score_topk_ref of
   its own arm's factors, score_topk launches equal to each arm's device
   batches (counted on the batcher's thread per arm); 200 of them
   repeated on the same arms, ``X-PIO-Variant: challenger`` overriding;
   ``POST /variants/weights`` 1:1 applied and the next 2,000 queries on
   the new hash, a weight on an unknown arm refused with the split
   unchanged; ``/reload?variant=challenger`` with ``variant.reload.partial``
   armed answers 500 failed, ``/health`` names the arm and its users are
   answered from the champion's factors, then a clean reload brings it
   back; one ``predict`` event per 200 answer in the store (entityType
   pio_pr, the answer's prId, properties.variant equal to the header),
   pio_engine_feedback_total{status="ok"} equal to them and none dropped,
   100 clicks through ``POST /feedback.json`` counted per arm on
   ``/variants``; with the event server stopped 50 queries all 200 (each
   sent once the previous one's feedback has settled, so that each is a
   send of its own), the feedback breaker open after 5 failures, the
   other 45 dropped as ``breaker_open``, and one incident bundle, read
   back with ``incidents list`` and ``incidents show``; on the restarted
   event server a ``blocked`` event answers 403 and the sniffer sees every
   201, ``app quota`` with a 10-event bucket makes a 50-POST burst answer
   429 with Retry-After (pio_tenant_quota_rejected_total equal to the
   429s), and with ``ingest.commit`` armed the group commits answer 500
   until the storage breaker opens, then 503, and none of their events
   lands. Prints the phase's wall, per-arm p50/p99, launches per arm and
   the feedback counts.
12. the ALS family at ML-20M width, in temporary PIO_HOMEs: phase 5's
   20,000,263 draws as event-order interactions (every draw a view; for
   e-commerce each draw rated >= 4.5 also a buy of weight 4; item n in
   category n % 7), the similar-product and e-commerce templates trained
   through their algorithms' ``train`` (implicit ALS, rank 64, 10
   iterations, lambda 0.01 weighted, alpha 1, seed 3): the walls of
   ``_to_coo``, ``als_prepare`` and the device, the launch counters
   (zeroed just before) equal to 10 x buckets and 10 x parts, the
   factors held against their float64 implicit normal equations (64
   items given the final U, 64 users given the second-to-last V) within
   1e-3, and a control (the last iteration rerun with the dense head's
   normal equations summed in f32, the JAX package's formula, both
   variants timed, its error split between the dense head's entities
   and the rest) must fail that check; both written as COMPLETED
   instances and deployed with the port's EngineServer. E-commerce: the store holds the 500 queried users' own
   views and buys and the items' $sets; 500 known users (drawn among
   those with at most 200 interactions; a fifth with categories, a
   whiteList or a blackList) and 20 unknown ones, an item made
   unavailable and another viewed midway, every answer equal to a float64
   host reference applying the same rules up to near-ties, score_topk
   launches equal to the device dispatches and the known-user queries.
   Similar-product: 300 single-item and 200 multi-item queries, each
   equal to float64 similar_items up to near-ties with the query items
   absent, one launch a query. ``batchpredict --device cuda`` through the
   CLI over phase 5's factors: 20,000 queries in batches of 1,024 (the
   last 1,000 with num 100), every line against score_topk_ref in float64,
   one launch a batch. Resume: phase 5's explicit train cut after 6
   iterations checkpointed every 3 and resumed to 10, bitwise equal to
   the straight run, each save timed; and ``train --resume`` in a
   subprocess on a small app cut after its second checkpoint, bitwise
   equal to a straight train, running only the remaining iterations.
   Phase 3 also holds score_topk at B = 1,024 (k = 16 and 128, rows_valid
   1,024 and 544) and phase 4 times it there.
13. ANN and the two-tower template at full width, in temporary
   PIO_HOMEs. Two-tower: the first 5,000,000 of phase 5's 20,000,263
   draws as (user, item) view pairs, the template's engine.json widths
   (embed 32, hidden [64], out 32, batch 1,024, lr 0.01, temperature
   0.1) for 1 epoch (the cuts: 5 epochs to 1, and the draws quartered to
   keep the whole run in its time), trained through ``run_train`` (the data source's read returns the
   draws); steps/s and the epoch loss printed; the card's first 50 steps
   (10 in the whole run, to keep it in its time), each from the CPU's
   state before it, held against the port's CPU run
   of the same steps (same seeded init, same batches): in float64 and
   f32 every entry of each gradient and of each parameter after the step
   within 1e-4 of its leaf's max |value|, each gradient within 1e-4 in
   its leaf's norm, the entries a ReLU switched between the runs
   reaches masked and the switches counted; a TF32 control and a
   temperature control must fail that gate; the free runs' drift
   printed (see ``tt_step_check``). Deployed
   with the port's EngineServer: 500 users sequentially and from 8
   clients, every answer equal to a float64 top 10 of user_embeds ·
   item_embedsᵀ up to near-ties within 1e-5, score_topk launches equal
   to the dispatches. With ``ann: true`` (annM 8, annK 256, annShortlist
   128), once plain and once with annOpq, each through ``run_train``
   reusing the trained towers (only the index is built): the build time
   split into Lloyd, encode and OPQ, every answer equal to a host float64
   replay of the ADC → shortlist → re-rank from the index up to near-ties
   within 1e-5, 0 score_topk launches, recall@10 against the exact path
   printed. Similar-product: phase 12's implicit train (rank 64) with
   ``ann: true`` (annM 8, annK 256) through ``run_train``, the index
   sidecars beside model.bin, 500 single-item queries each against the
   same replay, 0 score_topk launches. The 10M catalog: an ANNScorer over
   10,000,000 × 32 normalised Gaussian items (seeded), the index build
   timed, ANN dispatches at B = 1, 8 and 64 (k 16, k′ 128) against the
   exact score_topk over the same corpus (CUDA events) beside the ANN
   bytes bound (codes N·m + the B·k′·d re-rank rows over HBM), 8 rows'
   shortlists held against a float64 replay.

14. classification and e2 at full width, in temporary PIO_HOMEs; no
   kernel of the port runs (the four counters, zeroed first, must read
   0). A Covertype-shaped table (``synthetic_covertype``: 581,012 rows ×
   54 attributes, 7 classes at Covertype's counts, seed 7) trains the
   classification template's algorithms at their defaults on the card:
   NB multinomial (λ 1) and bernoulli, each log table within 1e-5 of a
   float64 numpy fit; LR (100 L-BFGS steps) at reg 0 and 1e-3, the
   latter held against the port's CPU run: the card takes each of the
   CPU's 100 steps from the CPU's state (point and memory), each within
   1e-5 of the CPU's next point (of its max |W|), and the free runs
   after 10 steps within 1e-4 (after 100 their gap and both float64
   losses are printed); the same steps with TF32 products, a control,
   must fail that limit; under ``--classification`` the CPU's 100 steps
   on one thread are printed against the run on every core; RF (16
   trees, depth 5, 16 thresholds, feature fraction 0.7), whose first 4 trees (1 in
   the whole run, to keep in its time) grown again on
   the CPU from the same draws must split alike, except where a level's
   two picks have float64 Gini within 1e-6 relative, with leaf_probs
   within 1e-6. Each training accuracy is printed. The NB, LR and RF
   instances are served by the port's EngineServer, 1,000 POST
   /queries.json each, every label equal to the float64 prediction from
   the stored arrays up to near-ties within 1e-5; ``pio eval`` of a
   DefaultGrid-shaped grid (NB λ 0.5 and 1.0, LR, RF; evalK 2) over every
   10th row (the cut: 58,102 rows, since the serial path answers each
   held-out row in Python), serially and distributed, every fold
   accuracy equal. The CLI: 20,000 ``$set`` entities (attr0..2 and the
   label) through the port's event server, ``train`` from the template's
   engine.json and ``deploy`` answering 50 queries as the instance does
   in-process. The text template on a corpus of 20 Newsgroups' shape
   (18,846 documents, 20 labels, 50–400 tokens from a Zipf vocabulary of
   30,000 words) in the event store: ``run_train`` of NB and of LR
   (hashBits 12, ngrams 2; the hashing's host time apart), 500 queries
   served to each on the float64 predictions. The Markov chain over
   phase 5's draws (each user's consecutive items, S = 26,744): counts
   equal to ``np.bincount``, probabilities within 1e-6 of float64,
   ``predict_top_k`` of 100 states a top 10 of numpy's sort. Categorical
   NB over 1,000,000 points × 10 positions (vocabularies 2–1,000): the
   counts equal numpy's. Every timed step prints its wall; with
   ``--profile`` it runs under torch.profiler and also prints the card's
   busy time in it (kernels and copies), and the phase prints the sums.
15. the universal recommender and sequential recommendation at full
   width, in temporary PIO_HOMEs; no kernel of the port runs (the four
   counters, zeroed first, must read 0). Universal: phase 5's draws as
   events of the ML-20M geometry (138,493 users x 26,744 items), a buy
   (the primary event) for each draw rated >= 4.5 and a view for each
   draw; ``URAlgorithm._prepare`` and the same ``cco_indicators`` call as
   ``URAlgorithm.train`` (50 indicators an item, LLR threshold 0.0) with
   the dense crossover raised to 4,096 MB so that C (2.86 GB an event)
   is built on the card; the walls of the call's stages (downsampling
   and CSR on the host, the slabs, the
   products, the LLR with its top-k; the card synchronised at each
   stage's end). For 256 sampled primary rows the counts against both
   events, computed on the card by ``_cooccurrence`` from the rows' own
   primary CSR, equal a host count bitwise (the views' CSR built for the
   rows' buyers alone, as the downsampling keeps them); for the primary
   event (the diagonal masked) their LLR lies within 1e-6 of the term
   scale 2·n·ln n of the port's CPU f32 LLR of the same counts, their gap
   to float64 ``_llr_values`` is printed, and their indicator lists
   equal the CPU's up to near-tie swaps within that tolerance (the views'
   LLR and lists are not checked: their column counts need the views'
   whole CSR again, about 15 s of host time). The model served by the port's EngineServer: 1,000 user
   queries (users with at most 500 views; a third with eventBoosts, every
   fifth with a blackList of its top three), 100 item queries and 50
   cold users, each answer equal to a float64 host replay of
   ``score_user`` with the popularity fallback and the bans up to
   near-ties within 1e-5 relative; p50 printed. Sequential: the same
   draws as per-user sequences in draw order, the template's engine.json
   widths (hidden 64, 2 blocks, 2 heads, seqLen 64, batch 128) for one
   epoch (cut from 20); the card's first three steps, each from the CPU's
   state, within 1e-5 of the CPU's loss and of each leaf's max |g|, and
   the parameters after the step within 1e-4 of each leaf's max |value|
   (both steps' distance from a float64 step printed); a TF32 control
   must fail the gradient check; steps/s printed (with ``--profile`` 20
   steps also run under torch.profiler: the card's busy time); 500
   ``{"history": ...}`` queries served, each top 10 equal to the port's
   CPU scores up to near-ties. Through the CLI (with ``--universal``
   only; the whole run leaves it out to keep in its time): 20,000 buy
   and view events through the port's event server in batches of 50, ``train``
   from each template's engine.json, ``deploy``, 50 queries to each
   answered as the same instance in-process answers (live-history
   ``user`` queries included), ``eval`` of UREvaluation over DefaultGrid
   with MAP@10 and MAP@1 printed. Every time printed stands beside the
   card's name and power limit.
16. the EVENTLOG backend at ML-20M width, in a temporary PIO_HOME whose
   EVENTDATA is the native event log (``PIO_STORAGE_REPOSITORIES_
   EVENTDATA_SOURCE=EVENTLOG``, 64 MiB segments): the port's C++ engine
   built with g++ (its time printed); phase 5's draws (all 20,000,263
   with ``--eventlog``; the whole run cuts them to the first 1,000,000
   to keep in its time, and prints the vocabularies' sizes) as ``rate`` events,
   one eventTime a second, fed to ``append_jsonl`` in ~8 MB NDJSON chunks
   (built by worker processes), the wall and events/s printed; ``pio
   import`` of a 1,000,000-line file (250,000 in the whole run), ``pio export`` (the engine's NDJSON
   path: the round trip's apps are kept to one active segment each) and
   the export imported into a second app, whose columnar scan must equal
   the first's;
   the Recommendation template's training read three times, cold (cache
   ``miss:cold``, writing the snapshot), warm (``hit``) and after 100,000
   more events (``hit:delta``), each read's vocabularies, indices and
   ratings bitwise equal to numpy's first-seen arrays of the draws; ``pio
   segments compact``, then a read without the cache (``--no-scan-cache``)
   served by the sidecars, equal again; ``pio fsck`` of the home, exit 0,
   and of a small home with one flipped byte in a sealed segment's frames
   (2, and 2 after ``--repair``: frames are report-only) and in its
   compaction sidecar (2, then 3 with ``--repair``, then 0); ``pio
   train`` of the template at rank 64, 10 iterations, lambda 0.01 on the
   card, its gather_gram and chol_solve launches printed beside phase 5's
   (counters zeroed just before), 64 items' factors held against the
   float64 normal equations of the raw events given the final U (limit
   1e-3); the instance deployed with the port's EngineServer and 200
   queries from 8 clients, every answer equal to score_topk_ref up to
   float64 near-ties (score_topk's counter zeroed just before, and it must
   grow). The CLI verbs run in this process on the phase's Storage.
17. every repository on ELASTICSEARCH at ML-20M width: the port's CLI in
   a new process a verb, from a fresh PIO_HOME whose METADATA, EVENTDATA
   and MODELDATA sources are one embedded index root
   (``PIO_STORAGE_SOURCES_ES_TYPE=ELASTICSEARCH``, ``_PATH=<home>/es``);
   ``app new``; ``import`` of phase 5's draws as ``rate`` events over the
   ML-20M id space (the first 2,000,000 with ``--storage``; the whole run
   cuts them to the first 150,000 to keep in its time: the index is
   Python dictionaries and a JSONL WAL that every process replays), its
   wall and events/s printed;
   ``train`` of the Recommendation template at rank 64, 10 iterations,
   lambda 0.01 twice, each in a driver that runs the verb with the
   process's tracer on and prints the walls of the repositories' open
   (the index's WAL replayed), of the training read with its snapshot
   cache outcome (``miss:cold``, then ``hit``) and of ``train.run``, the
   verb printing its gather_gram and chol_solve launches (counted from 0
   in the new process), each exactly 10 iterations x the buckets, and x
   the parts, of the draws' layout; 64 items' factors held
   against the float64 normal equations (limit 1e-3); ``deploy`` of the
   instance in a new process (its open of meta and models and its time
   to listen printed) and 200 queries from 8 clients, every answer equal
   to score_topk_ref up to float64 near-ties, the server's score_topk
   launches printed when ``GET /stop`` ends it; ``export`` of the app
   (in a process of its own while the deploy runs: both only read the
   index), its line count and 1,000 sampled lines equal to what was
   imported.
18. the replicated event plane and the continuous trainer at ML-20M
   width, every step through the port's CLI in a process of its own, on
   EVENTLOG homes: ``app new`` on a leader's and a follower's home (meta
   only; the follower's events come by replication), ``import`` of phase
   5's draws as ``rate`` events into the leader's home (all 20,000,263
   with ``--replication``; the whole run cuts them to the first
   1,000,000), its events/s printed; ``eventserver --lease-home
   --replicate-to --durable-acks`` for the leader, then the follower,
   which syncs the sealed segments from the leader's manifest (bytes and
   wall printed); the first batch through the follower, with which the
   leader resends its whole active file from the follower's cursor; a
   live tail (100,000 events with ``--replication``, 20,000 in the whole
   run) in ``/batch/events.json`` batches of 50 from 8 clients through the
   follower's 307 (events/s printed), every item 201; every frame file of
   the follower's ``eventlog/`` equal to the leader's by sha256, ``fsck``
   0 on both homes. Then one long-lived ``daemon -- train --continuous
   --read-from follower`` (rank 64, 10 iterations, a checkpoint every 2,
   waking on 5,000 new events), which reads the follower's live log
   through a view that ends at the acked cursor and is rebuilt at each
   1 s poll that finds the log moved, each cycle's walls printed (read, train, gate, promote,
   reload) with its gather_gram and chol_solve launches: cycle 1
   promotes generation 1, whose 64 items are held against float64
   (limit 1e-3); ``deploy`` of the follower's home (it needs an instance
   to start), which then joins the fleet manifest the trainer pushes
   ``/reload`` to, and 200 answers equal to score_topk_ref on generation
   1's factors; a delta of 5,000 events through the follower while the
   trainer polls (events/s printed), on which the same trainer wakes
   for cycle 2, delta-trains and passes the offline guardrail (champion
   and candidate RMSE over the newest 200 events: each instance loaded
   on the card, each rating a dot product on the host), promotes
   generation 2 and pushes ``/reload``, after which the answers follow
   generation 2; the crash drill: after another delta the daemon's
   trainer is killed with SIGKILL after two checkpoint steps, the daemon
   restarts it, it resumes from ``train_ckpt_torch/`` and promotes
   generation 3 exactly once (items on float64, answers on its factors);
   the daemon stopped with SIGTERM (exit 0) and the follower's frame
   files still equal to the leader's; one cycle with ``PIO_FAULTS``
   arming ``train.crash`` exits non-zero having published nothing; the
   refusal drill: a cycle with ``promote.regression`` armed is refused
   and, after a ``/reload``, the answers stay the champion's; the
   deploy's score_topk launches printed when ``GET /stop`` ends it.
   Last, ``failover --drill``, then this phase's own leader killed with
   SIGKILL after 500 of 1,000 events
   posted serially through the follower: 0 acknowledged events missing
   on the promoted follower, the epoch bumped, the kill-to-leader wall
   printed, a forged apply at the old epoch refused with 412, ``fsck`` 0
   on both homes, exactly one failover incident bundle.

Each phase prints its wall time. The line before the last is a JSON
object with each kernel's numbers; the last line is {"ok": true,
"device": {...}}. Any failed phase exits non-zero before either is
printed. Without a CUDA card the script exits non-zero at once.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

# ML-20M serving geometry (BASELINE.md protocol)
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
TILE = 2048
N_PAD = -(-N_ITEMS // TILE) * TILE          # 28,672 resident item rows
BATCH_MAX, AOT_TOPK = 64, 16
SEED = 0
# full-width training: the template's defaults at BASELINE.md's rank
N_RATINGS, ITERATIONS, LAMBDA = 20_000_263, 10, 0.01
# `pio train` through the CLI: a small app from the same generator
APP_EVENTS, APP_USERS, APP_ITEMS = 25_000, 10_000, 2_000

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

TOL = 1e-5
GRAM_TOL = 1e-5    # gather_gram: max|dA| / max|A64| on Gaussian data
SOLVE_TOL = 1e-4   # chol_solve: max|x - x64| / max|x64|
ORACLE_TOL = 1e-3  # trained factors against their float64 normal equations
EVAL_TOL = 1e-5    # pio eval scores: serial against distributed, sweep against float64


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


_PHASE_T0 = [0.0]


def phase(name: str) -> None:
    now = time.perf_counter()
    if _PHASE_T0[0]:
        print(f"-- phase wall time {now - _PHASE_T0[0]:.1f} s", flush=True)
    _PHASE_T0[0] = now
    print(f"== {name}", flush=True)


def synthetic_ml20m(nnz: int, n_users: int, n_items: int, seed: int = 7):
    """Power-law user/item popularity, Zipf-ish, like MovieLens (the
    benchmark's generator)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u_pop = rng.zipf(1.35, size=nnz * 2) % n_users
    i_pop = rng.zipf(1.25, size=nnz * 2) % n_items
    users = u_pop[:nnz].astype(np.int32)
    items = i_pop[:nnz].astype(np.int32)
    ratings = (rng.integers(1, 11, size=nnz) * 0.5).astype(np.float32)
    return users, items, ratings


def score_topk_bound_ms(B: int, d: int, n_valid: int, k: int):
    """The bound of one launch: only the n_valid item rows count (the
    pad rows past them are masked, not needed by the function)."""
    flop_s = 2 * B * d * n_valid / PEAK_F32_FLOPS
    byte_s = 4 * (B * d + n_valid * d + 2 * B * k) / PEAK_HBM_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s >= byte_s else "bytes")


def cuda_ms(fn, iters: int = 50, warmup: int = 5):
    """(device ms, per-call ms) of ``fn``, from CUDA events.

    Device time: the stream is first held by a spin kernel long enough
    for the host to enqueue every iteration, so the events bracket the
    launches back to back and host overhead drops out. Per-call time:
    the same loop without the spin, so a call whose host side is slower
    than its kernels is timed at its host rate — what a caller pays."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for hold in (True, False):
        if hold:  # ~2 GHz clock: spin three times the host's enqueue time
            torch.cuda._sleep(int(host_s * 3 * 2e9) + 1_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out[0], out[1]


def profile_score_topk(torch, ops, dev) -> None:
    """--profile: device time by kernel name from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    U = torch.randn(N_USERS, RANK, generator=g, device=dev)
    Vp = torch.randn(N_PAD, RANK, generator=g, device=dev)
    for B, k in [(B, k) for k in (AOT_TOPK, 64, 1024) for B in (1, 64)]:
        ids = torch.randint(0, N_USERS, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        call = lambda: ops.score_topk(U, Vp, k, n_valid=N_ITEMS, ids=ids)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            if dev_us and ev.count:
                print(f"profile B={B:2d} k={k:4d} {ev.key[:60]:60s} calls={ev.count:3d} "
                      f"device_us_per_call={dev_us / ev.count:.2f}", flush=True)


def topk_agrees(vals, idx, ref_vals, ref_idx, scores64) -> bool:
    """Values within rtol/atol 1e-5; indices equal except where the two
    candidates' float64 scores lie within 1e-5 of each other."""
    import torch

    if not torch.allclose(vals, ref_vals, rtol=TOL, atol=TOL):
        return False
    diff = idx != ref_idx
    if not bool(diff.any()):
        return True
    got = torch.gather(scores64, 1, idx.long())
    want = torch.gather(scores64, 1, ref_idx.long())
    return bool(((got - want).abs()[diff] <= TOL).all())


def check_score_topk(torch, ops, dev) -> float:
    """Phase 3: the kernel against score_topk_ref; returns the max abs
    value error at the serving path's shape (B=64, k=16, Gaussian)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    main_err = None
    for kind in ("integer", "gaussian"):
        if kind == "integer":
            # nonzero small integers: every score is exact in f32
            def draw(*shape):
                mag = torch.randint(1, 4, shape, generator=g, device=dev)
                sign = torch.randint(0, 2, shape, generator=g, device=dev) * 2 - 1
                return (mag * sign).float()
        else:
            def draw(*shape):
                return torch.randn(*shape, generator=g, device=dev)
        U = draw(N_USERS, RANK)
        V = draw(N_ITEMS, RANK)
        Vp = torch.cat([V, torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
        for B in (1, 16, 64, 256):
            ids = torch.randint(0, N_USERS, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            rows_valid = B - B // 4
            for k in (16, 128, 1024):
                vals, idx, err = topk_case(torch, ops, dev, f"{kind:8s}", U, Vp, k, ids,
                                           rows_valid, N_ITEMS, kind == "integer")
                if kind == "gaussian" and B == BATCH_MAX and k == AOT_TOPK:
                    main_err = err
                    # a row's answer does not depend on its batch: the
                    # padded bucket and the row alone agree bitwise
                    for r in (0, 1, rows_valid - 1):
                        v1, i1 = ops.score_topk(U, Vp, k, n_valid=N_ITEMS,
                                                ids=ids[r:r + 1])
                        check(torch.equal(v1[0], vals[r])
                              and torch.equal(i1[0], idx[r]),
                              f"row {r} differs between B={B} and B=1")
        # `pio batchpredict`'s dispatches: B = 1,024, full and a last batch
        # of 544 rows, at num 10 and 100 (k = 16 and 128)
        ids = torch.randint(0, N_USERS, (1024,), generator=g, device=dev,
                            dtype=torch.int32)
        for B, k in BATCHPREDICT_CELLS:
            for rows_valid in (1024, 544):
                topk_case(torch, ops, dev, f"{kind:8s}", U, Vp, k, ids, rows_valid,
                          N_ITEMS, kind == "integer")
    for spec in TOPK_PATHS.values():
        check_score_topk_path(torch, ops, dev, g, spec)
    return main_err


def topk_case(torch, ops, dev, label, U, V, k, ids, rows_valid, n_valid, exact):
    """One score_topk call against score_topk_ref on the same inputs:
    bitwise on exact (integer) data, topk_agrees on Gaussian data; pad
    rows exact in both. Returns (vals, idx, max abs value error)."""
    vals, idx = ops.score_topk(U, V, k, n_valid=n_valid, rows_valid=rows_valid, ids=ids)
    rv, ri = ops.score_topk_ref(U, V, k, n_valid=n_valid, rows_valid=rows_valid, ids=ids)
    torch.cuda.synchronize()
    if exact:
        ok = torch.equal(idx, ri) and torch.equal(vals, rv)
    else:
        s64 = U[ids.long()].double() @ V.double().T
        s64[rows_valid:] = 0.0
        s64[:, n_valid or V.shape[0]:] = -3.0e38
        ok = topk_agrees(vals[:rows_valid], idx[:rows_valid], rv[:rows_valid],
                         ri[:rows_valid], s64[:rows_valid])
    # pad rows: all-zero scores, then -3e38 where n_valid < k; items 0 .. k-1
    cols = torch.arange(k, device=dev)
    pad_vals = torch.where(cols < (n_valid or V.shape[0]), 0.0, -3.0e38)
    pad_ok = (bool((vals[rows_valid:] == pad_vals).all())
              and bool((idx[rows_valid:] == cols).all()))
    err = (vals - rv).abs().max().item()
    print(f"score_topk {label} B={ids.shape[0]:3d} d={V.shape[1]:3d} Np={V.shape[0]:5d} "
          f"k={k:4d} n_valid={n_valid or V.shape[0]:5d} rows_valid={rows_valid:3d} "
          f"max_abs_err={err:.3e} {'ok' if ok and pad_ok else 'MISMATCH'}", flush=True)
    check(ok, f"score_topk disagrees with score_topk_ref ({label}, B={ids.shape[0]}, k={k})")
    check(pad_ok, f"score_topk pad rows wrong ({label}, B={ids.shape[0]}, k={k})")
    return vals, idx, err


#: phase 3's grid for each path of score_topk. "k": held at every B of "B"
#: on integer and Gaussian data at ML-20M's shape; "alone": the k at which
#: each Gaussian row alone must equal its row in the bucket bitwise (None:
#: every k); "ties": k on tie-heavy and constant V; "masked": k with
#: n_valid = k // 2; "unaligned": (Np, n_valid, k) of an unaligned V;
#: "widths": d, then (Np, k) pairs of small catalogs at that d
TOPK_PATHS = {
    # k <= 32 and its boundary: each rows-per-block instantiation (B = 3
    # takes 4, B = 65 two groups of 64); Np 1 ... 2,000 at d = 10 and 100
    "select": {
        "k": (1, 5, AOT_TOPK, 17, 31, 32, 33), "B": (1, 2, 3, 8, 16, 31, 33, 64, 65),
        "alone": None, "ties": (1, AOT_TOPK, 32, 33), "masked": (5, 17, 32, 33),
        "unaligned": ((2000, 0, AOT_TOPK),),
        "widths": {d: [(np_, k) for np_ in (1, 31, 257, 2000)
                       for k in (1, 5, 17, 31, 32, 33) if k <= np_] for d in (10, 100)},
    },
    # 32 < k <= 1,024 (a bar from the chunks' J-th keys, then a sort of what
    # reaches it): each side of every power of two; B = 256 takes four row
    # groups; constant and tie-heavy V at Np = 28,672 pass more keys than
    # shared memory holds; a catalog of one chunk (40), and at k near Np
    # (2,000) too few chunks for a bar
    "bar": {
        "k": (33, 63, 64, 65, 100, 127, 128, 129, 255, 256, 257, 511, 512, 513, 1000, 1023,
              1024),
        "B": (1, 2, 3, 8, 16, 32, 64, 256),
        "alone": (64, 1024), "ties": (33, 64, 100, 1024), "masked": (33, 64, 100, 1024),
        "unaligned": ((N_PAD, N_ITEMS, 64), (N_PAD, N_ITEMS, 1024)),
        "widths": {d: [(np_, k) for np_ in (40, 257, 2000) for k in (33, 64, 129, 1000, 1024)
                       if k <= np_] + [(N_PAD, 64), (N_PAD, 1024)] for d in (8, 10, 128)},
    },
}


def check_score_topk_path(torch, ops, dev, g, spec) -> None:
    """Phase 3, one path of score_topk over its TOPK_PATHS grid: integer
    data bitwise, Gaussian data by topk_agrees against float64, pad rows
    exact, each answer bitwise equal on a rerun; constant V must give items
    0 .. k-1, and with n_valid < k the masked columns fill the list from
    n_valid at -3e38 in index order."""
    def integer(*shape):
        mag = torch.randint(1, 4, shape, generator=g, device=dev)
        return ((torch.randint(0, 2, shape, generator=g, device=dev) * 2 - 1) * mag).float()

    def gaussian(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def batch(B, n_users):
        return torch.randint(0, n_users, (B,), generator=g, device=dev, dtype=torch.int32)

    def case(label, U, V, k, ids, rows_valid, n_valid, exact):
        vals, idx, _ = topk_case(torch, ops, dev, label, U, V, k, ids, rows_valid, n_valid, exact)
        v2, i2 = ops.score_topk(U, V, k, n_valid=n_valid, rows_valid=rows_valid, ids=ids)
        check(torch.equal(v2, vals) and torch.equal(i2, idx),
              f"score_topk rerun differs ({label}, B={ids.shape[0]}, k={k})")
        return vals, idx

    n_users = 4096
    for kind, draw in (("integer", integer), ("gaussian", gaussian)):
        U = draw(n_users, RANK)
        Vp = torch.cat([draw(N_ITEMS, RANK), torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
        for B in spec["B"]:
            ids = batch(B, n_users)
            rows_valid = B - B // 4
            for k in spec["k"]:
                vals, idx = case(f"{kind:8s}", U, Vp, k, ids, rows_valid, N_ITEMS,
                                 kind == "integer")
                if kind == "gaussian" and (spec["alone"] is None or k in spec["alone"]):
                    # a row's answer does not depend on its batch
                    for r in sorted({0, rows_valid - 1}):
                        v1, i1 = ops.score_topk(U, Vp, k, n_valid=N_ITEMS, ids=ids[r:r + 1])
                        check(torch.equal(v1[0], vals[r]) and torch.equal(i1[0], idx[r]),
                              f"row {r} differs between B={B} and B=1 (k={k})")

    # tie-heavy and constant V (integer Q: every score exact)
    U = integer(n_users, RANK)
    for np_ in (2000, N_PAD):
        distinct = integer(3, RANK)
        V_ties = distinct[torch.randint(0, 3, (np_,), generator=g, device=dev)].contiguous()
        V_const = torch.ones(np_, RANK, device=dev)
        for B in (1, 8, 64, 65):
            ids = batch(B, n_users)
            rows_valid = B - B // 4
            for k in spec["ties"]:
                case("ties    ", U, V_ties, k, ids, rows_valid, 0, True)
                _, idx = case("constant", U, V_const, k, ids, rows_valid, 0, True)
                check(bool((idx == torch.arange(k, device=dev)).all()),
                      f"constant V: not items 0..k-1 (B={B}, k={k})")

    # n_valid < k: the masked columns fill the list from n_valid, in order
    Vp = integer(N_PAD, RANK)
    for B in (1, 64):
        ids = batch(B, n_users)
        for k in spec["masked"]:
            n_valid = k // 2
            vals, idx = case("masked  ", U, Vp, k, ids, B, n_valid, True)
            check(bool((idx[:, n_valid:] == torch.arange(n_valid, k, device=dev)).all())
                  and bool((vals[:, n_valid:] == -3.0e38).all()),
                  f"n_valid={n_valid} < k={k}: masked columns out of place")

    # a V that is not 16-byte aligned: the 4-byte copies at d % 4 == 0
    for np_, n_valid, k in spec["unaligned"]:
        Vm = misaligned(torch, integer(np_, RANK))
        for B in (1, 64):
            case("unalignV", U, Vm, k, batch(B, n_users), B, n_valid, True)

    # other widths
    for d, shapes in spec["widths"].items():
        for kind, draw in (("integer", integer), ("gaussian", gaussian)):
            Ud = draw(n_users, d)
            for np_ in sorted({np_ for np_, _ in shapes}):
                V = draw(np_, d)
                for B in (1, 3, 64):
                    ids = batch(B, n_users)
                    rows_valid = B - B // 4
                    for k in [k for n, k in shapes if n == np_]:
                        case(f"{kind:8s}", Ud, V, k, ids, rows_valid, 0, kind == "integer")


def _row_chunks(R: int, per_row: int, limit: int = 1 << 26):
    """Row slices whose gathered block stays under ``limit`` elements."""
    step = max(1, limit // max(1, per_row))
    return [slice(s, min(s + step, R)) for s in range(0, R, step)]


def gram64(torch, F, idx, wo, wb):
    """Float64 reference of gather_gram, in row chunks (order-free)."""
    R, C = idx.shape
    k = F.shape[1]
    A = torch.empty((R, k, k), dtype=torch.float64, device=F.device)
    b = torch.empty((R, k), dtype=torch.float64, device=F.device)
    F64 = F.double()
    for sl in _row_chunks(R, C * k):
        G = F64[idx[sl].long()]
        A[sl] = torch.einsum("rc,rck,rcl->rkl", wo[sl].double(), G, G)
        b[sl] = torch.einsum("rc,rck->rk", wb[sl].double(), G)
    return A, b


def gram_plain(torch, ops, F, idx, wo, wb):
    """gather_gram_ref over row chunks (rows are independent), so the
    largest shapes fit on the card."""
    parts = [ops.gather_gram_ref(F, idx[sl], wo[sl], wb[sl])
             for sl in _row_chunks(idx.shape[0], idx.shape[1] * F.shape[1])]
    return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])


def gram_inputs(torch, g, dev, R, C, k, kind, n_f=N_ITEMS, holes=False):
    """F, idx, wo, wb like a bucket's: odd rows draw their indices from 16
    rows (many repeats), the last quarter of each row is pad (index 0,
    weight 0). With ``holes``, every third row from the first also has a
    run of zero weights mid-row (whole tiles to skip at wide C) and every
    fifth row from the third has no nonzero weight at all. Integer data is exact in f32 whatever
    the summation order."""
    if kind == "integer":
        F = torch.randint(-3, 4, (n_f, k), generator=g, device=dev).float()
        wo = torch.randint(0, 4, (R, C), generator=g, device=dev).float()
        wb = torch.randint(-3, 4, (R, C), generator=g, device=dev).float()
    else:
        F = torch.randn(n_f, k, generator=g, device=dev)
        wo = torch.rand(R, C, generator=g, device=dev) * 2
        wo[torch.rand(R, C, generator=g, device=dev) < 0.2] = 0.0
        wb = torch.randn(R, C, generator=g, device=dev)
    idx = torch.randint(0, n_f, (R, C), generator=g, device=dev, dtype=torch.int32)
    idx[1::2] = torch.randint(0, 16, idx[1::2].shape, generator=g, device=dev,
                              dtype=torch.int32)
    pad = C - C // 4 if C >= 4 else C
    idx[:, pad:] = 0
    wo[:, pad:] = 0.0
    wb[:, pad:] = 0.0
    if holes:
        wo[::3, C // 8:C // 2] = 0.0
        wb[::3, C // 8:C // 2] = 0.0
        wo[2::5] = 0.0
        wb[2::5] = 0.0
    return F, idx, wo.contiguous(), wb.contiguous()


def misaligned(torch, F):
    """A contiguous copy of F that starts one element past a 16-byte
    boundary (a view into a larger buffer), so the kernel cannot take its
    16-byte copies."""
    buf = torch.empty(F.numel() + 1, dtype=F.dtype, device=F.device)
    out = buf[1:].view(F.shape)
    out.copy_(F)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def check_gather_gram(torch, ops, dev) -> float:
    """Phase 3: gather_gram against gather_gram_ref (bitwise on integer
    data) and a float64 reference (max|dA| / max|A64| <= 1e-5 on Gaussian
    data), f32 and bf16 factors; A exactly symmetric on every kind of
    data. Beside the first cases, every path of the kernel's plan: narrow
    rows packed several to a block with R not a multiple of the rows a
    block takes, wide rows split into chunks (C = 8,192 at R = 1, 42 and
    384), rows whose weights are all zero, zero runs mid-row, and an F
    that is not 16-byte aligned, and the training layout's bucket heights
    (R = 6,144, 19,813, 105,312), whose plans pack up to 8 rows. Returns the max abs error against the
    plain version at the training path's width (k=64, C=2048, Gaussian)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    main_err = 0.0
    # (k, C, R, dtype, holes, aligned)
    cases = [(k, C, R, torch.float32, False, True) for k in (8, 10, RANK, 128)
             for C in (8, 128, 2048, 8192) for R in (1, 13, 4096)]
    cases += [(k, C, 13, torch.bfloat16, False, True) for k in (10, RANK)
              for C in (128, 2048)]
    dtypes = (torch.float32, torch.bfloat16)
    # packed narrow rows (R = 4097: the last block takes fewer rows)
    cases += [(k, C, R, dt, True, True) for k in (10, RANK, 128) for C in (8, 32)
              for R in (1, 7, 4097) for dt in dtypes]
    # the training layout's bucket heights, so every packing it runs is held
    # here too (the user C = 8 bucket's 105,312 rows take the most)
    cases += [(RANK, C, R, dt, True, True) for C in (8, 32, 128, 512)
              for R in (6144, 19813) for dt in dtypes]
    cases += [(RANK, 8, 105312, torch.float32, True, True)]
    # split wide rows: the seg bucket's 42 rows and the 384 of C = 8,192
    cases += [(k, 8192, R, dt, True, True) for k in (10, RANK, 128) for R in (1, 42)
              for dt in dtypes]
    cases += [(RANK, 8192, 384, dt, True, True) for dt in dtypes]
    # an F off the 16-byte boundary: the plain-load route at every plan
    cases += [(k, C, R, dt, True, False) for k in (RANK, 128) for C, R in
              ((8, 4097), (512, 13), (8192, 42)) for dt in dtypes]
    for k, C, R, dtype, holes, aligned in cases:
        for kind in ("integer", "gaussian"):
            F, idx, wo, wb = gram_inputs(torch, g, dev, R, C, k, kind, holes=holes)
            F = F.to(dtype)
            if not aligned:
                F = misaligned(torch, F)
            A, b = ops.gather_gram(F, idx, wo, wb)
            Ar, br = gram_plain(torch, ops, F, idx, wo, wb)
            torch.cuda.synchronize()
            err = max((A - Ar).abs().max().item(), (b - br).abs().max().item())
            if kind == "integer":
                ok = torch.equal(A, Ar) and torch.equal(b, br)
                rel = 0.0
            else:
                A64, b64 = gram64(torch, F.float(), idx, wo, wb)
                rel = max(((A.double() - A64).abs().max()
                           / A64.abs().max().clamp_min(1e-300)).item(),
                          ((b.double() - b64).abs().max()
                           / b64.abs().max().clamp_min(1e-300)).item())
                ok = rel <= GRAM_TOL
                if k == RANK and C == 2048 and dtype == torch.float32 and not holes:
                    main_err = max(main_err, err)
                del A64, b64
            # A is mirrored from one triangle: symmetric on any data
            sym = torch.equal(A, A.transpose(1, 2))
            plan = ops.gram.gram_plan(R, C)
            print(f"gather_gram {kind:8s} {str(dtype)[6:]:8s} k={k:3d} C={C:4d} "
                  f"R={R:6d} split={plan.split} rows/block={plan.rows_per_block}"
                  f"{' holes' if holes else ''}{'' if aligned else ' unaligned F'} "
                  f"max_abs_err={err:.3e} rel64={rel:.3e} "
                  f"{'ok' if ok and sym else 'MISMATCH'}", flush=True)
            check(ok, f"gather_gram disagrees ({kind}, {dtype}, k={k}, C={C}, R={R})")
            check(sym, f"gather_gram A not symmetric ({kind}, k={k}, C={C}, R={R})")
            del F, idx, wo, wb, A, b, Ar, br
    for dtype in dtypes:
        A, b = ops.gather_gram(torch.zeros(5, RANK, device=dev, dtype=dtype),
                               torch.zeros(0, 8, device=dev, dtype=torch.int32),
                               torch.zeros(0, 8, device=dev), torch.zeros(0, 8, device=dev))
        check(A.shape == (0, RANK, RANK) and b.shape == (0, RANK),
              f"gather_gram R=0 ({dtype}) gave {tuple(A.shape)}, {tuple(b.shape)}")
    print("gather_gram R=0 (f32, bf16): empty outputs of the right shape, no launch",
          flush=True)
    return main_err


def multiplied_slots(torch, wo, wb, tile: int) -> int:
    """Slots the kernel gathers and multiplies, modelled from its rule (it
    counts nothing itself): in each tile of ``tile`` slots, those up to
    its last slot of nonzero weight. Exact for unsplit rows; a split
    chunk starts a tile of its own."""
    R, C = wo.shape
    live = torch.zeros((R, -(-C // tile) * tile), dtype=torch.bool, device=wo.device)
    live[:, :C] = (wo != 0) | (wb != 0)
    pos = torch.arange(1, tile + 1, device=wo.device)
    return int((live.view(R, -1, tile) * pos).amax(-1).sum().item())


def rows_gram_plain(torch, ops, F_g, wo, wb):
    """rows_gram_ref over row chunks (rows are independent), so the
    largest shapes fit on the card."""
    parts = [ops.rows_gram_ref(F_g[sl], wo[sl], wb[sl])
             for sl in _row_chunks(F_g.shape[0], F_g.shape[1] * F_g.shape[2])]
    return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])


def rows_plan(R: int, W: int):
    """The rows_gram kernel's plan for an (R, W) block (ops.rows_gram is
    the wrapper, so the module is looked up by name)."""
    import importlib

    return importlib.import_module("predictionio_tpu_torch.ops.rows_gram").rows_plan(R, W)


def check_rows_gram(torch, ops, dev) -> float:
    """Phase 3: rows_gram against rows_gram_ref (bitwise on integer data)
    and a float64 reference (max|dA| / max|A64| <= 1e-5 on Gaussian data
    with 20% zero weights; at wide W the plain version, cuBLAS, is itself
    up to 2.7e-5 off float64, so float64 is the reference), f32 and bf16
    F_g, A exactly symmetric and a rerun bitwise equal on every kind of
    data, R = 0. The blocks are gather_gram's inputs gathered, F_g =
    F[idx] (repeated rows, a quarter of pad slots, runs of zero weights
    mid-row), so gram64 is the float64 reference. Beside the first cases,
    every path of the kernel's plan: wide rows split into chunks (W =
    1,024, 2,048 and 8,192 at R = 1, 20, 42 and 128) and narrow rows
    packed several to a block (W = 8 and 32 at R = 4,096 and 105,312, and
    R = 4,097, where the last block takes fewer rows), with all-zero rows,
    and an F_g off the 16-byte boundary (the plain-load route). Returns
    the max abs error against the plain version at the training path's
    width (k=64, W=128, R=4096, Gaussian)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    main_err = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    # (k, W, R, dtype, holes, aligned)
    cases = [(k, W, R, f32, False, True) for k in (3, 8, RANK, 128)
             for W in (1, 16, 128, 2048) for R in (1, 20, 4096)]
    # the other widths of the training layout's ladder, at its k
    cases += [(RANK, W, R, f32, False, True) for W in (8, 32, 512, 8192)
              for R in (1, 20, 4096)]
    cases += [(k, W, 20, bf16, False, True) for k in (3, 8, RANK, 128) for W in (16, 2048)]
    # split wide rows, and packed narrow rows, with all-zero rows
    cases += [(RANK, W, R, f32, True, True) for W in (1024, 2048, 8192)
              for R in (1, 20, 42, 128)]
    cases += [(k, 8192, 42, dt, True, True) for k in (10, RANK, 128) for dt in (f32, bf16)]
    cases += [(RANK, W, R, f32, True, True) for W in (8, 32) for R in (4096, 4097, 105312)]
    cases += [(k, W, 4097, dt, True, True) for k in (10, RANK, 128) for W in (8, 32)
              for dt in (f32, bf16)]
    # an F_g off the 16-byte boundary: the plain-load route at every plan
    cases += [(RANK, W, R, dt, True, False) for W, R in ((8, 4097), (128, 20), (8192, 42))
              for dt in (f32, bf16)]
    for k, W, R, dtype, holes, aligned in cases:
        for kind in ("integer", "gaussian"):
            F, idx, wo, wb = gram_inputs(torch, g, dev, R, W, k, kind, holes=holes)
            if not holes:
                # every third row also gets a run of zero weights mid-row,
                # so the kernel skips whole tiles and then resumes
                wo[::3, W // 4:W // 2] = 0.0
                wb[::3, W // 4:W // 2] = 0.0
            F = F.to(dtype)
            F_g = F[idx.long()]
            if not aligned:
                F_g = misaligned(torch, F_g)
            A, b = ops.rows_gram(F_g, wo, wb)
            A2, b2 = ops.rows_gram(F_g, wo, wb)
            Ar, br = rows_gram_plain(torch, ops, F_g, wo, wb)
            torch.cuda.synchronize()
            err = max((A - Ar).abs().max().item(), (b - br).abs().max().item())
            if kind == "integer":
                ok = torch.equal(A, Ar) and torch.equal(b, br)
                rel = 0.0
            else:
                A64, b64 = gram64(torch, F.float(), idx, wo, wb)
                rel = max(((A.double() - A64).abs().max()
                           / A64.abs().max().clamp_min(1e-300)).item(),
                          ((b.double() - b64).abs().max()
                           / b64.abs().max().clamp_min(1e-300)).item())
                ok = rel <= GRAM_TOL
                if k == RANK and W == 128 and R == 4096 and dtype == f32 and not holes:
                    main_err = err
                del A64, b64
            # A is mirrored from one triangle: symmetric on any data; the
            # split chunks are summed in a fixed order: a rerun is bitwise
            sym = torch.equal(A, A.transpose(1, 2))
            same = torch.equal(A, A2) and torch.equal(b, b2)
            plan = rows_plan(R, W)
            print(f"rows_gram {kind:8s} {str(dtype)[6:]:8s} k={k:3d} W={W:4d} "
                  f"R={R:6d} split={plan.split} rows/block={plan.rows_per_block}"
                  f"{' holes' if holes else ''}{'' if aligned else ' unaligned F_g'} "
                  f"max_abs_err={err:.3e} rel64={rel:.3e} rerun_bitwise={same} "
                  f"{'ok' if ok and sym and same else 'MISMATCH'}", flush=True)
            check(ok, f"rows_gram disagrees ({kind}, {dtype}, k={k}, W={W}, R={R})")
            check(sym, f"rows_gram A not symmetric ({kind}, k={k}, W={W}, R={R})")
            check(same, f"rows_gram rerun differs ({kind}, k={k}, W={W}, R={R})")
            del F, F_g, idx, wo, wb, A, b, A2, b2, Ar, br
    for dtype in (f32, bf16):
        A, b = ops.rows_gram(torch.zeros(0, 16, RANK, device=dev, dtype=dtype),
                             torch.zeros(0, 16, device=dev), torch.zeros(0, 16, device=dev))
        check(A.shape == (0, RANK, RANK) and b.shape == (0, RANK),
              f"rows_gram R=0 ({dtype}) gave {tuple(A.shape)}, {tuple(b.shape)}")
    print("rows_gram R=0 (f32, bf16): empty outputs of the right shape, no launch",
          flush=True)
    return main_err


def spd_systems(torch, g, dev, N, k, lam=0.01):
    """ALS-like SPD systems: A = G Gᵀ + λ·n·I with n = 2k rating rows."""
    n = 2 * k
    G = torch.randn(N, k, n, generator=g, device=dev)
    A = torch.bmm(G, G.transpose(1, 2)) + lam * n * torch.eye(k, device=dev)
    b = torch.randn(N, k, generator=g, device=dev)
    return A.contiguous(), b


def check_chol_solve(torch, ops, dev) -> float:
    """Phase 3: chol_solve against float64 and chol_solve_ref at every KP
    boundary of the kernel (k = 1 … 128): ALS-like systems (max|x - x64| /
    max|x64| <= 1e-4 over the batch) and the same systems ill-scaled, each
    multiplied by 10^u, u uniform in [-2, 4) as in the CPU tests (the
    same ratio, taken per system, <= 1e-4); identity systems give x = b
    exactly. Returns the max abs error against the plain version at the
    training path's width (k=64, N=138,493)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    main_err = 0.0
    cases = [(k, N) for k in (1, 7, 8, 10, 16, 31, 33, 63, RANK, 65, 100, 128)
             for N in (1, 255, 4097)] + [(RANK, N_USERS)]
    for k, N in cases:
        A, b = spd_systems(torch, g, dev, N, k)
        x = ops.chol_solve(A, b)
        xr = ops.chol_solve_ref(A, b)
        x64 = torch.linalg.solve(A.double(), b.double())
        torch.cuda.synchronize()
        rel = ((x.double() - x64).abs().max() / x64.abs().max()).item()
        err = (x - xr).abs().max().item()
        # ill-scaled: per system 10^u, u in [-2, 4)
        scale = 10.0 ** (torch.rand(N, 1, 1, generator=g, device=dev) * 6 - 2)
        As = (A * scale).contiguous()
        xs = ops.chol_solve(As, b)
        xs64 = torch.linalg.solve(As.double(), b.double())
        rel_s = ((xs.double() - xs64).abs().amax(1)
                 / xs64.abs().amax(1)).max().item()
        eye = torch.eye(k, device=dev).expand(N, k, k).contiguous()
        exact = torch.equal(ops.chol_solve(eye, b), b)
        ok = rel <= SOLVE_TOL and rel_s <= SOLVE_TOL and exact
        print(f"chol_solve k={k:3d} N={N:6d} rel64={rel:.3e} "
              f"ill_scaled_rel64={rel_s:.3e} max_abs_err(plain)={err:.3e} "
              f"identity_exact={exact} {'ok' if ok else 'MISMATCH'}", flush=True)
        check(rel <= SOLVE_TOL, f"chol_solve off float64 (k={k}, N={N}): {rel:.3e}")
        check(rel_s <= SOLVE_TOL,
              f"chol_solve off float64 on ill-scaled systems (k={k}, N={N}): {rel_s:.3e}")
        check(exact, f"chol_solve identity systems not exact (k={k}, N={N})")
        if k == RANK and N == N_USERS:
            main_err = err
        del A, b, x, xr, x64, As, xs, xs64, eye
    return main_err


#: phase 4's cells of the k > 32 path, (B, k): k = 64, 128 and 1,024 are
#: what served queries with num = 50, 100 and 1,000 reach
BAR_CELLS = [(B, k) for k in (64, 128, 1024) for B in (1, 8, 64)] + [
    (B, k) for k in (256, 512) for B in (1, 64)]
#: phase 4's cells of `pio batchpredict` (1,024 queries a dispatch): num 10
#: and num 100 serve at k = 16 and 128
BATCHPREDICT_CELLS = [(1024, 16), (1024, 128)]


def time_score_topk(torch, ops, dev):
    """Phase 4: times at the serving path's shapes (d=64, Np=28,672,
    k=16, every bucket of the default ladder), then at the k > 32 path's
    BAR_CELLS (serving reaches it when num plus the excluded items exceeds
    32). Returns every cell's row by (B, k)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    U = torch.randn(N_USERS, RANK, generator=g, device=dev)
    Vp = torch.cat([torch.randn(N_ITEMS, RANK, generator=g, device=dev),
                    torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
    rows = {}
    shapes = [(B, AOT_TOPK) for B in (1, 2, 4, 8, 16, 32, 64)]
    shapes += BAR_CELLS + BATCHPREDICT_CELLS
    for B, k in shapes:
        ids = torch.randint(0, N_USERS, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        out = (torch.empty(B, k, device=dev),
               torch.empty(B, k, device=dev, dtype=torch.int32))
        kernel, kernel_call = cuda_ms(lambda: ops.score_topk(
            U, Vp, k, n_valid=N_ITEMS, rows_valid=B, ids=ids, out=out))
        plain, plain_call = cuda_ms(lambda: ops.score_topk_ref(
            U, Vp, k, n_valid=N_ITEMS, rows_valid=B, ids=ids))
        library, library_call = cuda_ms(lambda: torch.topk(
            U[ids.long()] @ Vp[:N_ITEMS].T, k))
        bound, bound_by = score_topk_bound_ms(B, RANK, N_ITEMS, k)
        rows[B, k] = {"ms": kernel, "plain_ms": plain, "library_ms": library,
                      "bound_ms": bound, "bound_by": bound_by}
        print(f"score_topk time B={B:2d} k={k} device ms: kernel={kernel:.4f} "
              f"plain={plain:.4f} library(torch.topk)={library:.4f} "
              f"bound={bound:.5f} ({bound_by}); per call ms: "
              f"kernel={kernel_call:.4f} plain={plain_call:.4f} "
              f"library={library_call:.4f}", flush=True)
    return rows


def reset_counters(ops) -> None:
    for c in ops.LAUNCH_COUNTERS:
        c.launches = 0


def read_counters(ops) -> dict:
    return {c.__name__: c.launches for c in ops.LAUNCH_COUNTERS}


def oracle_entities(side, rng, n_heavy: int = 8, n_total: int = 64):
    """Original ids of n_total entities of one side: the heaviest of the
    dense head and the seg bucket (n_heavy in all), the rest drawn by
    seed across the ladder buckets."""
    import numpy as np

    nb_dense = side.dense.nb if side.dense is not None else 0
    segs = [b for b in side.buckets if b.seg is not None]
    nb_seg = segs[0].nb if segs else 0
    half = n_heavy // 2
    pos = list(range(min(half, nb_seg)))
    pos = [nb_dense + p for p in pos]
    pos = list(range(min(n_heavy - len(pos), nb_dense))) + pos
    if len(pos) < n_heavy:  # a short head: more of the seg bucket
        pos += [nb_dense + p for p in range(half, min(nb_seg, half + n_heavy - len(pos)))]
    regs, start = [], nb_dense + nb_seg
    for b in side.buckets:
        if b.seg is None:
            regs.append((b.nb, start))
            start += b.nb
    # smallest buckets first, so a short bucket's share passes to the next
    want = n_total - len(pos)
    for j, (nb, start) in enumerate(sorted(regs)):
        take = min(nb, want // (len(regs) - j))
        pos += [start + int(p) for p in rng.choice(nb, size=take, replace=False)]
        want -= take
    return side.perm[np.asarray(pos, np.int64)]


def normal_equations_err(torch, dev, self_idx, other_idx, rating, F_other,
                         X_self, chosen, lam) -> float:
    """max|X[e] - x64[e]| / max|x64| over ``chosen``, x64 the float64 solve
    of (Σ f fᵀ + λ·n_e·I) x = Σ r f over e's ratings in the raw COO
    (duplicates counted, f the other side's factor rows)."""
    import numpy as np

    sel = np.isin(self_idx, chosen)
    s_idx, o_idx, r = self_idx[sel], other_idx[sel], rating[sel]
    order = np.argsort(s_idx, kind="stable")
    s_idx, o_idx, r = s_idx[order], o_idx[order], r[order]
    F64 = torch.as_tensor(F_other, device=dev).double()
    k = F64.shape[1]
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    diff = scale = 0.0
    for e in chosen:
        lo, hi = np.searchsorted(s_idx, [e, e + 1])
        f = F64[torch.as_tensor(o_idx[lo:hi].astype(np.int64), device=dev)]
        rr = torch.as_tensor(r[lo:hi], device=dev).double()
        A = f.T @ f + max(lam * (hi - lo), 1e-8) * eye
        x = torch.linalg.solve(A, f.T @ rr)
        got = torch.as_tensor(X_self[e], device=dev).double()
        diff = max(diff, (got - x).abs().max().item())
        scale = max(scale, x.abs().max().item())
    return diff / scale


@contextlib.contextmanager
def tf32_matmuls(torch):
    """TF32 allowed for f32 matmuls for the duration (the state a caller
    may leave the process in; the port's training must not depend on it)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def precision_controls(torch, dev, prep, p, coo, U, V9, items_chk, users_chk):
    """Phase 5 controls: the last iteration rerun from the second-to-last
    V with less precision, held against the same float64 normal
    equations as the run itself and against the run's final U — the
    gathers in bf16 (``bf16_gather``), or the dense head's matmuls in
    TF32 with the port's f32 guard taken out. Each must fail the float64
    check (items or users) and move U: the checks can tell it from f32."""
    import numpy as np

    from predictionio_tpu_torch.models import als

    out = {}
    for name, params, guard in (
            ("bf16 gathers", dataclasses.replace(p, iterations=1, bf16_gather=True),
             als.full_f32),
            ("TF32 dense head, guard removed", dataclasses.replace(p, iterations=1),
             contextlib.nullcontext)):
        with tf32_matmuls(torch), mock.patch.object(als, "full_f32", guard):
            Uc, Vc = als.als_train_prepared(prep, params, device=dev, V0=V9)
        err_v = normal_equations_err(torch, dev, coo.item_idx, coo.user_idx,
                                     coo.rating, Uc, Vc, items_chk, LAMBDA)
        err_u = normal_equations_err(torch, dev, coo.user_idx, coo.item_idx,
                                     coo.rating, V9, Uc, users_chk, LAMBDA)
        rel_u = np.abs(Uc - U).max() / np.abs(U).max()
        out[name] = (err_v, err_u, rel_u)
        print(f"control ({name}): float64 normal equations, items "
              f"{err_v:.3e}, users {err_u:.3e} (the f32 run's limit "
              f"{ORACLE_TOL}); U off the f32 run's final U by {rel_u:.3e} "
              f"(relative to max|U|)", flush=True)
        check(max(err_v, err_u) > ORACLE_TOL and rel_u > 0,
              f"control ({name}) passes the checks the f32 run is held to: "
              f"they cannot tell it from f32")
    return out


def train_full_width(torch, ops, dev) -> dict:
    """Phase 5: the training path at ML-20M width on the card, with TF32
    turned on around it: the port's guard keeps its matmuls at f32."""
    import numpy as np

    from predictionio_tpu_torch.models.als import (ALSParams, RatingsCOO,
                                                   als_prepare,
                                                   als_train_prepared)

    t0 = time.perf_counter()
    users, items, ratings = synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS)
    coo = RatingsCOO(users, items, ratings, N_USERS, N_ITEMS)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = als_prepare(coo)
    t_prep = time.perf_counter() - t0
    heaviest = {"user": int(np.bincount(users).max()),
                "item": int(np.bincount(items).max())}
    for name, side in (("user", prep.u_side), ("item", prep.i_side)):
        buckets = ", ".join(
            f"{'seg ' if b.seg is not None else ''}C={b.C} nb={b.nb} "
            f"rows={b.n_slabs * b.slab}" for b in side.buckets)
        slots = sum(b.n_slabs * b.slab * b.C for b in side.buckets)
        dense = (f"{side.dense.nb} x {side.dense.n_other}"
                 if side.dense is not None else "none")
        print(f"{name} side: {side.n} entities (heaviest {heaviest[name]} "
              f"ratings), dense head {dense}, {slots} padded slots; "
              f"buckets: {buckets}", flush=True)
    print(f"synthetic COO {N_USERS} x {N_ITEMS}, {coo.nnz} ratings in "
          f"{t_gen:.1f} s; host prep (als_prepare) {t_prep:.1f} s", flush=True)

    p = ALSParams(rank=RANK, iterations=ITERATIONS, reg=LAMBDA,
                  weighted_reg=True, implicit=False, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(ops)
    t0 = time.perf_counter()
    with tf32_matmuls(torch):
        U, V = als_train_prepared(prep, p, device=dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counters(ops)
    print(f"train: {ITERATIONS} iterations rank {RANK} in {t_train:.3f} s "
          f"wall (upload, train, fetch); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
          f"launches {launches}", flush=True)
    for name in ("gather_gram", "chol_solve"):
        check(launches[name] > 0, f"kernel {name} was not launched by training")
    check(np.isfinite(U).all() and np.isfinite(V).all(), "non-finite factors")

    # a second run, timed warm (layout already on the card)
    t0 = time.perf_counter()
    with tf32_matmuls(torch):
        U9, V9 = als_train_prepared(
            prep, dataclasses.replace(p, iterations=ITERATIONS - 1), device=dev)
    torch.cuda.synchronize()
    t_train9 = time.perf_counter() - t0
    # the final U half-step again, from the second-to-last V, at PyTorch's
    # default f32 matmuls: bitwise equal only if TF32 did not reach the
    # dense head of the run above
    U_re, _ = als_train_prepared(prep, dataclasses.replace(p, iterations=0),
                                 device=dev, V0=V9)
    rel_re = np.abs(U_re - U).max() / np.abs(U).max()
    print(f"warm train of {ITERATIONS - 1} iterations {t_train9:.3f} s wall; "
          f"the final U half-step rerun from it without TF32 differs from the "
          f"final U by {rel_re:.3e} (relative to max|U|)", flush=True)
    check(np.array_equal(U_re, U),
          f"rerun U half-step not bitwise the final U: {rel_re:.3e}")

    Ut = torch.as_tensor(U, device=dev)
    Vt = torch.as_tensor(V, device=dev)
    sq = 0.0
    for s in range(0, coo.nnz, 1 << 24):
        uu = torch.as_tensor(users[s:s + (1 << 24)].astype(np.int64), device=dev)
        ii = torch.as_tensor(items[s:s + (1 << 24)].astype(np.int64), device=dev)
        rr = torch.as_tensor(ratings[s:s + (1 << 24)], device=dev)
        sq += ((Ut[uu] * Vt[ii]).sum(1) - rr).double().pow(2).sum().item()
    rmse = (sq / coo.nnz) ** 0.5
    print(f"training RMSE {rmse:.4f} (ratings 0.5..5.0)", flush=True)
    check(rmse < 2.0, f"training RMSE {rmse:.4f} is not that of a fitted model")

    rng = np.random.default_rng(SEED + 5)
    items_chk = oracle_entities(prep.i_side, rng)
    users_chk = oracle_entities(prep.u_side, rng)
    err_v = normal_equations_err(torch, dev, items, users, ratings, U, V,
                                 items_chk, LAMBDA)
    err_u = normal_equations_err(torch, dev, users, items, ratings, V9, U_re,
                                 users_chk, LAMBDA)
    print(f"float64 normal equations: {len(items_chk)} items given the final "
          f"U {err_v:.3e}, {len(users_chk)} users given the second-to-last V "
          f"{err_u:.3e} (max|x - x64| / max|x64|, limit {ORACLE_TOL})", flush=True)
    check(err_v <= ORACLE_TOL, f"items off their normal equations: {err_v:.3e}")
    check(err_u <= ORACLE_TOL, f"users off their normal equations: {err_u:.3e}")
    precision_controls(torch, dev, prep, p, coo, U, V9, items_chk, users_chk)
    return {"prep": prep, "coo": coo, "U": U, "V": V, "V9": V9,
            "launches": launches, "t_train": t_train, "rmse": rmse}


EVAL_RATINGS = 6_000_000  # phase 5's first ratings that phase 9 evaluates over


def eval_full_width(torch, ops, dev, train) -> dict:
    """Phase 9: `pio eval` at ML-20M width on the card, distributed.

    The first EVAL_RATINGS of phase 5's synthetic COO (not generated
    again; the vocabularies stay ML-20M's) become the template's
    TrainingData (ids "u<j>" and "i<j>"), served by a RecDataSource whose
    `_read` returns it, so `read_eval` (the seeded fold draw, `subset`'s
    trimmed vocabularies, the query dicts), `sweep_programs` and the sweep
    run as they do on an event store. `run_evaluation(distributed=True)`
    evaluates rank 64, 10 iterations, seed 3, lambda 0.01 and 0.1 over
    evalK 2: one bucket a fold, two candidates. Checks: every
    candidate's fold scores equal a float64 recomputation (the candidate
    trained again with `als_train_prepared` on that fold's layout, the
    held-out pairs drawn again in numpy) within EVAL_TOL, with the same
    ranking; the launch counters, zeroed just before the sweep, read
    exactly candidates x iterations x (buckets + parts) launches of
    gather_gram and chol_solve summed over the folds; the best
    candidate's fold-0 factors hold their float64 normal equations (64
    items, ORACLE_TOL). The serial path is not run at this width: it
    answers 10 M `predict_rating` calls in Python per candidate and fold.
    Phase 7 holds it against the distributed path instead."""
    import resource

    import numpy as np

    from predictionio_tpu_torch.controller import (Engine, EngineParams,
                                                   Evaluation, FirstServing)
    from predictionio_tpu_torch.core.workflow import run_evaluation
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.storage import leaderboard as lb
    from predictionio_tpu_torch.templates.recommendation import engine as rec
    from predictionio_tpu_torch.utils.bimap import BiMap

    t_phase = time.perf_counter()
    coo = train["coo"]
    coo = dataclasses.replace(coo, user_idx=coo.user_idx[:EVAL_RATINGS],
                              item_idx=coo.item_idx[:EVAL_RATINGS],
                              rating=coo.rating[:EVAL_RATINGS])
    td = rec.TrainingData(coo.user_idx, coo.item_idx, coo.rating,
                          BiMap({f"u{j}": j for j in range(coo.n_users)}),
                          BiMap({f"i{j}": j for j in range(coo.n_items)}))
    folds_seen = []

    class ML20MSource(rec.RecDataSource):
        def _read(self, ctx):
            return td

        def read_eval(self, ctx):
            t0 = time.perf_counter()
            folds = super().read_eval(ctx)
            print(f"read_eval: {len(folds)} folds of {td.n} ratings, "
                  f"{sum(len(qa) for _, _, qa in folds)} held-out queries, "
                  f"{time.perf_counter() - t0:.1f} s wall", flush=True)
            folds_seen.extend(folds)
            return folds

    class ML20MEvaluation(Evaluation):
        engine_factory = staticmethod(lambda: Engine(
            ML20MSource, rec.RecPreparator, {"als": rec.ALSAlgorithm}, FirstServing))
        metric = rec.NegRMSE()

    lams, eval_k, seed = (0.01, 0.1), 2, 3
    cands = [EngineParams(
        data_source_params=rec.DataSourceParams(app_name="ml20m", eval_k=eval_k),
        algorithms_params=[("als", rec.ALSAlgorithmParams(
            rank=RANK, num_iterations=ITERATIONS, lambda_=lam, seed=seed))])
        for lam in lams]
    preps = []
    prepare = als.als_prepare

    def timed_prepare(fold_coo):
        t0 = time.perf_counter()
        prep = prepare(fold_coo)
        print(f"fold {len(preps)}: als_prepare of {fold_coo.nnz} ratings "
              f"({fold_coo.n_users} x {fold_coo.n_items}) "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        preps.append(prep)
        return prep

    with tempfile.TemporaryDirectory(prefix="pio_chip_eval_") as home:
        reset_counters(ops)
        t0 = time.perf_counter()
        with mock.patch.object(als, "als_prepare", timed_prepare):
            iid, result = run_evaluation(
                ML20MEvaluation(), cands, storage=Storage(StorageConfig(home=home)),
                distributed=True, device=dev, verbose=1)
        t_eval = time.perf_counter() - t0
        launches = read_counters(ops)
        doc = lb.read(home, iid)
    print(f"run_evaluation (distributed): {t_eval:.1f} s wall, sweep "
          f"{doc['wallSeconds']:.1f} s of which {doc['deviceSeconds']:.3f} s in "
          f"{doc['dispatches']} dispatches (buckets={doc['buckets']} "
          f"compiles={doc['compiles']}); kernel launches {launches}", flush=True)
    check(len(preps) == len(folds_seen) == eval_k, f"{len(preps)} fold layouts")
    check(doc["compiles"] <= doc["buckets"] == eval_k, f"{doc['buckets']} buckets")

    # the launches: each half-step launches gather_gram once a bucket and
    # chol_solve once a part (the dense head is a part without a bucket)
    want = {"gather_gram": 0, "chol_solve": 0, "score_topk": 0, "rows_gram": 0}
    for f, prep in enumerate(preps):
        buckets = sum(len(s.buckets) for s in (prep.u_side, prep.i_side))
        parts = buckets + sum(s.dense is not None for s in (prep.u_side, prep.i_side))
        print(f"fold {f} layout: {buckets} buckets, {parts} parts "
              f"(user {[b.C for b in prep.u_side.buckets]}, item "
              f"{[b.C for b in prep.i_side.buckets]}, dense heads "
              f"{[s.dense.nb if s.dense is not None else 0 for s in (prep.u_side, prep.i_side)]})",
              flush=True)
        want["gather_gram"] += len(cands) * ITERATIONS * buckets
        want["chol_solve"] += len(cands) * ITERATIONS * parts
    print(f"expected launches {want} (candidates x iterations x buckets or parts, "
          f"summed over the folds)", flush=True)
    check(launches == want, f"eval launches {launches}, expected {want}")

    # every fold score against a float64 recomputation
    fold_of = np.random.default_rng(rec.DataSourceParams().eval_seed).integers(
        0, eval_k, size=td.n)
    worst, best_uv = 0.0, None
    best = result.best_index
    recomputed = [[0.0] * eval_k for _ in cands]
    sq_sums, warm = [[0.0] * eval_k for _ in cands], [0] * eval_k
    t0 = time.perf_counter()
    for f, ((fold_td, _, qa), prep) in enumerate(zip(folds_seen, preps)):
        train_rows, test = fold_of != f, fold_of == f
        check(len(qa) == int(test.sum()), f"fold {f}: {len(qa)} queries")
        luts = []
        for idx, n in ((coo.user_idx, coo.n_users), (coo.item_idx, coo.n_items)):
            lut = np.full(n, -1, np.int64)
            seen = np.unique(idx[train_rows])
            lut[seen] = np.arange(len(seen))
            luts.append(lut[idx[test]])
        uq, iq = luts
        rq = coo.rating[test].astype(np.float64)
        valid = (uq >= 0) & (iq >= 0)
        uq, iq, rq = uq[valid], iq[valid], rq[valid]
        for c, lam in enumerate(lams):
            p = als.ALSParams(rank=RANK, iterations=ITERATIONS, reg=lam, seed=seed)
            U, V = als.als_train_prepared(prep, p, device=dev)
            sq = 0.0
            for s in range(0, len(uq), 1 << 20):
                u, i = uq[s:s + (1 << 20)], iq[s:s + (1 << 20)]
                pred = np.einsum("nk,nk->n", U[u].astype(np.float64),
                                 V[i].astype(np.float64))
                sq += float(((pred - rq[s:s + (1 << 20)]) ** 2).sum())
            sq_sums[c][f], warm[f] = sq, len(uq)
            recomputed[c][f] = -(sq / len(uq)) ** 0.5
            got = doc_fold_score(doc, c, f)
            worst = max(worst, abs(got - recomputed[c][f]) / abs(recomputed[c][f]))
            if c == best and f == 0:
                best_uv = (fold_td, U, V, lam)
        print(f"fold {f}: {int(valid.sum())} of {len(valid)} held-out pairs warm; "
              f"NegRMSE sweep {[doc_fold_score(doc, c, f) for c in range(len(lams))]} "
              f"float64 {[recomputed[c][f] for c in range(len(lams))]}", flush=True)
    totals = [-(sum(sq) / sum(warm)) ** 0.5 for sq in sq_sums]
    scores = [sc for _, sc, _ in result.candidates]
    worst = max([worst] + [abs(a - b) / abs(b) for a, b in zip(scores, totals)])
    print(f"sweep fold scores against float64: max relative difference "
          f"{worst:.3e} (limit {EVAL_TOL}); recomputation {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(worst <= EVAL_TOL, f"sweep scores off float64 by {worst:.3e}")
    for f in range(eval_k):
        ranks_sweep = lb.rank_candidates([doc_fold_score(doc, c, f) for c in range(len(lams))],
                                         True)
        ranks_64 = lb.rank_candidates([recomputed[c][f] for c in range(len(lams))], True)
        check(ranks_sweep == ranks_64, f"fold {f} ranks {ranks_sweep} vs {ranks_64}")
    check(lb.rank_candidates(scores, True) == lb.rank_candidates(totals, True),
          f"sweep ranks {scores} unlike float64 {totals}")
    print(f"NegRMSE over both folds: sweep {scores}, float64 {totals}; best "
          f"candidate {best} (lambda {lams[best]})", flush=True)

    fold_td, U, V, lam = best_uv
    items_chk = oracle_entities(preps[0].i_side, np.random.default_rng(SEED + 9))
    err_v = normal_equations_err(torch, dev, fold_td.item_idx, fold_td.user_idx,
                                 fold_td.rating, U, V, items_chk, lam)
    print(f"best candidate (lambda {lam}) on fold 0: {len(items_chk)} items off "
          f"their float64 normal equations by {err_v:.3e} (limit {ORACLE_TOL})",
          flush=True)
    check(err_v <= ORACLE_TOL, f"fold-0 items off their normal equations: {err_v:.3e}")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s wall; host peak RSS "
          f"{rss:.1f} GiB", flush=True)
    return {"launches": launches, "t_eval": t_eval, "doc": doc}


def doc_fold_score(doc: dict, index: int, fold: int) -> float:
    """Fold score of the candidate at ``index`` in a leaderboard."""
    return next(e["foldScores"][fold] for e in doc["entries"] if e["index"] == index)


def profile_training(torch, dev, train) -> None:
    """--profile: device time by kernel of one warm training iteration
    (both half-steps) at the phase-5 layout, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.models.als import ALSParams, als_train_prepared

    p = ALSParams(rank=RANK, iterations=1, reg=LAMBDA, seed=SEED)
    als_train_prepared(train["prep"], p, device=dev, V0=train["V"])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        als_train_prepared(train["prep"], p, device=dev, V0=train["V"])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        # kernels only (device-side events), not the host ops launching them
        if dev_us and ev.count and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us, ev.count, ev.key))
    total = sum(r[0] for r in rows)
    print(f"profile: one training iteration (upload of V, both half-steps, "
          f"fetch) {wall:.3f} ms wall, {total / 1e3:.3f} ms of kernels on "
          f"the card", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        print(f"profile train {key[:70]:70s} calls={count:3d} "
              f"device_ms={dev_us / 1e3:.3f} ({100 * dev_us / total:.1f}%)",
              flush=True)


def gram_bound(R: int, C: int, k: int, slots: int, f_rows: int, f_bytes: int = 4):
    """(seconds at the f32 rate, seconds at the memory rate) of the work
    one gather_gram launch needs: per slot of nonzero weight (``slots``)
    k(k+1)/2 FMAs for the lower triangle of the symmetric A, k for w·f and
    k for b; idx, wo and wb read once, each row of F that a slot of
    nonzero weight gathers (``f_rows`` distinct rows) read once, A and b
    written once."""
    flops = slots * (k * k + 5 * k)
    nbytes = 12 * R * C + f_rows * k * f_bytes + 4 * R * (k * k + k)
    return flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES


def solve_bound(N: int, k: int):
    """(seconds at the f32 rate, seconds at the memory rate) of the work
    one chol_solve launch needs: the lower triangle of A and b read once,
    x written once; k³/3 FLOP of Cholesky and 2k² of the two triangular
    solves per system."""
    flops = N * (k ** 3 / 3 + 2 * k * k)
    nbytes = 4 * N * (k * (k + 1) // 2 + 2 * k)
    return flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES


def add_bound(row: dict, flop_s: float, byte_s: float) -> float:
    """Adds one launch's bound (the larger of its two times) to ``row``'s
    sums; returns it in ms."""
    key = "ops_bound_s" if flop_s >= byte_s else "bytes_bound_s"
    row[key] += max(flop_s, byte_s)
    return max(flop_s, byte_s) * 1e3


def gram_library(torch, F, idx, wo, wb):
    """One PyTorch formulation of the same function: gather, then bmm of
    the weighted block (row chunks, so the largest bucket fits)."""
    outs = []
    for sl in _row_chunks(idx.shape[0], idx.shape[1] * F.shape[1]):
        G = F[idx[sl].long()]
        A = torch.bmm((G * wo[sl, :, None]).transpose(1, 2), G)
        b = torch.bmm(wb[sl, None, :], G)[:, 0]
        outs.append((A, b))
    return outs


def rel64(A, b, A64, b64) -> float:
    """max|dA| / max|A64| and max|db| / max|b64|, the larger."""
    return max(((A.double() - A64).abs().max() / A64.abs().max()).item(),
               ((b.double() - b64).abs().max() / b64.abs().max()).item())


def time_training_kernels(torch, ops, dev, train) -> dict:
    """Phase 6: gather_gram on every bucket of the ML-20M layout (both
    half-steps of one iteration, the trained factors as F) and chol_solve
    at both sides' N, each beside its plain version, one library call and
    the bound. Each bucket's result is held against a float64 reference
    (max|dA| / max|A64| and max|db| / max|b64| <= 1e-5, A exactly
    symmetric; the plain version's distance is printed beside), and where
    its plan packs rows, the bucket is timed again with one row a block,
    which must give the same bits. Returns the per-iteration sums."""
    import numpy as np

    from predictionio_tpu_torch.ops import _build

    prep, U, V = train["prep"], train["U"], train["V"]
    out = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_bound_s=0.0,
                      bytes_bound_s=0.0) for name in ("gather_gram", "chol_solve")}
    g = out["gather_gram"]
    tile = _build.load("gather_gram").pio_gather_gram_tile_slots(RANK)
    slot_sums = dict(padded=0, rated=0, multiplied=0)
    worst = worst_plain = packed_ms = one_row_ms = 0.0
    for name, side, F_np in (("user", prep.u_side, V), ("item", prep.i_side, U)):
        # the factors in the other side's permuted order, as training holds them
        other = prep.i_side if side is prep.u_side else prep.u_side
        F = torch.as_tensor(F_np[other.perm]).to(dev)
        for b in side.buckets:
            R = b.n_slabs * b.slab
            label = (f"{name} {'seg ' if b.seg is not None else ''}bucket "
                     f"R={R} C={b.C}")
            idx = torch.as_tensor(b.other_idx.reshape(R, b.C)).to(dev)
            wo = torch.as_tensor(b.mask.reshape(R, b.C)).to(dev)
            wb = torch.as_tensor((b.vals * b.mask).reshape(R, b.C)).to(dev)
            A, bv = ops.gather_gram(F, idx, wo, wb)
            Ar, br = gram_plain(torch, ops, F, idx, wo, wb)
            A64, b64 = gram64(torch, F, idx, wo, wb)
            rel, rel_plain = rel64(A, bv, A64, b64), rel64(Ar, br, A64, b64)
            sym = torch.equal(A, A.transpose(1, 2))
            check(bool(torch.isfinite(A).all()) and rel <= GRAM_TOL and sym,
                  f"gather_gram on {label}: off float64 {rel:.3e}, symmetric {sym}")
            worst, worst_plain = max(worst, rel), max(worst_plain, rel_plain)
            del Ar, br, A64, b64
            iters = 20 if R * b.C < (1 << 22) else 5
            kern, _ = cuda_ms(lambda: ops.gather_gram(F, idx, wo, wb), iters=iters,
                              warmup=2)
            plan = ops.gram.gram_plan(R, b.C)
            one_row = ""
            if plan.rows_per_block > 1:
                one = ops.gram.GramPlan(1, b.C, 1)
                with mock.patch.object(ops.gram, "gram_plan", lambda *_: one):
                    A1, b1 = ops.gather_gram(F, idx, wo, wb)
                    one_ms, _ = cuda_ms(lambda: ops.gather_gram(F, idx, wo, wb),
                                        iters=iters, warmup=2)
                check(torch.equal(A1, A) and torch.equal(b1, bv),
                      f"gather_gram on {label}: one row a block changed the result")
                packed_ms += kern
                one_row_ms += one_ms
                one_row = f" one-row-a-block={one_ms:.4f}"
                del A1, b1
            del A, bv
            plain, _ = cuda_ms(lambda: gram_plain(torch, ops, F, idx, wo, wb),
                               iters=3, warmup=1)
            lib, _ = cuda_ms(lambda: gram_library(torch, F, idx, wo, wb),
                             iters=3, warmup=1)
            live = (wo != 0) | (wb != 0)
            slots = int(np.count_nonzero(b.mask))
            f_rows = int(torch.unique(idx[live]).numel())
            done = multiplied_slots(torch, wo, wb, tile)
            fs, bs = gram_bound(R, b.C, RANK, slots, f_rows)
            g["ms"] += kern
            g["plain_ms"] += plain
            g["library_ms"] += lib
            for key, n in (("padded", R * b.C), ("rated", slots), ("multiplied", done)):
                slot_sums[key] += n
            bound = add_bound(g, fs, bs)
            print(f"gather_gram time {label} k={RANK} ({R * b.C} padded slots, "
                  f"{slots} rated, {done} multiplied (modelled), {f_rows} rows "
                  f"of F; split={plan.split} rows/block={plan.rows_per_block}) "
                  f"off float64 {rel:.3e} (plain {rel_plain:.3e}) device "
                  f"ms: kernel={kern:.4f}{one_row} plain={plain:.4f} "
                  f"library(F[idx]+bmm)={lib:.4f} bound={bound:.4f} "
                  f"({'operations' if fs >= bs else 'bytes'}; f32 FMA "
                  f"{fs * 1e3:.4f}, bytes {bs * 1e3:.4f}); "
                  f"{slots * (RANK * RANK + 5 * RANK) / kern / 1e9:.2f} "
                  f"needed TFLOP/s", flush=True)
            del idx, wo, wb, live
    print(f"gather_gram slots over both half-steps: {slot_sums['padded']} padded, "
          f"{slot_sums['rated']} rated, {slot_sums['multiplied']} multiplied "
          f"(modelled); off float64 by at most {worst:.3e}, the plain version "
          f"by at most {worst_plain:.3e}; the packed buckets {packed_ms:.3f} ms, "
          f"{one_row_ms:.3f} ms with one row a block", flush=True)
    c = out["chol_solve"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    for N in (N_USERS, N_ITEMS):
        A, b = spd_systems(torch, gen, dev, N, RANK)
        kern, _ = cuda_ms(lambda: ops.chol_solve(A, b), iters=10, warmup=2)
        plain, _ = cuda_ms(lambda: ops.chol_solve_ref(A, b), iters=5, warmup=1)
        lib, _ = cuda_ms(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(A)), iters=5, warmup=1)
        fs, bs = solve_bound(N, RANK)
        c["ms"] += kern
        c["plain_ms"] += plain
        c["library_ms"] += lib
        bound = add_bound(c, fs, bs)
        print(f"chol_solve time N={N} k={RANK} device ms: kernel={kern:.4f} "
              f"plain={plain:.4f} library(cholesky+cholesky_solve)={lib:.4f} "
              f"bound={bound:.4f} ({'operations' if fs >= bs else 'bytes'}; "
              f"f32 FMA {fs * 1e3:.4f}, bytes {bs * 1e3:.4f})", flush=True)
        del A, b
    for name, row in out.items():
        row["bound_ms"] = (row["ops_bound_s"] + row["bytes_bound_s"]) * 1e3
        row["bound_by"] = ("operations" if row["ops_bound_s"] >= row["bytes_bound_s"]
                           else "bytes")
        print(f"per ALS iteration (both half-steps): {name} kernel "
              f"{row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['ops_bound_s'] * 1e3:.3f} ms in launches bound by "
              f"operations, {row['bytes_bound_s'] * 1e3:.3f} ms by bytes), "
              f"{row['ms'] / row['bound_ms']:.1f}x the bound", flush=True)
    return out


def rows_gram_bound(R: int, W: int, k: int, slots: int, f_bytes: int = 4):
    """(seconds at the f32 rate, seconds at the memory rate) of the work
    one rows_gram launch needs: per slot of nonzero weight (``slots``)
    k(k+1)/2 + 2k FMAs and its row of F_g read once (a row at zero weight
    adds nothing); both weights of every slot read once, A and b written
    once."""
    flops = slots * (k * k + 5 * k)
    nbytes = slots * k * f_bytes + 8 * R * W + 4 * R * (k * k + k)
    return flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES


def rows_gram_library(torch, F_g, wo, wb):
    """One PyTorch formulation of the same function: bmm of the weighted
    block."""
    A = torch.bmm((F_g * wo[..., None]).transpose(1, 2), F_g)
    b = torch.bmm(wb[:, None, :], F_g)[:, 0]
    return A, b


def rows_gram_chunks(torch, dev, prep, U, V):
    """The ML-20M layout's buckets (both half-steps, the trained factors
    as F) as pre-gathered blocks: yields (label, F_g, wo, wb, rated
    slots), F_g = F[idx] gathered in row chunks of at most 2^26 values."""
    import numpy as np

    for name, side, F_np in (("user", prep.u_side, V), ("item", prep.i_side, U)):
        other = prep.i_side if side is prep.u_side else prep.u_side
        F = torch.as_tensor(F_np[other.perm]).to(dev)
        for b in side.buckets:
            R = b.n_slabs * b.slab
            idx = torch.as_tensor(b.other_idx.reshape(R, b.C)).to(dev)
            mask = b.mask.reshape(R, b.C)
            wo = torch.as_tensor(mask).to(dev)
            wb = torch.as_tensor((b.vals * b.mask).reshape(R, b.C)).to(dev)
            for sl in _row_chunks(R, b.C * RANK):
                label = (f"{name} {'seg ' if b.seg is not None else ''}bucket "
                         f"C={b.C} rows {sl.start}:{sl.stop}")
                yield (label, F[idx[sl].long()], wo[sl].contiguous(),
                       wb[sl].contiguous(), int(np.count_nonzero(mask[sl])))


def time_rows_gram(torch, ops, dev, train) -> dict:
    """Phase 6: rows_gram's path is its op entry point (no training or
    serving path calls it). It is driven once over every bucket of the
    ML-20M layout, pre-gathered as F[idx] outside the kernel, with the
    launch counters zeroed just before and read just after, each result
    held against a float64 reference on the same inputs (max|dA| /
    max|A64| and max|db| / max|b64| <= 1e-5; the plain version, an f32
    product in another order, is compared with the same reference and
    printed beside it); then each chunk is timed beside the
    plain version, one library call (bmm of the weighted block), the
    bound, and gather_gram on the same rows (F_g as its factor table, the
    identity as its index), which multiplies every padded slot."""
    prep, U, V = train["prep"], train["U"], train["V"]
    reset_counters(ops)
    worst = worst_plain = max_abs = 0.0
    for label, F_g, wo, wb, _ in rows_gram_chunks(torch, dev, prep, U, V):
        A, b = ops.rows_gram(F_g, wo, wb)
        Ar, br = ops.rows_gram_ref(F_g, wo, wb)
        F64 = F_g.double()
        A64 = torch.einsum("rw,rwk,rwl->rkl", wo.double(), F64, F64)
        b64 = torch.einsum("rw,rwk->rk", wb.double(), F64)
        del F64
        rel, rel_plain = rel64(A, b, A64, b64), rel64(Ar, br, A64, b64)
        sym = torch.equal(A, A.transpose(1, 2))
        print(f"rows_gram path {label}: off float64 {rel:.3e}, plain version "
              f"off float64 {rel_plain:.3e}, symmetric {sym}", flush=True)
        check(bool(torch.isfinite(A).all()) and rel <= GRAM_TOL and sym,
              f"rows_gram on {label}: off float64 {rel:.3e}, symmetric {sym}")
        worst, worst_plain = max(worst, rel), max(worst_plain, rel_plain)
        max_abs = max(max_abs, (A - Ar).abs().max().item(), (b - br).abs().max().item())
        del F_g, wo, wb, A, b, Ar, br, A64, b64
    launches = read_counters(ops)["rows_gram"]
    print(f"rows_gram path: {launches} launches over the ML-20M layout's "
          f"buckets; off float64 by at most {worst:.3e} (relative to max|A64|, "
          f"max|b64|), the plain version by at most {worst_plain:.3e}; kernel "
          f"against plain at most {max_abs:.3e} absolute", flush=True)
    check(launches > 0, "rows_gram was not launched on its path")

    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_bound_s=0.0,
               bytes_bound_s=0.0, launches=launches)
    gather_ms = 0.0
    for label, F_g, wo, wb, slots in rows_gram_chunks(torch, dev, prep, U, V):
        R, W, _ = F_g.shape
        idx = torch.arange(R * W, device=dev, dtype=torch.int32).reshape(R, W)
        F_flat = F_g.view(R * W, RANK)
        iters = 20 if R * W < (1 << 22) else 5
        kern, _ = cuda_ms(lambda: ops.rows_gram(F_g, wo, wb), iters=iters, warmup=2)
        gath, _ = cuda_ms(lambda: ops.gather_gram(F_flat, idx, wo, wb), iters=iters,
                          warmup=2)
        plain, _ = cuda_ms(lambda: ops.rows_gram_ref(F_g, wo, wb), iters=3, warmup=1)
        lib, _ = cuda_ms(lambda: rows_gram_library(torch, F_g, wo, wb), iters=3,
                         warmup=1)
        fs, bs = rows_gram_bound(R, W, RANK, slots)
        plan = rows_plan(R, W)
        row["ms"] += kern
        row["plain_ms"] += plain
        row["library_ms"] += lib
        gather_ms += gath
        bound = add_bound(row, fs, bs)
        print(f"rows_gram time {label} R={R} W={W} k={RANK} ({slots} rated "
              f"slots; split={plan.split} rows/block={plan.rows_per_block}) "
              f"device ms: kernel={kern:.4f} gather_gram(identity)="
              f"{gath:.4f} plain={plain:.4f} library(bmm)={lib:.4f} "
              f"bound={bound:.4f} ({'operations' if fs >= bs else 'bytes'}; "
              f"f32 FMA {fs * 1e3:.4f}, bytes {bs * 1e3:.4f})", flush=True)
        del F_g, F_flat, idx, wo, wb
    row["bound_ms"] = (row["ops_bound_s"] + row["bytes_bound_s"]) * 1e3
    row["bound_by"] = ("operations" if row["ops_bound_s"] >= row["bytes_bound_s"]
                       else "bytes")
    print(f"rows_gram over the whole layout (both half-steps): kernel "
          f"{row['ms']:.3f} ms, gather_gram on the same rows {gather_ms:.3f} ms, "
          f"plain {row['plain_ms']:.3f} ms, library "
          f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
          f"({row['ops_bound_s'] * 1e3:.3f} ms in launches bound by operations, "
          f"{row['bytes_bound_s'] * 1e3:.3f} ms by bytes), "
          f"{row['ms'] / row['bound_ms']:.1f}x the bound", flush=True)
    return row


CLI = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli"]
# phase 7's clients: singles from many, so the coalescer groups them, the
# rest in batches of the event server's limit
SINGLE_EVENTS, SINGLE_CLIENTS, BATCH_CLIENTS, BATCH_EVENTS = 2_000, 64, 16, 50


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(port: int, method: str, path: str, body=None, timeout: float = 30):
    """One request on a new connection: (status, decoded JSON body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def post_all(port: int, path: str, bodies, clients: int) -> list:
    """POST every pre-encoded body from ``clients`` keep-alive connections;
    returns the (status, JSON) answers in the bodies' order."""
    import http.client

    out = [None] * len(bodies)

    def client(c: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            for j in range(c, len(bodies), clients):
                conn.request("POST", path, body=bodies[j],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                out[j] = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()

    with ThreadPoolExecutor(clients) as pool:
        for f in [pool.submit(client, c) for c in range(clients)]:
            f.result()
    return out


def wait_until(ready, proc, log: str, timeout: float) -> None:
    """Poll ``ready()`` until true; fail if ``proc`` exits (printing the end
    of its ``log``) or time runs out."""
    deadline = time.monotonic() + timeout
    while True:
        if proc.poll() is not None:
            with open(log) as f:
                check(False, f"{proc.args[3]} exited with {proc.returncode}:\n"
                             f"{f.read()[-4000:]}")
        try:
            if ready():
                return
        except OSError:
            pass  # not listening yet
        check(time.monotonic() < deadline,
              f"{proc.args[3]} not ready in {timeout:.0f} s")
        time.sleep(0.2)


def quickstart_through_cli(torch, ops, dev) -> None:
    """Phase 7: the quickstart through the port's CLI and HTTP alone: `app
    new`, the event server with group commit taking the app's 25,000
    events, `export` and an `import` round trip, `train` and `deploy` on
    the card, 20 answers over HTTP held against the plain reference, and
    `status`."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import (RECOMMENDATION_FACTORY,
                                                      prepare_deploy)
    from predictionio_tpu_torch.storage import Storage, StorageConfig

    repo = os.path.dirname(os.path.abspath(__file__))
    engine_dir = os.path.join(repo, "predictionio_tpu_torch", "templates",
                              "recommendation")
    with open(os.path.join(engine_dir, "engine.json")) as f:
        app_name = json.load(f)["datasource"]["params"]["appName"]
    procs = []
    with tempfile.TemporaryDirectory(prefix="pio_chip_quickstart_") as home:
        env = dict(os.environ, PIO_HOME=home)

        def cli(*args, extra_env=None) -> str:
            t0 = time.perf_counter()
            proc = subprocess.run(CLI + list(args), cwd=repo,
                                  env=dict(env, **(extra_env or {})),
                                  capture_output=True, text=True, timeout=600)
            print(proc.stdout.strip(), flush=True)
            check(proc.returncode == 0, f"cli {' '.join(args)} failed "
                                        f"({proc.returncode}):\n{proc.stderr[-4000:]}")
            label = " ".join(args[:2]) + (" --distributed" if "--distributed" in args
                                          else "")
            print(f"-- cli {label}: {time.perf_counter() - t0:.2f} s wall", flush=True)
            return proc.stdout

        def serve(*args, extra_env=None):
            """Start a server verb; its output goes to <home>/<verb>.log."""
            log = os.path.join(home, f"{args[0]}.log")
            with open(log, "w") as out:
                proc = subprocess.Popen(CLI + list(args), cwd=repo,
                                        env=dict(env, **(extra_env or {})),
                                        stdout=out, stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc, log

        try:
            key = re.search(r"Access Key: (\S+)", cli("app", "new", app_name)).group(1)

            t0 = time.perf_counter()
            es_port = free_port()
            es, es_log = serve("eventserver", "--ip", "127.0.0.1", "--port",
                               str(es_port), "--ingest-batching", "--stats")
            wait_until(lambda: http_json(es_port, "GET", "/") == (200, {"status": "alive"}),
                       es, es_log, 120)
            print(f"-- eventserver up: {time.perf_counter() - t0:.2f} s", flush=True)

            users, items, ratings = synthetic_ml20m(APP_EVENTS, APP_USERS, APP_ITEMS,
                                                    seed=SEED + 3)
            t_base = 1_767_225_600  # 2026-01-01T00:00:00Z, one event a second
            events = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
                       "targetEntityType": "item", "targetEntityId": f"i{i}",
                       "properties": {"rating": float(r)},
                       "eventTime": time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                                                  time.gmtime(t_base + j))}
                       for j, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(),
                                                         ratings.tolist()))]
            path = f"/events.json?accessKey={key}"
            singles = [json.dumps(e) for e in events[:SINGLE_EVENTS]]
            t0 = time.perf_counter()
            answers = post_all(es_port, path, singles, SINGLE_CLIENTS)
            dt = time.perf_counter() - t0
            bad = sum(a[0] != 201 for a in answers)
            print(f"{SINGLE_EVENTS} single POST /events.json from {SINGLE_CLIENTS} "
                  f"clients: {dt:.2f} s, {SINGLE_EVENTS / dt:.0f} events/s, "
                  f"{bad} not 201", flush=True)
            check(bad == 0, f"{bad} single posts not answered 201: "
                            f"{[a for a in answers if a[0] != 201][:3]}")
            rest = events[SINGLE_EVENTS:]
            batches = [json.dumps(rest[s:s + BATCH_EVENTS])
                       for s in range(0, len(rest), BATCH_EVENTS)]
            t0 = time.perf_counter()
            answers = post_all(es_port, "/batch/events.json?accessKey=" + key,
                               batches, BATCH_CLIENTS)
            dt = time.perf_counter() - t0
            items_ok = sum(it["status"] == 201 for st, body in answers if st == 200
                           for it in body)
            print(f"{len(rest)} events in {len(batches)} POST /batch/events.json of "
                  f"{BATCH_EVENTS} from {BATCH_CLIENTS} clients: {dt:.2f} s, "
                  f"{len(rest) / dt:.0f} events/s, {len(rest) - items_ok} items not 201",
                  flush=True)
            check(items_ok == len(rest), f"{len(rest) - items_ok} batch items not 201")
            st, stats = http_json(es_port, "GET", "/stats.json")
            counted = sum(e["count"] for a in stats["appStats"] for e in a["events"]
                          if e["status"] == 201)
            print(f"GET /stats.json: {counted} events answered 201", flush=True)
            check(st == 200 and counted == APP_EVENTS,
                  f"stats.json counts {counted} of {APP_EVENTS}")
            # a few users' events come back exactly as posted
            rng = np.random.default_rng(SEED + 5)
            for u in rng.choice(np.unique(users), 5, replace=False).tolist():
                st, got = http_json(es_port, "GET", f"{path}&limit=-1&entityType=user"
                                                    f"&entityId=u{u}")
                key_of = lambda e: (e["targetEntityId"], e["properties"]["rating"],
                                    e["eventTime"][:19])
                want = sorted(key_of(e) for e in events if e["entityId"] == f"u{u}")
                check(st == 200 and sorted(map(key_of, got)) == want,
                      f"GET /events.json for user u{u}: {len(got)} events, "
                      f"{len(want)} posted")
            print("GET /events.json of 5 users: every event as posted", flush=True)
            st, health = http_json(es_port, "GET", "/health")
            check(st == 200 and health["status"] == "ok"
                  and health["ingest"]["breaker"] == "closed",
                  f"event server /health: {st} {health}")
            st, traces = http_json(es_port, "GET", "/traces")
            check(st == 200 and traces["enabled"] is False,
                  f"event server /traces: {st} {traces}")
            with urllib.request.urlopen(f"http://127.0.0.1:{es_port}/metrics",
                                        timeout=30) as r:
                exposition = r.read().decode()
            ingested = sum(float(line.rsplit(" ", 1)[1])
                           for line in exposition.splitlines()
                           if line.startswith("pio_events_ingested_total{")
                           and 'status="201"' in line)
            print(f"event server: /health {health['status']} (ingest queue "
                  f"{health['ingest']['queueDepth']}, breaker "
                  f"{health['ingest']['breaker']}); /metrics "
                  f"pio_events_ingested_total 201 = {ingested:g}; /traces "
                  f"enabled={traces['enabled']}", flush=True)
            check(ingested == APP_EVENTS, f"/metrics counts {ingested} of {APP_EVENTS}")
            es.send_signal(2)  # SIGINT: the server drains its queue and ends
            es.wait(timeout=60)

            exported = os.path.join(home, "MyApp1.jsonl")
            cli("export", "--app-name", app_name, "--output", exported)
            with open(exported) as f:
                lines = sorted(f)
            check(len(lines) == APP_EVENTS, f"export wrote {len(lines)} lines")
            cli("app", "new", "MyApp2")
            cli("import", "--app-name", "MyApp2", "--input", exported)
            again = os.path.join(home, "MyApp2.jsonl")
            cli("export", "--app-name", "MyApp2", "--output", again)
            with open(again) as f:
                check(sorted(f) == lines, "MyApp2's export differs from MyApp1's")
            print(f"export, import, export: {APP_EVENTS} equal lines", flush=True)

            out = cli("train", "--engine-dir", engine_dir)
            found = dict(re.findall(r"(\w+)=(\d+)", out.split("kernel launches:")[-1]))
            print(f"train kernel launches {found}", flush=True)
            for name in ("gather_gram", "chol_solve"):
                check(int(found.get(name, 0)) > 0, f"cli train did not launch {name}")

            eval_through_cli(cli, home, engine_dir, app_name)

            # the catalog is under the host-scoring threshold: ask for the card
            serve_env = {"PIO_ALS_SERVE": "device"}
            t0 = time.perf_counter()
            port = free_port()
            dp, dp_log = serve("deploy", "--engine-dir", engine_dir, "--batching",
                               "--aot-buckets", "auto", "--ip", "127.0.0.1",
                               "--port", str(port), extra_env=serve_env)
            # 503s until the ladder is warm, which on the card includes
            # loading the kernel
            wait_until(lambda: http_json(port, "GET", "/")[1]["warmup"]["state"] == "ready",
                       dp, dp_log, 600)
            print(f"-- deploy up and warm: {time.perf_counter() - t0:.2f} s", flush=True)
            prev = os.environ.get("PIO_ALS_SERVE")
            os.environ.update(serve_env)
            try:
                eng = prepare_deploy(RECOMMENDATION_FACTORY,
                                     storage=Storage(StorageConfig(home=home)),
                                     device=dev)
                check(eng.instance.status == "COMPLETED", "instance not COMPLETED")
                model = eng.models[0]
                inv = model.user_ids.inverse()
                rows = np.random.default_rng(SEED + 4).choice(len(model.user_ids), 20,
                                                              replace=False)
                t0 = time.perf_counter()
                answers = [http_json(port, "POST", "/queries.json",
                                     {"user": inv[int(r)], "num": 10}) for r in rows]
                print(f"20 POST /queries.json: {time.perf_counter() - t0:.2f} s", flush=True)
                check(all(st == 200 for st, _ in answers),
                      f"queries not 200: {[a for a in answers if a[0] != 200][:3]}")
                reset_counters(ops)
                local = [eng.query({"user": inv[int(r)], "num": 10}) for r in rows]
                served = read_counters(ops)["score_topk"]
            finally:
                if prev is None:
                    os.environ.pop("PIO_ALS_SERVE")
                else:
                    os.environ["PIO_ALS_SERVE"] = prev
            check(served > 0, "the deployed instance was not served by score_topk")
            items_of = lambda a: [it["item"] for it in a["itemScores"]]
            check([items_of(a) for _, a in answers] == [items_of(a) for a in local],
                  "HTTP answers differ from the same instance served in-process")
            Ud = torch.as_tensor(model.U, device=dev)
            Vd = torch.as_tensor(model.V, device=dev)
            ids = torch.as_tensor(rows.astype(np.int32), device=dev)
            rv, ri = ops.score_topk_ref(Ud, Vd, 10, ids=ids)
            s64 = Ud[ids.long()].double() @ Vd.double().T
            bad = 0
            for j, (_, a) in enumerate(answers):
                got_idx = torch.tensor([model.item_ids[it["item"]] for it in a["itemScores"]],
                                       device=dev)
                got_val = torch.tensor([it["score"] for it in a["itemScores"]], device=dev)
                if len(got_idx) != 10 or not topk_agrees(
                        got_val[None], got_idx[None], rv[j:j + 1], ri[j:j + 1],
                        s64[j:j + 1]):
                    bad += 1
            print(f"deployed instance {eng.instance.id} ({model.U.shape[0]} users x "
                  f"{model.V.shape[0]} items, rank {model.U.shape[1]}): 20 HTTP answers, "
                  f"{bad} off the reference; in-process score_topk launches {served}",
                  flush=True)
            check(bad == 0, f"{bad} of 20 answers disagree with score_topk_ref")

            out = cli("status")
            check(torch.cuda.get_device_name(0) in out, "cli status did not name the card")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()


def eval_through_cli(cli, home: str, engine_dir: str, app_name: str) -> None:
    """Phase 7's `pio eval` steps on the quickstart's app: the template's
    RecEvaluation over its DefaultGrid (ranks 8 and 16 x lambda 0.01 and
    0.1, 8 iterations, two folds) serially and with --distributed, then
    `eval leaderboard`, `evals list` and `evals show`. Both instances must
    be EVALCOMPLETED, rank the grid alike (equal leaderboard digests) and
    score every candidate within EVAL_TOL of each other; the distributed
    run builds each program at most once a bucket."""
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.storage import leaderboard as lb

    mod = "predictionio_tpu_torch.templates.recommendation.engine"
    env = {"PIO_EVAL_APP_NAME": app_name}
    ids = {}
    for mode, extra in (("serial", []), ("distributed", ["--distributed"])):
        out = cli("eval", f"{mod}:RecEvaluation", f"{mod}:DefaultGrid",
                  "--engine-dir", engine_dir, *extra, extra_env=env)
        ids[mode] = re.search(r"Evaluation completed: instance (\S+)", out).group(1)
    meta = Storage(StorageConfig(home=home)).meta
    docs = {}
    for mode, iid in ids.items():
        vi = meta.get_evaluation_instance(iid)
        check(vi is not None and vi.status == "EVALCOMPLETED",
              f"{mode} evaluation {iid} is {vi and vi.status}")
        docs[mode] = lb.read(home, iid)
        check(docs[mode] is not None and docs[mode]["mode"] == mode,
              f"no {mode} leaderboard for {iid}")
    ser, dist = docs["serial"], docs["distributed"]
    check(lb.digest(ser) == lb.digest(dist),
          f"serial and distributed rank the grid differently: "
          f"{lb.digest(ser)} vs {lb.digest(dist)}")
    by_index = {e["index"]: e["score"] for e in ser["entries"]}
    worst = max(abs(e["score"] - by_index[e["index"]]) / abs(by_index[e["index"]])
                for e in dist["entries"])
    print(f"pio eval: serial and distributed digests {lb.digest(ser)}, scores "
          f"within {worst:.3e} relative (limit {EVAL_TOL}); distributed "
          f"buckets={dist['buckets']} compiles={dist['compiles']} "
          f"dispatches={dist['dispatches']} device {dist['deviceSeconds']:.3f} s "
          f"of {dist['wallSeconds']:.3f} s sweep wall", flush=True)
    check(worst <= EVAL_TOL, f"serial and distributed scores differ by {worst:.3e}")
    check(dist["compiles"] <= dist["buckets"],
          f"{dist['compiles']} compiles for {dist['buckets']} buckets")
    out = cli("eval", "leaderboard")
    check(f"instance={ids['distributed']}" in out, "eval leaderboard is not the latest")
    out = cli("evals", "list")
    check(all(iid in out for iid in ids.values()), "evals list misses an instance")
    out = cli("evals", "show", ids["serial"])
    check("status=EVALCOMPLETED" in out, "evals show does not show the instance")


def write_instance(home: str, U, V):
    """Phase 8 set-up: one COMPLETED instance at ML-20M width holding the
    factors phase 5 trained, written through the port's storage and
    save_model."""
    from predictionio_tpu_torch.controller import params_to_json
    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY
    from predictionio_tpu_torch.storage import (EngineInstance, Storage,
                                                StorageConfig)
    from predictionio_tpu_torch.storage.meta import utcnow
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, ALSModel, DataSourceParams)
    from predictionio_tpu_torch.utils.bimap import BiMap

    model = ALSModel(U, V, BiMap.string_int(f"u{i}" for i in range(N_USERS)),
                     BiMap.string_int(f"i{j}" for j in range(N_ITEMS)))
    storage = Storage(StorageConfig(home=home))
    iid = storage.meta.new_instance_id()
    factory = RECOMMENDATION_FACTORY
    storage.models.put(iid, pickle.dumps(
        [ALSAlgorithm(ALSAlgorithmParams(rank=RANK)).save_model(model, None)]))
    now = utcnow()
    storage.meta.insert_engine_instance(EngineInstance(
        id=iid, status="COMPLETED", start_time=now, end_time=now,
        engine_factory=factory, engine_variant="default", batch="chip_smoke",
        env={}, mesh_conf={},
        data_source_params=json.dumps(params_to_json(DataSourceParams(app_name="ML20M"))),
        preparator_params="{}",
        algorithms_params=json.dumps([{"name": "als", "params": params_to_json(
            ALSAlgorithmParams(rank=RANK, seed=SEED))}]),
        serving_params="{}"))
    return storage, factory, U, V


def drive_server(torch, ops, dev, home: str, U, V):
    """Phase 8: deploy through the port's EngineServer and query it."""
    import numpy as np

    from predictionio_tpu_torch.models.als import _bucket_k
    from predictionio_tpu_torch.server import aot
    from predictionio_tpu_torch.server.engine_server import EngineServer

    t0 = time.perf_counter()
    storage, factory, U, V = write_instance(home, U, V)
    print(f"instance written: {N_USERS} x {N_ITEMS} rank {RANK} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    server = EngineServer(engine_factory=factory, storage=storage,
                          host="127.0.0.1", port=0, batching=True,
                          batch_max=BATCH_MAX, aot_buckets="auto",
                          aot_topk=AOT_TOPK, device=dev)
    check(server._warmup.wait(600) and server._warmup.ready,
          f"AOT warmup did not finish: {server._warmup.progress()}")
    print(f"deployed and warmed in {time.perf_counter() - t0:.1f} s: "
          f"{server._warmup.progress()}", flush=True)

    loop = asyncio.new_event_loop()
    serve = threading.Thread(target=loop.run_until_complete,
                             args=(server.serve_forever(),), daemon=True)
    serve.start()
    deadline = time.time() + 60
    while server.http._server is None:
        check(time.time() < deadline and serve.is_alive(), "server did not start")
        time.sleep(0.05)
    url = f"http://127.0.0.1:{server.http.bound_port}"

    def post(q):
        t = time.perf_counter()
        req = urllib.request.Request(f"{url}/queries.json",
                                     data=json.dumps(q).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        return body, time.perf_counter() - t

    rng = np.random.default_rng(SEED + 2)
    seq = [{"user": f"u{int(u)}", "num": int(n)} for u, n in zip(
        rng.integers(0, N_USERS, 200), rng.choice([5, 10, 16], 200))]
    burst = [{"user": f"u{int(u)}", "num": 10}
             for u in rng.integers(0, N_USERS, 512)]
    # the k > 32 path: num 50, 100 and 1,000 serve at k = 64, 128 and 1,024
    wide = [{"user": f"u{int(u)}", "num": int(n)} for u, n in zip(
        rng.integers(0, N_USERS, 96), rng.choice([50, 100, 1000], 96))]

    def dispatches_since(before):
        """Serving dispatches per (padded bucket, path) since ``before``
        (pio_aot_dispatch_total)."""
        out = {}
        for (bucket, path), n in aot._DISPATCHES._values.items():
            n = int(n - before.get((bucket, path), 0))
            if n:
                out[(int(bucket), path)] = n
        return out

    reset_counters(ops)
    batches0 = server._batcher.batches
    dispatches0 = dict(aot._DISPATCHES._values)
    seq_out = [post(q) for q in seq]
    with ThreadPoolExecutor(64) as pool:
        t_burst = time.perf_counter()
        burst_out = list(pool.map(post, burst))
        t_burst = time.perf_counter() - t_burst
    launches = read_counters(ops)
    batches = server._batcher.batches - batches0
    per_bucket = dispatches_since(dispatches0)
    for (bucket, path), n in sorted(per_bucket.items()):
        print(f"serving dispatches bucket={bucket:2d} path={path}: {n}", flush=True)

    # the sequential sub-run with num > 32, counted on its own. The metric
    # has no k label: one query at a time is one dispatch at bucket 1, so
    # each dispatch's k is its query's num bucketed
    reset_counters(ops)
    dispatches1 = dict(aot._DISPATCHES._values)
    wide_out = [post(q) for q in wide]
    wide_launches = read_counters(ops)
    wide_buckets = dispatches_since(dispatches1)
    check(sum(wide_buckets.values()) == len(wide)
          and all(bucket == 1 for bucket, _ in wide_buckets),
          f"num > 32 sub-run: {wide_buckets} is not one bucket-1 dispatch a query")
    (path,) = {p for _, p in wide_buckets}
    wide_per_k = {}
    for q in wide:
        key = (1, _bucket_k(q["num"]), path)
        wide_per_k[key] = wide_per_k.get(key, 0) + 1
    for (bucket, k, p), n in sorted(wide_per_k.items()):
        print(f"serving dispatches (num > 32 sub-run) bucket={bucket} k={k} path={p}: {n}",
              flush=True)

    urllib.request.urlopen(f"{url}/stop", timeout=10).read()
    serve.join(30)
    check(not serve.is_alive(), "server did not stop")
    loop.close()

    # every answer against the plain reference on the card, each at its
    # query's own num (the reference's stable sort: its first num of any
    # longer list are its top num)
    queries = seq + burst + wide
    answers = [b for b, _ in seq_out + burst_out + wide_out]
    rows = torch.tensor([int(q["user"][1:]) for q in queries], device=dev,
                        dtype=torch.int32)
    Ud = torch.as_tensor(U, device=dev)
    Vp = torch.cat([torch.as_tensor(V, device=dev),
                    torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
    rv, ri = ops.score_topk_ref(Ud, Vp, max(q["num"] for q in queries), n_valid=N_ITEMS,
                                ids=rows)
    s64 = Ud[rows.long()].double() @ Vp.double().T
    bad_at = []
    for j, (q, a) in enumerate(zip(queries, answers)):
        n = q["num"]
        items = a.get("itemScores", [])
        if len(items) != n:
            bad_at.append(j)
            continue
        got_idx = torch.tensor([int(it["item"][1:]) for it in items], device=dev)
        got_val = torch.tensor([it["score"] for it in items], device=dev)
        if not topk_agrees(got_val[None], got_idx[None], rv[j:j + 1, :n],
                           ri[j:j + 1, :n], s64[j:j + 1]):
            bad_at.append(j)
    bad = len(bad_at)
    bad_wide = sum(1 for j in bad_at if j >= len(seq) + len(burst))
    lat = np.asarray([t for _, t in seq_out]) * 1e3
    blat = np.asarray([t for _, t in burst_out]) * 1e3
    wlat = np.asarray([t for _, t in wide_out]) * 1e3
    print(f"queries: {len(seq)} sequential p50={np.percentile(lat, 50):.3f} ms "
          f"p99={np.percentile(lat, 99):.3f} ms; burst of {len(burst)} over 64 "
          f"clients p50={np.percentile(blat, 50):.3f} ms "
          f"p99={np.percentile(blat, 99):.3f} ms "
          f"({len(burst) / t_burst:.1f} q/s); {batches} device batches; "
          f"kernel launches {launches}; answers off the reference: {bad - bad_wide}",
          flush=True)
    print(f"queries with num > 32: {len(wide)} sequential p50={np.percentile(wlat, 50):.3f} ms "
          f"p99={np.percentile(wlat, 99):.3f} ms; kernel launches {wide_launches}; "
          f"answers off the reference: {bad_wide}", flush=True)
    check(bad == 0, f"{bad} of {len(queries)} answers disagree with score_topk_ref")
    check(launches["score_topk"] > 0, "score_topk was not launched on the serving path")
    check(wide_launches["score_topk"] == len(wide),
          f"the num > 32 sub-run launched score_topk {wide_launches['score_topk']} times "
          f"for {len(wide)} queries")
    return launches, per_bucket, {"launches": wide_launches["score_topk"],
                                  "per_k": wide_per_k, "p50_ms": float(np.percentile(wlat, 50))}


# phase 10: the load across the reload, the burst over the cap, the
# sequential runs with the tracer on and off
RELOAD_CLIENTS, SHED_CLIENTS, MAX_INFLIGHT, QUERY_TIMEOUT_MS = 64, 64, 32, 2000
TRACE_QUERIES, DEADLINE_MARGIN_S = 200, 0.5


def answers_agree(torch, ops, dev, Ud, Vp, users, answers, num: int = 10) -> list:
    """Per answer: does it equal score_topk_ref of the factors (Ud, Vp)?
    (the rule of topk_agrees, row by row: values within rtol/atol 1e-5,
    indices equal except between float64 near-ties)"""
    rows = torch.tensor(users, device=dev, dtype=torch.int32)
    rv, ri = ops.score_topk_ref(Ud, Vp, num, n_valid=N_ITEMS, ids=rows)
    full = [len(a.get("itemScores", [])) == num for a in answers]
    got_idx = torch.tensor([[int(it["item"][1:]) for it in a["itemScores"]]
                            if f else [0] * num for a, f in zip(answers, full)],
                           device=dev)
    got_val = torch.tensor([[it["score"] for it in a["itemScores"]]
                            if f else [0.0] * num for a, f in zip(answers, full)],
                           device=dev)
    ok = torch.isclose(got_val, rv, rtol=TOL, atol=TOL).all(1)
    ok &= torch.tensor(full, device=dev)
    diff = got_idx != ri.to(got_idx.dtype)
    need = (diff.any(1) & ok).nonzero()[:, 0]
    for c in range(0, len(need), 1024):
        r = need[c:c + 1024]
        s64 = Ud[rows[r].long()].double() @ Vp.double().T
        tie = (torch.gather(s64, 1, got_idx[r].long())
               - torch.gather(s64, 1, ri[r].long())).abs() <= TOL
        ok[r] = (tie | ~diff[r]).all(1)
    return ok.tolist()


def ops_surface(torch, ops, dev, home: str, train) -> dict:
    """Phase 10: the engine server's operations surface at ML-20M width.
    Two COMPLETED instances (phase 5's final U with its final V, then with
    its second-to-last V9); the first deployed with micro-batching, the
    AOT ladder, a max-inflight cap, a query deadline, a fast history
    scrape and the tracer on; then /health through the warm-up, a /reload
    under a 64-client load, a rolled-back /reload, the 504 deadlines, the
    shed 503s, /metrics, /metrics/history, /traces and `pio trace`."""
    import http.client
    import io
    from collections import Counter

    import numpy as np

    from predictionio_tpu_torch.server import aot
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.tools import cli as port_cli
    from predictionio_tpu_torch.utils import tracing
    from predictionio_tpu_torch.utils.faults import FAULTS
    from predictionio_tpu_torch.utils.timeseries import parse_prom_text

    t_phase = time.perf_counter()
    U, V, V9 = train["U"], train["V"], train["V9"]
    t0 = time.perf_counter()
    storage, factory, _, _ = write_instance(home, U, V)
    first = storage.meta.get_latest_completed_engine_instance(factory, "default").id
    write_instance(home, U, V9)
    second = storage.meta.get_latest_completed_engine_instance(factory, "default").id
    check(first != second, "the second instance was not recorded")
    print(f"two instances written in {time.perf_counter() - t0:.1f} s: "
          f"{first} (U, V) and {second} (U, V9)", flush=True)

    trace_file = os.path.join(home, "traces", "spans.jsonl")
    tracing.TRACER.reset()
    tracing.TRACER.configure(enabled=True, jsonl_path=trace_file)
    # every ladder program is built by this deploy's warm-up, not taken
    # from phase 8's; the warm-up starts once /health is listening, so
    # that the not-ready answers are seen
    aot.EXECUTABLES.clear()
    t0 = time.perf_counter()
    with mock.patch.object(aot.AOTWarmup, "start"):
        server = EngineServer(engine_factory=factory, instance_id=first,
                              storage=storage, host="127.0.0.1", port=0,
                              batching=True, batch_max=BATCH_MAX,
                              aot_buckets="auto", aot_topk=AOT_TOPK,
                              max_inflight=MAX_INFLIGHT,
                              query_timeout_ms=QUERY_TIMEOUT_MS,
                              scrape_interval=0.2, device=dev)
    t_load = time.perf_counter() - t0
    loop = asyncio.new_event_loop()
    serve = threading.Thread(target=loop.run_until_complete,
                             args=(server.serve_forever(),), daemon=True)
    serve.start()
    deadline = time.time() + 60
    while server.http._server is None:
        check(time.time() < deadline and serve.is_alive(), "server did not start")
        time.sleep(0.05)
    port = server.http.bound_port
    seen = Counter()      # status of every POST /queries.json of this phase
    seen_lock = threading.Lock()

    def get(path, headers=None, timeout=30):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            conn.request("GET", path, headers=headers or {})
            r = conn.getresponse()
            return r.status, r.read(), r.headers
        finally:
            conn.close()

    def get_json(path):
        st, raw, hdrs = get(path)
        return st, json.loads(raw), hdrs

    def query(conn, user, headers=None):
        """(status, body, sent, answered) of one num-10 query."""
        sent = time.perf_counter()
        conn.request("POST", "/queries.json",
                     body=json.dumps({"user": f"u{user}", "num": 10}),
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        body = json.loads(r.read())
        done = time.perf_counter()
        with seen_lock:
            seen[r.status] += 1
        return r.status, body, sent, done, r.headers

    def one(user, headers=None, timeout=30):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            return query(conn, user, headers)
        finally:
            conn.close()

    def metric(text, name, **labels):
        return sum(v for n, lab, v in parse_prom_text(text)
                   if n == name and all(lab.get(k) == w for k, w in labels.items()))

    def metrics_text():
        st, raw, _ = get("/metrics")
        check(st == 200, f"GET /metrics answered {st}")
        return raw.decode()

    Ud = torch.as_tensor(U, device=dev)

    def padded(Vh):
        return torch.cat([torch.as_tensor(Vh, device=dev),
                          torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])

    Vp = {first: padded(V), second: padded(V9)}

    def agrees(users, answers, iid):
        return answers_agree(torch, ops, dev, Ud, Vp[iid], users, answers)

    text0 = metrics_text()
    rng = np.random.default_rng(SEED + 10)
    try:
        # 1. /health: not-ready while the ladder warms, then ok
        st, body, hdrs = get_json("/health")
        check(st == 503 and body["status"] == "not-ready"
              and int(hdrs["Retry-After"]) >= 1 and "warmup" in body,
              f"/health before the warm-up: {st} {body}")
        instance = body["instance"]
        t0 = time.perf_counter()
        server._warmup.start(server.deployed)
        states = []
        while True:
            st, body, _ = get_json("/health")
            states.append((st, body["status"]))
            check(body["instance"] == instance, "/health changed its instance")
            if st == 200:
                break
            check(st == 503 and body["status"] == "not-ready"
                  and time.perf_counter() - t0 < 600,
                  f"/health while warming: {st} {body}")
            time.sleep(0.02)
        t_warm = time.perf_counter() - t0
        check(body["status"] == "ok", f"/health after the warm-up: {body}")
        print(f"deployed {first} in {t_load:.1f} s; /health 503 not-ready "
              f"{sum(s == 503 for s, _ in states) + 1} times, then 200 ok after "
              f"{t_warm:.3f} s of warm-up (ladder {body['warmup']['buckets']}, "
              f"{body['warmup']['compiled']} programs built in "
              f"{body['warmup']['wallSec']} s); instance {instance}", flush=True)

        # 2. /reload under a 64-client load (the cap lifted: 64 clients
        # over a cap of 32 shed, which check 5 holds on its own)
        server.max_inflight = 0
        answers = []
        stop = threading.Event()

        def client(c):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            r = np.random.default_rng(SEED + 100 + c)
            try:
                while not stop.is_set():
                    u = int(r.integers(0, N_USERS))
                    st, body, sent, done, _ = query(conn, u)
                    answers.append((u, st, body, sent, done))
            finally:
                conn.close()

        # the reload's own launches, counted on the threads that make
        # them: the candidate's warm-up and its probe each run on a thread
        # of their own, apart from the batcher's dispatch thread. The
        # tally only observes: every launch still counts in the kernel's
        # wrapper
        role, by_role, role_lock = threading.local(), Counter(), threading.Lock()
        kernel = ops.score_topk

        def tallied(*args, **kwargs):
            out = kernel(*args, **kwargs)
            with role_lock:
                by_role[getattr(role, "name", "load")] += 1
            return out

        def in_role(name, fn):
            def run(*args, **kwargs):
                role.name = name
                try:
                    return fn(*args, **kwargs)
                finally:
                    del role.name
            return run

        reset_counters(ops)
        batches0 = server._batcher.batches
        counts0 = aot.EXECUTABLES.counts()
        with ThreadPoolExecutor(RELOAD_CLIENTS) as pool, \
                mock.patch.object(ops, "score_topk", tallied), \
                mock.patch.object(server, "_probe_worker",
                                  in_role("probe", server._probe_worker)), \
                mock.patch.object(server._warmup, "warm_sync",
                                  in_role("warmup", server._warmup.warm_sync)):
            futs = [pool.submit(client, c) for c in range(RELOAD_CLIENTS)]
            time.sleep(0.5)
            t0 = time.perf_counter()
            st, rbody, _ = get_json("/reload")
            swapped = time.perf_counter()
            t_reload = swapped - t0
            time.sleep(0.5)
            stop.set()
            for f in futs:
                f.result()
        launches = read_counters(ops)["score_topk"]
        batches = server._batcher.batches - batches0
        counts1 = aot.EXECUTABLES.counts()
        built = counts1.get("compile", 0) - counts0.get("compile", 0)
        adopted = counts1.get("hit", 0) - counts0.get("hit", 0)
        check(st == 200 and rbody["swap"] == "promoted"
              and rbody["engineInstanceId"] == second
              and rbody["reloadGeneration"] == 1, f"/reload: {st} {rbody}")
        health = get_json("/health")[1]
        check(health["reloadGeneration"] == 1
              and health["lastSwap"]["outcome"] == "promoted",
              f"/health after the reload: {health}")
        statuses = Counter(a[1] for a in answers)
        check(set(statuses) == {200}, f"answers across the reload: {statuses}")
        users = [a[0] for a in answers]
        old_ok = agrees(users, [a[2] for a in answers], first)
        new_ok = agrees(users, [a[2] for a in answers], second)
        after = [a[3] > swapped for a in answers]
        bad = sum(1 for o, n, late in zip(old_ok, new_ok, after)
                  if not (n if late else (o or n)))
        lat = np.asarray([a[4] - a[3] for a in answers]) * 1e3
        print(f"/reload under {RELOAD_CLIENTS} clients: {t_reload:.3f} s wall, "
              f"candidate warmed in {server._warmup.wall_sec:.3f} s "
              f"({adopted} cached programs adopted, {built} built); "
              f"{len(answers)} answers ({sum(after)} sent after the swap), all 200, "
              f"{sum(old_ok)} equal the old factors' reference, {sum(new_ok)} the "
              f"new ones', {bad} neither (or old after the swap); p50 "
              f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms; "
              f"score_topk launches {launches}: {by_role['load']} by the load's "
              f"{batches} device batches, {by_role['warmup']} by the candidate's "
              f"warm-up, {by_role['probe']} by its probe", flush=True)
        check(bad == 0, f"{bad} answers across the reload off both references")
        check(sum(after) > 0, "no query was sent after the reload")
        check(launches > 0, "score_topk was not launched under the reload's load")
        check(by_role["probe"] == 1, f"the probe launched score_topk {by_role['probe']} times")
        check(sum(by_role.values()) == launches,
              f"launches by thread {dict(by_role)} do not add up to {launches}")
        server.max_inflight = MAX_INFLIGHT

        # 3. a rolled-back /reload keeps the serving engine
        rb0 = metric(metrics_text(), "pio_engine_reloads_total", result="rolled_back")
        FAULTS.arm("serving.reload", error="candidate cannot serve")
        try:
            st, body, _ = get_json("/reload")
        finally:
            FAULTS.disarm("serving.reload")
        check(st == 500 and body["swap"] == "rolled_back"
              and body["engineInstanceId"] == second, f"faulted /reload: {st} {body}")
        later_users = [int(u) for u in rng.integers(0, N_USERS, 20)]
        later = [one(u) for u in later_users]
        check(all(a[0] == 200 for a in later), "queries after the rollback not 200")
        check(all(agrees(later_users, [a[1] for a in later], second)),
              "answers after the rollback off the serving engine's reference")
        rb = metric(metrics_text(), "pio_engine_reloads_total", result="rolled_back") - rb0
        swap = get_json("/health")[1]["lastSwap"]
        print(f"faulted /reload: 500 {body['swap']} ({swap['reason']}); 20 later "
              f"answers equal the serving instance's reference; "
              f"pio_engine_reloads_total{{result=\"rolled_back\"}} +{rb:g}", flush=True)
        check(rb == 1 and swap["outcome"] == "rolled_back", f"rolled_back counted {rb}")

        # 4. deadlines: the server's own, then a hop's tighter one
        FAULTS.arm("serving.query", latency=3.0)
        try:
            st4, body4, sent, done, _ = one(1)
            st5, body5, sent5, done5, _ = one(2, {"X-PIO-Deadline-Ms": "500"})
        finally:
            FAULTS.disarm("serving.query")
        print(f"deadline: {st4} after {done - sent:.3f} s (limit "
              f"{QUERY_TIMEOUT_MS / 1e3} s); X-PIO-Deadline-Ms 500: {st5} after "
              f"{done5 - sent5:.3f} s", flush=True)
        check(st4 == 504 and done - sent < QUERY_TIMEOUT_MS / 1e3 + DEADLINE_MARGIN_S,
              f"deadline: {st4} {body4} after {done - sent:.3f} s")
        check(st5 == 504 and done5 - sent5 < 0.5 + DEADLINE_MARGIN_S,
              f"hop deadline: {st5} {body5} after {done5 - sent5:.3f} s")

        # 5. shedding: 64 clients over a cap of 32, each query held 3 s
        shed0 = metric(metrics_text(), "pio_engine_shed_total")
        degraded = []
        burst_done = threading.Event()

        def watch():
            while not burst_done.is_set():
                st, body, _ = get_json("/health")
                if body.get("status") == "degraded":
                    degraded.append(body.get("reason"))
                time.sleep(0.02)

        FAULTS.arm("serving.query", latency=3.0)
        watcher = threading.Thread(target=watch)
        watcher.start()
        try:
            with ThreadPoolExecutor(SHED_CLIENTS) as pool:
                burst = list(pool.map(lambda u: one(u, timeout=60),
                                      [int(u) for u in rng.integers(0, N_USERS,
                                                                    SHED_CLIENTS)]))
        finally:
            FAULTS.disarm("serving.query")
            burst_done.set()
            watcher.join()
        shed = [b for b in burst if b[0] == 503]
        shed_metric = metric(metrics_text(), "pio_engine_shed_total") - shed0
        print(f"{SHED_CLIENTS} clients over a cap of {MAX_INFLIGHT}: "
              f"{dict(Counter(b[0] for b in burst))}; pio_engine_shed_total "
              f"+{shed_metric:g}; /health degraded {len(degraded)} times "
              f"({sorted(set(degraded))})", flush=True)
        check(shed and all(int(b[4]["Retry-After"]) >= 1
                           and "overloaded" in b[1]["message"] for b in shed),
              "no shed 503 with Retry-After")
        check(shed_metric == len(shed), f"shed metric {shed_metric} != {len(shed)} seen")
        check("at inflight capacity" in degraded,
              f"/health never said 'at inflight capacity': {degraded}")
        # the batches held by the fault drain before the next checks
        t0 = time.perf_counter()
        while one(3, timeout=60)[0] != 200:
            check(time.perf_counter() - t0 < 60, "server did not recover after the burst")

        # 6. the tracer on, then off: sequential p50/p99 in the same server
        def sequential(n):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                out = [query(conn, int(u))
                       for u in rng.integers(0, N_USERS, n)]
            finally:
                conn.close()
            check(all(o[0] == 200 for o in out), "sequential queries not 200")
            return np.asarray([o[3] - o[2] for o in out]) * 1e3

        on = sequential(TRACE_QUERIES)
        tracing.TRACER.configure(enabled=False)
        off = sequential(TRACE_QUERIES)
        tracing.TRACER.configure(enabled=True)
        print(f"{TRACE_QUERIES} sequential num-10 queries: tracer on p50 "
              f"{np.percentile(on, 50):.3f} ms p99 {np.percentile(on, 99):.3f} ms; "
              f"tracer off p50 {np.percentile(off, 50):.3f} ms p99 "
              f"{np.percentile(off, 99):.3f} ms", flush=True)

        # 7. /metrics against the clients' own counts
        text = metrics_text()
        by_status = {str(code): metric(text, "pio_engine_queries_total", status=str(code))
                     - metric(text0, "pio_engine_queries_total", status=str(code))
                     for code in seen}
        print(f"/metrics pio_engine_queries_total by status +{by_status}; the "
              f"clients saw {dict(seen)}", flush=True)
        check(by_status == {str(c): float(n) for c, n in seen.items()},
              f"pio_engine_queries_total {by_status} != clients' {dict(seen)}")

        # 8. /metrics/history and /traces
        st, hist, _ = get_json("/metrics/history?series=pio_engine_queries_total&window=5m")
        samples = sum(len(v) for v in hist.get("series", {}).values())
        check(st == 200 and samples > 0, f"/metrics/history: {st} {hist}")
        st, tr, _ = get_json("/traces?limit=1000")
        spans = tr["spans"]
        # a batched query's device span is the child of the serving.batch
        # span its dispatch opened under the batch's first query
        batch_of = {d["spanId"]: d["parentId"] for d in spans
                    if d["name"] == "serving.batch"}
        parents = {batch_of.get(d["parentId"], d["parentId"]) for d in spans
                   if d["name"] in ("engine.predict", "serving.device")}
        queries = [d for d in spans if d["name"] == "engine.query"]
        linked = [d for d in queries if d["spanId"] in parents]
        batches = [d["attrs"] for d in spans if d["name"] == "serving.batch"]
        check(all(a["size"] == len(a["link_traces"]) for a in batches),
              "a serving.batch span does not link every trace it served")
        print(f"/metrics/history: {len(hist['series'])} series, {samples} samples; "
              f"/traces: {len(spans)} spans, {len(queries)} engine.query, "
              f"{len(linked)} with a device span under their serving.batch, "
              f"{len(batches)} serving.batch spans of sizes "
              f"{sorted(Counter(a['size'] for a in batches).items())}", flush=True)
        check(st == 200 and linked, "/traces holds no engine.query with a device span")
        traced = linked[0]["traceId"]
    finally:
        FAULTS.disarm()
        loop.call_soon_threadsafe(server.http.request_shutdown)
        serve.join(30)
        loop.close()
        tracing.TRACER.reset()
    check(not serve.is_alive(), "server did not stop")
    check(os.path.getsize(trace_file) > 0, "the trace file is empty")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_cli.main(["trace", "--file", trace_file, "--tree", "--trace-id", traced])
    tree = out.getvalue()
    print(f"pio trace --tree ({os.path.getsize(trace_file)} bytes of spans):\n"
          + "\n".join(tree.splitlines()[:12]), flush=True)
    check(f"trace {traced}:" in tree and "\n  engine.query" in tree
          and "\n    serving.batch" in tree and "\n      serving.device" in tree,
          "pio trace --tree printed no tree")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return {"reload_launches": by_role["warmup"] + by_role["probe"],
            "load_launches": launches,
            "reload_s": t_reload, "p50_on": float(np.percentile(on, 50)),
            "p50_off": float(np.percentile(off, 50))}


#: phase 11: the online loop
SPLIT_USERS, SPLIT_CLIENTS, REPEAT_USERS, CLICKS, DEAD_SINK_QUERIES = 2_000, 16, 200, 100, 50
ARMS = "champion:9,challenger:1"

EVENT_PLUGIN = '''
from predictionio_tpu_torch.core.plugins import EventServerPlugin


class Gate(EventServerPlugin):
    """Refuses events named "blocked"; writes one line per committed event."""

    name = "chip-gate"

    def input_blocker(self, event, app_id, channel_id):
        return "blocked by chip-gate" if event.event == "blocked" else None

    def input_sniffer(self, event, app_id, channel_id):
        with open({sniffed!r}, "a") as f:
            f.write(event.event + "\\n")
'''


def online_loop(torch, ops, dev, home: str, train) -> dict:
    """Phase 11: the engine server's online loop at ML-20M width. Two
    registry generations (phase 5's U with its final V, then with its
    second-to-last V9) served side by side as champion and challenger
    through one EngineServer on the card, with feedback going back
    through the port's event server (a CLI subprocess with group commit
    and an EventServerPlugin from PIO_PLUGINS), an EngineServerPlugin,
    and incident capture; then the event server's quota, plugin and
    ingest.commit fault paths."""
    import http.client
    import io
    from collections import Counter

    import numpy as np

    from predictionio_tpu_torch.core import plugins as port_plugins
    from predictionio_tpu_torch.server import aot
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.server.variants import parse_weights, weighted_assign
    from predictionio_tpu_torch.storage.models import model_registry
    from predictionio_tpu_torch.utils.faults import FAULTS
    from predictionio_tpu_torch.utils.timeseries import parse_prom_text

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    U, V, V9 = train["U"], train["V"], train["V9"]
    env = dict(os.environ, PIO_HOME=home)
    procs = []

    def cli(*args, extra_env=None) -> str:
        proc = subprocess.run(CLI + list(args), cwd=repo,
                              env=dict(env, **(extra_env or {})),
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"cli {' '.join(args)} failed "
                                    f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        return proc.stdout

    # -- set-up: two generations, the champion promoted through the CLI
    t0 = time.perf_counter()
    storage, factory, _, _ = write_instance(home, U, V)
    first = storage.meta.get_latest_completed_engine_instance(factory, "default").id
    write_instance(home, U, V9)
    second = storage.meta.get_latest_completed_engine_instance(factory, "default").id
    reg = model_registry(storage)
    g1 = reg.register(first, storage.models.get(first))
    g2 = reg.register(second, storage.models.get(second))
    out = cli("models", "promote", str(g1))
    check(f"promoted gen-{g1:06d}" in out, f"models promote: {out}")
    listed = json.loads(cli("models", "list", "--json"))
    check(listed["championGeneration"] == g1
          and [e["gen"] for e in listed["generations"]] == [g1, g2],
          f"models list: {listed}")
    key = re.search(r"Access Key: (\S+)",
                    cli("app", "new", "FeedbackApp")).group(1)
    quota_key = re.search(r"Access Key: (\S+)",
                          cli("app", "new", "QuotaApp")).group(1)
    fb_app = storage.meta.get_app_by_name("FeedbackApp").id
    quota_app = storage.meta.get_app_by_name("QuotaApp").id
    plugin_dir = os.path.join(home, "plugins")
    os.makedirs(plugin_dir)
    sniffed = os.path.join(home, "sniffed.txt")
    with open(os.path.join(plugin_dir, "chip_event_plugin.py"), "w") as f:
        f.write(EVENT_PLUGIN.format(sniffed=sniffed))
    plugin_env = {"PYTHONPATH": plugin_dir, "PIO_PLUGINS": "chip_event_plugin:Gate"}
    es_port = free_port()

    def start_event_server(extra_env=None):
        log = os.path.join(home, f"eventserver{len(procs)}.log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                CLI + ["eventserver", "--ip", "127.0.0.1", "--port", str(es_port),
                       "--ingest-batching"], cwd=repo,
                env=dict(env, **plugin_env, **(extra_env or {})),
                stdout=out, stderr=subprocess.STDOUT)
        procs.append(proc)
        wait_until(lambda: http_json(es_port, "GET", "/") == (200, {"status": "alive"}),
                   proc, log, 120)
        return proc

    def stop_event_server(proc):
        proc.send_signal(2)  # SIGINT: the server drains its queue and ends
        proc.wait(timeout=60)

    es = start_event_server()
    t_setup = time.perf_counter() - t0
    print(f"set-up in {t_setup:.1f} s: generations {g1} ({first}: U, V) and {g2} "
          f"({second}: U, V9) registered, gen {g1} promoted through `models "
          f"promote`; event server with group commit and the chip-gate plugin on "
          f":{es_port}", flush=True)

    # -- the engine server: champion and challenger, feedback, a plugin
    class Counting(port_plugins.EngineServerPlugin):
        name = "chip-counter"
        seen = 0

        def output_sniffer(self, query, prediction):
            Counting.seen += 1

    incident_dir = os.path.join(home, "incidents")
    aot.EXECUTABLES.clear()
    counts0 = aot.EXECUTABLES.counts()
    port_plugins.reset_plugins()
    port_plugins.register_engine_plugin(Counting())
    t0 = time.perf_counter()
    try:
        server = EngineServer(engine_factory=factory, storage=storage,
                              host="127.0.0.1", port=0, variants=ARMS,
                              batching=True, batch_max=BATCH_MAX,
                              aot_buckets="auto", aot_topk=AOT_TOPK,
                              feedback_url=f"http://127.0.0.1:{es_port}",
                              feedback_access_key=key,
                              incident_dir=incident_dir, device=dev)
    finally:
        port_plugins.reset_plugins()
    t_load = time.perf_counter() - t0
    check([p.name for p in server.plugins] == ["chip-counter"],
          f"engine plugins {server.plugins}")
    loop = asyncio.new_event_loop()
    serve = threading.Thread(target=loop.run_until_complete,
                             args=(server.serve_forever(),), daemon=True)
    serve.start()
    deadline = time.time() + 60
    while server.http._server is None:
        check(time.time() < deadline and serve.is_alive(), "server did not start")
        time.sleep(0.05)
    port = server.http.bound_port

    def get_json(path, method="GET", body=None):
        return http_json(port, method, path, body)

    def query(conn, user, headers=None):
        """(user, status, body, arm, ms) of one num-10 query."""
        t = time.perf_counter()
        conn.request("POST", "/queries.json",
                     body=json.dumps({"user": f"u{user}", "num": 10}),
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        body = json.loads(r.read())
        return (user, r.status, body, r.headers.get("X-PIO-Variant"),
                (time.perf_counter() - t) * 1e3)

    def run_queries(users, clients, headers=None):
        out = [None] * len(users)

        def client(c):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                for j in range(c, len(users), clients):
                    out[j] = query(conn, users[j], headers)
            finally:
                conn.close()

        with ThreadPoolExecutor(clients) as pool:
            for f in [pool.submit(client, c) for c in range(clients)]:
                f.result()
        return out

    Ud = torch.as_tensor(U, device=dev)
    pad = torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)
    Vp = {"champion": torch.cat([torch.as_tensor(V, device=dev), pad]),
          "challenger": torch.cat([torch.as_tensor(V9, device=dev), pad])}

    def on_own_arm(answers, arm_of=lambda a: a[3]):
        """Answers that equal score_topk_ref of the factors of the arm that
        served them, and those that equal the other arm's too."""
        own = other = 0
        for arm in ("champion", "challenger"):
            mine = [a for a in answers if arm_of(a) == arm]
            if not mine:
                continue
            users, bodies = [a[0] for a in mine], [a[2] for a in mine]
            own += sum(answers_agree(torch, ops, dev, Ud, Vp[arm], users, bodies))
            rival = "challenger" if arm == "champion" else "champion"
            other += sum(answers_agree(torch, ops, dev, Ud, Vp[rival], users, bodies))
        return own, other

    def split_of(spec):
        return [(s.name, s.weight) for s in parse_weights(spec)]

    served = []   # every 200 answer: (user, status, body, arm, ms)
    rng = np.random.default_rng(SEED + 11)
    # the size of every feedback send (the workers deliver a backlog at once)
    sends, send_batch = Counter(), server._event_sink.send_batch

    def counted_send(events):
        sends[len(events)] += 1
        return send_batch(events)

    server._event_sink.send_batch = counted_send
    try:
        # 0. both arms warm: the challenger adopts the champion's programs
        t0 = time.perf_counter()
        while True:
            st, health = get_json("/health")
            if st == 200:
                break
            check(st == 503 and time.perf_counter() - t0 < 600,
                  f"/health while the arms warm: {st} {health}")
            time.sleep(0.05)
        t_warm = time.perf_counter() - t0
        arms = health["variants"]["variants"]
        counts1 = aot.EXECUTABLES.counts()
        built = counts1.get("compile", 0) - counts0.get("compile", 0)
        ladder = len(arms["champion"]["warmup"]["buckets"])
        print(f"deployed {ARMS} in {t_load:.1f} s, both arms warm {t_warm:.2f} s "
              f"later: champion gen {arms['champion']['generation']} built "
              f"{arms['champion']['warmup']['compiled']} programs, challenger gen "
              f"{arms['challenger']['generation']} built "
              f"{arms['challenger']['warmup']['compiled']} and adopted "
              f"{arms['challenger']['warmup']['cached']}; the cache built {built} "
              f"for a ladder of {ladder}", flush=True)
        check(arms["champion"]["generation"] == g1
              and arms["challenger"]["generation"] == g2
              and arms["champion"]["engineInstanceId"] == first
              and arms["challenger"]["engineInstanceId"] == second,
              f"arms resolved to {arms}")
        check(arms["challenger"]["warmup"]["compiled"] == 0
              and arms["challenger"]["warmup"]["cached"] == ladder
              and built == ladder, "the challenger's warm-up built programs")

        # 1. the split: 2,000 distinct users from 16 clients, per-arm launches
        users = [int(u) for u in rng.choice(N_USERS, SPLIT_USERS, replace=False)]
        by_arm, batches = Counter(), Counter()
        role, role_lock = threading.local(), threading.Lock()
        kernel, batch_fn = ops.score_topk, server._batcher.fn_batch

        def tallied(*args, **kwargs):
            out = kernel(*args, **kwargs)
            with role_lock:
                by_arm[getattr(role, "arm", "other")] += 1
            return out

        def tallied_batch(queries, arm):
            role.arm = arm
            with role_lock:
                batches[arm] += 1
            try:
                return batch_fn(queries, arm)
            finally:
                del role.arm

        reset_counters(ops)
        t0 = t_first = time.perf_counter()
        with mock.patch.object(ops, "score_topk", tallied), \
                mock.patch.object(server._batcher, "fn_batch", tallied_batch):
            split = run_queries(users, SPLIT_CLIENTS)
        t_split = time.perf_counter() - t0
        launches = read_counters(ops)["score_topk"]
        check(all(a[1] == 200 for a in split),
              f"split answers {Counter(a[1] for a in split)}")
        served += split
        arms9 = split_of(ARMS)
        want = [weighted_assign(f"u{u}", arms9, "pio") for u in users]
        wrong = sum(a[3] != w for a, w in zip(split, want))
        per_arm = Counter(a[3] for a in split)
        own, other = on_own_arm(split)
        lat = {arm: np.asarray([a[4] for a in split if a[3] == arm]) for arm in per_arm}
        print(f"{SPLIT_USERS} users from {SPLIT_CLIENTS} clients in {t_split:.2f} s: "
              f"{dict(per_arm)} (the hash: {dict(Counter(want))}), {wrong} off the "
              f"hash; {own} answers equal their own arm's reference, {other} the "
              f"other arm's; " + "; ".join(
                  f"{arm} p50 {np.percentile(x, 50):.3f} ms p99 "
                  f"{np.percentile(x, 99):.3f} ms" for arm, x in sorted(lat.items()))
              + f"; score_topk launches {launches}: {dict(by_arm)} over device "
              f"batches {dict(batches)}", flush=True)
        check(wrong == 0, f"{wrong} answers off weighted_assign")
        check(own == SPLIT_USERS, f"{SPLIT_USERS - own} answers off their arm's reference")
        check(set(per_arm) == {"champion", "challenger"}, "an arm served nothing")
        check(dict(by_arm) == dict(batches) and sum(by_arm.values()) == launches,
              f"launches {dict(by_arm)} (total {launches}) != batches {dict(batches)}")
        launches_phase11 = dict(by_arm)

        # 2. sticky on a repeat; the X-PIO-Variant header overrides
        again = run_queries(users[:REPEAT_USERS], SPLIT_CLIENTS)
        check(all(a[1] == 200 and a[3] == b[3] for a, b in zip(again, split)),
              "a repeated user changed arm")
        champs = [a[0] for a in split if a[3] == "champion"][:50]
        forced = run_queries(champs, 4, {"X-PIO-Variant": "challenger"})
        own_f, _ = on_own_arm(forced)
        check(all(a[1] == 200 and a[3] == "challenger" for a in forced)
              and own_f == len(forced), "X-PIO-Variant: challenger did not override")
        ghost = run_queries(champs[:1], 1, {"X-PIO-Variant": "ghost"})[0]
        check(ghost[1] == 400, f"X-PIO-Variant: ghost answered {ghost[1]}")
        served += again + forced
        print(f"{REPEAT_USERS} repeated users on the same arms; {len(forced)} of the "
              f"champion's users forced onto the challenger, each equal to its "
              f"reference; X-PIO-Variant: ghost answered 400", flush=True)

        # 3. weights: 1:1 applied, then the next 2,000 follow the new split
        st, body = get_json("/variants/weights", "POST",
                            {"weights": {"champion": 1, "challenger": 1}})
        check(st == 200 and body["applied"]
              and body["effectiveWeights"] == {"champion": 1.0, "challenger": 1.0},
              f"/variants/weights: {st} {body}")
        epoch = body["weightsEpoch"]
        users2 = [int(u) for u in rng.choice(N_USERS, SPLIT_USERS, replace=False)]
        split2 = run_queries(users2, SPLIT_CLIENTS)
        arms1 = [("champion", 1.0), ("challenger", 1.0)]
        wrong2 = sum(a[1] != 200 or a[3] != weighted_assign(f"u{a[0]}", arms1, "pio")
                     for a in split2)
        own2, _ = on_own_arm(split2)
        st, body = get_json("/variants/weights", "POST",
                            {"weights": {"champion": 1, "ghost": 1}})
        _, snap = get_json("/variants")
        check(400 <= st < 500 and snap["weightsEpoch"] == epoch
              and snap["variants"]["champion"]["weight"] == 1.0
              and snap["variants"]["challenger"]["weight"] == 1.0,
              f"a weight on an unknown arm: {st} {body}; /variants {snap}")
        served += split2
        print(f"weights 1:1 applied (epoch {epoch}); the next {SPLIT_USERS} queries "
              f"{dict(Counter(a[3] for a in split2))}, {wrong2} off the new hash, "
              f"{own2} on their arm's reference; a weight on 'ghost' answered {st}, "
              f"the split unchanged", flush=True)
        check(wrong2 == 0 and own2 == SPLIT_USERS, "the re-weighted split is off")

        # 4. /reload?variant=challenger: a partial swap fails closed, then heals
        chal_users = [a[0] for a in split2 if a[3] == "challenger"][:100]
        FAULTS.arm("variant.reload.partial", error="mid-swap kill")
        try:
            st, body = get_json("/reload?variant=challenger")
        finally:
            FAULTS.disarm("variant.reload.partial")
        check(st == 500 and body["swap"] == "failed", f"faulted reload: {st} {body}")
        st, health = get_json("/health")
        check(st == 200 and health["status"] == "degraded"
              and "challenger" in health["reason"]
              and health["variants"]["variants"]["challenger"]["state"] == "failed",
              f"/health after the failed swap: {st} {health}")
        moved = run_queries(chal_users, 4)
        own_m, _ = on_own_arm(moved)
        check(all(a[1] == 200 and a[3] == "champion" for a in moved)
              and own_m == len(moved),
              "the failed arm's users were not answered from the champion's factors")
        t0 = time.perf_counter()
        st, body = get_json("/reload?variant=challenger")
        t_heal = time.perf_counter() - t0
        check(st == 200 and body["swap"] == "promoted"
              and body["modelGeneration"] == g2, f"clean reload: {st} {body}")
        back = run_queries(chal_users, 4)
        own_b, _ = on_own_arm(back)
        check(all(a[1] == 200 and a[3] == "challenger" for a in back)
              and own_b == len(back), "the challenger did not serve again")
        check(get_json("/health")[1]["status"] == "ok", "/health not ok after the heal")
        served += moved + back
        print(f"/reload?variant=challenger with variant.reload.partial: 500 failed, "
              f"/health degraded ({health['reason']}), {len(moved)} of its users "
              f"answered by the champion on the champion's factors; a clean reload "
              f"in {t_heal:.2f} s brought it back ({len(back)} answers on its "
              f"factors)", flush=True)

        # 5. feedback: one predict event per 200 answer, with prId and arm
        t0 = time.perf_counter()
        while server._feedback_inflight:
            check(time.perf_counter() - t0 < 120, "the feedback executor did not drain")
            time.sleep(0.05)
        t_drain = time.perf_counter() - t0
        fb_rate = len(served) / (time.perf_counter() - t_first)
        fb = {k[0]: v for k, v in server._m_feedback.items()}
        events = list(storage.events.find(fb_app, event_names=["predict"]))
        arm_of = {a[2]["prId"]: a[3] for a in served}
        got = {e.pr_id: e for e in events}
        wrong_ev = sum(1 for e in events
                       if e.entity_type != "pio_pr" or e.entity_id != e.pr_id
                       or e.properties.get("variant") != arm_of.get(e.pr_id))
        print(f"feedback: {len(served)} answers with a prId, {len(events)} predict "
              f"events in the store ({wrong_ev} with a wrong entity or arm), "
              f"pio_engine_feedback_total {fb}; drained {t_drain:.2f} s after the "
              f"last query, {fb_rate:.0f} events/s from the first query to the "
              f"drain; {sum(sends.values())} sends, by size "
              f"{sorted(sends.items())}", flush=True)
        check(len(got) == len(events) == len(served) and set(got) == set(arm_of)
              and wrong_ev == 0, "predict events do not match the answers")
        check(fb.get("ok") == len(served) and not fb.get("dropped"),
              f"pio_engine_feedback_total {fb} for {len(served)} answers")
        # recent answers of both arms: the scoreboard keeps the last 4,096 prIds
        clicked = split2[-CLICKS:]
        clicks = Counter()
        for a in clicked:
            st, body = get_json("/feedback.json", "POST",
                                {"prId": a[2]["prId"], "click": True})
            check(st == 200 and body["variant"] == a[3], f"click: {st} {body}")
            clicks[a[3]] += 1
        _, snap = get_json("/variants")
        online = {n: v["online"] for n, v in snap["variants"].items()}
        check(all(online[n]["clicks"] == clicks[n] for n in online),
              f"/variants clicks {online} != {dict(clicks)}")
        print(f"{CLICKS} clicks accepted on their arms {dict(clicks)}; /variants "
              f"online: " + "; ".join(f"{n} served {v['served']} clicks {v['clicks']} "
                                      f"ctr {v['ctr']}" for n, v in online.items()),
              flush=True)

        # 6. a dead sink: serving stays 200, the breaker opens, one bundle
        stop_event_server(es)
        fb0 = {k[0]: v for k, v in server._m_feedback.items()}
        # one query at a time, each after the previous one's feedback has
        # settled, so that each is a send of its own (a backlog would go
        # out in one batch)
        dead = []
        t0 = time.perf_counter()
        for u in rng.integers(0, N_USERS, DEAD_SINK_QUERIES):
            dead += run_queries([int(u)], 1)
            while server._feedback_inflight:
                check(time.perf_counter() - t0 < 120, "feedback did not drain "
                                                      "(dead sink)")
                time.sleep(0.005)
        check(all(a[1] == 200 for a in dead), "a query failed with the sink down")
        fb1 = {k[0]: v for k, v in server._m_feedback.items()}
        delta = {k: fb1.get(k, 0) - fb0.get(k, 0) for k in fb1}
        server.incidents.join(30)
        st, health = get_json("/health")
        print(f"event server stopped: {DEAD_SINK_QUERIES} queries all 200; feedback "
              f"{delta}; breaker {server._sink_breaker.state}; /health "
              f"{health['status']} ({health.get('reason')})", flush=True)
        check(server._sink_breaker.state == "open" and delta.get("error", 0) == 5
              and delta.get("breaker_open", 0) > 0
              and delta.get("error", 0) + delta.get("breaker_open", 0)
              == DEAD_SINK_QUERIES, f"the feedback breaker: {delta}")
        listed = cli("incidents", "list", "--dir", incident_dir)
        ids = json.loads(cli("incidents", "list", "--dir", incident_dir, "--json"))
        check(len(ids) == 1 and ids[0]["trigger"] == "breaker-open"
              and ids[0]["id"] in listed, f"incidents list: {listed}")
        shown = cli("incidents", "show", ids[0]["id"], "--dir", incident_dir)
        print(listed.strip() + "\n" + shown.strip(), flush=True)
        check("trigger breaker-open" in shown and "health.json" in shown
              and "engine_feedback_sink" in shown, f"incidents show: {shown}")

        # 7. the event server's share: plugin, tenant quota, ingest.commit
        cli("app", "quota", "QuotaApp", "--rate", "1", "--burst", "10")
        sniffed0 = sum(1 for _ in open(sniffed))
        es = start_event_server()
        ev = {"entityType": "user", "entityId": "chip", "targetEntityType": "item",
              "targetEntityId": "i1"}
        st, body = http_json(es_port, "POST", f"/events.json?accessKey={key}",
                             dict(ev, event="blocked"))
        check(st == 403 and "chip-gate" in body["message"], f"blocked: {st} {body}")
        good = post_all(es_port, f"/events.json?accessKey={key}",
                        [json.dumps(dict(ev, event="view"))] * 20, 4)
        check(all(a[0] == 201 for a in good), "the plugin refused good events")
        sniffed1 = sum(1 for _ in open(sniffed))
        burst = post_all(es_port, f"/events.json?accessKey={quota_key}",
                         [json.dumps(dict(ev, event="view"))] * 50, 50)
        raw = urllib.request.urlopen(f"http://127.0.0.1:{es_port}/metrics",
                                     timeout=30).read().decode()
        rejected = sum(v for n, lab, v in parse_prom_text(raw)
                       if n == "pio_tenant_quota_rejected_total"
                       and lab.get("app") == str(quota_app))
        codes = Counter(a[0] for a in burst)
        sniffed2 = sum(1 for _ in open(sniffed))
        print(f"restarted event server: 'blocked' answered 403; the sniffer saw "
              f"{sniffed1 - sniffed0} of 20 201s; QuotaApp (10-event bucket) burst of "
              f"50: {dict(codes)}, pio_tenant_quota_rejected_total{{app={quota_app}}} "
              f"= {rejected:g}", flush=True)
        check(sniffed1 - sniffed0 == 20, "the sniffer missed a 201")
        check(codes[429] > 0 and rejected == codes[429]
              and sniffed2 - sniffed1 == codes[201]
              and codes[201] + codes[429] == 50, f"the quota burst: {dict(codes)}")
        check(all(a[1]["retryAfterSec"] > 0 for a in burst if a[0] == 429),
              "a 429 without retryAfterSec")
        conn = http.client.HTTPConnection("127.0.0.1", es_port, timeout=30)
        try:
            conn.request("POST", f"/events.json?accessKey={quota_key}",
                         body=json.dumps(dict(ev, event="view")),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            r.read()
            check(r.status == 429 and int(r.headers["Retry-After"]) >= 1,
                  f"one more QuotaApp event: {r.status} {dict(r.headers)}")
        finally:
            conn.close()
        stop_event_server(es)
        es = start_event_server({"PIO_FAULTS": "ingest.commit:error=storage down"})
        seq = []
        for _ in range(20):
            st, _ = http_json(es_port, "POST", f"/events.json?accessKey={key}",
                              dict(ev, event="view", entityId="faulted"))
            seq.append(st)
            if st == 503:
                break
        batch = post_all(es_port, f"/events.json?accessKey={key}",
                         [json.dumps(dict(ev, event="view", entityId="faulted"))] * 50,
                         50)
        stop_event_server(es)
        landed = list(storage.events.find(fb_app, entity_type="user",
                                          entity_id="faulted"))
        print(f"ingest.commit armed: single POSTs {seq} (500 per failed group commit "
              f"until the storage breaker opens), then a burst of 50: "
              f"{dict(Counter(a[0] for a in batch))}; {len(landed)} of them in the "
              f"store", flush=True)
        check(seq[-1] == 503 and set(seq[:-1]) == {500}
              and all(a[0] == 503 for a in batch) and not landed,
              "the faulted commits")
        check(Counting.seen == len(served) + DEAD_SINK_QUERIES,
              f"the engine plugin saw {Counting.seen} answers")
    finally:
        FAULTS.disarm()
        loop.call_soon_threadsafe(server.http.request_shutdown)
        serve.join(30)
        loop.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    check(not serve.is_alive(), "server did not stop")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return {"launches_phase11": launches_phase11, "feedback": fb,
            "feedback_per_s": fb_rate}


# -- phase 12: the ALS family at ML-20M width ------------------------------------

#: the two implicit templates' params (rank 64, 10 iterations, weighted λ)
TEMPLATE_ALPHA, TEMPLATE_SEED = 1.0, 3
CATEGORIES = ("books", "electronics", "garden", "home", "music", "sports", "toys")
BUY_AT = 4.5                     # draws rated at least this add a buy (weight 4)
EC_USERS, EC_COLD, EC_MAX_INTERACTIONS = 500, 20, 200
SP_SINGLE, SP_MULTI = 300, 200
BP_QUERIES, BP_WIDE, BP_COLD, BP_BATCH = 20_000, 1_000, 50, 1024
RESUME_EVERY, RESUME_CRASH = 3, 6


def implicit_equations_err(torch, dev, self_idx, other_idx, conf, F_other,
                           X_self, chosen, lam, alpha, head=()):
    """max|X[e] - x64[e]| / max|x64| over ``chosen``, x64 the float64 solve
    of the implicit normal equations (FᵀF + Σ α·r·f fᵀ + λ·n_e·I) x =
    Σ (1 + α·r) f over e's entries of the aggregated COO (r the entry's
    summed weight, n_e its entry count, F the whole other side). With
    ``head`` (entity ids), returns (error over ``chosen``, over its
    entities in ``head``, over the rest), each on the same scale."""
    import numpy as np

    sel = np.isin(self_idx, chosen)
    s_idx, o_idx, r = self_idx[sel], other_idx[sel], conf[sel]
    order = np.argsort(s_idx, kind="stable")
    s_idx, o_idx, r = s_idx[order], o_idx[order], r[order]
    F64 = torch.as_tensor(F_other, device=dev).double()
    G = F64.T @ F64
    k = F64.shape[1]
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    diff, in_head, rest, scale = 0.0, 0.0, 0.0, 0.0
    for e in chosen:
        lo, hi = np.searchsorted(s_idx, [e, e + 1])
        f = F64[torch.as_tensor(o_idx[lo:hi].astype(np.int64), device=dev)]
        rr = torch.as_tensor(r[lo:hi], device=dev).double()
        A = G + f.T @ (alpha * rr[:, None] * f) + max(lam * (hi - lo), 1e-8) * eye
        x = torch.linalg.solve(A, f.T @ (1.0 + alpha * rr))
        got = torch.as_tensor(X_self[e], device=dev).double()
        d = (got - x).abs().max().item()
        diff = max(diff, d)
        if e in head:
            in_head = max(in_head, d)
        else:
            rest = max(rest, d)
        scale = max(scale, x.abs().max().item())
    if not len(head):
        return diff / scale
    return diff / scale, in_head / scale, rest / scale


def template_data(train):
    """Phase 12's training data from phase 5's draws (event order): every
    draw a view; for e-commerce each draw rated >= BUY_AT also a buy of
    weight 4, after the views. Ids are "u<n>" and "i<n>"; item n's
    category is CATEGORIES[n % 7]."""
    import numpy as np

    from predictionio_tpu_torch.templates.ecommercerecommendation import engine as ec
    from predictionio_tpu_torch.templates.similarproduct import engine as sp
    from predictionio_tpu_torch.utils.bimap import BiMap

    coo = train["coo"]
    user_ids = BiMap.string_int(f"u{i}" for i in range(N_USERS))
    item_ids = BiMap.string_int(f"i{j}" for j in range(N_ITEMS))
    cats = {f"i{j}": [CATEGORIES[j % len(CATEGORIES)]] for j in range(N_ITEMS)}
    sp_td = sp.TrainingData(coo.user_idx, coo.item_idx, user_ids, item_ids, cats)
    buy = coo.rating >= BUY_AT
    ec_td = ec.TrainingData(
        "ShopApp", np.concatenate([coo.user_idx, coo.user_idx[buy]]),
        np.concatenate([coo.item_idx, coo.item_idx[buy]]),
        np.concatenate([np.ones(coo.nnz, np.float32),
                        np.full(int(buy.sum()), 4.0, np.float32)]),
        user_ids, item_ids, cats)
    return sp_td, ec_td


def train_template(torch, ops, dev, storage, label, algo, td) -> dict:
    """One template's implicit training on the card through its
    algorithm's ``train``, with the walls of ``_to_coo``, ``als_prepare``
    and the rest (upload, device training, fetch), the launch counters
    zeroed just before and read just after, and the final factors held
    against their float64 implicit normal equations."""
    import numpy as np

    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.models import als

    cls = type(algo)
    to_coo, prepare = cls._to_coo, als.als_prepare
    seen, walls = {}, {}

    def timed_coo(pd):
        t = time.perf_counter()
        seen["coo"] = to_coo(pd)
        walls["_to_coo"] = time.perf_counter() - t
        return seen["coo"]

    def timed_prepare(coo):
        t = time.perf_counter()
        seen["prep"] = prepare(coo)
        walls["als_prepare"] = time.perf_counter() - t
        return seen["prep"]

    algo.device = dev
    ctx = WorkflowContext(storage=storage, device=dev)
    reset_counters(ops)
    t0 = time.perf_counter()
    with mock.patch.object(cls, "_to_coo", staticmethod(timed_coo)), \
            mock.patch.object(als, "als_prepare", timed_prepare):
        model = algo.train(ctx, td)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_counters(ops)
    coo, prep = seen["coo"], seen["prep"]
    walls["device"] = total - walls["_to_coo"] - walls["als_prepare"]
    p = cls._als_params(algo.params)
    parts = sum(len(s.buckets) + (s.dense is not None) for s in (prep.u_side, prep.i_side))
    buckets = len(prep.u_side.buckets) + len(prep.i_side.buckets)
    print(f"{label}: {td.n} interactions -> {coo.nnz} (user, item) entries, "
          f"weights {coo.rating.min():.0f}..{coo.rating.max():.0f}; _to_coo "
          f"{walls['_to_coo']:.2f} s, als_prepare {walls['als_prepare']:.2f} s, "
          f"device (upload, {p.iterations} iterations, fetch) {walls['device']:.3f} s; "
          f"kernel launches {launches} (buckets {buckets}, parts {parts})", flush=True)
    check(launches["gather_gram"] == p.iterations * buckets,
          f"{label}: gather_gram launched {launches['gather_gram']} times, not "
          f"{p.iterations} x {buckets} buckets")
    check(launches["chol_solve"] == p.iterations * parts,
          f"{label}: chol_solve launched {launches['chol_solve']} times, not "
          f"{p.iterations} x {parts} parts")
    V = model.V
    check(np.isfinite(V).all(), f"{label}: non-finite factors")
    # the second-to-last V, and U from it (the final U half-step again)
    _, V9 = als.als_train_prepared(prep, dataclasses.replace(p, iterations=p.iterations - 1),
                                   device=dev)
    U, _ = als.als_train_prepared(prep, dataclasses.replace(p, iterations=0),
                                  device=dev, V0=V9)
    if hasattr(model, "U"):
        check(np.array_equal(U, model.U), f"{label}: the U half-step rerun is not "
              "bitwise the trained U")
    rng = np.random.default_rng(SEED + 12)
    items_chk = oracle_entities(prep.i_side, rng)
    users_chk = oracle_entities(prep.u_side, rng)
    err_v = implicit_equations_err(torch, dev, coo.item_idx, coo.user_idx, coo.rating,
                                   U, V, items_chk, p.reg, p.alpha)
    err_u = implicit_equations_err(torch, dev, coo.user_idx, coo.item_idx, coo.rating,
                                   V9, U, users_chk, p.reg, p.alpha)
    print(f"{label}: float64 implicit normal equations: {len(items_chk)} items given "
          f"the final U {err_v:.3e}, {len(users_chk)} users given the second-to-last V "
          f"{err_u:.3e} (limit {ORACLE_TOL})", flush=True)
    check(err_v <= ORACLE_TOL, f"{label}: items off their normal equations: {err_v:.3e}")
    check(err_u <= ORACLE_TOL, f"{label}: users off their normal equations: {err_u:.3e}")
    implicit_control(torch, dev, label, prep, p, coo, V9, items_chk, users_chk)
    return {"model": model, "coo": coo, "launches": launches, "walls": walls,
            "err": max(err_v, err_u)}


def implicit_control(torch, dev, label, prep, p, coo, V9, items_chk, users_chk) -> None:
    """Phase 12 control: the last iteration rerun from the second-to-last
    V with the dense head's normal equations summed in f32, the JAX
    package's formula (every ``.double()`` of the half-step a no-op),
    must fail the float64 check that the port's float64-accumulated
    dense head passes; each variant of that iteration timed (best of 3,
    upload and fetch included)."""
    from predictionio_tpu_torch.models import als

    one = dataclasses.replace(p, iterations=1)
    f32_head = mock.patch.object(torch.Tensor, "double", lambda self: self)
    walls = {}
    for name, ctx in (("float64", contextlib.nullcontext), ("f32", lambda: f32_head)):
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ctx():
                Uc, Vc = als.als_train_prepared(prep, one, device=dev, V0=V9)
            torch.cuda.synchronize()
            best = min(best or 1e9, time.perf_counter() - t)
        walls[name] = best
    def head(side):
        return set(side.perm[:side.dense.nb].tolist()) if side.dense is not None else {-1}

    err_v, head_v, rest_v = implicit_equations_err(
        torch, dev, coo.item_idx, coo.user_idx, coo.rating, Uc, Vc, items_chk, p.reg,
        p.alpha, head=head(prep.i_side))
    err_u, head_u, rest_u = implicit_equations_err(
        torch, dev, coo.user_idx, coo.item_idx, coo.rating, V9, Uc, users_chk, p.reg,
        p.alpha, head=head(prep.u_side))
    print(f"{label}: control (dense head summed in f32): float64 implicit normal "
          f"equations, items {err_v:.3e} (dense head {head_v:.3e}, the rest "
          f"{rest_v:.3e}), users {err_u:.3e} (dense head {head_u:.3e}, the rest "
          f"{rest_u:.3e}) (limit {ORACLE_TOL}); one iteration from the second-to-last "
          f"V {walls['float64']:.4f} s with the float64 dense head, {walls['f32']:.4f} s "
          f"with the f32 one", flush=True)
    check(max(err_v, err_u) > ORACLE_TOL,
          f"{label}: control (f32 dense head) passes the float64 check: it cannot tell "
          f"the float64 accumulation from f32")


def write_template_instance(storage, factory: str, algo_name: str, algo, model,
                            ds_params) -> str:
    """A COMPLETED instance of ``model`` through the port's storage and
    the algorithm's save_model."""
    from predictionio_tpu_torch.controller import params_to_json
    from predictionio_tpu_torch.storage import EngineInstance
    from predictionio_tpu_torch.storage.meta import utcnow

    iid = storage.meta.new_instance_id()
    storage.models.put(iid, pickle.dumps([algo.save_model(model, None)]))
    now = utcnow()
    storage.meta.insert_engine_instance(EngineInstance(
        id=iid, status="COMPLETED", start_time=now, end_time=now,
        engine_factory=factory, engine_variant="default", batch="chip_smoke",
        env={}, mesh_conf={},
        data_source_params=json.dumps(params_to_json(ds_params)),
        preparator_params="{}",
        algorithms_params=json.dumps([{"name": algo_name,
                                       "params": params_to_json(algo.params)}]),
        serving_params="{}"))
    return iid


@contextlib.contextmanager
def running_server(dev, storage, factory: str, instance_id=None):
    """The port's EngineServer for ``factory`` (micro-batching, the AOT
    ladder) on a free port in this process, serving its latest COMPLETED
    instance or ``instance_id``; yields the port."""
    from predictionio_tpu_torch.server.engine_server import EngineServer

    server = EngineServer(engine_factory=factory, instance_id=instance_id, storage=storage,
                          host="127.0.0.1", port=0, batching=True,
                          batch_max=BATCH_MAX, aot_buckets="auto",
                          aot_topk=AOT_TOPK, device=dev)
    check(server._warmup.wait(600) and server._warmup.ready,
          f"AOT warmup did not finish: {server._warmup.progress()}")
    loop = asyncio.new_event_loop()
    serve = threading.Thread(target=loop.run_until_complete,
                             args=(server.serve_forever(),), daemon=True)
    serve.start()
    deadline = time.time() + 60
    while server.http._server is None:
        check(time.time() < deadline and serve.is_alive(), "server did not start")
        time.sleep(0.05)
    try:
        yield server.http.bound_port
    finally:
        urllib.request.urlopen(f"http://127.0.0.1:{server.http.bound_port}/stop",
                               timeout=10).read()
        serve.join(30)
        loop.close()
    check(not serve.is_alive(), "server did not stop")


def ranked_agrees(answer, ref_items, ref_scores, score_of, eligible) -> bool:
    """An answer equals a reference ranking up to near-ties: as long, its
    items distinct and each eligible under the query's rules, and its
    scores, position by position, within TOL (relative to the largest)
    of the reference's, which are float64 and sorted descending;
    ``score_of(item)`` is an item's float64 score."""
    items = [s["item"] for s in answer]
    if len(items) != len(ref_items) or len(set(items)) != len(items):
        return False
    if not all(eligible(it) for it in items):
        return False
    tol = TOL * max(1.0, max((abs(s) for s in ref_scores), default=1.0))
    for a, it, want in zip(answer, items, ref_scores):
        if abs(score_of(it) - want) > tol or abs(a["score"] - want) > tol:
            return False
    return True


def ecommerce_serving(torch, ops, dev, storage, ec, model) -> dict:
    """Phase 12, e-commerce: the instance deployed with the port's
    EngineServer; the store holds the queried users' own events and the
    items' $sets; 500 known users (a fifth with a rule) and 20 unknown
    ones, the live rules flipped midway, every answer against a float64
    host reference applying the same rules."""
    import numpy as np

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.server import aot

    td = ec["td"]
    app = storage.meta.create_app("ShopApp")
    storage.events.init_channel(app.id)
    counts = np.bincount(td.user_idx, minlength=N_USERS)
    rng = np.random.default_rng(SEED + 21)
    users = rng.choice(np.nonzero((counts >= 1) & (counts <= EC_MAX_INTERACTIONS))[0],
                       EC_USERS, replace=False)
    t0 = time.perf_counter()
    mine = np.isin(td.user_idx, users)
    evs = [Event(event="view" if w == 1.0 else "buy", entity_type="user",
                 entity_id=f"u{u}", target_entity_type="item", target_entity_id=f"i{i}")
           for u, i, w in zip(td.user_idx[mine].tolist(), td.item_idx[mine].tolist(),
                              td.weight[mine].tolist())]
    evs += [Event(event="$set", entity_type="item", entity_id=f"i{j}",
                  properties={"categories": [CATEGORIES[j % len(CATEGORIES)]]})
            for j in range(N_ITEMS)]
    for s in range(0, len(evs), 10_000):
        storage.events.insert_batch(evs[s:s + 10_000], app.id)
    seen = {int(u): set() for u in users}
    for u, i in zip(td.user_idx[mine].tolist(), td.item_idx[mine].tolist()):
        seen[u].add(i)
    print(f"e-commerce store: {len(evs)} events ({int(mine.sum())} views and buys "
          f"of {EC_USERS} users, {N_ITEMS} item $sets) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    U64 = torch.as_tensor(model.U, device=dev).double()
    V64 = torch.as_tensor(model.V, device=dev).double()
    s32 = torch.as_tensor(model.U[users], device=dev) @ torch.as_tensor(model.V, device=dev).T
    top200 = s32.topk(200, dim=1).indices.cpu().numpy()
    queries = []
    for j, u in enumerate(users):
        q = {"user": f"u{u}", "num": 10}
        if j % 5 == 4:
            rule = (j // 5) % 3
            if rule == 0:
                q["categories"] = [CATEGORIES[int(rng.integers(len(CATEGORIES)))]]
            elif rule == 1:
                q["whiteList"] = [f"i{i}" for i in np.concatenate([
                    rng.choice(top200[j], 30, replace=False),
                    rng.integers(0, N_ITEMS, 30)])]
            else:
                q["blackList"] = [f"i{i}" for i in rng.choice(top200[j][:20], 5,
                                                             replace=False)]
        queries.append(q)
    queries += [{"user": f"nobody{c}", "num": 10} for c in range(EC_COLD)]
    order = rng.permutation(len(queries))
    first = [queries[j] for j in order[: len(queries) // 2]]
    second = [queries[j] for j in order[len(queries) // 2:]]
    pop_order = np.argsort(-model.popularity)

    def reference(q, unavailable):
        u = q["user"]
        uidx = model.user_ids.get(u)
        banned = set(unavailable) | {model.item_ids[i] for i in q.get("blackList", [])}
        if uidx is not None:
            banned |= seen.get(int(u[1:]), set())
        white = {model.item_ids[i] for i in q.get("whiteList", [])}
        cats = set(q.get("categories", []))

        def eligible(it):
            i = model.item_ids[it]
            return (i not in banned and (not white or i in white)
                    and (not cats or CATEGORIES[i % len(CATEGORIES)] in cats))

        if uidx is None:
            ranked = [int(i) for i in pop_order]
            score = {int(i): float(model.popularity[i]) for i in ranked}
        else:
            s64 = (V64 @ U64[uidx]).cpu().numpy()
            fetch = min(N_ITEMS, q["num"] + len(banned) + 50)
            ranked = np.lexsort((np.arange(N_ITEMS), -s64))[:fetch].tolist()
            score = {i: float(s64[i]) for i in ranked}
        out = [i for i in ranked if eligible(f"i{i}")][: q["num"]]
        return ([f"i{i}" for i in out], [score[i] for i in out],
                lambda it: score.get(model.item_ids[it], float("nan")), eligible)

    def off_reference(queries, outs, unavailable) -> int:
        """How many answers are not the reference's (the store as it is now)."""
        bad = 0
        for q, (status, a) in zip(queries, outs):
            items, scores, score_of, eligible = reference(q, unavailable)
            if status != 200 or not ranked_agrees(a["itemScores"], items, scores,
                                                  score_of, eligible):
                bad += 1
        return bad

    from predictionio_tpu_torch.core.workflow import ECOMMERCE_FACTORY

    with running_server(dev, storage, ECOMMERCE_FACTORY) as port:
        reset_counters(ops)
        dispatches0 = sum(aot._DISPATCHES._values.values())
        t0 = time.perf_counter()
        out1 = post_all(port, "/queries.json", [json.dumps(q) for q in first], 8)
        t1 = time.perf_counter() - t0
        bad = off_reference(first, out1, set())
        # the live rules flip: one user's first answer becomes unavailable,
        # another user views their first answer
        known = [(q, a) for q, (_, a) in zip(first, out1)
                 if model.user_ids.get(q["user"]) is not None and a["itemScores"]]
        (qa, aa), (qb, ab) = known[0], known[1]
        gone, viewed = aa["itemScores"][0]["item"], ab["itemScores"][0]["item"]
        storage.events.insert(Event(event="$set", entity_type="constraint",
                                    entity_id="unavailableItems",
                                    properties={"items": [gone]}), app.id)
        storage.events.insert(Event(event="view", entity_type="user", entity_id=qb["user"],
                                    target_entity_type="item", target_entity_id=viewed),
                              app.id)
        seen[int(qb["user"][1:])].add(model.item_ids[viewed])
        second = second + [{"user": qa["user"], "num": 10}, {"user": qb["user"], "num": 10}]
        t0 = time.perf_counter()
        out2 = post_all(port, "/queries.json", [json.dumps(q) for q in second], 8)
        t2 = time.perf_counter() - t0
        launches = read_counters(ops)
        dispatches = int(sum(aot._DISPATCHES._values.values()) - dispatches0)
    bad += off_reference(second, out2, {model.item_ids[gone]})
    n_known = sum(model.user_ids.get(q["user"]) is not None for q in first + second)
    dropped = (all(gone not in {s["item"] for s in a["itemScores"]} for _, a in out2)
               and viewed not in {s["item"] for s in out2[-1][1]["itemScores"]})
    n = len(first) + len(second)
    print(f"e-commerce: {n} queries ({n_known} known users, {n - n_known} unknown) from "
          f"8 clients in {t1 + t2:.2f} s ({n / (t1 + t2):.1f} q/s); midway {gone} made "
          f"unavailable and {viewed} viewed by {qb['user']}: dropped from every later "
          f"answer: {dropped}; answers off the float64 reference: {bad}; score_topk "
          f"launches {launches['score_topk']}, device dispatches {dispatches}", flush=True)
    check(bad == 0, f"e-commerce: {bad} of {n} answers off the float64 reference")
    check(dropped, "e-commerce: a live rule did not reach the next answers")
    check(launches["score_topk"] == n_known == dispatches,
          f"e-commerce: score_topk launched {launches['score_topk']} times over "
          f"{dispatches} dispatches for {n_known} known-user queries")
    return {"launches": launches["score_topk"], "queries": n}


def similar_serving(torch, ops, dev, storage, model) -> dict:
    """Phase 12, similar-product: 300 single-item and 200 multi-item
    queries (num 10 and 50, a quarter with a category) over HTTP, each
    against float64 similar_items with the query items absent; one
    score_topk launch a query."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import SIMILARPRODUCT_FACTORY

    V64 = torch.as_tensor(model.V, device=dev).double()
    Vn64 = V64 / V64.norm(dim=1, keepdim=True).clamp_min(1e-12)
    live = np.nonzero(np.linalg.norm(model.V, axis=1) > 0)[0]
    rng = np.random.default_rng(SEED + 22)
    queries = []
    for j in range(SP_SINGLE + SP_MULTI):
        n_q = 1 if j < SP_SINGLE else int(rng.integers(2, 6))
        q = {"items": [f"i{i}" for i in rng.choice(live, n_q, replace=False)],
             "num": 10 if j % 2 == 0 else 50}
        if j % 4 == 3:
            q["categories"] = [CATEGORIES[int(rng.integers(len(CATEGORIES)))]]
        queries.append(q)

    def reference(q):
        idx = [model.item_ids[i] for i in q["items"]]
        qv = Vn64[torch.as_tensor(idx, device=dev)].mean(0)
        s64 = (Vn64 @ (qv / qv.norm().clamp_min(1e-12))).cpu().numpy()
        s64[idx] = -np.inf
        fetch = min(N_ITEMS, q["num"] + len(idx) + 50)
        ranked = np.lexsort((np.arange(N_ITEMS), -s64))[:fetch]
        cats = set(q.get("categories", []))
        out = [int(i) for i in ranked
               if not cats or CATEGORIES[i % len(CATEGORIES)] in cats][: q["num"]]

        def eligible(it):
            i = model.item_ids[it]
            return i not in idx and (not cats or CATEGORIES[i % len(CATEGORIES)] in cats)

        return ([f"i{i}" for i in out], [float(s64[i]) for i in out],
                lambda it: float(s64[model.item_ids[it]]), eligible)

    with running_server(dev, storage, SIMILARPRODUCT_FACTORY) as port:
        reset_counters(ops)
        t0 = time.perf_counter()
        outs = post_all(port, "/queries.json", [json.dumps(q) for q in queries], 8)
        wall = time.perf_counter() - t0
        launches = read_counters(ops)
    bad = absent = 0
    for q, (status, a) in zip(queries, outs):
        items, scores, score_of, eligible = reference(q)
        if status != 200 or not ranked_agrees(a["itemScores"], items, scores, score_of,
                                              eligible):
            bad += 1
        if set(q["items"]) & {s["item"] for s in a["itemScores"]}:
            absent += 1
    print(f"similar-product: {len(queries)} queries ({SP_SINGLE} single-item, {SP_MULTI} "
          f"of 2-5 items) from 8 clients in {wall:.2f} s ({len(queries) / wall:.1f} q/s); "
          f"answers off the float64 reference: {bad}; answers holding a query item: "
          f"{absent}; score_topk launches {launches['score_topk']}", flush=True)
    check(bad == 0 and absent == 0,
          f"similar-product: {bad} answers off the reference, {absent} with a query item")
    check(launches["score_topk"] == len(queries),
          f"similar-product: score_topk launched {launches['score_topk']} times for "
          f"{len(queries)} queries")
    return {"launches": launches["score_topk"], "queries": len(queries)}


def batchpredict_through_cli(torch, ops, dev, home: str, train) -> dict:
    """Phase 12, `pio batchpredict --device cuda` in a subprocess over a
    Recommendation instance of phase 5's factors: 20,000 queries (num 10,
    the last 1,000 num 100, users drawn with the generator's skew, 50
    unknown) in batches of 1,024, every line against score_topk_ref on
    the card in float64 up to near-ties, one launch a batch."""
    import numpy as np

    U, V = train["U"], train["V"]
    write_instance(home, U, V)
    rng = np.random.default_rng(SEED + 23)
    users = train["coo"].user_idx[rng.integers(0, train["coo"].nnz, BP_QUERIES)]
    queries = [{"user": f"u{u}", "num": 10} for u in users]
    for j in range(BP_QUERIES - BP_WIDE, BP_QUERIES):
        queries[j]["num"] = 100
    for j in rng.choice(BP_QUERIES - BP_WIDE, BP_COLD, replace=False):
        queries[j]["user"] = f"nobody{j}"
    src, dst = os.path.join(home, "queries.jsonl"), os.path.join(home, "predictions.jsonl")
    with open(src, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in queries)
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        CLI + ["batchpredict", "--engine-dir",
               os.path.join(repo, "predictionio_tpu_torch", "templates", "recommendation"),
               "--input", src, "--output", dst, "--batch-size", str(BP_BATCH),
               "--device", "cuda"],
        cwd=repo, env=dict(os.environ, PIO_HOME=home), capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    print(proc.stdout.strip(), flush=True)
    check(proc.returncode == 0, f"batchpredict failed ({proc.returncode}):\n"
                                f"{proc.stderr[-4000:]}")
    launches = int(re.search(r"score_topk=(\d+)", proc.stdout).group(1))
    with open(dst) as f:
        lines = [json.loads(ln) for ln in f]
    check(len(lines) == BP_QUERIES and [ln["query"] for ln in lines] == queries,
          "batchpredict: the output lines are not the queries in order")
    known = [j for j, q in enumerate(queries) if not q["user"].startswith("nobody")]
    check(all(lines[j]["prediction"] == {"itemScores": []} for j in range(BP_QUERIES)
              if queries[j]["user"].startswith("nobody")),
          "batchpredict: an unknown user got items")
    Ud = torch.as_tensor(U, device=dev)
    Vp = torch.cat([torch.as_tensor(V, device=dev),
                    torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
    bad = 0
    for s in range(0, len(known), 2048):
        rows = known[s:s + 2048]
        ids = torch.tensor([int(queries[j]["user"][1:]) for j in rows], device=dev,
                           dtype=torch.int32)
        rv, ri = ops.score_topk_ref(Ud, Vp, 100, n_valid=N_ITEMS, ids=ids)
        s64 = Ud[ids.long()].double() @ Vp.double().T
        s64[:, N_ITEMS:] = -3.0e38
        for r, j in enumerate(rows):
            n = queries[j]["num"]
            got = lines[j]["prediction"]["itemScores"]
            if len(got) != n:
                bad += 1
                continue
            gi = torch.tensor([int(it["item"][1:]) for it in got], device=dev)
            gv = torch.tensor([it["score"] for it in got], device=dev)
            if not topk_agrees(gv[None], gi[None], rv[r:r + 1, :n], ri[r:r + 1, :n],
                               s64[r:r + 1]):
                bad += 1
    n_batches = -(-BP_QUERIES // BP_BATCH)
    print(f"batchpredict: {BP_QUERIES} lines in {wall:.2f} s of subprocess wall "
          f"({BP_QUERIES / wall:.1f} lines/s, start-up and model load included); "
          f"{n_batches} batches of {BP_BATCH} (the last {BP_QUERIES % BP_BATCH} rows "
          f"padded to {BP_BATCH}); score_topk launches {launches}; lines off the "
          f"reference: {bad}", flush=True)
    check(bad == 0, f"batchpredict: {bad} lines off score_topk_ref")
    check(launches == n_batches,
          f"batchpredict: score_topk launched {launches} times for {n_batches} batches")
    return {"launches": launches, "wall": wall}


def resume_on_card(torch, ops, dev, home: str, train) -> dict:
    """Phase 12, mid-train checkpoints on the card: phase 5's explicit
    layout and params trained straight, then a run of 6 iterations
    checkpointing every 3 (the "crash"), then a resumed run of 10 from the
    same checkpointer, which must equal the straight run bitwise; then one
    resume through `pio train --resume` in a subprocess on a small app."""
    import numpy as np

    from predictionio_tpu_torch.models.als import ALSParams, als_train_prepared
    from predictionio_tpu_torch.utils.checkpoint import TrainCheckpointer

    prep = train["prep"]
    p = ALSParams(rank=RANK, iterations=ITERATIONS, reg=LAMBDA, weighted_reg=True,
                  implicit=False, seed=SEED)
    U_ref, V_ref = als_train_prepared(prep, p, device=dev)
    saves = []
    ck = TrainCheckpointer(os.path.join(home, "als"))
    save = ck.save

    def timed_save(step, state):
        t = time.perf_counter()
        save(step, state)
        saves.append((step, time.perf_counter() - t))

    ck.save = timed_save
    als_train_prepared(prep, dataclasses.replace(p, iterations=RESUME_CRASH), device=dev,
                       checkpointer=ck, checkpoint_every=RESUME_EVERY)
    check(ck.latest_step() == RESUME_CRASH, f"no checkpoint at step {RESUME_CRASH}")
    reset_counters(ops)
    U, V = als_train_prepared(prep, p, device=dev, checkpointer=ck,
                              checkpoint_every=RESUME_EVERY)
    launches = read_counters(ops)
    n_bytes = sum(a.nbytes for a in (U, V))
    bitwise = np.array_equal(U, U_ref) and np.array_equal(V, V_ref)
    rel = max(np.abs(U - U_ref).max() / np.abs(U_ref).max(),
              np.abs(V - V_ref).max() / np.abs(V_ref).max())
    print(f"resume: {RESUME_CRASH} iterations saved every {RESUME_EVERY}, then "
          f"{ITERATIONS} resumed from step {RESUME_CRASH} ({launches['gather_gram']} "
          f"gather_gram launches); saves (step, s) "
          f"{[(s, round(t, 4)) for s, t in saves]} of {n_bytes / 1e6:.1f} MB of U and V "
          f"each; resumed factors bitwise the straight run's: {bitwise} (max rel diff "
          f"{rel:.3e})", flush=True)
    check(bitwise, f"resumed factors differ from the straight run: {rel:.3e}")
    check([s for s, _ in saves] == [3, 6, 9, 10], f"saves at steps {saves}")
    return {"saves": saves, "bitwise": bitwise}


def resume_through_cli(ops, home: str) -> int:
    """Phase 12: `pio train --resume` in a subprocess on a small app whose
    train was cut after its second checkpoint in this process: it
    continues from that step (launches of the remaining iterations only),
    equals a straight train bitwise and removes its checkpoints."""
    import io

    import numpy as np

    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.utils import checkpoint

    storage = Storage(StorageConfig(home=home))
    app = storage.meta.create_app("ResumeApp")
    storage.events.init_channel(app.id)
    users, items, ratings = synthetic_ml20m(20_000, 1_000, 200)
    storage.events.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
              target_entity_id=f"i{i}", properties={"rating": float(r)})
        for u, i, r in zip(users.tolist(), items.tolist(), ratings.tolist())], app.id)
    repo = os.path.dirname(os.path.abspath(__file__))
    variant = {"id": "resume", "engineFactory": workflow.RECOMMENDATION_FACTORY,
               "datasource": {"params": {"appName": "ResumeApp"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 16, "numIterations": 6, "lambda": 0.05, "seed": 3,
                   "checkpointEvery": 2}}]}
    vpath = os.path.join(home, "resume.json")
    with open(vpath, "w") as f:
        json.dump(variant, f)
    reset_counters(ops)
    straight = workflow.run_train(workflow.RECOMMENDATION_FACTORY, variant=variant,
                                  storage=storage)
    straight_launches = read_counters(ops)["gather_gram"]
    save = checkpoint.TrainCheckpointer.save
    n = [0]

    def cut(self, step, state):
        save(self, step, state)
        n[0] += 1
        if n[0] == 2:
            raise RuntimeError("simulated preemption after the second checkpoint")

    with mock.patch.object(checkpoint.TrainCheckpointer, "save", cut):
        try:
            workflow.run_train(workflow.RECOMMENDATION_FACTORY, variant=variant,
                               storage=storage)
        except RuntimeError:
            pass
    root = workflow._ckpt_root(storage, workflow.RECOMMENDATION_FACTORY, "resume")
    check(checkpoint.TrainCheckpointer(os.path.join(root, "als")).latest_step() == 4,
          "the cut train left no checkpoint at step 4")
    t0 = time.perf_counter()
    proc = subprocess.run(CLI + ["train", "--engine-dir", repo, "-e", vpath, "--resume"],
                          cwd=repo, env=dict(os.environ, PIO_HOME=home),
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout.strip(), flush=True)
    check(proc.returncode == 0, f"train --resume failed:\n{proc.stderr[-4000:]}")
    iid = re.search(r"engine instance (\S+)", proc.stdout).group(1)
    resumed_launches = int(re.search(r"gather_gram=(\d+)", proc.stdout).group(1))

    def factors(instance_id):
        blob = pickle.loads(storage.models.get(instance_id))[0]
        d = pickle.loads(blob)
        z = np.load(io.BytesIO(d["npz"]))
        return z["U"], z["V"]

    (Us, Vs), (Ur, Vr) = factors(straight), factors(iid)
    bitwise = np.array_equal(Us, Ur) and np.array_equal(Vs, Vr)
    gone = not os.path.exists(root)
    print(f"train --resume (subprocess, {time.perf_counter() - t0:.2f} s): continued "
          f"from step 4 of 6 with {resumed_launches} gather_gram launches (the straight "
          f"train {straight_launches}); factors bitwise the straight train's: {bitwise}; "
          f"checkpoints removed: {gone}", flush=True)
    check(3 * resumed_launches == straight_launches,
          "train --resume: did not run only the last 2 of 6 iterations")
    check(bitwise, "train --resume: factors differ from the straight train")
    check(gone, "train --resume: the completed run left its checkpoints")
    return resumed_launches


def templates_full_width(torch, ops, dev, train) -> dict:
    """Phase 12: the ALS family at ML-20M width (see the module docstring)."""
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.templates.ecommercerecommendation import engine as ec
    from predictionio_tpu_torch.templates.similarproduct import engine as sp
    from predictionio_tpu_torch.core.workflow import ECOMMERCE_FACTORY, SIMILARPRODUCT_FACTORY

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sp_td, ec_td = template_data(train)
    print(f"template data from phase 5's draws in {time.perf_counter() - t0:.2f} s: "
          f"similar-product {sp_td.n} views, e-commerce {ec_td.n} views and buys",
          flush=True)
    launches = {name: 0 for name in ("gather_gram", "chol_solve", "score_topk")}
    with tempfile.TemporaryDirectory(prefix="pio_chip_templates_") as home:
        storage = Storage(StorageConfig(home=home))
        out = {}
        for label, algo, td, factory, name, ds in (
                ("similar-product", sp.ALSAlgorithm(sp.ALSAlgorithmParams(
                    rank=RANK, num_iterations=ITERATIONS, lambda_=LAMBDA,
                    alpha=TEMPLATE_ALPHA, seed=TEMPLATE_SEED)), sp_td,
                 SIMILARPRODUCT_FACTORY, "als", sp.DataSourceParams(app_name="ShopApp")),
                ("e-commerce", ec.ECommAlgorithm(ec.ECommAlgorithmParams(
                    rank=RANK, num_iterations=ITERATIONS, lambda_=LAMBDA,
                    alpha=TEMPLATE_ALPHA, seed=TEMPLATE_SEED)), ec_td,
                 ECOMMERCE_FACTORY, "ecomm", ec.DataSourceParams(app_name="ShopApp"))):
            res = train_template(torch, ops, dev, storage, label, algo, td)
            for k in ("gather_gram", "chol_solve"):
                launches[k] += res["launches"][k]
            t0 = time.perf_counter()
            write_template_instance(storage, factory, name, algo, res["model"], ds)
            print(f"{label}: instance written in {time.perf_counter() - t0:.2f} s", flush=True)
            out[label] = dict(res, td=td)
        ecs = ecommerce_serving(torch, ops, dev, storage, out["e-commerce"],
                                out["e-commerce"]["model"])
        sps = similar_serving(torch, ops, dev, storage, out["similar-product"]["model"])
        launches["score_topk"] += ecs["launches"] + sps["launches"]
    with tempfile.TemporaryDirectory(prefix="pio_chip_batchpredict_") as home:
        bp = batchpredict_through_cli(torch, ops, dev, home, train)
        launches["score_topk"] += bp["launches"]
    with tempfile.TemporaryDirectory(prefix="pio_chip_resume_") as home:
        resume_on_card(torch, ops, dev, home, train)
        resume_through_cli(ops, home)
    wall = time.perf_counter() - t_phase
    print(f"phase 12: {wall:.1f} s wall; launches {launches}", flush=True)
    return {"launches": launches, "wall": wall}


# -- phase 13: ANN and the two-tower template at full width ----------------------

#: the cut of phase 13: the two-tower template's 5 epochs → 1
TT_EPOCHS = 1
TT_PAIRS = 5_000_000       # the draws two-tower trains on (cut from 20,000,263)
TT_CHECK_STEPS = 50        # the card's first steps held against the CPU's (--ann)
TT_RUN_CHECK_STEPS = 10    # the whole run's cut, to keep it in its time
TT_STEP_TOL = 1e-4         # of each leaf's max |value|, and of its norm
TT_MAX_FLIP_SHARE = 1e-5   # switched ReLUs, of the check's hidden units
TT_F32_FACTOR = 4.0        # f32: the card's error, of the CPU's own
TT_CONTROL_TEMP = 1e-3     # the temperature control's relative offset
TT_SERVED = 500            # users sent to each two-tower server
ANN_M, ANN_K, ANN_SHORTLIST = 8, 256, 128
SP_ANN_QUERIES = 500
BIG_N, BIG_D, BIG_K = 10_000_000, 32, 16
BIG_BATCHES = (1, 8, 64)
BIG_CHECK_ROWS = 8


def tt_variant(**algo) -> dict:
    """The two-tower template's engine.json, its epochs cut to
    TT_EPOCHS, with ``algo`` over its algorithm params."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "predictionio_tpu_torch", "templates", "twotower", "engine.json")
    with open(path, encoding="utf-8") as f:
        v = json.load(f)
    params = v["algorithms"][0]["params"]
    params.update(epochs=TT_EPOCHS, **algo)
    v["id"] = "ann" if params.get("ann") else "exact"
    if params.get("annOpq"):
        v["id"] = "opq"
    return v


def _relu_flip_masks(pre_ref: dict, pre_got: dict, ids: dict):
    """The entries a switched ReLU reaches, and the count of switches.

    ``pre_*`` map (tower, hidden layer) to that layer's (B, width) input
    to its ReLU in one step's forward, ``ids`` each tower's (B,) rows. A
    unit whose input lies within rounding of 0 can switch between two
    summation orders: its output is about 0 either way, but its gradient
    jumps between 0 and the full upstream value, so the step of that
    sample's embedding row, of the unit's weight row and bias, and of
    every layer below it differs by a whole term. Returns ({leaf: [index,
    ...]} to leave out, number of switched units)."""
    import numpy as np

    masks, flips = {}, 0
    for (side, layer), a in pre_ref.items():
        switched = (a > 0) != (pre_got[(side, layer)] > 0)
        flips += int(switched.sum())
        if not switched.any():
            continue
        samples, units = np.nonzero(switched)
        masks.setdefault(f"{side}.embed.weight", []).append(np.unique(ids[side][samples]))
        masks.setdefault(f"{side}.hidden.{layer}.weight", []).append(np.unique(units))
        masks.setdefault(f"{side}.hidden.{layer}.bias", []).append(np.unique(units))
        for below in range(layer):
            for leaf in ("weight", "bias"):
                masks.setdefault(f"{side}.hidden.{below}.{leaf}", []).append(slice(None))
    return masks, flips


def _leaf_errors(ref: dict, got: dict, masks: dict) -> dict:
    """{leaf: (worst entry of |got − ref| over the leaf's max |ref|,
    ‖got − ref‖ / ‖ref‖)}, the ``masks`` entries left out of both."""
    import numpy as np

    out = {}
    for leaf, r in ref.items():
        r = r.astype(np.float64)
        d = np.abs(got[leaf].astype(np.float64) - r)
        scale = max(float(np.abs(r).max()), 1e-30)
        if leaf in masks:
            d, r = d.copy(), r.copy()
            for index in masks[leaf]:
                d[index] = 0.0
                r[index] = 0.0
        out[leaf] = (float(d.max()) / scale,
                     float(np.linalg.norm(d)) / max(float(np.linalg.norm(r)), 1e-30))
    return out


def tt_step_check(torch, dev, uu, ii, params: dict, n_steps: int = TT_CHECK_STEPS) -> dict:
    """The card's first ``n_steps`` training steps against the port's
    CPU run of the same steps (the same seeded initialisation, the same
    batches: epoch 0's permutation). Each card step starts from the CPU's
    state before that step (parameters, Adam moments, step count).

    float64: every entry of each leaf's gradient and of each parameter
    after the Adam step within TT_STEP_TOL of the leaf's max |value| of
    the CPU's step, and each leaf within TT_STEP_TOL in its norm.

    f32, the training precision, cannot meet that: some of its steps are
    ill-conditioned. The output bias's gradient is a sum over the batch
    that nearly cancels, and Adam divides a component's moment by its
    root mean square, so a row whose gradient is tiny moves by about lr
    whichever way rounding tips it. So the f32 step of the card and the
    CPU's f32 step are each held against the float64 step from the same
    state (on the CPU): for each leaf, gradient and parameters, the
    card's worst entry and its norm error must be within TT_STEP_TOL or
    within TT_F32_FACTOR times the CPU's own. Two controls must fail that
    gate: the card's step with TF32 matrix products, and with the
    temperature off by TT_CONTROL_TEMP.

    In every comparison the entries a ReLU that switched between the two
    runs reaches are left out (``_relu_flip_masks``); the switches are
    counted and must stay under TT_MAX_FLIP_SHARE of the hidden units.

    A free f32 run of the card, and of the CPU on one thread, is printed,
    not gated: differences of 1e-7 grow to a good part of the weights
    within 50 steps between ANY two summation orders, the CPU's own at
    another thread count included."""
    import numpy as np

    from predictionio_tpu_torch.models import two_tower as tt
    from predictionio_tpu_torch.utils.device import full_f32

    p = tt.TwoTowerParams(embed_dim=params["embedDim"], hidden=list(params["hidden"]),
                          out_dim=params["outDim"], batch_size=params["batchSize"],
                          learning_rate=params["learningRate"],
                          temperature=params["temperature"], seed=0)
    B = p.batch_size
    uv, iv = tt.init_variables(N_USERS, N_ITEMS, p)
    perm = np.random.default_rng(p.seed).permutation(len(uu))[:n_steps * B]
    bu = torch.from_numpy(uu[perm].reshape(n_steps, B).astype(np.int64))
    bi = torch.from_numpy(ii[perm].reshape(n_steps, B).astype(np.int64))
    bu_d, bi_d = bu.to(dev), bi.to(dev)
    cpu_dev = torch.device("cpu")

    def trainer(device, dtype, hooked=True):
        tr = tt.TwoTowerTrainer(uv, iv, p, device)
        tr.user.to(dtype)
        tr.item.to(dtype)
        tr.pre = {}
        if hooked:
            for side in ("user", "item"):
                for layer, lin in enumerate(getattr(tr, side).hidden):
                    lin.register_forward_hook(
                        lambda m, i, o, key=(side, layer), pre=tr.pre:
                        pre.__setitem__(key, o.detach().cpu().numpy()))
        return tr

    def leaves(tr, grad: bool) -> dict:
        return {f"{side}.{n}": (t.grad if grad else t).detach().cpu().numpy()
                for side, n, t in tr._named()}

    def as64(state):
        if isinstance(state, dict):
            return {k: as64(v) for k, v in state.items()}
        return state.astype(np.float64) if state.dtype == np.float32 else state

    def run(tr, state, j, on_card, tf32=False):
        tr.load_state(state)
        if tf32:
            torch.set_float32_matmul_precision("high")
        try:
            loss = float(tr.step(bu_d[j] if on_card else bu[j],
                                 bi_d[j] if on_card else bi[j]))
            if on_card:
                torch.cuda.synchronize()
        finally:
            torch.set_float32_matmul_precision("highest")
        return loss

    def accumulate(acc, name, ref_tr, tr, ids, refs):
        masks, n = _relu_flip_masks(ref_tr.pre, tr.pre, ids)
        acc.setdefault(name, {"flips": 0, "grad": {}, "param": {}})
        acc[name]["flips"] += n
        for what, grad in (("grad", True), ("param", False)):
            for leaf, (e, f) in _leaf_errors(refs[what], leaves(tr, grad), masks).items():
                old = acc[name][what].get(leaf, (0.0, 0.0))
                acc[name][what][leaf] = (max(old[0], e), max(old[1], f))

    def worst(a: dict) -> tuple:
        """(worst gradient entry, worst gradient norm, worst parameter
        entry), each (error, leaf)."""
        return tuple(max((a[what][leaf][k], leaf) for leaf in a[what])
                     for what, k in (("grad", 0), ("grad", 1), ("param", 0)))

    def limit_share(a: dict, cpu: dict) -> tuple:
        """The f32 gate: (highest error over its limit, where)."""
        return max((a[what][leaf][k] / max(TT_STEP_TOL, TT_F32_FACTOR * cpu[what][leaf][k]),
                    f"{leaf} {what} {('entry', 'norm')[k]}")
                   for what in ("grad", "param") for leaf in a[what] for k in (0, 1))

    def said(a: dict) -> str:
        g, n, q = worst(a)
        return (f"gradient worst entry {g[0]:.3e} ({g[1]}), worst norm {n[0]:.3e} "
                f"({n[1]}), parameters' worst entry {q[0]:.3e} ({q[1]}), "
                f"{a['flips']} ReLU switches")

    units = 2 * n_steps * B * sum(p.hidden)
    with full_f32():
        acc64: dict = {}
        cpu, card = trainer(cpu_dev, torch.float64), trainer(dev, torch.float64)
        for j in range(n_steps):
            state = cpu.state()
            run(cpu, state, j, False)
            run(card, state, j, True)
            refs = {"grad": leaves(cpu, True), "param": leaves(cpu, False)}
            accumulate(acc64, "card", cpu, card, {"user": bu[j].numpy(), "item": bi[j].numpy()},
                       refs)
        acc32: dict = {}
        cpu, truth = trainer(cpu_dev, torch.float32), trainer(cpu_dev, torch.float64)
        runs = {"card": trainer(dev, torch.float32), "tf32": trainer(dev, torch.float32),
                "temperature": trainer(dev, torch.float32)}
        runs["temperature"].temperature *= 1.0 + TT_CONTROL_TEMP
        losses, t_cpu, t_card = [], 0.0, 0.0
        for j in range(n_steps):
            state = cpu.state()
            ids = {"user": bu[j].numpy(), "item": bi[j].numpy()}
            run(truth, as64(state), j, False)
            refs = {"grad": leaves(truth, True), "param": leaves(truth, False)}
            for name, tr in runs.items():
                t0 = time.perf_counter()
                loss = run(tr, state, j, True, tf32=name == "tf32")
                if name == "card":
                    t_card += time.perf_counter() - t0
                    card_loss = loss
                accumulate(acc32, name, truth, tr, ids, refs)
            t0 = time.perf_counter()
            losses.append((run(cpu, state, j, False), card_loss))
            t_cpu += time.perf_counter() - t0
            accumulate(acc32, "cpu", truth, cpu, ids, refs)
            accumulate(acc32, "card vs cpu", cpu, runs["card"], ids,
                       {"grad": leaves(cpu, True), "param": leaves(cpu, False)})
        free = trainer(dev, torch.float32, hooked=False)
        for j in range(n_steps):
            free.step(bu_d[j], bi_d[j])
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = trainer(cpu_dev, torch.float32, hooked=False)
            for j in range(n_steps):
                one.step(bu[j], bi[j])
        finally:
            torch.set_num_threads(threads)
    ref32 = leaves(cpu, False)
    free_err = max((e, leaf) for leaf, (e, _) in _leaf_errors(ref32, leaves(free, False),
                                                               {}).items())
    one_err = max((e, leaf) for leaf, (e, _) in _leaf_errors(ref32, leaves(one, False),
                                                              {}).items())
    share = {name: limit_share(acc32[name], acc32["cpu"])
             for name in ("card", "tf32", "temperature")}
    loss_err = max(abs(a - b) for a, b in losses)
    print(f"two-tower: the first {n_steps} steps on the card, each from the CPU's "
          f"state before it (same init and batches; {units:,} hidden units in all; "
          f"entries a switched ReLU reaches masked). float64 against the CPU's float64 "
          f"step (limit {TT_STEP_TOL}): {said(acc64['card'])}. f32 against the float64 step "
          f"from the same state (limit per leaf the larger of {TT_STEP_TOL} and "
          f"{TT_F32_FACTOR} x the CPU's f32 error): the card {said(acc32['card'])}; the CPU "
          f"{said(acc32['cpu'])}; the card's highest share of its limit {share['card'][0]:.3f} "
          f"({share['card'][1]}). The card's f32 step against the CPU's, not gated: "
          f"{said(acc32['card vs cpu'])}. f32 losses {losses[0][1]:.5f} -> "
          f"{losses[-1][1]:.5f} (max |d| {loss_err:.3e}); f32 CPU {t_cpu:.2f} s, card "
          f"{t_card:.2f} s", flush=True)
    print(f"two-tower step controls, which must fail the f32 gate: TF32 products "
          f"{said(acc32['tf32'])}, share of its limit {share['tf32'][0]:.3f} "
          f"({share['tf32'][1]}); temperature x (1 + {TT_CONTROL_TEMP}) "
          f"{said(acc32['temperature'])}, share {share['temperature'][0]:.3f} "
          f"({share['temperature'][1]})", flush=True)
    print(f"two-tower free f32 runs after {n_steps} steps, not gated (worst entry "
          f"of its max |value|): the card {free_err[0]:.3e} ({free_err[1]}); the CPU on "
          f"one thread against {threads} threads {one_err[0]:.3e} ({one_err[1]})",
          flush=True)
    g, n, q = worst(acc64["card"])
    check(max(g[0], n[0], q[0]) <= TT_STEP_TOL
          and max(e[1] for e in acc64["card"]["param"].values()) <= TT_STEP_TOL
          and acc64["card"]["flips"] <= TT_MAX_FLIP_SHARE * units,
          f"two-tower: float64 card steps off the CPU's: {said(acc64['card'])}")
    check(share["card"][0] <= 1.0 and acc32["card"]["flips"] <= TT_MAX_FLIP_SHARE * units,
          f"two-tower: f32 card steps off the float64 step: {said(acc32['card'])}, "
          f"share of its limit {share['card'][0]:.3f} ({share['card'][1]})")
    for name in ("tf32", "temperature"):
        check(share[name][0] > 1.0, f"two-tower: the {name} control passed the f32 step "
              f"gate: {said(acc32[name])}")
    return {"err": share["card"][0], "first_loss": losses[0][1]}


def prefetch_check(torch, dev, uu, ii) -> None:
    """The streaming trainer's input path on the card: (G, B) step groups
    of phase 5's draws through ``DevicePrefetcher`` (pinned buffers, a
    side stream, depth 2) arrive whole, in order, bitwise the host's."""
    import numpy as np

    from predictionio_tpu_torch.data.pipeline import DevicePrefetcher

    G, B = 64, 1024
    n = min(40, len(uu) // (G * B))
    groups = [(uu[j * G * B:(j + 1) * G * B].reshape(G, B),
               ii[j * G * B:(j + 1) * G * B].reshape(G, B)) for j in range(n)]
    t0 = time.perf_counter()
    bad = 0
    with DevicePrefetcher(iter(groups), device=dev) as pf:
        for (hu, hi), (du, di) in zip(groups, pf):
            check(torch.as_tensor(du).device.type == "cuda",
                  "prefetched group not on the card")
            bad += int(not (np.array_equal(torch.as_tensor(du).cpu().numpy(), hu)
                            and np.array_equal(torch.as_tensor(di).cpu().numpy(), hi)))
    print(f"DevicePrefetcher: {n} groups of (64, 1,024) pairs to the card in "
          f"{time.perf_counter() - t0:.2f} s; groups off the host's: {bad}", flush=True)
    check(bad == 0, f"DevicePrefetcher: {bad} groups off the host's")


def profile_two_tower(torch, dev, uu, ii, params: dict) -> None:
    """``--profile``: device and host time by op of 50 f32 training steps
    at the template's widths (torch.profiler), after 20 warm steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.models import two_tower as tt
    from predictionio_tpu_torch.utils.device import full_f32

    p = tt.TwoTowerParams(embed_dim=params["embedDim"], hidden=list(params["hidden"]),
                          out_dim=params["outDim"], batch_size=params["batchSize"],
                          learning_rate=params["learningRate"],
                          temperature=params["temperature"], seed=0)
    B = p.batch_size
    bu = torch.from_numpy(uu[:70 * B].reshape(70, B).astype(np.int64)).to(dev)
    bi = torch.from_numpy(ii[:70 * B].reshape(70, B).astype(np.int64)).to(dev)
    tr = tt.TwoTowerTrainer(*tt.init_variables(N_USERS, N_ITEMS, p), p, dev)
    with full_f32():
        for j in range(20):
            tr.step(bu[j], bi[j])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for j in range(20, 70):
                tr.step(bu[j], bi[j])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # the table footer's sum: kernels, not the optimizer's annotation
    dev_us = sum(r.self_device_time_total for r in rows
                 if r.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(r, "is_user_annotation", False)) / 50
    launches = sum(r.count for r in rows if r.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    print(f"two-tower --profile: 50 steps in {wall * 1e3 / 50:.3f} ms a step (host clock, "
          f"profiler on), device {dev_us / 1e3:.3f} ms a step, {launches / 50:.1f} kernel "
          f"launches a step", flush=True)
    print(rows.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)


def ann_replay(q64, index, corpus64, kprime: int):
    """Host float64 replay of one ANN query: the ADC scores of every
    item against ``index`` (the query rotated first with OPQ), the top
    k′ by (score descending, item ascending), and the exact scores of
    that shortlist. Returns (adc, shortlist, exact)."""
    import numpy as np

    m, _, dsub = index.codebooks.shape
    qr = q64 @ index.rotation.astype(np.float64) if index.rotation is not None else q64
    lut = np.einsum("md,mkd->mk", qr.reshape(m, dsub), index.codebooks.astype(np.float64))
    adc = np.zeros(index.n_items)
    for mi in range(m):
        adc += lut[mi][index.codes[:, mi]]
    shortlist = np.lexsort((np.arange(index.n_items), -adc))[:kprime]
    return adc, shortlist, corpus64[shortlist] @ q64


def ann_reference(q64, index, corpus64, kprime: int, num: int, exclude=()):
    """``ranked_agrees`` arguments for an ANN answer: the replay's
    re-ranked shortlist (equal exact scores in shortlist order, the
    excluded items left out) cut to ``num``; an item is eligible when
    its float64 ADC score reaches the k′-th one within TOL (a near-tie
    at the shortlist's edge) and it is not excluded."""
    import numpy as np

    adc, shortlist, exact = ann_replay(q64, index, corpus64, kprime)
    order = np.lexsort((np.arange(len(shortlist)), -exact))
    ranked = [int(shortlist[j]) for j in order if int(shortlist[j]) not in exclude][:num]
    edge = adc[shortlist[-1]] - TOL * max(1.0, abs(adc[shortlist[0]]))
    scores = {int(j): float(s) for j, s in zip(shortlist, exact)}

    def score_of(it):
        j = int(it[1:])
        return scores.get(j, float(corpus64[j] @ q64))

    def eligible(it):
        j = int(it[1:])
        return adc[j] >= edge and j not in exclude

    return ([f"i{j}" for j in ranked], [scores[j] for j in ranked], score_of, eligible)


def serve_and_check(torch, ops, dev, storage, factory, iid, bodies, reference,
                    label: str) -> dict:
    """POST ``bodies`` to an EngineServer of instance ``iid``, once from
    one client and once from 8; every answer checked by ``reference(i)``
    (``ranked_agrees`` arguments). Returns the launches, the dispatches
    and the answers of the 8-client run."""
    from predictionio_tpu_torch.server import aot

    out = {}
    with running_server(dev, storage, factory, instance_id=iid) as port:
        for clients in (1, 8):
            reset_counters(ops)
            d0 = sum(aot._DISPATCHES._values.values())
            t0 = time.perf_counter()
            answers = post_all(port, "/queries.json", bodies, clients)
            wall = time.perf_counter() - t0
            launches = read_counters(ops)["score_topk"]
            dispatches = int(sum(aot._DISPATCHES._values.values()) - d0)
            bad = sum(1 for j, (status, a) in enumerate(answers)
                      if status != 200 or not ranked_agrees(a["itemScores"], *reference(j)))
            print(f"{label}: {len(bodies)} queries from {clients} client(s) in "
                  f"{wall:.2f} s ({len(bodies) / wall:.1f} q/s); answers off the "
                  f"float64 reference: {bad}; device dispatches {dispatches}, "
                  f"score_topk launches {launches}", flush=True)
            check(bad == 0, f"{label}: {bad} answers off the float64 reference")
            out[clients] = {"launches": launches, "dispatches": dispatches,
                            "answers": answers}
    return out


def twotower_full_width(torch, ops, dev, coo, profile: bool = False,
                        check_steps: int = TT_CHECK_STEPS) -> dict:
    """Phase 13, two-tower: trained through run_train on phase 5's draws,
    served exact and with ANN (plain PQ and OPQ)."""
    import numpy as np

    from predictionio_tpu_torch.ann import index as ann_index
    from predictionio_tpu_torch.core.workflow import TWOTOWER_FACTORY, run_train
    from predictionio_tpu_torch.data.pipeline import InteractionData
    from predictionio_tpu_torch.models import two_tower as tt_model
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.templates.twotower import engine as tt
    from predictionio_tpu_torch.utils.bimap import BiMap

    uu, ii = coo.user_idx[:TT_PAIRS], coo.item_idx[:TT_PAIRS]
    data = InteractionData(BiMap.string_int(f"u{i}" for i in range(N_USERS)),
                           BiMap.string_int(f"i{j}" for j in range(N_ITEMS)),
                           lambda: iter([(uu, ii, np.ones(len(uu), np.float32))]),
                           len(uu))
    td = tt.TrainingData(data, stream=False)
    read = mock.patch.object(tt.TTDataSource, "read_training", lambda self, ctx: td)
    base = tt_variant()
    steps = tt_step_check(torch, dev, uu, ii, base["algorithms"][0]["params"], check_steps)
    prefetch_check(torch, dev, uu, ii)
    if profile:
        profile_two_tower(torch, dev, uu, ii, base["algorithms"][0]["params"])
    launches = {"score_topk": 0}
    stats, trained, built = {}, {}, {}
    train_fn, build_fn = tt.two_tower_train, ann_index.build_index

    def timed_train(*args, **kw):
        trained["vars"] = train_fn(*args, **dict(kw, stats=stats))
        return trained["vars"]

    def capture_build(*args, **kw):
        built["index"] = build_fn(*args, **kw)
        return built["index"]

    with tempfile.TemporaryDirectory(prefix="pio_chip_twotower_") as home:
        storage = Storage(StorageConfig(home=home))
        t0 = time.perf_counter()
        with read, mock.patch.object(tt, "two_tower_train", timed_train):
            exact_id = run_train(TWOTOWER_FACTORY, variant=base, storage=storage, device=dev)
        wall = time.perf_counter() - t0
        losses = stats["epoch_losses"]
        print(f"two-tower: run_train of {len(uu)} pairs ({N_USERS} x {N_ITEMS}), "
              f"{TT_EPOCHS} epoch(s) of {stats['steps']} steps at batch "
              f"{base['algorithms'][0]['params']['batchSize']}: {stats['train_sec']:.2f} s "
              f"of training ({stats['steps'] / stats['train_sec']:.1f} steps/s), "
              f"{wall:.2f} s of run_train; epoch loss first {losses[0]:.5f}, last "
              f"{losses[-1]:.5f}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < steps["first_loss"],
              f"two-tower: epoch losses {losses} not below the first step's "
              f"{steps['first_loss']:.5f}")
        uv, iv = trained["vars"]
        UE = tt_model.two_tower_embed_users(uv, N_USERS, None)
        IE = tt_model.two_tower_embed_items(iv, N_ITEMS, None)
        UE64, IE64 = UE.astype(np.float64), IE.astype(np.float64)
        rng = np.random.default_rng(SEED + 31)
        users = rng.choice(N_USERS, TT_SERVED, replace=False)
        bodies = [json.dumps({"user": f"u{u}", "num": 10}) for u in users]
        S64 = (torch.as_tensor(UE64[users], device=dev)
               @ torch.as_tensor(IE64, device=dev).T).cpu().numpy()

        def exact_ref(j):
            s = S64[j]
            top = np.lexsort((np.arange(N_ITEMS), -s))[:10]
            return ([f"i{t}" for t in top], [float(s[t]) for t in top],
                    lambda it: float(s[int(it[1:])]), lambda it: True)

        ex = serve_and_check(torch, ops, dev, storage, TWOTOWER_FACTORY, exact_id,
                             bodies, exact_ref, "two-tower exact")
        for c in (1, 8):
            check(ex[c]["launches"] == ex[c]["dispatches"] > 0,
                  f"two-tower exact: {ex[c]['launches']} score_topk launches for "
                  f"{ex[c]['dispatches']} dispatches")
            launches["score_topk"] += ex[c]["launches"]
        exact_items = [[s["item"] for s in a["itemScores"]] for _, a in ex[8]["answers"]]

        for label, extra in (("plain PQ", {}), ("OPQ", {"annOpq": True})):
            v = tt_variant(ann=True, annM=ANN_M, annK=ANN_K, annShortlist=ANN_SHORTLIST,
                           **extra)
            with read, mock.patch.object(tt, "two_tower_train",
                                         lambda *a, **kw: trained["vars"]), \
                    mock.patch.object(ann_index, "build_index", capture_build):
                t0 = time.perf_counter()
                iid = run_train(TWOTOWER_FACTORY, variant=v, storage=storage, device=dev)
                wall = time.perf_counter() - t0
            index = built["index"]
            meta = index.meta
            print(f"two-tower ANN ({label}): run_train reusing the trained towers "
                  f"{wall:.2f} s; index build {meta['build_sec']:.3f} s (Lloyd "
                  f"{meta['lloyd_sec']:.3f} s, encode {meta['encode_sec']:.3f} s, OPQ "
                  f"{meta['opq_sec']:.3f} s), M={index.m} K={index.k} over "
                  f"{index.n_items} items, rotation {index.rotation is not None}", flush=True)
            refs = [ann_reference(UE64[u], index, IE64, ANN_SHORTLIST, 10) for u in users]
            res = serve_and_check(torch, ops, dev, storage, TWOTOWER_FACTORY, iid, bodies,
                                  lambda j: refs[j], f"two-tower ANN ({label})")
            for c in (1, 8):
                check(res[c]["launches"] == 0 and res[c]["dispatches"] > 0,
                      f"two-tower ANN ({label}): {res[c]['launches']} score_topk launches "
                      f"on the ANN path")
            hits = sum(len(set(e) & {s["item"] for s in a["itemScores"]})
                       for e, (_, a) in zip(exact_items, res[8]["answers"]))
            print(f"two-tower ANN ({label}): recall@10 against the exact path "
                  f"{hits / (10 * len(users)):.4f} (not gated: the pairs are random)",
                  flush=True)
    return launches


def similar_ann_full_width(torch, ops, dev, coo) -> dict:
    """Phase 13, similar-product with ``ann: true``: phase 12's implicit
    train (rank 64) through run_train, then single-item queries each
    against the float64 replay of its ADC shortlist and re-rank."""
    import numpy as np

    from predictionio_tpu_torch.ann import index as ann_index
    from predictionio_tpu_torch.core.workflow import SIMILARPRODUCT_FACTORY, run_train
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.templates.similarproduct import engine as sp

    sp_td, _ = template_data({"coo": coo})
    built, build_fn = {}, ann_index.build_index

    def capture_build(*args, **kw):
        built["Vn"] = np.asarray(args[0])
        built["index"] = build_fn(*args, **kw)
        return built["index"]

    variant = {"id": "ann", "engineFactory": SIMILARPRODUCT_FACTORY,
               "datasource": {"params": {"appName": "ShopApp"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": RANK, "numIterations": ITERATIONS, "lambda": LAMBDA,
                   "alpha": TEMPLATE_ALPHA, "seed": TEMPLATE_SEED, "ann": True,
                   "annM": ANN_M, "annK": ANN_K}}]}
    with tempfile.TemporaryDirectory(prefix="pio_chip_similar_ann_") as home:
        storage = Storage(StorageConfig(home=home))
        reset_counters(ops)
        t0 = time.perf_counter()
        with mock.patch.object(sp.SimilarProductDataSource, "read_training",
                               lambda self, ctx: sp_td), \
                mock.patch.object(ann_index, "build_index", capture_build):
            iid = run_train(SIMILARPRODUCT_FACTORY, variant=variant, storage=storage,
                            device=dev)
        wall = time.perf_counter() - t0
        train_launches = read_counters(ops)
        index, Vn = built["index"], built["Vn"]
        meta = index.meta
        print(f"similar-product ANN: run_train {wall:.2f} s, kernel launches "
              f"{train_launches}; index build {meta['build_sec']:.3f} s (Lloyd "
              f"{meta['lloyd_sec']:.3f} s, encode {meta['encode_sec']:.3f} s) over the "
              f"normalised V, M={index.m} K={index.k}", flush=True)
        for k in ("gather_gram", "chol_solve"):
            check(train_launches[k] > 0, f"similar-product ANN: train made no {k} launch")
        algo_dir = os.path.join(storage.models.model_dir(iid), "als")
        check(os.path.isfile(os.path.join(algo_dir, ann_index.INDEX_BASENAME))
              and os.path.isfile(os.path.join(algo_dir, ann_index.MANIFEST_BASENAME)),
              "similar-product ANN: no index sidecar beside model.bin")
        Vn64 = Vn.astype(np.float64)
        live = np.nonzero(np.linalg.norm(Vn, axis=1) > 0)[0]
        rng = np.random.default_rng(SEED + 32)
        items = rng.choice(live, SP_ANN_QUERIES, replace=False)
        bodies = [json.dumps({"items": [f"i{j}"], "num": 10}) for j in items]
        refs = [ann_reference(Vn64[j], index, Vn64, ANN_SHORTLIST, 10, exclude={int(j)})
                for j in items]
        res = serve_and_check(torch, ops, dev, storage, SIMILARPRODUCT_FACTORY, iid, bodies,
                              lambda j: refs[j], "similar-product ANN")
        for c in (1, 8):
            check(res[c]["launches"] == 0 and res[c]["dispatches"] == SP_ANN_QUERIES,
                  f"similar-product ANN: {res[c]['launches']} score_topk launches, "
                  f"{res[c]['dispatches']} dispatches for {SP_ANN_QUERIES} queries")
    return {k: train_launches[k] for k in ("gather_gram", "chol_solve")}


def ann_10m(torch, ops, dev) -> dict:
    """Phase 13, the 10M catalog: an ANNScorer over BIG_N normalised
    Gaussian items, the index build timed, ANN dispatches against the
    exact score_topk over the same corpus (CUDA events), BIG_CHECK_ROWS
    rows' shortlists against a float64 replay."""
    import numpy as np

    from predictionio_tpu_torch.ann import ANNScorer, build_index
    from predictionio_tpu_torch.ops.topk import adc_shortlist, rerank_topk

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    t0 = time.perf_counter()
    Vt = torch.randn(BIG_N, BIG_D, generator=g, device=dev)
    Vt /= Vt.norm(dim=1, keepdim=True)
    Qt = torch.randn(max(BIG_BATCHES), BIG_D, generator=g, device=dev)
    Qt /= Qt.norm(dim=1, keepdim=True)
    V, U = Vt.cpu().numpy(), Qt.cpu().numpy()
    del Vt, Qt
    print(f"10M catalog: {BIG_N} x {BIG_D} normalised Gaussian items made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    index = build_index(V, ANN_M, ANN_K, device=dev)
    meta = index.meta
    print(f"10M catalog: index build {meta['build_sec']:.3f} s (Lloyd "
          f"{meta['lloyd_sec']:.3f} s over a {min(BIG_N, 65536)}-row sample, encode "
          f"{meta['encode_sec']:.3f} s); codes {index.code_bytes() / 1e6:.1f} MB, "
          f"V {BIG_N * BIG_D * 4 / 1e9:.2f} GB", flush=True)
    t0 = time.perf_counter()
    scorer = ANNScorer(U, V, index, shortlist=ANN_SHORTLIST, device=dev)
    torch.cuda.synchronize()
    print(f"10M catalog: ANNScorer placed in {time.perf_counter() - t0:.2f} s", flush=True)
    rows = {}
    for B in BIG_BATCHES:
        Q = scorer._U[:B].contiguous()
        ids = torch.arange(B, dtype=torch.int32, device=dev)
        out = (torch.empty(B, BIG_K, device=dev),
               torch.empty(B, BIG_K, device=dev, dtype=torch.int32))

        def ann():
            _, sidx = adc_shortlist(Q, scorer._codebooks, scorer._codesT, ANN_SHORTLIST)
            return rerank_topk(Q, scorer._V, sidx, BIG_K)

        ann_ms, ann_call = cuda_ms(ann, iters=10, warmup=2)
        exact_ms, exact_call = cuda_ms(lambda: ops.score_topk(
            scorer._U, scorer._V, BIG_K, ids=ids, out=out), iters=10, warmup=2)
        bound = (BIG_N * ANN_M + B * ANN_SHORTLIST * BIG_D * 4) / PEAK_HBM_BYTES * 1e3
        exact_bound, exact_by = score_topk_bound_ms(B, BIG_D, BIG_N, BIG_K)
        t0 = time.perf_counter()
        scorer.recommend_batch(np.arange(B), 10)
        dispatch = (time.perf_counter() - t0) * 1e3
        rows[B] = {"ann_ms": ann_ms, "exact_ms": exact_ms, "bound_ms": bound}
        print(f"10M catalog B={B:2d} k={BIG_K} k'={ANN_SHORTLIST}: ANN device ms "
              f"{ann_ms:.4f} (per call {ann_call:.4f}; one whole dispatch, host clock, "
              f"{dispatch:.3f}), bound {bound:.5f} (bytes: codes N*m + the B*k'*d re-rank "
              f"rows); exact score_topk {exact_ms:.4f} (per call {exact_call:.4f}), its "
              f"bound {exact_bound:.5f} ({exact_by})", flush=True)
    # float64 replay of BIG_CHECK_ROWS rows' shortlists, on the card
    Q = scorer._U[:BIG_CHECK_ROWS].contiguous()
    vals, idx = adc_shortlist(Q, scorer._codebooks, scorer._codesT, ANN_SHORTLIST)
    m, K, dsub = index.codebooks.shape
    lut = torch.bmm(Q.double().reshape(-1, m, dsub).transpose(0, 1),
                    scorer._codebooks.double().transpose(1, 2))
    adc = torch.zeros(BIG_CHECK_ROWS, BIG_N, dtype=torch.float64, device=dev)
    for mi in range(m):
        adc += lut[mi][:, scorer._codesT[mi].long()]
    ref = torch.sort(adc, dim=1, descending=True, stable=True)
    kth = ref.values[:, ANN_SHORTLIST - 1:ANN_SHORTLIST]
    got = adc.gather(1, idx.long())
    tol = TOL * max(1.0, float(ref.values[:, 0].abs().max()))
    val_err = float((vals.double() - got).abs().max())
    edge_ok = bool((got >= kth - tol).all())
    differ = sum(len(set(idx[r].tolist()) ^ set(ref.indices[r, :ANN_SHORTLIST].tolist())) // 2
                 for r in range(BIG_CHECK_ROWS))
    print(f"10M catalog: {BIG_CHECK_ROWS} rows' shortlists against the float64 replay: "
          f"scores within {val_err:.3e} (limit {tol:.1e}), every item at or above the "
          f"k'-th float64 score less the limit: {edge_ok}; items swapped at the edge: "
          f"{differ}", flush=True)
    check(val_err <= tol and edge_ok, "10M catalog: shortlists off the float64 replay")
    del adc, scorer
    return rows


def ann_full_width(torch, ops, dev, train, profile: bool = False,
                   check_steps: int = TT_CHECK_STEPS) -> dict:
    """Phase 13: ANN and the two-tower template at full width (see the
    module docstring)."""
    from predictionio_tpu_torch.models.als import RatingsCOO

    t_phase = time.perf_counter()
    if train is None:
        t0 = time.perf_counter()
        coo = RatingsCOO(*synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS), N_USERS, N_ITEMS)
        print(f"phase 5's draws made again in {time.perf_counter() - t0:.1f} s", flush=True)
    else:
        coo = train["coo"]
    launches = twotower_full_width(torch, ops, dev, coo, profile, check_steps)
    launches.update(similar_ann_full_width(torch, ops, dev, coo))
    big = ann_10m(torch, ops, dev)
    wall = time.perf_counter() - t_phase
    print(f"phase 13: {wall:.1f} s wall; launches {launches}", flush=True)
    return {"launches": launches, "big": big, "wall": wall}


# -- phase 14: classification and e2 at full width --------------------------------

#: UCI Covertype's class counts (Spruce/Fir, Lodgepole Pine, Ponderosa Pine,
#: Cottonwood/Willow, Aspen, Douglas-fir, Krummholz): 581,012 rows
COVTYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
#: the classes from low to high on the planted rule (their elevation order)
COVTYPE_ORDER = (3, 2, 5, 4, 1, 0, 6)
COVTYPE_ROWS, COVTYPE_ATTRS = sum(COVTYPE_COUNTS), 54
NB64_TOL = 1e-5     # NB's log tables against a float64 numpy fit, absolute
LR_CPU_TOL = 1e-4   # LR's free run on the card against the port's CPU run, of max |W|
LR_STEP_TOL = 1e-5  # one LR step on the card from the CPU's state, of max |W|: a
                    # step with TF32 products must fail it (3.6e-5 on the H100)
LR_FREE_STEPS = 10  # the free runs are held from here; past it f32 drifts
RF_TOL = 1e-6       # leaf_probs, card against CPU
GINI_TIE = 1e-6     # two picks' float64 Gini within this, relative: a near-tie
LABEL_TIE = 1e-5    # served labels: top two float64 scores within this, relative
RF_CPU_TREES = 4    # trees also grown on the CPU from the same draws
RF_RUN_CPU_TREES = 1  # the whole run's cut, to keep it in its time
SERVE_QUERIES, SERVE_CLIENTS = 1_000, 8
EVAL_EVERY = 10     # the eval's cut: every 10th row (58,102 rows)
CLI_ENTITIES = 20_000
TEXT_DOCS, TEXT_LABELS, TEXT_VOCAB, TEXT_QUERIES = 18_846, 20, 30_000, 500
CAT_POINTS, CAT_POSITIONS = 1_000_000, 10


def synthetic_covertype(n_rows: int = COVTYPE_ROWS, seed: int = 7):
    """A table of UCI Covertype's shape, drawn from ``seed`` (nothing is
    downloaded): 10 non-negative continuous attributes at Covertype's
    ranges (elevation, aspect, slope, the distances, the three hillshades;
    the vertical distance to water shifted by +173 m to be non-negative),
    a one-of-4 wilderness group and a one-of-40 soil group, 54 columns in
    all. Labels come from a planted non-linear rule with noise: the rows
    ranked on it are cut into the 7 classes at Covertype's counts, lowest
    class first in ``COVTYPE_ORDER``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = n_rows
    elev = rng.normal(2960, 280, n).clip(1859, 3858)
    aspect = rng.uniform(0, 360, n)
    slope = rng.gamma(3.0, 4.7, n).clip(0, 66)
    hhyd = rng.gamma(1.3, 210, n).clip(0, 1397)
    vhyd = (rng.normal(46, 58, n) + 173).clip(0, 774)
    hroad = rng.gamma(1.8, 1300, n).clip(0, 7117)
    hs9 = (255 - rng.gamma(2.2, 16, n)).clip(0, 254)
    hsn = (255 - rng.gamma(3.0, 9, n)).clip(0, 254)
    hs3 = rng.normal(143, 38, n).clip(0, 254)
    hfire = rng.gamma(1.7, 1170, n).clip(0, 7173)
    wild = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = np.minimum(rng.zipf(1.4, n) - 1 + rng.integers(0, 8, n), 39)
    X = np.zeros((n, COVTYPE_ATTRS), np.float32)
    X[:, :10] = np.stack([elev, aspect, slope, hhyd, vhyd, hroad, hs9, hsn, hs3,
                          hfire], 1)
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    z = ((elev - 2960) / 280 + 0.35 * np.sin(np.radians(aspect)) * slope / 20
         - 0.25 * (hhyd / 400) * (vhyd > 250) + 0.3 * (wild == 2) - 0.4 * (wild == 3)
         + 0.05 * (soil % 7) + 0.2 * np.cos(hroad / 900) + rng.normal(0, 0.35, n))
    counts = np.round(np.asarray(COVTYPE_COUNTS) * n / COVTYPE_ROWS).astype(int)
    counts[1] += n - counts.sum()
    order = np.argsort(z, kind="stable")
    y = np.empty(n, np.int32)
    start = 0
    for c in COVTYPE_ORDER:
        y[order[start:start + counts[c]]] = c
        start += counts[c]
    return X, y


STEP_TIMES = []  # phase 14's (label, wall s, card busy s or None) of each timed step
PROFILE_STEPS = False  # --profile: take the card's busy time in each timed step


def timed(torch, dev, label: str, fn):
    """Run ``fn`` once and print its wall (host clock). With PROFILE_STEPS
    it runs under torch.profiler and also prints the card's busy time in
    it: the sum of the kernel, copy and memset durations the profiler
    records (CUPTI), and their count. Appends to STEP_TIMES; returns
    (result, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    busy, note = None, ""
    t0 = time.perf_counter()
    if PROFILE_STEPS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            out = fn()
            torch.cuda.synchronize(dev)
    else:
        out = fn()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if PROFILE_STEPS:
        rows = [r for r in prof.key_averages()
                if r.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(r, "is_user_annotation", False)]
        busy = sum(r.self_device_time_total for r in rows) / 1e6
        note = (f" (profiler on), the card busy {busy * 1e3:.2f} ms in "
                f"{sum(r.count for r in rows)} kernels and copies (torch.profiler)")
    STEP_TIMES.append((label, wall, busy))
    print(f"{label}: {wall:.3f} s wall{note}", flush=True)
    return out, wall


def near_tie(scores, rtol: float):
    """Rows whose top two float64 scores lie within ``rtol`` relative."""
    import numpy as np

    top2 = np.sort(scores, 1)[:, -2:]
    return np.abs(top2[:, 1] - top2[:, 0]) <= rtol * np.abs(top2).max(1)


def scores64(kind: str, arrays: dict, X):
    """Float64 scores of ``X`` under a stored ClassificationModel's arrays."""
    import numpy as np

    X = np.asarray(X, np.float64)
    if kind == "nb":
        lt = arrays["log_theta"].astype(np.float64)
        lp = arrays["log_prior"].astype(np.float64)
        if arrays["model_type"][0]:
            Xb = (X > 0).astype(np.float64)
            theta = np.exp(lt)
            log_neg = np.log1p(-np.clip(theta, 1e-12, 1 - 1e-12))
            return Xb @ lt.T + (1.0 - Xb) @ log_neg.T + lp
        return X @ lt.T + lp
    if kind == "lr":
        return X @ arrays["W"].astype(np.float64) + arrays["b"].astype(np.float64)
    feats, thrs = arrays["feats"], arrays["thrs"]
    T, D = feats.shape
    leaf = np.zeros((T, X.shape[0]), np.int64)
    for dep in range(D):
        leaf = leaf * 2 + (X[:, feats[:, dep]].T > thrs[:, dep, None]).astype(np.int64)
    return arrays["leaf_probs"].astype(np.float64)[np.arange(T)[:, None], leaf].mean(0)


def nb_fit64(X, y, C: int, lam: float, bernoulli: bool):
    """The NB smoothing formulas in float64 numpy."""
    import numpy as np

    X = (X > 0).astype(np.float64) if bernoulli else X.astype(np.float64)
    class_count = np.bincount(y, minlength=C).astype(np.float64)
    feat_sum = np.zeros((C, X.shape[1]))
    for c in range(C):
        feat_sum[c] = X[y == c].sum(0)
    log_prior = np.log(class_count + lam) - np.log(class_count.sum() + C * lam)
    if bernoulli:
        return log_prior, np.log(feat_sum + lam) - np.log(class_count[:, None] + 2 * lam)
    return log_prior, (np.log(feat_sum + lam)
                       - np.log(feat_sum.sum(1, keepdims=True) + X.shape[1] * lam))


def lr_loss64(W, b, X, y, reg: float) -> float:
    """The logistic loss in float64 numpy."""
    import numpy as np

    z = X.astype(np.float64) @ W.astype(np.float64) + b.astype(np.float64)
    zmax = z.max(1, keepdims=True)
    lse = np.log(np.exp(z - zmax).sum(1)) + zmax[:, 0]
    return float((lse - z[np.arange(len(y)), y]).mean()
                 + 0.5 * reg * (W.astype(np.float64) ** 2).sum())


def lr_cpu_trace(torch, vg, x, iters: int):
    """``iters`` L-BFGS steps of the port on the CPU from ``x``, keeping
    each step's (point, state); returns (trace, seconds)."""
    from predictionio_tpu_torch.models import lbfgs

    state = lbfgs.lbfgs_init(x)
    trace = []
    t0 = time.perf_counter()
    for _ in range(iters):
        trace.append((x, state))
        x, state, _, _ = lbfgs.lbfgs_step(vg, x, state)
    trace.append((x, state))
    return trace, time.perf_counter() - t0


def lr_card_against_cpu(torch, dev, X, y, C: int, reg: float, W_card, b_card,
                        witness: bool = False) -> dict:
    """Logistic regression at ``reg``, the card against the port's CPU run:
    the CPU runs the template's 100 L-BFGS steps, keeping each step's
    state; the card then takes each step from the CPU's state (the same
    point and memory), and every result must be within LR_STEP_TOL of the
    CPU's next point (of its max |W|). The same steps with TF32 products
    (the f32 guard taken out) are a control that must fail that limit.
    The free runs are held after LR_FREE_STEPS steps; the 100-step free
    runs' gap and float64 losses are printed. ``witness`` also runs the
    CPU's 100 steps on one thread and prints how far they end from the
    run on every core: the drift of two summation orders, no card in it."""
    import numpy as np

    from predictionio_tpu_torch.models import lbfgs, linear

    d = X.shape[1]
    iters = linear.LogisticRegressionParams().iterations
    Xc, yc = torch.from_numpy(X), torch.from_numpy(y.astype(np.int64))
    x0 = torch.zeros(d * C + C)
    threads = torch.get_num_threads()
    trace, t_cpu = lr_cpu_trace(torch, linear.loss_and_grad(Xc, yc, C, reg), x0, iters)
    Xd = torch.as_tensor(X).to(dev)
    yd = torch.as_tensor(y.astype(np.int64)).to(dev)
    vg = linear.loss_and_grad(Xd, yd, C, reg)

    def on_card(st):
        return lbfgs.LBFGSState(st.count, *(getattr(st, f).to(dev) for f in (
            "params", "updates", "diff_params", "diff_updates", "weights")))

    def rel(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref[:d * C]).max())

    def each_step():
        worst, worst_k, ls_steps = 0.0, -1, 0
        t0 = time.perf_counter()
        for k in range(iters):
            xk, sk = trace[k]
            xn, _, _, ls = lbfgs.lbfgs_step(vg, xk.to(dev), on_card(sk))
            err = rel(xn.cpu().numpy(), trace[k + 1][0].numpy())
            ls_steps += ls.count
            if err > worst:
                worst, worst_k = err, k
        return worst, worst_k, ls_steps, time.perf_counter() - t0

    worst, worst_k, ls_steps, t_steps = each_step()
    with tf32_matmuls(torch), mock.patch.object(linear, "full_f32", contextlib.nullcontext):
        tf32_worst, tf32_k, _, _ = each_step()
    W_free, b_free = linear.logreg_train(X, y, linear.LogisticRegressionParams(
        num_classes=C, iterations=LR_FREE_STEPS, reg=reg), device=dev)
    free_err = rel(np.concatenate([W_free.ravel(), b_free]), trace[LR_FREE_STEPS][0].numpy())
    xf = trace[-1][0].numpy()
    W_cpu, b_cpu = xf[:d * C].reshape(d, C), xf[d * C:]
    gap = rel(np.concatenate([W_card.ravel(), b_card]), xf)
    loss_card, loss_cpu = lr_loss64(W_card, b_card, X, y, reg), lr_loss64(W_cpu, b_cpu, X, y, reg)
    print(f"LR reg {reg:g}, card against the CPU: the CPU's {iters} steps on "
          f"{threads} threads {t_cpu:.1f} s; each card step from the CPU's state: worst "
          f"{worst:.3e} of max|W| (step {worst_k}; limit {LR_STEP_TOL}), "
          f"{ls_steps} line-search evaluations, {t_steps:.2f} s; free runs after "
          f"{LR_FREE_STEPS} steps {free_err:.3e} (limit {LR_CPU_TOL}); after "
          f"{iters}: {gap:.3e} apart, float64 loss card {loss_card!r} CPU "
          f"{loss_cpu!r}", flush=True)
    print(f"LR control, which must fail the step limit: each card step with TF32 "
          f"products, worst {tf32_worst:.3e} of max|W| (step {tf32_k}; limit "
          f"{LR_STEP_TOL})", flush=True)
    check(worst <= LR_STEP_TOL, f"an LR step on the card is {worst:.3e} off the CPU's")
    check(tf32_worst > LR_STEP_TOL, "the LR step limit does not tell TF32 steps apart")
    check(free_err <= LR_CPU_TOL, f"LR after {LR_FREE_STEPS} steps {free_err:.3e} off the CPU's")
    check(np.isfinite(loss_card), f"the card's LR loss is {loss_card}")
    out = {"step_err": worst, "tf32_step_err": tf32_worst, "free_err": free_err,
           "gap100": gap, "loss_card": loss_card, "loss_cpu": loss_cpu}
    if witness:
        torch.set_num_threads(1)
        try:
            one, t_one = lr_cpu_trace(torch, linear.loss_and_grad(Xc, yc, C, reg), x0, iters)
        finally:
            torch.set_num_threads(threads)
        x1 = one[-1][0].numpy()
        gap10 = rel(one[LR_FREE_STEPS][0].numpy(), trace[LR_FREE_STEPS][0].numpy())
        gap1 = rel(x1, xf)
        loss_one = lr_loss64(x1[:d * C].reshape(d, C), x1[d * C:], X, y, reg)
        print(f"LR witness, the CPU on 1 thread against {threads} ({t_one:.1f} s): after "
              f"{LR_FREE_STEPS} steps {gap10:.3e} of max|W| apart, after {iters} "
              f"{gap1:.3e}; float64 loss 1 thread {loss_one!r}, {threads} threads "
              f"{loss_cpu!r}", flush=True)
        out.update(thread_gap10=gap10, thread_gap100=gap1, loss_one_thread=loss_one)
    return out


def gini64(X, y, C: int, boot, splits, f: int, t: float) -> float:
    """The float64 Gini score of split (f, t) below the ``splits`` before it."""
    import numpy as np

    leaf = np.zeros(len(y), np.int64)
    for ff, tt in splits:
        leaf = leaf * 2 + (X[:, ff] > tt)
    L = 1 << (len(splits) + 1)
    w = np.asarray(boot, np.float64)
    above = X[:, f] > t
    score = 0.0
    for side in (above, ~above):
        h = np.bincount(leaf[side] * C + y[side], weights=w[side],
                        minlength=L * C).reshape(L, C)
        s = h.sum(1)
        p = h / np.maximum(s, 1e-9)[:, None]
        score += float((s * (1.0 - (p * p).sum(1))).sum())
    return score


def forest_card_against_cpu(X, y, p, model, trees: int = RF_CPU_TREES) -> dict:
    """The card's first ``trees`` trees against the same trees grown on
    the CPU from the same draws: equal splits, except where a level's two
    picks have float64 Gini scores within GINI_TIE relative (the tree
    differs from there on, and its leaves are not compared); leaf_probs
    within RF_TOL."""
    import dataclasses as dc

    import numpy as np

    from predictionio_tpu_torch.models import forest

    boot, keep = forest.forest_draws(X.shape[0], X.shape[1], p)
    q = dc.replace(p, n_trees=trees)
    t0 = time.perf_counter()
    cpu = forest.forest_train_drawn(X, y, q, boot[:trees], keep[:trees], device="cpu")
    t_cpu = time.perf_counter() - t0
    C = int(y.max()) + 1
    ties, worst = [], 0.0
    for t in range(trees):
        splits = []
        for dep in range(p.max_depth):
            a = (int(model.feats[t, dep]), float(model.thrs[t, dep]))
            b = (int(cpu.feats[t, dep]), float(cpu.thrs[t, dep]))
            if a != b:
                ga = gini64(X, y, C, boot[t].numpy(), splits, *a)
                gb = gini64(X, y, C, boot[t].numpy(), splits, *b)
                check(abs(ga - gb) <= GINI_TIE * max(abs(ga), abs(gb)),
                      f"tree {t} level {dep}: the card splits on {a}, the CPU on {b}, "
                      f"float64 Gini {ga!r} against {gb!r}")
                ties.append((t, dep, ga, gb))
                break
            splits.append(a)
        else:
            worst = max(worst, float(np.abs(model.leaf_probs[t] - cpu.leaf_probs[t]).max()))
    print(f"RF card against the CPU from the same draws: {trees} trees on the "
          f"CPU {t_cpu:.1f} s; splits equal in {trees - len(ties)} trees, "
          f"near-ties {ties}; leaf_probs within {worst:.3e} (limit {RF_TOL})", flush=True)
    check(worst <= RF_TOL, f"leaf_probs {worst:.3e} off the CPU's")
    return {"ties": len(ties), "leaf_err": worst}


def serve_classification(dev, storage, iid: str, kind: str, arrays: dict, Xq,
                         label: str) -> dict:
    """``len(Xq)`` POST /queries.json to the port's EngineServer serving
    instance ``iid``; every label must equal the float64 prediction from
    the stored arrays, except on near-ties within LABEL_TIE."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import CLASSIFICATION_FACTORY

    bodies = [json.dumps({f"attr{j}": float(v) for j, v in enumerate(row)})
              for row in Xq]
    with running_server(dev, storage, CLASSIFICATION_FACTORY, iid) as port:
        t0 = time.perf_counter()
        answers = post_all(port, "/queries.json", bodies, SERVE_CLIENTS)
        wall = time.perf_counter() - t0
    check(all(st == 200 for st, _ in answers),
          f"{label}: answers not 200: {[a for a in answers if a[0] != 200][:3]}")
    s = scores64(kind, arrays, Xq)
    want = np.argmax(s, 1)
    got = np.asarray([int(a["label"]) for _, a in answers])
    ties = near_tie(s, LABEL_TIE)
    off = int(((got != want) & ~ties).sum())
    print(f"{label}: {len(bodies)} POST /queries.json from {SERVE_CLIENTS} clients "
          f"{wall:.2f} s ({len(bodies) / wall:.0f} q/s); {int((got == want).sum())} "
          f"labels equal the float64 prediction, {int(ties.sum())} near-ties, "
          f"{off} off", flush=True)
    check(off == 0, f"{label}: {off} served labels off the float64 prediction")
    return {"qps": len(bodies) / wall, "off": off}


def covertype_full_width(torch, dev, home: str, X, y, witness: bool = False) -> dict:
    """Phase 14's classification template on the Covertype-shaped table:
    NB (multinomial and bernoulli), LR (reg 0 and 1e-3) and RF trained
    through the template's algorithms at its defaults, each checked; the
    three instances served; the eval grid serially and distributed."""
    import numpy as np

    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.core.workflow import JAX_CLASSIFICATION_FACTORY
    from predictionio_tpu_torch.models.forest import ForestModel, ForestParams
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.templates.classification import engine as tmpl

    C = int(y.max()) + 1
    print(f"class shares {np.round(np.bincount(y) / len(y) * 100, 2).tolist()} %",
          flush=True)
    attrs = [f"attr{j}" for j in range(COVTYPE_ATTRS)]
    data = tmpl.LabeledData(X, y, attrs)
    storage = Storage(StorageConfig(home=home))
    ctx = WorkflowContext(storage=storage, device=dev)
    out = {}

    def train(label, algo_cls, params):
        algo = algo_cls(params)
        algo.device = dev
        model, wall = timed(torch, dev, f"train {label}", lambda: algo.train(ctx, data))
        s = scores64(model.kind, model.arrays, X)
        acc = float((np.argmax(s, 1) == y).mean())
        print(f"{label}: training accuracy {acc:.4f}", flush=True)
        out[label] = {"wall": wall, "accuracy": acc}
        return algo, model

    models = {}
    for bern in (False, True):
        label = "NB " + ("bernoulli" if bern else "multinomial")
        algo, m = train(label, tmpl.NaiveBayesAlgorithm, tmpl.NBAlgoParams(
            model_type="bernoulli" if bern else "multinomial"))
        lp64, lt64 = nb_fit64(X, y, C, algo.params.lambda_, bern)
        err = max(float(np.abs(m.arrays["log_prior"] - lp64).max()),
                  float(np.abs(m.arrays["log_theta"] - lt64).max()))
        print(f"{label}: log tables within {err:.3e} of float64 (limit {NB64_TOL})",
              flush=True)
        check(err <= NB64_TOL, f"{label} {err:.3e} off float64")
        models[label] = (algo, m)
    for reg in (0.0, 1e-3):
        label = f"LR reg {reg:g}"
        models[label] = train(label, tmpl.LogisticRegressionAlgorithm,
                              tmpl.LRAlgoParams(reg=reg))
    W, b = models["LR reg 0.001"][1].arrays["W"], models["LR reg 0.001"][1].arrays["b"]
    out["lr_cpu"] = lr_card_against_cpu(torch, dev, X, y, C, 1e-3, W, b, witness)
    models["RF"] = train("RF", tmpl.RandomForestAlgorithm, tmpl.RFAlgoParams())
    rp = tmpl.RFAlgoParams()
    fp = ForestParams(n_trees=rp.num_trees, max_depth=rp.max_depth,
                      n_thresholds=rp.n_thresholds, feature_frac=rp.feature_frac,
                      seed=rp.seed)
    a = models["RF"][1].arrays
    out["rf_cpu"] = forest_card_against_cpu(
        X, y, fp, ForestModel(a["feats"], a["thrs"], a["leaf_probs"], C),
        RF_CPU_TREES if witness else RF_RUN_CPU_TREES)

    ds = tmpl.DataSourceParams(app_name="covertype", attrs=attrs)
    rows = np.random.default_rng(SEED + 14).choice(len(y), SERVE_QUERIES, replace=False)
    for label, name in (("NB multinomial", "naive"), ("LR reg 0.001", "lr"), ("RF", "forest")):
        algo, m = models[label]
        iid = write_template_instance(storage, JAX_CLASSIFICATION_FACTORY, name, algo,
                                      m, ds)
        out["serve " + label] = serve_classification(
            dev, storage, iid, m.kind, m.arrays, X[rows], f"served {label}")
    out["eval"] = covertype_eval(torch, dev, home, X[::EVAL_EVERY], y[::EVAL_EVERY],
                                 attrs)
    return out


def covertype_eval(torch, dev, home: str, X, y, attrs) -> dict:
    """``pio eval`` of a DefaultGrid-shaped grid (NB λ 0.5 and 1.0, LR, RF;
    evalK 2) over every EVAL_EVERY-th row, behind a data source whose read
    returns them: serially and distributed, every fold accuracy equal."""
    from predictionio_tpu_torch.controller import (Engine, EngineParams, Evaluation,
                                                   FirstServing, IdentityPreparator)
    from predictionio_tpu_torch.core.workflow import run_evaluation
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.storage import leaderboard as lb
    from predictionio_tpu_torch.templates.classification import engine as tmpl

    data = tmpl.LabeledData(X, y, attrs)
    serial = []  # the serial run's fold accuracies, candidate by candidate

    class TableSource(tmpl.ClassificationDataSource):
        def _read(self, ctx):
            return data

    class FoldAccuracy(tmpl.Accuracy):
        def calculate(self, ctx, eval_data):
            serial.append([super(FoldAccuracy, self).calculate(ctx, [fold])
                           for fold in eval_data])
            return super().calculate(ctx, eval_data)

    class TableEvaluation(Evaluation):
        engine_factory = staticmethod(lambda: Engine(
            TableSource, IdentityPreparator,
            {"naive": tmpl.NaiveBayesAlgorithm, "lr": tmpl.LogisticRegressionAlgorithm,
             "forest": tmpl.RandomForestAlgorithm}, FirstServing))
        metric = FoldAccuracy()

    ds = tmpl.DataSourceParams(app_name="covertype", attrs=attrs, eval_k=2)
    grid = [EngineParams(data_source_params=ds,
                         algorithms_params=[("naive", tmpl.NBAlgoParams(lambda_=lam))])
            for lam in (0.5, 1.0)] + [
        EngineParams(data_source_params=ds, algorithms_params=[("lr", tmpl.LRAlgoParams())]),
        EngineParams(data_source_params=ds,
                     algorithms_params=[("forest", tmpl.RFAlgoParams())])]
    storage = Storage(StorageConfig(home=home))
    docs = {}
    for dist in (False, True):
        (iid, res), _ = timed(torch, dev, f"run_evaluation over {len(y)} rows "
                              f"({'distributed' if dist else 'serial'})",
                              lambda: run_evaluation(TableEvaluation(), grid,
                                                     storage=storage, distributed=dist,
                                                     device=dev))
        docs[dist] = lb.read(home, iid)
    serial = serial[:len(grid)]  # the distributed run's fallback appended more
    dist = [e["foldScores"] for e in sorted(docs[True]["entries"], key=lambda e: e["index"])]
    print(f"eval fold accuracies, serial {serial}; distributed {dist} "
          f"(vmapped {docs[True]['vmapped']}, serial fallback {docs[True]['serial']}, "
          f"dispatches {docs[True]['dispatches']})", flush=True)
    check(serial == dist, "distributed fold accuracies differ from the serial run's")
    check(lb.digest(docs[False]) == lb.digest(docs[True]), "leaderboards differ")
    return {"fold_scores": dist}


def classification_cli(dev, X, y) -> dict:
    """CLI_ENTITIES ``$set`` entities of the template's attr0..2 layout (the
    table's first three attributes and label) through the port's event
    server, then the port's CLI: ``train`` from the template's engine.json
    on the card, and ``deploy`` answering queries equal to the instance
    served in-process."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import CLASSIFICATION_FACTORY, prepare_deploy
    from predictionio_tpu_torch.storage import Storage, StorageConfig

    repo = os.path.dirname(os.path.abspath(__file__))
    engine_dir = os.path.join(repo, "predictionio_tpu_torch", "templates", "classification")
    with open(os.path.join(engine_dir, "engine.json")) as f:
        app_name = json.load(f)["datasource"]["params"]["appName"]
    procs = []
    with tempfile.TemporaryDirectory(prefix="pio_chip_cls_cli_") as home:
        env = dict(os.environ, PIO_HOME=home)

        def cli(*args) -> str:
            t0 = time.perf_counter()
            proc = subprocess.run(CLI + list(args), cwd=repo, env=env,
                                  capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"cli {' '.join(args)} failed "
                                        f"({proc.returncode}):\n{proc.stderr[-4000:]}")
            print(f"-- cli {' '.join(args[:2])}: {time.perf_counter() - t0:.2f} s wall",
                  flush=True)
            return proc.stdout

        def serve(*args):
            log = os.path.join(home, f"{args[0]}.log")
            with open(log, "w") as out:
                proc = subprocess.Popen(CLI + list(args), cwd=repo, env=env,
                                        stdout=out, stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc, log

        try:
            key = re.search(r"Access Key: (\S+)", cli("app", "new", app_name)).group(1)
            es_port = free_port()
            es, es_log = serve("eventserver", "--ip", "127.0.0.1", "--port", str(es_port),
                               "--ingest-batching")
            wait_until(lambda: http_json(es_port, "GET", "/") == (200, {"status": "alive"}),
                       es, es_log, 120)
            events = [{"event": "$set", "entityType": "user", "entityId": f"u{j}",
                       "properties": {"attr0": float(X[j, 0]), "attr1": float(X[j, 1]),
                                      "attr2": float(X[j, 2]), "label": int(y[j])}}
                      for j in range(CLI_ENTITIES)]
            batches = [json.dumps(events[s:s + BATCH_EVENTS])
                       for s in range(0, len(events), BATCH_EVENTS)]
            t0 = time.perf_counter()
            answers = post_all(es_port, "/batch/events.json?accessKey=" + key, batches,
                               BATCH_CLIENTS)
            dt = time.perf_counter() - t0
            ok = sum(it["status"] == 201 for st, body in answers if st == 200 for it in body)
            print(f"{CLI_ENTITIES} $set entities in {len(batches)} batches: {dt:.2f} s, "
                  f"{ok} answered 201", flush=True)
            check(ok == CLI_ENTITIES, f"{CLI_ENTITIES - ok} $set events not 201")
            es.send_signal(2)
            es.wait(timeout=60)
            out = cli("train", "--engine-dir", engine_dir)
            check("Training completed" in out, f"cli train printed {out[-500:]}")
            port = free_port()
            dp, dp_log = serve("deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
                               "--port", str(port))
            wait_until(lambda: http_json(port, "GET", "/")[0] == 200, dp, dp_log, 300)
            rng = np.random.default_rng(SEED + 15)
            qs = [{"attr0": float(a), "attr1": float(b), "attr2": float(c)}
                  for a, b, c in X[rng.choice(len(y), 50, replace=False), :3]]
            t0 = time.perf_counter()
            got = [http_json(port, "POST", "/queries.json", q) for q in qs]
            wall = time.perf_counter() - t0
            check(all(st == 200 for st, _ in got), f"deploy answers {got[:3]}")
            eng = prepare_deploy(CLASSIFICATION_FACTORY,
                                 storage=Storage(StorageConfig(home=home)), device=dev)
            want = [eng.query(q) for q in qs]
            check([a for _, a in got] == want, "deploy's answers differ from in-process")
            print(f"cli deploy: 50 POST /queries.json {wall:.2f} s, equal to instance "
                  f"{eng.instance.id} served in-process; labels "
                  f"{sorted(set(int(a['label']) for a in want))}", flush=True)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    return {"entities": CLI_ENTITIES}


def synthetic_corpus(seed: int = 7):
    """A corpus of 20 Newsgroups' shape: TEXT_DOCS documents over
    TEXT_LABELS labels, 50-400 tokens each from a Zipf vocabulary of
    TEXT_VOCAB words; a label draws 30% of its tokens from 200 words of
    its own."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = np.asarray([f"w{j}" for j in range(TEXT_VOCAB)])
    topics = rng.integers(0, TEXT_VOCAB, size=(TEXT_LABELS, 200))
    labels = rng.integers(0, TEXT_LABELS, TEXT_DOCS)
    docs = []
    for lab, n in zip(labels, rng.integers(50, 401, TEXT_DOCS)):
        ids = np.minimum(rng.zipf(1.1, n) - 1, TEXT_VOCAB - 1)
        own = rng.random(n) < 0.3
        ids[own] = topics[lab, rng.integers(0, 200, int(own.sum()))]
        docs.append(" ".join(vocab[ids].tolist()))
    return docs, labels.astype(np.int32)


def text_full_width(torch, dev, home: str) -> dict:
    """The text template on the synthetic corpus through the event store:
    ``run_train`` of NB and of LR (hashBits 12, ngrams 2; the hashing's
    host time printed apart), TEXT_QUERIES queries served to each, every
    label equal to the float64 prediction from the stored arrays."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import (TEXTCLASSIFICATION_FACTORY,
                                                      prepare_deploy, run_train)
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.templates.textclassification import engine as tmpl

    (docs, labels), _ = timed(torch, dev, f"corpus of {TEXT_DOCS} documents",
                              synthetic_corpus)
    storage = Storage(StorageConfig(home=home))
    app = storage.meta.create_app("Newsgroups")
    storage.events.init_channel(app.id)
    _, _ = timed(torch, dev, f"{TEXT_DOCS} $set documents into the event store",
                 lambda: storage.events.insert_batch(
                     [Event(event="$set", entity_type="doc", entity_id=f"d{j}",
                            properties={"text": t, "label": int(lab)})
                      for j, (t, lab) in enumerate(zip(docs, labels))], app.id))
    hashing = [0.0]
    hash_features = tmpl.hash_features

    def timed_hash(texts, cfg):
        t0 = time.perf_counter()
        out = hash_features(texts, cfg)
        hashing[0] += time.perf_counter() - t0
        return out

    rng = np.random.default_rng(SEED + 16)
    qrows = rng.choice(TEXT_DOCS, TEXT_QUERIES, replace=False)
    cfg = tmpl.HashingConfig(12, 2)
    Xq = hash_features([docs[j] for j in qrows], cfg)
    out = {}
    for name, params in (("naive", {"lambda": 1.0}), ("lr", {})):
        variant = {"id": f"text-{name}", "engineFactory": TEXTCLASSIFICATION_FACTORY,
                   "datasource": {"params": {"appName": "Newsgroups", "hashBits": 12,
                                             "ngrams": 2}},
                   "algorithms": [{"name": name, "params": params}]}
        hashing[0] = 0.0
        with mock.patch.object(tmpl, "hash_features", timed_hash):
            iid, wall = timed(torch, dev, f"text {name}: run_train",
                              lambda: run_train(TEXTCLASSIFICATION_FACTORY, variant=variant,
                                                storage=storage, device=dev))
        model = prepare_deploy(instance_id=iid, storage=storage, device=dev).models[0]
        kind = "nb" if name == "naive" else "lr"
        s = scores64(kind, model.arrays, Xq)
        acc = float((np.argmax(scores64(kind, model.arrays,
                                        hash_features(docs[:2000], cfg)), 1)
                     == labels[:2000]).mean())
        print(f"text {name}: hashing {hashing[0]:.2f} s of the train's {wall:.2f} s "
              f"(host); training accuracy on the first 2,000 documents {acc:.4f}",
              flush=True)
        bodies = [json.dumps({"text": docs[j]}) for j in qrows]
        with running_server(dev, storage, TEXTCLASSIFICATION_FACTORY, iid) as port:
            t0 = time.perf_counter()
            answers = post_all(port, "/queries.json", bodies, SERVE_CLIENTS)
            qwall = time.perf_counter() - t0
        check(all(st == 200 for st, _ in answers), f"text {name}: answers not 200")
        got = np.asarray([int(a["label"]) for _, a in answers])
        ties = near_tie(s, LABEL_TIE)
        off = int(((got != np.argmax(s, 1)) & ~ties).sum())
        print(f"text {name}: {TEXT_QUERIES} POST /queries.json {qwall:.2f} s; {off} labels "
              f"off the float64 prediction, {int(ties.sum())} near-ties", flush=True)
        check(off == 0, f"text {name}: {off} served labels off float64")
        out[name] = {"hash_s": hashing[0], "train_s": wall, "accuracy": acc}
    return out


def markov_full_width(torch, dev, coo=None) -> dict:
    """The Markov chain over ML-20M's items: the consecutive items of each
    user in ``synthetic_ml20m``'s draw order (seed 7) as pairs; counts
    equal to ``np.bincount``, probabilities within 1e-6 of float64,
    ``predict_top_k`` of 100 states a top 10 of a numpy sort."""
    import numpy as np

    from predictionio_tpu_torch.e2.markov import markov_chain_train, transition_counts

    if coo is None:
        users, items, _ = synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS)
    else:  # phase 5's draws, in their order
        users, items = coo.user_idx, coo.item_idx
    order = np.argsort(users, kind="stable")
    u, it = users[order], items[order]
    same = u[1:] == u[:-1]
    pairs = np.stack([it[:-1][same], it[1:][same]], 1)
    S = N_ITEMS
    print(f"Markov: {len(pairs)} pairs over {S} states", flush=True)
    counts, _ = timed(torch, dev, "transition_counts", lambda: transition_counts(pairs, S, dev))
    flat = pairs[:, 0].astype(np.int64) * S + pairs[:, 1]
    ref = torch.from_numpy(np.bincount(flat, minlength=S * S)).to(dev)
    check(torch.equal(counts.view(-1), ref.to(torch.float32)),
          "Markov counts differ from np.bincount")
    total = int(counts.double().sum())
    del counts
    model, _ = timed(torch, dev, "markov_chain_train", lambda: markov_chain_train(pairs, S, dev))
    ref = ref.view(S, S).double()
    p64 = ref / ref.sum(1, keepdim=True).clamp(min=1.0)
    err = float((torch.from_numpy(model.transitions).to(dev).double() - p64).abs().max())
    del ref, p64
    check(err <= 1e-6, f"Markov probabilities {err:.3e} off float64")
    states = np.random.default_rng(SEED + 17).choice(S, 100, replace=False)
    for s in states.tolist():
        # a top 10 by numpy's sort: its probabilities in order, each the
        # row's own, no state twice (which of tied states is free)
        row = model.transitions[s]
        want = np.sort(row)[::-1][:10]
        got = model.predict_top_k(s, 10)
        check([p for _, p in got] == want[want > 0].tolist()
              and all(float(row[i]) == p for i, p in got)
              and len({i for i, _ in got}) == len(got),
              f"predict_top_k({s}) is not numpy's top 10")
    print(f"Markov: counts equal np.bincount ({total} transitions), "
          f"probabilities within {err:.3e} of float64, predict_top_k of 100 states "
          f"a top 10 of numpy's sort", flush=True)
    return {"pairs": int(len(pairs)), "prob_err": err}


def categorical_nb_full_width(torch, dev) -> dict:
    """Categorical NB over CAT_POINTS points x CAT_POSITIONS positions with
    vocabularies of 2-1,000 values (Zipf-skewed): the counts on the card
    equal numpy's, and the trained tables hold them."""
    import math

    import numpy as np

    from predictionio_tpu_torch.e2 import LabeledPoint, categorical_naive_bayes_train
    from predictionio_tpu_torch.e2.naivebayes import count_tables

    rng = np.random.default_rng(SEED + 18)
    sizes = np.unique(np.geomspace(2, 1000, CAT_POSITIONS).astype(int)).tolist()
    sizes += [1000] * (CAT_POSITIONS - len(sizes))
    labels = rng.integers(0, 5, CAT_POINTS)
    ids = [np.minimum(rng.zipf(1.3, CAT_POINTS) - 1 + labels * (v // 7), v - 1)
           for v in sizes]
    cols = [np.asarray([f"p{p}v{j}" for j in range(v)])[i].tolist()
            for p, (v, i) in enumerate(zip(sizes, ids))]
    lab_names = [f"l{c}" for c in labels.tolist()]
    points = [LabeledPoint(lab, feats) for lab, feats in zip(lab_names, zip(*cols))]
    (label_counts, mats), _ = timed(
        torch, dev, f"count_tables ({CAT_POINTS} x {CAT_POSITIONS})",
        lambda: count_tables(labels, ids, 5, sizes, dev))
    check(np.array_equal(label_counts, np.bincount(labels, minlength=5)),
          "label counts differ from numpy")
    for v, i, m in zip(sizes, ids, mats):
        check(np.array_equal(m, np.bincount(labels * v + i, minlength=5 * v).reshape(5, v)),
              f"counts of a {v}-value position differ from numpy")
    model, _ = timed(torch, dev, "categorical_naive_bayes_train",
                     lambda: categorical_naive_bayes_train(points, 1.0, device=dev))
    # a table entry against its count: vocabularies sort the value strings
    p, lab = 3, 2
    vocab = sorted(set(cols[p]))
    j = vocab[len(vocab) // 2]
    cnt = int(np.sum((labels == lab) & (np.asarray(cols[p]) == j)))
    want = math.log((np.float32(cnt) + 1.0) / (np.float32((labels == lab).sum())
                                                 + 1.0 * len(vocab)))
    check(model.likelihoods[f"l{lab}"][p][j] == want, "a likelihood is off its count")
    print(f"categorical NB: vocabularies {sizes}; counts equal numpy's", flush=True)
    return {"sizes": sizes}


def classification_full_width(torch, ops, dev, coo=None, witness: bool = False) -> dict:
    """Phase 14: classification and e2 at full width (see the module
    docstring). No kernel of the port runs here: the counters, zeroed
    first, must read 0. ``witness`` adds LR's one-thread CPU run."""
    t_phase = time.perf_counter()
    reset_counters(ops)
    STEP_TIMES.clear()
    if PROFILE_STEPS:
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA],
                                    acc_events=True):
            torch.cuda.synchronize(dev)
        print(f"torch.profiler start-up {time.perf_counter() - t0:.2f} s (outside every "
              f"step's wall)", flush=True)
    out = {}
    (X, y), _ = timed(torch, dev, f"Covertype-shaped table ({COVTYPE_ROWS} x "
                      f"{COVTYPE_ATTRS}, seed 7)", synthetic_covertype)
    with tempfile.TemporaryDirectory(prefix="pio_chip_cls_") as home:
        out["covertype"] = covertype_full_width(torch, dev, home, X, y, witness)
        out["cli"] = classification_cli(dev, X, y)
        out["text"] = text_full_width(torch, dev, home)
    out["markov"] = markov_full_width(torch, dev, coo)
    out["categorical"] = categorical_nb_full_width(torch, dev)
    launches = read_counters(ops)
    wall = time.perf_counter() - t_phase
    busy = ""
    if PROFILE_STEPS:
        busy = (f"; the card busy {sum(b for _, _, b in STEP_TIMES):.3f} s over the "
                f"{len(STEP_TIMES)} timed steps ({sum(w for _, w, _ in STEP_TIMES):.1f} s "
                f"of their wall; not profiled: the CPU checks, serving, the CLI's "
                f"processes)")
    print(f"phase 14: {wall:.1f} s wall{busy}; kernel launches {launches}", flush=True)
    check(sum(launches.values()) == 0, f"phase 14 launched {launches}")
    out["wall"] = wall
    return out


# -- phase 15: the universal recommender and sequential recommendation ---------

UR_DENSE_MB = 4096     # the card's dense path: C is 26,744² f32, 2.86 GB an event
UR_CHECK_ROWS = 256    # primary rows whose counts and LLR are held on the host
UR_LLR_TOL = 1e-6      # card LLR against the port's CPU f32 LLR, of the term scale 2·n·ln n
UR_USERS, UR_ITEM_QUERIES, UR_COLD, UR_MAX_VIEWS = 1_000, 100, 50, 500
SR_CHECK_STEPS = 3     # the card's first steps, each from the CPU's state
SR_GRAD_TOL = 1e-5     # card loss and gradients against the CPU's, of each leaf's max |g|
SR_STEP_TOL = 1e-4     # parameters after the step against the CPU's, of each leaf's max |value|
SR_SERVED = 500
SR_CLI_EVENTS, SR_CLI_USERS, SR_CLI_ITEMS = 20_000, 1_000, 400


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()


def ur_training_data(users, items, ratings):
    """The universal template's training data from phase 5's draws: a buy
    (the primary event) for each draw rated >= BUY_AT, a view for each
    draw; ids "u<n>" and "i<n>" over the whole ML-20M geometry."""
    from predictionio_tpu_torch.templates.universal import engine as ur
    from predictionio_tpu_torch.utils.bimap import BiMap

    buy = ratings >= BUY_AT
    return ur.TrainingData(
        "URApp", {"buy": (users[buy], items[buy]), "view": (users, items)},
        BiMap.string_int(f"u{i}" for i in range(N_USERS)),
        BiMap.string_int(f"i{j}" for j in range(N_ITEMS)))


def rows_csr(prim, rows):
    """The primary CSR restricted to the items ``rows`` (sorted),
    renumbered 0..len(rows)-1: its co-occurrence with S is C[rows]."""
    import numpy as np

    indptr, idx = prim
    n_users = len(indptr) - 1
    sel = np.isin(idx, rows)
    ent_user = np.repeat(np.arange(n_users), np.diff(indptr))
    sub = np.zeros_like(indptr)
    np.cumsum(np.bincount(ent_user[sel], minlength=n_users), out=sub[1:])
    return sub, np.searchsorted(rows, idx[sel]).astype(np.int32)


def downsampled_csr_of(users, items, keep_users, cap: int, n_users: int, n_b: int):
    """The CSR of ``_downsample_per_user(users, items, cap)`` (seed 0)
    restricted to the users ``keep_users``, computed for those users
    alone: each user keeps the ``cap`` events of lowest random priority,
    the priorities drawn for every event in order, as there."""
    import numpy as np

    from predictionio_tpu_torch.models import cco

    pri = np.random.default_rng(0).random(users.size)
    kept = np.zeros(n_users, bool)
    kept[keep_users] = True
    sel = kept[users]
    us, its, pr = users[sel], items[sel], pri[sel]
    order = np.lexsort((pr, us))
    u_sorted = us[order]
    starts = np.concatenate(([0], np.cumsum(np.bincount(u_sorted, minlength=n_users))))
    within = np.arange(u_sorted.size) - starts[u_sorted]
    keep = order[within < cap]
    return cco._csr_from_pairs(us[keep], its[keep], n_users, n_b)


def host_counts(prim, sec, rows, n_b: int):
    """Rows ``rows`` of C = PᵀS counted on the host from the two CSRs."""
    import numpy as np

    p_indptr, p_idx = prim
    s_indptr, s_idx = sec
    ent_user = np.repeat(np.arange(len(p_indptr) - 1), np.diff(p_indptr))
    sel = np.isin(p_idx, rows)
    us, row_of = ent_user[sel], np.searchsorted(rows, p_idx[sel])
    lens = s_indptr[us + 1] - s_indptr[us]
    rep = np.repeat(np.arange(len(us)), lens)
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    cols = s_idx[s_indptr[us][rep] + within]
    flat = row_of[rep].astype(np.int64) * n_b + cols
    return np.bincount(flat, minlength=len(rows) * n_b).reshape(len(rows), n_b).astype(np.float32)


def llr_lists_agree(got, want, tol: float, threshold: float) -> int:
    """Indicator rows (idx, val) equal up to rounding: values within ``tol``
    position by position where both are finite; an entry finite in one
    and -inf in the other lies within ``tol`` of the threshold; where the
    columns differ, the two are near-tied (within 2·tol) in ``want``, or
    the other's column was cut at ``want``'s last. Returns the swaps."""
    import numpy as np

    (gi, gv), (wi, wv) = got, want
    gf, wf = np.isfinite(gv), np.isfinite(wv)
    both = gf & wf
    check(np.abs(gv[both] - wv[both]).max(initial=0.0) <= tol,
          f"indicator values {np.abs(gv[both] - wv[both]).max():.3e} apart")
    for v in (gv[gf & ~wf], wv[wf & ~gf]):
        check(np.all(np.abs(v - threshold) <= tol), "an indicator past the threshold's rounding")
    swaps = 0
    for r, c in zip(*np.nonzero((gi != wi) & both)):
        where = np.nonzero((wi[r] == gi[r, c]) & wf[r])[0]
        ref = wv[r, where[0]] if where.size else wv[r][wf[r]][-1]
        check(abs(ref - wv[r, c]) <= 2 * tol or abs(ref - gv[r, c]) <= 2 * tol,
              f"row {r}: column {gi[r, c]} for {wi[r, c]}, not a near-tie")
        swaps += 1
    return swaps


def ur_indicators_full_width(torch, dev, td) -> dict:
    """The template's training at ML-20M width: ``URAlgorithm._prepare``,
    then the same ``cco_indicators`` call as ``URAlgorithm.train`` with the
    dense crossover raised to UR_DENSE_MB, its stages' walls printed.
    Checks, on UR_CHECK_ROWS sampled primary rows: their counts against
    both events, computed on the card by ``_cooccurrence`` from the rows'
    primary CSR, equal a host count bitwise (the views' CSR built for the
    rows' buyers alone, as the downsampling keeps them); for the primary
    event (the same space: the diagonal masked) their LLR against the
    port's CPU f32 LLR of the same counts and against float64, and their
    indicator lists against the CPU's."""
    import numpy as np

    from predictionio_tpu_torch.models import cco
    from predictionio_tpu_torch.ops.topk import _order_keys
    from predictionio_tpu_torch.templates.universal.engine import URAlgorithm

    card = card_line()
    t0 = time.perf_counter()
    (primary, user_ids, item_ids, n_items, event_pairs, user_history,
     popularity) = URAlgorithm._prepare(td)
    t_prepare = time.perf_counter() - t0
    n_users = len(user_ids)
    p = cco.CCOParams(max_indicators_per_item=50, llr_threshold=0.0,
                      dense_c_max_mb=UR_DENSE_MB)
    walls = {}
    sync(torch, dev)
    t0 = time.perf_counter()
    ind = cco.cco_indicators(event_pairs[primary], event_pairs, n_users, n_items,
                             {name: n_items for name in event_pairs}, p, device=dev,
                             timings=walls)
    wall = time.perf_counter() - t0
    print(f"UR train at {n_users} x {n_items} ({len(event_pairs[primary][0])} buys, "
          f"{len(event_pairs['view'][0])} views): _prepare {t_prepare:.2f} s; "
          f"cco_indicators {wall:.2f} s wall: downsampling and CSR "
          f"{walls['downsample_csr']:.2f} s (host), slabs {walls['slabs']:.3f} s, products "
          f"{walls['products']:.3f} s, LLR and top-k {walls['llr_topk']:.3f} s (walls, the "
          f"card synchronised at each stage's end) ({card})", flush=True)

    t0 = time.perf_counter()
    cap = p.max_interactions_per_user
    rows = np.sort(np.random.default_rng(SEED + 20).choice(n_items, UR_CHECK_ROWS,
                                                          replace=False))
    prim = cco._csr_from_pairs(*cco._downsample_per_user(*event_pairs[primary], cap),
                               n_users, n_items)
    rc = np.bincount(prim[1], minlength=n_items).astype(np.float32)
    sub = rows_csr(prim, rows)
    buyers = np.nonzero(np.diff(sub[0]))[0]
    secs = {primary: prim,
            "view": downsampled_csr_of(*event_pairs["view"], buyers, cap, n_users, n_items)}
    print(f"UR checks: {UR_CHECK_ROWS} primary rows with {buyers.size} buyers, CSRs "
          f"{time.perf_counter() - t0:.2f} s (host)", flush=True)
    scale = 2.0 * n_users * np.log(n_users)
    out = {"wall": wall, "prepare": t_prepare, **walls}
    card_rows = {}
    for name, sec in secs.items():
        t0 = time.perf_counter()
        Cr = cco._cooccurrence(sub, sec, n_users, UR_CHECK_ROWS, n_items, p.user_chunk, dev)
        card_rows[name] = Cr
        want = host_counts(prim, sec, rows, n_items)
        check(np.array_equal(Cr.cpu().numpy(), want),
              f"{name}: counts of the sampled rows differ from the host's")
        print(f"UR {name}: the {UR_CHECK_ROWS} rows' counts on the card equal the host's "
              f"({time.perf_counter() - t0:.2f} s, {int(want.sum())} co-occurrences)",
              flush=True)
    # the primary event's LLR of those rows: card, the port's CPU, float64
    Cr = card_rows[primary]
    card_llr = cco._llr_block(Cr, torch.as_tensor(rc[rows], device=dev),
                              torch.as_tensor(rc, device=dev), n_users, -np.inf, None)
    Cr = Cr.cpu()
    cpu_llr = cco._llr_block(Cr, torch.from_numpy(rc[rows]), torch.from_numpy(rc),
                             n_users, -np.inf, None)
    got, ref = card_llr.cpu().numpy(), cpu_llr.numpy()
    live = np.isfinite(ref)
    check(np.array_equal(np.isfinite(got), live), "live LLR entries differ")
    err = float(np.abs(got[live] - ref[live]).max()) / scale
    counts = Cr.numpy()
    v64 = cco._llr_values(counts[live], np.broadcast_to(rc[rows][:, None], counts.shape)[live],
                          np.broadcast_to(rc[None, :], counts.shape)[live], n_users)
    gap = np.abs(got[live].astype(np.float64) - v64)
    flips = int(np.sum((got[live] >= 0.0) != (v64 >= 0.0)))
    print(f"UR {primary}: LLR of those rows, card against the port's CPU f32 {err:.3e} of "
          f"2·n·ln n = {scale:.4g} (limit {UR_LLR_TOL}); f32 against float64 _llr_values: "
          f"max gap {gap.max():.4g} ({gap.max() / scale:.3e} of the term scale) over "
          f"{live.sum()} live entries, {flips} on the other side of the 0.0 threshold",
          flush=True)
    check(err <= UR_LLR_TOL, f"card LLR {err:.3e} off the CPU's")
    # the CPU's indicator lists of those rows, the diagonal masked
    cpu_llr[np.arange(len(rows)), rows] = -np.inf
    cpu_llr = torch.where(cpu_llr >= p.llr_threshold, cpu_llr, -torch.inf)
    pos = torch.topk(_order_keys(cpu_llr, torch.arange(n_items)),
                     p.max_indicators_per_item, dim=1).indices
    swaps = llr_lists_agree((ind[primary][0][rows], ind[primary][1][rows]),
                            (pos.numpy(), cpu_llr.gather(1, pos).numpy()),
                            UR_LLR_TOL * scale, p.llr_threshold)
    print(f"UR {primary}: the card's indicator lists of those rows equal the CPU's, "
          f"{swaps} near-tie swaps", flush=True)
    out |= {"llr_err": err, "gap64": float(gap.max()), "flips": flips, "swaps": swaps}
    return out | {"primary": primary, "user_history": user_history,
                  "popularity": popularity, "indicators": ind, "item_ids": item_ids,
                  "user_ids": user_ids, "params": p}


def ur_replay64(model, inverted, hist: dict, boosts, banned, num: int):
    """The float64 host replay of one user query: score_user's sum over the
    inverted indicator lists, the popularity fallback, the bans, then the
    top ``num`` with score > 0 (ties to the lower item)."""
    import numpy as np

    n = len(model.item_ids)
    scores = np.zeros(n, np.float64)
    for name, (indptr, rows, vals) in inverted.items():
        h = np.unique(np.asarray(hist.get(name, []), np.int64))
        if h.size == 0:
            continue
        lo, hi = indptr[h], indptr[h + 1]
        take = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)] or [[]]).astype(np.int64)
        part = np.zeros(n, np.float64)
        np.add.at(part, rows[take], vals[take])
        scores += float(np.float32((boosts or {}).get(name, 1.0))) * part
    if not (scores > 0).any():
        scores = model.popularity.astype(np.float64)
    order = np.lexsort((np.arange(n), -scores))
    keep = [int(i) for i in order if scores[i] > 0 and int(i) not in banned][:num]
    return keep, scores


def invert_indicators(indicators):
    """event → (indptr over history items, indicator rows, values) of the
    finite entries, for the replay."""
    import numpy as np

    out = {}
    for name, (idx, val) in indicators.items():
        fin = np.isfinite(val)
        h, r = idx[fin].astype(np.int64), np.nonzero(fin)[0]
        order = np.argsort(h, kind="stable")
        indptr = np.zeros(idx.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(h, minlength=idx.shape[0]), out=indptr[1:])
        out[name] = (indptr, r[order], val[fin][order].astype(np.float64))
    return out


def ur_serving(dev, storage, fit: dict, views_per_user) -> dict:
    """The UR instance served by the port's EngineServer: UR_USERS user
    queries (a third with eventBoosts, every fifth with a blackList of its
    top three), UR_ITEM_QUERIES item queries and UR_COLD unknown users,
    each against the float64 replay."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import UNIVERSAL_FACTORY
    from predictionio_tpu_torch.templates.universal import engine as ur

    algo = ur.URAlgorithm(ur.URAlgorithmParams())
    algo.device = dev
    model = ur.URModel(fit["indicators"], fit["user_history"], fit["item_ids"],
                       fit["primary"], algo.params, fit["popularity"], device=dev)
    t0 = time.perf_counter()
    iid = write_template_instance(storage, UNIVERSAL_FACTORY, "ur", algo, model,
                                  ur.DataSourceParams(app_name="URApp"))
    t_write = time.perf_counter() - t0
    inverted = invert_indicators(model.indicators)
    inv = model.item_ids.inverse()
    rng = np.random.default_rng(SEED + 21)
    pool = np.nonzero((views_per_user > 0) & (views_per_user <= UR_MAX_VIEWS))[0]
    users = rng.choice(pool, UR_USERS, replace=False)
    queries, refs = [], []
    for j, u in enumerate(users.tolist()):
        hist = model.user_history.get(f"u{u}", {})
        boosts = ({"view": 0.5}, {"buy": 2.0, "view": 0.25})[j % 2] if j % 3 == 0 else None
        banned = set(hist.get(model.primary_event, []))
        q = {"user": f"u{u}", "num": 10}
        if boosts:
            q["eventBoosts"] = boosts
        if j % 5 == 4:
            top, _ = ur_replay64(model, inverted, hist, boosts, banned, 3)
            q["blackList"] = [inv[i] for i in top]
            banned |= set(top)
        queries.append(q)
        refs.append(ur_replay64(model, inverted, hist, boosts, banned, 10))
    items_q = rng.choice(N_ITEMS, UR_ITEM_QUERIES, replace=False)
    for i in items_q.tolist():
        queries.append({"item": f"i{i}", "num": 10})
    pop_order = np.lexsort((np.arange(N_ITEMS), -model.popularity))
    for c in range(UR_COLD):
        q = {"user": f"cold{c}", "num": 10}
        if c % 2:
            q["blackList"] = [inv[int(i)] for i in pop_order[:c % 7]]
        queries.append(q)
    lat, answers = [], []
    t_load = time.perf_counter()
    with running_server(dev, storage, UNIVERSAL_FACTORY, iid) as port:
        t_load = time.perf_counter() - t_load
        for q in queries:
            t0 = time.perf_counter()
            st, body = http_json(port, "POST", "/queries.json", q)
            lat.append(time.perf_counter() - t0)
            check(st == 200, f"query {q} answered {st}: {body}")
            answers.append(body["itemScores"])
    for q, a, (keep, scores) in zip(queries, answers, refs):
        check(ranked_agrees(a, keep, [scores[i] for i in keep],
                            lambda it: scores[model.item_ids[it]],
                            lambda it: model.item_ids[it] not in
                            set(model.user_history.get(q["user"], {}).get("buy", []))
                            | {model.item_ids[b] for b in q.get("blackList", [])}),
              f"{q}: {a[:3]} is not the float64 replay's {keep[:3]}")
    idx, val = model.indicators[model.primary_event]
    for i, a in zip(items_q.tolist(), answers[UR_USERS:UR_USERS + UR_ITEM_QUERIES]):
        want = [{"item": inv[int(j)], "score": float(v)}
                for j, v in zip(idx[i], val[i]) if np.isfinite(v)][:10]
        check(a == want, f"item query i{i}: {a[:2]} is not its indicator list")
    for q, a in zip(queries[-UR_COLD:], answers[-UR_COLD:]):
        banned = set(q.get("blackList", []))
        want = [inv[int(i)] for i in pop_order if inv[int(i)] not in banned][:10]
        check([s["item"] for s in a] == want, f"cold {q}: not the popularity order")
    p50 = float(np.percentile(lat[:UR_USERS], 50)) * 1e3
    boosted = sum("eventBoosts" in q for q in queries)
    print(f"UR served: {UR_USERS} user queries ({boosted} with eventBoosts, "
          f"{sum('blackList' in q for q in queries[:UR_USERS])} with a blackList), "
          f"{UR_ITEM_QUERIES} item queries and {UR_COLD} cold users, every answer on "
          f"the float64 replay up to near-ties within {TOL} relative; user query p50 "
          f"{p50:.3f} ms (sequential HTTP); instance written in {t_write:.2f} s, loaded "
          f"in {t_load:.2f} s ({card_line()})", flush=True)
    return {"p50_ms": p50, "write_s": t_write, "load_s": t_load}


def seqrec_sequences(users, items):
    """Phase 5's draws as per-user sequences in draw order (1-based item
    ids), each cut to its last seq_len + 1 items — all that
    make_training_batches keeps — and the raw histories' users."""
    import numpy as np

    order = np.argsort(users, kind="stable")
    u, it = users[order], items[order] + 1
    bounds = np.concatenate(([0], np.nonzero(np.diff(u))[0] + 1, [u.size]))
    keep = 65
    seqs = [it[max(lo, hi - keep):hi].tolist() for lo, hi in zip(bounds[:-1], bounds[1:])]
    return seqs


def seqrec_switch_masks(pre_ref, pre_got, xb, paths, tol: float):
    """What a switched ReLU reaches in one SeqRec step, and the switches.

    ``pre_*`` are each block's (B, S, 4d) input to its ReLU in the two
    runs of the step, ``xb`` the batch's item ids. A unit whose input lies
    within rounding of 0 can switch between two summation orders: its
    output is about 0 either way, but its gradient jumps between 0 and
    the full upstream value, and the jump flows to every leaf below it:
    the block's own leaves but its ``w2`` and ``b2``, every earlier
    block, the position table and the item table's rows of the switched
    sequences. Checks that every switched input is within ``tol`` of 0
    (of the layer's max |input|). Returns ({path: index to leave out},
    the number of switched units)."""
    import numpy as np

    masks, flips = {}, 0
    for blk, (a, g) in enumerate(zip(pre_ref, pre_got)):
        switched = (a > 0) != (g > 0)
        if not switched.any():
            continue
        flips += int(switched.sum())
        near = np.abs(a[switched]).max() / max(float(np.abs(a).max()), 1e-30)
        check(near <= tol, f"a ReLU of block {blk} switched at {near:.3e} of its "
                           f"layer's max |input|: not a rounding near-tie")
        rows = np.unique(xb[np.nonzero(switched.any(axis=2))[0]])
        for path in paths:
            if path == ("item_emb",):
                masks[path] = np.union1d(masks.get(path, rows), rows)
            elif path == ("pos_emb",) or (path[0] == "blocks" and (
                    int(path[1]) < blk or (int(path[1]) == blk
                                           and path[2] not in ("w2", "b2")))):
                masks[path] = slice(None)
    return masks, flips


def seqrec_step_check(torch, dev, X, Y, params0, hp) -> dict:
    """The card's first SR_CHECK_STEPS steps, each taken from the CPU's
    state (parameters, Adam moments and count) before it, against the
    CPU's step from that state: the loss and every gradient within
    SR_GRAD_TOL (of the leaf's max |g|), the parameters after the step
    within SR_STEP_TOL (of the leaf's max |value|), the entries a ReLU
    switched between the two runs reaches left out and the switches
    counted (``seqrec_switch_masks``). Adam divides each gradient by its
    root mean square, so a step carries the gradients' rounding further
    than the gradients do; a float64 step from the same state, on the
    card, shows how far each f32 step is from the exact one. A control
    takes step 0 again with TF32 products, after the checked steps, and
    must fail the gradient check."""
    import numpy as np

    from predictionio_tpu_torch.models import seq_rec as sr
    from predictionio_tpu_torch.utils.device import full_f32

    cpu = sr.SeqRecNet(params0, hp, "cpu")
    cpu_opt = sr.Adam(cpu.leaves(), hp.lr)

    def snapshot():
        return ([t.detach().clone() for t in cpu.leaves()], [t.clone() for t in cpu_opt.mu],
                [t.clone() for t in cpu_opt.nu], cpu_opt.count)

    def on_card(state, dtype):
        leaves, mu, nu, count = state
        net = sr.SeqRecNet(params0, hp, dev).to(dtype)
        opt = sr.Adam(net.leaves(), hp.lr)
        with torch.no_grad():
            for dst, src in ((net.leaves(), leaves), (opt.mu, mu), (opt.nu, nu)):
                for a, b in zip(dst, src):
                    a.copy_(b)
        opt.count = count
        return net, opt

    def grads(net, b, f32=True):
        """(loss, gradients, each block's ReLU input as numpy)."""
        xb = torch.as_tensor(X[b].astype(np.int64), device=net.leaf("item_emb").device)
        yb = torch.as_tensor(Y[b].astype(np.int64), device=xb.device)
        pre, relu = [], torch.relu

        def recording_relu(x):
            pre.append(x.detach().cpu().numpy())
            return relu(x)

        with (full_f32() if f32 else contextlib.nullcontext()), \
                mock.patch.object(torch, "relu", recording_relu):
            loss = sr._loss(net, xb, yb)
            return loss.detach(), torch.autograd.grad(loss, net.leaves()), pre

    def errs(got, want, masks=None):
        out = []
        for path, a, b in zip(cpu.paths, got, want):
            d = (a.detach().cpu().double() - b.detach().cpu().double()).abs()
            scale = max(float(b.detach().abs().max()), 1e-30)
            if masks and path in masks:
                d[masks[path]] = 0.0
            out.append(float(d.max()) / scale)
        return out

    def worst(e):
        return max(zip(e, ("/".join(path) for path in cpu.paths)))

    worst_g, worst_l, worst_cc, worst_64 = 0.0, 0.0, 0.0, (0.0, 0.0)
    switches = []
    first = snapshot()
    g_first = None
    for b in range(SR_CHECK_STEPS):
        state = snapshot()
        card, card_opt = on_card(state, torch.float32)
        lc, gc, pre_c = grads(card, b)
        l0, g0, pre_0 = grads(cpu, b)
        if b == 0:
            g_first = g0
        masks, flips = seqrec_switch_masks(pre_0, pre_c, X[b], cpu.paths, SR_GRAD_TOL)
        switches.append(flips)
        eg = errs(gc, g0, masks)
        worst_l = max(worst_l, abs(float(lc) - float(l0)) / abs(float(l0)))
        worst_g = max(worst_g, max(eg))
        # the float64 step from the same state, on the card
        net64, opt64 = on_card(state, torch.float64)
        _, g64, _ = grads(net64, b)
        opt64.step(list(g64))
        card_opt.step(list(gc))
        cpu_opt.step(list(g0))
        e_card = errs(card.leaves(), net64.leaves(), masks)
        e_cpu = errs(cpu.leaves(), net64.leaves(), masks)
        e_cc = errs(card.leaves(), cpu.leaves(), masks)
        worst_64 = (max(worst_64[0], max(e_card)), max(worst_64[1], max(e_cpu)))
        worst_cc = max(worst_cc, max(e_cc))
        print(f"SeqRec step {b}: {flips} switched ReLUs ({len(masks)} leaves masked in part "
              f"or whole); gradients card against CPU worst {worst(eg)[0]:.3e} "
              f"({worst(eg)[1]}); after the step against float64: card worst "
              f"{worst(e_card)[0]:.3e} ({worst(e_card)[1]}), CPU worst {worst(e_cpu)[0]:.3e} "
              f"({worst(e_cpu)[1]}); card against CPU {max(e_cc):.3e}", flush=True)
        del net64, opt64, g64, card, card_opt
    # the control: step 0 again with TF32 products
    card, _ = on_card(first, torch.float32)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        _, gt, _ = grads(card, 0, f32=False)
    finally:
        torch.set_float32_matmul_precision(prev)
    control = max(errs(gt, g_first))
    print(f"SeqRec step check, {SR_CHECK_STEPS} card steps each from the CPU's state: "
          f"loss {worst_l:.3e} relative, gradients {worst_g:.3e} of each leaf's max |g| "
          f"(limit {SR_GRAD_TOL}); parameters after the step {worst_cc:.3e} of each leaf's "
          f"max |value| (limit {SR_STEP_TOL}), against the float64 step card "
          f"{worst_64[0]:.3e} and CPU {worst_64[1]:.3e}; switched ReLUs by step "
          f"{switches}; TF32 control gradients {control:.3e} (must exceed {SR_GRAD_TOL}) "
          f"({card_line()})", flush=True)
    check(worst_l <= SR_GRAD_TOL and worst_g <= SR_GRAD_TOL,
          f"card gradients {worst_g:.3e} (loss {worst_l:.3e}) off the CPU's")
    check(worst_cc <= SR_STEP_TOL, f"card step {worst_cc:.3e} off the CPU's")
    check(control > SR_GRAD_TOL, f"the TF32 control passed the gradient check ({control:.3e})")
    return {"grad_err": worst_g, "loss_err": worst_l, "step_err": worst_cc,
            "step_card_64": worst_64[0], "step_cpu_64": worst_64[1], "switches": switches,
            "tf32_control": control}


def seqrec_profile(torch, dev, X, Y, params0, hp, n: int = 20) -> None:
    """``n`` training steps under torch.profiler after two warm ones: the
    wall, the card's busy time (kernels, copies and memsets) and its
    count."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.models import seq_rec as sr
    from predictionio_tpu_torch.utils.device import full_f32

    net = sr.SeqRecNet(params0, hp, dev)
    opt = sr.Adam(net.leaves(), hp.lr)
    Xd = torch.as_tensor(X[:n].astype(np.int64), device=dev)
    Yd = torch.as_tensor(Y[:n].astype(np.int64), device=dev)
    with full_f32():
        sr.train_steps(net, opt, Xd[:2], Yd[:2])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            sync(torch, dev)
            t0 = time.perf_counter()
            sr.train_steps(net, opt, Xd, Yd)
            sync(torch, dev)
            wall = time.perf_counter() - t0
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(r, "is_user_annotation", False)]
    busy = sum(r.self_device_time_total for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:5]
    print(f"SeqRec profiled: {n} steps {wall:.3f} s wall (profiler on), the card busy "
          f"{busy:.3f} s in {sum(r.count for r in rows)} kernels and copies, "
          f"{busy / wall:.1%} of the wall (torch.profiler); the largest: " + "; ".join(
              f"{r.key[:60]} {r.self_device_time_total / 1e3:.1f} ms" for r in top)
          + f" ({card_line()})", flush=True)


def seqrec_full_width(torch, dev, storage, users, items) -> dict:
    """Sequential recommendation at full width: phase 5's draws as per-user
    sequences, the template's engine.json widths, one epoch on the card,
    the step check, and SR_SERVED history queries through the port's
    EngineServer against the port's CPU scores."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import SEQUENTIALREC_FACTORY
    from predictionio_tpu_torch.models import seq_rec as sr
    from predictionio_tpu_torch.templates.sequentialrec import engine as se
    from predictionio_tpu_torch.utils.bimap import BiMap

    t0 = time.perf_counter()
    seqs = seqrec_sequences(users, items)
    ap = se.SeqRecAlgorithmParams(epochs=1)
    hp = sr.SeqRecParams(hidden=ap.hidden, num_blocks=ap.num_blocks, num_heads=ap.num_heads,
                         seq_len=ap.seq_len, epochs=ap.epochs, lr=ap.lr,
                         batch_size=ap.batch_size, seed=ap.seed)
    X, Y = sr.make_training_batches(seqs, hp, seed=hp.seed)
    t_batches = time.perf_counter() - t0
    params0 = sr.init_params(N_ITEMS, hp)
    t0 = time.perf_counter()
    check_out = seqrec_step_check(torch, dev, X, Y, params0, hp)
    print(f"SeqRec step check {time.perf_counter() - t0:.2f} s", flush=True)
    sync(torch, dev)
    t0 = time.perf_counter()
    params, losses = sr.seq_rec_train(seqs, N_ITEMS, hp, device=dev)
    wall = time.perf_counter() - t0
    steps = X.shape[0]
    check(np.isfinite(losses).all() and losses.shape == (1,), f"losses {losses}")
    if PROFILE_STEPS:
        seqrec_profile(torch, dev, X, Y, params0, hp)
    print(f"SeqRec train: {len(seqs)} sequences, {steps} steps of {hp.batch_size} x "
          f"{hp.seq_len} (one epoch; the template's 20 cut to 1), sequences and batches "
          f"{t_batches:.2f} s (host), train {wall:.2f} s wall, {steps / wall:.1f} steps/s, "
          f"loss {float(losses[0]):.4f} ({card_line()})", flush=True)

    item_ids = BiMap.string_int(f"i{j}" for j in range(N_ITEMS))
    model = se.SeqRecModel(params, item_ids, "SeqApp", hp, ap, losses, device=dev)
    algo = se.SeqRecAlgorithm(ap)
    algo.device = dev
    iid = write_template_instance(storage, SEQUENTIALREC_FACTORY, "seqrec", algo, model,
                                  se.DataSourceParams(app_name="SeqApp"))
    cpu = sr.seq_rec_params_from_jax(params, hp)
    rng = np.random.default_rng(SEED + 22)
    picks = rng.choice(len(seqs), SR_SERVED, replace=False)
    queries = [{"history": [f"i{j - 1}" for j in seqs[k][-int(rng.integers(1, 65)):]],
                "num": 10} for k in picks.tolist()]
    lat, answers = [], []
    with running_server(dev, storage, SEQUENTIALREC_FACTORY, iid) as port:
        for q in queries:
            t0 = time.perf_counter()
            st, body = http_json(port, "POST", "/queries.json", q)
            lat.append(time.perf_counter() - t0)
            check(st == 200, f"history query answered {st}: {body}")
            answers.append(body["itemScores"])
    for q, a in zip(queries, answers):
        s = sr.seq_rec_scores(cpu, [item_ids[i] + 1 for i in q["history"]], hp).astype(np.float64)
        top = np.lexsort((np.arange(s.size), -s))[:10]
        check(ranked_agrees(a, [f"i{j - 1}" for j in top], [s[j] for j in top],
                            lambda it: s[item_ids[it] + 1], lambda it: True),
              f"history query: {a[:3]} is not the CPU's top 10")
    p50 = float(np.percentile(lat, 50)) * 1e3
    print(f"SeqRec served: {SR_SERVED} history queries, every top 10 the port's CPU "
          f"scores' up to near-ties within {TOL} relative; p50 {p50:.3f} ms "
          f"(sequential HTTP) ({card_line()})", flush=True)
    return check_out | {"steps_per_s": steps / wall, "train_s": wall, "steps": steps,
                        "p50_ms": p50}


def ur_seqrec_cli(dev) -> dict:
    """A small app of SR_CLI_EVENTS buy and view events through the port's
    event server in batches of 50; ``train`` from each template's
    engine.json, ``deploy``, 50 queries to each instance answered as the
    same instance in-process answers (with live-history ``user`` queries
    for the sequential template); ``eval`` of UREvaluation with
    DefaultGrid, MAP@10 and MAP@1 printed."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import (SEQUENTIALREC_FACTORY,
                                                      UNIVERSAL_FACTORY, prepare_deploy)
    from predictionio_tpu_torch.storage import Storage, StorageConfig

    repo = os.path.dirname(os.path.abspath(__file__))
    tpl = os.path.join(repo, "predictionio_tpu_torch", "templates")
    dirs = {"ur": os.path.join(tpl, "universal"), "sr": os.path.join(tpl, "sequentialrec")}
    with open(os.path.join(dirs["ur"], "engine.json")) as f:
        app_name = json.load(f)["datasource"]["params"]["appName"]
    procs = []
    with tempfile.TemporaryDirectory(prefix="pio_chip_ur_cli_") as home:
        env = dict(os.environ, PIO_HOME=home)

        def cli(*args, extra_env=None) -> str:
            t0 = time.perf_counter()
            proc = subprocess.run(CLI + list(args), cwd=repo, env=dict(env, **(extra_env or {})),
                                  capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"cli {' '.join(args)} failed "
                                        f"({proc.returncode}):\n{proc.stderr[-4000:]}")
            print(f"-- cli {' '.join(args[:3])}: {time.perf_counter() - t0:.2f} s wall",
                  flush=True)
            return proc.stdout

        def serve(*args):
            log = os.path.join(home, f"{args[0]}_{len(procs)}.log")
            with open(log, "w") as out:
                proc = subprocess.Popen(CLI + list(args), cwd=repo, env=env,
                                        stdout=out, stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc, log

        try:
            key = re.search(r"Access Key: (\S+)", cli("app", "new", app_name)).group(1)
            es_port = free_port()
            es, es_log = serve("eventserver", "--ip", "127.0.0.1", "--port", str(es_port),
                               "--ingest-batching")
            wait_until(lambda: http_json(es_port, "GET", "/") == (200, {"status": "alive"}),
                       es, es_log, 120)
            users, items, ratings = synthetic_ml20m(SR_CLI_EVENTS, SR_CLI_USERS, SR_CLI_ITEMS,
                                                    seed=SEED + 23)
            events = [{"event": "buy" if r >= BUY_AT else "view", "entityType": "user",
                       "entityId": f"u{u}", "targetEntityType": "item",
                       "targetEntityId": f"i{i}",
                       "eventTime": f"2026-01-01T{j // 3600:02d}:{j // 60 % 60:02d}:"
                                    f"{j % 60:02d}.000Z"}
                      for j, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(),
                                                        ratings.tolist()))]
            batches = [json.dumps(events[s:s + BATCH_EVENTS])
                       for s in range(0, len(events), BATCH_EVENTS)]
            t0 = time.perf_counter()
            answers = post_all(es_port, "/batch/events.json?accessKey=" + key, batches,
                               BATCH_CLIENTS)
            ok = sum(it["status"] == 201 for st, body in answers if st == 200 for it in body)
            print(f"{SR_CLI_EVENTS} buy and view events in {len(batches)} batches: "
                  f"{time.perf_counter() - t0:.2f} s, {ok} answered 201", flush=True)
            check(ok == SR_CLI_EVENTS, f"{SR_CLI_EVENTS - ok} events not 201")
            es.send_signal(2)
            es.wait(timeout=60)
            t0 = time.perf_counter()
            trains = {name: subprocess.Popen(
                CLI + ["train", "--engine-dir", dirs[name], "--device", dev.type], cwd=repo,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for name in dirs}
            for name, proc in trains.items():
                out, err = proc.communicate(timeout=600)
                check(proc.returncode == 0 and "Training completed" in out,
                      f"cli train {name} failed ({proc.returncode}):\n{err[-4000:]}")
            print(f"-- cli train of both templates side by side: "
                  f"{time.perf_counter() - t0:.2f} s wall", flush=True)
            # eval beside the deploys: it trains its own candidates
            mod = "predictionio_tpu_torch.templates.universal.engine"
            res = os.path.join(home, "ur_eval.json")
            t_eval = time.perf_counter()
            ev = subprocess.Popen(
                CLI + ["eval", f"{mod}:UREvaluation", f"{mod}:DefaultGrid", "--engine-dir",
                       dirs["ur"], "--output", res, "--device", dev.type], cwd=repo,
                env=dict(env, PIO_EVAL_APP_NAME=app_name), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            procs.append(ev)
            ports = {name: free_port() for name in dirs}
            servers = {name: serve("deploy", "--engine-dir", dirs[name], "--ip", "127.0.0.1",
                                   "--port", str(ports[name]), "--device", dev.type)
                       for name in dirs}
            rng = np.random.default_rng(SEED + 24)
            us = [f"u{u}" for u in rng.choice(np.unique(users), 40, replace=False)]
            its = [f"i{i}" for i in rng.choice(np.unique(items), 10, replace=False)]
            qs = {"ur": [{"user": u, "num": 10, **({"eventBoosts": {"view": 0.5}} if j % 3 == 0
                                                    else {})} for j, u in enumerate(us)]
                  + [{"item": i, "num": 5} for i in its],
                  "sr": [{"user": u, "num": 10} for u in us[:25]]
                  + [{"history": [f"i{i}" for i in rng.choice(SR_CLI_ITEMS, 8)], "num": 10}
                     for _ in range(25)]}
            storage = Storage(StorageConfig(home=home))
            for name, factory in (("ur", UNIVERSAL_FACTORY), ("sr", SEQUENTIALREC_FACTORY)):
                proc, log = servers[name]
                wait_until(lambda: http_json(ports[name], "GET", "/")[0] == 200, proc, log, 300)
                got = [http_json(ports[name], "POST", "/queries.json", q) for q in qs[name]]
                check(all(st == 200 for st, _ in got), f"{name} deploy answers {got[:3]}")
                eng = prepare_deploy(factory, storage=storage, device=dev)
                want = [eng.query(q) for q in qs[name]]
                check([a for _, a in got] == want, f"{name}: deploy's answers differ "
                                                   "from in-process")
                check(all(a["itemScores"] for q, a in zip(qs[name], want) if "item" not in q),
                      f"{name}: an empty answer to a user or history query")
                print(f"cli deploy {name}: 50 POST /queries.json equal to instance "
                      f"{eng.instance.id} served in-process", flush=True)
            out, err = ev.communicate(timeout=600)
            check(ev.returncode == 0, f"cli eval failed ({ev.returncode}):\n{err[-4000:]}")
            print(f"-- cli eval UREvaluation DefaultGrid (beside the deploys): "
                  f"{time.perf_counter() - t_eval:.2f} s wall", flush=True)
            with open(res) as f:
                doc = json.load(f)
            maps = [(c["engineParams"]["algorithmsParams"][0]["params"]["llr_threshold"],
                     c["score"], c["otherScores"][0]) for c in doc["candidates"]]
            check(len(maps) == 2 and all(np.isfinite(m) for _, *ms in maps for m in ms),
                  f"eval candidates {maps}")
            print("cli eval UREvaluation/DefaultGrid: " + "; ".join(
                f"llrThreshold {t}: MAP@10 {m10:.6f} MAP@1 {m1:.6f}" for t, m10, m1 in maps),
                flush=True)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    return {"maps": maps}


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def universal_sequential_full_width(torch, ops, dev, coo=None, cli: bool = True) -> dict:
    """Phase 15: the universal recommender and sequential recommendation
    at full width (see the module docstring); ``cli`` adds the CLI round
    trip. No kernel of the port runs here: the counters, zeroed first,
    must read 0."""
    import numpy as np

    t_phase = time.perf_counter()
    reset_counters(ops)
    if coo is None:
        users, items, ratings = synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS)
    else:  # phase 5's draws, in their order
        users, items, ratings = coo.user_idx, coo.item_idx, coo.rating
    out = {}
    with tempfile.TemporaryDirectory(prefix="pio_chip_ur_") as home:
        from predictionio_tpu_torch.storage import Storage, StorageConfig

        storage = Storage(StorageConfig(home=home))
        fit = ur_indicators_full_width(torch, dev, ur_training_data(users, items, ratings))
        out["ur"] = {k: v for k, v in fit.items() if isinstance(v, (int, float, dict))
                     and k not in ("indicators", "user_history")}
        out["ur_serving"] = ur_serving(dev, storage, fit,
                                       np.bincount(users, minlength=N_USERS))
        del fit
        out["seqrec"] = seqrec_full_width(torch, dev, storage, users, items)
    if cli:
        t0 = time.perf_counter()
        out["cli"] = ur_seqrec_cli(dev)
        print(f"UR and SeqRec through the CLI: {time.perf_counter() - t0:.1f} s", flush=True)
    launches = read_counters(ops)
    wall = time.perf_counter() - t_phase
    print(f"phase 15: {wall:.1f} s wall; kernel launches {launches} ({card_line()})",
          flush=True)
    check(sum(launches.values()) == 0, f"phase 15 launched {launches}")
    out["wall"] = wall
    out["launches"] = launches
    return out


# phase 16: the EVENTLOG backend at ML-20M width
EVENTLOG_DRAWS = N_RATINGS          # phase 5's draws as `rate` events (--eventlog)
EVENTLOG_RUN_DRAWS = 1_000_000      # the whole run's cut, to keep it in its time
EVENTLOG_CHUNK_LINES = 48_000       # ~8 MB of NDJSON a chunk, the size `pio import` reads
EVENTLOG_MORE = 100_000             # events appended after the snapshot: a delta read
EVENTLOG_IMPORT = 1_000_000         # lines of the `pio import` / `pio export` round trip
                                    # (at most a quarter of the phase's draws)
EVENTLOG_QUERIES = 200
EVENTLOG_T0 = 1_577_836_800         # 2020-01-01T00:00:00Z, one eventTime a second
RATING_TEXT = [repr(k / 2) for k in range(11)]


def ndjson_chunk(task) -> bytes:
    """NDJSON `rate` lines of draws ``lo ...``: one eventTime a second from
    EVENTLOG_T0 (a worker process builds them while the store appends)."""
    import numpy as np

    lo, users, items, halves = task
    times = np.datetime_as_string(
        np.datetime64(EVENTLOG_T0, "s") + np.arange(lo, lo + len(users)), unit="s")
    return "".join([
        f'{{"event":"rate","entityType":"user","entityId":"u{u}",'
        f'"targetEntityType":"item","targetEntityId":"i{i}",'
        f'"properties":{{"rating":{RATING_TEXT[r]}}},"eventTime":"{t}Z"}}\n'
        for u, i, r, t in zip(users.tolist(), items.tolist(), halves.tolist(),
                              times.tolist())]).encode()


def ndjson_chunks(users, items, ratings, first_time: int):
    """(lo, n, bytes) of every chunk in order, built by a pool of worker
    processes at most 16 chunks ahead of the consumer."""
    import multiprocessing

    import numpy as np
    from concurrent.futures import ProcessPoolExecutor

    halves = np.rint(np.asarray(ratings) * 2).astype(np.int64)
    starts = range(0, len(users), EVENTLOG_CHUNK_LINES)
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                             multiprocessing.get_context("spawn")) as pool:
        ahead = collections.deque()
        for lo in starts:
            hi = lo + EVENTLOG_CHUNK_LINES
            ahead.append((lo, min(hi, len(users)), pool.submit(
                ndjson_chunk, (first_time + lo, users[lo:hi], items[lo:hi],
                               halves[lo:hi]))))
            if len(ahead) >= 16:
                lo0, hi0, fut = ahead.popleft()
                yield lo0, hi0 - lo0, fut.result()
        while ahead:
            lo0, hi0, fut = ahead.popleft()
            yield lo0, hi0 - lo0, fut.result()


def first_seen(keys):
    """(vocabulary in first-seen order, each key's index in it) in numpy."""
    import numpy as np

    uniq, first = np.unique(keys, return_index=True)
    vocab = uniq[np.argsort(first, kind="stable")]
    lut = np.zeros(int(uniq.max()) + 1, np.int32)
    lut[vocab] = np.arange(len(vocab), dtype=np.int32)
    return vocab, lut[keys]


def bimap_keys(bimap) -> list:
    keys = [None] * len(bimap)
    for k, v in bimap.to_dict().items():
        keys[v] = k
    return keys


def run_cli(cli, argv) -> tuple:
    """One verb of the port's CLI in this process: (exit code, stdout)."""
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(list(argv))
        code = 0
    except SystemExit as e:
        code = e.code or 0
    print(f"-- cli {' '.join(argv[:2])}: exit {code}, "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    return code, out.getvalue()


def fsck_drill(cli, home: str) -> dict:
    """`pio fsck` on a small EVENTLOG home with one flipped byte: in a
    sealed segment's frames (exit 2; frames are report-only, so
    `--repair` leaves 2) and in a sealed segment's compaction sidecar
    (exit 2, then 3 with `--repair`, then 0)."""
    import datetime
    import shutil

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.filestore import NativeEventLogStore

    base = os.path.join(home, "small")
    store = NativeEventLogStore(os.path.join(base, "eventlog"))
    store.segment_bytes = 16_384
    t0 = 1_767_225_600
    for lo in range(0, 3_000, 500):
        store.insert_batch([Event(
            event="rate", entity_type="user", entity_id=f"u{j % 97}",
            target_entity_type="item", target_entity_id=f"i{j % 31}",
            properties={"rating": float(j % 5 + 1)},
            event_time=datetime.datetime.fromtimestamp(t0 + j, datetime.timezone.utc))
            for j in range(lo, lo + 500)], 1)
    ns = store._ns(1, None)
    for seg in list(ns.sealed):
        ns.compact(seg)
    ns.finalize_all()
    store.close()
    codes = {"clean": run_cli(cli, ["fsck", "--home", base])[0]}
    for kind, suffix in (("frame", ".pel"), ("sidecar", ".cols.npz")):
        d = os.path.join(home, kind)
        shutil.copytree(base, d)
        seg_dir = os.path.join(d, "eventlog", "events_1.peld")
        path = os.path.join(seg_dir, sorted(f for f in os.listdir(seg_dir)
                                            if f.endswith(suffix))[0])
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(blob)
        codes[kind] = [run_cli(cli, ["fsck", "--home", d] + extra)[0]
                       for extra in ([], ["--repair"], [])]
    print(f"fsck on a small home: clean {codes['clean']}; a flipped byte in a "
          f"sealed segment's frames {codes['frame']} (fsck, --repair, fsck); in "
          f"its compaction sidecar {codes['sidecar']}", flush=True)
    check(codes == {"clean": 0, "frame": [2, 2, 2], "sidecar": [2, 3, 0]},
          f"fsck exit codes {codes}")
    return codes


def eventlog_full_width(torch, ops, dev, coo=None, draws: int = EVENTLOG_DRAWS) -> dict:
    """Phase 16: the EVENTLOG backend at ML-20M width (see the module
    docstring)."""
    import numpy as np

    from predictionio_tpu_torch import native
    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY, prepare_deploy
    from predictionio_tpu_torch.data import store as event_store
    from predictionio_tpu_torch.storage import registry
    from predictionio_tpu_torch.tools import cli

    t_phase = time.perf_counter()
    reset_counters(ops)
    out = {}
    t0 = time.perf_counter()
    native.eventlog_library()
    info = native.BUILD_INFO.get("eventlog")
    print(f"native engine: {native.library_path('eventlog').name}, g++ "
          + (f"{info['seconds']:.2f} s" if info else "not run (library on disk)")
          + f" ({' '.join(native.GXX_FLAGS)}); loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if coo is None:
        users, items, ratings = synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS)
    else:  # phase 5's draws, in their order
        users, items, ratings = coo.user_idx, coo.item_idx, coo.rating
    users, items, ratings = users[:draws], items[:draws], ratings[:draws]
    n = len(users)
    repo = os.path.dirname(os.path.abspath(__file__))
    engine_dir = os.path.join(repo, "predictionio_tpu_torch", "templates", "recommendation")
    with tempfile.TemporaryDirectory(prefix="pio_chip_eventlog_") as home:
        env = {"PIO_HOME": home,
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EVENTLOG",
               "PIO_STORAGE_SOURCES_EVENTLOG_TYPE": "EVENTLOG"}
        storage = registry.Storage(registry.StorageConfig.from_env(env))
        check(storage.config.eventdata_type == "EVENTLOG", "EVENTDATA is not EVENTLOG")
        registry.set_storage(storage)
        try:
            check(run_cli(cli, ["app", "new", "ML20M"])[0] == 0, "app new failed")
            app_id = storage.meta.get_app_by_name("ML20M").id
            events = storage.events
            segment_bytes = events.segment_bytes
            events.init_channel(app_id)
            print(f"home {home}: EVENTDATA on EVENTLOG, {events.segment_bytes} B "
                  f"segments", flush=True)

            # 3. the draws through append_jsonl in ~8 MB chunks
            t0 = time.perf_counter()
            nbytes = chunks = 0
            for lo, n_lines, blob in ndjson_chunks(users, items, ratings, 0):
                appended, fallback = events.append_jsonl(blob, n_lines, app_id)
                check(appended == n_lines and not fallback,
                      f"append_jsonl took {appended} of {n_lines} lines at {lo}")
                nbytes += len(blob)
                chunks += 1
            t_load = time.perf_counter() - t0
            ns = events._ns(app_id, None)
            print(f"loaded {n} rate events ({N_USERS} x {N_ITEMS} draws, {nbytes / 1e9:.3f} GB "
                  f"of NDJSON in {chunks} chunks of {nbytes / chunks / 2**20:.2f} MiB) through "
                  f"append_jsonl in {t_load:.2f} s: {n / t_load:.0f} events/s; "
                  f"{len(ns.sealed)} sealed segments", flush=True)
            out["load_s"], out["load_events_s"] = t_load, n / t_load

            # 4. pio import, pio export, and the export imported again; the
            # round trip's apps stay one active segment each, so that export
            # takes the engine's own NDJSON path (a segmented namespace
            # exports through the merged find(), the CPU tests' case)
            events.segment_bytes = 1 << 30
            path = os.path.join(home, "import.jsonl")
            m = min(EVENTLOG_IMPORT, n // 4)
            with open(path, "wb") as f:
                for _, _, blob in ndjson_chunks(users[:m], items[:m], ratings[:m], 0):
                    f.write(blob)
            for name in ("Import1", "Import2"):
                check(run_cli(cli, ["app", "new", name])[0] == 0, f"app new {name}")
            code, text = run_cli(cli, ["import", "--app-name", "Import1", "--input", path])
            check(code == 0 and f"Imported {m} events" in text, f"import: {code} {text}")
            exported = os.path.join(home, "export.jsonl")
            code, text = run_cli(cli, ["export", "--app-name", "Import1", "--output", exported])
            check(code == 0 and f"Exported {m} events" in text, f"export: {code} {text}")
            code, text = run_cli(cli, ["import", "--app-name", "Import2", "--input", exported])
            check(code == 0, f"import of the export: {code} {text}")
            cols = [events.scan_columnar(storage.meta.get_app_by_name(a).id,
                                         value_key="rating") for a in ("Import1", "Import2")]
            same = all(np.array_equal(getattr(cols[0], f), getattr(cols[1], f))
                       for f in ("entity_idx", "target_idx", "name_idx", "values", "times_us"))
            same &= all(list(getattr(cols[0], f)) == list(getattr(cols[1], f))
                        for f in ("entity_ids", "target_ids", "names"))
            print(f"import {m} lines, export, import of the export: columnar scans "
                  f"equal {same} ({cols[0].n} rows)", flush=True)
            check(same and cols[0].n == m, "the re-imported app's columnar scan differs")
            events.segment_bytes = segment_bytes
            os.unlink(path)
            os.unlink(exported)

            # 5. the training read: cold, warm, after more events
            read = lambda: event_store.read_training_interactions(  # noqa: E731
                "ML20M", entity_type="user", target_entity_type="item",
                event_names=["rate", "buy"], value_key="rating",
                value_spec={"rate": "prop"}, default_spec=4.0, storage=storage)

            def cached(label, want):
                hits = event_store._SNAP_HITS._values.get((), 0.0)
                delta = event_store._SNAP_DELTA_ROWS._values.get((), 0.0)
                misses = dict(event_store._SNAP_MISSES._values)
                t0 = time.perf_counter()
                data = read()
                uu, ii, rr = data.arrays()
                wall = time.perf_counter() - t0
                if event_store._SNAP_HITS._values.get((), 0.0) > hits:
                    result = ("hit:delta" if event_store._SNAP_DELTA_ROWS._values.get(
                        (), 0.0) > delta else "hit")
                else:
                    grew = [k[0] for k, v in event_store._SNAP_MISSES._values.items()
                            if v > misses.get(k, 0.0)]
                    result = f"miss:{grew[0]}" if grew else "bypassed"
                u_vocab, i_vocab, u_idx, i_idx, r_want = want
                equal = (uu.dtype == np.int32 and ii.dtype == np.int32
                         and rr.dtype == np.float32 and np.array_equal(uu, u_idx)
                         and np.array_equal(ii, i_idx) and np.array_equal(rr, r_want)
                         and bimap_keys(data.user_ids) == [f"u{x}" for x in u_vocab]
                         and bimap_keys(data.item_ids) == [f"i{x}" for x in i_vocab])
                print(f"training read ({label}): {wall:.2f} s, cache {result}, "
                      f"{len(uu)} events, {len(u_vocab)} users x {len(i_vocab)} items, "
                      f"arrays equal numpy's bitwise {equal}", flush=True)
                check(equal, f"training read ({label}) differs from numpy's arrays")
                return result, wall

            def numpy_read(uu, ii, rr):
                u_vocab, u_idx = first_seen(uu)
                i_vocab, i_idx = first_seen(ii)
                return u_vocab, i_vocab, u_idx, i_idx, rr.astype(np.float32)

            want = numpy_read(users, items, ratings)
            reads = {"cold": cached("cold", want), "warm": cached("warm", want)}
            more = min(EVENTLOG_MORE, n)
            for _, n_lines, blob in ndjson_chunks(users[:more], items[:more], ratings[:more], n):
                check(events.append_jsonl(blob, n_lines, app_id)[0] == n_lines, "append")
            users = np.concatenate([users, users[:more]])
            items = np.concatenate([items, items[:more]])
            ratings = np.concatenate([ratings, ratings[:more]])
            want = numpy_read(users, items, ratings)
            reads["delta"] = cached(f"after {more} more events", want)
            check([reads[k][0] for k in ("cold", "warm", "delta")]
                  == ["miss:cold", "hit", "hit:delta"],
                  f"cache outcomes {[reads[k][0] for k in ('cold', 'warm', 'delta')]}")
            out["reads"] = reads

            # 6. compaction, then a read without the cache, through the sidecars
            code, text = run_cli(cli, ["segments", "compact", "--json"])
            doc = json.loads(text)
            check(code == 0 and ns.sealed and all(seg.meta.cols for seg in ns.sealed),
                  f"segments compact: exit {code}, {doc.get('compacted')} compacted")
            prev = event_store.set_scan_cache(False)
            try:
                reads["sidecars"] = cached("--no-scan-cache, after compaction", want)
            finally:
                event_store.set_scan_cache(prev)
            sources = collections.Counter(s["source"] for s in
                                          (ns.last_scan or {}).get("per_segment", []))
            print(f"segments compact: {doc['compacted']} sealed segments compacted "
                  f"({len(ns.sealed)} of this app); the uncached read took its "
                  f"blocks from {dict(sources)}", flush=True)
            check(reads["sidecars"][0] == "bypassed" and sources.get("columnar", 0)
                  == len(ns.sealed), f"the read after compaction: {dict(sources)}")

            # 7. fsck of this home, then the drill on a small one
            t0 = time.perf_counter()
            code, text = run_cli(cli, ["fsck", "--home", home, "--json"])
            report = json.loads(text)
            t_fsck = time.perf_counter() - t0
            print(f"pio fsck of this home: exit {code} in {t_fsck:.2f} s, checked "
                  f"{report['checked']} artifacts, clean {report['clean']}, corrupt "
                  f"{report['corrupt']}", flush=True)
            check(code == 0 and report["corrupt"] == 0, f"fsck exit {code}")
            out["fsck_s"] = t_fsck
            with tempfile.TemporaryDirectory(prefix="pio_chip_fsck_") as small:
                out["fsck_codes"] = fsck_drill(cli, small)

            # 8. pio train at rank 64, 10 iterations, lambda 0.01
            vpath = os.path.join(home, "variant.json")
            with open(vpath, "w") as f:
                json.dump({"id": "default", "engineFactory": RECOMMENDATION_FACTORY,
                           "datasource": {"params": {"appName": "ML20M",
                                                     "eventNames": ["rate", "buy"]}},
                           "algorithms": [{"name": "als", "params": {
                               "rank": RANK, "numIterations": ITERATIONS,
                               "lambda": LAMBDA, "seed": SEED}}]}, f)
            reset_counters(ops)
            t0 = time.perf_counter()
            code, text = run_cli(cli, ["train", "--engine-dir", engine_dir, "-e", vpath,
                                       "--device", dev.type])
            t_train = time.perf_counter() - t0
            launches = read_counters(ops)
            check(code == 0, f"train: exit {code}")
            iid = re.search(r"engine instance (\S+)", text).group(1)
            print(f"pio train on the event log: {t_train:.2f} s wall (the read, the "
                  f"layout and the train); kernel launches {launches} (phase 5: "
                  f"gather_gram 110, chol_solve 130)", flush=True)
            if dev.type == "cuda":
                for name in ("gather_gram", "chol_solve"):
                    check(launches[name] > 0, f"pio train did not launch {name}")
            out["train_s"], out["train_launches"] = t_train, launches
            eng = prepare_deploy(RECOMMENDATION_FACTORY, instance_id=iid, storage=storage,
                                 device=dev)
            model = eng.models[0]
            rows_u = np.array([int(k[1:]) for k in bimap_keys(model.user_ids)])
            rows_i = np.array([int(k[1:]) for k in bimap_keys(model.item_ids)])
            U = np.zeros((N_USERS, RANK), np.float32)
            V = np.zeros((N_ITEMS, RANK), np.float32)
            U[rows_u], V[rows_i] = model.U, model.V
            rng = np.random.default_rng(SEED + 16)
            counts = np.bincount(items, minlength=N_ITEMS)
            heavy = np.argsort(-counts, kind="stable")[:8]
            chosen = np.concatenate([heavy, rng.choice(
                np.setdiff1d(rows_i, heavy), 56, replace=False)])
            err = normal_equations_err(torch, dev, items, users, ratings, U, V,
                                       chosen, LAMBDA)
            print(f"float64 normal equations: {len(chosen)} items given the final U "
                  f"{err:.3e} (max|x - x64| / max|x64|, limit {ORACLE_TOL})", flush=True)
            check(err <= ORACLE_TOL, f"items off their normal equations: {err:.3e}")
            out["normal_equations_err"] = err

            # 9. deploy: answers equal to score_topk_ref
            queries = rng.choice(len(rows_u), EVENTLOG_QUERIES, replace=False)
            bodies = [json.dumps({"user": f"u{rows_u[r]}", "num": 10}) for r in queries]
            with running_server(dev, storage, RECOMMENDATION_FACTORY, instance_id=iid) as port:
                reset_counters(ops)
                t0 = time.perf_counter()
                answers = post_all(port, "/queries.json", bodies, 8)
                t_q = time.perf_counter() - t0
                served = read_counters(ops)
            Ud = torch.as_tensor(model.U, device=dev)
            Vd = torch.as_tensor(model.V, device=dev)
            ids = torch.as_tensor(queries.astype(np.int32), device=dev)
            rv, ri = ops.score_topk_ref(Ud, Vd, 10, ids=ids)
            s64 = Ud[ids.long()].double() @ Vd.double().T
            bad = 0
            for j, (st, a) in enumerate(answers):
                got_idx = torch.tensor([model.item_ids[it["item"]]
                                        for it in a.get("itemScores", [])], device=dev)
                got_val = torch.tensor([it["score"] for it in a.get("itemScores", [])],
                                       device=dev)
                if st != 200 or len(got_idx) != 10 or not topk_agrees(
                        got_val[None], got_idx[None], rv[j:j + 1], ri[j:j + 1],
                        s64[j:j + 1]):
                    bad += 1
            print(f"deploy: {EVENTLOG_QUERIES} POST /queries.json from 8 clients in "
                  f"{t_q:.2f} s, {bad} off score_topk_ref; kernel launches {served}",
                  flush=True)
            check(bad == 0, f"{bad} answers disagree with score_topk_ref")
            if dev.type == "cuda":
                check(served["score_topk"] > 0, "deploy did not launch score_topk")
            out["serve_launches"] = served
        finally:
            registry.set_storage(None)
            if storage._events is not None:
                storage._events.close()
    launches = {name: out["train_launches"][name] + out["serve_launches"][name]
                for name in out["train_launches"]}
    wall = time.perf_counter() - t_phase
    print(f"phase 16: {wall:.1f} s wall; kernel launches {launches} ({card_line()})",
          flush=True)
    out["launches"], out["wall"] = launches, wall
    return out


# phase 17: every repository on ELASTICSEARCH at ML-20M width
STORAGE_DRAWS = 2_000_000        # phase 5's first draws as `rate` events (--storage)
STORAGE_RUN_DRAWS = 150_000      # the whole run's cut, to keep it in its time
STORAGE_QUERIES = 200
STORAGE_SAMPLE = 1_000           # exported lines held against the imported ones

# phase 17's subprocess driver: one verb of the port's CLI, as `python -m
# predictionio_tpu_torch.tools.cli` runs it, with the process's tracer on.
# It first opens the repositories named in argv[1] through their stores and
# prints that wall (the index's snapshot load and WAL replay), then runs
# the verb and prints the walls and attributes of its `storage.scan` (the
# training read, with its `scan_cache` outcome) and `train.run` spans.
CLI_PROBE = r"""
import json, sys, time
from predictionio_tpu_torch.storage.registry import get_storage
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.utils import tracing

tracing.TRACER.configure(enabled=True)
st, t0 = get_storage(), time.perf_counter()
for repo in sys.argv[1].split(","):
    if repo == "meta":
        st.meta.list_engine_instances()
    elif repo == "models":
        st.models.list_ids()
    elif repo == "events":
        for app in st.meta.list_apps():
            st.events.creation_stats(app.id)
print("[probe] open " + json.dumps({"repos": sys.argv[1], "s": time.perf_counter() - t0}),
      flush=True)
try:
    cli.main(sys.argv[2:])
finally:
    spans = {d["name"]: {"s": d["durationUs"] / 1e6, "attrs": d.get("attrs", {})}
             for d in reversed(tracing.TRACER.ring.spans(limit=100_000))
             if d["name"] in ("storage.scan", "train.run")}
    print("[probe] spans " + json.dumps(spans), flush=True)
"""


def probe_line(out: str, key: str) -> dict:
    """The JSON of CLI_PROBE's ``[probe] <key>`` line in ``out``."""
    m = re.search(rf"^\[probe\] {key} (.*)$", out, re.M)
    check(m is not None, f"no [probe] {key} line in:\n{out[-2000:]}")
    return json.loads(m.group(1))


def index_files(root: str) -> str:
    """Each index file of the root with its size, for the log."""
    return ", ".join(f"{f} {os.path.getsize(os.path.join(root, f)) / 2**20:.1f} MiB"
                     for f in sorted(os.listdir(root)))


def storage_full_width(torch, ops, dev, coo=None, draws: int = STORAGE_DRAWS) -> dict:
    """Phase 17: every repository on ELASTICSEARCH at ML-20M width (see
    the module docstring)."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY, prepare_deploy
    from predictionio_tpu_torch.data.event import parse_event_time
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.storage import registry

    t_phase = time.perf_counter()
    if coo is None:
        users, items, ratings = synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS)
    else:  # phase 5's draws, in their order
        users, items, ratings = coo.user_idx, coo.item_idx, coo.rating
    users, items, ratings = users[:draws], items[:draws], ratings[:draws]
    n = len(users)
    repo = os.path.dirname(os.path.abspath(__file__))
    engine_dir = os.path.join(repo, "predictionio_tpu_torch", "templates", "recommendation")
    out = {}
    procs = []
    with tempfile.TemporaryDirectory(prefix="pio_chip_es_") as home:
        root = os.path.join(home, "es")
        settings = {"PIO_HOME": home, "PIO_STORAGE_SOURCES_ES_TYPE": "ELASTICSEARCH",
                    "PIO_STORAGE_SOURCES_ES_PATH": root}
        for r in ("METADATA", "EVENTDATA", "MODELDATA"):
            settings[f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE"] = "ES"
        env = dict(os.environ, **settings)

        def cli(*args, opens=None) -> tuple:
            """One verb in a new process (CLI_PROBE with ``opens``); (stdout, wall)."""
            argv = (CLI + list(args) if opens is None
                    else [sys.executable, "-c", CLI_PROBE, opens] + list(args))
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=repo, env=env, capture_output=True, text=True,
                                  timeout=900)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"cli {' '.join(args)} failed ({proc.returncode}):\n"
                                        f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            print(f"-- cli {' '.join(args[:2])}: {wall:.2f} s wall", flush=True)
            return proc.stdout, wall

        try:
            # 1. the app
            text, _ = cli("app", "new", "ML20M")
            check("Access Key:" in text, f"app new: {text}")
            storage = registry.Storage(registry.StorageConfig.from_env(settings))
            check((storage.config.metadata_type, storage.config.eventdata_type,
                   storage.config.modeldata_type) == ("ELASTICSEARCH",) * 3,
                  f"repositories not on ELASTICSEARCH: {storage.config}")
            check(sorted(os.listdir(home)) == ["es"] and "pio_apps.jsonl" in os.listdir(root),
                  f"the app did not land in the index root: {os.listdir(home)}")

            # 2. pio import of the draws
            path = os.path.join(home, "draws.jsonl")
            t0 = time.perf_counter()
            with open(path, "wb") as f:
                for _, _, blob in ndjson_chunks(users, items, ratings, 0):
                    f.write(blob)
            print(f"{n} rate events ({N_USERS} x {N_ITEMS} draws) as NDJSON: "
                  f"{os.path.getsize(path) / 1e6:.1f} MB in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            text, t_import = cli("import", "--app-name", "ML20M", "--input", path)
            check(f"Imported {n} events" in text, f"import: {text}")
            print(f"pio import: {n} events in {t_import:.2f} s wall, {n / t_import:.0f} "
                  f"events/s (the process start, the parse and the index's WAL appends); "
                  f"index root: {index_files(root)}", flush=True)
            out["import_s"], out["import_events_s"] = t_import, n / t_import

            # 3. pio train twice: a cold read, then a cached one
            vpath = os.path.join(home, "variant.json")
            with open(vpath, "w") as f:
                json.dump({"id": "default", "engineFactory": RECOMMENDATION_FACTORY,
                           "datasource": {"params": {"appName": "ML20M",
                                                     "eventNames": ["rate", "buy"]}},
                           "algorithms": [{"name": "als", "params": {
                               "rank": RANK, "numIterations": ITERATIONS,
                               "lambda": LAMBDA, "seed": SEED}}]}, f)
            trains = []
            for label in ("first", "second"):
                text, wall = cli("train", "--engine-dir", engine_dir, "-e", vpath,
                                 "--device", dev.type, opens="meta,models,events")
                opened, spans = probe_line(text, "open"), probe_line(text, "spans")
                launches = {k: int(v) for k, v in re.findall(
                    r"(\w+)=(\d+)", text.split("kernel launches:")[-1])}
                iid = re.search(r"engine instance (\S+)", text).group(1)
                scan = spans["storage.scan"]
                print(f"pio train ({label}): {wall:.2f} s wall; the repositories opened in "
                      f"{opened['s']:.2f} s (the event index's WAL replayed); the training "
                      f"read {scan['s']:.2f} s, cache {scan['attrs'].get('scan_cache')}, "
                      f"{scan['attrs'].get('records')} events; train.run "
                      f"{spans['train.run']['s']:.2f} s; kernel launches {launches} "
                      f"(phase 5: gather_gram 110, chol_solve 130)", flush=True)
                trains.append({"wall_s": wall, "open_s": opened["s"], "read_s": scan["s"],
                               "cache": scan["attrs"].get("scan_cache"), "iid": iid,
                               "launches": launches, "records": scan["attrs"].get("records")})
            check([t["cache"] for t in trains] == ["miss:cold", "hit"],
                  f"scan cache outcomes {[t['cache'] for t in trains]}")
            check(all(t["records"] == n for t in trains), "the training read lost events")
            if dev.type == "cuda":
                # each half-step launches gather_gram once a bucket and
                # chol_solve once a part (the dense head is a part too)
                (u_vocab, u_idx), (i_vocab, i_idx) = first_seen(users), first_seen(items)
                prep = als.als_prepare(als.RatingsCOO(u_idx, i_idx, ratings.astype(np.float32),
                                                      len(u_vocab), len(i_vocab)))
                buckets = sum(len(sd.buckets) for sd in (prep.u_side, prep.i_side))
                parts = buckets + sum(sd.dense is not None for sd in (prep.u_side, prep.i_side))
                want = {"gather_gram": ITERATIONS * buckets, "chol_solve": ITERATIONS * parts}
                print(f"the draws' layout: {buckets} buckets, {parts} parts; expected "
                      f"launches a train {want}", flush=True)
                for t in trains:
                    check({k: t["launches"].get(k) for k in want} == want,
                          f"pio train launched {t['launches']}, expected {want}")
            out["trains"] = trains
            iid = trains[1]["iid"]

            eng = prepare_deploy(RECOMMENDATION_FACTORY, instance_id=iid, storage=storage,
                                 device=dev)
            model = eng.models[0]
            rows_u = np.array([int(k[1:]) for k in bimap_keys(model.user_ids)])
            rows_i = np.array([int(k[1:]) for k in bimap_keys(model.item_ids)])
            print(f"instance {iid}: {len(rows_u)} users x {len(rows_i)} items, rank "
                  f"{model.U.shape[1]}", flush=True)
            U = np.zeros((N_USERS, RANK), np.float32)
            V = np.zeros((N_ITEMS, RANK), np.float32)
            U[rows_u], V[rows_i] = model.U, model.V
            rng = np.random.default_rng(SEED + 17)
            counts = np.bincount(items, minlength=N_ITEMS)
            heavy = np.argsort(-counts, kind="stable")[:8]
            chosen = np.concatenate([heavy, rng.choice(
                np.setdiff1d(rows_i, heavy), 56, replace=False)])
            err = normal_equations_err(torch, dev, items, users, ratings, U, V, chosen, LAMBDA)
            print(f"float64 normal equations: {len(chosen)} items given the final U "
                  f"{err:.3e} (max|x - x64| / max|x64|, limit {ORACLE_TOL})", flush=True)
            check(err <= ORACLE_TOL, f"items off their normal equations: {err:.3e}")
            out["normal_equations_err"] = err

            # 4. pio deploy in a new process, 200 queries from 8 clients, while
            # 5. pio export runs in another (each only reads the index)
            exported = os.path.join(home, "export.jsonl")
            export_log = os.path.join(home, "export.log")
            t_export = time.perf_counter()
            with open(export_log, "w") as f:
                ex = subprocess.Popen(CLI + ["export", "--app-name", "ML20M", "--output",
                                             exported], cwd=repo, env=env, stdout=f,
                                      stderr=subprocess.STDOUT)
            procs.append(ex)
            port = free_port()
            log = os.path.join(home, "deploy.log")
            t0 = time.perf_counter()
            with open(log, "w") as f:
                dp = subprocess.Popen(
                    [sys.executable, "-c", CLI_PROBE, "meta,models", "deploy",
                     "--engine-dir", engine_dir, "-e", vpath, "--engine-instance-id", iid,
                     "--batching", "--ip", "127.0.0.1", "--port", str(port),
                     "--device", dev.type], cwd=repo, env=env, stdout=f,
                    stderr=subprocess.STDOUT)
            procs.append(dp)
            wait_until(lambda: http_json(port, "GET", "/")[0] == 200, dp, log, 600)
            t_up = time.perf_counter() - t0
            opened = probe_line(open(log).read(), "open")
            print(f"pio deploy: listening {t_up:.2f} s after its start (the process, "
                  f"the index's snapshot load and WAL replay of meta and models "
                  f"{opened['s']:.2f} s, the model onto the card)", flush=True)
            queries = rng.choice(len(rows_u), STORAGE_QUERIES, replace=False)
            bodies = [json.dumps({"user": f"u{rows_u[r]}", "num": 10}) for r in queries]
            t0 = time.perf_counter()
            answers = post_all(port, "/queries.json", bodies, 8)
            t_q = time.perf_counter() - t0
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stop", timeout=30) as r:
                r.read()
            dp.wait(timeout=120)
            text = open(log).read()
            served = {k: int(v) for k, v in re.findall(
                r"(\w+)=(\d+)", text.split("kernel launches:")[-1])}
            Ud = torch.as_tensor(model.U, device=dev)
            Vd = torch.as_tensor(model.V, device=dev)
            ids = torch.as_tensor(queries.astype(np.int32), device=dev)
            rv, ri = ops.score_topk_ref(Ud, Vd, 10, ids=ids)
            s64 = Ud[ids.long()].double() @ Vd.double().T
            bad = 0
            for j, (st, a) in enumerate(answers):
                got_idx = torch.tensor([model.item_ids[it["item"]]
                                        for it in a.get("itemScores", [])], device=dev)
                got_val = torch.tensor([it["score"] for it in a.get("itemScores", [])],
                                       device=dev)
                if st != 200 or len(got_idx) != 10 or not topk_agrees(
                        got_val[None], got_idx[None], rv[j:j + 1], ri[j:j + 1],
                        s64[j:j + 1]):
                    bad += 1
            print(f"deploy: {STORAGE_QUERIES} POST /queries.json from 8 clients in "
                  f"{t_q:.2f} s, {bad} off score_topk_ref; the server's kernel launches "
                  f"{served}", flush=True)
            check(bad == 0, f"{bad} answers disagree with score_topk_ref")
            if dev.type == "cuda":
                check(served.get("score_topk", 0) > 0, "deploy did not launch score_topk")
            out["deploy_up_s"], out["deploy_open_s"] = t_up, opened["s"]
            out["serve_launches"] = served

            # 5. the export: every event, as imported
            code = ex.wait(timeout=900)
            t_export = time.perf_counter() - t_export
            text = open(export_log).read()
            check(code == 0 and f"Exported {n} events" in text, f"export: {code} {text[-4000:]}")
            with open(exported) as f:
                lines = f.readlines()
            sample = np.sort(rng.choice(n, min(STORAGE_SAMPLE, n), replace=False))
            with open(path) as f:
                imported = f.readlines()
            fields = ("event", "entityType", "entityId", "targetEntityType",
                      "targetEntityId", "properties")
            same = 0
            for j in sample.tolist():
                a, b = json.loads(lines[j]), json.loads(imported[j])
                same += (all(a[k] == b[k] for k in fields)
                         and parse_event_time(a["eventTime"]) == parse_event_time(b["eventTime"]))
            print(f"pio export: {len(lines)} lines in {t_export:.2f} s wall (its process "
                  f"ran beside the deploy's); {same} of {len(sample)} sampled lines equal "
                  f"to the imported ones", flush=True)
            check(len(lines) == n and same == len(sample), "the export differs from the import")
            out["export_s"] = t_export
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
            registry.set_storage(None)
    launches = {name: trains[1]["launches"].get(name, 0) + served.get(name, 0)
                for name in ("score_topk", "gather_gram", "chol_solve", "rows_gram")}
    wall = time.perf_counter() - t_phase
    print(f"phase 17: {wall:.1f} s wall; kernel launches of the second train and the "
          f"deploy {launches} ({card_line() if dev.type == 'cuda' else 'cpu'})", flush=True)
    out["launches"], out["wall"] = launches, wall
    return out


# phase 18: the replicated event plane and the continuous trainer at ML-20M width
REPL_DRAWS = N_RATINGS        # phase 5's draws imported with --replication
REPL_RUN_DRAWS = 1_000_000    # the whole run's cut, to keep it in its time
REPL_TAIL = 100_000           # live tail posted through the follower's 307 (--replication)
REPL_RUN_TAIL = 20_000        # the whole run's tail
REPL_DELTA = 5_000            # the events each later cycle wakes on
REPL_FAILOVER = 1_000         # the live ingest across the leader's kill -9
REPL_KILL_AFTER = 500         # acked events before the kill
REPL_BATCH = 50               # events a /batch/events.json request
REPL_QUERIES = 200
REPL_LEASE_TTL = 1.0          # the event plane's lease (promotion waits this out)
TRAINER_LEASE_TTL = 3.0       # the trainer's lease (a killed trainer's lapses in this)
TRAINER_POLL = 1.0            # the trainer's poll (each one rebuilds its view of a moved log)
REPL_KEY = "chip-repl-key"


def repl_events(users, items, ratings, lo: int, hi: int) -> list:
    """`rate` event dicts of draws ``lo .. hi-1`` (past the draws, they
    start over: a re-rating), one eventTime a second from EVENTLOG_T0."""
    import datetime

    n = len(users)
    t0 = datetime.datetime.fromtimestamp(EVENTLOG_T0, datetime.timezone.utc)
    out = []
    for j in range(lo, hi):
        d = j % n
        out.append({"event": "rate", "entityType": "user", "entityId": f"u{users[d]}",
                    "targetEntityType": "item", "targetEntityId": f"i{items[d]}",
                    "properties": {"rating": float(ratings[d])},
                    "eventTime": (t0 + datetime.timedelta(seconds=j)).isoformat(
                        timespec="milliseconds").replace("+00:00", "Z")})
    return out


def post_batch(url: str, events: list, timeout: float = 60) -> tuple:
    """POST one batch to ``url``'s /batch/events.json, following a 307 at
    once (its Retry-After is a hint for clients that wait); returns
    (HTTP status, per-event answers or None, hops followed)."""
    import urllib.error
    import urllib.parse

    target = f"{url}/batch/events.json?accessKey={REPL_KEY}"
    body = json.dumps(events).encode()
    for hop in range(3):
        req = urllib.request.Request(target, data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read()), hop
        except urllib.error.HTTPError as e:
            if e.code in (307, 308) and e.headers.get("Location"):
                target = urllib.parse.urljoin(target, e.headers["Location"])
                continue
            return e.code, None, hop
    return 0, None, 3


def repl_status(url: str) -> dict:
    with urllib.request.urlopen(url + "/repl/status", timeout=10) as r:
        return json.loads(r.read())


def file_digests(root: str) -> dict:
    """{relative path: sha256} of every file under ``root``."""
    import hashlib

    out = {}
    for base, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 22), b""):
                    h.update(chunk)
            out[os.path.relpath(path, root)] = h.hexdigest()
    return out


def launch_line(text: str, marker: str) -> dict:
    """The kernel counts of the last ``marker ... kernel launches: ...``
    line in ``text``."""
    lines = [ln for ln in text.splitlines() if marker in ln and "kernel launches:" in ln]
    check(bool(lines), f"no {marker!r} launch line in:\n{text[-3000:]}")
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)",
                                              lines[-1].split("kernel launches:")[-1])}


def replication_full_width(torch, ops, dev, coo=None, draws: int = REPL_DRAWS,
                           tail: int = REPL_TAIL) -> dict:
    """Phase 18: the replicated event plane and the continuous trainer at
    ML-20M width (see the module docstring)."""
    import signal
    import urllib.error

    import numpy as np

    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY, prepare_deploy
    from predictionio_tpu_torch.server.repl_server import _failover_bundles
    from predictionio_tpu_torch.storage import registry

    t_phase = time.perf_counter()
    if coo is None:
        users, items, ratings = synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS)
    else:  # phase 5's draws, in their order
        users, items, ratings = coo.user_idx, coo.item_idx, coo.rating
    n = min(draws, len(users))
    repo = os.path.dirname(os.path.abspath(__file__))
    engine_dir = os.path.join(repo, "predictionio_tpu_torch", "templates", "recommendation")
    out = {"cycles": []}
    procs = []
    posted = [n]        # events posted so far; the next batch starts here

    with tempfile.TemporaryDirectory(prefix="pio_chip_repl_") as base:
        homes = {r: os.path.join(base, r) for r in ("leader", "follower")}
        lease_home = os.path.join(base, "lease")
        ports = {r: free_port() for r in homes}
        urls = {r: f"http://127.0.0.1:{p}" for r, p in ports.items()}
        eventlog = {"PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EVENTLOG",
                    "PIO_STORAGE_SOURCES_EVENTLOG_TYPE": "EVENTLOG"}
        env = {r: dict(os.environ, PIO_HOME=h, **eventlog) for r, h in homes.items()}

        def cli(role, *args, extra_env=None, check_code=True) -> tuple:
            """One verb in a new process on ``role``'s home: (code, stdout, wall)."""
            t0 = time.perf_counter()
            proc = subprocess.run(CLI + list(args), cwd=repo,
                                  env=dict(env[role], **(extra_env or {})),
                                  capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if check_code:
                check(proc.returncode == 0,
                      f"cli {' '.join(args)} failed ({proc.returncode}):\n"
                      f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            print(f"-- cli {' '.join(args[:2])}: exit {proc.returncode}, {wall:.2f} s wall",
                  flush=True)
            return proc.returncode, proc.stdout + proc.stderr, wall

        def start_server(role: str):
            peer = "follower" if role == "leader" else "leader"
            log = os.path.join(base, f"{role}.log")
            with open(log, "w") as f:
                p = subprocess.Popen(CLI + [
                    "eventserver", "--ip", "127.0.0.1", "--port", str(ports[role]),
                    "--lease-home", lease_home, "--advertise-url", urls[role],
                    "--replicate-to", urls[peer], "--lease-ttl", str(REPL_LEASE_TTL),
                    "--durable-acks"], cwd=repo, env=env[role], stdout=f,
                    stderr=subprocess.STDOUT)
            procs.append(p)
            return p, log

        def post_range(url: str, count: int, clients: int) -> tuple:
            """``count`` next events in batches from ``clients`` threads;
            (every item 201, wall, 307 hops)."""
            lo = posted[0]
            posted[0] += count
            batches = [repl_events(users, items, ratings, s, min(s + REPL_BATCH, lo + count))
                       for s in range(lo, lo + count, REPL_BATCH)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(clients) as pool:
                answers = list(pool.map(lambda b: post_batch(url, b), batches))
            wall = time.perf_counter() - t0
            ok = all(st == 200 and doc is not None and all(d.get("status") == 201 for d in doc)
                     for st, doc, _ in answers)
            return ok, wall, sum(h for _, _, h in answers)

        def answers_match(port: int, iid: str, label: str) -> int:
            """200 queries to the deploy against score_topk_ref on ``iid``'s
            factors; returns how many disagree."""
            storage = registry.Storage(registry.StorageConfig.from_env(
                dict(eventlog, PIO_HOME=homes["follower"])))
            model = prepare_deploy(RECOMMENDATION_FACTORY, instance_id=iid,
                                   storage=storage, device=dev).models[0]
            rows_u = np.array([int(k[1:]) for k in bimap_keys(model.user_ids)])
            rng = np.random.default_rng(SEED + 18)
            queries = rng.choice(len(rows_u), REPL_QUERIES, replace=False)
            bodies = [json.dumps({"user": f"u{rows_u[r]}", "num": 10}) for r in queries]
            answers = post_all(ports["deploy"], "/queries.json", bodies, 8)
            Ud = torch.as_tensor(model.U, device=dev)
            Vd = torch.as_tensor(model.V, device=dev)
            ids = torch.as_tensor(queries.astype(np.int32), device=dev)
            rv, ri = ops.score_topk_ref(Ud, Vd, 10, ids=ids)
            s64 = Ud[ids.long()].double() @ Vd.double().T
            bad = 0
            for j, (st, a) in enumerate(answers):
                got_idx = torch.tensor([model.item_ids[it["item"]]
                                        for it in a.get("itemScores", [])], device=dev)
                got_val = torch.tensor([it["score"] for it in a.get("itemScores", [])],
                                       device=dev)
                if st != 200 or len(got_idx) != 10 or not topk_agrees(
                        got_val[None], got_idx[None], rv[j:j + 1], ri[j:j + 1],
                        s64[j:j + 1]):
                    bad += 1
            print(f"{label}: {REPL_QUERIES} answers against score_topk_ref on instance "
                  f"{iid}'s factors, {bad} off", flush=True)
            check(bad == 0, f"{label}: {bad} answers off score_topk_ref")
            return model

        def items_err(iid: str, label: str) -> float:
            """64 items of ``iid`` (8 heaviest) against their float64 normal
            equations over every event posted so far."""
            storage = registry.Storage(registry.StorageConfig.from_env(
                dict(eventlog, PIO_HOME=homes["follower"])))
            model = prepare_deploy(RECOMMENDATION_FACTORY, instance_id=iid,
                                   storage=storage, device=dev).models[0]
            m = posted[0]
            idx = np.arange(m) % len(users)
            uu, ii, rr = users[idx], items[idx], ratings[idx]
            rows_u = np.array([int(k[1:]) for k in bimap_keys(model.user_ids)])
            rows_i = np.array([int(k[1:]) for k in bimap_keys(model.item_ids)])
            U = np.zeros((N_USERS, RANK), np.float32)
            V = np.zeros((N_ITEMS, RANK), np.float32)
            U[rows_u], V[rows_i] = model.U, model.V
            rng = np.random.default_rng(SEED + 18)
            counts = np.bincount(ii, minlength=N_ITEMS)
            heavy = np.argsort(-counts, kind="stable")[:8]
            chosen = np.concatenate([heavy, rng.choice(
                np.setdiff1d(rows_i, heavy), 56, replace=False)])
            err = normal_equations_err(torch, dev, ii, uu, rr, U, V, chosen, LAMBDA)
            print(f"{label} ({m} events in the follower's home): {len(chosen)} items "
                  f"{err:.3e} from their float64 normal equations (limit {ORACLE_TOL})",
                  flush=True)
            check(err <= ORACLE_TOL, f"{label}'s items off float64: {err:.3e}")
            return err

        def fsck_both() -> dict:
            """``fsck`` of both homes, in two processes at once: exit codes."""
            with ThreadPoolExecutor(2) as pool:
                runs = {role: pool.submit(cli, role, "fsck", "--home", homes[role],
                                          check_code=False) for role in homes}
            for role, run in runs.items():
                code, text, _ = run.result()
                if code:
                    print(f"fsck of the {role}'s home:\n{text[-2000:]}", flush=True)
            return {role: run.result()[0] for role, run in runs.items()}

        def registry_doc() -> dict:
            path = os.path.join(homes["follower"], "model_registry", "registry.json")
            with open(path) as f:
                return json.load(f)

        try:
            # 1. the app on both homes (meta only: its events come by
            # replication), pio import into the leader's home
            for role in homes:
                plain = {k: v for k, v in env[role].items() if k not in eventlog}
                proc = subprocess.run(CLI + ["app", "new", "ML20M", "--access-key", REPL_KEY],
                                      cwd=repo, env=plain, capture_output=True, text=True,
                                      timeout=120)
                check(proc.returncode == 0, f"app new on the {role}: {proc.stderr[-2000:]}")
            path = os.path.join(base, "draws.jsonl")
            with open(path, "wb") as f:
                for _, _, blob in ndjson_chunks(users[:n], items[:n], ratings[:n], 0):
                    f.write(blob)
            _, text, t_import = cli("leader", "import", "--app-name", "ML20M", "--input", path)
            check(f"Imported {n} events" in text, f"import: {text[-2000:]}")
            os.unlink(path)
            print(f"pio import into the leader's home: {n} events in {t_import:.2f} s wall, "
                  f"{n / t_import:.0f} events/s", flush=True)
            out["import_s"], out["import_events_s"] = t_import, n / t_import

            # the leader, then the follower, which catches up on the sealed
            # segments by the manifest sync
            leader, leader_log = start_server("leader")
            wait_until(lambda: repl_status(urls["leader"])["role"] == "leader", leader,
                       leader_log, 300)
            with urllib.request.urlopen(urls["leader"] + "/repl/manifest", timeout=60) as r:
                next_id = json.loads(r.read())["namespaces"].get("events_1", {}).get(
                    "manifest", {}).get("next_id", 0)
            t0 = time.perf_counter()
            follower, follower_log = start_server("follower")
            wait_until(lambda: repl_status(urls["follower"])["role"] == "follower"
                       and repl_status(urls["follower"])["leaderUrl"] == urls["leader"]
                       and repl_status(urls["follower"])["replica"]["cursors"].get(
                           "events_1", {"seg": 0})["seg"] == next_id, follower,
                       follower_log, 600)
            t_sealed = time.perf_counter() - t0

            def pel_bytes() -> int:
                return sum(os.path.getsize(os.path.join(dp, f))
                           for dp, _, fs in os.walk(os.path.join(homes["follower"],
                                                                 "eventlog"))
                           for f in fs if f.endswith(".pel"))

            sealed_bytes = pel_bytes()
            # the first batch through the follower: the leader resends its
            # whole active file from the follower's cursor, then the batch
            ok, t_first, hops = post_range(urls["follower"], REPL_BATCH, 1)
            check(ok and hops == 1, "the first batch through the follower was not acked")
            # the resent active file may roll into a sealed segment at once
            active = pel_bytes() - sealed_bytes
            print(f"catch-up: {sealed_bytes} B of {next_id} sealed segments synced "
                  f"{t_sealed:.2f} s after the follower's start (process start included); "
                  f"the {active} B active file resent from the cursor with the first "
                  f"batch in {t_first:.2f} s", flush=True)
            out["catchup_bytes"] = sealed_bytes + active
            out["catchup_s"] = t_sealed + t_first

            # the live tail through the follower's 307, replication on
            ok, t_tail, hops = post_range(urls["follower"], tail - REPL_BATCH, 8)
            print(f"live tail: {tail - REPL_BATCH} events in batches of {REPL_BATCH} "
                  f"from 8 clients through the follower's 307 ({hops} redirects), "
                  f"{(tail - REPL_BATCH) / t_tail:.0f} events/s, every item 201: {ok}",
                  flush=True)
            check(ok, "an event of the live tail was not acked 201")
            out["tail_events_s"] = (tail - REPL_BATCH) / t_tail
            lead = file_digests(os.path.join(homes["leader"], "eventlog"))
            foll = file_digests(os.path.join(homes["follower"], "eventlog"))
            frames = {k: v for k, v in lead.items() if k.endswith(".pel")}
            same = {k: foll.get(k) for k in frames} == frames and all(
                k in frames for k in foll if k.endswith(".pel"))
            print(f"follower's event log against the leader's: {len(frames)} frame files, "
                  f"equal by sha256: {same}", flush=True)
            check(same, f"follower differs: leader {lead}, follower {foll}")
            codes = fsck_both()
            check(codes == {"leader": 0, "follower": 0}, f"fsck exit codes {codes}")

            # 2. one long-lived supervised trainer reads the follower's home
            # (through a view of its log that ends at the acked cursor) and
            # writes its models there; the deploy serves that home and joins
            # the fleet manifest that the trainer pushes /reload to
            vpath = os.path.join(base, "variant.json")
            with open(vpath, "w") as f:
                # a checkpoint every 2 iterations: the crash drill resumes
                json.dump({"id": "default", "engineFactory": RECOMMENDATION_FACTORY,
                           "datasource": {"params": {"appName": "ML20M",
                                                     "eventNames": ["rate", "buy"]}},
                           "algorithms": [{"name": "als", "params": {
                               "rank": RANK, "numIterations": ITERATIONS, "lambda": LAMBDA,
                               "seed": SEED, "checkpointEvery": 2}}]}, f)
            fleet = os.path.join(base, "fleet.json")
            with open(fleet, "w") as f:
                json.dump({"replicas": []}, f)
            trainer = ["train", "--continuous", "--read-from", "follower",
                       "--replica-home", homes["follower"], "--engine-dir", engine_dir,
                       "-e", vpath, "--device", dev.type, "-v", "--poll-interval",
                       str(TRAINER_POLL),
                       "--lease-ttl", str(TRAINER_LEASE_TTL), "--min-delta-events",
                       str(REPL_DELTA), "--guardrail-holdout", "200",
                       "--fleet-manifest", fleet]

            def cycles_of(text: str) -> list:
                """The trainer cycles in ``text`` that did work: outcome,
                generation, walls, kernel launches (each process's lines count
                from its start) and gate."""
                recs, split, last = [], None, {}
                for ln in text.splitlines():
                    if ln.startswith("[supervise] started pid"):
                        last = {}
                    m = re.search(r"train phases: read_training=([0-9.]+)s, "
                                  r"prepare=([0-9.]+)s, train:als=([0-9.]+)s", ln)
                    if m:
                        split = [float(x) for x in m.groups()]
                        continue
                    if ln.startswith("[trainer] gate: ") and recs:
                        recs[-1]["gate"] = json.loads(ln[len("[trainer] gate: "):])
                        continue
                    m = re.match(r"\[trainer\] cycle \d+: (\S+) gen=(\S+) (.*?) "
                                 r"\(kernel launches: (.*)\)$", ln)
                    if not m or m.group(1) in ("idle", "lease-held", "lease-lost"):
                        continue
                    now = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m.group(4))}
                    steps = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)s",
                                                                m.group(3))}
                    if split and "train" in steps:
                        # the workflow's own split of the train: the read, then
                        # (within "train") the preparator and the fit; the rest
                        # of "train" is the card's setup and saving the instance
                        read, prep, fit = split
                        steps["train"] -= read
                        steps.update(read=read, prepare=prep, fit=fit)
                    split = None
                    recs.append({"outcome": m.group(1), "gen": m.group(2), "steps": steps,
                                 "launches": {k: v - last.get(k, 0) for k, v in now.items()}})
                    last = now
                return recs

            def report(label: str, rec: dict, wall: float) -> dict:
                g = rec.get("gate") or {}
                print(f"{label}: {rec['outcome']} gen={rec['gen']}, {wall:.2f} s wall; walls "
                      + ", ".join(f"{k} {v:.3f} s" for k, v in rec["steps"].items())
                      + f"; kernel launches {rec['launches']}; gate {g.get('reason')}"
                      + (f" (champion RMSE {g['champion_rmse']}, candidate "
                         f"{g['candidate_rmse']}, {g['pairs']} pairs)"
                         if g.get("champion_rmse") is not None else ""), flush=True)
                out["cycles"].append(dict(rec, label=label, wall_s=wall))
                return rec

            dlog = os.path.join(base, "daemon.log")
            with open(dlog, "w") as f:
                daemon = subprocess.Popen(CLI + ["daemon", "--"] + trainer, cwd=repo,
                                          env=env["leader"], stdout=f,
                                          stderr=subprocess.STDOUT)
            procs.append(daemon)

            def await_cycle(outcome: str, gen: int, label: str, t0: float) -> dict:
                """The daemon's cycle that ended in ``outcome`` for ``gen``."""
                deadline = time.monotonic() + 600
                while True:
                    found = [r for r in cycles_of(open(dlog).read())
                             if (r["outcome"], r["gen"]) == (outcome, str(gen))]
                    if found:
                        wall = time.perf_counter() - t0
                        time.sleep(0.3)       # the gate's line follows its cycle's
                        found = [r for r in cycles_of(open(dlog).read())
                                 if (r["outcome"], r["gen"]) == (outcome, str(gen))]
                        check(len(found) == 1, f"{label}: {len(found)} cycles of gen {gen}")
                        return report(label, found[0], wall)
                    check(daemon.poll() is None and time.monotonic() < deadline,
                          f"{label}: no {outcome} gen={gen}:\n{open(dlog).read()[-4000:]}")
                    time.sleep(0.1)

            # cycle 1: generation 1 over the follower's whole log; no deploy
            # is in the fleet yet (one cannot start before an instance exists)
            c1 = await_cycle("promoted", 1, "cycle 1 (daemon start to promotion)",
                             time.perf_counter())
            if dev.type == "cuda":
                for name in ("gather_gram", "chol_solve"):
                    check(c1["launches"].get(name, 0) > 0, f"cycle 1 launched no {name}")
            gen1 = registry_doc()["generations"][0]["instance_id"]
            out["normal_equations_err"] = items_err(gen1, "generation 1")
            ports["deploy"] = free_port()
            urls["deploy"] = f"http://127.0.0.1:{ports['deploy']}"
            deploy_log = os.path.join(base, "deploy.log")
            t0 = time.perf_counter()
            with open(deploy_log, "w") as f:
                dp = subprocess.Popen(CLI + [
                    "deploy", "--engine-dir", engine_dir, "-e", vpath, "--batching",
                    "--ip", "127.0.0.1", "--port", str(ports["deploy"]),
                    "--device", dev.type], cwd=repo,
                    env=dict(os.environ, PIO_HOME=homes["follower"], **eventlog),
                    stdout=f, stderr=subprocess.STDOUT)
            procs.append(dp)
            wait_until(lambda: http_json(ports["deploy"], "GET", "/")[0] == 200, dp,
                       deploy_log, 600)
            print(f"pio deploy on the follower's home: listening in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            with open(fleet + ".tmp", "w") as f:
                json.dump({"replicas": [{"url": urls["deploy"]}]}, f)
            os.replace(fleet + ".tmp", fleet)
            answers_match(ports["deploy"], gen1, "deploy of generation 1")

            # cycle 2: a delta through the follower while the trainer polls
            # the follower's live log; it wakes once the whole delta is acked,
            # delta-trains with resume, gates offline (champion and candidate
            # RMSE) and pushes /reload to the deploy
            ok, t_delta, _ = post_range(urls["follower"], REPL_DELTA, 8)
            check(ok, "the delta of cycle 2 was not acked")
            print(f"cycle 2's delta: {REPL_DELTA} events through the follower's 307 while "
                  f"the trainer polls the follower's log, {REPL_DELTA / t_delta:.0f} "
                  f"events/s", flush=True)
            out["delta_events_s"] = REPL_DELTA / t_delta
            c2 = await_cycle("promoted", 2, "cycle 2 (last ack to promotion)",
                             time.perf_counter())
            check(c2.get("gate", {}).get("candidate_rmse") is not None
                  and c2["gate"].get("champion_rmse") is not None,
                  f"cycle 2's gate scored nothing: {c2.get('gate')}")
            if dev.type == "cuda":
                for name in ("gather_gram", "chol_solve"):
                    check(c2["launches"].get(name, 0) > 0, f"cycle 2 launched no {name}")
            doc = registry_doc()
            gen2 = [e for e in doc["generations"] if e["gen"] == 2][0]["instance_id"]
            check(doc["champion"] == 2, f"champion {doc['champion']} after cycle 2")
            answers_match(ports["deploy"], gen2, "after cycle 2's /reload")

            # the crash drill: the daemon's trainer is killed with SIGKILL
            # mid-train; the daemon restarts it, and it resumes from its
            # checkpoints and promotes generation 3 exactly once
            ok, _, _ = post_range(urls["follower"], REPL_DELTA, 8)
            check(ok, "the delta of the crash drill was not acked")
            t0 = time.perf_counter()
            token = registry_doc()["fence_token"]
            ckpt = os.path.join(homes["follower"], "train_ckpt_torch")
            deadline = time.monotonic() + 600
            while True:
                steps = [d for _, ds, _ in os.walk(ckpt) for d in ds if d.isdigit()]
                if len(steps) >= 2:
                    break
                check(daemon.poll() is None and time.monotonic() < deadline,
                      f"crash drill: no checkpoint before the kill:\n{open(dlog).read()[-3000:]}")
                time.sleep(0.01)
            killed = int(re.findall(r"\[supervise\] started pid (\d+)", open(dlog).read())[-1])
            os.kill(killed, signal.SIGKILL)
            print(f"crash drill: kill -9 of the daemon's trainer (pid {killed}) after "
                  f"{len(steps)} checkpoint steps", flush=True)
            c3 = await_cycle("promoted", 3, "crash drill (last ack to the resumed promotion)",
                             t0)
            doc = registry_doc()
            text = open(dlog).read()
            restarts = text.count("[supervise] restarting")
            left = [d for _, ds, _ in os.walk(ckpt) for d in ds if d.isdigit()]
            print(f"crash drill: {restarts} restart; generations {len(doc['generations'])}, "
                  f"champion {doc['champion']}, fencing token {token} -> "
                  f"{doc['fence_token']}; checkpoint steps left after the resumed train: "
                  f"{len(left)}", flush=True)
            check(restarts == 1 and len(doc["generations"]) == 3 and doc["champion"] == 3
                  and doc["fence_token"] > token and not left, f"crash drill: {text[-3000:]}")
            gen3 = [e for e in doc["generations"] if e["gen"] == 3][0]["instance_id"]
            out["resumed_err"] = items_err(gen3, "the resumed generation 3")
            answers_match(ports["deploy"], gen3, "after the crash drill's /reload")
            daemon.send_signal(signal.SIGTERM)
            code = daemon.wait(timeout=120)
            check(code == 0, f"the daemon stopped with {code}:\n{open(dlog).read()[-3000:]}")
            # the trainer read the follower's log while it was written: the
            # follower still equals the leader, byte for byte
            lead = file_digests(os.path.join(homes["leader"], "eventlog"))
            foll = file_digests(os.path.join(homes["follower"], "eventlog"))
            same = {k: foll.get(k) for k in lead if k.endswith(".pel")} == {
                k: v for k, v in lead.items() if k.endswith(".pel")}
            print(f"after the daemon's cycles, the follower's frame files equal the "
                  f"leader's by sha256: {same}", flush=True)
            check(same, f"follower differs after the trainer's reads: {lead}, {foll}")

            def one_shot(label: str, faults: str) -> tuple:
                """One unsupervised trainer cycle with ``faults`` armed."""
                t0 = time.perf_counter()
                proc = subprocess.run(CLI + trainer + ["--max-cycles", "1"], cwd=repo,
                                      env=dict(env["leader"], PIO_FAULTS=faults),
                                      capture_output=True, text=True, timeout=900)
                return proc.returncode, proc.stdout + proc.stderr, \
                    time.perf_counter() - t0

            # an armed train.crash exits before any publish; the refusal
            # drill's promote.regression refuses the candidate
            ok, _, _ = post_range(urls["follower"], REPL_DELTA, 8)
            check(ok, "the delta of the refusal drill was not acked")
            state = open(os.path.join(homes["follower"], "trainer.state.json")).read()
            code, text, wall = one_shot("train.crash armed", "train.crash:error=drill crash")
            print(f"train.crash armed: exit {code}, {wall:.2f} s wall", flush=True)
            check(code != 0 and "drill crash" in text
                  and len(registry_doc()["generations"]) == 3
                  and open(os.path.join(homes["follower"], "trainer.state.json")).read()
                  == state, f"the armed train.crash: {text[-3000:]}")
            # the crashed trainer kept its lease: wait out its time to live
            lease = json.load(open(os.path.join(homes["follower"], "trainer.lease")))
            time.sleep(max(0.0, float(lease["expires"]) - time.time()) + 0.1)
            code, text, wall = one_shot("refusal drill",
                                        "promote.regression:error=drill regression")
            c4 = cycles_of(text)
            doc = registry_doc()
            check(code == 0 and [(r["outcome"], r["gen"]) for r in c4] == [("refused", "4")]
                  and doc["champion"] == 3, f"refusal drill: {text[-3000:]}")
            report("refusal drill", c4[0], wall)
            # a /reload after the refusal still lands on the champion
            st, body = http_json(ports["deploy"], "GET", "/reload")
            check(st == 200, f"/reload after the refusal: {st} {body}")
            answers_match(ports["deploy"], gen3, "after the refusal and a /reload")
            urllib.request.urlopen(urls["deploy"] + "/stop", timeout=30).read()
            dp.wait(timeout=120)
            served = launch_line(open(deploy_log).read(), "kernel launches")
            print(f"the deploy's kernel launches: {served}", flush=True)
            if dev.type == "cuda":
                check(served.get("score_topk", 0) > 0, "the deploy launched no score_topk")

            # 3. failover: the port's drill, then this phase's own leader
            # killed during a live ingest through the follower
            drill_dir = os.path.join(base, "drill")
            code, text, t_drill = cli("leader", "failover", "--drill", "--events", "12",
                                      "--kill-after", "4", "--dir", drill_dir)
            proof = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
            print(f"failover --drill: {t_drill:.2f} s wall, {proof}", flush=True)
            check(proof["ok"], f"the drill failed: {proof}")
            out["drill"] = proof

            before = repl_status(urls["leader"])
            acked = []
            killed_at = None
            lo = posted[0]
            posted[0] += REPL_FAILOVER
            t0 = time.perf_counter()
            for s in range(lo, lo + REPL_FAILOVER, REPL_BATCH):
                batch = repl_events(users, items, ratings, s,
                                    min(s + REPL_BATCH, lo + REPL_FAILOVER))
                deadline = time.monotonic() + 60
                while True:
                    try:
                        st, doc, _ = post_batch(urls["follower"], batch, timeout=10)
                    except OSError:
                        st, doc = 0, None   # the dead leader behind a stale 307
                    if st == 200 and doc and all(d.get("status") == 201 for d in doc):
                        acked += [d["eventId"] for d in doc]
                        break
                    check(time.monotonic() < deadline, f"batch at {s} never acked: {st}")
                    time.sleep(0.02)
                if killed_at is None and len(acked) >= REPL_KILL_AFTER:
                    leader.send_signal(signal.SIGKILL)
                    leader.wait(timeout=30)
                    killed_at = time.time()
            t_fail = time.perf_counter() - t0
            after = repl_status(urls["follower"])
            promotion_ms = (float(after["promotedAt"]) - killed_at) * 1000.0
            lost = []

            def present(eid: str) -> bool:
                req = urllib.request.Request(
                    f"{urls['follower']}/events/{eid}.json?accessKey={REPL_KEY}")
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        return r.status == 200
                except urllib.error.HTTPError:
                    return False

            with ThreadPoolExecutor(8) as pool:
                lost = [e for e, ok in zip(acked, pool.map(present, acked)) if not ok]

            forged = urllib.request.Request(
                urls["follower"] + "/repl/apply", data=b"PELOGv2\n", method="POST",
                headers={"X-Repl-Ns": "events_1", "X-Repl-Seg": "0", "X-Repl-Offset": "0",
                         "X-Repl-Crc": "0", "X-Repl-Epoch": str(before["epoch"]),
                         "Content-Type": "application/octet-stream"})
            try:
                urllib.request.urlopen(forged, timeout=10)
                stale = 200
            except urllib.error.HTTPError as e:
                stale = e.code
            codes = fsck_both()
            bundles = _failover_bundles(os.path.join(homes["follower"], "incidents"))
            print(f"failover of this phase's leader: kill -9 after {REPL_KILL_AFTER} acked "
                  f"events, {len(acked)} acked in {t_fail:.2f} s, {len(lost)} missing on the "
                  f"promoted node; promoted {promotion_ms:.1f} ms after the kill (the node's "
                  f"own takeover {after.get('promotionMs')} ms), epoch {before['epoch']} -> "
                  f"{after['epoch']}; a stale-epoch apply got {stale}; fsck {codes}; "
                  f"{len(bundles)} failover bundle(s)", flush=True)
            check(not lost and len(acked) == REPL_FAILOVER, f"acked events lost: {lost[:10]}")
            check(after["role"] == "leader" and after["epoch"] > before["epoch"],
                  f"no promotion: {after}")
            check(stale == 412, f"the stale-epoch apply got {stale}")
            check(codes == {"leader": 0, "follower": 0}, f"fsck exit codes {codes}")
            check(len(bundles) == 1, f"{len(bundles)} failover bundles")
            out.update(promotion_ms=promotion_ms, node_promotion_ms=after.get("promotionMs"),
                       failover_events_s=REPL_FAILOVER / t_fail)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
    launches = {name: sum(c["launches"].get(name, 0) for c in out["cycles"])
                + served.get(name, 0)
                for name in ("score_topk", "gather_gram", "chol_solve", "rows_gram")}
    wall = time.perf_counter() - t_phase
    print(f"phase 18: {wall:.1f} s wall; kernel launches of the trainers and the deploy "
          f"{launches} ({card_line() if dev.type == 'cuda' else 'cpu'})", flush=True)
    out["launches"], out["wall"] = launches, wall
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from predictionio_tpu_torch import ops
    from predictionio_tpu_torch.ops import _build

    quick = "--quick" in argv
    topk_only = "--topk" in argv
    ops_only = "--ops" in argv
    templates_only = "--templates" in argv
    ann_only = "--ann" in argv
    classification_only = "--classification" in argv
    universal_only = "--universal" in argv
    eventlog_only = "--eventlog" in argv
    storage_only = "--storage" in argv
    replication_only = "--replication" in argv
    global PROFILE_STEPS
    PROFILE_STEPS = "--profile" in argv
    dev = torch.device("cuda", 0)

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2. build")
    t0 = time.perf_counter()
    _build.build(ops.KERNELS)
    print(f"{len(ops.KERNELS)} kernels built in parallel in "
          f"{time.perf_counter() - t0:.2f} s ({' '.join(_build.NVCC_FLAGS)})",
          flush=True)
    for name in ops.KERNELS:
        info = _build.BUILD_INFO.get(name)
        if info is None:
            print(f"{name}: library already on disk, not rebuilt", flush=True)
            continue
        print(f"{name} built in {info['seconds']:.2f} s", flush=True)
        print(info["log"].strip(), flush=True)

    if replication_only:
        phase("18. the replicated event plane and the continuous trainer at ML-20M width")
        replication_full_width(torch, ops, dev)
        phase("done")
        return 0

    if storage_only:
        phase("17. every repository on ELASTICSEARCH at ML-20M width")
        storage_full_width(torch, ops, dev)
        phase("done")
        return 0

    if eventlog_only:
        phase("16. the EVENTLOG backend at ML-20M width")
        eventlog_full_width(torch, ops, dev)
        phase("done")
        return 0

    if universal_only:
        phase("15. the universal and sequential templates at full width")
        universal_sequential_full_width(torch, ops, dev)
        phase("done")
        return 0

    if classification_only:
        phase("14. classification and e2 at full width")
        classification_full_width(torch, ops, dev, witness=True)
        phase("done")
        return 0

    if ann_only:
        phase("13. ANN and the two-tower template at full width")
        ann_full_width(torch, ops, dev, None, "--profile" in argv)
        phase("done")
        return 0

    if templates_only:
        phase("5. full-width training (ML-20M shape, rank 64)")
        train = train_full_width(torch, ops, dev)
        phase("12. the ALS family at ML-20M width")
        templates_full_width(torch, ops, dev, train)
        phase("done")
        return 0

    if ops_only:
        phase("5. full-width training (ML-20M shape, rank 64)")
        train = train_full_width(torch, ops, dev)
        phase("10. the engine server's operations surface at ML-20M width")
        with tempfile.TemporaryDirectory(prefix="pio_chip_ops_") as home:
            ops_surface(torch, ops, dev, home, train)
        phase("11. the engine server's online loop at ML-20M width")
        with tempfile.TemporaryDirectory(prefix="pio_chip_online_") as home:
            online_loop(torch, ops, dev, home, train)
        phase("done")
        return 0

    phase("3. kernels against their plain versions")
    main_err = check_score_topk(torch, ops, dev)
    if not topk_only:
        gram_err = check_gather_gram(torch, ops, dev)
        solve_err = check_chol_solve(torch, ops, dev)
        rows_err = check_rows_gram(torch, ops, dev)
    if quick:
        return 0

    phase("4. score_topk timing")
    times = time_score_topk(torch, ops, dev)
    if "--profile" in argv:
        profile_score_topk(torch, ops, dev)
    if topk_only:
        phase("done")
        return 0

    phase("5. full-width training (ML-20M shape, rank 64)")
    train = train_full_width(torch, ops, dev)

    phase("6. gather_gram, chol_solve and rows_gram at the training path's shapes")
    ttimes = time_training_kernels(torch, ops, dev, train)
    rows = time_rows_gram(torch, ops, dev, train)
    if "--profile" in argv:
        profile_training(torch, dev, train)

    phase("7. the quickstart through the port's CLI and HTTP")
    quickstart_through_cli(torch, ops, dev)

    phase("8. Recommendation engine served at ML-20M width (trained factors)")
    with tempfile.TemporaryDirectory(prefix="pio_chip_smoke_") as home:
        launches, per_bucket, wide = drive_server(torch, ops, dev, home, train["U"],
                                                  train["V"])
    # what the serving kernel loses on phase 8's traffic: each dispatch at
    # its bucket's phase-4 time less its bound
    loss = 0.0
    for (bucket, _), n in sorted(per_bucket.items()):
        t = times.get((bucket, AOT_TOPK))
        check(t is not None, f"phase 4 has no time for serving bucket {bucket}")
        loss += n * (t["ms"] - t["bound_ms"])
        print(f"score_topk serving bucket={bucket:2d} dispatches={n} "
              f"ms={t['ms']:.4f} bound_ms={t['bound_ms']:.5f} "
              f"lost_ms={n * (t['ms'] - t['bound_ms']):.4f}", flush=True)
    print(f"score_topk lost over phase 8's queries: {loss:.4f} ms "
          f"(sum of dispatches x (time - bound))", flush=True)
    wide_loss = 0.0
    for (bucket, k, _), n in sorted(wide["per_k"].items()):
        t = times.get((bucket, k))
        check(t is not None, f"phase 4 has no time for bucket {bucket} at k={k}")
        wide_loss += n * (t["ms"] - t["bound_ms"])
        print(f"score_topk serving (num > 32) bucket={bucket} k={k} dispatches={n} "
              f"ms={t['ms']:.4f} bound_ms={t['bound_ms']:.5f} "
              f"lost_ms={n * (t['ms'] - t['bound_ms']):.4f}", flush=True)
    print(f"score_topk lost over the num > 32 sub-run: {wide_loss:.4f} ms over "
          f"{wide['launches']} launches, p50 {wide['p50_ms']:.3f} ms", flush=True)

    phase("9. pio eval at ML-20M width (distributed sweep, rank 64)")
    evals = eval_full_width(torch, ops, dev, train)

    phase("10. the engine server's operations surface at ML-20M width")
    with tempfile.TemporaryDirectory(prefix="pio_chip_ops_") as home:
        surface = ops_surface(torch, ops, dev, home, train)
    phase("11. the engine server's online loop at ML-20M width")
    with tempfile.TemporaryDirectory(prefix="pio_chip_online_") as home:
        online = online_loop(torch, ops, dev, home, train)
    phase("12. the ALS family at ML-20M width")
    family = templates_full_width(torch, ops, dev, train)
    phase("13. ANN and the two-tower template at full width")
    ann = ann_full_width(torch, ops, dev, train, "--profile" in argv, TT_RUN_CHECK_STEPS)
    phase("14. classification and e2 at full width")
    classification_full_width(torch, ops, dev, train["coo"])
    phase("15. the universal and sequential templates at full width")
    universal = universal_sequential_full_width(torch, ops, dev, train["coo"], cli=False)
    phase("16. the EVENTLOG backend at ML-20M width")
    eventlog = eventlog_full_width(torch, ops, dev, train["coo"], EVENTLOG_RUN_DRAWS)
    phase("17. every repository on ELASTICSEARCH at ML-20M width")
    es = storage_full_width(torch, ops, dev, train["coo"], STORAGE_RUN_DRAWS)
    phase("18. the replicated event plane and the continuous trainer at ML-20M width")
    repl = replication_full_width(torch, ops, dev, train["coo"], REPL_RUN_DRAWS,
                                  REPL_RUN_TAIL)
    phase("done")

    main = times[BATCH_MAX, AOT_TOPK]
    gram, solve = ttimes["gather_gram"], ttimes["chol_solve"]
    print(json.dumps({"kernels": [{
        "name": "score_topk", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/score_topk.cu",
        "replaces": "predictionio_tpu/ops/topk.py:278",
        "launches": launches["score_topk"], "max_abs_err": main_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "launches_k_gt_32": wide["launches"],
        "launches_phase10_load": surface["load_launches"],
        "launches_phase10_reload": surface["reload_launches"],
        "launches_phase11": online["launches_phase11"],
        "launches_phase12": family["launches"]["score_topk"],
        "launches_phase13": ann["launches"]["score_topk"],
        "launches_phase15": universal["launches"]["score_topk"],
        "launches_phase16": eventlog["launches"]["score_topk"],
        "launches_phase17": es["launches"]["score_topk"],
        "launches_phase18": repl["launches"]["score_topk"],
        "k_gt_32": [{"k": k, "B": B, **{key: times[B, k][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}} for B, k in BAR_CELLS],
        "batchpredict": [{"k": k, "B": B, **{key: times[B, k][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            for B, k in BATCHPREDICT_CELLS],
    }, {
        "name": "gather_gram", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/gather_gram.cu",
        "replaces": "predictionio_tpu/ops/gram.py:203",
        "launches": train["launches"]["gather_gram"],
        "launches_eval": evals["launches"]["gather_gram"],
        "launches_phase12": family["launches"]["gather_gram"],
        "launches_phase13": ann["launches"]["gather_gram"],
        "launches_phase15": universal["launches"]["gather_gram"],
        "launches_phase16": eventlog["launches"]["gather_gram"],
        "launches_phase17": es["launches"]["gather_gram"],
        "launches_phase18": repl["launches"]["gather_gram"], "max_abs_err": gram_err,
        "ms": gram["ms"], "plain_ms": gram["plain_ms"],
        "bound_ms": gram["bound_ms"], "bound_by": gram["bound_by"],
        "library_ms": gram["library_ms"],
    }, {
        "name": "chol_solve", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/chol_solve.cu",
        "replaces": "predictionio_tpu/ops/cholesky.py:315",
        "launches": train["launches"]["chol_solve"],
        "launches_eval": evals["launches"]["chol_solve"],
        "launches_phase12": family["launches"]["chol_solve"],
        "launches_phase13": ann["launches"]["chol_solve"],
        "launches_phase15": universal["launches"]["chol_solve"],
        "launches_phase16": eventlog["launches"]["chol_solve"],
        "launches_phase17": es["launches"]["chol_solve"],
        "launches_phase18": repl["launches"]["chol_solve"], "max_abs_err": solve_err,
        "ms": solve["ms"], "plain_ms": solve["plain_ms"],
        "bound_ms": solve["bound_ms"], "bound_by": solve["bound_by"],
        "library_ms": solve["library_ms"],
    }, {
        "name": "rows_gram", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/rows_gram.cu",
        "replaces": "predictionio_tpu/ops/gram.py:73",
        "launches": rows["launches"],
        "launches_phase15": universal["launches"]["rows_gram"],
        "launches_phase16": eventlog["launches"]["rows_gram"],
        "launches_phase17": es["launches"]["rows_gram"],
        "launches_phase18": repl["launches"]["rows_gram"], "max_abs_err": rows_err,
        "ms": rows["ms"], "plain_ms": rows["plain_ms"],
        "bound_ms": rows["bound_ms"], "bound_by": rows["bound_by"],
        "library_ms": rows["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
