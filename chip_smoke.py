#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_jni_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR] [--profile] [--queries-only]
                          [--rows-only] [--native-only]

In order, it:

1. prints the card (``nvidia-smi --query-gpu=name,power.limit``) and
   builds the CUDA kernels K1-K7 from ``spark_rapids_jni_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together), timing
   the build;
2. holds each kernel against its plain PyTorch version on the card at
   stress shapes (exact equality required): K1 with 15,811 build and 10M
   probe rows, K2 with 10M rows at widths 8192 and 10 and values near
   +-2^63, K3 with 10M + 7 rows (once from a 16-byte boundary, once 5
   bytes past one) and its table form on the validity bytes of a
   12M-row, 32-field row matrix and of a 1M-row, 1500-field one;
3. generates the TPC-DS miniature at sf=1000, seed 7 (a 10,000,000-row
   store_sales), ingests it on the card once and runs q1-q10
   through ``run_fused``, with every kernel launch count set to 0 just
   before and read just after; per query it prints the time, the rows,
   the route counters, the counted host syncs and the synchronising CUDA
   calls that ``torch.cuda.set_sync_debug_mode("warn")`` reports, then
   the warm time (median of 3);
4. runs q1-q10 once more, recording the inputs of every kernel call,
   and holds each kernel against its plain version on exactly those
   inputs (exact equality required);
5. requires every result to equal the port's pandas oracle (integers
   and decimals exact, floats within rtol=1e-9, atol=1e-9: atomic float
   sums change the accumulation order), ``rel.fused_fallbacks == 0``, at
   most one counted host sync a query and at least one launch of each
   of K1-K3 during q1-q10; then steps 3-5 again for q11-q20 (string,
   decimal and window operators) on the same ingested tables, its own
   path; it also requires q15's ``rel.route.decimal.overflow`` to equal
   the oracle's count of rows whose DECIMAL32 product passes 2^31 - 1,
   and q11, q12 and q20 to equal their oracles once more on
   ``SRT_STRING_ROUTE=bytes``;
6. hashing (BASELINE config 1): a seeded 10,000,000-row table of int32,
   int64, float64, float32, bool, date32, decimal64, decimal128 and a
   0-32-byte UTF-8 STRING column, 10% nulls each, the floats with +-0.0,
   +-inf and NaNs of three payloads. With the counts set to 0 just
   before, it runs ``murmur3_table`` (four K4 and three K5 launches),
   ``xxhash64_table``, ``hive_hash_table`` (over the columns HiveHash
   takes: no decimals) and ``murmur3_table`` over store_sales'
   (ss_item_sk, ss_customer_sk) from step 3 (two K5 launches), and
   reads the counts just after. It requires every K4/K5 call to equal
   its plain version on its inputs, the first 1,000,000 rows of every
   hash to equal the same call with the table on the CPU, and every
   valid NaN row of a float column to hash like the canonical NaN; it
   prints rows/s of each table hash;
7. the aggregation and date roster, six phases, each with the launch
   counts set to 0 just before it runs once and read just after, every
   K3 call recorded and held against its plain version (exact), its
   warm wall time (median of 3) and rows/s printed beside K3's device
   time, and the step's seconds on a line of its own:
   (a) ``groupby_aggregate`` of store_sales by ss_item_sk: var and std
   of ss_net_profit, first, last and nunique of ss_customer_sk, any and
   all of ss_quantity > 10, equal to a pandas oracle (integers and bools
   exact, var/std within rtol=1e-9, first/last in input order), and a
   count by the STRUCT key (ss_store_sk, ss_promo_sk) equal to the count
   by the two flat keys; K3 packs the six nullable results' validity;
   (b) ``convert_to_rows_nested`` and ``convert_from_rows_nested`` of
   1,000,000 seeded rows (the eight TestTables types,
   STRUCT<INT32, FLOAT64, STRING 0-32 B>, LIST<INT64> of 0-8 elements,
   STRUCT<STRUCT<INT16, DECIMAL64>, INT64>; 1% nulls at every node):
   the round trip exact (NaN payloads byte for byte), K3's table form
   launched once for the 18 nodes' validity;
   (c) a bloom filter at Spark's runtime-filter defaults (8,388,608
   bits, k = 6) over 1,000,000 distinct build keys (every ss_customer_sk
   value and seeded int64s), probed with the build keys, the 10M
   ss_customer_sk values (no false negative) and 10M absent keys (the
   false-positive share printed beside its theoretical value); the words
   equal the same build on the CPU; K3 packs the bit plane;
   (d) HLL++ ``groupby_reduce`` of ss_customer_sk by ss_store_sk at
   precision 9, ``estimate_column`` and ``reduce`` over the column: the
   sketch words equal the CPU's on the first 1,000,000 rows, every
   estimate of a group with at least 1,000 distinct values within
   4 x 1.04 / sqrt(512) of the exact count;
   (e) every datetime extractor, ``truncate`` on every unit and
   ``add_interval_days`` over 10M seeded TIMESTAMP_MICROSECONDS of the
   years 0001-9999 (0001-01-01, 9999-12-31, the 1582-10-04/15 switch
   and pre-epoch values mixed in), and both rebases over their days:
   equal to the CPU on the first 1,000,000 rows and to Python's
   ``datetime`` on 10,000 sampled rows;
   (f) ``convert_utc_to_timezone`` and ``convert_timezone_to_utc`` of
   those timestamps in America/Los_Angeles, Europe/Berlin and
   Asia/Kolkata (the TZif files are required): equal to the CPU on the
   first 1,000,000 rows and to ``zoneinfo`` on the sampled rows up to
   the transition table's horizon, the year 2200;
8. the cast and string-function roster, seven phases run as the roster's
   are (launch counts set to 0 just before each and read just after,
   every K3 call recorded and held against its plain version, warm wall
   time, rows/s and peak memory allocated beside K3's device time), each
   call's first 1,000,000 rows equal to the same call on the CPU:
   (a) ``cast_integer_to_string`` of store_sales' ss_item_sk and
   ss_customer_sk and of seeded int64 over the full range (the edges
   mixed in), 10% nulls, 1% of the strings each wrapped in whitespace,
   '+' or a fraction or replaced by an overflow, an empty string or
   garbage; ``cast_to_integer`` to INT64, INT32 and INT8, ANSI on an
   all-valid column, ``conv`` 10 -> 16 -> -10: int -> string -> int
   exact, and Spark's grammar and NumberConverter's rules on 10,000
   sampled rows; (b) ``cast_float_to_string`` of float64 and float32
   random bit patterns (every exponent, subnormals, specials), 1% each
   of five literal forms mixed in, ``cast_to_float`` back (NaN and the
   infinities exact, the other rows' ulps from their source counted),
   and on 10,000 sampled rows Java's layout of Python's shortest digits,
   the reference's arithmetic bit for bit, and the exact round trip
   where that arithmetic rounds once; (c) ``cast_decimal_to_string`` of seeded
   DECIMAL64 at scale -2, ``cast_to_decimal`` at -2 (exact), at 0
   (HALF_UP, every row) and to DECIMAL32 (NULL exactly on overflow);
   (d) the roster's 10M timestamps as strings in every form Spark reads
   (yyyy to fractions of 0-6 digits, ' ' or 'T', Z, offsets, UTC, a
   region id), ``cast_to_date`` and ``cast_to_timestamp`` in UTC and
   America/Los_Angeles against ``datetime``/``zoneinfo`` on 10,000
   sampled rows; (e) 10,000,000 composed URLs of up to 96 bytes (1% with
   a forbidden byte or a bad escape) through ``parse_url`` for its
   eight parts and QUERY with a key, against the parts they were
   composed of; (f) the hashing step's STRING column through
   ``regexp_contains`` and ``regexp_full_match`` with six patterns of
   the device subset (no host route taken) against Python's ``re``; (g)
   on a 100,000-row head, a backreference through the host route,
   ``regexp_extract`` and ``format_number`` of float64, INT64 and
   DECIMAL64 at d = 0, 2 and 5;
9. roster II, five phases run as the strings step's are (launch counts
   set to 0 just before each and read just after, every K3 call recorded
   and held against its plain version, warm wall time, rows/s and peak
   memory allocated beside K3's device time, the synchronising CUDA
   calls of a run and the host-route counters printed), each call's
   first 1,000,000 rows (an aggregation: the call on the first 1,000,000
   input rows) equal to the same call on the CPU: (a) over store_sales
   with the hashing step's STRING column and a STRUCT (ss_store_sk,
   ss_promo_sk), 10% NULL quantities and profits: ``apply_boolean_mask``
   by ss_quantity > 10, ``slice_rows``, ``concatenate`` of two halves
   (equal to the table), ``if_else``, a four-branch ``case_when`` and
   ``coalesce``, equal to numpy on every row; (b) ``interleave_bits`` of
   four 10M-row INT32 columns with 10% nulls and ``hilbert_index`` at
   k = 3 x 21 and k = 2 x 31 bits, equal to bit-by-bit oracles on 10,000
   sampled rows; (c) by ss_item_sk: ``group_percentile`` of
   ss_net_profit at p = 0, 0.25, 0.5, 0.99, 1 equal to pandas' linear
   quantile (rtol 1e-12), ``group_histogram`` of ss_quantity equal to
   pandas' counts, ``merge_histograms`` of the halves equal to the whole,
   ``percentile_from_histogram`` equal to ``group_percentile``, and
   ``percentile_approx`` of a t-digest (delta = 100) merged from halves
   within the k1 rank bound of each group's exact rank; (d)
   ``get_json_object`` with nine paths over 10,000,000 seeded documents
   of 16-128 bytes built on the card (nested objects and arrays, four
   whitespace styles, 1% escapes, 1% malformed, 10% NULL), equal to the
   port's Python walker on 10,000 sampled rows, the escape rows on the
   host unescape route and none on the Python walker; (e)
   ``from_json_to_map`` and ``get_map_value`` on a 100,000-row head of
   those documents, equal to Python's ``json`` on every row;
10. the mesh: one NCCL process group of one rank (``init_method=file://``
   under ``target/``, ``NCCL_SOCKET_IFNAME=lo`` and ``NCCL_IB_DISABLE=1``
   unless set) and a ``part`` mesh of size 1 on the card; one NCCL rank
   a card, so every route and every collective runs, through NCCL, at
   world size 1. With the launch counts set to 0 just before and read
   just after, it runs q1-q20 through ``run_fused(plan, rels,
   mesh=mesh)`` on step 3's tables at the default threshold, then the
   queries whose routes a knob changes again with it forced
   (``MESH_PASSES``: ``SRT_BROADCAST_THRESHOLD=8192``, the reference
   test's, with the auto, ``exchange`` and ``reduce_scatter`` join
   routes, and the ``exchange`` route with q1's groupby merged whole
   (its all_gather); ``SRT_GROUPBY_PSUM_WIDTH=1``;
   ``SRT_SHUFFLE_SCRATCH_BYTES`` 64 MiB), then ``shuffle_table`` of the hashing step's 10M-row table
   (the STRING column through the torch route) and of a 1M-row
   TestTables table (K6 and K7), keyed by an INT32 and an
   INT64 column (K4 and K5). It requires every query result to equal the
   pandas oracle and the single-device result (integers exact, floats
   within rtol=atol=1e-9), ``rel.dist_fallbacks == 0``, at most one
   counted host sync a query, each of the routes in ``MESH_ROUTES``
   counted, each shuffled table equal to its input row for row with
   overflow 0, and each of K1-K6 launched; every kernel call is recorded
   and held against its plain version (exact). Per query it prints the
   warm time (median of 3) beside the single-device warm time, the peak
   memory allocated over its warm runs (resident tables included), the
   route and ``shuffle.*`` counters and the synchronising CUDA calls
   (under ``--profile`` also the device time of the NCCL kernels), and
   the step's peak memory allocated;
10b. the serving step, with ``SRT_METRICS`` on, on step 3's tables and
   step 10's mesh: q1-q20 through ``run_fused`` serially three times (the
   baseline; the peak memory allocated reset before each query), then
   served three times by ``QueryExecutor(device=cuda, max_queue=8,
   max_in_flight=16)``, one request a query submitted from the main
   thread while the oldest results decode, the launch counts set to 0
   just before the first pass and read just after, and once more
   recording every kernel call (held against its plain version, exact).
   It requires every served result to equal the pandas oracle and the
   serial result, one ExecutionReport a served query under its handle's
   qid with at most one host sync, provenance ``eager`` and the device's
   ``mem.device.0.*`` watermarks, and K1-K3 launched; it prints each
   query's serial median beside the served execute and latency medians,
   the report's modeled peak beside the measured per-query peak, both
   passes' wall times, the q3 report in full, and whether the kernel
   library's build was recorded as a compile event. Then: q1-q10's
   tables ingested again with ``SRT_RESULT_CACHE_BYTES`` 1 GiB and q1-q10
   served twice on each tier (whole entries on the card,
   ``SRT_PAGE_POOL_BYTES=0``; host pages, the pool at 1 GiB): the second
   pass must hit (provenance ``result_cache``), launch no kernel and
   count no host sync, and equal the oracle. On the paged tier every
   resident page must be pinned host memory and no entry may hold a CUDA
   tensor; q1-q10 hit once more through ``run_fused`` on this thread
   must launch no kernel and make no synchronising call before any
   decode, give new CUDA tensors, and equal the oracle although the
   cache is dropped and fresh pinned buffers of its sizes written over
   while the uploads may be in flight; each hit's ms (to return, and to
   the upload's end) is printed beside the whole tier's. A pass at a cap
   of half the bytes q1-q10 charge must count ``page_evictions``, the
   stripped or dropped entries missing and the rest hitting equal to the
   oracle. A one-row change of store_sales must miss, and so must q3 on
   equal sf=2 content filled on the card and run on the CPU. With
   ``SRT_FAULTS``-style injections (``dispatch:raise:1,alloc:retry_oom:1``)
   two requests reject with ``InjectedFault`` and ``RetryOOM``
   (``retry_action``: ``retry``, ``retry_oom``; ``serving.failed``) and
   the next serves; ``block=False`` on a full queue raises ``queue.Full``
   (``serving.rejected``); ``obs/server.py`` on port 0 serves
   ``/metrics`` (parsed; ``serving.completed``, ``serving.slo.*``,
   ``mem.device.0.*``), ``/healthz`` (200) and ``/reports?n=3`` (the three
   newest); and q1-q20 served once over the mesh at threshold 8192 with
   the ``exchange`` join route (launch counts from 0, every call
   recorded) must equal the oracle and the one-device results, each
   report's ``shuffle`` section its ``shuffle.*`` counters, with K5
   launched on the shuffle-hash joins' keys; it prints the scratch
   budget the ranks agreed;
10t. the trace-range step: q3 on step 3's tables (sf=1000), the result
   cache skipped, once under ``SRT_TRACE_ENABLED=1`` and once with it
   off, each inside ``torch.profiler`` (Chrome traces under
   ``target/trace_ranges/``): the first must hold ``srt::`` ranges (the
   spans' and ``traced`` ops' ``record_function`` ranges) with hand
   kernels inside them (their launching call, matched by correlation id,
   in a range of its thread), the second no ``srt::`` range; both
   results equal the oracle;
10c. the batched serving step, with ``SRT_METRICS`` on and the result
   cache off, on step 3's tables and ``rels_b``: the same tables but
   store_sales ingested again from its frame with ss_net_profit rotated
   by 3,333,333 rows (the same fingerprint, other answers where a query
   reads it). (a) Each of q1-q20 runs in the window ``[rels, rels_b,
   rels]`` through ``run_fused_batched`` (k=3, the padded route's
   capacity 4): the cold window captures the batch program into a CUDA
   graph, three warm windows replay it; the launch counts are set to 0
   before q1's first window and read after q20's last, and the batch
   cache is cleared after each query (its graphs, pools and buffers
   freed). It requires every slot to equal the serial ``run_fused`` of
   its rels (integers exact, floats rtol=atol=1e-9) and slot 0 the
   oracle; a warm window one ``rel.fused_batch_program``, one counted
   host sync and no other synchronising CUDA call, provenance
   ``warm_memory`` and ``rel.route.serving.batched == 3``; the cold
   window provenance ``cold_compile`` with one compile event (the
   capture); q1-q10 to replay a graph (a query of q11-q20 that cannot is
   printed with its ``BatchIncompatible`` reason, route-counted
   ``rel.batch.fallbacks``); K1, K2 and K3 launched inside the captured
   programs. Per query it prints the warm window's ms (median of 3)
   beside the sum of its three slots' serial ms, the cold window's and
   the capture's ms, the hand-kernel launches of one replay, the static
   buffer bytes (store_sales' four slots; the shared tables are read in
   place) and the peak memory allocated. (b) q1-q10's windows once
   more with the batch program run eagerly (no capture), every kernel
   call recorded and held against its plain version (exact), each slot
   equal to the replayed one. (c) q3's window on the ragged route with
   ``SRT_PAGE_POOL_BYTES`` 4 GiB (the three 880 MB store_sales slots need
   3 GiB) must count ``rel.route.batch.ragged`` and report the effective
   capacity; with a pool of one page it must count
   ``rel.batch.pool_degraded`` and serve padded. (d) A ``FleetScheduler``
   with tenants ``gold`` (priority 1, weight 3) and ``bronze`` (0, 1), two
   workers and a 20 ms window takes bursts of 32 submissions each of q9
   and q17, half from each tenant, at ``SRT_BATCH_MAX=16`` and at 1 (two
   warm-up bursts first): every result equal to the serial one, the
   per-tenant counters, and at 16 ``serving.batch.formed >= 1`` with a
   window of 16; it prints each query's p50 and p99 latency, the
   burst's queries/s and its windows' sizes (and how many captured) both
   ways. Then bursts of 16 q9 under
   ``batch:raise:1`` (``serving.batch.fallback``), ``batch:split_oom:1``
   (``serving.fault.oom.split``) and ``worker:crash:1``
   (``serving.fault.worker_restarts == 1``, the queries requeued), each
   query served and equal, and a q9 queued behind q19 with a 1 ms
   deadline must raise ``QueryExpired``. (e) A ``FleetScheduler`` with two
   workers and ``SRT_BATCH_MAX=4`` serves q1-q20, three submissions each
   (``rels``, ``rels_b``, ``rels``), in two rounds, and the batch cache
   is not cleared: every result equal to its serial one and none failed;
   after each round it prints the memory allocated and reserved, the
   cache's entries and the bytes they charge, and the evictions (by the
   card's headroom, by an out-of-memory error, by count);
10d. the fleet-control step (it runs between 10b and 10c, while step
   10's process group is open), on step 3's tables, with
   ``SRT_CONTROL_PLANE=1`` (``SRT_CONTROL_MIN_SAMPLES=4``),
   ``SRT_METRICS``, threshold 8192 and the ``exchange`` join route: a
   ``FleetScheduler`` with tenants ``gold`` (priority 10, weight 3) and
   ``bronze`` (0, 1) over ``make_mesh_2d(n_part=1, n_replica=1)`` (one
   replica slice on the one NCCL rank) serves q1-q20, the tenants
   alternating, each with a deadline, the launch counts set to 0 just
   before and read just after, then q1-q20 once more recording every
   kernel call (held against its plain version, exact). It requires
   every result to equal the oracle and step 10b's serial result, K1,
   K2, K3 and K5 launched; a burst of 8 gold q9 with 1 ms deadlines must
   shed at admission, each counted ``serving.shed.predicted``; with the
   ``control`` fault seam armed once, the next such q9 must be admitted
   (the shed loop latched, ``serving.control.telemetry_errors`` and
   ``serving.control.fallback.shed`` 1) and served equal to the oracle.
   Then a ``FleetRollup`` over this process's scrape endpoint and a
   child process's (tenant ``child``, two samples) scrapes 4 times: both
   members up, ``/fleet/healthz`` 200, the merged ``/slo.json`` holding
   both processes' keys, a history snapshot a scrape under
   ``target/fleet-history-<pid>`` read back, and the regression watch
   over the ring printed;
11. the morsel step (out-of-core execution, ``exec/``): the four fact
   tables of step 3's frames (1,346,648,000 bytes) become host tables
   and the dimensions stay on the card. It prints one plain copy of
   1 GiB from pinned memory to the card (the host link's rate) and runs
   q1-q10 through ``run_morsels`` (``run_fused``'s out-of-core route) in
   three passes: 8 morsels with ``SRT_PAGE_POOL_BYTES`` 1 GiB (the paged
   route: 13 morsels, capacities 1,048,576 / 262,144 / 262,144 / 131,072
   rows), 8 morsels with the pool off (whole-buffer staging), and sized
   to ``SRT_MORSEL_BYTES`` 256 MiB; then the default probe's verdict on
   q1; the delta pass (a host table of store_sales' first 9,000,000
   rows runs q3 at 256 MiB, ``rel_append`` adds the rest, q3 again must
   fold one morsel, provenance delta); the four facts written to
   Parquet under ``target/`` in 1,048,576-row groups and q1, q3, q9
   streamed from them, and q3 over store_sales sorted by
   ss_sold_date_sk with a ``between`` filter on a fifth of the dates
   (the zone maps must skip); q3, q9 and q10 at 4 morsels over a
   one-rank NCCL mesh; q11-q20 with the facts streamed (the queries that
   fall back in-core are printed with their reasons). With the launch
   counts set to 0 just before and read just after, it runs the paged
   pass once more (its entries warm), then records that pass's kernel
   calls and holds each against its plain version (exact). It requires
   every result to equal the pandas oracle (q1-q10 also the in-core
   single-device result; floats within rtol=atol=1e-9), no
   ``rel.morsel_fallbacks`` on q1-q10, ``exec.morsel.folded`` of at
   least the morsel count, at most one counted host sync a query, no
   more synchronising CUDA calls in a warm streamed query than in its
   in-core run, and K1-K3 each launched. Per query and pass it prints
   the streamed warm time (median of 3) beside the in-core one, the
   morsel count, capacities, window and accumulator bytes, the bytes
   staged for the card and their rate over the query,
   ``exec.morsel.overlap_ns``, the peak memory allocated above the
   step's base beside ``exec.morsel.peak_model_bytes``, and under
   ``--profile`` the device's idle share over the warm query;
11b. the warm-disk restart: two child processes at sf=10 sharing
   ``SRT_AOT_CACHE_DIR`` under ``target/``. The cold one builds the
   kernel library into the disk tier and runs one
   window of three of q3 and of q9, each captured (provenance
   ``cold_compile``, noted in the capture manifest); the warm one, whose
   ``nvcc`` lookup raises, binds the library from the disk tier, calls
   ``warm_disk`` and runs
   the same windows: each must report ``warm_disk`` with no build; every
   slot equal to the serial run. It prints each first window's time in
   both processes;
11c. the tune step: the tuner (``tune/runner.py``) over the ``pipeline``
   workload on step 3's tables (q3 at sf=1000, the main path's scale)
   with the candidates of ``SRT_JOIN_METHOD`` and ``SRT_DENSE_GROUPBY``:
   one oracle run each under deterministic algorithms, held byte for
   byte against the default's, then one warm-up and five timed samples
   with the mode off, as production runs; a candidate replaces the
   default only when it beats it by more than the larger of their
   spreads. It prints every candidate's best time and spread (or its
   oracle reject), stores the winners under ``target/``, requires a
   fresh process to read them with one disk read and no measurement,
   and runs q3 under the winners once counted and once recorded (each
   kernel call held against its plain version), equal to the oracle;
12. row conversion (BASELINE config 2, the 32-column ``TestTables.java``
   schema, 200-byte rows): 1,000,000 rows all valid; 1,000,000 rows with
   1% nulls per column; 12,000,000 rows with nulls (two batches below
   2 GB: 10,737,408 and 1,262,592 rows); 1,000,000 rows plus two
   nullable STRING columns (the torch route); 1,000,000 rows of the
   schema repeated 13 times (104 columns, 1% nulls). With the counts set
   to 0 just before ``convert_to_rows`` of the five and
   ``convert_from_rows`` of each of their batches, and read just after,
   it requires K6 and K7 to have been launched once per batch of the
   four fixed-width tables, K3's table form once per batch of the STRING
   table, each K6, K7 and K3 call to equal its plain version exactly,
   and ``convert_from_rows`` to give back every valid value (float NaN
   payloads byte for byte) and every validity bit; it prints ms and GB/s
   of row bytes both ways, and each conversion's wall time beside the
   device time of its K6 (to rows) or K7 / K3 (from rows) calls (the
   rest is host work, other kernels and idle card); after the native
   step it times the native engine's one-thread-a-row
   ``unpack_rows_kernel`` at K7's shapes (12M rows x 32 columns, 1M x
   104) as a yardstick (``--rows-only`` runs this step and that
   yardstick alone);
13. the native bridge (``native.py`` and its library; ``--native-only``
    runs this step alone): the library builds with ``nvcc`` (every source
    at once) on a thread beside steps 1-3, which then runs a CPU child
    (``--native-child``) that binds it with no engine
    (``native.load(device="cpu")``) and computes the host route of every
    entry point on seeded tables: 10M rows of int32, int64, timestamp,
    decimal64, float32 and float64 (floats with +-0.0, +-inf and NaN
    payloads) for the hashes, the ``TestTables`` schema x 4 at 1M and 12M
    rows with no validity (12M crosses the host route's 2 GB batch
    split), a 10M-row sort on an int32 key descending and an int64 key,
    a 10M-left x 1M-unique-right int64 join (80% hits), and 10M-row
    groupbys with 6,324 groups (two keys) and 1M groups, four value
    columns each. Here, with the engine started on the card and the
    launch counts set to 0 just before and read just after, every route
    runs once both ways, as host tables and as resident handles
    (``DeviceTable``/``DeviceBuffer``, ``then`` and ``from_rows`` on
    resident buffers): each must read sentinel 1 and equal the child's
    result (hashes, permutations, pairs, group reps, sizes and integral
    aggregates exactly, row bytes and decoded columns by sha256, float
    aggregates within rtol=1e-9), and the engine must have launched K4
    5 times, K5 8 times and K6 5 times. It prints each route's ms both
    ways (host clock, each call draining the engine's stream; median of
    10, of 3 for the 12M-row host-table row routes), rows/s, the byte
    bound and the child's host-route ms (one run), requires every native
    and engine handle freed, and holds the engine's K4/K5/K6 launches,
    as wrapper calls on the same inputs, against their plain versions.
    Before the routes, the JVM's face: the mock-``JNIEnv`` driver
    ``tests/torch_jni_engine_driver.cpp``, built with the host's ``g++``
    against the library beside steps 1-3, runs in a child: a
    ``Hashing.murmurHash3`` over 1M INT32/INT64 rows before
    ``PjrtEngine.init`` (the host route, sentinel 0), then init on device
    0, ``isAvailable``, ``deviceCount`` >= 1, the engine's platform name,
    ``registerProgram`` throwing (no StableHLO registry), no program
    registered, and the same hash again, which must route to the card
    (sentinel 1) and equal the host route;
14. prints the ``kernels`` JSON line (K1-K6, each with its launches on
    its paths: K1-K3 on q1-q10, q11-q20, the served path, the batched
    path, the morsel step, the fleet-control step (K5 too) and the tuned
    q3, the kernels launched serving over the mesh, K3 also on the
    roster, the strings step, roster II and, in its table form, on the
    row conversions and nested rows, K1-K6 on the mesh, and K4-K6 on the
    native path), the card again, and as
    the last line ``{"ok": true, "device": {...}}``.

Every kernel time is device time from CUDA events, the median of 10 runs
after two warm-ups, with the queue held by a device-side sleep so that
the host's enqueue does not count. Beside it stand the plain version's
time, one PyTorch library call's time where one computes the same
function, and the bound: the larger of the bytes the function must move
over the card's 3.35 TB/s and its operations over 67 T/s, or, for K2,
the updates of its busiest slot at one shared-memory atomic per SM
clock. The ``kernels`` line sums each kernel over its calls on its
paths: K1-K3 over q1-q10, q11-q20, the served path's counted pass, the
batched path (launches: the replayed windows of step 10c (a); calls and
times: its recording pass (b)), the morsel step's and the tuned q3
(step 11c), K4 and K5 over the hashing step, K3 over the roster, the
strings step and roster II, K6, K7 and K3's table form over the
row-conversion step, all of them over the mesh step and the mesh-served
pass, and K1, K2, K3 and K5 over the fleet-control step's counted pass
(its launches) and its recording pass (calls and times) (the mesh,
serving, batched, morsel, fleet-control and tune steps time 3 runs a
call, to keep them short). The
morsel step's first warm run of each query and its Parquet runs turn
``SRT_METRICS`` on, so the overlap and io histograms record; its timed
medians run with it off.

``--profile`` adds one warm run of each query, table hash, roster,
strings and roster II phase, mesh query and row conversion under
``torch.profiler``: the device time of its kernels (and of the NCCL
kernels among them), the device's idle share of the warm wall time, and
the kernels that took most of it. Busy time and idle share read "not measured" when the
profiler saw fewer launches of K1-K6 than the wrappers counted.

It uses the first visible card only. It imports nothing of JAX nor of
the JAX package. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result. ``--out DIR`` also
writes the build log, this output (``chip_smoke.log``) and a JSON
report there. ``--queries-only`` builds
the kernels, then only times q1-q20 (``query_times``) and prints their
warm medians as its last line: run it in two trees in turns to compare
their query times without the rest of the smoke around them.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import datetime as pydt
import decimal
import hashlib
import inspect
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path
from zoneinfo import ZoneInfo

import numpy as np
import pandas as pd
import torch

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table, bitmask
from spark_rapids_jni_tpu_torch.columnar.strings import (
    byte_matrix, lengths as str_lengths, strings_from_matrix)
from spark_rapids_jni_tpu_torch.exec import (HostTable, ParquetHostTable,
                                             morsel_bytes_budget, pages,
                                             rel_append,
                                             reset_standing_state)
from spark_rapids_jni_tpu_torch.exec.runner import reset_staging, run_morsels
from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.obs import (REGISTRY, dispatch_counts,
                                            kernel_stats, stats_since)
from spark_rapids_jni_tpu_torch.obs import server as obs_server
from spark_rapids_jni_tpu_torch.obs.memory import hbm_headroom_bytes
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.ops import (bloom_filter, groupby, hashing,
                                            hive_hash, hllpp, nested_rows)
from spark_rapids_jni_tpu_torch.ops import cast_strings as cs
from spark_rapids_jni_tpu_torch.ops import float_to_string as fts
from spark_rapids_jni_tpu_torch.ops import parse_uri as pu
from spark_rapids_jni_tpu_torch.ops import regexp as rx
from spark_rapids_jni_tpu_torch.ops import datetime as dto
from spark_rapids_jni_tpu_torch.ops import datetime_rebase as reb
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
from spark_rapids_jni_tpu_torch.ops import timezone as tz
from spark_rapids_jni_tpu_torch.ops import (
    apply_boolean_mask, case_when, coalesce, concatenate, get_json_object,
    histogram as hg, if_else, map_utils as mu, slice_rows, tdigest as td,
    zorder)
from spark_rapids_jni_tpu_torch.ops.get_json_object import (_eval_py,
                                                             _parse_path)
from spark_rapids_jni_tpu_torch.ops.sort import gather_column
from spark_rapids_jni_tpu_torch.obs import history as obs_history
from spark_rapids_jni_tpu_torch.obs import rollup as obs_rollup
from spark_rapids_jni_tpu_torch.obs import slo as obs_slo
from spark_rapids_jni_tpu_torch.parallel import (distributed, make_mesh,
                                                 make_mesh_2d, shuffle_table)
from spark_rapids_jni_tpu_torch.serving import (FleetScheduler,
                                                QueryExecutor, QueryExpired,
                                                QueryShed, TenantConfig,
                                                aot_cache, control_plane,
                                                reliability, result_cache)
from spark_rapids_jni_tpu_torch.tune import store as tune_store
from spark_rapids_jni_tpu_torch.tune.runner import tune
from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES, dist, generate
from spark_rapids_jni_tpu_torch.tpcds.rel import (BatchIncompatible,
                                                  batch_cache_stats,
                                                  clear_batch_cache,
                                                  rel_from_df, run_fused,
                                                  run_fused_batched)
from spark_rapids_jni_tpu_torch.utils import faults

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12     # H100 SXM rate outside the tensor cores
PALLAS = "spark_rapids_jni_tpu/ops/pallas_kernels.py"
SF, SEED, REPS = 1000, 7, 10  # the main path's scale, its seed, timing runs
Q1_10 = tuple(f"q{i}" for i in range(1, 11))
Q11_20 = tuple(f"q{i}" for i in range(11, 21))
BYTES_ROUTE = ("q11", "q12", "q20")  # run again on SRT_STRING_ROUTE=bytes
Q_NAMES = ("hash_join_probe", "ragged_groupby_sum_count", "bitmask_pack")
HASH_NAMES = ("murmur3_int32", "murmur3_int64")
ROW_NAMES = ("pack_rows", "unpack_rows", "bitmask_pack",
             "bitmask_pack_fields")
NAMES = tuple(dict.fromkeys(Q_NAMES + HASH_NAMES + ROW_NAMES))
# the kernels line: each kernel and the (path, wrapper) pairs it sums
KERNELS = (("hash_join_probe", (("q1-q10", "hash_join_probe"),
                                 ("q11-q20", "hash_join_probe"),
                                 ("mesh", "hash_join_probe"),
                                 ("serving", "hash_join_probe"),
                                 ("serving mesh", "hash_join_probe"),
                                 ("batched", "hash_join_probe"),
                                 ("morsel", "hash_join_probe"),
                                 ("fleet control", "hash_join_probe"),
                                 ("tune", "hash_join_probe"))),
           ("ragged_groupby_sum_count",
            (("q1-q10", "ragged_groupby_sum_count"),
             ("q11-q20", "ragged_groupby_sum_count"),
             ("mesh", "ragged_groupby_sum_count"),
             ("serving", "ragged_groupby_sum_count"),
             ("serving mesh", "ragged_groupby_sum_count"),
             ("batched", "ragged_groupby_sum_count"),
             ("morsel", "ragged_groupby_sum_count"),
             ("fleet control", "ragged_groupby_sum_count"),
             ("tune", "ragged_groupby_sum_count"))),
           ("bitmask_pack", (("q1-q10", "bitmask_pack"),
                             ("q11-q20", "bitmask_pack"),
                             ("serving", "bitmask_pack"),
                             ("serving mesh", "bitmask_pack"),
                             ("batched", "bitmask_pack"),
                             ("morsel", "bitmask_pack"),
                             ("row conversion", "bitmask_pack"),
                             ("row conversion", "bitmask_pack_fields"),
                             ("roster", "bitmask_pack"),
                             ("roster", "bitmask_pack_fields"),
                             ("strings", "bitmask_pack"),
                             ("roster II", "bitmask_pack"),
                             ("mesh", "bitmask_pack"),
                             ("mesh", "bitmask_pack_fields"),
                             ("serving mesh", "bitmask_pack_fields"),
                             ("fleet control", "bitmask_pack"),
                             ("tune", "bitmask_pack"))),
           ("murmur3_int32", (("hashing", "murmur3_int32"),
                              ("mesh", "murmur3_int32"),
                              ("serving mesh", "murmur3_int32"),
                              ("native", "murmur3_int32"))),
           ("murmur3_int64", (("hashing", "murmur3_int64"),
                              ("mesh", "murmur3_int64"),
                              ("serving mesh", "murmur3_int64"),
                              ("fleet control", "murmur3_int64"),
                              ("native", "murmur3_int64"))),
           ("pack_rows", (("row conversion", "pack_rows"),
                          ("mesh", "pack_rows"),
                          ("serving mesh", "pack_rows"),
                          ("native", "pack_rows"))),
           ("unpack_rows", (("row conversion", "unpack_rows"),
                            ("mesh", "unpack_rows"),
                            ("serving mesh", "unpack_rows"))))
HASH_ROWS, HASH_CPU_ROWS = 10_000_000, 1_000_000
# the wrappers as the port defines them (the recording pass swaps the
# module's names for recorders that call these)
WRAPPERS = {name: getattr(K, name) for name in NAMES}


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


# device clocks the queue is held before each timed run: about 2.5 ms,
# longer than the host takes to enqueue one wrapper call of a wide table
# (a 104-column K6 call checks 208 tensors), so that the enqueue stays
# out of the kernel's time
HOLD_CYCLES = 5_000_000
PROFILE_TRIES = 3  # profiled runs of one query at most (profile_run)


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events,
    after two warm-up runs. A device-side sleep ahead of each start
    event keeps the host's enqueue of ``fn`` out of the time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Card:
    """What the bounds need of the card: its SM count and top SM clock."""
    sms = 0
    sm_hz = 0.0

    @classmethod
    def read(cls) -> None:
        cls.sms = torch.cuda.get_device_properties(0).multi_processor_count
        cls.sm_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def bound(nbytes: int, ops: int, serial: int = 0) -> "tuple[float, str]":
    """Least time for the work, in ms, and what bounds it: the bytes over
    the memory rate, or the operations, the larger of ``ops`` over the
    scalar rate and ``serial`` updates that must follow one another in
    one SM, at one per clock."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / SCALAR_OPS_PER_S, serial / Card.sm_hz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# --------------------------------------------------------------------------
# Each kernel against its plain version, on given inputs
# --------------------------------------------------------------------------

def k1_cost(build, probe, build_live=None, probe_live=None):
    """Bytes: the live build keys, the live probe keys and both masks
    read once, (idx, found) written once; ~16 integer operations per
    key hashed."""
    nb = int(build.numel() if build_live is None else build_live.sum())
    n = int(probe.numel())
    npl = n if probe_live is None else int(probe_live.sum())
    masks = (0 if build_live is None else build.numel()) + \
        (0 if probe_live is None else n)
    return 8 * (nb + npl) + masks + 5 * n, 16 * (nb + npl), 0, \
        f"build {build.numel()} ({nb} live), probe {n} ({npl} live), " \
        f"capacity {K.hash_table_capacity(build.numel())}"


def k2_cost(slots, live, values, width):
    """Bytes: every live flag, the slots of live rows and the values of
    live in-range rows read once, sums and counts written once.
    Serial: the rows of the busiest slot, spread evenly over every SM's
    copy of it, follow one another at one shared-memory atomic per
    address per clock (an assumed rate: none is published)."""
    n = int(slots.numel())
    ok = live & (slots >= 0) & (slots < width)
    n_live, n_ok = int(live.sum()), int(ok.sum())
    busiest = (int(torch.bincount(slots[ok].to(torch.int64),
                                  minlength=width).max()) if n_ok else 0)
    return (n + 4 * n_live + 8 * n_ok + 12 * width, 4 * n_ok,
            -(-busiest // Card.sms),
            f"{n} rows ({n_ok} live in range, busiest slot {busiest}), "
            f"width {width}")


def k3_cost(valid):
    n = int(valid.numel())
    return n + 4 * ((n + 31) // 32), n, 0, \
        f"{n} bool -> {(n + 31) // 32} uint32 words" + (
            f" ({valid.data_ptr() % 16} B past a 16-byte boundary)"
            if valid.data_ptr() % 16 else "")


def k3_fields_cost(vbytes, n_fields):
    """Bytes: each row's validity bytes read once, every column's words
    written once; one operation a bit."""
    n, nbytes = vbytes.shape
    words = (n + 31) // 32
    return n * nbytes + 4 * n_fields * words, n * n_fields, 0, \
        f"{n} rows x {n_fields} fields (row stride {vbytes.stride(0)} B) " \
        f"-> {n_fields} x {words} uint32 words"


def k4_cost(blocks, seeds):
    """Bytes: block and seed read, hash written (12 B a row); about 16
    integer operations a row."""
    n = int(blocks.numel())
    return 12 * n, 16 * n, 0, f"{n} int32 blocks"


def k5_cost(values, seeds):
    """Bytes: value and seed read, hash written (16 B a row); about 24
    integer operations a row."""
    n = int(values.numel())
    return 16 * n, 24 * n, 0, f"{n} int64 values"


def k6_cost(columns, widths, validity):
    """Bytes: every column value and validity word read once, the row
    image written once; a few integer operations per output word."""
    n = int(columns[0].numel())
    size = K.pack_plan(tuple(widths)).size_per_row
    nullable = sum(v is not None for v in validity)
    return (n * sum(widths) + nullable * 4 * ((n + 31) // 32) + n * size,
            n * size, 0, f"{n} rows x {len(widths)} columns ({nullable} "
            f"with validity) -> {size} B rows")


def k7_cost(rows, widths, dtypes=None):
    """Bytes: every row read once, every column value and validity word
    written once; a few integer operations a value."""
    n, size = rows.shape
    words = 4 * len(widths) * ((n + 31) // 32)
    return (n * size + n * sum(widths) + words, n * len(widths), 0,
            f"{n} rows of {size} B -> {len(widths)} columns and their "
            "validity words")


def k2_library(slots, live, values, width):
    """One int64 ``index_add_`` of the live in-range values (the sums
    only: no single call also counts)."""
    ok = live & (slots >= 0) & (slots < width)
    parked = torch.where(ok, slots.to(torch.int64), width)
    acc = torch.zeros(width + 1, dtype=torch.int64, device=slots.device)

    def library():
        acc.zero_()
        acc.index_add_(0, parked, values.to(torch.int64))
    return library


SPECS = {
    "hash_join_probe": dict(
        source="spark_rapids_jni_tpu_torch/csrc/hash_join_probe.cu",
        replaces=f"{PALLAS}:480", plain=K.hash_join_probe_plain,
        cost=k1_cost, library=None, plain_reps=3),
    "ragged_groupby_sum_count": dict(
        source="spark_rapids_jni_tpu_torch/csrc/ragged_groupby.cu",
        replaces=f"{PALLAS}:604", plain=K.ragged_groupby_sum_count_plain,
        cost=k2_cost, library=k2_library, plain_reps=REPS),
    "bitmask_pack": dict(
        source="spark_rapids_jni_tpu_torch/csrc/bitmask_pack.cu",
        replaces=f"{PALLAS}:184", plain=K.bitmask_pack_plain,
        cost=k3_cost, library=None, plain_reps=REPS),
    "bitmask_pack_fields": dict(
        source="spark_rapids_jni_tpu_torch/csrc/bitmask_pack.cu",
        replaces=f"{PALLAS}:184", plain=K.bitmask_pack_fields_plain,
        cost=k3_fields_cost, library=None, plain_reps=3),
    "murmur3_int32": dict(
        source="spark_rapids_jni_tpu_torch/csrc/murmur3.cu",
        replaces=f"{PALLAS}:81", plain=K.murmur3_int32_plain,
        cost=k4_cost, library=None, plain_reps=REPS),
    "murmur3_int64": dict(
        source="spark_rapids_jni_tpu_torch/csrc/murmur3.cu",
        replaces=f"{PALLAS}:144", plain=K.murmur3_int64_plain,
        cost=k5_cost, library=None, plain_reps=REPS),
    "pack_rows": dict(
        source="spark_rapids_jni_tpu_torch/csrc/pack_rows.cu",
        replaces=f"{PALLAS}:311", plain=K.pack_rows_plain,
        cost=k6_cost, library=None, plain_reps=3),
    "unpack_rows": dict(
        source="spark_rapids_jni_tpu_torch/csrc/unpack_rows.cu",
        replaces="none (the reference decodes rows with jnp slices)",
        plain=K.unpack_rows_plain, cost=k7_cost, library=None,
        plain_reps=3),
}


def _launches(name: str, args: tuple) -> int:
    """The ``__global__`` launches one wrapper call on ``args`` makes: K1
    launches once when its table fits in shared memory, else its build and
    its probe; K2 once a call; the others once a call with rows."""
    if name == "hash_join_probe":
        shared = K.probe_table_shared(args[0].numel())
        return 0 if not args[1].numel() else 1 if shared else 2
    if name == "ragged_groupby_sum_count":
        return 1
    first = args[0][0] if name == "pack_rows" else args[0]
    return 1 if first.numel() else 0


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _outputs(out) -> list:
    """A wrapper's output tensors as int64, float ones by their bits (K7's:
    its columns, then its words)."""
    if isinstance(out, tuple) and isinstance(out[0], list):
        out = (*out[0], out[1])
    return [(t.view(_INT_OF_SIZE[t.element_size()]) if t.is_floating_point()
             else t).to(torch.int64)
            for t in (out if isinstance(out, tuple) else (out,))]


def measure(name: str, args: tuple, reps: int = REPS) -> dict:
    """Run kernel ``name`` and its plain version on ``args``; require
    exact equality; time the kernel, the plain version and the library
    call; bound the work."""
    spec = SPECS[name]
    wrapper, plain = WRAPPERS[name], spec["plain"]
    got, want = _outputs(wrapper(*args)), _outputs(plain(*args))
    torch.cuda.synchronize()
    err = max((int((g - w).abs().max()) if g.numel() else 0)
              for g, w in zip(got, want))
    nbytes, ops, serial, shape = spec["cost"](*args)
    _require(all(torch.equal(g, w) for g, w in zip(got, want)),
             f"{name} differs from its plain version on {shape} "
             f"(max_abs_err {err})")
    b_ms, b_by = bound(nbytes, ops, serial)
    library = spec["library"] and spec["library"](*args)
    return {"shape": shape, "max_abs_err": err,
            "ms": time_ms(lambda: wrapper(*args), reps),
            "plain_ms": time_ms(lambda: plain(*args),
                                min(reps, spec["plain_reps"])),
            "library_ms": time_ms(library, reps) if library else None,
            "bound_ms": b_ms, "bound_by": b_by}


def stress_cases(dev, gen) -> "list[tuple[str, tuple]]":
    """K1: the customer table's 15,811 unique keys as the build side (10%
    dead), a 10M-row probe of hits, in-range misses and out-of-range keys
    (5% dead). K2: 10M rows over 8192 and over 10 slots, values near
    +-2^63 (the sums wrap mod 2^64), 20% dead rows and a few
    out-of-range slots. K3: 10M + 7 rows (the last word has padding
    bits), from a 16-byte boundary and 5 bytes past one; its table form on
    the validity bytes of a 12M-row row matrix of the 32-field schema
    (200-byte rows, bytes 196-199) and of a 1M-row one of 1500 one-byte
    fields (1688-byte rows, bytes 1500-1687), random bytes in place."""
    n_build, n = 15_811, 10_000_000
    space = 4 * n_build
    build = torch.randperm(space, generator=gen, device=dev)[:n_build]
    build_live = torch.rand(n_build, generator=gen, device=dev) > 0.1
    pick = torch.randint(0, n_build, (n,), generator=gen, device=dev)
    wild = torch.randint(-space, 2 * space, (n,), generator=gen, device=dev)
    use_hit = torch.rand(n, generator=gen, device=dev) < 0.6
    probe = torch.where(use_hit, build[pick], wild)
    probe_live = torch.rand(n, generator=gen, device=dev) > 0.05
    cases = [("hash_join_probe", (build, probe, build_live, probe_live))]
    mag = torch.randint(2**62, 2**63 - 1, (n,), generator=gen, device=dev)
    sign = torch.rand(n, generator=gen, device=dev) < 0.5
    values = torch.where(sign, -mag, mag)
    live = torch.rand(n, generator=gen, device=dev) > 0.2
    for width in (8192, 10):
        slots = torch.randint(-8, width + 8, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        cases.append(("ragged_groupby_sum_count",
                      (slots, live, values, width)))
    flags = torch.rand(n + 16, generator=gen, device=dev) > 0.3
    cases += [("bitmask_pack", (flags[:n + 7],)),
              ("bitmask_pack", (flags[5:n + 12],))]
    for rows, row_bytes, voff, fields in ((12_000_000, 200, 196, 32),
                                          (1_000_000, 1688, 1500, 1500)):
        mat = torch.randint(0, 256, (rows, row_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
        cases.append(("bitmask_pack_fields",
                      (mat[:, voff:voff + (fields + 7) // 8], fields)))
    return cases


def _clone(x):
    """A copy of tensor ``x`` with its shape, strides and address modulo
    16 (so a recorded call is timed on the layout it had); other values
    as they are."""
    if not torch.is_tensor(x):
        return x
    if x.numel() == 0 or 0 in x.stride():
        return x.clone()
    span = 1 + sum((d - 1) * st for d, st in zip(x.shape, x.stride()))
    off = x.data_ptr() % 16 // x.element_size()
    buf = torch.empty(off + span, dtype=x.dtype, device=x.device)
    y = buf.as_strided(x.shape, x.stride(), off)
    y.copy_(x)
    return y


@contextlib.contextmanager
def recording(calls: list, query: list):
    """Swap each wrapper in ``cuda_kernels`` for one that records a copy
    of its inputs (``_clone``; and the query running, ``query[0]``) in
    ``calls``, then calls the wrapper."""
    def recorder(name):
        sig = inspect.signature(WRAPPERS[name])

        def record(*a, **kw):
            # a clone taken while a stream captures a graph holds nothing
            _require(not torch.cuda.is_current_stream_capturing(),
                     f"{name} recorded inside a graph capture")
            bound_args = sig.bind(*a, **kw)
            bound_args.apply_defaults()
            calls.append((query[0], name, tuple(
                _clone(x) for x in bound_args.args)))
            return WRAPPERS[name](*a, **kw)
        return record
    try:
        for name in NAMES:
            setattr(K, name, recorder(name))
        yield
    finally:
        for name in NAMES:
            setattr(K, name, WRAPPERS[name])


def path_kernels(calls: list, launches: dict, names: tuple, log,
                 reps: int = REPS) -> dict:
    """Hold every recorded call of a path against its plain version; sum
    each kernel's times (medians of ``reps`` runs) and bounds over its
    calls."""
    per_call: dict = {name: [] for name in names}
    for q, name, args in calls:
        r = measure(name, args, reps) | {"query": q}
        per_call[name].append(r)
        lib = ("" if r["library_ms"] is None
               else f" library_ms={r['library_ms']:.4f}")
        log(f"  {q} {name} on {r['shape']}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f}{lib} "
            f"bound_ms={r['bound_ms']:.4g} ({r['bound_by']})")
    recorded = {name: sum(_launches(name, args)
                          for _, n, args in calls if n == name)
                for name in names}
    _require(all(recorded[n] == launches.get(n, 0) for n in names),
             f"recorded launches {recorded} != the path's {launches}")
    totals = {}
    for name, rs in per_call.items():
        by = {"bytes": 0.0, "operations": 0.0}
        for r in rs:
            by[r["bound_by"]] += r["bound_ms"]
        libs = [r["library_ms"] for r in rs]
        totals[name] = {
            "calls": len(rs),
            "max_abs_err": max((r["max_abs_err"] for r in rs), default=0),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(by.values()),
            "bound_by": max(by, key=by.get),
            "library_ms": (None if not libs or None in libs
                           else sum(libs)),
            "per_call": rs}
    return totals


# --------------------------------------------------------------------------
# q1-q10 through the port's entry points, against the oracle
# --------------------------------------------------------------------------

def frames_match(got, want, qname: str) -> None:
    """The repo's bound (tests/test_tpcds.py): integers exact, floats
    within rtol=1e-9, atol=1e-9."""
    _require(list(got.columns) == list(want.columns),
             f"{qname} columns {list(got.columns)} != {list(want.columns)}")
    _require(len(got) == len(want), f"{qname} has {len(got)} rows, "
                                    f"oracle {len(want)}")
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=1e-9,
                atol=1e-9, equal_nan=True, err_msg=f"{qname}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{qname}.{c}")


def _count_syncs(fn):
    """Run ``fn`` under set_sync_debug_mode("warn"); return (result,
    synchronising calls reported)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own first-use notice ("Synchronization debug mode is a
    # prototype feature") is not a synchronising call
    return out, sum("synchroniz" in str(w.message).lower()
                    and "prototype" not in str(w.message) for w in caught)


# the __global__ functions of csrc/*.cu (templates included), as the
# profiler names them
HAND_KERNEL = re.compile(r"(?:^|::)(?:build|probe|build_probe|"
                         r"ragged_groupby|bitmask_pack|bitmask_pack_fields|"
                         r"murmur3_int32|murmur3_int64|pack_rows)_kernel"
                         r"(?:<[^>]*>)?\(")


def profile_run(fn, wall: float, label: str, log) -> dict:
    """One warm run of ``fn`` under ``torch.profiler``: the device time of
    its CUDA kernels, its share of ``wall`` (the unprofiled warm wall
    time, ms), and the kernels that took most of it. Busy time and idle
    share count as measured only when the profiler saw every launch of
    the hand kernels that ``cuda_kernels.LAUNCHES`` counted in the run;
    a run in which the profiler dropped events is profiled again, up to
    ``PROFILE_TRIES`` runs in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries in range(1, PROFILE_TRIES + 1):
        launched = sum(K.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = sum(K.LAUNCHES.values()) - launched
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us = e.time_range.elapsed_us()
                n, t = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, t + us)
        seen = sum(n for k, (n, _) in by_name.items()
                   if HAND_KERNEL.search(k))
        measured = bool(by_name) and seen == launched
        if measured:
            break
    busy_ms = sum(t for _, t in by_name.values()) / 1e3
    nccl_ms = sum(t for k, (_, t) in by_name.items()
                  if "nccl" in k.lower()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    r = {"device_busy_ms": busy_ms if measured else None,
         "nccl_ms": nccl_ms if measured else None,
         "profile_runs": tries,
         "device_kernels": sum(n for n, _ in by_name.values()),
         "hand_kernel_launches": launched,
         "hand_kernel_launches_profiled": seen,
         "top_kernels": [{"name": k[:90], "launches": n, "ms": t / 1e3}
                         for k, (n, t) in top],
         "device_idle_share": (max(0.0, 1.0 - busy_ms / wall) if measured
                               else None)}
    if measured:
        shares = (f"device_busy_ms={busy_ms:.3f} nccl_ms={nccl_ms:.3f} "
                  f"idle_share={r['device_idle_share']:.3f}")
    else:
        shares = ("device_busy_ms=not measured idle_share=not measured "
                  f"(the profiler saw {seen} of {launched} hand-kernel "
                  "launches)")
    log(f"{label}: profile {shares} kernels={r['device_kernels']} top="
        + json.dumps([(t['name'][:48], t['launches'], round(t['ms'], 3))
                      for t in r["top_kernels"]]))
    return r


def profile_queries(queries, rels, dev, per_query: dict, log) -> None:
    """``profile_run`` of one warm run per query."""
    for q in queries:
        per_query[q] |= profile_run(
            lambda q=q: run_fused(PLANS[q], rels, device=dev),
            per_query[q]["warm_ms"], q, log)


# the route counters a query line shows
ROUTE_PREFIXES = ("rel.route.join.probe.", "rel.route.groupby.dense.",
                  "rel.route.groupby.cuda", "rel.route.string.",
                  "rel.route.decimal.", "rel.route.window.")


def run_queries(path: str, queries: tuple, rels: dict, data: dict, dev,
                log, profile: bool = False) -> "tuple[dict, list]":
    """One main path: ``queries`` through ``run_fused`` with every launch
    count set to 0 just before and read just after (the cold run), then
    the warm times (median of 3), the profile, a pass recording every
    kernel call's inputs, and the checks: each result equal to its
    pandas oracle, no fused fallback, at most one counted host sync a
    query, K1-K3 each launched."""
    results, per_query = {}, {}
    before_all = kernel_stats()
    K.reset_launch_counts()
    for q in queries:
        before = kernel_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, syncs = _count_syncs(
            lambda q=q: run_fused(PLANS[q], rels, device=dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        results[q] = out.to_df()
        st = stats_since(before)
        routes = {k: v for k, v in st.items()
                  if k.startswith(ROUTE_PREFIXES)}
        per_query[q] = {"ms": ms, "rows": len(results[q]), "routes": routes,
                        "host_syncs": st.get("rel.host_syncs", 0),
                        "cuda_sync_calls": syncs}
    launches = dict(K.LAUNCHES)
    stats = stats_since(before_all)
    for q, r in per_query.items():
        log(f"{q}: ms={r['ms']:.3f} rows={r['rows']} "
            f"host_syncs={r['host_syncs']} "
            f"cuda_sync_calls={r['cuda_sync_calls']} "
            f"routes={json.dumps(r['routes'], sort_keys=True)}")
    log(f"{path} launches: {json.dumps(launches, sort_keys=True)}")

    # warm timings (the launch counts above are already read)
    for q in queries:
        _, syncs = _count_syncs(lambda q=q: run_fused(PLANS[q], rels,
                                                      device=dev))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_fused(PLANS[q], rels, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_query[q]["warm_ms"] = statistics.median(times)
        per_query[q]["warm_cuda_sync_calls"] = syncs
        log(f"{q}: warm_ms={per_query[q]['warm_ms']:.3f} "
            f"warm_cuda_sync_calls={syncs}")
    if profile:
        profile_queries(queries, rels, dev, per_query, log)

    # one more pass, recording the inputs of every kernel call
    calls, query = [], [None]
    with recording(calls, query):
        for q in queries:
            query[0] = q
            run_fused(PLANS[q], rels, device=dev)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    oracles = {q: QUERIES[q][1](data) for q in queries}
    oracle_s = time.perf_counter() - t0
    for q in queries:
        frames_match(results[q], oracles[q], q)
    log(f"oracle: {path} equal the pandas oracle (oracle_s={oracle_s:.3f})")
    _require(stats.get("rel.fused_fallbacks", 0) == 0,
             f"fused fallbacks: {stats}")
    for q, r in per_query.items():
        _require(r["host_syncs"] <= 1,
                 f"{q} counted {r['host_syncs']} host syncs")
    for name in Q_NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the {path} path")
    return {"per_query": per_query, "launches": launches,
            "oracle_s": oracle_s, "oracles": oracles}, calls


def run_main_path(dev, sf: float, seed: int, log, profile: bool = False):
    """Generate and ingest the TPC-DS miniature, then the q1-q10 path."""
    t0 = time.perf_counter()
    data = generate(sf=sf, seed=seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rels = {name: rel_from_df(df, device=dev) for name, df in data.items()}
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    rows = {k: len(v) for k, v in data.items()}
    log(f"data: sf={sf} seed={seed} generate_s={gen_s:.3f} "
        f"ingest_s={ingest_s:.3f} rows={json.dumps(rows)}")
    out, calls = run_queries("q1-q10", Q1_10, rels, data, dev, log, profile)
    oracles = out.pop("oracles")
    return out | {"rows": rows, "generate_s": gen_s,
                  "ingest_s": ingest_s}, calls, rels, data, oracles


def query_times(dev) -> dict:
    """q1-q20's warm times as the main paths take them (step 3): the
    miniature generated and ingested, a cold pass over the queries, then
    each query's ``wall_ms``; no checks."""
    data = generate(sf=SF, seed=SEED)
    rels = {name: rel_from_df(df, device=dev) for name, df in data.items()}
    del data
    queries = Q1_10 + Q11_20
    for q in queries:
        run_fused(PLANS[q], rels, device=dev)
    return {q: wall_ms(lambda q=q: run_fused(PLANS[q], rels, device=dev))
            for q in queries}


def overflow_rows(data: dict) -> int:
    """Rows of q15's DECIMAL32 product over 2^31 - 1, the oracle's way
    (exact Python integers)."""
    ss = data["store_sales"]
    prod = ss.ss_list_price_cents.astype(object) * ss.ss_coupon_amt_cents
    return int((prod > 2**31 - 1).sum())


def run_oplib_path(dev, rels: dict, data: dict, log,
                   profile: bool = False) -> "tuple[dict, list, dict]":
    """The q11-q20 path (string, decimal and window operators) on the
    rels q1-q10 ran on; then q15's overflow count against the oracle's,
    and q11, q12, q20 again on the ``bytes`` string route. Returns the
    path's report, its kernel calls and the oracles' frames."""
    out, calls = run_queries("q11-q20", Q11_20, rels, data, dev, log,
                             profile)
    oracles = out.pop("oracles")
    overflow = out["per_query"]["q15"]["routes"].get(
        "rel.route.decimal.overflow", 0)
    want = overflow_rows(data)
    log(f"q15: rel.route.decimal.overflow={overflow} (the oracle's rows "
        f"over 2^31 - 1: {want})")
    _require(overflow == want and want > 0,
             f"q15 counted {overflow} overflows, the oracle {want}")
    out["q15_overflow"] = {"counted": overflow, "oracle": want}
    os.environ["SRT_STRING_ROUTE"] = "bytes"
    try:
        for q in BYTES_ROUTE:
            before = kernel_stats()
            got = run_fused(PLANS[q], rels, device=dev).to_df()
            st = stats_since(before)
            routes = {k: v for k, v in st.items()
                      if k.startswith("rel.route.string.")}
            frames_match(got, oracles[q], f"{q} (bytes route)")
            _require(any(k.endswith(".bytes") for k in routes)
                     and st.get("rel.fused_fallbacks", 0) == 0,
                     f"{q} did not run fused on the bytes route: {st}")
            log(f"{q}: bytes route equal to the oracle's result, routes="
                f"{json.dumps(routes, sort_keys=True)}")
    finally:
        del os.environ["SRT_STRING_ROUTE"]
    return out, calls, oracles


# --------------------------------------------------------------------------
# Hashing and row conversion through the port's entry points
# --------------------------------------------------------------------------

# +-0.0, +-inf, NaN 0x7ff8..., 0xfff8... and 0x7ff0...01, as int64 bits
F64_SPECIALS = (0, -2**63, 0x7FF0000000000000, -0x10000000000000,
                0x7FF8000000000000, -0x8000000000000, 0x7FF0000000000001)
F32_SPECIALS = (0, -2**31, 0x7F800000, -0x800000, 0x7FC00000, -0x400000,
                0x7F800001)  # +-0.0, +-inf, NaN 0x7fc00000, 0xffc00000, sNaN
# 2-byte UTF-8 units of the STRING column (ASCII pairs and é ü ж ß)
UTF8_UNITS = [b"ab", b"Zq", b"09", b"  ", "é".encode(), "ü".encode(),
              "ж".encode(), "ß".encode()]


def wall_ms(fn, reps: int = 3) -> float:
    """Median host time of ``fn()`` ending in a synchronise, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _valid_words(dev, gen, n: int, null_share: float):
    if not null_share:
        return None
    return bitmask.pack(torch.rand(n, generator=gen, device=dev)
                        >= null_share)


def _with_specials(x: torch.Tensor, bits, every: int) -> torch.Tensor:
    """``x`` with every ``every``-th row set to the IEEE patterns
    ``bits`` in turn."""
    ints = x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)
    at = torch.arange(0, x.numel(), every, device=x.device)
    pats = torch.tensor(bits, dtype=ints.dtype, device=x.device)
    ints[at] = pats[torch.arange(at.numel(), device=x.device) % len(bits)]
    return x


def string_column(dev, gen, n: int, null_share: float) -> Column:
    """0-32 bytes of UTF-8 a row (2-byte units, odd lengths end in an
    ASCII byte); a null row holds no bytes."""
    valid = torch.rand(n, generator=gen, device=dev) >= null_share
    lens = torch.where(valid, torch.randint(0, 33, (n,), generator=gen,
                                            device=dev), 0)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    chars = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=dev)
    units = lens // 2
    row = torch.repeat_interleave(torch.arange(n, device=dev), units)
    first = torch.cumsum(units, 0) - units
    pos = offsets[row] + 2 * (torch.arange(row.numel(), device=dev)
                              - first[row])
    table = torch.tensor([list(u) for u in UTF8_UNITS], dtype=torch.uint8,
                         device=dev)
    pick = table[torch.randint(0, len(UTF8_UNITS), (row.numel(),),
                               generator=gen, device=dev)]
    chars[pos], chars[pos + 1] = pick[:, 0], pick[:, 1]
    odd = torch.nonzero(lens % 2 == 1)[:, 0]
    chars[offsets[odd + 1] - 1] = torch.randint(
        0x61, 0x7B, (odd.numel(),), generator=gen, device=dev,
        dtype=torch.uint8)
    return Column(T.STRING, n, None, bitmask.pack(valid), children=(
        Column(T.INT32, n + 1, offsets.to(torch.int32)),
        Column(T.UINT8, int(chars.numel()), chars)))


def _randint(dev, gen, n, lo, hi, dtype=torch.int64):
    return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                         dtype=dtype)


def hash_table(dev, gen, n: int) -> Table:
    """The hashing step's table: int32, int64, float64, float32, bool,
    date32, decimal64, decimal128, STRING; 10% nulls in every column."""
    def col(dt, data):
        return Column(dt, n, data, _valid_words(dev, gen, n, 0.1))
    f64 = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    f32 = torch.randn(n, generator=gen, device=dev, dtype=torch.float32)
    lo = _randint(dev, gen, n, -2**63, 2**63 - 1)
    hi = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                     lo >> 63, _randint(dev, gen, n, -2**40, 2**40))
    return Table([
        col(T.INT32, _randint(dev, gen, n, -2**31, 2**31, torch.int32)),
        col(T.INT64, _randint(dev, gen, n, -2**63, 2**63 - 1)),
        col(T.FLOAT64, _with_specials(f64 * 1e6, F64_SPECIALS, 97)),
        col(T.FLOAT32, _with_specials(f32 * 1e3, F32_SPECIALS, 89)),
        col(T.BOOL8, _randint(dev, gen, n, 0, 2, torch.int8)),
        col(T.TIMESTAMP_DAYS, _randint(dev, gen, n, -30000, 30000,
                                       torch.int32)),
        col(T.decimal64(-2), _randint(dev, gen, n, -10**15, 10**15)),
        col(T.decimal128(-2), torch.stack([lo, hi], dim=1)),
        string_column(dev, gen, n, 0.1)])


def head_on_cpu(col: Column, m: int) -> Column:
    """The first ``m`` rows of a column, on the CPU."""
    s = rc.slice_rows(col, 0, m)
    return Column(s.dtype, m, None if s.data is None else s.data.cpu(),
                  None if s.validity is None else s.validity.cpu(),
                  children=tuple(head_on_cpu(c, c.size)
                                 for c in s.children))


HIVE_COLUMNS = (0, 1, 2, 3, 4, 5, 8)  # HiveHash has no decimal route


def run_hashing(dev, gen, rels: dict, log, profile: bool = False):
    """Step 6: the table hashes, their K4/K5 launches and checks."""
    t0 = time.perf_counter()
    table = hash_table(dev, gen, HASH_ROWS)
    hive_t = Table([table.columns[i] for i in HIVE_COLUMNS])
    ss = rels["store_sales"]
    ss_t = Table([ss.col("ss_item_sk"), ss.col("ss_customer_sk")])
    torch.cuda.synchronize()
    log(f"hashing: {HASH_ROWS} rows generated on the card in "
        f"{time.perf_counter() - t0:.3f} s; store_sales {ss_t.num_rows} "
        "rows")
    fns = {"murmur3_table": lambda: hashing.murmur3_table(table),
           "xxhash64_table": lambda: hashing.xxhash64_table(table),
           "hive_hash_table": lambda: hive_hash.hive_hash_table(hive_t),
           "murmur3_table(store_sales keys)":
               lambda: hashing.murmur3_table(ss_t)}
    calls, query = [], ["hashing"]
    K.reset_launch_counts()
    with recording(calls, query):
        out = {name: fn() for name, fn in fns.items()}
        torch.cuda.synchronize()
    launches = {n: K.LAUNCHES[n] for n in HASH_NAMES}
    log(f"hashing launches: {json.dumps(launches)}")
    _require(launches == {"murmur3_int32": 4, "murmur3_int64": 3 + 2},
             f"hashing launched {launches}, want K4 4 and K5 3 + 2")
    rates = {}
    for name, fn in fns.items():
        ms = wall_ms(fn)
        rows = ss_t.num_rows if "store_sales" in name else HASH_ROWS
        rates[name] = {"ms": ms, "rows_per_s": rows / ms * 1e3}
        log(f"hashing {name}: {rows} rows in {ms:.3f} ms = "
            f"{rows / ms * 1e3:.4g} rows/s")
        if profile:
            rates[name] |= profile_run(fn, ms, f"hashing {name}", log)

    # the first rows, with the tables on the CPU
    m = HASH_CPU_ROWS
    cpu_t = Table([head_on_cpu(c, m) for c in table.columns])
    cpu_hive = Table([cpu_t.columns[i] for i in HIVE_COLUMNS])
    cpu_ss = Table([head_on_cpu(c, m) for c in ss_t.columns])
    want = {"murmur3_table": hashing.murmur3_table(cpu_t),
            "xxhash64_table": hashing.xxhash64_table(cpu_t),
            "hive_hash_table": hive_hash.hive_hash_table(cpu_hive),
            "murmur3_table(store_sales keys)":
                hashing.murmur3_table(cpu_ss)}
    for name, w in want.items():
        _require(torch.equal(out[name][:m].cpu(), w),
                 f"{name}: the card's first {m} rows differ from the CPU's")
    log(f"hashing: the first {m} rows of every hash equal the CPU's")

    # every NaN hashes like the canonical NaN
    for ci in (2, 3):
        col = table.columns[ci]
        nan = torch.isnan(col.data) & col.valid_bool()
        canon = torch.full((1,), float("nan"), dtype=col.data.dtype,
                           device=dev)
        one = Column(col.dtype, 1, canon)
        for fn in (hashing.murmur3_column, hashing.xxhash64_column,
                   hive_hash.hive_hash_column):
            h = fn(col)
            _require(bool(nan.any()) and bool((h[nan] == fn(one)[0]).all()),
                     f"{fn.__name__}: a NaN of {col.dtype!r} hashes unlike "
                     "the canonical NaN")
        log(f"hashing: {int(nan.sum())} valid NaN rows of {col.dtype!r} "
            "hash like the canonical NaN (murmur3, xxhash64, hive)")
    return {"rates": rates, "launches": launches}, calls, table


# (label, rows, null share per column, STRING columns, repeats of the
# 8-type schema); the third splits into two batches below 2 GB:
# 10,737,408 and 1,262,592 rows of 200 B
ROW_CASES = [("1M rows, all valid", 1_000_000, 0.0, 0, 4),
             ("1M rows, 1% nulls", 1_000_000, 0.01, 0, 4),
             ("12M rows, 1% nulls", 12_000_000, 0.01, 0, 4),
             ("1M rows + 2 STRING columns", 1_000_000, 0.01, 2, 4),
             ("1M rows x 104 columns, 1% nulls", 1_000_000, 0.01, 0, 13)]
# TestTables.java's eight types
ROW_TYPES = [T.INT64, T.FLOAT64, T.INT32, T.BOOL8, T.FLOAT32, T.INT8,
             T.decimal32(-3), T.decimal64(-8)]


def rows_table(dev, gen, n: int, null_share: float, strings: int,
               repeats: int) -> Table:
    """The TestTables types repeated ``repeats`` times (4: its 32-column
    schema), plus ``strings`` STRING columns; the floats carry NaN
    payloads, +-0.0 and +-inf."""
    def data(dt):
        if dt.id == T.TypeId.FLOAT64:
            return _with_specials(torch.randn(
                n, generator=gen, device=dev, dtype=torch.float64),
                F64_SPECIALS, 101)
        if dt.id == T.TypeId.FLOAT32:
            return _with_specials(torch.randn(
                n, generator=gen, device=dev, dtype=torch.float32),
                F32_SPECIALS, 103)
        if dt.id == T.TypeId.BOOL8:
            return _randint(dev, gen, n, 0, 2, torch.int8)
        info = torch.iinfo(dt.to_torch())
        return _randint(dev, gen, n, info.min, info.max, dt.to_torch())
    cols = [Column(dt, n, data(dt), _valid_words(dev, gen, n, null_share))
            for dt in ROW_TYPES * repeats]
    cols += [string_column(dev, gen, n, 0.1) for _ in range(strings)]
    return Table(cols)


def _same_columns(got: Table, want: Table) -> bool:
    """Every validity bit and every valid value (bytes) equal."""
    for a, b in zip(got.columns, want.columns):
        ok = b.valid_bool()
        if not torch.equal(a.valid_bool(), ok):
            return False
        if b.dtype.id == T.TypeId.STRING:
            (ma, la), (mb, lb) = byte_matrix(a, 32), byte_matrix(b, 32)
            if not (torch.equal(la[ok], lb[ok])
                    and torch.equal(ma[ok], mb[ok])):
                return False
        elif not torch.equal(K.as_bytes(a.data)[ok], K.as_bytes(b.data)[ok]):
            return False
    return True


def run_row_conversion(dev, gen, log, profile: bool = False):
    """Step 7: convert_to_rows / convert_from_rows, K6's, K7's and K3's
    launches and the round trip."""
    cases = ROW_CASES
    tables = [rows_table(dev, gen, *case[1:]) for case in cases]
    torch.cuda.synchronize()
    calls, query = [], [None]
    before = kernel_stats()
    K.reset_launch_counts()
    with recording(calls, query):
        rows, backs = [], []
        for (label, *_), t in zip(cases, tables):
            query[0] = label
            rows.append(rc.convert_to_rows(t))
            backs.append([rc.convert_from_rows(b, t.schema())
                          for b in rows[-1]])
        torch.cuda.synchronize()
    launches = {n: K.LAUNCHES[n] for n in ROW_NAMES}
    routes = {k: v for k, v in stats_since(before).items()
              if k.startswith(("row_conversion.route.",
                               "row_conversion.from_rows.route."))}
    log(f"row conversion launches: {json.dumps(launches)} routes: "
        f"{json.dumps(routes, sort_keys=True)}")
    fixed = sum(len(b) for b, case in zip(rows, cases) if not case[3])
    _require(launches["pack_rows"] == fixed,
             f"K6 launched {launches['pack_rows']} times, want {fixed}: one "
             "per batch of each fixed-width table")
    _require(launches["unpack_rows"] == fixed,
             f"K7 launched {launches['unpack_rows']} times, want {fixed}: "
             "one per batch of each fixed-width table converted back")
    want = sum(len(b) for b in rows) - fixed
    _require(launches["bitmask_pack_fields"] == want,
             f"K3's table form launched {launches['bitmask_pack_fields']} "
             f"times, want {want}: one per batch with STRING columns "
             "converted back")
    _require(routes == {"row_conversion.route.pack_rows": 4,
                        "row_conversion.route.torch": 1,
                        "row_conversion.from_rows.route.unpack_rows": fixed,
                        "row_conversion.from_rows.route.torch": want},
             f"row-conversion routes {routes}")
    step = rc.max_rows_per_batch(200)
    n_big = cases[2][1]
    _require([b.size for b in rows[2]] == [step, n_big - step],
             f"{n_big} rows split as {[b.size for b in rows[2]]}, want "
             f"{[step, n_big - step]}")
    results = []
    for (label, n, *_), t, batches, back in zip(cases, tables, rows, backs):
        schema = t.schema()
        start = 0
        for b, got in zip(batches, back):
            part = Table([rc.slice_rows(c, start, start + b.size)
                          for c in t.columns])
            _require(_same_columns(got, part),
                     f"{label}: the round trip lost a value or a bit")
            start += b.size
        del got, part
        back.clear()
        nbytes = sum(int(b.child.size) for b in batches)
        to_ms = wall_ms(lambda: rc.convert_to_rows(t))
        from_ms = wall_ms(lambda: [rc.convert_from_rows(b, schema)
                                   for b in batches])
        r = {"case": label, "rows": n, "batches": [b.size for b in batches],
             "row_bytes": nbytes, "to_rows_ms": to_ms,
             "from_rows_ms": from_ms,
             "to_rows_gb_s": nbytes / to_ms / 1e6,
             "from_rows_gb_s": nbytes / from_ms / 1e6}
        results.append(r)
        log(f"rows {label}: round trip exact; {nbytes} row bytes in "
            f"{len(batches)} batch(es); to_rows {to_ms:.3f} ms "
            f"({r['to_rows_gb_s']:.1f} GB/s), from_rows {from_ms:.3f} ms "
            f"({r['from_rows_gb_s']:.1f} GB/s)")
        if profile:
            r["to_rows_profile"] = profile_run(
                lambda: rc.convert_to_rows(t), to_ms, f"to_rows {label}", log)
            r["from_rows_profile"] = profile_run(
                lambda: [rc.convert_from_rows(b, schema) for b in batches],
                from_ms, f"from_rows {label}", log)
    del rows, tables, backs
    return {"cases": results, "launches": launches, "routes": routes}, calls


def kernels_beside_wall(cases: list, totals: dict, card: str, log) -> None:
    """Each conversion's wall time beside the device time of its kernel
    calls, K6 in ``convert_to_rows``, K7 (or, with STRING columns, K3's
    table form) in ``convert_from_rows``: the rest is the host's work,
    other kernels and the card's idle time."""
    for r in cases:
        for way, key, name in (("to_rows", "k6", "pack_rows"),
                               ("from_rows", "k7", "unpack_rows"),
                               ("from_rows", "k3", "bitmask_pack_fields")):
            ms = [c["ms"] for c in totals[name]["per_call"]
                  if c["query"] == r["case"]]
            if not ms:
                continue
            r[f"{key}_ms"] = sum(ms)
            share = r[f"{key}_share_of_{way}"] = sum(ms) / r[f"{way}_ms"]
            log(f"rows {r['case']}: convert_{way} {r[f'{way}_ms']:.3f} ms "
                f"wall, {key.upper()} {sum(ms):.4f} ms in {len(ms)} "
                f"call(s) = {share:.3f} of it [{card}]")


# K7's shapes (rows, repeats of the 8-type schema) at which the native
# engine's own decoder is timed beside it
NATIVE_UNPACK_SHAPES = ((12_000_000, 4), (1_000_000, 13))


def native_unpack_yardstick(log, card: str) -> list:
    """The native engine's ``unpack_rows_kernel`` (csrc/native/
    cuda_engine.cu: a thread a row, one global load a column, 32 columns
    a launch) at K7's shapes of the row step, on rows the engine packed
    and keeps resident: its device time under the profiler (the median of
    3 calls), beside K7's bound; "not measured" when the profiler saw
    none of its launches. A yardstick: no benchmark cell runs the engine,
    and the port does not call it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_jni_tpu_torch import native as nat
    torch.cuda.empty_cache()  # the engine allocates outside torch's cache
    nat.load()
    _require(nat.cuda_available(), "the CUDA engine did not start")
    out = []
    for n, repeats in NATIVE_UNPACK_SHAPES:
        schema = ROW_TYPES * repeats
        host = nat.NativeTable([(dt, np.zeros(n, dt.storage_dtype), None)
                                for dt in schema])
        table = host.to_device()
        host.close()
        with table.to_rows() as rows:
            times, launches = [], 0
            for _ in range(4):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    got = rows.from_rows(n, schema)
                    torch.cuda.synchronize()
                ev = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "unpack_rows_kernel" in e.name]
                times.append(sum(e.time_range.elapsed_us() for e in ev)
                             / 1e3)
                launches = len(ev)
                for d, v in got:
                    d.free()
                    v.free()
        table.free()
        widths = [dt.size_bytes for dt in schema]
        size = K.unpack_plan(tuple(widths)).size_per_row
        nbytes = n * size + n * sum(widths) + 4 * len(widths) * (
            (n + 31) // 32)
        r = {"rows": n, "columns": len(schema), "launches": launches,
             "ms": statistics.median(times[1:]) if launches else None,
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        out.append(r)
        ms = ("not measured (the profiler saw no launch)" if r["ms"] is None
              else f"{r['ms']:.4f} ms ({100 * r['bound_ms'] / r['ms']:.1f}% "
              "of the bound)")
        log(f"native unpack_rows_kernel {n} rows x {len(schema)} columns: "
            f"{launches} launch(es), {ms}, bound {r['bound_ms']:.4f} ms "
            f"[{card}]")
    return out


# --------------------------------------------------------------------------
# The aggregation and date roster through the port's entry points
# --------------------------------------------------------------------------

ROSTER_NAMES = ("bitmask_pack", "bitmask_pack_fields")
ROSTER_AGGS = [(0, "var"), (0, "std"), (1, "first"), (1, "last"),
               (2, "any"), (2, "all"), (1, "nunique")]
NESTED_ROWS = 1_000_000
BLOOM_BITS, BLOOM_KEYS, BLOOM_HASHES = 8_388_608, 1_000_000, 6
BLOOM_PROBES = 10_000_000
HLL_P = 9  # Spark's default rsd = 0.05
HLL_MIN_DISTINCT = 1000  # groups held to the error bound
DATE_ROWS, ROSTER_CPU_ROWS, SAMPLE_ROWS = 10_000_000, 1_000_000, 10_000
TZ_ZONES = ("America/Los_Angeles", "Europe/Berlin", "Asia/Kolkata")
US_PER_DAY = 86_400_000_000
EPOCH = pydt.datetime(1970, 1, 1)
ONE_US = pydt.timedelta(microseconds=1)


def _epoch_us(*ymd_hms) -> int:
    return (pydt.datetime(*ymd_hms) - EPOCH) // ONE_US


MIN_US, MAX_US = _epoch_us(1, 1, 1), _epoch_us(9999, 12, 31, 23, 59, 59,
                                               999_999)
# 0001-01-01, 9999-12-31, the 1582-10-04/15 switch, the epoch's
# neighbours and other pre-epoch values
DATE_EDGES = (MIN_US, MAX_US, _epoch_us(1582, 10, 4),
              _epoch_us(1582, 10, 15), _epoch_us(1582, 10, 4, 23, 59, 59,
                                                 999_999),
              _epoch_us(1582, 10, 14), -1, 0, 1, -US_PER_DAY,
              -US_PER_DAY - 1, _epoch_us(1900, 2, 28, 12),
              _epoch_us(2000, 2, 29, 23, 59, 59, 1), _epoch_us(1, 3, 1))


def run_phase(step: str, name: str, fn, rows: int, calls: list,
              launches: dict, names: tuple, log, profile: bool):
    """One phase of a step: the launch counts set to 0 just before
    ``fn()`` runs once (every call of the ``names`` wrappers recorded) and
    read just after, with the counters that run moved; then the warm wall
    time (median of 3), rows/s and the peak memory allocated on the card
    from the first run to the last."""
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_stats()
    with recording(calls, [name]):
        out = fn()
        torch.cuda.synchronize()
    counters = stats_since(before)
    got = {n: K.LAUNCHES[n] for n in names}
    for n, v in got.items():
        launches[n] = launches.get(n, 0) + v
    ms = wall_ms(fn)
    peak = torch.cuda.max_memory_allocated()
    r = {"phase": name, "launches": got, "wall_ms": ms, "rows": rows,
         "rows_per_s": rows / ms * 1e3, "peak_bytes": peak,
         "counters": counters}
    log(f"{step} {name}: {rows} rows in {ms:.3f} ms warm = "
        f"{r['rows_per_s']:.4g} rows/s; peak {peak / 2**30:.2f} GiB "
        f"allocated; K3 launches {json.dumps(got)}")
    if profile:
        r |= profile_run(fn, ms, f"{step} {name}", log)
    return out, r


def roster_phase(name: str, fn, rows: int, calls: list, launches: dict,
                 log, profile: bool):
    """One roster phase (``run_phase``)."""
    return run_phase("roster", name, fn, rows, calls, launches,
                     ROSTER_NAMES, log, profile)


def _host(col: Column) -> np.ndarray:
    return col.data.cpu().numpy()


def roster_groupby(ss, calls, launches, log, profile):
    """Phase 1: var/std of ss_net_profit, first/last/nunique of
    ss_customer_sk, any/all of ss_quantity > 10 by ss_item_sk, and a
    count by the STRUCT key (ss_store_sk, ss_promo_sk) against the same
    count by the two flat keys; held against a pandas oracle."""
    c = {k: ss.col(f"ss_{k}") for k in ("item_sk", "customer_sk",
                                        "net_profit", "quantity",
                                        "store_sk", "promo_sk")}
    n = c["item_sk"].size
    flag = Column(T.BOOL8, n, (c["quantity"].data > 10).to(torch.int8))
    keys = Table([c["item_sk"]])
    vals = Table([c["net_profit"], c["customer_sk"], flag])
    pair = Column.struct_from_children([c["store_sk"], c["promo_sk"]],
                                       field_names=("store", "promo"))
    ones = Table([c["store_sk"]])

    def fn():
        return (groupby.groupby_aggregate(keys, vals, ROSTER_AGGS),
                groupby.groupby_aggregate(Table([pair]), ones,
                                          [(0, "count_all")]),
                groupby.groupby_aggregate(Table([c["store_sk"],
                                                 c["promo_sk"]]), ones,
                                          [(0, "count_all")]))
    (out, by_struct, by_flat), r = roster_phase(
        "groupby", fn, n, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == 6,
             "K3 did not pack the six nullable results' validity")

    t0 = time.perf_counter()
    df = pd.DataFrame({"item": _host(c["item_sk"]),
                       "cust": _host(c["customer_sk"]),
                       "profit": _host(c["net_profit"]),
                       "flag": _host(c["quantity"]) > 10})
    g = df.groupby("item", sort=True)
    want = {"var": g.profit.var(), "std": g.profit.std(),
            "first": g.cust.first(), "last": g.cust.last(),
            "any": g.flag.any(), "all": g.flag.all(),
            "nunique": g.cust.nunique(), "count": g.size()}
    oracle_s = time.perf_counter() - t0
    _require(out.num_rows == len(want["count"]) and np.array_equal(
        _host(out.columns[0]), want["count"].index.to_numpy()),
        "groupby keys differ from the oracle's")
    two = want["count"].to_numpy() >= 2
    for (_, agg), col in zip(ROSTER_AGGS, out.columns[1:]):
        got, ok = col.to_numpy()
        exp = want[agg].to_numpy()
        if agg in ("var", "std"):
            _require(np.array_equal(ok, two), f"{agg}: NULL where the "
                     "oracle has fewer than two values, and only there")
            np.testing.assert_allclose(got[ok], exp[ok], rtol=1e-9,
                                       err_msg=agg)
        else:
            _require(ok.all() and np.array_equal(got, exp.astype(got.dtype)),
                     f"{agg} differs from the oracle")
    s0, s1 = by_struct.columns[0].children
    _require(by_struct.num_rows == by_flat.num_rows and all(
        torch.equal(a.data, b.data) for a, b in (
            (s0, by_flat.columns[0]), (s1, by_flat.columns[1]),
            (by_struct.columns[1], by_flat.columns[2]))),
        "the STRUCT key's groups differ from the two flat keys'")
    log(f"roster groupby: {out.num_rows} item groups equal the pandas "
        f"oracle (var/std rtol 1e-9; oracle_s={oracle_s:.3f}); the STRUCT "
        f"key gives the flat keys' {by_flat.num_rows} groups and counts")
    return r | {"groups": out.num_rows, "struct_groups": by_struct.num_rows,
                "oracle_s": oracle_s}


def _list_column(dev, gen, n: int, null_share: float) -> Column:
    """LIST<INT64> of 0-8 elements a row."""
    lens = torch.randint(0, 9, (n,), generator=gen, device=dev)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    return Column(T.LIST, n, None, _valid_words(dev, gen, n, null_share),
                  children=(Column(T.INT32, n + 1, offsets.to(torch.int32)),
                            Column(T.INT64, total, _randint(
                                dev, gen, total, -2**63, 2**63 - 1))))


def nested_table(dev, gen, n: int, share: float = 0.01) -> Table:
    """The eight TestTables types, STRUCT<INT32, FLOAT64, STRING 0-32 B>,
    LIST<INT64> of 0-8 elements and STRUCT<STRUCT<INT16, DECIMAL64>,
    INT64>, ``share`` nulls at every node, floats with NaN payloads."""
    def col(dt, data):
        return Column(dt, n, data, _valid_words(dev, gen, n, share))

    def struct(children, names=None):
        return Column(T.STRUCT, n, None, _valid_words(dev, gen, n, share),
                      children=tuple(children), field_names=names)
    f64 = _with_specials(torch.randn(n, generator=gen, device=dev,
                                     dtype=torch.float64), F64_SPECIALS, 89)
    return Table(list(rows_table(dev, gen, n, share, 0, 1).columns) + [
        struct([col(T.INT32, _randint(dev, gen, n, -2**31, 2**31,
                                      torch.int32)),
                col(T.FLOAT64, f64), string_column(dev, gen, n, share)],
               ("i", "f", "s")),
        _list_column(dev, gen, n, share),
        struct([struct([col(T.INT16, _randint(dev, gen, n, -2**15, 2**15,
                                              torch.int16)),
                        col(T.decimal64(-2), _randint(dev, gen, n, -10**15,
                                                      10**15))]),
                col(T.INT64, _randint(dev, gen, n, -2**63, 2**63 - 1))])])


def _same_nested(got: Column, want: Column) -> bool:
    """Every validity bit of every node equal, and every valid row's
    bytes (a STRING's or LIST's offsets and elements too)."""
    ok = want.valid_bool()
    if not torch.equal(got.valid_bool(), ok):
        return False
    if want.dtype.id == T.TypeId.STRUCT:
        return all(_same_nested(a, b) for a, b in zip(got.children,
                                                      want.children))
    if want.dtype.id in (T.TypeId.STRING, T.TypeId.LIST):
        idx = torch.nonzero(ok)[:, 0]
        a, b = gather_column(got, idx), gather_column(want, idx)
        return (torch.equal(a.offsets.data, b.offsets.data)
                and torch.equal(K.as_bytes(a.child.data),
                                K.as_bytes(b.child.data)))
    return torch.equal(K.as_bytes(got.data)[ok], K.as_bytes(want.data)[ok])


def roster_nested_rows(dev, gen, calls, launches, log, profile):
    """Phase 2: ``convert_to_rows_nested`` then
    ``convert_from_rows_nested`` of 1M seeded rows, exact round trip."""
    t = nested_table(dev, gen, NESTED_ROWS)
    tree = nested_rows.type_tree(t)
    lay = nested_rows.NestedRowLayout(tree)

    def fn():
        rows = nested_rows.convert_to_rows_nested(t)
        return rows, nested_rows.convert_from_rows_nested(rows, tree)
    (rows, back), r = roster_phase("nested rows", fn, NESTED_ROWS, calls,
                                   launches, log, profile)
    _require(r["launches"]["bitmask_pack_fields"] == 1,
             "the nested decode did not launch K3's table form once")
    _require(all(_same_nested(a, b) for a, b in zip(back.columns,
                                                    t.columns)),
             "the nested round trip lost a value or a validity bit")
    nbytes = int(rows.child.size)
    log(f"roster nested rows: {NESTED_ROWS} rows x {lay.n_nodes} nodes "
        f"({lay.var_start} fixed bytes a row, {nbytes} row bytes) round "
        "trip exact, NaN payloads byte for byte")
    return r | {"nodes": lay.n_nodes, "row_bytes": nbytes,
                "fixed_bytes": lay.var_start}


def roster_bloom(dev, gen, ss, calls, launches, log, profile):
    """Phase 3: Spark's runtime-filter defaults (8,388,608 bits, k = 6)
    over 1M distinct build keys (every ss_customer_sk value and seeded
    int64s above 2^33); probes of the build keys, the 10M ss_customer_sk
    values and 10M keys below -2^33, all absent."""
    cust = ss.col("ss_customer_sk")
    wide = torch.randint(2**33, 2**62, (BLOOM_KEYS + BLOOM_KEYS // 4,),
                         generator=gen, device=dev).unique()
    wide = wide[torch.randperm(wide.numel(), generator=gen, device=dev)]
    build_keys = torch.cat([cust.data.unique(), wide])[:BLOOM_KEYS]
    build = Column(T.INT64, BLOOM_KEYS, build_keys)
    absent = Column(T.INT64, BLOOM_PROBES, torch.randint(
        -2**62, -2**33, (BLOOM_PROBES,), generator=gen, device=dev))

    def fn():
        words = bloom_filter.build(build, BLOOM_BITS, BLOOM_HASHES)
        return words, [bloom_filter.probe(words, c, BLOOM_HASHES)
                       for c in (build, cust, absent)]
    (words, (hit_build, hit_cust, hit_absent)), r = roster_phase(
        "bloom filter", fn, BLOOM_KEYS + cust.size + BLOOM_PROBES, calls,
        launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == 1,
             "the bloom build did not pack its bit plane with K3")
    _require(int(build_keys.unique().numel()) == BLOOM_KEYS,
             "the build keys are not distinct")
    _require(bool(hit_build.all()) and bool(hit_cust.all()),
             "a false negative: a build key did not pass the filter")
    want = bloom_filter.build(Column(T.INT64, BLOOM_KEYS, build_keys.cpu()),
                              BLOOM_BITS, BLOOM_HASHES)
    _require(torch.equal(words.cpu(), want),
             "the filter words differ from the same build on the CPU")
    fp = float(hit_absent.float().mean())
    theory = (1 - math.exp(-BLOOM_HASHES * BLOOM_KEYS / BLOOM_BITS)) \
        ** BLOOM_HASHES
    set_bits = int(bitmask.unpack(words, BLOOM_BITS).sum())
    _require(fp < 2 * theory, f"false-positive share {fp} against the "
             f"theoretical {theory}")
    log(f"roster bloom filter: no false negative over {BLOOM_KEYS} build "
        f"keys and {cust.size} ss_customer_sk probes; false-positive share "
        f"{fp:.6f} over {BLOOM_PROBES} absent keys, theoretical "
        f"{theory:.6f}; {set_bits} of {BLOOM_BITS} bits set; words equal "
        "the CPU build")
    return r | {"false_positive_share": fp, "theoretical": theory,
                "bits_set": set_bits}


def roster_hllpp(dev, ss, calls, launches, log, profile):
    """Phase 4: ``groupby_reduce`` of ss_customer_sk by ss_store_sk at
    precision 9, ``estimate_column``, and ``reduce`` over the column."""
    store, cust = ss.col("ss_store_sk"), ss.col("ss_customer_sk")
    keys = Table([store])

    def fn():
        gk, sk = hllpp.groupby_reduce(keys, cust, HLL_P)
        whole = hllpp.reduce(cust, HLL_P)
        return gk, sk, hllpp.estimate_column(sk, HLL_P), whole, \
            hllpp.estimate(whole, HLL_P)
    (gk, sk, est, whole, west), r = roster_phase(
        "hllpp", fn, cust.size, calls, launches, log, profile)
    est_ms = wall_ms(lambda: hllpp.estimate_column(sk, HLL_P))
    # the same calls on the first rows, on the card and on the CPU
    m = ROSTER_CPU_ROWS
    heads = [(Table([rc.slice_rows(store, 0, m)]), rc.slice_rows(cust, 0, m)),
             (Table([head_on_cpu(store, m)]), head_on_cpu(cust, m))]
    (ck, cs), (pk, ps) = [hllpp.groupby_reduce(k, v, HLL_P) for k, v in heads]
    _require(torch.equal(ck.columns[0].data.cpu(), pk.columns[0].data)
             and torch.equal(cs.cpu(), ps)
             and torch.equal(hllpp.reduce(heads[0][1], HLL_P).cpu(),
                             hllpp.reduce(heads[1][1], HLL_P)),
             f"HLL++ sketch words differ from the CPU's on {m} rows")
    # exact distinct counts per store
    pair = store.data * (1 << 24) + cust.data
    uniq = pair.unique()
    exact = torch.bincount(uniq >> 24, minlength=int(store.data.max()) + 1)
    exact = exact[gk.columns[0].data].cpu()
    got = est.data.cpu()
    big = exact >= HLL_MIN_DISTINCT
    err = ((got - exact).abs().double() / exact.clamp(min=1).double())[big]
    bound = 4 * 1.04 / math.sqrt(1 << HLL_P)
    whole_exact = int(cust.data.unique().numel())
    whole_err = abs(int(west) - whole_exact) / whole_exact
    _require(bool(big.any()) and float(err.max()) <= bound
             and whole_err <= bound,
             f"HLL++ estimates off by up to {float(err.max()):.4f} "
             f"(whole column {whole_err:.4f}), bound {bound:.4f}")
    log(f"roster hllpp: {gk.num_rows} store sketches ({int(big.sum())} with "
        f">= 1000 distinct) within {float(err.max()):.4f} of the exact "
        f"counts, whole column {int(west)} against {whole_exact} "
        f"({whole_err:.4f}); bound {bound:.4f}; sketch words equal the "
        f"CPU's on {m} rows; estimate_column {est_ms:.3f} ms = "
        f"{est_ms / r['wall_ms']:.3f} of the phase's wall time")
    return r | {"groups": gk.num_rows, "max_rel_err": float(err.max()),
                "whole_rel_err": whole_err, "estimate_ms": est_ms,
                "estimate_share": est_ms / r["wall_ms"]}


def date_calls(col: Column, days: Column) -> dict:
    """Every extractor, ``truncate`` on every unit and
    ``add_interval_days`` over TIMESTAMP_MICROSECONDS; both rebases over
    TIMESTAMP_DAYS."""
    out = {f: getattr(dto, f)(col) for f in DATE_FIELDS}
    out |= {f"truncate {u}": dto.truncate(col, u)
            for u in dto.TRUNCATE_UNITS}
    out["add_interval_days 40"] = dto.add_interval_days(col, 40)
    out["gregorian_to_julian"] = reb.rebase_gregorian_to_julian(days)
    out["julian_to_gregorian"] = reb.rebase_julian_to_gregorian(days)
    return out


DATE_FIELDS = ("extract_year", "extract_month", "extract_day",
               "extract_hour", "extract_minute", "extract_second",
               "extract_microsecond", "day_of_week", "day_of_year")
_JULIAN_MONTHS = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334)
CUTOVER = pydt.date(1582, 10, 15)  # the hybrid calendar's first Gregorian day


def _julian_day(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 of a proleptic Julian date, by counting."""
    def ordinal(y, m, d):
        return 365 * (y - 1) + (y - 1) // 4 + _JULIAN_MONTHS[m - 1] \
            + (m > 2 and y % 4 == 0) + d
    return ordinal(y, m, d) - ordinal(1969, 12, 19)  # = 1970-01-01


def _julian_to_gregorian(day: int) -> int:
    """The proleptic Julian date of ``day`` read as a Gregorian date (a
    Julian February 29 the Gregorian year lacks rolls to March 1)."""
    y = 1968 + (day // 366 if day >= 0 else day // 365)  # a lower bound
    while _julian_day(y + 1, 1, 1) <= day:
        y += 1
    m = max(k for k in range(1, 13) if _julian_day(y, k, 1) <= day)
    first = (pydt.date(y, m, 1) - EPOCH.date()).days
    return first + day - _julian_day(y, m, 1)


def python_dates(us: int) -> dict:
    """``date_calls`` of one row by Python's ``datetime`` (the rebases by
    counting Julian days)."""
    dt = EPOCH + pydt.timedelta(microseconds=us)
    day = (dt.date() - EPOCH.date()).days

    def trunc(**zero):
        return (dt.replace(**zero) - EPOCH) // ONE_US
    return {"extract_year": dt.year, "extract_month": dt.month,
            "extract_day": dt.day, "extract_hour": dt.hour,
            "extract_minute": dt.minute, "extract_second": dt.second,
            "extract_microsecond": dt.microsecond,
            "day_of_week": dt.isoweekday() % 7 + 1,
            "day_of_year": dt.timetuple().tm_yday,
            "truncate day": trunc(hour=0, minute=0, second=0,
                                  microsecond=0),
            "truncate hour": trunc(minute=0, second=0, microsecond=0),
            "truncate minute": trunc(second=0, microsecond=0),
            "truncate second": trunc(microsecond=0),
            "add_interval_days 40":
                (dt - EPOCH + pydt.timedelta(days=40)) // ONE_US,
            "gregorian_to_julian": day if dt.date() >= CUTOVER
            else _julian_day(dt.year, dt.month, dt.day),
            "julian_to_gregorian": day if dt.date() >= CUTOVER
            else _julian_to_gregorian(day)}


def roster_dates(dev, gen, calls, launches, log, profile):
    """Phase 5: 10M seeded TIMESTAMP_MICROSECONDS over the years
    0001-9999 with the edge values mixed in; every extractor, truncate
    unit, add_interval_days, and both rebases over their days."""
    n = DATE_ROWS
    ts = torch.randint(MIN_US, MAX_US + 1, (n,), generator=gen, device=dev)
    edges = torch.tensor(DATE_EDGES, device=dev)
    at = torch.arange(0, n, 997, device=dev)
    ts[at] = edges[torch.arange(at.numel(), device=dev) % edges.numel()]
    col = Column(T.TIMESTAMP_MICROSECONDS, n, ts)
    days = Column(T.TIMESTAMP_DAYS, n, (ts // US_PER_DAY).to(torch.int32))
    out, r = roster_phase("dates", lambda: date_calls(col, days), n, calls,
                          launches, log, profile)
    m = ROSTER_CPU_ROWS
    cpu = date_calls(head_on_cpu(col, m), head_on_cpu(days, m))
    for name, c in cpu.items():
        _require(torch.equal(out[name].data[:m].cpu(), c.data),
                 f"{name}: the card's first {m} rows differ from the CPU's")
    pick = torch.randperm(n, generator=gen, device=dev)[:SAMPLE_ROWS]
    pick[:len(DATE_EDGES)] = torch.arange(0, 997 * len(DATE_EDGES), 997,
                                          device=dev)
    got = {k: v.data[pick].tolist() for k, v in out.items()}
    for i, us in enumerate(ts[pick].tolist()):
        for k, w in python_dates(us).items():
            _require(got[k][i] == w, f"{k} of {us} us: {got[k][i]}, "
                     f"Python's datetime {w}")
    log(f"roster dates: {len(out)} calls over {n} rows equal the CPU's on "
        f"the first {m} rows and Python's datetime on {SAMPLE_ROWS} sampled "
        f"rows (the {len(DATE_EDGES)} edge values among them)")
    return r | {"calls": len(out)}, col, pick


def roster_timezone(col: Column, pick, calls, launches, log, profile):
    """Phase 6: both conversions over the 10M timestamps in three zones;
    equal to the CPU on the first 1M rows and to ``zoneinfo`` on the
    sampled rows up to the transition table's horizon (the year 2200,
    as in the reference: past it the table's last offset holds)."""
    def fn():
        return {f"{z} {way}": getattr(tz, way)(col, z) for z in TZ_ZONES
                for way in ("convert_utc_to_timezone",
                            "convert_timezone_to_utc")}
    out, r = roster_phase("timezone", fn, col.size, calls, launches, log,
                          profile)
    m = ROSTER_CPU_ROWS
    head = head_on_cpu(col, m)
    for name, c in out.items():
        z, way = name.split(" ")
        _require(torch.equal(c.data[:m].cpu(), getattr(tz, way)(head, z).data),
                 f"{name}: the card's first {m} rows differ from the CPU's")
    us = col.data[pick].tolist()
    # Python's datetime ends at the year 1: a zone's local time within a
    # day of 0001-01-01 may lie before it
    lo_us = MIN_US + US_PER_DAY
    hi_us = _epoch_us(tz.RULE_HORIZON_YEAR + 1, 1, 1) - 2 * US_PER_DAY
    within = [i for i, v in enumerate(us) if lo_us <= v < hi_us]
    for z in TZ_ZONES:
        zone = ZoneInfo(z)
        lo = out[f"{z} convert_utc_to_timezone"].data[pick].tolist()
        ut = out[f"{z} convert_timezone_to_utc"].data[pick].tolist()
        for i in within:
            at = EPOCH + pydt.timedelta(microseconds=us[i])
            off = at.replace(tzinfo=pydt.timezone.utc).astimezone(zone) \
                .utcoffset() // ONE_US
            wall = at.replace(tzinfo=zone, fold=0).utcoffset() // ONE_US
            _require(lo[i] == us[i] + off and ut[i] == us[i] - wall,
                     f"{z} at {us[i]} us differs from zoneinfo")
    log(f"roster timezone: {len(out)} conversions over {col.size} rows "
        f"equal the CPU's on the first {m} rows and zoneinfo on the "
        f"{len(within)} sampled rows from 0001-01-02 to "
        f"{tz.RULE_HORIZON_YEAR}-12-30 in {', '.join(TZ_ZONES)} (the other "
        f"{len(us) - len(within)} lie past the transition table's horizon "
        "or within a day of the year 1, and are held against the CPU "
        "only)")
    return r | {"held_rows": len(within),
                "not_held": len(us) - len(within)}


def run_roster(dev, gen, rels: dict, log, profile: bool = False):
    """Step 7: the roster's six phases on store_sales and seeded data."""
    ss = rels["store_sales"]
    calls, launches, phases = [], {}, []
    phases.append(roster_groupby(ss, calls, launches, log, profile))
    phases.append(roster_nested_rows(dev, gen, calls, launches, log,
                                     profile))
    phases.append(roster_bloom(dev, gen, ss, calls, launches, log, profile))
    phases.append(roster_hllpp(dev, ss, calls, launches, log, profile))
    r, col, pick = roster_dates(dev, gen, calls, launches, log, profile)
    phases.append(r)
    phases.append(roster_timezone(col, pick, calls, launches, log, profile))
    for name in ROSTER_NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the roster path")
    return {"phases": phases, "launches": launches}, calls, col


# --------------------------------------------------------------------------
# The cast and string-function step through the port's entry points
# --------------------------------------------------------------------------

STRING_NAMES = ("bitmask_pack",)
STR_ROWS, STR_CPU_ROWS, HEAD_ROWS = 10_000_000, 1_000_000, 100_000
INT_EDGES = (-2**63, 2**63 - 1, 0, -1, 1, 10**18, -10**18, 2**31,
             -2**31 - 1, 127, -128)
# the integer strings' edits, 1% of the rows each: (prefix, suffix) or a
# replacement of the whole row
INT_WRAPS = (("  ", ""), ("", "\t "), ("+", ""), ("", ".9"), ("", ".25"))
INT_REPLACE = ("9223372036854775808", "-9223372036854775809", "", "12x4",
               "1e5", "--7")
FLOAT_LITERALS = ("inf", "Infinity", "nan", " -1.5E-3 ", "1e10")
DEC_SCALE = -2
# yyyy, yyyy-mm, yyyy-mm-dd, then hh:mm:ss with 0-6 fraction digits
TS_FORMS = 10
TS_ZONES = ("", "Z", "+05:30", "-08:00", "+00:00", "-03:30", "+14:00",
            " UTC", "UTC", " America/Los_Angeles")
TS_ZONE_WEIGHTS = (40, 8, 6, 6, 4, 4, 2, 12, 8, 10)
TS_ZONE_MINUTES = (None, 0, 330, -480, 0, -210, 840, 0, 0, None)
LA = "America/Los_Angeles"
REGEX_PATTERNS = (r"\d+", r"(ab|Zq)+\s*$", r"[^a-z0-9 ]\w",
                  r"^(ab|09|  )*[a-z]?$")
REGEX_FULL = (r"(ab|Zq|09|..)*[a-z]?", r"[\w ]*")
REGEX_HOST = r"(ab)\1"        # a backreference: the host route
EXTRACT = ((r"(\d+)", 1), (r"([a-z])(b|q)", 2))
FORMAT_DIGITS = (0, 2, 5)


def table_piece(dev, strings, pick):
    """(bytes (N, w) uint8, lengths (N,)) of ``strings[pick]``."""
    raw = [s.encode() if isinstance(s, str) else bytes(s) for s in strings]
    w = max(max(len(b) for b in raw), 1)
    tab = np.zeros((len(raw), w), np.uint8)
    for i, b in enumerate(raw):
        tab[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = torch.tensor([len(b) for b in raw], device=dev)
    return torch.from_numpy(tab).to(dev)[pick], lens[pick]


def concat(pieces, keep=None):
    """Row-wise concatenation of (bytes (N, w), lengths (N,)) pieces, a
    piece dropped from the rows where its ``keep`` mask is False ->
    ((N, sum of w) uint8, lengths)."""
    n = pieces[0][0].shape[0]
    dev = pieces[0][0].device
    width = sum(b.shape[1] for b, _ in pieces)
    pos = torch.arange(width, device=dev)[None, :]
    out = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    start = torch.zeros(n, dtype=torch.int64, device=dev)
    for k, (b, lens) in enumerate(pieces):
        lens = lens.to(torch.int64)
        if keep is not None and keep[k] is not None:
            lens = torch.where(keep[k], lens, 0)
        rel = pos - start[:, None]
        src = torch.gather(b, 1, rel.clamp(0, b.shape[1] - 1))
        out = torch.where((rel >= 0) & (rel < lens[:, None]), src, out)
        start = start + lens
    return out, start


def _picks(dev, gen, n, weights):
    """Seeded choice of one of ``len(weights)`` kinds a row."""
    w = torch.tensor(weights, dtype=torch.float64, device=dev)
    return torch.multinomial(w, n, replacement=True, generator=gen)


def _same_result(got: Column, want: Column) -> bool:
    """The first rows of ``got`` equal ``want`` (on the CPU): every
    validity bit, and every valid value's bytes (a STRING's lengths and
    bytes of every row)."""
    g = head_on_cpu(got, want.size)
    ok = want.valid_bool()
    if not torch.equal(g.valid_bool(), ok):
        return False
    if want.dtype.id == T.TypeId.STRING:
        lg, lw = str_lengths(g), str_lengths(want)
        w = int(lw.max()) if want.size else 0
        return torch.equal(lg, lw) and torch.equal(byte_matrix(g, w)[0],
                                                   byte_matrix(want, w)[0])
    return torch.equal(K.as_bytes(g.data)[ok], K.as_bytes(want.data)[ok])


def same_on_cpu(out: dict, calls: dict, inputs: dict, m: int, what: str):
    """Each call's first ``m`` rows equal the same call with its input's
    first ``m`` rows on the CPU."""
    heads = {k: head_on_cpu(v, min(m, v.size)) for k, v in inputs.items()}
    for name, (fn, arg) in calls.items():
        _require(_same_result(out[name], fn(heads[arg])),
                 f"{what} {name}: the card's first {m} rows differ from the "
                 "CPU's")


def string_phase(name, fn, rows, calls, launches, log, profile):
    """One strings phase (``run_phase``)."""
    return run_phase("strings", name, fn, rows, calls, launches,
                     STRING_NAMES, log, profile)


def _sample(dev, gen, n: int, k: int) -> list:
    return torch.randperm(n, generator=gen, device=dev)[:k].tolist()


def _host_strings(col: Column, rows: list) -> list:
    """The values of ``rows`` of a STRING column, None for nulls."""
    idx = torch.tensor(rows, device=col.device)
    return gather_column(col, idx).to_pylist()


def strings_integers(dev, gen, ss, calls, launches, log, profile):
    """Phase (a): three int64 sources (ss_item_sk and ss_customer_sk of
    store_sales, seeded int64 over the full range with the edges mixed
    in), 10% nulls; their strings with 1% of the rows each wrapped in
    whitespace, '+', a fraction, or replaced by an overflow, an empty
    string or garbage; cast back to INT64, INT32 and INT8, ANSI on an
    all-valid column, and conv 10 -> 16 -> -10."""
    n = STR_ROWS
    wide = torch.randint(-2**63, 2**63 - 1, (n,), generator=gen, device=dev)
    at = torch.arange(0, n, 997, device=dev)
    wide[at] = torch.tensor(INT_EDGES, device=dev)[
        torch.arange(at.numel(), device=dev) % len(INT_EDGES)]
    sources = {k: Column(T.INT64, n, ss.col(k).data.to(torch.int64),
                         _valid_words(dev, gen, n, 0.1))
               for k in ("ss_item_sk", "ss_customer_sk")}
    sources["seeded"] = Column(T.INT64, n, wide,
                               _valid_words(dev, gen, n, 0.1))
    plain = {k: cs.cast_integer_to_string(c) for k, c in sources.items()}
    kinds = len(INT_WRAPS) + len(INT_REPLACE)
    kind = _picks(dev, gen, n, [100 - kinds] + [1] * kinds)
    wrap = (kind - 1).clamp(0, len(INT_WRAPS) - 1)
    swap = (kind - 1 - len(INT_WRAPS)).clamp(0, len(INT_REPLACE) - 1)
    is_wrap = (kind >= 1) & (kind <= len(INT_WRAPS))
    is_swap = kind > len(INT_WRAPS)
    mixed = {}
    for k, s in plain.items():
        mat, lens = byte_matrix(s, 20)
        mat, lens = concat([table_piece(dev, [p for p, _ in INT_WRAPS], wrap),
                            (mat, lens),
                            table_piece(dev, [x for _, x in INT_WRAPS], wrap),
                            table_piece(dev, INT_REPLACE, swap)],
                           keep=[is_wrap, ~is_swap, is_wrap, is_swap])
        mixed[k] = strings_from_matrix(mat, lens, sources[k].valid_bool())
    all_valid = cs.cast_integer_to_string(Column(T.INT64, n, wide))
    del plain

    def fn():
        out = {f"to_string {k}": cs.cast_integer_to_string(c)
               for k, c in sources.items()}
        for k, s in mixed.items():
            for dt in (T.INT64, T.INT32, T.INT8):
                out[f"to {dt.id.name} {k}"] = cs.cast_to_integer(s, dt)
        out["ansi INT64"] = cs.cast_to_integer(all_valid, ansi=True)
        out["conv 10 16"] = cs.conv(mixed["seeded"], 10, 16)
        out["conv 16 -10"] = cs.conv(out["conv 10 16"], 16, -10)
        return out
    out, r = string_phase("integers", fn, n, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == len(out),
             f"K3 launched {r['launches']} times in {len(out)} calls with "
             "nullable results")

    # the first rows on the CPU
    cpu_calls = {f"to_string {k}": (cs.cast_integer_to_string, k)
                 for k in sources}
    for k in mixed:
        for dt in (T.INT64, T.INT32, T.INT8):
            cpu_calls[f"to {dt.id.name} {k}"] = (
                lambda c, dt=dt: cs.cast_to_integer(c, dt), f"mixed {k}")
    cpu_calls["ansi INT64"] = (lambda c: cs.cast_to_integer(c, ansi=True),
                               "all valid")
    cpu_calls["conv 10 16"] = (lambda c: cs.conv(c, 10, 16), "mixed seeded")
    cpu_calls["conv 16 -10"] = (lambda c: cs.conv(c, 16, -10), "hex")
    same_on_cpu(out, cpu_calls, {**sources, **{f"mixed {k}": v for k, v in
                                              mixed.items()},
                                 "all valid": all_valid,
                                 "hex": out["conv 10 16"]},
                STR_CPU_ROWS, "strings integers")

    # round trips on the untouched rows: int -> string -> int exact,
    # narrow types NULL exactly where the value does not fit
    for k, src in sources.items():
        v, ok = src.data, src.valid_bool() & (kind == 0)
        for dt in (T.INT64, T.INT32, T.INT8):
            got = out[f"to {dt.id.name} {k}"]
            info = torch.iinfo(dt.to_torch())
            fits = (v >= info.min) & (v <= info.max)
            gv = got.valid_bool()
            _require(torch.equal(gv[ok], fits[ok])
                     and torch.equal(got.data.to(torch.int64)[ok & fits],
                                     v[ok & fits]),
                     f"{k}: int -> string -> {dt.id.name} is not exact")
    _require(torch.equal(out["ansi INT64"].data, wide)
             and bool(out["ansi INT64"].valid_bool().all()),
             "ANSI: the all-valid column did not come back exact")
    back = out["conv 16 -10"]
    # conv round trip and Python's int on sampled rows; cast_to_integer
    # of the edited rows against Spark's toLong grammar
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    strs = _host_strings(mixed["seeded"], rows)
    got = {name: out[name].data[rows].tolist() for name in (
        "to INT64 seeded", "to INT32 seeded", "to INT8 seeded")}
    okb = {name: out[name].valid_bool()[rows].tolist() for name in got}
    hexs = _host_strings(out["conv 10 16"], rows)
    decs = _host_strings(back, rows)
    for i, s in enumerate(strs):
        for name, (lo, hi) in (("to INT64 seeded", (-2**63, 2**63 - 1)),
                               ("to INT32 seeded", (-2**31, 2**31 - 1)),
                               ("to INT8 seeded", (-128, 127))):
            want = None if s is None else spark_to_long(s, lo, hi)
            have = got[name][i] if okb[name][i] else None
            _require(have == want, f"{name} of {s!r}: {have}, Spark {want}")
        want_hex = None if not s else conv_oracle(s, 10, 16)
        _require(hexs[i] == want_hex,
                 f"conv({s!r}, 10, 16): {hexs[i]}, Python {want_hex}")
        want_dec = None if not want_hex else conv_oracle(want_hex, 16, -10)
        _require(decs[i] == want_dec, f"conv({want_hex!r}, 16, -10): "
                 f"{decs[i]}, Python {want_dec}")
    log(f"strings integers: {len(out)} calls over {n} rows equal the CPU's on "
        f"the first {STR_CPU_ROWS} rows; int -> string -> int exact on the "
        f"{int((kind == 0).sum())} untouched rows of each source; "
        f"cast_to_integer and conv equal Spark's grammar and "
        f"NumberConverter's rules on {SAMPLE_ROWS} sampled rows")
    return r


_WS = " \t\n\x0b\x0c\r"
_LONG = re.compile(r"([+-]?)(\d+)(\.\d*)?")


def spark_to_long(s: str, lo: int, hi: int):
    """Spark's UTF8String.toLong (non-ANSI): trimmed sign and digits, a
    fraction truncated; out of range -> None."""
    m = _LONG.fullmatch(s.strip(_WS))
    if not m:
        return None
    v = int(m[1] + m[2])
    return v if lo <= v <= hi else None


def conv_oracle(s: str, from_base: int, to_base: int):
    """NumberConverter's rules (Spark's conv) on Python ints."""
    neg = s.startswith("-")
    body = s[1:] if neg else s
    v = 0
    for ch in body:
        d = int(ch, 36) if ch.isalnum() and ch.isascii() else 99
        if d >= from_base:
            break
        v = min(v * from_base + d, 2**64 - 1)
    if neg and to_base > 0:
        v = (2**64 - 1) if v >= 2**63 else (-v) % 2**64
    negative = neg and to_base < 0
    if to_base < 0 and v >= 2**63:
        v, negative = 2**64 - v, True
    b = abs(to_base)
    digits = ""
    while True:
        digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"[v % b] + digits
        v //= b
        if not v:
            break
    return ("-" if negative else "") + digits


def java_float_string(x: float, f32: bool) -> str:
    """Java's Double.toString / Float.toString layout of Python's
    shortest round-tripping digits (numpy's for float32)."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "-Infinity" if x < 0 else "Infinity"
    sign = "-" if math.copysign(1.0, x) < 0 else ""
    if x == 0:
        return sign + "0.0"
    if f32:
        mant, e = np.format_float_scientific(
            np.float32(abs(x)), unique=True, trim="-").split("e")
        digs, exp = mant.replace(".", ""), int(e)
    else:
        t = decimal.Decimal(repr(abs(x))).as_tuple()
        digs = "".join(map(str, t.digits))
        exp = len(t.digits) - 1 + t.exponent
    digs = digs.rstrip("0") or "0"
    nd = len(digs)
    if -3 <= exp <= 6:
        if exp >= nd - 1:
            body = digs + "0" * (exp - nd + 1) + ".0"
        elif exp >= 0:
            body = digs[:exp + 1] + "." + digs[exp + 1:]
        else:
            body = "0." + "0" * (-exp - 1) + digs
    else:
        body = digs[0] + "." + (digs[1:] or "0") + "E" + str(exp)
    return sign + body


def _float_bits(dev, gen, n, f32: bool):
    """Random bit patterns of every exponent (subnormals and NaN payloads
    among them), the specials mixed in."""
    if f32:
        x = torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                          dtype=torch.int32).view(torch.float32)
        return _with_specials(x, F32_SPECIALS, 89)
    x = torch.randint(-2**63, 2**63 - 1, (n,), generator=gen,
                      device=dev).view(torch.float64)
    return _with_specials(x, F64_SPECIALS, 97)


def strings_floats(dev, gen, calls, launches, log, profile):
    """Phase (b): float64 and float32 random bit patterns, 10% nulls,
    through cast_float_to_string, 1% each of five literal forms mixed
    into the float64 strings, and cast_to_float back."""
    n = STR_ROWS
    src = {w: Column(T.FLOAT32 if w == 32 else T.FLOAT64, n,
                     _float_bits(dev, gen, n, w == 32),
                     _valid_words(dev, gen, n, 0.1)) for w in (64, 32)}
    plain = fts.cast_float_to_string(src[64])
    kind = _picks(dev, gen, n, [100 - len(FLOAT_LITERALS)]
                  + [1] * len(FLOAT_LITERALS))
    mat, lens = byte_matrix(plain, 26)
    mat, lens = concat([(mat, lens), table_piece(
        dev, FLOAT_LITERALS, (kind - 1).clamp(min=0))],
        keep=[kind == 0, kind > 0])
    mixed = strings_from_matrix(mat, lens, src[64].valid_bool())
    strs32 = fts.cast_float_to_string(src[32])
    del plain

    def fn():
        return {"to_string float64": fts.cast_float_to_string(src[64]),
                "to_string float32": fts.cast_float_to_string(src[32]),
                "to FLOAT64": cs.cast_to_float(mixed),
                "to FLOAT32": cs.cast_to_float(strs32, T.FLOAT32)}
    out, r = string_phase("floats", fn, n, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == len(out),
             f"K3 launched {r['launches']} times in {len(out)} calls")
    same_on_cpu(out, {
        "to_string float64": (fts.cast_float_to_string, "f64"),
        "to_string float32": (fts.cast_float_to_string, "f32"),
        "to FLOAT64": (cs.cast_to_float, "mixed"),
        "to FLOAT32": (lambda c: cs.cast_to_float(c, T.FLOAT32), "s32")},
        {"f64": src[64], "f32": src[32], "mixed": mixed, "s32": strs32},
        STR_CPU_ROWS, "strings floats")

    # float -> string -> float: the ulps between each valid, finite row
    # and its round trip (the reference's arithmetic is not correctly
    # rounded), NaN to NaN and infinities exact
    ulps = {}
    for w, name in ((64, "to FLOAT64"), (32, "to FLOAT32")):
        x, back = src[w].data, out[name]
        ok = src[w].valid_bool() & ((kind == 0) if w == 64 else True)
        _require(bool((back.valid_bool() | ~ok).all()),
                 f"float{w} -> string -> float lost a valid row")
        fin = ok & torch.isfinite(x)
        _require(bool(((torch.isnan(back.data) == torch.isnan(x))
                       & ((back.data == x) | ~torch.isinf(x)) | ~ok).all()),
                 f"float{w} -> string -> float: NaN or infinity changed")
        ints = torch.int64 if w == 64 else torch.int32
        d = (back.data.view(ints).to(torch.int64)
             - x.view(ints).to(torch.int64)).abs()[fin]
        ulps[w] = {k: int(v) for k, v in zip(
            ("rows", "exact", "1 ulp", "more"),
            (d.numel(), (d == 0).sum(), (d == 1).sum(), (d > 1).sum()))}
    # the literal forms
    lit = out["to FLOAT64"].data[kind > 0]
    want = torch.tensor([float(s) for s in FLOAT_LITERALS],
                        dtype=torch.float64, device=dev)[kind[kind > 0] - 1]
    _require(bool(((lit == want) | (torch.isnan(lit) & torch.isnan(want)))
                  .all()), "a literal form parsed wrong")
    # on sampled rows: Java's layout of the shortest digits, the round
    # trip equal to a Python model of the reference's arithmetic, and
    # exact where that arithmetic rounds once
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    literal = (kind[rows] > 0).tolist()
    exact = 0
    for w, name in ((64, "to_string float64"), (32, "to_string float32")):
        got = _host_strings(out[name], rows)
        vals = src[w].data[rows].tolist()
        okv = src[w].valid_bool()[rows].tolist()
        back = out["to FLOAT64" if w == 64 else "to FLOAT32"].data[rows]
        ints = torch.int64 if w == 64 else torch.int32
        back_bits = back.view(ints).tolist()
        nan = torch.isnan(back).tolist()
        for g, v, o, b, bn, lit_row in zip(got, vals, okv, back_bits, nan,
                                           literal):
            want_s = java_float_string(v, w == 32) if o else None
            _require(g == want_s, f"float{w} {v!r}: {g}, Java {want_s}")
            if not o or (w == 64 and lit_row):
                continue
            m = reference_float(g)
            m = np.float64(m) if w == 64 else np.float32(m)
            _require((bn and math.isnan(m)) or b == int(m.view(
                np.int64 if w == 64 else np.int32)),
                f"cast_to_float({g!r}) as float{w}: not the reference's "
                "arithmetic")
            if exact_path(g):
                exact += 1
                _require(bn == math.isnan(v) and (bn or b == int(np.array(
                    v, np.float64 if w == 64 else np.float32).view(
                        np.int64 if w == 64 else np.int32))),
                    f"float{w} {v!r} -> {g} -> float is not exact")
    log(f"strings floats: {len(out)} calls over {n} rows equal the CPU's on "
        f"the first {STR_CPU_ROWS} rows; Java's layout of the shortest "
        f"digits and the reference's arithmetic on {SAMPLE_ROWS} sampled "
        f"rows of each width, {exact} of them on its exact path and back "
        f"bit for bit; round trip of the finite rows in ulps: "
        f"float64 {ulps[64]}, float32 {ulps[32]}")
    return r | {"round_trip_ulps": ulps}


def reference_float(s: str) -> float:
    """The reference's string -> float arithmetic in Python floats (no
    subnormal flush): the first 19 mantissa digits accumulated as
    acc * 10 + d, times the C library's 10.0 ** e."""
    t = s.strip(_WS)
    neg = t[:1] == "-"
    t = t[1:] if t[:1] in "+-" else t
    if t.lower() in ("inf", "infinity"):
        return -math.inf if neg else math.inf
    if t.lower() == "nan":
        return math.nan
    mant, _, exp = t.lower().partition("e")
    ints, _, frac = mant.partition(".")
    acc = 0.0
    for d in (ints + frac)[:19]:
        acc = acc * 10.0 + int(d)
    e = (int(exp or 0) + max(len(ints) - 19, 0)
         - min(len(frac), max(19 - len(ints), 0)))
    v = acc * (0.0 if e < -323 else math.inf if e > 308 else 10.0 ** e)
    return -v if neg else v


def exact_path(s: str) -> bool:
    """Java's form of a finite float whose digits are below 2^53 and whose
    power of ten is 10^0 to 10^22: the reference's one multiply rounds
    it correctly."""
    if s[-1:].isalpha():
        return False  # NaN, Infinity
    mant, _, exp = s.lstrip("-").partition("E")
    ints, _, frac = mant.partition(".")
    return int(ints + frac) <= 2 ** 53 and 0 <= int(exp or 0) - len(frac) <= 22


def strings_decimals(dev, gen, calls, launches, log, profile):
    """Phase (c): seeded DECIMAL64 at scale -2 over the full int64 range,
    10% nulls, through cast_decimal_to_string, then cast_to_decimal at
    scales -2 and 0 (HALF_UP) and to DECIMAL32 (overflow -> NULL)."""
    n = STR_ROWS
    v = torch.randint(-2**63, 2**63 - 1, (n,), generator=gen, device=dev)
    # a third of the rows below 2^31 in magnitude, to fit DECIMAL32
    small = torch.rand(n, generator=gen, device=dev) < 1 / 3
    v = torch.where(small, v % (2**32) - 2**31, v)
    src = Column(T.decimal64(DEC_SCALE), n, v, _valid_words(dev, gen, n, 0.1))
    strs = cs.cast_decimal_to_string(src)

    def fn():
        return {"to_string": cs.cast_decimal_to_string(src),
                "to DECIMAL64(-2)": cs.cast_to_decimal(strs, T.decimal64(-2)),
                "to DECIMAL64(0)": cs.cast_to_decimal(strs, T.decimal64(0)),
                "to DECIMAL32(-2)": cs.cast_to_decimal(strs, T.decimal32(-2))}
    out, r = string_phase("decimals", fn, n, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == len(out),
             f"K3 launched {r['launches']} times in {len(out)} calls")
    same_on_cpu(out, {
        "to_string": (cs.cast_decimal_to_string, "src"),
        "to DECIMAL64(-2)": (lambda c: cs.cast_to_decimal(
            c, T.decimal64(-2)), "strs"),
        "to DECIMAL64(0)": (lambda c: cs.cast_to_decimal(
            c, T.decimal64(0)), "strs"),
        "to DECIMAL32(-2)": (lambda c: cs.cast_to_decimal(
            c, T.decimal32(-2)), "strs")},
        {"src": src, "strs": strs}, STR_CPU_ROWS, "strings decimals")
    ok = src.valid_bool()
    exact = out["to DECIMAL64(-2)"]
    _require(torch.equal(exact.valid_bool(), ok)
             and torch.equal(exact.data[ok], v[ok]),
             "decimal -> string -> decimal is not exact")
    # HALF_UP to scale 0, away from zero: v = 100 q + r, 0 <= r < 100
    q, rem = v // 100, torch.remainder(v, 100)
    want = torch.where(v >= 0, q + (rem >= 50).to(torch.int64),
                       q + (rem > 50).to(torch.int64))
    got = out["to DECIMAL64(0)"]
    _require(torch.equal(got.valid_bool(), ok)
             and torch.equal(got.data[ok], want[ok]),
             "the HALF_UP cast to scale 0 is off")
    fits = ok & (v.abs() <= 2**31 - 1) & (v != -2**63)
    d32 = out["to DECIMAL32(-2)"]
    _require(torch.equal(d32.valid_bool(), fits)
             and torch.equal(d32.data[fits].to(torch.int64), v[fits]),
             "DECIMAL32: NULL not exactly where the value overflows")
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    for g, x, o in zip(_host_strings(out["to_string"], rows),
                       v[rows].tolist(), ok[rows].tolist()):
        want_s = str(decimal.Decimal(x).scaleb(DEC_SCALE)) if o else None
        _require(g == want_s, f"decimal {x}e-2: {g}, Python {want_s}")
    log(f"strings decimals: {len(out)} calls over {n} rows equal the CPU's "
        f"on the first {STR_CPU_ROWS} rows; the round trip exact, HALF_UP "
        f"exact on every row, DECIMAL32 NULL exactly on the "
        f"{int((ok & ~fits).sum())} overflowing rows; Python's Decimal on "
        f"{SAMPLE_ROWS} sampled rows")
    return r


def _fixed_digits(width: int, count: int):
    """Table of the zero-padded decimal strings of 0 .. count - 1."""
    return [f"{i:0{width}d}" for i in range(count)]


def timestamp_strings(dev, gen, ts: Column):
    """The timestamps' strings in every form Spark's cast reads: yyyy,
    yyyy-mm, yyyy-mm-dd, then ' ' or 'T' and hh:mm:ss with 0-6 fraction
    digits and a zone (none, Z, an offset, UTC or a region id); 10%
    nulls. -> (column, form, zone)."""
    n = ts.size
    us = ts.data
    days = torch.div(us, US_PER_DAY, rounding_mode="floor")
    tod = us - days * US_PER_DAY
    y, mo, d = dto.civil_from_days(days)
    form = torch.randint(0, TS_FORMS, (n,), generator=gen, device=dev)
    zone = _picks(dev, gen, n, TS_ZONE_WEIGHTS)
    zone = torch.where(form >= 3, zone, 0)
    sep = torch.randint(0, 2, (n,), generator=gen, device=dev)
    k = (form - 3).clamp(min=0)  # fraction digits
    frac = tod % 1_000_000
    pieces = [table_piece(dev, _fixed_digits(4, 10000), y),
              table_piece(dev, ["-"], torch.zeros_like(y)),
              table_piece(dev, _fixed_digits(2, 13), mo),
              table_piece(dev, ["-"], torch.zeros_like(y)),
              table_piece(dev, _fixed_digits(2, 32), d),
              table_piece(dev, [" ", "T"], sep),
              table_piece(dev, _fixed_digits(2, 24),
                          tod // 3_600_000_000),
              table_piece(dev, [":"], torch.zeros_like(y)),
              table_piece(dev, _fixed_digits(2, 60),
                          tod // 60_000_000 % 60),
              table_piece(dev, [":"], torch.zeros_like(y)),
              table_piece(dev, _fixed_digits(2, 60),
                          tod // 1_000_000 % 60),
              table_piece(dev, ["."], torch.zeros_like(y))]
    keep = [None, form >= 1, form >= 1, form >= 2, form >= 2] + \
        [form >= 3] * 6 + [k > 0]
    for i in range(6):  # the i-th fraction digit
        pieces.append(table_piece(dev, list("0123456789"),
                                  frac // 10 ** (5 - i) % 10))
        keep.append(k > i)
    pieces.append(table_piece(dev, TS_ZONES, zone))
    keep.append(None)
    mat, lens = concat(pieces, keep)
    valid = torch.rand(n, generator=gen, device=dev) >= 0.1
    return strings_from_matrix(mat, lens, valid), form, zone


def python_timestamp(us: int, form: int, zone: int, default_tz: str):
    """(days of the date cast, micros of the timestamp cast or None) of
    the string ``timestamp_strings`` made, by Python's datetime and
    zoneinfo."""
    dt = EPOCH + pydt.timedelta(microseconds=us)
    if form == 0:
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                        microsecond=0)
    elif form == 1:
        dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif form == 2:
        dt = dt.replace(hour=0, minute=0, second=0, microsecond=0)
    else:
        k = form - 3
        dt = dt.replace(microsecond=dt.microsecond // 10 ** (6 - k)
                        * 10 ** (6 - k))
    day = (dt.date() - EPOCH.date()).days
    local = (dt - EPOCH) // ONE_US
    minutes = TS_ZONE_MINUTES[zone]
    if zone == 0:
        if default_tz == "UTC":
            return day, local
        off = dt.replace(tzinfo=ZoneInfo(default_tz), fold=0).utcoffset()
        return day, local - off // ONE_US
    if minutes is None:  # a region id: NULL, as in the reference
        return day, None
    return day, local - minutes * 60_000_000


def strings_dates(dev, gen, ts: Column, calls, launches, log, profile):
    """Phase (d): the roster's 10M timestamps as strings in every form
    Spark reads, cast_to_date and cast_to_timestamp in UTC and in
    America/Los_Angeles."""
    strs, form, zone = timestamp_strings(dev, gen, ts)
    n = strs.size

    def fn():
        return {"to_date": cs.cast_to_date(strs),
                "to_timestamp UTC": cs.cast_to_timestamp(strs, "UTC"),
                f"to_timestamp {LA}": cs.cast_to_timestamp(strs, LA)}
    out, r = string_phase("dates", fn, n, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == len(out),
             f"K3 launched {r['launches']} times in {len(out)} calls")
    same_on_cpu(out, {
        "to_date": (cs.cast_to_date, "s"),
        "to_timestamp UTC": (lambda c: cs.cast_to_timestamp(c, "UTC"), "s"),
        f"to_timestamp {LA}": (lambda c: cs.cast_to_timestamp(c, LA), "s")},
        {"s": strs}, STR_CPU_ROWS, "strings dates")
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    us = ts.data[rows].tolist()
    f, z = form[rows].tolist(), zone[rows].tolist()
    ok = strs.valid_bool()[rows].tolist()
    got = {k: (v.data[rows].tolist(), v.valid_bool()[rows].tolist())
           for k, v in out.items()}
    horizon = _epoch_us(tz.RULE_HORIZON_YEAR, 1, 1)
    held = 0
    for i in range(len(rows)):
        for name, zone_id in (("to_date", None), ("to_timestamp UTC", "UTC"),
                              (f"to_timestamp {LA}", LA)):
            vals, valid = got[name]
            have = vals[i] if valid[i] else None
            if zone_id == LA and z[i] == 0 and not (
                    MIN_US + US_PER_DAY <= us[i] < horizon):
                continue  # past the zone table's horizon: the CPU only
            day, stamp = python_timestamp(us[i], f[i], z[i], zone_id or "UTC")
            want = None if not ok[i] else day if zone_id is None else stamp
            _require(have == want, f"{name} of the form-{f[i]} zone-{z[i]} "
                     f"string of {us[i]} us: {have}, Python {want}")
            held += 1
    log(f"strings dates: {len(out)} calls over {n} rows equal the CPU's on "
        f"the first {STR_CPU_ROWS} rows and Python's datetime and zoneinfo "
        f"in {held} checks on {SAMPLE_ROWS} sampled rows (zone-less "
        f"{LA} rows after {tz.RULE_HORIZON_YEAR} held against the CPU "
        "only)")
    return r


URL_SCHEMES = ("http://", "https://", "ftp://", "s3a://", "HTTP://")
URL_USERS = ("alice@", "u:p@", "x%41y@", "bob.s@")
URL_HOSTS = ("example.com", "www.Example.org", "a.b-c.d", "h0st",
             "x_y~z.io", "10.0.0.1", "192.168.1.254", "[::1]",
             "[2001:db8::7]", "[fe80::1:2]")
URL_PORTS = (":80", ":8080", ":443")
URL_PATHS = ("", "/", "/a/b", "/index.html", "/x.y/z_w", "/%41b/c")
URL_KEYS = ("k", "id", "q", "pg", "x")
URL_VALUES = ("1", "abc", "", "a%20b", "42")
URL_FRAGS = ("#top", "#s-2", "#")
URL_BAD = ("# x", "#a|b", "%zz", "%4")  # a forbidden byte, a bad escape
URL_MAX = 96


def url_strings(dev, gen, n: int):
    """Seeded URLs: hierarchical (scheme, userinfo, host, port, path, 1-6
    query keys, fragment), opaque mailto: and relative ones; 1% with a
    forbidden byte or a bad '%' escape; 10% nulls. -> (column, picks)."""
    def pick(count):
        return torch.randint(0, count, (n,), generator=gen, device=dev)

    def some(p):
        return torch.rand(n, generator=gen, device=dev) < p
    p = {"kind": _picks(dev, gen, n, (85, 8, 7)),  # hier, mailto, relative
         "scheme": pick(len(URL_SCHEMES)), "user": pick(len(URL_USERS)),
         "host": pick(len(URL_HOSTS)), "port": pick(len(URL_PORTS)),
         "path": pick(len(URL_PATHS)), "nkeys": pick(7),
         "frag": pick(len(URL_FRAGS)), "bad": pick(len(URL_BAD)),
         "has_user": some(0.3), "has_port": some(0.3),
         "has_frag": some(0.3), "is_bad": some(0.01)}
    p["keys"] = [pick(len(URL_KEYS)) for _ in range(6)]
    p["values"] = [pick(len(URL_VALUES)) for _ in range(6)]
    hier, mail = p["kind"] == 0, p["kind"] == 1
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    pieces = [table_piece(dev, URL_SCHEMES, p["scheme"]),
              table_piece(dev, ["mailto:"], zero),
              table_piece(dev, URL_USERS, p["user"]),
              table_piece(dev, URL_HOSTS, p["host"]),
              table_piece(dev, URL_PORTS, p["port"]),
              table_piece(dev, URL_PATHS, p["path"])]
    keep = [hier, mail, (hier | mail) & p["has_user"], hier | mail,
            hier & p["has_port"], ~mail]
    for i in range(6):
        pieces += [table_piece(dev, ["?" if i == 0 else "&"], zero),
                   table_piece(dev, URL_KEYS, p["keys"][i]),
                   table_piece(dev, ["="], zero),
                   table_piece(dev, URL_VALUES, p["values"][i])]
        keep += [p["nkeys"] > i] * 4
    pieces += [table_piece(dev, URL_FRAGS, p["frag"]),
               table_piece(dev, URL_BAD, p["bad"])]
    keep += [p["has_frag"], p["is_bad"]]
    mat, lens = concat(pieces, keep)
    lens = lens.clamp(max=URL_MAX)
    valid = torch.rand(n, generator=gen, device=dev) >= 0.1
    return strings_from_matrix(mat[:, :URL_MAX], lens, valid), p


def python_url_parts(p: dict, i: int) -> dict:
    """The parts java.net.URI gives the URL ``url_strings`` composed from
    picks ``p`` at row ``i`` (host ints), None where absent."""
    kind = p["kind"][i]
    user = URL_USERS[p["user"][i]][:-1] if p["has_user"][i] else None
    host = URL_HOSTS[p["host"][i]]
    port = URL_PORTS[p["port"][i]] if p["has_port"][i] else ""
    path = URL_PATHS[p["path"][i]]
    pairs = [(URL_KEYS[p["keys"][j][i]], URL_VALUES[p["values"][j][i]])
             for j in range(p["nkeys"][i])]
    query = "&".join(f"{k}={v}" for k, v in pairs) if pairs else None
    ref = URL_FRAGS[p["frag"][i]][1:] if p["has_frag"][i] else None
    key_k = next((v for k, v in pairs if k == "k"), None)
    if kind == 1:  # mailto:[user@]host[?query]: opaque, no query parsed
        return {"PROTOCOL": "mailto", "HOST": None, "PATH": None,
                "QUERY": None, "REF": ref, "AUTHORITY": None, "FILE": None,
                "USERINFO": None, "QUERY k": None}
    scheme = URL_SCHEMES[p["scheme"][i]][:-3] if kind == 0 else None
    auth = ((user + "@" if user else "") + host + port) if kind == 0 \
        else None
    return {"PROTOCOL": scheme, "HOST": host if kind == 0 else None,
            "PATH": path, "QUERY": query, "REF": ref, "AUTHORITY": auth,
            "FILE": path + ("?" + query if query is not None else ""),
            "USERINFO": user if kind == 0 else None, "QUERY k": key_k}


URL_PARTS = ("PROTOCOL", "HOST", "PATH", "QUERY", "REF", "AUTHORITY",
             "FILE", "USERINFO")


def strings_urls(dev, gen, calls, launches, log, profile):
    """Phase (e): 10M seeded URLs through parse_url for each of the eight
    parts and for QUERY with the key 'k'."""
    urls, picks = url_strings(dev, gen, STR_ROWS)
    n = urls.size

    def fn():
        out = {part: pu.parse_url(urls, part) for part in URL_PARTS}
        out["QUERY k"] = pu.parse_url(urls, "QUERY", "k")
        return out
    out, r = string_phase("urls", fn, n, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == len(out),
             f"K3 launched {r['launches']} times in {len(out)} calls")
    cpu_calls = {part: (lambda c, part=part: pu.parse_url(c, part), "u")
                 for part in URL_PARTS}
    cpu_calls["QUERY k"] = (lambda c: pu.parse_url(c, "QUERY", "k"), "u")
    same_on_cpu(out, cpu_calls, {"u": urls}, STR_CPU_ROWS, "strings urls")
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    hp = {k: ([t[rows].tolist() for t in v] if isinstance(v, list)
              else v[rows].tolist()) for k, v in picks.items()}
    ok = urls.valid_bool()[rows].tolist()
    lens = str_lengths(urls)[rows].tolist()
    got = {k: _host_strings(v, rows) for k, v in out.items()}
    held = 0
    for i in range(len(rows)):
        if lens[i] >= URL_MAX:
            continue  # cut at 96 bytes: held against the CPU only
        if hp["is_bad"][i]:
            want = dict.fromkeys(got)  # NULL in every part
        else:
            want = python_url_parts(hp, i)
        for part, vals in got.items():
            w = want[part] if ok[i] else None
            _require(vals[i] == w, f"parse_url {part} of "
                     f"{_host_strings(urls, [rows[i]])[0]!r}: {vals[i]}, "
                     f"the composed part {w}")
            held += 1
    log(f"strings urls: {len(out)} calls over {n} URLs equal the CPU's on "
        f"the first {STR_CPU_ROWS} rows and the parts they were composed "
        f"of in {held} checks on {SAMPLE_ROWS} sampled rows (the "
        f"{sum(x >= URL_MAX for x in lens)} cut at {URL_MAX} bytes held "
        "against the CPU only)")
    return r


def _python_re(pattern: str, strs: list, full: bool) -> list:
    """Python's re with ASCII classes (Java's \\d \\w \\s), None on
    null rows."""
    rx_ = re.compile(pattern, re.ASCII)
    fn = rx_.fullmatch if full else rx_.search
    return [None if s is None else int(bool(fn(s))) for s in strs]


def strings_regex(dev, gen, col: Column, calls, launches, log, profile):
    """Phase (f): the hashing step's 0-32-byte UTF-8 STRING column through
    regexp_contains and regexp_full_match with patterns of the device
    subset; none may take the host route."""
    n = col.size

    def fn():
        out = {f"contains {p}": rx.regexp_contains(col, p)
               for p in REGEX_PATTERNS}
        out |= {f"full_match {p}": rx.regexp_full_match(col, p)
                for p in REGEX_FULL}
        return out
    out, r = string_phase("regex", fn, n, calls, launches, log, profile)
    fallbacks = r["counters"].get("regexp.host_fallback_calls", 0)
    _require(fallbacks == 0, f"{fallbacks} device-subset pattern calls took "
             "the host route")
    _require(r["launches"]["bitmask_pack"] == len(out),
             f"K3 launched {r['launches']} times in {len(out)} calls")
    cpu_calls = {f"contains {p}": (lambda c, p=p: rx.regexp_contains(c, p),
                                   "s") for p in REGEX_PATTERNS}
    cpu_calls |= {f"full_match {p}": (lambda c, p=p: rx.regexp_full_match(
        c, p), "s") for p in REGEX_FULL}
    same_on_cpu(out, cpu_calls, {"s": col}, STR_CPU_ROWS, "strings regex")
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    strs = _host_strings(col, rows)
    for name, c in out.items():
        kind, pattern = name.split(" ", 1)
        want = _python_re(pattern, strs, kind == "full_match")
        got = [v if ok else None for v, ok in zip(
            c.data[rows].tolist(), c.valid_bool()[rows].tolist())]
        _require(got == want, f"{name} differs from Python's re on the "
                 "sampled rows")
    log(f"strings regex: {len(out)} calls over {n} rows, none on the host "
        f"route, equal the CPU's on the first {STR_CPU_ROWS} rows and "
        f"Python's re on {SAMPLE_ROWS} sampled rows")
    return r


def strings_head(dev, gen, col: Column, calls, launches, log, profile):
    """Phase (g): host code on a 100,000-row head: a backreference
    through regexp's host route, regexp_extract, and format_number of
    float64, INT64 and DECIMAL64 at d = 0, 2 and 5."""
    m = HEAD_ROWS
    head = rc.slice_rows(col, 0, m)
    nums = {"float64": Column(T.FLOAT64, m, torch.randn(
                m, generator=gen, device=dev, dtype=torch.float64) * 1e6,
                _valid_words(dev, gen, m, 0.1)),
            "int64": Column(T.INT64, m, torch.randint(
                -2**63, 2**63 - 1, (m,), generator=gen, device=dev),
                _valid_words(dev, gen, m, 0.1))}
    nums["decimal64"] = Column(T.decimal64(-2), m, nums["int64"].data,
                               nums["int64"].validity)

    def calls_on(s, cols):
        out = {"host route": rx.regexp_contains(s, REGEX_HOST)}
        out |= {f"extract {p} {g}": rx.regexp_extract(s, p, g)
                for p, g in EXTRACT}
        out |= {f"format_number {k} {d}": cs.format_number(c, d)
                for k, c in cols.items() for d in FORMAT_DIGITS}
        return out
    out, r = string_phase("head", lambda: calls_on(head, nums), m, calls,
                          launches, log, profile)
    _require(r["counters"].get("regexp.host_fallback_calls") == 1,
             "the backreference did not take the host route once")
    _require(r["launches"]["bitmask_pack"] == 1,
             "K3 did not pack the host route's validity")
    want = calls_on(head_on_cpu(head, m),
                    {k: head_on_cpu(c, m) for k, c in nums.items()})
    for name, c in want.items():
        _require(_same_result(out[name], c), f"strings head {name} differs "
                 "from the CPU's")
    strs = head_on_cpu(head, m).to_pylist()
    _require(out["host route"].to_pylist()
             == [None if s is None else int(bool(re.search(REGEX_HOST, s)))
                 for s in strs], "the host route differs from Python's re")
    log(f"strings head: {len(out)} host calls over {m} rows equal the "
        "CPU's; the host route equals Python's re")
    return r


def run_strings(dev, gen, ss, ts: Column, text: Column, log,
                profile: bool = False):
    """Step 8: the cast and string-function phases."""
    calls, launches, phases = [], {}, []
    phases.append(strings_integers(dev, gen, ss, calls, launches, log,
                                   profile))
    phases.append(strings_floats(dev, gen, calls, launches, log, profile))
    phases.append(strings_decimals(dev, gen, calls, launches, log, profile))
    phases.append(strings_dates(dev, gen, ts, calls, launches, log,
                                profile))
    phases.append(strings_urls(dev, gen, calls, launches, log, profile))
    phases.append(strings_regex(dev, gen, text, calls, launches, log,
                                profile))
    phases.append(strings_head(dev, gen, text, calls, launches, log,
                               profile))
    for name in STRING_NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the strings path")
    return {"phases": phases, "launches": launches}, calls


# --------------------------------------------------------------------------
# Roster II: copying, conditionals, z-order, percentiles, JSON and maps
# --------------------------------------------------------------------------

ROSTER2_NAMES = ("bitmask_pack",)
R2_CPU_ROWS, MAP_ROWS = 1_000_000, 100_000
ZORDER_ROWS, JSON_ROWS = 10_000_000, 10_000_000
R2_PCTS = (0.0, 0.25, 0.5, 0.99, 1.0)
TDIGEST_DELTA = 100
QTY_CUT = 10  # ss_quantity is 1-20: the filter keeps about half the rows
# the documents: pieces picked a row (weights beside), 16-128 bytes
JSON_OPEN = ('{"a":', '{ "a" : ', '{\n  "a": ', '{"a" :')
JSON_PAD = tuple(" " * i for i in range(2, 30, 3))
JSON_A = ('{"b":1,"c":"x"}', '{"b": [10, 20], "c": null}',
          '[1,{"c":"deep"},true]', '[ {"c": 2} , {"c": "y"} ]', '"str"',
          '-12.5e3', 'null', '{"b":{"c":[7,8]}}', '{ "b" : "spaced" }',
          '[]', '{}', '[0,{"c":{"d":1}}]')
JSON_MID = (',"k":', ', "k" : ', ',\n  "k": ', ',"b":[1,2],"k":')
JSON_K = ('"v"', '42', '"a long value, with commas, and spaces"', 'true',
          '[1, 2, 3]', '{"z": "w"}', '""', '"q\\"t"', '"e\\n\\u00e9"',
          '"\\ud83d\\ude00 x"')
JSON_K_WEIGHTS = (30, 20, 15, 10, 10, 8, 7, 1 / 3, 1 / 3, 1 / 3)  # 1% escapes
JSON_TAIL = ('}', ' }', '\n}', ',"n":null}')
JSON_PATHS = ("$.a", "$.a.b", "$.a[1].c", "$['k']", "$.a.c", "$.a[0]",
              "$.b", "$", "$.a.b.c[0]")


def roster2_phase(name, fn, rows, calls, launches, log, profile):
    """One roster II phase (``run_phase``), then the synchronising CUDA
    calls of one more run (``torch.cuda.set_sync_debug_mode``)."""
    out, r = run_phase("roster II", name, fn, rows, calls, launches,
                       ROSTER2_NAMES, log, profile)
    _, r["syncs"] = _count_syncs(fn)
    host = {k: v for k, v in r["counters"].items()
            if k.startswith(("get_json_object.", "map_utils."))}
    log(f"roster II {name}: {r['syncs']} synchronising calls a run; "
        f"host routes {json.dumps(host)}")
    return out, r


def _to_cpu(col: Column) -> Column:
    return Column(col.dtype, col.size,
                  None if col.data is None else col.data.cpu(),
                  None if col.validity is None else col.validity.cpu(),
                  children=tuple(_to_cpu(c) for c in col.children),
                  field_names=col.field_names)


def _rows(col: Column, start: int, end: int) -> Column:
    """Rows [start, end) of a column of any type, on its device."""
    return gather_column(col, torch.arange(start, min(end, col.size),
                                           device=col.device))


def _rows_cpu(col: Column, start: int, end: int) -> Column:
    """Rows [start, end) of a column of any type, on the CPU."""
    return _to_cpu(_rows(col, start, end))


def _same_column(got: Column, want: Column) -> bool:
    """Every validity bit, every valid value's bytes, and a STRING's,
    LIST's or STRUCT's offsets and children, of two CPU columns."""
    if got.size != want.size or got.dtype.id != want.dtype.id or \
            not torch.equal(got.valid_bool(), want.valid_bool()):
        return False
    if want.dtype.id == T.TypeId.STRING:
        return _same_result(got, want)
    if want.data is not None:
        ok = want.valid_bool()
        return torch.equal(K.as_bytes(got.data)[ok],
                           K.as_bytes(want.data)[ok])
    if want.dtype.id == T.TypeId.LIST:
        return torch.equal(got.offsets.data, want.offsets.data) and \
            _same_column(got.child, want.child)
    return all(_same_column(g, w) for g, w in zip(got.children,
                                                  want.children))


def _same_outputs(out: dict, want: dict) -> list:
    """The names of the results (Columns or Tables) whose first rows on
    the card differ from ``want``'s on the CPU."""
    bad = []
    for name, w in want.items():
        g = out[name]
        gc = g.columns if isinstance(g, Table) else [g]
        wc = w.columns if isinstance(w, Table) else [w]
        if not all(_same_column(_rows_cpu(a, 0, b.size), b)
                   for a, b in zip(gc, wc)):
            bad.append(name)
    return bad


def _nullable(col: Column, dev, gen, share: float) -> Column:
    return Column(col.dtype, col.size, col.data,
                  _valid_words(dev, gen, col.size, share))


def _host_pair(col: Column):
    return col.data.cpu().numpy(), col.valid_bool().cpu().numpy()


def roster2_copying(dev, gen, ss, text: Column, calls, launches, log,
                    profile):
    """Phase (a): apply_boolean_mask by ss_quantity > 10 (10% NULL
    quantities drop), slice_rows, concatenate of two halves, if_else, a
    four-branch case_when and coalesce over store_sales, with the
    hashing step's STRING column and a STRUCT beside; against numpy."""
    c = {k: ss.col(f"ss_{k}") for k in ("item_sk", "net_profit",
                                        "quantity", "store_sk", "promo_sk",
                                        "sales_price")}
    n = c["item_sk"].size
    _require(text.size >= n, "the STRING column is shorter than store_sales")
    strs = text if text.size == n else rc.slice_rows(text, 0, n)
    qty = _nullable(c["quantity"], dev, gen, 0.1)
    keep = Column(T.BOOL8, n, (qty.data > QTY_CUT).to(torch.int8),
                  qty.validity)
    profit = _nullable(c["net_profit"], dev, gen, 0.1)
    price = _nullable(c["sales_price"], dev, gen, 0.3)
    neg = Column(T.FLOAT64, n, -c["net_profit"].data,
                 _valid_words(dev, gen, n, 0.05))
    pair = Column.struct_from_children(
        [c["store_sk"], _nullable(c["promo_sk"], dev, gen, 0.05)],
        field_names=("store", "promo"))
    table = Table([c["item_sk"], profit, strs, pair])
    conds = [Column(T.BOOL8, n, (qty.data > 15).to(torch.int8),
                    qty.validity),
             keep,
             Column(T.BOOL8, n, (profit.data < 0).to(torch.int8),
                    profit.validity),
             Column(T.BOOL8, n, (c["item_sk"].data % 2 == 0).to(torch.int8))]
    values = [profit, neg, price, Column(T.FLOAT64, n, c["sales_price"].data
                                         * 2)]
    cut = (n // 7, n - n // 5)

    def fn():
        return {"mask": apply_boolean_mask(table, keep),
                "slice": slice_rows(table, *cut),
                "concat": concatenate([slice_rows(table, 0, n // 2),
                                       slice_rows(table, n // 2, n)]),
                "if_else": if_else(keep, profit, neg),
                "case_when": case_when(list(zip(conds, values))),
                "coalesce": coalesce([price, profit, neg])}
    out, r = roster2_phase("copying", fn, n, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] > 0,
             "K3 packed no copied or conditional validity")

    # numpy: every row of the fixed-width results, STRING lengths
    t0 = time.perf_counter()
    h = {k: _host_pair(v) for k, v in (("item", c["item_sk"]),
                                       ("profit", profit), ("neg", neg),
                                       ("price", price), ("qty", qty),
                                       ("promo", pair.children[1]))}
    h["store"] = _host_pair(c["store_sk"])
    h["v3"] = (_host(values[3]), np.ones(n, bool))
    lens = str_lengths(strs).cpu().numpy()
    svalid = strs.valid_bool().cpu().numpy()
    q, qv = h["qty"]
    sel = {"mask": np.flatnonzero((q > QTY_CUT) & qv),
           "slice": np.arange(*cut), "concat": np.arange(n)}
    for name, rows in sel.items():
        t = out[name]
        _require(t.num_rows == rows.size, f"{name}: {t.num_rows} rows, "
                 f"numpy {rows.size}")
        for col, key in ((t.columns[0], "item"), (t.columns[1], "profit"),
                         (t.columns[3].children[0], "store"),
                         (t.columns[3].children[1], "promo")):
            got, ok = _host_pair(col)
            vals, valid = h[key]
            _require(np.array_equal(ok, valid[rows]) and np.array_equal(
                got[ok], vals[rows][ok]), f"{name} {key} differs from numpy")
        _require(np.array_equal(str_lengths(t.columns[2]).cpu().numpy(),
                                lens[rows]) and np.array_equal(
            t.columns[2].valid_bool().cpu().numpy(), svalid[rows]),
            f"{name}: STRING lengths or validity differ from numpy")
    whole = out["concat"]
    _require(torch.equal(whole.columns[2].child.data, strs.child.data[
        int(strs.offsets.data[0]):int(strs.offsets.data[-1])]),
        "the halves' STRING bytes differ from the column's")
    cv = [(conds[i].data.cpu().numpy() != 0)
          & conds[i].valid_bool().cpu().numpy() for i in range(4)]
    (p, pv), (m_, mv), (s, sv) = h["profit"], h["neg"], h["price"]
    want = {"if_else": (np.where(cv[1], p, m_), np.where(cv[1], pv, mv)),
            "coalesce": (np.where(sv, s, np.where(pv, p, m_)), sv | pv | mv)}
    data, valid = np.zeros(n), np.zeros(n, bool)
    for i in reversed(range(4)):
        v, ok = (h["profit"], h["neg"], h["price"], h["v3"])[i]
        data, valid = np.where(cv[i], v, data), np.where(cv[i], ok, valid)
    want["case_when"] = (data, valid)
    for name, (vals, valid) in want.items():
        got, ok = _host_pair(out[name])
        _require(np.array_equal(ok, valid) and np.array_equal(
            got[ok], vals[ok]), f"{name} differs from numpy")
    oracle_s = time.perf_counter() - t0

    # the card's first rows against the same calls on the CPU
    m = min(R2_CPU_ROWS, n // 2)

    def rows(t, a, b):
        return Table([_rows_cpu(x, a, b) for x in t.columns])
    hc = [_rows_cpu(x, 0, m) for x in conds]
    hv = [_rows_cpu(x, 0, m) for x in values]
    cpu_out = {"mask": apply_boolean_mask(rows(table, 0, m), hc[1]),
               "slice": slice_rows(rows(table, cut[0], cut[0] + m), 0, m),
               "concat": concatenate([rows(table, 0, m // 2),
                                      rows(table, m // 2, m)]),
               "if_else": if_else(hc[1], hv[0], hv[1]),
               "case_when": case_when(list(zip(hc, hv))),
               "coalesce": coalesce([hv[2], hv[0], hv[1]])}
    bad = _same_outputs(out, cpu_out)
    _require(not bad, f"copying {bad}: the card's first rows differ from "
             "the same calls on the CPU")
    log(f"roster II copying: mask kept {out['mask'].num_rows} of {n} rows, "
        f"slice {cut}, the halves equal the table; if_else, case_when "
        f"and coalesce equal numpy on every row (oracle_s={oracle_s:.3f}) "
        f"and the CPU on the first {m}")
    return r | {"kept": out["mask"].num_rows, "oracle_s": oracle_s}


def interleave_oracle(vals) -> bytes:
    """Delta InterleaveBits, bit by bit: bit t of the output (MSB first)
    is bit t // k (from the MSB) of column t % k."""
    k = len(vals)
    out = bytearray(4 * k)
    for t in range(32 * k):
        b = (vals[t % k] >> (31 - t // k)) & 1
        out[t >> 3] |= b << (7 - (t & 7))
    return bytes(out)


def hilbert_oracle(coords, num_bits: int) -> int:
    """Skilling's transpose, one coordinate at a time."""
    x = list(coords)
    k = len(x)
    q = 1 << (num_bits - 1)
    while q > 1:
        p = q - 1
        for i in range(k):
            if x[i] & q:
                x[0] ^= p
            else:
                t = (x[0] ^ x[i]) & p
                x[0] ^= t
                x[i] ^= t
        q >>= 1
    for i in range(1, k):
        x[i] ^= x[i - 1]
    t, q = 0, 1 << (num_bits - 1)
    while q > 1:
        if x[k - 1] & q:
            t ^= q - 1
        q >>= 1
    idx = 0
    for b in range(num_bits - 1, -1, -1):
        for i in range(k):
            idx = (idx << 1) | (((x[i] ^ t) >> b) & 1)
    return idx


def roster2_zorder(dev, gen, calls, launches, log, profile):
    """Phase (b): interleave_bits over four 10M-row INT32 columns with 10%
    nulls (16 bytes a row out), hilbert_index at k = 3 x 21 bits and
    k = 2 x 31 bits; against the oracles on sampled rows."""
    n = ZORDER_ROWS
    cols = [Column(T.INT32, n, _randint(dev, gen, n, -2**31, 2**31,
                                        torch.int32),
                   _valid_words(dev, gen, n, 0.1)) for _ in range(4)]
    shapes = (("hilbert 3 x 21", 3, 21), ("hilbert 2 x 31", 2, 31))

    def calls_on(cs_):
        out = {"interleave": zorder.interleave_bits(Table(cs_))}
        out |= {name: zorder.hilbert_index(Table(cs_[:k]), bits)
                for name, k, bits in shapes}
        return out
    out, r = roster2_phase("z-order", lambda: calls_on(cols), n, calls,
                           launches, log, profile)
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    idx = torch.tensor(rows, device=dev)
    u32 = [torch.where(c.valid_bool(), c.data.to(torch.int64) & 0xFFFFFFFF,
                       0)[idx].tolist() for c in cols]
    raw = out["interleave"].child.data.view(torch.uint8).reshape(n, 16)[
        idx].cpu().numpy()
    for j, row in enumerate(rows):
        vals = [u[j] for u in u32]
        _require(raw[j].tobytes() == interleave_oracle(vals),
                 f"interleave_bits differs from the oracle at row {row}")
        for name, k, bits in shapes:
            got = int(out[name].data[row])
            _require(got == hilbert_oracle([v & ((1 << bits) - 1)
                                            for v in vals[:k]], bits),
                     f"{name} differs from the oracle at row {row}")
    m = R2_CPU_ROWS
    want = calls_on([_rows_cpu(c, 0, m) for c in cols])
    bad = _same_outputs(out, want)
    _require(not bad, f"z-order {bad}: the card's first {m} rows differ "
             "from the CPU's")
    log(f"roster II z-order: {out['interleave'].child.size} interleaved "
        f"bytes; every call equals the bit-by-bit oracles on {SAMPLE_ROWS} "
        f"sampled rows and the CPU on the first {m}")
    return r


def k1_rank_bound(p: float, n: int, delta: int) -> float:
    """Twice the widest k1 cluster near quantile ``p`` (in quantile
    units: a cluster spans one unit of k(q) = delta / (2 pi) asin(2q - 1)
    + delta / 4), plus a row either side: a merged digest's estimate
    lies within it of the exact rank."""
    def q_of(k):
        k = min(max(k, 0.0), delta / 2)
        return (math.sin(2 * math.pi * k / delta - math.pi / 2) + 1) / 2
    k = delta / (2 * math.pi) * math.asin(2 * p - 1) + delta / 4
    widest = max(q_of(j + 1) - q_of(j)
                 for j in range(math.floor(k) - 1, math.floor(k) + 2))
    return 2 * widest + 2 / n


def roster2_percentiles(dev, gen, ss, calls, launches, log, profile):
    """Phase (c): store_sales by ss_item_sk: exact percentiles of
    ss_net_profit (10% NULL) against pandas, the histogram of ss_quantity
    against pandas' counts, its merge from halves, percentiles off it,
    and a t-digest merged from halves within the k1 rank bound."""
    item = ss.col("ss_item_sk")
    n = item.size
    profit = _nullable(ss.col("ss_net_profit"), dev, gen, 0.1)
    qty = ss.col("ss_quantity")
    keys = Table([item])
    cut = n // 2
    parts = [(slice_rows(keys, a, b), slice_rows(Table([profit, qty]), a, b))
             for a, b in ((0, cut), (cut, n))]

    def calls_on(keys, profit, qty, parts):
        out = {"percentile": hg.group_percentile(keys, profit, R2_PCTS),
               "histogram": hg.group_histogram(keys, qty),
               "merged": hg.merge_histograms([hg.group_histogram(
                   k, v.columns[1]) for k, v in parts]),
               "qty percentile": hg.group_percentile(keys, qty, R2_PCTS)}
        out["from histogram"] = hg.percentile_from_histogram(
            out["histogram"][1], R2_PCTS)
        out["digest"] = td.merge_tdigests([td.group_tdigest(
            k, v.columns[0], TDIGEST_DELTA) for k, v in parts],
            TDIGEST_DELTA)
        out["approx"] = td.percentile_approx(out["digest"][1], R2_PCTS)
        return out
    out, r = roster2_phase("percentiles",
                           lambda: calls_on(keys, profit, qty, parts), n,
                           calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] > 0,
             "K3 packed no percentile validity")

    t0 = time.perf_counter()
    p, pv = _host_pair(profit)
    df = pd.DataFrame({"item": _host(item), "profit": np.where(pv, p, np.nan),
                       "qty": _host(qty)})
    want = df.groupby("item", sort=True).profit.quantile(
        list(R2_PCTS)).unstack()
    pct = out["percentile"]
    _require(np.array_equal(_host(pct.columns[0]), want.index.to_numpy()),
             "percentile groups differ from pandas'")
    for i, q in enumerate(R2_PCTS):
        got, ok = _host_pair(pct.columns[1 + i])
        exp = want[q].to_numpy()
        _require(np.array_equal(ok, ~np.isnan(exp)), f"p={q}: NULL groups "
                 "differ from pandas' all-NULL groups")
        np.testing.assert_allclose(got[ok], exp[ok], rtol=1e-12, atol=0,
                                   err_msg=f"group_percentile p={q}")
    counts = df.groupby(["item", "qty"], sort=True).size()
    hk, hist = out["histogram"]
    _require(np.array_equal(hist.child.children[0].data.cpu().numpy(),
                            counts.index.get_level_values(1).to_numpy())
             and np.array_equal(hist.child.children[1].data.cpu().numpy(),
                                counts.to_numpy()),
             "the histogram differs from pandas' counts")
    mk, mh = out["merged"]
    _require(_same_column(_to_cpu(mk.columns[0]), _to_cpu(hk.columns[0]))
             and torch.equal(mh.offsets.data, hist.offsets.data) and all(
                 torch.equal(a.data, b.data) for a, b in
                 zip(mh.child.children, hist.child.children)),
             "the histogram merged from halves differs from the whole's")
    for a, b in zip(out["from histogram"].columns,
                    out["qty percentile"].columns[1:]):
        _require(torch.equal(a.valid_bool(), b.valid_bool()) and torch.equal(
            a.data[b.valid_bool()], b.data[b.valid_bool()]),
            "percentile_from_histogram differs from group_percentile")
    # the digest's estimates against the exact ranks of each group
    dk = out["digest"][0]
    gkeys = _host(dk.columns[0])
    order = np.lexsort((np.where(pv, p, np.inf), df["item"].to_numpy()))
    sk, sv, sok = df["item"].to_numpy()[order], p[order], pv[order]
    bounds = np.searchsorted(sk, gkeys), np.searchsorted(sk, gkeys, "right")
    worst = 0.0
    for i, q in enumerate(R2_PCTS):
        est, ok = _host_pair(out["approx"].columns[i])
        for g in range(len(gkeys)):
            vals = sv[bounds[0][g]:bounds[1][g]][sok[bounds[0][g]:
                                                      bounds[1][g]]]
            _require(ok[g] == (vals.size > 0), "a digest's NULL differs "
                     "from its group's values")
            if not vals.size:
                continue
            lo = np.searchsorted(vals, est[g], "left") / vals.size
            hi = np.searchsorted(vals, est[g], "right") / vals.size
            err = max(lo - q, q - hi, 0.0)
            worst = max(worst, err / k1_rank_bound(q, vals.size,
                                                   TDIGEST_DELTA))
    _require(worst <= 1.0, f"percentile_approx misses the k1 rank bound "
             f"(worst {worst:.3f} of it)")
    oracle_s = time.perf_counter() - t0

    m = R2_CPU_ROWS
    sub = [(Table([_rows_cpu(item, a, b)]),
            Table([_rows_cpu(profit, a, b), _rows_cpu(qty, a, b)]))
           for a, b in ((0, m // 2), (m // 2, m))]
    head = (Table([_rows_cpu(item, 0, m)]), _rows_cpu(profit, 0, m),
            _rows_cpu(qty, 0, m))
    card = calls_on(Table([_rows(item, 0, m)]), _rows(profit, 0, m),
                    _rows(qty, 0, m),
                    [(Table([_rows(item, a, b)]),
                      Table([_rows(profit, a, b), _rows(qty, a, b)]))
                     for a, b in ((0, m // 2), (m // 2, m))])
    cpu = calls_on(*head, sub)
    for name in ("percentile", "qty percentile", "from histogram"):
        for a, b in zip(card[name].columns, cpu[name].columns):
            _require(_same_column(_to_cpu(a), b), f"{name}: the card's "
                     f"result on the first {m} rows differs from the CPU's")
    for name in ("histogram", "merged"):
        (ka, la), (kb, lb) = card[name], cpu[name]
        _require(_same_column(_to_cpu(ka.columns[0]), kb.columns[0])
                 and _same_column(_to_cpu(la), lb), f"{name}: the card's "
                 f"result on the first {m} rows differs from the CPU's")
    (ka, da), (kb, db) = card["digest"], cpu["digest"]
    w = db.child.children[1].data
    bound = 1e-9 * float(np.abs(p[:m][pv[:m]]).sum()) / w
    _require(_same_column(_to_cpu(ka.columns[0]), kb.columns[0])
             and torch.equal(da.offsets.data.cpu(), db.offsets.data)
             and torch.equal(da.child.children[1].data.cpu(), w)
             and bool(((da.child.children[0].data.cpu()
                        - db.child.children[0].data).abs() <= bound).all()),
             f"digest: the card's on the first {m} rows differs from the "
             "CPU's beyond its bound")
    log(f"roster II percentiles: {pct.num_rows} groups equal pandas "
        f"(rtol 1e-12), the histogram its counts ({hist.child.size} runs), "
        f"the halves' merge the whole, percentiles off the histogram the "
        f"direct ones; the merged digest's estimates within "
        f"{worst:.3f} of the k1 rank bound (oracle_s={oracle_s:.3f}); "
        f"the first {m} rows' calls equal the CPU's")
    return r | {"groups": pct.num_rows, "k1_bound_share": worst,
                "oracle_s": oracle_s}


def json_documents(dev, gen, n: int) -> Column:
    """``n`` seeded JSON documents of 16-128 bytes built on the card:
    nested objects and arrays, four whitespace styles, 1% with escapes
    (a quote, \\n and \\u00e9, a surrogate pair), 1% cut short before
    their closing brace (malformed), 10% NULL."""
    pieces = [table_piece(dev, JSON_OPEN, _picks(dev, gen, n, [1] * 4)),
              table_piece(dev, JSON_PAD, _picks(dev, gen, n,
                                                [1] * len(JSON_PAD))),
              table_piece(dev, JSON_A, _picks(dev, gen, n,
                                              [1] * len(JSON_A))),
              table_piece(dev, JSON_MID, _picks(dev, gen, n, [1] * 4)),
              table_piece(dev, JSON_K, _picks(dev, gen, n, JSON_K_WEIGHTS)),
              table_piece(dev, JSON_TAIL, _picks(dev, gen, n, [1] * 4))]
    whole = torch.rand(n, generator=gen, device=dev) >= 0.01
    mat, lens = concat(pieces, [None] * 5 + [whole])
    valid = torch.rand(n, generator=gen, device=dev) >= 0.1
    return strings_from_matrix(mat, torch.where(valid, lens, 0), valid)


def roster2_json(dev, gen, col: Column, calls, launches, log, profile):
    """Phase (d): get_json_object with nine paths over the documents;
    against the port's Python walker on sampled rows."""
    n = col.size
    lens = str_lengths(col)[col.valid_bool()]
    short, long_ = int(lens.min()), int(lens.max())
    _require(16 <= short and long_ <= 128, f"documents of {short}-{long_} "
             "bytes, not 16-128")

    def calls_on(c):
        return {p: get_json_object(c, p) for p in JSON_PATHS}
    out, r = roster2_phase("get_json_object", lambda: calls_on(col), n,
                           calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == len(JSON_PATHS),
             f"K3 launched {r['launches']} times for {len(JSON_PATHS)} "
             "nullable results")
    host = r["counters"]
    _require(host.get("get_json_object.host_unescape_rows", 0) > 0
             and "get_json_object.python_walker_rows" not in host,
             f"host routes {host}: the escape rows must take the unescape "
             "route and no path the Python walker")
    rows = _sample(dev, gen, n, SAMPLE_ROWS)
    docs = _host_strings(col, rows)
    for p, res in out.items():
        steps = _parse_path(p)
        want = [None if d is None else _eval_py(d, steps) for d in docs]
        _require(_host_strings(res, rows) == want, f"{p} differs from the "
                 "Python walker on the sampled rows")
    m = R2_CPU_ROWS
    bad = _same_outputs(out, calls_on(_rows_cpu(col, 0, m)))
    _require(not bad, f"get_json_object {bad}: the card's first {m} rows "
             "differ from the CPU's")
    hits = {p: res.size - res.null_count() for p, res in out.items()}
    log(f"roster II get_json_object: {n} documents of {short}-{long_} "
        f"bytes; non-null results {json.dumps(hits)}; every path equals "
        f"the Python walker on {SAMPLE_ROWS} sampled rows and the CPU on "
        f"the first {m}")
    return r | {"hits": hits}


def _expected_map(doc):
    """Python's json on one document -> the map row (None if it is not
    one JSON object)."""
    try:
        obj = json.loads(doc)
    except json.JSONDecodeError:
        return None
    return obj if isinstance(obj, dict) else None


def roster2_maps(dev, col: Column, calls, launches, log, profile):
    """Phase (e): from_json_to_map and get_map_value on a 100,000-row
    head of the documents (host code, as in the reference), against
    Python's json on every row."""
    m = MAP_ROWS
    head = rc.slice_rows(col, 0, m)

    def fn():
        mp = mu.from_json_to_map(head)
        return {"map": mp, "k": mu.get_map_value(mp, "k")}
    out, r = roster2_phase("maps", fn, m, calls, launches, log, profile)
    _require(r["launches"]["bitmask_pack"] == 1,
             "K3 did not pack the map's row validity")
    _require(r["counters"].get("map_utils.host_tokenizer_rows") == m,
             "the tokenizer did not count its rows")
    docs = head.to_pylist()
    rows = mu.map_to_pylist(out["map"])
    looked = out["k"].to_pylist()
    for i, (d, got) in enumerate(zip(docs, rows)):
        want = None if d is None else _expected_map(d)
        ok = (got is None) == (want is None) and (
            want is None or (got.keys() == want.keys() and all(
                got[k] == v if v is None or isinstance(v, str)
                else json.loads(got[k]) == v for k, v in want.items())))
        _require(ok, f"map row {i} differs from Python's json: {d!r}")
        _require(looked[i] == (None if got is None else got.get("k")),
                 f"get_map_value differs on row {i}")
    mp = mu.from_json_to_map(_rows_cpu(head, 0, m))
    _require(_same_outputs(out, {"map": mp, "k": mu.get_map_value(mp, "k")})
             == [], "maps: the card's rows differ from the CPU's")
    log(f"roster II maps: {m} rows, {out['map'].null_count()} not one JSON "
        "object; every row equals Python's json and the CPU")
    return r


def run_roster2(dev, gen, ss, text: Column, log, profile: bool = False):
    """Step 9: copying, conditionals, z-order, percentiles, JSON, maps."""
    calls, launches, phases = [], {}, []
    phases.append(roster2_copying(dev, gen, ss, text, calls, launches, log,
                                  profile))
    phases.append(roster2_zorder(dev, gen, calls, launches, log, profile))
    phases.append(roster2_percentiles(dev, gen, ss, calls, launches, log,
                                      profile))
    docs = json_documents(dev, gen, JSON_ROWS)
    phases.append(roster2_json(dev, gen, docs, calls, launches, log,
                               profile))
    phases.append(roster2_maps(dev, docs, calls, launches, log, profile))
    for name in ROSTER2_NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the roster II path")
    return {"phases": phases, "launches": launches}, calls

# --------------------------------------------------------------------------
# The mesh: run_fused over a NCCL process group, and shuffle_table
# --------------------------------------------------------------------------

MESH_NAMES = NAMES  # K1-K7, K3 in both forms
MESH_THRESHOLD = "8192"  # the reference test's: the dimensions shard too
MESH_BUDGET = 64 << 20   # stages the 10M-row exchanges into rounds
# (pass, env, queries): the forced passes run only the queries whose
# routes their knob changes (at the default threshold only the fact
# tables shard, so the sharded-build join routes need MESH_THRESHOLD)
MESH_PASSES = (
    ("default", {}, Q1_10 + Q11_20),
    ("threshold", {"SRT_BROADCAST_THRESHOLD": MESH_THRESHOLD},
     ("q1", "q2", "q3", "q8")),
    ("exchange", {"SRT_BROADCAST_THRESHOLD": MESH_THRESHOLD,
                  "SRT_SHUFFLE_JOIN_ROUTE": "exchange"},
     ("q1", "q3", "q8")),
    # q1's (customer, store) groupby merged whole: its replicated result
    # probes the sharded customer table, which the exchange route cannot
    # take, so customer is all_gathered
    ("all_gather", {"SRT_BROADCAST_THRESHOLD": MESH_THRESHOLD,
                    "SRT_SHUFFLE_JOIN_ROUTE": "exchange",
                    "SRT_GROUPBY_PSUM_WIDTH": str(1 << 24)}, ("q1",)),
    ("reduce_scatter", {"SRT_BROADCAST_THRESHOLD": MESH_THRESHOLD,
                        "SRT_SHUFFLE_JOIN_ROUTE": "reduce_scatter"},
     ("q3", "q7")),
    ("scattered", {"SRT_GROUPBY_PSUM_WIDTH": "1"},
     ("q1", "q5", "q16", "q19")),
    ("staged", {"SRT_SHUFFLE_SCRATCH_BYTES": str(MESH_BUDGET)},
     ("q18", "q19")))
# every route of the reference's corpus, counted at least once a step
MESH_ROUTES = ("rel.route.join.presence_psum", "rel.route.join.shuffle_hash",
               "rel.route.join.reduce_scatter", "rel.route.dist.all_gather",
               "rel.route.groupby.two_phase.replicated",
               "rel.route.groupby.two_phase.scattered",
               "rel.route.window.exchange", "rel.route.shuffle.staged")
MESH_ROWS = 1_000_000  # the TestTables-schema table shuffle_table takes


@contextlib.contextmanager
def env_set(env: dict):
    """Set ``env`` in os.environ for the block, then restore it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_group(dev):
    """A process group of one rank (NCCL on the card, gloo on the CPU)
    and a 1-D ``part`` mesh over it."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "target", "mesh")
    os.makedirs(root, exist_ok=True)
    init = os.path.join(root, f"init-{os.getpid()}")
    if os.path.exists(init):
        os.remove(init)
    distributed.initialize(f"file://{init}", 1, 0,
                           backend="nccl" if dev.type == "cuda" else "gloo",
                           timeout_s=300)
    return make_mesh({"part": 1}, device_type=dev.type), init


def mesh_queries(mesh, rels, query: list) -> dict:
    """Every pass of ``MESH_PASSES`` once: {(pass, q): (frame, counters,
    synchronising CUDA calls)}; ``query[0]`` names the running query."""
    out = {}
    for pname, env, queries in MESH_PASSES:
        with env_set(env):
            for q in queries:
                query[0] = f"{pname} {q}"
                before = kernel_stats()
                res, syncs = _count_syncs(
                    lambda q=q: run_fused(PLANS[q], rels, mesh=mesh))
                out[(pname, q)] = (res.to_df(), stats_since(before), syncs)
    return out


def mesh_shuffles(mesh, tables: dict, query: list) -> dict:
    """``shuffle_table`` of each (table, keys) once: {label: (table,
    round-1 overflow, counters)}."""
    out = {}
    for label, (tab, keys) in tables.items():
        query[0] = f"shuffle_table {label}"
        before = kernel_stats()
        got, over = shuffle_table(mesh, tab, keys)
        out[label] = (got, over, stats_since(before))
    return out


def run_mesh(dev, gen, rels: dict, oracles: dict, hash_tab: Table, log,
             profile: bool = False):
    """Step 10: q1-q20 over a one-rank NCCL mesh, every route and
    collective, and shuffle_table; the kernels launched on the way.
    Returns the step's report, its kernel calls and (mesh, init file):
    the group stays open for the serving step."""
    torch.cuda.reset_peak_memory_stats()
    mesh, init = mesh_group(dev)
    log(f"mesh: {mesh!r} backend={distributed.process_info()['backend']}")
    queries = Q1_10 + Q11_20
    single, single_ms = {}, {}
    for q in queries:  # the single-device results, outside the count
        single[q] = run_fused(PLANS[q], rels, device=dev).to_df()
        single_ms[q] = wall_ms(lambda q=q: run_fused(PLANS[q], rels,
                                                     device=dev))
    test_tables = rows_table(dev, gen, MESH_ROWS, 0.01, 0, 4)
    # keys: an INT32 and an INT64 column of each table (K4, then K5)
    tables = {f"hashing table ({HASH_ROWS} rows)": (hash_tab, [0, 1]),
              f"TestTables ({MESH_ROWS} rows)": (test_tables, [2, 0])}
    torch.cuda.synchronize()

    query = [None]
    K.reset_launch_counts()
    runs = mesh_queries(mesh, rels, query)
    shuffled = mesh_shuffles(mesh, tables, query)
    torch.cuda.synchronize()
    launches = {n: K.LAUNCHES[n] for n in MESH_NAMES}
    log(f"mesh launches: {json.dumps(launches, sort_keys=True)}")

    per_query, total = {}, {}
    peak = torch.cuda.max_memory_allocated()
    for (pname, q), (frame, st, syncs) in runs.items():
        for k, v in st.items():
            total[k] = total.get(k, 0) + v
        counters = {k: v for k, v in st.items()
                    if k.startswith(("rel.route.join.", "rel.route.dist.",
                                     "rel.route.groupby.two_phase",
                                     "rel.route.window.exchange",
                                     "rel.route.shuffle.",
                                     "rel.route.sort.topk", "shuffle."))}
        r = {"pass": pname, "rows": len(frame), "counters": counters,
             "host_syncs": st.get("rel.host_syncs", 0),
             "dist_fallbacks": st.get("rel.dist_fallbacks", 0),
             "cuda_sync_calls": syncs}
        per_query[f"{pname} {q}"] = r
        if pname == "default":
            peak = max(peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            r["warm_ms"] = wall_ms(lambda q=q: run_fused(PLANS[q], rels,
                                                         mesh=mesh))
            r["peak_bytes"] = torch.cuda.max_memory_allocated()
            r["single_ms"] = single_ms[q]
            if profile:
                r |= profile_run(
                    lambda q=q: run_fused(PLANS[q], rels, mesh=mesh),
                    r["warm_ms"], f"mesh {q}", log)
        warm = ("" if "warm_ms" not in r else
                f"warm_ms={r['warm_ms']:.3f} single_device_ms="
                f"{r['single_ms']:.3f} peak_gib="
                f"{r['peak_bytes'] / 2**30:.2f} ")
        log(f"mesh {pname} {q}: {warm}rows={r['rows']} "
            f"host_syncs={r['host_syncs']} "
            f"cuda_sync_calls={syncs} "
            f"counters={json.dumps(counters, sort_keys=True)}")

    shuffles = {}
    for label, (got, over, st) in shuffled.items():
        tab, keys = tables[label]
        ms = wall_ms(lambda tab=tab, keys=keys: shuffle_table(mesh, tab,
                                                              keys))
        shuffles[label] = {"ms": ms, "rows_per_s": tab.num_rows / ms * 1e3,
                           "overflow": over.tolist(),
                           "counters": {k: v for k, v in st.items()
                                        if k.startswith(("shuffle.",
                                                         "row_conversion."))}}
        log(f"mesh shuffle_table {label}: {tab.num_rows} rows in "
            f"{ms:.3f} ms = {tab.num_rows / ms * 1e3:.4g} rows/s, "
            f"overflow={over.tolist()} "
            f"counters={json.dumps(shuffles[label]['counters'])}")
    peak = max(peak, torch.cuda.max_memory_allocated())
    log(f"mesh step peak memory allocated: {peak / 2**30:.2f} GiB")

    # one more pass, recording the inputs of every kernel call
    calls = []
    with recording(calls, query):
        mesh_queries(mesh, rels, query)
        mesh_shuffles(mesh, tables, query)
    torch.cuda.synchronize()

    for (pname, q), (frame, st, _) in runs.items():
        frames_match(frame, oracles[q], f"{q} (mesh, {pname})")
        frames_match(frame, single[q], f"{q} (mesh {pname} vs one device)")
        _require(st.get("rel.dist_fallbacks", 0) == 0
                 and st.get("rel.fused_fallbacks", 0) == 0,
                 f"{q} (mesh, {pname}) fell back: {st}")
        _require(st.get("rel.host_syncs", 0) <= 1,
                 f"{q} (mesh, {pname}) counted "
                 f"{st.get('rel.host_syncs', 0)} host syncs")
    log("mesh: every pass's results equal the oracle and the one-device "
        "run, no fallback, at most one host sync a query")
    for route in MESH_ROUTES:
        _require(any(k == route or k.startswith(route + ".")
                     for k in total),
                 f"route {route} was not taken on the mesh")
    for label, (got, over, _) in shuffled.items():
        _require(not bool(over.any()), f"shuffle_table {label} overflowed")
        _require(_same_columns(got, tables[label][0]),
                 f"shuffle_table {label} differs from its input")
    log("mesh: both shuffled tables equal their inputs row for row, "
        "overflow 0")
    for name in MESH_NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the mesh path")
    return {"per_query": per_query, "shuffles": shuffles,
            "launches": launches, "peak_bytes": peak,
            "routes": {k: v for k, v in total.items()
                       if k.startswith(MESH_ROUTES)}}, calls, (mesh, init)


# --------------------------------------------------------------------------
# The serving step: q1-q20 served by QueryExecutor, with their reports,
# the result cache, injected faults, admission, the scrape endpoint and
# the mesh
# --------------------------------------------------------------------------

SERVE_PASSES = 3
SERVE_WINDOW = 4     # results decoded on this thread while later ones queue
SERVE_TIMEOUT = 600  # every wait of the step, seconds
CACHE_QUERIES = Q1_10
FAULT_SPEC = "dispatch:raise:1,alloc:retry_oom:1"


def serve_pass(ex, rels: dict, queries: tuple) -> dict:
    """One request a query submitted from this thread, the oldest result
    decoded while later requests queue: {q: (frame, handle)}."""
    out, pending = {}, collections.deque()
    for q in queries:
        pending.append((q, ex.submit(PLANS[q], rels,
                                     timeout=SERVE_TIMEOUT)))
        while len(pending) > SERVE_WINDOW:
            qq, p = pending.popleft()
            out[qq] = (p.to_df(timeout=SERVE_TIMEOUT), p)
    while pending:
        qq, p = pending.popleft()
        out[qq] = (p.to_df(timeout=SERVE_TIMEOUT), p)
    return out


def served_reports(served: dict) -> dict:
    """{q: the ExecutionReport its handle's qid emitted}."""
    by_qid = {r.qid: r for r in obs.recent_reports()}
    return {q: by_qid.get(p.qid) for q, (_, p) in served.items()}


def serve_recorded(ex, rels: dict, queries: tuple, calls: list,
                   label: str) -> None:
    """The queries once more through ``ex``, one at a time, recording
    every kernel call's inputs under ``label q``."""
    query = [None]
    with recording(calls, query):
        for q in queries:
            query[0] = f"{label} {q}"
            ex.submit(PLANS[q], rels).result(timeout=SERVE_TIMEOUT)
    torch.cuda.synchronize()


def serving_cache(dev, data: dict, oracles: dict, ex, log, card: str):
    """q1-q10's tables ingested again with the result cache on, q1-q10
    served twice on each tier (whole entries on the card, then host
    pages): the second pass must hit, launch nothing and sync nothing.
    On the paged tier every resident page must be pinned host memory and
    no entry may hold a CUDA tensor; q1-q10 hit once more through
    ``run_fused`` on this thread must launch nothing and make no
    synchronising call before any decode, give new CUDA tensors, and
    still equal the oracle after the cache is dropped and its pinned
    memory written over while the uploads may be in flight; a pass at a
    cap of half the charged bytes must strip pages
    (``page_evictions``), the stripped entries missing and the rest
    hitting equal to the oracle. A one-row change of store_sales must
    miss, and equal content on another device must miss."""
    out = {}
    with env_set({"SRT_RESULT_CACHE_BYTES": str(1 << 30)}):
        result_cache.reset()
        t0 = time.perf_counter()
        cached = {n: rel_from_df(df, device=dev) for n, df in data.items()}
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        for tier, pool in (("whole", "0"), ("paged", str(1 << 30))):
            with env_set({"SRT_PAGE_POOL_BYTES": pool}):
                serve_pass(ex, cached, CACHE_QUERIES)  # fills the cache
                torch.cuda.synchronize()
                launches, st = dict(K.LAUNCHES), kernel_stats()
                t0 = time.perf_counter()
                hit = serve_pass(ex, cached, CACHE_QUERIES)
                hit_s = time.perf_counter() - t0
                d = stats_since(st)
                reps = served_reports(hit)
                cache = result_cache.result_cache()
                _require(isinstance(cache, result_cache.PagedResultCache)
                         == (tier == "paged"), f"{tier}: wrong tier {cache}")
                _require(dict(K.LAUNCHES) == launches,
                         f"result cache ({tier}): a hit launched kernels")
                _require(d.get("rel.host_syncs", 0) == 0
                         and d.get("rel.dispatches", 0) == 0,
                         f"result cache ({tier}): a hit synced: {d}")
                _require(d.get("serving.result_cache.hits") ==
                         len(CACHE_QUERIES), f"result cache ({tier}): {d}")
                for q, (frame, _) in hit.items():
                    r = reps[q]
                    _require(r is not None and r.provenance == "result_cache"
                             and r.host_syncs == 0,
                             f"{q} ({tier} hit): report {r and r.provenance}")
                    frames_match(frame, oracles[q], f"{q} ({tier} hit)")
                hit_ms = {q: reps[q].wall_ns / 1e6 for q in hit}
                out[tier] = {"pass_s": hit_s, "hit_ms": hit_ms,
                             "resident_bytes": cache.resident_bytes,
                             "entries": len(cache)}
                log(f"serving result cache ({tier}): q1-q10 again all hit "
                    f"(provenance result_cache, 0 launches, 0 host syncs), "
                    f"pass {hit_s * 1e3:.3f} ms, run_fused "
                    f"{min(hit_ms.values()):.4f}-{max(hit_ms.values()):.4f}"
                    f" ms a hit, {cache.resident_bytes} bytes in "
                    f"{len(cache)} entries [{card}]")
                if tier == "paged":
                    out[tier] |= paged_residency(dev, cache, cached, oracles,
                                                 log, card)
        for q in CACHE_QUERIES:
            p = out["paged"]["direct"][q]
            log(f"serving result cache hit {q}: whole "
                f"{out['whole']['hit_ms'][q]:.4f} ms, paged "
                f"{out['paged']['hit_ms'][q]:.4f} ms (served reports' "
                f"run_fused wall); paged on this thread {p['host_ms']:.4f} ms"
                f" to return (its token alone {p['token_ms']:.4f} ms, the "
                f"cache's get alone {p['get_ms']:.4f} ms), "
                f"{p['ready_ms']:.4f} ms to the upload's end, "
                f"{p['upload_bytes']} bytes up [{card}]")
        with env_set({"SRT_PAGE_POOL_BYTES": str(1 << 30)}):
            out["eviction"] = paged_eviction(
                dev, ex, cached, oracles, out["paged"]["resident_bytes"],
                log, card)
        out["large_put"] = paged_large_put(cached["store_sales"], log, card)
        ss = data["store_sales"].copy()
        ss.loc[0, "ss_quantity"] = ss.loc[0, "ss_quantity"] + 1
        changed = dict(cached, store_sales=rel_from_df(ss, device=dev))
        st = kernel_stats()
        frame, pq = serve_pass(ex, changed, ("q3",))["q3"]
        d = stats_since(st)
        _require(d.get("serving.result_cache.misses") == 1
                 and not d.get("serving.result_cache.hits")
                 and d.get("rel.host_syncs") == 1,
                 f"a changed ingest did not miss: {d}")
        log("serving result cache: one changed store_sales row misses "
            f"(q3 ran, {len(frame)} rows)")
        # the same content on another device keys apart: a hit would hand
        # back tensors on the card to a CPU run
        small = generate(sf=2, seed=SEED)
        for d_ in (dev, torch.device("cpu")):
            st = kernel_stats()
            got = run_fused(PLANS["q3"], {n: rel_from_df(df, device=d_)
                                          for n, df in small.items()},
                            device=d_)
            d = stats_since(st)
            _require(d.get("serving.result_cache.misses") == 1
                     and not d.get("serving.result_cache.hits")
                     and all(c.device.type == d_.type
                             for c in got.table.columns),
                     f"result cache on {d_}: {d}")
            frames_match(got.to_df(), QUERIES["q3"][1](small),
                         f"q3 (sf=2, {d_})")
        log("serving result cache: q3 on equal sf=2 content filled on the "
            "card misses on the CPU, and lands there")
        result_cache.reset()
    return out


def paged_residency(dev, cache, cached: dict, oracles: dict, log,
                    card: str) -> dict:
    """The paged tier's gates after its hit pass (``serving_cache``): the
    pages pinned on the host, no CUDA tensor held, and q1-q10 hit on this
    thread through ``run_fused`` with no launch and no synchronising call
    before any decode, each hit new CUDA tensors equal to the oracle even
    after the cache is dropped and pinned memory written over while the
    uploads may still be in flight. Returns the residency and each hit's
    host ms, ready ms and upload bytes."""
    pages = cache.resident_pages()
    _require(pages and all(p.device.type == "cpu"
                           and (p.numel() == 0 or p.is_pinned())
                           for p in pages),
             "paged result cache: a resident page is not pinned host memory")
    n_pages = len(pages)
    del pages  # views: they would keep the host buffers alive
    _require(not any(t.is_cuda for t in cache.resident_tensors()),
             "paged result cache: an entry holds a CUDA tensor")
    sizes = [t.nbytes for t in cache.resident_tensors()]
    host_bytes = sum(sizes)
    from spark_rapids_jni_tpu_torch.tpcds.rel import result_cache_token
    direct = {}
    for q in CACHE_QUERIES:  # one at a time: the ms of each hit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = run_fused(PLANS[q], cached, device=dev)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        ready = time.perf_counter()
        # the same hit in its parts: the token, then the cache's get (the
        # stream's wait and the uploads, enqueued)
        tok = result_cache_token(PLANS[q], cached, device=dev)
        t2 = time.perf_counter()
        _require(cache.get(tok) is not None, f"{q}: the token missed")
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        direct[q] = {"host_ms": (t1 - t0) * 1e3,
                     "ready_ms": (ready - t0) * 1e3,
                     "token_ms": (t2 - ready) * 1e3,
                     "get_ms": (t3 - t2) * 1e3,
                     "upload_bytes": sum(
                         c.data.nbytes + (0 if c.validity is None
                                          else c.validity.nbytes)
                         for c in one.table.columns)}
    launches, st = dict(K.LAUNCHES), kernel_stats()
    first = {q: run_fused(PLANS[q], cached, device=dev)
             for q in CACHE_QUERIES}
    hits, syncs = _count_syncs(lambda: {
        q: run_fused(PLANS[q], cached, device=dev) for q in CACHE_QUERIES})
    d = stats_since(st)
    _require(dict(K.LAUNCHES) == launches,
             "paged result cache: a run_fused hit launched kernels")
    _require(syncs == 0, f"paged result cache: {syncs} synchronising calls "
             "in the run_fused hits")
    _require(d.get("serving.result_cache.hits") == 2 * len(CACHE_QUERIES)
             and not d.get("rel.host_syncs"), f"paged hits: {d}")
    for q, rel in hits.items():
        held = {c.data.data_ptr() for c in first[q].table.columns}
        _require(all(c.data.device.type == dev.type
                     and c.data.data_ptr() not in held
                     for c in rel.table.columns),
                 f"{q}: a paged hit's columns are not new CUDA tensors")
    # drop every host page while the uploads may be in flight and write
    # over fresh pinned buffers of the same sizes (the caching host
    # allocator's next blocks): the hits must not see it
    cache.clear()
    junk = [torch.full((max(1, n),), 0xA5, dtype=torch.uint8,
                       pin_memory=True) for n in sizes for _ in range(2)]
    for q, rel in hits.items():
        frames_match(rel.to_df(), oracles[q], f"{q} (paged hit, cache "
                     "dropped during the upload)")
    del junk, first
    log(f"serving result cache (paged): {n_pages} resident pages, all "
        f"pinned host memory ({host_bytes} bytes), no CUDA tensor held; "
        f"q1-q10 hit through run_fused: 0 launches, 0 synchronising calls, "
        f"new CUDA tensors, equal to the oracle with the cache dropped and "
        f"its pinned memory written over during the upload [{card}]")
    return {"pages": n_pages, "host_bytes": host_bytes, "direct": direct}


def paged_large_put(rel, log, card: str) -> dict:
    """One large result through a paged cache of its own: ``rel`` (the
    main path's store_sales, every row and column) put, then read back.
    Times ``put`` on this thread (the pinned buffers' allocation and the
    copies enqueued) and to its event, and the hit to its return and to
    the upload's end; the hit must equal ``rel`` column for column."""
    from spark_rapids_jni_tpu_torch.exec.pages import page_bytes
    cache = result_cache.PagedResultCache(1 << 40, page_bytes())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _require(cache.put("large", rel), "large put: refused")
    t1 = time.perf_counter()
    ent = cache._entries["large"]
    _require(ent.opaque is None
             and (ent.event is not None) == (ent.device.type == "cuda"),
             "large put: not paged")
    if ent.event is not None:
        ent.event.synchronize()
    t2 = time.perf_counter()
    host_bytes = sum(t.nbytes for t in cache.resident_tensors())
    pages = len(ent.page_slots)
    t3 = time.perf_counter()
    got = cache.get("large")
    t4 = time.perf_counter()
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    for a, b in zip(rel.table.columns, got.table.columns, strict=True):
        _require(torch.equal(a.data, b.data)
                 and (a.validity is None) == (b.validity is None)
                 and (a.validity is None or torch.equal(a.validity,
                                                        b.validity)),
                 "large put: a column changed on its round trip")
    cache.clear()
    del got, ent
    out = {"rows": rel.table.num_rows, "columns": len(rel.table.columns),
           "host_bytes": host_bytes, "pages": pages,
           "put_ms": (t1 - t0) * 1e3, "put_ready_ms": (t2 - t0) * 1e3,
           "get_ms": (t4 - t3) * 1e3, "get_ready_ms": (t5 - t3) * 1e3}
    log(f"serving result cache (paged, one large result: store_sales, "
        f"{out['rows']} rows x {out['columns']} columns, {host_bytes} "
        f"bytes in {pages} pages): put {out['put_ms']:.3f} ms to return, "
        f"{out['put_ready_ms']:.3f} ms to its event; hit "
        f"{out['get_ms']:.3f} ms to return, {out['get_ready_ms']:.3f} ms "
        f"to the upload's end; equal column for column [{card}]")
    return out


def paged_eviction(dev, ex, cached: dict, oracles: dict, charged: int,
                   log, card: str) -> dict:
    """q1-q10 served once into a paged cache capped at half of what they
    charge: admission strips LRU pages (``page_evictions``); then every
    token is read once: the stripped entries miss, the rest hit equal to
    the oracle."""
    from spark_rapids_jni_tpu_torch.tpcds.rel import result_cache_token
    cap = max(charged // 2, 1)
    with env_set({"SRT_RESULT_CACHE_BYTES": str(cap)}):
        cache = result_cache.result_cache()
        _require(isinstance(cache, result_cache.PagedResultCache)
                 and len(cache) == 0, "eviction pass: not a fresh paged cache")
        st = kernel_stats()
        serve_pass(ex, cached, CACHE_QUERIES)
        filled = stats_since(st)
        tokens = {q: result_cache_token(PLANS[q], cached, device=dev)
                  for q in CACHE_QUERIES}
        with cache._lock:
            state = {q: ("absent" if t not in cache._entries else
                         "stripped" if cache._entries[t].stripped else "live")
                     for q, t in tokens.items()}
        resident = cache.resident_bytes
        st = kernel_stats()
        for q, tok in tokens.items():
            got = cache.get(tok)
            _require((got is None) == (state[q] != "live"),
                     f"{q}: {state[q]} entry read {got is not None}")
            if got is not None:
                frames_match(got.to_df(), oracles[q], f"{q} (eviction pass)")
        d = stats_since(st)
    pe = filled.get("serving.result_cache.page_evictions", 0)
    live = sum(v == "live" for v in state.values())
    _require(pe > 0 and resident <= cap, f"eviction pass: {filled}, "
             f"{resident} bytes resident of {cap}")
    _require(d.get("serving.result_cache.hits", 0) == live
             and d.get("serving.result_cache.misses", 0)
             == len(tokens) - live, f"eviction pass reads: {d}")
    log(f"serving result cache (paged, cap {cap} bytes of {charged} "
        f"charged): page_evictions={pe} "
        f"evictions={filled.get('serving.result_cache.evictions', 0)}; "
        f"{live} entries live and hit equal to the oracle, "
        f"{sum(v == 'stripped' for v in state.values())} stripped and "
        f"{sum(v == 'absent' for v in state.values())} gone, missing "
        f"[{card}]")
    return {"cap": cap, "charged": charged, "page_evictions": pe,
            "evictions": filled.get("serving.result_cache.evictions", 0),
            "states": state, "resident_bytes": resident}


def serving_faults(ex, rels: dict, oracles: dict, log) -> dict:
    """``FAULT_SPEC`` armed: the two faulted requests reject with their
    exceptions, counted ``serving.failed``; the next serves."""
    faults.configure(FAULT_SPEC)
    try:
        st = kernel_stats()
        pend = [ex.submit(PLANS[q], rels) for q in ("q1", "q2", "q3")]
        errors = []
        for p in pend[:2]:
            try:
                p.result(timeout=SERVE_TIMEOUT)
                errors.append(None)
            except (faults.InjectedFault, faults.RetryOOM) as e:
                errors.append(e)
        frame = pend[2].to_df(timeout=SERVE_TIMEOUT)
        d = stats_since(st)
    finally:
        faults.reset()
    kinds = [type(e).__name__ for e in errors]
    actions = [reliability.retry_action(e) for e in errors if e]
    _require(kinds == ["InjectedFault", "RetryOOM"], f"faults: {kinds}")
    _require(actions == ["retry", "retry_oom"], f"retry_action: {actions}")
    _require(d.get("serving.failed") == 2 and d.get("serving.completed")
             == 1, f"faults: counters {d}")
    frames_match(frame, oracles["q3"], "q3 (after the faults)")
    log(f"serving faults ({FAULT_SPEC}): q1 {kinds[0]} -> {actions[0]}, q2 "
        f"{kinds[1]} -> {actions[1]}, serving.failed=2; q3 next served "
        "equal to the oracle")
    return {"errors": kinds, "actions": actions}


def serving_admission(dev, rels: dict, oracles: dict, log) -> dict:
    """A queue of one behind a worker held inside a gated q9: a third
    ``block=False`` submit sheds with ``queue.Full``, counted."""
    gate, started = threading.Event(), threading.Event()

    def _gated_q9(t):
        started.set()
        gate.wait(SERVE_TIMEOUT)
        return PLANS["q9"](t)

    ax = QueryExecutor(device=dev, max_queue=1, max_in_flight=4,
                       name="admission")
    try:
        first = ax.submit(_gated_q9, rels)
        _require(started.wait(SERVE_TIMEOUT), "the gated query never ran")
        second = ax.submit(PLANS["q9"], rels)  # the queue is now full
        st = kernel_stats()
        try:
            ax.submit(PLANS["q9"], rels, block=False)
            shed = False
        except queue.Full:
            shed = True
        rejected = stats_since(st).get("serving.rejected", 0)
        gate.set()
        for p in (first, second):
            frames_match(p.to_df(timeout=SERVE_TIMEOUT), oracles["q9"],
                         "q9 (admission)")
    finally:
        gate.set()
        ax.close(timeout=SERVE_TIMEOUT)
    _require(shed and rejected == 1,
             f"admission: shed={shed} rejected={rejected}")
    log("serving admission: block=False on a full queue raised "
        "queue.Full, serving.rejected=1")
    return {"shed": shed}


def _http_get(srv, path: str) -> "tuple[int, str]":
    url = f"http://127.0.0.1:{srv.port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def serving_scrape(log) -> dict:
    """``obs/server.py`` on port 0: /metrics parses and carries the
    serving, SLO and device-memory families, /healthz is 200,
    /reports?n=3 the three newest reports."""
    srv = obs_server.start(0)
    try:
        status, text = _http_get(srv, "/metrics")
        samples = obs.parse_prometheus(text)
        h_status, _ = _http_get(srv, "/healthz")
        r_status, body = _http_get(srv, "/reports?n=3")
    finally:
        obs_server.stop()
    newest = [r.qid for r in obs.recent_reports(3)]
    got = [r["qid"] for r in json.loads(body)["reports"]]
    slo = [k for k in samples if k.startswith("srt_serving_slo_")]
    _require(status == 200 and "srt_serving_completed" in samples
             and slo and "srt_mem_device_0_bytes_in_use" in samples,
             f"/metrics: status {status}, {len(samples)} samples")
    _require(h_status == 200, f"/healthz: {h_status}")
    _require(r_status == 200 and got == newest,
             f"/reports?n=3: {got} != {newest}")
    log(f"serving scrape: /metrics {len(samples)} samples (serving.completed"
        f"={samples['srt_serving_completed']:.0f}, {len(slo)} serving.slo "
        f"gauges, mem.device.0.bytes_in_use="
        f"{samples['srt_mem_device_0_bytes_in_use']:.0f}), /healthz 200, "
        f"/reports?n=3 the three newest")
    return {"samples": len(samples), "slo_gauges": len(slo)}


def serving_mesh(dev, mesh, rels: dict, oracles: dict, single: dict, log):
    """q1-q20 once through ``QueryExecutor(mesh=...)`` at the forced
    threshold with the exchange join route (the mesh step's ``exchange``
    pass: shuffle-hash joins, K5 on their keys), launch counts set to 0
    before and read after, then once more recording every kernel
    call."""
    calls = []
    with env_set({"SRT_BROADCAST_THRESHOLD": MESH_THRESHOLD,
                  "SRT_SHUFFLE_JOIN_ROUTE": "exchange"}):
        with QueryExecutor(mesh=mesh, max_queue=8, max_in_flight=16,
                           name="serving-mesh") as mx:
            K.reset_launch_counts()
            served = serve_pass(mx, rels, Q1_10 + Q11_20)
            torch.cuda.synchronize()
            launches = {n: K.LAUNCHES[n] for n in MESH_NAMES}
            reps = served_reports(served)
            serve_recorded(mx, rels, Q1_10 + Q11_20, calls, "mesh")
        budget = dist.agreed_scratch_probe(mesh, None, dev)
    carried = 0
    for q, (frame, _) in served.items():
        r = reps[q]
        frames_match(frame, oracles[q], f"{q} (served over the mesh)")
        frames_match(frame, single[q], f"{q} (served mesh vs one device)")
        _require(r is not None and r.host_syncs <= 1
                 and not r.counters.get("rel.dist_fallbacks"),
                 f"{q} (served mesh): report {r and r.counters}")
        _require(r.shuffle == {k: v for k, v in r.counters.items()
                               if k.startswith("shuffle.")},
                 f"{q} (served mesh): shuffle section {r.shuffle}")
        carried += bool(r.shuffle)
    _require(carried > 0, "no served mesh report carries a shuffle section")
    _require(launches["murmur3_int64"] > 0,
             "K5 was not launched serving over the mesh")
    log(f"serving mesh: q1-q20 served over {mesh!r} equal the oracle and "
        f"the one-device results; {carried} of 20 reports carry a shuffle "
        f"section (q18 {json.dumps(reps['q18'].shuffle, sort_keys=True)}); "
        f"launches {json.dumps(launches, sort_keys=True)}; the scratch "
        f"budget agreed across the ranks: {budget} bytes")
    return {"launches": launches, "scratch_budget": budget,
            "shuffle_sections": carried}, calls


def run_serving(dev, rels: dict, data: dict, oracles: dict, mesh, log,
                card: str):
    """The serving step (module docstring): q1-q20 served by
    ``QueryExecutor`` with ``SRT_METRICS`` on. Returns the step's report
    and the kernel calls of its one-device and mesh paths."""
    t_step = time.perf_counter()
    queries = Q1_10 + Q11_20
    out: dict = {}
    builds = [r for r in obs.recompile_records()
              if r.site == "ops.cuda_kernels.build"]
    log("serving: the kernel library was " + (
        f"built at startup ({builds[0].duration_s:.3f} s, recorded as a "
        f"compile event at site {builds[0].site}); the served reports "
        "show no compile: the library was built before them"
        if builds else "already built before this process: no compile "
        "event"))
    with env_set({"SRT_METRICS": "1"}):
        # the serial baseline: run_fused and the decode on this thread
        serial, serial_ms, peak, serial_pass = {}, {}, {}, []
        for i in range(SERVE_PASSES):
            t_pass = time.perf_counter()
            for q in queries:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                serial[q] = run_fused(PLANS[q], rels, device=dev).to_df()
                torch.cuda.synchronize()
                serial_ms.setdefault(q, []).append(
                    (time.perf_counter() - t0) * 1e3)
                peak[q] = torch.cuda.max_memory_allocated()
            serial_pass.append(time.perf_counter() - t_pass)

        ex = QueryExecutor(device=dev, max_queue=8, max_in_flight=16)
        try:
            passes, reports, served_pass = [], [], []
            for i in range(SERVE_PASSES):
                if i == 0:
                    K.reset_launch_counts()
                t_pass = time.perf_counter()
                passes.append(serve_pass(ex, rels, queries))
                served_pass.append(time.perf_counter() - t_pass)
                if i == 0:
                    torch.cuda.synchronize()
                    launches = {n: K.LAUNCHES[n] for n in Q_NAMES}
                reports.append(served_reports(passes[-1]))
            calls = []
            serve_recorded(ex, rels, queries, calls, "serving")
            for i, (served, reps) in enumerate(zip(passes, reports)):
                for q, (frame, pq) in served.items():
                    frames_match(frame, oracles[q], f"{q} (served {i})")
                    frames_match(frame, serial[q],
                                 f"{q} (served {i} vs run_fused)")
                    r = reps[q]
                    _require(r is not None and r.qid == pq.qid
                             and r.query == q and r.host_syncs <= 1
                             and r.provenance == "eager" and r.fused,
                             f"{q} (served {i}): report "
                             f"{r and r.to_dict()}")
                    _require(r.memory["devices"]["0"]["bytes_limit"] > 0,
                             f"{q}: no device memory in its report")
            for name in Q_NAMES:
                _require(launches.get(name, 0) > 0,
                         f"kernel {name} was not launched on the served path")
            log(f"serving launches: {json.dumps(launches, sort_keys=True)}")
            per_query = {}
            for q in queries:
                execute = [reps[q].wall_ns / 1e6 for reps in reports]
                latency = [s[q][1].latency_ns / 1e6 for s in passes]
                mem = reports[-1][q].memory
                r = per_query[q] = {
                    "serial_ms": statistics.median(serial_ms[q]),
                    "served_execute_ms": statistics.median(execute),
                    "served_latency_ms": statistics.median(latency),
                    "modeled_peak_bytes": mem["modeled_peak_bytes"],
                    "measured_peak_bytes": peak[q],
                    "device0": mem["devices"]["0"]}
                log(f"serving {q}: serial_ms={r['serial_ms']:.3f} "
                    f"served_execute_ms={r['served_execute_ms']:.3f} "
                    f"served_latency_ms={r['served_latency_ms']:.3f} "
                    f"modeled_peak_gib={mem['modeled_peak_bytes'] / 2**30:.2f}"
                    f" measured_peak_gib={peak[q] / 2**30:.2f} "
                    f"in_use_gib={mem['devices']['0']['bytes_in_use'] / 2**30:.2f}"
                    f" process_peak_gib="
                    f"{mem['devices']['0']['peak_bytes_in_use'] / 2**30:.2f}")
            log(f"serving passes (q1-q20, decode included): serial "
                f"{statistics.median(serial_pass):.3f} s, executor "
                f"{statistics.median(served_pass):.3f} s (medians of "
                f"{SERVE_PASSES}) [{card}]")
            log("serving: the q3 report of the last pass:\n"
                + reports[-1]["q3"].render())
            out |= {"per_query": per_query, "launches": launches,
                    "serial_pass_s": serial_pass,
                    "served_pass_s": served_pass}
            out["result_cache"] = serving_cache(dev, data, oracles, ex, log,
                                                card)
            out["faults"] = serving_faults(ex, rels, oracles, log)
        finally:
            ex.close(timeout=SERVE_TIMEOUT)
        out["admission"] = serving_admission(dev, rels, oracles, log)
        out["scrape"] = serving_scrape(log)
        out["mesh"], mesh_calls = serving_mesh(dev, mesh, rels, oracles,
                                               serial, log)
    out["step_s"] = time.perf_counter() - t_step
    out["serial"] = serial  # the fleet-control step's baseline
    return out, calls, mesh_calls


# --------------------------------------------------------------------------
# The trace-range step: SRT_TRACE_ENABLED's srt:: profiler ranges
# --------------------------------------------------------------------------

TRACE_QUERY = "q3"
TRACE_DIR = Path(__file__).resolve().parent / "target" / "trace_ranges"


def _traced_ranges(trace: dict) -> dict:
    """The ``srt::`` ranges of a Chrome trace and the hand kernels inside
    them: a kernel is inside a range when the host call that launched it
    (matched by correlation id) lies in a CPU ``srt::`` range of its
    thread, or its device interval lies in a GPU-side ``srt::``
    annotation."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X"]
    cpu_ranges: dict = {}
    gpu_ranges = []
    for e in events:
        if not str(e.get("name", "")).startswith("srt::"):
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if e.get("cat") == "gpu_user_annotation":
            gpu_ranges.append(span)
        else:
            cpu_ranges.setdefault(e.get("tid"), []).append(span)
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver"):
            launches[corr] = e
    kernels = [e for e in events if e.get("cat") == "kernel"
               and HAND_KERNEL.search(str(e.get("name", "")) + "(")]
    inside = 0
    for k in kernels:
        launch = launches.get((k.get("args") or {}).get("correlation"))
        t = None if launch is None else float(launch["ts"])
        by_host = t is not None and any(
            lo <= t <= hi for lo, hi in cpu_ranges.get(launch.get("tid"), ()))
        lo_k = float(k["ts"])
        hi_k = lo_k + float(k.get("dur", 0))
        by_device = any(lo <= lo_k and hi_k <= hi for lo, hi in gpu_ranges)
        inside += by_host or by_device
    names = sorted({str(e["name"]) for e in events
                    if str(e.get("name", "")).startswith("srt::")})
    return {"ranges": sum(map(len, cpu_ranges.values())) + len(gpu_ranges),
            "names": names, "hand_kernels": len(kernels),
            "hand_kernels_inside": inside}


def run_trace_ranges(dev, rels: dict, oracles: dict, log, card: str) -> dict:
    """``TRACE_QUERY`` at sf=1000 once under ``SRT_TRACE_ENABLED=1`` and
    once with it off, each inside ``torch.profiler`` (the result cache
    skipped, so the kernels run): the first trace must hold ``srt::``
    ranges with hand kernels inside them, the second none; both results
    equal the oracle."""
    from torch.profiler import ProfilerActivity, profile
    t_step = time.perf_counter()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    TRACE_DIR.mkdir(parents=True)
    out = {}
    for on in ("1", "0"):
        with env_set({"SRT_TRACE_ENABLED": on}):
            run_fused(PLANS[TRACE_QUERY], rels, device=dev,
                      skip_result_cache=True).to_df()  # warm
            launched = dict(K.LAUNCHES)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                got = run_fused(PLANS[TRACE_QUERY], rels, device=dev,
                                skip_result_cache=True)
                torch.cuda.synchronize()
            path = TRACE_DIR / f"{TRACE_QUERY}_trace_{on}.json"
            prof.export_chrome_trace(str(path))
        frames_match(got.to_df(), oracles[TRACE_QUERY],
                     f"{TRACE_QUERY} (SRT_TRACE_ENABLED={on})")
        r = _traced_ranges(json.loads(path.read_text()))
        r["launched"] = sum(K.LAUNCHES.values()) - sum(launched.values())
        out["on" if on == "1" else "off"] = r
    on, off = out["on"], out["off"]
    _require(on["ranges"] > 0 and on["hand_kernels_inside"] > 0,
             f"SRT_TRACE_ENABLED=1: no srt:: range holding a hand kernel "
             f"({on})")
    _require(off["ranges"] == 0 and not off["names"],
             f"SRT_TRACE_ENABLED=0: srt:: ranges in the trace ({off})")
    out["step_s"] = time.perf_counter() - t_step
    log(f"trace ranges: {TRACE_QUERY} at sf={SF} under SRT_TRACE_ENABLED=1: "
        f"{on['ranges']} srt:: ranges ({', '.join(on['names'][:8])}), "
        f"{on['hand_kernels_inside']} of {on['hand_kernels']} hand-kernel "
        f"launches in the trace inside one ({on['launched']} launched); "
        f"with it off: {off['ranges']} srt:: ranges, {off['hand_kernels']} "
        f"hand-kernel launches; {out['step_s']:.3f} s [{card}]")
    return out


# --------------------------------------------------------------------------
# The batched serving step: run_fused_batched windows replayed from CUDA
# graphs, the recording pass, the ragged route and the fleet scheduler
# --------------------------------------------------------------------------

BATCH_K = 3                   # a window [rels, rels_b, rels]: capacity 4
BATCH_WARM = 3                # warm windows a query (their median)
BATCH_ROTATE = 3_333_333      # rels_b's ss_net_profit rotation, rows
RAGGED_POOL = 4 << 30         # funds q3's three 850 MB store_sales slots
SMALL_POOL = 1 << 16          # one page, too small for any window
MIX_BATCH_MAX = 4             # the fleet mix's windows: three, capacity 4
BURST = 32                    # q9 and q17 submissions each a burst
BURST_QUERIES = ("q9", "q17")
BURST_WINDOW_MS = 20          # the scheduler's fixed coalescing window
FAULT_BURST = 16              # q9 submissions a fault pass


def batch_rels(dev, rels: dict, data: dict) -> dict:
    """``rels`` with store_sales ingested again from its frame, its
    ss_net_profit rotated by ``BATCH_ROTATE`` rows: the same fingerprint
    (schema, stats, sizes), other answers wherever a query reads it."""
    ss = data["store_sales"].copy()
    ss["ss_net_profit"] = np.roll(ss["ss_net_profit"].to_numpy(),
                                  BATCH_ROTATE)
    return dict(rels, store_sales=rel_from_df(ss, device=dev))


def batch_window(q: str, window: list, dev, graph=None) -> list:
    return run_fused_batched(PLANS[q], window, device=dev, _graph=graph)


def batched_queries(dev, rels: dict, rels_b: dict, oracles: dict, log,
                    card: str) -> "tuple[dict, dict, dict]":
    """Pass (a): each of q1-q20 in a window of ``BATCH_K``: the cold
    window captures, ``BATCH_WARM`` warm windows replay; each slot equal
    to its serial run and slot 0 to the oracle; one batch program, one
    counted host sync and no other synchronising CUDA call a warm window.
    Returns the per-query report, the main path's launch counts, the
    last warm window's frames and the serial frames."""
    window = [rels, rels_b, rels]
    serial, serial_ms = {}, {}
    for q in Q1_10 + Q11_20:  # the serial baseline, before the counts
        serial[q] = [run_fused(PLANS[q], r, device=dev).to_df()
                     for r in (rels, rels_b)]
        serial_ms[q] = [wall_ms(lambda r=r: run_fused(PLANS[q], r,
                                                      device=dev))
                        for r in (rels, rels_b)]
    per_query, frames = {}, {}
    K.reset_launch_counts()
    for q in Q1_10 + Q11_20:
        want = (serial[q][0], serial[q][1], serial[q][0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel_stats()
        t0 = time.perf_counter()
        try:
            outs = batch_window(q, window, dev)
        except BatchIncompatible as e:
            _require(q in Q11_20, f"{q} did not batch: {e}")
            d = stats_since(before)
            _require(d.get("rel.batch.fallbacks") == 1,
                     f"{q}: BatchIncompatible not route-counted: {d}")
            per_query[q] = {"batched": False, "reason": str(e)[:300]}
            log(f"batched {q}: BatchIncompatible, route-counted "
                f"rel.batch.fallbacks: {str(e)[:300]}")
            clear_batch_cache()
            continue
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        cold = obs.last_report(q)
        (stats,) = batch_cache_stats()
        for i, o in enumerate(outs):
            frames_match(o.to_df(), want[i], f"{q} (batched slot {i})")
        frames_match(outs[0].to_df(), oracles[q], f"{q} (batched slot 0)")
        warm, syncs_seen = [], []
        for _ in range(BATCH_WARM):
            before = kernel_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs, syncs = _count_syncs(lambda: batch_window(q, window, dev))
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
            d = stats_since(before)
            disp, host = dispatch_counts(d)
            rep = obs.last_report(q)
            _require(d.get("rel.dispatches.rel.fused_batch_program") == 1
                     and host == 1 and syncs == 1
                     and d.get("rel.route.serving.batched") == BATCH_K
                     and rep.provenance == "warm_memory"
                     and rep.batch == BATCH_K,
                     f"{q} warm window: dispatches {disp}, host syncs "
                     f"{host}, synchronising calls {syncs}, counters {d}, "
                     f"provenance {rep.provenance}")
            syncs_seen.append(syncs)
            for i, o in enumerate(outs):
                frames_match(o.to_df(), want[i], f"{q} (replayed slot {i})")
        frames[q] = [o.to_df() for o in outs]
        peak = torch.cuda.max_memory_allocated()
        launches = stats["replay_launches"]
        captures = [r for r in cold.recompiles
                    if r["site"] == f"rel.fused_batch.{q}"]
        _require(cold.provenance == "cold_compile" and len(captures) == 1
                 and stats["graph"],
                 f"{q}: cold window provenance {cold.provenance}, "
                 f"captures {captures}")
        _require(q not in Q1_10 or stats["graph"],
                 f"{q} did not replay a graph")
        r = per_query[q] = {
            "batched": True, "warm_ms": statistics.median(warm),
            "serial_sum_ms": 2 * serial_ms[q][0] + serial_ms[q][1],
            "serial_ms": serial_ms[q], "cold_ms": cold_ms,
            "capture_ms": captures[0]["duration_s"] * 1e3,
            "replay_launches": launches,
            "static_bytes": stats["static_bytes"], "peak_bytes": peak,
            "cuda_sync_calls": syncs_seen}
        log(f"batched {q}: warm_ms={r['warm_ms']:.3f} (k={BATCH_K}, "
            f"capacity 4) serial_sum_ms={r['serial_sum_ms']:.3f} "
            f"(slots {serial_ms[q][0]:.3f} + {serial_ms[q][1]:.3f} + "
            f"{serial_ms[q][0]:.3f}) cold_ms={cold_ms:.1f} "
            f"capture_ms={r['capture_ms']:.1f} replay_launches="
            f"{json.dumps(launches, sort_keys=True)} static_gib="
            f"{r['static_bytes'] / 2**30:.3f} peak_gib={peak / 2**30:.2f} "
            f"sync_calls={syncs_seen} [{card}]")
        clear_batch_cache()  # frees the graph, its pool and its buffers
    torch.cuda.synchronize()
    main_launches = {n: K.LAUNCHES[n] for n in Q_NAMES}
    in_graphs = collections.Counter()
    for r in per_query.values():
        in_graphs.update(r.get("replay_launches", {}))
    for name in Q_NAMES:
        _require(main_launches[name] > 0 and in_graphs[name] > 0,
                 f"kernel {name} was not launched in a captured batch "
                 f"program (main path {main_launches}, in the graphs "
                 f"{dict(in_graphs)})")
    log(f"batched launches (q1-q20 windows, cold and warm): "
        f"{json.dumps(main_launches, sort_keys=True)}; in one replay of "
        f"each query's graph: {json.dumps(dict(in_graphs), sort_keys=True)}")
    return per_query, main_launches, frames, serial


def batched_recorded(dev, rels: dict, rels_b: dict, replayed: dict, log
                     ) -> "tuple[list, dict]":
    """Pass (b): q1-q10's windows once more with the batch program run
    eagerly (no capture: a recorded clone inside a capture would hold
    nothing), every kernel call recorded; each slot equal to the
    replayed one. Returns the calls and this pass's launch counts."""
    calls, query = [], [None]
    K.reset_launch_counts()
    with recording(calls, query):
        for q in Q1_10:
            query[0] = f"batched {q}"
            outs = batch_window(q, [rels, rels_b, rels], dev, graph=False)
            for i, (o, want) in enumerate(zip(outs, replayed[q])):
                frames_match(o.to_df(), want, f"{q} (eager slot {i} vs "
                                              "replayed)")
            clear_batch_cache()
    torch.cuda.synchronize()
    launches = {n: K.LAUNCHES[n] for n in Q_NAMES}
    log(f"batched recording pass: q1-q10 windows run eagerly equal the "
        f"replayed ones; launches {json.dumps(launches, sort_keys=True)}")
    return calls, launches


def batched_ragged(dev, rels: dict, rels_b: dict, oracles: dict, log
                   ) -> dict:
    """Pass (c): q3's window on the ragged route with a pool that funds
    it, then with one that cannot (the padded twin, counted)."""
    out = {}
    window = [rels, rels_b, rels]
    for label, pool, tag in (("ragged", RAGGED_POOL, "ragged"),
                             ("degraded", SMALL_POOL, "padded")):
        with env_set({"SRT_BATCH_ROUTE": "ragged",
                      "SRT_PAGE_POOL_BYTES": str(pool)}):
            pages.reset()
            before = kernel_stats()
            outs = batch_window("q3", window, dev)
            d = stats_since(before)
            rep = obs.last_report("q3")
            (stats,) = batch_cache_stats()
            clear_batch_cache()
        pages.reset()
        frames_match(outs[0].to_df(), oracles["q3"], f"q3 ({label})")
        degraded = d.get("rel.batch.pool_degraded", 0)
        _require(d.get(f"rel.route.batch.{tag}") == BATCH_K
                 and degraded == (label == "degraded"),
                 f"q3 {label}: counters {d}")
        out[label] = {"capacity": stats["capacity"],
                      "batch_multiplier": rep.memory["batch_multiplier"],
                      "padded_waste_bytes":
                          rep.memory.get("padded_waste_bytes", 0),
                      "pool_bytes": pool}
        log(f"batched q3 {label} (SRT_PAGE_POOL_BYTES={pool}): "
            f"rel.route.batch.{tag}={BATCH_K} pool_degraded={degraded} "
            f"effective capacity {stats['capacity']}, padded_waste_bytes "
            f"{out[label]['padded_waste_bytes']}")
    return out


def batched_fleet_mix(dev, rels: dict, rels_b: dict, serial: dict, log,
                      card: str) -> dict:
    """Pass (e): a ``FleetScheduler`` serves q1-q20, three submissions
    each (``rels``, ``rels_b``, ``rels``), in two rounds, and the batch
    cache is never cleared: its entries are bounded by the card's
    headroom alone. Every result equal to its serial one, none failed;
    memory in use, the allocator's reserve, the cache's charge and its
    evictions printed after each round."""
    out = {}
    qs = Q1_10 + Q11_20
    with env_set({"SRT_BATCH_MAX": str(MIX_BATCH_MAX)}):
        with FleetScheduler(n_workers=2, device=dev,
                            batch_window_ms=BURST_WINDOW_MS,
                            name="fleet-mix") as s:
            for rnd in ("cold", "warm"):
                before = kernel_stats()
                t0 = time.perf_counter()
                pend = [(q, i, s.submit(PLANS[q], r))
                        for q in qs
                        for i, r in enumerate((rels, rels_b, rels))]
                res = [(q, i, p.to_df(timeout=SERVE_TIMEOUT))
                       for q, i, p in pend]
                secs = time.perf_counter() - t0
                torch.cuda.synchronize()
                d = stats_since(before)
                for q, i, frame in res:
                    frames_match(frame, serial[q][i % 2],
                                 f"{q} (fleet mix {rnd}, slot {i})")
                _require(not d.get("serving.failed")
                         and d.get("serving.batch.formed", 0) >= 1,
                         f"fleet mix {rnd}: counters {d}")
                stats = batch_cache_stats()
                r = out[rnd] = {
                    "seconds": secs,
                    "allocated_bytes": torch.cuda.memory_allocated(dev),
                    "reserved_bytes": torch.cuda.memory_reserved(dev),
                    "cache_entries": len(stats),
                    "cache_graphs": sum(st["graph"] for st in stats),
                    "cache_bytes": sum(st["bytes"] for st in stats),
                    "counters": {k: v for k, v in d.items() if k in (
                        "serving.batch.formed", "serving.batch.queries",
                        "serving.batch.fallback", "serving.fault.oom.split",
                        "rel.batch.budget_evictions", "rel.batch.oom",
                        "rel.plan_cache_evictions.fused_batch",
                        "rel.batch.fallbacks")}}
                log(f"fleet mix {rnd} (q1-q20 x 3, 2 workers, "
                    f"SRT_BATCH_MAX={MIX_BATCH_MAX}, cache never "
                    f"cleared): {secs:.2f} s; allocated "
                    f"{r['allocated_bytes'] / 2**30:.2f} GiB, reserved "
                    f"{r['reserved_bytes'] / 2**30:.2f} GiB; cache "
                    f"{r['cache_entries']} entries ({r['cache_graphs']} "
                    f"graphs) charging {r['cache_bytes'] / 2**30:.2f} GiB; "
                    f"{json.dumps(r['counters'], sort_keys=True)} [{card}]")
    clear_batch_cache()
    return out


def burst(sched, rels: dict, tenants=("gold", "bronze"),
          queries=BURST_QUERIES, n=BURST) -> "tuple[list, float]":
    """``n`` submissions of each query, alternating tenants, submitted
    back to back; [(q, frame, latency ms)] and the burst's seconds."""
    t0 = time.perf_counter()
    pend = [(q, sched.submit(PLANS[q], rels, tenant=tenants[i % 2]))
            for i in range(n) for q in queries]
    out = [(q, p.to_df(timeout=SERVE_TIMEOUT), p.latency_ns / 1e6)
           for q, p in pend]
    return out, time.perf_counter() - t0


def burst_check(results: list, serial: dict, what: str) -> None:
    for q, frame, _ in results:
        frames_match(frame, serial[q], f"{q} ({what})")


def batched_scheduler(dev, rels: dict, oracles: dict, log, card: str
                      ) -> dict:
    """Pass (d): a ``FleetScheduler`` of two tenants and two workers takes
    bursts of q9 and q17, batched (``SRT_BATCH_MAX=16``) and not, then
    fault passes; every result equal to the serial one."""
    serial = {q: run_fused(PLANS[q], rels, device=dev).to_df()
              for q in BURST_QUERIES}
    tenants = [TenantConfig("gold", priority=1, weight=3),
               TenantConfig("bronze", priority=0, weight=1)]
    out = {}
    for label, bmax in (("batched", "16"), ("unbatched", "1")):
        with env_set({"SRT_BATCH_MAX": bmax}):
            with FleetScheduler(tenants=tenants, n_workers=2, device=dev,
                                batch_window_ms=BURST_WINDOW_MS,
                                name=f"burst-{label}") as s:
                for _ in range(2):  # capture the windows' graphs
                    warm, _ = burst(s, rels)
                    burst_check(warm, serial, f"{label} warm-up burst")
                obs.reset_reports()
                before = kernel_stats()
                res, secs = burst(s, rels)
                d = stats_since(before)
                batches = [r for r in obs.recent_reports() if r.batch]
                sizes = collections.Counter(r.batch for r in batches)
                colds = sum(r.provenance == "cold_compile" for r in batches)
        burst_check(res, serial, f"{label} burst")
        lat = {q: sorted(ms for qq, _, ms in res if qq == q)
               for q in BURST_QUERIES}
        r = out[label] = {
            "queries_per_s": len(res) / secs, "seconds": secs,
            "p50_ms": {q: float(np.percentile(v, 50)) for q, v in lat.items()},
            "p99_ms": {q: float(np.percentile(v, 99)) for q, v in lat.items()},
            "windows": dict(sizes), "captures": colds,
            "counters": {k: v for k, v in d.items()
                         if k.startswith("serving.")}}
        for t in ("gold", "bronze"):
            _require(d.get(f"serving.tenant.{t}.completed") == BURST,
                     f"{label} burst: tenant {t} counters {d}")
        if label == "batched":
            _require(d.get("serving.batch.formed", 0) >= 1
                     and sizes.get(16, 0) >= 1,
                     f"batched burst: windows {dict(sizes)}, counters {d}")
        log(f"scheduler burst {label} (2 tenants, 2 workers, "
            f"{len(res)} queries, SRT_BATCH_MAX={bmax}): "
            f"{r['queries_per_s']:.1f} queries/s, "
            + ", ".join(f"{q} p50 {r['p50_ms'][q]:.2f} p99 "
                        f"{r['p99_ms'][q]:.2f} ms" for q in BURST_QUERIES)
            + f", batch windows {json.dumps(dict(sizes), sort_keys=True)} "
            f"({colds} of them captured), batch.formed="
            f"{d.get('serving.batch.formed', 0)} [{card}]")
    out["faults"] = batched_faults(dev, rels, serial, tenants, log)
    return out


def batched_faults(dev, rels: dict, serial: dict, tenants, log) -> dict:
    """The scheduler under injected faults, one at a time, each a burst
    of ``FAULT_BURST`` q9 submissions; then a 1 ms deadline behind q19."""
    out = {}
    for spec, counter in (("batch:raise:1", "serving.batch.fallback"),
                          ("batch:split_oom:1", "serving.fault.oom.split"),
                          ("worker:crash:1",
                           "serving.fault.worker_restarts")):
        with env_set({"SRT_BATCH_MAX": "16"}):
            faults.configure(spec)
            try:
                before = kernel_stats()
                with FleetScheduler(tenants=tenants, n_workers=2,
                                    device=dev, retry_backoff_ms=0,
                                    batch_window_ms=BURST_WINDOW_MS,
                                    name="burst-faults") as s:
                    res, _ = burst(s, rels, queries=("q9",),
                                   n=FAULT_BURST)
                d = stats_since(before)
                left = faults.remaining()
            finally:
                faults.reset()
        burst_check(res, serial, spec)
        _require(d.get(counter, 0) >= 1 and not d.get("serving.failed")
                 and left == {}, f"{spec}: counters {d}, unfired {left}")
        if spec.startswith("worker"):
            _require(d.get("serving.fault.worker_restarts") == 1
                     and d.get("serving.fault.requeued", 0) >= 1,
                     f"{spec}: counters {d}")
        out[spec] = {k: v for k, v in d.items()
                     if k.startswith(("serving.fault.", "serving.batch."))}
        log(f"scheduler under {spec}: {len(res)} q9 served equal to the "
            f"serial result; {json.dumps(out[spec], sort_keys=True)}")
    with FleetScheduler(n_workers=1, device=dev, name="deadline") as s:
        long = s.submit(PLANS["q19"], rels)
        late = s.submit(PLANS["q9"], rels, deadline_ms=1)
        frames_match(long.to_df(timeout=SERVE_TIMEOUT),
                     run_fused(PLANS["q19"], rels, device=dev).to_df(),
                     "q19 (deadline pass)")
        try:
            late.result(timeout=SERVE_TIMEOUT)
            expired = False
        except QueryExpired:
            expired = True
    _require(expired, "the 1 ms deadline behind q19 did not expire")
    log("scheduler deadline: q9 queued behind q19 with a 1 ms deadline "
        "raised QueryExpired at dequeue")
    out["deadline"] = {"expired": expired}
    return out


def run_batching(dev, rels: dict, data: dict, oracles: dict, log,
                 card: str) -> "tuple[dict, list, dict]":
    """The batched serving step (module docstring, 10c), with
    ``SRT_METRICS`` on and the result cache off. Returns the step's
    report, the recording pass's calls and its launch counts."""
    t_step = time.perf_counter()
    out: dict = {}
    with env_set({"SRT_METRICS": "1", "SRT_RESULT_CACHE_BYTES": "0",
                  "SRT_BATCH_ROUTE": "padded"}):
        result_cache.reset()
        rels_b = batch_rels(dev, rels, data)
        (out["per_query"], out["launches"], replayed,
         serial) = batched_queries(dev, rels, rels_b, oracles, log, card)
        calls, launches = batched_recorded(dev, rels, rels_b, replayed, log)
        out["recorded_launches"] = launches
        del replayed
        out["ragged"] = batched_ragged(dev, rels, rels_b, oracles, log)
        out["scheduler"] = batched_scheduler(dev, rels, oracles, log, card)
        out["fleet_mix"] = batched_fleet_mix(dev, rels, rels_b, serial, log,
                                             card)
        del rels_b, serial
    out["step_s"] = time.perf_counter() - t_step
    return out, calls, launches


# --------------------------------------------------------------------------
# The morsel step: q1-q20 with the fact tables streamed from host memory
# and from Parquet through pinned, double-buffered staging
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# The fleet-control step: q1-q20 through FleetScheduler over a replica
# slice with the control plane on, its rollup and history
# --------------------------------------------------------------------------

FLEET_NAMES = Q_NAMES + ("murmur3_int64",)  # K5 on the exchange route
FLEET_TENANTS = (TenantConfig("gold", weight=3, priority=10),
                 TenantConfig("bronze", weight=1, priority=0))
FLEET_DEADLINE_MS = 600_000  # the served pass: every deadline met
FLEET_BURST = 8              # gold submissions a predicted shed answers
FLEET_BURST_MS = 1           # their deadline: below any execute window
FLEET_SNAPSHOTS = 4          # rollup scrapes, one history snapshot each
ROLLUP_CHILD_SAMPLES = (2_000_000, 40_000_000)  # the child's e2e, ns


def fleet_pass(sched, rels: dict, queries: tuple) -> dict:
    """Each query once, the tenants alternating, every submission with a
    deadline; results decoded after all are queued: {q: (frame, pq)}."""
    pending = [(q, sched.submit(PLANS[q], rels,
                                tenant=FLEET_TENANTS[i % 2].name,
                                deadline_ms=FLEET_DEADLINE_MS))
               for i, q in enumerate(queries)]
    return {q: (p.to_df(timeout=SERVE_TIMEOUT), p) for q, p in pending}


def child_json(args: list, env: dict, timeout: float) -> dict:
    """Run ``chip_smoke.py`` in a child process with ``args`` and ``env``
    over this one's; its last stdout line is a JSON object."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), *args],
        env={**os.environ, **env}, capture_output=True, text=True,
        timeout=timeout)
    _require(proc.returncode == 0,
             f"child {args}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def rollup_child() -> int:
    """The rollup's second member: a scrape endpoint over this process's
    own SLO sketches (tenant ``child``), its port printed, open until
    stdin closes."""
    obs.count("serving.submitted", len(ROLLUP_CHILD_SAMPLES))
    for d in ROLLUP_CHILD_SAMPLES:
        obs_slo.record(obs_slo.KIND_E2E, "child", 0, d)
    srv = obs_server.start(0)
    print(json.dumps({"port": srv.port}), flush=True)
    sys.stdin.read()
    obs_server.stop()
    return 0


def fleet_rollup(log) -> dict:
    """A ``FleetRollup`` over this process's scrape endpoint and a child
    process's: ``FLEET_SNAPSHOTS`` scrapes merging /metrics and
    /slo.json, each offering a history snapshot, then the regression
    watch over the ring read back."""
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rollup-child"],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "SRT_METRICS": "1"},
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        port = json.loads(child.stdout.readline())["port"]
        mine = obs_server.start(0)
        members = [f"127.0.0.1:{mine.port}", f"127.0.0.1:{port}"]
        r = obs_rollup.FleetRollup(members)
        try:
            snaps = [r.collect() for _ in range(FLEET_SNAPSHOTS)]
            h_status, h_body = _http_get(r, "/fleet/healthz")
            m_status, text = _http_get(r, "/fleet/metrics")
        finally:
            r.stop()
            obs_server.stop()
    finally:
        child.stdin.close()
        child.wait(timeout=60)
    last = snaps[-1]
    hists = last["slo"]["hists"]
    _require(last["up"] == 2 and h_status == 200 and m_status == 200,
             f"rollup: up {last['up']}, /fleet/healthz {h_status}, "
             f"/fleet/metrics {m_status}")
    _require("child|0|e2e" in hists and any(
        k.startswith(("gold|", "bronze|")) for k in hists),
             f"rollup: merged sketches {sorted(hists)}")
    child_n = hists["child|0|e2e"][obs_slo.N_BUCKETS]
    _require(child_n == len(ROLLUP_CHILD_SAMPLES),
             f"rollup: child e2e count {child_n}")
    samples = obs.parse_prometheus(text)
    merged_gold = {k: obs_slo.sketch_quantiles(h) for k, h in hists.items()}
    ring = obs_history.load_snapshots()
    fleet_snaps = [x for x in ring if x.get("source") == "fleet"]
    _require(len(fleet_snaps) >= FLEET_SNAPSHOTS,
             f"history: {len(fleet_snaps)} fleet snapshots")
    findings = obs_history.regression_watch(snapshots=ring)
    log(f"fleet rollup: members {members} up {last['up']}; /fleet/healthz "
        f"200; merged /slo.json keys {sorted(hists)}; fleet quantiles "
        + json.dumps({k: {f: q[f] for f in ("count", "p50_ns", "p99_ns")}
                      for k, q in sorted(merged_gold.items())})
        + f"; /fleet/metrics {len(samples)} samples; history ring "
        f"{len(ring)} snapshots ({len(fleet_snaps)} from the fleet) under "
        f"{obs_history.history_dir()}; "
        + obs_history.render_watch(findings).replace("\n", "; "))
    return {"members": members, "up": last["up"],
            "slo_keys": sorted(hists), "history_snapshots": len(ring),
            "regressions": findings}


def run_fleet_control(dev, rels: dict, oracles: dict, serial: dict, log,
                      card: str):
    """The fleet-control step (module docstring). Returns the step's
    report and the kernel calls of its recording pass."""
    t_step = time.perf_counter()
    queries = Q1_10 + Q11_20
    hist_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "target", f"fleet-history-{os.getpid()}")
    env = {"SRT_METRICS": "1", "SRT_CONTROL_PLANE": "1",
           "SRT_CONTROL_MIN_SAMPLES": "4",
           "SRT_BROADCAST_THRESHOLD": MESH_THRESHOLD,
           "SRT_SHUFFLE_JOIN_ROUTE": "exchange", "SRT_OBS_HISTORY": "1",
           "SRT_OBS_HISTORY_DIR": hist_dir,
           "SRT_OBS_HISTORY_MIN_INTERVAL_S": "0"}
    out: dict = {}
    calls: list = []
    with env_set(env):
        mesh2d = make_mesh_2d(n_part=1, n_replica=1, device_type=dev.type)
        sched = FleetScheduler(tenants=FLEET_TENANTS, mesh=mesh2d,
                               name="fleet-control")
        try:
            _require(sched._control is not None and sched._fleet is not None,
                     "no control plane or replica slice")
            before = kernel_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            served = fleet_pass(sched, rels, queries)
            pass_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {n: K.LAUNCHES[n] for n in FLEET_NAMES}
            query = [None]
            with recording(calls, query):
                for q in queries:
                    query[0] = f"fleet {q}"
                    sched.submit(PLANS[q], rels, tenant="gold",
                                 deadline_ms=FLEET_DEADLINE_MS).result(
                                     timeout=SERVE_TIMEOUT)
            torch.cuda.synchronize()
            for q, (frame, pq) in served.items():
                frames_match(frame, oracles[q], f"{q} (fleet control)")
                frames_match(frame, serial[q], f"{q} (fleet vs serial)")
                _require(type(pq.result()).__name__ == "Rel",
                         f"{q}: served by another slice on one rank")
            for name in FLEET_NAMES:
                _require(launches.get(name, 0) > 0,
                         f"kernel {name} was not launched on the fleet path")
            gold = obs_slo.TRACKER.latency_stats(obs_slo.KIND_EXECUTE,
                                                 "gold", 10)
            # (c) a burst the gold window says cannot meet its deadline
            shed_before = kernel_stats().get("serving.shed.predicted", 0)
            sheds = 0
            for _ in range(FLEET_BURST):
                try:
                    sched.submit(PLANS["q9"], rels, tenant="gold",
                                 deadline_ms=FLEET_BURST_MS)
                except QueryShed as e:
                    _require("serving.shed.predicted" in e.reason, e.reason)
                    sheds += 1
            predicted = (kernel_stats().get("serving.shed.predicted", 0)
                         - shed_before)
            _require(sheds == FLEET_BURST and predicted == sheds,
                     f"burst: {sheds} sheds, {predicted} predicted")
            # (d) the control seam: a garbage read latches the loop, and
            # the same doomed submission is admitted and served
            faults.configure("control:raise:1")
            try:
                pq = sched.submit(PLANS["q9"], rels, tenant="gold",
                                  deadline_ms=FLEET_BURST_MS)
                latched = sched._control.latched(control_plane.LOOP_SHED)
                frames_match(pq.to_df(timeout=SERVE_TIMEOUT),
                             oracles["q9"], "q9 (served while latched)")
            finally:
                faults.reset()
            delta = stats_since(before)
            _require(latched and delta.get(
                "serving.control.telemetry_errors") == 1 and delta.get(
                "serving.control.fallback.shed") == 1,
                f"control seam: latched {latched}, "
                f"{ {k: v for k, v in delta.items() if 'control' in k} }")
            tenants = {t.name: {k.rsplit('.', 1)[1]: v for k, v in
                                delta.items()
                                if k.startswith(f"serving.tenant.{t.name}.")}
                       for t in FLEET_TENANTS}
        finally:
            sched.close()
        out["rollup"] = fleet_rollup(log)
    control = {k: v for k, v in delta.items()
               if k.startswith(("serving.control.", "serving.shed"))}
    log(f"fleet control: q1-q20 served by FleetScheduler over {mesh2d!r} "
        f"(one replica slice, one NCCL rank) with the control plane on, "
        f"equal to the oracle and the serial run; pass {pass_s:.3f} s; "
        f"launches {json.dumps(launches, sort_keys=True)}; gold's execute "
        f"window {json.dumps(gold)}; a burst of {FLEET_BURST} gold q9 with "
        f"{FLEET_BURST_MS} ms deadlines: {sheds} predicted sheds; the "
        f"control seam latched the shed loop and the next doomed q9 was "
        f"served; tenants {json.dumps(tenants, sort_keys=True)}; control "
        f"counters {json.dumps(control, sort_keys=True)} [{card}]")
    out |= {"launches": launches, "pass_s": pass_s, "sheds": sheds,
            "latched": latched, "tenants": tenants, "control": control,
            "gold_execute": gold,
            "step_s": time.perf_counter() - t_step}
    return out, calls


# --------------------------------------------------------------------------
# The warm-disk restart and the tune step (after the morsel step: the
# children need little of the card)
# --------------------------------------------------------------------------

WARM_SF = 10                  # the children's data: 100,000 store_sales rows
WARM_QUERIES = ("q3", "q9")   # both capture on the card
WARM_K = 3                    # a window of three, capacity 4
TUNE_KNOBS = ("SRT_JOIN_METHOD", "SRT_DENSE_GROUPBY")
TUNE_NAMES = Q_NAMES


def warm_child(mode: str) -> int:
    """One process of the warm-disk restart: ingest at ``WARM_SF``, then
    (``warm``) ``warm_disk``, then each query's first batched window,
    timed; prints one JSON line."""
    dev = torch.device("cuda")
    if mode == "warm":  # a build would fail: the library must be bound
        def _no_nvcc():
            raise RuntimeError("the warm process has no nvcc")
        K._nvcc = _no_nvcc
    t0 = time.perf_counter()
    K.kernels()
    lib_s = time.perf_counter() - t0
    data = generate(sf=WARM_SF, seed=SEED)
    rels = {n: rel_from_df(df, device=dev) for n, df in data.items()}
    serial = {q: run_fused(PLANS[q], rels, device=dev).to_df()
              for q in WARM_QUERIES}
    res = {"mode": mode, "library_s": lib_s, "first": {}}
    with env_set({"SRT_METRICS": "1"}):
        t0 = time.perf_counter()
        res["warmed"] = (aot_cache.warm_disk(rels, device=dev)
                         if mode == "warm" else [])
        torch.cuda.synchronize()
        res["warm_disk_s"] = time.perf_counter() - t0
        for q in WARM_QUERIES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = run_fused_batched(PLANS[q], [rels] * WARM_K, device=dev)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            for i, o in enumerate(outs):
                frames_match(o.to_df(), serial[q], f"{q} slot {i} ({mode})")
            res["first"][q] = {"ms": ms,
                               "provenance": obs.last_report(q).provenance}
    res["aot"] = {k: v for k, v in kernel_stats().items()
                  if k.startswith("aot.")}
    res["builds"] = [r.site for r in obs.recompile_records()
                     if r.site == "ops.cuda_kernels.build"]
    print(json.dumps(res), flush=True)
    return 0


def run_warm_disk(log, card: str) -> dict:
    """The warm-disk restart (module docstring)."""
    t_step = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "target", f"aot-{os.getpid()}")
    torch.cuda.empty_cache()
    cold = child_json(["--warm-child", "cold"],
                      {"SRT_AOT_CACHE_DIR": os.path.join(root, "cache")}, 600)
    warm = child_json(["--warm-child", "warm"],
                      {"SRT_AOT_CACHE_DIR": os.path.join(root, "cache")}, 600)
    for q in WARM_QUERIES:
        _require(cold["first"][q]["provenance"] == "cold_compile",
                 f"{q}: the cold process's first window {cold['first'][q]}")
        _require(warm["first"][q]["provenance"] == "warm_disk",
                 f"{q}: the warm process's first window {warm['first'][q]}")
    _require(sorted(warm["warmed"]) == sorted(WARM_QUERIES),
             f"warm_disk warmed {warm['warmed']}")
    _require(not warm["builds"] and warm["aot"].get("aot.disk_hits", 0)
             >= 1 + len(WARM_QUERIES) and not warm["aot"].get("aot.fallback"),
             f"warm process: builds {warm['builds']}, aot {warm['aot']}")
    _require(cold["aot"].get("aot.saves", 0) >= 2,
             f"cold process: aot {cold['aot']}")
    for q in WARM_QUERIES:
        log(f"warm-disk restart {q}: first window of {WARM_K} at "
            f"sf={WARM_SF}: cold process {cold['first'][q]['ms']:.3f} ms "
            f"({cold['first'][q]['provenance']}), warm process "
            f"{warm['first'][q]['ms']:.3f} ms "
            f"({warm['first'][q]['provenance']}) [{card}]")
    log(f"warm-disk restart: the warm process loaded the kernel library "
        f"from the disk tier in {warm['library_s']:.3f} s with no nvcc "
        f"(the cold one built it in {cold['library_s']:.3f}"
        f" s) and captured the manifest's {len(warm['warmed'])} entries "
        f"in {warm['warm_disk_s']:.3f} s before its first window; aot "
        f"counters cold {json.dumps(cold['aot'], sort_keys=True)}, warm "
        f"{json.dumps(warm['aot'], sort_keys=True)} [{card}]")
    return {"cold": cold, "warm": warm,
            "step_s": time.perf_counter() - t_step}


def tune_child() -> int:
    """A fresh process reads the tuned table: printed with the counters
    that show it measured nothing."""
    table = tune_store.active_table()
    from spark_rapids_jni_tpu_torch.config import dense_groupby_mode, \
        join_method
    res = {"table": table, "join_method": join_method(),
           "dense_groupby": dense_groupby_mode(),
           "revision": repr(tune_store.revision_key()),
           "stats": {k: v for k, v in kernel_stats().items()
                     if k.startswith("tune.")}}
    print(json.dumps(res), flush=True)
    return 0


def run_tune(dev, rels: dict, oracles: dict, log, card: str):
    """The tune step (module docstring) on the main path's tables.
    Returns its report, the kernel calls of its recorded q3 and that
    path's launches."""
    t_step = time.perf_counter()
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "target", f"aot-tune-{os.getpid()}")
    env = {"SRT_AOT_CACHE_DIR": cache, "SRT_TUNE_WARMUP": "1",
           "SRT_TUNE_SAMPLES": "5"}
    calls: list = []
    with env_set(env):
        tune_store.reset_active_table_for_testing()
        before = kernel_stats()
        report = tune(knobs=TUNE_KNOBS, save=True, device=dev, rels=rels,
                      log=lambda line: log(f"tune: {line} [{card}]"))
        delta = stats_since(before)
        winners = {k: r["winner"] for k, r in report.items()}
        _require(all(winners.values()), f"tune: winners {winners}")
        _require(tune_store.load_table() == winners,
                 f"tune: stored {tune_store.load_table()} != {winners}")
        # the tuned path: q3 once under the winners, counted, then recorded
        K.reset_launch_counts()
        got = run_fused(PLANS["q3"], rels, device=dev).to_df()
        torch.cuda.synchronize()
        launches = {n: K.LAUNCHES[n] for n in TUNE_NAMES}
        with recording(calls, ["tune q3"]):
            again = run_fused(PLANS["q3"], rels, device=dev).to_df()
        torch.cuda.synchronize()
        frames_match(again, got, "q3 (tuned, recorded)")
        frames_match(got, oracles["q3"], "q3 (tuned) vs oracle")
        fresh = child_json(["--tune-child"], {}, 300)
        tune_store.reset_active_table_for_testing()
    _require(fresh["table"] == winners and fresh["stats"].get(
        "tune.store.loads") == 1 and not fresh["stats"].get(
        "tune.measurements"), f"tune: the fresh process read {fresh}")
    log(f"tune: winners {json.dumps(winners, sort_keys=True)} at sf="
        f"{SF} (candidate times above; oracle rejects "
        f"{delta.get('tune.oracle_rejects', 0)}, defaults kept within the "
        f"spread {delta.get('tune.kept_incumbent', 0)}, measurements "
        f"{delta.get('tune.measurements', 0)}); stored under {cache}, "
        f"revision {fresh['revision']}; a fresh process reloaded them with "
        f"one disk read and no measurement; q3 under the winners launches "
        f"{json.dumps(launches, sort_keys=True)} [{card}]")
    return ({"report": report, "winners": winners, "fresh": fresh,
             "launches": launches, "counters": {
                 k: v for k, v in delta.items() if k.startswith("tune.")},
             "step_s": time.perf_counter() - t_step}, calls, launches)


MORSEL_NAMES = Q_NAMES  # K1 and K2 on each morsel, K3 in the merge run
MORSEL_FACTS = ("store_sales", "web_sales", "catalog_sales", "store_returns")
MORSELS = 8
MORSEL_POOL = 1 << 30      # the paged pass's pool: the window fits it
MORSEL_BUDGET = 1 << 28    # the budget-sized and delta passes' window
DELTA_ROWS = 9_000_000     # store_sales' first ingest batch in the delta pass
GROUP_ROWS = 1 << 20       # Parquet row-group rows
DISK_QUERIES = ("q1", "q3", "q9")
MESH_MORSEL_QUERIES = ("q3", "q9", "q10")
MESH_MORSELS = 4
LINK_BYTES = 1 << 30       # the plain pinned-to-device copy
ZONE_SHARE = 5             # the zone-map filter keeps 1 / ZONE_SHARE of dates
# (pass, env, morsels, queries): the q1-q10 passes over the host tables
MORSEL_PASSES = (
    ("paged", {"SRT_PAGE_POOL_BYTES": str(MORSEL_POOL)}, MORSELS, Q1_10),
    ("whole-buffer", {"SRT_PAGE_POOL_BYTES": "0"}, MORSELS, Q1_10),
    ("budget", {"SRT_MORSEL_BYTES": str(MORSEL_BUDGET)}, None, Q1_10))


def host_link_rate(dev) -> dict:
    """One plain copy of LINK_BYTES from pinned host memory to the card,
    timed with CUDA events (median of 3 after a warm-up): the host link's
    rate as this machine gives it."""
    src = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(LINK_BYTES, dtype=torch.uint8, device=dev)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    del src, dst
    return {"bytes": LINK_BYTES, "ms": ms, "gb_per_s": LINK_BYTES / ms / 1e6}


def streamed(q: str, tables: dict, morsels, dev, mesh=None):
    """One streamed run from scratch (no standing state kept from an
    earlier run): (frame, counters, info, synchronising CUDA calls)."""
    reset_standing_state()
    info = {}
    before = kernel_stats()
    out, syncs = _count_syncs(lambda: run_morsels(
        PLANS[q], tables, info, mesh=mesh, morsels=morsels,
        device=None if mesh is not None else dev))
    return out.to_df(), stats_since(before), info, syncs


def _overlap_ns() -> int:
    return REGISTRY.histogram("exec.morsel.overlap_ns").snapshot()["sum"]


def morsel_query(q: str, tables: dict, morsels, dev, base: int,
                 incore: dict, card: str, log, profile: bool,
                 label: str) -> dict:
    """A warm streamed query: its median of 3 beside the in-core one, the
    layout, the bytes staged and their rate, the overlap, and the peak
    memory allocated above the step's ``base`` beside the modeled
    window and accumulator."""
    def run(info=None):
        reset_standing_state()  # stream every morsel, not a delta
        return run_morsels(PLANS[q], tables, info, morsels=morsels,
                           device=dev)

    # the first warm run (staging kept from the cold run) gives the
    # synchronising calls, the layout, the overlap and the peak; the
    # next three the time
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ov0 = _overlap_ns()
    info = {}
    t0 = time.perf_counter()
    with env_set({"SRT_METRICS": "1"}):  # the overlap histogram records
        _, syncs = _count_syncs(lambda: run(info))
        torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    overlap_ns = _overlap_ns() - ov0
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    m = info["morsel"]
    r = {"warm_ms": ms, "incore_warm_ms": incore[q],
         "n_morsels": m["n_morsels"], "capacity_rows": m["capacity_rows"],
         "paged": m["paged"], "window_bytes": m["window_bytes"],
         "acc_bytes": m["acc_bytes"], "h2d_bytes": m["h2d_bytes"],
         "h2d_gb_per_s": m["h2d_bytes"] / one_ms / 1e6,
         "overlap_ns": overlap_ns, "peak_above_base": peak,
         "peak_model_bytes": m["peak_model_bytes"],
         "warm_cuda_sync_calls": syncs}
    if profile:
        r |= profile_run(run, ms, f"morsel {label} {q}", log)
    log(f"morsel {label} {q}: warm_ms={ms:.3f} incore_warm_ms="
        f"{incore[q]:.3f} morsels={m['n_morsels']} paged={m['paged']} "
        f"capacities={json.dumps(m['capacity_rows'], sort_keys=True)} "
        f"window_bytes={m['window_bytes']} acc_bytes={m['acc_bytes']} "
        f"h2d_bytes={m['h2d_bytes']} h2d_gb_per_s={r['h2d_gb_per_s']:.2f} "
        f"overlap_ms={overlap_ns / 1e6:.3f} peak_above_base_mib="
        f"{peak / 2**20:.1f} peak_model_mib="
        f"{m['peak_model_bytes'] / 2**20:.1f} warm_cuda_sync_calls={syncs}"
        f" [{card}]")
    return r


def _require_streamed(q: str, frame, st: dict, info: dict, oracle,
                      single, what: str, fallback_ok: bool = False) -> None:
    frames_match(frame, oracle, f"{q} ({what})")
    if single is not None:
        frames_match(frame, single, f"{q} ({what} vs in-core)")
    _require(st.get("rel.host_syncs", 0) <= 1,
             f"{q} ({what}) counted {st.get('rel.host_syncs', 0)} host "
             "syncs")
    if not fallback_ok:
        _require(st.get("rel.morsel_fallbacks", 0) == 0,
                 f"{q} ({what}) fell back in-core: {info.get('fallback')}")
        _require(st.get("exec.morsel.folded", 0)
                 >= info["morsel"]["n_morsels"] >= 1,
                 f"{q} ({what}) folded {st.get('exec.morsel.folded', 0)}")


def write_parquet(df, path: str) -> None:
    """``df`` in GROUP_ROWS-row groups, uncompressed (the step times the
    reader, not a codec)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path,
                   row_group_size=GROUP_ROWS, compression="none")


def run_morsel(dev, data: dict, rels: dict, oracles: dict, log, card: str,
               profile: bool = False):
    """Step 11: q1-q20 with the four fact tables streamed (module
    docstring). Returns the step's report and the kernel calls of its
    counted pass (q1-q10 paged at MORSELS morsels)."""
    t0 = time.perf_counter()
    host = dict(rels)
    for f in MORSEL_FACTS:
        host[f] = HostTable.from_df(data[f])
    fact_bytes = sum(host[f].nbytes for f in MORSEL_FACTS)
    log(f"morsel: host tables built in {time.perf_counter() - t0:.3f} s, "
        f"{fact_bytes} bytes of facts "
        f"({json.dumps({f: host[f].num_rows for f in MORSEL_FACTS})} rows)")
    link = host_link_rate(dev)
    log(f"morsel: host link, one pinned-to-device copy of {LINK_BYTES} "
        f"bytes: {link['ms']:.3f} ms = {link['gb_per_s']:.2f} GB/s [{card}]")
    incore, single = {}, {}
    for q in Q1_10:
        single[q] = run_fused(PLANS[q], rels, device=dev).to_df()
        incore[q] = wall_ms(lambda q=q: run_fused(PLANS[q], rels, device=dev))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = {"link": link, "fact_bytes": fact_bytes, "passes": {},
           "incore_warm_ms": incore}

    # each pass once from a cold start, then the counted pass: q1-q10
    # paged again (the entries warm, as the recording pass finds them),
    # every launch count set to 0 just before and read just after
    passes = {}
    for pname, env, morsels, queries in MORSEL_PASSES:
        with env_set(env):
            passes[pname] = {q: streamed(q, host, morsels, dev)
                             for q in queries}
    pname, env, morsels, queries = MORSEL_PASSES[0]
    K.reset_launch_counts()
    with env_set(env):
        counted = {q: streamed(q, host, morsels, dev) for q in queries}
    torch.cuda.synchronize()
    launches = {n: K.LAUNCHES[n] for n in MORSEL_NAMES}
    log(f"morsel launches (q1-q10 paged, {MORSELS} morsels): "
        f"{json.dumps(launches, sort_keys=True)}")
    for q, (frame, st, info, _) in counted.items():
        _require_streamed(q, frame, st, info, oracles[q], single[q],
                          "paged, counted")
    for (pname, env, morsels, queries) in MORSEL_PASSES:
        per_query = {}
        with env_set(env):
            for q in queries:
                frame, st, info, syncs = passes[pname][q]
                _require_streamed(q, frame, st, info, oracles[q], single[q],
                                  pname)
                _require(pname == "budget"
                         or info["morsel"]["paged"] == (pname == "paged"),
                         f"{q} ({pname}) took the wrong staging route")
                r = morsel_query(q, host, morsels, dev, base, incore, card,
                                 log, profile, pname)
                r |= {"cuda_sync_calls": syncs,
                      "host_syncs": st.get("rel.host_syncs", 0)}
                per_query[q] = r
        routes = {q: passes[pname][q][2]["morsel"]["paged"] for q in queries}
        log(f"morsel pass {pname}: route "
            f"{'paged' if all(routes.values()) else 'whole-buffer'}; "
            f"pool_degraded={sum(passes[pname][q][1].get('exec.morsel.pool_degraded', 0) for q in queries)}")
        out["passes"][pname] = per_query
    in_core_syncs = {}
    for q in Q1_10:
        _, in_core_syncs[q] = _count_syncs(
            lambda q=q: run_fused(PLANS[q], rels, device=dev))
    for pname, per_query in out["passes"].items():
        for q, r in per_query.items():
            _require(r["warm_cuda_sync_calls"] <= in_core_syncs[q],
                     f"{q} ({pname}) streamed made {r['warm_cuda_sync_calls']}"
                     f" synchronising CUDA calls, in-core {in_core_syncs[q]}")
    log(f"morsel: q1-q10 on three passes equal the oracle, no fallback, at "
        f"most one host sync a query, no synchronising call past the "
        f"in-core run's ({json.dumps(in_core_syncs)})")

    # the default probe's verdict
    before = kernel_stats()
    info = {}
    frame = run_morsels(PLANS["q1"], host, info, device=dev).to_df()
    st = stats_since(before)
    frames_match(frame, oracles["q1"], "q1 (default budget)")
    incore_verdict = st.get("rel.route.morsel.incore", 0) == 1
    budget = morsel_bytes_budget(dev)
    log(f"morsel: default probe budget={budget} bytes (headroom "
        f"{hbm_headroom_bytes(dev)} bytes now: mem_get_info's free bytes "
        "and the caching allocator's reserve; the budget is 1/8 of it at "
        "the first probe, pow2-floored), "
        f"verdict for {fact_bytes} bytes of facts: "
        f"{'in-core' if incore_verdict else 'streamed'} [{card}]")
    out["default_probe"] = {"budget_bytes": budget,
                            "incore": incore_verdict}

    out["delta"] = run_morsel_delta(dev, data, rels, oracles, log)
    out["disk"] = run_morsel_disk(dev, data, rels, oracles, log, card)
    out["mesh"] = run_morsel_mesh(dev, host, oracles, log)

    # q11-q20 with the facts streamed
    fell = {}
    for q in Q11_20:
        frame, st, info, syncs = streamed(q, host, MORSELS, dev)
        _require_streamed(q, frame, st, info, oracles[q], None, "streamed",
                          fallback_ok=True)
        if st.get("rel.morsel_fallbacks", 0):
            fell[q] = info.get("fallback")
    log("morsel: q11-q20 streamed equal the oracle; in-core fallbacks: "
        + json.dumps(fell, sort_keys=True))
    out["q11_q20_fallbacks"] = fell

    # one more counted pass, recording every kernel call's inputs
    calls, query = [], [None]
    pname, env, morsels, queries = MORSEL_PASSES[0]
    with env_set(env), recording(calls, query):
        for q in queries:
            query[0] = q
            reset_standing_state()
            run_morsels(PLANS[q], host, morsels=morsels, device=dev)
    torch.cuda.synchronize()
    for name in MORSEL_NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the morsel path")
    out["launches"] = launches
    del host
    reset_staging()
    return out, calls


def run_morsel_delta(dev, data: dict, rels: dict, oracles: dict,
                     log) -> dict:
    """store_sales' first DELTA_ROWS rows as a host table (the other
    facts resident), q3 budget-sized, then ``rel_append`` of the rest and
    q3 again: one morsel folds, provenance delta."""
    ss = data["store_sales"]
    ht = HostTable.from_df(ss.iloc[:DELTA_ROWS].reset_index(drop=True))
    tables = dict(rels, store_sales=ht)
    reset_standing_state()
    with env_set({"SRT_MORSEL_BYTES": str(MORSEL_BUDGET)}):
        first = {}
        run_morsels(PLANS["q3"], tables, first, device=dev)
        _require(first.get("provenance") != "delta", "delta: a stale state")
        _require(first["morsel"]["n_morsels"] == -(-DELTA_ROWS // (
            first["morsel"]["capacity_rows"]["store_sales"])),
            f"delta: first run layout {first['morsel']}")
        t0 = time.perf_counter()
        rel_append(ht, ss.iloc[DELTA_ROWS:].reset_index(drop=True))
        append_s = time.perf_counter() - t0
        info = {}
        before = kernel_stats()
        out, syncs = _count_syncs(lambda: run_morsels(
            PLANS["q3"], tables, info, device=dev))
        frame, st = out.to_df(), stats_since(before)
    m = info["morsel"]
    _require(info.get("provenance") == "delta"
             and st.get("rel.morsel_delta_reuse", 0) == 1
             and m["n_morsels"] == 1
             and m["folded_rows"]["store_sales"] == DELTA_ROWS,
             f"delta: provenance {info.get('provenance')}, counters {st}, "
             f"morsel {m}")
    _require_streamed("q3", frame, st, info, oracles["q3"], None, "delta")
    log(f"morsel delta: first run {first['morsel']['n_morsels']} morsels of "
        f"{first['morsel']['capacity_rows']['store_sales']} rows; after "
        f"rel_append ({append_s:.3f} s) provenance={info['provenance']} "
        f"folded 1 morsel over folded_rows={m['folded_rows']} "
        f"cuda_sync_calls={syncs}; equal to the sf={SF} oracle")
    reset_standing_state()
    return {"first": first["morsel"], "delta": m, "append_s": append_s}


def run_morsel_disk(dev, data: dict, rels: dict, oracles: dict, log,
                    card: str) -> dict:
    """The four facts written to Parquet (GROUP_ROWS-row groups) under
    ``target/``; q1, q3 and q9 streamed from them; then store_sales
    sorted by ss_sold_date_sk with a zone-mapped ``between`` filter."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "target", "morsel_parquet")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    paths = {}
    for f in MORSEL_FACTS:
        paths[f] = os.path.join(root, f"{f}.parquet")
        write_parquet(data[f], paths[f])
    ss = data["store_sales"].sort_values("ss_sold_date_sk", kind="stable")
    sorted_path = os.path.join(root, "store_sales_by_date.parquet")
    write_parquet(ss, sorted_path)
    write_s = time.perf_counter() - t0
    out = {"write_s": write_s, "queries": {}}
    tables = dict(rels)
    for f in MORSEL_FACTS:
        tables[f] = ParquetHostTable(paths[f])
    try:
        for q in DISK_QUERIES:
            read0 = REGISTRY.histogram("io.disk.read_ns").snapshot()["sum"]
            dec0 = REGISTRY.histogram("io.disk.decode_ns").snapshot()["sum"]
            t0 = time.perf_counter()
            with env_set({"SRT_METRICS": "1"}):  # the io histograms record
                frame, st, info, syncs = streamed(q, tables, MORSELS, dev)
            ms = (time.perf_counter() - t0) * 1e3
            _require_streamed(q, frame, st, info, oracles[q], None, "disk")
            io = info["io"]
            r = {"ms": ms, "io": io, "cuda_sync_calls": syncs,
                 "read_ms": (REGISTRY.histogram("io.disk.read_ns")
                             .snapshot()["sum"] - read0) / 1e6,
                 "decode_ms": (REGISTRY.histogram("io.disk.decode_ns")
                               .snapshot()["sum"] - dec0) / 1e6}
            out["queries"][q] = r
            log(f"morsel disk {q}: {ms:.3f} ms cold, groups_read="
                f"{io['groups_read']} bytes_read={io['bytes_read']} "
                f"prefetch_hits={io['prefetch_hits']} misses="
                f"{io['prefetch_misses']} read_ms={r['read_ms']:.3f} "
                f"decode_ms={r['decode_ms']:.3f}; equal to the oracle "
                f"[{card}]")
    finally:
        for f in MORSEL_FACTS:
            tables[f].close()
    dates = np.sort(ss["ss_sold_date_sk"].unique())
    lo = int(dates[len(dates) * 2 // ZONE_SHARE])
    hi = int(dates[len(dates) * 3 // ZONE_SHARE - 1])
    view = ParquetHostTable(sorted_path, filters=[
        ("ss_sold_date_sk", "between", (lo, hi))])
    try:
        frame, st, info, syncs = streamed(
            "q3", dict(rels, store_sales=view), MORSELS, dev)
    finally:
        view.close()
    keep = ss[(ss["ss_sold_date_sk"] >= lo) & (ss["ss_sold_date_sk"] <= hi)]
    oracle = QUERIES["q3"][1](dict(data, store_sales=keep))
    _require_streamed("q3", frame, st, info, oracle, None, "zone maps")
    skipped = st.get("exec.morsel.zonemap_skipped", 0)
    _require(skipped > 0, f"zone maps skipped no chunk: {st}")
    log(f"morsel disk zone maps: q3 over store_sales sorted by date with "
        f"ss_sold_date_sk between {lo} and {hi} ({len(keep)} of {len(ss)} "
        f"rows): zonemap_skipped={skipped} groups_read="
        f"{info['io']['groups_read']}; equal to the oracle on the filtered "
        f"frame (write_s={write_s:.3f})")
    out["zonemap"] = {"skipped": skipped, "rows": len(keep),
                      "groups_read": info["io"]["groups_read"]}
    for p in list(paths.values()) + [sorted_path]:
        os.remove(p)
    return out


def run_morsel_mesh(dev, host: dict, oracles: dict, log) -> dict:
    """q3, q9 and q10 at MESH_MORSELS morsels over a one-rank NCCL mesh,
    against the oracle and the single-device streamed run."""
    mesh, init = mesh_group(dev)
    out = {}
    try:
        for q in MESH_MORSEL_QUERIES:
            reset_standing_state()
            single = run_morsels(PLANS[q], host, morsels=MESH_MORSELS,
                                 device=dev).to_df()
            frame, st, info, syncs = streamed(q, host, MESH_MORSELS, dev,
                                              mesh)
            _require_streamed(q, frame, st, info, oracles[q], single,
                              "mesh morsel")
            out[q] = {"n_morsels": info["morsel"]["n_morsels"],
                      "cuda_sync_calls": syncs,
                      "routes": {k: v for k, v in st.items()
                                 if k.startswith("rel.route.")}}
            log(f"morsel mesh {q}: morsels={info['morsel']['n_morsels']} "
                f"cuda_sync_calls={syncs} routes="
                f"{json.dumps(out[q]['routes'], sort_keys=True)}; equal to "
                f"the oracle and the one-device streamed run")
    finally:
        distributed.shutdown()
        os.remove(init)
    return out


# --------------------------------------------------------------------------
# The native bridge: native.py's library, its CUDA engine and the seven
# device routes, against the host route of the same C ABI in a CPU child
# --------------------------------------------------------------------------

NATIVE_ROWS = 10_000_000        # the hash, sort, join-left, groupby tables
NATIVE_RIGHT = 1_000_000        # the join's unique right keys
NATIVE_ROW_TABLES = (1_000_000, 12_000_000)  # TestTables x 4, no validity
NATIVE_GROUPS = ((62, 102), (1_000_000,))    # 6,324 groups (two keys), 1M
NATIVE_SEED = 14
NATIVE_DIR = Path(__file__).resolve().parent / "target" / "native_smoke"
# the mock-JNIEnv driver of the PjrtEngine natives (also the CPU tests')
JNI_DRIVER = Path(__file__).resolve().parent / "tests" / \
    "torch_jni_engine_driver.cpp"
NATIVE_NAMES = HASH_NAMES + ("pack_rows",)
# the engine's K4/K5/K6 launches in one pass of every route both ways:
# murmur3 of the hash table's two 4-byte and four 8-byte columns twice,
# the chained murmur3 of a hash (K4), to_rows of 1M rows (one batch) and
# 12M rows (two batches as host tables, one launch resident)
NATIVE_LAUNCHES = {"murmur3_int32": 5, "murmur3_int64": 8, "pack_rows": 5}


def _specials(x: np.ndarray, bits, every: int) -> np.ndarray:
    ints = x.view(np.int64 if x.dtype == np.float64 else np.int32)
    at = np.arange(0, x.size, every)
    ints[at] = np.resize(np.array(bits, ints.dtype), at.size)
    return x


def native_tables(seed: int = NATIVE_SEED) -> dict:
    """The native step's seeded host tables, (DType, numpy values) a
    column, none with validity (the device routes' contract)."""
    rng = np.random.default_rng(seed)
    n = NATIVE_ROWS

    def full(dtype, m):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, m, dtype=dtype,
                            endpoint=True)

    def f64(m):
        return _specials(rng.standard_normal(m) * 1e6, F64_SPECIALS, 97)

    def f32(m):
        return _specials((rng.standard_normal(m) * 1e3).astype(np.float32),
                         F32_SPECIALS, 89)

    def row_data(dt, m):
        if dt.id == T.TypeId.FLOAT64:
            return f64(m)
        if dt.id == T.TypeId.FLOAT32:
            return f32(m)
        if dt.id == T.TypeId.BOOL8:
            return rng.integers(0, 2, m, dtype=np.int8)
        return full(dt.storage_dtype, m)

    tabs = {"hash": [(T.INT32, full(np.int32, n)), (T.INT64, full(np.int64, n)),
                     (T.TIMESTAMP_MICROSECONDS,
                      rng.integers(-2**60, 2**60, n)),
                     (T.decimal64(-2), rng.integers(-10**15, 10**15, n)),
                     (T.FLOAT32, f32(n)), (T.FLOAT64, f64(n))]}
    for m in NATIVE_ROW_TABLES:
        tabs[f"rows {m}"] = [(dt, row_data(dt, m)) for dt in ROW_TYPES * 4]
    tabs["sort"] = [(T.INT32, rng.integers(0, 1000, n, dtype=np.int32)),
                    (T.INT64, full(np.int64, n))]
    right = (rng.permutation(8 * NATIVE_RIGHT)[:NATIVE_RIGHT].astype(np.int64)
             * 7919 - 2**40)
    tabs["join right"] = [(T.INT64, right)]
    tabs["join left"] = [(T.INT64, np.where(
        rng.random(n) < 0.8, right[rng.integers(0, NATIVE_RIGHT, n)],
        rng.integers(-2**62, 2**62, n)))]
    for dims in NATIVE_GROUPS:
        g = math.prod(dims)
        idx = rng.integers(0, g, n)
        idx[:g] = rng.permutation(g)  # every group present
        if len(dims) == 2:
            keys = [(T.INT32, (idx // dims[1]).astype(np.int32)),
                    (T.INT64, idx % dims[1] * 1_000_003 - 500)]
        else:
            keys = [(T.INT64, idx * 2_654_435_761 - 2**50)]
        tabs[f"groupby {g} keys"] = keys
        tabs[f"groupby {g} values"] = [
            (T.INT64, rng.integers(-2**62, 2**62, n)),
            (T.FLOAT64, rng.standard_normal(n)),
            (T.INT32, full(np.int32, n)),
            (T.FLOAT32, rng.standard_normal(n).astype(np.float32))]
    return tabs


def _native_table(nat, cols):
    return nat.NativeTable([(dt, v, None) for dt, v in cols])


class _Digest:
    """Streaming sha256 of a route's output, one a part (column)."""

    def __init__(self):
        self.h = collections.defaultdict(hashlib.sha256)

    def add(self, key: str, arr: np.ndarray) -> None:
        self.h[key].update(np.ascontiguousarray(arr).view(np.uint8).data)

    def hex(self) -> dict:
        return {k: v.hexdigest() for k, v in sorted(self.h.items())}


def _decoded(d: _Digest, cols) -> None:
    """A from_rows result ((values, valid bool) a column) into ``d``."""
    for c, (vals, ok) in enumerate(cols):
        d.add(f"{c} data", vals)
        d.add(f"{c} valid", np.packbits(ok, bitorder="little"))


def native_child(out_dir: str) -> int:
    """``--native-child``: the host route of every native entry point on
    the native step's tables, in a process whose library has no engine
    (``native.load(device="cpu")``): results under ``out_dir``, digests
    and the host route's ms (one run each) as the last stdout line."""
    from spark_rapids_jni_tpu_torch import native as nat
    nat.load(device="cpu")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tabs = native_tables()
    times, digests = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        times[name] = (time.perf_counter() - t0) * 1e3
        _require(nat.kernel_was_device(name.split()[0]) == 0,
                 f"{name} left the host route in the CPU child")
        return r

    with _native_table(nat, tabs["hash"]) as t:
        m3 = timed("murmur3", lambda: nat.murmur3_table(t))
        xx = timed("xxhash64", lambda: nat.xxhash64_table(t))
    with _native_table(nat, [(T.INT32, m3)]) as t:
        np.save(out / "murmur3_then.npy", nat.murmur3_table(t))
    with _native_table(nat, [(T.INT64, xx)]) as t:
        np.save(out / "xxhash64_then.npy", nat.xxhash64_table(t))
    np.save(out / "murmur3.npy", m3)
    np.save(out / "xxhash64.npy", xx)
    for m in NATIVE_ROW_TABLES:
        cols = tabs[f"rows {m}"]
        with _native_table(nat, cols) as t:
            batches = timed(f"to_rows {m}", lambda: nat.convert_to_rows(t))
        rows, dec = _Digest(), _Digest()
        for i, b in enumerate(batches):
            rows.add(f"batch {i}", b)
            rows.add("all", b)
        t0 = time.perf_counter()
        for b in batches:
            _decoded(dec, nat.convert_from_rows(b, [dt for dt, _ in cols]))
        times[f"from_rows {m}"] = (time.perf_counter() - t0) * 1e3
        _require(nat.kernel_was_device("from_rows") == 0, "from_rows host")
        digests[f"to_rows {m}"] = rows.hex() | {
            "batches": [int(b.shape[0]) for b in batches]}
        digests[f"from_rows {m}"] = dec.hex()
        del batches
    with _native_table(nat, tabs["sort"]) as t:
        np.save(out / "sort.npy", timed(
            "sort_order", lambda: nat.sort_order(t, [True, False])))
    with _native_table(nat, tabs["join left"]) as lt, \
            _native_table(nat, tabs["join right"]) as rt:
        li, ri = timed("inner_join", lambda: nat.inner_join(lt, rt))
    np.save(out / "join_left.npy", li)
    np.save(out / "join_right.npy", ri)
    for dims in NATIVE_GROUPS:
        g = math.prod(dims)
        with _native_table(nat, tabs[f"groupby {g} keys"]) as kt, \
                _native_table(nat, tabs[f"groupby {g} values"]) as vt:
            res = timed(f"groupby {g}", lambda: nat.groupby_sum_count(kt, vt))
        np.savez(out / f"groupby_{g}.npz", **_flat_groupby(res))
    _require(nat.live_handles() == 0, "the CPU child leaked native handles")
    print(json.dumps({"host_ms": times, "digests": digests}), flush=True)
    return 0


def _flat_groupby(res: dict) -> dict:
    out = {"rep_rows": res["rep_rows"], "sizes": res["sizes"]}
    for k in ("sums", "mins", "maxs", "means", "counts"):
        for i, a in enumerate(res[k]):
            out[f"{k} {i}"] = a
    return out


class NativePrep(threading.Thread):
    """Builds the native library (``nvcc``, every source at once) and then
    runs the CPU child, beside the rest of the smoke."""

    def __init__(self):
        super().__init__(daemon=True)
        self.build_s = None
        self.driver = None
        self.child = None
        self.error = None
        self.proc = None
        self.stopped = False

    def run(self):
        try:
            from spark_rapids_jni_tpu_torch import native as nat
            t0 = time.perf_counter()
            lib = nat.build()
            self.build_s = time.perf_counter() - t0
            self.driver = nat.build_jni_driver(lib, JNI_DRIVER)
            shutil.rmtree(NATIVE_DIR, ignore_errors=True)
            t0 = time.perf_counter()
            if self.stopped:
                return
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--native-child", str(NATIVE_DIR)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            out, err = self.proc.communicate(timeout=900)
            if self.proc.returncode != 0:
                raise RuntimeError(f"native child failed: {err[-4000:]}")
            self.child = json.loads(out.strip().splitlines()[-1])
            self.child["seconds"] = time.perf_counter() - t0
        except Exception as e:  # reported by the step, which fails
            self.error = e

    def stop(self):
        """Ends the child if it still runs (at the smoke's exit)."""
        self.stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def _route_bytes(tabs: dict) -> dict:
    """Bytes each route must move in device memory: inputs read once,
    outputs written once."""
    def data(name):
        return sum(v.nbytes for _, v in tabs[name])
    n, out = NATIVE_ROWS, {}
    out["murmur3"] = data("hash") + 4 * n
    out["xxhash64"] = data("hash") + 8 * n
    for m in NATIVE_ROW_TABLES:
        spr = K.pack_plan(tuple(dt.size_bytes for dt, _ in
                                tabs[f"rows {m}"])).size_per_row
        cols = len(tabs[f"rows {m}"])
        out[f"to_rows {m}"] = data(f"rows {m}") + spr * m
        out[f"from_rows {m}"] = (spr * m + data(f"rows {m}")
                                 + 4 * cols * ((m + 31) // 32))
    out["sort_order"] = data("sort") + 4 * n
    for dims in NATIVE_GROUPS:
        g = math.prod(dims)
        # outputs: rep row, size, and sum, min, max, mean a value column
        out[f"groupby {g}"] = (data(f"groupby {g} keys")
                               + data(f"groupby {g} values")
                               + g * (12 + 32 * len(tabs[f"groupby {g} "
                                                         "values"])))
    return out


def _native_timed(fn, reps: int) -> float:
    """Median host ms of ``fn()`` (each native call drains the engine's
    stream before it returns), its results released after each run."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        times.append((time.perf_counter() - t0) * 1e3)
        for x in (r if isinstance(r, (list, tuple)) else (r,)):
            if hasattr(x, "free"):
                x.free()
        del r
    return statistics.median(times)


def _same_groupby(got: dict, want, what: str) -> None:
    for k in ("rep_rows", "sizes"):
        _require(np.array_equal(got[k], want[k]), f"{what}: {k} differ")
    for k in ("sums", "mins", "maxs", "means", "counts"):
        for i, a in enumerate(got[k]):
            w = want[f"{k} {i}"]
            ok = (np.allclose(a, w, rtol=1e-9, atol=0, equal_nan=True)
                  if a.dtype == np.float64 else np.array_equal(a, w))
            _require(ok and a.dtype == w.dtype, f"{what}: {k} {i} differ")


def native_kernel_calls(dev, tabs: dict, m3: np.ndarray) -> list:
    """The engine's K4/K5/K6 launches of one pass as wrapper calls on the
    card, on the same inputs: the murmur3 chain of the hash table (floats
    normalised as the engine does; its end must equal the engine's
    hash), the chained hash of a hash, K6 over each row table and batch."""
    calls = []
    n = NATIVE_ROWS
    seeds = torch.full((n,), 42, dtype=torch.int32, device=dev)
    chain = []
    for dt, v in tabs["hash"]:
        t = torch.from_numpy(v).to(dev)
        if dt.id == T.TypeId.FLOAT32:
            bits = t.view(torch.int32)
            t = torch.where(t.isnan(), 0x7FC00000, torch.where(t == 0, 0,
                                                               bits))
        elif dt.id == T.TypeId.FLOAT64:
            bits = t.view(torch.int64)
            t = torch.where(t.isnan(), 0x7FF8000000000000,
                            torch.where(t == 0, 0, bits))
        name = "murmur3_int32" if t.element_size() == 4 else "murmur3_int64"
        chain.append((name, (t, seeds)))
        seeds = getattr(K, name)(t, seeds)
    _require(np.array_equal(seeds.cpu().numpy(), m3),
             "the wrappers' K4/K5 chain differs from the engine's murmur3")
    calls += [("native", nm, a) for nm, a in chain] * 2  # both ways
    calls.append(("native", "murmur3_int32", (
        seeds, torch.full((n,), 42, dtype=torch.int32, device=dev))))
    per_batch = rc.max_rows_per_batch(200)
    for m in NATIVE_ROW_TABLES:
        cols = [torch.from_numpy(v).to(dev) for _, v in tabs[f"rows {m}"]]
        widths = [c.element_size() for c in cols]
        none = [None] * len(cols)
        for a in range(0, m, per_batch):  # host tables: the host's batches
            calls.append(("native", "pack_rows", (
                [c[a:a + per_batch] for c in cols], widths, none)))
        calls.append(("native", "pack_rows", (cols, widths, none)))
    return calls


JNI_ROWS = 1_000_000  # the driver's murmurHash3 table: INT32 and INT64


def run_jni_driver(prep: NativePrep, log, card: str) -> dict:
    """The mock-``JNIEnv`` driver (``tests/torch_jni_engine_driver.cpp``,
    built with the host's ``g++`` against the library) in a child, as a
    Spark executor starts: a Hashing.murmurHash3 before init on the host
    route, ``PjrtEngine.init`` on device 0, the engine's queries, the
    refused program registration, and the same murmurHash3 again, which
    must route to the card (sentinel 1) and equal the host route."""
    t0 = time.perf_counter()
    proc = subprocess.run([str(prep.driver), "cuda: ", str(JNI_ROWS)],
                          capture_output=True, text=True, timeout=300)
    _require(proc.returncode == 0, f"JNI driver failed ({proc.returncode}): "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    _require(got["init_error"] == "" and got["available"]
             and got["device_count"] >= 1
             and got["platform"].startswith("cuda: ")
             and "StableHLO" in got["register_refused"]
             and not got["registered"] and got["host_sentinel"] == 0
             and got["device_sentinel"] == 1 and got["equal"]
             and got["failures"] == 0, f"JNI driver: {got}")
    got["seconds"] = time.perf_counter() - t0
    log(f"native JNI face: PjrtEngine.init on device 0 ({got['platform']}, "
        f"{got['device_count']} device(s)); registerProgram throws "
        f"({got['register_refused']!r}); Hashing.murmurHash3 over "
        f"{JNI_ROWS} rows routed to the card (sentinel 1) equal to the host "
        f"route before init; child {got['seconds']:.3f} s [{card}]")
    return got


def run_native(dev, prep: NativePrep, log, card: str, out_dir=None):
    """The native step: every route both ways with sentinel 1, equal to
    the CPU child's host route; K4/K5/K6 launches counted from the
    engine; ms per route; live handles back to 0."""
    from spark_rapids_jni_tpu_torch import native as nat
    t_step = time.perf_counter()
    prep.join()
    if prep.error is not None:
        raise prep.error
    log(f"native library built: {nat.library_path()} build_s="
        f"{prep.build_s:.3f} (nvcc, every source at once, beside steps "
        f"1-3); CPU child (host routes) {prep.child['seconds']:.1f} s "
        f"[{card}]")
    if out_dir:
        shutil.copyfile(nat.library_path().with_suffix(".log"),
                        os.path.join(out_dir, "chip_smoke_native_build.log"))
    torch.cuda.empty_cache()  # the engine allocates outside torch's cache
    nat.load()
    _require(nat.cuda_available(), "the CUDA engine did not start")
    log(f"native engine: {nat.cuda_platform_name()}, "
        f"{nat.cuda_device_count()} device(s)")
    jni = run_jni_driver(prep, log, card)
    tabs = native_tables()
    want = prep.child
    d = NATIVE_DIR
    n = NATIVE_ROWS
    sentinels = {}

    def check(route, way):
        s = nat.kernel_was_device(route)
        sentinels[f"{route} {way}"] = s
        _require(s == 1, f"{route} ({way}) read sentinel {s}, not 1")

    host = {k: _native_table(nat, v) for k, v in tabs.items()}
    nat.reset_kernel_launches()
    t0 = time.perf_counter()
    # -- one pass of every route both ways, counted --------------------------
    m3 = nat.murmur3_table(host["hash"])
    check("murmur3", "host table")
    xx = nat.xxhash64_table(host["hash"])
    check("xxhash64", "host table")
    _require(np.array_equal(m3, np.load(d / "murmur3.npy")), "murmur3")
    _require(np.array_equal(xx, np.load(d / "xxhash64.npy")), "xxhash64")
    dev_tabs = {k: t.to_device() for k, t in host.items()}
    with dev_tabs["hash"].murmur3() as b:
        check("murmur3", "resident")
        _require(np.array_equal(b.fetch(np.int32), m3), "murmur3 resident")
        with b.then(f"murmur3:i:{n}") as c:
            check("murmur3", "resident then")
            _require(np.array_equal(c.fetch(np.int32),
                                    np.load(d / "murmur3_then.npy")),
                     "murmur3 of a resident hash")
    with dev_tabs["hash"].xxhash64() as b:
        check("xxhash64", "resident")
        _require(np.array_equal(b.fetch(np.int64), xx), "xxhash64 resident")
        with b.then(f"xxhash64:l:{n}") as c:
            _require(np.array_equal(c.fetch(np.int64),
                                    np.load(d / "xxhash64_then.npy")),
                     "xxhash64 of a resident hash")
    for m in NATIVE_ROW_TABLES:
        schema = [dt for dt, _ in tabs[f"rows {m}"]]
        w_rows, w_dec = want["digests"][f"to_rows {m}"], \
            want["digests"][f"from_rows {m}"]
        batches = nat.convert_to_rows(host[f"rows {m}"])
        check("to_rows", "host table")
        got = _Digest()
        for i, b in enumerate(batches):
            got.add(f"batch {i}", b)
            got.add("all", b)
        _require([int(b.shape[0]) for b in batches] == w_rows["batches"]
                 and got.hex() == {k: v for k, v in w_rows.items()
                                   if k != "batches"},
                 f"to_rows {m}: the batches differ from the host route's")
        dec = _Digest()
        for b in batches:
            _decoded(dec, nat.convert_from_rows(b, schema))
            check("from_rows", "host table")
        _require(dec.hex() == w_dec, f"from_rows {m} differs")
        del batches
        with dev_tabs[f"rows {m}"].to_rows() as b:
            check("to_rows", "resident")
            got = _Digest()
            got.add("all", b.fetch(np.uint8))
            _require(got.hex()["all"] == w_rows["all"],
                     f"resident to_rows {m} differs")
            dec = _Digest()
            parts = b.from_rows(m, schema)
            check("from_rows", "resident")
            for c, (data, words) in enumerate(parts):
                vals = data.fetch(schema[c].storage_dtype)
                ok = nat._unpack_valid(words.fetch(np.uint32), m)
                _require(ok.all() and np.array_equal(
                    vals.view(np.uint8),
                    tabs[f"rows {m}"][c][1].view(np.uint8)),
                    f"resident from_rows {m} column {c} lost a value")
                dec.add(f"{c} data", vals)
                dec.add(f"{c} valid", np.packbits(ok, bitorder="little"))
                data.free()
                words.free()
            del parts
            _require(dec.hex() == w_dec, f"resident from_rows {m} differs "
                     "from the host route's")
    sort_want = np.load(d / "sort.npy")
    _require(np.array_equal(nat.sort_order(host["sort"], [True, False]),
                            sort_want), "sort_order")
    check("sort_order", "host table")
    with dev_tabs["sort"].sort_order([True, False]) as b:
        check("sort_order", "resident")
        _require(np.array_equal(b.fetch(np.int32), sort_want),
                 "resident sort_order")
    jl, jr = np.load(d / "join_left.npy"), np.load(d / "join_right.npy")
    for way, pairs in (("host table", lambda: nat.inner_join(
            host["join left"], host["join right"])),
            ("resident", lambda: dev_tabs["join left"].inner_join(
                dev_tabs["join right"]))):
        li, ri = pairs()
        check("inner_join", way)
        _require(np.array_equal(li, jl) and np.array_equal(ri, jr),
                 f"inner_join ({way}) differs")
    for dims in NATIVE_GROUPS:
        g = math.prod(dims)
        gw = np.load(d / f"groupby_{g}.npz")
        k, v = f"groupby {g} keys", f"groupby {g} values"
        _same_groupby(nat.groupby_sum_count(host[k], host[v]), gw,
                      f"groupby {g}")
        check("groupby", "host table")
        _same_groupby(dev_tabs[k].groupby_sum_count(dev_tabs[v]), gw,
                      f"resident groupby {g}")
        check("groupby", "resident")
        _require(len(gw["rep_rows"]) == g, f"{len(gw['rep_rows'])} groups")
    pass_s = time.perf_counter() - t0
    launches = {name: nat.kernel_launches().get(name, 0)
                for name in NATIVE_NAMES}
    engine = nat.kernel_launches()
    log(f"native pass: every route both ways equal to the host route, "
        f"sentinel 1, {pass_s:.3f} s; engine launches {json.dumps(engine)}")
    _require(launches == NATIVE_LAUNCHES,
             f"engine launches of K4/K5/K6 {launches} != {NATIVE_LAUNCHES}")
    # -- ms per route ---------------------------------------------------------
    nbytes = _route_bytes(tabs)
    # the join reads both key columns and writes its pairs
    nbytes["inner_join"] = (tabs["join left"][0][1].nbytes
                            + tabs["join right"][0][1].nbytes + 8 * jl.size)
    routes = []

    def route(name, way, rows, fn, key=None, reps=REPS):
        ms = _native_timed(fn, reps)
        b_ms = nbytes[key or name] / HBM_BYTES_PER_S * 1e3
        r = {"route": name, "way": way, "rows": rows, "ms": ms,
             "rows_per_s": rows / ms * 1e3, "bound_ms": b_ms,
             "host_ms": want["host_ms"].get(key or name)}
        routes.append(r)
        log(f"native {name} ({way}): {ms:.3f} ms, {r['rows_per_s']:.4g} "
            f"rows/s, byte bound {b_ms:.4f} ms, host route "
            f"{r['host_ms']:.1f} ms (one run, CPU child) [{card}]")

    route("murmur3", "host table", n, lambda: nat.murmur3_table(host["hash"]))
    route("murmur3", "resident", n, lambda: dev_tabs["hash"].murmur3())
    route("xxhash64", "host table", n,
          lambda: nat.xxhash64_table(host["hash"]))
    route("xxhash64", "resident", n, lambda: dev_tabs["hash"].xxhash64())
    for m in NATIVE_ROW_TABLES:
        schema = [dt for dt, _ in tabs[f"rows {m}"]]
        # 12M rows cross the host link both ways, seconds a run: 3 runs
        big = 3 if m > 2 ** 31 // 200 else REPS
        route("to_rows", "host table", m,
              lambda: nat.convert_to_rows(host[f"rows {m}"]), f"to_rows {m}",
              big)
        route("to_rows", "resident", m,
              lambda: dev_tabs[f"rows {m}"].to_rows(), f"to_rows {m}")
        batches = nat.convert_to_rows(host[f"rows {m}"])
        route("from_rows", "host table", m,
              lambda: [nat.convert_from_rows(b, schema) for b in batches],
              f"from_rows {m}", big)
        del batches
        with dev_tabs[f"rows {m}"].to_rows() as b:
            route("from_rows", "resident", m,
                  lambda: [x for pair in b.from_rows(m, schema)
                           for x in pair], f"from_rows {m}")
    route("sort_order", "host table", n,
          lambda: nat.sort_order(host["sort"], [True, False]))
    route("sort_order", "resident", n,
          lambda: dev_tabs["sort"].sort_order([True, False]))
    route("inner_join", "host table", n, lambda: nat.inner_join(
        host["join left"], host["join right"]))
    route("inner_join", "resident", n, lambda: dev_tabs["join left"]
          .inner_join(dev_tabs["join right"]))
    for dims in NATIVE_GROUPS:
        g = math.prod(dims)
        k, v = f"groupby {g} keys", f"groupby {g} values"
        route("groupby", "host table", n, lambda: nat.groupby_sum_count(
            host[k], host[v]), f"groupby {g}")
        route("groupby", "resident", n, lambda: dev_tabs[k]
              .groupby_sum_count(dev_tabs[v]), f"groupby {g}")
    for t in dev_tabs.values():
        t.free()
    for t in host.values():
        t.close()
    live = {"live_handles": nat.live_handles(),
            "live_device_handles": nat.live_device_handles(),
            "engine_buffers": nat.cuda_live_buffers()}
    _require(not any(live.values()), f"native handles left: {live}")
    calls = native_kernel_calls(dev, tabs, m3)
    step_s = time.perf_counter() - t_step
    log(f"native step: {step_s:.3f} s, live handles {json.dumps(live)} "
        f"[{card}]")
    log(json.dumps({"native_routes": routes}))
    return {"build_s": prep.build_s, "child_s": prep.child["seconds"],
            "jni": jni, "pass_s": pass_s, "step_s": step_s, "routes": routes,
            "sentinels": sentinels, "engine_launches": engine,
            "launches": launches, "live": live}, calls


def k3_beside_wall(step: str, phases: list, totals: dict, names: tuple,
                   card: str, log) -> None:
    """Each phase's warm wall time beside the device time of its K3
    calls (both forms)."""
    for r in phases:
        ms = [c["ms"] for name in names
              for c in totals[name]["per_call"] if c["query"] == r["phase"]]
        r["k3_ms"] = sum(ms)
        log(f"{step} {r['phase']}: {r['wall_ms']:.3f} ms wall, K3 "
            f"{sum(ms):.4f} ms in {len(ms)} call(s), peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB allocated [{card}]")


def kernel_entries(totals: dict, launches: dict, card: str, stress: list,
                   log) -> list:
    """The ``kernels`` line: each kernel of ``KERNELS`` summed over its
    (path, wrapper) parts, ``totals`` and ``launches`` keyed by path and
    then wrapper, with each part's calls, launches and times beside."""
    out = []
    for name, parts in KERNELS:
        spec = SPECS[name]
        wrappers = {w for _, w in parts}
        ts = [(p, w, totals[p][w], launches[p].get(w, 0)) for p, w in parts]
        ts = [x for x in ts if x[2]["calls"] or x[3]]
        by = {"bytes": 0.0, "operations": 0.0}
        for _, _, t, _ in ts:
            for r in t["per_call"]:
                by[r["bound_by"]] += r["bound_ms"]
        libs = [t["library_ms"] for _, _, t, _ in ts]
        entry = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(n for *_, n in ts),
            "calls": sum(t["calls"] for _, _, t, _ in ts),
            "path": " + ".join(dict.fromkeys(p for p, *_ in ts)),
            "max_abs_err": max([t["max_abs_err"] for _, _, t, _ in ts] + [
                r["max_abs_err"] for r in stress if r["name"] in wrappers],
                default=0),
            "ms": sum(t["ms"] for _, _, t, _ in ts),
            "plain_ms": sum(t["plain_ms"] for _, _, t, _ in ts),
            "bound_ms": sum(by.values()), "bound_by": max(by, key=by.get),
            "library_ms": None if None in libs else sum(libs),
            "parts": [{"path": p, "wrapper": w, "calls": t["calls"],
                       "launches": n, **{k: t[k] for k in (
                           "ms", "plain_ms", "bound_ms", "library_ms")}}
                      for p, w, t, n in ts],
            "stress": [{k: r[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for r in stress if r["name"] in wrappers]}
        out.append(entry)
        lib = ("none (no single PyTorch call computes it)"
               if entry["library_ms"] is None
               else f"{entry['library_ms']:.4f} (int64 index_add_, sums "
               "only)")
        each = "; ".join(f"{x['path']} {x['wrapper']}: calls={x['calls']} "
                         f"launches={x['launches']} ms={x['ms']:.4f}"
                         for x in entry["parts"])
        log(f"kernel {name}: {entry['path']} calls={entry['calls']} "
            f"launches={entry['launches']} kernel_ms={entry['ms']:.4f} "
            f"plain_ms={entry['plain_ms']:.4f} "
            f"bound_ms={entry['bound_ms']:.4g} ({entry['bound_by']}) "
            f"library_ms={lib} [{each}] [{card}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the build log and a JSON report")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm run of each query, table "
                    "hash, roster, strings and roster II phase and row "
                    "conversion")
    ap.add_argument("--queries-only", action="store_true",
                    help="only time q1-q20 as step 3 does (a cold pass, "
                    "then each query's warm median of 3), without the "
                    "oracles, kernel checks and later steps; print the "
                    "times as the last line, and no result")
    ap.add_argument("--rollup-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--warm-child", choices=("cold", "warm"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tune-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--native-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rows-only", action="store_true",
                    help="build the kernels, run only the row-conversion "
                    "step (step 7) with its kernel entries, and time the "
                    "native engine's row decoder beside K7; no result")
    ap.add_argument("--native-only", action="store_true",
                    help="build the kernels and the native library, run "
                    "only the native step (step 13) and print its routes "
                    "and K4/K5/K6 entries, and no result")
    args = ap.parse_args(argv)
    if args.rollup_child:
        return rollup_child()
    # one card: the device count printed at the end is the one used
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    _require(torch.cuda.device_count() == 1, "more than one card visible")
    if args.warm_child:
        return warm_child(args.warm_child)
    if args.tune_child:
        return tune_child()
    if args.native_child:
        return native_child(args.native_child)
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    logfile = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        logfile = open(os.path.join(args.out, "chip_smoke.log"), "w")

    def log(line: str) -> None:
        print(line, flush=True)
        if logfile:
            logfile.write(line + "\n")
            logfile.flush()

    prep = NativePrep()  # the native library's build, then its CPU child
    if not (args.queries_only or args.rows_only):
        atexit.register(prep.stop)
        prep.start()
    t0 = time.perf_counter()
    with env_set({"SRT_METRICS": "1"}):  # the build's compile event
        K.kernels()
    build_s = time.perf_counter() - t0
    log(f"kernels built: {K.library_path()} build_s={build_s:.3f}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_build.log"), "w") as f:
            f.write(K.library_path().with_suffix(".log").read_text())
    if args.queries_only:
        print(json.dumps({"queries_warm_ms": query_times(dev)}), flush=True)
        return 0
    Card.read()
    log(f"card: {Card.sms} SMs, max SM clock {Card.sm_hz / 1e6:.0f} MHz")
    if args.rows_only:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        rows, calls = run_row_conversion(dev, gen, log, args.profile)
        log("row-conversion kernel calls, each equal to its plain version:")
        totals = path_kernels(calls, rows["launches"], ROW_NAMES, log)
        del calls
        kernels_beside_wall(rows["cases"], totals, card, log)
        for name, t in totals.items():
            if t["calls"]:
                log(f"kernel {name}: row conversion calls={t['calls']} "
                    f"launches={rows['launches'][name]} "
                    f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                    f"bound_ms={t['bound_ms']:.4g} ({t['bound_by']}) "
                    f"[{card}]")
        native_unpack_yardstick(log, card)
        return 0
    if args.native_only:
        native_res, calls = run_native(dev, prep, log, card, args.out)
        totals = {"native": path_kernels(calls, native_res["launches"],
                                         NATIVE_NAMES, log, reps=3)}
        for name, t in totals["native"].items():
            log(f"kernel {name}: native calls={t['calls']} "
                f"launches={native_res['launches'][name]} "
                f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                f"bound_ms={t['bound_ms']:.4g} ({t['bound_by']}) [{card}]")
        return 0

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    stress = []
    for name, case in stress_cases(dev, gen):
        r = measure(name, case) | {"name": name}
        stress.append(r)
        lib = ("" if r["library_ms"] is None
               else f" library_ms={r['library_ms']:.4f}")
        log(f"stress {name} on {r['shape']}: equal to its plain version; "
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}{lib} "
            f"bound_ms={r['bound_ms']:.4g} ({r['bound_by']}) [{card}]")

    main_path, calls, rels, data, oracles = run_main_path(
        dev, SF, SEED, log, profile=args.profile)
    log("main-path kernel calls, each equal to its plain version on the "
        "inputs q1-q10 gave it:")
    totals = {"q1-q10": path_kernels(calls, main_path["launches"], Q_NAMES,
                                     log)}
    del calls
    oplib, calls, more = run_oplib_path(dev, rels, data, log, args.profile)
    oracles |= more
    del more
    log("q11-q20 kernel calls, each equal to its plain version on the "
        "inputs q11-q20 gave it:")
    totals["q11-q20"] = path_kernels(calls, oplib["launches"], Q_NAMES, log)
    del calls

    t0 = time.perf_counter()
    hashed, calls, hash_tab = run_hashing(dev, gen, rels, log, args.profile)
    text = hash_tab.columns[8]
    log("hashing kernel calls, each equal to its plain version:")
    totals["hashing"] = path_kernels(calls, hashed["launches"], HASH_NAMES,
                                     log)
    del calls
    hashed["step_s"] = time.perf_counter() - t0
    log(f"hashing step: {hashed['step_s']:.3f} s")

    t0 = time.perf_counter()
    roster, calls, stamps = run_roster(dev, gen, rels, log, args.profile)
    log("roster kernel calls, each equal to its plain version:")
    totals["roster"] = path_kernels(calls, roster["launches"], ROSTER_NAMES,
                                    log)
    del calls
    k3_beside_wall("roster", roster["phases"], totals["roster"],
                   ROSTER_NAMES, card, log)
    roster["step_s"] = time.perf_counter() - t0
    log(f"roster step: {roster['step_s']:.3f} s")

    t0 = time.perf_counter()
    strings, calls = run_strings(dev, gen, rels["store_sales"], stamps, text,
                                 log, args.profile)
    del stamps
    log("strings kernel calls, each equal to its plain version:")
    totals["strings"] = path_kernels(calls, strings["launches"],
                                     STRING_NAMES, log)
    del calls
    k3_beside_wall("strings", strings["phases"], totals["strings"],
                   STRING_NAMES, card, log)
    strings["step_s"] = time.perf_counter() - t0
    log(f"strings step: {strings['step_s']:.3f} s")

    t0 = time.perf_counter()
    roster2, calls = run_roster2(dev, gen, rels["store_sales"], text, log,
                                 args.profile)
    del text
    log("roster II kernel calls, each equal to its plain version:")
    totals["roster II"] = path_kernels(calls, roster2["launches"],
                                       ROSTER2_NAMES, log)
    del calls
    k3_beside_wall("roster II", roster2["phases"], totals["roster II"],
                   ROSTER2_NAMES, card, log)
    roster2["step_s"] = time.perf_counter() - t0
    log(f"roster II step: {roster2['step_s']:.3f} s")

    t0 = time.perf_counter()
    mesh, calls, group = run_mesh(dev, gen, rels, oracles, hash_tab, log,
                                  args.profile)
    del hash_tab
    log("mesh kernel calls, each equal to its plain version:")
    totals["mesh"] = path_kernels(calls, mesh["launches"], MESH_NAMES, log,
                                  reps=3)
    del calls
    mesh["step_s"] = time.perf_counter() - t0
    log(f"mesh step: {mesh['step_s']:.3f} s [{card}]")

    t0 = time.perf_counter()
    serving, calls, mesh_calls = run_serving(dev, rels, data, oracles,
                                             group[0], log, card)
    fleet, fleet_calls = run_fleet_control(dev, rels, oracles,
                                           serving.pop("serial"), log, card)
    distributed.shutdown()
    os.remove(group[1])
    log("served kernel calls, each equal to its plain version on the "
        "inputs the served q1-q20 gave it:")
    totals["serving"] = path_kernels(calls, serving["launches"], Q_NAMES,
                                     log, reps=3)
    log("kernel calls of q1-q20 served over the mesh, each equal to its "
        "plain version:")
    totals["serving mesh"] = path_kernels(
        mesh_calls, serving["mesh"]["launches"], MESH_NAMES, log, reps=3)
    del calls, mesh_calls
    serving["step_s"] = time.perf_counter() - t0 - fleet["step_s"]
    log(f"serving step: {serving['step_s']:.3f} s [{card}]")
    log("fleet-control kernel calls, each equal to its plain version on "
        "the inputs q1-q20 gave it through the scheduler:")
    totals["fleet control"] = path_kernels(fleet_calls, fleet["launches"],
                                           FLEET_NAMES, log, reps=3)
    del fleet_calls
    log(f"fleet-control step: {fleet['step_s']:.3f} s [{card}]")

    trace = run_trace_ranges(dev, rels, oracles, log, card)

    batching, calls, batch_rec = run_batching(dev, rels, data, oracles, log,
                                              card)
    log("batched kernel calls, each equal to its plain version on the "
        "inputs q1-q10's windows gave the eager batch program:")
    totals["batched"] = path_kernels(calls, batch_rec, Q_NAMES, log, reps=3)
    del calls
    log(f"batched serving step: {batching['step_s']:.3f} s [{card}]")

    t0 = time.perf_counter()
    morsel, calls = run_morsel(dev, data, rels, oracles, log, card,
                               args.profile)
    del data
    log("morsel kernel calls, each equal to its plain version on the "
        "inputs the streamed q1-q10 gave it:")
    totals["morsel"] = path_kernels(calls, morsel["launches"], MORSEL_NAMES,
                                    log, reps=3)
    del calls
    morsel["step_s"] = time.perf_counter() - t0
    log(f"morsel step: {morsel['step_s']:.3f} s [{card}]")

    warm_disk = run_warm_disk(log, card)
    log(f"warm-disk step: {warm_disk['step_s']:.3f} s [{card}]")
    tuned, calls, tune_launches = run_tune(dev, rels, oracles, log, card)
    del rels, oracles
    log("tuned q3 kernel calls, each equal to its plain version:")
    totals["tune"] = path_kernels(calls, tune_launches, TUNE_NAMES, log,
                                  reps=3)
    del calls
    log(f"tune step: {tuned['step_s']:.3f} s [{card}]")

    t0 = time.perf_counter()
    rows, calls = run_row_conversion(dev, gen, log, args.profile)
    log("row-conversion kernel calls, each equal to its plain version:")
    totals["row conversion"] = path_kernels(calls, rows["launches"],
                                            ROW_NAMES, log)
    del calls
    kernels_beside_wall(rows["cases"], totals["row conversion"], card, log)
    rows["step_s"] = time.perf_counter() - t0
    log(f"row-conversion step: {rows['step_s']:.3f} s")

    native_res, calls = run_native(dev, prep, log, card, args.out)
    native_res["unpack_yardstick"] = native_unpack_yardstick(log, card)
    log("native K4/K5/K6 launches as wrapper calls, each equal to its "
        "plain version on the engine's inputs:")
    totals["native"] = path_kernels(calls, native_res["launches"],
                                    NATIVE_NAMES, log, reps=3)
    del calls

    kernels = kernel_entries(
        totals, {"q1-q10": main_path["launches"],
                 "q11-q20": oplib["launches"],
                 "hashing": hashed["launches"],
                 "roster": roster["launches"],
                 "strings": strings["launches"],
                 "roster II": roster2["launches"],
                 "mesh": mesh["launches"],
                 "serving": serving["launches"],
                 "serving mesh": serving["mesh"]["launches"],
                 "batched": batching["launches"],
                 "morsel": morsel["launches"],
                 "fleet control": fleet["launches"],
                 "tune": tuned["launches"],
                 "row conversion": rows["launches"],
                 "native": native_res["launches"]}, card, stress, log)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_report.json"),
                  "w") as f:
            json.dump({"card": card, "sms": Card.sms, "sm_hz": Card.sm_hz,
                       "build_s": build_s, "stress": stress,
                       "path_kernels": totals, "main_path": main_path,
                       "q11_q20": oplib,
                       "hashing": hashed, "roster": roster,
                       "strings": strings, "roster_ii": roster2,
                       "mesh": mesh, "serving": serving,
                       "batching": batching, "morsel": morsel,
                       "fleet_control": fleet, "warm_disk": warm_disk,
                       "trace_ranges": trace,
                       "tune": tuned, "row_conversion": rows,
                       "native": native_res,
                       "sf": SF, "seed": SEED}, f, indent=1, sort_keys=True,
                      default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
