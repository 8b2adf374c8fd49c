#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository; it needs one CUDA device and the CUDA
toolkit (``nvcc``).  Phases, each timed:

1. Device and build: the card's name and power limit, and every kernel
   source under ``src/repro_torch/kernels/csrc/`` built at once, one nvcc
   each, in parallel.
2. segment_reduce against plain: every row source (slab, ids, dual) x op
   (or, and, xor, andnot, threshold, weighted threshold) at the main path's
   shapes (256 segments, about 10^5 rows) and at small edge cases; words
   must be bit-identical to the plain PyTorch version on the card and cards
   equal.  Kernel, plain and bytes-bound times are printed.
2b. The similarity score and select kernels against their plain versions:
   1,024 ragged candidates (about 2.3 * 10^5 rows, empty candidates, one
   at the maximum of 256 rows, duplicates that tie), every metric,
   ``exclude`` in {-1, 0, T-1}, a zero query cardinality and cards near
   2^31-1 for the score; k in {1, 10, 100, T} for the select, also on
   scores with many ties and on T = 5,000, and the select's off-contract
   cases (the repeat rounds after every entry above -2.0 is taken, every
   score below -2.0, -0.0 beside +0.0, a third of 1,024 at or below -2.0).
   Indices, intersections and float32 score bits must be equal, with one
   launch a call; in contract the select must also equal ``torch.sort``
   (stable), whose time is printed beside the kernel's and beside row 8's
   bitonic select fed the indices as ids (the design not taken).
2c. The pair kernels against their plain versions: the bitset pair op
   and count, the array x bitset probe, the array pair masks and count,
   at the path's shapes (M = 256, one merge of two terms; M = 8,192, a
   count batch; M = 1,027 with cards 0, 1, 64 and 4,096 mixed on each
   side, not a multiple of the count kernel's 4 rows a block) and at edge
   cases (M = 0 and 1; cards 0, 1 and 4,096; identical, disjoint and
   half-overlapping arrays; the values 0 and 65535; op ids -1 and 7;
   all-zero and all-ones words).  Words, masks and counts must be
   bit-equal; device times of kernel, plain version and library yardstick
   (``torch.searchsorted`` for the array kernels) and the bound are
   printed.
2d. The conversion kernels (array_to_bitset, bitset_set_many) and the
   popcount against their plain versions: at the path's shapes (M =
   245,760 array rows of about 64 values each, one ``to_words`` of the
   phase-7 tensor's sparse terms; M = 8,192) and at edge cases (M = 0 and
   1; cards -1, 0, 1, 4,096 and 5,000; the values 0, 65,535, 65,536 and
   -1; duplicated values; all-ones old words).  Words, deltas and counts
   must be bit-equal; device times of kernel, plain version and library
   yardstick (one ``scatter_add_`` over the masked values for
   array_to_bitset) and the bound are printed.
2e. The section-4 kernels (the fused bitset op and count for each of and,
   or, xor and andnot; the A-side sorted-array intersection) against
   their plain versions on phase 2c's inputs (M = 256 and 8,192) and edge
   cases (M = 1,027 with mixed cards, as in 2c; M = 0, 1 and 8: cards 0
   and 4,096, one side empty, a card above 4,096, a negative card, an A
   value of 65537 beside B's padding; M = 16, the intersection's own
   rows: A at 4,096 values against B past 512 values and against B at
   4,096, B of one value, A of one value, 65537 at A's last valid slot
   beside B padded with 65537, a negative card and a card above 4,096 on
   each side, cards of 127 to 129, A unsorted with repeats).
   Words, masks and counts must be bit-equal; device times of kernel,
   plain version and library yardstick (``torch.searchsorted`` for the
   intersection) and the bound are printed at M = 256, 8,192 and the
   mixed 1,027.
2f. The sharded similarity kernels (the score over ids and the labelled
   select) against their plain versions: phase 2b's 1,024 candidates
   (227,240 rows, read through positions of an arena-like table) split
   over S in {1, 3, 4} shards as the sharded engine splits them, every
   metric, a tie group of 11 straddling the shards at k = 10, a zero
   query cardinality, pad slots reading an all-zero row, exclusion of an
   id on each shard, k in {1, 10, 100} and past every shard's valid
   count; then the select alone on its edge cases (the rounds after
   every group above -2.0 is taken, every entry equal, one id on every
   entry, -1.0 and -2.0 entries, k past n, -0.0 beside +0.0) and on
   lists of 5,000 and 65,536 entries (past one block of the kernel) at k
   from 1 to 513.
   Scores, ids and intersections must be bit-equal, and the merged lists
   equal to the single-device score and select; times of the score over
   all 1,024 slots and of the select over one shard's list, over the
   merged S * k = 40 and 400 entries and over 5,000 and 65,536 entries,
   beside ``torch.sort``.
2g. The Roaring block-sparse decode attention kernel against its plain
   version at Gemma2-27B's decode shape (B = 4, H = 32, Hkv = 16, D = 128,
   S = 8,192, block 128, bfloat16, softcap 50, the serving engine's mask:
   sink 1 + local 8 blocks, three pinned blocks on row 0; kv_len 5,121 to
   5,160, different on each row) and at edge cases: an empty mask; kv_len
   0, 1, mid-block and S; bits past kv_len; every bit set; softcap 0;
   float32; g in {1, 2, 8}; D in {64, 256}; block 256; B = 1 and 64.
   The split count P (the grid blocks a row's keys are split over) is
   the wrapper's (8 at the live shape, one wave of the card; 1 at B =
   64) and forced to 1, 4, 9 (a wave and a tail), 16 and S / bs = 64 at
   the live shape, each timed, and to 16 in float32; and at Jamba's
   decode shape (Hkv = 8, so g = 4 query heads a KV head, softcap 0),
   timed beside its bound, the plain version and SDPA.
   float32 within atol = rtol = 2e-5, bfloat16 within one bf16 ulp of
   each (sequence, head) row's largest output (the ratio printed), rows
   with no visible position exactly 0; every case twice, bit for bit;
   where P > 1, the kernel's partials against the plain split step and
   the plain merge of them against the kernel's output.  Device times of
   the kernel and the plain version, its bytes bound and the ratio, and
   ``F.scaled_dot_product_attention`` over the expanded boolean mask at
   softcap 0 (live and full density).  Then the ``sparse_topk_blocks``
   gather route (plain PyTorch: the visible block ids by a prefix sum over
   the mask bits, a gather of only those K/V blocks) against the kernel
   on the live inputs with topk = S / bs, at least every row's visible
   count: float32 within 2e-5, bfloat16 within 8 bf16 ulps of each row's
   largest output (the route rounds its weights to bf16 before the PV
   product), also with topk the largest visible count (12); its device
   time beside the kernel's.
3. Boolean queries at real scale: an ``InvertedIndex`` over 2^24 documents
   and 1,024 terms on a ``BitmapArena`` on the card (64 dense bitset
   terms, 960 sparse array terms), 64 queries of each boolean class run
   one at a time and coalesced through ``aggregate.execute_plans``, every
   answer checked against an independent numpy oracle; then the two other
   segment_reduce front ends (cold staged rows, no arena).
4. Similarity at real scale on the same index: the engine built through
   ``InvertedIndex.similar`` (its build time and device bytes), 64
   member-term queries per metric at k = 10, 16 at k = 100 and 4 unknown
   terms, each equal to an independent numpy oracle (packed sets, popcount
   of the AND, float32 scores, stable argsort) and each launching the
   score and the select kernel exactly once; latency, idle share and
   kernel time per query.
5. The ``QueryServer`` on the same index: 256 mixed tickets (32 of each
   boolean class, 64 ``similar``) through ``run_until_idle``, every value
   equal to the oracle (so to the single-query calls of phases 3 and 4,
   which equal it), and in this fault-free run no retry, no host fallback
   and no degraded ticket; tickets/s and ticket latency.  Then scripted
   faults on a smaller index (2^20 documents, 64 terms): one
   ``dispatch_raise`` retries once, a ``slab_mismatch`` after one postings
   edit repatches only that row, and ``dispatch_raise`` always degrades
   every ticket to the host, flagged, with the same answers.
6. The two-by-two algebra on the same index: ``& | ^ -`` on 16 term
   pairs of each pairing (dense x dense, dense x sparse, sparse x dense,
   sparse x sparse) and 4 self-pairs, ``InvertedIndex.count_and`` and
   ``jaccard`` on the same pairs, a mixed-op
   ``RoaringBitmap.pairwise_card`` over 128 pairs and a ``jaccard_matrix``
   of 16 terms, each equal to the packed numpy oracle (Jaccard to the
   float64 bit); p50 / p99 per op and pairing, and from profiler
   windows over second calls the idle share, device busy time and the
   bytes the copies move for each merge, count and count batch.
7. ``RoaringTensor`` at real scale on the same index: ``from_bitmaps`` of
   all 1,024 postings and 64 window bitmaps (1-8 ranges of 4,096 to
   1,048,576 documents, run-optimized on the host, so run slots occur)
   at capacity 256 on the card, a 2.13 GiB slab; then ``cardinality``,
   ``packed_nbytes``, ``take(...).to_bitmaps()``, ``& | ^ andnot``, the
   four counts and ``jaccard`` on 80 row-aligned pairs (16 of each phase-6
   pairing, 16 window x sparse), a mixed-op ``pairwise_card`` over 512
   random pairs of the full tensor, ``contains`` on 64 rows, ``reduce_or``
   of the full tensor, ``run_optimize`` of the 64 window and 64 dense rows
   and ``to_arena`` followed by ``or_many``, each against the packed numpy
   oracle (host ``run_optimize`` for the kinds' bytes); p50 / p99 per
   operation and the peak device memory.
8. The caller-less ``kernels.ops`` entry points on the same index:
   ``popcount`` of all 16,384 dense bitset rows read from the arena's
   slab, ``bitset_op`` and ``bitset_op_card`` (every op) over the dense
   terms paired (t, t+1) (8,192 rows), ``bitset_set_many`` of the dense
   rows with sparse arrays of the same chunks (16,384 rows),
   ``array_intersect`` and ``array_difference`` over the sparse terms
   paired (t, t+1) (122,880 array rows a side, 1.875 GiB each) and the
   plain intersection once at that size; every answer against the packed
   numpy oracle; p50 / p99, one profiler window per entry point, launches
   and peak device memory.

9. The sharded paths on the same index over a ``WideMesh`` of four
   shards on the card (the arena's per-shard slabs, about 2 GiB more):
   phase 4's queries through ``similar(mesh=)``, each equal to phase 4's
   answer and launching the score over ids 4 times and the labelled
   select 5 times; a warm re-query that uploads no row; phase 3's classes
   through ``execute_plans(mesh=)``, equal to phase 3's answers; a sharded
   ``QueryServer`` over a share of phase 5's traffic with one
   ``slab_mismatch``; ``reduce_or(mesh=)`` of phase 7's tensor, equal to
   its union; a profiler window; and one edited term, after which one row
   of one shard patches.  The sharded similarity kernels must launch in
   phase 9 and in no earlier phase.
10. Gemma2-27B served at full width and depth, after phases 3-9 have
   released their device tensors: random bfloat16 weights from ``--seed``
   on the card (27,227,128,320 parameters), ``Engine(max_seq=8192,
   BlockPolicy(1, 8))``, B = 4 prompts of 5,120 tokens, 32 new tokens
   greedily, then 32 more under a ``lexicon_constraint`` (every token in
   the set; after ``release_all`` every page free).  The decode attention
   kernel launches 23 times a new token, never in prefill and in no
   earlier phase.  From the state after the first prefill, one
   ``decode_step(backend="ref")`` and one with the kernel give logits
   within 8 bf16 ulps of the largest, and each global layer's kernel
   output matches the plain version on the full-size cache within phase
   2g's limit; the gaps that a dropped last visible block gives, per
   layer and in the logits, are printed beside them; a second kernel step
   from the same state gives the same logits bit for bit.  Prefill seconds, decode ms a step
   (p50, p99), tokens/s, a profiler window over four steps (idle share,
   the kernel's share of device time), the step's bytes bound and the
   peak device memory.

11. Cold start and ingest on phase 3's index, at its full size, before
   phase 10 and with every temporary file in a directory removed at the
   end: ``serde.write_snapshot`` of all 1,024 postings, then
   ``load_index`` of the archive onto a fresh ``BitmapArena`` on the card
   (seconds to open and to the first answer), phase 3's boolean classes
   (64 queries a class) and phase 4's k = 10 ``similar`` queries on it,
   each equal to the oracle's answer (and a sample to the in-memory
   index's), a warm re-query that uploads no row, and the archive's bytes
   unchanged after the queries; every posting through RJ02, portable and
   frozen (the same set back, ``serialized_size_bytes`` equal to the
   length); the 960 sparse terms' postings and two dense terms' streamed
   through ``StreamingIndexBuilder`` in eight batches of documents in id
   order, each boundary half way through a chunk, with a
   ``segment_bytes`` that spills at least four segments, ``finalize``
   onto a fresh arena (the dense terms' split chunks merge in
   segment_reduce), every posting equal to the in-memory one and sparse
   boolean queries (8 a class, and the union of every sparse term) equal
   to the in-memory index's answers and, for 4 a class and the union, the
   oracle's; and
   ``RoaringDataPipeline`` over 2^24 documents with a quality and a dedup
   filter, 8 batches of 256 x 4,096 tokens with a ``state_dict`` round
   trip after the 4th (the resumed pipeline draws the same batches), no
   id drawn twice, every id in the filters' intersection and
   ``remaining()`` equal to the oracle's.  Launches per kernel are printed
   for each part; segment_reduce must launch in the reload, in the
   ingest's ``finalize`` and in its queries.

12. Jamba-v0.1 (``configs/jamba_v01_52b.py``) served at full width after
   phase 10 has released its model, with 16 of its 32 layers (two of its
   four 8-layer periods: 14 mamba and 2 global layers, 8 MoE and 8 dense
   ffns; 26,053,595,136 random bfloat16 parameters from ``--seed``, since
   the 32 layers' 103 GB exceed the card's 80 GB): phase 10's traffic
   (``Engine(max_seq=8192, BlockPolicy(1, 8))``, B = 4 prompts of 5,120
   tokens, 32 new tokens greedily, then 32 under a ``lexicon_constraint``,
   every token in the set and every page free after ``release_all``).
   The decode attention kernel launches 2 times a new token (once a global
   layer) and never in prefill.  From the state after the first prefill:
   ``decode_step(backend="ref")`` against the kernel's step (logits within
   8 bf16 ulps of the largest, each global layer's kernel output within
   phase 2g's limit), and a second kernel step from the same state giving
   the same logits bit for bit (the mamba state is not written in place).
   The first mamba layer's real prefill input at full width (B = 4, 5,120
   tokens, di 8,192, ds 16) through the chunked selective scan and the
   per-token float32 recurrence on the card: outputs and final h within
   1e-5 of the largest magnitude, and the prefill's own h equal to the
   scan's.  Printed: prefill seconds, decode ms a step (p50, p99),
   tokens/s, a profiler window over four steps (idle share, the kernel's
   share of device time, the top device ops), the step's bytes bound
   (every dense, attention and mamba weight, only the routed experts, the
   visible K/V rows and the mamba states), the peak device memory, the
   MoE ``dropped_fraction`` in prefill and in decode, and, from forward
   hooks, the first MoE layer's ``expert_idx`` of the first prefill
   through ``routing_sets``, ``load_balance_stats``,
   ``expert_overlap_matrix`` and ``routing_drift`` against the second
   prefill of the same prompts.

13. DeepSeek-V2 (``configs/deepseek_v2_236b.py``) served at full width
   after phase 12 has released its model, with 8 of its 60 layers (the
   dense prefix layer, ff 12,288, and 7 MLA + MoE layers: 128 heads,
   kv_lora 512, 160 experts of 1,536, top 6, 2 shared; 29,191,377,920
   random parameters from ``--seed``, 58.4 GB, since 9 layers' 66.3 GB
   would not fit beside the prefill): phase 10's traffic
   (``Engine(max_seq=8192, BlockPolicy(1, 8))``, B = 4 prompts of 5,120 tokens, 32 greedy tokens,
   then 32 under phase 10's lexicon constraint, every page free after).
   From the state after the first prefill: a second decode step bit-equal
   to the first; in every MLA layer of one step the absorbed attention
   (the prefix layer in JAX's ``mla_decode`` flavour, the others in its
   ``mla_decode_stacked`` one) against keys and values decompressed per
   head in float32 from the same ckv / k_rope caches, within 2^-5 of each
   head's largest output.  Printed: prefill seconds, decode ms a step
   (p50, p99), tokens/s, a profiler window over four steps (idle share,
   device ms a step, top device ops), the step's bytes bound (every dense,
   MLA and shared-expert weight, only the routed experts, the ckv / k_rope
   rows), the MoE ``dropped_fraction`` in prefill and decode (decode
   capacity 1), and the peak device memory.
14. xLSTM-350M (``configs/xlstm_350m.py``) whole on phase 10's traffic:
   the mLSTM prefill takes the chunkwise-parallel form (chunks of 64), the
   sLSTM runs token by token (its seconds and share of each prefill
   printed); a second decode step bit-equal; the first mLSTM layer's real
   prefill input through the chunked form and the per-token float32
   recurrence, h and the final C, n, m within 1e-5 of the largest
   magnitude and the prefill's own state equal to the chunked one.  Then
   HuBERT-xlarge (``configs/hubert_xlarge.py``, 48 encoder layers) whole:
   one encoder prefill of B = 4 x 5,120 frames of 512-wide audio-stub
   embeddings and no tokens, twice: finite (4, 504) logits, equal on the
   rerun.  Prefill seconds, decode ms a step, the idle share, xLSTM's step
   bytes bound (every weight, the B embedding rows, each layer's float32
   state read and written) and the peak device memory.

15. Qwen2.5-3B (``configs/qwen2_5_3b.py``) trained at full width and
   depth after phase 14, alone on the card: the port's ``Trainer`` (36
   layers, d 2,048, 16 / 2 heads, ff 11,008, vocab 151,936; 3,085,938,688
   random float32 master parameters from ``--seed``, bf16 compute,
   ``remat="block"``), its Roaring pipeline over 65,536 documents, batch 1
   of 4,096 tokens (the one cut: ``train_4k``'s global batch of 256), AdamW
   at lr 1e-3 with 5 warm-up steps, 5 steps (cut from 8 for the phase's
   time), then a sixth in a profiler window (``_traced`` with the
   trainer's ranges).  Printed: step ms p50 / p99 over steps 2-5,
   tokens/s, model FLOPs a step (6 N a token plus causal attention, 6 L S
   H hd) and their share of 989 TFLOP/s (``mfu``), the optimizer's bytes
   bound (read p, g, m, v, write p, m, v), the peak memory, and from the
   window the device time split into the data draw, forward + backward
   and the optimizer, the idle share (null unless the window kept every
   device event) and the top device ops.  Checks: every loss and grad
   norm finite, the norms above 0; the eval loss of the first and last
   batches (drawn by a twin of the trainer's pipeline) before their steps
   equals those steps' own losses, and each of the two steps lowers its
   own batch's loss.  At lr 1e-3 the first batch's loss after the 5 steps
   is printed, not checked: the pipeline's tokens are uniformly random,
   and at that rate the loss rises on the card (PERF.md, Findings).  So a
   second trainer from the same masters, pipeline and schedule at lr 1e-4
   trains 5 steps and must lower the first batch's loss from the same
   start.  Checked too: with 2 of the 36 layers at full width, the loss
   and every gradient leaf with remat on and off bit-equal; resume with 2
   layers (3 steps, an asynchronous checkpoint, a fresh trainer that
   resumes, 2 more steps) within 2e-4 of 5 uninterrupted steps, at the
   same pipeline step.  The pipeline's set algebra stays on its host
   merge at 65,536 documents, so the phase launches none of the
   17 kernels, and a launch fails it.
16. The rest of training after phase 15, each part alone on the card
   (everything before it released), each printing its step ms p50,
   tokens/s, peak memory and the 17 kernels' launches (none: a launch
   fails it) beside the card's name and power limit; float32 masters,
   bf16 compute, AdamW at lr 1e-4 after 1 warm-up step.
   16a. Mixtral-8x7B (``configs/mixtral_8x7b.py``) at full width, 2 of
   its 32 layers (d 4,096, 32 / 8 heads, 8 experts top-2 of 14,336,
   window 4,096; 3,164,688,384 parameters, 50.6 GB of state): the port's
   ``Trainer`` with its pipeline (65,536 documents, batch 1 of 4,096),
   ``remat="block"``, 5 steps, then a sixth in a profiler window.
   Printed: ``mfu`` (6 N_active a token, N_active every parameter but
   the 6 experts a token is not routed to, plus causal attention, over
   989 TFLOP/s), ``router_aux`` and each MoE layer's
   ``dropped_fraction`` a step, the window's forward + backward and
   optimizer split, idle share and top ops.  Checks: the first batch's
   eval loss lower after the steps (and equal to the first step's own
   loss before them); with remat on and off the loss and every gradient
   leaf bit-equal, and both routers' gradients above 0.
   16b. DeepSeek-V2 (``configs/deepseek_v2_236b.py``) at full width, its
   dense prefix layer alone (MLA with q_lora 1,536 and kv_lora 512, 128
   heads, ffn 12,288; 1,386,562,560 parameters, 22.2 GB): 3 train steps
   on the pipeline's first batch of 4,096 tokens, whose loss must fall
   over the steps (its eval loss after them below the first step's).  Two layers (85.7 GB) do not fit; the shared-expert MoE of
   its pattern layers trains only in the CPU tests.
   16c. HuBERT-xlarge (``configs/hubert_xlarge.py``) whole, 48 ``enc``
   layers (945,912,320 parameters, 15.1 GB): 3 steps of
   ``loss_and_metrics`` on one audio-stub batch, frontend embeddings
   (1, 4,096, 512) bf16 and 4,096 labels over its 504 units from the
   seed, no tokens; the loss must fall over the steps, as in 16b.
   16d. One ``Block(("mamba", "mlp"))`` at Jamba-v0.1's width (d 4,096, di
   8,192, ds 16, dt_rank 256, chunks of 128; float32 masters): forward
   and backward at B 1, S 4,096 in bf16, its wall and device ms and peak
   memory (the scan checkpoints each chunk); then in float32 at S 512 its
   gradients through the chunked scan against those through the per-token
   recurrence (``selective_scan_steps``), every leaf within 1e-4 of its
   largest magnitude.  A whole Jamba period (212.7 GB) does not fit.
   16e. xLSTM-350M (``configs/xlstm_350m.py``) whole, 24 mLSTM / sLSTM
   layers (443,044,960 parameters, 7.1 GB): the ``Trainer`` at sequences
   of 512 (cut from 4,096: the sLSTM runs token by token), 3 steps; the
   first batch's eval loss must fall.
   Qwen2-VL-72B (one layer, 54.1 GB) does not train on the card.
17. The dry run held against the card, after phase 16: for 17a
   Qwen2.5-3B whole (phase 15's config) and 17b Mixtral-8x7B at 2 layers
   (16a's), ``launch.dryrun.trace_cell`` traces one train step at batch 1
   x 4,096 on meta tensors on the host (``ShapeSpec(..., 4096, 1,
   "train")``), then the same step runs once on the card from fresh
   float32 masters and AdamW state (``remat="block"``).  The predicted
   peak (argument + temp bytes) must be within 10% of the measured
   ``max_memory_allocated`` above what was allocated before the model.
   Printed beside it: the trace's seconds and ops, its counted FLOPs and
   bytes next to phase 15's ``mfu`` numerator (6 N_active a token plus
   causal attention) and 6 N D, its roofline terms, what was live at the
   traced peak by the op that made it, the counted bytes by op, the
   step's seconds, the card's ``total_memory`` and
   ``launch.mesh.HBM_BYTES``.  The trace launches none of the 17 kernels,
   nor does the step.

18. The device mesh (``dist.ctx``, ``dist.sharding``, ``launch.mesh``):
   18a, after phase 17, the sharded train step: ``torchrun``'s
   environment for a world of one (``RANK`` 0, ``WORLD_SIZE`` 1, a free
   ``MASTER_PORT``), an NCCL process group and ``launch.mesh.
   make_local_mesh()`` = (1, 1) on the card; Qwen2.5-3B whole at phase
   15's batch and seed, every parameter, AdamW moment and batch leaf a
   DTensor placed by the rules (``train_step.shard_train_state``), two
   steps, held against two plain steps from the same masters: each
   step's loss and gradient norm bit-equal (every shard is the whole
   tensor); the step ms of both and the host time the DTensor dispatch
   adds.  18b, beside it, in child processes (each its own fake 256- or
   512-rank process group, ``launch.dryrun --mesh single|multi``): the
   dry run of ``qwen2_5_3b-train_4k`` and ``mixtral_8x7b-decode_32k`` on
   the (16, 16) and (2, 16, 16) production meshes; each cell's per-device
   peak, its fit in one card, its collective bytes by kind and its
   dominant term printed, and its per-device argument bytes held against
   the sum of the local shard sizes the rules give.  18c: ``python -m
   repro_torch.launch.train --distributed --arch qwen2.5-3b --reduced``
   for 2 steps under a world of one must exit 0 (the trainer raises on a
   non-finite loss).  18d, right after phase 9, on its index: a share of
   phase 4's similarity queries and of phase 3's boolean classes over a
   ``WideMesh`` of (card, CPU, card, CPU) -- one slab a shard on its own
   device, the rows a launch reads from another device gathered to it --
   each equal to the single-device answer, and a warm pass of them
   uploading no row; the rows gathered across devices a query printed.  The CPU shards run the plain versions, since
   the caller named that device.  No kernel is new: 18a-c launch none of
   the 17 (a launch fails them); 18d launches phase 9's on its card
   shards.

17c. After phase 17, a prefill's decode state in the dry run on the (16,
   16) production mesh (PyTorch's fake process group in this process,
   destroyed after): ``Transformer.placed_decode_state`` at
   ``qwen2_5_3b-prefill_32k``'s shape (32 x 32,768) under the counter must
   count exactly the state's per-device shard bytes by
   ``dist.sharding.decode_state_shardings``, not the 38.7 GB global
   shapes it reads; then Mixtral-8x7B's whole
   prefill at 32 x 4,096 traced: the decode-state bytes live at the traced
   peak (``peak.by_op["decode_state"]``) must equal the shard bytes, no
   global ``zeros`` may be live there, and the argument bytes must equal
   the rules' shard sizes.  No kernel launches.

19. Last, the port's five examples (``examples/torch_*.py``) on the card at
   their default sizes, each through its ``main`` in this process:
   quickstart, query_server, train_tiny_lm (200 steps, checkpoints in a
   temporary directory), constrained_serve and analytics_index.  Each
   one's wall time and launches are printed; each must launch its path's
   kernel (popcount, segment_reduce, decode_attention, segment_reduce;
   the trainer's pipeline has its own), train_tiny_lm's mean loss over
   its last 10 steps must be below that over its first 10, and the five
   must finish within 90 s.

Phases 10, 12, 13 and 14 share one serving driver (``_serve_phase``).

Launch counts are set to 0 just before each of phases 3 to 19 (and each
part of 11, 16 and 18, and each example of 19) and read just after it; a
kernel that a phase's path runs and that launched no time there fails the
script, and so does any launch in phases 13 to 17c and 18a-c, whose paths
run none: their prefills, decode
steps, checks, profiler windows, HuBERT's prefills, the training steps
and the dry run's traces.  In
phases 10, 12, 13 and 14 the counts are also set to 0 around the lexicon
constraint's build,
whose launches are read apart.  Then one JSON line with every kernel's numbers,
and the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device, when the
repository's sources are missing, or when any phase fails.  A detailed
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPORT = ROOT / "chiprun_out" / "chip_smoke.json"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12         # 32-bit lane ops; the data sheet's fp32 rate
N_DOCS = 1 << 24              # 256 chunks of 2^16 documents
N_DENSE, N_SPARSE = 64, 960
QUERIES = 64
CLASSES = ("and", "or", "xor", "andnot", "threshold", "threshold_w")
OPS = (("or", None), ("and", None), ("xor", None), ("andnot", None),
       ("threshold", "per_segment"), ("threshold", "weights"))
SOURCES = ("slab", "ids", "dual")
SOURCES_CU = ("segment_reduce", "similarity_topk", "pair_ops",
              "array_ops", "bitset_convert", "popcount",
              "bitset_ops", "block_sparse_attn")            # csrc/<name>.cu
PAIR_OPS = ("and", "or", "xor", "andnot")
PAIRINGS = ("dense x dense", "dense x sparse", "sparse x dense",
            "sparse x sparse")
PAIR_KERNELS = ("bitset_pair_op", "bitset_pair_card", "array_bitset_probe",
                "array_pair_masks", "array_intersect_card")
SECTION4_KERNELS = ("bitset_op", "bitset_op_card", "array_intersect")
METRICS = ("jaccard", "cosine", "containment")
SIM_T = 1024                  # candidates at the main path: the terms
CONVERT_KERNELS = ("array_to_bitset", "bitset_set_many", "popcount")
CONVERT_M = 245_760           # the array slots of the index's sparse terms
TENSOR_CAP = 256              # container slots a row: one a chunk
N_WINDOWS = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def _reset_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    from repro_torch.kernels import (
        array_ops, bitset_convert, bitset_ops, block_sparse_attn, harley_seal,
        pair_ops, segment_ops, topk_ops,
    )
    for mod in (segment_ops, topk_ops, pair_ops, array_ops, bitset_convert,
                harley_seal, bitset_ops, block_sparse_attn):
        mod.reset_launches()


def _pair_counts() -> dict:
    """Launches of each pair kernel since the last reset."""
    from repro_torch.kernels import array_ops, pair_ops
    both = {**pair_ops.launches_by_kernel, **array_ops.launches_by_kernel}
    return {name: both[name] for name in PAIR_KERNELS}


def _section4_counts() -> dict:
    """Launches of each section-4 kernel (fused bitset op and count,
    A-side array intersection) since the last reset."""
    from repro_torch.kernels import array_ops, bitset_ops
    return {**bitset_ops.launches_by_kernel,
            "array_intersect": array_ops.launches_by_kernel[
                "array_intersect"]}


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def _kernel_inputs(dev, gen, lens, n_table, n_staged):
    """Random rows, segment offsets, ids, dual-source positions (about one
    slot in ten cold, from a staged block) and weights, on the card."""
    def rand_rows(n):
        return torch.randint(-2**31, 2**31, (n, 2048), dtype=torch.int32,
                             device=dev, generator=gen)
    starts = torch.zeros(len(lens) + 1, dtype=torch.int32)
    starts[1:] = torch.cumsum(torch.tensor(lens, dtype=torch.int32), 0)
    r = int(starts[-1])
    table = rand_rows(max(n_table, r))            # the slab source's rows
    table[0] = 0                                  # the reserved zero row
    staged = rand_rows(n_staged)
    staged[0] = 0
    ids = torch.randint(1, n_table, (r,), dtype=torch.int32, device=dev,
                        generator=gen)
    cold = torch.rand(r, device=dev, generator=gen) < 0.1
    pos = torch.where(cold, 0, ids).to(torch.int32)
    sidx = torch.where(cold, torch.randint(1, n_staged, (r,), device=dev,
                                           generator=gen), 0)
    weights = torch.randint(1, 5, (r,), dtype=torch.int32, device=dev,
                            generator=gen)
    return dict(table=table, staged=staged, starts=starts.to(dev), ids=ids,
                pos=pos, sidx=sidx.to(torch.int32), weights=weights,
                lens=np.asarray(lens))


def _op_args(x, op, tmode):
    """Keyword arguments of one op case: T per segment (some exactly
    attainable, some above every count) and, for weights, the counter
    widths."""
    from repro_torch.kernels.segment_ops import counter_planes
    lens = x["lens"]
    jmax = max(1, int(lens.max()))
    kw = dict(jmax=jmax)
    if op != "threshold":
        return kw, {}
    scale = 4 if tmode == "weights" else 1
    t = np.maximum(1, (lens * scale) // 3)
    t[::5] = np.maximum(1, lens[::5])             # attainable by every row
    t[1::5] = lens[1::5] * scale + 1              # above every count
    kw["threshold"] = torch.from_numpy(t.astype(np.int32)).to(
        x["starts"].device)
    extra = {"planes": max(counter_planes(jmax * scale),
                           int(t.max()).bit_length())}
    if tmode == "weights":
        kw["weights"] = x["weights"]
        extra["wbits"] = 3
    return kw, extra


def _source_call(src, x):
    """(plain function, kernel wrapper, positional tensors) of a source."""
    from repro_torch.kernels import ref, segment_ops as so
    if src == "slab":
        return (ref.segment_reduce, so.segment_reduce,
                (x["table"][: int(x["starts"][-1])], x["starts"]))
    if src == "ids":
        return (ref.segment_reduce_rows, so.segment_reduce_rows,
                (x["table"], x["ids"], x["starts"]))
    return (ref.segment_reduce_rows_dual, so.segment_reduce_rows_dual,
            (x["table"], x["staged"], x["pos"], x["sidx"], x["starts"]))


def _time_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up (CUDA
    events).  The warm-up's result is returned."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


_LAUNCHES = ("Memcpy", "Memset", "LaunchKernel")    # runtime calls
_CU_LAUNCHES = ("cuLaunchKernel", "cuMemcpy", "cuMemset")   # below them
# segment_reduce's two kernels as the trace names them; PyTorch's own
# reductions are at::native::reduce_kernel<...>, which a bare
# "reduce_kernel" would also match
SEGMENT_KERNELS = (r"\(anonymous namespace\)::reduce_kernel<",
                   r"\(anonymous namespace\)::threshold_kernel<")
_PAIR_KERNEL_NAMES = ("pair_kernel", "probe_kernel",
                      "intersect_card_kernel")


def _trace_window(fn, dev, names=(), lead=64, ranges=()):
    """Run ``fn`` once in a profiler window and read the exported trace.

    Late in a long process the profiler can leave a window's earliest
    device events out of its trace (10 to 17 of them in phases 3-6 of this
    script on an H100 80GB HBM3 with PyTorch 2.11, whatever the window's
    length), so the window starts with ``lead`` one-element adds,
    synchronizes, and only then runs ``fn`` inside a ``record_function``
    range.  Of the runtime calls
    made in that range that queue device work (a copy, set or launch),
    the window is ``complete`` when every one has its device event.  From
    those events: device-busy microseconds (kernels, copies, sets), the
    time of the kernels whose names match one of the regular expressions
    ``names`` (in all and per name), the eight kernels that took the most
    time, and the bytes the copies moved up and down; ``lead_kept`` says
    how many lead adds kept theirs.  Kernels that PyTorch's libraries
    launch with ``cuLaunchKernel`` (cuBLASLt's, the attention kernels)
    have no runtime call to match, so ``span_busy_us`` also sums every
    device event that starts inside the measured range,
    ``span_top_kernels`` ranks those, and ``cu_launches`` counts the
    range's ``cuLaunchKernel`` / ``cuMemcpy`` / ``cuMemset`` calls.

    With ``ranges`` (names of ``record_function`` ranges that ``fn``
    opens), those driver calls are matched to their device events too and
    count in ``runtime_calls`` and towards ``complete`` (a training step
    launches its matmuls through them), and ``range_us`` splits
    ``busy_us`` by the range each event's call ran in, ``other`` for the
    rest."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x = torch.zeros(1, device=dev)
        for _ in range(lead):
            x.add_(1)
        torch.cuda.synchronize(dev)
        with record_function("chip_smoke.measured"):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t) * 1e6
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    span = next(((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == "chip_smoke.measured"), (0.0, 0.0))
    calls, lead_calls, work, by_kernel = {}, {}, {}, {}
    span_busy, span_kernels, cu_launches = 0.0, {}, 0
    range_spans = {n: [] for n in ranges}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        inside = span[0] <= e.get("ts", -1.0) <= span[1]
        if cat == "cuda_runtime" and any(k in name for k in _LAUNCHES):
            (calls if inside else lead_calls)[corr] = e
        elif name.startswith(_CU_LAUNCHES):
            cu_launches += inside
            if ranges and inside:
                calls[corr] = e
        elif cat == "user_annotation" and name in range_spans:
            range_spans[name].append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            work[corr] = e
            if inside:
                span_busy += float(e.get("dur", 0.0))
                if cat == "kernel":
                    span_kernels[name[:100]] = span_kernels.get(
                        name[:100], 0.0) + float(e.get("dur", 0.0))
    mine = {c: work[c] for c in calls if c in work}
    out = dict(wall_us=wall_us, lead=lead, busy_us=0.0, kernel_us=0.0,
               name_us={n: 0.0 for n in names}, h2d_bytes=0, d2h_bytes=0,
               range_us=dict.fromkeys((*ranges, "other"), 0.0),
               device_events=len(mine), runtime_calls=len(calls),
               lead_kept=sum(c in work for c in lead_calls),
               span_busy_us=span_busy, cu_launches=cu_launches,
               span_top_kernels=sorted(span_kernels.items(),
                                       key=lambda kv: -kv[1])[:8])
    for c, e in mine.items():
        name, dur = e.get("name", ""), float(e.get("dur", 0.0))
        out["busy_us"] += dur
        ts = calls[c]["ts"]
        out["range_us"][next((n for n, spans in range_spans.items() if any(
            a <= ts <= b for a, b in spans)), "other")] += dur
        if e["cat"] == "kernel":
            by_kernel[name[:100]] = by_kernel.get(name[:100], 0.0) + dur
        hit = ([n for n in names if re.search(n, name)]
               if e["cat"] == "kernel" else [])
        for n in hit:
            out["name_us"][n] += dur
        if hit:
            out["kernel_us"] += dur
        nbytes = int(e.get("args", {}).get("bytes", 0))
        if "HtoD" in name:
            out["h2d_bytes"] += nbytes
        elif "DtoH" in name:
            out["d2h_bytes"] += nbytes
    out["top_kernels"] = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out["complete"] = bool(calls) and len(mine) == len(calls)
    out["idle_share"] = (1.0 - out["busy_us"] / wall_us
                         if out["complete"] else None)
    return out


def _traced(label, fn, dev, names=(), ranges=()):
    """:func:`_trace_window` of a second call, with 64, then 256, then
    1,024 lead adds until a window is complete.  The first complete window
    is kept; every incomplete one is logged and kept in the report."""
    tries = []
    for lead in (64, 256, 1024):
        tr = _trace_window(fn, dev, names, lead, ranges)
        if tr["complete"]:
            break
        tries.append(tr)
        log(f"  {label}: profiler window with {lead} lead adds (kept "
            f"{tr['lead_kept']}) kept {tr['device_events']} of "
            f"{tr['runtime_calls']} device events of the measured calls")
    return dict(tr, incomplete_windows=tries)


def _device_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` runs after one warm-up: the
    sum of the card's event durations in a complete profiler window, per
    run.  Unlike CUDA events around a loop, it leaves out the host's time
    between launches, which is most of it for a kernel of microseconds.
    When no window kept every device event, the CUDA-event mean, logged."""
    fn()
    torch.cuda.synchronize()

    def repeat():                   # keeps no result alive
        for _ in range(reps):
            fn()
    tr = _traced("device time", repeat, torch.device("cuda"))
    if tr["complete"]:
        return tr["busy_us"] / reps / 1e3
    log("  device time: no complete profiler window; CUDA events instead")
    return _time_ms(fn, reps)[1]


def _bound(src, op, tmode, x, planes):
    """Least time for the work, in ms, and what bounds it: bytes (every
    needed row read once, outputs written once, index vectors read once)
    against operations (one op per word per row for the folds; for the
    counters about two per plane, per weight bit, per word per row)."""
    s = len(x["lens"])
    r = int(x["lens"].sum())
    idx = {"slab": 0, "ids": 4, "dual": 8}[src] * r
    nbytes = r * 8192 + s * 8192 + 4 * s + 4 * (s + 1) + idx
    ops = r * 2048
    if op == "threshold":
        nbytes += 4 * s + (4 * r if tmode == "weights" else 0)
        wset = (float(np.mean([bin(w).count("1") for w in
                               x["weights"].cpu().tolist()]))
                if tmode == "weights" else 1.0)
        ops = r * 2048 * 2 * planes * wset + s * 2048 * 4 * planes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, seed, failures, segments=256, max_len=781):
    from repro_torch.kernels import segment_ops as so
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    # main-path shapes: 256 segments, about 10^5 rows, a few empty
    lens = rng.integers(1, max_len + 1, segments)
    lens[rng.choice(segments, 4, replace=False)] = 0
    shapes = {"main": (lens.tolist(), 100_000, 4096),
              "edge": ([3, 0, 5, 1, 0, 7, 2, 9, 4], 64, 8),
              "jmax1": ([1, 1, 1, 1, 1], 16, 4)}
    cases = []
    max_err = 0
    for shape, (ls, n_table, n_staged) in shapes.items():
        x = _kernel_inputs(dev, gen, ls, n_table, n_staged)
        big = shape == "main"
        for src in SOURCES:
            plain, kern, args = _source_call(src, x)
            for op, tmode in OPS:
                kw, extra = _op_args(x, op, tmode)
                want, plain_ms = _time_ms(lambda: plain(*args, op, **kw),
                                          3 if big else 1)
                got, ms = _time_ms(lambda: kern(*args, op, **kw, **extra),
                                   20 if big else 1)
                same = torch.equal(got[0], want[0]) and \
                    torch.equal(got[1], want[1])
                for g, w in zip(got, want):
                    if g.numel():
                        max_err = max(max_err, int(
                            (g.to(torch.int64) - w).abs().max()))
                name = f"{shape}/{src}/{op}" + (f"/{tmode}" if tmode else "")
                if not same:
                    failures.append(f"kernel != plain: {name}")
                bound_ms, bound_by = _bound(src, op, tmode, x,
                                            extra.get("planes", 1))
                cases.append(dict(case=name, rows=int(x["lens"].sum()),
                                  segments=len(ls), equal=same,
                                  ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by))
                if big:
                    log(f"  {name:34s} equal={same} kernel {ms:.4f} ms  "
                        f"plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms "
                        f"({bound_by})")
        del x
        torch.cuda.empty_cache()
    log("  library_ms: null -- no single PyTorch call computes a segmented "
        "bitwise reduce fused with a popcount")
    n_small = sum(1 for c in cases if not c["case"].startswith("main"))
    log(f"  {n_small} edge cases: "
        f"{sum(c['equal'] for c in cases if not c['case'].startswith('main'))}"
        f" equal; launches so far {so.launches}")
    return cases, max_err


# ---------------------------------------------------------------------------
# phase 2b: the similarity score and select kernels against their plain
# versions
# ---------------------------------------------------------------------------

def _cards_of(rows, starts):
    """(T,) int32 popcount of each candidate's rows (plain torch, in
    blocks of rows so the int64 popcount stays small)."""
    from repro_torch.kernels.ref import popcount_words
    per = torch.cat([popcount_words(rows[i:i + 8192])
                     for i in range(0, rows.shape[0], 8192)])
    t = starts.shape[0] - 1
    seg = torch.searchsorted(starts[1:].long(),
                             torch.arange(rows.shape[0], device=rows.device),
                             right=True)
    return torch.zeros(t, dtype=torch.int64, device=rows.device).index_add_(
        0, seg, per.long()).to(torch.int32)


def _topk_inputs(dev, seed, n_cand=SIM_T, n_cols=256):
    """Main-path shapes: T = 1,024 candidates over 256 key columns, most
    with 192-256 rows (at most one per column, as in an engine), eight
    empty, one at the maximum of 256, and candidates 10-19 copies of
    candidate 9 (exact ties); random words on the card."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens = rng.integers(192, n_cols + 1, n_cand)
    lens[rng.choice(np.arange(20, n_cand - 2), 8, replace=False)] = 0
    lens[n_cand - 2] = n_cols
    lens[10:20] = lens[9]
    starts = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    cols = [np.sort(rng.choice(n_cols, n, replace=False)) for n in lens]
    for t in range(10, 20):
        cols[t] = cols[9]
    row_col = np.concatenate(cols).astype(np.int32)
    rows = torch.randint(-2**31, 2**31, (int(starts[-1]), 2048),
                         dtype=torch.int32, device=dev, generator=gen)
    s9 = int(starts[9])
    for t in range(10, 20):
        rows[int(starts[t]):int(starts[t + 1])] = rows[s9:int(starts[10])]
    q = torch.randint(-2**31, 2**31, (n_cols, 2048), dtype=torch.int32,
                      device=dev, generator=gen)
    st = torch.from_numpy(starts).to(dev)
    from repro_torch.kernels.ref import popcount_words
    return dict(rows=rows, row_col=torch.from_numpy(row_col).to(dev),
                starts=st, q=q, q_card=int(popcount_words(q).sum()),
                cards=_cards_of(rows, st), lens=lens)


def _score_bound(x):
    n, t = x["rows"].shape[0], len(x["lens"])
    nbytes = (n * 8192 + x["q"].shape[0] * 8192 + 4 * n + 4 * (t + 1)
              + 4 * t + 8 * t)
    ops = n * 2048 * 2                         # an AND and a popcount
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _select_bound(t, k):
    """Least time of the select: its 8 bytes a candidate read once and 12
    a result written, over the HBM rate.  The work an algorithm chooses (k
    rounds, a sort, a rank by counting) is not the function's, so no
    operations count here, as for the labelled select."""
    return (8 * t + 12 * k) / HBM_BYTES_PER_S * 1e3, "bytes"


def _select_edges(dev, rng, t):
    """(name, score, inter, k, in contract) for the select: the repeat
    rounds after every entry above -2.0 is taken ([0.5, -3.0, 0.25] and
    [0.5, -2.0, 0.1] at k = 3), every score below -2.0, -0.0 beside +0.0,
    k = T on these, and T entries of which a third lie at or below -2.0 at
    k = T (the rounds past them at scale).  In contract (every score above
    -2.0) the select must also give torch.sort's stable order."""
    def case(name, score, k, ok=False):
        sc = torch.tensor(np.asarray(score, np.float32), device=dev)
        it = torch.from_numpy(rng.integers(0, 1 << 20, sc.numel()).astype(
            np.int32)).to(dev)
        return (name, sc, it, k, ok)

    big = (rng.integers(-8, 40, t) / 32).astype(np.float32)
    big = np.where(big < -0.125, np.float32(-2.0),
                   np.where(big < 0, np.float32(-2.5), big))
    return [case("repeat/[.5,-3,.25]", [.5, -3, .25], 3),
            case("repeat/[.5,-2,.1]", [.5, -2, .1], 3),
            case("all below -2", [-3, -5, -2.5, -7], 4),
            case("all below -2/k=1", [-3, -5, -2.5, -7], 1),
            case("-2.0 and below", [-3, -2, -5, -2], 4),
            case("signed zeros", [0.0, -0.0, 0.0, 0.5, -0.0], 5, True),
            case(f"a third <= -2/T={t}/k=T", big, t),
            case(f"a third <= -2/T={t}/k=10", big, 10)]


def _bits_equal(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def _err(got, want):
    return max((float((g.double() - w.double()).abs().max())
                if g.numel() else 0.0) for g, w in zip(got, want))


def phase_topk_kernels(dev, seed, failures):
    """Score and select against their plain versions: exact equality of
    indices, intersections and float32 score bits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_ops as tk
    x = _topk_inputs(dev, seed + 10)
    t = len(x["lens"])
    args = (x["rows"], x["row_col"], x["starts"])
    cases, max_err = [], 0.0
    scores = {}
    variants = [("main", x["q"], x["q_card"], x["cards"]),
                ("q_card0", torch.zeros_like(x["q"]), 0, x["cards"]),
                ("cards_2^31", x["q"], 2**31 - 1, torch.randint(
                    2**31 - 2**20, 2**31, (t,), dtype=torch.int32,
                    device=dev))]
    for name, q, qc, cards in variants:
        for metric in METRICS:
            for exclude in (-1, 0, t - 1):
                big = name == "main" and exclude == -1
                want, plain_ms = _time_ms(lambda: ref.similarity_score(
                    *args, q, qc, cards, exclude, metric=metric),
                    3 if big else 1)
                got, ms = _time_ms(lambda: tk.similarity_score(
                    *args, q, qc, cards, exclude, metric=metric),
                    20 if big else 1)
                same = _bits_equal(got, want)
                max_err = max(max_err, _err(got, want))
                case = f"score/{name}/{metric}/exclude={exclude}"
                if not same:
                    failures.append(f"kernel != plain: {case}")
                bound_ms, bound_by = _score_bound(x)
                cases.append(dict(case=case, equal=same, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=None))
                if big:
                    log(f"  {case:40s} equal={same} kernel {ms:.4f} ms  "
                        f"plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms"
                        f" ({bound_by})")
                if name == "main" and exclude == 0:
                    scores[metric] = got
    rng = np.random.default_rng(seed + 11)
    ties = torch.from_numpy((rng.integers(0, 6, t) / 5).astype(
        np.float32)).to(dev)
    scores["ties"] = (ties, x["cards"])
    wide = 5000                         # past one tile of the rank select
    scores[f"T={wide}"] = tuple(torch.from_numpy(a).to(dev) for a in (
        (rng.integers(0, 41, wide) / 40).astype(np.float32),
        rng.integers(0, 1 << 20, wide).astype(np.int32)))
    runs = [(f"{name}/k={k}", score, inter, k, True)
            for name, (score, inter) in scores.items()
            for k in sorted({k for k in (1, 10, 100, score.numel())
                             if k <= score.numel()})]
    runs += _select_edges(dev, rng, t)
    for label, score, inter, k, in_contract in runs:
        n = score.numel()
        timed = label in ("jaccard/k=10", "jaccard/k=100",
                          f"T={wide}/k=10", f"T={wide}/k=100")
        want, plain_ms = _time_ms(lambda: ref.topk_select(
            score, inter, k), 3 if timed else 1)
        n0 = tk.launches_by_stage["select"]
        got = tk.topk_select(score, inter, k)
        torch.cuda.synchronize()
        one_launch = tk.launches_by_stage["select"] == n0 + 1
        _, ms = _time_ms(lambda: tk.topk_select(score, inter, k),
                         50 if timed else 1)
        lib, lib_ms = _time_ms(lambda: torch.sort(
            score, descending=True, stable=True).indices[:k],
            50 if timed else 1)
        same = (_bits_equal(got, want) and one_launch
                and (not in_contract or torch.equal(got[0].long(), lib)))
        device = {}
        if timed:                       # launch-bound: time on the device
            ids = torch.arange(n, dtype=torch.int32, device=dev)
            device = dict(
                device_ms=_device_ms(lambda: tk.topk_select(
                    score, inter, k), 50),
                device_plain_ms=_device_ms(lambda: ref.topk_select(
                    score, inter, k), 3),
                device_library_ms=_device_ms(lambda: torch.sort(
                    score, descending=True, stable=True).indices[:k], 50),
                # the other design the rank select was measured against:
                # row 8's one-pass bitonic select, fed the indices as ids
                device_bitonic_ms=_device_ms(lambda: tk.topk_merge(
                    score, inter, ids, k), 50))
        max_err = max(max_err, _err(got, want))
        case = f"select/{label}"
        if not same:
            failures.append(f"kernel != plain: {case} (one launch: "
                            f"{one_launch})")
        bound_ms, bound_by = _select_bound(n, k)
        cases.append(dict(case=case, equal=same, one_launch=one_launch,
                          in_contract=in_contract, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms, **device))
        if timed:
            log(f"  {case:40s} equal={same} events: kernel {ms:.4f} ms"
                f"  plain {plain_ms:.3f} ms  torch.sort {lib_ms:.4f} ms"
                f"; device: kernel {device['device_ms']:.4f} ms  plain "
                f"{device['device_plain_ms']:.3f} ms  torch.sort "
                f"{device['device_library_ms']:.4f} ms  bitonic "
                f"{device['device_bitonic_ms']:.4f} ms; bound "
                f"{bound_ms:.6f} ms ({bound_by})")
    edges = [c for c in cases if c["case"].startswith("select/")
             and not c["in_contract"]]
    log(f"  select off contract: {sum(c['equal'] for c in edges)} of "
        f"{len(edges)} equal to plain, one launch each")
    info = dict(candidates=t, rows=int(x["rows"].shape[0]),
                empty=int((x["lens"] == 0).sum()),
                longest=int(x["lens"].max()))
    log(f"  {len(cases)} cases, {sum(c['equal'] for c in cases)} equal; "
        f"{info['rows']} rows over {t} candidates ({info['empty']} empty, "
        f"longest {info['longest']}); launches so far {tk.launches_by_stage}")
    del x, scores
    torch.cuda.empty_cache()
    return cases, max_err, info


# ---------------------------------------------------------------------------
# phase 2c: the pair kernels against their plain versions
# ---------------------------------------------------------------------------

def _sorted_rows(rng, cards, lo=0, hi=1 << 16):
    """(M, 4096) int32: row r holds cards[r] sorted distinct values in
    [lo, hi), zeros after them (the planner's padding)."""
    vals = np.zeros((len(cards), 4096), np.int32)
    for r, c in enumerate(cards):
        vals[r, :c] = np.sort(rng.choice(np.arange(lo, hi), c,
                                         replace=False))
    return vals


def _sparse_rows(rng, m, mean=64):
    """Rows as the path gives them at 0.1% density: about ``mean`` sorted
    distinct values per row (random gaps), zeros after the card."""
    gaps = rng.integers(1, 2 * (65536 // mean), (m, 4096))
    vals = np.cumsum(gaps, axis=1) - 1
    cards = (vals < 65536).sum(axis=1).astype(np.int32)
    vals = np.where(vals < 65536, vals, 0).astype(np.int32)
    return vals, cards


def _pair_inputs(m, seed):
    """Main-path-shaped inputs of every pair kernel at M rows: random
    words with op ids cycling through 0, 1, 2, 3, -1 and 7; sparse array
    rows; B rows holding every other value of their A row plus as many
    of their own (a 50% overlap)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, (m, 2048), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (m, 2048), dtype=np.uint32)
    ids = np.resize(np.array([0, 1, 2, 3, -1, 7], np.int32), m)
    av, ac = _sparse_rows(rng, m)
    own, oc = _sparse_rows(rng, m)
    bv = np.zeros_like(av)
    bc = np.zeros(m, np.int32)
    for r in range(m):
        v = np.union1d(av[r, :ac[r]:2], own[r, :oc[r] // 2])[:4096]
        bv[r, :v.size] = v
        bc[r] = v.size
    return dict(a=a, b=b, ids=ids, av=av, ac=ac, bv=bv, bc=bc)


def _pair_edges(m):
    """Edge rows: op ids 0..3, -1 and 7 over all-zero, all-ones and
    identical words; cards 0, 1 and 4096, identical arrays, disjoint value
    ranges, a 50% overlap and the values 0 and 65535."""
    rng = np.random.default_rng(m + 99)
    a = rng.integers(0, 1 << 32, (m, 2048), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (m, 2048), dtype=np.uint32)
    ids = np.resize(np.array([0, 1, 2, 3, -1, 7, 3, 0], np.int32), m)
    ac = np.resize(np.array([0, 1, 4096, 3000, 900, 1000, 4096, 2]), m)
    bc = np.resize(np.array([5, 1, 1, 3000, 800, 1000, 4096, 3]), m)
    av = _sorted_rows(rng, ac)
    bv = _sorted_rows(rng, bc)
    for r in range(m):
        kind = r % 8
        if kind == 1:
            a[r], b[r] = 0, 0xFFFFFFFF
            bv[r, 0] = av[r, 0]
        elif kind == 2:
            a[r] = b[r] = 0xFFFFFFFF
            bv[r, 0] = av[r, 17]
        elif kind == 3:
            b[r] = a[r]
            bv[r] = av[r]
        elif kind == 4:
            av[r, :900] = _sorted_rows(rng, [900], 0, 30000)[0, :900]
            bv[r, :800] = _sorted_rows(rng, [800], 30000, 65536)[0, :800]
        elif kind == 5:
            c = np.sort(rng.choice(65536, 1500, replace=False))
            av[r, :1000] = np.sort(c[:1000])
            bv[r, :1000] = np.sort(c[500:])
        elif kind == 7:
            av[r, :2] = [0, 65535]
            bv[r, :3] = [0, 7, 65535]
    return dict(a=a, b=b, ids=ids, av=av, ac=ac.astype(np.int32), bv=bv,
                bc=bc.astype(np.int32))


def _mixed_cards(m, seed):
    """Phase 2c's mixed-card shape: :func:`_pair_inputs` rows whose array
    cards cycle through 0, 1, 64 and 4,096 on each side, out of step, so
    one launch meets every pairing of an empty, a one-value, a path-sized
    and a full row (B above the count kernel's 512 staged values among
    them); B holds every other value of A plus its own."""
    x = _pair_inputs(m, seed)
    rng = np.random.default_rng(seed + 1)
    ac = np.resize(np.array([0, 1, 64, 4096], np.int32), m)
    bc = np.resize(np.array([4096, 64, 1, 0, 64, 4096, 1], np.int32), m)
    av = _sorted_rows(rng, ac)
    bv = np.zeros_like(av)
    for r in range(m):
        own = rng.choice(1 << 16, bc[r], replace=False)
        v = np.union1d(av[r, :ac[r]:2], own)[:bc[r]]
        bv[r, :v.size] = v
        bc[r] = v.size
    return dict(x, av=av, ac=ac, bv=bv, bc=bc)


def _to_card(x, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)
                                if v.dtype == np.uint32 else
                                np.ascontiguousarray(v, np.int32)).to(dev)
            for k, v in x.items()}


def _searchsorted_hits(sorted_rows, probes):
    """The library yardstick of rows 13 and 14: a batched
    torch.searchsorted of one side into the other, then the equality
    test (sentinel-padded rows made outside the timing)."""
    idx = torch.searchsorted(sorted_rows, probes).clamp_(max=4095)
    return torch.gather(sorted_rows, 1, idx) == probes


def _pair_calls(t):
    """(kernel name, case label, plain call, kernel call, library call or
    None) per kernel."""
    from repro_torch.kernels import array_ops, pair_ops, ref
    a, b, ids = t["a"], t["b"], t["ids"]
    arr = (t["av"], t["ac"], t["bv"], t["bc"])
    pos = torch.arange(4096, device=a.device)
    pa = torch.where(pos < t["ac"][:, None], t["av"], 65536)
    pb = torch.where(pos < t["bc"][:, None], t["bv"], 65537)
    return [
        # rows 9-11: no PyTorch call computes a popcount or a bit test at
        # gathered positions, so there is no library yardstick
        ("bitset_pair_op", "bitset_pair_op",
         lambda: ref.bitset_pair_op(a, b, ids),
         lambda: pair_ops.bitset_pair_op(a, b, ids), None),
        ("bitset_pair_card", "bitset_pair_card",
         lambda: ref.bitset_pair_card(a, b, ids),
         lambda: pair_ops.bitset_pair_card(a, b, ids), None),
        ("array_bitset_probe", "array_bitset_probe",
         lambda: ref.array_bitset_probe(t["av"], t["ac"], a),
         lambda: pair_ops.array_bitset_probe(t["av"], t["ac"], a), None),
        ("array_pair_masks", "array_pair_masks",
         lambda: ref.array_pair_masks(*arr),
         lambda: array_ops.array_pair_masks(*arr),
         lambda: (_searchsorted_hits(pb, pa), _searchsorted_hits(pa, pb))),
        ("array_intersect_card", "array_intersect_card",
         lambda: ref.array_intersect_count(*arr),
         lambda: array_ops.array_intersect_card(*arr),
         lambda: _searchsorted_hits(pb, pa)),
    ]


def _probe_sectors(vals, cards):
    """Distinct 32-byte sectors of the word row (256 values each) that
    the first ``cards[r]`` sorted values of each row fall in."""
    sec = vals.astype(np.int64) >> 8
    valid = np.arange(vals.shape[1]) < cards[:, None]
    change = (sec[:, 1:] != sec[:, :-1]) & valid[:, 1:]
    return (cards > 0).astype(np.int64) + change.sum(axis=1)


def _pair_bound(name, x):
    """Least time, in ms, and what bounds it.  Bytes: every input read
    once -- of an array row only its values below the card, of the
    probe's word row only the 32-byte sectors those values fall in (the
    kernel itself stages the whole 8 KiB row) -- and every output written
    once.  Operations: a logical op and a popcount per word for the
    bitset rows, a load, shift and test per probed value, about
    log2(card) compares per searched value."""
    m = len(x["ids"])
    ac, bc = x["ac"].astype(np.int64), x["bc"].astype(np.int64)
    vals = 4 * int(ac.sum() + bc.sum())
    search = float((ac * np.log2(bc + 2)).sum())
    if name == "bitset_pair_op":
        nbytes, ops = m * (16384 + 4 + 8192 + 4), m * 2048 * 2
    elif name == "bitset_pair_card":
        nbytes, ops = m * (16384 + 4 + 4), m * 2048 * 2
    elif name == "array_bitset_probe":
        words = 32 * int(_probe_sectors(x["av"], ac).sum())
        nbytes = m * (4 + 16384 + 4) + 4 * int(ac.sum()) + words
        ops = 3 * int(ac.sum())
    elif name == "array_pair_masks":
        nbytes = m * (8 + 32768 + 4) + vals
        ops = search + float((bc * np.log2(ac + 2)).sum())
    elif name == "bitset_op":
        nbytes, ops = m * (16384 + 8192 + 4), m * 2048 * 2
    elif name == "bitset_op_card":
        nbytes, ops = m * (16384 + 4), m * 2048 * 2
    elif name == "array_intersect":
        nbytes, ops = m * (8 + 16384 + 4) + vals, search
    else:
        nbytes, ops = m * (8 + 4) + vals, search
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_pair_kernels(dev, seed, failures, calls=_pair_calls,
                       names=PAIR_KERNELS, edges=_pair_edges,
                       counts=_pair_counts, edge_rows=(0, 1, 8)):
    """The five pair kernels against their plain versions: at the path's
    shapes (M = 256, one merge of two terms at 2^24 documents; M = 8,192,
    a count batch) and at edge cases (M in ``edge_rows``).  Words, masks
    and counts must be bit-equal.  Kernel, plain and library times are
    device times from the profiler (a launch at M = 256 takes
    microseconds), with CUDA-event times beside them.  Phase 2e runs the
    same loop over the section-4 kernels (``calls``, ``names``,
    ``edges``, ``counts``, ``edge_rows``)."""
    cases, max_err = [], {name: 0 for name in names}
    shapes = [("main", 256), ("main", 8192), ("mixed", 1027)]
    shapes += [("edge", m) for m in edge_rows]
    for kind, m in shapes:
        x = (_pair_inputs(m, seed + m) if kind == "main" else
             _mixed_cards(m, seed + m) if kind == "mixed" else edges(m))
        t = _to_card(x, dev)
        for name, label, plain, kern, lib in calls(t):
            want = plain()
            got = kern()
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            for g, w in zip(got, want):
                if g.numel():
                    max_err[name] = max(max_err[name], int(
                        (g.to(torch.int64) - w).abs().max()))
            case = f"{kind}/M={m}/{label}"
            if not same:
                failures.append(f"kernel != plain: {case}")
            row = dict(case=case, kernel=name, rows=m, equal=same)
            if kind != "edge":
                bound_ms, bound_by = _pair_bound(name, x)
                row.update(
                    ms=_device_ms(kern, 20),
                    plain_ms=_device_ms(plain, 3),
                    library_ms=_device_ms(lib, 10) if lib else None,
                    event_ms=_time_ms(kern, 20)[1],
                    event_plain_ms=_time_ms(plain, 3)[1],
                    bound_ms=bound_ms, bound_by=bound_by,
                    mean_a_card=float(x["ac"].mean()),
                    mean_b_card=float(x["bc"].mean()))
                lib_txt = (f"{row['library_ms']:.4f}" if lib else
                           "null (no PyTorch call)")
                log(f"  {case:34s} equal={same} device: kernel "
                    f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                    f"library {lib_txt}; events: kernel "
                    f"{row['event_ms']:.4f} ms; bound {bound_ms:.4f} ms "
                    f"({bound_by})")
            cases.append(row)
        del t
        torch.cuda.empty_cache()
    edge_rows = [c for c in cases if c["case"].startswith("edge")]
    log(f"  {len(edge_rows)} edge cases: "
        f"{sum(c['equal'] for c in edge_rows)} equal; launches so far "
        f"{counts()}")
    return cases, max_err


# ---------------------------------------------------------------------------
# phase 2e: the section-4 kernels against their plain versions
# ---------------------------------------------------------------------------

def _section4_edges(m):
    """Phase 2c's edge rows (cards 0, 1 and 4,096, A empty, identical,
    disjoint and half-overlapping arrays, all-zero and all-ones words), and
    for M = 8: B empty (row 1), a negative card (row 4), a card above 4,096
    (row 6), and in row 7 A = [0, 65535, 65537] against B = [0, 7, 65535]
    whose slots past its card hold 65537 (a slot at or above a card never
    matches).  M = 16 holds the A-side intersection's own edge rows
    (:func:`_intersect_edges`)."""
    x = _pair_edges(m)
    if m == 16:
        av, ac, bv, bc = _intersect_edges(np.random.default_rng(m + 7))
        x.update(av=av, ac=ac, bv=bv, bc=bc)
    elif m >= 8:
        x["bc"][1], x["bc"][4], x["ac"][6] = 0, -3, 5000
        x["av"][7, :3], x["ac"][7] = [0, 65535, 65537], 3
        x["bv"][7, 3:] = 65537
    return x


def _intersect_edges(rng):
    """Sixteen rows for the A-side intersection: A at 4,096 values
    against B past 512 (1,000 values, an eighth of A's among them; 513),
    against B at 4,096 (identical; random), against B of one value, and
    A of one value against B at 4,096; the value 65537 at A's last valid
    slot beside B's slots past its card holding 65537; a negative card on
    each side; cards above 4,096 on each side; cards of 127 to 129 around
    the 128 values the kernel asks for early at small M; and A unsorted
    with repeats (off contract: the rows must still equal the plain
    version's)."""
    ac = np.array([4096, 4096, 4096, 4096, 4096, 1, 4000, -1, 5000, 100,
                   64, 129, 128, 127, 40, 4095], np.int32)
    bc = np.array([1000, 513, 4096, 4096, 1, 4096, 2000, 4096, 4096, 5000,
                   -7, 129, 128, 600, 40, 4097], np.int32)
    av = _sorted_rows(rng, np.clip(ac, 0, 4096))
    bv = _sorted_rows(rng, np.clip(bc, 0, 4096))

    def share(r, n):                 # B's valid prefix takes n of A's
        keep = bv[r, :np.clip(bc[r], 0, 4096)]
        take = av[r, :np.clip(ac[r], 0, 4096)][::max(1, ac[r] // n)][:n]
        mixed = np.union1d(take, keep)[:keep.size]
        bv[r, :mixed.size] = mixed

    share(0, 125)
    share(1, 64)
    bv[2] = av[2]                                  # identical full rows
    share(5, 1)
    share(9, 50)
    share(11, 64)
    share(13, 60)
    av[6, 3999] = 65537                            # off contract
    bv[6, 2000:] = 65537
    av[14, :40] = rng.integers(0, 1 << 16, 40)    # unsorted, repeats
    av[14, 20:30] = av[14, 0]
    bv[14, :40] = np.sort(av[14, :40])
    return av, ac, bv, bc


def _section4_calls(t):
    """(kernel name, case label, plain call, kernel call, library call or
    None): bitset_op and bitset_op_card for each op, array_intersect."""
    from repro_torch.kernels import array_ops, bitset_ops, ref
    a, b = t["a"], t["b"]
    arr = (t["av"], t["ac"], t["bv"], t["bc"])
    pos = torch.arange(4096, device=a.device)
    pa = torch.where(pos < t["ac"][:, None], t["av"], 65536)
    pb = torch.where(pos < t["bc"][:, None], t["bv"], 65537)
    out = []
    for op in PAIR_OPS:
        # no PyTorch call computes a popcount: no library yardstick
        out += [("bitset_op", f"bitset_op/{op}",
                 lambda op=op: ref.bitset_op(a, b, op),
                 lambda op=op: bitset_ops.bitset_op(a, b, op), None),
                ("bitset_op_card", f"bitset_op_card/{op}",
                 lambda op=op: ref.bitset_op_card(a, b, op),
                 lambda op=op: bitset_ops.bitset_op_card(a, b, op), None)]
    out.append(("array_intersect", "array_intersect",
                lambda: ref.array_intersect_mask(*arr),
                lambda: array_ops.array_intersect(*arr),
                lambda: _searchsorted_hits(pb, pa)))
    return out


def phase_section4_kernels(dev, seed, failures):
    """The fused bitset op and count (every op) and the A-side array
    intersection against their plain versions, on phase 2c's inputs at M
    = 256 and 8,192 and at :func:`_section4_edges`."""
    return phase_pair_kernels(dev, seed, failures, calls=_section4_calls,
                              names=SECTION4_KERNELS, edges=_section4_edges,
                              counts=_section4_counts,
                              edge_rows=(0, 1, 8, 16))


# ---------------------------------------------------------------------------
# phase 2d: the conversion kernels and the popcount against their plain
# versions
# ---------------------------------------------------------------------------

def _path_arrays(dev, gen, m, slots=160):
    """Array rows as ``to_words`` hands them to array_to_bitset at the
    index's 0.1% density: about 64 sorted distinct values a row (random
    gaps below 2,048), the tail padded with 65,535 as the slab is; old
    words random, with some all-ones and all-zero rows."""
    gaps = torch.randint(1, 2048, (m, slots), dtype=torch.int32, device=dev,
                         generator=gen)
    v = torch.cumsum(gaps, dim=1, dtype=torch.int32) - 1
    card = (v < 65536).sum(dim=1, dtype=torch.int32)
    vals = torch.full((m, 4096), 65535, dtype=torch.int32, device=dev)
    vals[:, :slots] = torch.where(v < 65536, v, 65535)
    old = torch.randint(-2**31, 2**31, (m, 2048), dtype=torch.int32,
                        device=dev, generator=gen)
    old[::97] = -1
    old[1::97] = 0
    return dict(vals=vals, card=card, old=old)


def _convert_edges(m, seed):
    """Edge rows: cards -1, 0, 1, 4,096 and 5,000 among sparse ones,
    garbage values past each card, the values 0, 65,535, 65,536 and -1,
    duplicates, values far outside [0, 65535]; all-zero and all-ones old
    words."""
    rng = np.random.default_rng(seed)
    card = rng.integers(1, 130, m).astype(np.int32)
    card[:5] = np.array([-1, 0, 1, 4096, 5000])[:m]
    vals = rng.integers(-2**31, 2**31, (m, 4096),
                        dtype=np.int64).astype(np.int32)
    for r in range(m):
        c = min(max(int(card[r]), 0), 4096)
        vals[r, :c] = np.sort(rng.choice(65536, c, replace=False))
    if m >= 8:
        vals[5, :4] = [0, 65535, 65536, -1]
        vals[6, :6] = [3, 3, 31, 31, 64, 64]
        vals[7, :5] = [-33, 70000, 2**31 - 1, -2**31, 9]
        card[5:8] = [4, 6, 5]
    old = rng.integers(0, 1 << 32, (m, 2048), dtype=np.uint32)
    old[::3] = 0
    old[1::3] = 0xFFFFFFFF
    return dict(vals=vals, card=card, old=old)


def _scatter_args(vals, card):
    """The masked values as one ``scatter_add_`` takes them: flat int64
    word indices and bit weights (made outside the timing)."""
    pos = torch.arange(4096, device=vals.device)
    valid = (pos[None, :] < card[:, None]) & (vals >= 0) & (vals < 65536)
    r, c = valid.nonzero(as_tuple=True)
    v = vals[r, c].to(torch.int64)
    return r * 2048 + (v >> 5), torch.ones_like(v) << (v & 31)


def _convert_calls(x):
    """(name, plain call, kernel call, library call or None) per kernel.
    array_to_bitset's library call is one ``scatter_add_`` of the masked
    values into zeroed int64 words; no PyTorch call computes a popcount,
    so bitset_set_many and popcount have none."""
    from repro_torch.kernels import bitset_convert as bc
    from repro_torch.kernels import harley_seal as hs
    from repro_torch.kernels import ref
    v, c, o = x["vals"], x["card"], x["old"]
    m = v.shape[0]
    idx, src = _scatter_args(v, c)

    def library():
        return torch.zeros(m * 2048, dtype=torch.int64,
                           device=v.device).scatter_add_(0, idx, src)
    return [
        ("array_to_bitset", lambda: ref.array_to_bitset(v, c),
         lambda: bc.array_to_bitset(v, c), library),
        ("bitset_set_many", lambda: ref.bitset_set_many(o, v, c),
         lambda: bc.bitset_set_many(o, v, c), None),
        ("popcount", lambda: ref.popcount_words(o),
         lambda: hs.popcount(o), None),
    ]


def _convert_bound(name, x):
    """Least time, in ms, and what bounds it.  Bytes: the card, the values
    below it (4 bytes each), the old words (8 KiB a row) for
    bitset_set_many and popcount, the words written (8 KiB a row) and
    the delta or count (4 bytes).  Operations: a shift, mask and add per
    valid value; an OR, XOR and popcount per word for bitset_set_many;
    a popcount and an add per word for popcount."""
    m = x["vals"].shape[0]
    n_vals = int(x["card"].to(torch.int64).clamp(0, 4096).sum())
    if name == "array_to_bitset":
        nbytes, ops = 4 * m + 4 * n_vals + 8192 * m, 3 * n_vals
    elif name == "bitset_set_many":
        nbytes = 4 * m + 4 * n_vals + 2 * 8192 * m + 4 * m
        ops = 3 * n_vals + 3 * 2048 * m
    else:
        nbytes, ops = 8192 * m + 4 * m, 2 * 2048 * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_convert_kernels(dev, seed, failures):
    """The conversion kernels and the popcount against their plain
    versions at the path's shapes (M = 245,760 and 8,192) and at edge
    cases (M = 0, 1 and 16).  Words, deltas and counts must be bit-equal;
    kernel, plain and library times are device times from the profiler,
    with CUDA-event times beside them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    cases, max_err = [], {name: 0 for name in CONVERT_KERNELS}
    for kind, m in [("main", CONVERT_M), ("main", 8192), ("edge", 0),
                    ("edge", 1), ("edge", 16)]:
        x = (_path_arrays(dev, gen, m) if kind == "main" else
             _to_card(_convert_edges(m, seed + m), dev))
        for name, plain, kern, lib in _convert_calls(x):
            want, got = plain(), kern()
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            for g, w in zip(got, want):
                if g.numel():
                    max_err[name] = max(max_err[name], int(
                        (g.to(torch.int64) - w).abs().max()))
            case = f"{kind}/M={m}/{name}"
            if not same:
                failures.append(f"kernel != plain: {case}")
            row = dict(case=case, kernel=name, rows=m, equal=same)
            if kind != "edge":
                if lib is not None:
                    lib_words = (lib() & 0xFFFFFFFF).to(torch.int32)
                    if not torch.equal(lib_words.view(m, 2048), got[0]):
                        failures.append(f"scatter_add_ yardstick != kernel: "
                                        f"{case}")
                    del lib_words
                bound_ms, bound_by = _convert_bound(name, x)
                row.update(
                    ms=_device_ms(kern, 20),
                    plain_ms=_device_ms(plain, 3),
                    library_ms=_device_ms(lib, 10) if lib else None,
                    event_ms=_time_ms(kern, 20)[1],
                    event_plain_ms=_time_ms(plain, 3)[1],
                    bound_ms=bound_ms, bound_by=bound_by,
                    mean_card=float(x["card"].to(torch.float64).mean()))
                lib_txt = (f"{row['library_ms']:.4f}" if lib else
                           "null (no PyTorch call)")
                log(f"  {case:34s} equal={same} device: kernel "
                    f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                    f"library {lib_txt}; events: kernel "
                    f"{row['event_ms']:.4f} ms; bound {bound_ms:.4f} ms "
                    f"({bound_by})")
            cases.append(row)
            del want, got
        del x
        torch.cuda.empty_cache()
    edges = [c for c in cases if c["case"].startswith("edge")]
    log(f"  {len(edges)} edge cases: {sum(c['equal'] for c in edges)} "
        f"equal; launches so far {_convert_counts()}")
    return cases, max_err


def _convert_counts() -> dict:
    """Launches of each conversion and popcount kernel since the last
    reset."""
    from repro_torch.kernels import bitset_convert, harley_seal
    return {**bitset_convert.launches_by_kernel,
            **harley_seal.launches_by_kernel}


# ---------------------------------------------------------------------------
# phase 2f: the sharded similarity kernels (score over ids, labelled
# select) against their plain versions
# ---------------------------------------------------------------------------

IDS_STAGES = ("score_ids", "select_ids")


def _bsa_count() -> int:
    """Launches of the decode attention kernel since the last reset."""
    from repro_torch.kernels import block_sparse_attn
    return block_sparse_attn.launches


def _ids_counts() -> dict:
    """Launches of the two sharded similarity kernels since the last
    reset."""
    from repro_torch.kernels import topk_ops
    return {s: topk_ops.launches_by_stage[s] for s in IDS_STAGES}


def _ids_layout(x, dev, gen):
    """Phase 2b's candidates in an arena-like table: the 227,240 rows at
    random positions of a table whose last row is all zero, read through
    positions (``perm``)."""
    n = x["rows"].shape[0]
    perm = torch.randperm(n, device=dev, generator=gen)
    table = torch.zeros((n + 1, 2048), dtype=torch.int32, device=dev)
    table[perm] = x["rows"]
    return table, perm.to(torch.int32)


def _shard_inputs(x, perm, s_count, shard, zero_row):
    """Shard ``shard`` of ``s_count`` in the engine's layout: candidates t
    with t % S == shard in ascending order, padded to the largest shard's
    slot count L with slots of id T, card 0 and ONE row that reads the
    table's all-zero row (so the -2.0 of a pad slot is what a zero row
    would otherwise score).  Returns the wrapper's arguments after the
    table and the query, and (n_valid, L)."""
    dev = x["rows"].device
    t = len(x["lens"])
    cands = np.arange(shard, t, s_count)
    slots = -(-t // s_count)
    starts_all = x["starts"].cpu().numpy().astype(np.int64)
    lens = x["lens"][cands].astype(np.int64)
    n_pad = slots - cands.size
    offs = np.repeat(np.cumsum(lens) - lens, lens)
    ridx = np.arange(int(lens.sum())) - offs + np.repeat(starts_all[cands],
                                                         lens)
    ridx_t = torch.from_numpy(ridx).to(dev)
    pos = torch.cat([perm[ridx_t], torch.full((n_pad,), zero_row,
                                               dtype=torch.int32,
                                               device=dev)])
    col = torch.cat([x["row_col"][ridx_t],
                     torch.zeros(n_pad, dtype=torch.int32, device=dev)])
    starts = np.concatenate(([0], np.cumsum(np.concatenate(
        [lens, np.ones(n_pad, np.int64)]))))
    gidx = np.concatenate([cands, np.full(n_pad, t)])
    cards = torch.cat([x["cards"][torch.from_numpy(cands).to(dev)],
                       torch.zeros(n_pad, dtype=torch.int32, device=dev)])
    return (pos, col, torch.from_numpy(starts.astype(np.int32)).to(dev),
            cards, torch.from_numpy(gidx.astype(np.int32)).to(dev)), \
        (int(cands.size), slots)


def _ids_select_bound(m, k):
    """Least time of the labelled select: its 12 bytes an entry read once
    and 12 a result written, over the HBM rate.  The work an algorithm
    chooses (k rounds, or a sort) is not the function's, so no operations
    count here."""
    return (12 * m + 12 * k) / HBM_BYTES_PER_S * 1e3, "bytes"


def _ids_edge_cases(dev, seed):
    """(name, score, inter, gidx, k) on the card: the exhaustion rounds
    (the lowest id in a group taken earlier among them), every entry
    equal, one id on every entry, -1.0 excluded entries, only -2.0
    padding, k past the entry count, and lists past the 1,024 entries one
    block sorts (5,000 and 65,536: a shard of many slots) at k from 1 past
    512, where the kernel changes plan."""
    rng = np.random.default_rng(seed + 41)

    def t(x, dt):
        return torch.tensor(np.asarray(x), dtype=dt, device=dev)

    def case(name, score, inter, gidx, k):
        return (name, t(score, torch.float32), t(inter, torch.int32),
                t(gidx, torch.int32), k)

    out = [case("exhaustion", [.5, .9, -2, .9, -1, .5], [5, 9, 77, 3, 1, 6],
                [40, 7, 2, 7, 9, 3], 8),
           case("exhaustion/lowest id taken", [.9, -2, .3, -2],
                [4, 50, 8, 60], [1, 5, 3, 1], 5),
           # -0.0 and +0.0 tie, the lower id first; a round at zero is
           # +0.0 while an entry of +0.0 remains, as jnp.max gives it
           case("signed zeros", [-0.0, 0.0, 0.5], [10, 11, 12], [0, 1, 2], 3),
           case("signed zeros/+0 first", [0.0, -0.0], [1, 2], [5, 7], 2),
           case("signed zeros/-0 first", [0.0, -0.0], [1, 2], [7, 5], 2),
           case("signed zeros/all -0", [-0.0, -0.0, -0.0], [1, 2, 3],
                [4, 2, 4], 4)]
    m = 40
    base = ((rng.integers(0, 4, m) / 4).astype(np.float32),
            rng.integers(0, 30, m), rng.integers(0, 12, m))
    for name in ("all equal", "one id", "excluded", "all padding"):
        sc, it, gi = (x.copy() for x in base)
        if name == "all equal":
            sc[:], it[:], gi[:] = 0.5, 7, 3
        elif name == "one id":
            gi[:] = 4
        elif name == "excluded":
            sc[::3] = -1.0
        else:
            sc[:] = -2.0
        for k in (1, 10, m + 7):
            out.append(case(f"{name}/k={k}", sc, it, gi, k))
    for n in (5000, 65536):
        sc = (rng.integers(-8, 40, n) / 32).astype(np.float32)
        sc = np.where(sc < -0.125, np.float32(-2.0),
                      np.where(sc < 0, np.float32(-1.0), sc))
        it = rng.integers(0, 1 << 20, n)
        gi = rng.integers(0, n // 2, n)
        for k in (1, 10, 100, 512, 513) + ((n + 7,) if n < 10_000 else ()):
            out.append(case(f"n={n}/k={k}", sc, it, gi, k))
    return out


def _score_ids_bound(x, n_rows, slots):
    nbytes = (n_rows * 8192 + x["q"].shape[0] * 8192 + 8 * n_rows
              + 4 * (slots + 1) + 8 * slots + 8 * slots)
    ops = n_rows * 2048 * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_ids_kernels(dev, seed, failures):
    """The score-over-ids and labelled-select kernels against their plain
    versions, bit-equal: phase 2b's 1,024 candidates (227,240 rows, ties
    among candidates 9-19) split over S in {1, 3, 4} shards as the engine
    splits them, every metric, a tie query whose group of 11 straddles
    the shards at k = 10, a zero query cardinality, every shard's pad
    slots reading an all-zero row, exclusion of an id on each shard, and
    k in {1, 10, 100, L + 7} (L + 7 past every shard's valid count).  The
    merged lists must also equal the single-device score and select of
    all candidates.  Then the select's edge cases (``_ids_edge_cases``:
    the exhaustion rounds, degenerate lists, lists of 5,000 and 65,536
    entries, k past n), bit-equal.  Times: the score over all 1,024
    slots, and the select over one shard's list (S = 4, L = 256), over
    the merged S * k = 40 and 400 entries, and over 5,000 and 65,536
    entries at k = 10."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_ops as tk
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    x = _topk_inputs(dev, seed + 10)
    t = len(x["lens"])
    table, perm = _ids_layout(x, dev, gen)
    zero_row = table.shape[0] - 1
    single = (x["rows"], x["row_col"], x["starts"])
    s9, e9 = int(x["starts"][9]), int(x["starts"][10])
    q_tie = torch.zeros_like(x["q"])
    q_tie[x["row_col"][s9:e9].long()] = x["rows"][s9:e9]
    variants = [("main", x["q"], x["q_card"]),
                ("ties", q_tie, int(x["cards"][9])),
                ("q_card0", torch.zeros_like(x["q"]), 0)]
    cases, max_err = [], 0.0
    single_cache = {}

    def check(case, got, want):
        nonlocal max_err
        same = _bits_equal(got, want)
        max_err = max(max_err, _err(got, want))
        if not same:
            failures.append(f"kernel != plain: {case}")
        return same

    for s_count in (1, 3, 4):
        shard_args = [_shard_inputs(x, perm, s_count, s, zero_row)
                      for s in range(s_count)]
        slots = shard_args[0][1][1]
        for vname, q, qc in variants:
            for metric in METRICS:
                excludes = [-1] + (list(range(s_count))
                                   if vname == "main" else [])
                for exclude in excludes:
                    key = (vname, metric, exclude)
                    if key not in single_cache:
                        single_cache[key] = ref.similarity_score(
                            *single, q, qc, x["cards"], exclude,
                            metric=metric)
                    sc_all, in_all = single_cache[key]
                    per = []
                    for s, (args, (n_valid, _)) in enumerate(shard_args):
                        pos, col, starts, cards, gidx = args
                        call = (table, pos, col, starts, q, qc, cards, gidx,
                                n_valid, exclude)
                        want = ref.similarity_score_ids(*call,
                                                        metric=metric)
                        got = tk.similarity_score_ids(*call, metric=metric)
                        case = (f"score_ids/S={s_count}/{vname}/{metric}/"
                                f"exclude={exclude}/shard={s}")
                        cases.append(dict(case=case,
                                          equal=check(case, got, want)))
                        per.append((got, gidx, n_valid))
                    ks = (1, 10, 100, slots + 7) if exclude == -1 and \
                        vname == "main" else (10,)
                    for k in ks:
                        lists = []
                        for s, ((score, inter), gidx, n_valid) in \
                                enumerate(per):
                            want = ref.topk_select_ids(score, inter, gidx,
                                                       k)
                            got = tk.topk_merge(score, inter, gidx, k)
                            case = (f"select_ids/S={s_count}/{vname}/"
                                    f"{metric}/exclude={exclude}/k={k}/"
                                    f"shard={s}")
                            cases.append(dict(case=case,
                                              equal=check(case, got, want)))
                            lists.append(got)
                        merged = [torch.cat(p) for p in zip(*lists)]
                        want = ref.topk_select_ids(merged[1], merged[2],
                                                   merged[0], k)
                        got = tk.topk_merge(merged[1], merged[2], merged[0],
                                            k)
                        case = (f"merge/S={s_count}/{vname}/{metric}/"
                                f"exclude={exclude}/k={k}")
                        same = check(case, got, want)
                        kk = min(k, t - (exclude >= 0))
                        one = ref.topk_select(sc_all, in_all, kk)
                        if not _bits_equal([g[:kk] for g in got], one):
                            same = False
                            failures.append(f"sharded != single-device: "
                                            f"{case}")
                        cases.append(dict(case=case, equal=same))
                        if vname == "ties" and k == 10 and \
                                got[0].tolist() != list(range(9, 19)):
                            failures.append(f"tie group not cut at the "
                                            f"lowest ids: {case}")
    # the select's edge cases, and lists past one block of the kernel
    for name, sc, it, gi, k in _ids_edge_cases(dev, seed):
        case = f"select_ids/edge/{name}"
        want = ref.topk_select_ids(sc, it, gi, k)
        cases.append(dict(case=case, equal=check(
            case, tk.topk_merge(sc, it, gi, k), want)))
        if name in ("n=5000/k=10", "n=65536/k=10"):
            ms = _device_ms(lambda: tk.topk_merge(sc, it, gi, k), 50)
            order = torch.argsort(gi, stable=True)
            sc_o = sc[order]
            lib_ms = _device_ms(lambda: torch.sort(
                sc_o, descending=True, stable=True).indices[:k], 50)
            cases[-1].update(ms=ms, library_ms=lib_ms)
            log(f"  {case:40s} equal={cases[-1]['equal']} device: kernel "
                f"{ms:.4f} ms  torch.sort {lib_ms:.4f} ms")
    # times: the score over all 1,024 slots (one shard of everything)
    args, _ = _shard_inputs(x, perm, 1, 0, zero_row)
    pos, col, starts, cards, gidx = args
    call = (table, pos, col, starts, x["q"], x["q_card"], cards, gidx, t,
            -1)
    want, plain_ms = _time_ms(lambda: ref.similarity_score_ids(
        *call, metric="jaccard"), 3)
    got, ms = _time_ms(lambda: tk.similarity_score_ids(
        *call, metric="jaccard"), 20)
    bound_ms, bound_by = _score_ids_bound(x, int(pos.shape[0]), t)
    main = dict(case="score_ids/main/jaccard", equal=check(
        "score_ids/main/jaccard", got, want), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    cases.append(main)
    log(f"  {main['case']:40s} equal={main['equal']} kernel {ms:.4f} ms  "
        f"plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    # the select: one shard's list (S = 4), the merged S * k entries
    shard_args = [_shard_inputs(x, perm, 4, s, zero_row) for s in range(4)]
    scored = []
    for (pos, col, starts, cards, gidx), (n_valid, _) in shard_args:
        sc, it = tk.similarity_score_ids(table, pos, col, starts, x["q"],
                                         x["q_card"], cards, gidx, n_valid,
                                         metric="jaccard")
        scored.append((sc, it, gidx))
    timed = [("select_ids/shard/L=256/k=10", scored[0], 10)]
    for k in (10, 100):
        lists = [tk.topk_merge(sc, it, g, k) for sc, it, g in scored]
        gi, sc, it = (torch.cat(p) for p in zip(*lists))
        timed.append((f"select_ids/merge/M={4 * k}/k={k}", (sc, it, gi), k))
    for name, (sc, it, gi), k in timed:
        want = ref.topk_select_ids(sc, it, gi, k)
        got = tk.topk_merge(sc, it, gi, k)
        # the library yardstick: a stable sort by score of entries already
        # in ascending id order gives the same top k
        order = torch.argsort(gi, stable=True)
        sc_o = sc[order]
        lib = torch.sort(sc_o, descending=True, stable=True).indices[:k]
        same = check(name, got, want) and torch.equal(
            got[0].long(), gi[order][lib].long())
        dev_ms = _device_ms(lambda: tk.topk_merge(sc, it, gi, k), 50)
        dev_plain = _device_ms(lambda: ref.topk_select_ids(sc, it, gi, k),
                               3)
        dev_lib = _device_ms(lambda: torch.sort(
            sc_o, descending=True, stable=True).indices[:k], 50)
        bound_ms, bound_by = _ids_select_bound(int(sc.shape[0]), k)
        cases.append(dict(case=name, equal=same, ms=dev_ms,
                          plain_ms=dev_plain, library_ms=dev_lib,
                          bound_ms=bound_ms, bound_by=bound_by))
        log(f"  {name:40s} equal={same} device: kernel {dev_ms:.4f} ms  "
            f"plain {dev_plain:.3f} ms  torch.sort {dev_lib:.4f} ms; bound "
            f"{bound_ms:.6f} ms ({bound_by})")
    log(f"  {len(cases)} cases, {sum(c['equal'] for c in cases)} equal; "
        f"launches so far {_ids_counts()}")
    del x, table, perm, single_cache, scored
    torch.cuda.empty_cache()
    return cases, max_err


# ---------------------------------------------------------------------------
# phase 3: the main path at real scale
# ---------------------------------------------------------------------------

def _dense_words(dev, gen, p):
    """(N_DOCS / 64,) uint64 words of independent random bits of density
    ``p``, drawn on the card."""
    bits = torch.rand(N_DOCS, device=dev, generator=gen) < p
    shifted = bits.view(-1, 64).to(torch.int64) << torch.arange(64,
                                                                device=dev)
    return shifted.sum(dim=1).cpu().numpy().view(np.uint64)


def _packed(values, n_words=N_DOCS // 64):
    words = np.zeros(n_words, np.uint64)
    np.bitwise_or.at(words, values >> 6,
                     np.uint64(1) << (values & 63).astype(np.uint64))
    return words


def _to_packed(bm):
    """A result bitmap as (N_DOCS / 64,) uint64 words."""
    from repro_torch.core import containers as C
    out = np.zeros((N_DOCS >> 16, 1024), np.uint64)
    for k, c in zip(bm.keys, bm.containers):
        out[k] = C.container_words64(c)
    return out.reshape(-1)


def build_corpus(dev, seed):
    """Postings and oracle sets: 64 dense terms (densities log-uniform in
    [8%, 50%], random bits, so bitset containers in every chunk) and 960
    sparse terms (about 0.1%: array containers)."""
    from repro_torch import convert
    from repro_torch.core import RoaringBitmap
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    postings, sets, df = {}, {}, {}
    for i in range(N_DENSE):
        p = float(np.exp(rng.uniform(np.log(0.08), np.log(0.5))))
        w = _dense_words(dev, gen, p)
        chunks = w.reshape(-1, 1024)
        cards = np.bitwise_count(chunks).sum(axis=1)
        keys = [k for k in range(chunks.shape[0]) if cards[k]]
        bm = convert.bitmap_from_parts(
            keys, ["bitset"] * len(keys), [chunks[k] for k in keys])
        t = f"d{i}"
        postings[t], sets[t], df[t] = bm, w, int(cards.sum())
    for i in range(N_SPARSE):
        p = float(np.exp(rng.uniform(np.log(0.0007), np.log(0.0014))))
        vals = np.unique(rng.integers(0, N_DOCS, int(p * N_DOCS),
                                      dtype=np.uint32))
        t = f"s{i}"
        postings[t] = RoaringBitmap.from_values(vals)
        sets[t], df[t] = vals, int(vals.size)
    return postings, sets, df


def make_traffic(seed, df):
    """64 queries per class, K in [2, 8], terms drawn within a tier in
    proportion to their document frequency.  AND filters on dense terms
    only; OR, XOR and threshold mix the tiers half and half; ANDNOT keeps
    a dense term and drops mixed ones."""
    rng = np.random.default_rng(seed + 2)
    tiers = {}
    for tier in ("d", "s"):
        names = [t for t in df if t[0] == tier]
        w = np.asarray([df[t] for t in names], np.float64)
        tiers[tier] = (names, w / w.sum())

    def draw(tier, n, exclude=()):
        names, p = tiers[tier]
        out = []
        while len(out) < n:
            t = str(rng.choice(names, p=p))
            if t not in out and t not in exclude:
                out.append(t)
        return out

    def mixed(k, exclude=()):
        return draw("d", (k + 1) // 2, exclude) + draw("s", k // 2, exclude)

    traffic = {c: [] for c in CLASSES}
    for _ in range(QUERIES):
        k = int(rng.integers(2, 9))
        traffic["and"].append(dict(terms=draw("d", k)))
        traffic["or"].append(dict(terms=mixed(k)))
        traffic["xor"].append(dict(terms=mixed(k)))
        keep = draw("d", 1)
        traffic["andnot"].append(dict(terms=keep + mixed(k - 1, keep)))
        traffic["threshold"].append(dict(terms=mixed(k),
                                         t=int(rng.integers(2, k + 1))))
        w = [int(x) for x in rng.integers(1, 5, k)]
        traffic["threshold_w"].append(dict(
            terms=mixed(k), weights=w, t=int(rng.integers(2, sum(w) + 1))))
    return traffic


class Oracle:
    """Independent numpy answers from packed document sets (2^24 bits, or
    ``n_words`` 64-bit words)."""

    def __init__(self, sets, n_words=N_DOCS // 64):
        self._src = sets
        self._n_words = n_words
        self._packed = {}

    def words(self, term):
        w = self._packed.get(term)
        if w is None:
            src = self._src[term]
            w = src if src.dtype == np.uint64 else \
                _packed(src, self._n_words)
            self._packed[term] = w
        return w

    def answer(self, cls, q):
        ws = [self.words(t) for t in q["terms"]]
        if cls == "and":
            return np.bitwise_and.reduce(ws)
        if cls == "or":
            return np.bitwise_or.reduce(ws)
        if cls == "xor":
            return np.bitwise_xor.reduce(ws)
        if cls == "andnot":
            return ws[0] & ~np.bitwise_or.reduce(ws[1:])
        cnt = np.zeros(ws[0].size * 64, np.uint8)
        for w, wt in zip(ws, q.get("weights") or [1] * len(ws)):
            cnt += np.unpackbits(w.view(np.uint8), bitorder="little") * \
                np.uint8(wt)
        return np.packbits(cnt >= q["t"], bitorder="little").view(np.uint64)


def _run_query(index, cls, q):
    terms = q["terms"]
    if cls == "and":
        return index.query_and(*terms)
    if cls == "or":
        return index.query_or(*terms)
    if cls == "xor":
        return index.query_xor(*terms)
    if cls == "andnot":
        return index.query_andnot(terms[0], *terms[1:])
    return index.query_threshold(terms, q["t"], weights=q.get("weights"))


def _plan(index, cls, q):
    from repro_torch.core import aggregate
    bms = [index._get(t) for t in q["terms"]]
    op = {"threshold_w": "threshold"}.get(cls, cls)
    return aggregate.plan_wide(op, bms, q.get("t", 0), q.get("weights"),
                               arena=index.arena)


def phase_main_path(dev, seed, failures):
    from repro_torch.core import BitmapArena, RoaringBitmap, aggregate
    from repro_torch.data.index import InvertedIndex
    from repro_torch.kernels import segment_ops as so

    t0 = time.perf_counter()
    postings, sets, df = build_corpus(dev, seed)
    n_conts = sum(len(b.containers) for b in postings.values())
    kinds = {}
    for b in postings.values():
        for c in b.containers:
            kinds[c.kind] = kinds.get(c.kind, 0) + 1
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    arena = BitmapArena(capacity=n_conts + 1, device=dev)
    index = InvertedIndex.from_postings(postings, N_DOCS, arena=arena)
    arena.sync()
    t_index = time.perf_counter() - t0
    slab = arena.device_slab()
    info = dict(documents=N_DOCS, terms=len(postings), containers=n_conts,
                kinds=kinds, arena_rows=arena.n_rows,
                arena_bytes=slab.numel() * 4,
                max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                corpus_s=t_gen, index_s=t_index)
    log(f"  corpus {t_gen:.1f} s; index + arena upload {t_index:.1f} s: "
        f"{n_conts} containers {kinds}, arena {info['arena_bytes']} bytes, "
        f"max_memory_allocated {info['max_memory_allocated']}")
    traffic = make_traffic(seed, df)
    oracle = Oracle(sets)
    answers = {c: [oracle.answer(c, q) for q in qs]
               for c, qs in traffic.items()}

    _reset_counts()                         # the boolean path starts here
    up0 = arena.stats.rows_uploaded
    classes = {}
    for cls in CLASSES:
        lat, launched, wrong = [], 0, 0
        for q, want in zip(traffic[cls], answers[cls]):
            n0 = so.launches
            t = time.perf_counter()
            got = _run_query(index, cls, q)
            torch.cuda.synchronize(dev)
            lat.append((time.perf_counter() - t) * 1e3)
            launched += so.launches > n0
            wrong += not np.array_equal(_to_packed(got), want)
        n0 = so.launches
        t = time.perf_counter()
        plans = [_plan(index, cls, q) for q in traffic[cls]]
        outs = aggregate.execute_plans(plans)
        torch.cuda.synchronize(dev)
        coalesced_ms = (time.perf_counter() - t) * 1e3
        coalesced_launches = so.launches - n0
        wrong_c = sum(not np.array_equal(_to_packed(g), w)
                      for g, w in zip(outs, answers[cls]))
        # device busy share over a window of single queries
        tr = _traced(cls, lambda: [_run_query(index, cls, q)
                                   for q in traffic[cls][:16]], dev,
                     SEGMENT_KERNELS)
        busy_us, kern_us, wall_us = (tr["busy_us"], tr["kernel_us"],
                                     tr["wall_us"])
        idle = tr["idle_share"]
        classes[cls] = dict(
            queries=len(lat), p50_ms=float(np.percentile(lat, 50)),
            p99_ms=float(np.percentile(lat, 99)), launched=launched,
            wrong=wrong, coalesced_ms=coalesced_ms,
            coalesced_launches=coalesced_launches, coalesced_wrong=wrong_c,
            profiled_queries=16, device_busy_us=busy_us,
            kernel_us=kern_us, wall_us=wall_us, idle_share=idle)
        log(f"  {cls:12s} p50 {classes[cls]['p50_ms']:.2f} ms  p99 "
            f"{classes[cls]['p99_ms']:.2f} ms  launched {launched}/"
            f"{len(lat)}  wrong {wrong}  coalesced {coalesced_ms:.1f} ms "
            f"({coalesced_launches} launches, wrong {wrong_c})  idle "
            + (f"{idle:.4f}" if idle is not None else "not measured")
            + f"  kernel {kern_us / 16:.1f} us/query")
        if wrong or wrong_c:
            failures.append(f"{cls}: {wrong} single and {wrong_c} "
                            f"coalesced answers differ from the oracle")
        if launched * 2 < len(lat):
            failures.append(f"{cls}: kernel launched on only {launched} "
                            f"of {len(lat)} queries")
    if arena.stats.rows_uploaded != up0:
        failures.append("warm queries uploaded container rows")

    # the other two front ends of the same planner: cold rows staged next
    # to the resident slab (dual), and no arena at all (slab)
    rng = np.random.default_rng(seed + 3)
    fronts = {}
    for name in ("dual", "slab"):
        wrong = 0
        n0 = dict(so.launches_by_source)
        for i in range(8):
            q = traffic["or"][i]
            bms = [index._get(t) for t in q["terms"]]
            want = answers["or"][i]
            if name == "dual":
                vals = np.unique(rng.integers(0, N_DOCS, 200_000,
                                              dtype=np.uint32))
                bms.append(RoaringBitmap.from_values(vals))
                want = want | _packed(vals)
                got = aggregate.or_many(bms, arena=arena)
            else:
                got = aggregate.threshold_many(bms, 2, device=dev)
                want = oracle.answer("threshold", dict(terms=q["terms"],
                                                       t=2))
            wrong += not np.array_equal(_to_packed(got), want)
        used = so.launches_by_source[name] - n0[name]
        fronts[name] = dict(queries=8, launches=used, wrong=wrong)
        log(f"  front end {name}: {used} launches over 8 queries, "
            f"wrong {wrong}")
        if wrong or used == 0:
            failures.append(f"front end {name}: {wrong} wrong, "
                            f"{used} launches")
    launches = so.launches                  # the boolean path ends here
    by_source = dict(so.launches_by_source)
    info.update(classes=classes, fronts=fronts, launches=launches,
                launches_by_source=by_source)
    return info, dict(index=index, postings=postings, sets=sets,
                      traffic=traffic, answers=answers)


# ---------------------------------------------------------------------------
# phase 4: similarity on the main path
# ---------------------------------------------------------------------------

def _scores_f32(inter, q_card, cards, metric):
    """The metric in float32, one rounding per step: (qc + oc) - inter,
    sqrt(qc * oc), or qc; a zero denominator scores 1.0."""
    fi = np.asarray(inter).astype(np.float32)
    qc = np.float32(q_card)
    oc = np.asarray(cards).astype(np.float32)
    if metric == "jaccard":
        denom = (qc + oc) - fi
    elif metric == "cosine":
        denom = np.sqrt(qc * oc)
    else:
        denom = np.full_like(oc, qc)
    return np.divide(fi, denom, out=np.ones_like(fi), where=denom > 0)


class SimOracle:
    """Independent numpy top-k over packed document sets: intersections by
    popcount of the packed AND (a sparse term's set is its values, so its
    AND with the query is the count of its values whose bit the query
    has), float32 scores and a stable argsort."""

    def __init__(self, terms, sets, n_words):
        self.terms = list(terms)
        self.n_words = n_words
        dense = [i for i, t in enumerate(self.terms)
                 if sets[t].dtype == np.uint64]
        self.dense_idx = np.asarray(dense, np.int64)
        self.dense = np.stack([sets[self.terms[i]][:n_words]
                               for i in dense])
        vals, owner = [], []
        for i, t in enumerate(self.terms):
            if sets[t].dtype != np.uint64:
                v = sets[t][sets[t] < n_words * 64]
                vals.append(v)
                owner.append(np.full(v.size, i, np.int32))
        self.vals = np.concatenate(vals)
        self.owner = np.concatenate(owner)
        self.sets = sets
        self.cards = np.zeros(len(self.terms), np.int64)
        self.cards[self.dense_idx] = np.bitwise_count(self.dense).sum(axis=1)
        self.cards += np.bincount(self.owner, minlength=len(self.terms))

    def words(self, term):
        s = self.sets.get(term)
        if s is None:
            return np.zeros(self.n_words, np.uint64)
        if s.dtype == np.uint64:
            return s[: self.n_words]
        w = np.zeros(self.n_words, np.uint64)
        v = s[s < self.n_words * 64]
        np.bitwise_or.at(w, v >> 6, np.uint64(1) << (v & 63).astype(
            np.uint64))
        return w

    def inter(self, qw):
        out = np.zeros(len(self.terms), np.int64)
        out[self.dense_idx] = np.bitwise_count(self.dense & qw).sum(axis=1)
        bit = (qw[self.vals >> 6] >> (self.vals & 63).astype(np.uint64)) \
            & np.uint64(1)
        out += np.bincount(self.owner, weights=bit,
                           minlength=len(self.terms)).astype(np.int64)
        return out

    def topk(self, term, k, metric, inter=None):
        qw = self.words(term)
        qc = int(np.bitwise_count(qw).sum())
        if inter is None:
            inter = self.inter(qw)
        score = _scores_f32(inter, qc, self.cards, metric)
        n = len(self.terms)
        if term in self.sets:
            score[self.terms.index(term)] = np.float32(-1.0)
            n -= 1
        order = np.argsort(-score, kind="stable")[: min(k, n)]
        return [(self.terms[i], float(score[i])) for i in order.tolist()]


def _same_sim(got, want):
    return [t for t, _ in got] == [t for t, _ in want] and \
        np.float32([s for _, s in got]).tobytes() == \
        np.float32([s for _, s in want]).tobytes()


def sim_traffic(seed, terms):
    """64 member terms (16 dense, 48 sparse) for k = 10, 16 more (8 and 8)
    for k = 100, and 4 unknown terms, each under all three metrics."""
    rng = np.random.default_rng(seed + 4)
    dense = [t for t in terms if t[0] == "d"]
    sparse = [t for t in terms if t[0] == "s"]
    d = list(rng.choice(dense, 24, replace=False))
    s = list(rng.choice(sparse, 56, replace=False))
    out = []
    for metric in METRICS:
        out += [(str(t), 10, metric) for t in d[:16] + s[:48]]
        out += [(str(t), 100, metric) for t in d[16:] + s[48:]]
        out += [(f"unknown-{i}", 10, metric) for i in range(4)]
    return out


def phase_similarity(dev, index, sets, seed, failures):
    from repro_torch.kernels import segment_ops as so
    from repro_torch.kernels import topk_ops as tk

    terms = list(index.postings)
    t0 = time.perf_counter()
    oracle = SimOracle(terms, sets, N_DOCS // 64)
    traffic = sim_traffic(seed, terms)
    inters = {}
    for term, _, _ in traffic:
        if term not in inters:
            inters[term] = oracle.inter(oracle.words(term))
    answers = [oracle.topk(t, k, m, inters[t]) for t, k, m in traffic]
    oracle_s = time.perf_counter() - t0
    log(f"  oracle: {len(inters)} query sets x {len(terms)} terms, "
        f"{oracle_s:.1f} s")

    _reset_counts()                         # the similarity path starts here
    mem0 = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    first = index.similar(traffic[0][0], traffic[0][1], traffic[0][2])
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t
    eng = index._sim_engine()[1]
    engine_bytes = eng._device()[0].numel() * 4
    mem_delta = torch.cuda.memory_allocated(dev) - mem0
    log(f"  engine build through similar(): {build_s:.2f} s; "
        f"{eng.rows.shape[0]} candidate rows, device rows {engine_bytes} "
        f"bytes (allocated +{mem_delta}) beside the "
        f"{index.arena.device_slab().numel() * 4}-byte arena")
    wrong = 0 if _same_sim(first, answers[0]) else 1
    lat: dict = {}
    bad_launch = 0
    for (term, k, metric), want in zip(traffic[1:], answers[1:]):
        n0 = dict(tk.launches_by_stage)
        t = time.perf_counter()
        got = index.similar(term, k, metric)
        lat.setdefault((metric, k), []).append(
            (time.perf_counter() - t) * 1e3)
        wrong += not _same_sim(got, want)
        bad_launch += any(tk.launches_by_stage[s] != n0[s] + 1
                          for s in ("score", "select"))
    classes = {}
    for metric in METRICS:
        qs = [(t, k) for t, k, m in traffic if m == metric and k == 10][:16]
        tr = _traced(metric, lambda: [index.similar(term, k, metric)
                                      for term, k in qs], dev,
                     ("score_kernel", "rank_select_kernel"))
        busy, kern, wall_us = tr["busy_us"], tr["kernel_us"], tr["wall_us"]
        sel = tr["name_us"]["rank_select_kernel"]
        for k in (10, 100):
            ls = lat.get((metric, k), [])
            classes[f"{metric}/k={k}"] = dict(
                queries=len(ls), p50_ms=float(np.percentile(ls, 50)),
                p99_ms=float(np.percentile(ls, 99)))
        classes[f"{metric}/k=10"].update(
            profiled_queries=len(qs), device_busy_us=busy, kernel_us=kern,
            score_us=kern - sel, select_us=sel, wall_us=wall_us,
            idle_share=tr["idle_share"])
        c = classes[f"{metric}/k=10"]
        log(f"  {metric:12s} k=10 p50 {c['p50_ms']:.3f} ms  p99 "
            f"{c['p99_ms']:.3f} ms; k=100 p50 "
            f"{classes[f'{metric}/k=100']['p50_ms']:.3f} ms; idle "
            + (f"{c['idle_share']:.4f}" if c["idle_share"] is not None
               else "not measured")
            + f"  kernels {kern / len(qs):.1f} us/query (score "
            f"{(kern - sel) / len(qs):.1f}, select {sel / len(qs):.1f})")
    launches = dict(tk.launches_by_stage)   # the similarity path ends here
    log(f"  {len(traffic)} queries: wrong {wrong}, queries not launching "
        f"each stage once {bad_launch}; launches {launches}, "
        f"segment_reduce {so.launches}")
    if wrong:
        failures.append(f"similarity: {wrong} answers differ from the "
                        f"oracle")
    if bad_launch:
        failures.append(f"similarity: {bad_launch} queries did not launch "
                        f"each stage exactly once")
    if min(launches["score"], launches["select"]) == 0:
        failures.append("similarity: a kernel never launched")
    sim_cases = [dict(term=t, k=k, metric=m, answer=a)
                 for (t, k, m), a in zip(traffic, answers)]
    return dict(queries=len(traffic), wrong=wrong, bad_launch=bad_launch,
                launches=launches, classes=classes, build_s=build_s,
                engine_rows=int(eng.rows.shape[0]),
                engine_device_bytes=engine_bytes,
                allocated_delta=mem_delta, oracle_s=oracle_s), sim_cases


# ---------------------------------------------------------------------------
# phase 5: the QueryServer
# ---------------------------------------------------------------------------

def _ticket_query(cls, q):
    from repro_torch.serve import Query
    if cls == "similar":
        return Query.similar(q["term"], k=q["k"], metric=q["metric"])
    terms = q["terms"]
    if cls == "and":
        return Query.and_(*terms)
    if cls == "or":
        return Query.or_(*terms)
    if cls == "xor":
        return Query.xor_(*terms)
    if cls == "andnot":
        return Query.andnot(terms[0], *terms[1:])
    return Query.threshold(terms, q["t"], q.get("weights"))


def _check_tickets(tickets, wants, to_packed, label, failures):
    """Every ticket OK and equal to its expected answer."""
    from repro_torch.serve import OK
    wrong = 0
    for t, (cls, want) in zip(tickets, wants):
        if t.result.status != OK:
            wrong += 1
        elif cls == "similar":
            wrong += not _same_sim(t.result.value, want)
        else:
            wrong += not np.array_equal(to_packed(t.result.value), want)
    if wrong:
        failures.append(f"{label}: {wrong} tickets wrong or not OK")
    return wrong


def phase_server(dev, index, traffic, answers, sim_cases, failures,
                 per_class=32):
    from repro_torch.kernels import segment_ops as so
    from repro_torch.kernels import topk_ops as tk
    from repro_torch.serve import QueryServer
    work = [(cls, q, answers[cls][i]) for cls in CLASSES
            for i, q in enumerate(traffic[cls][:per_class])]
    work += [("similar", c, c["answer"]) for c in sim_cases
             if c["k"] == 10 and not c["term"].startswith("unknown")][::3]
    order = np.random.default_rng(5).permutation(len(work))
    work = [work[i] for i in order]
    _reset_counts()                         # the serving path starts here
    srv = QueryServer(index)
    t0 = time.perf_counter()
    tickets = [srv.submit(_ticket_query(cls, q)) for cls, q, _ in work]
    t1 = time.perf_counter()
    srv.run_until_idle()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    launches = dict(segment_reduce=so.launches,
                    score=tk.launches_by_stage["score"],
                    select=tk.launches_by_stage["select"])
    st = srv.stats()                        # the serving path ends here
    wrong = _check_tickets(tickets, [(c, w) for c, _, w in work],
                           _to_packed, "server", failures)
    degraded = sum(t.telemetry.degraded for t in tickets)
    lat = [t.telemetry.latency * 1e3 for t in tickets]
    info = dict(tickets=len(tickets), wrong=wrong, degraded=degraded,
                stats=st.as_dict(), launches=launches, submit_s=t1 - t0,
                run_s=t2 - t1, tickets_per_s=len(tickets) / (t2 - t0),
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)))
    log(f"  {len(tickets)} tickets in {st.batches} batches over {st.ticks} "
        f"ticks: admission {t1 - t0:.2f} s, run {t2 - t1:.2f} s, "
        f"{info['tickets_per_s']:.1f} tickets/s, latency p50 "
        f"{info['p50_ms']:.1f} ms p99 {info['p99_ms']:.1f} ms; wrong "
        f"{wrong}; host_fallbacks {st.host_fallbacks}, dispatch_retries "
        f"{st.dispatch_retries}, degraded {degraded}; launches {launches}")
    if st.host_fallbacks or st.dispatch_retries or degraded:
        failures.append("server: the fault-free run retried or fell back "
                        "to the host")
    if min(launches.values()) == 0:
        failures.append(f"server: a kernel never launched {launches}")
    return info


def phase_server_faults(dev, postings, sets, seed, failures, chunks=16,
                        n_dense=16, n_sparse=48):
    """Scripted faults on a smaller index (the first ``chunks`` chunks of
    16 dense and 48 sparse terms, on its own arena): one dispatch_raise
    retries once; a slab_mismatch after one postings edit repatches only
    the edited row; dispatch_raise always degrades to the host and still
    answers right."""
    from repro_torch import convert
    from repro_torch.core import BitmapArena
    from repro_torch.data.index import InvertedIndex
    from repro_torch.serve import FakeClock, FaultInjector, QueryServer
    n_words = chunks << 10
    names = [f"d{i}" for i in range(n_dense)] + \
        [f"s{i}" for i in range(n_sparse)]
    small, small_sets = {}, {}
    for t in names:
        keys, kinds, payloads = convert.bitmap_to_parts(postings[t])
        j = int(np.searchsorted(keys, chunks))
        small[t] = convert.bitmap_from_parts(keys[:j], kinds[:j],
                                             payloads[:j])
        s = sets[t]
        small_sets[t] = s[:n_words].copy() if s.dtype == np.uint64 else \
            s[s < n_words * 64]
    index = InvertedIndex.from_postings(
        small, n_words * 64, arena=BitmapArena(capacity=4096, device=dev))
    rng = np.random.default_rng(seed + 6)
    specs = []
    for cls in CLASSES:
        for _ in range(4):
            ts = [str(x) for x in rng.choice(names[:n_dense], 2,
                                             replace=False)] + \
                [str(x) for x in rng.choice(names[n_dense:], 2,
                                            replace=False)]
            q = dict(terms=ts, t=2)
            if cls == "threshold_w":
                q["weights"] = [1, 2, 3, 1]
            specs.append((cls, q))
    for i in range(8):
        specs.append(("similar", dict(term=names[i * 7],
                                      k=1 + i, metric=METRICS[i % 3])))

    def answers(sets_now):
        oracle = Oracle(sets_now, n_words)
        sim = SimOracle(names, sets_now, n_words)
        out = []
        for cls, q in specs:
            if cls == "similar":
                out.append((cls, sim.topk(q["term"], q["k"], q["metric"])))
            else:
                out.append((cls, np.asarray(oracle.answer(cls, q))))
        return out

    def to_packed(bm):
        return _to_packed(bm)[:n_words]

    def run(script, edit=None):
        clock = FakeClock()
        srv = QueryServer(index, clock=clock,
                          faults=FaultInjector.script(script))
        tickets = [srv.submit(_ticket_query(c, q)) for c, q in specs]
        if edit is not None:
            edit()
        srv.run_until_idle()
        return srv.stats(), tickets

    runs = {}
    want = answers(small_sets)
    st, tickets = run({"dispatch_raise": [True]})
    runs["dispatch_raise once"] = dict(
        stats=st.as_dict(), wrong=_check_tickets(
            tickets, want, to_packed, "dispatch_raise once", failures))
    if st.dispatch_retries != 1 or st.host_fallbacks:
        failures.append(f"dispatch_raise once: {st}")

    # one postings edit between admission and dispatch: a new document in
    # an existing bitset chunk of d0 (one container, one arena row)
    doc = int(np.flatnonzero(~np.unpackbits(
        small_sets["d0"].view(np.uint8), bitorder="little").astype(bool))[0])
    edited = dict(small_sets)
    edited["d0"] = small_sets["d0"].copy()
    edited["d0"][doc >> 6] |= np.uint64(1) << np.uint64(doc & 63)
    st, tickets = run({"slab_mismatch": [True]},
                      edit=lambda: index.postings["d0"].add(doc))
    want = answers(edited)
    runs["slab_mismatch after one edit"] = dict(
        stats=st.as_dict(), wrong=_check_tickets(
            tickets, want, to_packed, "slab_mismatch", failures))
    if st.replans != 1 or st.rows_repatched != 1 or st.host_fallbacks:
        failures.append(f"slab_mismatch: {st}")

    st, tickets = run({"dispatch_raise": "always"})
    degraded = sum(t.telemetry.degraded for t in tickets)
    runs["dispatch_raise always"] = dict(
        stats=st.as_dict(), degraded=degraded, wrong=_check_tickets(
            tickets, want, to_packed, "dispatch_raise always", failures))
    if degraded != len(tickets) or st.host_fallbacks < 1:
        failures.append(f"dispatch_raise always: {degraded} degraded, {st}")
    for name, r in runs.items():
        s = r["stats"]
        log(f"  {name:30s} wrong {r['wrong']}  retries "
            f"{s['dispatch_retries']}  replans {s['replans']}  "
            f"rows_repatched {s['rows_repatched']}  host_fallbacks "
            f"{s['host_fallbacks']}"
            + (f"  degraded {r['degraded']}" if "degraded" in r else ""))
    return dict(tickets=len(specs), documents=n_words * 64,
                terms=len(names), runs=runs)


# ---------------------------------------------------------------------------
# phase 6: the two-by-two algebra on the main path
# ---------------------------------------------------------------------------

def pair_traffic(seed, per_pairing=16, batch_per_pairing=32):
    """Term pairs of each pairing (distinct terms), 2 dense and 2 sparse
    self-pairs, a separate draw of ``batch_per_pairing`` pairs per pairing
    for the mixed-op count batch, and 16 terms (4 dense, 12 sparse) for
    the Jaccard matrix."""
    rng = np.random.default_rng(seed + 7)
    tiers = {"dense": [f"d{i}" for i in range(N_DENSE)],
             "sparse": [f"s{i}" for i in range(N_SPARSE)]}

    def draw(pairing, n):
        ta, tb = (tiers[t] for t in pairing.split(" x "))
        out = []
        while len(out) < n:
            x, y = str(rng.choice(ta)), str(rng.choice(tb))
            if x != y:
                out.append((x, y))
        return out

    merges = {p: draw(p, per_pairing) for p in PAIRINGS}
    merges["self"] = [(t, t) for t in list(rng.choice(tiers["dense"], 2,
                                                      replace=False))
                      + list(rng.choice(tiers["sparse"], 2,
                                        replace=False))]
    batch = [pq for p in PAIRINGS for pq in draw(p, batch_per_pairing)]
    order = rng.permutation(len(batch))
    batch = [batch[i] for i in order]
    ops = [PAIR_OPS[i % 4] for i in range(len(batch))]
    matrix = [str(t) for t in rng.choice(tiers["dense"], 4, replace=False)]
    matrix += [str(t) for t in rng.choice(tiers["sparse"], 12,
                                          replace=False)]
    return merges, (ops, batch), matrix


_NP_PAIR = {"and": lambda x, y: x & y, "or": lambda x, y: x | y,
            "xor": lambda x, y: x ^ y, "andnot": lambda x, y: x & ~y}
_OPERATOR = {"and": lambda x, y: x & y, "or": lambda x, y: x | y,
             "xor": lambda x, y: x ^ y, "andnot": lambda x, y: x - y}


def _popc(w):
    return int(np.bitwise_count(w).sum())


def _jaccard64(inter, ca, cb):
    union = ca + cb - inter
    return inter / union if union else 1.0


def phase_pairwise(dev, index, sets, seed, failures):
    """``& | ^ -`` on term pairs of every pairing and self-pairs, then
    ``count_and`` / ``jaccard``, a mixed-op ``pairwise_card`` batch and a
    ``jaccard_matrix``, each against the packed numpy oracle.  Device busy
    time and copy bytes come from profiler windows over second calls."""
    from repro_torch.core import RoaringBitmap

    merges, (batch_ops, batch), matrix = pair_traffic(seed)
    oracle = Oracle(sets)
    bm = index._get
    pairs = [pq for ps in merges.values() for pq in ps]

    _reset_counts()                         # the pair path starts here
    lat, wrong = {}, 0
    for op in PAIR_OPS:
        for pairing, pq in merges.items():
            for x, y in pq:
                t = time.perf_counter()
                got = _OPERATOR[op](bm(x), bm(y))
                torch.cuda.synchronize(dev)
                lat.setdefault((op, pairing), []).append(
                    (time.perf_counter() - t) * 1e3)
                want = _NP_PAIR[op](oracle.words(x), oracle.words(y))
                wrong += not np.array_equal(_to_packed(got), want)
    merge_info = {f"{op}/{pairing}": dict(
        merges=len(ls), p50_ms=float(np.percentile(ls, 50)),
        p99_ms=float(np.percentile(ls, 99)))
        for (op, pairing), ls in lat.items()}
    for op in PAIR_OPS:
        log(f"  {op:7s} " + "  ".join(
            f"{p.split(' x ')[0][0]}x{p.split(' x ')[1][0]} p50 "
            f"{merge_info[f'{op}/{p}']['p50_ms']:.2f} p99 "
            f"{merge_info[f'{op}/{p}']['p99_ms']:.2f}"
            for p in PAIRINGS) + " ms")

    # counts: count_and and jaccard on the same pairs, one at a time
    c_lat, j_lat, wrong_c = [], [], 0
    for x, y in pairs:
        wx, wy = oracle.words(x), oracle.words(y)
        inter = _popc(wx & wy)
        t = time.perf_counter()
        got = index.count_and(x, y)
        c_lat.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        jac = index.jaccard(x, y)
        j_lat.append((time.perf_counter() - t) * 1e3)
        want = _jaccard64(inter, _popc(wx), _popc(wy))
        wrong_c += got != inter
        wrong_c += np.float64(jac).tobytes() != np.float64(want).tobytes()

    # one mixed-op count batch over 128 pairs
    batch_pairs = [(bm(x), bm(y)) for x, y in batch]
    t = time.perf_counter()
    got = RoaringBitmap.pairwise_card(batch_ops, batch_pairs)
    batch_ms = (time.perf_counter() - t) * 1e3
    want = np.array([_popc(_NP_PAIR[o](oracle.words(x), oracle.words(y)))
                     for o, (x, y) in zip(batch_ops, batch)])
    wrong_b = int((got != want).sum())

    # the all-pairs Jaccard matrix over 16 terms
    matrix_bms = [bm(x) for x in matrix]
    t = time.perf_counter()
    jm = RoaringBitmap.jaccard_matrix(matrix_bms)
    matrix_ms = (time.perf_counter() - t) * 1e3
    ws = [oracle.words(x) for x in matrix]
    cards = np.array([_popc(w) for w in ws], np.float64)
    n = len(matrix)
    inter = np.ones((n, n))
    for i in range(n):
        for j in range(n):
            inter[i, j] = _popc(ws[i] & ws[j])
    union = cards[:, None] + cards[None, :] - inter
    want_jm = np.divide(inter, union, out=np.ones_like(inter),
                        where=union > 0)
    np.fill_diagonal(want_jm, 1.0)
    wrong_m = int((jm.view(np.int64) != want_jm.view(np.int64)).sum())

    # profiler windows over second calls: 4 merges per op and pairing,
    # count_and over the first 4 pairs of each pairing, the batch, the
    # matrix; busy time and copy bytes as the trace records them
    for op in PAIR_OPS:
        busy = wall = kern = 0.0
        complete = True
        for pairing in PAIRINGS:
            window = merges[pairing][:4]
            tr = _traced(f"{op} {pairing}", lambda: [
                _OPERATOR[op](bm(x), bm(y)) for x, y in window], dev,
                _PAIR_KERNEL_NAMES)
            merge_info[f"{op}/{pairing}"].update(
                h2d_bytes=tr["h2d_bytes"] / len(window),
                d2h_bytes=tr["d2h_bytes"] / len(window),
                device_busy_us=tr["busy_us"] / len(window),
                kernel_us=tr["kernel_us"] / len(window),
                device_events=tr["device_events"], complete=tr["complete"])
            busy, wall, kern = (busy + tr["busy_us"], wall + tr["wall_us"],
                                kern + tr["kernel_us"])
            complete = complete and tr["complete"]
        m = 4 * len(PAIRINGS)
        merge_info[f"{op}/profiled"] = dict(
            merges=m, device_busy_us=busy, kernel_us=kern, wall_us=wall,
            complete=complete,
            idle_share=1.0 - busy / wall if complete else None)
        idle = merge_info[f"{op}/profiled"]["idle_share"]
        log(f"  {op:7s} idle share "
            + (f"{idle:.4f}" if idle is not None else "not measured")
            + f" over {m} merges; kernels {kern / m:.1f} us, device busy "
            f"{busy / m:.1f} us per merge; bytes up / down per merge "
            + "  ".join(
                f"{p.split(' x ')[0][0]}x{p.split(' x ')[1][0]} "
                f"{merge_info[f'{op}/{p}']['h2d_bytes']:.0f} / "
                f"{merge_info[f'{op}/{p}']['d2h_bytes']:.0f}"
                for p in PAIRINGS))
    window = [pq for p in PAIRINGS for pq in merges[p][:4]]
    count_tr = _traced("count_and", lambda: [
        index.count_and(x, y) for x, y in window], dev, _PAIR_KERNEL_NAMES)
    count_tr["calls"] = len(window)
    batch_tr = _traced("pairwise_card", lambda: RoaringBitmap.pairwise_card(
        batch_ops, batch_pairs), dev, _PAIR_KERNEL_NAMES)
    matrix_tr = _traced("jaccard_matrix", lambda: RoaringBitmap.jaccard_matrix(
        matrix_bms), dev, _PAIR_KERNEL_NAMES)
    launches = _pair_counts()               # the pair path ends here

    info = dict(
        merges=merge_info, merges_run=sum(len(v) for v in lat.values()),
        wrong_merges=wrong,
        counts=dict(pairs=len(pairs), wrong=wrong_c,
                    count_and_p50_ms=float(np.percentile(c_lat, 50)),
                    count_and_p99_ms=float(np.percentile(c_lat, 99)),
                    jaccard_p50_ms=float(np.percentile(j_lat, 50)),
                    jaccard_p99_ms=float(np.percentile(j_lat, 99)),
                    profiled=count_tr),
        pairwise_card=dict(pairs=len(batch), wrong=wrong_b, ms=batch_ms,
                           profiled=batch_tr),
        jaccard_matrix=dict(terms=n, wrong=wrong_m, ms=matrix_ms,
                            profiled=matrix_tr),
        launches=launches)

    def traced(tr):
        idle = tr["idle_share"]
        return (f"idle share "
                + (f"{idle:.4f}" if idle is not None else "not measured")
                + f", device busy {tr['busy_us']:.1f} us "
                f"({tr['device_events']} of {tr['runtime_calls']} device "
                f"events), "
                f"{tr['h2d_bytes']} bytes up, {tr['d2h_bytes']} down")

    log(f"  {info['merges_run']} merges, wrong {wrong}; count_and p50 "
        f"{info['counts']['count_and_p50_ms']:.2f} ms, jaccard p50 "
        f"{info['counts']['jaccard_p50_ms']:.2f} ms over {len(pairs)} "
        f"pairs, wrong {wrong_c}; {len(window)} count_and calls: "
        + traced(count_tr))
    log(f"  pairwise_card: {len(batch)} mixed-op pairs in {batch_ms:.1f} "
        f"ms, wrong {wrong_b}; second call: " + traced(batch_tr))
    log(f"  jaccard_matrix: {n} terms in {matrix_ms:.1f} ms, wrong "
        f"{wrong_m}; second call: " + traced(matrix_tr))
    log(f"  launches {launches}")
    if wrong or wrong_c or wrong_b or wrong_m:
        failures.append(f"pairwise: {wrong} merges, {wrong_c} counts, "
                        f"{wrong_b} batch counts and {wrong_m} matrix "
                        f"entries differ from the oracle")
    missing = [k for k in PAIR_KERNELS if launches[k] == 0]
    if missing:
        failures.append(f"pairwise: kernels never launched: {missing}")
    return info


# ---------------------------------------------------------------------------
# phase 7: RoaringTensor at real scale
# ---------------------------------------------------------------------------

def _window_bitmap(bits):
    """The port's bitmap of a 2^24-bit bool array made of a few ranges:
    one run container a touched chunk, then the host ``run_optimize``."""
    from repro_torch.core import RoaringBitmap
    from repro_torch.core.containers import RunContainer
    edges = np.flatnonzero(np.diff(bits.astype(np.int8), prepend=0,
                                   append=0))
    by_key = {}
    for s, e in zip(edges[0::2], edges[1::2]):          # disjoint [s, e)
        for k in range(s >> 16, ((e - 1) >> 16) + 1):
            lo, hi = max(s, k << 16), min(e, (k + 1) << 16)
            by_key.setdefault(k, []).append((lo - (k << 16), hi - lo - 1))
    keys = sorted(by_key)
    return RoaringBitmap(keys, [RunContainer(np.array(by_key[k], np.int32))
                                for k in keys]).run_optimize()


def window_bitmaps(seed, n=N_WINDOWS):
    """``n`` window bitmaps of 1-8 ranges of 4,096 to 1,048,576 documents
    (log-uniform) over 2^24, and their packed words."""
    rng = np.random.default_rng(seed + 11)
    bms, words = [], []
    for _ in range(n):
        k = int(rng.integers(1, 9))
        lens = np.exp(rng.uniform(np.log(4096), np.log(1 << 20), k)) \
            .astype(np.int64)
        starts = rng.integers(0, N_DOCS - lens)
        bits = np.zeros(N_DOCS, bool)
        for s, n_docs in zip(starts, lens):
            bits[s:s + n_docs] = True
        bms.append(_window_bitmap(bits))
        words.append(np.packbits(bits, bitorder="little").view(np.uint64))
    return bms, words


# the port's kernels in phase 7's windows, by name pattern (the trace
# holds demangled names)
_TENSOR_KERNELS = {"array_to_bitset": "a2b_kernel",
                   "bitset_pair": "pair_kernel",
                   "segment_reduce": SEGMENT_KERNELS[0]}
_TENSOR_OP = {"and": lambda x, y: x & y, "or": lambda x, y: x | y,
              "xor": lambda x, y: x ^ y, "andnot": lambda x, y: x.andnot(y)}


def _jaccard32(inter, ca, cb):
    """The port's float32 Jaccard formula in numpy float32: inter / (ca +
    cb - inter), 1.0 where the union is empty."""
    i32 = np.float32(inter)
    union = np.float32(ca + cb) - i32
    return np.float32(i32 / union) if union > 0 else np.float32(1.0)


def phase_tensor(dev, postings, sets, seed, failures, keep):
    """``RoaringTensor`` over the index's 1,024 postings and 64 windows
    at capacity 256 on the card, every operation against the packed
    numpy oracle; p50 / p99 (host clock, ending in a synchronize) per
    operation over 5 calls (3 for the largest), the first one checked;
    profiler windows over one more call of the algebra, a count, the
    count batch, ``reduce_or`` and ``run_optimize``.  The tensor and its
    union stay in ``keep`` for phase 9's sharded ``reduce_or``."""
    from repro_torch.core import aggregate
    from repro_torch.core.tensor import KIND_RUN, RoaringTensor
    from repro_torch.kernels import bitset_convert, harley_seal, segment_ops
    terms = [f"d{i}" for i in range(N_DENSE)] + \
        [f"s{i}" for i in range(N_SPARSE)]
    n_terms = len(terms)
    t0 = time.perf_counter()
    windows, window_words = window_bitmaps(seed)
    bitmaps = [postings[t] for t in terms] + windows
    b = len(bitmaps)
    row_of = {t: i for i, t in enumerate(terms)}
    cache = {}

    def words(i):
        w = cache.get(i)
        if w is None:
            if i >= n_terms:
                w = window_words[i - n_terms]
            else:
                src = sets[terms[i]]
                w = src if src.dtype == np.uint64 else _packed(src)
            cache[i] = w
        return w

    rng = np.random.default_rng(seed + 13)
    rows64 = np.sort(np.concatenate([
        rng.choice(N_DENSE, 16, replace=False),
        rng.choice(np.arange(N_DENSE, n_terms), 32, replace=False),
        rng.choice(np.arange(n_terms, b), 16, replace=False)]))
    merges, _, _ = pair_traffic(seed)
    pairs = [(row_of[x], row_of[y]) for p in PAIRINGS for x, y in merges[p]]
    pairs += [(n_terms + int(rng.integers(N_WINDOWS)),
               int(rng.integers(N_DENSE, n_terms))) for _ in range(16)]
    pl = rng.integers(0, b, 512)
    pr = rng.integers(0, b, 512)
    pops = [PAIR_OPS[i % 4] for i in range(512)]
    q = rng.integers(0, N_DOCS, (64, 4096))
    for i, r in enumerate(rows64):                # half the probes hit
        members = bitmaps[r].to_array()
        q[i, :2048] = rng.choice(members, 2048)
    t_inputs = time.perf_counter() - t0

    lat, wrong, traces = {}, {}, {}

    def trace(name, fn):
        """A profiler window over one more call: device busy and kernel
        time by kernel, bytes copied, idle share."""
        tr = _traced(f"tensor {name}", fn, dev,
                     tuple(_TENSOR_KERNELS.values()))
        traces[name] = tr
        idle = tr["idle_share"]
        log(f"  {name:14s} window: wall {tr['wall_us'] / 1e3:.2f} ms, "
            f"device busy {tr['busy_us'] / 1e3:.2f} ms, kernels "
            + ", ".join(f"{k} {tr['name_us'][v]:.1f} us"
                        for k, v in _TENSOR_KERNELS.items())
            + f"; {tr['h2d_bytes']} bytes up, {tr['d2h_bytes']} down; "
            "idle share " + (f"{idle:.4f}" if idle is not None else
                             "not measured"))
        log("    most device time: " + "; ".join(
            f"{k[:60]} {v:.1f} us" for k, v in tr["top_kernels"][:3]))

    def timed(name, fn, reps=5):
        out = None
        lat[name] = []
        for i in range(reps):
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize(dev)
            lat[name].append((time.perf_counter() - t) * 1e3)
            if i == 0:
                out = r
            del r
        return out

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()                         # the tensor path starts here
    t0 = time.perf_counter()
    t = RoaringTensor.from_bitmaps(bitmaps, capacity=TENSOR_CAP, device=dev)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    kinds = {int(k): int(n) for k, n in zip(*np.unique(
        t.kinds.cpu().numpy(), return_counts=True))}
    log(f"  inputs {t_inputs:.1f} s; from_bitmaps {build_s:.2f} s: B = {b}, "
        f"C = {t.capacity}, slab {t.slab.numel() * 2} bytes, slot kinds "
        f"{kinds}")

    card = timed("cardinality", t.cardinality).cpu().numpy()
    nbytes = timed("packed_nbytes", t.packed_nbytes).cpu().numpy()
    wrong["cardinality"] = int((card != [bm.cardinality
                                         for bm in bitmaps]).sum())
    wrong["packed_nbytes"] = int((nbytes != [bm.memory_bytes()
                                             for bm in bitmaps]).sum())
    sub = timed("take", lambda: t.take(rows64))
    got = timed("to_bitmaps", sub.to_bitmaps, reps=2)
    wrong["take"] = sum(g != bitmaps[r] for g, r in zip(got, rows64))

    # 80 row-aligned pairs: & | ^ andnot, the four counts, jaccard
    li, ri = [p[0] for p in pairs], [p[1] for p in pairs]
    lhs, rhs = t.take(li), t.take(ri)
    want_card = {op: [_popc(_NP_PAIR[op](words(x), words(y)))
                      for x, y in pairs] for op in PAIR_OPS}
    for op in PAIR_OPS:
        res = timed(op, lambda: _TENSOR_OP[op](lhs, rhs))
        bad = sum(not np.array_equal(_to_packed(g), _NP_PAIR[op](
            words(x), words(y))) for g, (x, y) in zip(res.to_bitmaps(),
                                                      pairs))
        bad += int((res.cardinality().cpu().numpy() != want_card[op]).sum())
        got = timed(f"{op}_card", lambda: getattr(lhs, f"{op}_card")(rhs))
        bad += int((got.cpu().numpy() != want_card[op]).sum())
        wrong[op] = bad
        del res
    jac = timed("jaccard", lambda: lhs.jaccard(rhs)).cpu().numpy()
    want_j = np.array([_jaccard32(i, _popc(words(x)), _popc(words(y)))
                       for i, (x, y) in zip(want_card["and"], pairs)],
                      np.float32)
    wrong["jaccard"] = int((jac.view(np.int32) != want_j.view(np.int32))
                           .sum())
    trace("and", lambda: lhs & rhs)
    trace("and_card", lambda: lhs.and_card(rhs))
    del lhs, rhs

    # a mixed-op count batch over 512 random pairs of the full tensor
    got = timed("pairwise_card", lambda: t.pairwise_card(
        t, pops, lhs_idx=pl, rhs_idx=pr), reps=3).cpu().numpy()
    want = [_popc(_NP_PAIR[o](words(x), words(y)))
            for o, x, y in zip(pops, pl, pr)]
    wrong["pairwise_card"] = int((got != want).sum())
    trace("pairwise_card", lambda: t.pairwise_card(
        t, pops, lhs_idx=pl, rhs_idx=pr))

    # membership: 4,096 document ids on each of the 64 rows
    got = timed("contains", lambda: sub.contains(q)).cpu().numpy()
    want = np.stack([((words(r)[q[i] >> 6] >> (q[i] & 63).astype(
        np.uint64)) & np.uint64(1)).astype(bool)
        for i, r in enumerate(rows64)])
    wrong["contains"] = int((got != want).sum())

    # reduce_or of the whole tensor: one segment_reduce launch
    res = timed("reduce_or", t.reduce_or, reps=3)
    union = np.zeros(N_DOCS // 64, np.uint64)
    for i in range(b):
        union |= words(i)
    wrong["reduce_or"] = int(not np.array_equal(
        _to_packed(res.to_bitmaps()[0]), union))
    trace("reduce_or", t.reduce_or)

    # run_optimize of the 64 window rows and the 64 dense rows
    ro_rows = list(range(n_terms, b)) + list(range(N_DENSE))
    sub_ro = t.take(ro_rows)
    res = timed("run_optimize", sub_ro.run_optimize, reps=3)
    host = [bitmaps[r].copy().run_optimize() for r in ro_rows]
    got = res.to_bitmaps()
    wrong["run_optimize"] = sum(g != h for g, h in zip(got, host)) + int((
        res.packed_nbytes().cpu().numpy() != [h.memory_bytes()
                                              for h in host]).sum())
    kind_differs = sum([c.kind for c in g.containers] !=
                       [c.kind for c in h.containers]
                       for g, h in zip(got, host))
    run_slots = int((res.kinds == KIND_RUN).sum())
    trace("run_optimize", sub_ro.run_optimize)
    del res, sub_ro

    # to_arena of the 64 rows, then a wide OR over the new arena
    arena, bms = timed("to_arena", sub.to_arena, reps=1)
    res = timed("or_many", lambda: aggregate.or_many(bms, arena=arena))
    want = np.bitwise_or.reduce([words(r) for r in rows64])
    wrong["to_arena_or_many"] = int(not np.array_equal(_to_packed(res),
                                                       want))
    torch.cuda.synchronize(dev)
    launches = {**bitset_convert.launches_by_kernel,
                **harley_seal.launches_by_kernel, **_pair_counts(),
                "segment_reduce": segment_ops.launches}
    peak = torch.cuda.max_memory_allocated(dev)       # the path ends here
    keep.update(tensor=t, union=union)
    del t, sub, arena, bms
    torch.cuda.empty_cache()

    ops = {name: dict(calls=len(ls), p50_ms=float(np.percentile(ls, 50)),
                      p99_ms=float(np.percentile(ls, 99)))
           for name, ls in lat.items()}
    for name, o in ops.items():
        log(f"  {name:14s} p50 {o['p50_ms']:9.2f} ms  p99 "
            f"{o['p99_ms']:9.2f} ms  ({o['calls']} calls)")
    log(f"  wrong {wrong}; run_optimize: {run_slots} run slots, "
        f"{kind_differs} rows whose kinds differ from the host's (ties "
        f"of equal bytes)")
    log(f"  launches {launches}; max_memory_allocated {peak}")
    if any(wrong.values()):
        failures.append(f"tensor: answers differ from the oracle: {wrong}")
    missing = [k for k in ("array_to_bitset", "bitset_pair_op",
                           "bitset_pair_card", "segment_reduce")
               if launches[k] == 0]
    if missing:
        failures.append(f"tensor: kernels never launched: {missing}")
    return dict(batch=b, capacity=TENSOR_CAP, slot_kinds=kinds,
                slab_bytes=b * TENSOR_CAP * 8192, build_s=build_s,
                inputs_s=t_inputs, ops=ops, traces=traces, wrong=wrong,
                pairs=len(pairs),
                pairwise_pairs=len(pops), run_slots=run_slots,
                kind_differs=kind_differs, launches=launches,
                max_memory_allocated=peak)


# ---------------------------------------------------------------------------
# phase 8: the kernels.ops surface at real scale
# ---------------------------------------------------------------------------

# the kernels of phase 8's entry points, by name pattern (the trace holds
# demangled names)
_OPS_KERNELS = ("bitset_op_kernel<", "array_intersect_kernel",
                "popcount_kernel", "a2b_kernel<")


def _chunk_rows(words64):
    """(N_DOCS / 64,) uint64 packed words -> (256, 2048) uint32 rows, one
    a chunk of 2^16 documents."""
    return words64.reshape(-1, 1024).view(np.uint32)


def _array_rows(index, terms, dev):
    """The array containers of ``terms`` as value rows on the card: row
    ``i * 256 + chunk`` holds term i's container of that chunk (sorted
    values, zeros past its card; card 0 where the term has no
    container).  The values come from the index's own containers on the
    host and are scattered into place on the card.  Returns (values (rows,
    4096) int32, card (rows,) int32); raises if a container is not an
    array."""
    n_chunks = N_DOCS >> 16
    vals, rows = [], []
    for i, t in enumerate(terms):
        bm = index._get(t)
        if any(c.kind != "array" for c in bm.containers):
            raise RuntimeError(f"{t} holds a container that is not an array")
        vals += [c.values for c in bm.containers]
        rows.append(np.repeat(i * n_chunks + np.asarray(bm.keys, np.int64),
                              [c.values.size for c in bm.containers]))
    vals = np.concatenate(vals).astype(np.int32)
    rows = np.concatenate(rows)
    card = np.bincount(rows, minlength=len(terms) * n_chunks)
    rank = np.arange(rows.size) - (np.cumsum(card) - card)[rows]
    out = torch.zeros((card.size, 4096), dtype=torch.int32, device=dev)
    out[torch.from_numpy(rows).to(dev), torch.from_numpy(rank).to(dev)] = \
        torch.from_numpy(vals).to(dev)
    return out, torch.from_numpy(card.astype(np.int32)).to(dev)


def _intersect_oracle(sets, pairs):
    """From the packed 2^24-bit sets: for each pair (a, b), A's values as
    (row, rank) slots with their bit in B's packed set, and per chunk
    |A|, and |A ∩ B| by np.bitwise_count.  Rows are ``p * 256 + chunk``."""
    n_chunks = N_DOCS >> 16
    rows, ranks, hits, a_card, inter = [], [], [], [], []
    for p, (x, y) in enumerate(pairs):
        va = sets[x].astype(np.int64)
        pa, pb = _packed(va), _packed(sets[y].astype(np.int64))
        chunk = va >> 16
        hits.append(((pb[va >> 6] >> (va & 63).astype(np.uint64))
                     & np.uint64(1)).astype(np.int32))
        rows.append(p * n_chunks + chunk)
        ranks.append(np.arange(va.size) - np.searchsorted(chunk, chunk))
        a_card.append(np.bincount(chunk, minlength=n_chunks))
        inter.append(np.bitwise_count(pa & pb).reshape(n_chunks, -1)
                     .sum(axis=1))
    return (np.concatenate(rows), np.concatenate(ranks),
            np.concatenate(hits), np.concatenate(a_card).astype(np.int32),
            np.concatenate(inter).astype(np.int32))


def phase_ops_surface(dev, index, sets, failures, reps=5):
    """The caller-less ``kernels.ops`` entry points on the phase-3 index
    at 2^24 documents, nothing cut: ``ops.popcount`` of all 16,384 dense
    bitset rows (read from the arena's resident slab); ``ops.bitset_op``
    and ``ops.bitset_op_card``, every op, over the 64 dense terms paired
    (t, t+1) (8,192 rows a call); ``ops.bitset_set_many`` of each dense
    term's rows with sparse term i's array in the same chunk (16,384
    rows); ``ops.array_intersect`` and ``array_difference`` over the 960
    sparse terms paired (t, t+1) (122,880 array rows a call, 1.875 GiB a
    side), and the plain version once at that size.  Every answer against
    the numpy oracle of the packed sets; p50 / p99 (host clock, ending in
    a synchronize) over ``reps`` calls, the first checked; one profiler
    window per entry point; launches and peak device memory."""
    from repro_torch.kernels import array_ops, ops
    dense = [f"d{i}" for i in range(N_DENSE)]
    sparse = [f"s{i}" for i in range(N_SPARSE)]
    n_chunks = N_DOCS >> 16
    lat, traces, wrong, checked = {}, {}, {}, {}

    def timed(name, fn):
        out = None
        lat[name] = []
        for i in range(reps):
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize(dev)
            lat[name].append((time.perf_counter() - t) * 1e3)
            if i == 0:
                out = r
            del r
        return out

    def trace(name, fn):
        tr = _traced(f"ops {name}", fn, dev, _OPS_KERNELS)
        traces[name] = tr
        idle = tr["idle_share"]
        log(f"  {name:20s} window: wall {tr['wall_us'] / 1e3:.3f} ms, "
            f"device busy {tr['busy_us'] / 1e3:.3f} ms (kernels "
            f"{tr['kernel_us'] / 1e3:.3f}, PyTorch glue "
            f"{(tr['busy_us'] - tr['kernel_us']) / 1e3:.3f}); "
            f"{tr['h2d_bytes']} bytes up, {tr['d2h_bytes']} down; idle "
            + (f"{idle:.4f}" if idle is not None else "not measured"))

    t0 = time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    arena = index.arena
    ids = []
    for t in dense:
        bm = index._get(t)
        if list(bm.keys) != list(range(n_chunks)) or any(
                c.kind != "bitset" for c in bm.containers):
            raise RuntimeError(f"{t} is not a bitset in every chunk")
        ids += [arena.lookup(c) for c in bm.containers]
    if None in ids:
        raise RuntimeError("a dense container is not resident in the arena")
    words = arena.device_slab()[torch.tensor(ids, device=dev)]
    want_rows = np.concatenate([_chunk_rows(sets[t]) for t in dense])
    t_inputs = time.perf_counter() - t0

    _reset_counts()                         # the ops surface starts here
    # popcount of every dense bitset row
    got = timed("popcount", lambda: ops.popcount(words)).cpu().numpy()
    wrong["popcount"] = int((got != np.bitwise_count(want_rows)
                             .sum(axis=1)).sum())
    checked["popcount"] = got.size
    trace("popcount", lambda: ops.popcount(words))

    # one op over the dense terms paired (t, t+1): 32 x 256 rows
    pairs = words.view(N_DENSE // 2, 2, n_chunks, 2048)
    lhs = pairs[:, 0].reshape(-1, 2048).contiguous()
    rhs = pairs[:, 1].reshape(-1, 2048).contiguous()
    wp = want_rows.reshape(N_DENSE // 2, 2, n_chunks, 2048)
    wl, wr = wp[:, 0].reshape(-1, 2048), wp[:, 1].reshape(-1, 2048)
    for op in PAIR_OPS:
        want_w = _NP_PAIR[op](wl, wr)
        want_c = np.bitwise_count(want_w).sum(axis=1)
        w, c = timed(f"bitset_op/{op}", lambda: ops.bitset_op(lhs, rhs, op))
        c2 = timed(f"bitset_op_card/{op}",
                   lambda: ops.bitset_op_card(lhs, rhs, op))
        wrong[f"bitset_op/{op}"] = int(
            (w.cpu().numpy().view(np.uint32) != want_w).any(axis=1).sum()
            + (c.cpu().numpy() != want_c).sum())
        wrong[f"bitset_op_card/{op}"] = int((c2.cpu().numpy()
                                             != want_c).sum())
        checked[f"bitset_op/{op}"] = checked[f"bitset_op_card/{op}"] = \
            len(want_c)
        del w, c, c2
    trace("bitset_op", lambda: ops.bitset_op(lhs, rhs, "and"))
    trace("bitset_op_card", lambda: ops.bitset_op_card(lhs, rhs, "and"))
    del pairs, lhs, rhs, wp, wl, wr

    # each dense term's rows ORed with sparse term i's arrays
    t0 = time.perf_counter()
    sv, sc = _array_rows(index, sparse[:N_DENSE], dev)
    want_new = want_rows | np.concatenate(
        [_chunk_rows(_packed(sets[t].astype(np.int64)))
         for t in sparse[:N_DENSE]])
    t_inputs += time.perf_counter() - t0
    new, delta = timed("bitset_set_many",
                       lambda: ops.bitset_set_many(words, sv, sc))
    want_delta = (np.bitwise_count(want_new).sum(axis=1)
                  - np.bitwise_count(want_rows).sum(axis=1))
    wrong["bitset_set_many"] = int(
        (new.cpu().numpy().view(np.uint32) != want_new).any(axis=1).sum()
        + (delta.cpu().numpy() != want_delta).sum())
    checked["bitset_set_many"] = len(want_delta)
    trace("bitset_set_many", lambda: ops.bitset_set_many(words, sv, sc))
    del new, delta, sv, sc, words, want_new, want_rows
    torch.cuda.empty_cache()

    # the sorted-array intersection and difference over the sparse terms
    # paired (t, t+1): 480 x 256 rows
    t0 = time.perf_counter()
    av, ac = _array_rows(index, sparse[0::2], dev)
    bv, bc = _array_rows(index, sparse[1::2], dev)
    rows, ranks, hits, a_card, inter = _intersect_oracle(
        sets, list(zip(sparse[0::2], sparse[1::2])))
    want = torch.zeros(av.shape, dtype=torch.int32, device=dev)
    want[torch.from_numpy(rows).to(dev), torch.from_numpy(ranks).to(dev)] \
        = torch.from_numpy(hits).to(dev)
    t_inputs += time.perf_counter() - t0
    m = av.shape[0]
    mask, count = timed("array_intersect",
                        lambda: ops.array_intersect(av, ac, bv, bc))
    wrong["array_intersect"] = int(
        (mask != want).any(dim=1).sum().item()
        + (count.cpu().numpy() != inter).sum())
    trace("array_intersect", lambda: ops.array_intersect(av, ac, bv, bc))
    t = time.perf_counter()
    pm, pc = ops.array_intersect(av, ac, bv, bc, backend="ref")
    torch.cuda.synchronize(dev)
    plain_ms = (time.perf_counter() - t) * 1e3
    wrong["array_intersect plain"] = int(
        (pm != mask).any(dim=1).sum().item() + (pc != count).sum().item())
    del mask, count, pm, pc
    pos = torch.arange(4096, device=dev)
    want = (pos[None, :] < torch.from_numpy(a_card).to(dev)[:, None]) \
        .to(torch.int32).sub_(want)
    keep, diff = timed("array_difference",
                       lambda: array_ops.array_difference(av, ac, bv, bc))
    wrong["array_difference"] = int(
        (keep != want).any(dim=1).sum().item()
        + (diff.cpu().numpy() != a_card - inter).sum())
    checked["array_intersect"] = checked["array_difference"] = m
    trace("array_difference",
          lambda: array_ops.array_difference(av, ac, bv, bc))
    del keep, diff, want
    torch.cuda.synchronize(dev)
    launches = {**_section4_counts(), **_convert_counts()}
    peak = torch.cuda.max_memory_allocated(dev)    # the surface ends here
    mean_card = float(ac.to(torch.float64).mean()), float(
        bc.to(torch.float64).mean())
    del av, ac, bv, bc
    torch.cuda.empty_cache()

    calls = {name: dict(calls=len(ls), p50_ms=float(np.percentile(ls, 50)),
                        p99_ms=float(np.percentile(ls, 99)))
             for name, ls in lat.items()}
    for name, c in calls.items():
        log(f"  {name:22s} p50 {c['p50_ms']:9.3f} ms  p99 "
            f"{c['p99_ms']:9.3f} ms  ({c['calls']} calls, "
            f"{checked[name]} rows checked)")
    log(f"  inputs and oracles {t_inputs:.1f} s; array rows {m} a side, "
        f"mean cards {mean_card[0]:.1f} / {mean_card[1]:.1f}; plain "
        f"array_intersect at that size {plain_ms:.1f} ms")
    log(f"  wrong {wrong}")
    log(f"  launches {launches}; max_memory_allocated {peak}")
    if any(wrong.values()):
        failures.append(f"ops surface: answers differ from the oracle: "
                        f"{wrong}")
    missing = [k for k in (*SECTION4_KERNELS, "popcount", "bitset_set_many")
               if launches[k] == 0]
    if missing:
        failures.append(f"ops surface: kernels never launched: {missing}")
    return dict(ops=calls, traces=traces, wrong=wrong, checked=checked,
                launches=launches, array_rows=m, mean_cards=mean_card,
                plain_array_intersect_ms=plain_ms, inputs_s=t_inputs,
                max_memory_allocated=peak)


# ---------------------------------------------------------------------------
# phase 9: the sharded paths at real scale
# ---------------------------------------------------------------------------

SHARDS = 4
_IDS_KERNELS = ("score_ids_kernel", "select_ids_kernel")


def _shard_rows(shards) -> dict:
    return dict(uploaded=[st.rows_uploaded for st in shards.stats],
                patched=[st.rows_patched for st in shards.stats])


def phase_sharded(dev, ctx, sim_cases, keep, failures):
    """The sharded paths on phase 3's index (2^24 documents, 1,024 terms,
    the 2 GiB arena; nothing cut) over a ``WideMesh`` of four shards on
    the card: the shard slabs built (about 2 GiB more), phase 4's queries
    through ``similar(mesh=)``, each equal to phase 4's single-device
    answer (itself held against the numpy oracle) and launching the
    score-over-ids kernel S times and the labelled select S + 1 times; a
    warm re-query pass that uploads no row; phase 3's classes through
    ``execute_plans(mesh=)``, equal to phase 3's answers; a sharded
    ``QueryServer`` over a share of phase 5's traffic with one
    ``slab_mismatch``; ``reduce_or(mesh=)`` of phase 7's tensor, equal to
    its single-device union; one profiler window; and last one mutated
    term, after which only the owning shard patches and the sharded
    answer equals the single-device one."""
    from repro_torch.core import aggregate
    from repro_torch.dist import WideMesh
    from repro_torch.kernels import segment_ops as so
    from repro_torch.kernels import topk_ops as tk
    from repro_torch.serve import FaultInjector, QueryServer
    index = ctx["index"]
    arena = index.arena
    mesh = WideMesh([dev] * SHARDS)
    _reset_counts()                         # the sharded path starts here
    mem0 = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    shards = arena.shard_slabs(mesh)
    shards.sync()
    slabs_s = time.perf_counter() - t
    slab_bytes = shards.assembled().numel() * 4
    rows0 = _shard_rows(shards)
    t = time.perf_counter()
    index._sim_engine(mesh)
    engine_s = time.perf_counter() - t
    log(f"  shard slabs: {slab_bytes} bytes in {slabs_s:.2f} s, rows "
        f"{rows0['uploaded']}; sharded engine build {engine_s:.2f} s")

    # similarity: phase 4's queries, each against phase 4's answer
    wrong, bad_launch, lat = 0, 0, {}
    for c in sim_cases:
        n0 = dict(tk.launches_by_stage)
        t = time.perf_counter()
        got = index.similar(c["term"], c["k"], c["metric"], mesh=mesh)
        lat.setdefault((c["metric"], c["k"]), []).append(
            (time.perf_counter() - t) * 1e3)
        wrong += not _same_sim(got, c["answer"])
        d = {k: tk.launches_by_stage[k] - n0[k] for k in n0}
        bad_launch += d != dict(score=0, select=0, score_ids=SHARDS,
                                select_ids=SHARDS + 1)
    up0 = _shard_rows(shards)["uploaded"]
    rewrong = sum(not _same_sim(index.similar(c["term"], c["k"],
                                              c["metric"], mesh=mesh),
                                c["answer"]) for c in sim_cases[::8])
    warm_uploaded = sum(_shard_rows(shards)["uploaded"]) - sum(up0)
    classes = {}
    for (metric, k), ls in sorted(lat.items()):
        classes[f"{metric}/k={k}"] = dict(
            queries=len(ls), p50_ms=float(np.percentile(ls, 50)),
            p99_ms=float(np.percentile(ls, 99)))
    qs = [c for c in sim_cases if c["k"] == 10][:16]
    tr = _traced("sharded similar", lambda: [
        index.similar(c["term"], c["k"], c["metric"], mesh=mesh)
        for c in qs], dev, _IDS_KERNELS)
    sim = dict(queries=len(sim_cases), wrong=wrong, bad_launch=bad_launch,
               rewrong=rewrong, warm_rows_uploaded=warm_uploaded,
               classes=classes, window=dict(
                   queries=len(qs), wall_us=tr["wall_us"],
                   busy_us=tr["busy_us"], kernel_us=tr["kernel_us"],
                   name_us=tr["name_us"], h2d_bytes=tr["h2d_bytes"],
                   idle_share=tr["idle_share"]))
    for name, cl in classes.items():
        log(f"  similar(mesh=) {name:18s} p50 {cl['p50_ms']:.3f} ms  p99 "
            f"{cl['p99_ms']:.3f} ms  ({cl['queries']} queries)")
    idle = tr["idle_share"]
    log(f"  {len(sim_cases)} sharded queries: wrong {wrong}, not launching "
        f"S and S + 1 {bad_launch}; warm re-query of "
        f"{len(sim_cases[::8])}: wrong {rewrong}, rows uploaded "
        f"{warm_uploaded}; window of {len(qs)}: busy "
        f"{tr['busy_us'] / 1e3:.3f} ms of {tr['wall_us'] / 1e3:.3f} ms, "
        f"kernels {tr['kernel_us'] / 1e3:.3f} ms, idle "
        + (f"{idle:.4f}" if idle is not None else "not measured"))
    if wrong or rewrong:
        failures.append(f"sharded similar: {wrong} + {rewrong} answers "
                        f"differ from the single-device answers")
    if bad_launch:
        failures.append(f"sharded similar: {bad_launch} queries did not "
                        f"launch score_ids S and select_ids S + 1 times")
    if warm_uploaded:
        failures.append(f"sharded similar: a warm re-query uploaded "
                        f"{warm_uploaded} rows")

    # boolean: phase 3's classes through execute_plans(mesh=)
    boolean = {}
    for cls in CLASSES:
        plans = [_plan(index, cls, q) for q in ctx["traffic"][cls]]
        n0 = so.launches
        t = time.perf_counter()
        outs = aggregate.execute_plans(plans, mesh=mesh)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t) * 1e3
        bad = sum(not np.array_equal(_to_packed(g), w)
                  for g, w in zip(outs, ctx["answers"][cls]))
        boolean[cls] = dict(queries=len(plans), coalesced_ms=ms,
                            launches=so.launches - n0, wrong=bad)
        log(f"  execute_plans(mesh=) {cls:12s} {ms:8.1f} ms, "
            f"{so.launches - n0} segment_reduce launches, wrong {bad}")
        if bad:
            failures.append(f"sharded {cls}: {bad} answers differ from "
                            f"phase 3's")
    up1 = _shard_rows(shards)["uploaded"]
    if up1 != up0:
        failures.append(f"sharded boolean queries uploaded rows "
                        f"{up0} -> {up1}")

    # the server: a share of phase 5's traffic, one slab_mismatch
    work = [(cls, q, ctx["answers"][cls][i]) for cls in CLASSES
            for i, q in enumerate(ctx["traffic"][cls][:8])]
    work += [("similar", c, c["answer"]) for c in sim_cases
             if c["k"] == 10 and not c["term"].startswith("unknown")][::6]
    srv = QueryServer(index, mesh=mesh, faults=FaultInjector.script(
        {"slab_mismatch": [True]}))
    t = time.perf_counter()
    tickets = [srv.submit(_ticket_query(cls, q)) for cls, q, _ in work]
    srv.run_until_idle()
    torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t
    st = srv.stats()
    srv_wrong = _check_tickets(tickets, [(c, w) for c, _, w in work],
                               _to_packed, "sharded server", failures)
    lat_t = [tk_.telemetry.latency * 1e3 for tk_ in tickets]
    server = dict(tickets=len(tickets), wrong=srv_wrong, stats=st.as_dict(),
                  run_s=run_s, tickets_per_s=len(tickets) / run_s,
                  p50_ms=float(np.percentile(lat_t, 50)),
                  p99_ms=float(np.percentile(lat_t, 99)))
    log(f"  sharded server: {len(tickets)} tickets in {run_s:.2f} s "
        f"({server['tickets_per_s']:.1f}/s), wrong {srv_wrong}, replans "
        f"{st.replans}, rows_repatched {st.rows_repatched}, host_fallbacks "
        f"{st.host_fallbacks}")
    if st.replans != 1 or st.host_fallbacks or st.dispatch_retries:
        failures.append(f"sharded server: {st}")

    # reduce_or(mesh=) of phase 7's tensor
    tensor = keep.pop("tensor")
    union = keep.pop("union")
    n0 = so.launches
    t = time.perf_counter()
    res = tensor.reduce_or(mesh=mesh)
    torch.cuda.synchronize(dev)
    ro_ms = (time.perf_counter() - t) * 1e3
    ro_wrong = int(not np.array_equal(_to_packed(res.to_bitmaps()[0]),
                                      union))
    reduce_or = dict(ms=ro_ms, launches=so.launches - n0, wrong=ro_wrong)
    log(f"  reduce_or(mesh=): {ro_ms:.1f} ms, {so.launches - n0} launches, "
        f"wrong {ro_wrong}")
    if ro_wrong:
        failures.append("sharded reduce_or differs from the single-device "
                        "union")
    del tensor, res
    torch.cuda.empty_cache()

    # one mutated term: only the owning shard patches
    term = "s0"
    bm = index.postings[term]
    vals = bm.to_array()
    doc = int(np.setdiff1d(np.arange(int(vals[0]), int(vals[0]) + 64),
                           vals)[0])
    bm.add(doc)
    p0 = _shard_rows(shards)["patched"]
    got = index.similar(term, 10, "jaccard", mesh=mesh)
    want = index.similar(term, 10, "jaccard")
    p1 = _shard_rows(shards)["patched"]
    patched = [b - a for a, b in zip(p0, p1)]
    mut_wrong = int(not _same_sim(got, want))
    log(f"  one edit of {term}: rows patched per shard {patched}, wrong "
        f"{mut_wrong}")
    if sum(patched) != 1 or max(patched) != 1 or mut_wrong:
        failures.append(f"sharded refresh: patched {patched}, wrong "
                        f"{mut_wrong}")
    bm.remove(doc)                  # later phases hold phase 3's oracle

    launches = {**dict(tk.launches_by_stage), "segment_reduce":
                so.launches}                # the sharded path ends here
    mem = torch.cuda.memory_allocated(dev) - mem0
    log(f"  launches {launches}; shard slabs and engines hold +{mem} bytes")
    if min(launches[k] for k in (*IDS_STAGES, "segment_reduce")) == 0:
        failures.append(f"sharded: a kernel never launched {launches}")
    return dict(shards=SHARDS, slab_bytes=slab_bytes, slabs_s=slabs_s,
                engine_s=engine_s, rows_at_build=rows0, similarity=sim,
                boolean=boolean, server=server, reduce_or=reduce_or,
                edit=dict(term=term, patched=patched, wrong=mut_wrong),
                launches=launches, allocated_delta=mem)


# ---------------------------------------------------------------------------
# phase 11: cold start and ingest
# ---------------------------------------------------------------------------

FORMATS = ("rj02", "portable", "frozen")
PIPE = dict(n_docs=N_DOCS, seq_len=4096, batch_size=256, vocab=256_000)
PIPE_BATCHES = 8


def _all_counts() -> dict:
    """Launches of every kernel since the last reset, by kernel."""
    from repro_torch.kernels import (
        array_ops, bitset_convert, bitset_ops, block_sparse_attn, harley_seal,
        pair_ops, segment_ops, topk_ops,
    )
    out = {"segment_reduce": segment_ops.launches, **topk_ops.launches_by_stage}
    for mod in (pair_ops, array_ops, bitset_convert, harley_seal, bitset_ops):
        out.update(mod.launches_by_kernel)
    out["decode_attention"] = block_sparse_attn.launches
    return {k: v for k, v in out.items() if v}


def _file_digest(path) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _boolean_wrong(index, traffic, answers, per_class=QUERIES):
    """Answers of the first ``per_class`` queries of each class that differ
    from ``answers``, by class."""
    return {cls: sum(not np.array_equal(_to_packed(_run_query(index, cls, q)),
                                        want)
                     for q, want in zip(traffic[cls][:per_class],
                                        answers[cls][:per_class]))
            for cls in CLASSES}


def _reload(dev, path, ctx, sim_cases, failures):
    """Item 1: the whole index mapped back from its snapshot archive onto
    a fresh arena, then phase 3's boolean classes and phase 4's k = 10
    similarity queries on it."""
    from repro_torch.core import BitmapArena
    from repro_torch.data.index import load_index
    _reset_counts()
    digest = _file_digest(path)
    t = time.perf_counter()
    arena = BitmapArena(device=dev)
    index = load_index(path, arena=arena)
    arena.sync()
    torch.cuda.synchronize(dev)
    open_s = time.perf_counter() - t
    q0 = ctx["traffic"]["and"][0]
    first = index.query_and(*q0["terms"])
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t
    wrong = {"first": int(not np.array_equal(_to_packed(first),
                                             ctx["answers"]["and"][0]))}
    t = time.perf_counter()
    wrong.update(_boolean_wrong(index, ctx["traffic"], ctx["answers"]))
    boolean_s = time.perf_counter() - t
    # the in-memory index's own answers on the first queries of a class
    mem = ctx["index"]
    wrong["vs_in_memory"] = sum(
        _run_query(index, cls, q) != _run_query(mem, cls, q)
        for cls in CLASSES for q in ctx["traffic"][cls][:4])
    sims = [c for c in sim_cases if c["k"] == 10]
    t = time.perf_counter()
    wrong["similar"] = sum(not _same_sim(index.similar(c["term"], 10,
                                                       c["metric"]),
                                         c["answer"]) for c in sims)
    similar_s = time.perf_counter() - t
    wrong["similar_vs_in_memory"] = sum(
        index.similar(c["term"], 10, c["metric"]) !=
        mem.similar(c["term"], 10, c["metric"]) for c in sims[::16])
    up0 = arena.stats.rows_uploaded
    warm = _boolean_wrong(index, ctx["traffic"], ctx["answers"], 8)
    warm_uploads = arena.stats.rows_uploaded - up0
    wrong["warm"] = sum(warm.values())
    unchanged = _file_digest(path) == digest
    launches = _all_counts()
    out = dict(open_s=open_s, first_answer_s=first_s, boolean_s=boolean_s,
               similar_s=similar_s, similar_queries=len(sims),
               arena_rows=arena.n_rows, warm_uploads=warm_uploads,
               file_unchanged=unchanged, wrong=wrong, launches=launches)
    log(f"  reload: open {open_s:.2f} s (load_index + arena upload of "
        f"{arena.n_rows} rows), first answer {first_s:.2f} s; "
        f"{QUERIES} queries a class {boolean_s:.1f} s, {len(sims)} similar "
        f"{similar_s:.1f} s; wrong {wrong}; warm re-query uploads "
        f"{warm_uploads} rows; file unchanged {unchanged}; launches "
        f"{launches}")
    if any(wrong.values()):
        failures.append(f"reload: answers differ {wrong}")
    if warm_uploads or not unchanged:
        failures.append(f"reload: warm uploads {warm_uploads}, file "
                        f"unchanged {unchanged}")
    if not launches.get("segment_reduce") or not launches.get("select"):
        failures.append(f"reload: a kernel never launched {launches}")
    del index, arena, mem
    return out


def _same_set(a, b) -> bool:
    """Whether two bitmaps hold the same set: the same keys, and each pair
    of containers the same payload where their kinds match (words, sorted
    values or maximal runs), else the same values."""
    if a.keys != b.keys:
        return False
    for x, y in zip(a.containers, b.containers):
        if x.kind != y.kind:
            same = np.array_equal(x.to_array_values(), y.to_array_values())
        else:
            same = np.array_equal(*(c.words if c.kind == "bitset" else
                                    c.values if c.kind == "array" else
                                    c.runs for c in (x, y)))
        if not same:
            return False
    return True


def _round_trips(postings, failures):
    """Item 2: every posting through the three formats."""
    from repro_torch.core import RoaringBitmap, serde
    t = time.perf_counter()
    bad, nbytes = {f: 0 for f in FORMATS}, {f: 0 for f in FORMATS}
    for bm in postings.values():
        for fmt in FORMATS:
            buf = bm.serialize(fmt)
            nbytes[fmt] += len(buf)
            back = RoaringBitmap.deserialize(buf, format=fmt)
            bad[fmt] += (not _same_set(back, bm)
                         or serde.serialized_size_bytes(bm, fmt) != len(buf))
    secs = time.perf_counter() - t
    log(f"  round trips of {len(postings)} postings: {secs:.1f} s; bytes "
        f"{nbytes}; wrong {bad}")
    if any(bad.values()):
        failures.append(f"round trips: {bad}")
    return dict(seconds=secs, bytes=nbytes, wrong=bad)


def _sparse_traffic(seed, terms, per_class=8):
    """Boolean queries over the sparse terms alone (K in [2, 8]), and one
    union of every sparse term."""
    rng = np.random.default_rng(seed + 11)
    traffic = {c: [] for c in CLASSES}
    for _ in range(per_class):
        for cls in CLASSES:
            k = int(rng.integers(2, 9))
            q = dict(terms=[str(t) for t in rng.choice(terms, k,
                                                       replace=False)])
            if cls == "threshold":
                q["t"] = int(rng.integers(1, k + 1))
            elif cls == "threshold_w":
                q["weights"] = [int(x) for x in rng.integers(1, 5, k)]
                q["t"] = int(rng.integers(2, sum(q["weights"]) + 1))
            traffic[cls].append(q)
    traffic["or"].append(dict(terms=list(terms)))
    return traffic


def _ingest(dev, tmp, ctx, seed, failures):
    """Item 3: the 960 sparse terms' postings, and the two dense terms of
    lowest document frequency at or above 20%, streamed through
    StreamingIndexBuilder in eight batches of documents in id order, each
    batch boundary half way through a chunk, with a segment_bytes that
    spills at least four segments; then finalize onto a fresh arena.  A
    chunk cut by a batch boundary that is also a segment boundary reaches
    the merge in two parts: the sparse terms' parts union on the host (the
    planner's rule for arrays), the dense terms' (a bitset of more than
    4,096 values each) on the card, in segment_reduce.  Every posting must
    equal the in-memory index's, sparse queries its answers, and a sample
    of them and the union of every sparse term the oracle's."""
    from repro_torch.core import BitmapArena
    from repro_torch.data.pipeline import StreamingIndexBuilder
    sets, postings = ctx["sets"], ctx["postings"]
    terms = [t for t in postings if t[0] == "s"]
    dense = sorted((t for t in postings if t[0] == "d"
                    and postings[t].cardinality >= N_DOCS // 5),
                   key=lambda t: postings[t].cardinality)[:2]
    ids = {t: sets[t] for t in terms}
    for t in dense:
        ids[t] = np.flatnonzero(np.unpackbits(
            sets[t].view(np.uint8), bitorder="little")).astype(np.uint32)
    total = sum(v.size for v in ids.values()) * 4
    edges = [0] + [b * (N_DOCS // 8) + (1 << 15) for b in range(1, 8)]
    edges.append(N_DOCS)
    _reset_counts()
    t = time.perf_counter()
    builder = StreamingIndexBuilder(tmp / "stream.snap",
                                    segment_bytes=total // 6)
    for lo, hi in zip(edges[:-1], edges[1:]):
        for term, v in ids.items():
            builder.append_postings(term, v[np.searchsorted(v, lo):
                                            np.searchsorted(v, hi)])
    segments = len(builder._segments) + bool(builder._pend)
    append_s = time.perf_counter() - t
    arena = BitmapArena(device=dev)
    t = time.perf_counter()
    index = builder.finalize(arena=arena)
    arena.sync()
    torch.cuda.synchronize(dev)
    finalize_s = time.perf_counter() - t
    finalize_launches = _all_counts()
    wrong = {"postings": sum(not _same_set(index.postings[t], postings[t])
                             for t in ids),
             "n_docs": int(index.n_docs != int(max(v.max()
                                                   for v in ids.values()))
                           + 1)}
    traffic = _sparse_traffic(seed, terms)
    union = traffic["or"].pop()
    oracle = Oracle(sets, N_DOCS // 64)
    t = time.perf_counter()
    for cls in CLASSES:
        wrong[cls] = 0
        for i, q in enumerate(traffic[cls]):
            got = _run_query(index, cls, q)
            wrong[cls] += got != _run_query(ctx["index"], cls, q)
            if i < 4:
                wrong[cls] += not np.array_equal(_to_packed(got),
                                                 oracle.answer(cls, q))
    got = _run_query(index, "or", union)
    wrong["union"] = int(not np.array_equal(
        got.to_array(), np.unique(np.concatenate([sets[t] for t in terms]))))
    query_s = time.perf_counter() - t
    launches = _all_counts()
    out = dict(ids=total // 4, dense_terms=dense,
               segment_bytes=total // 6, segments=segments,
               append_s=append_s, finalize_s=finalize_s, query_s=query_s,
               queries={c: len(q) for c, q in traffic.items()},
               union_terms=len(union["terms"]),
               archive_bytes=os.path.getsize(tmp / "stream.snap"),
               finalize_launches=finalize_launches, launches=launches,
               wrong=wrong)
    log(f"  ingest: {total // 4} ids of {len(terms)} sparse and "
        f"{len(dense)} dense terms in {segments} segments, appends {append_s:.1f} s, finalize "
        f"(merge, archive, load_index, arena upload) {finalize_s:.1f} s, "
        f"queries {query_s:.1f} s; wrong {wrong}; launches in finalize "
        f"{finalize_launches}, with the queries {launches}")
    if any(wrong.values()):
        failures.append(f"ingest: answers differ {wrong}")
    if segments < 4:
        failures.append(f"ingest: only {segments} segments")
    if not finalize_launches.get("segment_reduce") or \
            launches["segment_reduce"] <= finalize_launches["segment_reduce"]:
        failures.append(f"ingest: segment_reduce did not launch in both "
                        f"finalize {finalize_launches} and the queries "
                        f"{launches}")
    del index, arena
    return out


def _pipeline(dev, seed, failures):
    """Item 4: the training data pipeline over 2^24 documents with a
    quality and a dedup filter, 8 batches, a state_dict round trip after
    the 4th."""
    from repro_torch.data.pipeline import (
        RoaringDataPipeline, dedup_filter, quality_filter,
    )
    rng = np.random.default_rng(seed + 12)
    scores = rng.random(N_DOCS)
    hashes = rng.integers(0, N_DOCS, N_DOCS)
    _reset_counts()
    t = time.perf_counter()
    filters = {"quality": quality_filter(scores, 0.5),
               "dedup": dedup_filter(hashes)}
    pipe = RoaringDataPipeline(**PIPE, seed=seed, filters=filters,
                               device=dev)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t
    lowest = np.full(N_DOCS, N_DOCS)        # each hash's first document
    np.minimum.at(lowest, hashes, np.arange(N_DOCS))
    first = np.zeros(N_DOCS, bool)
    first[lowest[lowest < N_DOCS]] = True
    keep = (scores >= 0.5) & first
    n_keep = int(keep.sum())
    wrong = {"keep": int(pipe.keep.cardinality != n_keep or not
                         np.array_equal(pipe.keep.to_array(),
                                        np.flatnonzero(keep)))}
    drawn, lat = [], []
    for i in range(PIPE_BATCHES):
        if i == 4:
            state = pipe.state_dict()
            twin = RoaringDataPipeline(**PIPE, seed=seed, filters=filters,
                                       device=dev)
            twin.load_state_dict(state)
        t = time.perf_counter()
        batch = pipe.next_batch()
        lat.append((time.perf_counter() - t) * 1e3)
        if i >= 4:
            other = twin.next_batch()
            wrong.setdefault("resumed", 0)
            wrong["resumed"] += not all(np.array_equal(other[k], batch[k])
                                        for k in batch)
        ids = batch["doc_ids"]
        drawn.extend(ids.tolist())
        wrong.setdefault("shape", 0)
        wrong["shape"] += (batch["tokens"].shape != (256, 4096)
                           or not np.array_equal(batch["tokens"][:, 1:],
                                                 batch["labels"][:, :-1]))
        wrong.setdefault("outside_keep", 0)
        wrong["outside_keep"] += int((~keep[ids]).sum())
    wrong["repeats"] = len(drawn) - len(set(drawn))
    remaining = pipe.remaining()
    wrong["remaining"] = int(remaining != n_keep - len(drawn)
                             or twin.remaining() != remaining)
    launches = _all_counts()
    out = dict(build_s=build_s, keep=n_keep, drawn=len(drawn),
               remaining=remaining, batch_p50_ms=float(np.median(lat)),
               batch_ms=lat, wrong=wrong, launches=launches)
    log(f"  pipeline: filters and keep {build_s:.1f} s ({n_keep} of "
        f"{N_DOCS} kept); {PIPE_BATCHES} batches of 256 x 4,096 tokens, p50 "
        f"{out['batch_p50_ms']:.1f} ms; remaining {remaining}; wrong "
        f"{wrong}; launches {launches}")
    if any(wrong.values()):
        failures.append(f"pipeline: {wrong}")
    if not launches:
        failures.append("pipeline: no kernel launched")
    return out


def phase_cold_start(dev, ctx, sim_cases, seed, failures):
    """Phase 11: the whole index through a snapshot archive and back, every
    posting through the three formats, the sparse terms streamed into a
    second archive, and the data pipeline; temporary files in a directory
    removed at the end."""
    import shutil
    import tempfile
    from repro_torch.core import serde
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        path = tmp / "index.snap"
        t = time.perf_counter()
        nbytes = serde.write_snapshot(path, ctx["postings"], meta=N_DOCS)
        write_s = time.perf_counter() - t
        log(f"  write_snapshot of {len(ctx['postings'])} postings: "
            f"{nbytes} bytes, {write_s:.2f} s")
        out = dict(archive_bytes=nbytes, write_s=write_s)
        out["reload"] = _reload(dev, path, ctx, sim_cases, failures)
        gc.collect()
        torch.cuda.empty_cache()
        out["round_trips"] = _round_trips(ctx["postings"], failures)
        out["ingest"] = _ingest(dev, tmp, ctx, seed, failures)
        gc.collect()
        torch.cuda.empty_cache()
        out["pipeline"] = _pipeline(dev, seed, failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 2g: the decode attention kernel against its plain version
# ---------------------------------------------------------------------------

LIVE = dict(b=4, h=32, hkv=16, d=128, s=8192, bs=128)   # Gemma2-27B decode
BSA_KERNELS = ("decode_attention_split", "decode_attention_combine")
PINNED = (2, 17, 29)          # phase 2g's pinned blocks on row 0


def _engine_mask(dev, kv_lens, s, bs, pinned=PINNED):
    """The serving engine's mask words for ``kv_lens``: ``BlockPolicy(1,
    8)`` (sink 1 + local 8), with ``pinned`` blocks on row 0 only."""
    from repro_torch.core import RoaringBitmap
    from repro_torch.core.tensor import block_mask_words
    from repro_torch.serve import BlockPolicy
    pol = BlockPolicy(1, 8)
    pin = BlockPolicy(1, 8, RoaringBitmap.from_values(list(pinned)))
    sets = [(pin if i == 0 else pol).visible_set(kl, bs, device=dev)
            for i, kl in enumerate(kv_lens)]
    return block_mask_words(sets, s // bs, device=dev)


def _bsa_inputs(dev, gen, b, h, hkv, d, s, bs, dtype=torch.bfloat16,
                kv_len=None, words=None):
    """q, k, v from ``gen`` on the card (k scaled by 0.3, as the JAX kernel
    test draws it), mask words (default: the engine's mask) and kv_len
    (default: different on each row, 5,121 + 13 i at S = 8,192 as after a
    5,120-token prompt, else S - 1 - 97 i)."""
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    k = (torch.randn((b, hkv, s, d), generator=gen, device=dev)
         * 0.3).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    if kv_len is None:
        kv_len = [5121 + 13 * i if s >= 8192 else max(1, s - 1 - 97 * i)
                  for i in range(b)]
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    if words is None:
        words = _engine_mask(dev, kv_len, s, bs)
    return q, k, v, words, kvl


def _visible_positions(words, kvl, s, bs):
    """(B, S) bool: position visible (its block's bit set, below kv_len)."""
    from repro_torch.kernels.ref import block_mask_bits
    pos = torch.arange(s, device=words.device)
    vis = block_mask_bits(words, s // bs)[:, pos // bs]
    return vis & (pos[None, :] < kvl[:, None])


def _bsa_bound(q, k, words, kvl, bs):
    """Least time for one call, in ms, and what bounds it: the K and V
    rows at visible valid positions read once, q read, the output
    written, the mask words and kv_len read once, over the HBM rate;
    against 4 * g * D float32 operations a visible key and head group
    over the fp32 rate (67 T/s)."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    n_vis = int(_visible_positions(words, kvl, s, bs).sum())
    el = q.element_size()
    nbytes = (2 * n_vis * hkv * d * el + 2 * b * h * d * el
              + words.numel() * 4 + kvl.numel() * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * n_vis * h * d / INT_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            nbytes, n_vis)


def _bf16_ulp_ratio(got, want):
    """The largest |got - want| over one bfloat16 ulp of the largest
    magnitude of ``want`` in its (sequence, head) row; the bf16 check
    holds it to at most 1.  The kernel and the plain version sum the same
    float32 terms in other orders, an error that scales with the row's
    magnitude: an element near 0 after cancellation can differ by more
    than its own ulp, never by more than the row's."""
    g, w = got.float(), want.float()
    top = w.abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float(((g - w).abs() / ulp).max()) if g.numel() else 0.0


def _sdpa(q, k, v, words, kvl, bs, scale):
    """One ``F.scaled_dot_product_attention`` call over the expanded
    boolean mask (the library yardstick; softcap 0 only, rows with a
    visible position only)."""
    import torch.nn.functional as F
    vis = _visible_positions(words, kvl, k.shape[2], bs)
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=vis[:, None, None, :],
        scale=scale, enable_gqa=True)[:, :, 0, :]


def _partials_err(part, plain):
    """The largest |kernel - plain| over the split step's (m, l, acc)
    rows, each over its row's largest magnitude (at least 1)."""
    scale = plain.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    return float(((part - plain).abs() / scale).max())


def phase_bsa_kernel(dev, seed, failures):
    """The Roaring block-sparse decode attention kernel against its plain
    version at Gemma2-27B's decode shape and at edge cases (see the module
    docstring, phase 2g).  float32: atol = rtol = 2e-5; bfloat16: within
    one bf16 ulp of each (sequence, head) row's largest output; rows with
    no visible position exactly 0.  The split count P: the wrapper's at
    the live shape, forced to 1, 4, 9, 16 and S / bs there (each timed),
    1 at B = 64.  The
    live case twice, bit for bit; where P > 1 the kernel's partials
    against ``ref.decode_attention_partials`` (within 2e-5 of each row's
    largest magnitude) and the plain merge of them against the kernel's
    output (phase 2g's limits)."""
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels import ref
    gen = torch.Generator(dev).manual_seed(seed + 17)
    L = LIVE
    full_words = torch.full((L["b"], 2), -1, dtype=torch.int32, device=dev)
    n_live_blocks = L["s"] // L["bs"]
    cases = [
        ("live", dict(L), 50.0, {}, None),
        ("live/P=1", dict(L), 50.0, {}, 1),
        ("live/P=4", dict(L), 50.0, {}, 4),
        ("live/P=9", dict(L), 50.0, {}, 9),
        ("live/P=16", dict(L), 50.0, {}, 16),
        (f"live/P={n_live_blocks}", dict(L), 50.0, {}, n_live_blocks),
        ("live/softcap=0", dict(L), 0.0, {}, None),
        ("live/softcap=0/full", dict(L), 0.0, dict(words=full_words), None),
        ("jamba (g=4)", dict(L, hkv=8), 0.0, {}, None),
        ("empty mask", dict(L, s=2048), 50.0, dict(
            words=torch.zeros((4, 1), dtype=torch.int32, device=dev)), None),
        ("kv_len 0/1/mid/S, bits past kv_len", dict(L, s=2048), 50.0, dict(
            kv_len=[0, 1, 1000, 2048], words=torch.full(
                (4, 1), -1, dtype=torch.int32, device=dev)), None),
        ("every bit set", dict(L, s=2048), 50.0, dict(words=torch.full(
            (4, 1), -1, dtype=torch.int32, device=dev)), None),
        ("float32", dict(L, s=2048), 50.0, dict(dtype=torch.float32), None),
        ("float32/softcap=0", dict(L, s=2048), 0.0,
         dict(dtype=torch.float32), None),
        ("float32/P=16", dict(L, s=2048), 50.0, dict(
            dtype=torch.float32, kv_len=[0, 70, 1000, 2048]), 16),
        ("g=1", dict(L, h=16, s=2048), 50.0, {}, None),
        ("g=2 (live)", dict(L, s=2048), 50.0, {}, None),
        ("g=8", dict(L, h=128, s=2048), 50.0, {}, None),
        ("D=64", dict(L, d=64, s=2048), 50.0, {}, None),
        ("D=256", dict(L, d=256, s=2048), 50.0, {}, None),
        ("block 256", dict(L, s=2048, bs=256), 50.0, {}, None),
        ("B=1", dict(L, b=1, s=2048), 50.0, {}, None),
        ("B=64", dict(L, b=64, s=2048), 50.0, dict(
            kv_len=[1 + 31 * i for i in range(64)]), None),
    ]
    rows, max_err = [], 0.0
    for name, shape, softcap, kw, splits in cases:
        bs = shape["bs"]
        dims = {k_: v_ for k_, v_ in shape.items() if k_ != "bs"}
        q, k, v, words, kvl = _bsa_inputs(dev, gen, bs=bs, **dims, **kw)
        scale = q.shape[-1] ** -0.5

        def kern():
            return bsa.decode_attention(q, k, v, words, kvl, block_size=bs,
                                        softcap=softcap, splits=splits)

        def plain():
            return ref.block_sparse_attention_decode(
                q, k, v, words, kvl, block_size=bs, softcap=softcap)

        got, again = kern(), kern()
        part = bsa.decode_attention_with_partials(
            q, k, v, words, kvl, block_size=bs, softcap=softcap,
            splits=splits)[1]
        want = plain()
        torch.cuda.synchronize()
        n_split = 1 if part is None else part.shape[2]
        same_bits = torch.equal(got, again)
        err = float((got.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        empty = ~_visible_positions(words, kvl, k.shape[2], bs).any(dim=-1)
        zeros_ok = bool((got[empty] == 0).all())
        ulps = None
        if q.dtype == torch.float32:
            ok = bool(torch.allclose(got, want, atol=2e-5, rtol=2e-5))
        else:
            ulps = _bf16_ulp_ratio(got, want)
            ok = ulps <= 1.0
        part_err = comb_ok = None
        if part is not None:
            part_err = _partials_err(part, ref.decode_attention_partials(
                q, k, v, words, kvl, n_split, block_size=bs,
                softcap=softcap))
            comb = ref.combine_partials(part).to(q.dtype)
            comb_ok = (bool(torch.allclose(comb, got, atol=2e-5, rtol=2e-5))
                       if q.dtype == torch.float32
                       else _bf16_ulp_ratio(comb, got) <= 1.0)
            ok = ok and part_err <= 2e-5 and comb_ok
        ok = ok and zeros_ok and same_bits
        (bound_ms, bound_by), nbytes, n_vis = _bsa_bound(q, k, words, kvl,
                                                         bs)
        row = dict(case=name, dtype=str(q.dtype), shape=list(k.shape),
                   block_size=bs, softcap=softcap, splits=n_split,
                   equal=ok, max_abs_err=err, max_row_ulps=ulps,
                   same_bits=same_bits, partials_err=part_err,
                   combine_ok=comb_ok, empty_rows=int(empty.sum()),
                   visible_positions=n_vis, bytes=nbytes,
                   bound_ms=bound_ms, bound_by=bound_by)
        if name.startswith(("live", "jamba")):
            row.update(ms=_device_ms(kern, 50), plain_ms=_device_ms(plain, 5),
                       event_ms=_time_ms(kern, 50)[1],
                       event_plain_ms=_time_ms(plain, 5)[1])
            row["bound_ratio"] = row["ms"] / bound_ms
            if softcap == 0.0:
                # CUDA events: the profiler window misses the attention
                # kernels PyTorch launches with cuLaunchKernel
                sdpa = _sdpa(q, k, v, words, kvl, bs, scale)
                lib, lib_ms = _time_ms(sdpa, 20)
                row.update(library_ms=lib_ms,
                           library_max_abs_err=float(
                               (lib.float() - want.float()).abs().max()))
            log(f"  {name:36s} P={n_split} ok={ok} err {err:.3g} ({ulps} "
                f"row ulps), partials {part_err}; device: kernel "
                f"{row['ms']:.4f} ms ({row['bound_ratio']:.2f}x bound)  "
                f"plain {row['plain_ms']:.4f} ms"
                + (f"  sdpa {row['library_ms']:.4f} ms"
                   if "library_ms" in row else "")
                + f"; bound {bound_ms:.4f} ms ({bound_by}, {nbytes} bytes,"
                f" {n_vis} visible positions)")
        else:
            log(f"  {name:36s} P={n_split} ok={ok} err {err:.3g} ({ulps} "
                f"row ulps), partials {part_err}, {n_vis} visible "
                f"positions, {int(empty.sum())} empty rows")
        rows.append(row)
        if not ok:
            failures.append(f"decode_attention kernel != plain: {name} "
                            f"(max_abs_err {err}, zero rows ok {zeros_ok}, "
                            f"same bits {same_bits}, partials {part_err}, "
                            f"merge {comb_ok})")
        del q, k, v, got, again, part, want
        torch.cuda.empty_cache()
    rows += _gather_cases(dev, gen, failures)
    bf16_ulps = max(r["max_row_ulps"] for r in rows
                    if r["max_row_ulps"] is not None)
    log(f"  {len(rows)} cases: {sum(r['equal'] for r in rows)} within "
        f"tolerance, max_abs_err {max_err:.3g}, bf16 at most {bf16_ulps} "
        f"row ulps (limit 1); launches so far {bsa.launches}")
    return rows, max_err


def _gather_cases(dev, gen, failures):
    """The ``sparse_topk_blocks`` gather route (plain PyTorch, no kernel of
    its own) against row 17 at Gemma2-27B's decode shape (phase 2g's live
    inputs, softcap 50), with topk at least every row's visible count:
    the largest count (12), and S / bs (every block, the whole cache
    gathered).  float32 within atol = rtol = 2e-5 (summation order),
    bfloat16 within 8 bf16 ulps of each row's largest output (the route
    rounds the softmax weights to bf16 before the PV product, the kernel
    does not).  The route's device time beside the kernel's."""
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels.ref import block_mask_bits
    from repro_torch.models.layers import decode_attention_block_gather
    L = LIVE
    bs, n_blocks = L["bs"], L["s"] // L["bs"]
    dims = {k_: v_ for k_, v_ in L.items() if k_ != "bs"}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, words, kvl = _bsa_inputs(dev, gen, bs=bs, dtype=dtype,
                                          **dims)
        visible = block_mask_bits(words, n_blocks).sum(dim=1).tolist()

        def kern():
            return bsa.decode_attention(q, k, v, words, kvl, block_size=bs,
                                        softcap=50.0)

        want = kern()
        kernel_ms = _device_ms(kern, 50)
        for topk in (max(visible), n_blocks):
            def route():
                return decode_attention_block_gather(
                    q, k, v, kvl, words, block_size=bs, topk=topk,
                    softcap=50.0)

            got = route()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ulps = None
            if dtype == torch.float32:
                ok = bool(torch.allclose(got, want, atol=2e-5, rtol=2e-5))
            else:
                ulps = _bf16_ulp_ratio(got, want)
                ok = ulps <= 8.0
            row = dict(case=f"gather route/{str(dtype)[6:]}/topk={topk}",
                       kernel="decode_attention_block_gather",
                       dtype=str(dtype), shape=list(k.shape), topk=topk,
                       visible_blocks=visible, equal=ok, max_abs_err=err,
                       max_row_ulps=None, gather_row_ulps=ulps,
                       ms=_device_ms(route, 20), kernel_ms=kernel_ms,
                       event_ms=_time_ms(route, 20)[1])
            log(f"  {row['case']:36s} visible blocks {visible}: ok={ok} "
                f"err {err:.3g} ({ulps} row ulps, limit 8 in bf16); "
                f"device: route {row['ms']:.4f} ms, kernel "
                f"{kernel_ms:.4f} ms")
            if not ok:
                failures.append(f"gather route != decode_attention: {row}")
            rows.append(row)
            del got
        del q, k, v, want
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 10: Gemma2-27B serving at full width and depth
# ---------------------------------------------------------------------------

SERVE_B, SERVE_PROMPT, SERVE_MAX_SEQ, SERVE_NEW = 4, 5120, 8192, 32


class _TimedModel:
    """Delegates ``prefill`` and ``decode_step`` to the engine's model,
    timing each with the host clock around a synchronize, counting the
    decode kernel's launches in each prefill, and keeping the first
    prefill's state and logits for the kernel-against-plain check."""

    def __init__(self, model):
        self.model = model
        self.prefill_s, self.step_ms, self.prefill_launches = [], [], []
        self.kept = None

    def prefill(self, *a, **kw):
        from repro_torch.kernels import block_sparse_attn as bsa
        torch.cuda.synchronize()
        n0, t = bsa.launches, time.perf_counter()
        out = self.model.prefill(*a, **kw)
        torch.cuda.synchronize()
        self.prefill_s.append(time.perf_counter() - t)
        self.prefill_launches.append(bsa.launches - n0)
        if self.kept is None:
            self.kept = out
        return out

    def decode_step(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.model.decode_step(*a, **kw)
        torch.cuda.synchronize()
        self.step_ms.append((time.perf_counter() - t) * 1e3)
        return out


def _decode_bound(model, kv_len, words):
    """Least time of one decode step, in ms, and its bytes: every weight
    read once (the tied embedding once, as the head), plus each local
    layer's K and V rows inside its window and each global layer's at
    visible valid positions, over the HBM rate."""
    cfg = model.cfg
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    row = cfg.n_kv_heads * cfg.hd * 2 * 2              # K and V, bf16
    local = sum(min(kl, cfg.sliding_window) for kl in kv_len) * row
    vis = int(_visible_positions(words, torch.tensor(
        kv_len, dtype=torch.int32, device=words.device), SERVE_MAX_SEQ,
        cfg.attn_block_size).sum()) * row
    kinds = [m for m, _ in cfg.layer_kinds]
    nbytes = (w_bytes + kinds.count("local") * local
              + kinds.count("global") * vis)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def _drop_last_block(words, kv_len, bs):
    """``words`` with each row's last visible block below ``kv_len``
    cleared: the planted fault of a kernel that stops one block early."""
    w = words.cpu().numpy().view(np.uint32).copy()
    for r in range(w.shape[0]):
        bits = [i for i in range(-(-kv_len // bs))
                if int(w[r, i // 32]) >> (i % 32) & 1]
        if bits:
            j, b = divmod(bits[-1], 32)
            w[r, j] = np.uint32(int(w[r, j]) & ~(1 << b) & 0xFFFFFFFF)
    return torch.from_numpy(w.view(np.int32)).to(words.device)


def _layer_ulps(calls, fault_words):
    """For each recorded kernel call (q, k, v, words, kv_len, keywords,
    output): the output's row-ulp ratio against the plain version, and the
    plain version's under ``fault_words`` against the same."""
    from repro_torch.kernels import ref
    layer_ulps, fault_ulps = [], []
    for q, k, v, w, kvl, kw, got in calls:
        plain_out = ref.block_sparse_attention_decode(q, k, v, w, kvl, **kw)
        layer_ulps.append(_bf16_ulp_ratio(got, plain_out))
        fault_ulps.append(_bf16_ulp_ratio(ref.block_sparse_attention_decode(
            q, k, v, fault_words, kvl, **kw), plain_out))
    return layer_ulps, fault_ulps


def _phase_model(name, layers, dev, seed):
    """A model of ``name``'s config at full width (cut to ``layers`` where
    given), random bf16 weights from ``seed`` on the card; its config, the
    full config, the parameter count and bytes, and the init seconds."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    full = configs.get_config(name)
    cfg = dataclasses.replace(full, n_layers=layers) if layers else full
    t = time.perf_counter()
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return model, cfg, full, n_params, w_bytes, time.perf_counter() - t


def _lexicon(dev, vocab):
    """Phase 10's constraint (the "digits" and "names" lexicons) and the
    allowed token ids."""
    from repro_torch.serve import lexicon_constraint
    lex = {"digits": np.arange(vocab // 256, vocab // 256 + 100),
           "names": np.arange(vocab // 5, min(vocab, vocab // 5 + 2000))}
    return (lexicon_constraint(vocab, lex, ["digits", "names"], device=dev),
            np.concatenate(list(lex.values())))


def _sum_counts(*counts) -> dict:
    """Launch counts by kernel, added."""
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def _kernel_vs_plain(label, model, state, tok0, words, failures):
    """From ``state``: ``decode_step(backend="ref")`` against the kernel's
    step (logits within 8 bf16 ulps of the largest), and each global
    layer's kernel output against the plain version on the same full-size
    cache (each layer's column was written by this step and nothing has
    written since) within phase 2g's limit; beside them, what each row's
    last visible block cleared (the fault the limits must catch) gives per
    layer and through the whole model.  The kernel's step runs last.
    Returns the logits check."""
    from repro_torch.kernels import block_sparse_attn as bsa
    cfg = model.cfg
    n_global = sum(m == "global" for m, _ in cfg.layer_kinds)
    g = cfg.n_heads // cfg.n_kv_heads
    fault_words = _drop_last_block(words, SERVE_PROMPT + 1,
                                   cfg.attn_block_size)
    # [0]: the returned state shares the caches, and would keep them alive
    ref_logits = model.decode_step(state, tok0, words, backend="ref")[0]
    fault_logits = model.decode_step(state, tok0, fault_words,
                                     backend="ref")[0]
    calls, kernel_fn = [], bsa.decode_attention

    def recorded(q, k, v, w, kvl, **kw):
        out = kernel_fn(q, k, v, w, kvl, **kw)
        calls.append((q, k, v, w, kvl, kw, out))
        return out

    bsa.decode_attention = recorded         # ops reaches it by attribute
    try:
        ker_logits = model.decode_step(state, tok0, words)[0]
    finally:
        bsa.decode_attention = kernel_fn
    torch.cuda.synchronize()
    layer_ulps, fault_ulps = _layer_ulps(calls, fault_words)
    del calls
    layer_check = dict(layers=len(layer_ulps), max_row_ulps=max(
        layer_ulps, default=None), row_ulps=layer_ulps,
        fault_row_ulps=fault_ulps,
        fault_caught=sum(f > 1.0 for f in fault_ulps),
        q_heads_per_kv_head=g)
    log(f"  kernel vs plain in each global layer at the full-size state "
        f"(g = {g}): {len(layer_ulps)} layers, at most "
        f"{layer_check['max_row_ulps']} row ulps (limit 1); a dropped last "
        f"block gives "
        f"{min(fault_ulps, default=0):.4g}-{max(fault_ulps, default=0):.4g}"
        f", over the limit in {layer_check['fault_caught']} layers")
    if len(layer_ulps) != n_global or layer_check["max_row_ulps"] > 1.0:
        failures.append(f"{label}: decode_attention kernel != plain in the "
                        f"global layers {layer_ulps}")
    diff = (ker_logits.float() - ref_logits.float()).abs()
    top = float(ref_logits.float().abs().max())
    tol = 8 * 2.0 ** (np.floor(np.log2(top)) - 7)      # 8 bf16 ulps at top
    agree = float((ker_logits.argmax(-1) == ref_logits.argmax(-1))
                  .float().mean())
    fault_diff = float((fault_logits.float() - ref_logits.float())
                       .abs().max())
    logit_check = dict(max_abs_diff=float(diff.max()),
                       mean_abs_diff=float(diff.mean()), max_abs_logit=top,
                       tolerance=tol, argmax_agreement=agree,
                       finite=bool(torch.isfinite(ker_logits).all()),
                       fault_max_abs_diff=fault_diff, layers=layer_check)
    log(f"  kernel vs plain decode logits: max |diff| "
        f"{logit_check['max_abs_diff']:.4g} (tolerance {tol:.4g}, 8 bf16 "
        f"ulps at max |logit| {top:.4g}), mean "
        f"{logit_check['mean_abs_diff']:.3g}, argmax agreement {agree}; "
        f"a dropped last block moves them {fault_diff:.4g}")
    if not (logit_check["finite"] and logit_check["max_abs_diff"] <= tol):
        failures.append(f"{label}: kernel and plain decode logits differ "
                        f"{logit_check}")
    return logit_check


def _serve_phase(label, model, dev, seed, failures, checks, bound, *,
                 want=0, prompt=SERVE_PROMPT):
    """Phase 10's traffic on ``model``: B = 4 random prompts of ``prompt``
    tokens through ``Engine(max_seq=8192, BlockPolicy(1, 8))``, 32 tokens
    greedily; from the state after the first prefill, a second decode step
    bit-equal to the first, ``checks(state, tok0, words)`` (the phase's
    own checks) and a profiler window over four steps, printed beside
    ``bound(words)`` (the step's least ms and its bytes); then 32 tokens
    under phase 10's lexicon constraint and every page back.

    The decode attention kernel must launch ``want`` times in each
    generate (0 for a model without global layers) and never in a
    prefill.  The caller sets the counts to 0 at the phase's start; they
    are read after the greedy generate (``launch_counts["greedy"]``) and
    after the window (``["served"]``: prefill, greedy decode, the checks
    and the window), set to 0 around the constraint's build (its launches
    read apart, ``["constraint_build"]``) and read after the constrained
    generate (``["constrained"]``).  Returns the end-to-end numbers with
    ``checks``' result."""
    from repro_torch.serve import BlockPolicy, Engine
    cfg = model.cfg
    timed = _TimedModel(model)
    eng = Engine(model, max_seq=SERVE_MAX_SEQ, policy=BlockPolicy(1, 8))
    eng.model = timed
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_B, prompt)).astype(np.int32)

    # 1. greedy generation
    t = time.perf_counter()
    out = eng.generate(prompts, SERVE_NEW)
    gen_s = time.perf_counter() - t
    greedy = _all_counts()
    launches = greedy.get("decode_attention", 0)
    steps = np.asarray(timed.step_ms)
    ok_shape = out.shape == (SERVE_B, SERVE_NEW) and bool(
        ((out >= 0) & (out < cfg.vocab)).all())
    log(f"  generate: {SERVE_B} x {prompt} prompt tokens, {SERVE_NEW} "
        f"new: prefill {timed.prefill_s[0]:.2f} s, decode p50 "
        f"{np.percentile(steps, 50):.2f} ms p99 "
        f"{np.percentile(steps, 99):.2f} ms a step, "
        f"{SERVE_B * SERVE_NEW / (steps.sum() / 1e3):.1f} tokens/s "
        f"decoding, {SERVE_B * SERVE_NEW / gen_s:.1f} end to end; "
        f"decode_attention launches {launches} (want {want}), in prefill "
        f"{timed.prefill_launches[0]}; tokens {out[:, :8].tolist()}")
    if not ok_shape:
        failures.append(f"{label}: tokens {out.shape} outside the vocab")
    if launches != want or timed.prefill_launches[0]:
        failures.append(f"{label}: decode_attention launched {launches} "
                        f"times in generate (want {want}), "
                        f"{timed.prefill_launches[0]} in prefill")

    # 2. from the state after prefill: the same step twice, then the
    # phase's own checks
    p_logits, state = timed.kept
    timed.kept = None
    tok0 = torch.argmax(p_logits, dim=-1).to(torch.int32)
    words = eng._mask_words([prompt + 1] * SERVE_B)
    first = model.decode_step(state, tok0, words)[0]
    again = model.decode_step(state, tok0, words)[0]
    torch.cuda.synchronize()
    same_again = bool(torch.equal(first, again))
    finite = bool(torch.isfinite(first).all())
    log(f"  a second decode step from the state after prefill gives the "
        f"same logits bit for bit: {same_again}; finite {finite}")
    if not (same_again and finite):
        failures.append(f"{label}: a second decode step from the same state "
                        f"gave other logits ({same_again}) or non-finite "
                        f"ones ({finite})")
    del first, again
    extra = checks(state, tok0, words)

    # 3. a profiler window over four decode steps from that state (kv_len
    # prompt + 1 to prompt + 4: one block count, so the same mask words)
    def window():
        st, tok = state, tok0
        for _ in range(4):
            logits, st = model.decode_step(st, tok, words)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)

    names = BSA_KERNELS if want else ()
    tr = _traced(f"{label} decode window", window, dev, names=names)
    # the step's weight products run cuBLASLt kernels launched with
    # cuLaunchKernel: busy and idle come from every device event in the range
    busy = tr["span_busy_us"]
    idle = 1.0 - busy / tr["wall_us"] if tr["complete"] else None
    bound_ms, step_bytes = bound(words)
    win = dict(steps=4, wall_us=tr["wall_us"], busy_us=busy,
               runtime_matched_busy_us=tr["busy_us"],
               cu_launches=tr["cu_launches"], idle_share=idle,
               device_ms_per_step=busy / 4e3,
               top_kernels=tr["span_top_kernels"])
    kernel_note = ""
    if names:
        bsa_us = sum(tr["name_us"][n] for n in names)
        share = bsa_us / busy if busy else None
        win.update(decode_attention_us=bsa_us, decode_attention_split_us=tr[
            "name_us"]["decode_attention_split"],
            decode_attention_share=share)
        kernel_note = (f", decode_attention {bsa_us:.1f} us ("
                       + (f"{share:.4f}" if share is not None
                          else "not measured") + " of busy)")
    log(f"  decode window (4 steps): busy {busy / 1e3:.2f} ms of "
        f"{tr['wall_us'] / 1e3:.2f} ms ({tr['busy_us'] / 1e3:.2f} ms matched "
        f"to runtime launches, {tr['cu_launches']} cuLaunchKernel-level "
        f"calls), idle "
        + (f"{idle:.4f}" if idle is not None else "not measured")
        + kernel_note + f"; step bound {bound_ms:.2f} ms ({step_bytes} "
        f"bytes); top {tr['span_top_kernels'][:6]}")
    del state, p_logits
    torch.cuda.empty_cache()
    served = _all_counts()

    # 4. constrained generation, then every page back
    _reset_counts()
    eng.constraint, allowed = _lexicon(dev, cfg.vocab)
    built = _all_counts()
    _reset_counts()
    cout = eng.generate(prompts, SERVE_NEW)
    constrained = _all_counts()
    c_launches = constrained.get("decode_attention", 0)
    in_set = bool(np.isin(cout, allowed).all())
    eng.release_all()
    free = eng.allocator.n_free == eng.allocator.n_pages
    log(f"  constrained generate: every token in the set {in_set}, "
        f"launches {c_launches}, prefill {timed.prefill_s[-1]:.2f} s; "
        f"after release_all {eng.allocator.n_free} of "
        f"{eng.allocator.n_pages} pages free; the constraint's build "
        f"launched {built or 'no kernel'}")
    if not in_set or not free or c_launches != want:
        failures.append(f"{label}: constrained tokens in set {in_set}, "
                        f"pages free {free}, launches {c_launches}")
    if any(timed.prefill_launches):
        failures.append(f"{label}: decode_attention launched in prefill "
                        f"{timed.prefill_launches}")
    steps = np.asarray(timed.step_ms)
    res = dict(
        batch=SERVE_B, prompt=prompt, max_seq=SERVE_MAX_SEQ,
        new_tokens=SERVE_NEW, generate_s=gen_s, prefill_s=timed.prefill_s,
        step_ms=timed.step_ms,
        decode_p50_ms=float(np.percentile(steps, 50)),
        decode_p99_ms=float(np.percentile(steps, 99)),
        tokens_per_s=SERVE_B * len(steps) / (steps.sum() / 1e3),
        generate_tokens_per_s=SERVE_B * SERVE_NEW / gen_s,
        tokens=out.tolist(), constrained_tokens=cout.tolist(),
        launches_per_generate=[launches, c_launches],
        prefill_launches=timed.prefill_launches,
        launch_counts=dict(greedy=greedy, served=served,
                           constraint_build=built, constrained=constrained),
        same_logits_again=same_again, in_set=in_set, pages_free=free,
        window=win, step_bound_ms=bound_ms, step_bound_bytes=step_bytes)
    res.update(extra)
    del eng, timed
    return res


def phase_serving(dev, seed, failures):
    """Gemma2-27B served at full width and depth (see the module
    docstring, phase 10)."""
    _reset_counts()                       # the serving path starts here
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    model, cfg, _, n_params, w_bytes, init_s = _phase_model(
        "gemma2_27b", 0, dev, seed)
    kinds = [m for m, _ in cfg.layer_kinds]
    n_global = kinds.count("global")
    log(f"  Gemma2-27B: {cfg.n_layers} layers ({kinds.count('local')} "
        f"local, {n_global} global), d {cfg.d_model}, {n_params} "
        f"parameters, {w_bytes} bytes, random from seed {seed} in "
        f"{init_s:.1f} s; allocated before {mem0} bytes")

    def checks(state, tok0, words):
        return dict(logits=_kernel_vs_plain("serving", model, state, tok0,
                                            words, failures))

    res = _serve_phase(
        "serving", model, dev, seed, failures, checks,
        lambda words: _decode_bound(model, [SERVE_PROMPT + 1] * SERVE_B,
                                    words), want=n_global * SERVE_NEW)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  peak device memory {peak} bytes")
    res.update(layers=cfg.n_layers, params=n_params, weight_bytes=w_bytes,
               init_s=init_s, launches=sum(res["launches_per_generate"]),
               allocated_before=mem0, peak_bytes=peak)
    del model
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 12: Jamba-v0.1 serving at full width, 16 of its 32 layers
# ---------------------------------------------------------------------------

JAMBA_LAYERS = 16
CARD_BYTES = 80e9


class _MoEHooks:
    """Forward hooks on every MoE layer: each call's ``dropped_fraction``
    (kept on the card until read), the routed experts of each decode call,
    and the first MoE layer's ``expert_idx`` of every prefill."""

    def __init__(self, model):
        from repro_torch.models.mlp import MoE
        self.dropped = {"prefill": [], "decode": []}
        self.prefill_idx, self.decode_idx, self.handles = [], [], []
        layers = [b.ffn for b in model.layers if isinstance(b.ffn, MoE)]
        for j, moe in enumerate(layers):
            self.handles.append(moe.register_forward_hook(
                lambda mod, inp, out, j=j: self._seen(j, inp[0], out[1])))

    def _seen(self, j, x, metrics):
        kind = "prefill" if x.shape[1] > 1 else "decode"
        self.dropped[kind].append(metrics["dropped_fraction"])
        if kind == "prefill" and j == 0:
            self.prefill_idx.append(metrics["expert_idx"])
        elif kind == "decode":
            self.decode_idx.append(metrics["expert_idx"])

    def dropped_fraction(self, kind):
        vals = torch.stack(self.dropped[kind]).float().cpu().numpy()
        return dict(calls=len(vals), mean=float(vals.mean()),
                    max=float(vals.max()))

    def remove(self):
        for h in self.handles:
            h.remove()


def _step_bound(model, kv_len, words, routed):
    """Least time of one decode step, in ms, and its bytes: every weight
    the step reads once (every dense, attention, MLA, recurrent and shared
    expert weight, the LM head, the B embedding rows it looks up, and of
    each MoE layer only the experts this step routed to: ``routed[j]`` of
    them in MoE layer j), each global layer's K and V rows at visible
    valid positions, each MLA layer's ckv and k_rope rows below kv_len,
    each recurrent layer's state read and its new state written, over the
    HBM rate."""
    from repro_torch.models.mlp import MoE
    cfg, b = model.cfg, len(kv_len)
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    emb = model.embed
    w_bytes -= (emb.shape[0] - b) * emb.shape[1] * emb.element_size()
    moes = [blk.ffn for blk in model.layers if isinstance(
        getattr(blk, "ffn", None), MoE)]
    for moe, n in zip(moes, routed, strict=True):
        per_expert = sum(w[0].numel() * w.element_size()
                         for w in (moe.wg, moe.wu, moe.wd))
        w_bytes -= (cfg.n_experts - n) * per_expert
    kinds = [m for m, _ in cfg.layer_kinds]
    nbytes = w_bytes
    if "global" in kinds:
        row = cfg.n_kv_heads * cfg.hd * 2 * 2          # K and V, bf16
        nbytes += kinds.count("global") * row * int(_visible_positions(
            words, torch.tensor(kv_len, dtype=torch.int32,
                                device=words.device), SERVE_MAX_SEQ,
            cfg.attn_block_size).sum())
    mla_row = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2  # ckv and k_rope
    nbytes += kinds.count("mla") * mla_row * sum(kv_len)
    state = {"mamba": (cfg.ssm_expand * cfg.d_model) * (
        (cfg.ssm_d_conv - 1) * 2 + cfg.ssm_d_state * 4)}
    for blk, kind in zip(model.layers, kinds):
        if kind in ("mlstm", "slstm"):
            st = blk.init_state(1, 1, model.dtype, "meta")
            state[kind] = sum(t.numel() * 4 for t in st.values())
    nbytes += sum(kinds.count(k) * 2 * b * n for k, n in state.items())
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def _scan_check(model, cfg, h_in):
    """The first mamba layer's chunked selective scan against the per-token
    float32 recurrence on the same inputs, on the card: the largest
    difference of the float32 outputs and of the final h, each over the
    recurrence's largest magnitude."""
    from repro_torch.models import ssm
    mixer = model.layers[0].mixer
    with torch.no_grad():
        _, _, xi, dt, bmat, cmat = ssm.scan_inputs(h_in, mixer, cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        y, h = ssm.selective_scan(xi, dt, bmat, cmat, mixer.A_log,
                                  cfg.ssm_chunk, torch.float32)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t
        t = time.perf_counter()
        y_ref, h_ref = ssm.selective_scan_steps(xi, dt, bmat, cmat,
                                                mixer.A_log)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t
    out = dict(
        shape=list(xi.shape), d_state=cfg.ssm_d_state, chunk=cfg.ssm_chunk,
        y_err=float((y - y_ref).abs().max() / y_ref.abs().max()),
        h_err=float((h - h_ref).abs().max() / h_ref.abs().max()),
        y_max=float(y_ref.abs().max()), h_max=float(h_ref.abs().max()),
        finite=bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
        scan_s=scan_s, steps_s=steps_s)
    return out, h


def phase_jamba(dev, seed, failures):
    """Jamba-v0.1 served at full width with 16 of its 32 layers (see the
    module docstring, phase 12)."""
    from repro_torch.serve import (expert_overlap_matrix, load_balance_stats,
                                   routing_drift, routing_sets)
    _reset_counts()                       # the Jamba path starts here
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    model, cfg, full, n_params, w_bytes, init_s = _phase_model(
        "jamba_v01_52b", JAMBA_LAYERS, dev, seed)
    kinds = [m for m, _ in cfg.layer_kinds]
    ffns = [f for _, f in cfg.layer_kinds]
    n_global = kinds.count("global")
    block_bytes = sum(p.numel() * p.element_size()
                      for p in model.layers.parameters())
    full_bytes = w_bytes - block_bytes + block_bytes * (
        full.n_layers // cfg.n_layers)
    log(f"  Jamba-v0.1: n_layers {full.n_layers} -> {cfg.n_layers}: "
        f"{full_bytes / 1e9:.1f} GB of bf16 weights exceed the card's "
        f"{CARD_BYTES / 1e9:.0f} GB; kept {kinds.count('mamba')} mamba and "
        f"{n_global} global layers, {ffns.count('moe')} MoE ({cfg.n_experts} "
        f"experts, top {cfg.moe_top_k}) and {ffns.count('mlp')} dense ffns, "
        f"d {cfg.d_model}, {n_params} parameters, {w_bytes} bytes, random "
        f"from seed {seed} in {init_s:.1f} s; allocated before {mem0} bytes")
    hooks = _MoEHooks(model)
    scan_in, routed = [], []
    first_mamba = model.layers[0].ln1.register_forward_hook(
        lambda mod, inp, out: scan_in.append(out)
        if not scan_in and out.dim() == 3 else None)

    def checks(state, tok0, words):
        logits = _kernel_vs_plain("jamba", model, state, tok0, words,
                                  failures)
        # the kernel's step ran last: its routes are the last of each layer
        routed[:] = [len(torch.unique(i))
                     for i in hooks.decode_idx[-len(hooks.handles):]]
        log(f"  routed experts a MoE layer in that step {routed}")
        # the first mamba layer's scan against the per-token recurrence
        first_mamba.remove()
        scan, scan_h = _scan_check(model, cfg, scan_in.pop())
        scan["prefill_h_equal"] = bool(torch.equal(scan_h,
                                                   state.layers[0]["h"]))
        log(f"  chunked scan vs per-token float32 recurrence, first mamba "
            f"layer's prefill input {scan['shape']} x ds "
            f"{scan['d_state']}: outputs {scan['y_err']:.3g}, final h "
            f"{scan['h_err']:.3g} of the largest magnitude "
            f"({scan['y_max']:.4g}, {scan['h_max']:.4g}; limit 1e-5); the "
            f"prefill's h equal to the scan's {scan['prefill_h_equal']}; "
            f"scan {scan['scan_s']:.3f} s, recurrence "
            f"{scan['steps_s']:.3f} s")
        if not (scan["finite"] and scan["y_err"] <= 1e-5
                and scan["h_err"] <= 1e-5 and scan["prefill_h_equal"]):
            failures.append(f"jamba: chunked scan != per-token recurrence "
                            f"{scan}")
        return dict(logits=logits, scan=scan, routed_experts=routed)

    try:
        res = _serve_phase(
            "jamba", model, dev, seed, failures, checks,
            lambda words: _step_bound(model, [SERVE_PROMPT + 1] * SERVE_B,
                                      words, routed),
            want=n_global * SERVE_NEW)
    finally:
        first_mamba.remove()
        hooks.remove()

    # MoE telemetry from the hooks: drops, and the first MoE layer's
    # routes of the two prefills of the same prompts as Roaring sets
    dropped = {k: hooks.dropped_fraction(k) for k in ("prefill", "decode")}
    idx0, idx1 = (i.reshape(-1, cfg.moe_top_k) for i in hooks.prefill_idx)
    t = time.perf_counter()
    sets = routing_sets(idx0, cfg.n_experts)
    later = routing_sets(idx1, cfg.n_experts)
    balance = load_balance_stats(sets)
    overlap = expert_overlap_matrix(sets, device=dev)
    drift = routing_drift(sets, later, device=dev)
    tel_s = time.perf_counter() - t
    off = overlap[~np.eye(cfg.n_experts, dtype=bool)]
    telemetry = dict(tokens=int(idx0.shape[0]), loads=[
        s_.cardinality for s_ in sets], balance=balance,
        overlap_max=float(off.max()), overlap_mean=float(off.mean()),
        drift=drift.tolist(), seconds=tel_s, dropped=dropped)
    pre, dec = dropped["prefill"], dropped["decode"]
    log(f"  MoE dropped_fraction: prefill mean {pre['mean']:.4f} (max "
        f"{pre['max']:.4f}, {pre['calls']} calls), decode mean "
        f"{dec['mean']:.4f} (max {dec['max']:.4f}, {dec['calls']} calls); "
        f"first MoE layer's routes of {telemetry['tokens']} prefill "
        f"tokens: loads {telemetry['loads']}, {balance}, expert overlap "
        f"(Jaccard) max {telemetry['overlap_max']:.4f} mean "
        f"{telemetry['overlap_mean']:.4f}, drift against the second prefill "
        f"max {drift.max():.4f}; {tel_s:.2f} s")
    if sum(telemetry["loads"]) != cfg.moe_top_k * telemetry["tokens"]:
        failures.append(f"jamba: routing sets hold {sum(telemetry['loads'])}"
                        f" routes of {telemetry['tokens']} tokens")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  peak device memory {peak} bytes")
    res.update(layers=cfg.n_layers, full_layers=full.n_layers,
               params=n_params, weight_bytes=w_bytes,
               full_weight_bytes=full_bytes, init_s=init_s,
               launches=sum(res["launches_per_generate"]),
               telemetry=telemetry, allocated_before=mem0, peak_bytes=peak)
    del model, hooks
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 13 and 14: DeepSeek-V2, xLSTM-350M and HuBERT-xlarge
# ---------------------------------------------------------------------------

DEEPSEEK_LAYERS = 8
MLA_LIMIT = 2.0 ** -5         # absorbed vs decompressed, of a head's largest
XLSTM_PROMPT = SERVE_PROMPT   # xLSTM's prompt length (phase 10's)
HUBERT_FRAMES = 5120


def _mla_check(model, cfg, state, tok0, words):
    """Every MLA layer of one decode step from ``state``: the absorbed
    attention's output against the decompressed attention recomputed in
    float32 from the same caches (written by this step, read after it),
    the largest difference over each head's largest output; the prefix
    layer runs JAX's ``mla_decode`` flavour, the others its
    ``mla_decode_stacked``."""
    from repro_torch.models import layers as L
    calls, absorbed = [], L.mla_attend_absorbed

    def recorded(q_nope, q_rope, ckv, kr, kv_len, p, c, *, ctx_f32):
        out = absorbed(q_nope, q_rope, ckv, kr, kv_len, p, c,
                       ctx_f32=ctx_f32)
        calls.append((q_nope, q_rope, ckv, kr, kv_len, p, ctx_f32, out))
        return out

    L.mla_attend_absorbed = recorded      # mla_decode reads it by name
    try:
        model.decode_step(state, tok0, words)
    finally:
        L.mla_attend_absorbed = absorbed
    errs, flavours = [], []
    for q_nope, q_rope, ckv, kr, kv_len, p, ctx_f32, out in calls:
        want = L.mla_attend_decompressed(q_nope, q_rope, ckv, kr, kv_len, p,
                                         cfg)
        top = want.abs().amax(dim=-1, keepdim=True)
        errs.append(float(((out.float() - want).abs() / top).max()))
        flavours.append("prefix" if ctx_f32 else "stacked")
        del want
    torch.cuda.empty_cache()
    return dict(layers=len(errs), max_err=max(errs, default=None),
                errs=errs, flavours=flavours, limit=MLA_LIMIT)


def phase_deepseek(dev, seed, failures):
    """DeepSeek-V2 served at full width with 8 of its 60 layers (see the
    module docstring, phase 13)."""
    _reset_counts()                       # the DeepSeek path starts here
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    model, cfg, full, n_params, w_bytes, init_s = _phase_model(
        "deepseek_v2_236b", DEEPSEEK_LAYERS, dev, seed)
    per_layer = sum(p.numel() * p.element_size() for p in model.layers[
        1:].parameters()) / (cfg.n_layers - 1)
    full_bytes = w_bytes + per_layer * (full.n_layers - cfg.n_layers)
    log(f"  DeepSeek-V2: n_layers {full.n_layers} -> {cfg.n_layers}: "
        f"{full_bytes / 1e9:.1f} GB of bf16 weights exceed the card's "
        f"{CARD_BYTES / 1e9:.0f} GB; kept the dense prefix layer (ff "
        f"{cfg.dense_d_ff}) and {cfg.n_layers - 1} MLA + MoE layers "
        f"({cfg.n_experts} experts of {cfg.moe_d_ff}, top {cfg.moe_top_k}, "
        f"{cfg.n_shared_experts} shared), d {cfg.d_model}, {cfg.n_heads} "
        f"heads, kv_lora {cfg.kv_lora_rank}; {n_params} parameters, "
        f"{w_bytes} bytes, random from seed {seed} in {init_s:.1f} s; "
        f"allocated before {mem0} bytes")
    hooks, routed = _MoEHooks(model), []

    def checks(state, tok0, words):
        mla = _mla_check(model, cfg, state, tok0, words)
        # that step's routes are the last of each MoE layer
        routed[:] = [len(torch.unique(i))
                     for i in hooks.decode_idx[-len(hooks.handles):]]
        log(f"  absorbed vs decompressed MLA in each layer of one step "
            f"({mla['flavours'].count('prefix')} prefix, "
            f"{mla['flavours'].count('stacked')} stacked): at most "
            f"{mla['max_err']:.4g} of a head's largest output (limit "
            f"{MLA_LIMIT}); per layer {[f'{e:.3g}' for e in mla['errs']]}")
        want_fl = ["prefix"] + ["stacked"] * (cfg.n_layers - 1)
        if mla["flavours"] != want_fl or mla["max_err"] > MLA_LIMIT:
            failures.append(f"deepseek: absorbed MLA != decompressed {mla}")
        log(f"  routed experts a MoE layer in that step {routed}")
        return dict(mla=mla, routed_experts=routed)

    try:
        res = _serve_phase(
            "deepseek", model, dev, seed, failures, checks,
            lambda words: _step_bound(model, [SERVE_PROMPT + 1] * SERVE_B,
                                      words, routed))
    finally:
        hooks.remove()
    dropped = {k: hooks.dropped_fraction(k) for k in ("prefill", "decode")}
    pre, dec = dropped["prefill"], dropped["decode"]
    cap = max(1, round(cfg.capacity_factor * SERVE_B * cfg.moe_top_k
                       / cfg.n_experts))
    log(f"  MoE dropped_fraction: prefill mean {pre['mean']:.4f} (max "
        f"{pre['max']:.4f}, {pre['calls']} calls), decode mean "
        f"{dec['mean']:.4f} (max {dec['max']:.4f}, {dec['calls']} calls; "
        f"capacity {cap})")
    # prefill, decode, the checks and the window, then the constrained
    # generate (the constraint's build is counted apart)
    launches = _sum_counts(res["launch_counts"]["served"], _all_counts())
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  kernel launches in the phase {launches or 'none'}; peak device "
        f"memory {peak} bytes")
    if launches:
        failures.append(f"deepseek: a kernel launched on the DeepSeek path, "
                        f"which runs none: {launches}")
    res.update(layers=cfg.n_layers, full_layers=full.n_layers,
               params=n_params, weight_bytes=w_bytes,
               full_weight_bytes=full_bytes, init_s=init_s, dropped=dropped,
               launches=launches, allocated_before=mem0, peak_bytes=peak)
    del model, hooks
    torch.cuda.empty_cache()
    return res


def _mlstm_check(model, cfg, h_in, prefill_state):
    """The first mLSTM layer's real prefill input through the chunked form
    (chunks of ``cfg.xlstm_chunk``) and the per-token float32 recurrence
    on the card: h and the final C, n and m, each's largest difference
    over its largest magnitude (at least 1); and the prefill's own final
    state equal to the chunked one."""
    from repro_torch.models import ssm
    mixer = model.layers[0].mixer
    di = cfg.ssm_expand * cfg.d_model
    with torch.no_grad():
        ins = ssm.mlstm_inputs((h_in @ mixer.up)[..., :di], mixer, cfg)
        st0 = ssm.mlstm_init_state(cfg, h_in.shape[0], h_in.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        h_c, st_c = ssm.mlstm_chunked(*ins, st0, cfg.xlstm_chunk)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t
        t = time.perf_counter()
        h_s, st_s = ssm.mlstm_steps(*ins, st0)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t
    errs = {k: float((a - b).abs().max() / max(float(b.abs().max()), 1.0))
            for k, a, b in (("h", h_c, h_s), *((k, st_c[k], st_s[k])
                                                for k in "Cnm"))}
    same = all(torch.equal(st_c[k], prefill_state[k]) for k in "Cnm")
    return dict(shape=list(h_c.shape), chunk=cfg.xlstm_chunk, errs=errs,
                max_err=max(errs.values()), prefill_state_equal=same,
                finite=bool(torch.isfinite(h_c).all()), chunked_s=chunk_s,
                steps_s=steps_s)


def phase_xlstm_hubert(dev, seed, failures):
    """xLSTM-350M served whole, then one HuBERT-xlarge encoder prefill (see
    the module docstring, phase 14)."""
    from repro_torch.models import ssm
    _reset_counts()                       # the xLSTM path starts here
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    model, cfg, _, n_params, w_bytes, init_s = _phase_model(
        "xlstm_350m", 0, dev, seed)
    log(f"  xLSTM-350M: {cfg.n_layers} layers (mLSTM and sLSTM, ffn none), "
        f"d {cfg.d_model}, {cfg.xlstm_heads} heads, mLSTM chunk "
        f"{cfg.xlstm_chunk}; {n_params} parameters, {w_bytes} bytes, random "
        f"from seed {seed} in {init_s:.1f} s")
    mlstm_in, slstm_s, slstm_train = [], [], ssm.slstm_train

    def timed_slstm(*a, **kw):            # transformer.py reads it by name
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = slstm_train(*a, **kw)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t)
        return out

    first = model.layers[0].ln1.register_forward_hook(
        lambda mod, inp, out: mlstm_in.append(out)
        if not mlstm_in and out.dim() == 3 else None)
    ssm.slstm_train = timed_slstm
    n_slstm = sum(m == "slstm" for m, _ in cfg.layer_kinds)

    def checks(state, tok0, words):
        first.remove()
        chk = _mlstm_check(model, cfg, mlstm_in.pop(), state.layers[0])
        errs = {k: f"{v:.3g}" for k, v in chk["errs"].items()}
        log(f"  chunked mLSTM vs per-token float32 recurrence, first mLSTM "
            f"layer's prefill input {chk['shape']} (chunks of "
            f"{chk['chunk']}): {errs} of the largest magnitude (limit "
            f"1e-5); the prefill's state "
            f"equal to the chunked one {chk['prefill_state_equal']}; chunked "
            f"{chk['chunked_s']:.3f} s, recurrence {chk['steps_s']:.3f} s")
        if not (chk["finite"] and chk["max_err"] <= 1e-5
                and chk["prefill_state_equal"]):
            failures.append(f"xlstm: chunked mLSTM != recurrence {chk}")
        return dict(mlstm=chk)

    try:
        res = _serve_phase(
            "xlstm", model, dev, seed, failures, checks,
            lambda words: _step_bound(model, [XLSTM_PROMPT + 1] * SERVE_B,
                                      words, []), prompt=XLSTM_PROMPT)
    finally:
        ssm.slstm_train = slstm_train
        first.remove()
    prefill_slstm = [sum(slstm_s[i:i + n_slstm])
                     for i in range(0, len(slstm_s), n_slstm)]
    share = [s_ / p_ for s_, p_ in zip(prefill_slstm, res["prefill_s"])]
    log(f"  sLSTM layers (token by token) in each prefill: "
        f"{[f'{s_:.2f}' for s_ in prefill_slstm]} s, "
        f"{[f'{x:.3f}' for x in share]} of the prefill")
    res.update(layers=cfg.n_layers, params=n_params, weight_bytes=w_bytes,
               init_s=init_s, slstm_prefill_s=prefill_slstm,
               slstm_share=share, allocated_before=mem0,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # HuBERT-xlarge: one encoder prefill of audio-stub embeddings, twice
    torch.cuda.reset_peak_memory_stats(dev)
    model, hcfg, _, h_params, h_bytes, h_init = _phase_model(
        "hubert_xlarge", 0, dev, seed)
    fe = torch.randn((SERVE_B, HUBERT_FRAMES, hcfg.frontend_dim),
                     generator=torch.Generator(dev).manual_seed(seed + 1),
                     device=dev).to(torch.bfloat16)
    times, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _st = model.prefill(frontend_embeds=fe)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        outs.append(logits)
        del _st
    ok = (outs[0].shape == (SERVE_B, hcfg.vocab)
          and bool(torch.isfinite(outs[0]).all())
          and bool(torch.equal(outs[0], outs[1])))
    h_peak = torch.cuda.max_memory_allocated(dev)
    log(f"  HuBERT-xlarge: {hcfg.n_layers} encoder layers, d "
        f"{hcfg.d_model}, {h_params} parameters, random from seed {seed} in "
        f"{h_init:.1f} s; prefill of {SERVE_B} x {HUBERT_FRAMES} frames of "
        f"{hcfg.frontend_dim}-wide embeddings, no tokens: "
        f"{[f'{t_:.2f}' for t_ in times]} s; logits {tuple(outs[0].shape)} "
        f"finite and equal on the rerun: {ok}; peak {h_peak} bytes")
    if not ok:
        failures.append("hubert: encoder prefill logits not finite, of "
                        "another shape, or different on a rerun")
    # xLSTM's prefill, decode, checks and window, its constrained generate
    # and HuBERT's prefills (the constraint's build is counted apart)
    launches = _sum_counts(res["launch_counts"]["served"], _all_counts())
    log(f"  kernel launches in the phase {launches or 'none'}")
    if launches:
        failures.append(f"xlstm/hubert: a kernel launched on a path that "
                        f"runs none: {launches}")
    res.update(launches=launches, hubert=dict(
        layers=hcfg.n_layers, params=h_params, weight_bytes=h_bytes,
        init_s=h_init, frames=HUBERT_FRAMES, prefill_s=times, ok=ok,
        peak_bytes=h_peak))
    del model, outs, fe
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 15: Qwen2.5-3B training at full width and depth
# ---------------------------------------------------------------------------

TRAIN_SEQ = 4096              # the JAX package's train_4k sequence
TRAIN_STEPS = 5               # 8 planned, cut to keep the phase's time
TRAIN_DOCS = 65_536           # the train launcher's pipeline
TRAIN_CHECK_LAYERS = 2        # the remat and resume checks' depth
TRAIN_LR = 1e-3
WITNESS_LR = 1e-4             # the first-batch descent check's rate
BF16_DENSE_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
TRAIN_RANGES = ("trainer.data", "train_step.forward_backward",
                "train_step.optimizer")


def _train_cfg(layers=0, name="qwen2_5_3b", **kw):
    import dataclasses

    from repro_torch import configs
    cfg = configs.get_config(name)
    return dataclasses.replace(cfg, **(dict(n_layers=layers) if layers
                                       else {}), **kw)


def _train_opt(steps, lr=TRAIN_LR, warmup=5):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps)


def _train_pipeline(cfg, dev, seq=TRAIN_SEQ):
    """The launcher's pipeline: 65,536 documents, batch 1 of ``seq``."""
    from repro_torch.data.pipeline import RoaringDataPipeline
    return RoaringDataPipeline(n_docs=TRAIN_DOCS, seq_len=seq,
                               batch_size=1, vocab=cfg.vocab, seed=0,
                               device=dev)


def _trainer(cfg, dev, seed, ckpt_dir, steps, ckpt_every=10 ** 9,
             async_ckpt=True, lr=TRAIN_LR, warmup=5, seq=TRAIN_SEQ):
    """The launcher's trainer over ``_train_pipeline``, float32 masters
    from ``seed``."""
    from repro_torch.train.trainer import Trainer
    return Trainer(cfg, _train_opt(steps, lr, warmup),
                   _train_pipeline(cfg, dev, seq), ckpt_dir,
                   ckpt_every=ckpt_every, async_ckpt=async_ckpt, seed=seed,
                   device=dev)


def _batches(cfg, dev, n, seq=TRAIN_SEQ):
    """The first ``n`` batches a trainer of ``cfg`` draws (a twin of its
    pipeline), on the card."""
    pipe = _train_pipeline(cfg, dev, seq)
    out = []
    for _ in range(n):
        b = pipe.next_batch()
        out.append({k: torch.from_numpy(b[k]).to(dev)
                    for k in ("tokens", "labels")})
    return out


def _remat_check(dev, seed, batch, name="qwen2_5_3b"):
    """TRAIN_CHECK_LAYERS layers of ``name`` at full width from the same
    seed, with remat on and off: the loss and every gradient leaf compared
    bit for bit; the leaves that differ named with their largest
    difference; each leaf's gradient norm with remat on."""
    from repro_torch.models.transformer import Transformer
    out = {}
    for remat in ("block", "none"):
        cfg = _train_cfg(TRAIN_CHECK_LAYERS, name, remat=remat)
        model = Transformer(cfg, device=dev, param_dtype="float32",
                            generator=torch.Generator(dev).manual_seed(seed))
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = model.loss_and_metrics(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), dict(zip(params, grads)),
                      time.perf_counter() - t,
                      torch.cuda.max_memory_allocated(dev))
        del model, params, grads
    (l_on, g_on, s_on, _), (l_off, g_off, s_off, _) = out["block"], \
        out["none"]
    differ = {k: float((g_on[k] - g).abs().max())
              for k, g in g_off.items() if not torch.equal(g_on[k], g)}
    router_norms = {k: float(g.norm()) for k, g in g_on.items()
                    if k.endswith("ffn.router")}
    return dict(layers=TRAIN_CHECK_LAYERS, leaves=len(g_off),
                router_norms=router_norms,
                loss_equal=bool(torch.equal(l_on, l_off)),
                loss=float(l_on), differ=differ, remat_s=s_on,
                no_remat_s=s_off)


def _resume_check(dev, seed, tmp):
    """TRAIN_CHECK_LAYERS layers at full width: 3 steps and an asynchronous
    checkpoint, a fresh trainer that resumes, 2 more steps; against 5
    uninterrupted steps."""
    cfg = _train_cfg(TRAIN_CHECK_LAYERS)
    t = time.perf_counter()
    a = _trainer(cfg, dev, seed, os.path.join(tmp, "run"), 5, ckpt_every=3)
    a.train(3, log_every=10 ** 9)          # waits for the save
    run_s = time.perf_counter() - t
    state_bytes = sum(p.numel() * 12 for p in a.params.values())
    del a
    gc.collect()
    b = _trainer(cfg, dev, seed, os.path.join(tmp, "run"), 5, ckpt_every=3)
    t = time.perf_counter()
    resumed = b.maybe_resume()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    b_step = b.step
    hb = b.train(2, log_every=10 ** 9)
    b_pipe = b.pipeline.step
    del b
    gc.collect()
    c = _trainer(cfg, dev, seed, os.path.join(tmp, "ref"), 5)
    hc = c.train(5, log_every=10 ** 9)
    c_pipe = c.pipeline.step
    del c
    gc.collect()
    got = [h["loss"] for h in hb]
    want = [h["loss"] for h in hc[3:]]
    close = bool(np.allclose(got, want, rtol=2e-4, atol=2e-4))
    return dict(layers=TRAIN_CHECK_LAYERS, state_bytes=state_bytes,
                resumed=resumed, resumed_step=b_step, losses=got,
                reference=want, close=close, equal=got == want,
                pipeline_step=(b_pipe, c_pipe), first_run_s=run_s,
                resume_s=resume_s)


def _descent_witness(cfg, dev, seed, ckpt_dir, steps, first):
    """A trainer from the same masters, pipeline and schedule as phase
    15's, at WITNESS_LR: the loss (eval step) of ``first``, the first
    batch, before and after ``steps`` steps, and the steps' losses."""
    from repro_torch.train.train_step import make_eval_step
    eval_step = make_eval_step(cfg)
    tr = _trainer(cfg, dev, seed, ckpt_dir, steps, lr=WITNESS_LR)
    before = float(eval_step(tr.model, first)["loss"])
    hist = tr.train(steps, log_every=10 ** 9)
    after = float(eval_step(tr.model, first)["loss"])
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return dict(lr=WITNESS_LR, before=before, after=after,
                losses=[h["loss"] for h in hist])


def phase_training(dev, seed, failures, steps=TRAIN_STEPS):
    """Phase 15: Qwen2.5-3B trained at full width and depth (see the module
    docstring)."""
    import tempfile

    from repro_torch.train.train_step import make_eval_step
    _reset_counts()                       # the training path starts here
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = _train_cfg()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tr = _trainer(cfg, dev, seed, tmp, steps)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        n_params = sum(p.numel() for p in tr.params.values())
        log(f"  Qwen2.5-3B: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads} / {cfg.n_kv_heads} heads, ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}; {n_params} float32 master parameters from seed "
            f"{seed} in {init_s:.1f} s; {cfg.compute_dtype} compute, remat "
            f"{cfg.remat!r}; batch 1 x {TRAIN_SEQ} tokens from the Roaring "
            f"pipeline over {TRAIN_DOCS} documents")
        eval_step = make_eval_step(cfg)
        batches = _batches(cfg, dev, steps)
        walls, before, own = [], {}, {}
        for k in range(1, steps + 1):
            if k in (1, steps):             # the step's own batch, before
                before[k] = float(eval_step(tr.model, batches[k - 1])["loss"])
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.train(1, log_every=10 ** 9)
            walls.append(time.perf_counter() - t)
            if k in (1, steps):             # and after it
                own[k] = float(eval_step(tr.model, batches[k - 1])["loss"])
        hist = list(tr.history)
        loss0, loss1 = before[1], float(eval_step(tr.model,
                                                  batches[0])["loss"])
        window = _traced("training step", lambda: tr.train(
            1, log_every=10 ** 9), dev, ranges=TRAIN_RANGES)
        peak = torch.cuda.max_memory_allocated(dev)
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        step_ms = [h["sec"] * 1e3 for h in hist[1:]]
        p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
        flops_token = 6 * n_params + 6 * cfg.n_layers * TRAIN_SEQ \
            * cfg.n_heads * cfg.hd
        flops_step = flops_token * TRAIN_SEQ
        mfu = flops_step / (p50 / 1e3) / BF16_DENSE_FLOPS
        opt_bytes = 28 * n_params           # read p, g, m, v; write p, m, v
        opt_bound_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
        split_ms = {k: v / 1e3 for k, v in window["range_us"].items()}
        idle, top = window["idle_share"], window["top_kernels"]
        finite = all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                     and h["grad_norm"] > 0 for h in hist)
        log(f"  {steps} steps: losses "
            f"{[round(h['loss'], 4) for h in hist]}, grad norms "
            f"{[round(h['grad_norm'], 4) for h in hist]}, lr "
            f"{['%.2e' % h['lr'] for h in hist]}; all finite, norms above "
            f"0: {finite}")
        log(f"  step ms (steps 2-{steps}) p50 {p50:.1f}, p99 {p99:.1f}; "
            f"with the data draw {[round(w * 1e3, 1) for w in walls]}; "
            f"{TRAIN_SEQ / (p50 / 1e3):.0f} tokens/s; model FLOPs "
            f"{flops_token / 1e9:.2f} G a token, {flops_step / 1e12:.1f} T "
            f"a step: mfu {mfu:.4f} of {BF16_DENSE_FLOPS / 1e12:.0f} T/s "
            f"bf16 dense ({flops_step / BF16_DENSE_FLOPS * 1e3:.1f} ms a "
            f"step at 100%)")
        tries = len(window["incomplete_windows"]) + window["complete"]
        log(f"  profiler window of a training step ({tries} window(s); "
            f"complete {window['complete']}, "
            f"{window['device_events']} of {window['runtime_calls']} launch "
            f"calls, lead adds {window['lead']}): wall "
            f"{window['wall_us'] / 1e3:.1f} ms, device "
            f"{window['busy_us'] / 1e3:.1f} ms, idle "
            f"{'null' if idle is None else f'{idle:.4f}'}; forward + "
            f"backward {split_ms['train_step.forward_backward']:.1f} ms, "
            f"optimizer {split_ms['train_step.optimizer']:.1f} ms (bound "
            f"{opt_bound_ms:.1f} ms: {opt_bytes / 1e9:.1f} GB), data "
            f"{split_ms['trainer.data']:.3f} ms, other "
            f"{split_ms['other']:.3f} ms; top device ops "
            f"{[(n[:60], round(us / 1e3, 2)) for n, us in top]}")
        descent = {k: (before[k], own[k]) for k in own}
        twin = {k: (before[k], hist[k - 1]["loss"]) for k in before}
        log(f"  each step's own batch, its loss (eval step) before and after "
            f"the step: {descent}; the eval loss before each of those steps "
            f"against the step's own loss (equal when the twin pipeline "
            f"drew the trainer's batch): {twin}; first batch's loss "
            f"{loss0:.5f} before, {loss1:.5f} after {steps} steps at lr "
            f"{TRAIN_LR:g}; peak {peak} bytes")
        if not finite:
            failures.append(f"training: a non-finite loss or grad norm, or "
                            f"a zero norm: {hist}")
        if any(a != b for a, b in twin.values()):
            failures.append(f"training: the twin pipeline's batches are not "
                            f"the trainer's: {twin}")
        if not all(after < b for b, after in descent.values()):
            failures.append(f"training: a step did not lower its own batch's "
                            f"loss: {descent}")
        witness = _descent_witness(cfg, dev, seed, os.path.join(
            tmp, "witness"), steps, batches[0])
        log(f"  the same masters, pipeline and schedule at lr "
            f"{WITNESS_LR:g}: first batch's loss {witness['before']:.5f} "
            f"before, {witness['after']:.5f} after {steps} steps; losses "
            f"{[round(x, 4) for x in witness['losses']]}")
        if not (witness["after"] < witness["before"]
                and witness["before"] == loss0
                and all(np.isfinite(witness["losses"]))):
            failures.append(f"training: at lr {WITNESS_LR:g} the first "
                            f"batch's loss did not fall from the same start: "
                            f"{witness} (at lr {TRAIN_LR:g} it began at "
                            f"{loss0})")

        remat = _remat_check(dev, seed, batches[0])
        log(f"  remat on vs off, {remat['layers']} of {cfg.n_layers} layers "
            f"at full width: loss equal {remat['loss_equal']}, "
            f"{remat['leaves'] - len(remat['differ'])} of {remat['leaves']} "
            f"gradient leaves bit-equal, differing {remat['differ'] or 'none'}"
            f"; {remat['remat_s']:.2f} / {remat['no_remat_s']:.2f} s")
        if not remat["loss_equal"] or remat["differ"]:
            failures.append(f"training: remat on and off differ: {remat}")
        del batches
        gc.collect()
        torch.cuda.empty_cache()
        resume = _resume_check(dev, seed, tmp)
        log(f"  resume, {resume['layers']} layers at full width "
            f"({resume['state_bytes']} bytes of state): 3 steps and a "
            f"checkpoint in {resume['first_run_s']:.1f} s, resumed "
            f"{resume['resumed']} at step {resume['resumed_step']} in "
            f"{resume['resume_s']:.1f} s; losses {resume['losses']} against "
            f"uninterrupted {resume['reference']} (within 2e-4: "
            f"{resume['close']}, equal: {resume['equal']}); pipeline steps "
            f"{resume['pipeline_step']}")
        if not (resume["resumed"] and resume["resumed_step"] == 3
                and resume["close"]
                and resume["pipeline_step"][0] == resume["pipeline_step"][1]):
            failures.append(f"training: resume differs: {resume}")
    launches = _all_counts()
    log(f"  kernel launches in the phase {launches or 'none'}")
    if launches:
        failures.append(f"training: a kernel launched on a path that runs "
                        f"none: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, params=n_params, init_s=init_s,
                steps=steps, history=hist, step_walls_s=walls,
                step_p50_ms=p50, step_p99_ms=p99,
                tokens_per_s=TRAIN_SEQ / (p50 / 1e3),
                flops_per_step=flops_step,
                mfu=mfu, optimizer_bytes=opt_bytes,
                optimizer_bound_ms=opt_bound_ms, window=window,
                eval_loss=(loss0, loss1), descent=descent, twin=twin,
                witness=witness, peak_bytes=peak, remat=remat,
                resume=resume, launches=launches)


# ---------------------------------------------------------------------------
# phase 16: the rest of training on the card
# ---------------------------------------------------------------------------

MOE_TRAIN_STEPS = 5           # 16a's steps (Mixtral-8x7B, 2 of 32 layers)
FAMILY_STEPS = 3              # 16b, 16c and 16e
FAMILY_LR = 1e-4              # every sub-phase, 1 warm-up step
XLSTM_TRAIN_SEQ = 512         # 16e: cut from 4,096 (the sLSTM's host loop)
MAMBA_CHECK_SEQ = 512         # 16d: the recurrence check's sequence
MAMBA_GRAD_TOL = 1e-4         # 16d: of each leaf's largest magnitude
STATE_BYTES = 16              # float32 parameter, gradient, m and v


def _card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def _step_stats(hist, seq):
    """Step ms p50 / p99 past the first step, and tokens/s at the p50."""
    ms = [h["sec"] * 1e3 for h in hist[1:]] or [hist[0]["sec"] * 1e3]
    p50, p99 = (float(np.percentile(ms, q)) for q in (50, 99))
    return dict(step_ms=ms, step_p50_ms=p50, step_p99_ms=p99,
                tokens_per_s=seq / (p50 / 1e3))


def _family_report(label, res, failures):
    """Log a sub-phase's common numbers and apply check 1 (finite losses
    and norms, every norm above 0) and the launch check."""
    hist = res["history"]
    finite = all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                 and h["grad_norm"] > 0 for h in hist)
    log(f"  {label}: {res['card']}; {res['params']} float32 master "
        f"parameters ({res['params'] * STATE_BYTES / 1e9:.1f} GB of state), "
        f"init {res['init_s']:.1f} s; losses "
        f"{[round(h['loss'], 5) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}; step ms "
        f"{[round(x, 1) for x in res['step_ms']]}, p50 "
        f"{res['step_p50_ms']:.1f}, {res['tokens_per_s']:.0f} tokens/s; "
        f"peak {res['peak_bytes']} bytes; kernel launches "
        f"{res['launches'] or 'none'}")
    if not finite:
        failures.append(f"{label}: a non-finite loss or grad norm, or a "
                        f"zero norm: {hist}")
    if res["launches"]:
        failures.append(f"{label}: a kernel launched on a path that runs "
                        f"none: {res['launches']}")


def _train_fixed(cfg, dev, seed, batch, steps):
    """``steps`` train steps of a fresh model of ``cfg`` (float32 masters
    from ``seed``) on one fixed ``batch``, AdamW at FAMILY_LR after one
    warm-up step -> the history, the batch's eval loss after, the
    parameter count and the init seconds."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_eval_step, make_train_step
    t = time.perf_counter()
    model = Transformer(cfg, device=dev, param_dtype="float32",
                        generator=torch.Generator(dev).manual_seed(seed))
    model.requires_grad_(True)
    state = adamw.init_state(dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, _train_opt(steps, FAMILY_LR, warmup=1))
    hist = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, state, m = step(model, state, batch)
        loss = float(m["loss"])
        hist.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]),
                     "sec": time.perf_counter() - t})
    after = float(make_eval_step(cfg)(model, batch)["loss"])
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return hist, after, n_params, init_s


def _falls(hist, after):
    """The fixed batch's loss falls over the steps: its eval loss after
    the last step is below the first step's loss (taken before any
    update)."""
    return after < hist[0]["loss"]


def _phase16a_mixtral(dev, seed, failures, steps):
    """16a: Mixtral-8x7B at full width, 2 of its 32 layers, through the
    port's ``Trainer`` (see the module docstring)."""
    import tempfile

    from repro_torch.models.mlp import MoE
    from repro_torch.train.train_step import make_eval_step
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = _train_cfg(TRAIN_CHECK_LAYERS, "mixtral_8x7b")
    card = _card_line()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        tr = _trainer(cfg, dev, seed, tmp, steps, lr=FAMILY_LR, warmup=1)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        n_params = sum(p.numel() for p in tr.params.values())
        dropped = []
        hooks = [b.ffn.register_forward_hook(
            lambda mod, inp, out: dropped.append(out[1]["dropped_fraction"]))
            for b in tr.model.layers if isinstance(b.ffn, MoE)]
        eval_step = make_eval_step(cfg)
        first = _batches(cfg, dev, 1)[0]
        before = float(eval_step(tr.model, first)["loss"])
        dropped.clear()
        per_step = []
        for _ in range(steps):
            tr.train(1, log_every=10 ** 9)
            # the forward's calls; remat's recompute calls them again
            per_step.append([float(d) for d in dropped[:len(hooks)]])
            dropped.clear()
        hist = list(tr.history)
        after = float(eval_step(tr.model, first)["loss"])
        window = _traced("Mixtral training step", lambda: tr.train(
            1, log_every=10 ** 9), dev, ranges=TRAIN_RANGES)
        peak = torch.cuda.max_memory_allocated(dev)
        for h in hooks:
            h.remove()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    launches = _all_counts()
    res = dict(card=card, layers=cfg.n_layers, params=n_params,
               init_s=init_s, history=hist, peak_bytes=peak,
               launches=launches, **_step_stats(hist, TRAIN_SEQ))
    # model FLOPs: 6 N_active a token (N_active: every parameter but the
    # experts a token is not routed to) plus causal attention, as phase 15
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    n_active = n_params - cfg.n_layers * (cfg.n_experts - cfg.moe_top_k) \
        * per_expert
    flops_step = (6 * n_active + 6 * cfg.n_layers * TRAIN_SEQ * cfg.n_heads
                  * cfg.hd) * TRAIN_SEQ
    mfu = flops_step / (res["step_p50_ms"] / 1e3) / BF16_DENSE_FLOPS
    opt_bytes = 28 * n_params
    split_ms = {k: v / 1e3 for k, v in window["range_us"].items()}
    idle = window["idle_share"]
    res.update(n_active=n_active, flops_per_step=flops_step, mfu=mfu,
               optimizer_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3,
               window={k: window[k] for k in (
                   "range_us", "idle_share", "busy_us", "wall_us",
                   "complete", "top_kernels")},
               dropped_fraction=per_step,
               router_aux=[h["router_aux"] for h in hist],
               eval_loss=(before, after))
    _family_report("16a Mixtral-8x7B", res, failures)
    log(f"  16a: {cfg.n_layers} of 32 layers, d {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads, {cfg.n_experts} experts "
        f"top-{cfg.moe_top_k} of {cfg.moe_d_ff}, window "
        f"{cfg.sliding_window}; batch 1 x {TRAIN_SEQ}, lr {FAMILY_LR:g}, "
        f"remat {cfg.remat!r}; router_aux a step "
        f"{[round(x, 5) for x in res['router_aux']]}, dropped_fraction a "
        f"step and layer {[[round(x, 4) for x in d] for d in per_step]}; "
        f"{n_active} parameters a token reads, "
        f"{flops_step / 1e12:.1f} TFLOP a step: mfu {mfu:.4f}; first "
        f"batch's loss {before:.5f} before, {after:.5f} after {steps} steps")
    log(f"  16a profiler window (complete {window['complete']}): wall "
        f"{window['wall_us'] / 1e3:.1f} ms, device "
        f"{window['busy_us'] / 1e3:.1f} ms, idle "
        f"{'null' if idle is None else f'{idle:.4f}'}; forward + backward "
        f"{split_ms['train_step.forward_backward']:.1f} ms, optimizer "
        f"{split_ms['train_step.optimizer']:.1f} ms (bound "
        f"{res['optimizer_bound_ms']:.1f} ms), data "
        f"{split_ms['trainer.data']:.3f} ms; top device ops "
        f"{[(n[:60], round(us / 1e3, 2)) for n, us in window['top_kernels']]}")
    if not after < before:
        failures.append(f"16a: the first batch's loss did not fall: "
                        f"{before} -> {after}")
    if before != hist[0]["loss"]:
        failures.append(f"16a: the twin pipeline's first batch is not the "
                        f"trainer's: {before} against {hist[0]['loss']}")
    remat = _remat_check(dev, seed, first, "mixtral_8x7b")
    res["remat"] = remat
    log(f"  16a remat on vs off, {remat['layers']} layers: loss equal "
        f"{remat['loss_equal']}, {remat['leaves'] - len(remat['differ'])} "
        f"of {remat['leaves']} gradient leaves bit-equal, differing "
        f"{remat['differ'] or 'none'}; router gradient norms "
        f"{remat['router_norms']}; {remat['remat_s']:.2f} / "
        f"{remat['no_remat_s']:.2f} s")
    if not remat["loss_equal"] or remat["differ"]:
        failures.append(f"16a: remat on and off differ: {remat}")
    if len(remat["router_norms"]) != cfg.n_layers or not all(
            np.isfinite(v) and v > 0 for v in remat["router_norms"].values()):
        failures.append(f"16a: a router's gradient is zero or not finite: "
                        f"{remat['router_norms']}")
    more = _all_counts()
    if more:
        failures.append(f"16a: a kernel launched in the remat check: {more}")
    return res


def _phase16b_deepseek(dev, seed, failures, steps):
    """16b: DeepSeek-V2's dense prefix layer (MLA + MLP) at full width, 3
    steps on one fixed batch of 4,096 tokens."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = _train_cfg(1, "deepseek_v2_236b")
    assert cfg.layer_kinds == (("mla", "mlp"),)
    first = _batches(cfg, dev, 1)[0]
    hist, after, n_params, init_s = _train_fixed(cfg, dev, seed, first,
                                                 steps)
    res = dict(card=_card_line(), layers=1, params=n_params, init_s=init_s,
               history=hist, after=after, falls=_falls(hist, after),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               launches=_all_counts(), **_step_stats(hist, TRAIN_SEQ))
    _family_report("16b DeepSeek-V2 (1 of 60 layers)", res, failures)
    log(f"  16b: MLA q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
        f"{cfg.n_heads} heads, ffn {cfg.dense_d_ff}; the fixed batch's loss "
        f"after {steps} steps {after:.5f}; falls over the steps "
        f"{res['falls']}")
    if not res["falls"]:
        failures.append(f"16b: the fixed batch's loss did not fall: "
                        f"{hist}, {after}")
    return res


def _phase16c_hubert(dev, seed, failures, steps):
    """16c: HuBERT-xlarge whole on an audio-stub batch (no tokens)."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = _train_cfg(0, "hubert_xlarge")
    gen = torch.Generator(dev).manual_seed(seed + 16)
    batch = {"frontend_embeds": torch.randn(
                 (1, TRAIN_SEQ, cfg.frontend_dim), generator=gen,
                 device=dev).to(torch.bfloat16),
             "labels": torch.randint(0, cfg.vocab, (1, TRAIN_SEQ),
                                     generator=gen, device=dev)}
    hist, after, n_params, init_s = _train_fixed(cfg, dev, seed, batch,
                                                 steps)
    res = dict(card=_card_line(), layers=cfg.n_layers, params=n_params,
               init_s=init_s, history=hist, after=after,
               falls=_falls(hist, after),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               launches=_all_counts(), **_step_stats(hist, TRAIN_SEQ))
    _family_report("16c HuBERT-xlarge (48 layers)", res, failures)
    log(f"  16c: {cfg.n_layers} enc layers, d {cfg.d_model}; batch of "
        f"frontend_embeds (1, {TRAIN_SEQ}, {cfg.frontend_dim}) bf16 and "
        f"{TRAIN_SEQ} labels over {cfg.vocab} units; the batch's loss after "
        f"{steps} steps {after:.5f}; falls over the steps {res['falls']}")
    if not res["falls"]:
        failures.append(f"16c: the fixed batch's loss did not fall: "
                        f"{hist}, {after}")
    return res


def _steps_scan(xi, dt, bmat, cmat, a_log, chunk, out_dtype=None):
    """``selective_scan``'s signature over the per-token recurrence."""
    from repro_torch.models import ssm
    y, h = ssm.selective_scan_steps(xi, dt, bmat, cmat, a_log)
    return y.to(out_dtype or xi.dtype), h


def _mamba_block(cfg, dev, seed):
    from repro_torch.models.transformer import Block
    blk = Block(cfg, ("mamba", "mlp"), torch.float32, dev,
                torch.Generator(dev).manual_seed(seed))
    return blk.requires_grad_(True)


def _mamba_grads(blk, x, cot):
    pos = torch.arange(x.shape[1], dtype=torch.int32,
                       device=x.device).expand(x.shape[0], -1)
    out, _ = blk.train_forward(x, pos)
    return torch.autograd.grad(out, [x, *blk.parameters()], cot)


def _phase16d_mamba(dev, seed, failures):
    """16d: one Block(("mamba", "mlp")) at Jamba-v0.1's width, float32
    masters: forward and backward at B 1, S 4,096 in bf16 (device ms,
    peak memory); then in float32 at S 512 its gradients through the
    chunked scan against the per-token recurrence."""
    import dataclasses
    from unittest import mock

    from repro_torch.models import ssm
    _reset_counts()
    full = _train_cfg(0, "jamba_v01_52b")
    gen = torch.Generator(dev).manual_seed(seed + 17)
    blk = _mamba_block(full, dev, seed)
    n_params = sum(p.numel() for p in blk.parameters())
    x = torch.randn((1, TRAIN_SEQ, full.d_model), generator=gen,
                    device=dev).to(torch.bfloat16).requires_grad_(True)
    cot = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    _mamba_grads(blk, x, cot)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    grads = _mamba_grads(blk, x, cot)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del grads
    dev_ms = _device_ms(lambda: _mamba_grads(blk, x, cot), 2)
    del blk, x, cot
    gc.collect()
    torch.cuda.empty_cache()
    # the recurrence check, float32 compute at S 512
    cfg32 = dataclasses.replace(full, compute_dtype="float32")
    blk = _mamba_block(cfg32, dev, seed)
    x = torch.randn((1, MAMBA_CHECK_SEQ, full.d_model), generator=gen,
                    device=dev).requires_grad_(True)
    cot = torch.randn(x.shape, generator=gen, device=dev)
    got = _mamba_grads(blk, x, cot)
    with mock.patch.object(ssm, "selective_scan", _steps_scan):
        want = _mamba_grads(blk, x, cot)
    names = ["x", *(n for n, _ in blk.named_parameters())]
    errs = {n: float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for n, g, w in zip(names, got, want)}
    worst = max(errs, key=errs.get)
    del blk, x, cot, got, want
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(card=_card_line(), d=full.d_model,
               di=full.ssm_expand * full.d_model, ds=full.ssm_d_state,
               chunk=full.ssm_chunk, params=n_params, seq=TRAIN_SEQ,
               fwd_bwd_wall_ms=wall_ms, fwd_bwd_device_ms=dev_ms,
               tokens_per_s=TRAIN_SEQ / (wall_ms / 1e3), peak_bytes=peak,
               layer_peak_bytes=peak - base, finite=finite,
               check_seq=MAMBA_CHECK_SEQ, grad_errors=errs,
               worst=(worst, errs[worst]), launches=_all_counts())
    log(f"  16d Jamba-v0.1's Mamba block ((mamba, mlp), d {res['d']}, di "
        f"{res['di']}, ds {res['ds']}, chunk {res['chunk']}; {n_params} "
        f"float32 masters): {res['card']}; forward + backward at 1 x "
        f"{TRAIN_SEQ} in bf16: wall {wall_ms:.1f} ms, device {dev_ms:.1f} "
        f"ms, {res['tokens_per_s']:.0f} tokens/s; peak {peak} bytes, "
        f"{peak - base} above the layer's weights and inputs; finite "
        f"{finite}; gradients at S {MAMBA_CHECK_SEQ} in float32, chunked "
        f"scan against the per-token recurrence: worst leaf {worst} "
        f"{errs[worst]:.3g} of its largest magnitude (limit "
        f"{MAMBA_GRAD_TOL:g}); kernel launches {res['launches'] or 'none'}")
    if not finite:
        failures.append("16d: a non-finite gradient at S 4,096")
    if errs[worst] > MAMBA_GRAD_TOL:
        failures.append(f"16d: the chunked scan's gradients differ from the "
                        f"recurrence's: {errs}")
    if res["launches"]:
        failures.append(f"16d: a kernel launched on a path that runs none: "
                        f"{res['launches']}")
    return res


def _phase16e_xlstm(dev, seed, failures, steps):
    """16e: xLSTM-350M whole through the ``Trainer`` at sequences of 512."""
    import tempfile

    from repro_torch.train.train_step import make_eval_step
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = _train_cfg(0, "xlstm_350m")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        tr = _trainer(cfg, dev, seed, tmp, steps, lr=FAMILY_LR, warmup=1,
                      seq=XLSTM_TRAIN_SEQ)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        n_params = sum(p.numel() for p in tr.params.values())
        eval_step = make_eval_step(cfg)
        first = _batches(cfg, dev, 1, XLSTM_TRAIN_SEQ)[0]
        before = float(eval_step(tr.model, first)["loss"])
        hist = tr.train(steps, log_every=10 ** 9)
        after = float(eval_step(tr.model, first)["loss"])
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    res = dict(card=_card_line(), layers=cfg.n_layers, params=n_params,
               init_s=init_s, history=hist, eval_loss=(before, after),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               launches=_all_counts(), **_step_stats(hist, XLSTM_TRAIN_SEQ))
    _family_report("16e xLSTM-350M (24 layers)", res, failures)
    log(f"  16e: batch 1 x {XLSTM_TRAIN_SEQ} (cut from {TRAIN_SEQ}), mLSTM "
        f"chunks of {cfg.xlstm_chunk}, the sLSTM token by token; first "
        f"batch's loss {before:.5f} before, {after:.5f} after {steps} steps")
    if not after < before:
        failures.append(f"16e: the first batch's loss did not fall: "
                        f"{before} -> {after}")
    if before != hist[0]["loss"]:
        failures.append(f"16e: the twin pipeline's first batch is not the "
                        f"trainer's: {before} against {hist[0]['loss']}")
    return res


def phase_training_families(dev, seed, failures, steps=MOE_TRAIN_STEPS):
    """Phase 16: the rest of training on the card, each sub-phase alone
    (see the module docstring).  ``steps``: 16a's step count."""
    out, secs = {}, {}
    for key, fn, args in (
            ("16a", _phase16a_mixtral, (steps,)),
            ("16b", _phase16b_deepseek, (FAMILY_STEPS,)),
            ("16c", _phase16c_hubert, (FAMILY_STEPS,)),
            ("16d", _phase16d_mamba, ()),
            ("16e", _phase16e_xlstm, (FAMILY_STEPS,))):
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out[key] = fn(dev, seed, failures, *args)
        secs[key] = time.perf_counter() - t
        log(f"  phase {key}: {secs[key]:.1f} s")
    launches = {}
    for res in out.values():
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(out, seconds=secs, launches=launches)


CALIBRATION_TOL = 0.10        # phase 17: |predicted - measured| / measured


def _calibrate(label, cfg, dev, seed, failures):
    """Phase 17's check of one config: the dry run's trace (meta tensors,
    on the host) of one train step at batch 1 x TRAIN_SEQ, then the same
    step on the card from fresh float32 masters and AdamW state; the
    predicted peak (argument + temp bytes) against the bytes the step
    allocated at its peak above what was allocated before the model."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    spec = ShapeSpec(f"train_1x{TRAIN_SEQ}", TRAIN_SEQ, 1, "train")
    t = time.perf_counter()
    res = trace_cell(cfg, spec)
    trace_s = time.perf_counter() - t
    launched = _all_counts()
    mem = res["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(dev).manual_seed(seed)
    model = Transformer(cfg, device=dev, param_dtype=cfg.param_dtype,
                        generator=gen)
    model.requires_grad_(True)
    state = adamw.init_state(dict(model.named_parameters()))
    batch = {k: torch.randint(0, cfg.vocab, (1, TRAIN_SEQ), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, adamw.AdamWConfig())
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, state, m = step(model, state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    measured = torch.cuda.max_memory_allocated(dev) - base
    del model, state, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    err = (predicted - measured) / measured
    flops = res["analysis"]["flops"]
    # phase 15's mfu numerator: 6 N a token (N_active for an MoE) plus
    # causal attention, 6 L S H hd
    n_active = n_params - (cfg.n_layers * (cfg.n_experts - cfg.moe_top_k)
                           * 3 * cfg.d_model * cfg.moe_d_ff
                           if cfg.n_experts else 0)
    mfu_flops = (6 * n_active + 6 * cfg.n_layers * TRAIN_SEQ * cfg.n_heads
                 * cfg.hd) * TRAIN_SEQ
    out = dict(label=label, arch=cfg.name, layers=cfg.n_layers,
               params=n_params, trace_s=trace_s, ops=res["ops"],
               argument_bytes=mem["argument_bytes"],
               temp_bytes=mem["temp_bytes"], predicted_peak=predicted,
               measured_peak=measured, allocated_before=base,
               peak_error=err, counted_flops=flops,
               counted_bytes=res["analysis"]["bytes"],
               transcendentals=res["analysis"]["transcendentals"],
               model_flops=res["roofline"]["model_flops_global"],
               mfu_flops=mfu_flops, roofline=res["roofline"],
               step_s=step_s, loss=loss, trace_launches=launched,
               peak=res["peak"], bytes_by_op=res["bytes_by_op"])
    log(f"  {label} {cfg.name}, {cfg.n_layers} layers, batch 1 x "
        f"{TRAIN_SEQ}, remat {cfg.remat!r}: trace {trace_s:.1f} s, "
        f"{res['ops']} ops; predicted peak {predicted} bytes (arguments "
        f"{mem['argument_bytes']} + temp {mem['temp_bytes']}), measured "
        f"max_memory_allocated {measured} above {base} before: error "
        f"{err:+.4f} (limit {CALIBRATION_TOL}); counted {flops:.6e} FLOPs, "
        f"{res['analysis']['bytes']:.6e} bytes, against the mfu's "
        f"{mfu_flops:.6e} (ratio {flops / mfu_flops:.4f}) and 6 N D "
        f"{out['model_flops']:.6e}; roofline compute "
        f"{res['roofline']['compute_s'] * 1e3:.1f} ms, memory "
        f"{res['roofline']['memory_s'] * 1e3:.1f} ms; one step on the card "
        f"{step_s:.2f} s, loss {loss:.5f}")
    log(f"  {label} at the traced peak (reached by {res['peak']['op']}), "
        f"live GB by the op that made them: "
        f"{[(k, round(v / 1e9, 3)) for k, v in list(res['peak']['by_op'].items())[:8]]}; "
        f"counted GB by op: {[(k, round(v / 1e9, 1)) for k, v in list(res['bytes_by_op'].items())[:8]]}")
    if not abs(err) <= CALIBRATION_TOL:
        failures.append(f"17 {label}: predicted peak {predicted} is "
                        f"{err:+.4f} off the measured {measured}")
    if not np.isfinite(loss):
        failures.append(f"17 {label}: the step's loss is {loss}")
    return out


def phase_dryrun_calibration(dev, seed, failures):
    """Phase 17: the dry run's predicted peak memory held against the
    card's, for Qwen2.5-3B whole (17a, phase 15's shape) and Mixtral-8x7B
    at 2 layers (17b, phase 16a's)."""
    from repro_torch.launch.mesh import HBM_BYTES
    _reset_counts()
    total = torch.cuda.get_device_properties(dev).total_memory
    card = _card_line()
    log(f"  {card}; total_memory {total} bytes (launch.mesh.HBM_BYTES "
        f"{HBM_BYTES})")
    out = dict(card=card, total_memory=total)
    for key, cfg in (("17a", _train_cfg()),
                     ("17b", _train_cfg(TRAIN_CHECK_LAYERS,
                                        "mixtral_8x7b"))):
        out[key] = _calibrate(key, cfg, dev, seed, failures)
    out["launches"] = _all_counts()
    if out["launches"]:
        failures.append(f"17: a kernel launched: {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the device mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 2                # 18a: plain and sharded steps from one start
MESH_CELLS = (("qwen2_5_3b", "train_4k"), ("mixtral_8x7b", "decode_32k"))
MESH_NAMES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
MESH_LIMIT_S = 900            # 18b's children
DISTINCT_SIM = 4              # 18d: phase 4's queries, evenly spaced
DISTINCT_BOOL = 4             # 18d: phase 3's queries of each class


class _MeshShape:
    """A mesh's axis names and shape, for the sharding rules' shard
    sizes without a process group."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, object)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _world_of_one() -> dict:
    """torchrun's environment for a world of one."""
    return dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))


def _full(x) -> float:
    from repro_torch.dist import ctx as dctx
    return float(x.full_tensor() if dctx.is_dtensor(x) else x)


def _mesh_steps(cfg, dev, seed, batch, mesh):
    """MESH_STEPS train steps of fresh float32 masters of ``cfg`` from
    ``seed`` on ``batch``: plain, or with every leaf placed on ``mesh``
    by the rules.  -> (history, {"named": parameter specs naming a mesh
    axis, "leaves": leaves placed, "dtensor_params"})."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    model = Transformer(cfg, device=dev, param_dtype=cfg.param_dtype,
                        generator=torch.Generator(dev).manual_seed(seed))
    model.requires_grad_(True)
    state = adamw.init_state(dict(model.named_parameters()))
    placed = dict(named=0, leaves=0, dtensor_params=0)
    if mesh is not None:
        params = dict(model.named_parameters())
        specs = SH.param_shardings(params, mesh)
        placed["named"] = sum(any(e is not None for e in s.spec)
                              for _, s in SH.leaves_with_path(specs))
        state, batch = TS.shard_train_state(model, state, dict(batch), mesh)
        placed["leaves"] = 3 * len(params) + len(batch)
        placed["dtensor_params"] = sum(hasattr(p, "placements")
                                       for p in model.parameters())
    step = TS.make_train_step(cfg, _train_opt(MESH_STEPS, warmup=1))
    hist = []
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        _, state, m = step(model, state, batch)
        loss, gn = _full(m["loss"]), _full(m["grad_norm"])
        torch.cuda.synchronize(dev)
        hist.append(dict(loss=loss, grad_norm=gn,
                         ms=(time.perf_counter() - t) * 1e3))
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return hist, placed


def _phase18a_sharded_step(dev, seed, failures):
    """18a: the sharded train step on an NCCL group of one against the
    plain step (see the module docstring)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    cfg = _train_cfg()
    batch = _batches(cfg, dev, 1)[0]
    os.environ.update(_world_of_one())
    card = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", device_id=card)
    try:
        mesh = make_local_mesh()
        plain, _ = _mesh_steps(cfg, dev, seed, batch, None)
        sharded, placed = _mesh_steps(cfg, dev, seed, batch, mesh)
    finally:
        dist.destroy_process_group()
    equal = all(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                for a, b in zip(plain, sharded))
    added = sharded[-1]["ms"] - plain[-1]["ms"]
    log(f"  18a {cfg.name} whole ({cfg.n_layers} layers), batch 1 x "
        f"{TRAIN_SEQ}, mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
        f"NCCL: {placed['leaves']} leaves placed, "
        f"{placed['dtensor_params']} DTensor parameters, {placed['named']} "
        f"parameter specs naming an axis; losses plain "
        f"{[h['loss'] for h in plain]} sharded "
        f"{[h['loss'] for h in sharded]}; grad norms plain "
        f"{[h['grad_norm'] for h in plain]} sharded "
        f"{[h['grad_norm'] for h in sharded]}; bit-equal {equal}; step ms "
        f"plain {[round(h['ms'], 1) for h in plain]} sharded "
        f"{[round(h['ms'], 1) for h in sharded]}; DTensor dispatch adds "
        f"{added:.1f} ms a step ({added / plain[-1]['ms']:+.1%})")
    if not equal:
        failures.append(f"18a: the sharded step differs from the plain "
                        f"one: {plain} vs {sharded}")
    if not placed["dtensor_params"]:
        failures.append("18a: no parameter was a DTensor")
    return dict(arch=cfg.name, layers=cfg.n_layers, seq=TRAIN_SEQ,
                mesh=list(mesh.shape), plain=plain, sharded=sharded,
                bit_equal=equal, added_host_ms=added, **placed)


def _start_dryruns(tmp):
    """18b's children: one ``launch.dryrun`` a (cell, mesh), started at
    once, at a lower priority than the card's phase beside them."""
    procs = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape in MESH_CELLS:
        for name in MESH_NAMES:
            log_path = Path(tmp) / f"{arch}-{shape}-{name}.log"
            procs[(arch, shape, name)] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", name,
                 "--out", str(tmp)], cwd=ROOT, env=env,
                stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(10)), log_path,
                time.perf_counter())
    return procs


def _phase18b_dryruns(procs, tmp, failures):
    """18b: wait for the children, read each cell's result and hold its
    per-device argument bytes against the rules' shard sizes."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import shard_bytes
    from repro_torch.launch.mesh import HBM_BYTES
    out = {}
    for (arch, shape, name), (proc, log_path, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, MESH_LIMIT_S - (
                time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        secs = time.perf_counter() - t0
        tag = f"{arch}-{shape}-{name}"
        path = Path(tmp) / f"{tag}.json"
        res = json.loads(path.read_text()) if path.is_file() else {}
        if rc != 0 or "memory" not in res:
            tail = log_path.read_text()[-1500:] if log_path.is_file() \
                else ""
            failures.append(f"18b {tag}: exit {rc}, "
                            f"{res.get('error', 'no result')}; {tail}")
            log(f"  {failures[-1]}")
            out[tag] = dict(rc=rc, seconds=secs, error=res.get("error"))
            continue
        cfg = configs.get_config(arch)
        want = shard_bytes(cfg, shape, _MeshShape(*MESH_NAMES[name]))
        mem, r = res["memory"], res["roofline"]
        peak = mem["argument_bytes"] + mem["temp_bytes"]
        coll = {k: v for k, v in res["collectives"].items() if k != "total"}
        log(f"  18b {tag} ({res['mesh']}, {res['chips']} cards): trace "
            f"{res['compile_s']} s ({secs:.1f} s with start-up), "
            f"{res['ops']} ops; per device argument {mem['argument_bytes']} "
            f"bytes (rules' shards {want}), temp {mem['temp_bytes']}, peak "
            f"{peak} ({peak / 1e9:.2f} GB, fits {HBM_BYTES / 1e9:.2f} GB: "
            f"{peak <= HBM_BYTES}); collective bytes {coll} in "
            f"{res.get('collective_calls')} calls; compute "
            f"{r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, "
            f"collective {r['collective_s']:.4e} s: {r['dominant']}")
        if mem["argument_bytes"] != want:
            failures.append(f"18b {tag}: argument bytes "
                            f"{mem['argument_bytes']} != the rules' {want}")
            log(f"  {failures[-1]}")
        out[tag] = dict(rc=rc, seconds=secs, mesh=res["mesh"],
                        chips=res["chips"], trace_s=res["compile_s"],
                        ops=res["ops"], memory=mem, rules_bytes=want,
                        peak=peak, fits=peak <= HBM_BYTES,
                        collectives=res["collectives"],
                        collective_calls=res.get("collective_calls"),
                        roofline=r)
    return out


def _phase18c_launcher(tmp, failures):
    """18c: the train launcher with ``--distributed`` under a world of
    one, 2 steps of the reduced Qwen2.5-3B on the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **_world_of_one())
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--distributed", "--arch", "qwen2.5-3b", "--reduced", "--steps",
           "2", "--ckpt", str(Path(tmp) / "ckpt")]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t
    log(f"  18c {' '.join(cmd[1:])}: exit {proc.returncode} in "
        f"{secs:.1f} s")
    if proc.returncode != 0:
        failures.append(f"18c: the launcher exited {proc.returncode}: "
                        f"{proc.stderr[-2000:]}")
    return dict(cmd=cmd[1:], rc=proc.returncode, seconds=secs)


def phase_device_mesh(dev, seed, failures):
    """Phase 18a-c (18d runs after phase 9, on its index): see the module
    docstring."""
    import tempfile
    from repro_torch.dist import ctx as dctx
    with tempfile.TemporaryDirectory() as tmp:
        procs = _start_dryruns(tmp)
        try:
            _reset_counts()                 # the mesh path starts here
            step = _phase18a_sharded_step(dev, seed, failures)
            launcher = _phase18c_launcher(tmp, failures)
            launches = _all_counts()        # and ends here
        finally:
            dryruns = _phase18b_dryruns(procs, tmp, failures)
    if launches:
        failures.append(f"18: a kernel launched: {launches}")
    if dctx.current_mesh() is not None:
        failures.append("18: a mesh stayed current")
    return {"18a": step, "18b": dryruns, "18c": launcher,
            "launches": launches}


def phase_distinct_shards(dev, ctx, sim_cases, failures):
    """18d: phase 9's index over a ``WideMesh`` of (card, CPU, card, CPU);
    see the module docstring."""
    from repro_torch.core import aggregate
    from repro_torch.dist import WideMesh
    from repro_torch.kernels import segment_ops as so
    from repro_torch.kernels import topk_ops as tk
    index = ctx["index"]
    cpu = torch.device("cpu")
    mesh = WideMesh([dev, cpu, dev, cpu])
    _reset_counts()                         # the distinct-device path
    t = time.perf_counter()
    shards = index.arena.shard_slabs(mesh)
    shards.sync()
    slabs_s = time.perf_counter() - t
    on_card = [int(b.numel() * 4) for b in shards._bufs]

    def gathered():
        return sum(st.rows_gathered for st in shards.stats)

    cases = [c for c in sim_cases if not c["term"].startswith("unknown")]
    cases = cases[::max(1, len(cases) // DISTINCT_SIM)][:DISTINCT_SIM]
    wrong, rows, ms = 0, [], []
    for c in cases:
        g0 = gathered()
        t = time.perf_counter()
        got = index.similar(c["term"], c["k"], c["metric"], mesh=mesh)
        ms.append((time.perf_counter() - t) * 1e3)
        rows.append(gathered() - g0)
        wrong += not _same_sim(got, c["answer"])
    bool_wrong, bool_rows = 0, {}
    for cls in CLASSES:
        plans = [_plan(index, cls, q)
                 for q in ctx["traffic"][cls][:DISTINCT_BOOL]]
        g0 = gathered()
        outs = aggregate.execute_plans(plans, mesh=mesh)
        bool_rows[cls] = (gathered() - g0) / max(1, len(plans))
        bool_wrong += sum(not np.array_equal(_to_packed(g), w) for g, w in
                          zip(outs, ctx["answers"][cls]))
    # warm: the boolean queries and the cheapest similarity query again
    # upload no row (the first pass may patch a row an earlier phase edited)
    up0 = sum(st.rows_uploaded for st in shards.stats)
    cheap = cases[int(np.argmin(rows))]
    wrong += not _same_sim(index.similar(cheap["term"], cheap["k"],
                                         cheap["metric"], mesh=mesh),
                           cheap["answer"])
    for cls in CLASSES:
        again = [_plan(index, cls, q)
                 for q in ctx["traffic"][cls][:DISTINCT_BOOL]]
        bool_wrong += sum(
            not np.array_equal(_to_packed(g), w) for g, w in zip(
                aggregate.execute_plans(again, mesh=mesh),
                ctx["answers"][cls]))
    warm = sum(st.rows_uploaded for st in shards.stats) - up0
    launches = {**dict(tk.launches_by_stage),
                "segment_reduce": so.launches}
    log(f"  18d {mesh}: slabs {on_card} bytes, built in {slabs_s:.2f} s; "
        f"{len(cases)} similar(mesh=) queries, wrong {wrong}, p50 "
        f"{np.percentile(ms, 50):.1f} ms, rows gathered across devices a "
        f"query {rows}; {DISTINCT_BOOL} execute_plans(mesh=) queries of "
        f"each class, wrong {bool_wrong}, rows gathered a query "
        f"{bool_rows}; rows uploaded by a warm pass {warm}; launches "
        f"{launches}")
    if wrong or bool_wrong:
        failures.append(f"18d: {wrong} similarity and {bool_wrong} boolean "
                        f"answers differ from the single-device answers")
    if warm:
        failures.append(f"18d: a warm pass uploaded {warm} rows")
    if not sum(rows) or not any(bool_rows.values()):
        failures.append(f"18d: no query gathered a row across devices: "
                        f"{rows} {bool_rows}")
    if min(launches[k] for k in (*IDS_STAGES, "segment_reduce")) == 0:
        failures.append(f"18d: a card shard launched no kernel {launches}")
    return dict(mesh=str(mesh), slab_bytes=on_card, slabs_s=slabs_s,
                sim_queries=len(cases), sim_wrong=wrong,
                sim_rows_gathered=rows, sim_ms=ms, bool_wrong=bool_wrong,
                bool_rows_gathered=bool_rows, rows_uploaded=warm,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 17c: a prefill's decode state on a production mesh
# ---------------------------------------------------------------------------

STATE_CELL = ("qwen2_5_3b", "prefill_32k")   # 17c's placed state, whole
STATE_TRACE = ("mixtral_8x7b", 4096)         # 17c's traced prefill, cut


def phase_prefill_state(dev, seed, failures):
    """Phase 17c: what a prefill's decode state costs one device of the
    (16, 16) production mesh in the dry run (see the module docstring)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.dist import ctx as dctx
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.transformer import Transformer
    _reset_counts()
    out = {}
    try:
        mesh = dryrun.production_mesh("single")
        arch, shape = STATE_CELL
        cfg, spec = configs.get_config(arch), configs.SHAPES[shape]
        local, whole = dryrun.state_bytes(cfg, spec, mesh)
        model = Transformer(cfg, device="meta")
        t = time.perf_counter()
        with dctx.activate(mesh), OpAnalysis(torch.device("meta")) as oa, \
                dctx.on_mesh(mesh):
            model.placed_decode_state(spec.global_batch, spec.seq_len, mesh)
        res = oa.result()
        log(f"  17c {arch}-{shape} on 16 x 16: placed_decode_state counts "
            f"temp {res['temp_bytes']} bytes, live {res['peak_by_op']} in "
            f"{time.perf_counter() - t:.1f} s; the rules' shard "
            f"{local} bytes of a global {whole} ({whole / 1e9:.2f} GB)")
        if res["temp_bytes"] != local or \
                res["peak_by_op"] != {"decode_state": local}:
            failures.append(f"17c: {arch}-{shape}'s placed state counts "
                            f"{res['peak_by_op']}, not its shard {local}")
        out["placed"] = dict(cell=f"{arch}-{shape}", temp_bytes=res[
            "temp_bytes"], shard_bytes=local, global_bytes=whole)
        arch, seq = STATE_TRACE
        cfg = configs.get_config(arch)
        spec = configs.ShapeSpec(f"prefill_{seq}", seq,
                                 configs.SHAPES["prefill_32k"].global_batch,
                                 "prefill")
        local, whole = dryrun.state_bytes(cfg, spec, mesh)
        t = time.perf_counter()
        res = dryrun.trace_cell(cfg, spec, mesh=mesh)
        secs = time.perf_counter() - t
        want = dryrun.shard_bytes(cfg, spec, mesh)
        by_op, mem = res["peak"]["by_op"], res["memory"]
        at_peak = by_op.get("decode_state", 0)
        log(f"  17c {arch} prefill {spec.global_batch} x {seq} on 16 x 16: "
            f"trace {secs:.1f} s, {res['ops']} ops; argument "
            f"{mem['argument_bytes']} bytes (rules' {want}), temp "
            f"{mem['temp_bytes']}; peak at {res['peak']['op']}, the decode "
            f"state there {at_peak} bytes against its shard {local} (global "
            f"{whole}); live at the peak by op {by_op}")
        if at_peak != local or "zeros" in by_op:
            failures.append(f"17c: the decode state live at {arch}'s "
                            f"prefill peak is {at_peak} bytes, not its "
                            f"shard {local} ({by_op})")
        if mem["argument_bytes"] != want:
            failures.append(f"17c: argument bytes {mem['argument_bytes']} "
                            f"!= the rules' {want}")
        out["traced"] = dict(cell=f"{arch}-prefill_{seq}", trace_s=secs,
                             ops=res["ops"], memory=mem, rules_bytes=want,
                             state_at_peak=at_peak, shard_bytes=local,
                             global_bytes=whole, peak=res["peak"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out["launches"] = _all_counts()
    if out["launches"]:
        failures.append(f"17c: a kernel launched: {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 19: the port's examples
# ---------------------------------------------------------------------------

EXAMPLE_RUNS = ("torch_quickstart", "torch_query_server",
                "torch_train_tiny_lm", "torch_constrained_serve",
                "torch_analytics_index")
EXAMPLES_LIMIT_S = 90.0
# a kernel each example's path must launch on the card
EXAMPLE_KERNELS = {"torch_quickstart": "popcount",
                   "torch_query_server": "score",
                   "torch_constrained_serve": "decode_attention",
                   "torch_analytics_index": "segment_reduce"}


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(dev, seed, failures):
    """Phase 19: the five port examples at their default sizes on the card,
    in this process through their ``main`` (see the module docstring)."""
    import tempfile
    out = {}
    total = {}
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLE_RUNS:
            argv = ["--ckpt-dir", str(Path(tmp) / "ckpt")] \
                if name == "torch_train_tiny_lm" else []
            log(f"  19 {name} {' '.join(argv)}")
            _reset_counts()
            t = time.perf_counter()
            try:
                res = _example(name).main(argv)
                torch.cuda.synchronize(dev)
            except Exception as e:      # one example's failure is recorded
                failures.append(f"19 {name}: {type(e).__name__}: {e}")
                log(f"  {failures[-1]}")
                continue
            secs = time.perf_counter() - t
            launches = _all_counts()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            out[name] = dict(seconds=secs, launches=launches)
            log(f"  19 {name}: {secs:.2f} s, launches {launches}")
            need = EXAMPLE_KERNELS.get(name)
            if need and not launches.get(need):
                failures.append(f"19 {name}: {need} launched no time")
            if name == "torch_train_tiny_lm":
                out[name].update(first10=res["first"], last10=res["last"],
                                 steps=res["steps"])
                if not res["last"] < res["first"]:
                    failures.append(f"19 {name}: the loss did not fall: "
                                    f"{res['first']} -> {res['last']}")
    out["seconds"] = time.perf_counter() - t_all
    out["launches"] = total
    log(f"  19: the five examples in {out['seconds']:.1f} s "
        f"(limit {EXAMPLES_LIMIT_S:.0f} s)")
    if out["seconds"] > EXAMPLES_LIMIT_S:
        failures.append(f"19: the examples took {out['seconds']:.1f} s, "
                        f"past {EXAMPLES_LIMIT_S:.0f} s")
    return out


# ---------------------------------------------------------------------------

def _build_all():
    """Build every kernel source at once, one nvcc each, in parallel.
    Returns {source: (seconds, registers, spill stores)}."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def one(name):
        t = time.perf_counter()
        _build.library(name)
        return name, time.perf_counter() - t

    with ThreadPoolExecutor(len(SOURCES_CU)) as pool:
        done = dict(pool.map(one, SOURCES_CU))
    out = {}
    for name, secs in done.items():
        ptxas = _build.build_logs.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                            ptxas)]
        out[name] = (secs, regs, spill)
        log(f"  {name}: nvcc {secs:.2f} s; " + (
            f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, spill stores up to {max(spill, default=0)} bytes"
            if regs else "library was already built, no report"))
    return out


def _kernel_line(main_path, sim, cases, topk_cases, max_err, topk_err,
                 pair_cases, pair_err, pairwise, convert_cases, convert_err,
                 tensor, section4_cases, section4_err, surface, ids_cases,
                 ids_err, sharded, bsa_cases, bsa_err, serving, jamba,
                 later):
    rep = next(c for c in cases if c["case"] == "main/ids/or")
    jamba_case = next(c for c in bsa_cases if c["case"] == "jamba (g=4)")
    score = next(c for c in topk_cases
                 if c["case"] == "score/main/jaccard/exclude=-1")
    select = next(c for c in topk_cases if c["case"] == "select/jaccard/k=10")
    src = "src/repro_torch/kernels/csrc/"

    def row(name, source, replaces, launches, err, c):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c.get("library_ms")}

    rows = [
        # no single PyTorch call computes a segmented bitwise reduce fused
        # with a popcount, nor a segmented AND-popcount fused with a score
        row("segment_reduce", "segment_reduce.cu",
            "src/repro/kernels/segment_ops.py:243", main_path["launches"],
            max_err, dict(rep, library_ms=None)),
        row("similarity_score", "similarity_topk.cu",
            "src/repro/kernels/topk_ops.py:147", sim["launches"]["score"],
            topk_err, score),
        # times on the device (the profiler), since CUDA events around a
        # loop of launches of microseconds time the host; library_ms:
        # torch.sort(stable, descending)[:k], the same function
        row("similarity_select", "similarity_topk.cu",
            "src/repro/kernels/topk_ops.py:166", sim["launches"]["select"],
            topk_err, dict(select, ms=select["device_ms"],
                           plain_ms=select["device_plain_ms"],
                           library_ms=select["device_library_ms"])),
    ] + [
        # the pair kernels at M = 8,192 rows (a count batch), device times
        # from the profiler; library_ms: torch.searchsorted of one side
        # into the other and the equality test for the array kernels, none
        # for the bitset ones (PyTorch has no popcount) or the probe
        row(name, source, f"src/repro/kernels/{site}",
            pairwise["launches"][name], pair_err[name],
            next(c for c in pair_cases
                 if c["case"] == f"main/M=8192/{name}"))
        for name, source, site in (
            ("bitset_pair_op", "pair_ops.cu", "pair_ops.py:90"),
            ("bitset_pair_card", "pair_ops.cu", "pair_ops.py:118"),
            ("array_bitset_probe", "pair_ops.cu", "pair_ops.py:169"),
            ("array_pair_masks", "array_ops.cu", "array_ops.py:161"),
            ("array_intersect_card", "array_ops.cu", "array_ops.py:216"))
    ] + [
        # the conversion kernels and the popcount at M = 245,760 (one
        # to_words of the sparse terms), device times from the profiler;
        # launches of array_to_bitset from phase 7, of bitset_set_many
        # and popcount from phase 8 (RoaringTensor's run count forces the
        # plain popcount, as the JAX class does); library_ms: one
        # scatter_add_ of the masked values for array_to_bitset, none for
        # the two popcounts (PyTorch has no popcount)
        row(name, source, f"src/repro/kernels/{site}",
            launches[name], convert_err[name],
            next(c for c in convert_cases
                 if c["case"] == f"main/M={CONVERT_M}/{name}"))
        for name, source, site, launches in (
            ("array_to_bitset", "bitset_convert.cu", "bitset_convert.py:84",
             tensor["launches"]),
            ("bitset_set_many", "bitset_convert.cu",
             "bitset_convert.py:103", surface["launches"]),
            ("popcount", "popcount.cu", "harley_seal.py:99",
             surface["launches"]))
    ] + [
        # the section-4 kernels at M = 8,192 rows (bitset_op and
        # bitset_op_card with op "and"), device times from the profiler;
        # launches from phase 8; library_ms: torch.searchsorted of A into
        # B and the equality test for array_intersect, none for the two
        # bitset kernels (PyTorch has no popcount)
        row(name, source, f"src/repro/kernels/{site}",
            surface["launches"][name], section4_err[name],
            next(c for c in section4_cases
                 if c["case"] == f"main/M=8192/{label}"))
        for name, label, source, site in (
            ("bitset_op", "bitset_op/and", "bitset_ops.cu",
             "bitset_ops.py:69"),
            ("bitset_op_card", "bitset_op_card/and", "bitset_ops.cu",
             "bitset_ops.py:96"),
            ("array_intersect", "array_intersect", "array_ops.cu",
             "array_ops.py:83"))
    ] + [
        # the sharded similarity kernels, launches from phase 9: the score
        # over ids at row 5's size (T = 1,024 slots, 227,240 rows, CUDA
        # events; no PyTorch call computes it), the labelled select on the
        # merged S * k = 40 entries of a k = 10 query (device times;
        # library_ms: a stable torch.sort by score of the entries in
        # ascending id order)
        row("similarity_score_ids", "similarity_topk.cu",
            "src/repro/kernels/topk_ops.py:273",
            sharded["launches"]["score_ids"], ids_err,
            next(c for c in ids_cases
                 if c["case"] == "score_ids/main/jaccard")),
        row("topk_merge", "similarity_topk.cu",
            "src/repro/kernels/topk_ops.py:310",
            sharded["launches"]["select_ids"], ids_err,
            next(c for c in ids_cases
                 if c["case"] == "select_ids/merge/M=40/k=10")),
        # the decode attention kernel at Gemma2-27B's decode shape (phase
        # 2g, softcap 50, the engine's mask), device times; launches from
        # phase 10's and phase 12's two generates each; library_ms: one
        # F.scaled_dot_product_attention over the expanded boolean mask at
        # softcap 0 (it has no softcap), the same function there; and the
        # same numbers at Jamba's decode shape (g = 4, softcap 0)
        dict(row("decode_attention", "block_sparse_attn.cu",
                 "src/repro/kernels/block_sparse_attn.py:110",
                 serving["launches"] + jamba["launches"], bsa_err,
                 dict(next(c for c in bsa_cases if c["case"] == "live"),
                      library_ms=next(c for c in bsa_cases
                                      if c["case"] == "live/softcap=0")[
                                          "library_ms"])),
             launches_by_phase={"10": serving["launches"],
                                "12": jamba["launches"]},
             jamba_shape={k: jamba_case[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "max_abs_err", "shape")})]
    # launches in phases 13 to 19 (``later``: the counts by kernel), whose
    # paths run no kernel of the port but 18d's card shards and 19's
    # examples
    count_key = {"similarity_score": "score", "similarity_select": "select",
                 "similarity_score_ids": "score_ids",
                 "topk_merge": "select_ids"}
    for r in rows:
        key = count_key.get(r["name"], r["name"])
        r["launches_by_phase"] = dict(r.get("launches_by_phase", {}), **{
            ph: counts.get(key, 0) for ph, counts in later.items()})
    return {"kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the repository root (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    dev = torch.device("cuda")
    failures: list[str] = []
    t_all = time.perf_counter()
    phases = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phases[name] = time.perf_counter() - t
        log(f"phase {name}: {phases[name]:.1f} s")
        return out

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    builds = phase("1 (build every kernel)", _build_all)
    cases, max_err = phase("2 (segment_reduce against plain)",
                           phase_kernels, dev, args.seed, failures)
    log(f"  {len(cases)} cases, max_abs_err {max_err}")
    topk_cases, topk_err, topk_info = phase(
        "2b (score and select against plain)", phase_topk_kernels, dev,
        args.seed, failures)
    log(f"  {len(topk_cases)} cases, max_abs_err {topk_err}")
    pair_cases, pair_err = phase("2c (pair kernels against plain)",
                                 phase_pair_kernels, dev, args.seed,
                                 failures)
    log(f"  {len(pair_cases)} cases, max_abs_err {pair_err}")
    convert_cases, convert_err = phase(
        "2d (conversion kernels against plain)", phase_convert_kernels, dev,
        args.seed, failures)
    log(f"  {len(convert_cases)} cases, max_abs_err {convert_err}")
    section4_cases, section4_err = phase(
        "2e (section-4 kernels against plain)", phase_section4_kernels, dev,
        args.seed, failures)
    log(f"  {len(section4_cases)} cases, max_abs_err {section4_err}")
    ids_cases, ids_err = phase(
        "2f (sharded similarity kernels against plain)", phase_ids_kernels,
        dev, args.seed, failures)
    log(f"  {len(ids_cases)} cases, max_abs_err {ids_err}")
    bsa_cases, bsa_err = phase(
        "2g (decode attention against plain)", phase_bsa_kernel, dev,
        args.seed, failures)
    main_path, ctx = phase("3 (boolean queries at real scale)",
                           phase_main_path, dev, args.seed, failures)
    main_path["pair_launches"] = _pair_counts()
    main_path["convert_launches"] = _convert_counts()
    main_path["section4_launches"] = _section4_counts()
    main_path["ids_launches"] = _ids_counts()
    main_path["bsa_launches"] = _bsa_count()
    sim, sim_cases = phase("4 (similarity at real scale)",
                           phase_similarity, dev, ctx["index"],
                           ctx["sets"], args.seed, failures)
    sim["pair_launches"] = _pair_counts()
    sim["convert_launches"] = _convert_counts()
    sim["section4_launches"] = _section4_counts()
    sim["ids_launches"] = _ids_counts()
    sim["bsa_launches"] = _bsa_count()
    server = phase("5 (query server)", phase_server, dev, ctx["index"],
                   ctx["traffic"], ctx["answers"], sim_cases, failures)
    server["faults"] = phase("5 (query server under scripted faults)",
                             phase_server_faults, dev, ctx["postings"],
                             ctx["sets"], args.seed, failures)
    server["pair_launches"] = _pair_counts()
    server["convert_launches"] = _convert_counts()
    server["section4_launches"] = _section4_counts()
    server["ids_launches"] = _ids_counts()
    server["bsa_launches"] = _bsa_count()
    pairwise = phase("6 (two-by-two algebra at real scale)",
                     phase_pairwise, dev, ctx["index"], ctx["sets"],
                     args.seed, failures)
    pairwise["convert_launches"] = _convert_counts()
    pairwise["section4_launches"] = _section4_counts()
    pairwise["ids_launches"] = _ids_counts()
    pairwise["bsa_launches"] = _bsa_count()
    keep = {}
    tensor = phase("7 (RoaringTensor at real scale)", phase_tensor, dev,
                   ctx["postings"], ctx["sets"], args.seed, failures, keep)
    tensor["section4_launches"] = _section4_counts()
    tensor["ids_launches"] = _ids_counts()
    tensor["bsa_launches"] = _bsa_count()
    surface = phase("8 (the kernels.ops surface at real scale)",
                    phase_ops_surface, dev, ctx["index"], ctx["sets"],
                    failures)
    surface["ids_launches"] = _ids_counts()
    surface["bsa_launches"] = _bsa_count()
    sharded = phase("9 (the sharded paths at real scale)", phase_sharded,
                    dev, ctx, sim_cases, keep, failures)
    sharded["pair_launches"] = _pair_counts()
    sharded["convert_launches"] = _convert_counts()
    sharded["section4_launches"] = _section4_counts()
    sharded["bsa_launches"] = _bsa_count()
    ids_per_phase = [p["ids_launches"] for p in (main_path, sim, server,
                                                 pairwise, tensor, surface)]
    ids_per_phase.append({k: sharded["launches"][k] for k in IDS_STAGES})
    log("sharded similarity launches in phases 3 / 4 / 5 / 6 / 7 / 8 / 9: "
        + "  ".join(f"{k} " + " / ".join(str(p[k]) for p in ids_per_phase)
                    for k in IDS_STAGES))
    if any(p[k] for p in ids_per_phase[:-1] for k in IDS_STAGES):
        failures.append(f"a sharded similarity kernel launched outside "
                        f"phase 9: {ids_per_phase}")
    per_phase = [{**p["convert_launches"], **p["section4_launches"]}
                 for p in (main_path, sim, server, pairwise)]
    per_phase += [{**tensor["launches"], **tensor["section4_launches"]},
                  surface.get("launches", {}),
                  {**sharded["convert_launches"],
                   **sharded["section4_launches"]}]
    log("conversion, popcount and section-4 launches in phases 3 / 4 / 5 / "
        "6 / 7 / 8 / 9: " + "  ".join(
            f"{k} " + " / ".join(str(p.get(k)) for p in per_phase)
            for k in (*CONVERT_KERNELS, *SECTION4_KERNELS)))
    distinct = phase("18d (arena shards on distinct devices)",
                     phase_distinct_shards, dev, ctx, sim_cases, failures)
    cold = phase("11 (cold start and ingest at real scale)",
                 phase_cold_start, dev, ctx, sim_cases, args.seed, failures)
    cold_launches = {k: sum(cold[i]["launches"].get(k, 0) for i in
                            ("reload", "ingest", "pipeline"))
                     for k in (*IDS_STAGES, "decode_attention")}
    if any(cold_launches[k] for k in IDS_STAGES):
        failures.append(f"a sharded similarity kernel launched in phase "
                        f"11: {cold_launches}")
    bsa_per_phase = [p["bsa_launches"] for p in (
        main_path, sim, server, pairwise, tensor, surface, sharded)]
    bsa_per_phase.append(cold_launches["decode_attention"])

    # phase 10 runs alone on the card: release what phases 3-9 and 11 hold
    del ctx, keep, sim_cases
    gc.collect()
    torch.cuda.empty_cache()
    serving = phase("10 (Gemma2-27B serving at full width and depth)",
                    phase_serving, dev, args.seed, failures)
    bsa_per_phase.append(serving["launches"])

    # phase 12 runs alone on the card too: phase 10 has released its model
    gc.collect()
    torch.cuda.empty_cache()
    jamba = phase("12 (Jamba-v0.1 serving at full width, 16 of 32 layers)",
                  phase_jamba, dev, args.seed, failures)
    bsa_per_phase.append(jamba["launches"])
    log("decode_attention launches in phases 3 / 4 / 5 / 6 / 7 / 8 / 9 / "
        "11 / 10 / 12: " + " / ".join(map(str, bsa_per_phase)))
    if any(bsa_per_phase[:-2]):
        failures.append(f"decode_attention launched outside phases 10 and "
                        f"12: {bsa_per_phase}")

    # phases 13 and 14 run alone on the card too, after phase 12's model
    gc.collect()
    torch.cuda.empty_cache()
    deepseek = phase("13 (DeepSeek-V2 serving at full width, 8 of 60 "
                     "layers)", phase_deepseek, dev, args.seed, failures)
    gc.collect()
    torch.cuda.empty_cache()
    xlstm = phase("14 (xLSTM-350M serving and a HuBERT-xlarge encoder "
                  "prefill, whole)", phase_xlstm_hubert, dev, args.seed,
                  failures)
    # phase 15 runs alone on the card too, after phase 14's models
    gc.collect()
    torch.cuda.empty_cache()
    training = phase("15 (Qwen2.5-3B training at full width and depth)",
                     phase_training, dev, args.seed, failures)
    # phase 16 runs alone on the card too, each part after the last has
    # released its model
    gc.collect()
    torch.cuda.empty_cache()
    families = phase("16 (the rest of training: Mixtral-8x7B, DeepSeek-V2, "
                     "HuBERT-xlarge, Jamba's Mamba block, xLSTM-350M)",
                     phase_training_families, dev, args.seed, failures)
    # phase 17 after phase 16 has released its models
    gc.collect()
    torch.cuda.empty_cache()
    calibration = phase("17 (the dry run's peak memory against the card's)",
                        phase_dryrun_calibration, dev, args.seed, failures)
    prefill_state = phase("17c (a prefill's decode state on the 16 x 16 "
                          "mesh)", phase_prefill_state, dev, args.seed,
                          failures)

    # phase 18 after phase 17 has released its models
    gc.collect()
    torch.cuda.empty_cache()
    mesh18 = phase("18 (the device mesh: the sharded train step, the "
                   "production meshes' dry run, the launcher)",
                   phase_device_mesh, dev, args.seed, failures)
    mesh18["18d"] = distinct

    # phase 19 last: the examples, each on a card the phases before left
    gc.collect()
    torch.cuda.empty_cache()
    examples = phase("19 (the port's five examples at their default sizes)",
                     phase_examples, dev, args.seed, failures)

    kernels = _kernel_line(main_path, sim, cases, topk_cases, max_err,
                           topk_err, pair_cases, pair_err, pairwise,
                           convert_cases, convert_err, tensor,
                           section4_cases, section4_err, surface, ids_cases,
                           ids_err, sharded, bsa_cases, bsa_err, serving,
                           jamba, {"13": deepseek["launches"],
                                   "14": xlstm["launches"],
                                   "15": training["launches"],
                                   "16": families["launches"],
                                   "17": calibration["launches"],
                                   "17c": prefill_state["launches"],
                                   "18": mesh18["launches"],
                                   "18d": distinct["launches"],
                                   "19": examples["launches"]})
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(dict(
        card=card, builds=builds, kernel_cases=cases,
        topk_cases=topk_cases, topk_inputs=topk_info, main_path=main_path,
        similarity=sim, server=server, pair_cases=pair_cases,
        pairwise=pairwise, convert_cases=convert_cases, tensor=tensor,
        section4_cases=section4_cases, ops_surface=surface,
        ids_cases=ids_cases, sharded=sharded, cold_start=cold,
        bsa_cases=bsa_cases, serving=serving, jamba=jamba,
        deepseek=deepseek, xlstm_hubert=xlstm, training=training,
        training_families=families, dryrun_calibration=calibration,
        prefill_state=prefill_state, device_mesh=mesh18, examples=examples,
        bsa_launches_per_phase=bsa_per_phase,
        kernels=kernels["kernels"],
        phases_s=phases, failures=failures,
        total_s=time.perf_counter() - t_all), indent=1, default=str))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
