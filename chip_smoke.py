#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (two_tower_models_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 10] [--only sharded]

With ``--only sharded`` it runs phase 1 and phases 14 and 15 alone, and
the four-card legs must run (a host with four cards).

Phases, in the order they run; any failure exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of the CUDA kernels from csrc/ (nvcc, on
     first use; cached under two_tower_models_tpu_torch/_build/); beside the
     build, nvcc -Xptxas -v on csrc/fused_softmax.cu, csrc/fused_mha.cu,
     csrc/select_topk.cu, csrc/rows_write.cu, csrc/fused_encoder.cu,
     csrc/fused_encoder_bwd.cu, csrc/tile_max.cu, csrc/gather_rescore.cu,
     csrc/history_attention.cu and csrc/approx_scan.cu for the registers,
     stack and spills of each
     instance of B15's tensor-core kernel, of the CE forward (B10:
     ce_fwd_tc_kernel<MULTI>, MULTI for D > 64) and backward, of B13's and
     B14's tensor-core kernels (each instance, by key bands), of both select
     kernels, of each row-write instance, of each instance of the
     whole-encoder tensor-core kernel (encoder_tc_kernel<RES, STACK, Hp /
     16>: B1, B5, B8) and of its backward (encoder_bwd_tc_kernel<MODE, Hp /
     16, D>: B6, B7, B9), of the tile max (tile_max_kernel: B2) and of the
     gather-rescore's inversion and scoring kernels (B4) and of the
     approximate bin-max scan N1 (its tensor-core kernel's three instances,
     approx_scan_tc_kernel<ROWS: 0 f32, 1 int8, 2 bf16>, and the FMA
     kernel's two, approx_scan_kernel<INT8>), and their shared memory (a
     spill fails the run);
  2. kernels: each of the four kernels of the serving path is held against
     its plain PyTorch version on the card, on the tensors the serving path
     gives it, and timed beside that plain version, a one-call PyTorch
     yardstick where there is one, and its bound on an H100 SXM.  The
     whole-encoder forward (B1) takes the tensor cores (route "tc"), which
     sum in their own order: its y is held as B13's (at most 0.5% of values
     beyond one bf16 step from plain, all within 1e-2 of scale, at most 1.5
     times the plain version's count beyond one step from the same function
     with f64 sums, bit-equal on repeat), the FMA kernel on the same input
     within one step of plain; its device time beside the FMA kernel's and
     three B13 launches' on the same input; the tile max (B2) and the
     gather-rescore (B4) timed by device time beside their event times,
     B4's inversion launches apart from its scoring launch, B4's inverted
     selection equal to its plain version, B2's tile max at every selected
     tile equal to the max of B4's scores over it bit for bit, and B4 on a
     skewed selection (every query on the same 100 tiles) against plain and
     timed; the
     select (B3) on the radix route the path takes and, launched alone,
     on the tournament (k > K_MAX), each with its device time beside
     torch.topk's;
  3. serve: the full-width serving configuration (the exact leg of
     scripts/bench_serving.py: 2^20-item catalog, D=64, H=32, 3-layer 4-head
     bf16 history encoder, k=100, B=1024), weights random from --seed,
     through RetrievalEngine.from_params / warmup / query.  Launch counters
     are zeroed just before the timed batches and read just after: every
     kernel must have run, the select twice per batch on its radix route
     and never on the tournament.  Indices are held
     against the dense plain MIPS on the same user embeddings, and the user
     embeddings against the CPU run of the same model on a slice.  The user
     tower and the exact MIPS are then timed alone, for the breakdown of a
     batch's time;
  2b. serve, variable-length histories: the same engine warmed up with
     variable_history=True, then ten batches with lengths uniform in
     [1, 32] and id 0 past each length.  The length-masked attention stack
     (B8, on the tensor cores) is held and timed as B1 in phase 2 on the
     batch's own tensors;
     launch counts, indices and user embeddings are checked as in phase 3,
     with B8 in place of the whole-encoder forward;
  4. train: the flagship training configuration (bench.py's _bench_cfg,
     copied: 65,536-row user and item tables, D=64, 16 features, T=3,
     H=32, 3-layer 4-head bf16 encoder, Debias.BOTH, fused loss; B=4096,
     Adam at lr 1e-3), weights and one fixed batch random from --seed.
     The training kernels (encoder residual forward on the tensor cores,
     its y and residuals xs, ps, p0 held as B1's y in phase 2, and the
     encoder backward (B6, on the tensor cores) on the plain and on the
     kernel's residuals: within 3e-2 of scale of the plain version, against
     the backward with f64 sums at most 1.5 times the plain version's count
     of dx values beyond one bf16 step and its grads' RMS error, bit-equal
     on repeat, the FMA kernel on the same inputs within 3e-2 of scale; its
     device time beside the FMA kernel's, three B14 launches' of the same
     shape, its bound and phase 1's ptxas line; in-batch
     CE forward (B10, 3xTF32 on the tensor cores: also within 1e-5 of max
     |lse| of a logsumexp over f64 scores, beside the plain version's
     error, and bit-equal on repeat; its device time beside the library
     call's, its 3xTF32 bound and the f32 FMA one, phase 1's ptxas line),
     and the CE backward that writes dU and dI in one pass over
     the score tiles, bit-equal on repeat) are held against their plain
     versions on the step's own tensors and timed.  Then 3
     warm-up and 20 timed steps through make_train_step; launch
     counters are zeroed around the timed steps and must show one launch
     per step of each training kernel (and of the backward's reduce), the
     residual forward's and the backward's on the tensor cores, and none
     of the forward-only encoder kernel.  Three more steps run under
     torch.profiler, for the device time per kernel and the device's busy
     share;
  4c. the recompute encoder backward (B7, on the tensor cores) on phase
     4's encoder tensors, held as B6 is in phase 4 (against its plain
     version, the backward with f64 sums and the FMA kernel on the same
     inputs, bit-equal on repeat; its f32 instance within 1e-4 of scale of
     plain), against the FMA kernel directly and against B6 on B5's
     residuals, both within 3e-2 of scale; its device time beside the FMA
     kernel's, three B14 launches', its bound and phase 1's ptxas line.
     Then the step with B1 and B7 in place of B5 and B6 (_RESIDUAL_BWD
     False): one launch of each a step, B7 on the tensor cores, timed
     beside the B5/B6 step in the order B6, B7, B7, B6, and three steps of
     it under torch.profiler, their device-busy ms a step beside the B5/B6
     step's.  Last, train_loss and its gradients at B=256 on the card
     against a CPU copy of the model;
  4b. train, variable-length histories: the flagship config on
     make_synthetic_data with variable_history (lengths in [1, 32], id 0
     past them).  The stack's backward (B9, on the tensor cores) is held
     and timed as B6 in phase 4 on the step's own tensors, its dx exactly 0
     past each length, and B8 timed there as in phase 2b;
     3 warm-up and 20 timed steps launch B8 and B9 (on the tensor cores) and
     the CE kernels once each and none of the fixed-length encoder kernels; three steps under torch.profiler; grads
     against a CPU copy at B=256;
  5. large tables: scripts/bench_tables.py's configuration (the flagship
     with 2^22-row user and item tables, stored 128-lane packed).  The row
     scatter-add (B18) is held against its plain version at the lookups of
     the legs below and on a stream where id 0 holds about half the ids
     (exactly, on rows of small integers), and timed against F.embedding's
     gradient at 2^16-2^22 rows; the in-place row write (B19) exactly at
     the lazy step's write-backs on its own ids (one launch a table for the
     table and its two moments, and the six one-array launches), timed
     with and without the host's dispatch.  From one seed, the
     first lazy step is held against the first dense step on every
     parameter and table moment.  Three legs, each 2 or 3 warm-up and 10
     timed steps plus three under the profiler: train-4M-packed (dense
     Adam, B18 three times a step through the packed lookups),
     train-4M-lazy (lazy_table_adam: B19 twice a step, no B18 on a table) and
     train-1M-plain (2^20-row plain tables, B18 three times a step inside
     the scatter window); in every training leg of a config that debiases
     by position (phases 4-9) B18 also takes the position table's gradient,
     once a step (POS_B18).  Each leg then runs one step twice from one
     state, through the kernels and on the plain route, and the tables and
     moments must agree.  Last, train_loss and its grads at 2^18 packed
     rows and B=256 on the card against a CPU copy;
  6. the per-layer attention tier (HistoryEncoderConfig fused_kernel=True,
     fused_encoder=False: each attention layer in one kernel, B13 forward,
     B14 backward).  6a: B13 and B14 against their plain versions on layer
     0's tensors of the serving batch (with and without lengths) and of
     the training batch, bf16 and f32, B13 and B14 (bf16: their
     tensor-core kernels) twice (bit-equal), each timed beside its plain
     version, its bound and F.multi_head_attention_forward (B14: that
     call's autograd backward).  The tensor-core kernels sum in f32 in
     their own order, so B13's bf16 y is held as B14's dx is, and against
     the layer (and its backward) with f64 sums they may have at most 1.5
     times the plain version's values beyond one bf16 step (B14's weight
     grads: 1.5 times its RMS error, or 1e-6 of scale); the FMA kernels,
     called through their launchers on the same bf16 inputs, are held as
     before (B13 within one step of the plain version) and timed beside
     them, B14's with its device time, reduce apart, and phase 1's ptxas
     line for its tensor-core instance.
     6b: phase 3's configuration and
     seed on this tier through from_params / warmup / query, ten batches
     with full histories (serve-1M-exact-layer) and ten with lengths
     uniform in [1, 32] (-varlen), launch counts as in phase 3 with three
     B13 a batch, all on the tensor cores, and no B1 or B8, indices and
     user embeddings checked as
     there.  6c: phase 4's configuration on this tier, 3 warm-up and 20
     timed steps on the fixed batch (train-65k-layer) and on
     make_synthetic_data's variable-length histories (-varlen): three B13
     and three B14 (all on the tensor cores) and three reduces a step, the
     CE kernels once, none of B1 and B5-B9; three steps under the profiler
     (the step's device-busy ms beside ms/step and host ms) and
     train_loss's grads at B=256 against a CPU copy for each; the step
     beside phase 4's.
  7. the blockwise attention tier (HistoryEncoderConfig blockwise_kernel=True,
     fused_encoder=False: each layer's attention through B15, and B16 and B17
     for the gradient, between plain projections).  7a: B15's two kernels
     (the tensor cores' attn_fwd_tc_kernel, twice: bit-equal, and the FMA
     kernel, each forced) against their plain version on layer 0's folded q,
     k, v of the serving batch (with and without lengths) and of the
     training batch, the tensor cores also at 30 sigma (1e-3 / 1e-4), B16
     and B17 there on both their kernels (the tensor cores'
     attn_bwd_tc_kernel and the FMA kernels, each forced, twice: bit-equal),
     and a long-history leg at N=4, H=4096 with and without lengths, whose
     forward and backward through blockwise_self_attention must launch
     B15, B16 and B17 on the tensor cores (the routes' kernels there; counts
     zeroed around it) and keep its peak memory under a quarter of the
     plain dense autograd's; B15's kernels timed at the five shapes beside
     its plain version, its bounds (bytes, f32 FMA, 3xTF32) and
     F.scaled_dot_product_attention, B16's and B17's kernels at the
     training batch and the long history beside their plain version,
     bounds and that call's autograd backward.
     7b: phase 3's configuration and seed on this tier, ten batches with full
     histories (serve-1M-exact-blockwise) and ten with lengths (-varlen):
     three B15 a batch (on the route's kernel: the FMA kernel at H = 32),
     none of B1, B8 or B13, indices and user embeddings checked as in
     phase 3.  7c: phase 4's configuration on this tier, 3
     warm-up and 20 timed steps on the fixed batch (train-65k-blockwise) and
     on make_synthetic_data's variable-length histories (-varlen): three
     each of B15, B16 and B17 a step, the CE kernels once, none of B1, B5-B9,
     B13 or B14; a trace and card-vs-CPU grads each; the legs beside phases 4
     and 6.  7d: train-4k-blockwise, 7c's configuration with histories of
     4096 items at B=256 (N=1024 heads: dense attention's probabilities
     would take 64 GiB a layer): on layer 0 of its fixed batch B16 and B17
     on both kernels against the plain backward of the first four leading
     indices, and timed with their bounds; 2 warm-up and 5 timed steps,
     three each of B15, B16 and B17 a step on the tensor cores, the CE
     kernels once, none of B1, B5-B9, B13 or B14; a trace, and the grads
     against a CPU copy at B=2;
  8. fused Adam (TrainConfig fused_adam=True) on phase 5's train-4M-packed:
     B20 against its plain version on the state's leaves of 2^16 elements or
     more (the two packed tables), bit for bit over three steps, timed beside
     torch.optim.Adam(fused=True); one step through B20 against one through
     Adam from one state (tables and moments within 1e-6 of their scale);
     the leg train-4M-packed-fusedadam (2 warm-up and 10 timed steps, one B20
     launch a step per such leaf, a trace) beside train-4M-packed.
  9. the training loop (training.loop.train) at the flagship's width
     (phase 4's model with debias_aux_weight 1/4096) on make_synthetic_data
     of 2^21 samples, 65,536 users and 65,536 items, B=4096, lr 1e-3, a
     step log every 64 steps and an eval every 512, all with the default
     algorithms: the position table's gradient sums in a fixed order (B18),
     where F.embedding's backward differs from call to call in its last
     bits (both counted here).  9a: two epochs (1,024 steps) with a
     checkpoint directory: one launch a step of each training kernel (B5,
     B6 and its reduce, B10, B11 + B12 and its reduce, B18 for the position
     table) and, each eval, one
     B1, one B2, two B3 (radix), one B4 and its inversion; the losses
     finite and epoch 1's below epoch 0's; recall@100 beside random and
     within 2/1024 of a CPU copy of the final params; no host sync added by
     the loop between the gates at steps 64 and 128 against the bare
     step's own (CUDA's sync debug mode); the loop's ms/step over epoch 1's
     steady steps beside 2 x 128 bare make_train_step steps with each kind
     of algorithms; the eval's refresh and recall timed; a checkpoint's
     bytes, the blocking and total ms of an async and a sync save, the
     restore's ms, and 9a's saved state restored bit for bit.  9c: a fresh
     two-epoch run, preempted at the first step log at or past step 600
     (with a torch.profiler trace of steps 3-7 that must hold
     encoder_tc_kernel and ce_fwd_tc_kernel), then the identical call
     finishes the schedule: its final params bit-equal to 9a's.  9b: 9a's
     call with three epochs restores step 1,024, runs only epoch 2 and
     gives the loop's ms/step as a user runs it.  9e: the JAX package's
     round-5 quality anchor at these widths (BASELINE.md:199-209: no
     debiasing, lr 3e-3, 8 steps a dispatch) for 8 epochs: one launch a
     step of each training kernel through the [K, B] path, the loss
     falling, recall@100 at least 10x random.  9d: the trainer CLI (python
     -m two_tower_models_tpu_torch.training.loop, the
     two_tower_with_user_history_encoder preset, 640 samples, 2 epochs)
     twice as a subprocess on one checkpoint directory: epoch and recall
     lines, and the second run restores.
  10. mixed negatives and the logQ correction at scripts/exp_mns_scale.py's
     width (the two_tower_with_user_history_encoder preset: 65,536-row
     tables, D = 64, H = 32, 3 layers of 4 heads, bf16, fused loss; 2^21
     samples of 65,536 users and items with Zipf(1.0) engagement; B = 4096,
     lr 1e-3, grad_clip_norm 1.0), arms mns+logq (64 mixed negatives, the
     oracle catalog_logq), stream+mns+logq (the streaming estimator, decay
     0.999) and plain.  10a: B10 and B11 + B12 on one real step's augmented
     operands ([u, 1] [4096, 65] and [pool, -logq] [4160, 65], no
     diagonal) against their plain versions at phase 4's tolerances,
     bit-equal on repeat, B10 against f64 sums; device times beside the
     (4096, 4096, 64) instance in the same call, the bounds, and the
     library calls (torch.logsumexp of U I^T, and autograd's backward of
     it).  10b: the mns+logq step, 3 warm-up and 20 timed steps, beside
     the plain arm's in the same call (order mns, plain, plain, mns):
     ms/step, device-busy ms (a trace), one launch a step of B5, B6 and its
     reduce, B10, B11 + B12 and its reduce and none of the other kernels,
     0 host syncs a step, and train_loss with every grad leaf within 1e-2
     of scale of a CPU copy at B = 256 on the card's own draw (the two
     leaves that are zero in exact arithmetic held to 0: the card at most
     1.5 times the CPU's distance from it); the lazy
     path (lazy_table_adam, no clip) for 2 + 5 steps with the same launch
     and sync gates (its 2^16-row tables are plain: written back by an
     indexed copy, no B19), its first step against the dense step's from
     one state and one draw.  10c: stream+mns+logq, 20
     steps on 20 batches: the estimator equal to a CPU recompute from the
     batches' item ids (1e-6 relative), 0 host syncs.  10d:
     stream+mns+logq through training.loop.train (8 steps a dispatch), two
     epochs with a checkpoint each epoch, then the epoch-1 checkpoint
     resumed: params, moments, rng and logq_state bit-equal to the
     uninterrupted run's, with the default algorithms, and the data each
     run makes, made twice, bit-equal; the loop's
     examples/s beside 10b's bare step.  10e: mns+logq and plain, 8 epochs
     each from seed 42: recall@100 over 16,384 held-out engaged examples,
     head (id < 0.2 C) and tail, the corrected arm at least 0.25 and 5x the
     plain arm's, beside the JAX package's 0.453 and 0.0195
     (BASELINE.md:624, a TPU v5e run).
  11. the rest of the model zoo at scripts/bench_presets.py:39-70's width
     (65,536-row tables, D = 64, IU = II = 16, T = 3, H = 32 on the
     whole-encoder kernel, bf16, fused loss, B = 4096, lr 1e-3;
     LightRankerConfig()'s NI = 50, NU = 4; KD's labels [labels, 0.5 labels]).
     11a: two_tower_plus_light_ranker, two_tower_plus_light_ranker_kd and
     two_tower_with_main_ranker_reward, 3 warm-up and 20 timed steps each:
     ms/step, device-busy ms (a trace) and peak memory beside phase 4's
     flagship in the same call; one launch a step of B5, B6 and its reduce
     and B18, and of B10, B11 + B12 and its reduce except on the reward
     model (its loss takes the precomputed [B, B] scores), none of any
     other kernel; 0 host syncs; finite metrics under the new names; and
     train_loss with every grad leaf within 1e-2 of scale of a CPU copy at
     B = 256 (the reward model's two item-tower biases at their own scale).
     11b: one step of the KD preset and one of the reward model with 64
     mixed negatives and the oracle logQ (phase 10's settings): the CE
     kernels at (4096, 4160, 65) on the first, none on the second (the
     scores route of _extended_ce); grads against the CPU copy as in 11a.
     11c: the light ranker's RetrievalEngine from 11a's trained model over a
     2^20-item catalog, B = 1024, num_items = 10 (validate() needs NI >=
     num_items, so not bench_serving.py's 100), ten batches: ms/batch
     beside phase 3's; a batch launches B1 once, B2, two B3 and B4 (k =
     50); indices as sets equal to a CPU copy's on the card's user and
     ranker embeddings, 128 rows a batch, on every row whose 10th and 11th
     rerank values and 50th and 51st MIPS scores differ by more than 1e-5 of
     its scale (the rows excluded counted). 11d: the trainer CLI (--preset
     two_tower_plus_light_ranker_kd at phase 9's widths on 2^19 samples, cut
     from 2^21) for one epoch with a checkpoint, then for two on that
     checkpoint: its final state bit-equal to two epochs in this process;
     and each models/zoo.py builder's init, train_forward and forward.
  12. approximate and int8 MIPS at scripts/bench_serving.py's width (phase
     3's model, catalog and batches, rebuilt from --seed; Debias.BOTH, bf16,
     B = 1024, k = 100, mips_recall_target 0.95).  12a: the bin-max scan
     (N1) on phase 3's user embeddings over the 2^20 x 64 corpus, f32 rows
     and the int8 rows of quantize_corpus at M = 2048 (k = 100) and 8192
     (the rescore pool of 400), and the corpus's bf16 copy at M = 2048: the
     routed kernel (the tensor cores) and the FMA kernel forced, each with
     values within 1e-5 of each query's scale of the plain version's, rows
     equal on every (query, bin) whose best two scores differ by more (the
     pairs left out counted); both routes and every row kind bit for bit on
     an integer grid with phase 2's +-inf and NaN rows (for int8, those
     rows' scales) at valid_count C and C - 3000; each instance's device
     time on both kernels in one call, its bounds (2xTF32 or 3xTF32 at
     TF32_FLOPS, and the f32 FMA bound), plain version and library call
     (matmul + amax over the bins), beside B2's device time in this call
     and phase 1's ptxas lines.  12b:
     scripts/bench_serving.py's four legs (exact, approx_mips, approx_int8,
     approx_int8_rescore), each a RetrievalEngine over the one corpus,
     warmed up, then ten batches: ms/batch and QPS; recall@100 against the
     exact leg (gates: 0.95 for approx_mips and approx_int8_rescore, 0.90 for
     approx_int8); a batch launches B1 once and, on the approximate legs, N1
     once (on the tensor cores) and B3 once and nothing else (no B2, no B4);
     each leg's ms/batch (mean, and the median beside it, which one slow
     batch does not move) beside the exact leg's; peak memory over the
     batches under 1 GiB above what was allocated before them (no [B, C]
     scores); indices as sets equal to a CPU copy's on 128 rows a batch,
     fed the card's user embeddings, except rows whose k-th and (k+1)-th
     bin values (and, rescored, pool scores) lie within 1e-5 of scale,
     counted.  12c: scripts/bench_mips.py's width (1,000,000 x 64 bf16,
     B = 1024, k = 100): mips_topk_exact_tilemax, mips_topk_segmented (64
     and 256 segments) and chunked_mips_topk (131072) index-equal to
     mips_topk_exact, and mips_topk_approx at 0.95 with recall >= 0.95
     against it (N1 on the bf16 rows as they are, no widened copy: one
     tensor-core launch, its peak memory recorded), each timed.
  13. raw-key ingest and reference-checkpoint interop at serve-1M-exact's
     and the flagship's widths (the port's training.ingest, native and
     interop; no new kernel).  13a: the host hasher's C++ path is built
     (its library under the port's _build/) and agrees slot for slot with
     the numpy fallback on 4,096 of the 2^20 catalog's string keys
     ("sku-0000000"...) and on 131,072 uint64 keys from --seed (0 and
     2^64 - 1 among them); host ms of the C++ path, strings and uint64
     apart, for one serving batch's keys (1,024 users, 1,024 x 32 history
     keys), one flagship batch's (4,096 + 4,096 + 4,096 x 32) and the
     catalog, the hash call alone beside its marshalling, and the host
     CPU's model.  13b: serve-1M-raw and serve-1M-raw-u64: phase 3's model
     (serve_cfg) over a corpus built from the 2^20 string item keys through
     hash_item_keys (collisions kept), warmed up, then ten batches of
     RetrievalEngine.query_raw on string keys, or on uint64 keys: each
     batch's indices bit-equal to query on training.ingest's slots of the
     same keys; a batch launches B1 and the exact MIPS route and nothing
     else; the hasher called only on its C++ path (two calls a batch);
     on 128 rows a batch, a CPU copy hashing with the numpy fallback gives
     the same slots, user embeddings within 3e-2, and, fed the card's
     embeddings, the same index sets (serve_leg's rule); ms/batch of
     query_raw by the host clock with a synchronize beside query's on the
     same slots and the hash's host ms.  13c: train-65k-raw: the flagship
     (flagship_cfg(TRAIN_ROWS), B = 4096) on batches ingested one a step
     from a string event log made from --seed, 5 warm-up and 20 timed
     steps: finite metrics, phase 4's launches a step, the hasher on its
     C++ path only, ms/step with the ingest inline beside the ingest's host
     ms a batch and the bare step's ms/step on the last batch, and
     train_loss with every grad leaf within 1e-2 of scale of a CPU copy at
     B = 256.  13d: reference state_dicts for serve_cfg and for
     two_tower_plus_light_ranker_kd at phase 11's width, made in torch on
     the CPU from --seed, imported onto the card and exported back bit for
     bit on every key (KD's aux columns the card's fresh init); one serving
     batch through the imported serve model against a CPU copy on 128 rows
     (13b's rule).  13e: examples/raw_key_ingest_torch.py as a subprocess
     on the card: exit 0 and its consistency line.
  14. sharded serving (A13a: parallel/, sharded_mips_topk and
     RetrievalEngine(mesh=...)), one process a card over NCCL, at
     serve-1M-exact's width (serve_cfg), model, catalog and batches drawn
     on the host from --seed so every rank holds the same.  14a, in this
     process: a world of one on card 0, mesh (1, 1): from_params(mesh=...)
     bit-equal (indices, and the scores of the towers + sharded_mips_topk)
     to the single-device engine over the same rows on ten batches, with
     phase 3's launches a batch; ms/batch beside the single-device query.
     With four cards, four spawned ranks (the kernels built once, here,
     before they start; a rank that fails fails the run, and the others
     are stopped): 14b exact on meshes (1, 4) and (2, 2) and, on (1, 4), a
     catalog of 2^20 - 3 items (the last shard padded, B2 on a cut valid
     count): each rank holds 2^18 corpus rows and V / n_model table rows,
     its refresh within one bf16 step of the single-device refresh, ten
     batches bit-equal (indices and scores) to a single-device engine on
     card 0 over the gathered rows, phase 3's launches a batch on every
     rank; 14c approx_mips at 0.95, int8 and int8_rescore (under
     approx_mips) on (1, 4): recall@100 against 14b's answers >= 0.95,
     0.90, 0.95 (phase 12b's gates), N1 on the tensor cores once a batch
     on every rank; 14d tower_tp on (1, 4) and (2, 2), the all_to_all
     lookup on (1, 4), history_len in [1, 32] on (2, 2) (B8) and
     serve-1M-exact-lightranker's model on (2, 2): indices equal to the
     single-device engine's wherever the 100th and 101st scores (the light
     ranker: its 10th and 11th rerank values and 50th and 51st MIPS
     scores) differ by more than 1e-5, recall >= 0.999, and the two lookup
     strategies' user embeddings bit-equal; 14e make_sharded_recall_fn on
     (2, 2) equal to make_eval_recall_fn on the same examples.  Every
     leg's answers equal on all ranks.  Times (CUDA events, the maximum
     over ranks of the mean of ten batches) beside the single-device query
     on card 0, split into the user tower, the local scan, the all-gather
     and the merge, with the bytes a rank all-gathers a batch and the
     sharded refresh's ms.  With fewer cards it says so on a line of its
     own and goes on.
  15. the explicit sharded training step (A13b:
     parallel/train_step.make_sharded_train_step over parallel/sharding's
     shard_state, the lookups' backward, parallel/collectives and
     parallel/sparse_grads), in the same process and ranks as phase 14.
     15a, in this process: a world of one on card 0, the flagship
     (flagship_cfg(TRAIN_ROWS), B = 4096): SHARD_STEPS steps bit-equal to
     make_train_step (every metric each step, parameters and moments
     after), phase 4's launches a step, no host sync, both ms/step.  With
     four cards, after 14e, in the four ranks (a card's batch SHARD_TRAIN_B,
     scripts/scaling_prediction.py's weak scaling; batches and the
     initial state drawn from --seed, rank 0's parameters broadcast): 15b
     the flagship on meshes (4, 1), (2, 2) and (1, 4): every gradient leaf
     (sharded_grads, assembled over model) within 1e-2 of its scale of one
     card's train_loss gradients on the same global batch (the zero-
     gradient leaves against 1e-2 of the top), the metrics within 1e-4
     relative, grad_norm within 1e-3; the parameters after three steps
     within 1e-2 of scale of three single-card steps (the elements of
     near-zero first-step gradient left out: kept_params_close); then 3
     warm-up and SHARD_STEPS timed steps (ms/step and the host's issue
     ms, the maximum over ranks; the launches a step: phase 4's and one
     B18 a sparse table; no host sync in a step), every replicated leaf
     and table replica bit-equal on every rank, the step's collectives
     each timed alone with the bytes a rank hands them, beside one card's
     ms/step at B = SHARD_TRAIN_B (the weak-scaling efficiency), and B10
     and B11 + B12 at (4096, 16384, 64) and (4096, 8192, 64) against plain
     and timed beside the library calls; 15c on (2, 2): sparse_table_grads
     on and off, the all_to_all lookup and tower_tp (gradients as 15b's),
     SHARD_K steps a dispatch (bit-equal to SHARD_K single steps, the mean
     metrics within 1e-2 of one card's K steps), and
     scripts/exp_mns_scale.py's mns+logq model on a batch extended once by
     extend_batch_for_idx (B10-B12 at D = 65; both CE kernels at (4096,
     8256, 65) timed); 15d the light ranker, KD and the reward model
     (scripts/bench_presets.py's width) on (2, 2), gradients as 15b's;
     15e scripts/bench_tables.py's 2^22-row tables packed [2^21, 128] on
     (2, 2): both tables through the sparse exchange, gradients as 15b's,
     ms/step, the launches a step (B18 for each lookup's backward on the
     packed shards, each exchange and the position table) and the peak
     memory a rank.

Phase 2 also holds B2 and the exact pipeline on an integer-grid corpus whose
scores hold +-inf and NaN of both signs (nonfinite_check).

Prints one JSON line of per-kernel numbers, then, last, the ok line.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import platform
import statistics
import subprocess
import sys
import time

# H100 SXM data sheet (dense): HBM bytes/s, f32 CUDA-core and bf16 and
# TF32 tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12

CORPUS = 1 << 20
BATCH = 1024
HIST = 32
TOPK = 100
DEVICE = "cuda"
TRAIN_ROWS = 65536
TRAIN_BATCH = 4096
TRAIN_STEPS = 20  # timed training steps
CHECK_BATCH = 256  # card-against-CPU gradient check
TABLE_ROWS = 1 << 22  # scripts/bench_tables.py --rows 4194304: packed tables
TABLE_ROWS_1M = 1 << 20  # scripts/bench_checkpoint.py's tables: plain, in the scatter window
PACK_MIN_ROWS = 1 << 22  # TrainConfig's default pack_tables_min_rows
TABLE_STEPS = 10  # timed steps of each large-table leg
CHECK_ROWS = 1 << 18  # large-table card-against-CPU check: the scatter window's lower edge
WINDOW_ROWS = (1 << 16, 1 << 18, 1 << 20, 1 << 22)  # B18 against F.embedding's gradient
BF16_TOL = 1e-2  # tests/test_torch_train_step.py's bf16 tolerance
LONG_N, LONG_H = 4, 4096  # scripts/tpu_kernel_parity.py:275-293's long history (Dh 16)
LONG_TRAIN_B = 256  # train-4k-blockwise: B = 256 at H = LONG_H (N = 1024 at 4 heads)
LONG_TRAIN_STEPS = 5  # its timed steps
LONG_CHECK_N = 4  # its layer 0's leading indices held against the plain backward
LONG_CHECK_ROWS = 2  # its card-against-CPU rows: the CPU's dense [8, H, H] takes 512 MiB
# phase 9, the loop: BASELINE.md's round-5 loop run (2.1M samples an epoch, 65,536 users)
LOOP_SAMPLES = 1 << 21
LOOP_USERS = LOOP_ITEMS = 65536
LOOP_LOG_EVERY, LOOP_EVAL_EVERY = 64, 512
LOOP_PREEMPT_AT = 600  # 9c: the preempt flag is set at the first step log at or past it
LOOP_BARE_STEPS = 128  # the bare make_train_step's timed steps
LOOP_CLI_SAMPLES = 640  # 9d: the CLI's --num_samples
LOOP_ANCHOR_EPOCHS = 8  # 9e: BASELINE.md:199-209's quality anchor ran 8 epochs
# phase 10, mixed negatives and logQ: scripts/exp_mns_scale.py:73-121 at its full scale
MNS_SAMPLES = 1 << 21
MNS_ROWS = 65536  # users, items, and the rows of both id tables
MNS_NEGATIVES = 64
MNS_STEPS = 20  # 10b's timed steps a run, 10c's steps
MNS_LAZY_STEPS = 5  # 10b's timed lazy steps
MNS_EPOCHS = 8  # 10e: exp_mns_scale.py's --epochs
MNS_EVAL = 16384  # 10e: exp_mns_scale.py's --eval_size
# 10e's yardstick: the JAX package's recall@100 at lr 1e-3, seed 42 (BASELINE.md:624, TPU v5e)
MNS_JAX_RECALL = {"mns+logq": 0.453, "plain": 0.0195}
# phase 11, the rest of the zoo: scripts/bench_presets.py:39-70's width
ZOO_PRESETS = ("two_tower_plus_light_ranker", "two_tower_plus_light_ranker_kd",
               "two_tower_with_main_ranker_reward")
ZOO_SHORT = {"two_tower_plus_light_ranker": "lightranker",
             "two_tower_plus_light_ranker_kd": "kd",
             "two_tower_with_main_ranker_reward": "reward"}
ZOO_MNS_SAMPLES = 2 * TRAIN_BATCH  # 11b: make_synthetic_data's rows, for one step and its check
ZOO_CLI_SAMPLES = 1 << 19  # 11d: phase 9's 2^21 samples cut to 128 steps an epoch
ZOO_CHECK_ROWS = 128  # 11c and 12b: the rows of each batch held against the CPU copy
MIPS_C = 1_000_000  # 12c: scripts/bench_mips.py's --corpus
# phase 13, raw-key ingest: examples/raw_key_ingest.py's key formats at the cells' widths
RAW_USERS = 65536  # the user keys' population: serve_cfg's and the flagship's user table
RAW_CHECK_KEYS = 4096  # 13a: string keys held C++ against the fallback (a Python loop)
RAW_U64_KEYS = 131072  # 13a: uint64 keys held C++ against the fallback
RAW_WARMUP, RAW_STEPS = 5, 20  # 13c: warm-up and timed steps
# phase 14, sharded serving: four ranks, one a card, over NCCL, on a host with four cards
SHARD_CARDS = 4
SHARD_PAD = 3  # 14b: a catalog of CORPUS - 3 items, so the last shard is padded
SHARD_GATES = {"approx_mips": 0.95, "int8": 0.90, "int8_rescore": 0.95}  # phase 12b's recall gates
SHARD_TIMEOUT = 600  # s the parent waits for the four ranks (14b-14e, then 15b-15e)
SHARD_TRAIN_B = 4096  # 15b-15e: rows a card a step (scripts/scaling_prediction.py:8-13: weak scaling)
SHARD_TABLE_ROWS = TABLE_ROWS  # 15e: scripts/bench_tables.py's 2^22-row tables, packed
SHARD_STEPS = 20  # timed steps of 15a and 15b (half of them in 15e)
SHARD_PARAM_STEPS = 3  # 15b: the parameters after three steps against one card's
SHARD_K = 4  # 15c: steps a dispatch
# B18 launches a training step of a config that debiases by position: the
# position-bias table's gradient, summed in a fixed order (nn.layers
# embedding_lookup's fixed_order), where F.embedding's differs call to call
POS_B18 = 1
# a serving batch's selects (k = 100): both on the radix route, none on the tournament
SELECT_ROUTE = {"select_topk_radix": 2, "select_topk": 0}
# a serving batch's exact MIPS: B2, both selects, B4's inversion and its scoring
MIPS_ROUTE = {"tile_max_scores": 1, **SELECT_ROUTE, "gather_rescore_invert": 1,
              "gather_rescore": 1}
# an approximate serving batch's N1: one launch, on the tensor cores
N1_TC = {"approx_scan": 1, "approx_scan_tc": 1}
# the whole-encoder forward's launches on the tensor cores (B1, B5, B8; the
# route of the cells' bf16 encoder): none unless a leg says otherwise
ENC_TC = {"fused_history_encoder_tc": 0, "fused_history_encoder_res_tc": 0,
          "fused_attn_stack_tc": 0, "fused_history_encoder_bwd_tc": 0,
          "fused_history_encoder_bwd_recompute_tc": 0, "fused_attn_stack_bwd_tc": 0}


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def ptxas_report(log: str, kernels, smem: dict) -> tuple[list, dict]:
    """Print each kernel's registers, stack and spills from nvcc -Xptxas -v
    output, a template instance as ``name<n, ...>`` (its int arguments),
    beside the dynamic shared memory ``smem`` gives by that printed name;
    returns (the kernels that spill or gave no report, the report lines by
    printed name)."""
    import re

    lines, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in kernels if k in line), None)
            args = re.findall(r"L[ib](\d+)E", line)
            if cur:
                cur += f"<{', '.join(args)}>" if args else ""
                lines.setdefault(cur, [])
        elif cur and ("Used" in line or "spill" in line):
            lines[cur].append(line.replace("ptxas info    :", "").strip())
    spills = [k for k in kernels if not any(n.split("<")[0] == k for n in lines)]
    for name, got in sorted(lines.items()):
        print(f"ptxas {name}: {'; '.join(got) or 'no report'}; dynamic shared memory "
              + (f"{smem[name]} bytes a block" if name in smem else "set by the launch plan"),
              flush=True)
        if not got or any(" 0 bytes spill stores" not in ln for ln in got if "spill" in ln):
            spills.append(name)
    return spills, lines


def time_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of one call, CUDA events over ``iters`` calls."""
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


def device_ms(torch, fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernel whose name holds
    ``kernel``, from torch.profiler over ``iters`` calls of ``fn``: the
    kernel alone, where time_ms also counts the host's dispatch, which at
    a small batch takes longer than the kernel."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window in which the profiler recorded no launch is taken again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if kernel in e.name]
        if ev:
            break
    return sum(e.device_time for e in ev) / max(len(ev), 1) / 1e3


def call_device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn``: every kernel and copy it
    launches, from torch.profiler over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3


def bound(bytes_: float, flops: float, flops_rate: float):
    t_bytes, t_ops = bytes_ / HBM_BPS * 1e3, flops / flops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(a, b, rtol: float, atol: float) -> tuple[bool, float]:
    """|a - b| <= atol + rtol*|b| where both are finite, and equal where
    either is not; returns (ok, max abs difference over finite entries)."""
    a, b = a.float(), b.float()
    fin = a.isfinite() & b.isfinite()
    err = (a[fin] - b[fin]).abs()
    ok = bool((a[~fin] == b[~fin]).all()) and bool((err <= atol + rtol * b[fin].abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def bf16_steps(torch, a, b):
    """Distance between two bf16 tensors value by value, in steps of the
    bf16 number line (0 = bit-equal up to the sign of zero)."""
    keys = [torch.where(v < 0, -(v & 0x7FFF), v)
            for v in (t.contiguous().view(torch.int16).int() for t in (a, b))]
    return (keys[0] - keys[1]).abs()


def bf16_ulps(torch, a, b) -> int:
    """Largest distance between two bf16 tensors in steps of the bf16
    number line; -1 if their NaNs are not in the same places."""
    if not torch.equal(a.isnan(), b.isnan()):
        return -1
    steps = bf16_steps(torch, a, b)[~a.isnan()]
    return int(steps.max()) if steps.numel() else 0


def bf16_far(torch, a, b) -> int:
    """Values of two bf16 tensors more than one bf16 step apart."""
    return int((bf16_steps(torch, a, b) > 1).sum())


def enc_flops(n: int, d: int, nl: int) -> int:
    """Operations of the encoder's layers on one example of n valid rows:
    nl - 1 full layers and the thin last one (query row 0)."""
    return (nl - 1) * (2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d) \
        + (2 * n * d * 2 * d + 2 * d * d + 4 * n * d + 2 * d * d)


def bwd_flops(n: int, d: int, nl: int) -> int:
    """Operations of the encoder's backward proper on one example of n valid
    rows.  A full layer: dW_out and do (2nd^2 each), dp, dv, dq and dk (2n^2d
    each), dW_in and dx (6nd^2 each).  The thin last layer, whose output and
    dq are row 0 only: dW_out and do (2d^2 each), dp, dv, dq0 and dk (2nd
    each), dW_in and dx (4nd^2 for k, v and 2d^2 for q, each)."""
    return (nl - 1) * (16 * n * d * d + 8 * n * n * d) \
        + (4 * d * d + 8 * n * d + 8 * n * d * d + 4 * d * d)


def vjp_flops(n: int, d: int, nl: int) -> int:
    """What a backward that recomputes the forward must do on one example of
    n valid rows: the forward but the thin layer's output projection, whose
    result the backward does not need, then the backward."""
    return enc_flops(n, d, nl) - 2 * d * d + bwd_flops(n, d, nl)


def resid_bwd_flops(n: int, d: int, nl: int) -> int:
    """What a backward from stored layer inputs and probabilities must do on
    one example of n valid rows: vjp_flops less the scores and the full
    layers' output projections, which the stored residuals stand for."""
    return vjp_flops(n, d, nl) - (nl - 1) * (2 * n * n * d + 2 * n * d * d) - 2 * n * d


def scaled_close(got, want, tol: float) -> tuple[bool, float]:
    """Each output within ``tol`` of its largest magnitude."""
    return close(got, want, 0.0, tol * float(want.float().abs().max()))


def enc_checks(torch, label, got, again, plain, ref, fma, names):
    """The whole-encoder tensor-core kernel's bf16 outputs ``got`` (y, or y,
    xs, ps, p0; None where the function has none) against the plain
    versions' ``plain``, as B13's y: at most 0.5% of values beyond one bf16
    step, all within 1e-2 of scale; against the same function with f64
    sums ``ref``, at most 1.5 times the plain version's count of values
    beyond one step (or 1e-6 of the values, where both are that rare: ps
    and p0); bit-equal to ``again``, a second run; and the FMA kernel's
    outputs ``fma`` within one step of the plain version's (the same sum
    order).  Returns (ok, max_abs_err)."""
    ok, err, parts = True, 0.0, []
    for name, a, a2, pl, r, f in zip(names, got, again, plain, ref, fma):
        if pl is None:
            continue
        far, n = bf16_far(torch, a, pl), a.numel()
        ok_s, e = scaled_close(a, pl, 1e-2)
        far64 = [bf16_far(torch, t, r) for t in (a, pl)]
        rep = torch.equal(a, a2)
        fma_steps = bf16_ulps(torch, f, pl)
        ok = ok and ok_s and far <= 5e-3 * n and far64[0] <= max(1.5 * far64[1], 1e-6 * n) \
            and rep and 0 <= fma_steps <= 1
        err = max(err, e)
        parts.append(f"{name}: {far} of {n} values beyond one bf16 step (tol 0.5%), max_abs_err "
                     f"{e:.3g} (tol 1e-2 of scale); beyond one step from f64 sums: kernel "
                     f"{far64[0]}, plain {far64[1]} (tol 1.5x, or 1e-6 of the values); "
                     f"bit-equal on repeat={rep}; the FMA kernel {fma_steps} steps from plain")
    print(f"{label} on the tensor cores: " + "; ".join(parts), flush=True)
    return ok, err


def b13_layers(x, lens, w, nh):
    """The per-layer tier's kernel (B13) once a layer on x: full layers,
    every row, the whole-encoder kernels' yardstick."""
    from two_tower_models_tpu_torch.ops import fused_mha as fm

    for l in range(w[0].shape[0]):
        x = fm.fused_mha_fwd(x, lens, w[0][l], w[1][l], w[2][l], w[3][l], nh)
    return x


def bwd_checks(torch, label, got, again, plain, ref, fma, names):
    """An encoder backward on the tensor cores, ``got`` (dx bf16, then the
    f32 grads), against the plain version's ``plain``: each output within
    3e-2 of its scale; against the same function with f64 sums ``ref``: dx
    no more values beyond one bf16 step than 1.5 times the plain version's
    (or 1e-6 of the values, where both are that rare), each grad's RMS
    error relative to its scale at most 1.5 times the plain version's, or
    1e-6 where both are near 0; bit-equal to ``again``, a second run; and
    the FMA kernel's outputs ``fma`` within 3e-2 of scale of the plain
    version's.  Prints a line; returns (ok, max_abs_err)."""
    checks = [scaled_close(a, e, 3e-2) for a, e in zip(got, plain)]
    fma_checks = [scaled_close(a, e, 3e-2) for a, e in zip(fma, plain)]
    n = got[0].numel()
    far = bf16_far(torch, got[0], plain[0])
    far64 = [bf16_far(torch, t[0], ref[0]) for t in (got, plain)]
    rms = [[float((a.double() - e).pow(2).mean().sqrt() / e.abs().max().clamp_min(1e-300))
            for a, e in zip(t[1:], ref[1:])] for t in (got, plain)]
    rep = all(torch.equal(a, a2) for a, a2 in zip(got, again))
    ok64 = far64[0] <= max(1.5 * far64[1], 1e-6 * n) and all(
        k <= max(1.5 * p, 1e-6) for k, p in zip(*rms))
    ok = all(k for k, _ in checks + fma_checks) and ok64 and rep
    print(f"{label} on the tensor cores: dx {far} of {n} values beyond one bf16 step from plain; "
          f"max_abs_err ({', '.join(names)}) {[float(f'{e:.3g}') for _, e in checks]} (tol 3e-2 "
          f"of scale); dx beyond one step from f64 sums: kernel {far64[0]}, plain {far64[1]} "
          f"(tol 1.5x, or 1e-6 of the values); grads' RMS error from f64 sums (of scale) kernel "
          f"{[float(f'{v:.3g}') for v in rms[0]]}, plain {[float(f'{v:.3g}') for v in rms[1]]} "
          f"(tol 1.5x, or 1e-6); bit-equal on repeat={rep}; the FMA kernel max_abs_err "
          f"{[float(f'{e:.3g}') for _, e in fma_checks]} (tol 3e-2 of scale)", flush=True)
    return ok, max(e for _, e in checks)


def b14_layers(torch, x, lens, w, nh):
    """The per-layer tier's backward (B14) once a layer at x's shape, with
    a cotangent of that shape: the whole-encoder backward's yardstick."""
    from two_tower_models_tpu_torch.ops import fused_mha as fm

    g = torch.ones_like(x) / x.shape[0]
    for l in range(w[0].shape[0]):
        fm.fused_mha_bwd(g, x, lens, w[0][l], w[1][l], w[2][l], w[3][l], nh)


def bwd_times(torch, e, tc_fn, fma_fn, b14_fn, ptxas: str) -> None:
    """Beside an encoder backward's entry ``e``: the tensor-core kernel's
    device time and its reduce's, the FMA kernel's on the same inputs (with
    the host's dispatch and device), three B14 launches' device time of the
    same shape, and phase 1's ptxas line of the instance."""
    e["device_ms"] = device_ms(torch, tc_fn, "encoder_bwd_tc_kernel")
    e["reduce_device_ms"] = device_ms(torch, tc_fn, "reduce_kernel")
    e["fma_ms"] = time_ms(torch, fma_fn)
    e["fma_device_ms"] = device_ms(torch, fma_fn, "encoder_bwd_kernel")
    e["b14x3_device_ms"] = call_device_ms(torch, b14_fn)
    e["ptxas"] = ptxas
    e["note"] = (
        "ms includes the second launch that sums the per-block weight grads and the host's "
        "dispatch; device_ms is encoder_bwd_tc_kernel's launch alone and reduce_device_ms the "
        "reduce's (torch.profiler); fma_* the FMA kernel (encoder_bwd_kernel) on the same "
        "inputs; b14x3_device_ms three B14 launches (and reduces) of the same shape")


def bwd_line(torch, smi, label, e) -> str:
    return (f"{label} on {torch.cuda.get_device_name(0)} ({smi}): route {e['kernel_route']} "
            f"{e['ms']:.4f} ms (device time {e['device_ms']:.4f}, its reduce "
            f"{e['reduce_device_ms']:.4f}); the FMA kernel {e['fma_ms']:.4f} (device "
            f"{e['fma_device_ms']:.4f}); three B14 launches, device {e['b14x3_device_ms']:.4f}; "
            f"bound {e['bound_ms']:.4f} ({e['bound_by']}); ptxas {e['ptxas']}")


def enc_times(torch, e, tc_fn, fma_fn, b13_fn, key: str = "") -> None:
    """Beside a whole-encoder kernel's entry ``e`` (``key``: a prefix for
    another shape): the tensor-core kernel's device time, the FMA kernel's
    on the same inputs (with the host's dispatch and device), and the
    device time of three B13 launches on the same input (``b13_layers``)."""
    e[f"{key}device_ms"] = device_ms(torch, tc_fn, "encoder_tc_kernel")
    e[f"{key}fma_ms"] = time_ms(torch, fma_fn)
    e[f"{key}fma_device_ms"] = device_ms(torch, fma_fn, "encoder_kernel")
    e[f"{key}b13x3_device_ms"] = call_device_ms(torch, b13_fn)


def enc_line(torch, smi, label, e, key: str = "") -> str:
    return (f"{label} on {torch.cuda.get_device_name(0)} ({smi}): the tensor cores "
            f"{e[f'{key}ms']:.4f} ms (device {e[f'{key}device_ms']:.4f}); the FMA "
            f"kernel {e[f'{key}fma_ms']:.4f} (device {e[f'{key}fma_device_ms']:.4f}); three B13 "
            f"launches, device {e[f'{key}b13x3_device_ms']:.4f}")


def check_launches(counts: dict, expect: dict, n: int, failures: list, label: str) -> None:
    for name, per in expect.items():
        if counts.get(name, 0) != per * n:
            failures.append(f"{label} launches[{name}]={counts.get(name, 0)}")


def run_steps(torch, step, state, data, idx, n: int):
    """n training steps, the launch counts zeroed just before and read just
    after: (state, metrics, device ms/step, host ms/step, counts)."""
    from two_tower_models_tpu_torch.ops import _lib

    metrics = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.enable_grad():
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            state, m = step(state, data, idx)
            metrics.append(m)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
    return state, metrics, start.elapsed_time(end) / n, wall * 1e3 / n, counts


def finite(torch, metrics) -> bool:
    return all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values())


def grads_vs_cpu(torch, model, cfg, data, idx, failures, label: str,
                 rows: int = CHECK_BATCH, sub=None, zero_exact: bool = False) -> None:
    """train_loss and every grad leaf on the card against a CPU copy of the
    model, on the first ``rows`` rows of idx (or on the batch ``sub``, on the
    card, copied to the CPU as it is: an extended batch's drawn negatives
    included), at BF16_TOL of each leaf's scale (the leaves of
    ``zero_grad_leaves(cfg)``, zero in exact arithmetic, against
    ZERO_GRAD_FLOOR of the top; the reward model has none).  With
    ``zero_exact`` those leaves are held to their exact value, 0, instead:
    the card's largest magnitude at most 1.5 times the CPU's, plus the same
    allowance."""
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.training.data import gather_batch

    cpu_model = copy.deepcopy(model).cpu()
    if sub is None:
        sub = gather_batch(data, idx[:rows])
    rows = sub.item_id.shape[0]
    sub_cpu = type(sub)(*(None if t is None else t.cpu() for t in sub))
    results = []
    with torch.enable_grad():
        for mdl, bt in ((model, sub), (cpu_model, sub_cpu)):
            mdl.zero_grad(set_to_none=True)
            loss, m = tt.train_loss(mdl, cfg, bt)
            loss.backward()
            results.append(({k: float(v.detach()) for k, v in m.items()},
                            {n: p.grad.detach().float().cpu() for n, p in mdl.named_parameters()}))
    model.zero_grad(set_to_none=True)
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_leaf, exact = 0.0, "", []
    floor = tt.zero_grad_leaves(cfg)
    for name, want in g_cpu.items():
        scale = tt.ZERO_GRAD_FLOOR * top if name in floor else float(want.abs().max())
        rel = float((g_gpu[name] - want).abs().max()) / max(scale, 1e-30)
        if name in floor and zero_exact:
            card, cpu = float(g_gpu[name].abs().max()), float(want.abs().max())
            exact.append(f"{name} card {card / top:.3g}, CPU {cpu / top:.3g} of the top leaf "
                         f"(apart {rel:.3g} of ZERO_GRAD_FLOOR x top)")
            if not card <= 1.5 * cpu + BF16_TOL * scale:
                failures.append(f"{label} grad {name}: the card's {card / top:.3g} of the top "
                                f"leaf from 0, the CPU's {cpu / top:.3g}")
            continue
        if not (rel <= BF16_TOL):
            failures.append(f"{label} grad {name} card vs CPU: {rel:.3g} of its scale")
        if rel > worst:
            worst, worst_leaf = rel, name
    for k, v in m_cpu.items():
        if not abs(m_gpu[k] - v) <= BF16_TOL * max(abs(v), 1.0):
            failures.append(f"{label} metric {k} card vs CPU: {m_gpu[k]} vs {v}")
    print(f"{label}: train_loss B={rows} card vs CPU: loss {m_gpu['loss']:.6f} vs "
          f"{m_cpu['loss']:.6f}; worst grad leaf {worst_leaf} at {worst:.3g} of its "
          f"scale (tol {BF16_TOL}); leaves on the floor {list(floor)}"
          + (f"; zero in exact arithmetic (the card at most 1.5x the CPU's distance from 0): "
             f"{'; '.join(exact)}" if exact else ""), flush=True)


def stack_input(torch, model, hist, lens):
    """What the history encoder hands fused_attn_stack: the embedded
    history zeroed past each length, plus the PE at each length (f32)."""
    from two_tower_models_tpu_torch.models.history_encoder import (
        per_example_positional_encoding,
    )

    emb = model.item_id_table.detach()[hist]
    valid = torch.arange(HIST, device=hist.device)[None, :] < lens[:, None]
    return torch.where(valid[..., None], emb, 0) + per_example_positional_encoding(
        lens, HIST, emb.shape[-1])


def serve_leg(torch, label, engine, model, cpu_model, cfg, batches, expect, own,
              entries, failures, smi) -> None:
    """Ten query batches through engine.query, launch counts zeroed just
    before and read just after (``own``: the kernels whose ``launches`` this
    leg reports); indices against the dense plain MIPS on the same user
    embeddings, and the user embeddings against the CPU model on 32 rows."""
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk

    _lib.reset_launch_counts()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in batches]
    outs = []
    t0 = time.perf_counter()
    for (s, e), (u, f, h, lens) in zip(evs, batches):
        s.record()
        outs.append(engine.query(u, f, h, history_len=lens))
        e.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.launches)
    ms = [s.elapsed_time(e) for s, e in evs]
    print(f"launches on the {label} path: {json.dumps(counts)}", flush=True)
    check_launches(counts, expect, len(batches), failures, label)
    for name in own:
        entries[name]["launches"] = counts.get(name, 0)

    hits, total, margin_rows, mismatched = 0, 0, 0, 0
    for (u, f, h, lens), got in zip(batches, outs):
        with torch.inference_mode():
            qq, _ = tt.compute_user_embedding(model, cfg, u, f, h, lens)
            ridx, rsc, _ = mips_topk(engine.corpus, qq, TOPK + 1)
        if got.shape != (BATCH, TOPK) or int(got.min()) < 0 or int(got.max()) >= CORPUS:
            failures.append(f"{label} output shape/range")
        clear = (rsc[:, TOPK - 1] - rsc[:, TOPK]) > 1e-5 * rsc[:, TOPK - 1].abs()
        margin_rows += int(clear.sum())
        same = torch.sort(got[clear], dim=1).values == torch.sort(ridx[clear, :TOPK], dim=1).values
        mismatched += int((~same).any(dim=1).sum())
        for g, r in zip(got.tolist(), ridx[:, :TOPK].tolist()):
            hits += len(set(g) & set(r))
            total += TOPK
    recall = hits / total
    print(f"{label}: recall@{TOPK} vs plain {recall:.6f}; clear-margin rows "
          f"{margin_rows} with index mismatch {mismatched}", flush=True)
    if recall < 0.999 or mismatched:
        failures.append(f"{label} indices")

    u, f, h, lens = (None if t is None else t[:32] for t in batches[0])
    cpu = lambda t: None if t is None else t.cpu()
    with torch.inference_mode():
        q_gpu, _ = tt.compute_user_embedding(model, cfg, u, f, h, lens)
        q_cpu, _ = tt.compute_user_embedding(cpu_model, cfg, cpu(u), cpu(f), cpu(h), cpu(lens))
    ok, err = close(q_gpu.cpu(), q_cpu, 3e-2, 3e-2)
    print(f"{label} user embeddings GPU vs CPU: ok={ok} max_abs_err={err:.3g} (tol 3e-2)",
          flush=True)
    if not ok or not bool(q_gpu.isfinite().all()):
        failures.append(f"{label} user embeddings vs CPU")
    ms_batch = sum(ms) / len(ms)
    print(
        f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {len(batches)} batches of "
        f"B={BATCH} over C={CORPUS}, k={TOPK}: ms/batch mean {ms_batch:.3f} "
        f"min {min(ms):.3f} max {max(ms):.3f}; QPS {BATCH / ms_batch * 1e3:.0f}; "
        f"host wall {wall * 1e3 / len(batches):.3f} ms/batch",
        flush=True,
    )
    return counts, ms_batch


def phase_serve_varlen(torch, args, gen, smi, dev, cfg, model, cpu_model, engine, w,
                       entry, entries, failures) -> None:
    """Phase 2b: B8 on a variable-length batch, then the varlen serve leg."""
    from two_tower_models_tpu_torch.ops import fused_encoder as fe

    nh, nl, d = 4, 3, 64
    engine.warmup(BATCH, variable_history=True)
    batches = []
    for _ in range(args.batches):
        lens = torch.randint(1, HIST + 1, (BATCH,), generator=gen, device=dev)
        hist = torch.randint(0, CORPUS, (BATCH, HIST), generator=gen, device=dev)
        hist = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], hist, 0)
        batches.append((
            torch.randint(0, cfg.user_id_hash_size, (BATCH,), generator=gen, device=dev),
            torch.randn(BATCH, 16, generator=gen, device=dev), hist, lens,
        ))
    _, _, hist, lens = batches[0]
    x = stack_input(torch, model, hist, lens)
    xb = x.to(torch.bfloat16)
    route = fe._enc_route(torch.bfloat16, HIST, d, nh, nl)
    l32, w_k = fe._lens(lens, xb), [fe._f32(t, dev) for t in w]
    fma8 = lambda: fe._launch_fwd_fma("fused_attn_stack", xb, l32, *w_k, nh)
    ok_bf, err_bf = enc_checks(
        torch, "attention stack", (fe.fused_attn_stack_fwd(xb, lens, *w, nh),),
        (fe.fused_attn_stack_fwd(xb, lens, *w, nh),), (fe.fused_attn_stack_fwd_plain(xb, lens, *w, nh),),
        (fe.fused_attn_stack_f64_sums(xb, lens, *w, nh),), (fma8(),), ("y",))
    ok_32, err_32 = close(fe.fused_attn_stack_fwd(x, lens, *w, nh),
                          fe.fused_attn_stack_fwd_plain(x, lens, *w, nh), 1e-4, 1e-4)
    print(f"attention stack route {route}; f32: ok={ok_32} max_abs_err={err_32:.3g} (tol 1e-4)",
          flush=True)
    n_valid = int(lens.sum())
    w_bytes = sum(t.numel() for t in w) * 4
    entry(
        "fused_attn_stack", "two_tower_models_tpu_torch/csrc/fused_encoder.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:853",
        ok_bf and ok_32 and route == "tc", err_bf,
        time_ms(torch, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh)),
        time_ms(torch, lambda: fe.fused_attn_stack_fwd_plain(xb, lens, *w, nh)),
        n_valid * d * 2 + BATCH * 4 + w_bytes + BATCH * d * 2,
        sum(enc_flops(n, d, nl) for n in lens.tolist()), BF16_FLOPS, None,
    )
    e8 = entries["fused_attn_stack"]
    e8["kernel_route"] = route
    enc_times(torch, e8, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh), fma8,
              lambda: b13_layers(xb, l32, w, nh))
    print(enc_line(torch, smi, f"B8 at B={BATCH}", e8), flush=True)
    e8["note"] = (
        "bytes and operations count each example's valid rows only; kernel_route, device_ms, "
        "fma_* and b13x3_device_ms as fused_history_encoder's, with lengths; train_* at the "
        "training batch (B=4096) of phase 4b")
    counts, _ = serve_leg(
        torch, "serve varlen", engine, model, cpu_model, cfg, batches,
        {"fused_attn_stack": 1, "fused_history_encoder": 0, **MIPS_ROUTE, **ENC_TC,
         "fused_attn_stack_tc": 1},
        ["fused_attn_stack"], entries, failures, smi,
    )
    e8["tc_launches"] = counts.get("fused_attn_stack_tc", 0)


def trace_steps(torch, step, state, data, idx, label: str):
    """Three steps under torch.profiler: device time per kernel (device-side
    events only: kernels and copies, one stream) and the device's busy
    share of the window.  Returns (the state, device-busy ms a step, None if
    the profiler recorded no device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.enable_grad(), torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(3):
            state, _ = step(state, data, idx)
        end.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(end) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy = sum(by_name.values())
    if busy:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        print(f"{label} trace, 3 steps under the profiler ({window_us / 3e3:.3f} ms/step): "
              f"device busy {busy / 3e3:.3f} ms/step ({busy / window_us * 100:.1f}% of the "
              f"window) in {len(by_name)} distinct kernels and copies; top per step: "
              + "; ".join(f"{k[:48]} {v / 3e3:.3f} ms" for k, v in top), flush=True)
    else:
        print(f"{label} trace: the profiler recorded no device time (not measured)", flush=True)
    return state, busy / 3e3 if busy else None


def flagship_cfg(rows: int):
    """bench.py's _bench_cfg, copied, with ``rows``-row user and item
    tables; at 2^22 rows it is scripts/bench_tables.py's configuration."""
    from two_tower_models_tpu_torch.config import Debias, HistoryEncoderConfig, ModelConfig

    return ModelConfig(
        user_id_hash_size=rows,
        user_id_embedding_dim=64,
        item_id_hash_size=rows,
        item_id_embedding_dim=64,
        user_features_size=16,
        item_features_size=16,
        user_value_weights=(1.0, 0.5, 0.25),
        history_len=HIST,
        history_encoder=HistoryEncoderConfig(fused_encoder=True),
        debias=Debias.BOTH,
        compute_dtype="bfloat16",
        fused_loss=True,
    )


def serve_cfg():
    """The exact leg of scripts/bench_serving.py (phase 3's configuration)."""
    from two_tower_models_tpu_torch.config import Debias, HistoryEncoderConfig, ModelConfig

    return ModelConfig(
        user_id_hash_size=65536,
        user_id_embedding_dim=64,
        item_id_hash_size=CORPUS,
        item_id_embedding_dim=64,
        user_features_size=16,
        item_features_size=16,
        user_value_weights=(1.0, 0.5, 0.25),
        history_len=HIST,
        history_encoder=HistoryEncoderConfig(fused_encoder=True),
        debias=Debias.BOTH,
        compute_dtype="bfloat16",
        num_items=TOPK,
    )


def serve_setup(torch, args, dev):
    """Phase 3's model, catalog, engine (warmed up) and query batches, all
    from --seed: (cfg, the generator, model, engine, batches)."""
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    cfg = serve_cfg()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = tt.init_params(gen, cfg, device=dev)
    catalog_ids = torch.arange(CORPUS, device=dev)
    catalog_feats = torch.randn(CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, catalog_ids, catalog_feats, device=dev)
    engine.warmup(BATCH)
    batches = [
        (
            torch.randint(0, cfg.user_id_hash_size, (BATCH,), generator=gen, device=dev),
            torch.randn(BATCH, 16, generator=gen, device=dev),
            torch.randint(0, CORPUS, (BATCH, HIST), generator=gen, device=dev),
        )
        for _ in range(args.batches)
    ]
    torch.cuda.synchronize()
    return cfg, gen, model, engine, batches


def fixed_batch(torch, gen, dev, cfg, b: int):
    """One fixed batch of b rows for ``cfg`` with __graft_entry__._make_batch's
    shapes: ids uniform over the tables, positions over the position table."""
    from two_tower_models_tpu_torch.training.data import SyntheticRecData

    randint = lambda hi, *shape: torch.randint(0, hi, shape, generator=gen, device=dev)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return SyntheticRecData(
        user_ids=randint(cfg.user_id_hash_size, b),
        user_features=randn(b, cfg.user_features_size),
        user_history=randint(cfg.item_id_hash_size, b, cfg.history_len),
        item_ids=randint(cfg.item_id_hash_size, b),
        item_features=randn(b, cfg.item_features_size),
        positions=randint(cfg.position_table_size, b),
        labels=torch.bernoulli(torch.full((b, cfg.num_tasks), 0.5, device=dev), generator=gen),
        catalog_ids=torch.arange(4, device=dev),
        catalog_features=torch.zeros(4, cfg.item_features_size, device=dev),
    )


def phase_train(torch, args, smi, dev, entry, entries, failures, b6_ptxas: str,
                b7_ptxas: str, b10_ptxas: str):
    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.models.history_encoder import (
        sinusoidal_positional_encoding,
    )
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import fused_encoder as fe
    from two_tower_models_tpu_torch.ops import fused_softmax as fs
    from two_tower_models_tpu_torch.training.data import gather_batch
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    cfg = flagship_cfg(TRAIN_ROWS)
    train_cfg = TrainConfig(batch_size=TRAIN_BATCH, learning_rate=1e-3)
    b, d, h, nh, nl = TRAIN_BATCH, 64, HIST, 4, 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    model = state.params
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, b)
    idx = torch.arange(b, device=dev)
    batch = gather_batch(data, idx)

    # -- the five training kernels on the step's own tensors --
    with torch.no_grad():
        u, _ = tt.compute_user_embedding(model, cfg, batch.user_id, batch.user_features,
                                         batch.user_history)
        it = tt.compute_item_embeddings(model, cfg, batch.item_id, batch.item_features)
        nuv, _ = tt.example_weights(model, cfg, u, batch.position, batch.labels)
    g_ce = nuv / b  # the cotangent of ce in the loss
    # B10 (3xTF32 on the tensor cores): against plain, and both against f64 sums
    ce_k, lse_k = fs.in_batch_ce_fwd(u, it)
    ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, it)
    ok_c, err_c = close(ce_k, ce_p, 0.0, 1e-5 * float(ce_p.abs().max()))
    ok_l, err_l = close(lse_k, lse_p, 0.0, 1e-5 * float(lse_p.abs().max()))
    ce_2, lse_2 = fs.in_batch_ce_fwd(u, it)
    repeat10 = torch.equal(ce_k, ce_2) and torch.equal(lse_k, lse_2)
    s64 = u.double() @ it.double().T
    lse64 = torch.logsumexp(s64, 1)
    ce64 = lse64 - torch.diagonal(s64)
    del s64
    f64_scale = float(lse64.abs().max())
    f64_err = lambda got, want: float((got.double() - want).abs().max()) / f64_scale
    f64 = {"lse": f64_err(lse_k, lse64), "ce": f64_err(ce_k, ce64),
           "plain_lse": f64_err(lse_p, lse64), "plain_ce": f64_err(ce_p, ce64)}
    ok_64 = max(f64["lse"], f64["ce"]) <= 1e-5
    print(f"CE forward (B10) vs plain: max_abs_err {max(err_c, err_l):.3g} (tol 1e-5 of scale); "
          f"from f64 sums, share of max |lse| {f64_scale:.4f}: kernel lse {f64['lse']:.3g} ce "
          f"{f64['ce']:.3g}, plain lse {f64['plain_lse']:.3g} ce {f64['plain_ce']:.3g} (tol 1e-5); "
          f"bit-equal on repeat={repeat10}; splits "
          f"{fs.fwd_plan(b, b, d, _lib.sm_count(torch.cuda.current_device()))}; "
          f"bounds: 3xTF32 {3 * 2 * b * b * d / TF32_FLOPS * 1e3:.4f} ms, f32 FMA "
          f"{2 * b * b * d / F32_FLOPS * 1e3:.4f} ms", flush=True)
    b10 = lambda: fs.in_batch_ce_fwd(u, it)
    ce_lib = lambda: torch.logsumexp(u @ it.T, 1) - (u * it).sum(1)
    entry(
        "fused_in_batch_ce", "two_tower_models_tpu_torch/csrc/fused_softmax.cu",
        "two_tower_models_tpu/ops/pallas/fused_softmax.py:121",
        ok_c and ok_l and repeat10 and ok_64, max(err_c, err_l),
        time_ms(torch, b10), time_ms(torch, lambda: fs.in_batch_ce_fwd_plain(u, it)),
        2 * b * d * 4 + 2 * b * 4, 3 * 2 * b * b * d, TF32_FLOPS, time_ms(torch, ce_lib),
    )
    e10 = entries["fused_in_batch_ce"]
    e10["device_ms"] = device_ms(torch, b10, "ce_fwd_tc_kernel")
    e10["library_device_ms"] = call_device_ms(torch, ce_lib)
    e10["f32_fma_bound_ms"] = 2 * b * b * d / F32_FLOPS * 1e3
    e10["f64_err"] = f64
    e10["ptxas"] = b10_ptxas
    print(f"B10 at B={b} on {torch.cuda.get_device_name(0)} ({smi}): device {e10['device_ms']:.4f} "
          f"ms, with the host's dispatch {e10['ms']:.4f}; library (logsumexp of U I^T - diag) "
          f"device {e10['library_device_ms']:.4f}, {e10['library_ms']:.4f} with dispatch; bound "
          f"{e10['bound_ms']:.4f} ({e10['bound_by']}, 3xTF32), f32 FMA {e10['f32_fma_bound_ms']:.4f}; "
          f"ptxas {b10_ptxas}", flush=True)
    e10["note"] = ("bound_ms counts the three TF32 products at the TF32 tensor-core rate "
                   "(f32_fma_bound_ms: one f32 product on the CUDA cores); device_ms the "
                   "kernel's device time from torch.profiler; f64_err the max abs error from "
                   "f64 sums over max |f64 lse|")
    del ce_2, lse_2, lse64, ce64
    # B11 and B12: one pass over the score tiles writes both gradients
    term = float(g_ce.abs().max()) * max(float(u.abs().max()), float(it.abs().max()))
    (du_k, di_k), (du_p, di_p) = (fs.in_batch_ce_bwd(u, it, lse_k, g_ce),
                                  fs.in_batch_ce_bwd_plain(u, it, lse_p, g_ce))
    checks = [close(got, want, 0.0, 1e-5 * max(float(want.abs().max()), term))
              for got, want in ((du_k, du_p), (di_k, di_p))]
    du_2, di_2 = fs.in_batch_ce_bwd(u, it, lse_k, g_ce)
    repeat = torch.equal(du_k, du_2) and torch.equal(di_k, di_2)
    print(f"CE backward (dU, dI) vs plain: max_abs_err {[float(f'{e:.3g}') for _, e in checks]} "
          f"(tol 1e-5 of scale); bit-equal on repeat={repeat}", flush=True)

    def ce_bwd_lib():  # one softmax, both gradients
        sm = torch.softmax(u @ it.T, 1) * g_ce[:, None]
        return sm @ it - g_ce[:, None] * it, sm.T @ u - g_ce[:, None] * u

    entry(
        "in_batch_ce_bwd", "two_tower_models_tpu_torch/csrc/fused_softmax.cu",
        "two_tower_models_tpu/ops/pallas/fused_softmax.py:228 and :246",
        all(ok for ok, _ in checks) and repeat, max(err for _, err in checks),
        time_ms(torch, lambda: fs.in_batch_ce_bwd(u, it, lse_k, g_ce)),
        time_ms(torch, lambda: fs.in_batch_ce_bwd_plain(u, it, lse_k, g_ce)),
        4 * b * d * 4 + 2 * b * 4, 6 * b * b * d, F32_FLOPS, time_ms(torch, ce_bwd_lib),
    )
    entries["in_batch_ce_bwd"]["note"] = (
        "B11 (dU) and B12 (dI) in one kernel; ms includes the launch that sums its partial slices")
    del ce_p, lse_p, du_k, di_k, du_p, di_p, du_2, di_2

    layers = model.history_encoder.attn_layers
    w = [torch.stack([getattr(getattr(l, p), a) for l in layers]).detach()
         for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))]
    pe = sinusoidal_positional_encoding(h, d, dev)
    x = model.item_id_table.detach()[batch.user_history].to(torch.bfloat16)
    res_k = fe.fused_history_encoder_res(x, pe, *w, nh)
    res_p = fe.fused_history_encoder_res_plain(x, pe, *w, nh)
    route = fe._enc_route(x.dtype, h, d, nh, nl)
    w_k = [fe._f32(t, dev) for t in w]
    fma5 = lambda: fe._launch_fwd_fma("fused_history_encoder_res", x, fe._pe(pe, x), *w_k, nh)
    ok5, err5 = enc_checks(
        torch, "encoder residual forward", res_k, fe.fused_history_encoder_res(x, pe, *w, nh),
        res_p, fe.fused_history_encoder_res_f64_sums(x, pe, *w, nh), fma5(),
        ("y", "xs", "ps", "p0"))
    w_bytes = sum(t.numel() for t in w) * 4 + pe.numel() * 4
    resid_bytes = (nl * b * h * d + (nl - 1) * b * nh * h * h + b * nh * h) * 2
    entry(
        "fused_history_encoder_res", "two_tower_models_tpu_torch/csrc/fused_encoder.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:561", ok5 and route == "tc", err5,
        time_ms(torch, lambda: fe.fused_history_encoder_res(x, pe, *w, nh)),
        time_ms(torch, lambda: fe.fused_history_encoder_res_plain(x, pe, *w, nh)),
        b * h * d * 2 + w_bytes + b * 2 * d * 2 + resid_bytes, b * enc_flops(h, d, nl),
        BF16_FLOPS, None,
    )
    e5 = entries["fused_history_encoder_res"]
    e5["kernel_route"] = route
    x0 = (x.float() + pe).to(torch.bfloat16)
    enc_times(torch, e5, lambda: fe.fused_history_encoder_res(x, pe, *w, nh), fma5,
              lambda: b13_layers(x0, None, w, nh))
    print(enc_line(torch, smi, f"B5 at B={b}", e5), flush=True)
    e5["note"] = "kernel_route, device_ms, fma_* and b13x3_device_ms as fused_history_encoder's"
    del x0
    # B6 on the plain residuals, so it is held alone; the cotangent is
    # random at the size of a loss averaged over B (bf16, as autograd gives it)
    g_enc = (randn(b, 2, d) / b).to(torch.bfloat16)
    _, xs, ps, p0 = res_p
    bwd_args = (g_enc, xs, ps, p0, w[0], w[1], w[2], nh)
    route6 = fe._enc_bwd_route(x.dtype, h, d, nh, nl)
    inputs6, shapes6 = fe._res_bwd_inputs(*bwd_args), fe._grad_shapes(h, d, nl, True)

    def fma6():  # the FMA kernel on the same inputs, its outputs in the wrapper's order
        dx6 = torch.empty_like(x)
        dwi, dbi, dwo, dbo, dpe = fe._launch_bwd_fma("fused_history_encoder_bwd", inputs6, dx6,
                                                     shapes6, nh, nl)
        return dx6, dpe, dwi, dbi, dwo, dbo

    want = fe.fused_history_encoder_bwd_plain(*bwd_args)
    ok6, err6 = bwd_checks(
        torch, "encoder backward (B6)", fe.fused_history_encoder_bwd(*bwd_args),
        fe.fused_history_encoder_bwd(*bwd_args), want,
        fe.fused_history_encoder_bwd_f64_sums(*bwd_args), fma6(),
        ("dx", "dpe", "dW_in", "db_in", "dW_out", "db_out"))
    # and on the tensor-core kernel's residuals, against the plain backward
    # on the plain version's: the layouts agree, and the rounding flips
    # between the two forwards stay within the backward's tolerance
    on_tc = [close(a, e, 0.0, 3e-2 * float(e.float().abs().max())) for a, e in zip(
        fe.fused_history_encoder_bwd(g_enc, *res_k[1:], w[0], w[1], w[2], nh), want)]
    print(f"encoder backward (B6) on the tensor-core residuals vs plain: ok="
          f"{all(ok for ok, _ in on_tc)} max_abs_err {[float(f'{e:.3g}') for _, e in on_tc]} "
          f"(tol 3e-2 of scale)", flush=True)
    grads_bytes = sum(t.numel() for t in want[1:]) * 4
    entry(
        "fused_history_encoder_bwd", "two_tower_models_tpu_torch/csrc/fused_encoder_bwd.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:618",
        ok6 and all(ok for ok, _ in on_tc) and route6 == "tc", err6,
        time_ms(torch, lambda: fe.fused_history_encoder_bwd(*bwd_args)),
        time_ms(torch, lambda: fe.fused_history_encoder_bwd_plain(*bwd_args)),
        b * 2 * d * 2 + resid_bytes + w_bytes + b * h * d * 2 + grads_bytes,
        b * resid_bwd_flops(h, d, nl), BF16_FLOPS, None,
    )
    e6 = entries["fused_history_encoder_bwd"]
    e6["kernel_route"] = route6
    bwd_times(torch, e6, lambda: fe.fused_history_encoder_bwd(*bwd_args), fma6,
              lambda: b14_layers(torch, xs[0], None, w, nh), b6_ptxas)
    print(bwd_line(torch, smi, f"B6 at B={b}", e6), flush=True)

    # -- phase 4c, first half: B7 on the same input, held as B6 (against
    # its plain version, f64 sums and the FMA kernel), against the FMA
    # kernel directly and against B6 on B5's residuals (one VJP, p rounded
    # in B6) --
    rc_args = (g_enc, x, pe, *w, nh)
    route7 = fe._enc_bwd_route(x.dtype, h, d, nh, nl)
    inputs7 = fe._recompute_bwd_inputs(g_enc, x, fe._pe(pe, x), *w, nh, enc=True)
    res7 = fe._res_floats(h, d, nh, nl)

    def fma7():  # the FMA kernel on the same inputs, its outputs in the wrapper's order
        dx7 = torch.empty_like(x)
        dwi, dbi, dwo, dbo, dpe = fe._launch_bwd_fma("fused_history_encoder_bwd_recompute",
                                                     inputs7, dx7, shapes6, nh, nl, res7)
        return dx7, dpe, dwi, dbi, dwo, dbo

    got7 = fe.fused_history_encoder_bwd_recompute(*rc_args)
    fma7_out = fma7()
    ok7, err7 = bwd_checks(
        torch, "encoder recompute backward (B7)", got7,
        fe.fused_history_encoder_bwd_recompute(*rc_args),
        fe.fused_history_encoder_bwd_recompute_plain(*rc_args),
        fe.fused_history_encoder_bwd_recompute_f64_sums(*rc_args), fma7_out,
        ("dx", "dpe", "dW_in", "db_in", "dW_out", "db_out"))
    vs_fma = [scaled_close(a, e, 3e-2) for a, e in zip(got7, fma7_out)]
    b6 = fe.fused_history_encoder_bwd(g_enc, *res_k[1:], w[0], w[1], w[2], nh)
    vs_b6 = [scaled_close(a, e, 3e-2) for a, e in zip(got7, b6)]
    x32, g32 = x.float(), g_enc.float()
    ok_32 = all(scaled_close(a, e, 1e-4)[0] for a, e in zip(
        fe.fused_history_encoder_bwd_recompute(g32, x32, pe, *w, nh),
        fe.fused_history_encoder_bwd_recompute_plain(g32, x32, pe, *w, nh)))
    print(f"encoder recompute backward (B7) vs the FMA kernel and vs B6 (dx, dpe, dW_in, "
          f"db_in, dW_out, db_out): FMA ok={all(ok for ok, _ in vs_fma)} max_abs_err "
          f"{[float(f'{err:.3g}') for _, err in vs_fma]}; B6 ok={all(ok for ok, _ in vs_b6)} "
          f"max_abs_err {[float(f'{err:.3g}') for _, err in vs_b6]} (tol 3e-2 of scale); f32 "
          f"vs plain ok={ok_32} (tol 1e-4 of scale)", flush=True)
    entry(
        "fused_history_encoder_bwd_recompute",
        "two_tower_models_tpu_torch/csrc/fused_encoder_bwd.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:700",
        ok7 and all(ok for ok, _ in vs_fma + vs_b6) and ok_32 and route7 == "tc", err7,
        time_ms(torch, lambda: fe.fused_history_encoder_bwd_recompute(*rc_args)),
        time_ms(torch, lambda: fe.fused_history_encoder_bwd_recompute_plain(*rc_args)),
        b * h * d * 2 + b * 2 * d * 2 + w_bytes + b * h * d * 2 + grads_bytes,
        b * vjp_flops(h, d, nl), BF16_FLOPS, None,
    )
    e7 = entries["fused_history_encoder_bwd_recompute"]
    e7["kernel_route"] = route7
    bwd_times(torch, e7, lambda: fe.fused_history_encoder_bwd_recompute(*rc_args), fma7,
              lambda: b14_layers(torch, xs[0], None, w, nh), b7_ptxas)
    print(bwd_line(torch, smi, f"B7 at B={b}", e7), flush=True)
    del res_k, res_p, want, xs, ps, p0, got7, fma7_out, b6
    torch.cuda.empty_cache()

    # -- the training steps --
    step = make_train_step(cfg, train_cfg)
    state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, 3)
    state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
    metrics += timed
    print(f"launches on the training path ({TRAIN_STEPS} steps): {json.dumps(counts)}", flush=True)
    expect = {"fused_history_encoder_res": 1, "fused_history_encoder_bwd": 1,
              "fused_history_encoder_bwd_reduce": 1, "fused_in_batch_ce": 1,
              "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1, "fused_history_encoder": 0,
              "fused_history_encoder_bwd_recompute": 0, "rows_scatter_add": POS_B18,
              "rows_write": 0, **ENC_TC, "fused_history_encoder_res_tc": 1,
              "fused_history_encoder_bwd_tc": 1}
    check_launches(counts, expect, TRAIN_STEPS, failures, "train")
    e5["tc_launches"] = counts.get("fused_history_encoder_res_tc", 0)
    e6["tc_launches"] = counts.get("fused_history_encoder_bwd_tc", 0)
    for name, per in expect.items():
        if name in entries and per:
            entries[name]["launches"] = counts.get(name, 0)
    entries["fused_history_encoder_bwd"]["reduce_launches"] = counts.get(
        "fused_history_encoder_bwd_reduce", 0)
    entries["in_batch_ce_bwd"]["reduce_launches"] = counts.get("in_batch_ce_bwd_reduce", 0)
    first, last = metrics[0], metrics[-1]
    if not finite(torch, metrics):
        failures.append("train metrics not finite")
    kernel_ms = sum(entries[n]["ms"] for n in expect if n in entries and expect[n])
    print(
        f"train on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of B={b}: "
        f"ms/step {ms_step:.3f}, examples/s {b / ms_step * 1e3:.0f}; host wall "
        f"{host_ms:.3f} ms/step; loss first {float(first['loss']):.5f} "
        f"last {float(last['loss']):.5f}; softmax_ce first {float(first['softmax_ce']):.5f} "
        f"last {float(last['softmax_ce']):.5f}; the training kernels alone {kernel_ms:.3f} ms "
        f"({kernel_ms / ms_step * 100:.1f}% of the step)",
        flush=True,
    )

    # -- where a step's device time goes: a trace of three steps --
    state, busy6 = trace_steps(torch, step, state, data, idx, "train")

    # -- phase 4c, second half: the step with B1 + B7 (_RESIDUAL_BWD False)
    # beside the B5 + B6 step, in the order B6, B7, B7, B6, then three B7
    # steps under the profiler --
    b6_ms, b7_ms = [ms_step], []
    try:
        fe._RESIDUAL_BWD = False
        for i in range(2):
            state, m7, ms, _, counts = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
            b7_ms.append(ms)
            if not finite(torch, m7):
                failures.append("train (B7) metrics not finite")
            if i == 0:
                print(f"launches on the B7 training path ({TRAIN_STEPS} steps): "
                      f"{json.dumps(counts)}", flush=True)
                check_launches(counts, {
                    "fused_history_encoder": 1, "fused_history_encoder_bwd_recompute": 1,
                    "fused_history_encoder_bwd_recompute_reduce": 1,
                    "fused_history_encoder_res": 0, "fused_history_encoder_bwd": 0,
                    **ENC_TC, "fused_history_encoder_tc": 1,
                    "fused_history_encoder_bwd_recompute_tc": 1,
                }, TRAIN_STEPS, failures, "train (B7)")
                e7["launches"] = counts.get("fused_history_encoder_bwd_recompute", 0)
                e7["tc_launches"] = counts.get("fused_history_encoder_bwd_recompute_tc", 0)
                e7["reduce_launches"] = counts.get("fused_history_encoder_bwd_recompute_reduce", 0)
        state, busy7 = trace_steps(torch, step, state, data, idx, "train (B7)")
    finally:
        fe._RESIDUAL_BWD = True
    state, _, ms, _, _ = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
    b6_ms.append(ms)
    busy = lambda v: "not measured" if v is None else f"{v:.3f}"
    print(f"encoder backward in the step on {torch.cuda.get_device_name(0)} ({smi}), "
          f"{TRAIN_STEPS} steps each, order B6 B7 B7 B6: B5+B6 ms/step "
          f"{b6_ms[0]:.3f} {b6_ms[1]:.3f}; B1+B7 ms/step {b7_ms[0]:.3f} {b7_ms[1]:.3f}; "
          f"device busy ms a step (three profiled steps): B5+B6 {busy(busy6)}, B1+B7 "
          f"{busy(busy7)}", flush=True)
    e7["busy_ms_step"] = busy7
    e7["busy_ms_step_b5_b6"] = busy6

    # -- train_loss and its gradients, card against a CPU copy --
    grads_vs_cpu(torch, model, cfg, data, idx, failures, "train")
    return cfg, train_cfg, b6_ms  # phase 4b trains the same configuration


def phase_train_varlen(torch, args, smi, dev, cfg, train_cfg, entry, entries, failures,
                       b9_ptxas: str) -> None:
    """Phase 4b: the flagship step on make_synthetic_data's variable-length
    histories; B9 on the step's own tensors (``b9_ptxas``: phase 1's report
    of its tensor-core instance there)."""
    from two_tower_models_tpu_torch.config import DataConfig
    from two_tower_models_tpu_torch.ops import fused_encoder as fe
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    b, d, nh, nl = TRAIN_BATCH, 64, 4, 3
    data = make_synthetic_data(DataConfig(
        num_samples=b, num_users=TRAIN_ROWS, num_items=TRAIN_ROWS, feature_dim=16,
        history_len=HIST, num_tasks=3, max_position=cfg.position_table_size,
        seed=args.seed, variable_history=True,
    ), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 2)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    model = state.params
    idx = torch.arange(b, device=dev)
    batch = gather_batch(data, idx)
    layers = model.history_encoder.attn_layers
    w = [torch.stack([getattr(getattr(l, p), a) for l in layers]).detach()
         for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))]
    lens = batch.history_len
    x = stack_input(torch, model, batch.user_history, lens)
    xb = x.to(torch.bfloat16)
    g = torch.randn(b, d, generator=gen, device=dev) / b
    gb = g.to(torch.bfloat16)
    h = HIST
    route9 = fe._enc_bwd_route(xb.dtype, h, d, nh, nl)
    inputs9 = fe._recompute_bwd_inputs(gb, xb, fe._lens(lens, xb), *w, nh, enc=False)
    shapes9 = fe._grad_shapes(h, d, nl, False)

    def fma9():  # the FMA kernel on the same inputs
        dx9 = torch.empty_like(xb)
        return (dx9, *fe._launch_bwd_fma("fused_attn_stack_bwd", inputs9, dx9, shapes9, nh, nl,
                                         fe._res_floats(h, d, nh, nl)))

    got = fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh)
    want = fe.fused_attn_stack_bwd_plain(gb, xb, lens, *w, nh)
    ok9, err9 = bwd_checks(
        torch, "attention stack backward (B9)", got, fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh),
        want, fe.fused_attn_stack_bwd_f64_sums(gb, xb, lens, *w, nh), fma9(),
        ("dx", "dW_in", "db_in", "dW_out", "db_out"))
    ok_32 = all(scaled_close(a, e, 1e-4)[0] for a, e in zip(
        fe.fused_attn_stack_bwd(g, x, lens, *w, nh),
        fe.fused_attn_stack_bwd_plain(g, x, lens, *w, nh)))
    past = torch.arange(HIST, device=dev)[None, :] >= lens[:, None]
    zero_past = bool((got[0][past] == 0).all())
    print(f"attention stack backward: f32 ok={ok_32} (tol 1e-4 of scale); dx zero past each "
          f"length: {zero_past}", flush=True)
    n_valid = int(lens.sum())
    grads_bytes = sum(t.numel() for t in want[1:]) * 4
    entry(
        "fused_attn_stack_bwd", "two_tower_models_tpu_torch/csrc/fused_encoder_bwd.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:893",
        ok9 and ok_32 and zero_past and route9 == "tc", err9,
        time_ms(torch, lambda: fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh)),
        time_ms(torch, lambda: fe.fused_attn_stack_bwd_plain(gb, xb, lens, *w, nh)),
        n_valid * d * 2 + b * 4 + b * d * 2 + sum(t.numel() for t in w) * 4
        + b * HIST * d * 2 + grads_bytes,
        sum(vjp_flops(n, d, nl) for n in lens.tolist()), BF16_FLOPS, None,
    )
    e9 = entries["fused_attn_stack_bwd"]
    e9["kernel_route"] = route9
    bwd_times(torch, e9, lambda: fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh), fma9,
              lambda: b14_layers(torch, xb, fe._lens(lens, xb), w, nh), b9_ptxas)
    e9["note"] += "; bytes and operations count each example's valid rows only"
    print(bwd_line(torch, smi, f"B9 at B={b}", e9), flush=True)
    # B8 at the training batch: the tensor cores, the FMA kernel, three B13
    e8 = entries["fused_attn_stack"]
    l32, w_k = fe._lens(lens, xb), [fe._f32(t, dev) for t in w]
    e8["train_ms"] = time_ms(torch, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh))
    e8["train_bound_ms"] = bound(n_valid * d * 2 + b * 4 + sum(t.numel() for t in w) * 4
                                 + b * d * 2, sum(enc_flops(n, d, nl) for n in lens.tolist()),
                                 BF16_FLOPS)[0]
    enc_times(torch, e8, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh),
              lambda: fe._launch_fwd_fma("fused_attn_stack", xb, l32, *w_k, nh),
              lambda: b13_layers(xb, l32, w, nh), "train_")
    print(enc_line(torch, smi, f"B8 at B={b}", e8, "train_")
          + f"; bound {e8['train_bound_ms']:.4f}", flush=True)
    del got, want, x, xb
    torch.cuda.empty_cache()

    step = make_train_step(cfg, train_cfg)
    state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, 3)
    state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
    metrics += timed
    print(f"launches on the varlen training path ({TRAIN_STEPS} steps): {json.dumps(counts)}",
          flush=True)
    check_launches(counts, {
        "fused_attn_stack": 1, "fused_attn_stack_bwd": 1, "fused_attn_stack_bwd_reduce": 1,
        "fused_in_batch_ce": 1, "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1,
        "fused_history_encoder": 0, "fused_history_encoder_res": 0,
        "fused_history_encoder_bwd": 0, "fused_history_encoder_bwd_recompute": 0,
        "rows_scatter_add": POS_B18, "rows_write": 0, **ENC_TC, "fused_attn_stack_tc": 1,
        "fused_attn_stack_bwd_tc": 1,
    }, TRAIN_STEPS, failures, "train varlen")
    entries["fused_attn_stack"]["train_tc_launches"] = counts.get("fused_attn_stack_tc", 0)
    entries["fused_attn_stack_bwd"]["launches"] = counts.get("fused_attn_stack_bwd", 0)
    entries["fused_attn_stack_bwd"]["tc_launches"] = counts.get("fused_attn_stack_bwd_tc", 0)
    entries["fused_attn_stack_bwd"]["reduce_launches"] = counts.get(
        "fused_attn_stack_bwd_reduce", 0)
    if not finite(torch, metrics):
        failures.append("train varlen metrics not finite")
    first, last = metrics[0], metrics[-1]
    print(
        f"train varlen on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of "
        f"B={b}, lengths uniform in [1, {HIST}] (mean {n_valid / b:.2f}): ms/step "
        f"{ms_step:.3f}, examples/s {b / ms_step * 1e3:.0f}; host wall {host_ms:.3f} ms/step; "
        f"loss first {float(first['loss']):.5f} last {float(last['loss']):.5f}",
        flush=True,
    )
    state, _ = trace_steps(torch, step, state, data, idx, "train varlen")
    grads_vs_cpu(torch, model, cfg, data, idx, failures, "train varlen")


# The warning CUDA's sync debug mode gives for each operation that waits
# (c10/cuda: warn_or_error_on_sync); the mode's one-time notice that it is
# a prototype ("Synchronization debug mode ... synchronizing operations")
# is not one.
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(torch, step, state, data, idx):
    """One step under CUDA's sync debug mode: (state, the number of
    operations that made the host wait for the stream)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught, torch.enable_grad():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, data, idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return state, sum(SYNC_WARNING in str(w.message) for w in caught)


def table_leg(torch, label, step, state, data, idx, warm, expect, smi, failures):
    """``warm`` warm-up steps, then TABLE_STEPS timed steps with the launch
    counts zeroed around them (``expect``: launches per step), one step
    counting its host syncs, then three steps under the profiler.  Returns
    (state, ms/step, counts)."""
    torch.cuda.reset_peak_memory_stats()
    state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, warm)
    state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx, TABLE_STEPS)
    state, syncs = count_syncs(torch, step, state, data, idx)
    metrics += timed
    print(f"launches on the {label} path ({TABLE_STEPS} steps): {json.dumps(counts)}", flush=True)
    check_launches(counts, expect, TABLE_STEPS, failures, label)
    if not finite(torch, metrics):
        failures.append(f"{label} metrics not finite")
    b = idx.shape[0]
    print(
        f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {TABLE_STEPS} steps of B={b}: "
        f"ms/step {ms_step:.3f}, examples/s {b / ms_step * 1e3:.0f}; host wall "
        f"{host_ms:.3f} ms/step; loss first {float(metrics[0]['loss']):.5f} last "
        f"{float(metrics[-1]['loss']):.5f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host syncs in a step {syncs}",
        flush=True,
    )
    return trace_steps(torch, step, state, data, idx, label)[0], ms_step, counts


def table_tensors(state):
    """{name: tensor} of the id tables and their Adam moments."""
    from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS

    opt = state.opt_state
    out = {}
    for name in SPARSE_TABLE_KEYS:
        out[name] = getattr(state.params, name).detach()
        for m in ("mu", "nu"):
            out[f"{m}.{name}"] = (opt.tables[m] if hasattr(opt, "tables") else getattr(opt, m))[name]
    return out


def route_check(torch, label, step, state, data, idx, failures):
    """One step from one state twice: through the kernels, and on the plain
    route (the scatter kernel disabled, B19 swapped for its plain version).
    The updated tables and moments agree at 1e-5 of each one's scale (the
    table gradients are f32 sums in other orders).  Returns the state."""
    from unittest import mock

    from two_tower_models_tpu_torch.nn.layers import disable_scatter_kernel
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import rows_write as rw
    from two_tower_models_tpu_torch.training import sparse_tables

    twin = copy.deepcopy(state)
    with torch.enable_grad():
        state, _ = step(state, data, idx)
        before = dict(_lib.launches)
        with disable_scatter_kernel(), mock.patch.object(
                sparse_tables, "rows_write_many", rw.rows_write_many_reference):
            twin, _ = step(twin, data, idx)
    plain_launches = sum(_lib.launches[k] - before.get(k, 0) for k in ("rows_scatter_add", "rows_write"))
    got, want = table_tensors(state), table_tensors(twin)
    worst = 0.0
    for name in got:
        ok, err = scaled_close(got[name], want[name], 1e-5)
        worst = max(worst, err)
        if not ok:
            failures.append(f"{label} kernel vs plain route: {name}")
    if plain_launches:
        failures.append(f"{label} plain route launched {plain_launches} kernels")
    print(f"{label}: one step through the kernels vs the plain route, tables and moments: "
          f"max_abs_err {worst:.3g} (tol 1e-5 of each one's scale); kernels launched on the "
          f"plain route: {plain_launches}", flush=True)
    del twin
    torch.cuda.empty_cache()
    return state


def row_write_check(torch, cfg, st_lazy, batch, randn, dev, entry, entries) -> None:
    """Phase 5a: B19 at the 4M-lazy write-back, on the step's own ids: the
    two rows_write_many launches of a step (one a table: the table and its
    two moments) and the six one-array launches, exactly against the plain
    version, timed with and without the host's dispatch beside index_copy_
    of the blended rows.  Its copies of the tables die with it."""
    from two_tower_models_tpu_torch.ops import rows_write as rw
    from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS, build_minibatch

    d = 64
    _, _, meta = build_minibatch(cfg, st_lazy.params, batch)
    arrays = table_tensors(st_lazy)
    writes, lib_args, exact, n_live = [], [], True, 0
    for name in SPARSE_TABLE_KEYS:  # one write-back a table: the table, mu and nu
        s, dup = meta[name]
        plan = rw.lane_block_plan(s, dup, 128 // d)
        dsts = [arrays[key].clone() for key in (name, f"mu.{name}", f"nu.{name}")]
        vals = [rw.merge_rows(plan, s, randn(s.numel(), d)) for _ in dsts]
        got = rw.rows_write_many([t.clone() for t in dsts], plan[0], plan[1], vals, d)
        for dst, v, g in zip(dsts, vals, got):
            exact &= torch.equal(g, rw.rows_write_reference(dst.clone(), plan[0], plan[1], v, d))
            exact &= torch.equal(rw.rows_write(dst.clone(), plan[0], plan[1], v, d), g)
        live = (plan[1] != 0).nonzero()[:, 0]
        m = ((plan[1][live][:, None] >> (torch.arange(128, device=dev) // d)) & 1).float()
        for dst, v in zip(dsts, vals):
            lib_args.append((dst, plan[0][live], dst[plan[0][live]] * (1 - m) + v[live] * m))
        n_live += 3 * live.numel()
        writes.append((dsts, plan[0], plan[1], vals))
    print(f"row write vs plain at the 4M-lazy write-back (2 tables x 3 arrays, {n_live} live "
          f"slots of {3 * sum(w[1].numel() for w in writes)}): exact={exact}", flush=True)
    two = lambda: [rw.rows_write_many(*w, d) for w in writes]
    six = lambda: [rw.rows_write(dst, pids, bits, v, d)
                   for dsts, pids, bits, vals in writes for dst, v in zip(dsts, vals)]
    entry(
        "rows_write", "two_tower_models_tpu_torch/csrc/rows_write.cu",
        "two_tower_models_tpu/ops/pallas/rows_write.py:150", exact, 0.0 if exact else float("nan"),
        time_ms(torch, two),
        time_ms(torch, lambda: [rw.rows_write_many_reference(*w, d) for w in writes], 3),
        # each live row read old and new and written, in 3 arrays; ids and bits once a table
        3 * n_live * 128 * 4 + sum(w[1].numel() * 12 for w in writes), 0, F32_FLOPS,
        None,
    )
    e19 = entries["rows_write"]
    e19["device_ms"] = call_device_ms(torch, two)
    e19["six_ms"] = time_ms(torch, six)
    e19["six_device_ms"] = call_device_ms(torch, six)
    e19["index_copy_ms"] = time_ms(torch, lambda: [t.index_copy_(0, i, v) for t, i, v in lib_args])
    e19["index_copy_device_ms"] = call_device_ms(
        torch, lambda: [t.index_copy_(0, i, v) for t, i, v in lib_args])
    e19["note"] = (
        "times are the write-backs of one 4M-lazy step: two rows_write_many launches (table, mu "
        "and nu of each table; ms with the host's dispatch, device_ms the kernels alone), six_* "
        "the six one-array launches; library_ms null: no one PyTorch call blends lanes and drops "
        "dead slots; index_copy_* copies the blended live rows (2/3 of the bytes, no blend)")
    print(f"row write: two launches {e19['ms']:.4f} ms (device {e19['device_ms']:.4f}); six "
          f"one-array launches {e19['six_ms']:.4f} (device {e19['six_device_ms']:.4f}); index_copy_ "
          f"of blended rows {e19['index_copy_ms']:.4f} (device {e19['index_copy_device_ms']:.4f}); "
          f"bound {e19['bound_ms']:.4f}", flush=True)


def phase_tables(torch, args, smi, dev, entry, entries, failures) -> None:
    """Phase 5: large tables, scripts/bench_tables.py's configuration."""
    import dataclasses

    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.nn.packed_table import is_packed
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import scatter_add as sa
    from two_tower_models_tpu_torch.training.data import gather_batch
    from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    b, d = TRAIN_BATCH, 64
    cfg = flagship_cfg(TABLE_ROWS)
    dense_cfg = TrainConfig(batch_size=b, learning_rate=1e-3, pack_tables_min_rows=PACK_MIN_ROWS)
    lazy_cfg = dataclasses.replace(dense_cfg, lazy_table_adam=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 5)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, b)
    idx = torch.arange(b, device=dev)
    batch = gather_batch(data, idx)
    # one seed, one set of weights: the dense and the lazy states
    st_dense = create_train_state(args.seed + 6, cfg, dense_cfg, device=dev)
    st_lazy = create_train_state(args.seed + 6, cfg, lazy_cfg, device=dev)
    if not all(is_packed(getattr(st.params, n), d) for st in (st_dense, st_lazy)
               for n in SPARSE_TABLE_KEYS):
        failures.append("tables of 2^22 rows not packed")

    # -- 5a: B18 at the lookups of the packed and the 1M legs --
    lookups = {"user": batch.user_id.reshape(-1), "item": batch.item_id.reshape(-1),
               "history": batch.user_history.reshape(-1)}
    cot = {k: randn(ids.numel(), d) for k, ids in lookups.items()}
    errs, oks = [], []
    for rows in (TABLE_ROWS, TABLE_ROWS_1M):
        for k, ids in lookups.items():
            got = sa.rows_scatter_add(ids % rows, cot[k], rows)
            ok, err = close(got, sa.rows_scatter_add_reference(ids % rows, cot[k], rows), 1e-5, 1e-6)
            oks.append(ok)
            errs.append(err)
            del got
    # the variable-length cell's history stream: id 0 past each length,
    # about half of the ids; rows of small integers, whose sums are exact
    n_var = b * HIST
    lens = torch.randint(1, HIST + 1, (b,), generator=gen, device=dev)
    skew = torch.randint(0, TRAIN_ROWS, (b, HIST), generator=gen, device=dev)
    skew = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], skew, 0).reshape(-1)
    grid = torch.randint(-2, 3, (n_var, d), generator=gen, device=dev).float()
    got = sa.rows_scatter_add(skew, grid, TRAIN_ROWS)
    exact = torch.equal(got, sa.rows_scatter_add_reference(skew, grid, TRAIN_ROWS))
    repeat = torch.equal(got, sa.rows_scatter_add(skew, grid, TRAIN_ROWS))
    print(f"scatter-add vs plain at the legs' lookups: max_abs_err {max(errs):.3g} (rtol 1e-5, "
          f"atol 1e-6); skewed stream (id 0 {float((skew == 0).float().mean()):.3f} of "
          f"{n_var}): exact={exact}, bit-equal on repeat={repeat}", flush=True)
    emb_bwd = lambda g, ids, rows: torch.ops.aten.embedding_dense_backward(g, ids, rows, -1, False)
    entry(
        "rows_scatter_add", "two_tower_models_tpu_torch/csrc/scatter_add.cu",
        "two_tower_models_tpu/ops/pallas/scatter_add.py:130", all(oks) and exact and repeat,
        max(errs),
        time_ms(torch, lambda: [sa.rows_scatter_add(i, cot[k], TABLE_ROWS) for k, i in lookups.items()]),
        time_ms(torch, lambda: [sa.rows_scatter_add_reference(i, cot[k], TABLE_ROWS)
                                for k, i in lookups.items()], 3),
        sum(TABLE_ROWS * d * 4 + i.numel() * (d * 4 + 8) for i in lookups.values()),
        sum(i.numel() * d for i in lookups.values()), F32_FLOPS,
        time_ms(torch, lambda: [emb_bwd(cot[k], i, TABLE_ROWS) for k, i in lookups.items()], 3),
    )
    ms_1m = time_ms(torch, lambda: [sa.rows_scatter_add(i % TABLE_ROWS_1M, cot[k], TABLE_ROWS_1M)
                                    for k, i in lookups.items()])
    sort_ms = time_ms(torch, lambda: sa.sort_stream(lookups["history"], TABLE_ROWS))
    # the kernel alone (chunk and fill launches) on streams sorted beforehand
    streams = {k: sa.sort_stream(i, TABLE_ROWS) for k, i in lookups.items()}
    kernel_ms = time_ms(torch, lambda: [sa.scatter_sorted(*streams[k], cot[k], TABLE_ROWS)
                                        for k in lookups])
    del streams
    print(f"scatter-add: the three lookups of a 1M-plain step {ms_1m:.4f} ms; the stable sort "
          f"of the history lookup's {lookups['history'].numel()} ids alone {sort_ms:.4f} ms; "
          f"the 4M-packed step's three launches alone on sorted streams {kernel_ms:.4f} ms "
          f"(bound {entries['rows_scatter_add']['bound_ms']:.4f} ms, the wrapper "
          f"{entries['rows_scatter_add']['ms']:.4f} ms)", flush=True)
    entries["rows_scatter_add"]["ms_1m_plain"] = ms_1m
    entries["rows_scatter_add"]["history_sort_ms"] = sort_ms
    entries["rows_scatter_add"]["kernel_ms"] = kernel_ms
    entries["rows_scatter_add"]["note"] = (
        "times are the three lookups of one 4M-packed step (user, item, history), the "
        "wrapper's stable sort included; kernel_ms is the chunk and fill launches alone "
        "on streams sorted beforehand; plain_ms is zeros + index_add_, library_ms "
        "aten.embedding_dense_backward")

    # B18 against F.embedding's gradient, over table sizes at the legs' N
    n_win = b * HIST + b  # the 4M-lazy item minitable: history and item ids
    window = {}
    for rows in WINDOW_ROWS:
        ids = torch.randint(0, rows, (n_win,), generator=gen, device=dev)
        g = randn(n_win, d)
        window[str(rows)] = {
            "b18_ms": time_ms(torch, lambda: sa.rows_scatter_add(ids, g, rows)),
            "embedding_backward_ms": time_ms(torch, lambda: emb_bwd(g, ids, rows)),
            "index_add_ms": time_ms(torch, lambda: sa.rows_scatter_add_reference(ids, g, rows)),
        }
    window["skewed"] = {
        "b18_ms": time_ms(torch, lambda: sa.rows_scatter_add(skew, grid, TRAIN_ROWS)),
        "embedding_backward_ms": time_ms(torch, lambda: emb_bwd(grid, skew, TRAIN_ROWS)),
        "index_add_ms": time_ms(torch, lambda: sa.rows_scatter_add_reference(skew, grid, TRAIN_ROWS)),
    }
    entries["rows_scatter_add"]["window_ms"] = window
    print(f"scatter-add window on {torch.cuda.get_device_name(0)} ({smi}), N={n_win} uniform "
          f"ids (skewed: N={n_var}, V={TRAIN_ROWS}), D={d}: {json.dumps(window)}", flush=True)
    del cot, got, grid
    torch.cuda.empty_cache()

    # -- 5a: B19 at the 4M-lazy write-back, on the step's own ids --
    row_write_check(torch, cfg, st_lazy, batch, randn, dev, entry, entries)
    torch.cuda.empty_cache()

    # -- first lazy step against the first dense step, from zero moments --
    step_dense, step_lazy = make_train_step(cfg, dense_cfg), make_train_step(cfg, lazy_cfg)
    with torch.enable_grad():
        st_dense, _ = step_dense(st_dense, data, idx)
        st_lazy, _ = step_lazy(st_lazy, data, idx)
    got, want = table_tensors(st_lazy), table_tensors(st_dense)
    got.update((n, p.detach()) for n, p in st_lazy.params.named_parameters())
    want.update((n, p.detach()) for n, p in st_dense.params.named_parameters())
    worst, bad = 0.0, []
    for name in want:
        ok, err = close(got[name], want[name], 1e-5, 1e-7)
        worst = max(worst, err)
        if not ok:
            bad.append(name)
    print(f"tables 4M: first lazy step vs first dense step, every parameter and table moment: "
          f"max_abs_err {worst:.3g} (rtol 1e-5, atol 1e-7); mismatched {bad}", flush=True)
    if bad:
        failures.append(f"first lazy step vs dense: {bad}")
    del got, want

    # -- 5b, 5c: the two 4M legs --
    five = {"fused_history_encoder_res": 1, "fused_history_encoder_bwd": 1, "fused_in_batch_ce": 1,
            "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1, **ENC_TC,
            "fused_history_encoder_res_tc": 1, "fused_history_encoder_bwd_tc": 1}
    st_dense, ms_packed, counts = table_leg(
        torch, "train-4M-packed", step_dense, st_dense, data, idx, 2,
        {**five, "rows_scatter_add": 3 + POS_B18, "rows_write": 0, "fused_adam": 0}, smi,
        failures)
    entries["rows_scatter_add"]["launches"] = counts.get("rows_scatter_add", 0)
    b18 = entries["rows_scatter_add"]["ms"]
    print(f"train-4M-packed: B18's three table launches alone {b18:.3f} ms ({b18 / ms_packed * 100:.1f}% "
          f"of the step)", flush=True)
    route_check(torch, "train-4M-packed", step_dense, st_dense, data, idx, failures)
    del st_dense
    torch.cuda.empty_cache()
    st_lazy, ms_lazy, counts = table_leg(
        torch, "train-4M-lazy", step_lazy, st_lazy, data, idx, 2,
        {**five, "rows_scatter_add": POS_B18, "rows_write": 2}, smi, failures)
    entries["rows_write"]["launches"] = counts.get("rows_write", 0)
    b19 = entries["rows_write"]["device_ms"]
    print(f"train-4M-lazy: B19's two launches alone {b19:.3f} ms of device time "
          f"({b19 / ms_lazy * 100:.1f}% of the step)", flush=True)
    route_check(torch, "train-4M-lazy", step_lazy, st_lazy, data, idx, failures)
    del st_lazy
    torch.cuda.empty_cache()

    # -- 5d: 1M rows, plain storage, B18 inside the window --
    cfg1 = flagship_cfg(TABLE_ROWS_1M)
    st = create_train_state(args.seed + 7, cfg1, dense_cfg, device=dev)
    if any(is_packed(getattr(st.params, n), d) for n in SPARSE_TABLE_KEYS):
        failures.append("tables of 2^20 rows packed")
    data1 = fixed_batch(torch, gen, dev, cfg1, b)
    step1 = make_train_step(cfg1, dense_cfg)
    st, ms_1m_step, counts = table_leg(torch, "train-1M-plain", step1, st, data1, idx, 3,
                              {**five, "rows_scatter_add": 3 + POS_B18, "rows_write": 0}, smi,
                              failures)
    entries["rows_scatter_add"]["launches_1m_plain"] = counts.get("rows_scatter_add", 0)
    print(f"train-1M-plain: B18's three table launches alone {ms_1m:.3f} ms ({ms_1m / ms_1m_step * 100:.1f}% "
          f"of the step)", flush=True)
    route_check(torch, "train-1M-plain", step1, st, data1, idx, failures)
    del st
    torch.cuda.empty_cache()

    # -- card against CPU at the window's lower edge, packed --
    cfg_c = flagship_cfg(CHECK_ROWS)
    st = create_train_state(args.seed + 8, cfg_c, dataclasses.replace(
        dense_cfg, pack_tables_min_rows=CHECK_ROWS), device=dev)
    if not is_packed(st.params.item_id_table, d):
        failures.append("tables of 2^18 rows not packed at pack_tables_min_rows 2^18")
    before = _lib.launches["rows_scatter_add"]
    grads_vs_cpu(torch, st.params, cfg_c, fixed_batch(torch, gen, dev, cfg_c, b), idx,
                 failures, "tables 2^18 packed")
    if _lib.launches["rows_scatter_add"] - before != 3 + POS_B18:
        failures.append("tables 2^18 packed: B18 not launched once a table and once for the "
                        "position table on the card")
    del st
    torch.cuda.empty_cache()
    return ms_packed

def layer_flops(h: int, n: int, d: int) -> int:
    """Operations of one attention layer on one example of h rows of which
    the first n are valid keys: q and the output projection for every row,
    k and v for the valid rows, scores and P.V over the valid keys (the
    other keys' scores are masked and need not be computed)."""
    return 2 * h * d * d + 4 * n * d * d + 4 * h * n * d + 2 * h * d * d


def layer_vjp_flops(h: int, d: int) -> int:
    """What B14 must do on one example of h rows (all keys valid): the
    forward less its output projection (6hd^2 + 4h^2d), then dW_out and do
    (2hd^2 each), dp, dv, dq and dk (2h^2d each), dW_in and dx (6hd^2 each)."""
    return 6 * h * d * d + 4 * h * h * d + 16 * h * d * d + 8 * h * h * d


def layer_cfg(cfg):
    """``cfg`` with its history encoder on the per-layer tier."""
    import dataclasses

    return dataclasses.replace(cfg, history_encoder=dataclasses.replace(
        cfg.history_encoder, fused_kernel=True, fused_encoder=False))


def layer_input(torch, model, hist, lens):
    """Layer 0's input on the per-layer tier, in bf16: the embedded history
    plus the PE (zeroed and with the PE at each length under ``lens``)."""
    from two_tower_models_tpu_torch.models.history_encoder import (
        sinusoidal_positional_encoding,
    )

    if lens is not None:
        return stack_input(torch, model, hist, lens).to(torch.bfloat16)
    emb = model.item_id_table.detach()[hist]
    return (emb + sinusoidal_positional_encoding(HIST, emb.shape[-1], emb.device)).to(torch.bfloat16)


def mha_library(torch, x, lens, w, nh):
    """One PyTorch call computing the layer (``F.multi_head_attention_forward``,
    bf16, keys past each length masked), seq-first, and its inputs."""
    F = torch.nn.functional
    xs = x.transpose(0, 1).contiguous()
    wb = [w[0].T.contiguous().bfloat16(), w[1].bfloat16(), w[2].T.contiguous().bfloat16(),
          w[3].bfloat16()]
    kpm = None if lens is None else (
        torch.arange(x.shape[1], device=x.device)[None, :] >= lens[:, None])
    return lambda xq, ws: F.multi_head_attention_forward(
        xq, xq, xq, x.shape[2], nh, ws[0], ws[1], None, None, False, 0.0, ws[2], ws[3],
        training=False, key_padding_mask=kpm, need_weights=False)[0], xs, wb


def layer_checks(torch, label, x, lens, g, w, nh):
    """B13 (and, with a cotangent ``g``, B14) against their plain versions
    on one layer's tensors, bf16 and f32: (ok, max_abs_err of the bf16
    outputs, a line of what was measured).  B13's tensor-core kernel sums
    in f32 in another order than the plain version, so a bf16 rounding
    upstream of y can flip: y is held as B14's dx is (at most 0.5% of the
    values beyond one bf16 step, all within 1e-2 of scale), and against the
    layer with f64 sums it may have at most 1.5 times as many values beyond
    one step as the plain version has.  The FMA kernel sums in the plain
    version's order: within one step.  B14 (the tensor-core kernel for
    bf16) and its FMA kernel, launched through its launcher on the same
    inputs: dx as above, the weight grads within 3e-3 of scale; the
    tensor-core kernel's dx no more values beyond one step from the
    backward with f64 sums than 1.5 times the plain version's, each weight
    grad's RMS error from f64 sums at most 1.5 times the plain version's
    (or 1e-6 of scale), and bit-equal on repeat."""
    from two_tower_models_tpu_torch.ops import fused_mha as fm

    y, plain = fm.fused_mha_fwd(x, lens, *w, nh), fm.fused_mha_layer_plain(x, lens, *w, nh)
    route = fm._fwd_route(x.dtype, *x.shape[1:], nh)
    steps, far = bf16_ulps(torch, y, plain), bf16_far(torch, y, plain)
    ok_y, err = scaled_close(y, plain, 1e-2)
    ref = fm.fused_mha_layer_f64_sums(x, lens, *w, nh)
    far64 = [bf16_far(torch, t, ref) for t in (y, plain)]
    rep13 = torch.equal(y, fm.fused_mha_fwd(x, lens, *w, nh))
    fma_steps = bf16_ulps(torch, fm._launch_fwd_fma(*fm._fwd_inputs(x, lens, *w), nh), plain)
    ok32, _ = scaled_close(fm.fused_mha_fwd(x.float(), lens, *w, nh),
                           fm.fused_mha_layer_plain(x.float(), lens, *w, nh), 1e-4)
    ok = (route == "tc" and ok_y and far <= 5e-3 * y.numel() and far64[0] <= 1.5 * far64[1]
          and rep13 and 0 <= fma_steps <= 1 and ok32)
    line = (f"{label}: B13 bf16 ({route} route) vs plain: {far} of {y.numel()} values beyond "
            f"one bf16 step (tol 0.5%), most {steps} steps, max_abs_err {err:.3g} (tol 1e-2 of "
            f"scale); beyond one step from f64 sums: kernel {far64[0]}, plain {far64[1]} (tol "
            f"1.5x); bit-equal on repeat={rep13}; the FMA kernel {fma_steps} steps from plain; "
            f"f32 ok={ok32} (tol 1e-4 of scale)")
    if g is not None:
        got = fm.fused_mha_bwd(g, x, lens, *w, nh)
        want = fm.fused_mha_layer_bwd_plain(g, x, lens, *w, nh)
        again = fm.fused_mha_bwd(g, x, lens, *w, nh)
        route = fm._bwd_route(x.dtype, *x.shape[1:], nh)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        d = x.shape[2]
        dx_fma, flat = fm._launch_bwd_fma(*fm._bwd_inputs(g, x, lens, *w[:3]), nh)
        fma = (dx_fma, *(t.view_as(e) for t, e in zip(
            torch.split(flat, [d * 3 * d, 3 * d, d * d, d]), want[1:])))
        line += f"; B14 ({route} route)"
        for tag, t in (("", got), ("the FMA kernel ", fma)):
            far = bf16_far(torch, t[0], want[0]) / t[0].numel()
            ok_dx, err_dx = scaled_close(t[0], want[0], 1e-2)
            grads = [scaled_close(a, e, 3e-3) for a, e in zip(t[1:], want[1:])]
            ok = ok and ok_dx and far <= 5e-3 and all(k for k, _ in grads)
            line += (f"; {tag}dx: {far:.2e} of values beyond one bf16 step (tol 5e-3), "
                     f"max_abs_err {err_dx:.3g} (tol 1e-2 of scale); weight grads max_abs_err "
                     f"{[float(f'{e:.3g}') for _, e in grads]} (tol 3e-3 of scale)")
            if not tag:
                err = err_dx  # the entry's max_abs_err: B14's dx
        # against the backward with f64 sums: dx values beyond one bf16 step,
        # each weight grad's RMS error relative to its scale
        ref = fm.fused_mha_layer_bwd_f64_sums(g, x, lens, *w, nh)
        far64 = [bf16_far(torch, t[0], ref[0]) for t in (got, want)]
        rms = [[float((a.double() - e).pow(2).mean().sqrt() / e.abs().max())
                for a, e in zip(t[1:], ref[1:])] for t in (got, want)]
        ok64 = far64[0] <= 1.5 * far64[1] and all(
            k <= max(1.5 * p, 1e-6) for k, p in zip(*rms))
        ok32 = all(scaled_close(a, e, 1e-4)[0] for a, e in zip(
            fm.fused_mha_bwd(g.float(), x.float(), lens, *w, nh),
            fm.fused_mha_layer_bwd_plain(g.float(), x.float(), lens, *w, nh)))
        ok = ok and route == "tc" and repeat and ok64 and ok32
        line += (f"; beyond one step from f64 sums: kernel {far64[0]}, plain {far64[1]} (tol "
                 f"1.5x); weight grads' RMS error from f64 sums (of scale) kernel "
                 f"{[float(f'{v:.3g}') for v in rms[0]]}, plain "
                 f"{[float(f'{v:.3g}') for v in rms[1]]} (tol 1.5x or 1e-6); f32 ok={ok32} "
                 f"(tol 1e-4 of scale); bit-equal on repeat={repeat}")
    print(line, flush=True)
    return ok, err


def phase_layer(torch, args, smi, dev, entry, entries, failures, b56_ms, b14_ptxas) -> None:
    """Phase 6: the per-layer attention tier (HistoryEncoderConfig with
    fused_kernel=True, fused_encoder=False) at the cells' full width;
    ``b14_ptxas`` is phase 1's report of B14's tensor-core instance there."""
    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import fused_mha as fm
    from two_tower_models_tpu_torch.serving import RetrievalEngine
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    nh, nl, d, b = 4, 3, 64, BATCH
    src = "two_tower_models_tpu_torch/csrc/fused_mha.cu"
    w_layer = lambda model: [getattr(getattr(model.history_encoder.attn_layers[0], p), a).detach()
                             for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"),
                                          ("out_proj", "b"))]
    w_bytes = (4 * d * d + 4 * d) * 4

    # -- 6a, 6b: serving.  phase 3's configuration and seed on the per-layer tier
    cfg = layer_cfg(serve_cfg())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = tt.init_params(gen, cfg, device=dev)
    catalog_ids = torch.arange(CORPUS, device=dev)
    catalog_feats = torch.randn(CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, catalog_ids, catalog_feats, device=dev)
    engine.warmup(BATCH)
    batches = [(torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                torch.randn(b, 16, generator=gen, device=dev),
                torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev), None)
               for _ in range(args.batches)]
    engine.warmup(BATCH, variable_history=True)
    var_batches = []
    for _ in range(args.batches):
        lens = torch.randint(1, HIST + 1, (b,), generator=gen, device=dev)
        hist = torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev)
        hist = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], hist, 0)
        var_batches.append((torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                            torch.randn(b, 16, generator=gen, device=dev), hist, lens))
    w = w_layer(model)
    x = layer_input(torch, model, batches[0][2], None)
    ok, err = layer_checks(torch, "layer serve", x, None, None, w, nh)
    lens = var_batches[0][3]
    xv = layer_input(torch, model, var_batches[0][2], lens)
    ok_v, err_v = layer_checks(torch, "layer serve varlen", xv, lens, None, w, nh)
    lib, xs, wb = mha_library(torch, x, None, w, nh)
    lib_v, xs_v, _ = mha_library(torch, xv, lens, w, nh)
    entry(
        "fused_mha_fwd", src, "two_tower_models_tpu/ops/pallas/fused_mha.py:297", ok and ok_v,
        max(err, err_v),
        time_ms(torch, lambda: fm.fused_mha_fwd(x, None, *w, nh)),
        time_ms(torch, lambda: fm.fused_mha_layer_plain(x, None, *w, nh)),
        2 * b * HIST * d * 2 + w_bytes, b * layer_flops(HIST, HIST, d), BF16_FLOPS,
        time_ms(torch, lambda: lib(xs, wb)),
    )
    e13 = entries["fused_mha_fwd"]
    fma = lambda xx, ll: fm._launch_fwd_fma(*fm._fwd_inputs(xx, ll, *w), nh)
    e13["kernel_route"] = fm._fwd_route(x.dtype, HIST, d, nh)
    e13["fma_ms"] = time_ms(torch, lambda: fma(x, None))
    e13["fma_varlen_ms"] = time_ms(torch, lambda: fma(xv, lens))
    e13["varlen_ms"] = time_ms(torch, lambda: fm.fused_mha_fwd(xv, lens, *w, nh))
    e13["varlen_plain_ms"] = time_ms(torch, lambda: fm.fused_mha_layer_plain(xv, lens, *w, nh))
    e13["varlen_bound_ms"] = bound(2 * b * HIST * d * 2 + w_bytes + b * 4, sum(
        layer_flops(HIST, n, d) for n in lens.tolist()), BF16_FLOPS)[0]
    e13["varlen_library_ms"] = time_ms(torch, lambda: lib_v(xs_v, wb))
    for key, xx, ll in (("", x, None), ("varlen_", xv, lens)):
        e13[f"{key}device_ms"] = device_ms(torch, lambda: fm.fused_mha_fwd(xx, ll, *w, nh),
                                           "mha_fwd_tc_kernel")
        e13[f"fma_{key}device_ms"] = device_ms(torch, lambda: fma(xx, ll), "mha_fwd_kernel")
    print(f"B13 at B={b} on {torch.cuda.get_device_name(0)} ({smi}): route {e13['kernel_route']} "
          f"{e13['ms']:.4f} ms, with lengths {e13['varlen_ms']:.4f} (device time "
          f"{e13['device_ms']:.4f}, {e13['varlen_device_ms']:.4f}); the FMA kernel "
          f"{e13['fma_ms']:.4f}, {e13['fma_varlen_ms']:.4f} (device {e13['fma_device_ms']:.4f}, "
          f"{e13['fma_varlen_device_ms']:.4f}); library {e13['library_ms']:.4f}, "
          f"{e13['varlen_library_ms']:.4f}; bound {e13['bound_ms']:.4f}, "
          f"{e13['varlen_bound_ms']:.4f}", flush=True)
    del xs, xs_v
    cpu_model = copy.deepcopy(model).cpu()
    others = {"fused_history_encoder": 0, "fused_attn_stack": 0, **MIPS_ROUTE, **ENC_TC}
    legs = {}
    for label, bts in (("serve-1M-exact-layer", batches), ("serve-1M-exact-layer-varlen", var_batches)):
        counts, legs[label] = serve_leg(torch, label, engine, model, cpu_model, cfg, bts,
                                        {"fused_mha_fwd": nl, "fused_mha_fwd_tc": nl, **others},
                                        [], entries, failures, smi)
        e13[f"launches_{label}"] = counts.get("fused_mha_fwd", 0)
        e13[f"launches_tc_{label}"] = counts.get("fused_mha_fwd_tc", 0)
    e13["launches"] = e13["launches_serve-1M-exact-layer"]
    del engine, model, cpu_model, batches, var_batches, catalog_feats
    torch.cuda.empty_cache()

    # -- 6a, 6c: training.  phase 4's configuration on the per-layer tier
    cfg = layer_cfg(flagship_cfg(TRAIN_ROWS))
    bt = TRAIN_BATCH
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen.manual_seed(args.seed + 9)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, bt)
    idx = torch.arange(bt, device=dev)
    w = w_layer(state.params)
    x = layer_input(torch, state.params, gather_batch(data, idx).user_history, None)
    g = (torch.randn(bt, HIST, d, generator=gen, device=dev) / bt).to(torch.bfloat16)
    ok, err = layer_checks(torch, "layer train", x, None, g, w, nh)
    lib, xs, wb = mha_library(torch, x, None, w, nh)
    with torch.enable_grad():
        xl = xs.detach().requires_grad_()
        wl = [t.detach().requires_grad_() for t in wb]
        out = lib(xl, wl)
        gl = g.transpose(0, 1).contiguous()
        lib_bwd = lambda: torch.autograd.grad(out, [xl, *wl], gl, retain_graph=True)
        lib_bwd_ms = time_ms(torch, lib_bwd)
    del out, xl, wl
    grads_bytes = (4 * d * d + 4 * d) * 4
    e13["train_ms"] = time_ms(torch, lambda: fm.fused_mha_fwd(x, None, *w, nh))
    e13["train_plain_ms"] = time_ms(torch, lambda: fm.fused_mha_layer_plain(x, None, *w, nh))
    e13["train_bound_ms"] = bound(2 * bt * HIST * d * 2 + w_bytes,
                                  bt * layer_flops(HIST, HIST, d), BF16_FLOPS)[0]
    e13["train_library_ms"] = time_ms(torch, lambda: lib(xs, wb))
    e13["train_fma_ms"] = time_ms(torch, lambda: fma(x, None))
    e13["train_device_ms"] = device_ms(torch, lambda: fm.fused_mha_fwd(x, None, *w, nh),
                                       "mha_fwd_tc_kernel")
    e13["train_fma_device_ms"] = device_ms(torch, lambda: fma(x, None), "mha_fwd_kernel")
    print(f"B13 at B={bt} on {torch.cuda.get_device_name(0)} ({smi}): route "
          f"{fm._fwd_route(x.dtype, HIST, d, nh)} {e13['train_ms']:.4f} ms (device time "
          f"{e13['train_device_ms']:.4f}); the FMA kernel {e13['train_fma_ms']:.4f} (device "
          f"{e13['train_fma_device_ms']:.4f}); library {e13['train_library_ms']:.4f}; bound "
          f"{e13['train_bound_ms']:.4f}", flush=True)
    entry(
        "fused_mha_bwd", src, "two_tower_models_tpu/ops/pallas/fused_mha.py:369", ok, err,
        time_ms(torch, lambda: fm.fused_mha_bwd(g, x, None, *w, nh)),
        time_ms(torch, lambda: fm.fused_mha_layer_bwd_plain(g, x, None, *w, nh)),
        3 * bt * HIST * d * 2 + (4 * d * d + 3 * d) * 4 + grads_bytes,
        bt * layer_vjp_flops(HIST, d), BF16_FLOPS, lib_bwd_ms,
    )
    e14 = entries["fused_mha_bwd"]
    bwd = lambda: fm.fused_mha_bwd(g, x, None, *w, nh)
    fma14 = lambda: fm._launch_bwd_fma(*fm._bwd_inputs(g, x, None, *w[:3]), nh)
    e14["kernel_route"] = fm._bwd_route(x.dtype, HIST, d, nh)
    e14["device_ms"] = device_ms(torch, bwd, "mha_bwd_tc_kernel")
    e14["reduce_device_ms"] = device_ms(torch, bwd, "reduce_kernel")
    e14["fma_ms"] = time_ms(torch, fma14)
    e14["fma_device_ms"] = device_ms(torch, fma14, "mha_bwd_kernel")
    e14["ptxas"] = b14_ptxas
    e14["note"] = (
        "ms includes the second launch that sums the per-block weight grads and the host's "
        "dispatch; device_ms is mha_bwd_tc_kernel's launch alone and reduce_device_ms the "
        "reduce's (torch.profiler); fma_* the FMA kernel (mha_bwd_kernel) on the same inputs; "
        "library_ms is the autograd backward of F.multi_head_attention_forward (bf16)")
    print(f"B14 at B={bt} on {torch.cuda.get_device_name(0)} ({smi}): route {e14['kernel_route']} "
          f"{e14['ms']:.4f} ms (device time {e14['device_ms']:.4f}, its reduce "
          f"{e14['reduce_device_ms']:.4f}); the FMA kernel {e14['fma_ms']:.4f} (device "
          f"{e14['fma_device_ms']:.4f}); library {e14['library_ms']:.4f}; bound "
          f"{e14['bound_ms']:.4f} ({e14['bound_by']}); ptxas {b14_ptxas}", flush=True)
    e13["note"] = (
        "ms, plain_ms, bound_ms, library_ms at the serving batch (B=1024), varlen_* there "
        "with lengths (bound counting valid keys only), train_* at the training batch "
        "(B=4096); library_ms is F.multi_head_attention_forward (bf16); kernel_route is the kernel "
        "fused_mha_fwd takes there (tc: the tensor cores), *fma_ms the FMA kernel on the "
        "same inputs; *device_ms one launch's device time from torch.profiler")
    del xs, x, g
    torch.cuda.empty_cache()

    expect = {"fused_mha_fwd": nl, "fused_mha_fwd_tc": nl, "fused_mha_bwd": nl,
              "fused_mha_bwd_reduce": nl, "fused_mha_bwd_tc": nl,
              "fused_in_batch_ce": 1, "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1,
              "fused_history_encoder": 0, "fused_history_encoder_res": 0,
              "fused_history_encoder_bwd": 0, "fused_history_encoder_bwd_recompute": 0,
              "fused_attn_stack": 0, "fused_attn_stack_bwd": 0, "rows_scatter_add": POS_B18,
              "rows_write": 0, **ENC_TC}
    var_data = make_synthetic_data(DataConfig(
        num_samples=bt, num_users=TRAIN_ROWS, num_items=TRAIN_ROWS, feature_dim=16,
        history_len=HIST, num_tasks=3, max_position=cfg.position_table_size,
        seed=args.seed, variable_history=True,
    ), device=dev)
    step = make_train_step(cfg, train_cfg)
    for label, dat in (("train-65k-layer", data), ("train-65k-layer-varlen", var_data)):
        state, metrics, _, _, _ = run_steps(torch, step, state, dat, idx, 3)
        state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, dat, idx,
                                                           TRAIN_STEPS)
        metrics += timed
        legs[label] = ms_step
        print(f"launches on the {label} path ({TRAIN_STEPS} steps): {json.dumps(counts)}",
              flush=True)
        check_launches(counts, expect, TRAIN_STEPS, failures, label)
        for name in ("fused_mha_fwd", "fused_mha_bwd"):
            entries[name][f"launches_{label}"] = counts.get(name, 0)
        e13[f"launches_tc_{label}"] = counts.get("fused_mha_fwd_tc", 0)
        e14[f"launches_tc_{label}"] = counts.get("fused_mha_bwd_tc", 0)
        e14[f"reduce_launches_{label}"] = counts.get("fused_mha_bwd_reduce", 0)
        if not finite(torch, metrics):
            failures.append(f"{label} metrics not finite")
        kern = nl * (e13["train_ms"] + e14["ms"])
        print(
            f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of B={bt}: "
            f"ms/step {ms_step:.3f}, examples/s {bt / ms_step * 1e3:.0f}; host wall "
            f"{host_ms:.3f} ms/step; loss first {float(metrics[0]['loss']):.5f} last "
            f"{float(metrics[-1]['loss']):.5f}; three B13 and three B14 alone {kern:.3f} ms "
            f"({kern / ms_step * 100:.1f}% of the step)", flush=True)
        state, busy = trace_steps(torch, step, state, dat, idx, label)
        print(f"{label} step on {torch.cuda.get_device_name(0)} ({smi}): ms/step {ms_step:.3f}, "
              f"host wall {host_ms:.3f} ms/step, device busy "
              + (f"{busy:.3f} ms/step (the trace's three steps)" if busy else "not measured"),
              flush=True)
        e14[f"busy_ms_{label}"] = busy
        grads_vs_cpu(torch, state.params, cfg, dat, idx, failures, label)
    e14["launches"] = e14["launches_train-65k-layer"]
    print(f"per-layer tier on {torch.cuda.get_device_name(0)} ({smi}): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in legs.items())
          + f"; phase 4's B5+B6 step {b56_ms[0]:.3f}, {b56_ms[1]:.3f} ms: the per-layer step "
          f"{legs['train-65k-layer'] / b56_ms[0]:.2f}x", flush=True)
    return legs


def blockwise_cfg(cfg):
    """``cfg`` with its history encoder on the blockwise tier."""
    import dataclasses

    return dataclasses.replace(cfg, history_encoder=dataclasses.replace(
        cfg.history_encoder, blockwise_kernel=True, fused_encoder=False))


def folded_qkv(torch, model, hist, lens, nh, cd):
    """Layer 0's q, k, v on the blockwise tier as mha_apply hands them to
    blockwise_self_attention: the embedded history plus the PE (zeroed past
    each length, the PE at each length, under ``lens``), projected in the
    compute dtype to f32 and folded to [B * nh, H, hd], n = b * nh + head;
    and the lengths repeated per head."""
    from two_tower_models_tpu_torch.models.history_encoder import (
        sinusoidal_positional_encoding,
    )
    from two_tower_models_tpu_torch.nn.layers import linear_apply

    if lens is None:
        emb = model.item_id_table.detach()[hist]
        x = emb + sinusoidal_positional_encoding(hist.shape[1], emb.shape[-1], emb.device)
    else:
        x = stack_input(torch, model, hist, lens)
    b, h, d = x.shape
    qkv = linear_apply(model.history_encoder.attn_layers[0].in_proj, x, cd)
    fold = [t.reshape(b, h, nh, d // nh).transpose(1, 2).reshape(b * nh, h, d // nh).contiguous()
            for t in qkv.split(d, dim=-1)]
    return fold, None if lens is None else lens.repeat_interleave(nh).int()


def attn_counts(n, h, dh, lens):
    """(bytes of one [N, H, Dh] f32 tensor, bytes of one [N, H] one,
    multiply-adds of one [H, valid keys, Dh] product) for the blockwise
    kernels' bounds: B15 does two such products (q kᵀ and P·V), B16 three
    and B17 four, at two operations a multiply-add."""
    keys = n * h if lens is None else int(lens.sum())
    return n * h * dh * 4, n * h * 4, h * keys * dh


def attn_lib(torch, q, k, v, lens):
    """F.scaled_dot_product_attention in f32 with a boolean key mask: the
    one PyTorch call computing B15's output (a yardstick; the port never
    calls it)."""
    F = torch.nn.functional
    mask = None if lens is None else (
        torch.arange(q.shape[1], device=q.device)[None, None, :] < lens[:, None, None])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def attn_checks(torch, label, q, k, v, lens, g):
    """B15 on the tensor cores (twice: bit-equal) and on its FMA kernel,
    each forced by ``_route`` (and, with a cotangent ``g``, B16 and B17,
    twice) against their plain versions: out and lse within rtol 1e-4 and atol 1e-5 of each output's
    scale, the grads within 1e-4 of each one's scale or of one |do| |v|
    term; masked keys' dk and dv exactly 0.  Returns (ok, max_abs_err of
    out, of the grads)."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    n, h, _ = q.shape
    lk = torch.full((n,), h, dtype=torch.int32, device=q.device) if lens is None else lens
    out, lse = ha.blockwise_attn_fwd(q, k, v, lk, _route="tc")
    again = ha.blockwise_attn_fwd(q, k, v, lk, _route="tc")
    fma = ha.blockwise_attn_fwd(q, k, v, lk, _route="fma")
    want = ha.blockwise_attn_fwd_plain(q, k, v, lk)
    checks = [close(a, e, 1e-4, 1e-5 * float(e.abs().max())) for a, e in zip((out, lse), want)]
    fchecks = [close(a, e, 1e-4, 1e-5 * float(e.abs().max())) for a, e in zip(fma, want)]
    repeat15 = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ok = all(c for c, _ in checks + fchecks) and repeat15
    err, gerr = checks[0][1], 0.0
    line = (f"{label}: B15 (tensor cores) out, lse max_abs_err "
            f"{[float(f'{e:.3g}') for _, e in checks]}, bit-equal on repeat={repeat15}; its FMA "
            f"kernel {[float(f'{e:.3g}') for _, e in fchecks]} (tol 1e-4, 1e-5 of scale)")
    if g is not None:
        args = (q, k, v, g, want[1], (g * want[0]).sum(-1), lk)
        bok, gerr, bline = attn_bwd_checks(torch, args, ha.blockwise_attn_bwd_plain(*args))
        ok = ok and bok
        line += bline
    print(line + f"; ok={ok}", flush=True)
    return ok, err, gerr


def attn_bwd_checks(torch, args, plain, rows: int | None = None):
    """B16 and B17 on both kernels, each forced by ``_route`` and run
    twice (bit-equal), against ``plain`` (the plain backward of the leading
    indices below ``rows``, or of all): the grads within 1e-4 of each
    one's scale or of one |do| |v| term, masked keys' dk and dv exactly
    0.  Returns (ok, max_abs_err of the grads, the line's text)."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    q, g, v, lk = args[0], args[3], args[2], args[-1]
    n = q.shape[0] if rows is None else rows
    term = float(g[:n].abs().max() * v[:n].abs().max())
    masked = torch.arange(q.shape[1], device=q.device)[None, :] >= lk[:n, None]
    ok, gerr, text = True, 0.0, ""
    for route in ("tc", "fma"):
        runs = [(ha.blockwise_attn_dq(*args, _route=route),
                 *ha.blockwise_attn_dkv(*args, _route=route)) for _ in range(2)]
        repeat = all(torch.equal(a, b) for a, b in zip(*runs))
        checks = [close(a[:n], e, 0.0, 1e-4 * max(float(e.abs().max()), term))
                  for a, e in zip(runs[0], plain)]
        zero = bool((runs[0][1][:n][masked] == 0).all()) and bool((runs[0][2][:n][masked] == 0).all())
        ok = ok and repeat and zero and all(c for c, _ in checks)
        gerr = max([gerr] + [e for _, e in checks])
        text += (f"; B16, B17 ({'tensor cores' if route == 'tc' else 'FMA kernels'}) dq, dk, dv "
                 f"max_abs_err {[float(f'{e:.3g}') for _, e in checks]} (tol 1e-4 of scale); "
                 f"masked keys zero={zero}; bit-equal on repeat={repeat}")
    return ok, gerr, text


def attn_extreme(torch, dev) -> bool:
    """B15 on the tensor cores on the card tests' extreme input (64
    examples, H = 256, Dh = 16, q and k at 30 sigma: scores of some
    thousands, lengths in [1, 256]): finite, within rtol 1e-3, atol 1e-4 of
    the plain version (the JAX package's extreme-score tolerance), bit-equal
    on repeat."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q, k = (torch.randn(64, 256, 16, generator=gen, device=dev) * 30 for _ in range(2))
    v = torch.randn(64, 256, 16, generator=gen, device=dev)
    lens = torch.randint(1, 257, (64,), generator=gen, device=dev, dtype=torch.int32)
    runs = [ha.blockwise_attn_fwd(q, k, v, lens, _route="tc") for _ in range(2)]
    want = ha.blockwise_attn_fwd_plain(q, k, v, lens)
    checks = [close(a, e, 1e-3, 1e-4) for a, e in zip(runs[0], want)]
    repeat = all(torch.equal(a, b) for a, b in zip(*runs))
    finite_ = all(bool(t.isfinite().all()) for t in runs[0])
    ok = repeat and finite_ and all(c for c, _ in checks)
    print(f"blockwise extreme scores (q, k at 30 sigma, N=64, H=256): B15 out, lse max_abs_err "
          f"{[float(f'{e:.3g}') for _, e in checks]} (tol 1e-3, 1e-4); finite={finite_}; "
          f"bit-equal on repeat={repeat}; ok={ok}", flush=True)
    return ok


def b15_times(torch, smi, e, key, q, k, v, lens, ptxas: str) -> None:
    """B15 at one shape, into ``e`` under the prefix ``key``: the
    tensor-core kernel and the FMA kernel in the same call (``tc_*``,
    ``fma_*``), each by CUDA events and alone from torch.profiler
    (``*device_ms``), ``ms`` and ``device_ms`` the kernel the route takes
    there (``route``); the plain version and F.scaled_dot_product_attention;
    the bounds: bytes, f32 FMA on the CUDA cores (two products) and 3xTF32
    on the tensor cores (three times the operations at the TF32 rate),
    ``bound_ms`` the larger of bytes and the routed kernel's operations."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    n, h, dh = q.shape
    lk = torch.full((n,), h, dtype=torch.int32, device=q.device) if lens is None else lens
    row_b, lse_b, fl = attn_counts(n, h, dh, lens)
    nbytes = 4 * row_b + lse_b + (0 if lens is None else n * 4)
    slow = 3 if h > 1024 else 10
    route = ha._fwd_route(h)
    t = {"route": route}
    for name, kernel in (("tc", "attn_fwd_tc_kernel"), ("fma", "attn_fwd_kernel")):
        fn = lambda r=name: ha.blockwise_attn_fwd(q, k, v, lk, _route=r)  # noqa: E731
        t[f"{name}_ms"], t[f"{name}_device_ms"] = time_ms(torch, fn), device_ms(torch, fn, kernel)
    t["ms"], t["device_ms"] = t[f"{route}_ms"], t[f"{route}_device_ms"]
    t.update({"plain_ms": time_ms(torch, lambda: ha.blockwise_attn_fwd_plain(q, k, v, lk), slow),
              "library_ms": time_ms(torch, attn_lib(torch, q, k, v, lens), slow),
              "bytes_bound_ms": nbytes / HBM_BPS * 1e3, "f32_bound_ms": 4 * fl / F32_FLOPS * 1e3,
              "tf32_bound_ms": 12 * fl / TF32_FLOPS * 1e3})
    t["bound_ms"], t["bound_by"] = (bound(nbytes, 12 * fl, TF32_FLOPS) if route == "tc"
                                    else bound(nbytes, 4 * fl, F32_FLOPS))
    e.update({key + name: val for name, val in t.items()})
    print(f"B15 at N={n}, H={h}, Dh={dh}{'' if lens is None else ' with lengths'} on "
          f"{torch.cuda.get_device_name(0)} ({smi}): route {route}; tensor cores "
          f"{t['tc_ms']:.4f} ms (device {t['tc_device_ms']:.4f}), the FMA kernel "
          f"{t['fma_ms']:.4f} (device {t['fma_device_ms']:.4f}); plain {t['plain_ms']:.4f}; "
          f"library {t['library_ms']:.4f}; bounds: bytes {t['bytes_bound_ms']:.4f}, f32 FMA "
          f"{t['f32_bound_ms']:.4f}, 3xTF32 {t['tf32_bound_ms']:.4f} (the routed kernel at "
          f"{t['bound_ms'] / max(t['device_ms'], 1e-9):.1%} of its bound); ptxas {ptxas}",
          flush=True)


def attn_bwd_times(torch, smi, entries, key, bargs, lens, ptxas: dict, plain: bool = True) -> None:
    """B16 and B17 at one shape (``bargs``: q, k, v, do, lse, delta and
    the lengths), into entries["blockwise_attn_dq"] and
    ["blockwise_attn_dkv"] under the prefix ``key``: both kernels forced
    (``tc_*``: attn_bwd_tc_kernel, ``fma_*``: attn_dq_kernel and
    attn_dkv_kernel), each by CUDA events and alone from torch.profiler
    (``*device_ms``), ``ms`` and ``device_ms`` the kernel the route takes
    there (``route``); the plain backward and the autograd backward of
    F.scaled_dot_product_attention, for both together (``plain`` False
    leaves them out: at N = 1024, H = 4096 their [N, H, H] tensors would
    take 64 GiB); the bounds: bytes, f32 FMA on the CUDA cores (three
    products in B16, four in B17) and 3xTF32 on the tensor cores (three
    times the operations at the TF32 rate), ``bound_ms`` the larger of
    bytes and the routed kernel's operations; ``ptxas`` phase 1's lines of
    the tensor-core instances by kernel."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    q, _, _, g = bargs[:4]
    n, h, dh = q.shape
    row_b, lse_b, fl = attn_counts(n, h, dh, lens)
    slow = 3 if h > 1024 else 10
    route = ha._bwd_route(h)
    shared = {"plain_ms": None, "library_ms": None}
    if plain:
        shared["plain_ms"] = time_ms(torch, lambda: ha.blockwise_attn_bwd_plain(*bargs), slow)
        with torch.enable_grad():
            leaves = [t.clone().requires_grad_() for t in bargs[:3]]
            lib_out = attn_lib(torch, *leaves, lens)()
            shared["library_ms"] = time_ms(
                torch, lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True), slow)
        del lib_out, leaves
    for name, fn, kernels, rows, products in (
        ("blockwise_attn_dq", ha.blockwise_attn_dq, ("attn_bwd_tc_kernel<0", "attn_dq_kernel"),
         5, 3),
        ("blockwise_attn_dkv", ha.blockwise_attn_dkv, ("attn_bwd_tc_kernel<1", "attn_dkv_kernel"),
         6, 4),
    ):
        t = {"route": route, **shared}
        for r, kernel in zip(("tc", "fma"), kernels):
            call = lambda r=r: fn(*bargs, _route=r)  # noqa: E731
            t[f"{r}_ms"] = time_ms(torch, call)
            t[f"{r}_device_ms"] = device_ms(torch, call, kernel, 10 if h > 1024 else 20)
        t["ms"], t["device_ms"] = t[f"{route}_ms"], t[f"{route}_device_ms"]
        nbytes = rows * row_b + 2 * lse_b + (0 if lens is None else n * 4)
        t.update({"bytes_bound_ms": nbytes / HBM_BPS * 1e3,
                  "f32_bound_ms": 2 * products * fl / F32_FLOPS * 1e3,
                  "tf32_bound_ms": 6 * products * fl / TF32_FLOPS * 1e3})
        t["bound_ms"], t["bound_by"] = (bound(nbytes, 6 * products * fl, TF32_FLOPS) if route == "tc"
                                        else bound(nbytes, 2 * products * fl, F32_FLOPS))
        entries[name].update({key + k_: v_ for k_, v_ in t.items()})
        tag = "B16" if name == "blockwise_attn_dq" else "B17"
        print(f"{tag} at N={n}, H={h}, Dh={dh}{'' if lens is None else ' with lengths'} on "
              f"{torch.cuda.get_device_name(0)} ({smi}): route {route}; tensor cores "
              f"{t['tc_ms']:.4f} ms (device {t['tc_device_ms']:.4f}), the FMA kernel "
              f"{t['fma_ms']:.4f} (device {t['fma_device_ms']:.4f}); plain (dq, dk, dv) "
              f"{t['plain_ms'] if plain else 'not measured'}; library (B16 + B17) "
              f"{t['library_ms'] if plain else 'not measured'}; bounds: bytes "
              f"{t['bytes_bound_ms']:.4f}, f32 FMA {t['f32_bound_ms']:.4f}, 3xTF32 "
              f"{t['tf32_bound_ms']:.4f} (the routed kernel at "
              f"{t['bound_ms'] / max(t['device_ms'], 1e-9):.1%} of its bound); ptxas "
              f"{ptxas.get(tag, '')}", flush=True)


def attn_memory(torch, q, k, v, lens, g):
    """Peak device memory above the inputs of forward + backward through
    autograd: the blockwise tier (B15, B16, B17) and the plain dense
    version ([N, H, H] scores and probabilities kept for the backward)."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    peaks = []
    for fn in (lambda a, b, c: ha.blockwise_self_attention(a, b, c, lengths=lens),
               lambda a, b, c: ha.blockwise_attn_fwd_plain(a, b, c, lens)[0]):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.enable_grad():
            torch.autograd.grad(fn(*leaves), leaves, g)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del leaves
    return peaks


def phase_blockwise(torch, args, smi, dev, entry, entries, failures, b56_ms, layer_legs,
                    b15_ptxas, bwd_ptxas) -> None:
    """Phase 7: the blockwise attention tier (HistoryEncoderConfig with
    blockwise_kernel=True, fused_encoder=False) at the cells' full width,
    the long-history leg of its kernels and the long-history training leg
    (7d); ``b15_ptxas`` is phase 1's report of B15's tensor-core instances
    by plan, ``bwd_ptxas`` of B16's and B17's at Dh = 16 by kernel."""
    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import history_attention as ha
    from two_tower_models_tpu_torch.serving import RetrievalEngine
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    nh, nl, d, b = 4, 3, 64, BATCH
    dh = d // nh
    src = "two_tower_models_tpu_torch/csrc/history_attention.cu"
    rep = "two_tower_models_tpu/ops/pallas/history_attention.py:"
    cd = torch.bfloat16

    # -- 7a, 7b: serving.  phase 3's configuration and seed on the blockwise tier
    cfg = blockwise_cfg(serve_cfg())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = tt.init_params(gen, cfg, device=dev)
    catalog_ids = torch.arange(CORPUS, device=dev)
    catalog_feats = torch.randn(CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, catalog_ids, catalog_feats, device=dev)
    engine.warmup(BATCH)
    batches = [(torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                torch.randn(b, 16, generator=gen, device=dev),
                torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev), None)
               for _ in range(args.batches)]
    engine.warmup(BATCH, variable_history=True)
    var_batches = []
    for _ in range(args.batches):
        lens = torch.randint(1, HIST + 1, (b,), generator=gen, device=dev)
        hist = torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev)
        hist = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], hist, 0)
        var_batches.append((torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                            torch.randn(b, 16, generator=gen, device=dev), hist, lens))
    (q, k, v), _ = folded_qkv(torch, model, batches[0][2], None, nh, cd)
    (qv, kv, vv), lv = folded_qkv(torch, model, var_batches[0][2], var_batches[0][3], nh, cd)
    ok, err, _ = attn_checks(torch, "blockwise serve", q, k, v, None, None)
    ok_v, err_v, _ = attn_checks(torch, "blockwise serve varlen", qv, kv, vv, lv, None)
    ok_x = attn_extreme(torch, dev)
    full = torch.full((q.shape[0],), HIST, dtype=torch.int32, device=dev)
    row_b, lse_b, fl = attn_counts(q.shape[0], HIST, dh, None)
    entry(
        "blockwise_attn_fwd", src, rep + "144", ok and ok_v and ok_x, max(err, err_v),
        time_ms(torch, lambda: ha.blockwise_attn_fwd(q, k, v, full)),
        time_ms(torch, lambda: ha.blockwise_attn_fwd_plain(q, k, v, full)),
        4 * row_b + lse_b, 12 * fl, TF32_FLOPS, time_ms(torch, attn_lib(torch, q, k, v, None)),
    )
    e15 = entries["blockwise_attn_fwd"]
    e15["kernel_route"] = {str(h_): ha._fwd_route(h_) for h_ in (HIST, LONG_H)}
    e15["plan"] = {str(h_): ha.tc_shape(ha._fwd_tc_plan(h_), dh) for h_ in (HIST, LONG_H)}
    e15["ptxas"] = b15_ptxas
    b15_times(torch, smi, e15, "", q, k, v, None, b15_ptxas)
    b15_times(torch, smi, e15, "varlen_", qv, kv, vv, lv, b15_ptxas)
    del q, k, v, qv, kv, vv
    cpu_model = copy.deepcopy(model).cpu()
    others = {"fused_history_encoder": 0, "fused_attn_stack": 0, "fused_mha_fwd": 0,
              **MIPS_ROUTE, **ENC_TC}
    tc_cells = nl * (ha._fwd_route(HIST) == "tc")  # B15's tensor-core launches a batch or step
    legs = {}
    for label, bts in (("serve-1M-exact-blockwise", batches),
                       ("serve-1M-exact-blockwise-varlen", var_batches)):
        counts, legs[label] = serve_leg(torch, label, engine, model, cpu_model, cfg, bts,
                                        {"blockwise_attn_fwd": nl,
                                         "blockwise_attn_fwd_tc": tc_cells, **others}, [],
                                        entries, failures, smi)
        e15[f"launches_{label}"] = counts.get("blockwise_attn_fwd", 0)
        e15[f"tc_launches_{label}"] = counts.get("blockwise_attn_fwd_tc", 0)
    e15["launches"] = e15["launches_serve-1M-exact-blockwise"]
    del engine, model, cpu_model, batches, var_batches, catalog_feats
    torch.cuda.empty_cache()

    # -- 7a: the training batch's layer 0, and the long-history leg --
    cfg = blockwise_cfg(flagship_cfg(TRAIN_ROWS))
    bt = TRAIN_BATCH
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen.manual_seed(args.seed + 10)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, bt)
    idx = torch.arange(bt, device=dev)
    (q, k, v), _ = folded_qkv(torch, state.params, gather_batch(data, idx).user_history, None,
                              nh, cd)
    g = torch.randn(q.shape, generator=gen, device=dev) / bt
    ok, err, gerr = attn_checks(torch, "blockwise train", q, k, v, None, g)
    full = torch.full((q.shape[0],), HIST, dtype=torch.int32, device=dev)
    out, lse = ha.blockwise_attn_fwd(q, k, v, full)
    delta = (g * out).sum(-1)
    bargs = (q, k, v, g, lse, delta, full)
    with torch.enable_grad():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_out = attn_lib(torch, *leaves, None)()
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True))
    del lib_out, leaves
    row_b, lse_b, fl = attn_counts(q.shape[0], HIST, dh, None)
    b15_times(torch, smi, e15, "train_", q, k, v, None, b15_ptxas)
    plain_bwd_ms = time_ms(torch, lambda: ha.blockwise_attn_bwd_plain(*bargs))
    entry("blockwise_attn_dq", src, rep + "277", ok, gerr,
          time_ms(torch, lambda: ha.blockwise_attn_dq(*bargs)), plain_bwd_ms,
          5 * row_b + 2 * lse_b, 6 * fl, F32_FLOPS, lib_bwd_ms)
    entry("blockwise_attn_dkv", src, rep + "295", ok, gerr,
          time_ms(torch, lambda: ha.blockwise_attn_dkv(*bargs)), plain_bwd_ms,
          6 * row_b + 2 * lse_b, 8 * fl, F32_FLOPS, lib_bwd_ms)
    attn_bwd_times(torch, smi, entries, "train_", bargs, None, bwd_ptxas)
    for name in ("blockwise_attn_dq", "blockwise_attn_dkv"):
        e = entries[name]
        e["kernel_route"] = {str(h_): ha._bwd_route(h_) for h_ in (HIST, LONG_H)}
        mode = int(name == "blockwise_attn_dkv")
        e["plan"] = {f"{n_}x{h_}": ha.bwd_tc_shape(ha._bwd_tc_plan(mode, n_, h_), dh)
                     for n_, h_ in ((bt * nh, HIST), (LONG_N, LONG_H), (LONG_TRAIN_B * nh, LONG_H))}
        e["ptxas"] = bwd_ptxas["B16" if name == "blockwise_attn_dq" else "B17"]
        e["note"] = (
            "ms, plain_ms, library_ms at the training batch's layer 0 (N=16384, H=32, Dh=16) on "
            "the route's kernel (kernel_route by H; plan by N x H: warps on the leading index, "
            "rows a tile, ring stages); plain_ms is the plain backward (dq, dk and dv together); "
            "library_ms the autograd backward of F.scaled_dot_product_attention (f32), for B16 "
            "and B17 together; train_* there, long_* at N=4, H=4096 (long_varlen_*: lengths "
            "uniform in [1, 4096]), 4k_* at N=1024, H=4096 (layer 0 of train-4k-blockwise's "
            "batch); tc_* the tensor-core kernel (attn_bwd_tc_kernel, 3xTF32), fma_* the FMA "
            "kernel, device_ms the kernel alone (torch.profiler); bound_ms the larger of "
            "bytes_bound_ms and the routed kernel's operations (tf32_bound_ms: 3xTF32 at the "
            "TF32 rate; f32_bound_ms: f32 FMA); tc_launches the launches on the tensor cores")
    e15["note"] = (
        "the tensor-core kernel (attn_fwd_tc_kernel, 3xTF32; kernel_route, plan by H: warps on "
        "the leading index, keys a tile, ring stages); ms, plain_ms, "
        "bound_ms, library_ms at the serving batch's layer 0 (N=4096, H=32, Dh=16), varlen_* "
        "there with lengths (bounds counting valid keys only), train_* at the training batch "
        "(N=16384), long_* at N=4, H=4096 (long_varlen_*: lengths uniform in [1, 4096]); "
        "device_ms the kernel alone (torch.profiler); fma_* the FMA kernel (attn_fwd_kernel) on "
        "the same inputs in the same call; bound_ms the larger of bytes_bound_ms and "
        "tf32_bound_ms (3xTF32 at the TF32 rate), f32_bound_ms one f32 FMA pass on the CUDA "
        "cores; library_ms is F.scaled_dot_product_attention (f32, boolean key mask); "
        "tc_launches the launches on the tensor cores")
    del q, k, v, g, out, lse, delta, bargs
    torch.cuda.empty_cache()

    long_ok, mem = True, {}
    for tag, lens in (("long", None),
                      ("long_varlen", torch.randint(1, LONG_H + 1, (LONG_N,), generator=gen,
                                                    device=dev, dtype=torch.int32))):
        q, k, v, g = (torch.randn(LONG_N, LONG_H, dh, generator=gen, device=dev) for _ in range(4))
        ok_l, _, _ = attn_checks(torch, f"blockwise {tag} (N={LONG_N}, H={LONG_H})", q, k, v,
                                 lens, g)
        lk = torch.full((LONG_N,), LONG_H, dtype=torch.int32, device=dev) if lens is None else lens
        out, lse = ha.blockwise_attn_fwd(q, k, v, lk)
        bargs = (q, k, v, g, lse, (g * out).sum(-1), lk)
        row_b, lse_b, fl = attn_counts(LONG_N, LONG_H, dh, lens)
        b15_times(torch, smi, e15, f"{tag}_", q, k, v, lens, b15_ptxas)
        attn_bwd_times(torch, smi, entries, f"{tag}_", bargs, lens, bwd_ptxas)
        # the long history's own path: blockwise_self_attention forward and
        # backward, the counts zeroed just before and read just after
        _lib.reset_launch_counts()
        peaks = attn_memory(torch, q, k, v, lk, g)
        counts = dict(_lib.launches)
        e15[f"launches_{tag}"] = counts.get("blockwise_attn_fwd", 0)
        e15[f"tc_launches_{tag}"] = counts.get("blockwise_attn_fwd_tc", 0)
        for name in ("blockwise_attn_dq", "blockwise_attn_dkv"):
            entries[name][f"launches_{tag}"] = counts.get(name, 0)
            entries[name][f"tc_launches_{tag}"] = counts.get(name + "_tc", 0)
        want = {"blockwise_attn_fwd": 1, "blockwise_attn_dq": 1, "blockwise_attn_dkv": 1,
                "blockwise_attn_fwd_tc": int(ha._fwd_route(LONG_H) == "tc"),
                "blockwise_attn_dq_tc": int(ha._bwd_route(LONG_H) == "tc"),
                "blockwise_attn_dkv_tc": int(ha._bwd_route(LONG_H) == "tc")}
        print(f"launches on the blockwise {tag} path (forward and backward): "
              f"{json.dumps(counts)}", flush=True)
        check_launches(counts, want, 1, failures, f"blockwise {tag}")
        mem[tag] = peaks
        long_ok &= ok_l and peaks[0] < peaks[1] / 4
        print(f"blockwise {tag}: peak memory of forward + backward above the inputs: blockwise "
              f"{peaks[0] / 2**20:.2f} MiB, plain dense {peaks[1] / 2**20:.2f} MiB "
              f"({peaks[0] / peaks[1]:.4f}, needs < 0.25); B15 {e15[f'{tag}_ms']:.4f} ms, "
              f"B16 {entries['blockwise_attn_dq'][f'{tag}_ms']:.4f} ms, B17 "
              f"{entries['blockwise_attn_dkv'][f'{tag}_ms']:.4f} ms", flush=True)
        del q, k, v, g, out, lse, bargs
        torch.cuda.empty_cache()
    e15["long_memory_bytes"] = mem
    e15["tc_launches"] = e15["tc_launches_long"]
    if not long_ok:
        failures.append("blockwise long history")

    # -- 7c: training.  phase 4's configuration on the blockwise tier
    tc_bwd = nl * (ha._bwd_route(HIST) == "tc")  # B16's and B17's tensor-core launches a step
    expect = {"blockwise_attn_fwd": nl, "blockwise_attn_fwd_tc": tc_cells,
              "blockwise_attn_dq": nl, "blockwise_attn_dkv": nl,
              "blockwise_attn_dq_tc": tc_bwd, "blockwise_attn_dkv_tc": tc_bwd,
              "fused_in_batch_ce": 1, "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1,
              "fused_history_encoder": 0, "fused_history_encoder_res": 0,
              "fused_history_encoder_bwd": 0, "fused_history_encoder_bwd_recompute": 0,
              "fused_attn_stack": 0, "fused_attn_stack_bwd": 0, "fused_mha_fwd": 0,
              "fused_mha_bwd": 0, "fused_mha_bwd_tc": 0, "rows_scatter_add": POS_B18,
              "rows_write": 0, "fused_adam": 0, **ENC_TC}
    var_data = make_synthetic_data(DataConfig(
        num_samples=bt, num_users=TRAIN_ROWS, num_items=TRAIN_ROWS, feature_dim=16,
        history_len=HIST, num_tasks=3, max_position=cfg.position_table_size,
        seed=args.seed, variable_history=True,
    ), device=dev)
    step = make_train_step(cfg, train_cfg)
    for label, dat in (("train-65k-blockwise", data), ("train-65k-blockwise-varlen", var_data)):
        state, metrics, _, _, _ = run_steps(torch, step, state, dat, idx, 3)
        state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, dat, idx,
                                                           TRAIN_STEPS)
        state, syncs = count_syncs(torch, step, state, dat, idx)
        metrics += timed
        legs[label] = ms_step
        print(f"launches on the {label} path ({TRAIN_STEPS} steps): {json.dumps(counts)}",
              flush=True)
        check_launches(counts, expect, TRAIN_STEPS, failures, label)
        for name in ("blockwise_attn_fwd", "blockwise_attn_dq", "blockwise_attn_dkv"):
            entries[name][f"launches_{label}"] = counts.get(name, 0)
            entries[name][f"tc_launches_{label}"] = counts.get(name + "_tc", 0)
        if not finite(torch, metrics):
            failures.append(f"{label} metrics not finite")
        kern = nl * (e15["train_device_ms"] + entries["blockwise_attn_dq"]["ms"]
                     + entries["blockwise_attn_dkv"]["ms"])
        print(
            f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of B={bt}: "
            f"ms/step {ms_step:.3f}, examples/s {bt / ms_step * 1e3:.0f}; host wall "
            f"{host_ms:.3f} ms/step; loss first {float(metrics[0]['loss']):.5f} last "
            f"{float(metrics[-1]['loss']):.5f}; three each of B15, B16, B17 alone {kern:.3f} ms "
            f"({kern / ms_step * 100:.1f}% of the step); host syncs in a step {syncs}", flush=True)
        state, _ = trace_steps(torch, step, state, dat, idx, label)
        grads_vs_cpu(torch, state.params, cfg, dat, idx, failures, label)
    for name in ("blockwise_attn_dq", "blockwise_attn_dkv"):
        entries[name]["launches"] = entries[name]["launches_train-65k-blockwise"]
    del state, data, var_data
    torch.cuda.empty_cache()

    # -- 7d: the long-history training leg
    legs["train-4k-blockwise"] = phase_train_4k(torch, args, smi, dev, entries, failures,
                                                bwd_ptxas)
    print(f"blockwise tier on {torch.cuda.get_device_name(0)} ({smi}): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in legs.items())
          + f"; phase 4's B5+B6 step {b56_ms[0]:.3f}, {b56_ms[1]:.3f} ms; phase 6: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in layer_legs.items()), flush=True)


def phase_train_4k(torch, args, smi, dev, entries, failures, bwd_ptxas) -> float:
    """Phase 7d, train-4k-blockwise: phase 7c's configuration with
    histories of LONG_TRAIN_H items, B = LONG_TRAIN_B (N = 4 B heads of H =
    4096 rows, whose dense [N, H, H] probabilities would take 64 GiB a
    layer).  On layer 0 of its fixed batch, B16 and B17 on both kernels
    held against the plain backward of the first LONG_CHECK_N leading
    indices (the plain version of all would take 64 GiB) and timed; then 2
    warm-up and LONG_TRAIN_STEPS timed steps, three each of B15, B16 and
    B17 a step on the tensor cores, three profiled steps, and train_loss's
    grads on LONG_CHECK_ROWS rows against a CPU copy.  Returns ms/step."""
    import dataclasses

    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.ops import history_attention as ha
    from two_tower_models_tpu_torch.training.data import gather_batch
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    label, nh, nl, bt = "train-4k-blockwise", 4, 3, LONG_TRAIN_B
    cfg = dataclasses.replace(blockwise_cfg(flagship_cfg(TRAIN_ROWS)), history_len=LONG_H)
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 20)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, bt)
    idx = torch.arange(bt, device=dev)
    t0 = time.perf_counter()
    (q, k, v), _ = folded_qkv(torch, state.params, gather_batch(data, idx).user_history, None,
                              nh, torch.bfloat16)
    g = torch.randn(q.shape, generator=gen, device=dev) / bt
    full = torch.full((q.shape[0],), LONG_H, dtype=torch.int32, device=dev)
    out, lse = ha.blockwise_attn_fwd(q, k, v, full)
    bargs = (q, k, v, g, lse, (g * out).sum(-1), full)
    m = LONG_CHECK_N
    ok, gerr, text = attn_bwd_checks(torch, bargs, ha.blockwise_attn_bwd_plain(
        *(t[:m] for t in bargs)), rows=m)
    print(f"{label} layer 0 (N={q.shape[0]}, H={LONG_H}, the first {m} leading indices against "
          f"the plain backward){text}; ok={ok}", flush=True)
    if not ok:
        failures.append(f"{label} B16, B17 against plain")
    attn_bwd_times(torch, smi, entries, "4k_", bargs, None, bwd_ptxas, plain=False)
    del q, k, v, g, out, lse, bargs
    torch.cuda.empty_cache()
    expect = {"blockwise_attn_fwd": nl, "blockwise_attn_fwd_tc": nl, "blockwise_attn_dq": nl,
              "blockwise_attn_dkv": nl, "blockwise_attn_dq_tc": nl, "blockwise_attn_dkv_tc": nl,
              "fused_in_batch_ce": 1, "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1,
              "fused_history_encoder": 0, "fused_history_encoder_res": 0,
              "fused_history_encoder_bwd": 0, "fused_history_encoder_bwd_recompute": 0,
              "fused_attn_stack": 0, "fused_attn_stack_bwd": 0, "fused_mha_fwd": 0,
              "fused_mha_bwd": 0, "fused_mha_bwd_tc": 0, **ENC_TC}
    step = make_train_step(cfg, train_cfg)
    state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, 2)
    state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx,
                                                       LONG_TRAIN_STEPS)
    metrics += timed
    print(f"launches on the {label} path ({LONG_TRAIN_STEPS} steps): {json.dumps(counts)}",
          flush=True)
    check_launches(counts, expect, LONG_TRAIN_STEPS, failures, label)
    for name in ("blockwise_attn_fwd", "blockwise_attn_dq", "blockwise_attn_dkv"):
        entries[name][f"launches_{label}"] = counts.get(name, 0)
        entries[name][f"tc_launches_{label}"] = counts.get(name + "_tc", 0)
    if not finite(torch, metrics):
        failures.append(f"{label} metrics not finite")
    print(f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {LONG_TRAIN_STEPS} steps of "
          f"B={bt}, H={LONG_H}: ms/step {ms_step:.3f}, examples/s {bt / ms_step * 1e3:.1f}; host "
          f"wall {host_ms:.3f} ms/step; loss first {float(metrics[0]['loss']):.5f} last "
          f"{float(metrics[-1]['loss']):.5f}", flush=True)
    state, busy = trace_steps(torch, step, state, data, idx, label)
    grads_vs_cpu(torch, state.params, cfg, data, idx, failures, label, rows=LONG_CHECK_ROWS)
    print(f"{label}: leg wall {time.perf_counter() - t0:.1f} s", flush=True)
    del state, data
    torch.cuda.empty_cache()
    return ms_step


def phase_fused_adam(torch, args, smi, dev, entry, entries, failures, ms_packed) -> None:
    """Phase 8: one-pass fused Adam (B20) on scripts/bench_tables.py's
    configuration (train-4M-packed with TrainConfig(fused_adam=True))."""
    import dataclasses

    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.ops import fused_adam as fa
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    b = TRAIN_BATCH
    cfg = flagship_cfg(TABLE_ROWS)
    dense_cfg = TrainConfig(batch_size=b, learning_rate=1e-3, pack_tables_min_rows=PACK_MIN_ROWS)
    fused_cfg = dataclasses.replace(dense_cfg, fused_adam=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 11)
    data = fixed_batch(torch, gen, dev, cfg, b)
    idx = torch.arange(b, device=dev)
    st_fused = create_train_state(args.seed + 12, cfg, fused_cfg, device=dev)
    big = [(n, p) for n, p in st_fused.params.named_parameters()
           if p.numel() >= fa._MIN_KERNEL_ELEMS]
    print(f"fused Adam: leaves of >= {fa._MIN_KERNEL_ELEMS} elements (one B20 launch a step "
          f"each): {[(n, tuple(p.shape)) for n, p in big]}", flush=True)

    # -- 8a: B20 against its plain version on the real leaves, 3 steps --
    exact, err, bytes_, elems = True, 0.0, 0, 0
    for name, p in big:
        g = torch.randn(p.shape, generator=gen, device=dev) * 1e-2
        m0 = torch.randn(p.shape, generator=gen, device=dev) * 1e-3
        v0 = m0.square() * 2
        runs = [[p.detach().clone(), m0.clone(), v0.clone()] for _ in range(2)]
        for t in (1, 2, 3):
            c = fa.bias_corrections(torch.tensor(t, dtype=torch.int32, device=dev))
            fa.fused_adam_leaf(*runs[0], g, c, 1e-3)
            fa.fused_adam_leaf_plain(*runs[1], g, c, 1e-3)
        for a, e in zip(*runs):
            exact &= torch.equal(a, e)
            err = max(err, close(a, e, 0.0, 0.0)[1])
        elems += p.numel()
        bytes_ += p.numel() * (2 * p.element_size() + 4 * 4 + g.element_size())
        del runs, g, m0, v0
        torch.cuda.empty_cache()
    print(f"fused Adam vs plain on the 4M-packed leaves, 3 steps: p, m, v bit-equal={exact}",
          flush=True)
    c = fa.bias_corrections(torch.tensor(4, dtype=torch.int32, device=dev))
    leaves = [(p.detach().clone(), torch.zeros_like(p), torch.zeros_like(p),
               torch.randn(p.shape, generator=gen, device=dev) * 1e-2) for _, p in big]
    one_pass = lambda: [fa.fused_adam_leaf(pp, m, v, g, c, 1e-3) for pp, m, v, g in leaves]
    tp = [torch.nn.Parameter(pp.clone()) for pp, _, _, _ in leaves]
    for t, (_, _, _, g) in zip(tp, leaves):
        t.grad = g
    lib_opt = torch.optim.Adam(tp, lr=1e-3, fused=True)
    entry(
        "fused_adam", "two_tower_models_tpu_torch/csrc/fused_adam.cu",
        "two_tower_models_tpu/ops/pallas/fused_adam.py:84", exact, err,
        time_ms(torch, one_pass),
        time_ms(torch, lambda: [fa.fused_adam_leaf_plain(pp, m, v, g, c, 1e-3)
                                for pp, m, v, g in leaves], 3),
        bytes_, 14 * elems, F32_FLOPS, time_ms(torch, lib_opt.step, 3),
    )
    entries["fused_adam"]["note"] = (
        "times are one step's launches over the leaves of >= 2^16 elements of a 4M-packed state "
        "(the two packed id tables); library_ms is torch.optim.Adam(fused=True).step() on "
        "copies of them")
    del leaves, tp, lib_opt
    torch.cuda.empty_cache()

    # -- 8b: one step from one state through B20 and through Adam --
    st_adam = create_train_state(args.seed + 12, cfg, dense_cfg, device=dev)
    with torch.enable_grad():
        st_fused, _ = make_train_step(cfg, fused_cfg)(st_fused, data, idx)
        st_adam, _ = make_train_step(cfg, dense_cfg)(st_adam, data, idx)
    got, want = table_tensors(st_fused), table_tensors(st_adam)
    worst, bad = 0.0, []
    for name in want:
        ok, e = scaled_close(got[name], want[name], 1e-6)
        worst = max(worst, e)
        if not ok:
            bad.append(name)
    print(f"train-4M-packed: one step through B20 vs through Adam from one state, tables and "
          f"moments: max_abs_err {worst:.3g} (tol 1e-6 of each one's scale); mismatched {bad}",
          flush=True)
    if bad:
        failures.append(f"fused Adam step vs Adam: {bad}")
    del st_adam, got, want
    torch.cuda.empty_cache()

    # -- 8c: the leg --
    five = {"fused_history_encoder_res": 1, "fused_history_encoder_bwd": 1, "fused_in_batch_ce": 1,
            "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1, **ENC_TC,
            "fused_history_encoder_res_tc": 1, "fused_history_encoder_bwd_tc": 1}
    step = make_train_step(cfg, fused_cfg)
    st_fused, ms, counts = table_leg(
        torch, "train-4M-packed-fusedadam", step, st_fused, data, idx, 2,
        {**five, "rows_scatter_add": 3 + POS_B18, "rows_write": 0, "fused_adam": len(big)}, smi,
        failures)
    entries["fused_adam"]["launches"] = counts.get("fused_adam", 0)
    b20 = entries["fused_adam"]["ms"]
    print(f"train-4M-packed-fusedadam on {torch.cuda.get_device_name(0)} ({smi}): {ms:.3f} "
          f"ms/step against train-4M-packed's {ms_packed:.3f} (phase 5, this run); B20's "
          f"{len(big)} launches alone {b20:.3f} ms ({b20 / ms * 100:.1f}% of the step)", flush=True)
    del st_fused
    torch.cuda.empty_cache()


def nonfinite_check(torch, dev) -> bool:
    """Phase 2's input for the tile max's total order: an integer-grid
    corpus (every finite score exact) with rows that score +-inf and NaN
    (+inf in a column half the queries zero, so 0 * inf; -inf rows; a -NaN
    row and a +NaN row).  B2 must equal its plain version bit for bit (as
    int32 keys), and the exact pipeline's indices topk_ordered on the dense
    scores."""
    from two_tower_models_tpu_torch.ops import mips_topk as mt
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact, topk_ordered

    b, c, d = 256, 1 << 18, 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    corpus = torch.randint(-2, 3, (c, d), generator=gen, device=dev).float()
    query = torch.randint(-2, 3, (b, d), generator=gen, device=dev).float()
    query[: b // 2, 0] = 0
    corpus[torch.arange(0, 300, device=dev) * mt.TILE + 5, 0] = float("inf")
    corpus[torch.arange(300, 400, device=dev) * mt.TILE + 7, 1] = float("-inf")
    bits = corpus.view(torch.int32)
    bits[3, 2] = -(1 << 22)  # 0xFFC00000, a negative NaN
    bits[77_777, 5] = 0x7FC00000  # a positive NaN
    got = mt.tile_max_scores(query, corpus, mt.TILE, c)
    tile_exact = torch.equal(mt.f32_keys(got), mt.f32_keys(mt.tile_max_scores_plain(
        query, corpus, mt.TILE, c)))
    scores = query @ corpus.T
    idx, _, _ = mips_topk_exact(corpus, query, TOPK)
    pipe_exact = torch.equal(idx, topk_ordered(scores, TOPK)[1])
    print(f"tile max on non-finite scores ({int(scores.isnan().sum())} NaN, "
          f"{int(scores.isinf().sum())} inf of {scores.numel()}): B2 vs plain bit-equal="
          f"{tile_exact}; pipeline indices vs topk_ordered on the dense scores equal={pipe_exact}",
          flush=True)
    return tile_exact and pipe_exact


def rescore_checks(torch, dev, smi, q, corpus, mk, tile_idx, ptxas_lines, entry, entries):
    """Phase 2's B4 on the serving batch's own selection ``tile_idx`` (sorted,
    as the pipeline takes it): the inverted selection against its plain
    version (counts, offsets and work items exactly, each tile's pairs as a
    set); the scores against the plain version and, bit for bit, B2's tile
    max ``mk`` at every selected tile against the max of B4's scores over
    its rows; the skewed selection (every query on the first query's 100
    tiles) against the plain version.  Entries gather_rescore_invert and
    gather_rescore, each timed with the host's dispatch and by device time,
    the inversion's launches apart from the scoring launch.  Returns B4's
    scores."""
    from two_tower_models_tpu_torch.ops import mips_topk as mt

    b, d = q.shape
    c, nt, n = corpus.shape[0], mk.shape[1], q.shape[0] * TOPK
    src, replaces = ("two_tower_models_tpu_torch/csrc/gather_rescore.cu",
                     "two_tower_models_tpu/ops/pallas/mips_topk.py:559")
    inv_fn = lambda: mt.invert_selection(tile_idx, nt)
    got = mt.rescore_scratch_views(inv_fn(), b, TOPK, nt)
    want = mt.rescore_scratch_views(mt.invert_selection_plain(tile_idx, nt), b, TOPK, nt)
    n_items = int(want["n_items"][0])
    flat = tile_idx.reshape(-1).long()
    pair_key = lambda p: flat[p.long()] * n + p.long()  # (tile, pair): each list as a set
    bad = [k for k in ("n_items", "counts", "offsets") if not torch.equal(got[k], want[k])]
    bad += [] if torch.equal(got["items"][:n_items], want["items"][:n_items]) else ["items"]
    bad += ([] if torch.equal(torch.sort(pair_key(got["pairs"])).values, pair_key(want["pairs"]))
            else ["pairs"])
    entry("gather_rescore_invert", src, replaces, not bad, float(len(bad)),
          time_ms(torch, inv_fn),
          time_ms(torch, lambda: mt.invert_selection_plain(tile_idx, nt), 3),
          2 * n * 4 + (2 * nt + 3) * 4 + n_items * 16 + 4, 0, F32_FLOPS,
          time_ms(torch, lambda: torch.argsort(flat, stable=True), 3))
    ei = entries["gather_rescore_invert"]
    ei.update(device_ms=call_device_ms(torch, inv_fn), work_items=n_items, mismatched_parts=bad,
              note="max_abs_err counts the parts of the inverted selection (n_items, counts, "
                   "offsets, items, pairs as sets) that differ from the plain version's; "
                   "library is torch.argsort of the selection (the pairs alone)")

    rs_fn = lambda: mt.gather_rescore(q, corpus, tile_idx, mt.TILE)
    ck = rs_fn()
    cp = mt.gather_rescore_plain(q, corpus, tile_idx, mt.TILE)
    scale = float(cp.abs().max())
    ok, err = close(ck, cp, 1e-5, 1e-5 * scale)
    rows = tile_idx.long()[:, :, None] * mt.TILE + torch.arange(mt.TILE, device=dev)
    cand = ck.view(b, TOPK, mt.TILE).masked_fill(rows >= c, float("-inf"))
    bits = torch.equal(mt.f32_keys(cand).amax(-1), mt.f32_keys(mk.gather(1, tile_idx.long())))
    skew = tile_idx[:1].expand(b, TOPK).contiguous()
    sk_fn = lambda: mt.gather_rescore(q, corpus, skew, mt.TILE)
    ok_sk, err_sk = close(sk_fn(), mt.gather_rescore_plain(q, corpus, skew, mt.TILE), 1e-5,
                          1e-5 * scale)
    tiles_lib = corpus.view(nt, mt.TILE, d)
    entry(
        "gather_rescore", src, replaces, ok and bits and ok_sk, max(err, err_sk),
        time_ms(torch, rs_fn),
        time_ms(torch, lambda: mt.gather_rescore_plain(q, corpus, tile_idx, mt.TILE), 3),
        int(torch.unique(tile_idx).numel()) * mt.TILE * d * 4 + b * d * 4 + n * 4
        + n * mt.TILE * 4, 2 * n * mt.TILE * d, F32_FLOPS,
        time_ms(torch, lambda: torch.bmm(
            tiles_lib[tile_idx.long()].view(b, TOPK * mt.TILE, d), q[:, :, None]), 3),
    )
    e4 = entries["gather_rescore"]
    e4.update(
        device_ms=call_device_ms(torch, rs_fn), invert_device_ms=ei["device_ms"],
        score_device_ms=device_ms(torch, rs_fn, "rescore_kernel"),
        tile_max_equals_rescore_max=bits,
        skewed={"ok": ok_sk, "max_abs_err": err_sk, "ms": time_ms(torch, sk_fn),
                "device_ms": call_device_ms(torch, sk_fn),
                "score_device_ms": device_ms(torch, sk_fn, "rescore_kernel")},
        ptxas="; ".join(ptxas_lines.get("rescore_kernel", [])),
        note="ms and device_ms count the inversion and the scoring (invert_device_ms, "
             "score_device_ms: each alone); skewed: every query on the first query's 100 "
             "tiles; bytes count each distinct selected tile once")
    sk = e4["skewed"]
    print(f"B4 at B={b}, k={TOPK} on {smi}: inversion vs plain exact={not bad} ({n_items} work "
          f"items), scores ok={ok} max_abs_err={err:.3g}; B2's tile max = max of B4's scores at "
          f"every selected tile, bit for bit: {bits}; device {e4['device_ms']:.4f} ms (inversion "
          f"{ei['device_ms']:.4f}, scoring {e4['score_device_ms']:.4f}), with the host's dispatch "
          f"{e4['ms']:.4f}; bound {e4['bound_ms']:.4f} ({e4['bound_by']}); skewed: ok={ok_sk} "
          f"device {sk['device_ms']:.4f} (scoring {sk['score_device_ms']:.4f}), with the host's "
          f"dispatch {sk['ms']:.4f}; ptxas {e4['ptxas']}", flush=True)
    return ck


def loop_recorder(flag=None, flag_at=None, window=None):
    """Phase 9's logger: a JsonlLogger (no echo) that keeps every event with
    the host's clock in ``.events``, sets ``flag`` at the first step log at
    or past ``flag_at``, and opens ``window`` at the step log of
    ``window.start``."""
    from two_tower_models_tpu_torch.utils.logging import JsonlLogger

    class Recorder(JsonlLogger):
        def log(self, event, **fields):
            self.events.append((event, fields, time.perf_counter()))
            super().log(event, **fields)
            if event == "step":
                if flag is not None and fields["step"] >= flag_at:
                    flag.set()
                if window is not None and fields["step"] == window.start:
                    window.open()

    rec = Recorder(echo=False)
    rec.events = []
    return rec


class SyncWindow:
    """Counts the operations that make the host wait for the stream (CUDA's
    sync debug mode) from the step log at ``start`` to the return of the
    step call that reaches step ``end``: the loop's code between two gates
    and the ``end - start`` steps it runs."""

    def __init__(self, torch, start: int, end: int):
        self.torch, self.start, self.end = torch, start, end
        self.steps, self.syncs, self._cm, self._caught = 0, None, None, None

    def open(self) -> None:
        import warnings

        self._cm = warnings.catch_warnings(record=True)
        self._caught = self._cm.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")

    def close(self) -> None:
        self.torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(None, None, None)
        self.syncs = sum(SYNC_WARNING in str(w.message) for w in self._caught)
        self._cm = None

    def wrap(self, make_train_step):
        """``make_train_step`` whose steps close the window on reaching
        ``end``."""
        def make(*a, **k):
            step = make_train_step(*a, **k)

            def counted(state, data, idx):
                out = step(state, data, idx)
                self.steps += idx.shape[0] if idx.dim() == 2 else 1
                if self._cm is not None and self.steps == self.end:
                    self.close()
                return out
            return counted
        return make


def state_diff(torch, got, want, prefix: str = ""):
    """(worst |got - want| over each tensor's largest |want|, its name,
    bit-equal) over the tensors of two TrainStates whose flat names start
    with ``prefix`` (``checkpoint.state_tensors``)."""
    from two_tower_models_tpu_torch.training.checkpoint import state_tensors

    a, b = state_tensors(got), state_tensors(want)
    if a.keys() != b.keys():
        return float("inf"), "the names", False
    worst, worst_name, equal = 0.0, "", True
    for k, w in b.items():
        if not k.startswith(prefix):
            continue
        g = a[k]
        equal = equal and g.dtype == w.dtype and bool(torch.equal(g, w))
        scale = max(float(w.double().abs().max()), 1e-30)
        err = float((g.double() - w.double()).abs().max()) / scale
        if err > worst or not worst_name:
            worst, worst_name = err, k
    return worst, worst_name, equal


def embedding_repeats(torch, dev, calls: int = 5, fixed_order: bool = False) -> int:
    """Distinct results of ``calls`` identical lookup backwards at the
    position table's shape on the flagship step (100 x 1, B = 4096 ids on
    DataConfig's 10 positions): F.embedding's, or with ``fixed_order`` the
    port's lookup (B18)."""
    from two_tower_models_tpu_torch.nn.layers import embedding_lookup

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn(100, 1, device=dev, generator=gen).requires_grad_()
    ids = torch.randint(0, 10, (TRAIN_BATCH,), device=dev, generator=gen)
    up = torch.randn(TRAIN_BATCH, 1, device=dev, generator=gen)
    seen = set()
    with torch.enable_grad():
        for _ in range(calls):
            out = (embedding_lookup(table, ids, fixed_order=True) if fixed_order
                   else torch.nn.functional.embedding(ids, table))
            (g,) = torch.autograd.grad(out, table, up)
            seen.add(g.cpu().numpy().tobytes())
    return len(seen)


def deterministic(torch, on: bool) -> None:
    """torch.use_deterministic_algorithms(on), warning (not raising) on an
    operation without a deterministic implementation (make_synthetic_data's
    bincount, whose integer counts do not depend on the order)."""
    torch.use_deterministic_algorithms(on, warn_only=True)


def step_ms(events, lo: int, hi: int) -> float:
    """The loop's host ms a step between its step logs at ``lo`` and ``hi``."""
    t = {f["step"]: at for e, f, at in events if e == "step"}
    return (t[hi] - t[lo]) * 1e3 / (hi - lo)


def check_loop_launches(counts: dict, steps: int, evals: int, entries, key: str,
                        failures: list, label: str, b18: int = POS_B18) -> None:
    """One launch a step of each training kernel of the flagship step (``b18``
    of B18: the position table's, none without debiasing) and, each eval,
    one B1 (on the tensor cores) and the exact MIPS's kernels; none of the
    other encoder or table kernels."""
    per_step = {"fused_history_encoder_res": 1, "fused_history_encoder_res_tc": 1,
                "fused_history_encoder_bwd": 1, "fused_history_encoder_bwd_tc": 1,
                "fused_history_encoder_bwd_reduce": 1, "fused_in_batch_ce": 1,
                "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1, "rows_scatter_add": b18}
    per_eval = {"fused_history_encoder": 1, "fused_history_encoder_tc": 1, **MIPS_ROUTE}
    names = {**ENC_TC, **per_step, **per_eval, "rows_write": 0,
             "fused_history_encoder_bwd_recompute": 0, "fused_attn_stack": 0}
    for k in names:
        want = steps * per_step.get(k, 0) + evals * per_eval.get(k, 0)
        if counts.get(k, 0) != want:
            failures.append(f"{label} launches[{k}]={counts.get(k, 0)}, want {want}")
        if k in entries:
            entries[k][key] = counts.get(k, 0)


def counted_train(torch, loop, exp, rec, dev, **kw):
    """training.loop.train with the launch counts zeroed just before and
    read just after: (summary, counts, evals)."""
    from two_tower_models_tpu_torch.ops import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    summary = loop.train(exp, rec, device=dev, **kw)
    torch.cuda.synchronize()
    return summary, dict(_lib.launches), sum(e == "eval" for e, _, _ in rec.events)


def phase_loop(torch, args, smi, dev, entries, failures) -> None:
    """Phase 9: the training loop (training.loop.train) at the flagship's
    width: checkpoints, exact-position resume, preemption, the recall@k
    eval, the trainer CLI, and the JAX package's quality anchor, all with
    the default algorithms.  The position table's gradient (4096 ids on 10
    rows) sums in a fixed order (B18), where F.embedding's backward differs
    from call to call in its last bits, so two runs from one state stay
    bit-equal and 9c against 9a checks resume alone."""
    import dataclasses
    import math
    import os
    import tempfile
    import threading

    from two_tower_models_tpu_torch.config import (
        DataConfig,
        Debias,
        ExperimentConfig,
        TrainConfig,
        resolve_kernel_flags,
    )
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.retrieval.mips import refresh_corpus
    from two_tower_models_tpu_torch.training import loop
    from two_tower_models_tpu_torch.training.checkpoint import (
        ASYNC_MIN_D2H_MBPS,
        CheckpointManager,
        device_to_host_mbps,
    )
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_eval_recall_fn, make_train_step

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    cfg = dataclasses.replace(flagship_cfg(TRAIN_ROWS), debias_aux_weight=1.0 / 4096)
    data_cfg = DataConfig(num_samples=LOOP_SAMPLES, num_users=LOOP_USERS, num_items=LOOP_ITEMS,
                          feature_dim=16, history_len=HIST, num_tasks=cfg.num_tasks,
                          seed=args.seed)
    b = TRAIN_BATCH
    n_batches = LOOP_SAMPLES // b
    rand = TOPK / LOOP_ITEMS
    tmp = tempfile.TemporaryDirectory(prefix="loop_", dir=_lib.BUILD_DIR)
    root = tmp.name

    def experiment(ckpt, epochs=2, model=cfg, **kw):
        kw = {"learning_rate": 1e-3, "eval_every": LOOP_EVAL_EVERY, **kw}
        return ExperimentConfig(model=model, data=data_cfg, train=TrainConfig(
            batch_size=b, num_epochs=epochs, log_every=LOOP_LOG_EVERY, seed=args.seed,
            checkpoint_dir=ckpt, **kw))

    try:
        deterministic(torch, False)
        repeats = [embedding_repeats(torch, dev), embedding_repeats(torch, dev, fixed_order=True)]
        print(f"loop: the position table's lookup backward (100 x 1, 4096 ids), default "
              f"algorithms: F.embedding {repeats[0]} distinct results in 5 calls, the port's "
              f"fixed-order lookup (B18) {repeats[1]}", flush=True)
        if repeats[1] != 1:
            failures.append(f"the fixed-order lookup gave {repeats[1]} results in 5 calls")

        # -- 9a: two epochs with a checkpoint directory (default
        # algorithms); the launch counts and a window of host syncs between
        # two gates --
        window = SyncWindow(torch, LOOP_LOG_EVERY, 2 * LOOP_LOG_EVERY)
        rec_a = loop_recorder(window=window)
        make_step = loop.make_train_step
        loop.make_train_step = window.wrap(make_step)
        try:
            s_a, counts, evals = counted_train(torch, loop, experiment(os.path.join(root, "a")),
                                               rec_a, dev)
        finally:
            loop.make_train_step = make_step
        steps = int(s_a["state"].step)
        print(f"launches on the loop's path ({steps} steps, {evals} evals): {json.dumps(counts)}",
              flush=True)
        check_loop_launches(counts, steps, evals, entries, "loop_launches", failures, "loop 9a")
        if steps != 2 * n_batches or evals != 2 * n_batches // LOOP_EVAL_EVERY + 1:
            failures.append(f"loop 9a ran {steps} steps and {evals} evals")
        losses = s_a["epoch_losses"]
        logged = [f["loss"] for e, f, _ in rec_a.events if e == "step"]
        if not all(math.isfinite(v) for v in losses + logged):
            failures.append("loop 9a losses not finite")
        if not losses[1] < losses[0]:
            failures.append(f"loop 9a epoch 1 loss {losses[1]} not below epoch 0's {losses[0]}")
        recall = s_a["recall_at_k"]
        lo, hi = n_batches + LOOP_LOG_EVERY, 2 * n_batches - LOOP_LOG_EVERY
        loop_ms = step_ms(rec_a.events, lo, hi)
        print(f"loop 9a on {name} ({smi}), default algorithms: {steps} steps of B={b} in "
              f"{s_a['train_seconds']:.2f} s ({s_a['examples_per_sec']:.0f} examples/s with its "
              f"evals); steps {lo}-{hi} {loop_ms:.3f} ms/step, {b / loop_ms * 1e3:.0f} "
              f"examples/s; epoch losses {losses[0]:.5f} {losses[1]:.5f}; recall@{TOPK} "
              f"{recall:.4f} (random {rand:.6f}; the in-batch CE is still at ln B here, 9e "
              f"holds the learning)", flush=True)

        # -- the loop's added host syncs: the window against the bare step's --
        bare_step = make_train_step(resolve_kernel_flags(cfg, dev), experiment(None).train)
        data = make_synthetic_data(data_cfg, label_cols=cfg.num_tasks, device=dev)
        state = create_train_state(args.seed, cfg, experiment(None).train, device=dev)
        perm = loop.epoch_permutation(args.seed, 0, LOOP_SAMPLES, dev)
        idx_of = lambda i: perm[(i % n_batches) * b:(i % n_batches + 1) * b]
        state, bare_syncs = count_syncs(torch, bare_step, state, data, idx_of(0))
        added = None if window.syncs is None else window.syncs - (window.end - window.start) * bare_syncs
        print(f"loop host syncs between the gates at steps {window.start} and {window.end}: "
              f"{window.syncs} in {window.end - window.start} steps; the bare step {bare_syncs} a "
              f"step; the loop adds {added}", flush=True)
        if added != 0:
            failures.append(f"the loop adds {added} host syncs between gates")

        # -- the bare make_train_step on the same config and batches, with
        # deterministic and with default algorithms --
        bare_ms = {}
        with torch.enable_grad():
            for i in range(3):
                state, _ = bare_step(state, data, idx_of(i))
            for det in (True, False, False, True):
                deterministic(torch, det)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(LOOP_BARE_STEPS):
                    state, m = bare_step(state, data, idx_of(3 + i))
                float(m["loss"])
                bare_ms.setdefault(det, []).append(
                    (time.perf_counter() - t0) * 1e3 / LOOP_BARE_STEPS)
        deterministic(torch, False)
        del state
        bare = {k: sum(v) / len(v) for k, v in bare_ms.items()}
        print(f"loop vs bare step on {name} ({smi}), default algorithms: the loop "
              f"{loop_ms:.3f} ms/step, the bare make_train_step {bare[False]:.3f} (two runs of "
              f"{LOOP_BARE_STEPS} steps: {bare_ms[False][0]:.3f} {bare_ms[False][1]:.3f}); the "
              f"loop's overhead {loop_ms - bare[False]:.3f} ms/step; the bare step with "
              f"deterministic algorithms {bare_ms[True][0]:.3f} {bare_ms[True][1]:.3f}", flush=True)

        # -- the eval's parts, and recall@k on a CPU copy of the final params --
        params = s_a["state"].params
        eval_idx = loop.eval_indices(data_cfg, LOOP_SAMPLES, dev)
        batch = gather_batch(data, eval_idx)
        recall_fn = make_eval_recall_fn(cfg, TOPK)
        with torch.no_grad():
            refresh = lambda: refresh_corpus(params, cfg, data.catalog_ids, data.catalog_features)
            corpus = refresh()
            refresh_ms = time_ms(torch, refresh, 5)
            recall_ms = time_ms(torch, lambda: recall_fn(params, corpus, batch), 5)
            cpu_params = copy.deepcopy(params).cpu()
            cpu_corpus = refresh_corpus(cpu_params, cfg, data.catalog_ids.cpu(),
                                        data.catalog_features.cpu())
            cpu_batch = type(batch)(*(None if t is None else t.cpu() for t in batch))
            recall_cpu = float(recall_fn(cpu_params, cpu_corpus, cpu_batch))
            positives = int((batch.labels > 0).any(dim=1).sum())
        del data, batch, corpus, cpu_params, cpu_corpus
        ok_cpu = abs(recall - recall_cpu) <= 2 / 1024
        print(f"loop eval on {name} ({smi}): refresh {refresh_ms:.3f} ms, recall {recall_ms:.3f} "
              f"ms (B={eval_idx.numel()}, {positives} positive, C={LOOP_ITEMS}); recall@{TOPK} "
              f"card {recall:.6f} vs CPU copy {recall_cpu:.6f} (tol 2/1024): ok={ok_cpu}",
              flush=True)
        if not ok_cpu:
            failures.append(f"loop recall card {recall} vs CPU {recall_cpu}")

        # -- checkpoint costs, and 9a's saved state restored --
        state_a = s_a["state"]
        cost = {}
        for mode in (True, False):
            mgr = CheckpointManager(os.path.join(root, f"cost_{mode}"), async_save=mode,
                                    device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(state_a)
            blocking = (time.perf_counter() - t0) * 1e3
            mgr.wait_until_finished()
            total = (time.perf_counter() - t0) * 1e3
            cost[mode] = (blocking, total, os.path.getsize(
                os.path.join(root, f"cost_{mode}", f"step_{steps}.pt")))
            mgr.close()
        mgr = CheckpointManager(os.path.join(root, "a"), device=dev)
        template = create_train_state(args.seed + 1, cfg, experiment(None).train, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore_latest(template)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        mgr.close()
        err_b, _, equal_b = state_diff(torch, restored, state_a)
        del template, restored
        mbps = device_to_host_mbps(dev)
        print(f"loop checkpoint on {name} ({smi}): {cost[True][2]} bytes; async blocking "
              f"{cost[True][0]:.2f} ms, total {cost[True][1]:.2f} ms; sync {cost[False][1]:.2f} "
              f"ms (the probe reads {mbps:.0f} MB/s: async_save=None picks "
              f"{'async' if mbps >= ASYNC_MIN_D2H_MBPS else 'sync'}); restore "
              f"{restore_ms:.2f} ms (the file warm in the page cache); 9a's saved state "
              f"restored bit-equal={equal_b}", flush=True)
        if not equal_b:
            failures.append(f"loop restored state differs from 9a's by {err_b:.3g} of scale")

        # -- 9c: preempted at a step log at or past LOOP_PREEMPT_AT, then
        # the identical call finishes the schedule (default algorithms, as
        # 9a); the first call traces steps 3-7 --
        prof = os.path.join(root, "prof")
        exp_c = experiment(os.path.join(root, "c"), profile_dir=prof)
        flag = threading.Event()
        s_c1 = loop.train(exp_c, loop_recorder(flag, LOOP_PREEMPT_AT), preempt_flag=flag,
                          device=dev)
        at, preempted = int(s_c1["state"].step), s_c1["preempted"]
        del s_c1
        rec_c = loop_recorder()
        s_c = loop.train(exp_c, rec_c, preempt_flag=threading.Event(), device=dev)
        got = [f["step"] for e, f, _ in rec_c.events if e == "restored"]
        err_c, leaf_c, equal_c = state_diff(torch, s_c["state"], state_a, "params.")
        print(f"loop 9c: preempted={preempted} at step {at}, resumed from {got}, epochs "
              f"{s_c['epoch_numbers']}; final params vs 9a's: worst {leaf_c} at {err_c:.3g} of "
              f"its scale, bit-equal={equal_c} (the gate)", flush=True)
        if (not preempted or s_c["preempted"] or got != [at]
                or not LOOP_PREEMPT_AT <= at < 2 * n_batches):
            failures.append(f"loop 9c: preempted={preempted} at {at}, restored {got}")
        if not equal_c:
            failures.append(f"loop 9c final params differ from 9a's: {leaf_c} by {err_c:.3g}")
        del s_c, s_a, state_a, params
        traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
        text = "".join(open(os.path.join(prof, f)).read() for f in traces)
        names = {k: k in text for k in ("encoder_tc_kernel", "ce_fwd_tc_kernel")}
        print(f"loop trace: {len(traces)} file(s), {len(text)} bytes; holds {names}", flush=True)
        if len(traces) != 1 or not all(names.values()):
            failures.append(f"loop trace: {traces}, {names}")

        # -- 9b: 9a's call with three epochs restores step 2n and runs epoch
        # 2: the loop's speed as a user runs it --
        rec_b = loop_recorder()
        s_b = loop.train(experiment(os.path.join(root, "a"), epochs=3), rec_b, device=dev)
        got = [f["step"] for e, f, _ in rec_b.events if e == "restored"]
        lo, hi = 2 * n_batches + LOOP_LOG_EVERY, 3 * n_batches - LOOP_LOG_EVERY
        ms_b = step_ms(rec_b.events, lo, hi)
        print(f"loop 9b on {name} ({smi}), default algorithms: restored {got}, epochs "
              f"{s_b['epoch_numbers']}, loss {s_b['final_loss']:.5f}; steps {lo}-{hi} "
              f"{ms_b:.3f} ms/step, {b / ms_b * 1e3:.0f} examples/s (the bare step "
              f"{bare[False]:.3f}: overhead {ms_b - bare[False]:.3f}); recall@{TOPK} "
              f"{s_b['recall_at_k']:.4f}", flush=True)
        if (got != [2 * n_batches] or s_b["epoch_numbers"] != [2]
                or not math.isfinite(s_b["final_loss"])):
            failures.append(f"loop 9b: restored {got}, epochs {s_b['epoch_numbers']}")
        del s_b

        # -- 9e: the JAX package's round-5 quality anchor at these widths
        # (BASELINE.md:199-209: history and base towers without debiasing,
        # B = 4096 bf16, lr 3e-3, K = 8 steps a dispatch), LOOP_ANCHOR_EPOCHS
        # epochs through the [K, B] dispatch path, default algorithms --
        anchor = dataclasses.replace(cfg, debias=Debias.NONE)
        rec_e = loop_recorder()
        s_e, counts, evals = counted_train(
            torch, loop, experiment(None, epochs=LOOP_ANCHOR_EPOCHS, model=anchor,
                                    learning_rate=3e-3, steps_per_dispatch=8,
                                    eval_every=n_batches), rec_e, dev)
        steps = int(s_e["state"].step)
        check_loop_launches(counts, steps, evals, entries, "anchor_launches", failures, "loop 9e",
                            b18=0)
        lo, hi = n_batches, (LOOP_ANCHOR_EPOCHS - 1) * n_batches
        ms_e = step_ms(rec_e.events, lo, hi)
        losses = s_e["epoch_losses"]
        curve = [round(f["recall_at_k"], 4) for e, f, _ in rec_e.events if e == "eval"]
        print(f"loop 9e, the quality anchor on {name} ({smi}): {steps} steps ({evals} evals: "
              f"launches as 9a's); steps {lo}-{hi} {ms_e:.3f} ms/step, {b / ms_e * 1e3:.0f} "
              f"examples/s; epoch losses {' '.join(f'{v:.4f}' for v in losses)}; recall@{TOPK} "
              f"by epoch {curve}: {s_e['recall_at_k']:.4f}, {s_e['recall_at_k'] / rand:.0f}x "
              f"random (gate: 10x); the JAX package's anchor (BASELINE.md, a TPU v5e run, "
              f"K = 8): loss 1.565 -> 1.271, recall@{TOPK} 0.155", flush=True)
        if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
            failures.append(f"loop 9e losses {losses}")
        if not s_e["recall_at_k"] >= 10 * rand:
            failures.append(f"loop 9e recall@{TOPK} {s_e['recall_at_k']} below 10x random")
        del s_e
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])

    # -- 9d: the trainer CLI, twice, as a subprocess --
    cli = [sys.executable, "-m", "two_tower_models_tpu_torch.training.loop", "--preset",
           "two_tower_with_user_history_encoder", "--num_epochs", "2", "--num_samples",
           str(LOOP_CLI_SAMPLES), "--checkpoint_dir", os.path.join(root, "cli"),
           "--device", str(dev)]
    here = os.path.dirname(os.path.abspath(__file__))
    runs = [subprocess.run(cli, capture_output=True, text=True, timeout=600, cwd=here)
            for _ in range(2)]
    for i, r in enumerate(runs):
        print(f"loop 9d CLI run {i + 1}: rc {r.returncode}; stdout "
              f"{r.stdout.strip().splitlines()}", flush=True)
    ok_d = (all(r.returncode == 0 for r in runs)
            and "Epoch [1/2] - Loss: " in runs[0].stdout
            and "Epoch [2/2] - Loss: " in runs[0].stdout
            and all(f"recall@{TOPK}: " in r.stdout for r in runs)
            and '"event": "restored"' in runs[1].stderr)
    if not ok_d:
        for r in runs:
            print(r.stderr[-2000:], flush=True)
        failures.append("loop 9d: the CLI runs")
    tmp.cleanup()
    print(f"loop: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


def mns_cfg(arm: str):
    """scripts/exp_mns_scale.py's model for ``arm`` (plain, mns+logq,
    stream+mns+logq) at its full scale."""
    from two_tower_models_tpu_torch.config import preset

    return preset(
        "two_tower_with_user_history_encoder", user_id_hash_size=MNS_ROWS,
        item_id_hash_size=MNS_ROWS, user_id_embedding_dim=64, item_id_embedding_dim=64,
        user_features_size=16, item_features_size=16, history_len=HIST,
        compute_dtype="bfloat16", mixed_negatives=MNS_NEGATIVES if arm.endswith("mns+logq") else 0,
        logq_correction=arm != "plain",
    )


def mns_exp(arm: str, epochs: int, ckpt=None, **train):
    """scripts/exp_mns_scale.py's experiment for ``arm`` at seed 42: Zipf(1.0)
    engagement, B = 4096, lr 1e-3, grad_clip_norm 1.0, 8 steps a dispatch."""
    from two_tower_models_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig

    model = mns_cfg(arm)
    data = DataConfig(num_samples=MNS_SAMPLES, num_users=MNS_ROWS, num_items=MNS_ROWS,
                      feature_dim=16, history_len=HIST, num_tasks=model.num_tasks,
                      structured=True, popularity_skew=1.0, seed=42)
    train = {"batch_size": TRAIN_BATCH, "num_epochs": epochs, "learning_rate": 1e-3,
             "grad_clip_norm": 1.0, "seed": 42, "steps_per_dispatch": 8,
             "streaming_logq": arm.startswith("stream"), "checkpoint_dir": ckpt,
             "log_every": LOOP_LOG_EVERY, **train}
    return ExperimentConfig(model=model, data=data, train=TrainConfig(**train))


def check_only_launches(counts: dict, expect: dict, n: int, failures: list, label: str) -> None:
    """``expect``'s launches a step over n steps, and no launch of any other
    kernel."""
    check_launches(counts, expect, n, failures, label)
    other = {k: v for k, v in counts.items() if v and k not in expect}
    if other:
        failures.append(f"{label} launched other kernels: {other}")


def head_tail_recall(torch, cfg, params, corpus, data, seed: int) -> dict:
    """scripts/exp_mns_scale.py's head_tail_recall: recall@100 over the
    engaged examples among MNS_EVAL held out (a permutation from seed + 100),
    and apart for head items (id < 0.2 C, the top-20% of the Zipf ranks)
    and tail items; counts summed on the device, read once."""
    from two_tower_models_tpu_torch.config import resolve_kernel_flags
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact
    from two_tower_models_tpu_torch.training.data import gather_batch

    dev = corpus.device
    cfg = resolve_kernel_flags(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 100)
    eval_idx = torch.randperm(data.num_samples, generator=gen, device=dev)[:MNS_EVAL]
    head_cut = int(0.2 * data.catalog_ids.shape[0])
    totals = torch.zeros(6, dtype=torch.int64, device=dev)
    b = TRAIN_BATCH
    with torch.no_grad():
        for i in range(MNS_EVAL // b):
            bt = gather_batch(data, eval_idx[i * b:(i + 1) * b])
            u, _ = tt.compute_user_embedding(params, cfg, bt.user_id, bt.user_features,
                                             bt.user_history, bt.history_len)
            ind, _, _ = mips_topk_exact(corpus, u, TOPK)
            hit = (ind == bt.item_id[:, None]).any(1)
            engaged = (bt.labels[:, :cfg.num_tasks] > 0).any(1)
            head = bt.item_id < head_cut
            for j, m in enumerate((engaged, engaged & head, engaged & ~head)):
                totals[2 * j] += (hit & m).sum()
                totals[2 * j + 1] += m.sum()
    h, n, hh, nh, ht, nt = totals.tolist()
    return {"recall": h / max(n, 1), "head": hh / max(nh, 1), "tail": ht / max(nt, 1),
            "engaged": n, "n_head": nh, "n_tail": nt}


def phase_mns(torch, args, smi, dev, entries, failures) -> None:
    """Phase 10: mixed negatives and the logQ correction at
    scripts/exp_mns_scale.py's width (10a the CE kernels on the route's
    operands, 10b the step and its lazy form, 10c the streaming estimator,
    10d the loop and exact resume, 10e quality), all with the default
    algorithms."""
    import dataclasses
    import math
    import os
    import tempfile

    from two_tower_models_tpu_torch.config import resolve_kernel_flags
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import fused_softmax as fs
    from two_tower_models_tpu_torch.training import loop
    from two_tower_models_tpu_torch.training.checkpoint import state_tensors
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.freq_estimator import freq_update, init_freq_estimator
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import _extend_and_track, make_train_step

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    b, c, d = TRAIN_BATCH, TRAIN_BATCH + MNS_NEGATIVES, 64 + 1
    data_cfg = mns_exp("plain", 1).data
    data = make_synthetic_data(data_cfg, label_cols=1, device=dev)
    n_batches = MNS_SAMPLES // b
    perm = loop.epoch_permutation(42, 0, MNS_SAMPLES, dev)
    idx_of = lambda i: perm[(i % n_batches) * b:(i % n_batches + 1) * b]
    single = lambda arm, **kw: dataclasses.replace(mns_exp(arm, 1).train, steps_per_dispatch=1, **kw)
    cfg = resolve_kernel_flags(mns_cfg("mns+logq"), dev)
    tc = single("mns+logq")

    # -- 10a: B10 and B11 + B12 on one real step's augmented operands --
    state = create_train_state(args.seed + 10, cfg, tc, device=dev, catalog_size=MNS_ROWS)
    model = state.params
    with torch.no_grad():
        batch, _ = _extend_and_track(cfg, tc, state, data, gather_batch(data, idx_of(0)))
        u, _ = tt.compute_user_embedding(model, cfg, batch.user_id, batch.user_features,
                                         batch.user_history)
        items = tt.compute_item_embeddings(model, cfg, batch.item_id, batch.item_features)
        negs = tt.compute_item_embeddings(model, cfg, batch.neg_item_id, batch.neg_item_features)
        nuv, _ = tt.example_weights(model, cfg, u, batch.position, batch.labels)
        au, ap = tt.logq_operands(u, *tt._extended_pool(items, negs, batch.item_logq,
                                                         batch.neg_logq))
    g = nuv / b  # the cotangent of ce in the loss
    if au.shape != (b, d) or ap.shape != (c, d):
        failures.append(f"mns operands {tuple(au.shape)}, {tuple(ap.shape)}")
    ce_k, lse_k = fs.in_batch_ce_fwd(au, ap, False)
    _, lse_p = fs.in_batch_ce_fwd_plain(au, ap, False)
    ok_f, err_f = close(lse_k, lse_p, 0.0, 1e-5 * float(lse_p.abs().max()))
    rep_f = all(torch.equal(x, y) for x, y in zip(fs.in_batch_ce_fwd(au, ap, False), (ce_k, lse_k)))
    lse64 = torch.logsumexp(au.double() @ ap.double().T, 1)
    f64 = [float((t.double() - lse64).abs().max()) / float(lse64.abs().max()) for t in (lse_k, lse_p)]
    del lse64
    term = float(g.abs().max()) * max(float(au.abs().max()), float(ap.abs().max()))
    got, want = fs.in_batch_ce_bwd(au, ap, lse_k, g, False), fs.in_batch_ce_bwd_plain(
        au, ap, lse_p, g, False)
    checks = [close(x, y, 0.0, 1e-5 * max(float(y.abs().max()), term)) for x, y in zip(got, want)]
    again = fs.in_batch_ce_bwd(au, ap, lse_k, g, False)
    rep_b = all(torch.equal(x, y) for x, y in zip(got, again))
    del want, again
    ok_a = ok_f and rep_f and f64[0] <= 1e-5 and all(ok for ok, _ in checks) and rep_b
    print(f"mns 10a: CE forward (B10) at B={b}, C={c}, D={d} (no diagonal) vs plain: max_abs_err "
          f"{err_f:.3g} (tol 1e-5 of scale); from f64 sums, share of max |lse|: kernel "
          f"{f64[0]:.3g}, plain {f64[1]:.3g} (tol 1e-5); bit-equal on repeat={rep_f}; CE backward "
          f"(dU, dI) max_abs_err {[float(f'{e:.3g}') for _, e in checks]} (tol 1e-5 of scale); "
          f"bit-equal on repeat={rep_b}; ok={ok_a}", flush=True)
    if not ok_a:
        failures.append("mns 10a: the CE kernels at the logQ width")
    u64, i64 = au[:, :64].contiguous(), ap[:b, :64].contiguous()
    ua, pa = au.clone().requires_grad_(), ap.clone().requires_grad_()
    with torch.enable_grad():
        lse_lib = torch.logsumexp(ua @ pa.T, 1)
    fwd = lambda: fs.in_batch_ce_fwd(au, ap, False)
    bwd = lambda: fs.in_batch_ce_bwd(au, ap, lse_k, g, False)
    lib_fwd = lambda: torch.logsumexp(au @ ap.T, 1)
    lib_bwd = lambda: torch.autograd.grad(lse_lib, (ua, pa), g, retain_graph=True)
    f_bound = bound((b + c) * d * 4 + 2 * b * 4, 3 * 2 * b * c * d, TF32_FLOPS)
    b_bound = bound(2 * (b + c) * d * 4 + 2 * b * 4, 6 * b * c * d, F32_FLOPS)
    e_f = {"shape": [b, c, d], "max_abs_err": err_f, "f64_err": f64[0], "plain_f64_err": f64[1],
           "ms": time_ms(torch, fwd), "device_ms": device_ms(torch, fwd, "ce_fwd_tc_kernel"),
           "plain_ms": time_ms(torch, lambda: fs.in_batch_ce_fwd_plain(au, ap, False)),
           "library_ms": time_ms(torch, lib_fwd), "library_device_ms": call_device_ms(torch, lib_fwd),
           "flagship_device_ms": device_ms(torch, lambda: fs.in_batch_ce_fwd(u64, i64),
                                           "ce_fwd_tc_kernel"),
           "bound_ms": f_bound[0], "bound_by": f_bound[1],
           "splits": fs.fwd_plan(b, c, d, _lib.sm_count(torch.cuda.current_device()))}
    e_b = {"shape": [b, c, d], "max_abs_err": max(e for _, e in checks),
           "ms": time_ms(torch, bwd), "device_ms": call_device_ms(torch, bwd),
           "plain_ms": time_ms(torch, lambda: fs.in_batch_ce_bwd_plain(au, ap, lse_k, g, False)),
           "library_ms": time_ms(torch, lib_bwd), "library_device_ms": call_device_ms(torch, lib_bwd),
           "flagship_device_ms": call_device_ms(torch, lambda: fs.in_batch_ce_bwd(
               u64, i64, fs.in_batch_ce_fwd(u64, i64)[1], g)),
           "bound_ms": b_bound[0], "bound_by": b_bound[1]}
    del ua, pa, lse_lib, got
    print(f"B10 at B={b}, C={c}, D={d} on {name} ({smi}): device {e_f['device_ms']:.4f} ms "
          f"({e_f['splits']} splits), with the host's dispatch {e_f['ms']:.4f}; the (4096, 4096, "
          f"64) instance in this call {e_f['flagship_device_ms']:.4f}; plain {e_f['plain_ms']:.4f}; "
          f"library (logsumexp of U I^T) device {e_f['library_device_ms']:.4f}, "
          f"{e_f['library_ms']:.4f} with dispatch; bound {e_f['bound_ms']:.4f} "
          f"({e_f['bound_by']}, 3xTF32)", flush=True)
    print(f"B11 + B12 at B={b}, C={c}, D={d} on {name} ({smi}): device {e_b['device_ms']:.4f} ms "
          f"(kernel and reduce), with the host's dispatch {e_b['ms']:.4f}; the (4096, 4096, 64) "
          f"instance in this call {e_b['flagship_device_ms']:.4f}; plain {e_b['plain_ms']:.4f}; "
          f"library (autograd's backward of logsumexp of U I^T) device "
          f"{e_b['library_device_ms']:.4f}, {e_b['library_ms']:.4f} with dispatch; bound "
          f"{e_b['bound_ms']:.4f} ({e_b['bound_by']})", flush=True)
    entries["fused_in_batch_ce"]["logq_width"] = e_f
    entries["in_batch_ce_bwd"]["logq_width"] = e_b
    del state, model, batch, u, items, negs, au, ap, u64, i64
    torch.cuda.empty_cache()

    # -- 10b: the mns+logq step beside the plain arm, then the lazy path --
    per_step = {"fused_history_encoder_res": 1, "fused_history_encoder_res_tc": 1,
                "fused_history_encoder_bwd": 1, "fused_history_encoder_bwd_tc": 1,
                "fused_history_encoder_bwd_reduce": 1, "fused_in_batch_ce": 1,
                "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1}
    idx = idx_of(1)
    steps, states, ms, busy = {}, {}, {}, {}
    for arm in ("mns+logq", "plain"):
        tca = single(arm)
        steps[arm] = make_train_step(mns_cfg(arm), tca)
        states[arm] = create_train_state(args.seed + 11, mns_cfg(arm), tca, device=dev,
                                         catalog_size=MNS_ROWS)
        states[arm] = run_steps(torch, steps[arm], states[arm], data, idx, 3)[0]
    for i, arm in enumerate(("mns+logq", "plain", "plain", "mns+logq")):
        states[arm], metrics, ms_step, _, counts = run_steps(torch, steps[arm], states[arm], data,
                                                             idx, MNS_STEPS)
        ms.setdefault(arm, []).append(ms_step)
        if not finite(torch, metrics):
            failures.append(f"mns 10b {arm} metrics not finite")
        if i == 0:
            print(f"launches on the mns+logq path ({MNS_STEPS} steps): {json.dumps(counts)}",
                  flush=True)
            check_only_launches(counts, per_step, MNS_STEPS, failures, "mns 10b")
            for k in ("fused_in_batch_ce", "in_batch_ce_bwd"):
                entries[k]["logq_launches"] = counts.get(k, 0)
            entries["in_batch_ce_bwd"]["logq_reduce_launches"] = counts.get(
                "in_batch_ce_bwd_reduce", 0)
            loss = (float(metrics[0]["loss"]), float(metrics[-1]["loss"]))
    for arm in ("mns+logq", "plain"):
        states[arm], busy[arm] = trace_steps(torch, steps[arm], states[arm], data, idx,
                                             f"mns 10b {arm}")
    states["mns+logq"], syncs = count_syncs(torch, steps["mns+logq"], states["mns+logq"], data, idx)
    if syncs:
        failures.append(f"mns 10b: {syncs} host syncs in a step")
    fmt = lambda v: "not measured" if v is None else f"{v:.3f}"
    print(f"mns 10b on {name} ({smi}): mns+logq {ms['mns+logq'][0]:.3f} {ms['mns+logq'][1]:.3f} "
          f"ms/step, plain {ms['plain'][0]:.3f} {ms['plain'][1]:.3f} (order mns plain plain mns, "
          f"{MNS_STEPS} steps of B={b} each); device busy ms a step (three profiled steps): "
          f"mns+logq {fmt(busy['mns+logq'])}, plain {fmt(busy['plain'])}; host syncs in a "
          f"mns+logq step {syncs}; loss {loss[0]:.5f} -> {loss[1]:.5f}", flush=True)
    st = states["mns+logq"]
    with torch.no_grad():
        sub, _ = _extend_and_track(cfg, tc, st, data, gather_batch(data, idx[:CHECK_BATCH]))
    # The two leaves that are zero in exact arithmetic are held to 0: under
    # bf16 compute item_features_mlp.1.b sums one bf16-rounded cotangent per
    # pool item (the item head's input cast), and with no debias weights
    # and Zipf duplicates that noise is about 1.7e-3 of the top leaf on both
    # sides, where one rounding flipped by an f32 sum order moves it by
    # more than the ZERO_GRAD_FLOOR allowance.
    grads_vs_cpu(torch, st.params, cfg, data, idx, failures, "mns 10b", sub=sub, zero_exact=True)
    del steps, states, st, sub
    torch.cuda.empty_cache()

    lazy_tc = single("mns+logq", lazy_table_adam=True, grad_clip_norm=None)
    dense_tc = single("mns+logq", grad_clip_norm=None)
    st_l = create_train_state(args.seed + 12, cfg, lazy_tc, device=dev, catalog_size=MNS_ROWS)
    st_d = create_train_state(args.seed + 12, cfg, dense_tc, device=dev, catalog_size=MNS_ROWS)
    step_l = make_train_step(cfg, lazy_tc)
    with torch.enable_grad():
        st_l, _ = step_l(st_l, data, idx)
        st_d, _ = make_train_step(cfg, dense_tc)(st_d, data, idx)
    got, want = table_tensors(st_l), table_tensors(st_d)
    got.update((n, p.detach()) for n, p in st_l.params.named_parameters())
    want.update((n, p.detach()) for n, p in st_d.params.named_parameters())
    worst, bad = 0.0, []
    for k in want:
        ok, err = close(got[k], want[k], 1e-5, 1e-7)
        worst = max(worst, err)
        if not ok:
            bad.append(k)
    del st_d, got, want
    st_l = run_steps(torch, step_l, st_l, data, idx, 2)[0]
    st_l, metrics, ms_lazy, _, counts = run_steps(torch, step_l, st_l, data, idx, MNS_LAZY_STEPS)
    check_only_launches(counts, per_step, MNS_LAZY_STEPS, failures, "mns 10b lazy")
    st_l, syncs_l = count_syncs(torch, step_l, st_l, data, idx)
    print(f"mns 10b lazy on {name} ({smi}): first lazy step vs first dense step from one state "
          f"and one draw, every parameter and table moment: max_abs_err {worst:.3g} (rtol 1e-5, "
          f"atol 1e-7), mismatched {bad}; {MNS_LAZY_STEPS} steps {ms_lazy:.3f} ms/step; launches "
          f"{json.dumps(counts)}; host syncs in a step {syncs_l}", flush=True)
    if bad or syncs_l or not finite(torch, metrics):
        failures.append(f"mns 10b lazy: mismatched {bad}, {syncs_l} syncs")
    del st_l
    torch.cuda.empty_cache()

    # -- 10c: the streaming estimator against a CPU recompute --
    s_cfg, s_tc = mns_cfg("stream+mns+logq"), single("stream+mns+logq")
    st = create_train_state(args.seed + 13, s_cfg, s_tc, device=dev, catalog_size=MNS_ROWS)
    step = make_train_step(s_cfg, s_tc)
    with torch.enable_grad():
        for i in range(MNS_STEPS):
            st, _ = step(st, data, idx_of(i))
    st, syncs_s = count_syncs(torch, step, st, data, idx_of(MNS_STEPS))
    est = init_freq_estimator(MNS_ROWS)
    catalog = data.catalog_ids.cpu()
    for i in range(MNS_STEPS + 1):
        est = freq_update(est, torch.searchsorted(catalog, data.item_ids[idx_of(i)].cpu()),
                          s_tc.logq_decay)
    counts_c, total_c = (t.cpu() for t in st.logq_state)
    ok_c, err_c = close(counts_c, est.counts, 1e-6, 0.0)
    ok_t, _ = close(total_c, est.total, 1e-6, 0.0)
    exact = torch.equal(counts_c, est.counts) and torch.equal(total_c, est.total)
    print(f"mns 10c on {name} ({smi}): stream+mns+logq, {MNS_STEPS + 1} steps on as many batches: "
          f"the estimator vs a CPU recompute from the batches' item ids: counts max_abs_err "
          f"{err_c:.3g} (rtol 1e-6), total {float(total_c):.4f} vs {float(est.total):.4f}, "
          f"bit-equal={exact}; host syncs in a step {syncs_s}", flush=True)
    if not (ok_c and ok_t) or syncs_s:
        failures.append("mns 10c: the streaming estimator")
    del st, step
    torch.cuda.empty_cache()

    # -- 10d: the loop, a checkpoint each epoch, and the epoch-1 checkpoint
    # resumed; the data, which each run makes anew, made twice --
    again = make_synthetic_data(data_cfg, label_cols=1, device=dev)
    data_equal = all(x is None and y is None or torch.equal(x, y) for x, y in zip(data, again))
    del again
    tmp = tempfile.TemporaryDirectory(prefix="mns_", dir=_lib.BUILD_DIR)
    ckpt = os.path.join(tmp.name, "d")
    exp_d = mns_exp("stream+mns+logq", 2, ckpt, checkpoint_every=n_batches)
    rec_a = loop_recorder()
    s_a = loop.train(exp_d, rec_a, device=dev)
    os.remove(os.path.join(ckpt, f"step_{2 * n_batches}.pt"))
    rec_b = loop_recorder()
    s_b = loop.train(exp_d, rec_b, device=dev)
    got_r = [f["step"] for e, f, _ in rec_b.events if e == "restored"]
    err_d, leaf_d, equal_d = state_diff(torch, s_b["state"], s_a["state"])
    t_a, t_b = (state_tensors(x["state"]) for x in (s_a, s_b))
    differ = [k for k in t_a if not torch.equal(t_a[k], t_b[k])]
    lo, hi = n_batches + LOOP_LOG_EVERY, 2 * n_batches - LOOP_LOG_EVERY
    loop_ms = step_ms(rec_a.events, lo, hi)
    bare = sum(ms["mns+logq"]) / 2
    print(f"mns 10d on {name} ({smi}), default algorithms: stream+mns+logq through the loop, 2 "
          f"epochs, K = 8: losses {' '.join(f'{v:.5f}' for v in s_a['epoch_losses'])}; steps "
          f"{lo}-{hi} {loop_ms:.3f} ms/step, {b / loop_ms * 1e3:.0f} examples/s (10b's bare step, "
          f"K = 1: {bare:.3f} ms/step, {b / bare * 1e3:.0f} examples/s); resumed from {got_r}, "
          f"epochs {s_b['epoch_numbers']}: params, moments, rng and logq_state vs the "
          f"uninterrupted run's: worst {leaf_d} at {err_d:.3g} of its scale, "
          f"bit-equal={equal_d} (the gate; {len(differ)} tensors differ: {differ[:8]}); the data "
          f"made twice bit-equal={data_equal}", flush=True)
    if got_r != [n_batches] or s_b["epoch_numbers"] != [1] or not (equal_d and data_equal):
        failures.append(f"mns 10d: restored {got_r}, epochs {s_b['epoch_numbers']}, "
                        f"bit-equal {equal_d} ({differ[:8]}), data {data_equal}")
    del s_a, s_b, t_a, t_b
    tmp.cleanup()
    torch.cuda.empty_cache()

    # -- 10e: quality, mns+logq against plain --
    rec_q, ms_q = {}, {}
    for arm in ("mns+logq", "plain"):
        rec = loop_recorder()
        s = loop.train(mns_exp(arm, MNS_EPOCHS), rec, device=dev)
        ms_q[arm] = step_ms(rec.events, n_batches, (MNS_EPOCHS - 1) * n_batches)
        rec_q[arm] = head_tail_recall(torch, mns_cfg(arm), s["state"].params, s["corpus"], data, 42)
        rec_q[arm]["losses"] = [round(v, 4) for v in s["epoch_losses"]]
        if not all(math.isfinite(v) for v in s["epoch_losses"]):
            failures.append(f"mns 10e {arm} losses {s['epoch_losses']}")
        del s
        torch.cuda.empty_cache()
        r = rec_q[arm]
        print(f"mns 10e {arm} on {name} ({smi}): {MNS_EPOCHS} epochs, {ms_q[arm]:.3f} ms/step; "
              f"epoch losses {' '.join(f'{v:.4f}' for v in r['losses'])}; recall@{TOPK} "
              f"{r['recall']:.4f} over {r['engaged']} engaged of {MNS_EVAL} held out (head "
              f"{r['head']:.4f} of {r['n_head']}, tail {r['tail']:.4f} of {r['n_tail']}); the JAX "
              f"package's (BASELINE.md:624, a TPU v5e run) {MNS_JAX_RECALL[arm]}", flush=True)
    mns, plain = rec_q["mns+logq"]["recall"], rec_q["plain"]["recall"]
    ok_q = mns >= 0.25 and mns >= 5 * plain
    print(f"mns 10e: mns+logq recall@{TOPK} {mns:.4f} vs plain {plain:.4f} (gate: >= 0.25 and >= 5x "
          f"plain): ok={ok_q}; the JAX package's {MNS_JAX_RECALL['mns+logq']} vs "
          f"{MNS_JAX_RECALL['plain']}", flush=True)
    if not ok_q:
        failures.append(f"mns 10e recall {mns} vs plain {plain}")
    entries["fused_in_batch_ce"]["mns_quality"] = rec_q
    print(f"mns: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


def zoo_cfg(name: str, **kw):
    """scripts/bench_presets.py:39-70's model for preset ``name``: 65,536-row
    tables, D = 64, 16 features, T = 3, H = 32 on the whole-encoder kernel,
    bf16, the fused loss; LightRankerConfig()'s NI = 50, NU = 4."""
    import dataclasses

    from two_tower_models_tpu_torch.config import preset

    cfg = preset(name, user_id_hash_size=TRAIN_ROWS, user_id_embedding_dim=64,
                 item_id_hash_size=TRAIN_ROWS, item_id_embedding_dim=64, user_features_size=16,
                 item_features_size=16, user_value_weights=(1.0, 0.5, 0.25), history_len=HIST,
                 compute_dtype="bfloat16", fused_loss=True, **kw)
    return dataclasses.replace(
        cfg, history_encoder=dataclasses.replace(cfg.history_encoder, fused_encoder=True))


def zoo_train_launches(cfg) -> dict:
    """A training step's launches for ``cfg``: B5, B6 and its reduce, B18 for
    the position table, and B10, B11 + B12 and its reduce unless the loss
    takes precomputed scores (the reward model); none of any other kernel."""
    ce = 0 if cfg.reward_model else 1
    return {"fused_history_encoder_res": 1, "fused_history_encoder_res_tc": 1,
            "fused_history_encoder_bwd": 1, "fused_history_encoder_bwd_tc": 1,
            "fused_history_encoder_bwd_reduce": 1, "rows_scatter_add": POS_B18,
            "fused_in_batch_ce": ce, "in_batch_ce_bwd": ce, "in_batch_ce_bwd_reduce": ce}


def zoo_metric_names(cfg) -> set:
    names = {"loss", "softmax_ce", "debias_aux_loss", "nuv_mean", "grad_norm"}
    if cfg.light_ranker is not None:
        names.add("light_ranker_bce")
    if cfg.kd:
        names.add("kd_loss")
    if cfg.reward_model:
        names |= {"reward_kl", "proxy_ranker_bce"}
    return names


def phase_zoo(torch, args, smi, dev, entries, failures, b56_ms, busy56, serve_ms) -> None:
    """Phase 11: the light ranker, KD and the reward model at
    scripts/bench_presets.py's width (11a the three training steps, 11b
    with mixed negatives and logQ, 11c the light ranker's serving, 11d the
    trainer CLI's exact resume and the zoo builders)."""
    import dataclasses
    import os
    import tempfile

    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig, resolve_kernel_flags
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.models import zoo
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk, topk_ordered
    from two_tower_models_tpu_torch.serving import RetrievalEngine
    from two_tower_models_tpu_torch.training import loop
    from two_tower_models_tpu_torch.training.checkpoint import state_tensors
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import _extend_and_track, make_train_step

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    b = TRAIN_BATCH
    train_cfg = TrainConfig(batch_size=b, learning_rate=1e-3)
    fmt = lambda v: "not measured" if v is None else f"{v:.3f}"

    # -- 11a: the three presets' training steps --
    trained = {}
    for preset_name in ZOO_PRESETS:
        short = ZOO_SHORT[preset_name]
        label = f"train-65k-{short}"
        cfg = zoo_cfg(preset_name)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 20)
        state = create_train_state(gen, cfg, train_cfg, device=dev)
        data = fixed_batch(torch, gen, dev, cfg, b)
        if cfg.kd:  # scripts/bench_presets.py:67-70: the soft labels are half the hard ones
            data = data._replace(labels=torch.cat([data.labels, 0.5 * data.labels], 1))
        idx = torch.arange(b, device=dev)
        step = make_train_step(cfg, train_cfg)
        state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, 3)
        torch.cuda.reset_peak_memory_stats()
        state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx,
                                                           TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        metrics += timed
        expect = zoo_train_launches(cfg)
        print(f"launches on the {label} path ({TRAIN_STEPS} steps): {json.dumps(counts)}",
              flush=True)
        check_only_launches(counts, expect, TRAIN_STEPS, failures, label)
        for k, per in expect.items():
            if k in entries and per:
                entries[k][f"launches_{label}"] = counts.get(k, 0)
        if not finite(torch, metrics) or set(metrics[0]) != zoo_metric_names(cfg):
            failures.append(f"{label} metrics {sorted(metrics[0])}, finite {finite(torch, metrics)}")
        state, busy = trace_steps(torch, step, state, data, idx, label)
        state, syncs = count_syncs(torch, step, state, data, idx)
        if syncs:
            failures.append(f"{label}: {syncs} host syncs in a step")
        first, last = metrics[0], metrics[-1]
        terms = " ".join(f"{k} {float(first[k]):.5f}->{float(last[k]):.5f}"
                         for k in sorted(zoo_metric_names(cfg) - {"grad_norm", "nuv_mean"}))
        print(f"{label} on {name} ({smi}): {TRAIN_STEPS} steps of B={b}: ms/step {ms_step:.3f}, "
              f"examples/s {b / ms_step * 1e3:.0f}; host wall {host_ms:.3f} ms/step; device busy "
              f"{fmt(busy)} ms/step (three profiled steps); peak device memory {peak:.2f} GiB; "
              f"host syncs in a step {syncs}; the flagship's step in this call (phase 4) "
              f"{b56_ms[0]:.3f} ms/step, busy {fmt(busy56)}; {terms}", flush=True)
        grads_vs_cpu(torch, state.params, cfg, data, idx, failures, label)
        trained[preset_name] = (cfg, state.params)
        del state, step, data, metrics, timed
        torch.cuda.empty_cache()

    # -- 11b: mixed negatives and oracle logQ (phase 10's settings) --
    kw = dict(mixed_negatives=MNS_NEGATIVES, logq_correction=True)
    for preset_name in ("two_tower_plus_light_ranker_kd", "two_tower_with_main_ranker_reward"):
        label = f"zoo 11b {ZOO_SHORT[preset_name]} mns+logq"
        cfg = resolve_kernel_flags(zoo_cfg(preset_name, **kw), dev)
        data_cfg = DataConfig(num_samples=ZOO_MNS_SAMPLES, num_users=MNS_ROWS, num_items=MNS_ROWS,
                              feature_dim=16, history_len=HIST, num_tasks=cfg.num_tasks,
                              popularity_skew=1.0, seed=42)
        data = make_synthetic_data(data_cfg, label_cols=cfg.num_tasks * (2 if cfg.kd else 1),
                                   device=dev)
        tc = dataclasses.replace(train_cfg, grad_clip_norm=1.0)
        state = create_train_state(args.seed + 21, cfg, tc, device=dev, catalog_size=MNS_ROWS)
        step = make_train_step(cfg, tc)
        idx = torch.arange(b, device=dev)
        state = run_steps(torch, step, state, data, idx, 1)[0]  # a warm-up step
        state, metrics, ms_step, _, counts = run_steps(torch, step, state, data, idx, 1)
        expect = zoo_train_launches(cfg)
        print(f"launches on the {label} path (1 step): {json.dumps(counts)}", flush=True)
        check_only_launches(counts, expect, 1, failures, label)
        if not finite(torch, metrics):
            failures.append(f"{label} metrics not finite")
        with torch.no_grad():
            sub, _ = _extend_and_track(cfg, tc, state, data, gather_batch(data, idx[:CHECK_BATCH]))
        if sub.neg_item_id.shape != (MNS_NEGATIVES,) or sub.item_logq is None:
            failures.append(f"{label}: the batch was not extended")
        print(f"{label} on {name} ({smi}): one step of B={b} with {MNS_NEGATIVES} mixed "
              f"negatives, {ms_step:.3f} ms; loss {float(metrics[0]['loss']):.5f}; the CE "
              f"kernels {'not launched: precomputed scores' if cfg.reward_model else 'at (4096, 4160, 65)'}",
              flush=True)
        grads_vs_cpu(torch, state.params, cfg, data, idx, failures, label, sub=sub)
        del state, step, data, sub
        torch.cuda.empty_cache()

    # -- 11c: the light ranker's serving, from 11a's trained model --
    cfg, model = trained["two_tower_plus_light_ranker"]
    cfg = resolve_kernel_flags(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 22)
    catalog_ids = torch.arange(CORPUS, device=dev) % TRAIN_ROWS  # the 65,536-row item table
    catalog_feats = torch.randn(CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, catalog_ids, catalog_feats, device=dev)
    engine.warmup(BATCH)
    corpus = engine.corpus
    batches = [(torch.randint(0, cfg.user_id_hash_size, (BATCH,), generator=gen, device=dev),
                torch.randn(BATCH, 16, generator=gen, device=dev),
                torch.randint(0, TRAIN_ROWS, (BATCH, HIST), generator=gen, device=dev))
               for _ in range(args.batches)]
    _lib.reset_launch_counts()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in batches]
    outs = []
    for (s, e), (u, f, h) in zip(evs, batches):
        s.record()
        outs.append(engine.query(u, f, h))
        e.record()
    torch.cuda.synchronize()
    counts = dict(_lib.launches)
    ms = [s.elapsed_time(e) for s, e in evs]
    label = "serve-1M-exact-lightranker"
    print(f"launches on the {label} path: {json.dumps(counts)}", flush=True)
    expect = {"fused_history_encoder": 1, "fused_history_encoder_tc": 1, **MIPS_ROUTE}
    check_only_launches(counts, expect, len(batches), failures, label)
    for k in expect:
        if k in entries:
            entries[k][f"launches_{label}"] = counts.get(k, 0)
    cpu_model = copy.deepcopy(model).cpu()
    corpus_cpu = corpus.cpu()
    cfg_cpu = resolve_kernel_flags(cfg, "cpu")
    n_items, ni = cfg.num_items, cfg.light_ranker.num_mips_items
    margin_rows, mismatched, checked, rerank_ties = 0, 0, 0, 0
    for (u, f, h), got in zip(batches, outs):
        if got.shape != (BATCH, n_items) or int(got.min()) < 0 or int(got.max()) >= CORPUS:
            failures.append(f"{label} output shape/range")
        with torch.inference_mode():
            q, ranker = tt.compute_user_embedding(model, cfg, u, f, h)
            q, ranker = q[:ZOO_CHECK_ROWS].cpu(), ranker[:ZOO_CHECK_ROWS].cpu()
            cand, sc, emb = mips_topk(corpus_cpu, q, ni + 1)
            value = tt.rerank_values(cpu_model, cfg_cpu, ranker, sc[:, :ni], emb[:, :ni])
            top_v, top_i = topk_ordered(value, n_items + 1)
            want = torch.gather(cand, 1, top_i[:, :n_items])
        # a clear row: its 10th and 11th rerank values, and its NI-th and
        # (NI + 1)-th MIPS scores (which set the candidates), apart by more
        # than 1e-5 of the row's scale
        clear = ((top_v[:, n_items - 1] - top_v[:, n_items]) > 1e-5 * value.abs().amax(1))
        mips_clear = (sc[:, ni - 1] - sc[:, ni]) > 1e-5 * sc[:, 0].abs()
        rerank_ties += int((~clear).sum())
        clear &= mips_clear
        margin_rows += int(clear.sum())
        checked += ZOO_CHECK_ROWS
        same = (torch.sort(got[:ZOO_CHECK_ROWS].cpu()[clear], 1).values
                == torch.sort(want[clear], 1).values)
        mismatched += int((~same).any(1).sum())
    u, f, h = (t[:32] for t in batches[0])
    with torch.inference_mode():
        g_q, g_r = tt.compute_user_embedding(model, cfg, u, f, h)
        c_q, c_r = tt.compute_user_embedding(cpu_model, cfg_cpu, u.cpu(), f.cpu(), h.cpu())
    ok_q, err_q = close(torch.cat([g_q, g_r.flatten(1)], 1).cpu(), torch.cat([c_q, c_r.flatten(1)], 1),
                        3e-2, 3e-2)
    if mismatched or not margin_rows or not ok_q:
        failures.append(f"{label}: {mismatched} of {margin_rows} clear rows mismatched, "
                        f"embeddings ok={ok_q}")
    ms_batch = sum(ms) / len(ms)
    print(f"{label} on {name} ({smi}): {len(batches)} batches of B={BATCH} over C={CORPUS}, "
          f"MIPS k={cfg.light_ranker.num_mips_items} then the rerank to {n_items}: ms/batch mean "
          f"{ms_batch:.3f} min {min(ms):.3f} max {max(ms):.3f}; QPS {BATCH / ms_batch * 1e3:.0f}; "
          f"phase 3's exact serving (k={TOPK}) {serve_ms:.3f} ms/batch in this call; indices vs "
          f"the CPU copy on the card's user and ranker embeddings, {ZOO_CHECK_ROWS} rows a batch: "
          f"{mismatched} mismatched (as sets) of {margin_rows} rows whose 10th and 11th rerank "
          f"values, and {ni}th and {ni + 1}st MIPS scores, differ by more than 1e-5 of the row's "
          f"scale ({checked - margin_rows} of {checked} excluded, {rerank_ties} of them by the "
          f"rerank values); "
          f"user and ranker embeddings card vs CPU max_abs_err {err_q:.3g} (tol 3e-2)", flush=True)
    del engine, corpus, corpus_cpu, cpu_model, batches, outs, trained
    torch.cuda.empty_cache()

    # -- 11d: the trainer CLI, one epoch with a checkpoint, then its resume,
    # against the uninterrupted run in this process --
    tmp = tempfile.TemporaryDirectory(prefix="zoo_", dir=_lib.BUILD_DIR)
    ckpt = os.path.join(tmp.name, "cli")
    argv = ["--preset", "two_tower_plus_light_ranker_kd", "--num_samples", str(ZOO_CLI_SAMPLES),
            "--num_users", str(LOOP_USERS), "--num_items", str(LOOP_ITEMS),
            "--user_id_hash_size", str(LOOP_USERS), "--item_id_hash_size", str(LOOP_ITEMS),
            "--embedding_dim", "64", "--feature_dim", "16", "--user_history_seqlen", str(HIST),
            "--batch_size", str(b), "--compute_dtype", "bfloat16", "--device", str(dev)]
    cli = [sys.executable, "-m", "two_tower_models_tpu_torch.training.loop", *argv,
           "--checkpoint_dir", ckpt]
    here = os.path.dirname(os.path.abspath(__file__))
    runs = [subprocess.run(cli + ["--num_epochs", str(e)], capture_output=True, text=True,
                           timeout=600, cwd=here) for e in (1, 2)]
    for i, r in enumerate(runs):
        print(f"zoo 11d CLI run {i + 1}: rc {r.returncode}; stdout "
              f"{r.stdout.strip().splitlines()}", flush=True)
    n_batches = ZOO_CLI_SAMPLES // b
    exp = loop.config_from_args(loop.build_argparser().parse_args(argv + ["--num_epochs", "2"]))
    whole = loop.train(exp, loop_recorder(), device=dev)
    path = os.path.join(ckpt, f"step_{2 * n_batches}.pt")
    ok_files = all(r.returncode == 0 for r in runs) and os.path.exists(path)
    differ = ["the CLI runs"]
    if ok_files:
        got = torch.load(path, map_location="cpu", weights_only=True)
        want = {k: v.detach().cpu() for k, v in state_tensors(whole["state"]).items()}
        differ = sorted(set(got) ^ set(want)) + [k for k in want if k in got
                                                  and not torch.equal(got[k], want[k])]
    restored = '"event": "restored"' in runs[1].stderr if ok_files else False
    print(f"zoo 11d on {name} ({smi}): the CLI (--preset two_tower_plus_light_ranker_kd, "
          f"{ZOO_CLI_SAMPLES} samples, {n_batches} steps an epoch) one epoch, then two epochs on "
          f"its checkpoint (restored={restored}) against two epochs in this process: "
          f"{len(differ)} tensors differ {differ[:8]} (the gate: bit-equal); losses "
          f"{[round(v, 5) for v in whole['epoch_losses']]}", flush=True)
    if differ or not restored or "Epoch [2/2] - Loss: " not in runs[1].stdout:
        for r in runs:
            print(r.stderr[-2000:], flush=True)
        failures.append(f"zoo 11d: resume not bit-equal ({differ[:8]}) or not restored")
    del whole
    tmp.cleanup()
    torch.cuda.empty_cache()

    # -- 11d: each builder of models/zoo.py on the card --
    widths = dict(user_id_hash_size=TRAIN_ROWS, user_id_embedding_dim=64,
                  item_id_hash_size=TRAIN_ROWS, item_id_embedding_dim=64, user_features_size=16,
                  item_features_size=16, user_value_weights=(1.0, 0.5, 0.25),
                  compute_dtype="bfloat16")
    hist = {"user_history_seqlen": HIST}
    ranker = {**hist, "num_mips_items": 50, "num_ranker_user_embeddings": 4}
    builders = {"two_tower_base_retrieval": {}, "two_tower_with_user_history_encoder": hist,
                "two_tower_with_position_debiased_weights": hist,
                "two_tower_with_user_debiased_weights": hist, "two_tower_with_debiasing": hist,
                "two_tower_plus_light_ranker": ranker, "two_tower_plus_light_ranker_with_kd": ranker,
                "two_tower_with_main_ranker_reward": hist}
    ok_b = []
    for bname, extra in builders.items():
        handle = getattr(zoo, bname)(**widths, **extra)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 23)
        params = handle.init(gen)
        data = fixed_batch(torch, gen, dev, handle.cfg, b)
        if handle.cfg.kd:
            data = data._replace(labels=torch.cat([data.labels, 0.5 * data.labels], 1))
        batch = gather_batch(data, torch.arange(b, device=dev))
        with torch.enable_grad():
            loss, _ = handle.train_forward(params, batch)
            loss.backward()
        with torch.no_grad():
            corpus = handle.compute_item_embeddings(params, torch.arange(TRAIN_ROWS, device=dev),
                                                    torch.randn(TRAIN_ROWS, 16, generator=gen,
                                                                device=dev))
        top = handle.forward(params, corpus, batch.user_id[:BATCH], batch.user_features[:BATCH],
                             batch.user_history[:BATCH])
        good = (bool(torch.isfinite(loss)) and top.shape == (BATCH, handle.cfg.num_items)
                and top.device.type == "cuda" and int(top.max()) < TRAIN_ROWS
                and params.item_id_table.grad is not None)
        ok_b.append(good)
        if not good:
            failures.append(f"zoo builder {bname}")
        del params, data, batch, corpus
    print(f"zoo 11d builders on {name}: init, train_forward (B={b}, backward) and forward "
          f"(B={BATCH} over {TRAIN_ROWS} items) of each of {len(builders)}: ok {ok_b}", flush=True)
    torch.cuda.empty_cache()
    print(f"zoo: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)

def approx_nonfinite_check(torch, dev) -> tuple[bool, str]:
    """12a's exact input: an integer-grid corpus (every finite score exact)
    whose rows score +-inf and NaN as in nonfinite_check, and valid_count
    below C; for the int8 instance integer rows whose scale is +inf or NaN
    of either sign on the same rows; the bf16 instance the corpus's bf16
    copy (exact).  N1 against its plain version bit for bit, values as
    int32 keys and rows, on the tensor cores (f32, int8, bf16 rows) and on
    the FMA kernel forced (f32, int8)."""
    from two_tower_models_tpu_torch.ops import approx_topk as at
    from two_tower_models_tpu_torch.ops import mips_topk as mt

    b, c, d, m = 256, 1 << 18, 64, 2048
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    corpus = torch.randint(-2, 3, (c, d), generator=gen, device=dev).float()
    query = torch.randint(-2, 3, (b, d), generator=gen, device=dev).float()
    query[: b // 2, 0] = 0
    inf_rows = torch.arange(0, 300, device=dev) * mt.TILE + 5
    ninf_rows = torch.arange(300, 400, device=dev) * mt.TILE + 7
    corpus[inf_rows, 0] = float("inf")
    corpus[ninf_rows, 1] = float("-inf")
    bits = corpus.view(torch.int32)
    bits[3, 2] = -(1 << 22)  # 0xFFC00000, a negative NaN
    bits[77_777, 5] = 0x7FC00000  # a positive NaN
    rows8 = torch.randint(-127, 128, (c, d), generator=gen, device=dev).to(torch.int8)
    scale = torch.rand(c, generator=gen, device=dev) * 0.09 + 0.01
    scale[::7] = 0.5
    scale[inf_rows] = float("inf")
    scale[ninf_rows] = float("-inf")
    scale.view(torch.int32)[3] = -(1 << 22)
    scale.view(torch.int32)[77_777] = 0x7FC00000
    out = []
    for route, label, rows, sc in (("tc", "f32", corpus, None), ("tc", "int8", rows8, scale),
                                   ("tc", "bf16", corpus.to(torch.bfloat16), None),
                                   ("fma", "f32", corpus, None), ("fma", "int8", rows8, scale)):
        for valid in (c, c - 3000):
            got = at.approx_scan(query, rows, m, valid, sc, force=route)
            want = at.approx_scan_plain(query, rows, m, valid, sc)
            out.append((f"{route} {label} valid={valid}", torch.equal(got[1], want[1])
                        and torch.equal(mt.f32_keys(got[0]), mt.f32_keys(want[0]))))
    return all(ok for _, ok in out), "; ".join(f"{k} {ok}" for k, ok in out)


def bin_margins(torch, q, rows, m, scale, tol):
    """Per (query, bin) of the plain scan: its best score minus the second
    best (+inf where the bin has one row), and whether that exceeds
    ``tol`` [B, 1]; a query chunk at a time."""
    b, c = q.shape[0], rows.shape[0]
    w = -(-c // m)
    rf = rows.float()
    clear = []
    for b0 in range(0, b, 64):
        s = q[b0 : b0 + 64] @ rf.T
        if scale is not None:
            s = s * scale[None, :]
        s = torch.nn.functional.pad(s, (0, w * m - c), value=float("-inf"))
        top2 = torch.topk(s.view(s.shape[0], w, m), 2, dim=1).values
        clear.append((top2[:, 0] - top2[:, 1]) > tol[b0 : b0 + 64])
    return torch.cat(clear)


def phase_approx(torch, args, smi, dev, entry, entries, failures, serve_ms: float,
                 b2_device_ms: float, ptxas: dict) -> None:
    """Phase 12: approximate and int8 MIPS at scripts/bench_serving.py's
    width (12a N1 alone, 12b the four engine legs, 12c the exact scans at
    scripts/bench_mips.py's width)."""
    import dataclasses

    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import approx_topk as at
    from two_tower_models_tpu_torch.ops import mips_topk as mt
    from two_tower_models_tpu_torch.retrieval import mips as rm
    from two_tower_models_tpu_torch.retrieval.quant import (
        QuantizedCorpus,
        mips_topk_quantized,
        quantize_corpus,
    )
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    cfg, gen, model, engine, batches = serve_setup(torch, args, dev)
    corpus = engine.corpus
    b, c, d = BATCH, CORPUS, corpus.shape[1]
    with torch.inference_mode():
        q, _ = tt.compute_user_embedding(model, cfg, *batches[0])
    qc = quantize_corpus(corpus)

    # -- 12a: N1 alone on phase 3's user embeddings and corpus: both kernels --
    res, errs = {}, []
    cb = corpus.to(torch.bfloat16)
    kernel = {"tc": "approx_scan_tc_kernel", "fma": "approx_scan_kernel"}
    m_k = {k: at.approx_bins(c, k, cfg.mips_recall_target) for k in (TOPK, 4 * TOPK)}
    for inst, k, rows, sc in (("f32", TOPK, corpus, None), ("int8", TOPK, qc.q, qc.scale),
                              ("bf16", TOPK, cb, None), ("f32", 4 * TOPK, corpus, None),
                              ("int8", 4 * TOPK, qc.q, qc.scale)):
        m = m_k[k]
        w = c // m
        want = at.approx_scan_plain(q, rows, m, None, sc)
        tol = 1e-5 * want[0].abs().amax(dim=1, keepdim=True)
        clear = bin_margins(torch, q, rows, m, sc, tol)
        r = {"route": at.scan_route(d, inst), "rows_left_out": int((~clear).sum())}
        for rt in kernel:
            got = at.approx_scan(q, rows, m, None, sc, force=rt)
            err = float((got[0] - want[0]).abs().max())
            bad = int(((got[1] != want[1]) & clear).sum())
            r[rt] = {"ok": bool(((got[0] - want[0]).abs() <= tol).all()) and bad == 0,
                     "max_abs_err": err, "rows_mismatched": bad, "device_ms": []}
            errs.append(err)
            del got
        fns = {rt: (lambda rt=rt: at.approx_scan(q, rows, m, None, sc, force=rt)) for rt in kernel}
        for rt in ("fma", "tc", "tc", "fma"):  # in turns, in this one call
            r[rt]["device_ms"].append(device_ms(torch, fns[rt], kernel[rt]))
        lib = (lambda: (q @ rows.T).view(b, w, m).amax(1)) if inst == "f32" else \
            (lambda: (q @ rows.float().T).view(b, w, m).amax(1)) if sc is None else \
            (lambda: (q @ rows.float().T * sc[None, :]).view(b, w, m).amax(1))
        row_bytes = {"f32": d * 4, "int8": d + 4, "bf16": d * 2}[inst]
        n_prod = 3 if inst == "f32" else 2
        bytes_ = b * d * 4 + c * row_bytes + b * m * 8
        r.update(ms=time_ms(torch, lambda: at.approx_scan(q, rows, m, None, sc)),
                 plain_ms=time_ms(torch, lambda: at.approx_scan_plain(q, rows, m, None, sc), 2),
                 library_ms=time_ms(torch, lib, 3),
                 bound_tc=bound(bytes_, n_prod * 2 * b * c * d, TF32_FLOPS),
                 bound_fma=bound(bytes_, 2 * b * c * d, F32_FLOPS),
                 tc_plan=at.tc_plan(b, d, inst))
        r["speedup"] = min(r["fma"]["device_ms"]) / max(r["tc"]["device_ms"])
        r["ok"] = r["tc"]["ok"] and r["fma"]["ok"] and r["route"] == "tc"
        res[f"{inst}_M{m}"] = r
        print(f"N1 {inst} rows at B={b}, C={c}, D={d}, M={m} (k={k}) on {name} ({smi}): route "
              f"{r['route']} (plan {r['tc_plan']}); device ms tc {r['tc']['device_ms']}, fma "
              f"{r['fma']['device_ms']} (in turns fma, tc, tc, fma): {r['speedup']:.2f}x at the "
              f"least; bounds {n_prod}xTF32 {r['bound_tc'][0]:.4f} ({r['bound_tc'][1]}), f32 FMA "
              f"{r['bound_fma'][0]:.4f}; tc values vs plain ok={r['tc']['ok']} max_abs_err "
              f"{r['tc']['max_abs_err']:.3g}, rows mismatched {r['tc']['rows_mismatched']}; fma "
              f"ok={r['fma']['ok']} max_abs_err {r['fma']['max_abs_err']:.3g}, rows mismatched "
              f"{r['fma']['rows_mismatched']} (tol 1e-5 of each query's scale; "
              f"{r['rows_left_out']} of {b * m} pairs left out); routed with the host's dispatch "
              f"{r['ms']:.4f}; plain {r['plain_ms']:.3f}; library (matmul + amax over the bins) "
              f"{r['library_ms']:.3f}", flush=True)
        del want, clear
    del cb
    ok_nf, nf_line = approx_nonfinite_check(torch, dev)
    b2_now = device_ms(torch, lambda: mt.tile_max_scores(q, corpus, mt.TILE, c),
                       "tile_max_kernel")
    print(f"N1 on an integer grid with +-inf and NaN rows, bit-equal to plain: {nf_line}; B2 in "
          f"this call {b2_now:.4f} ms device (phase 2: {b2_device_ms:.4f}); ptxas "
          + " | ".join(f"{k}: {'; '.join(v)}" for k, v in sorted(ptxas.items())), flush=True)
    m0 = f"f32_M{m_k[TOPK]}"
    r0 = res[m0]
    entry("approx_scan", "two_tower_models_tpu_torch/csrc/approx_scan.cu",
          "two_tower_models_tpu/retrieval/mips.py:356 (lax.approx_max_k; no pl.pallas_call site)",
          all(r["ok"] for r in res.values()) and ok_nf, max(errs), r0["ms"], r0["plain_ms"],
          b * d * 4 + c * d * 4 + b * m_k[TOPK] * 8, 6 * b * c * d, TF32_FLOPS, r0["library_ms"])
    en = entries["approx_scan"]
    en.update(device_ms=sum(r0["tc"]["device_ms"]) / 2, kernel_route=r0["route"],
              fma_device_ms=sum(r0["fma"]["device_ms"]) / 2, fma_bound_ms=r0["bound_fma"][0],
              instances=res, nonfinite_exact=ok_nf, b2_device_ms_this_call=b2_now, ptxas=ptxas,
              note=f"ms (routed, with the host's dispatch), plain, library and bound are the "
                   f"approx_mips leg's instance ({m0}: f32 rows, M bins for k = 100) on the routed "
                   "kernel, approx_scan_tc_kernel (3xTF32 wgmma; bound at TF32_FLOPS); "
                   "device_ms its device time, fma_* the FMA kernel (approx_scan_kernel) forced "
                   "on the same input, fma_bound_ms the f32 FMA bound; instances holds each row "
                   "kind (f32 and int8 at M = 2048 for k = 100 and 8192 for the rescore pool of "
                   "400, bf16 at 2048) on both kernels; library is q @ rows^T (int8 and bf16 rows "
                   "widened, int8 times the scale) and amax over the bins; launches counts N1 "
                   "launches in 12b, tc_launches those on the tensor cores")
    torch.cuda.empty_cache()

    t_12b = time.perf_counter()

    # -- 12b: the four engine legs of scripts/bench_serving.py --
    approx = dataclasses.replace(cfg, approx_mips=True)
    serve_only = {"fused_history_encoder": 1, "fused_history_encoder_tc": 1}
    legs = (("exact", cfg, None, {**serve_only, **MIPS_ROUTE}),
            ("approx_mips", approx, None, {**serve_only, **N1_TC, "select_topk_radix": 1}),
            ("approx_int8", approx, "int8", {**serve_only, **N1_TC, "select_topk_radix": 1}),
            ("approx_int8_rescore", approx, "int8_rescore",
             {**serve_only, **N1_TC, "select_topk_radix": 1}))
    gates = {"approx_mips": cfg.mips_recall_target, "approx_int8": 0.90,
             "approx_int8_rescore": cfg.mips_recall_target}
    exact_out, n_approx, n_tc, summary = None, 0, 0, {}
    corpus_cpu = corpus.cpu()
    for label, lcfg, quant, expect in legs:
        eng = RetrievalEngine(model, lcfg, corpus, quantize=quant, device=dev)
        eng.warmup(BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _lib.reset_launch_counts()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in batches]
        outs = []
        for (s, e), (u, f, h) in zip(evs, batches):
            s.record()
            outs.append(eng.query(u, f, h))
            e.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = dict(_lib.launches)
        ms = [s.elapsed_time(e) for s, e in evs]
        check_only_launches(counts, expect, len(batches), failures, f"serve {label}")
        n_approx += counts.get("approx_scan", 0)
        n_tc += counts.get("approx_scan_tc", 0)
        if peak >= 1 << 30:
            failures.append(f"serve {label}: peak {peak / 2**30:.2f} GiB above the corpus")
        if any(o.shape != (BATCH, TOPK) or int(o.min()) < 0 or int(o.max()) >= CORPUS
               for o in outs):
            failures.append(f"serve {label} output shape/range")
        recall = None
        if exact_out is None:
            exact_out = outs
        else:
            hits = sum(len(set(g) & set(r)) for go, ro in zip(outs, exact_out)
                       for g, r in zip(go.tolist(), ro.tolist()))
            recall = hits / (len(outs) * BATCH * TOPK)
            if recall < gates[label]:
                failures.append(f"serve {label}: recall {recall:.4f} < {gates[label]}")
        # a CPU copy of the leg's MIPS, fed the card's user embeddings; the
        # margins from the card's own bin values (and rescored pool)
        left_out, mismatched, checked = 0, 0, 0
        lc = eng.corpus
        ccorp = corpus_cpu if quant is None else QuantizedCorpus(*(
            None if t is None else t.cpu() for t in lc))
        pool = TOPK * (4 if quant == "int8_rescore" else 1)
        rows_d, sc_d = (lc, None) if quant is None else (lc.q, lc.scale)
        for (u, f, h), got in zip(batches, outs):
            with torch.inference_mode():
                qd, _ = tt.compute_user_embedding(model, lcfg, u, f, h)
            qd = qd[:ZOO_CHECK_ROWS]
            qq = qd.cpu()
            if label == "exact":
                rsc = rm.mips_topk(lc, qd, TOPK + 1)[1]
                clear = (rsc[:, TOPK - 1] - rsc[:, TOPK]) > 1e-5 * rsc[:, 0].abs()
                ridx, _, _ = rm.mips_topk(ccorp, qq, TOPK)
            else:
                m = at.approx_bins(c, pool, lcfg.mips_recall_target)
                top = torch.topk(at.approx_scan(qd, rows_d, m, None, sc_d)[0], pool + 1).values
                clear = (top[:, pool - 1] - top[:, pool]) > 1e-5 * top[:, 0].abs()
                if quant == "int8_rescore":  # and the rescored pool's k-th and (k+1)-th
                    _, pre_i = at.approx_max_k(qd, rows_d, pool, lcfg.mips_recall_target,
                                               scale=sc_d)
                    ex = torch.einsum("bmd,bd->bm", lc.raw[pre_i].float(), qd)
                    top = torch.topk(ex, TOPK + 1, dim=1).values
                    clear &= (top[:, TOPK - 1] - top[:, TOPK]) > 1e-5 * top[:, 0].abs()
                if quant is None:
                    ridx, _, _ = rm.mips_topk_approx(ccorp, qq, TOPK, lcfg.mips_recall_target)
                else:
                    ridx, _, _ = mips_topk_quantized(ccorp, qq, TOPK, lcfg.mips_recall_target)
            clear = clear.cpu()
            g = torch.sort(got[:ZOO_CHECK_ROWS].cpu()[clear], 1).values
            mismatched += int((g != torch.sort(ridx[clear], 1).values).any(1).sum())
            left_out += int((~clear).sum())
            checked += ZOO_CHECK_ROWS
        if mismatched:
            failures.append(f"serve {label}: {mismatched} rows differ from the CPU copy")
        ms_batch = sum(ms) / len(ms)
        summary[label] = {"ms_batch": ms_batch, "ms_median": statistics.median(ms),
                          "qps": BATCH / ms_batch * 1e3, "recall": recall,
                          "peak_gib": peak / 2**30, "launches": counts}
        vs_exact = "" if label == "exact" else (
            f" (the exact leg {summary['exact']['ms_batch']:.3f}: "
            f"{ms_batch / summary['exact']['ms_batch']:.3f} of it)")
        print(f"serve {label} on {name} ({smi}): {len(batches)} batches of B={BATCH} over C={c}, "
              f"k={TOPK}: ms/batch mean {ms_batch:.3f}{vs_exact} median "
              f"{summary[label]['ms_median']:.3f} min {min(ms):.3f} max {max(ms):.3f}; QPS "
              f"{BATCH / ms_batch * 1e3:.0f}; recall@{TOPK} vs the exact leg "
              f"{'-' if recall is None else f'{recall:.4f}'} (gate "
              f"{gates.get(label, '-')}); peak {peak / 2**30:.3f} GiB above the corpus; launches "
              f"{json.dumps(counts)}; vs a CPU copy on {ZOO_CHECK_ROWS} rows a batch: {mismatched} "
              f"mismatched of {checked - left_out} ({left_out} left out within 1e-5 of scale)",
              flush=True)
        del eng, outs
        torch.cuda.empty_cache()
    en["launches"] = n_approx
    en["tc_launches"] = n_tc
    en["serving_legs"] = summary
    print(f"serve legs on {name} ({smi}): " + "; ".join(
        f"{k} {v['ms_batch']:.3f} ms/batch (median {v['ms_median']:.3f}), recall {v['recall']}"
        for k, v in summary.items())
        + f" (phase 3's exact leg {serve_ms:.3f}); approximate legs below the exact leg, by the "
        "mean and by the median: " + ", ".join(
            f"{k} {v['ms_batch'] < summary['exact']['ms_batch']} "
            f"{v['ms_median'] < summary['exact']['ms_median']}"
            for k, v in summary.items() if k != "exact"), flush=True)
    del engine, corpus, corpus_cpu, qc, batches, model
    torch.cuda.empty_cache()

    t_12c = time.perf_counter()

    # -- 12c: the exact scans at scripts/bench_mips.py's width --
    g2 = torch.Generator(device=dev)
    g2.manual_seed(args.seed + 12)
    cm = torch.randn(MIPS_C, 64, generator=g2, device=dev).to(torch.bfloat16)
    qm = torch.randn(BATCH, 64, generator=g2, device=dev).to(torch.bfloat16)
    ref_i, _, _ = rm.mips_topk_exact(cm, qm, TOPK)
    scans = {"tilemax": lambda: rm.mips_topk_exact_tilemax(cm, qm, TOPK),
             "segmented64": lambda: rm.mips_topk_segmented(cm, qm, TOPK, 64),
             "segmented256": lambda: rm.mips_topk_segmented(cm, qm, TOPK, 256),
             "chunked": lambda: rm.chunked_mips_topk(cm, qm, TOPK, 131072)}
    scan_res = {"exact": {"ms": time_ms(torch, lambda: rm.mips_topk_exact(cm, qm, TOPK), 3)}}
    for sname, fn in scans.items():
        idx, _, _ = fn()
        same = torch.equal(idx, ref_i)
        scan_res[sname] = {"equal": same, "rows_differ": int((idx != ref_i).any(1).sum()),
                           "ms": time_ms(torch, fn, 3)}
        if not same:
            failures.append(f"mips scan {sname}: indices differ from mips_topk_exact")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _lib.reset_launch_counts()
    ai, _, _ = rm.mips_topk_approx(cm, qm, TOPK, 0.95)  # N1 on the bf16 rows as they are
    torch.cuda.synchronize()
    c95 = dict(_lib.launches)
    if c95.get("approx_scan_tc", 0) != 1:
        failures.append(f"mips scan approx95: N1 not once on the tensor cores ({c95})")
    rec95 = sum(len(set(a) & set(r)) for a, r in zip(ai.tolist(), ref_i.tolist())) / ref_i.numel()
    scan_res["approx95"] = {"recall": rec95, "launches": c95,
                            "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
                            "ms": time_ms(torch, lambda: rm.mips_topk_approx(cm, qm, TOPK, 0.95), 3)}
    if rec95 < 0.95:
        failures.append(f"mips scan approx95: recall {rec95:.4f} < 0.95")
    en["exact_scans"] = scan_res
    print(f"mips scans at C={MIPS_C}, D=64 bf16, B={BATCH}, k={TOPK} on {name} ({smi}): " + "; ".join(
        f"{k} {v['ms']:.3f} ms" + (f" indices = mips_topk_exact's {v['equal']} ({v['rows_differ']} "
                                   f"rows differ)" if "equal" in v else "")
        + (f" recall {v['recall']:.4f}, peak {v['peak_mib']:.1f} MiB above its inputs, "
           f"launches {v['launches']}" if "recall" in v else "") for k, v in scan_res.items()),
        flush=True)
    del cm, qm
    torch.cuda.empty_cache()
    t_end = time.perf_counter()
    print(f"approx: phase wall {t_end - t_phase:.1f} s (set-up and 12a {t_12b - t_phase:.1f}, "
          f"12b {t_12c - t_12b:.1f}, 12c {t_end - t_12c:.1f})", flush=True)


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo gives its first processor: the model
    name, or where /proc masks it ("unknown") the vendor, family, model
    and clock; the machine's product name where /sys shows it; and the
    cores this process may use."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break
                key, _, value = ln.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"model name masked: {info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
                f"{info.get('cpu MHz', '?')} MHz")
    try:
        with open("/sys/devices/virtual/dmi/id/product_name") as f:
            name += f", in a {f.read().strip()}"
    except OSError:
        pass
    return f"{name} ({platform.machine()}), {len(os.sched_getaffinity(0))} cores"


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of one call of ``fn`` (host work, no device)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fallback_slots(native, keys, size: int, seed: int):
    """``keys``' slots through the numpy fallback, whatever their kind."""
    import numpy as np

    arr = np.asarray(keys)
    if arr.dtype.kind == "u":
        return native.hash_ids(arr, size, seed=seed, force_fallback=True)
    return native.hash_strings(list(arr.reshape(-1)), size, seed=seed,
                               force_fallback=True).reshape(arr.shape)


def raw_cpu_check(torch, cfg, model, cpu_model, corpus, corpus_cpu, slots, feats, got,
                  raw_keys=None) -> tuple:
    """serve_leg's rule on the first ZOO_CHECK_ROWS rows of one batch: the
    CPU copy's user embeddings against the card's (3e-2), and the CPU's
    exact MIPS fed the card's embeddings, index sets equal on every row
    whose k-th and (k+1)-th card scores differ by more than 1e-5 of scale.
    With ``raw_keys`` (user keys, history keys) the CPU copy hashes them with
    the numpy fallback, and its slots must be the card's.  Returns (slots
    equal, embedding error, rows mismatched, rows left out)."""
    from two_tower_models_tpu_torch import native
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.retrieval import mips as rm
    from two_tower_models_tpu_torch.training import ingest

    r = ZOO_CHECK_ROWS
    u, h = (t[:r] for t in slots)
    f = feats[:r]
    same_slots = True
    if raw_keys is None:
        u_cpu, h_cpu = u.cpu(), h.cpu()
    else:
        uk, hk = raw_keys
        u_cpu = torch.as_tensor(fallback_slots(native, uk[:r], cfg.user_id_hash_size,
                                               ingest.USER_TABLE_SEED))
        h_cpu = torch.as_tensor(fallback_slots(native, hk[:r], cfg.item_id_hash_size,
                                               ingest.ITEM_TABLE_SEED))
        same_slots = torch.equal(u_cpu, u.cpu()) and torch.equal(h_cpu, h.cpu())
    with torch.inference_mode():
        q, _ = tt.compute_user_embedding(model, cfg, u, f, h)
        q_cpu, _ = tt.compute_user_embedding(cpu_model, cfg, u_cpu, f.cpu(), h_cpu)
        rsc = rm.mips_topk(corpus, q, TOPK + 1)[1]
        ridx, _, _ = rm.mips_topk(corpus_cpu, q.cpu(), TOPK)
    _, err = close(q.cpu(), q_cpu, 3e-2, 3e-2)
    clear = ((rsc[:, TOPK - 1] - rsc[:, TOPK]) > 1e-5 * rsc[:, TOPK - 1].abs()).cpu()
    g = torch.sort(got[:r].cpu()[clear], 1).values
    mismatched = int((g != torch.sort(ridx[clear], 1).values).any(1).sum())
    return same_slots, err, mismatched, int((~clear).sum())


def phase_raw(torch, args, smi, dev, entries, failures, serve_ms: float) -> None:
    """Phase 13: raw-key ingest (13a the hasher, 13b raw-key serving, 13c
    ingested training) and reference-checkpoint interop (13d), and the
    port's raw-key example (13e)."""
    import ctypes
    from pathlib import Path

    import numpy as np

    from two_tower_models_tpu_torch import interop, native
    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.serving import RetrievalEngine
    from two_tower_models_tpu_torch.training import ingest
    from two_tower_models_tpu_torch.training.data import SyntheticRecData
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    t_phase = time.perf_counter()
    name, cpu = torch.cuda.get_device_name(0), host_cpu()
    rec = {"host_cpu": cpu}

    # -- 13a: the host hasher --
    so = native.library_path()
    built = so is not None and native.BUILD_DIR.resolve() in so.resolve().parents
    print(f"hasher 13a: C++ path available {native.native_available()}, library {so} "
          f"(under the port's _build/: {built}); host CPU {cpu}", flush=True)
    if not built:
        print(f"hasher 13a: the C++ build failed:\n{native.build_error()}", flush=True)
        failures.append("13a: the C++ hasher is not built under the port's _build/")
        return
    rng = np.random.default_rng(args.seed + 130)
    catalog = np.array([f"sku-{i:07d}" for i in range(CORPUS)])
    users = np.array([f"user:{i:06d}@example.com" for i in range(RAW_USERS)])
    u64 = rng.integers(0, 1 << 64, RAW_U64_KEYS, dtype=np.uint64)
    u64[:2] = [0, (1 << 64) - 1]
    sample = list(catalog[rng.choice(CORPUS, RAW_CHECK_KEYS, replace=False)])
    agree = {
        "str": bool(np.array_equal(
            native.hash_strings(sample, CORPUS, seed=ingest.ITEM_TABLE_SEED),
            native.hash_strings(sample, CORPUS, seed=ingest.ITEM_TABLE_SEED, force_fallback=True))),
        "u64": all(bool(np.array_equal(native.hash_ids(u64, size, seed=seed),
                                       native.hash_ids(u64, size, seed=seed, force_fallback=True)))
                   for size, seed in ((CORPUS, ingest.ITEM_TABLE_SEED),
                                      (RAW_USERS, ingest.USER_TABLE_SEED))),
    }
    if not all(agree.values()):
        failures.append(f"13a: the C++ path and the fallback disagree: {agree}")
    cfg, fcfg = serve_cfg(), flagship_cfg(TRAIN_ROWS)
    pick = lambda keys, *shape: keys[rng.integers(0, len(keys), shape)]
    rand64 = lambda *shape: rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    sb = {"str": (pick(users, BATCH), pick(catalog, BATCH, HIST)),
          "u64": (rand64(BATCH), rand64(BATCH, HIST))}
    fb = {"str": (pick(users, TRAIN_BATCH), pick(catalog[:TRAIN_ROWS], TRAIN_BATCH),
                  pick(catalog[:TRAIN_ROWS], TRAIN_BATCH, HIST)),
          "u64": (rand64(TRAIN_BATCH), rand64(TRAIN_BATCH), rand64(TRAIN_BATCH, HIST))}
    u64_catalog = rand64(CORPUS)
    times = {}
    for kind in ("str", "u64"):
        times[kind] = {
            "serve_batch_ms": host_ms(lambda: (ingest.hash_user_keys(sb[kind][0], cfg),
                                               ingest.hash_item_keys(sb[kind][1], cfg))),
            "flagship_batch_ms": host_ms(lambda: ingest.ingest_example_keys(fcfg, *fb[kind])),
            "catalog_ms": host_ms(lambda: ingest.hash_item_keys(
                catalog if kind == "str" else u64_catalog, cfg), 3),
        }
    # the catalog's hash call alone, its keys already one byte blob
    lib = native._load()
    raw = [k.encode() for k in catalog]
    blob = np.frombuffer(b"".join(raw), np.uint8)
    offsets = np.zeros(len(raw) + 1, np.int64)
    np.cumsum([len(k) for k in raw], out=offsets[1:])
    out = np.empty(len(raw), np.uint32)
    ptr = lambda a, c: a.ctypes.data_as(ctypes.POINTER(c))
    times["str"]["catalog_call_alone_ms"] = host_ms(lambda: lib.hash_ids_bytes(
        ptr(blob, ctypes.c_uint8), ptr(offsets, ctypes.c_int64), len(raw),
        ingest.ITEM_TABLE_SEED, CORPUS, ptr(out, ctypes.c_uint32)), 3)
    del raw, blob
    rec["hasher"] = {"agree_with_fallback": agree, "library": str(so), "host_ms": times}
    print(f"hasher 13a on {cpu} (card {name}, {smi}): C++ path and numpy fallback agree on "
          f"{RAW_CHECK_KEYS} catalog string keys {agree['str']} and {RAW_U64_KEYS} uint64 keys "
          f"{agree['u64']}; host ms (median of 5; the catalog of 3), strings | uint64: serving "
          f"batch ({BATCH} + {BATCH}x{HIST} keys) {times['str']['serve_batch_ms']:.3f} | "
          f"{times['u64']['serve_batch_ms']:.3f}; flagship batch ({TRAIN_BATCH} + {TRAIN_BATCH} + "
          f"{TRAIN_BATCH}x{HIST}) {times['str']['flagship_batch_ms']:.3f} | "
          f"{times['u64']['flagship_batch_ms']:.3f}; catalog ({CORPUS}) "
          f"{times['str']['catalog_ms']:.3f} | {times['u64']['catalog_ms']:.3f}, of which the "
          f"string hash call alone {times['str']['catalog_call_alone_ms']:.3f}", flush=True)

    # -- 13b: serve-1M-raw and serve-1M-raw-u64 --
    t_13b = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 131)
    model = tt.init_params(gen, cfg, device=dev)
    cat_slots = ingest.hash_item_keys(catalog, cfg)
    collided = 1 - len(np.unique(cat_slots)) / CORPUS
    engine = RetrievalEngine.from_params(
        model, cfg, torch.as_tensor(cat_slots, device=dev),
        torch.randn(CORPUS, 16, generator=gen, device=dev), device=dev)
    engine.warmup(BATCH)
    corpus = engine.corpus
    corpus_cpu, cpu_model = corpus.cpu(), copy.deepcopy(model).cpu()
    expect = {"fused_history_encoder": 1, "fused_history_encoder_tc": 1, **MIPS_ROUTE}
    legs = {}
    for leg, kind in (("serve-1M-raw", "str"), ("serve-1M-raw-u64", "u64")):
        batches = []
        for _ in range(args.batches):
            keys = (pick(users, BATCH), pick(catalog, BATCH, HIST)) if kind == "str" else (
                rand64(BATCH), rand64(BATCH, HIST))
            batches.append((keys[0], torch.randn(BATCH, 16, generator=gen, device=dev), keys[1]))
        engine.query_raw(*batches[0])  # warm-up
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        native.reset_calls()
        outs, raw_ms = [], []
        for uk, f, hk in batches:
            t0 = time.perf_counter()
            outs.append(engine.query_raw(uk, f, hk))
            torch.cuda.synchronize()
            raw_ms.append((time.perf_counter() - t0) * 1e3)
        counts, calls = dict(_lib.launches), dict(native.calls)
        check_only_launches(counts, expect, len(batches), failures, leg)
        if calls != {"cpp": 2 * len(batches)}:
            failures.append(f"{leg}: the hasher's calls {calls}, not C++ only")
        hash_ms, q_ms, unequal, slots = [], [], 0, []
        for uk, _, hk in batches:
            t0 = time.perf_counter()
            us, hs = ingest.hash_user_keys(uk, cfg), ingest.hash_item_keys(hk, cfg)
            hash_ms.append((time.perf_counter() - t0) * 1e3)
            slots.append((torch.as_tensor(us, device=dev), torch.as_tensor(hs, device=dev)))
        torch.cuda.synchronize()
        for (us, hs), (_, f, _), got in zip(slots, batches, outs):
            t0 = time.perf_counter()
            want = engine.query(us, f, hs)
            torch.cuda.synchronize()
            q_ms.append((time.perf_counter() - t0) * 1e3)
            unequal += not torch.equal(got, want)
        if unequal or any(o.shape != (BATCH, TOPK) for o in outs):
            failures.append(f"{leg}: {unequal} batches of query_raw differ from query on the slots")
        bad_slots, errs, mismatched, left_out = 0, [], 0, 0
        for (us, hs), (uk, f, hk), got in zip(slots, batches, outs):
            same, err, mm, lo = raw_cpu_check(torch, cfg, model, cpu_model, corpus, corpus_cpu,
                                              (us, hs), f, got, (uk, hk))
            bad_slots += not same
            errs.append(err)
            mismatched += mm
            left_out += lo
        if bad_slots or mismatched or max(errs) > 3e-2:
            failures.append(f"{leg} vs the CPU copy: {bad_slots} batches' slots differ, "
                            f"{mismatched} rows mismatched, embeddings {max(errs):.3g}")
        mean = lambda v: sum(v) / len(v)
        legs[leg] = {"query_raw_ms": mean(raw_ms), "query_raw_median_ms": statistics.median(raw_ms),
                     "query_ms": mean(q_ms), "query_median_ms": statistics.median(q_ms),
                     "hash_host_ms": mean(hash_ms), "launches": counts, "hasher_calls": calls,
                     "equal_to_query": not unequal, "cpu_rows_mismatched": mismatched,
                     "cpu_rows_left_out": left_out}
        print(f"{leg} on {name} ({smi}), host {cpu}: {len(batches)} batches of B={BATCH} over "
              f"C={CORPUS} ({collided:.1%} of the catalog's keys share a slot), k={TOPK}: "
              f"query_raw {mean(raw_ms):.3f} ms/batch (median {statistics.median(raw_ms):.3f}; "
              f"host clock with a synchronize: hash, copy, query) beside query on the same slots "
              f"{mean(q_ms):.3f} (median {statistics.median(q_ms):.3f}; phase 3's exact leg "
              f"{serve_ms:.3f} by CUDA events); the hash alone {mean(hash_ms):.3f} host ms a "
              f"batch; indices bit-equal to query's in every batch {not unequal}; launches "
              f"{json.dumps(counts)}; hasher calls {json.dumps(calls)}; vs a CPU copy hashing "
              f"with the numpy fallback on {ZOO_CHECK_ROWS} rows a batch: slots equal "
              f"{not bad_slots}, user embeddings max_abs_err {max(errs):.3g} (tol 3e-2), "
              f"{mismatched} rows mismatched ({left_out} left out within 1e-5 of scale)",
              flush=True)
    rec["serving"] = legs
    del engine, corpus, corpus_cpu, cpu_model, model, outs, batches
    torch.cuda.empty_cache()

    # -- 13c: train-65k-raw --
    t_13c = time.perf_counter()
    b, n_steps = TRAIN_BATCH, RAW_WARMUP + RAW_STEPS
    items = catalog[:TRAIN_ROWS]
    gen.manual_seed(args.seed + 132)
    train_cfg = TrainConfig(batch_size=b, learning_rate=1e-3)
    state = create_train_state(gen, fcfg, train_cfg, device=dev)
    step = make_train_step(fcfg, train_cfg)
    log = [(pick(users, b), pick(items, b), pick(items, b, HIST)) for _ in range(n_steps)]
    dense = [(torch.randn(b, 16, generator=gen, device=dev), torch.randn(b, 16, generator=gen, device=dev),
              torch.randint(0, fcfg.position_table_size, (b,), generator=gen, device=dev),
              torch.bernoulli(torch.full((b, fcfg.num_tasks), 0.5, device=dev), generator=gen))
             for _ in range(n_steps)]
    idx = torch.arange(b, device=dev)

    def ingested(i):
        t0 = time.perf_counter()
        uid, iid, hist = ingest.ingest_example_keys(fcfg, *log[i])
        ms = (time.perf_counter() - t0) * 1e3
        uf, itf, pos, lab = dense[i]
        on = lambda a: torch.as_tensor(a, device=dev)
        return SyntheticRecData(
            user_ids=on(uid), user_features=uf, user_history=on(hist), item_ids=on(iid),
            item_features=itf, positions=pos, labels=lab, catalog_ids=torch.arange(4, device=dev),
            catalog_features=torch.zeros(4, 16, device=dev)), ms

    metrics, ingest_ms = [], []
    with torch.enable_grad():
        for i in range(RAW_WARMUP):
            state, _ = step(state, ingested(i)[0], idx)
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        native.reset_calls()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(RAW_WARMUP, n_steps):
            data, ms = ingested(i)
            ingest_ms.append(ms)
            state, m = step(state, data, idx)
            metrics.append(m)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / RAW_STEPS
    counts, calls = dict(_lib.launches), dict(native.calls)
    check_only_launches(counts, zoo_train_launches(fcfg), RAW_STEPS, failures, "train-65k-raw")
    if calls != {"cpp": 3 * RAW_STEPS}:
        failures.append(f"train-65k-raw: the hasher's calls {calls}, not C++ only")
    if not finite(torch, metrics):
        failures.append("train-65k-raw metrics not finite")
    state, _, bare_ms, bare_host, _ = run_steps(torch, step, state, data, idx, RAW_STEPS)
    ing = sum(ingest_ms) / len(ingest_ms)
    rec["train"] = {"ms_step_with_ingest": wall, "device_ms_step": start.elapsed_time(end) / RAW_STEPS,
                    "ingest_host_ms": ing, "bare_step_ms": bare_ms, "bare_step_host_ms": bare_host,
                    "keeps_up": ing < bare_ms, "launches": counts, "hasher_calls": calls}
    print(f"train-65k-raw on {name} ({smi}), host {cpu}: {RAW_STEPS} steps of B={b}, each on a "
          f"batch ingested from string keys: {wall:.3f} ms/step with the ingest inline (host "
          f"clock; CUDA events {rec['train']['device_ms_step']:.3f}); the ingest {ing:.3f} host ms "
          f"a batch; the bare step on the last batch {bare_ms:.3f} ms/step (host wall "
          f"{bare_host:.3f}); the ingest keeps up with the step: {ing < bare_ms} (ingest below "
          f"the bare step's time); loss {float(metrics[0]['loss']):.5f}->"
          f"{float(metrics[-1]['loss']):.5f}; launches {json.dumps(counts)}; hasher calls "
          f"{json.dumps(calls)}", flush=True)
    grads_vs_cpu(torch, state.params, fcfg, data, idx, failures, "train-65k-raw")
    del state, step, data, log, dense
    torch.cuda.empty_cache()

    # -- 13d: reference-checkpoint interop --
    t_13d = time.perf_counter()
    rec["interop"] = {}
    for label, icfg in (("serve-1M-exact", cfg), ("kd", zoo_cfg("two_tower_plus_light_ranker_kd"))):
        g = torch.Generator()
        g.manual_seed(args.seed + 133)
        layout = interop.reference_state_dict_from_params(tt.init_params(0, icfg, device="cpu"), icfg)
        sd = {k: torch.randn(v.shape, generator=g) * (1.0 if k.endswith("embedding_arch.weight")
                                                      else 0.05) for k, v in layout.items()}
        t0 = time.perf_counter()
        imported = interop.params_from_reference_state_dict(sd, icfg, seed=args.seed, device=dev)
        torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = interop.reference_state_dict_from_params(imported, icfg)
        export_ms = (time.perf_counter() - t0) * 1e3
        exact = list(back) == list(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
        aux = True
        if icfg.kd:
            t = icfg.num_tasks
            fresh = tt.init_params(args.seed, icfg, device=dev)
            aux = torch.equal(imported.light_ranker_head.w[:, t:], fresh.light_ranker_head.w[:, t:])
        serve = ""
        if label == "serve-1M-exact":
            eng = RetrievalEngine.from_params(imported, icfg, torch.arange(CORPUS, device=dev),
                                              torch.randn(CORPUS, 16, generator=gen, device=dev),
                                              device=dev)
            u = torch.randint(0, icfg.user_id_hash_size, (BATCH,), generator=gen, device=dev)
            h = torch.randint(0, CORPUS, (BATCH, HIST), generator=gen, device=dev)
            f = torch.randn(BATCH, 16, generator=gen, device=dev)
            got = eng.query(u, f, h)
            _, err, mm, lo = raw_cpu_check(torch, icfg, imported, copy.deepcopy(imported).cpu(),
                                           eng.corpus, eng.corpus.cpu(), (u, h), f, got)
            serve = (f"; one batch of B={BATCH} through the imported model vs a CPU copy on "
                     f"{ZOO_CHECK_ROWS} rows: user embeddings max_abs_err {err:.3g} (tol 3e-2), "
                     f"{mm} rows mismatched ({lo} left out)")
            if mm or err > 3e-2:
                failures.append(f"13d {label}: the imported model's batch differs from the CPU copy")
            del eng
        if not (exact and aux):
            failures.append(f"13d {label}: export not bit-equal to the state_dict ({exact}) or "
                            f"KD's aux columns not the fresh init ({aux})")
        n_el = sum(v.numel() for v in sd.values())
        rec["interop"][label] = {"entries": len(sd), "elements": n_el, "import_ms": import_ms,
                                 "export_ms": export_ms, "bit_equal": exact, "aux_fresh": aux}
        print(f"interop 13d {label} on {name}: {len(sd)} reference entries, {n_el} values; "
              f"imported onto the card in {import_ms:.1f} ms, exported in {export_ms:.1f} ms; "
              f"export bit-equal to the state_dict on every key {exact}"
              + (f"; KD's aux columns the fresh init {aux}" if icfg.kd else "") + serve,
              flush=True)
        del imported, back, sd, layout
        torch.cuda.empty_cache()

    # -- 13e: the port's raw-key example --
    t_13e = time.perf_counter()
    example = Path(__file__).resolve().parent / "examples" / "raw_key_ingest_torch.py"
    res = subprocess.run([sys.executable, str(example)], capture_output=True, text=True,
                         timeout=300)
    line = "raw-key serving matches pre-hashed serving: OK"
    ok = res.returncode == 0 and line in res.stdout
    print(f"example 13e: {example.name} rc {res.returncode} in {time.perf_counter() - t_13e:.1f} s; "
          f"{'; '.join(res.stdout.strip().splitlines()[-3:])}", flush=True)
    if not ok:
        print(res.stderr[-4000:], flush=True)
        failures.append(f"13e: {example.name} rc {res.returncode}, consistency line {line in res.stdout}")
    entries["fused_history_encoder"]["raw_key"] = rec
    t_end = time.perf_counter()
    print(f"raw: phase wall {t_end - t_phase:.1f} s (13a {t_13b - t_phase:.1f}, 13b "
          f"{t_13c - t_13b:.1f}, 13c {t_13d - t_13c:.1f}, 13d {t_13e - t_13d:.1f}, 13e "
          f"{t_end - t_13e:.1f})", flush=True)


def free_port() -> int:
    """A free TCP port on this host, for a process group's store."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class StageTimer:
    """Device time of calls on this rank's stream: CUDA events on the card,
    the host clock around a synchronised call on the CPU (the rehearsal)."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, dev.type == "cuda"

    def __call__(self, fn):
        """(ms of one call of fn, its result)."""
        torch = self.torch
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t0) * 1e3, out
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e), out


def shard_inputs(torch, seed: int, nb: int, light_ranker: bool = False):
    """The sharded legs' model (serve_cfg, or serve-1M-exact-lightranker's
    zoo_cfg with its catalog ids modulo the 65,536-row table), catalog and
    ``nb`` query batches, all on the CPU from ``seed`` (every rank draws
    the same): (cfg, model, catalog ids, catalog features, batches)."""
    from two_tower_models_tpu_torch.models import two_tower as tt

    cfg = zoo_cfg("two_tower_plus_light_ranker") if light_ranker else serve_cfg()
    gen = torch.Generator()
    gen.manual_seed(seed + (31 if light_ranker else 30))
    model = tt.init_params(gen, cfg, device="cpu")
    ids = torch.arange(CORPUS) % cfg.item_id_hash_size
    feats = torch.randn(CORPUS, cfg.item_features_size, generator=gen)
    batches = [(torch.randint(0, cfg.user_id_hash_size, (BATCH,), generator=gen),
                torch.randn(BATCH, cfg.user_features_size, generator=gen),
                torch.randint(0, cfg.item_id_hash_size, (BATCH, HIST), generator=gen))
               for _ in range(nb)]
    return cfg, model, ids, feats, batches


def varlen_batches(torch, seed: int, cfg, batches):
    """``batches`` with per-example lengths uniform in [1, H] and id 0 past
    each length (phase 2b's rule)."""
    gen = torch.Generator()
    gen.manual_seed(seed + 32)
    out = []
    for u, f, h in batches:
        lens = torch.randint(1, HIST + 1, (BATCH,), generator=gen)
        out.append((u, f, torch.where(torch.arange(HIST)[None, :] < lens[:, None], h, 0), lens))
    return out


def margin_compare(torch, got, want, scores, k: int):
    """(rows whose k-th and (k+1)-th reference scores are more than 1e-5
    apart, those of them whose indices differ as sets, recall@k of got
    against want, rows equal in full)."""
    clear = (scores[:, k - 1] - scores[:, k]) > 1e-5
    same = torch.sort(got[clear], 1).values == torch.sort(want[clear], 1).values
    hits = sum(len(set(g) & set(w)) for g, w in zip(got.tolist(), want.tolist()))
    return (int(clear.sum()), int((~same).any(1).sum()), hits / want.numel(),
            int((got == want).all(1).sum()))


class ShardRank:
    """One rank of the four-card legs (14b-14e): its process group, mesh
    cache, timer and checks.  Rank 0 also holds the single-device
    references on its card and prints the lines."""

    def __init__(self, torch, rank: int, world: int, dev, seed: int, nb: int):
        self.torch, self.rank, self.world, self.seed, self.nb = torch, rank, world, seed, nb
        self.dev = dev
        self.time = StageTimer(torch, dev)
        self.failures, self.meshes, self.launches = [], {}, {}
        # host ms a batch to issue a leg's ten calls (no sync between them):
        # beside the device's ms/batch it says which of the two sets the pace
        self.issue_ms = {}
        self.name = torch.cuda.get_device_name(self.dev) if self.dev.type == "cuda" else "cpu"

    def mesh(self, shape):
        from two_tower_models_tpu_torch.config import MeshConfig
        from two_tower_models_tpu_torch.parallel import mesh as pm

        if shape not in self.meshes:  # every rank builds them in the same order
            self.meshes[shape] = pm.make_mesh(MeshConfig(*shape), self.dev.type)
        return self.meshes[shape]

    def say(self, line: str) -> None:
        if self.rank == 0:
            print(line, flush=True)

    def fail(self, what: str) -> None:
        self.failures.append(f"rank {self.rank}: {what}")

    def align(self) -> None:
        """Every rank idle and past one barrier, so that a stage timed next
        starts on all ranks together and its time is not another rank's lag."""
        self.torch.distributed.barrier()
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def max_over_ranks(self, values):
        """The element-wise maximum of a list of floats over the ranks."""
        torch = self.torch
        t = torch.tensor(values, dtype=torch.float64, device=self.dev)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return t.tolist()

    def same_on_every_rank(self, outs, label: str) -> bool:
        """Each output equal to rank 0's, on every rank (one flag, all-reduced)."""
        torch = self.torch
        ok = True
        for out in outs:
            mine = out.contiguous()
            first = mine.clone()
            torch.distributed.broadcast(first, src=0)
            ok &= torch.equal(mine, first)
        flag = torch.tensor([int(ok)], device=self.dev)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
        if not int(flag):
            self.fail(f"{label}: the ranks' answers differ")
        return bool(int(flag))

    def gather_rows(self, rows):
        """Every rank's rows, in rank order, on rank 0 (None elsewhere)."""
        torch = self.torch
        parts = [torch.empty_like(rows) for _ in range(self.world)] if self.rank == 0 else None
        torch.distributed.gather(rows.contiguous(), parts, dst=0)
        return torch.cat(parts) if self.rank == 0 else None

    def serve(self, label, fn, batches, expect: dict | None = None, alone: bool = False):
        """``fn(batch)`` on each batch, a CUDA event before and after each
        and one synchronise at the end (phase 3's timing), launch counts
        zeroed just before and read just after (``expect``: launches a
        batch on every rank): (outputs, ms/batch, the maximum over the
        ranks unless ``alone``: a call on this rank only)."""
        from two_tower_models_tpu_torch.ops import _lib

        torch = self.torch
        cuda = self.dev.type == "cuda"
        _lib.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize(self.dev)
        outs, marks = [], []
        t0 = time.perf_counter()
        for bt in batches:
            if cuda:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                outs.append(fn(bt))
                e.record()
                marks.append((s, e))
            else:
                t0 = time.perf_counter()
                outs.append(fn(bt))
                marks.append((time.perf_counter() - t0) * 1e3)
        issue = (time.perf_counter() - t0) * 1e3 / len(batches)
        if cuda:
            torch.cuda.synchronize(self.dev)
            marks = [s.elapsed_time(e) for s, e in marks]
        ms = sum(marks) / len(marks)
        counts = dict(_lib.launches)
        self.launches[label] = counts
        if expect is not None and self.dev.type == "cuda":
            for name, per in expect.items():
                if counts.get(name, 0) != per * len(batches):
                    self.fail(f"{label} launches[{name}]={counts.get(name, 0)}")
        if not alone:
            ms, issue = self.max_over_ranks([ms, issue])
        self.issue_ms[label] = issue
        return outs, ms


def shard_stage_times(ctx, local, cfg, mesh, corpus, valid: int, batches, recall_target=None):
    """ms/batch (max over ranks, mean of the batches) of the user tower,
    the local scan, the all-gather and the merge, each timed alone on the
    batches' own tensors with the ranks aligned before it, and the bytes a
    rank all-gathers a batch."""
    torch = ctx.torch
    from two_tower_models_tpu_torch.parallel.train_step import _user_tower
    from two_tower_models_tpu_torch.retrieval.mips import _shard_topk, all_gather_stacked, topk_ordered

    t = {"tower": [], "scan": [], "gather": [], "merge": []}
    nbytes = 0
    with torch.inference_mode():
        for u, f, h in batches:
            ctx.align()
            ms, (q, _) = ctx.time(lambda: _user_tower(local, cfg, mesh, u, f, h, "psum"))
            t["tower"].append(ms)
            ctx.align()
            ms, (top, idx, _, n_local) = ctx.time(lambda: _shard_topk(
                corpus, q, TOPK, ctx.rank, valid, recall_target, 4))
            t["scan"].append(ms)
            gidx = idx.long() + ctx.rank * n_local
            ctx.align()
            ms, (cs, ci) = ctx.time(lambda: (all_gather_stacked(top.float()),
                                             all_gather_stacked(gidx)))
            t["gather"].append(ms)
            nbytes = cs.numel() * 4 + ci.numel() * 8

            def merge():
                s = cs.movedim(0, 1).reshape(BATCH, -1)
                i = ci.movedim(0, 1).reshape(BATCH, -1)
                v, sel = topk_ordered(s, TOPK)
                return torch.gather(i, 1, sel)

            ctx.align()
            t["merge"].append(ctx.time(merge)[0])
    means = ctx.max_over_ranks([sum(v) / len(v) for v in t.values()])
    return dict(zip(t, means)), nbytes


def shard_exact_leg(ctx, cfg, model, ids, feats, batches, shape, c: int, ref=None):
    """14b on mesh ``shape`` over the first ``c`` catalog rows: the engine
    from from_params, each rank's rows and table rows, its refresh against
    the single-device refresh on card 0 (within one bf16 step), ten batches
    bit-equal (indices and scores) to a single-device engine over the
    gathered rows, the stage split and the refresh's ms.  Returns rank 0's
    reference engine and the leg's outputs."""
    torch = ctx.torch
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.parallel.retrieval import make_sharded_refresh_fn, pad_catalog
    from two_tower_models_tpu_torch.parallel.sharding import shard_params
    from two_tower_models_tpu_torch.parallel.train_step import _user_tower
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact, sharded_mips_topk
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    label = f"sharded exact {shape[0]}x{shape[1]} C={c}"
    mesh = ctx.mesh(shape)
    dev = ctx.dev
    eng = RetrievalEngine.from_params(model, cfg, ids[:c], feats[:c], mesh=mesh, device=dev.type)
    eng.warmup(BATCH)
    local, rows = eng._state
    n = ctx.world
    c_pad = -(-c // n) * n
    held = (tuple(rows.shape), local.item_id_table.shape[0], local.user_id_table.shape[0])
    want_held = ((c_pad // n, cfg.item_id_embedding_dim), cfg.item_id_hash_size // shape[1],
                 cfg.user_id_hash_size // shape[1])
    if held != want_held:
        ctx.fail(f"{label}: a rank holds {held}, not {want_held}")
    # the refresh alone, timed on each rank (the engine's was the warm-up)
    ids_p, feats_p, valid = pad_catalog(ids[:c], feats[:c], mesh)
    refresh = make_sharded_refresh_fn(cfg, mesh)
    local2 = shard_params(model, cfg, mesh, False, dev)
    refresh_ms = ctx.max_over_ranks([ctx.time(lambda: refresh(local2, ids_p, feats_p))[0]])[0]
    del local2
    full = ctx.gather_rows(rows)
    dev_batches = [tuple(t.to(dev) for t in bt) for bt in batches]
    outs, ms = ctx.serve(label, lambda bt: eng.query(*bt), dev_batches,
                         {"fused_history_encoder": 1, **MIPS_ROUTE, **ENC_TC,
                          "fused_history_encoder_tc": 1})
    same = ctx.same_on_every_rank(outs, label)
    # the scores: the towers and the scan of sharded_mips_topk, every rank
    direct = []
    with torch.inference_mode():
        for u, f, h in dev_batches:
            q, _ = _user_tower(local, cfg, mesh, u, f, h, "psum")
            direct.append(sharded_mips_topk(rows, q, TOPK, valid_count=valid, embeddings=False))
    stages, nbytes = shard_stage_times(ctx, local, cfg, mesh, rows, valid, dev_batches)
    if ctx.rank == 0:
        ref_model = ref[0] if ref is not None else copy.deepcopy(model).to(dev)
        with torch.inference_mode():
            single = tt.compute_item_embeddings  # the single-device refresh, 4096 rows a call
            want_rows = torch.cat([single(ref_model, cfg, ids[i : min(i + 4096, c)].to(dev),
                                          feats[i : min(i + 4096, c)].to(dev).float())
                                   for i in range(0, c, 4096)])
        steps = bf16_steps(torch, full[:c].bfloat16(), want_rows.bfloat16())
        rows_equal = bool(torch.equal(full[:c], want_rows))
        if int(steps.max()) > 1:
            ctx.fail(f"{label}: refresh rows {int(steps.max())} bf16 steps from single-device")
        del want_rows
        ref_eng = RetrievalEngine(ref_model, cfg, full[:c], device=dev.type)
        ref_eng.warmup(BATCH)
        ref_outs, ref_batch = ctx.serve("single-device", lambda bt: ref_eng.query(*bt),
                                        dev_batches, alone=True)
        idx_equal = all(torch.equal(a, b) for a, b in zip(outs, ref_outs))
        sc_equal = True
        with torch.inference_mode():
            for (u, f, h), (di, ds, _) in zip(dev_batches, direct):
                q, _ = tt.compute_user_embedding(ref_model, cfg, u, f, h)
                ri, rs, _ = mips_topk_exact(ref_eng.corpus, q, TOPK)
                sc_equal &= torch.equal(di, ri) and torch.equal(ds, rs)
        if not (idx_equal and sc_equal):
            ctx.fail(f"{label}: indices equal {idx_equal}, scores equal {sc_equal}")
        ctx.say(f"{label} on {n} x {ctx.name}: each rank holds {held[0][0]} corpus rows, "
                f"{held[1]} item-table rows, {held[2]} user-table rows; refresh rows vs the "
                f"single-device refresh: bit-equal={rows_equal}, at most {int(steps.max())} bf16 "
                f"steps; {len(batches)} batches of B={BATCH}, k={TOPK}: indices bit-equal to the "
                f"single-device engine over the gathered rows={idx_equal}, scores (towers + "
                f"sharded_mips_topk vs mips_topk_exact) bit-equal={sc_equal}, equal on every "
                f"rank={same}; ms/batch {ms:.3f} (max over ranks, mean of {len(batches)}; the "
                f"host issues a batch in {ctx.issue_ms[label]:.3f}) beside the single-device "
                f"query on card 0 {ref_batch:.3f} (issued in {ctx.issue_ms['single-device']:.3f}); "
                f"stages, each timed alone: user tower "
                f"{stages['tower']:.3f}, local scan {stages['scan']:.3f}, all-gather "
                f"{stages['gather']:.3f}, merge {stages['merge']:.3f}; all-gathered "
                f"{nbytes} bytes a rank a batch; sharded refresh {refresh_ms:.1f} ms "
                f"({c_pad // shape[0]} rows a data group, 4096 a call)")
        ref = (ref_model, ref_eng, ref_batch)
    ctx.say(f"launches a rank on the {label} path (rank 0): {json.dumps(ctx.launches[label])}")
    return ref, outs, (eng, local, rows, valid)


def shard_approx_legs(ctx, cfg, model, ids, feats, batches, exact_outs) -> None:
    """14c on (1, 4): approx_mips at 0.95, int8 and int8_rescore (under
    approx_mips, as phase 12b's legs); recall@100 against the exact leg's
    answers, N1 on the tensor cores once a batch on every rank."""
    import dataclasses

    from two_tower_models_tpu_torch.serving import RetrievalEngine

    mesh = ctx.mesh((1, 4))
    acfg = dataclasses.replace(cfg, approx_mips=True)
    dev_batches = [tuple(t.to(ctx.dev) for t in bt) for bt in batches]
    for leg, quant in (("approx_mips", None), ("int8", "int8"), ("int8_rescore", "int8_rescore")):
        label = f"sharded {leg} 1x4"
        eng = RetrievalEngine.from_params(model, acfg, ids, feats, mesh=mesh, quantize=quant,
                                          device=ctx.dev.type)
        eng.warmup(BATCH)
        outs, ms = ctx.serve(label, lambda bt: eng.query(*bt), dev_batches,
                             {**N1_TC, "fused_history_encoder_tc": 1, "tile_max_scores": 0})
        same = ctx.same_on_every_rank(outs, label)
        hits = sum(len(set(g) & set(w)) for a, b in zip(outs, exact_outs)
                   for g, w in zip(a.tolist(), b.tolist()))
        recall = hits / sum(b.numel() for b in exact_outs)
        gate = SHARD_GATES[leg]
        if recall < gate:
            ctx.fail(f"{label}: recall@{TOPK} {recall:.4f} < {gate}")
        n1 = -ctx.max_over_ranks([-ctx.launches[label].get("approx_scan_tc", 0)])[0]
        local, rows = eng._state
        q_rows = rows.q if quant else rows
        stages, nbytes = shard_stage_times(ctx, local, acfg, mesh, rows, len(ids), dev_batches,
                                           acfg.mips_recall_target)
        ctx.say(f"{label} on {ctx.world} x {ctx.name}: recall@{TOPK} vs the exact 1x4 leg "
                f"{recall:.4f} (gate {gate}); N1 on the tensor cores at least {int(n1)} launches "
                f"a rank over {len(batches)} batches; equal on every rank={same}; each rank "
                f"scans {q_rows.shape[0]} {q_rows.dtype} rows; ms/batch {ms:.3f} (max over "
                f"ranks; issued in {ctx.issue_ms[label]:.3f}); stages: user tower "
                f"{stages['tower']:.3f}, local scan "
                f"{stages['scan']:.3f}, all-gather {stages['gather']:.3f}, merge "
                f"{stages['merge']:.3f}; all-gathered {nbytes} bytes a rank a batch")
        ctx.say(f"launches a rank on the {label} path (rank 0): {json.dumps(ctx.launches[label])}")
        del eng, rows, local


def shard_branch_legs(ctx, cfg, model, ids, feats, batches, ref, exact14) -> None:
    """14d: tower_tp on (1, 4) and (2, 2), the all_to_all lookup on (1, 4),
    history_len in [1, 32] on (2, 2) (B8), each against rank 0's
    single-device engine by the margin rule (indices equal where the 100th
    and 101st reference scores are more than 1e-5 apart, recall >= 0.999);
    all_to_all and psum user embeddings bit-equal."""
    torch = ctx.torch
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.parallel.retrieval import make_sharded_retrieval_fn
    from two_tower_models_tpu_torch.parallel.train_step import _user_tower
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    dev_batches = [tuple(t.to(ctx.dev) for t in bt) for bt in batches]
    var_batches = [tuple(t.to(ctx.dev) for t in bt)
                   for bt in varlen_batches(torch, ctx.seed, cfg, batches)]
    eng14, local14, rows14, valid14 = exact14
    a2a = make_sharded_retrieval_fn(cfg, ctx.mesh((1, 4)), lookup_strategy="all_to_all")
    legs = []
    for shape in ((1, 4), (2, 2)):
        eng = RetrievalEngine.from_params(model, cfg, ids, feats, mesh=ctx.mesh(shape),
                                          tower_tp=True, device=ctx.dev.type)
        legs.append((f"tower_tp {shape[0]}x{shape[1]}", lambda bt, e=eng: e.query(*bt),
                     dev_batches, None))
    legs.append(("all_to_all 1x4", lambda bt: a2a(local14, rows14, *bt, None, valid14),
                 dev_batches, None))
    eng22 = RetrievalEngine.from_params(model, cfg, ids, feats, mesh=ctx.mesh((2, 2)),
                                        device=ctx.dev.type)
    eng22.warmup(BATCH, variable_history=True)
    legs.append(("history_len 2x2", lambda bt: eng22.query(*bt[:3], history_len=bt[3]),
                 var_batches, {"fused_attn_stack_tc": 1, "fused_history_encoder_tc": 0}))
    for name, fn, bts, expect in legs:
        label = f"sharded {name}"
        fn(bts[0])  # warm
        outs, ms = ctx.serve(label, fn, bts, expect)
        same = ctx.same_on_every_rank(outs, label)
        if ctx.rank == 0:
            _, ref_eng, _ = ref
            clear = bad = full = 0
            hits = 0.0
            for bt, got in zip(bts, outs):
                with torch.inference_mode():
                    q, _ = tt.compute_user_embedding(ref[0], cfg, *bt[:3],
                                                     bt[3] if len(bt) > 3 else None)
                    _, rs, _ = mips_topk_exact(ref_eng.corpus, q, TOPK + 1)
                want = ref_eng.query(*bt[:3], history_len=bt[3] if len(bt) > 3 else None)
                c_, b_, r_, f_ = margin_compare(torch, got, want, rs, TOPK)
                clear, bad, hits, full = clear + c_, bad + b_, hits + r_ / len(bts), full + f_
            if bad or hits < 0.999:
                ctx.fail(f"{label}: {bad} of {clear} clear rows differ, recall {hits:.5f}")
            ctx.say(f"{label} on {ctx.world} x {ctx.name}: vs the single-device engine: {bad} of "
                    f"{clear} clear-margin rows differ (of {len(bts) * BATCH}), recall@{TOPK} "
                    f"{hits:.5f} (gate 0.999), rows equal in full {full}; equal on every rank="
                    f"{same}; ms/batch {ms:.3f} (max over ranks; issued in "
                    f"{ctx.issue_ms[label]:.3f})")
        ctx.say(f"launches a rank on the {label} path (rank 0): {json.dumps(ctx.launches[label])}")
    # the two lookup strategies give the same user embeddings, bit for bit
    mesh = ctx.mesh((1, 4))
    with torch.inference_mode():
        equal = all(torch.equal(_user_tower(local14, cfg, mesh, *bt, "psum")[0],
                                _user_tower(local14, cfg, mesh, *bt, "all_to_all")[0])
                    for bt in dev_batches)
    if not equal:
        ctx.fail("all_to_all and psum user embeddings differ")
    ctx.say(f"sharded lookups 1x4: all_to_all and psum user embeddings bit-equal={equal} on "
            f"{len(dev_batches)} batches")


def shard_light_ranker_leg(ctx) -> None:
    """14d: serve-1M-exact-lightranker's model on (2, 2) (MIPS k = 50,
    rerank to 10; the rows all-gathered for the rerank) against rank 0's
    single-device engine over the gathered rows: indices equal as sets
    where the 10th and 11th rerank values and the 50th and 51st MIPS scores
    are more than 1e-5 of scale apart, recall >= 0.999."""
    torch = ctx.torch
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact, topk_ordered
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    cfg, model, ids, feats, batches = shard_inputs(torch, ctx.seed, ctx.nb, light_ranker=True)
    mesh = ctx.mesh((2, 2))
    label = "sharded light ranker 2x2"
    eng = RetrievalEngine.from_params(model, cfg, ids, feats, mesh=mesh, device=ctx.dev.type)
    eng.warmup(BATCH)
    dev_batches = [tuple(t.to(ctx.dev) for t in bt) for bt in batches]
    outs, ms = ctx.serve(label, lambda bt: eng.query(*bt), dev_batches,
                         {"fused_history_encoder_tc": 1, **MIPS_ROUTE})
    same = ctx.same_on_every_rank(outs, label)
    full = ctx.gather_rows(eng.corpus)
    if ctx.rank == 0:
        ref_model = model.to(ctx.dev)
        ref_eng = RetrievalEngine(ref_model, cfg, full, device=ctx.dev.type)
        ni, n_items = cfg.light_ranker.num_mips_items, cfg.num_items
        clear_n = bad = 0
        hits = 0
        for bt, got in zip(dev_batches, outs):
            want = ref_eng.query(*bt)
            with torch.inference_mode():
                q, ranker = tt.compute_user_embedding(ref_model, cfg, *bt)
                _, sc, emb = mips_topk_exact(full, q, ni + 1)
                value = tt.rerank_values(ref_model, cfg, ranker, sc[:, :ni], emb[:, :ni])
                top_v, _ = topk_ordered(value, n_items + 1)
            clear = ((top_v[:, n_items - 1] - top_v[:, n_items]) > 1e-5 * value.abs().amax(1)) & (
                (sc[:, ni - 1] - sc[:, ni]) > 1e-5 * sc[:, 0].abs())
            clear_n += int(clear.sum())
            same_rows = torch.sort(got[clear], 1).values == torch.sort(want[clear], 1).values
            bad += int((~same_rows).any(1).sum())
            hits += sum(len(set(g) & set(w)) for g, w in zip(got.tolist(), want.tolist()))
        recall = hits / (len(outs) * BATCH * n_items)
        if bad or recall < 0.999 or not clear_n:
            ctx.fail(f"{label}: {bad} of {clear_n} clear rows differ, recall {recall:.5f}")
        nbytes = ctx.world * BATCH * ni * (4 + 8 + full.shape[1] * full.element_size())
        ctx.say(f"{label} on {ctx.world} x {ctx.name}: MIPS k={ni} then the rerank to "
                f"{n_items}: {bad} of {clear_n} clear rows differ from the single-device engine "
                f"(of {len(outs) * BATCH}), recall@{n_items} {recall:.5f} (gate 0.999); equal on "
                f"every rank={same}; ms/batch {ms:.3f} (max over ranks; issued in "
                f"{ctx.issue_ms[label]:.3f}); all-gathered {nbytes} "
                f"bytes a rank a batch (the candidates' scores, indices and rows)")
    ctx.say(f"launches a rank on the {label} path (rank 0): {json.dumps(ctx.launches[label])}")


def shard_recall_leg(ctx, cfg, model, ids, feats, batches, ref, exact_outs) -> None:
    """14e: make_sharded_recall_fn on (2, 2) equals the single-device
    make_eval_recall_fn on the same examples: batch 0's users, half of them
    engaged with their own top exact item (so hits exist), three quarters
    positive."""
    torch = ctx.torch
    from two_tower_models_tpu_torch.models.two_tower import Batch
    from two_tower_models_tpu_torch.parallel.retrieval import (
        make_sharded_recall_fn,
        make_sharded_refresh_fn,
        pad_catalog,
    )
    from two_tower_models_tpu_torch.parallel.sharding import shard_params
    from two_tower_models_tpu_torch.training.step import make_eval_recall_fn

    mesh = ctx.mesh((2, 2))
    u, f, h = (t.to(ctx.dev) for t in batches[0])
    gen = torch.Generator()
    gen.manual_seed(ctx.seed + 33)
    item = torch.randint(0, CORPUS, (BATCH,), generator=gen).to(ctx.dev)
    item[: BATCH // 2] = exact_outs[0][: BATCH // 2, 0]
    labels = (torch.arange(BATCH, device=ctx.dev) % 4 != 0)[:, None].float().expand(
        BATCH, cfg.num_tasks)
    batch = Batch(user_id=u, user_features=f, user_history=h, item_id=item, labels=labels)
    local = shard_params(model, cfg, mesh, False, ctx.dev)
    ids_p, feats_p, valid = pad_catalog(ids, feats, mesh)
    rows = make_sharded_refresh_fn(cfg, mesh)(local, ids_p, feats_p)
    ms, got = ctx.time(lambda: make_sharded_recall_fn(cfg, mesh, TOPK)(local, rows, batch, valid))
    got = float(got)
    vals = ctx.max_over_ranks([got, -got])
    if vals[0] != -vals[1]:
        ctx.fail("sharded recall differs between ranks")
    if ctx.rank == 0:
        want = float(make_eval_recall_fn(cfg, TOPK)(ref[0], ref[1].corpus, batch))
        if got != want or not 0 < got < 1:
            ctx.fail(f"sharded recall {got} != single-device {want}")
        ctx.say(f"sharded recall 2x2 on {ctx.world} x {ctx.name}: recall@{TOPK} {got:.6f}, "
                f"single-device make_eval_recall_fn {want:.6f}, equal={got == want} on "
                f"{BATCH} examples; {ms:.2f} ms on rank 0")


def shard_collectives(ctx, cfg) -> None:
    """The collectives of an exact batch alone, at its sizes: the history
    lookup's all-reduce over ``model`` on (1, 4) ([B * H, D] f32) and the
    merge's all-gather of [B, k] f32 scores and int64 indices over all
    ranks, each launched 20 times back to back between two CUDA events
    (one host sync); and which peers each card reaches directly (P2P)."""
    torch = ctx.torch
    from two_tower_models_tpu_torch.retrieval.mips import all_gather_stacked

    group = ctx.mesh((1, 4)).get_group("model")
    rows = torch.ones(BATCH * HIST, cfg.item_id_embedding_dim, device=ctx.dev)
    sc = torch.ones(BATCH, TOPK, device=ctx.dev)
    ix = torch.ones(BATCH, TOPK, dtype=torch.int64, device=ctx.dev)
    legs = {"all_reduce": lambda: torch.distributed.all_reduce(rows, group=group),
            "all_gather": lambda: (all_gather_stacked(sc), all_gather_stacked(ix))}
    ms = {}
    for name, fn in legs.items():
        fn()
        ctx.time(lambda: [fn() for _ in range(20)])
        ms[name] = ctx.max_over_ranks([ctx.time(lambda: [fn() for _ in range(20)])[0] / 20])[0]
    if ctx.dev.type == "cuda":
        peers = [torch.cuda.can_device_access_peer(ctx.dev.index, r)
                 for r in range(ctx.world) if r != ctx.dev.index]
    else:
        peers = []
    nbytes = {"all_reduce": rows.numel() * 4, "all_gather": ctx.world * BATCH * TOPK * 12}
    ctx.say(f"sharded collectives on {ctx.world} x {ctx.name}: all_reduce of {nbytes['all_reduce']} "
            f"bytes over model (1x4) {ms['all_reduce']:.3f} ms "
            f"({nbytes['all_reduce'] / ms['all_reduce'] / 1e6:.1f} GB/s of the buffer); the "
            f"merge's all_gather of scores and indices, {nbytes['all_gather']} bytes a rank, "
            f"{ms['all_gather']:.3f} ms (max over ranks, mean of 20 back to back); rank 0 "
            f"reaches its peers directly (P2P): {peers}")


# ---- phase 15: the explicit sharded training step ----------------------------


def train_launches(cfg, b18: int = 0) -> dict:
    """A sharded training step's launches for ``cfg``: zoo_train_launches',
    the position table's B18 only where a position head runs, and ``b18``
    more (the sparse exchange's scatters; the lookups' backward on shards
    inside the scatter window)."""
    from two_tower_models_tpu_torch.config import Debias

    out = zoo_train_launches(cfg)
    out["rows_scatter_add"] = (POS_B18 if cfg.debias in (Debias.POSITION, Debias.BOTH) else 0) + b18
    return out


def shard_train_data(torch, ctx, cfg, b: int, seed: int, kd: bool = False):
    """A fixed global batch of ``b`` rows for ``cfg`` (fixed_batch's shapes),
    drawn on the host from ``seed`` so every rank holds the same, on the
    rank's device: (SyntheticRecData, Batch)."""
    from two_tower_models_tpu_torch.training.data import gather_batch

    gen = torch.Generator()
    gen.manual_seed(seed)
    data = fixed_batch(torch, gen, "cpu", cfg, b)
    if kd:  # scripts/bench_presets.py:67-70: the soft labels are half the hard ones
        data = data._replace(labels=torch.cat([data.labels, 0.5 * data.labels], 1))
    data = type(data)(*(None if t is None else t.to(ctx.dev) for t in data))
    return data, gather_batch(data, torch.arange(b, device=ctx.dev))


def shard_full_state(torch, ctx, cfg, tcfg, n_model: int, broadcast: bool = True):
    """The full TrainState from --seed on this rank's device, rank 0's
    parameters broadcast to every rank (one init on every card); rank 0
    alone passes ``broadcast=False``."""
    from two_tower_models_tpu_torch.training.state import create_train_state

    st = create_train_state(ctx.seed + 50, cfg, tcfg, device=ctx.dev, model_shards=n_model)
    for p in st.params.parameters() if broadcast else ():
        torch.distributed.broadcast(p.data, src=0)
    return st


def gather_leaves(torch, ctx, mesh, tensors: dict, specs: dict):
    """Rank 0's view of whole leaves: each leaf's blocks from the ranks of
    data row 0, joined on the dim its spec splits (None elsewhere)."""
    if mesh.get_local_rank("data") != 0:
        return None
    group = mesh.get_group("model")
    n = mesh.size(1)
    out = {}
    for name, t in tensors.items():
        t = t.detach().contiguous()
        if n == 1:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(n)] if ctx.rank == 0 else None
        torch.distributed.gather(t, parts, dst=0, group=group)
        if ctx.rank == 0:
            axes = [i for i, a in enumerate(specs[name]) if a == "model"]
            out[name] = torch.cat(parts, axes[0]) if axes else parts[0]
    return out if ctx.rank == 0 else None


def leaf_errors(torch, cfg, got: dict, want: dict):
    """(worst share of its scale over the leaves, that leaf): each leaf's
    max |got - want| over its scale; the leaves of zero_grad_leaves(cfg)
    against ZERO_GRAD_FLOOR of the top leaf (phase 4's rule)."""
    from two_tower_models_tpu_torch.models import two_tower as tt

    top = max(float(w.abs().max()) for w in want.values())
    worst, leaf = 0.0, ""
    for name, w in want.items():
        g = got[name].reshape(w.shape).float()
        scale = tt.ZERO_GRAD_FLOOR * top if name in tt.zero_grad_leaves(cfg) else float(w.abs().max())
        rel = float((g - w.float()).abs().max()) / max(scale, 1e-30)
        if rel > worst:
            worst, leaf = rel, name
    return worst, leaf


def replicas_equal(torch, ctx, mesh, params) -> bool:
    """Every leaf equal, bit for bit, to its replica on rank 0 (replicated
    leaves) or on the data-row-0 rank of its model index (split leaves)."""
    from two_tower_models_tpu_torch.parallel.sharding import param_pspecs

    dist = torch.distributed
    data = mesh.get_group("data")
    ok = True
    for name, spec in param_pspecs(params).items():
        mine = dict(params.named_parameters())[name].detach().contiguous()
        theirs = mine.clone()
        if "model" in spec:
            dist.broadcast(theirs, src=dist.get_global_rank(data, 0), group=data)
        else:
            dist.broadcast(theirs, src=0)
        ok &= torch.equal(mine, theirs)
    flag = torch.tensor([int(ok)], device=ctx.dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(int(flag))


def kept_params_close(torch, cfg, got: dict, want: dict, g0: dict, tol: float):
    """(worst error over each leaf's scale, fewest share of elements kept):
    the parameters after a few steps, each element whose first-step
    gradient on one card is 0 or at least 1e-2 of its leaf's largest (Adam
    moves every other element by about lr whatever its gradient's size, so
    the bf16 rounding of the two runs' sums there decides the sign); the
    leaves of zero_grad_leaves(cfg) left out."""
    from two_tower_models_tpu_torch.models import two_tower as tt

    worst, kept = 0.0, 1.0
    for name, w in want.items():
        if name in tt.zero_grad_leaves(cfg):
            continue
        g = g0[name].abs()
        keep = (g == 0) | (g >= 1e-2 * g.max())
        d = (got[name].reshape(w.shape) - w).abs()[keep]
        worst = max(worst, float(d.max()) / max(float(w.abs().max()), 1e-30) if d.numel() else 0.0)
        kept = min(kept, float(keep.float().mean()))
    return worst, kept


def timed_steps(torch, ctx, label: str, step, state, batch, n: int, expect: dict | None):
    """n steps after the caller's warm-up, the launch counts zeroed just
    before and read just after: (state, metrics, ms/step by CUDA events,
    host issue ms/step), both the maximum over the ranks."""
    from two_tower_models_tpu_torch.ops import _lib

    cuda = ctx.dev.type == "cuda"
    ctx.align()
    metrics = []
    with torch.enable_grad():
        _lib.reset_launch_counts()
        if cuda:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
            metrics.append(m)
        issue = (time.perf_counter() - t0) * 1e3 / n
        if cuda:
            e.record()
            e.synchronize()
            ms = s.elapsed_time(e) / n
        else:
            ms = issue
        counts = dict(_lib.launches)
    ctx.launches[label] = counts
    if expect is not None and cuda:
        check_only_launches(counts, expect, n, ctx.failures, f"rank {ctx.rank}: {label}")
    ms, issue = ctx.max_over_ranks([ms, issue])
    return state, metrics, ms, issue


def lookup_b18(cfg, params, batch) -> int:
    """The lookups a step whose backward takes B18 (shards inside the
    scatter window: ``nn.layers._in_scatter_window``, packed ones uncapped)."""
    from two_tower_models_tpu_torch.nn.layers import _in_scatter_window

    n = 0
    item_lookups = 1 + (cfg.history_encoder is not None) + (batch.neg_item_id is not None)
    for name, dim, lookups in (("user_id_table", cfg.user_id_embedding_dim, 1),
                               ("item_id_table", cfg.item_id_embedding_dim, item_lookups)):
        t = getattr(params, name)
        if _in_scatter_window(t.shape[0] * (t.shape[-1] // dim), capped=t.shape[-1] == dim):
            n += lookups
    return n


def grads_leg(torch, ctx, label, cfg, mesh_cfg, shape, batch, tcfg=None, strategy="psum",
              ref=None):
    """One fixed global batch through sharded_grads on ``shape``: every
    leaf (assembled over model) against one card's train_loss gradients
    within BF16_TOL of its scale, the metrics within 1e-4 relative and
    grad_norm within 1e-3, on rank 0; the forward's and backward's launches
    (train_launches, on every rank).  ``ref`` (rank 0: the card's
    (metrics, grads)) is computed when None.  (the rank's block, ref, the
    line's text)."""
    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.parallel.sharding import param_pspecs, shard_state
    from two_tower_models_tpu_torch.parallel.sparse_grads import sparse_table_grad_names
    from two_tower_models_tpu_torch.parallel.train_step import local_batch, sharded_grads
    from two_tower_models_tpu_torch.training.state import global_norm
    from two_tower_models_tpu_torch.training.step import _grads

    tcfg = tcfg or TrainConfig(learning_rate=1e-3)
    mesh = ctx.mesh(shape)
    full = shard_full_state(torch, ctx, cfg, tcfg, shape[1])
    block = shard_state(full, cfg, mesh, mesh_cfg.tower_tp, ctx.dev)
    if ctx.rank == 0 and ref is None:
        with torch.enable_grad():
            loss, m = tt.train_loss(full.params, cfg, batch)
            names, ps = zip(*full.params.named_parameters())
            g = dict(zip(names, _grads(loss, ps)))
        m = {k: float(v) for k, v in m.items()}
        m["grad_norm"] = float(global_norm(list(g.values())))
        ref = (m, g)
    del full
    ctx.align()
    _lib.reset_launch_counts()
    with torch.enable_grad():
        names, grads, metrics = sharded_grads(block.params, cfg, mesh_cfg, mesh, batch, strategy)
    counts = ctx.launches[label] = dict(_lib.launches)
    local = local_batch(batch, mesh.get_local_rank("data"), shape[0])
    n_sparse = len(sparse_table_grad_names(cfg, mesh_cfg, local, block.params))
    expect = train_launches(cfg, n_sparse + lookup_b18(cfg, block.params, local))
    if ctx.dev.type == "cuda":
        check_only_launches(counts, expect, 1, ctx.failures, f"rank {ctx.rank}: {label}")
    got = gather_leaves(torch, ctx, mesh, dict(zip(names, grads)),
                        param_pspecs(block.params, mesh_cfg.tower_tp))
    line = ""
    if ctx.rank == 0:
        want_m, want_g = ref
        worst, leaf = leaf_errors(torch, cfg, got, want_g)
        bad = [k for k, v in want_m.items() if k != "grad_norm"
               and not abs(float(metrics[k]) - v) <= 1e-4 * max(abs(v), 1e-6)]
        gn = abs(float(metrics["grad_norm"]) - want_m["grad_norm"]) / want_m["grad_norm"]
        if worst > BF16_TOL or bad or gn > 1e-3 or set(metrics) != set(want_m):
            ctx.fail(f"{label}: worst grad leaf {leaf} {worst:.3g} of scale, metrics off {bad}, "
                     f"grad_norm {gn:.3g} relative")
        line = (f"worst grad leaf {leaf} at {worst:.3g} of its scale (tol {BF16_TOL}), loss "
                f"{float(metrics['loss']):.6f} vs {want_m['loss']:.6f} on one card, grad_norm "
                f"{float(metrics['grad_norm']):.4f} vs {want_m['grad_norm']:.4f} ({gn:.2g} "
                f"relative)")
    return block, ref, line


def shard_train_mesh(torch, ctx, cfg, tcfg, shape, single_ms: float | None):
    """15b on one mesh: gradients against one card, three steps' parameters
    against three single-card steps, then 3 warm-up and SHARD_STEPS timed
    steps (ms/step and issue ms, the maximum over ranks; launches a step;
    host syncs of one step), the replicas bit-equal, and the collectives of
    a step timed alone."""
    from two_tower_models_tpu_torch.config import MeshConfig
    from two_tower_models_tpu_torch.parallel.sharding import param_pspecs
    from two_tower_models_tpu_torch.parallel.sparse_grads import sparse_table_grad_names
    from two_tower_models_tpu_torch.parallel.train_step import local_batch, make_sharded_train_step
    from two_tower_models_tpu_torch.training.step import make_train_step

    n_d, n_m = shape
    b = SHARD_TRAIN_B * n_d
    label = f"train {n_d}x{n_m}"
    mesh_cfg = MeshConfig(*shape)
    mesh = ctx.mesh(shape)
    data, batch = shard_train_data(torch, ctx, cfg, b, ctx.seed + 51)
    block, ref, line = grads_leg(torch, ctx, f"{label} grads", cfg, mesh_cfg, shape, batch)
    # three steps beside three on one card (rank 0)
    step = make_sharded_train_step(cfg, tcfg, mesh, mesh_cfg)
    with torch.enable_grad():
        for _ in range(SHARD_PARAM_STEPS):
            block, _ = step(block, batch)
    specs = param_pspecs(block.params)
    got = gather_leaves(torch, ctx, mesh, dict(block.params.named_parameters()), specs)
    if ctx.rank == 0:
        full = shard_full_state(torch, ctx, cfg, tcfg, n_m, broadcast=False)
        single = make_train_step(cfg, tcfg)
        idx = torch.arange(b, device=ctx.dev)
        with torch.enable_grad():
            for _ in range(SHARD_PARAM_STEPS):
                full, _ = single(full, data, idx)
        want = {k: p.detach() for k, p in full.params.named_parameters()}
        worst, kept = kept_params_close(torch, cfg, got, want, ref[1], BF16_TOL)
        if worst > BF16_TOL:
            ctx.fail(f"{label}: params after {SHARD_PARAM_STEPS} steps {worst:.3g} of scale from "
                     f"one card's, {kept:.3f} of the elements kept")
        line += (f"; params after {SHARD_PARAM_STEPS} steps {worst:.3g} of scale from one card's "
                 f"(elements kept: at least {kept:.3f} of a leaf)")
        del full, want
    del got
    local = local_batch(batch, mesh.get_local_rank("data"), n_d)
    sparse = sparse_table_grad_names(cfg, mesh_cfg, local, block.params)
    expect = train_launches(cfg, len(sparse) + lookup_b18(cfg, block.params, local))
    with torch.enable_grad():
        for _ in range(3):
            block, _ = step(block, batch)
    block, metrics, ms, issue = timed_steps(torch, ctx, label, step, block, batch, SHARD_STEPS,
                                            expect)
    syncs = 0
    if ctx.dev.type == "cuda":
        block, syncs = count_syncs(torch, lambda s, d, i: step(s, batch), block, None, None)
        syncs = int(ctx.max_over_ranks([syncs])[0])
        if syncs:
            ctx.fail(f"{label}: {syncs} host syncs in a step")
    equal = replicas_equal(torch, ctx, mesh, block.params)
    if not equal:
        ctx.fail(f"{label}: replicated leaves or table replicas differ between ranks")
    if not finite(torch, metrics):
        ctx.fail(f"{label}: metrics not finite")
    coll = train_collectives(torch, ctx, cfg, shape, mesh, block, local, sparse)
    eff = "not measured" if single_ms is None else f"{single_ms / ms:.3f}"
    ctx.say(f"sharded {label} on {ctx.world} x {ctx.name}: train-65k-sharded-{n_d}x{n_m}, "
            f"B={b} ({SHARD_TRAIN_B} a card), sparse tables {sorted(sparse)}: {line}; "
            f"{SHARD_STEPS} steps: ms/step {ms:.3f} (max over ranks; issued in {issue:.3f}), "
            f"examples/s {b / ms * 1e3:.0f}; one card at B={SHARD_TRAIN_B} in this call "
            f"{'not measured' if single_ms is None else f'{single_ms:.3f}'} ms/step: weak-scaling "
            f"efficiency {eff}; host syncs in a step {syncs}; replicas bit-equal on every rank="
            f"{equal}; launches a step {json.dumps({k: v // SHARD_STEPS for k, v in ctx.launches[label].items() if v})}; "
            f"loss {float(metrics[0]['loss']):.5f}->{float(metrics[-1]['loss']):.5f}")
    ctx.say(f"sharded {label} collectives: {coll}")
    return block


def train_collectives(torch, ctx, cfg, shape, mesh, block, local, sparse) -> str:
    """The collectives of one step of ``block`` on ``local``, each launched
    20 times back to back between two CUDA events (the maximum over ranks
    of the mean): the lookups' all-reduces over model, the negatives' and
    nuv's all-gathers and reduce-scatters over data, the gradients'
    all-reduces (flat buffers: the dense leaves over data, the replicated
    over model), the sparse exchange's two all-gathers, and the metrics'.
    Each with the bytes a rank hands it (its input); and their sum a step."""
    from two_tower_models_tpu_torch.parallel.collectives import all_gather_into, reduce_scatter_into
    from two_tower_models_tpu_torch.parallel.sharding import param_pspecs
    from two_tower_models_tpu_torch.parallel.sparse_grads import table_touched_ids

    dist = torch.distributed
    n_d, n_m = shape
    data, model = mesh.get_group("data"), mesh.get_group("model")
    b, di = local.user_id.shape[0], cfg.item_id_embedding_dim
    h = cfg.history_len if cfg.history_encoder is not None else 0
    f32 = lambda *s: torch.ones(*s, device=ctx.dev)
    specs = param_pspecs(block.params)
    ps = dict(block.params.named_parameters())
    legs = {}
    if n_m > 1:
        for name, rows in (("lookup user", b), ("lookup history", b * h), ("lookup item", b)):
            t = f32(rows, di)
            legs[name] = (lambda t=t: dist.all_reduce(t, group=model), t.numel() * 4)
        rep = sum(p.numel() for k, p in ps.items() if "model" not in specs[k])
        t = f32(rep)
        legs["grads over model"] = (lambda t=t: dist.all_reduce(t, group=model), rep * 4)
    if n_d > 1:
        x, out = f32(b, di), f32(b * n_d, di)
        legs["negatives all-gather"] = (lambda: all_gather_into(out, x, group=data), x.numel() * 4)
        legs["negatives reduce-scatter"] = (lambda: reduce_scatter_into(x, out, group=data),
                                            out.numel() * 4)
        v, vo = f32(b), f32(b * n_d)
        legs["nuv all-gather"] = (lambda: all_gather_into(vo, v, group=data), b * 4)
        legs["nuv reduce-scatter"] = (lambda: reduce_scatter_into(v, vo, group=data), b * n_d * 4)
        dense = sum(p.numel() for k, p in ps.items() if k.split(".")[0] not in sparse)
        t = f32(dense)
        legs["grads over data"] = (lambda t=t: dist.all_reduce(t, group=data), dense * 4)
        ids = table_touched_ids(cfg, local)
        for name in sorted(sparse):
            u = ids[name].numel()
            gi, gr = torch.ones(u, dtype=torch.int32, device=ctx.dev), f32(u, di)
            oi, orow = torch.ones(u * n_d, dtype=torch.int32, device=ctx.dev), f32(u * n_d, di)
            legs[f"sparse {name}"] = (lambda gi=gi, gr=gr, oi=oi, orow=orow: (
                all_gather_into(oi, gi, group=data), all_gather_into(orow, gr, group=data)),
                u * (di + 1) * 4)
        t = f32(6)
        legs["metrics"] = (lambda t=t: dist.all_reduce(t, group=data), 24)
    parts, total = [], 0
    for name, (fn, nbytes) in legs.items():
        fn()
        ctx.align()
        ms = ctx.max_over_ranks([ctx.time(lambda: [fn() for _ in range(20)])[0] / 20])[0]
        parts.append(f"{name} {nbytes} bytes {ms:.4f} ms")
        total += nbytes
    return "; ".join(parts) + f"; a rank hands the collectives {total} bytes a step"


def ce_shape_times(torch, ctx, b: int, c: int, d: int) -> str:
    """B10 and B11 + B12 at (b, c, d), rank 0 alone: against the plain
    versions (1e-5 of scale) and timed (CUDA events, 20 back to back) beside
    the library calls (logsumexp of U I^T; autograd's backward of it)."""
    from two_tower_models_tpu_torch.ops import fused_softmax as fs

    gen = torch.Generator(device=ctx.dev)
    gen.manual_seed(ctx.seed + 52)
    u = torch.randn(b, d, generator=gen, device=ctx.dev) * 0.3
    i = torch.randn(c, d, generator=gen, device=ctx.dev) * 0.3
    g = torch.rand(b, generator=gen, device=ctx.dev) / b
    _, lse = fs.in_batch_ce_fwd(u, i, False)
    _, lse_p = fs.in_batch_ce_fwd_plain(u, i, False)
    ok_f, err_f = close(lse, lse_p, 0.0, 1e-5 * float(lse_p.abs().max()))
    got, want = fs.in_batch_ce_bwd(u, i, lse, g, False), fs.in_batch_ce_bwd_plain(u, i, lse_p, g, False)
    checks = [close(x, y, 0.0, 1e-5 * float(y.abs().max())) for x, y in zip(got, want)]
    ok = ok_f and all(o for o, _ in checks)
    if not ok:
        ctx.fail(f"CE kernels at ({b}, {c}, {d}) vs plain: {err_f:.3g}, {[e for _, e in checks]}")
    ua, ia = u.clone().requires_grad_(), i.clone().requires_grad_()
    with torch.enable_grad():
        lse_lib = torch.logsumexp(ua @ ia.T, 1)
    legs = {"B10": lambda: fs.in_batch_ce_fwd(u, i, False),
            "B11 + B12": lambda: fs.in_batch_ce_bwd(u, i, lse, g, False),
            "library fwd": lambda: torch.logsumexp(u @ i.T, 1),
            "library bwd": lambda: torch.autograd.grad(lse_lib, (ua, ia), g, retain_graph=True)}
    ms = {}
    for name, fn in legs.items():
        fn()
        ms[name] = ctx.time(lambda: [fn() for _ in range(20)])[0] / 20
    fb = bound((b + c) * d * 4 + 2 * b * 4, 3 * 2 * b * c * d, TF32_FLOPS)
    bb = bound(2 * (b + c) * d * 4 + 2 * b * 4, 6 * b * c * d, F32_FLOPS)
    return (f"B10 at ({b}, {c}, {d}) {ms['B10']:.4f} ms (bound {fb[0]:.4f}, {fb[1]}; library "
            f"{ms['library fwd']:.4f}); B11 + B12 {ms['B11 + B12']:.4f} ms with its reduce "
            f"(bound {bb[0]:.4f}, {bb[1]}; library {ms['library bwd']:.4f}); against plain "
            f"ok={ok} (max_abs_err {err_f:.3g}, {max(e for _, e in checks):.3g})")


def single_card_ms(torch, ctx, cfg, tcfg) -> float | None:
    """One card's make_train_step at B = SHARD_TRAIN_B, on rank 0 alone
    (the others wait): ms/step of SHARD_STEPS steps after 3, by CUDA events."""
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    ms = None
    if ctx.rank == 0:
        data, _ = shard_train_data(torch, ctx, cfg, SHARD_TRAIN_B, ctx.seed + 53)
        idx = torch.arange(SHARD_TRAIN_B, device=ctx.dev)
        state = create_train_state(ctx.seed + 50, cfg, tcfg, device=ctx.dev)
        step = make_train_step(cfg, tcfg)
        with torch.enable_grad():
            for _ in range(3):
                state, _ = step(state, data, idx)
            t = ctx.time(lambda: [step(state, data, idx) for _ in range(SHARD_STEPS)])[0]
        ms = t / SHARD_STEPS
    torch.distributed.barrier()
    return ms


def k_steps_leg(torch, ctx, cfg, tcfg) -> None:
    """15c: SHARD_K steps a dispatch on (2, 2): one dispatch of [K, B]
    batches bit-equal to K single sharded steps from the same block (the
    parameters; the metrics their mean), SHARD_K launches of each kernel a
    dispatch, and the mean metrics within 1e-4 of one card's K steps."""
    import dataclasses

    from two_tower_models_tpu_torch.config import MeshConfig
    from two_tower_models_tpu_torch.models.two_tower import Batch
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.parallel.sharding import shard_state
    from two_tower_models_tpu_torch.parallel.train_step import local_batch, make_sharded_train_step
    from two_tower_models_tpu_torch.parallel.sparse_grads import sparse_table_grad_names
    from two_tower_models_tpu_torch.training.step import make_train_step

    shape, label = (2, 2), f"train 2x2 K={SHARD_K}"
    mesh, mesh_cfg = ctx.mesh(shape), MeshConfig(*shape)
    b = SHARD_TRAIN_B * shape[0]
    parts = [shard_train_data(torch, ctx, cfg, b, ctx.seed + 60 + k) for k in range(SHARD_K)]
    stacked = Batch(*(None if ts[0] is None else torch.stack(ts)
                      for ts in zip(*(bt for _, bt in parts))))
    tk = dataclasses.replace(tcfg, steps_per_dispatch=SHARD_K)
    full = shard_full_state(torch, ctx, cfg, tcfg, shape[1])
    one, many = (shard_state(full, cfg, mesh, False, ctx.dev) for _ in range(2))
    multi = make_sharded_train_step(cfg, tk, mesh, mesh_cfg)
    step = make_sharded_train_step(cfg, tcfg, mesh, mesh_cfg)
    ctx.align()
    with torch.enable_grad():
        _lib.reset_launch_counts()
        many, m_k = multi(many, stacked)
        counts = ctx.launches[label] = dict(_lib.launches)
        singles = []
        for _, bt in parts:
            one, m = step(one, bt)
            singles.append(m)
    same = all(torch.equal(p, q) for p, q in zip(many.params.parameters(), one.params.parameters()))
    mean_ok = all(torch.allclose(m_k[k], torch.stack([m[k] for m in singles]).mean(0), rtol=1e-6)
                  for k in m_k)
    local = local_batch(parts[0][1], mesh.get_local_rank("data"), shape[0])
    expect = train_launches(cfg, len(sparse_table_grad_names(cfg, mesh_cfg, local, one.params)))
    if ctx.dev.type == "cuda":
        check_only_launches(counts, expect, SHARD_K, ctx.failures, f"rank {ctx.rank}: {label}")
    if not (same and mean_ok):
        ctx.fail(f"{label}: K steps a dispatch against K steps: params equal {same}, metrics "
                 f"the mean {mean_ok}")
    line = ""
    if ctx.rank == 0:
        data = type(parts[0][0])(*(None if ts[0] is None else torch.cat(ts)
                                   for ts in zip(*(d for d, _ in parts))))
        idx = torch.arange(SHARD_K * b, device=ctx.dev).view(SHARD_K, b)
        with torch.enable_grad():
            _, want = make_train_step(cfg, tk)(full, data, idx)
        # steps 2-K follow two trajectories apart: Adam moves the elements of
        # near-zero gradient by about lr whatever the bf16 noise says
        rel = {k: abs(float(m_k[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
               for k in want}
        worst = max(rel, key=rel.get)
        if rel[worst] > BF16_TOL:
            ctx.fail(f"{label}: mean {worst} {rel[worst]:.3g} from one card's")
        line = (f"; mean loss {float(m_k['loss']):.6f} beside one card's {float(want['loss']):.6f} "
                f"(K steps a dispatch there too), the worst metric {worst} at {rel[worst]:.3g} "
                f"relative (tol {BF16_TOL})")
    del full
    ctx.say(f"sharded {label} on {ctx.world} x {ctx.name}: one dispatch of {SHARD_K} x B={b} "
            f"bit-equal to {SHARD_K} single steps={same}, metrics their mean={mean_ok}; launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}{line}")


def mns_leg(torch, ctx) -> None:
    """15c: scripts/exp_mns_scale.py's mns+logq model on (2, 2), one global
    batch extended once by training.data.extend_batch_for_idx (64 mixed
    negatives, oracle logQ) on the host, handed to every rank: gradients
    against one card (the step refuses the arm's grad_clip_norm, so none),
    B10-B12 at D = 65; and B10, B11 + B12 at that width timed on rank 0."""
    import dataclasses

    from two_tower_models_tpu_torch.config import MeshConfig, TrainConfig, resolve_kernel_flags
    from two_tower_models_tpu_torch.training.data import (
        extend_batch_for_idx,
        gather_batch,
        make_synthetic_data,
    )

    shape = (2, 2)
    b = SHARD_TRAIN_B * shape[0]
    cfg = resolve_kernel_flags(mns_cfg("mns+logq"), ctx.dev)
    data_cfg = dataclasses.replace(mns_exp("mns+logq", 1).data, num_samples=b)
    data = make_synthetic_data(data_cfg, device="cpu")
    idx = torch.arange(b)
    batch = extend_batch_for_idx(cfg, data, gather_batch(data, idx), ctx.seed + 55, idx)
    batch = type(batch)(*(None if t is None else t.to(ctx.dev) for t in batch))
    label = "train 2x2 mns+logq"
    _, _, line = grads_leg(torch, ctx, label, cfg, MeshConfig(*shape), shape, batch,
                           TrainConfig(learning_rate=1e-3))
    ctx.say(f"sharded {label} on {ctx.world} x {ctx.name}: train-65k-sharded-branches, B={b}, "
            f"{cfg.mixed_negatives} mixed negatives: {line}; launches "
            f"{json.dumps({k: v for k, v in ctx.launches[label].items() if v})}")
    if ctx.rank == 0:
        ctx.say(f"sharded {label} CE on {ctx.name}: " + ce_shape_times(
            torch, ctx, SHARD_TRAIN_B, b + cfg.mixed_negatives, cfg.item_id_embedding_dim + 1))
    torch.distributed.barrier()


def packed_leg(torch, ctx) -> None:
    """15e: scripts/bench_tables.py's 2^22-row tables, packed [2^21, 128],
    on (2, 2) at SHARD_TRAIN_B rows a card: both tables through the sparse
    exchange ("auto"), gradients against one card, SHARD_STEPS // 2 timed
    steps (launches: B18 for each lookup's backward on the packed shards,
    each exchange's scatter and the position table), the peak memory a rank."""
    from two_tower_models_tpu_torch.config import MeshConfig, TrainConfig
    from two_tower_models_tpu_torch.parallel.sparse_grads import sparse_table_grad_names
    from two_tower_models_tpu_torch.parallel.train_step import local_batch, make_sharded_train_step

    shape, label = (2, 2), "train 2x2 4M packed"
    cfg = flagship_cfg(SHARD_TABLE_ROWS)
    tcfg = TrainConfig(learning_rate=1e-3, pack_tables_min_rows=SHARD_TABLE_ROWS)
    b = SHARD_TRAIN_B * shape[0]
    mesh, mesh_cfg = ctx.mesh(shape), MeshConfig(*shape)
    _, batch = shard_train_data(torch, ctx, cfg, b, ctx.seed + 56)
    block, ref, line = grads_leg(torch, ctx, f"{label} grads", cfg, mesh_cfg, shape, batch, tcfg)
    del ref
    local = local_batch(batch, mesh.get_local_rank("data"), shape[0])
    sparse = sparse_table_grad_names(cfg, mesh_cfg, local, block.params)
    packed = {n: tuple(getattr(block.params, n).shape) for n in ("user_id_table", "item_id_table")}
    if sparse != {"user_id_table", "item_id_table"}:
        ctx.fail(f"{label}: sparse tables {sorted(sparse)}")
    step = make_sharded_train_step(cfg, tcfg, mesh, mesh_cfg)
    cuda = ctx.dev.type == "cuda"
    with torch.enable_grad():
        for _ in range(3):
            block, _ = step(block, batch)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.dev)
    n = max(SHARD_STEPS // 2, 1)
    block, metrics, ms, issue = timed_steps(
        torch, ctx, label, step, block, batch, n,
        train_launches(cfg, len(sparse) + lookup_b18(cfg, block.params, local)))
    peak = ctx.max_over_ranks([torch.cuda.max_memory_allocated(ctx.dev) / 2**30 if cuda else 0.0])[0]
    held = sum(t.numel() * t.element_size() for t in (*block.params.parameters(),
                                                      *block.opt_state.mu.values(),
                                                      *block.opt_state.nu.values())) / 2**30
    if not finite(torch, metrics):
        ctx.fail(f"{label}: metrics not finite")
    ctx.say(f"sharded {label} on {ctx.world} x {ctx.name}: train-4M-packed-sharded, B={b} "
            f"({SHARD_TRAIN_B} a card), shards {packed}, sparse tables {sorted(sparse)}: {line}; "
            f"{n} steps: ms/step {ms:.3f} (max over ranks; issued in {issue:.3f}); launches a step "
            f"{json.dumps({k: v // n for k, v in ctx.launches[label].items() if v})}; a rank holds "
            f"{held:.2f} GiB of parameters and moments, peak {peak:.2f} GiB (max over ranks)")


def train_rank_legs(ctx) -> None:
    """Phase 15b-15e on this rank (every rank runs every leg, in order)."""
    from two_tower_models_tpu_torch.config import MeshConfig, TrainConfig

    torch = ctx.torch
    t0 = time.perf_counter()
    cfg, tcfg = flagship_cfg(TRAIN_ROWS), TrainConfig(learning_rate=1e-3)
    cuda = ctx.dev.type == "cuda"
    # 15b: the flagship on each mesh, beside one card
    single = single_card_ms(torch, ctx, cfg, tcfg)
    for shape in ((4, 1), (2, 2), (1, 4)):
        shard_train_mesh(torch, ctx, cfg, tcfg, shape, single)
        if cuda:
            torch.cuda.empty_cache()
    if ctx.rank == 0:
        for n_d in (4, 2):
            ctx.say(f"sharded train CE on {ctx.name}: " + ce_shape_times(
                torch, ctx, SHARD_TRAIN_B, SHARD_TRAIN_B * n_d, cfg.item_id_embedding_dim))
    torch.distributed.barrier()
    # 15c: the step's other branches on (2, 2), one fixed batch each
    shape = (2, 2)
    _, batch = shard_train_data(torch, ctx, cfg, SHARD_TRAIN_B * shape[0], ctx.seed + 51)
    ref = None
    for name, kw, strategy in (("sparse on", {"sparse_table_grads": "on"}, "psum"),
                               ("sparse off", {"sparse_table_grads": "off"}, "psum"),
                               ("all_to_all", {}, "all_to_all"),
                               ("tower_tp", {"tower_tp": True}, "psum")):
        label = f"train 2x2 {name}"
        _, ref, line = grads_leg(torch, ctx, label, cfg, MeshConfig(*shape, **kw), shape, batch,
                                 tcfg, strategy, ref)
        ctx.say(f"sharded {label} on {ctx.world} x {ctx.name}: train-65k-sharded-branches: "
                f"{line}; launches {json.dumps({k: v for k, v in ctx.launches[label].items() if v})}")
    del ref
    k_steps_leg(torch, ctx, cfg, tcfg)
    mns_leg(torch, ctx)
    # 15d: the rest of the zoo
    for preset_name in ZOO_PRESETS:
        zc = zoo_cfg(preset_name)
        label = f"train 2x2 {ZOO_SHORT[preset_name]}"
        _, zb = shard_train_data(torch, ctx, zc, SHARD_TRAIN_B * shape[0], ctx.seed + 57, zc.kd)
        _, _, line = grads_leg(torch, ctx, label, zc, MeshConfig(*shape), shape, zb, tcfg)
        ctx.say(f"sharded {label} on {ctx.world} x {ctx.name}: train-65k-sharded-zoo: {line}; "
                f"launches {json.dumps({k: v for k, v in ctx.launches[label].items() if v})}")
    if cuda:
        torch.cuda.empty_cache()
    # 15e: the packed 4M tables
    packed_leg(torch, ctx)
    if cuda:
        torch.cuda.empty_cache()
    ctx.say(f"sharded 15b-15e: wall {time.perf_counter() - t0:.1f} s")


def train_one_leg(torch, args, smi, entries, failures) -> None:
    """15a: a world of one over NCCL on card 0, mesh (1, 1), the flagship at
    B = TRAIN_BATCH: SHARD_STEPS steps of make_sharded_train_step beside
    make_train_step on the same batch from the same state, bit-equal (every
    metric each step; parameters and moments after), then SHARD_STEPS timed
    steps of each: the sharded step's launches a step (phase 4's), no host
    sync in a step."""
    from two_tower_models_tpu_torch.config import MeshConfig, TrainConfig
    from two_tower_models_tpu_torch.parallel import mesh as pm
    from two_tower_models_tpu_torch.parallel.sharding import shard_state
    from two_tower_models_tpu_torch.parallel.train_step import make_sharded_train_step
    from two_tower_models_tpu_torch.training.data import gather_batch
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    dev = pm.init_process_group(0, 1, f"tcp://localhost:{free_port()}", device="cuda")
    try:
        mesh = pm.single_device_mesh("cuda")
        cfg, tcfg = flagship_cfg(TRAIN_ROWS), TrainConfig(learning_rate=1e-3)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 40)
        data = fixed_batch(torch, gen, dev, cfg, TRAIN_BATCH)
        idx = torch.arange(TRAIN_BATCH, device=dev)
        batch = gather_batch(data, idx)
        ref = create_train_state(args.seed + 41, cfg, tcfg, device=dev)
        st = shard_state(ref, cfg, mesh)  # a copy; ref is left as it is
        single = make_train_step(cfg, tcfg)
        sharded = make_sharded_train_step(cfg, tcfg, mesh, MeshConfig())
        same_m = True
        with torch.enable_grad():
            for _ in range(SHARD_STEPS):
                ref, want = single(ref, data, idx)
                st, got = sharded(st, batch)
                same_m &= list(got) == list(want) and all(torch.equal(got[k], want[k])
                                                          for k in want)
        pairs = list(zip(st.params.parameters(), ref.params.parameters()))
        pairs += [(st.opt_state.mu[k], ref.opt_state.mu[k]) for k in ref.opt_state.mu]
        pairs += [(st.opt_state.nu[k], ref.opt_state.nu[k]) for k in ref.opt_state.nu]
        same_p = all(torch.equal(p, q) for p, q in pairs)
        on_batch = lambda s, d, i: sharded(s, batch)
        st, metrics, ms, host, counts = run_steps(torch, on_batch, st, data, idx, SHARD_STEPS)
        ref, _, ms_ref, host_ref, _ = run_steps(torch, single, ref, data, idx, SHARD_STEPS)
        label = "sharded 15a"
        check_only_launches(counts, train_launches(cfg), SHARD_STEPS, failures, label)
        st, syncs = count_syncs(torch, on_batch, st, data, idx)
        if not (same_m and same_p) or syncs or not finite(torch, metrics):
            failures.append(f"{label}: metrics bit-equal {same_m}, params bit-equal {same_p}, "
                            f"host syncs {syncs}")
        for k in ("fused_history_encoder_res", "fused_history_encoder_bwd", "fused_in_batch_ce",
                  "in_batch_ce_bwd", "rows_scatter_add"):
            if k in entries:
                entries[k]["launches_sharded_train_1x1"] = counts.get(k, 0)
        print(f"launches on the sharded 1x1 training path ({SHARD_STEPS} steps): "
              f"{json.dumps(counts)}", flush=True)
        print(f"sharded 15a, a world of one over {torch.distributed.get_backend()} on "
              f"{torch.cuda.get_device_name(0)} ({smi}), mesh 1x1, train-65k-sharded-1x1, "
              f"B={TRAIN_BATCH}: {SHARD_STEPS} steps of make_sharded_train_step beside "
              f"make_train_step: every metric bit-equal each step={same_m}, parameters and "
              f"moments bit-equal after={same_p}; ms/step {ms:.3f} (host {host:.3f}) beside "
              f"make_train_step's {ms_ref:.3f} (host {host_ref:.3f}) in this call; host syncs in "
              f"a step {syncs}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def shard_rank_main(torch, rank: int, world: int, port: int, seed: int, nb: int,
                    device="cuda", train: bool = True) -> dict:
    """The four-card legs on one rank (14b-14e, then with ``train``
    15b-15e): {"failures": [...], "launches": {...}}."""
    from two_tower_models_tpu_torch.parallel import mesh as pm

    dev = pm.init_process_group(rank, world, f"tcp://localhost:{port}", device=device)
    ctx = ShardRank(torch, rank, world, dev, seed, nb)
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    cfg, model, ids, feats, batches = shard_inputs(torch, seed, nb)
    ctx.say(f"sharded set-up: {world} ranks over "
            f"{torch.distributed.get_backend()}, model and catalog from --seed on the host in "
            f"{time.perf_counter() - t0:.1f} s")
    shard_collectives(ctx, cfg)
    # 14b
    ref, exact_outs, exact14 = shard_exact_leg(ctx, cfg, model, ids, feats, batches, (1, 4),
                                               CORPUS)
    shard_exact_leg(ctx, cfg, model, ids, feats, batches, (2, 2), CORPUS, ref)
    shard_exact_leg(ctx, cfg, model, ids, feats, batches, (1, 4), CORPUS - SHARD_PAD, ref)
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
    # 14c
    shard_approx_legs(ctx, cfg, model, ids, feats, batches, exact_outs)
    # 14d
    shard_branch_legs(ctx, cfg, model, ids, feats, batches, ref, exact14)
    del exact14
    shard_light_ranker_leg(ctx)
    # 14e
    shard_recall_leg(ctx, cfg, model, ids, feats, batches, ref, exact_outs)
    del ref, exact_outs, model, batches
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
    if train:  # 15b-15e
        train_rank_legs(ctx)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return {"failures": ctx.failures, "launches": ctx.launches}


def _shard_rank_entry(rank: int, world: int, port: int, seed: int, nb: int, out: str) -> None:
    """A spawned rank of phase 14b-14e: its result (or its traceback) to ``out``."""
    import traceback

    import torch

    try:
        res = shard_rank_main(torch, rank, world, port, seed, nb)
    except Exception:
        res = {"failures": [f"rank {rank} raised:\n{traceback.format_exc()}"], "launches": {}}
        with open(out, "w") as fh:
            json.dump(res, fh)
        raise SystemExit(1)
    with open(out, "w") as fh:
        json.dump(res, fh)


def shard_one_leg(torch, args, smi, entries, failures) -> None:
    """14a: a world of one over NCCL on card 0, mesh (1, 1), at full width:
    RetrievalEngine.from_params(mesh=...) bit-equal (indices and scores) to
    the single-device engine over the same corpus rows on ten batches,
    with the exact route's launches a batch."""
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.parallel import mesh as pm
    from two_tower_models_tpu_torch.parallel.train_step import _user_tower
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact, sharded_mips_topk
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    dev = pm.init_process_group(0, 1, f"tcp://localhost:{free_port()}", device="cuda")
    try:
        ctx = ShardRank(torch, 0, 1, dev, args.seed, args.batches)
        mesh = pm.single_device_mesh("cuda")
        cfg, model, ids, feats, batches = shard_inputs(torch, args.seed, args.batches)
        eng = RetrievalEngine.from_params(model, cfg, ids, feats, mesh=mesh)
        eng.warmup(BATCH)
        local, rows = eng._state
        ref = RetrievalEngine(model, cfg, rows)  # the model moves to the card here
        ref.warmup(BATCH)
        dev_batches = [tuple(t.to(dev) for t in bt) for bt in batches]
        expect = {"fused_history_encoder": 1, **MIPS_ROUTE, **ENC_TC, "fused_history_encoder_tc": 1}
        label = "sharded 1x1"
        outs, ms = ctx.serve(label, lambda bt: eng.query(*bt), dev_batches, expect)
        ref_outs, ref_ms = ctx.serve("single-device", lambda bt: ref.query(*bt), dev_batches,
                                     alone=True)
        counts = ctx.launches[label]
        print(f"launches on the {label} path: {json.dumps(counts)}", flush=True)
        for name in ("fused_history_encoder", "tile_max_scores", "select_topk_radix",
                     "gather_rescore_invert", "gather_rescore"):
            if name in entries:
                entries[name]["launches_sharded_1x1"] = counts.get(name, 0)
        idx_equal = all(torch.equal(a, b) for a, b in zip(outs, ref_outs))
        sc_equal = True
        with torch.inference_mode():
            for u, f, h in dev_batches:
                q, _ = _user_tower(local, cfg, mesh, u, f, h, "psum")
                got = sharded_mips_topk(rows, q, TOPK, valid_count=CORPUS, embeddings=False)
                q_ref, _ = tt.compute_user_embedding(ref._state[0], cfg, u, f, h)
                want = mips_topk_exact(ref.corpus, q_ref, TOPK)
                sc_equal &= torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        rows_ok = rows.shape == (CORPUS, cfg.item_id_embedding_dim)
        if not (idx_equal and sc_equal and rows_ok):
            ctx.fail(f"{label}: indices equal {idx_equal}, scores equal {sc_equal}, rows {rows_ok}")
        failures.extend(ctx.failures)
        print(f"sharded 14a, a world of one over {torch.distributed.get_backend()} on "
              f"{torch.cuda.get_device_name(0)} ({smi}), mesh 1x1, C={CORPUS}, B={BATCH}, "
              f"k={TOPK}: indices bit-equal to the single-device engine={idx_equal}, scores "
              f"bit-equal={sc_equal} on {len(batches)} batches; ms/batch {ms:.3f} (issued in "
              f"{ctx.issue_ms[label]:.3f}) beside the single-device query {ref_ms:.3f} (issued "
              f"in {ctx.issue_ms['single-device']:.3f}) in this call", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def phase_sharded(torch, args, smi, entries, failures, only: bool) -> None:
    """Phases 14 and 15: 14a and 15a in this process; 14b-14e and 15b-15e
    in four spawned ranks, one a card, when this host has four cards."""
    import multiprocessing
    import tempfile

    t_phase = time.perf_counter()
    shard_one_leg(torch, args, smi, entries, failures)
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    train_one_leg(torch, args, smi, entries, failures)
    torch.cuda.empty_cache()
    print(f"sharded 15a: wall {time.perf_counter() - t15:.1f} s", flush=True)
    n = torch.cuda.device_count()
    if n < SHARD_CARDS:
        print(f"sharded 14b-14e, 15b-15e: skipped: the four-card legs need {SHARD_CARDS} cards "
              f"of one host (python3 chip_smoke.py --only sharded on such a host); this host "
              f"has {n}",
              flush=True)
        if only:
            failures.append(f"--only sharded needs {SHARD_CARDS} cards, this host has {n}")
        return
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(SHARD_CARDS)]
        procs = [ctx.Process(target=_shard_rank_entry,
                             args=(r, SHARD_CARDS, port, args.seed, args.batches, outs[r]))
                 for r in range(SHARD_CARDS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_TIMEOUT
        while time.monotonic() < deadline and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # the others wait in a collective for the one that failed
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        launches = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if not os.path.exists(out):
                failures.append(f"sharded rank {r} exited with {p.exitcode} and no result")
                continue
            with open(out) as fh:
                res = json.load(fh)
            failures.extend(res["failures"])
            if p.exitcode != 0 and not res["failures"]:
                failures.append(f"sharded rank {r} exited with {p.exitcode}")
            launches.append(res["launches"])
    for label in (launches[0] if launches else {}):
        per_rank = [lc.get(label, {}) for lc in launches]
        for name in ("fused_history_encoder", "tile_max_scores", "select_topk_radix",
                     "gather_rescore_invert", "gather_rescore", "approx_scan", "fused_attn_stack"):
            if name in entries and any(name in lc for lc in per_rank):
                entries[name].setdefault("launches_sharded_4", {})[label] = [
                    lc.get(name, 0) for lc in per_rank]
    print(f"sharded: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--only", choices=["sharded"], default=None,
                    help="run phase 1 (the build) and phases 14 and 15 (sharded serving "
                         "and training) alone; the four-card legs then must run")
    args = ap.parse_args()

    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs a GPU", file=sys.stderr)
        return 2
    try:
        from two_tower_models_tpu_torch.models import two_tower as tt
        from two_tower_models_tpu_torch.models.history_encoder import (
            sinusoidal_positional_encoding,
        )
        from two_tower_models_tpu_torch.ops import _lib
        from two_tower_models_tpu_torch.ops import fused_encoder as fe
        from two_tower_models_tpu_torch.ops import mips_topk as mt
        from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact
    except ImportError as e:
        print(f"the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)

    # ---- phase 1: environment and build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = [subprocess.Popen(  # beside the build, which they do not slow by much
        [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(_lib.CSRC / f"{src}.cu"),
         "-o", str(_lib.BUILD_DIR / f"ptxas_{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("fused_softmax", "fused_mha", "select_topk", "rows_write", "fused_encoder",
                    "fused_encoder_bwd", "tile_max", "gather_rescore", "history_attention",
                    "approx_scan")]
    _lib.library()
    ptxas_log = "\n".join(p.communicate(timeout=600)[0] for p in ptxas)
    print(smi, flush=True)
    print(
        f"env: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"kernel build {_lib.build_seconds if _lib.build_seconds is not None else 0.0:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)",
        flush=True,
    )
    from two_tower_models_tpu_torch.ops import approx_topk as at
    from two_tower_models_tpu_torch.ops import fused_mha as fm
    from two_tower_models_tpu_torch.ops import fused_softmax as fs
    from two_tower_models_tpu_torch.ops import history_attention as ha

    ept = fm._fwd_tc_tile(HIST, 64)
    enc_smem = fe._enc_tc_plan(TRAIN_BATCH, HIST, 64, 3, 1)[2]
    bwd_smem = fe._enc_bwd_tc_plan(TRAIN_BATCH, HIST, 64, 3, 1)[2]
    spills, ptxas_lines = ptxas_report(
        ptxas_log, ["ce_fwd_tc_kernel", "ce_bwd_kernel", "ce_bwd_reduce", "mha_fwd_tc_kernel",
                    "mha_bwd_tc_kernel",
                    "select_radix_kernel", "select_topk_kernel", "rows_write_kernel",
                    "encoder_tc_kernel", "encoder_bwd_tc_kernel", "tile_max_kernel",
                    "rescore_kernel", "invert_count_kernel", "invert_scan_kernel",
                    "invert_scatter_kernel", "attn_fwd_tc_kernel", "attn_bwd_tc_kernel",
                    "approx_scan_kernel", "approx_scan_tc_kernel"], {
            # B10 (<MULTI>: D > 64), fwd::smem_bytes in csrc/fused_softmax.cu
            **{f"ce_fwd_tc_kernel<{m}>": fs.fwd_smem_bytes(m) for m in (0, 1)},
            # bwd::SMEM_FLOATS in csrc/fused_softmax.cu
            "ce_bwd_kernel": 4 * (128 * 68 + 2 * 64 * 68 + 128 * 72 + 2 * 128),
            "ce_bwd_reduce": 0,
            # the instances of the cells' H = 32 (two key bands), D = 64
            f"mha_fwd_tc_kernel<{HIST // 16}>": fm._fwd_tc_smem_bytes(HIST, 64, ept),
            f"mha_bwd_tc_kernel<{HIST // 16}, 64>": fm._bwd_tc_plan(TRAIN_BATCH, HIST, 64, 1)[2],
            # B1, B5 and B8 (<RES, STACK, Hp / 16>) at the cells' three layers
            **{f"encoder_tc_kernel<{res}, {stack}, {HIST // 16}>": enc_smem
               for res, stack in ((0, 0), (1, 0), (0, 1))},
            # B6, B7 and B9 (<MODE, Hp / 16, D>: MODE 0 from the stored
            # residuals, 1 by recompute, 2 the stack)
            **{f"encoder_bwd_tc_kernel<{mode}, {HIST // 16}, 64>": bwd_smem for mode in (0, 1, 2)},
            # B2 and B4 at the serving cell's D = 64
            "tile_max_kernel": mt._tile_max_smem_bytes(64),
            "rescore_kernel": mt._rescore_smem_bytes(64),
            # N1 at D = 64, B = 1024: the FMA kernel (<INT8>) and the tensor
            # cores (<ROWS>: 0 f32, 1 int8, 2 bf16)
            **{f"approx_scan_kernel<{i}>": at.scan_smem_bytes(64, ("f32", "int8")[i], "fma")
               for i in (0, 1)},
            **{f"approx_scan_tc_kernel<{i}>": at.scan_smem_bytes(64, kind, "tc", BATCH)
               for i, kind in enumerate(at.ROW_KINDS)},
            **{f"invert_{k}_kernel": 0 for k in ("count", "scan", "scatter")},
            # B15 on the tensor cores (<DH, warps on the n, keys a tile, stages>)
            **{f"attn_fwd_tc_kernel<{dh}, {', '.join(map(str, ha.tc_shape(i, dh)))}>":
               ha.fwd_tc_smem_bytes(i, dh) for i in range(len(ha._TC_PLANS))
               for dh in ha.HEAD_DIMS},
            # B16 and B17 on the tensor cores (<MODE: 0 B16, 1 B17; DH, warps
            # on the n, rows a tile, stages>)
            **{f"attn_bwd_tc_kernel<{m}, {dh}, {', '.join(map(str, ha.bwd_tc_shape(i, dh)))}>":
               ha.bwd_tc_smem_bytes(m, i, dh) for m in (0, 1)
               for i in range(len(ha._BWD_PLANS)) for dh in ha.HEAD_DIMS},
        })
    dev = torch.device(DEVICE)
    if args.only == "sharded":
        entries, failures = {}, [f"ptxas: {n} spills or gave no report" for n in spills]
        phase_sharded(torch, args, smi, entries, failures, only=True)
        return finish(torch, t_start, entries, failures)

    # ---- set-up: full-width model, catalog, engine ---------------------
    t0 = time.perf_counter()
    cfg, gen, model, engine, batches = serve_setup(torch, args, dev)
    corpus = engine.corpus
    print(f"setup: model + corpus {tuple(corpus.shape)} {corpus.dtype} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2: kernels against their plain versions -----------------
    uid, feat, hist = batches[0]
    with torch.inference_mode():
        q, _ = tt.compute_user_embedding(model, cfg, uid, feat, hist)
    layers = model.history_encoder.attn_layers
    w = [torch.stack([getattr(getattr(l, p), a) for l in layers]).detach()
         for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))]
    pe = sinusoidal_positional_encoding(HIST, 64, dev)
    x_f32 = model.item_id_table.detach()[hist]
    x_bf16 = x_f32.to(torch.bfloat16)
    nh, nl, d, b, c = 4, 3, 64, BATCH, CORPUS
    nt = c // mt.TILE
    entries, failures = {}, [f"ptxas: {n} spills or gave no report" for n in spills]

    def entry(name, source, replaces, ok, err, ms, plain_ms, bytes_, flops, rate, library_ms):
        bms, by = bound(bytes_, flops, rate)
        if not ok:
            failures.append(name)
        entries[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
        }
        print(f"kernel {name}: ok={ok} max_abs_err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
              f"library_ms={library_ms}", flush=True)

    # kernel 1: whole encoder (main path: bf16, on the tensor cores); f32 checked too
    enc_args = lambda x: (x, pe, *w, nh)
    route = fe._enc_route(torch.bfloat16, HIST, d, nh, nl)
    w_k = [fe._f32(t, dev) for t in w]
    fma1 = lambda: fe._launch_fwd_fma("fused_history_encoder", x_bf16, fe._pe(pe, x_bf16), *w_k, nh)
    ok_bf, err_bf = enc_checks(
        torch, "encoder", (fe.fused_history_encoder(*enc_args(x_bf16)),),
        (fe.fused_history_encoder(*enc_args(x_bf16)),),
        (fe.fused_history_encoder_plain(*enc_args(x_bf16)),),
        (fe.fused_history_encoder_f64_sums(*enc_args(x_bf16)),), (fma1(),), ("y",))
    ok_32, err_32 = close(fe.fused_history_encoder(*enc_args(x_f32)),
                          fe.fused_history_encoder_plain(*enc_args(x_f32)), 1e-4, 1e-4)
    print(f"encoder route {route}; f32: ok={ok_32} max_abs_err={err_32:.3g} (tol 1e-4)", flush=True)
    entry(
        "fused_history_encoder", "two_tower_models_tpu_torch/csrc/fused_encoder.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:506",
        ok_bf and ok_32 and route == "tc", err_bf,
        time_ms(torch, lambda: fe.fused_history_encoder(*enc_args(x_bf16))),
        time_ms(torch, lambda: fe.fused_history_encoder_plain(*enc_args(x_bf16))),
        b * HIST * d * 2 + HIST * d * 4 + sum(t.numel() for t in w) * 4 + b * 2 * d * 2,
        b * enc_flops(HIST, d, nl), BF16_FLOPS, None,
    )
    e1 = entries["fused_history_encoder"]
    e1["kernel_route"] = route
    x0 = (x_f32 + pe).to(torch.bfloat16)
    enc_times(torch, e1, lambda: fe.fused_history_encoder(*enc_args(x_bf16)), fma1,
              lambda: b13_layers(x0, None, w, nh))
    print(enc_line(torch, smi, f"B1 at B={b}", e1), flush=True)
    e1["note"] = ("kernel_route is the kernel fused_history_encoder takes (tc: the tensor cores); "
                  "device_ms that kernel's device time from torch.profiler; fma_* the FMA "
                  "kernel (encoder_kernel) on the same inputs; b13x3_device_ms three B13 "
                  "launches (full layers) on x + PE")
    del x0

    # kernel 2: tile maxes
    tm_fn = lambda: mt.tile_max_scores(q, corpus, mt.TILE, c)
    mk = tm_fn()
    mp = mt.tile_max_scores_plain(q, corpus, mt.TILE, c)
    scale = float(mp.abs().max())
    ok, err = close(mk, mp, 1e-5, 1e-5 * scale)
    ok = nonfinite_check(torch, dev) and ok
    entry(
        "tile_max_scores", "two_tower_models_tpu_torch/csrc/tile_max.cu",
        "two_tower_models_tpu/ops/pallas/mips_topk.py:112", ok, err,
        time_ms(torch, tm_fn),
        time_ms(torch, lambda: mt.tile_max_scores_plain(q, corpus, mt.TILE, c), 3),
        b * d * 4 + c * d * 4 + b * nt * 4, 2 * b * c * d, F32_FLOPS,
        time_ms(torch, lambda: (q @ corpus.T).view(b, nt, mt.TILE).amax(-1), 3),
    )
    e2 = entries["tile_max_scores"]
    qblocks, runs, per_sm, tm_smem = mt._tile_max_plan(b, c, d, _lib.sm_count(q.device.index))
    e2["device_ms"] = call_device_ms(torch, tm_fn)
    e2["plan"] = {"query_blocks": qblocks, "runs": runs, "blocks_an_sm": per_sm,
                  "smem_bytes": tm_smem}
    e2["ptxas"] = "; ".join(ptxas_lines.get("tile_max_kernel", []))
    print(f"B2 at B={b}, C={c}, D={d} on {smi}: device {e2['device_ms']:.4f} ms, with the host's "
          f"dispatch {e2['ms']:.4f}; bound {e2['bound_ms']:.4f} ({e2['bound_by']}), "
          f"{e2['bound_ms'] / max(e2['device_ms'], 1e-9):.1%} of it; {qblocks} query blocks x "
          f"{runs} runs, {per_sm} blocks an SM; ptxas {e2['ptxas']}", flush=True)

    # kernel 3 at pass 2 ([B, NT]) and pass 4 ([B, k*TILE]); kernel 4 between
    kk, ik = mt.select_rows(mk, TOPK)
    kp, ip = mt.select_keys_plain(mt.f32_keys(mk).clamp_min(-(1 << 31) + 1), TOPK)
    ok2 = torch.equal(kk, kp) and torch.equal(ik, ip)
    tile_idx = torch.sort(ik, dim=1).values
    ck = rescore_checks(torch, dev, smi, q, corpus, mk, tile_idx, ptxas_lines, entry, entries)
    ck4, ik4 = mt.select_rows(ck, TOPK)
    cp4, ip4 = mt.select_keys_plain(mt.f32_keys(ck).clamp_min(-(1 << 31) + 1), TOPK)
    ok4 = torch.equal(ck4, cp4) and torch.equal(ik4, ip4)
    # the selected values as f32, kernel against plain, over both passes;
    # the pass condition stays exact equality of keys and positions
    _, err2 = close(mt.keys_f32(kk), mt.keys_f32(kp), 0.0, 0.0)
    _, err4 = close(mt.keys_f32(ck4), mt.keys_f32(cp4), 0.0, 0.0)
    sel_err = max(err2, err4)
    idx_mismatch = int((ik != ip).sum()) + int((ik4 != ip4).sum())
    # the tournament (k > K_MAX's route) at the same shapes, launched alone
    tour = lambda x: mt._launch_select(x, TOPK, True, "tournament")
    ok_tour = all(torch.equal(a, e) for x, want in ((mk, (kp, ip)), (ck, (cp4, ip4)))
                  for a, e in zip(tour(x), want))
    passes = (mk, ck)
    sel = {
        "ms": [time_ms(torch, lambda: mt.select_rows(x, TOPK)) for x in passes],
        "device_ms": [call_device_ms(torch, lambda: mt.select_rows(x, TOPK)) for x in passes],
        "plain_ms": [time_ms(torch, lambda: mt.select_keys_plain(
            mt.f32_keys(x).clamp_min(-(1 << 31) + 1), TOPK), 3) for x in passes],
        "library_ms": [time_ms(torch, lambda: torch.topk(x, TOPK), 3) for x in passes],
        "library_device_ms": [call_device_ms(torch, lambda: torch.topk(x, TOPK)) for x in passes],
        "tournament_ms": [time_ms(torch, lambda: tour(x)) for x in passes],
        "tournament_device_ms": [call_device_ms(torch, lambda: tour(x)) for x in passes],
    }
    print(f"select pass2 exact={ok2} ms={sel['ms'][0]:.4f} (device {sel['device_ms'][0]:.4f}); "
          f"pass4 exact={ok4} ms={sel['ms'][1]:.4f} (device {sel['device_ms'][1]:.4f}); index "
          f"mismatches {idx_mismatch}; torch.topk device {sel['library_device_ms'][0]:.4f}, "
          f"{sel['library_device_ms'][1]:.4f}; the tournament exact={ok_tour} device "
          f"{sel['tournament_device_ms'][0]:.4f}, {sel['tournament_device_ms'][1]:.4f}", flush=True)
    entry(
        "select_topk_radix", "two_tower_models_tpu_torch/csrc/select_topk.cu",
        "two_tower_models_tpu/ops/pallas/mips_topk.py:319", ok2 and ok4 and ok_tour, sel_err,
        sum(sel["ms"]), sum(sel["plain_ms"]),
        (b * nt * 4 + b * TOPK * 8) + (b * TOPK * mt.TILE * 4 + b * TOPK * 8), 0, F32_FLOPS,
        sum(sel["library_ms"]),
    )
    e3 = entries["select_topk_radix"]
    e3.update({f"{key}_by_pass": v for key, v in sel.items()})
    e3["device_ms"] = sum(sel["device_ms"])
    e3["library_device_ms"] = sum(sel["library_device_ms"])
    e3["tournament_device_ms"] = sum(sel["tournament_device_ms"])
    e3["note"] = ("times are pass 2 + pass 4 of one query batch (_by_pass: each); ms with the "
                  "host's dispatch (CUDA events), device_ms the kernels alone (torch.profiler); "
                  "library is torch.topk, which keeps no tie order; tournament_* the kernel "
                  "that takes k > K_MAX, at these shapes")
    e3["index_mismatches"] = idx_mismatch
    del mp
    torch.cuda.empty_cache()

    # ---- phase 3: serve ------------------------------------------------
    cpu_model = copy.deepcopy(model).cpu()
    counts, serve_ms = serve_leg(
        torch, "serve", engine, model, cpu_model, cfg, [(*bt, None) for bt in batches],
        {"fused_history_encoder": 1, **MIPS_ROUTE, **ENC_TC, "fused_history_encoder_tc": 1},
        ["fused_history_encoder", "tile_max_scores", "select_topk_radix", "gather_rescore_invert",
         "gather_rescore"],
        entries, failures, smi,
    )
    e1["tc_launches"] = counts.get("fused_history_encoder_tc", 0)

    # where a batch's time goes: the user tower and the MIPS, each alone
    u, f, h = batches[0]
    with torch.inference_mode():
        tower_ms = time_ms(torch, lambda: tt.compute_user_embedding(model, cfg, u, f, h))
        q_serve, _ = tt.compute_user_embedding(model, cfg, u, f, h)
        mips_ms = time_ms(torch, lambda: mips_topk_exact(corpus, q_serve, TOPK))
    print(f"stages: user tower {tower_ms:.4f} ms, exact MIPS {mips_ms:.4f} ms "
          f"per B={BATCH} batch", flush=True)

    # ---- phase 2b: serve variable-length histories ----------------------
    phase_serve_varlen(torch, args, gen, smi, dev, cfg, model, cpu_model, engine, w,
                       entry, entries, failures)
    del engine, corpus, batches, model, cpu_model
    torch.cuda.empty_cache()

    # ---- phase 4 (and 4c): train; phase 4b: train variable lengths -------
    bwd_ptxas = ["; ".join(ptxas_lines.get(f"encoder_bwd_tc_kernel<{mode}, {HIST // 16}, 64>", []))
                 for mode in (0, 1, 2)]
    train_cfg4, train_cfg, b56_ms = phase_train(torch, args, smi, dev, entry, entries, failures,
                                                bwd_ptxas[0], bwd_ptxas[1],
                                                "; ".join(ptxas_lines.get("ce_fwd_tc_kernel<0>", [])))
    torch.cuda.empty_cache()
    phase_train_varlen(torch, args, smi, dev, train_cfg4, train_cfg, entry, entries, failures,
                       bwd_ptxas[2])
    torch.cuda.empty_cache()

    # ---- phase 5: large tables -------------------------------------------
    ms_packed = phase_tables(torch, args, smi, dev, entry, entries, failures)
    torch.cuda.empty_cache()

    # ---- phase 6: the per-layer attention tier ---------------------------
    layer_legs = phase_layer(torch, args, smi, dev, entry, entries, failures, b56_ms,
                             "; ".join(ptxas_lines.get(f"mha_bwd_tc_kernel<{HIST // 16}, 64>", [])))
    torch.cuda.empty_cache()

    # ---- phase 7: the blockwise attention tier ---------------------------
    phase_blockwise(torch, args, smi, dev, entry, entries, failures, b56_ms, layer_legs,
                    " | ".join(f"plan {i} (H {('<= 64', '> 64')[i]}): "
                               + "; ".join(ptxas_lines.get(
                                   f"attn_fwd_tc_kernel<16, {', '.join(map(str, ha.tc_shape(i, 16)))}>",
                                   []))
                               for i in range(len(ha._TC_PLANS))),
                    {tag: " | ".join(
                        f"plan {i}: " + "; ".join(ptxas_lines.get(
                            f"attn_bwd_tc_kernel<{m}, 16, "
                            f"{', '.join(map(str, ha.bwd_tc_shape(i, 16)))}>", []))
                        for i in range(len(ha._BWD_PLANS))) for m, tag in ((0, "B16"), (1, "B17"))})

    # ---- phase 8: fused Adam ---------------------------------------------
    phase_fused_adam(torch, args, smi, dev, entry, entries, failures, ms_packed)
    torch.cuda.empty_cache()

    # ---- phase 9: the training loop --------------------------------------
    phase_loop(torch, args, smi, dev, entries, failures)
    torch.cuda.empty_cache()

    # ---- phase 10: mixed negatives and the logQ correction ---------------
    phase_mns(torch, args, smi, dev, entries, failures)
    torch.cuda.empty_cache()

    # ---- phase 11: the light ranker, KD and the reward model --------------
    phase_zoo(torch, args, smi, dev, entries, failures, b56_ms,
              entries["fused_history_encoder_bwd_recompute"].get("busy_ms_step_b5_b6"), serve_ms)
    torch.cuda.empty_cache()

    # ---- phase 12: approximate and int8 MIPS -----------------------------
    phase_approx(torch, args, smi, dev, entry, entries, failures, serve_ms, e2["device_ms"],
                 {k: v for k, v in ptxas_lines.items() if k.startswith("approx_scan")})
    torch.cuda.empty_cache()

    # ---- phase 13: raw-key ingest and reference-checkpoint interop --------
    phase_raw(torch, args, smi, dev, entries, failures, serve_ms)
    torch.cuda.empty_cache()

    # ---- phases 14 and 15: sharded serving and training ------------------
    phase_sharded(torch, args, smi, entries, failures, only=False)
    return finish(torch, t_start, entries, failures)


def finish(torch, t_start: float, entries: dict, failures: list) -> int:
    """The wall, the kernels line and, if nothing failed, the ok line."""
    print(f"smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    if failures:
        _fail(", ".join(failures))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
