#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Drives the port's two user-facing paths on the card at the size of the
paper's fMRI application (225 time points x 59 subjects x 200 x 200 regions,
2.12 GB in float32, synthetic data made from ``--seed``): one big tensor
through ``Problem.from_tensor -> plan_sweep -> cp_als``, and the fleet of its
59 per-subject tensors (225 x 200 x 200) served by ``CPService`` through
``Problem(batch=8) -> plan_sweep -> batched cp_als``; the kernelized 2-step
MTTKRP and the explicit KRP (``ops.mttkrp_2step_kernel``,
``ops.krp_materialize``); the measured-autotuning path ``tune() ->
plan_sweep("autotune") -> cp_als`` and ``-> CPService``; and the legacy
front door (``core.cp_als(x, CPConfig(...))``) and pairwise-perturbation
sweeps (``Problem(pp_tol > 0) -> plan_sweep("pp") -> cp_als``, tuned and
served); and the sharded front door in an NCCL world of one (the sharded,
overlapping and compressed executors, ``executor="auto"``, ``tune(mesh=)``
and ``CPService(mesh=)``, the two-level node mesh and sharded pairwise
perturbation); and the LM serving path, OLMo-1B at full width and depth
served through ``ServeEngine`` (``build_model -> ServeEngine -> generate ->
prefill / decode_step``), with its checkpoint restored by
``launch.serve --ckpt-dir``; and the other LM families on that path,
falcon-mamba-7b and recurrentgemma-2b at full width and depth,
qwen2-moe-a2.7b at full width cut to 8 layers and whisper-base; and the LM
training path, OLMo-1B trained at full width and depth (``make_train_step``
with accumulation and remat, the fault-tolerant ``train_loop``,
``launch.train`` writing the checkpoint ``launch.serve`` serves); and the
sharded LM in an NCCL world of one (the compressed data-parallel step and
``launch.train``/``launch.serve`` on a mesh, bitwise their local runs), and
the other families' tensor and expert parallelism there (the MoE, SSM,
hybrid and enc-dec models served and trained on the mesh, against their
local runs).  Holds all seven
CUDA kernel entries (fused and matrix-free MTTKRP and multi-TTV, unbatched
and batched, and the KRP pair) against their plain PyTorch versions, at the
main path's rank and at ranks 80 and 128 (column blocks), and in bf16,
fp16 and float64 as well as float32; the LM
path reaches none of them (the reference computes its attention, FFN and
logits with plain products, no Pallas kernel).

    python3 chip_smoke.py [--seed 0] [--rank 10] [--sweeps 5]
    python3 chip_smoke.py --only fused                # phases 0-7 of rows 1 and 3 only
    python3 chip_smoke.py --only matrix_free          # phases 0-4 of row 2 only
    python3 chip_smoke.py --only batched_matrix_free  # phases 0, 1, 5, 7 of row 4 only
    python3 chip_smoke.py --only pp                   # phases 0, 1 and 12 only
    python3 chip_smoke.py --only dist                 # phases 0, 1 and 13 only
    python3 chip_smoke.py --only lm                   # phases 0 and 14 only
    python3 chip_smoke.py --only lm_families          # phases 0 and 15 only
    python3 chip_smoke.py --only train                # phases 0 and 16 only
    python3 chip_smoke.py --only sharded_lm           # phases 0, 16d and 17 only
    python3 chip_smoke.py --only sharded_families     # phases 0 and 18 only
    python3 chip_smoke.py --only dryrun               # phases 0 and 19 only
    python3 chip_smoke.py --only examples             # phases 0 and 20 only
    python3 chip_smoke.py --only high_rank            # phases 0, 1 and 21 only
    python3 chip_smoke.py --only dtypes               # phases 0, 1 and 22 only
    python3 chip_smoke.py --only krp                  # phase 0 and row 7 of 1, 8, 11, 21, 22

Phases (any failure ends the run with a non-zero exit and no result line):

0. device: name, count, power limit; TF32 switched off for matmuls and cuDNN.
1. build: all seven kernel entries from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel); registers, shared memory and spills.
2. kernels vs plain versions on the card: the fused kernel on every mode of
   the 4-way tensor (pos 0, 1 and 2); the matrix-free kernel on every mode
   of the 4-way tensor, its 3-way linearization (225 x 59 x 20100) and small
   order-5 and order-6 tensors, each with its launch geometry, and on the
   4-way tensor also at rank 64, at ``blocks_per_sm`` 1, run twice bitwise
   and on a misaligned view of 8 subjects bitwise equal to the aligned call.
   Norm-wise relative error ``|K-P|/|P|`` must stay under ``REL_ERR_BOUND``.
3. main path: ``cp_als`` for strategies auto, fused and matrix_free from one
   seeded init; kernel launch counts, per-sweep fits (finite, agreeing within
   ``FIT_AGREE``), per-sweep time and peak memory; a ``torch.profiler``
   trace of the ``matrix_free`` sweeps (device operations a sweep, busy
   share, idle gaps, the ten longest operations); plus a small tensor whose
   card run must agree with the port's CPU run.
4. timing of each kernel per mode at the main path's shapes with CUDA
   events, beside its plain version, one PyTorch einsum call and the bound
   ``max(bytes / 3.35e12, flops / 67e12)``; for both kernels also device
   ms a launch (``torch.profiler``) and the CUDA kernels a call (counted
   exactly in a CUDA graph of one call: 1 with one group, 2 with more, as
   each launch states), and for the matrix-free kernel its residency and
   cluster slots against the CUDA occupancy queries.
5. batched kernels vs plain versions on the card, same bound: both on every
   mode of an 8-subject batch (8 x 225 x 200 x 200, cut from the tensor by
   subject) and of an odd 5-subject batch, the matrix-free one also on small
   order-4, 5 and 6 batches; both at rank 16 (the serving path's second
   signature) on the 8-subject batch and, unbatched, on subject 0; slab 0's
   output bitwise unchanged when the other slabs hold other data; the
   batched fused kernel bitwise equal to the batched matrix-free kernel on
   the 8-subject batch (its views of a 3-way stack are the stack itself).
6. serving path: ``CPService(batch_size=8, n_iters=sweeps, tol=0)`` under
   strategies autotune (empty tuning cache: the model plans), fused and
   matrix_free serves the 59 subjects at rank ``--rank`` plus subjects 0-7
   again at rank 16 (a second signature), one seeded init per request shared
   by every strategy.  Checks the serving counters (67 completed, 2
   signatures, 2 compiles, 9 batches, 5 padded slots), the batched launch
   counts read off each plan (3 modes x sweeps x 9 batches under the kernel
   strategies, no unbatched launch), finite results, fits agreeing across
   strategies within ``FIT_AGREE`` and subject 0 against the unbatched
   ``cp_als`` on that subject alone; then ``batch_size=1`` under fused and
   matrix_free on the 8 rank-16 requests (only the unbatched kernel, 8 x
   sweeps x 3 launches; finite results whose fits agree with the
   ``batch_size=8`` ones within ``FIT_AGREE``).  Prints problems/s and ms per batch (host clock
   over a second flush of the same fleet) and peak memory.
7. timing of both batched kernels per mode at ``(8, 225, 200, 200)``, as in
   phase 4 (device ms a launch and CUDA kernels a call, which must be 1,
   for both), and the batched sweep's time outside the kernels: the host-clock
   time of a batched ``cp_als`` run as a dispatch runs it (one sync) less
   the kernels' CUDA-event times from the separate timing loop.
8. new kernels vs plain versions on the card, same bound: multi-TTV at the
   fMRI tensor's 2-step second steps (mode 1 right-first, T 225 x 59 x 10;
   mode 2 left-first, T 200 x 200 x 10) at ranks 10, 16 and 64; batched
   multi-TTV at the 8-subject batch's mode-1 left-first partial (8 x 200 x
   200 x 10) at ranks 10, 16 and 64 and at an odd S = 5, slab 0 bitwise
   unchanged by the other slabs; both on a ragged shape (T 3 x 59 x 7:
   I * C % 4 != 0, L shorter than a cluster); each at every ``block_i``
   candidate and 32 and 1024, with its launch geometry; the KRP pair and
   ``krp_materialize`` on the factors of modes 1-3 (2.36 M rows, 94 MB)
   and of modes 0-1, bitwise their plain versions, and the KRP pair's
   edge cases (a row span off the 16-byte unit, B or A off a 16-byte
   line, 70000 rows of B at ``block_b=1``), each bitwise with one launch
   on the path (16-byte or one-element) it should take; the
   fused and matrix-free kernels on every mode at each ``blocks_per_sm``
   candidate (the default bitwise equal to a call without the knob); every
   new kernel bitwise repeatable.
9. the kernelized 2-step MTTKRP on every mode of the 4-way tensor against
   the einsum oracle (multi-TTV on modes 1-2, the fused fallback on modes 0
   and 3), ``krp_materialize`` of the factors of modes 1-3 and
   ``ops.multi_ttv_batched`` on the batch, each with its launch counts.
10. the tuning path: ``tune()`` on the 4-way tensor (no budget cap; tile
   rows, node rows, elapsed), ``plan_sweep("autotune")`` on that cache
   (every node carries ``measured_s``), ``cp_als`` under the tuned plan
   (fits within ``FIT_AGREE`` of phase 3's ``auto`` fits, kernel launches
   = the plan's kernel leaves x sweeps, per-sweep time, peak memory); then
   ``tune()`` on subject 0 and ``CPService(batch_size=1,
   strategy="autotune")`` serving subjects 0-7 from phase 6's inits (one
   warm-plan hit, fits within ``FIT_AGREE`` of phase 6's, launches read off
   the plan).
11. timing, as in phase 4, of multi-TTV (both shapes), batched multi-TTV and
   the KRP pair (the 94 MB KRP's last fold, with its TB/s and path; gate:
   the 16-byte path), each beside its plain version,
   one PyTorch call and the bound; for the multi-TTV rows also the host
   time a call (host clock over 200 calls, no sync inside) and the device
   time a call (``torch.profiler``, every CUDA kernel a call launches),
   for the kernel and for the library call; the fused and matrix-free
   sweep at each ``blocks_per_sm`` candidate; and the CUDA kernels one
   multi-TTV call launches, counted in a CUDA graph of the call (must be 1).

12. the legacy front door and PP sweeps.  (a) ``core.cp_als(x4,
   CPConfig(rank, method=m))`` for ``m`` in fused and matrix_free bitwise
   equal (factors, weights, per-sweep fits) to phase 3's ``plan.cp_als``,
   with 4 x sweeps launches of row 1 / row 2; one ``core.cpals.als_sweep``
   (fused, matrix_free) and one ``core.dimtree.dimtree_sweep`` bitwise equal
   to one engine sweep under the matching plan.  (b) ``cp_als`` under
   ``plan_sweep(Problem.from_tensor(x4, rank, pp_tol=PP_TOL), "pp")`` for
   ``PP_SWEEPS`` sweeps from phase 3's init beside the exact ``auto`` run:
   the exact/approximate sequence (at least one of each), ``pp_exact_sweeps``,
   one host-gate read a sweep, finite fits within ``PP_FIT_AGREE`` of the
   exact run's, launches read off the plan, and the last approximate
   sweep's first-order MTTKRP closer to the exact one at its factors than
   the largest drift; printed: ms per exact and approximate sweep, the
   cache build (CUDA events) and its peak memory, the exact fraction
   against ``PP_EXACT_FRACTION``.  (c) ``tune(x4, rank, pp_tol=PP_TOL)``:
   positive PP rows, and the ``autotune`` plan priced on them
   (``describe()["pp"]["basis"] == "measured"``).  (d) ``CPService(
   batch_size=8, pp_tol=PP_FLEET_TOL, strategy="pp")`` serving the 59
   subjects from phase 6's inits: counters (59 completed, 8 batches, 5
   padded slots, one ``|pp`` signature), finite fits (gap to phase 6's
   printed), ``pp_exact_sweeps`` per batch, problems/s.  (e) a small PP run
   on the card and on the CPU: the same sequence, fits within
   ``SMALL_FIT_AGREE``.
13. sharded CP-ALS over a ``torch.distributed`` DeviceMesh, in an NCCL
   world of one (``init_process_group("nccl", init_method="file://...",
   rank=0, world_size=1)``, mesh ``(1, 1)`` of ``("data", "model")``; NCCL
   failing to start fails the run, nothing falls back).  (a) mode-parallel
   on the fMRI tensor with ``mode_axes={0: "data", 2: "model"}``: for
   matrix_free and fused, ``plan.cp_als`` under ``plan_sweep(...,
   executor="sharded")`` with ``make_executor("sharded", ...)`` and
   ``dist_cp_als(method=m)``, each bitwise equal (factors, weights,
   per-sweep fits) to phase 3's local run, with 4 x sweeps launches of row 2
   / row 1 and the collective count derived from the plan's schedule
   (``_expected_gathers``); printed: seconds a sweep sharded against local
   (host clock) and a trace of one sharded sweep with NCCL's share.  (b)
   ``dist_dimtree_sweep`` for 3 sweeps bitwise equal to ``dimtree_sweep``.
   (c) batch-parallel: subjects 0-7 stacked, ``mode_axes={}``,
   ``batch_axes=("data",)``, under matrix_free and fused, bitwise equal to
   the local batched engine, with 3 x sweeps launches of row 4 / row 3.
   (d) the overlapping executor (``n_chunks`` 4) on (a)'s problem under
   matrix_free and fused: every leaf in 4 slabs within ``LEAF_REL`` of the
   sharded leaf; ``plan.cp_als`` with fits within ``FIT_AGREE`` of phase
   3's, the launches (one a slab), collectives (one an axis a slab) and
   slab copies (each slab of a mode past the first) the plan and the
   chunks state; printed: the bytes copied a sweep, seconds a sweep against
   sharded and local, and a trace of one sweep with the NCCL operations
   that ran beside another device operation.  The binary tree for 3
   sweeps bitwise equal to the sharded executor's, the chain's fits
   within ``FIT_AGREE``.  (e) the compressed executor on the same problem
   under matrix_free and fused: fits finite and within
   ``COMPRESSED_FIT_AGREE`` of phase 3's, every residual changed every
   sweep, the launches, collectives and int8 gathers the plan states;
   printed: int8 gathers and bytes a sweep, seconds a sweep.  (f)
   ``select_executor``/``plan_sweep(executor="auto")`` under the H100
   constants, with each kind's predicted seconds.  (g) ``tune(mesh=,
   mode_axes=)`` in its default budget: the rows of the three kinds, the
   fitted ``serial_fractions`` and the ``autotune`` plan, whose
   ``cp_als`` fits agree with phase 3's within ``FIT_AGREE``
   (``COMPRESSED_FIT_AGREE`` if it picks the compressed kind).  (h)
   ``CPService(mesh=)`` serving the 67 requests of phase 6 batch-parallel
   at batch 8 under matrix_free and fused, beside the single-device
   service from the same inits: phase 6's counters, 3 x sweeps x 9
   launches of row 4 / row 3, fits within ``FIT_AGREE`` of both services'
   (the single-device one of this phase and phase 6's).  (i) the two-level
   path on ``make_node_mesh(1, 1)`` with ``{0: "node", 2: "device"}`` and
   ``intra_axes=("device",)``, under matrix_free and fused: every node
   planned flat (one node: no level to split), no lower bound and not
   certified; ``plan.cp_als`` bitwise equal to phase 3's run (and so to
   (a)'s), 4 x sweeps launches, (a)'s collective count and no
   reduce-scatter; ``reduce_scatter`` (an NCCL all-to-all),
   ``all_gather`` and ``hierarchical_psum`` of a mode-1 MTTKRP on the
   one-rank group the identity bitwise, one reduce-scatter sending 0
   bytes; ``tune(mesh=, intra_axes=)`` stores rows under a ``|node1`` key.
   (j) sharded PP on (a)'s mesh and mapping at ``PP_TOL`` for
   ``PP_SWEEPS`` sweeps: the pairs at the init bitwise the local
   executor's; the exact/approximate sequence, fits, host-gate reads and
   the last cache's pairs bitwise phase 12b's local run; launches read off
   the plan; printed: exact and approximate ms a sweep against the local
   ones, the sharded cache build (CUDA events) and its peak memory.  Then
   ``CPService(mesh=, pp_tol=PP_FLEET_TOL, strategy="pp")`` serving the 59
   subjects batch-parallel: fits, sequences and exact sweeps a batch
   bitwise phase 12d's single-device PP fleet, and its counters.

14. the LM serving path (no kernel of the port; TF32 off as set in phase 0).
   (a) olmo-1b at full width and depth (16 layers, d_model 2048, 16 heads of
   128, d_ff 8192, vocab 50304, tied embeddings; bf16 compute over fp32
   parameters, as its config states) built by ``build_model(cfg,
   device="cuda", generator=...)`` from ``--seed``: its parameter count
   must be the reference's ``OLMO_1B_PARAMS``; ``ServeEngine`` serves
   ``LM_REQUESTS`` prompts as ``launch.serve`` makes them (lengths in [4,
   16) from ``np.random.default_rng(seed)``), batch ``LM_BATCH``,
   ``LM_NEW_TOKENS`` greedy tokens: every rid answered, every token in
   ``[0, vocab)``, a second flush bitwise equal, and ``generate`` equal to
   a manual ``prefill`` + ``decode_step`` argmax loop; printed: prefill ms
   and decode ms a token (CUDA events), tokens/s (host clock over the
   second flush), peak memory, and the decode step's bound (each fp32
   weight read once over ``HBM_BW``).  (e) the 14a model and
   ``init_opt_state`` of it saved by the port's ``CheckpointManager`` into
   a temporary directory; ``launch.serve --ckpt-dir`` (in process) restores
   it and serves ``default_rng(0)``'s prompts, bitwise the tokens the 14a
   model serves for them.  (b) teacher-forced decode against the parallel
   forward in fp32 compute, within ``LM_LOGIT_TOL``: olmo-1b at full width
   and depth, and qwen3-8b at full width cut to ``QWEN3_LAYERS`` layers
   (GQA g = 4, QK-norm, rope_theta 1e6: the grouped branch).  (c) olmo-1b
   at full width cut to ``LM_SMALL_LAYERS`` layers, fp32, on the CPU and,
   with the same parameters, on the card: prefill and 4 decode logits
   within ``LM_LOGIT_TOL``; greedy tokens reported, and gated where the
   CPU's top-2 gap exceeds the tolerance.  (d) that card model's dense FFN
   weights factored by ``compress_ffn`` (rank ``LM_CP_RANK``) on the card;
   the ``cp_rank`` model serves ``LM_BATCH`` requests, and its prefill
   logits agree within ``LM_LOGIT_TOL`` with the dense model whose FFN
   weights are the products ``A @ B``.

15. the other LM families on the serving path (no kernel of the port: the
   reference's scans and MoE dispatch are plain ``jnp``), one model resident
   at a time, random weights from ``--seed``, bf16 compute over fp32
   parameters: (a) falcon-mamba-7b (Mamba-1 SSM) and (b) recurrentgemma-2b
   (RG-LRU, rec, rec, local-attention) at full width and depth, (c)
   qwen2-moe-a2.7b at full width cut to 8 of 24 layers (60 experts padded
   to 64, top-4, a shared expert), (d) whisper-base (enc-dec, whole, the
   engine's zero frames).  Each: its parameter count (``FAMILIES``);
   ``ServeEngine`` serves ``LM_REQUESTS`` prompts as ``launch.serve`` makes
   them plus a batch whose longest prompt is ``FAMILY_LONG_PROMPT`` (the
   SSM's chunked scan), ``LM_NEW_TOKENS`` greedy tokens, batch ``LM_BATCH``:
   every rid answered, a second flush bitwise equal, the first batch equal
   to a manual ``prefill`` + ``decode_step`` loop; printed: prefill ms (the
   first batch and the long one) and decode ms a token (CUDA events),
   tokens/s (host clock over the second flush), peak memory, the decode
   step's bound (each fp32 weight read once over ``HBM_BW``), a traced
   decode step's device operations and busy share, and for (c) the pairs
   dropped at capacity in prefill and decode.  Gates in fp32: decode
   against the forward at full width (``FAMILY_CHECK``: falcon-mamba 4
   layers over 256 tokens, the chunked scan against 256 recurrent steps;
   recurrentgemma 3 layers; qwen2-moe 2 layers on 8 tokens, no pair
   dropped; whisper-base whole, ``decode_step`` against ``decode_train``)
   and the card against the port's CPU run (``FAMILY_SMALL_LAYERS``
   layers, whisper-base whole), within ``LM_LOGIT_TOL``, greedy tokens
   equal where the CPU's top-2 gap is wider; the checkpoint round trip
   bitwise for whisper-base whole (restored and served by ``launch.serve
   --ckpt-dir``) and falcon-mamba-7b cut to 2 layers (every leaf, and the
   served tokens).

16. the LM training path (no kernel of the port: the reference's training
   step reaches no Pallas kernel), one model resident at a time.  (a)
   olmo-1b at full width and depth, bf16 compute over fp32 parameters, remat
   on: ``analysis.flops.param_count`` must be ``OLMO_1B_PARAMS``;
   ``make_train_step`` with ``accum_steps`` ``TRAIN_ACCUM`` on
   ``SyntheticLM`` batches of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` from ``--seed``,
   ``TRAIN_WARMUP_STEPS`` steps then ``TRAIN_TIMED_STEPS`` timed ones (CUDA
   events): ms a step, tokens/s, ``model_flops`` (6 N D) a second against
   ``BF16_PEAK_FLOPS``, peak memory, and a traced step (device operations,
   busy share, the ten longest); gates: loss and grad norm finite, every
   leaf moved by the first step, the last loss below the first.  (b) olmo-1b
   at full width cut to ``TRAIN_SMALL_LAYERS`` layers, fp32: one step on the
   card against the port's CPU step (metrics, each gradient leaf, the
   updated parameters, at ``TRAIN_*`` bounds), ``accum_steps`` 2 against 1
   under ``TRAIN_ACCUM_BOUND``, remat on against off bitwise, and
   ``train_loop`` for ``TRAIN_LOOP_STEPS`` steps (checkpoint every
   ``TRAIN_CKPT_EVERY``) with a fault at ``TRAIN_FAULT_STEP`` bitwise the
   unfaulted run (losses, parameters and optimizer state), one failure, steps
   4 and 5 replayed; checkpoint GB and save/restore seconds.  (c)
   ``TRAIN_FAMILIES`` (falcon-mamba-7b, recurrentgemma-2b and qwen2-moe-a2.7b
   at full width cut to 2 layers, whisper-base whole): one fp32 step of
   ``TRAIN_FAMILY_BATCH`` x ``TRAIN_FAMILY_SEQ`` tokens on the card against
   the CPU (metrics at the ``TRAIN_*`` bounds; the MoE's expert choices and
   drops equal on both).  (d) ``launch.train`` trains olmo-1b at full width
   and depth on the card (``TRAIN_DRIVER_STEPS`` steps of
   ``TRAIN_DRIVER_BATCH`` x ``TRAIN_SEQ``, a checkpoint at the last), then
   ``launch.serve --ckpt-dir`` restores that step and serves 4 requests: the
   served parameters bitwise the trained ones.

17. the sharded LM in an NCCL world of one (``init_process_group("nccl",
   init_method="file://...", rank=0, world_size=1)``, mesh ``(1, 1)`` of
   ``("data", "model")``; NCCL failing to start fails the run, nothing
   falls back).  (a) olmo-1b at full width and depth, bf16 compute over fp32
   parameters: ``SHARDED_STEPS`` steps of ``SHARDED_BATCH`` x ``TRAIN_SEQ``
   ``SyntheticLM`` tokens from one init, by ``make_train_step`` and by
   ``make_compressed_dp_step`` exact and compressed; gates: losses finite,
   the exact run bitwise the local one (losses and every parameter), the
   compressed run's last loss within ``SHARDED_GAP`` of the exact run's,
   one int8 gather a reference leaf a step, every residual leaf nonzero
   after step 1; printed: ms a step (CUDA events) of each run, int8 GB a
   step, peak memory.  (b) ``launch.train --distributed --dp 1 --tp 1`` as
   16d: the trained parameters bitwise 16d's, the sharded path's
   collectives counted (``dist.TP``, ``GATHERS``, ``SCATTERS`` above 0),
   its checkpoint restored with ``mesh`` and ``model.partition_specs(mesh)``
   bitwise, and ``launch.serve --distributed --tp 1 --ckpt-dir`` serving
   16d's tokens; printed: step seconds against 16d's.

18. the other families on the mesh, in an NCCL world of one as phase 17
   (mesh ``(1, 1)``; NCCL failing to start fails the run).  (a) serving at
   full width, bf16 compute over fp32 parameters, the depths of phase 15
   (falcon-mamba-7b and recurrentgemma-2b whole, qwen2-moe-a2.7b cut to 8
   of 24 layers, whisper-base whole): a ``ServeEngine`` on the mesh (the
   serving layout's blocks) and a local one on the same ``--seed`` weights;
   gates: the greedy tokens equal, the prefill logits bitwise equal (or
   within ``LM_LOGIT_TOL``, printed as differing), the family's layers
   counted in ``dist.TP`` (its SSM, RG-LRU, expert-parallel MoE or cross
   attention); printed: decode ms a token (CUDA events) on the mesh and
   locally, peak memory.  (b) training at full width, each family at 2
   layers (whisper-base whole), fp32, ``TRAIN_FAMILY_BATCH`` x
   ``TRAIN_FAMILY_SEQ`` tokens: one ``make_train_step`` on the mesh bitwise
   the local step (loss and every parameter), its collectives counted;
   printed: step ms (CUDA events) on the mesh and locally.  A model axis
   above 1 (tensor and expert parallelism proper, the query-row attention
   layout) needs a second rank, which NCCL refuses on one card: the 8-rank
   gloo worlds of ``tests/test_torch_sharded_lm_{moe,scan}.py`` check it.
19. FSDP and the dry-run, each part in a process of its own (a process
   holds one default process group).  (a) olmo-1b whole, bf16 compute over
   fp32 parameters, ``SHARDED_STEPS`` steps of ``SHARDED_BATCH`` x
   ``TRAIN_SEQ`` tokens as 17a, in an NCCL world of one on a (1, 1) mesh:
   ``make_train_step(fsdp=True)`` (parameters and AdamW state on the FSDP
   blocks, gathered a layer at a time) against the ``drop_fsdp`` step there
   and the local step; gate: bitwise (losses and every parameter); printed:
   ms a step (CUDA events), peak memory, ``fsdp_gather`` calls a step.
   (b) that step traced by the dry-run's counters
   (``launch.dryrun.measure``) on fake tensors in a fake world of one, then
   run on the card under the same counters; gates: flops, HBM bytes and
   collective operand bytes equal (the trace is the card's program), the
   predicted peak (arguments + temp) within ``DRYRUN_PEAK_BOUND`` of the
   allocator's; printed: ``RooflineTerms`` (nominal H100 constants) beside
   the measured ms.  (c) ``launch.dryrun`` of ``DRYRUN_CELLS`` and
   ``launch.dryrun_cp --method auto`` on the pod mesh (a fake world of 256),
   in processes on the host started with the phase (beside 19a-b); gate:
   each ``ok`` with exit code 0;
   printed: each record's flops, collective bytes, a rank's argument and
   temp GB and its ``RooflineTerms``.
20. the user-facing surface, each part a process of its own with
   ``--device cuda`` (the kernels built first, so the parts reuse them);
   the fMRI example runs alone, then the other parts together (none of
   them is timed): ``examples/repro_torch/quickstart.py`` (gates: the fused CUDA kernel
   launched, its error within the example's bound); ``fmri_cpals.py`` at
   the paper's size (``FMRI``, rank 10; gates: every fit finite, auto's
   fit within ``FIT_AGREE`` of the baseline's on the 4-way and the 3-way
   tensor, both runs starting from the same seeded init; printed: ms an
   iteration of each and the speedups); ``distributed_cpals.py`` under
   ``torch.distributed.run --standalone --nproc-per-node 1`` (an NCCL world
   of one, ``--data 1 --model 1``); ``serve_lm.py`` and ``train_lm.py`` at
   their defaults; ``tools/check_docs_torch.py --device cuda`` on the
   architecture and serving documents (the distributed one needs 8 ranks
   and runs on the CPU in the tests).  Any part's failure fails the phase.
21. the MTTKRP kernels above rank 64, run right after phase 13 while the
   fMRI tensor and its fleet are on the card (a rank above 64 is cut into
   column blocks of one launch: ``matrix_free.column_blocks``).  At ranks
   80 and 128: rows 1-2 on every mode of the fMRI tensor, rows 3-4 on
   every mode of the 8-subject batch, row 5 at the 2-step path's second
   steps (modes 1 and 2), row 6 at the batch's mode-1 second step and row
   7 at the KRP's last fold; gates: each within ``REL_ERR_BOUND`` of its
   plain version, run twice bitwise, one counted launch a call and the
   CUDA kernels a call its design states (a CUDA graph of one call);
   printed: kernel ms (CUDA events) beside the bound ``max(bytes /
   3.35e12, flops / 67e12)`` (the tensor counted once, whatever the design
   reads), the plain version and one ``torch.einsum``, row 7 also its TB/s
   and path (gate: 16-byte); rows 1-2 also at
   rank 64, one column block, timed beside them.  Then ``cp_als`` under
   auto, fused and matrix_free for ``HIGH_RANK_SWEEPS`` sweeps from one
   init (gates: launch counts, fits within ``FIT_AGREE``; printed: ms a
   sweep); at rank 128 the fleet's first 8 subjects served by
   ``CPService`` under fused and matrix_free (gates: 3 batched launches a
   sweep, fits within ``FIT_AGREE``), ``mttkrp_2step_kernel`` on every
   mode against the einsum oracle, ``krp_materialize`` bitwise its oracle
   and ``ops.multi_ttv_batched`` (gate: their launch counts);
   ``tune(x4, 128)`` (gate: kernel tile rows and kernel node rows;
   printed: the autotune plan); and one sharded ``matrix_free`` run at
   rank 80 in an NCCL world of one (gate: bitwise the local run).
22. every kernel in bf16, fp16 and float64, run right after phase 21 with
   the other float32 tensors released, the fMRI tensor cast to one dtype
   at a time.  Rows 1-2 on every mode of the fMRI tensor and rows 3-4 on
   every mode of the 8-subject batch at ranks 10 and 80 (two column
   blocks); rows 5-7 at rank 10 (row 5 at the 2-step path's second steps,
   row 6 at the batch's mode-1 second step, through the kernel-level
   entries, and row 7 at the KRP's last fold).  Gates: each within
   ``REL_ERR_BOUND`` of its plain version relative to the plain version's
   largest magnitude (row 7 bitwise), float32 out (row 7 the dtype), run
   twice bitwise, one counted launch a call and the CUDA kernels a call
   of float32 (a CUDA graph of one call).  Printed at rank 10: kernel ms
   (CUDA events) beside the bound (each operand read once at its width,
   the float32 output written once; 2 C fp32 operations an element), the
   plain version and one ``torch.einsum`` on the operands in their dtype;
   row 7 also its TB/s and path (gate: 16-byte) and phase 8's KRP edge
   cases in the dtype.  Then ``cp_als`` in float64 under auto, fused and matrix_free for
   ``DTYPE_SWEEPS`` sweeps from one init (gates: launch counts, float64
   factors, fits within ``FIT_AGREE``), and ``tune()`` of the float64 and
   the bf16 tensor at rank 10 (gate: kernel tile rows, kernel node rows
   and launches).

NCCL beyond a world of one is not exercised here: the card is one H100.

The kernels-a-call gates (phases 4, 7 and 11) count the nodes of a CUDA
graph captured from one call, not the profiler's events: the profiler drops
a few kernel events of a window now and then.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON summary.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# fp32 kernel vs plain version: two summation orders over up to 2.36 M terms
# per output.  Blocked fp32 sums of that length agree to ~1e-6 norm-wise; an
# indexing or masking fault gives O(1).  1e-4 keeps two orders of margin.
REL_ERR_BOUND = 1e-4
# Per-sweep fits of the three strategies: the same ALS iterates computed with
# differently ordered fp32 sums; the fit's factored identity subtracts nearly
# equal terms, which amplifies their ~1e-6 relative differences to ~1e-5.
FIT_AGREE = 1e-3
# The small card-vs-CPU run: same algorithms, ~1e-6 differences per sweep.
SMALL_FIT_AGREE = 1e-4
# Phase 12's PP runs.  PP_TOL is the reference bench's PP_TOL
# (benchmarks/bench_mttkrp.py).  On the fMRI tensor from seed 0 at rank 10
# the ALS step first falls under it at sweep 10 (0.015; sweep 9's is 0.060):
# PP_SWEEPS = 16 leaves the build and six approximate sweeps after ten
# exact ones.  The fleet runs phase 6's 5 sweeps, whose steps a batch are
# 0.29-0.41 at sweep 3 and 0.15-0.23 at sweep 4: PP_FLEET_TOL = 0.25 makes
# every batch build the cache after sweep 4 and approximate sweep 5 (at
# 0.15, five batches built after their last sweep and none approximated).
# (Steps: the host-gate reads of a full smoke, NVIDIA H100 80GB HBM3, 700 W.)
PP_TOL = 0.05
PP_SWEEPS = 16
PP_FLEET_TOL = 0.25
# PP fits against the exact run's: a first-order PP MTTKRP neglects terms of
# second order in the drift (< PP_TOL on every approximate sweep), a relative
# error of about PP_TOL**2 = 2.5e-3 a sweep that moves the iterate and its fit
# by about as much; a few approximate sweeps stay within 1e-2.  A sign or
# index fault in a correction errs by the drift itself, ~5e-2.
PP_FIT_AGREE = 1e-2
# Nominal H100 SXM datasheet rates at 700 W (fp32 without tensor cores, HBM3).
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12

FMRI = (225, 59, 200, 200)
X3_SHAPE = FMRI[:2] + (FMRI[2] * (FMRI[2] + 1) // 2,)  # its 3-way linearization (upper triangles)
FUSED_SOURCE = "src/repro_torch/kernels/csrc/fused_mttkrp.cu"
MF_SOURCE = "src/repro_torch/kernels/csrc/matrix_free.cu"
FUSED_REPLACES = "src/repro/kernels/fused_mttkrp.py:182"
MF_REPLACES = "src/repro/kernels/matrix_free.py:84"
FUSED_BATCHED_REPLACES = "src/repro/kernels/fused_mttkrp.py:111"
MF_BATCHED_REPLACES = "src/repro/kernels/matrix_free.py:157"
MT_SOURCE = "src/repro_torch/kernels/csrc/multi_ttv.cu"
KRP_SOURCE = "src/repro_torch/kernels/csrc/krp_pair.cu"
MT_REPLACES = "src/repro/kernels/multi_ttv.py:46"
MT_BATCHED_REPLACES = "src/repro/kernels/multi_ttv.py:82"
KRP_REPLACES = "src/repro/kernels/krp_kernel.py:32"
# The serving fleet: one tensor per subject, served in batches of 8; a second
# signature at rank 16 serves subjects 0-7 again.
SERVE_BATCH = 8
SECOND_RANK = 16
SECOND_SUBJECTS = 8


def _log(msg: str) -> None:
    print(msg, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def synth_fmri(torch, gen, rank: int, device):
    """Synthetic fMRI tensor after ``examples/fmri_cpals.py``: positive
    temporal envelopes, softplus subject loadings, symmetric rank-1 network
    maps, scaled to max |x| = 1, plus 5% Gaussian noise."""
    t, s, r, _ = FMRI
    tt = torch.linspace(0, 8 * math.pi, t, device=device)[:, None]
    phases = torch.rand((1, rank), generator=gen, device=device) * 2 * math.pi
    temporal = 1.0 + torch.sin(tt / (1 + torch.arange(rank, device=device)) + phases)
    subj = torch.nn.functional.softplus(
        torch.randn((s, rank), generator=gen, device=device)
    )
    seeds = torch.randn((r, rank), generator=gen, device=device)
    ts = (temporal[:, None, :] * subj[None, :, :]).reshape(t * s, rank)
    nets = (seeds[:, None, :] * seeds[None, :, :]).reshape(r * r, rank)
    x = (ts @ nets.T).view(FMRI)
    x /= x.abs().max()
    for k in range(t):  # noise slab by slab: no second 2 GB buffer
        x[k] += 0.05 * torch.randn((s, r, r), generator=gen, device=device)
    return x


def _rel(torch, k, p) -> tuple[float, float]:
    d = (k.double() - p.double())
    return float(d.norm() / p.double().norm()), float(d.abs().max())


def _checker(torch, err):
    """``check(label, key, kern, plain, phase)``: the norm-wise relative error
    of a kernel's output against its plain version must stay under
    ``REL_ERR_BOUND``; ``err[key]`` keeps the largest absolute error."""

    def check(label, key, kern, plain, phase=2):
        rel, mabs = _rel(torch, kern, plain)
        err[key] = max(err[key], mabs)
        ok = math.isfinite(rel) and rel <= REL_ERR_BOUND
        _log(f"[{phase}] {label}: rel err {rel:.3e} max abs {mabs:.3e} "
             f"(bound {REL_ERR_BOUND:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: kernel disagrees with its plain version")

    return check


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_device_us(torch, fn, reps: int):
    """One call of ``fn`` split into host and device time, in µs.

    Host: the host clock over ``reps`` back-to-back calls with no sync inside
    the loop (what the caller's thread spends a call).  Device: from
    ``torch.profiler`` (CUDA activity) over ``reps`` more calls, each kernel
    name's mean duration times its events a call (rounded).  The profiler now
    and then drops a few kernel events of a window (seen on the H100: 47 of
    50, three windows in a row), so its event count is no exact count of
    launches: a short window is logged, and the kernels a call that a gate
    reads come from :func:`_graph_ops`.  Also returns the kernels a call the
    profiler shows (per name, rounded) and their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    per_name = {name: max(1, round(k / reps)) for name, (_, k) in by_name.items()}
    events = sum(k for _, k in by_name.values())
    if events != reps * sum(per_name.values()):
        _log(f"(torch.profiler recorded {events} kernel events for {reps} calls of "
             f"{sum(per_name.values())} kernels: events dropped; device time from each "
             "name's mean)")
    device = sum(t / k * per_name[name] for name, (t, k) in by_name.items())
    return host, device, sum(per_name.values()), sorted(by_name)


_CU_GRAPH_NODE_TYPE_KERNEL = 0  # CUgraphNodeType


def _graph_ops(torch, fn) -> tuple[int, int]:
    """The device operations one call of ``fn`` puts on its stream, counted
    exactly: the call is captured into a CUDA graph (captured, never
    replayed) and the graph's nodes are read through the driver
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``).  Returns (operations,
    kernels among them).  Call ``fn`` once before, so that nothing it does
    once (a build, a function attribute) falls in the capture."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def check(code):
        if code != 0:
            raise SystemExit(f"CUDA driver error {code} reading a captured graph")

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)))
    kinds = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kinds.append(kind.value)
    del graph
    torch.cuda.synchronize()
    return len(kinds), kinds.count(_CU_GRAPH_NODE_TYPE_KERNEL)


def _trace(torch, fn):
    """One call of ``fn`` (after a warm one) under ``torch.profiler`` (CPU and
    CUDA activity): the host-clock µs of the call, its sync included, and
    every device event ``(start µs, end µs, name)`` in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    return wall, evs


def _log_trace(label: str, wall: float, evs, per: int, smi: str, unit: str = "sweep") -> None:
    """Print a trace's device busy share, its longest idle gaps and its ten
    longest device operations (by summed time), per ``per`` repeats (a
    ``unit`` each)."""
    merged = []
    for a, b, _ in evs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    window = merged[-1][1] - merged[0][0]
    gaps = sorted((b[0] - a[1] for a, b in zip(merged, merged[1:])), reverse=True)
    by_name = {}
    for a, b, name in evs:
        t, k = by_name.get(name, (0.0, 0))
        by_name[name] = (t + b - a, k + 1)
    _log(f"{label}: {len(evs) / per:g} device operations a {unit}; device busy {busy / per:.1f} "
         f"us a {unit} of a {window / per:.1f} us device window ({100 * busy / window:.1f}% busy) "
         f"and of {wall / per:.1f} us host clock ({100 * busy / wall:.1f}%); longest idle gaps (us) "
         f"{[round(g, 1) for g in gaps[:5]]}, {sum(gaps) / per:.1f} us idle a {unit} in "
         f"{len(gaps)} gaps; card {smi}")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        _log(f"{label}:   {t / per:9.1f} us a {unit}, {k / per:g} a {unit}: {name[:110]}")


def _row4_checks(torch, gen, dev, check, xb, fb, phase):
    """The batched matrix-free kernel beyond phase 5's shared checks: rank 64
    on every mode of the batch, run-twice bitwise, a misaligned view of
    x (scalar copies) and a ragged order-4 stack, each against its plain
    version; with the launch geometry where the port computes one."""
    from repro_torch.kernels import matrix_free as mf

    def geometry(x, n, c):
        if not hasattr(mf, "launch_shape"):
            return ""
        g = mf.launch_shape(tuple(x.shape[1:]), n, c, x.shape[0])
        vec = g.vec and x.data_ptr() % 16 == 0  # as the wrapper decides
        return (f" [grid ({g.row_blocks}, {g.splits}, {g.slabs}), clusters of {g.splits}, "
                f"q chunk {g.q_chunk} x {g.chunks}, {'16' if vec else '4'}-byte copies, "
                f"{g.smem} B shared, {g.residency} CTAs an SM]")

    def one(label, x, fs, n):
        us = [fs[k] for k in range(x.ndim - 1) if k != n]
        out = mf.matrix_free_batched_kernel(x, us, n)
        check(f"matrix_free batched {label} mode {n}{geometry(x, n, fs[0].shape[-1])}", "mf_b",
              out, mf.matrix_free_batched_kernel_plain(x, us, n), phase)
        return out, us

    fb64 = [torch.randn((xb.shape[0], d, 64), generator=gen, device=dev) for d in xb.shape[1:]]
    for n in range(3):
        one(f"S={xb.shape[0]} rank 64", xb, fb64, n)
        out, us = one(f"S={xb.shape[0]} rank {fb[0].shape[-1]} (run twice)", xb, fb, n)
        same = torch.equal(out, mf.matrix_free_batched_kernel(xb, us, n))
        _log(f"[{phase}] matrix_free batched mode {n} run twice bitwise equal: "
             f"{'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit("matrix_free batched: not bitwise repeatable")
    del fb64
    # a contiguous view 4 bytes off a 16-byte line: the wrapper takes 4-byte copies
    buf = torch.empty(3 * xb[0].numel() + 1, device=dev)
    xm = buf[1:].view((3,) + tuple(xb.shape[1:]))
    xm.copy_(xb[:3])
    for n in range(3):
        one(f"S=3 misaligned x (data_ptr % 16 = {xm.data_ptr() % 16})", xm,
            [f[:3] for f in fb], n)
    del buf, xm
    for shape in ((5, 37, 23, 41, 30), (5, 37, 23, 41, 28)):  # 4- and 16-byte copies
        xr = torch.randn(shape, generator=gen, device=dev)
        fr = [torch.randn((5, d, 7), generator=gen, device=dev) for d in shape[1:]]
        for n in range(4):
            one(f"ragged order-4 {shape} rank 7", xr, fr, n)


def _row4_device(torch, xb, fb, smi, phase):
    """Device time a launch (``torch.profiler``) and CUDA kernels a call
    (:func:`_graph_ops`) of the batched matrix-free kernel on every mode of
    the batch; returns the kernels a call."""
    from repro_torch.kernels import matrix_free as mf

    per_call = []
    for n in range(3):
        us = [fb[k] for k in range(3) if k != n]
        host, dev_us, k, names = _host_device_us(
            torch, lambda: mf.matrix_free_batched_kernel(xb, us, n), 50)
        ops, kern = _graph_ops(torch, lambda: mf.matrix_free_batched_kernel(xb, us, n))
        per_call.append(ops if ops == kern else (ops, kern))
        _log(f"[{phase}] matrix_free_batched_kernel S={xb.shape[0]} mode {n}: device "
             f"{dev_us / 1e3:.4f} ms a launch (torch.profiler: {k:g} kernels a call, {names}); "
             f"{ops} device operations a call, {kern} of them kernels (CUDA graph of one call); "
             f"host {host:.2f} us a call (host clock, 50 calls, no sync); card {smi}")
    return per_call


def _row4_occupancy(torch, xb, smi, phase):
    """The batched matrix-free kernel's residency and waves at the batch's
    launches (ranks 10, 16, 64), from the CUDA occupancy queries, against
    the constants its geometry assumes."""
    from repro_torch.kernels import matrix_free as mf

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _log(f"[{phase}] SMs {sms} (launch_shape assumes {mf.SMS}); card {smi}")
    for rank in (10, SECOND_RANK, 64):
        for n in range(3):
            g = mf.launch_shape(tuple(xb.shape[1:]), n, rank, xb.shape[0])
            # the shared kernel's query, under its older name in older trees
            per_sm, clusters = (getattr(mf, "occupancy", None) or mf.batched_occupancy)(g, rank)
            ctas = g.row_blocks * g.splits * g.slabs
            waves = -(-ctas // (clusters * g.splits))
            _log(f"[{phase}] matrix_free batched rank {rank} mode {n}: {ctas} CTAs in clusters "
                 f"of {g.splits}, {g.smem} B shared each; occupancy {per_sm} CTAs an SM "
                 f"(residency constant {g.residency}), {clusters} clusters on the card: "
                 f"{waves} wave(s)")
            if per_sm < g.residency:
                raise SystemExit(f"matrix_free batched rank {rank} mode {n}: {per_sm} CTAs an SM "
                                 f"< the residency {g.residency} its geometry assumes")


def _trace_served_sweep(torch, args, xb, init, smi, phase, strategy="matrix_free"):
    """A batch dispatch as ``CPService`` runs it under ``strategy`` (its
    sweeps in one chunk, one host sync), traced by ``torch.profiler``."""
    from repro_torch.plan import Problem, TuningCache, cp_als, plan_sweep

    plan = plan_sweep(Problem(tuple(xb.shape[1:]), args.rank, batch=xb.shape[0]), strategy,
                      tuning_cache=TuningCache())
    wall, evs = _trace(torch, lambda: cp_als(xb, plan, n_iters=args.sweeps, tol=0.0,
                                              init_factors=init, sweeps_per_sync=args.sweeps))
    _log_trace(f"[{phase}] trace of one {strategy} batch dispatch (S={xb.shape[0]}, rank "
               f"{args.rank}, {args.sweeps} sweeps, one sync), per sweep", wall, evs,
               args.sweeps, smi)


def _grid_x(g) -> str:
    """Grid x of a launch: its row blocks, times its column blocks above
    rank 64 (where the port cuts the rank into blocks)."""
    blocks = getattr(g, "col_blocks", 1)
    if blocks == 1:
        return str(g.row_blocks)
    return f"{g.row_blocks} x {blocks} column blocks of {g.block_width} at {g.padded_rank}"


def _row2_geometry(x, n, c, bps=None) -> str:
    """The unbatched matrix-free launch at mode ``n``, where the port
    computes one."""
    from repro_torch.kernels import matrix_free as mf

    if not hasattr(mf, "unbatched_launch_shape"):
        return ""
    g = mf.unbatched_launch_shape(tuple(x.shape), n, c, bps or mf.BLOCKS_PER_SM)
    vec = g.vec and x.data_ptr() % 16 == 0  # as the wrapper decides
    return (f" [grid ({_grid_x(g)}, {g.groups} x {g.splits}), clusters of {g.splits}, "
            f"{g.groups} group(s), q chunk {g.q_chunk} x {g.chunks}, "
            f"{'16' if vec else '4'}-byte copies, {g.smem} B shared]")


def _row2_checks(torch, gen, dev, check, x4, phase):
    """The unbatched matrix-free kernel beyond phase 2's shared checks, on
    the 4-way tensor: every mode at rank 64 and at ``blocks_per_sm`` 1 (a
    launch of other groups), run twice bitwise at rank 10, and a misaligned
    view of 8 subjects (4-byte copies) bitwise equal to the aligned call."""
    from repro_torch.kernels import matrix_free as mf

    def one(label, x, fs, n, **kw):
        us = [fs[k] for k in range(x.ndim) if k != n]
        out = mf.matrix_free_kernel(x, us, n, **kw)
        check(f"matrix_free {label} mode {n}"
              f"{_row2_geometry(x, n, fs[0].shape[-1], kw.get('blocks_per_sm'))}", "mf",
              out, mf.matrix_free_kernel_plain(x, us, n), phase)
        return out, us

    f10 = [torch.randn((d, 10), generator=gen, device=dev) for d in x4.shape]
    f64 = [torch.randn((d, 64), generator=gen, device=dev) for d in x4.shape]
    for n in range(x4.ndim):
        one("4-way rank 64", x4, f64, n)
        one("4-way rank 10 blocks_per_sm 1", x4, f10, n, blocks_per_sm=1)
        out, us = one("4-way rank 10 (run twice)", x4, f10, n)
        same = torch.equal(out, mf.matrix_free_kernel(x4, us, n))
        _log(f"[{phase}] matrix_free mode {n} run twice bitwise equal: {'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit("matrix_free: not bitwise repeatable")
    del f64
    xa = x4[:, :8].contiguous()
    buf = torch.empty(xa.numel() + 1, device=dev)
    xm = buf[1:].view(xa.shape)  # a contiguous view 4 bytes off a 16-byte line
    xm.copy_(xa)
    for n in range(xa.ndim):
        out, us = one(f"8 subjects misaligned x (data_ptr % 16 = {xm.data_ptr() % 16})", xm,
                      f10[:1] + [f10[1][:8]] + f10[2:], n)
        same = torch.equal(out, mf.matrix_free_kernel(xa, us, n))
        _log(f"[{phase}] matrix_free misaligned mode {n} bitwise equal to the aligned call: "
             f"{'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit("matrix_free: a misaligned view differs from the aligned call")


def _row2_device(torch, x4, init, smi, phase):
    """Device time a launch (``torch.profiler``) and CUDA kernels a call
    (:func:`_graph_ops`) of the unbatched matrix-free kernel on every mode
    of the 4-way tensor; returns each mode's kernels a call."""
    from repro_torch.kernels import matrix_free as mf

    per_call = []
    for n in range(x4.ndim):
        us = [init[k] for k in range(x4.ndim) if k != n]
        host, dev_us, k, names = _host_device_us(
            torch, lambda: mf.matrix_free_kernel(x4, us, n), 20)
        ops, kern = _graph_ops(torch, lambda: mf.matrix_free_kernel(x4, us, n))
        per_call.append(ops if ops == kern else (ops, kern))
        _log(f"[{phase}] matrix_free_kernel mode {n}: device {dev_us / 1e3:.4f} ms a launch "
             f"(torch.profiler: {k:g} kernels a call, {names}); {ops} device operations a "
             f"call, {kern} of them kernels (CUDA graph of one call); host {host:.2f} us a "
             f"call (host clock, 20 calls, no sync); card {smi}")
    return per_call


def _row2_occupancy(torch, smi, phase):
    """The unbatched matrix-free kernel's residency and cluster slots at the
    4-way tensor's launches (ranks 10, 16, 64) and its 3-way linearization's
    (rank 10), from the CUDA occupancy queries, against the constants its
    geometry counts; returns the CUDA kernels each rank-10 4-way call should
    launch (1 with one group, else 2)."""
    from repro_torch.kernels import matrix_free as mf

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _log(f"[{phase}] SMs {sms} (unbatched_launch_shape assumes {mf.SMS}); card {smi}")
    want = []
    for shape, rank in ((FMRI, 10), (FMRI, SECOND_RANK), (FMRI, 64), (X3_SHAPE, 10)):
        for n in range(len(shape)):
            g = mf.unbatched_launch_shape(shape, n, rank)
            per_sm, clusters = mf.occupancy(g, rank)
            counted = mf.CLUSTER_SLOTS[g.residency][g.splits]
            waves = -(-g.row_blocks * g.groups // clusters)
            _log(f"[{phase}] matrix_free {shape} rank {rank} mode {n}: "
                 f"{g.row_blocks * g.groups * g.splits} CTAs, {g.row_blocks} row blocks x "
                 f"{g.groups} groups of clusters of {g.splits}, {g.smem} B shared each; "
                 f"occupancy {per_sm} CTAs an SM (residency constant {g.residency}), {clusters} "
                 f"clusters on the card (counted {counted}): {waves} wave(s)")
            if per_sm < g.residency or clusters != counted:
                raise SystemExit(f"matrix_free {shape} rank {rank} mode {n}: the occupancy "
                                 f"query disagrees with the geometry's residency or cluster slots")
            if shape == FMRI and rank == 10:
                want.append(1 if g.groups == 1 else 2)
    return want


def _trace_big_sweep(torch, args, x4, init, smi, phase, strategy="matrix_free"):
    """Sweeps of the big tensor under ``strategy`` (all in one chunk, one
    host sync), traced by ``torch.profiler``, per sweep."""
    from repro_torch.plan import Problem, cp_als, plan_sweep

    plan = plan_sweep(Problem.from_tensor(x4, args.rank), strategy=strategy)
    wall, evs = _trace(torch, lambda: cp_als(x4, plan, n_iters=args.sweeps, tol=0.0,
                                              init_factors=init, sweeps_per_sync=args.sweeps))
    _log_trace(f"[{phase}] trace of the big tensor under {strategy} ({tuple(x4.shape)}, rank "
               f"{args.rank}, {args.sweeps} sweeps, one sync), per sweep", wall, evs,
               args.sweeps, smi)


def _row2_times(torch, x4, init, smi, phase, reps=20):
    """Phase 4's row-2 timing: each mode's kernel, plain version and one
    einsum call (CUDA events) beside the bound; returns the rows."""
    from repro_torch.kernels import matrix_free as mf

    rows = []
    c = init[0].shape[-1]
    for n in range(x4.ndim):
        us = [init[k] for k in range(x4.ndim) if k != n]
        byts = 4 * (x4.numel() + sum(u.numel() for u in us) + x4.shape[n] * c)
        r = {
            "ms": _time_ms(torch, lambda: mf.matrix_free_kernel(x4, us, n), reps),
            "plain_ms": _time_ms(torch, lambda: mf.matrix_free_kernel_plain(x4, us, n), 5),
            "library_ms": _time_ms(
                torch, lambda: torch.einsum(_einsum_spec(x4.ndim, n), x4, *us), 5),
            "bytes_ms": byts / HBM_BW * 1e3, "flops_ms": 2 * x4.numel() * c / PEAK_FLOPS * 1e3,
        }
        rows.append(r)
        bound = max(r["bytes_ms"], r["flops_ms"])
        _log(f"[{phase}] matrix_free_kernel mode {n}: kernel {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, einsum {r['library_ms']:.4f} ms, bound {bound:.4f} ms "
             f"({'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}){_row2_geometry(x4, n, c)}; "
             f"card {smi}")
    _log(f"[{phase}] matrix_free_kernel sweep (4 launches): kernel "
         f"{sum(r['ms'] for r in rows):.4f} ms, bound "
         f"{sum(max(r['bytes_ms'], r['flops_ms']) for r in rows):.4f} ms; card {smi}")
    return rows


def _mf_checks(torch, gen, dev, check, x4, rank, phase=2):
    """Phase 2's unbatched matrix-free checks: every mode of the 4-way
    tensor, its 3-way linearization (225 x 59 x 20100) and small order-5 and
    order-6 tensors, each against its plain version, with the launch."""
    from repro_torch.kernels import matrix_free as mf

    iu = torch.triu_indices(FMRI[2], FMRI[3], device=dev)
    x3 = x4[:, :, iu[0], iu[1]].contiguous()
    _log(f"[{phase}] data: x4 {tuple(x4.shape)} ({x4.numel() * 4 / 1e9:.2f} GB), "
         f"x3 {tuple(x3.shape)} ({x3.numel() * 4 / 1e9:.2f} GB)")
    small5 = torch.randn((12, 10, 8, 9, 11), generator=gen, device=dev)
    small6 = torch.randn((6, 7, 5, 8, 6, 7), generator=gen, device=dev)
    for label, x in (("4-way", x4), ("3-way", x3), ("order-5", small5), ("order-6", small6)):
        fs = [torch.randn((d, rank), generator=gen, device=dev) for d in x.shape]
        for n in range(x.ndim):
            us = [fs[k] for k in range(x.ndim) if k != n]
            check(f"matrix_free {label} mode {n}{_row2_geometry(x, n, rank)}", "mf",
                  mf.matrix_free_kernel(x, us, n), mf.matrix_free_kernel_plain(x, us, n), phase)


def _only_fused(torch, args, dev, smi) -> None:
    """``--only fused``: build ``fused_mttkrp.cu`` and ``matrix_free.cu``,
    run phase 2's fused checks and the row-1 checks, phase 5's batched
    fused checks and row 3 against row 4 bitwise, time both fused kernels
    per mode as phases 4 and 7 do (CUDA events; device time by the
    profiler and CUDA kernels a call from a CUDA graph of one call;
    occupancy against the residency and cluster slots the geometry
    counts), time the batch's modes at every split, and time and trace
    the big tensor's and the batch's ``fused`` sweeps.  On a tree without
    the fold's geometry it gates nothing that the fold changed (the
    kernels a call, row 3 = row 4) and only prints."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import Problem, TuningCache, cp_als, plan_sweep

    fold = hasattr(fm, "launch_geometry")
    t0 = time.perf_counter()
    _build.build_all([fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL])
    _log(f"[1] built {fm.KERNEL.source.name} and {mf.KERNEL.source.name} in "
         f"{time.perf_counter() - t0:.1f} s")
    for line in fm.KERNEL.ptxas_log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            _log(f"[1] {fm.KERNEL.source.name}: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rank = args.rank
    x4 = synth_fmri(torch, gen, rank, dev)
    err = {"fused": 0.0, "fused_b": 0.0}
    check = _checker(torch, err)
    f4 = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
    for n in range(4):  # phase 2's fused checks
        t, a, b, pos = ops.bilinear_operands(x4, f4, n)
        check(f"fused 4-way mode {n} pos {pos} T{tuple(t.shape)}{_fused_geometry(t, pos, rank)}",
              "fused", fm.fused_mttkrp_bilinear(t, a, b, pos=pos),
              fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos))
    _row1_checks(torch, gen, dev, check, x4, 2)
    xb = torch.stack([x4[:, s].contiguous() for s in range(SERVE_BATCH)])
    fb = [torch.randn((SERVE_BATCH, d, rank), generator=gen, device=dev) for d in xb.shape[1:]]
    fb16 = [torch.randn((SERVE_BATCH, d, SECOND_RANK), generator=gen, device=dev)
            for d in xb.shape[1:]]
    for n in range(3):  # phase 5's batched fused checks
        for label, x, fs in ((f"S={SERVE_BATCH}", xb, fb), ("S=5 (odd)", xb[:5], [f[:5] for f in fb]),
                             (f"S={SERVE_BATCH} rank {SECOND_RANK}", xb, fb16)):
            t, a, b, pos = ops.bilinear_operands_batched(x, fs, n)
            check(f"fused batched {label} mode {n} pos {pos} T{tuple(t.shape)}"
                  f"{_fused_geometry(t, pos, a.shape[-1], x.shape[0])}", "fused_b",
                  fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos),
                  fm.fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos), 5)
    del fb16
    _row3_same_as_row4(torch, xb, fb, 5, gate=fold)
    torch.cuda.synchronize()
    init = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
    _row1_times(torch, x4, init, smi, 4)
    got = _row1_device(torch, x4, init, smi, 4)
    if fold:
        want = _row1_want_kernels(x4, init)
        _log(f"[4] fused_mttkrp_bilinear CUDA kernels a call {got} (want {want})")
        if got != want:
            raise SystemExit("fused_mttkrp_bilinear: CUDA kernels a call off its design")
    _row3_times(torch, xb, fb, smi, 7)
    got = _row3_device(torch, xb, fb, smi, 7)
    if fold and set(got) != {1}:
        raise SystemExit(f"fused_mttkrp_bilinear_batched: {got} CUDA kernels a call, not 1")
    if fold:
        _fused_occupancy(torch, x4, xb, smi, 4)
    _row4_splits(torch, xb, fb, smi, 7)
    plan = plan_sweep(Problem.from_tensor(x4, rank), strategy="fused")
    for _ in range(2):  # the second run's sweeps
        fm.KERNEL.launches = 0
        secs = []
        cp_als(x4, plan, n_iters=args.sweeps, tol=0.0, init_factors=init,
               callback=lambda it, f, dt: secs.append(dt))
        torch.cuda.synchronize()
    _log(f"[3] fused: per-sweep s {secs} (host clock, one device sync per sweep); "
         f"launches fused {fm.KERNEL.launches}; card {smi}")
    _trace_big_sweep(torch, args, x4, init, smi, 3, "fused")
    del x4
    initb = [f.clone() for f in fb]
    plan = plan_sweep(Problem(tuple(xb.shape[1:]), rank, batch=SERVE_BATCH), "fused",
                      tuning_cache=TuningCache())
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp_als(xb, plan, n_iters=args.sweeps, tol=0.0, init_factors=initb,
               sweeps_per_sync=args.sweeps)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / args.sweeps
    _log(f"[7] batched fused sweep (S={SERVE_BATCH}, rank {rank}): {1e3 * dt:.3f} ms (host clock, "
         f"cp_als with sweeps_per_sync={args.sweeps} as a served dispatch, its set-up included); "
         f"card {smi}")
    _trace_served_sweep(torch, args, xb, initb, smi, 7, "fused")
    _log(f"[2] max abs err of the fused kernel: {err['fused']:.3e}; [5] of the batched fused "
         f"kernel: {err['fused_b']:.3e}")


def _only_matrix_free(torch, args, dev, smi) -> None:
    """``--only matrix_free``: build ``matrix_free.cu``, run phase 2's
    unbatched matrix-free checks and the row-2 checks, time the kernel per
    mode as phase 4 does (CUDA events; device time by the profiler and CUDA
    kernels a call from a CUDA graph of one call; occupancy against the residency and cluster slots its
    geometry counts), and time and trace the big tensor's ``matrix_free``
    sweeps as phase 3 does."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import Problem, cp_als, plan_sweep

    t0 = time.perf_counter()
    _build.build_all([mf.KERNEL, mf.BATCHED_KERNEL])
    _log(f"[1] built {mf.KERNEL.source.name} in {time.perf_counter() - t0:.1f} s")
    for line in mf.KERNEL.ptxas_log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            _log(f"[1] {mf.KERNEL.source.name}: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x4 = synth_fmri(torch, gen, args.rank, dev)
    err = {"mf": 0.0}
    check = _checker(torch, err)
    _mf_checks(torch, gen, dev, check, x4, args.rank)
    _row2_checks(torch, gen, dev, check, x4, 2)
    torch.cuda.synchronize()
    init = [torch.randn((d, args.rank), generator=gen, device=dev) for d in FMRI]
    _row2_times(torch, x4, init, smi, 4)
    _row2_device(torch, x4, init, smi, 4)
    if hasattr(mf, "unbatched_launch_shape"):
        _row2_occupancy(torch, smi, 4)
    plan = plan_sweep(Problem.from_tensor(x4, args.rank), strategy="matrix_free")
    for _ in range(2):  # the second run's sweeps
        mf.KERNEL.launches = 0
        secs = []
        cp_als(x4, plan, n_iters=args.sweeps, tol=0.0, init_factors=init,
               callback=lambda it, f, dt: secs.append(dt))
        torch.cuda.synchronize()
    _log(f"[3] matrix_free: per-sweep s {secs} (host clock, one device sync per sweep); "
         f"launches matrix_free {mf.KERNEL.launches}; card {smi}")
    _trace_big_sweep(torch, args, x4, init, smi, 3)
    _log(f"[2] max abs err of the matrix-free kernel: {err['mf']:.3e}")


# ---- rows 1 and 3: the fused bilinear kernels (on the cluster body since
# the fold redesign; the helpers read the geometry only where the port has it)

_BILINEAR = {0: "iab,ac,bc->ic", 1: "aib,ac,bc->ic", 2: "abi,ac,bc->ic"}


def _fused_geometry(t, pos, c, slabs=None) -> str:
    """The fused launch of view ``t`` at ``pos``, where the port computes one."""
    from repro_torch.kernels import fused_mttkrp as fm

    if not hasattr(fm, "launch_geometry"):
        return ""
    g = fm.launch_geometry(tuple(t.shape[-3:]), pos, c, slabs)
    vec = g.vec and t.data_ptr() % 16 == 0  # as the wrapper decides
    grid = (f"({_grid_x(g)}, {g.groups} x {g.splits})" if slabs is None
            else f"({_grid_x(g)}, {g.splits}, {g.slabs})")
    return (f" [grid {grid}, clusters of {g.splits}, {g.groups} group(s), q chunk "
            f"{g.q_chunk} x {g.chunks}, {'16' if vec else '4'}-byte copies, {g.smem} B shared]")


def _row1_checks(torch, gen, dev, check, x4, phase):
    """The unbatched fused kernel beyond phase 2's checks, on the 4-way
    tensor: every mode at rank 64, run twice bitwise at rank 10, and a
    misaligned view of 8 subjects (4-byte copies) bitwise equal to the
    aligned call."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import ops

    def one(label, x, fs, n):
        t, a, b, pos = ops.bilinear_operands(x, fs, n)
        out = fm.fused_mttkrp_bilinear(t, a, b, pos=pos)
        check(f"fused {label} mode {n} pos {pos} T{tuple(t.shape)}"
              f"{_fused_geometry(t, pos, a.shape[-1])}", "fused", out,
              fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos), phase)
        return out

    def same(label, a, b):
        ok = torch.equal(a, b)
        _log(f"[{phase}] fused {label}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"fused {label}: not bitwise equal")

    f10 = [torch.randn((d, 10), generator=gen, device=dev) for d in x4.shape]
    f64 = [torch.randn((d, 64), generator=gen, device=dev) for d in x4.shape]
    for n in range(x4.ndim):
        one("4-way rank 64", x4, f64, n)
        out = one("4-way rank 10 (run twice)", x4, f10, n)
        t, a, b, pos = ops.bilinear_operands(x4, f10, n)
        same(f"mode {n} run twice bitwise equal", out, fm.fused_mttkrp_bilinear(t, a, b, pos=pos))
    del f64
    xa = x4[:, :8].contiguous()
    buf = torch.empty(xa.numel() + 1, device=dev)
    xm = buf[1:].view(xa.shape)  # a contiguous view 4 bytes off a 16-byte line
    xm.copy_(xa)
    fs = f10[:1] + [f10[1][:8]] + f10[2:]
    for n in range(xa.ndim):
        out = one(f"8 subjects misaligned x (data_ptr % 16 = {xm.data_ptr() % 16})", xm, fs, n)
        t, a, b, pos = ops.bilinear_operands(xa, fs, n)
        same(f"misaligned mode {n} bitwise equal to the aligned call", out,
             fm.fused_mttkrp_bilinear(t, a, b, pos=pos))


def _row1_times(torch, x4, init, smi, phase, reps=20):
    """Phase 4's row-1 timing: each mode's kernel, plain version and one
    einsum call (CUDA events) beside the bound; returns the rows."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import ops

    rows = []
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, init, n)
        c = a.shape[1]
        byts = 4 * (t.numel() + a.numel() + b.numel() + t.shape[pos] * c)
        r = {
            "ms": _time_ms(torch, lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos), reps),
            "plain_ms": _time_ms(torch, lambda: fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos), 5),
            "library_ms": _time_ms(torch, lambda: torch.einsum(_BILINEAR[pos], t, a, b), 5),
            "bytes_ms": byts / HBM_BW * 1e3, "flops_ms": 2 * t.numel() * c / PEAK_FLOPS * 1e3,
        }
        rows.append(r)
        bound = max(r["bytes_ms"], r["flops_ms"])
        _log(f"[{phase}] fused_mttkrp_bilinear mode {n}: kernel {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, einsum {r['library_ms']:.4f} ms, bound {bound:.4f} ms "
             f"({'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'})"
             f"{_fused_geometry(t, pos, c)}; card {smi}")
    _log(f"[{phase}] fused_mttkrp_bilinear sweep (4 launches): kernel "
         f"{sum(r['ms'] for r in rows):.4f} ms, bound "
         f"{sum(max(r['bytes_ms'], r['flops_ms']) for r in rows):.4f} ms; card {smi}")
    return rows


def _row1_device(torch, x4, init, smi, phase):
    """Device time a launch (``torch.profiler``) and CUDA kernels a call
    (:func:`_graph_ops`) of the unbatched fused kernel on every mode of the
    4-way tensor; returns each mode's kernels a call."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import ops

    per_call = []
    for n in range(x4.ndim):
        t, a, b, pos = ops.bilinear_operands(x4, init, n)
        run = lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos)  # noqa: E731
        host, dev_us, k, names = _host_device_us(torch, run, 20)
        ops_, kern = _graph_ops(torch, run)
        per_call.append(ops_ if ops_ == kern else (ops_, kern))
        _log(f"[{phase}] fused_mttkrp_bilinear mode {n}: device {dev_us / 1e3:.4f} ms a launch "
             f"(torch.profiler: {k:g} kernels a call, {names}); {ops_} device operations a "
             f"call, {kern} of them kernels (CUDA graph of one call); host {host:.2f} us a "
             f"call (host clock, 20 calls, no sync); card {smi}")
    return per_call


def _row1_want_kernels(x4, init):
    """The CUDA kernels each mode's fused call launches by design: 1 with
    one group, 2 with more (the groups' partials, then their sum)."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import ops

    want = []
    for n in range(x4.ndim):
        t, a, _, pos = ops.bilinear_operands(x4, init, n)
        g = fm.launch_geometry(tuple(t.shape), pos, a.shape[-1])
        want.append(1 if g.groups == 1 else 2)
    return want


def _row3_times(torch, xb, fb, smi, phase, reps=50):
    """Phase 7's row-3 timing at the batch: each mode's kernel, plain
    version and one einsum call (CUDA events) beside the bound; returns the
    rows."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import ops

    rows = []
    for n in range(3):
        t, a, b, pos = ops.bilinear_operands_batched(xb, fb, n)
        c = a.shape[-1]
        spec = "s" + _BILINEAR[pos].replace(",", ",s").replace("->", "->s")
        r = {
            "ms": _time_ms(torch, lambda: fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos), reps),
            "plain_ms": _time_ms(
                torch, lambda: fm.fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos), 10),
            "library_ms": _time_ms(torch, lambda: torch.einsum(spec, t, a, b), 10),
            "bytes_ms": 4 * (t.numel() + a.numel() + b.numel() + xb.shape[0] * t.shape[1 + pos]
                             * c) / HBM_BW * 1e3,
            "flops_ms": 2 * t.numel() * c / PEAK_FLOPS * 1e3,
        }
        rows.append(r)
        bound = max(r["bytes_ms"], r["flops_ms"])
        _log(f"[{phase}] fused_mttkrp_bilinear_batched S={xb.shape[0]} mode {n}: kernel "
             f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, einsum {r['library_ms']:.4f} ms, "
             f"bound {bound:.4f} ms "
             f"({'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'})"
             f"{_fused_geometry(t, pos, c, xb.shape[0])}; card {smi}")
    _log(f"[{phase}] fused_mttkrp_bilinear_batched batch sweep (3 launches): kernel "
         f"{sum(r['ms'] for r in rows):.4f} ms, bound "
         f"{sum(max(r['bytes_ms'], r['flops_ms']) for r in rows):.4f} ms; card {smi}")
    return rows


def _row3_device(torch, xb, fb, smi, phase):
    """Device time a launch (``torch.profiler``) and CUDA kernels a call
    (:func:`_graph_ops`) of the batched fused kernel on every mode of the
    batch; returns the kernels a call."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import ops

    per_call = []
    for n in range(3):
        t, a, b, pos = ops.bilinear_operands_batched(xb, fb, n)
        run = lambda: fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos)  # noqa: E731
        host, dev_us, k, names = _host_device_us(torch, run, 50)
        ops_, kern = _graph_ops(torch, run)
        per_call.append(ops_ if ops_ == kern else (ops_, kern))
        _log(f"[{phase}] fused_mttkrp_bilinear_batched S={xb.shape[0]} mode {n}: device "
             f"{dev_us / 1e3:.4f} ms a launch (torch.profiler: {k:g} kernels a call, {names}); "
             f"{ops_} device operations a call, {kern} of them kernels (CUDA graph of one call); "
             f"host {host:.2f} us a call (host clock, 50 calls, no sync); card {smi}")
    return per_call


def _row3_same_as_row4(torch, xb, fb, phase, gate=True):
    """The fused views of the 8-subject stack are the stack itself: row 3
    must equal row 4 (the batched matrix-free kernel) bit for bit."""
    from repro_torch.kernels import ops

    for n in range(3):
        same = torch.equal(ops.fused_mttkrp_batched(xb, fb, n),
                           ops.matrix_free_mttkrp_batched(xb, fb, n))
        _log(f"[{phase}] fused batched S={xb.shape[0]} mode {n} bitwise equal to matrix_free "
             f"batched: {'ok' if same else 'FAIL' if gate else 'no (not gated)'}")
        if gate and not same:
            raise SystemExit("fused batched differs from matrix_free batched on a 3-way stack")


def _fused_occupancy(torch, x4, xb, smi, phase):
    """The fused launches' residency and cluster slots (rows 1 and 3, ranks
    10, 16 and 64), from the CUDA occupancy queries of the shared body,
    against the constants the geometry counts."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import ops

    views = []
    xm = torch.empty(x4.shape, device="meta")  # shapes only
    for n in range(x4.ndim):
        t, _, _, pos = ops.bilinear_operands(xm, [torch.empty((d, 1), device="meta")
                                                  for d in x4.shape], n)
        views.append((f"row 1 mode {n}", tuple(t.shape), pos, None))
    views += [(f"row 3 mode {n}", tuple(xb.shape[1:]), n, xb.shape[0]) for n in range(3)]
    for rank in (10, SECOND_RANK, 64):
        for label, view, pos, slabs in views:
            g = fm.launch_geometry(view, pos, rank, slabs)
            per_sm, clusters = mf.occupancy(g, rank)
            counted = mf.CLUSTER_SLOTS[g.residency][g.splits]
            waves = -(-g.row_blocks * g.groups * g.slabs // clusters)
            _log(f"[{phase}] fused {label} view {view} rank {rank}: "
                 f"{g.row_blocks * g.groups * g.splits * g.slabs} CTAs in clusters of "
                 f"{g.splits}, {g.smem} B shared each; occupancy {per_sm} CTAs an SM (residency "
                 f"constant {g.residency}), {clusters} clusters on the card (counted {counted}): "
                 f"{waves} wave(s)")
            if per_sm < g.residency or clusters != counted:
                raise SystemExit(f"fused {label} rank {rank}: the occupancy query disagrees with "
                                 "the geometry's residency or cluster slots")


def _row4_splits(torch, xb, fb, smi, phase):
    """The batch's launches (row 4's, and row 3's since the fold) at every
    split the batched entry takes, mode by mode, through the C entry (the
    wrapper's launch but the split; not counted), timed by CUDA events: the
    geometry's choice against the others."""
    import ctypes

    from repro_torch.kernels import matrix_free as mf

    c = fb[0].shape[-1]
    shape, slabs = tuple(xb.shape[1:]), xb.shape[0]
    dims = (ctypes.c_int64 * 3)(*shape)
    stream = torch.cuda.current_stream().cuda_stream
    for n in range(3):
        g = mf.launch_shape(shape, n, c, slabs)
        us = [fb[k] for k in range(3) if k != n]
        plain = mf.matrix_free_batched_kernel_plain(xb, us, n)
        out = torch.empty_like(plain)
        ptrs = (ctypes.c_void_p * 3)(*[0 if k == n else fb[k].data_ptr() for k in range(3)])
        for s in mf.SPLITS:
            def run(s=s):
                mf.BATCHED_KERNEL.query(xb.data_ptr(), ptrs, dims, 3, n, c, slabs, s, g.q_chunk,
                                        int(g.vec), out.data_ptr(), stream)
            ms = _time_ms(torch, run, 50)
            rel, _ = _rel(torch, out, plain)
            _log(f"[{phase}] matrix_free batched S={slabs} mode {n} at splits {s} "
                 f"({g.row_blocks * slabs * s} CTAs in clusters of {s}): {ms:.4f} ms (CUDA "
                 f"events, 50 launches), rel err {rel:.2e}"
                 f"{' <- the geometry' if s == g.splits else ''}; card {smi}")
            if not rel <= REL_ERR_BOUND:
                raise SystemExit(f"matrix_free batched mode {n} at splits {s} disagrees with its "
                                 "plain version")


def _einsum_spec(order: int, n: int) -> str:
    letters = "abdefg"[:order]
    terms = [letters] + [letters[k] + "c" for k in range(order) if k != n]
    return ",".join(terms) + f"->{letters[n]}c"


def _kernel_leaves(plan, algorithm: str) -> int:
    """Root leaves of ``plan`` that run ``algorithm`` (one launch a sweep)."""
    return sum(1 for np_ in plan.nodes
               if np_.node.from_root and np_.node.is_leaf and np_.algorithm == algorithm)


def _serve_phase(torch, args, dev, smi, subjects, gen):
    """Phase 6: serve the fleet under each strategy.  Returns the batched
    kernels' launches under the kernel strategies, the batched sweep's
    seconds (host clock, one dispatch's cp_als over its sweeps) under each,
    the per-request inits and the served fits of the rank-``--rank``
    requests under ``autotune`` (subject order)."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import Problem, TuningCache, cp_als, plan_sweep
    from repro_torch.serve import CPService

    rank, sweeps = args.rank, args.sweeps
    shape = tuple(subjects[0].shape)
    requests = [(i, rank) for i in range(len(subjects))]
    requests += [(i, SECOND_RANK) for i in range(SECOND_SUBJECTS)]
    inits = {(i, r): [torch.randn((d, r), generator=gen, device=dev) for d in shape]
             for i, r in requests}
    n_batches = {rank: -(-len(subjects) // SERVE_BATCH), SECOND_RANK: 1}
    padded = SERVE_BATCH * n_batches[rank] - len(subjects)
    want_stats = {"completed": len(requests), "signatures": 2, "compiles": 2,
                  "batches": sum(n_batches.values()), "padded_slots": padded}
    counters = (fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL)

    def submit_all(svc, reqs):
        return [svc.submit(subjects[i], r, init_factors=inits[(i, r)]) for i, r in reqs]

    fits, served_launches, second_fits = {}, {}, {}
    for strategy in ("autotune", "fused", "matrix_free"):
        svc = CPService(batch_size=SERVE_BATCH, n_iters=sweeps, tol=0.0, strategy=strategy,
                        tuning_cache=TuningCache(), device=dev)
        futs = submit_all(svc, requests)
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        svc.flush()
        torch.cuda.synchronize()
        got = tuple(k.launches for k in counters)
        plans = {r: plan_sweep(Problem(shape, r, batch=SERVE_BATCH), strategy,
                               tuning_cache=TuningCache()) for r in n_batches}
        want = [0, 0, 0, 0]
        for r, plan in plans.items():
            want[1] += _kernel_leaves(plan, "fused") * sweeps * n_batches[r]
            want[3] += _kernel_leaves(plan, "matrix_free") * sweeps * n_batches[r]
            _log(f"[6] {strategy} rank {r}: schedule {plan.resolved_schedule.name} "
                 f"nodes {[np_.algorithm for np_ in plan.nodes]}")
        stats = svc.stats()
        _log(f"[6] {strategy}: stats {json.dumps({k: stats[k] for k in sorted(stats)})}")
        _log(f"[6] {strategy}: launches fused {got[0]} fused_batched {got[1]} "
             f"matrix_free {got[2]} matrix_free_batched {got[3]} (want {want})")
        if {k: stats[k] for k in want_stats} != want_stats:
            raise SystemExit(f"{strategy}: serving counters {stats} != {want_stats}")
        if list(got) != want:
            raise SystemExit(f"{strategy}: launch counts {got} != {want}")
        if strategy != "autotune" and max(got) != 3 * sweeps * want_stats["batches"]:
            raise SystemExit(f"{strategy}: not every mode of every batch sweep ran the kernel")
        served_launches[strategy] = max(got)
        res = [f.result() for f in futs]
        if not all(math.isfinite(r.fit) and r.sweeps == sweeps for r in res) or not all(
            bool(torch.isfinite(u).all()) for r in res for u in r.factors
        ):
            raise SystemExit(f"{strategy}: non-finite served result or wrong sweep count")
        fits[strategy] = [r.fit for r in res]
        second_fits[strategy] = [r.fit for (_, r_), r in zip(requests, res) if r_ == SECOND_RANK]
        # subject 0 against the unbatched cp_als on that subject alone
        one = cp_als(subjects[0], plan_sweep(Problem(shape, rank), strategy,
                                             tuning_cache=TuningCache()),
                     n_iters=sweeps, tol=0.0, init_factors=inits[(0, rank)])
        d0 = abs(float(one.fit) - res[0].fit)
        _log(f"[6] {strategy}: subject 0 served fit {res[0].fit:.7f} vs unbatched "
             f"{float(one.fit):.7f}: |diff| {d0:.3e} (bound {FIT_AGREE:g})")
        if d0 > FIT_AGREE:
            raise SystemExit(f"{strategy}: served subject 0 disagrees with its unbatched run")
        # the same fleet again, timed: the warm service (plans made)
        submit_all(svc, requests)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _log(f"[6] {strategy}: {len(requests) / dt:.2f} problems/s, "
             f"{1e3 * dt / want_stats['batches']:.3f} ms per batch of {SERVE_BATCH} x {sweeps} "
             f"sweeps (host clock, second flush of {len(requests)} requests); peak memory "
             f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; card {smi}")
    gap = max(abs(a - b) for s in ("fused", "matrix_free")
              for a, b in zip(fits[s], fits["autotune"]))
    _log(f"[6] per-request fit agreement across strategies: max |diff| {gap:.3e} "
         f"(bound {FIT_AGREE:g})")
    if gap > FIT_AGREE:
        raise SystemExit("strategies disagree on the served fits")

    # batch_size=1: every dispatch is an unbatched problem -> unbatched kernels only
    second = [(i, SECOND_RANK) for i in range(SECOND_SUBJECTS)]
    for strategy, own in (("fused", 0), ("matrix_free", 2)):
        svc = CPService(batch_size=1, n_iters=sweeps, tol=0.0, strategy=strategy,
                        tuning_cache=TuningCache(), device=dev)
        futs = submit_all(svc, second)
        for k in counters:
            k.launches = 0
        svc.flush()
        torch.cuda.synchronize()
        got = [k.launches for k in counters]
        want = [0, 0, 0, 0]
        want[own] = len(second) * sweeps * 3
        _log(f"[6] {strategy} batch_size=1: launches {got} (want {want})")
        if got != want:
            raise SystemExit(f"{strategy} batch_size=1: launch counts {got} != {want}")
        res = [f.result() for f in futs]
        if not all(math.isfinite(r.fit) and r.sweeps == sweeps for r in res) or not all(
            bool(torch.isfinite(u).all()) for r in res for u in r.factors
        ):
            raise SystemExit(f"{strategy} batch_size=1: non-finite served result or wrong sweep count")
        d1 = max(abs(r.fit - f) for r, f in zip(res, second_fits[strategy]))
        _log(f"[6] {strategy} batch_size=1 vs batch_size={SERVE_BATCH} rank {SECOND_RANK} fits "
             f"from the same inits: max |diff| {d1:.3e} (bound {FIT_AGREE:g})")
        if d1 > FIT_AGREE:
            raise SystemExit(f"{strategy} batch_size=1: served fits disagree with the batched ones")

    # the batched sweep under each kernel strategy as a dispatch runs it (all
    # sweeps in one chunk, one host sync), for the time outside the kernels;
    # the second of two calls, host clock, the call's set-up included
    xb = torch.stack(subjects[:SERVE_BATCH])
    init = [torch.stack([inits[(i, rank)][m] for i in range(SERVE_BATCH)]) for m in range(3)]
    sweep_s = {}
    for strategy in ("fused", "matrix_free"):
        plan = plan_sweep(Problem(shape, rank, batch=SERVE_BATCH), strategy,
                          tuning_cache=TuningCache())
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp_als(xb, plan, n_iters=sweeps, tol=0.0, init_factors=init,
                   sweeps_per_sync=sweeps)
            torch.cuda.synchronize()
            sweep_s[strategy] = (time.perf_counter() - t0) / sweeps
    return served_launches, sweep_s, inits, fits["autotune"][: len(subjects)]


# ---- row 7, the KRP pair: what phases 8, 11, 21 and 22 check of it (and --only krp)
def _krp_case(torch, label, a, b, want_vec, phase, block_b=512) -> None:
    """One ``krp_pair`` call held bitwise to its plain version, with one
    launch on the path ``want_vec`` says (16-byte or one-element, read off
    ``KERNEL.vector_launches``)."""
    from repro_torch.kernels import krp_kernel as kk

    before = (kk.KERNEL.launches, kk.KERNEL.vector_launches)
    out = kk.krp_pair(a, b, block_b=block_b)
    torch.cuda.synchronize()
    launched, vector = kk.KERNEL.launches - before[0], kk.KERNEL.vector_launches - before[1]
    same = torch.equal(out, kk.krp_pair_plain(a, b))
    ok = same and launched == 1 and vector == int(want_vec)
    path = {1: "16-byte", 0: "one-element"}
    _log(f"[{phase}] krp_pair {label}: {tuple(a.shape)} (.) {tuple(b.shape)} "
         f"{str(a.dtype).removeprefix('torch.')} block_b {block_b}: bitwise the plain version "
         f"{same}, launches {launched}, {path.get(vector, vector)} path (want "
         f"{path[int(want_vec)]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[{phase}] krp_pair {label}: wrong, not one launch or the wrong path")


def _krp_edge_cases(torch, dev, dtype, phase) -> None:
    """Row 7 beside the fMRI folds, in ``dtype``: a row span that is no
    whole number of 16-byte units (7 x 13 at rank 3), B and then A as the
    second row block of a contiguous (2, 13, 3) stack (off a 16-byte line:
    B's alignment decides the path, A's does not), B one element past a
    line with a span of whole units, and 70000 rows of B at ``block_b=1``
    (70000 tiles, which the first version refused past 65535)."""
    gen = torch.Generator(device=dev).manual_seed(34)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    stack, flat = rnd(2, 13, 3), rnd(1 + 200 * 10)
    if stack[1].data_ptr() % 16 == 0 or flat[1:].data_ptr() % 16 == 0:
        raise SystemExit(f"[{phase}] krp_pair edge cases: a misaligned operand is aligned")
    for label, a, b, want_vec, block_b in (
        ("row span off the 16-byte unit", rnd(7, 3), rnd(13, 3), False, 512),
        ("B the second block of a (2, 13, 3) stack", rnd(5, 3), stack[1], False, 512),
        ("A the second block of a (2, 13, 3) stack", stack[1], rnd(200, 3), True, 512),
        ("B one element past a 16-byte line", rnd(3, 10), flat[1:].view(200, 10), False, 512),
        ("70000 rows of B, one a tile", rnd(4, 3), rnd(70000, 3), True, 1),
    ):
        _krp_case(torch, label, a, b, want_vec, phase, block_b)


def _krp_rate(torch, k12, u3, ms, byts, bound_ms, smi, phase) -> None:
    """Row 7's achieved TB/s at the fMRI KRP's last fold and the path it
    took, with its launch geometry and a call's host and device time
    (``_host_device_us``: back-to-back calls run at the slower of the two);
    raise unless the 16-byte path."""
    from repro_torch.kernels import krp_kernel as kk

    before = kk.KERNEL.vector_launches
    kk.krp_pair(k12, u3, block_b=512)
    vector = kk.KERNEL.vector_launches - before
    g = kk.launch_shape(k12.shape[0], u3.shape[0], u3.shape[1], k12.element_size(), True)
    host, dev, _, _ = _host_device_us(torch, lambda: kk.krp_pair(k12, u3, block_b=512), 50)
    _log(f"[{phase}] krp_pair {str(k12.dtype).removeprefix('torch.')} {tuple(k12.shape)} (.) "
         f"{tuple(u3.shape)}: {byts / ms / 1e9:.3f} TB/s ({byts / 1e6:.1f} MB in {ms:.4f} ms), "
         f"{bound_ms / ms:.2f} of the bound, {'16-byte' if vector else 'one-element'} path "
         f"(grid {g.blocks} x {kk.THREADS}: {g.tiles} tiles of {g.tile} positions, "
         f"{g.rows_per_step} rows a step, {g.per_thread} vectors of {g.vec} a thread); a call "
         f"host {host:.2f} us (host clock, 50 calls, no sync), device {dev:.2f} us "
         f"(torch.profiler, {byts / dev / 1e6:.3f} TB/s); card {smi}")
    if not vector:
        raise SystemExit(f"[{phase}] krp_pair at the fMRI fold did not take the 16-byte path")


def _krp_checks8(torch, check, init):
    """Phase 8's row-7 checks: ``krp_materialize`` of the factors of modes
    1-3 and 0-1 against the oracle, the last fold and ``U0 (.) U1`` bitwise
    their plain versions and repeatable, then :func:`_krp_edge_cases` in
    float32.  Returns the last fold's left factor ``U1 (.) U2``."""
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import ops, ref

    u0, u1, u2, u3 = init

    def bitwise(label, run, plain):
        a, b = run(), run()
        ok = torch.equal(a, b) and torch.equal(a, plain)
        _log(f"[8] {label} run twice bitwise equal, and bitwise its plain version: "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: not bitwise repeatable or not its plain version")
        return a

    k_full = bitwise("krp_materialize [U1, U2, U3]", lambda: ops.krp_materialize([u1, u2, u3]),
                     ref.krp_ref([u1, u2, u3]))
    check(f"krp_materialize [U1, U2, U3] {tuple(k_full.shape)} ({k_full.numel() * 4 / 1e6:.0f} MB)",
          "krp", k_full, ref.krp_ref([u1, u2, u3]), 8)
    del k_full
    k12 = kk.krp_pair(u1, u2, block_b=512)
    last = bitwise("krp_pair (U1 (.) U2) (.) U3, the last fold",
                   lambda: kk.krp_pair(k12, u3, block_b=512), kk.krp_pair_plain(k12, u3))
    check("krp_pair (U1 (.) U2) (.) U3, the last fold", "krp", last, kk.krp_pair_plain(k12, u3), 8)
    del last
    bitwise("krp_pair U0 (.) U1", lambda: kk.krp_pair(u0, u1, block_b=512),
            kk.krp_pair_plain(u0, u1))
    check("krp_materialize [U0, U1]", "krp", ops.krp_materialize([u0, u1]), ref.krp_ref([u0, u1]), 8)
    _krp_edge_cases(torch, u0.device, torch.float32, 8)
    return k12


def _krp_time11(torch, k12, u3, smi):
    """Phase 11's row 7: the last fold's kernel, plain and one-einsum ms
    (CUDA events, 50 launches) beside its bound, then :func:`_krp_rate`."""
    from repro_torch.kernels import krp_kernel as kk

    n_out = k12.shape[0] * u3.shape[0] * u3.shape[1]
    byts = 4 * (k12.numel() + u3.numel() + n_out)
    r = {"ms": _time_ms(torch, lambda: kk.krp_pair(k12, u3, block_b=512), 50),
         "plain_ms": _time_ms(torch, lambda: kk.krp_pair_plain(k12, u3), 50),
         "library_ms": _time_ms(torch, lambda: torch.einsum("ac,bc->abc", k12, u3), 50),
         "bytes_ms": byts / HBM_BW * 1e3, "flops_ms": n_out / PEAK_FLOPS * 1e3}
    bound = max(r["bytes_ms"], r["flops_ms"])
    _log(f"[11] krp_pair {tuple(k12.shape)} (.) {tuple(u3.shape)} -> ({n_out // u3.shape[1]}, "
         f"{u3.shape[1]}): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
         f"{r['library_ms']:.4f} ms, bound {bound:.4f} ms "
         f"({'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}); card {smi}")
    _krp_rate(torch, k12, u3, r["ms"], byts, bound, smi, 11)
    return r


def _krp_row(torch, row, fs, smi, phase, reps):
    """Row 7 of phases 21 and 22 at the KRP's last fold of ``fs`` (in their
    dtype) through the phase's ``row`` (gates and times), then
    :func:`_krp_rate`."""
    from repro_torch.kernels import krp_kernel as kk

    k12, u3 = kk.krp_pair(fs[1], fs[2], block_b=512), fs[3]
    isz = k12.element_size()
    n_out = k12.shape[0] * u3.shape[0] * u3.shape[1]
    byts = isz * (k12.numel() + u3.numel() + n_out)
    r = row("krp", f"krp_pair {tuple(k12.shape)} (.) {tuple(u3.shape)} (the KRP's last fold, "
            f"{isz * n_out / 1e9:.2f} GB)", kk.KERNEL, lambda: kk.krp_pair(k12, u3, block_b=512),
            lambda: kk.krp_pair_plain(k12, u3), lambda: torch.einsum("ac,bc->abc", k12, u3),
            byts, n_out, 1, reps)
    _krp_rate(torch, k12, u3, r["ms"], byts, max(r["bytes_ms"], r["flops_ms"]), smi, phase)
    del k12
    torch.cuda.empty_cache()
    return r


def _row_sums(rows, err) -> dict:
    """Each row's sums over its calls (phases 21 and 22)."""
    summary = {}
    for key, rs in rows.items():
        b_bytes, b_ops = sum(r["bytes_ms"] for r in rs), sum(r["flops_ms"] for r in rs)
        summary[key] = {"ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                        "library_ms": sum(r["library_ms"] for r in rs),
                        "bound_ms": max(b_bytes, b_ops),
                        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                        "calls": len(rs), "max_abs_err": err[key]}
    return summary


def _only_krp(torch, args, dev, smi) -> None:
    """``--only krp``: build ``krp_pair.cu``, then row 7 alone: phase 8's
    checks on the fMRI factors at ``--rank`` (random, from ``--seed``),
    phase 11's timing, phase 21's row at ranks 80 and 128 and phase 22's
    in bf16, fp16 and float64 at rank 10, with their edge cases."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import krp_kernel as kk

    t0 = time.perf_counter()
    _build.build_all([kk.KERNEL])
    _log(f"[1] built {kk.KERNEL.source.name} in {time.perf_counter() - t0:.1f} s")
    _log_ptxas([kk.KERNEL])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    init = [torch.randn((d, args.rank), generator=gen, device=dev) for d in FMRI]
    err = {"krp": 0.0}
    k12 = _krp_checks8(torch, _checker(torch, err), init)
    _krp_time11(torch, k12, init[3], smi)
    del k12
    for rank in HIGH_RANKS:
        fs = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
        summary = _high_rank_rows(torch, None, fs, None, None, smi, rank, err, krp_only=True)
        _log(f"[21] row 7 at rank {rank}: {json.dumps(summary)}")
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        fs = [u.to(dtype) for u in init]
        rows = _dtype_rows(torch, None, None, fs, None, args.rank, smi, err, True, krp_only=True)
        _log(f"[22] {str(dtype).removeprefix('torch.')} row 7 at rank {args.rank}: "
             f"{json.dumps(_row_sums(rows, err))}")


def _new_kernels_phases(torch, args, dev, smi, x4, init, f4, subjects, fb, gen, check, rows,
                        auto_fits, auto_secs, serve_inits, serve_fits):
    """Phases 8-11 (see the module docstring).  ``check`` and ``rows`` are
    main()'s error check and timing table; returns the launches of each new
    kernel's path (phase 9)."""
    from repro_torch.kernels import _tiling, ops, ref
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.plan import Problem, TuningCache, cp_als, plan_sweep, tune
    from repro_torch.plan.autotune import (
        FUSED_TILE_CANDIDATES,
        MATRIX_FREE_TILE_CANDIDATES,
        TTV_TILE_CANDIDATES,
    )
    from repro_torch.serve import CPService

    rank, sweeps = args.rank, args.sweeps

    def same_twice(label, run):
        a, b = run(), run()
        ok = torch.equal(a, b)
        _log(f"[8] {label} run twice bitwise equal: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: not bitwise repeatable")
        return a

    # ---- phase 8: the new kernels against their plain versions; the split knob
    ttv_blocks = TTV_TILE_CANDIDATES + (32, 1024)

    def geometry(t, bi, slabs):
        g = mt.launch_shape(t.shape[-2], t.shape[-3], t.shape[-1], bi, slabs)
        return (f"grid ({g.tiles}, {g.cluster}, {g.slabs}), clusters of {g.cluster}, "
                f"{g.threads_x}x{g.groups} threads, {'float4' if g.vec else 'scalar'}")

    def ttv_checks(label, key, t, w, run, plain):
        want = plain(t, w)
        slabs = len(t) if key == "mt_b" else 1
        for bi in ttv_blocks:
            check(f"{label} T{tuple(t.shape)} block_i {bi} ({geometry(t, bi, slabs)})", key,
                  run(t, w, block_i=bi), want, 8)
        same_twice(f"{label} T{tuple(t.shape)}", lambda: run(t, w))

    ttv_ops = {n: ops.multi_ttv_operands(x4, init, n) for n in (1, 2)}  # the 2-step 2nd steps
    for n, (t, w) in ttv_ops.items():
        ttv_checks(f"multi_ttv mode {n}", "mt", t, w, mt.multi_ttv, mt.multi_ttv_plain)
    for r_ in (SECOND_RANK, 64):
        f_r = [torch.randn((d, r_), generator=gen, device=dev) for d in FMRI]
        for n in (1, 2):
            t, w = ops.multi_ttv_operands(x4, f_r, n)
            ttv_checks(f"multi_ttv mode {n} rank {r_}", "mt", t, w, mt.multi_ttv,
                       mt.multi_ttv_plain)
    # ragged: I * C % 4 != 0 (the scalar path's masked tail) and L = 3 < a cluster
    t = torch.randn((3, 59, 7), generator=gen, device=dev)
    w = torch.randn((3, 7), generator=gen, device=dev)
    ttv_checks("multi_ttv ragged", "mt", t, w, mt.multi_ttv, mt.multi_ttv_plain)
    ttv_checks("multi_ttv_batched ragged", "mt_b", torch.stack([t, t.flip(0)]),
               torch.stack([w, w.flip(0)]), mt.multi_ttv_batched, mt.multi_ttv_batched_plain)
    del f_r, t, w

    def batch_ttv_operands(idx, fs):  # mode 1 of each subject: L = 225 > R = 200, left-first
        pairs = [ops.multi_ttv_operands(subjects[i], [f[j] for f in fs], 1)
                 for j, i in enumerate(idx)]
        return torch.stack([t for t, _ in pairs]), torch.stack([w for _, w in pairs])

    tb, wb = batch_ttv_operands(range(SERVE_BATCH), fb)
    ttv_checks(f"multi_ttv_batched S={SERVE_BATCH}", "mt_b", tb, wb, mt.multi_ttv_batched,
               mt.multi_ttv_batched_plain)
    ttv_checks("multi_ttv_batched S=5 (odd)", "mt_b", tb[:5], wb[:5], mt.multi_ttv_batched,
               mt.multi_ttv_batched_plain)
    for r_ in (SECOND_RANK, 64):
        fb_r = [torch.randn((SERVE_BATCH, d, r_), generator=gen, device=dev)
                for d in subjects[0].shape]
        t, w = batch_ttv_operands(range(SERVE_BATCH), fb_r)
        ttv_checks(f"multi_ttv_batched S={SERVE_BATCH} rank {r_}", "mt_b", t, w,
                   mt.multi_ttv_batched, mt.multi_ttv_batched_plain)
    del fb_r, t, w
    other = [torch.randn(f.shape, generator=gen, device=dev) for f in fb]
    ub, vb = batch_ttv_operands([(SERVE_BATCH + k) % len(subjects) for k in range(SERVE_BATCH)],
                                other)
    ub, vb = torch.cat([tb[:1], ub[1:]]), torch.cat([wb[:1], vb[1:]])
    same = torch.equal(mt.multi_ttv_batched(tb, wb)[0], mt.multi_ttv_batched(ub, vb)[0])
    _log(f"[8] slab 0 of multi_ttv_batched bitwise unchanged by slabs 1..: {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("multi_ttv_batched: slab 0 depends on the other slabs")
    del other, ub, vb

    u1, u2, u3 = init[1:]
    k12 = _krp_checks8(torch, check, init)

    default_bps = _tiling.BLOCKS_PER_SM
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, f4, n)
        us = [f4[k] for k in range(4) if k != n]
        for label, key, run, plain, cands in (
            ("fused", "fused", lambda **kw: fm.fused_mttkrp_bilinear(t, a, b, pos=pos, **kw),
             fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos), FUSED_TILE_CANDIDATES),
            ("matrix_free", "mf", lambda **kw: mf.matrix_free_kernel(x4, us, n, **kw),
             mf.matrix_free_kernel_plain(x4, us, n), MATRIX_FREE_TILE_CANDIDATES),
        ):
            default = run()
            for bps in cands:
                out = run(blocks_per_sm=bps)
                check(f"{label} mode {n} blocks_per_sm {bps}", key, out, plain, 8)
                if bps == default_bps and not torch.equal(out, default):
                    raise SystemExit(f"{label} mode {n}: blocks_per_sm={bps} differs from the default")
            _log(f"[8] {label} mode {n} blocks_per_sm={default_bps} bitwise equal to the call "
                 "without the knob: ok")
    torch.cuda.synchronize()

    # ---- phase 9: the paths of the new kernels, with their launch counts
    path = {}
    for k in (mt.KERNEL, fm.KERNEL, mf.KERNEL):
        k.launches = 0
    two_step = [ops.mttkrp_2step_kernel(x4, init, n) for n in range(4)]
    torch.cuda.synchronize()
    got = (mt.KERNEL.launches, fm.KERNEL.launches, mf.KERNEL.launches)
    _log(f"[9] mttkrp_2step_kernel on every mode: launches multi_ttv {got[0]} fused {got[1]} "
         f"matrix_free {got[2]} (want 2, 2, 0)")
    if got != (2, 2, 0):
        raise SystemExit(f"mttkrp_2step_kernel launch counts {got} != (2, 2, 0)")
    path["mt"] = got[0]
    for n, out in enumerate(two_step):
        check(f"mttkrp_2step_kernel mode {n} vs the einsum oracle", "2step", out,
              ref.fused_mttkrp_ref(x4, init, n), 9)
    del two_step
    kk.KERNEL.launches = 0
    ops.krp_materialize([u1, u2, u3])
    mt.BATCHED_KERNEL.launches = 0
    ops.multi_ttv_batched(tb, wb)
    torch.cuda.synchronize()
    path["krp"], path["mt_b"] = kk.KERNEL.launches, mt.BATCHED_KERNEL.launches
    _log(f"[9] krp_materialize [U1, U2, U3]: krp_pair launches {path['krp']} (want 2); "
         f"ops.multi_ttv_batched S={SERVE_BATCH}: launches {path['mt_b']} (want 1)")
    if (path["krp"], path["mt_b"]) != (2, 1):
        raise SystemExit("krp_materialize / multi_ttv_batched launch counts are off")

    # ---- phase 10: the tuning path
    kernels = (fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL, mt.KERNEL,
               mt.BATCHED_KERNEL, kk.KERNEL)

    def run_tune(x, factors, label):
        cache = TuningCache(None)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        entry = tune(x, rank, factors=factors, cache=cache, budget_ms=None, reps=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name_, summ in entry["tiles"].items():
            for r in summ["rows"]:
                _log(f"[10] tune {label} tile {name_} mode {summ['mode']} candidate "
                     f"{r['candidate']} launch {r['effective']}: {1e3 * r['measured_s']:.4f} ms "
                     f"(CUDA events, median of 3); card {smi}")
            chosen = {k_: v for k_, v in summ.items() if k_ not in
                      ("mode", "default_s", "tuned_s", "speedup_vs_default", "rows")}
            _log(f"[10] tune {label} tile {name_}: chosen {chosen}, default "
                 f"{1e3 * summ['default_s']:.4f} ms, tuned {1e3 * summ['tuned_s']:.4f} ms, "
                 f"speedup {summ['speedup_vs_default']:.3f}")
        for r in entry["nodes"]:
            _log(f"[10] tune {label} node {r['key']} ({r['schedule']}): "
                 f"{1e3 * r['measured_s']:.4f} ms")
        launched = {k.symbol: k.launches for k in kernels if k.launches}
        _log(f"[10] tune {label}: {len(entry['nodes'])} node rows, elapsed_ms "
             f"{entry['elapsed_ms']:.1f} (its budget clock, after the build), {wall:.1f} s wall; "
             f"launches {launched}; card {smi}")
        if not all(summ["rows"] for summ in entry["tiles"].values()):
            raise SystemExit(f"tune {label}: a tile table is empty")
        return cache

    cache = run_tune(x4, init, "x4")
    problem = Problem.from_tensor(x4, rank)
    plan = plan_sweep(problem, strategy="autotune", tuning_cache=cache)
    desc = plan.describe()
    _log(f"[10] autotune plan describe(): {json.dumps(desc)}")
    if any(nd["measured_s"] is None for nd in desc["nodes"]):
        raise SystemExit("autotune plan: a node carries no measured_s")
    _log(f"[10] autotune plan: schedule {plan.resolved_schedule.name} nodes "
         f"{[(np_.algorithm, np_.tiles) for np_ in plan.nodes]}")
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tuned_fits, secs = [], []
    st = cp_als(x4, plan, n_iters=sweeps, tol=0.0, init_factors=init,
                callback=lambda it, f, dt: (tuned_fits.append(f), secs.append(dt)))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = (fm.KERNEL.launches, mf.KERNEL.launches)
    want = (_kernel_leaves(plan, "fused") * sweeps, _kernel_leaves(plan, "matrix_free") * sweeps)
    gap = max(abs(a - b) for a, b in zip(tuned_fits, auto_fits))
    _log(f"[10] cp_als under the tuned plan: fits {tuned_fits}; per-sweep s {secs} (host clock, "
         f"one device sync per sweep; phase 3 auto {auto_secs}); peak memory {peak:.3f} GB; "
         f"launches fused {got[0]} matrix_free {got[1]} (want {want}); fits vs phase 3 auto: "
         f"max |diff| {gap:.3e} (bound {FIT_AGREE:g}); card {smi}")
    if got != want or any(k.launches for k in kernels if k not in (fm.KERNEL, mf.KERNEL)):
        raise SystemExit(f"tuned cp_als launch counts {got} != {want}")
    if st.it != sweeps or not all(math.isfinite(f) for f in tuned_fits) or gap > FIT_AGREE:
        raise SystemExit("tuned cp_als: wrong sweep count, non-finite fit or fits off phase 3's")

    shape = tuple(subjects[0].shape)
    cache2 = run_tune(subjects[0], serve_inits[(0, rank)], "subject 0")
    plan2 = plan_sweep(Problem(shape, rank), "autotune", tuning_cache=cache2)
    _log(f"[10] subject plan: schedule {plan2.resolved_schedule.name} nodes "
         f"{[(np_.algorithm, np_.tiles) for np_ in plan2.nodes]}")
    svc = CPService(batch_size=1, n_iters=sweeps, tol=0.0, strategy="autotune",
                    tuning_cache=cache2, device=dev)
    futs = [svc.submit(subjects[i], rank, init_factors=serve_inits[(i, rank)])
            for i in range(SECOND_SUBJECTS)]
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    svc.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = [k.launches for k in kernels]
    want = [0] * len(kernels)
    want[0] = _kernel_leaves(plan2, "fused") * sweeps * SECOND_SUBJECTS
    want[2] = _kernel_leaves(plan2, "matrix_free") * sweeps * SECOND_SUBJECTS
    stats = svc.stats()
    res = [f.result() for f in futs]
    d = max(abs(r.fit - serve_fits[i]) for i, r in enumerate(res))
    _log(f"[10] CPService(batch_size=1, autotune, tuned cache) subjects 0-{SECOND_SUBJECTS - 1}: "
         f"warm_plan_hits {stats['warm_plan_hits']} (want 1), compiles {stats['compiles']}; "
         f"launches {got} (want {want}); fits vs phase 6: max |diff| {d:.3e} "
         f"(bound {FIT_AGREE:g}); {SECOND_SUBJECTS / dt:.2f} problems/s (host clock, first "
         f"flush, plan made in it); card {smi}")
    if stats["warm_plan_hits"] != 1 or got != want:
        raise SystemExit("tuned service: warm-plan hits or launch counts are off")
    if not all(math.isfinite(r.fit) and r.sweeps == sweeps for r in res) or d > FIT_AGREE:
        raise SystemExit("tuned service: non-finite result, wrong sweep count or fits off")

    # ---- phase 11: timing of the new kernels, and of the knob
    def bound(byts, flops):
        return {"bytes_ms": byts / HBM_BW * 1e3, "flops_ms": flops / PEAK_FLOPS * 1e3}

    def log_row(label, row):
        b = max(row["bytes_ms"], row["flops_ms"])
        _log(f"[11] {label}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
             f"library {row['library_ms']:.4f} ms, bound {b:.4f} ms "
             f"({'bytes' if row['bytes_ms'] >= row['flops_ms'] else 'operations'}); card {smi}")

    per_call = {}  # CUDA kernels one call launches, from a CUDA graph of the call

    def split_row(label, key, kernel, library):
        """The host/device split of one kernel call and of its library call."""
        kh, kd, k, names = _host_device_us(torch, kernel, 200)
        ops, kern = _graph_ops(torch, kernel)
        per_call[key] = ops if ops == kern else (ops, kern)
        lh, ld, lk, _ = _host_device_us(torch, library, 200)
        _log(f"[11] {label}: kernel host {kh:.2f} us a call (host clock, 200 calls, no sync), "
             f"device {kd:.2f} us a call (torch.profiler: {k:g} kernels a call, {names}), "
             f"{ops} device operations a call, {kern} of them kernels (CUDA graph of one "
             f"call); library host {lh:.2f} us, device {ld:.2f} us ({lk:g} CUDA kernels a "
             f"call, torch.profiler); card {smi}")

    for n, (t, w) in ttv_ops.items():
        r = {"ms": _time_ms(torch, lambda: mt.multi_ttv(t, w), 200),
             "plain_ms": _time_ms(torch, lambda: mt.multi_ttv_plain(t, w), 200),
             "library_ms": _time_ms(torch, lambda: torch.einsum("lic,lc->ic", t, w), 200),
             **bound(4 * (t.numel() + w.numel() + t.shape[1] * t.shape[2]), 2 * t.numel())}
        rows.setdefault("mt", []).append(r)
        log_row(f"multi_ttv mode {n} T{tuple(t.shape)}", r)
        split_row(f"multi_ttv mode {n} T{tuple(t.shape)}", f"mt{n}", lambda: mt.multi_ttv(t, w),
                  lambda: torch.einsum("lic,lc->ic", t, w))
    r = {"ms": _time_ms(torch, lambda: mt.multi_ttv_batched(tb, wb), 100),
         "plain_ms": _time_ms(torch, lambda: mt.multi_ttv_batched_plain(tb, wb), 100),
         "library_ms": _time_ms(torch, lambda: torch.einsum("slic,slc->sic", tb, wb), 100),
         **bound(4 * (tb.numel() + wb.numel() + SERVE_BATCH * tb.shape[2] * tb.shape[3]),
                 2 * tb.numel())}
    rows["mt_b"] = [r]
    log_row(f"multi_ttv_batched T{tuple(tb.shape)}", r)
    split_row(f"multi_ttv_batched T{tuple(tb.shape)}", "mt_b",
              lambda: mt.multi_ttv_batched(tb, wb), lambda: torch.einsum("slic,slc->sic", tb, wb))
    def device_by_block(label, run, t, w):
        us = {bi: round(_host_device_us(torch, lambda: run(t, w, block_i=bi), 50)[1], 2)
              for bi in ttv_blocks}
        _log(f"[11] {label} T{tuple(t.shape)} device us a call by block_i (torch.profiler): "
             f"{us}; card {smi}")

    for n, (t, w) in ttv_ops.items():
        device_by_block(f"multi_ttv mode {n}", mt.multi_ttv, t, w)
    device_by_block("multi_ttv_batched", mt.multi_ttv_batched, tb, wb)
    rows["krp"] = [_krp_time11(torch, k12, u3, smi)]

    tuner_ms = {}
    for name_, summ in cache.get(cache.keys()[0])["tiles"].items():
        tuner_ms[name_] = {r_["candidate"][0]: 1e3 * r_["measured_s"] for r_ in summ["rows"]}
    for label, cands, tiles_key in (("fused", FUSED_TILE_CANDIDATES, "fused_mttkrp"),
                                    ("matrix_free", MATRIX_FREE_TILE_CANDIDATES, "matrix_free")):
        for bps in cands:
            total = 0.0
            for n in range(4):
                if label == "fused":
                    t, a, b, pos = ops.bilinear_operands(x4, init, n)
                    total += _time_ms(torch, lambda: fm.fused_mttkrp_bilinear(
                        t, a, b, pos=pos, blocks_per_sm=bps), 20)
                else:
                    us = [init[k] for k in range(4) if k != n]
                    total += _time_ms(torch, lambda: mf.matrix_free_kernel(
                        x4, us, n, blocks_per_sm=bps), 20)
            tuner = tuner_ms[tiles_key].get(bps)
            _log(f"[11] {label} kernel sweep at blocks_per_sm {bps}: {total:.4f} ms (4 launches, "
                 f"CUDA events); tuner's row, ops wrapper at mode 2: "
                 f"{'deduped' if tuner is None else f'{tuner:.4f} ms'}; card {smi}")
    _log(f"[11] CUDA kernels one call launches (CUDA graph): multi_ttv {per_call['mt1']:g} and "
         f"{per_call['mt2']:g}, multi_ttv_batched {per_call['mt_b']:g} (want 1 each)")
    if set(per_call.values()) != {1}:
        raise SystemExit(f"a multi-TTV call launches other than one CUDA kernel: {per_call}")
    return path


def _only_batched_matrix_free(torch, args, dev, smi) -> None:
    """``--only batched_matrix_free``: build ``matrix_free.cu``, check the
    batched kernel on the 8-subject batch (ranks 10, 16 and 64, S = 8 and
    5, every mode) and on phase 5's extra inputs, time it as phase 7 does
    (CUDA events, device time by the profiler, kernels a call from a CUDA
    graph of one call), and
    trace one served batch dispatch under ``matrix_free``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import matrix_free as mf

    t0 = time.perf_counter()
    _build.build_all([mf.KERNEL, mf.BATCHED_KERNEL])
    _log(f"[1] built {mf.KERNEL.source.name} in {time.perf_counter() - t0:.1f} s")
    for line in mf.KERNEL.ptxas_log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            _log(f"[1] {mf.KERNEL.source.name}: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x4 = synth_fmri(torch, gen, args.rank, dev)
    xb = torch.stack([x4[:, s].contiguous() for s in range(SERVE_BATCH)])
    del x4
    fb = [torch.randn((SERVE_BATCH, d, args.rank), generator=gen, device=dev) for d in xb.shape[1:]]
    fb16 = [torch.randn((SERVE_BATCH, d, SECOND_RANK), generator=gen, device=dev)
            for d in xb.shape[1:]]
    err = {"mf_b": 0.0}
    check = _checker(torch, err)
    for n in range(3):
        for label, x, fs in ((f"S={SERVE_BATCH}", xb, fb), ("S=5 (odd)", xb[:5], [f[:5] for f in fb]),
                             (f"S={SERVE_BATCH} rank {SECOND_RANK}", xb, fb16)):
            us = [fs[k] for k in range(3) if k != n]
            check(f"matrix_free batched {label} mode {n}", "mf_b",
                  mf.matrix_free_batched_kernel(x, us, n),
                  mf.matrix_free_batched_kernel_plain(x, us, n), 5)
    del fb16
    _row4_checks(torch, gen, dev, check, xb, fb, 5)
    for n in range(3):
        us = [fb[k] for k in range(3) if k != n]
        c = fb[0].shape[-1]
        ms = _time_ms(torch, lambda: mf.matrix_free_batched_kernel(xb, us, n), 50)
        byts = 4 * (xb.numel() + sum(u.numel() for u in us) + SERVE_BATCH * xb.shape[1 + n] * c)
        _log(f"[7] matrix_free_batched_kernel S={SERVE_BATCH} mode {n}: kernel {ms:.4f} ms "
             f"(CUDA events, 50 launches), bound {byts / HBM_BW * 1e3:.4f} ms (bytes); card {smi}")
    _row4_device(torch, xb, fb, smi, 7)
    if hasattr(mf, "launch_shape"):
        _row4_occupancy(torch, xb, smi, 7)
    _trace_served_sweep(torch, args, xb, [f.clone() for f in fb], smi, 7)
    _log(f"[5] max abs err of the batched matrix-free kernel: {err['mf_b']:.3e}")


# ---- phase 12: the legacy front door and pairwise-perturbation (PP) sweeps
class _PPRecorder:
    """Wraps the PP engine's module-level steps for one run: the sequence of
    sweeps ('E' exact, 'B' exact followed by a cache build, 'a'
    approximate), the host-gate reads and the last approximate sweep's
    output state.  The engine looks these up by name at call time."""

    NAMES = ("_exact_sweep", "_pp_sweep", "_pp_materialize", "_host_gate")

    def __init__(self, sweep):
        self.sweep = sweep
        self.real = {k: getattr(sweep, k) for k in self.NAMES}
        self.seq, self.reads, self.last_pp = [], [], None

    def __enter__(self):
        real = self.real

        def exact(*a, **k):
            self.seq.append("E")
            return real["_exact_sweep"](*a, **k)

        def pp_sweep(*a, **k):
            self.seq.append("a")
            self.last_pp = real["_pp_sweep"](*a, **k)
            return self.last_pp

        def build(*a, **k):
            if self.seq and self.seq[-1] == "E":
                self.seq[-1] = "B"
            return real["_pp_materialize"](*a, **k)

        def gate(d):
            v = real["_host_gate"](d)
            self.reads.append(v)
            return v

        for name, fn in zip(self.NAMES, (exact, pp_sweep, build, gate)):
            setattr(self.sweep, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.sweep, name, fn)

    @property
    def pattern(self) -> str:
        return "".join(self.seq)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def _pp_run(torch, x4, plan, init, executor=None):
    """A PP ``cp_als`` of ``PP_SWEEPS`` sweeps from ``init`` under the
    recorder: ``(state, recorder, per-sweep fits, per-sweep seconds)``."""
    from repro_torch.plan import cp_als
    from repro_torch.plan import sweep as tsweep

    fits, secs = [], []
    with _PPRecorder(tsweep) as rec:
        st = cp_als(x4, plan, executor=executor, n_iters=PP_SWEEPS, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: (fits.append(f), secs.append(dt)))
    torch.cuda.synchronize()
    return st, rec, fits, secs


def _pp_fleet(torch, args, dev, subjects, serve_inits, mesh=None):
    """The 59 subjects served as PP problems by ``CPService(batch_size=8,
    pp_tol=PP_FLEET_TOL, strategy="pp")`` from phase 6's inits, on ``mesh``
    when given: ``(service, results, each batch's cp_als state, recorder,
    seconds of the flush)``."""
    from repro_torch.plan import TuningCache
    from repro_torch.plan import sweep as tsweep
    from repro_torch.serve import CPService, cp_service

    rank = args.rank
    states = []
    real_cp_als = cp_service.cp_als

    def recording_cp_als(*a, **k):
        states.append(real_cp_als(*a, **k))
        return states[-1]

    svc = CPService(batch_size=SERVE_BATCH, n_iters=args.sweeps, tol=0.0, pp_tol=PP_FLEET_TOL,
                    strategy="pp", tuning_cache=TuningCache(), mesh=mesh, device=dev)
    futs = [svc.submit(subjects[i], rank, init_factors=serve_inits[(i, rank)])
            for i in range(len(subjects))]
    cp_service.cp_als = recording_cp_als
    try:
        with _PPRecorder(tsweep) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.flush()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        cp_service.cp_als = real_cp_als
    return svc, [f.result() for f in futs], states, rec, dt


def _fleet_want(subjects) -> dict:
    """The serving counters of the PP fleet: 59 completed in 8 batches of
    8, 5 padded slots, one ``|pp`` signature."""
    batches = -(-len(subjects) // SERVE_BATCH)
    return {"completed": len(subjects), "batches": batches,
            "padded_slots": SERVE_BATCH * batches - len(subjects), "signatures": 1}


def _pp_phase(torch, args, dev, smi, x4, init, engine, subjects=None, serve_inits=None,
              serve_fits=None):
    """Phase 12 (see the module docstring).  ``engine`` maps each of auto,
    fused and matrix_free to ``(state, per-sweep fits)`` of phase 3's
    ``plan.cp_als`` from ``init``; ``subjects``, ``serve_inits`` and
    ``serve_fits`` are phase 6's fleet, inits and exact served fits (made
    here when the phase runs alone).  Returns the local PP references
    phase 13j holds the sharded runs to: 12b's sequence, fits, seconds,
    host-gate reads and last cache pairs, and 12d's fleet fits, sequence,
    counters and exact sweeps a batch."""
    from repro_torch import core
    from repro_torch.core.cpals import als_sweep as legacy_als_sweep
    from repro_torch.core.dimtree import dimtree_sweep
    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import ref
    from repro_torch.plan import (PP_EXACT_FRACTION, LocalExecutor, Problem, SweepState,
                                  TuningCache, als_sweep, cp_als, plan_sweep, tune)
    from repro_torch.plan import sweep as tsweep
    from repro_torch.serve import CPService

    rank, sweeps = args.rank, args.sweeps

    # ---- 12a: the legacy front door on the big tensor, from phase 3's init
    for method, kern in (("fused", fm.KERNEL), ("matrix_free", mf.KERNEL)):
        fits = []
        torch.cuda.synchronize()
        fm.KERNEL.launches = mf.KERNEL.launches = 0
        st = core.cp_als(x4, core.CPConfig(rank, n_iters=sweeps, tol=0.0, method=method),
                         init_factors=init, callback=lambda it, f, dt: fits.append(f))
        torch.cuda.synchronize()
        got = (fm.KERNEL.launches, mf.KERNEL.launches)
        want = (4 * sweeps, 0) if method == "fused" else (0, 4 * sweeps)
        est, efits = engine[method]
        same = (fits == efits and torch.equal(st.weights, est.weights)
                and all(torch.equal(u, v) for u, v in zip(st.factors, est.factors)))
        _log(f"[12] core.cp_als(CPConfig(method={method!r})): launches fused {got[0]} "
             f"matrix_free {got[1]} (want {want}); fits {fits}; bitwise equal to phase 3's "
             f"plan.cp_als: {'ok' if same else 'FAIL'}")
        if got != want or not same:
            raise SystemExit(f"legacy cp_als {method}: launch counts or bits differ")
    w, nx = torch.ones(rank, device=dev), tensor_norm(x4)
    legacy = {
        "fused": lambda: legacy_als_sweep(x4, init, w, nx, 0, "fused", True),
        "matrix_free": lambda: legacy_als_sweep(x4, init, w, nx, 0, "matrix_free", True),
        "dimtree": lambda: dimtree_sweep(x4, init, w, nx, 0),
    }
    for strategy, run in legacy.items():
        plan = plan_sweep(Problem.from_tensor(x4, rank), strategy,
                          schedule=None if strategy == "dimtree" else "flat")
        fm.KERNEL.launches = mf.KERNEL.launches = 0
        out = run()
        torch.cuda.synchronize()
        got = (fm.KERNEL.launches, mf.KERNEL.launches)
        st = als_sweep(plan.problem, plan, LocalExecutor(),
                       SweepState(x=x4, factors=init, weights=w, norm_x=nx, it=0))
        same = (torch.equal(out[1], st.weights) and torch.equal(out[2], st.fit)
                and all(torch.equal(u, v) for u, v in zip(out[0], st.factors)))
        want = {"fused": (4, 0), "matrix_free": (0, 4), "dimtree": (0, 0)}[strategy]
        _log(f"[12] legacy {'dimtree_sweep' if strategy == 'dimtree' else 'als_sweep'} "
             f"({strategy}, schedule {plan.resolved_schedule.name}): launches {got} (want {want}); "
             f"fit {float(out[2]):.7f}; bitwise equal to one engine sweep: "
             f"{'ok' if same else 'FAIL'}")
        if got != want or not same:
            raise SystemExit(f"legacy {strategy} sweep: launch counts or bits differ")

    # ---- 12b: PP on the big tensor, beside the exact auto run for the same sweeps
    exact_fits = []
    cp_als(x4, plan_sweep(Problem.from_tensor(x4, rank), "auto"), n_iters=PP_SWEEPS, tol=0.0,
           init_factors=init, callback=lambda it, f, dt: exact_fits.append(f))
    problem = Problem.from_tensor(x4, rank, pp_tol=PP_TOL)
    plan = plan_sweep(problem, "pp")
    _log(f"[12] PP plan (pp_tol {PP_TOL:g}): schedule {plan.resolved_schedule.name} nodes "
         f"{[np_.algorithm for np_ in plan.nodes]}; describe()['pp'] "
         f"{json.dumps(plan.describe()['pp'])}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.KERNEL.launches = mf.KERNEL.launches = 0
    st, rec, fits, secs = _pp_run(torch, x4, plan, init)
    peak = torch.cuda.max_memory_allocated() / 1e9
    local_pp = {"pattern": rec.pattern, "fits": list(fits), "secs": list(secs),
                "reads": list(rec.reads), "pairs": rec.last_pp.pp.pairs}
    got = (fm.KERNEL.launches, mf.KERNEL.launches)
    n_exact = sum(1 for s in rec.seq if s != "a")
    want = (_kernel_leaves(plan, "fused") * n_exact, _kernel_leaves(plan, "matrix_free") * n_exact)
    gap = max(abs(a - b) for a, b in zip(fits, exact_fits))
    by = {k: [1e3 * t for s, t in zip(rec.seq, secs) if s == k] for k in "EBa"}
    _log(f"[12] PP cp_als {tuple(x4.shape)} rank {rank}, {PP_SWEEPS} sweeps: sequence "
         f"{rec.pattern} (E exact, B exact + cache build, a approximate); pp_exact_sweeps "
         f"{st.pp_exact_sweeps}; exact fraction {st.pp_exact_sweeps / st.it:.3f} (planner assumes "
         f"{PP_EXACT_FRACTION}); host-gate reads {len(rec.reads)} (one a sweep) "
         f"{[round(v, 5) for v in rec.reads]}")
    _log(f"[12] PP fits {fits}; exact auto fits {exact_fits}; max |diff| {gap:.3e} "
         f"(bound {PP_FIT_AGREE:g})")
    _log(f"[12] PP per-sweep ms (host clock, one chunk a sweep, each ending in the host sync): "
         f"exact {by['E']} (median {_median(by['E']):.3f}), exact + build {by['B']}, "
         f"approximate {by['a']} (median {_median(by['a']):.3f}); peak memory {peak:.3f} GB; "
         f"launches fused {got[0]} matrix_free {got[1]} (want {want}); card {smi}")
    if st.it != PP_SWEEPS or st.pp_exact_sweeps != n_exact or len(rec.reads) != PP_SWEEPS:
        raise SystemExit("PP cp_als: wrong sweep count, exact-sweep count or host-gate reads")
    if "a" not in rec.seq or n_exact == 0:
        raise SystemExit(f"PP cp_als: sequence {rec.pattern} lacks an approximate or exact sweep")
    if got != want or not all(math.isfinite(f) for f in fits) or gap > PP_FIT_AGREE:
        raise SystemExit("PP cp_als: launch counts, non-finite fits or fits off the exact run")
    # the last approximate sweep's first-order MTTKRP against the exact one at its factors
    pp = rec.last_pp.pp
    fs = rec.last_pp.factors
    drift = tsweep._pp_drift(fs, pp.ref)
    worst = 0.0
    for n in range(4):
        approx = pp.base[n]
        for m in range(4):
            if m != n:
                du = fs[m] - pp.ref[m]
                approx = approx + (tsweep._pp_contract_second(pp.pairs[(n, m)], du) if n < m
                                   else tsweep._pp_contract_first(pp.pairs[(m, n)], du))
        exact = ref.fused_mttkrp_ref(x4, fs, n)
        rel = float((approx.double() - exact.double()).norm() / exact.double().norm())
        worst = max(worst, rel)
        _log(f"[12] last approximate sweep, mode {n}: first-order MTTKRP rel err {rel:.3e}")
    dmax = float(drift.max())
    _log(f"[12] first-order MTTKRP worst rel err {worst:.3e} against the largest drift "
         f"{dmax:.3e} (second order: must stay below it) {'ok' if worst < dmax else 'FAIL'}")
    if not worst < dmax:
        raise SystemExit("PP: the first-order MTTKRP is no closer than the drift (a sign or "
                         "index fault)")
    # the cache build alone: CUDA events and its own peak memory
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build = tsweep._pp_materialize(problem, LocalExecutor(), x4, list(init), 0)
    torch.cuda.synchronize()
    build_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    del build
    build_ms = _time_ms(torch, lambda: tsweep._pp_materialize(problem, LocalExecutor(), x4,
                                                              list(init), 0), 3)
    corr_state = SweepState(x=x4, factors=list(fs), weights=rec.last_pp.weights, norm_x=nx,
                            it=1, grams=rec.last_pp.grams, pp=pp)
    corr_ms = _time_ms(torch, lambda: tsweep._pp_sweep(problem, plan, corr_state), 10)
    bound_ms = 6 * x4.numel() * 4 / HBM_BW * 1e3
    _log(f"[12] PP cache build (6 pair einsums + 4 bases): {build_ms:.3f} ms (CUDA events, 3 "
         f"calls; bound {bound_ms:.3f} ms: 6 passes over the tensor); its peak memory above "
         f"the resident set {build_peak:.3f} GB; one correction-only sweep {corr_ms:.3f} ms "
         f"(CUDA events, 10 calls, no host read); card {smi}")

    # ---- 12c: tuned PP
    cache = TuningCache(None)
    t0 = time.perf_counter()
    entry = tune(x4, rank, factors=init, cache=cache, budget_ms=None, reps=3, pp_tol=PP_TOL)
    torch.cuda.synchronize()
    tuned = plan_sweep(problem, "autotune", tuning_cache=cache)
    d = tuned.describe()["pp"]
    _log(f"[12] tune(pp_tol={PP_TOL:g}) in {time.perf_counter() - t0:.1f} s: pp rows "
         f"{entry['pp']} (CUDA events, median of 3); autotune plan: schedule "
         f"{tuned.resolved_schedule.name} nodes {[np_.algorithm for np_ in tuned.nodes]}; "
         f"describe()['pp'] {json.dumps(d)}")
    _log(f"[12] autotune PP {'enabled' if tuned.pp else 'not enabled'}: amortized "
         f"{1e3 * d['amortized_sweep_s']:.3f} ms a sweep ({d['exact_fraction']} x (exact "
         f"{1e3 * d['exact_sweep_s']:.3f} + build {1e3 * d['build_s']:.3f}) + "
         f"{1 - d['exact_fraction']} x correction {1e3 * d['correction_sweep_s']:.3f}) "
         f"{'<' if tuned.pp else '>='} exact {1e3 * d['exact_sweep_s']:.3f} ms; card {smi}")
    if not (entry["pp"].get("build_s", 0) > 0 and entry["pp"].get("correct_sweep_s", 0) > 0):
        raise SystemExit(f"tune(pp_tol) wrote no positive PP rows: {entry['pp']}")
    if d["basis"] != "measured":
        raise SystemExit("autotune PP plan is not priced on the measured basis")

    # ---- 12d: the PP fleet
    if subjects is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        subjects = [x4[:, s].contiguous() for s in range(FMRI[1])]
        shape = tuple(subjects[0].shape)
        serve_inits = {(i, rank): [torch.randn((d_, rank), generator=gen, device=dev)
                                   for d_ in shape] for i in range(len(subjects))}
        svc = CPService(batch_size=SERVE_BATCH, n_iters=sweeps, tol=0.0, strategy="autotune",
                        tuning_cache=TuningCache(), device=dev)
        futs = [svc.submit(subjects[i], rank, init_factors=serve_inits[(i, rank)])
                for i in range(len(subjects))]
        svc.flush()
        serve_fits = [f.result().fit for f in futs]
    svc, res, states, rec, dt = _pp_fleet(torch, args, dev, subjects, serve_inits)
    stats = svc.stats()
    want_stats = _fleet_want(subjects)
    sigs = {r.signature for r in res}
    gapf = max(abs(r.fit - f) for r, f in zip(res, serve_fits))
    _log(f"[12] PP fleet CPService(batch_size={SERVE_BATCH}, n_iters={sweeps}, "
         f"pp_tol={PP_FLEET_TOL:g}, strategy='pp'): stats "
         f"{json.dumps({k: stats[k] for k in sorted(stats)})}; signature {sorted(sigs)}; "
         f"pp_exact_sweeps per batch {[s.pp_exact_sweeps for s in states]}, sequences "
         f"{[rec.pattern[i:i + sweeps] for i in range(0, len(rec.pattern), sweeps)]}, host-gate "
         f"reads {[round(v, 4) for v in rec.reads]}; fits vs phase 6's "
         f"exact fits: max |diff| {gapf:.3e}; {len(subjects) / dt:.2f} problems/s (host clock, "
         f"first flush, plan made in it); card {smi}")
    if {k: stats[k] for k in want_stats} != want_stats or len(sigs) != 1 or not all(
        "|pp" in s for s in sigs
    ):
        raise SystemExit(f"PP fleet: serving counters {stats} != {want_stats} or signature {sigs}")
    if len(states) != want_stats["batches"] or any(s.pp_exact_sweeps is None for s in states):
        raise SystemExit("PP fleet: a batch ran without the PP cache")
    if not all(math.isfinite(r.fit) and r.sweeps == sweeps for r in res):
        raise SystemExit("PP fleet: non-finite fit or wrong sweep count")
    local_pp["fleet"] = {"fits": [r.fit for r in res], "pattern": rec.pattern,
                         "exact": [s.pp_exact_sweeps for s in states]}

    # ---- 12e: a small PP run on the card against the port's CPU run
    g = torch.Generator().manual_seed(5)
    shape, srank = (12, 10, 8, 6), 3
    true = [torch.randn((d_, srank), generator=g) for d_ in shape]
    xs = torch.einsum("ac,bc,dc,ec->abde", *true)
    xs = (xs + 0.1 * xs.std() * torch.randn(xs.shape, generator=g)).contiguous()
    sinit = [torch.randn((d_, srank), generator=g) for d_ in shape]
    out = []
    for where in ("cpu", dev):
        sfits = []
        with _PPRecorder(tsweep) as r:
            cp_als(xs.to(where), plan_sweep(Problem(shape, srank, pp_tol=0.05), "pp"), n_iters=12,
                   tol=0.0, init_factors=[u.to(where) for u in sinit],
                   callback=lambda it, f, dt: sfits.append(f))
        out.append((r.pattern, sfits))
    (cpu_seq, cpu_fits), (card_seq, card_fits) = out
    dsmall = max(abs(a - b) for a, b in zip(cpu_fits, card_fits))
    _log(f"[12] small PP run {shape} rank {srank} pp_tol 0.05 (every gate value at least 1.4x "
         f"from it on the CPU): card sequence {card_seq}, CPU {cpu_seq}; fits max |diff| "
         f"{dsmall:.3e} (bound {SMALL_FIT_AGREE:g})")
    if cpu_seq != card_seq or dsmall > SMALL_FIT_AGREE:
        raise SystemExit("small PP run: card and CPU disagree")
    return local_pp


def _only_pp(torch, args, dev, smi) -> None:
    """``--only pp``: build the kernels, make the fMRI tensor and phase 3's
    init, run phase 3's three ``plan.cp_als`` runs for the bitwise
    comparison, then phase 12."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.plan import Problem, cp_als, plan_sweep

    _build.build_all([fm.KERNEL, mf.KERNEL, mt.KERNEL])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x4 = synth_fmri(torch, gen, args.rank, dev)
    init = [torch.randn((d, args.rank), generator=gen, device=dev) for d in FMRI]
    engine = {}
    for strategy in ("auto", "fused", "matrix_free"):
        fits = []
        st = cp_als(x4, plan_sweep(Problem.from_tensor(x4, args.rank), strategy),
                    n_iters=args.sweeps, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: fits.append(f))
        engine[strategy] = (st, fits)
    _pp_phase(torch, args, dev, smi, x4, init, engine)


# ---- phase 13: flat sharded CP-ALS over a torch.distributed DeviceMesh
# The reference's mode-parallel mapping (tests/dist_worker.py) on the fMRI
# tensor: time points on "data", the first region mode on "model".
DIST_AXES = {0: "data", 2: "model"}
DIST_TREE_SWEEPS = 3


def _slabs(plan, node, n_chunks: int) -> int:
    """The slabs a node's reduction is cut into under the overlapping
    executor: ``n_chunks`` capped by the local extent of the node's first
    kept mode (1 without a reduction or with ``n_chunks`` 1)."""
    if not node.reduce_axes or n_chunks <= 1:
        return 1
    return max(1, min(n_chunks, plan.problem.local_shape[node.lo]))


def _expected_gathers(plan, sweeps: int, batch_axes=(), n_chunks: int = 1) -> tuple[int, str]:
    """The collectives a sharded ``cp_als`` run of ``plan`` makes, derived
    from its schedule, and the derivation.  Set-up: the tensor norm, one
    gather a mapped mode's axis, and the Gram of each mapped mode.  A
    sweep: each node's reduction (one gather an axis of the mapped modes it
    contracts, a slab: ``n_chunks`` is the overlapping executor's), the
    column norms and the Gram of each mapped leaf mode, the fit's inner
    product when the last mode is mapped, and one gather a batch axis for
    the sweep's fits (one host read a sweep).  The compressed executor
    makes the same count: its int8 gather is one an axis too."""
    prob = plan.problem
    mapped = set(prob.mode_axes)
    nodes = sum(len(node.reduce_axes) * _slabs(plan, node, n_chunks)
                for node in plan.resolved_schedule.walk())
    algebra = (2 if plan.normalize else 1) * len(mapped) + (prob.ndim - 1 in mapped)
    setup = 2 * len(mapped)
    per_sweep = nodes + algebra + len(batch_axes)
    return setup + per_sweep * sweeps, (f"{setup} set-up + {sweeps} sweeps x ({nodes} node "
                                        f"reductions + {algebra} algebra + {len(batch_axes)} "
                                        f"fit gathers)")


def _bitwise(st, fits, ref) -> bool:
    """A ``cp_als`` state and its per-sweep fits bitwise equal to ``ref``'s."""
    rst, rfits = ref
    return (fits == rfits and st.weights.equal(rst.weights) and st.fit.equal(rst.fit)
            and all(u.equal(v) for u, v in zip(st.factors, rst.factors)))


def _dist_phase(torch, args, dev, smi, x4, init, engine, subjects, serve_inits=None,
                serve_fits=None, pp_ref=None) -> None:
    """Phase 13: an NCCL world of one on the card, the sharded paths at
    full width against the single-device engine (see the module
    docstring).  ``engine`` maps fused and matrix_free to ``(state,
    per-sweep fits)`` of phase 3's ``plan.cp_als`` from ``init``;
    ``subjects`` is the 59-subject fleet, ``serve_inits`` phase 6's
    per-request inits and ``serve_fits`` its served fits of the
    rank-``--rank`` requests, ``pp_ref`` phase 12's local PP references
    (the inits and references made here, and the fits not compared, when
    the phase runs alone)."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t0 = time.perf_counter()
    try:
        tdist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                 world_size=1)
        mesh = make_host_mesh(1, 1, device="cuda")
        probe = torch.ones(4, device=dev)
        tdist.all_gather([torch.empty_like(probe)], probe, group=mesh.get_group("data"))
        torch.cuda.synchronize()
    except Exception as e:  # no fallback: the phase fails
        shutil.rmtree(store, ignore_errors=True)
        raise SystemExit(f"[13] NCCL failed to start: {type(e).__name__}: {e}")
    _log(f"[13] NCCL world of 1 (backend {tdist.get_backend()}, NCCL "
         f"{'.'.join(map(str, torch.cuda.nccl.version()))}), mesh {mesh.mesh_dim_names} "
         f"{tuple(mesh.shape)}, first all_gather done in {time.perf_counter() - t0:.1f} s")
    if serve_inits is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
        shape = tuple(subjects[0].shape)
        serve_inits = {(i, r): [torch.randn((d, r), generator=gen, device=dev) for d in shape]
                       for r, n in ((args.rank, len(subjects)), (SECOND_RANK, SECOND_SUBJECTS))
                       for i in range(n)}
    try:
        secs = _dist_runs(torch, args, dev, smi, x4, init, engine, subjects, mesh)
        _dist_overlapping(torch, args, smi, x4, init, engine, mesh, secs)
        _dist_compressed(torch, args, smi, x4, init, engine, mesh, secs)
        _dist_auto_and_tune(torch, args, smi, x4, init, engine, mesh)
        _dist_serve(torch, args, dev, smi, subjects, serve_inits, serve_fits, mesh)
        _dist_levels(torch, args, smi, x4, init, engine)
        if pp_ref is None:
            pp_ref = _pp_local_refs(torch, args, dev, x4, init, subjects, serve_inits)
        _dist_pp(torch, args, dev, smi, x4, init, mesh, pp_ref, subjects, serve_inits)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _dist_runs(torch, args, dev, smi, x4, init, engine, subjects, mesh) -> None:
    from repro_torch.core.dimtree import dimtree_sweep
    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.dist import GATHERS, dist_cp_als, dist_dimtree_sweep
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import Problem, cp_als, make_executor, plan_sweep

    rank, sweeps = args.rank, args.sweeps
    kernels = {"matrix_free": (mf.KERNEL, fm.KERNEL), "fused": (fm.KERNEL, mf.KERNEL)}
    batched = {"matrix_free": (mf.BATCHED_KERNEL, fm.BATCHED_KERNEL),
               "fused": (fm.BATCHED_KERNEL, mf.BATCHED_KERNEL)}

    def counted(run, pair):
        """``run()`` with the kernel counters and the collective counter set
        to 0 just before; returns its result and (launches of the path's
        kernel, of the other, collectives)."""
        torch.cuda.synchronize()
        pair[0].launches = pair[1].launches = GATHERS.calls = 0
        out = run()
        torch.cuda.synchronize()
        return out, (pair[0].launches, pair[1].launches, GATHERS.calls)

    def local_secs(m):
        secs = []
        cp_als(x4, plan_sweep(Problem.from_tensor(x4, rank), m), n_iters=sweeps, tol=0.0,
               init_factors=init, callback=lambda it, f, dt: secs.append(dt))
        return secs

    # ---- 13a: mode-parallel, the fMRI tensor at full width
    out = {}
    for m in ("matrix_free", "fused"):
        before = local_secs(m)
        plan = plan_sweep(Problem.from_tensor(x4, rank, DIST_AXES, mesh), m, executor="sharded")
        want, how = _expected_gathers(plan, sweeps)
        fits, secs = [], []
        st, got = counted(lambda: cp_als(
            x4, plan, executor=make_executor("sharded", mesh, DIST_AXES), n_iters=sweeps,
            tol=0.0, init_factors=init,
            callback=lambda it, f, dt: (fits.append(f), secs.append(dt))), kernels[m])
        same = _bitwise(st, fits, engine[m])
        _log(f"[13] plan.cp_als sharded {m} {DIST_AXES}: schedule "
             f"{plan.resolved_schedule.name}; launches {got[0]} of its kernel (want "
             f"{4 * sweeps}), {got[1]} of the other; collectives {got[2]} (want {want}: {how}); "
             f"bitwise equal to phase 3's local run: {'ok' if same else 'FAIL'}")
        if not same or got[:2] != (4 * sweeps, 0) or got[2] != want:
            raise SystemExit(f"sharded plan.cp_als {m}: bits, launches or collectives differ")
        (blocks, w, fit), got = counted(lambda: dist_cp_als(
            x4, rank, DIST_AXES, mesh, n_iters=sweeps, tol=0.0, init_factors=init, method=m),
            kernels[m])
        est = engine[m][0]
        same = (w.equal(est.weights) and fit.equal(est.fit)
                and all(u.equal(v) for u, v in zip(blocks, est.factors)))
        _log(f"[13] dist_cp_als(method={m!r}): launches {got[0]} (want {4 * sweeps}), "
             f"{got[1]} of the other; collectives {got[2]} (want {want}); factors, weights "
             f"and fit bitwise equal to phase 3's: {'ok' if same else 'FAIL'}")
        if not same or got[:2] != (4 * sweeps, 0) or got[2] != want:
            raise SystemExit(f"dist_cp_als {m}: bits, launches or collectives differ")
        after = local_secs(m)
        _log(f"[13] {m} seconds a sweep (host clock, one sync a sweep): local {before} then "
             f"{after}; sharded {secs}; medians local {_median(before + after):.6f} sharded "
             f"{_median(secs):.6f}; card {smi}")
        out[m] = {"local": _median(before + after), "sharded": _median(secs)}
        _dist_trace(torch, args, x4, init, plan, mesh, m, smi)

    # ---- 13b: the dimension tree, sweep by sweep against the legacy sweep
    w0, nx = torch.ones(rank, device=x4.device), tensor_norm(x4)
    f_l, w_l, f_d, w_d = list(init), w0, list(init), w0
    for it in range(DIST_TREE_SWEEPS):
        f_l, w_l, fit_l = dimtree_sweep(x4, f_l, w_l, nx, it)
        GATHERS.calls = 0
        f_d, w_d, fit_d = dist_dimtree_sweep(x4, f_d, w_d, nx, it, DIST_AXES, mesh)
        torch.cuda.synchronize()
        same = (w_d.equal(w_l) and fit_d.equal(fit_l)
                and all(u.equal(v) for u, v in zip(f_d, f_l)))
        _log(f"[13] dist_dimtree_sweep {it}: fit {float(fit_d):.7f}, collectives "
             f"{GATHERS.calls}; bitwise equal to dimtree_sweep: {'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit("dist_dimtree_sweep differs from the legacy dimtree_sweep")

    # ---- 13c: batch-parallel, subjects 0-7 stacked
    xb = torch.stack(subjects[:SERVE_BATCH])
    gen = torch.Generator(device=x4.device).manual_seed(args.seed + 13)
    fb = [torch.randn((SERVE_BATCH, d, rank), generator=gen, device=x4.device)
          for d in xb.shape[1:]]
    for m in ("matrix_free", "fused"):
        lfits = []
        lst = cp_als(xb, plan_sweep(Problem.from_tensor(xb, rank, batch=SERVE_BATCH), m),
                     n_iters=sweeps, tol=0.0, init_factors=fb,
                     callback=lambda it, f, dt: lfits.append(f))
        plan = plan_sweep(Problem.from_tensor(xb, rank, {}, mesh, batch=SERVE_BATCH,
                                              batch_axes=("data",)), m, executor="sharded")
        want, how = _expected_gathers(plan, sweeps, ("data",))
        fits = []
        st, got = counted(lambda: cp_als(
            xb, plan, executor=make_executor("sharded", mesh, {}, batch_axes=("data",)),
            n_iters=sweeps, tol=0.0, init_factors=fb,
            callback=lambda it, f, dt: fits.append(f)), batched[m])
        same = _bitwise(st, fits, (lst, lfits))
        _log(f"[13] batch-parallel {m} ({tuple(xb.shape)}, batch on 'data', placement "
             f"{plan.describe()['placement']}): launches {got[0]} of its batched kernel (want "
             f"{3 * sweeps}), {got[1]} of the other; collectives {got[2]} (want {want}: {how}); "
             f"bitwise equal to the local batched engine: {'ok' if same else 'FAIL'}")
        if not same or got[:2] != (3 * sweeps, 0) or got[2] != want:
            raise SystemExit(f"batch-parallel {m}: bits, launches or collectives differ")
    return out


# The overlapping executor's slab count (repro_torch.plan.DEFAULT_OVERLAP_CHUNKS).
DIST_CHUNKS = 4
# A full MTTKRP cut into DIST_CHUNKS slabs against the unsplit kernel: each slab
# is its own launch with its own split of the outer sum, so the fp32 sums run
# in other orders (~1e-7 relative); an indexing fault between slabs is O(1).
LEAF_REL = 1e-5
# The compressed executor's fits against the exact run's: the reference's own
# compressed_cpals bound (tests/dist_worker.py).  An int8 step is 1/254 of a
# partial's largest entry a participant; error feedback keeps the accumulated
# error within one step, so the iterates track the exact ones to ~1e-3.
COMPRESSED_FIT_AGREE = 2e-2


def _overlap_counts(plan, sweeps: int, n_chunks: int) -> tuple[int, int]:
    """Kernel launches and slab copies of an overlapping run of a plan whose
    root leaves run a kernel: one launch a slab, and a copy of every slab of
    a mode past the first (a strided view of the block)."""
    launches = copies = 0
    for node in plan.resolved_schedule.walk():
        if node.from_root and node.is_leaf:
            k = _slabs(plan, node, n_chunks)
            launches += k
            copies += k if k > 1 and node.mode > 0 else 0
    return launches * sweeps, copies * sweeps


def _nccl_overlap(evs) -> tuple[int, int, float, float]:
    """Of a trace's device events: the NCCL operations, how many of them ran
    beside another device operation, their µs, and the µs of that overlap."""
    nccl = [(a, b) for a, b, name in evs if "nccl" in name.lower()]
    other = [(a, b) for a, b, name in evs if "nccl" not in name.lower()]
    beside, overlap = 0, 0.0
    for a, b in nccl:
        o = sum(max(0.0, min(b, d) - max(a, c)) for c, d in other)
        beside += o > 0
        overlap += o
    return len(nccl), beside, sum(b - a for a, b in nccl), overlap


def _dist_overlapping(torch, args, smi, x4, init, engine, mesh, secs) -> None:
    """13d: the overlapping executor on the fMRI tensor (see the module
    docstring)."""
    from repro_torch.dist import GATHERS, SLAB_COPIES
    from repro_torch.dist.dist_mttkrp import mttkrp_block, mttkrp_overlapped_block
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import Problem, cp_als, make_executor, plan_sweep

    rank, sweeps = args.rank, args.sweeps
    problem = Problem.from_tensor(x4, rank, DIST_AXES, mesh)
    ex = make_executor("overlapping", mesh, DIST_AXES, n_chunks=DIST_CHUNKS)
    for m, kernel in (("matrix_free", mf.KERNEL), ("fused", fm.KERNEL)):
        worst = 0.0
        for n in range(4):
            a = mttkrp_block(x4, init, n, DIST_AXES, mesh, method=m)
            b = mttkrp_overlapped_block(x4, init, n, DIST_AXES, mesh, method=m,
                                        n_chunks=DIST_CHUNKS)
            worst = max(worst, _rel(torch, b, a)[0])
        _log(f"[13] overlapping {m}: each leaf in {DIST_CHUNKS} slabs against the sharded "
             f"leaf: largest rel err {worst:.3e} (bound {LEAF_REL:g})")
        if not worst <= LEAF_REL:
            raise SystemExit(f"overlapping {m}: a slabbed leaf disagrees with the sharded leaf")
        plan = plan_sweep(problem, m, executor="overlapping", n_chunks=DIST_CHUNKS)
        want_l, want_c = _overlap_counts(plan, sweeps, DIST_CHUNKS)
        want_g, how = _expected_gathers(plan, sweeps, n_chunks=DIST_CHUNKS)
        fits, osecs = [], []
        torch.cuda.synchronize()
        kernel.launches = GATHERS.calls = SLAB_COPIES.calls = SLAB_COPIES.bytes = 0
        st = cp_als(x4, plan, executor=ex, n_iters=sweeps, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: (fits.append(f), osecs.append(dt)))
        torch.cuda.synchronize()
        got = (kernel.launches, GATHERS.calls, SLAB_COPIES.calls, SLAB_COPIES.bytes)
        gap = max(abs(a - b) for a, b in zip(fits, engine[m][1]))
        finite = all(math.isfinite(f) for f in fits) and all(
            bool(torch.isfinite(u).all()) for u in st.factors)
        _log(f"[13] overlapping {m} (n_chunks {DIST_CHUNKS}): fits {fits}; against phase 3's "
             f"max |diff| {gap:.3e} (bound {FIT_AGREE:g}); launches {got[0]} (want {want_l}: "
             f"{want_l // sweeps} a sweep); collectives {got[1]} (want {want_g}: {how}); slab "
             f"copies {got[2]} (want {want_c}), {got[3] / sweeps / 1e9:.3f} GB copied a sweep")
        if not finite or gap > FIT_AGREE or got[:3] != (want_l, want_g, want_c):
            raise SystemExit(f"overlapping {m}: fits, launches, collectives or copies differ")
        _log(f"[13] {m} seconds a sweep (host clock, medians): overlapping "
             f"{_median(osecs):.6f} ({osecs}), sharded {secs[m]['sharded']:.6f}, local "
             f"{secs[m]['local']:.6f}; card {smi}")
        wall, evs = _trace(torch, lambda: cp_als(x4, plan, executor=ex, n_iters=1, tol=0.0,
                                                 init_factors=init))
        _log_trace(f"[13] trace of one overlapping {m} sweep with its set-up", wall, evs, 1, smi)
        count, beside, nccl_us, overlap_us = _nccl_overlap(evs)
        _log(f"[13] overlapping {m}: {count} NCCL operations ({nccl_us:.1f} us), {beside} of "
             f"them beside another device operation ({overlap_us:.1f} us of overlap); card {smi}")
    # tree schedules: partials bitwise the sharded executor's; the chain's
    # root leaf is cut into slabs, so its run holds at the fits' bound
    for name, strategy, schedule in (("binary", "dimtree", None), ("chain", "1step", "chain")):
        runs = {}
        for kind in ("sharded", "overlapping"):
            plan = plan_sweep(problem, strategy, executor=kind, schedule=schedule,
                              n_chunks=DIST_CHUNKS)
            fits = []
            GATHERS.calls = 0
            st = cp_als(x4, plan, executor=make_executor(kind, mesh, DIST_AXES,
                                                          n_chunks=DIST_CHUNKS),
                        n_iters=DIST_TREE_SWEEPS, tol=0.0, init_factors=init,
                        callback=lambda it, f, dt: fits.append(f))
            torch.cuda.synchronize()
            want, _ = _expected_gathers(plan, DIST_TREE_SWEEPS,
                                        n_chunks=DIST_CHUNKS if kind == "overlapping" else 1)
            runs[kind] = (st, fits, GATHERS.calls, want, plan.resolved_schedule.name)
        (sst, sfits, *_), (ost, ofits, calls, want, sched) = runs["sharded"], runs["overlapping"]
        same = _bitwise(ost, ofits, (sst, sfits))
        gap = max(abs(a - b) for a, b in zip(ofits, sfits))
        _log(f"[13] overlapping {sched}: {DIST_TREE_SWEEPS} sweeps bitwise equal to the sharded "
             f"executor's: {'yes' if same else 'no'} (fits max |diff| {gap:.3e}); collectives "
             f"{calls} (want {want})")
        if calls != want or gap > FIT_AGREE or (name == "binary" and not same):
            raise SystemExit(f"overlapping {sched}: bits, fits or collectives differ")


def _dist_compressed(torch, args, smi, x4, init, engine, mesh, secs) -> None:
    """13e: the compressed executor on the fMRI tensor (see the module
    docstring)."""
    from repro_torch.dist import GATHERS, INT8_GATHERS
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import CompressedShardedExecutor, Problem, cp_als, plan_sweep

    class Probe(CompressedShardedExecutor):
        """Counts the node contractions that hand back a changed residual."""

        updates = 0

        def contract_carry(self, node, src, factors, algorithm, carry, tiles=None,
                           collective="flat"):
            out, new = super().contract_carry(node, src, factors, algorithm, carry,
                                              tiles=tiles, collective=collective)
            if carry is not None and node.id in carry:
                self.updates += not torch.equal(new[node.id], carry[node.id])
            return out, new

    rank, sweeps = args.rank, args.sweeps
    problem = Problem.from_tensor(x4, rank, DIST_AXES, mesh)
    for m, kernel in (("matrix_free", mf.KERNEL), ("fused", fm.KERNEL)):
        plan = plan_sweep(problem, m, executor="compressed")
        ex = Probe(mesh, DIST_AXES)
        reducing = [node for node in plan.resolved_schedule.walk() if node.reduce_axes]
        want_i = sum(len(node.reduce_axes) for node in reducing) * sweeps
        want_g, how = _expected_gathers(plan, sweeps)
        fits, csecs = [], []
        torch.cuda.synchronize()
        kernel.launches = GATHERS.calls = INT8_GATHERS.calls = INT8_GATHERS.bytes = 0
        st = cp_als(x4, plan, executor=ex, n_iters=sweeps, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: (fits.append(f), csecs.append(dt)))
        torch.cuda.synchronize()
        got = (kernel.launches, GATHERS.calls, INT8_GATHERS.calls, ex.updates)
        want = (4 * sweeps, want_g, want_i, len(reducing) * sweeps)
        gap = max(abs(a - b) for a, b in zip(fits, engine[m][1]))
        finite = all(math.isfinite(f) for f in fits) and all(
            bool(torch.isfinite(u).all()) for u in st.factors)
        _log(f"[13] compressed {m}: fits {fits}; against phase 3's max |diff| {gap:.3e} (bound "
             f"{COMPRESSED_FIT_AGREE:g}); launches {got[0]} (want {want[0]}); collectives "
             f"{got[1]} (want {want_g}: {how}); int8 gathers {got[2]} (want {want_i}: "
             f"{want_i // sweeps} a sweep, {INT8_GATHERS.bytes / sweeps:.0f} B sent a sweep); "
             f"residuals changed {got[3]} times (want {want[3]}: {len(reducing)} nodes every "
             f"sweep)")
        if not finite or gap > COMPRESSED_FIT_AGREE or got != want:
            raise SystemExit(f"compressed {m}: fits, launches, gathers or carry differ")
        _log(f"[13] {m} seconds a sweep (host clock, medians): compressed "
             f"{_median(csecs):.6f} ({csecs}), sharded {secs[m]['sharded']:.6f}, local "
             f"{secs[m]['local']:.6f}; card {smi}")


def _dist_auto_and_tune(torch, args, smi, x4, init, engine, mesh) -> None:
    """13f-g: the executor argmin under the H100 constants, then the
    sharded tuner and its ``autotune`` plan (see the module docstring)."""
    from repro_torch.plan import (Problem, TuningCache, cp_als, make_executor, plan_sweep,
                                  select_executor, tune)

    rank, sweeps = args.rank, args.sweeps
    problem = Problem.from_tensor(x4, rank, DIST_AXES, mesh)
    for strategy in ("auto", "matrix_free", "fused"):
        plan = plan_sweep(problem, strategy)
        totals = {k: plan_sweep(problem, strategy, executor=k).total_cost()["predicted_s"]
                  for k in ("sharded", "overlapping", "compressed")}
        _log(f"[13] executor='auto' under the H100 constants, strategy {strategy}: "
             f"select_executor -> {select_executor(problem, strategy)}; plan {plan.executor} on "
             f"{plan.resolved_schedule.name}; predicted s a sweep by kind {totals}")
    cache = TuningCache()
    t0 = time.perf_counter()
    entry = tune(x4, rank, mesh=mesh, mode_axes=DIST_AXES, cache=cache)
    _log(f"[13] tune(mesh=, mode_axes={DIST_AXES}) in {time.perf_counter() - t0:.2f} s (budget "
         f"{entry['budget_ms']} ms, elapsed_ms {entry['elapsed_ms']:.1f}): "
         f"{len(entry['nodes'])} node rows; card {smi}")
    for kind in ("sharded", "overlapping", "compressed"):
        rows = [r for r in entry["nodes"] if r["executor"] == kind]
        _log(f"[13] tune rows {kind} ({len(rows)}): "
             + ", ".join(f"{r['key'].split('|', 1)[1]} {1e3 * r['measured_s']:.3f} ms"
                         for r in rows))
    _log(f"[13] tune serial_fractions {entry['serial_fractions']}")
    plan = plan_sweep(problem, "autotune", tuning_cache=cache)
    bound = COMPRESSED_FIT_AGREE if plan.executor == "compressed" else FIT_AGREE
    fits = []
    st = cp_als(x4, plan, executor=make_executor(plan.executor, mesh, DIST_AXES), n_iters=sweeps,
                tol=0.0, init_factors=init, callback=lambda it, f, dt: fits.append(f))
    torch.cuda.synchronize()
    gap = max(abs(a - b) for a, b in zip(fits, engine["matrix_free"][1]))
    _log(f"[13] autotune plan: executor {plan.executor}, schedule {plan.resolved_schedule.name}, "
         f"nodes {[np_.algorithm for np_ in plan.nodes]}, serial_fractions "
         f"{plan.describe()['serial_fractions']}; fits {fits}; against phase 3's max |diff| "
         f"{gap:.3e} (bound {bound:g})")
    if not all(math.isfinite(f) for f in fits) or gap > bound or st.it != sweeps:
        raise SystemExit("the tuned sharded plan's fits disagree with phase 3's")


def _dist_serve(torch, args, dev, smi, subjects, serve_inits, serve_fits, mesh) -> None:
    """13h: the fleet served batch-parallel through ``CPService(mesh=)``
    beside the single-device service (see the module docstring)."""
    from repro_torch.dist import GATHERS
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import TuningCache
    from repro_torch.serve import CPService

    rank, sweeps = args.rank, args.sweeps
    requests = [(i, rank) for i in range(len(subjects))]
    requests += [(i, SECOND_RANK) for i in range(SECOND_SUBJECTS)]
    batches = -(-len(subjects) // SERVE_BATCH) + 1
    want_stats = {"completed": len(requests), "signatures": 2, "compiles": 2,
                  "batches": batches, "padded_slots": SERVE_BATCH * (batches - 1) - len(subjects)}
    for m, kernel in (("matrix_free", mf.BATCHED_KERNEL), ("fused", fm.BATCHED_KERNEL)):
        fits = {}
        for label, where in (("single-device", None), ("mesh", mesh)):
            svc = CPService(batch_size=SERVE_BATCH, n_iters=sweeps, tol=0.0, strategy=m,
                            tuning_cache=TuningCache(), mesh=where, device=dev)
            futs = [svc.submit(subjects[i], r, init_factors=serve_inits[(i, r)])
                    for i, r in requests]
            torch.cuda.synchronize()
            kernel.launches = GATHERS.calls = 0
            t0 = time.perf_counter()
            svc.flush()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            stats = {k: svc.stats()[k] for k in want_stats}
            res = [f.result() for f in futs]
            fits[label] = [r.fit for r in res]
            kinds = sorted({st.plan.executor for st in svc._states.values()})
            _log(f"[13] CPService({label}) {m}: executors {kinds}; stats {stats}; launches of "
                 f"its batched kernel {kernel.launches} (want {3 * sweeps * batches}); "
                 f"collectives {GATHERS.calls}; {len(requests) / dt:.2f} problems/s (host clock, "
                 f"first flush, plans made in it); card {smi}")
            if stats != want_stats or kernel.launches != 3 * sweeps * batches or not all(
                    math.isfinite(r.fit) and r.sweeps == sweeps for r in res):
                raise SystemExit(f"CPService({label}) {m}: counters, launches or results differ")
        gap = max(abs(a - b) for a, b in zip(fits["mesh"], fits["single-device"]))
        gap6 = (max(abs(a - b) for a, b in zip(fits["mesh"], serve_fits))
                if serve_fits is not None else 0.0)
        _log(f"[13] CPService(mesh=) {m} against the single-device service: fits max |diff| "
             f"{gap:.3e} (bitwise: {'yes' if fits['mesh'] == fits['single-device'] else 'no'}); "
             f"against phase 6's served fits: "
             f"{f'{gap6:.3e}' if serve_fits is not None else 'not run'} (bound {FIT_AGREE:g})")
        if gap > FIT_AGREE or gap6 > FIT_AGREE:
            raise SystemExit(f"CPService(mesh=) {m}: served fits disagree")


# 13i: the reference's two-level mapping on a node mesh of one node of one device
NODE_AXES = {0: "node", 2: "device"}


def _dist_levels(torch, args, smi, x4, init, engine) -> None:
    """13i: the two-level path on ``make_node_mesh(1, 1)`` (see the module
    docstring): one node is no level to split, so every node plans flat and
    the sweeps are bitwise phase 3's (as 13a's are), with no
    reduce-scatter; the collectives called alone are the identity."""
    from repro_torch.core.mttkrp import mttkrp
    from repro_torch.dist import (GATHERS, SCATTERS, all_gather, hierarchical_psum,
                                  reduce_scatter)
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.launch.mesh import make_node_mesh
    from repro_torch.plan import Problem, TuningCache, cp_als, make_executor, plan_sweep, tune

    rank, sweeps = args.rank, args.sweeps
    mesh = make_node_mesh(1, 1, device="cuda")
    problem = Problem.from_tensor(x4, rank, NODE_AXES, mesh, intra_axes=("device",))
    kernels = {"matrix_free": (mf.KERNEL, fm.KERNEL), "fused": (fm.KERNEL, mf.KERNEL)}
    for m in ("matrix_free", "fused"):
        plan = plan_sweep(problem, m, executor="sharded")
        d = plan.describe()
        colls = [n["collective"] for n in d["nodes"]]
        hier = sum(c == "hierarchical" for c in colls)
        ex = make_executor(plan.executor, mesh, plan.problem.mode_axes,
                           node_axis=plan.problem.node_axis)
        want, how = _expected_gathers(plan, sweeps)
        fits = []
        torch.cuda.synchronize()
        kernels[m][0].launches = kernels[m][1].launches = GATHERS.calls = SCATTERS.calls = 0
        st = cp_als(x4, plan, executor=ex, n_iters=sweeps, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: fits.append(f))
        torch.cuda.synchronize()
        got = (kernels[m][0].launches, kernels[m][1].launches, GATHERS.calls, SCATTERS.calls)
        same = _bitwise(st, fits, engine[m])
        _log(f"[13i] two-level {m} on make_node_mesh(1, 1) {NODE_AXES}, intra_axes ('device',): "
             f"plan mapping {plan.problem.mode_axes}, collectives {colls}, lower_bound_bytes "
             f"{d['lower_bound_bytes']}, certified {d['certified']}, {len(d['mappings'])} mapping "
             f"rows; launches {got[0]} (want {4 * sweeps}), {got[1]} of the other; collectives "
             f"{got[2]} (want {want}: {how}); reduce-scatters {got[3]} (want {hier} hierarchical "
             f"nodes x {sweeps}); bitwise equal to phase 3's local run (13a's): "
             f"{'ok' if same else 'FAIL'}")
        if hier or d["lower_bound_bytes"] is not None or d["certified"] or colls != ["flat"] * 4:
            raise SystemExit(f"13i {m}: a node of one node planned other than flat, or certified")
        if not same or got != (4 * sweeps, 0, want, 0):
            raise SystemExit(f"13i {m}: bits, launches or collectives differ")
    # the collectives alone on the one-rank group: the identity, bitwise
    t = mttkrp(x4, init, 1)
    SCATTERS.calls = SCATTERS.bytes = GATHERS.calls = 0
    rs = reduce_scatter(t, "device", mesh)
    ag = all_gather(rs, "device", mesh)
    hp = hierarchical_psum(t, ("node", "device"), mesh, node_axis="device")
    torch.cuda.synchronize()
    counts = (SCATTERS.calls, SCATTERS.bytes, GATHERS.calls)
    same = torch.equal(rs, t) and torch.equal(ag, t) and torch.equal(hp, t)
    _log(f"[13i] reduce_scatter, all_gather and hierarchical_psum of the mode-1 MTTKRP "
         f"{tuple(t.shape)} on the one-rank group: identity bitwise {'ok' if same else 'FAIL'}; "
         f"reduce-scatters {counts[0]} (want 1: the size-1 node axis makes hierarchical_psum "
         f"the flat sum), bytes sent {counts[1]} (want 0), gathers {counts[2]} (want 3)")
    if not same or counts != (1, 0, 3):
        raise SystemExit("13i: the collectives of a group of one are not the identity")
    cache = TuningCache()
    t0 = time.perf_counter()
    entry = tune(x4, rank, mesh=mesh, mode_axes=NODE_AXES, intra_axes=("device",), cache=cache)
    colls = sorted({r["collective"] for r in entry["nodes"]})
    _log(f"[13i] tune(mesh=, intra_axes=('device',)) in {time.perf_counter() - t0:.2f} s "
         f"(elapsed_ms {entry['elapsed_ms']:.1f}): {len(entry['nodes'])} node rows, collectives "
         f"{colls}; key {cache.keys()}; card {smi}")
    if not entry["nodes"] or colls != ["flat"] or not cache.keys()[0].endswith("|node1"):
        raise SystemExit("13i: the two-level tune stored no rows or the wrong key")


def _pp_local_refs(torch, args, dev, x4, init, subjects, serve_inits) -> dict:
    """Phase 12's local PP references when phase 13 runs alone: 12b's run
    and 12d's fleet, without their logs and gates."""
    from repro_torch.plan import Problem, plan_sweep

    st, rec, fits, secs = _pp_run(torch, x4, plan_sweep(
        Problem.from_tensor(x4, args.rank, pp_tol=PP_TOL), "pp"), init)
    ref = {"pattern": rec.pattern, "fits": fits, "secs": secs, "reads": list(rec.reads),
           "pairs": rec.last_pp.pp.pairs}
    _, res, states, frec, _ = _pp_fleet(torch, args, dev, subjects, serve_inits)
    ref["fleet"] = {"fits": [r.fit for r in res], "pattern": frec.pattern,
                    "exact": [s.pp_exact_sweeps for s in states]}
    return ref


def _dist_pp(torch, args, dev, smi, x4, init, mesh, pp_ref, subjects, serve_inits) -> None:
    """13j: sharded pairwise perturbation in the NCCL world of one (see the
    module docstring), against phase 12's local runs ``pp_ref``."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import LocalExecutor, Problem, make_executor, plan_sweep
    from repro_torch.plan import sweep as tsweep

    rank = args.rank
    local_plan = plan_sweep(Problem.from_tensor(x4, rank, pp_tol=PP_TOL), "pp")
    problem = Problem.from_tensor(x4, rank, DIST_AXES, mesh, pp_tol=PP_TOL)
    plan = plan_sweep(problem, "pp", executor="sharded")
    ex = make_executor(plan.executor, mesh, plan.problem.mode_axes)
    xs, fs = ex.prepare(plan.problem, x4, init)
    pairs = ex.pp_pairs(plan.problem, xs, fs)
    local = LocalExecutor().pp_pairs(local_plan.problem, x4, init)
    same_pairs = all(torch.equal(pairs[k], local[k]) for k in local)
    del pairs, local
    nodes, lnodes = [np_.algorithm for np_ in plan.nodes], [np_.algorithm for np_ in local_plan.nodes]
    torch.cuda.synchronize()
    fm.KERNEL.launches = mf.KERNEL.launches = 0
    st, rec, fits, secs = _pp_run(torch, x4, plan, init, ex)
    n_exact = sum(1 for s in rec.seq if s != "a")
    got = (fm.KERNEL.launches, mf.KERNEL.launches)
    want = (_kernel_leaves(plan, "fused") * n_exact, _kernel_leaves(plan, "matrix_free") * n_exact)
    same = (rec.pattern == pp_ref["pattern"] and fits == pp_ref["fits"]
            and rec.reads == pp_ref["reads"]
            and all(torch.equal(rec.last_pp.pp.pairs[k], v) for k, v in pp_ref["pairs"].items()))
    _log(f"[13j] sharded PP {DIST_AXES} (pp_tol {PP_TOL:g}, {PP_SWEEPS} sweeps): plan "
         f"{plan.executor} nodes {nodes} (local {lnodes}); pairs at the init bitwise the local "
         f"executor's: {'ok' if same_pairs else 'FAIL'}; sequence {rec.pattern} (phase 12 "
         f"{pp_ref['pattern']}); pp_exact_sweeps {st.pp_exact_sweeps}; launches fused {got[0]} "
         f"matrix_free {got[1]} (want {want}); fits, host-gate reads and the last cache's pairs "
         f"bitwise phase 12's: {'ok' if same else 'FAIL'}")
    if not same_pairs or not same or nodes != lnodes or got != want:
        raise SystemExit("13j: sharded PP differs from phase 12's local PP")
    by = {k: [1e3 * t for s, t in zip(rec.seq, secs) if s == k] for k in "EBa"}
    lby = {k: [1e3 * t for s, t in zip(pp_ref["pattern"], pp_ref["secs"]) if s == k]
           for k in "EBa"}
    _log(f"[13j] per-sweep ms (host clock, one chunk a sweep, each ending in the host sync): "
         f"sharded exact {by['E']} (median {_median(by['E']):.3f}) against local "
         f"{_median(lby['E']):.3f}; exact + build {by['B']} against {lby['B']}; approximate "
         f"{by['a']} (median {_median(by['a']):.3f}) against local {_median(lby['a']):.3f}; "
         f"card {smi}")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build = tsweep._pp_materialize(plan.problem, ex, xs, fs, 0)
    torch.cuda.synchronize()
    build_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    del build
    build_ms = _time_ms(torch, lambda: tsweep._pp_materialize(plan.problem, ex, xs, fs, 0), 3)
    _log(f"[13j] sharded PP cache build: {build_ms:.3f} ms (CUDA events, 3 calls), its peak "
         f"memory above the resident set {build_peak:.3f} GB; card {smi}")
    # the PP fleet through CPService(mesh=): batch-parallel, bitwise phase 12d's
    svc, res, states, frec, dt = _pp_fleet(torch, args, dev, subjects, serve_inits, mesh)
    stats = {k: svc.stats()[k] for k in _fleet_want(subjects)}
    fleet = pp_ref["fleet"]
    same = ([r.fit for r in res] == fleet["fits"] and frec.pattern == fleet["pattern"]
            and [s.pp_exact_sweeps for s in states] == fleet["exact"])
    kinds = sorted({s.plan.executor for s in svc._states.values()})
    _log(f"[13j] CPService(mesh=, pp_tol={PP_FLEET_TOL:g}, strategy='pp'): executors {kinds}; "
         f"stats {stats} (want {_fleet_want(subjects)}); pp_exact_sweeps per batch "
         f"{[s.pp_exact_sweeps for s in states]}; fits, sequences and exact sweeps bitwise "
         f"the single-device PP fleet's (phase 12d): {'ok' if same else 'FAIL'}; "
         f"{len(subjects) / dt:.2f} problems/s (host clock, first flush, plan made in it); "
         f"card {smi}")
    if not same or stats != _fleet_want(subjects) or kinds != ["sharded"]:
        raise SystemExit("13j: the sharded PP fleet differs from the single-device one")


def _dist_trace(torch, args, x4, init, plan, mesh, m, smi) -> None:
    """A ``torch.profiler`` trace of one sharded sweep (its set-up
    included): the device's busy share and the share of NCCL's operations
    (kernels named ``nccl*``) and of device-to-device copies in it."""
    from repro_torch.plan import cp_als, make_executor

    wall, evs = _trace(torch, lambda: cp_als(
        x4, plan, executor=make_executor("sharded", mesh, DIST_AXES), n_iters=1, tol=0.0,
        init_factors=init))
    _log_trace(f"[13] trace of one sharded {m} sweep with its set-up", wall, evs, 1, smi)
    busy = sum(b - a for a, b, _ in evs)
    nccl = sum(b - a for a, b, name in evs if "nccl" in name.lower())
    copies = sum(b - a for a, b, name in evs if name.startswith("Memcpy"))
    _log(f"[13] {m}: NCCL operations {nccl:.1f} us, device copies {copies:.1f} us of "
         f"{busy:.1f} us of device operations ({100 * nccl / max(busy, 1e-9):.2f}% NCCL); "
         f"card {smi}")


def _only_dist(torch, args, dev, smi) -> None:
    """``--only dist``: build the MTTKRP kernels (and multi-TTV, which
    ``tune()`` builds), make the fMRI tensor and an init, run phase 3's
    fused and matrix_free ``plan.cp_als`` for the bitwise comparison, then
    phase 13 (the fleet, its inits and phase 12's local PP references made
    for it)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.plan import Problem, cp_als, plan_sweep

    # tune() also builds multi_ttv.cu: all three sources in parallel, here
    _build.build_all([fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL, mt.KERNEL])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x4 = synth_fmri(torch, gen, args.rank, dev)
    init = [torch.randn((d, args.rank), generator=gen, device=dev) for d in FMRI]
    engine = {}
    for strategy in ("fused", "matrix_free"):
        fits = []
        st = cp_als(x4, plan_sweep(Problem.from_tensor(x4, args.rank), strategy),
                    n_iters=args.sweeps, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: fits.append(f))
        engine[strategy] = (st, fits)
    subjects = [x4[:, s].contiguous() for s in range(FMRI[1])]
    _dist_phase(torch, args, dev, smi, x4, init, engine, subjects)


# ---- phase 21: the MTTKRP kernels above rank 64 (column blocks)
# Ranks of the phase: 80, two column blocks of 40 padded to 48; 128, two
# of 64 (matrix_free.column_blocks).
HIGH_RANKS = (80, 128)
BLOCK_RANK_TIMED = 64  # one column block of the widest width, timed beside them
HIGH_RANK_SWEEPS = 3
HIGH_RANK_SHARDED = 80


def _slab_spec(spec: str) -> str:
    """An einsum spec with a leading slab axis ``s`` on every operand."""
    return "s" + spec.replace(",", ",s").replace("->", "->s")


def _high_rank_rows(torch, x4, fs, xb, fb, smi, rank, err, krp_only=False):
    """Rows 1-7 at ``rank`` on the fMRI tensor (rows 1, 2, 5, 7) and the
    fleet batch (rows 3, 4, 6): every call within ``REL_ERR_BOUND`` of its
    plain version and bitwise repeatable, one counted launch a call, the
    CUDA kernels a call its design states (a CUDA graph of one call), and
    its CUDA-event time beside the bound, the plain version and one
    ``torch.einsum``.  Row 7 first, and alone with ``krp_only`` (``x4``,
    ``xb`` and ``fb`` unused).  Returns each row's sums over its calls."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.kernels import ops

    def row(key, label, kernel, run, plain, library, byts, flops, want_kernels, reps):
        out = run()
        before = kernel.launches
        again = run()
        launched = kernel.launches - before
        rel, mabs = _rel(torch, out, plain())
        err[key] = max(err.get(key, 0.0), mabs)
        ops_, kern = _graph_ops(torch, run)
        r = {"ms": _time_ms(torch, run, reps), "plain_ms": _time_ms(torch, plain, 2),
             "library_ms": _time_ms(torch, library, 2), "bytes_ms": byts / HBM_BW * 1e3,
             "flops_ms": flops / PEAK_FLOPS * 1e3}
        bound = max(r["bytes_ms"], r["flops_ms"])
        ok = (math.isfinite(rel) and rel <= REL_ERR_BOUND and torch.equal(out, again)
              and launched == 1 and ops_ == kern == want_kernels)
        _log(f"[21] {label} rank {rank}: rel err {rel:.3e} max abs {mabs:.3e} (bound "
             f"{REL_ERR_BOUND:g}), run twice bitwise {torch.equal(out, again)}, launches "
             f"{launched} a call, {kern} CUDA kernels a call (want "
             f"{want_kernels}); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, einsum "
             f"{r['library_ms']:.4f} ms, bound {bound:.4f} ms ("
             f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}); card {smi} "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[21] {label} rank {rank}: wrong, not repeatable or wrong launches")
        return r

    rows = {"krp": [_krp_row(torch, row, fs, smi, 21, 50)]}
    if krp_only:
        return _row_sums(rows, err)
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, fs, n)
        g = fm.launch_geometry(tuple(t.shape), pos, rank)
        rows.setdefault("fused", []).append(row(
            "fused", f"fused_mttkrp_bilinear mode {n} pos {pos}{_fused_geometry(t, pos, rank)}",
            fm.KERNEL, lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos),
            lambda: fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos),
            lambda: torch.einsum(_BILINEAR[pos], t, a, b),
            4 * (t.numel() + a.numel() + b.numel() + t.shape[pos] * rank),
            2 * t.numel() * rank, 1 if g.groups == 1 else 2, 5))
        del t, a, b
        us = [fs[k] for k in range(4) if k != n]
        g = mf.unbatched_launch_shape(FMRI, n, rank)
        rows.setdefault("mf", []).append(row(
            "mf", f"matrix_free_kernel mode {n}{_row2_geometry(x4, n, rank)}", mf.KERNEL,
            lambda: mf.matrix_free_kernel(x4, us, n),
            lambda: mf.matrix_free_kernel_plain(x4, us, n),
            lambda: torch.einsum(_einsum_spec(4, n), x4, *us),
            4 * (x4.numel() + sum(u.numel() for u in us) + FMRI[n] * rank),
            2 * x4.numel() * rank, 1 if g.groups == 1 else 2, 5))
        torch.cuda.empty_cache()
    for n in range(3):
        t, a, b, pos = ops.bilinear_operands_batched(xb, fb, n)
        rows.setdefault("fused_b", []).append(row(
            "fused_b", f"fused_mttkrp_bilinear_batched S={len(xb)} mode {n} pos {pos}",
            fm.BATCHED_KERNEL, lambda: fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos),
            lambda: fm.fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos),
            lambda: torch.einsum(_slab_spec(_BILINEAR[pos]), t, a, b),
            4 * (t.numel() + a.numel() + b.numel() + len(xb) * t.shape[1 + pos] * rank),
            2 * t.numel() * rank, 1, 10))
        us = [fb[k] for k in range(3) if k != n]
        spec = _slab_spec(_einsum_spec(3, n))
        rows.setdefault("mf_b", []).append(row(
            "mf_b", f"matrix_free_batched_kernel S={len(xb)} mode {n}", mf.BATCHED_KERNEL,
            lambda: mf.matrix_free_batched_kernel(xb, us, n),
            lambda: mf.matrix_free_batched_kernel_plain(xb, us, n),
            lambda: torch.einsum(spec, xb, *us),
            4 * (xb.numel() + sum(u.numel() for u in us) + len(xb) * xb.shape[1 + n] * rank),
            2 * xb.numel() * rank, 1, 10))
    for n in (1, 2):  # the 2-step path's second steps
        t, w = ops.multi_ttv_operands(x4, fs, n)
        rows.setdefault("mt", []).append(row(
            "mt", f"multi_ttv mode {n} T{tuple(t.shape)}", mt.KERNEL, lambda: mt.multi_ttv(t, w),
            lambda: mt.multi_ttv_plain(t, w), lambda: torch.einsum("lic,lc->ic", t, w),
            4 * (t.numel() + w.numel() + t.shape[1] * rank), 2 * t.numel(), 1, 50))
    pairs = [ops.multi_ttv_operands(xb[s], [f[s] for f in fb], 1) for s in range(len(xb))]
    tb, wb = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    del pairs
    rows["mt_b"] = [row(
        "mt_b", f"multi_ttv_batched T{tuple(tb.shape)}", mt.BATCHED_KERNEL,
        lambda: mt.multi_ttv_batched(tb, wb), lambda: mt.multi_ttv_batched_plain(tb, wb),
        lambda: torch.einsum("slic,slc->sic", tb, wb),
        4 * (tb.numel() + wb.numel() + len(tb) * tb.shape[2] * rank), 2 * tb.numel(), 1, 50)]
    del tb, wb
    torch.cuda.empty_cache()
    return _row_sums(rows, err)


def _high_rank_phase(torch, args, dev, smi, x4, subjects) -> None:
    """Phase 21 (see the module docstring): the MTTKRP kernels at ranks 80
    and 128 on the fMRI tensor and the fleet; ``cp_als`` under the three
    strategies, ``tune()`` at rank 128 and a sharded ``matrix_free`` run at
    rank 80 in an NCCL world of one."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from repro_torch.dist import GATHERS
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.plan import (Problem, TuningCache, cp_als, make_executor, plan_sweep,
                                  tune)
    from repro_torch.serve import CPService

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 21)
    xb = torch.stack(subjects[:SERVE_BATCH])
    # one column block of 64, the widest: what each of rank 128's two costs alone
    f64 = [torch.randn((d, BLOCK_RANK_TIMED), generator=gen, device=dev) for d in FMRI]
    one = {"fused": 0.0, "matrix_free": 0.0}
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, f64, n)
        one["fused"] += _time_ms(torch, lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos), 5)
        us = [f64[k] for k in range(4) if k != n]
        one["matrix_free"] += _time_ms(torch, lambda: mf.matrix_free_kernel(x4, us, n), 5)
    del f64, t, a, b, us
    _log(f"[21] rank {BLOCK_RANK_TIMED} (one column block) kernel ms a sweep of the fMRI "
         f"tensor: fused {one['fused']:.4f}, matrix_free {one['matrix_free']:.4f} (CUDA "
         f"events); card {smi}")
    local = {}
    for rank in HIGH_RANKS:
        nb, width, cp = mf.column_blocks(rank)
        _log(f"[21] rank {rank}: {nb} column blocks of {width} columns (the last "
             f"{rank - (nb - 1) * width}), each padded to {cp}")
        fs = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
        fb = [torch.randn((SERVE_BATCH, d, rank), generator=gen, device=dev) for d in xb.shape[1:]]
        err = {}
        summary = _high_rank_rows(torch, x4, fs, xb, fb, smi, rank, err)
        _log(f"[21] rows at rank {rank} (sums over each row's calls: 4 modes of rows 1-2, 3 of "
             f"rows 3-4, modes 1-2 of row 5; card {smi}): {json.dumps(summary)}")
        del fs, fb
        # cp_als under the three strategies from one init
        init = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
        fits, msec = {}, {}
        for strategy in ("auto", "fused", "matrix_free"):
            plan = plan_sweep(Problem.from_tensor(x4, rank), strategy)
            torch.cuda.synchronize()
            fm.KERNEL.launches = mf.KERNEL.launches = 0
            got, secs = [], []
            st = cp_als(x4, plan, n_iters=HIGH_RANK_SWEEPS, tol=0.0, init_factors=init,
                        callback=lambda it, f, dt: (got.append(f), secs.append(dt)))
            torch.cuda.synchronize()
            launches = (fm.KERNEL.launches, mf.KERNEL.launches)
            want = {"auto": (0, 0), "fused": (4 * HIGH_RANK_SWEEPS, 0),
                    "matrix_free": (0, 4 * HIGH_RANK_SWEEPS)}[strategy]
            fits[strategy], msec[strategy] = got, [1e3 * s for s in secs]
            local[(rank, strategy)] = (st, got)
            _log(f"[21] cp_als rank {rank} {strategy}: nodes "
                 f"{[np_.algorithm for np_ in plan.nodes]}; fits {got}; ms a sweep "
                 f"{[round(s, 3) for s in msec[strategy]]} (host clock, one sync a sweep); "
                 f"launches fused {launches[0]} matrix_free {launches[1]} (want {want}); "
                 f"card {smi}")
            if launches != want or not all(math.isfinite(f) for f in got):
                raise SystemExit(f"[21] cp_als rank {rank} {strategy}: launches or fits wrong")
        gap = max(abs(a - b) for s in ("fused", "matrix_free")
                  for a, b in zip(fits[s], fits["auto"]))
        _log(f"[21] cp_als rank {rank}: fits across strategies max |diff| {gap:.3e} (bound "
             f"{FIT_AGREE:g})")
        if gap > FIT_AGREE:
            raise SystemExit(f"[21] cp_als rank {rank}: the strategies disagree on the fits")
        if rank != HIGH_RANK_SHARDED:
            del init
        else:
            sharded_init = init
        torch.cuda.empty_cache()

    # the entry points of rows 3-7 at rank 128: the fleet served under the
    # kernel strategies, the 2-step MTTKRP, the batched multi-TTV, the KRP
    rank = HIGH_RANKS[-1]
    shape = tuple(subjects[0].shape)
    inits = [[torch.randn((d, rank), generator=gen, device=dev) for d in shape]
             for _ in range(SERVE_BATCH)]
    served = {}
    for strategy, kernel in (("fused", fm.BATCHED_KERNEL), ("matrix_free", mf.BATCHED_KERNEL)):
        svc = CPService(batch_size=SERVE_BATCH, n_iters=HIGH_RANK_SWEEPS, tol=0.0,
                        strategy=strategy, tuning_cache=TuningCache(), device=dev)
        futs = [svc.submit(subjects[i], rank, init_factors=inits[i]) for i in range(SERVE_BATCH)]
        torch.cuda.synchronize()
        kernel.launches = 0
        t0 = time.perf_counter()
        svc.flush()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        served[strategy] = [f.result().fit for f in futs]
        want = 3 * HIGH_RANK_SWEEPS
        _log(f"[21] CPService rank {rank} {strategy}: {SERVE_BATCH} subjects in one batch, "
             f"{1e3 * secs:.3f} ms (host clock, {HIGH_RANK_SWEEPS} sweeps); batched launches "
             f"{kernel.launches} (want {want}); fits {[round(f, 6) for f in served[strategy]]}; "
             f"card {smi}")
        if kernel.launches != want or not all(math.isfinite(f) for f in served[strategy]):
            raise SystemExit(f"[21] CPService rank {rank} {strategy}: launches or fits wrong")
    gap = max(abs(a - b) for a, b in zip(served["fused"], served["matrix_free"]))
    if gap > FIT_AGREE:
        raise SystemExit(f"[21] CPService rank {rank}: fused and matrix_free fits differ by {gap}")
    del inits
    fs = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
    for k in (mt.KERNEL, mt.BATCHED_KERNEL, fm.KERNEL, kk.KERNEL):
        k.launches = 0
    worst = max(_rel(torch, ops.mttkrp_2step_kernel(x4, fs, n), ref.fused_mttkrp_ref(x4, fs, n))[0]
                for n in range(4))
    krp_same = torch.equal(ops.krp_materialize(fs[1:]), ref.krp_ref(fs[1:]))
    fsub = [torch.randn((d, rank), generator=gen, device=dev) for d in shape]
    pairs = [ops.multi_ttv_operands(subjects[i], fsub, 1) for i in range(2)]  # the fleet's mode 1
    tb, wb = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    ops.multi_ttv_batched(tb, wb)
    torch.cuda.synchronize()
    got = (mt.KERNEL.launches, fm.KERNEL.launches, kk.KERNEL.launches, mt.BATCHED_KERNEL.launches)
    _log(f"[21] rank {rank}: mttkrp_2step_kernel on every mode against the einsum oracle, worst "
         f"rel err {worst:.3e} (bound {REL_ERR_BOUND:g}); krp_materialize bitwise the oracle: "
         f"{krp_same}; launches multi_ttv {got[0]} fused {got[1]} krp_pair {got[2]} "
         f"multi_ttv_batched {got[3]} (want 2, 2, 2, 1)")
    if worst > REL_ERR_BOUND or not krp_same or got != (2, 2, 2, 1):
        raise SystemExit(f"[21] the 2-step, KRP or batched multi-TTV path at rank {rank} failed")
    del fs, fsub, pairs, tb, wb
    torch.cuda.empty_cache()

    # tune() at rank 128: the kernels timed, and the plan it makes
    for k in (fm.KERNEL, mf.KERNEL, mt.KERNEL):
        k.launches = 0
    cache = TuningCache(None)
    t0 = time.perf_counter()
    entry = tune(x4, rank, cache=cache, budget_ms=None, reps=1)
    torch.cuda.synchronize()
    tile_rows = {name_: len(summ["rows"]) for name_, summ in entry["tiles"].items()}
    algs = sorted({r["algorithm"] for r in entry["nodes"] if "algorithm" in r})
    plan = plan_sweep(Problem.from_tensor(x4, rank), "autotune", tuning_cache=cache)
    _log(f"[21] tune(x4, {rank}): tile rows {tile_rows}, {len(entry['nodes'])} node rows "
         f"({algs}), launches fused {fm.KERNEL.launches} matrix_free {mf.KERNEL.launches} "
         f"multi_ttv {mt.KERNEL.launches}, {time.perf_counter() - t0:.1f} s wall; autotune "
         f"plan nodes {[(np_.algorithm, np_.tiles) for np_ in plan.nodes]}; card {smi}")
    if not all(tile_rows.values()) or not {"fused", "matrix_free"} <= set(algs):
        raise SystemExit(f"[21] tune at rank {rank} timed no kernel")
    del cache, entry

    # one sharded matrix_free run at rank 80 in an NCCL world of one
    rank = HIGH_RANK_SHARDED
    store = tempfile.mkdtemp(prefix="chip_smoke_high_rank_")
    try:
        tdist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                 world_size=1)
        mesh = make_host_mesh(1, 1, device="cuda")
        plan = plan_sweep(Problem.from_tensor(x4, rank, DIST_AXES, mesh), "matrix_free",
                          executor="sharded")
        torch.cuda.synchronize()
        mf.KERNEL.launches = GATHERS.calls = 0
        fits = []
        st = cp_als(x4, plan, executor=make_executor("sharded", mesh, DIST_AXES),
                    n_iters=HIGH_RANK_SWEEPS, tol=0.0, init_factors=sharded_init,
                    callback=lambda it, f, dt: fits.append(f))
        torch.cuda.synchronize()
        same = _bitwise(st, fits, local[(rank, "matrix_free")])
        _log(f"[21] sharded matrix_free rank {rank} {DIST_AXES} (NCCL world of 1): launches "
             f"{mf.KERNEL.launches} (want {4 * HIGH_RANK_SWEEPS}), collectives {GATHERS.calls}; "
             f"bitwise equal to the local run: {'ok' if same else 'FAIL'}")
        if not same or mf.KERNEL.launches != 4 * HIGH_RANK_SWEEPS or GATHERS.calls == 0:
            raise SystemExit("[21] the sharded run at rank 80 differs from the local one")
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del xb, local, sharded_init
    torch.cuda.empty_cache()
    _log(f"[21] high-rank phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


def _only_high_rank(torch, args, dev, smi) -> None:
    """``--only high_rank``: build every kernel source, make the fMRI tensor
    and its fleet, then phase 21."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt

    _build.build_all([fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL, mt.KERNEL,
                      mt.BATCHED_KERNEL, kk.KERNEL])
    for k in (fm.KERNEL, mf.KERNEL):
        for line in k.ptxas_log.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                _log(f"[1] {k.source.name}: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x4 = synth_fmri(torch, gen, args.rank, dev)
    subjects = [x4[:, s].contiguous() for s in range(FMRI[1])]
    _high_rank_phase(torch, args, dev, smi, x4, subjects)


# ---- phase 22: bf16, fp16 and float64 operands on every kernel
DTYPE_RANKS = (10, 80)  # rank 80: two column blocks of rows 1-4
DTYPE_SWEEPS = 3


def _log_ptxas(kernels) -> None:
    """Each source's ``-Xptxas -v`` report of its instances: registers,
    shared memory and spills."""
    from repro_torch.kernels import _build

    for src in dict.fromkeys(s for k in kernels for s in k.sources):
        for line in _build.ptxas_log(src).splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                _log(f"[1] {src.name}: {line.strip()}")


def _dtype_geometry(g) -> str:
    return (f" [grid ({_grid_x(g)}, {g.groups} x {g.splits}, {g.slabs}), q chunk "
            f"{g.q_chunk} x {g.chunks}, {'16' if g.vec else 'element'}-byte copies, "
            f"{g.smem} B shared]")


def _dtype_rows(torch, x4, xb, fs, fb, rank, smi, err, timed, krp_only=False):
    """Rows 1-7 in the dtype of ``fs`` (the fMRI tensor ``x4``: rows 1, 2,
    5, 7; the fleet batch ``xb``: rows 3, 4, 6; rows 1-4 only unless
    ``timed``; row 7 first, with :func:`_krp_edge_cases`, and alone with
    ``krp_only``, where ``x4``, ``xb`` and ``fb`` are unused):
    every call within ``REL_ERR_BOUND`` of its plain version relative to the
    plain version's largest magnitude (row 7 bitwise), bitwise repeatable,
    one counted launch a call and the CUDA kernels a call its design states
    (a CUDA graph of one call: those of float32).  With ``timed``, its
    CUDA-event time beside the bound (each operand read once at its width,
    the float32 output written once; 2 C fp32 operations an element), the
    plain version and one ``torch.einsum`` on the operands in their own
    dtype.  Returns each row's sums over its calls."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.kernels import ops

    dtype = fs[0].dtype
    isz = fs[0].element_size()
    tag = str(dtype).removeprefix("torch.")

    def row(key, label, kernel, run, plain, library, byts, flops, want_kernels, reps):
        out = run()
        before = kernel.launches
        again = run()
        launched = kernel.launches - before
        want = plain()
        mabs = float((out.double() - want.double()).abs().max())
        rel = mabs / max(float(want.double().abs().max()), 1e-300)
        bitwise = kernel is kk.KERNEL
        err[key] = max(err.get(key, 0.0), mabs)
        ops_, kern = _graph_ops(torch, run)
        same = torch.equal(out, again)
        ok = (torch.equal(out, want) if bitwise else math.isfinite(rel) and rel <= REL_ERR_BOUND)
        ok = (ok and same and launched == 1 and ops_ == kern == want_kernels
              and out.dtype == (dtype if bitwise else torch.float32))
        r = {}
        if timed:
            r = {"ms": _time_ms(torch, run, reps), "plain_ms": _time_ms(torch, plain, 2),
                 "library_ms": _time_ms(torch, library, 2), "bytes_ms": byts / HBM_BW * 1e3,
                 "flops_ms": flops / PEAK_FLOPS * 1e3}
        del want, out, again
        times = ""
        if timed:
            bound = max(r["bytes_ms"], r["flops_ms"])
            times = (f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, einsum "
                     f"{r['library_ms']:.4f} ms, bound {bound:.4f} ms ("
                     f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'})")
        _log(f"[22] {tag} {label} rank {rank}: max abs err {mabs:.3e}, relative to the plain "
             f"version's largest {rel:.3e} (bound {'bitwise' if bitwise else REL_ERR_BOUND}), "
             f"run twice bitwise {same}, launches "
             f"{launched} a call, {kern} CUDA kernels a call (want {want_kernels}){times}; "
             f"card {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[22] {tag} {label} rank {rank}: wrong, not repeatable or wrong "
                             "launches")
        return r

    rows = {}
    if timed:
        rows["krp"] = [_krp_row(torch, row, fs, smi, 22, 50)]
        _krp_edge_cases(torch, fs[0].device, dtype, 22)
    if krp_only:
        return rows
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, fs, n)
        g = fm.launch_geometry(tuple(t.shape), pos, rank, itemsize=isz)
        rows.setdefault("fused", []).append(row(
            "fused", f"fused_mttkrp_bilinear mode {n} pos {pos}{_dtype_geometry(g)}", fm.KERNEL,
            lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos),
            lambda: fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos),
            lambda: torch.einsum(_BILINEAR[pos], t, a, b),
            isz * (t.numel() + a.numel() + b.numel()) + 4 * t.shape[pos] * rank,
            2 * t.numel() * rank, 1 if g.groups == 1 else 2, 5))
        del t, a, b
        us = [fs[k] for k in range(4) if k != n]
        g = mf.unbatched_launch_shape(FMRI, n, rank, itemsize=isz)
        rows.setdefault("mf", []).append(row(
            "mf", f"matrix_free_kernel mode {n}{_dtype_geometry(g)}", mf.KERNEL,
            lambda: mf.matrix_free_kernel(x4, us, n),
            lambda: mf.matrix_free_kernel_plain(x4, us, n),
            lambda: torch.einsum(_einsum_spec(4, n), x4, *us),
            isz * (x4.numel() + sum(u.numel() for u in us)) + 4 * FMRI[n] * rank,
            2 * x4.numel() * rank, 1 if g.groups == 1 else 2, 5))
        torch.cuda.empty_cache()
    for n in range(3):
        t, a, b, pos = ops.bilinear_operands_batched(xb, fb, n)
        rows.setdefault("fused_b", []).append(row(
            "fused_b", f"fused_mttkrp_bilinear_batched S={len(xb)} mode {n} pos {pos}",
            fm.BATCHED_KERNEL, lambda: fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos),
            lambda: fm.fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos),
            lambda: torch.einsum(_slab_spec(_BILINEAR[pos]), t, a, b),
            isz * (t.numel() + a.numel() + b.numel()) + 4 * len(xb) * t.shape[1 + pos] * rank,
            2 * t.numel() * rank, 1, 10))
        us = [fb[k] for k in range(3) if k != n]
        spec = _slab_spec(_einsum_spec(3, n))
        rows.setdefault("mf_b", []).append(row(
            "mf_b", f"matrix_free_batched_kernel S={len(xb)} mode {n}", mf.BATCHED_KERNEL,
            lambda: mf.matrix_free_batched_kernel(xb, us, n),
            lambda: mf.matrix_free_batched_kernel_plain(xb, us, n),
            lambda: torch.einsum(spec, xb, *us),
            isz * (xb.numel() + sum(u.numel() for u in us)) + 4 * len(xb) * xb.shape[1 + n] * rank,
            2 * xb.numel() * rank, 1, 10))
    if not timed:
        return rows
    # rows 5-6 through the kernel-level entries (float32 out, one kernel a
    # call), a tile of the rows there are (block_i must divide them)
    for n in (1, 2):
        t, w = ops.multi_ttv_operands(x4, fs, n)
        bi = t.shape[1]
        rows.setdefault("mt", []).append(row(
            "mt", f"multi_ttv_kernel mode {n} T{tuple(t.shape)} block_i {bi}", mt.KERNEL,
            lambda: mt.multi_ttv_kernel(t, w, block_i=bi), lambda: mt.multi_ttv_plain(t, w),
            lambda: torch.einsum("lic,lc->ic", t, w),
            isz * (t.numel() + w.numel()) + 4 * t.shape[1] * rank, 2 * t.numel(), 1, 50))
    pairs = [ops.multi_ttv_operands(xb[s], [f[s] for f in fb], 1) for s in range(len(xb))]
    tb, wb = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    del pairs
    bi = tb.shape[2]
    rows["mt_b"] = [row(
        "mt_b", f"multi_ttv_batched_kernel T{tuple(tb.shape)} block_i {bi}", mt.BATCHED_KERNEL,
        lambda: mt.multi_ttv_batched_kernel(tb, wb, block_i=bi, block_batch=1),
        lambda: mt.multi_ttv_batched_plain(tb, wb),
        lambda: torch.einsum("slic,slc->sic", tb, wb),
        isz * (tb.numel() + wb.numel()) + 4 * len(tb) * tb.shape[2] * rank, 2 * tb.numel(), 1,
        50)]
    del tb, wb
    torch.cuda.empty_cache()
    return rows


def _dtypes_phase(torch, args, dev, smi, x4) -> None:
    """Phase 22 (see the module docstring): rows 1-7 in bf16, fp16 and
    float64 on the fMRI tensor (``x4``, float32, cast one dtype at a time)
    and the fleet batch; ``cp_als`` in float64 under auto, fused and
    matrix_free; ``tune()`` in float64 and bf16."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.plan import Problem, TuningCache, cp_als, plan_sweep, tune

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 22)
    f32 = {rank: [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
           for rank in DTYPE_RANKS}
    fb32 = {rank: [torch.randn((SERVE_BATCH, d, rank), generator=gen, device=dev)
                   for d in (FMRI[0],) + FMRI[2:]] for rank in DTYPE_RANKS}
    summaries = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        tag = str(dtype).removeprefix("torch.")
        t0 = time.perf_counter()
        xd = x4.to(dtype)
        xb = x4[:, :SERVE_BATCH].transpose(0, 1).to(  # subjects 0-7, the fleet batch
            dtype, memory_format=torch.contiguous_format)
        for rank in DTYPE_RANKS:
            err = {}
            fs = [u.to(dtype) for u in f32[rank]]
            fb = [u.to(dtype) for u in fb32[rank]]
            rows = _dtype_rows(torch, xd, xb, fs, fb, rank, smi, err, rank == DTYPE_RANKS[0])
            if rank == DTYPE_RANKS[0]:
                summaries[tag] = summary = _row_sums(rows, err)
                _log(f"[22] {tag} rows at rank {rank} (sums over each row's calls: 4 modes of "
                     f"rows 1-2, 3 of rows 3-4, modes 1-2 of row 5; card {smi}): "
                     f"{json.dumps(summary)}")
            del fs, fb
        if dtype == torch.float64:  # the front door in float64
            init = [u.double() for u in f32[DTYPE_RANKS[0]]]
            fits = {}
            rank = DTYPE_RANKS[0]
            for strategy in ("auto", "fused", "matrix_free"):
                plan = plan_sweep(Problem.from_tensor(xd, rank), strategy)
                torch.cuda.synchronize()
                fm.KERNEL.launches = mf.KERNEL.launches = 0
                got, secs = [], []
                st = cp_als(xd, plan, n_iters=DTYPE_SWEEPS, tol=0.0, init_factors=init,
                            callback=lambda it, f, dt: (got.append(f), secs.append(dt)))
                torch.cuda.synchronize()
                launches = (fm.KERNEL.launches, mf.KERNEL.launches)
                want = {"auto": (0, 0), "fused": (4 * DTYPE_SWEEPS, 0),
                        "matrix_free": (0, 4 * DTYPE_SWEEPS)}[strategy]
                fits[strategy] = got
                finite = all(math.isfinite(f) for f in got) and all(
                    u.dtype == torch.float64 and bool(torch.isfinite(u).all()) for u in st.factors)
                _log(f"[22] cp_als float64 rank {rank} {strategy}: nodes "
                     f"{[np_.algorithm for np_ in plan.nodes]}; fits {got}; ms a sweep "
                     f"{[round(1e3 * s_, 3) for s_ in secs]} (host clock, one sync a sweep); "
                     f"launches fused {launches[0]} matrix_free {launches[1]} (want {want}); "
                     f"card {smi}")
                if launches != want or not finite:
                    raise SystemExit(f"[22] cp_als float64 {strategy}: launches or fits wrong")
                del st
            gap = max(abs(a - b) for s_ in ("fused", "matrix_free")
                      for a, b in zip(fits[s_], fits["auto"]))
            _log(f"[22] cp_als float64: fits across strategies max |diff| {gap:.3e} (bound "
                 f"{FIT_AGREE:g})")
            if gap > FIT_AGREE:
                raise SystemExit("[22] cp_als float64: the strategies disagree on the fits")
        if dtype in (torch.float64, torch.bfloat16):  # tune() times the kernels
            for k in (fm.KERNEL, mf.KERNEL, mt.KERNEL):
                k.launches = 0
            cache = TuningCache(None)
            t1 = time.perf_counter()
            entry = tune(xd, DTYPE_RANKS[0], cache=cache, budget_ms=None, reps=1)
            torch.cuda.synchronize()
            tile_rows = {name_: len(summ["rows"]) for name_, summ in entry["tiles"].items()}
            algs = sorted({r["algorithm"] for r in entry["nodes"] if "algorithm" in r})
            _log(f"[22] tune({tag} x4, {DTYPE_RANKS[0]}): tile rows {tile_rows}, "
                 f"{len(entry['nodes'])} node rows ({algs}), launches fused "
                 f"{fm.KERNEL.launches} matrix_free {mf.KERNEL.launches} multi_ttv "
                 f"{mt.KERNEL.launches}, {time.perf_counter() - t1:.1f} s wall; card {smi}")
            if not all(tile_rows.values()) or not {"fused", "matrix_free"} <= set(algs) or not (
                    fm.KERNEL.launches and mf.KERNEL.launches and mt.KERNEL.launches):
                raise SystemExit(f"[22] tune in {tag} timed no kernel")
            del cache, entry
        del xd, xb
        torch.cuda.empty_cache()
        _log(f"[22] {tag}: {time.perf_counter() - t0:.1f} s")
    _log(f"[22] dtype rows at rank {DTYPE_RANKS[0]} (card {smi}): {json.dumps(summaries)}")
    _log(f"[22] dtype phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


def _only_dtypes(torch, args, dev, smi) -> None:
    """``--only dtypes``: build every kernel source (every element type),
    make the fMRI tensor, then phase 22."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt

    kernels = [fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL, mt.KERNEL,
               mt.BATCHED_KERNEL, kk.KERNEL]
    t0 = time.perf_counter()
    _build.build_all(kernels)
    _log(f"[1] built {len({s for k in kernels for s in k.sources})} sources in "
         f"{time.perf_counter() - t0:.1f} s")
    _log_ptxas(kernels)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x4 = synth_fmri(torch, gen, args.rank, dev)
    _dtypes_phase(torch, args, dev, smi, x4)


# ---- phase 14: the LM serving path
# olmo-1b's parameter count: the reference's repro.analysis.flops.param_count
# of its config, and the port's count on the meta device
# (tests/test_torch_lm_configs.py::test_olmo_1b_has_the_reference_count).
OLMO_1B_PARAMS = 1_176_764_416
# Logits of two fp32 computations of one model (decode against the parallel
# forward; the card against the CPU; factored FFN against its dense product):
# the reference's own bound for decode against forward
# (tests/test_models_smoke.py::test_decode_matches_forward_dense).
LM_LOGIT_TOL = 2e-3
LM_REQUESTS = 8
LM_BATCH = 4
LM_NEW_TOKENS = 16
LM_CP_RANK = 64
LM_SMALL_LAYERS = 2
QWEN3_LAYERS = 4
LM_TRACE_STEPS = 4


def _lm_requests(vocab: int, seed: int, n: int) -> list:
    """``launch.serve``'s prompts: lengths in [4, 16), tokens in [0, vocab)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 16))) for _ in range(n)]


def _lm_serve(model, params, prompts, new_tokens=LM_NEW_TOKENS):
    from repro_torch.serve import GenerationConfig, ServeEngine

    eng = ServeEngine(model, params, GenerationConfig(max_new_tokens=new_tokens),
                      batch_size=LM_BATCH)
    rids = [eng.submit(p) for p in prompts]
    return rids, eng.flush()


def _lm_check_served(label, rids, results, vocab, new_tokens=LM_NEW_TOKENS):
    ok = sorted(results) == sorted(rids) and all(
        r.shape == (new_tokens,) and (r >= 0).all() and (r < vocab).all()
        for r in results.values())
    _log(f"{label}: {len(results)} of {len(rids)} rids answered, {new_tokens} tokens each "
         f"in [0, {vocab}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: a request went unanswered or a token is out of range")


def _lm_teacher_forced(torch, params, cfg, toks):
    """Logits of the parallel forward and of decode step by step (one
    token a step from an empty cache); their largest |difference| and scale."""
    from repro_torch.models import transformer as tt

    with torch.no_grad():
        full = tt.lm_logits(params, cfg, tt.forward(params, cfg, toks)[0])
        cache = tt.init_cache(cfg, toks.shape[0], toks.shape[1], torch.float32, toks.device)
        steps = []
        for i in range(toks.shape[1]):
            lg, cache = tt.decode_step(params, cfg, toks[:, i : i + 1], cache)
            steps.append(lg)
        step = torch.cat(steps, 1)
    return full, step


def _lm_close(torch, label, got, want, tol=LM_LOGIT_TOL):
    """``|got - want| <= tol + tol * |want|`` everywhere (allclose at rtol =
    atol = tol), as the reference's tests hold logits."""
    diff = (got.double() - want.double()).abs()
    excess = float((diff - tol * want.double().abs()).max())
    mabs = float(diff.max())
    ok = math.isfinite(mabs) and excess <= tol
    _log(f"{label}: max |diff| {mabs:.3e} (logits up to {float(want.abs().max()):.3f}; "
         f"allclose rtol = atol = {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: logits disagree")
    return mabs


def _lm_phase(torch, args, dev, smi) -> None:
    """Phase 14: the port's LM serving path on the card (see the module
    docstring).  Catches nothing: any failure ends the run."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.cp_layers import compress_ffn, reconstruction_error
    from repro_torch.launch import serve as serve_driver
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.serve import GenerationConfig, generate
    from repro_torch.train.optimizer import init_opt_state

    t_phase = time.perf_counter()
    cfg = get_config("olmo-1b")
    # ---- 14a: olmo-1b at full width and depth, bf16 compute over fp32 params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    n_params = count_params(model.params)
    _log(f"[14a] olmo-1b: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
         f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied {cfg.tie_embeddings}, compute "
         f"{cfg.compute_dtype} over {cfg.param_dtype}; {n_params:,} params (reference "
         f"{OLMO_1B_PARAMS:,}) built in {time.perf_counter() - t0:.2f} s")
    if n_params != OLMO_1B_PARAMS:
        raise SystemExit(f"olmo-1b has {n_params} parameters, not the reference's {OLMO_1B_PARAMS}")
    prompts = _lm_requests(cfg.vocab, args.seed, LM_REQUESTS)
    rids, first = _lm_serve(model, model.params, prompts)  # warm-up and the first answer
    _lm_check_served("[14a] olmo-1b ServeEngine", rids, first, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids2, second = _lm_serve(model, model.params, prompts)
    serve_s = time.perf_counter() - t0  # flush returns host arrays: ends in a sync
    peak = torch.cuda.max_memory_allocated() / 1e9
    same = sorted(second) == sorted(first) and all(np.array_equal(first[r], second[r])
                                                   for r in first)
    _log(f"[14a] a second flush of the same {LM_REQUESTS} requests bitwise equal: "
         f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("olmo-1b: serving the same requests twice gave other tokens")
    # generate against a manual prefill + decode argmax loop, on the first batch as flushed
    s = max(len(p) for p in prompts[:LM_BATCH])
    toks = np.zeros((LM_BATCH, s), np.int32)
    for i, p in enumerate(prompts[:LM_BATCH]):
        toks[i, s - len(p):] = p
    first_batch = torch.from_numpy(toks).to(dev)
    gen_out = generate(model, model.params, {"tokens": first_batch},
                       GenerationConfig(max_new_tokens=LM_NEW_TOKENS))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(LM_NEW_TOKENS + 2)]
    ev[0].record()
    cache, logits = model.prefill(model.params, {"tokens": first_batch},
                                  max_len=s + LM_NEW_TOKENS + 1)
    ev[1].record()
    manual = []
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(LM_NEW_TOKENS):
        manual.append(tok[:, 0])
        logits, cache = model.decode_step(model.params, tok, cache)
        ev[i + 2].record()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    manual = torch.stack(manual, 1).cpu().numpy()
    agree = np.array_equal(gen_out, manual) and all(
        np.array_equal(first[rids[i]], manual[i]) for i in range(LM_BATCH))
    _log(f"[14a] generate and the flushed batch equal a manual prefill + decode argmax loop: "
         f"{'ok' if agree else 'FAIL'}")
    if not agree:
        raise SystemExit("olmo-1b: generate disagrees with prefill + decode_step")
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(LM_NEW_TOKENS)]
    n_tok = sum(len(v) for v in second.values())
    weight_bytes = 4 * n_params
    _log(f"[14a] olmo-1b serving (batch {LM_BATCH}, prompts {sorted(len(p) for p in prompts)}, "
         f"{LM_NEW_TOKENS} new tokens, greedy): prefill {prefill_ms:.3f} ms (prompt {s}, CUDA "
         f"events); decode {sum(decode_ms) / len(decode_ms):.3f} ms a token (median "
         f"{_median(decode_ms):.3f}, min {min(decode_ms):.3f}, max {max(decode_ms):.3f}); "
         f"flush of {LM_REQUESTS} requests {serve_s * 1e3:.1f} ms, {n_tok / serve_s:.1f} tokens/s "
         f"(host clock); peak memory {peak:.3f} GB; decode-step bound, each fp32 weight read "
         f"once: {weight_bytes / 1e9:.3f} GB / {HBM_BW:.3g} B/s = "
         f"{weight_bytes / HBM_BW * 1e3:.3f} ms; card {smi}")
    # a trace of decode steps (each rewrites the same cache slot, so repeats are alike)
    wall, evs = _trace(torch, lambda: [model.decode_step(model.params, tok, cache)
                                       for _ in range(LM_TRACE_STEPS)])
    _log_trace(f"[14a] olmo-1b decode (batch {LM_BATCH}, traced)", wall, evs, LM_TRACE_STEPS, smi,
               unit="step")
    del cache, logits, first_batch

    # ---- 14e: a checkpoint round trip (here, while the 14a model is resident)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        free = shutil.disk_usage(tmp).free / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        opt = init_opt_state(model.params)
        path = CheckpointManager(tmp).save(1, (model.params, opt), extra={"arch": cfg.name})
        del opt
        torch.cuda.empty_cache()
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir()) / 1e9
        t0 = time.perf_counter()
        restored = serve_driver.main(["--arch", cfg.name, "--requests", str(LM_REQUESTS),
                                      "--new-tokens", str(LM_NEW_TOKENS), "--batch-size",
                                      str(LM_BATCH), "--ckpt-dir", tmp, "--device", str(dev)])
        restore_s = time.perf_counter() - t0
        ckpt_peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.seed == 0:
        want = first  # launch.serve draws its prompts from default_rng(0) too
    else:
        want = _lm_serve(model, model.params, _lm_requests(cfg.vocab, 0, LM_REQUESTS))[1]
    same = sorted(restored) == sorted(want) and all(np.array_equal(restored[r], want[r])
                                                    for r in want)
    _log(f"[14e] checkpoint of (params, init_opt_state(params)): {size:.2f} GB written in "
         f"{save_s:.1f} s ({free:.0f} GB free there); launch.serve --ckpt-dir restored it and "
         f"served in {restore_s:.1f} s (peak memory {ckpt_peak:.2f} GB: the 14a model beside "
         f"the driver's, its restore template and the restored tree); its greedy tokens "
         f"bitwise 14a's: "
         f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("the restored checkpoint served other tokens")
    del restored
    torch.cuda.empty_cache()

    # ---- 14b: teacher-forced decode against the parallel forward, fp32 compute
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev, dtype=torch.int32)
    full, step = _lm_teacher_forced(torch, model.params, cfg32, toks)
    _lm_close(torch, "[14b] olmo-1b decode vs forward (fp32, 16 tokens, batch 2)", step, full)
    del model, full, step
    torch.cuda.empty_cache()
    qcfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=QWEN3_LAYERS,
                               compute_dtype="float32")
    qwen = build_model(qcfg, device=dev, generator=gen)
    _log(f"[14b] qwen3-8b at full width cut to {QWEN3_LAYERS} layers: {count_params(qwen.params):,} "
         f"params, GQA {qcfg.n_heads}/{qcfg.n_kv_heads} (g = {qcfg.n_heads // qcfg.n_kv_heads}), "
         f"QK-norm {qcfg.qk_norm}, rope_theta {qcfg.rope_theta:g}")
    toks = torch.randint(0, qcfg.vocab, (2, 16), generator=gen, device=dev, dtype=torch.int32)
    full, step = _lm_teacher_forced(torch, qwen.params, qcfg, toks)
    _lm_close(torch, "[14b] qwen3-8b decode vs forward (fp32, 16 tokens, batch 2)", step, full)
    del qwen, full, step
    torch.cuda.empty_cache()

    # ---- 14c: the card against the port's CPU run, olmo-1b full width, 2 layers, fp32
    small = dataclasses.replace(cfg, n_layers=LM_SMALL_LAYERS, compute_dtype="float32")
    cpu = build_model(small, device="cpu", generator=torch.Generator().manual_seed(args.seed))
    card = build_model(small, device=dev, generator=gen)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, small.vocab, (2, 12), generator=torch.Generator().manual_seed(args.seed),
                         dtype=torch.int32)
    runs = {}
    for name, m in (("cpu", cpu), ("card", card)):
        t = toks.to(m.device)
        cache, lg = m.prefill(m.params, {"tokens": t[:, :8]}, max_len=12)
        steps = [lg]
        for i in range(8, 12):
            lg, cache = m.decode_step(m.params, t[:, i : i + 1], cache)
            steps.append(lg)
        runs[name] = torch.cat(steps, 1).cpu()
    _lm_close(torch, "[14c] olmo-1b 2 layers, card vs CPU: prefill and 4 decode logits",
              runs["card"], runs["cpu"])
    top2 = runs["cpu"].topk(2, -1).values
    gaps = (top2[..., 0] - top2[..., 1]).flatten()
    same_tok = runs["cpu"].argmax(-1).flatten() == runs["card"].argmax(-1).flatten()
    wide = gaps > LM_LOGIT_TOL
    _log(f"[14c] greedy tokens equal at {int(same_tok.sum())} of {same_tok.numel()} positions; "
         f"{int(wide.sum())} have a CPU top-2 gap over {LM_LOGIT_TOL:g} (smallest gap "
         f"{float(gaps.min()):.3e}), all equal there: "
         f"{'ok' if bool(same_tok[wide].all()) else 'FAIL'}")
    if not bool(same_tok[wide].all()):
        raise SystemExit("card and CPU pick other greedy tokens where the CPU's top-2 gap is wide")
    del cpu

    # ---- 14d: the cp_rank model against the dense model of its products
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = [{k: v.detach() for k, v in layer["mlp"].items()} for layer in card.params["layers"]]
    factors = [compress_ffn(mlp, LM_CP_RANK) for mlp in dense]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    recon = max(reconstruction_error(mlp[k], fs[f"{k}_a"], fs[f"{k}_b"])
                for mlp, fs in zip(dense, factors) for k in ("gate", "up", "down"))
    cp_cfg = dataclasses.replace(small, cp_rank=LM_CP_RANK)
    cp_model = build_model(cp_cfg, device=dev, generator=gen)
    with torch.no_grad():
        cp_model.params["embed"].copy_(card.params["embed"])
        for lc, ld, fs in zip(cp_model.params["layers"], card.params["layers"], factors):
            for k, v in ld["attn"].items():
                lc["attn"][k].copy_(v)
            for k, v in fs.items():
                lc["mlp"][k].copy_(v)
            for k in ("gate", "up", "down"):  # the dense model: W = A @ B
                ld["mlp"][k].copy_(fs[f"{k}_a"] @ fs[f"{k}_b"])
    prompts = _lm_requests(cp_cfg.vocab, args.seed + 2, LM_BATCH)
    rids, served = _lm_serve(cp_model, cp_model.params, prompts)
    _lm_check_served(f"[14d] olmo-1b 2 layers at cp_rank {LM_CP_RANK} ServeEngine", rids, served,
                     cp_cfg.vocab)
    toks = torch.randint(0, small.vocab, (LM_BATCH, 12), generator=gen, device=dev,
                         dtype=torch.int32)
    _, cp_logits = cp_model.prefill(cp_model.params, {"tokens": toks}, max_len=13)
    _, dense_logits = card.prefill(card.params, {"tokens": toks}, max_len=13)
    _log(f"[14d] compress_ffn of {LM_SMALL_LAYERS} layers' gate/up/down at rank {LM_CP_RANK} on "
         f"the card in {fit_s:.2f} s (largest relative reconstruction error {recon:.3f}: random "
         f"weights are far from rank {LM_CP_RANK}; the gate holds the factored FFN to its "
         f"own products)")
    _lm_close(torch, f"[14d] cp_rank {LM_CP_RANK} prefill vs the dense model of its products",
              cp_logits, dense_logits)
    del card, cp_model
    torch.cuda.empty_cache()
    _log(f"[14] LM serving phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


# ---- phase 15: the other LM families on the serving path
# (tag, architecture, layers kept (0: all), parameters).  The counts are the
# sums of the reference's ParamDef shapes of each full config
# (tests/test_torch_lm_configs.py::test_full_config_param_counts_equal_the_reference_defs);
# qwen2-moe-a2.7b is cut to 8 of its 24 layers: 15,146,305,536 less 16 of its
# 605,165,568-parameter layers.  At full depth its 60.59 GB of fp32 weights
# leave too little of the card's 80 GB for the per-use bf16 casts.
FAMILIES = (
    ("15a", "falcon-mamba-7b", 0, 7_272_665_088),
    ("15b", "recurrentgemma-2b", 0, 3_337_597_440),
    ("15c", "qwen2-moe-a2.7b", 8, 5_463_656_448),
    ("15d", "whisper-base", 0, 114_065_408),
)
# The longest prompt of the extra served batch: the SSM chunks its scan at
# 128 only where 128 divides S, so 256 runs the chunked scan.
FAMILY_LONG_PROMPT = 256
# Layers of the fp32 decode-vs-forward gate (full width; whisper-base runs
# whole), and its sequence length: falcon-mamba's 256 runs the chunked scan
# against 256 recurrent steps; a MoE forward of one row of 8 tokens has
# capacity 8 an expert, so no pair drops and decode must equal it.
FAMILY_CHECK = {"falcon-mamba-7b": (4, 2, 256), "recurrentgemma-2b": (3, 2, 16),
                "qwen2-moe-a2.7b": (2, 1, 8), "whisper-base": (0, 2, 16)}
FAMILY_SMALL_LAYERS = 2  # the card against the CPU (whisper-base runs whole)


def _with_moe_drops(fn):
    """``fn()`` with every MoE layer call also counting the pairs it drops at
    capacity (a host read a call): returns ``fn()``'s result and each call's
    ``(tokens a row, pairs dropped)``."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod._moe_local
    seen = []

    def counting(p, cfg, x, **kw):
        seen.append((x.shape[1], moe_mod.dropped_pairs(p, cfg, x)))
        return real(p, cfg, x, **kw)

    moe_mod._moe_local = counting
    try:
        return fn(), seen
    finally:
        moe_mod._moe_local = real


def _family_batch(torch, cfg, prompts, dev):
    """The batch ``ServeEngine.flush`` makes of ``prompts``: left-padded with
    0 to the longest, zero frames for an enc-dec model."""
    import numpy as np

    s = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        toks[i, s - len(p):] = p
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.is_encdec:
        batch["frames"] = torch.zeros((len(prompts), s, cfg.d_model), dtype=torch.float32,
                                      device=dev)
    return batch


def _family_serve(torch, args, dev, smi, tag, cfg, want_params) -> None:
    """15a-d serving: build the model from ``--seed`` (bf16 compute over fp32
    parameters), serve ``LM_REQUESTS`` prompts as ``launch.serve`` makes them
    plus one batch whose longest prompt is ``FAMILY_LONG_PROMPT`` tokens, twice
    (bitwise equal), the first batch again by a manual prefill + decode loop
    (equal), and print the times, peak memory, bound and a decode trace."""
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    n_params = count_params(model.params)
    _log(f"[{tag}] {cfg.name}: family {cfg.family}, {cfg.n_layers} layers "
         f"{'(enc ' + str(cfg.enc_layers) + ' + dec ' + str(cfg.dec_layers) + ') ' if cfg.is_encdec else ''}"
         f"d_model {cfg.d_model}, vocab {cfg.vocab}, compute {cfg.compute_dtype} over "
         f"{cfg.param_dtype}; {n_params:,} params ({4 * n_params / 1e9:.2f} GB; expected "
         f"{want_params:,}) built in {time.perf_counter() - t0:.2f} s")
    if n_params != want_params:
        raise SystemExit(f"{cfg.name} has {n_params} parameters, not {want_params}")
    prompts = _lm_requests(cfg.vocab, args.seed, LM_REQUESTS)
    long = _lm_requests(cfg.vocab, args.seed + 3, LM_BATCH - 1)
    long.append(np.random.default_rng(args.seed + 4).integers(0, cfg.vocab, FAMILY_LONG_PROMPT))
    every = prompts + long
    # the first flush also counts the pairs MoE layers drop at capacity (host reads)
    (rids, first), seen = _with_moe_drops(lambda: _lm_serve(model, model.params, every))
    _lm_check_served(f"[{tag}] {cfg.name} ServeEngine", rids, first, cfg.vocab)
    if cfg.n_experts:
        k, e = cfg.n_experts_per_tok, cfg.n_experts
        _log(f"[{tag}] pairs dropped at capacity in the first flush (top-{k} of {e} experts, "
             f"capacity factor {cfg.capacity_factor}, {cfg.n_layers} layers): prefill "
             f"{sum(d for s_, d in seen if s_ > 1)}, decode {sum(d for s_, d in seen if s_ == 1)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids2, second = _lm_serve(model, model.params, every)
    serve_s = time.perf_counter() - t0  # flush returns host arrays: ends in a sync
    peak = torch.cuda.max_memory_allocated() / 1e9
    same = rids2 == rids and all(np.array_equal(first[r], second[r]) for r in first)
    _log(f"[{tag}] a second flush of the same {len(every)} requests bitwise equal: "
         f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit(f"{cfg.name}: serving the same requests twice gave other tokens")
    batch = _family_batch(torch, cfg, prompts[:LM_BATCH], dev)
    s = batch["tokens"].shape[1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(LM_NEW_TOKENS + 2)]
    ev[0].record()
    cache, logits = model.prefill(model.params, batch, max_len=s + LM_NEW_TOKENS + 1)
    ev[1].record()
    manual = []
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(LM_NEW_TOKENS):
        manual.append(tok[:, 0])
        logits, cache = model.decode_step(model.params, tok, cache)
        ev[i + 2].record()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    manual = torch.stack(manual, 1).cpu().numpy()
    agree = all(np.array_equal(first[rids[i]], manual[i]) for i in range(LM_BATCH))
    _log(f"[{tag}] the flushed first batch equals a manual prefill + decode argmax loop: "
         f"{'ok' if agree else 'FAIL'}")
    if not agree:
        raise SystemExit(f"{cfg.name}: the engine disagrees with prefill + decode_step")
    long_batch = _family_batch(torch, cfg, long, dev)
    pe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    pe[0].record()
    model.prefill(model.params, long_batch, max_len=FAMILY_LONG_PROMPT + LM_NEW_TOKENS + 1)
    pe[1].record()
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    long_ms = pe[0].elapsed_time(pe[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(LM_NEW_TOKENS)]
    n_tok = sum(len(v) for v in second.values())
    weight_bytes = 4 * n_params
    _log(f"[{tag}] {cfg.name} serving (batch {LM_BATCH}, prompts "
         f"{sorted(len(p) for p in every)}, {LM_NEW_TOKENS} new tokens, greedy): prefill "
         f"{prefill_ms:.3f} ms (prompt {s}) and {long_ms:.3f} ms (prompt {FAMILY_LONG_PROMPT}), "
         f"CUDA events; decode {sum(decode_ms) / len(decode_ms):.3f} ms a token (median "
         f"{_median(decode_ms):.3f}, min {min(decode_ms):.3f}, max {max(decode_ms):.3f}); flush "
         f"of {len(every)} requests {serve_s * 1e3:.1f} ms, {n_tok / serve_s:.1f} tokens/s (host "
         f"clock); peak memory {peak:.3f} GB; decode-step bound, each fp32 weight read once: "
         f"{weight_bytes / 1e9:.3f} GB / {HBM_BW:.3g} B/s = {weight_bytes / HBM_BW * 1e3:.3f} ms; "
         f"card {smi}")
    wall, evs = _trace(torch, lambda: [model.decode_step(model.params, tok, cache)
                                       for _ in range(LM_TRACE_STEPS)])
    _log_trace(f"[{tag}] {cfg.name} decode (batch {LM_BATCH}, traced)", wall, evs, LM_TRACE_STEPS,
               smi, unit="step")
    if cfg.is_encdec:
        _family_checkpoint_served(torch, args, dev, tag, model)
    del model, cache, logits, batch, long_batch
    torch.cuda.empty_cache()


def _family_checkpoint_served(torch, args, dev, tag, model) -> None:
    """The served model and ``init_opt_state`` of it saved by the port's
    ``CheckpointManager``; ``launch.serve --ckpt-dir`` (in process) restores
    it and serves ``default_rng(0)``'s prompts, bitwise what the model
    serves for them."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import serve as serve_driver
    from repro_torch.train.optimizer import init_opt_state

    cfg = model.cfg
    tmp = tempfile.mkdtemp(prefix="chip_smoke_family_")
    try:
        t0 = time.perf_counter()
        path = CheckpointManager(tmp).save(1, (model.params, init_opt_state(model.params)),
                                           extra={"arch": cfg.name})
        size = sum(f.stat().st_size for f in Path(path).iterdir()) / 1e9
        save_s = time.perf_counter() - t0
        restored = serve_driver.main(["--arch", cfg.name, "--requests", str(LM_REQUESTS),
                                      "--new-tokens", str(LM_NEW_TOKENS), "--batch-size",
                                      str(LM_BATCH), "--ckpt-dir", tmp, "--device", str(dev)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = _lm_serve(model, model.params, _lm_requests(cfg.vocab, 0, LM_REQUESTS))[1]
    same = sorted(restored) == sorted(want) and all(np.array_equal(restored[r], want[r])
                                                    for r in want)
    _log(f"[{tag}] checkpoint of (params, init_opt_state(params)): {size:.2f} GB in {save_s:.1f} s; "
         f"launch.serve --ckpt-dir restored it; its greedy tokens bitwise the model's: "
         f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit(f"{cfg.name}: the restored checkpoint served other tokens")


def _family_checks(torch, args, dev, smi, tag, name) -> None:
    """15a-d gates in fp32 compute: decode against the forward at full width
    (``FAMILY_CHECK`` layers), the card against the CPU (``FAMILY_SMALL_LAYERS``
    layers), and for falcon-mamba-7b the checkpoint round trip of that model."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import _tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tt
    from repro_torch.models.common import count_params
    from repro_torch.train.optimizer import init_opt_state

    full_cfg = get_config(name)
    layers, b, s = FAMILY_CHECK[name]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    cfg = dataclasses.replace(full_cfg, compute_dtype="float32",
                              **({"n_layers": layers} if layers else {}))
    m = build_model(cfg, device=dev, generator=gen)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)
    what = f"{cfg.n_layers} layers" if layers else "whole"
    if cfg.is_encdec:
        frames = torch.randn((b, 24, cfg.d_model), generator=gen, device=dev)
        with torch.no_grad():
            enc = ed.encode(m.params, cfg, frames)
            full = ed.decode_train(m.params, cfg, toks, enc)
            cache = ed.init_encdec_cache(m.params, cfg, enc, s, torch.float32)
            steps = []
            for i in range(s):
                lg, cache = ed.decode_step(m.params, cfg, toks[:, i : i + 1], cache)
                steps.append(lg)
            step = torch.cat(steps, 1)
    else:
        if cfg.n_experts:
            with torch.no_grad():
                _, seen = _with_moe_drops(lambda: tt.forward(m.params, cfg, toks))
            seen = [d for _, d in seen]
            _log(f"[{tag}] pairs dropped in the forward of {b} x {s} tokens: {seen} (must be 0)")
            if any(seen):
                raise SystemExit(f"{name}: the forward dropped pairs; decode cannot equal it")
        full, step = _lm_teacher_forced(torch, m.params, cfg, toks)
    # the real vocabulary (whisper's padded slots hold -1e9 in both)
    _lm_close(torch, f"[{tag}] {name} at full width ({what}, {count_params(m.params):,} params) "
                     f"decode vs forward (fp32, {s} tokens, batch {b})",
              step[..., : cfg.vocab], full[..., : cfg.vocab])
    del m, full, step
    torch.cuda.empty_cache()

    # the card against the port's CPU run
    small = dataclasses.replace(full_cfg, compute_dtype="float32",
                                **({} if full_cfg.is_encdec else {"n_layers": FAMILY_SMALL_LAYERS}))
    cpu = build_model(small, device="cpu", generator=torch.Generator().manual_seed(args.seed))
    card = build_model(small, device=dev, generator=gen)
    card.load_state_dict(cpu.state_dict())
    cg = torch.Generator().manual_seed(args.seed + 6)
    toks = torch.randint(0, small.vocab, (2, 12), generator=cg, dtype=torch.int32)
    frames = torch.randn((2, 8, small.d_model), generator=cg)
    runs = {}
    for where, mm in (("cpu", cpu), ("card", card)):
        t = toks.to(mm.device)
        batch = {"tokens": t[:, :8]}
        if small.is_encdec:
            batch["frames"] = frames.to(mm.device)
        cache, lg = mm.prefill(mm.params, batch, max_len=12)
        steps = [lg]
        for i in range(8, 12):
            lg, cache = mm.decode_step(mm.params, t[:, i : i + 1], cache)
            steps.append(lg)
        runs[where] = torch.cat(steps, 1)[..., : small.vocab].cpu()
    depth = "whole" if small.is_encdec else f"{FAMILY_SMALL_LAYERS} layers"
    _lm_close(torch, f"[{tag}] {name} {depth}, card vs CPU: prefill and 4 decode logits",
              runs["card"], runs["cpu"])
    top2 = runs["cpu"].topk(2, -1).values
    gaps = (top2[..., 0] - top2[..., 1]).flatten()
    same_tok = runs["cpu"].argmax(-1).flatten() == runs["card"].argmax(-1).flatten()
    wide = gaps > LM_LOGIT_TOL
    _log(f"[{tag}] greedy tokens equal at {int(same_tok.sum())} of {same_tok.numel()} positions; "
         f"{int(wide.sum())} have a CPU top-2 gap over {LM_LOGIT_TOL:g}, all equal there: "
         f"{'ok' if bool(same_tok[wide].all()) else 'FAIL'}")
    if not bool(same_tok[wide].all()):
        raise SystemExit(f"{name}: card and CPU pick other greedy tokens where the gap is wide")
    del cpu

    if name == "falcon-mamba-7b":  # the checkpoint round trip of the 2-layer card model
        tmp = tempfile.mkdtemp(prefix="chip_smoke_family_")
        try:
            t0 = time.perf_counter()
            path = CheckpointManager(tmp).save(1, (card.params, init_opt_state(card.params)),
                                               extra={"arch": name})
            size = sum(f.stat().st_size for f in Path(path).iterdir()) / 1e9
            fresh = build_model(small, device=dev, generator=gen)
            (params, _), manifest = CheckpointManager(tmp).restore(
                (fresh.params, init_opt_state(fresh.params)))
            rt_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        want, got = _tree.leaves(card.params), _tree.leaves(params)
        bitwise = manifest["step"] == 1 and len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(want, got))
        prompts = _lm_requests(small.vocab, args.seed + 7, LM_BATCH)
        a = _lm_serve(card, card.params, prompts)[1]
        bb = _lm_serve(fresh, params, prompts)[1]
        same = bitwise and all(np.array_equal(a[r], bb[r]) for r in a)
        _log(f"[{tag}] checkpoint of the {FAMILY_SMALL_LAYERS}-layer model and its optimizer "
             f"state: {size:.2f} GB written and restored in {rt_s:.1f} s; every leaf bitwise and "
             f"the restored model's greedy tokens equal: {'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit(f"{name}: the checkpoint round trip changed the model")
        del fresh, params
    del card
    torch.cuda.empty_cache()


def _lm_families_phase(torch, args, dev, smi) -> None:
    """Phase 15: the MoE, SSM, hybrid and enc-dec families on the card (see
    the module docstring).  One model resident at a time; catches nothing."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    for tag, name, layers, want in FAMILIES:
        t0 = time.perf_counter()
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        _family_serve(torch, args, dev, smi, tag, cfg, want)
        _family_checks(torch, args, dev, smi, tag, name)
        _log(f"[{tag}] {name}: {time.perf_counter() - t0:.1f} s")
    _log(f"[15] LM families phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


# ---- phase 16: the LM training path
# 16a: olmo-1b's published training context (arXiv:2402.00838), global batch
# 8 in 2 micro-batches of 4: 16,384 tokens a step.
TRAIN_SEQ = 2048
TRAIN_BATCH = 8
TRAIN_ACCUM = 2
TRAIN_LR = 3e-4
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 5
# NVIDIA's H100 SXM datasheet: 989 TFLOP/s dense BF16 on the tensor cores at
# the full 700 W.  Nominal, not measured: the share of it a step reaches.
BF16_PEAK_FLOPS = 989e12
# 16b-c: card against the port's CPU run, at the CPU tests' bounds
# (tests/test_torch_train.py): loss and metrics at the fp32 bound, each
# gradient leaf within a norm-wise 2e-3 (the reference's whole-model bound),
# updated parameters at the fp32 bound plus 2 * lr where a gradient is below
# TRAIN_SIGN_NOISE of its leaf's largest (AdamW's first step moves such an
# entry by about lr * sign(g)); accumulation against one batch under the
# reference's 5e-3 (tests/test_train.py::test_grad_accum_equivalence).
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
TRAIN_GRAD_REL = 2e-3
TRAIN_SIGN_NOISE = 1e-5
TRAIN_ACCUM_BOUND = 5e-3
TRAIN_SMALL_LAYERS = 2
TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ = 4, 128
TRAIN_LOOP_STEPS, TRAIN_FAULT_STEP, TRAIN_CKPT_EVERY = 8, 5, 3
# 16c: full width cut to 2 layers (whisper-base whole), 2 x 256 tokens so
# the SSM's chunked scan (128 divides 256) and RG-LRU's scan run backward.
TRAIN_FAMILIES = (("falcon-mamba-7b", 2), ("recurrentgemma-2b", 2),
                  ("qwen2-moe-a2.7b", 2), ("whisper-base", 0))
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 2, 256
# 16d: launch.train at full width and depth, then launch.serve of its checkpoint.
TRAIN_DRIVER_STEPS, TRAIN_DRIVER_BATCH = 2, 4


def _train_batch(torch, cfg, data, index, dev, seed):
    """Batch ``index`` of ``data`` on ``dev``; an enc-dec model also gets
    frames drawn from ``seed`` (its frontend is a stub)."""
    import numpy as np

    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(index).items()}
    if cfg.is_encdec:
        b, s = batch["tokens"].shape
        frames = np.random.default_rng(seed).standard_normal((b, s - 1, cfg.d_model))
        batch["frames"] = torch.from_numpy(frames.astype(np.float32)).to(dev)
    return batch


def _with_grads(fn):
    """``fn()`` with the gradients each training step hands to
    ``adamw_update`` recorded (on the host): returns ``fn()``'s result and
    the list of ``{leaf path: array}``."""
    import numpy as np

    from repro_torch import _tree
    from repro_torch.train import train_step as ts

    real = ts.adamw_update
    seen = []

    def recording(params, grads, state, cfg):
        seen.append(_tree.flatten(grads, lambda g: g.detach().cpu().numpy(), np.stack))
        return real(params, grads, state, cfg)

    ts.adamw_update = recording
    try:
        return fn(), seen
    finally:
        ts.adamw_update = real


def _with_routing(fn):
    """``fn()`` with each MoE routing's expert choices and dropped pairs
    recorded (host reads): returns ``fn()``'s result and ``[(top_idx, dropped)]``."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.route
    seen = []

    def recording(*a, **k):
        r = real(*a, **k)
        seen.append((r.top_idx.cpu(), int((~r.keep).sum())))
        return r

    moe_mod.route = recording
    try:
        return fn(), seen
    finally:
        moe_mod.route = real


def _train_close(label, got: dict, want: dict):
    """Metrics of two runs of one step within ``TRAIN_RTOL``/``TRAIN_ATOL``."""
    bad = {k: (float(got[k]), float(want[k])) for k in want
           if not math.isclose(float(got[k]), float(want[k]), rel_tol=TRAIN_RTOL,
                               abs_tol=TRAIN_ATOL)}
    shown = ", ".join(f"{k} {float(got[k]):.6g} / {float(want[k]):.6g}" for k in sorted(want))
    _log(f"{label}: {shown} (rtol {TRAIN_RTOL:g}, atol {TRAIN_ATOL:g}) "
         f"{'ok' if not bad and set(got) == set(want) else 'FAIL'}")
    if bad or set(got) != set(want):
        raise SystemExit(f"{label}: metrics disagree {bad}")


def _train_update_close(label, got: dict, want: dict, grads: dict, lr: float) -> None:
    """Updated parameters at the fp32 bound plus AdamW's first-step
    allowance of 2 * lr where the gradient is below ``TRAIN_SIGN_NOISE`` of
    its leaf's largest."""
    import numpy as np

    worst, allowed = 0.0, 0
    for k in want:
        g = np.abs(grads[k])
        small = g < TRAIN_SIGN_NOISE * g.max()
        diff = np.abs(got[k] - want[k])
        over = diff > TRAIN_ATOL + TRAIN_RTOL * np.abs(want[k]) + np.where(small, 2 * lr, 0.0)
        if over.any():
            raise SystemExit(f"{label}: {k} updated by {float(diff.max()):.3e} more")
        worst = max(worst, float(diff[~small].max()) if (~small).any() else 0.0)
        allowed += int(small.sum())
    _log(f"{label}: updated parameters max |diff| {worst:.3e} where |g| >= {TRAIN_SIGN_NOISE:g} "
         f"of its leaf's largest ({allowed} entries below, allowed 2 * lr) ok")


def _train_grads_close(label, got: dict, want: dict) -> None:
    import numpy as np

    rel = {k: float(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30))
           for k in want}
    worst = max(rel, key=rel.get)
    ok = set(got) == set(want) and rel[worst] < TRAIN_GRAD_REL
    _log(f"{label}: {len(rel)} gradient leaves, largest norm-wise relative error "
         f"{rel[worst]:.3e} ({worst}; bound {TRAIN_GRAD_REL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: gradients disagree")


def _host(tree):
    import numpy as np

    from repro_torch import _tree

    return _tree.flatten(tree, lambda t: t.detach().cpu().numpy(), np.stack)


# Device kernels by kind, by a substring of the name, in this order: the
# GEMMs (cuBLAS's nvjet and cutlass kernels), the softmax, copies and dtype
# casts (copy kernels, device-to-device memcpy), and the rest (elementwise
# arithmetic, reductions, indexing).
_KINDS = (("GEMMs", ("nvjet", "gemm", "cutlass")), ("softmax", ("softmax",)),
          ("copies and casts", ("copy", "Memcpy")))


def _log_kinds(label: str, evs, smi: str) -> None:
    """Device time of a traced call by kind of kernel (``_KINDS``)."""
    sums = {name: 0.0 for name, _ in _KINDS}
    sums["other"] = 0.0
    for a, b, name in evs:
        kind = next((k for k, heads in _KINDS if any(h in name for h in heads)), "other")
        sums[kind] += b - a
    total = sum(sums.values())
    _log(f"{label}: device time by kind: " + ", ".join(
        f"{k} {v / 1e3:.1f} ms ({100 * v / total:.1f}%)" for k, v in sums.items())
        + f"; card {smi}")


def _train_full(torch, args, dev, smi) -> None:
    """16a: olmo-1b at full width and depth, bf16 compute over fp32
    parameters, remat on: steps of ``make_train_step`` timed with CUDA
    events, against ``model_flops`` and the BF16 peak; a traced step."""
    from repro_torch import _tree
    from repro_torch.analysis import flops
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("olmo-1b")
    n_params = flops.param_count(cfg)
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    step_flops = flops.model_flops(cfg, shape)
    _log(f"[16a] olmo-1b training: {cfg.n_layers} layers x {cfg.d_model}, vocab {cfg.vocab}, "
         f"{cfg.compute_dtype} compute over {cfg.param_dtype} parameters, remat {cfg.remat}; "
         f"analysis.flops.param_count {n_params:,} (reference {OLMO_1B_PARAMS:,}); global batch "
         f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_ACCUM} micro-batches; training state "
         f"{n_params * flops.bytes_per_param(cfg, True) / 1e9:.2f} GB by bytes_per_param")
    if n_params != OLMO_1B_PARAMS:
        raise SystemExit(f"param_count(olmo-1b) is {n_params}, not {OLMO_1B_PARAMS}")
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed))
    n_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    batches = [_train_batch(torch, cfg, data, i, dev, args.seed) for i in range(n_steps)]
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    step = make_train_step(model, opt_cfg, accum_steps=TRAIN_ACCUM)
    p, s = model.params, init_opt_state(model.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    mets = []
    t0 = time.perf_counter()
    ev[0].record()
    for i, batch in enumerate(batches):
        p, s, met = step(p, s, batch)
        ev[i + 1].record()
        mets.append(met)
        if i == 0:
            moved = [not torch.equal(a, b) for a, b in zip(_tree.leaves(model.params),
                                                          _tree.leaves(p))]
        if i + 1 == TRAIN_WARMUP_STEPS:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t_timed) / TRAIN_TIMED_STEPS
    first_s = ev[0].elapsed_time(ev[1]) / 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_WARMUP_STEPS, n_steps)]
    losses = [float(m["loss"]) for m in mets]
    norms = [float(m["grad_norm"]) for m in mets]
    mean_ms = sum(ms) / len(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    _log(f"[16a] losses {[round(x, 4) for x in losses]}; grad norms "
         f"{[round(x, 4) for x in norms]}; lr {float(mets[-1]['lr']):.3g}")
    _log(f"[16a] step {mean_ms:.1f} ms (CUDA events, {TRAIN_TIMED_STEPS} steps after "
         f"{TRAIN_WARMUP_STEPS}: median {_median(ms):.1f}, min {min(ms):.1f}, max {max(ms):.1f}; "
         f"first step {first_s:.2f} s; host clock {host_s * 1e3:.1f} ms a step); "
         f"{tokens / (mean_ms / 1e3):,.0f} tokens/s; model_flops 6 N D = {step_flops:.4g} a step, "
         f"{step_flops / (mean_ms / 1e3) / 1e12:.1f} TFLOP/s = "
         f"{100 * step_flops / (mean_ms / 1e3) / BF16_PEAK_FLOPS:.1f}% of the nominal "
         f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s BF16 peak (bound {step_flops / BF16_PEAK_FLOPS * 1e3:.1f}"
         f" ms); peak memory {peak:.2f} GB; wall {time.perf_counter() - t0:.1f} s; card {smi}")
    finite = all(math.isfinite(x) for x in losses + norms)
    _log(f"[16a] loss and grad norm finite every step: {'ok' if finite else 'FAIL'}; every one of "
         f"{len(moved)} leaves moved by the first step: {'ok' if all(moved) else 'FAIL'}; last "
         f"loss {losses[-1]:.4f} below the first {losses[0]:.4f}: "
         f"{'ok' if losses[-1] < losses[0] else 'FAIL'}")
    if not finite or not all(moved) or not losses[-1] < losses[0]:
        raise SystemExit("olmo-1b training: non-finite, a leaf unmoved or the loss not lower")
    wall, evs = _trace(torch, lambda: step(p, s, batches[-1]))
    _log_trace("[16a] olmo-1b train step (traced)", wall, evs, 1, smi, unit="step")
    _log_kinds("[16a] olmo-1b train step (traced)", evs, smi)
    del p, s, mets, batches, model, step
    torch.cuda.empty_cache()


def _train_small(torch, args, dev, smi) -> None:
    """16b: olmo-1b's width cut to 2 layers in fp32 compute: a step on the
    card against the port's CPU step, accumulation, remat, and the
    fault-tolerant loop bitwise its unfaulted run."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import _tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    small = dataclasses.replace(get_config("olmo-1b"), n_layers=TRAIN_SMALL_LAYERS,
                                compute_dtype="float32")
    cpu = build_model(small, device="cpu", generator=torch.Generator().manual_seed(args.seed))
    card = build_model(small, device=dev)
    card.load_state_dict(cpu.state_dict())
    data = SyntheticLM(DataConfig(small.vocab, TRAIN_SMALL_SEQ, TRAIN_SMALL_BATCH, seed=args.seed))
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    runs = {}
    for where, m in (("cpu", cpu), ("card", card)):
        t0 = time.perf_counter()
        batch = _train_batch(torch, small, data, 0, m.device, args.seed)
        (p2, s2, met), grads = _with_grads(
            lambda: make_train_step(m, opt_cfg)(m.params, init_opt_state(m.params), batch))
        runs[where] = (_host(p2), met, grads[0])
        _log(f"[16b] olmo-1b {TRAIN_SMALL_LAYERS} layers fp32, one step of "
             f"{TRAIN_SMALL_BATCH} x {TRAIN_SMALL_SEQ} on the {where}: "
             f"{time.perf_counter() - t0:.2f} s (host clock, its first step)")
        del p2, s2
    label = f"[16b] olmo-1b {TRAIN_SMALL_LAYERS} layers, card vs CPU"
    _train_close(label, runs["card"][1], runs["cpu"][1])
    _train_grads_close(label, runs["card"][2], runs["cpu"][2])
    _train_update_close(label, runs["card"][0], runs["cpu"][0], runs["cpu"][2], TRAIN_LR)
    del cpu, runs

    # accumulation over 2 micro-batches against one batch, and remat on against off
    batch = _train_batch(torch, small, data, 0, dev, args.seed)
    no_remat = build_model(dataclasses.replace(small, remat=False), device="meta")
    out = {}
    for key, m, accum in (("one", card, 1), ("accum", card, 2), ("no_remat", no_remat, 1)):
        out[key] = make_train_step(m, opt_cfg, accum_steps=accum)(
            card.params, init_opt_state(card.params), batch)
    d = max(float((a - b).detach().abs().max()) for a, b in zip(_tree.leaves(out["one"][0]),
                                                               _tree.leaves(out["accum"][0])))
    _log(f"[16b] accum_steps 2 against 1: updated parameters max |diff| {d:.3e} (bound "
         f"{TRAIN_ACCUM_BOUND:g}) {'ok' if d < TRAIN_ACCUM_BOUND else 'FAIL'}")
    same = all(torch.equal(a, b) for a, b in zip(_tree.leaves(out["one"]),
                                                 _tree.leaves(out["no_remat"])))
    _log(f"[16b] remat on against off: parameters, optimizer state and metrics bitwise: "
         f"{'ok' if same else 'FAIL'}")
    if d >= TRAIN_ACCUM_BOUND or not same:
        raise SystemExit("olmo-1b 2 layers: accumulation or remat changed the step")
    del out, batch

    # the fault-tolerant loop: a fault at TRAIN_FAULT_STEP, bitwise the unfaulted run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        armed = [True]

        def fault(step):
            if step == TRAIN_FAULT_STEP and armed[0]:
                armed[0] = False
                raise RuntimeError("injected fault")

        res, final = {}, {}
        for key, hook in (("clean", None), ("faulted", fault)):
            t0 = time.perf_counter()
            res[key] = train_loop(card, data, OptConfig(lr=TRAIN_LR, warmup_steps=0),
                                  LoopConfig(total_steps=TRAIN_LOOP_STEPS,
                                             ckpt_every=TRAIN_CKPT_EVERY,
                                             ckpt_dir=os.path.join(tmp, key)),
                                  params=card.params, fault_hook=hook)
            loop_s = time.perf_counter() - t0
            mgr = CheckpointManager(os.path.join(tmp, key))
            t0 = time.perf_counter()
            (fp, fs), manifest = mgr.restore((card.params, init_opt_state(card.params)))
            restore_s = time.perf_counter() - t0
            final[key] = _tree.leaves((fp, fs))
            size = sum(f.stat().st_size for f in Path(tmp, key, f"step_{manifest['step']:08d}")
                       .iterdir()) / 1e9
            _log(f"[16b] train_loop {key}: {TRAIN_LOOP_STEPS} steps, checkpoint every "
                 f"{TRAIN_CKPT_EVERY}, in {loop_s:.1f} s; steps "
                 f"{[m['step'] for m in res[key].metrics_history]}, failures "
                 f"{res[key].failures}; its step-{manifest['step']} checkpoint {size:.2f} GB "
                 f"restored in {restore_s:.1f} s")
        hist = res["faulted"].metrics_history
        by_step = {m["step"]: m["loss"] for m in res["clean"].metrics_history}
        replay = [m["step"] for m in hist] == [1, 2, 3, 4, 5, 4, 5, 6, 7, 8]
        same_loss = all(m["loss"] == by_step[m["step"]] for m in hist)
        same_state = len(final["clean"]) == len(final["faulted"]) and all(
            torch.equal(a, b) for a, b in zip(final["clean"], final["faulted"]))
        ok = (res["faulted"].failures == 1 and res["clean"].failures == 0 and replay
              and same_loss and same_state and res["faulted"].step == TRAIN_LOOP_STEPS)
        _log(f"[16b] fault at step {TRAIN_FAULT_STEP}: failures {res['faulted'].failures}, steps 4 "
             f"and 5 replayed from the step-3 checkpoint {replay}, every loss bitwise the "
             f"unfaulted run's {same_loss}, the step-{TRAIN_LOOP_STEPS} parameters and optimizer "
             f"state bitwise {same_state}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the faulted training run is not the unfaulted one")
        t0 = time.perf_counter()
        path = CheckpointManager(os.path.join(tmp, "save")).save(1, (card.params,
                                                                    init_opt_state(card.params)))
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir()) / 1e9
        _log(f"[16b] a checkpoint of the {TRAIN_SMALL_LAYERS}-layer state: {size:.2f} GB saved in "
             f"{save_s:.1f} s (synchronous); card {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del card, final
    torch.cuda.empty_cache()


def _train_families(torch, args, dev, smi) -> None:
    """16c: one fp32 step of the SSM, hybrid, MoE and enc-dec families on
    the card against the port's CPU step (loss and metrics; the MoE's
    routing and drops equal on both)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    for name, layers in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(name), compute_dtype="float32",
                                  **({"n_layers": layers} if layers else {}))
        data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_BATCH,
                                      seed=args.seed))
        cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(args.seed))
        n = count_params(cpu.params)
        state = cpu.state_dict()
        runs = {}
        for where in ("cpu", "card"):
            m = cpu if where == "cpu" else build_model(cfg, device=dev)
            if where == "card":
                m.load_state_dict(state)
                del state
            batch = _train_batch(torch, cfg, data, 0, m.device, args.seed)
            t0 = time.perf_counter()
            (_, _, met), routes = _with_routing(
                lambda: make_train_step(m, opt_cfg)(m.params, init_opt_state(m.params), batch))
            secs = time.perf_counter() - t0
            runs[where] = ({k: float(v) for k, v in met.items()}, routes, secs)
            del m, batch, met
            if where == "cpu":
                del cpu
        what = f"{cfg.n_layers} layers" if layers else "whole"
        label = (f"[16c] {name} ({what}, {n:,} params) fp32 step of {TRAIN_FAMILY_BATCH} x "
                 f"{TRAIN_FAMILY_SEQ}, card ({runs['card'][2]:.2f} s) vs CPU "
                 f"({runs['cpu'][2]:.2f} s)")
        _train_close(label, runs["card"][0], runs["cpu"][0])
        if cfg.n_experts:
            (_, rc, _), (_, rg, _) = runs["cpu"], runs["card"]
            same = len(rc) == len(rg) and all(torch.equal(a[0], b[0]) and a[1] == b[1]
                                              for a, b in zip(rc, rg))
            _log(f"[16c] {name}: {len(rg)} routings (forward and remat's recomputation), top-"
                 f"{cfg.n_experts_per_tok} experts equal on card and CPU, pairs dropped at "
                 f"capacity {[d for _, d in rg]} on the card, {[d for _, d in rc]} on the CPU: "
                 f"{'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"{name}: the card routes otherwise than the CPU")
        torch.cuda.empty_cache()
    _log(f"[16c] families' backward on the card; card {smi}")


def _run_drivers(torch, dev, tmp, train_flags=(), serve_flags=()):
    """``launch.train`` of olmo-1b at full width and depth into ``tmp``
    (``TRAIN_DRIVER_STEPS`` steps of ``TRAIN_DRIVER_BATCH`` x ``TRAIN_SEQ``,
    a checkpoint at the last), then ``launch.serve --ckpt-dir tmp`` of 4
    requests, each with its extra flags: returns the loop's result, the
    trained and the served parameters (each as the step and the engine
    hold them), the served tokens, the serve driver's log lines, and the
    seconds and peak GB of each driver."""
    import logging

    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import loop as loop_mod

    trained, served, logged = [], [], []
    real_step, real_engine = loop_mod.make_train_step, engine_mod.ServeEngine

    def recording_step(*a, **k):
        step = real_step(*a, **k)

        def run(p, s, batch):
            out = step(p, s, batch)
            trained[:] = [out[0]]
            return out

        return run

    class RecordingEngine(real_engine):
        def __post_init__(self):
            served.append(self.params)
            super().__post_init__()

    class Lines(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    handler = Lines()
    logging.getLogger("repro_torch.launch.serve").addHandler(handler)
    loop_mod.make_train_step, engine_mod.ServeEngine = recording_step, RecordingEngine
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_driver.main(["--arch", "olmo-1b", "--steps", str(TRAIN_DRIVER_STEPS),
                                 "--batch", str(TRAIN_DRIVER_BATCH), "--seq", str(TRAIN_SEQ),
                                 "--ckpt-every", str(TRAIN_DRIVER_STEPS), "--ckpt-dir", tmp,
                                 "--device", str(dev), *train_flags])
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = serve_driver.main(["--arch", "olmo-1b", "--requests", "4", "--ckpt-dir", tmp,
                                 "--device", str(dev), *serve_flags])
        serve_s = time.perf_counter() - t0
        serve_peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        loop_mod.make_train_step, engine_mod.ServeEngine = real_step, real_engine
        logging.getLogger("repro_torch.launch.serve").removeHandler(handler)
    return dict(res=res, trained=trained, served=served, out=out, logged=logged,
                train_s=train_s, train_peak=train_peak, serve_s=serve_s, serve_peak=serve_peak)


# 16d's run, kept for phase 17b's bitwise comparison: the trained parameters
# (in host memory), the served tokens and the step seconds
_DRIVER_RUN: dict = {}


def _train_drivers(torch, args, dev, smi) -> None:
    """16d: ``launch.train`` trains olmo-1b at full width and depth on the
    card, writing its checkpoints; ``launch.serve --ckpt-dir`` restores the
    last and serves it: the served parameters are the trained ones, bitwise."""
    import shutil
    import tempfile

    from repro_torch import _tree

    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    try:
        run = _run_drivers(torch, dev, tmp)
        steps = sorted(os.listdir(tmp))
        size = sum(f.stat().st_size for f in Path(tmp, steps[-1]).iterdir()) / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res, trained, served, out = run["res"], run["trained"], run["served"], run["out"]
    restored = [line for line in run["logged"] if line.startswith("restored step")]
    same = len(served) == 1 and len(trained) == 1 and all(
        torch.equal(a, b) for a, b in zip(_tree.leaves(trained[0]), _tree.leaves(served[0])))
    ok = (res.step == TRAIN_DRIVER_STEPS and res.failures == 0 and len(out) == 4
          and restored and restored[0].startswith(f"restored step {TRAIN_DRIVER_STEPS} ")
          and same)
    _log(f"[16d] launch.train olmo-1b --steps {TRAIN_DRIVER_STEPS} --batch {TRAIN_DRIVER_BATCH} "
         f"--seq {TRAIN_SEQ}: {run['train_s']:.1f} s (build, {TRAIN_DRIVER_STEPS} steps and the "
         f"checkpoints {steps}, {size:.2f} GB each), losses "
         f"{[round(m['loss'], 4) for m in res.metrics_history]}, step seconds (host clock) "
         f"{[round(m['seconds'], 3) for m in res.metrics_history]}, peak memory "
         f"{run['train_peak']:.2f} GB; launch.serve --ckpt-dir: {restored[:1]}, {len(out)} "
         f"requests served in {run['serve_s']:.1f} s (peak {run['serve_peak']:.2f} GB); the "
         f"served parameters bitwise the trained ones {same}: {'ok' if ok else 'FAIL'}; "
         f"card {smi}")
    if not ok:
        raise SystemExit("launch.serve did not serve what launch.train trained")
    _DRIVER_RUN.update(params=_tree.tree_map(lambda t: t.detach().cpu(), trained[0]), tokens=out,
                       step_s=[m["seconds"] for m in res.metrics_history],
                       losses=[m["loss"] for m in res.metrics_history])
    del trained, served, run
    torch.cuda.empty_cache()


def _train_phase(torch, args, dev, smi) -> None:
    """Phase 16: the LM training path on the card (see the module
    docstring).  Each model is freed before the next; catches nothing."""
    t_phase = time.perf_counter()
    for part in (_train_full, _train_small, _train_families, _train_drivers):
        t0 = time.perf_counter()
        part(torch, args, dev, smi)
        _log(f"[16] {part.__name__}: {time.perf_counter() - t0:.1f} s")
    _log(f"[16] LM training phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


# ---- phase 17: the sharded LM in an NCCL world of one
# 17a: olmo-1b at full width and depth, 8 steps of 4 x 2048 tokens from one
# init, make_train_step locally and make_compressed_dp_step exact and int8.
SHARDED_STEPS = 8
SHARDED_BATCH = 4
SHARDED_GAP = 0.3  # the reference's own criterion (tests/dist_worker.py)


def _sharded_dp(torch, args, dev, smi, mesh) -> None:
    """17a: ``make_compressed_dp_step`` exact and compressed against
    ``make_train_step`` on one mesh of one rank: the exact run bitwise the
    local one, the compressed run's last loss within ``SHARDED_GAP``, one
    int8 gather a reference leaf a step, every residual leaf nonzero after
    step 1."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives as coll
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("olmo-1b")
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, SHARDED_BATCH, seed=args.seed))
    batches = [_train_batch(torch, cfg, data, i, dev, args.seed) for i in range(SHARDED_STEPS)]
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    n_leaves = len(_tree.flatten(model.params, lambda x: x, lambda xs: xs))
    runs = {}
    for label in ("local", "exact", "compressed"):
        p = model.params
        s = init_opt_state(p)
        if label == "local":
            step = make_train_step(model, opt_cfg)
        else:
            err = coll.init_error_state(p, mesh)
            dp_step = coll.make_compressed_dp_step(model, opt_cfg, mesh,
                                                   compress=label == "compressed")
        coll.INT8_GATHERS.calls = coll.INT8_GATHERS.bytes = coll.GATHERS.calls = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(SHARDED_STEPS + 1)]
        losses, nonzero = [], None
        t0 = time.perf_counter()
        ev[0].record()
        for i, batch in enumerate(batches):
            if label == "local":
                p, s, met = step(p, s, batch)
            else:
                p, s, err, met = dp_step(p, s, err, batch)
            ev[i + 1].record()
            losses.append(met["loss"])
            if i == 0 and label == "compressed":
                nonzero = all(bool(e.abs().max() > 0) for e in _tree.leaves(err))
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(1, SHARDED_STEPS)]
        runs[label] = dict(losses=[float(x) for x in losses], ms=ms,
                           wall=time.perf_counter() - t0,
                           peak=torch.cuda.max_memory_allocated() / 1e9,
                           int8=(coll.INT8_GATHERS.calls, coll.INT8_GATHERS.bytes),
                           gathers=coll.GATHERS.calls, nonzero=nonzero)
        del s
        if label != "local":
            del err
        if label == "local":
            local_p = p
        elif label == "exact":  # compared now, so the compressed run has the memory
            same_p = all(torch.equal(a, b) for a, b in zip(_tree.leaves(p),
                                                           _tree.leaves(local_p)))
            del local_p
        del p
        torch.cuda.empty_cache()
    local, exact, comp = runs["local"], runs["exact"], runs["compressed"]
    bitwise = exact["losses"] == local["losses"] and same_p
    finite = all(math.isfinite(x) for r in runs.values() for x in r["losses"])
    gap = abs(comp["losses"][-1] - exact["losses"][-1])
    int8_ok = comp["int8"][0] == n_leaves * SHARDED_STEPS and exact["int8"][0] == 0
    for label, r in runs.items():
        _log(f"[17a] {label}: losses {[round(x, 4) for x in r['losses']]}; step "
             f"{sum(r['ms']) / len(r['ms']):.1f} ms (CUDA events, steps 2-{SHARDED_STEPS}: median "
             f"{_median(r['ms']):.1f}, min {min(r['ms']):.1f}, max {max(r['ms']):.1f}); wall "
             f"{r['wall']:.1f} s; peak memory {r['peak']:.2f} GB; gathers {r['gathers']}; int8 "
             f"gathers {r['int8'][0]} ({r['int8'][0] // SHARDED_STEPS} a step, "
             f"{r['int8'][1] / SHARDED_STEPS / 1e9:.3f} GB a step); card {smi}")
    ok = bitwise and finite and gap < SHARDED_GAP and int8_ok and comp["nonzero"]
    _log(f"[17a] olmo-1b {SHARDED_BATCH} x {TRAIN_SEQ}, {SHARDED_STEPS} steps: exact DP step bitwise "
         f"make_train_step (losses and every parameter) {bitwise}; losses finite {finite}; "
         f"compressed last loss {comp['losses'][-1]:.4f} against exact {exact['losses'][-1]:.4f} "
         f"(gap {gap:.4f} < {SHARDED_GAP}); int8 gathers one a reference leaf a step "
         f"({n_leaves} leaves) {int8_ok}; every residual leaf nonzero after step 1 "
         f"{comp['nonzero']}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("17a: the data-parallel steps failed their gates")
    del runs, local, exact, comp, model, batches
    torch.cuda.empty_cache()


def _sharded_drivers(torch, args, dev, smi, mesh) -> None:
    """17b: ``launch.train --distributed --dp 1 --tp 1`` bitwise 16d's local
    run, through the sharded path's collectives; its checkpoint restored
    onto the mesh bitwise; ``launch.serve --distributed --tp 1 --ckpt-dir``
    serving 16d's tokens."""
    import shutil
    import tempfile

    from repro_torch import _tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptState, init_opt_state

    counts = (coll.TP, coll.GATHERS, coll.SCATTERS)
    for c in counts:
        c.calls = c.bytes = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_driver_")
    try:
        run = _run_drivers(torch, dev, tmp, ("--distributed", "--dp", "1", "--tp", "1"),
                           ("--distributed", "--tp", "1"))
        calls = [c.calls for c in counts]
        res, trained = run["res"], run["trained"][0]
        model = build_model(get_config("olmo-1b"), device="meta")
        specs = model.partition_specs(mesh)
        template = model.params  # shapes and dtypes only: the leaves land on the mesh's device
        t0 = time.perf_counter()
        (restored, _), manifest = CheckpointManager(tmp).restore(
            (template, init_opt_state(template)), mesh=mesh,
            specs=(specs, OptState((), specs, specs)))
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    local = _DRIVER_RUN
    bitwise = all(torch.equal(a.cpu(), b) for a, b in zip(_tree.leaves(trained),
                                                          _tree.leaves(local["params"])))
    restored_ok = manifest["step"] == TRAIN_DRIVER_STEPS and all(
        torch.equal(a, b) for a, b in zip(_tree.leaves(restored), _tree.leaves(trained)))
    served = run["out"]
    tokens_ok = sorted(served) == sorted(local["tokens"]) and all(
        (served[k] == local["tokens"][k]).all() for k in served)
    ok = (res.step == TRAIN_DRIVER_STEPS and res.failures == 0 and bitwise and all(calls)
          and restored_ok and tokens_ok)
    step_s = [m["seconds"] for m in res.metrics_history]
    _log(f"[17b] launch.train --distributed --dp 1 --tp 1 olmo-1b: {run['train_s']:.1f} s, losses "
         f"{[round(m['loss'], 4) for m in res.metrics_history]} (16d "
         f"{[round(x, 4) for x in local['losses']]}), step seconds (host clock) "
         f"{[round(x, 3) for x in step_s]} against 16d's {[round(x, 3) for x in local['step_s']]}, "
         f"peak memory {run['train_peak']:.2f} GB; collectives of the sharded path (TP, gathers, "
         f"reduce-scatters) {calls}; the parameters bitwise 16d's {bitwise}; the checkpoint "
         f"restored onto the mesh with partition_specs bitwise {restored_ok} ({restore_s:.1f} s); "
         f"launch.serve --distributed --tp 1 --ckpt-dir served 16d's tokens {tokens_ok} "
         f"({run['serve_s']:.1f} s, peak {run['serve_peak']:.2f} GB): {'ok' if ok else 'FAIL'}; "
         f"card {smi}")
    if not ok:
        raise SystemExit("17b: the sharded drivers differ from the local ones")
    del run, trained, restored, template
    torch.cuda.empty_cache()


def _sharded_lm_phase(torch, args, dev, smi) -> None:
    """Phase 17: the sharded LM in an NCCL world of one (see the module
    docstring).  NCCL failing to start fails the run; nothing falls back."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    if not _DRIVER_RUN:  # run alone: 16d's local run first, its gates included
        _train_drivers(torch, args, dev, smi)
    store = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        tdist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                 world_size=1)
        mesh = make_host_mesh(1, 1, device="cuda")
        probe = torch.ones(4, device=dev)
        tdist.all_gather([torch.empty_like(probe)], probe, group=mesh.get_group("model"))
        torch.cuda.synchronize()
    except Exception as e:  # no fallback: the phase fails
        shutil.rmtree(store, ignore_errors=True)
        raise SystemExit(f"[17] NCCL failed to start: {type(e).__name__}: {e}")
    _log(f"[17] NCCL world of 1 (backend {tdist.get_backend()}), mesh {mesh.mesh_dim_names} "
         f"{tuple(mesh.shape)}")
    try:
        for part in (_sharded_dp, _sharded_drivers):
            t0 = time.perf_counter()
            part(torch, args, dev, smi, mesh)
            _log(f"[17] {part.__name__}: {time.perf_counter() - t0:.1f} s")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    _DRIVER_RUN.clear()
    torch.cuda.empty_cache()
    _log(f"[17] sharded LM phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


# ---- phase 18: the other families on the mesh (NCCL world of one)
# The layer function of each family whose TP collectives phase 18 counts.
SHARDED_FAMILY_LAYERS = {"ssm": ("ssm", "ssm_apply"), "hybrid": ("rglru", "rglru_apply"),
                         "moe": ("moe", "moe_apply"), "encdec": ("attention", "cross_attn")}


def _tp_inside(family: str):
    """A context that counts the ``dist.TP`` collectives made inside the
    family's layer function (``SHARDED_FAMILY_LAYERS``): yields a one-item
    list holding the count."""
    import contextlib
    import importlib

    from repro_torch.dist import collectives as coll

    module_name, fn_name = SHARDED_FAMILY_LAYERS[family]
    module = importlib.import_module(f"repro_torch.models.{module_name}")
    real, count = getattr(module, fn_name), [0]

    def counting(*a, **k):
        before = coll.TP.calls
        try:
            return real(*a, **k)
        finally:
            count[0] += coll.TP.calls - before

    @contextlib.contextmanager
    def ctx():
        setattr(module, fn_name, counting)
        try:
            yield count
        finally:
            setattr(module, fn_name, real)

    return ctx()


def _decode_ms(torch, model, params, batch, steps):
    """``(prefill logits, decode ms a token, dist.TP collectives a decode
    step)``: a prefill and ``steps`` greedy decode steps timed with CUDA
    events."""
    from repro_torch.dist import collectives as coll

    s = batch["tokens"].shape[1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    cache, logits = model.prefill(params, batch, max_len=s + steps + 1)
    first = logits
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    calls = coll.TP.calls
    ev[0].record()
    for i in range(steps):
        logits, cache = model.decode_step(params, tok, cache)
        ev[i + 1].record()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    return first, [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)], (
        (coll.TP.calls - calls) // steps)


def _sharded_family_serve(torch, args, dev, smi, mesh, name, layers) -> None:
    """18a: one family served at full width on the mesh and locally."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model

    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    prompts = _lm_requests(cfg.vocab, args.seed, LM_REQUESTS)
    batch = _family_batch(torch, cfg, prompts[:LM_BATCH], dev)
    runs = {}
    for where in ("local", "mesh"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            params = model.params
            count = [0]
            if where == "mesh":
                stack.enter_context(meshlib.use_mesh(mesh))
                params = meshlib.shard_tree(params, model.partition_specs(mesh, drop_fsdp=True),
                                            mesh)
                count = stack.enter_context(_tp_inside(cfg.family))
            rids, served = _lm_serve(model, params, prompts)
            with torch.no_grad():
                logits, ms, per_step = _decode_ms(torch, model, params, batch, LM_NEW_TOKENS)
        runs[where] = dict(rids=rids, served=served, logits=logits.float(), ms=ms,
                           peak=torch.cuda.max_memory_allocated() / 1e9, tp=count[0],
                           per_step=per_step)
    local, sharded = runs["local"], runs["mesh"]
    _lm_check_served(f"[18a] {name} on the mesh", sharded["rids"], sharded["served"], cfg.vocab)
    same_tokens = local["rids"] == sharded["rids"] and all(
        np.array_equal(local["served"][r], sharded["served"][r]) for r in local["served"])
    bitwise = torch.equal(local["logits"], sharded["logits"])
    diff = float((local["logits"] - sharded["logits"]).abs().max())
    close = bitwise or diff <= LM_LOGIT_TOL
    ok = same_tokens and close and sharded["tp"] > 0
    what = f"{cfg.n_layers} layers" if layers else "whole"
    extra = sum(sharded["ms"]) / len(sharded["ms"]) - sum(local["ms"]) / len(local["ms"])
    _log(f"[18a] {name}: {sharded['per_step']} ordered collectives a decode step on the mesh; "
         f"the mesh's extra {extra:.3f} ms a token is {extra / max(sharded['per_step'], 1):.3f} "
         f"ms a collective; card {smi}")
    _log(f"[18a] {name} ({what}, {cfg.compute_dtype} over {cfg.param_dtype}) served on the mesh "
         f"against a local engine: greedy tokens of {len(prompts)} requests equal {same_tokens}; "
         f"prefill logits {'bitwise equal' if bitwise else f'differ, max |diff| {diff:.3e} (bound {LM_LOGIT_TOL:g})'}; "
         f"TP collectives inside its {SHARDED_FAMILY_LAYERS[cfg.family][1]} {sharded['tp']}; "
         f"decode {sum(sharded['ms']) / len(sharded['ms']):.3f} ms a token on the mesh (median "
         f"{_median(sharded['ms']):.3f}) against {sum(local['ms']) / len(local['ms']):.3f} locally "
         f"(median {_median(local['ms']):.3f}), CUDA events, batch {LM_BATCH}; peak memory "
         f"{sharded['peak']:.2f} GB on the mesh, {local['peak']:.2f} GB locally: "
         f"{'ok' if ok else 'FAIL'}; card {smi}")
    if not ok:
        raise SystemExit(f"18a: {name} served on the mesh differs from the local engine")
    del model, runs, local, sharded, batch
    torch.cuda.empty_cache()


def _sharded_family_train(torch, args, dev, smi, mesh, name, layers) -> None:
    """18b: one fp32 train step at full width on the mesh, bitwise the local one."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config(name), compute_dtype="float32",
                              **({"n_layers": layers} if layers else {}))
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_BATCH, seed=args.seed))
    batch = _train_batch(torch, cfg, data, 0, dev, args.seed)
    step = make_train_step(model, OptConfig(lr=TRAIN_LR, warmup_steps=0))
    runs = {}
    for where in ("local", "mesh"):
        params = model.params
        with contextlib.ExitStack() as stack:
            if where == "mesh":
                stack.enter_context(meshlib.use_mesh(mesh))
                params = meshlib.shard_tree(params, model.partition_specs(mesh, drop_fsdp=True),
                                            mesh)
            coll.TP.calls = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            p, state, met = step(params, init_opt_state(params), batch)
            ev[1].record()
            torch.cuda.synchronize()
        # the updated parameters kept in host memory (the card holds one step's state)
        runs[where] = dict(p=[t.cpu() for t in _tree.leaves(p)], loss=float(met["loss"]),
                           ms=ev[0].elapsed_time(ev[1]), tp=coll.TP.calls,
                           peak=torch.cuda.max_memory_allocated() / 1e9)
        del p, state, met
        torch.cuda.empty_cache()
    local, sharded = runs["local"], runs["mesh"]
    bitwise = sharded["loss"] == local["loss"] and all(
        torch.equal(a, b) for a, b in zip(sharded["p"], local["p"]))
    ok = bitwise and math.isfinite(local["loss"]) and sharded["tp"] > 0
    what = f"{cfg.n_layers} layers" if layers else "whole"
    _log(f"[18b] {name} ({what}, {count_params(model.params):,} params) fp32 step of "
         f"{TRAIN_FAMILY_BATCH} x {TRAIN_FAMILY_SEQ} on the mesh bitwise the local step (loss "
         f"{sharded['loss']:.6f}, every parameter) {bitwise}; TP collectives {sharded['tp']}; "
         f"step {sharded['ms']:.1f} ms on the mesh against {local['ms']:.1f} ms locally (CUDA "
         f"events, the first step of each); peak memory {sharded['peak']:.2f} GB on the mesh, "
         f"{local['peak']:.2f} GB locally: {'ok' if ok else 'FAIL'}; card {smi}")
    if not ok:
        raise SystemExit(f"18b: {name}'s step on the mesh differs from the local step")
    del model, runs, local, sharded, batch
    torch.cuda.empty_cache()


def _sharded_families_phase(torch, args, dev, smi) -> None:
    """Phase 18: the MoE, SSM, hybrid and enc-dec families on the mesh in an
    NCCL world of one (see the module docstring).  NCCL failing to start
    fails the run; nothing falls back."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    # earlier phases' garbage in reference cycles (16d's and 17b's recording
    # engine classes hold the served olmo-1b parameters, 4.7 GB each)
    held = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"[18] {held:.2f} GB allocated at the phase's start, "
         f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after a garbage collection")
    store = tempfile.mkdtemp(prefix="chip_smoke_families_")
    try:
        tdist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                 world_size=1)
        mesh = make_host_mesh(1, 1, device="cuda")
        probe = torch.ones(4, device=dev)
        tdist.all_gather([torch.empty_like(probe)], probe, group=mesh.get_group("model"))
        torch.cuda.synchronize()
    except Exception as e:  # no fallback: the phase fails
        shutil.rmtree(store, ignore_errors=True)
        raise SystemExit(f"[18] NCCL failed to start: {type(e).__name__}: {e}")
    _log(f"[18] NCCL world of 1 (backend {tdist.get_backend()}), mesh {mesh.mesh_dim_names} "
         f"{tuple(mesh.shape)}; a model axis above 1 and the query-row layout need a second "
         "rank (the CPU tests' 8-rank gloo worlds check them)")
    try:
        for _, name, layers, _ in FAMILIES:
            t0 = time.perf_counter()
            _sharded_family_serve(torch, args, dev, smi, mesh, name, layers)
            _log(f"[18a] {name}: {time.perf_counter() - t0:.1f} s")
        for name, layers in TRAIN_FAMILIES:
            t0 = time.perf_counter()
            _sharded_family_train(torch, args, dev, smi, mesh, name, layers)
            _log(f"[18b] {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    _log(f"[18] sharded families phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


# ---- phase 19: FSDP on the card and the dry-run against the card
# 19a/19b run in processes of their own (a process holds one default process
# group; 19b starts a fake world, then an NCCL one), started by this one.
# 19b: the dry-run's predicted peak (arguments + the storages the step holds
# at once) against the allocator's: the caching allocator rounds each block
# up to a multiple of 512 bytes, and the step's cuBLAS workspace comes from
# it too, beyond what the trace sees.  Measured on an NVIDIA H100 80GB HBM3
# at 700.00 W: 37.992 GB against 37.925 predicted, a gap of 0.18% (0.067
# GB); DRYRUN_PEAK_BOUND allows five times that.
DRYRUN_PEAK_BOUND = 0.01
DRYRUN_CELLS = (("olmo-1b", "train_4k"), ("qwen3-8b", "decode_32k"))
DRYRUN_PART_TIMEOUT = 300


def _part_env() -> dict:
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _spawn(cmd: list) -> subprocess.Popen:
    """Start ``cmd`` from the repo's root in a process group of its own (a
    launcher's workers included), its output captured."""
    return subprocess.Popen(cmd, cwd=ROOT, env=_part_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, process_group=0)


def _stop(proc: subprocess.Popen) -> None:
    """Kill ``proc``'s whole process group and reap ``proc``."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _reap(proc: subprocess.Popen, timeout: float) -> tuple[int, str, str]:
    """Wait for ``proc`` at most ``timeout`` seconds; a failure or the time
    limit kills its group.  Returns ``(exit code, stdout, stderr)``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop(proc)
        out, err = proc.communicate()
        return proc.returncode, out, f"ran over {timeout} s\n{err}"
    if proc.returncode != 0:
        _stop(proc)
    return proc.returncode, out, err


def _nccl_world_of_one(torch, dev, tag: str):
    """An NCCL world of one and its (1, 1) mesh; NCCL failing to start fails
    the part (nothing falls back).  Returns ``(mesh, store dir)``."""
    import tempfile

    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        tdist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                 world_size=1)
        mesh = make_host_mesh(1, 1, device="cuda")
        probe = torch.ones(4, device=dev)
        tdist.all_gather([torch.empty_like(probe)], probe, group=mesh.get_group("model"))
        torch.cuda.synchronize()
    except Exception as e:
        raise SystemExit(f"[{tag}] NCCL failed to start: {type(e).__name__}: {e}")
    return mesh, store


def _fsdp_part(torch, args, dev, smi) -> None:
    """19a: olmo-1b whole, bf16 compute over fp32 parameters, ``SHARDED_STEPS``
    steps of ``SHARDED_BATCH`` x ``TRAIN_SEQ`` tokens, as 17a: the local
    step, the ``drop_fsdp`` step on a (1, 1) mesh and the FSDP step there
    (``make_train_step(fsdp=True)``); gate: the FSDP run bitwise both (the
    losses and every parameter after the last step)."""
    import shutil

    import torch.distributed as tdist

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    mesh, store = _nccl_world_of_one(torch, dev, "19a")
    try:
        cfg = get_config("olmo-1b")
        model = build_model(cfg, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed))
        data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, SHARDED_BATCH, seed=args.seed))
        batches = [_train_batch(torch, cfg, data, i, dev, args.seed) for i in range(SHARDED_STEPS)]
        opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=0)
        runs, finals = {}, {}
        for label in ("local", "drop_fsdp", "fsdp"):
            if label == "local":
                p, ctx = model.params, contextlib.nullcontext()
                step = make_train_step(model, opt_cfg)
            else:
                specs = model.partition_specs(mesh, drop_fsdp=label == "drop_fsdp")
                p, ctx = meshlib.shard_tree(model.params, specs, mesh), meshlib.use_mesh(mesh)
                step = make_train_step(model, opt_cfg, fsdp=label == "fsdp")
            s = init_opt_state(p)
            coll.FSDP.calls = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(SHARDED_STEPS + 1)]
            losses = []
            with ctx:
                ev[0].record()
                for i, batch in enumerate(batches):
                    p, s, met = step(p, s, batch)
                    ev[i + 1].record()
                    losses.append(met["loss"])
            torch.cuda.synchronize()
            ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(1, SHARDED_STEPS)]
            runs[label] = dict(losses=[float(x) for x in losses], ms=ms,
                               peak=torch.cuda.max_memory_allocated() / 1e9,
                               fsdp=coll.FSDP.calls / SHARDED_STEPS)
            finals[label] = p
            del s
            if label == "drop_fsdp":  # compared now, so the FSDP run has the memory
                same_drop = all(torch.equal(a, b) for a, b in zip(
                    _tree.leaves(p), _tree.leaves(finals["local"])))
                finals.pop("drop_fsdp")
            elif label == "fsdp":
                same_fsdp = all(torch.equal(a, b) for a, b in zip(
                    _tree.leaves(p), _tree.leaves(finals["local"])))
            del p
            torch.cuda.empty_cache()
        del finals
        for label, r in runs.items():
            _log(f"[19a] {label}: losses {[round(x, 4) for x in r['losses']]}; step "
                 f"{sum(r['ms']) / len(r['ms']):.1f} ms (CUDA events, steps 2-{SHARDED_STEPS}: "
                 f"median {_median(r['ms']):.1f}, min {min(r['ms']):.1f}, max {max(r['ms']):.1f});"
                 f" peak memory {r['peak']:.2f} GB; fsdp_gather calls a step {r['fsdp']:.0f}; "
                 f"card {smi}")
        loc, drop, fsdp = runs["local"], runs["drop_fsdp"], runs["fsdp"]
        bitwise = fsdp["losses"] == loc["losses"] == drop["losses"] and same_fsdp and same_drop
        finite = all(math.isfinite(x) for r in runs.values() for x in r["losses"])
        ok = bitwise and finite and fsdp["fsdp"] > 0
        _log(f"[19a] olmo-1b {SHARDED_BATCH} x {TRAIN_SEQ}, {SHARDED_STEPS} steps on a (1, 1) "
             f"mesh: make_train_step(fsdp=True) bitwise the drop_fsdp and local steps (losses "
             f"and every parameter) {bitwise}; losses finite {finite}; fsdp_gather counted "
             f"{fsdp['fsdp'] > 0}; FSDP step {_median(fsdp['ms']):.1f} ms against local "
             f"{_median(loc['ms']):.1f} ms (medians): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("19a: the FSDP step failed its gates")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _dryrun_part(torch, args, dev, smi) -> None:
    """19b: 19a's FSDP step traced by the dry-run's counters on fake tensors
    in a fake world of one, then run on the card under the same counters in
    an NCCL world of one; gates: flops, bytes and collective operand bytes
    (over groups of one included) equal, the predicted peak within
    ``DRYRUN_PEAK_BOUND`` of the allocator's; printed: the step's
    ``RooflineTerms`` beside its measured ms."""
    import shutil

    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.flops import model_flops
    from repro_torch.analysis.roofline import terms_from_record
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("olmo-1b")
    shape = ShapeConfig("19b", TRAIN_SEQ, SHARDED_BATCH, "train")
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    dryrun.start_fake_world(1)
    try:
        mesh = meshlib.make_host_mesh(1, 1, device="cpu")
        with FakeTensorMode(), meshlib.use_mesh(mesh):
            meta = build_model(cfg, device="meta")
            fake_args = (specs.blocks(specs.param_structs(meta, mesh)),
                         specs.blocks(specs.opt_structs(meta, mesh)),
                         specs.blocks(specs.train_batch_structs(cfg, shape, mesh)))
            _, fake = dryrun.measure(make_train_step(meta, opt_cfg, fsdp=True), fake_args)
        del fake_args, meta
    finally:
        tdist.destroy_process_group()
    _log(f"[19b] fake trace (fake world of 1, (1, 1) mesh): {fake['trace_s']:.1f} s")

    mesh, store = _nccl_world_of_one(torch, dev, "19b")
    try:
        model = build_model(cfg, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed))
        data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, SHARDED_BATCH, seed=args.seed))
        batch = _train_batch(torch, cfg, data, 0, dev, args.seed)
        p = meshlib.shard_tree(model.params, model.partition_specs(mesh), mesh)
        s = init_opt_state(p)
        step = make_train_step(model, opt_cfg, fsdp=True)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with meshlib.use_mesh(mesh):
            out, real = dryrun.measure(step, (p, s, batch))
            torch.cuda.synchronize()
            step_peak = torch.cuda.max_memory_allocated() - held
            del out
            torch.cuda.empty_cache()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            for i in range(2):  # the step without the counters; the second one timed
                out = step(p, s, batch)
                ev[i + 1].record()
                del out
            torch.cuda.synchronize()
            ms = ev[1].elapsed_time(ev[2])
        args_b = real["argument_size_in_bytes"]
        predicted = fake["argument_size_in_bytes"] + fake["temp_size_in_bytes"]
        measured = args_b + step_peak
        gap = abs(measured - predicted) / predicted
        keys = ("flops", "bytes", "coll_bytes", "coll_issued_bytes", "coll_counts",
                "argument_size_in_bytes")
        same = {k: fake[k] == real[k] for k in keys}
        for k in keys:
            _log(f"[19b] {k}: fake {fake[k]} card {real[k]} equal {same[k]}")
        _log(f"[19b] temp: fake trace {fake['temp_size_in_bytes'] / 1e9:.4f} GB, the card's "
             f"storages {real['temp_size_in_bytes'] / 1e9:.4f} GB, the allocator's step peak "
             f"{step_peak / 1e9:.4f} GB above {held / 1e9:.4f} GB held before the step; "
             f"predicted peak (arguments + temp) {predicted / 1e9:.4f} GB against measured "
             f"{measured / 1e9:.4f} GB: gap {gap:.4%} (bound {DRYRUN_PEAK_BOUND:.0%})")
        record = {"chips": 1, "n_layers": cfg.n_layers, "accum_steps": 1,
                  "model_flops": model_flops(cfg, shape), "full": fake}
        t = terms_from_record(record)
        _log(f"[19b] RooflineTerms (dry-run, nominal H100 SXM datasheet constants, 700 W): "
             f"compute {t.compute_s * 1e3:.1f} ms, memory {t.memory_s * 1e3:.1f} ms, "
             f"collective {t.collective_s * 1e3:.3f} ms, bound {t.step_bound_s * 1e3:.1f} ms "
             f"({t.bottleneck}), mfu_bound {t.mfu_bound:.3f}, useful flops "
             f"{t.useful_flops_ratio:.3f}; measured step {ms:.1f} ms (CUDA events, no "
             f"counters; the counted run took {real['trace_s']:.1f} s of host clock); card {smi}")
        ok = all(same.values()) and gap <= DRYRUN_PEAK_BOUND
        _log(f"[19b] the fake trace is the card's program (flops, bytes, collectives equal) "
             f"{all(same.values())}; peak within bound {gap <= DRYRUN_PEAK_BOUND}: "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("19b: the dry-run disagrees with the card")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _run_part(part: str, args) -> None:
    """Run ``--part`` in a process of its own; its log lines are this
    phase's; a failure fails the phase."""
    rc, out, err = _reap(_spawn([sys.executable, str(ROOT / "chip_smoke.py"), "--part", part,
                                 "--seed", str(args.seed)]), DRYRUN_PART_TIMEOUT)
    for line in out.splitlines():
        if line.startswith(f"[{part}]"):
            _log(line)
    if rc != 0:
        raise SystemExit(f"[{part}] failed (exit {rc}):\n{err[-3000:]}")


def _start_cells() -> tuple[Path, list]:
    """19c's processes, started at once (on the host: they run beside 19a-b
    on the card): ``launch.dryrun`` of ``DRYRUN_CELLS`` and
    ``launch.dryrun_cp --method auto`` on the pod mesh."""
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_cells_"))
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", "pod", "--out", str(out)] for arch, shape in DRYRUN_CELLS]
    cmds.append([sys.executable, "-m", "repro_torch.launch.dryrun_cp", "--method", "auto",
                 "--mesh", "pod", "--out", str(out)])
    return out, [(c, _spawn(c)) for c in cmds]


def _finish_cells(out: Path, procs: list, smi) -> None:
    """19c: each process's record ``ok`` with exit code 0; printed: the
    records' flops, collective bytes, a rank's argument and temp GB and
    their ``RooflineTerms``."""
    from repro_torch.analysis.roofline import terms_from_record

    bad = []
    for c, proc in procs:
        rc, _, e = _reap(proc, DRYRUN_PART_TIMEOUT)
        if rc != 0:
            bad.append(f"{' '.join(c[2:])}: exit {rc}\n{e[-2000:]}")
    for arch, shape in DRYRUN_CELLS:
        path = out / f"{arch}__{shape}__pod.json"
        if not path.exists():
            bad.append(f"{arch} {shape}: no record")
            continue
        rec = json.loads(path.read_text())
        if not rec.get("ok") or "full" not in rec:
            bad.append(f"{arch} {shape}: not ok ({rec.get('error')})")
            continue
        st, t = rec["step"], terms_from_record(rec)
        _log(f"[19c] {arch} {shape} pod (dry-run, fake world of 256): flops "
             f"{st['flops']:.4e}, HBM bytes {st['bytes']:.4e}, coll bytes {st['coll_bytes']:.4e} "
             f"(received {st['coll_received_bytes']:.4e}), a rank's arguments "
             f"{st['argument_size_in_bytes'] / 1e9:.3f} GB and temp "
             f"{st['temp_size_in_bytes'] / 1e9:.3f} GB; RooflineTerms (nominal H100 SXM datasheet "
             f"constants, 700 W): compute {t.compute_s * 1e3:.2f} ms, memory "
             f"{t.memory_s * 1e3:.2f} ms, collective {t.collective_s * 1e3:.2f} ms, bound "
             f"{t.step_bound_s * 1e3:.2f} ms ({t.bottleneck}), mfu_bound {t.mfu_bound:.4f}; "
             f"trace {st['compile_s']} s")
    cp = list(out.glob("cpals__auto__pod__*.json"))
    if not cp:
        bad.append("dryrun_cp: no record")
    else:
        rec = json.loads(cp[0].read_text())
        _log(f"[19c] cpals auto pod {rec['shape']} rank {rec['rank']} (dry-run, fake world of "
             f"256): flops {rec['flops']:.4e}, bytes {rec['bytes']:.4e}, coll bytes "
             f"{rec['coll_bytes']:.4e} (plan's ring estimate {rec['plan_collective_bytes']:.4e}), "
             f"a rank's arguments {rec['arg_bytes'] / 1e9:.3f} GB and temp "
             f"{rec['temp_bytes'] / 1e9:.3f} GB; trace {rec['compile_s']} s")
        if not rec.get("ok"):
            bad.append("dryrun_cp: not ok")
    if bad:
        raise SystemExit("[19c] " + "; ".join(bad))
    _log(f"[19c] {len(DRYRUN_CELLS)} LM cells and the CP sweep traced ok; card {smi}")


def _dryrun_phase(torch, args, dev, smi) -> None:
    """Phase 19: FSDP on the card (19a), the dry-run against the card (19b),
    the production cells (19c); see the module docstring."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out, cells = _start_cells()
    try:
        for part in ("19a", "19b"):
            t0 = time.perf_counter()
            _run_part(part, args)
            _log(f"[19] {part}: {time.perf_counter() - t0:.1f} s")
    except BaseException:  # a part failed: stop the cells' processes too
        for _, proc in cells:
            _stop(proc)
        raise
    t0 = time.perf_counter()
    _finish_cells(out, cells, smi)
    _log(f"[19] 19c (after 19a-b, beside which it ran): {time.perf_counter() - t0:.1f} s")
    _log(f"[19] dry-run phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


# ---- phase 20: the examples and the executable docs on the card
EXAMPLE_TIMEOUT = 300  # seconds a part may take
EXAMPLES = "examples/repro_torch"
QUICKSTART_ERR_BOUND = 1e-2  # examples/repro_torch/quickstart.py's own
_FMRI_ROW = re.compile(r"^\s+(4D|3D) (paper methods \(auto\)|reorder-baseline)\s+fit=(\S+)"
                       r"\s+per-iter=\s*(\S+) ms\s+\((\d+) sweeps\)")


def _finish_example(tag: str, proc: subprocess.Popen, t0: float) -> str:
    """Wait for a part started at ``t0``; a failure or the time limit fails
    the phase.  Returns its standard output."""
    rc, out, err = _reap(proc, EXAMPLE_TIMEOUT)
    if rc != 0:
        raise SystemExit(f"[20] {tag} failed (exit {rc}):\n{out[-2000:]}\n{err[-3000:]}")
    _log(f"[20] {tag}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return out


def _expect(tag: str, out: str, text: str) -> None:
    if text not in out:
        raise SystemExit(f"[20] {tag}: no {text!r} in its output:\n{out[-2000:]}")


def _quickstart_part(out: str, smi: str) -> None:
    m = re.search(r"max\|err\| vs einsum oracle: (\S+) .*launches (\d+)", out)
    if m is None:
        raise SystemExit(f"[20] quickstart: no kernel line in its output:\n{out[-2000:]}")
    err, launches = float(m.group(1)), int(m.group(2))
    for line in out.splitlines():
        if line.startswith(("  schedule", "  mode", "final fit")):
            _log(f"[20] quickstart: {line.strip()}")
    _log(f"[20] quickstart: fused MTTKRP max abs err {err:.3e} (bound {QUICKSTART_ERR_BOUND:g}), "
         f"fused_mttkrp_bilinear_f32 launches {launches}; card {smi}")
    if not (launches >= 1 and err < QUICKSTART_ERR_BOUND):
        raise SystemExit("[20] quickstart: the fused CUDA kernel did not launch or disagrees")


def _fmri_part(args, smi: str) -> None:
    t, s, r, _ = FMRI
    t0 = time.perf_counter()
    out = _finish_example("fmri_cpals", _spawn([
        sys.executable, f"{EXAMPLES}/fmri_cpals.py", "--device", "cuda", "--time", str(t),
        "--subjects", str(s), "--regions", str(r), "--rank", str(args.rank),
        "--seed", str(args.seed)]), t0)
    rows = {}
    for line in out.splitlines():
        m = _FMRI_ROW.match(line)
        if m:
            kind = "auto" if m.group(2).startswith("paper") else "baseline"
            rows[(m.group(1), kind)] = (float(m.group(3)), float(m.group(4)), int(m.group(5)))
    if len(rows) != 4:
        raise SystemExit(f"[20] fmri_cpals: {len(rows)} of 4 result rows:\n{out[-2000:]}")
    for line in out.splitlines():
        if line.startswith(("4-way", "3-way")):
            _log(f"[20] fmri_cpals: {line.strip()}")
    bad = []
    for order in ("4D", "3D"):
        (fa, ta, na), (fb, tb, nb) = rows[(order, "auto")], rows[(order, "baseline")]
        _log(f"[20] fmri_cpals {order} rank {args.rank}: auto {ta:.3f} ms an iteration (fit "
             f"{fa:.4f}, {na} sweeps), baseline {tb:.3f} ms (fit {fb:.4f}, {nb} sweeps), "
             f"speedup {tb / ta:.2f}x; card {smi}")
        if not (math.isfinite(fa) and math.isfinite(fb)) or abs(fa - fb) > FIT_AGREE:
            bad.append(f"{order}: fits {fa} / {fb} (agree within {FIT_AGREE:g})")
    if bad:
        raise SystemExit("[20] fmri_cpals: " + "; ".join(bad))


def _examples_phase(torch, args, dev, smi) -> None:
    """Phase 20: the examples and the port's executable docs on the card;
    see the module docstring."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _build.build_all([fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL, mt.KERNEL,
                      mt.BATCHED_KERNEL, kk.KERNEL])  # built once; the parts load them
    _fmri_part(args, smi)  # alone on the card: it times
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    cmds = {
        "quickstart": [sys.executable, f"{EXAMPLES}/quickstart.py", "--device", "cuda"],
        "distributed_cpals": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", "1", f"{EXAMPLES}/distributed_cpals.py",
                              "--data", "1", "--model", "1"],
        "serve_lm": [sys.executable, f"{EXAMPLES}/serve_lm.py"],
        "train_lm": [sys.executable, f"{EXAMPLES}/train_lm.py", "--ckpt-dir", ckpt],
        "check_docs_torch": [sys.executable, "tools/check_docs_torch.py", "--device", "cuda",
                             "--doc", "architecture", "--doc", "serving"],
    }
    t0 = time.perf_counter()
    started = {tag: _spawn(cmd) for tag, cmd in cmds.items()}  # together: none times
    try:
        outs = {tag: _finish_example(tag, proc, t0) for tag, proc in started.items()}
    finally:
        for proc in started.values():  # a part failed: stop the others too
            if proc.poll() is None:
                _stop(proc)
        shutil.rmtree(ckpt, ignore_errors=True)
    _quickstart_part(outs["quickstart"], smi)
    out = outs["distributed_cpals"]
    _expect("distributed_cpals", out, "OK: distributed result matches")
    for line in out.splitlines():
        if line.startswith(("distributed", "single-device", "  planner")):
            _log(f"[20] distributed_cpals (NCCL world of one): {line.strip()}; card {smi}")
    _expect("serve_lm", outs["serve_lm"], "served 6 requests, 96 tokens")
    _log(f"[20] serve_lm: {outs['serve_lm'].splitlines()[0]}; card {smi}")
    _expect("train_lm", outs["train_lm"], "over 40 steps")
    _log(f"[20] train_lm: {outs['train_lm'].strip().splitlines()[-1]}; card {smi}")
    _expect("check_docs_torch", outs["check_docs_torch"], "docs check OK (2 files)")
    _log(f"[20] examples phase {time.perf_counter() - t_phase:.1f} s; card {smi}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--sweeps", type=int, default=5)
    ap.add_argument("--part", choices=["19a", "19b"], help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=["fused", "matrix_free", "batched_matrix_free", "pp",
                                       "dist", "lm", "lm_families", "train", "sharded_lm",
                                       "sharded_families", "dryrun", "examples", "high_rank",
                                       "dtypes", "krp"],
                    help="run only both fused kernels' (phases 0-7 for those kernels), the "
                         "unbatched (phases 0-4 for that kernel) or the batched (phases 0, 1, "
                         "5 and 7) matrix-free kernel's checks, timing and trace, phase 12 "
                         "(the legacy front door and PP sweeps) or phase 13 (sharded CP-ALS, "
                         "its executors, tuner and service, the two-level mesh and sharded PP "
                         "in an NCCL world of one), phase 14 (the LM serving path), phase 15 "
                         "(the MoE, SSM, hybrid and enc-dec families), phase 16 (the LM "
                         "training path), phase 17 (the sharded LM in an NCCL world of one), "
                         "phase 18 (the other families on the mesh there), phase 19 (FSDP on "
                         "the card and the dry-run against it), phase 20 (the examples and "
                         "the executable docs), phase 21 (the MTTKRP kernels above rank 64), "
                         "phase 22 (every kernel in bf16, fp16 and float64) or the KRP pair's "
                         "checks and timings of phases 8, 11, 21 and 22; prints no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import krp_kernel as kk
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import multi_ttv as mt
    from repro_torch.plan import Problem, cp_als, plan_sweep

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # ---- phase 0: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    _log(f"[0] device: {name}; count {count}; torch {torch.__version__} cuda {torch.version.cuda}")
    _log("[0] nvidia-smi name, power.limit:")
    _log(smi)
    _log(f"[0] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn={torch.backends.cudnn.allow_tf32}")
    if args.part:  # one part of phase 19, in its own process
        {"19a": _fsdp_part, "19b": _dryrun_part}[args.part](torch, args, dev, smi)
        return 0
    if args.only:
        only = {"fused": _only_fused, "matrix_free": _only_matrix_free,
                "batched_matrix_free": _only_batched_matrix_free, "pp": _only_pp,
                "dist": _only_dist, "lm": _lm_phase, "lm_families": _lm_families_phase,
                "train": _train_phase, "sharded_lm": _sharded_lm_phase,
                "sharded_families": _sharded_families_phase, "dryrun": _dryrun_phase,
                "examples": _examples_phase, "high_rank": _only_high_rank,
                "dtypes": _only_dtypes, "krp": _only_krp}[args.only]
        only(torch, args, dev, smi)
        _log(f"partial run (--only {args.only}) in {time.perf_counter() - t_start:.1f} s: "
             "no result line")
        return 0

    # ---- phase 1: build
    t0 = time.perf_counter()
    kernels = [fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL, mt.KERNEL,
               mt.BATCHED_KERNEL, kk.KERNEL]
    _build.build_all(kernels)
    _log(f"[1] built {', '.join(k.symbol for k in kernels)}, each in "
         f"{', '.join(kk.KERNEL.entries)}, in {time.perf_counter() - t0:.1f} s")
    _log_ptxas(kernels)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rank = args.rank
    x4 = synth_fmri(torch, gen, rank, dev)
    _log(f"[2] data: synthetic fMRI tensor from seed {args.seed}")

    # ---- phase 2: kernels vs plain versions
    err = {"fused": 0.0, "mf": 0.0, "fused_b": 0.0, "mf_b": 0.0, "mt": 0.0, "mt_b": 0.0,
           "krp": 0.0, "2step": 0.0}
    check = _checker(torch, err)

    f4 = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, f4, n)
        kern = fm.fused_mttkrp_bilinear(t, a, b, pos=pos)
        check(f"fused 4-way mode {n} pos {pos} T{tuple(t.shape)}", "fused", kern,
              fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos))
    _mf_checks(torch, gen, dev, check, x4, rank)
    _row2_checks(torch, gen, dev, check, x4, 2)
    torch.cuda.synchronize()

    # ---- phase 3: the main path
    init = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
    fits, launches, sweep_secs, states = {}, {}, {}, {}
    for strategy in ("auto", "fused", "matrix_free"):
        problem = Problem.from_tensor(x4, rank)
        plan = plan_sweep(problem, strategy=strategy)
        algs = [np_.algorithm for np_ in plan.nodes]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.KERNEL.launches = 0
        mf.KERNEL.launches = 0
        secs = []
        st = cp_als(x4, plan, n_iters=args.sweeps, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: (fits.setdefault(strategy, []).append(f),
                                                secs.append(dt)))
        torch.cuda.synchronize()
        launches[strategy] = (fm.KERNEL.launches, mf.KERNEL.launches)
        sweep_secs[strategy] = secs
        states[strategy] = st
        peak = torch.cuda.max_memory_allocated() / 1e9
        _log(f"[3] {strategy}: schedule {plan.resolved_schedule.name} nodes {algs}")
        _log(f"[3] {strategy}: fits {fits[strategy]}")
        _log(f"[3] {strategy}: per-sweep s {secs} (host clock, one device sync per sweep); "
             f"peak memory {peak:.3f} GB; launches fused {launches[strategy][0]} "
             f"matrix_free {launches[strategy][1]}; card {smi}")
        if st.it != args.sweeps or any(tuple(u.shape) != (d, rank) for u, d in zip(st.factors, FMRI)):
            raise SystemExit(f"{strategy}: wrong sweep count or factor shapes")
        if not all(math.isfinite(f) for f in fits[strategy]) or not all(
            bool(torch.isfinite(u).all()) for u in st.factors
        ):
            raise SystemExit(f"{strategy}: non-finite fit or factors")
    want = 4 * args.sweeps
    if launches["auto"] != (0, 0) or launches["fused"] != (want, 0) or launches["matrix_free"] != (0, want):
        raise SystemExit(f"launch counts {launches} do not match 4 x sweeps = {want}")
    gap = max(abs(a - b) for s in ("fused", "matrix_free") for a, b in zip(fits[s], fits["auto"]))
    _log(f"[3] fit agreement across strategies: max |diff| {gap:.3e} (bound {FIT_AGREE:g})")
    if gap > FIT_AGREE:
        raise SystemExit("strategies disagree on the fits")
    _trace_big_sweep(torch, args, x4, init, smi, 3)

    # small input: the card's run against the port's CPU run (plain versions)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    xs = torch.randn((20, 15, 12, 10), generator=cpu_gen)
    inits = [torch.randn((d, 5), generator=cpu_gen) for d in xs.shape]
    for strategy in ("fused", "matrix_free"):
        out = {}
        for where in ("cpu", "cuda"):
            plan = plan_sweep(Problem.from_tensor(xs, 5), strategy=strategy)
            got = []
            cp_als(xs.to(where), plan, n_iters=5, tol=0.0, init_factors=[u.to(where) for u in inits],
                   callback=lambda it, f, dt: got.append(f))
            out[where] = got
        d = max(abs(a - b) for a, b in zip(out["cpu"], out["cuda"]))
        _log(f"[3] small {strategy} card vs CPU fits: max |diff| {d:.3e} (bound {SMALL_FIT_AGREE:g})")
        if d > SMALL_FIT_AGREE:
            raise SystemExit("card and CPU runs disagree on a small input")

    # ---- phase 4: timing at the main path's shapes
    rows = {"fused": _row1_times(torch, x4, init, smi, 4)}
    row1_kernels = _row1_device(torch, x4, init, smi, 4)
    want_kernels = _row1_want_kernels(x4, init)
    if row1_kernels != want_kernels:
        raise SystemExit(f"fused_mttkrp_bilinear calls launch {row1_kernels} CUDA kernels, not "
                         f"the {want_kernels} its design states")
    rows["mf"] = _row2_times(torch, x4, init, smi, 4)
    row2_kernels = _row2_device(torch, x4, init, smi, 4)
    want_kernels = _row2_occupancy(torch, smi, 4)
    if row2_kernels != want_kernels:
        raise SystemExit(f"matrix_free_kernel calls launch {row2_kernels} CUDA kernels, not the "
                         f"{want_kernels} its design states")

    # ---- phase 5: batched kernels vs plain versions (the fleet is made here, after
    # phases 3-4, so their peak memory stays that of the single-tensor path)
    subjects = [x4[:, s].contiguous() for s in range(FMRI[1])]  # the serving fleet
    xb = torch.stack(subjects[:SERVE_BATCH])
    _log(f"[5] fleet: {len(subjects)} subjects {tuple(subjects[0].shape)}; batch "
         f"{tuple(xb.shape)} ({xb.numel() * 4 / 1e6:.0f} MB)")
    fb = [torch.randn((SERVE_BATCH, d, rank), generator=gen, device=dev) for d in xb.shape[1:]]

    def check_batched(label, x, fs, n, also_fused=True):
        if also_fused:
            t, a, b, pos = ops.bilinear_operands_batched(x, fs, n)
            check(f"fused batched {label} mode {n} pos {pos} T{tuple(t.shape)}", "fused_b",
                  fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos),
                  fm.fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos), 5)
        us = [fs[k] for k in range(x.ndim - 1) if k != n]
        check(f"matrix_free batched {label} mode {n}", "mf_b",
              mf.matrix_free_batched_kernel(x, us, n), mf.matrix_free_batched_kernel_plain(x, us, n),
              5)

    # rank 16, the serving path's second signature: batched at (8, 225, 200, 200)
    # and, for batch_size=1, unbatched on one subject
    fb16 = [torch.randn((SERVE_BATCH, d, SECOND_RANK), generator=gen, device=dev)
            for d in xb.shape[1:]]
    f16 = [f[0] for f in fb16]
    for n in range(3):
        check_batched(f"S={SERVE_BATCH}", xb, fb, n)
        check_batched("S=5 (odd)", xb[:5], [f[:5] for f in fb], n)
        check_batched(f"S={SERVE_BATCH} rank {SECOND_RANK}", xb, fb16, n)
        t, a, b, pos = ops.bilinear_operands(subjects[0], f16, n)
        check(f"fused subject 0 rank {SECOND_RANK} mode {n} pos {pos} T{tuple(t.shape)}", "fused",
              fm.fused_mttkrp_bilinear(t, a, b, pos=pos),
              fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos), 5)
        us = [f16[k] for k in range(3) if k != n]
        check(f"matrix_free subject 0 rank {SECOND_RANK} mode {n}", "mf",
              mf.matrix_free_kernel(subjects[0], us, n),
              mf.matrix_free_kernel_plain(subjects[0], us, n), 5)
    del fb16, f16
    for shape in ((3, 20, 15, 12, 10), (3, 12, 10, 8, 9, 11), (3, 6, 7, 5, 8, 6, 7)):
        xs_ = torch.randn(shape, generator=gen, device=dev)
        fs_ = [torch.randn((shape[0], d, rank), generator=gen, device=dev) for d in shape[1:]]
        for n in range(len(shape) - 1):
            check_batched(f"order-{len(shape) - 1} S={shape[0]}", xs_, fs_, n, also_fused=False)
    # slab independence: slabs 1.. hold other subjects and factors
    yb = torch.stack([subjects[0]] + [subjects[(SERVE_BATCH + k) % len(subjects)]
                                      for k in range(SERVE_BATCH - 1)])
    gb = [torch.cat([f[:1], torch.randn(f[1:].shape, generator=gen, device=dev)]) for f in fb]
    for n in range(3):
        for label, run in (("fused", ops.fused_mttkrp_batched),
                           ("matrix_free", ops.matrix_free_mttkrp_batched)):
            same = torch.equal(run(xb, fb, n)[0], run(yb, gb, n)[0])
            _log(f"[5] slab 0 of {label} mode {n} bitwise unchanged by slabs 1..: "
                 f"{'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"{label}: slab 0 depends on the other slabs")
    del yb, gb
    _row3_same_as_row4(torch, xb, fb, 5)
    _row4_checks(torch, gen, dev, check, xb, fb, 5)
    torch.cuda.synchronize()

    # ---- phase 6: the serving path
    serve_launches, sweep_s, serve_inits, serve_fits = _serve_phase(
        torch, args, dev, smi, subjects, gen
    )

    # ---- phase 7: batched kernel timing at the serving shapes
    rows["fused_b"] = _row3_times(torch, xb, fb, smi, 7)
    for n in range(3):
        c = fb[0].shape[-1]
        us = [fb[k] for k in range(3) if k != n]
        letters = "abd"
        lib_spec = ",".join(["s" + letters] + ["s" + letters[k] + "c" for k in range(3) if k != n])
        lib_spec += f"->s{letters[n]}c"
        r2 = {
            "ms": _time_ms(torch, lambda: mf.matrix_free_batched_kernel(xb, us, n), 50),
            "plain_ms": _time_ms(torch, lambda: mf.matrix_free_batched_kernel_plain(xb, us, n), 10),
            "library_ms": _time_ms(torch, lambda: torch.einsum(lib_spec, xb, *us), 10),
            "bytes_ms": 4 * (xb.numel() + sum(u.numel() for u in us) + SERVE_BATCH
                             * xb.shape[1 + n] * c) / HBM_BW * 1e3,
            "flops_ms": 2 * xb.numel() * c / PEAK_FLOPS * 1e3,
        }
        rows.setdefault("mf_b", []).append(r2)
        bound = max(r2["bytes_ms"], r2["flops_ms"])
        _log(f"[7] matrix_free_batched_kernel S={SERVE_BATCH} mode {n}: kernel {r2['ms']:.4f} ms, "
             f"plain {r2['plain_ms']:.4f} ms, einsum {r2['library_ms']:.4f} ms, "
             f"bound {bound:.4f} ms "
             f"({'bytes' if r2['bytes_ms'] >= r2['flops_ms'] else 'operations'}); card {smi}")
    row3_kernels = _row3_device(torch, xb, fb, smi, 7)
    if set(row3_kernels) != {1}:
        raise SystemExit(f"a fused_mttkrp_bilinear_batched call launches other than one CUDA "
                         f"kernel: {row3_kernels}")
    row4_kernels = _row4_device(torch, xb, fb, smi, 7)
    if set(row4_kernels) != {1}:
        raise SystemExit(f"a matrix_free_batched_kernel call launches other than one CUDA "
                         f"kernel: {row4_kernels}")
    _row4_occupancy(torch, xb, smi, 7)
    _trace_served_sweep(torch, args, xb, [f.clone() for f in fb], smi, 7)
    for key, strategy in (("fused_b", "fused"), ("mf_b", "matrix_free")):
        kern = sum(r["ms"] for r in rows[key])
        sweep = 1e3 * sweep_s[strategy]
        _log(f"[7] batched {strategy} sweep (S={SERVE_BATCH}, rank {rank}): {sweep:.3f} ms "
             f"(host clock, cp_als with sweeps_per_sync={args.sweeps} as a served dispatch, "
             f"its set-up included); kernels {kern:.3f} ms (CUDA events, separate loop); "
             f"difference, the time outside the kernels: {sweep - kern:.3f} ms; card {smi}")

    # ---- phases 8-11: the new kernels, the 2-step and KRP entry points, tuning
    new_launches = _new_kernels_phases(
        torch, args, dev, smi, x4, init, f4, subjects, fb, gen, check, rows, fits["auto"],
        sweep_secs["auto"], serve_inits, serve_fits,
    )

    # ---- phase 12: the legacy front door and PP sweeps
    pp_ref = _pp_phase(torch, args, dev, smi, x4, init,
                       {k: (states[k], fits[k]) for k in states}, subjects, serve_inits,
                       serve_fits)

    # ---- phase 13: sharded CP-ALS in an NCCL world of one
    _dist_phase(torch, args, dev, smi, x4, init, {k: (states[k], fits[k]) for k in states},
                subjects, serve_inits, serve_fits, pp_ref)

    # ---- phase 21: the MTTKRP kernels above rank 64, while the fMRI tensor is here
    _high_rank_phase(torch, args, dev, smi, x4, subjects)

    # ---- phase 22: every kernel in bf16, fp16 and float64 (the float32 tensors of
    # phases 2-13 and 21 released first, but the fMRI tensor, cast one dtype at a time)
    del init, f4, subjects, xb, fb, states, pp_ref
    torch.cuda.empty_cache()
    _dtypes_phase(torch, args, dev, smi, x4)

    # ---- phase 14: the LM serving path (the tensors of phases 2-13, 21 and 22 released first)
    del x4
    torch.cuda.empty_cache()
    _lm_phase(torch, args, dev, smi)

    # ---- phase 15: the other LM families (each model freed before the next)
    _lm_families_phase(torch, args, dev, smi)

    # ---- phase 16: the LM training path (each model freed before the next)
    _train_phase(torch, args, dev, smi)

    # ---- phase 17: the sharded LM in an NCCL world of one (16d's run kept for 17b)
    _sharded_lm_phase(torch, args, dev, smi)

    # ---- phase 18: the other families on the mesh (NCCL world of one)
    _sharded_families_phase(torch, args, dev, smi)

    # ---- phase 19: FSDP on the card, the dry-run against it, production cells
    _dryrun_phase(torch, args, dev, smi)

    # ---- phase 20: the examples and the executable docs, each a process of its own
    _examples_phase(torch, args, dev, smi)

    def summary(name_, source, replaces, key, launch):
        rs = rows[key]
        b_bytes = sum(r["bytes_ms"] for r in rs)
        b_ops = sum(r["flops_ms"] for r in rs)
        return {
            "name": name_, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launch, "max_abs_err": err[key],
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
        }

    _log(f"[4] kernel times per sweep (one launch per mode, 4 modes); card {smi}")
    _log(f"[7] batched kernel times per batch sweep (one launch per mode, 3 modes, "
         f"S={SERVE_BATCH}); card {smi}")
    _log(f"[11] multi_ttv times per 2-step sweep (modes 1 and 2, one launch each); "
         f"multi_ttv_batched one launch at S={SERVE_BATCH}; krp_pair the 94 MB KRP's last fold; "
         f"card {smi}")
    _log(f"whole smoke {time.perf_counter() - t_start:.1f} s")
    _log("kernels: fused_mttkrp_bilinear, matrix_free_kernel, fused_mttkrp_bilinear_batched, "
         "matrix_free_batched_kernel, multi_ttv, multi_ttv_batched, krp_pair")
    print(json.dumps({"kernels": [
        summary("fused_mttkrp_bilinear", FUSED_SOURCE, FUSED_REPLACES, "fused",
                launches["fused"][0]),
        summary("matrix_free_kernel", MF_SOURCE, MF_REPLACES, "mf", launches["matrix_free"][1]),
        summary("fused_mttkrp_bilinear_batched", FUSED_SOURCE, FUSED_BATCHED_REPLACES, "fused_b",
                serve_launches["fused"]),
        summary("matrix_free_batched_kernel", MF_SOURCE, MF_BATCHED_REPLACES, "mf_b",
                serve_launches["matrix_free"]),
        summary("multi_ttv", MT_SOURCE, MT_REPLACES, "mt", new_launches["mt"]),
        summary("multi_ttv_batched", MT_SOURCE, MT_BATCHED_REPLACES, "mt_b", new_launches["mt_b"]),
        summary("krp_pair", KRP_SOURCE, KRP_REPLACES, "krp", new_launches["krp"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
