#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. Device: prints the card's name and power limit, builds the CUDA tile
     kernels from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a).
  2. Kernel vs plain version: on the full-size cit-HP stand-in (n=34,546,
     128×128 tiles, 4.7 GB per matrix) for all five semirings, each kernel
     against its plain PyTorch version (``kernels/ref.py``) on the same
     card inputs: exact for the integer and min semirings, ⟨+,×⟩ within
     rtol 1e-5, atol 1e-6 (another fold order). SpMSpV at frontier
     densities of 0.1%, 5% and 60%. Plus the full ca-Q stand-in at 16×16
     tiles. Kernel, plain, bound and (⟨+,×⟩) library times.
  3. Main path: adaptive BFS/SSSP/PPR through ``build_engine(fmt="bsr")``
     on full-size cit-HP (scale-free), held to the numpy/scipy oracles.
  4. Main path: BFS on full-size r-TX (regular, n=1,087,849), levels
     held to the oracle clipped to max_iters.
  5. Per traversal: wall ms, iterations, launches per kernel, peak memory.
  6. Fused path on full-size cit-HP at 128×128 for all five semirings,
     through ``core.spmv.spmv(impl="fused")``, ``ops.semiring_spmv_sliced``
     (sell-C-σ from ``autotune_sell``) and ``core.spmspv.spmspv(impl=
     "fused")`` at densities 0.1%, 5%, 60%, each also with ``chunks=2``.
     Kernels 3 and 4 are held to their plain versions and with
     ``torch.equal`` to kernel 1, kernel 5 to its plain version and to
     kernel 2 (x is finite and nonzero, so pad ⊗ x is the ⊕-identity).
     Kernel, plain, bound (the ported ``*_stream_stats`` bytes) and
     (⟨+,×⟩) library times.
  7. Fused path on full-size r-TX (⟨∨,∧⟩): kernels 3 and 5 against 1 and 2.
  8. sell-C-σ on full-size graph500-scale18 (g-18, n=174,147), whose
     ELL-of-tiles copy (106 GB) does not fit the card: kernel 4 for ⟨+,×⟩
     on integer values, equal to a numpy integer oracle, and for ⟨∨,∧⟩,
     equal to the CSR SpMV; both also held to the plain version.
  9. Masked tile SpGEMM on full-size ca-Q (n=5,242): A its adjacency, B
     dense [n, n] and a mask of density 0.4, in each semiring's safe
     domain, masked and unmasked, at 16×16, 64×64 and 128×128 tiles,
     through the front door ``ops.semiring_spgemm``, which must launch
     the tensor-core variant (kernel 6b) for the 0/1 ⟨+,∧⟩ and ⟨∨,∧⟩
     cases and kernel 6 for the others: the float semirings, a case for
     ⟨+,×⟩ and ⟨min,×⟩ where the pad products are NaN, and ⟨+,∧⟩ with B
     in 0..8 or a negative row under tile-column 0. Kernel 6 against its
     plain version, exact (NaN where NaN) for the integer and min
     semirings, ⟨+,×⟩ within rtol 1e-5, atol 1e-6; kernel 6b
     ``torch.equal`` to its plain version and to kernel 6. Kernel, plain
     and bound times of both on the 64×64 ⟨+,∧⟩ masked case; kernel 6's
     on the 64×64 ⟨+,×⟩ masked case (f32, operands the front door sends
     it) beside ``torch.sparse.sampled_addmm`` with the mask as CSR and A
     densified, the one library call for that function (⟨min,+⟩ and the
     others have none), held to kernel 6 within the same tolerance:
     kernel 6's row of the kernels line; beside it the launch alone, and
     kernel, plain and bound rows of ⟨min,+⟩, ⟨min,×⟩ and ⟨+,∧⟩ (B in
     0..8) on the same 64×64 masked operands. Both kernels' bounds count
     the work the function needs: the real slots of each active tile, at
     the fp32 or int32 rate of the CUDA cores for kernel 6. In every case
     kernel 6 reports the (tile, slot) pairs it folded as real slots and
     as the pad row, which must be each active tile's real and pad slots;
     for ⟨+,×⟩ the worst |diff| / (1e-6 + 1e-5·|want|) of each case is
     printed, and on a 2048² A of density 1/2 at 64×64 (~1,000 nonzero
     products an output entry) it must stay at most 0.5 against the
     plain version and against the product in float64.
 10. Whole-graph analytics on full-size cit-HP: ``triangle_count(impl=
     "bsr", block=(64, 64))``, which must launch kernel 6b and not kernel
     6 (total equal to ``triangle_reference``, per-edge counts equal to
     scipy's exact (L·Lᵀ) ⊙ L, to ``torch._int_mm(L8, L8ᵀ) * L`` and to
     the dense fp32 matmul yardstick), and through
     ``build_engine(fmt="bsr")`` connected components (⟨min,×⟩, equal to
     ``cc_reference``), k-core (⟨+,×⟩, equal to ``kcore_reference``) and
     PageRank (within rtol 1e-3, atol 1e-6 of ``pagerank_reference``).
     Per app: wall ms, iterations, launches of kernels 1, 6 and 6b, peak
     memory. On the triangle operands: kernel 6b's time (median of 5, the
     int8 packing included), kernel 6's (median of 3), their bounds from
     ``ops.spgemm_stream_stats``, the two library calls' times (casts
     included), and the app's wall split into operand preparation, the
     front door's 0/1 test, packing, grouping and the kernel alone.
 11. MoE dispatch gather (kernel 7) against its plain version with
     ``torch.equal`` at D = 2048 in bf16 and f32, on a decode-shaped plan
     (S = 4·64·8 = 2,048 slots, 24 valid) and a prefill-shaped plan
     (S = 4·64·64 = 16,384) from random top-6 routing; after phase 12, on
     the plans its first MoE layer built (with the layout hint
     ``moe_sparse`` passed, which phase 12 checks). Each plan through
     ``ops.moe_dispatch_gather`` with the hint, as ``moe_sparse`` calls
     it, and without it: the path each took (the wrapper's per-path
     counts), device times of both, plain, bound and library
     (``index_select`` on x with a zero row appended), and single-call
     times (``call_ms``, the host's share) of the kernel and the library.
 12. Serving: the full deepseek-v2-lite-16b (27 layers, 15.7 B
     parameters) in bf16, initialised on the card from a seeded
     generator, serves 4 requests (prompts of 17, 64, 200 and 511 tokens,
     8 new tokens each, max_seq 1024) through ``ServingEngine.run``,
     twice. Each request gets its budget, the logits are finite, kernel 7
     launches 26 × (1 + decode steps) times, the second run gives the same
     tokens, peak memory stays under 80 GB. Prefill ms, decode ms per
     step, tokens/s, peak memory; a profiler window of 3 decode steps
     gives device busy time and the top kernels.
 13. The same model cut to 2 layers (the dense one and one MoE layer) in
     f32 with TF32 off, on the card and on the host from the same
     weights (``card_against_host``): prefill and 4 greedy decode steps
     route every token to the same experts, every card launch of kernel 7
     equals its plain version and the host path's rows, the same tokens,
     logits within rtol 1e-3, atol 1e-4.
 14. Multi-source traversals. Kernels 1 and 2 over a [B, n] block
     (``semiring_spmv_padded_batch``, ``semiring_spmspv_padded_batch``) on
     full cit-HP at 128×128 for all five semirings, at B = 1, 5, 32 and 40
     (two vector groups of the fold), with an all-pad row and kernel 2's
     rows at densities 0.1%, 5% and 60%: ``torch.equal`` to kernels 1 and 2
     row by row and held to their plain versions; kernel (kernel 2's alone
     and with the wrapper's union operands), 32 sequential single
     launches, plain (⟨+,×⟩), bound and (⟨+,×⟩) library
     (``torch.sparse_bsr_tensor @ Xᵀ``) times, medians of 10 (of 3 for the
     sequential launches and the plain versions). Then through
     ``build_engine(fmt_spmv="bsr", fmt_spmspv="bsr")`` on full cit-HP,
     ``bfs_multi``, ``sssp_multi`` (weighted) and ``ppr_multi``
     (normalized) at B = 32 sources from SEED: every row equal to the
     single-source run on the same engine (PPR within rtol 1e-3, atol
     1e-6) with its iterations and kernel and density traces, four rows
     held to ``bfs_reference``/``sssp_reference``; ``traverse_multi_buckets``
     on buckets of 32, 32 and 20 padded to 32, identical at depth 0 and 2;
     on full r-TX ``bfs_multi`` at B = 8 over 128 levels on the tile route
     (two rows held to the clipped oracle), kernel 2 over the block on its
     rows' level-64 frontiers (``torch.equal`` to kernel 2 row by row,
     timed, with its CTAs and non-empty block rows), and ``sssp_multi`` at
     B = 8 on the csr/csc route, which must run ``spmspv_batch_union``. Per
     app: wall ms against the 32 (8) sequential single-source calls,
     queries/s, host syncs per level (the profiler's count of
     device-to-host reads), block launches and peak memory; for cit-HP's
     ``ppr_multi`` and r-TX's ``bfs_multi`` one more run in a profiler
     window: wall, all device time and the block fold's device time.
 15. Dynamic graphs on full cit-HP: a grow (inserts, ~1% of nnz) and a
     churn delta (inserts and deletes), built by the rule of
     ``benchmarks/dynamic_updates.py::_deltas``, go through
     ``DynamicGraph.apply``; on bsr engines of the new snapshot
     ``bfs_incremental`` (unit ⟨min,+⟩) and ``sssp_incremental``
     (content-keyed weights) at B = 32 equal cold ``bfs_multi`` and
     ``sssp_multi``, ``cc_incremental`` equals a cold
     ``connected_components`` and ``cc_reference``, ``pagerank_warm`` is
     within rtol 1e-4, atol 1e-7 of a cold PageRank, in no more iterations
     on the grow delta (on churn the count is reported). Apply and repair
     ms, traffic, iterations, walls, peak memory.
 16. The mesh layer (``core/mesh.py``, ``partition.py``,
     ``collectives.py``, ``distributed.py``, ``pipeline.iterate_phases``)
     on D = 8 virtual devices of the card (mesh 2×4). Full cit-HP, bsr
     128×128, ⟨+,×⟩ (integer weights), ⟨min,+⟩ and ⟨∨,∧⟩: row (8,1), col
     (1,8) and 2d (2,4), each at balance rows and nnz, kernel 1 (SpMV) and
     kernel 2 (SpMSpV at 5%), flat and fused (kernels 3 and 5), each output
     ``torch.equal`` to the single-device kernel on the same graph
     (integer-valued x; ⟨+,×⟩ on a float x within rtol 1e-5), and ring,
     tree, staged2d rc (and cr on col) bit-equal to flat. Each partition's
     stored bytes; per strategy the Load, Kernel and Retrieve+Merge of one
     SpMV timed apart under the blocking schedule, with the Kernel phase's
     launches, beside ``estimate_phase_costs`` and ``merge_wire_cost``.
     Full r-TX (⟨∨,∧⟩) row, 2d and col (about 31 GB), against kernels 1 and
     2. The paper's config (``configs/alpha_pim_graph.py``: CSC, SpMSpV)
     through ``partitioned_matvec(strategy="auto", topology="auto")`` on
     cit-HP and r-TX: the planner's pick beside the fastest of the six
     fixed strategy:balance runs, each held to kernel 2. ``iterate_phases``
     over ``build_phase_fns`` for 20 rank updates (⟨+,×⟩, column-stochastic)
     and 20 ⟨min,+⟩ steps on cit-HP 2d/rows: depth 0 and 2 ``torch.equal``,
     against 20 single-device kernel-1 steps (⟨min,+⟩ ``torch.equal``,
     ⟨+,×⟩ within rtol 1e-4: every step folds in another order), both
     walls and the device-to-host reads per phase and per iteration.
     ``make_distributed_batched_matvec`` at B = 32 (kernels 1b and 2b on
     every device), each row equal to the unbatched call. The distributed
     SpGEMM on full ca-Q at 64×64, row/col/2d, 0/1 ⟨+,∧⟩ (kernel 6b) and
     integer ⟨+,×⟩ (kernel 6), masked and not, equal to the single-device
     front door. One row at D = 64 (8×8) on cit-HP 2d/rows. Every kernel
     launched through the mesh (1, 2, 3, 5 in each strategy, balance and
     semiring, on cit-HP, r-TX and at D = 64; 1b and 2b in the batched
     call; 6 and 6b on ca-Q) is held on each virtual device to its plain
     version on that device's part and gathered input, the shapes the mesh
     gives it (``compare``: exact, ⟨+,×⟩ within rtol 1e-5, atol 1e-6);
     the largest difference per kernel goes into the ``kernels`` line. A
     warm distributed call (⟨min,+⟩, every strategy, topology, kernel,
     fused form and the compressed Load) and one phase step of the pipeline under every topology
     make no synchronising CUDA call (torch.cuda's sync debug mode). Peak
     memory.
 17. Graph serving (``repro_torch.serve.graph_engine``): one
     ``AsyncGraphServer`` on a ``FakeClock`` hosts full cit-HP and r-TX
     (batch 32, csr/csc engines, max_iters 64, r-TX's traversals 32 but
     for the globals, pipeline depth 2, strategy
     auto, eager windows), 256 seeded traversals each (bfs/sssp/ppr in
     equal shares, 30% repeats). The deep-backlog capacity, the faster of
     two traced drains: each bucket's wall from its ``pipeline/*`` spans. Open loop at 0.5×, 1×
     and 2× capacity over the workload (4 times for cit-HP, twice for r-TX) with the
     cache off, Poisson arrivals, each flush
     advancing the clock by its wall, one deadline budget of 4 median
     bucket walls: misses equal the per-ticket slack oracle, conservation
     in every snapshot, bfs/sssp checksums equal at every load, the miss
     rate not falling with the load (within a window's step). Every
     served (algorithm, source) equal to the single-source run on the same
     engine (PPR within rtol 1e-3, atol 1e-6), a cit-HP sample of 32 per
     algorithm to ``bfs/sssp/ppr_multi`` on bsr engines (kernels 1b, 2b)
     and scipy. Host syncs per flush (profiler), one traced window against
     the same window untraced (every ``serve/*`` span carries its
     ``window_id``). With the cache on: PageRank, CC, k-core and triangles
     on cit-HP, PageRank and k-core on r-TX, four askers and one run each,
     against phase 10's oracles and the numpy references; ``mutate`` with
     phase 15's grow delta, retained + invalidated equal to the entries
     before, every re-ask equal to a cold server on the new snapshot, the
     device memory dropping. A threaded run on the system clock (4
     submitters, 128 queries per tenant, every wait with a timeout) equal
     to the fake-clock answers. Seconds per part, peak memory.
 18. The GQA families at full width in bf16, random weights from seed 0
     by the reference's init rule, each built, run and freed before the
     next: ``quantize_kv`` on the card equal to the host's bit for bit on
     the same f32 input; mistral-nemo-12b (40 layers, 12.25 B
     parameters, head_dim 128), deepseek-7b (int8 KV), minitron-4b and
     qwen1.5-32b (qkv bias, int8 KV, 35.2 B parameters whole) each serve
     phase 12's 4 requests (8 new tokens, max_seq 1024) through
     ``ServingEngine.run``, nemo twice with the same tokens; every request
     gets its budget with finite logits, the cache tensors' bytes equal
     ``kv_cache.cache_bytes``, the int8 caches hold ``torch.int8`` codes
     in [−127, 127]. hubert-xlarge encodes [4, 1500, 512] frames (full
     logits, no cache). llama-3.2-vision-11b serves the requests, then
     prefills them with random ``image_embeds`` [4, 1601, 7680] (its
     gates start closed, so the logits equal the text-only prefill's) and
     decodes with ``vision_kv``. mixtral-8x22b at the most layers that
     fit (14 of 56 unless fewer leave 6 GB free), window 4,096, capacity
     factor 1.25: batch 2, a 4,000-token prompt and 100 decode steps
     through the ring (it wraps at position 4,096); kernel 7 launches
     once per MoE layer in prefill and in every decode step, and its
     first prefill and decode plans (D = 6144) are held to the plain
     version and timed against their bound and ``index_select``; the
     prefill plan must take the window path. Per arch:
     parameters, layers run, weight and cache bytes, peak memory, init s,
     prefill ms, decode ms a step, tokens/s, kernel 7 launches; a profiler
     window of 3 decode steps on nemo and mixtral (device busy time,
     launches a step).
 19. In f32 with TF32 off, matrices redrawn with std 1/√(input width) as
     in phase 13: a 2-layer cut of mistral-nemo-12b at full width and a
     1-MoE-layer cut of mixtral-8x22b, each on the card and on the host
     from the same weights, prefill phase 13's prompts and take 4 greedy
     steps: the same routing at every MoE call, every card launch of
     kernel 7 equal to its plain version and to the host path's rows, the
     same greedy tokens, logits within rtol 1e-3, atol 1e-4. Then on the
     card the mixtral cut at capacity factor 4.0 (no drops) prefills
     2 × 4,000 tokens and decodes 128 through the ring, each step's
     logits within rtol 1e-3, atol 1e-4 of ``forward`` over the same
     4,100 tokens, window-masked.
 20. The ssm and hybrid families, whole in bf16 with random weights from
     seed 0 by the reference's init rule, each built, run and freed before
     the next: xlstm-1.3b (48 blocks: 6 groups of 1 sLSTM + 7 mLSTM, d
     2048, 4 heads, 1,639,614,632 parameters) and zamba2-1.2b (38 Mamba2
     layers, d_state 64, one shared attention+MLP block at 7 sites,
     1,104,602,240 parameters) serve phase 12's 4 requests twice with the
     same tokens; every request gets its budget with finite logits, the
     cache tensors' bytes equal ``kv_cache.cache_bytes``; a profiler
     window of 3 decode steps each. Then batch 2, a 4,000-token prompt (16
     chunks of 256) and 32 decode steps (xlstm at max_seq 1,024, having
     no positional cache; zamba2 at 4,128): every cache tensor keeps its
     ``data_ptr`` and shape from ``init_cache`` through the last step.
     f32 cuts at full width with TF32 off and matrices redrawn (xlstm one
     group of 8 blocks, zamba2 7 layers: a group of 6 and the remainder,
     2 sites) on the card and on the host: the same greedy tokens, logits
     within rtol 1e-3, atol 1e-4; then on the card 2 × 600 tokens and 32
     decode steps, each step within rtol 1e-3, atol 1e-4 of ``forward``
     over the same tokens (chunked against stepwise recurrence). No
     hand-written kernel is on this path: all eleven launch counts are
     set to 0 before the phase and must read 0 after it.
 21. Train mode. (a) Kernel 7ᵀ (``moe_dispatch_gather_backward``, the
     dispatch gather's transpose) on three ``dispatch_plan`` plans from
     random routing: deepseek's training microbatch (2 × 2,048 tokens,
     64 experts top-6, capacity 240, D = 2,048: S = 30,720), the same at
     capacity factor 0.5 (assignments drop) and mixtral's (8 experts
     top-2, D = 6,144), in bf16 and f32, ``torch.equal`` to its plain
     version; x's gradient through the dispatch Function (kernels 7 and
     7ᵀ) equal to the plain versions' bit for bit; kernel, plain, bound
     (the kept rows read once, x written once, the index) and library
     (``torch.zeros(T, D).index_add_`` over the kept slots) times. (b)
     deepseek-v2-lite-16b cut to 2 layers at full width in f32, TF32
     off, matrices redrawn: ``Model.loss`` (total, NLL, aux) within rtol
     1e-4 of the host's, the same routing, every gradient leaf within
     rtol 1e-3, atol 1e-5·max|g| of the leaf, and one ``adamw_apply``
     from the card's gradients on each side: master, mu and nu within
     rtol 1e-5, atol 1e-6·max|leaf|. (c) deepseek-v2-lite-16b at full
     width, 4 of its 27 layers (the dense one and 3 MoE layers,
     2,254,983,168 parameters), bf16 weights from seed 0 by the
     reference's rule, trained 8 steps through ``train_step_fn`` (AdamW
     with f32 master weights, lr 3e-4, warmup 2; remat; 4 × 2,048 tokens
     of ``SyntheticLM`` in 2 microbatches): every loss and grad norm
     finite, step 8's loss below step 1's, the parameters in their
     storage and dtype, kernel 7 launched 12 times a step and 7ᵀ 6
     times; parameters and bytes of weights, gradients and optimizer
     state, peak memory, init and first-step s, the median step ms of
     steps 2–8, tokens/s, and a profiler window of one more step. (d)
     ``TrainDriver`` on ``scaled_config(deepseek-v2-lite-16b, 0.05)`` at
     top-2 (sparse dispatch, kernels 7 and 7ᵀ): 12 steps with async
     checkpoints every 4, once clean and once failing at steps 5 and 9:
     2 restarts, every loss, the final parameters and optimizer state
     equal bit for bit; then ``launch.train.main`` at its defaults for
     12 steps in a temporary directory, its loss falling.
 22. The dry run (``launch/dryrun.py``, on the meta device) against the
     card's own steps. (a) In phase 21c, the model resident: one more
     train step on the card under ``launch/op_analysis.py``'s counter,
     and the dry run of the same cell (DeepSeek-V2-Lite at full width,
     4 layers, 4 × 2,048 tokens, 2 microbatches, remat) on meta. (b) In
     phase 12, deepseek-v2-lite-16b resident: one ``make_serve_step``
     decode at batch 4, max_seq 1,024 after the prompts' prefill, under
     the counter, and its dry run. Gates of (a) and (b): the same ops
     (name, FLOPs, dtype, bytes) in the same order on meta and on the
     card (the first that differs is printed), so the same FLOPs by
     dtype and bytes; kernels 7 and 7ᵀ report their traffic 12 and 6
     times a train step, kernel 7 26 times a decode step, on both; the
     dry run's arguments plus temps within 5% of the card's
     ``max_memory_allocated`` over the step less what was allocated
     before the model was built; the roofline's ``bound_s`` at most 1.05
     × the measured step (phase 21c's median, phase 12's decode ms a
     step). Printed: the roofline terms, ``bound_s`` over the step,
     ``useful_flops_ratio``, the top 10 (caller, op) pairs and callers
     by bytes (and for (a) phase 21c's profiler top ops beside them). (c) The dry run's
     records of two cells at the reference's shapes, xlstm-1.3b ×
     decode_32k and deepseek-v2-lite-16b × decode_32k (kernel 7 on
     meta): every key of the reference's record, FLOPs > 0, and
     ``model_flops`` = 2 · N_active · batch. Seconds of each part.
 23. The LM sharding layer and the mesh train steps on virtual devices
     of the card (``distributed/sharding.py``, ``train/train_loop.py``'s
     ``make_train_step`` and ``make_compressed_train_step``). (a)
     deepseek-v2-lite-16b as phase 21c (4 of 27 layers, 4 × 2,048 tokens
     in 2 microbatches, remat, AdamW lr 3e-4, warmup 2) on
     ``small_mesh(data=2, model=2)`` for 8 steps: every loss and grad norm
     finite, step 8's loss below step 1's, every parameter, master, mu
     and nu block of the shape ``spec_for`` and ZeRO-1 give, kernels 7
     and 7ᵀ launched as often as the code predicts (every MoE layer of
     every microbatch: forward, recompute and backward); each device's
     bytes of each state, peak memory, the median step ms of steps 2–8
     beside phase 21c's; kernel 7 timed on the training plan (2 × 2,048
     tokens) against its bound and ``index_select``. (b) A 2-layer f32
     cut, TF32 off, matrices redrawn, one mesh step on the card and on
     the host (compared on the card): loss and grad norm within rtol 1e-4, master within rtol
     1e-5, atol 1e-6·max|leaf| where |mu| clears 1e-2·max|mu|, mu and nu
     within the gradient's tolerance (rtol 1e-3, atol 1e-5·max|leaf|:
     they are the gradient scaled and squared, and each side computes
     its own), their worst relative error printed. (c) 2 layers on (pod
     2, data 2, model 2) with the int8 error-feedback pod step for 8
     steps: the codes gathered over pod int8, every loss finite, and by
     leaf and step the share of zero codes and the error-feedback norm.
     Against the uncompressed step on the same mesh and batches: the
     loss within 5%; the loss of step 1's batch, read again after step 8,
     fallen by at least a quarter of the uncompressed drop; and, leaf by
     leaf, ``tests/test_launch.py``'s mean |Δ| / (|p| + 1e-3) below 0.05
     over the entries that some step's codes carried (AdamW's nu > 0),
     while the entries no step carried must hold AdamW's zero-gradient
     value (the weight decay alone) bit for bit. The whole-leaf mean is
     printed: on lm_head it is above 0.05 (its 102,400 columns' small
     gradients stay below half an int8 step, and the uncompressed AdamW
     step moves them by ~lr). The bytes that cross
     the pod axis against a bf16 ring all-reduce. (d) A checkpoint of
     ``scaled_config(deepseek-v2-lite-16b, 0.05)`` at top-2 written from
     (data 2, model 2) restored onto (4, 1) and (1, 4), every leaf equal
     bit for bit; then ``launch.train.main`` with ``--data 2 --model 2
     --pod 2 --compress-pod`` for 12 steps, its loss falling.
 24. The multi-source traversals row-sharded over ``("batch",)`` meshes
     of virtual devices (``graphs/multi.py``'s ``mesh``/``axis_name``).
     On full cit-HP's 128×128 bsr engines: ``bfs_multi``,
     ``sssp_multi`` (weighted) and ``ppr_multi`` at B = 32 on D = 4 and
     8, every field of every row ``torch.equal`` to phase 14's
     single-device batched run (PPR included: the tile route folds each
     row alone, in slot order); kernels 1b and 2b launched on the main
     path; wall ms beside the single-device run's, launches and host
     syncs per level, peak memory. On one BFS level of cit-HP (and a
     ⟨+,×⟩ block of the same frontier), each device's launch of 1b and
     2b on its rows (2b with the union operands of its rows alone) held
     to its plain version and ``torch.equal`` to those rows of the
     whole block's launch. On full r-TX: ``bfs_multi`` at B = 8 on D =
     8, one row a device, equal to phase 14's run, two rows held to the
     clipped oracle; each app's single-device batch is rerun in the phase
     for the wall beside it. ``GraphQueryServer(mesh=...)`` on cit-HP (D = 8)
     serves 256 queries with answers equal to the mesh-less server's
     (its csr/csc engines: PPR within rtol 1e-3, atol 1e-6, for the
     atomic ``scatter_reduce``). (b) The dry run on a production mesh,
     on meta: xlstm-1.3b × decode_32k on the 16x16 mesh and
     deepseek-v2-lite-16b × train_4k on the 16x16 and 2x16x16 meshes
     (one microbatch: the clamp of the CLI's 16 takes minutes on meta),
     each record's per-device memory, FLOPs, wire bytes inside and
     between NVLink nodes and roofline printed, with every key of the
     reference's record and non-zero collectives (and ``dcn_bytes`` on
     the 2x16x16 train cell); and the dry run of phase 23a's cell on its
     (2, 2) mesh, whose per-device argument bytes must equal what device
     0's blocks hold on the card (parameters, master, mu, nu, the step,
     its rows of the batch).
 25. The mesh on a process group, one rank per device
     (``core/rank_mesh.py``). The card's machine has one H100, so the
     ranks time-share it over gloo, each collective staged through pinned
     host buffers (NCCL refuses two ranks on one GPU); their walls are
     not a multi-card result. (a) 8 ranks on phase 16's (2, 4) mesh,
     each holding its own parts of cit-HP (bsr 128×128): ⟨+,×⟩ on
     integer weights, ⟨min,+⟩ and ⟨∨,∧⟩, every strategy, both kernels,
     the fused form, every Merge topology and the compressed Load;
     ⟨+,×⟩'s batched calls (B = 8) on 2d; ``iterate_phases`` at depth 0
     and 2; the masked SpGEMM on ca-Q (2d, 64×64, 0/1 ⟨+,∧⟩ and integer
     ⟨+,×⟩). Each rank's result ``torch.equal`` to block ``rank`` of the
     virtual mesh's, each rank's Kernel-phase launches held to their
     plain versions on its part (phase 16's tolerances), and its Load /
     Kernel / Retrieve+Merge ms by CUDA events beside the virtual
     mesh's, with its wire bytes by primitive and peak memory. (b) 4
     ranks, ``make_train_step`` on (data 2, model 2), DeepSeek-V2-Lite at
     full width, 2 layers (1,085,287,424 parameters), bf16, 4 × 2,048
     tokens in 2 microbatches, 2 steps, after the virtual mesh's run of
     the same steps (freed before the ranks start): each rank's loss and
     grad norm ``torch.equal`` and every block's digest (two 64-bit
     position-weighted integer sums of its bytes) equal to the virtual
     mesh's block ``rank``. (c) On (a)'s 8 ranks, the compressed step on
     (pod 2, data 2, model 2) at phase 21d's scaled config, 2 steps:
     every block and each pod's error feedback ``torch.equal``. (d) One
     NCCL rank (world 1): (a)'s row ⟨+,×⟩ spmv and one train step on
     1×1 meshes, equal to the virtual mesh's. Every rank is joined and
     its exit code checked; a rank's failure fails the run.
 26. Row-sharded traversals and ``GraphQueryServer`` on ranks
     (``rank_multi_phases``).
 27. One checkpoint for a whole rank mesh and ``AsyncGraphServer``
     tenants on a ``RankMesh``, on 4 gloo ranks sharing the card
     (``rank_ckpt_phases``), beside the virtual mesh's and the mesh-less
     server's twins run meanwhile in the parent. (a) Phase 21d's config:
     ``TrainDriver`` on (data 2, model 2), 12 steps, an async checkpoint
     every 4, failures at steps 5 and 9, equal bit for bit to the
     uninterrupted 4-rank run and to the virtual mesh's driver; its
     checkpoint one directory, every file byte for byte the virtual
     mesh's; restored onto (4, 1) and (1, 4) on the 4 ranks and onto (2,
     1) on 2, each rank's blocks the virtual restore's; the launcher on
     (2, 2) for 4 steps, relaunched on (4, 1) to step 8, equal to the
     virtual sequence; kernels 7 and 7ᵀ launched in every driver run, and
     their first launch on rank 0 ``torch.equal`` to the plain versions.
     (b) Phase 25b's full-width 2-layer deepseek: its 1,085,287,424
     parameters (bf16; the whole state is 15.2 GB, past the phase's
     budget through gloo's host staging) saved on (data 2, model 2) and
     restored into zero blocks, equal; per rank the save's and restore's
     seconds, bytes received, host RSS, and the bytes on disk. (c) cit-HP
     as one tenant of ``AsyncGraphServer`` on ``RankMesh((4,),
     ("batch",))``, phase 17's csr/csc engines, 64 mixed queries and
     PageRank, a ``mutate``, ``close()``, rank r's ``FakeClock``
     advancing 1 / (1 + 3r) as far as rank 0's: every rank's payloads
     equal to the mesh-less server's (PPR and PageRank within rtol 1e-3,
     atol 1e-6), rank 0's decision ruling every flush (one share each),
     conservation in every snapshot; per rank each flush's wall and the
     shares' bytes.

Order and time. Phase 24b's production meshes launch no hand-written
kernel and time nothing on the card, so they run on the host in a
process of their own while nvcc builds the kernels (phase 1; kernel 6's
source in one nvcc process a semiring), and 24b's cell of phase 23a
after phase 23. Phase 20 follows the build: its prefill and decode
times are host-bound, so nothing else loads the host while it runs. The line before the card's
name is ``{"phase_seconds": ...}``: each group of phases' seconds, from
the ``[t s] phases N`` marks, so every run shows where its time goes.

Launch counters: all eight are set to 0 before phase 3 and kernels 1–2
read after phase 4. In phases 6–8 every call of the fused path, in phase
9 every front-door SpGEMM, in phase 10 every app, in phase 12 each
serving run, in phases 14–15 every multi-source and incremental
traversal, in phase 16 every distributed call and in phase 17 the served
path (capacity run) and each bsr batched run, in phase 18 each
serving run, phase 20 whole, in phases 21 and 23 each train step, and in
phase 24 each traversal on a mesh or one device, and in phase 25 every
rank's distributed call and train step (in the ranks' own processes), runs
with the counters set to 0 just before it and read just after; the
comparisons and timings in between are not counted. The run fails unless kernels 1–2 launched in
phases 3–4 and the block launches did not, kernels 3–5 in phases 6–8,
kernels 6 and 6b in phase 9 (each for the cases it is chosen for),
kernel 6b alone on phase 10's triangle path, kernel 1 on its CC and
k-core paths, kernel 7 on both serving paths (deepseek-v2-lite's
phase 12 and mixtral's phase 18), kernels 1 and 2 over a block
in phases 14–15 (kernel 2's on r-TX), kernels 1, 2, 3, 5, 1b, 2b, 6
and 6b through the mesh in phase 16, and 1b and 2b in phase 17's bsr
cross-check (the served path itself runs csr/csc engines and launches
none; the count is printed), none of the eleven in phase 20, kernels
7 and 7ᵀ in every train step of phases 21 and 23, 1b or 2b in every
traversal of phase 24 on a mesh, and on every rank of phase 25 kernels
1, 2, 3, 5, 1b, 2b, 6 and 6b (a) and 7 and 7ᵀ in every step (b, c), and
7 and 7ᵀ in every rank's driver runs of phase 27a. Any
mismatch raises, so the run
exits non-zero without the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# H100 SXM int32 on the CUDA cores: an SM issues at most 128 integer
# operations per clock, its 64 INT32 lanes beside FP32 lanes that run
# integer adds as IMAD (Hopper architecture white paper), × 132 SMs × 1.98
# GHz; kernel 6's ⟨+,∧⟩ fold, a min and an add a pair, runs above 64
INT32_OPS_PER_S = 128 * 132 * 1.98e9
INT8_OPS_PER_S = 1979e12       # H100 SXM int8 tensor cores, dense
DENSITIES = (0.001, 0.05, 0.6)
PLAIN_REPS = 3                 # CUDA-event timings of a plain version (phases 2, 6), after one
PLAIN_SLOW_REPS = 1            # and of one that takes ~0.1-1 s (phases 8, 9, 14)
RTX_MAX_ITERS = 256
RTX_MULTI_ITERS = 128          # phases 14 and 24: r-TX's multi-source BFS/SSSP levels
PROMPT_LENS = (17, 64, 200, 511)
MAX_NEW_TOKENS = 8
MAX_SEQ = 1024
MESH_GRID = (2, 4)             # phase 16: D = 8 virtual devices
MESH_GRID_BIG = (8, 8)         # and one row at D = 64
MESH_B = 32
PIPE_ITERS = 20
SERVE_ALGS = ("bfs", "sssp", "ppr")
SERVE_BATCH = 32               # phase 17: the servers' bucket
SERVE_QUERIES = 256            # traversals per tenant
SERVE_THREAD_QUERIES = 64      # per tenant in the threaded run
SERVE_SAMPLE = 32              # cit-HP sources per algorithm held to bsr and scipy
SERVE_LOADS = (0.5, 1.0, 2.0)  # offered load, × capacity
# the open loop's stream: the workload 4 times over for each tenant (at
# fewer repeats a tenant's 3-8 windows a load left its miss rates to
# window-granularity noise, and the gate below failed)
SERVE_OPEN_REPEATS = {"cit-HP": 4, "r-TX": 4}
SERVE_RTX_ITERS = 32           # r-TX's traversal depth in the open loop and threaded servers
HUBERT_FRAMES = 1500           # phase 18: frames per request, 512 wide
MIXTRAL_LAYERS = 14            # of 56, 5.01 GB each in bf16: what one card holds
MIXTRAL_FREE_BYTES = 6e9       # left free when fewer fit
MIXTRAL_BATCH = 2
MIXTRAL_PROMPT = 4000          # and 100 decode steps: the ring wraps at 4,096
MIXTRAL_DECODE = 100
SSM_ARCHS = ("xlstm-1.3b", "zamba2-1.2b")   # phase 20, whole, in bf16
SSM_BATCH = 2
SSM_PROMPT = 4000              # 16 chunks of 256, the last one padded
SSM_DECODE = 32
SSM_LONG_SEQ = {"xlstm-1.3b": 1024,         # no positional cache at all
                "zamba2-1.2b": SSM_PROMPT + SSM_DECODE + 96}
SSM_CUT_LAYERS = {"xlstm-1.3b": 8,          # one group: 1 sLSTM + 7 mLSTM
                  "zamba2-1.2b": 7}         # a group of 6 and the remainder: 2 sites
SSM_CHECK_PROMPT = 600         # the cuts' decode against forward
SSM_CHECK_DECODE = 32
TRAIN_LAYERS = 4               # phase 21: deepseek's dense layer and 3 of its 26 MoE layers
TRAIN_BATCH = 4                # sequences a step, of TRAIN_SEQ tokens,
TRAIN_SEQ = 2048
TRAIN_MICRO = 2                # in this many microbatches
TRAIN_MICRO_BATCH = TRAIN_BATCH // TRAIN_MICRO
TRAIN_STEPS = 8
TRAIN_CUT_TOKENS = 128         # phase 21b: 1 × 128 tokens through the f32 cut
FT_STEPS = 12                  # phase 21d: TrainDriver's and the launcher's runs
MESH_TRAIN_SHAPE = (2, 2)      # phase 23a: (data, model) virtual devices
MESH_POD_SHAPE = (2, 2, 2)     # phase 23c: (pod, data, model)
MESH_POD_LAYERS = 2            # phase 23c: the dense layer and one MoE layer
MESH_CUT_ROWS = 2              # phase 23b: 2 × 64 tokens, one row per data group
MESH_CUT_TOKENS = 64
MESH_ROW_DEVICES = (4, 8)      # phase 24: ("batch",) meshes for B = 32 on cit-HP
MESH_ROW_RTX = 8               # and for B = 8 on r-TX, one row a device
RANK_GRID = (2, 4)             # phase 25a: 8 gloo ranks sharing the card, phase 16's mesh
RANK_B = 8                     # 25a: the batched calls' block
RANK_PIPE_ITERS = 8            # 25a: iterate_phases steps at depth 0 and 2
RANK_SPGEMM_COLS = 512         # 25a: B's columns in the SpGEMM on ca-Q
RANK_TRAIN_SHAPE = (2, 2)      # 25b: 4 gloo ranks, (data, model)
RANK_TRAIN_ROWS = 4            # 25b: phase 23's 4 × 2,048 tokens a step
RANK_TRAIN_MICRO = 2           # in 2 microbatches
RANK_TRAIN_STEPS = 2
RANK_POD_SHAPE = (2, 2, 2)     # 25c: 8 gloo ranks, (pod, data, model)
RANK_POD_STEPS = 2
RANK_MULTI_B_SMALL = 6         # phase 26a: bfs over 8 gloo ranks on (2, 4): ranks 6, 7 empty
RANK_SERVE_QUERIES = 64        # phase 26b: mixed bfs/sssp/ppr through the server on 4 ranks
CKPT_STEPS = 12                # phase 27a: TrainDriver's run, an async checkpoint every 4 steps
CKPT_FAILURES = (5, 9)
CKPT_SHAPES = [(4, 1), (1, 4)]  # 27a: restored onto these on the 4 ranks, and (2, 1) on 2
CKPT_LAUNCH = ["--seq", "64", "--global-batch", "4"]   # 27a: the launcher's minitron at 0.05
ASYNC_QUERIES = 64             # 27c: mixed bfs/sssp/ppr on cit-HP, and PageRank
ASYNC_SKEW = 3.0               # 27c: rank r's clock advances 1 / (1 + 3r) as far as rank 0's
# phase 21c's device time by kind of kernel, by words of the kernel's name
TRAIN_KERNEL_KINDS = (("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
                      ("moe_dispatch", ("moe_dispatch",)),
                      ("reduction", ("reduce_kernel",)),
                      ("elementwise", ("elementwise_kernel",)),
                      ("copy_and_index", ("copy", "index", "gather", "scatter", "cat")))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gather_bound(x, slot_tok) -> tuple[float, str, int, int]:
    """Least time of one dispatch gather, in ms: each row of x that a slot
    names read once (a token routed to k experts is one read, not k),
    every output row written once, the index read once, at the memory
    rate. Returns (bound_ms, "bytes", valid slots, rows read)."""
    valid = slot_tok[slot_tok < x.shape[0]]
    n_rows = int(valid.unique().numel())
    s, d = slot_tok.shape[0], x.shape[1]
    nbytes = (n_rows + s) * d * x.element_size() + 4 * s
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", int(valid.numel()), n_rows


def random_plan(torch, dev, b: int, t: int, cfg, gen):
    """The slot→token plan ``moe_sparse`` builds for [b, t] tokens routed
    to distinct random top-k experts, and the layout hint it passes."""
    from repro_torch.models.moe import capacity, dispatch_plan

    ids = torch.argsort(torch.rand((b, t, cfg.n_experts), generator=gen, device=dev), dim=-1)
    c = capacity(t, cfg)
    plan = dispatch_plan(ids[..., :cfg.top_k].to(torch.int32), cfg.n_experts, c)
    return plan.slot_tok, {"group": c, "experts": cfg.n_experts}


def device_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one call, in ms: ``reps`` calls queued behind a
    ~20 ms sleep kernel, so they run back to back however long the
    host takes to launch them; CUDA events around the run, over reps.
    Kernel 7 runs for microseconds, less than a call's host time, so
    a single-call timing would measure the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time of one call, in µs: ``reps`` calls issued back to back
    with no sync between them (the launch path alone, while the card
    works behind it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / reps * 1e6


def gather_row(torch, dev, x, tok, hint: dict, label: str, time_ms) -> dict:
    """Kernel 7 on the path ``moe_sparse`` takes (``ops.moe_dispatch_gather``
    with the plan's layout ``hint``) and without the hint (the flat path),
    each against its plain version (``torch.equal``), and the library's
    index_select on a zero-row-extended x: device times of each; the
    single-call times (``call_ms``, CUDA events around one call, the
    host's share included) and host times a call (``host_us``) of the
    kernel and index_select; the path each call took, as the wrapper
    counts it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather

    def taken(fn):
        before = dict(moe_dispatch_gather.paths)
        out = fn()
        return out, next(p for p, n in moe_dispatch_gather.paths.items() if n > before[p])

    y, path = taken(lambda: ops.moe_dispatch_gather(x, tok, **hint))
    y_flat, unhinted_path = taken(lambda: ops.moe_dispatch_gather(x, tok))
    y_plain = ref.moe_dispatch_gather_ref(x, tok)
    torch.cuda.synchronize()
    check(torch.equal(y, y_plain), f"kernel 7 {label}: differs from the plain version")
    check(torch.equal(y_flat, y_plain), f"kernel 7 {label}: unhinted, differs from the plain "
          "version")
    x_ext = torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype, device=dev)])
    tok_lib = tok.clamp(max=x.shape[0])
    check(torch.equal(x_ext.index_select(0, tok_lib), y), f"kernel 7 {label}: index_select")
    bound_ms, bound_by, n_valid, n_rows = gather_bound(x, tok)
    return {"kernel": "moe_dispatch_gather", "plan": label, "dtype": str(x.dtype),
            "T": x.shape[0], "S": tok.shape[0], "D": x.shape[1], "hint": hint,
            "path": path, "unhinted_path": unhinted_path,
            "n_valid": n_valid, "rows_read": n_rows,
            "max_abs_err": max(float((z.float() - y_plain.float()).abs().max())
                               for z in (y, y_flat)),
            "ms": device_ms(torch, lambda: ops.moe_dispatch_gather(x, tok, **hint)),
            "unhinted_ms": device_ms(torch, lambda: ops.moe_dispatch_gather(x, tok)),
            "call_ms": time_ms(lambda: ops.moe_dispatch_gather(x, tok, **hint)),
            "plain_ms": device_ms(torch, lambda: ref.moe_dispatch_gather_ref(x, tok)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(torch, lambda: x_ext.index_select(0, tok_lib)),
            "library_call_ms": time_ms(lambda: x_ext.index_select(0, tok_lib)),
            "host_us": host_us(torch, lambda: ops.moe_dispatch_gather(x, tok, **hint)),
            "library_host_us": host_us(torch, lambda: x_ext.index_select(0, tok_lib))}


def lm_phases(torch, dev, cfg, prompt_lens, max_new: int, max_seq: int, time_ms,
              cfg13) -> dict:
    """Phases 11-13: kernel 7 against its plain version, the serving path
    on the full model in bf16, and a 2-layer f32 cut of it on the card
    against the host. Returns kernel 7's row on phase 12's decode plan,
    with phase 12's launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    from repro_torch.models.zoo import count_params

    # ---------------------------------------------------------------- 11
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, m, d = len(prompt_lens), cfg.moe, cfg.d_model
    t_pre = max(prompt_lens)
    for dtype in (torch.bfloat16, torch.float32):
        for label, t in (("decode", 1), ("prefill", t_pre)):
            x = torch.randn((b * t, d), generator=gen, device=dev).to(dtype)
            tok, hint = random_plan(torch, dev, b, t, m, gen)
            print(json.dumps(gather_row(torch, dev, x, tok, hint, f"random {label}", time_ms)))
    print("phase 11: kernel 7 equals its plain version on decode- and prefill-shaped plans, "
          "bf16 and f32")

    # ---------------------------------------------------------------- 12
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()     # phase 22b's baseline
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n) for n in prompt_lens]
    captured = {}
    real_gather = ops.moe_dispatch_gather

    def capture(x, slot_tok, **hint):
        key = "prefill" if x.shape[0] > b else "decode"
        captured.setdefault(key, (x.clone(), slot_tok.to(torch.int32).clone(), hint))
        return real_gather(x, slot_tok, **hint)

    runs, cache = serve_runs(torch, dev, model, prompts, max_new, max_seq, runs=2,
                             capture=capture)
    del cache
    routed = cfg.n_layers - m.first_dense_layers
    for r in runs:
        check(r["kernel7_launches"] == routed * (1 + r["decode_steps"]),
              f"kernel 7 launched {r['kernel7_launches']} times, not {routed} × "
              f"(1 + {r['decode_steps']})")
    check(runs[0]["generated"] == runs[1]["generated"], "a second run gave other tokens")
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"peak memory {peak} bytes")
    for r in runs:
        print(json.dumps({k: v for k, v in r.items() if k != "generated"}))
    print(json.dumps({"phase": 12, "arch": cfg.arch_id, "params": count_params(cfg),
                      "dtype": str(cfg.dtype), "batch": b, "prompt_lens": list(prompt_lens),
                      "max_new_tokens": max_new, "max_seq": max_seq, "init_s": init_s,
                      "max_memory_allocated": peak,
                      "first_tokens": [g[:8] for g in runs[0]["generated"]]}))
    # a traced window of 3 decode steps: device busy time against the wall
    print(json.dumps({"phase": 12, **decode_profile(torch, model, prompts, max_seq)}))
    check(all(v[2] == {"group": v[1].shape[0] // (b * m.n_experts), "experts": m.n_experts}
              for v in captured.values()), "moe_sparse did not pass its plan's layout hint")
    summary = gather_row(torch, dev, *captured["decode"], "phase-12 decode", time_ms)
    print(json.dumps(summary))
    print(json.dumps(gather_row(torch, dev, *captured["prefill"], "phase-12 prefill", time_ms)))
    summary["launches"] = runs[0]["kernel7_launches"]
    print(f"phase 12: {cfg.arch_id} served {b} requests × {max_new} tokens in bf16 "
          f"twice with identical tokens; kernel 7 launched {summary['launches']} times")
    del captured

    # ---------------------------------------------------------------- 22b
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.engine import make_serve_step

    cache = model.init_cache(b, max_seq)
    logits, cache = model.prefill(left_padded(torch, prompts, dev), cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    del logits
    serve_step = make_serve_step(model)
    dry = hold_dryrun(torch, "b", lambda: serve_step(tok, cache), (dict(model.named_parameters()),
                                                                     cache, tok),
                      base_bytes, statistics.median(r["decode_ms_per_step"] for r in runs),
                      cfg.arch_id, ShapeConfig("decode_4x1024", max_seq, b, "decode"), cfg, None,
                      {"moe_dispatch_gather": routed})
    summary["phase22b_s"] = dry["seconds"]
    del model, cache, tok
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 13
    card_against_host(torch, dev, cfg13, prompt_lens, max_seq, 13,
                      f"{cfg.arch_id}, {cfg13.n_layers} layers")
    torch.cuda.empty_cache()
    return summary


def serve_runs(torch, dev, model, prompts, budget: int, seq: int, runs: int = 1,
               capture=None):
    """``ServingEngine.run`` ``runs`` times, each with the kernel-7
    count set to 0 just before it and read just after (``capture``, if
    given, stands in for ``ops.moe_dispatch_gather`` meanwhile); prefill
    and each decode step timed on the host clock (each ends in a sync).
    Every request must get its budget and every logit be finite. Returns
    the runs' rows and the last cache."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather
    from repro_torch.serve.engine import Request, ServingEngine

    real_gather = ops.moe_dispatch_gather
    engine = ServingEngine(model, max_seq=seq, device=dev)
    timings = {"prefill": [], "decode": []}
    state = {"finite": torch.ones((), dtype=torch.bool, device=dev), "cache": None}

    def timed(label, fn):
        def step(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            timings[label].append((time.perf_counter() - t0) * 1e3)
            logits = out[0] if label == "prefill" else out[1]
            state["finite"] = state["finite"] & torch.isfinite(logits).all()
            state["cache"] = out[-1]
            return out
        return step

    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)
    out = []
    for _ in range(runs):
        for k in timings.values():
            k.clear()
        if capture is not None:
            ops.moe_dispatch_gather = capture
        moe_dispatch_gather.launches = 0
        t0 = time.perf_counter()
        try:
            done = engine.run([Request(prompt=p.tolist(), max_new_tokens=budget)
                               for p in prompts])
        finally:
            ops.moe_dispatch_gather = real_gather
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = moe_dispatch_gather.launches
        steps = len(timings["decode"])
        decode_ms = sum(timings["decode"])
        check(all(len(r.generated) == budget for r in done),
              f"{model.cfg.arch_id}: a request missed its budget")
        out.append({"run": len(out) + 1, "wall_ms": wall_ms, "prefill_ms": timings["prefill"][0],
                    "decode_steps": steps, "decode_ms_per_step": decode_ms / max(steps, 1),
                    "decode_tokens_per_s": len(prompts) * steps / (decode_ms / 1e3),
                    "tokens_per_s": sum(len(r.generated) for r in done) / (wall_ms / 1e3),
                    "kernel7_launches": launches,
                    "generated": [r.generated for r in done]})
    check(bool(state["finite"]), f"{model.cfg.arch_id}: non-finite logits on the serving path")
    return out, state["cache"]


def left_padded(torch, prompts, device):
    """Prompts left-padded with token 0 to the longest, as
    ``ServingEngine.run`` pads them: int64 [B, T] on ``device``."""
    import numpy as np

    toks = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    return torch.from_numpy(toks).to(device)


def card_against_host(torch, dev, cfg, prompt_lens, max_seq: int, phase: int, label: str):
    """A cut of a model in f32 (TF32 off) on the card and on the host from
    the same weights, matrices redrawn by ``redraw_matrices``: prefill
    phase 12's prompts and take 4 greedy steps. Every MoE call routes
    alike, every card launch of kernel 7 equals its plain version on the
    card's inputs and the host path's rows, the greedy tokens are the
    same, the logits within rtol 1e-3, atol 1e-4. Prints the row and
    returns the card model."""
    import numpy as np

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather
    from repro_torch.models import moe
    from repro_torch.models.transformer import build_model
    from repro_torch.models.zoo import count_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    card = build_model(cfg, device=dev).init(g)
    redraw_matrices(torch, card, g)
    host = build_model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n) for n in prompt_lens]
    routes, gathers, out = {}, {}, {}
    real_plan, real_gather = moe.dispatch_plan, ops.moe_dispatch_gather

    def record(top_ids, *args):
        routes[where].append(top_ids.cpu())
        return real_plan(top_ids, *args)

    def gather(x, slot_tok, **hint):
        y = real_gather(x, slot_tok, **hint)
        gathers[where].append((x, slot_tok, y) if where == "card" else (slot_tok, y))
        return y

    moe.dispatch_plan, ops.moe_dispatch_gather = record, gather
    moe_dispatch_gather.launches = 0
    try:
        for where, mdl in (("card", card), ("host", host)):
            routes[where], gathers[where] = [], []
            t0 = time.perf_counter()
            cache = mdl.init_cache(len(prompts), max_seq)
            logits, cache = mdl.prefill(left_padded(torch, prompts, mdl.embed.device), cache)
            seq = [logits.float().cpu()]
            for _ in range(4):
                tok = torch.argmax(logits, dim=-1)[:, None]
                logits, cache = mdl.decode(tok, cache)
                seq.append(logits.float().cpu())
            if where == "card":
                torch.cuda.synchronize()
            out[where] = (seq, (time.perf_counter() - t0) * 1e3)
            del cache
    finally:
        moe.dispatch_plan, ops.moe_dispatch_gather = real_plan, real_gather
    n_moe = 5 * sum(getattr(blk, "ffn", None) == "moe"
                    for _, blocks in card.stack_modules() for blk in blocks)
    check(len(routes["card"]) == len(routes["host"]) == n_moe,
          f"phase {phase} {label}: routing not recorded")
    check(moe_dispatch_gather.launches == n_moe,
          f"phase {phase} {label}: kernel 7 launched {moe_dispatch_gather.launches} times")
    for i, (rc, rh) in enumerate(zip(routes["card"], routes["host"])):
        check(torch.equal(rc, rh), f"phase {phase} {label}: routing differs at MoE call {i}")
    gather_err = 0.0
    for i, ((x, tok, y), (tok_h, y_h)) in enumerate(zip(gathers["card"], gathers["host"])):
        check(torch.equal(y, ref.moe_dispatch_gather_ref(x, tok)),
              f"phase {phase} {label}: kernel 7 differs from its plain version at call {i}")
        check(torch.equal(tok.cpu(), tok_h), f"phase {phase} {label}: slot plans differ at {i}")
        torch.testing.assert_close(y.cpu(), y_h, rtol=1e-3, atol=1e-4,
                                   msg=lambda m: f"phase {phase} {label} gather {i}: {m}")
        gather_err = max(gather_err, float((y.cpu() - y_h).abs().max()))
    worst = 0.0
    for i, (lc, lh) in enumerate(zip(out["card"][0], out["host"][0])):
        check(torch.equal(lc.argmax(-1), lh.argmax(-1)),
              f"phase {phase} {label}: greedy tokens differ at {i}")
        torch.testing.assert_close(lc, lh, rtol=1e-3, atol=1e-4,
                                   msg=lambda m: f"phase {phase} {label} step {i}: {m}")
        worst = max(worst, float((lc - lh).abs().max()))
    print(json.dumps({"phase": phase, "cut": label, "layers": cfg.n_layers,
                      "params": count_params(cfg), "dtype": str(cfg.dtype),
                      "card_ms": out["card"][1], "host_ms": out["host"][1],
                      "moe_calls": n_moe, "max_abs_logit_diff": worst,
                      "max_abs_gather_diff": gather_err,
                      "tokens": [lc.argmax(-1).tolist() for lc in out["card"][0]]}))
    print(f"phase {phase}: {label}, f32, TF32 off: card and host route every token alike and "
          f"pick the same greedy tokens; largest logit difference {worst:.3g}")
    return card


def decode_profile(torch, model, prompts, seq: int) -> dict:
    """A traced window of 3 decode steps after a prefill of ``prompts``:
    device busy time against the wall, launches a step, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(len(prompts), seq)
    logits, cache = model.prefill(left_padded(torch, prompts, model.device), cache)
    tok = torch.argmax(logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            logits, cache = model.decode(tok, cache)
            tok = torch.argmax(logits, dim=-1)[:, None]
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {"traced_decode_steps": 3, "window_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / window_ms if window_ms else None,
            "kernel_launches_per_step": sum(e.count for e in kernels) / 3,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}


def cache_tensors(tree) -> list:
    """Every tensor of a cache tree (dicts, lists and the cache NamedTuples,
    the recurrent states' nested ``GLAState`` included), in order."""
    if hasattr(tree, "data_ptr"):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in cache_tensors(v)]
    return []


def cache_tensor_bytes(cache: dict) -> int:
    """Bytes of a model's caches as ``kv_cache.cache_bytes`` counts them:
    every tensor, plus one int32 for each attention cache's ``pos`` (the
    recurrent states have none)."""
    return sum(sum(t.numel() * t.element_size() for t in cache_tensors(c))
               + (4 if hasattr(c, "pos") else 0)
               for seg in cache.values() for c in seg)


def redraw_matrices(torch, model, gen) -> None:
    """Every matrix but the embedding redrawn with std 1/√(input width), as
    phase 13 does: under the reference's stacked fan-in a one-layer segment
    draws with std 1, and f32 rounding alone then moves the logits past
    the card-against-host tolerance. Mamba2's B and C projections (``w_B``,
    ``w_C``) are drawn at std 1/√(d_model · d_state), so their scores over
    d_state are O(1) as attention's scaled scores are: at 1/√d_model a
    7-layer zamba2 at d_model 160 in f32 already decodes 1.6e-4 away from
    its own forward on the host CPU. A tied embedding is the output head
    too, and is redrawn as a matrix of input width d_model: at its std of
    1 the full-width xLSTM and zamba2 cuts give logits up to ~2,000, whose
    f32 rounding alone passes atol 1e-4 near zero."""
    tied = model.cfg.tie_embeddings
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "embed" and tied:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
            elif p.dim() >= 2 and name != "embed":
                std = p.shape[-2] ** -0.5
                if name.endswith((".w_B", ".w_C")):
                    std /= p.shape[-1] ** 0.5
                p.normal_(0.0, std, generator=gen)


def gqa_phases(torch, dev, time_ms, prompt_lens, max_new: int, max_seq: int) -> dict:
    """Phases 18-19: the GQA families at full width in bf16 on the card
    (mistral-nemo-12b served twice, deepseek-7b, minitron-4b, qwen1.5-32b,
    hubert-xlarge, llama-3.2-vision-11b, mixtral-8x22b cut in depth), then
    f32 cuts of nemo and mixtral on the card against the host and the
    ring check. Returns kernel 7's row of the kernels line (phase 18's
    mixtral decode plan, D = 6144) with phase 18's launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.layers import QuantKVCache, quantize_kv
    from repro_torch.models.transformer import build_model
    from repro_torch.models.zoo import count_params, get_config
    from repro_torch.serve import kv_cache
    from repro_torch.serve.engine import make_prefill_step, make_serve_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"phase": 18, "allocated_at_start": torch.cuda.memory_allocated()}))
    b = len(prompt_lens)
    real_gather = ops.moe_dispatch_gather

    def build(cfg, seed=SEED):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    def report(cfg, model, init_s, run, cache, full_layers, seq, batch, **extra):
        c_bytes = kv_cache.cache_bytes(cfg, batch, seq)
        if cache is not None:
            check(cache_tensor_bytes(cache) == c_bytes,
                  f"{cfg.arch_id}: cache tensors hold {cache_tensor_bytes(cache)} bytes, "
                  f"cache_bytes says {c_bytes}")
            if cfg.kv_quant:
                for seg in cache.values():
                    for c in seg:
                        check(isinstance(c, QuantKVCache) and c.k.dtype == torch.int8
                              and c.v.dtype == torch.int8, f"{cfg.arch_id}: not an int8 cache")
                        check(int(c.k.min()) >= -127 and int(c.v.min()) >= -127,
                              f"{cfg.arch_id}: an int8 code below -127")
        row = {"phase": 18, "arch": cfg.arch_id, "params": count_params(cfg),
               "layers_run": cfg.n_layers, "layers": full_layers, "dtype": str(cfg.dtype),
               "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
               "cache_bytes": c_bytes, "batch": batch, "max_seq": seq,
               "max_memory_allocated": torch.cuda.max_memory_allocated(), "init_s": init_s}
        if run is not None:
            row.update({k: v for k, v in run.items() if k != "generated"})
            row["first_tokens"] = [g[:8] for g in run["generated"]]
        row.update(extra)
        print(json.dumps(row))
        return row

    # ---------------------------------------------------------------- 18
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((b, 64, 32, 128), generator=gen, device=dev) * 3
    qc, sc = quantize_kv(x)
    qh, sh = quantize_kv(x.cpu())
    check(torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh),
          "quantize_kv on the card differs from the host")
    print(json.dumps({"phase": 18, "quantize_kv": "card equals host bit for bit",
                      "shape": list(x.shape), "codes_at_127": int((qh.abs() == 127).sum())}))
    del x, qc, sc

    rows = {}
    for arch in ("mistral-nemo-12b", "deepseek-7b", "minitron-4b", "qwen1.5-32b"):
        cfg = get_config(arch)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab, n) for n in prompt_lens]
        model, init_s = build(cfg)
        runs, cache = serve_runs(torch, dev, model, prompts, max_new, max_seq,
                                 runs=2 if arch == "mistral-nemo-12b" else 1)
        if len(runs) == 2:
            check(runs[0]["generated"] == runs[1]["generated"],
                  f"{arch}: a second run gave other tokens")
        for r in runs:
            check(r["kernel7_launches"] == 0, f"{arch}: kernel 7 launched on a dense model")
        rows[arch] = report(cfg, model, init_s, runs[-1], cache, cfg.n_layers, max_seq, b,
                            runs=len(runs))
        del cache
        if arch == "mistral-nemo-12b":
            print(json.dumps({"phase": 18, "arch": arch, **decode_profile(torch, model, prompts,
                                                                          max_seq)}))
        del model
        torch.cuda.empty_cache()

    # hubert: encode [4, 1500, 512] frames, non-causal, no cache
    cfg = get_config("hubert-xlarge")
    model, init_s = build(cfg)
    frames = torch.randn((b, HUBERT_FRAMES, cfg.frontend_dim), generator=gen,
                         device=dev).to(cfg.dtype)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, cache = model.prefill(frames=frames)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    check(cache == {} and tuple(logits.shape) == (b, HUBERT_FRAMES, cfg.vocab),
          f"hubert: encode gave {tuple(logits.shape)} and a cache")
    check(bool(torch.isfinite(logits).all()), "hubert: non-finite logits")
    rows[cfg.arch_id] = report(cfg, model, init_s, None, None, cfg.n_layers, HUBERT_FRAMES, b,
                               frames=list(frames.shape), encode_ms=walls[-1],
                               first_encode_ms=walls[0],
                               frames_per_s=b * HUBERT_FRAMES / (walls[-1] / 1e3))
    del model, frames, logits
    torch.cuda.empty_cache()

    # llama-3.2-vision: served (text only), then prefill with image_embeds
    # and decode with vision_kv
    cfg = get_config("llama-3.2-vision-11b")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n) for n in prompt_lens]
    model, init_s = build(cfg)
    runs, cache = serve_runs(torch, dev, model, prompts, max_new, max_seq)
    del cache
    image = torch.randn((b, cfg.vlm.vision_tokens, cfg.vlm.vision_dim), generator=gen,
                        device=dev).to(cfg.dtype)
    toks = left_padded(torch, prompts, dev)
    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
    t0 = time.perf_counter()
    logits, cache = prefill_step(toks, model.init_cache(b, max_seq), image)
    vision = model.vision_kv(image)
    torch.cuda.synchronize()
    vlm_prefill_ms = (time.perf_counter() - t0) * 1e3
    text_logits, _ = model.prefill(toks, model.init_cache(b, max_seq))
    # the reference's init zeroes every gate, tanh(0) = 0: the vision
    # path adds exact zeros
    check(torch.equal(logits, text_logits), "llama-vision: a closed gate moved the logits")
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        tok, logits, cache = serve_step(tok, cache, vision)
        finite = finite & torch.isfinite(logits).all()
    torch.cuda.synchronize()
    vlm_decode_ms = (time.perf_counter() - t0) * 1e3 / (max_new - 1)
    check(bool(finite), "llama-vision: non-finite logits with vision_kv")
    rows[cfg.arch_id] = report(cfg, model, init_s, runs[0], cache, cfg.n_layers, max_seq, b,
                               image_embeds=list(image.shape), vision_kv=list(vision.shape),
                               vision_prefill_ms=vlm_prefill_ms,
                               vision_decode_ms_per_step=vlm_decode_ms)
    del model, cache, image, vision, logits, text_logits, prefill_step, serve_step
    torch.cuda.empty_cache()

    # mixtral: the most layers one card holds with MIXTRAL_FREE_BYTES left
    full = get_config("mixtral-8x22b")
    seq = MIXTRAL_PROMPT + MIXTRAL_DECODE
    one = dataclasses.replace(full, n_layers=1)
    per_layer = (count_params(dataclasses.replace(full, n_layers=2)) - count_params(one)) * 2
    base = count_params(one) * 2 - per_layer
    cache_per_layer = kv_cache.cache_bytes(one, MIXTRAL_BATCH, seq)
    free_bytes = torch.cuda.mem_get_info()[0]
    fit = int((free_bytes - MIXTRAL_FREE_BYTES - base) // (per_layer + cache_per_layer))
    n_layers = min(MIXTRAL_LAYERS, fit)
    check(n_layers >= 1, f"mixtral: not one layer fits in {free_bytes} free bytes")
    cfg = dataclasses.replace(full, n_layers=n_layers)
    captured = {}

    def capture(x, slot_tok, **hint):
        key = "prefill" if x.shape[0] > MIXTRAL_BATCH else "decode"
        captured.setdefault(key, (x.clone(), slot_tok.to(torch.int32).clone(), hint))
        return real_gather(x, slot_tok, **hint)

    gen_m = torch.Generator(device=dev).manual_seed(SEED)
    prompts = [torch.randint(0, cfg.vocab, (MIXTRAL_PROMPT,), generator=gen_m, device=dev).cpu()
               .numpy() for _ in range(MIXTRAL_BATCH)]
    model, init_s = build(cfg)
    runs, cache = serve_runs(torch, dev, model, prompts, MIXTRAL_DECODE + 1, seq,
                             capture=capture)
    run = runs[0]
    check(run["decode_steps"] == MIXTRAL_DECODE, f"mixtral: {run['decode_steps']} decode steps")
    check(run["kernel7_launches"] == n_layers * (1 + MIXTRAL_DECODE),
          f"mixtral: kernel 7 launched {run['kernel7_launches']} times, not {n_layers} × "
          f"(1 + {MIXTRAL_DECODE})")
    ring = cache["moe_layers"][0]
    check(ring.k.shape[1] == cfg.sliding_window and ring.pos == seq,
          f"mixtral: ring of {ring.k.shape[1]} slots at pos {ring.pos}")
    n_valid = {k: gather_bound(x, tok)[2] for k, (x, tok, _) in captured.items()}
    check(all(hint["experts"] == cfg.moe.n_experts for _, _, hint in captured.values()),
          "mixtral: moe_sparse did not pass its plan's layout hint")
    rows[cfg.arch_id] = report(
        cfg, model, init_s, run, cache, full.n_layers, seq, MIXTRAL_BATCH,
        prompt_tokens=MIXTRAL_PROMPT, window=cfg.sliding_window,
        capacity_factor=cfg.moe.capacity_factor, free_bytes_before=free_bytes,
        bytes_per_layer=per_layer, layers_that_fit=fit,
        prefill_assignments_dropped=MIXTRAL_BATCH * MIXTRAL_PROMPT * cfg.moe.top_k
        - n_valid["prefill"])
    del cache, ring
    print(json.dumps({"phase": 18, "arch": cfg.arch_id, **decode_profile(torch, model, prompts, seq)}))
    del model
    torch.cuda.empty_cache()
    summary = gather_row(torch, dev, *captured["decode"], "phase-18 mixtral decode", time_ms)
    print(json.dumps(summary))
    pre = gather_row(torch, dev, *captured["prefill"], "phase-18 mixtral prefill", time_ms)
    print(json.dumps(pre))
    check(pre["path"] == "window", f"kernel 7 took the {pre['path']} path on mixtral's prefill "
          "plan, not the window path")
    summary["launches"] = run["kernel7_launches"]
    summary["max_abs_err"] = max(summary["max_abs_err"], pre["max_abs_err"])
    del captured
    torch.cuda.empty_cache()
    print(f"phase 18: {len(rows)} GQA archs at full width in bf16 ({n_layers} of "
          f"{full.n_layers} mixtral layers); mistral-nemo-12b served twice with identical "
          f"tokens; kernel 7 launched {summary['launches']} times in mixtral's layers")

    # ---------------------------------------------------------------- 19
    nemo = get_config("mistral-nemo-12b")
    card_against_host(torch, dev, dataclasses.replace(nemo, n_layers=2, dtype=torch.float32),
                      prompt_lens, max_seq, 19, "mistral-nemo-12b, 2 layers")
    torch.cuda.empty_cache()
    card = card_against_host(torch, dev, dataclasses.replace(full, n_layers=1,
                                                             dtype=torch.float32),
                             prompt_lens, max_seq, 19, "mixtral-8x22b, 1 MoE layer")

    # the ring (f32, TF32 off since card_against_host): capacity factor
    # 4.0 (no token drops, as the reference's reduced config sets it),
    # prefill then decode across the wrap against the window-masked
    # forward over the same tokens
    cfg4 = dataclasses.replace(card.cfg, moe=dataclasses.replace(card.cfg.moe,
                                                                  capacity_factor=4.0))
    model = build_model(cfg4, device=dev)
    model.load_state_dict(card.state_dict())
    del card
    torch.cuda.empty_cache()
    gen_r = torch.Generator(device=dev).manual_seed(SEED + 2)
    toks = torch.randint(0, cfg4.vocab, (MIXTRAL_BATCH, MIXTRAL_PROMPT), generator=gen_r,
                         device=dev)
    t0 = time.perf_counter()
    cache = model.init_cache(MIXTRAL_BATCH, seq)
    logits, cache = model.prefill(toks, cache)
    steps, fed = [logits], []
    for _ in range(MIXTRAL_DECODE):
        fed.append(torch.argmax(logits, dim=-1)[:, None])
        logits, cache = model.decode(fed[-1], cache)
        steps.append(logits)
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    ring = cache["moe_layers"][0]
    check(ring.k.shape[1] == cfg4.sliding_window and ring.pos == seq,
          f"phase 19 ring: {ring.k.shape[1]} slots at pos {ring.pos}")
    del cache, ring
    t0 = time.perf_counter()
    full_logits = model.forward(torch.cat([toks] + fed, dim=1))
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for i, lg in enumerate(steps):
        want = full_logits[:, MIXTRAL_PROMPT - 1 + i]
        torch.testing.assert_close(lg, want, rtol=1e-3, atol=1e-4,
                                   msg=lambda s: f"phase 19 ring step {i}: {s}")
        worst = max(worst, float((lg - want).abs().max()))
    print(json.dumps({"phase": 19, "ring": "mixtral-8x22b, 1 MoE layer, f32, cf 4.0",
                      "batch": MIXTRAL_BATCH, "prompt": MIXTRAL_PROMPT,
                      "decode_steps": MIXTRAL_DECODE, "window": cfg4.sliding_window,
                      "wrapped_at": cfg4.sliding_window, "prefill_and_decode_ms": ring_ms,
                      "forward_ms": forward_ms, "max_abs_logit_diff": worst}))
    del model, full_logits, steps, fed
    torch.cuda.empty_cache()
    print(f"phase 19: f32 cuts on the card equal the host (same routing and greedy tokens); "
          f"the ring decode across position {cfg4.sliding_window} equals the window-masked "
          f"forward (largest logit difference {worst:.3g})")
    print(json.dumps({"phase": "18-19", "seconds": time.perf_counter() - t_phase}))
    return summary


def ssm_phases(torch, dev, prompt_lens, max_new: int, max_seq: int, all_kernels) -> dict:
    """Phase 20: the ssm and hybrid families. xlstm-1.3b and zamba2-1.2b,
    whole in bf16 with random weights from seed 0 by the reference's
    rule, each built, run and freed before the next: phase 12's requests
    served twice with the same tokens, a profiler window of 3 decode
    steps, then batch 2 × a 4,000-token prompt and 32 decode steps with
    every cache tensor keeping its storage and shape from ``init_cache``
    on. Then f32 cuts at full width (TF32 off, matrices redrawn) on the
    card against the host, and on the card each decode step against
    ``forward`` over the same tokens. No hand-written kernel is on this
    path: all ten launch counts must stay 0. Returns the rows by arch."""
    import numpy as np

    from repro_torch.models.transformer import build_model
    from repro_torch.models.zoo import count_params, get_config
    from repro_torch.serve import kv_cache

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for k in all_kernels:
        k.launches = 0
    b = len(prompt_lens)
    rows = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab, n) for n in prompt_lens]
        runs, cache = serve_runs(torch, dev, model, prompts, max_new, max_seq, runs=2)
        check(runs[0]["generated"] == runs[1]["generated"],
              f"{arch}: a second run gave other tokens")
        check(all(r["kernel7_launches"] == 0 for r in runs), f"{arch}: kernel 7 launched")
        c_bytes = kv_cache.cache_bytes(cfg, b, max_seq)
        check(cache_tensor_bytes(cache) == c_bytes,
              f"{arch}: cache tensors hold {cache_tensor_bytes(cache)} bytes, cache_bytes says "
              f"{c_bytes}")
        del cache
        row = {"phase": 20, "arch": arch, "params": count_params(cfg), "layers": cfg.n_layers,
               "dtype": str(cfg.dtype),
               "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
               "cache_bytes": c_bytes, "batch": b, "max_seq": max_seq, "init_s": init_s,
               "max_memory_allocated": torch.cuda.max_memory_allocated(), "runs": len(runs),
               **{k: v for k, v in runs[-1].items() if k != "generated"},
               "first_tokens": [g[:8] for g in runs[-1]["generated"]]}
        row.update(decode_profile(torch, model, prompts, max_seq))
        print(json.dumps(row))

        # the long prompt: the recurrent state must not grow or move
        seq = SSM_LONG_SEQ[arch]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        long_prompts = [torch.randint(0, cfg.vocab, (SSM_PROMPT,), generator=gen, device=dev)
                        .cpu().numpy() for _ in range(SSM_BATCH)]
        born = {}
        real_init = model.init_cache

        def init_cache(batch, size):
            c = real_init(batch, size)
            born["tensors"] = [(t.data_ptr(), tuple(t.shape)) for t in cache_tensors(c)]
            return c

        model.init_cache = init_cache
        torch.cuda.reset_peak_memory_stats()
        try:
            long_runs, cache = serve_runs(torch, dev, model, long_prompts, SSM_DECODE + 1, seq)
        finally:
            del model.init_cache
        run = long_runs[0]
        check(run["decode_steps"] == SSM_DECODE, f"{arch}: {run['decode_steps']} decode steps")
        check(run["kernel7_launches"] == 0, f"{arch}: kernel 7 launched on the long prompt")
        now = [(t.data_ptr(), tuple(t.shape)) for t in cache_tensors(cache)]
        check(now == born["tensors"], f"{arch}: a cache tensor moved or changed shape between "
              f"init_cache and the last of {SSM_DECODE} decode steps")
        sites = [c.pos for c in cache.get("attn", [])]
        check(all(p == SSM_PROMPT + SSM_DECODE for p in sites), f"{arch}: site positions {sites}")
        long_bytes = kv_cache.cache_bytes(cfg, SSM_BATCH, seq)
        check(cache_tensor_bytes(cache) == long_bytes, f"{arch}: long-prompt cache bytes")
        print(json.dumps({"phase": 20, "arch": arch, "long_prompt": SSM_PROMPT,
                          "batch": SSM_BATCH, "max_seq": seq, "cache_bytes": long_bytes,
                          "cache_tensors": len(now), "storage_kept": True,
                          "max_memory_allocated": torch.cuda.max_memory_allocated(),
                          **{k: v for k, v in run.items() if k != "generated"}}))
        rows[arch] = row
        del model, cache
        gc.collect()
        torch.cuda.empty_cache()

    # f32 cuts at full width: card against host, then decode against forward
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=SSM_CUT_LAYERS[arch],
                                  dtype=torch.float32)
        label = f"{arch}, {cfg.n_layers} layers"
        card = card_against_host(torch, dev, cfg, prompt_lens, max_seq, 20, label)
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        toks = torch.randint(0, cfg.vocab, (SSM_BATCH, SSM_CHECK_PROMPT), generator=gen,
                             device=dev)
        t0 = time.perf_counter()
        cache = card.init_cache(SSM_BATCH, SSM_CHECK_PROMPT + SSM_CHECK_DECODE)
        logits, cache = card.prefill(toks, cache)
        steps, fed = [logits], []
        for _ in range(SSM_CHECK_DECODE):
            fed.append(torch.argmax(logits, dim=-1)[:, None])
            logits, cache = card.decode(fed[-1], cache)
            steps.append(logits)
        torch.cuda.synchronize()
        stepwise_ms = (time.perf_counter() - t0) * 1e3
        full = card.forward(torch.cat([toks] + fed, dim=1))
        worst = 0.0
        for i, lg in enumerate(steps):
            want = full[:, SSM_CHECK_PROMPT - 1 + i]
            torch.testing.assert_close(lg, want, rtol=1e-3, atol=1e-4,
                                       msg=lambda m: f"phase 20 {label} decode step {i}: {m}")
            worst = max(worst, float((lg - want).abs().max()))
        print(json.dumps({"phase": 20, "cut": label, "decode_against_forward": True,
                          "batch": SSM_BATCH, "prompt": SSM_CHECK_PROMPT,
                          "decode_steps": SSM_CHECK_DECODE, "prefill_and_decode_ms": stepwise_ms,
                          "max_abs_logit_diff": worst}))
        del card, cache, full, steps, fed
        torch.cuda.empty_cache()

    counts = {k.__name__: k.launches for k in all_kernels}
    print(json.dumps({"phase": 20, "kernel_launches": counts,
                      "seconds": time.perf_counter() - t_phase}))
    check(not any(counts.values()), f"a hand-written kernel launched in phase 20: {counts}")
    print(f"phase 20: xlstm-1.3b and zamba2-1.2b served whole in bf16 twice with identical "
          f"tokens; {SSM_PROMPT}-token prompts decoded {SSM_DECODE} steps in the storage "
          f"init_cache gave; f32 cuts equal the host and decode equals forward; no kernel launched")
    return rows


def profile_step(torch, run) -> tuple:
    """``run()`` once under ``torch.profiler`` (CPU and CUDA), its loss read
    and the card synchronised: (its result, {window ms on the host clock,
    device busy ms, idle share, kernel launches, device ms by kind of
    kernel, the top 8 kernels' ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        float(out[-1]["loss"])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    by_kind = {}
    for e in events:
        kind = next((k for k, words in TRAIN_KERNEL_KINDS if any(w in e.key for w in words)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    return out, {"window_ms": window_ms, "device_busy_ms": busy_ms,
                 "device_idle_share": 1 - busy_ms / window_ms,
                 "launches": sum(e.count for e in events), "device_ms_by_kind": by_kind,
                 "top_device_ops_ms": {e.key[:90]: e.self_device_time_total / 1e3 for e in top}}


def train_phases(torch, dev) -> dict:
    """Phase 21: train mode on the card. (a) kernel 7ᵀ against its plain
    version on three plans, (b) an f32 cut against the host, (c)
    DeepSeek-V2-Lite at full width (4 of its 27 layers) trained for 8
    steps, (d) ``TrainDriver``'s restarts and the launcher. Returns
    kernel 7ᵀ's row of the kernels line, with (c)'s launches, and
    kernel 7's launches in (c)."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.distributed.fault_tolerance import FTConfig, TrainDriver
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.moe_dispatch import (
        moe_dispatch_gather, moe_dispatch_gather_backward,
    )
    from repro_torch.launch.train import main as train_main, scaled_config
    from repro_torch.models import moe
    from repro_torch.models.moe import capacity, dispatch_plan
    from repro_torch.models.transformer import build_model
    from repro_torch.models.zoo import count_params, get_config
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig, adamw_apply, adamw_init
    from repro_torch.train.train_loop import (
        TrainConfig, _grads_and_loss, device_batch, init_train_state, train_params,
        train_step_fn,
    )

    t_phase = time.perf_counter()
    laps, t_lap = {}, [t_phase]

    def lap(part: str) -> None:
        now = time.perf_counter()
        laps[part], t_lap[0] = now - t_lap[0], now

    full = get_config("deepseek-v2-lite-16b")
    kernels = (moe_dispatch_gather, moe_dispatch_gather_backward)

    # ---------------------------------------------------------------- 21a
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    plans = {"train": (full.moe, full.d_model),
             "train-drops": (dataclasses.replace(full.moe, capacity_factor=0.5), full.d_model),
             "mixtral": (get_config("mixtral-8x22b").moe, get_config("mixtral-8x22b").d_model)}
    b, t = TRAIN_MICRO_BATCH, TRAIN_SEQ
    summary = None
    for label, (m, d) in plans.items():
        ids = torch.argsort(torch.rand((b, t, m.n_experts), generator=gen, device=dev), dim=-1)
        c = capacity(t, m)
        plan = dispatch_plan(ids[..., :m.top_k].to(torch.int32).contiguous(), m.n_experts, c)
        s = b * m.n_experts * c
        kept = plan.slot_tok < b * t
        n_kept = int(kept.sum())
        if m.capacity_factor < 1:
            check(n_kept < b * t * m.top_k, f"phase 21 {label}: no assignment dropped")
        for dtype in (torch.bfloat16, torch.float32):
            grad = torch.randn((s, d), generator=gen, device=dev).to(dtype)
            got = moe_dispatch_gather_backward(grad, plan.tok_slots)
            want = ref.moe_dispatch_gather_backward_ref(grad, plan.tok_slots)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"phase 21 {label} {dtype}: kernel 7ᵀ differs from "
                  "its plain version")
            x = torch.randn((b * t, d), generator=gen, device=dev).to(dtype).requires_grad_(True)
            y = ops.moe_dispatch(x, plan.slot_tok, plan.tok_slots, group=c, experts=m.n_experts)
            y.backward(grad)
            torch.cuda.synchronize()
            check(torch.equal(y.detach(), ref.moe_dispatch_gather_ref(x.detach(), plan.slot_tok)),
                  f"phase 21 {label} {dtype}: the Function's forward differs from the plain gather")
            check(torch.equal(x.grad, want), f"phase 21 {label} {dtype}: x.grad through kernels "
                  "7 and 7ᵀ differs from the plain versions'")
            idx, rows = plan.slot_tok[kept].long(), grad[kept]
            esize = grad.element_size()
            nbytes = (n_kept + b * t) * d * esize + 4 * b * t * m.top_k
            row = {"phase": "21a", "kernel": "moe_dispatch_gather_backward", "plan": label,
                   "dtype": str(dtype), "T": b * t, "k": m.top_k, "S": s, "D": d,
                   "kept": n_kept, "max_abs_err": 0.0,
                   "ms": device_ms(torch, lambda: moe_dispatch_gather_backward(
                       grad, plan.tok_slots)),
                   "plain_ms": device_ms(torch, lambda: ref.moe_dispatch_gather_backward_ref(
                       grad, plan.tok_slots), reps=10),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "bound_bytes": nbytes,
                   "library_ms": device_ms(torch, lambda: torch.zeros(
                       (b * t, d), dtype=dtype, device=dev).index_add_(0, idx, rows))}
            print(json.dumps(row))
            if label == "train" and dtype == torch.bfloat16:
                summary = row
            del grad, got, want, x, y
    print(f"phase 21a: kernel 7ᵀ equals its plain version bit for bit on {list(plans)} in bf16 "
          f"and f32, and x.grad through kernels 7 and 7ᵀ equals the plain versions'")

    # ---------------------------------------------------------------- 21b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    card = build_model(cut, device=dev).init(g)
    redraw_matrices(torch, card, g)
    host = build_model(cut, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = np.random.default_rng(SEED).integers(0, cut.vocab, (1, TRAIN_CUT_TOKENS + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    routes, res = {}, {}
    real_plan = moe.dispatch_plan

    def record(top_ids, *args):
        routes[where].append(top_ids.cpu())
        return real_plan(top_ids, *args)

    moe.dispatch_plan = record
    try:
        for where, mdl in (("card", card), ("host", host)):
            routes[where] = []
            for k in kernels:
                k.launches = 0
            params = train_params(mdl)
            t0 = time.perf_counter()
            total, aux = mdl.loss(device_batch(batch, mdl.device), remat=True)
            total.backward()
            grads = {k: p.grad for k, p in params.items()}
            for p in params.values():
                p.grad = None
            if where == "card":
                torch.cuda.synchronize()
            res[where] = (total.detach().cpu(), {k: v.detach().cpu() for k, v in aux.items()},
                          grads, (time.perf_counter() - t0) * 1e3,
                          tuple(k.launches for k in kernels))
    finally:
        moe.dispatch_plan = real_plan
    check(len(routes["card"]) == len(routes["host"]) == 2, "phase 21b: routing not recorded")
    for rc, rh in zip(routes["card"], routes["host"]):
        check(torch.equal(rc, rh), "phase 21b: card and host route tokens differently")
    check(res["card"][4] == (2, 1), f"phase 21b: kernels 7 and 7ᵀ launched {res['card'][4]} "
          "times, not twice (forward and recompute) and once")
    (tc, ac, gc_, card_ms, _), (th, ah, gh, host_ms, _) = res["card"], res["host"]
    for name, a, b_ in (("total", tc, th), ("loss", ac["loss"], ah["loss"]),
                        ("moe_aux", ac["moe_aux"], ah["moe_aux"])):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=0.0,
                                   msg=lambda msg: f"phase 21b {name}: {msg}")
    grad_err = 0.0
    for k in gh:      # compared on the card (on the host they took tens of seconds)
        want = gh[k].to(dev)
        scale = float(want.abs().max())
        check(scale > 0, f"phase 21b: the host gradient of {k} is zero")
        torch.testing.assert_close(gc_[k], want, rtol=1e-3, atol=1e-5 * scale,
                                   msg=lambda msg: f"phase 21b grad {k}: {msg}")
        grad_err = max(grad_err, float((gc_[k] - want).abs().max()) / scale)
    # one AdamW step on each side from the card's gradients
    pc, ph = train_params(card), train_params(host)
    sc, sh = adamw_init(pc), adamw_init(ph)
    _, sc, mc = adamw_apply(pc, gc_, sc, ocfg)
    _, sh, mh = adamw_apply(ph, {k: v.cpu() for k, v in gc_.items()}, sh, ocfg)
    torch.testing.assert_close(mc["grad_norm"].cpu(), mh["grad_norm"], rtol=1e-5, atol=0.0)
    for f in ("master", "mu", "nu"):
        for k, want in getattr(sh, f).items():
            want = want.to(dev)
            torch.testing.assert_close(getattr(sc, f)[k], want, rtol=1e-5,
                                       atol=1e-6 * float(want.abs().max()),
                                       msg=lambda msg: f"phase 21b adamw {f} {k}: {msg}")
    print(json.dumps({"phase": "21b", "cut": "deepseek-v2-lite-16b, 2 layers, f32, TF32 off",
                      "params": count_params(cut), "tokens": TRAIN_CUT_TOKENS,
                      "total": [float(tc), float(th)], "loss": [float(ac["loss"]), float(ah["loss"])],
                      "moe_aux": [float(ac["moe_aux"]), float(ah["moe_aux"])],
                      "max_grad_diff_over_leaf_max": grad_err, "grad_leaves": len(gh),
                      "card_ms": card_ms, "host_ms": host_ms}))
    del card, host, pc, ph, sc, sh, gc_, gh, res
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 21b: the f32 cut's loss, every gradient leaf and one AdamW step on the card "
          "match the host")

    # ---------------------------------------------------------------- 21c
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()     # phase 22a's baseline
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params, opt = init_train_state(model, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = {k: (p.data_ptr(), p.dtype) for k, p in params.items()}
    n_params = sum(p.numel() for p in params.values())
    check(n_params == count_params(cfg), "phase 21c: parameter count")
    src = SyntheticLM(DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
                                 seed=SEED))
    tcfg = TrainConfig(opt=ocfg, microbatches=TRAIN_MICRO, remat=True)
    step = train_step_fn(model, tcfg)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = device_batch(src.batch(i, 0, 1), dev)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        steps.append({"step": i + 1, "ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                      "grad_norm": gnorm, "launches": [k.launches for k in kernels]})
        print(json.dumps({"phase": "21c", **steps[-1]}))
    peak = torch.cuda.max_memory_allocated()
    batch = device_batch(src.batch(TRAIN_STEPS, 0, 1), dev)
    (params, opt, met), profiled = profile_step(torch, lambda: step(params, opt, batch))
    # the step's two halves apart: the microbatches' forward and backward, then AdamW
    t0 = time.perf_counter()
    grads, _, _ = _grads_and_loss(model, params, batch, tcfg)
    torch.cuda.synchronize()
    grads_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    params, opt, _ = adamw_apply(params, grads, opt, ocfg)
    torch.cuda.synchronize()
    adamw_ms = (time.perf_counter() - t0) * 1e3
    del grads
    med_ms = statistics.median(s["ms"] for s in steps[1:])
    # ---------------------------------------------------------------- 22a
    from repro_torch.models.config import ShapeConfig

    batch = device_batch(src.batch(TRAIN_STEPS + 1, 0, 1), dev)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    dry = hold_dryrun(torch, "a", lambda: step(params, opt, batch), (params, opt, batch),
                      base_bytes, med_ms, cfg.arch_id,
                      ShapeConfig("train_4x2048", TRAIN_SEQ, TRAIN_BATCH, "train"), cfg, tcfg,
                      {"moe_dispatch_gather": 2 * TRAIN_MICRO * n_moe,
                       "moe_dispatch_gather_backward": TRAIN_MICRO * n_moe})
    print(json.dumps({"phase": "22a", "phase_21c_profiler_top_ops_ms":
                      profiled["top_device_ops_ms"]}))
    numel = n_params
    row = {"phase": "21c", "arch": cfg.arch_id, "layers": cfg.n_layers, "params": n_params,
           "weight_bytes": sum(p.numel() * p.element_size() for p in params.values()),
           "grad_bytes": {"per_microbatch": sum(p.numel() * p.element_size()
                                                for p in params.values()),
                          "f32_accumulator": 4 * numel},
           "optimizer_bytes": 12 * numel, "max_memory_allocated": peak,
           "init_s": init_s, "first_step_s": steps[0]["ms"] / 1e3,
           "median_step_ms_2_to_8": med_ms, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med_ms * 1e3,
           "loss": [s["loss"] for s in steps], "grad_norm": [s["grad_norm"] for s in steps],
           "launches_per_step": {k.__name__: steps[-1]["launches"][i]
                                 for i, k in enumerate(kernels)},
           "profiled_step": profiled,
           "split_ms": {"forward_backward": grads_ms, "adamw": adamw_ms}}
    print(json.dumps(row))
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps),
          "phase 21c: a loss or grad norm is not finite")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"phase 21c: step {TRAIN_STEPS}'s loss {steps[-1]['loss']} is not below step 1's "
          f"{steps[0]['loss']}")
    check({k: (p.data_ptr(), p.dtype) for k, p in params.items()} == before
          and all(p is q for p, q in zip(params.values(), model.parameters())),
          "phase 21c: a parameter moved or changed dtype")
    for s in steps:
        check(s["launches"] == [2 * TRAIN_MICRO * n_moe, TRAIN_MICRO * n_moe],
              f"phase 21c step {s['step']}: kernels 7 and 7ᵀ launched {s['launches']} times, "
              f"not {2 * TRAIN_MICRO * n_moe} and {TRAIN_MICRO * n_moe}")
    launches = [sum(s["launches"][i] for s in steps) for i in range(2)]
    del model, params, opt, met, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 21c: {cfg.arch_id} at full width, {cfg.n_layers} layers, "
          f"{n_params:,} parameters: {TRAIN_STEPS} finite steps, loss {steps[0]['loss']:.3f} → "
          f"{steps[-1]['loss']:.3f}, {med_ms:.1f} ms a step, peak {peak / 1e9:.1f} GB")

    # ---------------------------------------------------------------- 21d
    small = scaled_config(full, 0.05)
    small = dataclasses.replace(small, moe=dataclasses.replace(small.moe, top_k=2))
    check(not moe.uses_dense(small.moe), "phase 21d: the scaled config takes moe_dense")

    def drive(ckpt_dir, failure_at):
        mdl = build_model(small, device=dev)
        p, o = init_train_state(mdl, seed=SEED)
        fn = train_step_fn(mdl, TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                                          total_steps=20)))
        data = SyntheticLM(DataConfig(global_batch=8, seq_len=128, vocab=small.vocab, seed=SEED))
        driver = TrainDriver(fn, lambda i: device_batch(data.batch(i, 0, 1), dev),
                             FTConfig(ckpt_dir=ckpt_dir, ckpt_every=4, async_save=True))
        return driver.run(p, o, FT_STEPS, failure_at=failure_at)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for k in kernels:
            k.launches = 0
        clean = drive(os.path.join(tmp, "clean"), None)
        ft_launches = [k.launches for k in kernels]
        faulty = drive(os.path.join(tmp, "faulty"), [5, 9])
        ft_s = time.perf_counter() - t0
        check(clean["restarts"] == 0 and faulty["restarts"] == 2,
              f"phase 21d: restarts {clean['restarts']} and {faulty['restarts']}")
        c = [h["loss"] for h in clean["history"]]
        f = {h["step"]: h["loss"] for h in faulty["history"]}
        check(len(c) == FT_STEPS and [f[i] for i in range(FT_STEPS)] == c,
              "phase 21d: the restarted run's losses differ from the uninterrupted run's")
        for part in ("params", "opt_state"):
            fa, fb = ckpt._flatten(clean[part]), ckpt._flatten(faulty[part])
            check(fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa),
                  f"phase 21d: the final {part} differ between the clean and restarted runs")
        check(all(n > 0 for n in ft_launches), f"phase 21d: kernels 7 and 7ᵀ launched "
              f"{ft_launches} times in TrainDriver's run")
        t0 = time.perf_counter()
        out = train_main(["--steps", str(FT_STEPS), "--ckpt-dir", os.path.join(tmp, "cli")])
        cli_s = time.perf_counter() - t0
        h = [x["loss"] for x in out["history"]]
        check(out["final_step"] == FT_STEPS and h[-1] < h[0],
              f"phase 21d: the launcher's losses {h} do not fall")
    print(json.dumps({"phase": "21d", "config": "scaled_config(deepseek-v2-lite-16b, 0.05), top-2",
                      "params": count_params(small), "steps": FT_STEPS, "failure_at": [5, 9],
                      "restarts": faulty["restarts"], "losses": c, "driver_s": ft_s,
                      "launches_clean_run": ft_launches, "cli_losses": h, "cli_s": cli_s,
                      "seconds": time.perf_counter() - t_phase}))
    print(f"phase 21d: restarted at steps 5 and 9, TrainDriver's run equals the uninterrupted run "
          f"bit for bit; the launcher trained {FT_STEPS} steps, loss {h[0]:.3f} → {h[-1]:.3f}")
    summary = dict(summary, launches=launches[1])
    return {"moe_dispatch_gather_backward": summary, "moe_dispatch_gather_launches": launches[0],
            "phase22a_s": dry["seconds"], "step_ms": med_ms}


def mesh_train_phases(torch, dev, single_step_ms: float, time_ms) -> dict:
    """Phase 23: the LM sharding layer and the mesh train steps on virtual
    devices of the card. (a) ``make_train_step`` on ``small_mesh(2, 2)``
    at phase 21c's cell, (b) the same step on an f32 cut against the
    host, (c) ``make_compressed_train_step`` on (pod 2, data 2, model 2)
    against (a)'s step on that mesh, (d) the elastic restore and the
    launcher's mesh flags. Returns kernel 7's and 7ᵀ's launches in (a)–(c)
    and kernel 7's rows on the training plans."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.distributed.sharding import (
        Sharded, param_shardings, set_activation_mesh, unshard_state, zero1_shardings,
    )
    from repro_torch.kernels.moe_dispatch import (
        moe_dispatch_gather, moe_dispatch_gather_backward,
    )
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.train import main as train_main, scaled_config
    from repro_torch.models.transformer import build_model, model_specs
    from repro_torch.models.zoo import count_params, get_config
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_loop
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.convert import param_layout
    from repro_torch.train.optimizer import OptConfig, OptState, cosine_lr
    from repro_torch.train.train_loop import (
        TrainConfig, _MeshPlan, device_batch, init_mesh_ef, init_mesh_state,
        make_compressed_train_step, make_train_step,
    )

    t_phase = time.perf_counter()
    laps, t_lap = {}, [t_phase]

    def lap(part: str) -> None:
        now = time.perf_counter()
        laps[part], t_lap[0] = now - t_lap[0], now

    full = get_config("deepseek-v2-lite-16b")
    kernels = (moe_dispatch_gather, moe_dispatch_gather_backward)
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    src = SyntheticLM(DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=full.vocab,
                                 seed=SEED))
    totals = [0, 0]

    def predicted(cfg, tcfg, positions: int) -> list:
        """Kernel 7's and 7ᵀ's launches a step, from the code: every MoE
        layer of every microbatch of every (pod, data) position's rows runs
        kernel 7 in its forward and again in remat's recompute, and 7ᵀ in
        its backward."""
        once = positions * max(tcfg.microbatches, 1) * (cfg.n_layers - cfg.moe.first_dense_layers)
        return [(2 if tcfg.remat else 1) * once, once]

    def run_steps(label, step, state, batches, want):
        """Each step with the launch counts set to 0 just before it and read
        just after; every count must equal ``want``."""
        rows = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            out = step(*state, batch)
            state, met = out[:-1], out[-1]
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            torch.cuda.synchronize()
            rows.append({"step": i + 1, "ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                         "grad_norm": gnorm, "launches": [k.launches for k in kernels],
                         "predicted": want})
            print(json.dumps({"phase": label, **rows[-1]}))
            check(rows[-1]["launches"] == want, f"phase {label} step {i + 1}: kernels 7 and 7ᵀ "
                  f"launched {rows[-1]['launches']} times, the code predicts {want}")
            totals[0] += rows[-1]["launches"][0]
            totals[1] += rows[-1]["launches"][1]
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
              f"phase {label}: a loss or grad norm is not finite")
        return state, rows

    def blocks_of(tree):
        return [(k, v) for k, v in ckpt._flatten(tree).items() if isinstance(v, Sharded)]

    def check_shapes(label, tree, shardings):
        want = ckpt._flatten(shardings)
        for k, leaf in blocks_of(tree):
            check(leaf.block_shape == want[k].shard_shape(leaf.shape) and leaf.sharding.spec ==
                  want[k].spec, f"phase {label}: {k}'s blocks {leaf.block_shape} are not "
                  f"{want[k].spec}'s shard shape")

    def free():
        set_activation_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 23a
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    mesh = small_mesh(*MESH_TRAIN_SHAPE, device=dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).init(seed=SEED)
    params, opt = init_mesh_state(model, mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = model_specs(cfg)
    p_sh, z_sh = param_shardings(mesh, specs), zero1_shardings(mesh, specs)
    check_shapes("23a", params, p_sh)
    for f in ("master", "mu", "nu"):
        check_shapes("23a", getattr(opt, f), z_sh)
    tcfg = TrainConfig(opt=ocfg, microbatches=TRAIN_MICRO, remat=True)
    want = predicted(cfg, tcfg, mesh.shape["data"])
    step = make_train_step(model, mesh, tcfg)
    batches = [device_batch(src.batch(i, 0, 1), dev) for i in range(TRAIN_STEPS)]
    (params, opt), steps = run_steps("23a", step, (params, opt), batches, want)
    peak = torch.cuda.max_memory_allocated()
    batch = device_batch(src.batch(TRAIN_STEPS, 0, 1), dev)
    (params, opt, _), profiled = profile_step(torch, lambda: step(params, opt, batch))
    per_device = {f: [sum(v.blocks[d].numel() * v.blocks.element_size()
                          for _, v in blocks_of(tree)) for d in range(mesh.n_devices)]
                  for f, tree in (("params", params), ("master", opt.master), ("mu", opt.mu),
                                  ("nu", opt.nu))}
    med_ms = statistics.median(s["ms"] for s in steps[1:])
    # device 0's arguments of a step, for phase 24b: its blocks, the step,
    # its data group's rows of the batch
    rows0 = TRAIN_BATCH // mesh.shape["data"]
    bytes_23a = {"cfg": cfg, "tcfg": tcfg, "mesh": mesh.shape,
                 "blocks": {f: v[0] for f, v in per_device.items()},
                 "step": opt.step.numel() * opt.step.element_size(),
                 "batch_rows": sum(v[:rows0].numel() * v.element_size() for v in batch.values())}
    row_a = {"phase": "23a", "arch": cfg.arch_id, "layers": cfg.n_layers,
             "params": count_params(cfg), "mesh": mesh.shape, "init_s": init_s,
             "bytes_per_device": per_device,
             "bytes_max": {f: max(v) for f, v in per_device.items()},
             "bytes_sum": {f: sum(v) for f, v in per_device.items()},
             "max_memory_allocated": peak, "median_step_ms_2_to_8": med_ms,
             "single_device_step_ms_phase_21c": single_step_ms,
             "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med_ms * 1e3,
             "loss": [s["loss"] for s in steps], "grad_norm": [s["grad_norm"] for s in steps],
             "launches_per_step": steps[-1]["launches"], "predicted_per_step": want,
             "profiled_step": profiled}
    print(json.dumps(row_a))
    check(steps[-1]["loss"] < steps[0]["loss"], f"phase 23a: step {TRAIN_STEPS}'s loss "
          f"{steps[-1]['loss']} is not below step 1's {steps[0]['loss']}")
    del model, params, opt, step, batches, batch
    free()
    # kernel 7 on the training plan: a microbatch of 2 × 2,048 tokens, as in phase 21c
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    tok, hint = random_plan(torch, dev, TRAIN_MICRO_BATCH, TRAIN_SEQ, full.moe, gen)
    x = torch.randn((TRAIN_MICRO_BATCH * TRAIN_SEQ, full.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    gather_rows = [gather_row(torch, dev, x, tok, hint,
                              f"training {TRAIN_MICRO_BATCH} x {TRAIN_SEQ}", time_ms)]
    print(json.dumps({"phase": "23a", **gather_rows[0]}))
    del x, tok
    print(f"phase 23a: {cfg.arch_id} at full width, {cfg.n_layers} layers, on "
          f"{mesh.n_devices} virtual devices {mesh.shape}: {TRAIN_STEPS} finite steps, loss "
          f"{steps[0]['loss']:.3f} → {steps[-1]['loss']:.3f}, {med_ms:.1f} ms a step "
          f"({single_step_ms:.1f} on one device), peak {peak / 1e9:.1f} GB")

    lap("23a")
    # ---------------------------------------------------------------- 23b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    card = build_model(cut, device=dev).init(g)
    redraw_matrices(torch, card, g)
    host = build_model(cut, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = np.random.default_rng(SEED + 3).integers(0, cut.vocab,
                                                    (MESH_CUT_ROWS, MESH_CUT_TOKENS + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    ctcfg = TrainConfig(opt=ocfg, microbatches=1, remat=True)
    res = {}
    for where, mdl in (("card", card), ("host", host)):
        m = small_mesh(*MESH_TRAIN_SHAPE, device=mdl.device)
        p, o = init_mesh_state(mdl, m)
        want = predicted(cut, ctcfg, m.shape["data"])
        t0 = time.perf_counter()
        if where == "card":
            (p, o), rows = run_steps("23b", make_train_step(mdl, m, ctcfg), (p, o),
                                     [device_batch(batch, dev)], want)
            met = rows[0]
        else:
            p, o, met = make_train_step(mdl, m, ctcfg)(p, o, device_batch(batch, "cpu"))
            met = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
        # each side's state stays where it was computed; the comparisons
        # below run on the card (on the host they took most of the phase)
        res[where] = (met, {f: dict(ckpt._flatten(unshard_state(getattr(o, f))))
                            for f in ("master", "mu", "nu")}, (time.perf_counter() - t0) * 1e3)
        del p, o
        set_activation_mesh(None)
    (mc, sc, card_ms), (mh, sh, host_ms) = res["card"], res["host"]
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(mc[name], mh[name], rtol=1e-4,
                                   err_msg=f"phase 23b {name}: card against host")
    worst = {"mu": 0.0, "nu": 0.0}        # max |card − host| / |host| where |mu| clears 1e-2·max
    for k in sh["mu"]:
        mu = sh["mu"][k].to(dev)
        ok = mu.abs() > 1e-2 * mu.abs().max()
        for f, rtol, atol in (("master", 1e-5, 1e-6), ("mu", 1e-3, 1e-5), ("nu", 1e-3, 1e-5)):
            want = sh[f][k].to(dev)
            got = sc[f][k]
            sel = ok if f == "master" else torch.ones_like(ok)
            torch.testing.assert_close(got[sel], want[sel], rtol=rtol,
                                       atol=atol * float(want.abs().max()),
                                       msg=lambda msg: f"phase 23b {f} {k}: {msg}")
            if f in worst and bool(ok.any()):
                worst[f] = max(worst[f], float(((got[ok] - want[ok]).abs()
                                                / want[ok].abs()).max()))
    print(json.dumps({"phase": "23b",
                      "cut": f"deepseek-v2-lite-16b, {cut.n_layers} layers, f32, TF32 off",
                      "params": count_params(cut), "mesh": MESH_TRAIN_SHAPE,
                      "tokens": [MESH_CUT_ROWS, MESH_CUT_TOKENS],
                      "loss": [mc["loss"], mh["loss"]],
                      "grad_norm": [mc["grad_norm"], mh["grad_norm"]],
                      "worst_rel_err_where_mu_clears_1e-2_max": worst,
                      "card_ms": card_ms, "host_ms": host_ms}))
    del card, host, res, sc, sh
    free()
    print(f"phase 23b: one mesh step of the f32 cut on the card matches the host: loss, grad "
          f"norm, master (rtol 1e-5), mu and nu (the gradient's rtol 1e-3; worst "
          f"{worst['mu']:.2e} and {worst['nu']:.2e} where |mu| clears 1e-2·max)")

    lap("23b")
    # ---------------------------------------------------------------- 23c
    cfg = dataclasses.replace(full, n_layers=MESH_POD_LAYERS)
    mesh = small_mesh(*MESH_POD_SHAPE[1:], pod=MESH_POD_SHAPE[0], device=dev)
    ptcfg = TrainConfig(opt=ocfg, microbatches=1, remat=True, grad_compress_pod=True)
    batches = [device_batch(src.batch(i, 0, 1), dev) for i in range(TRAIN_STEPS)]
    # the loss of step 1's batch and of a batch no step trains, read before and after
    fixed = {"trained": batches[0], "untrained": device_batch(src.batch(TRAIN_STEPS, 0, 1), dev)}
    names = [name for name, _, _ in param_layout(cfg)]
    n_pod = mesh.shape["pod"]

    def fixed_losses(model, params) -> dict:
        _MeshPlan(model, mesh).load_weights(params)
        with torch.no_grad():
            return {k: float(model.loss(b, remat=False)[0]) for k, b in fixed.items()}

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev).init(seed=SEED)
    params, opt = init_mesh_state(model, mesh)
    ef = init_mesh_ef(model, mesh)
    start = {k: v.full() for k, v in blocks_of(params)}            # bf16, the masters' start
    loss_before = fixed_losses(model, params)
    step = make_compressed_train_step(model, mesh, ptcfg)
    want = predicted(cfg, ptcfg, n_pod * mesh.shape["data"])
    wire, per_leaf = [], []       # gathered dtypes; per leaf a step: zero codes, mean, ef norms
    real_psum = train_loop.compressed_psum_mean

    def spy(x, e, axis, pod_mesh):
        """compressed_psum_mean, noting the dtype of what crosses the pod
        axis, the share of zero codes over the pods, the share of the
        mean's entries that are 0, and each pod's error-feedback norm."""
        gather, zero = pod_mesh.all_gather, []

        def noted(t, ax, dim=1):
            wire.append(t.dtype)
            if t.dtype == torch.int8:
                zero.append(t.numel() - torch.count_nonzero(t))
            return gather(t, ax, dim)
        pod_mesh.all_gather = noted
        try:
            mean, new_ef = real_psum(x, e, axis, pod_mesh)
        finally:
            del pod_mesh.all_gather
        per_leaf.append((zero[0], mean[0].numel() - torch.count_nonzero(mean[0]),
                         mean[0].numel(), torch.linalg.vector_norm(new_ef.flatten(1), dim=1)))
        return mean, new_ef

    train_loop.compressed_psum_mean = spy
    try:
        (params, opt, ef), csteps = run_steps("23c", step, (params, opt, ef), batches, want)
    finally:
        train_loop.compressed_psum_mean = real_psum
    peak_c = torch.cuda.max_memory_allocated()
    code_types = {str(t) for t in wire[0::2]}           # codes, then scales, a leaf
    check(code_types == {"torch.int8"}, f"phase 23c: the codes gathered over pod are {code_types}")
    # by leaf, a step each: the share of zero codes over both pods, of zero entries in the
    # mean, and the error-feedback norm (the pods' mean)
    codes = {}
    for i, name in enumerate(names):
        rows = per_leaf[i::len(names)]
        codes[name] = {"zero_codes": [round(float(z) / (n_pod * n), 4) for z, _, n, _ in rows],
                       "zero_mean": [round(float(m) / n, 4) for _, m, n, _ in rows],
                       "ef_norm": [round(float(e.mean()), 4) for _, _, _, e in rows]}
    del per_leaf
    print(json.dumps({"phase": "23c", "compressed_codes": codes["lm_head"], "others": {
        "zero_codes_max": max(max(v["zero_codes"]) for k, v in codes.items()
                              if k not in ("lm_head", "embed")),
        "embed_zero_codes": codes["embed"]["zero_codes"]}}))
    loss_c = fixed_losses(model, params)
    numel = count_params(cfg)
    leaves = len(blocks_of(params))
    wire_bytes = {"int8_codes_and_scales_per_pod_step": (n_pod - 1) * (numel + 4 * leaves),
                  "bf16_ring_all_reduce_per_pod_step": 2 * (n_pod - 1) / n_pod * numel * 2}
    c_params = {k: v.full() for k, v in blocks_of(params)}
    c_master = {k: v.full() for k, v in blocks_of(opt.master)}
    # entries no step carried a gradient to: AdamW's nu is still 0 there
    never = {k: v.full() == 0 for k, v in blocks_of(opt.nu)}
    ef_bytes = sum(v.blocks.numel() * 4 for _, v in blocks_of(ef))
    del model, params, opt, ef, step
    free()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev).init(seed=SEED)
    params, opt = init_mesh_state(model, mesh)
    step = make_train_step(model, mesh, ptcfg)
    (params, opt), psteps = run_steps("23c", step, (params, opt), batches,
                                      predicted(cfg, ptcfg, n_pod * mesh.shape["data"]))
    loss_p = fixed_losses(model, params)
    p_params = {k: v.full() for k, v in blocks_of(params)}
    del model, opt, step
    # the reference's measure (tests/test_launch.py:126-130), leaf by leaf: the mean of
    # |Δ| / (|p| + 1e-3) against the uncompressed step. Held on the entries the int8 wire
    # carried; the entries it never carried must hold AdamW's zero-gradient value (the
    # decay alone) bit for bit, and their share and reading are printed beside it.
    lrs = [cosine_lr(torch.tensor(i + 1, dtype=torch.int32, device=dev), ocfg)
           for i in range(TRAIN_STEPS)]
    by_leaf = {}
    for k, pp in p_params.items():
        pp = pp.float()
        cp = c_params.pop(k).float()
        nv = never.pop(k)
        r = (cp - pp).abs() / (pp.abs() + 1e-3)
        del cp
        m = start.pop(k).float()
        for lr in lrs:
            m = m - (m * ocfg.weight_decay) * lr
        decayed = torch.equal(c_master.pop(k)[nv], m[nv])
        n_never = int(nv.sum())
        by_leaf[k] = {"whole": float(r.mean()), "carried": float(r[~nv].mean()) if
                      n_never < r.numel() else 0.0, "never_carried_share": n_never / r.numel(),
                      "never_carried": float(r[nv].mean()) if n_never else 0.0,
                      "never_carried_is_decay_only": decayed}
        del pp, nv, r, m
    del params, p_params
    free()
    lc, lp = csteps[-1]["loss"], psteps[-1]["loss"]
    drop = {"compressed": loss_before["trained"] - loss_c["trained"],
            "plain": loss_before["trained"] - loss_p["trained"]}
    print(json.dumps({"phase": "23c", "arch": cfg.arch_id, "layers": cfg.n_layers,
                      "params": numel, "mesh": mesh.shape,
                      "compressed_loss": [s["loss"] for s in csteps],
                      "plain_loss": [s["loss"] for s in psteps],
                      "fixed_batch_loss": {"before": loss_before, "compressed": loss_c,
                                           "plain": loss_p},
                      "compressed_step_ms": statistics.median(s["ms"] for s in csteps[1:]),
                      "plain_step_ms": statistics.median(s["ms"] for s in psteps[1:]),
                      "rel_param_diff_by_leaf": by_leaf, "ef_bytes": ef_bytes,
                      "max_memory_allocated_compressed": peak_c,
                      "max_memory_allocated_plain": torch.cuda.max_memory_allocated(),
                      "pod_wire_bytes": wire_bytes}))
    for k, v in by_leaf.items():
        check(v["carried"] < 0.05, f"phase 23c: {k}'s mean relative difference from the plain "
              f"step over the entries the int8 wire carried is {v['carried']}")
        check(v["never_carried_is_decay_only"], f"phase 23c: {k}'s entries that no step carried "
              f"do not hold AdamW's zero-gradient value")
    check(drop["plain"] > 0 and drop["compressed"] > 0.25 * drop["plain"],
          f"phase 23c: the loss of step 1's batch fell by {drop['compressed']} compressed, "
          f"{drop['plain']} uncompressed")
    check(abs(lc - lp) < 0.05 * abs(lp), f"phase 23c: loss {lc} not within 5% of {lp}")
    del batches, fixed
    worst_leaf = max(by_leaf, key=lambda k: by_leaf[k]["whole"])
    print(f"phase 23c: int8 error-feedback pod compression on {mesh.shape}: step 1's batch "
          f"{loss_before['trained']:.4f} → {loss_c['trained']:.4f} against "
          f"{loss_p['trained']:.4f} uncompressed; the reference's per-leaf reading, over the "
          f"entries the wire carried, at most {max(v['carried'] for v in by_leaf.values()):.4f};"
          f" whole leaves at most {by_leaf[worst_leaf]['whole']:.4f} ({worst_leaf}, "
          f"{by_leaf[worst_leaf]['never_carried_share']:.1%} of it never carried, decay only)")

    lap("23c")
    # ---------------------------------------------------------------- 23d
    small = scaled_config(full, 0.05)
    small = dataclasses.replace(small, moe=dataclasses.replace(small.moe, top_k=2))
    model = build_model(small, device=dev).init(seed=SEED)
    mesh = small_mesh(2, 2, device=dev)
    params, opt = init_mesh_state(model, mesh)
    specs = model_specs(small)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, 1, {"params": params, "opt": opt})
        saved = {k: v.full() for k, v in blocks_of({"params": params, "opt": opt})}
        for shape in ((4, 1), (1, 4)):
            mesh_b = small_mesh(*shape, device=dev)
            z = zero1_shardings(mesh_b, specs)
            got, _ = ckpt.restore(tmp, 1, {"params": params, "opt": opt},
                                  {"params": param_shardings(mesh_b, specs),
                                   "opt": OptState(None, z, z, z)})
            back = blocks_of(got)
            check(len(back) == len(saved) and all(
                v.sharding.mesh is mesh_b and torch.equal(v.full(), saved[k]) for k, v in back),
                f"phase 23d: a leaf restored onto {shape} differs from the saved one")
        t0 = time.perf_counter()
        out = train_main(["--data", "2", "--model", "2", "--pod", "2", "--compress-pod",
                          "--steps", str(FT_STEPS), "--ckpt-dir", os.path.join(tmp, "cli")])
        cli_s = time.perf_counter() - t0
    h = [x["loss"] for x in out["history"]]
    check(out["final_step"] == FT_STEPS and h[-1] < h[0],
          f"phase 23d: the launcher's losses {h} do not fall")
    del model, params, opt, out
    free()
    lap("23d")
    print(json.dumps({"phase": "23d", "config": "scaled_config(deepseek-v2-lite-16b, 0.05), "
                      "top-2", "restored_onto": [[4, 1], [1, 4]], "leaves": len(saved),
                      "cli_losses": h, "cli_s": cli_s,
                      "seconds": time.perf_counter() - t_phase, "seconds_by_part": laps}))
    print(f"phase 23d: a (2, 2) checkpoint restored onto (4, 1) and (1, 4) bit for bit; the "
          f"launcher's compressed pod step trained {FT_STEPS} steps, loss {h[0]:.3f} → "
          f"{h[-1]:.3f}")
    return {"launches": totals, "gather_rows": gather_rows, "bytes_23a": bytes_23a}


def hold_dryrun(torch, label: str, card_step, resident, base_bytes: int, step_ms: float,
                arch: str, shape, cfg, tcfg, kernel_notes: dict) -> dict:
    """Phase 22 (a) or (b): ``card_step()`` once on the card under the op
    counter (``resident``: its arguments), then the dry run of the same
    cell on meta; the gates of the module's phase 22. ``base_bytes``: what
    was allocated before the model was built; ``step_ms``: the measured
    step; ``kernel_notes``: the traffic reports each hand-written kernel
    must make. Returns the row printed."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.op_profile import contributors

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with OpCounter(resident) as counter:
        card_step()
    torch.cuda.synchronize()
    card_bytes = torch.cuda.max_memory_allocated() - base_bytes
    card = counter.analysis()
    rec, meta = lower_cell(arch, shape, {"card": 1}, tcfg, cfg=cfg)

    def sig(r):
        return (r.op, r.flops, r.dtype, r.bytes)

    first = next((i for i, (a, b) in enumerate(zip(card.ops, meta.ops)) if sig(a) != sig(b)),
                 None if len(card.ops) == len(meta.ops) else min(len(card.ops), len(meta.ops)))
    if first is not None:
        print(json.dumps({"phase": f"22{label}", "first_difference": first,
                          "card": card.ops[first:first + 1], "meta": meta.ops[first:first + 1]}))
    notes = {side: {k: sum(r.op == k for r in a.ops) for k in kernel_notes}
             for side, a in (("card", card), ("meta", meta))}
    pred = meta.peak_bytes
    terms = rec["roofline"]
    row = {"phase": f"22{label}", "arch": arch, "shape": rec["shape"], "ops": [len(card.ops),
                                                                             len(meta.ops)],
           "flops_by_dtype": [card.flops_by_dtype, meta.flops_by_dtype],
           "hbm_bytes": [card.hbm_bytes, meta.hbm_bytes], "kernel_notes": notes,
           "argument_bytes": [card.argument_bytes, meta.argument_bytes],
           "predicted_bytes": pred, "temp_bytes": rec["memory"]["temp_bytes"],
           "card_counter_peak_bytes": card.peak_bytes,
           "card_max_memory_allocated_less_base": card_bytes,
           "memory_error": pred / card_bytes - 1, "roofline": terms, "step_ms": step_ms,
           "bound_over_step": terms["bound_s"] * 1e3 / step_ms,
           "useful_flops_ratio": rec["useful_flops_ratio"],
           "model_flops_total": rec["model_flops_total"], "meta_pass_s": rec["compile_s"]}
    print(json.dumps(row))
    print(f"phase 22{label}: the dry run's top 10 (caller, op) pairs and callers by bytes")
    top = contributors(meta, top=10)
    print(json.dumps({"phase": f"22{label}", "top_bytes": [[f"{c} :: {o}", v, n]
                                                          for (c, o), v, n in top["bytes"]],
                      "top_callers": top["callers"]}))
    check(first is None, f"phase 22{label}: op {first} differs between the card and meta")
    check(card.flops_by_dtype == meta.flops_by_dtype and card.hbm_bytes == meta.hbm_bytes,
          f"phase 22{label}: FLOPs or bytes differ between the card and meta")
    check(notes["card"] == notes["meta"] == kernel_notes,
          f"phase 22{label}: kernel traffic reports {notes}, not {kernel_notes}")
    check(abs(pred - card_bytes) <= 0.05 * card_bytes,
          f"phase 22{label}: the dry run's {pred} bytes are not within 5% of the card's "
          f"{card_bytes}")
    check(terms["bound_s"] <= 1.05 * step_ms / 1e3,
          f"phase 22{label}: bound {terms['bound_s'] * 1e3:.2f} ms above 1.05 × the measured "
          f"{step_ms:.2f} ms")
    row["seconds"] = time.perf_counter() - t0
    print(f"phase 22{label}: {len(card.ops)} ops, FLOPs and bytes equal on the card and meta; "
          f"memory {pred / 1e9:.2f} GB predicted, {card_bytes / 1e9:.2f} GB on the card; bound "
          f"{terms['bound_s'] * 1e3:.1f} ms ({terms['dominant']}) of a {step_ms:.1f} ms step; "
          f"{row['seconds']:.1f} s")
    return row


def dryrun_cells(torch) -> float:
    """Phase 22 (c): the dry run's records of two cells at the reference's
    shapes, on meta. Returns its seconds."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models.config import SHAPES
    from repro_torch.models.zoo import active_params, get_config

    t0 = time.perf_counter()
    keys = {"arch", "shape", "mesh", "devices", "compile_s", "memory", "cost_raw", "cost",
            "collectives", "roofline", "model_flops_total", "model_flops_per_device",
            "useful_flops_ratio", "params_total", "params_active", "fits_one_card"}
    # (arch, kernel 7's reports: one a routed layer of deepseek's decode)
    for arch, k7_want in (("xlstm-1.3b", 0), ("deepseek-v2-lite-16b", 26)):
        rec, _ = lower_cell(arch, "decode_32k")
        print(json.dumps({"phase": "22c", **rec}))
        want = 2.0 * active_params(get_config(arch)) * SHAPES["decode_32k"].global_batch
        check(keys <= rec.keys() and rec["devices"] == 1, f"phase 22c {arch}: record keys")
        check(rec["cost"]["flops_per_device"] > 0 and rec["model_flops_total"] == want,
              f"phase 22c {arch}: FLOPs {rec['cost']} or model_flops {rec['model_flops_total']}")
        k7 = rec["kernels"].get("moe_dispatch_gather", {}).get("launches", 0)
        check(k7 == k7_want, f"phase 22c {arch}: kernel 7 reported {k7} times, not {k7_want}")
    seconds = time.perf_counter() - t0
    print(f"phase 22c: xlstm-1.3b and deepseek-v2-lite-16b × decode_32k dry-run records "
          f"complete; {seconds:.1f} s")
    return seconds


def mesh_rows_phases(torch, dev, cit, rtx, stump, compare, all_kernels, phase14: dict,
                     devices=MESH_ROW_DEVICES, d_rtx: int = MESH_ROW_RTX,
                     rtx_iters: int = RTX_MULTI_ITERS, n_queries: int = SERVE_QUERIES,
                     walls: dict | None = None) -> tuple[dict, dict]:
    """Phase 24: the multi-source traversals row-sharded over ("batch",)
    meshes of virtual devices, against phase 14's single-device batched
    runs (``phase14``: "app graph" → (sources, result, wall ms)); each
    device's launch of kernels 1b and 2b on one level's rows against its
    plain version; ``GraphQueryServer(mesh=...)`` against the mesh-less
    server. Returns the block kernels' main-path launches and worst
    differences from their plain versions; ``walls``, when given, gets
    each cit-HP run's wall ms by "app D=d" (D=1: the single-device run)."""
    import warnings

    import numpy as np

    from repro_torch.core import build_bsr_padded
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES
    from repro_torch.graphs import bfs_multi, bfs_reference, build_engine, ppr_multi, sssp_multi
    from repro_torch.graphs.engine import edge_values
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch
    from repro_torch.serve.graph_engine import GraphQueryServer

    t_phase = time.perf_counter()
    laps, t_lap = {}, [t_phase]

    def lap(part: str) -> None:
        now = time.perf_counter()
        laps[part], t_lap[0] = now - t_lap[0], now

    blocks = (semiring_spmv_padded_batch, semiring_spmspv_padded_batch)
    tally = {k.__name__: 0 for k in blocks}
    worst = {k.__name__: 0.0 for k in blocks}
    tiles = {"fmt_spmv": "bsr", "fmt_spmspv": "bsr"}

    def main_path(fn):
        """fn's result, its wall ms (host clock, ending in a sync) and the
        block kernels' launches, the counters set to 0 just before it."""
        for k in all_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k.__name__: k.launches for k in blocks}
        for name, n in counts.items():
            tally[name] += n
        return out, ms, counts

    def syncs(fn) -> int:
        """Synchronising CUDA calls in one call of fn, as torch.cuda's sync
        debug mode reports them (phase 16's count; the profiler's, phase
        14's, costs ~0.1 s a level at D = 8)."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)

    def run_mesh(label, g, eng, multi, srcs, want, single_ms, d, oracle_rows=0, oracle=None,
                 extra=None):
        mesh = Mesh((d,), ("batch",), device=dev)
        torch.cuda.reset_peak_memory_stats()
        res, ms, counts = main_path(lambda: multi(eng, srcs, mesh=mesh))
        peak = torch.cuda.max_memory_allocated()
        for field, got, ref_ in zip(res._fields, res, want):
            check(torch.equal(got, ref_), f"phase 24 {label} {g.name} D={d}: {field} differs "
                  "from phase 14's single-device batched run")
        check(sum(counts.values()) > 0, f"phase 24 {label} {g.name} D={d}: no block kernel "
              f"launched on the mesh: {counts}")
        for i in range(oracle_rows):
            check(np.array_equal(res.levels[i].cpu().numpy(), oracle(srcs[i])),
                  f"phase 24 {label} {g.name} D={d} row {i}: differs from the clipped oracle")
        levels = int(res.iterations.max())
        t_sync = time.perf_counter()
        n_sync = syncs(lambda: multi(eng, srcs, mesh=mesh))
        laps[f"syncs {label} {g.name} D={d}"] = time.perf_counter() - t_sync
        if walls is not None and g is cit:
            walls[f"{label} D={d}"] = ms
        row = {"phase": 24, "app": f"{label}_multi", "graph": g.name, "B": len(srcs),
               "devices": d, "rows_per_device": -(-len(srcs) // d), "wall_ms": ms,
               "single_device_wall_ms": single_ms, "levels": levels, "launches": counts,
               "launches_per_level": sum(counts.values()) / max(levels, 1),
               "host_syncs": n_sync, "host_syncs_per_level": n_sync / max(levels, 1),
               "rows_held_to_oracle": oracle_rows, "max_memory_allocated": peak, **(extra or {})}
        print(json.dumps(row))
        return row

    # ------------------------------------------------- cit-HP, three apps
    apps = (("bfs", BOOL_OR_AND, bfs_multi, {}), ("sssp", MIN_PLUS, sssp_multi,
                                                  {"weighted": True, "seed": 5}),
            ("ppr", PLUS_TIMES, ppr_multi, {"normalize": True}))
    rows = []
    for label, sr, multi, kw in apps:
        srcs, want, phase14_ms = phase14[f"{label} cit-HP"]
        eng = build_engine(cit, sr, stump, device=dev, **tiles, **kw)
        # the single-device batched run again, for a wall in this phase
        one, one_ms, one_counts = main_path(lambda: multi(eng, srcs))
        for field, got, ref_ in zip(one._fields, one, want):
            check(torch.equal(got, ref_), f"phase 24 {label} cit-HP: the single-device run's "
                  f"{field} differs from phase 14's")
        one_syncs = syncs(lambda: multi(eng, srcs)) / max(int(one.iterations.max()), 1)
        if walls is not None:
            walls[f"{label} D=1"] = one_ms
        for d in devices:
            rows.append(run_mesh(label, cit, eng, multi, srcs, want, one_ms, d, extra={
                "single_device_launches": one_counts,
                "single_device_host_syncs_per_level": one_syncs}))
        del eng, one
        torch.cuda.empty_cache()
    lap("cit-HP")
    print(f"phase 24: cit-HP bfs/sssp/ppr_multi at B = {len(srcs)} on ('batch',) meshes of "
          f"{list(devices)} virtual devices equal phase 14's single-device batched runs row "
          "for row (every field, PPR included)")

    # ------------------------- each device's launch on one level's rows
    src_bfs, res_bfs, _ = phase14["bfs cit-HP"]
    level = 2
    live = res_bfs.levels == level
    held = 0
    for sr in (BOOL_OR_AND, PLUS_TIMES):
        vals = edge_values(cit, sr, weighted=False, normalize=sr is PLUS_TIMES)
        a = build_bsr_padded(cit.cols.astype(np.int32), cit.rows.astype(np.int32), vals,
                             (cit.n, cit.n), sr, block=(128, 128), device=dev)
        n_pad = a.shape[1]
        gen = torch.Generator(device=dev).manual_seed(SEED + 24)
        if sr is BOOL_OR_AND:
            xs = torch.zeros((live.shape[0], n_pad), dtype=sr.dtype, device=dev)
            xs[:, : cit.n] = live.to(sr.dtype)
        else:
            xs = torch.rand((live.shape[0], n_pad), generator=gen, device=dev) + 0.5
            xs[:, : cit.n] = torch.where(live, xs[:, : cit.n], 0.0)
            xs[:, cit.n:] = 0.0
        xsp = xs[:, : cit.n]
        whole1 = semiring_spmv_padded_batch(a.tiles, a.tile_cols, xs, sr=sr)
        keep, xd = ops._frontier_block(a, xsp, sr, None)
        whole2 = semiring_spmspv_padded_batch(a.tiles, ops._spmspv_meta_batch(a, keep), xd, sr=sr)
        for d in devices:
            c = -(-xs.shape[0] // d)
            for lo in range(0, xs.shape[0], c):
                hi = min(xs.shape[0], lo + c)
                blk = xs[lo:hi].contiguous()
                y1 = semiring_spmv_padded_batch(a.tiles, a.tile_cols, blk, sr=sr)
                err = compare(y1, ref.spmv_padded_batch_ref(a.tiles, a.tile_cols, blk, sr), sr,
                              f"phase 24 kernel 1b {sr.name} D={d} rows {lo}:{hi}")
                worst["semiring_spmv_padded_batch"] = max(worst["semiring_spmv_padded_batch"], err)
                torch.cuda.synchronize()
                check(torch.equal(y1, whole1[lo:hi]), f"phase 24 kernel 1b {sr.name} D={d} rows "
                      f"{lo}:{hi}: not the whole block's rows")
                keep_d, xd_d = ops._frontier_block(a, xsp[lo:hi], sr, None)
                meta_d = ops._spmspv_meta_batch(a, keep_d)
                y2 = semiring_spmspv_padded_batch(a.tiles, meta_d, xd_d, sr=sr)
                err = compare(y2, ref.spmspv_padded_batch_ref(a.tiles, meta_d, xd_d, sr), sr,
                              f"phase 24 kernel 2b {sr.name} D={d} rows {lo}:{hi}")
                worst["semiring_spmspv_padded_batch"] = max(
                    worst["semiring_spmspv_padded_batch"], err)
                torch.cuda.synchronize()
                check(torch.equal(y2, whole2[lo:hi]), f"phase 24 kernel 2b {sr.name} D={d} rows "
                      f"{lo}:{hi}: not the whole block's rows")
                held += 2
        del a, xs, xsp, whole1, whole2, keep, xd
        torch.cuda.empty_cache()
    lap("hold")
    print(f"phase 24: on cit-HP's BFS level {level} ({int(live.sum())} frontier entries over "
          f"{live.shape[0]} rows), {held} per-device launches of kernels 1b and 2b (⟨∨,∧⟩ and "
          f"⟨+,×⟩, D in {list(devices)}) match their plain versions and equal the whole block's "
          "rows bit for bit")

    # ------------------------------------------------- r-TX, one row a device
    src_rtx, want_rtx, _ = phase14["bfs r-TX"]
    eng = build_engine(rtx, BOOL_OR_AND, stump, device=dev, **tiles)

    def clipped(s):
        want = bfs_reference(rtx.rows, rtx.cols, rtx.n, s)
        return np.where(want > rtx_iters, -1, want)

    def rtx_multi(e, s, mesh=None):
        return bfs_multi(e, s, max_iters=rtx_iters, mesh=mesh)

    # the single-device batched run again, for a wall in this phase
    one, one_ms, one_counts = main_path(lambda: rtx_multi(eng, src_rtx))
    for field, got, ref_ in zip(one._fields, one, want_rtx):
        check(torch.equal(got, ref_), f"phase 24 bfs r-TX: the single-device run's {field} "
              "differs from phase 14's")
    one_syncs = syncs(lambda: rtx_multi(eng, src_rtx)) / max(int(one.iterations.max()), 1)
    rows.append(run_mesh("bfs", rtx, eng, rtx_multi, src_rtx, want_rtx, one_ms, d_rtx,
                         oracle_rows=2, oracle=clipped, extra={
                             "single_device_launches": one_counts,
                             "single_device_host_syncs_per_level": one_syncs}))
    del eng, one
    torch.cuda.empty_cache()
    lap("r-TX")
    print(f"phase 24: r-TX bfs_multi at B = {len(src_rtx)} on {d_rtx} virtual devices, one row "
          f"a device, equals phase 14's run; two rows equal the clipped oracle")

    # ------------------------------------------------- the server on a mesh
    queries = serve_workload(cit, n_queries, SEED + 24)
    served = {}
    for name, mesh in (("plain", None), ("mesh", Mesh((max(devices),), ("batch",), device=dev))):
        srv = GraphQueryServer(cit, stump, batch_size=SERVE_BATCH, mesh=mesh, device=dev)
        reqs = [srv.submit(a, s) for a, s in queries]
        t0 = time.perf_counter()
        srv.flush()
        served[name] = (reqs, (time.perf_counter() - t0) * 1e3, dict(srv.counters))
        del srv
    for p, q in zip(served["plain"][0], served["mesh"][0]):
        check((p.algorithm, p.source) == (q.algorithm, q.source) and set(p.result) ==
              set(q.result), f"phase 24 server: request {p.algorithm}/{p.source} differs")
        # csr/csc PPR: the ⟨+,×⟩ CSR reduce sums with atomics, so ranks
        # within rtol 1e-3, atol 1e-6 and the stop within one iteration,
        # as phase 17 holds them
        same_stop = p.result["iterations"] == q.result["iterations"]
        for key, want in p.result.items():
            if p.algorithm == "ppr" and key != "rank" and not same_stop:
                check(key != "iterations" or abs(q.result[key] - want) <= 1,
                      f"phase 24 server ppr/{p.source}: iterations {q.result[key]} and {want}")
            elif p.algorithm == "ppr" and key in ("rank", "residual"):
                np.testing.assert_allclose(q.result[key], want, rtol=1e-3, atol=1e-6,
                                           err_msg=f"phase 24 server ppr/{p.source} {key}")
            else:
                check(np.array_equal(np.asarray(q.result[key]), np.asarray(want)),
                      f"phase 24 server {p.algorithm}/{p.source}: {key} differs")
    check(served["plain"][2] == served["mesh"][2], "phase 24 server: counters differ")
    lap("server")
    print(json.dumps({"phase": 24, "seconds_by_part": laps}))
    print(json.dumps({"phase": 24, "server": "cit-HP", "queries": len(queries),
                      "devices": max(devices), "flush_ms": served["mesh"][1],
                      "plain_flush_ms": served["plain"][1], "counters": served["mesh"][2]}))
    print(f"phase 24: GraphQueryServer(mesh=Mesh(({max(devices)},), ('batch',))) on cit-HP served "
          f"{len(queries)} queries equal to the mesh-less server's "
          f"({time.perf_counter() - t_phase:.1f} s)")
    return tally, worst


def mesh_dryrun_phase(torch) -> float:
    """Phase 24 (b): the dry run on the production meshes, on meta (no
    card: ``main`` runs it while the kernels build). Returns its seconds."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import ShapeConfig

    t0 = time.perf_counter()
    keys = {"arch", "shape", "mesh", "devices", "compile_s", "memory", "cost_raw", "cost",
            "collectives", "roofline", "model_flops_total", "model_flops_per_device",
            "useful_flops_ratio", "params_total", "params_active"}
    for arch, shape, kinds in (("xlstm-1.3b", "decode_32k", ("single",)),
                               ("deepseek-v2-lite-16b", "train_4k", ("single", "multi"))):
        for kind in kinds:
            mesh = make_production_mesh(multi_pod=kind == "multi", device="meta")
            rec, _ = dryrun.lower_cell(arch, shape, mesh)
            coll, mem, r = rec["collectives"], rec["memory"], rec["roofline"]
            print(json.dumps({"phase": "24b", "arch": arch, "shape": shape, "mesh": rec["mesh"],
                              "devices": rec["devices"], "microbatches": rec["microbatches"],
                              "memory": mem, "fits_one_card": rec["fits_one_card"],
                              "flops_per_device": rec["cost"]["flops_per_device"],
                              "hbm_bytes_per_device": rec["cost"]["hbm_bytes_per_device"],
                              "wire_bytes_per_device": coll["wire_bytes_per_device"],
                              "nvlink_bytes": coll["ici_bytes"], "ib_bytes": coll["dcn_bytes"],
                              "by_kind": coll["by_kind"], "collectives": coll["n_ops"],
                              "roofline": r, "useful_flops_ratio": rec["useful_flops_ratio"],
                              "meta_pass_s": rec["compile_s"]}))
            check(keys <= rec.keys() and rec["devices"] == mesh.n_devices,
                  f"phase 24b {arch} {kind}: record keys or devices")
            check(coll["n_ops"] > 0 and coll["wire_bytes_per_device"] > 0 and
                  coll["wire_bytes_per_device"] == coll["ici_bytes"] + coll["dcn_bytes"],
                  f"phase 24b {arch} {kind}: collectives {coll}")
            if kind == "multi":
                check(coll["dcn_bytes"] > 0, f"phase 24b {arch} multi: no bytes between nodes")
    return time.perf_counter() - t0


def rank24b_dryrun(rank: int, world: int, init: str, payload: dict) -> float:
    """``mesh_dryrun_phase`` in a process of its own (``main`` runs it
    beside the kernel build and phase 20). Returns its seconds."""
    import torch

    sys.path.insert(0, payload["src"])
    return mesh_dryrun_phase(torch)


def mesh_dryrun_cell(torch, bytes_23a: dict) -> float:
    """Phase 24 (b): the dry run of phase 23a's cell on its (2, 2) mesh
    against the bytes device 0's blocks hold on the card. Returns its
    seconds."""
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    t0 = time.perf_counter()
    b = bytes_23a
    shape = ShapeConfig("train_23a", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec, _ = dryrun.lower_cell(b["cfg"].arch_id, shape, b["mesh"], b["tcfg"], cfg=b["cfg"])
    card = sum(b["blocks"].values()) + b["step"] + b["batch_rows"]
    print(json.dumps({"phase": "24b", "cell": "phase 23a", "mesh": b["mesh"],
                      "dry_run_argument_bytes": rec["memory"]["argument_bytes"],
                      "card_device0_bytes": card, "card_blocks": b["blocks"],
                      "collectives": rec["collectives"]}))
    check(rec["memory"]["argument_bytes"] == card, f"phase 24b: the dry run's per-device "
          f"arguments {rec['memory']['argument_bytes']} are not device 0's {card} bytes on "
          "the card")
    s = time.perf_counter() - t0
    print(f"phase 24b: dry-run records on the 16x16 and 2x16x16 meshes on meta; phase 23a's "
          f"per-device arguments equal device 0's bytes on the card ({s:.1f} s)")
    return s


def local_inserts(g, k: int, rng):
    """Triangle-closing inserts: for k random edges (u, v), a random
    neighbour w of v gives a new edge (u, w); self loops and duplicates are
    no-ops. The rule of benchmarks/dynamic_updates.py::_local_inserts."""
    import numpy as np

    order = np.argsort(g.rows, kind="stable")
    sorted_cols = g.cols[order]
    ptr = np.searchsorted(g.rows[order], np.arange(g.n + 1))
    e = rng.choice(g.nnz, k, replace=True)
    u, v = g.rows[e], g.cols[e]
    deg = ptr[v + 1] - ptr[v]
    off = (rng.random(k) * deg).astype(np.int64)
    return u, sorted_cols[ptr[v] + off]


def graph_deltas(g, edge_delta):
    """One insert-only (``grow``) and one mixed (``churn``) delta of about
    1% of nnz: the rule of benchmarks/dynamic_updates.py::_deltas."""
    import numpy as np

    rng = np.random.default_rng(11)
    k = max(8, g.nnz // 100)
    gu, gw = local_inserts(g, k, rng)
    grow = edge_delta(insert_rows=gu, insert_cols=gw)
    cu, cw = local_inserts(g, k, rng)
    drop = rng.choice(g.nnz, max(4, k // 2), replace=False)
    return [("grow", grow), ("churn", edge_delta(cu, cw, g.rows[drop], g.cols[drop]))]


def multi_phases(torch, dev, cit, rtx, stump, time_ms, compare, all_kernels, b: int = 32,
                 b_rtx: int = 8, rtx_iters: int = RTX_MULTI_ITERS, max_iters: int = 256,
                 results: dict | None = None) -> dict:
    """Phases 14-15: kernels 1 and 2 over a [B, n] block against their plain
    versions and the single-vector kernels; the multi-source traversals on
    cit-HP and r-TX against the single-source runs; incremental recompute
    on cit-HP's grow and churn deltas against cold runs. Returns the two
    block kernels' rows of the kernels line; ``results``, when given,
    takes each batched run's (sources, result, wall ms) by "app graph"."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SEMIRINGS, build_bsr_padded
    from repro_torch.core.delta import EdgeDelta, canonicalize
    laps, t_lap = {}, [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        laps[part] = now - t_lap[0]
        t_lap[0] = now

    from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, MIN_TIMES, PLUS_TIMES
    from repro_torch.graphs import (
        bfs, bfs_multi, bfs_reference, build_engine, cc_reference, connected_components,
        pagerank, ppr, ppr_multi, sssp, sssp_multi, sssp_reference, traverse_multi_buckets,
    )
    from repro_torch.graphs import engine as engine_module
    from repro_torch.graphs.dynamic import (
        DynamicGraph, bfs_incremental, cc_incremental, pagerank_warm, plan_repair,
        sssp_incremental, traffic_of,
    )
    from repro_torch.graphs.engine import edge_values
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.semiring_spmv import (
        launch_block_kernel, semiring_spmv_padded, semiring_spmv_padded_batch,
    )
    from repro_torch.kernels.spmspv_tiles import (
        semiring_spmspv_padded, semiring_spmspv_padded_batch,
    )

    blocks = (semiring_spmv_padded_batch, semiring_spmspv_padded_batch)
    tally = {k.__name__: 0 for k in blocks}
    worst = {k.__name__: 0.0 for k in blocks}
    summary = {}

    def main_path(fn):
        """Run ``fn`` with every launch counter set to 0 just before it and
        add the block kernels' counts, read just after, to the tally."""
        for k in all_kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for k in blocks:
            tally[k.__name__] += k.launches
        return out

    def same(y, y_ref, what: str) -> None:
        torch.cuda.synchronize()
        check(torch.equal(y, y_ref), what)

    def bound(nbytes: int, n_ops: int, rate: float) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / rate
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def wall(fn):
        """fn's result and its host-clock ms, ending in a sync."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def trace_window(fn) -> dict:
        """One call of fn under the profiler with CUDA activity: its wall,
        all device time, the device time of the block fold (kernels 1
        and 2 over a block, tile_fold_block_kernel) and, under
        ``host_syncs``, ``syncs``' count of its device-to-host reads."""
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        block = [e for e in kernels if "tile_fold_block_kernel" in e.key]
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:5]
        return {"wall_ms": wall_ms, "device_ms": device_ms,
                "block_fold_ms": sum(e.self_device_time_total for e in block) / 1e3,
                "block_fold_launches": sum(e.count for e in block),
                "device_launches": sum(e.count for e in kernels),
                "device_idle_share": 1 - device_ms / wall_ms if wall_ms else None,
                "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
                "host_syncs": sum(e.count for e in prof.key_averages()
                                  if e.key == "aten::_local_scalar_dense")}

    def syncs(fn) -> int:
        """Device-to-host reads in one call of fn: the profiler's count of
        aten::_local_scalar_dense (every bool(), int() and item())."""
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        return sum(e.count for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")

    # ---------------------------------------------------------------- 14
    rng = np.random.default_rng(SEED)
    extra = np.random.default_rng(SEED + 1)
    for name_i, (name, sr) in enumerate(SEMIRINGS.items()):
        vals = edge_values(cit, sr, weighted=sr.collective == "pmin", seed=5,
                           normalize=name == "plus_times")
        a = build_bsr_padded(cit.cols.astype(np.int32), cit.rows.astype(np.int32), vals,
                             (cit.n, cit.n), sr, block=(128, 128), device=dev)
        mb, t, bm, bn = a.tiles.shape
        n_pad = a.shape[1]
        if sr.dtype == torch.int32:
            xv = rng.integers(0, 2, (b, n_pad)).astype(np.int32)
        else:
            xv = rng.uniform(0.5, 4.0, (b, n_pad)).astype(np.float32)
        xs = torch.from_numpy(xv).to(dev)
        xs[0] = sr.zero                                   # an all-pad row
        dens = np.array([0.0] + [DENSITIES[i % 3] for i in range(b - 1)])
        live = torch.from_numpy(rng.random((b, cit.n)) < dens[:, None]).to(dev)
        xsp = torch.where(live, xs[:, : cit.n], sr.zero)
        # 8 more rows, from their own generator, for a block over two
        # vector groups of the fold (32 + 8)
        xs40 = torch.cat([xs, xs[1:9].roll(1 + name_i, dims=1)])
        xsp40 = torch.cat([xsp, torch.where(
            torch.from_numpy(extra.random((8, cit.n)) < 0.05).to(dev), xs40[b:, : cit.n],
            sr.zero)])
        for lo, hi in ((1, 2), (0, 5), (0, b + 8), (0, b)):   # B = 1, 5, b + 8, b
            blk, blk_sp = xs40[lo:hi].contiguous(), xsp40[lo:hi]
            ys = semiring_spmv_padded_batch(a.tiles, a.tile_cols, blk, sr=sr)
            same(ys, torch.stack([semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)
                                  for x in blk]),
                 f"kernel 1 over a block {name} B={hi - lo}: not kernel 1 row by row")
            err = compare(ys, ref.spmv_padded_batch_ref(a.tiles, a.tile_cols, blk, sr), sr,
                          f"kernel 1 over a block {name} B={hi - lo}")
            worst["semiring_spmv_padded_batch"] = max(worst["semiring_spmv_padded_batch"], err)
            keep, xd = ops._frontier_block(a, blk_sp, sr, None)
            meta = ops._spmspv_meta_batch(a, keep)
            ys2 = semiring_spmspv_padded_batch(a.tiles, meta, xd, sr=sr)
            same(ys2, torch.stack([semiring_spmspv_padded(a.tiles, m, x, sr=sr)
                                   for m, x in zip(meta, xd)]),
                 f"kernel 2 over a block {name} B={hi - lo}: not kernel 2 row by row")
            err = compare(ys2, ref.spmspv_padded_batch_ref(a.tiles, meta, xd, sr), sr,
                          f"kernel 2 over a block {name} B={hi - lo}")
            worst["semiring_spmspv_padded_batch"] = max(worst["semiring_spmspv_padded_batch"],
                                                        err)
        rate = INT32_OPS_PER_S if sr.dtype == torch.int32 else FP32_OPS_PER_S
        lib = None
        if name == "plus_times":
            real = (a.tiles != sr.zero).flatten(2).any(dim=2)
            crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              real.sum(dim=1).cumsum(0)])
            lib = torch.sparse_bsr_tensor(crow, a.tile_cols[real].long(), a.tiles[real],
                                          size=a.shape, check_invariants=False)
            torch.testing.assert_close((lib @ xs.T).T, ys, rtol=1e-4, atol=1e-5)
        nbytes = (a.tiles.numel() + a.tile_cols.numel() + xs.numel() + b * mb * bm) * 4
        bound_ms, bound_by = bound(nbytes, 2 * b * a.tiles.numel(), rate)
        row = {"kernel": "semiring_spmv_padded_batch", "semiring": name, "graph": "cit-HP",
               "B": b, "tiles": [mb, t, bm, bn], "max_abs_err": worst["semiring_spmv_padded_batch"],
               "ms": time_ms(lambda: semiring_spmv_padded_batch(a.tiles, a.tile_cols, xs, sr=sr)),
               "seq_kernel1_ms": time_ms(lambda: [semiring_spmv_padded(a.tiles, a.tile_cols, x,
                                                                       sr=sr) for x in xs], reps=3),
               "plain_ms": time_ms(lambda: ref.spmv_padded_batch_ref(a.tiles, a.tile_cols, xs, sr),
                                   reps=PLAIN_SLOW_REPS, warmup=0) if lib is not None else None,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(lambda: lib @ xs.T) if lib is not None else None}
        print(json.dumps(row))
        # bytes: each tile that some row's frontier needs, read once; the
        # operations: every row's active slots
        n_active = int(meta[:, :, 0].sum())
        union = ops._spmspv_union_batch(meta)
        needed = int(union[:, :, 0].sum())
        nbytes2 = (needed * bm * bn + meta.numel() + xd.numel() + b * mb * bm) * 4
        bound2, by2 = bound(nbytes2, 2 * n_active * bm * bn, rate)
        row2 = {"kernel": "semiring_spmspv_padded_batch", "semiring": name, "graph": "cit-HP",
                "B": b, "row_densities": list(DENSITIES), "n_active": n_active,
                "tiles_needed": needed,
                "max_abs_err": worst["semiring_spmspv_padded_batch"],
                "ms": time_ms(lambda: launch_block_kernel(
                    "spmspv_tiles.cu", "semiring_spmspv_padded_batch", a.tiles, union, xd, sr)),
                "wrapper_ms": time_ms(lambda: semiring_spmspv_padded_batch(a.tiles, meta, xd,
                                                                           sr=sr)),
                "seq_kernel2_ms": time_ms(lambda: [semiring_spmspv_padded(a.tiles, m, x, sr=sr)
                                                   for m, x in zip(meta, xd)], reps=3),
                "plain_ms": time_ms(lambda: ref.spmspv_padded_batch_ref(a.tiles, meta, xd, sr),
                                    reps=PLAIN_SLOW_REPS, warmup=0) if lib is not None else None,
                "bound_ms": bound2, "bound_by": by2,
                "library_ms": time_ms(lambda: lib @ xd.T) if lib is not None else None}
        print(json.dumps(row2))
        if lib is not None:
            summary["semiring_spmv_padded_batch"] = row
            summary["semiring_spmspv_padded_batch"] = row2
        del a, xs, xsp, xs40, xsp40, live, ys, ys2, meta, union, xd, lib
        torch.cuda.empty_cache()
    lap("block kernels")
    print("phase 14: kernels 1 and 2 over a block equal kernels 1 and 2 row by row and match "
          f"their plain versions for all five semirings at B = 1, 5, {b} and {b + 8}, an "
          f"all-pad row and per-row densities {list(DENSITIES)}")

    apps = {}

    def run_multi(label, g, sr, multi, single, field, srcs, exact=True, oracle=None,
                  traced=False, **kw):
        """The batched app once through the main path, then its sequential
        single-source runs on the same engine; every row held to its
        single-source run; with ``traced``, one more run in a profiler
        window. Returns the engine (for more runs) and the row."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = build_engine(g, sr, stump, device=dev, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        before = dict(tally)
        res, wall_ms = wall(lambda: main_path(lambda: multi(eng, srcs)))
        launches = {k: tally[k] - before[k] for k in tally}
        peak = torch.cuda.max_memory_allocated()
        singles, seq_ms = wall(lambda: [single(eng, s) for s in srcs])
        for i, s in enumerate(srcs):
            ref_i = singles[i]
            what = f"{label} {g.name} row {i} (source {s})"
            check(int(res.iterations[i]) == ref_i.iterations,
                  f"{what}: {int(res.iterations[i])} iterations, single {ref_i.iterations}")
            same(res.kernel_used[i], ref_i.kernel_used, f"{what}: kernel trace")
            same(res.densities[i], ref_i.densities, f"{what}: density trace")
            got, want = getattr(res, field)[i], getattr(ref_i, field)
            if exact:
                same(got, want, f"{what}: {field} differ from the single-source run")
            else:
                torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-6,
                                           msg=lambda m: f"{what}: {m}")
        n_oracle = 0
        if oracle is not None:
            for i in range(min(4, len(srcs))):
                check(np.array_equal(getattr(res, field)[i].cpu().numpy(), oracle(srcs[i])),
                      f"{label} {g.name} row {i}: differs from the oracle")
                n_oracle += 1
        if traced:          # one profiled run: its device-to-host reads and its trace
            trace = trace_window(lambda: multi(eng, srcs))
            n_sync = trace.pop("host_syncs")
        else:
            n_sync = syncs(lambda: multi(eng, srcs))
        levels = int(res.iterations.max())
        row = {"app": f"{label}_multi", "graph": g.name, "B": len(srcs),
               "fmt": f"{kw.get('fmt_spmv', 'csr')}/{kw.get('fmt_spmspv', 'csc')}",
               "build_s": build_s, "wall_ms": wall_ms, "seq_single_ms": seq_ms,
               "queries_per_s": len(srcs) / (wall_ms / 1e3),
               "seq_queries_per_s": len(srcs) / (seq_ms / 1e3),
               "levels": levels, "iterations": res.iterations.tolist(),
               "host_syncs": n_sync, "host_syncs_per_level": n_sync / max(levels, 1),
               "launches": launches, "rows_held_to_oracle": n_oracle,
               "max_memory_allocated": peak}
        if traced:
            row["trace"] = trace
        apps[f"{label} {g.name}"] = row
        if results is not None:
            results[f"{label} {g.name}"] = (list(srcs), res, wall_ms)
        print(json.dumps(row))
        return eng, res, row

    tiles = {"fmt_spmv": "bsr", "fmt_spmspv": "bsr"}
    srcs = [int(s) for s in rng.choice(cit.n, b, replace=False)]
    w5 = edge_values(cit, MIN_PLUS, weighted=True, seed=5)
    eng, res, _ = run_multi(
        "bfs", cit, BOOL_OR_AND, bfs_multi, bfs, "levels", srcs,
        oracle=lambda s: bfs_reference(cit.rows, cit.cols, cit.n, s), **tiles)
    more = [int(s) for s in rng.choice(cit.n, 52, replace=False)]
    buckets = [srcs, more[:32], more[32:]]
    outs = {depth: main_path(lambda: traverse_multi_buckets(eng, "bfs", buckets,
                                                            pipeline_depth=depth, pad_to=b))
            for depth in (0, 2)}
    for r0, r2, bucket in zip(outs[0], outs[2], buckets):
        for x0, x2 in zip(r0, r2):
            same(x0, x2, "traverse_multi_buckets: depth 0 and depth 2 differ")
        check(r0.levels.shape[0] == b, "pad_to did not pad the bucket")
    same(outs[0][0].levels, res.levels, "the first bucket differs from bfs_multi")
    print(f"phase 14: traverse_multi_buckets on cit-HP BFS, buckets of {[len(x) for x in buckets]} "
          f"padded to {b}: depth 0 and depth 2 identical")
    del eng, res, outs
    torch.cuda.empty_cache()
    eng, _, _ = run_multi(
        "sssp", cit, MIN_PLUS, sssp_multi, sssp, "dist", srcs, weighted=True, seed=5,
        oracle=lambda s: sssp_reference(cit.rows, cit.cols, w5, cit.n, s).astype(np.float32),
        **tiles)
    del eng
    torch.cuda.empty_cache()
    eng, _, _ = run_multi("ppr", cit, PLUS_TIMES, ppr_multi, ppr, "rank", srcs, exact=False,
                          normalize=True, traced=True, **tiles)
    del eng
    torch.cuda.empty_cache()
    lap("cit-HP multi-source")
    print(f"phase 14: cit-HP bfs/sssp/ppr_multi at B = {b} equal the single-source runs row by "
          "row (PPR within rtol 1e-3), with iterations and kernel traces")

    src_rtx = [int(s) for s in rng.choice(rtx.n, b_rtx, replace=False)]
    eng, res, row = run_multi(
        "bfs", rtx, BOOL_OR_AND, lambda e, s: bfs_multi(e, s, max_iters=rtx_iters),
        lambda e, s: bfs(e, s, max_iters=rtx_iters), "levels", src_rtx, traced=True, **tiles)
    check(row["launches"]["semiring_spmspv_padded_batch"] > 0,
          "kernel 2 over a block was not launched on r-TX")
    for i in range(2):
        want = bfs_reference(rtx.rows, rtx.cols, rtx.n, src_rtx[i])
        check(np.array_equal(res.levels[i].cpu().numpy(), np.where(want > rtx_iters, -1, want)),
              f"r-TX BFS row {i}: differs from the clipped oracle")
    # kernel 2 over the block at B = b_rtx on one real BFS level of r-TX:
    # each row's frontier is its source's level-`depth` vertices; a CTA of
    # the fold owns TILEFOLD_BLOCK_ROWS tile rows
    rows_per_cta = int(re.search(r"#define TILEFOLD_BLOCK_ROWS (\d+)",
                                 (_build.CSRC / "tile_fold.cuh").read_text()).group(1))
    depth = min(64, rtx_iters)
    levels = res.levels.cpu().numpy()
    del eng, res
    torch.cuda.empty_cache()
    sr = BOOL_OR_AND
    a = build_bsr_padded(rtx.cols.astype(np.int32), rtx.rows.astype(np.int32),
                         np.ones(rtx.nnz, np.int32), (rtx.n, rtx.n), sr, block=(128, 128),
                         device=dev)
    mb, t, bm, bn = a.tiles.shape
    live = torch.from_numpy(levels == depth).to(dev)
    keep, xd = ops._frontier_block(a, live.to(torch.int32), sr, None)
    meta = ops._spmspv_meta_batch(a, keep)
    union = ops._spmspv_union_batch(meta)
    ys2 = semiring_spmspv_padded_batch(a.tiles, meta, xd, sr=sr)
    same(ys2, torch.stack([semiring_spmspv_padded(a.tiles, m, x, sr=sr)
                           for m, x in zip(meta, xd)]),
         f"kernel 2 over a block on r-TX level {depth}: not kernel 2 row by row")
    err = compare(ys2, ref.spmspv_padded_batch_ref(a.tiles, meta, xd, sr), sr,
                  f"kernel 2 over a block on r-TX level {depth}")
    worst["semiring_spmspv_padded_batch"] = max(worst["semiring_spmspv_padded_batch"], err)
    needed, n_active = int(union[:, :, 0].sum()), int(meta[:, :, 0].sum())
    bound_ms, bound_by = bound((needed * bm * bn + meta.numel() + xd.numel()
                                + b_rtx * mb * bm) * 4, 2 * n_active * bm * bn, INT32_OPS_PER_S)
    print(json.dumps({
        "kernel": "semiring_spmspv_padded_batch", "semiring": sr.name, "graph": "r-TX",
        "B": b_rtx, "level": depth, "frontier": int(live.sum()), "tiles": [mb, t, bm, bn],
        "n_active": n_active, "tiles_needed": needed,
        "nonempty_block_rows": int((union[:, :, 0] > 0).sum()),
        "ctas": mb * union.shape[0] * -(-bm // rows_per_cta),
        "ms": time_ms(lambda: launch_block_kernel(
            "spmspv_tiles.cu", "semiring_spmspv_padded_batch", a.tiles, union, xd, sr)),
        "wrapper_ms": time_ms(lambda: semiring_spmspv_padded_batch(a.tiles, meta, xd, sr=sr)),
        "seq_kernel2_ms": time_ms(lambda: [semiring_spmspv_padded(a.tiles, m, x, sr=sr)
                                           for m, x in zip(meta, xd)]),
        "bound_ms": bound_ms, "bound_by": bound_by}))
    print(f"phase 14: r-TX kernel 2 over a block at B = {b_rtx} on BFS level {depth} equals "
          "kernel 2 row by row")
    del a, live, keep, xd, meta, union, ys2
    torch.cuda.empty_cache()
    union_calls = [0]
    real_union = engine_module.spmspv_batch_union

    def counted_union(*args, **kw):
        union_calls[0] += 1
        return real_union(*args, **kw)

    engine_module.spmspv_batch_union = counted_union
    try:
        eng, _, row = run_multi(
            "sssp", rtx, MIN_PLUS, lambda e, s: sssp_multi(e, s, max_iters=rtx_iters),
            lambda e, s: sssp(e, s, max_iters=rtx_iters), "dist", src_rtx, weighted=True, seed=5)
    finally:
        engine_module.spmspv_batch_union = real_union
    check(union_calls[0] > 0, "spmspv_batch_union did not run on the r-TX element route")
    row["union_calls"] = union_calls[0]
    print(json.dumps({"phase": 14, "rtx_sssp_union_calls": union_calls[0]}))
    del eng
    torch.cuda.empty_cache()
    lap("r-TX multi-source")
    print(f"phase 14: r-TX bfs_multi (tile route, {rtx_iters} levels, held to the clipped "
          f"oracle) and sssp_multi (csr/csc, the union SpMSpV) at B = {b_rtx} equal the "
          "single-source runs")

    # ---------------------------------------------------------------- 15
    def tile_engine(g, sr, **kw):
        return build_engine(g, sr, stump, device=dev, **tiles, **kw)

    keyed = {"weighted": True, "seed": 5, "content_keyed": True}
    old = {}
    for key, sr, kw, fn in (
            ("levels", BOOL_OR_AND, {}, lambda e: bfs_multi(e, srcs, max_iters=max_iters).levels),
            ("dist", MIN_PLUS, keyed, lambda e: sssp_multi(e, srcs, max_iters=max_iters).dist),
            ("labels", MIN_TIMES, {}, lambda e: connected_components(e).labels),
            ("rank", PLUS_TIMES, {"normalize": True},
             lambda e: pagerank(e, max_iters=200).rank)):
        e = tile_engine(cit, sr, **kw)
        old[key] = fn(e)
        del e
        torch.cuda.empty_cache()
    for kind, delta in graph_deltas(cit, EdgeDelta):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g1 = DynamicGraph(cit).apply(delta)
        apply_ms = (time.perf_counter() - t0) * 1e3
        d = canonicalize(delta, cit.n)
        row = {"phase": 15, "delta": kind, "inserts": d.n_inserts, "deletes": d.n_deletes,
               "apply_ms": apply_ms, "nnz": g1.nnz, "B": b}
        e = tile_engine(g1, MIN_PLUS)                     # unit weights: BFS levels
        repair, row["repair_ms"] = wall(lambda: plan_repair(e, d))
        inc, row["bfs_inc_ms"] = wall(lambda: main_path(
            lambda: bfs_incremental(e, srcs, old["levels"], d, repair=repair,
                                    max_iters=max_iters)))
        del e
        torch.cuda.empty_cache()
        e = tile_engine(g1, BOOL_OR_AND)
        cold, row["bfs_cold_ms"] = wall(lambda: main_path(
            lambda: bfs_multi(e, srcs, max_iters=max_iters)))
        del e
        torch.cuda.empty_cache()
        check(int(cold.iterations.max()) < max_iters, f"{kind}: cold BFS hit max_iters")
        check(np.array_equal(inc.values, cold.levels.cpu().numpy()),
              f"{kind}: bfs_incremental differs from the cold bfs_multi")
        row.update(bfs_traffic_inc=inc.traffic, bfs_traffic_cold=traffic_of(cold),
                   repair_traffic=repair.traffic,
                   stale=int(repair.stale.sum()) if repair.stale is not None else 0,
                   bfs_iters_inc=int(inc.result.iterations.max()),
                   bfs_iters_cold=int(cold.iterations.max()))
        e = tile_engine(g1, MIN_PLUS, **keyed)
        inc, row["sssp_inc_ms"] = wall(lambda: main_path(
            lambda: sssp_incremental(e, srcs, old["dist"], d, repair=repair,
                                     max_iters=max_iters)))
        cold, row["sssp_cold_ms"] = wall(lambda: main_path(
            lambda: sssp_multi(e, srcs, max_iters=max_iters)))
        del e
        torch.cuda.empty_cache()
        check(int(cold.iterations.max()) < max_iters, f"{kind}: cold SSSP hit max_iters")
        check(np.array_equal(inc.values, cold.dist.cpu().numpy()),
              f"{kind}: sssp_incremental differs from the cold sssp_multi")
        row.update(sssp_traffic_inc=inc.traffic, sssp_traffic_cold=traffic_of(cold),
                   sssp_iters_inc=int(inc.result.iterations.max()),
                   sssp_iters_cold=int(cold.iterations.max()))
        e = tile_engine(g1, MIN_TIMES)
        inc, row["cc_inc_ms"] = wall(lambda: cc_incremental(e, old["labels"], d))
        cold, row["cc_cold_ms"] = wall(lambda: connected_components(e))
        del e
        torch.cuda.empty_cache()
        same(inc.labels, cold.labels, f"{kind}: cc_incremental differs from the cold run")
        check(np.array_equal(cold.labels.cpu().numpy(), cc_reference(g1.rows, g1.cols, g1.n)),
              f"{kind}: CC differs from cc_reference")
        row.update(cc_iters_inc=inc.iterations, cc_iters_cold=cold.iterations)
        e = tile_engine(g1, PLUS_TIMES, normalize=True)
        warm, row["pr_warm_ms"] = wall(lambda: pagerank_warm(e, old["rank"], max_iters=200))
        cold, row["pr_cold_ms"] = wall(lambda: pagerank(e, max_iters=200))
        del e
        torch.cuda.empty_cache()
        torch.testing.assert_close(warm.rank, cold.rank, rtol=1e-4, atol=1e-7,
                                   msg=lambda m: f"{kind}: pagerank_warm: {m}")
        # no more iterations than cold, held on the insert-only delta as
        # tests/test_dynamic.py holds it; on churn the deletes can move the
        # fixpoint near hubs so far that the uniform start is closer
        # (benchmarks/dynamic_updates.py reports scale-free rows, asserts none)
        if kind == "grow":
            check(warm.iterations <= cold.iterations,
                  f"{kind}: warm PageRank took {warm.iterations} iterations, cold "
                  f"{cold.iterations}")
        row.update(pr_iters_warm=warm.iterations, pr_iters_cold=cold.iterations,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        print(json.dumps(row))
    lap("incremental")
    print(json.dumps({"phase": "14-15", "seconds_by_part": laps}))
    print(f"phase 15: cit-HP grow and churn deltas: bfs/sssp/cc_incremental equal the cold runs "
          f"at B = {b}, pagerank_warm within rtol 1e-4 of cold (no more iterations on grow)")
    for k in blocks:
        check(tally[k.__name__] > 0, f"{k.__name__} was not launched in phases 14-15")
        summary[k.__name__]["launches"] = tally[k.__name__]
        summary[k.__name__]["max_abs_err"] = worst[k.__name__]
    print(f"phases 14-15: block launches on the multi-source path {json.dumps(tally)}")
    return summary


def mesh_phases(torch, dev, cit, rtx, caq, time_ms, compare, all_kernels) -> tuple[dict, dict]:
    """Phase 16: the mesh layer on D = R·C virtual devices of the card.
    Every distributed call is held to the single-device kernels on the same
    graph, and each kernel's launches on the virtual devices to its plain
    version on that device's part and input (the shapes the mesh gives
    it); the Load / Kernel / Retrieve+Merge split of each strategy is
    timed under the blocking schedule beside the cost model's estimate;
    a warm distributed call under every topology makes no synchronising
    CUDA call; ``iterate_phases`` runs at depth 0 and 2; the planner's pick
    for the paper's CSC-2D config is set beside the measured fastest
    strategy. Returns ({kernel name: launches in phase 16's distributed
    calls}, {kernel name: max |kernel - plain| over the parts})."""
    import importlib
    import warnings

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.alpha_pim_graph import CONFIG
    from repro_torch.core import build_bsr_padded, frontier_from_dense
    from repro_torch.core.collectives import plan_merge
    from repro_torch.core.distributed import (
        _fused_partials, build_phase_fns, make_distributed_batched_matvec,
        make_distributed_matvec, make_distributed_spgemm, vec_to_2d_layout,
    )
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.pipeline import iterate_phases, run_phases_once
    from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, PLUS_AND, PLUS_TIMES
    from repro_torch.core.spgemm import spgemm_masked
    from repro_torch.core.spmspv import spmspv_batch
    from repro_torch.core.spmv import spmv_batch
    from repro_torch.graphs.cost_model import estimate_phase_costs, merge_wire_cost
    from repro_torch.graphs.engine import edge_values
    from repro_torch.graphs.multi import partitioned_matvec
    from repro_torch.kernels import ops, ref

    part = importlib.import_module("repro_torch.core.partition")
    grid, grid_big, b, pipe_iters = MESH_GRID, MESH_GRID_BIG, MESH_B, PIPE_ITERS
    r_parts, c_parts = grid
    d = r_parts * c_parts
    strategies = {"row": (d, 1), "col": (1, d), "2d": grid}
    mesh = Mesh(grid, device=dev)
    tally = {k.__name__: 0 for k in all_kernels}
    kern = {k.__name__: k for k in all_kernels}
    errs = {}           # kernel name -> max |kernel - plain| over the mesh's parts
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    def main_path(fn):
        """Run one distributed call with every launch counter set to 0 just
        before it; add the counts, read just after, to the tally."""
        for k in all_kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for k in all_kernels:
            tally[k.__name__] += k.launches
        return out

    def same(a, b_, what: str) -> None:
        torch.cuda.synchronize()
        check(torch.equal(a, b_), what)

    def reads(fn) -> int:
        """Device-to-host reads in one call of fn (aten::_local_scalar_dense)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")

    def syncs(fn) -> int:
        """Synchronising CUDA calls in one call of fn (a blocking copy, a
        read, a nonzero, a synchronize), as torch.cuda's sync debug mode
        reports them."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)

    def held(name: str, y, y_plain, sr, what: str) -> None:
        errs[name] = max(errs.get(name, 0.0), compare(y, y_plain, sr, what))

    kernel_of = {("spmv", False): "semiring_spmv_padded",
                 ("spmspv", False): "semiring_spmspv_padded",
                 ("spmv", True): "semiring_spmv_fused_padded",
                 ("spmspv", True): "semiring_spmspv_fused_padded"}

    def hold_kernel_phase(pm, sr, strategy, x, kernel, fused=False, m=None, tag="") -> None:
        """One Kernel phase of a distributed call, run as the main path;
        device g's output held to its kernel's plain version on device g's
        part and gathered input: the operands the mesh gives the kernel."""
        use = m or mesh
        xs = part.shard_tensor(pm.plan, x[:pm.plan.shape[1]], sr.zero)
        fns = build_phase_fns(use, pm, sr, strategy, kernel, fused=fused)
        xf = fns["load"](pm.parts, xs) if fns["load"] is not None else xs
        if fused and strategy != "row":
            # the fused closure merges too: its Kernel half alone
            chunks = use.n_devices if strategy == "col" else use.grid[1]
            ys = main_path(lambda: _fused_partials(pm.parts, xf, sr, kernel, chunks)[0])
        else:
            ys = main_path(lambda: fns["kernel"](pm.parts, xs, xf))
        name = kernel_of[(kernel, fused)]
        for g in range(pm.n_devices):
            a, xg = part.device_part(pm.parts, g), xf[g]
            if kernel == "spmspv":
                y_plain = ops.semiring_spmspv_ref(a, frontier_from_dense(xg, sr), sr)
            elif fused:
                y_plain = ref.spmv_fused_padded_ref(a.tiles, ops._spmv_fused_meta(a), xg, sr)
            else:
                y_plain = ops.semiring_spmv_ref(a, xg, sr)
            held(name, ys[g].reshape(-1), y_plain, sr, f"phase 16 {tag} {name} on device {g}")

    def sync_check(pm, sr, strategy, x, tag: str) -> dict:
        """Synchronising calls in a warm distributed call (its index tables
        built by a first call), for every topology, kernel, fused form and
        (row, 2d) the compressed Load: 0 each, or the depth-2 pipeline
        would wait on the card."""
        xs = part.shard_tensor(pm.plan, x[:pm.plan.shape[1]], sr.zero)
        forms = [("spmv", False, None), ("spmv", True, None), ("spmspv", False, None),
                 ("spmspv", True, None)]
        if strategy != "col":
            forms.append(("spmspv", False, pm.plan.in_per))
        counts = {}
        for topology in (("flat",) if strategy == "row" else ("flat", "ring", "tree", "staged2d")):
            for kernel, fused, f_local in forms:
                fn = make_distributed_matvec(mesh, pm, sr, strategy, kernel=kernel,
                                             topology=topology, fused=fused, f_local=f_local)
                fn(pm.parts, xs)
                form = "compressed" if f_local else "fused" if fused else "unfused"
                counts[f"{topology}/{kernel}/{form}"] = syncs(lambda: fn(pm.parts, xs))
        check(not any(counts.values()), f"{tag}: a warm distributed call synchronised: {counts}")
        return counts

    def transposed(g, sr, vals, shape=None, block=(128, 128)):
        return build_bsr_padded(g.cols.astype(np.int32), g.rows.astype(np.int32), vals,
                                shape or (g.n, g.n), sr, block=block, device=dev)

    def partition_of(g, sr, vals, pgrid, balance, shape=None, fmt="bsr", block=(128, 128)):
        t0 = time.perf_counter()
        pm = part.partition(g.cols.astype(np.int64), g.rows.astype(np.int64), vals,
                            shape or (g.n, g.n), pgrid, fmt, sr, block=block, balance=balance,
                            device=dev)
        torch.cuda.synchronize()
        return pm, time.perf_counter() - t0

    def run_e2e(pm, sr, strategy, x, n_true, m=None, **kw):
        """Shard x (length n_true), one distributed call, unshard: y [m]."""
        use = mesh if m is None else m
        xs = part.shard_tensor(pm.plan, x[:n_true], sr.zero)
        fn = make_distributed_matvec(use, pm, sr, strategy, **kw)
        return part.unshard_tensor(pm.plan, main_path(lambda: fn(pm.parts, xs)))

    def x_of(rng, sr, n, integer=True):
        if sr.dtype == torch.int32:
            v = rng.integers(0, 2, n).astype(np.int32)
        elif integer:
            v = rng.integers(0, 9, n).astype(np.float32)
        else:
            v = rng.uniform(0.5, 4.0, n).astype(np.float32)
        return torch.from_numpy(v).to(dev)

    def sparse(rng, sr, x, density):
        keep = torch.from_numpy(rng.random(x.shape[0]) < density).to(dev)
        return torch.where(keep, x, torch.as_tensor(sr.zero, dtype=sr.dtype, device=dev))

    def phase_split(pm, sr, strategy, balance, x, t_single, m=None) -> dict:
        """Load, Kernel and Retrieve+Merge of one spmv timed apart under the
        blocking schedule (CUDA events around each phase, medians of 10),
        the Kernel phase's launches, and the cost model's estimate beside
        them (elements per device; the Merge priced for the flat merge)."""
        use = m or mesh
        xs = part.shard_tensor(pm.plan, x[:pm.plan.shape[1]], sr.zero)
        fns = build_phase_fns(use, pm, sr, strategy, "spmv")
        load, kern, rm = fns["load"], fns["kernel"], fns["retrieve_merge"]
        xf = load(pm.parts, xs) if load is not None else xs
        for k in all_kernels:
            k.launches = 0
        ys = kern(pm.parts, xs, xf)
        torch.cuda.synchronize()
        launched = {k.__name__: k.launches for k in all_kernels if k.launches}
        m_merge = {"row": 0, "col": pm.plan.padded_shape[0],
                   "2d": pm.plan.local_shape[0]}[strategy]
        return {"strategy": strategy, "balance": balance, "devices": use.n_devices,
                "load_ms": time_ms(lambda: load(pm.parts, xs)) if load is not None else 0.0,
                "kernel_ms": time_ms(lambda: kern(pm.parts, xs, xf)),
                "retrieve_merge_ms": (time_ms(lambda: rm(pm.parts, ys)) if rm is not None
                                      else 0.0),
                "e2e_ms": time_ms(lambda: fns["e2e"](pm.parts, xs)),
                "single_kernel1_ms": t_single, "kernel_phase_launches": launched,
                "estimate": estimate_phase_costs(pm.plan, strategy, "spmv",
                                                 mesh_grid=use.grid, merge="flat"),
                "merge_wire": merge_wire_cost(strategy, use.grid, m_merge, "flat"),
                "merge_steps_flat": (plan_merge(strategy, use.grid, "flat").n_steps
                                     if strategy != "row" else 0)}

    def batched(pm, sr) -> None:
        """Kernels 1 and 2 over a [B, n] block on every device through
        make_distributed_batched_matvec; each row equals the unbatched call
        bit for bit."""
        n_in = pm.plan.shape[1]
        xb = torch.from_numpy(rng.uniform(0.5, 4.0, (b, n_in)).astype(np.float32)).to(dev)
        xb[:, n:] = 0
        live = torch.from_numpy(rng.random((b, n_in)) < 0.05).to(dev)
        for kernel, blk in (("spmv", xb), ("spmspv", torch.where(live, xb, 0.0))):
            xs = part.shard_tensor(pm.plan, blk, sr.zero, dim=1)
            fb = make_distributed_batched_matvec(mesh, pm, sr, "2d", kernel=kernel)
            f1 = make_distributed_matvec(mesh, pm, sr, "2d", kernel=kernel)
            singles = [xs[:, i].contiguous() for i in range(b)]
            before = dict(tally)
            ys = main_path(lambda: fb(pm.parts, xs))
            same(ys, torch.stack([f1(pm.parts, x1) for x1 in singles], dim=1),
                 f"batched {kernel}: a row differs from the unbatched call")
            # each device's block launch against its plain version, on the
            # block the batched Load gathers for it
            xfb = mesh.all_gather(vec_to_2d_layout(xs, pm.grid), "dr", dim=2)
            body = spmv_batch if kernel == "spmv" else spmspv_batch
            name = f"semiring_{kernel}_padded_batch"
            for g in range(d):
                a = part.device_part(pm.parts, g)
                held(name, body(a, xfb[g], sr), body(a, xfb[g], sr, impl="ref"), sr,
                     f"phase 16 batched {kernel} on device {g}")
            print(json.dumps({"phase": 16, "batched": kernel, "graph": "cit-HP",
                              "strategy": "2d", "B": b,
                              "launches": {k: tally[k] - before[k] for k in tally
                                           if tally[k] - before[k]},
                              "ms": time_ms(lambda: fb(pm.parts, xs), reps=5),
                              "seq_ms": time_ms(lambda: [f1(pm.parts, x1) for x1 in singles],
                                                reps=3)}))

    rng = np.random.default_rng(SEED + 16)
    n = cit.n
    vals_of = {s.name: edge_values(cit, s, weighted=s.name != "bool_or_and", seed=5)
               for s in (PLUS_TIMES, MIN_PLUS, BOOL_OR_AND)}
    stored, splits, sync_rows = [], [], []
    cfg_ref = {}

    # ------------------------------------------- cit-HP: strategy × balance
    for sr in (PLUS_TIMES, MIN_PLUS, BOOL_OR_AND):
        a = transposed(cit, sr, vals_of[sr.name])
        x_int = x_of(rng, sr, a.shape[1])
        x_sp = sparse(rng, sr, x_int, 0.05)
        x_sp[n:] = sr.zero
        y1 = ops.semiring_spmv(a, x_int, sr)[:n]
        y2 = ops.semiring_spmspv(a, frontier_from_dense(x_sp[:n], sr), sr)[:n]
        x_fl = x_of(rng, sr, a.shape[1], integer=False) if sr.name == "plus_times" else None
        y1f = ops.semiring_spmv(a, x_fl, sr)[:n] if x_fl is not None else None
        if sr.name == "bool_or_and":
            x_cfg = sparse(rng, sr, torch.ones(a.shape[1], dtype=torch.int32, device=dev), 0.05)
            x_cfg[n:] = 0
            cfg_ref["cit-HP"] = (x_cfg, ops.semiring_spmspv(
                a, frontier_from_dense(x_cfg[:n], sr), sr)[:n])
        t_single = time_ms(lambda: ops.semiring_spmv(a, x_int, sr))
        del a
        torch.cuda.empty_cache()
        for strategy, pgrid in strategies.items():
            for balance in ("rows", "nnz"):
                pm, build_s = partition_of(cit, sr, vals_of[sr.name], pgrid, balance)
                tag = f"{sr.name}/{strategy}/{balance}"
                stored.append({"graph": "cit-HP", "semiring": sr.name, "strategy": strategy,
                               "balance": balance, "tiles": list(pm.parts.tiles.shape),
                               "stored_bytes": pm.stored_bytes(), "build_s": build_s,
                               "imbalance": pm.plan.imbalance()})
                y = run_e2e(pm, sr, strategy, x_int, n)
                same(y, y1, f"{tag} spmv: not the single-device kernel 1")
                if y1f is not None:
                    yf = run_e2e(pm, sr, strategy, x_fl, n)
                    torch.testing.assert_close(yf, y1f, rtol=1e-5, atol=0,
                                               msg=lambda s: f"{tag} float x: {s}")
                ysp = run_e2e(pm, sr, strategy, x_sp, n, kernel="spmspv")
                same(ysp, y2, f"{tag} spmspv: not the single-device kernel 2")
                same(run_e2e(pm, sr, strategy, x_int, n, fused=True), y,
                     f"{tag} fused spmv: not the unfused bits")
                same(run_e2e(pm, sr, strategy, x_sp, n, kernel="spmspv", fused=True), ysp,
                     f"{tag} fused spmspv: not the unfused bits")
                if strategy != "row":
                    for topology, order in (("ring", "rc"), ("tree", "rc"), ("staged2d", "rc"),
                                            ("staged2d", "cr")):
                        if order == "cr" and strategy != "col":
                            continue
                        same(run_e2e(pm, sr, strategy, x_int, n, topology=topology,
                                     merge_order=order), y,
                             f"{tag} {topology}:{order}: not the flat merge's bits")
                for xk, kernel in ((x_int, "spmv"), (x_sp, "spmspv")):
                    for fused in (False, True):
                        hold_kernel_phase(pm, sr, strategy, xk, kernel, fused, tag=tag)
                if sr.name == "min_plus":
                    sync_rows.append({"strategy": strategy, "balance": balance,
                                      "syncs": sync_check(pm, sr, strategy, x_int, tag)})
                if sr.name == "plus_times":
                    splits.append(phase_split(pm, sr, strategy, balance, x_int, t_single))
                del pm
                torch.cuda.empty_cache()
        print(f"phase 16: cit-HP {sr.name}: row/col/2d × rows/nnz on {d} virtual devices "
              "equal the single-device kernels 1 and 2 (spmv, spmspv at 5%, fused); every "
              "topology equals the flat merge bit for bit")
    for row in stored:
        print(json.dumps({"phase": 16, "partition": row}))
    for row in splits:
        print(json.dumps({"phase": 16, "split": row}))
    for row in sync_rows:
        print(json.dumps({"phase": 16, "graph": "cit-HP", "semiring": "min_plus",
                          "syncs_in_a_warm_call": row}))

    # --------------------------------------------------- r-TX: row, 2d, col
    rtx_vals = edge_values(rtx, BOOL_OR_AND, weighted=False)
    sr = BOOL_OR_AND
    a = transposed(rtx, sr, rtx_vals)
    x_int = x_of(rng, sr, a.shape[1])
    x_sp = sparse(rng, sr, x_int, 0.05)
    x_sp[rtx.n:] = 0
    y1 = ops.semiring_spmv(a, x_int, sr)[:rtx.n]
    y2 = ops.semiring_spmspv(a, frontier_from_dense(x_sp[:rtx.n], sr), sr)[:rtx.n]
    x_cfg = sparse(rng, sr, torch.ones(a.shape[1], dtype=torch.int32, device=dev), 0.05)
    x_cfg[rtx.n:] = 0
    cfg_ref["r-TX"] = (x_cfg, ops.semiring_spmspv(a, frontier_from_dense(x_cfg[:rtx.n], sr),
                                                  sr)[:rtx.n])
    t_single = time_ms(lambda: ops.semiring_spmv(a, x_int, sr))
    del a
    torch.cuda.empty_cache()
    rtx_rows = []
    for strategy in ("row", "2d", "col"):
        pm, build_s = partition_of(rtx, sr, rtx_vals, strategies[strategy], "rows")
        y = run_e2e(pm, sr, strategy, x_int, rtx.n)
        same(y, y1, f"r-TX {strategy} spmv: not the single-device kernel 1")
        same(run_e2e(pm, sr, strategy, x_sp, rtx.n, kernel="spmspv"), y2,
             f"r-TX {strategy} spmspv: not the single-device kernel 2")
        same(run_e2e(pm, sr, strategy, x_sp, rtx.n, kernel="spmspv", fused=True), y2,
             f"r-TX {strategy} fused spmspv: not kernel 2")
        for xk, kernel, fused in ((x_int, "spmv", False), (x_sp, "spmspv", False),
                                  (x_sp, "spmspv", True)):
            hold_kernel_phase(pm, sr, strategy, xk, kernel, fused, tag=f"r-TX {strategy}")
        row = {"graph": "r-TX", "semiring": sr.name, "strategy": strategy, "balance": "rows",
               "tiles": list(pm.parts.tiles.shape), "stored_bytes": pm.stored_bytes(),
               "build_s": build_s, "imbalance": pm.plan.imbalance(),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        row.update(phase_split(pm, sr, strategy, "rows", x_int, t_single))
        rtx_rows.append(row)
        print(json.dumps({"phase": 16, "partition": row}))
        del pm
        torch.cuda.empty_cache()
    print(f"phase 16: r-TX {sr.name}: {', '.join(r['strategy'] for r in rtx_rows)} equal the "
          "single-device kernels 1 and 2")

    # ------------------------------------- the paper's config: CSC-2D, auto
    for g in (cit, rtx):
        x_cfg, ref_y = cfg_ref[g.name]
        pm, fn, choice = partitioned_matvec(g, BOOL_OR_AND, mesh, strategy="auto",
                                            topology="auto", kernel="spmspv", fmt=CONFIG.fmt,
                                            frontier_density=0.05)
        measured = {}
        for strategy in ("row", "col", "2d"):
            for balance in ("rows", "nnz"):
                pm_s, fn_s, ch = partitioned_matvec(
                    g, BOOL_OR_AND, mesh, strategy=f"{strategy}:{balance}", topology="auto",
                    kernel="spmspv", fmt=CONFIG.fmt, frontier_density=0.05)
                xs = part.shard_tensor(pm_s.plan, x_cfg[:pm_s.plan.shape[1]], 0)
                y = part.unshard_tensor(pm_s.plan, main_path(lambda: fn_s(pm_s.parts, xs)))
                same(y[:g.n], ref_y, f"{g.name} config {strategy}:{balance}: not kernel 2")
                measured[f"{strategy}:{balance}"] = {
                    "ms": time_ms(lambda: fn_s(pm_s.parts, xs), reps=5),
                    "merge": ch.merge, "merge_order": ch.merge_order,
                    "estimate_total": ch.costs[(strategy, balance)]["total"]}
                del pm_s, fn_s
                torch.cuda.empty_cache()
        picked = f"{choice.strategy}:{choice.balance}"
        fastest = min(measured, key=lambda k: measured[k]["ms"])
        print(json.dumps({"phase": 16, "config": "alpha_pim_graph", "graph": g.name,
                          "fmt": CONFIG.fmt, "kernel": "spmspv", "density": 0.05,
                          "planner": picked, "planner_merge": choice.merge,
                          "planner_ms": measured[picked]["ms"], "fastest": fastest,
                          "fastest_ms": measured[fastest]["ms"], "measured": measured}))
        del pm, fn
        torch.cuda.empty_cache()

    # ------------------------------- the pipeline: 20 rank updates, 2d/rows
    n_pad = -(-n // (128 * d)) * (128 * d)             # square: input chunks = output chunks
    pipe = {}
    for sr, vals in ((PLUS_TIMES, edge_values(cit, PLUS_TIMES, weighted=False, normalize=True)),
                     (MIN_PLUS, vals_of["min_plus"])):
        a = transposed(cit, sr, vals, shape=(n_pad, n_pad))
        if sr.name == "plus_times":
            x0 = torch.full((n_pad,), 1.0 / n, dtype=torch.float32, device=dev)
            x0[n:] = 0
        else:
            x0 = torch.full((n_pad,), float("inf"), device=dev)
            x0[torch.from_numpy(rng.choice(n, 64, replace=False)).to(dev)] = 0.0
        y_single = x0
        for _ in range(pipe_iters):
            y_single = ops.semiring_spmv(a, y_single, sr)
        del a
        torch.cuda.empty_cache()
        pm, _ = partition_of(cit, sr, vals, grid, "rows", shape=(n_pad, n_pad))
        check(pm.plan.in_per == pm.plan.out_per, "pipeline partition is not chainable")
        fns = build_phase_fns(mesh, pm, sr, "2d", "spmv")
        xs0 = part.shard_tensor(pm.plan, x0, sr.zero)
        walls = {}
        outs = {}
        for depth in (0, 2, 0, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = main_path(lambda: iterate_phases(fns, pm.parts, xs0, pipe_iters, depth=depth))
            walls.setdefault(depth, []).append((time.perf_counter() - t0) * 1e3)
            outs[depth] = out
        same(outs[0], outs[2], f"pipeline {sr.name}: depth 0 and depth 2 differ")
        y_d = part.unshard_tensor(pm.plan, outs[0])
        if sr.name == "plus_times":
            # 20 chained steps, each folding in another order than the single
            # device: within rtol 1e-4 (not bit for bit)
            torch.testing.assert_close(y_d, y_single, rtol=1e-4, atol=1e-12,
                                       msg=lambda s: f"pipeline plus_times: {s}")
            rel = ((y_d - y_single).abs() / y_single.abs().clamp_min(1e-30)).max()
        else:
            same(y_d, y_single, "pipeline min_plus: not 20 single-device kernel-1 steps")
            rel = torch.zeros(())
        xf = fns["load"](pm.parts, xs0)
        ys = fns["kernel"](pm.parts, xs0, xf)
        per_phase = {"load": reads(lambda: fns["load"](pm.parts, xs0)),
                     "kernel": reads(lambda: fns["kernel"](pm.parts, xs0, xf)),
                     "retrieve_merge": reads(lambda: fns["retrieve_merge"](pm.parts, ys))}
        per_iter = reads(lambda: iterate_phases(fns, pm.parts, xs0, pipe_iters, depth=2))
        step_syncs = {}
        for topology in ("flat", "ring", "tree", "staged2d"):
            fns_t = build_phase_fns(mesh, pm, sr, "2d", "spmv", topology=topology)
            run_phases_once(fns_t, pm.parts, xs0)
            step_syncs[topology] = syncs(lambda: run_phases_once(fns_t, pm.parts, xs0))
        check(not any(step_syncs.values()),
              f"pipeline {sr.name}: a phase step synchronised: {step_syncs}")
        ring = build_phase_fns(mesh, pm, sr, "2d", "spmv", topology="ring")
        pipe[sr.name] = {"iters": pipe_iters, "depth0_ms": walls[0], "depth2_ms": walls[2],
                         "max_rel_err_vs_single": float(rel),
                         "host_reads_per_phase": per_phase,
                         "host_reads_per_iteration": per_iter / pipe_iters,
                         "syncs_per_phase_step": step_syncs,
                         "syncs_depth2_ring": syncs(lambda: iterate_phases(
                             ring, pm.parts, xs0, pipe_iters, depth=2))}
        print(json.dumps({"phase": 16, "pipeline": sr.name, "graph": "cit-HP",
                          "strategy": "2d", "balance": "rows", "n_pad": n_pad,
                          **pipe[sr.name]}))
        if sr.name == "plus_times":
            batched(pm, sr)
        del pm, fns
        torch.cuda.empty_cache()

    # ----------------------------------------------------- SpGEMM on ca-Q
    spgemm_rows = []
    for sr, bvals in ((PLUS_AND, "01"), (PLUS_TIMES, "int")):
        vals = np.ones(caq.nnz, np.int32 if sr.dtype == torch.int32 else np.float32)
        a = transposed(caq, sr, vals, block=(64, 64))
        kn = caq.n
        bmat = (torch.from_numpy(rng.random((a.shape[1], kn)) < 0.3).to(dev).to(sr.dtype)
                if bvals == "01" else
                torch.from_numpy(rng.integers(0, 4, (a.shape[1], kn)).astype(np.float32)).to(dev))
        bmat[caq.n:] = 0
        mask = torch.from_numpy(rng.random((caq.n, kn)) < 0.4).to(dev).to(sr.dtype)
        want = spgemm_masked(a, bmat, sr)[:caq.n]
        want_m = torch.where(mask != 0, want, torch.zeros((), dtype=sr.dtype, device=dev))
        t_single = time_ms(lambda: spgemm_masked(a, bmat, sr), reps=3)
        del a
        torch.cuda.empty_cache()
        for strategy, pgrid in strategies.items():
            pm, _ = partition_of(caq, sr, vals, pgrid, "rows", block=(64, 64))
            bs = part.shard_tensor(pm.plan, bmat[:caq.n], sr.one)
            ms = part.shard_tensor(pm.plan, mask, sr.zero, side="output")
            fn = make_distributed_spgemm(mesh, pm, sr, strategy)
            before = dict(tally)
            c = part.unshard_tensor(pm.plan, main_path(lambda: fn(pm.parts, bs)))
            same(c, want, f"ca-Q spgemm {sr.name}/{strategy}: not the single-device front door")
            cm = part.unshard_tensor(pm.plan, main_path(lambda: fn(pm.parts, bs, ms)))
            same(cm, want_m, f"ca-Q masked spgemm {sr.name}/{strategy}")
            # each device's launch (the front door picks 6 or 6b) against
            # that kernel's plain version, on B as the Load leaves it there
            bf = {"row": lambda: mesh.all_gather(bs, ("dr", "dc")), "col": lambda: bs,
                  "2d": lambda: mesh.all_gather(vec_to_2d_layout(bs, pm.grid), "dr")}[strategy]()
            for g in range(d):
                a = part.device_part(pm.parts, g)
                n6b = kern["semiring_spgemm_binary"].launches
                y = spgemm_masked(a, bf[g], sr)
                bp, mk, meta, bn, ncol = ops._spgemm_operands(a, bf[g], sr, None)
                if kern["semiring_spgemm_binary"].launches > n6b:
                    name, y_plain = "semiring_spgemm_binary", ref.spgemm_binary_ref(
                        a.tiles, meta, bp, mk, sr, bn)
                else:
                    name, y_plain = "semiring_spgemm_padded", ref.spgemm_padded_ref(
                        a.tiles, meta, bp, mk, sr, bn)
                held(name, y, y_plain[:, :ncol], sr, f"phase 16 ca-Q {strategy} {name} on "
                                                     f"device {g}")
            row = {"graph": "ca-Q", "semiring": sr.name, "B": bvals, "strategy": strategy,
                   "tiles": list(pm.parts.tiles.shape),
                   "launches": {k: tally[k] - before[k] for k in
                                ("semiring_spgemm_padded", "semiring_spgemm_binary")},
                   "ms": time_ms(lambda: fn(pm.parts, bs), reps=3), "single_ms": t_single,
                   "host_reads": reads(lambda: fn(pm.parts, bs))}
            spgemm_rows.append(row)
            print(json.dumps({"phase": 16, "spgemm": row}))
            del pm, bs, ms, c, cm
            torch.cuda.empty_cache()
    check(all(r["launches"]["semiring_spgemm_binary"] == 2 * d for r in spgemm_rows
              if r["B"] == "01"), "0/1 ⟨+,∧⟩ did not take kernel 6b on every device")
    check(all(r["launches"]["semiring_spgemm_padded"] == 2 * d for r in spgemm_rows
              if r["B"] == "int"), "⟨+,×⟩ did not take kernel 6 on every device")
    print("phase 16: ca-Q SpGEMM row/col/2d equals the single-device front door "
          "(0/1 ⟨+,∧⟩ on kernel 6b, ⟨+,×⟩ on kernel 6), masked and unmasked")

    # ------------------------------------------------ one row at D = R·C big
    sr = PLUS_TIMES
    a = transposed(cit, sr, vals_of["plus_times"])
    x_int = x_of(rng, sr, a.shape[1])
    y1 = ops.semiring_spmv(a, x_int, sr)[:n]
    t_single = time_ms(lambda: ops.semiring_spmv(a, x_int, sr))
    del a
    torch.cuda.empty_cache()
    big = Mesh(grid_big, device=dev)
    pm, build_s = partition_of(cit, sr, vals_of["plus_times"], grid_big, "rows")
    same(run_e2e(pm, sr, "2d", x_int, n, m=big), y1, "D=64 2d: not the single-device kernel 1")
    hold_kernel_phase(pm, sr, "2d", x_int, "spmv", m=big, tag="D=64")
    row = {"graph": "cit-HP", "semiring": sr.name, "strategy": "2d", "balance": "rows",
           "grid": list(grid_big), "tiles": list(pm.parts.tiles.shape),
           "stored_bytes": pm.stored_bytes(), "build_s": build_s}
    row.update(phase_split(pm, sr, "2d", "rows", x_int, t_single, m=big))
    print(json.dumps({"phase": 16, "partition": row}))
    del pm
    torch.cuda.empty_cache()

    peak = torch.cuda.max_memory_allocated()
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s, peak memory {peak} bytes, "
          f"launches in the distributed calls {json.dumps(tally)}")
    print(json.dumps({"phase": 16, "plain_max_abs_err_on_the_parts": errs}))
    for k in ("semiring_spmv_padded", "semiring_spmspv_padded", "semiring_spmv_fused_padded",
              "semiring_spmspv_fused_padded", "semiring_spmv_padded_batch",
              "semiring_spmspv_padded_batch", "semiring_spgemm_padded", "semiring_spgemm_binary"):
        check(tally[k] > 0, f"{k} was not launched through the mesh in phase 16")
        check(k in errs, f"{k} was not held to its plain version on the mesh's parts")
    return tally, errs


def serve_workload(g, n: int, seed: int) -> list:
    """``n`` traversal queries (bfs/sssp/ppr in equal shares) on ``g``:
    70% distinct (algorithm, source) pairs, the rest repeats of them, in a
    seeded order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_distinct = int(round(0.7 * n))
    sources = rng.choice(g.n, n_distinct, replace=False)
    pairs = [(SERVE_ALGS[i % 3], int(s)) for i, s in enumerate(sources)]
    pairs += [pairs[int(i)] for i in rng.integers(0, n_distinct, n - n_distinct)]
    return [pairs[int(i)] for i in rng.permutation(n)]


def serve_checksum(payloads) -> str:
    """sha1 of integer-exact payload arrays (unreached as -1)."""
    import hashlib

    import numpy as np

    h = hashlib.sha1()
    for a in payloads:
        a = np.asarray(a, np.float64)
        h.update(np.where(np.isfinite(a), a, -1.0).astype(np.int64).tobytes())
    return h.hexdigest()[:12]


def ppr_reference_block(g, sources, alpha: float = 0.85, iters: int = 64) -> "np.ndarray":
    """``ppr_reference(..., sparse=True)`` for many sources at once: the same
    float64 power iteration on the columns of one [n, B] block, each column
    stopped where its own L1 change first drops to 1e-6. Returns [B, n]."""
    import numpy as np
    import scipy.sparse as sp

    deg = np.maximum(np.bincount(g.rows, minlength=g.n), 1).astype(np.float64)
    p = sp.csr_matrix((1.0 / deg[g.rows], (g.cols, g.rows)), shape=(g.n, g.n))
    e = np.zeros((g.n, len(sources)))
    e[sources, np.arange(len(sources))] = 1.0
    r, live = e.copy(), np.ones(len(sources), bool)
    for _ in range(iters):
        r_new = (1 - alpha) * e[:, live] + alpha * (p @ r[:, live])
        done = np.abs(r_new - r[:, live]).sum(axis=0) <= 1e-6
        r[:, live] = r_new
        live[np.flatnonzero(live)[done]] = False
        if not live.any():
            break
    return r.T


def serve_phases(torch, dev, cit, rtx, oracles, all_kernels, n_queries: int = SERVE_QUERIES,
                 n_thread_queries: int = SERVE_THREAD_QUERIES, sample: int = SERVE_SAMPLE,
                 loads=SERVE_LOADS) -> dict:
    """Phase 17: graph serving through ``repro_torch.serve.graph_engine``.
    One AsyncGraphServer on a FakeClock hosts cit-HP and r-TX (batch 32,
    the JAX defaults otherwise: csr/csc engines, max_iters 64 (r-TX's
    traversals 32 in the open loop and the threaded run), pipeline depth
    2, strategy "auto"). Open loop as ``benchmarks/slo_openloop.py``
    runs it: the deep-backlog capacity, then Poisson arrivals of the
    workload, repeated ``SERVE_OPEN_REPEATS`` times (by tenant), at each of ``loads`` ×
    capacity, each flush consuming simulated time equal to its wall, every
    query due two mixed windows after its arrival. Then the whole-graph
    kinds with the cache on, a mutate of cit-HP, one traced window against
    the same window untraced, and a threaded run on the system clock.
    ``oracles`` holds phase 10's cit-HP answers (cc, kcore, triangles,
    pagerank). Every served traversal is held to the port's single-source
    run on the same engine; on cit-HP a sample is also held to the bsr
    engines' batched runs and the scipy oracles. Returns the block
    kernels' launches in those batched runs."""
    import threading

    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.delta import EdgeDelta
    from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES
    from repro_torch.graphs import (
        bfs, bfs_multi, build_engine, kcore_reference, pagerank_reference, ppr, ppr_multi,
        sssp, sssp_multi, trained_stump,
    )
    from repro_torch.graphs.engine import edge_values
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import percentile_exact
    from repro_torch.serve import AsyncGraphServer, FakeClock, GraphQueryServer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    split, t_lap = {}, [t_phase]

    def lap(part: str) -> None:
        """Seconds since the previous lap, under ``part``."""
        now = time.perf_counter()
        split[part] = now - t_lap[0]
        t_lap[0] = now

    graphs = {"cit-HP": cit, "r-TX": rtx}
    work = {name: serve_workload(g, n_queries, 17 + i) for i, (name, g) in enumerate(graphs.items())}
    field = {"bfs": "levels", "sssp": "dist", "ppr": "rank"}
    server_kw = {"batch_size": SERVE_BATCH, "device": dev}
    # the traversals' depth by tenant in the open loop's and the threaded
    # servers (the globals' server keeps the default, 64)
    served_kw = {"cit-HP": {}, "r-TX": {"max_iters": SERVE_RTX_ITERS}}
    stump = trained_stump()
    answers: dict = {}          # (tenant, algorithm, source) -> the first payload served
    ppr_bits = {"same": 0, "close": 0}

    def hold(tenant, alg, src, payload, want, what: str) -> None:
        """bfs/sssp exact (values and iterations); ppr within rtol 1e-3, atol
        1e-6, its iterations within one (the ⟨+,×⟩ CSR reduce sums with
        atomics on the card, so the tol crossing may move)."""
        got = payload[field[alg]]
        if alg == "ppr":
            np.testing.assert_allclose(got, want[field[alg]], rtol=1e-3, atol=1e-6,
                                       err_msg=f"{what}: {tenant} ppr/{src}")
            check(abs(payload["iterations"] - want["iterations"]) <= 1,
                  f"{what}: {tenant} ppr/{src} iterations {payload['iterations']} against "
                  f"{want['iterations']}")
            ppr_bits["same" if np.array_equal(got, want[field[alg]]) else "close"] += 1
        else:
            check(np.array_equal(got, want[field[alg]]) and got.dtype == want[field[alg]].dtype,
                  f"{what}: {tenant} {alg}/{src} differs")
            check(payload["iterations"] == want["iterations"],
                  f"{what}: {tenant} {alg}/{src} iterations differ")

    def record(tenant, tickets, what: str) -> None:
        for tk in tickets:
            check(tk.done() and tk.result is not None, f"{what}: ticket {tk.request_id} unresolved")
            key = (tenant, tk.algorithm, tk.source)
            if key in answers:
                hold(tenant, tk.algorithm, tk.source, tk.result, answers[key], what)
            else:
                answers[key] = tk.result

    def timed_flushes(srv, clock) -> None:
        """Each tenant's flush consumes simulated time equal to its wall,
        which ends in the host pull of its last bucket."""
        for name in graphs:
            server = srv.tenant(name)
            orig = server.flush

            def flush(orig=orig):
                t0 = time.perf_counter()
                out = orig()
                clock.advance(time.perf_counter() - t0)
                return out
            server.flush = flush

    def fake_server(max_wait: float, cache_capacity: int = 0, warm: bool = True,
                    tenant_kw: dict | None = None):
        clock = FakeClock()
        srv = AsyncGraphServer(clock=clock, max_pending=1 << 16, max_wait=max_wait,
                               cache_capacity=cache_capacity)
        for name, g in graphs.items():
            srv.add_tenant(name, g, **server_kw, **(tenant_kw or {}).get(name, {}))
        timed_flushes(srv, clock)
        t0 = time.perf_counter()
        for name in graphs if warm else ():  # builds every traversal engine, no deadline
            tks = [srv.submit(name, a, 0) for a in SERVE_ALGS]
            srv.drain(name)
            record(name, tks, "warm-up")
            for a in SERVE_ALGS:
                check(srv.tenant(name).engine(a).device.type == dev.type,
                      f"{name} {a} engine is not on {dev}")
        return srv, clock, time.perf_counter() - t0

    for k in all_kernels:
        k.launches = 0
    # ---------------------------------------------------------------- capacity
    # One server for the capacity and open-loop runs. Its windows are
    # eager (max_wait 0): a window is due when it opens and holds what
    # arrived while the previous flush ran. A timer window that times out
    # partial costs as much as a full one (one bucket per algorithm), which
    # made the lowest load miss more deadlines than the highest.
    ol, clock, build_s = fake_server(0.0, tenant_kw=served_kw)
    sched = ol.scheduler
    # the deep backlog drained as one window; its spans time each bucket:
    # the runner's issue (the traversal, which syncs every level) plus its
    # materialize (the host pull). Drained twice after a collection, the
    # faster kept: a host stall only slows a drain, and one of 1.6 s (cit-HP
    # at 134 queries/s, its buckets 0.3 s of the 1.9 s timed) put every load
    # of the open loop below the true capacity, so no load missed
    capacity, bucket_wall, window_wall = {}, {}, {}
    for name in graphs:
        drains = []
        for _ in range(2):
            gc.collect()
            with trace.tracing() as tracer:
                t0 = time.perf_counter()
                tks = [ol.submit(name, a, s) for a, s in work[name]]
                ol.drain(name)
                drains.append((time.perf_counter() - t0, tracer))
            record(name, tks, "capacity")
        wall, tracer = min(drains, key=lambda d: d[0])
        capacity[name] = len(tks) / wall
        by_t0 = lambda spans: sorted(spans, key=lambda s: s.t0)  # noqa: E731
        issues, mats, pulls = (by_t0(tracer.filter(p)) for p in (
            "pipeline/issue", "pipeline/materialize", "serve/bucket_compute"))
        check(len(issues) == len(mats) == len(pulls) > 0, f"{name}: unpaired bucket spans")
        walls = [(p.attrs["algorithm"], i.duration + m.duration)
                 for i, m, p in zip(issues, mats, pulls)]
        bucket_wall[name] = statistics.median(w for _, w in walls)
        # a window of mixed queries runs one bucket of each algorithm
        window_wall[name] = sum(statistics.median(w for b, w in walls if b == a)
                                for a in SERVE_ALGS)
        print(json.dumps({"phase": 17, "tenant": name, "capacity_qps": capacity[name],
                          "buckets": len(walls), "bucket_wall_ms_median": bucket_wall[name] * 1e3,
                          "bucket_wall_ms": [[a, w * 1e3] for a, w in walls],
                          "window_wall_ms": window_wall[name] * 1e3, "set_up_s": build_s}))
    lap("set_up_and_capacity")
    served_launches = {k.__name__: k.launches for k in all_kernels}
    print(f"phase 17: hand-written kernel launches on the served path (csr/csc engines) "
          f"{json.dumps(served_launches)}")

    # every served (algorithm, source) against the single-source run on the
    # tenant's own engine and max_iters
    t0 = time.perf_counter()
    n_single = 0
    for (name, alg, src), payload in answers.items():
        server = ol.tenant(name)
        eng = server.engine(alg)
        if alg == "bfs":
            r = bfs(eng, src, max_iters=server.max_iters)
            want = {"levels": r.levels.cpu().numpy(), "iterations": r.iterations}
        elif alg == "sssp":
            r = sssp(eng, src, max_iters=server.max_iters)
            want = {"dist": r.dist.cpu().numpy(), "iterations": r.iterations}
        else:
            r = ppr(eng, src, alpha=server.alpha, max_iters=server.max_iters)
            want = {"rank": r.rank.cpu().numpy(), "iterations": r.iterations}
        hold(name, alg, src, payload, want, "single-source")
        n_single += 1
    single_s = time.perf_counter() - t0
    lap("single_source")
    print(f"phase 17: {n_single} served (tenant, algorithm, source) answers equal the "
          f"single-source runs on the same csr/csc engines ({single_s:.1f} s)")

    # cit-HP sample: bsr engines' batched runs (kernels 1b and 2b) and scipy
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    block_tally = {k.__name__: 0 for k in (semiring_spmv_padded_batch,
                                           semiring_spmspv_padded_batch)}
    w_keyed = edge_values(cit, MIN_PLUS, weighted=True, seed=5, content_keyed=True)
    for alg, sr, kw in (("bfs", BOOL_OR_AND, {}),
                        ("sssp", MIN_PLUS, {"weighted": True, "seed": 5, "content_keyed": True}),
                        ("ppr", PLUS_TIMES, {"normalize": True})):
        pool = sorted({s for a, s in work["cit-HP"] if a == alg})
        srcs = [int(s) for s in rng.choice(pool, min(sample, len(pool)), replace=False)]
        eng = build_engine(cit, sr, stump, fmt_spmv="bsr", fmt_spmspv="bsr", device=dev, **kw)
        for k in all_kernels:
            k.launches = 0
        if alg == "bfs":
            res = bfs_multi(eng, srcs, max_iters=64)
        elif alg == "sssp":
            res = sssp_multi(eng, srcs, max_iters=64)
        else:
            res = ppr_multi(eng, srcs, max_iters=64)
        torch.cuda.synchronize()
        for k in (semiring_spmv_padded_batch, semiring_spmspv_padded_batch):
            block_tally[k.__name__] += k.launches
        check(int(res.iterations.max()) < 64, f"cit-HP {alg} sample hit max_iters")
        rows = getattr(res, field[alg]).cpu().numpy()
        iters = res.iterations.cpu().numpy()
        if alg == "ppr":
            want = ppr_reference_block(cit, srcs)
            for i, s in enumerate(srcs):
                hold("cit-HP", alg, s, {"rank": rows[i], "iterations": int(iters[i])},
                     answers[("cit-HP", alg, s)], "bsr ppr_multi")
                np.testing.assert_allclose(rows[i], want[i], rtol=1e-3, atol=1e-6,
                                           err_msg=f"cit-HP ppr/{s} against the oracle")
        else:
            for i, s in enumerate(srcs):
                hold("cit-HP", alg, s, {field[alg]: rows[i], "iterations": int(iters[i])},
                     answers[("cit-HP", alg, s)], f"bsr {alg}_multi")
            weights = np.ones(cit.nnz) if alg == "bfs" else w_keyed
            dist = csgraph.dijkstra(sp.csr_matrix((weights, (cit.rows, cit.cols)),
                                                  shape=(cit.n, cit.n)), indices=srcs)
            if alg == "bfs":
                want = np.where(np.isfinite(dist), dist, -1).astype(np.int32)
            else:
                want = dist.astype(np.float32)
            check(np.array_equal(rows, want), f"cit-HP {alg} sample differs from scipy")
        del eng, res
        torch.cuda.empty_cache()
    for name, count in block_tally.items():
        check(count > 0, f"{name} was not launched by the bsr cross-check")
    lap("bsr_and_scipy")
    print(f"phase 17: cit-HP, {sample} sources per algorithm: served answers equal "
          f"bfs/sssp/ppr_multi on the bsr engines and the scipy oracles "
          f"({time.perf_counter() - t0:.1f} s; block launches {json.dumps(block_tally)})")

    # ---------------------------------------------------------------- open loop
    # A query at light load waits for at most the window in flight and
    # then its own: the budget is two mixed windows. Each load's stream is
    # the workload repeated (every answer stays held to the single-source
    # runs), long enough that at 2x the backlog outgrows the budget.
    budget = {name: 2 * window_wall[name] for name in graphs}
    curves = {}
    for name in graphs:
        queries = work[name] * SERVE_OPEN_REPEATS[name]
        gaps = np.random.default_rng(SEED).exponential(1.0, len(queries))
        curves[name] = {}
        for mult in loads:
            slo0 = ol.stats(name)["slo"]
            h0 = ol.stats(name)["latency"]["bucket_s"]
            rate = mult * capacity[name]
            arrivals = clock.now() + np.cumsum(gaps / rate)
            tickets, i = [], 0
            while i < len(queries) or sched.pending() > 0:
                due = sched.next_wakeup()
                if i < len(queries) and (due is None or arrivals[i] <= due):
                    if arrivals[i] > clock.now():
                        clock.advance(arrivals[i] - clock.now())
                    alg, src = queries[i]
                    tickets.append(ol.submit(name, alg, src, deadline=float(
                        arrivals[i] + budget[name] - clock.now())))
                    i += 1
                else:
                    if due > clock.now():
                        clock.advance(due - clock.now())
                    ol.poll()
            record(name, tickets, f"open loop {mult}x")
            st = ol.stats(name)
            slo, h1 = st["slo"], st["latency"]["bucket_s"]
            check(slo["admitted"] == slo["dispatched"] + slo["pending"] + slo["abandoned"],
                  f"{name} {mult}x: admission not conserved {slo}")
            check(slo["goodput"] + slo["deadline_misses"] + slo["no_deadline"] == slo["resolved"],
                  f"{name} {mult}x: resolutions not conserved {slo}")
            check(slo["pending"] == 0 and slo["resolved"] == slo["dispatched"],
                  f"{name} {mult}x: unresolved tickets {slo}")
            misses = slo["deadline_misses"] - slo0["deadline_misses"]
            oracle = sum(1 for tk in tickets if tk.slack() < 0)
            check(misses == oracle, f"{name} {mult}x: {misses} misses against the slack "
                                    f"oracle's {oracle}")
            lat = [tk.resolved_at - a for tk, a in zip(tickets, arrivals)]
            n_b = h1["count"] - h0.get("count", 0)
            mean_b = (h1["mean"] * h1["count"] - h0.get("mean", 0.0) * h0.get("count", 0)) / n_b
            csum = {a: serve_checksum(tk.result[field[a]] for tk in tickets if tk.algorithm == a)
                    for a in ("bfs", "sssp")}
            row = {"phase": 17, "tenant": name, "load_x": mult, "queries": len(tickets),
                   "offered_qps": rate,
                   "achieved_qps": len(tickets) / (max(tk.resolved_at for tk in tickets)
                                                   - arrivals[0]),
                   "p50_ms": percentile_exact(lat, 0.5) * 1e3,
                   "p99_ms": percentile_exact(lat, 0.99) * 1e3,
                   "miss_rate": misses / len(tickets), "misses": misses,
                   "budget_ms": budget[name] * 1e3,
                   "windows": len({tk.window_id for tk in tickets}),
                   "buckets": n_b, "bucket_s_mean": mean_b, "checksums": csum}
            curves[name][mult] = row
            print(json.dumps(row))
        # the highest load misses more than the lowest, and each step up in
        # load loses at most 0.1 (benchmarks/slo_openloop.py's slack)
        rates = [curves[name][m]["miss_rate"] for m in loads]
        check(rates[-1] > rates[0] and all(a <= b + 0.1 for a, b in zip(rates, rates[1:])),
              f"{name}: the miss rate does not rise with the load: {rates}")
        sums = {json.dumps(curves[name][m]["checksums"]) for m in loads}
        check(len(sums) == 1, f"{name}: bfs/sssp checksums differ across loads: {sums}")

    lap("open_loop")
    # host syncs per flush: one window per tenant under the profiler
    for name in graphs:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tks = [ol.submit(name, a, s) for a, s in work[name][:SERVE_BATCH]]
            ol.drain(name)
        record(name, tks, "profiled window")
        reads = sum(e.count for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")
        print(json.dumps({"phase": 17, "tenant": name, "flushes": 1,
                          "buckets": len({t.algorithm for t in tks}),
                          "host_syncs_per_flush": reads}))

    # one traced window against the same window untraced
    window = work["cit-HP"][:SERVE_BATCH]
    tks = [ol.submit("cit-HP", a, s) for a, s in window]
    ol.drain("cit-HP")
    with trace.tracing() as tr:
        traced = [ol.submit("cit-HP", a, s) for a, s in window]
        ol.drain("cit-HP")
    for a, b in zip(tks, traced):
        check(a.result.keys() == b.result.keys(), "traced payload keys differ")
        if a.algorithm == "ppr":
            hold("cit-HP", "ppr", a.source, b.result, a.result, "traced window")
            np.testing.assert_allclose(b.result["residual"], a.result["residual"], rtol=1e-3,
                                       atol=1e-6)
            continue
        for k in a.result:
            check(np.array_equal(a.result[k], b.result[k]),
                  f"traced {a.algorithm}/{a.source} {k} differs from untraced")
    spans = tr.filter("serve/")
    wid = traced[0].window_id
    check(spans and all(s.attrs.get("window_id") == wid for s in spans),
          "a serve/* span lacks the window_id")
    print(json.dumps({"phase": 17, "traced_window": wid, "serve_spans": len(spans),
                      "span_names": sorted({s.name for s in spans}),
                      "bucket_compute_ms": sum(s.duration for s in tr.filter(
                          "serve/bucket_compute")) * 1e3}))
    del ol
    torch.cuda.empty_cache()
    lap("profile_and_trace")

    # ---------------------------------------------------------------- globals, mutate
    gs, _, _ = fake_server(0.0, cache_capacity=4096, warm=False)
    globals_run = {"cit-HP": ("pagerank", "cc", "kcore", "triangles"),
                   "r-TX": ("pagerank", "kcore")}
    rtx_oracles = {"kcore": kcore_reference(rtx.rows, rtx.cols, rtx.n),
                   "pagerank": pagerank_reference(rtx.rows, rtx.cols, rtx.n, iters=64,
                                                  sparse=True)}
    for name, algs in globals_run.items():
        want = oracles if name == "cit-HP" else rtx_oracles
        for alg in algs:
            runs0 = gs.stats(name)["global_runs"]
            t0 = time.perf_counter()
            tks = [gs.submit(name, alg) for _ in range(4)]
            gs.drain(name)
            wall_ms = (time.perf_counter() - t0) * 1e3
            check(gs.stats(name)["global_runs"] == runs0 + 1, f"{name} {alg} ran more than once")
            check(sum(tk.cached for tk in tks) == 3, f"{name} {alg}: three askers not cached")
            p = tks[0].result
            if alg == "pagerank":
                np.testing.assert_allclose(p["rank"], want["pagerank"], rtol=1e-3, atol=1e-6,
                                           err_msg=f"{name} pagerank")
            elif alg == "cc":
                check(np.array_equal(p["labels"], want["cc"]), f"{name} CC labels differ")
            elif alg == "kcore":
                check(np.array_equal(p["coreness"], want["kcore"]), f"{name} coreness differs")
            else:
                check(p["total"] == want["triangles"], f"{name} triangle total differs")
            print(json.dumps({"phase": 17, "tenant": name, "global": alg, "wall_ms": wall_ms,
                              "iterations": p["iterations"]}))

    lap("globals")
    # the cit-HP workload with the cache on, then the grow delta
    t0 = time.perf_counter()
    tks = [gs.submit("cit-HP", a, s) for a, s in work["cit-HP"]]
    gs.drain("cit-HP")
    record("cit-HP", tks, "cached run")
    st = gs.stats("cit-HP")
    distinct = set(work["cit-HP"])
    entries = len(distinct) + len(globals_run["cit-HP"])
    check(len(gs.cache) == entries + len(globals_run["r-TX"]),
          f"the LRU holds {len(gs.cache)} entries, expected {entries} + 2")
    delta = graph_deltas(cit, EdgeDelta)[0][1]
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    report = gs.mutate("cit-HP", delta)
    mutate_ms = (time.perf_counter() - t0) * 1e3
    mem_after = torch.cuda.memory_allocated()
    check(report["retained"] + report["invalidated"] == entries,
          f"mutate: retained + invalidated = {report['retained'] + report['invalidated']}, "
          f"entries before = {entries}")
    check(mem_after < mem_before or dev.type == "cpu",
          f"mutate kept the old snapshot's engines: {mem_after} >= {mem_before} bytes")
    again = [gs.submit("cit-HP", a, s) for a, s in sorted(distinct)]
    gs.drain("cit-HP")
    cold = GraphQueryServer(gs.tenant("cit-HP").graph, cache_capacity=0, **server_kw)
    reqs = [cold.submit(a, s) for a, s in sorted(distinct)]
    cold.flush()
    for tk, rq in zip(again, reqs):
        hold("cit-HP", tk.algorithm, tk.source, tk.result, rq.result,
             "after the mutate (cold run on the new snapshot)")
    retained_hits = sum(tk.cached for tk in again)
    check(retained_hits == report["retained"],
          f"{retained_hits} re-asks hit the cache, {report['retained']} entries retained")
    print(json.dumps({"phase": 17, "mutate": "cit-HP grow", "mutate_ms": mutate_ms, **report,
                      "entries_before": entries, "lru_hit_rate": st["latency"]["lru_hit_rate"],
                      "cache": st["cache"], "memory_before": mem_before,
                      "memory_after": mem_after}))
    del gs, cold
    torch.cuda.empty_cache()
    lap("mutate")

    # ---------------------------------------------------------------- threads
    ts = AsyncGraphServer(max_pending=4096, max_wait=0.005, cache_capacity=0)
    for name, g in graphs.items():
        ts.add_tenant(name, g, **server_kw, **served_kw[name])
    got: dict = {}
    errors: list = []

    def submitter(tid):
        name = list(graphs)[tid % 2]
        half = work[name][:n_thread_queries][tid // 2::2]
        try:
            got[tid] = (name, [ts.submit(name, a, s) for a, s in half])
        except Exception as e:         # reported below; the run fails
            errors.append(e)

    t0 = time.perf_counter()
    ts.start()
    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), "a submitter thread hung")
    check(not errors, f"submitters failed: {errors[:2]}")
    try:
        for name, tks in got.values():
            for tk in tks:
                tk.wait(timeout=120)
    except TimeoutError as e:
        ts.close()
        check(False, f"threaded run: {e}")
    thread_s = time.perf_counter() - t0
    ts.close()
    check(ts._thread is None, "the loop thread outlived close()")
    sched_st = ts.scheduler.stats()
    check(sched_st["pending"] == 0 and sched_st["admitted"] == sched_st["dispatched"]
          == 2 * n_thread_queries, f"threaded run lost tickets: {sched_st}")
    for name, tks in got.values():
        record(name, tks, "threaded run")
    print(json.dumps({"phase": 17, "threaded_wall_s": thread_s, "queries": 2 * n_thread_queries,
                      "windows": len({tk.window_id for _, tks in got.values() for tk in tks}),
                      "ppr_bit_identical": ppr_bits["same"], "ppr_within_tol": ppr_bits["close"]}))
    del ts
    torch.cuda.empty_cache()
    lap("threads")
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"phase": 17, "seconds": time.perf_counter() - t_phase,
                      "split_s": split, "max_memory_allocated": peak,
                      "answers_held": len(answers)}))
    return block_tally


# ---------------------------------------------------------------------------
# Phase 25: the mesh on a process group, one rank per device. The card's
# machine has one H100, so the ranks share it over host-staged gloo; the
# rank functions below run in processes of their own (``launch.ranks.run_ranks``)
# and take the device they run on.
# ---------------------------------------------------------------------------


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _event_ms(torch, dev, fn, reps: int = 5) -> float:
    """Median ms of ``reps`` single calls after one warm-up: CUDA events
    around each call on the card (a host clock around it on the host)."""
    fn()
    _sync(torch, dev)
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _peak(torch, dev, reset: bool = False) -> int:
    if dev.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev)


def _free(torch, dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _held(torch, y, y_plain, sr, what: str) -> float:
    """Phase 16's tolerances: ⟨+,×⟩ within rtol 1e-5, atol 1e-6, the rest
    exact; returns max |diff| over entries finite in both."""
    if sr.name == "plus_times":
        torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-6, equal_nan=True,
                                   msg=lambda m: f"{what}: {m}")
    else:
        check(torch.equal(y, y_plain), f"{what}: kernel differs from the plain version")
    fin = torch.isfinite(y.double()) & torch.isfinite(y_plain.double())
    diff = (y.double() - y_plain.double()).abs()[fin]
    return float(diff.max()) if diff.numel() else 0.0


def rank_wrappers() -> tuple:
    """Every hand-written kernel's wrapper (each counts its launches)."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather, moe_dispatch_gather_backward
    from repro_torch.kernels.semiring_spmv import (
        semiring_spmv_fused_padded, semiring_spmv_padded, semiring_spmv_padded_batch,
        semiring_spmv_sell,
    )
    from repro_torch.kernels.spgemm_binary import semiring_spgemm_binary
    from repro_torch.kernels.spgemm_tiles import semiring_spgemm_padded
    from repro_torch.kernels.spmspv_tiles import (
        semiring_spmspv_fused_padded, semiring_spmspv_padded, semiring_spmspv_padded_batch,
    )
    return (semiring_spmv_padded, semiring_spmspv_padded, semiring_spmv_fused_padded,
            semiring_spmv_sell, semiring_spmspv_fused_padded, semiring_spgemm_padded,
            semiring_spgemm_binary, moe_dispatch_gather, semiring_spmv_padded_batch,
            semiring_spmspv_padded_batch, moe_dispatch_gather_backward)


def rank_graph_calls(torch, mesh, dev, data: dict, call=None, holds=None, timing=None) -> dict:
    """Phase 25a's calls on ``mesh``, the virtual ``Mesh`` or a rank's
    ``RankMesh`` (its own parts, ``partition(..., part=rank)``): on cit-HP
    (bsr 128×128) ⟨+,×⟩ on integer weights, ⟨min,+⟩ and ⟨∨,∧⟩, every
    strategy, both kernels and the fused form, every Merge topology, the
    compressed Load; ⟨+,×⟩'s batched calls on 2d; ``iterate_phases`` at
    depth 0 and 2 (⟨min,+⟩, 2d, square); the masked SpGEMM on ca-Q (2d,
    64×64, 0/1 ⟨+,∧⟩ and integer ⟨+,×⟩). Returns {key: what the mesh
    holds after the call, on the host}. ``call`` runs each call (the
    launch counts), ``holds`` (kind -> fn) hold a rank's Kernel-phase
    launches to the plain versions, ``timing`` times the phase split.
    ``partition_s`` holds the seconds the partitions took."""
    import importlib

    from repro_torch.core.distributed import (
        build_phase_fns, make_distributed_batched_matvec, make_distributed_matvec,
        make_distributed_spgemm,
    )
    from repro_torch.core.pipeline import iterate_phases
    from repro_torch.core.semiring import SEMIRINGS

    part = importlib.import_module("repro_torch.core.partition")
    call = call or (lambda fn: fn())
    own = getattr(mesh, "rank", None)
    d = mesh.n_devices
    strategies = {"row": (d, 1), "col": (1, d), "2d": mesh.grid}
    out = {}

    def pm_of(g, sr, vals, grid, shape=None, block=(128, 128)):
        t0 = time.perf_counter()
        pm = part.partition(g["cols"], g["rows"], vals, shape or (g["n"], g["n"]), grid, "bsr",
                            sr, block=block, balance="rows", device=dev, part=own)
        out["partition_s"] = out.get("partition_s", 0.0) + time.perf_counter() - t0
        return pm

    def vec(pm, v, fill, dim=0, side="input"):
        t = torch.from_numpy(v).to(dev)
        return mesh.local(part.shard_tensor(pm.plan, t, fill, dim=dim, side=side))

    def keep(key, y):
        out[key] = y.cpu()

    cit = data["cit"]
    for name in ("plus_times", "min_plus", "bool_or_and"):
        sr, inp = SEMIRINGS[name], data[name]
        for strategy, grid in strategies.items():
            pm = pm_of(cit, sr, inp["vals"], grid)
            xs, xsp = vec(pm, inp["x"], sr.zero), vec(pm, inp["x_sp"], sr.zero)
            forms = [("spmv", xs, {}), ("spmspv", xsp, {"kernel": "spmspv"}),
                     ("spmv/fused", xs, {"fused": True}),
                     ("spmspv/fused", xsp, {"kernel": "spmspv", "fused": True})]
            if strategy != "row":
                forms += [(f"spmv/{t}:{o}", xs, {"topology": t, "merge_order": o})
                          for t, o in (("ring", "rc"), ("tree", "rc"), ("staged2d", "rc"),
                                       ("staged2d", "cr")) if o == "rc" or strategy == "col"]
            if strategy != "col":
                forms.append(("spmspv/compressed", xsp,
                              {"kernel": "spmspv", "f_local": pm.plan.in_per}))
            for label, xin, kw in forms:
                fn = make_distributed_matvec(mesh, pm, sr, strategy, **kw)
                keep((name, strategy, label), call(lambda: fn(pm.parts, xin)))
            if holds is not None:
                for kernel, xin in (("spmv", xs), ("spmspv", xsp)):
                    for fused in (False, True):
                        holds["matvec"](pm, sr, strategy, xin, kernel, fused)
            if timing is not None and name == "plus_times":
                timing(pm, sr, strategy, xs)
            if name == "plus_times" and strategy == "2d":
                for kernel, key in (("spmv", "xb"), ("spmspv", "xb_sp")):
                    blk = vec(pm, inp[key], sr.zero, dim=1)
                    fb = make_distributed_batched_matvec(mesh, pm, sr, "2d", kernel=kernel)
                    keep((name, strategy, f"batched/{kernel}"), call(lambda: fb(pm.parts, blk)))
                    if holds is not None:
                        holds["batched"](pm, sr, blk, kernel)
            del pm, xs, xsp
            _free(torch, dev)
    # the pipeline: x <- A x on 2d, square chunks
    sr, inp = SEMIRINGS["min_plus"], data["min_plus"]
    n_pad = inp["x0"].shape[0]
    pm = pm_of(cit, sr, inp["vals"], mesh.grid, shape=(n_pad, n_pad))
    x0 = vec(pm, inp["x0"], sr.zero)
    fns = build_phase_fns(mesh, pm, sr, "2d", "spmv")
    for depth in (0, 2):
        keep(("min_plus", "2d", f"iterate/depth{depth}"),
             call(lambda: iterate_phases(fns, pm.parts, x0, data["pipe_iters"], depth=depth)))
    del pm, fns
    _free(torch, dev)
    # the masked SpGEMM on ca-Q
    caq = data["caq"]
    for name in ("plus_and", "plus_times"):
        sr = SEMIRINGS[name]
        pm = pm_of(caq, sr, caq[f"vals/{name}"], mesh.grid, block=(64, 64))
        bs = vec(pm, caq[f"b/{name}"], sr.one)
        ms = vec(pm, caq[f"mask/{name}"], sr.zero, side="output")
        fn = make_distributed_spgemm(mesh, pm, sr, "2d")
        keep((name, "2d", "spgemm/masked"), call(lambda: fn(pm.parts, bs, ms)))
        if holds is not None:
            holds["spgemm"](pm, sr, bs)
        del pm, bs, ms
        _free(torch, dev)
    return out


_DIGEST_WEIGHTS: dict = {}


def digest(torch, t) -> tuple:
    """(dtype, shape, two 64-bit sums of t's bytes, each byte times a
    seeded random int64 weight by position): integer sums, the same in any
    order, so two tensors' digests are equal exactly when their bits are
    (but for a 2^-64 chance). Computed on t's device in chunks."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    n = 1 << 24
    if str(b.device) not in _DIGEST_WEIGHTS:
        gen = torch.Generator(device=b.device).manual_seed(25)
        _DIGEST_WEIGHTS[str(b.device)] = torch.randint(
            -(1 << 62), 1 << 62, (2, n), dtype=torch.int64, device=b.device, generator=gen)
    w = _DIGEST_WEIGHTS[str(b.device)]
    acc = torch.zeros(2, dtype=torch.int64, device=b.device)
    for i in range(0, b.numel(), n):
        c = b[i:i + n].to(torch.int64)
        acc = acc * 1000003 + (c[None] * w[:, :c.numel()]).sum(dim=1)
    return (str(t.dtype), tuple(t.shape)) + tuple(int(v) for v in acc.tolist())


def state_blocks(params, opt, ef=None) -> dict:
    """{key: the block stack} of every ``Sharded`` leaf of a mesh state."""
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.train import checkpoint as ckpt
    trees = {"params": params, "master": opt.master, "mu": opt.mu, "nu": opt.nu}
    if ef is not None:
        trees["ef"] = ef
    return {f"{f}/{k}": v.blocks for f, tree in trees.items()
            for k, v in ckpt._flatten(tree).items() if isinstance(v, Sharded)}


def rank_train_run(torch, mesh, dev, cfg, batches, tcfg, compressed: bool, hold: str,
                   kernels=()) -> list:
    """``make_train_step`` (or the compressed step) on ``mesh`` from the
    model drawn from seed ``SEED``, one record a step: the loss and grad
    norm (on the host), the step's ms (host clock ending in a sync) and
    kernel 7's and 7ᵀ's launches, and every block of the state: as host
    copies (``hold="blocks"``) or as ``digest``s (``hold="digest"``;
    on the virtual mesh, each block of the stack)."""
    from repro_torch.distributed.sharding import set_activation_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.train.train_loop import (
        init_mesh_ef, init_mesh_state, make_compressed_train_step, make_train_step,
    )
    model = build_model(cfg, device=dev).init(seed=SEED)
    params, opt = init_mesh_state(model, mesh)
    ef = init_mesh_ef(model, mesh) if compressed else None
    step = (make_compressed_train_step if compressed else make_train_step)(model, mesh, tcfg)
    rows = []
    for batch in batches:
        _sync(torch, dev)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        if compressed:
            params, opt, ef, met = step(params, opt, ef, batch)
        else:
            params, opt, met = step(params, opt, batch)
        _sync(torch, dev)
        rec = {"ms": (time.perf_counter() - t0) * 1e3, "loss": met["loss"].cpu(),
               "grad_norm": met["grad_norm"].cpu(), "launches": [k.launches for k in kernels]}
        blocks = state_blocks(params, opt, ef)
        if hold == "blocks":
            rec["blocks"] = {k: v.cpu() for k, v in blocks.items()}
        else:
            rec["digests"] = {k: [digest(torch, v[i]) for i in range(v.shape[0])]
                              for k, v in blocks.items()}
        rows.append(rec)
    set_activation_mesh(None)
    del model, params, opt, ef, step
    _free(torch, dev)
    return rows


def _rank_launch_counts(kernels, tally):
    def call(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        for k in kernels:
            tally[k.__name__] += k.launches
        return out
    return call


def rank25_graph_and_pod(rank: int, world: int, init: str, payload: dict) -> dict:
    """One of phase 25's 8 gloo ranks: 25a on a (2, 4) ``RankMesh`` (its
    parts alone), each Kernel-phase launch held to its plain version on
    the rank's part, Load / Kernel / Retrieve+Merge ms by CUDA events; then
    25c's compressed steps on (pod 2, data 2, model 2)."""
    import torch

    sys.path.insert(0, payload["src"])
    from repro_torch.core.distributed import _fused_partials, build_phase_fns
    from repro_torch.core.partition import device_part
    from repro_torch.core.rank_mesh import init_rank_mesh
    from repro_torch.core.spmspv import frontier_from_dense, spmspv_batch
    from repro_torch.core.spmv import spmv_batch
    from repro_torch.kernels import ops, ref

    dev = torch.device(payload["device"])
    t_rank = time.perf_counter()
    mesh = init_rank_mesh(RANK_GRID, ("dr", "dc"), "gloo", device=dev, init_method=init,
                          rank=rank, world_size=world)
    kernels = rank_wrappers()
    tally = {k.__name__: 0 for k in kernels}
    call = _rank_launch_counts(kernels, tally)
    errs: dict = {}
    kernel_of = {("spmv", False): "semiring_spmv_padded",
                 ("spmspv", False): "semiring_spmspv_padded",
                 ("spmv", True): "semiring_spmv_fused_padded",
                 ("spmspv", True): "semiring_spmspv_fused_padded"}

    def held(name, y, y_plain, sr, what):
        errs[name] = max(errs.get(name, 0.0), _held(torch, y, y_plain, sr, what))

    def hold_matvec(pm, sr, strategy, xs, kernel, fused):
        fns = build_phase_fns(mesh, pm, sr, strategy, kernel, fused=fused)
        xf = fns["load"](pm.parts, xs) if fns["load"] is not None else xs
        if fused and strategy != "row":
            chunks = mesh.n_devices if strategy == "col" else mesh.grid[1]
            ys = call(lambda: _fused_partials(pm.parts, xf, sr, kernel, chunks)[0])
        else:
            ys = call(lambda: fns["kernel"](pm.parts, xs, xf))
        a, xg = device_part(pm.parts, 0), xf[0]
        if kernel == "spmspv":
            y_plain = ops.semiring_spmspv_ref(a, frontier_from_dense(xg, sr), sr)
        elif fused:
            y_plain = ref.spmv_fused_padded_ref(a.tiles, ops._spmv_fused_meta(a), xg, sr)
        else:
            y_plain = ops.semiring_spmv_ref(a, xg, sr)
        name = kernel_of[(kernel, fused)]
        held(name, ys[0].reshape(-1), y_plain, sr, f"phase 25a rank {rank} {sr.name}/"
             f"{strategy} {name}")

    def hold_batched(pm, sr, blk, kernel):
        xfb = mesh.all_gather(to_2d(mesh, blk, pm.grid), "dr", dim=2)
        body = spmv_batch if kernel == "spmv" else spmspv_batch
        a = device_part(pm.parts, 0)
        y = call(lambda: body(a, xfb[0], sr))
        held(f"semiring_{kernel}_padded_batch", y, body(a, xfb[0], sr, impl="ref"), sr,
             f"phase 25a rank {rank} batched {kernel}")

    def hold_spgemm(pm, sr, bs):
        from repro_torch.core.spgemm import spgemm_masked
        bf = mesh.all_gather(to_2d(mesh, bs, pm.grid), "dr")
        a = device_part(pm.parts, 0)
        n6b = tally["semiring_spgemm_binary"]
        y = call(lambda: spgemm_masked(a, bf[0], sr))
        bp, mk, meta, bn, ncol = ops._spgemm_operands(a, bf[0], sr, None)
        if tally["semiring_spgemm_binary"] > n6b:
            name, y_plain = "semiring_spgemm_binary", ref.spgemm_binary_ref(
                a.tiles, meta, bp, mk, sr, bn)
        else:
            name, y_plain = "semiring_spgemm_padded", ref.spgemm_padded_ref(
                a.tiles, meta, bp, mk, sr, bn)
        held(name, y, y_plain[:, :ncol], sr, f"phase 25a rank {rank} spgemm {sr.name}")

    splits = []

    def timing(pm, sr, strategy, xs):
        fns = build_phase_fns(mesh, pm, sr, strategy, "spmv")
        load, kernel, rm = fns["load"], fns["kernel"], fns["retrieve_merge"]
        xf = load(pm.parts, xs) if load is not None else xs
        ys = kernel(pm.parts, xs, xf)
        splits.append({"strategy": strategy,
                       "load_ms": _event_ms(torch, dev, lambda: load(pm.parts, xs))
                       if load is not None else 0.0,
                       "kernel_ms": _event_ms(torch, dev, lambda: kernel(pm.parts, xs, xf)),
                       "retrieve_merge_ms": _event_ms(torch, dev, lambda: rm(pm.parts, ys))
                       if rm is not None else 0.0,
                       "e2e_ms": _event_ms(torch, dev, lambda: fns["e2e"](pm.parts, xs))})

    from repro_torch.core.distributed import to_2d_layout as to_2d
    _peak(torch, dev, reset=True)
    t0 = time.perf_counter()
    wire0 = dict(mesh.wire_bytes)
    outs = rank_graph_calls(torch, mesh, dev, payload["graph"], call,
                            {"matvec": hold_matvec, "batched": hold_batched,
                             "spgemm": hold_spgemm}, timing)
    graph = {"outs": outs, "tally": tally, "errs": errs, "splits": splits,
             "seconds": time.perf_counter() - t0, "peak_bytes": _peak(torch, dev),
             "wire_bytes": {k: v - wire0.get(k, 0) for k, v in mesh.wire_bytes.items()},
             "calls": dict(mesh.calls)}
    del outs
    _free(torch, dev)
    # 25c: the compressed step on (pod 2, data 2, model 2)
    pod = init_rank_mesh(RANK_POD_SHAPE, ("pod", "data", "model"), "gloo", device=dev)
    _peak(torch, dev, reset=True)
    t0 = time.perf_counter()
    batches = [{k: v.to(dev) for k, v in b.items()} for b in payload["pod_batches"]]
    steps = rank_train_run(torch, pod, dev, payload["pod_cfg"], batches, payload["pod_tcfg"],
                           True, "blocks", kernels[7:8] + kernels[10:11])
    pod_run = {"steps": steps, "seconds": time.perf_counter() - t0,
               "peak_bytes": _peak(torch, dev), "wire_bytes": dict(pod.wire_bytes),
               "calls": dict(pod.calls)}
    return {"graph": graph, "pod": pod_run, "seconds": time.perf_counter() - t_rank}


def rank25_train(rank: int, world: int, init: str, payload: dict) -> dict:
    """One of phase 25b's 4 gloo ranks: ``make_train_step`` on (data 2,
    model 2) at full width, every block's digest after every step."""
    import torch

    sys.path.insert(0, payload["src"])
    from repro_torch.launch.mesh import rank_mesh

    dev = torch.device(payload["device"])
    t0 = time.perf_counter()
    mesh = rank_mesh(*RANK_TRAIN_SHAPE, backend="gloo", device=dev, init_method=init,
                     rank=rank, world_size=world)
    kernels = rank_wrappers()
    _peak(torch, dev, reset=True)
    batches = [{k: v.to(dev) for k, v in b.items()} for b in payload["batches"]]
    steps = rank_train_run(torch, mesh, dev, payload["cfg"], batches, payload["tcfg"], False,
                           "digest", kernels[7:8] + kernels[10:11])
    return {"steps": steps, "peak_bytes": _peak(torch, dev), "wire_bytes": dict(mesh.wire_bytes),
            "calls": dict(mesh.calls), "seconds": time.perf_counter() - t0}


def rank25_nccl(rank: int, world: int, init: str, payload: dict) -> dict:
    """Phase 25d: one NCCL rank (world 1, the calling process) on the
    card: 25a's row strategy (⟨+,×⟩ spmv on cit-HP) and one train step of
    25c's config on 1×1 meshes, the collectives NCCL's."""
    import importlib

    import torch

    sys.path.insert(0, payload["src"])
    from repro_torch.core.distributed import make_distributed_matvec
    from repro_torch.core.rank_mesh import init_rank_mesh
    from repro_torch.core.semiring import PLUS_TIMES

    part = importlib.import_module("repro_torch.core.partition")
    dev = torch.device(payload["device"])
    mesh = init_rank_mesh((1, 1), ("dr", "dc"), "nccl", device=dev, init_method=init,
                          rank=rank, world_size=world)
    g, inp = payload["graph"]["cit"], payload["graph"]["plus_times"]
    pm = part.partition(g["cols"], g["rows"], inp["vals"], (g["n"], g["n"]), (1, 1), "bsr",
                        PLUS_TIMES, block=(128, 128), device=dev, part=0)
    xs = mesh.local(part.shard_tensor(pm.plan, torch.from_numpy(inp["x"]).to(dev), 0.0))
    y = make_distributed_matvec(mesh, pm, PLUS_TIMES, "row")(pm.parts, xs).cpu()
    del pm
    lm = init_rank_mesh((1, 1), ("data", "model"), "nccl", device=dev)
    batches = [{k: v.to(dev) for k, v in payload["pod_batches"][0].items()}]
    steps = rank_train_run(torch, lm, dev, payload["pod_cfg"], batches, payload["pod_tcfg"],
                           False, "blocks")
    return {"row": y, "steps": steps, "backend": mesh.backend,
            "calls": {"graph": dict(mesh.calls), "train": dict(lm.calls)}}


def rank_phases(torch, dev, cit, caq) -> dict:
    """Phase 25: the mesh on a process group, one rank per device. The
    card's machine has one H100, so the ranks time-share it over gloo,
    each collective staged through pinned host buffers; their walls are
    not a multi-card result. (a) 8 ranks on phase 16's (2, 4) mesh and
    partitions of cit-HP: every call of ``rank_graph_calls`` on every rank
    ``torch.equal`` to block ``rank`` of the virtual mesh's, each rank's
    Kernel-phase launches held to their plain versions on its part, the
    phase split by CUDA events beside the virtual mesh's. (b) 4 ranks,
    ``make_train_step`` on (data 2, model 2), DeepSeek-V2-Lite at full
    width, 2 layers, bf16, 2 steps: each rank's loss and grad norm equal
    and every block's digest equal to the virtual mesh's block ``rank``.
    (c) The compressed step on (pod 2, data 2, model 2) at phase 21d's
    scaled config on the 8 ranks of (a): blocks and per-pod error
    feedback ``torch.equal``. (d) One NCCL rank (world 1): (a)'s row
    strategy and one train step on 1×1 meshes, equal to the virtual
    mesh's. Returns the ranks' kernel launches, by kernel."""
    import numpy as np

    from repro_torch.core.distributed import build_phase_fns
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.graphs.engine import edge_values
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.train import scaled_config
    from repro_torch.models.zoo import count_params, get_config
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainConfig

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 25)
    src = str(Path(__file__).resolve().parent / "src")
    where = "cuda:0" if dev.type == "cuda" else "cpu"
    kernels = rank_wrappers()
    launches = {k.__name__: 0 for k in kernels}
    print("phase 25: the ranks time-share one card, each collective staged through pinned "
          "host buffers over gloo (NCCL refuses two ranks on one GPU): their walls are not a "
          "multi-card result")

    def edges(g):
        return {"rows": g.rows.astype(np.int64), "cols": g.cols.astype(np.int64), "n": g.n}

    def sparse(v, fill, density=0.05):
        return np.where(rng.random(v.shape) < density, v, fill).astype(v.dtype)

    n = cit.n
    graph = {"cit": edges(cit), "pipe_iters": RANK_PIPE_ITERS}
    for name in ("plus_times", "min_plus", "bool_or_and"):
        sr = SEMIRINGS[name]
        x = (rng.integers(0, 2, n).astype(np.int32) if sr.dtype == torch.int32
             else rng.integers(0, 9, n).astype(np.float32))
        fill = 0 if sr.dtype == torch.int32 else float(sr.zero)
        graph[name] = {"vals": edge_values(cit, sr, weighted=name != "bool_or_and", seed=5),
                       "x": x, "x_sp": sparse(x, fill)}
    xb = rng.uniform(0.5, 4.0, (RANK_B, n)).astype(np.float32)
    graph["plus_times"].update(xb=xb, xb_sp=sparse(xb, 0.0))
    n_pad = -(-n // (128 * 8)) * (128 * 8)
    x0 = np.full(n_pad, np.inf, np.float32)
    x0[rng.choice(n, 64, replace=False)] = 0.0
    graph["min_plus"]["x0"] = x0
    graph["caq"] = edges(caq)
    for name in ("plus_and", "plus_times"):
        sr = SEMIRINGS[name]
        dt = np.int32 if sr.dtype == torch.int32 else np.float32
        graph["caq"][f"vals/{name}"] = np.ones(caq.nnz, dt)
        graph["caq"][f"b/{name}"] = ((rng.random((caq.n, RANK_SPGEMM_COLS)) < 0.3).astype(dt)
                                     if name == "plus_and" else
                                     rng.integers(0, 4, (caq.n, RANK_SPGEMM_COLS)).astype(dt))
        graph["caq"][f"mask/{name}"] = (rng.random((caq.n, RANK_SPGEMM_COLS)) < 0.4).astype(dt)

    # the virtual mesh's results and phase split
    t0 = time.perf_counter()
    vm = Mesh(RANK_GRID, device=dev)
    v_splits = []

    def v_timing(pm, sr, strategy, xs):
        fns = build_phase_fns(vm, pm, sr, strategy, "spmv")
        load, kernel, rm = fns["load"], fns["kernel"], fns["retrieve_merge"]
        xf = load(pm.parts, xs) if load is not None else xs
        ys = kernel(pm.parts, xs, xf)
        v_splits.append({"strategy": strategy,
                         "load_ms": _event_ms(torch, dev, lambda: load(pm.parts, xs))
                         if load is not None else 0.0,
                         "kernel_ms": _event_ms(torch, dev, lambda: kernel(pm.parts, xs, xf)),
                         "retrieve_merge_ms": _event_ms(torch, dev, lambda: rm(pm.parts, ys))
                         if rm is not None else 0.0,
                         "e2e_ms": _event_ms(torch, dev, lambda: fns["e2e"](pm.parts, xs))})

    want = rank_graph_calls(torch, vm, dev, graph, timing=v_timing)
    v_partition_s = want.pop("partition_s")
    virtual_s = time.perf_counter() - t0
    full = get_config("deepseek-v2-lite-16b")
    pod_cfg = scaled_config(full, 0.05)
    pod_cfg = dataclasses.replace(pod_cfg, moe=dataclasses.replace(pod_cfg.moe, top_k=2))
    pod_tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                           microbatches=1, remat=True, grad_compress_pod=True)
    pod_src = SyntheticLM(DataConfig(global_batch=8, seq_len=128, vocab=pod_cfg.vocab, seed=SEED))
    pod_batches = [{k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in pod_src.batch(i, 0, 1).items()} for i in range(RANK_POD_STEPS)]
    on_dev = [{k: v.to(dev) for k, v in b.items()} for b in pod_batches]
    v_pod = rank_train_run(torch, small_mesh(*RANK_POD_SHAPE[1:], pod=RANK_POD_SHAPE[0],
                                             device=dev),
                           dev, pod_cfg, on_dev, pod_tcfg, True, "blocks")
    payload = {"src": src, "device": where, "graph": graph, "pod_cfg": pod_cfg,
               "pod_tcfg": pod_tcfg, "pod_batches": pod_batches}

    # ---------------------------------------------------------------- 25a, 25c
    t0 = time.perf_counter()
    ranks = run_ranks(rank25_graph_and_pod, RANK_GRID[0] * RANK_GRID[1], payload, timeout=600)
    spawn_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        got = res["graph"]["outs"]
        partition_s = got.pop("partition_s")
        check(got.keys() == want.keys(), f"phase 25a rank {r}: calls {set(want) ^ set(got)}")
        for key, w in want.items():
            check(torch.equal(got[key], w[r:r + 1]),
                  f"phase 25a rank {r} {key}: not block {r} of the virtual mesh's result")
        for k, v in res["graph"]["tally"].items():
            launches[k] += v
        for k in ("semiring_spmv_padded", "semiring_spmspv_padded", "semiring_spmv_fused_padded",
                  "semiring_spmspv_fused_padded", "semiring_spmv_padded_batch",
                  "semiring_spmspv_padded_batch", "semiring_spgemm_padded",
                  "semiring_spgemm_binary"):
            check(res["graph"]["tally"][k] > 0, f"phase 25a rank {r}: {k} was not launched")
            check(k in res["graph"]["errs"], f"phase 25a rank {r}: {k} was not held to its "
                  "plain version on the rank's part")
        print(json.dumps({"phase": "25a", "rank": r, "splits": res["graph"]["splits"],
                          "wire_bytes": res["graph"]["wire_bytes"],
                          "collectives": res["graph"]["calls"],
                          "peak_bytes": res["graph"]["peak_bytes"],
                          "seconds": res["graph"]["seconds"], "partition_s": partition_s,
                          "rank_seconds": res["seconds"],
                          "max_abs_err_vs_plain": res["graph"]["errs"]}))
        for i, (s, w) in enumerate(zip(res["pod"]["steps"], v_pod)):
            check(torch.equal(s["loss"], w["loss"]) and torch.equal(s["grad_norm"],
                                                                    w["grad_norm"]),
                  f"phase 25c rank {r} step {i + 1}: loss or grad norm differs")
            check(s["blocks"].keys() == w["blocks"].keys(), f"phase 25c rank {r}: leaves differ")
            for k, v in w["blocks"].items():
                check(torch.equal(s["blocks"][k], v[r:r + 1]),
                      f"phase 25c rank {r} step {i + 1} {k}: not the virtual mesh's block")
            check(all(x > 0 for x in s["launches"]),
                  f"phase 25c rank {r} step {i + 1}: kernels 7 and 7ᵀ launched {s['launches']}")
            launches["moe_dispatch_gather"] += s["launches"][0]
            launches["moe_dispatch_gather_backward"] += s["launches"][1]
    print(json.dumps({"phase": "25a", "virtual": True, "splits": v_splits,
                      "virtual_seconds": virtual_s, "partition_s": v_partition_s}))
    print(json.dumps({"phase": "25c", "config": "scaled_config(deepseek-v2-lite-16b, 0.05), "
                      "top-2", "params": count_params(pod_cfg), "mesh": list(RANK_POD_SHAPE),
                      "step_ms": [[s["ms"] for s in res["pod"]["steps"]] for res in ranks],
                      "virtual_step_ms": [s["ms"] for s in v_pod],
                      "loss": [float(s["loss"]) for s in v_pod],
                      "wire_bytes_rank0": ranks[0]["pod"]["wire_bytes"],
                      "peak_bytes": [res["pod"]["peak_bytes"] for res in ranks]}))
    print(f"phase 25a: {len(want)} calls on 8 gloo ranks ((2, 4), cit-HP and ca-Q) equal the "
          f"virtual mesh's blocks bit for bit; every rank's Kernel-phase launches equal their "
          f"plain versions; ranks started and run in {spawn_s:.1f} s")
    print(f"phase 25c: the compressed step on {RANK_POD_SHAPE} over 8 ranks equals the virtual "
          f"mesh for {RANK_POD_STEPS} steps: every block and each pod's error feedback")
    del ranks, want, v_pod
    _free(torch, dev)

    # ---------------------------------------------------------------- 25b
    cfg = dataclasses.replace(full, n_layers=2)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS),
                       microbatches=RANK_TRAIN_MICRO, remat=True)
    t_src = SyntheticLM(DataConfig(global_batch=RANK_TRAIN_ROWS, seq_len=TRAIN_SEQ,
                                   vocab=cfg.vocab, seed=SEED))
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in t_src.batch(i, 0, 1).items()} for i in range(RANK_TRAIN_STEPS)]
    _peak(torch, dev, reset=True)
    t0 = time.perf_counter()
    v_train = rank_train_run(torch, small_mesh(*RANK_TRAIN_SHAPE, device=dev), dev, cfg,
                             [{k: v.to(dev) for k, v in b.items()} for b in batches], tcfg,
                             False, "digest", kernels[7:8] + kernels[10:11])
    v_peak, v_s = _peak(torch, dev), time.perf_counter() - t0
    _free(torch, dev)
    t0 = time.perf_counter()
    tranks = run_ranks(rank25_train, RANK_TRAIN_SHAPE[0] * RANK_TRAIN_SHAPE[1],
                       {"src": src, "device": where, "cfg": cfg, "tcfg": tcfg,
                        "batches": batches}, timeout=600)
    train_s = time.perf_counter() - t0
    for r, res in enumerate(tranks):
        for i, (s, w) in enumerate(zip(res["steps"], v_train)):
            check(torch.equal(s["loss"], w["loss"]) and torch.equal(s["grad_norm"],
                                                                    w["grad_norm"]),
                  f"phase 25b rank {r} step {i + 1}: loss or grad norm differs")
            check(s["digests"].keys() == w["digests"].keys(), f"phase 25b rank {r}: leaves")
            for k, v in w["digests"].items():
                check(s["digests"][k] == [v[r]],
                      f"phase 25b rank {r} step {i + 1} {k}: not the virtual mesh's block")
            # the virtual mesh runs the rows of both data positions, a rank its own
            check([RANK_TRAIN_SHAPE[0] * x for x in s["launches"]] == w["launches"]
                  and all(x > 0 for x in s["launches"]),
                  f"phase 25b rank {r} step {i + 1}: kernels 7 and 7ᵀ launched "
                  f"{s['launches']}, the virtual mesh {w['launches']} for {RANK_TRAIN_SHAPE[0]} "
                  "data positions")
            launches["moe_dispatch_gather"] += s["launches"][0]
            launches["moe_dispatch_gather_backward"] += s["launches"][1]
        print(json.dumps({"phase": "25b", "rank": r, "step_ms": [s["ms"] for s in res["steps"]],
                          "wire_bytes": res["wire_bytes"], "collectives": res["calls"],
                          "peak_bytes": res["peak_bytes"], "seconds": res["seconds"]}))
    leaves = len(v_train[0]["digests"])
    print(json.dumps({"phase": "25b", "virtual": True, "arch": cfg.arch_id, "layers": 2,
                      "params": count_params(cfg), "mesh": list(RANK_TRAIN_SHAPE),
                      "tokens_per_step": RANK_TRAIN_ROWS * TRAIN_SEQ,
                      "microbatches": RANK_TRAIN_MICRO,
                      "step_ms": [s["ms"] for s in v_train], "peak_bytes": v_peak,
                      "seconds": v_s, "loss": [float(s["loss"]) for s in v_train],
                      "grad_norm": [float(s["grad_norm"]) for s in v_train]}))
    print(f"phase 25b: {cfg.arch_id} at full width, 2 layers, on {RANK_TRAIN_SHAPE} over 4 gloo "
          f"ranks: {RANK_TRAIN_STEPS} steps, each rank's loss and grad norm equal and all "
          f"{leaves} block digests equal to the virtual mesh's block rank, ranks started and run "
          f"in {train_s:.1f} s")
    del tranks, v_train
    _free(torch, dev)

    # ---------------------------------------------------------------- 25d
    from repro_torch.core.distributed import make_distributed_matvec
    import importlib
    part = importlib.import_module("repro_torch.core.partition")
    sr, inp = SEMIRINGS["plus_times"], graph["plus_times"]
    pm = part.partition(graph["cit"]["cols"], graph["cit"]["rows"], inp["vals"], (n, n), (1, 1),
                        "bsr", sr, block=(128, 128), device=dev)
    xs = part.shard_tensor(pm.plan, torch.from_numpy(inp["x"]).to(dev), 0.0)
    y1 = make_distributed_matvec(Mesh((1, 1), device=dev), pm, sr, "row")(pm.parts, xs).cpu()
    del pm, xs
    v_one = rank_train_run(torch, small_mesh(1, 1, device=dev), dev, pod_cfg, on_dev[:1],
                           dataclasses.replace(pod_tcfg, grad_compress_pod=False), False,
                           "blocks")
    t0 = time.perf_counter()
    # world 1: this process is the rank (its process group is destroyed after)
    import os
    import tempfile

    import torch.distributed as tdist
    with tempfile.TemporaryDirectory() as tmp:
        try:
            nccl = rank25_nccl(0, 1, "file://" + os.path.join(tmp, "rendezvous"),
                               {"src": src, "device": where, "graph": graph, "pod_cfg": pod_cfg,
                                "pod_tcfg": dataclasses.replace(pod_tcfg,
                                                                grad_compress_pod=False),
                                "pod_batches": pod_batches})
        finally:
            if tdist.is_initialized():
                tdist.destroy_process_group()
    nccl_s = time.perf_counter() - t0
    check(nccl["backend"] == "nccl", f"phase 25d: the process group is {nccl['backend']}")
    check(torch.equal(nccl["row"], y1), "phase 25d: the NCCL rank's row spmv is not the "
          "virtual mesh's")
    s, w = nccl["steps"][0], v_one[0]
    check(torch.equal(s["loss"], w["loss"]) and torch.equal(s["grad_norm"], w["grad_norm"])
          and all(torch.equal(s["blocks"][k], v) for k, v in w["blocks"].items()),
          "phase 25d: the NCCL rank's train step is not the virtual mesh's")
    check(nccl["calls"]["graph"].get("all_gather", 0) > 0
          and nccl["calls"]["train"].get("gather_full", 0) > 0,
          f"phase 25d: NCCL issued no collective: {nccl['calls']}")
    print(json.dumps({"phase": "25d", "backend": "nccl", "world": 1,
                      "collectives": nccl["calls"], "seconds": nccl_s}))
    seconds = time.perf_counter() - t_phase
    print(f"phase 25d: one NCCL rank's row spmv and train step equal one virtual device's; "
          f"phase 25: {seconds:.1f} s")
    return launches


def _rank_syncs(torch, dev, fn) -> tuple:
    """(fn's result, its wall ms on the host clock ending in a sync, the
    synchronising CUDA calls torch.cuda's sync debug mode reports in it;
    0 on the host)."""
    import warnings

    _sync(torch, dev)
    t0 = time.perf_counter()
    if dev.type != "cuda":
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3, 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def rank26_multi(rank: int, world: int, init: str, payload: dict) -> dict:
    """One gloo rank of phase 26 on cit-HP's bsr engines: each run of
    ``payload["runs"]`` ((app, B, mesh shape, axis names, axis_name)) on a
    ``RankMesh``, the rank's own rows alone (a first run counted and
    timed, a second under the sync debug mode), the first launch of
    kernels 1b and 2b held to its plain version; then, with ``serve``,
    26b's ``GraphQueryServer(mesh=RankMesh)`` flush of the queries, and
    with ``matvec``, ``GraphQueryServer.partitioned_matvec`` on (2, 4)."""
    import torch

    sys.path.insert(0, payload["src"])
    from repro_torch.core.rank_mesh import init_rank_mesh
    from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES
    from repro_torch.graphs import bfs_multi, build_engine, ppr_multi, sssp_multi
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded_batch

    dev = torch.device(payload["device"])
    t_rank = time.perf_counter()
    cit, stump = payload["graph"], payload["stump"]
    apps = {"bfs": (BOOL_OR_AND, bfs_multi, {}),
            "sssp": (MIN_PLUS, sssp_multi, {"weighted": True, "seed": 5}),
            "ppr": (PLUS_TIMES, ppr_multi, {"normalize": True})}
    blocks = (semiring_spmv_padded_batch, semiring_spmspv_padded_batch)
    plain = {"semiring_spmv_padded_batch": ref.spmv_padded_batch_ref,
             "semiring_spmspv_padded_batch": ref.spmspv_padded_batch_ref}
    caught: dict = {}
    errs: dict = {}

    def recorder(k):
        """k's wrapper, keeping the operands and output of its first launch
        on the main path (the launch itself counts as any other)."""
        def call(tiles, second, xs, *, sr):
            y = k(tiles, second, xs, sr=sr)
            if k.__name__ not in caught:
                caught[k.__name__] = (tiles, second.clone(), xs.clone(), sr, y)
            return y
        return call

    def hold(name, tiles, second, xs, sr, y, what) -> list:
        """Hold one launch's output to its plain version; its block shape.
        (A function of its own: no frame keeps the engine's tiles after.)"""
        errs[name] = max(errs.get(name, 0.0), _held(torch, y, plain[name](tiles, second, xs, sr),
                                                    sr, what))
        return list(xs.shape)

    meshes: dict = {}

    def mesh_of(shape, names):
        if (shape, names) not in meshes:
            meshes[shape, names] = init_rank_mesh(shape, names, "gloo", device=dev,
                                                  init_method=init, rank=rank, world_size=world)
        return meshes[shape, names]

    launches = {k.__name__: 0 for k in blocks}
    runs = []
    for app, b, shape, names, axis in payload["runs"]:
        sr, multi, kw = apps[app]
        mesh = mesh_of(shape, names)
        t0 = time.perf_counter()
        eng = build_engine(cit, sr, stump, device=dev, fmt_spmv="bsr", fmt_spmspv="bsr", **kw)
        _sync(torch, dev)
        build_s = time.perf_counter() - t0
        srcs = payload["sources"][app][:b]
        caught.clear()
        ops.semiring_spmv_padded_batch, ops.semiring_spmspv_padded_batch = (
            recorder(k) for k in blocks)
        try:
            for k in blocks:
                k.launches = 0
            calls0, wire0 = dict(mesh.calls), dict(mesh.wire_bytes)
            _peak(torch, dev, reset=True)
            _sync(torch, dev)
            t0 = time.perf_counter()
            res = multi(eng, srcs, mesh=mesh, axis_name=axis)
            _sync(torch, dev)
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k.__name__: k.launches for k in blocks}
            calls = {k: v - calls0.get(k, 0) for k, v in mesh.calls.items()
                     if v > calls0.get(k, 0)}
            wire = {k: v - wire0.get(k, 0) for k, v in mesh.wire_bytes.items()
                    if v > wire0.get(k, 0)}
            peak = _peak(torch, dev)
        finally:
            ops.semiring_spmv_padded_batch, ops.semiring_spmspv_padded_batch = blocks
        for k, v in counts.items():
            launches[k] += v
        held = {name: hold(name, *ops_, f"phase 26a rank {rank} {app} B={b} {name}")
                for name, ops_ in caught.items()}
        caught.clear()
        again, warm_ms, n_sync = _rank_syncs(torch, dev, lambda: multi(eng, srcs, mesh=mesh,
                                                                       axis_name=axis))
        (lo, hi), = mesh.row_shares(b, axis)
        runs.append({"app": app, "B": b, "mesh": list(shape), "axis": axis, "rows": hi - lo,
                     "result": tuple(t.cpu() for t in res),
                     "again_equal": all(torch.equal(x, y) for x, y in zip(res, again)),
                     "wall_ms": ms, "warm_wall_ms": warm_ms, "host_syncs": n_sync,
                     "levels": int(res.iterations.max()), "launches": counts,
                     "collectives": calls, "wire_bytes": wire, "peak_bytes": peak,
                     "build_s": build_s, "held": held})
        del eng, res, again
        _free(torch, dev)
    out = {"runs": runs, "launches": launches, "errs": errs}
    if "serve" in payload:
        from repro_torch.serve.graph_engine import GraphQueryServer
        mesh = mesh_of((world,), ("batch",))
        srv = GraphQueryServer(cit, stump, batch_size=SERVE_BATCH, mesh=mesh, device=dev)
        reqs = [srv.submit(a, s) for a, s in payload["serve"]]
        calls0 = dict(mesh.calls)
        _peak(torch, dev, reset=True)
        t0 = time.perf_counter()
        srv.flush()
        out["serve"] = {"payloads": [(r.algorithm, r.source, r.result) for r in reqs],
                        "flush_ms": (time.perf_counter() - t0) * 1e3,
                        "counters": dict(srv.counters), "lru": list(srv.cache._d.keys()),
                        "collectives": {k: v - calls0.get(k, 0) for k, v in mesh.calls.items()
                                        if v > calls0.get(k, 0)},
                        "peak_bytes": _peak(torch, dev)}
        del srv, reqs
        _free(torch, dev)
    if "matvec" in payload:
        import importlib

        from repro_torch.serve.graph_engine import GraphQueryServer
        part = importlib.import_module("repro_torch.core.partition")
        mesh = mesh_of((2, 4), ("dr", "dc"))
        srv = GraphQueryServer(cit, stump, device=dev)
        t0 = time.perf_counter()
        pm, fn, choice = srv.partitioned_matvec("bfs", mesh)
        build_s = time.perf_counter() - t0
        x = torch.from_numpy(payload["matvec"]).to(dev)
        xp = torch.zeros(pm.plan.shape[1], dtype=x.dtype, device=dev)
        xp[: x.shape[0]] = x
        xs = mesh.local(part.shard_tensor(pm.plan, xp, 0))
        y = fn(pm.parts, xs)
        out["matvec"] = {"y": y.cpu(), "strategy": choice.strategy, "partition_s": build_s,
                         "stack": int(xs.shape[0]),
                         "ms": _event_ms(torch, dev, lambda: fn(pm.parts, xs))}
        del pm, fn, srv
        _free(torch, dev)
    out["calls"] = {str(k): dict(m.calls) for k, m in meshes.items()}
    out["seconds"] = time.perf_counter() - t_rank
    return out


def rank26_nccl(rank: int, world: int, init: str, payload: dict) -> dict:
    """Phase 26c: one NCCL rank (world 1, the calling process):
    ``bfs_multi`` on a 1-device ``RankMesh``, the collectives NCCL's."""
    import torch

    from repro_torch.core.rank_mesh import init_rank_mesh
    from repro_torch.graphs import bfs_multi

    dev = torch.device(payload["device"])
    mesh = init_rank_mesh((1,), ("batch",), "nccl", device=dev, init_method=init, rank=rank,
                          world_size=world)
    _sync(torch, dev)
    t0 = time.perf_counter()
    res = bfs_multi(payload["engine"], payload["sources"], mesh=mesh)
    _sync(torch, dev)
    return {"result": res, "ms": (time.perf_counter() - t0) * 1e3, "backend": mesh.backend,
            "calls": dict(mesh.calls)}


def rank_multi_phases(torch, dev, cit, stump, phase14: dict, walls24: dict, smi: str) -> dict:
    """Phase 26: the row-sharded traversals and the graph server on a
    process group, one gloo rank per position, the ranks sharing the one
    card (their walls are host-staged gloo on time-shared SMs, not a
    multi-card result). (a) cit-HP's bsr engines: bfs, sssp and ppr_multi
    at B = 32 over 4 ranks on ("batch",), then bfs at B = 6 over 8 ranks
    on (2, 4) with the tuple axis (ranks 6 and 7 hold no rows): every
    rank's result equal to phase 14's single-device batch (bfs, sssp
    ``torch.equal``; ppr within rtol 1e-3, atol 1e-6), each rank's first
    launch of kernels 1b and 2b held to its plain version, walls beside
    phase 24's virtual ones. (b) ``GraphQueryServer(mesh=RankMesh((4,)))``
    on the 4 ranks: mixed queries, every rank's payloads equal to each
    other's and to the mesh-less server's (PPR, on the csr route's atomic
    sums, within rtol 1e-3, atol 1e-6); ``partitioned_matvec`` through the
    server on the 8 ranks equal to the virtual mesh's block ``rank``. (c)
    One NCCL rank: ``bfs_multi`` on a 1-device ``RankMesh``. Returns the
    block kernels' launches and worst differences from the plain versions."""
    import importlib
    import os
    import tempfile

    import numpy as np
    import torch.distributed as tdist

    from repro_torch.core.mesh import Mesh
    from repro_torch.core.semiring import BOOL_OR_AND
    from repro_torch.graphs import bfs_multi, build_engine
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.serve.graph_engine import GraphQueryServer

    t_phase = time.perf_counter()
    src = str(Path(__file__).resolve().parent / "src")
    where = "cuda:0" if dev.type == "cuda" else "cpu"
    want = {app: phase14[f"{app} cit-HP"] for app in ("bfs", "sssp", "ppr")}
    b = len(want["bfs"][0])
    launches = {"semiring_spmv_padded_batch": 0, "semiring_spmspv_padded_batch": 0}
    worst = dict.fromkeys(launches, 0.0)
    rng = np.random.default_rng(SEED + 26)
    queries = serve_workload(cit, RANK_SERVE_QUERIES, SEED + 26)
    x_mv = (rng.random(cit.n) < 0.3).astype(np.int32)
    base = {"src": src, "device": where, "graph": cit, "stump": stump,
            "sources": {app: w[0] for app, w in want.items()}}
    print(f"phase 26: {smi}; the ranks time-share one card over gloo, each collective staged "
          "through pinned host buffers: their walls are not a multi-card result")

    def held_result(label, got, ref_, app):
        for field, g, w in zip(ref_._fields, got, ref_):
            w = w.cpu()
            check(g.shape == w.shape and g.dtype == w.dtype, f"{label}: {field} shape or dtype")
            if app == "ppr" and field in ("rank", "residual"):
                torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-6,
                                           msg=lambda m: f"{label} {field}: {m}")
            else:
                check(torch.equal(g, w), f"{label}: {field} differs from phase 14's "
                      "single-device batch")
        return all(torch.equal(g, w.cpu()) for g, w in zip(got, ref_))

    def take(res_ranks, phase):
        rows = []
        for r, res in enumerate(res_ranks):
            for k, v in res["launches"].items():
                launches[k] += v
            for k, v in res["errs"].items():
                worst[k] = max(worst[k], v)
            for run in res["runs"]:
                app, bb = run["app"], run["B"]
                ref_ = type(want[app][1])(*(t[:bb] for t in want[app][1]))
                label = f"phase {phase} rank {r} {app} B={bb} on {run['mesh']}"
                exact = held_result(label, run.pop("result"), ref_, app)
                check(run.pop("again_equal"), f"{label}: a second run differs from the first")
                levels = max(run["levels"], 1)
                blocks = sum(run["launches"].values())
                check(run["rows"] == 0 or blocks > 0, f"{label}: no block kernel launched on the "
                      f"rank's {run['rows']} rows")
                check(run["rows"] > 0 or blocks == 0, f"{label}: an empty share launched {blocks}")
                tests = run["levels"] + (run["levels"] < (50 if app == "ppr" else 64))
                check(run["collectives"] == {"all_true": tests, "gather_rows": 1},
                      f"{label}: collectives {run['collectives']}, expected {tests} stopping "
                      "tests and one gather")
                row = {"phase": phase, "rank": r, **run, "bit_equal": exact,
                       "launches_per_level": blocks / levels,
                       "host_syncs_per_level": run["host_syncs"] / levels,
                       "card": smi}
                if run["mesh"] == [4]:
                    row["virtual_wall_ms_D4_phase24"] = walls24.get(f"{app} D=4")
                    row["single_device_wall_ms_phase24"] = walls24.get(f"{app} D=1")
                rows.append(row)
                print(json.dumps(row))
        return rows

    # ---------------------------------------------------------------- 26a (4 ranks), 26b
    t0 = time.perf_counter()
    four = run_ranks(rank26_multi, 4, {**base, "runs": [(app, b, (4,), ("batch",), "batch")
                                                      for app in ("bfs", "sssp", "ppr")],
                                       "serve": queries}, timeout=600)
    spawn4_s = time.perf_counter() - t0
    rows4 = take(four, "26a")
    for name in launches:
        check(all(any(name in run["held"] for run in res["runs"]) for res in four),
              f"phase 26a: {name} was not held to its plain version on every rank")
    print(f"phase 26a: cit-HP bfs/sssp/ppr_multi at B = {b} over 4 gloo ranks equal phase 14's "
          f"single-device batch on every rank; ranks started and run in {spawn4_s:.1f} s")

    plain = GraphQueryServer(cit, stump, batch_size=SERVE_BATCH, device=dev)
    preqs = [plain.submit(a, s) for a, s in queries]
    t0 = time.perf_counter()
    plain.flush()
    plain_ms = (time.perf_counter() - t0) * 1e3
    first = four[0]["serve"]
    for r, res in enumerate(four):
        got = res["serve"]
        check(got["counters"] == dict(plain.counters) and got["lru"] == list(plain.cache._d.keys()),
              f"phase 26b rank {r}: counters or LRU keys differ from the mesh-less server's")
        for (a, s, q), p, (_, _, q0) in zip(got["payloads"], preqs, first["payloads"]):
            check((a, s) == (p.algorithm, p.source) and set(q) == set(p.result),
                  f"phase 26b rank {r}: request {a}/{s}")
            # csr/csc PPR: the ⟨+,×⟩ CSR reduce sums with atomics, so ranks
            # within rtol 1e-3, atol 1e-6 and the stop within one iteration,
            # as phase 24 holds them; every rank holds the same gathered bytes
            same_stop = q["iterations"] == p.result["iterations"]
            for key, w in p.result.items():
                check(np.array_equal(np.asarray(q[key]), np.asarray(q0[key])),
                      f"phase 26b rank {r} {a}/{s}: {key} differs from rank 0's")
                if a == "ppr" and key != "rank" and not same_stop:
                    check(key != "iterations" or abs(q[key] - w) <= 1,
                          f"phase 26b rank {r} ppr/{s}: iterations {q[key]} and {w}")
                elif a == "ppr" and key in ("rank", "residual"):
                    np.testing.assert_allclose(q[key], w, rtol=1e-3, atol=1e-6,
                                               err_msg=f"phase 26b rank {r} ppr/{s} {key}")
                else:
                    check(np.array_equal(np.asarray(q[key]), np.asarray(w)),
                          f"phase 26b rank {r} {a}/{s}: {key} differs")
        print(json.dumps({"phase": "26b", "rank": r, "queries": len(queries),
                          "flush_ms": got["flush_ms"], "plain_flush_ms": plain_ms,
                          "collectives": got["collectives"], "peak_bytes": got["peak_bytes"],
                          "counters": got["counters"], "card": smi}))
    del plain, preqs, four
    _free(torch, dev)

    # ---------------------------------------------------------------- 26a (8 ranks), 26b
    t0 = time.perf_counter()
    eight = run_ranks(rank26_multi, 8, {**base, "runs": [
        ("bfs", RANK_MULTI_B_SMALL, (2, 4), ("a", "b"), ("a", "b"))], "matvec": x_mv},
        timeout=600)
    spawn8_s = time.perf_counter() - t0
    rows8 = take(eight, "26a")
    for r in (6, 7):
        check(rows8[r]["rows"] == 0, f"phase 26a: rank {r} holds {rows8[r]['rows']} rows of 6")
    eng = build_engine(cit, BOOL_OR_AND, stump, device=dev, fmt_spmv="bsr", fmt_spmspv="bsr")
    srcs6 = want["bfs"][0][:RANK_MULTI_B_SMALL]
    vm = Mesh((2, 4), ("a", "b"), device=dev)
    bfs_multi(eng, srcs6, mesh=vm, axis_name=("a", "b"))   # the runner built, as on the ranks
    _sync(torch, dev)
    t0 = time.perf_counter()
    v6 = bfs_multi(eng, srcs6, mesh=vm, axis_name=("a", "b"))
    _sync(torch, dev)
    v6_ms = (time.perf_counter() - t0) * 1e3
    held_result("phase 26a virtual (2, 4) B=6", tuple(t.cpu() for t in v6),
                type(want["bfs"][1])(*(t[:6] for t in want["bfs"][1])), "bfs")
    print(json.dumps({"phase": "26a", "virtual": True, "app": "bfs", "B": 6, "mesh": [2, 4],
                      "warm_wall_ms": v6_ms, "card": smi}))
    srv = GraphQueryServer(cit, stump, device=dev)
    part = importlib.import_module("repro_torch.core.partition")
    pm, fn, choice = srv.partitioned_matvec("bfs", Mesh((2, 4), device=dev))
    xp = torch.zeros(pm.plan.shape[1], dtype=torch.int32, device=dev)
    xp[: cit.n] = torch.from_numpy(x_mv).to(dev)
    y_virtual = fn(pm.parts, part.shard_tensor(pm.plan, xp, 0)).cpu()
    for r, res in enumerate(eight):
        mv = res["matvec"]
        check(mv["stack"] == 1 and mv["strategy"] == choice.strategy,
              f"phase 26b rank {r}: partitioned_matvec built {mv['stack']} parts, strategy "
              f"{mv['strategy']}")
        check(torch.equal(mv["y"], y_virtual[r:r + 1]),
              f"phase 26b rank {r}: partitioned_matvec is not block {r} of the virtual mesh's")
    print(json.dumps({"phase": "26b", "partitioned_matvec": "bfs", "mesh": [2, 4],
                      "strategy": choice.strategy,
                      "rank_ms": [res["matvec"]["ms"] for res in eight],
                      "partition_s": [res["matvec"]["partition_s"] for res in eight],
                      "card": smi}))
    del pm, fn, srv, eight, y_virtual
    print(f"phase 26a: bfs_multi at B = 6 over 8 gloo ranks on (2, 4), tuple axis, equals phase "
          f"14's rows on every rank (ranks 6 and 7 empty); phase 26b: GraphQueryServer on 4 ranks "
          f"answered {len(queries)} queries as the mesh-less server, partitioned_matvec on 8 "
          f"ranks equals the virtual blocks; 8 ranks started and run in {spawn8_s:.1f} s")

    # ---------------------------------------------------------------- 26c
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            nccl = rank26_nccl(0, 1, "file://" + os.path.join(tmp, "rendezvous"),
                               {"device": where, "engine": eng, "sources": want["bfs"][0]})
        finally:
            if tdist.is_initialized():
                tdist.destroy_process_group()
    check(nccl["backend"] == "nccl", f"phase 26c: the process group is {nccl['backend']}")
    held_result("phase 26c NCCL rank", tuple(t.cpu() for t in nccl["result"]), want["bfs"][1],
                "bfs")
    levels = int(nccl["result"].iterations.max())
    check(nccl["calls"] == {"all_true": levels + (levels < 64), "gather_rows": 1},
          f"phase 26c: collectives {nccl['calls']}")
    print(json.dumps({"phase": "26c", "backend": "nccl", "world": 1, "B": b,
                      "wall_ms": nccl["ms"], "collectives": nccl["calls"],
                      "seconds": time.perf_counter() - t0, "card": smi}))
    del eng, nccl
    _free(torch, dev)
    print(f"phase 26c: one NCCL rank's bfs_multi equals phase 14's batch; phase 26: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "worst": worst, "rows": rows4 + rows8}


# ---------------------------------------------------------------- phase 27


def ckpt27_blocks(tree) -> dict:
    """{checkpoint key: a host copy of the blocks} of a mesh state's
    ``Sharded`` leaves, and {"plain:" key: a host copy} of its plain
    tensors."""
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.train import checkpoint as ckpt
    out = {}
    for k, v in ckpt._flatten(tree).items():
        if isinstance(v, Sharded):
            out[k] = v.blocks.detach().cpu()
        elif hasattr(v, "detach"):
            out["plain:" + k] = v.detach().cpu()
    return out


def ckpt27_drive(torch, mesh, dev, cfg, tcfg, batches, ckpt_dir: str, failure_at,
                 kernels=()) -> dict:
    """``TrainDriver`` on ``mesh`` from the model of seed ``SEED``,
    ``CKPT_STEPS`` steps, an async checkpoint every 4: losses, steps,
    restarts, the final blocks, kernels' launches (counted from 0 just
    before the run) and seconds; ``state`` is the live final state."""
    from repro_torch.distributed.fault_tolerance import FTConfig, TrainDriver
    from repro_torch.distributed.sharding import set_activation_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.train.train_loop import init_mesh_state, make_train_step
    model = build_model(cfg, device=dev).init(seed=SEED)
    params, opt = init_mesh_state(model, mesh)
    driver = TrainDriver(make_train_step(model, mesh, tcfg), lambda i: batches[i],
                         FTConfig(ckpt_dir=ckpt_dir, ckpt_every=4, async_save=True))
    _sync(torch, dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = driver.run(params, opt, CKPT_STEPS, failure_at=failure_at)
    _sync(torch, dev)
    seconds = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    set_activation_mesh(None)
    state = {"params": out["params"], "opt": out["opt_state"]}
    return {"losses": [h["loss"] for h in out["history"]],
            "steps": [h["step"] for h in out["history"]], "restarts": out["restarts"],
            "blocks": ckpt27_blocks(state), "launches": launches, "seconds": seconds,
            "state": state}


def ckpt27_restore(ckpt_dir: str, like, mesh, cfg) -> dict:
    """Checkpoint ``CKPT_STEPS`` restored into ``mesh``'s parameter and
    ZeRO-1 shardings: the blocks."""
    from repro_torch.distributed.sharding import param_shardings, zero1_shardings
    from repro_torch.models.transformer import model_specs
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptState
    specs = model_specs(cfg)
    z = zero1_shardings(mesh, specs)
    got, _ = ckpt.restore(ckpt_dir, CKPT_STEPS, like,
                          {"params": param_shardings(mesh, specs), "opt": OptState(None, z, z, z)})
    return ckpt27_blocks(got)


def ckpt27_launch(extra: list, ckpt_dir: str, steps: int, dev) -> dict:
    """The launcher (its default minitron at 0.05) for ``steps`` steps from
    ``ckpt_dir``: its losses and final blocks."""
    from repro_torch.launch.train import main as train_main
    out = train_main(["--steps", str(steps), "--device", str(dev), "--ckpt-dir", ckpt_dir]
                     + CKPT_LAUNCH + extra)
    return {"losses": [h["loss"] for h in out["history"]],
            "blocks": ckpt27_blocks({"params": out["params"], "opt": out["opt_state"]})}


def async27_serve(torch, dev, cit, stump, queries, delta, mesh=None, skew: float = 1.0) -> dict:
    """Phase 27c's workload: ``AsyncGraphServer`` on a ``FakeClock`` with
    cit-HP as one tenant (phase 17's csr/csc engines, ``mesh`` given or
    none): the first half of ``queries`` and PageRank, a ``mutate``, the
    second half, ``close()``; 30% of the queries with a deadline, the
    clock advanced by ``skew`` times a seeded step and the server polled
    after a quarter of them. Every flush's wall (host clock ending in a
    sync), the payloads, the tenant's SLO snapshot after every flush."""
    import numpy as np

    from repro_torch.serve.graph_engine import AsyncGraphServer
    from repro_torch.serve.scheduler import FakeClock
    clock = FakeClock()
    srv = AsyncGraphServer(clock=clock, max_pending=1024, max_wait=0.05)
    srv.add_tenant("cit", cit, stump=stump, batch_size=SERVE_BATCH, mesh=mesh, device=dev)
    rng = np.random.default_rng(SEED + 27)
    walls, snaps, tickets = [], [], []

    def timed(what: str, fn) -> None:
        _sync(torch, dev)
        t0 = time.perf_counter()
        n = fn()
        _sync(torch, dev)
        walls.append({"call": what, "tickets": n, "ms": (time.perf_counter() - t0) * 1e3})
        snaps.append(srv.stats("cit")["slo"])

    half = len(queries) // 2
    report = None
    for epoch, qs in enumerate((list(queries[:half]) + [("pagerank", None)], queries[half:])):
        for a, s in qs:
            dl = float(rng.uniform(0.005, 0.1)) if rng.random() < 0.3 else None
            tickets.append(srv.submit("cit", a, s, deadline=dl))
            if rng.random() < 0.25:
                clock.advance(float(rng.uniform(0.0, 0.08)) * skew)
                timed("poll", srv.poll)
        timed("drain", srv.drain)
        if epoch == 0:
            rep = {}
            timed("mutate", lambda: rep.update(srv.mutate("cit", delta)) or 0)
            report = rep
    timed("close", lambda: srv.close() or 0)
    return {"payloads": [(tk.algorithm, tk.source, tk.done(), tk.result) for tk in tickets],
            "walls": walls, "snapshots": snaps, "report": report,
            "slo": srv.stats("cit")["slo"]}


def rank27_state(torch, mesh, dev, cfg, ckpt_dir: str) -> dict:
    """Phase 27b on one rank: the full-width 2-layer model's parameters as
    (data 2, model 2) blocks, saved (rank 0 writes) and restored into zero
    blocks of the same shardings; the seconds, bytes received, host RSS
    and the restored blocks' equality."""
    import os
    import resource

    from repro_torch.convert import stack_model_params
    from repro_torch.distributed.sharding import Sharded, param_shardings, shard_state, tree_map
    from repro_torch.models.transformer import build_model, model_specs
    from repro_torch.train import checkpoint as ckpt

    def rss() -> dict:
        """Host bytes: the process's peak so far and its resident set now."""
        with open("/proc/self/statm") as f:
            now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        return {"peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024, "now": now}

    model = build_model(cfg, device=dev).init(seed=SEED)
    params = shard_state(stack_model_params(cfg, dict(model.named_parameters())),
                         param_shardings(mesh, model_specs(cfg)))
    del model
    _free(torch, dev)
    is_sharded = lambda x: isinstance(x, Sharded)          # noqa: E731
    like = tree_map(lambda s: Sharded(torch.zeros_like(s.blocks), s.sharding, s.shape), params,
                    is_leaf=is_sharded)
    out = {"rss_before": rss(), "block_bytes": sum(
        v.blocks.numel() * v.blocks.element_size() for v in ckpt._flatten(params).values())}
    wire0, calls0 = mesh.wire_bytes["gather_root"], mesh.calls["gather_root"]
    _sync(torch, dev)
    t0 = time.perf_counter()
    ckpt.save(ckpt_dir, 1, {"params": params})
    out["save_s"] = time.perf_counter() - t0
    out["rss_after_save"] = rss()
    out["received_bytes"] = mesh.wire_bytes["gather_root"] - wire0
    out["gathers"] = mesh.calls["gather_root"] - calls0
    mesh.share(b"")                         # rank 0's files are written before the reads
    if mesh.rank == 0:
        step = os.path.join(ckpt_dir, "step_1")
        out["disk_bytes"] = sum(os.path.getsize(os.path.join(step, f)) for f in os.listdir(step))
    t0 = time.perf_counter()
    got, _ = ckpt.restore(ckpt_dir, 1, {"params": like})
    _sync(torch, dev)
    out["restore_s"] = time.perf_counter() - t0
    out["rss_after_restore"] = rss()
    a, b = ckpt._flatten(got["params"]), ckpt._flatten(params)
    out["equal"] = a.keys() == b.keys() and all(torch.equal(a[k].blocks, b[k].blocks) for k in a)
    out["leaves"] = len(a)
    del params, like, got, a, b
    _free(torch, dev)
    return out


def rank27(rank: int, world: int, init: str, payload: dict) -> dict:
    """One of phase 27's 4 gloo ranks sharing the card. (a) ``TrainDriver``
    on (data 2, model 2) uninterrupted and with failures, the first launch
    of kernels 7 and 7ᵀ on rank 0 kept; the checkpoint restored onto (4,
    1) and (1, 4); the launcher on (2, 2), then relaunched on (4, 1).
    (c) ``async27_serve`` on ``RankMesh((4,), ("batch",))``, this rank's
    clock advancing 1 / (1 + ASYNC_SKEW · rank) as far as rank 0's.
    (b) ``rank27_state``. Then ranks 0 and 1, a world of 2 of their own,
    restore (a)'s checkpoint onto (2, 1)."""
    import os

    import torch
    import torch.distributed as tdist

    sys.path.insert(0, payload["src"])
    from repro_torch.core.rank_mesh import init_rank_mesh
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import rank_mesh

    dev = torch.device(payload["device"])
    t_rank = time.perf_counter()
    laps, t_lap = {}, [t_rank]

    def lap(part: str) -> None:
        now = time.perf_counter()
        laps[part] = now - t_lap[0]
        t_lap[0] = now

    work, cfg, tcfg = payload["dir"], payload["cfg"], payload["tcfg"]
    batches = [{k: v.to(dev) for k, v in b.items()} for b in payload["batches"]]
    kernels = rank_wrappers()
    k7 = (kernels[7], kernels[10])
    mesh = rank_mesh(2, 2, 0, "gloo", device=dev, init_method=init, rank=rank, world_size=world)
    out: dict = {"held": {}}

    # ---- 27a: rank 0 keeps the first launch of kernels 7 and 7ᵀ
    caught: dict = {}
    gather, backward = ops._moe_dispatch_gather, ops.moe_dispatch_gather_backward

    def first_gather(x, slot_tok, **hint):
        y = gather(x, slot_tok, **hint)
        caught.setdefault("moe_dispatch_gather", (x.detach().clone(), slot_tok.clone(), y.clone()))
        return y

    def first_backward(g, tok_slots):
        y = backward(g, tok_slots)
        caught.setdefault("moe_dispatch_gather_backward", (g.clone(), tok_slots.clone(),
                                                           y.clone()))
        return y

    if rank == 0:
        ops._moe_dispatch_gather, ops.moe_dispatch_gather_backward = first_gather, first_backward
    try:
        out["clean"] = ckpt27_drive(torch, mesh, dev, cfg, tcfg, batches,
                                    os.path.join(work, "clean"), None, k7)
    finally:
        ops._moe_dispatch_gather, ops.moe_dispatch_gather_backward = gather, backward
    for name, (a, b, y) in caught.items():
        plain = (ref.moe_dispatch_gather_ref if name == "moe_dispatch_gather"
                 else ref.moe_dispatch_gather_backward_ref)(a, b)
        _sync(torch, dev)
        out["held"][name] = {"equal": bool(torch.equal(y, plain)),
                             "max_abs_err": float((y.double() - plain.double()).abs().max())
                             if y.numel() else 0.0, "shape": list(a.shape)}
    del caught
    out["clean"].pop("state")
    lap("27a clean driver")
    out["faulty"] = ckpt27_drive(torch, mesh, dev, cfg, tcfg, batches,
                                 os.path.join(work, "faulty"), list(CKPT_FAILURES), k7)
    like = out["faulty"].pop("state")
    lap("27a faulty driver")
    out["restore"] = {shape: ckpt27_restore(os.path.join(work, "faulty"), like,
                                            rank_mesh(*shape, 0, "gloo", device=dev), cfg)
                      for shape in CKPT_SHAPES}
    lap("27a restores")
    first = ckpt27_launch(["--backend", "gloo", "--data", "2", "--model", "2"],
                          os.path.join(work, "launch"), 4, dev)
    tdist.init_process_group("gloo", init_method=init + "_relaunch", rank=rank, world_size=world)
    out["launcher"] = [first, ckpt27_launch(["--backend", "gloo", "--data", "4", "--model", "1"],
                                            os.path.join(work, "launch"), 8, dev)]
    lap("27a launcher")

    # ---- 27c, 27b on a process group of their own
    tdist.init_process_group("gloo", init_method=init + "_serve", rank=rank, world_size=world)
    m4 = init_rank_mesh((world,), ("batch",), "gloo", device=dev)
    shares0 = m4.calls["share"]
    out["async"] = async27_serve(torch, dev, payload["graph"], payload["stump"],
                                 payload["queries"], payload["delta"], mesh=m4,
                                 skew=1.0 / (1.0 + ASYNC_SKEW * rank))
    out["async"]["shares"] = m4.calls["share"] - shares0
    out["async"]["share_bytes"] = m4.wire_bytes["share"]
    _free(torch, dev)
    lap("27c")
    out["state"] = rank27_state(torch, rank_mesh(2, 2, 0, "gloo", device=dev), dev,
                                payload["big_cfg"], os.path.join(work, "state"))
    lap("27b")
    tdist.destroy_process_group()
    if rank < 2:
        tdist.init_process_group("gloo", init_method=init + "_two", rank=rank, world_size=2)
        out["restore"][(2, 1)] = ckpt27_restore(os.path.join(work, "faulty"), like,
                                                rank_mesh(2, 1, 0, "gloo", device=dev), cfg)
        lap("27a restore onto (2, 1)")
    out["laps"] = laps
    out["seconds"] = time.perf_counter() - t_rank
    return out


def rank_ckpt_phases(torch, dev, cit, stump, smi: str) -> dict:
    """Phase 27: one checkpoint for a whole rank mesh, restored onto rank
    meshes of other shapes, and ``AsyncGraphServer`` tenants on a
    ``RankMesh``, on 4 gloo ranks sharing the card (``rank27``), beside the
    virtual mesh's and the mesh-less server's twins run meanwhile in this
    process. (a) Phase 21d's config: ``TrainDriver`` with failures at
    steps 5 and 9 equal bit for bit to the uninterrupted 4-rank run and to
    the virtual mesh's driver; its checkpoint one directory, byte for byte
    the virtual mesh's; restored onto (4, 1), (1, 4) and (2, 1), each
    rank's blocks the virtual restore's; the launcher on (2, 2) relaunched
    on (4, 1) equal to the virtual sequence; kernels 7 and 7ᵀ launched in
    every rank's driver and their first launch on rank 0 equal to the
    plain versions. (b) Phase 25b's full-width 2-layer deepseek: its
    parameters (bf16) saved and restored on (data 2, model 2), with each
    rank's seconds, bytes and host RSS. (c) cit-HP served by
    ``AsyncGraphServer`` on ``RankMesh((4,), ("batch",))``, each rank's
    clock skewed: every rank's payloads equal the mesh-less server's,
    one shared decision a flush. Returns kernel 7's and 7ᵀ's launches."""
    import filecmp
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np

    from repro_torch.core.delta import EdgeDelta
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.launch.train import scaled_config
    from repro_torch.models.zoo import count_params, get_config
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainConfig

    t_phase = time.perf_counter()
    src = str(Path(__file__).resolve().parent / "src")
    where = "cuda:0" if dev.type == "cuda" else "cpu"
    full = get_config("deepseek-v2-lite-16b")
    small = scaled_config(full, 0.05)
    small = dataclasses.replace(small, moe=dataclasses.replace(small.moe, top_k=2))
    big = dataclasses.replace(full, n_layers=2)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    data = SyntheticLM(DataConfig(global_batch=8, seq_len=128, vocab=small.vocab, seed=SEED))
    host_batches = [{k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in data.batch(i, 0, 1).items()} for i in range(CKPT_STEPS)]
    queries = serve_workload(cit, ASYNC_QUERIES, SEED + 27)
    rng = np.random.default_rng(SEED + 27)
    ins = rng.integers(0, cit.n, (8, 2))
    delta = EdgeDelta(insert_rows=ins[:, 0], insert_cols=ins[:, 1],
                      delete_rows=cit.rows[:2], delete_cols=cit.cols[:2])
    work = tempfile.mkdtemp(prefix="phase27_")
    payload = {"src": src, "device": where, "dir": os.path.join(work, "ranks"), "cfg": small,
               "tcfg": tcfg, "batches": host_batches, "graph": cit, "stump": stump,
               "queries": queries, "delta": delta, "big_cfg": big}
    print(f"phase 27: {smi}; 4 gloo ranks time-share the card, each collective staged through "
          "pinned host buffers: their walls are not a multi-card result")
    got: dict = {}

    def ranks_run() -> None:
        try:
            got["ranks"] = run_ranks(rank27, 4, payload, timeout=300)
        except BaseException as e:          # re-raised in this thread below
            got["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    try:
        # the virtual mesh's and the mesh-less server's twins, meanwhile
        v_dir = os.path.join(work, "virtual")
        batches = [{k: v.to(dev) for k, v in b.items()} for b in host_batches]
        vm = small_mesh(2, 2, device=dev)
        v_drive = ckpt27_drive(torch, vm, dev, small, tcfg, batches,
                               os.path.join(v_dir, "faulty"), list(CKPT_FAILURES))
        like = v_drive.pop("state")
        v_restore = {shape: ckpt27_restore(os.path.join(v_dir, "faulty"), like,
                                           small_mesh(*shape, device=dev), small)
                     for shape in CKPT_SHAPES + [(2, 1)]}
        v_launch = [ckpt27_launch(["--data", "2", "--model", "2"],
                                  os.path.join(v_dir, "launch"), 4, dev),
                    ckpt27_launch(["--data", "4", "--model", "1"],
                                  os.path.join(v_dir, "launch"), 8, dev)]
        del like, batches
        v_async = async27_serve(torch, dev, cit, stump, queries, delta)
        v_s = time.perf_counter() - t_phase
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    ranks = got["ranks"]
    ranks_s = time.perf_counter() - t_phase

    def hold_blocks(g: dict, w: dict, r: int, what: str) -> None:
        check(g.keys() == w.keys(), f"{what} rank {r}: leaves differ")
        for k, v in w.items():
            check(torch.equal(g[k], v if k.startswith("plain:") else v[r:r + 1]),
                  f"{what} rank {r} {k}: not the virtual mesh's block")

    # ---- 27a
    launches = {"moe_dispatch_gather": 0, "moe_dispatch_gather_backward": 0}
    r_dir = payload["dir"]
    check(sorted(os.listdir(r_dir)) == ["clean", "faulty", "launch", "state"],
          f"phase 27a: the ranks' directory holds {sorted(os.listdir(r_dir))}")
    check(sorted(os.listdir(os.path.join(r_dir, "faulty")))
          == sorted(os.listdir(os.path.join(v_dir, "faulty")))
          == ["step_0", "step_12", "step_4", "step_8"],
          "phase 27a: the driver's checkpoints are not one directory a step, 0, 4, 8 and 12")
    a, b = (os.path.join(d, "faulty", f"step_{CKPT_STEPS}") for d in (r_dir, v_dir))
    names = sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    check(sorted(os.listdir(a)) == names and len(match) == len(names) and not mismatch
          and not errors, f"phase 27a: the ranks' checkpoint differs from the virtual mesh's "
          f"in {mismatch + errors}")
    for r, res in enumerate(ranks):
        clean, faulty = res["clean"], res["faulty"]
        check(clean["restarts"] == 0 and faulty["restarts"] == len(CKPT_FAILURES),
              f"phase 27a rank {r}: restarts {clean['restarts']} and {faulty['restarts']}")
        by_step = dict(zip(faulty["steps"], faulty["losses"]))
        check([by_step[i] for i in range(CKPT_STEPS)] == clean["losses"],
              f"phase 27a rank {r}: the restarted run's losses differ from the uninterrupted run's")
        check(clean["blocks"].keys() == faulty["blocks"].keys() and all(
            torch.equal(faulty["blocks"][k], v) for k, v in clean["blocks"].items()),
            f"phase 27a rank {r}: the restarted run's final blocks differ from the uninterrupted")
        check(faulty["losses"] == v_drive["losses"] and faulty["steps"] == v_drive["steps"],
              f"phase 27a rank {r}: the driver's losses differ from the virtual mesh's")
        hold_blocks(faulty["blocks"], v_drive["blocks"], r, "phase 27a driver")
        for shape, w in v_restore.items():
            if shape in res["restore"]:
                hold_blocks(res["restore"][shape], w, r, f"phase 27a restore onto {shape}")
        check(all(s in res["restore"] for s in CKPT_SHAPES) and ((2, 1) in res["restore"])
              == (r < 2), f"phase 27a rank {r}: restored onto {sorted(res['restore'])}")
        for part, (g, w) in enumerate(zip(res["launcher"], v_launch)):
            check(g["losses"] == w["losses"], f"phase 27a rank {r}: launcher part {part} losses "
                  f"{g['losses']}, the virtual {w['losses']}")
            hold_blocks(g["blocks"], w["blocks"], r, f"phase 27a launcher part {part}")
        for run in (clean, faulty):
            check(all(n > 0 for n in run["launches"]), f"phase 27a rank {r}: kernels 7 and 7ᵀ "
                  f"launched {run['launches']} in the driver")
            launches["moe_dispatch_gather"] += run["launches"][0]
            launches["moe_dispatch_gather_backward"] += run["launches"][1]
    check(len(v_launch[1]["losses"]) == 4, "phase 27a: the relaunch did not resume at step 4")
    held = ranks[0]["held"]
    check(set(held) == set(launches) and all(h["equal"] for h in held.values()),
          f"phase 27a rank 0: kernels 7 and 7ᵀ against their plain versions {held}")
    print(json.dumps({"phase": "27a", "config": "scaled_config(deepseek-v2-lite-16b, 0.05), top-2",
                      "params": count_params(small), "steps": CKPT_STEPS,
                      "failure_at": list(CKPT_FAILURES), "losses": v_drive["losses"],
                      "restored_onto": [list(s) for s in v_restore],
                      "launcher_losses": [v_launch[0]["losses"], v_launch[1]["losses"]],
                      "checkpoint_files": len(names), "held_rank0": held,
                      "driver_s": [[res["clean"]["seconds"], res["faulty"]["seconds"]]
                                   for res in ranks],
                      "virtual_driver_s": v_drive["seconds"], "card": smi}))

    # ---- 27c
    vp = v_async["payloads"]
    for r, res in enumerate(ranks):
        got_p = res["async"]["payloads"]
        check(len(got_p) == len(vp), f"phase 27c rank {r}: {len(got_p)} tickets")
        for (a, s, done, q), (_, _, _, p), (_, _, _, q0) in zip(got_p, vp,
                                                                ranks[0]["async"]["payloads"]):
            check(done and set(q) == set(p), f"phase 27c rank {r}: request {a}/{s}")
            # csr/csc PPR and PageRank sum with atomics: within rtol 1e-3, atol
            # 1e-6 and the stop within one iteration, as phase 26b holds them
            same_stop = q.get("iterations") == p.get("iterations")
            for key, w in p.items():
                if a in ("ppr", "pagerank") and key == "iterations":
                    check(abs(q[key] - w) <= 1, f"phase 27c rank {r} {a}/{s}: iterations")
                elif a in ("ppr", "pagerank") and (key in ("rank", "residual") or not same_stop):
                    np.testing.assert_allclose(q[key], w, rtol=1e-3, atol=1e-6,
                                               err_msg=f"phase 27c rank {r} {a}/{s} {key}")
                else:
                    check(np.array_equal(np.asarray(q[key]), np.asarray(w)),
                          f"phase 27c rank {r} {a}/{s}: {key} differs from the mesh-less server")
                if a != "pagerank":     # every rank holds the same gathered rows
                    check(np.array_equal(np.asarray(q[key]), np.asarray(q0[key])),
                          f"phase 27c rank {r} {a}/{s}: {key} differs from rank 0's")
        calls = [w["call"] for w in res["async"]["walls"]]
        check(res["async"]["shares"] == len(calls),
              f"phase 27c rank {r}: {res['async']['shares']} shares for {len(calls)} flushes")
        check([w["tickets"] for w in res["async"]["walls"]]
              == [w["tickets"] for w in ranks[0]["async"]["walls"]],
              f"phase 27c rank {r}: dispatched other tickets than rank 0")
        for snap in res["async"]["snapshots"]:
            check(snap["admitted"] == snap["dispatched"] + snap["pending"] + snap["abandoned"]
                  and snap["goodput"] + snap["deadline_misses"] + snap["no_deadline"]
                  == snap["resolved"] and snap["resolved"] <= snap["dispatched"],
                  f"phase 27c rank {r}: conservation fails in {snap}")
        s0 = ranks[0]["async"]["slo"]
        check(all(res["async"]["slo"][k] == s0[k] for k in ("admitted", "dispatched", "resolved")),
              f"phase 27c rank {r}: admitted, dispatched or resolved differ from rank 0's")
        check(res["async"]["report"] == v_async["report"], f"phase 27c rank {r}: mutate report")
        print(json.dumps({"phase": "27c", "rank": r, "queries": len(queries) + 1,
                          "flush_walls_ms": [[w["call"], w["tickets"], w["ms"]]
                                             for w in res["async"]["walls"]],
                          "shares": res["async"]["shares"],
                          "share_bytes_received": res["async"]["share_bytes"],
                          "slo": {k: res["async"]["slo"][k] for k in (
                              "admitted", "dispatched", "resolved", "goodput",
                              "deadline_misses", "no_deadline")}, "card": smi}))
    print(json.dumps({"phase": "27c", "mesh_less": True,
                      "flush_walls_ms": [[w["call"], w["tickets"], w["ms"]]
                                         for w in v_async["walls"]], "card": smi}))

    # ---- 27b
    for r, res in enumerate(ranks):
        st = res["state"]
        check(st["equal"], f"phase 27b rank {r}: the restored blocks differ from the saved")
        check(st["gathers"] == st["leaves"] and (st["received_bytes"] > 0) == (r == 0),
              f"phase 27b rank {r}: {st['gathers']} gathers, {st['received_bytes']} bytes")
        print(json.dumps({"phase": "27b", "rank": r, "arch": big.arch_id, "layers": 2,
                          "params": count_params(big), "saved": "parameters (bf16)", **st,
                          "laps": res["laps"], "rank_seconds": res["seconds"], "card": smi}))
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 27a: TrainDriver on 4 ranks restarted at steps 5 and 9 equals the uninterrupted "
          f"run and the virtual mesh bit for bit; one checkpoint directory, byte for byte the "
          f"virtual mesh's, restored onto {[list(s) for s in v_restore]}; the launcher resumed on "
          f"(4, 1); phase 27c: {len(queries) + 1} queries on the rank tenant equal the mesh-less "
          f"server's on every rank; phase 27b saved and restored {count_params(big):,} "
          f"parameters; phase 27: {seconds:.1f} s (the twins {v_s:.1f} s, the ranks "
          f"{ranks_s:.1f} s)")
    return launches


def stop_helpers() -> list:
    """Stop the helper processes of the ranks' launcher (``run_ranks``'
    fork server and multiprocessing's resource tracker), then terminate
    any other child process still alive, so the run leaves no process
    behind; returns the command lines of those others."""
    import multiprocessing.forkserver
    import multiprocessing.resource_tracker
    import os
    import signal

    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()
    alive = []
    for tid in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{tid}/children") as f:
            for pid in f.read().split():
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as c:
                        alive.append(c.read().replace(b"\0", b" ").decode().strip())
                    os.kill(int(pid), signal.SIGTERM)
                except OSError:         # it ended meanwhile
                    pass
    return alive


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import scipy.sparse

    from repro_torch.core import (
        SEMIRINGS, autotune_sell, build_bsr_padded, build_csr, frontier_from_dense, spmspv,
        spmv, spmv_csr,
    )
    from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, MIN_TIMES, PLUS_AND, PLUS_TIMES
    from repro_torch.graphs import (
        bfs, bfs_reference, build_engine, cc_reference, connected_components, generate, kcore,
        kcore_reference, largest_component_source, pagerank, pagerank_reference, ppr,
        ppr_reference, sssp, sssp_reference, trained_stump, triangle_count, triangle_reference,
    )
    from repro_torch.graphs.analytics import lower_triangle, triangle_problem
    from repro_torch.graphs.engine import edge_values
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.graphs.cost_model import kernel_stream_cost
    from repro_torch.kernels.semiring_spmv import (
        semiring_spmv_fused_padded, semiring_spmv_padded, semiring_spmv_sell,
    )
    from repro_torch.kernels.moe_dispatch import moe_dispatch_gather, moe_dispatch_gather_backward
    from repro_torch.core.spgemm import spgemm_masked
    from repro_torch.kernels import spgemm_binary, spgemm_tiles
    from repro_torch.kernels.spgemm_binary import semiring_spgemm_binary
    from repro_torch.kernels.spgemm_tiles import semiring_spgemm_padded
    from repro_torch.models.zoo import get_config
    from repro_torch.kernels.spmspv_tiles import (
        semiring_spmspv_fused_padded, semiring_spmspv_padded, semiring_spmspv_padded_batch,
    )
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded_batch

    dev = torch.device("cuda")
    t_main = time.perf_counter()
    marks: list = []

    def mark(phases: str) -> None:
        """When each group of phases starts, in seconds of the run (the
        1,200 s limit covers the whole run); ``phase_seconds`` is each
        group's span to the next mark."""
        t = time.perf_counter() - t_main
        marks.append((phases, t))
        print(f"[{t:.1f} s] phases {phases}", flush=True)

    kernels = (semiring_spmv_padded, semiring_spmspv_padded)
    fused_kernels = (semiring_spmv_fused_padded, semiring_spmv_sell,
                     semiring_spmspv_fused_padded)
    block_kernels = (semiring_spmv_padded_batch, semiring_spmspv_padded_batch)
    all_kernels = kernels + fused_kernels + (semiring_spgemm_padded, semiring_spgemm_binary,
                                             moe_dispatch_gather) + block_kernels + (
                                                 moe_dispatch_gather_backward,)

    # ---------------------------------------------------------------- 1
    mark("1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    # the ranks of phases 25-27 fork from a server that imports torch meanwhile
    from repro_torch.launch.ranks import run_ranks, start_rank_server
    start_rank_server()
    built: dict = {}

    def build() -> None:
        t = time.perf_counter()
        try:
            _build.build_all()
        except BaseException as e:              # re-raised once the build is joined
            built["error"] = e
        built["s"] = time.perf_counter() - t

    def dry_run() -> None:
        t = time.perf_counter()
        try:
            built["24b_s"] = run_ranks(rank24b_dryrun, 1, {"src": str(Path(__file__).resolve()
                                                                     .parent / "src")},
                                       timeout=600)[0]
        except BaseException as e:              # re-raised once the thread is joined
            built["24b_error"] = e
        # the process's start and its imports included
        built["24b_wall"] = time.perf_counter() - t

    # phase 24b's production meshes launch no hand-written kernel: they run
    # on the host, in a process of their own, while nvcc builds
    helpers = [threading.Thread(target=build), threading.Thread(target=dry_run)]
    t1 = time.perf_counter()
    for h in helpers:
        h.start()
    for h in helpers:
        h.join()
    for key in ("error", "24b_error"):
        if key in built:
            raise built[key]
    wall = time.perf_counter() - t1
    print(f"phase 1: kernels built in {built['s']:.1f} s; phase 24b's production meshes "
          f"{built['24b_s']:.1f} s in a process of their own ({built['24b_wall']:.1f} s with "
          f"its start) beside the build; both in {wall:.1f} s, "
          f"{built['s'] + built['24b_wall'] - wall:.1f} s less than one after the other")
    # per source: kernels compiled, the most registers any uses, and the
    # spill bytes (stores + loads) over all of them, from nvcc -Xptxas -v
    for src, log in _build.build_log.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))
        print(f"  {src}: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
              f"{spills} spill bytes, built in {_build.build_seconds.get(src, 0.0):.1f} s")

    mark("20")
    ssm_phases(torch, dev, PROMPT_LENS, MAX_NEW_TOKENS, MAX_SEQ, all_kernels)

    def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
        """Median of ``reps`` single-call CUDA-event timings after warm-up."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return statistics.median(ts)

    def compare(y, y_plain, sr, what: str, nan: bool = False) -> float:
        """Hold a kernel output to its plain version (``nan``: NaN where it
        is NaN); max |diff| over entries finite in both."""
        torch.cuda.synchronize()
        if sr.name == "plus_times":
            torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-6, equal_nan=True,
                                       msg=lambda m: f"{what}: {m}")
        elif nan:
            torch.testing.assert_close(y, y_plain, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"{what}: {m}")
        else:
            check(torch.equal(y, y_plain), f"{what}: kernel differs from the plain version")
        fin = torch.isfinite(y.double()) & torch.isfinite(y_plain.double())
        diff = (y.double() - y_plain.double()).abs()[fin]
        return float(diff.max()) if diff.numel() else 0.0

    weighted = {"min_plus": True, "min_times": True}

    def values(g, sr):
        """Edge values per semiring: integer weights for the min
        semirings, column-stochastic for ⟨+,×⟩, ones otherwise."""
        return edge_values(g, sr, weighted=weighted.get(sr.name, False), seed=5,
                           normalize=sr.name == "plus_times")

    def transposed(g, sr, block, vals):
        return build_bsr_padded(g.cols.astype(np.int32), g.rows.astype(np.int32), vals,
                                (g.n, g.n), sr, block=block, device=dev)

    def transposed_sell(g, sr, vals):
        """sell-C-σ of the transposed adjacency at the engine's 128×128
        tile, with the (C, σ) sweep of benchmarks/roofline.py."""
        return autotune_sell(g.cols.astype(np.int32), g.rows.astype(np.int32), vals,
                             (g.n, g.n), sr, blocks=((128, 128),), cs=(4, 8, 16),
                             sigmas=(None, 64), device=dev)

    def random_x(rng, sr, n):
        if sr.dtype == torch.int32:
            v = rng.integers(0, 2, n).astype(np.int32)
        elif sr.name == "plus_times":
            v = rng.random(n).astype(np.float32)
        else:
            v = rng.uniform(1.0, 10.0, n).astype(np.float32)
        return torch.from_numpy(v).to(dev)

    def sparse_x(rng, sr, x, n_true, density):
        xs = x.clone()
        keep = torch.from_numpy(rng.random(x.shape[0]) < density).to(dev)
        keep[n_true:] = False
        xs[~keep] = sr.zero
        return xs

    def bound(nbytes: int, ops: int, rate: float = FP32_OPS_PER_S) -> tuple[float, str]:
        """Least time for the work, in ms, and what sets it: the bytes over
        the memory rate or the operations over ``rate`` (fp32 by default)."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def library_bsr(a, sr):
        """torch.sparse_bsr_tensor over the real tiles (pads dropped)."""
        real = (a.tiles != sr.zero).flatten(2).any(dim=2)           # [mb, T]
        crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          real.sum(dim=1).cumsum(0)])
        return torch.sparse_bsr_tensor(crow, a.tile_cols[real].long(), a.tiles[real],
                                       size=a.shape, check_invariants=False)

    # ---------------------------------------------------------------- 2
    mark("2")
    rng = np.random.default_rng(SEED)
    cit = generate("cit-HP", 1.0, SEED)
    worst = {k.__name__: 0.0 for k in kernels}
    summary = {}
    for name, sr in SEMIRINGS.items():
        a = transposed(cit, sr, (128, 128), values(cit, sr))
        mb, t, bm, bn = a.tiles.shape
        x = random_x(rng, sr, a.shape[1])
        lib = library_bsr(a, sr) if name == "plus_times" else None
        y = semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)
        err = compare(y, ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr), sr,
                      f"spmv {name} cit-HP")
        if lib is not None:
            torch.testing.assert_close((lib @ x[:, None])[:, 0], y, rtol=1e-4, atol=1e-6)
        nbytes = a.tiles.numel() * 4 + a.tile_cols.numel() * 4 + x.numel() * 4 + mb * bm * 4
        bound_ms, bound_by = bound(nbytes, 2 * a.tiles.numel())
        row = {"kernel": "semiring_spmv_padded", "semiring": name, "graph": "cit-HP",
               "tiles": [mb, t, bm, bn], "max_abs_err": err,
               "ms": time_ms(lambda: semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)),
               "plain_ms": time_ms(lambda: ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr),
                                   reps=PLAIN_REPS, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(lambda: lib @ x[:, None]) if lib is not None else None,
               "real_slots": int(lib.values().shape[0]) if lib is not None else None}
        worst["semiring_spmv_padded"] = max(worst["semiring_spmv_padded"], err)
        print(json.dumps(row))
        if lib is not None:
            summary["semiring_spmv_padded"] = row
        for d in DENSITIES:
            f = frontier_from_dense(sparse_x(rng, sr, x, cit.n, d)[: cit.n], sr)
            meta = ops._spmspv_meta(a, f, sr)
            xd = ops._dense_frontier(a, f, sr)
            y = semiring_spmspv_padded(a.tiles, meta, xd, sr=sr)
            err = compare(y, ref.spmspv_padded_ref(a.tiles, meta, xd, sr), sr,
                          f"spmspv {name} cit-HP density {d}")
            n_active = int(meta[:, 0].sum())
            nbytes = (n_active * bm * bn * 4 + meta.numel() * 4 + xd.numel() * 4
                      + mb * bm * 4)
            bound_ms, bound_by = bound(nbytes, 2 * n_active * bm * bn)
            row = {"kernel": "semiring_spmspv_padded", "semiring": name, "graph": "cit-HP",
                   "density": d, "n_active": n_active, "max_abs_err": err,
                   "ms": time_ms(lambda: semiring_spmspv_padded(a.tiles, meta, xd, sr=sr)),
                   "plain_ms": time_ms(lambda: ref.spmspv_padded_ref(a.tiles, meta, xd, sr),
                                       reps=PLAIN_REPS, warmup=1),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": time_ms(lambda: lib @ xd[:, None]) if lib is not None else None}
            worst["semiring_spmspv_padded"] = max(worst["semiring_spmspv_padded"], err)
            print(json.dumps(row))
            if lib is not None and d == 0.05:
                summary["semiring_spmspv_padded"] = row
        del a, x, y, lib
        torch.cuda.empty_cache()

    caq = generate("ca-Q", 1.0, SEED)
    for name, sr in SEMIRINGS.items():
        a = transposed(caq, sr, (16, 16), values(caq, sr))
        x = random_x(rng, sr, a.shape[1])
        err = compare(semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr),
                      ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr), sr,
                      f"spmv {name} ca-Q 16x16")
        worst["semiring_spmv_padded"] = max(worst["semiring_spmv_padded"], err)
        for d in DENSITIES:
            f = frontier_from_dense(sparse_x(rng, sr, x, caq.n, d)[: caq.n], sr)
            meta, xd = ops._spmspv_meta(a, f, sr), ops._dense_frontier(a, f, sr)
            err = compare(semiring_spmspv_padded(a.tiles, meta, xd, sr=sr),
                          ref.spmspv_padded_ref(a.tiles, meta, xd, sr), sr,
                          f"spmspv {name} ca-Q 16x16 density {d}")
            worst["semiring_spmspv_padded"] = max(worst["semiring_spmspv_padded"], err)
        print(f"phase 2: ca-Q {tuple(a.tiles.shape)} at 16x16 tiles, {name}: both kernels "
              "match the plain version")
    print(f"phase 2: max |kernel - plain| {json.dumps(worst)}")

    # ---------------------------------------------------------------- 3, 4
    mark("3, 4")
    stump = trained_stump()
    for k in all_kernels:
        k.launches = 0
    traversals = []

    def run(label, g, sr, app, **build_kw):
        torch.cuda.reset_peak_memory_stats()
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        eng = build_engine(g, sr, stump, fmt_spmv="bsr", fmt_spmspv="bsr", **build_kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = app(eng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        its = res.iterations
        row = {"traversal": label, "graph": g.name, "n": g.n, "nnz": g.nnz,
               "graph_class": eng.graph_class, "threshold": eng.threshold,
               "n_pad": eng.n, "build_s": build_s,
               "wall_ms": wall_ms, "iterations": its,
               "kernel_used": res.kernel_used[:its].tolist(),
               "launches": {k.__name__: k.launches - b for k, b in zip(kernels, before)},
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del eng
        torch.cuda.empty_cache()
        traversals.append(row)
        print(json.dumps(row))
        return res

    src = largest_component_source(cit)
    res = run("bfs", cit, BOOL_OR_AND, lambda e: bfs(e, src))
    check(np.array_equal(res.levels.cpu().numpy(), bfs_reference(cit.rows, cit.cols, cit.n, src)),
          "cit-HP BFS levels differ from the oracle")
    res = run("sssp", cit, MIN_PLUS, lambda e: sssp(e, src), weighted=True, seed=5)
    w = edge_values(cit, MIN_PLUS, weighted=True, seed=5)
    check(np.array_equal(res.dist.cpu().numpy(),
                         sssp_reference(cit.rows, cit.cols, w, cit.n, src).astype(np.float32)),
          "cit-HP SSSP distances differ from Dijkstra")
    res = run("ppr", cit, PLUS_TIMES, lambda e: ppr(e, src), normalize=True)
    np.testing.assert_allclose(res.rank.cpu().numpy(),
                               ppr_reference(cit.rows, cit.cols, cit.n, src, sparse=True),
                               rtol=1e-3, atol=1e-6)
    print("phase 3: cit-HP BFS/SSSP/PPR match the oracles")

    rtx = generate("r-TX", 1.0, SEED)
    src = largest_component_source(rtx)
    res = run("bfs", rtx, BOOL_OR_AND, lambda e: bfs(e, src, max_iters=RTX_MAX_ITERS))
    want = bfs_reference(rtx.rows, rtx.cols, rtx.n, src)
    want = np.where(want > RTX_MAX_ITERS, -1, want)
    check(np.array_equal(res.levels.cpu().numpy(), want),
          "r-TX BFS levels differ from the oracle clipped to max_iters")
    print(f"phase 4: r-TX BFS matches the oracle over {RTX_MAX_ITERS} levels")

    launches = {k.__name__: k.launches for k in kernels}
    print(f"phase 5: launches on the main path {json.dumps(launches)}")
    for k in kernels:
        check(k.launches > 0, f"{k.__name__} was not launched on the main path")
    for k in block_kernels:
        check(k.launches == 0, f"{k.__name__} was launched by a single-source traversal")

    # ---------------------------------------------------------------- 6, 7, 8
    mark("6, 7, 8")
    tally = {k.__name__: 0 for k in all_kernels}

    def main_path(fn):
        """Run ``fn`` with every launch counter set to 0 just before it,
        read the counters just after it and add them to the tally."""
        for k in all_kernels:
            k.launches = 0
        out = fn()
        for k in all_kernels:
            tally[k.__name__] += k.launches
        return out

    def same(y, y_ref, what: str) -> None:
        torch.cuda.synchronize()
        check(torch.equal(y, y_ref), what)

    def fused_bound(stats: dict, index_entries: int) -> tuple[float, str]:
        """The ported stream stats' fused bytes plus the index entries the
        kernel reads, against the fp32 rate for the real slots' operations."""
        return bound(stats["fused_bytes"] + 4 * index_entries, stats["ops"])

    for k in fused_kernels:
        worst[k.__name__] = 0.0
    for name, sr in SEMIRINGS.items():
        vals = values(cit, sr)
        a = transposed(cit, sr, (128, 128), vals)
        sell, report = transposed_sell(cit, sr, vals)
        mb, t, bm, bn = a.tiles.shape
        x = random_x(rng, sr, a.shape[1])
        fronts = [frontier_from_dense(sparse_x(rng, sr, x, cit.n, d)[: cit.n], sr)
                  for d in DENSITIES]
        y3, y3c, y4, y4c, y5s = main_path(lambda: (
            spmv(a, x, sr, impl="fused"), ops.semiring_spmv_fused(a, x, sr, chunks=2),
            ops.semiring_spmv_sliced(sell, x, sr), ops.semiring_spmv_sliced(sell, x, sr, chunks=2),
            [(spmspv(a, f, sr, impl="fused"), ops.semiring_spmspv_fused(a, f, sr, chunks=2))
             for f in fronts]))
        y1 = semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)
        meta3 = ops._spmv_fused_meta(a)
        for y, yc, k in ((y3, y3c, "semiring_spmv_fused_padded"), (y4, y4c, "semiring_spmv_sell")):
            same(y, y1, f"{k} {name} cit-HP is not equal to kernel 1")
            same(yc, y1.view(2, -1), f"{k} {name} cit-HP chunks=2 is not kernel 1's rows")
        err3 = compare(y3, ref.spmv_fused_padded_ref(a.tiles, meta3, x, sr), sr,
                       f"fused spmv {name} cit-HP")
        err4 = compare(y4, ref.spmv_sell_ref(sell.tiles, sell.tile_cols, sell.row_meta, x, sr),
                       sr, f"sell spmv {name} cit-HP")
        worst["semiring_spmv_fused_padded"] = max(worst["semiring_spmv_fused_padded"], err3)
        worst["semiring_spmv_sell"] = max(worst["semiring_spmv_sell"], err4)
        lib = library_bsr(a, sr) if name == "plus_times" else None
        lib_ms = time_ms(lambda: lib @ x[:, None]) if lib is not None else None
        st3, st4 = ops.spmv_stream_stats(a), ops.sell_stream_stats(sell, a)
        real = sell.real_slots
        bound3, by3 = fused_bound(st3, mb + real)
        bound4, by4 = fused_bound(st4, 3 * mb + real)
        rows = [
            {"kernel": "semiring_spmv_fused_padded", "semiring": name, "graph": "cit-HP",
             "real_slots": real, "ell_slots": mb * t, "max_abs_err": err3,
             "ms": time_ms(lambda: semiring_spmv_fused_padded(a.tiles, meta3, x, sr=sr)),
             "kernel1_ms": time_ms(lambda: semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)),
             "plain_ms": time_ms(lambda: ref.spmv_fused_padded_ref(a.tiles, meta3, x, sr),
                                 reps=PLAIN_REPS, warmup=1),
             "bound_ms": bound3, "bound_by": by3, "library_ms": lib_ms},
            {"kernel": "semiring_spmv_sell", "semiring": name, "graph": "cit-HP",
             "c": sell.slice_height, "sigma": sell.sigma, "slot_total": sell.slot_total,
             "real_slots": real, "sell_bytes": sell.tiles.numel() * 4,
             "ell_bytes": a.tiles.numel() * 4, "max_abs_err": err4,
             "ms": time_ms(lambda: semiring_spmv_sell(sell.tiles, sell.tile_cols, sell.row_meta,
                                                      x, sr=sr)),
             "plain_ms": time_ms(lambda: ref.spmv_sell_ref(sell.tiles, sell.tile_cols,
                                                           sell.row_meta, x, sr),
                                 reps=PLAIN_REPS, warmup=1),
             "bound_ms": bound4, "bound_by": by4, "library_ms": lib_ms}]
        for f, d, (y5, y5c) in zip(fronts, DENSITIES, y5s):
            meta, xd = ops._spmspv_meta(a, f, sr), ops._dense_frontier(a, f, sr)
            same(y5, semiring_spmspv_padded(a.tiles, meta, xd, sr=sr),
                 f"fused spmspv {name} cit-HP density {d} is not equal to kernel 2")
            same(y5c, y5.view(2, -1), f"fused spmspv {name} cit-HP density {d} chunks=2")
            err5 = compare(y5, ref.spmspv_padded_ref(a.tiles, meta, xd, sr), sr,
                           f"fused spmspv {name} cit-HP density {d}")
            worst["semiring_spmspv_fused_padded"] = max(worst["semiring_spmspv_fused_padded"],
                                                        err5)
            n_active = int(meta[:, 0].sum())
            bound5, by5 = fused_bound(ops.spmspv_stream_stats(a, f, sr), mb + 2 * n_active)
            rows.append(
                {"kernel": "semiring_spmspv_fused_padded", "semiring": name, "graph": "cit-HP",
                 "density": d, "n_active": n_active, "max_abs_err": err5,
                 "ms": time_ms(lambda: semiring_spmspv_fused_padded(a.tiles, meta, xd, sr=sr)),
                 "plain_ms": time_ms(lambda: ref.spmspv_padded_ref(a.tiles, meta, xd, sr),
                                     reps=PLAIN_REPS, warmup=1),
                 "bound_ms": bound5, "bound_by": by5,
                 "library_ms": time_ms(lambda: lib @ xd[:, None]) if lib is not None else None})
        for row in rows:
            print(json.dumps(row))
            if name == "plus_times" and row.get("density", 0.05) == 0.05:
                summary[row["kernel"]] = row
        del a, sell, x, fronts, y1, y3, y3c, y4, y4c, y5s, lib
        torch.cuda.empty_cache()
    print("phase 6: cit-HP kernels 3 and 4 equal kernel 1 and kernel 5 equals kernel 2 for "
          "all five semirings, chunks=2 included; all three match their plain versions")

    sr = BOOL_OR_AND
    a = transposed(rtx, sr, (128, 128), values(rtx, sr))
    x = random_x(rng, sr, a.shape[1])
    fronts = [frontier_from_dense(sparse_x(rng, sr, x, rtx.n, d)[: rtx.n], sr) for d in DENSITIES]
    y3, y5s = main_path(lambda: (spmv(a, x, sr, impl="fused"),
                                 [spmspv(a, f, sr, impl="fused") for f in fronts]))
    same(y3, semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr),
         "fused spmv r-TX is not equal to kernel 1")
    compare(y3, ref.spmv_fused_padded_ref(a.tiles, ops._spmv_fused_meta(a), x, sr), sr,
            "fused spmv r-TX")
    for f, d, y5 in zip(fronts, DENSITIES, y5s):
        meta, xd = ops._spmspv_meta(a, f, sr), ops._dense_frontier(a, f, sr)
        same(y5, semiring_spmspv_padded(a.tiles, meta, xd, sr=sr),
             f"fused spmspv r-TX density {d} is not equal to kernel 2")
        compare(y5, ref.spmspv_padded_ref(a.tiles, meta, xd, sr), sr, f"fused spmspv r-TX {d}")
    print(f"phase 7: r-TX {tuple(a.tiles.shape)} bool_or_and: kernel 3 equals kernel 1, "
          "kernel 5 equals kernel 2 at every density")
    del a, x, fronts, y3, y5s
    torch.cuda.empty_cache()

    g18 = generate("g-18", 1.0, SEED)
    rows_np, cols_np = g18.cols.astype(np.int64), g18.rows.astype(np.int64)
    for sr in (PLUS_TIMES, BOOL_OR_AND):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if sr is PLUS_TIMES:
            vals = rng.integers(1, 9, g18.nnz).astype(np.float32)
        else:
            vals = values(g18, sr)
        sell, report = transposed_sell(g18, sr, vals)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        mb, (bm, bn) = sell.n_block_rows, sell.block
        n_pad = sell.shape[1]
        if sr is PLUS_TIMES:
            xv = rng.integers(0, 9, n_pad).astype(np.float32)
        else:
            xv = rng.integers(0, 2, n_pad).astype(np.int32)
        x = torch.from_numpy(xv).to(dev)
        y4 = main_path(lambda: ops.semiring_spmv_sliced(sell, x, sr))
        if sr is PLUS_TIMES:
            oracle = np.zeros(n_pad, np.float32)
            np.add.at(oracle, rows_np, vals * xv[cols_np])
            same(y4, torch.from_numpy(oracle).to(dev),
                 "sell spmv g-18 plus_times differs from the integer numpy oracle")
        else:
            csr = build_csr(rows_np.astype(np.int32), cols_np.astype(np.int32), vals,
                            (g18.n, g18.n), sr, device=dev)
            same(y4[: g18.n], spmv_csr(csr, x[: g18.n], sr),
                 "sell spmv g-18 bool_or_and differs from the CSR SpMV")
            check(not y4[g18.n:].any(), "sell spmv g-18: rows past n are not zero")
            del csr
        err4 = compare(y4, ref.spmv_sell_ref(sell.tiles, sell.tile_cols, sell.row_meta, x, sr),
                       sr, f"sell spmv {sr.name} g-18")
        worst["semiring_spmv_sell"] = max(worst["semiring_spmv_sell"], err4)
        real = sell.real_slots
        width = int(sell.row_meta[:, 2].max())
        cost = kernel_stream_cost(mb, width, real, sell.block, n_pad)
        bound4, by4 = bound(cost["fused_bytes"] + 4 * (real + 3 * mb), 2 * real * bm * bn)
        row = {"kernel": "semiring_spmv_sell", "semiring": sr.name, "graph": "g-18",
               "n": g18.n, "nnz": g18.nnz, "mb": mb, "ell_width": width,
               "c": sell.slice_height, "sigma": sell.sigma, "slot_total": sell.slot_total,
               "real_slots": real, "ell_bytes_needed": mb * width * bm * bn * 4,
               "sell_bytes": sell.tiles.numel() * 4, "build_s": build_s,
               "max_memory_allocated": torch.cuda.max_memory_allocated(), "max_abs_err": err4,
               "ms": time_ms(lambda: semiring_spmv_sell(sell.tiles, sell.tile_cols,
                                                        sell.row_meta, x, sr=sr)),
               "plain_ms": time_ms(lambda: ref.spmv_sell_ref(sell.tiles, sell.tile_cols,
                                                             sell.row_meta, x, sr),
                                   reps=PLAIN_SLOW_REPS, warmup=1),
               "bound_ms": bound4, "bound_by": by4, "library_ms": None}
        print(json.dumps(row))
        del sell, x, y4
        torch.cuda.empty_cache()
    print("phase 8: g-18 sell-C-σ matches the integer oracle (plus_times) and the CSR SpMV "
          "(bool_or_and); no library time: a BSR copy of the real tiles is another 40 GB")

    print(f"phases 6-8: launches on the fused path {json.dumps(tally)}")
    for k in fused_kernels:
        check(tally[k.__name__] > 0, f"{k.__name__} was not launched on the fused path")
        launches[k.__name__] = tally[k.__name__]

    # ---------------------------------------------------------------- 9
    mark("9")
    spgemm_kernels = (semiring_spgemm_padded, semiring_spgemm_binary)

    def spgemm_bounds(a, bp, mk, meta, sr) -> dict:
        """Bounds of one masked tile SpGEMM from ``ops.spgemm_stream_stats``:
        the work the function needs, the real slots of each active output
        tile (a pad slot adds one precomputed row) and the bytes of those
        slots, B's met blocks, the mask and the output, each moved once;
        kernel 6's at the int32 or fp32 rate of the CUDA cores, the
        variant's at the int8 tensor-core rate."""
        st = ops.spgemm_stream_stats(a, meta, bp, mk)
        rate = INT32_OPS_PER_S if sr.dtype == torch.int32 else FP32_OPS_PER_S
        return {"semiring_spgemm_padded": bound(st["real_bytes"], 2 * st["real_macs"], rate),
                "semiring_spgemm_binary": bound(st["real_bytes"], 2 * st["real_macs"],
                                                INT8_OPS_PER_S),
                "stats": st}

    def tolerance_ratio(y, want) -> float:
        """Worst |y − want| / (atol + rtol·|want|) under ⟨+,×⟩'s tolerance
        (rtol 1e-5, atol 1e-6) over entries finite in both: above 1 the
        comparison fails."""
        y, want = y.double(), want.double()
        fin = torch.isfinite(y) & torch.isfinite(want)
        r = ((y - want).abs() / (1e-6 + 1e-5 * want.abs()))[fin]
        return float(r.max()) if r.numel() else 0.0

    def kernel6_paths(a, meta, bp, mk, sr, bn, what: str):
        """Kernel 6 with its path counts set to 0 first: the output and
        {path: (tile, slot) pairs} it reported. Fails unless it folded each
        active tile's real slots once and one pad row per pad slot."""
        semiring_spgemm_padded.paths = dict.fromkeys(spgemm_tiles.PATHS, 0)
        y = semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr, bn=bn)
        paths = {k: int(v) for k, v in semiring_spgemm_padded.paths.items()}
        t = a.tiles.shape[1]
        act = (meta[:, t:] > 0).sum(dim=1)
        real = int((ref.ell_n_real(meta[:, :t]).long() * act).sum())
        check(paths["real"] == real and paths["pad"] == int(act.sum()) * t - real,
              f"{what}: kernel 6 reported {paths}, not {real} real and "
              f"{int(act.sum()) * t - real} pad pairs")
        return y, paths

    def spgemm_domain(sr, n: int, gen):
        """A's values, a dense B [n, n] and a mask [n, n] of density 0.4 in
        the semiring's safe domain, as tests/test_spgemm.py::make_problem
        makes them (min_times operands stay strictly positive)."""
        def u():
            return torch.rand((n, n), generator=gen, device=dev)

        if sr.collective == "pmin":
            vals = rng.integers(1, 9, caq.nnz).astype(np.float32)
            b = torch.randint(1, 9, (n, n), generator=gen, device=dev).float()
            mask = torch.where(u() < 0.4, 1.0, float("inf"))
        elif sr.dtype == torch.int32:
            vals = np.ones(caq.nnz, np.int32)
            b, mask = (u() < 0.4).int(), (u() < 0.4).int()
        else:
            vals = rng.random(caq.nnz).astype(np.float32)
            b, mask = u(), (u() < 0.4).float()
        return vals, b, mask

    def kernel6_library_row(a, bp, mk, meta, bn, sr, vals, b, mask, y) -> dict:
        """Kernel 6 on operands it serves (ca-Q ⟨+,×⟩ f32, masked) against
        the one library call for that function: cuSPARSE's sampled
        product ``torch.sparse.sampled_addmm`` with the mask as CSR and
        A densified before the timing. ⟨min,+⟩ and the other semirings
        have no such call."""
        n = caq.n
        a_dense = torch.zeros((n, n), dtype=torch.float32, device=dev)
        a_dense.index_put_((torch.from_numpy(caq.rows.astype(np.int64)).to(dev),
                            torch.from_numpy(caq.cols.astype(np.int64)).to(dev)),
                           torch.from_numpy(vals).to(dev), accumulate=True)
        mask_csr = mask.to_sparse_csr()

        def lib():
            return torch.sparse.sampled_addmm(mask_csr, a_dense, b, beta=0.0)

        lib_diff = compare(lib().to_dense(), y[:n, :n].contiguous(), sr,
                           "kernel 6 ca-Q plus_times: torch.sparse.sampled_addmm")
        bound_ms, bound_by = spgemm_bounds(a, bp, mk, meta, sr)["semiring_spgemm_padded"]
        # the launch alone into an output filled once, held to the wrapper's
        out = torch.full_like(mk, sr.zero)

        def launch_only():
            spgemm_tiles._launch(a.tiles, meta, bp, mk, out, sr)

        launch_only()
        same(out, y, "kernel 6 ca-Q plus_times: the launch alone differs from the wrapper")
        row = {"kernel": "semiring_spgemm_padded", "semiring": sr.name, "graph": "ca-Q",
               "tiles": list(a.tiles.shape), "mask_nnz": mask_csr.values().numel(),
               "max_row_degree": int(np.bincount(caq.rows).max()),
               "ms": time_ms(lambda: semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr,
                                                            bn=bn)),
               "launch_ms": time_ms(launch_only),
               "plain_ms": time_ms(lambda: ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn),
                                   reps=PLAIN_SLOW_REPS, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(lib), "library": "torch.sparse.sampled_addmm",
               "library_max_abs_diff": lib_diff,
               "library_tolerance_ratio": tolerance_ratio(y[:n, :n], lib().to_dense())}
        print(json.dumps(row))
        del a_dense, mask_csr, out
        return row

    def kernel6_row(a, bp, mk, meta, bn, sr, label: str) -> dict:
        """Kernel 6 on ca-Q 64×64 operands of a semiring no library call
        computes: its time, its plain version's, its bound."""
        bound_ms, bound_by = spgemm_bounds(a, bp, mk, meta, sr)["semiring_spgemm_padded"]
        row = {"kernel": "semiring_spgemm_padded", "semiring": sr.name, "graph": "ca-Q",
               "case": label, "tiles": list(a.tiles.shape),
               "ms": time_ms(lambda: semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr,
                                                            bn=bn)),
               "plain_ms": time_ms(lambda: ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn),
                                   reps=PLAIN_SLOW_REPS, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        row["share_of_bound"] = bound_ms / row["ms"]
        print(json.dumps(row))
        return row

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for k in spgemm_kernels:
        worst[k.__name__] = 0.0
    tally = {k.__name__: 0 for k in all_kernels}
    spgemm_rows = {}
    paths6 = {}
    ratio6 = {}
    for name, sr in SEMIRINGS.items():
        vals, b, mask = spgemm_domain(sr, caq.n, gen)
        for block in ((16, 16), (64, 64), (128, 128)):
            a = build_bsr_padded(caq.rows.astype(np.int32), caq.cols.astype(np.int32), vals,
                                 (caq.n, caq.n), sr, block=block, device=dev)
            bpad = torch.full((a.shape[1], caq.n), sr.one, dtype=sr.dtype, device=dev)
            bpad[: caq.n] = b
            mpad = torch.full((a.shape[0], caq.n), sr.zero, dtype=sr.dtype, device=dev)
            mpad[: caq.n] = mask
            cases = [("masked", bpad, mpad), ("unmasked", bpad, None)]
            if name in ("plus_times", "min_times") and block == (64, 64):
                # a row of B under tile-column 0 where pad ⊗ b is NaN
                bnan = bpad.clone()
                bnan[3, ::7] = float("inf") if name == "plus_times" else 0.0
                cases.append(("pad-nan", bnan, mpad))
                del bnan
            if name == "plus_and" and block == (64, 64):
                # values past {0, 1} take kernel 6: B in 0..8, and a negative
                # row under tile-column 0, where min(pad, b) = -1 is not the
                # ⊕-identity and the pads are part of the function
                b08 = bpad.clone()
                b08[: caq.n] = torch.randint(0, 9, (caq.n, caq.n), generator=gen, device=dev,
                                             dtype=torch.int32)
                bneg = bpad.clone()
                bneg[3, ::7] = -1
                cases += [("b-0..8", b08, mpad), ("neg-row", bneg, mpad)]
                del b08, bneg
            for label, bb, mm in cases:
                y_front = main_path(lambda: ops.semiring_spgemm(a, bb, sr, mm))
                binary = (name in spgemm_binary.SEMIRINGS
                          and label in ("masked", "unmasked"))
                want = {"semiring_spgemm_padded": int(not binary),
                        "semiring_spgemm_binary": int(binary)}
                what = f"spgemm {name} ca-Q {block} {label}"
                moved = {k.__name__: k.launches for k in spgemm_kernels}
                check(moved == want, f"{what}: the front door launched {moved}, not {want}")
                bp, mk, meta, bn, n = ops._spgemm_operands(a, bb, sr, mm)
                y, paths = kernel6_paths(a, meta, bp, mk, sr, bn, what)
                y_plain = ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)
                err = compare(y, y_plain, sr, what, nan=label == "pad-nan")
                worst["semiring_spgemm_padded"] = max(worst["semiring_spgemm_padded"], err)
                if label == "pad-nan":
                    check(bool(torch.isnan(y).any()), f"{what}: no NaN")
                if name == "plus_times":
                    paths6[f"{block[0]}-{label}"] = paths
                    ratio6[f"{block[0]}-{label}"] = tolerance_ratio(y, y_plain)
                if binary:
                    yb = semiring_spgemm_binary(a.tiles, meta, bp, mk, sr=sr, bn=bn)
                    yb_plain = ref.spgemm_binary_ref(a.tiles, meta, bp, mk, sr, bn)
                    same(yb, yb_plain, f"{what}: the variant differs from its plain version")
                    same(yb, y, f"{what}: the variant differs from kernel 6")
                    same(y_front, yb[:, :n], f"{what}: the front door differs from the variant")
                    del yb, yb_plain
                else:
                    compare(y_front, y[:, :n], sr, f"{what}: the front door",
                            nan=label == "pad-nan")
                if name == "plus_times" and block == (64, 64) and label == "masked":
                    spgemm_rows["plus_times"] = kernel6_library_row(a, bp, mk, meta, bn, sr,
                                                                    vals, b, mask, y)
                if block == (64, 64) and (name, label) in (("min_plus", "masked"),
                                                           ("min_times", "masked"),
                                                           ("plus_and", "b-0..8")):
                    spgemm_rows[name] = kernel6_row(a, bp, mk, meta, bn, sr, label)
                if name == "plus_and" and block == (64, 64) and label == "masked":
                    bounds = spgemm_bounds(a, bp, mk, meta, sr)
                    for k, plain in ((semiring_spgemm_padded, ref.spgemm_padded_ref),
                                     (semiring_spgemm_binary, ref.spgemm_binary_ref)):
                        row = {"kernel": k.__name__, "semiring": name, "graph": "ca-Q",
                               "tiles": list(a.tiles.shape),
                               "n_active": bounds["stats"]["n_active"],
                               "max_abs_err": worst[k.__name__],
                               "ms": time_ms(lambda: k(a.tiles, meta, bp, mk, sr=sr, bn=bn)),
                               "plain_ms": time_ms(lambda: plain(a.tiles, meta, bp, mk, sr, bn),
                                                   reps=PLAIN_SLOW_REPS, warmup=1),
                               "bound_ms": bounds[k.__name__][0],
                               "bound_by": bounds[k.__name__][1]}
                        print(json.dumps(row))
                        spgemm_rows[k.__name__] = row
                del bp, mk, meta, y, y_plain, y_front, bb, mm
            del a, bpad, mpad, cases
        print(f"phase 9: ca-Q {name}: masked, unmasked at 16x16, 64x64, 128x128 through the "
              "front door, which took the tensor-core variant exactly for the 0/1 cases; "
              "every output matches the plain versions")
        del b, mask
        torch.cuda.empty_cache()
    # ⟨+,×⟩ where an output entry sums ~1,000 nonzero products: a 2048² A
    # of density 1/2 at 64×64 (every tile real), values and B in [0, 1);
    # kernel 6 within half the tolerance of the plain version and of the
    # product in float64
    sr = SEMIRINGS["plus_times"]
    hd = np.random.default_rng(SEED + 8)
    nd = 2048
    dense = np.where(hd.random((nd, nd)) < 0.5, hd.random((nd, nd)), 0.0).astype(np.float32)
    r, c = np.nonzero(dense)
    a = build_bsr_padded(r.astype(np.int32), c.astype(np.int32), dense[r, c], (nd, nd), sr,
                         block=(64, 64), device=dev)
    bb = torch.from_numpy(hd.random((nd, nd)).astype(np.float32)).to(dev)
    bp, mk, meta, bn, _ = ops._spgemm_operands(a, bb, sr, None)
    y, paths6["64-degree-1000"] = kernel6_paths(a, meta, bp, mk, sr, bn,
                                               "spgemm plus_times 2048² density 1/2")
    ratio6["64-degree-1000"] = tolerance_ratio(y, ref.spgemm_padded_ref(a.tiles, meta, bp, mk,
                                                                        sr, bn))
    ratio6["64-degree-1000-float64"] = tolerance_ratio(
        y, torch.from_numpy(dense).to(dev).double() @ bb.double())
    check(max(ratio6["64-degree-1000"], ratio6["64-degree-1000-float64"]) <= 0.5,
          f"kernel 6 plus_times at ~1,000 products an entry: tolerance ratios {ratio6}")
    del dense, r, c, a, bb, bp, mk, meta, y
    torch.cuda.empty_cache()
    print(f"phase 9: kernel 6's ⟨+,×⟩ pairs by path {json.dumps(paths6)}")
    print(f"phase 9: kernel 6's ⟨+,×⟩ worst |diff| / (1e-6 + 1e-5·|want|) by case "
          f"{json.dumps(ratio6)}")
    print(f"phase 9: launches through the front door {json.dumps(tally)}")
    for k in spgemm_kernels:
        check(tally[k.__name__] > 0, f"{k.__name__} was not launched in phase 9")
    tally9 = tally

    # ---------------------------------------------------------------- 10
    mark("10")
    torch.backends.cuda.matmul.allow_tf32 = False   # the yardstick matmul in full fp32
    apps = {}

    def run_app(label, sr, app, **build_kw):
        """Build the tile-route engine (sr given) or nothing (sr None) and
        run ``app``, with every launch counter set to 0 just before and read
        just after."""
        for k in all_kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = None if sr is None else build_engine(cit, sr, stump, fmt_spmv="bsr",
                                                   fmt_spmspv="bsr", **build_kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = app(eng)
        torch.cuda.synchronize()
        row = {"app": label, "graph": cit.name, "n": cit.n, "nnz": cit.nnz, "build_s": build_s,
               "wall_ms": (time.perf_counter() - t0) * 1e3,
               "iterations": getattr(res, "iterations", None),
               "launches": {k.__name__: k.launches for k in (semiring_spmv_padded,
                                                             *spgemm_kernels)},
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        for k in all_kernels:
            tally[k.__name__] += k.launches
        apps[label] = row
        print(json.dumps(row))
        del eng
        torch.cuda.empty_cache()
        return res

    tally = {k.__name__: 0 for k in all_kernels}
    tri = run_app("triangle_count", None,
                  lambda _: triangle_count(cit, impl="bsr", block=(64, 64), device=dev))
    moved = {k: apps["triangle_count"]["launches"][k.__name__] for k in spgemm_kernels}
    check(moved[semiring_spgemm_binary] == 1 and moved[semiring_spgemm_padded] == 0,
          f"the triangle path launched {moved}, not the tensor-core variant alone")
    want_total = triangle_reference(cit.rows, cit.cols, cit.n)
    check(int(tri.total) == want_total,
          f"cit-HP triangles {int(tri.total)} != triangle_reference {want_total}")
    lr, lc = lower_triangle(cit)
    lmat = scipy.sparse.csr_matrix((np.ones(lr.shape[0], np.int64), (lr, lc)),
                                   shape=(cit.n, cit.n))
    want = (lmat @ lmat.T).multiply(lmat).tocoo()
    exact = torch.zeros((cit.n, cit.n), dtype=torch.int32, device=dev)
    exact[torch.from_numpy(want.row).to(dev).long(), torch.from_numpy(want.col).to(dev).long()] = (
        torch.from_numpy(want.data.astype(np.int32)).to(dev))
    check(torch.equal(tri.per_edge, exact), "cit-HP per-edge counts differ from scipy's (L·Lᵀ)⊙L")
    del exact
    print(f"phase 10: cit-HP triangle count {want_total} equals triangle_reference; per-edge "
          f"counts equal scipy's ({want.nnz} nonzero)")

    # the app's wall, split into operand preparation and the SpGEMM call,
    # and the call into the front door's test, packing, grouping and kernel
    split = {}
    t0 = time.perf_counter()
    a, b, mask, _ = triangle_problem(cit, "bsr", (64, 64), device=dev)
    torch.cuda.synchronize()
    split["prepare_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    c = spgemm_masked(a, b, PLUS_AND, mask)
    torch.cuda.synchronize()
    split["spgemm_ms"] = (time.perf_counter() - t0) * 1e3
    same(c[: cit.n], tri.per_edge, "the split triangle run differs from the app's")
    bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, PLUS_AND, mask)
    del b, mask, c
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(ops._binary_operands(a, bp, PLUS_AND), "the triangle operands are not 0/1")
    split["check_ms"] = (time.perf_counter() - t0) * 1e3
    t = a.tiles.shape[1]
    g = spgemm_binary.group_size(64)
    split["pack_ms"] = time_ms(lambda: spgemm_binary.pack(a.tiles, bp), reps=3)
    split["group_ms"] = time_ms(lambda: spgemm_binary.group_tiles(meta, t, g), reps=3)
    a8, bt8 = spgemm_binary.pack(a.tiles, bp)
    active, groups = spgemm_binary.group_tiles(meta, t, g)
    n_real = ref.ell_n_real(meta[:, :t])
    out = torch.zeros_like(mk)
    split["kernel_ms"] = time_ms(lambda: spgemm_binary._launch(a8, bt8, n_real, active, groups,
                                                               meta, mk, out, PLUS_AND), reps=5)
    same(out[: cit.n, : cit.n], tri.per_edge, "the variant's kernel alone differs")
    split["groups"] = groups.shape[0]
    del a8, bt8, active, groups, out
    bounds = spgemm_bounds(a, bp, mk, meta, PLUS_AND)
    tiles_shape = list(a.tiles.shape)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    binary_ms = time_ms(lambda: semiring_spgemm_binary(a.tiles, meta, bp, mk, sr=PLUS_AND,
                                                       bn=bn), reps=5)
    split["variant_extra_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    y6 = semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=PLUS_AND, bn=bn)
    same(y6[: cit.n, : cit.n], tri.per_edge, "kernel 6 differs on the triangle operands")
    del y6
    spgemm_ms = time_ms(lambda: semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=PLUS_AND, bn=bn),
                        reps=3, warmup=0)

    def int_mm():
        """The exact int8 library product (L·Lᵀ) ⊙ L, the cast included."""
        l8 = mk.to(torch.int8)
        return torch._int_mm(l8, l8.t()) * mk

    def fp32_matmul():
        """The dense fp32 yardstick, TF32 off, the casts included."""
        lf = mk.float()
        return torch.matmul(lf, bp.float()) * lf

    del a, meta
    torch.cuda.empty_cache()
    same(int_mm()[: cit.n, : cit.n], tri.per_edge, "torch._int_mm differs from the per-edge counts")
    int_mm_ms = time_ms(int_mm, reps=3, warmup=1)
    same(fp32_matmul()[: cit.n, : cit.n].to(torch.int32), tri.per_edge,
         "the fp32 matmul yardstick differs from the per-edge counts")
    fp32_ms = time_ms(fp32_matmul, reps=3, warmup=1)
    del bp, mk, tri
    torch.cuda.empty_cache()
    st = bounds["stats"]
    for k, ms in ((semiring_spgemm_padded, spgemm_ms), (semiring_spgemm_binary, binary_ms)):
        bound_ms, bound_by = bounds[k.__name__]
        summary[k.__name__] = {"ms": ms, "plain_ms": spgemm_rows[k.__name__]["plain_ms"],
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": int_mm_ms}
        print(json.dumps({"kernel": k.__name__, "semiring": "plus_and", "graph": "cit-HP",
                          "tiles": tiles_shape, "n_active": st["n_active"],
                          "real_slots": st["real_slots"], "ms": ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                          "int_mm_ms": int_mm_ms, "fp32_matmul_ms": fp32_ms,
                          "plain_ms_ca_q_64": spgemm_rows[k.__name__]["plain_ms"]}))
    # kernel 6's row of the kernels line: ca-Q ⟨+,×⟩, operands the front
    # door sends it (the triangle operands above go to 6b)
    summary["semiring_spgemm_padded"] = spgemm_rows["plus_times"]
    split["app_wall_ms"] = apps["triangle_count"]["wall_ms"]
    split["real_macs"], split["real_bytes"] = st["real_macs"], st["real_bytes"]
    print(json.dumps({"phase": 10, "triangle_split": split}))

    # phase 10's oracles, kept for phase 17's served answers
    oracles = {"triangles": want_total, "cc": cc_reference(cit.rows, cit.cols, cit.n),
               "kcore": kcore_reference(cit.rows, cit.cols, cit.n),
               "pagerank": pagerank_reference(cit.rows, cit.cols, cit.n, sparse=True)}
    res = run_app("connected_components", MIN_TIMES, connected_components)
    check(np.array_equal(res.labels.cpu().numpy(), oracles["cc"]),
          "cit-HP CC labels differ from cc_reference")
    res = run_app("kcore", PLUS_TIMES, kcore)
    check(np.array_equal(res.coreness.cpu().numpy(), oracles["kcore"]),
          "cit-HP coreness differs from kcore_reference")
    for label in ("connected_components", "kcore"):
        check(apps[label]["launches"]["semiring_spmv_padded"] > 0,
              f"kernel 1 was not launched on the {label} path")
    res = run_app("pagerank", PLUS_TIMES, pagerank, normalize=True)
    np.testing.assert_allclose(res.rank.cpu().numpy(), oracles["pagerank"],
                               rtol=1e-3, atol=1e-6)
    del res
    print("phase 10: cit-HP CC, k-core and PageRank match the references")
    for k in spgemm_kernels:
        launches[k.__name__] = tally9[k.__name__] + tally[k.__name__]
    launches["semiring_spmv_padded"] += tally["semiring_spmv_padded"]

    # ---------------------------------------------------------------- 11, 12, 13
    mark("11, 12, 13")
    cfg = get_config("deepseek-v2-lite-16b")
    row = lm_phases(torch, dev, cfg, PROMPT_LENS, MAX_NEW_TOKENS, MAX_SEQ, time_ms,
                    dataclasses.replace(cfg, n_layers=2, dtype=torch.float32))
    summary["moe_dispatch_gather"] = row
    launches["moe_dispatch_gather"] = row["launches"]
    worst["moe_dispatch_gather"] = row["max_abs_err"]
    phase22b_s = row.pop("phase22b_s")

    # ---------------------------------------------------------------- 14, 15
    mark("14, 15")
    t0 = time.perf_counter()
    phase14 = {}
    rows = multi_phases(torch, dev, cit, rtx, stump, time_ms, compare, all_kernels,
                        results=phase14)
    print(f"phases 14-15: {time.perf_counter() - t0:.1f} s")
    for name, row in rows.items():
        summary[name] = row
        launches[name] = row["launches"]
        worst[name] = row["max_abs_err"]

    # ---------------------------------------------------------------- 16
    mark("16")
    tally, errs = mesh_phases(torch, dev, cit, rtx, caq, time_ms, compare, all_kernels)
    for name, count in tally.items():
        launches[name] = launches.get(name, 0) + count
    for name, err in errs.items():
        worst[name] = max(worst[name], err)

    # ---------------------------------------------------------------- 17
    mark("17")
    for name, count in serve_phases(torch, dev, cit, rtx, oracles, all_kernels).items():
        launches[name] = launches.get(name, 0) + count

    # ---------------------------------------------------------------- 18, 19
    mark("18, 19")
    row = gqa_phases(torch, dev, time_ms, PROMPT_LENS, MAX_NEW_TOKENS, MAX_SEQ)
    launches["moe_dispatch_gather"] += row["launches"]
    worst["moe_dispatch_gather"] = max(worst["moe_dispatch_gather"], row["max_abs_err"])
    summary["moe_dispatch_gather"] = row

    # ---------------------------------------------------------------- 21
    mark("21")
    t0 = time.perf_counter()
    rows = train_phases(torch, dev)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    row = rows["moe_dispatch_gather_backward"]
    summary["moe_dispatch_gather_backward"] = row
    launches["moe_dispatch_gather_backward"] = (launches.get("moe_dispatch_gather_backward", 0)
                                                + row["launches"])
    worst["moe_dispatch_gather_backward"] = row["max_abs_err"]
    launches["moe_dispatch_gather"] += rows["moe_dispatch_gather_launches"]

    # ---------------------------------------------------------------- 23
    mark("23")
    t0 = time.perf_counter()
    mesh_rows = mesh_train_phases(torch, dev, rows["step_ms"], time_ms)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    launches["moe_dispatch_gather"] += mesh_rows["launches"][0]
    launches["moe_dispatch_gather_backward"] += mesh_rows["launches"][1]

    # ---------------------------------------------------------------- 22
    mark("22")
    dry_s = phase22b_s + rows["phase22a_s"] + dryrun_cells(torch)
    print(f"phase 22: {dry_s:.1f} s")

    # ---------------------------------------------------------------- 24
    mark("24")
    t0 = time.perf_counter()
    walls24: dict = {}
    tally, errs = mesh_rows_phases(torch, dev, cit, rtx, stump, compare, all_kernels, phase14,
                                   walls=walls24)
    for name, count in tally.items():
        launches[name] = launches.get(name, 0) + count
    for name, err in errs.items():
        worst[name] = max(worst[name], err)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    mark("24b (the 23a cell)")
    mesh_dryrun_cell(torch, mesh_rows["bytes_23a"])

    # ---------------------------------------------------------------- 25
    mark("25")
    for name, count in rank_phases(torch, dev, cit, caq).items():
        launches[name] = launches.get(name, 0) + count

    # ---------------------------------------------------------------- 26
    mark("26")
    got = rank_multi_phases(torch, dev, cit, stump, phase14, walls24, smi)
    for name, count in got["launches"].items():
        launches[name] += count
    for name, err in got["worst"].items():
        worst[name] = max(worst[name], err)
    del phase14, got

    # ---------------------------------------------------------------- 27
    mark("27")
    for name, count in rank_ckpt_phases(torch, dev, cit, stump, smi).items():
        launches[name] += count
    mark("done")

    sources = {"semiring_spmv_padded": ("src/repro_torch/kernels/csrc/semiring_spmv.cu",
                                        "src/repro/kernels/semiring_spmv.py:56"),
               "semiring_spmspv_padded": ("src/repro_torch/kernels/csrc/spmspv_tiles.cu",
                                          "src/repro/kernels/spmspv_tiles.py:71"),
               "semiring_spmv_fused_padded": ("src/repro_torch/kernels/csrc/semiring_spmv_fused.cu",
                                              "src/repro/kernels/semiring_spmv.py:170"),
               "semiring_spmv_sell": ("src/repro_torch/kernels/csrc/semiring_spmv_sell.cu",
                                      "src/repro/kernels/semiring_spmv.py:209"),
               "semiring_spmspv_fused_padded": ("src/repro_torch/kernels/csrc/spmspv_fused.cu",
                                                "src/repro/kernels/spmspv_tiles.py:108"),
               "semiring_spgemm_padded": ("src/repro_torch/kernels/csrc/spgemm_tiles.cu",
                                          "src/repro/kernels/spgemm_tiles.py:77"),
               "semiring_spgemm_binary": ("src/repro_torch/kernels/csrc/spgemm_binary.cu",
                                          "src/repro/kernels/spgemm_tiles.py:77"),
               "moe_dispatch_gather": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                                       "src/repro/kernels/moe_dispatch.py:45"),
               "semiring_spmv_padded_batch": ("src/repro_torch/kernels/csrc/semiring_spmv.cu",
                                              "src/repro/kernels/semiring_spmv.py:56"),
               "semiring_spmspv_padded_batch": ("src/repro_torch/kernels/csrc/spmspv_tiles.cu",
                                                "src/repro/kernels/spmspv_tiles.py:71"),
               # the transpose XLA derives from kernel 7's gather in the reference
               "moe_dispatch_gather_backward": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                                                "src/repro/kernels/moe_dispatch.py:45")}
    line = []
    for k in all_kernels:
        row = summary[k.__name__]
        line.append({"name": k.__name__, "route": "cuda", "source": sources[k.__name__][0],
                     "replaces": sources[k.__name__][1], "launches": launches[k.__name__],
                     "max_abs_err": worst[k.__name__], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    phase_seconds = {name: later - t for (name, t), (_, later) in zip(marks, marks[1:])}
    print(json.dumps({"phase_seconds": phase_seconds, "total_s": marks[-1][1],
                      "children_stopped": stop_helpers(), "card": smi}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:                # a failed run stops its helper processes too
        stop_helpers()
    sys.exit(code)
