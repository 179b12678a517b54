#!/usr/bin/env python3
"""Smoke test and first measurement of the PyTorch/CUDA port on one NVIDIA
GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card and build: prints the card's name and power limit, builds the six
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one process
   per library, all started together: the gather and segment_reduce one
   a run length, the fused kernel one a tile) and prints the build time. TF32 is
   off for matmuls and cuDNN.
2. Kernels against their plain PyTorch versions on the card, and the six
   kernels launched twice on the same inputs, which must give the same
   bits. Tolerances:
   fp32 rtol = 1e-4, atol = 1e-4·max|plain| (sums are taken in another
   order); bf16 rtol = 2e-2, atol = 2e-2·max|plain| against the fp32 plain
   version of the same upcast inputs. Each configuration prints kernel_ms
   and plain_ms (CUDA events, median of 20 runs after 3 warm-up runs; a
   busy-wait kernel queued first keeps host launch time out of the window;
   L2 is not flushed, as a served layer finds its input there).

   a. The serving kernels at the served ogbn-arxiv bucket (V = 262,144,
      E = 2,097,152 padded edges): every reduce and weighting of
      gather_segment_reduce at F = 32 and 64 and, weighted sum and max, at
      F = 16, 40 and 3 (widths that are not a multiple of the 16-byte
      vector), a hub of 150,000 rows into one segment amid 400,000 rows into
      50,000 others (the gather, segment_reduce and the softmax), the 4-head
      and (E,) softmax with its padded rows exactly 0 and a segment whose
      logits are all -inf (0, as the plain version gives), the share of
      rows in segments that the softmax's runs cut, the fused kernel
      at the GCN/SAGE layer widths (32->64, 64->64, 64->16), in fp32 and
      bf16, weighted sum and mean, on the hub (32->64), on gcn's reddit2
      request padded to its bucket (its largest fused launch, timed beside
      its bound), the mean of GraphSAGE's last layer over Reddit2's real
      edges at fp32 F = 41 and 47 (class widths that narrow the 16-byte
      vector: each must launch one whole-row walk and equal the column
      tiles' launch bitwise, timed beside the tiles, ``torch.sparse.mm``
      and its bound), GAT's aggregations as its benchmark cell runs them
      over Reddit2's real edges plus a self-loop a node, through the ops
      with the model's plan: the fp32 softmax of (E', 4) and (E', 6)
      logits (its head tile, 4 and 2, read from the profiler's kernel
      names) and a head's alpha-weighted sum at F = 256 (the runs path's
      column tiles) and F = 41 (one whole-row walk), each sum's path and
      schedule counted and its output bitwise the column tiles' launch,
      each timed beside the plain version, the library and its bound,
      plus an empty graph and num_segments % 64 != 0 (the kernel's
      tile). Yardsticks: ``torch.sparse.mm`` of a CSR for the weighted
      sum, the same followed by ``torch.matmul`` by W for the fused kernel
      (two calls: no single PyTorch call computes both),
      ``torch.sparse.softmax`` of a COO.
   b. segment_matmul at the typed rows of the AM graph (M = 5,988,321
      edges in 133 zipf-skewed relation groups) at K->N = 64->64, 32->128,
      64->128, 64->16 and 64->32 (in bf16 beside today's mma_sync kernel
      through its C entry, whichever path the rule takes), plus, in fp32
      and bf16, empty groups, a
      single group, rows past the groups, 3,000 groups of 1-3 rows, and
      N = 16 and 32, and K = 512, 1001 and 1024 (deeper than one pass of
      shared memory holds), and the MoE expert products of 3h (K = 2048 ->
      N = 768 and 768 -> 2048) over 128 groups of 0-3 rows with rows past
      the groups; the gather kernel with H = the (E, 64) typed messages
      and the inverse type permutation as its gather index, as ``mp_typed``
      runs it, with its bound; the fp32 (E, 2) softmax over the AM typed
      rows, as RGAT runs it, with its bound;
      segment_reduce (sum, mean, max at F = 32 and 64) on the ogbn-arxiv
      destinations (M = 1,166,243 rows, S = 169,343 segments); sddmm on
      arxiv's (dst, src) pairs, dst-sorted and shuffled, at F = 64, 40 and
      3 in fp32 and bf16. Yardsticks:
      ``torch.segment_reduce`` with lengths (each reduce; ``initial=0``
      for the mean, whose empty segments it would make NaN),
      ``torch.sparse.sampled_addmm``
      on the CSR of the coalesced (dst, src) pattern (duplicate pairs are
      merged there, so it computes each distinct pair once), and
      ``torch._grouped_mm`` with the group offsets.
   c. The backwards: each op's gradients through the kernels against the
      plain versions' autograd on the card, at the phase's tolerances, and
      two backwards bitwise equal, with every backward op on a kernel:
      index_segment_reduce and index_weight_segment_reduce (sum, mean, max,
      F = 64) and fused_transform_reduce (weighted sum fp32 and bf16, mean,
      32->64) at the arxiv bucket with its graph plan (whose source order
      the dH walks follow), the gather of GAT's (V, 4) logits by the
      sources, the (E, 4) softmax in fp32 and bf16, sddmm on arxiv's
      (dst, src) pairs, segment_reduce on the arxiv destinations, and
      segment_matmul over the AM typed rows (64->64 and 64->16 fp32,
      64->64 bf16). Then each backward role timed beside its bound and a
      one-call yardstick: the dH walk of a sum (``index_add_`` of the
      per-edge rows) and of a weighted sum (``torch.sparse.mm`` of the
      transposed CSR), a gather's dH with its sort by arxiv's sources and
      by its destinations (``index_add_``), the
      softmax backward's segment sum (``torch.segment_reduce``),
      segment_matmul's dX with Wᵀ 16->64 (``torch._grouped_mm``); the
      weight gradient's sddmm is the call 2b times. A
      ``{"backward_roles": [...]}`` line lists them.
3. The main paths, each with the launch counters zeroed just before it and
   read just after it:

   a. Serving: for gcn, gin, sage and gat (4 heads), a 3-layer model (feat
      32, hidden 64, 16 classes) with seeded random weights behind
      ``GNNServer`` on the card serves one full ogbn-arxiv request (twice:
      cold and warm), one cora + citeseer + pubmed micro-batch, and for gcn
      one full reddit2 request. Every result is held against the same model
      run with ``impl="ref"`` on the card (fp32 tolerance above), and each
      kernel of a family's path must have launched.
   b. Typed inference: rgcn and rgat (2 heads), 3 layers, feat 32, hidden
      64, 16 classes, seeded weights, on the AM-scale typed graph
      (``synth_typed_graph``: 1,666,764 nodes, 5,988,321 edges, 133
      relations), with both plans built on the card. Held against the same
      model at ``impl="ref"`` on the card; every layer must launch
      segment_matmul exactly once and the gather kernel, every rgat layer
      the softmax, and no op may take a plain version. Prints each
      family's warm forward time (CUDA events, median of 3) and one
      forward under ``torch.profiler``: device-busy time, idle share, the
      ops that take the most device time, the gather's kernels
      (gsr_runs, gsr_fix, and gsr_owner for inputs of few rows) and the
      softmax's three (ssm_runs, ssm_fix, ssm_cut) summed over the forward.
   c. The public ops: ``segment_reduce`` (sum, mean, max) and ``sddmm`` on
      arxiv's card tensors, as ``examples/quickstart.py`` calls them.
   d. Training, under ``torch.use_deterministic_algorithms(True)`` with a
      fixed cuBLAS workspace: gcn, gin, sage and gat (4 heads), 3 layers,
      feat 32 / hidden 64 / 16 classes, full-graph on a graph of
      ogbn-arxiv's size (169,343 nodes, 1,166,243 edges, unpadded,
      ``GraphEpochProvider``), 6 steps each through ``repro_torch.fit``;
      rgcn, 3 steps, on the AM-scale typed graph of 2b. For each family:
      every op on a kernel and each kernel of its path launched; the
      losses within rtol 1e-4 of the same trainer at ``impl="ref"`` on the
      card; the step-0 gradients at the fp32 tolerance above, layer by
      layer (each layer on the kernel path's input with one random
      cotangent: a ReLU input within rounding of 0 may fall on either
      side on the two whole forwards, and a weight gradient contracting
      10^5 rows then moves by a whole term; the count of such inputs is
      printed); a second
      run and a run killed after its checkpoint at step 3 (rgcn: 2) and
      resumed, both bitwise the first run. Prints the warm step time (CUDA
      events at each step's end, median over steps 2-5), the forward /
      backward / optimizer split (CUDA events, median of 5), one profiled
      step's device-busy time and idle share, and peak memory; a
      ``{"training": [...]}`` line lists them.
   e. Sampled mini-batches, under deterministic algorithms, on the graph
      of 3d (169,343 nodes, 1,166,243 edges, seed 0) resident on the
      host. Seeds are the nodes that have in-edges (22,377): the synthetic
      stand-in puts every in-edge on a few nodes, and 1024 seeds drawn
      from all nodes would give a batch of about 2 k edges. Sampler:
      1024 seeds, fanouts (15, 10, 5) (the 3-layer neighbour-sampling
      fanouts of PyG's and DGL's ogbn-products GraphSAGE examples); the
      prefetch pipeline at depth 2. Checks: (1) the first 8 batches of an
      8-shard ``ShardedGraphStore`` are bitwise the in-memory ones; (2)
      the device tensors of the first 8 batches are bitwise equal at
      depth 0 and at depth 2 with 2 producer threads; (3) an exact 3-hop
      sample around 64 seeds gives the full-graph forward's logits on the
      seed rows at the fp32 tolerance (gcn, sage, gat); (4) gcn, sage and
      gat (4 heads), 3 layers, feat 32 / hidden 64 / 16 classes, 20 steps
      of ``repro_torch.fit`` on a ``SampledNodeProvider``: losses within
      rtol 1e-4 of ``impl="ref"`` on the card, a second run and a run
      killed after its step-10 checkpoint and resumed bitwise the first,
      the run's buckets those the producer's probe predicts and one cache
      entry built per bucket, every op on a kernel and each kernel of the
      family's path launched; (5) gcn ``serve_sampled`` over
      ``GNNServer.sampled_pipeline`` for 20 batches equal to
      ``impl="ref"`` at the fp32 tolerance, ``builds`` equal to the cache
      entries, and a batch stamped against a foreign cache restamped
      (into the same logits) with no build; (6) the registry's
      ``kernel.launches`` equals the fusion accounting over the phase, and
      a served step's span tree holds every engine stage; the
      ``repro_torch.obs`` report is printed. Prints, per family, the warm
      step (CUDA events at each step's end, median over steps 2-19), the
      pipeline's steady produce and wait medians and overlap, the
      batches' (V, E) and buckets, one profiled step's device-busy time
      and idle share (host sampling included), peak memory above the
      tensors already live, and the warm step of the same run with the
      blocking loader (depth 0, its losses bitwise the same); a
      ``{"sampled": [...]}`` line lists them.
   f. Config selection (after the paths, which run the generated rules'
      picks with no ``tune=``; each path prints its configs). Sweeps the
      built kernel instances with ``repro_torch.core.autotune.tune`` into a
      PerfDB in a temporary directory (median of 20 CUDA-event timings a
      candidate, every candidate held against its plain version at the
      tolerances above): the gather at the arxiv bucket (F = 64 and 32),
      the gather's mean at the AM typed messages' shape (F = 64),
      segment_reduce on the arxiv destinations (F = 64), the fused kernel
      32->64 at the arxiv bucket and at gcn's reddit2 request, and the
      gather (F = 64) and the fused kernel (32->64) at the cora + citeseer
      + pubmed bucket. Per sweep it prints each candidate's ms, the rules'
      pick, the measured winner and the shipped values' ms; a second
      ``tune`` of each must time nothing. Then ``python -m
      repro_torch.core.train_rules --from-perfdb`` on the DB, whose rules
      must load; gcn's arxiv request through ``GNNServer(tune=True)`` on
      the DB, whose bucket must run the measured winners and whose logits
      must equal ``impl="ref"``; and, for gcn's and sage's layers at the
      arxiv bucket and gcn's first layer at reddit2's, the order
      ``choose_order`` picks beside all three orders timed on the card.
      Before the kernels line, the H100 cost model's ms beside the card's
      at the six configurations of the kernels line; a ``{"selection":
      ..., "cost_model": [...]}`` line lists them.
   g. Sharded message passing (``torch.distributed``, one process a
      rank): 4 ranks, NCCL with a card a rank where there are 4 cards,
      else gloo with every rank on the one card (NCCL refuses two ranks on
      one card; gloo moves CUDA tensors through the host); the backend is
      printed. Each rank partitions the ogbn-arxiv-size graph of 3a
      (169,343 nodes, 1,166,243 edges, seed 0; its cut fraction, halo
      nodes and host partition and plan times printed) and holds, at the
      fp32 tolerance above, against the unsharded kernels on the card:
      ``mp_sharded`` at F = 64 for every reduce, plain and weighted, and
      its gradients; the (E, 4) ``segment_softmax_sharded``, exactly 0 on
      padding. Then the main path, the counters zeroed: ``GNNServer(
      shards=4)`` serves one arxiv request three times (cold, warm,
      profiled on rank 0) for gcn, gin, sage and gat (4 heads) at the
      served width, and ``fit(mesh=)`` trains gcn and gat 5 steps on the
      graph of 3d; every rank must launch the gather, the softmax,
      segment_reduce and sddmm, never the fused kernel, and no op may take
      a plain version. Then, outside the counted window: the served logits
      against the unsharded forward, the losses within rtol 1e-4 of the
      unsharded ``fit``, and the parameters bitwise equal on every rank.
      Prints each request's serve_ms with its stages (``stamp``: the host
      partition and plan), the bytes its merges moved, and, profiled, the
      ported kernels' device ms beside the host ms in the collectives
      (gloo runs them on the host, after waiting for the kernels queued
      before each); each training step's ms (median over steps 2-5), its
      collective bytes and its profiled split; one (V, 64) all-reduce
      alone. A rank that fails ends the phase at once (the others are
      killed); the group's 120 s timeout ends a hung collective. A
      ``{"sharded": ...}`` line lists it all.
   h. LM serving: qwen3-moe-30b-a3b at full width (d_model 2048, 32 heads
      / 4 KV heads, 128 experts of d_ff 768, top-8, vocab 151,936) in
      bf16 with seeded weights drawn on the card, its depth cut from 48 to
      8 layers (about 11.2 GB; the cut is printed). (a) One MoE layer
      alone at 8 tokens (decode) and 4096 (prefill, 32,768 assignments):
      ``moe_impl="cuda"`` (the three expert products on segment_matmul,
      the combine on the gather kernel: exactly 3 and 1 launches) within
      the bf16 tolerance of the fp32 plain version of the same upcast
      inputs, bitwise over two calls, its three products on
      segment_matmul's wgmma path and its combine on the gather's owner
      path at 8 tokens (64 rows), its runs path at 4096
      (``kops.path_launch_counts``); each product held to the fp32 plain
      version and bitwise over two calls, and timed (kernel; plain;
      ``torch._grouped_mm``) beside its bound, max(bytes / 3.35 TB/s,
      2·rows·K·N / 989 TFLOP/s), the bytes counting X, the W of each
      expert with rows and the output once; the combine held to the fp32
      plain version, bitwise over two calls, timed through the op (its
      metadata included) beside its bound and ``torch.sparse.mm`` of the
      (T, T·k) CSR of the router weights and, at 8 tokens, beside the
      runs path through its C entry ``gsr_launch`` with the row offsets it
      builds. (b) As ``launch/serve.py`` serves: the forward on 2 x 2048
      SyntheticTokens tokens on the kernels, for the weights and tokens of
      two seeds. The two paths sum in other orders, so from the second
      layer on a token may take another top-8 set: the check holds routing
      fixed, running the plain forward (``moe_impl="ragged"``) with each
      MoE layer also run on the kernels from the same input, at the bf16
      tolerance; the end-to-end logits' distance and argmax differences
      are printed as readings. Then, the counters zeroed, 8 prompts of 128
      tokens prefilled token by token into the caches
      (``prefill_into_cache``) and 32 greedy decode steps on the kernels,
      each step's MoE layers then held the same way on the plain path fed
      the same tokens; prefill and decode tok/s, ms a decode step, one
      profiled decode step's device time split into the MoE layers (and
      their segment_matmul and gather kernels), attention and the rest
      (failing if a range has no device time), its idle share, and peak
      memory. (c) ``ContinuousBatcher`` on the same weights, on the
      capacity path (its combine on the gather kernel, one launch a MoE
      layer a tick): 12 requests with prompts of 16-96 tokens, 16 new
      tokens each, into 4 slots; every request must finish with exactly
      16 tokens, and the first tick's MoE layers on the capacity path
      match the plain ones on the same inputs. A ``{"lm_serving": ...}``
      line lists it all.
   i. LM training: qwen3-moe-30b-a3b at full width, its depth cut from 48
      to 4 layers (3.11 B parameters; bf16 weights and gradients and fp32
      AdamW moments, 37.4 GB), on 2 x 1024 ``TokenProvider`` tokens a
      step, ``LMTask(moe_impl="cuda")`` through ``repro_torch.train.fit``.
      (a) One MoE layer's forward and backward at the step's 2048 tokens
      (16,384 assignments), routing held fixed (the router is fp32 and
      reads the same upcast input): the kernels (6 segment_matmul, 3
      gather, 1 sddmm launches) against the fp32 plain path (``"ragged"``)
      on the same upcast weights, input and upstream gradient, the output
      and the gradients of x, the router and the three expert weights at
      the bf16 tolerance; then each piece of the backward timed beside its
      bound and a one-call yardstick: the three products forward and
      their dX on segment_matmul's wgmma path, the dX reading W[g]ᵀ in
      place (no copy), each held to the fp32 plain version and bitwise
      over two calls (``torch._grouped_mm``), the three dW loops of
      ``torch.matmul`` with their host sync (``torch._grouped_mm`` of Xᵀ
      and dY), the combine's dH on the gather kernel (``torch.sparse.mm``
      of the transposed CSR) and its router-weight gradient on sddmm's
      wide path, held, bitwise, with B (the expert outputs) in fp32
      (``torch.sparse.sampled_addmm``; beside it the runs kernel through
      its C entry ``sddmm_launch``) and in bf16, as the backward passes
      it, the dispatch gather's dH with its sort (``index_add_``). (b) The
      embedding's backward at full vocab: 2048 sorted ids of width 2048
      into 151,936 segments on segment_reduce against the fp32
      ``index_add_`` at the fp32 tolerance, timed beside its bound and
      ``torch.segment_reduce``. (c) 4 steps (one cold, three warm), the
      counters zeroed: finite losses, step 0 beside a ``"ragged"``
      forward on the same weights (a reading: routing may differ), each
      of segment_matmul, the gather, sddmm and segment_reduce launched and
      no op on a plain version; the warm step (host clock after a
      synchronise, median of steps 1-3); one profiled step: its forward
      (the task's loss), backward (``torch.autograd.grad``) and AdamW
      (``adamw.update_``) each in a profiler range and timed on the card
      by CUDA events at the range's ends (failing if one is missing), its
      device-busy time (the union of the device events) and idle share;
      peak memory beside the 37.4 GB reckoning. (d) Two runs of 2
      steps from the same seed: bitwise-equal parameters, compared by an
      integer digest of each tensor's bits. (e) Kill and resume at
      ``reduced_100m`` on the card (fp32): 6 steps with a checkpoint
      every 3, killed after step 3 and resumed, bitwise the uninterrupted
      run. A ``{"lm_training": ...}`` line lists it all.
   j. LM sharding: 4 ranks (gloo on the one card) on a 2 x 2 ("data",
      "model") mesh, qwen3-moe-30b-a3b at full width, 2 of 48 layers, 2 x
      1024 tokens a data shard. (a) ``moe_shard_map`` forward and
      gradients against ``moe_capacity`` on each data shard at its
      capacity; (b) ``tp_out_project``; (c) prefill and 8 decode steps, each
      MoE layer held to ``moe_capacity``; (d) ``fit(mesh=)`` on
      ``LMTask(moe_impl="capacity")``, 3 steps, the warm step and its split,
      every parameter and moment its share, the peak over a tallied warm
      step beside the 14.01 GB it took before the loss's gold logit was
      kept a data shard's; (e) an elastic restore 2 x 2 -> 4 x 1,
      bitwise; then, its model dropped, the dropless MoE: (f) one layer
      through ``moe(impl="cuda")`` under the mesh (``moe_ragged_shard_map``:
      segment_matmul, the gather and sddmm on every rank), the output and
      the gradients of x, the router and the three expert weights held to
      the single-device ``moe_ragged(impl="cuda")`` and the fp32 plain path
      on the rank's data shard (every token's output is its own: no
      capacity) at the bf16 tolerance, and on rank 0 the layer's static
      tail (all of the shard's sorted rows, those past the rank's groups
      0) against the live count at this run's share of the experts and a
      16-way model axis's: segment_matmul and the forward's expert part
      timed both ways, the products on the wgmma path (bitwise over two
      calls) beside their bound, plain version and ``torch._grouped_mm``;
      (g) prefill and 8
      decode steps with ``moe_impl="cuda"``, every MoE layer held to the
      plain ``moe_ragged`` on its data shard, the logits read against
      the single-device decode; (h) ``fit(mesh=)`` on
      ``LMTask(moe_impl="cuda")``, 3 steps, step 0's loss within 1e-4 of
      the single-device loss on the same batch, the warm step and its
      split, the peak a rank. (c)-(d) and (g)-(h) are two main paths
      (``_sharded_serve_and_train``), each with its counters zeroed first:
      each must launch its kernels on every rank and take no plain
      version. A ``{"lm_sharded": ...}`` line lists it all.
   k. The dry run (``repro_torch.launch.dryrun``), in a process of its
      own with a deadline. (a) ``torch.library.opcheck`` (schema and fake
      tensor) of the six kernel ops on the card at small shapes: the
      fakes' output shapes, dtypes and strides are the kernels'. (b) The
      dry run at 3j's own configuration on a fake 2 x 2 ``"cuda"`` mesh
      (qwen3-moe-30b-a3b at full width, 2 layers, 2 x 1024 tokens a data
      shard): the train step ``LMTask`` builds under ``fit(mesh=)`` and a
      decode step at 3j's batch and length, held to 3j's rank 0, which ran
      one more warm step of each under the dry run's tally (not timed, not
      profiled): its parameter and moment bytes, FLOPs, and collective
      counts and bytes by kind exactly equal; the predicted peak a rank
      beside ``max_memory_allocated`` of that warm training step (after
      ``reset_peak_memory_stats``, the state in place), its ratio printed
      and within 0.5-2x. (c) Three production cells on fake 256- and
      512-rank ``"cuda"`` meshes, each a ``python -m
      repro_torch.launch.dryrun`` process (all three together):
      stablelm-1.6b x decode_32k x single, rwkv6-3b x long_500k x multi,
      qwen3-moe-30b-a3b x train_4k x single, at full depth; each ends ``"ok"`` with FLOPs and collective
      bytes > 0, its record printed. (d) The ten ``examples/torch_*.py``
      on the card at small settings, each a subprocess with a deadline:
      each exits 0 and prints its result line, and those that run a
      kernel print nonzero ``launch_counts()``. A ``{"dryrun": ...}``
      line lists it all.
4. A ``{"kernels": [...]}`` line: per kernel its launches on the main paths
   (and per path: serving, typed, ops, training, sampled, sharded, lm,
   lm_train, lm_sharded and lm_sharded_dropless, the sharded ones summed
   over the ranks), ``cuda_kernels_per_launch``, the port's
   CUDA kernels that one launch of its representative configuration runs,
   counted from the device events of ``torch.profiler`` over two calls
   after phase 3g, before the LM phases (null
   where the profiler lost events; one launch of
   gather_segment_reduce or segment_reduce is two, the row runs and the
   fix-up pass of the segments they cut; one of segment_softmax three, the
   runs, the fold of the cut segments and their rows; the times cover them
   all), the max abs error and times of its representative
   configuration, and ``bound_ms``, the least time the card could take for
   that work: the larger of (bytes it must move) / 3.35 TB/s and (flops) /
   the peak of the unit that does them: 67 TFLOP/s fp32 outside the tensor
   cores for five kernels; for segment_matmul the tensor cores, 495 TFLOP/s
   TF32 with the flops counted three times for the 3xTF32 split of fp32,
   989 TFLOP/s bf16. The bytes count each input read once (a gathered
   operand at its distinct rows) and each output row written once; the
   gather's also count the plan's int64 row offsets, which its fix pass
   reads whole. The fused kernel reads no segment ids: its bytes count the
   gather index and weight of each real row and the plan's int64 row
   offsets, which it reads whole, and no chunk ranges. Its entry adds ``two_call_ms`` (the SpMM + GEMM
   yardstick), and its hub and reddit2 times beside their bounds; sddmm's
   adds ``shuffled_ms``; the gather's adds ``moe_combine`` and
   segment_matmul's ``moe_products``, the MoE shapes of 3h, each with its
   path, ms, plain ms, bound and library ms (the combine at 8 tokens with
   ``runs_path_ms``, the runs path with its offsets in the same call);
   the gather's ``sage_class_mean``, GraphSAGE's last-layer mean over
   Reddit2 at F = 41 and 47 fp32 (its schedule, ms, ``tiled_ms`` of the
   column tiles, plain ms, ``library_ms`` of ``torch.sparse.mm`` and
   ``bound_ms``); the gather's ``gat_weighted_sum`` and the softmax's
   ``gat_softmax``, GAT's on Reddit2 with self-loops (F = 256 and 41; 4 and
   6 heads), each with its path and schedule or head tile, ms, plain ms,
   library ms and ``bound_ms``;
   segment_matmul's ``typed_bf16`` (the path the rule takes at the bf16
   typed widths, beside ``mma_sync_ms``, today's mma_sync kernel in the
   same call); the gather's, segment_matmul's and sddmm's
   ``launches_by_kernel_path`` (their launches on 3h, 3i and 3j's two
   paths, summed over the ranks, by the path they took: runs or owner,
   wgmma or mma_sync, runs or wide) and the gather's and sddmm's
   ``path``, the one their generic row took; from 3i, segment_matmul's
   ``moe_train_products`` (forward and dX), the gather's
   ``moe_train_backward`` (the combine's and the dispatch's dH), sddmm's
   ``moe_train_router_grad`` (B in fp32, with ``runs_kernel_ms``, and in
   bf16) and segment_reduce's ``embedding_backward``.
5. The last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS sums in a fixed order only with a fixed workspace; it must be set
# before the first cuBLAS call (phase 3d trains under deterministic
# algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM tensor cores, TF32 dense
BF16_FLOPS = 989e12            # H100 SXM tensor cores, bf16 dense
FEAT, HIDDEN, CLASSES = 32, 64, 16
SEED = 0
# the GraphSAGE benchmark cell on Reddit2: its widest layer (the 602 input
# features) and the class widths of its last layer's mean gather (Reddit2's
# 41, ogbn-products' 47), which narrow the 16-byte vector
SAGE_IN, SAGE_CLASS_WIDTHS = 602, (41, 47)
# the GAT benchmark cell on Reddit2 with a self-loop a node: (heads of its
# softmax, width of a head's alpha-weighted sum, the row-run schedule that
# sum takes) for layers 1-2 (4 concatenated heads of 256, column tiles) and
# layer 3 (6 averaged heads of Reddit2's 41 classes, one whole-row walk;
# 6 fp32 heads are 24 bytes, so the softmax takes tiles of 2 heads)
GAT_AGGREGATIONS = ((4, 256, "tiled"), (6, 41, "whole_row"))
# the AM graph of the R-GCN paper (Schlichtkrull et al. 2018, Table 1)
AM_NODES, AM_EDGES, AM_RELATIONS = 1_666_764, 5_988_321, 133
RGAT_HEADS = 2
TRAIN_STEPS, TYPED_TRAIN_STEPS = 6, 3
# phase 3e: the 3-layer neighbour-sampling fanouts of PyG's and DGL's
# ogbn-products GraphSAGE examples, 1024 seeds a batch, prefetch depth 2
SAMPLED_FANOUTS, SAMPLED_BATCH, SAMPLED_DEPTH = (15, 10, 5), 1024, 2
SAMPLED_STEPS, SAMPLED_KILL_AT, EXACT_SEEDS = 20, 10, 64
SAMPLED_FAMILIES = ("gcn", "sage", "gat")
SERVE_STAGES = ("serve.batch", "serve.pad", "serve.plan_cache", "serve.copy",
                "serve.stamp", "serve.execute", "serve.fetch")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call; a
    busy-wait kernel queued first lets the host enqueue the call before the
    device reaches it, so launch overhead stays out of the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, what: str, got, want, dtype) -> float:
    """Max abs error of ``got`` against the plain ``want``; fails outside
    the tolerance of ``dtype`` (see the module docstring)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        fail(f"{what}: -inf (empty max) rows disagree")
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        fail(f"{what}: non-finite values where the plain version is finite")
    if not fin.any():
        return 0.0
    g, w = got[fin], want[fin]
    err = (g - w).abs()
    scale = float(w.abs().max())
    bad = err > tol * max(scale, 1e-30) + tol * w.abs()
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} values outside rtol={tol}, "
             f"atol={tol}*{scale:.3g}; max abs err {float(err.max()):.3g}")
    return float(err.max())


def deterministic(torch, what: str, fn) -> None:
    """Fails unless two launches of ``fn`` give the same bits."""
    first = fn()
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail(f"{what}: two launches differ (not bitwise deterministic)")
    print(f"  {what}: bitwise equal over two launches", flush=True)


def bound(nbytes, flops, peak=FP32_FLOPS, unit="fp32"):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the flops over the peak of the unit that does them."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    print(f"  bound: {nbytes} bytes, {flops} flops on {unit} -> "
          f"{max(t_b, t_o) * 1e3:.4f} ms", flush=True)
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def smm_bound(torch, m, k, n, groups, dtype, plan_bytes):
    """segment_matmul's bound: X read and out written once, W once; fp32
    runs as 3xTF32 (three TF32 products), bf16 as one bf16 product."""
    es = 4 if dtype == torch.float32 else 2
    flops = 2 * m * k * n
    if dtype == torch.float32:
        return bound(m * (k + n) * es + groups * k * n * es + plan_bytes,
                     3 * flops, TF32_FLOPS, "TF32 tensor cores, 3 passes")
    return bound(m * (k + n) * es + groups * k * n * es + plan_bytes, flops,
                 BF16_FLOPS, "bf16 tensor cores")


def smm_mma_sync(torch, x, sizes, w, w_transposed=False):
    """A call of today's mma_sync kernel through its C entry
    (``smm_launch``) on the inputs of a wgmma launch, for its time beside
    the new path's in the same call (not a launch of the op, so not
    counted); W read transposed is copied to (G, K, N) once, before."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE
    from repro_torch.kernels.segment_matmul import group_metadata
    lib = _build.load("segment_matmul")
    wk = w.transpose(1, 2).contiguous() if w_transposed else w.contiguous()
    (m, k), (g, n) = x.shape, (wk.shape[0], wk.shape[2])
    meta = group_metadata(sizes, m, 64)

    def call():
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        _build.check(lib.smm_launch(
            DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(wk),
            *(_build.ptr(t) for t in meta), _build.ptr(out), m, k, n, g, 64,
            _build.stream_of(x)), "segment_matmul (mma_sync, C entry)")
        return out
    return call


def took_paths(kops, what, expect) -> dict:
    """The launches by path since the last reset
    (``kops.path_launch_counts()``); fails unless each kernel of ``expect``
    ({kernel: {path: launches}}) took exactly those."""
    got = kops.path_launch_counts()
    bad = {k: got[k] for k, want in expect.items() if got[k] != want}
    if bad:
        fail(f"{what}: launches by path {bad}, expected "
             f"{ {k: expect[k] for k in bad} }")
    return got


def count_diff(after, before) -> dict:
    """``after`` - ``before``, key by key, of two launch counts of one
    form: {kernel: launches} or {kernel: {path: launches}}."""
    return {k: (count_diff(v, before.get(k, {})) if isinstance(v, dict)
                else v - before.get(k, 0)) for k, v in after.items()}


@contextlib.contextmanager
def not_counted(kops, ref):
    """Adds the launches the block makes, each kernel's and by path, to
    ``ref`` ({"launches": Counter, "paths": defaultdict(Counter)}), for the
    caller to take off its run's counts (:func:`count_diff`)."""
    before = kops.launch_counts(), kops.path_launch_counts()
    yield
    ref["launches"].update(count_diff(kops.launch_counts(), before[0]))
    for k, by in count_diff(kops.path_launch_counts(), before[1]).items():
        ref["paths"][k].update(by)


def smm_row(torch, kops, what, x, sizes, w, w_transposed=False) -> dict:
    """A MoE product on the op (the wgmma path, checked): against the fp32
    plain version, bitwise over two calls, and its time. {"max_abs_err",
    "ms", "path"}."""
    def kern():
        return kops.segment_matmul(x, sizes, w, impl="cuda",
                                   w_transposed=w_transposed)
    kops.reset_launch_counts()
    got = kern()
    torch.cuda.synchronize()
    took_paths(kops, what, {"segment_matmul": {"wgmma": 1, "mma_sync": 0}})
    err = compare(torch, what, got, kops.segment_matmul(
        x.float(), sizes, w.float(), impl="ref", w_transposed=w_transposed),
        torch.bfloat16)
    deterministic(torch, what, kern)
    rec = {"max_abs_err": err, "ms": time_ms(torch, kern), "path": "wgmma"}
    print(f"  {what}: wgmma {rec['ms']:.4f} ms", flush=True)
    return rec


def gsr_runs_call(torch, h, gidx, seg, num_segments, weight):
    """A call of the gather's runs path through its C entry
    (:func:`~repro_torch.kernels.gather_segment_reduce.c_entry`) with the
    row offsets it builds on the card (``row_offsets``: arange and
    searchsorted), as the op ran every input before the owner path: for
    its time beside the owner path's in the same call (not a launch of the
    op, so not counted)."""
    from repro_torch.kernels import gather_segment_reduce as gsr

    def call():
        # int32 indices, as the op makes them
        g32, s32 = (t.to(torch.int32).contiguous() for t in (gidx, seg))
        return gsr.c_entry("runs", h, g32, s32, num_segments, weight,
                           row_ptr=gsr.row_offsets(s32, num_segments))
    return call


def sage_class_gather(torch, kops, dev, gen, graph) -> dict:
    """SAGE's last-layer mean gather as the benchmark cell runs it: fp32
    rows of :data:`SAGE_CLASS_WIDTHS` columns over ``graph``'s real edges
    (Reddit2's), through the op with a plan made for the cell's widest
    layer. Each width must launch one whole-row walk (the schedule
    counter), agree with the plain version at the fp32 tolerance, and equal
    the column tiles' launch of the same inputs (``c_entry("tiled")``)
    bitwise; then the op is timed beside the tiles, the plain version,
    ``torch.sparse.mm`` of the mean's CSR and its bound. {"F=<f>": {...}}."""
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import gather_segment_reduce as gsr
    v, e = graph.num_nodes, graph.num_edges
    src = torch.from_numpy(graph.edge_index[0]).to(dev).int().contiguous()
    dst = torch.from_numpy(graph.edge_index[1]).to(dev).int().contiguous()
    plan = make_plan(dst, v, feat=SAGE_IN, device=dev)
    deg = plan.row_ptr.diff()
    csr = torch.sparse_csr_tensor(
        plan.row_ptr, src.long(),
        (1.0 / deg.clamp_min(1).float()).repeat_interleave(deg), (v, v))
    h_rows = int(torch.unique(src).numel())
    out = {}
    for f in SAGE_CLASS_WIDTHS:
        h = torch.randn(v, f, generator=gen, device=dev)
        what = (f"gather_segment_reduce mean F={f} float32 over reddit2 "
                f"({v} nodes, {e} edges)")

        def kernel(h=h):
            return kops.gather_segment_reduce(h, src, dst, v, None, "mean",
                                              plan=plan, impl="cuda")

        def tiled(h=h):
            return gsr.c_entry("tiled", h, src, dst, v, None, "mean",
                               row_ptr=plan.row_ptr, run_rows=plan.config.m_b)

        def plain(h=h):
            return kops.gather_segment_reduce(h, src, dst, v, None, "mean",
                                              impl="ref")

        def library(h=h):
            return torch.sparse.mm(csr, h)

        before = kops.schedule_launch_counts()
        got = kernel()
        took = count_diff(kops.schedule_launch_counts(),
                          before)["gather_segment_reduce"]
        if took != {"tiled": 0, "whole_row": 1}:
            fail(f"{what}: launches by schedule {took}, expected one "
                 "whole_row")
        want = plain()
        err = compare(torch, what, got, want, torch.float32)
        if not torch.equal(got, tiled()):
            fail(f"{what}: not bitwise the column tiles' output")
        compare(torch, f"torch.sparse.mm yardstick F={f}", library(), want,
                torch.float32)
        del got, want
        row = {"schedule": "whole_row", "max_abs_err": err,
               "ms": time_ms(torch, kernel), "tiled_ms": time_ms(torch, tiled),
               "plain_ms": time_ms(torch, plain),
               "library_ms": time_ms(torch, library)}
        # the two int32 indices, the int64 row offsets, the distinct rows
        # of H, the output; an add a row element and a divide an output one
        row["bound_ms"], row["bound_by"] = bound(
            e * (4 + 4) + (v + 1) * 8 + h_rows * f * 4 + v * f * 4,
            e * f + v * f)
        print(f"  {what}: whole_row {row['ms']:.4f} ms, column tiles "
              f"{row['tiled_ms']:.4f}, plain {row['plain_ms']:.4f}, "
              f"torch.sparse.mm {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f}; bitwise the tiles", flush=True)
        out[f"F={f}"] = row
        del h
    return out


def softmax_head_tile(torch, fn):
    """The head tile V of the ``ssm_runs<T, V>`` instance that a call of
    ``fn`` launched, read from the profiler's device kernel names; None
    where the profiler recorded no device events."""
    names = [row[0] for row in profiled(torch, fn)[2]]
    if not names:
        return None
    # demangled ("ssm_runs<float, 2>(") or mangled ("8ssm_runsIfLi2EE")
    pat = re.compile(r"ssm_runs(?:<[^,>]+, (\d+)>|I\w+?Li(\d+)E)")
    tiles = {int(m.group(1) or m.group(2)) for n in names
             for m in [pat.search(n)] if m}
    if len(tiles) != 1:
        fail(f"segment_softmax: ssm_runs instances {sorted(tiles)} among "
             f"the call's kernels {names}")
    return tiles.pop()


def gat_aggregations(torch, kops, dev, gen, graph) -> dict:
    """GAT's attention softmax and alpha-weighted sums as the benchmark cell
    ``gat-reddit2.infer`` runs them: over ``graph``'s real edges
    (Reddit2's) with a self-loop a node (``add_self_loops``), through the
    ops with the model's plan (``make_model_plan`` at its widest head).
    For each row of :data:`GAT_AGGREGATIONS`: the fp32 softmax of (E', K)
    logits, which must launch the widest head tile of at most 4 that
    divides K (the profiler's ``ssm_runs<float, V>``); then the sum of one
    head's (V, F) fp32 rows weighted by a head of that softmax, which must
    take the runs path and the schedule named there (the counters) and
    equal the column tiles' launch (``c_entry("tiled")``) bitwise. Each
    agrees with the plain version at the fp32 tolerance and is timed beside
    it, the library (``torch.sparse.softmax`` of a (V, E', K) COO,
    ``torch.sparse.mm`` of a CSR whose values are the weights) and its
    bound. {"softmax": {"heads=<k>": {...}}, "weighted_sum":
    {"F=<f>": {...}}}."""
    from repro_torch.data.graphs import add_self_loops
    from repro_torch.kernels import gather_segment_reduce as gsr
    from repro_torch.models.gnn import make_model_plan
    v = graph.num_nodes
    ei = add_self_loops(torch.from_numpy(graph.edge_index).to(dev).int(), v)
    src, dst = ei[0].contiguous(), ei[1].contiguous()
    e = int(dst.numel())
    plan = make_model_plan(ei, v, feat=max(f for _, f, _ in GAT_AGGREGATIONS),
                           device=dev)
    h_rows = int(torch.unique(src).numel())
    # row i of the library's (V, E') COO holds the edges into node i, in
    # the rows' order (destinations sorted), so its values line up
    coo_idx = torch.stack([dst.long(), torch.arange(e, device=dev)])
    where = f"over reddit2 with self-loops ({v} nodes, {e} rows)"
    out = {"softmax": {}, "weighted_sum": {}}
    for heads, f, sched in GAT_AGGREGATIONS:
        x = torch.randn(e, heads, generator=gen, device=dev)
        what = f"segment_softmax heads={heads} float32 {where}"

        def soft(x=x):
            return kops.segment_softmax(x, dst, v, plan=plan, impl="cuda")

        def soft_plain(x=x):
            return kops.segment_softmax(x, dst, v, impl="ref")

        coo = torch.sparse_coo_tensor(coo_idx, x, (v, e, heads)).coalesce()

        def soft_library(coo=coo):
            return torch.sparse.softmax(coo, 1)

        alpha = soft()
        want = soft_plain()
        err = compare(torch, what, alpha, want, torch.float32)
        lib = soft_library()
        if not torch.equal(lib.indices(), coo_idx):
            fail("torch.sparse.softmax yardstick reordered its entries")
        compare(torch, f"torch.sparse.softmax yardstick heads={heads}",
                lib.values(), want, torch.float32)
        del want, lib
        tile = softmax_head_tile(torch, soft)
        want_tile = max(t for t in (1, 2, 4) if heads % t == 0)
        if tile not in (None, want_tile):
            fail(f"{what}: ssm_runs<float, {tile}> launched, expected a "
                 f"tile of {want_tile} heads")
        row = {"head_tile": tile, "max_abs_err": err,
               "ms": time_ms(torch, soft), "plain_ms": time_ms(torch,
                                                              soft_plain),
               "library_ms": time_ms(torch, soft_library)}
        # the segment ids and logits read once, the output written once
        row["bound_ms"], row["bound_by"] = bound(
            e * (4 + 2 * heads * 4), 4 * e * heads)
        print(f"  {what}: ssm_runs<float, {tile}> {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, torch.sparse.softmax "
              f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f}",
              flush=True)
        out["softmax"][f"heads={heads}"] = row
        del coo, x

        # a head's weights, taken out as the model takes them
        w = alpha[:, 0].contiguous()
        del alpha
        h = torch.randn(v, f, generator=gen, device=dev)
        what = (f"gather_segment_reduce sum weighted F={f} float32 {where}")

        def gather(h=h, w=w):
            return kops.gather_segment_reduce(h, src, dst, v, w, "sum",
                                              plan=plan, impl="cuda")

        def gather_tiled(h=h, w=w):
            return gsr.c_entry("tiled", h, src, dst, v, w, "sum",
                               row_ptr=plan.row_ptr, run_rows=plan.config.m_b)

        def gather_plain(h=h, w=w):
            return kops.gather_segment_reduce(h, src, dst, v, w, "sum",
                                              impl="ref")

        csr = torch.sparse_csr_tensor(plan.row_ptr, src.long(), w, (v, v))

        def gather_library(h=h, csr=csr):
            return torch.sparse.mm(csr, h)

        paths, scheds = kops.path_launch_counts(), kops.schedule_launch_counts()
        got = gather()
        took = count_diff(kops.path_launch_counts(),
                          paths)["gather_segment_reduce"]
        took_sched = count_diff(kops.schedule_launch_counts(),
                                scheds)["gather_segment_reduce"]
        if took.get("runs") != 1 or sum(took.values()) != 1:
            fail(f"{what}: launches by path {took}, expected one runs")
        if took_sched.get(sched) != 1 or sum(took_sched.values()) != 1:
            fail(f"{what}: launches by schedule {took_sched}, expected one "
                 f"{sched}")
        torch.cuda.empty_cache()
        want = gather_plain()
        err = compare(torch, what, got, want, torch.float32)
        if not torch.equal(got, gather_tiled()):
            fail(f"{what}: not bitwise the column tiles' output")
        compare(torch, f"torch.sparse.mm yardstick weighted F={f}",
                gather_library(), want, torch.float32)
        del got, want
        row = {"path": "runs", "schedule": sched, "max_abs_err": err,
               "ms": time_ms(torch, gather),
               "plain_ms": time_ms(torch, gather_plain),
               "library_ms": time_ms(torch, gather_library)}
        torch.cuda.empty_cache()
        # the two int32 indices and the fp32 weight of each row, the int64
        # row offsets, the distinct rows of H, the output; a multiply and
        # an add a row element
        row["bound_ms"], row["bound_by"] = bound(
            e * (4 + 4 + 4) + (v + 1) * 8 + h_rows * f * 4 + v * f * 4,
            2 * e * f)
        print(f"  {what}: runs {sched} {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, torch.sparse.mm "
              f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f}; "
              f"bitwise the column tiles", flush=True)
        out["weighted_sum"][f"F={f}"] = row
        del h, w, csr
    torch.cuda.empty_cache()
    return out


def sddmm_runs_call(torch, a, b, row, col):
    """A call of sddmm's runs kernel through its C entry
    (:func:`~repro_torch.kernels.sddmm.c_entry`; A and B in one dtype) on
    the inputs of a wide-path launch: for its time beside the wide path's
    in the same call (not a launch of the op, so not counted)."""
    from repro_torch.kernels import sddmm as sdd

    def call():
        # int32 indices, as the op makes them
        r32, c32 = (t.to(torch.int32).contiguous() for t in (row, col))
        return sdd.c_entry("runs", a, b, r32, c32)
    return call


def took_one_path(torch, kops, kernel, fn) -> str:
    """The path one call of ``fn`` (one launch of ``kernel``) took."""
    kops.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    took = [p for p, n in kops.path_launch_counts()[kernel].items() if n]
    if kops.launch_counts()[kernel] != 1 or len(took) != 1:
        fail(f"{kernel}: one call launched {kops.path_launch_counts()}")
    return took[0]


def cut_rows(row_ptr, run: int):
    """(rows of the segments that runs of ``run`` rows cut, real rows): the
    rows that a row-run kernel folds from partials rather than writing
    whole."""
    a, e = row_ptr[:-1], row_ptr[1:]
    cut = (e > a) & (a // run != (e - 1) // run)
    return int((e - a)[cut].sum()), int(row_ptr[-1])


def library(what: str, call):
    """(result, None) of one library call, or (None, reason) when this
    PyTorch build lacks or refuses it. A library call is a yardstick that is
    timed only, never part of the port, so its failure is printed and the
    run goes on."""
    try:
        return call(), None
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        reason = str(e).splitlines()[0][:200]
        print(f"  {what} yardstick did not run: {reason}", flush=True)
        return None, reason


def _annotation(evt) -> bool:
    """Whether a profiler event is a range's copy on the device timeline
    (``record_function``, and every ``repro_torch.obs`` span while the
    profiler records): it spans the kernels launched inside the range, so
    counting it would count their time again."""
    return bool(getattr(evt, "is_user_annotation", False))


def profiled(torch, fn):
    """(wall ms, device-busy ms, device ops by time as (name, ms, calls))
    of one call of ``fn`` under ``torch.profiler``: device events only
    (kernels and copies, not the ranges' copies), so a host op's
    attributed device time is not counted twice."""
    from torch.autograd import DeviceType
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or _annotation(evt):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows


def port_kernel_names(*sources) -> set:
    """The names of the ``__global__`` functions in the port's CUDA
    sources: those named (file names in ``kernels/csrc``), else all."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    names = set()
    for f in ([csrc / n for n in sources] if sources
              else csrc.glob("*.cu*")):
        names.update(pat.findall(f.read_text()))
    return names


def kernels_in_call(torch, fn, names) -> dict:
    """{kernel: times} of the port's CUDA kernels that a call of ``fn``
    runs, read from the device events of ``torch.profiler`` (host and
    device activities, as :func:`profiled`); empty when the profiler
    recorded no device events."""
    from torch.autograd import DeviceType
    # the name as demangled ("::ssm_runs<float, 4>(") or mangled
    # ("8ssm_runsIfLi4E", "7ssm_fixEPKi")
    pat = re.compile(r"(?<![A-Za-z_])(" + "|".join(sorted(names))
                     + r")(?=[<(IE])")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = collections.Counter()
    for evt in prof.key_averages():
        hit = pat.search(evt.key) if evt.device_type == DeviceType.CUDA \
            else None
        if hit:
            seen[hit.group(1)] += evt.count
    return dict(seen)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def backward_phase(torch, rt, kops, dev, gen, padded, v, e_real, wts, a_src,
                   a_dst, a_v, am, sizes, rplan, offs):
    """Phase 2c: each op's gradients on the kernels against the plain
    versions' autograd on the card, bitwise over two backwards, and the
    backward roles timed beside their bounds and yardsticks. Returns the
    roles' records."""
    from repro_torch.core.plan import source_order
    gplan = padded.make_plan(feat=HIDDEN, device=dev)  # with its source order
    order = gplan.src_order
    src = torch.from_numpy(padded.edge_index[0]).to(dev)
    dst = torch.from_numpy(padded.edge_index[1]).to(dev)

    def grad_check(what, kernel_fn, plain_fn, leaves, dtype):
        """Gradients of ``kernel_fn()`` (every backward op on a kernel)
        against those of the plain ``plain_fn()`` for one random
        cotangent, at the phase's tolerance; two backwards bitwise equal."""
        out = kernel_fn()
        ct = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        ct = torch.where(torch.isfinite(out), ct, torch.zeros_like(ct))

        def grads():
            # the backward records in its forward's scope, whatever thread
            # the autograd engine runs it on
            with kops.fusion_scope() as fusion:
                got = torch.autograd.grad(kernel_fn(), leaves, ct)
            if not fusion or any(not k.startswith("fused:") for k in fusion):
                fail(f"{what}: an op took a plain version: "
                     f"{sorted(fusion)}")
            return got
        got = grads()
        torch.cuda.synchronize()
        want = torch.autograd.grad(plain_fn(), leaves, ct)
        err = max(compare(torch, f"{what} grad {i}", a, b, dtype)
                  for i, (a, b) in enumerate(zip(got, want)))
        deterministic(torch, f"{what} backward", lambda: torch.cat(
            [t.reshape(-1).float() for t in grads()]))
        print(f"  {what} backward: max_abs_err={err:.3g}", flush=True)
        return err

    f32, bf16 = torch.float32, torch.bfloat16
    h64 = torch.randn(v, HIDDEN, generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        for weighted in (False, True):
            h = h64.clone().requires_grad_()
            w = wts.clone().requires_grad_()
            if weighted:
                leaves = [h, w]
                k_fn = (lambda: rt.index_weight_segment_reduce(
                    h, src, w, dst, v, reduce, None, None, gplan))
                p_fn = (lambda: kops.gather_segment_reduce(
                    h, src, dst, v, w, reduce, impl="ref"))
            else:
                leaves = [h]
                k_fn = (lambda: rt.index_segment_reduce(
                    h, src, dst, v, reduce, None, None, gplan))
                p_fn = (lambda: kops.gather_segment_reduce(
                    h, src, dst, v, None, reduce, impl="ref"))
            grad_check(f"index{'_weight' if weighted else ''}_segment_reduce "
                       f"{reduce} F={HIDDEN} float32", k_fn, p_fn, leaves,
                       f32)
    h32 = torch.randn(v, FEAT, generator=gen, device=dev)
    wm32 = torch.randn(FEAT, HIDDEN, generator=gen, device=dev) / FEAT ** 0.5
    for dtype, reduce, weighted in ((f32, "sum", True), (bf16, "sum", True),
                                    (f32, "mean", False)):
        h = h32.to(dtype).requires_grad_()
        wm = wm32.to(dtype).requires_grad_()
        w = wts.to(dtype).requires_grad_() if weighted else None
        leaves = [h, wm] + ([w] if weighted else [])
        grad_check(f"fused_transform_reduce {reduce}"
                   f"{' weighted' if weighted else ''} {FEAT}->{HIDDEN} "
                   f"{str(dtype)[6:]}",
                   lambda: rt.fused_transform_reduce(
                       h, wm, src, w, dst, v, reduce, None, None, gplan),
                   lambda: kops.fused_transform_reduce(
                       h, wm, src, dst, v, w, reduce, impl="ref"),
                   leaves, dtype)
    heads = 4
    logit_v = torch.randn(v, heads, generator=gen, device=dev)
    lv = logit_v.clone().requires_grad_()
    grad_check(f"gather ({v}, {heads}) by the sources",
               lambda: rt.gather(lv, src),
               lambda: lv.index_select(0, src.long()), [lv], f32)
    x_soft = torch.randn(dst.numel(), heads, generator=gen, device=dev) * 5
    for dtype in (f32, bf16):
        xs = x_soft.to(dtype).requires_grad_()
        grad_check(f"segment_softmax heads={heads} {str(dtype)[6:]}",
                   lambda: rt.segment_softmax(xs, dst, v, None, None, gplan),
                   lambda: kops.segment_softmax(xs, dst, v, impl="ref"),
                   [xs], dtype)
    sa = torch.randn(a_v, HIDDEN, generator=gen, device=dev).requires_grad_()
    sb = torch.randn(a_v, HIDDEN, generator=gen, device=dev).requires_grad_()
    grad_check(f"sddmm F={HIDDEN} on arxiv's (dst, src) pairs float32",
               lambda: rt.sddmm(sa, sb, a_dst, a_src),
               lambda: kops.sddmm(sa, sb, a_dst, a_src, impl="ref"),
               [sa, sb], f32)
    a_plan = rt.make_plan(a_dst, a_v, feat=HIDDEN, device=dev)
    xr = torch.randn(a_dst.numel(), HIDDEN, generator=gen,
                     device=dev).requires_grad_()
    for reduce in ("sum", "mean", "max"):
        grad_check(f"segment_reduce {reduce} F={HIDDEN} float32",
                   lambda: rt.segment_reduce(xr, a_dst, a_v, reduce, None,
                                             None, a_plan),
                   lambda: kops.segment_reduce(xr, a_dst, a_v, reduce,
                                               impl="ref"), [xr], f32)
    m_typed = am.num_edges
    for k_dim, n_dim, dtype in ((HIDDEN, HIDDEN, f32), (HIDDEN, CLASSES, f32),
                                (HIDDEN, HIDDEN, bf16)):
        xm = torch.randn(m_typed, k_dim, generator=gen,
                         device=dev).to(dtype).requires_grad_()
        wg = (torch.randn(AM_RELATIONS, k_dim, n_dim, generator=gen,
                          device=dev) / k_dim ** 0.5).to(dtype).requires_grad_()
        grad_check(f"segment_matmul {k_dim}->{n_dim} M={m_typed} "
                   f"G={AM_RELATIONS} {str(dtype)[6:]}",
                   lambda: rt.grouped_segment_matmul(xm, sizes, wg, None,
                                                     None, rplan),
                   lambda: kops.segment_matmul(xm, sizes, wg, impl="ref"),
                   [xm, wg], dtype)
        del xm, wg
    torch.cuda.empty_cache()

    # -- the backward roles, timed -------------------------------------------
    roles = []

    def role(name, kernel, fn, plain, bnd, lib_fn, lib_name):
        got = fn()
        torch.cuda.synchronize()
        err = compare(torch, name, got, plain(), f32)
        k_ms, p_ms = time_ms(torch, fn), time_ms(torch, plain)
        lib_ms = None
        if lib_fn is not None:
            lib, reason = library(lib_name, lib_fn)
            if lib is not None:
                compare(torch, f"{lib_name} yardstick", lib, plain(), f32)
                lib_ms = time_ms(torch, lib_fn)
        print(f"  role {name}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} bound_ms={bnd[0]:.4f} library_ms="
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)}", flush=True)
        roles.append({"role": name, "kernel": kernel, "max_abs_err": err,
                      "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                      "bound_by": bnd[1], "library_ms": lib_ms,
                      "library": lib_name})

    keep = dst < v
    src_r, dst_r = src[keep].long(), dst[keep].long()
    g_rows = int(torch.unique(dst_r).numel())
    G = torch.randn(v, HIDDEN, generator=gen, device=dev)
    w_o = wts.index_select(0, order.perm)
    # dH of an unweighted sum: each real edge's index words, the distinct
    # rows of G it reads, the source offsets, dH written once
    walk_bytes = (e_real * 8 + g_rows * HIDDEN * 4 + (v + 1) * 8
                  + v * HIDDEN * 4)
    g_edges = G.index_select(0, dst_r)
    role(f"dH transposed walk, sum F={HIDDEN} fp32 (arxiv bucket)",
         "gather_segment_reduce",
         lambda: kops.transposed_gather(G, order.dst, order.src,
                                        order.row_ptr, v),
         lambda: kops.transposed_gather(G, order.dst, order.src,
                                        order.row_ptr, v, impl="ref"),
         bound(walk_bytes, e_real * HIDDEN),
         lambda: torch.zeros(v, HIDDEN, device=dev).index_add_(0, src_r,
                                                               g_edges),
         "index_add_ of the (E, F) per-edge rows (gathered beforehand)")
    del g_edges
    csr_t = torch.sparse_coo_tensor(torch.stack([src_r, dst_r]), wts[keep],
                                    (v, v)).coalesce().to_sparse_csr()
    role(f"dH transposed walk, weighted sum F={HIDDEN} fp32 (arxiv bucket)",
         "gather_segment_reduce",
         lambda: kops.transposed_gather(G, order.dst, order.src,
                                        order.row_ptr, v, w_o),
         lambda: kops.transposed_gather(G, order.dst, order.src,
                                        order.row_ptr, v, w_o, impl="ref"),
         bound(walk_bytes + e_real * 4, 2 * e_real * HIDDEN),
         lambda: torch.sparse.mm(csr_t, G),
         "torch.sparse.mm of the transposed CSR")
    del csr_t
    # a gather's dH (GAT's per-edge logits) on the unpadded arxiv graph, as
    # training runs it: by the sources (uniform) and by the sorted,
    # zipf-skewed destinations; the function reads the ids and the
    # cotangent rows once and writes dH
    a_e = int(a_dst.numel())
    g4 = torch.randn(a_e, heads, generator=gen, device=dev)
    for label, idx in (("sources", a_src), ("destinations", a_dst)):
        gorder = source_order(idx, None, 0, a_v)
        role(f"dH of a gather ({a_e}, {heads}) -> ({a_v}, {heads}) by the "
             f"{label}, with its sort", "gather_segment_reduce",
             lambda: (lambda o: kops.transposed_gather(g4, o.perm, o.src,
                                                       o.row_ptr, a_v))(
                 source_order(idx, None, 0, a_v)),
             lambda: kops.transposed_gather(g4, gorder.perm, gorder.src,
                                            gorder.row_ptr, a_v, impl="ref"),
             bound(a_e * (4 + heads * 4) + a_v * heads * 4, a_e * heads),
             lambda: torch.zeros(a_v, heads, device=dev).index_add_(
                 0, idx.long(), g4),
             "index_add_ of the (E, heads) rows")
        sort_ms = time_ms(torch, lambda: source_order(idx, None, 0, a_v))
        print(f"  of which the source order (stable sort of {a_e} ids, "
              f"offsets): {sort_ms:.4f} ms", flush=True)
        roles[-1]["sort_ms"] = sort_ms
    pg = torch.randn(dst.numel(), heads, generator=gen, device=dev)
    lengths = torch.bincount(dst_r, minlength=v)
    role(f"segment sum of the softmax backward, ({dst.numel()}, {heads}) "
         "fp32", "segment_reduce",
         lambda: kops.segment_reduce(pg, dst, v, "sum", plan=gplan),
         lambda: kops.segment_reduce(pg, dst, v, "sum", impl="ref"),
         bound(e_real * (4 + heads * 4) + v * heads * 4 + (v + 1) * 8,
               e_real * heads),
         lambda: torch.segment_reduce(pg[:e_real], "sum", lengths=lengths),
         "torch.segment_reduce with per-segment lengths")
    dy = torch.randn(m_typed, CLASSES, generator=gen, device=dev)
    wt = torch.randn(AM_RELATIONS, CLASSES, HIDDEN, generator=gen,
                     device=dev)
    role(f"dX of segment_matmul, Wᵀ {CLASSES}->{HIDDEN} fp32 (AM typed rows)",
         "segment_matmul",
         lambda: kops.segment_matmul(dy, sizes, wt, plan=rplan),
         lambda: kops.segment_matmul(dy, sizes, wt, impl="ref"),
         smm_bound(torch, m_typed, CLASSES, HIDDEN, AM_RELATIONS, f32,
                   rplan.offsets.numel() * 4 + rplan.first_group.numel() * 8),
         lambda: torch._grouped_mm(dy, wt, offs=offs),
         "torch._grouped_mm with the group offsets")
    del dy, wt, G, g4, pg
    torch.cuda.empty_cache()
    return roles


# the kernels each trained family's step must launch (forward and backward)
TRAIN_KERNELS = {
    "gcn": ("fused_transform_reduce", "gather_segment_reduce"),
    "gin": ("gather_segment_reduce",),
    "sage": ("fused_transform_reduce", "gather_segment_reduce"),
    "gat": ("segment_softmax", "gather_segment_reduce", "sddmm",
            "segment_reduce"),
    "rgcn": ("segment_matmul", "gather_segment_reduce"),
}


class _Fixed:
    """A provider whose every batch is one graph."""

    def __init__(self, graph):
        self.graph = graph

    def batch(self, step):
        return self.graph


class _Killed(Exception):
    """Raised from a step's callback: not in the loop's catch list."""


def step0_layer_grads(torch, family, t_kernel, t_ref, batch):
    """The step-0 gradients through the kernels against ``impl="ref"``,
    layer by layer: each layer gets the input the kernel path's forward
    gives it and one random cotangent, and its parameter and input
    gradients on both paths must agree at the phase's tolerance. Returns
    (max abs error, ReLU inputs that the two whole forwards put on opposite
    sides of 0). Layer by layer because a ReLU input within rounding of 0
    may fall on either side on the two paths; its gradient then passes on
    one path and not the other, which moves every weight-gradient element
    contracting over that row by a whole term (beyond an element-wise tier
    once a contraction spans ~10^5 rows, as rgcn's first layer does)."""
    from repro_torch.models.gnn import TYPED_MODELS
    params = t_kernel.init_state().params
    skeleton = t_kernel.task._skeleton()
    x0 = t_kernel.task.prepare(batch)[0]["x"]
    gen = torch.Generator(device=x0.device).manual_seed(SEED)
    err, flips = 0.0, 0
    h = {None: x0, "ref": x0}               # each path's input to layer i
    last = len(skeleton.layers) - 1
    for i, layer in enumerate(skeleton.layers):
        sub = {k.split(".", 2)[2]: p for k, p in params.items()
               if k.startswith(f"layers.{i}.")}
        grads, pre, ct = {}, {}, None
        for impl, t in ((None, t_kernel), ("ref", t_ref)):
            arrays, _ = t.task.prepare(batch)
            kw = dict(impl=impl, plan=arrays["plan"])
            if family in TYPED_MODELS:
                kw.update({k: arrays[k] for k in (
                    "edge_type", "type_perm", "inv_type_perm", "type_counts",
                    "rplan")})

            def call(x):
                return torch.func.functional_call(
                    layer, sub, (x, arrays["edge_index"], batch.num_nodes,
                                 arrays["deg_inv_sqrt"]), kw)
            # the gradients on the kernel path's input, one cotangent
            xin = h[None].detach().requires_grad_(i > 0)
            y = call(xin)
            if ct is None:
                ct = torch.randn(y.shape, generator=gen, device=y.device)
            leaves = ([xin] if i > 0 else []) + list(sub.values())
            grads[impl] = torch.autograd.grad(y, leaves, ct)
            # the layer on its own path's input: the whole forward
            with torch.no_grad():
                pre[impl] = y.detach() if impl is None else call(h["ref"])
        for n, (a, b) in enumerate(zip(grads[None], grads["ref"])):
            err = max(err, compare(torch, f"{family} step-0 layer {i} "
                                   f"gradient {n}", a, b, torch.float32))
        if i < last:
            flips += int(((pre[None] > 0) != (pre["ref"] > 0)).sum())
            h = {impl: torch.relu(y) for impl, y in pre.items()}
    return err, flips


def train_family(torch, family, data, task_kw, steps, ckpt_root):
    """Phase 3d for one family: ``repro_torch.fit`` through the kernels,
    held against ``impl="ref"`` on the card; a second run and a run
    checkpointed at step 3 and resumed, both bitwise the first; the warm
    step time, its forward / backward / optimizer split, one profiled
    step's idle share, peak memory. Returns the family's record."""
    from repro_torch import train
    from repro_torch.kernels import ops as kops
    from repro_torch.optim import adamw
    cfg = train.TrainerConfig(steps=steps, warmup_steps=2,
                              opt=adamw.AdamWConfig(lr=1e-2))

    def trainer(impl=None, **kw):
        task = train.NodeClassification(model=family, impl=impl, **task_kw)
        return train.Trainer(task, data, dataclasses.replace(cfg, **kw))

    # the run through the kernels, each step's end marked on the stream
    ends = []

    def mark(step, metrics, verdict):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)

    t1 = trainer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kops.launch_counts()
    with kops.fusion_scope() as fusion:
        run1 = t1.fit(metrics_cb=mark)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {k: n - before[k] for k, n in kops.launch_counts().items()}
    print(f"  {family} trained {steps} steps: losses {run1.losses}; "
          f"launched {launched}", flush=True)
    if any(not k.startswith("fused:") for k in fusion):
        fail(f"{family} training: an op took a plain version: "
             f"{sorted(k for k in fusion if not k.startswith('fused:'))}")
    for k in TRAIN_KERNELS[family]:
        if launched[k] == 0:
            fail(f"{family} training: kernel {k} of its path never launched")
    if not all(math.isfinite(x) for x in run1.losses):
        fail(f"{family} training: a loss is not finite: {run1.losses}")
    step_ms = [ends[k - 1].elapsed_time(ends[k]) for k in range(1, steps)]
    warm_ms = statistics.median(step_ms[1:] if steps > 3 else step_ms)

    # the same run again: the same bits
    run2 = trainer().fit()
    if run2.losses != run1.losses or any(
            not torch.equal(p, run2.state.params[k])
            for k, p in run1.state.params.items()):
        fail(f"{family} training: two runs from one state differ")
    # killed after its checkpoint at step 3 (the last step but one of a
    # shorter run), resumed: the uninterrupted run
    at = min(3, steps - 1)
    ckpt_dir = os.path.join(ckpt_root, family)

    def killer(step, metrics, verdict):
        if step == at:
            raise _Killed()
    try:
        trainer(ckpt_dir=ckpt_dir, ckpt_every=at).fit(metrics_cb=killer)
        fail(f"{family} training: the killed run was not killed")
    except _Killed:
        pass
    resumed = trainer(ckpt_dir=ckpt_dir, ckpt_every=at).fit(resume=True)
    if (resumed.start_step != at or resumed.losses != run1.losses[at:]
            or any(not torch.equal(p, resumed.state.params[k])
                   for k, p in run1.state.params.items())):
        fail(f"{family} training: the resumed run (from step "
             f"{resumed.start_step}, losses {resumed.losses}) is not the "
             "uninterrupted one")
    print(f"  {family}: a second run and a run resumed from its step-{at} "
          "checkpoint are bitwise the first", flush=True)

    # held against the plain versions on the card
    t_ref = trainer("ref")
    ref = t_ref.fit()
    for i, (a, b) in enumerate(zip(run1.losses, ref.losses)):
        if not abs(a - b) <= 1e-4 * abs(b):
            fail(f"{family} training: step {i} loss {a!r} vs the plain "
                 f"versions' {b!r} (rtol 1e-4)")
    batch = data.batch(0)
    grad_err, flips = step0_layer_grads(torch, family, t1, t_ref, batch)
    print(f"  {family}: losses within rtol 1e-4 of impl='ref' "
          f"({ref.losses}); step-0 gradients layer by layer within the "
          f"phase's tolerance (max_abs_err={grad_err:.3g}); ReLU inputs of "
          f"the two whole forwards on opposite sides of 0: {flips}",
          flush=True)
    del t_ref, ref

    # the warm step's split, from the trained state
    st = run1.state
    arrays, static = t1.task.prepare(batch)
    params = list(st.params.values())
    fwd_ms = time_ms(torch, lambda: t1.task.loss(st.params, arrays, static),
                     reps=5, warmup=1)
    loss, _ = t1.task.loss(st.params, arrays, static)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        loss, params, retain_graph=True), reps=5, warmup=1)
    grads = dict(zip(st.params, torch.autograd.grad(loss, params)))
    # the trainer's own update, in place (st is not read again but by the
    # profiled step below)
    opt_ms = time_ms(torch, lambda: adamw.update_(
        grads, st.opt_state, st.params, cfg.opt), reps=5, warmup=1)
    wall_ms, busy_ms, rows = profiled(torch, lambda: t1.step(st, steps))
    rec = {"family": family, "steps": steps, "losses": run1.losses,
           "warm_step_ms": warm_ms, "step_ms": step_ms,
           "forward_ms": fwd_ms, "backward_ms": bwd_ms,
           "optimizer_ms": opt_ms, "profiled_wall_ms": wall_ms,
           "device_busy_ms": busy_ms or None,
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "peak_alloc_gib": peak_gib, "step0_grad_max_abs_err": grad_err,
           "relu_flips_step0": flips,
           "launches": launched}
    print(f"  {family}: warm_step_ms={warm_ms:.3f} (steps {step_ms}); "
          f"forward_ms={fwd_ms:.3f} backward_ms={bwd_ms:.3f} "
          f"optimizer_ms={opt_ms:.3f}; peak_alloc_gib={peak_gib:.2f}",
          flush=True)
    if busy_ms:
        print(f"  profiled {family} step: wall_ms={wall_ms:.3f} "
              f"device_busy_ms={busy_ms:.3f} idle_share="
              f"{1 - busy_ms / wall_ms:.3f}; top device ops:", flush=True)
        for key, ms, calls in rows[:14]:
            print(f"    {ms:9.3f} ms {calls:4d} calls  {key[:90]}",
                  flush=True)
    else:
        print(f"  profiled {family} step: device time not measured (the "
              "profiler recorded no device events)", flush=True)
    return rec


def training_phase(torch, am):
    """Phase 3d: gcn, gin, sage and gat (4 heads) on the ogbn-arxiv-size
    graph, rgcn on the AM-scale typed graph, trained through
    ``repro_torch.fit`` under deterministic algorithms."""
    from repro_torch import train
    torch.use_deterministic_algorithms(True)
    # every kernel writes each element of its output: filling fresh
    # buffers would add device work that no step needs
    torch.utils.deterministic.fill_uninitialized_memory = False
    from repro_torch.data.graphs import TABLE_II
    from repro_torch.models.gnn import MODELS
    name, v, e = next(row for row in TABLE_II if row[0] == "ogbn-arxiv")
    data = train.GraphEpochProvider(shapes=((v, e),), graphs_per_shape=1,
                                    feat=FEAT, num_classes=CLASSES,
                                    seed=SEED, name=name)
    records = []
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for family in MODELS:
            task_kw = dict(d_in=FEAT, hidden=HIDDEN, num_classes=CLASSES,
                           heads=4 if family == "gat" else 1)
            records.append(train_family(torch, family, data, task_kw,
                                        TRAIN_STEPS, ckpt_root))
            torch.cuda.empty_cache()
        cfg = data.batch(0).make_plan(HIDDEN, device="cuda").config
        print(f"  training plan config (generated rules): m_b={cfg.m_b} "
              f"s_b={cfg.s_b}", flush=True)
        records.append(train_family(
            torch, "rgcn", _Fixed(am),
            dict(d_in=FEAT, hidden=HIDDEN, num_classes=CLASSES,
                 num_relations=AM_RELATIONS), TYPED_TRAIN_STEPS, ckpt_root))
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    return records


class _Seen:
    """A provider that remembers each step's batch size and bucket."""

    def __init__(self, data):
        self.data = data
        self.sizes = {}

    def batch(self, step):
        b = self.data.batch(step)
        self.sizes[step] = (b.graph.orig_num_nodes, b.graph.orig_num_edges,
                            str(b.bucket))
        return b


def sampled_train_family(torch, family, store, seeds, ckpt_root):
    """Phase 3e check 4 for one family: ``SAMPLED_STEPS`` sampled steps
    through ``repro_torch.fit`` on the kernels, held against ``impl="ref"``
    on the card; a second run and a run killed after its checkpoint at
    step ``SAMPLED_KILL_AT`` and resumed, both bitwise the first; one
    bucket entry built per bucket; the warm step, the pipeline's overlap,
    one profiled step's idle share, peak memory. Returns the record."""
    from repro_torch import train
    from repro_torch.kernels import ops as kops
    from repro_torch.optim import adamw
    cfg = train.TrainerConfig(steps=SAMPLED_STEPS, warmup_steps=2,
                              opt=adamw.AdamWConfig(lr=1e-2))
    heads = 4 if family == "gat" else 1

    def trainer(data, impl=None, **kw):
        task = train.NodeClassification.from_provider(
            data.data, model=family, hidden=HIDDEN, heads=heads, impl=impl)
        return train.Trainer(task, data, dataclasses.replace(cfg, **kw))

    ends = []

    def mark(step, metrics, verdict):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)

    with train.SampledNodeProvider(
            store, fanouts=SAMPLED_FANOUTS, batch_size=SAMPLED_BATCH,
            seed_nodes=seeds, seed=SEED, plan_feat=HIDDEN,
            depth=SAMPLED_DEPTH) as provider:
        data = _Seen(provider)
        t1 = trainer(data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live_gib = torch.cuda.memory_allocated() / 2 ** 30
        before = kops.launch_counts()
        with kops.fusion_scope() as fusion:
            run1 = t1.fit(metrics_cb=mark)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 - live_gib
        launched = {k: n - before[k] for k, n in kops.launch_counts().items()}
        pipe = provider.stats()
        print(f"  {family} trained {SAMPLED_STEPS} sampled steps: losses "
              f"{run1.losses}; launched {launched}", flush=True)
        if any(not k.startswith("fused:") for k in fusion):
            fail(f"sampled {family}: an op took a plain version: "
                 f"{sorted(k for k in fusion if not k.startswith('fused:'))}")
        for k in TRAIN_KERNELS[family]:
            if launched[k] == 0:
                fail(f"sampled {family}: kernel {k} of its path never "
                     "launched")
        if not all(math.isfinite(x) for x in run1.losses):
            fail(f"sampled {family}: a loss is not finite: {run1.losses}")
        # one entry built per bucket: the run's buckets are the probed
        # schedule's, and no cache line was built twice (the prefetch may
        # have made up to SAMPLED_DEPTH batches past the last step)
        probed = provider.producer.buckets_for_warmup(SAMPLED_STEPS)
        ahead = provider.producer.buckets_for_warmup(
            SAMPLED_STEPS + SAMPLED_DEPTH)
        cached = {key[0] for key in provider.producer.cache.keys()}
        ran = {(s.num_nodes, s.num_edges) for s in run1.buckets}
        if (len(run1.buckets) != len(probed)
                or ran != {(b.num_nodes, b.num_edges) for b in probed}
                or pipe["cache"]["plan_builds"] != len(cached)
                or not set(probed) <= cached <= set(ahead)):
            fail(f"sampled {family}: buckets {sorted(ran)} vs the probed "
                 f"{probed}; plan_builds {pipe['cache']['plan_builds']} for "
                 f"the cached {sorted(map(str, cached))}")
        step_ms = [ends[k - 1].elapsed_time(ends[k])
                   for k in range(1, SAMPLED_STEPS)]
        warm_ms = statistics.median(step_ms[1:])    # steps 2..19

        # the same run again: the same bits
        run2 = trainer(data).fit()
        if run2.losses != run1.losses or any(
                not torch.equal(p, run2.state.params[k])
                for k, p in run1.state.params.items()):
            fail(f"sampled {family}: two runs from one state differ")
        at = SAMPLED_KILL_AT
        ckpt_dir = os.path.join(ckpt_root, f"sampled-{family}")

        def killer(step, metrics, verdict):
            if step == at:
                raise _Killed()
        try:
            trainer(data, ckpt_dir=ckpt_dir, ckpt_every=at).fit(
                metrics_cb=killer)
            fail(f"sampled {family}: the killed run was not killed")
        except _Killed:
            pass
        resumed = trainer(data, ckpt_dir=ckpt_dir, ckpt_every=at).fit(
            resume=True)
        if (resumed.start_step != at or resumed.losses != run1.losses[at:]
                or any(not torch.equal(p, resumed.state.params[k])
                       for k, p in run1.state.params.items())):
            fail(f"sampled {family}: the resumed run (from step "
                 f"{resumed.start_step}, losses {resumed.losses}) is not "
                 "the uninterrupted one")
        ref = trainer(data, "ref").fit()
        for i, (a, b) in enumerate(zip(run1.losses, ref.losses)):
            if not abs(a - b) <= 1e-4 * abs(b):
                fail(f"sampled {family}: step {i} loss {a!r} vs the plain "
                     f"versions' {b!r} (rtol 1e-4)")
        print(f"  {family}: losses within rtol 1e-4 of impl='ref'; a second "
              f"run and a run resumed from its step-{at} checkpoint are "
              "bitwise the first", flush=True)
        wall_ms, busy_ms, rows = profiled(
            torch, lambda: t1.step(run1.state, SAMPLED_STEPS))
    # the same run with the blocking loader (depth 0): no producer thread
    # competes with the step for the interpreter lock
    ends.clear()
    with train.SampledNodeProvider(
            store, fanouts=SAMPLED_FANOUTS, batch_size=SAMPLED_BATCH,
            seed_nodes=seeds, seed=SEED, plan_feat=HIDDEN,
            depth=0) as blocking:
        run0 = trainer(_Seen(blocking)).fit(metrics_cb=mark)
        pipe0 = blocking.stats()
    if run0.losses != run1.losses:
        fail(f"sampled {family}: the blocking loader's run differs")
    step0_ms = [ends[k - 1].elapsed_time(ends[k])
                for k in range(1, SAMPLED_STEPS)]
    sizes = [data.sizes[s] for s in range(SAMPLED_STEPS)]
    rec = {"family": family, "steps": SAMPLED_STEPS,
           "losses": run1.losses, "warm_step_ms": warm_ms,
           "step_ms": step_ms,
           "produce_s_median_steady": pipe["produce_s_median_steady"],
           "wait_s_median_steady": pipe["wait_s_median_steady"],
           "overlap": pipe["overlap"], "sync_falls": pipe["sync_falls"],
           "batch_nodes": [v for v, _, _ in sizes],
           "batch_edges": [e for _, e, _ in sizes],
           "buckets": sorted({b for _, _, b in sizes}),
           "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "peak_alloc_gib": peak_gib, "live_before_gib": live_gib,
           "depth0_warm_step_ms": statistics.median(step0_ms[1:]),
           "depth0_produce_s_median_steady":
               pipe0["produce_s_median_steady"],
           "launches": launched}
    print(f"  {family}: warm_step_ms={warm_ms:.3f} (steps {step_ms}); "
          f"produce_s median {pipe['produce_s_median_steady']:.4f}, wait_s "
          f"median {pipe['wait_s_median_steady']:.4f}, overlap "
          f"{pipe['overlap']:.3f}; batches (V, E) {sizes[:4]} ... buckets "
          f"{rec['buckets']}; peak_alloc_gib={peak_gib:.3f} above "
          f"{live_gib:.3f} live; at depth 0 (bitwise the same losses): "
          f"warm_step_ms={rec['depth0_warm_step_ms']:.3f}, produce_s median "
          f"{pipe0['produce_s_median_steady']:.4f}", flush=True)
    if busy_ms:
        print(f"  profiled sampled {family} step: wall_ms={wall_ms:.3f} "
              f"device_busy_ms={busy_ms:.3f} idle_share="
              f"{1 - busy_ms / wall_ms:.3f}; top device ops:", flush=True)
        for key, ms, calls in rows[:8]:
            print(f"    {ms:9.3f} ms {calls:4d} calls  {key[:90]}",
                  flush=True)
    else:
        print(f"  profiled sampled {family} step: device time not measured "
              "(the profiler recorded no device events)", flush=True)
    return rec


def sampled_phase(torch, graph, dev):
    """Phase 3e: sampled mini-batches on ``dev`` (the card; see the module
    docstring); returns (training records, the sampled-serving record, the
    exact samples' max abs errors)."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.data.pipeline import (PrefetchPipeline,
                                           SampledBatchProducer)
    from repro_torch.data.sampling import (InMemoryStore, NeighborSampler,
                                           ShardedGraphStore,
                                           save_graph_shards)
    from repro_torch.kernels import ops as kops
    from repro_torch.models import gnn
    from repro_torch.serve import GNNServer
    store = InMemoryStore(graph)
    # seeds drawn from all nodes would give ~2 k edges a batch: the
    # synthetic graph puts every in-edge on a few nodes
    seeds = np.unique(graph.edge_index[1]).astype(np.int64)
    print(f"  {seeds.size} of {graph.num_nodes} nodes have in-edges: the "
          "seeds", flush=True)

    def sampler(**kw):
        kw.setdefault("fanouts", SAMPLED_FANOUTS)
        kw.setdefault("batch_size", SAMPLED_BATCH)
        return NeighborSampler(store, seed_nodes=seeds, seed=SEED, **kw)

    def tensors(b):
        p, o = b.plan, b.plan.src_order
        return [b.arrays[k] for k in sorted(b.arrays)] + [
            p.row_ptr, o.perm, o.src, o.dst, o.row_ptr]

    obs.reset()                 # the report covers this phase
    snap = obs.get_registry().snapshot()
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sampled_")
    try:
        with kops.fusion_scope() as phase_fusion:
            # 1. a sharded store of 8 shards gives the in-memory stream. Its
            # LRU holds all 8: random seeds touch every shard from every
            # node's expansion, so a smaller LRU re-reads shard files for
            # most nodes
            t0 = time.perf_counter()
            save_graph_shards(graph, os.path.join(tmp, "shards"), 8)
            shard_store = ShardedGraphStore(os.path.join(tmp, "shards"),
                                            cache_shards=8)
            sharded = NeighborSampler(
                shard_store, SAMPLED_FANOUTS, batch_size=SAMPLED_BATCH,
                seed_nodes=seeds, seed=SEED)
            mem = sampler()
            for s in range(8):
                a, b = mem.sample_batch(s), sharded.sample_batch(s)
                for f in ("node_ids", "edge_index", "x", "labels",
                          "deg_inv_sqrt"):
                    if not np.array_equal(getattr(a, f), getattr(b, f)):
                        fail(f"sampled: step {s} {f} of the sharded store "
                             "differs from the in-memory one")
            print(f"  check 1: 8 batches of an 8-shard store are bitwise the "
                  f"in-memory ones ({shard_store.loads} shard loads, "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)

            # 2. depth 0 and depth 2 with 2 threads: the same device bits
            t0 = time.perf_counter()
            streams = {}
            for depth, threads in ((0, 1), (SAMPLED_DEPTH, 2)):
                prod = SampledBatchProducer(sampler(), feat=HIDDEN)
                with PrefetchPipeline(prod, depth=depth,
                                      num_threads=threads) as pipe:
                    streams[depth] = [tensors(pipe.batch(s))
                                      for s in range(8)]
            for s, (a, b) in enumerate(zip(streams[0],
                                           streams[SAMPLED_DEPTH])):
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    fail(f"sampled: step {s}'s device tensors differ between "
                         f"depth 0 and depth {SAMPLED_DEPTH}")
            del streams
            print(f"  check 2: 8 batches' device tensors bitwise equal at "
                  f"depth 0 and depth {SAMPLED_DEPTH} with 2 threads "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)

            # 3. an exact 3-hop sample around 64 seeds: the full graph's
            # logits on the seed rows
            t0 = time.perf_counter()
            exact = SampledBatchProducer(
                sampler(fanouts=(None,) * 3, exact=True,
                        batch_size=EXACT_SEEDS), feat=HIDDEN).produce(0)
            exact.ready()
            exact_s = time.perf_counter() - t0
            x = torch.from_numpy(graph.x).to(dev)
            ei = torch.from_numpy(graph.edge_index).to(dev)
            dis = torch.from_numpy(graph.deg_inv_sqrt).to(dev)
            plan = graph.make_plan(HIDDEN)
            rows = torch.from_numpy(exact.seed_nodes).to(dev)
            a = exact.arrays
            exact_err = {}
            for family in SAMPLED_FAMILIES:
                model = gnn.init(family, FEAT, HIDDEN, CLASSES, seed=SEED,
                                 heads=4 if family == "gat" else 1)
                with torch.no_grad():
                    full = model(x, ei, graph.num_nodes, dis, plan=plan)
                    sub = model(a["x"], a["edge_index"],
                                exact.bucket.num_nodes, a["deg_inv_sqrt"],
                                plan=exact.plan)
                exact_err[family] = compare(
                    torch, f"exact-sampled {family} seed logits",
                    sub[:exact.num_seeds], full.index_select(0, rows),
                    torch.float32)
            print(f"  check 3: an exact 3-hop sample around {EXACT_SEEDS} "
                  f"seeds ({exact.graph.orig_num_nodes} nodes, "
                  f"{exact.graph.orig_num_edges} edges, bucket "
                  f"{exact.bucket}, made in {exact_s:.2f} s) gives the full "
                  f"graph's seed logits: max_abs_err {exact_err}", flush=True)
            del x, ei, dis, plan, exact, a

            # 4. training
            t0 = time.perf_counter()
            records = []
            for family in SAMPLED_FAMILIES:
                records.append(sampled_train_family(torch, family, store,
                                                    seeds, tmp))
                torch.cuda.empty_cache()
            print(f"  check 4: {len(records)} families trained "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            t0 = time.perf_counter()

            # 5. sampled serving
            srv = GNNServer(gnn.init("gcn", FEAT, HIDDEN, CLASSES,
                                     seed=SEED), "gcn")
            serve_ms, serve_err, first = [], 0.0, None
            with srv.sampled_pipeline(sampler(),
                                      depth=SAMPLED_DEPTH) as pipe:
                for s in range(SAMPLED_STEPS):
                    b = pipe.batch(s)
                    t0 = time.perf_counter()
                    got = srv.serve_sampled(b)
                    serve_ms.append((time.perf_counter() - t0) * 1e3)
                    a = b.arrays
                    with torch.no_grad():
                        want = srv.model(a["x"], a["edge_index"],
                                         b.bucket.num_nodes,
                                         a["deg_inv_sqrt"], impl="ref")
                    serve_err = max(serve_err, compare(
                        torch, f"served sampled gcn step {s}",
                        torch.from_numpy(got),
                        want[:b.num_seeds].float().cpu(), torch.float32))
                    first = got if first is None else first
            st = srv.stats()
            if st["builds"] != len(srv.cache):
                fail(f"sampled serving: {st['builds']} builds for "
                     f"{len(srv.cache)} cache entries")
            builds = srv.builds
            foreign = SampledBatchProducer(sampler(), feat=HIDDEN).produce(0)
            got = srv.serve_sampled(foreign)
            root = obs.spans("serve.step")[-1]
            stamp = root.find("serve.stamp")
            if (srv.builds != builds or stamp is None
                    or stamp.attrs.get("restamp") is not True
                    or not np.array_equal(got, first)):
                fail("sampled serving: the foreign-cache batch was not "
                     "restamped into the same logits without a build")
            serving = {"batches": SAMPLED_STEPS,
                       "serve_ms_median": statistics.median(serve_ms[1:]),
                       "serve_ms": serve_ms, "max_abs_err": serve_err,
                       "builds": st["builds"], "cache_entries": len(srv.cache),
                       "foreign_restamped": True}
            print("  sampled bucket configs (generated rules): "
                  + ", ".join(f"{ent.bucket}: m_b={ent.config.m_b} "
                              f"s_b={ent.config.s_b}"
                              for _, ent in srv.cache.entries()), flush=True)
            print(f"  check 5: served {SAMPLED_STEPS} sampled gcn batches "
                  f"(median {serving['serve_ms_median']:.3f} ms, "
                  f"max_abs_err {serve_err:.3g}); builds {st['builds']} == "
                  f"cache entries; a foreign-cache batch restamped with no "
                  f"build ({time.perf_counter() - t0:.1f} s)", flush=True)

            # 6. one served request's span tree
            srv.submit(mem.sample_batch(0))
            srv.step(flush=True)
            stages = obs.spans("serve.step")[-1].stages()
            if not set(SERVE_STAGES) <= stages:
                fail(f"obs: a served step's spans {sorted(stages)} miss "
                     f"{sorted(set(SERVE_STAGES) - stages)}")
            del srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    mirror = {f"{r['labels']['kind']}:{r['labels']['op']}": int(r["value"])
              for r in obs.get_registry().delta(snap)
              if r["name"] == "kernel.launches" and r["value"]}
    if mirror != dict(phase_fusion):
        fail(f"obs: kernel.launches over the phase {mirror} != the fusion "
             f"accounting {dict(phase_fusion)}")
    print(f"  check 6: kernel.launches equals the fusion accounting over the "
          f"phase ({sum(mirror.values())} events); a served step's span tree "
          f"holds {', '.join(SERVE_STAGES)}", flush=True)
    print(obs.report(), flush=True)
    return records, serving, exact_err


# phase 3f: timings a candidate of a sweep takes (median of CUDA events)
SELECTION_REPS = 20


def selection_phase(torch, dev, graphs, am):
    """Phase 3f: config selection. Sweeps the built instances with
    ``autotune.tune`` into a PerfDB in a temporary directory (every
    candidate held against its plain version inside ``tune``), replays
    each sweep from the DB with no timing, distills rules from the DB with
    ``train_rules --from-perfdb`` and loads them, serves the arxiv gcn
    request through ``GNNServer(tune=True)`` on that DB, and times the
    three transform orders beside ``choose_order``'s pick. With
    ``REPRO_PERFDB_PATH`` set the sweeps go there (forced fresh) and stay,
    to train rules from later. Returns the phase's record."""
    import importlib.util

    from repro_torch.core import autotune
    from repro_torch.core import mp as tmp
    from repro_torch.core.config_space import default_config
    from repro_torch.core.features import InputFeatures
    from repro_torch.core.heuristics import select_config
    from repro_torch.data.graphs import batch_graphs
    from repro_torch.models import gnn
    from repro_torch.serve import GNNServer, pad_to_bucket
    from repro_torch.serve.plan_cache import BucketEntry

    kept = os.environ.get("REPRO_PERFDB_PATH")
    db_dir = kept or tempfile.mkdtemp(prefix="chip_smoke_perfdb_")
    db = autotune.PerfDB(db_dir)
    arxiv, r2 = graphs["ogbn-arxiv"], graphs["reddit2"]
    a_pad, ab = pad_to_bucket(arxiv)
    r_pad, rb = pad_to_bucket(r2)
    _, mb = pad_to_bucket(batch_graphs([graphs[n] for n in
                                        ("cora", "citeseer", "pubmed")]))
    micro = "cora+citeseer+pubmed bucket"
    sweeps = [
        ("gather_segment_reduce", "arxiv bucket", ab.num_edges,
         ab.num_nodes, HIDDEN, None),
        ("gather_segment_reduce", "arxiv bucket", ab.num_edges,
         ab.num_nodes, FEAT, None),
        ("gather_segment_reduce_mean", "AM typed messages", am.num_edges,
         am.num_nodes, HIDDEN, None),
        ("segment_reduce", "arxiv destinations", arxiv.num_edges,
         arxiv.num_nodes, HIDDEN, None),
        ("fused_transform_reduce", "arxiv bucket", ab.num_edges,
         ab.num_nodes, FEAT, HIDDEN),
        ("fused_transform_reduce", "gcn's reddit2 request", rb.num_edges,
         rb.num_nodes, FEAT, HIDDEN),
        ("gather_segment_reduce", micro, mb.num_edges, mb.num_nodes, HIDDEN,
         None),
        ("fused_transform_reduce", micro, mb.num_edges, mb.num_nodes, FEAT,
         HIDDEN),
    ]
    records = []
    try:
        for op, label, m, s_, f, d_out in sweeps:
            t0 = time.perf_counter()
            kw = dict(idx_size=m, num_segments=s_, feat=f, db=db, d_out=d_out)
            res = autotune.tune(op, reps=SELECTION_REPS, warmup=3,
                                force=bool(kept), **kw)
            if res.timings_performed == 0 or res.cache_hit:
                fail(f"selection: the first sweep of {op} {label} hit the "
                     "PerfDB")
            again = autotune.tune(op, **kw)
            if again.timings_performed != 0 or again.config != res.config:
                fail(f"selection: replaying {op} {label} timed "
                     f"{again.timings_performed} candidates")
            rule = select_config(m, s_, f, op=op, tune=False)
            shipped = default_config(f)
            t_rule, t_ship = res.time_of(rule), res.time_of(shipped)
            if t_rule is None or t_ship is None:
                fail(f"selection: {op} {label} did not time the rules' pick "
                     "and the shipped values")
            ms = {"=".join(map(str, k)): u / 1e3 for k, u in
                  res.timings.items()}
            proj = lambda c: "=".join(  # noqa: E731
                map(str, autotune.config_projection(op, c)))
            rec = {"op": op, "shape": label, "idx_size": m,
                   "num_segments": s_, "feat": f, "d_out": d_out,
                   "candidates_ms": ms, "rule_pick": proj(rule),
                   "rule_ms": t_rule / 1e3, "winner": proj(res.config),
                   "winner_ms": min(res.timings.values()) / 1e3,
                   "shipped_ms": t_ship / 1e3,
                   "rule_over_shipped": t_rule / t_ship}
            records.append(rec)
            width = f"F={f}" + ("" if d_out is None else f"->{d_out}")
            print(f"  {op} at the {label} (E={m}, S={s_}, {width}): "
                  + " ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; rules pick {rec['rule_pick']} "
                  f"({rec['rule_ms']:.4f} ms), measured winner "
                  f"{rec['winner']}, shipped {proj(shipped)} "
                  f"{rec['shipped_ms']:.4f} ms, rules / shipped "
                  f"{rec['rule_over_shipped']:.3f}; every candidate equal "
                  f"to its plain version; the replay timed 0 "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)

        # rules distilled from the measured DB, loaded
        out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_rules_"),
                           "rules_measured.py")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.core.train_rules",
             "--from-perfdb", db_dir, "--out", out],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"selection: train_rules --from-perfdb failed:\n"
                 f"{proc.stdout}{proc.stderr}")
        spec = importlib.util.spec_from_file_location("rules_measured", out)
        rules = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(rules)
        picks = []
        for op, label, m, s_, f, _ in sweeps:
            c = rules.select(*InputFeatures(m, s_, f).as_vector())
            picks.append(f"{label} F={f}: m_b={c.m_b} s_b={c.s_b}")
        print(f"  rules from --from-perfdb ({len(db)} entries) load; they "
              f"pick " + "; ".join(picks), flush=True)

        # the tuned engine: its bucket runs the measured winners
        model = gnn.init("gcn", FEAT, HIDDEN, CLASSES, seed=SEED)
        srv = GNNServer(model, "gcn", max_batch_nodes=1 << 22, tune=True,
                        perfdb=db)
        srv.submit(arxiv)
        (served,) = srv.step(flush=True)
        (entry,) = [e for _, e in srv.cache.entries()
                    if e.bucket == served.bucket]
        kw = dict(idx_size=ab.num_edges, num_segments=ab.num_nodes,
                  feat=srv.feat, db=db)
        g_win = autotune.tune("gather_segment_reduce", **kw)
        f_win = autotune.tune("fused_transform_reduce", **kw)
        if not (g_win.cache_hit and f_win.cache_hit):
            fail("selection: the tuned engine did not store its sweeps")
        if (entry.config.m_b, entry.config.s_b) != (g_win.config.m_b,
                                                    f_win.config.s_b):
            fail(f"selection: the tuned bucket runs {entry.config}, not the "
                 f"measured winners m_b={g_win.config.m_b} "
                 f"s_b={f_win.config.s_b}")
        with torch.inference_mode():
            want = srv.model(torch.from_numpy(arxiv.x).to(dev),
                             torch.from_numpy(arxiv.edge_index).to(dev),
                             arxiv.num_nodes,
                             torch.from_numpy(arxiv.deg_inv_sqrt).to(dev),
                             impl="ref").float().cpu()
        served_err = compare(torch, "tuned engine's arxiv gcn logits",
                             torch.from_numpy(served.logits), want,
                             torch.float32)
        print(f"  GNNServer(tune=True): bucket {served.bucket} runs the "
              f"measured winners m_b={entry.config.m_b} "
              f"s_b={entry.config.s_b}; logits equal impl='ref' "
              f"(max_abs_err={served_err:.3g})", flush=True)
        del srv, model

        # choose_order's pick beside the three orders timed on the card
        gen = torch.Generator(device=dev).manual_seed(SEED)
        orders = []
        for gname, pad, bkt in (("ogbn-arxiv", a_pad, ab),
                                ("reddit2", r_pad, rb)):
            ei = torch.from_numpy(pad.edge_index).to(dev)
            cfg = BucketEntry(bkt, HIDDEN, select_config(
                max(bkt.num_edges, 1), max(min(bkt.num_edges, bkt.num_nodes),
                                           1), HIDDEN, tune=False)).config
            plan = BucketEntry(bkt, HIDDEN, cfg).stamp(ei[1])
            ew = torch.rand(bkt.num_edges, generator=gen, device=dev)
            layers = ([("gcn", "sum", d) for d in ((FEAT, HIDDEN),
                                                    (HIDDEN, HIDDEN),
                                                    (HIDDEN, CLASSES))]
                      + [("sage", "mean", d) for d in ((FEAT, HIDDEN),
                                                       (HIDDEN, HIDDEN),
                                                       (HIDDEN, CLASSES))]
                      if gname == "ogbn-arxiv"
                      else [("gcn", "sum", (FEAT, HIDDEN))])
            for family, reduce, (d_in, d_out) in layers:
                x = torch.randn(bkt.num_nodes, d_in, generator=gen,
                                device=dev)
                w = torch.randn(d_in, d_out, generator=gen,
                                device=dev) / d_in ** 0.5
                wt = ew if reduce == "sum" else None
                pick = tmp.choose_order(d_in, d_out, plan=plan,
                                        allow_fused=True)
                times = {o: time_ms(torch, lambda o=o: tmp.mp_transform(
                    x, w, ei, bkt.num_nodes, reduce=reduce, edge_weight=wt,
                    plan=plan, order=o))
                    for o in ("transform_first", "aggregate_first", "fused")}
                fastest = min(times, key=times.get)
                orders.append({"graph": gname, "family": family,
                               "layer": f"{d_in}->{d_out}", "pick": pick,
                               "ms": times, "fastest": fastest,
                               "pick_over_fastest":
                                   times[pick] / times[fastest]})
                print(f"  choose_order {family} {d_in}->{d_out} at {bkt}: "
                      f"picks {pick}; on the card "
                      + " ".join(f"{o} {t:.4f}" for o, t in times.items())
                      + f" ms; fastest {fastest}"
                      + ("" if pick == fastest else
                         f" ({times[pick] / times[fastest]:.3f}x)"),
                      flush=True)
            del ei, plan, ew, x, w
    finally:
        if not kept:
            shutil.rmtree(db_dir, ignore_errors=True)
    return {"sweeps": records, "orders": orders,
            "tuned_engine_max_abs_err": served_err}


# phase 3g: sharded message passing, one process a rank of SHARDS; the
# process group's timeout ends a hung collective, the join's deadline a
# hung rank
SHARDS, SHARDED_STEPS = 4, 5
SHARDED_PG_TIMEOUT_S, SHARDED_DEADLINE_S = 120, 400
# the kernels the sharded main path must launch on every rank (sddmm: the
# edge-weight gradients of training), and the one it must never launch
SHARDED_KERNELS = ("gather_segment_reduce", "segment_softmax",
                   "segment_reduce", "sddmm")


def profiled_split(torch, fn, names):
    """(wall ms, the port's kernels' device ms, collective host ms) of one
    call of ``fn`` under ``torch.profiler``; the device ms is None when the
    profiler recorded no device events. The collective ms is the host time
    inside the ``gloo:`` / ``nccl:`` ops: gloo runs them on the host, after
    waiting for the kernels queued before each; NCCL's launch returns at
    once, so its time shows as device kernels instead."""
    from torch.autograd import DeviceType
    pat = re.compile(r"(?<![A-Za-z_])(" + "|".join(sorted(names))
                     + r")(?=[<(IE])")
    coll = re.compile(r"^(gloo|nccl):")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = coll_ms = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and pat.search(evt.key):
            us = getattr(evt, "self_device_time_total", None)
            kern += (evt.self_cuda_time_total if us is None else us) / 1e3
        elif evt.device_type == DeviceType.CPU and coll.match(evt.key):
            coll_ms += evt.cpu_time_total / 1e3
    return wall_ms, (kern or None), coll_ms


def sharded_rank(rank: int, world: int, backend: str, store: str,
                 out: str) -> None:
    """Phase 3g on one rank (a spawned process): the sharded ops against
    the unsharded kernels, then the main path with the launch counters
    zeroed (``GNNServer(shards=world)`` for every family, ``fit(mesh=)``
    for gcn and gat), then the unsharded references. An exception ends the
    process with a non-zero exit code; rank 0 writes the phase's record
    to ``out``."""
    import datetime

    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SHARDED_PG_TIMEOUT_S))
    try:
        _sharded_rank(torch, dist, rank, world, backend, dev, out)
    finally:
        dist.destroy_process_group()


def _sharded_rank(torch, dist, rank, world, backend, dev, out):
    import repro_torch as rt
    from repro_torch import train
    from repro_torch.core import dist_mp
    from repro_torch.data.graphs import TABLE_II, dataset
    from repro_torch.kernels import ops as kops
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

    def say(msg):
        if rank == 0:
            print(f"  [3g] {msg}", flush=True)

    mesh = rt.make_shard_mesh(world, device=dev)
    rec = {"backend": backend, "world": world, "ranks_on_cards": (
        "one card a rank" if backend == "nccl" else
        "all ranks on one card; gloo moves CUDA tensors through the host")}
    g = dataset("ogbn-arxiv", feat=FEAT, seed=SEED)
    v, e = g.num_nodes, g.num_edges
    t0 = time.perf_counter()
    pg = g.partition(world, device=dev)
    t1 = time.perf_counter()
    pplan = pg.make_plan(feat=HIDDEN)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rec["partition"] = {
        "graph": f"ogbn-arxiv size (V={v}, E={e}, seed {SEED})",
        "cut_fraction": pg.halo.cut_fraction,
        "cut_edges": list(pg.halo.cut_edges),
        "halo_nodes": list(pg.halo.halo_nodes),
        "node_ptr": list(pg.node_ptr), "edges_per_shard": pg.edges_per_shard,
        "nodes_per_shard": pg.nodes_per_shard,
        "partition_ms": (t1 - t0) * 1e3, "plan_ms": (t2 - t1) * 1e3,
        "config": f"m_b={pplan.config.m_b} s_b={pplan.config.s_b}"}
    say(f"backend {backend}, {world} ranks ({rec['ranks_on_cards']}); "
        f"partition {rec['partition']}")

    # -- the sharded ops at F = 64 against the unsharded kernels -----------
    gen = torch.Generator(device=dev).manual_seed(SEED)   # the same a rank
    ei = torch.from_numpy(g.edge_index).to(dev)
    plan1 = g.make_plan(HIDDEN, device=dev)
    x = torch.randn(v, HIDDEN, generator=gen, device=dev)
    w = torch.rand(e, generator=gen, device=dev)
    ct = torch.randn(v, HIDDEN, generator=gen, device=dev)
    errs = {}
    for reduce in ("sum", "mean", "max"):
        for weighted in (False, True):
            what = f"mp_sharded {reduce}{' weighted' if weighted else ''}"
            outs = []
            for sharded in (True, False):
                xs = x.clone().requires_grad_()
                ws = w.clone().requires_grad_() if weighted else None
                y = (rt.mp_sharded(xs, pg, reduce=reduce, edge_weight=ws,
                                   pplan=pplan, mesh=mesh) if sharded else
                     rt.mp(xs, ei, v, reduce=reduce, edge_weight=ws,
                           plan=plan1))
                grads = torch.autograd.grad(
                    (y * ct).sum(), [xs] + ([ws] if weighted else []))
                outs.append((y.detach(),) + grads)
            errs[what] = max(
                compare(torch, f"rank {rank} {what}{part}", a, b,
                        torch.float32)
                for part, a, b in zip(("", " dx", " dw"), outs[0], outs[1]))
    logits = torch.randn(e, 4, generator=gen, device=dev)
    block = rt.segment_softmax_sharded(logits, pg, pplan=pplan, mesh=mesh)
    want = pg.shard_edges(rt.segment_softmax(logits, ei[1], v, plan=plan1),
                          rank)
    errs["segment_softmax_sharded (E, 4)"] = compare(
        torch, f"rank {rank} softmax (E, 4)", block, want, torch.float32)
    if bool(block[~pg.edge_valid[rank]].any()):
        fail(f"rank {rank}: the sharded softmax is not 0 on padding")
    torch.cuda.synchronize()
    rec["ops_max_abs_err"] = errs
    say(f"sharded ops at F={HIDDEN} (every reduce, plain and weighted, "
        f"values and gradients) and the (E, 4) softmax within the fp32 "
        f"tolerance of the unsharded kernels: {errs}")
    del x, w, ct, logits, block, want

    # -- the main path: served and trained across the ranks ----------------
    names = port_kernel_names()
    models = {fam: gnn.init(fam, FEAT, HIDDEN, CLASSES,
                            heads=4 if fam == "gat" else 1, seed=SEED,
                            device=dev)
              for fam in gnn.MODELS}
    name, tv, te = next(row for row in TABLE_II if row[0] == "ogbn-arxiv")
    data = train.GraphEpochProvider(shapes=((tv, te),), graphs_per_shape=1,
                                    feat=FEAT, num_classes=CLASSES,
                                    seed=SEED, name=name)
    cfg = train.TrainerConfig(steps=SHARDED_STEPS, warmup_steps=2,
                              opt=adamw.AdamWConfig(lr=1e-2))

    def task(fam, impl=None):
        return train.NodeClassification(
            model=fam, impl=impl, d_in=FEAT, hidden=HIDDEN,
            num_classes=CLASSES, heads=4 if fam == "gat" else 1,
            device=dev)

    served, served_logits, fits = [], {}, {}
    torch.cuda.synchronize()
    dist.barrier()
    kops.reset_launch_counts()
    with kops.fusion_scope() as fusion:
        for fam, model in models.items():
            srv = rt.GNNServer(model, fam, device=dev, shards=world,
                               mesh=mesh, max_batch_nodes=1 << 22)
            for turn in ("cold", "warm", "profiled"):
                srv.submit(g)
                b0 = dist_mp.collective_bytes
                if turn == "profiled" and rank == 0:
                    box = []
                    wall, kern, coll = profiled_split(
                        torch, lambda: box.extend(srv.step(flush=True)),
                        names)
                    (res,) = box
                else:
                    (res,) = srv.step(flush=True)
                    wall = kern = coll = None
                row = {"family": fam, "turn": turn,
                       "serve_ms": res.serve_s * 1e3,
                       "stages_ms": {k: s * 1e3
                                     for k, s in res.stages.items()},
                       "collective_bytes": dist_mp.collective_bytes - b0,
                       "collective_bytes_per_layer":
                           (dist_mp.collective_bytes - b0) / len(model.layers)}
                if turn == "profiled":
                    row.update(wall_ms=wall, kernels_device_ms=kern,
                               collectives_host_ms=coll)
                served.append(row)
                say(f"served {fam} ({turn}): {row}")
            served_logits[fam] = res.logits
            del srv
        for fam in ("gcn", "gat"):
            ends = []

            def mark(step, metrics, verdict):
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
            trainer = train.Trainer(task(fam), data, cfg, mesh=mesh)
            b0 = dist_mp.collective_bytes
            run = trainer.fit(metrics_cb=mark)
            step_bytes = (dist_mp.collective_bytes - b0) / SHARDED_STEPS
            step_ms = [(ends[k] - ends[k - 1]) * 1e3
                       for k in range(1, len(ends))]
            split = ((None,) * 3 if rank else profiled_split(
                torch, lambda: trainer.step(run.state, SHARDED_STEPS),
                names))
            if rank:
                trainer.step(run.state, SHARDED_STEPS)
            flat = torch.cat([p.detach().reshape(-1)
                              for p in run.state.params.values()])
            every = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(every, flat)
            if any(not torch.equal(f, flat) for f in every):
                fail(f"rank {rank}: {fam} parameters differ across ranks "
                     "after sharded training")
            fits[fam] = {"family": fam, "steps": SHARDED_STEPS,
                         "losses": run.losses,
                         "warm_step_ms": statistics.median(step_ms[1:]),
                         "step_ms": step_ms,
                         "collective_bytes_per_step": step_bytes,
                         "profiled_step_wall_ms": split[0],
                         "profiled_kernels_device_ms": split[1],
                         "profiled_collectives_host_ms": split[2]}
            say(f"fit(mesh=) {fam}: {fits[fam]}; parameters bitwise equal "
                f"on all {world} ranks")
    torch.cuda.synchronize()
    launched = kops.launch_counts()
    ops_seen = dict(fusion)
    for k in SHARDED_KERNELS:
        if launched[k] == 0:
            fail(f"rank {rank}: kernel {k} of the sharded path never "
                 f"launched: {launched}")
    if launched["fused_transform_reduce"]:
        fail(f"rank {rank}: the sharded path launched the fused kernel")
    plain = sorted(k for k in ops_seen if k.startswith("unfused:"))
    if plain:
        fail(f"rank {rank}: an op of the sharded path took a plain "
             f"version: {plain}")

    # -- the unsharded references (outside the counted window) -------------
    x0 = torch.from_numpy(g.x).to(dev)
    dis = torch.from_numpy(g.deg_inv_sqrt).to(dev)
    logit_err = {}
    for fam, model in models.items():
        with torch.inference_mode():
            want = model(x0, ei, v, dis, plan=plan1).float().cpu()
        logit_err[fam] = compare(
            torch, f"rank {rank} GNNServer(shards={world}) {fam}",
            torch.from_numpy(served_logits[fam]), want, torch.float32)
    say(f"GNNServer(shards={world}) logits within the fp32 tolerance of the "
        f"unsharded forward on the card: {logit_err}")
    for fam in ("gcn", "gat"):
        ref = train.Trainer(task(fam), data, cfg).fit()
        got = fits[fam]["losses"]
        for i, (a, b) in enumerate(zip(got, ref.losses)):
            if not abs(a - b) <= 1e-4 * abs(b):
                fail(f"rank {rank}: sharded {fam} step {i} loss {a!r} vs "
                     f"unsharded {b!r} (rtol 1e-4)")
        fits[fam]["unsharded_losses"] = ref.losses
        say(f"fit(mesh=) {fam} losses within rtol 1e-4 of the unsharded "
            f"fit: {got} vs {ref.losses}")

    # one merge's all-reduce alone: (V, HIDDEN) fp32, median of 5
    buf = torch.randn(v, HIDDEN, device=dev)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec.update(
        all_reduce_ms={"shape": [v, HIDDEN], "bytes": buf.numel() * 4,
                       "median_ms": statistics.median(times[1:])},
        served=served, fits=list(fits.values()), logits_max_abs_err=logit_err,
        launches=launched, ops=ops_seen)
    everyone = [None] * world
    dist.all_gather_object(everyone, {"launches": launched})
    if rank == 0:
        rec["launches_by_rank"] = [r["launches"] for r in everyone]
        Path(out).write_text(json.dumps(rec))


def sharded_phase(torch) -> dict:
    """Phase 3g: spawn SHARDS ranks (see spawn_ranks); returns rank 0's
    record."""
    return spawn_ranks(torch, sharded_rank, SHARDED_DEADLINE_S, "sharded")


# phase 3h: LM serving. qwen3-moe-30b-a3b at full width (d_model 2048, 128
# experts of d_ff 768, top-8, vocab 151,936) in bf16, depth cut from 48 to
# LM_LAYERS layers (about 11.2 GB of seeded weights on the card)
LM_ARCH, LM_LAYERS = "qwen3-moe-30b-a3b", 8
LM_MOE_TOKENS = (8, 4096)              # one MoE layer alone: decode, prefill
LM_FWD_BATCH, LM_FWD_SEQ = 2, 2048
LM_PROMPTS, LM_PROMPT_LEN, LM_GEN = 8, 128, 32
LM_REQUESTS, LM_SLOTS, LM_NEW, LM_MIN_PROMPT, LM_MAX_PROMPT = 12, 4, 16, 16, 96
LM_SEEDS = (SEED, SEED + 1)            # the forward's weights and tokens
# the port's kernels a MoE layer launches on moe_impl="cuda", and the
# sources of their CUDA kernels: a profile reads every __global__ in them
# (each path's)
LM_MOE_KERNELS = {"segment_matmul": 3, "gather_segment_reduce": 1}
LM_KERNEL_SOURCES = ("segment_matmul.cu", "gather_segment_reduce.cu",
                     "row_runs.cuh")
# segment_matmul's launches by path (kops.path_launch_counts) of one MoE
# layer: its three products on the wgmma path
LM_MOE_PATHS = {"wgmma": 3, "mma_sync": 0}
# the path of the combine on the gather kernel at LM_MOE_TOKENS: 64 rows at
# decode (the owner path), 32,768 at prefill (the runs path)
LM_COMBINE_PATHS = {8: "owner", 4096: "runs"}


@contextlib.contextmanager
def moe_held(torch, moe_mod, impl, what, rows):
    """While open, every MoE layer the model runs also runs on ``impl``
    from the same input, so both see the same routing, and is held to it
    at the bf16 tolerance; the model goes on with its own output. Each
    layer appends (max abs err, max abs of the model's output) to
    ``rows``."""
    plain = moe_mod.moe

    def held(prm, x, cfg, **kw):
        want = plain(prm, x, cfg, **kw)
        got, _ = plain(prm, x, cfg, impl=impl)
        err = compare(torch, f"{what}: MoE layer call {len(rows)}, {impl} "
                      "on the same input", got, want[0], torch.bfloat16)
        rows.append((err, float(want[0].float().abs().max())))
        return want
    moe_mod.moe = held
    try:
        yield
    finally:
        moe_mod.moe = plain


def held_reading(what, rows, expected):
    """Fails unless ``expected`` MoE layers were held; the worst error as
    a share of the layer's largest output."""
    if len(rows) != expected:
        fail(f"{what}: {len(rows)} MoE layers held, expected {expected}")
    return max(err / max(scale, 1e-30) for err, scale in rows)


def margin(rel: float) -> str:
    """How far a held error share lies inside the bf16 tolerance."""
    return f"{2e-2 / rel:.1f}x margin" if rel else "bitwise equal"


def e2e_reading(torch, what, got, want):
    """End to end, where the two paths may route a token to other experts:
    shape and finiteness are checked; the max abs error, the number of
    rows whose argmax differs and the number of rows are readings."""
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite logits")
    err = float((got - want).abs().max())
    flips = int((got.argmax(-1) != want.argmax(-1)).sum())
    return err, flips, got.numel() // got.shape[-1]


@contextlib.contextmanager
def lm_spans(torch, layers_mod, moe_mod):
    """Name each decode attention and MoE layer as a profiler range
    (``record_function``) while the block is open."""
    saved = layers_mod.attention_decode, moe_mod.moe

    def named(fn, name):
        def run(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    layers_mod.attention_decode = named(saved[0], "lm.attention")
    moe_mod.moe = named(saved[1], "lm.moe")
    try:
        yield
    finally:
        layers_mod.attention_decode, moe_mod.moe = saved


def profiled_lm_step(torch, fn, layers_mod, moe_mod) -> dict:
    """One call of ``fn`` (a decode step) under ``torch.profiler``: wall
    ms, device-busy ms, idle share, and the device ms of the MoE kernels
    (segment_matmul's and the gather's), of the MoE layers as a whole and
    of the attention layers (the kernels launched inside their ranges), the
    rest of the busy time apart; fails where a range has no device time."""
    from torch.autograd import DeviceType
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with lm_spans(torch, layers_mod, moe_mod), \
            torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_ms(evt, attr):
        us = getattr(evt, attr, None)
        return (us if us is not None
                else getattr(evt, attr.replace("device", "cuda"))) / 1e3
    busy = moe_k = 0.0
    names = port_kernel_names(*LM_KERNEL_SOURCES)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or _annotation(evt) \
                or evt.key.startswith("lm."):
            continue
        ms = dev_ms(evt, "self_device_time_total")
        busy += ms
        if any(n in evt.key for n in names):
            moe_k += ms
    spans = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU and evt.name in ("lm.attention",
                                                             "lm.moe"):
            spans[evt.name] += dev_ms(evt, "device_time_total")
    if not busy or not spans["lm.moe"] or not spans["lm.attention"]:
        fail(f"profiled decode step: device busy {busy} ms, ranges "
             f"{dict(spans)} (the profiler lost the device time, or the "
             "model no longer calls layers.attention_decode and moe.moe "
             "through their modules)")
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall, "moe_kernels_ms": moe_k,
            "moe_layers_ms": spans["lm.moe"],
            "attention_ms": spans["lm.attention"],
            "rest_ms": busy - spans["lm.moe"] - spans["lm.attention"]}


def lm_phase(torch, dev, card) -> dict:
    """Phase 3h: serve qwen3-moe-30b-a3b at full width (LM_LAYERS of its
    48 layers, bf16, seeded weights on the card). (a) One MoE layer alone
    at decode and prefill token counts: moe_impl="cuda" against the fp32
    plain version, bitwise over two calls, 3 segment_matmul and 1 gather
    launches, each product and the combine timed beside its bound and its
    library call. (b) As launch/serve.py serves: the forward on
    LM_FWD_BATCH x LM_FWD_SEQ tokens on the kernels, for each of LM_SEEDS,
    each MoE layer held to the plain one on the plain path's input; then
    LM_PROMPTS SyntheticTokens prompts of LM_PROMPT_LEN prefilled into the
    caches and LM_GEN greedy decode steps on the kernels, each step's MoE
    layers held the same way on the plain path fed the same tokens;
    timings, a profiled step's split, peak memory. (c) ContinuousBatcher,
    capacity path (its combine on the gather kernel), LM_REQUESTS requests
    into LM_SLOTS slots, the first tick held the same way. Returns the
    phase's record."""
    import numpy as np
    from repro_torch import configs as lm_configs
    from repro_torch.data.tokens import SyntheticTokens, TokenDatasetConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import Params
    from repro_torch.serve.lm import ContinuousBatcher, Request

    full = lm_configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_LAYERS)
    print(f"  {LM_ARCH}: depth cut from {full.num_layers} to "
          f"{cfg.num_layers} layers, every width as published (d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV "
          f"heads of {cfg.head_dim}, {cfg.num_experts} experts of d_ff "
          f"{cfg.moe_d_ff}, top-{cfg.top_k}, vocab {cfg.vocab_size}), "
          f"{cfg.dtype}", flush=True)
    record = {"arch": LM_ARCH, "layers": cfg.num_layers,
              "published_layers": full.num_layers, "card": card}
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = lm.LM(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    record.update(init_s=time.perf_counter() - t0, weight_gb=n_bytes / 1e9)
    print(f"  weights: {n_bytes / 1e9:.2f} GB drawn on the card in "
          f"{record['init_s']:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    # -- (a) one MoE layer alone ---------------------------------------------
    prm = model.layers[0].ffn
    prm32 = Params(router=prm.router, w_up=prm.w_up.float(),
                   w_gate=prm.w_gate.float(), w_down=prm.w_down.float())
    act = layers_mod._ACTS[cfg.act]
    smm_shapes, gather_shapes = [], []
    for t in LM_MOE_TOKENS:
        x = torch.randn(1, t, cfg.d_model, generator=gen, device=dev,
                        dtype=bf16)
        with torch.no_grad():
            kops.reset_launch_counts()
            got, _ = moe_mod.moe(prm, x, cfg, impl="cuda")
            torch.cuda.synchronize()
            launched = {k: v for k, v in kops.launch_counts().items() if v}
            if launched != LM_MOE_KERNELS:
                fail(f"MoE layer T={t}: launched {launched}, expected "
                     f"{LM_MOE_KERNELS}")
            took_paths(kops, f"MoE layer T={t}", {
                "segment_matmul": LM_MOE_PATHS,
                "gather_segment_reduce": {
                    p: int(p == LM_COMBINE_PATHS[t])
                    for p in ("runs", "owner")}})
            want, _ = moe_mod.moe(prm32, x.float(), cfg, impl="ragged")
            plain16, _ = moe_mod.moe(prm, x, cfg, impl="ragged")
        err = compare(torch, f"MoE layer T={t} cuda vs fp32 plain", got,
                      want, bf16)
        err16 = compare(torch, f"MoE layer T={t} bf16 plain vs fp32 plain",
                        plain16, want, bf16)
        deterministic(torch, f"MoE layer T={t} moe_impl=cuda",
                      lambda: moe_mod.moe(prm, x, cfg, impl="cuda")[0])
        layer_ms = time_ms(torch, lambda: moe_mod.moe(prm, x, cfg,
                                                      impl="cuda"))
        plain_layer_ms = time_ms(torch, lambda: moe_mod.moe(
            prm, x, cfg, impl="ragged"), reps=5, warmup=1)
        print(f"  MoE layer T={t} ({t * cfg.top_k} assignments): "
              f"max_abs_err={err:.3g} (bf16 plain {err16:.3g}) layer_ms="
              f"{layer_ms:.4f} plain_ms={plain_layer_ms:.4f}", flush=True)
        # the dispatch as moe_ragged runs it, then each product alone
        x2d = x.reshape(t, cfg.d_model)
        top_e, top_p, _ = moe_mod._route(prm, x2d, cfg)
        e_flat, w_flat, tok_flat = moe_mod._assignments(top_e, top_p, t,
                                                        cfg.top_k)
        order = torch.argsort(e_flat, stable=True)
        sizes = torch.bincount(e_flat, minlength=cfg.num_experts).to(
            torch.int32)
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        active = int((sizes > 0).sum())
        a = t * cfg.top_k
        xs = x2d[tok_flat[order].long()]
        with torch.no_grad():
            hu = kops.segment_matmul(xs, sizes, prm.w_up, impl="cuda")
            hg = kops.segment_matmul(xs, sizes, prm.w_gate, impl="cuda")
            hd = (act(hg) * hu).contiguous()
            ys = kops.segment_matmul(hd, sizes, prm.w_down, impl="cuda")
        for name, xin, w in (("up", xs, prm.w_up), ("gate", xs, prm.w_gate),
                             ("down", hd, prm.w_down)):
            k_dim, n_dim = int(w.shape[1]), int(w.shape[2])
            plain = (lambda xin=xin, w=w: kops.segment_matmul(
                xin, sizes, w, impl="ref"))
            row = smm_row(torch, kops, f"segment_matmul MoE {name} T={t}",
                          xin, sizes, w)
            err_p, k_ms = row["max_abs_err"], row["ms"]
            p_ms = time_ms(torch, plain, reps=5, warmup=1)
            print(f"  segment_matmul MoE {name} {k_dim}->{n_dim} T={t}: {a} "
                  f"rows in {active} of {cfg.num_experts} experts, bf16:",
                  flush=True)
            bnd = bound(a * (k_dim + n_dim) * 2 + active * k_dim * n_dim * 2
                        + (cfg.num_experts + 1) * 4, 2 * a * k_dim * n_dim,
                        BF16_FLOPS, "bf16 tensor cores")
            lib, reason = library(
                f"torch._grouped_mm MoE {name} T={t}",
                lambda xin=xin, w=w: torch._grouped_mm(xin, w, offs=offs))
            lib_ms = None
            if lib is not None:
                compare(torch, f"torch._grouped_mm yardstick MoE {name} "
                        f"T={t}", lib, kops.segment_matmul(
                            xin.float(), sizes, w.float(), impl="ref"), bf16)
                lib_ms = time_ms(torch, lambda xin=xin, w=w:
                                 torch._grouped_mm(xin, w, offs=offs))
            print(f"    max_abs_err={err_p:.3g} kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}) "
                  f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)}"
                  f" ({k_ms / bnd[0]:.1f}x its bound)", flush=True)
            smm_shapes.append({
                "product": name, "tokens": t, "rows": a, "k": k_dim,
                "n": n_dim, "experts_with_rows": active, "dtype": "bf16",
                "path": row["path"],
                "max_abs_err": err_p, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
                "library_note": "torch._grouped_mm with the group offsets"
                if lib_ms is not None else reason})
        # the combine: Y[token] = sum of its k rows of ys, router-weighted,
        # through the op (its metadata included) on the path the rule picks
        inv = moe_mod._inverse(order)
        comb = (lambda: kops.gather_segment_reduce(
            ys, inv, tok_flat, t, w_flat, "sum", impl="cuda"))
        c_path = took_one_path(torch, kops, "gather_segment_reduce", comb)
        if c_path != LM_COMBINE_PATHS[t]:
            fail(f"gather combine T={t}: took the {c_path} path, expected "
                 f"{LM_COMBINE_PATHS[t]}")
        want_c = kops.gather_segment_reduce(ys.float(), inv, tok_flat, t,
                                            w_flat.float(), "sum", impl="ref")
        err_c = compare(torch, f"gather combine T={t} ({c_path} path)",
                        comb(), want_c, bf16)
        deterministic(torch, f"gather combine T={t} ({c_path} path)", comb)
        c_ms = time_ms(torch, comb)
        runs_ms = None
        if c_path == "owner":
            # the runs path beside it, with the row offsets it builds
            runs = gsr_runs_call(torch, ys, inv, tok_flat, t,
                                 w_flat.to(ys.dtype))
            compare(torch, f"gather combine T={t} (runs path, C entry)",
                    runs(), want_c, bf16)
            runs_ms = time_ms(torch, runs)
        cp_ms = time_ms(torch, lambda: kops.gather_segment_reduce(
            ys, inv, tok_flat, t, w_flat, "sum", impl="ref"))
        print(f"  gather combine T={t}: {a} rows of F={cfg.d_model} into "
              f"{t} tokens, bf16, the {c_path} path:", flush=True)
        # the runs path also reads the row offsets it builds
        cb = bound(a * cfg.d_model * 2 + a * (4 + 4 + 2)
                   + (t + 1) * 8 * (c_path == "runs")
                   + t * cfg.d_model * 2, 2 * a * cfg.d_model)
        # yardstick: torch.sparse.mm of the (T, T·k) CSR of the weights
        row_ptr = torch.arange(0, a + 1, cfg.top_k, device=dev)
        csr, reason = library(
            f"torch.sparse.mm combine T={t}",
            lambda: torch.sparse_csr_tensor(row_ptr, inv.long(), w_flat,
                                            size=(t, a)))
        lib_c = None
        if csr is not None:
            out, reason = library(f"torch.sparse.mm combine T={t}",
                                  lambda: torch.sparse.mm(csr, ys))
            if out is not None:
                lib_c = time_ms(torch, lambda: torch.sparse.mm(csr, ys))
        print(f"    max_abs_err={err_c:.3g} kernel_ms={c_ms:.4f} "
              + ("" if runs_ms is None else
                 f"(runs path with its offsets {runs_ms:.4f}) ")
              + f"plain_ms={cp_ms:.4f} bound_ms={cb[0]:.4f} ({cb[1]}) "
              f"library_ms={lib_c if lib_c is None else round(lib_c, 4)}",
              flush=True)
        gather_shapes.append({
            "tokens": t, "rows": a, "feat": cfg.d_model, "dtype": "bf16",
            "path": c_path, "runs_path_ms": runs_ms,
            "max_abs_err": err_c, "ms": c_ms, "plain_ms": cp_ms,
            "bound_ms": cb[0], "bound_by": cb[1], "library_ms": lib_c,
            "library_note": "torch.sparse.mm of the (T, T*k) CSR of the "
            "router weights" if lib_c is not None else reason})
        record.setdefault("moe_layer", []).append({
            "tokens": t, "max_abs_err": err, "plain_bf16_max_abs_err": err16,
            "ms": layer_ms, "plain_ms": plain_layer_ms,
            "experts_with_rows": active})
        del x, got, want, plain16, xs, hu, hg, hd, ys
    del prm32
    torch.cuda.empty_cache()

    # -- (b) batched serving, as launch/serve.py does it ---------------------
    # The forward on each seed's weights and tokens, on the kernels end to
    # end: the two paths sum in other orders, so from the second layer on a
    # token may take another top-k set, and the logits' distance is a
    # reading. The check: the plain forward with each MoE layer also run on
    # the kernels from the same input, where the routing is the same.
    n_moe = sum(kind[1] == "moe" for kind in model.kinds)
    record["forward"] = []
    for seed in LM_SEEDS:
        m = model if seed == SEED else lm.LM(cfg, device=dev, seed=seed)
        toks = torch.from_numpy(SyntheticTokens(TokenDatasetConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_FWD_SEQ,
            global_batch=LM_FWD_BATCH, seed=seed)).batch(0)["tokens"]).to(dev)
        what = f"lm forward {LM_FWD_BATCH}x{LM_FWD_SEQ} seed {seed}"
        rows = []
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_k, _ = m(toks, moe_impl="cuda")
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            with moe_held(torch, moe_mod, "cuda", what, rows):
                logits_p, _ = m(toks, moe_impl="ragged")
        if logits_k.shape != (LM_FWD_BATCH, LM_FWD_SEQ, cfg.padded_vocab):
            fail(f"{what}: logits {tuple(logits_k.shape)}")
        held = held_reading(what, rows, n_moe)
        e2e, flips, n_rows = e2e_reading(torch, what, logits_k, logits_p)
        print(f"  forward {LM_FWD_BATCH}x{LM_FWD_SEQ} tokens, seed {seed}: "
              f"each MoE layer on the kernels within {held:.3g} of its "
              f"largest output of the plain one on the same input (the "
              f"tolerance 2e-2: {margin(held)}); end to end, "
              f"routing free to differ: logits max_abs_err={e2e:.3g} (up "
              f"to {float(logits_p.abs().max()):.3g}), argmax differs at "
              f"{flips} of {n_rows} positions; forward_ms={fwd_ms:.1f} "
              f"(host clock, first call)", flush=True)
        record["forward"].append({
            "seed": seed, "batch": LM_FWD_BATCH, "seq": LM_FWD_SEQ,
            "held_max_rel_err": held,
            "e2e_max_abs_err": e2e, "e2e_argmax_differs": flips,
            "positions": n_rows, "ms": fwd_ms})
        del m, logits_k, logits_p, toks
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    prompts = torch.from_numpy(SyntheticTokens(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_PROMPT_LEN,
        global_batch=LM_PROMPTS, seed=SEED)).batch(0)["tokens"]).to(dev)
    max_len = LM_PROMPT_LEN + LM_GEN + 1
    state = lm.init_decode_state(cfg, LM_PROMPTS, max_len, bf16, device=dev)
    fed, step_logits, step_ms = [], [], []
    kops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill_into_cache(model, prompts, state, "cuda")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_logits.append(logits)
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    for _ in range(LM_GEN):
        fed.append(tok)
        t1 = time.perf_counter()
        logits, state = lm.decode_step(model, tok, state, moe_impl="cuda")
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        step_logits.append(logits)
    launches_b = kops.launch_counts()
    # every step's combine gathers LM_PROMPTS x top-k rows: the owner path
    n_calls = cfg.num_layers * (LM_PROMPT_LEN + LM_GEN)
    paths_b = took_paths(kops, "lm serving", {
        "segment_matmul": {p: n * n_calls for p, n in LM_MOE_PATHS.items()},
        "gather_segment_reduce": {"runs": 0, "owner": n_calls}})
    expect = {k: n * cfg.num_layers * (LM_PROMPT_LEN + LM_GEN)
              for k, n in LM_MOE_KERNELS.items()}
    if {k: v for k, v in launches_b.items() if v} != expect:
        fail(f"lm serving launched {launches_b}, expected {expect}")
    decode_s = sum(step_ms) / 1e3
    # teacher-forced: the plain path fed the same tokens, each decode
    # step's MoE layers also run on the kernels from the same input
    state_p = lm.init_decode_state(cfg, LM_PROMPTS, max_len, bf16,
                                   device=dev)
    logits_p, state_p = prefill_into_cache(model, prompts, state_p,
                                           "ragged")
    e2e = [e2e_reading(torch, "lm prefill logits", step_logits[0],
                       logits_p)]
    rows = []
    with moe_held(torch, moe_mod, "cuda", "lm decode", rows):
        for i, tok_i in enumerate(fed):
            logits_p, state_p = lm.decode_step(model, tok_i, state_p,
                                               moe_impl="ragged")
            e2e.append(e2e_reading(torch, f"lm decode step {i}",
                                   step_logits[i + 1], logits_p))
    held_dec = held_reading("lm decode", rows, LM_GEN * n_moe)
    gen_tokens = torch.cat(fed, 1).cpu().numpy()
    split = profiled_lm_step(torch, lambda: lm.decode_step(
        model, tok, state, moe_impl="cuda"), layers_mod, moe_mod)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    serving = {
        "prompts": LM_PROMPTS, "prompt_len": LM_PROMPT_LEN, "gen": LM_GEN,
        "prefill_s": prefill_s,
        "prefill_tok_s": LM_PROMPTS * LM_PROMPT_LEN / prefill_s,
        "decode_tok_s": LM_PROMPTS * LM_GEN / decode_s,
        "decode_step_ms": statistics.median(step_ms),
        "held_max_rel_err": held_dec,
        "e2e_max_abs_err": max(r[0] for r in e2e),
        "e2e_argmax_differs": sum(r[1] for r in e2e),
        "positions": sum(r[2] for r in e2e), "peak_alloc_gib": peak_gb,
        "launches": {k: v for k, v in launches_b.items() if v},
        "profiled_step": split, "sample": gen_tokens[0, :12].tolist()}
    record["serving"] = serving
    print(f"  prefill {LM_PROMPTS}x{LM_PROMPT_LEN} tokens (token by token "
          f"through decode_step) in {prefill_s:.2f} s = "
          f"{serving['prefill_tok_s']:.1f} tok/s; {LM_GEN} greedy decode "
          f"steps: {serving['decode_tok_s']:.1f} tok/s, "
          f"{serving['decode_step_ms']:.2f} ms a step (median, host clock "
          f"after a synchronise); against the plain path fed the same "
          f"tokens, each decode step's MoE layers on the kernels within "
          f"{held_dec:.3g} of their largest output on the same input "
          f"({margin(held_dec)}), end to end logits max_abs_err="
          f"{serving['e2e_max_abs_err']:.3g}, argmax differs at "
          f"{serving['e2e_argmax_differs']} of {serving['positions']}; "
          f"peak_alloc_gib={peak_gb:.2f}; launches {serving['launches']}",
          flush=True)
    print("  profiled decode step: wall_ms={wall_ms:.2f} device_busy_ms="
          "{device_busy_ms:.2f} idle_share={idle_share:.3f}; MoE layers "
          "{moe_layers_ms:.2f} ms (of which segment_matmul + gather "
          "kernels {moe_kernels_ms:.2f}), attention {attention_ms:.2f}, "
          "rest {rest_ms:.2f}".format(**split), flush=True)
    del state, state_p, step_logits, logits, logits_p
    torch.cuda.empty_cache()

    # -- (c) continuous batching on the capacity path ------------------------
    rng = np.random.default_rng(SEED)
    lens = rng.integers(LM_MIN_PROMPT, LM_MAX_PROMPT + 1, LM_REQUESTS)
    pool = SyntheticTokens(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_MAX_PROMPT,
        global_batch=LM_REQUESTS, seed=SEED)).batch(1)["tokens"]
    batcher = ContinuousBatcher(model, LM_SLOTS,
                                LM_MAX_PROMPT + LM_NEW + 1, dtype=bf16)
    for uid, n in enumerate(lens):
        batcher.submit(Request(uid, pool[uid, :n], LM_NEW))
    kops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batcher.tick()
    first = batcher.last_logits
    ticks = 1
    while batcher.queue or any(not s.free for s in batcher.slots):
        batcher.tick()
        ticks += 1
    torch.cuda.synchronize()
    cb_s = time.perf_counter() - t0
    launches_c = kops.launch_counts()
    # each tick's combine gathers LM_SLOTS x top-k rows: the owner path
    paths_c = took_paths(kops, "batcher", {
        "segment_matmul": {"wgmma": 0, "mma_sync": 0},
        "gather_segment_reduce": {"runs": 0,
                                  "owner": ticks * cfg.num_layers}})
    if launches_c["gather_segment_reduce"] != ticks * cfg.num_layers:
        fail(f"batcher: {launches_c['gather_segment_reduce']} gather "
             f"launches over {ticks} ticks of {cfg.num_layers} MoE layers")
    done = batcher.finished
    if sorted(done) != list(range(LM_REQUESTS)) or \
            any(len(v) != LM_NEW for v in done.values()):
        fail(f"batcher: finished {{uid: tokens}} = "
             f"{ {k: len(v) for k, v in done.items()} }")
    # the first tick against the plain versions (the first LM_SLOTS
    # prompts' first tokens at position 0), each MoE layer also run on the
    # batcher's capacity path from the same input
    state_p = lm.init_decode_state(cfg, LM_SLOTS, batcher.max_len, bf16,
                                   device=dev)
    rows = []
    with moe_held(torch, moe_mod, "capacity", "batcher first tick", rows):
        first_p, _ = lm.decode_step(
            model, torch.from_numpy(pool[:LM_SLOTS, :1]).to(dev), state_p,
            moe_impl="ragged",
            lengths=torch.zeros(LM_SLOTS, dtype=torch.int32, device=dev))
    first_held = held_reading("batcher first tick", rows, n_moe)
    first_err, first_flips, _ = e2e_reading(torch, "batcher first tick",
                                            first, first_p)
    fed_tokens = int(lens.sum()) + LM_REQUESTS * (LM_NEW - 1)
    record["batcher"] = {
        "requests": LM_REQUESTS, "slots": LM_SLOTS, "new_tokens": LM_NEW,
        "prompt_lens": lens.tolist(), "ticks": ticks, "seconds": cb_s,
        "generated_tok_s": LM_REQUESTS * LM_NEW / cb_s,
        "fed_tok_s": fed_tokens / cb_s, "first_tick_held_max_rel_err":
        first_held, "first_tick_e2e_max_abs_err": first_err,
        "first_tick_e2e_argmax_differs": first_flips,
        "launches": {k: v for k, v in launches_c.items() if v}}
    print(f"  ContinuousBatcher: {LM_REQUESTS} requests (prompts "
          f"{int(lens.min())}-{int(lens.max())} tokens) x {LM_NEW} new "
          f"tokens in {LM_SLOTS} slots: {ticks} ticks in {cb_s:.2f} s, "
          f"{record['batcher']['generated_tok_s']:.1f} generated tok/s "
          f"({record['batcher']['fed_tok_s']:.1f} tokens fed a second); "
          f"first tick: each MoE layer on the capacity path within "
          f"{first_held:.3g} of its largest output of the plain one on the "
          f"same input ({margin(first_held)}), end to end "
          f"max_abs_err={first_err:.3g}, argmax differs at {first_flips} of "
          f"{LM_SLOTS}; launches "
          f"{record['batcher']['launches']}", flush=True)
    record["launches"] = {k: launches_b[k] + launches_c[k]
                          for k in launches_b}
    record["kernel_paths"] = {
        k: {p: n + paths_c[k][p] for p, n in by.items()}
        for k, by in paths_b.items()}
    record["segment_matmul_moe"] = smm_shapes
    record["gather_moe"] = gather_shapes
    del model, batcher
    torch.cuda.empty_cache()
    return record


# phase 3i: LM training. qwen3-moe-30b-a3b at full width, depth cut from 48
# to LM_TRAIN_LAYERS layers (3.11 B parameters), bf16 weights and
# gradients, fp32 AdamW moments, LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens a step
LM_TRAIN_LAYERS = 4
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 2, 1024
LM_TRAIN_STEPS = 4                     # one cold step, then warm ones
LM_REPLAY_STEPS = 2
LM_RESUME_STEPS, LM_RESUME_EVERY = 6, 3
# the port's kernels a training step of moe_impl="cuda" launches
LM_TRAIN_KERNELS = ("segment_matmul", "gather_segment_reduce", "sddmm",
                    "segment_reduce")
# one MoE layer's forward and backward on moe_impl="cuda": 3 expert
# products and their 3 dX; the combine, its dH and the dispatch's dH; the
# combine's router-weight gradient
LM_MOE_TRAIN_LAUNCHES = {"segment_matmul": 6, "gather_segment_reduce": 3,
                         "sddmm": 1}
STATE_BYTES_PER_PARAM = 12             # bf16 weight + bf16 grad + 2 fp32


def digest(torch, tensors) -> list:
    """One integer a tensor from its bits (position-weighted sums of its
    16- or 32-bit words, in chunks): two states compare without both
    sitting on the card."""
    out = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        word = torch.int16 if flat.element_size() == 2 else torch.int32
        bits = flat.view(word)
        total, chunk = 0, 1 << 24
        for lo in range(0, bits.numel(), chunk):
            b = bits[lo:lo + chunk].to(torch.int64)
            pos = torch.arange(lo, lo + b.numel(), device=b.device) \
                % 65521 + 1
            total += int((b * pos).sum()) + int(b.sum()) * 7
        out.append(total)
    return out


def piece(torch, name, fn, bnd, lib_fn=None, lib_name=None, plain_fn=None,
          err=None, extra=None) -> dict:
    """One timed piece of the training step beside its bound and, where
    one exists, the library call's time."""
    ms = time_ms(torch, fn, reps=10, warmup=2)
    plain_ms = (time_ms(torch, plain_fn, reps=3, warmup=1)
                if plain_fn is not None else None)
    lib_ms, note = None, lib_name
    if lib_fn is not None:
        out, reason = library(name, lib_fn)
        if out is not None:
            lib_ms = time_ms(torch, lib_fn, reps=10, warmup=2)
        else:
            note = reason
    rec = {"piece": name, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
           "library_note": note, "max_abs_err": err}
    rec.update(extra or {})
    print(f"    {name}: ms={ms:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}, "
          f"{ms / bnd[0]:.1f}x) plain_ms="
          f"{plain_ms if plain_ms is None else round(plain_ms, 4)} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)}"
          f"{'' if err is None else f' max_abs_err={err:.3g}'}", flush=True)
    return rec


@contextlib.contextmanager
def train_spans(torch, task, trainer_mod, marks):
    """While open, the forward (the task's loss), the backward
    (``torch.autograd.grad``) and AdamW (``adamw.update_``) each run in a
    profiler range and between two CUDA events, appended to ``marks`` as
    (name, start, end)."""
    saved = task.loss, torch.autograd.grad, trainer_mod.adamw.update_

    def named(fn, name):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(name):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            marks.append((name, start, end))
            return out
        return run
    task.loss = named(saved[0], "lm.forward")
    torch.autograd.grad = named(saved[1], "lm.backward")
    trainer_mod.adamw.update_ = named(saved[2], "lm.adamw")
    try:
        yield
    finally:
        del task.loss
        torch.autograd.grad = saved[1]
        trainer_mod.adamw.update_ = saved[2]


def profiled_train_step(torch, fn, task, trainer_mod) -> dict:
    """One training step under ``torch.profiler``: wall ms, device-busy ms
    (the union of the device events' intervals), idle share, and the
    device span of the forward, the backward and AdamW, read from CUDA
    events recorded on the stream at each range's ends (the device time
    from the range's first queued work to its last, idle gaps inside it
    included); fails where a range is missing or has no device time. The
    profiler's own per-range device sums are not used: the backward's
    kernels are launched from the autograd engine's thread, outside the
    host range, and are not attributed to it."""
    from torch.autograd import DeviceType
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    marks = []
    torch.cuda.synchronize()
    with train_spans(torch, task, trainer_mod, marks), \
            torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not _annotation(e))
    busy, reach = 0.0, -math.inf
    for lo, hi in spans:
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    busy /= 1e3
    split = {name: start.elapsed_time(end) for name, start, end in marks}
    if sorted(split) != ["lm.adamw", "lm.backward", "lm.forward"] or \
            not busy or not all(v > 0 for v in split.values()):
        fail(f"profiled training step: device busy {busy} ms, ranges "
             f"{split} (a range is missing: the trainer no longer calls "
             "task.loss, torch.autograd.grad and adamw.update_ once each, "
             "or the profiler lost the device events)")
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "forward_ms": split["lm.forward"],
            "backward_ms": split["lm.backward"],
            "adamw_ms": split["lm.adamw"],
            "rest_ms": wall - sum(split.values())}


def lm_train_phase(torch, dev, card) -> dict:
    """Phase 3i: train qwen3-moe-30b-a3b at full width (LM_TRAIN_LAYERS of
    its 48 layers; bf16 weights and gradients, fp32 AdamW moments) on
    LM_TRAIN_BATCH x LM_TRAIN_SEQ TokenProvider tokens with
    LMTask(moe_impl="cuda") through repro_torch.train.fit. (a) One MoE
    layer's forward and backward at the step's 2048 tokens, routing held
    fixed: the kernels against the fp32 plain path, and each piece of the
    backward timed. (b) The embedding's backward at full vocab:
    segment_reduce against index_add_. (c) LM_TRAIN_STEPS steps: finite
    losses, step 0 beside a "ragged" forward on the same weights, every
    kernel launched, the warm step and its profiled split, idle share,
    peak memory. (d) Two runs of LM_REPLAY_STEPS steps: bitwise-equal
    parameters. (e) Kill and resume at reduced_100m on the card: bitwise
    the uninterrupted run. Returns the phase's record."""
    import gc
    import types

    from repro_torch import configs as lm_configs
    from repro_torch import train
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import ops as geot
    from repro_torch.core.plan import source_order
    from repro_torch.data.tokens import TokenDatasetConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import reduced_100m
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_mod

    full = lm_configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_TRAIN_LAYERS)
    n_params = sum(p.numel() for p in
                   lm.LM(cfg, device="meta", seed=None).parameters())
    reckoned_gb = n_params * STATE_BYTES_PER_PARAM / 1e9
    print(f"  {LM_ARCH}: depth cut from {full.num_layers} to "
          f"{cfg.num_layers} layers, every width as published; "
          f"{n_params / 1e9:.3f} B parameters, {reckoned_gb:.1f} GB of "
          f"weights, gradients and fp32 AdamW moments; "
          f"{LM_TRAIN_BATCH}x{LM_TRAIN_SEQ} tokens a step", flush=True)
    record = {"arch": LM_ARCH, "layers": cfg.num_layers,
              "published_layers": full.num_layers, "params": n_params,
              "reckoned_state_gb": reckoned_gb, "card": card,
              "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ}
    bf16 = torch.bfloat16
    t, k, d = LM_TRAIN_BATCH * LM_TRAIN_SEQ, cfg.top_k, cfg.d_model
    a = t * k
    e_n = cfg.num_experts
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.empty_cache()

    # -- (a) one MoE layer, forward and backward, routing held fixed -------
    prm = moe_mod.moe_init(gen, cfg, bf16, dev)
    names = ("router", "w_up", "w_gate", "w_down")
    x = torch.randn(1, t, d, generator=gen, device=dev, dtype=bf16)
    gy = torch.randn(1, t, d, generator=gen, device=dev, dtype=bf16)
    aux_w = 0.01
    res = {}
    for impl, up in (("cuda", lambda v: v), ("ragged", lambda v: v.float())):
        leaves = [up(getattr(prm, n)).detach().clone().requires_grad_()
                  for n in names]
        xl = up(x).detach().clone().requires_grad_()
        kops.reset_launch_counts()
        y, aux = moe_mod.moe(types.SimpleNamespace(**dict(zip(names,
                                                              leaves))),
                             xl, cfg, impl=impl)
        grads = torch.autograd.grad(
            (y, aux), [xl] + leaves,
            (up(gy), torch.tensor(aux_w, device=dev)))
        torch.cuda.synchronize()
        launched = {kk: v for kk, v in kops.launch_counts().items() if v}
        want = LM_MOE_TRAIN_LAUNCHES if impl == "cuda" else {}
        if launched != want:
            fail(f"MoE layer forward + backward, {impl}: launched "
                 f"{launched}, expected {want}")
        # the forward's three products and their dX, W read in place; the
        # router-weight gradient's rows of F = 2048 on sddmm's wide path
        took_paths(kops, f"MoE layer forward + backward, {impl}", {
            "segment_matmul": {p: 2 * n if impl == "cuda" else 0
                               for p, n in LM_MOE_PATHS.items()},
            "sddmm": {"runs": 0, "wide": int(impl == "cuda")}})
        res[impl] = (y.detach(),) + tuple(grads)
        del leaves, xl, y, aux, grads
    errs = {}
    for what, got, want in zip(("output", "dx") + names, res["cuda"],
                               res["ragged"]):
        errs[what] = compare(torch, f"MoE layer T={t} {what}: cuda vs fp32 "
                             "plain, routing held", got, want, bf16)
        errs[what] /= max(float(want.float().abs().max()), 1e-30)
    print(f"  MoE layer forward + backward at {t} tokens ({a} assignments): "
          f"the kernels within the bf16 tolerance of the fp32 plain path "
          f"(max error / max |plain|: "
          + ", ".join(f"{kk} {v:.3g}" for kk, v in errs.items())
          + f"); launches {LM_MOE_TRAIN_LAUNCHES}", flush=True)
    record["moe_layer"] = {"tokens": t, "assignments": a,
                           "max_rel_err": errs,
                           "launches": LM_MOE_TRAIN_LAUNCHES}
    del res
    torch.cuda.empty_cache()

    # the backward's pieces, at this layer's routing
    print(f"  the MoE backward's pieces at {t} tokens, bf16 ({card}):",
          flush=True)
    act = layers_mod._ACTS[cfg.act]
    with torch.no_grad():
        x2d = x.reshape(t, d)
        top_e, top_p, _ = moe_mod._route(prm, x2d, cfg)
        e_flat, w_flat, tok_flat = moe_mod._assignments(top_e, top_p, t, k)
        order = torch.argsort(e_flat, stable=True)
        tok_sorted = tok_flat[order]
        sizes = torch.bincount(e_flat, minlength=e_n).to(torch.int32)
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        active = int((sizes > 0).sum())
        xs = x2d.index_select(0, tok_sorted.long())
        hu = kops.segment_matmul(xs, sizes, prm.w_up, impl="cuda")
        hg = kops.segment_matmul(xs, sizes, prm.w_gate, impl="cuda")
        h = (act(hg) * hu).contiguous()
        ys = kops.segment_matmul(h, sizes, prm.w_down, impl="cuda")
        g_h = torch.randn(a, cfg.moe_d_ff, generator=gen, device=dev,
                          dtype=bf16)
        g_ys = torch.randn(a, d, generator=gen, device=dev, dtype=bf16)
        g_t = gy.reshape(t, d).float()
    pieces = []
    plan_bytes = (e_n + 1) * 4
    wts = {"up": prm.w_up, "gate": prm.w_gate, "down": prm.w_down}
    for name, g in (("up", g_h), ("gate", g_h), ("down", g_ys)):
        w = wts[name]
        xin = h if name == "down" else xs
        kd, nd = int(w.shape[1]), int(w.shape[2])
        row = smm_row(torch, kops, f"segment_matmul forward {name}", xin,
                      sizes, w)
        err = row["max_abs_err"]
        pieces.append(piece(
            torch, f"forward {name} {kd}->{nd} (segment_matmul)",
            lambda xin=xin, w=w: kops.segment_matmul(xin, sizes, w,
                                                     impl="cuda"),
            bound(a * (kd + nd) * 2 + active * kd * nd * 2 + plan_bytes,
                  2 * a * kd * nd, BF16_FLOPS, "bf16 tensor cores"),
            lambda xin=xin, w=w: torch._grouped_mm(xin, w, offs=offs),
            "torch._grouped_mm with the group offsets",
            lambda xin=xin, w=w: kops.segment_matmul(xin, sizes, w,
                                                     impl="ref"),
            err, {"kernel": "segment_matmul", "role": "forward", "rows": a,
                  "k": kd, "n": nd, "experts_with_rows": active,
                  "path": row["path"]}))
        # dX = dY @ W[g]^T with W read in place (no transposed copy)
        kd, nd = int(w.shape[2]), int(w.shape[1])
        row = smm_row(torch, kops, f"segment_matmul dX {name}", g, sizes, w,
                      w_transposed=True)
        err = row["max_abs_err"]
        pieces.append(piece(
            torch, f"dX {name} {kd}->{nd} (segment_matmul, W^T read in place)",
            lambda g=g, w=w: kops.segment_matmul(g, sizes, w, impl="cuda",
                                                 w_transposed=True),
            bound(a * (kd + nd) * 2 + active * kd * nd * 2 + plan_bytes,
                  2 * a * kd * nd, BF16_FLOPS, "bf16 tensor cores"),
            lambda g=g, w=w: torch._grouped_mm(g, w.transpose(1, 2),
                                               offs=offs),
            "torch._grouped_mm with the group offsets, W^T a strided view",
            lambda g=g, w=w: kops.segment_matmul(g, sizes, w, impl="ref",
                                                 w_transposed=True),
            err, {"kernel": "segment_matmul", "role": "dX", "rows": a,
                  "k": kd, "n": nd, "experts_with_rows": active,
                  "path": row["path"]}))
        gout = g_ys if name == "down" else g_h
        kd, nd = int(w.shape[1]), int(w.shape[2])
        pieces.append(piece(
            torch, f"dW {name} {kd}x{nd} (torch.matmul over {e_n} groups, "
            "1 host sync)",
            lambda xin=xin, gout=gout, w=w: geot._grouped_dw(
                xin, gout, sizes, None, w.shape, w.dtype),
            bound(a * (kd + nd) * 2 + e_n * kd * nd * 2,
                  2 * a * kd * nd, BF16_FLOPS, "bf16 tensor cores"),
            lambda xin=xin, gout=gout: torch._grouped_mm(
                xin.t(), gout, offs=offs),
            "torch._grouped_mm of X^T and dY with the group offsets",
            extra={"role": "dW", "host_syncs": 1}))
    # the combine's backward: dH on the gather kernel, dw on sddmm
    inv = moe_mod._inverse(order)
    c_order = source_order(inv, tok_flat, t, a)
    wt = w_flat.float().index_select(0, c_order.perm)
    dh_k = kops.transposed_gather(g_t, c_order.dst, c_order.src,
                                  c_order.row_ptr, a, wt, impl="cuda")
    err = compare(torch, "combine dH", dh_k, kops.transposed_gather(
        g_t, c_order.dst, c_order.src, c_order.row_ptr, a, wt, impl="ref"),
        torch.float32)
    csr_t = torch.sparse_csr_tensor(
        torch.arange(a + 1, device=dev), tok_flat[order].long(),
        w_flat[order].float(), size=(a, t))
    pieces.append(piece(
        torch, f"combine dH ({a} rows of F={d}, gather kernel)",
        lambda: kops.transposed_gather(g_t, c_order.dst, c_order.src,
                                       c_order.row_ptr, a, wt, impl="cuda"),
        bound(t * d * 4 + a * (4 + 4 + 4) + (a + 1) * 8 + a * d * 4,
              2 * a * d),
        lambda: torch.sparse.mm(csr_t, g_t),
        "torch.sparse.mm of the (T·k, T) CSR of the router weights",
        lambda: kops.transposed_gather(g_t, c_order.dst, c_order.src,
                                       c_order.row_ptr, a, wt, impl="ref"),
        err, {"kernel": "gather_segment_reduce", "role": "combine dH"}))
    # the router-weight gradient on sddmm's wide path: B (the expert
    # outputs) read in fp32, as an fp32 copy of it, and in bf16, as the
    # backward passes it; beside the fp32 one, the runs kernel through its
    # C entry (the path rows of this width took before the wide path)
    ys32 = ys.float()
    pattern = torch.sparse_csr_tensor(
        torch.arange(0, a + 1, k, device=dev), inv.long(),
        torch.zeros(a, device=dev), size=(t, a))
    old = sddmm_runs_call(torch, g_t, ys32, tok_flat, inv)
    for b_in, lib_fn in ((ys32, lambda: torch.sparse.sampled_addmm(
            pattern, g_t, ys32.T)), (ys, None)):
        def dw(b_in=b_in):
            return kops.sddmm_rows(g_t, b_in, tok_flat, inv, impl="cuda")
        b_name = str(b_in.dtype)[6:]
        what = f"combine dw, B {b_name} (sddmm)"
        w_path = took_one_path(torch, kops, "sddmm", dw)
        if w_path != "wide":
            fail(f"{what}: took the {w_path} path, expected the wide path")
        want_dw = kops.sddmm_rows(g_t, b_in, tok_flat, inv, impl="ref")
        err = compare(torch, what, dw(), want_dw, torch.float32)
        deterministic(torch, what, dw)
        if b_in is ys32:
            compare(torch, f"{what}: the runs kernel (C entry)", old(),
                    want_dw, torch.float32)
        pieces.append(piece(
            torch, f"combine dw ({a} dots of F={d}, B {b_name}, sddmm "
            "wide path)", dw,
            bound(t * d * 4 + a * d * b_in.element_size() + a * 8 + a * 4,
                  2 * a * d),
            lib_fn, "torch.sparse.sampled_addmm on the (T, T·k) CSR pattern"
            if lib_fn is not None else "no PyTorch call takes an fp32 A "
            "with a bf16 B: the fp32 row's library_ms",
            lambda b_in=b_in: kops.sddmm_rows(g_t, b_in, tok_flat, inv,
                                              impl="ref"), err,
            {"kernel": "sddmm", "role": "combine dw", "b_dtype": b_name,
             "path": w_path,
             "runs_kernel_ms": time_ms(torch, old, reps=10, warmup=2)
             if b_in is ys32 else None}))
    del ys32, dh_k, old

    # the dispatch gather's dH: its sort and the gather kernel
    def dispatch_dh(impl):
        o = source_order(tok_sorted, None, 0, t)
        return kops.transposed_gather(g_ys, o.perm, o.src, o.row_ptr, t,
                                      impl=impl)
    err = compare(torch, "dispatch dH", dispatch_dh("cuda"), torch.zeros(
        t, d, device=dev).index_add_(0, tok_sorted.long(), g_ys.float()),
        bf16)
    pieces.append(piece(
        torch, f"dispatch dH ({a} rows into {t}, sort + gather kernel)",
        lambda: dispatch_dh("cuda"),
        bound(a * d * 2 + a * 4 + t * d * 2, a * d),
        lambda: torch.zeros(t, d, device=dev, dtype=bf16).index_add_(
            0, tok_sorted.long(), g_ys),
        "index_add_ of the rows", lambda: dispatch_dh("ref"), err,
        {"kernel": "gather_segment_reduce", "role": "dispatch dH"}))
    record["backward_pieces"] = pieces
    del prm, x, gy, xs, hu, hg, h, ys, g_h, g_ys, g_t, csr_t, pattern
    del c_order, wt, wts
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the embedding's backward at full vocab --------------------------
    vocab = cfg.padded_vocab
    data = train.TokenProvider(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
        global_batch=LM_TRAIN_BATCH, seed=SEED))
    ids = torch.from_numpy(data.batch(0)["tokens"]).to(dev).reshape(-1)
    g_e = torch.randn(t, d, generator=gen, device=dev, dtype=bf16)
    srt = torch.argsort(ids, stable=True)
    ids_s = ids.index_select(0, srt).to(torch.int32)
    g_s = g_e.index_select(0, srt).float()
    want = torch.zeros(vocab, d, device=dev).index_add_(0, ids.long(),
                                                        g_e.float())
    err = compare(torch, "embedding backward: segment_reduce vs index_add_",
                  kops.segment_reduce(g_s, ids_s, vocab, "sum",
                                      impl="cuda"), want, torch.float32)
    lengths = torch.bincount(ids_s.long(), minlength=vocab)
    print(f"  embedding backward: {t} sorted ids ({int((lengths > 0).sum())}"
          f" distinct) of F={d} into {vocab} segments, fp32:", flush=True)
    emb = piece(
        torch, "segment_reduce (embedding backward)",
        lambda: kops.segment_reduce(g_s, ids_s, vocab, "sum", impl="cuda"),
        bound(t * d * 4 + t * 4 + vocab * d * 4, t * d),
        lambda: torch.segment_reduce(g_s, "sum", lengths=lengths,
                                     unsafe=True),
        "torch.segment_reduce with per-segment lengths",
        lambda: kops.segment_reduce(g_s, ids_s, vocab, "sum", impl="ref"),
        err, {"kernel": "segment_reduce", "rows": t, "segments": vocab,
              "feat": d})
    table = torch.zeros(vocab, d, device=dev, dtype=bf16).requires_grad_()
    tab = types.SimpleNamespace(table=table)
    emb["whole_backward_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        layers_mod.embed(tab, ids), [table], g_e), reps=10, warmup=2)
    print(f"    the embedding's whole backward (argsort, gather, "
          f"segment_reduce, cast): {emb['whole_backward_ms']:.4f} ms",
          flush=True)
    record["embedding_backward"] = emb
    del want, g_s, g_e, table, tab, lengths
    torch.cuda.empty_cache()

    # -- (c) training through fit -------------------------------------------
    def tcfg(steps, **kw):
        return train.TrainerConfig(steps=steps, opt=adamw.AdamWConfig(),
                                   warmup_steps=1, seed=SEED, **kw)
    task = train.LMTask(cfg, moe_impl="cuda", device=dev)
    arrays, static = task.prepare(data.batch(0))
    state0 = train.Trainer(task, data, tcfg(LM_TRAIN_STEPS)).init_state()
    with torch.no_grad():
        ragged0 = float(train.LMTask(cfg, moe_impl="ragged", device=dev)
                        .loss(state0.params, arrays, static)[0])
    del state0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    ends = []

    def mark(step, metrics, verdict):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    kops.reset_launch_counts()
    with kops.fusion_scope() as ran:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = train.fit(task, data, tcfg(LM_TRAIN_STEPS), metrics_cb=mark)
    launches = kops.launch_counts()
    # the router-weight gradient's rows of F = 2048: sddmm's wide path
    paths_train = took_paths(kops, "lm training", {
        "segment_matmul": {"wgmma": launches["segment_matmul"],
                           "mma_sync": 0},
        "sddmm": {"runs": 0, "wide": launches["sddmm"]}})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [ends[0] - t0] + [ends[i] - ends[i - 1]
                               for i in range(1, len(ends))]
    missing = [kk for kk in LM_TRAIN_KERNELS if not launches[kk]]
    if missing:
        fail(f"lm training: kernels {missing} never launched: {launches}")
    plain = sorted(kk for kk in ran if kk.startswith("unfused:"))
    if plain:
        fail(f"lm training: an op took a plain version: {plain}")
    if not all(math.isfinite(v) for v in run.losses) or \
            len(run.losses) != LM_TRAIN_STEPS:
        fail(f"lm training: losses {run.losses}")
    split = profiled_train_step(torch, lambda: train.Trainer(
        task, data, tcfg(LM_TRAIN_STEPS + 1)).step(run.state,
                                                   LM_TRAIN_STEPS),
        task, trainer_mod)
    training = {
        "steps": LM_TRAIN_STEPS, "losses": run.losses,
        "step0_ragged_loss": ragged0,
        "step0_vs_ragged": abs(run.losses[0] - ragged0),
        "cold_step_s": step_s[0],
        "warm_step_ms": statistics.median(step_s[1:]) * 1e3,
        "step_s": step_s, "tokens_per_s": t / statistics.median(step_s[1:]),
        "peak_alloc_gb": peak_gb, "before_fit_gb": base_gb,
        "reckoned_state_gb": reckoned_gb,
        "launches": {kk: v for kk, v in launches.items() if v},
        "kernel_paths": paths_train,
        "profiled_step": split}
    record["training"] = training
    print(f"  fit: {LM_TRAIN_STEPS} steps, losses "
          f"{[round(v, 4) for v in run.losses]} (step 0 beside the "
          f"\"ragged\" forward on the same weights: {ragged0:.4f}, "
          f"{training['step0_vs_ragged']:.3g} apart; routing may differ); "
          f"cold step {step_s[0]:.2f} s, warm step "
          f"{training['warm_step_ms']:.1f} ms (median of steps 1-"
          f"{LM_TRAIN_STEPS - 1}, host clock after a synchronise), "
          f"{training['tokens_per_s']:.0f} tokens/s; peak "
          f"{peak_gb:.2f} GB allocated against the {reckoned_gb:.1f} GB "
          f"reckoning ({base_gb:.2f} GB before fit); launches "
          f"{training['launches']}", flush=True)
    print("  profiled warm step: wall_ms={wall_ms:.1f} device_busy_ms="
          "{device_busy_ms:.1f} idle_share={idle_share:.3f}; device spans: "
          "forward {forward_ms:.1f} ms, backward {backward_ms:.1f}, AdamW "
          "{adamw_ms:.1f}; the rest of the wall {rest_ms:.1f}"
          .format(**split), flush=True)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) bitwise replay -------------------------------------------------
    digests = []
    for _ in range(2):
        rep = train.fit(task, data, tcfg(LM_REPLAY_STEPS))
        digests.append(digest(torch, rep.state.params.values()))
        del rep
        gc.collect()
        torch.cuda.empty_cache()
    if digests[0] != digests[1]:
        bad = sum(x != y for x, y in zip(*digests))
        fail(f"lm training replay: {bad} of {len(digests[0])} parameter "
             "tensors differ between two runs from the same seed")
    print(f"  replay: two runs of {LM_REPLAY_STEPS} steps give bitwise-equal "
          f"parameters ({len(digests[0])} tensors, compared by digest)",
          flush=True)
    record["replay_bitwise"] = True

    # -- (e) kill and resume at reduced_100m --------------------------------
    small = reduced_100m(full)
    small_task = train.LMTask(small, moe_impl="cuda", device=dev)
    small_data = train.TokenProvider(TokenDatasetConfig(
        vocab_size=small.vocab_size, seq_len=256, global_batch=4,
        seed=SEED))
    whole = train.fit(small_task, small_data, tcfg(LM_RESUME_STEPS))
    tmp = tempfile.mkdtemp(prefix="lm_resume_")

    class Killed(Exception):
        pass

    def killer(step, metrics, verdict):
        if step == LM_RESUME_EVERY:
            raise Killed()
    try:
        try:
            train.fit(small_task, small_data, tcfg(
                LM_RESUME_STEPS, ckpt_dir=tmp, ckpt_every=LM_RESUME_EVERY),
                metrics_cb=killer)
            fail("lm resume: the killed run was not interrupted")
        except Killed:
            pass
        resumed = train.fit(small_task, small_data, tcfg(
            LM_RESUME_STEPS, ckpt_dir=tmp, ckpt_every=LM_RESUME_EVERY),
            resume=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = resumed.start_step == LM_RESUME_EVERY and \
        resumed.losses == whole.losses[LM_RESUME_EVERY:] and all(
            torch.equal(p, resumed.state.params[kk])
            for kk, p in whole.state.params.items())
    if not same:
        fail(f"lm resume at reduced_100m: start {resumed.start_step}, "
             f"losses {resumed.losses} vs {whole.losses}, or the final "
             "parameters differ from the uninterrupted run's")
    print(f"  kill and resume at reduced_100m ({small.num_layers} layers, "
          f"d_model {small.d_model}, {small.num_experts} experts, fp32): "
          f"killed after step {LM_RESUME_EVERY} of {LM_RESUME_STEPS}, "
          f"resumed from its checkpoint: final parameters bitwise the "
          f"uninterrupted run's", flush=True)
    record["resume_bitwise"] = True
    record["launches"] = training["launches"]
    record["kernel_paths"] = training["kernel_paths"]
    del whole, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return record


# phase 3j: the LM/MoE stack sharded across 4 ranks on a 2x2 ("data",
# "model") mesh (DTensor; moe_shard_map for the experts). qwen3-moe-30b-a3b
# at full width, depth cut from 48 to LM_SHARD_LAYERS layers; one process a
# rank, as phase 3g spawns them
LM_SHARD_LAYERS = 2
LM_SHARD_BATCH, LM_SHARD_SEQ = 4, 1024     # 2 x 1024 tokens a data shard
LM_SHARD_DECODE = 8
LM_SHARD_STEPS = 3
LM_SHARD_TP = (4, 256)                     # tp_out_project's x: (B, S, q_dim)
LM_SHARD_PG_TIMEOUT_S, LM_SHARD_DEADLINE_S = 180, 600
# the kernels the sharded path must launch on every rank: the gather (the
# per-shard combine, its dH, the dispatch gather's backward) and sddmm (the
# combine's router-weight gradient)
LM_SHARD_KERNELS = ("gather_segment_reduce", "sddmm")
# the dropless path (moe_impl="cuda", moe_ragged_shard_map) adds the
# expert products and their dX on segment_matmul
LM_DROPLESS_KERNELS = ("segment_matmul", "gather_segment_reduce", "sddmm")
# the capacity path's peak a rank over its tallied warm step before the
# sharded loss kept its gold logit a data shard's (NVIDIA H100 80GB HBM3,
# 700.00 W)
LM_SHARD_PEAK_BEFORE_GB = 14.01
# the dropless path's step-0 loss against the single-device loss on the same
# batch, relative (it read 8.5e-6 on the H100)
LM_SHARD_LOSS_RTOL = 1e-4


def spawn_ranks(torch, target, deadline_s: int, what: str) -> dict:
    """Spawn SHARDS ranks running ``target(rank, world, backend, store,
    out)`` (NCCL with a card a rank, else gloo with all ranks on the one
    card), wait for them, fail unless every rank exits 0; returns the
    record rank 0 wrote to ``out``."""
    import multiprocessing
    world = SHARDS
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{what}_")
    out = os.path.join(tmp, "rank0.json")
    # the ranks share the card with this process: drop what the earlier
    # phases left behind (cycles included) before they start
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  [{what}] spawning {world} ranks ({backend}); this process "
          f"holds {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; the card "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free", flush=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, backend, os.path.join(tmp, "store"),
                               out)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        # a rank that fails ends the phase at once: the others would wait
        # in their next collective until the group's timeout
        deadline = time.monotonic() + deadline_s
        codes = [None] * world
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0)
                                                 for c in codes):
                break
            time.sleep(0.5)
        if any(c != 0 for c in codes):
            fail(f"{what} phase: rank exit codes {codes} (None: killed "
                 f"at the {deadline_s} s deadline)")
        return json.loads(Path(out).read_text())
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def lm_sharded_rank(rank: int, world: int, backend: str, store: str,
                    out: str) -> None:
    """Phase 3j on one rank (a spawned process); an exception ends the
    process with a non-zero exit code; rank 0 writes the record."""
    import datetime

    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=LM_SHARD_PG_TIMEOUT_S))
    try:
        _lm_sharded_rank(torch, dist, rank, world, backend, dev, out)
    finally:
        dist.destroy_process_group()


def _local_share(torch, t, spec, sizes) -> bool:
    """Whether a DTensor holds exactly its share: the whole numel over the
    product of the mesh dims its spec shards it on."""
    parts = 1
    for entry in spec:
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                parts *= sizes[name]
    return t.to_local().numel() * parts == t.numel()


@contextlib.contextmanager
def shard_held(torch, shd, moe_mod, kops, plain_of, moe_impl, what, rows,
               ref):
    """While open, every expert-parallel MoE call (``moe_shard_map`` for
    ``moe_impl="capacity"``, ``moe_ragged_shard_map`` for the dropless
    path) is also run on this rank's data shard by the single-device layer
    with the plain model's weights, and held to it at the bf16 tolerance:
    ``moe_capacity`` at the shard's capacity (the same routing, the same
    drops), or the plain ``moe_ragged(impl="ref")`` (every token's output
    is its own). The model goes on with the sharded output. The
    reference's kernel launches go to ``ref`` (:func:`not_counted`); its
    plain ops are recorded outside the caller's fusion scope."""
    name = ("moe_shard_map" if moe_impl == "capacity"
            else "moe_ragged_shard_map")
    sharded = getattr(moe_mod, name)

    def held(prm, x, cfg, **kw):
        y, aux = sharded(prm, x, cfg, **kw)
        mesh, plan = shd.current_context()
        rows_pl = shd.placements(shd.spec_for_axes(("batch", None, None),
                                                   x.shape, plan, mesh), mesh)
        x_loc = x.redistribute(mesh, rows_pl).to_local()
        with not_counted(kops, ref):
            if moe_impl == "capacity":
                t_loc = x_loc.shape[0] * x_loc.shape[1]
                cap = max(1, int(t_loc * cfg.top_k * cfg.capacity_factor
                                 / cfg.num_experts))
                cap = -(-cap // 8) * 8
                want, _ = moe_mod.moe_capacity(plain_of[id(prm)], x_loc, cfg,
                                               capacity=cap)
                against = f"moe_capacity on the data shard (capacity {cap})"
            else:
                with kops.in_fusion_scopes(()):
                    want, _ = moe_mod.moe_ragged(plain_of[id(prm)], x_loc,
                                                 cfg, impl="ref")
                against = "the plain moe_ragged on the data shard"
        got = y.redistribute(mesh, rows_pl).to_local()
        err = compare(torch, f"{what}: MoE layer call {len(rows)} against "
                      f"{against}", got, want, torch.bfloat16)
        rows.append((err, float(want.float().abs().max())))
        return y, aux
    setattr(moe_mod, name, held)
    try:
        yield
    finally:
        setattr(moe_mod, name, sharded)


def _lm_sharded_rank(torch, dist, rank, world, backend, dev, out):
    import copy
    import types

    from repro_torch import configs as lm_configs
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    torch.backends.cuda.matmul.allow_tf32 = False

    def say(msg):
        if rank == 0:
            print(f"  [3j] {msg}", flush=True)

    def every(value):
        box = [None] * world
        dist.all_gather_object(box, value)
        return box

    mesh = make_host_mesh(2, 2, device_type="cuda")
    plan = shd.ParallelPlan.for_mesh(mesh)
    sizes = shd.mesh_sizes(mesh)
    d_rank = mesh.get_local_rank("data")
    full = lm_configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_SHARD_LAYERS)
    bf16 = torch.bfloat16
    rec = {"backend": backend, "world": world, "mesh": "2x2 (data, model)",
           "arch": LM_ARCH, "layers": cfg.num_layers,
           "published_layers": full.num_layers,
           "reduced": f"depth {full.num_layers} -> {cfg.num_layers} layers",
           "ranks_on_cards": (
               "one card a rank" if backend == "nccl" else
               "all ranks on one card; gloo moves CUDA tensors through the "
               "host, its functional all-gather routed through c10d's")}
    say(f"backend {backend}, {world} ranks ({rec['ranks_on_cards']}); "
        f"{LM_ARCH} at full width, depth cut from {full.num_layers} to "
        f"{cfg.num_layers} layers")

    # -- (a) one MoE layer through moe_shard_map, forward and gradients ----
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)   # the same a rank
    prm = moe_mod.moe_init(gen, cfg, bf16, dev)
    x = torch.randn(LM_SHARD_BATCH, LM_SHARD_SEQ, cfg.d_model, generator=gen,
                    device=dev, dtype=bf16)
    ct = torch.randn(x.shape, generator=gen, device=dev, dtype=bf16)
    names = ("router", "w_up", "w_gate", "w_down")
    sprm = shd.distribute(copy.deepcopy(prm), plan, mesh)
    leaves = {n: getattr(sprm, n).detach().requires_grad_() for n in names}
    xpl = shd.placements(shd.spec_for_axes(("batch", "seq", None), x.shape,
                                           plan, mesh), mesh)
    xs = shd.place_tensor(x, mesh, xpl).requires_grad_()
    cts = shd.place_tensor(ct, mesh, xpl)
    kops.reset_launch_counts()
    with shd.activation_sharding(mesh, plan):
        y, _ = moe_mod.moe_shard_map(types.SimpleNamespace(**leaves), xs,
                                     cfg)
        grads = torch.autograd.grad((y * cts).sum(),
                                    [xs] + [leaves[n] for n in names])
    torch.cuda.synchronize()
    launched_a = {k: v for k, v in kops.launch_counts().items() if v}
    # the single-device reference on this rank's data shard, at the shard's
    # capacity; the weights' gradients summed over the data shards
    lo = d_rank * (LM_SHARD_BATCH // sizes["data"])
    hi = lo + LM_SHARD_BATCH // sizes["data"]
    t_loc = (hi - lo) * LM_SHARD_SEQ
    cap = -(-max(1, int(t_loc * cfg.top_k * cfg.capacity_factor
                        / cfg.num_experts)) // 8) * 8
    rl = {n: getattr(prm, n).detach().clone().requires_grad_()
          for n in names}
    xl = x[lo:hi].clone().requires_grad_()
    want, _ = moe_mod.moe_capacity(types.SimpleNamespace(**rl), xl, cfg,
                                   capacity=cap)
    wgrads = torch.autograd.grad((want * ct[lo:hi]).sum(),
                                 [xl] + [rl[n] for n in names])
    wgrads = list(wgrads)
    for g in wgrads[1:]:
        dist.all_reduce(g, group=mesh.get_group("data"))
    errs = {"output": compare(torch, f"rank {rank} moe_shard_map output",
                              y.to_local(), want, bf16),
            "dx": compare(torch, f"rank {rank} moe_shard_map dx",
                          grads[0].redistribute(mesh, xpl).to_local(),
                          wgrads[0], bf16)}
    for n, g, w in zip(names, grads[1:], wgrads[1:]):
        errs[f"d{n}"] = compare(torch, f"rank {rank} moe_shard_map d{n}",
                                g.full_tensor(), w, bf16)
    for k in LM_SHARD_KERNELS:
        if not launched_a.get(k):
            fail(f"rank {rank}: moe_shard_map's forward and backward never "
                 f"launched {k}: {launched_a}")
    rec["moe_shard_map"] = {
        "tokens_a_data_shard": t_loc, "capacity": cap,
        "max_abs_err": errs, "launches": launched_a,
        "seconds": time.perf_counter() - t0}
    say(f"(a) moe_shard_map at {t_loc} tokens a data shard (capacity "
        f"{cap}), forward and gradients, within the bf16 tolerance of the "
        f"single-device moe_capacity on each data shard: {errs}; "
        f"launches {launched_a}")
    del prm, sprm, leaves, x, ct, xs, cts, y, grads, rl, xl, want, wgrads

    # -- (b) tp_out_project at wo's full width -----------------------------
    xt = torch.randn(*LM_SHARD_TP, cfg.q_dim, generator=gen, device=dev,
                     dtype=bf16)
    wt = torch.randn(cfg.q_dim, cfg.d_model, generator=gen, device=dev,
                     dtype=bf16) / math.sqrt(cfg.q_dim)
    axes = ("heads", "embed")
    wpl = shd.placements(shd.spec_for_axes(axes, wt.shape, plan, mesh), mesh)
    xtpl = shd.placements(shd.spec_for_axes(("batch", None, "act_heads"),
                                            xt.shape, plan, mesh), mesh)
    with shd.activation_sharding(mesh, plan):
        got = layers_mod.tp_out_project(
            shd.place_tensor(xt, mesh, xtpl), shd.place_tensor(wt, mesh, wpl),
            axes)
    rec["tp_out_project"] = {
        "x": list(xt.shape), "w": list(wt.shape),
        "max_abs_err": compare(torch, f"rank {rank} tp_out_project",
                               got.full_tensor(), xt @ wt, bf16)}
    say(f"(b) tp_out_project {tuple(xt.shape)} @ {tuple(wt.shape)} within "
        f"the bf16 tolerance of the plain matmul: {rec['tp_out_project']}")
    del xt, wt, got

    # -- (c) + (d) the main path, launch counters zeroed --------------------
    main = _sharded_serve_and_train(torch, dist, rank, dev, mesh, plan, cfg,
                                    "capacity", gen, ("c", "d"), say)
    rec.update(main["record"])
    run, launched, main_paths = main["run"], main["launches"], main["paths"]
    del main
    # each rank's parameters and moments hold exactly its share
    skeleton = lm.LM(cfg, device="meta", seed=None)
    specs = shd.param_specs(skeleton, plan, mesh)
    st = run.state
    bad = [k for k, p in st.params.items()
           if not _local_share(torch, p, specs[k], sizes)
           or not _local_share(torch, st.opt_state.mu[k], specs[k], sizes)
           or not _local_share(torch, st.opt_state.nu[k], specs[k], sizes)]
    if bad:
        fail(f"rank {rank}: parameters or moments not held as their share "
             f"of the mesh (silently replicated?): {bad[:5]}")
    local_bytes = sum(p.to_local().numel() * p.to_local().element_size()
                      + st.opt_state.mu[k].to_local().numel() * 4
                      + st.opt_state.nu[k].to_local().numel() * 4
                      for k, p in st.params.items())
    n_params = sum(p.numel() for p in st.params.values())
    rec["training"].update(
        params=n_params, local_param_and_moment_bytes=local_bytes,
        whole_param_and_moment_bytes=n_params * (2 + 8))
    say(f"(d) every parameter and moment held as its share "
        f"({local_bytes / 1e9:.3f} GB a rank of "
        f"{n_params * 10 / 1e9:.3f} GB whole)")

    # -- (e) elastic restore: saved under 2x2, restored under 4x1 ----------
    t0 = time.perf_counter()
    part = {k: p for k, p in st.params.items() if k.startswith("layers.0.")}
    whole = {k: p.detach().full_tensor() for k, p in part.items()}
    tmp = os.path.join(os.path.dirname(out), "elastic")
    if rank == 0:
        ckpt.save(whole, tmp, 0)
    dist.barrier()
    mesh_b = make_host_mesh(4, 1, device_type="cuda")
    plan_b = shd.ParallelPlan.for_mesh(mesh_b)
    psh_b = shd.param_shardings(skeleton, plan_b, mesh_b)
    restored = ckpt.restore(whole, tmp, 0, shardings={
        k: ckpt.Sharding(mesh_b, tuple(psh_b[k])) for k in whole})
    bitwise = all(torch.equal(restored[k].to_local(), shd.place_tensor(
        whole[k], mesh_b, psh_b[k]).to_local()) for k in whole)
    if not bitwise:
        fail(f"rank {rank}: the elastic restore (2x2 -> 4x1) is not bitwise")
    rec["elastic"] = {"tensors": len(whole),
                      "bytes": sum(t.numel() * t.element_size()
                                   for t in whole.values()),
                      "what": "layer 0's parameters after training",
                      "seconds": time.perf_counter() - t0, "bitwise": True}
    say(f"(e) elastic restore of {len(whole)} tensors "
        f"({rec['elastic']['bytes'] / 1e9:.2f} GB) saved under 2x2, restored "
        f"under 4x1: bitwise on every rank")
    peak_gb = rec["tally_train"]["max_memory_allocated"] / 1e9
    say(f"(d) the capacity path's peak over its tallied warm step: "
        f"{peak_gb:.2f} GB a rank (before the gold logit was kept a data "
        f"shard's: {LM_SHARD_PEAK_BEFORE_GB} GB)")
    rec["launches"] = launched
    rec["launches_by_rank"] = every(launched)
    rec["paths_by_rank"] = every(main_paths)
    rec["peak_mem_gb_by_rank"] = every(max(rec["serving"]["peak_mem_gb"],
                                           rec["training"]["peak_mem_gb"]))
    rec["tally_peak_gb_by_rank"] = every(peak_gb)

    # -- (f)-(h) the dropless MoE (moe_impl="cuda") on the same mesh --------
    del run, st, part, whole, restored
    gc.collect()
    torch.cuda.empty_cache()
    dropless = _lm_dropless(torch, dist, rank, dev, mesh, plan, cfg, say)
    rec["dropless"] = dropless
    rec["dropless"]["launches_by_rank"] = every(dropless["launches"])
    rec["dropless"]["paths_by_rank"] = every(dropless["paths"])
    rec["dropless"]["peak_mem_gb_by_rank"] = every(dropless["peak_mem_gb"])
    if rank == 0:
        Path(out).write_text(json.dumps(rec))


def _dropless_tail(torch, kops, moe_mod, cfg, prm, x_loc, e_m, m_rank):
    """The static tail against the live count on one rank, at two shares
    of the experts on the same tokens: this run's (``e_m`` experts of
    model rank ``m_rank``) and a 16-way "model" axis's (E/16 experts,
    about 1/16 of the T_loc·k sorted rows live: the production meshes').
    ``moe_ragged_shard_map`` runs all sorted rows (the rows past the
    rank's groups come out 0); the alternative reads the live count and
    runs only its own. For each share: segment_matmul's up and down products over
    all rows against the live rows; the expert part of the forward (the
    dispatch gather, the three products, the activation) by CUDA events,
    and by the host's clock over 20 layers back to back, where the live
    variant reads its count each layer (the sync drains the queue) and the
    static one runs ahead; at this run's share also each product's bound,
    its plain version's time and ``torch._grouped_mm``'s on the same
    inputs. Besides, the host time of reading the count on an idle
    card."""
    geot = moe_mod.geot
    act = moe_mod.layers._ACTS[cfg.act]
    out = {}
    with torch.no_grad():
        t_loc = x_loc.shape[0]
        te, tp, _, _ = moe_mod._route_local(x_loc, prm.router, cfg=cfg)
        e_flat, _, tok_flat = moe_mod._assignments(te, tp, t_loc, cfg.top_k)
        for share, e_s, r_s in (("model_2", e_m, m_rank),
                                ("model_16", cfg.num_experts // 16, 0)):
            _, order, sizes = moe_mod._own_first(e_flat, e_s, r_s)
            tok_sorted = tok_flat[order]
            lo = r_s * e_s
            wu, wg, wd = (w[lo:lo + e_s].contiguous()
                          for w in (prm.w_up, prm.w_gate, prm.w_down))
            xs = geot.gather(x_loc, tok_sorted, impl="cuda")
            hs = torch.randn(xs.shape[0], cfg.moe_d_ff, device=xs.device,
                             dtype=xs.dtype)
            live = int(sizes.sum())
            active = int((sizes > 0).sum())
            offs = torch.cumsum(sizes, 0, dtype=torch.int32)
            rec = {"experts": e_s, "rows": int(xs.shape[0]),
                   "live_rows": live, "experts_with_rows": active}

            def forward(rows):
                xr = geot.gather(x_loc, tok_sorted[:rows], impl="cuda")
                hu = geot.segment_matmul(xr, sizes, wu, impl="cuda")
                hg = geot.segment_matmul(xr, sizes, wg, impl="cuda")
                return geot.segment_matmul(act(hg) * hu, sizes, wd,
                                           impl="cuda")
            rec["forward_static_ms"] = time_ms(
                torch, lambda: forward(xs.shape[0]))
            rec["forward_live_ms"] = time_ms(torch, lambda: forward(live))
            for name, fn in (
                    ("static", lambda: forward(xs.shape[0])),
                    ("live", lambda: forward(max(int(sizes.sum()), 1)))):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                rec[f"forward_{name}_wall_ms"] = \
                    (time.perf_counter() - t0) * 1e3 / 20
            for what, a, w in (("up", xs, wu), ("down", hs, wd)):
                rec[f"{what}_static_ms"] = time_ms(
                    torch, lambda: kops.segment_matmul(a, sizes, w,
                                                       impl="cuda"))
                rec[f"{what}_live_ms"] = time_ms(
                    torch, lambda: kops.segment_matmul(a[:live], sizes, w,
                                                       impl="cuda"))
                if share != "model_2":
                    continue
                kd, nd = int(w.shape[1]), int(w.shape[2])
                # the wgmma path (checked, bitwise, beside today's kernel)
                row = smm_row(torch, kops, f"segment_matmul {what} over the "
                              "static tail", a, sizes, w)
                rec[f"{what}_max_abs_err"] = row["max_abs_err"]
                rec[f"{what}_path"] = row["path"]
                # the live rows read, every row written (the tail as 0),
                # the weights of the experts with rows read once
                rec[f"{what}_bound_ms"], rec[f"{what}_bound_by"] = bound(
                    live * kd * 2 + a.shape[0] * nd * 2
                    + active * kd * nd * 2 + (e_s + 1) * 4,
                    2 * live * kd * nd, BF16_FLOPS, "bf16 tensor cores")
                rec[f"{what}_plain_ms"] = time_ms(
                    torch, lambda: kops.segment_matmul(a, sizes, w,
                                                       impl="ref"),
                    reps=3, warmup=1)
                lib, note = library(
                    f"torch._grouped_mm dropless {what}",
                    lambda: torch._grouped_mm(a, w, offs=offs))
                rec[f"{what}_library_ms"] = None if lib is None else time_ms(
                    torch, lambda: torch._grouped_mm(a, w, offs=offs))
                rec[f"{what}_library_note"] = (
                    note or "torch._grouped_mm with the group offsets, "
                    "the rows past the last offset left to it")
            out[share] = rec
            del xs, hs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            int(sizes.sum())
        out["live_count_sync_ms"] = (time.perf_counter() - t0) * 1e3 / 50
    return out


def _lm_dropless(torch, dist, rank, dev, mesh, plan, cfg, say) -> dict:
    """3j's dropless part on one rank: (f) one MoE layer through
    ``moe(impl="cuda")`` under the mesh, held to the single-device
    ``moe_ragged(impl="cuda")`` and the fp32 plain path; the tail rows'
    cost (rank 0); then the main path with ``moe_impl="cuda"``
    (:func:`_sharded_serve_and_train`): (g) prefill and decode steps, every
    MoE layer held to the plain ``moe_ragged`` on its data shard, and (h)
    ``fit(mesh=)`` on ``LMTask(moe_impl="cuda")``."""
    import copy
    import types

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops as kops
    from repro_torch.models import moe as moe_mod
    bf16 = torch.bfloat16
    sizes = shd.mesh_sizes(mesh)
    d_rank = mesh.get_local_rank("data")
    rec = {"moe_impl": "cuda"}

    # -- (f) one MoE layer, forward and gradients, routing held ------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)  # one a rank
    prm = moe_mod.moe_init(gen, cfg, bf16, dev)
    x = torch.randn(LM_SHARD_BATCH, LM_SHARD_SEQ, cfg.d_model, generator=gen,
                    device=dev, dtype=bf16)
    ct = torch.randn(x.shape, generator=gen, device=dev, dtype=bf16)
    names = ("router", "w_up", "w_gate", "w_down")
    sprm = shd.distribute(copy.deepcopy(prm), plan, mesh)
    leaves = {n: getattr(sprm, n).detach().requires_grad_() for n in names}
    xpl = shd.placements(shd.spec_for_axes(("batch", "seq", None), x.shape,
                                           plan, mesh), mesh)
    xs = shd.place_tensor(x, mesh, xpl).requires_grad_()
    cts = shd.place_tensor(ct, mesh, xpl)
    kops.reset_launch_counts()
    with shd.activation_sharding(mesh, plan):
        y, _ = moe_mod.moe(types.SimpleNamespace(**leaves), xs, cfg,
                           impl="cuda")
        grads = torch.autograd.grad((y * cts).sum(),
                                    [xs] + [leaves[n] for n in names])
    torch.cuda.synchronize()
    launched_f = {k: v for k, v in kops.launch_counts().items() if v}
    for k in LM_DROPLESS_KERNELS:
        if not launched_f.get(k):
            fail(f"rank {rank}: the dropless MoE layer under the mesh never "
                 f"launched {k}: {launched_f}")
    took_paths(kops, f"rank {rank}: the dropless MoE layer under the mesh",
               {"segment_matmul": {"wgmma": launched_f["segment_matmul"],
                                   "mma_sync": 0},
                "sddmm": {"runs": 0, "wide": launched_f["sddmm"]}})
    got = [y.to_local(), grads[0].redistribute(mesh, xpl).to_local()] + [
        g.full_tensor() for g in grads[1:]]
    del sprm, leaves, xs, cts, y, grads
    # the single-device layer on this rank's data shard (every token's
    # output is its own: no capacity), on the kernels and on the fp32
    # plain path; the weights' gradients summed over the data shards
    lo = d_rank * (LM_SHARD_BATCH // sizes["data"])
    hi = lo + LM_SHARD_BATCH // sizes["data"]
    errs = {}
    for impl, up in (("ref", lambda v: v.float()), ("cuda", lambda v: v)):
        rl = {n: up(getattr(prm, n)).detach().clone().requires_grad_()
              for n in names}
        xl = up(x[lo:hi]).detach().clone().requires_grad_()
        want, _ = moe_mod.moe_ragged(types.SimpleNamespace(**rl), xl, cfg,
                                     impl=impl)
        wgrads = list(torch.autograd.grad((want * up(ct[lo:hi])).sum(),
                                          [xl] + [rl[n] for n in names]))
        for g in wgrads[1:]:
            dist.all_reduce(g, group=mesh.get_group("data"))
        against = "fp32 plain" if impl == "ref" else "single-device kernels"
        for what, a, b in zip(("output", "dx") + tuple(f"d{n}"
                                                       for n in names),
                              got, [want] + wgrads):
            err = compare(torch, f"rank {rank} dropless MoE layer {what} vs "
                          f"{against}", a, b, bf16)
            errs[f"{what} vs {against}"] = err / max(
                float(b.float().abs().max()), 1e-30)
        del rl, xl, want, wgrads
    t_loc = (hi - lo) * LM_SHARD_SEQ
    rec["moe_layer"] = {"tokens_a_data_shard": t_loc,
                        "assignments_a_data_shard": t_loc * cfg.top_k,
                        "max_rel_err": errs, "launches": launched_f,
                        "seconds": time.perf_counter() - t0}
    say(f"(f) the dropless MoE layer under the mesh at {t_loc} tokens a data "
        f"shard, forward and gradients, within the bf16 tolerance of the "
        f"fp32 plain path and of the single-device kernels (max error / max "
        f"|want|: {errs}); launches {launched_f}")
    dist.barrier()
    if rank == 0:      # the others wait at the barrier: the card is ours
        rec["tail"] = _dropless_tail(
            torch, kops, moe_mod, cfg, prm,
            x[lo:hi].reshape(-1, cfg.d_model),
            cfg.num_experts // sizes["model"], mesh.get_local_rank("model"))
        say(f"(f) the static tail (all sorted rows) against the live "
            f"count, at this run's share and a 16-way model axis's: "
            f"{rec['tail']}")
    dist.barrier()
    del prm, x, ct
    torch.cuda.empty_cache()

    # -- (g) + (h) the main path, launch counters zeroed --------------------
    main = _sharded_serve_and_train(
        torch, dist, rank, dev, mesh, plan, cfg, "cuda",
        torch.Generator(device=dev).manual_seed(SEED + 3), ("g", "h"), say)
    rec.update(main["record"])
    rec["launches"], rec["paths"] = main["launches"], main["paths"]
    rec["peak_mem_gb"] = max(rec["serving"]["peak_mem_gb"],
                             rec["training"]["peak_mem_gb"])
    return rec


def _sharded_serve_and_train(torch, dist, rank, dev, mesh, plan, cfg,
                             moe_impl, gen, tags, say) -> dict:
    """3j's main path on one rank with ``moe_impl`` ("capacity", or "cuda":
    the dropless kernels), the launch counters zeroed just before it and
    read just after. (tags[0]) A prefill and LM_SHARD_DECODE decode steps,
    every MoE layer held to the single-device layer on its data shard
    (:func:`shard_held`), the logits read against the single-device
    decode; (tags[1]) ``fit(mesh=)`` on ``LMTask(moe_impl=)`` for
    LM_SHARD_STEPS steps: the first loss beside the single-device loss on
    the same batch (held within LM_SHARD_LOSS_RTOL on the dropless path;
    a reading on the capacity path, whose capacity from the local tokens
    drops otherwise), the warm step, its profiled split and the peak. The
    capacity path also runs one decode and one warm train step under the
    dry run's tally (phase 3k holds its trace to them). Returns
    ``{"record", "run", "launches"}``: the launches are the path's alone,
    the single-device references' taken out."""
    import copy

    from repro_torch import train
    from repro_torch.data.tokens import TokenDatasetConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.tally import StepTally
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw
    bf16 = torch.bfloat16
    capacity = moe_impl == "capacity"
    kernels = LM_SHARD_KERNELS if capacity else LM_DROPLESS_KERNELS
    what = f"rank {rank} {'' if capacity else 'dropless '}sharded"
    rec = {}
    model = lm.LM(cfg, device=dev, seed=SEED)            # the same a rank
    smodel = shd.distribute(copy.deepcopy(model), plan, mesh)
    plain_of = {id(sb.ffn): b.ffn for sb, b in zip(smodel.layers,
                                                   model.layers)}
    tokens = torch.randint(0, cfg.vocab_size, (LM_SHARD_BATCH, LM_SHARD_SEQ),
                           generator=gen, device=dev)
    prefill = steplib.build_prefill_step(cfg, mesh, plan, moe_impl=moe_impl)
    serve, shardings_for = steplib.build_serve_step(
        cfg, mesh, plan, LM_SHARD_BATCH, 16, moe_impl=moe_impl)
    held_rows = []
    ref = {"launches": collections.Counter(),
           "paths": collections.defaultdict(collections.Counter)}
    torch.cuda.synchronize()
    dist.barrier()
    kops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with kops.fusion_scope() as fusion:
        with shard_held(torch, shd, moe_mod, kops, plain_of, moe_impl,
                        f"{what} serve", held_rows, ref):
            t0 = time.perf_counter()
            logits = prefill(smodel, {"tokens": tokens})
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(logits.to_local()).all()):
                fail(f"{what}: non-finite prefill logits")
            state = steplib.shard_decode_state(
                lm.init_decode_state(cfg, LM_SHARD_BATCH, 16, bf16,
                                     device=dev),
                shardings_for(None)[2], mesh)
            tok = tokens[:, :1]
            steps_ms, dec_logits = [], []
            for _ in range(LM_SHARD_DECODE):
                t0 = time.perf_counter()
                lg, state = serve(smodel, tok, state)
                torch.cuda.synchronize()
                steps_ms.append((time.perf_counter() - t0) * 1e3)
                whole = lg.full_tensor()
                if not bool(torch.isfinite(whole).all()):
                    fail(f"{what}: non-finite decode logits")
                dec_logits.append(whole)
                tok = whole[:, -1].argmax(-1, keepdim=True)
        held = held_reading(f"{what} serving", held_rows,
                            (1 + LM_SHARD_DECODE) * cfg.num_layers)
        serve_mem = torch.cuda.max_memory_allocated()
        if capacity:
            # one more decode step on a fresh state, counted as the dry
            # run counts (phase 3k holds its trace to this): not timed
            fresh = steplib.shard_decode_state(
                lm.init_decode_state(cfg, LM_SHARD_BATCH, 16, bf16,
                                     device=dev),
                shardings_for(None)[2], mesh)
            with StepTally() as tally:
                serve(smodel, tokens[:, :1], fresh)
            torch.cuda.synchronize()
            rec["tally_decode"] = tally_record(tally)
            del fresh
        del logits, state
        # the single-device decode of the same tokens, a reading
        ref_state = lm.init_decode_state(cfg, LM_SHARD_BATCH, 16, bf16,
                                         device=dev)
        tok, e2e = tokens[:, :1], []
        with not_counted(kops, ref):
            for want in dec_logits:
                lg, ref_state = lm.decode_step(model, tok, ref_state,
                                               moe_impl=moe_impl)
                e2e.append(e2e_reading(torch, f"{what} decode", want, lg))
                tok = want[:, -1].argmax(-1, keepdim=True)
        # the single-device model (and the layers the held checks read)
        # is done with: four ranks share the card's memory
        del ref_state, dec_logits, smodel, model, plain_of
        rec["serving"] = {
            "moe_impl": moe_impl,
            "prefill_tokens": [LM_SHARD_BATCH, LM_SHARD_SEQ],
            "prefill_ms": prefill_ms, "decode_steps": LM_SHARD_DECODE,
            "decode_step_ms": steps_ms,
            "decode_step_ms_median": statistics.median(steps_ms[1:]),
            "moe_held_worst_share": held, "moe_held_layers": len(held_rows),
            "e2e_logits_vs_single_device": [
                {"max_abs_err": a, "argmax_flips": b, "rows": c}
                for a, b, c in e2e],
            "peak_mem_gb": serve_mem / 1e9}
        say(f"({tags[0]}) moe_impl={moe_impl!r}: prefill {LM_SHARD_BATCH}x"
            f"{LM_SHARD_SEQ} in {prefill_ms:.1f} ms, {LM_SHARD_DECODE} decode "
            f"steps (median {rec['serving']['decode_step_ms_median']:.1f} "
            f"ms); every MoE layer held to the single-device layer on its "
            f"data shard (worst {held:.3g} of the layer's max, "
            f"{margin(held)}); logits vs the single-device decode "
            f"(reading): {e2e}")

        # training: fit(mesh=) on LMTask(moe_impl=)
        task = train.LMTask(cfg, moe_impl=moe_impl, device=dev)
        data = train.TokenProvider(TokenDatasetConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_SHARD_SEQ,
            global_batch=LM_SHARD_BATCH))
        tcfg = train.TrainerConfig(steps=LM_SHARD_STEPS, warmup_steps=1,
                                   opt=adamw.AdamWConfig(lr=1e-4))
        trainer = train.Trainer(task, data, tcfg, mesh=mesh)
        with not_counted(kops, ref):
            st0 = trainer.init_state()
            whole0 = {k: p.full_tensor() for k, p in st0.params.items()}
            del st0
            batch0 = {k: torch.as_tensor(v).to(dev)
                      for k, v in data.batch(0).items()}
            with torch.no_grad():
                ref_loss0 = float(lm.loss_fn(whole0, cfg, batch0,
                                             remat_policy="none",
                                             moe_impl=moe_impl)[0])
            del whole0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ends = []

        def mark(step, metrics, verdict):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
        t0 = time.perf_counter()
        run = trainer.fit(metrics_cb=mark)
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + ends[:-1], ends)]
        split = ((None,) * 3 if rank else profiled_split(
            torch, lambda: trainer.step(run.state, LM_SHARD_STEPS),
            port_kernel_names()))
        if rank:
            trainer.step(run.state, LM_SHARD_STEPS)
        train_mem = torch.cuda.max_memory_allocated()
        if capacity:
            # one more warm step, counted as the dry run counts (phase 3k
            # holds its trace to this): not timed, not profiled; the peak
            # over it with the state in place
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with StepTally() as tally:
                trainer.step(run.state, LM_SHARD_STEPS + 1)
            torch.cuda.synchronize()
            rec["tally_train"] = dict(
                tally_record(tally),
                max_memory_allocated=torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    # the path's launches, each kernel's and by path
    launched = count_diff(kops.launch_counts(), ref["launches"])
    paths = count_diff(kops.path_launch_counts(), ref["paths"])
    if paths["segment_matmul"]["mma_sync"] or paths["sddmm"]["runs"]:
        fail(f"{what}: a MoE product took segment_matmul's mma_sync path, "
             f"or a router-weight gradient sddmm's runs path: {paths}")
    losses = run.losses
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: non-finite losses {losses}")
    rel = abs(losses[0] - ref_loss0) / max(abs(ref_loss0), 1e-30)
    if not capacity and rel > LM_SHARD_LOSS_RTOL:
        fail(f"{what}: step 0 loss {losses[0]} is {rel:.3g} off the "
             f"single-device loss {ref_loss0} on the same batch (held "
             f"within {LM_SHARD_LOSS_RTOL})")
    for k in kernels:
        if launched[k] == 0:
            fail(f"{what}: kernel {k} of the path never launched: "
                 f"{launched}")
    plain = sorted(k for k in dict(fusion) if k.startswith("unfused:"))
    if plain:
        fail(f"{what}: an op of the path took a plain version: {plain}")
    rec["training"] = {
        "steps": LM_SHARD_STEPS, "losses": losses,
        "batch": [LM_SHARD_BATCH, LM_SHARD_SEQ], "moe_impl": moe_impl,
        "step0_single_device_loss": ref_loss0,
        "step0_loss_diff": losses[0] - ref_loss0, "step0_rel_diff": rel,
        "step_ms": step_ms, "warm_step_ms": statistics.median(step_ms[1:]),
        "profiled_step_wall_ms": split[0],
        "profiled_kernels_device_ms": split[1],
        "profiled_collectives_host_ms": split[2],
        "peak_mem_gb": train_mem / 1e9}
    say(f"({tags[1]}) fit(mesh=) on LMTask(moe_impl={moe_impl!r}), "
        f"{LM_SHARD_STEPS} steps: losses {losses} (step 0 {rel:.3g} off the "
        f"single-device loss {ref_loss0:.5f}, "
        + ("a reading: capacity from the local tokens drops otherwise"
           if capacity else f"held within {LM_SHARD_LOSS_RTOL}")
        + f"); warm step {rec['training']['warm_step_ms']:.1f} ms; profiled "
        f"split (wall, kernels' device ms, collectives' host ms) {split}; "
        f"peak {train_mem / 1e9:.2f} GB a rank; launches {launched}")
    return {"record": rec, "run": run, "launches": launched, "paths": paths}


def tally_record(tally) -> dict:
    """What the dry run's tally counted over one step."""
    return {"flops": tally.flops, "collectives": tally.collectives(),
            "kernels": dict(tally.kernels)}


def lm_sharded_phase(torch) -> dict:
    """Phase 3j: spawn SHARDS ranks of the sharded LM stack; returns rank
    0's record."""
    return spawn_ranks(torch, lm_sharded_rank, LM_SHARD_DEADLINE_S,
                       "lm_sharded")



# -- phase 3k: the dry run on fake ranks, held to 3j; the examples ----------
# the production cells of the reference's dry-run test, and its MoE cell
DRYRUN_CELLS = (("stablelm-1.6b", "decode_32k", "single"),
                ("rwkv6-3b", "long_500k", "multi"),
                ("qwen3-moe-30b-a3b", "train_4k", "single"))
DRYRUN_DEADLINE_S = 300            # the 3j comparison; each cell
# the ten examples at small settings: (script, arguments, its result line,
# whether it runs a kernel on the card)
EXAMPLES = (
    ("torch_quickstart", [], r"^d\(SpMM\)/dH:", True),
    ("torch_gnn_inference", ["--dataset", "cora", "--hidden", "32",
                             "--shards", "2"], r"^served 4 models", True),
    ("torch_gnn_serving", ["--requests", "24", "--max-nodes", "512",
                           "--max-batch-nodes", "1024"],
     r"^serving contract holds", True),
    ("torch_gnn_training", ["--steps", "12", "--ckpt-every", "4"],
     r"^all training checks passed", True),
    ("torch_gnn_sampled_training", ["--steps", "30", "--nodes", "1024",
                                    "--edges", "4096"],
     r"^all sampled-pipeline checks passed", True),
    ("torch_hetero_inference", [], r"grouped vs per-type-loop parity", True),
    ("torch_lm_serving", ["--gen", "4"], r"^decode: ", False),
    ("torch_continuous_batching", [], r"^served 10 requests", False),
    ("torch_moe_training", ["--steps", "3"], r"^MoE \(cuda dispatch\) loss",
     True),
    ("torch_train_100m", ["--steps", "3"], r"^loss: ", True),
)
EXAMPLE_DEADLINE_S = 150


def opcheck_ops(torch) -> dict:
    """``torch.library.opcheck`` (schema, fake tensor) of the six kernel
    ops on the card at small shapes; returns each output's shape, dtype
    and strides."""
    from repro_torch.kernels import segment_matmul as smm
    from repro_torch.kernels.gather_segment_reduce import (OWNER_MAX_ROWS,
                                                           row_offsets)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, v, s, f = 5000, 1000, 800, 64
    few = OWNER_MAX_ROWS

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    seg = torch.sort(torch.randint(0, s, (m,), generator=gen, device=dev)
                     )[0].to(torch.int32)
    gidx = torch.randint(0, v, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    rp = row_offsets(seg, s)
    wt = torch.rand(m, generator=gen, device=dev)
    sizes = torch.tensor([400, 0, 900, 37, 1, 800, 262, 600], device=dev)
    meta = smm.group_metadata(sizes, 3000, 64)
    cases = {
        "gather_segment_reduce": (randn(v, f), gidx, seg, s, wt, "sum", rp,
                                  64),
        # the owner path (few rows) reads no row offsets
        "gather_segment_reduce owner": (randn(v, f), gidx[:few], seg[:few],
                                        s, wt[:few], "max", None, 64),
        "segment_reduce": (randn(m, f), seg, s, "sum", rp, 64),
        "segment_softmax": (randn(m, 4), seg, s, rp),
        "fused_transform_reduce": (randn(v, 32), randn(32, f), gidx, s, wt,
                                   "sum", rp, 64),
        "segment_matmul": (randn(3000, f), randn(8, f, f), *meta, 64),
        "sddmm": (randn(v, f), randn(v, f), seg, gidx),
    }
    out = {}
    for name, args in cases.items():
        op = getattr(torch.ops.repro_torch, name.split()[0]).default
        try:
            torch.library.opcheck(op, args, test_utils=("test_schema",
                                                         "test_faketensor"))
        except Exception as e:  # noqa: BLE001 — reported as the failure
            fail(f"opcheck of repro_torch::{name}: {e!r}")
        y = op(*args)
        out[name] = {"shape": list(y.shape), "dtype": str(y.dtype),
                     "stride": list(y.stride())}
    torch.cuda.synchronize()
    return out


def dryrun_vs_3j(torch, j: dict) -> dict:
    """3j's train and decode steps traced on a fake 2 x 2 "cuda" mesh,
    held to what 3j's rank 0 counted over the same steps."""
    import numpy as np

    from repro_torch import configs as lm_configs
    from repro_torch.data.tokens import TokenDatasetConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import TokenProvider
    full = lm_configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_SHARD_LAYERS)
    # 3j's batch fields and dtypes, and its trainer's step configuration
    batch = TokenProvider(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_SHARD_SEQ,
        global_batch=LM_SHARD_BATCH)).batch(0)
    specs = {k: torch.empty(np.shape(a), device="meta",
                            dtype=torch.as_tensor(a).dtype)
             for k, a in batch.items()}
    ts = steplib.TrainStepConfig(
        opt=adamw.AdamWConfig(lr=1e-4), warmup_steps=1,
        total_steps=LM_SHARD_STEPS, remat_policy="none",
        moe_impl="capacity")
    dev = torch.device("cuda")
    with dryrun.fake_world(SHARDS):
        mesh = make_host_mesh(2, 2, device_type="cuda")
        plan = shd.ParallelPlan.for_mesh(mesh)
        t0 = time.perf_counter()
        train, local = dryrun.trace_step("train", cfg, mesh, plan, specs, dev,
                                         train_config=ts)
        t1 = time.perf_counter()
        dec, _ = dryrun.trace_step(
            "decode", cfg, mesh, plan,
            {"tokens": torch.empty((LM_SHARD_BATCH, 1), dtype=torch.int64,
                                   device="meta")},
            dev, batch=LM_SHARD_BATCH, max_len=16)
        t2 = time.perf_counter()
    got_bytes = local["param"] + local["opt"]
    want_bytes = j["training"]["local_param_and_moment_bytes"]
    if got_bytes != want_bytes:
        fail(f"3k: the dry run's parameter and moment bytes a rank "
             f"{got_bytes} != 3j's {want_bytes}")
    rows = {}
    for what, fake, real in (("train", train, j["tally_train"]),
                             ("decode", dec, j["tally_decode"])):
        if fake.flops != real["flops"]:
            fail(f"3k: the dry run's {what} FLOPs {fake.flops} != 3j's "
                 f"{real['flops']}")
        if fake.collectives() != real["collectives"]:
            fail(f"3k: the dry run's {what} collectives "
                 f"{fake.collectives()} != 3j's {real['collectives']}")
        rows[what] = {"flops": fake.flops, "collectives": fake.collectives(),
                      "kernels": dict(fake.kernels),
                      "kernels_3j": real["kernels"]}
    peak = train.memory()
    real_peak = j["tally_train"]["max_memory_allocated"]
    ratio = peak["peak_bytes"] / real_peak
    if not 0.5 <= ratio <= 2.0:
        fail(f"3k: the dry run's peak {peak['peak_bytes']} B a rank is "
             f"{ratio:.3f}x 3j's max_memory_allocated {real_peak} B "
             f"(outside 0.5-2x)")
    return {"mesh": "2x2 (data, model), fake \"cuda\"",
            "layers": cfg.num_layers,
            "param_and_moment_bytes": got_bytes, "match_3j": True,
            "steps": rows, "peak": peak, "max_memory_allocated_3j": real_peak,
            "peak_over_3j": ratio, "trace_train_s": t1 - t0,
            "trace_decode_s": t2 - t1}


def dryrun_proc(j_path: str, out: str) -> None:
    """Phase 3k's own process (spawned): opcheck, then the dry run held to
    3j; writes its record to ``out``."""
    import torch
    torch.cuda.set_device(0)
    rec = {"opcheck": opcheck_ops(torch)}
    print(f"  [3k] opcheck (schema, fake tensor) of the six kernel ops: "
          f"{rec['opcheck']}", flush=True)
    rec["vs_3j"] = dryrun_vs_3j(torch, json.loads(Path(j_path).read_text()))
    v = rec["vs_3j"]
    print(f"  [3k] dry run of 3j's steps on a fake 2x2 cuda mesh: parameter "
          f"and moment bytes a rank {v['param_and_moment_bytes']} (= 3j's), "
          f"FLOPs and collectives by kind = 3j's rank 0: "
          f"{json.dumps(v['steps'])}; predicted peak "
          f"{v['peak']['peak_bytes'] / 1e9:.3f} GB a rank "
          f"({v['peak']['at_peak']}) vs 3j's max_memory_allocated "
          f"{v['max_memory_allocated_3j'] / 1e9:.3f} GB: "
          f"{v['peak_over_3j']:.3f}x; traced in {v['trace_train_s']:.1f} s "
          f"(train), {v['trace_decode_s']:.1f} s (decode)", flush=True)
    Path(out).write_text(json.dumps(rec))


def run_examples(env) -> list:
    """Each example on the card as a subprocess with its deadline."""
    rows = []
    for name, args, result, kernels in EXAMPLES:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "examples" / f"{name}.py"),
                 *args], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=EXAMPLE_DEADLINE_S)
        except subprocess.TimeoutExpired:
            fail(f"3k: example {name} ran past its {EXAMPLE_DEADLINE_S} s "
                 f"deadline")
        secs = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        if proc.returncode != 0:
            fail(f"3k: example {name} exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        hit = [ln for ln in lines if re.search(result, ln)]
        counts = [json.loads(ln.split(":", 1)[1]) for ln in lines
                  if ln.startswith("kernel launches:")]
        if not hit or not counts:
            fail(f"3k: example {name} printed no result line ({result!r}) "
                 f"or no kernel launches: {proc.stdout[-2000:]}")
        if kernels and not sum(counts[-1].values()):
            fail(f"3k: example {name} launched no kernel on the card: "
                 f"{counts[-1]}")
        rows.append({"example": name, "args": args, "result": hit[-1],
                     "launches": counts[-1], "seconds": secs})
        print(f"  [3k] examples/{name}.py {' '.join(args)}: exit 0 in "
              f"{secs:.1f} s; {hit[-1].strip()}; launches {counts[-1]}",
              flush=True)
    return rows


def dryrun_phase(torch, j_rec: dict) -> dict:
    """Phase 3k: the production cells as ``repro_torch.launch.dryrun``
    processes, all started together with the process that holds the dry
    run to 3j; meanwhile the ten examples one after another; every
    process stopped on the way out."""
    import multiprocessing
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [q for q in [os.environ.get("PYTHONPATH")]
                               if q]))
    j_path = os.path.join(tmp, "3j.json")
    Path(j_path).write_text(json.dumps(j_rec))
    cells, procs = [], []
    try:
        for arch, shape, mesh in DRYRUN_CELLS:
            out = os.path.join(tmp, f"{arch}__{shape}__{mesh}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", out]
            log = open(os.path.join(tmp, f"{arch}.log"), "w")
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                          stdout=log, stderr=log))
            cells.append((arch, shape, mesh, out, log))
        t0 = time.monotonic()
        ctx = multiprocessing.get_context("spawn")
        vs = ctx.Process(target=dryrun_proc,
                         args=(j_path, os.path.join(tmp, "3k.json")))
        vs.start()
        examples = run_examples(env)
        vs.join(max(1.0, DRYRUN_DEADLINE_S - (time.monotonic() - t0)))
        if vs.exitcode != 0:
            fail(f"3k: the dry run held to 3j exited {vs.exitcode} (None: "
                 f"killed at the {DRYRUN_DEADLINE_S} s deadline)")
        rec = json.loads(Path(tmp, "3k.json").read_text())
        rec["examples"] = examples
        rec["cells"] = []
        for (arch, shape, mesh, out, log), proc in zip(cells, procs):
            try:
                proc.wait(max(1.0, DRYRUN_DEADLINE_S
                              - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"3k: dry run {arch} x {shape} x {mesh} ran past "
                     f"{DRYRUN_DEADLINE_S} s")
            log.close()
            if proc.returncode != 0:
                fail(f"3k: dry run {arch} x {shape} x {mesh} exited "
                     f"{proc.returncode}: "
                     f"{Path(log.name).read_text()[-3000:]}")
            res = json.loads(Path(out).read_text())
            if res.get("status") != "ok" or not res["flops"] > 0 or \
                    not res["collectives"]["total_bytes"] > 0:
                fail(f"3k: dry run {arch} x {shape} x {mesh}: {res}")
            rec["cells"].append(res)
            mem = res["memory"]
            print(f"  [3k] dry run {arch} x {shape} x {mesh} ({res['layers']}"
                  f" layers, {res['world']} fake cuda ranks): ok; a device "
                  f"holds {res['param_bytes_per_device'] / 1e9:.3f} GB of "
                  f"parameters, "
                  f"{res.get('opt_bytes_per_device', 0) / 1e9:.3f} GB of "
                  f"moments, {res.get('cache_bytes_per_device', 0) / 1e9:.3f}"
                  f" GB of cache; peak {mem['peak_bytes'] / 1e9:.3f} GB "
                  f"({mem['at_peak']}), fits {mem['device_bytes'] / 1e9:.1f}"
                  f" GB: {mem['fits']}; FLOPs {res['flops']:.4e}; "
                  f"collectives {res['collectives']}; kernels "
                  f"{res['kernels']}; traced in {res['trace_s']} s",
                  flush=True)
        return rec
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for *_, log in cells:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device; this script runs the port on the card")
    try:
        import repro_torch as rt
        from repro_torch.core.config_space import KernelConfig, default_config
        from repro_torch.core.plan import make_plan
        from repro_torch.data.graphs import dataset, synth_typed_graph
        from repro_torch.kernels import _build
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.sddmm import sddmm_launch
        from repro_torch.kernels.segment_softmax import RUN_ROWS
        from repro_torch.models import gnn
        from repro_torch.serve import GNNServer, pad_to_bucket
        from repro_torch.serve.plan_cache import BucketEntry
    except ImportError as e:
        fail(f"repro_torch is not importable next to this script ({e})")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card and build ----------------------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    for name, instance in _build.units():
        _build.load(name, instance)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.KERNELS)} "
          f"kernels in {len(_build.units())} libraries (sm_90a; the run "
          f"lengths and tiles one a value)", flush=True)

    # -- 2. kernels against their plain versions ------------------------------
    t_phase = time.perf_counter()
    g = dataset("ogbn-arxiv", feat=FEAT, seed=SEED)
    padded, bucket = pad_to_bucket(g)
    v, e = bucket.num_nodes, bucket.num_edges
    config = default_config(HIDDEN)
    src = torch.from_numpy(padded.edge_index[0]).to(dev)
    dst = torch.from_numpy(padded.edge_index[1]).to(dev)
    plan = BucketEntry(bucket, HIDDEN, config).stamp(dst)
    e_real = g.num_edges
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wts = torch.rand(e, generator=gen, device=dev)
    print(f"kernel shapes: bucket {bucket} (real V={g.num_nodes}, "
          f"E={e_real}), config {config}", flush=True)

    def run(fn, plain, what, dtype, upcast_plain):
        got = fn()
        torch.cuda.synchronize()
        err = compare(torch, what, got, upcast_plain(), dtype)
        k_ms, p_ms = time_ms(torch, fn), time_ms(torch, plain)
        print(f"  {what}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f}", flush=True)
        return err, k_ms, p_ms

    results = {}
    for feat in (FEAT, HIDDEN):
        h32 = torch.randn(v, feat, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            h = h32.to(dtype)
            for reduce in ("sum", "mean", "max"):
                for weighted in (False, True):
                    w = wts.to(dtype) if weighted else None
                    what = (f"gather_segment_reduce {reduce}"
                            f"{' weighted' if weighted else ''} F={feat} "
                            f"{str(dtype)[6:]}")
                    res = run(
                        lambda: kops.gather_segment_reduce(
                            h, src, dst, v, w, reduce, plan=plan, impl="cuda"),
                        lambda: kops.gather_segment_reduce(
                            h, src, dst, v, w, reduce, impl="ref"),
                        what, dtype,
                        lambda: kops.gather_segment_reduce(
                            h.float(), src, dst, v,
                            None if w is None else w.float(), reduce,
                            impl="ref"))
                    results[(feat, dtype, reduce, weighted)] = res

    h64 = torch.randn(v, HIDDEN, generator=gen, device=dev)
    deterministic(torch, f"gather_segment_reduce weighted sum F={HIDDEN} "
                  "float32", lambda: kops.gather_segment_reduce(
                      h64, src, dst, v, wts, "sum", plan=plan, impl="cuda"))
    # the generic rows keep the old paths: the gather's runs at the arxiv
    # bucket (and, below, sddmm's runs kernel at F = 64)
    gsr_generic = took_one_path(
        torch, kops, "gather_segment_reduce", lambda: kops.gather_segment_reduce(
            h64, src, dst, v, wts, "sum", plan=plan, impl="cuda"))

    # widths that are not a multiple of the 16-byte vector
    for feat in (16, 40, 3):
        h32 = torch.randn(v, feat, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            h, w = h32.to(dtype), wts.to(dtype)
            for reduce in ("sum", "max"):
                run(lambda: kops.gather_segment_reduce(
                        h, src, dst, v, w, reduce, plan=plan, impl="cuda"),
                    lambda: kops.gather_segment_reduce(
                        h, src, dst, v, w, reduce, impl="ref"),
                    f"gather_segment_reduce {reduce} weighted F={feat} "
                    f"{str(dtype)[6:]}", dtype,
                    lambda: kops.gather_segment_reduce(
                        h.float(), src, dst, v, w.float(), reduce,
                        impl="ref"))

    # a hub: one segment of 150,000 rows amid 400,000 rows into short ones
    hub_s = 50_000
    hub_dst = torch.cat([
        torch.randint(0, hub_s, (400_000,), generator=gen, device=dev),
        torch.full((150_000,), hub_s // 2, device=dev)]).sort().values.int()
    hub_src = torch.randint(0, hub_s, (hub_dst.numel(),), generator=gen,
                            device=dev).int()
    hub_w = torch.rand(hub_dst.numel(), generator=gen, device=dev)
    hub_plan = make_plan(hub_dst, hub_s, feat=HIDDEN, device=dev)
    hub_h32 = torch.randn(hub_s, HIDDEN, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        h, w = hub_h32.to(dtype), hub_w.to(dtype)
        for reduce in ("sum", "mean", "max"):
            fn = (lambda: kops.gather_segment_reduce(
                h, hub_src, hub_dst, hub_s, w, reduce, plan=hub_plan,
                impl="cuda"))
            run(fn, lambda: kops.gather_segment_reduce(
                    h, hub_src, hub_dst, hub_s, w, reduce, impl="ref"),
                f"gather_segment_reduce {reduce} weighted F={HIDDEN} hub of "
                f"150000 rows {str(dtype)[6:]}", dtype,
                lambda: kops.gather_segment_reduce(
                    h.float(), hub_src, hub_dst, hub_s, w.float(), reduce,
                    impl="ref"))
            deterministic(torch, f"gather_segment_reduce {reduce} hub "
                          f"{str(dtype)[6:]}", fn)
    hub_x32 = torch.randn(hub_dst.numel(), HIDDEN, generator=gen, device=dev)
    hub_l32 = torch.randn(hub_dst.numel(), 4, generator=gen, device=dev) * 5
    for dtype in (torch.float32, torch.bfloat16):
        x = hub_x32.to(dtype)
        for reduce in ("sum", "mean", "max"):
            fn = (lambda: kops.segment_reduce(x, hub_dst, hub_s, reduce,
                                              plan=hub_plan, impl="cuda"))
            run(fn, lambda: kops.segment_reduce(x, hub_dst, hub_s, reduce,
                                                impl="ref"),
                f"segment_reduce {reduce} F={HIDDEN} hub of 150000 rows "
                f"{str(dtype)[6:]}", dtype,
                lambda: kops.segment_reduce(x.float(), hub_dst, hub_s, reduce,
                                            impl="ref"))
            deterministic(torch, f"segment_reduce {reduce} hub "
                          f"{str(dtype)[6:]}", fn)
        xl = hub_l32.to(dtype)
        fn = (lambda: kops.segment_softmax(xl, hub_dst, hub_s, plan=hub_plan,
                                           impl="cuda"))
        run(fn, lambda: kops.segment_softmax(xl, hub_dst, hub_s, impl="ref"),
            f"segment_softmax heads=4 hub of 150000 rows {str(dtype)[6:]}",
            dtype, lambda: kops.segment_softmax(xl.float(), hub_dst, hub_s,
                                                impl="ref"))
        deterministic(torch, f"segment_softmax heads=4 hub {str(dtype)[6:]}",
                      fn)
    # the fused kernel: the hub's 150,000 rows lie in one tile of segments
    hub_hf32 = torch.randn(hub_s, FEAT, generator=gen, device=dev)
    hub_wm32 = torch.randn(FEAT, HIDDEN, generator=gen, device=dev) / FEAT ** 0.5
    for dtype in (torch.float32, torch.bfloat16):
        h, wm, w = hub_hf32.to(dtype), hub_wm32.to(dtype), hub_w.to(dtype)
        fn = (lambda: kops.fused_transform_reduce(
            h, wm, hub_src, hub_dst, hub_s, w, "sum", plan=hub_plan,
            impl="cuda"))
        results[("fused hub", dtype)] = run(
            fn, lambda: kops.fused_transform_reduce(
                h, wm, hub_src, hub_dst, hub_s, w, "sum", impl="ref"),
            f"fused_transform_reduce sum weighted {FEAT}->{HIDDEN} hub of "
            f"150000 rows {str(dtype)[6:]}", dtype,
            lambda: kops.fused_transform_reduce(
                h.float(), wm.float(), hub_src, hub_dst, hub_s, w.float(),
                "sum", impl="ref"))
        deterministic(torch, f"fused_transform_reduce hub {str(dtype)[6:]}",
                      fn)
    # its bound: the gather index and weight of every row, the plan's
    # int64 row offsets (read whole), the distinct rows of H, W, the output
    # written once
    results["fused hub bound"] = bound(
        hub_dst.numel() * 8 + (hub_s + 1) * 8
        + int(torch.unique(hub_src).numel()) * FEAT * 4
        + FEAT * HIDDEN * 4 + hub_s * HIDDEN * 4,
        2 * hub_dst.numel() * FEAT + 2 * hub_s * FEAT * HIDDEN)
    del hub_dst, hub_src, hub_w, hub_plan, hub_h32, hub_x32, hub_l32
    del hub_hf32, hub_wm32

    heads = 4
    logits32 = torch.randn(e, heads, generator=gen, device=dev) * 5
    for dtype in (torch.float32, torch.bfloat16):
        x = logits32.to(dtype)
        results[("softmax", dtype)] = run(
            lambda: kops.segment_softmax(x, dst, v, plan=plan, impl="cuda"),
            lambda: kops.segment_softmax(x, dst, v, impl="ref"),
            f"segment_softmax heads={heads} {str(dtype)[6:]}", dtype,
            lambda: kops.segment_softmax(x.float(), dst, v, impl="ref"))
    x1 = logits32[:, 0].contiguous()
    run(lambda: kops.segment_softmax(x1, dst, v, plan=plan, impl="cuda"),
        lambda: kops.segment_softmax(x1, dst, v, impl="ref"),
        "segment_softmax (E,) float32", torch.float32,
        lambda: kops.segment_softmax(x1, dst, v, impl="ref"))
    dropped = dst >= v
    for xs in (logits32, logits32.bfloat16(), x1):
        got = kops.segment_softmax(xs, dst, v, plan=plan, impl="cuda")
        if not bool((got[dropped] == 0).all()):
            fail(f"segment_softmax {tuple(xs.shape)} {xs.dtype}: the "
                 f"{int(dropped.sum())} padded rows are not exactly 0")
    print(f"  segment_softmax: the {int(dropped.sum())} padded rows are "
          "exactly 0", flush=True)
    deterministic(torch, f"segment_softmax heads={heads} float32",
                  lambda: kops.segment_softmax(logits32, dst, v, plan=plan,
                                               impl="cuda"))
    # a segment whose logits are all -inf: the plain version's rule (a max
    # that is not finite counts as 0) makes its rows 0, not NaN; the
    # largest segment spans many runs, a short one lies inside one
    counts = torch.bincount(dst[:e_real].long(), minlength=v)
    inf_segs = (int(counts.argmax()), int(dst[e_real // 2]))
    x_inf = logits32.clone()
    for sid in inf_segs:
        x_inf[dst == sid] = float("-inf")
    got = kops.segment_softmax(x_inf, dst, v, plan=plan, impl="cuda")
    compare(torch, "segment_softmax with all--inf segments", got,
            kops.segment_softmax(x_inf, dst, v, impl="ref"), torch.float32)
    for sid in inf_segs:
        if not bool((got[dst == sid] == 0).all()):
            fail(f"segment_softmax: the all--inf segment {sid} "
                 f"({int(counts[sid])} rows) is not 0")
    print(f"  segment_softmax: all--inf segments of {int(counts[inf_segs[0]])}"
          f" and {int(counts[inf_segs[1]])} rows come out 0", flush=True)
    print("  segment_softmax: %d of %d rows lie in segments that runs of %d "
          "rows cut" % (*cut_rows(plan.row_ptr, RUN_ROWS), RUN_ROWS),
          flush=True)
    del x_inf, got

    for d_in, d_out in ((FEAT, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, CLASSES)):
        h32 = torch.randn(v, d_in, generator=gen, device=dev)
        wm32 = torch.randn(d_in, d_out, generator=gen, device=dev) / d_in ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            h, wm = h32.to(dtype), wm32.to(dtype)
            for reduce, weighted in (("sum", True), ("mean", False)):
                w = wts.to(dtype) if weighted else None
                results[("fused", d_in, d_out, dtype, reduce)] = run(
                    lambda: kops.fused_transform_reduce(
                        h, wm, src, dst, v, w, reduce, plan=plan, impl="cuda"),
                    lambda: kops.fused_transform_reduce(
                        h, wm, src, dst, v, w, reduce, impl="ref"),
                    f"fused_transform_reduce {reduce}"
                    f"{' weighted' if weighted else ''} {d_in}->{d_out} "
                    f"{str(dtype)[6:]}", dtype,
                    lambda: kops.fused_transform_reduce(
                        h.float(), wm.float(), src, dst, v,
                        None if w is None else w.float(), reduce, impl="ref"))

    h_det = torch.randn(v, FEAT, generator=gen, device=dev)
    w_det = torch.randn(FEAT, HIDDEN, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        hd, wd, wtd = h_det.to(dtype), w_det.to(dtype), wts.to(dtype)
        deterministic(torch, f"fused_transform_reduce weighted sum "
                      f"{FEAT}->{HIDDEN} {str(dtype)[6:]}",
                      lambda: kops.fused_transform_reduce(
                          hd, wd, src, dst, v, wtd, "sum", plan=plan,
                          impl="cuda"))
    del h_det, w_det

    # gcn's reddit2 request as served: the largest fused launch of the
    # serving path (its first layer, weighted sum 32->64 fp32 at the bucket)
    r2 = dataset("reddit2", feat=FEAT, seed=SEED)
    r2_pad, r2_bucket = pad_to_bucket(r2)
    r2_v = r2_bucket.num_nodes
    r2_src = torch.from_numpy(r2_pad.edge_index[0]).to(dev)
    r2_dst = torch.from_numpy(r2_pad.edge_index[1]).to(dev)
    r2_plan = BucketEntry(r2_bucket, HIDDEN, config).stamp(r2_dst)
    r2_w = torch.rand(r2_dst.numel(), generator=gen, device=dev)
    r2_h = torch.randn(r2_v, FEAT, generator=gen, device=dev)
    r2_wm = torch.randn(FEAT, HIDDEN, generator=gen, device=dev) / FEAT ** 0.5
    results[("fused reddit2", torch.float32)] = run(
        lambda: kops.fused_transform_reduce(r2_h, r2_wm, r2_src, r2_dst, r2_v,
                                            r2_w, "sum", plan=r2_plan,
                                            impl="cuda"),
        lambda: kops.fused_transform_reduce(r2_h, r2_wm, r2_src, r2_dst, r2_v,
                                            r2_w, "sum", impl="ref"),
        f"fused_transform_reduce sum weighted {FEAT}->{HIDDEN} reddit2 at "
        f"{r2_bucket} (real E={r2.num_edges}) float32", torch.float32,
        lambda: kops.fused_transform_reduce(r2_h, r2_wm, r2_src, r2_dst, r2_v,
                                            r2_w, "sum", impl="ref"))
    # every edge reads its 128-byte row of H through L2, however often the
    # row repeats: the rate those reads reach
    r2_rows_bytes = r2.num_edges * FEAT * 4
    results["fused reddit2 rows"] = (
        r2_rows_bytes, r2_rows_bytes / results[("fused reddit2",
                                                torch.float32)][1] / 1e9)
    print(f"  reddit2: {r2_rows_bytes} bytes of H rows read, one a real edge:"
          f" {results['fused reddit2 rows'][1]:.2f} TB/s", flush=True)
    results["fused reddit2 bound"] = bound(
        r2.num_edges * 8 + (r2_v + 1) * 8
        + int(torch.unique(r2_src[:r2.num_edges]).numel()) * FEAT * 4
        + FEAT * HIDDEN * 4 + r2_v * HIDDEN * 4,
        2 * r2.num_edges * FEAT + 2 * r2_v * FEAT * HIDDEN)
    del r2_pad, r2_src, r2_dst, r2_plan, r2_w, r2_h, r2_wm
    # SAGE's class rows on Reddit2, walked whole in one column tile
    results["sage class gather"] = sage_class_gather(torch, kops, dev, gen,
                                                     r2)
    # GAT's softmax and alpha-weighted sums on Reddit2 with self-loops
    results["gat aggregations"] = gat_aggregations(torch, kops, dev, gen, r2)

    # edge cases: an empty graph, and num_segments % s_b != 0 (and % the
    # fused kernel's tile) with padding rows
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    hx = torch.randn(1000, HIDDEN, generator=gen, device=dev)
    wm = torch.randn(HIDDEN, CLASSES, generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"empty graph {reduce}",
                kops.gather_segment_reduce(hx, none, none, 1000, None, reduce,
                                           impl="cuda"),
                kops.gather_segment_reduce(hx, none, none, 1000, None, reduce,
                                           impl="ref"), torch.float32)
    compare(torch, "empty graph fused",
            kops.fused_transform_reduce(hx, wm, none, none, 1000, impl="cuda"),
            torch.zeros(1000, CLASSES, device=dev), torch.float32)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"empty graph segment_reduce {reduce}",
                kops.segment_reduce(torch.zeros(0, HIDDEN, device=dev), none,
                                    1000, reduce, impl="cuda"),
                kops.segment_reduce(torch.zeros(0, HIDDEN, device=dev), none,
                                    1000, reduce, impl="ref"), torch.float32)
    compare(torch, "empty graph softmax",
            kops.segment_softmax(torch.zeros(0, 4, device=dev), none, 1000,
                                 impl="cuda"),
            torch.zeros(0, 4, device=dev), torch.float32)
    s_odd = 1001
    rng_idx = torch.randint(0, s_odd, (9000,), generator=gen, device=dev)
    d_odd = torch.cat([rng_idx.sort().values,
                       torch.full((37,), s_odd, device=dev)]).int()
    s_src = torch.randint(0, s_odd, (d_odd.numel(),), generator=gen,
                          device=dev).int()
    odd_cfg = KernelConfig("SR", 32, 64, 64, 1)
    odd_plan = make_plan(d_odd, s_odd, config=odd_cfg).to(dev)
    hx = torch.randn(s_odd, HIDDEN, generator=gen, device=dev)
    w_odd = torch.rand(d_odd.numel(), generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"S%s_b!=0 {reduce}",
                kops.gather_segment_reduce(hx, s_src, d_odd, s_odd, w_odd,
                                           reduce, plan=odd_plan, impl="cuda"),
                kops.gather_segment_reduce(hx, s_src, d_odd, s_odd, w_odd,
                                           reduce, impl="ref"), torch.float32)
    xr_odd = torch.randn(d_odd.numel(), HIDDEN, generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"S%s_b!=0 segment_reduce {reduce}",
                kops.segment_reduce(xr_odd, d_odd, s_odd, reduce,
                                    plan=odd_plan, impl="cuda"),
                kops.segment_reduce(xr_odd, d_odd, s_odd, reduce, impl="ref"),
                torch.float32)
    x_odd = torch.randn(d_odd.numel(), heads, generator=gen, device=dev)
    compare(torch, "S%s_b!=0 softmax",
            kops.segment_softmax(x_odd, d_odd, s_odd, plan=odd_plan,
                                 impl="cuda"),
            kops.segment_softmax(x_odd, d_odd, s_odd, impl="ref"),
            torch.float32)
    compare(torch, "S%T!=0 fused",
            kops.fused_transform_reduce(hx, wm, s_src, d_odd, s_odd, w_odd,
                                        "mean", plan=odd_plan, impl="cuda"),
            kops.fused_transform_reduce(hx, wm, s_src, d_odd, s_odd, w_odd,
                                        "mean", impl="ref"), torch.float32)
    torch.cuda.synchronize()
    print(f"kernel checks passed ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # library yardstick for the weighted sum: one torch.sparse.mm of a CSR
    # built from the real edges (timed only; the port never calls it)
    csr = torch.sparse_coo_tensor(
        torch.stack([dst[:e_real].long(), src[:e_real].long()]),
        wts[:e_real], (v, v)).coalesce().to_sparse_csr()
    lib_sum = torch.sparse.mm(csr, h64)
    compare(torch, "torch.sparse.mm yardstick", lib_sum,
            kops.gather_segment_reduce(h64, src, dst, v, wts, "sum",
                                       impl="ref"), torch.float32)
    library_gather_ms = time_ms(torch, lambda: torch.sparse.mm(csr, h64))
    # the fused kernel's yardstick: no single PyTorch call computes SpMM
    # then GEMM, so the pair torch.sparse.mm of the same CSR then
    # torch.matmul by W, timed together (timed only; never in the port)
    h_two = torch.randn(v, FEAT, generator=gen, device=dev)
    w_two = torch.randn(FEAT, HIDDEN, generator=gen, device=dev)
    compare(torch, "torch.sparse.mm + torch.matmul yardstick",
            torch.sparse.mm(csr, h_two) @ w_two,
            kops.fused_transform_reduce(h_two, w_two, src, dst, v, wts, "sum",
                                        impl="ref"), torch.float32)
    two_call_ms = time_ms(torch, lambda: torch.sparse.mm(csr, h_two) @ w_two)
    print(f"  torch.sparse.mm then torch.matmul {FEAT}->{HIDDEN} float32: "
          f"two_call_ms={two_call_ms:.4f}", flush=True)
    del csr, lib_sum, h_two, w_two

    # library yardstick for the softmax: one torch.sparse.softmax over dim 1
    # of a (V, E, heads) COO whose row i holds the logits of the edges into
    # node i; absent entries count as -inf (timed only; never in the port)
    x_real = logits32[:e_real]
    coo = torch.sparse_coo_tensor(
        torch.stack([dst[:e_real].long(),
                     torch.arange(e_real, device=dev)]),
        x_real, (v, e_real, heads)).coalesce()
    lib_soft = torch.sparse.softmax(coo, 1)
    if not torch.equal(lib_soft.indices(), coo.indices()):
        fail("torch.sparse.softmax yardstick reordered its entries")
    compare(torch, "torch.sparse.softmax yardstick", lib_soft.values(),
            kops.segment_softmax(x_real, dst[:e_real], v, impl="ref"),
            torch.float32)
    library_softmax_ms = time_ms(torch, lambda: torch.sparse.softmax(coo, 1))
    del coo, lib_soft
    # the gather reads each distinct source row of H once (padded edges
    # stop the walk before any load, so no padded row is read)
    h_rows = int(torch.unique(src[:e_real]).numel())

    # -- 2b. the kernels of the typed path and of the public ops ---------------
    t_phase = time.perf_counter()
    am = synth_typed_graph("am", AM_NODES, AM_EDGES,
                           num_relations=AM_RELATIONS, feat=FEAT, seed=SEED)
    print(f"AM-scale typed graph built on the host "
          f"({time.perf_counter() - t_phase:.1f} s): |V|={am.num_nodes} "
          f"|E|={am.num_edges} R={am.num_relations}, "
          f"{int((am.type_counts == 0).sum())} empty relations, largest "
          f"{int(am.type_counts.max())} rows", flush=True)
    m_typed = am.num_edges
    sizes = torch.from_numpy(am.type_counts).to(dev)
    rplan = am.make_relation_plan(feat=HIDDEN, device=dev)
    offs = rplan.offsets[1:].contiguous()          # cumulative group ends
    library_smm, smm_bounds = {}, {}
    smm_plan_bytes = rplan.offsets.numel() * 4 + rplan.first_group.numel() * 8
    for k_dim, n_dim in ((HIDDEN, HIDDEN), (FEAT, 2 * HIDDEN),
                         (HIDDEN, 2 * HIDDEN), (HIDDEN, CLASSES),
                         (HIDDEN, 2 * CLASSES)):
        x32 = torch.randn(m_typed, k_dim, generator=gen, device=dev)
        w32 = torch.randn(AM_RELATIONS, k_dim, n_dim, generator=gen,
                          device=dev) / k_dim ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            results[("smm", k_dim, n_dim, dtype)] = run(
                lambda: kops.segment_matmul(x, sizes, w, plan=rplan,
                                            impl="cuda"),
                lambda: kops.segment_matmul(x, sizes, w, impl="ref"),
                f"segment_matmul {k_dim}->{n_dim} M={m_typed} "
                f"G={AM_RELATIONS} {str(dtype)[6:]}", dtype,
                lambda: kops.segment_matmul(x.float(), sizes, w.float(),
                                            impl="ref"))
            smm_bounds[(k_dim, n_dim, dtype)] = smm_bound(
                torch, m_typed, k_dim, n_dim, AM_RELATIONS, dtype,
                smm_plan_bytes)
            if (k_dim, n_dim) == (HIDDEN, HIDDEN):
                deterministic(torch, f"segment_matmul {k_dim}->{n_dim} "
                              f"{str(dtype)[6:]}",
                              lambda: kops.segment_matmul(
                                  x, sizes, w, plan=rplan, impl="cuda"))
            if dtype == torch.bfloat16:
                # the path the rule takes here, beside today's mma_sync
                # kernel through its C entry in the same call
                from repro_torch.kernels import segment_matmul as smm_mod
                mma_ms = time_ms(torch, smm_mma_sync(torch, x, sizes, w))
                results[("smm typed bf16", k_dim, n_dim)] = {
                    "path": smm_mod.path_of(x, w), "ms":
                    results[("smm", k_dim, n_dim, dtype)][1],
                    "mma_sync_ms": mma_ms}
                print(f"  segment_matmul {k_dim}->{n_dim} bf16 took the "
                      f"{smm_mod.path_of(x, w)} path; today's mma_sync "
                      f"kernel {mma_ms:.4f} ms", flush=True)
            # yardstick: one torch._grouped_mm with the group offsets
            # (timed only)
            out, reason = library(
                f"torch._grouped_mm {k_dim}->{n_dim} {str(dtype)[6:]}",
                lambda: torch._grouped_mm(x, w, offs=offs))
            if out is not None:
                compare(torch, f"torch._grouped_mm yardstick {k_dim}->{n_dim}",
                        out, kops.segment_matmul(x.float(), sizes, w.float(),
                                                 impl="ref"), dtype)
                lib_ms = time_ms(torch, lambda: torch._grouped_mm(
                    x, w, offs=offs))
                print(f"  torch._grouped_mm {k_dim}->{n_dim} "
                      f"{str(dtype)[6:]}: library_ms={lib_ms:.4f}", flush=True)
                library_smm[(k_dim, n_dim, dtype)] = lib_ms
            else:
                library_smm[(k_dim, n_dim, dtype)] = reason
            del x, w, out
        del x32, w32

    # the gather kernel as mp_typed runs it: H = the (E, F) typed messages,
    # gathered back through the inverse type permutation, mean into nodes
    am_dst = torch.from_numpy(am.edge_index[1]).to(dev)
    am_inv = torch.from_numpy(am.inv_type_perm).to(dev)
    am_plan = am.make_plan(feat=HIDDEN, device=dev)
    msg = torch.randn(m_typed, HIDDEN, generator=gen, device=dev)
    typed_fn = (lambda: kops.gather_segment_reduce(
        msg, am_inv, am_dst, am.num_nodes, None, "mean", plan=am_plan,
        impl="cuda"))
    results["gather typed"] = run(
        lambda: kops.gather_segment_reduce(msg, am_inv, am_dst, am.num_nodes,
                                           None, "mean", plan=am_plan,
                                           impl="cuda"),
        lambda: kops.gather_segment_reduce(msg, am_inv, am_dst, am.num_nodes,
                                           None, "mean", impl="ref"),
        f"gather_segment_reduce mean F={HIDDEN} H=(E={m_typed}, F) gathered "
        f"by inv_type_perm", torch.float32,
        lambda: kops.gather_segment_reduce(msg, am_inv, am_dst, am.num_nodes,
                                           None, "mean", impl="ref"))
    deterministic(torch, "gather_segment_reduce typed mean", typed_fn)
    # its bound: gather index and segment words of every row, H read once,
    # the output written once, the plan's int64 row offsets
    print(f"bound of the typed-path gather (mean F={HIDDEN}, H=({m_typed}, "
          f"{HIDDEN}) fp32 into {am.num_nodes} rows):", flush=True)
    results["gather typed bound"] = bound(
        m_typed * 8 + m_typed * HIDDEN * 4 + am.num_nodes * HIDDEN * 4
        + (am.num_nodes + 1) * 8, m_typed * HIDDEN)
    del msg
    # the softmax as RGAT runs it: fp32 (E, heads) logits over the typed
    # rows sorted by destination, with the plan's row offsets
    am_logits = torch.randn(m_typed, RGAT_HEADS, generator=gen,
                            device=dev) * 5
    soft_fn = (lambda: kops.segment_softmax(am_logits, am_dst, am.num_nodes,
                                            plan=am_plan, impl="cuda"))
    results["softmax typed"] = run(
        soft_fn, lambda: kops.segment_softmax(am_logits, am_dst, am.num_nodes,
                                              impl="ref"),
        f"segment_softmax heads={RGAT_HEADS} E={m_typed} into "
        f"{am.num_nodes} rows (AM typed) float32", torch.float32,
        lambda: kops.segment_softmax(am_logits, am_dst, am.num_nodes,
                                     impl="ref"))
    deterministic(torch, f"segment_softmax heads={RGAT_HEADS} AM typed",
                  soft_fn)
    print("  segment_softmax AM typed: %d of %d rows lie in segments that "
          "runs of %d rows cut" % (*cut_rows(am_plan.row_ptr, RUN_ROWS),
                                   RUN_ROWS), flush=True)
    print(f"bound of the typed-path softmax (fp32 ({m_typed}, {RGAT_HEADS}) "
          f"into {am.num_nodes} rows):", flush=True)
    # (its segment ids and logits read once, its output written once)
    results["softmax typed bound"] = bound(
        m_typed * (4 + 2 * RGAT_HEADS * 4), 4 * m_typed * RGAT_HEADS)
    del am_logits

    # edge cases: empty groups, a single group, rows past the groups, groups
    # of 1-3 rows (every 128-row tile overlaps some 60 groups), N = 16 and
    # 32, K deeper than one pass of shared memory holds, and the MoE expert
    # products of phase 3h (K = 2048 -> N = 768 and 768 -> 2048: chunked K
    # with several column tiles) over 128 groups of 0-3 rows with rows past
    # the groups
    tiny = torch.randint(1, 4, (3000,), generator=gen, device=dev).tolist()
    moe_groups = torch.randint(0, 4, (128,), generator=gen,
                               device=dev).tolist()
    for label, gs, pad, k_e, n_e in (
            ("empty groups", [0, 300, 0, 0, 77, 0, 1000, 0], 0, HIDDEN,
             2 * HIDDEN),
            ("single group", [4096], 0, HIDDEN, 2 * HIDDEN),
            ("rows past the groups", [0, 513, 64, 0, 3], 200, HIDDEN,
             2 * HIDDEN),
            ("no rows in any group", [0, 0, 0], 129, HIDDEN, 2 * HIDDEN),
            ("groups of 1-3 rows", tiny, 77, HIDDEN, HIDDEN),
            ("N=16, rows past the groups", [0, 513, 64, 0, 3000], 70,
             HIDDEN, CLASSES),
            ("N=32, empty groups", [0, 900, 0, 0, 4000, 0], 0, HIDDEN,
             2 * CLASSES),
            ("K=512, N=128", [0, 3000, 700, 0, 5000], 33, 512, 2 * HIDDEN),
            ("K=1001, N=40", [1200, 0, 900, 1], 5, 1001, 40),
            ("K=1024, N=16", [2000, 77, 0, 4000], 0, 1024, CLASSES),
            ("MoE K=2048, N=768, 128 groups of 0-3 rows", moe_groups, 45,
             2048, 768),
            ("MoE K=768, N=2048, 128 groups of 0-3 rows", moe_groups, 45,
             768, 2048)):
        gs_t = torch.tensor(gs, dtype=torch.int32, device=dev)
        m_e = sum(gs) + pad
        xe32 = torch.randn(m_e, k_e, generator=gen, device=dev)
        we32 = torch.randn(len(gs), k_e, n_e, generator=gen,
                           device=dev) / k_e ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            xe, we = xe32.to(dtype), we32.to(dtype)
            got = kops.segment_matmul(xe, gs_t, we, impl="cuda")
            compare(torch, f"segment_matmul {label} {str(dtype)[6:]}", got,
                    kops.segment_matmul(xe.float(), gs_t, we.float(),
                                        impl="ref"), dtype)
            if pad and not bool((got[m_e - pad:] == 0).all()):
                fail(f"segment_matmul {label}: rows past the groups are "
                     "not 0")

    # segment_reduce on the ogbn-arxiv destinations (unpadded), and sddmm on
    # its (dst, src) pairs
    a_src = torch.from_numpy(g.edge_index[0]).to(dev)
    a_dst = torch.from_numpy(g.edge_index[1]).to(dev)
    a_v, a_e = g.num_nodes, g.num_edges
    for feat in (FEAT, HIDDEN):
        a_plan = make_plan(a_dst, a_v, feat=feat, device=dev)
        x32 = torch.randn(a_e, feat, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for reduce in ("sum", "mean", "max"):
                results[("srd", feat, dtype, reduce)] = run(
                    lambda: kops.segment_reduce(x, a_dst, a_v, reduce,
                                                plan=a_plan, impl="cuda"),
                    lambda: kops.segment_reduce(x, a_dst, a_v, reduce,
                                                impl="ref"),
                    f"segment_reduce {reduce} F={feat} M={a_e} S={a_v} "
                    f"{str(dtype)[6:]}", dtype,
                    lambda: kops.segment_reduce(x.float(), a_dst, a_v, reduce,
                                                impl="ref"))
    for reduce in ("sum", "mean", "max"):
        deterministic(torch, f"segment_reduce {reduce} F={HIDDEN} float32",
                      lambda: kops.segment_reduce(x32, a_dst, a_v, reduce,
                                                  plan=a_plan, impl="cuda"))
    # yardsticks: torch.segment_reduce with per-segment lengths, F=64 fp32,
    # each reduce; initial=0 gives an empty mean 0, as the port does
    # (timed only)
    lengths = torch.bincount(a_dst.long(), minlength=a_v)
    library_srd = {}
    for reduce in ("sum", "mean", "max"):
        kw = {"initial": 0.0} if reduce == "mean" else {}
        compare(torch, f"torch.segment_reduce {reduce} yardstick",
                torch.segment_reduce(x32, reduce, lengths=lengths, **kw),
                kops.segment_reduce(x32, a_dst, a_v, reduce, impl="ref"),
                torch.float32)
        library_srd[reduce] = time_ms(torch, lambda: torch.segment_reduce(
            x32, reduce, lengths=lengths, **kw))
        print(f"  torch.segment_reduce {reduce} F={HIDDEN} float32: "
              f"library_ms={library_srd[reduce]:.4f}", flush=True)
    del x32, x

    # sddmm on arxiv's dst-sorted (dst, src) pairs, whose runs share A
    # rows, and on the same pairs shuffled, where no row repeats in order;
    # F = 64 and widths off the 16-byte vector (40, 3)
    sd_a32 = torch.randn(a_v, HIDDEN, generator=gen, device=dev)
    sd_b32 = torch.randn(a_v, HIDDEN, generator=gen, device=dev)
    perm = torch.randperm(a_e, generator=gen, device=dev)
    pairs = {"dst-sorted": (a_dst, a_src),
             "shuffled": (a_dst[perm].contiguous(), a_src[perm].contiguous())}
    for feat in (HIDDEN, 40, 3):
        fa = sd_a32 if feat == HIDDEN else torch.randn(
            a_v, feat, generator=gen, device=dev)
        fb = sd_b32 if feat == HIDDEN else torch.randn(
            a_v, feat, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            sa, sb = fa.to(dtype), fb.to(dtype)
            for order, (rows, cols) in pairs.items():
                results[("sddmm", feat, dtype, order)] = run(
                    lambda: sddmm_launch(sa, sb, rows, cols),
                    lambda: kops.sddmm(sa, sb, rows, cols, impl="ref"),
                    f"sddmm F={feat} M={a_e} pairs (dst, src) {order} "
                    f"{str(dtype)[6:]}", dtype,
                    lambda: kops.sddmm(sa.float(), sb.float(), rows, cols,
                                       impl="ref"))
    deterministic(torch, f"sddmm F={HIDDEN} float32",
                  lambda: sddmm_launch(sd_a32, sd_b32, a_dst, a_src))
    generic_paths = (gsr_generic, took_one_path(
        torch, kops, "sddmm", lambda: sddmm_launch(sd_a32, sd_b32, a_dst,
                                                   a_src)))
    if generic_paths != ("runs", "runs"):
        fail(f"the generic rows took the paths {generic_paths} (gather, "
             "sddmm), expected the runs paths")
    # every pair reads its row of B (src, random over the nodes) in full
    sd_b_bytes = a_e * HIDDEN * 4
    print(f"  sddmm F={HIDDEN} float32 dst-sorted: {sd_b_bytes} bytes of B "
          f"rows read, one a pair: {sd_b_bytes / results[('sddmm', HIDDEN, torch.float32, 'dst-sorted')][1] / 1e9:.2f}"
          " TB/s", flush=True)
    del pairs, perm, fa, fb, sa, sb
    compare(torch, "sddmm through its checked wrapper",
            kops.sddmm(sd_a32, sd_b32, a_dst, a_src, impl="cuda"),
            kops.sddmm(sd_a32, sd_b32, a_dst, a_src, impl="ref"),
            torch.float32)
    # yardstick: torch.sparse.sampled_addmm on the CSR of the (dst, src)
    # pattern; coalescing merges duplicate pairs, so it computes each
    # distinct pair once (timed only)
    mask = torch.sparse_coo_tensor(
        torch.stack([a_dst.long(), a_src.long()]),
        torch.ones(a_e, device=dev), (a_v, a_v)).coalesce().to_sparse_csr()
    sd_pairs = int(mask.values().numel())
    lib, reason = library("torch.sparse.sampled_addmm",
                          lambda: torch.sparse.sampled_addmm(
                              mask, sd_a32, sd_b32.t(), beta=0.0))
    if lib is not None:
        rows = torch.repeat_interleave(
            torch.arange(a_v, device=dev), mask.crow_indices().diff())
        compare(torch, "torch.sparse.sampled_addmm yardstick", lib.values(),
                kops.sddmm(sd_a32, sd_b32, rows, mask.col_indices(),
                           impl="ref"), torch.float32)
        library_sddmm = time_ms(torch, lambda: torch.sparse.sampled_addmm(
            mask, sd_a32, sd_b32.t(), beta=0.0))
        print(f"  torch.sparse.sampled_addmm ({sd_pairs} distinct pairs of "
              f"{a_e}): library_ms={library_sddmm:.4f}", flush=True)
        del rows
    else:
        library_sddmm = reason
    del mask, lib
    sd_rows = (int(torch.unique(a_dst).numel())
               + int(torch.unique(a_src).numel()))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"typed-path and op kernel checks passed "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # -- 2c. the backwards -------------------------------------------------------
    t_phase = time.perf_counter()
    roles = backward_phase(torch, rt, kops, dev, gen, padded, v, e_real, wts,
                           a_src, a_dst, a_v, am, sizes, rplan, offs)
    # the weight gradient of a weighted aggregation is the sddmm of phase 2b
    # on the same (dst, src) pairs at F=64
    sd_res = results[("sddmm", HIDDEN, torch.float32, "dst-sorted")]
    roles.append({"role": f"dw of a weighted aggregation: sddmm on arxiv's "
                  f"(dst, src) pairs F={HIDDEN} fp32 (as timed in 2b)",
                  "kernel": "sddmm", "max_abs_err": sd_res[0],
                  "ms": sd_res[1], "plain_ms": sd_res[2], "bound_ms": None,
                  "bound_by": "bytes", "library_ms": (
                      library_sddmm if isinstance(library_sddmm, float)
                      else None),
                  "library": "torch.sparse.sampled_addmm"})
    print(f"backward checks passed ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # -- 3. serving: the main path --------------------------------------------
    t_phase = time.perf_counter()
    graphs = {name: dataset(name, feat=FEAT, seed=SEED)
              for name in ("ogbn-arxiv", "cora", "citeseer", "pubmed")}
    graphs["reddit2"] = r2
    print(f"graphs built on the host ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    def plain_forward(model, gr):
        with torch.inference_mode():
            return model(torch.from_numpy(gr.x).to(dev),
                         torch.from_numpy(gr.edge_index).to(dev),
                         gr.num_nodes,
                         torch.from_numpy(gr.deg_inv_sqrt).to(dev),
                         impl="ref").float().cpu()

    path_kernels = {"gcn": ["fused_transform_reduce"],
                    "gin": ["gather_segment_reduce"],
                    "sage": ["fused_transform_reduce"],
                    "gat": ["segment_softmax", "gather_segment_reduce"]}
    serving = []
    kops.reset_launch_counts()
    for family in gnn.MODELS:
        before = kops.launch_counts()
        model = gnn.init(family, FEAT, HIDDEN, CLASSES,
                         heads=4 if family == "gat" else 1, seed=SEED)
        srv = GNNServer(model, family, max_batch_nodes=1 << 22,
                        max_batch_graphs=8)
        steps = [["ogbn-arxiv"], ["ogbn-arxiv"], ["cora", "citeseer", "pubmed"]]
        if family == "gcn":
            steps.append(["reddit2"])
        for names in steps:
            for name in names:
                srv.submit(graphs[name])
            served = srv.step(flush=True)
            if len(served) != len(names):
                fail(f"{family}: served {len(served)} of {len(names)}")
            for name, res in zip(names, served):
                gr = graphs[name]
                if res.logits.shape != (gr.num_nodes, CLASSES):
                    fail(f"{family} {name}: logits {res.logits.shape}")
                want = plain_forward(srv.model, gr)
                err = compare(torch, f"served {family} {name}",
                              torch.from_numpy(res.logits), want,
                              torch.float32)
                serving.append({"family": family, "graph": name,
                                "batch": "+".join(names),
                                "serve_ms": round(res.serve_s * 1e3, 3),
                                "cache_hit": res.cache_hit,
                                "max_abs_err": err})
                print(f"  served {family} {name} in batch {'+'.join(names)}: "
                      f"serve_ms={res.serve_s * 1e3:.3f} "
                      f"cache_hit={res.cache_hit} max_abs_err={err:.3g} "
                      f"launched={sorted(res.fusion)}", flush=True)
        after = kops.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        print(f"  {family} launches: {launched}", flush=True)
        print(f"  {family} bucket configs (generated rules): "
              + ", ".join(f"{ent.bucket}: m_b={ent.config.m_b} "
                          f"s_b={ent.config.s_b}"
                          for _, ent in srv.cache.entries()), flush=True)
        for k in path_kernels[family]:
            if launched[k] == 0:
                fail(f"{family}: kernel {k} of its path was never launched")
        del srv, model
    launches_serving = kops.launch_counts()
    print(f"serving passed ({time.perf_counter() - t_phase:.1f} s); "
          f"launches on the serving path: {launches_serving}", flush=True)

    # -- 3b. typed inference: rgcn and rgat on the AM-scale typed graph --------
    t_phase = time.perf_counter()
    am_x = torch.from_numpy(am.x).to(dev)
    am_ei = torch.from_numpy(am.edge_index).to(dev)
    am_typed = dict(edge_type=torch.from_numpy(am.edge_type).to(dev),
                    type_perm=torch.from_numpy(am.type_perm).to(dev),
                    inv_type_perm=am_inv, type_counts=sizes)
    am_rplan = am.make_relation_plan(feat=RGAT_HEADS * HIDDEN, device=dev)
    print(f"  typed plan config (generated rules): m_b={am_plan.config.m_b} "
          f"s_b={am_plan.config.s_b}; relation plan m_b="
          f"{am_rplan.config.m_b}", flush=True)
    typed = []
    kops.reset_launch_counts()
    for family in gnn.TYPED_MODELS:
        n_heads = RGAT_HEADS if family == "rgat" else 1
        model = gnn.init(family, FEAT, HIDDEN, CLASSES, heads=n_heads,
                         num_relations=AM_RELATIONS, seed=SEED)

        def forward(impl=None):
            with torch.inference_mode():
                return rt.gnn_forward(model, am_x, am_ei, am.num_nodes,
                                      impl=impl, plan=am_plan, rplan=am_rplan,
                                      **am_typed)
        torch.cuda.reset_peak_memory_stats()
        before = kops.launch_counts()
        with kops.fusion_scope() as fusion:
            got = forward()
            torch.cuda.synchronize()
        after = kops.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        layers = len(model.layers)
        print(f"  {family} one forward launched {launched}; ops "
              f"{dict(fusion)}", flush=True)
        if any(not k.startswith("fused:") for k in fusion):
            fail(f"{family}: an op of the typed path took its plain version: "
                 f"{sorted(fusion)}")
        if launched["segment_matmul"] != layers:
            fail(f"{family}: {launched['segment_matmul']} segment_matmul "
                 f"launches for {layers} layers, expected one each")
        if launched["gather_segment_reduce"] < layers:
            fail(f"{family}: the gather kernel missed a layer")
        if family == "rgat" and launched["segment_softmax"] != layers:
            fail(f"{family}: {launched['segment_softmax']} softmax launches "
                 f"for {layers} layers")
        if got.shape != (am.num_nodes, CLASSES):
            fail(f"{family}: logits {tuple(got.shape)}")
        err = compare(torch, f"typed {family} on AM", got, forward("ref"),
                      torch.float32)
        fwd_ms = time_ms(torch, forward, reps=3, warmup=1)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        wall_ms, busy_ms, rows = profiled(torch, forward)
        # the gather's kernels (its runs path's two and its owner path's)
        # and the softmax's three, summed over the forward's launches
        gsr = {p: sum(ms for key, ms, _ in rows if p in key)
               for p in ("gsr_runs", "gsr_fix", "gsr_owner", "ssm_runs",
                         "ssm_fix", "ssm_cut")}
        ssm_ms = gsr["ssm_runs"] + gsr["ssm_fix"] + gsr["ssm_cut"]
        typed.append({"family": family, "heads": n_heads, "layers": layers,
                      "forward_ms": fwd_ms, "max_abs_err": err,
                      "peak_alloc_gib": peak_gb, "profiled_wall_ms": wall_ms,
                      "device_busy_ms": busy_ms or None,
                      "gather_runs_ms": gsr["gsr_runs"] if busy_ms else None,
                      "gather_fix_ms": gsr["gsr_fix"] if busy_ms else None,
                      "gather_owner_ms": gsr["gsr_owner"] if busy_ms else None,
                      "softmax_ms": ssm_ms if busy_ms else None})
        print(f"  typed {family} (heads={n_heads}) on AM: forward_ms="
              f"{fwd_ms:.3f} max_abs_err={err:.3g} peak_alloc_gib="
              f"{peak_gb:.2f}", flush=True)
        if busy_ms:
            print(f"  profiled {family} forward: wall_ms={wall_ms:.3f} "
                  f"device_busy_ms={busy_ms:.3f} idle_share="
                  f"{1 - busy_ms / wall_ms:.3f}; top device ops:", flush=True)
            for key, ms, _ in rows[:8]:
                print(f"    {ms:9.3f} ms  {key[:90]}", flush=True)
            gsr_ms = gsr["gsr_runs"] + gsr["gsr_fix"] + gsr["gsr_owner"]
            print(f"  profiled {family} forward: gather_segment_reduce "
                  f"gsr_runs {gsr['gsr_runs']:.3f} ms + gsr_fix "
                  f"{gsr['gsr_fix']:.3f} ms + gsr_owner "
                  f"{gsr['gsr_owner']:.3f} ms = {gsr_ms:.3f} ms", flush=True)
            if family == "rgat":
                print(f"  profiled {family} forward: segment_softmax "
                      f"ssm_runs {gsr['ssm_runs']:.3f} ms + ssm_fix "
                      f"{gsr['ssm_fix']:.3f} ms + ssm_cut "
                      f"{gsr['ssm_cut']:.3f} ms = {ssm_ms:.3f} ms", flush=True)
        else:
            print(f"  profiled {family} forward: device time not measured "
                  "(the profiler recorded no device events)", flush=True)
        del model, got
        torch.cuda.empty_cache()
    launches_typed = kops.launch_counts()
    print(f"typed inference passed ({time.perf_counter() - t_phase:.1f} s); "
          f"launches on the typed path: {launches_typed}", flush=True)
    print(json.dumps({"typed": typed}))
    del am_x, am_ei, am_typed

    # -- 3c. the public ops on card tensors ------------------------------------
    kops.reset_launch_counts()
    xo = torch.randn(a_e, HIDDEN, generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"rt.segment_reduce {reduce}",
                rt.segment_reduce(xo, a_dst, a_v, reduce),
                kops.segment_reduce(xo, a_dst, a_v, reduce, impl="ref"),
                torch.float32)
    compare(torch, "rt.sddmm", rt.sddmm(sd_a32, sd_b32, a_dst, a_src),
            kops.sddmm(sd_a32, sd_b32, a_dst, a_src, impl="ref"),
            torch.float32)
    launches_ops = kops.launch_counts()
    if launches_ops["segment_reduce"] != 3 or launches_ops["sddmm"] != 1:
        fail(f"the public ops missed their kernels: {launches_ops}")
    print(f"public ops passed; launches on the op path: {launches_ops}",
          flush=True)
    del xo

    # -- 3d. training: every family through repro_torch.fit --------------------
    t_phase = time.perf_counter()
    kops.reset_launch_counts()
    training = training_phase(torch, am)
    launches_training = kops.launch_counts()
    print(f"training passed ({time.perf_counter() - t_phase:.1f} s); "
          f"launches on the training path: {launches_training}", flush=True)
    print(json.dumps({"training": training}))

    # -- 3e. sampled mini-batches: sampler, prefetch, training, serving ------
    t_phase = time.perf_counter()
    kops.reset_launch_counts()
    arxiv = dataset("ogbn-arxiv", feat=FEAT, seed=SEED)
    sampled, sampled_serving, exact_err = sampled_phase(torch, arxiv, dev)
    launches_sampled = kops.launch_counts()
    print(f"sampled path passed ({time.perf_counter() - t_phase:.1f} s); "
          f"launches on the sampled path: {launches_sampled}", flush=True)
    print(json.dumps({"sampled": sampled, "sampled_serving": sampled_serving,
                      "exact_max_abs_err": exact_err}))
    del arxiv

    # -- 3f. config selection: sweeps, measured rules, the tuned engine -------
    t_phase = time.perf_counter()
    selection = selection_phase(torch, dev, graphs, am)
    print(f"config selection passed ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # -- 3g. sharded message passing: served and trained across ranks ------
    t_phase = time.perf_counter()
    sharded = sharded_phase(torch)
    launches_sharded = {k: sum(r[k] for r in sharded["launches_by_rank"])
                        for k in kops.launch_counts()}
    sharded.update(phase_s=time.perf_counter() - t_phase, card=card)
    print(f"sharded path passed ({sharded['phase_s']:.1f} s, backend "
          f"{sharded['backend']}, {card}); launches on the sharded path, "
          f"summed over the {SHARDS} ranks: {launches_sharded}", flush=True)
    print(json.dumps({"sharded": sharded}))

    # the CUDA kernels one launch of each wrapper runs, read from the
    # profiler's device events: two calls of the kernels line's
    # configuration (fresh inputs of its shapes) under one profiler
    # session each, back to back after the profiled forwards of 3b and
    # before the LM phases: after them, sessions saw the device events of
    # one kernel of six
    names = port_kernel_names()
    h_f = torch.randn(v, FEAT, generator=gen, device=dev)
    w_f = torch.randn(FEAT, HIDDEN, generator=gen, device=dev)
    x_m = torch.randn(m_typed, HIDDEN, generator=gen, device=dev)
    w_m = torch.randn(AM_RELATIONS, HIDDEN, HIDDEN, generator=gen, device=dev)
    x_r = torch.randn(a_e, HIDDEN, generator=gen, device=dev)
    per_launch = {}
    for name, fn in (
            ("gather_segment_reduce", lambda: kops.gather_segment_reduce(
                h64, src, dst, v, wts, "sum", plan=plan, impl="cuda")),
            ("segment_softmax", lambda: kops.segment_softmax(
                logits32, dst, v, plan=plan, impl="cuda")),
            ("fused_transform_reduce", lambda: kops.fused_transform_reduce(
                h_f, w_f, src, dst, v, wts, "sum", plan=plan, impl="cuda")),
            ("segment_matmul", lambda: kops.segment_matmul(
                x_m, sizes, w_m, plan=rplan, impl="cuda")),
            ("segment_reduce", lambda: kops.segment_reduce(
                x_r, a_dst, a_v, "sum", plan=a_plan, impl="cuda")),
            ("sddmm", lambda: kops.sddmm(sd_a32, sd_b32, a_dst, a_src,
                                         impl="cuda"))):
        fn()
        seen = kernels_in_call(torch, lambda: (fn(), fn()), names)
        total = sum(seen.values())
        # an odd or zero total means the profiler lost device events
        per_launch[name] = total // 2 if total and total % 2 == 0 else None
        print(f"  {name}: two calls ran the CUDA kernels {seen} -> "
              f"{per_launch[name]} a launch", flush=True)
    del h_f, w_f, x_m, w_m, x_r

    # -- 3h. LM serving: qwen3-moe-30b-a3b at full width, cut in depth -------
    t_phase = time.perf_counter()
    lm_record = lm_phase(torch, dev, card)
    lm_record["phase_s"] = time.perf_counter() - t_phase
    launches_lm = lm_record["launches"]
    print(f"LM serving passed ({lm_record['phase_s']:.1f} s, {card}); "
          f"launches on the LM path: {launches_lm}", flush=True)
    print(json.dumps({"lm_serving": lm_record}))

    # -- 3i. LM training: qwen3-moe-30b-a3b at full width, cut in depth ------
    t_phase = time.perf_counter()
    lm_train = lm_train_phase(torch, dev, card)
    lm_train["phase_s"] = time.perf_counter() - t_phase
    launches_lm_train = {k: lm_train["launches"].get(k, 0)
                         for k in kops.launch_counts()}
    print(f"LM training passed ({lm_train['phase_s']:.1f} s, {card}); "
          f"launches on the LM training path: {launches_lm_train}",
          flush=True)
    print(json.dumps({"lm_training": lm_train}))

    # -- 3j. the LM/MoE stack sharded across 4 ranks (2x2 data x model) -----
    t_phase = time.perf_counter()
    lm_sharded = lm_sharded_phase(torch)
    launches_lm_sharded = {k: sum(r.get(k, 0)
                                  for r in lm_sharded["launches_by_rank"])
                           for k in kops.launch_counts()}
    launches_lm_dropless = {
        k: sum(r.get(k, 0)
               for r in lm_sharded["dropless"]["launches_by_rank"])
        for k in kops.launch_counts()}
    # by path, summed over the ranks
    paths_lm_sharded, paths_lm_dropless = (
        {k: {p: sum(r[k][p] for r in ranks) for p in by}
         for k, by in ranks[0].items()}
        for ranks in (lm_sharded["paths_by_rank"],
                      lm_sharded["dropless"]["paths_by_rank"]))
    lm_sharded.update(phase_s=time.perf_counter() - t_phase, card=card)
    print(f"LM sharded passed ({lm_sharded['phase_s']:.1f} s, backend "
          f"{lm_sharded['backend']}, {card}); launches on the sharded LM "
          f"path, summed over the {SHARDS} ranks: {launches_lm_sharded}; "
          f"on its dropless path: {launches_lm_dropless}", flush=True)
    print(json.dumps({"lm_sharded": lm_sharded}))

    # -- 3k. the dry run on fake ranks, held to 3j; the ten examples ---------
    t_phase = time.perf_counter()
    dry = dryrun_phase(torch, lm_sharded)
    dry.update(phase_s=time.perf_counter() - t_phase, card=card)
    print(f"dry run and examples passed ({dry['phase_s']:.1f} s, {card})",
          flush=True)
    print(json.dumps({"dryrun": dry}))

    # -- 4. the kernels line ----------------------------------------------------
    print(f"bounds over {e_real} real edges, {h_rows} distinct source rows, "
          f"{v} output rows (gather, softmax, fused):", flush=True)

    idx_bytes = e_real * (4 + 4 + 4)          # gather idx, segment, fp32 weight
    # the gather kernel reads the plan's int64 row offsets, not its chunk
    # ranges
    g_bound = bound(idx_bytes + h_rows * HIDDEN * 4 + v * HIDDEN * 4
                    + (v + 1) * 8, 2 * e_real * HIDDEN)
    # the softmax reads the real rows' ids and logits and writes every row
    s_bound = bound(e_real * (4 + heads * 4) + e * heads * 4,
                    4 * e_real * heads)
    # the fused kernel reads the gather index and weight of each real row
    # and the plan's int64 row offsets whole, in place of the segment ids;
    # then the distinct rows of H, W and the output
    f_bound = bound(e_real * (4 + 4) + (v + 1) * 8 + h_rows * FEAT * 4
                    + FEAT * HIDDEN * 4 + v * HIDDEN * 4,
                    2 * e_real * FEAT + 2 * v * FEAT * HIDDEN)
    print(f"bounds of segment_matmul over M={m_typed} typed rows, "
          f"G={AM_RELATIONS} groups, {HIDDEN}->{HIDDEN}; segment_reduce over "
          f"M={a_e} rows into S={a_v}, F={HIDDEN}; sddmm over {a_e} pairs "
          f"reading {sd_rows} distinct rows of A and B, F={HIDDEN}:",
          flush=True)
    m_bound = smm_bounds[(HIDDEN, HIDDEN, torch.float32)]
    r_bound = bound(a_e * 4 + a_e * HIDDEN * 4 + a_v * HIDDEN * 4,
                    a_e * HIDDEN)
    d_bound = bound(a_e * 8 + sd_rows * HIDDEN * 4 + a_e * 4,
                    2 * a_e * HIDDEN)

    # the H100 cost model beside the card at the kernel table's
    # configurations (the shipped values)
    from repro_torch.core import costmodel as cm
    cfg0 = default_config(HIDDEN)
    model_vs_card = []
    for name, model_s, key in (
            ("gather_segment_reduce",
             cm.spmm_cost(e_real, v, HIDDEN, cfg0).total_s,
             (HIDDEN, torch.float32, "sum", True)),
            ("segment_softmax",
             cm.segment_softmax_cost(e_real, v, heads).total_s,
             ("softmax", torch.float32)),
            ("fused_transform_reduce",
             cm.fused_transform_reduce_cost(e_real, v, FEAT, HIDDEN,
                                            cfg0).total_s,
             ("fused", FEAT, HIDDEN, torch.float32, "sum")),
            ("segment_matmul",
             cm.segment_matmul_cost(m_typed, HIDDEN, HIDDEN,
                                    AM_RELATIONS).total_s,
             ("smm", HIDDEN, HIDDEN, torch.float32)),
            ("segment_reduce", cm.segment_reduce_cost(a_e, a_v, HIDDEN,
                                                      cfg0).total_s,
             ("srd", HIDDEN, torch.float32, "sum")),
            ("sddmm", cm.sddmm_cost(a_e, sd_rows, HIDDEN).total_s,
             ("sddmm", HIDDEN, torch.float32, "dst-sorted"))):
        card_ms = results[key][1]
        model_vs_card.append({"name": name, "model_ms": model_s * 1e3,
                              "card_ms": card_ms,
                              "card_over_model": card_ms / (model_s * 1e3)})
        print(f"  cost model {name}: {model_s * 1e3:.4f} ms, card "
              f"{card_ms:.4f} ms ({card_ms / (model_s * 1e3):.2f}x)",
              flush=True)
    print(json.dumps({"selection": selection, "cost_model": model_vs_card}))

    paths = {"serving": launches_serving, "typed": launches_typed,
             "ops": launches_ops, "training": launches_training,
             "sampled": launches_sampled, "sharded": launches_sharded,
             "lm": launches_lm, "lm_train": launches_lm_train,
             "lm_sharded": launches_lm_sharded,
             "lm_sharded_dropless": launches_lm_dropless}

    csrc = "src/repro_torch/kernels/csrc"

    def entry(name, replaces, res, bnd, library_ms, config, note=None):
        err, k_ms, p_ms = res
        out = {"name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
               "replaces": f"src/repro/kernels/{replaces}",
               "cuda_kernels_per_launch": per_launch[name],
               "launches": sum(p[name] for p in paths.values()),
               "launches_by_path": {k: p[name] for k, p in paths.items()},
               "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
               "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_ms": (library_ms if isinstance(library_ms, float)
                              else None), "config": config}
        if note or not isinstance(library_ms, float):
            out["library_note"] = note or library_ms
        return out

    smm_lib = library_smm[(HIDDEN, HIDDEN, torch.float32)]
    kernels = [
        entry("gather_segment_reduce", "gather_segment_reduce.py:277",
              results[(HIDDEN, torch.float32, "sum", True)], g_bound,
              library_gather_ms, f"weighted sum fp32 F={HIDDEN} at {bucket}",
              "torch.sparse.mm of the CSR of the real edges"),
        entry("segment_softmax", "segment_softmax.py:202",
              results[("softmax", torch.float32)], s_bound,
              library_softmax_ms, f"fp32 (E, {heads}) at {bucket}",
              "torch.sparse.softmax of a (V, E, heads) COO over dim 1"),
        entry("fused_transform_reduce", "fused_transform_reduce.py:171",
              results[("fused", FEAT, HIDDEN, torch.float32, "sum")],
              f_bound, None, f"weighted sum fp32 {FEAT}->{HIDDEN} at {bucket}",
              "no single PyTorch call computes SpMM then GEMM; two_call_ms "
              "times torch.sparse.mm of the CSR of the real edges then "
              "torch.matmul by W"),
        entry("segment_matmul", "segment_matmul.py:149",
              results[("smm", HIDDEN, HIDDEN, torch.float32)], m_bound,
              smm_lib, f"fp32 {HIDDEN}->{HIDDEN}, M={m_typed} rows in "
              f"{AM_RELATIONS} groups (AM typed graph)",
              "torch._grouped_mm with the group offsets, same fp32 inputs"
              if isinstance(smm_lib, float) else None),
        entry("segment_reduce", "segment_reduce.py:266",
              results[("srd", HIDDEN, torch.float32, "sum")], r_bound,
              library_srd["sum"], f"sum fp32 F={HIDDEN}, M={a_e} rows into "
              f"S={a_v} (ogbn-arxiv destinations)",
              "torch.segment_reduce with per-segment lengths"),
        entry("sddmm", "sddmm.py:98",
              results[("sddmm", HIDDEN, torch.float32, "dst-sorted")],
              d_bound, library_sddmm, f"fp32 F={HIDDEN}, {a_e} (dst, src) "
              f"pairs of ogbn-arxiv",
              f"torch.sparse.sampled_addmm on the CSR of the pattern: "
              f"{sd_pairs} distinct pairs (duplicates merged)"
              if isinstance(library_sddmm, float) else None),
    ]
    # the gather kernel as the typed path runs it, beside its own bound
    kernels[0]["typed_mean_ms"] = results["gather typed"][1]
    kernels[0]["typed_mean_bound_ms"] = results["gather typed bound"][0]
    # the softmax as RGAT runs it, and segment_reduce's other reduces beside
    # torch.segment_reduce's
    kernels[1]["typed_ms"] = results["softmax typed"][1]
    kernels[1]["typed_bound_ms"] = results["softmax typed bound"][0]
    kernels[4]["ms_by_reduce"] = {
        r: results[("srd", HIDDEN, torch.float32, r)][1]
        for r in ("sum", "mean", "max")}
    kernels[4]["library_ms_by_reduce"] = library_srd
    # the fused kernel's two-call yardstick, its hub and reddit2 launches
    # beside their bounds; sddmm on the shuffled pairs
    kernels[2]["two_call_ms"] = two_call_ms
    kernels[2]["hub_ms"] = results[("fused hub", torch.float32)][1]
    kernels[2]["hub_bound_ms"] = results["fused hub bound"][0]
    kernels[2]["reddit2_ms"] = results[("fused reddit2", torch.float32)][1]
    kernels[2]["reddit2_plain_ms"] = results[("fused reddit2",
                                              torch.float32)][2]
    kernels[2]["reddit2_bound_ms"] = results["fused reddit2 bound"][0]
    kernels[2]["reddit2_row_read_tb_s"] = results["fused reddit2 rows"][1]
    # the gather at SAGE's class widths over Reddit2 (the whole-row walk)
    kernels[0]["sage_class_mean"] = results["sage class gather"]
    # GAT's alpha-weighted sums and softmax on Reddit2 with self-loops
    kernels[0]["gat_weighted_sum"] = results["gat aggregations"][
        "weighted_sum"]
    kernels[1]["gat_softmax"] = results["gat aggregations"]["softmax"]
    # the MoE shapes of phase 3h: the combine, and the three expert products
    kernels[0]["moe_combine"] = lm_record["gather_moe"]
    kernels[3]["moe_products"] = lm_record["segment_matmul_moe"]
    # the typed widths in bf16: the path the rule takes, and today's
    # mma_sync kernel's time in the same call
    kernels[3]["typed_bf16"] = {
        f"{k_dim}->{n_dim}": results[("smm typed bf16", k_dim, n_dim)]
        for k_dim, n_dim in ((HIDDEN, HIDDEN), (FEAT, 2 * HIDDEN))}
    # the launches of the kernels with two paths on the LM paths, by the
    # path they took; the generic rows' path (the old one, by the rules)
    for i in (0, 3, 5):
        name = kernels[i]["name"]
        kernels[i]["launches_by_kernel_path"] = {
            "lm": lm_record["kernel_paths"][name],
            "lm_train": lm_train["kernel_paths"][name],
            "lm_sharded": paths_lm_sharded[name],
            "lm_sharded_dropless": paths_lm_dropless[name]}
    kernels[0]["path"], kernels[5]["path"] = generic_paths
    # the training shapes of phase 3i: the expert products' dX, the
    # combine's dH and the dispatch's dH, the router-weight gradient, the
    # embedding's backward
    by_kernel = collections.defaultdict(list)
    for p in lm_train["backward_pieces"]:
        if "kernel" in p:
            by_kernel[p["kernel"]].append(p)
    kernels[3]["moe_train_products"] = by_kernel["segment_matmul"]
    kernels[0]["moe_train_backward"] = by_kernel["gather_segment_reduce"]
    kernels[5]["moe_train_router_grad"] = by_kernel["sddmm"]
    kernels[4]["embedding_backward"] = lm_train["embedding_backward"]
    kernels[5]["shuffled_ms"] = results[("sddmm", HIDDEN, torch.float32,
                                         "shuffled")][1]
    kernels[5]["b_row_read_tb_s"] = sd_b_bytes / kernels[5]["ms"] / 1e9
    for r in roles:           # the sddmm role is 2b's call, and its bound
        if r["kernel"] == "sddmm":
            r["bound_ms"] = d_bound[0]
    print(f"chip_smoke.py ran {time.perf_counter() - t_script:.1f} s after "
          f"its imports of the standard library", flush=True)
    print(json.dumps({"serving": serving}))
    print(json.dumps({"backward_roles": roles}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
