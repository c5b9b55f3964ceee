#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GraphChallenge, GraphBLAS, training, tuning,
sharded, fleet and model-stack (LLM serving and training) paths and its
meta-device dry run on one GPU (the sharded phases and the model's data
mesh also over one position a card on a host with 4).

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (each prints one JSON line; any failure raises, exit code != 0;
they run in this order, except that 30, ``dryrun``, runs right after 2,
with the numpy oracles of 10, 16 and 20 computed beside it):

1. device    — a CUDA card must be present; print its name and power
   limit, build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) and print nvcc's register/spill report; the
   register-tiled kernels (all five) must spill nothing.
2. kernels   — each of the five kernels against its plain PyTorch
   version at the serving shapes (RadiX-net 1024 neurons, block 16,
   panel 512; 16384 neurons for the tiled kernel; the dense kernel on a
   densified 1024 × 1024 layer): error, median time from CUDA events,
   the plain version's time, the bound and a library yardstick where one
   PyTorch call computes the same function, the stored work folded per
   second (``tflops``) and the time over the library's (``vs_library``);
   the three semiring kernels also on an 8-column panel (``narrow``);
   ``bcsr_spmm`` also where its work is: RadiX-net's stride-32 layer as
   block-CSR (``stride32``, the same 2048 stored blocks as ``bsr_spmm``'s
   row) and the graphblas phase's skewed 8192 × 8192 adjacency at 256
   and 8 columns (``skewed``, with its piece count and cut rows); both
   SpMMs on the paper's 128 × 128 blocks (``block128``: an 8192 × 8192
   layer, 8 of 64 blocks a row, 64 columns), which the wrappers launch
   re-tiled, with the sub-block they launched; each beside the ``addmm``
   of its dense form; the two fused kernels with
   their launch (``cluster``, ``ctas``, what the card holds at once) and
   a 2048-column ``wide`` probe with its time over the 512-column time. Then ``semirings``: the
   three semiring kernels in all eight semirings on integer-valued
   operands with an empty block-row, ELL pad slots and block-CSR tail
   slots — exact, ``log_plus`` within 1e-5 — with their times.
3. serve     — ``run_challenge(RadixNetSpec(1024, 120))``: all 60 000
   inputs in 512-column panels through ``SparseDNNEngine`` on route
   ``fused``; categories against the numpy reference on 512 inputs.
4. layered   — the same spec with ``use_resident=False`` on 2 048 inputs:
   route ``layered`` through both SpMM kernels.
5. tiled     — ``RadixNetSpec(16384, 120)`` on 1 024 inputs at input
   density 0.4: route ``fused-tiled``.
6. dense     — the paper's BLAS arm: the same 1024 × 120 network with
   every distinct layer matrix densified once, 2 048 inputs through
   ``SparseDNNEngine`` on route ``layered``, every layer ``kernel-dense``
   (``semiring_matmul`` only); categories against the numpy reference
   on all 2 048 inputs. With ``layered`` it is the paper's sparse-vs-
   dense point on this card at inverse sparsity 32.
7. graphblas — the reference's GNN arm (benchmarks/kernel_bench.py
   ``gnn_arm``) at card scale: a power-law 8192 × 8192 adjacency (block
   16, 8192 stored blocks, skew 0.8, seed 5) handed over as ELL; two
   ``plus_times`` graph-convolution rounds through ``gb.mxm`` against
   the ``use_kernel=False`` oracle, ``min_plus`` Bellman-Ford through
   ``gb.mxv`` against numpy bit for bit, one ``lor_land`` BFS step
   through ``gb.vxm``, and the paper's three-call ``dnn_forward(
   fused=False)`` on RadiX-net 1024 × 120 with 2 048 inputs; it prints
   the adjacency's longest and median block-row.
8. train-radixnet — the training path at full width: RadiX-net 1024 ×
   120's stored blocks (the stride-1 phase as block-CSR) with seeded
   He-scale values, a 512-column Philox panel, a differentiable
   ``StackPlan``, the first step's gradients against the plain versions
   on the card (``GRAD_RTOL``), then 3 SGD steps of
   ``make_sparse_train_step``: the loss must fall, the gradients stay in
   the stored pattern, no transpose is sorted after the plan's build,
   and the launches per step split into forward (one per sparse layer)
   and backward (``bcsr_spmm`` on the cached transpose of every sparse
   layer whose input needs a gradient); forward, backward and
   step times on the synchronised host clock.
9. train-paper — the paper's MLP at a Fig. 5 grid point
   (``graphblas_mlp.make_config(m=8192, num_layers=8,
   inverse_sparsity=8, block=128)``, batch 64): seeded dense weights
   ``block_prune``'d to 8 of 64 blocks a row, every other layer as
   block-CSR; a no-grad forward through a layered plan against the plain
   version (the 128 × 128 blocks reach the kernels as 64 × 64
   sub-blocks, the wrappers' re-tiling), then 2 AdamW steps checked as in
   phase 8, with the block shapes each wrapper launched.
10. continuous — RadiX-net 1024 × 120 through a ``ContinuousBatcher``
   (resident engine, ``batch_size`` 512, width classes 64/128/256/512,
   ``min_fill`` 0, ``max_wait`` 4) serving a ``poissonish_trace`` of
   6 000 single-column requests at a mean of 256 a tick (``CONTINUOUS``),
   each a column of the Philox input panel (density 0.3, seed 0): every
   completed request's category against the numpy oracle on its column,
   one capture per width class used, goodput 1.0, a plan-cache miss for
   each class used and a hit for every other dispatch (the rate is
   printed: a few dozen dispatches hold it far under 0.99), launches =
   replays + warm-ups; the ``ServeStats`` summary, the loop's host
   seconds and edge·inputs/s.
11. continuous-faults — the same batcher on the same trace with a
   seeded injector (NaN panel, transient step, plan-compile failure)
   and a ``VirtualClock``: the poisoned requests
   quarantined, the others' categories exact, the transient step
   retried, the ladder demoted to ``layered`` and restored; the ladder's
   events.
12. serve-bf16 — ``run_challenge`` at 1024 × 120 with
   ``panel_dtype="bfloat16"``: a 512-column panel's output against
   ``fused_mlp_plain(..., panel_dtype="bfloat16")`` within
   ``STACK_RTOL``, the categories that agree with the f32 oracle
   (printed, not held), the bf16 launch's time beside the f32 one's.
13. tune — the autotuner (``repro_torch.tune``): the reference tune
   arm's skewed stack (``TUNE_SKEWED``: three rectangular layers, skew
   0.3, width 64), where ``layout=bcsr`` must win with fewer tile
   products and less block work than the default and give the default
   plan's output within 1e-6 of it; then RadiX-net 1024 × 120 and
   4096 × 120 (``TUNE_RADIX``; input density 0.3 and 0.35) at 512
   columns of the challenge's {0, 1} panel over block_n (default, 8) × panel dtype × layout × shared-memory
   budget (default, and one byte under the f32 resident panel or the
   card's limit): every candidate's route, bill, shared-memory bytes,
   time, error and selection, and whether the selection is the fastest
   measured (evidence only: the cost model selects). No candidate may
   fail to build. The winners go into one ``TuningTable``, saved and
   loaded back.
14. serve-tuned — ``run_challenge(spec, tuning_table=table)`` on all
   60 000 inputs at both sizes and their densities: route, launches (warm-up + replays),
   edge·inputs/s; categories against the numpy oracle on 512 columns
   (held for f32 panels; for bf16 panels a panel is held bit for bit to
   ``fused_mlp_plain`` and the disagreements printed); then an engine
   built with the same table, its plan's tuned token and captured
   launches checked as in the serving phases.
15. train-resilient — ``run_resilient_training`` on train-radixnet's
   network (``RESILIENT``: 12 SGD steps, checkpoints every 4, a batch per
   step): a clean run, a run with a NaN loss at step 6 (one restart,
   step 6 skipped) and a run stopped at step 8 and resumed; both must
   give the clean run's losses bit for bit. The checkpoint's bytes and
   its save, restore and (on the card) validation times.

16. sharded — ``run_challenge(RadixNetSpec(65536, 120), mesh=
   make_row_blocks_mesh(4))`` on the one card (``SHARDED``: 8 192 inputs
   in 512-column panels, input density 0.45): route and level
   ``sharded``, 4 ``bcsr_spmm`` launches a layer a replay (the captured
   graph's kernel nodes), imbalance <= 1.10, the per-shard bills summing
   to the unsharded block-CSR bill, a replay bit-identical to the eager
   forward; at the first layer of each of the 4 distinct partitions,
   every shard's launch (no epilogue, the served panel's 512 columns)
   against ``bcsr_spmm_plain`` on its sub-segment and the summed layer
   against the plain unsharded layer (``SPMM_RTOL``); categories equal to
   the unsharded engine's (its own route) on every input and to the numpy
   oracle on 64, whose final values the served ones match by the stack
   criterion (``STACK_RTOL`` and the f32 bound); edge·inputs/s beside the
   unsharded run's; the heaviest layer's 4 launches against its
   partial-panel sum (CUDA events); then a fresh engine with a shard lost
   at dispatch 1: the timed panels serve from ``layered`` with the same
   categories, one ladder event.
17. sharded-train — train-radixnet's network with every layer block-CSR
   through a differentiable 4-shard plan (``SHARDED_TRAIN``): the first
   step's gradients against the plain versions on the sharded kernels'
   ReLU masks (``GRAD_RTOL``), two backward passes bit-identical, 3 SGD
   steps whose losses are within 1e-5 of the unsharded differentiable
   plan's, launches per step (4 a layer forward, 4 a layer but the first
   backward), step times.
18. sharded-cards — the ``sharded`` phase's network and inputs over one
   card a shard (``cards_mesh``: ``make_row_blocks_mesh(devices=...)``
   on a host with 4 cards, else every position on the one card,
   ``"cards": 1``): route and level ``sharded``; each card's 120
   ``bcsr_spmm`` launches a forward from the per-card counts; each
   card's allocated memory holding its shards' sub-layouts; categories
   equal to the one-card run's, the unsharded engine's and the oracle's;
   one 512-column panel's output bit for bit the one-card 4-shard
   route's; the bills summing to the unsharded bill. Prints edge·inputs/s,
   each card's kernel time (CUDA events on the card), the host's time to
   issue a layer and the exchange's share of it, and on several cards
   whether they reach each other's memory and one band's copy rate.
19. sharded-cards-train — ``sharded-train`` over the same mesh, with its
   checks, and each card's launches.
20. fleet — the reference's fleet arm (``FLEET``): 3 replicas of
   RadiX-net 1024 × 120, each its own plan cache, behind
   ``FleetFrontend`` on a ``VirtualClock``; a bursty trace at rate factor
   4 (8 s, seed 17, widths 4 and 24, classes 8 and 24, deadline 0.05 s,
   2 048 pending columns); the service model's price of a billed block
   product is a replayed 24-column plan's time over its bill. Plan hit
   rate >= 0.9, no failed job, launches = the replicas' warm-ups +
   replays; the same trace with replica 0 lost at dispatch 100 drops no
   admitted job; every served job's categories in both runs against the
   numpy oracle.
21. llm-serve — Llama-3.2-1B at its published dimensions (``LLM_SERVE``):
   ``Model.init`` draws the 1.236e9 f32 parameters on the card from a
   seeded generator; ``Engine(batch_size=4, cache_len=128,
   temperature=0.0)`` casts its bf16 serving copy once; two ``generate``
   calls of 32 tokens for a seeded 4 × 32 prompt panel must agree; the
   first token must be the argmax of ``Model.forward``'s last prompt
   position, ``decode_step``'s logits at position 32 must match
   ``forward`` at 32 within the reference's rtol = atol = 2e-2, and the
   cache must hold the bytes its shapes give (16 785 408). Prints prefill
   ms, decode ms a step (host clock after ``synchronize``, median of 8),
   the step's kernel time (``torch.profiler``, kernel rows only), its
   bound (the serving copy and the cache read once), tokens/s and peak
   memory.
22. model-mlp — the paper's MLP through ``Model`` (``MODEL_MLP``:
   ``graphblas_mlp.make_config(m=8192, num_layers=8, inverse_sparsity=16,
   block=128)``, 4 blocks of 128 × 128 a block-row): ``init``,
   ``sparsify``, ``forward`` on 64 U[0, 1) feature vectors: 8
   ``bsr_spmm`` launches, all at the re-tiled 64 × 64 blocks, the output
   against ``Model(cfg, use_kernel=False)`` on the same params by the
   stack criterion (``STACK_RTOL`` and ``f32_chain_bound``).
23. llm-sparse — llm-serve's weights with every FFN projection
   block-pruned to 4 blocks of 128 × 128 a block-row (``SparsityConfig``,
   ``Model.sparsify``), cast to bf16: a 4 × 32 ``prefill`` launches 48
   ``bsr_spmm`` (3 a layer; bf16 operands read as f32 by ``linear``) and
   its logits match ``use_kernel=False`` within 2e-2.
24. model-train — model-mlp's network trained through the model API
   (``MODEL_TRAIN``): ``sparsify``, ``make_train_step`` with AdamW on one
   fixed batch of 64 U[0, 1) feature vectors, 20 steps: the loss falls by
   more than 0.2; a step launches 8 ``bsr_spmm`` (forward) and 7
   ``bcsr_spmm`` (dX on the ELL transpose of every layer but the first),
   all at 64 × 64; the first step's loss and every gradient within
   ``GRAD_RTOL`` of each leaf's max |plain| against the plain products on
   the kernels' ReLU masks (the plain model's own gradients and its mask
   flips printed, held when nothing flips); a 2-microbatch SGD step
   against the 1-microbatch one (the reference's tolerances); topology
   unchanged. Step, forward and backward ms, the step's kernel ms, the
   plain step's ms, transposes sorted a step.
25. llm-train — Llama-3.2-1B at published width (``LLM_TRAIN``):
   ``init_train_state`` on the card (4.94 GB of f32 weights), AdamW with
   ``warmup_cosine(3e-4, 10, 100)`` and f32 moments, ``SyntheticLM(vocab,
   128, 8)`` through a ``Prefetcher``, 2 microbatches, 5 steps; then the
   same weights with every FFN block-pruned to 4 blocks of 128 × 128 a row
   (48 sparse projections, each forward and backward on the SpMM kernels
   a microbatch). Finite losses, ``opt.step`` = 5, every float leaf moved,
   launches against the count from shapes, the sparse first step's loss
   and gradients at f32 compute against the plain products microbatch by
   microbatch, at the timed steps' 512 columns (``GRAD_RTOL`` of each
   leaf's max), topology unchanged. Step ms (median of steps
   2–5), tokens/s, peak memory, kernel ms, beside the step's bound: the
   larger of 6 × params × tokens over the dense bf16 tensor-core peak and
   the optimizer's f32 passes over params, gradients and moments over the
   HBM rate.
26. launch-train — ``repro_torch.launch.train.main`` on the default device
   at ``--arch llama3.2-1b --scale-down``, 20 steps, checkpoints at steps 10
   and 20; the run stopped at 10 (its step-20 checkpoint dropped) and
   resumed with ``--resume`` gives the uninterrupted run's metrics for
   steps 11–20 bit for bit.
27. llm-train-data — llm-train over the model's data mesh of 4 positions
   (``LLM_TRAIN_DATA``, ``data_mesh``: one a card on a host with 4 cards,
   else all 4 on card 0, ``"cards": 1``): the state placed by
   ``param_pspecs``, each position its rows of each of 2 microbatches,
   gradients added onto the owners in card order, 3 steps dense and 3 with
   every FFN block-pruned. Held: the first step at f32 compute (SGD)
   against the one-position step on the same global batch (loss and ce
   within ``LOSS_RTOL``; each gradient, each updated leaf and
   ``grad_norm`` within ``GRAD_RTOL`` of its leaf's max, chunk by chunk);
   each position's stored bytes its chunks'; the leaves every position
   holds whole the same bits after every step; every float leaf moved on
   every position; each card's launches against the count from shapes
   (48 ``bsr_spmm`` and 48 ``bcsr_spmm`` a microbatch a position on its
   card); topology unchanged. Prints step ms on the host clock, each
   card's device ms and peak memory, and the gather and reduce bytes and
   ms.
28. launch-train-data — launch-train over the same mesh (``--data 4``;
   ``--device cuda`` on a host with fewer than 4 cards): 20 steps,
   stopped at 10 and resumed bit for bit; the step-20 checkpoint restored
   onto one position holds the 4 positions' leaves.
29. llm-train-model — llm-train over the model's 2 × 2 ``data`` × ``model``
   mesh (``LLM_TRAIN_MODEL``, ``model_mesh``: one position a card on a
   host with 4 cards, else all 4 on card 0, ``"cards": 1``): attention
   heads, the FFN's hidden columns, the embedding's d and the head's vocab
   split over ``model``, each group of 2 positions computing its rows with
   ``tensor_parallel``'s fan-out, fan-in, gathers and reshard, 3 steps
   dense and 3 with every FFN block-pruned (whole, on each group's home
   card). Held: the first step at f32 compute (SGD) against the
   one-position step (loss and ce within ``LOSS_RTOL``; each gradient,
   each updated leaf and ``grad_norm`` within ``GRAD_RTOL`` of its leaf's
   max, chunk by chunk); each position's stored bytes ``param_pspecs``'
   chunk sizes; chunks held by several positions the same bits after
   every step; every float leaf moved; each card's launches against the
   count from shapes (48 ``bsr_spmm`` and 48 ``bcsr_spmm`` a microbatch a
   group on its home card, none on the others); topology unchanged. Then
   Moonlight-16B-A3B at published width cut to its dense first layer and
   one MoE layer (1.3 B parameters), its 64 experts 32 a model position,
   one step held the same way. Then the other mixers at published width
   (``MIXER_CUTS``): DeepSeek-V2 cut to its dense first layer (MLA over
   heads), Jamba to one Mamba layer with its dense FFN (``di`` over
   ``model``, ``in_proj``'s ``[x_in | z]`` regrouped), RWKV-6 to 8 of its
   32 layers (time mix over heads, channel mix over ``d_ff``), each one
   f32-compute step held against the one-position step as above (RWKV-6,
   ``MIXER_HELD_IN_F64``: held so in f64, and at f32 its loss held and
   its gradients measured beside the data mesh's own spread), then one
   step at the config's compute dtype; and Jamba's layer again with
   its FFN pruned to 4 blocks of 128 × 128 a row, whole on each group's
   home card, its ``bsr_spmm``/``bcsr_spmm`` launches held to the count
   from shapes and added to this phase's. Prints step ms on the host
   clock, each card's device ms and peak memory, stored bytes, the
   groups' gather and reduce bytes and ms, and the model axis's exchanges
   a step (bytes by collective, Mamba's ``in_proj`` regroup its own line,
   and ms replayed on their own). Then sequence parallelism over
   ``model`` (``ShardingRules(seq_axis="model")`` active, ``seq_rules``;
   64 of the 128 tokens a position): Llama-3.2-1B's first step at f32
   held against the one-position step (the limits above) and against the
   unsplit 2 × 2 step (``split_against_unsplit``: the loss and ce the same
   bits, each gradient within ``SPLIT_GRAD_RTOL`` of its leaf's max; the
   sequence gathers and reduce-scatters present, the fan-out and fan-in
   bytes fallen), the bf16 step timed against the unsplit one in turns
   with each card's peak, its exchanges by kind; the same with every FFN
   pruned (the sequence gathered on each group's home card, its
   ``bsr_spmm``/``bcsr_spmm`` launches held to the count from shapes and
   added to this phase's); and Jamba's one-Mamba-layer cut held to its
   unsplit step the same way.
30. dryrun — ``repro_torch.launch.dryrun`` held to the card (``DRYRUN``),
   in a process of its own with ``expandable_segments``: one line per
   record of every arch's ``decode_32k`` and ``long_500k`` on the
   ``card`` and ``pod16x16`` meshes (``ok``, or ``skipped`` with the
   assigned reason). Then the plan's ``fn`` (``launch.specs.make_plan``)
   runs for real at full sequence length, random weights and tokens
   from seeded generators: Gemma-3-4B ``long_500k`` at full size (a
   cache filled with seeded values as by a prefill of S - 1 positions;
   the donated decode equal to the out-of-place one bit for bit);
   Llama-3.2-1B ``train_4k``, ``prefill_32k`` and ``decode_32k`` at the
   largest batch whose dry-run peak fits the card's free memory less
   1 GiB (train: the plan's 8 microbatches need an f32 accumulator
   more, so one sequence in one microbatch, and two must not fit;
   prefill: from a batch-1 trace, the cut traced beside its card run;
   decode: from the full batch's trace, its cache a real prefill of
   S - 1 positions of 2 prompts, tiled). Each held to the dry run
   traced once at its cut batch: ``FlopCounterMode``'s FLOPs on the
   card equal, ``max_memory_allocated`` over the call less what the
   process held besides the arguments within 10%, a donated cache in
   its own storages; train's loss and gradient norm finite; the same
   donated decode at f32 compute within ``LLM_F32_TOL`` of the f32
   prefill of S positions (the bf16 distances printed). Each cell's
   time beside its roofline bound; no kernel launched. Then the mesh
   cells (``DRYRUN_MESH``): Llama-3.2-1B ``train_4k`` (8 of 16 layers)
   and ``decode_32k`` on the 2 × 2 ``data`` × ``model`` mesh, traced
   through the mesh path on ``meta`` at the largest batch whose traced
   peak for the whole device fits the same limit, then the same placed
   step run on 4 positions of card 0 with every move between positions a
   copy: FLOPs and the exchanges by kind equal to the trace, the card's
   peak within 10% of the traced peak for the whole device; then
   ``train_4k_seq``, ``train_4k`` at the same batch with its sequence
   split over ``model`` (``--seq-shard``), traced and held the same way; a line each
   with the trace's per-position peaks, collectives, ``t_collective_s``
   and dominant term (``tools/torch_cards_run.py dryrun-cards`` runs them
   one card a position). The cells keep
   the card busy and the host's cores idle for minutes, so the numpy
   oracles of ``continuous``, ``sharded`` and ``fleet`` run beside them
   (``oracles_ahead``, on the cores less 4: the dry run's process and
   its three tracers); the script waits for them before the next phase,
   so no phase that reads the host's clock runs beside them
   (``oracles_beside`` in this line).
31. llm-serve-model — serving over the model's 2 × 2 ``data`` × ``model``
   mesh (``LLM_SERVE_MODEL``, ``model_mesh``) through
   ``serve.engine.make_serve_fns``: Llama-3.2-1B at published width, its
   params placed by ``param_pspecs`` and its cache by ``cache_pspecs``
   (128 slots, 64 a model position), 4 prompts of 48 tokens, 40 greedy
   tokens, so the decode crosses into model position 1's slot range.
   Held at f32 compute against the one-device path on the same weights
   and tokens and ``Engine.generate`` (``serve_held``): every call's
   logits within ``LLM_F32_TOL`` of each row's max, the greedy tokens
   equal, every cache chunk in its own storage. Timed at bf16
   (``serve_timed``): prefill and decode ms on the host clock, one decode
   step's exchanges between model positions by kind and each card's
   device ms, the per-call gather of the groups' params and its share of
   a step, stored bytes a position, peak. Then the f32 serve again with
   ``ShardingRules(seq_axis="model")`` active: the 48-token prefill split
   over ``model`` (24 tokens a position), held to the one-device path and
   ``Engine`` the same way, its sequence gathers and reduce-scatters
   counted; the decode steps (S = 1) unsplit. Then the same weights with
   every FFN pruned to 4 blocks of 128 × 128 a row, held at f32 against
   the one-device path with the kernels and with the plain products
   (``Model(use_kernel=False)``), its ``bsr_spmm`` launches on each
   group's home card held to the count from shapes. Then
   ``SERVE_MIXER_CUTS`` on 1 × 2, each held at f32 and
   timed: DeepSeek-V2 (1 layer, MLA latents over ``cache_seq``), Jamba (1
   Mamba layer, its state over ``di``), RWKV-6 (8 layers, its state over
   heads; held in f64, ``MIXER_HELD_IN_F64``, its f32 errors printed) and
   Gemma-3-4B cut to one period (5 local layers of window 1024 and a
   global one; a 1 100-token prompt into 1 280 slots, so the local rings
   wrap and split, ``SERVE_LONG``).

Every engine plan on the card captures its forward as a CUDA graph at
its first panel (an eager warm-up, then the capture) and replays it for
the others: each serving phase checks that its launches are the
warm-ups' and the replays' (``plan_launches``), and for one plan of each
route reads the kernel nodes of its captured graph through libcuda
and holds them against what the capture recorded and what one more
replay added to the wrappers' counts (``measured_replay``). The layered, dense and
three-call phases also time the captured ``plan.forward`` against the
same layer loop called eagerly through ``kernel_ops`` from this script,
interleaved, five times each, beside the kernels' CUDA-event time
(``host_share``).

Launch counts are reset to 0 right before each of phases 3-31 and read
right after (for 8, 9, 17, 19 and 24, around the train steps; for 25, 27
and 29, around the sparse model's steps, in 29 also around the pruned
Jamba layer's step and the split pruned step; for 20, around each run of the trace; for 31, around
the mesh's calls of the pruned serve). Each phase's line ends with
``elapsed_s``, the seconds since the script started. The ``kernels``
line, the ``nvidia-smi`` line and, last, ``{"ok": true, "device":
{...}}`` close the run. Numbers are this run's
own; the bound of a kernel is max(bytes / 3.35 TB/s, ops / 67 TFLOP/s)
(H100 SXM HBM3 rate and f32 CUDA-core peak at 700 W; the LLM train step's
bound takes the dense bf16 tensor-core peak, 989 TFLOP/s), counting the
stored blocks' values, the index arrays, bias, the panel read once and
the output written once, and 2·n operations (one ⊗, one ⊕) per weight
the product needs: the nonzero weights under ``plus_times`` (zeros
inside stored blocks are not work these inputs need), every stored entry
under the other semirings, whose zero is not 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
# H100 SXM, dense bf16 on the tensor cores (NVIDIA's data sheet: 1,979 TFLOP/s
# with 2:4 sparsity, half that dense), at the full 700 W
BF16_TC_FLOPS_PER_S = 989e12
SPMM_RTOL, SPMM_ATOL = 1e-5, 1e-6  # f32, one layer, summation order differs
# f32 stacks: max|kernel - plain| <= 1e-4 x max|plain| over the output,
# and every entry |kernel - plain| <= 2e + 1e-6, where e bounds how far
# any f32 evaluation of the stack may lie from the exact one
# (f32_chain_bound). Live RadiX-net columns grow to ~1e34 and early-layer
# cancellation against the bias leaves a few columns ill-conditioned, so a
# fixed per-column rtol cannot hold both f32 orders to one another there;
# the bound holds each entry to what its own column's arithmetic allows.
STACK_RTOL, STACK_ATOL = 1e-4, 1e-6
BF16_ULPS = 4  # bf16 panels, per column: 4 ulp(bf16) x max|plain| + atol
BF16_DEPTH = 8  # layers of the bf16-panel comparison
WIDE = 2048  # columns of the fused kernels' occupancy probe
LOG_PLUS_TOL = 1e-5  # the reference's TOL: its reductions chain in another order
GNN_TOL = 1e-5  # gnn_arm's scale-normalised conv agreement

NARROW_N = 8  # the narrow-panel timing of the redesigned kernels (an mxv's width)
# the training phases: the first step's gradients, kernels against the plain
# versions on the card with each layer's ReLU mask taken from the kernels'
# forward, per layer tensor ||kernel - plain|| <= GRAD_RTOL ||plain|| (f32
# products summed in another order through the forward and back). With its
# own masks the plain forward puts a few of RadiX-net's 6e7 pre-activations
# within rounding of 0 on the other side (a gradient of a ReLU stack jumps
# there): those flips are counted and their gradient error printed, not held
# to the bound.
GRAD_RTOL = 1e-4
TRAIN_SEED = 7
RADIX_TRAIN = dict(neurons=1024, layers=120, columns=512, steps=3, lr=0.02)
PAPER_TRAIN = dict(m=8192, layers=8, inverse_sparsity=8, block=128, batch=64, steps=2, lr=1e-3)
# the continuous phases: arrivals of poissonish_trace(n_requests, m=1024, lam=lam,
# seed=seed) with the generator's own burst parameters, each request a column of
# the Philox panel. A mean of 256 arrivals a tick fills half of a 512-column
# panel, so about half the ticks' arrivals take the 512 class.
CONTINUOUS = dict(n_requests=6000, lam=256.0, seed=0)
# the tune phase: the reference tune arm's skewed stack
# (benchmarks/kernel_bench.py tune_arm) and RadiX-net at two challenge sizes
TUNE_SKEWED = dict(specs=(((128, 256), 100), ((128, 128), 55), ((64, 128), 28)), skew=0.3,
                   block=16, width=64, reps=3)
# (neurons, input density): at 4096 × 120 every input of a 0.3-density
# panel dies before the last layer (no category on 512 columns, in the
# oracle as in the port), so that size takes 0.35, which keeps about half
TUNE_RADIX = dict(sizes=((1024, 0.3), (4096, 0.35)), layers=120, block=16, width=512, reps=3)
RESILIENT = dict(neurons=1024, layers=120, columns=512, lr=0.02, steps=12, ckpt_interval=4,
                 nan_step=6, kill_step=8)
# the sharded phases: RadiX-net 65536 × 120 (the largest official size) served
# over a mesh of 4 shards on the one card (and, in sharded-cards, on 4 cards
# when the host has them), 8 192 inputs in 512-column panels (16 timed panels
# a route).
# At 0.3–0.4 input density no input of 16 survives to the last layer in the
# oracle; 0.45 keeps 8 of 16, so the cell takes 0.45. The oracle runs on 64
# columns (~120 × 65536 × 32 gathers a column), 8 processes of 8.
SHARDED = dict(neurons=65536, layers=120, shards=4, n_inputs=8192, density=0.45, ref_cols=64)
SHARDED_TRAIN = dict(neurons=1024, layers=120, columns=512, steps=3, lr=0.02, shards=4)
# the fleet phase: the reference's fleet arm (benchmarks/kernel_bench.py fleet_arm,
# its full config) at rate factor 4, over RadiX-net 1024 × 120
FLEET = dict(neurons=1024, layers=120, replicas=3,
             profile=dict(base=10.0, burst_rate=40.0, burst_every=2.0, burst_len=0.5),
             rate_factor=4.0, duration=8.0, width_mix=((4, 0.7), (24, 0.3)),
             width_classes=(8, 24), deadline_s=0.05, max_pending_cols=2048, seed=17,
             loss_at=100)
# the model-stack phases: Llama-3.2-1B at its published dimensions (random
# weights from MODEL_SEED), served 4 prompts of 32 tokens into a 128-position
# cache, 32 new tokens; the paper's MLP at the Fig. 5 point m = 8192,
# inverse sparsity 16 (4 blocks of 128 x 128 a block-row); the same Llama with
# its FFNs block-pruned to 4 blocks of 128 x 128 a block-row
MODEL_SEED = 0
LLM_SERVE = dict(arch="llama3.2-1b", batch=4, prompt_len=32, new_tokens=32, cache_len=128,
                 seed=MODEL_SEED)
MODEL_MLP = dict(m=8192, num_layers=8, inverse_sparsity=16, block=128, batch=64,
                 seed=MODEL_SEED)
LLM_SPARSE = dict(arch="llama3.2-1b", batch=4, prompt_len=32, block=128, blocks_per_row=4,
                  seed=MODEL_SEED)
# the training phases on the model API: model-mlp's network trained sparse, 20
# AdamW steps on one fixed batch (the reference's test_sparse_mlp_trainable).
# AdamW's first steps move every weight by about lr, so what a step does to a
# pre-activation grows with the fan-in (512 stored weights a row here, of
# scale 1/sqrt(8192)). At lr 1e-3 the loss falls to 6.92 by step 9 and then
# climbs to 38.7 by step 20, on the kernels and on the plain products alike
# (and in the reference at m = 4096 on the CPU); at 2e-4 it falls by 0.075 in
# 20 steps, at 3e-4 by 0.90 with every step lower than the one before, at 4e-4
# to 6.46 by step 19 and back up to 7.52 at step 20.
# Llama-3.2-1B at published width, the launcher's optimizer and data (global
# batch 8 of 128 tokens, 2 microbatches), dense and then with llm-sparse's FFN
# pruning; the launcher itself at --scale-down, 20 steps, stopped at 10 and resumed
MODEL_TRAIN = dict(m=8192, num_layers=8, inverse_sparsity=16, block=128, batch=64, steps=20,
                   lr=3e-4, seed=MODEL_SEED)
LLM_TRAIN = dict(arch="llama3.2-1b", seq_len=128, global_batch=8, microbatches=2, steps=5,
                 lr=3e-4, block=128, blocks_per_row=4, seed=MODEL_SEED)
LAUNCH_TRAIN = dict(arch="llama3.2-1b", steps=20, ckpt_interval=10, seed=MODEL_SEED)
# llm-train and launch-train over the model's data mesh of 4 positions (one a
# card on a host with 4, else all on card 0), 3 steps each model
LLM_TRAIN_DATA = dict(LLM_TRAIN, steps=3, positions=4)
LAUNCH_TRAIN_DATA = dict(LAUNCH_TRAIN, positions=4)
# llm-train over the model's 2 x 2 data x model mesh (4 cards when the host has
# them, else the 4 positions on card 0), 3 steps each model; then Moonlight's
# MoE at published width cut to its dense first layer and one MoE layer
# then the other mixers at published width, cut in depth to fit one card with
# every position's state: one f32 step each held against one position, one step
# timed; Jamba's layer again with its FFN pruned (the SpMM kernels on each
# group's home card)
MIXER_CUTS = {"deepseek-v2-236b": dict(num_layers=1),  # its dense first layer (MLA)
              "jamba-v0.1-52b": dict(num_layers=1, period=1),  # a Mamba layer, dense FFN
              "rwkv6-3b": dict(num_layers=8)}
# RWKV-6's f32 gradients on the card move by 3.9e-4 (1 layer) and 4.5e-3 (8
# layers) of a leaf's max between one position and the data mesh, which splits
# nothing over model, and lie 1.3e-7 apart in f64 (tools/torch_rwkv_spread.py;
# PERF.md, PR 26): its f32 arithmetic amplifies rounding with depth. So its
# first step is held in f64 (f64_casts), and at f32 its loss is held and its
# gradients measured beside the data mesh's own spread
MIXER_HELD_IN_F64 = ("rwkv6-3b",)
# the MoE's step whose token groups cross data indices: a global batch of 4 rows
# in 2 microbatches puts one row of 128 tokens a data index (groups of 128)
# against the microbatch's groups of 256
MOE_CROSSING = dict(global_batch=4, microbatches=2)
LLM_TRAIN_MODEL = dict(LLM_TRAIN, steps=3, data=2, model=2, moe_arch="moonshot-v1-16b-a3b",
                       moe_layers=2, moe_crossing=MOE_CROSSING, mixers=MIXER_CUTS,
                       pruned_mixer="jamba-v0.1-52b", seq_mixers=("jamba-v0.1-52b",))
# serving over the model's mesh: llm-serve's Llama-3.2-1B over the 2 x 2 data x
# model mesh (model_mesh), 4 prompts of 48 tokens into a 128-slot cache (64 slots
# a model position) and 40 greedy new tokens, so the decode crosses from model
# position 0's slot range into position 1's at position 64; the same weights
# with every FFN pruned; then MIXER_CUTS and Gemma-3-4B cut to one period (5
# local layers of window 1024 and a global one) on data 1 x model 2, Gemma's
# 1 100-token prompt into 1 280 slots, so its local ring wraps and is split
SERVE_MIXER_CUTS = {**MIXER_CUTS, "gemma3-4b": dict(num_layers=6, tail=0)}
SERVE_LONG = {"gemma3-4b": dict(cache_len=1280, prompt_len=1100, new_tokens=8)}
# and Moonlight at published width cut to its dense first layer and one MoE
# layer (64 experts, top 6, two shared; 1.345 B parameters) on the same mesh and
# prompts: prefill token groups of 64 where a data index's 96 tokens make 32,
# decode groups of 4 where a data index's 2 rows make 2 (capacity 1 an expert),
# so each MoE layer runs once on group 0's home over both data indices' rows
SERVE_MOE = dict(arch="moonshot-v1-16b-a3b", num_layers=2, new_tokens=8)
LLM_SERVE_MODEL = dict(arch="llama3.2-1b", data=2, model=2, batch=4, cache_len=128,
                       prompt_len=48, new_tokens=40, block=128, blocks_per_row=4,
                       pruned_tokens=4, mixers=SERVE_MIXER_CUTS, long=SERVE_LONG,
                       moe=SERVE_MOE, seed=MODEL_SEED)
# sequence parallelism over model (ShardingRules(seq_axis="model")): the split
# f32 step against the unsplit one on the same mesh, the loss bits equal and
# each gradient within this of its leaf's max (the norms' scales add their
# chunks' partials in model order where the unsplit step sums every row at once)
SPLIT_GRAD_RTOL = 1e-6
LOSS_RTOL = 1e-5  # f32 compute: the tests' loss tolerance (tests/_torch_train.py)
# logits, per row: max|got - want| <= tol x max|want|. bf16 compute: 2e-2 (the
# reference's decode/forward tolerance, tests/test_arch_smoke.py, taken against
# the row's scale: at published width two bf16 forwards of 32 and 33 tokens
# already differ by 1.2% of it at one position, 0.05 on logits up to ~5, so
# its elementwise form cannot hold); f32 compute on the same weights: 1e-4
LLM_TOL, LLM_F32_TOL = 2e-2, 1e-4
# the dryrun phase: the dry run's records of every arch's decode_32k and
# long_500k, then Llama-3.2-1B's prefill_32k, decode_32k and train_4k, each at
# the largest batch whose dry-run peak fits the card's free memory less
# DRYRUN_MARGIN_BYTES (kernel code loaded at first use), and Gemma-3-4B's
# long_500k at full size, run on the card at full sequence length and held to
# the dry run: FLOPs equal, peak within DRYRUN_PEAK_RTOL. decode_32k's cache is
# a real prefill of S - 1 positions of DRYRUN["decode_rows"] prompts, tiled
DRYRUN = dict(arch="llama3.2-1b", long_arch="gemma3-4b", decode_rows=2, seed=MODEL_SEED)
DRYRUN_PEAK_RTOL = 0.10
# the dryrun phase's mesh cells: Llama-3.2-1B's train_4k and decode_32k on the
# 2 x 2 data x model mesh, traced through the mesh path on meta
# (dryrun.mesh_trace) at the largest batch whose traced peak for the whole
# device fits, then run on 4 positions of card 0 (tools/torch_cards_run.py
# dryrun-cards: one card a position). train_4k is cut to 8 of 16 layers: at
# full depth one sequence a group already needs 85.3 GiB over the 4 positions
# (80.1 GiB with the positions' copies shared), more than the card holds
DRYRUN_MESH = dict(arch="llama3.2-1b", data=2, model=2, train_layers=8, seed=MODEL_SEED)
# the MoE archs' pod decode records (~40-55 s each on the chip host, each MoE
# layer gathering every group's rows on position 0) trace in a process of
# their own from the script's start, beside the kernels' build, the kernels
# phase (CUDA events) and the dry run, and are joined before the first phase
# that reads the host's clock; every other pod record traces in the dry run's
# own pool. In that pool too they made it the dry run's longest chain
# (PERF.md, PR 30)
POD_MOE = (("deepseek-v2-236b", "decode_32k"), ("moonshot-v1-16b-a3b", "decode_32k"),
           ("jamba-v0.1-52b", "decode_32k"))
DRYRUN_MARGIN_BYTES = 2**30
WIDTH_CLASSES = (64, 128, 256, 512)
HOST_SHARE_REPEATS = 5  # captured and eager forwards, interleaved
# the graphblas phase's adjacency: random_skewed(SKEWED_SEED, (m, m), (16, 16), blocks, skew)
SKEWED_M, SKEWED_BLOCKS, SKEWED_SKEW, SKEWED_SEED = 8192, 8192, 0.8, 5
KERNEL_SOURCES = {
    "semiring_matmul": ("src/repro_torch/csrc/semiring_matmul.cu",
                        "src/repro/kernels/semiring_matmul.py:112"),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu", "src/repro/kernels/bsr_spmm.py:142"),
    "bcsr_spmm": ("src/repro_torch/csrc/bcsr_spmm.cu", "src/repro/kernels/bcsr_spmm.py:165"),
    "fused_mlp_forward": ("src/repro_torch/csrc/fused_mlp.cu",
                          "src/repro/kernels/fused_mlp.py:214"),
    "fused_mlp_tiled_forward": ("src/repro_torch/csrc/fused_mlp.cu",
                                "src/repro/kernels/fused_mlp.py:409"),
}


def check(ok: bool, detail) -> None:
    """Fail the run (a raised error, so the exit code is not 0)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {detail}")


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (seconds since
    the script started)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def gpu_time_ms(fn, *, per_rep: int, reps: int) -> float:
    """Median device time of one call of ``fn``: each repetition queues
    ``per_rep`` calls behind a sleep kernel (so host overhead is hidden)
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nonzero_weights(a) -> int:
    """Nonzero values in the stored (valid) blocks of a BSR, block-CSR or
    stacked BSR matrix: the products a panel column needs."""
    import torch

    blocks, keep = (a.values, a.valid) if hasattr(a, "row_ptr") else (a.blocks, a.block_mask)
    return int(torch.count_nonzero(blocks * keep[..., None, None]))


def spmm_work(a, n: int, semiring: str = "plus_times") -> tuple[float, float]:
    """(bytes, ops) one fused SpMM layer needs on an (k, n) panel."""
    m, k = a.shape
    bs_r, bs_c = a.block_shape
    # the index arrays the launch reads: row_ptr/col_idx/valid or col_idx/mask
    index = (a.row_ptr, a.col_idx, a.valid) if hasattr(a, "row_ptr") else (
        a.col_idx, a.block_mask)
    index_bytes = sum(t.numel() * t.element_size() for t in index)
    valid = a.nnz_blocks()
    nbytes = valid * bs_r * bs_c * 4 + index_bytes + k * n * 4 + m * 4 + m * n * 4
    weights = nonzero_weights(a) if semiring == "plus_times" else valid * bs_r * bs_c
    return nbytes, 2.0 * weights * n


def stored_work(a, n: int) -> float:
    """Operations a kernel folds for an (·, n) panel: 2 per stored
    weight (zeros inside stored blocks included) and column."""
    bs_r, bs_c = a.block_shape
    return 2.0 * a.nnz_blocks() * bs_r * bs_c * n


def rates(ms: float, work: float, library_ms) -> dict:
    """The work folded per second, and the time against the library's."""
    return {"tflops": work / ms / 1e9,
            "vs_library": None if library_ms is None else ms / library_ms}


def dense_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(bytes, ops) of one dense (m, k) × (k, n) product with its bias."""
    return 4.0 * (m * k + k * n + m + m * n), 2.0 * m * k * n


def stack_work(stacked_w, n: int) -> tuple[float, float]:
    """(bytes, flops) of a whole fused stack on an (m, n) panel."""
    n_layers, nrb, mbpr = stacked_w.col_idx.shape
    m = stacked_w.shape[0]
    bs = stacked_w.block_shape[0]
    valid = stacked_w.nnz_blocks()
    nbytes = (valid * bs * bs * 4 + n_layers * nrb * mbpr * 5
              + n_layers * m * 4 + 2 * m * n * 4)
    return nbytes, 2.0 * nonzero_weights(stacked_w) * n


def f32_chain_bound(weights, biases, y0):
    """(Y, e): the exact forward pass of a BSR stack on ``y0``, to f64
    rounding, and an elementwise bound ``e`` on |f32 evaluation - Y| for
    any summation order. A layer output sums at most n nonzero products
    and the bias, so its rounding error is at most
    gamma x (|W|·|Y_f32| + |b|), gamma = (n+1)u / (1 - (n+1)u), u = 2^-24
    (the dot-product bound of Higham, Accuracy and Stability of Numerical
    Algorithms, §3.1); |Y_f32| <= |Y| + e, earlier errors carry through
    |W|, and ReLU is 1-Lipschitz."""
    import torch

    from repro_torch.sparse import ops as sparse_ops
    from repro_torch.sparse.bsr import BlockSparseMatrix

    u = 2.0 ** -24
    y = y0.double()
    e = torch.zeros_like(y)
    per_weight = {}  # RadiX-net layers of one phase share one matrix
    for w, b in zip(weights, biases):
        if id(w) not in per_weight:
            nz = (w.blocks != 0) & w.block_mask[..., None, None]
            terms = int(nz.sum(dim=(1, 3)).max()) + 1
            per_weight[id(w)] = (
                BlockSparseMatrix(w.blocks.double(), w.col_idx, w.block_mask, w.shape,
                                  w.block_shape),
                BlockSparseMatrix(w.blocks.double().abs(), w.col_idx, w.block_mask, w.shape,
                                  w.block_shape),
                terms * u / (1 - terms * u),
            )
        w64, abs_w64, gamma = per_weight[id(w)]
        b64 = b.double()[:, None]
        z = sparse_ops.bsr_matmul(w64, y) + b64
        e = (sparse_ops.bsr_matmul(abs_w64, e)
             + gamma * (sparse_ops.bsr_matmul(abs_w64, y.abs() + e) + b64.abs()))
        y = torch.clamp_min(z, 0)
    return y, e


def col_rel(got, want) -> float:
    """Worst column's max |got - want| over that column's max |want|
    (columns where ``want`` is all zero are left out)."""
    col_diff, col_scale = (got - want).abs().amax(dim=0), want.abs().amax(dim=0)
    live = col_scale > 0
    return float((col_diff[live] / col_scale[live]).max()) if bool(live.any()) else 0.0


def errors(got, want) -> dict:
    """Largest absolute error, the worst live column's relative error
    (``col_rel``) and the largest error in a dead (all-zero) column."""
    col_diff, dead = (got - want).abs().amax(dim=0), want.abs().amax(dim=0) == 0
    return {"max_abs_err": float(col_diff.max()),
            "max_col_rel_err": col_rel(got, want),
            "dead_col_abs_err": float(col_diff[dead].max()) if bool(dead.any()) else 0.0}


def columns_within(got, want, rtol: float, atol: float) -> bool:
    """Every column: max_i |got - want| <= rtol * max_i |want| + atol."""
    col_diff = (got - want).abs().amax(dim=0)
    return bool((col_diff <= rtol * want.abs().amax(dim=0) + atol).all())


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU host")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    logs = build.build()
    report = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "smem" in ln]
        for name, log in logs.items()
    }
    # every kernel is register-tiled over cp.async stages: none may spill
    for source in sorted({os.path.basename(src)[:-3] for src, _ in KERNEL_SOURCES.values()}):
        spills = [int(v) for ln in report[source] for v in re.findall(r"(\d+) bytes spill", ln)]
        check(spills and not any(spills), (source, "spills registers", spills))
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_seconds": time.perf_counter() - t0,
        "ptxas": report,
    }
    emit(info)
    return info


def phase_kernels() -> dict:
    """Each kernel against its plain version at the serving shapes."""
    import torch

    from repro_torch.core.dnn import stack_bsr
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain, piece_table
    from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
    from repro_torch.kernels.fused_mlp import card_geometry, fused_mlp_plain
    from repro_torch.kernels.semiring_matmul import semiring_matmul_plain
    from repro_torch.plan.layout import preferred_layout
    from repro_torch.sparse.bcsr import BlockCSRMatrix

    dev = torch.device("cuda")
    n = 512
    out = {}
    spec = rx.RadixNetSpec(1024, 120)
    weights, biases = rx.radixnet_weights(spec, device=dev)
    ell = weights[1]  # stride-32 phase: 32 stored diagonal blocks per row
    csr = BlockCSRMatrix.from_bsr(weights[0])  # stride-1 phase, as relayouted
    check(preferred_layout(ell) == "ell" and preferred_layout(weights[0]) == "bcsr",
          "RadiX-net 1024 phase layouts")
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((1024, n), dtype=np.float32)).to(dev)
    y_narrow = y[:, :NARROW_N].contiguous()
    b = biases[0]

    for name, a, kern, plain in (
        ("bsr_spmm", ell, ops.bsr_spmm, bsr_spmm_plain),
        ("bcsr_spmm", csr, ops.bcsr_spmm, bcsr_spmm_plain),
    ):
        got = kern(a, y, b, fuse_bias_relu=True)
        want = plain(a, y, b, fuse_bias_relu=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
        dense = a.to_dense()
        bias_col = b[:, None]
        lib = torch.addmm(bias_col, dense, y)  # yardstick only: no ReLU
        torch.testing.assert_close(torch.clamp_min(lib, 0), want, rtol=SPMM_RTOL,
                                   atol=SPMM_ATOL)
        nbytes, flops = spmm_work(a, n)
        bms, by = bound(nbytes, flops)
        ms = gpu_time_ms(lambda: kern(a, y, b, fuse_bias_relu=True), per_rep=20, reps=5)
        library_ms = gpu_time_ms(lambda: torch.addmm(bias_col, dense, y), per_rep=20, reps=5)
        out[name] = {
            **errors(got, want),
            "ms": ms,
            "plain_ms": gpu_time_ms(lambda: plain(a, y, b, fuse_bias_relu=True),
                                    per_rep=5, reps=5),
            "library_ms": library_ms, **rates(ms, stored_work(a, n), library_ms),
            "bound_ms": bms, "bound_by": by, "shape": [1024, 1024, n],
            "stored_blocks": a.nnz_blocks(), "nonzero_weights": nonzero_weights(a),
        }
        out[name]["narrow"] = panel_timing(kern, plain, a, dense, y_narrow, b,
                                           stored_work(a, NARROW_N), spmm_work(a, NARROW_N))

    # bcsr_spmm where its work is: the stride-32 layer as block-CSR, and the
    # graphblas phase's skewed adjacency (long block-rows cut into pieces)
    stride32 = BlockCSRMatrix.from_bsr(ell)
    out["bcsr_spmm"]["stride32"] = {
        "stored_blocks": stride32.nnz_blocks(), "pieces": piece_table(stride32).n_pieces,
        "n512": panel_timing(ops.bcsr_spmm, bcsr_spmm_plain, stride32, ell.to_dense(), y, b,
                             stored_work(stride32, n), spmm_work(stride32, n))}
    skewed = BlockCSRMatrix.random_skewed(SKEWED_SEED, (SKEWED_M, SKEWED_M), (16, 16),
                                          SKEWED_BLOCKS, skew=SKEWED_SKEW, device=dev)
    table = piece_table(skewed)
    g = torch.Generator(device=dev).manual_seed(SKEWED_SEED)
    skew_y = torch.rand((SKEWED_M, 256), generator=g, device=dev)
    skew_b = torch.randn((SKEWED_M,), generator=g, device=dev)
    skew_dense = skewed.to_dense()
    out["bcsr_spmm"]["skewed"] = {
        "shape": [SKEWED_M, SKEWED_M], "stored_blocks": skewed.nnz_blocks(),
        "pieces": table.n_pieces, "cut_rows": table.n_cut_rows,
        "cut_pieces": table.n_cut_pieces,
        **{f"n{w}": panel_timing(ops.bcsr_spmm, bcsr_spmm_plain, skewed, skew_dense,
                                 skew_y[:, :w].contiguous(), skew_b, stored_work(skewed, w),
                                 spmm_work(skewed, w))
           for w in (256, NARROW_N)}}
    del skew_dense

    # the paper's 128 x 128 blocks (a train-paper layer's shape), which the
    # wrappers launch re-tiled (kernels.retile): 64 x 64 sub-blocks here
    from repro_torch.kernels import retile
    from repro_torch.kernels.bsr_spmm import tile_for

    m, bs, bpr, n_paper = PAPER_TRAIN["m"], PAPER_TRAIN["block"], 8, PAPER_TRAIN["batch"]
    gp = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    paper = block_ell(gp, m, bs, bpr, dev)
    paper_y = torch.rand((m, n_paper), generator=gp, device=dev)
    paper_b = torch.rand((m,), generator=gp, device=dev)
    paper_dense = paper.to_dense()
    for name, kern, plain, a in (
        ("bsr_spmm", ops.bsr_spmm, bsr_spmm_plain, paper),
        ("bcsr_spmm", ops.bcsr_spmm, bcsr_spmm_plain, BlockCSRMatrix.from_bsr(paper)),
    ):
        out[name]["block128"] = {
            "shape": [m, m, n_paper], "block": [bs, bs], "stored_blocks": a.nnz_blocks(),
            "launched_block": list(retile.launch_block_shape(tile_for(n_paper), bs, bs)[:2]),
            **panel_timing(kern, plain, a, paper_dense, paper_y, paper_b,
                           stored_work(a, n_paper), spmm_work(a, n_paper))}
    del paper_dense

    # dense: a densified stride-32 layer, as the dense phase runs it
    w_dense = ell.to_dense()
    got = ops.semiring_matmul(w_dense, y, b, fuse_bias_relu=True)
    want = semiring_matmul_plain(w_dense, y, b, fuse_bias_relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
    bias_col = b[:, None]
    bms, by = bound(*dense_work(1024, 1024, n))
    ms = gpu_time_ms(lambda: ops.semiring_matmul(w_dense, y, b, fuse_bias_relu=True),
                     per_rep=10, reps=5)
    library_ms = gpu_time_ms(lambda: torch.addmm(bias_col, w_dense, y), per_rep=10, reps=5)
    out["semiring_matmul"] = {
        **errors(got, want),
        "ms": ms,
        "plain_ms": gpu_time_ms(lambda: semiring_matmul_plain(w_dense, y, b, fuse_bias_relu=True),
                                per_rep=10, reps=5),
        "library_ms": library_ms, **rates(ms, dense_work(1024, 1024, n)[1], library_ms),
        "bound_ms": bms, "bound_by": by, "shape": [1024, 1024, n],
        "narrow": panel_timing(ops.semiring_matmul, semiring_matmul_plain, w_dense, w_dense,
                               y_narrow, b, dense_work(1024, 1024, NARROW_N)[1],
                               dense_work(1024, 1024, NARROW_N)),
    }
    out["semirings"] = semiring_checks(weights[1], dev, n)

    # fused, resident: the whole 1024 x 120 stack on the first 512 inputs
    panel = rx.radixnet_input_panel(1024, 60000, density=0.3, seed=0)[:, :WIDE]
    wide_y0 = torch.from_numpy(np.ascontiguousarray(panel)).to(dev)
    y0 = wide_y0[:, :n].contiguous()
    sw, sb = stack_bsr(weights), torch.stack(biases)
    big_spec = rx.RadixNetSpec(16384, 120)
    big_w, big_b = rx.radixnet_weights(big_spec, device=dev)
    bsw, bsb = stack_bsr(big_w), torch.stack(big_b)
    big_wide_y0 = torch.from_numpy(
        rx.radixnet_input_panel(16384, WIDE, density=0.4, seed=0)).to(dev)
    big_y0 = big_wide_y0[:, :n].contiguous()
    for name, kern, args, wide, layer_w, layer_b in (
        ("fused_mlp_forward", ops.fused_mlp_forward, (sw, sb, y0), wide_y0, weights, biases),
        ("fused_mlp_tiled_forward", ops.fused_mlp_tiled_forward, (bsw, bsb, big_y0),
         big_wide_y0, big_w, big_b),
    ):
        got = kern(*args)
        want = fused_mlp_plain(*args)
        torch.cuda.synchronize()
        err = errors(got, want)
        exact, e = f32_chain_bound(layer_w, layer_b, args[2])
        slack = 2 * e + STACK_ATOL
        err["bound_share"] = float(((got.double() - want.double()).abs() / slack).max())
        err["col_rel_err_vs_exact"] = {"kernel": col_rel(got.double(), exact),
                                       "plain": col_rel(want.double(), exact)}
        check(err["max_abs_err"] <= STACK_RTOL * float(want.abs().max()), (name, err))
        check(err["bound_share"] <= 1.0, (name, err))
        cats_got = rx.reference_categories(got.cpu().numpy())
        cats_want = rx.reference_categories(want.cpu().numpy())
        check(np.array_equal(cats_got, cats_want), (name, cats_got, cats_want))
        check(0 < len(cats_want) < n, (name, len(cats_want)))
        # bf16 panels, compared in the working type, at a cut depth
        cut_w = type(args[0])(args[0].blocks[:BF16_DEPTH], args[0].col_idx[:BF16_DEPTH],
                              args[0].block_mask[:BF16_DEPTH], args[0].shape,
                              args[0].block_shape)
        cut = (cut_w, args[1][:BF16_DEPTH], args[2])
        got16 = kern(*cut, panel_dtype="bfloat16")
        want16 = fused_mlp_plain(*cut, panel_dtype="bfloat16")
        err16 = errors(got16, want16)
        rtol16 = BF16_ULPS * 2.0 ** -8
        check(columns_within(got16, want16, rtol16, STACK_ATOL), (name, err16, rtol16))
        nbytes, flops = stack_work(args[0], n)
        bms, by = bound(nbytes, flops)
        reps = 3
        ms = gpu_time_ms(lambda: kern(*args), per_rep=1, reps=reps)
        tiled = name == "fused_mlp_tiled_forward"
        geo, at_once = card_geometry(args[0], n, tiled=tiled, device=dev)
        wide_geo, _ = card_geometry(args[0], WIDE, tiled=tiled, device=dev)
        wide_ms = gpu_time_ms(lambda: kern(args[0], args[1], wide), per_rep=1, reps=reps)
        out[name] = {
            **err,
            "categories": int(len(cats_want)),
            "bf16": {**err16, "rtol": rtol16, "layers": BF16_DEPTH},
            "ms": ms,
            "plain_ms": gpu_time_ms(lambda: fused_mlp_plain(*args), per_rep=1, reps=reps),
            "library_ms": None, **rates(ms, stored_work(args[0], n), None),
            "bound_ms": bms, "bound_by": by,
            "shape": [args[0].shape[0], int(args[1].shape[0]), n],
            "stored_blocks": args[0].nnz_blocks(),
            "nonzero_weights": nonzero_weights(args[0]),
            "weight_bytes_per_stripe": args[0].nnz_blocks() * 4 * args[0].block_shape[0] ** 2,
            "cluster": geo.cluster, "ctas": geo.ctas, "smem_bytes": geo.smem_bytes,
            # resident: clusters of this size the card holds at once; tiled: CTAs an SM holds
            ("clusters_at_once" if not tiled else "ctas_per_sm"): at_once,
            # occupancy probe: the same stack on a 4x wider panel (4x the work); a
            # ratio near 4 says the 512-column launch already fills the card
            "wide": {"columns": WIDE, "cluster": wide_geo.cluster, "ctas": wide_geo.ctas,
                     "ms": wide_ms, "ratio_to_512": wide_ms / ms},
        }
    emit({"phase": "kernels", **out})
    return out


def panel_timing(kern, plain, a, dense, y, b, work: float, bytes_ops) -> dict:
    """A kernel on one more panel (an 8-column one runs the narrow tile):
    checked against the plain version, timed beside it and beside one
    ``torch.addmm`` of the same product on ``dense``, ``a``'s dense form."""
    import torch

    got = kern(a, y, b, fuse_bias_relu=True)
    want = plain(a, y, b, fuse_bias_relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
    bias_col = b[:, None]
    ms = gpu_time_ms(lambda: kern(a, y, b, fuse_bias_relu=True), per_rep=20, reps=5)
    library_ms = gpu_time_ms(lambda: torch.addmm(bias_col, dense, y), per_rep=20, reps=5)
    bms, by = bound(*bytes_ops)
    return {**errors(got, want), "n": int(y.shape[1]), "ms": ms,
            "plain_ms": gpu_time_ms(lambda: plain(a, y, b, fuse_bias_relu=True),
                                    per_rep=5, reps=5),
            "library_ms": library_ms, **rates(ms, work, library_ms),
            "bound_ms": bms, "bound_by": by}


def semiring_checks(topology, dev, n: int) -> dict:
    """The three semiring kernels in all eight semirings against their
    plain versions, on integer-valued operands: a RadiX-net topology
    (the stride-32 phase at 1024 × 1024, block 16) with block-row 1
    emptied and the last four slots of block-row 2 turned into ELL pad
    slots, its block-CSR form with two tail slots, a dense matrix of the
    same shape, and a (k, n) panel, all with values in [-3, 3]. Exact (integer sums
    stay far below 2^24), ``log_plus`` within LOG_PLUS_TOL."""
    import torch

    from repro_torch.core.semiring import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
    from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
    from repro_torch.kernels.semiring_matmul import semiring_matmul_plain
    from repro_torch.kernels.semirings import kernel_zero
    from repro_torch.sparse.bcsr import BlockCSRMatrix
    from repro_torch.sparse.bsr import BlockSparseMatrix

    g = torch.Generator(device=dev).manual_seed(3)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=g, device=dev).float()

    mask = topology.block_mask.clone()
    mask[1] = False
    mask[2, -4:] = False
    blocks = torch.where(mask[:, :, None, None], ints(*topology.blocks.shape), 0.0)
    col_idx = torch.where(mask, topology.col_idx, 0)
    ell = BlockSparseMatrix(blocks, col_idx, mask, topology.shape, topology.block_shape)
    csr = BlockCSRMatrix.from_bsr(ell, pad_to=ell.nnz_blocks() + 2)
    m, k = topology.shape
    dense, y = ints(m, k), ints(k, n)
    check(not bool(ell.block_mask.all()) and int(csr.valid.sum()) == csr.total_blocks - 2,
          "semiring operands carry pad slots and tail slots")
    results = {}
    for kname, kern, plain, a in (
        ("semiring_matmul", ops.semiring_matmul, semiring_matmul_plain, dense),
        ("bsr_spmm", ops.bsr_spmm, bsr_spmm_plain, ell),
        ("bcsr_spmm", ops.bcsr_spmm, bcsr_spmm_plain, csr),
    ):
        per = {}
        for name in sorted(REGISTRY):
            got = kern(a, y, semiring_name=name)
            want = plain(a, y, semiring_name=name)
            torch.cuda.synchronize()
            diff = (got - want).abs().nan_to_num(nan=float("inf"))
            finite = torch.isfinite(want)
            err = float(diff[finite].max()) if bool(finite.any()) else 0.0
            same_inf = bool(torch.equal(got[~finite], want[~finite]))
            if name == "log_plus":
                ok = same_inf and bool((diff[finite] <= LOG_PLUS_TOL * (1 + want[finite].abs())).all())
                rule = f"within {LOG_PLUS_TOL} (rtol and atol)"
            else:
                ok = bool(torch.equal(got, want))
                rule = "bit-exact"
            check(ok, (kname, name, err))
            if a is not dense:
                check(bool((got[16:32] == kernel_zero(name)).all()), (kname, name, "empty row"))
            nbytes, ops_ = dense_work(m, k, n) if a is dense else spmm_work(a, n, name)
            bms, by = bound(nbytes, ops_)
            library = None
            if name == "plus_times":
                lib_a = a if a is dense else a.to_dense()
                library = gpu_time_ms(lambda: torch.matmul(lib_a, y), per_rep=5, reps=3)
            ms = gpu_time_ms(lambda: kern(a, y, semiring_name=name), per_rep=5, reps=3)
            work = dense_work(m, k, n)[1] if a is dense else stored_work(a, n)
            per[name] = {
                "max_abs_err": err, "check": rule, "ms": ms,
                "plain_ms": gpu_time_ms(lambda: plain(a, y, semiring_name=name),
                                        per_rep=2, reps=3),
                "bound_ms": bms, "bound_by": by, "library_ms": library,
                **rates(ms, work, library),
            }
        results[kname] = per
    return results


def plan_launches(cache) -> dict:
    """Per kernel, the launches the cached plans ran: each plan's captured
    forward (its per-replay launches) times its warm-ups and replays."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.KERNELS, 0)
    for plan in cache.plans():
        for name, k in (plan.captured_launches or {}).items():
            want[name] += k * (plan.warmups + plan.replays)
    return want


def plan_summaries(cache) -> list:
    return [{k: plan.describe()[k] for k in ("width", "route", "executable", "compiles",
                                              "warmups", "replays", "kernel_launches")}
            for plan in cache.plans()]


def measured_replay(plan) -> dict:
    """One more replay of ``plan`` (a zero panel of its width): the kernel
    nodes of its captured graph, read through libcuda
    (``plan.graph_launches``), must be the launches the capture recorded
    and the counts the wrappers' accounting added for the replay."""
    import torch

    from repro_torch.kernels import ops

    y = torch.zeros((plan.weights[0].shape[1], plan.width), device="cuda")
    before, replays = ops.launch_counts(), plan.replays
    plan.forward(y)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    counted = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    in_graph = {k: v for k, v in plan.graph_launches.items() if v}
    captured = {k: v for k, v in plan.captured_launches.items() if v}
    check(plan.replays == replays + 1 and in_graph == captured == counted,
          ("a replay's kernels, graph nodes / captured / counted", in_graph, captured, counted))
    return {"route": plan.route, "width": plan.width, "graph_kernel_nodes": in_graph,
            "counted": counted}


def check_captured(cache, counts) -> dict:
    """Every plan captured once, and the launches are the plans'
    warm-ups and replays, no more and no fewer. Returns the plans'
    summaries as served and, for one plan of each route, a replay checked
    against its graph's kernel nodes (``measured_replay``): the replays'
    share of the counts rests on what the graph holds."""
    summaries = plan_summaries(cache)
    for plan in cache.plans():
        check(plan.describe()["executable"] == "cuda-graph" and plan.compile_count == 1
              and plan.warmups == 1, plan.describe())
    check(counts == plan_launches(cache), ("launches = warm-ups + replays", counts,
                                           plan_launches(cache)))
    by_route = {plan.route: plan for plan in cache.plans()}
    return {"plans": summaries,
            "replays_measured": [measured_replay(plan) for plan in by_route.values()]}


def phase_serve(spec, *, n_inputs, use_resident, density, ref_cols, route, level,
                kernels, panel_dtype=None):
    """``run_challenge`` through an engine built here (so its plans can be
    read): routes, levels, answer set, and the launches its captured plans
    ran. Returns the phase's line, the engine and the result."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import SparseDNNEngine, run_challenge

    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(spec, device=dev)
    engine = SparseDNNEngine(weights, biases, batch_align=32, use_resident=use_resident,
                             device=dev, panel_dtype=panel_dtype)
    ops.reset_launch_counts()
    res = run_challenge(spec, n_inputs=n_inputs, density=density, engine=engine)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    check(res.routes == (route,), ("routes", res.routes))
    check(res.levels == (level,), ("levels", res.levels))
    check(res.served == n_inputs, ("served", res.served))
    for name in kernels:
        check(counts[name] > 0, (name, counts))
    captured = check_captured(engine.plan_cache, counts)
    panel = rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=0)
    ref_y, ref_cats = rx.radixnet_reference(spec, np.ascontiguousarray(panel[:, :ref_cols]))
    check(np.isfinite(ref_y).all(), "finite reference activations")
    check(0 < len(ref_cats) < ref_cols, ("nondegenerate answer set", len(ref_cats)))
    got = res.categories[res.categories < ref_cols]
    if panel_dtype is None:
        check(np.array_equal(got, ref_cats), (got, ref_cats))
    info = {
        "spec": [spec.neurons, spec.layers], "n_inputs": n_inputs, "density": density,
        "routes": list(res.routes), "levels": list(res.levels), "steps": res.steps,
        "width_classes": list(res.width_classes), "launches": counts, **captured,
        "seconds": res.seconds, "edge_inputs_per_sec": res.edge_inputs_per_sec,
        "categories": int(len(res.categories)), "reference_columns": ref_cols,
        "reference_categories": int(len(ref_cats)),
        "reference_categories_matched": int(len(np.intersect1d(got, ref_cats))),
    }
    return info, engine, res


def eager_forward(plan, y):
    """A layered plan's layer loop, called eagerly through ``kernel_ops``
    from this script: what the plan's captured graph replays."""
    from repro_torch.kernels import ops

    kernel = {"kernel-bcsr": ops.bcsr_spmm, "kernel-ell": ops.bsr_spmm,
              "kernel-dense": ops.semiring_matmul}
    for lp, w, b in zip(plan.layers, plan.weights, plan.biases):
        y = kernel[lp.path](w, y, b, fuse_bias_relu=True)
    return y


def wall_ms(fn) -> float:
    """Host milliseconds of ``fn`` from a synchronised start to its end on
    the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def host_share(plan, y, *, other=None) -> dict:
    """The captured ``plan.forward`` against the same layer loop called
    eagerly (and ``other``, a second eager forward of the same function,
    when given), interleaved ``HOST_SHARE_REPEATS`` times on the host
    clock, beside the kernels' CUDA-event time. The replay must give the
    eager loop's bits."""
    import torch

    got, want = plan.forward(y), eager_forward(plan, y)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "a replay gives the eager forward's bits")
    arms = {"eager": lambda: eager_forward(plan, y), "captured": lambda: plan.forward(y)}
    if other is not None:
        arms["other"] = other
    times = {name: [] for name in arms}
    for _ in range(HOST_SHARE_REPEATS):
        for name, fn in arms.items():
            times[name].append(wall_ms(fn))
    kernels_ms = gpu_time_ms(lambda: eager_forward(plan, y), per_rep=1, reps=3)
    return {
        "columns": int(y.shape[1]), "launches_per_forward": plan.kernel_launches,
        **{f"{name}_ms": t for name, t in times.items()},
        **{f"{name}_ms_median": statistics.median(t) for name, t in times.items()},
        "kernels_ms": kernels_ms,
        "replay_device_ms": gpu_time_ms(lambda: plan.forward(y), per_rep=1, reps=3),
    }


def _oracle_chunk(job):
    """The numpy oracle's final activations and categories on one chunk of
    panel columns (run in a worker process)."""
    from repro_torch.data import radixnet as rx

    neurons, layers, chunk = job
    return rx.radixnet_reference(rx.RadixNetSpec(neurons, layers), chunk)


def oracle_categories(spec, panel, chunk: int = 512) -> np.ndarray:
    """``radixnet_reference``'s categories on every column of ``panel``."""
    return oracle_forward(spec, panel, chunk)[1]


def oracle_forward(spec, panel, chunk: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """``radixnet_reference``'s (final activations, categories) on every
    column of ``panel``, chunks of columns in parallel processes (the
    oracle is one numpy gather a layer, single-threaded)."""
    return oracles_ahead({"": (spec, panel, chunk)}, os.cpu_count() or 1)[""]()


def oracles_ahead(work: dict, workers: int) -> dict:
    """Each entry ``name: (spec, panel, chunk)`` of ``work`` started now, in
    that order, as :func:`oracle_forward`'s chunks on one pool of
    ``workers`` spawned processes, beside whatever the script does next;
    returns ``name:`` a function that waits for its (final activations,
    categories)."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    waits = {}
    for name, (spec, panel, chunk) in work.items():
        starts = range(0, panel.shape[1], chunk)
        futures = [pool.submit(_oracle_chunk, (spec.neurons, spec.layers,
                                               np.ascontiguousarray(panel[:, i:i + chunk])))
                   for i in starts]

        def result(futures=futures, starts=starts) -> tuple[np.ndarray, np.ndarray]:
            parts = [f.result() for f in futures]
            return (np.concatenate([y for y, _ in parts], axis=1),
                    np.concatenate([cats + i for (_, cats), i in zip(parts, starts)]))

        waits[name] = result
    pool.shutdown(wait=False)  # the workers finish the jobs, then exit
    return waits


def serve_trace(batcher, ticks, features, *, on_tick=None) -> float:
    """Serve an arrival trace through ``batcher``: ``ticks[t]`` requests
    arrive at tick t, the next columns of ``features`` in order; one
    scheduler step a tick, then a drain. Returns the host seconds to the
    last result on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = 0
    for count in ticks:
        for _ in range(count):
            batcher.submit(features[k])
            k += 1
        if on_tick is not None:
            on_tick(batcher)
        batcher.step()
    batcher.drain()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def served_categories(batcher, n: int) -> np.ndarray:
    """The challenge categories of the requests the batcher completed
    (request id = panel column)."""
    import torch

    rids = sorted(batcher.stats().latencies)
    out = torch.stack([batcher.result(r) for r in rids], dim=1)
    active = np.zeros(n, bool)
    active[rids] = (out > 0).any(dim=0).cpu().numpy()
    return np.flatnonzero(active)


def continuous_batcher(spec, **engine_kw):
    """The continuous phases' engine (resident, RadiX-net ``spec``) and
    batcher (512 slots, width classes, min_fill 0, max_wait 4)."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.serve import ContinuousBatcher, SparseDNNEngine

    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(spec, device=dev)
    engine = SparseDNNEngine(weights, biases, batch_align=32, use_resident=True, device=dev,
                             **engine_kw)
    batcher = ContinuousBatcher(engine, batch_size=512, min_fill=0.0, max_wait=4,
                                width_classes=WIDTH_CLASSES,
                                fault_injector=engine.fault_injector, clock=engine.clock)
    return engine, batcher


def trace_ticks(spec, n_requests: int, lam: float, seed: int) -> list[int]:
    """Arrivals a tick of ``poissonish_trace`` (its columns are not used:
    every request is a column of the challenge's input panel)."""
    from repro_torch.serve import poissonish_trace

    return [len(a) for a in poissonish_trace(n_requests, m=spec.neurons, lam=lam, seed=seed)]


def phase_continuous(spec, panel, ref_cats, *, n_requests, lam, seed) -> dict:
    """Continuous batching over captured plans, one per width class."""
    import torch

    from repro_torch.kernels import ops

    engine, batcher = continuous_batcher(spec)
    ticks = trace_ticks(spec, n_requests, lam, seed)
    features = torch.from_numpy(panel).to("cuda").unbind(1)
    ops.reset_launch_counts()
    seconds = serve_trace(batcher, ticks, features)
    counts = ops.launch_counts()
    stats = batcher.stats()
    check(stats.requests == n_requests and not batcher.failures, stats.summary())
    cats = served_categories(batcher, n_requests)
    check(np.array_equal(cats, ref_cats), ("continuous categories", len(cats), len(ref_cats)))
    used = sorted({r.width_class for r in stats.steps})
    check(sorted(stats.plan_recompiles_by_class) == used
          and all(v == 1 for v in stats.plan_recompiles_by_class.values()),
          ("one capture per width class", stats.plan_recompiles_by_class, used))
    check(sorted(p.width for p in engine.plan_cache.plans()) == used, plan_summaries(
        engine.plan_cache))
    captured = check_captured(engine.plan_cache, counts)
    # one miss per width class used, every other dispatch a hit: with a
    # few dozen dispatches the first-panel misses hold the rate well
    # under 1 (printed, not held to a bound)
    dispatches = len(stats.steps)
    check(stats.goodput == 1.0, stats.summary())
    check(stats.plan_cache_hit_rate == (dispatches - len(used)) / dispatches, stats.summary())
    check({r.plan_level for r in stats.steps} == {"resident"}, "resident throughout")
    return {
        "spec": [spec.neurons, spec.layers], "trace": {"n_requests": n_requests, "lam": lam,
                                                        "seed": seed, "ticks": len(ticks)},
        "batcher": {"batch_size": 512, "width_classes": list(WIDTH_CLASSES), "min_fill": 0.0,
                    "max_wait": 4},
        "summary": stats.summary(),
        "steps_by_width_class": {str(w): sum(r.width_class == w for r in stats.steps)
                                 for w in used},
        "launches": counts, **captured,
        "seconds": seconds, "edge_inputs_per_sec": spec.edges * n_requests / seconds,
        "categories": int(len(cats)), "reference_categories": int(len(ref_cats)),
    }


def phase_continuous_faults(spec, panel, ref_cats, *, n_requests, lam, seed) -> dict:
    """The continuous batcher under scheduled faults on a virtual clock."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import VirtualClock
    from repro_torch.testing import faults

    inj = faults.FaultInjector(seed=seed)
    inj.schedule(faults.SITE_PANEL_NANS, 2, count=3)
    inj.schedule(faults.SITE_STEP_TRANSIENT, 4, failures=1)
    inj.schedule(faults.SITE_PLAN_COMPILE, 6)
    clock = VirtualClock()
    engine, batcher = continuous_batcher(spec, fault_injector=inj, clock=clock,
                                         retry_backoff_s=0.05)
    ticks = trace_ticks(spec, n_requests, lam, seed)
    features = torch.from_numpy(panel).to("cuda").unbind(1)

    demoted_at = []

    def restore_later(b):  # an operator re-admits the resident level 8 ticks on
        if engine.ladder.degraded:
            demoted_at.append(b.tick)
            if b.tick >= demoted_at[0] + 8:
                engine.ladder.restore("resident", reason="operator restore", step=b.tick)

    ops.reset_launch_counts()
    seconds = serve_trace(batcher, ticks, features, on_tick=restore_later)
    counts = ops.launch_counts()
    stats = batcher.stats()
    quarantined = sorted(r for r, why in batcher.failures.items() if "quarantined" in why)
    poisoned = min(3, stats.steps[2].occupancy)  # dispatch 2's panel, 3 columns at most
    check(len(quarantined) == len(batcher.failures) == poisoned
          and set(quarantined) <= set(stats.steps[2].request_ids), batcher.failures)
    check(stats.faults.retried_steps == 1 and stats.faults.failed == 0, stats.summary())
    check(clock.sleeps == [0.05], ("backoff on the virtual clock", clock.sleeps))
    check([(e.level, e.healthy) for e in engine.ladder.events]
          == [("resident", False), ("resident", True)], engine.ladder.describe())
    levels = [r.plan_level for r in stats.steps]
    first_layered = levels.index("layered")
    check(set(levels[:first_layered]) == {"resident"} and "resident" in levels[first_layered:],
          levels)
    cats = served_categories(batcher, n_requests)
    want = np.setdiff1d(ref_cats[ref_cats < n_requests], quarantined)
    check(np.array_equal(cats, want), ("served exactly", len(cats), len(want)))
    check(stats.goodput == (n_requests - poisoned) / n_requests, stats.summary())
    captured = check_captured(engine.plan_cache, counts)
    return {
        "n_requests": n_requests, "faults_fired": [dataclasses.asdict(e) for e in inj.fired],
        "quarantined_request_ids": quarantined, "summary": stats.summary(),
        "levels": {lvl: levels.count(lvl) for lvl in sorted(set(levels))},
        "ladder": engine.ladder.describe(), "virtual_sleeps": clock.sleeps,
        "launches": counts, **captured, "seconds": seconds,
    }


def phase_serve_bf16(spec, f32_res) -> dict:
    """``run_challenge`` on bf16 activation panels: the output against the
    plain version in bf16, categories against the f32 run's, and the bf16
    launch's time beside the f32 one's."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_mlp import fused_mlp_plain

    info, engine, res = phase_serve(spec, n_inputs=f32_res.n_inputs, use_resident=None,
                                    density=0.3, ref_cols=512, route="fused",
                                    level="resident", kernels=("fused_mlp_forward",),
                                    panel_dtype="bfloat16")
    (plan,) = engine.plan_cache.plans()
    check(plan.key.tuned == "panel_dtype=bfloat16", plan.key)
    y = torch.from_numpy(np.ascontiguousarray(
        rx.radixnet_input_panel(spec.neurons, f32_res.n_inputs, density=0.3,
                                seed=0)[:, :plan.width])).to("cuda")
    got = plan.forward(y)
    want = fused_mlp_plain(*plan.stacked, y, panel_dtype="bfloat16")
    torch.cuda.synchronize()
    err = errors(got, want)
    check(err["max_abs_err"] <= STACK_RTOL * float(want.abs().max()), ("bf16 stack", err))
    agree = f32_res.n_inputs - len(np.setxor1d(res.categories, f32_res.categories))
    sw, sb = plan.stacked
    return {
        **info, **err, "check": "max|kernel - plain(bf16)| <= 1e-4 max|plain(bf16)|",
        "categories_agreeing_with_f32": int(agree),
        "categories_f32": int(len(f32_res.categories)),
        "kernel_ms": {"bfloat16": gpu_time_ms(lambda: ops.fused_mlp_forward(
                          sw, sb, y, panel_dtype="bfloat16"), per_rep=1, reps=3),
                      "float32": gpu_time_ms(lambda: ops.fused_mlp_forward(sw, sb, y),
                                             per_rep=1, reps=3)},
        "edge_inputs_per_sec_f32": f32_res.edge_inputs_per_sec,
    }


def radix_inputs(spec, n_inputs: int, density: float):
    """The challenge input panel (Philox, seed 0) and the numpy oracle's
    categories on all of it."""
    from repro_torch.data import radixnet as rx

    panel = np.ascontiguousarray(
        rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=0))
    ref_y, ref_cats = rx.radixnet_reference(spec, panel)
    check(np.isfinite(ref_y).all(), "finite reference activations")
    check(0 < len(ref_cats) < n_inputs, ("nondegenerate answer set", len(ref_cats)))
    return panel, ref_cats


def phase_dense(spec, panel, ref_cats, *, panel_width: int = 512) -> dict:
    """The BLAS arm: the RadiX-net stack with each distinct layer matrix
    densified once, served panel by panel through the engine."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import SparseDNNEngine

    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(spec, device=dev)
    dense = {id(w): w.to_dense() for w in weights}  # phases stay shared
    engine = SparseDNNEngine([dense[id(w)] for w in weights], biases, batch_align=32,
                             device=dev)
    y0 = torch.from_numpy(panel).to(dev)
    n_inputs = y0.shape[1]
    ops.reset_launch_counts()
    engine.submit(y0[:, :panel_width])  # warmup panel, untimed
    engine.step(pad_to=panel_width)
    torch.cuda.synchronize()
    active = torch.zeros((n_inputs,), dtype=torch.bool, device=dev)
    stats = []
    t0 = time.perf_counter()
    for start in range(0, n_inputs, panel_width):
        chunk = y0[:, start:start + panel_width]
        engine.submit(chunk)
        out, st = engine.step(pad_to=panel_width)
        active[start:start + chunk.shape[1]] = (out > 0).any(dim=0)
        stats.append(st)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = sorted({st["plan"]["route"] for st in stats})
    check(routes == ["layered"], ("routes", routes))
    check(counts["semiring_matmul"] == spec.layers * (len(stats) + 1), counts)
    check(all(v == 0 for k, v in counts.items() if k != "semiring_matmul"), counts)
    captured = check_captured(engine.plan_cache, counts)
    cats = np.flatnonzero(active.cpu().numpy())
    check(np.array_equal(cats, ref_cats), ("dense categories", len(cats), len(ref_cats)))
    (plan,) = engine.plan_cache.plans()
    return {
        "spec": [spec.neurons, spec.layers], "n_inputs": n_inputs, "routes": routes,
        "layer_paths": ["kernel-dense"], "steps": len(stats), "launches": counts, **captured,
        "seconds": seconds, "inputs_per_sec": n_inputs / seconds,
        "edge_inputs_per_sec": spec.edges * n_inputs / seconds,
        "grid_steps_per_panel": stats[0]["grid_steps"],
        "categories": int(len(cats)), "reference_categories": int(len(ref_cats)),
        "host_share": host_share(plan, y0[:, :panel_width].contiguous()),
    }


def bf_relax_numpy(lengths, row_id, col_idx, d):
    """One min_plus relaxation d ← min(d, A ⊕.⊗ d) in numpy over the
    stored blocks (every entry of a stored block is an edge; a missing
    block is +∞): lengths (T, bs, bs), d (m,) float32."""
    bs = lengths.shape[1]
    cand = (lengths + d.reshape(-1, bs)[col_idx][:, None, :]).min(axis=2)  # (T, bs)
    out = d.reshape(-1, bs).copy()
    np.minimum.at(out, row_id, cand)
    return out.reshape(-1)


def phase_graphblas(spec, panel, ref_cats, layered_plan, *, m=SKEWED_M, block=16,
                    total_blocks=SKEWED_BLOCKS, skew=SKEWED_SKEW, seed=SKEWED_SEED, feat=256,
                    rounds=2, bf_cap=64) -> dict:
    """gnn_arm at card scale, one BFS step, and the three-call DNN, the
    last timed on a 512-column panel against ``layered_plan`` (the same
    network's captured layered plan) and its eager layer loop."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.core import graphblas as gb
    from repro_torch.core.semiring import LOR_LAND, MIN_PLUS
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.plan.cost import mxv_grid_steps
    from repro_torch.plan.mxm import mxm_cache_stats, mxm_plan, reset_mxm_cache
    from repro_torch.sparse.bcsr import BlockCSRMatrix

    dev = torch.device("cuda")
    t_build = time.perf_counter()
    csr = BlockCSRMatrix.random_skewed(seed, (m, m), (block, block), total_blocks, skew=skew,
                                       device=dev)
    adj = csr.to_bsr()  # the graph's native, badly padded ELL layout
    t_build = time.perf_counter() - t_build
    ops.reset_launch_counts()
    reset_mxm_cache()
    t0 = time.perf_counter()
    plan = mxm_plan(adj, feat)
    check(plan.layout == "bcsr" and plan.grid_steps < plan.xla_equiv_grid_steps,
          (plan.layout, plan.grid_steps, plan.xla_equiv_grid_steps))

    # graph convolution: rounds of relu(A ⊕.⊗ (H·W)), plus_times
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.rand((m, feat), generator=g, device=dev)
    ws = torch.rand((rounds, feat, feat), generator=g, device=dev) - 0.5
    h_kernel, h_oracle = h, h
    for r in range(rounds):
        h_kernel = torch.clamp_min(gb.mxm(adj, h_kernel @ ws[r]), 0.0)
        h_oracle = torch.clamp_min(gb.mxm(adj, h_oracle @ ws[r], use_kernel=False), 0.0)
    torch.cuda.synchronize()
    scale = max(float(h_oracle.abs().max()), 1.0)
    conv_err = float((h_kernel - h_oracle).abs().max()) / scale
    check(conv_err <= GNN_TOL, ("conv", conv_err))
    conv_stats = mxm_cache_stats()
    check(conv_stats["hits"] >= 1, ("conv plan hits", conv_stats))

    # Bellman-Ford: min_plus mxv to a fixpoint, integer lengths in [0, 6]
    lengths = torch.round(csr.values.abs() * 2.0)
    adj_len = BlockCSRMatrix(lengths, csr.row_ptr, csr.row_id, csr.col_idx, csr.valid,
                             csr.shape, csr.block_shape).to_bsr()
    len_np, rows_np, cols_np = (x.cpu().numpy() for x in (lengths, csr.row_id, csr.col_idx))
    d = torch.full((m,), float("inf"), device=dev)
    d[0] = 0.0
    d_np = d.cpu().numpy()
    bf_iters, converged = 0, False
    for _ in range(bf_cap):
        d_next = torch.minimum(d, gb.mxv(adj_len, d, MIN_PLUS))
        d_np = bf_relax_numpy(len_np, rows_np, cols_np, d_np)
        bf_iters += 1
        check(np.array_equal(d_next.cpu().numpy(), d_np), ("bellman-ford", bf_iters))
        if bool(torch.equal(d_next, d)):
            converged = True
            break
        d = d_next
    check(converged, ("bellman-ford converged", bf_iters))
    bf_stats = mxm_cache_stats()
    check(bf_stats["hits"] - conv_stats["hits"] >= 1, ("bf plan hits", bf_stats))

    # one BFS step from the block-row with the fewest (but some) stored blocks
    counts_np = np.diff(csr.row_ptr.cpu().numpy())  # stored blocks a block-row
    src = int(np.flatnonzero(counts_np == counts_np[counts_np > 0].min())[0])
    frontier = torch.zeros((m,), device=dev)
    frontier[src * block:(src + 1) * block] = 1.0
    reached = gb.vxm(frontier, adj, LOR_LAND)
    want = np.zeros((m // block, block), bool)  # column j reached iff some A[i, j] != 0
    vals_np = csr.values.cpu().numpy()
    for t in np.flatnonzero(rows_np == src):
        want[cols_np[t]] |= (vals_np[t] != 0).any(axis=0)
    check(np.array_equal(reached.cpu().numpy() != 0, want.reshape(-1)), "bfs step")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts["bcsr_spmm"] > 0, counts)

    # the paper's three-call DNN (Fig. 4) on RadiX-net, 2 048 inputs
    weights, biases = rx.radixnet_weights(spec, device=dev)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    out = dnn.dnn_forward(weights, biases, torch.from_numpy(panel).to(dev), fused=False)
    torch.cuda.synchronize()
    dnn_seconds = time.perf_counter() - t1
    dnn_counts = ops.launch_counts()
    # 60 stride-1 layers run block-CSR after the relayout, 60 stride-32 ELL
    check(dnn_counts["bsr_spmm"] == dnn_counts["bcsr_spmm"] == spec.layers // 2, dnn_counts)
    cats = rx.reference_categories(out.cpu().numpy())
    check(np.array_equal(cats, ref_cats), ("three-call categories", len(cats), len(ref_cats)))
    y = torch.from_numpy(np.ascontiguousarray(panel[:, :layered_plan.width])).to(dev)
    three_call = lambda: dnn.dnn_forward(weights, biases, y, fused=False)  # noqa: E731
    share = host_share(layered_plan, y, other=three_call)
    return {
        "m": m, "block": block, "total_blocks": total_blocks, "skew": skew, "seed": seed,
        "feat_dim": feat, "rounds": rounds, "bf_iters_cap": bf_cap,
        "build_seconds": t_build,
        "block_row_blocks": {"longest": int(counts_np.max()),
                             "median": float(np.median(counts_np))},
        "source_layout": plan.source_layout, "exec_layout": plan.layout,
        "kernel_grid_steps": plan.grid_steps, "xla_equiv_grid_steps": plan.xla_equiv_grid_steps,
        "mxv_grid_steps": mxv_grid_steps(plan.weight),
        "conv_max_rel_err": conv_err, "conv_plan_builds": conv_stats["builds"],
        "conv_plan_hits": conv_stats["hits"], "bf_iters": bf_iters, "bf_converged": converged,
        "bf_reachable": int(np.isfinite(d_np).sum()), "bf_matches_numpy": True,
        "bf_plan_hits": bf_stats["hits"] - conv_stats["hits"],
        "bfs_source_block_row": src, "bfs_reached": int((reached != 0).sum()),
        "launches": counts, "seconds": seconds,
        "three_call": {"spec": [spec.neurons, spec.layers], "n_inputs": panel.shape[1],
                       "launches": dnn_counts, "seconds": dnn_seconds,
                       "categories": int(len(cats)), "matches_reference": True,
                       "host_share": {**share, "three_call_ms": share.pop("other_ms"),
                                      "three_call_ms_median": share.pop("other_ms_median")}},
    }


def block_ell(gen, m: int, bs: int, bpr: int, dev):
    """An m x m ELL matrix of bs x bs blocks, ``bpr`` random block-columns a
    block-row, values U[0, 1) / (bpr · bs) (positive: no cancellation)."""
    import torch

    from repro_torch.sparse.bsr import BlockSparseMatrix

    nrb = m // bs
    cols = torch.rand((nrb, nrb), generator=gen, device=dev).argsort(dim=1)[:, :bpr]
    blocks = torch.rand((nrb, bpr, bs, bs), generator=gen, device=dev) / (bpr * bs)
    return BlockSparseMatrix(blocks, cols.sort(dim=1).values.int().contiguous(),
                             torch.ones((nrb, bpr), dtype=torch.bool, device=dev), (m, m),
                             (bs, bs))


def he_values(w, gen, fan_in: int):
    """``w`` with each nonzero stored weight redrawn U(-a, a), a = sqrt(6 /
    fan_in) (He scale: ReLU stacks keep their activations' scale)."""
    import torch

    from repro_torch.core.dnn import values_of, with_values

    v = values_of(w)
    a = (6.0 / fan_in) ** 0.5
    u = torch.rand(v.shape, generator=gen, device=v.device)
    return with_values(w, (v != 0) * (u * 2 - 1) * a)


def rel_norm_err(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def relu_masks(weights, biases, y0, transpose_plans, *, use_kernel: bool) -> list:
    """Each layer's ReLU mask (``out > 0``) in the kernels' or the plain forward."""
    import torch

    from repro_torch.core import dnn

    masks, y = [], y0
    with torch.no_grad():
        for w, b, tp in zip(weights, biases, transpose_plans):
            y = (dnn.dnn_layer_trainable(w, y, b, transpose_plan=tp) if use_kernel
                 else dnn.dnn_layer(w, y, b))
            masks.append(y > 0)
    return masks


def grads_on_masks(weights, biases, y0, targets, masks):
    """Loss and gradients (values, then biases) of the plain forward with
    each layer's ReLU mask fixed to ``masks``: the same piecewise-linear
    function as the forward that made the masks, at the same point."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.sparse import ops as sparse_ops
    from repro_torch.sparse.bcsr import BlockCSRMatrix
    from repro_torch.sparse.bsr import BlockSparseMatrix

    leaves = [dnn.values_of(w).detach().requires_grad_() for w in weights]
    bleaves = [b.detach().requires_grad_() for b in biases]
    y = y0
    for w, v, b, m in zip(weights, leaves, bleaves, masks):
        w = dnn.with_values(w, v)
        z = (sparse_ops.bcsr_matmul(w, y) if isinstance(w, BlockCSRMatrix)
             else sparse_ops.bsr_matmul(w, y) if isinstance(w, BlockSparseMatrix) else w @ y)
        y = torch.where(m, z + b[:, None], torch.zeros((), device=y.device))
    loss = 0.5 * torch.mean((y - targets) ** 2)
    return loss.detach(), torch.autograd.grad(loss, leaves + bleaves)


def train_cell(weights, biases, y0, targets, opt, steps: int) -> dict:
    """A differentiable plan, the first step's gradients against the plain
    versions, then ``steps`` steps of ``make_sparse_train_step`` (launches
    counted over them), forward and backward timed apart."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.kernels import ops
    from repro_torch.plan import build_plan
    from repro_torch.sparse.bcsr import (
        BlockCSRMatrix,
        reset_transpose_sort_count,
        transpose_sort_count,
    )
    from repro_torch.sparse.bsr import BlockSparseMatrix
    from repro_torch.train import (
        grad_sparsity_preserved,
        init_sparse_mlp_state,
        make_sparse_train_step,
    )

    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "no TF32 in the backward products")
    n = y0.shape[1]
    n_ell = sum(isinstance(w, BlockSparseMatrix) for w in weights)
    n_csr = sum(isinstance(w, BlockCSRMatrix) for w in weights)
    reset_transpose_sort_count()
    t0 = time.perf_counter()
    plan = build_plan(weights, biases, n, differentiable=True)
    plan_seconds = time.perf_counter() - t0
    sorts = transpose_sort_count()
    sparse = (BlockCSRMatrix, BlockSparseMatrix)
    check(sorts == len({id(w) for w in weights if isinstance(w, sparse)}),
          ("one sort per sparse matrix at plan build", sorts))
    check(plan.route in ("layered", "xla") and not plan.is_fused_route, plan.route)

    # the first step's gradients against the plain versions on the card:
    # on the kernels' ReLU masks (checked), and on the plain forward's own
    # (printed, with the mask entries the two forwards disagree on)
    loss_k, (dw_k, db_k) = dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
    got = [dnn.values_of(g) for g in dw_k] + list(db_k)
    masks = relu_masks(weights, biases, y0, plan.transpose_plans, use_kernel=True)
    loss_m, want = grads_on_masks(weights, biases, y0, targets, masks)
    own = relu_masks(weights, biases, y0, plan.transpose_plans, use_kernel=False)
    flips = [int((a != b).sum()) for a, b in zip(masks, own)]
    del masks, own
    loss_p, (dw_p, db_p) = dnn.dnn_value_and_grad(weights, biases, y0, targets, use_kernel=False)
    torch.cuda.synchronize()
    plain = [dnn.values_of(g) for g in dw_p] + list(db_p)
    grad_err = max(rel_norm_err(a, b) for a, b in zip(got, want))
    grad_max_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(got, want))
    own_err = max(rel_norm_err(a, b) for a, b in zip(got, plain))
    loss_err = abs(float(loss_k) - float(loss_m)) / abs(float(loss_m))
    check(all(bool(torch.isfinite(a).all()) for a in got), "finite gradients")
    check(grad_err <= GRAD_RTOL, ("gradients vs plain on the kernels' masks", grad_err))
    check(loss_err <= GRAD_RTOL, ("loss vs plain", loss_err))
    sparsity = grad_sparsity_preserved(weights, dw_k)
    check(sparsity, "gradients outside the stored pattern")
    del dw_p, db_p, got, want, plain

    # forward alone (the graph built), then forward + backward, timed
    def leaves():
        ws = [dnn.with_values(w, dnn.values_of(w).detach().requires_grad_()) for w in weights]
        return ws, [b.detach().requires_grad_() for b in biases]

    def forward():
        ws, bs = leaves()
        out = dnn.dnn_forward_trainable(ws, bs, y0, plan=plan)
        return 0.5 * torch.mean((out - targets) ** 2)

    ops.reset_launch_counts()
    forward()
    torch.cuda.synchronize()
    fwd_counts = ops.launch_counts()
    fwd_times, vag_times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        fwd_times.append(time.perf_counter() - t0)
        del loss
        t0 = time.perf_counter()
        dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
        torch.cuda.synchronize()
        vag_times.append(time.perf_counter() - t0)

    # the main path: steps of the sparse train step, counted
    state = init_sparse_mlp_state(weights, biases, opt)
    step = make_sparse_train_step(opt, plan=plan)
    batch = {"y0": y0, "targets": targets}
    losses, step_times = [], []
    ops.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = ops.launch_counts()
    shapes = ops.launched_block_shapes()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], ("loss falls", losses))
    check(transpose_sort_count() == sorts, ("no sort after the plan's build", sorts,
                                            transpose_sort_count()))
    # dX launches, a bcsr_spmm on the cached transpose of every sparse layer
    # whose input needs a gradient: all but a first layer (the input panel
    # is data)
    n_bwd = n_ell + n_csr - int(isinstance(weights[0], sparse))
    fwd = {k: fwd_counts[k] for k in ("bsr_spmm", "bcsr_spmm")}
    per_step = {k: counts[k] / steps for k in ("bsr_spmm", "bcsr_spmm")}
    bwd = {k: per_step[k] - fwd[k] for k in fwd}
    check(fwd == {"bsr_spmm": n_ell, "bcsr_spmm": n_csr}, ("forward launches", fwd))
    check(bwd == {"bsr_spmm": 0, "bcsr_spmm": n_bwd}, ("backward launches", bwd))
    check(all(v == 0 for k, v in counts.items() if k not in fwd), counts)
    return {
        "layers": len(weights), "ell_layers": n_ell, "bcsr_layers": n_csr,
        "route": plan.route, "paths": sorted({lp.path for lp in plan.layers}),
        "columns": n, "plan_seconds": plan_seconds,
        "losses": losses, "first_step_loss_rel_err": loss_err,
        "grad_rel_err": grad_err, "grad_check": f"per layer tensor ||kernel - plain|| <= "
                                                f"{GRAD_RTOL} ||plain||, the kernels' ReLU masks",
        "grad_max_rel_err": grad_max_err,
        "own_masks": {"grad_rel_err": own_err, "relu_mask_flips": sum(flips),
                      "layers_with_flips": [i for i, f in enumerate(flips) if f],
                      "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))},
        "grad_sparsity_preserved": sparsity,
        "transpose_sorts": {"after_plan_build": sorts, "after_steps": transpose_sort_count()},
        "launches": counts, "launches_per_step": {"forward": fwd, "backward": bwd},
        "launched_block_shapes": {k: [list(s) for s in v] for k, v in shapes.items()},
        "forward_ms": 1e3 * statistics.median(fwd_times),
        "forward_backward_ms": 1e3 * statistics.median(vag_times),
        "backward_ms": 1e3 * (statistics.median(vag_times) - statistics.median(fwd_times)),
        "step_ms": 1e3 * statistics.median(step_times[1:]),
        "step_ms_all": [1e3 * x for x in step_times],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def phase_train_radixnet(neurons: int, layers: int, columns: int, steps: int, lr: float) -> dict:
    """The challenge topology at full width, trained: RadiX-net's stored
    blocks with seeded He-scale values (the challenge's own 1/16 weights
    double a live column every layer, past f32's range for a squared
    loss), the stride-1 phase as block-CSR, a Philox input panel."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.plan.layout import to_preferred_layout
    from repro_torch.train import sgd

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    spec = rx.RadixNetSpec(neurons, layers)
    phases, _ = rx.radixnet_weights(spec, device=dev)
    relaid = {}
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    weights = []
    for w in phases:
        if id(w) not in relaid:
            relaid[id(w)] = to_preferred_layout(w)
        weights.append(he_values(relaid[id(w)], gen, fan_in=32))
    biases = [torch.zeros(neurons, device=dev) for _ in weights]
    y0 = torch.from_numpy(rx.radixnet_input_panel(neurons, columns, density=0.3, seed=0)).to(dev)
    targets = torch.rand((neurons, columns), generator=gen, device=dev)
    info = train_cell(weights, biases, y0, targets, sgd(lr), steps)
    return {"spec": [neurons, layers], "optimizer": f"sgd(lr={lr}, momentum=0.9)", **info}


def phase_train_paper(m: int, layers: int, inverse_sparsity: int, block: int, batch: int,
                      steps: int, lr: float) -> dict:
    """The paper's MLP at a Fig. 5 grid point (graphblas_mlp.make_config(m,
    layers, inverse_sparsity, block)): seeded dense weights block-pruned to
    ELL, every other layer re-laid as block-CSR; a served forward through a
    layered plan (128 x 128 blocks, re-tiled by the wrappers) against the
    plain version; then AdamW steps."""
    import torch

    from repro_torch.core import dnn, pruning
    from repro_torch.kernels import ops
    from repro_torch.plan import build_plan
    from repro_torch.sparse.bcsr import BlockCSRMatrix

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    bpr = max(1, round((m // block) / inverse_sparsity))
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    t0 = time.perf_counter()
    weights = []
    for i in range(layers):
        dense = torch.randn((m, m), generator=gen, device=dev) * (2.0 / (bpr * block)) ** 0.5
        w = pruning.block_prune(dense, (block, block), bpr)
        del dense
        weights.append(BlockCSRMatrix.from_bsr(w) if i % 2 else w)
    biases = [torch.full((m,), 0.01, device=dev) for _ in weights]
    build_seconds = time.perf_counter() - t0
    y0 = torch.rand((m, batch), generator=gen, device=dev)
    targets = torch.rand((m, batch), generator=gen, device=dev)

    # serving: the 128 x 128 stack through a layered plan, no grad
    plan = build_plan(weights, biases, batch)
    check(plan.route == "layered", plan.route)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = plan.forward(y0)
    torch.cuda.synchronize()
    serve_counts, serve_shapes = ops.launch_counts(), ops.launched_block_shapes()
    want = dnn.dnn_forward(weights, biases, y0)
    serve_err = errors(got, want)
    check(columns_within(got, want, STACK_RTOL, STACK_ATOL), ("served forward", serve_err))
    check(serve_counts["bsr_spmm"] + serve_counts["bcsr_spmm"] == layers, serve_counts)
    check(all(tuple(s) != (block, block) for v in serve_shapes.values() for s in v), serve_shapes)

    from repro_torch.train import adamw

    info = train_cell(weights, biases, y0, targets, adamw(lr), steps)
    check(all(tuple(s) != (block, block) for v in info["launched_block_shapes"].values()
              for s in v), info["launched_block_shapes"])
    return {
        "config": {"m": m, "num_layers": layers, "inverse_sparsity": inverse_sparsity,
                   "block": block, "blocks_per_row": bpr, "batch": batch},
        "values_mb_per_layer": m // block * bpr * block * block * 4 / 2 ** 20,
        "build_seconds": build_seconds, "optimizer": f"adamw(lr={lr})",
        "serve": {**serve_err, "launches": serve_counts,
                  "launched_block_shapes": {k: [list(s) for s in v]
                                            for k, v in serve_shapes.items()}},
        **info,
    }


def _skewed_stack(specs, skew: float, block: int, dev):
    """The reference tune arm's skewed stack (benchmarks/kernel_bench.py
    ``tune_arm``): ``random_skewed`` block-CSR topologies handed over as ELL."""
    import torch

    from repro_torch.sparse.bcsr import BlockCSRMatrix

    ws = [BlockCSRMatrix.random_skewed(i, shape, (block, block), total, skew=skew,
                                       device=dev).to_bsr()
          for i, (shape, total) in enumerate(specs)]
    return ws, [torch.zeros(w.shape[0], device=dev) for w in ws]


def sweep_record(rec: dict) -> dict:
    keys = ("token", "route", "grid_steps", "block_work", "vmem_bytes", "wall_s",
            "max_abs_err", "ok", "selected", "error")
    out = {k: rec[k] for k in keys if k in rec}
    if "vmem_bytes" in out:
        out["smem_bytes"] = out.pop("vmem_bytes")
    return out


def phase_tune(skewed, radix) -> tuple[dict, object]:
    """The autotuner on the card: the reference tune arm's skewed stack
    (``layout=bcsr`` must win, as in the reference) and RadiX-net at the
    challenge sizes on the {0, 1} panel. Every candidate's bill and time
    is printed; the winners go into one ``TuningTable``, saved and loaded
    back. Returns the line and the table."""
    import tempfile

    import torch

    from repro_torch import plan as P
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES, fused_mlp_smem_bytes
    from repro_torch.tune import (
        TunedConfig,
        TuningTable,
        default_candidates,
        sweep_stack,
        tune_stack,
    )

    dev = torch.device("cuda")
    table = TuningTable()
    ops.reset_launch_counts()

    ws, bs = _skewed_stack(skewed["specs"], skewed["skew"], skewed["block"], dev)
    width = skewed["width"]
    winner, records = sweep_stack(ws, bs, width, reps=skewed["reps"])
    by_token = {r["token"]: r for r in records}
    win, default = by_token[winner.token()], by_token["default"]
    check(winner.token() == "layout=bcsr", ("skewed winner", winner.token()))
    check(win["grid_steps"] < default["grid_steps"]
          and win["block_work"] < default["block_work"], (win, default))
    check(not any("error" in r for r in records), records)
    probe = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (ws[0].shape[1], width)).astype(np.float32)).to(dev)
    want = P.build_plan(ws, bs, width).forward(probe)
    got = P.build_plan(ws, bs, width, tuned=winner).forward(probe)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30))[want != 0].max())
    check(bool(((got - want).abs() <= 1e-6 * want.abs()).all()), ("tuned vs default", rel))
    tune_stack(ws, bs, width, table=table, sweep=(winner, records))
    skewed_line = {"specs": [[list(sh), t] for sh, t in skewed["specs"]], "skew": skewed["skew"],
                   "width": width, "winner": winner.token(),
                   "tuned_vs_default_max_rel_err": rel, "check": "|tuned - default| <= 1e-6 |default|",
                   "candidates": [sweep_record(r) for r in records]}

    radix_lines = []
    for neurons, density in radix["sizes"]:
        spec = rx.RadixNetSpec(neurons, radix["layers"])
        weights, biases = rx.radixnet_weights(spec, block_size=radix["block"], device=dev)
        n = radix["width"]
        probe = torch.from_numpy(np.ascontiguousarray(rx.radixnet_input_panel(
            neurons, n, density=density, seed=0))).to(dev)
        f32_bytes = fused_mlp_smem_bytes(neurons, None, radix["block"])
        budget = min(f32_bytes - 1, SMEM_LIMIT_BYTES)
        cands = default_candidates(block_ns=(None, 8), vmem_limits=(None, budget))
        t0 = time.perf_counter()
        winner, records = sweep_stack(weights, biases, n, candidates=cands, reps=radix["reps"],
                                      probe=probe)
        sweep_seconds = time.perf_counter() - t0
        # no candidate here is one the port refuses by design
        check(not any("error" in r for r in records), [r for r in records if "error" in r])
        timed = [r for r in records if r["ok"]]
        fastest = min(timed, key=lambda r: r["wall_s"])
        tune_stack(weights, biases, n, table=table, sweep=(winner, records))
        radix_lines.append({
            "spec": [neurons, radix["layers"]], "width": n, "density": density,
            "f32_resident_smem_bytes": f32_bytes,
            "budget_candidate": budget, "winner": winner.token(),
            "winner_route": next(r for r in records if r["selected"])["route"],
            "fastest_measured": fastest["token"],
            "selected_is_fastest": fastest["selected"],
            "sweep_seconds": sweep_seconds,
            "candidates": [sweep_record(r) for r in records]})
        del weights, biases
    counts = ops.launch_counts()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "table.json")
        table.save(path)
        loaded = TuningTable.load(path)
        table_bytes = os.path.getsize(path)
    check(loaded.entries == table.entries and len(loaded) == 1 + len(radix["sizes"]),
          "the tuning table round-trips")
    check(all(loaded.lookup(k.split(":")[0], backend="cuda") is not None for k in loaded.entries),
          list(loaded.entries))
    check(isinstance(loaded.lookup(next(iter(loaded.entries)).split(":")[0], backend="cuda"),
                     TunedConfig), "lookup")
    return {"skewed": skewed_line, "radix": radix_lines, "table_entries": len(loaded),
            "table_bytes": table_bytes, "launches": counts}, loaded


def phase_serve_tuned(sizes, layers: int, table, *, n_inputs: int, ref_cols: int) -> dict:
    """``run_challenge(spec, tuning_table=table)`` on all ``n_inputs``
    inputs at each size: the route and launches of the table's winner, its
    answer set (f32 panels: equal to the numpy oracle on ``ref_cols``
    columns; bf16 panels: a panel bit-identical to ``fused_mlp_plain`` at
    the same config, the disagreeing categories printed); then a short run
    through an engine built with the same table, whose captured plans are
    held to their launches as the serving phases hold theirs."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_mlp import fused_mlp_plain
    from repro_torch.plan import topology_fingerprint
    from repro_torch.serve import SparseDNNEngine, run_challenge

    dev = torch.device("cuda")
    lines = []
    for neurons, density in sizes:
        spec = rx.RadixNetSpec(neurons, layers)
        weights, biases = rx.radixnet_weights(spec, device=dev)
        tuned = table.lookup(topology_fingerprint(weights), backend="cuda")
        check(tuned is not None, ("a table hit", spec))
        record = table.record(topology_fingerprint(weights), backend="cuda")
        kernel = {"fused": "fused_mlp_forward", "fused-tiled": "fused_mlp_tiled_forward"}[
            record["route"]]
        ops.reset_launch_counts()
        res = run_challenge(spec, n_inputs=n_inputs, density=density, tuning_table=table)
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        check(res.routes == (record["route"],) and res.levels == ("resident",), res.routes)
        check(res.served == n_inputs, res.served)
        # the warm-up captures the one plan, every timed panel replays it
        check(counts[kernel] == res.steps + 1
              and sum(counts.values()) == counts[kernel], counts)

        panel = rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=0)
        ref_panel = np.ascontiguousarray(panel[:, :ref_cols])
        ref_cats = oracle_categories(spec, ref_panel, chunk=64)
        check(0 < len(ref_cats) < ref_cols, ("nondegenerate answer set", len(ref_cats)))
        got_cats = res.categories[res.categories < ref_cols]
        engine = SparseDNNEngine(weights, biases, batch_align=32, tuning_table=table, device=dev)
        check(engine.tuned == tuned, (engine.tuned, tuned))
        ops.reset_launch_counts()
        run_challenge(spec, n_inputs=4 * 512, density=density, engine=engine)
        short_counts = ops.launch_counts()
        torch.cuda.synchronize()
        captured = check_captured(engine.plan_cache, short_counts)
        (plan,) = engine.plan_cache.plans()
        check(plan.key.tuned == tuned.token() and plan.route == record["route"], plan.describe())
        line = {"spec": [spec.neurons, spec.layers], "density": density, "tuned": tuned.token(),
                "route": record["route"], "n_inputs": n_inputs, "steps": res.steps,
                "launches": counts, "seconds": res.seconds,
                "edge_inputs_per_sec": res.edge_inputs_per_sec,
                "categories": int(len(res.categories)), "reference_columns": ref_cols,
                "reference_categories": int(len(ref_cats)),
                "reference_categories_matched": int(len(np.intersect1d(got_cats, ref_cats))),
                "engine_run": {"launches": short_counts, **captured}}
        if tuned.panel_dtype == "bfloat16":
            # RadiX-net's sums of bf16 panel values times 1/16 are exact in
            # f32, so the kernel and the plain version agree to the bit
            y = torch.from_numpy(np.ascontiguousarray(panel[:, :plan.width])).to(dev)
            out = plan.forward(y)
            want = fused_mlp_plain(*plan.stacked, y, panel_dtype="bfloat16")
            torch.cuda.synchronize()
            check(torch.equal(out, want), ("bf16 panel vs plain", errors(out, want)))
            line["bf16_panel_max_abs_err"] = float((out - want).abs().max())
            line["categories_disagreeing_with_oracle"] = int(
                len(np.setxor1d(got_cats, ref_cats)))
        else:
            check(np.array_equal(got_cats, ref_cats), ("categories", got_cats, ref_cats))
        lines.append(line)
        del weights, biases, engine
    return {"runs": lines,
            "launches": {k: sum(ln["launches"][k] + ln["engine_run"]["launches"][k]
                                for ln in lines) for k in lines[0]["launches"]}}


def phase_train_resilient(neurons: int, layers: int, columns: int, lr: float, steps: int,
                          ckpt_interval: int, nan_step: int, kill_step: int) -> dict:
    """Resilient training at full width: RADIX_TRAIN's network (RadiX-net's
    stored blocks, He-scale values, a differentiable plan), a clean run,
    a run with a NaN loss at ``nan_step`` and a run stopped at
    ``kill_step`` and resumed; both must give the clean run's losses bit
    for bit. Checkpoints go to a temporary directory."""
    import tempfile

    import torch

    from repro_torch.core.dnn import values_of
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.plan import build_plan
    from repro_torch.plan.layout import to_preferred_layout
    from repro_torch.testing import SITE_TRAIN_NAN_LOSS, FaultInjector
    from repro_torch.train import (
        checkpoint,
        init_sparse_mlp_state,
        run_resilient_training,
        sgd,
        validate_sparse_state,
    )

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    phases, _ = rx.radixnet_weights(spec, device=dev)
    relaid, weights = {}, []
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    for w in phases:
        if id(w) not in relaid:
            relaid[id(w)] = to_preferred_layout(w)
        weights.append(he_values(relaid[id(w)], gen, fan_in=32))
    biases = [torch.zeros(neurons, device=dev) for _ in weights]
    panel = torch.from_numpy(rx.radixnet_input_panel(neurons, columns * steps, density=0.3,
                                                     seed=0)).to(dev)

    def batch_fn(step):
        g = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1 + step)
        return {"y0": panel[:, step * columns:(step + 1) * columns],
                "targets": torch.rand((neurons, columns), generator=g, device=dev)}

    plan = build_plan(weights, biases, columns, differentiable=True)
    state = init_sparse_mlp_state(weights, biases, sgd(lr))
    kw = dict(ckpt_interval=ckpt_interval, plan=plan, device=dev)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        _, clean = run_resilient_training(state, batch_fn, sgd(lr), steps,
                                          os.path.join(d, "clean"), **kw)
        clean_seconds = time.perf_counter() - t0
        inj = FaultInjector()
        inj.schedule(SITE_TRAIN_NAN_LOSS, nan_step)
        t0 = time.perf_counter()
        _, faulted = run_resilient_training(state, batch_fn, sgd(lr), steps,
                                            os.path.join(d, "nan"), fault_injector=inj, **kw)
        faulted_seconds = time.perf_counter() - t0
        kill_dir = os.path.join(d, "kill")
        _, part = run_resilient_training(state, batch_fn, sgd(lr), kill_step, kill_dir, **kw)
        final, rest = run_resilient_training(state, batch_fn, sgd(lr), steps, kill_dir, **kw)
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        losses = [clean["losses"][i] for i in range(steps)]
        check(all(np.isfinite(losses)), ("finite losses", losses))
        check(faulted["skipped"] == [nan_step] and len(faulted["restarts"]) == 1, faulted)
        check(faulted["losses"] == clean["losses"], ("NaN fault replay", faulted["losses"]))
        check(rest["start_step"] == kill_step
              and {**part["losses"], **rest["losses"]} == clean["losses"],
              ("kill and resume", part["losses"], rest["losses"]))
        check(counts["bsr_spmm"] > 0 and counts["bcsr_spmm"] > 0, counts)
        # the checkpoint itself: bytes, save and restore times, and a
        # restored state validated on the card
        ckpt = os.path.join(d, "timing")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(ckpt, steps, final)
        save_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = checkpoint.restore(ckpt, final)
        torch.cuda.synchronize()
        restore_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        validate_sparse_state(restored)
        validate_seconds = time.perf_counter() - t0
        check(all(values_of(w).device.type == "cuda" and torch.equal(values_of(w), values_of(v))
                  for w, v in zip(restored.weights, final.weights)),
              "restored on the card, bit for bit")
        ckpt_bytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    return {
        "spec": [neurons, layers], "columns": columns, "steps": steps,
        "optimizer": f"sgd(lr={lr}, momentum=0.9)", "ckpt_interval": ckpt_interval,
        "losses": losses, "nan_step": nan_step, "skipped": faulted["skipped"],
        "restarts": faulted["restarts"], "kill_step": kill_step,
        "replays_bit_identical": {"nan_fault": True, "kill_and_resume": True},
        "clean_seconds": clean_seconds, "faulted_seconds": faulted_seconds,
        "checkpoint_bytes": ckpt_bytes, "save_seconds": save_seconds,
        "restore_seconds": restore_seconds, "validate_seconds": validate_seconds,
        "launches": counts,
    }


def sharded_layer_times(plan, y) -> dict:
    """One sparse layer of a sharded plan, eager, on the card: its S
    ``bcsr_spmm`` launches (``layer_partials``) against the partial
    panels' sum and epilogue (``sum_and_relu``), CUDA events; the heaviest
    layer (most stored blocks)."""
    from repro_torch.plan.sharded import sum_and_relu

    i, lp = max(enumerate(plan.layers), key=lambda e: sum(e[1].nnz_per_shard))
    b = plan.biases[i]
    parts = plan.layer_partials(i, y)
    spmm_ms = gpu_time_ms(lambda: plan.layer_partials(i, y), per_rep=2, reps=3)
    sum_ms = gpu_time_ms(lambda: sum_and_relu(parts, b), per_rep=2, reps=3)
    works = [spmm_work(local, y.shape[1]) for local in lp.shards]
    spmm_bound, spmm_by = bound(sum(w[0] for w in works), sum(w[1] for w in works))
    # the function reads the S partial panels and the bias once and writes
    # the output once: S - 1 adds, the bias add and the ReLU an entry
    m, n = y.shape
    sum_bound, sum_by = bound(4.0 * ((len(parts) + 1) * m * n + m), (len(parts) + 1) * m * n)
    return {"layer": i, "nnz_per_shard": list(lp.nnz_per_shard), "spmm_ms": spmm_ms,
            "spmm_bound_ms": spmm_bound, "spmm_bound_by": spmm_by,
            "partial_sum_ms": sum_ms, "partial_sum_bound_ms": sum_bound,
            "partial_sum_bound_by": sum_by, "partial_sum_share": sum_ms / (spmm_ms + sum_ms)}


def sharded_layer_checks(plan, unsharded, y0) -> dict:
    """The sharded forward layer by layer, eager, on the card: at the first
    layer of each distinct partition, every shard's ``bcsr_spmm`` (no
    epilogue) against ``bcsr_spmm_plain`` on the same sub-segment and
    panel, and the summed layer against the plain UNSHARDED layer
    (``unsharded[i]``, bias and ReLU fused), both within ``SPMM_RTOL`` /
    ``SPMM_ATOL``; the walk's output must be the plan's own forward."""
    import torch

    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
    from repro_torch.plan.sharded import sum_and_relu

    seen, checked = set(), []
    part_err = layer_err = 0.0
    y = y0
    for i, (lp, b) in enumerate(zip(plan.layers, plan.biases)):
        if id(lp.sharded) in seen:
            y = plan.layer_forward(i, y)
            continue
        seen.add(id(lp.sharded))
        parts = plan.layer_partials(i, y)
        for local, part in zip(lp.shards, parts):
            want = bcsr_spmm_plain(local, y, fuse_bias_relu=False)
            torch.testing.assert_close(part, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
            part_err = max(part_err, float((part - want).abs().max()))
        out = sum_and_relu(parts, b)
        want = bcsr_spmm_plain(unsharded[i], y, b, fuse_bias_relu=True)
        torch.testing.assert_close(out, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
        layer_err = max(layer_err, float((out - want).abs().max()))
        checked.append(i)
        del parts, want
        y = out
    check(torch.equal(y, plan._eager(y0)), "the layer walk is the plan's forward")
    return {"layers_checked": checked, "shard_max_abs_err": part_err,
            "layer_max_abs_err": layer_err,
            "check": "each shard's launch vs bcsr_spmm_plain on its sub-segment, and the "
                     "summed layer vs the plain unsharded layer: |kernel - plain| <= "
                     f"{SPMM_RTOL} |plain| + {SPMM_ATOL}"}


def phase_sharded(neurons, layers, shards, n_inputs, density, ref_cols, *,
                  ahead=None) -> dict:
    """``run_challenge(spec, mesh=make_row_blocks_mesh(shards))`` on the one
    card: route and level ``sharded``, ``bcsr_spmm`` launches counted as
    the captured graph's kernel nodes, per-shard nnz and bills, categories
    against the unsharded engine's on every input and the numpy oracle's
    on ``ref_cols`` (``ahead``: (its panel, its :func:`oracle_forward`),
    computed earlier, else here); then a shard failure at dispatch 1. Returns what the ``sharded-cards`` phase
    is held to (the weights, a panel and its output, the categories, the
    oracle's and the unsharded bill), and the phase's record."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import stack_grid_steps
    from repro_torch.serve import SparseDNNEngine, run_challenge
    from repro_torch.sparse import BlockCSRMatrix
    from repro_torch.testing import SITE_SHARD_FAILURE, FaultInjector

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    t0 = time.perf_counter()
    weights, biases = rx.radixnet_weights(spec, device=dev)
    weights_seconds = time.perf_counter() - t0
    mesh = make_row_blocks_mesh(shards)
    engine = SparseDNNEngine(weights, biases, batch_align=32, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_challenge(spec, n_inputs=n_inputs, density=density, engine=engine)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(res.routes == ("sharded",) and res.levels == ("sharded",), (res.routes, res.levels))
    check(res.served == n_inputs, res.served)
    (plan,) = engine.plan_cache.plans()
    captured = check_captured(engine.plan_cache, counts)
    check(plan.captured_launches == {**dict.fromkeys(ops.KERNELS, 0),
                                     "bcsr_spmm": shards * layers}, plan.captured_launches)
    check(plan.imbalance() <= 1.10, ("imbalance", plan.imbalance()))
    relaid = {}
    for w in weights:
        relaid.setdefault(id(w), BlockCSRMatrix.from_bsr(w))
    unsharded_bill = stack_grid_steps([relaid[id(w)] for w in weights], plan.width)
    check(plan.grid_steps == sum(plan.grid_steps_per_shard) == unsharded_bill,
          ("bills", plan.grid_steps_per_shard, unsharded_bill))
    panel = rx.radixnet_input_panel(neurons, n_inputs, density=density, seed=0)
    y = torch.from_numpy(np.ascontiguousarray(panel[:, :plan.width])).to(dev)
    got, want = plan.forward(y), plan._eager(y)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "a sharded replay gives the eager forward's bits")
    served = got[:, :ref_cols].clone()
    one_card = {"panel": y.cpu(), "panel_out": got.cpu(), "categories": res.categories,
                "unsharded_bill": unsharded_bill, "edge_inputs_per_sec": res.edge_inputs_per_sec}
    layer = sharded_layer_times(plan, y)
    layer_checks = sharded_layer_checks(plan, [relaid[id(w)] for w in weights], y)
    del relaid, got, want

    # the unsharded engine on the same inputs
    single = SparseDNNEngine(weights, biases, batch_align=32)
    base = run_challenge(spec, n_inputs=n_inputs, density=density, engine=single)
    check(np.array_equal(res.categories, base.categories),
          ("sharded vs unsharded categories", len(res.categories), len(base.categories)))
    one_card.update(unsharded_categories=base.categories,
                    unsharded_edge_inputs_per_sec=base.edge_inputs_per_sec)
    del single
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if ahead is None:
        ref_y, ref_cats = oracle_forward(spec, np.ascontiguousarray(panel[:, :ref_cols]),
                                         chunk=8)
    else:
        check(np.array_equal(ahead[0], panel[:, :ref_cols]), "the oracle's panel")
        ref_y, ref_cats = ahead[1]
    oracle_seconds = time.perf_counter() - t0
    got_cats = res.categories[res.categories < ref_cols]
    check(0 < len(ref_cats) < ref_cols, ("nondegenerate answer set", len(ref_cats)))
    check(np.array_equal(got_cats, ref_cats), (got_cats, ref_cats))
    one_card.update(ref_cats=ref_cats, weights=weights, biases=biases)
    # the served values on the oracle's columns, by the stack criterion:
    # both are f32 evaluations, each within e of the exact forward
    check(bool(torch.isfinite(served).all()) and np.isfinite(ref_y).all(), "finite values")
    oracle = torch.from_numpy(ref_y).to(dev)
    exact, e = f32_chain_bound(weights, biases, y[:, :ref_cols])
    diff = (served.double() - oracle.double()).abs()
    values = {"max_abs_err": float(diff.max()), "max_oracle": float(oracle.abs().max()),
              "bound_share": float((diff / (2 * e + STACK_ATOL)).max()),
              "col_rel_err": col_rel(served.double(), oracle.double()),
              "col_rel_err_vs_exact": {"sharded": col_rel(served.double(), exact),
                                       "oracle": col_rel(oracle.double(), exact)}}
    check(values["max_abs_err"] <= STACK_RTOL * values["max_oracle"], ("values", values))
    check(values["bound_share"] <= 1.0, ("values", values))
    del oracle, exact, e, diff, served

    # the reference's degrade arm: a shard lost at dispatch 1
    inj = FaultInjector()
    inj.schedule(SITE_SHARD_FAILURE, 1, reason="injected shard loss")
    faulted = SparseDNNEngine(weights, biases, batch_align=32, mesh=mesh, fault_injector=inj)
    deg = run_challenge(spec, n_inputs=n_inputs, density=density, engine=faulted)
    check(deg.levels == ("layered",) and deg.routes == ("layered",), (deg.levels, deg.routes))
    check(np.array_equal(deg.categories, res.categories), "categories after the demotion")
    check([(e.level, e.healthy, e.step) for e in faulted.ladder.events]
          == [("sharded", False, 1)], faulted.ladder.describe())
    return one_card, {
        "spec": [neurons, layers], "shards": shards, "n_inputs": n_inputs, "density": density,
        "routes": list(res.routes), "levels": list(res.levels), "steps": res.steps,
        "width_classes": list(res.width_classes), "launches": counts, **captured,
        "nnz_per_shard": list(plan.nnz_per_shard()), "imbalance": plan.imbalance(),
        "grid_steps_per_shard": list(plan.grid_steps_per_shard),
        "unsharded_bill": unsharded_bill, "shard_pad_blocks": plan.shard_pad_blocks(),
        "seconds": res.seconds, "edge_inputs_per_sec": res.edge_inputs_per_sec,
        "unsharded": {"route": base.routes[0], "seconds": base.seconds,
                      "edge_inputs_per_sec": base.edge_inputs_per_sec},
        "layer": layer, "layer_checks": layer_checks, "values_vs_oracle": values,
        "peak_memory_gb": peak_gb, "weights_seconds": weights_seconds,
        "categories": int(len(res.categories)), "reference_columns": ref_cols,
        "reference_categories": int(len(ref_cats)), "oracle_seconds": oracle_seconds,
        "oracle_computed_ahead": ahead is not None,
        "degrade": {"levels": list(deg.levels), "routes": list(deg.routes),
                    "events": faulted.ladder.describe()["events"],
                    "categories_match": True},
    }


def sharded_relu_masks(plan, y0) -> list:
    """Each layer's ReLU mask in a sharded plan's forward on the kernels."""
    import torch

    masks, y = [], y0
    with torch.no_grad():
        for i in range(plan.n_layers):
            y = plan.layer_forward(i, y)
            masks.append(y > 0)
    return masks


def phase_sharded_train(neurons, layers, columns, steps, lr, shards, *, cards=False) -> dict:
    """train-radixnet's network, every layer block-CSR, through a
    differentiable sharded plan: the first step's gradients against the
    plain versions on the sharded kernels' ReLU masks, the same bits on
    two backward passes, then ``steps`` SGD steps against the unsharded
    differentiable plan's losses, launches per step (and per card),
    step times. ``cards``: over :func:`cards_mesh` (one shard a card)
    instead of ``shards`` positions on the one card."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import build_plan, build_sharded_plan
    from repro_torch.sparse import BlockCSRMatrix
    from repro_torch.train import init_sparse_mlp_state, make_sparse_train_step, sgd

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    phases, _ = rx.radixnet_weights(spec, device=dev)
    csr, weights = {}, []
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    for w in phases:
        weights.append(he_values(csr.setdefault(id(w), BlockCSRMatrix.from_bsr(w)), gen,
                                 fan_in=32))
    biases = [torch.zeros(neurons, device=dev) for _ in weights]
    y0 = torch.from_numpy(rx.radixnet_input_panel(neurons, columns, density=0.3, seed=0)).to(dev)
    targets = torch.rand((neurons, columns), generator=gen, device=dev)
    t0 = time.perf_counter()
    mesh = cards_mesh(shards) if cards else make_row_blocks_mesh(shards)
    plan = build_sharded_plan(weights, biases, columns, mesh, differentiable=True)
    plan_seconds = time.perf_counter() - t0
    check(plan.imbalance() <= 1.10, plan.imbalance())

    loss1, (dw1, db1) = dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
    loss2, (dw2, db2) = dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
    got = [dnn.values_of(g) for g in dw1] + list(db1)
    same_bits = bool(torch.equal(loss1, loss2)) and all(
        torch.equal(a, b) for a, b in zip(got, [dnn.values_of(g) for g in dw2] + list(db2)))
    check(same_bits, "two sharded backward passes give the same bits")
    masks = sharded_relu_masks(plan, y0)
    loss_m, want = grads_on_masks(weights, biases, y0, targets, masks)
    del masks, dw2, db2
    grad_err = max(rel_norm_err(a, b) for a, b in zip(got, want))
    loss_err = abs(float(loss1) - float(loss_m)) / abs(float(loss_m))
    check(all(bool(torch.isfinite(a).all()) for a in got), "finite gradients")
    check(grad_err <= GRAD_RTOL, ("gradients vs plain on the kernels' masks", grad_err))
    check(loss_err <= GRAD_RTOL, ("loss vs plain", loss_err))
    del got, want, dw1, db1

    def train(p):
        state = init_sparse_mlp_state(weights, biases, sgd(lr))
        step = make_sparse_train_step(sgd(lr), plan=p)
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, {"y0": y0, "targets": targets})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        return losses, times

    ops.reset_launch_counts()
    losses, times = train(plan)
    counts = ops.launch_counts()
    # forward: a launch per shard per layer; backward: dX on each shard's
    # transpose for every layer but the first (its input is data)
    per_step = shards * layers + shards * (layers - 1)
    check(counts == {**dict.fromkeys(ops.KERNELS, 0), "bcsr_spmm": steps * per_step},
          ("launches", counts))
    by_card = card_launches(plan)
    check(all(by_card[str(d)] == steps * per_step // shards * plan.shard_devices.count(d)
              for d in plan.cards), ("launches by card", by_card))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], ("loss falls", losses))
    unsharded, u_times = train(build_plan(weights, biases, columns, differentiable=True))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, unsharded))
    check(loss_rel <= 1e-5, ("sharded vs unsharded losses", losses, unsharded))
    return {
        "spec": [neurons, layers], "shards": shards, "columns": columns,
        "cards": len(plan.cards), "devices": plan.describe()["devices"],
        "launches_by_card": by_card,
        "optimizer": f"sgd(lr={lr}, momentum=0.9)", "plan_seconds": plan_seconds,
        "nnz_per_shard": list(plan.nnz_per_shard()), "imbalance": plan.imbalance(),
        "losses": losses, "unsharded_losses": unsharded, "loss_rel_err": loss_rel,
        "first_step_loss_rel_err": loss_err, "grad_rel_err": grad_err,
        "grad_check": f"per layer tensor ||kernel - plain|| <= {GRAD_RTOL} ||plain||, the "
                      "sharded kernels' ReLU masks",
        "same_bits_on_two_backward_passes": same_bits,
        "launches": counts, "launches_per_step": {"forward": shards * layers,
                                                  "backward": shards * (layers - 1)},
        "step_ms": 1e3 * statistics.median(times[1:]), "step_ms_all": [1e3 * t for t in times],
        "unsharded_step_ms": 1e3 * statistics.median(u_times[1:]),
    }


def cards_mesh(shards: int):
    """One shard a card over the first ``shards`` cards when the host has
    that many; else every position on the one card (the same code, with
    every peer copy a slice)."""
    import torch

    from repro_torch.launch.mesh import make_row_blocks_mesh

    if torch.cuda.device_count() >= shards > 1:
        return make_row_blocks_mesh(devices=[f"cuda:{i}" for i in range(shards)])
    return make_row_blocks_mesh(shards)


def card_launches(plan) -> dict:
    """``bcsr_spmm`` launches counted on each of the plan's cards."""
    from repro_torch.kernels import ops

    return {str(d): ops.launch_counts(d)["bcsr_spmm"] for d in plan.cards}


def sync_cards(plan) -> None:
    import torch

    for d in plan.cards:
        torch.cuda.synchronize(d)


def cards_layer_times(plan, y, reps: int = 5) -> dict:
    """The heaviest sparse layer of a sharded plan, eager: each card's
    ``bcsr_spmm`` time (CUDA events on the card, behind a sleep kernel so
    the host's launches on the other cards are hidden), and on the host
    clock (all cards synchronised) the shards' launches alone against the
    whole layer with its exchange: the band sums and the peer copies."""
    import torch

    i, lp = max(enumerate(plan.layers), key=lambda e: sum(e[1].nnz_per_shard))
    panels = plan.scatter(y)
    plan.layer_partials(i, panels)
    per_card = {str(d): [] for d in plan.cards}
    for _ in range(reps):
        sync_cards(plan)
        marks = {}
        for d in plan.cards:
            with torch.cuda.device(d):
                torch.cuda._sleep(20_000_000)
                marks[d] = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                marks[d][0].record()
        plan.layer_partials(i, panels)
        for d in plan.cards:
            with torch.cuda.device(d):
                marks[d][1].record()
        sync_cards(plan)
        for d, (a, b) in marks.items():
            per_card[str(d)].append(a.elapsed_time(b))

    def host_ms(fn) -> float:
        fn()
        sync_cards(plan)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync_cards(plan)
        return 1e3 * (time.perf_counter() - t0) / reps

    partials_ms = host_ms(lambda: plan.layer_partials(i, panels))
    layer_ms = host_ms(lambda: plan._layer(i, panels, plan.cards))
    enqueue = []  # the host's time to issue a layer, the cards still busy
    for _ in range(reps):
        sync_cards(plan)
        t0 = time.perf_counter()
        plan._layer(i, panels, plan.cards)
        enqueue.append(1e3 * (time.perf_counter() - t0))
    sync_cards(plan)
    return {"layer": i, "nnz_per_shard": list(lp.nnz_per_shard),
            "card_spmm_ms": {d: statistics.median(t) for d, t in per_card.items()},
            "host_partials_ms": partials_ms, "host_layer_ms": layer_ms,
            "host_enqueue_ms": statistics.median(enqueue),
            "exchange_share": 1.0 - partials_ms / layer_ms, **peer_copy_rate(plan, y)}


def peer_copy_rate(plan, y, reps: int = 10) -> dict:
    """Whether each card reaches the others' memory directly, and the rate
    of one band's copy from the last card to the home card (host clock
    around ``reps`` copies, both cards synchronised); {} on one card."""
    import torch

    from repro_torch.distribution import peer

    if len(plan.cards) == 1:
        return {}
    src, dst = plan.cards[-1], plan.device
    band = y[plan.bands(0)[-1]].to(src)
    out = torch.empty_like(band, device=dst)
    peer.copy_into(out, band)
    sync_cards(plan)
    t0 = time.perf_counter()
    for _ in range(reps):
        peer.copy_into(out, band)
    sync_cards(plan)
    seconds = (time.perf_counter() - t0) / reps
    return {"peer_access": [[torch.cuda.can_device_access_peer(a, b) if a != b else True
                             for b in plan.cards] for a in plan.cards],
            "band_copy_bytes": band.numel() * 4, "band_copy_ms": 1e3 * seconds,
            "band_copy_gb_per_s": band.numel() * 4 / seconds / 1e9}


def phase_sharded_cards(neurons, layers, shards, n_inputs, density, ref_cols, one_card) -> dict:
    """``run_challenge`` of the ``sharded`` phase's network and inputs over
    :func:`cards_mesh` (one shard a card on a host with ``shards`` cards):
    route and level ``sharded``; on every card its shards' 120
    ``bcsr_spmm`` launches a forward, from the per-card counts; every
    card's allocated memory holds its shards' sub-layouts; categories
    equal to the one-card ``sharded`` run's, the unsharded engine's and
    the numpy oracle's (``one_card``, from :func:`phase_sharded`); one
    panel's output bit-identical to the one-card 4-shard route's; the
    per-shard bills summing to the unsharded bill. Prints edge·inputs/s,
    each card's kernel time and the exchange's share of a layer."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import SparseDNNEngine, run_challenge

    spec = rx.RadixNetSpec(neurons, layers)
    mesh = cards_mesh(shards)
    engine = SparseDNNEngine(one_card["weights"], one_card["biases"], batch_align=32,
                             mesh=mesh)
    for d in mesh.cards:
        torch.cuda.reset_peak_memory_stats(d)
    ops.reset_launch_counts()
    res = run_challenge(spec, n_inputs=n_inputs, density=density, engine=engine)
    counts = ops.launch_counts()
    (plan,) = engine.plan_cache.plans()
    by_card = card_launches(plan)
    sync_cards(plan)
    check(res.routes == ("sharded",) and res.levels == ("sharded",), (res.routes, res.levels))
    check(res.served == n_inputs, res.served)
    check(counts == {**dict.fromkeys(ops.KERNELS, 0),
                     "bcsr_spmm": plan.calls * plan.kernel_launches}, ("launches", counts))
    check(all(by_card[str(d)] == plan.calls * layers * plan.shard_devices.count(d)
              for d in plan.cards), ("launches by card", by_card, plan.calls))
    shard_bytes = {str(d): 0 for d in plan.cards}
    seen = set()
    for lp in plan.layers:
        if id(lp.sharded) not in seen:
            seen.add(id(lp.sharded))
            for local, d in zip(lp.shards, plan.shard_devices):
                check(local.values.device == d, ("shard off its card", local.values.device, d))
                shard_bytes[str(d)] += sum(t.numel() * t.element_size() for t in (
                    local.values, local.row_ptr, local.row_id, local.col_idx, local.valid))
    memory = {str(d): torch.cuda.memory_allocated(d) for d in plan.cards}
    check(all(memory[d] >= shard_bytes[d] for d in memory), ("memory", memory, shard_bytes))
    peak_gb = {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in plan.cards}
    check(np.array_equal(res.categories, one_card["categories"]), "categories vs one card")
    check(np.array_equal(res.categories, one_card["unsharded_categories"]),
          "categories vs the unsharded engine")
    check(np.array_equal(res.categories[res.categories < ref_cols], one_card["ref_cats"]),
          "categories vs the oracle")
    check(plan.grid_steps == sum(plan.grid_steps_per_shard) == one_card["unsharded_bill"],
          ("bills", plan.grid_steps_per_shard, one_card["unsharded_bill"]))
    y = one_card["panel"].to(plan.device)
    got = plan.forward(y)
    check(torch.equal(got.cpu(), one_card["panel_out"]),
          "a panel's output is the one-card 4-shard route's, bit for bit")
    layer = cards_layer_times(plan, y)
    desc = plan.describe()
    return {
        "spec": [neurons, layers], "shards": shards, "cards": len(plan.cards),
        "devices": desc["devices"], "bands": desc["bands"], "n_inputs": n_inputs,
        "routes": list(res.routes), "levels": list(res.levels), "steps": res.steps,
        "executable": desc["executable"], "eager_because": desc["eager_because"],
        "launches": counts, "launches_by_card": by_card, "forwards": plan.calls,
        "shard_bytes_by_card": shard_bytes, "memory_allocated_by_card": memory,
        "peak_memory_gb_by_card": peak_gb,
        "grid_steps_per_shard": list(plan.grid_steps_per_shard),
        "seconds": res.seconds, "edge_inputs_per_sec": res.edge_inputs_per_sec,
        "one_card_edge_inputs_per_sec": one_card["edge_inputs_per_sec"],
        "unsharded_edge_inputs_per_sec": one_card["unsharded_edge_inputs_per_sec"],
        "layer": layer, "bit_identical_panel": True,
        "categories": int(len(res.categories)), "reference_columns": ref_cols,
    }


def fleet_jobs(neurons, profile, rate_factor, duration, width_mix, deadline_s, seed, device,
               **_):
    """The fleet phase's job trace (``FLEET``) with its panels on ``device``."""
    from repro_torch.serve import LoadProfile, generate_jobs

    return generate_jobs(LoadProfile.bursty(**profile).scaled(rate_factor), duration,
                         m=neurons, seed=seed, width_mix=width_mix, deadline_s=deadline_s,
                         device=device)


def phase_fleet(neurons, layers, replicas, profile, rate_factor, duration, width_mix,
                width_classes, deadline_s, max_pending_cols, seed, loss_at, *,
                ahead) -> dict:
    """The reference's fleet arm on the card: ``replicas`` engines of
    RadiX-net ``neurons × layers`` behind ``FleetFrontend`` on a
    ``VirtualClock``, the service model priced by a replayed plan's
    measured time over its bill; every served job's categories against
    the numpy oracle (``ahead``: (every job's panel in trace order, its
    :func:`oracle_forward`), computed earlier), the plan hit rate, then the same
    trace with a replica lost mid-trace, which must drop no admitted
    job."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        FleetFrontend,
        ReplicaFleet,
        ServiceModel,
        SparseDNNEngine,
        VirtualClock,
    )
    from repro_torch.testing import SITE_REPLICA_LOSS, FaultInjector

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    weights, biases = rx.radixnet_weights(spec, device=dev)
    jobs = fleet_jobs(neurons, profile, rate_factor, duration, width_mix, deadline_s, seed,
                      device=dev)
    # the card's price of a billed block product: a replayed plan of the
    # largest class, its CUDA-event time over its bill
    probe = SparseDNNEngine(weights, biases, batch_align=8)
    top = max(width_classes)
    probe.infer(torch.zeros((neurons, top), device=dev))
    (plan,) = probe.plan_cache.plans()
    y = torch.rand((neurons, top), device=dev)
    replay_ms = gpu_time_ms(lambda: plan.forward(y), per_rep=4, reps=3)
    service = ServiceModel(base_s=2e-3, per_grid_step_s=1e-3 * replay_ms / plan.grid_steps)
    del probe, plan

    def run(injector):
        engines = [SparseDNNEngine(weights, biases, batch_align=8) for _ in range(replicas)]
        fleet = ReplicaFleet(engines, width_classes=width_classes)
        fe = FleetFrontend(fleet, clock=VirtualClock(), service_model=service,
                           max_pending_cols=max_pending_cols, fault_injector=injector)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = fe.run(jobs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = dict.fromkeys(ops.KERNELS, 0)
        for r in fleet.replicas:
            for name, k in plan_launches(r.engine.plan_cache).items():
                want[name] += k
        check(counts == want, ("launches = warm-ups + replays", counts, want))
        check(counts["fused_mlp_forward"] == sum(r.dispatches for r in fleet.replicas), counts)
        return fleet, fe, stats, counts, seconds

    _, fe, stats, counts, seconds = run(None)
    f = stats["fleet"]
    check(stats["failed_jobs"] == 0 and stats["served_jobs"] == stats["admitted_jobs"], stats)
    check(f["plan_hit_rate"] >= 0.9, ("plan hit rate", f["plan_hit_rate"]))
    inj = FaultInjector()
    inj.schedule(SITE_REPLICA_LOSS, loss_at, replica=0)
    _, lfe, lstats, lcounts, lseconds = run(inj)
    check(inj.pending() == 0 and lstats["fleet"]["alive"] == replicas - 1, lstats["fleet"])
    check(lstats["failed_jobs"] == 0 and lstats["served_jobs"] == lstats["admitted_jobs"]
          and lstats["requeued_jobs"] >= 1, lstats)

    # every served job of both runs against the numpy oracle
    rids = sorted(set(fe.results) | set(lfe.results))
    cols = np.cumsum([0] + [jobs[r].cols for r in rids])
    check(np.array_equal(ahead[0], np.concatenate([j.features.cpu().numpy() for j in jobs],
                                                  axis=1)), "the oracle's panel")
    alive = np.zeros(ahead[0].shape[1], bool)
    alive[ahead[1][1]] = True
    starts = np.cumsum([0] + [j.cols for j in jobs])
    ref = np.concatenate([alive[starts[r]:starts[r + 1]] for r in rids])
    for results in (fe.results, lfe.results):
        for i, r in enumerate(rids):
            if r in results:
                got = (results[r] > 0).any(dim=0).cpu().numpy()
                check(np.array_equal(got, ref[cols[i]:cols[i + 1]]), ("job categories", r))
    # the trace's features are U[0, 1): every column stays alive, so the
    # values of the first jobs are held too
    first = [r for r in rids if r in fe.results][:8]
    ref_y, _ = rx.radixnet_reference(spec, np.ascontiguousarray(np.concatenate(
        [jobs[r].features.cpu().numpy() for r in first], axis=1)))
    got_y = torch.cat([fe.results[r] for r in first], dim=1).cpu().double()
    value_err = col_rel(got_y, torch.from_numpy(ref_y).double())
    check(value_err <= STACK_RTOL, ("fleet values vs the oracle", value_err))
    keep = ("offered_jobs", "admitted_jobs", "rejected_jobs", "served_jobs", "failed_jobs",
            "deadline_misses", "miss_rate", "requeued_jobs", "latency_p50_s", "latency_p99_s",
            "latency_max_s", "throughput_cols_per_s", "goodput_cols_per_s")
    return {
        "spec": [neurons, layers], "replicas": replicas,
        "trace": {"profile": {"kind": "bursty", **profile}, "rate_factor": rate_factor,
                  "duration_s": duration, "width_mix": [list(w) for w in width_mix],
                  "width_classes": list(width_classes), "deadline_s": deadline_s,
                  "max_pending_cols": max_pending_cols, "seed": seed, "jobs": len(jobs)},
        "service_model": {"base_s": service.base_s, "per_grid_step_s": service.per_grid_step_s,
                          "replay_ms": replay_ms, "replay_width": top},
        **{k: stats[k] for k in keep},
        "routing": f["routing"], "plan_hit_rate": f["plan_hit_rate"],
        "cross_replica_compiles": f["cross_replica_compiles"],
        "launches": counts, "host_seconds": seconds,
        "oracle_columns": int(cols[-1]), "oracle_categories": int(ref.sum()),
        "value_col_rel_err_first_8_jobs": value_err,
        "replica_loss": {"at_dispatch": loss_at, **{k: lstats[k] for k in keep},
                         "routing": lstats["fleet"]["routing"],
                         "events": lstats["fleet"]["events"], "launches": lcounts,
                         "host_seconds": lseconds},
    }


# --- the model stack (Llama-3.2-1B at published width, the paper's MLP) ---------


def device_ms_per_call(fn, calls: int, kernel: str = "") -> float | None:
    """Kernel time on the card per call of ``fn`` (of the kernels whose
    name holds ``kernel``, or all), summed from a ``torch.profiler`` trace
    of ``calls`` calls; None when the trace holds no such device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # the kernels' own rows (an op's row repeats its kernels' time)
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
    return total_us / 1e3 / calls if total_us > 0 else None


def kernel_breakdown(fn, calls: int, top: int = 8) -> dict:
    """Kernel time on the card per call of ``fn`` from one ``torch.profiler``
    trace of ``calls`` calls: the total and the ``top`` kernels by time,
    with their launches a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows) / 1e3 / calls
    return {"kernel_ms": total or None, "kernels_per_call": sum(r[1] for r in rows) / calls,
            "top": [{"kernel": k[:120], "ms": t / 1e3 / calls, "launches": n / calls}
                    for t, n, k in rows[:top]]}


def row_rel(got, want) -> float:
    """The worst row's max |got - want| over that row's max |want| (rows
    along the last axis)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max())


def synced_ms(fn) -> tuple[float, object]:
    """Host milliseconds of ``fn()`` up to the card's end of its work."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def phase_llm_serve(arch: str, batch: int, prompt_len: int, new_tokens: int, cache_len: int,
                    seed: int) -> tuple[dict, object]:
    """The LLM serving path at published width: ``Model.init`` on the card,
    ``Engine`` (bf16 serving copy), two greedy ``generate`` calls, the first
    token against ``forward``'s argmax, a decode step's logits against
    ``forward`` (the reference's 2e-2), the cache's bytes against the count
    from shapes; prefill and decode times, the decode step's bound and its
    kernels' share (profiler). Returns the f32 params for ``llm-sparse``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine, cache_nbytes

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    engine = Engine(model, params, batch_size=batch, cache_len=cache_len, temperature=0.0)
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    n_params = model.param_count()
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed + 1))

    ops.reset_launch_counts()
    gen_ms, (tokens, stats) = synced_ms(lambda: engine.generate(prompts, new_tokens))
    gen2_ms, (tokens2, _) = synced_ms(lambda: engine.generate(prompts, new_tokens))
    launches = ops.launch_counts()
    check(torch.equal(tokens, tokens2), "two greedy generate calls differ")
    check(tuple(tokens.shape) == (batch, new_tokens), tokens.shape)

    seq = torch.cat([prompts, tokens[:, :1]], dim=1)  # the prompt and its first token
    full = model.forward(engine.params, seq)
    check(bool(torch.isfinite(full).all()), "non-finite forward logits")
    check(torch.equal(tokens[:, 0], torch.argmax(full[:, prompt_len - 1], dim=-1).to(torch.int32)),
          ("first token", tokens[:, 0].tolist()))
    cache = model.init_cache(batch, cache_len)
    prefill_ms, (_, cache) = synced_ms(lambda: model.prefill(engine.params, prompts, cache))
    step_ms = []
    dec = None
    for i in range(8):  # decode at prompt_len .. prompt_len + 7, timed one by one
        ms, (dec_i, cache_i) = synced_ms(
            lambda: model.decode_step(engine.params, tokens[:, i], cache, prompt_len + i))
        cache = cache_i
        step_ms.append(ms)
        if i == 0:
            dec = dec_i
    want = full[:, prompt_len]
    dec_err = {"row_rel": row_rel(dec, want),
               "max_abs": float((dec.float() - want.float()).abs().max()),
               "elementwise_2e-2": bool(torch.allclose(dec.float(), want.float(),
                                                       rtol=LLM_TOL, atol=LLM_TOL)),
               # the bf16 floor: the same position from a forward one token shorter
               "forward_32_vs_33": row_rel(model.forward(engine.params, prompts)[:, -1],
                                           full[:, prompt_len - 1])}
    check(dec_err["row_rel"] <= LLM_TOL, ("decode_step vs forward, bf16", dec_err))
    # the cache path at f32 compute on the f32 weights: the same check, tight
    model32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
    full32 = model32.forward(params, seq)
    _, cache32 = model32.prefill(params, prompts, model32.init_cache(batch, cache_len))
    dec32, _ = model32.decode_step(params, tokens[:, 0], cache32, prompt_len)
    dec_err["f32_row_rel"] = row_rel(dec32, full32[:, prompt_len])
    del full32, cache32
    check(dec_err["f32_row_rel"] <= LLM_F32_TOL, ("decode_step vs forward, f32", dec_err))
    a = cfg.attention  # keys and values in bf16, and int32 positions, a layer
    expect_bytes = cfg.num_layers * cache_len * (2 * batch * a.num_kv_heads * a.head_dim * 2 + 4)
    check(stats["cache_bytes"] == expect_bytes, (stats["cache_bytes"], expect_bytes))

    cache = model.prefill(engine.params, prompts, model.init_cache(batch, cache_len))[1]
    kernel_ms = device_ms_per_call(
        lambda: model.decode_step(engine.params, tokens[:, 0], cache, prompt_len), 4)
    weight_bytes = cache_nbytes(engine.params)
    bms, by = bound(weight_bytes + stats["cache_bytes"], 2.0 * n_params * batch)
    step = statistics.median(step_ms)
    return {
        "arch": arch, "params": n_params, "param_gb_f32": cache_nbytes(params) / 1e9,
        "serving_copy_gb": weight_bytes / 1e9, "build_seconds": build_seconds,
        "batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
        "cache_len": cache_len, "cache_bytes": stats["cache_bytes"],
        "generate_ms": [gen_ms, gen2_ms],
        "tokens_per_s": stats["generated_tokens"] / (min(gen_ms, gen2_ms) / 1e3),
        "prefill_ms": prefill_ms, "decode_step_ms": step, "decode_step_ms_all": step_ms,
        "decode_kernel_ms": kernel_ms,
        "decode_host_share": None if kernel_ms is None else 1 - kernel_ms / step,
        "decode_bound_ms": bms, "decode_bound_by": by,
        "decode_vs_forward": dec_err, "tolerance": {"bf16": LLM_TOL, "f32": LLM_F32_TOL},
        "first_tokens": tokens[:, :8].tolist(), "launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, params


def phase_model_mlp(m: int, num_layers: int, inverse_sparsity: int, block: int, batch: int,
                    seed: int) -> dict:
    """The paper's MLP through ``Model``: init, ``sparsify`` (block-pruned
    ELL), ``forward`` on U[0, 1) features — one ``bsr_spmm`` a layer, the
    blocks re-tiled — against the same params on the plain products
    (``use_kernel=False``) by the stack criterion."""
    import torch

    from repro_torch.configs import graphblas_mlp
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_index

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = graphblas_mlp.make_config(m=m, num_layers=num_layers,
                                    inverse_sparsity=inverse_sparsity, block=block)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.sparsify(model.init(torch.Generator(device=dev).manual_seed(seed),
                                       device=dev))
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    x = torch.rand((batch, m), generator=torch.Generator(device=dev).manual_seed(seed + 1),
                   device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = model.forward(params, x)
    torch.cuda.synchronize()
    launches, shapes = ops.launch_counts(), ops.launched_block_shapes()
    check(launches["bsr_spmm"] == num_layers and sum(launches.values()) == num_layers, launches)
    check(shapes.get("bsr_spmm") and all(tuple(s) == (64, 64) for s in shapes["bsr_spmm"]),
          shapes)
    plain = Model(cfg, use_kernel=False)
    with torch.no_grad():
        want = plain.forward(params, x)
    layers = [tree_index(params["stack"]["period"][0], i)["ffn"] for i in range(cfg.n_periods)]
    weights, biases = [f["w"] for f in layers], [f["b"] for f in layers]
    # panel form: (m, batch) columns, as the chain bound takes them
    g, w_ = got[:, 0].T.contiguous(), want[:, 0].T.contiguous()
    err = errors(g, w_)
    exact, e = f32_chain_bound(weights, biases, x.T.contiguous())
    err["bound_share"] = float(((g.double() - w_.double()).abs() / (2 * e + STACK_ATOL)).max())
    check(err["max_abs_err"] <= STACK_RTOL * float(w_.abs().max()), err)
    check(err["bound_share"] <= 1.0, err)
    check(bool(torch.isfinite(got).all()) and bool((got > 0).any()), "dead or non-finite output")
    with torch.no_grad():
        ms = gpu_time_ms(lambda: model.forward(params, x), per_rep=3, reps=5)
        plain_ms = gpu_time_ms(lambda: plain.forward(params, x), per_rep=1, reps=3)
        spmm_ms = device_ms_per_call(lambda: model.forward(params, x), 3, "bsr_spmm_kernel")
        kernels_ms = device_ms_per_call(lambda: model.forward(params, x), 3)
    nbytes = flops = 0.0
    for w in weights:
        b_, f_ = spmm_work(w, batch)
        nbytes, flops = nbytes + b_, flops + f_
    bms, by = bound(nbytes, flops)
    return {
        "config": {"m": m, "num_layers": num_layers, "inverse_sparsity": inverse_sparsity,
                   "block": block, "blocks_per_row": cfg.sparsity.blocks_per_row,
                   "batch": batch},
        "build_seconds": build_seconds, **err,
        "col_rel_err_vs_exact": {"kernel": col_rel(g.double(), exact),
                                 "plain": col_rel(w_.double(), exact)},
        "launches": launches,
        "launched_block_shapes": {k: [list(s) for s in v] for k, v in shapes.items()},
        "forward_ms": ms, "plain_forward_ms": plain_ms, "forward_kernels_ms": kernels_ms,
        "spmm_ms_per_launch": None if spmm_ms is None else spmm_ms / num_layers,
        "bound_ms": bms, "bound_by": by, "bound_ms_per_launch": bms / num_layers,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def phase_llm_sparse(arch: str, params, batch: int, prompt_len: int, block: int,
                     blocks_per_row: int, seed: int) -> dict:
    """The paper's technique on the LLM: the llm-serve weights with every
    FFN projection block-pruned (``SparsityConfig(targets=("ffn",))``,
    ``Model.sparsify``), a bf16 ``prefill`` whose FFNs run on ``bsr_spmm``
    (bf16 operands read as f32, the result cast back), against the same
    params on the plain products (the reference's 2e-2)."""
    import torch

    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model, cast_floating

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), sparsity=SparsityConfig(
        (block, block), blocks_per_row=blocks_per_row, targets=("ffn",)))
    model = Model(cfg)
    t0 = time.perf_counter()
    sparse32 = model.sparsify(params)
    sparse = cast_floating(sparse32, model.compute_dtype)
    torch.cuda.synchronize()
    build_seconds = time.perf_counter() - t0
    w_in = sparse["stack"]["period"][0]["ffn"]["w_in"]
    check(w_in.dtype == torch.bfloat16 and tuple(w_in.blocks.shape[:2]) == (
        cfg.n_periods, cfg.d_ff // block), (w_in.dtype, w_in.blocks.shape))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed + 1))
    ops.reset_launch_counts()
    with torch.no_grad():
        got, _ = model.prefill(sparse, prompts, model.init_cache(batch, prompt_len))
    torch.cuda.synchronize()
    launches, shapes = ops.launch_counts(), ops.launched_block_shapes()
    n_ffn = 3 * cfg.num_layers
    check(launches["bsr_spmm"] == n_ffn and sum(launches.values()) == n_ffn, launches)
    plain = Model(cfg, use_kernel=False)
    with torch.no_grad():
        want, _ = plain.prefill(sparse, prompts, plain.init_cache(batch, prompt_len))
    check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()), got.dtype)
    err = {"row_rel": row_rel(got, want), "max_abs": float((got.float() - want.float()).abs().max()),
           "elementwise_2e-2": bool(torch.allclose(got.float(), want.float(), rtol=LLM_TOL,
                                                   atol=LLM_TOL))}
    check(err["row_rel"] <= LLM_TOL, ("sparse prefill vs plain, bf16", err))
    # the same at f32 compute (f32 weights: the kernels take them as they are)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ops.reset_launch_counts()
    model32, plain32 = Model(cfg32), Model(cfg32, use_kernel=False)
    with torch.no_grad():
        got32, _ = model32.prefill(sparse32, prompts, model32.init_cache(batch, prompt_len))
        want32, _ = plain32.prefill(sparse32, prompts, plain32.init_cache(batch, prompt_len))
    check(ops.launch_counts()["bsr_spmm"] == n_ffn, ops.launch_counts())
    err["f32_row_rel"] = row_rel(got32, want32)
    check(err["f32_row_rel"] <= LLM_F32_TOL, ("sparse prefill vs plain, f32", err))

    def run(m):
        return lambda: m.prefill(sparse, prompts, m.init_cache(batch, prompt_len))

    with torch.no_grad():
        ms = gpu_time_ms(run(model), per_rep=1, reps=5)
        plain_ms = gpu_time_ms(run(plain), per_rep=1, reps=3)
        spmm_ms = device_ms_per_call(run(model), 2, "bsr_spmm_kernel")
        kernels_ms = device_ms_per_call(run(model), 2)
    return {
        "arch": cfg.name, "sparsity": dataclasses.asdict(cfg.sparsity),
        "ffn_gb_bf16": sum(sparse["stack"]["period"][0]["ffn"][k].nbytes
                           for k in ("w_in", "w_gate", "w_out")) / 1e9,
        "build_seconds": build_seconds, "batch": batch, "prompt_len": prompt_len,
        "vs_plain": err, "max_abs_logit": float(want.float().abs().max()),
        "tolerance": {"bf16": LLM_TOL, "f32": LLM_F32_TOL}, "launches": launches,
        "launched_block_shapes": {k: [list(s) for s in v] for k, v in shapes.items()},
        "prefill_ms": ms, "plain_prefill_ms": plain_ms, "prefill_kernels_ms": kernels_ms,
        "spmm_ms_per_launch": None if spmm_ms is None else spmm_ms / n_ffn,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def sparse_projections(params) -> int:
    """Sparse FFN projections a forward runs: each sparse matrix of the
    params tree once a layer (a stacked one once for each of its layers)."""
    from repro_torch.models.layers import SPARSE, tree_leaves

    return sum(leaf.col_idx.shape[0] if leaf.col_idx.dim() == 3 else 1
               for leaf in tree_leaves(params) if isinstance(leaf, SPARSE))


def leaf_errors(got: list, want: list) -> float:
    """The worst float leaf's max |got - want| over its max |want| (leaves
    of ``checkpoint.leaves`` order; None for an index leaf in both)."""
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        check((g is None) == (w is None), "gradient leaves line up")
        if w is not None:
            check(bool(torch.isfinite(g).all()), "finite gradients")
            worst = max(worst, float((g.float() - w.float()).abs().max())
                        / max(float(w.float().abs().max()), 1e-30))
    return worst


def topology_unchanged(before, after) -> bool:
    """Every index leaf of ``after`` is the tensor ``before`` held, unchanged."""
    from repro_torch.train import checkpoint

    return all(b is a for b, a in zip(checkpoint.leaves(before), checkpoint.leaves(after))
               if not b.is_floating_point())


def mlp_relu_masks(params, cfg, x, *, use_kernel: bool) -> tuple[list, object]:
    """The paper's MLP as ``Model`` runs it (``clamp_min(linear(w, x) + b,
    0)`` a layer), on the kernels or the plain products: each layer's ReLU
    mask (``z >= 0``, where ``clamp_min`` passes the gradient) and the
    output."""
    import torch

    from repro_torch.models.layers import linear, tree_index

    f = params["stack"]["period"][0]["ffn"]
    masks, y = [], x[:, None, :]
    with torch.no_grad():
        for i in range(cfg.n_periods):
            z = linear(tree_index(f["w"], i), y, use_kernel=use_kernel) + f["b"][i]
            masks.append(z >= 0)
            y = torch.clamp_min(z, 0.0)
    return masks, y


def mlp_grads_on_masks(params, batch, masks):
    """Loss and gradients (``checkpoint.leaves`` order) of the paper's MLP
    on the plain products with each layer's ReLU mask fixed to ``masks``:
    the function the kernels' forward computed, at the same point."""
    import torch

    from repro_torch.models.layers import cross_entropy_loss, linear, tree_index
    from repro_torch.train import checkpoint

    flat = [leaf.detach().requires_grad_() if leaf.is_floating_point() else leaf
            for leaf in checkpoint.leaves(params)]
    f = checkpoint.with_leaves(params, flat)["stack"]["period"][0]["ffn"]
    y = batch["inputs"][:, None, :]
    with torch.enable_grad():
        for i, mask in enumerate(masks):
            z = linear(tree_index(f["w"], i), y, use_kernel=False) + f["b"][i]
            y = torch.where(mask, z, torch.zeros((), device=z.device))
        loss = cross_entropy_loss(y, batch["labels"], z_loss=1e-4)
        got = iter(torch.autograd.grad(loss, [x for x in flat if x.is_floating_point()]))
    return loss.detach(), [next(got) if x.is_floating_point() else None for x in flat]


def train_steps(step_fn, state, batches, *, counted: bool = True):
    """``step_fn`` over ``batches`` (an iterable of device batches), each
    step timed on the host clock to the card's end of its work; launches
    counted over all of them. Returns (state, losses, grad norms, step ms,
    launch counts)."""
    import torch

    from repro_torch.kernels import ops

    losses, norms, times = [], [], []
    if counted:
        ops.reset_launch_counts()
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, losses, norms, times, ops.launch_counts()


def phase_model_train(m: int, num_layers: int, inverse_sparsity: int, block: int, batch: int,
                      steps: int, lr: float, seed: int) -> dict:
    """The paper's MLP trained through ``Model`` (model-mlp's network):
    ``sparsify``, then ``make_train_step`` with AdamW on one fixed batch
    of U[0, 1) features, the sparse FFNs on the SpMM kernels forward
    (``bsr_spmm`` a layer) and backward (a ``bcsr_spmm`` dX on the ELL
    transpose of each layer whose input needs a gradient, all but the
    first). The first step's loss and gradients against the plain
    products on the kernels' ReLU masks (``GRAD_RTOL`` of each leaf's max
    |plain|); the plain model's own gradients, and its masks' flips,
    printed (held when no mask flips); launches per step against the
    count from shapes; a 2-microbatch SGD step against the 1-microbatch
    one (the reference's tolerances); topology unchanged after the steps;
    the loss falls by more than 0.2."""
    import torch

    from repro_torch.configs import graphblas_mlp
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.sparse.bcsr import reset_transpose_sort_count, transpose_sort_count
    from repro_torch.train import adamw, checkpoint, sgd
    from repro_torch.train.trainer import TrainState, loss_and_grads, make_train_step

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = graphblas_mlp.make_config(m=m, num_layers=num_layers,
                                    inverse_sparsity=inverse_sparsity, block=block)
    model, plain = Model(cfg), Model(cfg, use_kernel=False)
    params = model.sparsify(model.init(torch.Generator(device=dev).manual_seed(seed),
                                       device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    data = {"inputs": torch.rand((batch, m), generator=gen, device=dev),
            "labels": torch.randint(0, m, (batch, 1), generator=gen, device=dev,
                                    dtype=torch.int32)}
    n_fwd = sparse_projections(params)
    check(n_fwd == num_layers, n_fwd)
    n_bwd = n_fwd - 1  # the first layer's input is data

    # the first step's gradients, kernels against plain
    ops.reset_launch_counts()
    reset_transpose_sort_count()
    loss_k, _, got = loss_and_grads(model, params, data)
    torch.cuda.synchronize()
    grad_counts, sorts = ops.launch_counts(), transpose_sort_count()
    shapes = ops.launched_block_shapes()
    check({k: grad_counts[k] for k in ("bsr_spmm", "bcsr_spmm")}
          == {"bsr_spmm": n_fwd, "bcsr_spmm": n_bwd}, ("launches a step", grad_counts))
    check(shapes.get("bsr_spmm") and shapes.get("bcsr_spmm")
          and all(tuple(x) == (64, 64) for v in shapes.values() for x in v), shapes)
    masks, out = mlp_relu_masks(params, cfg, data["inputs"], use_kernel=True)
    with torch.no_grad():
        check(torch.equal(out, model.forward(params, data["inputs"])),
              "the layer loop is the model's kernel forward")
    loss_m, want = mlp_grads_on_masks(params, data, masks)
    grad_err = leaf_errors(got, want)
    loss_err = abs(float(loss_k) - float(loss_m)) / abs(float(loss_m))
    check(grad_err <= GRAD_RTOL and loss_err <= GRAD_RTOL,
          ("gradients vs plain on the kernels' masks", grad_err, loss_err))
    del want
    loss_p, _, own = loss_and_grads(plain, params, data)
    own_masks, _ = mlp_relu_masks(params, cfg, data["inputs"], use_kernel=False)
    flips = [int((a != b).sum()) for a, b in zip(masks, own_masks)]
    own_err = leaf_errors(got, own)
    if not sum(flips):
        check(own_err <= GRAD_RTOL, ("gradients vs the plain model, no mask flips", own_err))
    del got, own, masks, own_masks

    # one SGD step in 2 microbatches against the full batch
    opt = sgd(1e-2, momentum=0.0)
    state = TrainState(params, opt.init(checkpoint.leaves(params)))
    s1, m1 = make_train_step(model, opt)(state, data)
    ops.reset_launch_counts()
    s2, m2 = make_train_step(model, opt, microbatches=2)(state, data)
    mb_counts = ops.launch_counts()
    check(mb_counts["bsr_spmm"] == 2 * n_fwd and mb_counts["bcsr_spmm"] == 2 * n_bwd, mb_counts)
    mb_loss = abs(float(m1["loss"]) - float(m2["loss"])) / abs(float(m1["loss"]))
    check(mb_loss <= 1e-4, ("microbatched loss", mb_loss))
    mb_err = 0.0
    for a, b in zip(checkpoint.leaves(s1.params), checkpoint.leaves(s2.params)):
        if a.is_floating_point():
            check(bool(((a - b).abs() <= 2e-4 + 2e-3 * b.abs()).all()), "microbatched params")
            mb_err = max(mb_err, float((a - b).abs().max()))
    del s1, s2

    # the main path: AdamW steps on the fixed batch, timed and counted
    opt = adamw(lr, weight_decay=0.0)
    state = TrainState(params, opt.init(checkpoint.leaves(params)))
    step = make_train_step(model, opt)
    reset_transpose_sort_count()
    state, losses, norms, step_ms, counts = train_steps(step, state, [data] * steps)
    sorts_per_step = transpose_sort_count() / steps
    check(counts["bsr_spmm"] == steps * n_fwd and counts["bcsr_spmm"] == steps * n_bwd
          and sum(counts.values()) == steps * (n_fwd + n_bwd), ("launches", counts))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.2, ("loss falls", losses))
    check(topology_unchanged(params, state.params), "topology changed")
    w0, w1 = params["stack"]["period"][0]["ffn"]["w"], state.params["stack"]["period"][0]["ffn"]["w"]
    check(bool((w1.blocks[~w1.block_mask] == 0).all()) and not torch.equal(w0.blocks, w1.blocks),
          "stored blocks trained, pad slots zero")

    # forward alone, forward + backward, the plain step, kernel time a step
    def leaves():
        return checkpoint.with_leaves(params, [x.detach().requires_grad_()
                                               if x.is_floating_point() else x
                                               for x in checkpoint.leaves(params)])

    fwd, vag = [], []
    for _ in range(3):
        p = leaves()
        ms, _ = synced_ms(lambda: model.loss(p, data))
        fwd.append(ms)
        ms, _ = synced_ms(lambda: loss_and_grads(model, params, data))
        vag.append(ms)
    plain_state = TrainState(params, opt.init(checkpoint.leaves(params)))
    _, _, _, plain_ms, _ = train_steps(make_train_step(plain, opt), plain_state, [data] * 3,
                                       counted=False)
    kernels = kernel_breakdown(lambda: step(state, data), 2)
    kernel_ms = kernels["kernel_ms"]
    spmm_ms = device_ms_per_call(lambda: step(state, data), 2, "spmm")
    return {
        "config": {"m": m, "num_layers": num_layers, "inverse_sparsity": inverse_sparsity,
                   "block": block, "blocks_per_row": cfg.sparsity.blocks_per_row,
                   "batch": batch},
        "optimizer": f"adamw({lr}, weight_decay=0.0)", "steps": steps,
        "losses": losses, "grad_norms": norms,
        "first_step": {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
                       "check": f"each float leaf max|kernel - plain| <= {GRAD_RTOL} "
                                "max|plain|, plain on the kernels' ReLU masks",
                       "own_masks": {"grad_max_rel_err": own_err, "relu_mask_flips": sum(flips),
                                     "layers_with_flips": [i for i, f in enumerate(flips) if f],
                                     "loss_rel_err": abs(float(loss_k) - float(loss_p))
                                     / abs(float(loss_p))}},
        "microbatches_2_vs_1": {"loss_rel_err": mb_loss, "param_max_abs_err": mb_err,
                                "launches": mb_counts},
        "launches": counts,
        "launches_per_step": {"forward": {"bsr_spmm": n_fwd}, "backward": {"bcsr_spmm": n_bwd}},
        "launched_block_shapes": {k: [list(x) for x in v] for k, v in shapes.items()},
        "transpose_sorts_per_step": sorts_per_step,
        "first_step_sorts": sorts,
        "step_ms": statistics.median(step_ms[1:]), "step_ms_all": step_ms,
        "forward_ms": statistics.median(fwd),
        "backward_ms": statistics.median(vag) - statistics.median(fwd),
        "step_kernels": kernels, "step_spmm_kernel_ms": spmm_ms,
        "step_host_share": None if kernel_ms is None
        else 1 - kernel_ms / statistics.median(step_ms[1:]),
        "plain_step_ms": statistics.median(plain_ms),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def llm_train_bound(cfg, n_params: int, tokens: int) -> tuple[float, str, dict]:
    """The least time a train step could take on the card: the larger of
    6 x (non-embedding params + the tied head's d_model x vocab) x tokens
    over the dense bf16 tensor-core peak, and the optimizer's passes (read
    params, gradients and two moments, write params and two moments, f32)
    over the HBM rate."""
    embed = cfg.vocab_size * cfg.d_model
    matmul_params = n_params - embed + (embed if cfg.tie_embeddings else 0)
    flops = 6.0 * matmul_params * tokens
    nbytes = 7 * 4.0 * n_params
    t_ops, t_bytes = flops / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes",
            {"flops": flops, "bytes": nbytes, "ops_ms": 1e3 * t_ops, "bytes_ms": 1e3 * t_bytes,
             "peaks": "989e12 bf16 FLOP/s dense (tensor cores), 3.35e12 B/s HBM3: NVIDIA's "
                      "H100 SXM data sheet, 700 W"})


def phase_llm_train(arch: str, seq_len: int, global_batch: int, microbatches: int, steps: int,
                    lr: float, block: int, blocks_per_row: int, seed: int) -> dict:
    """Llama-3.2-1B trained at published width with the launcher's parts:
    ``init_train_state`` on the card (f32 weights), AdamW with a
    warmup-cosine schedule and f32 moments, ``SyntheticLM`` batches through
    a ``Prefetcher``, ``make_train_step(microbatches=2)``, 5 steps; then
    the same from the same weights with every FFN block-pruned
    (``Model.sparsify``), its 48 sparse projections a microbatch on the
    SpMM kernels forward and backward. Held: finite loss and grad norm,
    ``opt.step``, params moved, launches against the count from shapes,
    the sparse first step's loss and gradients against the plain products
    at f32 compute, microbatch by microbatch as the timed steps launch
    (``GRAD_RTOL`` of each leaf's max |plain|), topology
    unchanged. Step times beside the step's bound."""
    import torch

    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.data import Prefetcher, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.sparse.bcsr import reset_transpose_sort_count, transpose_sort_count
    from repro_torch.train import adamw, checkpoint
    from repro_torch.train.optimizer import warmup_cosine
    from repro_torch.train.trainer import (
        TrainState,
        init_train_state,
        loss_and_grads,
        make_train_step,
    )

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    model = Model(cfg)
    opt = adamw(warmup_cosine(lr, 10, 100), state_dtype=torch.float32)
    t0 = time.perf_counter()
    state0 = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(seed),
                              device=dev)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    n_params = model.param_count()
    data = SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed)
    tokens = seq_len * global_batch

    def run(step_fn, state):
        prefetch = Prefetcher(data)
        try:
            def batches():
                for _ in range(steps):
                    _, host = prefetch.next()
                    yield {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

            return train_steps(step_fn, state, batches())
        finally:
            prefetch.close()

    dense_step = make_train_step(model, opt, microbatches=microbatches)
    state, losses, norms, step_ms, dense_counts = run(dense_step, state0)
    check(all(np.isfinite(losses + norms)), ("finite loss and grad norm", losses, norms))
    check(int(state.opt.step) == steps, int(state.opt.step))
    check(sum(dense_counts.values()) == 0, ("dense FFNs launch no kernel", dense_counts))
    moved = [not torch.equal(a, b) for a, b in zip(checkpoint.leaves(state0.params),
                                                   checkpoint.leaves(state.params))]
    check(all(moved), ("every float leaf moved", moved.count(False)))
    dense_peak = torch.cuda.max_memory_allocated() / 1e9
    dense_ms = statistics.median(step_ms[1:])
    dense = {"losses": losses, "grad_norms": norms, "step_ms": dense_ms, "step_ms_all": step_ms,
             "tokens_per_s": tokens / (dense_ms / 1e3), "launches": dense_counts,
             "peak_memory_gb": dense_peak}
    first = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    dense["step_kernels"] = kernel_breakdown(lambda: dense_step(state, first), 1)
    bms, by, bound_info = llm_train_bound(cfg, n_params, tokens)
    del state

    # the same from the same weights with every FFN block-pruned
    torch.cuda.reset_peak_memory_stats()
    scfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        (block, block), blocks_per_row=blocks_per_row, targets=("ffn",)))
    smodel = Model(scfg)
    sparams = smodel.sparsify(state0.params)
    del state0
    n_proj = sparse_projections(sparams)
    check(n_proj == 3 * cfg.num_layers, n_proj)

    # the first step's loss and gradients at f32 compute, kernels against
    # plain, microbatch by microbatch: the shapes the timed steps launch at
    cfg32 = dataclasses.replace(scfg, compute_dtype="float32")
    rows = global_batch // microbatches
    ops.reset_launch_counts()
    grad_err = loss_err = 0.0
    for i in range(microbatches):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in first.items()}
        loss_k, _, got = loss_and_grads(Model(cfg32), sparams, mb)
        loss_p, _, want = loss_and_grads(Model(cfg32, use_kernel=False), sparams, mb)
        grad_err = max(grad_err, leaf_errors(got, want))
        loss_err = max(loss_err, abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)))
        del got, want
    grad_counts = ops.launch_counts()
    check(grad_counts["bsr_spmm"] == microbatches * n_proj
          and grad_counts["bcsr_spmm"] == microbatches * n_proj, ("f32 step launches", grad_counts))
    check(grad_err <= GRAD_RTOL and loss_err <= GRAD_RTOL,
          ("sparse f32 gradients vs plain", grad_err, loss_err))

    sopt = adamw(warmup_cosine(lr, 10, 100), state_dtype=torch.float32)
    sstate0 = TrainState(sparams, sopt.init(checkpoint.leaves(sparams)))
    sparse_step = make_train_step(smodel, sopt, microbatches=microbatches)
    reset_transpose_sort_count()
    sstate, slosses, snorms, sstep_ms, counts = run(sparse_step, sstate0)
    sorts = transpose_sort_count()
    per_step = {"bsr_spmm": microbatches * n_proj, "bcsr_spmm": microbatches * n_proj}
    check({k: counts[k] for k in per_step} == {k: steps * v for k, v in per_step.items()}
          and sum(counts.values()) == steps * sum(per_step.values()), ("launches", counts))
    check(all(np.isfinite(slosses + snorms)), ("finite sparse loss", slosses, snorms))
    check(int(sstate.opt.step) == steps, int(sstate.opt.step))
    check(topology_unchanged(sparams, sstate.params), "topology changed")
    smoved = [not torch.equal(a, b) for a, b in zip(checkpoint.leaves(sparams),
                                                    checkpoint.leaves(sstate.params))
              if a.is_floating_point()]
    check(all(smoved), ("every float leaf moved", smoved.count(False)))
    sparse_ms = statistics.median(sstep_ms[1:])
    kernels = kernel_breakdown(lambda: sparse_step(sstate, first), 1)
    spmm_ms = device_ms_per_call(lambda: sparse_step(sstate, first), 1, "spmm")
    return {
        "arch": arch, "params": n_params, "seq_len": seq_len, "global_batch": global_batch,
        "microbatches": microbatches, "steps": steps, "tokens_per_step": tokens,
        "optimizer": f"adamw(warmup_cosine({lr}, 10, 100), state_dtype=float32)",
        "init_seconds": init_seconds, "dense": dense,
        "bound_ms": bms, "bound_by": by, "bound": bound_info,
        "sparse": {
            "sparsity": dataclasses.asdict(scfg.sparsity), "projections": n_proj,
            "first_step_f32": {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
                               "microbatches": microbatches,
                               "columns_a_launch": rows * seq_len, "launches": grad_counts},
            "losses": slosses, "grad_norms": snorms, "launches": counts,
            "launches_per_step": per_step, "transpose_sorts_per_step": sorts / steps,
            "step_ms": sparse_ms, "step_ms_all": sstep_ms,
            "tokens_per_s": tokens / (sparse_ms / 1e3),
            "step_kernels": kernels, "step_spmm_kernel_ms": spmm_ms,
            "dense_step_ms": dense_ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        },
    }


def phase_launch_train(arch: str, steps: int, ckpt_interval: int, seed: int) -> dict:
    """The entry point: ``repro_torch.launch.train.main`` on the default
    device at ``--scale-down``, ``steps`` steps with checkpoints at each
    chunk's end; then the run stopped at ``ckpt_interval`` (its last
    checkpoint dropped) and resumed with ``--resume``: the resumed steps'
    metrics must equal the uninterrupted run's bit for bit."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    args = ["--arch", arch, "--scale-down", "--steps", str(steps),
            "--ckpt-interval", str(ckpt_interval), "--seed", str(seed)]
    with tempfile.TemporaryDirectory() as d:
        full, stopped = os.path.join(d, "full"), os.path.join(d, "stopped")
        ops.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            hist = launch_train.main(args + ["--ckpt-dir", full])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        ckpts = sorted(os.listdir(full))
        shutil.copytree(full, stopped)
        for name in ckpts:
            if int(name.split("_")[1]) > ckpt_interval:
                shutil.rmtree(os.path.join(stopped, name))
        resumed_out = io.StringIO()
        with contextlib.redirect_stdout(resumed_out):
            resumed = launch_train.main(args + ["--ckpt-dir", stopped, "--resume"])
        ckpt_bytes = sum(os.path.getsize(os.path.join(full, ckpts[-1], f))
                         for f in os.listdir(os.path.join(full, ckpts[-1])))
    check([h["step"] for h in hist] == list(range(1, steps + 1)), "steps run")
    check(all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist), "finite")
    check(ckpts == [f"step_{s:08d}" for s in range(10, steps + 1, 10)], ckpts)
    check(f"[train] resumed from step {ckpt_interval}" in resumed_out.getvalue(),
          resumed_out.getvalue())
    check(resumed == hist[ckpt_interval:], ("resumed metrics differ", resumed, hist))
    return {"args": args, "lines": out.getvalue().splitlines(),
            "resumed_lines": resumed_out.getvalue().splitlines(),
            "losses": [h["loss"] for h in hist], "resumed_bit_identical": True,
            "seconds": seconds, "checkpoints": ckpts, "checkpoint_bytes": ckpt_bytes,
            "launches": launches, "device": str(torch.cuda.get_device_name(0))}


def data_mesh(positions: int):
    """The model's data mesh of ``positions``: one a card over the first
    ``positions`` cards when the host has that many; else every position on
    card 0 (the same code, every copy between positions on one device)."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh

    if torch.cuda.device_count() >= positions > 1:
        return make_local_mesh(devices=[f"cuda:{i}" for i in range(positions)])
    return make_local_mesh(positions, device="cuda")


def sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def placed_leaves(state) -> list:
    """Every placed leaf of a training state: params and moments."""
    from repro_torch.distribution.sharding import Placed
    from repro_torch.train import checkpoint

    return [x for x in checkpoint.leaves(checkpoint.state_tree(state)) if isinstance(x, Placed)]


def stored_bytes(state, mesh) -> dict:
    """Each position's bytes of the state (its chunks), held to be their own
    storage, and each card's sum beside what the card has allocated."""
    import torch

    leaves = placed_leaves(state)
    for x in leaves:
        for c in x.chunks:
            check(c.untyped_storage().nbytes() == c.numel() * c.element_size(),
                  ("a chunk is a tensor of its own", tuple(c.shape)))
    per_position = [sum(x.chunks[c].numel() * x.element_size() for x in leaves)
                    for c in range(mesh.size)]
    want = sum(x.numel() * x.element_size() // split_ways(x) for x in leaves)
    check(per_position == [want] * mesh.size,
          ("each position stores its chunks, param_pspecs' sizes", per_position, want))
    per_card = {str(d): sum(b for b, dev in zip(per_position, mesh.devices) if dev == d)
                for d in mesh.cards}
    return {"per_position_gb": [b / 1e9 for b in per_position],
            "per_card_gb": {d: b / 1e9 for d, b in per_card.items()},
            "allocated_gb": {str(d): torch.cuda.memory_allocated(d) / 1e9 for d in mesh.cards}}


def split_ways(leaf) -> int:
    """Over how many positions ``param_pspecs`` splits a placed leaf: its
    ``data`` positions if it splits a dim over ``data``, times its
    ``model`` positions if it splits one over ``model``."""
    s = leaf.sharding
    return ((s.data_size if s.data_dim is not None else 1)
            * (s.model_size if s.model_dim is not None else 1))


def copies_of(leaf, p: int) -> int:
    """The first position holding the same chunk of ``leaf`` as position ``p``."""
    s = leaf.sharding
    c, m = divmod(p, s.model_size)
    return ((0 if s.data_dim is None else c) * s.model_size
            + (0 if s.model_dim is None else m))


def held_whole_same_bits(state) -> bool:
    """Every chunk that several positions hold (a leaf whole along an axis)
    is the same bits on all of them."""
    import torch

    return all(torch.equal(c.to(x.chunks[q].device), x.chunks[q]) for x in placed_leaves(state)
               for p, c in enumerate(x.chunks) if (q := copies_of(x, p)) != p)


def recording(optimizer):
    """``optimizer`` whose update keeps the gradients it gets (one list of
    chunks a position on a placed state)."""
    from repro_torch.train.optimizer import Optimizer

    seen: list = []

    def update(grads, state, params, *, gnorm=None):
        seen.append(grads)
        return optimizer.update(grads, state, params, gnorm=gnorm)

    return Optimizer(optimizer.init, update), seen


def chunk_errors(owners, per_position: list, whole: list) -> float:
    """The worst leaf's max |chunk - the whole's part| over the whole leaf's
    max |whole| (float leaves), chunk by chunk on the chunk's card;
    ``per_position[j]`` holds leaf j's chunks."""
    import torch

    worst = 0.0
    for leaf, chunks, want in zip(owners, per_position, whole):
        if want is None or not want.is_floating_point() or want.numel() == 0:
            continue
        scale = max(float(want.float().abs().max()), 1e-30)
        for c, got in enumerate(chunks):
            part = leaf.sharding.part(want, c).to(got.device)
            check(bool(torch.isfinite(got).all()), "finite")
            worst = max(worst, float((got.float() - part.float()).abs().max()) / scale)
    return worst


def first_step_against_one_position(model, params, batch, mesh, microbatches: int, *,
                                    hold_grads: bool = True, on_host: bool = False) -> dict:
    """One SGD step of ``model`` (f32 compute) on the data mesh against the
    one-position ``make_train_step`` from the same params and global batch:
    loss and ce within ``LOSS_RTOL``, ``grad_norm``, every gradient and
    every updated leaf within ``GRAD_RTOL`` of its leaf's max, compared
    chunk by chunk on each position's card. ``hold_grads=False``: the
    gradient, update and norm errors are measured and not held.
    ``on_host``: the one-position step's gradients and leaves wait on the
    host while the mesh steps."""
    import torch

    from repro_torch.distribution.sharding import param_pspecs, place, shardings_for
    from repro_torch.train import checkpoint, make_train_step, sgd
    from repro_torch.train.optimizer import init_placed
    from repro_torch.train.trainer import TrainState

    opt = sgd(1e-2, momentum=0.0)
    rec1, seen1 = recording(opt)
    on_home = {k: v.to(mesh.device) for k, v in batch.items()}
    s1, m1 = make_train_step(model, rec1, microbatches=microbatches)(
        TrainState(params, opt.init(checkpoint.leaves(params))), on_home)
    grads1, new1 = seen1[0], checkpoint.leaves(s1.params)
    del s1, on_home
    if on_host:
        grads1 = [None if g is None else g.cpu() for g in grads1]
        new1 = [x.cpu() for x in new1]
        seen1.clear()
        torch.cuda.empty_cache()
    placed = place(params, shardings_for(None, mesh, param_pspecs(None, params, mesh)))
    owners = checkpoint.leaves(placed)
    rec4, seen4 = recording(opt)
    s4, m4 = make_train_step(model, rec4, microbatches=microbatches)(
        TrainState(placed, init_placed(opt, owners)), batch)
    del placed
    grads4 = [[per[j] for per in seen4] for j in range(len(owners))]
    new4 = [list(x.chunks) for x in checkpoint.leaves(s4.params)]
    grad_err = chunk_errors(owners, grads4, grads1)
    param_err = chunk_errors(owners, new4, new1)
    del grads1, grads4, new1, new4, s4, seen1, seen4
    torch.cuda.empty_cache()
    loss_err = abs(float(m4["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    ce_err = abs(float(m4["ce"]) - float(m1["ce"])) / abs(float(m1["ce"]))
    norm_err = abs(float(m4["grad_norm"]) - float(m1["grad_norm"])) / float(m1["grad_norm"])
    check(loss_err <= LOSS_RTOL and ce_err <= LOSS_RTOL, ("loss on the mesh", loss_err, ce_err))
    check(not hold_grads or (grad_err <= GRAD_RTOL and param_err <= GRAD_RTOL
                             and norm_err <= GRAD_RTOL),
          ("gradients and updated leaves on the mesh", grad_err, param_err, norm_err))
    return {"loss": float(m4["loss"]), "one_position_loss": float(m1["loss"]),
            "loss_rel_err": loss_err, "ce_rel_err": ce_err, "grad_norm_rel_err": norm_err,
            "grad_max_rel_err": grad_err, "updated_leaf_max_rel_err": param_err,
            "check": f"f32 compute, SGD 1e-2: loss and ce <= {LOSS_RTOL}, each float leaf's "
                     f"gradient and update <= {GRAD_RTOL} of its max against one position"
                     + ("" if hold_grads else " (gradients and updates measured, not held)")}


def gather_reduce(state, mesh) -> dict:
    """The step's two exchanges on their own, timed on the host clock with
    every card synchronised: each card gathering every leaf whole, and one
    microbatch's reduce (every position's whole gradient, here a stand-in
    of the params' shapes, added onto the owners in card order). Bytes:
    what crosses between cards, and what the gather and the reduce copy."""
    from repro_torch.distribution.sharding import constrain_like_params
    from repro_torch.train import checkpoint

    owners = checkpoint.leaves(state.params)
    n = mesh.size
    leaf_bytes = [x.numel() * 4 for x in owners if x.is_floating_point()]
    split = [x.numel() * 4 for x in owners if x.is_floating_point() and x.sharding.dim is not None]
    whole = sum(leaf_bytes) - sum(split)
    cards = len(mesh.cards)
    sync_all()
    t0 = time.perf_counter()
    gathered = {d: [x.gather(d) for x in owners] for d in mesh.cards}
    sync_all()
    gather_ms = 1e3 * (time.perf_counter() - t0)
    terms = [[g if g.is_floating_point() else None for g in gathered[d]] for d in mesh.devices]
    sync_all()
    t0 = time.perf_counter()
    acc = None
    for term in terms:
        acc = constrain_like_params(term, owners=owners, into=acc)
    sync_all()
    reduce_ms = 1e3 * (time.perf_counter() - t0)
    del gathered, terms, acc
    return {"gather_ms": gather_ms, "reduce_ms_a_microbatch": reduce_ms,
            "split_leaf_bytes": sum(split), "whole_leaf_bytes": whole,
            "gather_bytes_between_cards": (n - 1) * sum(split) if cards > 1 else 0,
            "gather_bytes_copied": cards * sum(split),
            "reduce_bytes_between_cards_a_microbatch":
                (n - 1) * (sum(split) + n * whole) if cards > 1 else 0,
            "reduce_bytes_added_a_microbatch": n * (sum(split) + n * whole)}


def device_ms_by_card(fn) -> dict | None:
    """Device time (kernels and copies) on each card during one ``fn()``,
    from a ``torch.profiler`` trace; None when the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync_all()
    per: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = f"cuda:{e.device_index}"
            per[key] = per.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return per or None


def data_steps(step_fn, state, data, steps: int, mesh) -> tuple:
    """``steps`` steps of ``step_fn`` over ``data``'s batches through a
    ``Prefetcher``, host batches (the step copies each position's rows to
    its card), each timed on the host clock to every card's end of its
    work; launches counted from 0 over the steps, per card; after each
    step every leaf held whole must be the same bits on every position."""
    import torch

    from repro_torch.data import Prefetcher
    from repro_torch.kernels import ops

    prefetch = Prefetcher(data)
    losses, norms, times, same = [], [], [], []
    try:
        ops.reset_launch_counts()
        for _ in range(steps):
            _, host = prefetch.next()
            batch = {k: torch.from_numpy(v) for k, v in host.items()}
            sync_all()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            sync_all()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            same.append(held_whole_same_bits(state))
        counts = {str(d): ops.launch_counts(d) for d in mesh.cards}
        total = ops.launch_counts()
    finally:
        prefetch.close()
    check(all(same), ("leaves held whole differ between positions", same))
    check(all(np.isfinite(losses + norms)), ("finite loss and grad norm", losses, norms))
    check(int(state.opt.step) == steps, int(state.opt.step))
    return state, {"losses": losses, "grad_norms": norms, "step_ms": statistics.median(times[1:]),
                   "step_ms_all": times, "launches_by_card": counts, "launches": total,
                   "whole_leaves_same_bits_every_step": True}


def moved(before, after) -> bool:
    """Every float leaf of ``after`` differs from ``before`` on every
    position (a leaf of no elements, a period repeated 0 times, aside)."""
    import torch

    from repro_torch.train import checkpoint

    return all(not torch.equal(a, b) for x, y in zip(checkpoint.leaves(before),
                                                     checkpoint.leaves(after))
               if x.is_floating_point() and x.numel() for a, b in zip(x.chunks, y.chunks))


def phase_llm_train_data(arch: str, seq_len: int, global_batch: int, microbatches: int,
                         steps: int, lr: float, block: int, blocks_per_row: int, positions: int,
                         seed: int) -> dict:
    """llm-train over the data mesh (:func:`data_mesh`: one position a card on
    a host with ``positions`` cards, else every position on card 0): the
    state placed by ``param_pspecs``, each position its rows of each
    microbatch, gradients added onto the owners in card order. Dense, then
    every FFN block-pruned. Held: the first step against the one-position
    step at f32 compute (:func:`first_step_against_one_position`), each
    position's stored bytes its chunks', leaves held whole the same bits on
    every position after each step, launches on each card against the count
    from shapes, topology unchanged, finite losses."""
    import torch

    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distribution.sharding import param_pspecs, place, shardings_for
    from repro_torch.models import Model
    from repro_torch.train import adamw, checkpoint
    from repro_torch.train.optimizer import init_placed, warmup_cosine
    from repro_torch.train.trainer import TrainState, make_train_step

    mesh = data_mesh(positions)
    cfg = get_config(arch)
    model = Model(cfg)
    opt = adamw(warmup_cosine(lr, 10, 100), state_dtype=torch.float32)
    params0 = model.init(torch.Generator(device=mesh.device).manual_seed(seed),
                         device=mesh.device)
    data = SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed)
    first = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    per_card = {str(d): sum(1 for x in mesh.devices if x == d) for d in mesh.cards}

    def placed(params):
        p = place(params, shardings_for(None, mesh, param_pspecs(cfg, params, mesh)))
        return TrainState(p, init_placed(opt, checkpoint.leaves(p)))

    def peaks() -> dict:
        return {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in mesh.cards}

    def reset_peaks() -> None:
        for d in mesh.cards:
            torch.cuda.reset_peak_memory_stats(d)

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    dense_first = first_step_against_one_position(Model(f32), params0, first, mesh, microbatches)
    state0 = placed(params0)
    stored = stored_bytes(state0, mesh)
    exchange = gather_reduce(state0, mesh)
    step = make_train_step(model, opt, microbatches=microbatches)
    reset_peaks()
    state, dense = data_steps(step, state0, data, steps, mesh)
    dense["peak_memory_gb"] = peaks()
    check(sum(dense["launches"].values()) == 0, ("dense FFNs launch no kernel", dense["launches"]))
    check(moved(state0.params, state.params), "every float leaf moved on every position")
    dense["device_ms_by_card"] = device_ms_by_card(lambda: step(state, first))
    dense["first_step_f32"] = dense_first
    del state, state0

    scfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        (block, block), blocks_per_row=blocks_per_row, targets=("ffn",)))
    smodel = Model(scfg)
    sparams = smodel.sparsify(params0)
    del params0
    n_proj = sparse_projections(sparams)
    check(n_proj == 3 * cfg.num_layers, n_proj)
    sparse_first = first_step_against_one_position(
        Model(dataclasses.replace(scfg, compute_dtype="float32")), sparams, first, mesh,
        microbatches)
    sstate0 = placed(sparams)
    sstored = stored_bytes(sstate0, mesh)
    sstep = make_train_step(smodel, opt, microbatches=microbatches)
    reset_peaks()
    sstate, sparse = data_steps(sstep, sstate0, data, steps, mesh)
    sparse["peak_memory_gb"] = peaks()
    a_card = {d: {"bsr_spmm": steps * microbatches * n_proj * k,
                  "bcsr_spmm": steps * microbatches * n_proj * k} for d, k in per_card.items()}
    got = {d: {k: c[k] for k in ("bsr_spmm", "bcsr_spmm")} for d, c in
           sparse["launches_by_card"].items()}
    check(got == a_card and sum(sparse["launches"].values())
          == sum(sum(v.values()) for v in a_card.values()), ("launches on each card", got, a_card))
    check(all(a is b for a, b in zip(checkpoint.leaves(sstate0.params),
                                     checkpoint.leaves(sstate.params))
              if not a.is_floating_point()), "topology changed")
    check(moved(sstate0.params, sstate.params), "every float leaf moved on every position")
    sparse["device_ms_by_card"] = device_ms_by_card(lambda: sstep(sstate, first))
    sparse.update({"first_step_f32": sparse_first, "projections": n_proj,
                   "launches_per_step_a_position": {"bsr_spmm": microbatches * n_proj,
                                                    "bcsr_spmm": microbatches * n_proj},
                   "stored": sstored})
    tokens = seq_len * global_batch
    return {"arch": arch, "mesh": dict(mesh.shape), "cards": len(mesh.cards),
            "devices": [str(d) for d in mesh.devices], "seq_len": seq_len,
            "global_batch": global_batch, "microbatches": microbatches, "steps": steps,
            "tokens_per_step": tokens,
            "optimizer": f"adamw(warmup_cosine({lr}, 10, 100), state_dtype=float32)",
            "stored": stored, "exchange": exchange,
            "dense": {**dense, "tokens_per_s": tokens / (dense["step_ms"] / 1e3)},
            "sparse": {**sparse, "tokens_per_s": tokens / (sparse["step_ms"] / 1e3)}}


def phase_launch_train_data(arch: str, steps: int, ckpt_interval: int, positions: int,
                            seed: int) -> dict:
    """The launcher over the data mesh: ``repro_torch.launch.train.main`` at
    ``--scale-down --data positions`` (every card on a host with that many,
    else ``--device cuda``: the positions on card 0), ``steps`` steps with
    checkpoints at each chunk's end; the run stopped at ``ckpt_interval``
    and resumed gives the same metrics bit for bit; the last checkpoint
    restores onto one position with the leaves the positions hold."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.train import adamw, checkpoint
    from repro_torch.train.trainer import init_train_state

    args = ["--arch", arch, "--scale-down", "--steps", str(steps), "--data", str(positions),
            "--ckpt-interval", str(ckpt_interval), "--seed", str(seed)]
    if torch.cuda.device_count() < positions:
        args += ["--device", "cuda"]
    with tempfile.TemporaryDirectory() as d:
        full, stopped = os.path.join(d, "full"), os.path.join(d, "stopped")
        ops.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            hist = launch_train.main(args + ["--ckpt-dir", full])
        sync_all()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        ckpts = sorted(os.listdir(full))
        shutil.copytree(full, stopped)
        for name in ckpts:
            if int(name.split("_")[1]) > ckpt_interval:
                shutil.rmtree(os.path.join(stopped, name))
        resumed_out = io.StringIO()
        with contextlib.redirect_stdout(resumed_out):
            resumed = launch_train.main(args + ["--ckpt-dir", stopped, "--resume"])
        model = Model(get_config(arch).scaled_down(max_seq_len=128))
        opt = adamw(1e-3)
        one, four = (
            checkpoint.restore(full, init_train_state(
                model, opt, torch.Generator(device=m.device).manual_seed(seed), mesh=m))[0]
            for m in (data_mesh(1), data_mesh(positions)))
        manifest = checkpoint.restore(full, four)[1]
        mesh = data_mesh(positions)
    check([h["step"] for h in hist] == list(range(1, steps + 1)), "steps run")
    check(all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist), "finite")
    check(ckpts == [f"step_{s:08d}" for s in range(10, steps + 1, 10)], ckpts)
    check(f"mesh={dict(mesh.shape)}" in out.getvalue(), out.getvalue())
    check(f"[train] resumed from step {ckpt_interval}" in resumed_out.getvalue(),
          resumed_out.getvalue())
    check(resumed == hist[ckpt_interval:], ("resumed metrics differ", resumed, hist))
    check(manifest["step"] == steps, manifest["step"])
    same = all(torch.equal(a.chunks[0], b.gather(a.device))
               for a, b in zip(placed_leaves(one), placed_leaves(four)))
    check(same, "the last checkpoint on one position holds the positions' leaves")
    return {"args": args, "mesh": dict(mesh.shape), "cards": len(mesh.cards),
            "lines": out.getvalue().splitlines(),
            "resumed_lines": resumed_out.getvalue().splitlines(),
            "losses": [h["loss"] for h in hist], "resumed_bit_identical": True,
            "restored_on_one_position": True, "seconds": seconds, "checkpoints": ckpts,
            "launches": launches}


def model_mesh(data: int, model: int):
    """The model's ``data`` × ``model`` mesh: one position a card over the
    first ``data · model`` cards when the host has them; else every
    position on card 0 (the same code, every exchange on one device)."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh

    n = data * model
    if torch.cuda.device_count() >= n > 1:
        return make_local_mesh(data=data, model=model,
                               devices=[f"cuda:{i}" for i in range(n)])
    return make_local_mesh(data=data, model=model, device="cuda")


def group_exchange(state, mesh) -> dict:
    """The step's exchanges across groups on their own, timed on the host
    clock with every card synchronised: each group gathering its copies
    (each position its model chunk of every leaf split over ``model``,
    whole along ``data``; the home position every other leaf whole), and
    one microbatch's reduce (each group's gradients, here stand-ins of the
    copies' shapes, added onto the owners in card order). Bytes: what the
    gather copies and what the reduce adds."""
    from repro_torch.distribution.sharding import constrain_like_params, group_params
    from repro_torch.train import checkpoint

    owners = checkpoint.leaves(state.params)
    sync_all()
    t0 = time.perf_counter()
    groups = group_params(state.params, owners, mesh)
    sync_all()
    gather_ms = 1e3 * (time.perf_counter() - t0)
    own = {id(c) for x in owners for c in x.chunks}
    copies = {id(t): t for g in groups for x in checkpoint.leaves(g)
              for t in getattr(x, "chunks", (x,)) if id(t) not in own}
    terms = [[x if x.is_floating_point() else None for x in checkpoint.leaves(g)]
             for g in groups]
    sync_all()
    t0 = time.perf_counter()
    acc = None
    for term in terms:
        acc = constrain_like_params(term, owners=owners, into=acc)
    sync_all()
    reduce_ms = 1e3 * (time.perf_counter() - t0)
    added = sum(a.numel() * 4 for sums in acc if sums is not None for a in sums) * len(groups)
    del groups, terms, acc
    return {"gather_ms": gather_ms, "reduce_ms_a_microbatch": reduce_ms,
            "gather_bytes_copied": sum(t.numel() * t.element_size() for t in copies.values()),
            "reduce_bytes_added_a_microbatch": added}


def exchanges_a_step(step_fn, state, batch) -> dict:
    """The model axis's exchanges in one step (``tensor_parallel``): calls
    and bytes moved between model positions, by collective, forward and
    backward; and their time, each logged exchange replayed on its own on
    fresh tensors of its shapes (forward and backward), host clock with
    every card synchronised."""
    from repro_torch.distribution import tensor_parallel as tp

    tp.reset_exchange_counts()
    with tp.logging_exchanges() as log:
        step_fn(state, batch)
    counts = tp.exchange_counts()
    kinds = sorted({k for k, _ in log})
    for kind in kinds:  # a warm-up of each kind
        tp.replay(next(e for e in log if e[0] == kind))
    sync_all()
    ms = {}
    for kind in kinds:
        t0 = time.perf_counter()
        for entry in log:
            if entry[0] == kind:
                tp.replay(entry)
        sync_all()
        ms[kind] = 1e3 * (time.perf_counter() - t0)
    return {"counts": counts, "replayed_ms": ms,
            "fan_out_fan_in_bytes": sum(counts.get(k, {}).get("bytes", 0)
                                        for k in ("fan_out", "fan_in")),
            "fan_out_fan_in_ms": sum(ms.get(k, 0.0) for k in ("fan_out", "fan_in")),
            "all_bytes": sum(c["bytes"] for c in counts.values()),
            "all_ms": sum(ms.values())}


@contextlib.contextmanager
def f64_casts():
    """The model's f32 casts (``Tensor.float()``: the WKV, the norms, the
    softmax, the cross entropy) made f64 inside the block, so a model at
    f64 compute runs every op in f64 (its gradients still accumulate in
    f32 where the trainer says so)."""
    import torch

    float32 = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = float32


def cut_config(arch: str, num_layers: int, period: int | None = None,
               tail: int | None = None):
    """``arch``'s published config cut to ``num_layers`` layers (and its
    period and tail to their first ``period`` and ``tail`` layers): widths
    unchanged."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cuts = {"num_layers": num_layers}
    if period is not None:
        cuts["period"] = cfg.period[:period]
    if tail is not None:
        cuts["tail"] = cfg.tail[:tail]
    return dataclasses.replace(cfg, **cuts)


def mixer_on_model_mesh(cfg, mesh, opt, *, seq_len: int, global_batch: int,
                        microbatches: int, seed: int, params=None,
                        held_in_f64: bool = False) -> tuple[dict, object]:
    """One model of ``cfg`` on the model's mesh: its first step at f32
    compute held against the one-position step
    (:func:`first_step_against_one_position`; with ``held_in_f64``, held
    so in f64, :func:`f64_casts`, and at f32 the loss held and the
    gradients measured, as they are for the data mesh of the same groups,
    ``model`` = 1, against one position), then one step of ``opt`` at
    the config's compute dtype, timed on the host clock with every card
    synchronised, launches counted from 0 over it; every float leaf moved,
    chunks held by several positions the same bits; each card's device
    ms, stored bytes and peak, the model axis's exchanges a step. Returns
    (the record, the params)."""
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.distribution.sharding import param_pspecs, place, shardings_for
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import init_placed
    from repro_torch.train.trainer import TrainState, make_train_step

    if params is None:
        params = Model(cfg).init(torch.Generator(device=mesh.device).manual_seed(seed),
                                 device=mesh.device)
    stream = SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed)
    first = {k: torch.from_numpy(v) for k, v in stream.batch(0).items()}
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    held = first_step_against_one_position(Model(f32), params, first, mesh, microbatches,
                                           hold_grads=not held_in_f64)
    if held_in_f64:
        held["data_mesh_against_one_position"] = first_step_against_one_position(
            Model(f32), params, first, model_mesh(mesh.shape["data"], 1), microbatches,
            hold_grads=False)
        f64 = dataclasses.replace(cfg, compute_dtype="float64", param_dtype="float64")
        with f64_casts():
            p64 = checkpoint.with_leaves(params, [x.double() if x.is_floating_point() else x
                                                  for x in checkpoint.leaves(params)])
            held["float64"] = first_step_against_one_position(Model(f64), p64, first, mesh,
                                                              microbatches, on_host=True)
        del p64
        torch.cuda.empty_cache()
    placed = place(params, shardings_for(None, mesh, param_pspecs(cfg, params, mesh)))
    state0 = TrainState(placed, init_placed(opt, checkpoint.leaves(placed)))
    del placed
    owners = checkpoint.leaves(state0.params)
    paths = checkpoint.leaves(checkpoint.map_with_path(lambda k, _: k, state0.params))
    split = sorted({k.split("//")[-1] for k, x in zip(paths, owners)
                    if x.sharding.model_dim is not None and "//mixer//" in k})
    check(split, (cfg.name, "mixer leaves split over model"))
    stored = stored_bytes(state0, mesh)
    step = make_train_step(Model(cfg), opt, microbatches=microbatches)
    for d in mesh.cards:
        torch.cuda.reset_peak_memory_stats(d)
    sync_all()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state0, first)
    sync_all()
    step_ms = 1e3 * (time.perf_counter() - t0)
    launches = {str(d): ops.launch_counts(d) for d in mesh.cards}
    total = ops.launch_counts()
    peak = {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in mesh.cards}
    check(held_whole_same_bits(state) and moved(state0.params, state.params)
          and np.isfinite(float(metrics["loss"])), (cfg.name, "the step"))
    del state0
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "compute_dtype": cfg.compute_dtype,
           "params": sum(x.numel() for x in checkpoint.leaves(params)),
           "mixer_leaves_split": split, "first_step_f32": held, "stored": stored,
           "step_ms": step_ms, "loss": float(metrics["loss"]), "peak_memory_gb": peak,
           "launches_by_card": launches, "launches": total,
           "device_ms_by_card": device_ms_by_card(lambda: step(state, first)),
           "exchanges_a_step": exchanges_a_step(step, state, first)}
    del state
    torch.cuda.empty_cache()
    return rec, params


def seq_rules():
    """The reference's sequence parallelism over ``model``."""
    from repro_torch.distribution.sharding import ShardingRules

    return ShardingRules(seq_axis="model")


def sgd_on_mesh(model, params, batch, mesh, microbatches: int, rules=None) -> tuple:
    """One SGD step (1e-2, no momentum) of ``model`` on ``params`` placed on
    ``mesh``, under ``rules`` (``sharding.activate``): (the metrics, the
    gradients each position's update got, the model axis's exchanges)."""
    from repro_torch.distribution import tensor_parallel as tp
    from repro_torch.distribution.sharding import activate, param_pspecs, place, shardings_for
    from repro_torch.train import checkpoint, make_train_step, sgd
    from repro_torch.train.optimizer import init_placed
    from repro_torch.train.trainer import TrainState

    opt = sgd(1e-2, momentum=0.0)
    rec, seen = recording(opt)
    placed = place(params, shardings_for(None, mesh, param_pspecs(None, params, mesh)))
    state = TrainState(placed, init_placed(opt, checkpoint.leaves(placed)))
    del placed
    tp.reset_exchange_counts()
    with activate(mesh, rules):
        _, metrics = make_train_step(model, rec, microbatches=microbatches)(state, batch)
    return {k: float(v) for k, v in metrics.items()}, seen, tp.exchange_counts()


def split_against_unsplit(model, params, batch, mesh, microbatches: int) -> dict:
    """The first step at f32 compute split along the sequence
    (:func:`seq_rules`) against the same step unsplit on the same mesh:
    the loss and ce the same bits, each gradient within
    ``SPLIT_GRAD_RTOL`` of its leaf's max on each position's card; the
    split step's sequence gathers and reduce-scatters present, and no
    fan-out or fan-in left of the residual (their bytes fall)."""
    import torch

    from repro_torch.train import checkpoint

    m0, g0, c0 = sgd_on_mesh(model, params, batch, mesh, microbatches)
    m1, g1, c1 = sgd_on_mesh(model, params, batch, mesh, microbatches, seq_rules())
    paths = checkpoint.leaves(checkpoint.map_with_path(lambda k, _: k, params))
    worst, moved = 0.0, {}
    for j, path in enumerate(paths):
        for a, b in zip(g0, g1):
            if a[j] is None:
                continue
            err = float((a[j].float() - b[j].float()).abs().max()) / max(
                float(a[j].float().abs().max()), 1e-30)
            check(bool(torch.isfinite(b[j]).all()), (path, "finite split gradient"))
            worst = max(worst, err)
            if err:
                moved[path] = max(moved.get(path, 0.0), err)
    del g0, g1
    torch.cuda.empty_cache()
    fans = {k: sum(c.get(x, {}).get("bytes", 0) for x in ("fan_out", "fan_in"))
            for k, c in (("unsplit", c0), ("split", c1))}
    rec = {"loss": m1["loss"], "unsplit_loss": m0["loss"],
           "loss_bits_equal": m1["loss"] == m0["loss"] and m1["ce"] == m0["ce"],
           "grad_max_rel_err": worst, "grad_rel_err_by_leaf": moved,
           "fan_out_fan_in_bytes": fans, "exchanges_split": c1, "exchanges_unsplit": c0,
           "check": f"f32 compute, SGD 1e-2: loss and ce bit for bit, each gradient <= "
                    f"{SPLIT_GRAD_RTOL} of its leaf's max against the unsplit step"}
    check(rec["loss_bits_equal"] and worst <= SPLIT_GRAD_RTOL,
          ("the split step against the unsplit one", rec))
    check(c1.get("seq_gather", {}).get("bytes", 0) > 0 and "seq_gather" not in c0
          and fans["split"] < fans["unsplit"], ("the split's exchanges", c0, c1))
    return rec


def interleaved_steps(step, state, batch, mesh, rounds: int) -> dict:
    """``step`` from ``state`` unsplit and split along the sequence in turns
    (unsplit, split, split, unsplit; ``rounds`` times), each timed on the
    host clock with every card synchronised and each card's peak read;
    the state is not advanced. Medians and every time."""
    import torch

    from repro_torch.distribution.sharding import activate

    times, peaks = {"unsplit": [], "split": []}, {"unsplit": {}, "split": {}}
    for _ in range(rounds):
        for name in ("unsplit", "split", "split", "unsplit"):
            for d in mesh.cards:
                torch.cuda.reset_peak_memory_stats(d)
            sync_all()
            t0 = time.perf_counter()
            with activate(mesh, seq_rules() if name == "split" else None):
                out = step(state, batch)
            sync_all()
            times[name].append(1e3 * (time.perf_counter() - t0))
            peaks[name] = {str(d): max(peaks[name].get(str(d), 0.0),
                                       torch.cuda.max_memory_allocated(d) / 1e9)
                           for d in mesh.cards}
            check(np.isfinite(float(out[1]["loss"])), (name, "finite loss"))
            del out
    return {"step_ms": {k: statistics.median(v) for k, v in times.items()},
            "step_ms_all": times, "peak_memory_gb": peaks}


def seq_on_model_mesh(cfg, params, first, mesh, opt, microbatches: int, *,
                      rounds: int = 2, exchanges: bool = True) -> dict:
    """``cfg`` on the model's mesh with the sequence split over ``model``
    (:func:`seq_rules`): the first step at f32 compute against the
    one-position step (:func:`first_step_against_one_position`, its limits)
    and against the unsplit step (:func:`split_against_unsplit`), then
    ``opt``'s step at the config's compute dtype timed against the unsplit
    one in turns (:func:`interleaved_steps`), the split step's launches
    counted from 0 over one more call, and (``exchanges``) the model axis's
    exchanges a split step by kind (:func:`exchanges_a_step`)."""
    import torch

    from repro_torch.distribution.sharding import activate, param_pspecs, place, shardings_for
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import init_placed
    from repro_torch.train.trainer import TrainState, make_train_step

    f32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
    rec = {"rules": "ShardingRules(seq_axis='model')",
           "tokens_a_position": first["inputs"].shape[1] // mesh.shape["model"]}
    with activate(mesh, seq_rules()):
        rec["first_step_f32"] = first_step_against_one_position(f32, params, first, mesh,
                                                                microbatches)
    rec["against_unsplit_f32"] = split_against_unsplit(f32, params, first, mesh, microbatches)
    placed = place(params, shardings_for(None, mesh, param_pspecs(cfg, params, mesh)))
    state = TrainState(placed, init_placed(opt, checkpoint.leaves(placed)))
    del placed
    step = make_train_step(Model(cfg), opt, microbatches=microbatches)
    rec.update(interleaved_steps(step, state, first, mesh, rounds))
    sync_all()
    ops.reset_launch_counts()
    with activate(mesh, seq_rules()):
        out = step(state, first)
    sync_all()
    rec["launches_by_card"] = {str(d): ops.launch_counts(d) for d in mesh.cards}
    rec["launches"] = ops.launch_counts()
    del out
    if exchanges:
        with activate(mesh, seq_rules()):
            rec["exchanges_a_step"] = exchanges_a_step(step, state, first)
        ex = rec["exchanges_a_step"]["counts"]
        check(ex.get("seq_gather", {}).get("bytes", 0) > 0
              and ex.get("seq_reduce", {}).get("bytes", 0) > 0, ("split exchanges", ex))
    del state
    torch.cuda.empty_cache()
    return rec


def phase_llm_train_model(arch: str, seq_len: int, global_batch: int, microbatches: int,
                          steps: int, lr: float, block: int, blocks_per_row: int, data: int,
                          model: int, moe_arch: str, moe_layers: int, moe_crossing: dict,
                          mixers: dict, pruned_mixer: str, seq_mixers: tuple,
                          seed: int) -> dict:
    """llm-train over the model's ``data`` × ``model`` mesh (:func:`model_mesh`:
    one position a card on a host with ``data · model`` cards, else every
    position on card 0): heads, the FFN's hidden columns, the embedding's d
    and the head's vocab split over ``model``, each group of ``model``
    positions computing its rows together, gradients added onto the owners
    in card order. Dense, then every FFN block-pruned (whole, on each
    group's home card). Held: the first step at f32 compute against the
    one-position step (:func:`first_step_against_one_position`), each
    position's stored bytes ``param_pspecs``' chunk sizes, chunks held by
    several positions the same bits after each step, launches on each card
    against the count from shapes, topology unchanged, finite losses. Then
    ``moe_arch`` at published width cut to ``moe_layers`` layers, one step,
    its experts split over ``model``, held the same way, and again on
    ``moe_crossing``'s batch, whose MoE token groups cross data indices
    (each MoE layer once on group 0's home over every index's rows). Then each of
    ``mixers`` (arch: its cut, :func:`cut_config`) through
    :func:`mixer_on_model_mesh`, and ``pruned_mixer``'s cut again with its
    FFNs block-pruned, the SpMM launches of its timed step held to the
    count from shapes on each group's home card. Then the sequence split
    over ``model`` (:func:`seq_on_model_mesh`: ``arch`` dense and pruned,
    the pruned step's SpMM launches on each group's home card from shapes)
    and each of ``seq_mixers``' cuts held to its unsplit step
    (:func:`split_against_unsplit`)."""
    import torch

    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distribution.sharding import param_pspecs, place, shardings_for
    from repro_torch.models import Model
    from repro_torch.train import adamw, checkpoint
    from repro_torch.train.optimizer import init_placed, warmup_cosine
    from repro_torch.train.trainer import TrainState, make_train_step

    mesh = model_mesh(data, model)
    homes = mesh.devices[::model]
    cfg = get_config(arch)
    opt = adamw(warmup_cosine(lr, 10, 100), state_dtype=torch.float32)
    params0 = Model(cfg).init(torch.Generator(device=mesh.device).manual_seed(seed),
                              device=mesh.device)
    stream = SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed)
    first = {k: torch.from_numpy(v) for k, v in stream.batch(0).items()}

    def placed(c, params):
        p = place(params, shardings_for(None, mesh, param_pspecs(c, params, mesh)))
        return TrainState(p, init_placed(opt, checkpoint.leaves(p)))

    def peaks() -> dict:
        return {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in mesh.cards}

    def reset_peaks() -> None:
        for d in mesh.cards:
            torch.cuda.reset_peak_memory_stats(d)

    def split_leaves(state) -> list:
        return [x for x in checkpoint.leaves(state.params) if x.sharding.model_dim is not None]

    def run(c, params, label):
        m = Model(c)
        held = first_step_against_one_position(
            Model(dataclasses.replace(c, compute_dtype="float32")), params, first, mesh,
            microbatches)
        state0 = placed(c, params)
        check(len(split_leaves(state0)) > 0, (label, "leaves split over model"))
        stored = stored_bytes(state0, mesh)
        step = make_train_step(m, opt, microbatches=microbatches)
        reset_peaks()
        state, out = data_steps(step, state0, stream, steps, mesh)
        out["peak_memory_gb"] = peaks()
        check(moved(state0.params, state.params), (label, "every float leaf moved"))
        check(all(a is b for a, b in zip(checkpoint.leaves(state0.params),
                                         checkpoint.leaves(state.params))
                  if not a.is_floating_point()), (label, "topology changed"))
        out["device_ms_by_card"] = device_ms_by_card(lambda: step(state, first))
        out["exchanges_a_step"] = exchanges_a_step(step, state, first)
        out.update({"first_step_f32": held, "stored": stored,
                    "split_leaves": len(split_leaves(state0))})
        return state0, state, out

    state0, state, dense = run(cfg, params0, "dense")
    check(sum(dense["launches"].values()) == 0, ("dense FFNs launch no kernel", dense["launches"]))
    dense["group_exchange"] = group_exchange(state0, mesh)
    del state, state0
    torch.cuda.empty_cache()
    # the sequence split over model (ShardingRules(seq_axis="model")), dense
    seq = {"dense": seq_on_model_mesh(cfg, params0, first, mesh, opt, microbatches)}
    check(sum(seq["dense"]["launches"].values()) == 0, ("split dense launches", seq["dense"]))

    scfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        (block, block), blocks_per_row=blocks_per_row, targets=("ffn",)))
    sparams = Model(scfg).sparsify(params0)
    del params0
    n_proj = sparse_projections(sparams)
    check(n_proj == 3 * cfg.num_layers, n_proj)
    sstate0, sstate, sparse = run(scfg, sparams, "sparse")
    a_group = steps * microbatches * n_proj
    want = {str(d): {"bsr_spmm": a_group * homes.count(d), "bcsr_spmm": a_group * homes.count(d)}
            for d in mesh.cards}
    got = {d: {k: c[k] for k in ("bsr_spmm", "bcsr_spmm")} for d, c in
           sparse["launches_by_card"].items()}
    check(got == want and sum(sparse["launches"].values())
          == sum(sum(v.values()) for v in want.values()),
          ("launches on each group's home card", got, want))
    sparse.update({"projections": n_proj,
                   "launches_per_step_a_group": {"bsr_spmm": microbatches * n_proj,
                                                 "bcsr_spmm": microbatches * n_proj}})
    del sstate, sstate0
    torch.cuda.empty_cache()
    # the pruned FFNs under the split: whole on each group's home card, the
    # sequence gathered there and handed back; its SpMM launches from shapes
    seq["pruned"] = seq_on_model_mesh(scfg, sparams, first, mesh, opt, microbatches, rounds=1,
                                      exchanges=False)
    a_step = microbatches * n_proj
    want = {str(d): {"bsr_spmm": a_step * homes.count(d), "bcsr_spmm": a_step * homes.count(d)}
            for d in mesh.cards}
    got = {d: {k: c[k] for k in ("bsr_spmm", "bcsr_spmm")}
           for d, c in seq["pruned"]["launches_by_card"].items()}
    check(got == want and sum(seq["pruned"]["launches"].values())
          == sum(sum(v.values()) for v in want.values()),
          ("the split pruned step's launches on each group's home card", got, want))
    seq["pruned"]["launches_by_card_from_shapes"] = want
    del sparams
    torch.cuda.empty_cache()

    mcfg = dataclasses.replace(get_config(moe_arch), num_layers=moe_layers)
    mparams = Model(mcfg).init(torch.Generator(device=mesh.device).manual_seed(seed),
                               device=mesh.device)
    moe_params = sum(x.numel() for x in checkpoint.leaves(mparams))
    mstream = SyntheticLM(mcfg.vocab_size, seq_len, global_batch, seed=seed)
    mfirst = {k: torch.from_numpy(v) for k, v in mstream.batch(0).items()}
    moe_held = first_step_against_one_position(
        Model(dataclasses.replace(mcfg, compute_dtype="float32")), mparams, mfirst, mesh,
        microbatches)
    crossing = moe_crossing_step(mcfg, mparams, mesh, seq_len=seq_len, seed=seed,
                                 **moe_crossing)
    mstate0 = placed(mcfg, mparams)
    del mparams
    paths = checkpoint.leaves(checkpoint.map_with_path(lambda k, _: k, mstate0.params))
    banks = [x for k, x in zip(paths, checkpoint.leaves(mstate0.params))
             if k.split("//")[-2:-1] == ["ffn"] and x.ndim == 4]  # (layers, experts, ., .)
    experts = [[c.shape[1] for c in x.chunks[:model]] for x in banks]
    check(banks and all(e == [mcfg.moe.num_experts // model] * model for e in experts),
          ("experts over model", experts))
    mstored = stored_bytes(mstate0, mesh)
    mstep = make_train_step(Model(mcfg), opt, microbatches=microbatches)
    reset_peaks()
    sync_all()
    t0 = time.perf_counter()
    mstate, mmetrics = mstep(mstate0, mfirst)
    sync_all()
    moe_ms = 1e3 * (time.perf_counter() - t0)
    check(held_whole_same_bits(mstate) and moved(mstate0.params, mstate.params)
          and np.isfinite(float(mmetrics["loss"])), "the MoE step")
    moe = {"arch": moe_arch, "layers": moe_layers, "params": moe_params,
           "experts_per_position": experts[0], "first_step_f32": moe_held,
           "groups_crossing": crossing,
           "stored": mstored, "step_ms": moe_ms, "loss": float(mmetrics["loss"]),
           "peak_memory_gb": peaks()}
    del mstate, mstate0
    torch.cuda.empty_cache()

    run = dict(seq_len=seq_len, global_batch=global_batch, microbatches=microbatches, seed=seed)
    mixer_runs = {}
    for name, cut in mixers.items():
        c = cut_config(name, **cut)
        rec, mixer_params = mixer_on_model_mesh(c, mesh, opt,
                                                held_in_f64=name in MIXER_HELD_IN_F64, **run)
        rec["cut"] = cut
        if name == pruned_mixer:
            pcfg = dataclasses.replace(c, sparsity=SparsityConfig(
                (block, block), blocks_per_row=blocks_per_row, targets=("ffn",)))
            pparams = Model(pcfg).sparsify(mixer_params)
            n_pruned = sparse_projections(pparams)
            check(n_pruned == 3 * pcfg.num_layers, n_pruned)
            pruned, _ = mixer_on_model_mesh(pcfg, mesh, opt, params=pparams, **run)
            del pparams
            a_group = microbatches * n_pruned
            want = {str(d): {"bsr_spmm": a_group * homes.count(d),
                             "bcsr_spmm": a_group * homes.count(d)} for d in mesh.cards}
            got = {d: {k: n[k] for k in ("bsr_spmm", "bcsr_spmm")}
                   for d, n in pruned["launches_by_card"].items()}
            check(got == want and sum(pruned["launches"].values())
                  == sum(sum(v.values()) for v in want.values()),
                  ("the pruned FFN's launches on each group's home card", got, want))
            pruned.update({"cut": cut, "projections": n_pruned,
                           "pruned": f"{blocks_per_row} blocks of {block} x {block} a row"})
            rec["pruned_ffn"] = pruned
        else:
            check(sum(rec["launches"].values()) == 0, (name, "no kernel", rec["launches"]))
        if name in seq_mixers:  # the split step held to the unsplit one
            stream_c = SyntheticLM(c.vocab_size, seq_len, global_batch, seed=seed)
            first_c = {k: torch.from_numpy(v) for k, v in stream_c.batch(0).items()}
            seq[name] = {"cut": cut, "against_unsplit_f32": split_against_unsplit(
                Model(dataclasses.replace(c, compute_dtype="float32")), mixer_params, first_c,
                mesh, microbatches)}
        del mixer_params
        mixer_runs[name] = rec
    launches = dict(sparse["launches"])
    for k, n in mixer_runs[pruned_mixer]["pruned_ffn"]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    for k, n in seq["pruned"]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    tokens = seq_len * global_batch
    return {"arch": arch, "mesh": dict(mesh.shape), "cards": len(mesh.cards),
            "devices": [str(d) for d in mesh.devices], "homes": [str(d) for d in homes],
            "seq_len": seq_len, "global_batch": global_batch, "microbatches": microbatches,
            "steps": steps, "tokens_per_step": tokens,
            "optimizer": f"adamw(warmup_cosine({lr}, 10, 100), state_dtype=float32)",
            "dense": {**dense, "tokens_per_s": tokens / (dense["step_ms"] / 1e3)},
            "sparse": {**sparse, "tokens_per_s": tokens / (sparse["step_ms"] / 1e3)},
            "moe": moe, "mixers": mixer_runs, "seq": seq, "launches": launches}


def moe_crossing_step(cfg, params, mesh, *, seq_len: int, global_batch: int,
                      microbatches: int, seed: int) -> dict:
    """The first f32 step of the MoE ``cfg`` on ``mesh`` held to one position
    (:func:`first_step_against_one_position`) on a batch whose microbatches
    give each data index fewer tokens than the token group of the whole
    microbatch, so the groups cross data indices; with the step's
    ``moe_gather``/``moe_return`` exchanges."""
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.distribution import tensor_parallel as tp
    from repro_torch.distribution.sharding import moe_groups_cross
    from repro_torch.models import Model

    data = len(mesh.devices) // mesh.shape["model"]
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed).batch(0).items()}
    rows = global_batch // microbatches // data
    check(moe_groups_cross(cfg, {"inputs": batch["inputs"][:rows]}, data),
          ("the MoE token groups cross data indices", rows, seq_len))
    tp.reset_exchange_counts()
    held = first_step_against_one_position(
        Model(dataclasses.replace(cfg, compute_dtype="float32")), params, batch, mesh,
        microbatches)
    ex = {k: v for k, v in tp.exchange_counts().items() if k.startswith("moe_")}
    layers = sum(s.ffn == "moe" for s in cfg.layer_specs())
    check(all(ex.get(k, {}).get("calls") == 2 * microbatches * layers
              for k in ("moe_gather", "moe_return")), ("a gather and a return a MoE layer", ex))
    return {"global_batch": global_batch, "microbatches": microbatches,
            "tokens_a_data_index": rows * seq_len, "first_step_f32": held, "exchanges": ex}


def serve_moe(arch: str, num_layers: int, new_tokens: int, mesh, batch: int, cache_len: int,
              prompt_len: int, seed: int) -> dict:
    """``arch`` at published width cut to ``num_layers`` layers, served over
    ``mesh`` where its MoE token groups cross data indices: how many
    (token, expert) assignments of the one-device prefill and first decode
    step each data index's own groups would route otherwise
    (``moe.rerouted``; more than 0), the serve held at f32 to the
    one-device path and ``Engine`` (:func:`serve_held`), then timed at
    bf16 (:func:`serve_timed`) with its exchange bytes by kind."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distribution.sharding import moe_groups_cross
    from repro_torch.models import Model, moe
    from repro_torch.train import checkpoint

    dev = mesh.device
    data = len(mesh.devices) // mesh.shape["model"]
    cfg = dataclasses.replace(get_config(arch), num_layers=num_layers)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed + 1))
    rows = prompts[:batch // data]
    check(moe_groups_cross(cfg, {"inputs": rows}, data)
          and moe_groups_cross(cfg, {"inputs": rows[:, 0]}, data),
          ("the prefill's and the decode's MoE token groups cross data indices", batch))
    seen, apply_moe = [], moe.apply_moe

    def spy(p, c, x, act, glu):
        seen.append((p["router"], x.detach()))
        return apply_moe(p, c, x, act, glu)

    moe.apply_moe = spy
    try:
        one_device_serve(Model(f32), params, prompts, 2, cache_len)
    finally:
        moe.apply_moe = apply_moe
    rerouted = {call: sum(moe.rerouted(r, cfg.moe, x, data) for r, x in seen
                          if (x.shape[1] > 1) == (call == "prefill"))
                for call in ("prefill", "decode")}
    check(sum(rerouted.values()) > 0, ("each data index's own groups route as the batch's",
                                       rerouted))
    held = serve_held(Model(f32), params, mesh, prompts, new_tokens, cache_len)
    layers = sum(s.ffn == "moe" for s in cfg.layer_specs())
    check(all(held["prefill_exchanges"].get(k, {}).get("calls") == layers
              for k in ("moe_gather", "moe_return")), ("the prefill's MoE exchanges", held))
    timed = serve_timed(Model(cfg), params, mesh, prompts, new_tokens, cache_len)
    return {"arch": arch, "num_layers": num_layers, "new_tokens": new_tokens,
            "params": sum(x.numel() for x in checkpoint.leaves(params)),
            "moe": {"experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                    "shared": cfg.moe.num_shared_experts,
                    "token_groups": {"prefill": [moe._group_size(batch * prompt_len),
                                                 moe._group_size(batch * prompt_len // data)],
                                     "decode": [moe._group_size(batch),
                                                moe._group_size(batch // data)]}},
            "rerouted_assignments": rerouted, "f32": held, "timed": timed,
            "exchange_bytes_a_decode_step": {k: v["bytes"] for k, v in
                                             timed["exchanges_a_decode_step"].items()}}


def placed_for_serving(model, params, mesh, batch: int, cache_len: int) -> tuple:
    """(``params`` placed by ``param_pspecs``, a fresh cache placed by
    ``cache_pspecs``) on ``mesh``."""
    from repro_torch.distribution.sharding import cache_pspecs, param_pspecs, place, shardings_for

    pp = place(params, shardings_for(None, mesh, param_pspecs(model.cfg, params, mesh)))
    cache = model.init_cache(batch, cache_len, device=mesh.device)
    return pp, place(cache, shardings_for(None, mesh, cache_pspecs(model.cfg, cache, mesh)))


def greedy(logits):
    import torch

    return torch.argmax(logits, dim=-1).to(torch.int32)


def one_device_serve(model, params, prompts, new_tokens: int, cache_len: int, *,
                     feed=None) -> tuple[list, list, object]:
    """The one-device prefill and ``new_tokens - 1`` decode steps of
    ``model`` (``Model.prefill``/``decode_step``): (each call's logits, the
    prefill's last position's; the greedy tokens; the cache). Decode step
    i is fed ``feed[i]`` where given, else its own greedy token."""
    b, s = prompts.shape
    cache = model.init_cache(b, cache_len, device=prompts.device)
    logits, cache = model.prefill(params, prompts, cache)
    calls = [logits[:, -1]]
    toks = [greedy(calls[-1])]
    for i in range(new_tokens - 1):
        logits, cache = model.decode_step(params, toks[i] if feed is None else feed[i], cache,
                                          s + i)
        calls.append(logits)
        toks.append(greedy(logits))
    return calls, toks, cache


def serve_greedy(model, pp, cache, prompts, new_tokens: int, *, feed=None) -> tuple:
    """A prefill of ``prompts`` and ``new_tokens - 1`` greedy decode steps
    through ``make_serve_fns`` over placed params ``pp`` and a placed
    ``cache`` (written in place): (each call's logits, the prefill's last
    position's; each call's ms on the host clock, every card synchronised
    before and after it; each call's ``tensor_parallel.exchange_counts``).
    Decode step i is fed ``feed[i]`` where given (another path's greedy
    tokens), else the greedy token of the call before."""
    from repro_torch.distribution import tensor_parallel as tp
    from repro_torch.serve.engine import make_serve_fns

    prefill_fn, decode_fn = make_serve_fns(model)
    s = prompts.shape[1]
    calls, ms, exchanges = [], [], []
    for i in range(new_tokens):
        tp.reset_exchange_counts()
        sync_all()
        t0 = time.perf_counter()
        if i == 0:
            logits = prefill_fn(pp, prompts, cache)[0][:, -1]
        else:
            tok = greedy(calls[-1]) if feed is None else feed[i - 1]
            logits = decode_fn(pp, tok, cache, s + i - 1)[0]
        sync_all()
        ms.append(1e3 * (time.perf_counter() - t0))
        exchanges.append(tp.exchange_counts())
        calls.append(logits)
    return calls, ms, exchanges


def serve_held(model, params, mesh, prompts, new_tokens: int, cache_len: int, *,
               hold: bool = True, plain=None) -> dict:
    """The greedy serve through ``make_serve_fns`` over ``params`` and a cache
    placed on ``mesh`` against the one-device path on the same weights
    (:func:`one_device_serve`, and ``Engine.generate``), then the mesh fed
    the one-device path's tokens (:func:`serve_greedy`), launches counted
    from 0 over the mesh's calls alone. Held (``hold``): every call's
    logits within ``LLM_F32_TOL`` of each row's max |logit|, the mesh's
    greedy tokens the one-device path's and the engine's, and every cache
    chunk in its own storage after the calls. ``plain``: another model of
    the same weights (the plain products in place of the kernels), its
    one-device calls fed the same tokens, the mesh's logits held to its
    too. Also the placed cache, gathered, against the one-device cache
    (each leaf's max error over its max)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine
    from repro_torch.train import checkpoint

    b = prompts.shape[0]
    want, toks, one = one_device_serve(model, params, prompts, new_tokens, cache_len)
    engine_tokens, _ = Engine(model, params, batch_size=b, cache_len=cache_len,
                              device=mesh.device).generate(prompts, new_tokens)
    pp, cache = placed_for_serving(model, params, mesh, b, cache_len)
    ptrs = [c.data_ptr() for x in checkpoint.leaves(cache) for c in x.chunks]
    sync_all()
    ops.reset_launch_counts()
    got, ms, exchanges = serve_greedy(model, pp, cache, prompts, new_tokens, feed=toks)
    sync_all()
    launches = {str(d): ops.launch_counts(d) for d in mesh.cards}
    total = ops.launch_counts()
    errs = [row_rel(g, w) for g, w in zip(got, want)]
    same = [torch.equal(greedy(g), t) for g, t in zip(got, toks)]
    kept = ptrs == [c.data_ptr() for x in checkpoint.leaves(cache) for c in x.chunks]
    engine_same = torch.equal(engine_tokens, torch.stack(toks, 1))
    cache_err = max(float((x.gather(mesh.device).double() - y.double()).abs().max())
                    / max(float(y.double().abs().max()), 1e-30)
                    for x, y in zip(checkpoint.leaves(cache), checkpoint.leaves(one)) if y.numel())
    rec = {"max_row_rel": max(errs), "row_rel_by_call": errs, "tokens_equal": all(same),
           "engine_tokens_equal": engine_same, "cache_storages_kept": kept,
           "cache_rel_err": cache_err, "first_tokens": torch.stack(toks, 1)[:, :8].tolist(),
           "launches_by_card": launches, "launches": total, "calls": new_tokens,
           "prefill_ms": ms[0], "prefill_exchanges": exchanges[0]}
    held = all(same) and engine_same and kept and max(errs) <= LLM_F32_TOL
    if plain is not None:
        ref, _, _ = one_device_serve(plain, params, prompts, new_tokens, cache_len, feed=toks)
        rec["plain_row_rel_by_call"] = [row_rel(g, w) for g, w in zip(got, ref)]
        rec["plain_max_row_rel"] = max(rec["plain_row_rel_by_call"])
        held = held and rec["plain_max_row_rel"] <= LLM_F32_TOL
    if hold:
        check(held, (model.cfg.name, "the mesh's serve is the one-device serve", rec))
    return rec


def serve_timed(model, params, mesh, prompts, new_tokens: int, cache_len: int) -> dict:
    """The greedy serve through ``make_serve_fns`` at the config's compute
    dtype (the params cast once, the serving copy ``Engine`` holds),
    timed on the host clock with every card synchronised
    (:func:`serve_greedy`): the prefill and each decode step; the second
    decode step's exchanges between model positions by kind
    (``tensor_parallel.exchange_counts``) and one more step's device ms on
    each card (profiler); the per-call gather of the groups' params on its
    own and its share of a decode step; each position's stored bytes
    (params and cache chunks) and each card's peak."""
    import torch

    from repro_torch.distribution.sharding import group_params
    from repro_torch.models.model import cast_floating
    from repro_torch.serve.engine import make_serve_fns
    from repro_torch.train import checkpoint

    b, s = prompts.shape
    for d in mesh.cards:
        torch.cuda.reset_peak_memory_stats(d)
    pp, cache = placed_for_serving(model, cast_floating(params, model.compute_dtype), mesh, b,
                                   cache_len)
    owners = checkpoint.leaves(pp)
    stored = [sum(x.chunks[p].numel() * x.chunks[p].element_size()
                  for x in owners + checkpoint.leaves(cache)) for p in range(mesh.size)]
    calls, ms, exchanges = serve_greedy(model, pp, cache, prompts, new_tokens)
    prefill_ms, step_ms, counts = ms[0], ms[1:], exchanges[2]
    check(bool(torch.isfinite(calls[-1]).all()), (model.cfg.name, "finite logits"))
    n = len(mesh.devices) // mesh.shape["model"]
    groups = n if b % n == 0 else 1
    gather_ms = []
    for _ in range(3):
        sync_all()
        t0 = time.perf_counter()
        trees = group_params(pp, owners, mesh, groups)
        sync_all()
        gather_ms.append(1e3 * (time.perf_counter() - t0))
        del trees
    step = statistics.median(step_ms)
    _, decode_fn = make_serve_fns(model)
    device_ms = device_ms_by_card(
        lambda: decode_fn(pp, greedy(calls[-1]), cache, s + new_tokens - 1))
    return {"compute_dtype": model.cfg.compute_dtype, "prefill_ms": prefill_ms,
            "decode_step_ms": step, "decode_step_ms_all": step_ms,
            "tokens_per_s": b / (step / 1e3), "decode_device_ms_by_card": device_ms,
            "exchanges_a_decode_step": counts,
            "exchange_mb_a_decode_step": sum(c["bytes"] for c in counts.values()) / 1e6,
            "param_gather_ms": statistics.median(gather_ms),
            "param_gather_share_of_decode": statistics.median(gather_ms) / step,
            "stored_gb_by_position": [x / 1e9 for x in stored],
            "peak_memory_gb": {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                               for d in mesh.cards}}


def split_cache_leaves(model, mesh, batch: int, cache_len: int) -> list:
    """The cache leaves ``cache_pspecs`` splits over ``model`` (their key)."""
    from repro_torch.distribution.sharding import Sharding, cache_pspecs
    from repro_torch.train import checkpoint

    cache = model.init_cache(batch, cache_len, device="meta")
    specs = checkpoint.leaves(cache_pspecs(model.cfg, cache, mesh))
    keys = checkpoint.leaves(checkpoint.map_with_path(lambda k, _: k, cache))
    return sorted({k.split("//")[-1] for k, spec in zip(keys, specs)
                   if Sharding(mesh, spec).model_dim is not None})


def phase_llm_serve_model(arch: str, data: int, model: int, batch: int, cache_len: int,
                          prompt_len: int, new_tokens: int, block: int, blocks_per_row: int,
                          pruned_tokens: int, mixers: dict, long: dict, moe: dict,
                          seed: int) -> dict:
    """Serving over the model's ``data`` × ``model`` mesh (:func:`model_mesh`)
    through ``make_serve_fns``: params placed by ``param_pspecs``, the cache
    by ``cache_pspecs`` (attention slots over ``model``, Mamba's channels,
    RWKV-6's heads), each group's rows with its split weights, the decode
    attention's slot ranges merged in model order. ``arch`` at published
    width, f32 compute held against the one-device path and ``Engine``
    (:func:`serve_held`) across the slot-range boundary, then timed at its
    compute dtype (:func:`serve_timed`); again with every FFN pruned to
    ``blocks_per_row`` blocks of ``block`` × ``block`` a row, held at f32
    against the one-device path with the kernels and with the plain
    products, its ``bsr_spmm`` launches on each group's home card held to the count
    from shapes; then each of ``mixers`` (cut by :func:`cut_config`, sizes
    from ``long`` where given) on ``data`` 1 × ``model``, held at f32
    (``MIXER_HELD_IN_F64``: held in f64, the f32 errors printed) and
    timed; then ``moe``'s cut on the same mesh, its token groups crossing
    data indices (:func:`serve_moe`)."""
    import torch

    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.distribution.sharding import activate
    from repro_torch.models import Model
    from repro_torch.models.model import cast_floating
    from repro_torch.train import checkpoint

    mesh = model_mesh(data, model)
    homes = mesh.devices[::model]
    dev = mesh.device
    cfg = get_config(arch)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed + 1))
    check(prompt_len < cache_len // model < prompt_len + new_tokens,
          ("the decode crosses into model position 1's slots", prompt_len, new_tokens))
    held = serve_held(Model(f32), params, mesh, prompts, new_tokens, cache_len)
    timed = serve_timed(Model(cfg), params, mesh, prompts, new_tokens, cache_len)
    # the prefill with its sequence split over model (prompt_len / model tokens a
    # position), held the same way; the decode steps (S = 1) run unsplit
    with activate(mesh, seq_rules()):
        seq = serve_held(Model(f32), params, mesh, prompts, new_tokens, cache_len)
    ex = seq["prefill_exchanges"]
    check(ex.get("seq_gather", {}).get("bytes", 0) > 0
          and ex.get("seq_reduce", {}).get("bytes", 0) > 0
          and "seq_gather" not in held["prefill_exchanges"], ("the split prefill", ex))
    seq.update(tokens_a_position=prompt_len // model, unsplit_prefill_ms=held["prefill_ms"],
               unsplit_prefill_exchanges=held["prefill_exchanges"])

    pcfg = dataclasses.replace(f32, sparsity=SparsityConfig(
        (block, block), blocks_per_row=blocks_per_row, targets=("ffn",)))
    pparams = Model(pcfg).sparsify(params)
    del params
    n_proj = sparse_projections(pparams)
    check(n_proj == 3 * cfg.num_layers, n_proj)
    pruned = serve_held(Model(pcfg), pparams, mesh, prompts, pruned_tokens, cache_len,
                        plain=Model(pcfg, use_kernel=False))
    del pparams
    want = {str(d): {"bsr_spmm": pruned_tokens * n_proj * homes.count(d)} for d in mesh.cards}
    got = {d: {"bsr_spmm": c["bsr_spmm"]} for d, c in pruned["launches_by_card"].items()}
    check(got == want and all(sum(c.values()) == c["bsr_spmm"]
                              for c in pruned["launches_by_card"].values()),
          ("bsr_spmm on each group's home card", got, want))
    pruned.update({"projections": n_proj, "launches_by_card_from_shapes": want,
                   "pruned": f"{blocks_per_row} blocks of {block} x {block} a row"})
    torch.cuda.empty_cache()

    runs = {}
    mesh1 = model_mesh(1, model)
    for name, cut in mixers.items():
        c = cut_config(name, **cut)
        sizes = {"cache_len": cache_len, "prompt_len": prompt_len, "new_tokens": new_tokens,
                 **long.get(name, {})}
        mparams = Model(c).init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        mprompts = torch.randint(0, c.vocab_size, (batch, sizes["prompt_len"]), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(seed + 1))
        args = (mesh1, mprompts, sizes["new_tokens"], sizes["cache_len"])
        c32 = dataclasses.replace(c, compute_dtype="float32")
        rec = {"cut": cut, **sizes,
               "params": sum(x.numel() for x in checkpoint.leaves(mparams)),
               "cache_leaves_split": split_cache_leaves(Model(c), mesh1, batch,
                                                        sizes["cache_len"])}
        check(rec["cache_leaves_split"], (name, "cache leaves split over model"))
        if name in MIXER_HELD_IN_F64:
            rec["f32"] = serve_held(Model(c32), mparams, *args, hold=False)
            c64 = dataclasses.replace(c, compute_dtype="float64", param_dtype="float64")
            with f64_casts():
                rec["float64"] = serve_held(Model(c64), cast_floating(mparams, torch.float64),
                                            *args)
        else:
            rec["f32"] = serve_held(Model(c32), mparams, *args)
        rec["timed"] = serve_timed(Model(c), mparams, *args)
        del mparams
        torch.cuda.empty_cache()
        runs[name] = rec
    moe_run = serve_moe(**moe, mesh=mesh, batch=batch, cache_len=cache_len,
                        prompt_len=prompt_len, seed=seed)
    torch.cuda.empty_cache()
    return {"arch": arch, "mesh": dict(mesh.shape), "cards": len(mesh.cards),
            "devices": [str(d) for d in mesh.devices], "homes": [str(d) for d in homes],
            "batch": batch, "cache_len": cache_len, "slots_a_position": cache_len // model,
            "prompt_len": prompt_len, "new_tokens": new_tokens,
            "cache_leaves_split": split_cache_leaves(Model(cfg), mesh, batch, cache_len),
            "f32": held, "timed": timed, "seq": seq, "pruned_ffn": pruned,
            "tolerance": {"f32": LLM_F32_TOL}, "mixers": runs, "moe": moe_run,
            "mixers_mesh": dict(mesh1.shape),
            "launches": pruned["launches"]}


def dryrun_meta_record(arch: str, shape: str, global_batch: int | None,
                       microbatches: int | None) -> dict:
    """The dry run's record of one cell on the card's mesh, traced on
    ``meta`` (run in a worker process beside the card's runs)."""
    from repro_torch.launch import dryrun

    (rec,) = dryrun.run_cell(arch, shape, meshes=("card",), global_batch=global_batch,
                             microbatches=microbatches)
    return rec


def cache_ptrs(tree) -> list[int]:
    from repro_torch.models.layers import tree_leaves

    return [t.untyped_storage().data_ptr() for t in tree_leaves(tree)]


def fixed_bytes(plan) -> int:
    """The bytes of a serving plan that do not grow with the batch: the
    parameters and the compute-dtype copy every call casts
    (``models.model.cast_floating``)."""
    import torch

    from repro_torch.models.layers import tree_leaves

    copy = torch.empty((), dtype=plan.model.compute_dtype).element_size()
    return sum(t.nbytes + (t.numel() * copy if t.is_floating_point() else 0)
               for t in tree_leaves(plan.args[0]))


def largest_batch(rec: dict, fixed: int, limit: int) -> int:
    """The largest batch whose peak, at the per-sequence bytes of ``rec``'s
    trace above ``fixed``, stays within ``limit``."""
    per_seq = (rec["memory"]["peak_per_device_bytes"] - fixed) / rec["global_batch"]
    return int((limit - fixed) // per_seq)


def next_batch_peak(rec: dict, fixed: int) -> float:
    """``rec``'s peak one sequence up, at its own bytes per sequence."""
    b = rec["global_batch"]
    return rec["memory"]["peak_per_device_bytes"] * (b + 1) / b - fixed / b


def card_measure(plan, args, *, donated: bool) -> tuple[dict, object]:
    """``plan.fn`` on the card's ``args`` once under ``FlopCounterMode``: its
    FLOPs, the peak the call adds to what the process held besides ``args``
    (``max_memory_allocated`` after ``reset_peak_memory_stats``), its time
    under the counter, and whether a donated cache kept its storages."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - dryrun.live_bytes(args, "cuda")
    ptrs = cache_ptrs(args[2]) if donated else None
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        ms, out = synced_ms(lambda: plan.fn(*args))
    res = {"global_batch": plan.cell.global_batch, "flops": counter.get_total_flops(),
           "peak_bytes": torch.cuda.max_memory_allocated() - held, "counted_ms": ms}
    if donated:
        res["cache_in_place"] = cache_ptrs(out[1]) == ptrs
        check(res["cache_in_place"], ("a donated cache moved", plan.name))
    return res, out


def hold_to_dryrun(res: dict, rec: dict) -> dict:
    """A card run (``card_measure``) held to the dry run's record of the
    same cell: FLOPs equal, peak within ``DRYRUN_PEAK_RTOL``."""
    want = rec["memory"]["peak_per_device_bytes"]
    res.update(dryrun_flops=rec["flops_per_device"], dryrun_peak_bytes=want,
               peak_rel_err=res["peak_bytes"] / want - 1,
               bound_ms=rec["roofline"]["step_time_lower_bound_s"] * 1e3,
               bound_by=rec["roofline"]["dominant"], dryrun_trace_s=rec["trace_s"],
               useful_flops_fraction=rec["useful_flops_fraction"])
    check(res["flops"] == rec["flops_per_device"], ("FLOPs on the card vs the dry run", res))
    check(abs(res["peak_rel_err"]) <= DRYRUN_PEAK_RTOL, ("peak on the card vs the dry run", res))
    return res


def card_run(plan, args, rec: dict, *, donated: bool) -> tuple[dict, object]:
    """``card_measure`` and ``hold_to_dryrun`` of one call."""
    res, out = card_measure(plan, args, donated=donated)
    return hold_to_dryrun(res, rec), out


def tile_rows(cache, rows, batch: int) -> None:
    """``cache``'s ``batch`` rows copied from ``rows``' R rows in turn
    (row b from row b mod R), one row at a time."""
    from repro_torch.models.layers import tree_leaves

    for dst, src in zip(tree_leaves(cache), tree_leaves(rows)):
        if dst.shape == src.shape:
            dst.copy_(src)
            continue
        dim = next(i for i, (a, b) in enumerate(zip(dst.shape, src.shape)) if a != b)
        for b in range(batch):
            dst.select(dim, b).copy_(src.select(dim, b % src.shape[dim]))


def fill_cache(cache, filled: int, generator) -> None:
    """``cache`` as a prefill of ``filled`` positions would leave its
    shapes: seeded keys and values, every attention layer's positions
    (a window layer's as its ring holds them)."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.train import checkpoint

    def fill(path, t):
        if path.endswith("positions"):
            size = t.shape[-1]
            pos = (attn._ring_positions(size, filled, t.device) if size < filled else
                   torch.cat([torch.arange(filled, dtype=torch.int32, device=t.device),
                              torch.full((size - filled,), -1, dtype=torch.int32,
                                         device=t.device)]))
            t.copy_(pos.expand(t.shape))
        elif t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device))

    checkpoint.map_with_path(fill, cache)


def dryrun_long(arch: str, rec: dict, seed: int) -> dict:
    """``long_500k`` at full size on the card: a cache filled as by a
    prefill of S - 1 positions, the out-of-place decode of position S - 1,
    then the plan's donated decode on the same inputs: held to the dry run
    (``card_run``) and to the out-of-place decode bit for bit."""
    import torch

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import tree_leaves

    dev = torch.device("cuda")
    plan = specs.make_plan(arch, "long_500k", make_production_mesh(device="meta"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, token, cache, _ = dryrun.materialize(plan, device=dev, generator=gen)
    s = plan.cell.seq_len
    fill_cache(cache, s - 1, gen)
    pos = torch.tensor(s - 1, dtype=torch.int32)
    want, want_cache = plan.model.decode_step(params, token, cache, pos)
    res, (got, got_cache) = card_run(plan, (params, token, cache, pos), rec, donated=True)
    res["bitwise_equal_to_out_of_place"] = bool(
        torch.equal(got, want) and all(torch.equal(a, b) for a, b in
                                       zip(tree_leaves(got_cache), tree_leaves(want_cache))))
    check(res["bitwise_equal_to_out_of_place"], "donated decode vs out-of-place, long_500k")
    check(bool(torch.isfinite(got.float()).all()), "non-finite long_500k logits")
    res["ms"] = statistics.median(synced_ms(lambda: plan.fn(params, token, cache, pos))[0]
                                  for _ in range(3))
    res["cache_bytes"] = sum(t.nbytes for t in tree_leaves(cache))
    return res


def dryrun_train(arch: str, limit: int, seed: int) -> dict:
    """``train_4k`` on the card at the largest global batch, a multiple of
    its microbatches, whose dry-run peak fits ``limit``. The plan's 8
    microbatches hold at least what one microbatch of one sequence holds
    and an f32 gradient accumulator besides (``trainer.make_train_step``):
    where that does not fit, the cut is one sequence a microbatch, and two
    sequences in two must not fit. Loss and gradient norm finite."""
    import torch

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import tree_leaves

    plan = specs.make_plan(arch, "train_4k", make_production_mesh(device="meta"),
                           microbatches=1, global_batch=1)
    rec = dryrun_meta_record(arch, "train_4k", 1, 1)
    peak = rec["memory"]["peak_per_device_bytes"]
    acc = sum(t.numel() * 4 for t in tree_leaves(plan.args[0].params)
              if t.is_floating_point())
    check(peak + acc > limit, "the plan's own microbatches may fit: trace them before cutting")
    check(peak <= limit, ("train_4k fits at no batch", rec))
    two = dryrun_meta_record(arch, "train_4k", 2, 2)
    check(two["memory"]["peak_per_device_bytes"] > limit, ("two sequences fit", two))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = dryrun.materialize(plan, device="cuda", generator=gen)
    res, (state, metrics) = card_run(plan, args, rec, donated=False)
    res.update(microbatches=1, plan_microbatches=specs.DEFAULT_MICROBATCHES,
               plan_microbatches_peak_at_least=peak + acc,
               two_sequence_peak_bytes=two["memory"]["peak_per_device_bytes"],
               loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))
    check(np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"]), ("train_4k", res))
    del state, metrics
    res["ms"] = synced_ms(lambda: plan.fn(*args))[0]
    return res


def decode_vs_prefill(model, params, tokens, got, want, tile, pos) -> dict:
    """decode_32k's logits against the S-position prefill's last ones. At
    the plan's bf16 compute the two paths differ in their attention's
    arithmetic (decode: bf16 scores and probabilities over the cache;
    prefill: the streaming f32 online softmax), and at 32 768 positions
    they lie further apart than ``LLM_TOL`` (``PERF.md`` §6): printed,
    beside each one's distance from the f32 computation of the same
    logits. Held:
    the same donated decode path at f32 compute on the same weights,
    within ``LLM_F32_TOL`` of the f32 prefill, on the first prompt."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.serve.engine import make_serve_fns

    s = tokens.shape[1]
    model32 = Model(dataclasses.replace(model.cfg, compute_dtype="float32"))
    prefill32, decode32 = make_serve_fns(model32)
    one = tokens[:1]
    truth, _ = prefill32(params, one, model32.init_cache(1, s, device=one.device))
    _, cache = prefill32(params, one[:, :s - 1], model32.init_cache(1, s, device=one.device))
    dec32, _ = decode32(params, one[:, s - 1], cache, pos)
    res = {"bf16_decode_vs_prefill_row_rel": row_rel(got, want[tile]),
           "bf16_decode_vs_f32_row_rel": row_rel(got[:1], truth[:, -1]),
           "bf16_prefill_vs_f32_row_rel": row_rel(want[:1], truth[:, -1]),
           "f32_decode_vs_prefill_row_rel": row_rel(dec32, truth[:, -1]),
           "tolerance": {"f32": LLM_F32_TOL}}
    check(res["f32_decode_vs_prefill_row_rel"] <= LLM_F32_TOL, ("decode_32k vs prefill", res))
    return res


def dryrun_records(mesh: str = "card", cells=None, skip=()) -> tuple[dict, float]:
    """The dry run's records of ``cells`` (arch, shape), default every
    arch's ``decode_32k`` and ``long_500k`` less ``skip``, on ``mesh``
    (``card``, or ``single``: ``pod16x16``, from the trace of the mesh path
    over it), each ``ok`` or ``skipped`` with its assigned reason (none
    ``refused``: an MoE decode whose token groups cross data indices
    gathers them on position 0, its ``moe_gather``/``moe_return`` bytes at
    position 0 and its collective time printed), printed on a line of its
    own, and the seconds they took (run in a worker process)."""
    from repro_torch.configs import ARCHS, SHAPE_CELLS, get_config
    from repro_torch.launch import dryrun, specs

    if cells is None:
        cells = [(a, shape) for a in ARCHS for shape in ("decode_32k", "long_500k")
                 if (a, shape) not in skip]
    recs, t0 = {}, time.perf_counter()
    for a, shape in cells:
        for rec in dryrun.run_cell(a, shape, meshes=(mesh,)):
            cfg = get_config(a)
            reason = specs.skip_reason(cfg, SHAPE_CELLS[shape])
            check(rec["status"] == ("skipped" if reason else "ok"), rec)
            recs[a, shape, rec["mesh"]] = rec
            line = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "chips",
                                            "flops_per_device", "bytes_per_device",
                                            "useful_flops_fraction", "trace_s", "reason")}
            if rec["status"] == "ok":
                mem, r = rec["memory"], rec["roofline"]
                line.update(peak_per_device_bytes=mem["peak_per_device_bytes"],
                            temp_bytes=mem["temp_bytes"],
                            bound_s=r["step_time_lower_bound_s"], dominant=r["dominant"],
                            t_collective_s=r["t_collective_s"])
                if rec["collectives"] is not None:
                    line.update(total_bytes=rec["collectives"]["total_bytes"],
                                busiest_position=rec["busiest_position"],
                                peak_position=rec["peak_position"],
                                traced_groups=rec["traced_groups"],
                                t_collective_s_position_0=rec["per_position"]
                                ["t_collective_s"][0])
                    links = rec["collectives"]["moe_links"]
                    if cfg.moe is not None and shape == "decode_32k":
                        check(links, ("the MoE decode's rows gathered on position 0", a))
                    if links:
                        line["moe_bytes_position_0"] = {
                            k: sum(x["bytes"] for x in links
                                   if x["kind"] == k and 0 in (x["src"], x["dst"]))
                            for k in ("moe_gather", "moe_return")}
                        line["moe_axes"] = sorted({x["axis"] for x in links})
            emit({"dryrun_record": line})
    return recs, time.perf_counter() - t0


def mesh_plan(arch: str, shape: str, mesh, batch: int, train_layers: int, seq: bool = False):
    """``arch``'s plan of ``shape`` for ``mesh`` at global batch ``batch``:
    train in one microbatch, cut to ``train_layers`` layers; ``seq``: under
    :func:`seq_rules` (``--seq-shard``)."""
    from repro_torch.launch import specs

    train = shape == "train_4k"
    return specs.make_plan(arch, shape, mesh, global_batch=batch,
                           microbatches=1 if train else None,
                           config=cut_config(arch, train_layers) if train else None,
                           rules=seq_rules() if seq else None)


def mesh_cell(name: str) -> tuple[str, bool]:
    """A mesh cell's shape and whether its sequence splits (``_seq``)."""
    return name.removesuffix("_seq"), name.endswith("_seq")


def dryrun_mesh_traces(arch: str, data: int, model: int, train_layers: int,
                       limit: int) -> dict:
    """``DRYRUN_MESH``'s cells traced through the mesh path on a ``meta``
    ``data`` × ``model`` mesh (``dryrun.mesh_trace``, every move between
    positions a copy, as on one card a position): each at the largest
    batch, a multiple of ``data``, whose traced peak for the whole device
    fits ``limit``: traces at ``data`` and ``2·data`` rows, then at the
    batch the line through the last two traces puts at the limit, until
    one batch fits and the next one up (traced) does not; ``train_4k_seq``
    is ``train_4k`` at the same batch with its sequence split over
    ``model`` (:func:`seq_rules`, ``--seq-shard``). Run in a worker
    process."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(data, model=model, device="meta")
    out = {}
    for cell, cap in (("train_4k", 256), ("train_4k_seq", None), ("decode_32k", 128)):
        shape, seq = mesh_cell(cell)
        runs = {}

        def traced(b):
            plan = mesh_plan(arch, shape, mesh, b, train_layers, seq)
            runs[b] = plan, dryrun.mesh_trace(plan, mesh)
            return runs[b]

        if seq:  # the unsplit cell's batch
            batch = out[shape]["batch"]
            probes = {batch: traced(batch)[1]["peak_bytes"]}
            check(probes[batch] <= limit, (cell, "does not fit", probes, limit))
        else:
            probes = {b: traced(b)[1]["peak_bytes"] for b in (data, 2 * data)}
            check(probes[data] <= limit, (shape, "fits at no batch", probes, limit))
        while not seq:  # the secant through the two traces nearest the limit
            batch = max(b for b, p in probes.items() if p <= limit)
            over = min((b for b, p in probes.items() if p > limit), default=None)
            if batch == cap or over == batch + data:
                break
            other = over if over is not None else max(b for b in probes if b < batch)
            per_row = (probes[other] - probes[batch]) / (other - batch)
            guess = batch + data * int((limit - probes[batch]) // (per_row * data))
            guess = min(max(guess, batch + data), cap if over is None else over - data)
            probes[guess] = traced(guess)[1]["peak_bytes"]
        plan, mt = runs[batch]
        name = f"{data}x{model}"
        rec = dryrun.mesh_record(arch, shape, plan, mt, mesh, name, rules=plan.rules)
        out[cell] = {
            "batch": batch, "layers": plan.model.cfg.num_layers, "probes": probes,
            "next_batch_peak_bytes": probes.get(batch + data), "trace_s": mt["trace_s"],
            "flops": mt["flops"], "peak_bytes": mt["peak_bytes"],
            "positions": mt["positions"], "exchanges": mt["exchanges"],
            "links": sorted((k, s, d, v["calls"], v["bytes"])
                            for (k, s, d), v in mt["links"].items()),
            "collectives": {k: rec["collectives"][k] for k in
                            ("per_kind_bytes", "per_kind_count", "total_bytes",
                             "per_axis_bytes", "position")},
            "t_collective_s": rec["roofline"]["t_collective_s"],
            "dominant": rec["roofline"]["dominant"],
            "bound_s": rec["roofline"]["step_time_lower_bound_s"],
            "per_position_t_collective_s": rec["per_position"]["t_collective_s"],
            "layout": rec["layout"], "seq_axis": rec["seq_axis"],
        }
        check(seq or batch == cap or out[cell]["next_batch_peak_bytes"] > limit,
              (shape, "a larger mesh batch fits", probes))
    return out


def fresh_placed_cache(plan, mesh):
    """The plan's cache placed on ``mesh`` as ``Model.init_cache`` fills it
    (zeros; -1, an empty slot, in the int32 positions), each chunk made on
    its position's device: never whole on one card."""
    import torch

    from repro_torch.distribution import sharding as sh
    from repro_torch.train import checkpoint

    specs_ = checkpoint.leaves(plan.args[2])
    shardings = checkpoint.leaves(sh.shardings_for(None, mesh, plan.in_shardings[2]))
    return checkpoint.with_leaves(plan.args[2], [
        sh.Placed(tuple(torch.full(s.part(leaf, p).shape, -1 if leaf.dtype == torch.int32
                                   else 0, dtype=leaf.dtype, device=d)
                        for p, d in enumerate(mesh.devices)), s)
        for leaf, s in zip(specs_, shardings)])


def position_bytes(tree, mesh) -> list[int]:
    """Each position's live bytes of ``tree``'s placed chunks, rounded as
    the caching allocator rounds a block."""
    from repro_torch.launch import dryrun
    from repro_torch.train import checkpoint

    seen: dict[int, tuple[int, int]] = {}
    for leaf in checkpoint.leaves(tree):
        for p, c in enumerate(getattr(leaf, "chunks", ())):
            st = c.untyped_storage()
            seen.setdefault(st._cdata, (p, -(-st.nbytes() // dryrun.ALLOC_ROUND_BYTES)
                                        * dryrun.ALLOC_ROUND_BYTES))
    out = [0] * mesh.size
    for p, n in seen.values():
        out[p] += n
    return out


def dryrun_mesh_card(arch: str, cell: str, info: dict, train_layers: int, seed: int, *,
                     cards: bool = False) -> dict:
    """One ``dryrun_mesh_traces`` cell run for real on the 2 × 2 mesh: 4
    positions of card 0, or (``cards``) one card a position. Seeded
    weights placed by the plan's ``in_shardings`` (the cache made on its
    positions), the batch (the tokens) from the host, the step run once
    with every move between positions a copy (``peer.distinct_positions``)
    under ``FlopCounterMode``. Held to the trace: FLOPs and the exchanges
    by kind equal; on one card, ``max_memory_allocated`` over the call less
    what the process held besides the arguments within
    ``DRYRUN_PEAK_RTOL`` of the traced peak for the whole device; on the
    cards, each card's within ``DRYRUN_PEAK_RTOL`` of its position's, and
    the bytes each position received equal. Loss (logits) finite. A
    ``_seq`` cell runs under the plan's rules (the sequence split over
    ``model``), as it was traced."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distribution import peer
    from repro_torch.distribution import sharding as sh
    from repro_torch.distribution import tensor_parallel as tp
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import train_optimizer
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import TrainState

    mesh = (make_local_mesh(2, model=2, devices=[f"cuda:{i}" for i in range(4)]) if cards
            else make_local_mesh(2, model=2, device="cuda"))
    shape, seq = mesh_cell(cell)
    plan = mesh_plan(arch, shape, mesh, info["batch"], train_layers, seq)
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    model, cfg = plan.model, plan.model.cfg
    if shape == "train_4k":
        params = model.init(gen, device=mesh.device)
        state = TrainState(params, train_optimizer().init(checkpoint.leaves(params)))
        placed = dryrun.place_args(plan, mesh, (state, None))[:1]
        del params, state
        batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=host, dtype=v.dtype)
                 for k, v in plan.args[1].items()}
        args = (placed[0], batch if cards else {k: v.to(mesh.device) for k, v in batch.items()})
    else:
        params = model.init(gen, device=mesh.device)
        pp = sh.place(params, sh.shardings_for(None, mesh, plan.in_shardings[0]))
        del params
        tokens = torch.randint(0, cfg.vocab_size, plan.args[1].shape, generator=host,
                               dtype=plan.args[1].dtype)
        args = (pp, tokens if cards else tokens.to(mesh.device),
                fresh_placed_cache(plan, mesh), plan.args[3].clone())
    torch.cuda.empty_cache()
    devices = mesh.cards
    for d in devices:  # cuBLAS's workspaces first, so that no measured peak holds them
        w = torch.ones((64, 64), device=d)
        _ = (w @ w, w.bfloat16() @ w.bfloat16())
    sync_all()
    own = position_bytes(args, mesh)
    if cards:
        held = [torch.cuda.memory_allocated(d) - own[p] for p, d in enumerate(mesh.devices)]
    else:
        held = [torch.cuda.memory_allocated(mesh.device) - dryrun.live_bytes(args, "cuda")]
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    tp.reset_exchange_counts()
    peer.reset_link_counts()
    with sh.activate(mesh, plan.rules), peer.distinct_positions(), \
            FlopCounterMode(display=False) as counter:
        ms, out = synced_ms(lambda: plan.fn(*args))
    sync_all()
    peaks = [torch.cuda.max_memory_allocated(d) - h for d, h in zip(devices, held)]
    links = sorted((k, s, d, v["calls"], v["bytes"])
                   for (k, s, d), v in peer.link_counts().items())
    received = [sum(v[4] for v in links if v[2] == p) for p in range(mesh.size)]
    want_received = [sum(v[4] for v in info["links"] if v[2] == p) for p in range(mesh.size)]
    res = {"cards": len(devices), "global_batch": info["batch"], "layers": info["layers"],
           "flops": counter.get_total_flops(), "dryrun_flops": info["flops"],
           "exchanges": tp.exchange_counts(), "received_bytes": received, "ms": ms}
    check(res["flops"] == info["flops"], ("mesh FLOPs on the card vs the trace", shape, res))
    check(res["exchanges"] == info["exchanges"], ("mesh exchanges vs the trace", shape, res,
                                                  info["exchanges"]))
    check(received == want_received, ("bytes received by position vs the trace", shape,
                                      received, want_received))
    if cards:
        want = info["positions"]["peak_bytes"]
        res.update(peak_bytes=peaks, dryrun_peak_bytes=want,
                   peak_rel_err=[got / w - 1 for got, w in zip(peaks, want)])
    else:
        res.update(peak_bytes=peaks[0], dryrun_peak_bytes=info["peak_bytes"],
                   peak_rel_err=[peaks[0] / info["peak_bytes"] - 1])
    check(all(abs(e) <= DRYRUN_PEAK_RTOL for e in res["peak_rel_err"]),
          ("mesh peak on the card vs the trace", shape, res))
    if shape == "train_4k":
        res.update(loss=float(out[1]["loss"]), grad_norm=float(out[1]["grad_norm"]))
        check(np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"]), (shape, res))
    else:
        check(bool(torch.isfinite(out[0].float()).all()), (shape, "non-finite mesh logits"))
    del out, args
    torch.cuda.empty_cache()
    return res




def dryrun_mesh_cells(info: dict, train_layers: int, seed: int, *, arch: str,
                      cards: bool = False) -> dict:
    """``dryrun_mesh_card`` of each ``dryrun_mesh_traces`` cell, each
    printed on a line of its own beside the trace's per-position peaks,
    collectives, collective time and dominant term."""
    out = {}
    for shape, cell in info.items():
        res = dryrun_mesh_card(arch, shape, cell, train_layers, seed, cards=cards)
        out[shape] = {"mesh": "2x2", "seq_axis": cell["seq_axis"],
                      "positions_peak_bytes": cell["positions"]["peak_bytes"],
                      "collectives": cell["collectives"],
                      "t_collective_s": cell["t_collective_s"], "dominant": cell["dominant"],
                      "bound_s": cell["bound_s"], "trace_s": cell["trace_s"],
                      "probes": cell["probes"],
                      "next_batch_peak_bytes": cell["next_batch_peak_bytes"], **res}
        emit({"dryrun_mesh": shape, **out[shape]})
    return out


def dryrun_card(arch: str, long_arch: str, decode_rows: int, seed: int, mesh: dict) -> dict:
    """The ``dryrun`` phase, in a process of its own on the card (see
    ``phase_dryrun``); ``mesh``: ``DRYRUN_MESH``."""
    import concurrent.futures
    import multiprocessing

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # cuBLAS's workspaces first, so that no measured peak holds them
    w = torch.ones((64, 64), device=dev)
    _ = (w @ w, w.bfloat16() @ w.bfloat16())
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    limit = free - DRYRUN_MARGIN_BYTES
    out = {"free_bytes": free, "total_bytes": total, "limit_bytes": limit,
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    grid = mesh
    mesh = make_production_mesh(device="meta")
    ops.reset_launch_counts()
    # the records, the prefill's batch-1 trace, the mesh cells' traces and the
    # pod records (but the MoE decodes', POD_MOE) run in three worker
    # processes beside the card's runs
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn")) as meta:
        records = meta.submit(dryrun_records)
        probe = meta.submit(dryrun_meta_record, arch, "prefill_32k", 1, None)
        mesh_traces = meta.submit(dryrun_mesh_traces, grid["arch"], grid["data"],
                                  grid["model"], grid["train_layers"], limit)
        pods = meta.submit(dryrun_records, "single", None, POD_MOE)
        out["train_4k"] = dryrun_train(arch, limit, seed)
        emit({"dryrun_cell": "train_4k", **out["train_4k"]})
        torch.cuda.empty_cache()
        recs, out["records_seconds"] = records.result()
        out["records"] = len(recs)
        out["long_500k"] = dryrun_long(long_arch, recs[long_arch, "long_500k", "card"], seed)
        emit({"dryrun_cell": "long_500k", **out["long_500k"]})
        torch.cuda.empty_cache()

        # prefill_32k: the cut from the batch-1 trace, the estimate traced at
        # the cut beside the card's run of it
        full = specs.make_plan(arch, "prefill_32k", mesh)
        fixed = fixed_bytes(full)
        b1 = probe.result()
        batch = min(largest_batch(b1, fixed, limit), full.cell.global_batch)
        estimate = meta.submit(dryrun_meta_record, arch, "prefill_32k", batch, None)
        plan = specs.make_plan(arch, "prefill_32k", mesh, global_batch=batch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        args = dryrun.materialize(plan, device=dev, generator=gen)
        res, (logits, _) = card_measure(plan, args, donated=True)
        rec = estimate.result()
        hold_to_dryrun(res, rec)
        check(rec["memory"]["peak_per_device_bytes"] <= limit, ("prefill cut does not fit", rec))
        check(next_batch_peak(rec, fixed) > limit, ("a larger prefill batch fits", rec))
        # the counted call's time: the card, not the counter's host work, is
        # the slower side at these shapes (a tile op moves ~2 GB)
        res.update(ms=res["counted_ms"], fixed_bytes=fixed,
                   batch_one_peak_bytes=b1["memory"]["peak_per_device_bytes"],
                   next_batch_peak_bytes=next_batch_peak(rec, fixed))
        out["prefill_32k"] = res
        emit({"dryrun_cell": "prefill_32k", **res})
        params, tokens = args[0], args[1][:decode_rows].clone()
        want = logits[:decode_rows, -1].clone()
        del args, logits
        torch.cuda.empty_cache()

        # decode_32k: the cut from the full batch's trace, a cache filled by a
        # real prefill of S - 1 positions of ``decode_rows`` prompts, tiled
        full = specs.make_plan(arch, "decode_32k", mesh)
        fixed = fixed_bytes(full)
        batch = min(largest_batch(recs[arch, "decode_32k", "card"], fixed, limit),
                    full.cell.global_batch)
        rec = dryrun_meta_record(arch, "decode_32k", batch, None)
        check(rec["memory"]["peak_per_device_bytes"] <= limit, ("decode cut does not fit", rec))
        check(next_batch_peak(rec, fixed) > limit, ("a larger decode batch fits", rec))
        plan = specs.make_plan(arch, "decode_32k", mesh, global_batch=batch)
        model, s = plan.model, plan.cell.seq_len
        ms_prefill, (_, rows) = synced_ms(lambda: model.prefill(
            params, tokens[:, :s - 1], model.init_cache(decode_rows, s, device=dev),
            donate_cache=True))
        cache = model.init_cache(batch, s, device=dev)
        tile_rows(cache, rows, batch)
        del rows
        tile = torch.arange(batch, device=dev) % decode_rows
        pos = torch.tensor(s - 1, dtype=torch.int32)
        token = tokens[:, s - 1][tile]
        res, (got, cache) = card_run(plan, (params, token, cache, pos), rec, donated=True)
        res.update(prefill_rows=decode_rows, prefill_rows_ms=ms_prefill,
                   next_batch_peak_bytes=next_batch_peak(rec, fixed),
                   ms=statistics.median(synced_ms(lambda: plan.fn(params, token, cache, pos))[0]
                                        for _ in range(3)))
        del cache
        torch.cuda.empty_cache()
        res.update(decode_vs_prefill(model, params, tokens, got, want, tile, pos))
        out["decode_32k"] = res
        emit({"dryrun_cell": "decode_32k", **res})
        del params, tokens, got, want
        torch.cuda.empty_cache()

        # the mesh cells: traced through the mesh path, run on 4 positions of the card
        out["mesh"] = dryrun_mesh_cells(mesh_traces.result(), grid["train_layers"],
                                        grid["seed"], arch=grid["arch"])
        pod_recs, out["pod_records_seconds"] = pods.result()
        out["pod_records"] = len(pod_recs)
    out["launches"] = ops.launch_counts()
    check(not any(out["launches"].values()), ("the dry run's cells launch no kernel", out))
    return out


def phase_dryrun(arch: str, long_arch: str, decode_rows: int, seed: int, mesh: dict) -> dict:
    """The dry run held to the card (``dryrun_card``), in a process of its
    own: its cells fill the card, so it starts from no allocation of the
    earlier phases, and with ``expandable_segments`` so that a cell sized
    to the free memory is not refused for the allocator's fragments."""
    import concurrent.futures
    import gc
    import multiprocessing

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:  # the worker starts, and takes the environment, at submit
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=1, mp_context=multiprocessing.get_context("spawn")) as pool:
            return pool.submit(dryrun_card, arch, long_arch, decode_rows, seed, mesh).result()
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import concurrent.futures
    import multiprocessing

    from repro_torch.data import radixnet as rx
    from repro_torch.data.radixnet import RadixNetSpec

    moe_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    moe_pods = moe_pool.submit(dryrun_records, "single", POD_MOE)
    dev = phase_device()
    kern = phase_kernels()

    # the dry run holds the card for minutes and leaves the host's cores
    # idle: the numpy oracles of the sharded, fleet and continuous phases
    # run beside it, and the script waits for them before the phases that
    # read the host's clock
    spec = RadixNetSpec(1024, 120)
    n = CONTINUOUS["n_requests"]
    cont_panel = np.ascontiguousarray(rx.radixnet_input_panel(spec.neurons, n, density=0.3,
                                                              seed=CONTINUOUS["seed"]))
    big = RadixNetSpec(SHARDED["neurons"], SHARDED["layers"])
    sharded_panel = np.ascontiguousarray(rx.radixnet_input_panel(
        big.neurons, SHARDED["n_inputs"], density=SHARDED["density"],
        seed=0)[:, :SHARDED["ref_cols"]])
    fleet_panel = np.concatenate([j.features.numpy() for j in fleet_jobs(**FLEET, device="cpu")],
                                 axis=1)
    workers = max(1, (os.cpu_count() or 1) - 4)  # the dry run's process and its tracers
    torch.cuda.empty_cache()  # the dry run sizes its cells by the card's free memory
    t0 = time.perf_counter()
    oracles = oracles_ahead({"sharded": (big, sharded_panel, 8), "fleet": (spec, fleet_panel, 512),
                             "continuous": (spec, cont_panel, 512)}, workers)
    dry = phase_dryrun(**DRYRUN, mesh=DRYRUN_MESH)
    t1 = time.perf_counter()
    ready = {name: wait() for name, wait in oracles.items()}
    beside = {"workers": workers, "started_to_ready_seconds": time.perf_counter() - t0,
              "wait_after_dryrun_seconds": time.perf_counter() - t1,
              "columns": {"sharded": sharded_panel.shape[1], "fleet": fleet_panel.shape[1],
                          "continuous": cont_panel.shape[1]}}
    emit({"phase": "dryrun", "card": dev["nvidia_smi"], **dry, "oracles_beside": beside})
    t2 = time.perf_counter()
    moe_recs, moe_s = moe_pods.result()
    moe_pool.shutdown()
    emit({"phase": "dryrun-pod-moe", "cells": [list(c) for c in POD_MOE],
          "records": len(moe_recs), "seconds": moe_s,
          "beside": ["device", "kernels", "dryrun"],
          "wait_after_dryrun_seconds": time.perf_counter() - t2})

    serve, _, serve_res = phase_serve(spec, n_inputs=60000, use_resident=None, density=0.3,
                                      ref_cols=512, route="fused", level="resident",
                                      kernels=("fused_mlp_forward",))
    # the warm-up panel builds and captures the one plan, every timed step
    # replays it: launches = warm-up + replays = steps + 1, and nothing else
    (plan,) = serve["plans"]
    check(plan["warmups"] == 1 and plan["replays"] == serve["steps"]
          and serve["launches"]["fused_mlp_forward"] == serve["steps"] + 1, serve)
    emit({"phase": "serve", **serve})

    layered, layered_engine, _ = phase_serve(spec, n_inputs=2048, use_resident=False,
                                             density=0.3, ref_cols=512, route="layered",
                                             level="layered", kernels=("bsr_spmm", "bcsr_spmm"))
    (layered_plan,) = layered_engine.plan_cache.plans()
    panel, ref_cats = radix_inputs(spec, 2048, 0.3)
    layered["host_share"] = host_share(layered_plan, torch.from_numpy(
        np.ascontiguousarray(panel[:, :layered_plan.width])).to("cuda"))
    emit({"phase": "layered", **layered})

    tiled, _, _ = phase_serve(RadixNetSpec(16384, 120), n_inputs=1024, use_resident=None,
                              density=0.4, ref_cols=64, route="fused-tiled", level="resident",
                              kernels=("fused_mlp_tiled_forward",))
    emit({"phase": "tiled", **tiled})

    dense = phase_dense(spec, panel, ref_cats)
    emit({"phase": "dense", **dense})
    graph = phase_graphblas(spec, panel, ref_cats, layered_plan)
    emit({"phase": "graphblas", **graph})
    train_radix = phase_train_radixnet(**RADIX_TRAIN)
    emit({"phase": "train-radixnet", **train_radix})
    train_paper = phase_train_paper(**PAPER_TRAIN)
    emit({"phase": "train-paper", **train_paper})

    cont_cats = ready["continuous"][1]
    cont = phase_continuous(spec, cont_panel, cont_cats, **CONTINUOUS)
    emit({"phase": "continuous", **cont})
    faulted = phase_continuous_faults(spec, cont_panel, cont_cats, **CONTINUOUS)
    emit({"phase": "continuous-faults", **faulted})
    bf16 = phase_serve_bf16(spec, serve_res)
    emit({"phase": "serve-bf16", **bf16})
    tune, table = phase_tune(TUNE_SKEWED, TUNE_RADIX)
    emit({"phase": "tune", **tune})
    served = phase_serve_tuned(TUNE_RADIX["sizes"], TUNE_RADIX["layers"], table,
                               n_inputs=60000, ref_cols=512)
    emit({"phase": "serve-tuned", **served})
    resilient = phase_train_resilient(**RESILIENT)
    emit({"phase": "train-resilient", **resilient})
    one_card, sharded = phase_sharded(**SHARDED,
                                      ahead=(sharded_panel, ready["sharded"]))
    emit({"phase": "sharded", **sharded})
    sharded_train = phase_sharded_train(**SHARDED_TRAIN)
    emit({"phase": "sharded-train", **sharded_train})
    cards = phase_sharded_cards(one_card=one_card, **SHARDED)
    del one_card
    emit({"phase": "sharded-cards", **cards})
    cards_train = phase_sharded_train(**SHARDED_TRAIN, cards=True)
    emit({"phase": "sharded-cards-train", **cards_train})
    fleet = phase_fleet(**FLEET, ahead=(fleet_panel, ready["fleet"]))
    emit({"phase": "fleet", **fleet})
    llm, llm_params = phase_llm_serve(**LLM_SERVE)
    emit({"phase": "llm-serve", **llm})
    mlp = phase_model_mlp(**MODEL_MLP)
    emit({"phase": "model-mlp", **mlp})
    llm_sparse = phase_llm_sparse(params=llm_params, **LLM_SPARSE)
    del llm_params
    emit({"phase": "llm-sparse", **llm_sparse})
    model_train = phase_model_train(**MODEL_TRAIN)
    emit({"phase": "model-train", **model_train})
    llm_train = phase_llm_train(**LLM_TRAIN)
    emit({"phase": "llm-train", **llm_train})
    launch = phase_launch_train(**LAUNCH_TRAIN)
    emit({"phase": "launch-train", **launch})
    llm_data = phase_llm_train_data(**LLM_TRAIN_DATA)
    emit({"phase": "llm-train-data", **llm_data})
    launch_data = phase_launch_train_data(**LAUNCH_TRAIN_DATA)
    emit({"phase": "launch-train-data", **launch_data})
    llm_model = phase_llm_train_model(**LLM_TRAIN_MODEL)
    emit({"phase": "llm-train-model", **llm_model})
    serve_model = phase_llm_serve_model(**LLM_SERVE_MODEL)
    emit({"phase": "llm-serve-model", **serve_model})

    by_phase = {"serve": serve["launches"], "layered": layered["launches"],
                "tiled": tiled["launches"], "dense": dense["launches"],
                "graphblas": graph["launches"],
                "three_call": graph["three_call"]["launches"],
                "train-radixnet": train_radix["launches"],
                "train-paper": train_paper["launches"],
                "continuous": cont["launches"], "continuous-faults": faulted["launches"],
                "serve-bf16": bf16["launches"], "tune": tune["launches"],
                "serve-tuned": served["launches"], "train-resilient": resilient["launches"],
                "sharded": sharded["launches"], "sharded-train": sharded_train["launches"],
                "sharded-cards": cards["launches"],
                "sharded-cards-train": cards_train["launches"],
                "fleet": fleet["launches"], "llm-serve": llm["launches"],
                "model-mlp": mlp["launches"], "llm-sparse": llm_sparse["launches"],
                "model-train": model_train["launches"],
                "llm-train": llm_train["sparse"]["launches"],
                "launch-train": launch["launches"],
                "llm-train-data": llm_data["sparse"]["launches"],
                "launch-train-data": launch_data["launches"],
                "llm-train-model": llm_model["launches"], "dryrun": dry["launches"],
                "llm-serve-model": serve_model["launches"]}
    checks = {name: "max|kernel - plain| <= 1e-5 |plain| + 1e-6 (f32 order)"
              for name in ("semiring_matmul", "bsr_spmm", "bcsr_spmm")}
    checks.update({name: "stack: <= 1e-4 max|plain|, each entry within 2x the f32 bound, "
                         "exact categories"
                   for name in ("fused_mlp_forward", "fused_mlp_tiled_forward")})
    rows = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(c[name] for c in by_phase.values()),
            "launches_by_phase": {p: c[name] for p, c in by_phase.items() if c[name]},
            "max_abs_err": kern[name]["max_abs_err"],
            "max_col_rel_err": kern[name]["max_col_rel_err"], "check": checks[name],
            "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
            "bound_ms": kern[name]["bound_ms"], "bound_by": kern[name]["bound_by"],
            "library_ms": kern[name]["library_ms"],
        }
        if name in kern["semirings"]:
            row["semirings"] = kern["semirings"][name]
        rows.append(row)
    emit({"kernels": rows})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
