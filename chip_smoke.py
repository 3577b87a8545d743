#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--profile]
    python3 chip_smoke.py --only shard     # the build and [shard] alone
    python3 chip_smoke.py --only mesh      # the build and [mesh] alone
    python3 chip_smoke.py --only mesh-train  # [mesh]'s training parts

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. print the card's ``nvidia-smi`` name and power limit; TF32 off;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each HFL kernel against its plain PyTorch version on the card, at
   the main path's shapes (``CONFIG``) and at the reference bench scale
   (4096 clients × 32 edges), with the tolerances the tests use, and time
   both: the fused dense score (``score_matrix``: the Eq. 21
   normalisation inside the launch) bit for bit, against the unfused
   chain it replaced (the torch normalisation around the rows kernel) in
   turns old, new, new, old, each with its wrapper and device time, and
   on edge gains; the rows kernel; the SIC kernel (a thread-block cluster
   per edge over the edge's own clients) at ``CONFIG``'s quota mask, a
   4096 × 32 one-hot mask and a 4097 × 32 50% mask with exact ties, there
   at every cluster size, each beside its bound counted from the mask;
   the SGD kernel (a thread-block cluster per lane) also at its edge
   shapes (every cluster size, ragged tiles, the block-per-lane route),
   with its cluster size, shared memory and the clusters the card holds
   at once, and its time from a CUDA-graph replay (its wrapper's host
   time exceeds the kernel's);
4. run the HFL main path -- ``HFLSimulation(CONFIG, device="cuda")``: 5
   rounds of fcea + PDD, then 2 rounds of gcea + fastest -- with every
   launch counter zeroed just before and read just after; check the
   counts, the metrics and the per-stage times;
5. run one round on the card and the same state and draws through the
   plain versions on the CPU, and compare;
6. with ``--profile``, profile one more steady fcea round (kernel count
   and the device's busy share);
6b. the candidate path -- ``EngineSpec(candidates_k=k)`` through
   ``engine.round_step``, each run with the launch counters zeroed just
   before and read just after: at ``CONFIG``, K = M = 4 against the dense
   round (same decisions), K = 2 on the card against the CPU, then gcea +
   fastest and rcea + rra + fastest; at the reference bench scale (4096
   clients × 32 edges), dense, K = 8 and K = 4 timed by stage and one K = 4
   round card against CPU; the fused score on the frontier (4096 × 32 at
   K = 8 and 4, 4095 clients at K = 3) bit for bit against its plain
   version, old against new in turns;
6c. the fleet -- ``engine.run_fleet`` over seeds stacked by
   ``stack_fleet``, one batched round for all seeds, with the launch
   counters zeroed just before and read just after (one fused-score call,
   one SIC call and τ₂ SGD launches a round, whatever the number of
   seeds): ``CONFIG`` fcea + PDD, 3 rounds at S = 1, 4 and 8 (seeds
   0-7) in turns S = 1, 4, 8, 8, 4, 1, each timed by round and stage with
   its seed-rounds per second (each seed's world built once for the
   phase and copied into every fleet and own run);
   with ``--profile``, one steady S = 8 round profiled; every seed against
   its own ``run_scanned`` (decisions exact, bill rtol 1e-5, loss rtol
   1e-4); the fused score and the SIC at S = 8 against S = 1 in turns,
   each seed of the fleet's call bit-equal to its own call, and the SGD
   kernel at the fleet's 128 lanes against its plain version; one S = 2
   round card against CPU; the bench scale (4096 × 32, K = 8) at S = 4, 3
   rounds, seed 0 against its own run;
6d. dynamic scenarios and the fpa/fca allocators (``[scenario]``), each
   run with the launch counters zeroed just before and read just after:
   ``HFLSimulation(CONFIG, scenario="full_dynamic")``, 5 rounds of fcea +
   PDD beside the static ``[main]`` round, and one round card vs CPU
   (availability, n_available and the decisions exact, the moved
   positions and distances to rtol 1e-6 above 1e-6 of the area's side);
   the reference's static against
   ``full_dynamic`` overhead at 256 × 8 (gcea + fastest, 15 rounds a run,
   in turns static, dynamic, dynamic, static twice over:
   ``dynamic_overhead_pct`` from the medians); its
   sweep fleet of mixed worlds (random_waypoint, markov_dropout,
   hetero_devices × seeds 0-3, S = 12, one kind "dynamic") at 256 × 8, one
   member of each world against its own run; the sync half of its
   sync/buffered A/B at 1024 × 16 under flash_crowd and markov_dropout
   (simulated rounds a second); the frontier under mobility (1024 × 16,
   K = 4, some client's frontier changing every round, card vs CPU); fpa
   and fca at ``CONFIG`` on hetero_devices (two SIC calls a round, the
   grid's (16, N, M) call against its plain version, the action each
   timed round's grid chose exact card vs CPU on that round's own inputs,
   also with time weighted 100:1, and some pick inside the grid); and a
   round with every client dropped (the global
   model bit-equal, the bill finite);
6e. the DDPG allocator (``[ddpg]``), each run with the launch counters
   zeroed just before and read just after: ``HFLSimulation(CONFIG,
   allocator="ddpg").train_ddpg()`` at the paper's defaults (20 × 50
   slots, hidden 128, buffer 4096, batch 64, warmup 64; one SIC call a
   slot, one fused-score call for the fcea association snapshot, no SGD
   launch), then 3 deployed fcea + PDD rounds (a ``mid`` round's
   launches) beside the ``[main]`` round and one deployed round card vs
   CPU; the reference's ``bench_ddpg`` scale (64 × 4 full_dynamic, gcea,
   the 192-wide observation, hidden 64, buffer 1024, 10 × 40 slots),
   twice; training card vs CPU from the same weights and draws (``CONFIG``
   static, gcea, 2 × 40 slots, warmup 16, hidden 64) at
   ``DDPG_TRAIN_TOL``, each side's gap to a float64 CPU run printed; the
   S = 4 fleet (seeds 0-3, ``CONFIG`` full_dynamic, 10 × 40 slots, one
   SIC call a slot), member 0 against its own run, then
   ``run_fleet_actors`` 3 rounds, each member against its own
   ``run_scanned`` with its own actor; and the paper's comparison
   (``benchmarks/fig_ddpg_cost.py``): the trained actor's mean Eq. 23a
   cost beside rra's, fpa's and fca's on the same slots, printed; with
   ``--profile``, the device's busy share over 20 updating slots;
6f. the in-round telemetry (``[telemetry]``), each run with the launch
   counters zeroed just before and read just after: ``CONFIG`` fcea +
   PDD, 5 rounds without and with ``EngineSpec(telemetry=True)`` from one
   state and seed (the same launches, metrics and final state bit-equal,
   the trace's invariants); ``telemetry_overhead_pct`` and the JSONL
   tee's overhead at 1024 x 16 gcea + fastest, in turns off, on, tee,
   tee, on, off, and the tee's file read back equal to the returned
   trace; ``spans.profile_scanned``'s Chrome trace with the five
   ``hfl/<stage>`` ranges and the CUDA kernels launched under them;
6g. the buffered engine (``[buffered]``), each run with the launch
   counters zeroed just before and read just after: ``CONFIG`` fcea dense,
   64 micro-steps (a sync round's launches a micro-step), micro-steps a
   second beside the ``[main]`` rounds a second, merges and virtual
   seconds, and one more micro-step whose kernel calls are recorded (as
   many calls of each wrapper as its kernel's launches in that step, and
   no other launch) and held against their plain versions on its own
   inputs; the same for
   ``CONFIG`` K = 2 (the frontier's score), 8 micro-steps, and for
   ``CONFIG`` at a buffer fill of 3 and a server step of 0.5, 64
   micro-steps (a micro-step's launches unchanged, the merges beside the
   default's); card vs CPU over 8 (and 4) micro-steps from one state and
   the same draws (the
   buffer's integers and every decision exact, the clock and finish times
   rtol 1e-5; a disagreement prints each client's values and their gap
   in ulps); the reference's sync/buffered A/B
   (``bench_rounds.async_ab``) at 1024 x 16 under flash_crowd and
   markov_dropout: 8 sync rounds against 64 micro-steps, merges, virtual
   seconds, virtual and wall rates;
6h. the fault layer and the resumable driver (``[faults]``), each run
   with the launch counters zeroed just before and read just after and
   every kernel call it makes on the card recorded and held against its
   plain version (a faulted round launches as an unfaulted one), under
   "chaos" (the reference's chaos sweep cell -- edge churn, SINR-tied
   uplink loss -- plus crashes and NaN poisoning): ``CONFIG`` fcea + PDD
   dense, 5 rounds card vs CPU from one state and the same draws (z,
   n_associated, sweeps, staleness and every ``FaultState`` leaf exact;
   the bill rtol 1e-5, the loss rtol 1e-4); ``CONFIG`` K = 2 with edge 0
   dead and the churn frozen, 3 rounds (no client admitted there, one
   dead edge in every trace); ``CONFIG`` fcea dense buffered, 16
   micro-steps card vs CPU (the buffer's and the fault state's integers
   exact, the clock and finish times rtol 1e-5); the fault layer's cost,
   chaos against off in turns off, on, on, off (1024 x 16 gcea + fastest,
   10 rounds a run, each mode's kernels in a profiled round; ``CONFIG``
   fcea + PDD, 4 rounds); ``faults.run_scanned_resumable`` (``CONFIG``
   buffered chaos with telemetry, 6 micro-steps in segments of 2, a CUDA
   generator) stopped after one segment and resumed: metrics, trace,
   final carry and generator state bit-identical to an uninterrupted
   ``run_scanned``;
6i. the warm-started association (``[warm]``), under random_waypoint,
   each warm run with the launch counters zeroed just before and read
   just after and every kernel call it makes recorded and held against
   its plain version: ``CONFIG`` fcea + PDD dense 5 rounds, the same at
   K = 2 and buffered fcea dense 16 micro-steps, each warm against cold
   from one generator state (metrics, trace, params, staleness and the
   carry bit-equal but for the sweeps and the seed; each round's sweeps
   printed); the warm dense run card vs CPU over 3 rounds (integers and
   the warm leaf exact); a warm ``run_scanned_resumable`` stopped after
   one segment of 2 and resumed bit-identical, seed and generator state
   included; the reference's ``warm_sweeps`` case (1024 x 16 gcea +
   fastest, 16 rounds): median and mean sweeps cold and warm and the
   associate stage's ms a round in turns cold, warm, warm, cold;
6j. the sweep runner (``[sweep]``), with the launch counters zeroed just
   before its four grids and read just after and every kernel call held
   against its plain version: the reference's ``--quick`` demo grid at
   its own config (32 x 4: 12 cells in 6 groups), its quick chaos grid
   (buffered, telemetry, faults), one ddpg group (fcea K = 2, 2 x 10
   slots, an actor trained a cell) and a quick buffered grid with
   ``buffer_fill``, ``timeout_s``, ``n_tiers`` and ``retier_every`` off
   their defaults, written to a temporary directory;
   each group's wall time; every cell against its own ``run_scanned`` on
   the card (decisions exact, every float bit-equal); the witness of why
   a fleet computes a seed at a time (seed 0 of a fleet vs its own run on
   the same inputs, per-seed vs batched: the DDPG networks' products, the
   eval logits, the SGD's cluster size); a group's wall time against a
   plain ``run_fleet`` of the same fleet, and that fleet's SGD launched
   at the fleet-wide cluster size instead of one seed's, in turns;
6k. the HFL engine across processes (``[shard]``): ``CONFIG`` fcea + PDD
   at S = 8 on the seed axis (``run_fleet_sharded``) and 512 clients ×
   16 edges at ``CONFIG``'s widths (x 1.9 GB) on the client axis
   (``run_scanned_client_sharded``), dense fcea + PDD and K = 4, 3 rounds
   each, and on the same world the buffered engine (fcea dense, 8
   micro-steps), fcea + PDD under chaos (3 rounds) and K = 4 buffered
   under chaos (8 micro-steps), the worlds built once here and read by
   the ranks through CUDA
   IPC: each job unsharded here first, then over W = min(cards, 4) NCCL
   ranks (``core.mesh.spawn`` of this script's ``shard_rank``), or on
   one card over NCCL alone (W = 1) and then over two gloo ranks on
   that card (after a probe of which
   collectives gloo takes on CUDA tensors); every leaf of every rank's
   metrics, final state and generators bit-equal to the unsharded run's
   (SHA-256 of the bytes), each rank's launches (a fleet rank a whole
   fleet's; a client rank the unsharded score and SIC calls and its
   share of the SGD), seed-rounds/s, s a round and micro-steps/s at W
   and unsharded, each rank's rows of the client models and of the
   buffer's pending deltas (N / W, or the phase fails), its peak device
   memory and resident host memory; the shared
   worlds released after (the device memory held no more than before);
7. hold the sequence kernels (flash attention: the tensor-core kernel for
   bf16 at d_head 64/128/256, the CUDA-core kernel otherwise; linear
   recurrence) against their plain versions at recurrentgemma-9b's
   prefill shapes, at the tensor-core kernel's edge shapes (ragged S,
   S below one q-tile, small and ragged windows, GQA groups 1/2/7/8/16,
   d_head 64/128, non-causal, B = 2) and at fp32 shapes, checking which
   kernel each call launched, and the recurrence bit for bit at its main
   shape in fp32 and bf16 and at its edge shapes (ragged S and C, B·C
   below one block, S = 1, odd C in bf16); time the main shapes beside
   their bound and, for attention, PyTorch's
   ``scaled_dot_product_attention``;
8. serve recurrentgemma-9b at full width and depth (random weights from
   a seeded generator): one prefill of 2 × 4096 tokens with the launch
   counters zeroed just before and read just after (12 flash launches,
   all of them to the tensor-core kernel; 26 recurrence launches), timed
   prefills, a token-by-token decode of 2 64-token prompts and 16 greedy
   tokens, and the prefill's last logits against the decode's;
9. the reduced recurrentgemma config (d_head 64, window 32) on the card
   (kernels) against the CPU (plain versions) from the same weights, and
   its prefill's logits at every position of a 300-token prompt (several
   flash tiles, the window skip) against a token-by-token decode on the
   card: in float32 (the CUDA-core flash kernel) and in bfloat16 (the
   tensor-core one);
9b. the dense decoders (``[dense]``), one model at a time, each freed
   before the next, weights drawn from a seeded generator (fp32, bf16
   compute; the norm scales and the norm and QKV biases redrawn away from
   ones and zeros): qwen3-8b and stablelm-1.6b at full width and depth,
   yi-34b (12 of 60 layers), qwen1.5-110b (4 of 80) and qwen3-8b-sw4k (4
   layers, one 8192-token sequence) at full width -- a prefill of 2 x
   4096 tokens with the launch counters zeroed just before and read just
   after (one tensor-core flash launch a layer and nothing else), timed
   prefills, a token-by-token decode of a 64-token prompt and 16 greedy
   tokens (no kernel launch), the prefill's last logits against the
   decode's, the peak memory beside the card's name and power limit; each
   config reduced, MHA and with 2 KV heads, card vs CPU in float32 and
   prefill vs decode in bfloat16; reduced qwen3-8b decoding 12 steps
   with a float8 (e4m3fn) KV cache, card vs CPU (``FP8_CACHE_REL``) and
   beside its float32 cache; the flash kernel at each run's prefill
   shape (GQA groups 4, 7 and 8 at D = 128, MHA at D = 64, a 4096
   window) timed beside its bound and SDPA;
9c. the prefix-LM and MoE decoders (``[vlm-moe]``), one model at a time,
   weights drawn from a seeded generator on the card (norm scales
   redrawn): paligemma-3b at full size (fp32 weights, 256 patch
   embeddings in front of 4096 text tokens, the flash kernel's prefix
   mask), grok-1-314b (4 of 64 layers, bf16 weights, 8 experts top-2) and
   llama4-maverick (one pattern unit of 4 layers, bf16 weights, 128
   experts top-1, 3 chunked layers and a NoPE global one, 1 x 16384
   tokens: two chunks) at full width -- a prefill with the launch counters
   zeroed just before and read just after (one tensor-core flash launch a
   layer and nothing else), the (token, choice) pairs each MoE layer
   dropped at the published capacity factor, timed prefills, paligemma's
   ``prefill_prefix`` (one flash launch a layer), a token-by-token decode
   of a 64-token prompt and 16 greedy tokens (no kernel launch), the
   prefill's last logits against the decode's (the MoE prefill at a
   capacity factor of experts / top-k, where nothing can drop; at the
   model's own routers the share of routing decisions the two paths made
   alike and the rel rms are printed, since bf16 rounding flips near ties
   of the top-k, then the logits are held with the routers zeroed, which
   pins every token to experts 0..k-1 on both paths), the peak
   memory beside the card's name and power limit; each config reduced and
   with 2 KV heads, card vs CPU in float32 (logits, the MoE aux) and
   prefill vs decode in float32 and bfloat16; the flash kernel at the
   four prefill shapes timed beside its bound and SDPA, and at the prefix
   and chunk edges (prefix 1, ragged, = S; chunk 32, 100, 128, = S and
   past S) in bf16 and fp32;
9d. xLSTM and the encoder-decoder (``[xlstm-encdec]``), one model at a
   time, weights drawn from a seeded generator on the card (fp32, bf16
   compute; norm scales, LayerNorm, QKV and MLP biases redrawn):
   xlstm-125m at full size -- a 2 x 1024 prefill with the launch counters
   zeroed just before and read just after (no launch: its mLSTM and sLSTM
   scans are plain, as the reference's are XLA), timed prefills, a
   token-by-token decode of a 64-token prompt and 16 greedy tokens, the
   prefill's last logits against the decode's, the peak memory;
   whisper-large-v3 at full size (32 + 32 layers, 2 requests x 1500 stub
   frames) -- ``prefill_cross`` (32 tensor-core flash launches, the
   encoder) and a teacher-forced ``apply`` over 448 tokens (96: the
   encoder's, the causal self-attention's and the cross-attention's, 448
   queries over 1500 frames; nothing else), each with the counters zeroed
   just before and read just after, timed prefill steps, a decode of a
   64-token prompt from index 0 and 16 greedy tokens (no launch), the
   apply's logits at the prompt's last position against the decode's, the
   peak memory; each reduced config (whisper also with 2 KV heads) card vs
   CPU in fp32 and prefill vs decode in fp32 and bf16; both flash kernels
   with a key length of their own at their edges (one query, 448 over
   1500, fewer keys than queries, ragged both ways with MQA, fewer keys
   than a tile) in bf16 and fp32, a causal call with two lengths refused;
   the flash kernel at whisper's encoder, self-attention and
   cross-attention shapes timed beside its bound and SDPA;
9e. the substrate's training path (``[train]``), one model at a time,
   weights drawn from a seeded generator on the card (constant leaves
   redrawn), ``launch.steps.make_train_step`` (AdamW at lr 1e-5,
   clipping at 1.0):
   stablelm-1.6b at full size (2 x 2048), recurrentgemma-9b at full width
   and one (rec, rec, swa) unit (2 x 2048), xlstm-125m at full size (2 x
   128) and whisper-large-v3 at full size (2 x (1500 frames + 448
   tokens)), each with its config's ``remat`` on (every unit through
   ``torch.utils.checkpoint``, recomputed in the backward) -- a
   ``loss_and_grads`` call (every parameter's gradient present and
   finite) and 4 train steps (xLSTM 2) on one batch, each with the launch
   counters zeroed just before and read just after (exactly two flash
   forwards an attention layer, forward and recompute, all on the
   tensor-core kernel, and three recurrence launches a ``rec`` layer, forward,
   recompute and adjoint: stablelm 48, recurrentgemma's unit 2 + 6,
   xLSTM none, whisper 192), the loss falling, ms a step, steps/s,
   tokens/s, the ``loss_and_grads`` peak and the whole step's (≤ 80 GB)
   beside the card's name and power limit; for stablelm and
   recurrentgemma the same weights with remat off (``loss_and_grads``
   and its peak, the gradients' max abs gap to remat on, steps in turns
   off, off, on; ms and both peaks each way), then stablelm at 2 x 4096
   with remat on (ms, both peaks) and remat off only where an estimate
   made from the 2048 run leaves 10 GB of the card free; flash forward
   and backward ms at each model's attention shapes beside their bounds
   (4·D and 10·D flops an allowed pair and head); each mixer kind
   reduced in float32 with remat on, card vs CPU: the loss, every
   gradient leaf and one step's weights, and on the card its forward
   run twice (bit-equal or not) and its gradients remat on vs off;
   the recurrence's adjoint kernel and flash's Function against
   autograd of their plain versions (the recurrence's edges and
   recurrentgemma's shape, timed; every mask kind and two lengths, bf16
   and fp32);
9f. the substrate across ranks (``[mesh]``) on the reference's
   ``("data", "model")`` mesh, weights drawn from ``MESH_SEED`` by every
   rank (each keeps its blocks): the main flash shape timed; on one card
   a mesh of one over an NCCL group of one (bit-equal to the unsharded
   model), then ``MESH_ONE_CARD`` over gloo ranks on the card (model 2:
   yi-34b 2 layers, grok-1-314b 2, recurrentgemma-9b one unit, xlstm-125m
   3 layers, whisper-large-v3 1 + 1 layers; model 3: yi-34b 2 layers and
   whisper 1 + 1 context-parallel, xlstm-125m with its heads whole and
   ``r_gates`` split on dh, recurrentgemma-9b one unit with ``rec``
   whole); on four cards ``MESH_FOUR_CARDS`` over NCCL (model 4: yi-34b
   at its full 60 layers, grok-1-314b at 16, recurrentgemma-9b at 38,
   whisper-large-v3 at 32 + 32 and xlstm-125m; model 3: yi-34b 12 layers
   and whisper 32 + 32 context-parallel).  Per part: the unsharded model
   first (``_unsharded_logits``: streamed one block at a time from the
   same draws for an attention decoder, built whole for the others),
   then the ranks (``mesh_rank``), in turns: a prefill with the counters
   zeroed just before and read just after (one tensor-core flash an
   attention call and one recurrence a ``rec`` layer a rank, nothing
   else), every rank's last logits bit-equal and within
   ``PREFILL_DECODE_REL_RMS`` of the unsharded prefill's, timed
   prefills, a context-parallel rank's offset flash block held to the
   plain version at ``FLASH_TOL`` and timed alone, a ``rec`` rank's
   recurrence at its channels held bit for bit and timed, a decode (the
   prompt token by token, greedy tokens from ``make_serve_step``; whisper
   after ``prefill_cross``) held against the unsharded model
   teacher-forced on its tokens (rel rms at the prompt's end, the share
   of tokens alike; a MoE at its no-drop factor), each rank's ms,
   tokens/s, peak device and host memory; each layout's reduced fp32
   config against the card's unsharded run at ``SUBSTRATE_TOL``.  Then
   training on the mesh with the training placement (FSDP over
   ``data``), remat on: on one card in the model-2 spawn
   ``MESH_TRAIN_ONE_CARD`` (stablelm-1.6b 2 layers at 1 x 2 and 2 x 1,
   recurrentgemma-9b one unit at 1 x 2, each rank's first Adam moments
   after one step held to its blocks of its own unsharded step's at
   ``PREFILL_DECODE_REL_RMS``), on
   four cards ``MESH_TRAIN_FOUR_CARDS`` over NCCL (qwen3-8b whole at 2 x 2
   and 4 x 1, grok-1-314b 4 layers at 1 x 4, each loss held to the
   unsharded model streamed one block at a time; qwen3-8b 8 layers at 4 x
   1, every step's loss and the first moments held to the unsharded
   train step on each rank's card; remat on vs off): ``loss_and_grads`` and
   ``MESH_TRAIN_STEPS`` steps on one batch, every rank's losses
   bit-equal, the loss falling, each call's launches exactly
   ``_train_want`` a rank (two tensor-core flash launches an attention
   layer, three recurrence launches a ``rec`` layer), ms a step,
   tokens/s, the peak a rank and the state's bytes a rank; and each
   mixer kind's reduced fp32 config (``MESH_TRAIN_KINDS``) on each layout
   against the rank's own unsharded step at the CPU tests' tolerances;
10. print the per-kernel JSON line (six entries, the kernels the paths
    launch: ``score_matrix`` and ``score_candidates`` are the fused score
    on the two paths; the rows-only ``score_rows``, which only the unfused
    chain launches, has its ``[compare]`` lines alone; ``launches`` counts
    the main path's run, ``scenario_launches`` the ``CONFIG``
    full_dynamic run's, ``ddpg_launches`` the paper-default
    ``train_ddpg()`` run's, ``buffered_launches`` the ``CONFIG`` fcea
    dense buffered run's, ``score_candidates`` its K = 2 run's, and
    ``faults_launches`` the ``CONFIG`` fcea + PDD chaos run's, 5 rounds,
    ``score_candidates`` its K = 2 dead-edge run's, ``warm_launches`` the
    warm ``CONFIG`` fcea + PDD dense run's, ``score_candidates`` its K = 2
    run's, ``sweep_launches`` the ``[sweep]`` phase's four grids,
    ``shard_launches`` the ``[shard]`` phase's widest part, a rank each
    (its six jobs summed), ``mesh_launches`` the ``[mesh]`` part's
    prefill that launched the most of the kernel, a rank each (flash and
    the recurrence), ``mesh_train_launches`` the same of a ``[mesh]``
    training part's train step, and
    ``dense_launches`` the five dense prefills', ``vlm_moe_launches`` the
    three prefix-LM and MoE prefills', ``encdec_launches`` whisper's
    teacher-forced ``apply`` (xLSTM's prefill launches none); the
    ``train_launches`` the four models' remat'd train steps, one each,
    summed;
    the ``flash_attention`` entry's ``dense_shapes``, ``vlm_moe_shapes``
    and ``encdec_shapes`` hold its readings at their shapes,
    ``train_shapes`` its forward and backward at the training shapes, and
    the ``linear_recurrence`` entry's ``train_adjoint`` its backward at
    recurrentgemma's) and, last, the device line.

It needs one CUDA device and imports nothing of the JAX reference.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, bf16
# dense tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {  # the CPU tests' tolerances (tests/test_torch_kernels.py)
    "score_rows": dict(rtol=1e-5, atol=2e-4),
    "sic_rates": dict(rtol=1e-5, atol_frac=1e-6),
    "local_sgd_step": dict(rtol=2e-5, atol=2e-6),
}
SOURCE = {"score_matrix": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "score_candidates": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "sic_rates": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "local_sgd_step": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "flash_attention": "src/repro_torch/kernels/csrc/flash_wgmma.cu",
          "linear_recurrence": "src/repro_torch/kernels/csrc/seq_ops.cu"}
REPLACES = {
    "score_matrix": "src/repro/kernels/hfl_ops.py:133",
    "score_candidates": "src/repro/kernels/hfl_ops.py:156",
    "sic_rates": "src/repro/kernels/hfl_ops.py:185",
    "local_sgd_step": "src/repro/kernels/hfl_ops.py:259",
    "flash_attention": "src/repro/kernels/flash_attention.py:34",
    "linear_recurrence": "src/repro/kernels/linear_recurrence.py:29",
}
# the sequence kernels against their plain versions (tests/test_torch_cuda.py):
# float32 -- the kernel and the plain einsum sum in other orders; bfloat16
# inputs -- the plain version in float32 rounded to bf16 once, as the
# kernels compute in float32 (the tensor-core kernel feeds P to its second
# product as two bf16 terms, exact to 2^-17) and round only their output:
# one bf16 ulp (2^-7 relative at most) apart where the two float32 results
# straddle a rounding boundary
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=1e-3, rtol=8e-3)}
# bf16 shapes at the tensor-core flash kernel's edges (128 query rows a
# block, 64 keys a K/V tile): (B, S, H, KV, D, causal, window)
WGMMA_EDGES = [
    (1, 100, 4, 1, 256, True, 0),        # S below one q-tile
    (1, 1000, 16, 1, 256, True, 300),    # S and window not multiples of 64
    (2, 300, 4, 2, 128, True, 40),       # window below one tile, group 2
    (1, 200, 4, 4, 64, True, 0),         # MHA (group 1), D = 64
    (1, 333, 4, 2, 128, False, 100),     # non-causal with a window
    (2, 512, 16, 1, 256, False, 0),      # non-causal, MQA (group 16)
    (1, 300, 14, 2, 128, True, 0),       # odd group 7 (yi-34b's), ragged S
    (1, 257, 16, 2, 128, True, 100),     # group 8 (qwen1.5-110b's), window
    (1, 333, 4, 4, 64, False, 0),        # non-causal MHA, D = 64 (whisper's
                                         # encoder)
]
# the prefix-LM and chunked masks at both flash kernels' edges, in bf16 (the
# tensor-core kernel: 128 query rows a block, 64 keys a tile) and fp32 (the
# CUDA-core one: 64 and 64): (B, S, H, KV, D, prefix_len, chunk)
MASK_EDGES = [
    (1, 300, 4, 1, 256, 1, 0),           # prefix 1 (= causal)
    (2, 333, 8, 1, 256, 100, 0),         # ragged prefix, MQA, ragged S
    (1, 200, 4, 2, 128, 200, 0),         # prefix = S: full attention
    (1, 300, 4, 4, 64, 0, 32),           # chunk below a tile
    (1, 333, 10, 2, 128, 0, 100),        # chunk not a tile multiple, group 5
    (2, 400, 4, 2, 128, 0, 128),         # chunk = the q-tile
    (1, 300, 12, 2, 128, 0, 1000),       # chunk past S (causal), group 6
]
# (the dense decoders' prefill shapes, DENSE_FLASH below, are held and
# timed in [dense]; the prefix-LM and MoE decoders', VLM_MOE_FLASH, in
# [vlm-moe])
# prefill (kernels) against token-by-token decode (plain), full config and
# the reduced config in bfloat16: bf16 activations round at 2^-8 in every
# op, at other places on the two paths, so the logits agree to a few
# percent, not to ulps.  The full config's 64-token prompt is one flash
# tile; the reduced config's checks below cover several tiles and the
# window skip, in float32 at a float32 tolerance and in bfloat16 at this one
PREFILL_DECODE_REL_RMS = 5e-2
# card (kernels) against CPU (plain), and prefill (kernels) against
# token-by-token decode (plain) on the card, reduced config in float32: the
# reference's decode-parity tolerance (tests/test_decode_parity.py)
SUBSTRATE_TOL = dict(atol=2e-4, rtol=1e-3)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, *, min_iters=3, budget_s=0.5):
    """Mean device time of ``fn()`` in ms over CUDA events, after warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    iters = max(min_iters, min(200, int(budget_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps=20):
    """Device time of one ``fn()`` in ms with no host time in it: ``reps``
    calls captured in one CUDA graph, replayed and timed by ``time_ms``.
    For a kernel whose wrapper takes longer on the host than the kernel on
    the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay) / reps


def bound_ms(n_bytes: float, n_ops: float,
             peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Kernel inputs and work counts
# ---------------------------------------------------------------------------

SCORE_OPS_PER_ROW = 9 * 7 + 27 * 3 + 201 * 12 + 2
# the Eq. 21 normalisation's elementwise operations per (client, edge)
# pair: clamp, log10, ×10, the min and max, −lo, ÷, clamp, ×100
SCORE_NORM_OPS_PER_PAIR = 9


def score_inputs(rows: int, seed: int, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 100.0, (3, rows)).astype(np.float32)
    vals[:, ::17] = np.round(vals[:, ::17])          # exact set boundaries
    return [torch.tensor(v, device=dev) for v in vals]


def score_work(rows: int):
    return 4 * rows * 4 + 4 * (9 + 5 * 201 + 27), rows * SCORE_OPS_PER_ROW


def sic_inputs(n: int, m: int, per_edge: int, seed: int, dev, ties: bool):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.01, 0.1, n).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, (n, m)) * 1e-9).astype(np.float32)
    mask = np.zeros((n, m), bool)
    if per_edge:
        owner = rng.integers(0, m, n)
        for e in range(m):
            mask[np.flatnonzero(owner == e)[:per_edge], e] = True
    else:
        mask = rng.random((n, m)) < 0.5
    if ties:   # exact-tie rows: equal received power at every edge
        p[1::5] = p[0::5][:len(p[1::5])]
        g[1::5] = g[0::5][:len(g[1::5])]
    return (torch.tensor(p, device=dev), torch.tensor(g, device=dev),
            torch.tensor(mask, device=dev))


def sic_work(mask):
    """Bytes and operations the SIC rates need at this (N, M) bool
    ``mask`` (numpy or torch): the N·M fp32 gains, the N·M one-byte mask
    and the N powers read once, the N·M rates written once; the weaker-than
    test over each edge's own n_e masked clients (a compare and an add a
    pair, 2·Σₑ nₑ²) and 8 operations a (client, edge) for rx, the SINR and
    the rate."""
    n, m = mask.shape
    per_edge = [int(v) for v in mask.sum(0).tolist()]
    n_bytes = 4 * n * m + n * m + 4 * n + 4 * n * m
    return n_bytes, 2 * sum(v * v for v in per_edge) + 8 * m * n


def sgd_inputs(k, tau1, batch, d_in, hidden, n_classes, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shapes = {"w1": (k, d_in, hidden), "b1": (k, hidden),
              "w2": (k, hidden, hidden), "b2": (k, hidden),
              "w3": (k, hidden, n_classes), "b3": (k, n_classes)}
    params = {}
    for name, shape in shapes.items():
        scale = 1.0 / math.sqrt(shape[1]) if len(shape) == 3 else 0.1
        params[name] = torch.tensor(
            (scale * rng.normal(size=shape)).astype(np.float32), device=dev)
    bx = torch.tensor(rng.uniform(0.0, 1.0, (tau1, k, batch, d_in))
                      .astype(np.float32), device=dev)
    by = torch.tensor(rng.integers(0, n_classes, (tau1, k, batch))
                      .astype(np.int32), device=dev)
    return params, bx, by


def sgd_work(k, tau1, batch, d_in, hidden, n_classes):
    n_params = d_in * hidden + hidden + hidden * hidden + hidden \
        + hidden * n_classes + n_classes
    mats = d_in * hidden + hidden * hidden + hidden * n_classes
    per_step = (2 * batch * mats                      # forward
                + 2 * batch * mats                    # weight gradients
                + 2 * batch * (hidden * hidden + hidden * n_classes)  # dh
                + 5 * batch * n_classes               # softmax + dl
                + 2 * n_params)                       # update
    n_bytes = 2 * 4 * k * n_params + tau1 * k * batch * (4 * d_in + 4)
    return n_bytes, tau1 * k * per_step


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    log(f"[build] {info.path.name}: nvcc {info.seconds:.2f} s, "
        f"load {time.perf_counter() - t0:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line or "Performance" in line:
            log("[build]   " + line.strip())


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def _check_close(name, got, want, rtol, atol):
    import torch
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {_max_err(got, want):.3e}, rtol {rtol}, "
            f"atol {atol})")


def compare_score(rows, seed, dev):
    from repro_torch.kernels import hfl_ops
    cq, dq, ms = score_inputs(rows, seed, dev)
    got = hfl_ops.score_rows(cq, dq, ms)
    want = hfl_ops.score_rows_plain(cq, dq, ms)
    _check_close(f"score_rows R={rows}", got, want, **TOL["score_rows"])
    ms_k = time_ms(lambda: hfl_ops.score_rows(cq, dq, ms))
    ms_p = time_ms(lambda: hfl_ops.score_rows_plain(cq, dq, ms))
    return _max_err(got, want), ms_k, ms_p, score_work(rows)


def score_fused_work(n, m, k=None):
    """Bytes (the gains, counts and staleness read once, the frontier's
    int32 indices where there are, the scores written once, the tables)
    and operations (the Eq. 21 normalisation over the whole N·M field,
    the fuzzy pipeline over the N·K or N·M rows) of one fused score."""
    w = m if k is None else k
    idx = 0 if k is None else n * k
    n_bytes = 4 * (n * m + 2 * n + idx + n * w) + 4 * (9 + 5 * 201 + 27)
    return n_bytes, n * m * SCORE_NORM_OPS_PER_PAIR + n * w * SCORE_OPS_PER_ROW


def score_old_vs_new(name, new, old, plain, work):
    """The fused score (``new``: one C call from the raw inputs) against
    the unfused chain it replaced (``old``: the torch normalisation and
    gather around the rows kernel), in turns old, new, new, old, each with
    its wrapper time (CUDA events around the call, host time included)
    and its device time (a CUDA-graph replay); ``new`` held to the plain
    version bit for bit, and to exactly one launch of its own counter and
    none of the rows kernel.  Returns err, new ms, plain ms, bound."""
    import torch
    from repro_torch.kernels import hfl_ops
    counter = "score_matrix" if name.startswith("score_matrix") \
        else "score_candidates"
    before = dict(hfl_ops.LAUNCHES)
    got = new()
    torch.cuda.synchronize()
    if (hfl_ops.LAUNCHES[counter] - before[counter],
            hfl_ops.LAUNCHES["score_rows"] - before["score_rows"]) != (1, 0):
        raise AssertionError(f"{name}: expected one {counter} call and no "
                             f"score_rows launch")
    want = plain()
    err = _max_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the fused score is not bit-equal to "
                             f"its plain version (max abs err {err:.3e})")
    if not torch.equal(old(), want):
        raise AssertionError(f"{name}: the unfused chain is not bit-equal "
                             f"to the plain version")
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        fn = new if who == "new" else old
        times[who].append((time_ms(fn), graph_ms(fn)))
    ms_p = time_ms(plain, min_iters=2, budget_s=0.2)
    b_ms, b_by = bound_ms(*work)
    fmt = "; ".join
    log(f"[compare] {name}: bit-equal to plain; new (fused) "
        + fmt(f"{c:.4f} ms (device {d:.4f})" for c, d in times["new"])
        + "; old (torch normalisation + rows kernel) "
        + fmt(f"{c:.4f} ms (device {d:.4f})" for c, d in times["old"])
        + f"; plain {ms_p:.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    ms_new = sum(c for c, _ in times["new"]) / 2
    return err, ms_new, ms_p, b_ms, b_by


def edge_gains(n, m, seed):
    """Gains with exact dB ties, values under the 1e-30 clamp and zeros."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    g[::5] = g[0]                       # exact ties across clients
    g[1::7, 0] = 1e-35
    g[2::11, -1] = 0.0
    return g


def compare_score_matrix(cfg, dev):
    """The dense fused score at ``CONFIG`` on the engine's first-round
    inputs with random staleness, old vs new in turns (the entry of the
    JSON line), then untimed on edge gains and all-zero staleness; the
    unfused chain's rows-kernel launch, logged."""
    import numpy as np
    import torch
    from repro_torch.core import engine, fuzzy
    from repro_torch.kernels import hfl_ops
    state, bundle, _ = engine.init_simulation(cfg, seed=0, device=dev)
    rng = np.random.default_rng(8)
    stale = torch.tensor(rng.integers(1, 9, cfg.n_clients).astype(np.int32),
                         device=dev)
    dm = float(cfg.max_samples)

    def call(g, c, st):
        return (lambda: hfl_ops.score_matrix(g, c, st, data_max=dm),
                lambda: fuzzy.score_matrix(g, c, st, data_max=dm,
                                           rows=hfl_ops.score_rows),
                lambda: fuzzy.score_matrix(g, c, st, data_max=dm,
                                           rows=hfl_ops.score_rows_plain))
    n, m = cfg.n_clients, cfg.n_edges
    res = score_old_vs_new(f"score_matrix N={n} M={m}",
                           *call(state.gains, bundle.counts, stale),
                           score_fused_work(n, m))
    for g, st in ((edge_gains(n, m, 9), stale),
                  (edge_gains(4097, 32, 10), None)):
        gt = torch.tensor(g, device=dev)
        nn = gt.shape[0]
        counts = torch.tensor(rng.integers(60, 1200, nn).astype(np.float32),
                              device=dev)
        st = torch.zeros(nn, dtype=torch.int32, device=dev) \
            if st is None else st
        new, _, plain = call(gt, counts, st)
        got, want = new(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"score_matrix N={nn}: edge gains not "
                                 f"bit-equal (max abs err "
                                 f"{_max_err(got, want):.3e})")
        log(f"[compare] score_matrix N={nn} M={g.shape[1]} edge gains (ties, "
            f"< 1e-30, zeros; staleness {'all 0' if nn > n else 'random'}):"
            f" bit-equal")
    # the unfused chain, which no engine path runs now, launches the rows
    # kernel once (a log line; not the JSON line's)
    before = hfl_ops.LAUNCHES["score_rows"]
    call(state.gains, bundle.counts, stale)[1]()
    torch.cuda.synchronize()
    log(f"[compare] score_matrix N={n} M={m} unfused chain: "
        f"{hfl_ops.LAUNCHES['score_rows'] - before} score_rows launch")
    err, ms_new, ms_p, b_ms, b_by = res
    return err, ms_new, ms_p, score_fused_work(n, m)


def compare_sic(n, m, per_edge, seed, dev, ties, clusters=()):
    """The SIC kernel against its plain version at the default cluster
    size and, untimed, at each of ``clusters``; the wrapper call's time
    (CUDA events, host time included) and its device time (graph
    replay), beside the bound counted from the mask."""
    import torch
    from repro_torch.core import noma
    from repro_torch.kernels import hfl_ops
    p, g, mask = sic_inputs(n, m, per_edge, seed, dev, ties)
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    want = hfl_ops.sic_rates_plain(p, g, mask, **kw)
    tol = TOL["sic_rates"]
    c0 = hfl_ops.sic_cluster_size(n)
    name = (f"sic_rates N={n} M={m} "
            f"{'one-hot ' + str(per_edge) if per_edge else '50% mask'}")
    before = hfl_ops.LAUNCHES["sic_rates"]
    got = hfl_ops.sic_rates(p, g, mask, **kw)
    torch.cuda.synchronize()
    if hfl_ops.LAUNCHES["sic_rates"] != before + 1:
        raise AssertionError(f"{name}: expected one sic_rates launch")
    for c in (c0, *clusters):
        out = got if c == c0 else hfl_ops._sic_launch(p, g, mask, c, **kw)
        _check_close(f"{name} cluster {c}", out, want, tol["rtol"],
                     float(want.abs().max()) * tol["atol_frac"])
        if c != c0:
            ms_c = graph_ms(lambda: hfl_ops._sic_launch(p, g, mask, c,
                                                        **kw))
            log(f"[compare] {name} cluster {c}: max_abs_err "
                f"{_max_err(out, want):.3e}  device {ms_c:.4f} ms")
    ms_k = time_ms(lambda: hfl_ops.sic_rates(p, g, mask, **kw))
    ms_dev = graph_ms(lambda: hfl_ops.sic_rates(p, g, mask, **kw))
    ms_p = time_ms(lambda: hfl_ops.sic_rates_plain(p, g, mask, **kw))
    work = sic_work(mask)
    b_ms, b_by = bound_ms(*work)
    log(f"[compare] {name} cluster {c0} (default): max_abs_err "
        f"{_max_err(got, want):.3e}  kernel {ms_k:.4f} ms (device "
        f"{ms_dev:.4f} ms by graph replay)  plain {ms_p:.4f} ms  bound "
        f"{b_ms:.6f} ms ({b_by}; {work[1] - 8 * m * n} pair ops over "
        f"{int(mask.sum())} masked pairs)")
    return _max_err(got, want), ms_k, ms_p, work


def compare_sgd(k, tau1, batch, d_in, hidden, n_classes, seed, dev,
                timed=True):
    """Kernel vs plain through the wrapper, checking the route it took;
    with ``timed``, the kernel's device time (CUDA-graph replay: the
    wrapper's host time exceeds the kernel's), the wrapper call's time and
    the plain version's."""
    import ctypes
    import torch
    from repro_torch.kernels import hfl_ops
    from repro_torch.kernels._build import check as _build_check
    from repro_torch.kernels._build import library as _build_lib
    from repro_torch.models.mlp import PARAM_KEYS
    params, bx, by = sgd_inputs(k, tau1, batch, d_in, hidden, n_classes,
                                seed, dev)
    shape = (k, batch, d_in, hidden, n_classes)
    route = hfl_ops.sgd_route(*shape)
    c = hfl_ops.sgd_cluster_size(*shape)
    before = dict(hfl_ops.LAUNCHES)
    got = hfl_ops.local_sgd_step(params, bx, by, lr=0.01)
    torch.cuda.synchronize()
    cluster = int(route == "hfl_local_sgd_cluster")
    if (hfl_ops.LAUNCHES["local_sgd_step_cluster"]
            - before["local_sgd_step_cluster"]) != cluster:
        raise AssertionError(f"local_sgd_step K={k}: expected {route}")
    want = hfl_ops.local_sgd_step_plain(params, bx, by, lr=0.01)
    err = 0.0
    name = (f"local_sgd_step K={k} tau1={tau1} B={batch} D={d_in} "
            f"H={hidden} ({route}, cluster {c})")
    for leaf in PARAM_KEYS:
        _check_close(f"{name} {leaf}", got[leaf], want[leaf],
                     **TOL["local_sgd_step"])
        err = max(err, _max_err(got[leaf], want[leaf]))
    if not timed:
        log(f"[compare] {name}: max_abs_err {err:.3e}")
        return err

    def call():
        return hfl_ops.local_sgd_step(params, bx, by, lr=0.01)
    ms_k = graph_ms(call)
    ms_call = time_ms(call)
    ms_p = time_ms(lambda: hfl_ops.local_sgd_step_plain(params, bx, by,
                                                        lr=0.01))
    smem = hfl_ops.sgd_smem_bytes(batch, d_in, hidden, n_classes, c)
    active = hfl_ops.sgd_max_active_clusters(*shape)
    # the same launch asking for more than half an SM's shared memory: one
    # CTA an SM, the layout the kernel's 2-CTA budget avoids
    alone = ctypes.c_int(0)
    _build_check(_build_lib().hfl_sgd_max_active_clusters(
        *shape, c, max(smem, 116_000), ctypes.byref(alone)), "occupancy")
    log(f"[compare] {name}: kernel {ms_k:.4f} ms (graph replay), wrapper "
        f"call {ms_call:.4f} ms; {k * c} CTAs, {smem} bytes of shared "
        f"memory a CTA, {active} clusters active at once ({alone.value} at "
        f"one CTA an SM)")
    return err, ms_k, ms_p, sgd_work(k, tau1, batch, d_in, hidden,
                                     n_classes)


# the SGD kernels' edge shapes (tests/test_torch_cuda.py): (K, τ₁, B, D, H)
# -- every cluster size, K = 1, τ₁ = 4, ragged tiles and W1 row slices, a
# CTA without rows of W1, and a layer too wide for any cluster (the
# block-per-lane kernel)
SGD_EDGES = [(3, 2, 5, 7, 6), (2, 2, 6, 30, 12), (1, 4, 8, 30, 16),
             (1, 1, 32, 783, 128), (40, 2, 9, 50, 20), (1, 2, 4, 7, 16),
             (1, 1, 4, 70_000, 8)]


def phase_compare(cfg, dev):
    """Kernel vs plain at the CONFIG shapes (returned for the JSON line)
    and at the reference bench scale (printed)."""
    quota = cfg.clients_per_edge
    # the rows-only kernel, on no engine path now: printed, not in the
    # JSON line
    rows = {"score_rows": compare_score(cfg.n_clients * cfg.n_edges, 1, dev)}
    main = {
        "score_matrix": compare_score_matrix(cfg, dev),
        "sic_rates": compare_sic(cfg.n_clients, cfg.n_edges, quota, 2, dev,
                                 ties=True),
        "local_sgd_step": compare_sgd(
            quota * cfg.n_edges, cfg.tau1, cfg.local_batch, cfg.input_dim,
            cfg.hidden, cfg.n_classes, 3, dev),
    }
    # the reference bench scale: the engine's one-hot association (4
    # clients an edge) and a dense 50% mask with exact ties, every cluster
    # size
    bench = {
        "score_rows": compare_score(4096 * 32 + 37, 4, dev),
        "sic_rates one-hot": compare_sic(4096, 32, 4, 7, dev, ties=True),
        "sic_rates": compare_sic(4097, 32, 0, 5, dev, ties=True,
                                 clusters=(1, 2, 4, 8)),
        "local_sgd_step": compare_sgd(4 * 32, 3, 16, 32, 16, 10, 6, dev),
    }
    for i, (k, tau1, batch, d_in, hidden) in enumerate(SGD_EDGES):
        compare_sgd(k, tau1, batch, d_in, hidden, 10, 20 + i, dev,
                    timed=False)
    for label, res in (("CONFIG", {**rows, **main}),
                       ("bench 4096x32", bench)):
        for name, (err, ms_k, ms_p, work) in res.items():
            b_ms, b_by = bound_ms(*work)
            log(f"[compare] {label:>13} {name:<17} max_abs_err {err:.3e}  "
                f"kernel {ms_k:.4f} ms  plain {ms_p:.4f} ms  "
                f"bound {b_ms:.6f} ms ({b_by})")
    return main


class StageTimer:
    """CUDA-event spans around each engine stage (``round_step``'s
    ``timer`` hook)."""

    def __init__(self):
        import torch
        self._torch = torch
        self.spans = {}

    @contextlib.contextmanager
    def __call__(self, name):
        ev = self._torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.spans.setdefault(name, []).append((start, end))

    def ms(self):
        self._torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.spans.items()}


def _check_metrics(cfg, spec_quota, rows, m_c):
    for r in rows:
        vals = [r.accuracy, r.loss, r.avg_staleness, r.total_time_s,
                r.total_energy_j, r.cost]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"round {r.round}: non-finite metrics {r}")
        if r.n_associated > spec_quota * cfg.n_edges:
            raise AssertionError(f"round {r.round}: {r.n_associated} "
                                 f"associated > quota·M")
        if r.n_associated > r.n_available:
            raise AssertionError(f"round {r.round}: {r.n_associated} "
                                 f"associated > {r.n_available} available")
        if int(r.z.sum()) != m_c:
            raise AssertionError(f"round {r.round}: Σz = {r.z.sum()} != "
                                 f"M_c = {m_c}")


def _drive(cfg, policy, scheduler, rounds, dev, **kw):
    import torch
    from repro_torch.core.hfl import HFLSimulation
    from repro_torch.kernels import hfl_ops
    sim = HFLSimulation(cfg, seed=0, policy=policy, scheduler=scheduler,
                        device=dev, **kw)
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rows.append(sim.run_round(timer=timer))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(hfl_ops.LAUNCHES)
    return sim, rows, walls, timer.ms(), launches


def phase_main_path(cfg, dev):
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    quota = cfg.clients_per_edge
    runs = {}
    for policy, scheduler, rounds in (("fcea", "pdd", 5),
                                      ("gcea", "fastest", 2)):
        sim, rows, walls, stages, launches = _drive(cfg, policy, scheduler,
                                                    rounds, dev)
        want = _want_launches(cfg, sim.spec, rounds)
        if launches != want:
            raise AssertionError(f"{policy}-{scheduler}: launches {launches} "
                                 f"!= expected {want}")
        _check_metrics(cfg, quota, rows, m_c)
        steady = _report("main", f"{policy}-{scheduler}", rows, walls,
                         stages, launches)
        runs[policy] = (sim, launches, steady)
    return runs


def _report(tag, label, rows, walls, stages, launches, per_round=True):
    """Print each round (unless ``per_round`` is off), the steady s/round
    and the stage spans; return the steady s/round (rounds 2.., or round
    1 alone)."""
    rounds = len(rows)
    for r, w in zip(rows, walls if per_round else ()):
        log(f"[{tag}] {label} round {r.round}: {w:.4f} s  "
            f"acc {r.accuracy:.4f} loss {r.loss:.5f} cost {r.cost:.5f} "
            f"n_avail {r.n_available} n_assoc {r.n_associated} "
            f"z {r.z.tolist()} sweeps {r.sweeps}")
    steady = walls[1:] or walls
    log(f"[{tag}] {label}: launches {launches}; "
        f"s/round {sum(steady) / len(steady):.4f} "
        f"(rounds 2..{rounds}; round 1 {walls[0]:.4f})")
    for name, spans in stages.items():
        tail = spans[1:] or spans
        log(f"[stage] {label} {name:<9} "
            f"{sum(tail) / len(tail):.4f} ms/round "
            f"(rounds 2..{rounds}; round 1 {spans[0]:.4f})")
    return sum(steady) / len(steady)


def profile_device(fn, label, steady_s):
    """Device busy share of one call of ``fn``: the time of the CUDA
    kernels ``torch.profiler`` records, over the profiled call's wall time
    and over ``steady_s``, the unprofiled steady time of the same call;
    and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # host ops (their kernels are counted below), and the engine's
        # ``hfl/<stage>`` ranges, which the profiler mirrors onto the
        # device timeline as spans over their kernels: not kernels
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("hfl/"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append((us, ev.count, ev.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    launches = sum(count for _, count, _ in rows)
    log(f"[profile] {label}: {launches} kernels, device busy "
        f"{busy_s * 1e3:.3f} ms; profiled wall {wall_s * 1e3:.3f} ms "
        f"(busy {100.0 * busy_s / wall_s:.2f}%); unprofiled steady "
        f"{steady_s * 1e3:.3f} ms (busy {100.0 * busy_s / steady_s:.2f}%, "
        f"idle {100.0 * (1.0 - busy_s / steady_s):.2f}%)")
    for us, count, key in sorted(rows, reverse=True)[:16]:
        log(f"[profile]   {us / 1e3:9.3f} ms  x{count:<6} {key[:90]}")


def _to(obj, device):
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, device) for v in obj))
    return obj


def _check_bill(tag, g, c, n_test):
    """A round's ``metrics_row`` ``g`` against ``c``: cost, time and energy
    to rtol 1e-5, the loss to rtol 1e-4, the accuracy to 2 test samples.
    Returns the largest relative difference of each."""
    worst = {}
    for key, rtol in (("cost", 1e-5), ("total_time_s", 1e-5),
                      ("total_energy_j", 1e-5), ("loss", 1e-4)):
        # a buffered micro-step that lands nothing bills 0
        worst[key] = abs(g[key] - c[key]) / max(abs(c[key]), 1e-30)
        if not math.isclose(g[key], c[key], rel_tol=rtol):
            raise AssertionError(f"{tag} {key}: {g[key]} vs {c[key]} "
                                 f"(rtol {rtol})")
    if abs(g["accuracy"] - c["accuracy"]) > 2.0 / n_test:
        raise AssertionError(f"{tag} accuracy: {g['accuracy']} vs "
                             f"{c['accuracy']}")
    return worst


def card_vs_cpu(cfg, spec, state, bundle, generator, label="", actor=None):
    """One round of ``spec`` from ``state`` with fresh draws from
    ``generator`` (billed by the DDPG ``actor``, if given), on the card
    and, from the same state, draws and actor, on the CPU: ``z``, ``n_associated``, sweeps and staleness exact, the bill to
    rtol 1e-5, the loss to rtol 1e-4, the accuracy to 2 test samples; on
    a dynamic scenario also ``n_available`` and the availability exactly,
    the moved positions and distances as ``_check_world`` holds them."""
    import torch
    from repro_torch import scenarios
    from repro_torch.core import engine, noma
    from repro_torch.kernels import hfl_ops
    cpu = torch.device("cpu")
    draws = engine.sample_draws(cfg, bundle, generator, spec)
    s_gpu, m_gpu = engine.round_step(cfg, spec, state, bundle, draws, actor)
    s_cpu, m_cpu = engine.round_step(cfg, spec, _to(state, cpu),
                                     _to(bundle, cpu), _to(draws, cpu),
                                     _to(actor, cpu))
    g, c = engine.metrics_row(m_gpu), engine.metrics_row(m_cpu)
    tag = f"[card-vs-cpu]{' ' + label if label else ''}"
    if cfg.n_clients <= 256:
        log(f"{tag} card {g}")
        log(f"{tag} cpu  {c}")
    exact_ok = (g["z"].tolist() == c["z"].tolist()
                and g["n_associated"] == c["n_associated"]
                and g["n_available"] == c["n_available"]
                and g["sweeps"] == c["sweeps"]
                and torch.equal(s_gpu.staleness.cpu(), s_cpu.staleness))
    dynamic = spec.scenario != "static"
    if dynamic:
        _check_world(tag, s_gpu.scenario, s_cpu.scenario, cfg.area_side_m)
    if not exact_ok:
        # print the competing scores: a gap below the score tolerance is a
        # near-tie (reported, and still a failure)
        dist = bundle.dist
        if dynamic:
            dist = scenarios.advance(cfg, spec.scenario, draws.scenario,
                                     state.scenario).dist
        gains = noma.evolve_gains(
            draws.fading, state.gains, dist,
            path_loss_exponent=cfg.path_loss_exponent,
            rho=spec.fading_rho)
        sc_g = hfl_ops.score_matrix(gains, bundle.counts, state.staleness,
                                    data_max=float(cfg.max_samples)).cpu()
        sc_c = hfl_ops.score_matrix(_to(gains, cpu), _to(bundle.counts, cpu),
                                    _to(state.staleness, cpu),
                                    data_max=float(cfg.max_samples))
        diff = (sc_g - sc_c).abs()
        srt = torch.sort(sc_c, dim=0, descending=True).values
        gaps = (srt[:-1] - srt[1:]).abs()
        log(f"{tag} score max |card - cpu| {float(diff.max()):.3e}; "
            f"smallest per-edge adjacent score gap "
            f"{float(gaps[gaps > 0].min()):.3e}; near-tie if below 2e-4")
        raise AssertionError(f"{tag} card and CPU rounds disagree on z, "
                             f"n_associated, sweeps or staleness: {g} {c}")
    _check_bill(tag, g, c, bundle.test_y.shape[0])
    world = ("availability exact; positions/distances rtol 1e-6, atol "
             "1e-6 of the side; " if dynamic else "")
    log(f"{tag} z, n_available {g['n_available']}, n_associated "
        f"{g['n_associated']}, sweeps {g['sweeps']}, staleness exact; "
        f"{world}cost/time/energy rtol 1e-5, loss rtol 1e-4, accuracy "
        f"atol 2/T: ok")


# a scenario's moved positions and distances, card against CPU: the card's
# norm rounds the waypoint step an ulp apart, and a position an ulp off
# (3e-5 m at 500 m) is more than 1e-6 of a distance of a few metres to an
# edge; so rtol 1e-6 above a floor of 1e-6 of the area's side (0.5 mm of a
# 500 m cell, ~16 ulps of a coordinate)
WORLD_RTOL = 1e-6


def _check_world(tag, got, want, area_side_m):
    """A scenario state on the card against the CPU's: the availability
    and the fixed leaves exactly, positions, waypoints and distances to
    ``WORLD_RTOL`` above a floor of ``WORLD_RTOL`` of the area's side."""
    import torch
    for field in got._fields:
        g, w = getattr(got, field).cpu(), getattr(want, field)
        if field in ("pos", "waypoint", "dist"):
            ok = torch.allclose(g, w, rtol=WORLD_RTOL,
                                atol=WORLD_RTOL * area_side_m)
        else:
            ok = torch.equal(g, w)
        if not ok:
            raise AssertionError(f"{tag} scenario {field}: card and CPU "
                                 f"disagree (max abs err "
                                 f"{_max_err(g, w):.3e})")


# ---------------------------------------------------------------------------
# The candidate path
# ---------------------------------------------------------------------------

# the dense SIC is the pairwise kernel; the candidate path bills with the
# reference's sorted SIC (``noma.sic_rates_assigned``), whose interference
# is a total minus a prefix sum: in float32 that loses up to ~2% of a weak
# client's rate, and the two bills of one association part by up to
# ~1e-3 (rtol, PERF.md)
SORTED_SIC_RTOL = 2e-3


def bench_config(cfg, n=4096, m=32):
    """The reference's ``benchmarks/bench_rounds.py::_cfg(n, m)`` (also
    ``bench_sweeps.py::_cfg()`` at 256 × 8)."""
    import dataclasses
    return dataclasses.replace(cfg, n_clients=n, n_edges=m,
                               clients_per_edge=4, min_samples=60,
                               max_samples=120, hidden=16, input_dim=32,
                               local_batch=16)


def _drive_spec(cfg, spec, rounds, dev, seed=0, scenario=None,
                on_round=None):
    """``rounds`` rounds of ``engine.round_step`` from
    ``engine.init_simulation`` (in ``scenario``), fresh draws each round,
    with every launch counter zeroed just before and read just after;
    ``on_round(state)``, if given, sees the state before the first round
    and after each.  Returns the host rows, walls, stage spans, launches
    and the final (state, bundle, generator)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.hfl import RoundMetrics
    from repro_torch.kernels import hfl_ops
    state, bundle, aux = engine.init_simulation(cfg, seed=seed, device=dev,
                                                scenario=scenario)
    if on_round:
        on_round(state)
    gen = aux["generator"]
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        draws = engine.sample_draws(cfg, bundle, gen, spec)
        state, m = engine.round_step(cfg, spec, state, bundle, draws,
                                     timer=timer)
        rows.append(RoundMetrics.from_engine(m))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if on_round:
            on_round(state)
    launches = dict(hfl_ops.LAUNCHES)
    return rows, walls, timer.ms(), launches, (state, bundle, gen)


def _want_launches(cfg, spec, rounds, seeds=1):
    """The kernel launches ``rounds`` rounds of ``spec`` make, of one
    simulation or of a fleet of ``seeds``: one score call and one SIC call a
    round whatever the fleet's size (and one more SIC call for the fpa/fca
    grid), τ₂ SGD launches over its S·K lanes."""
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    fcea = spec.policy == "fcea"
    dense = spec.candidates_k is None
    grid = spec.allocator in ("fpa", "fca")
    lanes = seeds * min(cfg.n_clients,
                        engine.quota_for(cfg, spec) * cfg.n_edges)
    cluster = hfl_ops.sgd_route(lanes, cfg.local_batch, cfg.input_dim,
                                cfg.hidden, cfg.n_classes) \
        == "hfl_local_sgd_cluster"
    return {"score_rows": 0,
            "score_matrix": rounds * (fcea and dense),
            "score_candidates": rounds * (fcea and not dense),
            "sic_rates": rounds * ((dense + grid) * spec.noma_enabled),
            "local_sgd_step": cfg.tau2 * rounds,
            "local_sgd_step_cluster": cfg.tau2 * rounds * cluster}


def _run_spec(cfg, spec, rounds, dev, label, tag="cand", scenario=None,
              per_round=True, on_round=None):
    """Drive ``spec`` (in ``scenario``), check its launches and metrics,
    print its rounds and stages.  Returns (rows, steady s/round, stages,
    launches, final)."""
    from repro_torch.core import engine
    rows, walls, stages, launches, final = _drive_spec(
        cfg, spec, rounds, dev, scenario=scenario, on_round=on_round)
    want = _want_launches(cfg, spec, rounds)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != expected "
                             f"{want}")
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    _check_metrics(cfg, engine.quota_for(cfg, spec), rows, m_c)
    steady = _report(tag, label, rows, walls, stages, launches, per_round)
    return rows, steady, stages, launches, final


def _same_decisions(label, dense_rows, cand_rows):
    """K ≥ the maximum coverage degree loses nothing: the candidate round
    makes the dense round's decisions (z, n_associated, sweeps, staleness;
    the same training, so the same loss and accuracy); its bill differs
    only by the sorted SIC's float32 rounding (``SORTED_SIC_RTOL``)."""
    worst = {}
    for d, c in zip(dense_rows, cand_rows):
        same = (d.z.tolist() == c.z.tolist()
                and (d.n_associated, d.sweeps, d.avg_staleness)
                == (c.n_associated, c.sweeps, c.avg_staleness))
        if not same:
            raise AssertionError(f"{label} round {d.round}: candidate "
                                 f"decisions differ from dense: {d} {c}")
        if not (math.isclose(d.loss, c.loss, rel_tol=1e-6)
                and d.accuracy == c.accuracy):
            raise AssertionError(f"{label} round {d.round}: training "
                                 f"differs: {d} {c}")
        for key in ("cost", "total_time_s", "total_energy_j"):
            a, b = getattr(d, key), getattr(c, key)
            worst[key] = max(worst.get(key, 0.0), abs(a - b) / abs(a))
            if not math.isclose(a, b, rel_tol=SORTED_SIC_RTOL):
                raise AssertionError(f"{label} round {d.round} {key}: "
                                     f"dense {a} vs candidate {b}")
    log(f"[cand] {label}: z, n_associated, sweeps, staleness exact; loss "
        f"rtol 1e-6, accuracy equal; bill max rel diff (pairwise vs sorted "
        f"SIC) " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limit {SORTED_SIC_RTOL}): ok")


def compare_score_candidates(state, bundle, cfg, k, n_rows=None):
    """The fused score on the frontier of the bench state's gains (the
    first ``n_rows`` clients), old vs new in turns, beside its bound."""
    from repro_torch.core import candidates, engine, fuzzy
    from repro_torch.kernels import hfl_ops
    n = n_rows or cfg.n_clients
    gains, counts, stale = (state.gains[:n], bundle.counts[:n],
                            state.staleness[:n])
    cand = candidates.build_candidates(
        bundle.dist[:n], k, coverage_radius_m=engine.coverage_radius(cfg))
    dm = float(cfg.max_samples)

    def unfused(rows):
        return lambda: fuzzy.score_candidates(gains, cand, counts, stale,
                                              data_max=dm, rows=rows)
    return score_old_vs_new(
        f"score_candidates N={n} M={cfg.n_edges} K={k} ({n * k} rows)",
        lambda: hfl_ops.score_candidates(gains, cand.idx, counts, stale,
                                         data_max=dm),
        unfused(hfl_ops.score_rows), unfused(hfl_ops.score_rows_plain),
        score_fused_work(n, cfg.n_edges, k)) + (None,)


def phase_candidates(cfg, dev):
    """The candidate path at ``CONFIG`` and at the bench scale.  Returns
    the ``score_candidates`` entry of the kernel line: its launches on the
    bench K = 8 run and its comparison at 4096 × 8 rows."""
    import dataclasses
    from repro_torch.core import candidates, engine
    # 1. CONFIG: K = M against dense, fcea + PDD
    m = cfg.n_edges
    deg = candidates.max_coverage_degree(
        engine.init_simulation(cfg, seed=0, device=dev)[1].dist,
        engine.coverage_radius(cfg))
    if deg > m:
        raise AssertionError(f"coverage degree {deg} > M")
    dense = engine.EngineSpec()
    rows_d = _run_spec(cfg, dense, 3, dev, "CONFIG dense fcea-pdd")[0]
    rows_m = _run_spec(cfg, dataclasses.replace(dense, candidates_k=m), 3,
                       dev, f"CONFIG K={m} fcea-pdd")[0]
    _same_decisions(f"CONFIG K={m} vs dense", rows_d, rows_m)
    # 2. CONFIG, K = 2: card against CPU, then gcea and rcea + rra
    k2 = dataclasses.replace(dense, candidates_k=2)
    state, bundle, gen = _run_spec(cfg, k2, 2, dev, "CONFIG K=2 fcea-pdd")[4]
    card_vs_cpu(cfg, k2, state, bundle, gen, "CONFIG K=2")
    for kw in (dict(policy="gcea", scheduler="fastest"),
               dict(policy="rcea", allocator="rra", scheduler="fastest")):
        spec = dataclasses.replace(k2, **kw)
        _run_spec(cfg, spec, 2, dev, f"CONFIG K=2 {spec.policy}-"
                  f"{spec.allocator}-{spec.scheduler}")
    # 3. the bench scale: dense, K = 8, K = 4, by stage
    big = bench_config(cfg)
    runs = {}
    for k in (None, 8, 4):
        spec = dataclasses.replace(dense, candidates_k=k)
        runs[k] = _run_spec(big, spec, 3, dev,
                            f"4096x32 {'dense' if k is None else f'K={k}'} "
                            f"fcea-pdd", tag="bench")
    log("[bench] 4096x32 s/round (rounds 2..3): "
        + ", ".join(f"{'dense' if k is None else f'K={k}'} {r[1]:.4f}"
                    for k, r in runs.items()))
    state, bundle, gen = runs[4][4]
    card_vs_cpu(big, dataclasses.replace(dense, candidates_k=4), state,
                bundle, gen, "4096x32 K=4")
    # 4. the score kernel at the frontier's rows
    out = compare_score_candidates(state, bundle, big, 8)
    compare_score_candidates(state, bundle, big, 4)
    compare_score_candidates(state, bundle, big, 3, n_rows=4095)
    return {"score_candidates": (runs[8][3]["score_candidates"], out)}


# ---------------------------------------------------------------------------
# The fleet: run_fleet, one batched round over a leading seed axis
# ---------------------------------------------------------------------------

# the fleets the reference runs: 4 seeds below N = 1024 and 2 from there
# on (benchmarks/bench_rounds.py:467; 4 in benchmarks/bench_sweeps.py:102,
# 2 in src/repro/sweeps/grid.py:372,385); and S = 8, twice the largest,
# at CONFIG, at which one round's 128 SGD lanes launch 1024 CTAs (one
# seed's cluster size, 8), and 4 at the bench scale: the CONFIG and
# bench-scale sizes driven
REF_FLEET_SEEDS = (4, 2)
FLEET_SEEDS = (8, 4)
# rounds of each CONFIG fleet run (in turns S = 1, 4, 8, 8, 4, 1) and of
# each seed's own run: host-bound rounds, kept few so that the script stays
# near half its time limit on a slow host
FLEET_ROUNDS = 3


# the worlds ``_world`` has built, by (config, seed, scenario, device):
# (state, bundle, the generator's state after init_simulation)
WORLDS = {}


def _clone(obj):
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_clone(v) for v in obj))
    return obj


def _world(cfg, seed, dev, world=None):
    """``init_simulation(cfg, seed=seed, scenario=world)``'s (state,
    bundle, generator), built once a phase (``WORLDS``, emptied after
    each; ~1.8 s a seed at ``CONFIG``) and handed out as fresh copies: a copy and its generator
    are what a new build gives, bit for bit."""
    import torch
    from repro_torch.core import engine
    key = (cfg, seed, world, str(dev))
    if key not in WORLDS:
        state, bundle, aux = engine.init_simulation(
            cfg, seed=seed, device=dev, scenario=world)
        WORLDS[key] = (state, bundle, aux["generator"].get_state())
    state, bundle, gen_state = WORLDS[key]
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    return _clone(state), _clone(bundle), gen


def _fleet(cfg, seeds, dev, worlds=None):
    """``stack_fleet`` of ``init_simulation`` at each seed (in its scenario
    of ``worlds``, if given; ``_world``), and the seeds' generators."""
    from repro_torch.core import engine
    pairs, gens = [], []
    for i, s in enumerate(seeds):
        state, bundle, gen = _world(cfg, s, dev,
                                    worlds[i] if worlds else None)
        pairs.append((state, bundle))
        gens.append(gen)
    return (*engine.stack_fleet(pairs), gens)


def _drive_fleet(cfg, spec, seeds, rounds, dev, label, worlds=None,
                 actors=None):
    """``run_fleet`` of ``seeds`` for ``rounds`` rounds, one round a call
    (the trajectory of one call of ``rounds``) so that each round's wall is
    read, with every launch counter zeroed just before and read just after;
    check the launches and each seed's metrics, print the rounds and the
    stage spans.  Returns the fleet metrics (S, rounds, …), the steady s a
    round, the final (states, bundles, generators) and the stage spans.
    ``worlds``: each seed's scenario, for a fleet of mixed worlds;
    ``actors``: one DDPG actor a seed (``run_fleet_actors``)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.hfl import RoundMetrics
    from repro_torch.kernels import hfl_ops
    states, bundles, gens = _fleet(cfg, seeds, dev, worlds)
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        states, m = engine.run_fleet_actors(cfg, spec, states, bundles, 1,
                                            gens, actors, timer=timer)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rows.append(m)
    launches = dict(hfl_ops.LAUNCHES)
    fm = engine.RoundMetrics(*(torch.cat([f.cpu() for f in field], dim=1)
                               for field in zip(*rows)))
    want = _want_launches(cfg, spec, rounds, len(seeds))
    if launches != want:
        raise AssertionError(f"[fleet] {label}: launches {launches} != "
                             f"expected {want}")
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    for s in range(len(seeds)):
        sm = engine.select_seed(fm, s)
        _check_metrics(cfg, engine.quota_for(cfg, spec),
                       [RoundMetrics.from_engine(sm, i)
                        for i in range(rounds)], m_c)
    stages = timer.ms()
    for r, w in enumerate(walls):
        log(f"[fleet] {label} round {r + 1}: {w:.4f} s; sweeps "
            f"{fm.sweeps[:, r].tolist()}; n_avail "
            f"{fm.n_available[:, r].tolist()}; n_assoc "
            f"{fm.n_associated[:, r].tolist()}; cost "
            + " ".join(f"{v:.5f}" for v in fm.cost[:, r].tolist()))
    steady = walls[1:] or walls
    steady_s = sum(steady) / len(steady)
    log(f"[fleet] {label}: launches {launches}; s/round {steady_s:.4f} "
        f"(rounds 2..{rounds}; round 1 {walls[0]:.4f}); "
        f"{len(seeds) / steady_s:.2f} seed-rounds/s")
    for name, spans in stages.items():
        tail = spans[1:] or spans
        log(f"[stage] fleet {label} {name:<9} "
            f"{sum(tail) / len(tail):.4f} ms/round "
            f"(rounds 2..{rounds}; round 1 {spans[0]:.4f})")
    return fm, steady_s, (states, bundles, gens), stages


def _fleet_vs_own(cfg, spec, seeds, members, fm, final, dev, label,
                  own=None, worlds=None, actors=None):
    """Each of ``members`` (indices into ``seeds``) against its own
    ``run_scanned`` from ``init_simulation(seed)`` (in its scenario of
    ``worlds``) and its generator, on the card: z, n_available,
    n_associated, sweeps, the mean staleness each round and the final
    staleness exactly; cost, time and energy to rtol 1e-5; the loss to
    rtol 1e-4; the accuracy to 2 test samples; the rounds whose every
    float is bit-equal are counted.  The own runs are kept in ``own`` (by
    seed and world) for a later fleet of the same seeds.  ``actors``: the
    fleet's DDPG actors, one a seed; each own run deploys its seed's."""
    import torch
    from repro_torch.core import engine
    rounds = fm.accuracy.shape[1]
    own = {} if own is None else own
    worst, exact = {}, 0
    for s in members:
        world = worlds[s] if worlds else None
        if (seeds[s], world) not in own:
            state, bundle, gen = _world(cfg, seeds[s], dev, world)
            o_state, om = engine.run_scanned(
                cfg, spec, state, bundle, rounds, gen,
                None if actors is None else engine.select_seed(actors, s))
            own[seeds[s], world] = (o_state, engine.RoundMetrics(
                *(v.cpu() for v in om)), bundle.test_y.shape[0])
        o_state, om, n_test = own[seeds[s], world]
        sm = engine.select_seed(fm, s)
        for i in range(rounds):
            g, w = engine.metrics_row(sm, i), engine.metrics_row(om, i)
            msg = f"[fleet] {label} seed {seeds[s]} round {i + 1}"
            if not (g["z"].tolist() == w["z"].tolist()
                    and all(g[k] == w[k] for k in (
                        "n_available", "n_associated", "sweeps",
                        "avg_staleness"))):
                raise AssertionError(f"{msg}: decisions differ from its own "
                                     f"run: {g} {w}")
            for key, v in _check_bill(msg, g, w, n_test).items():
                worst[key] = max(worst.get(key, 0.0), v)
            exact += all(g[k] == w[k] for k in (
                "cost", "total_time_s", "total_energy_j", "loss",
                "accuracy"))
        if not torch.equal(final.staleness[s].cpu(), o_state.staleness.cpu()):
            raise AssertionError(f"[fleet] {label} seed {seeds[s]}: final "
                                 f"staleness differs from its own run")
    who = [seeds[s] if not worlds else f"{worlds[s]}/{seeds[s]}"
           for s in members]
    log(f"[fleet] {label}: seeds {who} each equal their own run_scanned: "
        f"z, n_available, n_associated, sweeps, staleness exact; "
        f"max rel diff " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limits cost/time/energy 1e-5, loss 1e-4), every float "
        f"bit-equal in {exact} of {rounds * len(members)} rounds: ok")


def _fleet_card_vs_cpu(cfg, spec, states, bundles, gens, label):
    """One fleet round from ``states`` with fresh draws, on the card and,
    from the same states and draws, on the CPU, to ``card_vs_cpu``'s
    tolerances for every seed."""
    import torch
    from repro_torch.core import engine
    cpu = torch.device("cpu")
    draws = engine.fleet_draws(cfg, bundles, gens, spec)
    s_gpu, m_gpu = engine.fleet_step(cfg, spec, states, bundles, draws)
    s_cpu, m_cpu = engine.fleet_step(cfg, spec, _to(states, cpu),
                                     _to(bundles, cpu), _to(draws, cpu))
    n_test = bundles.test_y.shape[1]
    for s in range(bundles.dist.shape[0]):
        g = engine.metrics_row(_to(engine.select_seed(m_gpu, s), cpu))
        c = engine.metrics_row(engine.select_seed(m_cpu, s))
        tag = f"[card-vs-cpu] fleet {label} seed {s}"
        if not (g["z"].tolist() == c["z"].tolist()
                and (g["n_associated"], g["sweeps"])
                == (c["n_associated"], c["sweeps"])
                and torch.equal(s_gpu.staleness[s].cpu(), s_cpu.staleness[s])):
            raise AssertionError(f"{tag}: decisions differ: {g} {c}")
        _check_bill(tag, g, c, n_test)
    log(f"[card-vs-cpu] fleet {label}: every seed's z, n_associated, sweeps, "
        f"staleness exact; cost/time/energy rtol 1e-5, loss rtol 1e-4, "
        f"accuracy atol 2/T: ok")


def _seed_axis_call(label, call, seeds, plain, work):
    """A seed-axis kernel call ``call(sl)`` over the seeds ``sl`` of a
    fleet: the whole fleet's call held to its plain version on the same
    inputs (``plain(got)`` raises on a disagreement and returns the max abs
    error), each seed's rows bit-equal to its own single-seed call; then
    S = 1 and S in turns S = 1, S, S, S = 1, wrapper and device time (graph
    replay) of one call, beside the fleet's bound (``work``)."""
    import torch
    fleet = call(slice(None))
    err = plain(fleet)
    for s in range(seeds):
        if not torch.equal(fleet[s], call(slice(s, s + 1))[0]):
            raise AssertionError(f"[fleet] {label}: seed {s} of the fleet's "
                                 f"call differs from its own")
    times = {1: [], seeds: []}
    for size in (1, seeds, seeds, 1):
        sl = slice(0, size)
        times[size].append((time_ms(lambda: call(sl)),
                            graph_ms(lambda: call(sl))))
    b_ms, b_by = bound_ms(*work)
    log(f"[fleet] {label}: S={seeds} against plain max_abs_err {err:.3e}; "
        f"each seed bit-equal to its own call; " + "; ".join(
            f"S={size} " + ", ".join(f"{c:.4f} ms (device {d:.4f})"
                                     for c, d in t)
            for size, t in times.items())
        + f"; bound at S={seeds} {b_ms:.6f} ms ({b_by})")


def _fleet_kernel_times(cfg, states, bundles, dev):
    """The fused score (on the fleet's own gains, counts and staleness)
    and the SIC over a ``CONFIG`` fleet of S seeds: the score bit-equal to
    the plain torch chain, the SIC to ``sic_rates_plain`` at
    ``TOL["sic_rates"]``, each seed to its own call, timed against S = 1
    (``_seed_axis_call``).  Then the SGD kernel at the fleet's S·K lanes
    against its plain version, beside its bound."""
    import torch
    from repro_torch.core import fuzzy, noma
    from repro_torch.kernels import hfl_ops
    seeds = bundles.dist.shape[0]
    dm = float(cfg.max_samples)
    n, m = cfg.n_clients, cfg.n_edges

    def score(sl):
        return hfl_ops.score_matrix(states.gains[sl], bundles.counts[sl],
                                    states.staleness[sl], data_max=dm)

    def score_plain(got):
        want = fuzzy.score_matrix(states.gains, bundles.counts,
                                  states.staleness, data_max=dm,
                                  rows=hfl_ops.score_rows_plain)
        if not torch.equal(got, want):
            raise AssertionError(f"[fleet] score_matrix S={seeds}: not "
                                 f"bit-equal to the plain chain (max abs "
                                 f"err {_max_err(got, want):.3e})")
        return _max_err(got, want)
    _seed_axis_call("score_matrix CONFIG", score, seeds, score_plain,
                    [seeds * v for v in score_fused_work(n, m)])
    sic_in = [sic_inputs(n, m, cfg.clients_per_edge, 20 + s, dev, False)
              for s in range(seeds)]
    p, g, mask = (torch.stack(f) for f in zip(*sic_in))
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    tol = TOL["sic_rates"]

    def sic_plain(got):
        want = hfl_ops.sic_rates_plain(p, g, mask, **kw)
        for s in range(seeds):
            _check_close(f"[fleet] sic_rates S={seeds} seed {s}", got[s],
                         want[s], tol["rtol"],
                         float(want[s].abs().max()) * tol["atol_frac"])
        return _max_err(got, want)
    _seed_axis_call("sic_rates CONFIG", lambda sl: hfl_ops.sic_rates(
        p[sl], g[sl], mask[sl], **kw), seeds, sic_plain,
        [sum(v) for v in zip(*(sic_work(mask[s]) for s in range(seeds)))])
    lanes = seeds * min(n, cfg.clients_per_edge * m)
    _, ms_k, _, work = compare_sgd(lanes, cfg.tau1, cfg.local_batch,
                                   cfg.input_dim, cfg.hidden, cfg.n_classes,
                                   31, dev)
    b_ms, b_by = bound_ms(*work)
    log(f"[fleet] local_sgd_step CONFIG S={seeds} ({lanes} lanes, one "
        f"launch): {ms_k:.4f} ms (graph replay), bound {b_ms:.6f} ms "
        f"({b_by})")


def _fleet_frontier_score(cfg, states, bundles, k):
    """The fused score on a fleet's own frontier (its gains, K nearest
    candidates, counts and staleness): bit-equal to the plain chain
    (``fuzzy.candidate_inputs`` + ``score_rows_plain``), each seed to its
    own call, timed against S = 1 (``_seed_axis_call``)."""
    import torch
    from repro_torch.core import candidates, engine, fuzzy
    from repro_torch.kernels import hfl_ops
    seeds = bundles.dist.shape[0]
    n, m = cfg.n_clients, cfg.n_edges
    dm = float(cfg.max_samples)
    idx = candidates.build_candidates(
        bundles.dist, k, coverage_radius_m=engine.coverage_radius(cfg)).idx

    def call(sl):
        return hfl_ops.score_candidates(states.gains[sl], idx[sl],
                                        bundles.counts[sl],
                                        states.staleness[sl], data_max=dm)

    def plain(got):
        want = hfl_ops.score_rows_plain(*fuzzy.candidate_inputs(
            states.gains, idx, bundles.counts, states.staleness,
            data_max=dm)).reshape(idx.shape)
        if not torch.equal(got, want):
            raise AssertionError(f"[fleet] score_candidates S={seeds}: not "
                                 f"bit-equal to the plain chain (max abs "
                                 f"err {_max_err(got, want):.3e})")
        return _max_err(got, want)
    _seed_axis_call(f"score_candidates {n}x{m} K={k}", call, seeds, plain,
                    [seeds * v for v in score_fused_work(n, m, k)])


def phase_fleet(cfg, dev, profile=False):
    """The fleet path.  ``CONFIG`` fcea + PDD, ``FLEET_ROUNDS`` rounds of
    ``run_fleet`` at S = 1, the reference's S = 4 and S = 8 (seeds 0-7) in
    turns 1, 4, 8, 8, 4, 1, each seed's world built once for the phase
    (``_world``); every seed of the S = 8 and S = 4 fleets
    against its own ``run_scanned``; the score and SIC calls at S = 8
    against their plain versions and S = 1; a round at S = 2 card against
    CPU.  Then the bench
    scale (4096 × 32, K = 8), 3 rounds at the reference's S = 2 and at
    S = 4, a seed of each against its own run, and the frontier score at
    S = 4 against its plain version and S = 1."""
    import dataclasses
    from repro_torch.core import engine
    spec = engine.EngineSpec()
    seeds = tuple(range(max(FLEET_SEEDS)))
    sizes = (1, REF_FLEET_SEEDS[0], FLEET_SEEDS[0])
    # the sizes in turns (the host's pace drifts within a run)
    runs = {size: [] for size in sizes}
    for size in sizes + sizes[::-1]:
        runs[size].append(_drive_fleet(cfg, spec, seeds[:size],
                                       FLEET_ROUNDS, dev, f"CONFIG S={size}"))
    steady = {size: [r[1] for r in rs] for size, rs in runs.items()}
    log("[fleet] CONFIG fcea-pdd s/round in turns "
        + ", ".join(f"S={z}" for z in sizes + sizes[::-1]) + ": "
        + "; ".join(f"S={z} " + ", ".join(f"{v:.4f}" for v in steady[z])
                    for z in sizes)
        + "; seed-rounds/s " + ", ".join(
            f"S={z} {2 * z / sum(steady[z]):.2f}" for z in sizes)
        + f"; S={sizes[-1]}/S=1 "
        f"{sum(steady[sizes[-1]]) / sum(steady[1]):.3f}x")
    fm, steady_s, final, _ = runs[len(seeds)][0]
    if profile:
        states, bundles, gens = final
        profile_device(lambda: engine.run_fleet(cfg, spec, states, bundles,
                                                1, gens),
                       f"one steady CONFIG fleet round S={len(seeds)}",
                       steady_s)
    own = {}
    _fleet_vs_own(cfg, spec, seeds, range(len(seeds)), fm, final[0], dev,
                  f"CONFIG S={len(seeds)}", own)
    fm4, _, final4, _ = runs[REF_FLEET_SEEDS[0]][0]
    _fleet_vs_own(cfg, spec, seeds, range(REF_FLEET_SEEDS[0]), fm4,
                  final4[0], dev, f"CONFIG S={REF_FLEET_SEEDS[0]}", own)
    states, bundles, gens = final
    _fleet_kernel_times(cfg, states, bundles, dev)
    two = slice(0, 2)
    _fleet_card_vs_cpu(cfg, spec, engine.select_seed(states, two),
                       engine.select_seed(bundles, two), gens[:2],
                       "CONFIG S=2")
    big = bench_config(cfg)
    k8 = dataclasses.replace(spec, candidates_k=8)
    for size, member in ((REF_FLEET_SEEDS[1], 1), (FLEET_SEEDS[1], 0)):
        label = f"4096x32 K=8 S={size}"
        fm, _, final, _ = _drive_fleet(big, k8, seeds[:size], 3, dev, label)
        _fleet_vs_own(big, k8, seeds[:size], [member], fm, final[0], dev,
                      label)
    _fleet_frontier_score(big, final[0], final[1], 8)


# ---------------------------------------------------------------------------
# Dynamic scenarios and the fpa/fca allocators
# ---------------------------------------------------------------------------

# the reference's sweep worlds (src/repro/sweeps/grid.py's defaults,
# benchmarks/bench_sweeps.py::bench_sweep_fleet) and the churny worlds of
# its sync/buffered A/B (benchmarks/bench_rounds.py::AB_SCENARIOS)
SWEEP_WORLDS = ("random_waypoint", "markov_dropout", "hetero_devices")
AB_WORLDS = ("flash_crowd", "markov_dropout")


def _scenario_config_round(cfg, dev, static_steady):
    """``HFLSimulation(CONFIG, scenario="full_dynamic")``, fcea + PDD, 5
    rounds beside the static ``[main]`` round; one round card vs CPU.
    Returns the run's launches (the scenario path's counts)."""
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    sim, rows, walls, stages, launches = _drive(
        cfg, "fcea", "pdd", 5, dev, scenario="full_dynamic")
    want = _want_launches(cfg, sim.spec, 5)
    if launches != want:
        raise AssertionError(f"[scenario] full_dynamic: launches {launches} "
                             f"!= expected {want}")
    _check_metrics(cfg, cfg.clients_per_edge, rows, m_c)
    steady = _report("scenario", "CONFIG full_dynamic fcea-pdd", rows, walls,
                     stages, launches)
    log(f"[scenario] CONFIG full_dynamic s/round {steady:.4f} against the "
        f"static [main] round {static_steady:.4f} in this run "
        f"({steady / static_steady:.3f}x)")
    card_vs_cpu(cfg, sim.spec, sim.state, sim.bundle, sim.generator,
                "CONFIG full_dynamic")
    return launches


OVERHEAD_TURNS = ("static", "dynamic", "dynamic", "static") * 2


def _scenario_overhead(cfg, dev):
    """The reference's ``bench_sweeps.bench_engine_overhead``: 256 × 8,
    gcea + fastest, static against ``full_dynamic``, 15 rounds a run, in
    ``OVERHEAD_TURNS``; ``dynamic_overhead_pct`` from each label's median
    steady s a round (the reference takes the median of 5 runs: its host
    jitter once gave a negative overhead)."""
    from repro_torch.core import engine
    big = bench_config(cfg, 256, 8)
    runs = {"static": (engine.EngineSpec(policy="gcea", scheduler="fastest"),
                       None),
            "dynamic": (engine.EngineSpec(policy="gcea", scheduler="fastest",
                                          scenario="dynamic"),
                        "full_dynamic")}
    steady = {label: [] for label in runs}
    for label in OVERHEAD_TURNS:
        spec, world = runs[label]
        steady[label].append(_run_spec(
            big, spec, 15, dev, f"256x8 {label} gcea-fastest",
            tag="scenario", scenario=world, per_round=False)[1])
    med = {k: statistics.median(v) for k, v in steady.items()}
    pct = 100.0 * (med["dynamic"] / med["static"] - 1.0)
    log(f"[scenario] 256x8 gcea-fastest s/round (rounds 2..15) in turns "
        f"{', '.join(OVERHEAD_TURNS)}: static "
        + ", ".join(f"{v:.5f}" for v in steady["static"]) + "; dynamic "
        + ", ".join(f"{v:.5f}" for v in steady["dynamic"])
        + f"; medians {med['static']:.5f}, {med['dynamic']:.5f}; "
        f"dynamic_overhead_pct {pct:.2f}")


def _scenario_fleet(cfg, dev):
    """The reference's sweep fleet: 256 × 8, fcea + PDD, kind "dynamic",
    the three sweep worlds × seeds 0-3 (S = 12) for 5 rounds, beside one
    seed's 5 rounds; one member of each world against its own run on the
    card."""
    from repro_torch.core import engine
    big = bench_config(cfg, 256, 8)
    spec = engine.EngineSpec(scenario="dynamic")
    one = _run_spec(big, spec, 5, dev, "256x8 random_waypoint S=1 fcea-pdd",
                    tag="scenario", scenario="random_waypoint",
                    per_round=False)[1]
    worlds = [w for w in SWEEP_WORLDS for _ in range(4)]
    seeds = [s for _ in SWEEP_WORLDS for s in range(4)]
    label = f"256x8 mixed worlds S={len(seeds)}"
    fm, steady_s, final, _ = _drive_fleet(big, spec, seeds, 5, dev, label,
                                          worlds)
    _fleet_vs_own(big, spec, seeds, [0, 5, 10], fm, final[0], dev, label,
                  worlds=worlds)
    log(f"[scenario] {label}: {steady_s:.4f} s/round, "
        f"{len(seeds) / steady_s:.2f} seed-rounds/s; one seed's round "
        f"(random_waypoint S=1) {one:.4f} s, {1.0 / one:.2f} seed-rounds/s; "
        f"S={len(seeds)}/S=1 round {steady_s / one:.3f}x")


def _scenario_sync_ab(cfg, dev):
    """The sync half of the reference's ``bench_rounds.async_ab``: 1024 ×
    16, gcea + fastest, 8 rounds of each churny world: wall s a round,
    simulated rounds a second (rounds / Σ total_time_s), n_available."""
    from repro_torch.core import engine
    big = bench_config(cfg, 1024, 16)
    for world in AB_WORLDS:
        spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                                 scenario="dynamic")
        rows, steady, _, _, _ = _run_spec(
            big, spec, 8, dev, f"1024x16 {world} gcea-fastest",
            tag="scenario", scenario=world, per_round=False)
        sim_s = sum(r.total_time_s for r in rows)
        log(f"[scenario] 1024x16 {world} sync: wall {steady:.4f} s/round; "
            f"{len(rows) / sim_s:.4f} simulated rounds/s "
            f"({len(rows)} rounds / {sim_s:.4f} s of Eq. 18 time); "
            f"n_available {[r.n_available for r in rows]}")


def _scenario_frontier(cfg, dev):
    """The frontier under mobility: 1024 × 16, K = 4, random_waypoint,
    fcea + PDD, 3 rounds; some client's frontier must change between
    rounds; one round card vs CPU."""
    from repro_torch.core import candidates, engine
    big = bench_config(cfg, 1024, 16)
    spec = engine.EngineSpec(candidates_k=4, scenario="dynamic")
    fronts = []

    def frontier(state):
        fronts.append(candidates.build_candidates(
            state.scenario.dist, 4,
            coverage_radius_m=engine.coverage_radius(big)).idx.cpu())
    state, bundle, gen = _run_spec(big, spec, 3, dev,
                                   "1024x16 K=4 random_waypoint fcea-pdd",
                                   tag="scenario",
                                   scenario="random_waypoint",
                                   on_round=frontier)[4]
    moved = [int((a != b).any(dim=-1).sum())
             for a, b in zip(fronts, fronts[1:])]
    if not all(moved):
        raise AssertionError(f"[scenario] 1024x16 K=4: no client's frontier "
                             f"changed in some round ({moved} changed)")
    log(f"[scenario] 1024x16 K=4 random_waypoint: clients whose frontier "
        f"changed, rounds 1..3: {moved}")
    card_vs_cpu(big, spec, state, bundle, gen, "1024x16 K=4 random_waypoint")


@contextlib.contextmanager
def _recording_grid():
    """Record every ``env.grid_best_action`` call the engine makes while
    the block runs: its inputs and the action it chose (no copy, no
    sync)."""
    from repro_torch.core import env
    calls, real = [], env.grid_best_action

    def record(cfg, params, gains, **kw):
        action = real(cfg, params, gains, **kw)
        calls.append((params, gains, kw, action))
        return action
    env.grid_best_action = record
    try:
        yield calls
    finally:
        env.grid_best_action = real


def _scenario_grid(cfg, dev):
    """fpa and fca at ``CONFIG`` on hetero_devices, fcea + PDD, 3 rounds
    each (two SIC calls a round: the grid's and the bill's).  The action
    each timed round's grid chose is held against the same grid on the
    CPU, on that round's own inputs, exactly; so are those inputs billed
    with time weighted 100:1 over energy, where the best point lies inside
    the grid.  The fca grid's (16, N, M) SIC call goes against its plain
    version; one round card vs CPU."""
    import dataclasses
    import torch
    from repro_torch.core import engine, env, noma
    from repro_torch.kernels import hfl_ops
    cpu = torch.device("cpu")
    timed = dataclasses.replace(cfg, lambda_t=1.0, lambda_e=0.01)
    fracs = env.grid_fractions(16, cpu).tolist()
    for allocator in ("fpa", "fca"):
        spec = engine.EngineSpec(allocator=allocator, scenario="dynamic")
        label = f"CONFIG hetero_devices {allocator} fcea-pdd"
        with _recording_grid() as calls:
            _, _, _, launches, final = _run_spec(cfg, spec, 3, dev, label,
                                                 tag="scenario",
                                                 scenario="hetero_devices")
        log(f"[scenario] {label}: {launches['sic_rates'] / 3:.0f} sic_rates "
            f"launches a round (the grid's G = 16 points folded into one "
            f"call, and the bill's)")
        if len(calls) != 3:
            raise AssertionError(f"[scenario] {label}: {len(calls)} grid "
                                 f"calls in 3 rounds")
        axis = 0 if allocator == "fpa" else 1
        picks = {}
        for weights, c in (("paper", cfg), ("time 100:1", timed)):
            idx = []
            for r, (params, gains, kw, chosen) in enumerate(calls, 1):
                a_gpu = chosen if c is cfg else env.grid_best_action(
                    c, params, gains, **kw)
                a_cpu = env.grid_best_action(c, _to(params, cpu),
                                             _to(gains, cpu), **kw)
                if not torch.equal(a_gpu.cpu(), a_cpu):
                    raise AssertionError(
                        f"[scenario] {label} round {r} ({weights} "
                        f"weights): the grid's action differs on the card "
                        f"and the CPU")
                idx.append(fracs.index(float(a_cpu[0, 1 - axis, 0])))
            picks[weights] = idx
        if not any(i > 0 for v in picks.values() for i in v):
            raise AssertionError(f"[scenario] {label}: every grid pick is "
                                 f"point 0 ({picks}); the grid's fold and "
                                 f"argmin are not exercised")
        log(f"[card-vs-cpu] {label}: each timed round's grid action exact "
            f"on its own inputs; grid point chosen, rounds 1..3: "
            + "; ".join(f"{k} weights {v}" for k, v in picks.items()))
        state, bundle, gen = final
        card_vs_cpu(cfg, spec, state, bundle, gen, label)
        if allocator == "fca":
            # the last timed round's own grid SIC call: 16 power rows at
            # the caps, on that round's association and gains
            params, gains, _, _ = calls[-1]
            g = env.grid_fractions(16, dev)
            act = torch.ones((16, 2, cfg.n_clients), device=dev)
            act[:, 0, :] = g[:, None]
            p, _ = env.env_decode_action(cfg, params, act)
            gains = gains.expand(16, -1, -1).contiguous()
            mask = (params.assoc > 0).expand(16, -1, -1).contiguous()
            kw = dict(bandwidth_hz=cfg.bandwidth_hz,
                      noise_w=noma.noise_power_w(cfg.noise_dbm_per_hz,
                                                 cfg.bandwidth_hz))
            got = hfl_ops.sic_rates(p, gains, mask, **kw)
            want = hfl_ops.sic_rates_plain(p, gains, mask, **kw)
            tol = TOL["sic_rates"]
            _check_close(f"[scenario] fca grid sic_rates (16, "
                         f"{cfg.n_clients}, {cfg.n_edges})", got, want,
                         tol["rtol"], float(want.abs().max())
                         * tol["atol_frac"])
            ms_k = time_ms(lambda: hfl_ops.sic_rates(p, gains, mask, **kw))
            ms_dev = graph_ms(lambda: hfl_ops.sic_rates(p, gains, mask, **kw))
            ms_p = time_ms(lambda: hfl_ops.sic_rates_plain(p, gains, mask,
                                                           **kw))
            work = [sum(v) for v in zip(*(sic_work(mask[i])
                                          for i in range(16)))]
            b_ms, b_by = bound_ms(*work)
            log(f"[scenario] fca grid sic_rates (16, {cfg.n_clients}, "
                f"{cfg.n_edges}) against plain: max_abs_err "
                f"{_max_err(got, want):.3e}; kernel {ms_k:.4f} ms (device "
                f"{ms_dev:.4f} ms by graph replay), plain {ms_p:.4f} ms, "
                f"bound {b_ms:.6f} ms ({b_by})")


def _scenario_all_dropped(cfg, dev):
    """Every client dropped (p_drop 1, p_return 0) at ``CONFIG``, gcea +
    fastest, one round on the card: nothing available or associated, the
    global model unchanged bit for bit, a finite bill."""
    import torch
    from repro_torch import scenarios
    from repro_torch.core.hfl import HFLSimulation
    from repro_torch.kernels import hfl_ops
    sim = HFLSimulation(cfg, seed=0, policy="gcea", scheduler="fastest",
                        scenario=scenarios.ScenarioSpec(
                            kind="markov_dropout", p_drop=1.0,
                            p_return=0.0), device=dev)
    before = {k: v.clone() for k, v in sim.state.global_params.items()}
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    m = sim.run_round()
    torch.cuda.synchronize()
    launches = dict(hfl_ops.LAUNCHES)
    want = _want_launches(cfg, sim.spec, 1)
    if launches != want:
        raise AssertionError(f"[scenario] all dropped: launches {launches} "
                             f"!= expected {want}")
    same = all(torch.equal(sim.state.global_params[k], v)
               for k, v in before.items())
    if not (m.n_available == m.n_associated == 0 and same
            and math.isfinite(m.cost)):
        raise AssertionError(f"[scenario] all dropped: {m}; global model "
                             f"unchanged: {same}")
    log(f"[scenario] CONFIG all clients dropped, gcea-fastest: n_available "
        f"0, n_associated 0, global model bit-equal, cost {m.cost:.5f} "
        f"finite; launches {launches}: ok")


def phase_scenario(cfg, dev, static_steady):
    """The dynamic-scenario path and the fpa/fca allocators, each run with
    the launch counters zeroed just before and read just after.  Returns
    the ``CONFIG`` full_dynamic run's launches."""
    launches = _scenario_config_round(cfg, dev, static_steady)
    _scenario_overhead(cfg, dev)
    _scenario_fleet(cfg, dev)
    _scenario_sync_ab(cfg, dev)
    _scenario_frontier(cfg, dev)
    _scenario_grid(cfg, dev)
    _scenario_all_dropped(cfg, dev)
    return launches


# ---------------------------------------------------------------------------
# The DDPG allocator (paper §IV-C, Algorithm 2)
# ---------------------------------------------------------------------------

# card (kernels, cuBLAS) against CPU (plain versions) training from the
# same weights and draws, CONFIG static, 2 × 40 slots, warmup 16, hidden
# 64 (65 updates); each side's gap to a float64 CPU run is printed beside.
# Measured on an H100 80GB HBM3: networks 7.5e-8 apart (abs), history
# 1.3e-7 (rel), and each side 1.9e-7 from float64 -- ulp-level sums in
# other orders, no near-zero gradient flipping sign under Adam
DDPG_TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)


def _ddpg_counts(label, launches, slots, score):
    """Training makes one SIC call a slot (the env's bill, every seed in
    one call), ``score`` fused-score calls (the fcea association snapshot
    the MDP starts from) and no SGD launch."""
    want = {"score_rows": 0, "score_matrix": score, "score_candidates": 0,
            "sic_rates": slots, "local_sgd_step": 0,
            "local_sgd_step_cluster": 0}
    if launches != want:
        raise AssertionError(f"[ddpg] {label}: launches {launches} != "
                             f"expected {want}")


def _finite_history(label, hist):
    import torch
    for k, v in hist.items():
        if not bool(torch.isfinite(torch.as_tensor(v)).all()):
            raise AssertionError(f"[ddpg] {label}: non-finite {k} {v}")


def _ddpg_paper_default(cfg, dev, static_steady):
    """``HFLSimulation(CONFIG, allocator="ddpg").train_ddpg()`` at the
    paper's defaults with the launch counters zeroed just before and read
    just after; 3 deployed fcea + PDD rounds (a ``mid`` round's launches);
    one deployed round card vs CPU.  Returns (sim, launches)."""
    import torch
    from repro_torch.core.hfl import HFLSimulation
    from repro_torch.kernels import hfl_ops
    sim = HFLSimulation(cfg, seed=0, allocator="ddpg", device=dev)
    slots = 20 * 50
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    t0 = time.perf_counter()
    hist = sim.train_ddpg()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hfl_ops.LAUNCHES)
    _ddpg_counts("paper default", launches, slots, 1)
    _finite_history("paper default", hist)
    r = hist["episode_reward"]
    log(f"[ddpg] CONFIG train_ddpg() (20 x 50 slots, hidden 128, buffer "
        f"4096, batch 64, warmup 64): {wall:.3f} s, {slots / wall:.1f} env "
        f"steps/s; launches {launches}: {launches['sic_rates'] / slots:.0f} "
        f"sic_rates a slot; episode reward first {r[0]:.5f}, last "
        f"{r[-1]:.5f}, best {max(r):.5f} (episode {r.index(max(r)) + 1})")
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        rows.append(sim.run_round(timer=timer))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    deployed = dict(hfl_ops.LAUNCHES)
    want = _want_launches(cfg, sim.spec, 3)
    if deployed != want:
        raise AssertionError(f"[ddpg] deployed rounds: launches {deployed} "
                             f"!= a mid round's {want}")
    _check_metrics(cfg, cfg.clients_per_edge, rows, m_c)
    steady = _report("ddpg", "CONFIG deployed actor fcea-pdd", rows, walls,
                     timer.ms(), deployed)
    log(f"[ddpg] deployed round {steady:.4f} s against the mid [main] round "
        f"{static_steady:.4f} s of this run ({steady / static_steady:.3f}x)")
    card_vs_cpu(cfg, sim.spec, sim.state, sim.bundle, sim.generator,
                "CONFIG ddpg actor", actor=sim.agent.actor)
    return sim, launches


def _ddpg_bench_scale(cfg, dev):
    """The reference's ``benchmarks/bench_ddpg.py`` full run:
    ``_setup(64, 4)`` (full_dynamic, gcea + fastest), hidden 64, buffer
    1024, 10 × 40 slots, warmup 64, the (3N,) = 192 observation; twice
    from the same agent and draws (the first run pays the first calls)."""
    import dataclasses

    import torch
    from repro_torch.core import ddpg, engine
    from repro_torch.kernels import hfl_ops
    big = dataclasses.replace(cfg, n_clients=64, n_edges=4,
                              clients_per_edge=4, min_samples=60,
                              max_samples=120, hidden=16, input_dim=32)
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                             scenario="dynamic")
    state, bundle, _ = engine.init_simulation(big, seed=0, device=dev,
                                              scenario="full_dynamic")
    dcfg = ddpg.allocator_config(big, spec, hidden=64, buffer_size=1024)
    if dcfg.state_dim != 192:
        raise AssertionError(f"[ddpg] bench_ddpg observation {dcfg}")
    gen = torch.Generator(device=dev).manual_seed(0)
    agent0 = ddpg.init_ddpg(gen, dcfg)
    draws = ddpg.sample_ddpg_draws(big, dcfg, [gen], 10, 40).seed(0)
    walls, hists = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        hfl_ops.reset_launches()
        t0 = time.perf_counter()
        _, hist = ddpg.train_allocator(big, spec, state, bundle, dcfg, agent0,
                                       draws, warmup=64)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        _ddpg_counts("bench_ddpg scale", dict(hfl_ops.LAUNCHES), 400, 0)
        _finite_history("bench_ddpg scale", hist)
        hists.append(hist)
    same = all(torch.equal(hists[0][k], hists[1][k]) for k in hists[0])
    log(f"[ddpg] bench_ddpg scale (64 x 4 full_dynamic gcea, obs 192, "
        f"hidden 64, buffer 1024, 10 x 40 slots, warmup 64): run 1 "
        f"{walls[0]:.3f} s ({400 / walls[0]:.1f} env steps/s), run 2 "
        f"{walls[1]:.3f} s ({400 / walls[1]:.1f} env steps/s); 1 sic_rates "
        f"a slot; the two runs' histories bit-equal: {same}")


def _tree_gap(got, want):
    """Largest |got − want| over the tensor leaves of two trees (on the
    CPU, in float64)."""
    from repro_torch.core import engine
    gaps = []
    engine._map(lambda a, b: gaps.append(float(
        (a.cpu().double() - b.cpu().double()).abs().max())), got, want)
    return max(gaps)


def _ddpg_card_vs_cpu(cfg, dev):
    """Algorithm 2 on the card and on the CPU from the same weights and
    ``DDPGDraws`` (``CONFIG`` static, gcea, 2 × 40 slots, warmup 16,
    hidden 64): the history and the final networks at
    ``DDPG_TRAIN_TOL``, each side's gap to a float64 CPU run printed."""
    import torch
    from repro_torch.core import ddpg, engine
    cpu = torch.device("cpu")
    spec = engine.EngineSpec(policy="gcea", allocator="ddpg")
    state, bundle, _ = engine.init_simulation(cfg, seed=0, device=dev)
    dcfg = ddpg.allocator_config(cfg, spec, hidden=64)
    gen = torch.Generator().manual_seed(3)
    agent0 = ddpg.init_ddpg(gen, dcfg)
    draws = ddpg.sample_ddpg_draws(cfg, dcfg, [gen], 2, 40).seed(0)

    def run(to, f64=False):
        moved = lambda tree: engine._map(
            lambda t: t.to(to, torch.float64) if f64 and t.is_floating_point()
            else t.to(to), tree)
        return ddpg.train_allocator(cfg, spec, moved(state), moved(bundle),
                                    dcfg, moved(agent0), moved(draws),
                                    warmup=16)

    card, cpu32, cpu64 = run(dev), run(cpu), run(cpu, f64=True)
    nets = ("actor", "critic")
    gaps = {}
    for label, (agent, hist) in (("card", card), ("cpu", cpu32)):
        gaps[label] = (
            max(_tree_gap(getattr(agent, n), getattr(cpu64[0], n))
                for n in nets),
            max(float(((hist[k].cpu().double() - cpu64[1][k]).abs()
                       / cpu64[1][k].abs()).max()) for k in hist))
    net_gap = max(_tree_gap(getattr(card[0], n), getattr(cpu32[0], n))
                  for n in nets)
    hist_gap = max(float(((card[1][k].cpu() - cpu32[1][k]).abs()
                          / cpu32[1][k].abs()).max()) for k in cpu32[1])
    log(f"[ddpg] card vs CPU training (CONFIG static gcea, 2 x 40 slots, "
        f"warmup 16, hidden 64, 65 updates): networks max |card - cpu| "
        f"{net_gap:.3e}, history max rel {hist_gap:.3e}; against a float64 "
        f"CPU run: card networks {gaps['card'][0]:.3e} history "
        f"{gaps['card'][1]:.3e}, cpu networks {gaps['cpu'][0]:.3e} history "
        f"{gaps['cpu'][1]:.3e}")
    for n in nets:
        for k, want in getattr(cpu32[0], n).items():
            torch.testing.assert_close(getattr(card[0], n)[k].cpu(), want,
                                       **DDPG_TRAIN_TOL, msg=f"{n}/{k}")
    for k, want in cpu32[1].items():
        torch.testing.assert_close(card[1][k].cpu(), want, **DDPG_TRAIN_TOL,
                                   msg=k)
    if not torch.equal(card[0].step.cpu(), cpu32[0].step):
        raise AssertionError("[ddpg] card vs CPU: update counts differ")
    log(f"[ddpg] card vs CPU training within rtol "
        f"{DDPG_TRAIN_TOL['rtol']}, atol {DDPG_TRAIN_TOL['atol']}: ok")


def _ddpg_fleet(cfg, dev):
    """``train_allocator_fleet`` at S = 4 (seeds 0-3, ``CONFIG``
    full_dynamic, 10 × 40 slots, hidden 64): one SIC call a slot; member 0
    against its own ``train_allocator`` on its own slice of the draws, bit
    for bit (the networks' products run a seed at a time: a batched
    product's cuBLAS kernel depends on the batch's size); then
    ``run_fleet_actors`` 3 rounds, each member against its own
    ``run_scanned`` with its own actor."""
    import torch
    from repro_torch.core import ddpg, engine
    from repro_torch.kernels import hfl_ops
    seeds, worlds = (0, 1, 2, 3), ["full_dynamic"] * 4
    spec = engine.EngineSpec(scenario="dynamic", allocator="ddpg")
    states, bundles, _ = _fleet(cfg, seeds, dev, worlds)
    dcfg = ddpg.allocator_config(cfg, spec, hidden=64)
    gens = [torch.Generator(device=dev).manual_seed(100 + s) for s in seeds]
    agents0 = ddpg.stack_agents([ddpg.init_ddpg(g, dcfg) for g in gens])
    draws = ddpg.sample_ddpg_draws(cfg, dcfg, gens, 10, 40)
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    t0 = time.perf_counter()
    agents, hist = ddpg.train_allocator_fleet(cfg, spec, states, bundles,
                                              dcfg, agents0, draws, warmup=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _ddpg_counts("fleet S=4", dict(hfl_ops.LAUNCHES), 400, 1)
    _finite_history("fleet S=4", hist)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    own, own_h = ddpg.train_allocator(
        cfg, spec, engine.select_seed(states, 0),
        engine.select_seed(bundles, 0), dcfg,
        engine.select_seed(agents0, 0), draws.seed(0), warmup=64)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    log(f"[ddpg] fleet S=4 (CONFIG full_dynamic fcea, 10 x 40 slots, hidden "
        f"64): {wall:.3f} s, {4 * 400 / wall:.1f} seed-steps/s, 1 sic_rates "
        f"a slot; member 0 alone {wall1:.3f} s, {400 / wall1:.1f} "
        f"seed-steps/s; last episode rewards "
        + " ".join(f"{v:.5f}" for v in hist["episode_reward"][:, -1].tolist()))
    member = engine.select_seed(agents, 0)
    net_gap = max(_tree_gap(getattr(member, n), getattr(own, n))
                  for n in ("actor", "critic"))
    hist_gap = max(float(((hist[k][0] - own_h[k]).abs()
                          / own_h[k].abs()).max()) for k in own_h)
    log(f"[ddpg] fleet member 0 vs its own train_allocator: networks max "
        f"abs {net_gap:.3e}, history max rel {hist_gap:.3e}")
    if not (all(torch.equal(getattr(member, n)[k], want)
                for n in ("actor", "critic")
                for k, want in getattr(own, n).items())
            and all(torch.equal(hist[k][0], want)
                    for k, want in own_h.items())):
        raise AssertionError("[ddpg] fleet member 0 is not bit-equal to its "
                             "own train_allocator")
    label = "CONFIG full_dynamic ddpg actors S=4"
    fm, steady_s, final, _ = _drive_fleet(cfg, spec, seeds, 3, dev, label,
                                          worlds, actors=agents.actor)
    _fleet_vs_own(cfg, spec, seeds, range(len(seeds)), fm, final[0], dev,
                  label, worlds=worlds, actors=agents.actor)


def _ddpg_vs_baselines(cfg, sim, dev, slots=20):
    """``benchmarks/fig_ddpg_cost.py``'s comparison, printed and not gated:
    on the trained env's association, ``slots`` slots from the same fading
    draws, the mean Eq. 23a cost of the noise-free actor beside rra's,
    fpa's and fca's best actions."""
    import torch
    from repro_torch.core import ddpg, env
    m = cfg.n_edges
    e = env.NomaHflEnv(cfg, torch.tensor(sim._associate(), device=dev),
                       torch.ones(m, device=dev), sim.bundle.dist,
                       sim.bundle.counts)
    gen = torch.Generator(device=dev).manual_seed(7)
    exp1 = lambda shape: torch.empty(shape, device=dev).exponential_(
        generator=gen)
    reset, fading = exp1(e.params.dist.shape), exp1(
        (slots,) + e.params.dist.shape)
    u = torch.rand((slots, e.action_dim), generator=gen, device=dev)
    costs = {}
    for name in ("ddpg", "rra", "fpa", "fca"):
        st, obs = e.reset(reset)
        bills = []
        for t in range(slots):
            act = {"ddpg": lambda: ddpg.actor_apply(sim.agent.actor, obs),
                   "rra": lambda: env.rra_action(u[t]),
                   "fpa": lambda: env.fpa_best_action(e, st.gains),
                   "fca": lambda: env.fca_best_action(e, st.gains)}[name]()
            st, obs, _, rc = e.step(st, act, fading[t])
            bills.append(rc.cost)
        costs[name] = float(torch.stack(bills).mean())
    gain = {k: 100.0 * (1.0 - costs["ddpg"] / v) for k, v in costs.items()
            if k != "ddpg"}
    log(f"[ddpg] fig_ddpg_cost comparison on the trained env ({slots} "
        f"slots, same fading): mean Eq. 23a cost "
        + ", ".join(f"{k} {v:.5f}" for k, v in costs.items())
        + "; ddpg gain % " + ", ".join(f"vs {k} {v:.2f}"
                                        for k, v in gain.items()))


def _ddpg_profile(cfg, sim, dev, slots=20):
    """Device busy share of ``slots`` updating slots (warmup 1) at the
    paper's widths, on the trained simulation's MDP."""
    import torch
    from repro_torch.core import ddpg
    dcfg = sim.agent_cfg
    gen = torch.Generator(device=dev).manual_seed(11)
    agent0 = ddpg.init_ddpg(gen, dcfg)
    draws = ddpg.sample_ddpg_draws(cfg, dcfg, [gen], 1, slots).seed(0)
    run = lambda: ddpg.train_allocator(cfg, sim.spec, sim.state, sim.bundle,
                                       dcfg, agent0, draws, warmup=1)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    profile_device(run, f"{slots} updating DDPG slots (CONFIG, hidden 128)",
                   time.perf_counter() - t0)


def phase_ddpg(cfg, dev, static_steady, profile=False):
    """The DDPG allocator: Algorithm 2 at the paper's defaults and at the
    reference's ``bench_ddpg`` scale, card vs CPU training, the S = 4 fleet
    and its deployed rounds, and the paper's cost comparison; with
    ``profile``, the device's busy share over updating slots.  Returns the
    paper-default run's launches."""
    sim, launches = _ddpg_paper_default(cfg, dev, static_steady)
    if profile:
        _ddpg_profile(cfg, sim, dev)
    _ddpg_bench_scale(cfg, dev)
    _ddpg_card_vs_cpu(cfg, dev)
    _ddpg_fleet(cfg, dev)
    _ddpg_vs_baselines(cfg, sim, dev)
    return launches


# ---------------------------------------------------------------------------
# Telemetry (RoundTrace, spans, JSONL sinks)
# ---------------------------------------------------------------------------

# 1024 x 16 gcea + fastest runs in turns: the engine without the trace, with
# it, and with it teed to a JSONL file after every round
TELEMETRY_TURNS = ("off", "on", "tee", "tee", "on", "off") * 2
TELEMETRY_ROUNDS = 20


def _same_tree(a, b) -> bool:
    """Two engine outputs (named tuples of tensors and host values) equal
    leaf for leaf, tensors bit for bit."""
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_same_tree(x, y) for x, y in zip(a, b))
    return a == b


def _check_trace(tag, cfg, spec, ms, tr):
    """The reference's trace invariants on a stacked trace: the three
    energy terms sum to the bill (rtol 1e-5), the time terms bound it, the
    SIC depth is the largest edge load within the quota, the histogram
    counts every client, PDD's iterations are its 1,200 (0 otherwise)."""
    import torch
    from repro_torch.core import engine
    energy = tr.energy_local_j + tr.energy_uplink_j + tr.energy_cloud_j
    tsum = tr.time_local_s + tr.time_uplink_s + tr.time_cloud_s
    iters = 1200 if spec.scheduler == "pdd" and spec.engine_mode == "sync" \
        else 0
    ok = (torch.allclose(energy, ms.total_energy_j, rtol=1e-5, atol=0.0)
          and bool(torch.all(tsum >= ms.total_time_s - 1e-5))
          and torch.equal(tr.sic_depth, tr.edge_load.amax(dim=-1))
          and bool(torch.all(tr.sic_depth <= engine.quota_for(cfg, spec)))
          and bool(torch.all(tr.stale_hist.sum(dim=-1) == cfg.n_clients))
          and bool(torch.all(tr.pdd_iters == iters)))
    if not ok:
        raise AssertionError(f"{tag}: the trace breaks an invariant: {tr}")


def _telemetry_config(cfg, dev):
    """``CONFIG`` fcea + PDD, 5 rounds without and with the trace from one
    state and one generator seed, each run with the launch counters zeroed
    just before and read just after: equal launches, metrics and final
    state bit-equal; the trace's invariants.  Returns the traced run's
    launches."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    state, bundle, _ = engine.init_simulation(cfg, seed=0, device=dev)
    runs = {}
    for on in (False, True):
        spec = engine.EngineSpec(telemetry=on)
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        hfl_ops.reset_launches()
        t0 = time.perf_counter()
        final, out = engine.run_scanned(cfg, spec, state, bundle, 5, gen)
        torch.cuda.synchronize()
        runs[on] = (final, out, dict(hfl_ops.LAUNCHES),
                    time.perf_counter() - t0)
    (f_off, m_off, l_off, w_off), (f_on, out, l_on, w_on) = \
        runs[False], runs[True]
    ms, tr = out
    if l_on != l_off or l_on != _want_launches(cfg, engine.EngineSpec(), 5):
        raise AssertionError(f"[telemetry] CONFIG launches with the trace "
                             f"{l_on} != without {l_off}")
    if not (_same_tree(ms, m_off) and _same_tree(f_on, f_off)):
        raise AssertionError("[telemetry] CONFIG: metrics or state with the "
                             "trace differ from the run without it")
    _check_trace("[telemetry] CONFIG fcea-pdd", cfg, engine.EngineSpec(), ms,
                 tr)
    log(f"[telemetry] CONFIG fcea-pdd 5 rounds: launches {l_on} with and "
        f"without the trace; metrics and final state bit-equal; wall "
        f"{w_off:.4f} s off, {w_on:.4f} s on (round 1 included)")
    for r in range(5):
        log(f"[telemetry] CONFIG round {int(tr.round[r])}: time local "
            f"{float(tr.time_local_s[r]):.5f} uplink "
            f"{float(tr.time_uplink_s[r]):.5f} cloud "
            f"{float(tr.time_cloud_s[r]):.5f} s; energy local "
            f"{float(tr.energy_local_j[r]):.5f} uplink "
            f"{float(tr.energy_uplink_j[r]):.5f} cloud "
            f"{float(tr.energy_cloud_j[r]):.5f} J; sweeps "
            f"{int(tr.assoc_sweeps[r])}; edge_load {tr.edge_load[r].tolist()}"
            f"; pdd residual {float(tr.pdd_residual[r]):.3e}; z_relaxed "
            f"{[round(v, 4) for v in tr.z_relaxed[r].tolist()]}; stale_hist "
            f"{tr.stale_hist[r].tolist()}")
    return l_on


def _telemetry_overhead(cfg, dev):
    """``telemetry_overhead_pct`` and the JSONL tee's at 1024 x 16 gcea +
    fastest: ``TELEMETRY_ROUNDS`` rounds a run from one state and
    generator seed, each mode warmed once, then in ``TELEMETRY_TURNS``;
    s a round (host clock around the run, ending in ``synchronize``), the
    overheads from each mode's median.  The last tee's file read back by
    ``load_jsonl`` equals the returned trace exactly."""
    import numpy as np
    import torch
    from repro_torch.core import engine
    from repro_torch.telemetry import sink
    big = bench_config(cfg, 1024, 16)
    state, bundle, _ = engine.init_simulation(big, seed=0, device=dev)
    specs = {"off": engine.EngineSpec(policy="gcea", scheduler="fastest"),
             "on": engine.EngineSpec(policy="gcea", scheduler="fastest",
                                     telemetry=True)}
    out_dir = ROOT / "build" / "telemetry"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "rounds.jsonl"
    last = {}

    def run(mode):
        gen = torch.Generator(device=dev).manual_seed(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "tee":
            path.unlink(missing_ok=True)
            with sink.JsonlSink(str(path)) as js:
                res = sink.stream_scanned(big, specs["on"], state, bundle,
                                          TELEMETRY_ROUNDS, js, gen)
        else:
            res = engine.run_scanned(big, specs[mode], state, bundle,
                                     TELEMETRY_ROUNDS, gen)
        torch.cuda.synchronize()
        last[mode] = res
        return (time.perf_counter() - t0) / TELEMETRY_ROUNDS

    for mode in ("off", "on", "tee"):
        run(mode)
    walls = {mode: [] for mode in specs}
    walls["tee"] = []
    for mode in TELEMETRY_TURNS:
        walls[mode].append(run(mode))
    med = {k: statistics.median(v) for k, v in walls.items()}
    tel_pct = 100.0 * (med["on"] / med["off"] - 1.0)
    tee_pct = 100.0 * (med["tee"] / med["off"] - 1.0)
    log(f"[telemetry] 1024x16 gcea-fastest s/round ({TELEMETRY_ROUNDS} "
        f"rounds a run) in turns {', '.join(TELEMETRY_TURNS)}: "
        + "; ".join(f"{k} " + ", ".join(f"{v:.5f}" for v in vs)
                    for k, vs in walls.items())
        + f"; medians off {med['off']:.5f}, on {med['on']:.5f}, tee "
        f"{med['tee']:.5f}; telemetry_overhead_pct {tel_pct:.2f}; "
        f"jsonl_tee_overhead_pct {tee_pct:.2f}")
    _, ms_off = last["off"]
    _, (ms_on, tr) = last["on"]
    _, ms_tee, tr_tee = last["tee"]
    if not (_same_tree(ms_on, ms_off) and _same_tree(ms_tee, ms_off)
            and _same_tree(tr_tee, tr)):
        raise AssertionError("[telemetry] 1024x16: the three modes' metrics "
                             "or traces differ")
    _check_trace("[telemetry] 1024x16", big, specs["on"], ms_on, tr)
    loaded = sink.load_jsonl(str(path))
    host = sink.host_trace(tr)
    for name in tr._fields:
        if not np.array_equal(loaded[name], getattr(host, name)):
            raise AssertionError(f"[telemetry] JSONL round trip: {name} "
                                 f"differs")
    log(f"[telemetry] JSONL round trip: {len(loaded['round'])} rounds, "
        f"{path.stat().st_size} bytes; every field of load_jsonl equal to "
        f"the returned trace: ok")


def _kernels_by_stage(path):
    """A Chrome trace's ``hfl/<stage>`` host ranges, and the CUDA kernels
    each range launched: a kernel's launch (the runtime call of its
    correlation id) lies inside the innermost range on the same thread."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    cat = lambda e: str(e.get("cat", "")).lower()          # noqa: E731
    ranges = [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0),
               e["name"][len("hfl/"):]) for e in events
              if e.get("ph") == "X" and cat(e) == "user_annotation"
              and str(e.get("name", "")).startswith("hfl/")]
    launch = {e["args"]["correlation"]: (e.get("tid"), e["ts"])
              for e in events if cat(e) in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    by_stage = {}
    for e in events:
        if cat(e) != "kernel":
            continue
        tid, ts = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        inner = [r for r in ranges if ts is not None and r[0] == tid
                 and r[1] <= ts <= r[2] and r[3] != "run_scanned"]
        if inner:
            stage = min(inner, key=lambda r: r[2] - r[1])[3]
            by_stage.setdefault(stage, []).append(e["name"])
    cats = {}
    for e in events:
        cats[cat(e)] = cats.get(cat(e), 0) + 1
    return {r[3] for r in ranges}, by_stage, cats


def _telemetry_profile(cfg, dev):
    """``spans.profile_scanned`` of 2 ``CONFIG`` fcea + fastest rounds: its
    Chrome trace holds the five stage ranges, and under associate,
    schedule and train the fused score, the SIC and the SGD kernels."""
    from repro_torch.core import engine
    from repro_torch.telemetry import spans
    spec = engine.EngineSpec(policy="fcea", scheduler="fastest")
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    path = spans.profile_scanned(cfg, spec, state, bundle, 2,
                                 str(ROOT / "build" / "profile"),
                                 aux["generator"])
    names, by_stage, cats = _kernels_by_stage(path)
    want_kernels = {"associate": "score_fused_kernel",
                    "schedule": "sic_cluster_kernel",
                    "train": "sgd_cluster_kernel"}
    missing = [s for s in spans.STAGES if s not in names]
    absent = [s for s, k in want_kernels.items()
              if not any(k in name for name in by_stage.get(s, ()))]
    if missing or absent or not all(by_stage.get(s) for s in spans.STAGES):
        raise AssertionError(f"[telemetry] profile: stage ranges missing "
                             f"{missing}; expected kernels absent under "
                             f"{absent}; kernels by stage "
                             f"{ {k: len(v) for k, v in by_stage.items()} }; "
                             f"event categories {cats}")
    log(f"[telemetry] profile_scanned 2 CONFIG fcea-fastest rounds "
        f"({time.perf_counter() - t0:.2f} s, {Path(path).stat().st_size} "
        f"bytes): ranges {sorted(names)}; kernels under each stage "
        + "; ".join(f"{s} {len(by_stage[s])} ("
                    + ", ".join(sorted({k[:40] for k in by_stage[s]
                                        if 'hfl' in k or 'kernel' in k})[:4])
                    + ")" for s in spans.STAGES))


def phase_telemetry(cfg, dev):
    """The trace on the sync round: ``CONFIG`` on vs off, the overheads at
    1024 x 16, the JSONL round trip and the profiler ranges.  Returns the
    traced ``CONFIG`` run's launches."""
    launches = _telemetry_config(cfg, dev)
    _telemetry_overhead(cfg, dev)
    _telemetry_profile(cfg, dev)
    return launches


# ---------------------------------------------------------------------------
# The buffered engine (FedBuff micro-steps with TiFL tiers)
# ---------------------------------------------------------------------------

BUFFER_INTS = ("in_flight", "tier", "pulled_ver", "fill", "version", "step")
BUFFER_FLOATS = ("finish_s", "obs_s", "weight_sum", "clock_s", "last_agg_s")


def _first_tensor(obj):
    import torch
    if isinstance(obj, torch.Tensor):
        return obj
    for item in (obj.values() if isinstance(obj, dict)
                 else obj if isinstance(obj, (tuple, list)) else ()):
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


@contextlib.contextmanager
def _recording_kernels():
    """Record the arguments of every HFL kernel wrapper call the engine
    makes on the card while the block runs (no copy, no sync); a call on
    CPU tensors (the plain version, no launch) is not recorded."""
    from repro_torch.kernels import hfl_ops
    names = ("score_matrix", "score_candidates", "sic_rates",
             "local_sgd_step")
    calls = {name: [] for name in names}
    real = {name: getattr(hfl_ops, name) for name in names}

    def recorder(name):
        def call(*a, **kw):
            if _first_tensor(a).is_cuda:
                calls[name].append((a, kw))
            return real[name](*a, **kw)
        return call
    for name in names:
        setattr(hfl_ops, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(hfl_ops, name, fn)


def _hold_recorded(label, calls, launches):
    """Every recorded kernel call against its plain version on the same
    inputs: the fused scores bit for bit, the SIC and the SGD at the CPU
    tests' tolerances.  ``label`` opens each line (``"[phase] run"``).
    ``launches``: the counters of the recorded run, zeroed just before
    it.  Every wrapper must have been recorded exactly as often as its
    kernel launched, and no other kernel may have launched
    (``local_sgd_step_cluster`` counts the cluster route of
    ``local_sgd_step``'s launches), so no launch of the run goes
    unheld."""
    import torch
    from repro_torch.core import fuzzy
    from repro_torch.kernels import hfl_ops
    from repro_torch.models.mlp import PARAM_KEYS
    recorded = {name: len(rec) for name, rec in calls.items()}
    launched = {name: launches[name] for name in calls}
    unrecorded = {name: n for name, n in launches.items()
                  if n and name not in calls
                  and name != "local_sgd_step_cluster"}
    if recorded != launched or unrecorded or not any(recorded.values()):
        raise AssertionError(f"{label}: recorded wrapper calls "
                             f"{recorded} against launches {launches}: a "
                             f"launch was made past the recorded wrappers")
    worst = {}
    for name, call, (a, kw) in [(name, i, rec) for name, recs in
                                calls.items() for i, rec in enumerate(recs)]:
        got = getattr(hfl_ops, name)(*a, **kw)
        if name == "score_matrix":
            want = fuzzy.score_matrix(*a, **kw, rows=hfl_ops.score_rows_plain)
            ok, err = torch.equal(got, want), _max_err(got, want)
        elif name == "score_candidates":
            gains, idx, counts, stale = a
            want = hfl_ops.score_rows_plain(*fuzzy.candidate_inputs(
                gains, idx, counts, stale, **kw)).reshape(idx.shape)
            ok, err = torch.equal(got, want), _max_err(got, want)
        elif name == "sic_rates":
            want = hfl_ops.sic_rates_plain(*a, **kw)
            tol = TOL["sic_rates"]
            err = _max_err(got, want)
            ok = torch.allclose(got, want, rtol=tol["rtol"],
                                atol=float(want.abs().max())
                                * tol["atol_frac"])
        else:
            want = hfl_ops.local_sgd_step_plain(*a, lr=kw["lr"])
            err = max(_max_err(got[k], want[k]) for k in PARAM_KEYS)
            ok = all(torch.allclose(got[k], want[k], **TOL["local_sgd_step"])
                     for k in PARAM_KEYS)
        shape = tuple(a[1 if name in ("sic_rates", "local_sgd_step")
                        else 0].shape)
        if not ok:
            raise AssertionError(f"{label} {name} call {call} {shape}: "
                                 f"kernel disagrees with its plain version "
                                 f"on the run's own inputs (max abs err "
                                 f"{err:.3e})")
        n, e, _ = worst.get(name, (0, 0.0, shape))
        worst[name] = (n + 1, max(e, err), shape)
    log(f"{label}: every kernel call of the run against its plain version "
        f"on its own inputs: " + "; ".join(
            f"{name} {shape} x{n} max_abs_err {e:.3e}"
            for name, (n, e, shape) in worst.items()) + ": ok")


def _drive_buffered(cfg, spec, steps, dev, label, scenario=None):
    """``steps`` micro-steps of ``spec`` from ``init_simulation`` (in
    ``scenario``), fresh draws each, with every launch counter zeroed just
    before and read just after (one score call, one SIC call and τ₂ SGD
    launches a micro-step, as a sync round); checks the metrics and the
    buffer, prints the summary and the stage spans; then one more
    micro-step with its kernel calls recorded and held against their
    plain versions.  Returns (launches, steady s a micro-step, the final
    state, bundle and generator)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.hfl import RoundMetrics
    from repro_torch.kernels import hfl_ops
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev,
                                                scenario=scenario)
    gen = aux["generator"]
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        draws = engine.sample_draws(cfg, bundle, gen, spec)
        state, m = engine.round_step(cfg, spec, state, bundle, draws,
                                     timer=timer)
        rows.append(RoundMetrics.from_engine(m))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(hfl_ops.LAUNCHES)
    want = _want_launches(cfg, spec, steps)
    if launches != want:
        raise AssertionError(f"[buffered] {label}: launches {launches} != "
                             f"expected {want}")
    buf = state.buffer
    merges = sum(int(r.z[0] > 0) for r in rows)
    cap = engine.quota_for(cfg, spec) * cfg.n_edges
    for r in rows:
        vals = [r.accuracy, r.loss, r.avg_staleness, r.total_time_s,
                r.total_energy_j, r.cost]
        if not (all(math.isfinite(v) for v in vals) and r.total_time_s >= 0
                and r.n_associated <= min(cap, r.n_available)):
            raise AssertionError(f"[buffered] {label} micro-step {r.round}: "
                                 f"{r}")
    if not (int(buf.step) == steps and int(buf.version) == merges
            and bool(((buf.tier >= 0) & (buf.tier < spec.n_tiers)).all())):
        raise AssertionError(f"[buffered] {label}: buffer step "
                             f"{int(buf.step)}, version {int(buf.version)} "
                             f"for {merges} merges, tiers "
                             f"{buf.tier.tolist()}")
    steady = walls[1:] or walls
    steady_s = sum(steady) / len(steady)
    clock = float(buf.clock_s)
    log(f"[buffered] {label}: {steps} micro-steps, launches {launches}; "
        f"s/micro-step {steady_s:.5f} (steps 2..{steps}; step 1 "
        f"{walls[0]:.4f}), {1.0 / steady_s:.2f} micro-steps/s; {merges} "
        f"merges in {clock:.4f} virtual s ({merges / clock:.4f} merges a "
        f"virtual s); n_assoc a step "
        f"{statistics.mean(r.n_associated for r in rows):.2f}, final "
        f"accuracy {rows[-1].accuracy:.4f}")
    for name, spans in timer.ms().items():
        tail = spans[1:] or spans
        log(f"[stage] buffered {label} {name:<9} "
            f"{sum(tail) / len(tail):.4f} ms/micro-step (steps 2..{steps}; "
            f"step 1 {spans[0]:.4f})")
    with _recording_kernels() as calls:
        draws = engine.sample_draws(cfg, bundle, gen, spec)
        hfl_ops.reset_launches()
        state, _ = engine.round_step(cfg, spec, state, bundle, draws)
        recorded_launches = dict(hfl_ops.LAUNCHES)
    _hold_recorded(f"[buffered] {label}", calls, recorded_launches)
    return launches, steady_s, (state, bundle, gen)


def _ulps(a: float, b: float) -> float:
    """|a - b| in float32 ulps of the larger magnitude."""
    import numpy as np
    return abs(a - b) / float(np.spacing(np.float32(max(abs(a), abs(b)))))


def _near_ties(s_gpu, s_cpu):
    """On a disagreement of the buffer's integers: for each client whose
    landing or tier differs, its finish time beside the clock and its
    duration EMA on both sides, with their gaps in ulps."""
    import torch
    lines = []
    gpu, bc = _to(s_gpu.buffer, torch.device("cpu")), s_cpu.buffer
    for i in torch.nonzero((gpu.in_flight != bc.in_flight)
                           | (gpu.tier != bc.tier)).flatten().tolist():
        fg, fc = float(gpu.finish_s[i]), float(bc.finish_s[i])
        og, oc = float(gpu.obs_s[i]), float(bc.obs_s[i])
        lines.append(f"client {i}: finish card {fg!r} cpu {fc!r} "
                     f"({_ulps(fg, fc):.1f} ulp), clock card "
                     f"{float(gpu.clock_s)!r} cpu {float(bc.clock_s)!r}; obs "
                     f"card {og!r} cpu {oc!r} ({_ulps(og, oc):.1f} ulp); "
                     f"in_flight {bool(gpu.in_flight[i])}/"
                     f"{bool(bc.in_flight[i])}, tier {int(gpu.tier[i])}/"
                     f"{int(bc.tier[i])}")
    return lines


def _buffered_card_vs_cpu(cfg, spec, state, bundle, gen, label, steps=8):
    """``steps`` micro-steps from one state and the same draws on the card
    and on the CPU (plain versions): the buffer's integers, z,
    n_associated, n_available, sweeps and staleness (and, under faults,
    every ``FaultState`` leaf) exact each step; the
    clock, finish times, EMA and weights rtol 1e-5; the bill rtol 1e-5
    (time and cost also within 1e-5 of the clock: the time charge is a
    difference of two clock readings); loss rtol 1e-4, accuracy 2 test
    samples."""
    import torch
    from repro_torch.core import engine
    cpu = torch.device("cpu")
    s_g, s_c = state, _to(state, cpu)
    n_test = bundle.test_y.shape[0]
    worst = {}
    for i in range(steps):
        draws = engine.sample_draws(cfg, bundle, gen, spec)
        s_g, m_g = engine.round_step(cfg, spec, s_g, bundle, draws)
        s_c, m_c = engine.round_step(cfg, spec, s_c, _to(bundle, cpu),
                                     _to(draws, cpu))
        g, c = engine.metrics_row(m_g), engine.metrics_row(m_c)
        bg, bc = _to(s_g.buffer, cpu), s_c.buffer
        exact = (g["z"].tolist() == c["z"].tolist()
                 and all(g[k] == c[k] for k in ("n_associated", "n_available",
                                                "sweeps"))
                 and torch.equal(s_g.staleness.cpu(), s_c.staleness)
                 and all(torch.equal(getattr(bg, k), getattr(bc, k))
                         for k in BUFFER_INTS)
                 and _same_faults(s_g.faults, s_c.faults))
        if not exact:
            for line in _near_ties(s_g, s_c):
                log(f"[card-vs-cpu] buffered {label} step {i + 1}: {line}")
            raise AssertionError(f"[card-vs-cpu] buffered {label} step "
                                 f"{i + 1}: card and CPU disagree on a "
                                 f"decision, the buffer's integers or the "
                                 f"fault state: {g} {c} {s_g.faults} "
                                 f"{s_c.faults}")
        clock = float(bc.clock_s)
        for k in BUFFER_FLOATS:
            a, b = getattr(bg, k), getattr(bc, k)
            if not torch.allclose(a, b, rtol=1e-5, atol=0.0):
                raise AssertionError(f"[card-vs-cpu] buffered {label} step "
                                     f"{i + 1} {k}: {a} vs {b}")
        for key, rtol, atol in (
                ("total_energy_j", 1e-5, 0.0), ("loss", 1e-4, 0.0),
                ("total_time_s", 1e-5, 1e-5 * clock),
                ("cost", 1e-5, 1e-5 * clock * cfg.lambda_t)):
            gap = abs(g[key] - c[key])
            worst[key] = max(worst.get(key, 0.0), gap / max(abs(c[key]),
                                                            1e-30))
            if gap > atol + rtol * abs(c[key]):
                raise AssertionError(f"[card-vs-cpu] buffered {label} step "
                                     f"{i + 1} {key}: {g[key]} vs {c[key]}")
        if abs(g["accuracy"] - c["accuracy"]) > 2.0 / n_test:
            raise AssertionError(f"[card-vs-cpu] buffered {label} step "
                                 f"{i + 1} accuracy: {g['accuracy']} vs "
                                 f"{c['accuracy']}")
    faults = ("" if s_g.faults is None else
              f"fault state ({', '.join(FAULT_LEAVES)}: final "
              f"{_fault_summary(s_g.faults)}), ")
    log(f"[card-vs-cpu] buffered {label}, {steps} micro-steps: buffer "
        f"integers ({', '.join(BUFFER_INTS)}), {faults}z, n_associated, "
        f"n_available, sweeps and staleness exact every step; clock, "
        f"finish, EMA and weights rtol 1e-5; largest relative bill gaps "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"; final clock {float(s_g.buffer.clock_s):.6f} s, version "
        f"{int(s_g.buffer.version)}: ok")


def _buffered_async_ab(cfg, dev):
    """The reference's ``bench_rounds.async_ab`` at 1024 x 16 (gcea +
    fastest) under ``AB_WORLDS``: 8 sync rounds against 64 micro-steps
    from one state, each warmed once and then timed twice, with the launch
    counters zeroed just before each timed run and read just after;
    virtual rates (sync: rounds / Σ Eq. 18 time; buffered: merges / the
    final clock) and wall rates."""
    import dataclasses
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    big = bench_config(cfg, 1024, 16)
    for world in AB_WORLDS:
        spec_s = engine.EngineSpec(policy="gcea", scheduler="fastest",
                                   scenario="dynamic")
        spec_b = dataclasses.replace(spec_s, engine_mode="buffered")
        state, bundle, _ = engine.init_simulation(big, seed=0, device=dev,
                                                  scenario=world)
        res = {}
        for label, spec, n in (("sync", spec_s, 8), ("buffered", spec_b, 64)):
            walls = []
            for timed in (False, True, True):
                gen = torch.Generator(device=dev).manual_seed(0)
                torch.cuda.synchronize()
                hfl_ops.reset_launches()
                t0 = time.perf_counter()
                final, ms = engine.run_scanned(big, spec, state, bundle, n,
                                               gen)
                torch.cuda.synchronize()
                if timed:
                    walls.append(time.perf_counter() - t0)
            launches = dict(hfl_ops.LAUNCHES)
            if launches != _want_launches(big, spec, n):
                raise AssertionError(f"[buffered] async_ab {world} {label}: "
                                     f"launches {launches}")
            res[label] = (final, ms, walls, launches)
        _, ms_s, walls_s, _ = res["sync"]
        fb, ms_b, walls_b, l_b = res["buffered"]
        sync_virtual = float(ms_s.total_time_s.sum())
        merges, virtual = int(fb.buffer.version), float(fb.buffer.clock_s)
        sync_vrps, buf_vrps = 8 / sync_virtual, merges / virtual
        log(f"[buffered] async_ab 1024x16 {world}: sync 8 rounds "
            f"{sync_virtual:.4f} virtual s ({sync_vrps:.4f} rounds a virtual "
            f"s), wall " + ", ".join(f"{8 / w:.2f}" for w in walls_s)
            + f" rounds/s; buffered 64 micro-steps {merges} merges in "
            f"{virtual:.4f} virtual s ({buf_vrps:.4f} merges a virtual s, "
            f"{buf_vrps / sync_vrps:.3f}x sync), wall "
            + ", ".join(f"{64 / w:.2f}" for w in walls_b)
            + f" micro-steps/s; launches {l_b}; n_available a micro-step "
            f"{float(ms_b.n_available.float().mean()):.1f}")


# FedBuff's buffer size and server step off their defaults (CONFIG's
# automatic fill is 8, its server step 1)
BUFFER_KNOBS = dict(buffer_fill=3, buffer_lr=0.5)


def _buffered_knobs(cfg, dev, default_launches):
    """``CONFIG`` fcea dense at ``BUFFER_KNOBS``: 64 micro-steps beside the
    default run's (the same launches, more merges at the smaller fill),
    then 8 micro-steps card vs CPU from its final state and the same
    draws (the buffer's integers and every decision exact)."""
    from repro_torch.core import engine
    spec = engine.EngineSpec(engine_mode="buffered", **BUFFER_KNOBS)
    if engine.buffer_fill_for(cfg, spec) != BUFFER_KNOBS["buffer_fill"]:
        raise AssertionError(f"[buffered] knobs: fill "
                             f"{engine.buffer_fill_for(cfg, spec)}")
    label = "CONFIG fcea dense fill 3 lr 0.5"
    launches, _, final = _drive_buffered(cfg, spec, 64, dev, label)
    if launches != default_launches:
        raise AssertionError(f"[buffered] {label}: launches {launches} != "
                             f"the default run's {default_launches}")
    _buffered_card_vs_cpu(cfg, spec, *final, label, steps=8)


def phase_buffered(cfg, dev, static_steady):
    """The buffered engine: ``CONFIG`` fcea dense, 64 micro-steps beside
    the sync ``[main]`` round; ``CONFIG`` K = 2, 8 micro-steps (the
    frontier's score); ``CONFIG`` at a buffer fill of 3 and a server step
    of 0.5 (``_buffered_knobs``); each run's kernel calls held against
    their plain versions; card vs CPU over 8 micro-steps; the reference's
    async A/B at 1024 x 16.  Returns the launches of the two default
    ``CONFIG`` runs."""
    from repro_torch.core import engine
    spec = engine.EngineSpec(engine_mode="buffered")
    launches, steady, (state, bundle, gen) = _drive_buffered(
        cfg, spec, 64, dev, "CONFIG fcea dense")
    log(f"[buffered] CONFIG fcea dense {1.0 / steady:.2f} micro-steps/s "
        f"against the sync [main] fcea-pdd {1.0 / static_steady:.3f} "
        f"rounds/s in this run ({static_steady / steady:.1f}x)")
    _buffered_card_vs_cpu(cfg, spec, state, bundle, gen, "CONFIG fcea dense")
    spec_k = engine.EngineSpec(engine_mode="buffered", candidates_k=2)
    launches_k, _, final_k = _drive_buffered(cfg, spec_k, 8, dev,
                                             "CONFIG fcea K=2")
    _buffered_card_vs_cpu(cfg, spec_k, *final_k, "CONFIG fcea K=2", steps=4)
    _buffered_knobs(cfg, dev, launches)
    _buffered_async_ab(cfg, dev)
    return {**launches,
            "score_candidates": launches_k["score_candidates"]}


# ---------------------------------------------------------------------------
# The fault layer (edge churn, SINR-tied uplink loss with retry/backoff,
# crashes, poisoning, quarantine) and the resumable driver
# ---------------------------------------------------------------------------

# the reference's chaos sweep cell (``sweeps/grid.py``'s fault cell) plus
# crashes and NaN poisoning
FAULT_CHAOS = dict(edge_p_kill=0.2, edge_p_respawn=0.5, uplink_p_loss=0.1,
                   uplink_loss_slope=0.2, client_p_crash=0.05, p_poison=0.1,
                   poison_nan=True)
FAULT_LEAVES = ("edge_up", "attempts", "n_retries", "n_dropped",
                "n_quarantined", "n_crashed")
FAULT_TURNS = ("off", "on", "on", "off")
FAULT_COST_ROUNDS = 10


def _same_faults(got, want):
    """Two ``FaultState``s (card, CPU) leaf for leaf, or both None."""
    import torch
    if got is None or want is None:
        return got is None and want is None
    return all(torch.equal(getattr(got, k).cpu(), getattr(want, k))
               for k in FAULT_LEAVES)


def _bit_equal(a, b):
    """Two tensors bit for bit, NaN payloads included (a poisoned delta in
    the carry is NaN, and NaN != NaN)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(bits[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def _fault_summary(flt):
    return (f"dead {int((flt.edge_up <= 0).sum())}, retries "
            f"{int(flt.n_retries)}, dropped {int(flt.n_dropped)}, "
            f"quarantined {int(flt.n_quarantined)}, crashed "
            f"{int(flt.n_crashed)}")


def _faults_sync_card_vs_cpu(cfg, spec, rounds, dev, label):
    """``rounds`` sync rounds of ``spec`` from ``init_simulation`` on the
    card and, from the same state and draws, on the CPU, with the launch
    counters zeroed just before and read just after and the card's kernel
    calls recorded: z, n_associated, sweeps, staleness and every
    ``FaultState`` leaf exact each round; cost, time and energy rtol 1e-5,
    the loss rtol 1e-4, the accuracy 2 test samples.  Then every recorded
    kernel call against its plain version.  Returns the launches."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    cpu = torch.device("cpu")
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev)
    gen = aux["generator"]
    s_g, s_c, b_c = state, _to(state, cpu), _to(bundle, cpu)
    n_test = bundle.test_y.shape[0]
    tag = f"[faults] {label}"
    worst, zs = {}, []
    with _recording_kernels() as calls:
        torch.cuda.synchronize()
        hfl_ops.reset_launches()
        for r in range(rounds):
            draws = engine.sample_draws(cfg, bundle, gen, spec)
            s_g, m_g = engine.round_step(cfg, spec, s_g, bundle, draws)
            s_c, m_c = engine.round_step(cfg, spec, s_c, b_c,
                                         _to(draws, cpu))
            g, c = engine.metrics_row(m_g), engine.metrics_row(m_c)
            if not (g["z"].tolist() == c["z"].tolist()
                    and all(g[k] == c[k] for k in ("n_associated",
                                                   "sweeps"))
                    and torch.equal(s_g.staleness.cpu(), s_c.staleness)
                    and _same_faults(s_g.faults, s_c.faults)):
                raise AssertionError(f"{tag} round {r + 1}: card and CPU "
                                     f"disagree: {g} {c} {s_g.faults} "
                                     f"{s_c.faults}")
            for key, rtol in (("cost", 1e-5), ("total_time_s", 1e-5),
                              ("total_energy_j", 1e-5), ("loss", 1e-4)):
                gap = abs(g[key] - c[key])
                worst[key] = max(worst.get(key, 0.0),
                                 gap / max(abs(c[key]), 1e-30))
                if gap > rtol * abs(c[key]):
                    raise AssertionError(f"{tag} round {r + 1} {key}: "
                                         f"{g[key]} vs {c[key]}")
            if abs(g["accuracy"] - c["accuracy"]) > 2.0 / n_test:
                raise AssertionError(f"{tag} round {r + 1} accuracy: "
                                     f"{g['accuracy']} vs {c['accuracy']}")
            zs.append(g["z"].tolist())
        torch.cuda.synchronize()
        launches = dict(hfl_ops.LAUNCHES)
    want = _want_launches(cfg, spec, rounds)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != expected "
                             f"{want}")
    log(f"{tag}, {rounds} rounds card vs CPU: z {zs}, n_associated, "
        f"sweeps, staleness and the fault state ({', '.join(FAULT_LEAVES)})"
        f" exact every round, final {_fault_summary(s_g.faults)}; largest "
        f"relative gaps " + ", ".join(f"{k} {v:.2e}"
                                      for k, v in worst.items())
        + f"; launches {launches}: ok")
    _hold_recorded(tag, calls, launches)
    return launches


def _faults_dead_edge_frontier(cfg, dev):
    """``CONFIG`` K = 2, fcea + PDD, 3 rounds with the churn frozen and
    edge 0 dead from the start: no client is admitted there and the trace
    counts one dead edge every round; every kernel call against its plain
    version.  Returns the launches."""
    import torch
    from repro_torch.core import engine
    from repro_torch.faults import FaultSpec
    from repro_torch.kernels import hfl_ops
    spec = engine.EngineSpec(candidates_k=2, telemetry=True,
                             faults=FaultSpec(edge_p_kill=0.0,
                                              edge_p_respawn=0.0))
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev)
    state = engine.ensure_carry(cfg, spec, state)
    up = torch.ones_like(state.faults.edge_up)
    up[0] = 0.0
    state = state._replace(faults=state.faults._replace(edge_up=up))
    with _recording_kernels() as calls:
        torch.cuda.synchronize()
        hfl_ops.reset_launches()
        state, (ms, tr) = engine.run_scanned(cfg, spec, state, bundle, 3,
                                             aux["generator"])
        torch.cuda.synchronize()
        launches = dict(hfl_ops.LAUNCHES)
    want = _want_launches(cfg, spec, 3)
    load, dead = tr.edge_load.cpu(), tr.dead_edges.cpu()
    if launches != want or not (bool((load[:, 0] == 0).all())
                                and bool((dead == 1).all())
                                and bool((ms.n_associated > 0).all())):
        raise AssertionError(f"[faults] K=2 dead edge 0: launches "
                             f"{launches} (expected {want}), edge_load "
                             f"{load.tolist()}, dead_edges {dead.tolist()}")
    log(f"[faults] CONFIG fcea-pdd K=2, edge 0 dead, churn frozen, 3 rounds:"
        f" edge_load {load.tolist()}, dead_edges {dead.tolist()}, orphaned "
        f"{tr.orphaned_clients.tolist()}, valid share "
        f"{[round(v, 4) for v in tr.frontier_valid_frac.tolist()]}, z "
        f"{ms.z.tolist()}; launches {launches}: ok")
    _hold_recorded("[faults] CONFIG K=2 dead edge", calls, launches)
    return launches


def _faults_buffered(cfg, spec, steps, dev):
    """``steps`` buffered micro-steps under ``spec`` card vs CPU
    (``_buffered_card_vs_cpu``, the fault state exact), with the card's
    kernel calls recorded and each held against its plain version."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev)
    with _recording_kernels() as calls:
        torch.cuda.synchronize()
        hfl_ops.reset_launches()
        _buffered_card_vs_cpu(cfg, spec, state, bundle, aux["generator"],
                              "CONFIG fcea dense chaos", steps=steps)
        torch.cuda.synchronize()
        launches = dict(hfl_ops.LAUNCHES)
    want = _want_launches(cfg, spec, steps)
    if launches != want:
        raise AssertionError(f"[faults] buffered chaos: launches "
                             f"{launches} != expected {want}")
    _hold_recorded("[faults] CONFIG buffered chaos", calls, launches)
    return launches


def _faults_cost(cfg, off, rounds, dev, label, profile=False):
    """The fault layer's cost on ``cfg``: seconds a round of ``off`` and
    of ``off`` under chaos in turns ``FAULT_TURNS`` after one warm run
    each, ``rounds`` rounds a run of ``_drive_spec`` (launches equal a
    round in both modes); the medians of rounds 2.. of each run, and of
    the runs.  With ``profile``, each mode's kernels in one profiled
    steady round."""
    import dataclasses
    from repro_torch.core import engine
    from repro_torch.faults import FaultSpec
    specs = {"off": off,
             "on": dataclasses.replace(off, faults=FaultSpec(**FAULT_CHAOS))}
    walls = {"off": [], "on": []}
    finals = {}
    for turn in ("off", "on") + FAULT_TURNS:     # one warm run each first
        _, per_round, _, launches, finals[turn] = _drive_spec(
            cfg, specs[turn], rounds, dev)
        if launches != _want_launches(cfg, specs[turn], rounds):
            raise AssertionError(f"[faults] cost {label} {turn}: launches "
                                 f"{launches}")
        walls[turn].append(statistics.median(per_round[1:]))
    med = {k: statistics.median(v[1:]) for k, v in walls.items()}
    pct = 100.0 * (med["on"] - med["off"]) / med["off"]
    log(f"[faults] cost {label}, {rounds} rounds a run in turns "
        f"{' '.join(FAULT_TURNS)}: s/round medians (rounds 2..) off "
        + ", ".join(f"{w:.6f}" for w in walls["off"][1:]) + "; on "
        + ", ".join(f"{w:.6f}" for w in walls["on"][1:])
        + f"; median off {med['off']:.6f} s, on {med['on']:.6f} s, fault "
        f"layer {1e3 * (med['on'] - med['off']):.4f} ms a round "
        f"({pct:.2f}%); launches a run {launches}; chaos final "
        f"{_fault_summary(finals['on'][0].faults)}")
    if profile:
        for turn in ("off", "on"):
            spec = specs[turn]
            s, bundle, gen = finals[turn]
            draws = engine.sample_draws(cfg, bundle, gen, spec)
            profile_device(lambda: engine.round_step(cfg, spec, s, bundle,
                                                     draws),
                           f"faults {turn} {label} round", med[turn])


def _faults_resume(cfg, dev):
    """``run_scanned_resumable`` on the card: ``CONFIG`` buffered, chaos,
    telemetry, 6 micro-steps in segments of 2 with a CUDA generator,
    stopped after one segment in a fresh directory under ``build/`` and
    resumed with a fresh generator; metrics, trace, the final carry and
    the generator's state bit-identical to an uninterrupted
    ``run_scanned``."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.core import engine
    from repro_torch.faults import FaultSpec, run_scanned_resumable
    spec = engine.EngineSpec(engine_mode="buffered", telemetry=True,
                             faults=FaultSpec(**FAULT_CHAOS))
    state, bundle, _ = engine.init_simulation(cfg, seed=0, device=dev)
    state = engine.ensure_carry(cfg, spec, state)
    gen_ref = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    ref, (ms, tr) = engine.run_scanned(cfg, spec, state, bundle, 6, gen_ref)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    directory = tempfile.mkdtemp(prefix="faults_resume_", dir=build)
    try:
        t0 = time.perf_counter()
        first = run_scanned_resumable(
            cfg, spec, state, bundle, 6,
            torch.Generator(device=dev).manual_seed(21),
            directory=directory, segment_rounds=2, max_segments=1)
        t_first = time.perf_counter() - t0
        if first.completed_rounds != 2 or store.latest_step(directory) != 2:
            raise AssertionError(f"[faults] resume: the first call ran "
                                 f"{first.completed_rounds} micro-steps")
        gen = torch.Generator(device=dev).manual_seed(999)
        t0 = time.perf_counter()
        res = run_scanned_resumable(cfg, spec, state, bundle, 6, gen,
                                    directory=directory, segment_rounds=2)
        t_rest = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in Path(directory).iterdir())
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    diverged = []

    def same(tag):
        def eq(a, b):
            if not _bit_equal(a, b):
                diverged.append(tag)
            return a
        return eq
    engine._map(same("metrics"), res.metrics, ms)
    engine._map(same("trace"), res.trace, tr)
    engine._map(same("carry"), res.state, ref)
    if not torch.equal(gen.get_state(), gen_ref.get_state()):
        diverged.append("generator")
    if diverged or not res.done or res.state.gains.device.type != "cuda":
        raise AssertionError(f"[faults] resume: the resumed run diverged "
                             f"from the uninterrupted one in "
                             f"{sorted(set(diverged))}")
    log(f"[faults] resume CONFIG buffered chaos telemetry, 6 micro-steps in "
        f"segments of 2 (CUDA generator): stopped after one segment, "
        f"resumed; metrics, trace, final carry and generator state "
        f"bit-identical to the uninterrupted run_scanned: ok; "
        f"uninterrupted {t_ref:.3f} s, first segment {t_first:.3f} s, "
        f"resume {t_rest:.3f} s, checkpoint files {size} bytes; final "
        f"{_fault_summary(res.state.faults)}")


def phase_faults(cfg, dev):
    """The fault layer on the card: ``CONFIG`` fcea + PDD dense under
    chaos, 5 rounds card vs CPU; ``CONFIG`` K = 2 with a dead edge, 3
    rounds; ``CONFIG`` fcea dense buffered under chaos, 16 micro-steps card
    vs CPU; every kernel call of the three held against its plain version;
    the fault layer's cost at 1024 x 16 gcea + fastest and at ``CONFIG``
    fcea + PDD; a resumed run bit-identical to an uninterrupted one.  Returns the launches of the faulted ``CONFIG``
    runs (the K = 2 run's for ``score_candidates``)."""
    from repro_torch.core import engine
    from repro_torch.faults import FaultSpec
    chaos = FaultSpec(**FAULT_CHAOS)
    launches = _faults_sync_card_vs_cpu(
        cfg, engine.EngineSpec(faults=chaos), 5, dev,
        "CONFIG fcea-pdd dense chaos")
    launches_k = _faults_dead_edge_frontier(cfg, dev)
    _faults_buffered(cfg, engine.EngineSpec(engine_mode="buffered",
                                            faults=chaos), 16, dev)
    _faults_cost(bench_config(cfg, 1024, 16),
                 engine.EngineSpec(policy="gcea", scheduler="fastest"),
                 FAULT_COST_ROUNDS, dev, "1024x16 gcea-fastest",
                 profile=True)
    _faults_cost(cfg, engine.EngineSpec(), 4, dev, "CONFIG fcea-pdd")
    _faults_resume(cfg, dev)
    return {**launches, "score_candidates": launches_k["score_candidates"]}


# ---------------------------------------------------------------------------
# The warm-started association and the sweep runner
# ---------------------------------------------------------------------------

WARM_WORLD = "random_waypoint"
WARM_TURNS = ("cold", "warm", "warm", "cold")


class _PieceClock:
    """Host seconds of each piece of a phase, printed on one line."""

    def __init__(self, tag):
        self.tag, self.parts = tag, []

    def __call__(self, name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        self.parts.append((name, time.perf_counter() - t0))
        return out

    def report(self):
        log(f"[{self.tag}] piece s: " + ", ".join(
            f"{name} {sec:.1f}" for name, sec in self.parts))


def _warm_cold_pair(cfg, spec_kw, steps, dev, label):
    """``steps`` rounds (micro-steps) of ``spec_kw`` under
    ``random_waypoint``, cold then warm, from one state and one generator
    state, telemetry on; the warm run with the launch counters zeroed just
    before and read just after and its kernel calls recorded.  Metrics and
    trace bit-equal but for the sweeps, the final carry bit-equal but for
    the seed; each round's sweeps printed.  Returns the warm run's
    launches and both runs' sweeps."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev,
                                                scenario=WARM_WORLD)
    start = aux["generator"].get_state()
    out = {}
    for warm in (False, True):
        spec = engine.EngineSpec(scenario="dynamic", telemetry=True,
                                 warm_start=warm, **spec_kw)
        gen = torch.Generator(device=dev).set_state(start)
        with (_recording_kernels() if warm
              else contextlib.nullcontext()) as calls:
            torch.cuda.synchronize()
            hfl_ops.reset_launches()
            final, (ms, tr) = engine.run_scanned(cfg, spec, state, bundle,
                                                 steps, gen)
            torch.cuda.synchronize()
            launches = dict(hfl_ops.LAUNCHES)
        out[warm] = (final, ms, tr, launches, calls, spec)
    (cf, cm, ct, cl, _, _), (wf, wm, wt, wl, calls, spec) = \
        out[False], out[True]
    sweeps = {"cold": cm.sweeps.tolist(), "warm": wm.sweeps.tolist()}
    diverged = [name for name in engine.RoundMetrics._fields
                if name != "sweeps"
                and not _same_tree(getattr(cm, name), getattr(wm, name))]
    diverged += [f"trace.{name}" for name in ct._fields
                 if name != "assoc_sweeps"
                 and not _same_tree(getattr(ct, name), getattr(wt, name))]
    diverged += [f"state.{name}" for name in engine.RoundState._fields
                 if name != "warm"
                 and not _same_tree(getattr(cf, name), getattr(wf, name))]
    if not _same_tree(wt.assoc_sweeps.cpu(), wm.sweeps.to(torch.int32)):
        diverged.append("trace.assoc_sweeps != metrics.sweeps")
    want = _want_launches(cfg, spec, steps)
    if diverged or wl != want or cl != want or cf.warm is not None \
            or wf.warm is None or wf.warm.device.type != "cuda":
        raise AssertionError(f"[warm] {label}: warm and cold runs differ "
                             f"in {diverged}; launches warm {wl}, cold "
                             f"{cl}, expected {want}")
    log(f"[warm] {label}, {steps} steps warm vs cold from one generator "
        f"state: metrics, trace, params, staleness and the rest of the "
        f"carry bit-equal: ok; sweeps a step cold {sweeps['cold']}, warm "
        f"{sweeps['warm']}; launches {wl}")
    _hold_recorded(f"[warm] {label}", calls, wl)
    return wl, sweeps


def _warm_card_vs_cpu(cfg, rounds, dev):
    """``CONFIG`` fcea + PDD dense warm under ``random_waypoint``,
    ``rounds`` rounds on the card and, from the same state and draws, on
    the CPU: z, n_associated, n_available, sweeps, staleness and the warm
    leaf exact each round; the bill at ``_check_bill``'s tolerances."""
    import torch
    from repro_torch.core import engine
    cpu = torch.device("cpu")
    spec = engine.EngineSpec(scenario="dynamic", warm_start=True)
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev,
                                                scenario=WARM_WORLD)
    gen = aux["generator"]
    s_g, s_c, b_c = state, _to(state, cpu), _to(bundle, cpu)
    n_test = bundle.test_y.shape[0]
    worst, sweeps = {}, []
    for r in range(rounds):
        draws = engine.sample_draws(cfg, bundle, gen, spec)
        s_g, m_g = engine.round_step(cfg, spec, s_g, bundle, draws)
        s_c, m_c = engine.round_step(cfg, spec, s_c, b_c, _to(draws, cpu))
        g, c = engine.metrics_row(m_g), engine.metrics_row(m_c)
        tag = f"[card-vs-cpu] warm round {r + 1}"
        if not (g["z"].tolist() == c["z"].tolist()
                and all(g[k] == c[k] for k in ("n_associated", "n_available",
                                               "sweeps"))
                and torch.equal(s_g.staleness.cpu(), s_c.staleness)
                and torch.equal(s_g.warm.cpu(), s_c.warm)):
            raise AssertionError(f"{tag}: card and CPU disagree: {g} {c}")
        for key, v in _check_bill(tag, g, c, n_test).items():
            worst[key] = max(worst.get(key, 0.0), v)
        sweeps.append(g["sweeps"])
    log(f"[card-vs-cpu] CONFIG fcea-pdd dense warm, {rounds} rounds: z, "
        f"n_associated, n_available, sweeps {sweeps}, staleness and the "
        f"warm leaf exact every round; largest relative gaps "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + ": ok")


def _warm_resume(cfg, dev):
    """``run_scanned_resumable`` warm (``CONFIG`` fcea + PDD dense under
    ``random_waypoint``), 4 rounds in segments of 2 with a CUDA generator,
    stopped after one segment in a temporary directory under ``build/``
    and resumed with a fresh generator: metrics (sweeps included), the
    final carry with its warm leaf and the generator state bit-identical
    to an uninterrupted ``run_scanned``."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import engine
    from repro_torch.faults import run_scanned_resumable
    spec = engine.EngineSpec(scenario="dynamic", warm_start=True)
    state, bundle, _ = engine.init_simulation(cfg, seed=0, device=dev,
                                              scenario=WARM_WORLD)
    gen_ref = torch.Generator(device=dev).manual_seed(22)
    ref, ms = engine.run_scanned(cfg, spec, state, bundle, 4, gen_ref)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    directory = tempfile.mkdtemp(prefix="warm_resume_", dir=build)
    try:
        first = run_scanned_resumable(
            cfg, spec, state, bundle, 4,
            torch.Generator(device=dev).manual_seed(22),
            directory=directory, segment_rounds=2, max_segments=1)
        gen = torch.Generator(device=dev).manual_seed(999)
        res = run_scanned_resumable(cfg, spec, state, bundle, 4, gen,
                                    directory=directory, segment_rounds=2)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    cpu = torch.device("cpu")
    diverged = [tag for tag, a, b in (("metrics", res.metrics, ms),
                                      ("carry", res.state, ref))
                if not _same_tree(_to(a, cpu), _to(b, cpu))]
    if not torch.equal(gen.get_state(), gen_ref.get_state()):
        diverged.append("generator")
    if diverged or first.completed_rounds != 2 or not res.done \
            or res.state.warm.device.type != "cuda":
        raise AssertionError(f"[warm] resume: the resumed run diverged from "
                             f"the uninterrupted one in {diverged}")
    log(f"[warm] resume CONFIG fcea-pdd dense warm, 4 rounds in segments of "
        f"2 (CUDA generator): stopped after one segment, resumed; metrics "
        f"(sweeps {res.metrics.sweeps.tolist()}), the final carry with its "
        f"warm leaf and the generator state bit-identical to the "
        f"uninterrupted run_scanned: ok")


def _warm_bench(cfg, dev, rounds=16):
    """The reference's ``bench_rounds.warm_sweeps_ab``: 1024 x 16
    ``random_waypoint``, gcea + fastest, ``rounds`` rounds cold and warm
    from one state and generator state, in turns cold, warm, warm, cold:
    the median and mean sweeps of rounds 2..R (round 1 has no seed) and
    the associate stage's ms a round (CUDA events, median over rounds
    2..R, then over the turns of each mode); the two modes' decisions
    equal."""
    import torch
    from repro_torch.core import engine
    cfg = bench_config(cfg, 1024, 16)
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=dev,
                                                scenario=WARM_WORLD)
    start = aux["generator"].get_state()
    sweeps, assoc_ms, decisions = {}, {"cold": [], "warm": []}, {}
    for mode in WARM_TURNS:
        spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                                 scenario="dynamic",
                                 warm_start=mode == "warm")
        timer = StageTimer()
        gen = torch.Generator(device=dev).set_state(start)
        _, ms = engine.run_scanned(cfg, spec, state, bundle, rounds, gen,
                                   timer=timer)
        sweeps[mode] = ms.sweeps.tolist()
        decisions.setdefault(mode, (ms.n_associated.cpu(), ms.z.cpu()))
        assoc_ms[mode].append(statistics.median(timer.ms()["associate"][1:]))
    if not (torch.equal(decisions["cold"][0], decisions["warm"][0])
            and torch.equal(decisions["cold"][1], decisions["warm"][1])):
        raise AssertionError("[warm] 1024x16: warm and cold decisions differ")
    out = {}
    for mode in ("cold", "warm"):
        tail = sweeps[mode][1:]
        out[mode] = (statistics.median(tail), statistics.mean(tail),
                     statistics.median(assoc_ms[mode]))
    log(f"[warm] 1024x16 random_waypoint gcea-fastest, {rounds} rounds: "
        f"sweeps a round cold {sweeps['cold']}, warm {sweeps['warm']}; "
        f"rounds 2..{rounds}: median sweeps cold {out['cold'][0]} warm "
        f"{out['warm'][0]}, mean cold {out['cold'][1]:.2f} warm "
        f"{out['warm'][1]:.2f}; associate stage ms a round (median, turns "
        f"{'/'.join(WARM_TURNS)}) cold {out['cold'][2]:.4f} warm "
        f"{out['warm'][2]:.4f} ({out['warm'][2] / out['cold'][2]:.2f}x); "
        f"per turn cold {[round(v, 4) for v in assoc_ms['cold']]} warm "
        f"{[round(v, 4) for v in assoc_ms['warm']]}; decisions equal: ok")


def phase_warm(cfg, dev):
    """The warm-started association on the card: ``CONFIG`` fcea + PDD
    dense 5 rounds and K = 2, and buffered fcea dense 16 micro-steps, each
    warm against cold from one generator state under ``random_waypoint``
    (every kernel call of each warm run held against its plain version);
    the warm dense run card vs CPU; a warm resumable run; the reference's
    ``warm_sweeps`` case at 1024 x 16.  Returns the launches of the dense
    warm run (the K = 2 run's for ``score_candidates``)."""
    clock = _PieceClock("warm")
    launches, _ = clock("dense", _warm_cold_pair, cfg, {}, 5, dev,
                        "CONFIG fcea-pdd dense")
    launches_k, _ = clock("K=2", _warm_cold_pair, cfg, {"candidates_k": 2},
                          5, dev, "CONFIG fcea-pdd K=2")
    clock("buffered", _warm_cold_pair, cfg, {"engine_mode": "buffered"}, 16,
          dev, "CONFIG fcea dense buffered")
    clock("card vs cpu", _warm_card_vs_cpu, cfg, 3, dev)
    clock("resume", _warm_resume, cfg, dev)
    clock("1024x16", _warm_bench, cfg, dev)
    clock.report()
    return {**launches, "score_candidates": launches_k["score_candidates"]}


def _sweep_cfg(cfg):
    """The reference's ``sweeps/grid.py`` demo config: 32 x 4, hidden 32,
    input 64."""
    import dataclasses
    return dataclasses.replace(cfg, n_clients=32, n_edges=4, min_samples=60,
                               max_samples=120, hidden=32, input_dim=64)


# the buffered engine's grid knobs off their defaults (at 32 x 4 the
# automatic fill is 8, the tiers 4, the timeout 10 s, a retier every 8)
SWEEP_KNOBS = dict(buffer_fill=3, timeout_s=2.0, n_tiers=2, retier_every=2)


def _sweep_grids():
    """The reference's ``--quick`` demo grid and quick chaos grid, one
    ddpg group (fcea at K = 2, 2 seeds, 2 episodes x 10 slots, each cell
    trained on its own world), and a quick buffered grid with
    ``SWEEP_KNOBS`` (gcea, static and markov_dropout, 2 seeds, 4
    micro-steps)."""
    from repro_torch.faults import FaultSpec
    from repro_torch.sweeps import SweepGrid
    return [
        SweepGrid(name="demo",
                  scenarios=("static", "random_waypoint", "markov_dropout",
                             "hetero_devices", "full_dynamic",
                             "flash_crowd"),
                  policies=("fcea", "gcea"), seeds=(0,), n_rounds=3),
        SweepGrid(name="chaos", scenarios=("static", "markov_dropout"),
                  policies=("gcea",), seeds=(0,), n_rounds=3, telemetry=True,
                  engine_modes=("buffered",),
                  faults=FaultSpec(edge_p_kill=0.2, edge_p_respawn=0.5,
                                   uplink_p_loss=0.1, uplink_loss_slope=0.2)),
        SweepGrid(name="ddpg", scenarios=("full_dynamic",),
                  policies=("fcea",), allocators=("ddpg",), seeds=(0, 1),
                  n_rounds=3, candidates_k=2, ddpg_episodes=2, ddpg_steps=10,
                  ddpg_warmup=8, ddpg_hidden=64),
        SweepGrid(name="knobs", scenarios=("static", "markov_dropout"),
                  policies=("gcea",), seeds=(0, 1), n_rounds=4,
                  engine_modes=("buffered",), **SWEEP_KNOBS)]


def _sweep_cell_vs_own(cfg, grid, rows, dev):
    """Each cell of ``grid`` against its own ``run_scanned`` from a fresh
    ``init_simulation(seed)`` on the card (a ddpg cell billed by the actor
    ``train_allocator`` trains alone from its own training generator): the
    decisions (round, n_associated, n_available, z) exact and every float
    bit-equal in every cell, whatever group it ran in.  Returns (cells,
    the largest relative gaps, all 0)."""
    import torch
    from repro_torch.core import ddpg, engine
    from repro_torch.sweeps import grid as sweep_grid
    cells = sweep_grid.expand_grid(grid)
    worst = {}
    for cell in cells:
        spec = sweep_grid._spec_for(cell, grid)
        state, bundle, aux = engine.init_simulation(
            cfg, seed=cell.seed, iid=grid.iid, device=dev,
            scenario=cell.sspec)
        actor = None
        if cell.allocator == "ddpg":
            g = torch.Generator(device=dev).manual_seed(
                sweep_grid.TRAIN_SEED_BASE + cell.seed)
            dcfg = ddpg.allocator_config(cfg, spec, hidden=grid.ddpg_hidden)
            agent = ddpg.init_ddpg(g, dcfg)
            draws = ddpg.sample_ddpg_draws(cfg, dcfg, [g],
                                           grid.ddpg_episodes,
                                           grid.ddpg_steps).seed(0)
            assoc_u = (torch.rand(bundle.dist.shape, generator=g, device=dev)
                       if spec.policy == "rcea" else None)
            agent, _ = ddpg.train_allocator(cfg, spec, state, bundle, dcfg,
                                            agent, draws,
                                            warmup=grid.ddpg_warmup,
                                            assoc_u=assoc_u)
            actor = agent.actor
        _, out = engine.run_scanned(cfg, spec, state, bundle, grid.n_rounds,
                                    aux["generator"], actor)
        ms, _ = engine.split_output(spec, out)
        got = rows[cell.cell_id]
        tag = f"[sweep] {cell.cell_id}"
        if not all(got[k] == getattr(ms, k).tolist()
                   for k in ("round", "n_associated", "n_available", "z")):
            raise AssertionError(f"{tag}: decisions differ from its own "
                                 f"run_scanned")
        for i in range(grid.n_rounds):
            g = {k: v[i] for k, v in got.items()}
            w = engine.metrics_row(ms, i)
            diff = [k for k in ("cost", "total_time_s", "total_energy_j",
                                "avg_staleness", "loss", "accuracy")
                    if g[k] != w[k]]
            if diff:
                raise AssertionError(f"{tag} round {i + 1}: {diff} not "
                                     f"bit-equal to its own run: {g} {w}")
            for key, v in _check_bill(f"{tag} round {i + 1}", g, w,
                                      bundle.test_y.shape[0]).items():
                worst[key] = max(worst.get(key, 0.0), v)
    return len(cells), worst


def _batched_mlp_apply(params, x, n_layers):
    """The DDPG networks as one batched product over the seed axis (the
    form ``ddpg._mlp_apply`` avoids), for ``_fleet_witness``."""
    import torch
    one = x.dim() == params["w0"].dim() - 1
    if one:
        x = x.unsqueeze(-2)
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"].unsqueeze(-2)
        if i < n_layers - 1:
            x = torch.relu(x)
    return x.squeeze(-2) if one else x


def _fleet_witness(cfg, config8, dev):
    """Why a fleet computes a seed at a time: seed 0 of a fleet against
    its own single run on the same inputs, in the port's per-seed form and
    in the batched form it replaces -- the ddpg group's first cell's actor
    trained alone and in a fleet of 2 (``_mlp_apply``'s products); the
    eval logits of ``CONFIG``'s 8 initial models on their test sets
    (``config8``, ``_fleet_inputs``; ``mlp._dense``); 4 × 16 SGD lanes at the sweep config's shape at one
    seed's cluster size and at the fleet-wide one.  Fails unless every
    per-seed form is bit-equal; returns the batched forms' max abs gaps."""
    import torch
    from repro_torch.core import ddpg, engine
    from repro_torch.kernels import hfl_ops
    from repro_torch.models import mlp
    from repro_torch.models.mlp import PARAM_KEYS
    from repro_torch.sweeps import grid as sweep_grid
    gap = lambda a, b: max(float((a[k] - b[k]).abs().max()) for k in a)
    grid = _sweep_grids()[2]
    cells = sweep_grid.expand_grid(grid)[:2]
    spec = sweep_grid._spec_for(cells[0], grid)

    def actor0(members):
        built = [engine.init_simulation(cfg, seed=c.seed, device=dev,
                                        scenario=c.sspec)[:2]
                 for c in members]
        states, bundles = engine.stack_fleet(built)
        return {k: v[0] for k, v in sweep_grid._train_actors(
            cfg, spec, grid, members, states, bundles, dev).items()}
    per_seed = ddpg._mlp_apply
    out = {}
    for form in ("per_seed", "batched"):
        ddpg._mlp_apply = per_seed if form == "per_seed" else \
            _batched_mlp_apply
        try:
            out[form, "ddpg"] = gap(actor0(cells[:2]), actor0(cells[:1]))
        finally:
            ddpg._mlp_apply = per_seed
    params, x = config8[0].global_params, config8[1].test_x

    def batched(p, xs):
        h = torch.relu(xs @ p["w1"] + p["b1"][:, None])
        h = torch.relu(h @ p["w2"] + p["b2"][:, None])
        return h @ p["w3"] + p["b3"][:, None]
    one = {k: v[:1] for k, v in params.items()}
    out["per_seed", "eval"] = float(
        (mlp.apply(params, x)[0] - mlp.apply(one, x[:1])[0]).abs().max())
    out["batched", "eval"] = float(
        (batched(params, x)[0] - batched(one, x[:1])[0]).abs().max())
    k, seeds = 16, 4
    shape = (cfg.local_batch, cfg.input_dim, cfg.hidden, cfg.n_classes)
    p, bx, by = sgd_inputs(seeds * k, 1, *shape, 7, dev)
    own = hfl_ops.local_sgd_step({n: v[:k] for n, v in p.items()},
                                 bx[:, :k], by[:, :k], lr=0.01)
    for form, n in (("per_seed", seeds), ("batched", 1)):
        got = hfl_ops.local_sgd_step(p, bx, by, lr=0.01, seeds=n)
        out[form, "sgd"] = gap({n_: got[n_][:k] for n_ in PARAM_KEYS}, own)
    torch.cuda.synchronize()
    if any(out["per_seed", part] for part in ("ddpg", "eval", "sgd")):
        raise AssertionError(f"[sweep] a fleet's seed 0 is not bit-equal to "
                             f"its own run in the per-seed form: {out}")
    sizes = [hfl_ops.sgd_cluster_size(n * k, *shape) for n in (1, seeds)]
    log(f"[sweep] fleet seed 0 vs its own single run on the same inputs, "
        f"max abs gap per-seed form / batched form: ddpg actor trained in "
        f"a fleet of 2 {out['per_seed', 'ddpg']} / {out['batched', 'ddpg']}"
        f"; CONFIG eval logits, 8 seeds {out['per_seed', 'eval']} / "
        f"{out['batched', 'eval']}; SGD 4 x 16 lanes at one seed's cluster "
        f"size ({sizes[0]}) {out['per_seed', 'sgd']} / at the fleet-wide "
        f"({sizes[1]}) {out['batched', 'sgd']}: ok")


def _fleet_inputs(cfg, worlds, seeds, dev):
    """A fleet of ``worlds`` at seed 0, or of the static ``seeds``: its
    stacked states and bundles and each world's generator state."""
    from repro_torch.core import engine
    built = ([engine.init_simulation(cfg, seed=0, device=dev, scenario=w)
              for w in worlds] if worlds else
             [engine.init_simulation(cfg, seed=s, device=dev)
              for s in seeds])
    states, bundles = engine.stack_fleet([(st, b) for st, b, _ in built])
    return states, bundles, [aux["generator"].get_state()
                             for _, _, aux in built]


def _plain_fleet_s(cfg, spec, inputs, dev, rounds=3):
    """Seconds of one plain ``run_fleet`` from ``_fleet_inputs``, with
    fresh generators, from a synchronised start to its metrics on the
    host."""
    import torch
    from repro_torch.core import engine
    states, bundles, gen_states = inputs
    gens = [torch.Generator(device=dev).set_state(g) for g in gen_states]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ms = engine.run_fleet(cfg, spec, states, bundles, rounds, gens)
    [v.cpu() for v in ms if isinstance(v, torch.Tensor)]
    return time.perf_counter() - t0


def _sweep_vs_run_fleet(cfg, config8, dev):
    """A sweep group's wall time against a plain ``run_fleet`` of the same
    fleet (gcea + fastest, so no PDD loop hides the runner;
    random_waypoint, markov_dropout, hetero_devices and full_dynamic, seed
    0, 3 rounds), each ending with its metrics on the host, in turns
    sweep, plain, plain, sweep, twice.  Then the SGD's launch geometry: a
    plain fleet with its S·K lanes at one seed's cluster size (the port's
    rule, which keeps each seed bit-equal to its own run) against the
    fleet-wide size (the largest with S·K·c within the SMs), in turns
    per-seed, fleet-wide, fleet-wide, per-seed, at those 4 worlds and at
    ``CONFIG``'s 8 static seeds (``config8``)."""
    from repro_torch.configs.hfl_mnist import CONFIG
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    from repro_torch.sweeps import SweepGrid, run_sweep
    worlds = ("random_waypoint", "markov_dropout", "hetero_devices",
              "full_dynamic")
    grid = SweepGrid(name="ab", scenarios=worlds, policies=("gcea",),
                     schedulers=("fastest",), seeds=(0,), n_rounds=3)
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                             scenario="dynamic")
    inputs = _fleet_inputs(cfg, worlds, None, dev)
    walls = {"sweep": [], "plain": []}
    for turn in ("sweep", "plain", "plain", "sweep") * 2:
        walls[turn].append(
            run_sweep(cfg, grid, write_json=False, device=dev)["groups"][0]
            ["wall_s"] if turn == "sweep"
            else _plain_fleet_s(cfg, spec, inputs, dev))
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"[sweep] group vs plain run_fleet, 4 worlds gcea-fastest 3 rounds, "
        f"turns sweep/plain/plain/sweep x2: sweep {walls['sweep']} s, plain "
        f"{walls['plain']} s; medians sweep {med['sweep']} plain "
        f"{med['plain']} ({med['sweep'] / med['plain']:.3f}x)")
    real = hfl_ops.local_sgd_step

    def fleet_wide(*a, **kw):
        kw.pop("seeds", None)
        return real(*a, **kw)
    static = engine.EngineSpec(policy="gcea", scheduler="fastest")
    for label, c, sp, inputs in (
            ("sweep config, 4 worlds", cfg, spec, inputs),
            ("CONFIG, 8 static seeds", CONFIG, static, config8)):
        lanes = min(c.n_clients, engine.quota_for(c, sp) * c.n_edges)
        shape = (c.local_batch, c.input_dim, c.hidden, c.n_classes)
        s = inputs[1].dist.shape[0]
        sizes = {"per_seed": hfl_ops.sgd_cluster_size(lanes, *shape),
                 "fleet_wide": hfl_ops.sgd_cluster_size(s * lanes, *shape)}
        walls = {"per_seed": [], "fleet_wide": []}
        try:
            for turn in ("per_seed", "fleet_wide", "fleet_wide",
                         "per_seed"):
                hfl_ops.local_sgd_step = (fleet_wide if turn == "fleet_wide"
                                          else real)
                walls[turn].append(_plain_fleet_s(c, sp, inputs, dev))
        finally:
            hfl_ops.local_sgd_step = real
        med = {k: statistics.median(v) for k, v in walls.items()}
        log(f"[sweep] SGD cluster size a fleet, {label} ({s} x {lanes} "
            f"lanes), gcea-fastest 3 rounds, turns per-seed/fleet-wide/"
            f"fleet-wide/per-seed: "
            f"per-seed (cluster {sizes['per_seed']}) {walls['per_seed']} s, "
            f"fleet-wide (cluster {sizes['fleet_wide']}) "
            f"{walls['fleet_wide']} s; medians {med['per_seed']} vs "
            f"{med['fleet_wide']} "
            f"({med['per_seed'] / med['fleet_wide']:.3f}x)")


def phase_sweep(cfg, dev):
    """The sweep runner on the card, the launch counters zeroed just
    before the four grids and read just after, every kernel call held
    against its plain version: the reference's quick demo grid (12 cells
    in 6 groups), its quick chaos grid (buffered, telemetry, faults), one
    ddpg group and a buffered grid with its four knobs off their defaults
    (each group's spec holding them), written to a temporary directory;
    each group's wall
    time; every cell against its own ``run_scanned``; the per-seed forms
    against the batched ones (``_fleet_witness``); a group against a
    plain ``run_fleet``.  Returns the phase's launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import hfl_ops
    from repro_torch.sweeps import run_sweep
    cfg = _sweep_cfg(cfg)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    directory = tempfile.mkdtemp(prefix="sweep_", dir=build)
    grids, summaries = _sweep_grids(), []
    try:
        with _recording_kernels() as calls:
            torch.cuda.synchronize()
            hfl_ops.reset_launches()
            for grid in grids:
                summaries.append(run_sweep(cfg, grid, out_dir=directory,
                                           device=dev))
            torch.cuda.synchronize()
            launches = dict(hfl_ops.LAUNCHES)
        files = sorted(p.name for p in (Path(directory) / "sweep_demo")
                       .iterdir())
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    for grid, s in zip(grids, summaries):
        if s["failed_cells"]:
            raise AssertionError(f"[sweep] {grid.name}: failed cells "
                                 f"{s['failed_cells']}")
        log(f"[sweep] {grid.name}: {s['n_cells']} cells in "
            f"{s['n_compiles']} groups; wall s a group "
            + ", ".join(f"{g['spec']['policy']}/{g['spec']['scenario']}/"
                        f"{g['spec']['engine_mode']} x{g['n_cells']} "
                        f"{g['wall_s']}"
                        + (f" (+{g['ddpg_train_s']} s training, "
                           f"{g['ddpg_actors']} actors)"
                           if 'ddpg_train_s' in g else "")
                        for g in s["groups"]))
    for g in summaries[-1]["groups"]:
        if {k: g["spec"][k] for k in SWEEP_KNOBS} != SWEEP_KNOBS:
            raise AssertionError(f"[sweep] knobs: a group ran {g['spec']}")
    demo = summaries[0]
    if (demo["n_cells"], demo["n_compiles"], len(files)) != (12, 6, 13):
        raise AssertionError(f"[sweep] demo: {demo['n_cells']} cells, "
                             f"{demo['n_compiles']} groups, {len(files)} "
                             f"files")
    if not all(launches[k] for k in ("score_matrix", "score_candidates",
                                     "sic_rates", "local_sgd_step")):
        raise AssertionError(f"[sweep] a kernel of the path never launched: "
                             f"{launches}")
    log(f"[sweep] launches of the phase (4 grids): {launches}")
    _hold_recorded("[sweep] four grids", calls, launches)
    clock = _PieceClock("sweep")
    for grid, s in zip(grids, summaries):
        n, worst = clock(f"{grid.name} cells vs own", _sweep_cell_vs_own,
                         cfg, grid, s["cells"], dev)
        log(f"[sweep] {grid.name}: each of {n} cells against its own "
            f"run_scanned on the card: decisions exact, every float "
            f"(cost, time, energy, staleness, loss, accuracy) bit-equal; "
            f"largest relative gaps "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + ": ok")
    from repro_torch.configs.hfl_mnist import CONFIG
    config8 = clock("CONFIG 8 seeds", _fleet_inputs, CONFIG, None, range(8),
                    dev)
    clock("fleet witness", _fleet_witness, cfg, config8, dev)
    clock("group vs run_fleet", _sweep_vs_run_fleet, cfg, config8, dev)
    clock.report()
    return launches


# ---------------------------------------------------------------------------
# [shard]: the HFL engine across processes
# ---------------------------------------------------------------------------

# the seed axis at CONFIG (fcea + PDD, S = 8) and the client axis at
# 512 x 16 at CONFIG's widths (x (512, 1200, 784) float32, 1.9 GB; cut
# from 2048 x 16, then 1024 x 16, to keep the whole script inside its
# budget):
# dense fcea + PDD, K = 4 and fcea + PDD under chaos, each SHARD_ROUNDS
# rounds, the buffered engine (fcea dense) and K = 4 buffered under chaos,
# each SHARD_STEPS micro-steps
SHARD_ROUNDS = 3
SHARD_STEPS = 8
SHARD_SEEDS = 8
SHARD_WORLD = (512, 16)
SHARD_K = 4
SHARD_KERNELS = ("score_matrix", "score_candidates", "sic_rates",
                 "local_sgd_step")


def _shard_jobs(cfg):
    import dataclasses
    from repro_torch.core import engine
    from repro_torch.faults import FaultSpec
    from repro_torch.launch import sharded
    big = dataclasses.replace(cfg, n_clients=SHARD_WORLD[0],
                              n_edges=SHARD_WORLD[1])
    chaos = FaultSpec(**FAULT_CHAOS)
    return {
        "fleet": sharded.Job("fleet", cfg, engine.EngineSpec(), SHARD_ROUNDS,
                             tuple(range(SHARD_SEEDS))),
        "clients-dense": sharded.Job("clients", big, engine.EngineSpec(),
                                     SHARD_ROUNDS),
        "clients-k4": sharded.Job("clients", big,
                                  engine.EngineSpec(candidates_k=SHARD_K),
                                  SHARD_ROUNDS),
        "clients-buffered": sharded.Job(
            "clients", big, engine.EngineSpec(engine_mode="buffered"),
            SHARD_STEPS),
        "clients-chaos": sharded.Job(
            "clients", big, engine.EngineSpec(faults=chaos), SHARD_ROUNDS),
        "clients-buffered-chaos": sharded.Job(
            "clients", big, engine.EngineSpec(
                candidates_k=SHARD_K, engine_mode="buffered", faults=chaos),
            SHARD_STEPS)}


def _host_peak_bytes() -> int:
    """This process's peak resident host memory (``ru_maxrss``)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _shard_world_on(world, job, device):
    """A world as the parent hands it to the ranks (its tensors on the
    card, reaching them through CUDA IPC; its generators as numpy
    states), with the generators rebuilt on ``device``."""
    import torch
    states, bundles, gen_states = world

    def gen(a):
        return torch.Generator(device=device).set_state(torch.from_numpy(a))

    if job.axis == "clients":
        return states, bundles, gen(gen_states)
    return states, bundles, [gen(a) for a in gen_states]


def _probe_gloo_cuda(device):
    """Which collectives the default (gloo) group takes on CUDA tensors
    directly: "ok", or the first line of the error each raised (``Mesh``
    stages gloo's tensors through the host either way)."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    t = torch.full((4,), float(dist.get_rank() + 1), device=device)
    calls = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "all_reduce": lambda: dist.all_reduce(t.clone()),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as exc:  # noqa: BLE001 -- the probe's answer
            out[name] = (str(exc).strip().splitlines() or [repr(exc)])[0]
    return out


def _shard_part(jobs, worlds, solo=None, probe=False):
    """One part of ``shard_rank``: each job through ``run_sharded`` on
    the current process group, on its world (one a job, as
    ``_shard_world_on`` takes it).  ``solo``: a backend ("nccl"); rank 0
    runs the jobs alone over a group of its own of that backend (a world
    of one whose collectives still go through it) while the others wait.
    ``probe``: first ``_probe_gloo_cuda``, whose answer is the first
    result.  Returns this rank's ``(outputs, stats)`` a job, as digests."""
    import torch.distributed as dist
    from repro_torch.core.mesh import Mesh, client_mesh, fleet_mesh, \
        rank_device
    from repro_torch.launch import sharded
    results = []
    dev = rank_device("cuda")
    if probe:
        results.append(_probe_gloo_cuda(dev))
    if solo:
        groups = [dist.new_group([r], backend=solo)
                  for r in range(dist.get_world_size())]
        if dist.get_rank() != 0:
            dist.barrier()
            return results
    for job, world in zip(jobs, worlds):
        if solo:
            mesh = Mesh(job.axis, groups[0], 0, 1, dev)
        else:
            mesh = fleet_mesh() if job.axis == "fleet" else client_mesh()
        results.append(sharded.run_sharded(
            job, mesh, _shard_world_on(world, job, dev), digest=True))
    if solo:
        dist.barrier()
    return results


def shard_rank(parts):
    """The ranks' target (``core.mesh.spawn`` imports it from this
    script): ``_shard_part(**part)`` for each part in turn (one spawn for
    several meshes: a world of one over NCCL, then two gloo ranks).  Each
    part is emptied after it ran: the worlds the parent shared through
    CUDA IPC are released here, while the process lives, so that the
    parent can free them (``torch.cuda.ipc_collect``) once every rank is
    done."""
    results = []
    for part in parts:
        results.append(_shard_part(**part))
        part.clear()
    gc.collect()
    return results


def _steady(stats) -> float:
    """The median of a run's rounds after the first."""
    return statistics.median(stats["seconds"][1:])


def _shard_check(label, want, runs, index):
    """Every rank's digests of job ``index`` of a part against the
    unsharded run's: every leaf bit-equal (equal SHA-256 of its bytes)."""
    for rank, results in enumerate(runs):
        got = results[index][0]
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        if bad:
            raise AssertionError(f"[shard] {label} rank {rank}: leaves "
                                 f"differ from the unsharded run: {bad}")


def _shard_launches(label, job, cfg_rounds_want, runs, index):
    """Each rank's kernel launches of job ``index``: a fleet rank makes a
    whole fleet's (one score and one SIC call a round, τ₂ SGD launches);
    a client rank scores and bills the whole control plane (the
    unsharded counts) and launches the SGD only on rounds where its rows
    hold an admitted client."""
    per_rank = [results[index][1]["launches"] for results in runs]
    want = cfg_rounds_want
    for rank, got in enumerate(per_rank):
        for k in ("score_matrix", "score_candidates", "sic_rates"):
            if got[k] != want[k]:
                raise AssertionError(f"[shard] {label} rank {rank}: {k} "
                                     f"{got[k]} != {want[k]}")
        sgd = got["local_sgd_step"]
        if (job.axis == "fleet" and sgd != want["local_sgd_step"]) or \
                sgd > want["local_sgd_step"]:
            raise AssertionError(f"[shard] {label} rank {rank}: SGD "
                                 f"launches {sgd}, want "
                                 f"{want['local_sgd_step']}")
    if sum(r["local_sgd_step"] for r in per_rank) == 0:
        raise AssertionError(f"[shard] {label}: no rank launched the SGD")
    return per_rank


def phase_shard(cfg, dev, card):
    """The seed axis (``engine.run_fleet_sharded``) and the client axis
    (``engine.run_scanned_client_sharded``) over W = min(cards, 4) NCCL
    ranks, or, on one card, a world of one over NCCL and then two gloo
    ranks on that card (with which collectives gloo takes on CUDA tensors
    directly).  The worlds are built once, here, on the card; the ranks
    (``core.mesh.spawn``) read them through CUDA IPC and copy only their
    share.  Each job first runs unsharded here, then on the ranks (in
    turns, never side by side); every leaf of every rank's metrics, final
    state (the client rows and pending deltas gathered) and generator
    states is held bit for bit to the unsharded run's (SHA-256 of the
    bytes).  Reports seed-rounds a second, s a round and micro-steps a
    second at W and at 1, each rank's launches, rows, peak device memory
    and peak host memory.  Returns each kernel's launches a rank of the
    widest part, summed over its jobs."""
    import torch
    from repro_torch.core.engine import quota_for
    from repro_torch.core.mesh import spawn
    from repro_torch.launch import sharded
    jobs = _shard_jobs(cfg)
    names = list(jobs)
    cards = torch.cuda.device_count()
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # the fleet's worlds in a thread beside the client world's (numpy
    # draws them without the GIL)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fleet_future = pool.submit(sharded.build_world, jobs["fleet"], dev)
        client_world = sharded.build_world(jobs["clients-dense"], dev)
        fleet_world = fleet_future.result()
    del fleet_future
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    worlds = {
        "fleet": (*fleet_world[:2],
                  [g.get_state().numpy() for g in fleet_world[2]]),
        "clients-dense": (*client_world[:2],
                          client_world[2].get_state().numpy())}
    for name in names[2:]:                  # one client world for all
        worlds[name] = worlds["clients-dense"]
    x = client_world[1].x
    log(f"[shard] worlds built once, on the card, in {build_s:.1f} s: "
        f"CONFIG S={SHARD_SEEDS} and {SHARD_WORLD[0]}x{SHARD_WORLD[1]} at "
        f"CONFIG's widths (x {tuple(x.shape)} float32, "
        f"{x.numel() * 4 / 1e9:.2f} GB); this process's peak host memory "
        f"so far {_host_peak_bytes() / 1e9:.2f} GB")
    want = {}
    for name, job in jobs.items():
        world = _shard_world_on(worlds[name], job, dev)
        want[name] = sharded.run_unsharded(job, 1, dev, world, digest=True)
        del world
    if cards >= 2:
        w = min(cards, 4)
        parts = [dict(jobs=list(jobs.values()),
                      worlds=[worlds[n] for n in names])]
        labels = [(f"W={w} nccl across {w} cards", w)]
        t0 = time.perf_counter()
        runs = spawn(shard_rank, w, backend="nccl", device="cuda",
                     args=(parts,), timeout_s=400)
        probe = None
    else:
        parts = [dict(jobs=list(jobs.values()),
                      worlds=[worlds[n] for n in names], solo="nccl",
                      probe=True),
                 dict(jobs=list(jobs.values()),
                      worlds=[worlds[n] for n in names])]
        labels = [("W=1 nccl", 1), ("W=2 gloo on one card", 2)]
        t0 = time.perf_counter()
        runs = spawn(shard_rank, 2, backend="gloo", device="cuda",
                     args=(parts,), timeout_s=400)
        probe = runs[0][0][0]
        log("[shard] one card: NCCL across cards did not run; gloo on "
            "CUDA tensors directly: "
            + ", ".join(f"{k} {v}" for k, v in probe.items())
            + " (the mesh stages gloo's tensors through the host)")
    spawn_s = time.perf_counter() - t0
    per_rank_launches = None
    for p, (label, w) in enumerate(labels):
        # the rank results of part p; a solo part's only rank is rank 0,
        # and the probe (if any) is its first result
        part = [runs[r][p] for r in range(w)]
        if probe is not None and p == 0:
            part = [part[0][1:]]
        launches = {}
        for i, name in enumerate(names):
            job = jobs[name]
            ref_out, ref_stats = want[name]
            _shard_check(f"{label} {name}", ref_out, part, i)
            rounds_want = _want_launches(job.cfg, job.spec, job.rounds,
                                         len(job.seeds) if job.axis ==
                                         "fleet" else 1)
            per = _shard_launches(f"{label} {name}", job, rounds_want,
                                  part, i)
            launches[name] = per
            stats = [res[i][1] for res in part]
            peaks = ", ".join(f"{s['peak_bytes'] / 1e9:.3f} (from "
                              f"{s['start_bytes'] / 1e9:.3f})"
                              for s in stats)
            hosts = ", ".join(
                "not measured" if s["host_resident_bytes"] is None
                else f"{s['host_resident_bytes'] / 1e9:.2f}" for s in stats)
            counts = "; ".join(
                f"r{r} score {l['score_matrix'] + l['score_candidates']} "
                f"SIC {l['sic_rates']} SGD {l['local_sgd_step']}"
                for r, l in enumerate(per))
            s_w, s_1 = _steady(stats[0]), _steady(ref_stats)
            buffered = job.spec.engine_mode == "buffered"
            if job.axis == "fleet":
                rate = (f"{SHARD_SEEDS / s_w:.2f} seed-rounds/s at W={w} "
                        f"({s_w:.4f} s a round), "
                        f"{SHARD_SEEDS / s_1:.2f} unsharded ({s_1:.4f})")
            else:
                rows = job.cfg.n_clients // w
                held = [(s["client_rows"],
                         s["pending_rows"] if buffered else rows)
                        for s in stats]
                if any(h != (rows, rows) for h in held):
                    raise AssertionError(
                        f"[shard] {label} {name}: rows a rank (client "
                        f"models, pending deltas) {held}, want {rows}")
                k_lanes = min(job.cfg.n_clients,
                              quota_for(job.cfg, job.spec)
                              * job.cfg.n_edges)
                rate = (f"{1 / s_w:.2f} micro-steps/s at W={w} ({s_w:.4f} "
                        f"s each), {1 / s_1:.2f} unsharded ({s_1:.4f})"
                        if buffered else
                        f"{s_w:.4f} s a round at W={w}, {s_1:.4f} "
                        f"unsharded")
                rate += (f"; {k_lanes} lanes, rows a rank {rows}"
                         + (" (client models and pending deltas)"
                            if buffered else ""))
            log(f"[shard] {label} {name} {job.rounds} "
                f"{'micro-steps' if buffered else 'rounds'}: {rate}; "
                f"launches {counts}; peak device GB a rank {peaks} "
                f"(unsharded {ref_stats['peak_bytes'] / 1e9:.3f} from "
                f"{ref_stats['start_bytes'] / 1e9:.3f}, its worlds "
                f"included); host GB resident a rank after its run "
                f"{hosts}; every leaf of "
                f"every rank's "
                f"metrics, final state and generators bit-equal to the "
                f"unsharded run ({len(ref_out)} leaves): ok")
        if w == max(lw for _, lw in labels):
            per_rank_launches = [
                {k: sum(launches[n][r][k] for n in names)
                 for k in SHARD_KERNELS} for r in range(w)]
    log(f"[shard] ranks' processes {spawn_s:.1f} s in all (start, CUDA "
        f"context, runs)")
    # the ranks dropped their handles before they exited
    # (``shard_rank``); the parent's sent tensors go once its own
    # references do
    del worlds, fleet_world, client_world, x, want, parts
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    held_after = torch.cuda.memory_allocated()
    log(f"[shard] device memory held before the phase "
        f"{held_before / 1e9:.3f} GB, after {held_after / 1e9:.3f} GB")
    if held_after > held_before + 2 ** 30:
        raise AssertionError("[shard] the worlds shared with the ranks were "
                             "not released")
    return per_rank_launches


# ---------------------------------------------------------------------------
# The substrate: sequence kernels and recurrentgemma-9b serving
# ---------------------------------------------------------------------------

# the most fp32 scores the plain flash version holds at once; above it the
# comparison runs it one KV head (and its query heads) at a time
PLAIN_SCORE_BYTES = 8e9


def flash_plain(q, k, v, **mask):
    """``seq_ops.attention_plain``, one KV head at a time where all heads'
    (S, S_kv) fp32 scores would pass ``PLAIN_SCORE_BYTES`` (llama4's 1 x
    16384 at 40 heads: 43 GB): the same function."""
    import torch
    from repro_torch.kernels import seq_ops
    b, s, h, _ = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    if 4.0 * b * h * s * s_kv <= PLAIN_SCORE_BYTES:
        return seq_ops.attention_plain(q, k, v, **mask)
    g = h // kv
    return torch.cat([seq_ops.attention_plain(
        q[:, :, i * g:(i + 1) * g], k[:, :, i:i + 1], v[:, :, i:i + 1],
        **mask) for i in range(kv)], dim=2)


def flash_work(b, s, h, kv, d, itemsize, mask):
    """Bytes (q, k, v read once, o written once) and flops (QK^T and PV,
    4 · D per allowed (query, key) pair and head) the function needs --
    counted from the (S, S_kv) mask, not from the kernel's tiles."""
    pairs = int(mask.sum())
    s_kv = mask.shape[1]
    n_bytes = itemsize * b * d * (2 * h * s + 2 * kv * s_kv)
    return n_bytes, 4.0 * b * h * pairs * d


def _seq_inputs(shape, dtype, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=shape).astype(np.float32),
                        device=dev).to(dtype)


def compare_flash(b, s, h, kv, d, causal, window, dtype, seed, dev,
                  library=False, timed=True, prefix_len=0, chunk=0,
                  s_kv=None):
    """Kernel vs plain (``flash_plain``), checking that the call launched
    the kernel ``seq_ops.flash_route`` names; with ``timed``, the times of
    both beside the bound and, with ``library``, the time of PyTorch's
    scaled_dot_product_attention with the same boolean mask -- a yardstick
    the port never calls.  ``s_kv``: the keys' length (default S).
    Returns err, ms, plain ms, bound, library ms."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import seq_ops
    s_kv = s if s_kv is None else s_kv
    q = _seq_inputs((b, s, h, d), dtype, seed, dev)
    k = _seq_inputs((b, s_kv, kv, d), dtype, seed + 1, dev)
    v = _seq_inputs((b, s_kv, kv, d), dtype, seed + 2, dev)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              chunk=chunk)
    route = seq_ops.flash_route(dtype, d)
    before = seq_ops.LAUNCHES["flash_attention_wgmma"]
    got = seq_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    masks = (f" prefix={prefix_len}" if prefix_len else "") \
        + (f" chunk={chunk}" if chunk else "")
    if s_kv != s:
        masks += f" S_kv={s_kv}"
    name = f"flash_attention B={b} S={s} H={h} KV={kv} D={d} " \
           f"causal={causal} window={window}{masks} {str(dtype)[6:]} " \
           f"({route})"
    wgmma = int(route == "seq_flash_attention_wgmma")
    if seq_ops.LAUNCHES["flash_attention_wgmma"] - before != wgmma:
        raise AssertionError(f"{name}: the tensor-core kernel was launched "
                             f"{seq_ops.LAUNCHES['flash_attention_wgmma'] - before}"
                             f" times, expected {wgmma}")
    if dtype == torch.bfloat16:
        # held to the plain version in fp32 on the same (bf16) inputs,
        # rounded to bf16 once, as the kernel rounds only its output; the
        # bf16 plain version, which rounds at every step, is printed only
        info = _max_err(got, flash_plain(q, k, v, **kw))
        log(f"[seq] {name}: bf16 plain vs kernel max abs {info:.3e} "
            f"(information)")
        want = flash_plain(q.float(), k.float(), v.float(), **kw).to(dtype)
    else:
        want = flash_plain(q, k, v, **kw)
    _check_close(name, got.float(), want.float(),
                 **FLASH_TOL[str(dtype)[6:]])
    err = _max_err(got, want)
    del want
    if not timed:
        log(f"[seq] {name}: max_abs_err {err:.3e}")
        return err
    ms_k = time_ms(lambda: seq_ops.flash_attention(q, k, v, **kw))
    ms_p = time_ms(lambda: flash_plain(q, k, v, **kw))
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    mask = seq_ops.attention_mask(s, dev, s_kv=s_kv, **kw)
    b_ms, b_by = bound_ms(*flash_work(b, s, h, kv, d, q.element_size(),
                                      mask), peak)
    lib_ms = None
    if library:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = _max_err(sdpa().transpose(1, 2), got)
        lib_ms = time_ms(sdpa)
        log(f"[seq] {name}: sdpa vs kernel max abs {lib_err:.3e}")
    log(f"[seq] {name}: max_abs_err {err:.3e}  kernel {ms_k:.4f} ms  "
        f"plain {ms_p:.4f} ms  bound {b_ms:.6f} ms ({b_by}; kernel "
        f"{ms_k / b_ms:.2f}x)"
        + (f"  sdpa {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return err, ms_k, ms_p, b_ms, b_by, lib_ms


def compare_linrec(b, s, c, dtype, seed, dev, timed=True):
    """Kernel vs plain, bit for bit (the kernel does the plain version's
    exp, IEEE multiply and add in the same order); with ``timed``, both
    times beside the bound."""
    import torch
    from repro_torch.kernels import seq_ops
    log_a = -_seq_inputs((b, s, c), torch.float32, seed, dev).abs() \
        .mul_(0.1).to(dtype)
    x = _seq_inputs((b, s, c), dtype, seed + 1, dev)
    got = seq_ops.linear_recurrence(log_a, x)
    want = seq_ops.linear_recurrence_plain(log_a, x)
    torch.cuda.synchronize()
    vec = seq_ops.linrec_vector_bytes(c, x.element_size(), log_a.data_ptr(),
                                      x.data_ptr())
    name = (f"linear_recurrence B={b} S={s} C={c} {str(dtype)[6:]} (ring "
            f"{seq_ops.LINREC_STAGES} x {seq_ops.LINREC_TILE} steps x "
            f"{seq_ops.LINREC_CHANNELS} channels, {vec}-byte copies)")
    err = _max_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to its plain version "
                             f"(max abs err {err:.3e})")
    if not timed:
        log(f"[seq] {name}: bit-equal")
        return err
    ms_k = time_ms(lambda: seq_ops.linear_recurrence(log_a, x))
    ms_p = time_ms(lambda: seq_ops.linear_recurrence_plain(log_a, x),
                   min_iters=2, budget_s=0.2)
    n = b * s * c
    b_ms, b_by = bound_ms(2 * n * log_a.element_size() + 4 * n, 3 * n)
    # a yardstick of what the card streams: one elementwise pass that
    # reads log_a and x and writes a float32 tensor of the same size
    sink = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    ms_s = time_ms(lambda: torch.add(log_a, x, out=sink))
    log(f"[seq] {name}: bit-equal  kernel {ms_k:.4f} ms  plain {ms_p:.4f} "
        f"ms  bound {b_ms:.6f} ms ({b_by}; kernel at "
        f"{100.0 * b_ms / ms_k:.1f}% of it; a streaming add over the same "
        f"bytes {ms_s:.4f} ms, {100.0 * b_ms / ms_s:.1f}%)")
    return err, ms_k, ms_p, b_ms, b_by, None


# the recurrence kernel's edge shapes (tests/test_torch_cuda.py): S not a
# multiple of the ring's tile, C not a multiple of the block's channels,
# B·C below one block, S = 1, bf16 rows of odd C (2-byte copies)
LINREC_EDGES = [(1, 77, 130), (1, 300, 20), (2, 1, 96), (1, 33, 13),
                (4, 129, 8)]


def phase_seq_compare(dev):
    """The sequence kernels vs their plain versions: recurrentgemma-9b's
    prefill shapes (returned for the JSON line), then ragged and
    non-causal shapes (printed)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    main = {
        "flash_attention": compare_flash(2, 4096, 16, 1, 256, True, 2048,
                                         bf16, 11, dev, library=True),
        "linear_recurrence": compare_linrec(2, 4096, 4096, f32, 14, dev),
    }
    for i, shape in enumerate(WGMMA_EDGES):
        compare_flash(*shape, bf16, 40 + 3 * i, dev, timed=False)
    for i, (b, s, h, kv, d, prefix, chunk) in enumerate(MASK_EDGES):
        for dtype in (bf16, f32):
            compare_flash(b, s, h, kv, d, True, 0, dtype, 90 + 3 * i, dev,
                          timed=False, prefix_len=prefix, chunk=chunk)
    compare_flash(1, 130, 2, 1, 80, True, 50, bf16, 24, dev, timed=False)
    compare_flash(1, 1000, 4, 2, 64, True, 300, f32, 21, dev)
    compare_flash(1, 300, 4, 1, 256, False, 100, f32, 27, dev, timed=False)
    compare_linrec(1, 1000, 130, bf16, 31, dev)
    compare_linrec(2, 4096, 4096, bf16, 33, dev)
    for i, shape in enumerate(LINREC_EDGES):
        for dtype in (f32, bf16):
            compare_linrec(*shape, dtype, 50 + i, dev, timed=False)
    torch.cuda.empty_cache()
    return main


def _launch_counts():
    from repro_torch.kernels import hfl_ops, seq_ops
    return {**hfl_ops.LAUNCHES, **seq_ops.LAUNCHES}


def _reset_launches():
    from repro_torch.kernels import hfl_ops, seq_ops
    hfl_ops.reset_launches()
    seq_ops.reset_launches()


def _rel_rms(got, want):
    d = (got.float() - want.float())
    return float(d.square().mean().sqrt() / want.float().square().mean()
                 .sqrt())


def phase_serve(dev, profile=False, batch=2, seq=4096, prompt_len=64,
                new_tokens=16):
    """recurrentgemma-9b at full width and depth on the card; with
    ``profile``, also the device busy share and top kernels of one
    prefill and one decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    cfg = get_config("recurrentgemma-9b")
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    prefill, model = steps.make_prefill_step(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers {cfg.block_pattern}, "
        f"{n_params} params ({n_params * 4 / 1e9:.2f} GB fp32) drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev)

    # the main path: one prefill with every launch counter zeroed
    _reset_launches()
    t0 = time.perf_counter()
    logits = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    want = {"score_rows": 0, "score_matrix": 0, "score_candidates": 0,
            "sic_rates": 0,
            "local_sgd_step": 0, "local_sgd_step_cluster": 0,
            "flash_attention": 12,
            "flash_attention_wgmma": 12, "linear_recurrence": 26}
    if launches != want:
        raise AssertionError(f"prefill launches {launches} != {want}")
    if tuple(logits.shape) != (batch, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        prefill({"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pre_s = sum(walls) / len(walls)
    peak_prefill = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] prefill {batch} x {seq}: launches {launches}; "
        f"{pre_s * 1e3:.2f} ms ({batch * seq / pre_s:.1f} tokens/s; runs "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; first "
        f"{first_s * 1e3:.2f} ms); peak memory {peak_prefill / 1e9:.2f} GB")

    # the serve path: token-by-token prompt feed, then greedy decode
    serve_step, _ = steps.make_serve_step(cfg, model=model)
    prompt = tokens[:, :prompt_len]
    cache = model.init_cache(batch, cfg.window)
    before = _launch_counts()
    t0 = time.perf_counter()
    feed_logits, cache = serve.prefill_into_cache(model, prompt, cache)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    tok = torch.argmax(feed_logits[:, -1, :], dim=-1,
                       keepdim=True).to(torch.int32)
    out, step_ms = [], []
    for i in range(new_tokens):
        t0 = time.perf_counter()
        tok, cache = serve_step(tok, cache, prompt_len + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok[:, 0])
    if _launch_counts() != before:
        raise AssertionError("the decode path launched a kernel")
    gen_tokens = torch.stack(out, dim=1)
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()):
        raise AssertionError("generated tokens outside the vocabulary")
    steady = step_ms[1:]
    decode_ms = sum(steady) / len(steady)
    log(f"[serve] decode {batch} requests: prompt of {prompt_len} fed token "
        f"by token in {feed_s * 1e3:.2f} ms ({feed_s * 1e3 / prompt_len:.2f} "
        f"ms/token); {new_tokens} greedy tokens at {decode_ms:.3f} ms/token "
        f"(steps 2..{new_tokens}; first {step_ms[0]:.3f}); "
        f"sample {gen_tokens[0, :8].tolist()}")

    if profile:
        profile_device(lambda: prefill({"tokens": tokens}),
                       f"one prefill {batch} x {seq}", pre_s)
        index = prompt_len + new_tokens
        profile_device(lambda: serve_step(tok, cache, index),
                       "one decode step", decode_ms / 1e3)

    # the kernel path against the token-by-token decode
    pre_logits = prefill({"tokens": prompt})
    rel = _rel_rms(pre_logits, feed_logits[:, 0])
    err = _max_err(pre_logits, feed_logits[:, 0])
    agree = float((pre_logits.argmax(-1) == feed_logits[:, 0].argmax(-1))
                  .float().mean())
    log(f"[serve] prefill vs decode, last logits of the {prompt_len}-token "
        f"prompt: rel rms {rel:.3e} (limit {PREFILL_DECODE_REL_RMS}), max abs "
        f"{err:.3e}, argmax agreement {agree:.2f}")
    if not rel <= PREFILL_DECODE_REL_RMS:
        raise AssertionError(f"prefill and decode logits disagree: rel rms "
                             f"{rel:.3e}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] peak device memory {peak / 1e9:.2f} GB")
    del model, cache, prefill, serve_step
    torch.cuda.empty_cache()
    return launches


def phase_substrate(dev, seq=300):
    """The reduced config (float32, window 32) from the same weights: the
    prefill's last logits and every position's logits on the card
    (kernels) against the CPU (plain versions), and against a token-by-
    token decode on the card through a ``window``-slot ring.  ``seq`` is
    ragged and spans several flash q-tiles, so tiles left of the window
    are skipped."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models.transformer import Transformer
    cfg = get_config("recurrentgemma-9b").reduced()
    gen = torch.Generator(device="cpu").manual_seed(1)
    cpu_model = Transformer(cfg, device="cpu", generator=gen)
    card_model = Transformer(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen)
    pre_cpu, _ = steps.make_prefill_step(cfg, model=cpu_model)
    pre_card, _ = steps.make_prefill_step(cfg, model=card_model)
    _reset_launches()
    last_card = pre_card({"tokens": tokens.to(dev)})
    full_card = card_model.apply(tokens.to(dev))
    torch.cuda.synchronize()
    launches = _launch_counts()
    if (launches["flash_attention"], launches["flash_attention_wgmma"],
            launches["linear_recurrence"]) != (2, 0, 4):
        raise AssertionError(f"reduced card launches {launches}")
    cache = card_model.init_cache(2, cfg.window)
    with torch.no_grad():
        decoded = torch.cat([
            card_model.decode_step(tokens[:, i:i + 1].to(dev), cache, i)[0]
            for i in range(seq)], dim=1)
    if _launch_counts() != launches:
        raise AssertionError("the decode path launched a kernel")
    for name, got, want in (
            ("card vs cpu, last logits", last_card.cpu(),
             pre_cpu({"tokens": tokens})),
            ("card vs cpu, all logits", full_card.cpu(),
             cpu_model.apply(tokens)),
            ("card prefill vs card decode, all logits", full_card, decoded)):
        _check_close(f"reduced {name}", got, want, **SUBSTRATE_TOL)
        log(f"[substrate] {cfg.name} S={seq} window {cfg.window}: {name} "
            f"max abs {_max_err(got, want):.3e} (atol "
            f"{SUBSTRATE_TOL['atol']}, rtol {SUBSTRATE_TOL['rtol']}): ok")


def phase_substrate_bf16(dev, seq=300):
    """The reduced config in bfloat16 (d_head 64, window 32): the prefill's
    logits at every position on the card (through the tensor-core flash
    kernel, over several q-tiles and the window skip) against a token-by-
    token decode on the card (plain attention)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    cfg = get_config("recurrentgemma-9b").reduced().replace(
        compute_dtype_str="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(2)
    model = Transformer(cfg, device=dev, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                           device=dev)
    _reset_launches()
    with torch.no_grad():
        full = model.apply(tokens)
    torch.cuda.synchronize()
    launches = _launch_counts()
    if (launches["flash_attention"], launches["flash_attention_wgmma"],
            launches["linear_recurrence"]) != (1, 1, 2):
        raise AssertionError(f"reduced bf16 card launches {launches}")
    cache = model.init_cache(2, cfg.window)
    with torch.no_grad():
        decoded = torch.cat([model.decode_step(tokens[:, i:i + 1], cache, i)[0]
                             for i in range(seq)], dim=1)
    if _launch_counts() != launches:
        raise AssertionError("the decode path launched a kernel")
    rel = _rel_rms(full, decoded)
    agree = float((full.argmax(-1) == decoded.argmax(-1)).float().mean())
    log(f"[substrate] {cfg.name} bf16 S={seq} window {cfg.window}: card "
        f"prefill (tensor-core flash, launches {launches['flash_attention_wgmma']}) "
        f"vs card decode, all logits: rel rms {rel:.3e} (limit "
        f"{PREFILL_DECODE_REL_RMS}), max abs {_max_err(full, decoded):.3e}, "
        f"argmax agreement {agree:.3f}")
    if not rel <= PREFILL_DECODE_REL_RMS:
        raise AssertionError(f"reduced bf16 prefill and decode logits "
                             f"disagree: rel rms {rel:.3e}")


# ---------------------------------------------------------------------------
# The dense decoders: yi-34b, qwen3-8b and -sw4k, qwen1.5-110b, stablelm-1.6b
# ---------------------------------------------------------------------------

# (arch, layers run -- None for the config's own --, batch, prefill length,
# why the depth is cut).  At fp32 weights yi-34b's 60 layers take 137.56
# GB and qwen1.5-110b's 80 take 444.84 GB; sw4k's window has to cut a
# prefill, so it runs one sequence of twice the window
DENSE_RUNS = [
    ("qwen3-8b", None, 2, 4096, ""),
    ("stablelm-1.6b", None, 2, 4096, ""),
    ("yi-34b", 12, 2, 4096, "60 layers are 137.56 GB of fp32 weights"),
    ("qwen1.5-110b", 4, 2, 4096, "80 layers are 444.84 GB of fp32 weights"),
    ("qwen3-8b-sw4k", 4, 1, 8192, "the window (4096) has to cut the prefill"),
]
# the flash kernel at each dense run's prefill shape, bf16:
# (B, S, H, KV, D, causal, window) -- GQA groups 4, 7 and 8 at D = 128,
# MHA at D = 64, the sliding window at 4096
DENSE_FLASH = [
    (2, 4096, 32, 8, 128, True, 0),      # qwen3-8b
    (2, 4096, 56, 8, 128, True, 0),      # yi-34b, group 7
    (2, 4096, 64, 8, 128, True, 0),      # qwen1.5-110b, group 8
    (2, 4096, 32, 32, 64, True, 0),      # stablelm-1.6b, MHA
    (1, 8192, 32, 8, 128, True, 4096),   # qwen3-8b-sw4k
]


def _perturb_constants(model, gen):
    """The leaves a config initialises to constants -- norm scales (ones;
    xLSTM's ``norm_scale`` too), norm, QKV and MLP biases (zeros) --
    redrawn from ``gen``, so the norm and bias paths are not held at their
    identity."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "norm_scale", "bias", "bq", "bk", "bv",
                        "b_in", "b_out"):
                z = torch.randn(p.shape, generator=gen, device=gen.device)
                p.copy_(1.0 + 0.2 * z if leaf.endswith("scale") else 0.3 * z)


def _no_drop(cfg):
    """``cfg`` at a capacity factor of experts / top-k: every expert has a
    slot for every (token, choice) of a group, so nothing drops, as the
    reference's decode-parity test raises it (a dense config as it is)."""
    if not cfg.moe_experts:
        return cfg
    return cfg.replace(moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)


def _record_routing(model):
    """Forward hooks on every MoE layer that keep the ``moe.route`` of each
    call, in call order; returns the list they fill and the hooks'
    handles (none for a dense model)."""
    from repro_torch.models import moe
    calls, handles = [], []
    for blk in model.blocks:
        if blk.ffn_kind == "moe":
            handles.append(blk.moe.register_forward_hook(
                lambda m, args, out: calls.append(
                    moe.route(m.router, args[0], args[1]))))
    return calls, handles


def _routing_agreement(pre, fed, batch, steps):
    """The share of (token, MoE layer) decisions -- the set of experts a
    token went to -- that a forward over ``batch`` x ``steps`` tokens
    (``pre``: one routing a layer) and a token-by-token decode of the same
    tokens (``fed``: a step's layers in order) made alike."""
    import torch
    n = len(pre)
    same = []
    for layer in range(n):
        a = pre[layer].idx.reshape(batch, steps, -1).sort(-1).values
        b = torch.stack([fed[i * n + layer].idx.reshape(batch, -1)
                         for i in range(steps)], 1).sort(-1).values
        same.append((a == b).all(-1))
    return float(torch.stack(same).float().mean())


def _pin_routers(model):
    """Zero every router: each token's probabilities are all 1 / E, the
    stable top-k takes experts 0..k-1 and the gates are exactly 1 / k, on
    any path -- routing can no longer flip between two paths."""
    import torch
    with torch.no_grad():
        for blk in model.blocks:
            if blk.ffn_kind == "moe":
                blk.moe.router.zero_()


def _prefix(cfg, batch, gen, dev):
    """A VLM's stub patch embeddings (B, P, d) in the compute dtype, or
    None."""
    import torch
    if not cfg.prefix_tokens:
        return None
    return torch.randn((batch, cfg.prefix_tokens, cfg.d_model), generator=gen,
                       device=dev).to(cfg.compute_dtype)


def _decode(model, tokens, patches, cache_len):
    """A token-by-token decode of ``tokens`` on the model's device after
    ``prefill_prefix`` of a VLM's ``patches``: every step's logits (B, S,
    V), the routing of each MoE call, and the flash launches it made (the
    prefix's: one a layer; the decode makes none)."""
    import torch
    p_len = model.cfg.prefix_tokens
    calls, hooks = _record_routing(model)
    cache = model.init_cache(tokens.shape[0], cache_len)
    before = _launch_counts()["flash_attention"]
    with torch.no_grad():
        if patches is not None:
            cache = model.prefill_prefix(cache, patches)
        logits = torch.cat([
            model.decode_step(tokens[:, i:i + 1], cache, p_len + i,
                              prefix_len=p_len)[0]
            for i in range(tokens.shape[1])], dim=1)
    for h in hooks:
        h.remove()
    return logits, calls, _launch_counts()["flash_attention"] - before


def _forward_no_drop(model, tokens, patches, last=False):
    """Every text position's logits of one forward (the kernel path) at
    ``_no_drop``'s capacity factor -- with ``last``, the last position's
    alone, as the prefill step unembeds it -- and the routing of its MoE
    calls."""
    import torch
    cfg = model.cfg
    calls, hooks = _record_routing(model)
    model.cfg = _no_drop(cfg)
    try:
        with torch.no_grad():
            if last:
                logits = model.unembed(model.hidden(tokens, patches)[:, -1])
            else:
                logits = model.apply(tokens, patches)
    finally:
        model.cfg = cfg
    for h in hooks:
        h.remove()
    return logits, calls


def _forward_vs_decode(tag, label, model, tokens, patches, cache_len,
                       last=False, fed=None):
    """A forward (``_forward_no_drop``) against a token-by-token decode of
    the same tokens, at ``PREFILL_DECODE_REL_RMS`` (every position, or the
    last with ``last``); ``fed``, a decode already made (its logits and
    routing), stands for the first.  For a MoE model, first at its own
    routers -- the
    share of routing decisions the two paths made alike and the rel rms,
    printed: bf16 rounding that differs between the flash kernel and the
    decode's plain attention flips near ties of the top-k, and each flip
    swaps an expert -- then held with the routers pinned
    (``_pin_routers``)."""
    cfg = model.cfg
    batch, steps = tokens.shape

    def both(made=None):
        if made is None:
            out, calls, flash = _decode(model, tokens, patches, cache_len)
            if flash != (cfg.n_layers if patches is not None else 0):
                raise AssertionError(f"{cfg.name}: the decode path made "
                                     f"{flash} flash launches")
            made = (out, calls)
        full, pre_calls = _forward_no_drop(model, tokens, patches, last)
        return full, made[0][:, -1] if last else made[0], pre_calls, made[1]

    full, fed, pre_calls, fed_calls = both(fed)
    rel = _rel_rms(full, fed)
    if pre_calls:
        agree = _routing_agreement(pre_calls, fed_calls, batch, steps)
        log(f"[{tag}] {cfg.name} {label} own routers: forward (capacity "
            f"factor {_no_drop(cfg).moe_capacity_factor}) and decode routed "
            f"{100 * agree:.2f}% of (token, layer) decisions alike; rel rms "
            f"{rel:.3e} (information)")
        _pin_routers(model)
        full, fed, _, _ = both()
        rel = _rel_rms(full, fed)
    agree = float((full.argmax(-1) == fed.argmax(-1)).float().mean())
    log(f"[{tag}] {cfg.name} {label}: forward vs token-by-token decode"
        f"{' (routers pinned)' if pre_calls else ''}, "
        f"{'last' if last else 'all'} logits of {steps} tokens: rel rms "
        f"{rel:.3e} (limit {PREFILL_DECODE_REL_RMS}), max abs "
        f"{_max_err(full, fed):.3e}, argmax agreement {agree:.3f}")
    if not rel <= PREFILL_DECODE_REL_RMS:
        raise AssertionError(f"{cfg.name} {label}: forward and decode "
                             f"disagree: rel rms {rel:.3e}")


def _serve_full(tag, cfg, why, batch, seq, dev, card, prompt_len=64,
                new_tokens=16, flash=None):
    """One config at full width on the card: a prefill of batch x seq text
    tokens (after a VLM's patches) with every launch counter zeroed just
    before and read just after (``flash`` tensor-core flash launches --
    default one a layer -- and nothing else) and each MoE layer's dropped
    (token, choice) pairs,
    timed prefills, ``prefill_prefix`` of a VLM's patches (one flash launch
    a layer), a token-by-token decode of a 64-token prompt and 16 greedy
    tokens (no launch), and ``_forward_vs_decode`` on the prompt's last
    logits."""
    import torch
    from repro_torch.launch import serve, steps
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    prefill, model = steps.make_prefill_step(cfg, device=dev, generator=gen)
    _perturb_constants(model, gen)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers"
        + (f" (depth cut: {why})" if why else " (full depth)")
        + f" {cfg.block_pattern} / {cfg.ffn_pattern}, d {cfg.d_model}, "
        f"{cfg.n_heads} H / {cfg.n_kv_heads} KV, D {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, norm {cfg.norm}, qk_norm "
        f"{cfg.qk_norm}, qkv_bias {cfg.qkv_bias}, tied {cfg.tie_embeddings}, "
        f"window {cfg.window}, chunk {cfg.attn_chunk}, prefix "
        f"{cfg.prefix_tokens}, experts {cfg.moe_experts} top-"
        f"{cfg.moe_top_k} (d_ff {cfg.moe_d_ff}, capacity factor "
        f"{cfg.moe_capacity_factor}): {n_bytes / 1e9:.2f} GB of "
        f"{cfg.param_dtype_str} weights drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev)
    patches = _prefix(cfg, batch, gen, dev)
    batch_in = {"tokens": tokens}
    if patches is not None:
        batch_in["embeddings"] = patches
    routed, hooks = _record_routing(model)
    _reset_launches()
    t0 = time.perf_counter()
    logits = prefill(batch_in)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    for h in hooks:
        h.remove()
    want = {k: 0 for k in launches}
    flash = cfg.n_layers if flash is None else flash
    want.update(flash_attention=flash, flash_attention_wgmma=flash)
    if launches != want:
        raise AssertionError(f"{cfg.name} prefill launches {launches} != "
                             f"{want}")
    if tuple(logits.shape) != (batch, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill logits: shape "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if routed:
        log(f"[{tag}] {cfg.name} prefill at capacity factor "
            f"{cfg.moe_capacity_factor}: (token, choice) pairs dropped by "
            f"each MoE layer {[int((~r.keep).sum()) for r in routed]} of "
            f"{routed[0].keep.numel()} each")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        prefill(batch_in)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pre_s = sum(walls) / len(walls)
    p_len = cfg.prefix_tokens
    log(f"[{tag}] {cfg.name} prefill {batch} x ({p_len} + {seq}): flash "
        f"launches {launches['flash_attention_wgmma']} (tensor-core) of "
        f"{launches['flash_attention']}, linrec "
        f"{launches['linear_recurrence']}; {pre_s * 1e3:.2f} ms "
        f"({batch * (p_len + seq) / pre_s:.1f} tokens/s; runs "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; first "
        f"{first_s * 1e3:.2f} ms)")

    serve_step, _ = steps.make_serve_step(cfg, model=model)
    prompt = tokens[:, :prompt_len]
    cache = model.init_cache(batch, p_len + prompt_len + new_tokens)
    before = _launch_counts()
    if patches is not None:
        with torch.no_grad():
            cache = model.prefill_prefix(cache, patches)
        made = _launch_counts()["flash_attention_wgmma"] \
            - before["flash_attention_wgmma"]
        if made != cfg.n_layers:
            raise AssertionError(f"{cfg.name} prefill_prefix: {made} flash "
                                 f"launches, not {cfg.n_layers}")
        before = _launch_counts()
    fed_calls, hooks = _record_routing(model)
    t0 = time.perf_counter()
    feed_logits, cache = serve.prefill_into_cache(model, prompt, cache, p_len)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    tok = torch.argmax(feed_logits[:, -1, :], dim=-1,
                       keepdim=True).to(torch.int32)
    out, step_ms = [], []
    for i in range(new_tokens):
        t0 = time.perf_counter()
        tok, cache = serve_step(tok, cache, p_len + prompt_len + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok[:, 0])
    if _launch_counts() != before:
        raise AssertionError(f"{cfg.name}: the decode path launched a kernel")
    gen_tokens = torch.stack(out, dim=1)
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: tokens outside the vocabulary")
    decode_ms = statistics.mean(step_ms[1:])
    log(f"[{tag}] {cfg.name} decode {batch} requests: prompt of {prompt_len} "
        f"fed token by token from index {p_len} in {feed_s * 1e3:.2f} ms; "
        f"{new_tokens} greedy tokens at {decode_ms:.3f} ms/token (steps "
        f"2..{new_tokens}; first {step_ms[0]:.3f}); sample "
        f"{gen_tokens[0, :8].tolist()}")
    del cache
    _forward_vs_decode(tag, "full width", model, prompt, patches,
                       p_len + prompt_len, last=True,
                       fed=(feed_logits, fed_calls))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}] {cfg.name} peak device memory {peak / 1e9:.2f} GB on "
        f"{card}")
    if peak >= 80e9:
        raise AssertionError(f"{cfg.name}: peak memory {peak / 1e9:.2f} GB")
    del model, prefill, serve_step, logits, feed_logits
    torch.cuda.empty_cache()
    return dict(launches=launches["flash_attention_wgmma"],
                prefill_ms=pre_s * 1e3, decode_ms=decode_ms,
                peak_gb=peak / 1e9)


def _reduced_card_vs_cpu(tag, cfg, dev, seq):
    """A reduced config in float32 from the same (perturbed) weights on the
    card (kernels) and on the CPU (plain versions): the prefill's last
    logits, every position's logits and the MoE aux; then the card's
    forward against its own token-by-token decode
    (``_forward_vs_decode``'s path, held here at ``SUBSTRATE_TOL``: in
    float32 no routing flips).  ``seq`` spans several flash tiles (the
    window skip, several chunks of 32); B · seq stays within one MoE
    routing group."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models.transformer import Transformer
    gen = torch.Generator(device="cpu").manual_seed(3)
    cpu_model = Transformer(cfg, device="cpu", generator=gen)
    _perturb_constants(cpu_model, gen)
    card_model = Transformer(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen)
    patches = _prefix(cfg, 2, gen, "cpu")
    on_card = None if patches is None else patches.to(dev)
    batch_cpu = {"tokens": tokens}
    batch_card = {"tokens": tokens.to(dev)}
    if patches is not None:
        batch_cpu["embeddings"], batch_card["embeddings"] = patches, on_card
    last_cpu = steps.make_prefill_step(cfg, model=cpu_model)[0](batch_cpu)
    with torch.no_grad():
        full_cpu, aux_cpu = cpu_model.apply(tokens, patches, with_aux=True)
    _reset_launches()
    last_card = steps.make_prefill_step(cfg, model=card_model)[0](batch_card)
    with torch.no_grad():
        full_card, aux_card = card_model.apply(tokens.to(dev), on_card,
                                               with_aux=True)
    torch.cuda.synchronize()
    launches = _launch_counts()
    if (launches["flash_attention"], launches["flash_attention_wgmma"],
            launches["linear_recurrence"]) != (2 * cfg.n_layers, 0, 0):
        raise AssertionError(f"{cfg.name} card launches {launches}")
    decoded, _, flash = _decode(card_model, tokens.to(dev), on_card,
                                cfg.prefix_tokens + seq)
    if flash != (cfg.n_layers if patches is not None else 0):
        raise AssertionError(f"{cfg.name}: the decode path made {flash} "
                             f"flash launches")
    no_drop = full_card if not cfg.moe_experts else \
        _forward_no_drop(card_model, tokens.to(dev), on_card)[0]
    errs = []
    for name, got, want in (
            ("card vs cpu, last logits", last_card.cpu(), last_cpu),
            ("card vs cpu, all logits", full_card.cpu(), full_cpu),
            ("card vs cpu, aux", aux_card.cpu(), aux_cpu),
            ("card prefill vs card decode, all logits", no_drop, decoded)):
        _check_close(f"{cfg.name} {name}", got, want, **SUBSTRATE_TOL)
        errs.append(f"{name} {_max_err(got, want):.3e}")
    log(f"[{tag}] {cfg.name} (H {cfg.n_heads} / KV {cfg.n_kv_heads}, window "
        f"{cfg.window}, chunk {cfg.attn_chunk}, prefix {cfg.prefix_tokens}) "
        f"S={seq} fp32, max abs: {'; '.join(errs)} (atol "
        f"{SUBSTRATE_TOL['atol']}, rtol {SUBSTRATE_TOL['rtol']}): ok")


def _reduced_bf16(tag, cfg, dev, seq):
    """A reduced config in bfloat16 (d_head 64: the tensor-core flash
    kernel, one launch a layer): ``_forward_vs_decode`` over every
    position."""
    import torch
    from repro_torch.models.transformer import Transformer
    cfg = cfg.replace(compute_dtype_str="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(4)
    model = Transformer(cfg, device=dev, generator=gen)
    _perturb_constants(model, gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                           device=dev)
    patches = _prefix(cfg, 2, gen, dev)
    _reset_launches()
    with torch.no_grad():
        model.apply(tokens, patches)
    torch.cuda.synchronize()
    launches = _launch_counts()
    if (launches["flash_attention"], launches["flash_attention_wgmma"]) != \
            (cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"{cfg.name} bf16 card launches {launches}")
    _forward_vs_decode(tag, f"(KV {cfg.n_kv_heads}) bf16", model, tokens,
                       patches, cfg.prefix_tokens + seq)


# a float8 KV cache decode, card against CPU: each step's max abs gap
# over its largest logit (tests/test_torch_fp8_cache.py's bound against
# the reference: an fp8 rounding boundary can flip one cached value)
FP8_CACHE_REL = 2e-3


def _fp8_cache_card_vs_cpu(tag, dev, steps=12):
    """Reduced qwen3-8b with ``kv_cache_dtype_str="float8_e4m3fn"``: the
    same weights decode ``steps`` tokens on the card and on the CPU (an
    fp8 cache on both); each step's logits within ``FP8_CACHE_REL`` of its
    largest, and against the card's own compute-dtype cache."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    base = get_config("qwen3-8b").reduced()
    cfg = base.replace(kv_cache_dtype_str="float8_e4m3fn")
    gen = torch.Generator(device="cpu").manual_seed(8)
    cpu_model = Transformer(cfg, device="cpu", generator=gen)
    _perturb_constants(cpu_model, gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, steps), generator=gen)
    out = {}
    for name, c, d in (("cpu", cfg, "cpu"), ("card", cfg, dev),
                       ("card-f32", base, dev)):
        model = Transformer(c, device=d)
        model.load_state_dict(cpu_model.state_dict())
        cache = model.init_cache(2, steps)
        if cache["stage_0"]["0"]["k"].dtype != c.kv_cache_dtype:
            raise AssertionError(f"[{tag}] {name}: cache dtype")
        with torch.no_grad():
            out[name] = torch.stack([
                model.decode_step(tokens[:, i:i + 1].to(d), cache, i)[0][:, 0]
                .float().cpu() for i in range(steps)])
    gap = (out["card"] - out["cpu"]).abs().flatten(1).amax(1)
    rel = gap / out["cpu"].abs().flatten(1).amax(1)
    if not float(rel.max()) <= FP8_CACHE_REL:
        raise AssertionError(f"[{tag}] fp8 cache card vs cpu: {rel}")
    far = float((out["card"] - out["card-f32"]).abs().mean()
                / out["card-f32"].abs().mean())
    alike = float((out["card"].argmax(-1) == out["cpu"].argmax(-1))
                  .float().mean())
    log(f"[{tag}] {cfg.name} fp8 (e4m3fn) KV cache, {steps} decode steps: "
        f"card vs cpu worst step max abs / largest logit {float(rel.max()):.3e}"
        f" (bound {FP8_CACHE_REL}), greedy tokens alike {alike:.3f}; against "
        f"the card's float32 cache mean rel gap {far:.3e} (the reference's "
        f"bound 0.15)")


def phase_dense(dev, card):
    """The five dense decoders: each at full width (full depth, or the
    depth that fits 80 GB of fp32 weights) served on the card, one model
    at a time; then each reduced config, MHA and GQA (2 KV heads), card
    vs CPU in fp32 and prefill vs decode in bf16, and reduced qwen3-8b's
    decode with a float8 KV cache card vs CPU; then the flash kernel at
    each run's prefill shape, timed beside its bound and SDPA."""
    import torch
    from repro_torch.configs import get_config
    runs = {}
    for arch, depth, batch, seq, why in DENSE_RUNS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = cfg.replace(n_layers=depth)
        runs[arch] = _serve_full("dense", cfg, why, batch, seq, dev, card)
    for arch, *_ in DENSE_RUNS:
        for kv in (None, 2):
            cfg = get_config(arch).reduced()
            if kv is not None:
                cfg = cfg.replace(n_kv_heads=kv)
            _reduced_card_vs_cpu("dense", cfg, dev, 300)
        _reduced_bf16("dense", get_config(arch).reduced().replace(
            n_kv_heads=2), dev, 300)
    _fp8_cache_card_vs_cpu("dense", dev)
    shapes = []
    for i, shape in enumerate(DENSE_FLASH):
        err, ms_k, ms_p, b_ms, b_by, lib_ms = compare_flash(
            *shape, torch.bfloat16, 70 + 3 * i, dev, library=True)
        shapes.append({"shape": list(shape), "max_abs_err": err, "ms": ms_k,
                       "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib_ms})
        torch.cuda.empty_cache()
    total = sum(r["launches"] for r in runs.values())
    summary = "; ".join(
        f"{a} prefill {r['prefill_ms']:.2f} ms, decode {r['decode_ms']:.3f} "
        f"ms/token, peak {r['peak_gb']:.2f} GB" for a, r in runs.items())
    log(f"[dense] flash launches over the five prefills: {total}; "
        f"{summary}; card {card}")
    return {"flash_attention": total}, shapes


# ---------------------------------------------------------------------------
# The prefix-LM and MoE decoders: paligemma-3b, grok-1-314b, llama4-maverick
# ---------------------------------------------------------------------------

# (arch, layers run -- None for the config's own --, batch, text length,
# why the depth is cut).  paligemma's 18 layers are 10.0 GB of fp32
# weights; grok's 64 would be ~633 GB of bf16 (9.84 GB a layer) and
# llama4's 48 some 789 GB, so those two run at full width with 4 layers:
# llama4's one pattern unit (3 chunked + 1 global NoPE; FFNs dense, MoE,
# dense, MoE; 69.6 GB), on one sequence of two 8192-token chunks
VLM_MOE_RUNS = [
    ("paligemma-3b", None, 2, 4096, ""),
    ("grok-1-314b", 4, 2, 4096,
     "64 layers are ~633 GB of bf16 weights, 9.84 GB a layer"),
    ("llama4-maverick-400b-a17b", 4, 1, 16384,
     "one pattern unit of 48 layers; its two MoE layers are 32.2 GB each"),
]
# the flash kernel at each run's prefill shapes, bf16: (B, S, H, KV, D,
# prefix_len, chunk) -- MQA at D = 256 with a 256-token prefix, GQA groups
# 6 and 5, a chunk boundary inside the sequence
VLM_MOE_FLASH = [
    (2, 4352, 8, 1, 256, 256, 0),        # paligemma-3b
    (2, 4096, 48, 8, 128, 0, 0),         # grok-1-314b
    (1, 16384, 40, 8, 128, 0, 8192),     # llama4-maverick, chunked layers
    (1, 16384, 40, 8, 128, 0, 0),        # llama4-maverick, the NoPE layer
]


def phase_vlm_moe(dev, card):
    """paligemma-3b, grok-1-314b and llama4-maverick: each at full width
    (paligemma at full depth, the MoE configs at 4 layers) served on the
    card, one model at a time; each reduced config, as ``reduced()`` and
    with 2 KV heads, card vs CPU in fp32 and prefill vs decode in fp32 and
    bf16; then the flash kernel at the four prefill shapes, timed beside
    its bound and SDPA."""
    import torch
    from repro_torch.configs import get_config
    runs = {}
    for arch, depth, batch, seq, why in VLM_MOE_RUNS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = cfg.replace(n_layers=depth)
        runs[arch] = _serve_full("vlm-moe", cfg, why, batch, seq, dev, card)
    for arch, *_ in VLM_MOE_RUNS:
        # B · S within one routing group of 512 for the MoE configs
        seq = 300 if arch == "paligemma-3b" else 250
        for kv in (None, 2):
            cfg = get_config(arch).reduced()
            if kv is not None:
                cfg = cfg.replace(n_kv_heads=kv)
            _reduced_card_vs_cpu("vlm-moe", cfg, dev, seq)
        _reduced_bf16("vlm-moe", get_config(arch).reduced().replace(
            n_kv_heads=2), dev, seq)
    shapes = []
    for i, (b, s, h, kv, d, prefix, chunk) in enumerate(VLM_MOE_FLASH):
        err, ms_k, ms_p, b_ms, b_by, lib_ms = compare_flash(
            b, s, h, kv, d, True, 0, torch.bfloat16, 110 + 3 * i, dev,
            library=True, prefix_len=prefix, chunk=chunk)
        shapes.append({"shape": [b, s, h, kv, d], "prefix_len": prefix,
                       "chunk": chunk, "max_abs_err": err, "ms": ms_k,
                       "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib_ms})
        torch.cuda.empty_cache()
    total = sum(r["launches"] for r in runs.values())
    summary = "; ".join(
        f"{a} prefill {r['prefill_ms']:.2f} ms, decode {r['decode_ms']:.3f} "
        f"ms/token, peak {r['peak_gb']:.2f} GB" for a, r in runs.items())
    log(f"[vlm-moe] flash launches over the three prefills: {total}; "
        f"{summary}; card {card}")
    return {"flash_attention": total}, shapes


# ---------------------------------------------------------------------------
# xLSTM and the encoder-decoder: xlstm-125m, whisper-large-v3
# ---------------------------------------------------------------------------

# whisper's text context: the decoder tokens of one teacher-forced apply
WHISPER_TEXT = 448
# the flash kernel at whisper-large-v3's three attention shapes, bf16 at 2
# requests: (B, S_q, S_kv, H, KV, D, causal)
ENCDEC_FLASH = [
    (2, 1500, 1500, 20, 20, 64, False),  # the encoder over its frames
    (2, 448, 448, 20, 20, 64, True),     # decoder self-attention
    (2, 448, 1500, 20, 20, 64, False),   # cross-attention over the frames
]
# full attention over a key length of its own at both kernels' edges (128
# query rows a block and 64 keys a tile; 64 and 64): (B, S_q, S_kv, H, KV,
# D) -- one query; whisper's 448 tokens over 1500 frames (1500 = 23 · 64 +
# 28); fewer keys than queries, group 2; ragged both ways, MQA at D = 256;
# fewer keys than one tile
KV_LENGTH_EDGES = [
    (1, 1, 1500, 4, 4, 64),
    (2, 448, 1500, 20, 20, 64),
    (1, 100, 64, 4, 2, 128),
    (1, 300, 333, 8, 1, 256),
    (1, 1500, 7, 4, 4, 64),
]


def _frames(cfg, batch, gen, dev):
    """Stub frame embeddings (B, F, d) in the compute dtype, or None."""
    import torch
    if not cfg.encoder_layers:
        return None
    return torch.randn((batch, cfg.stub_frames, cfg.d_model), generator=gen,
                       device=gen.device).to(dev).to(cfg.compute_dtype)


def _xe_decode(model, tokens, frames):
    """Every step's logits (B, S, V) of a token-by-token decode of
    ``tokens`` from index 0 (after ``prefill_cross`` of an encoder-decoder's
    frames), and the launches of the decode steps alone (none expected)."""
    import torch
    with torch.no_grad():
        if frames is None:
            cache = model.init_cache(tokens.shape[0], tokens.shape[1])
        else:
            cache = model.prefill_cross(
                model.init_cache(tokens.shape[0], tokens.shape[1],
                                 frames.shape[1]), frames)
        before = _launch_counts()
        logits = torch.cat([model.decode_step(tokens[:, i:i + 1], cache,
                                              i)[0]
                            for i in range(tokens.shape[1])], dim=1)
    after = _launch_counts()
    return logits, {k: after[k] - before[k] for k in after}


def _xe_want(cfg, wgmma):
    """The launches of one ``apply``: for an encoder-decoder one flash a
    layer of the encoder and two a decoder layer (its causal
    self-attention and its cross-attention), ``wgmma`` of them on the
    tensor-core kernel; none for xLSTM, whose scans are plain."""
    from repro_torch.kernels import hfl_ops, seq_ops
    want = {k: 0 for k in {**hfl_ops.LAUNCHES, **seq_ops.LAUNCHES}}
    if cfg.encoder_layers:
        n = cfg.encoder_layers + 2 * cfg.n_layers
        want.update(flash_attention=n, flash_attention_wgmma=n if wgmma else 0)
    return want


def _xe_reduced(cfg, dev, seq):
    """A reduced config from the same (perturbed) weights in float32 on
    the card (kernels) and on the CPU (plain versions): every position's
    logits; the card's forward against its own token-by-token decode; both
    at ``SUBSTRATE_TOL``.  Then the same config in bfloat16 (D = 64: the
    tensor-core flash kernel) forward vs decode at
    ``PREFILL_DECODE_REL_RMS``."""
    import torch
    from repro_torch.models import build_model
    gen = torch.Generator(device="cpu").manual_seed(3)
    cpu_model = build_model(cfg, device="cpu", generator=gen)
    _perturb_constants(cpu_model, gen)
    card_model = build_model(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen)
    frames = _frames(cfg, 2, gen, "cpu")
    on_card = None if frames is None else frames.to(dev)
    with torch.no_grad():
        full_cpu = cpu_model.apply(tokens, frames)
        _reset_launches()
        full_card = card_model.apply(tokens.to(dev), on_card)
    torch.cuda.synchronize()
    if _launch_counts() != _xe_want(cfg, False):
        raise AssertionError(f"{cfg.name} card launches {_launch_counts()}")
    decoded, made = _xe_decode(card_model, tokens.to(dev), on_card)
    if any(made.values()):
        raise AssertionError(f"{cfg.name}: the decode path launched {made}")
    errs = []
    for name, got, want in (
            ("card vs cpu, all logits", full_card.cpu(), full_cpu),
            ("card prefill vs card decode, all logits", full_card, decoded)):
        _check_close(f"{cfg.name} {name}", got, want, **SUBSTRATE_TOL)
        errs.append(f"{name} {_max_err(got, want):.3e}")
    del cpu_model, card_model
    bf = cfg.replace(compute_dtype_str="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(4)
    model = build_model(bf, device=dev, generator=gen)
    _perturb_constants(model, gen)
    tokens = torch.randint(0, bf.vocab_size, (2, seq), generator=gen,
                           device=dev)
    frames = _frames(bf, 2, gen, dev)
    with torch.no_grad():
        _reset_launches()
        full = model.apply(tokens, frames)
    torch.cuda.synchronize()
    if _launch_counts() != _xe_want(bf, True):
        raise AssertionError(f"{cfg.name} bf16 launches {_launch_counts()}")
    decoded, made = _xe_decode(model, tokens, frames)
    if any(made.values()):
        raise AssertionError(f"{cfg.name}: the decode path launched {made}")
    rel = _rel_rms(full, decoded)
    log(f"[xlstm-encdec] {cfg.name} (H {cfg.n_heads} / KV {cfg.n_kv_heads}, "
        f"frames {cfg.stub_frames}) S={seq}: fp32 max abs: "
        f"{'; '.join(errs)} (atol {SUBSTRATE_TOL['atol']}, rtol "
        f"{SUBSTRATE_TOL['rtol']}); bf16 forward vs decode rel rms "
        f"{rel:.3e} (limit {PREFILL_DECODE_REL_RMS}): ok")
    if not rel <= PREFILL_DECODE_REL_RMS:
        raise AssertionError(f"{cfg.name} bf16: forward and decode disagree: "
                             f"rel rms {rel:.3e}")


def _serve_whisper(dev, card, batch=2, prompt_len=64, new_tokens=16):
    """whisper-large-v3 at full size on the card (fp32 weights drawn from a
    seeded generator, bf16 compute, LayerNorm and every bias redrawn):
    ``prefill_cross`` of 1500 stub frames (one tensor-core flash a
    encoder layer), a teacher-forced ``apply`` over 448 tokens (an encoder
    layer one, a decoder layer two: causal self-attention and
    cross-attention of 448 queries over 1500 frames; nothing else), each
    with every launch counter zeroed just before and read just after;
    timed prefill steps; a token-by-token decode of a 64-token prompt from
    index 0 and 16 greedy tokens (no launch); the apply's logits at the
    prompt's last position against the decode's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    cfg = get_config("whisper-large-v3")
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    prefill, model = steps.make_prefill_step(cfg, device=dev, generator=gen)
    _perturb_constants(model, gen)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"[xlstm-encdec] {cfg.name}: {cfg.encoder_layers} + {cfg.n_layers} "
        f"layers (full depth), d {cfg.d_model}, {cfg.n_heads} H / "
        f"{cfg.n_kv_heads} KV, D {cfg.d_head}, d_ff {cfg.d_ff} (gelu, "
        f"biased), vocab {cfg.vocab_size}, {cfg.stub_frames} frames: "
        f"{n_par / 1e9:.3f} B parameters, {4 * n_par / 1e9:.2f} GB of fp32 "
        f"weights drawn in {time.perf_counter() - t0:.2f} s")
    frames = _frames(cfg, batch, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, WHISPER_TEXT),
                           generator=gen, device=dev)
    want = _xe_want(cfg, True)
    _reset_launches()
    with torch.no_grad():
        model.prefill_cross(model.init_cache(batch, prompt_len + new_tokens),
                            frames)
    torch.cuda.synchronize()
    cross = _launch_counts()
    if cross != {**want, "flash_attention": cfg.encoder_layers,
                 "flash_attention_wgmma": cfg.encoder_layers}:
        raise AssertionError(f"{cfg.name} prefill_cross launches {cross}")
    _reset_launches()
    with torch.no_grad():
        logits = model.apply(tokens, frames)
    torch.cuda.synchronize()
    launches = _launch_counts()
    if launches != want:
        raise AssertionError(f"{cfg.name} apply launches {launches} != "
                             f"{want}")
    if tuple(logits.shape) != (batch, WHISPER_TEXT, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} apply logits: shape "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    batch_in = {"tokens": tokens, "embeddings": frames}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(batch_in)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pre_s = sum(walls[1:]) / 2
    log(f"[xlstm-encdec] {cfg.name} prefill_cross: flash launches "
        f"{cross['flash_attention_wgmma']} (tensor-core) of "
        f"{cross['flash_attention']}; apply {batch} x ({cfg.stub_frames} "
        f"frames + {WHISPER_TEXT} tokens): {launches['flash_attention_wgmma']}"
        f" (tensor-core) of {launches['flash_attention']}, nothing else; "
        f"prefill step {pre_s * 1e3:.2f} ms ({batch * WHISPER_TEXT / pre_s:.1f}"
        f" tokens/s; runs {', '.join(f'{w * 1e3:.2f}' for w in walls[1:])} "
        f"ms; first {walls[0] * 1e3:.2f} ms)")

    serve_step, _ = steps.make_serve_step(cfg, model=model)
    prompt = tokens[:, :prompt_len]
    with torch.no_grad():
        cache = model.prefill_cross(
            model.init_cache(batch, prompt_len + new_tokens), frames)
    before = _launch_counts()
    t0 = time.perf_counter()
    feed_logits, cache = serve.prefill_into_cache(model, prompt, cache)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    tok = torch.argmax(feed_logits[:, -1, :], dim=-1,
                       keepdim=True).to(torch.int32)
    out, step_ms = [], []
    for i in range(new_tokens):
        t0 = time.perf_counter()
        tok, cache = serve_step(tok, cache, prompt_len + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok[:, 0])
    if _launch_counts() != before:
        raise AssertionError(f"{cfg.name}: the decode path launched a kernel")
    gen_tokens = torch.stack(out, dim=1)
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: tokens outside the vocabulary")
    decode_ms = statistics.mean(step_ms[1:])
    with torch.no_grad():
        full = model.apply(prompt, frames)[:, -1]
    rel = _rel_rms(full, feed_logits[:, -1])
    agree = float((full.argmax(-1) == feed_logits[:, -1].argmax(-1))
                  .float().mean())
    log(f"[xlstm-encdec] {cfg.name} decode {batch} requests: prompt of "
        f"{prompt_len} fed token by token from index 0 in "
        f"{feed_s * 1e3:.2f} ms; {new_tokens} greedy tokens at "
        f"{decode_ms:.3f} ms/token (steps 2..{new_tokens}; first "
        f"{step_ms[0]:.3f}); sample {gen_tokens[0, :8].tolist()}; apply vs "
        f"decode, last logits of {prompt_len} tokens: rel rms {rel:.3e} "
        f"(limit {PREFILL_DECODE_REL_RMS}), argmax agreement {agree:.3f}")
    if not rel <= PREFILL_DECODE_REL_RMS:
        raise AssertionError(f"{cfg.name}: apply and decode disagree: rel rms "
                             f"{rel:.3e}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[xlstm-encdec] {cfg.name} peak device memory {peak / 1e9:.2f} GB "
        f"on {card}")
    if peak >= 80e9:
        raise AssertionError(f"{cfg.name}: peak memory {peak / 1e9:.2f} GB")
    del model, prefill, serve_step, cache
    torch.cuda.empty_cache()
    return dict(launches=launches, cross=cross["flash_attention_wgmma"],
                prefill_ms=pre_s * 1e3, decode_ms=decode_ms,
                peak_gb=peak / 1e9)


def phase_xlstm_encdec(dev, card):
    """xlstm-125m and whisper-large-v3 at full size on the card, one at a
    time: xLSTM's prefill (no kernel launch: its scans are plain),
    decode and prefill vs decode (``_serve_full``); whisper
    (``_serve_whisper``); each reduced config (whisper also with 2 KV
    heads) card vs CPU in fp32 and prefill vs decode in fp32 and bf16
    (``_xe_reduced``); the flash kernels with a key length of their own at
    their edges in bf16 and fp32, and refusing a causal call with two
    lengths; the flash kernel at whisper's three shapes, timed beside its
    bound and SDPA.  Returns the launches of the two full-size prefills
    (xLSTM's, whisper's ``apply``) and the three shapes' readings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import seq_ops
    xl = _serve_full("xlstm-encdec", get_config("xlstm-125m"), "", 2, 1024,
                     dev, card, flash=0)
    wh = _serve_whisper(dev, card)
    for arch, kv in (("xlstm-125m", None), ("whisper-large-v3", None),
                     ("whisper-large-v3", 2)):
        cfg = get_config(arch).reduced()
        if kv is not None:
            cfg = cfg.replace(n_kv_heads=kv)
        _xe_reduced(cfg, dev, 300 if arch == "xlstm-125m" else 200)
    for i, (b, s_q, s_kv, h, kv, d) in enumerate(KV_LENGTH_EDGES):
        for dtype in (torch.bfloat16, torch.float32):
            compare_flash(b, s_q, h, kv, d, False, 0, dtype, 130 + 3 * i, dev,
                          timed=False, s_kv=s_kv)
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((1, 12, 2, 64), device=dev, dtype=torch.bfloat16)
    try:
        seq_ops.flash_attention(q, k, k, causal=True)
    except ValueError as e:
        log(f"[xlstm-encdec] a causal call with S_q 8 and S_kv 12 raises: {e}")
    else:
        raise AssertionError("a causal flash call with two lengths ran")
    shapes = []
    for i, (b, s_q, s_kv, h, kv, d, causal) in enumerate(ENCDEC_FLASH):
        err, ms_k, ms_p, b_ms, b_by, lib_ms = compare_flash(
            b, s_q, h, kv, d, causal, 0, torch.bfloat16, 150 + 3 * i, dev,
            library=True, s_kv=s_kv)
        shapes.append({"shape": [b, s_q, h, kv, d], "s_kv": s_kv,
                       "causal": causal, "max_abs_err": err, "ms": ms_k,
                       "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib_ms})
        torch.cuda.empty_cache()
    log(f"[xlstm-encdec] xlstm-125m prefill {xl['prefill_ms']:.2f} ms, "
        f"decode {xl['decode_ms']:.3f} ms/token, peak {xl['peak_gb']:.2f} "
        f"GB, flash launches {xl['launches']}; whisper-large-v3 prefill "
        f"{wh['prefill_ms']:.2f} ms, decode {wh['decode_ms']:.3f} ms/token, "
        f"peak {wh['peak_gb']:.2f} GB, flash launches prefill_cross "
        f"{wh['cross']}, apply {wh['launches']['flash_attention_wgmma']}; "
        f"card {card}")
    return wh["launches"], shapes


# ---------------------------------------------------------------------------
# [train]: the substrate's training path
# ---------------------------------------------------------------------------

# (arch, layers kept (None: all), batch, text tokens, train steps, why,
# remat off beside on, a longer sequence): full width, one model at a
# time, each with its config's remat on; recurrentgemma's depth cut to one
# (rec, rec, swa) unit (its 256,000-token table alone is 1.05 B
# parameters, 16.8 GB with gradients and Adam), whisper's 448 tokens
# after 1500 stub frames; xLSTM's host-bound step loop at 2 x 128 and 2
# steps (a remat'd 2 x 128 step takes 5.7-6.4 s of host time, the loop
# run again in the recompute; more would put the script past 700 s)
TRAIN_RUNS = [
    ("stablelm-1.6b", None, 2, 2048, 4, "full size", True, 4096),
    ("recurrentgemma-9b", 3, 2, 2048, 4, "full width, one (rec, rec, swa) "
                                         "unit of 38 layers", True, None),
    ("xlstm-125m", None, 2, 128, 2, "full size", False, None),
    ("whisper-large-v3", None, 2, 448, 4, "full size, 1500 frames", False,
     None),
]
# AdamW's learning rate at full width: at the default 3e-4 the first steps
# from random weights overshoot (stablelm-1.6b: 12.12, 14.53, 16.05, 12.99
# on one repeated batch), far below it Adam's ~lr·sign(g) moves descend
TRAIN_LR = 1e-5
# one reduced config per mixer kind, card (kernels, Functions) vs CPU
# (plain versions), float32
TRAIN_KINDS = {"attention": "stablelm-1.6b", "rec": "recurrentgemma-9b",
               "xlstm": "xlstm-125m", "moe": "grok-1-314b",
               "prefix-lm": "paligemma-3b", "encdec": "whisper-large-v3"}
# the CPU tests' bounds against jax.grad (tests/test_torch_train.py): the
# loss rtol 1e-5; a gradient leaf max|Δ| ≤ 1e-4·max|g_cpu| + 1e-6; after
# one step at lr 1e-2 the weights within the reference's Adam-sign bound
# (tests/test_arch_smoke.py: max 2.5e-2, a leaf's mean 2e-3)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LEAF_REL, TRAIN_LEAF_ABS = 1e-4, 1e-6
TRAIN_STEP_ATOL, TRAIN_STEP_MEAN = 2.5e-2, 2e-3
# the adjoint recurrence (the kernel, run backwards) against autograd
# through the plain step loop: float32 rounds the product λ·a·h in
# another order than autograd's (λ·h)·a; bfloat16 inputs at one bf16 ulp
LINREC_GRAD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
                   "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
# (B, S, C, dtype): C odd and not a multiple of the 32-channel block, S
# not a multiple of the 32-step tile, bf16 rows of odd C
LINREC_GRAD_EDGES = [(1, 77, 130, "float32"), (2, 33, 13, "bfloat16"),
                     (1, 300, 20, "float32"), (3, 45, 7, "float32")]
# flash's Function against autograd of attention_plain, every mask kind
# and the two lengths: (B, S, S_kv, H, KV, D, mask)
FLASH_GRAD_CASES = [
    (2, 300, 300, 8, 2, 64, dict(causal=True)),
    (1, 333, 333, 4, 1, 256, dict(causal=True, window=100)),
    (1, 200, 200, 4, 4, 64, dict(causal=False, window=50)),
    (2, 300, 300, 8, 1, 128, dict(causal=True, prefix_len=77)),
    (1, 333, 333, 10, 2, 128, dict(causal=True, chunk=100)),
    (2, 448, 1500, 4, 4, 64, dict(causal=False)),
]


def _train_want(cfg):
    """The exact launches of one train step: one flash forward an
    attention layer (an encoder-decoder: an encoder layer's one, a decoder
    layer's two), all on the tensor-core kernel in bf16 at its head dims,
    and a recurrence forward and its adjoint a ``rec`` layer; with
    ``cfg.remat`` the backward recomputes each unit's forward, so every
    forward launch happens twice (an attention layer 2 flash, a ``rec``
    layer 3 recurrence launches)."""
    from repro_torch.kernels import seq_ops
    from repro_torch.models.transformer import ATTENTION_KINDS
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.n_layers)]
    flash = cfg.encoder_layers + 2 * cfg.n_layers if cfg.encoder_layers \
        else sum(k in ATTENTION_KINDS for k in kinds)
    wgmma = flash if seq_ops.flash_route(cfg.compute_dtype, cfg.d_head) \
        == "seq_flash_attention_wgmma" else 0
    fwd = 2 if cfg.remat else 1
    return {"flash_attention": fwd * flash,
            "flash_attention_wgmma": fwd * wgmma,
            "linear_recurrence": (fwd + 1) * kinds.count("rec")}


def _seq_launches():
    counts = _launch_counts()
    return {k: counts[k] for k in ("flash_attention", "flash_attention_wgmma",
                                   "linear_recurrence")}


def _train_batch(cfg, batch, seq, seed, gen, dev):
    """A token batch (``data.tokens.token_batches``, seeded numpy) on the
    card, with whisper's stub frames or a VLM's patches drawn from
    ``gen``."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import token_batches
    b = next(token_batches(np.random.default_rng(seed), vocab=cfg.vocab_size,
                           batch=batch, seq_len=seq, n_batches=1))
    out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    n = cfg.prefix_tokens or cfg.stub_frames
    if n:
        out["embeddings"] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                        device=dev).to(cfg.compute_dtype)
    return out


def _finite_grads(label, grads):
    import torch
    missing = [k for k, g in grads.items() if g is None]
    if missing:
        raise AssertionError(f"{label}: no gradient for {missing[:5]} "
                             f"({len(missing)} parameters)")
    finite = torch.stack([torch.isfinite(g).all() for g in grads.values()])
    if not bool(finite.all()):
        bad = [k for k, ok in zip(grads, finite.tolist()) if not ok]
        raise AssertionError(f"{label}: non-finite gradients in {bad[:5]}")


def _flash_train_ms(b, s, s_kv, h, kv, d, mask, dev):
    """The flash Function at a training shape in bf16: forward (the
    kernel) and backward (the recompute through ``attention_plain``) ms,
    each beside its bound -- 4·D flops an allowed (query, key) pair and
    head forward, 10·D backward, at the bf16 peak; bytes q, k, v read and
    o written forward, q, k, v, do read and dq, dk, dv written
    backward."""
    import torch
    from repro_torch.kernels import seq_ops
    bf16 = torch.bfloat16
    q = _seq_inputs((b, s, h, d), bf16, 1, dev).requires_grad_()
    k = _seq_inputs((b, s_kv, kv, d), bf16, 2, dev).requires_grad_()
    v = _seq_inputs((b, s_kv, kv, d), bf16, 3, dev).requires_grad_()
    g = _seq_inputs((b, s, h, d), bf16, 4, dev)
    out = seq_ops.flash_attention(q, k, v, **mask)
    fwd = time_ms(lambda: seq_ops.flash_attention(q, k, v, **mask))
    bwd = time_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                              retain_graph=True),
                  min_iters=2, budget_s=0.3)
    pairs = float(seq_ops.attention_mask(s, dev, s_kv=s_kv, **mask).sum())
    qo = 2 * b * s * h * d
    kvb = 2 * b * s_kv * kv * d
    fwd_bound = bound_ms(2 * qo + 2 * kvb, 4.0 * b * h * pairs * d,
                         PEAK_BF16_FLOPS)
    bwd_bound = bound_ms(3 * qo + 4 * kvb, 10.0 * b * h * pairs * d,
                         PEAK_BF16_FLOPS)
    del out
    torch.cuda.empty_cache()
    return {"shape": [b, s, h, kv, d], "s_kv": s_kv,
            "mask": {k_: v_ for k_, v_ in mask.items() if v_},
            "fwd_ms": fwd, "fwd_bound_ms": fwd_bound[0],
            "fwd_bound_by": fwd_bound[1], "bwd_ms": bwd,
            "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1]}


def _train_lg(model, data, dev, want, label):
    """``loss_and_grads`` with the launch counters zeroed just before and
    read just after (exactly ``want``) and the peak memory reset just
    before and read just after: (loss, grads, peak GB, ms)."""
    import torch
    from repro_torch.launch import steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    t0 = time.perf_counter()
    loss, grads = steps.loss_and_grads(model, data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = _seq_launches()
    if got != want:
        raise AssertionError(f"{label}: loss_and_grads launched {got}, "
                             f"expected {want}")
    _finite_grads(label, grads)
    return loss, grads, torch.cuda.max_memory_allocated(dev) / 1e9, ms


def _train_step(step_fn, opt_state, step, data, dev, want, label):
    """One train step with the launch counters zeroed just before and read
    just after (exactly ``want``) and the peak memory reset just before:
    (opt_state, step, loss, wall s, peak GB); the loss's ``float`` waits
    for the whole step, the update included."""
    import torch
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    t0 = time.perf_counter()
    opt_state, step, m = step_fn(opt_state, step, data)
    loss = float(m["loss"])
    wall = time.perf_counter() - t0
    got = _seq_launches()
    if got != want:
        raise AssertionError(f"{label}: train step {step} launched {got}, "
                             f"expected {want}")
    return opt_state, step, loss, wall, \
        torch.cuda.max_memory_allocated(dev) / 1e9


def _max_grad_gap(got, held):
    """max |got - held| over every gradient."""
    return max(float((got[k] - held[k]).abs().max()) for k in held)


def _score_bytes(cfg, batch, seq):
    """The float32 (B, H, S, S) tensors the plain flash backward holds at
    once, counted as four (scores, probabilities and their gradients)."""
    return 4.0 * batch * cfg.n_heads * seq * seq * 4


def _remat_off_grads(cfg, model, data, dev, grads_on, base):
    """The remat-off ``loss_and_grads`` on the same weights as the remat-on
    call whose gradients ``grads_on`` it is given: (loss, peak GB, the
    gradients' max abs gap to remat on, and, where there is a gap, remat
    off run twice's own gap, telling the backward's spread from the
    recompute's).  The held gradients stay on the card, so the peak
    reported is the one read less the bytes allocated past ``base`` (GB,
    read before the remat-on call) when the call starts: what the call
    alone reaches.  ``model.cfg`` is swapped and restored."""
    import torch
    off = cfg.replace(remat=False)
    want = _train_want(off)
    held = torch.cuda.memory_allocated(dev) / 1e9 - base
    model.cfg = off
    try:
        loss, grads, peak, _ = _train_lg(model, data, dev, want,
                                         f"{cfg.name} remat off")
        gap = _max_grad_gap(grads, grads_on)
        repeat = None
        if gap:
            _, again, _, _ = _train_lg(model, data, dev, want,
                                       f"{cfg.name} remat off again")
            repeat = _max_grad_gap(again, grads)
    finally:
        model.cfg = cfg
    return float(loss), peak - held, gap, repeat


def _train_long(cfg, model, step_fn, opt_state, step, gen, batch, seq, seq2,
                ab, dev, card):
    """The same model at ``batch`` x ``seq2`` with remat on: its
    ``loss_and_grads`` peak and two train steps (ms, whole-step peak).
    The remat-off ``loss_and_grads`` peak there is estimated from the
    ``seq`` A/B before the run -- the weights and moments, the
    activations scaled by seq2 / seq, the plain flash backward's (B, H,
    S, S) float32 tensors (``_score_bytes``) by its square -- and remat
    off runs only if that estimate, or the remat-off whole-step peak at
    ``seq`` if larger, leaves 10 GB of the card free."""
    import torch
    data = _train_batch(cfg, batch, seq2, 11, gen, dev)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    r = seq2 / seq
    t_seq = _score_bytes(cfg, batch, seq) / 1e9
    act = ab["lg_peak_off_gb"] - ab["base_gb"]
    est = ab["base_gb"] + r * (act - t_seq) + r * r * t_seq
    off_step = ab["step_peak_off_gb"]
    need = max(est, off_step)
    run_off = total - need >= 10.0
    log(f"[train] {cfg.name} {batch} x {seq2}: estimated remat-off "
        f"loss_and_grads peak {est:.2f} GB (weights and moments "
        f"{ab['base_gb']:.2f} + {r:g} x {act - t_seq:.2f} GB of "
        f"activations + {r * r:g} x {t_seq:.2f} GB of flash-backward "
        f"scores, from the {batch} x {seq} run), remat-off whole step at "
        f"{seq} {off_step:.2f} GB, card {total:.2f} GB: "
        + ("remat off runs" if run_off else
           "less than 10 GB free, remat off does not run"))
    out = {"seq": seq2, "est_lg_peak_off_gb": est, "card_gb": total}
    modes = ("on", "off") if run_off else ("on",)
    off = cfg.replace(remat=False)
    for mode in modes:
        model.cfg = off if mode == "off" else cfg
        try:
            want = _train_want(model.cfg)
            loss, grads, lg_peak, lg_ms = _train_lg(
                model, data, dev, want, f"{cfg.name} {seq2} remat {mode}")
            del grads
            walls, peaks = [], []
            for _ in range(2):
                opt_state, step, _, wall, peak = _train_step(
                    step_fn, opt_state, step, data, dev, want,
                    f"{cfg.name} {seq2} remat {mode}")
                walls.append(wall)
                peaks.append(peak)
        finally:
            model.cfg = cfg
        log(f"[train] {cfg.name} {batch} x {seq2} remat {mode}: launches a "
            f"step {want}; loss {float(loss):.4f}; loss_and_grads "
            f"{lg_ms:.1f} ms, peak {lg_peak:.2f} GB; train steps "
            + ", ".join(f"{w * 1e3:.1f}" for w in walls)
            + f" ms, whole-step peak {max(peaks):.2f} GB; {card}")
        out[mode] = {"lg_peak_gb": lg_peak, "lg_ms": lg_ms,
                     "step_ms": [w * 1e3 for w in walls],
                     "step_peak_gb": max(peaks)}
    return out


def _train_full(arch, layers, batch, seq, n_steps, why, dev, card,
                ab=False, seq2=None):
    """One model at full width on the card, with its config's remat on: a
    ``loss_and_grads`` call and ``n_steps`` train steps on one batch,
    each with the launch counters zeroed just before and read just after
    (exactly ``_train_want``); every parameter's gradient present and
    finite; the loss falling; steps/s, tokens/s and the peak memory (≤ 80
    GB).  With ``ab`` also remat off on the same weights
    (``_remat_off_grads``, before the steps) and train steps in turns
    off, off, on after them: ms a step, the ``loss_and_grads`` peak and
    the whole step's each way, and the gradients' gap; with ``seq2`` then
    the longer sequence (``_train_long``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: the full config has remat off")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=gen)
    _perturb_constants(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    step_fn, model, opt = steps.make_train_step(cfg, lr=TRAIN_LR,
                                                model=model)
    opt_state = opt.init(dict(model.named_parameters()))
    data = _train_batch(cfg, batch, seq, 7, gen, dev)
    torch.cuda.synchronize()
    log(f"[train] {cfg.name} ({why}): {cfg.n_layers} layers, {n_params} "
        f"params ({n_params * 16 / 1e9:.2f} GB of fp32 weights, gradients "
        f"and Adam moments) built in {time.perf_counter() - t0:.2f} s; "
        f"batch {batch} x {seq}; remat on")
    want = _train_want(cfg)
    base = torch.cuda.memory_allocated(dev) / 1e9
    loss0, grads, lg_peak, lg_ms = _train_lg(model, data, dev, want,
                                             cfg.name)
    if ab:
        loss_off, lg_off, gap, repeat = _remat_off_grads(cfg, model, data,
                                                         dev, grads, base)
    del grads
    losses, walls, peaks, step = [], [], [], 0
    for i in range(n_steps):
        opt_state, step, loss, wall, peak = _train_step(
            step_fn, opt_state, step, data, dev, want, cfg.name)
        losses.append(loss)
        walls.append(wall)
        peaks.append(peak)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: losses {losses} (finite, falling "
                             f"on one repeated batch expected)")
    if abs(losses[0] - float(loss0)) > 1e-3 * abs(losses[0]):
        raise AssertionError(f"{cfg.name}: the first step's loss "
                             f"{losses[0]} is not loss_and_grads' {loss0}")
    peak = max([lg_peak] + peaks)
    if peak > 80.0:
        raise AssertionError(f"{cfg.name}: peak {peak:.2f} GB > 80 GB")
    steady = walls[1:]
    step_s = sum(steady) / len(steady)
    log(f"[train] {cfg.name}: launches a step {want}; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {step_s * 1e3:.1f} ms a "
        f"step (steps 2..{n_steps}: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in steady)}; first "
        f"{walls[0] * 1e3:.1f}), {1.0 / step_s:.3f} steps/s, "
        f"{batch * seq / step_s:.1f} tokens/s"
        f"{' (text; the frames besides)' if cfg.encoder_layers else ''}; "
        f"loss_and_grads peak {lg_peak:.2f} GB, whole-step peak "
        f"{max(peaks):.2f} GB; {card}")
    run = {"arch": arch, "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "remat": True, "step_ms": step_s * 1e3,
           "tokens_per_s": batch * seq / step_s, "peak_gb": peak,
           "lg_peak_gb": lg_peak, "step_peak_gb": max(peaks),
           "losses": losses}
    if ab:
        off = cfg.replace(remat=False)
        turns = []
        for mode in ("off", "off", "on"):
            model.cfg = off if mode == "off" else cfg
            try:
                opt_state, step, _, wall, peak_ = _train_step(
                    step_fn, opt_state, step, data, dev,
                    _train_want(model.cfg), f"{cfg.name} remat {mode}")
            finally:
                model.cfg = cfg
            turns.append((mode, wall * 1e3, peak_))
        on_ms = [w * 1e3 for w in steady] + [w for m, w, _ in turns
                                             if m == "on"]
        off_ms = [w for m, w, _ in turns if m == "off"]
        on_step_peak = max(peaks + [p for m, _, p in turns if m == "on"])
        off_step_peak = max(p for m, _, p in turns if m == "off")
        if gap == 0.0:
            verdict = "bit-equal"
        elif repeat:
            verdict = (f"remat off run twice differs by {repeat:.3e} "
                       f"itself: the backward is not deterministic on the "
                       f"card")
        else:
            raise AssertionError(
                f"{cfg.name}: remat on vs off gradients differ by {gap:.3e} "
                f"while remat off run twice is bit-equal")
        log(f"[train] {cfg.name} remat on vs off, {batch} x {seq}, turns "
            f"on x{n_steps}, off, off, on: ms a step on "
            f"{statistics.mean(on_ms):.1f} ("
            + ", ".join(f"{w:.1f}" for w in on_ms) + f"), off "
            f"{statistics.mean(off_ms):.1f} ("
            + ", ".join(f"{w:.1f}" for w in off_ms) + f"); launches a step "
            f"on {want}, off {_train_want(off)}; loss_and_grads peak on "
            f"{lg_peak:.2f} GB, off {lg_off:.2f} GB ({lg_off - lg_peak:.2f}"
            f" GB saved; weights and moments {base:.2f} GB); whole-step "
            f"peak on {on_step_peak:.2f} GB, off {off_step_peak:.2f} GB; "
            f"loss on vs off "
            f"{'bit-equal' if loss_off == float(loss0) else 'differs'} "
            f"({float(loss0)!r}, {loss_off!r}); gradients max abs diff on "
            f"vs off {gap:.3e} ({verdict}); {card}")
        run["remat_ab"] = {
            "on_ms": on_ms, "off_ms": off_ms, "lg_peak_on_gb": lg_peak,
            "lg_peak_off_gb": lg_off, "base_gb": base,
            "step_peak_on_gb": on_step_peak, "step_peak_off_gb":
            off_step_peak, "grad_gap": gap, "grad_gap_off_repeat": repeat}
        if seq2:
            run["long"] = _train_long(cfg, model, step_fn, opt_state, step,
                                      gen, batch, seq, seq2,
                                      run["remat_ab"], dev, card)
    del model, opt_state, step_fn, opt, data
    torch.cuda.empty_cache()
    return cfg, want, run


def _reduced_remat_gap(cfg, card_model, on_card, g_card):
    """On the card, the reduced model's forward run twice (no gradient:
    the same kernels as the recompute's) bit-equal or not, and its
    gradients with remat off against ``g_card`` (remat on): 0 wherever
    the forward and the backward are deterministic.  A gap while the
    forward is bit-equal and remat off run twice is too fails.  Returns
    (forward bit-equal, the gap, remat off run twice's gap or None)."""
    import torch
    from repro_torch.launch import steps
    with torch.no_grad():
        a = card_model.apply(on_card["tokens"], on_card.get("embeddings"))
        b = card_model.apply(on_card["tokens"], on_card.get("embeddings"))
    same_fwd = torch.equal(a, b)
    del a, b
    card_model.cfg = cfg.replace(remat=False)
    try:
        _, g_off = steps.loss_and_grads(card_model, on_card)
        gap = max(float((g_off[k] - g_card[k]).abs().max()) for k in g_off)
        repeat = None
        if gap:
            _, again = steps.loss_and_grads(card_model, on_card)
            repeat = max(float((again[k] - g_off[k]).abs().max())
                         for k in g_off)
            if same_fwd and not repeat:
                raise AssertionError(
                    f"{cfg.name}: remat on vs off gradients differ by "
                    f"{gap:.3e} on the card with a deterministic forward "
                    f"and backward")
    finally:
        card_model.cfg = cfg
    return same_fwd, gap, repeat


def _train_reduced(kind, arch, dev):
    """A reduced config in float32 with remat on, from the same
    (perturbed) weights on the card (kernels and their Functions) and the
    CPU (plain versions): the loss and every gradient leaf, then one train
    step's weights (lr 1e-2), at the CPU tests' bounds; the card's
    launches exactly ``_train_want``; the card's remat on vs off
    (``_reduced_remat_gap``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced().replace(remat=True)
    gen = torch.Generator(device="cpu").manual_seed(8)
    cpu_model = build_model(cfg, device="cpu", generator=gen)
    _perturb_constants(cpu_model, gen)
    card_model = build_model(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    batch = _train_batch(cfg, 2, 128, 9, gen, "cpu")
    on_card = {k: v.to(dev) for k, v in batch.items()}
    _reset_launches()
    loss_card, g_card = steps.loss_and_grads(card_model, on_card)
    torch.cuda.synchronize()
    got, want = _seq_launches(), _train_want(cfg)
    if got != want:
        raise AssertionError(f"{cfg.name}: card launches {got} != {want}")
    loss_cpu, g_cpu = steps.loss_and_grads(cpu_model, batch)
    _finite_grads(f"{cfg.name} card", g_card)
    if abs(float(loss_card) - float(loss_cpu)) > \
            TRAIN_LOSS_RTOL * abs(float(loss_cpu)):
        raise AssertionError(f"{cfg.name}: loss card {float(loss_card)} vs "
                             f"cpu {float(loss_cpu)}")
    worst = 0.0
    for name, gc in g_cpu.items():
        bound = TRAIN_LEAF_REL * float(gc.abs().max()) + TRAIN_LEAF_ABS
        err = float((g_card[name].cpu() - gc).abs().max())
        if err > bound:
            raise AssertionError(f"{cfg.name}: gradient {name} card vs cpu "
                                 f"max abs {err:.3e} > {bound:.3e}")
        worst = max(worst, err / bound)
    same_fwd, gap, repeat = _reduced_remat_gap(cfg, card_model, on_card,
                                               g_card)
    steps_ = []
    for model, data in ((card_model, on_card), (cpu_model, batch)):
        step_fn, _, opt = steps.make_train_step(cfg, lr=1e-2, model=model)
        state, count, m = step_fn(opt.init(dict(model.named_parameters())),
                                  0, data)
        steps_.append((count, float(m["loss"])))
    step_err = 0.0
    for (name, pc), pg in zip(cpu_model.named_parameters(),
                              card_model.parameters()):
        d = (pg.detach().cpu() - pc.detach()).abs()
        if float(d.max()) > TRAIN_STEP_ATOL or \
                float(d.mean()) >= TRAIN_STEP_MEAN:
            raise AssertionError(f"{cfg.name}: after one step {name} max "
                                 f"{float(d.max()):.3e}, mean "
                                 f"{float(d.mean()):.3e}")
        step_err = max(step_err, float(d.max()))
    if [count for count, _ in steps_] != [1, 1]:
        raise AssertionError(f"{cfg.name}: step counts {steps_}")
    log(f"[train] reduced {kind} ({cfg.name}) fp32 remat on, card vs cpu: "
        f"loss {float(loss_card):.6f} vs {float(loss_cpu):.6f}; every "
        f"gradient leaf within its bound (worst {100 * worst:.1f}% of "
        f"1e-4·max|g| + 1e-6); one step at lr 1e-2: weights max abs "
        f"{step_err:.3e} (limit {TRAIN_STEP_ATOL}); launches {got}; on the "
        f"card the forward run twice "
        f"{'bit-equal' if same_fwd else 'NOT bit-equal'}, gradients remat "
        f"on vs off max abs {gap:.3e}"
        + ("" if repeat is None else
           f" (remat off run twice: {repeat:.3e})") + ": ok")
    return worst


def _linrec_grad_check(b, s, c, dtype_name, dev, timed=False):
    """The recurrence's Function on the card (the kernel forward, the
    kernel again over reversed time for the adjoint) against autograd
    through ``linear_recurrence_plain``'s step loop, on the same inputs;
    two launches, the second the adjoint's."""
    import torch
    from repro_torch.kernels import seq_ops
    dtype = getattr(torch, dtype_name)
    log_a = (-_seq_inputs((b, s, c), torch.float32, 61, dev).abs()
             .mul_(0.1)).to(dtype)
    x = _seq_inputs((b, s, c), dtype, 62, dev)
    g = _seq_inputs((b, s, c), torch.float32, 63, dev)
    leaves = [log_a.clone().requires_grad_(), x.clone().requires_grad_()]
    before = seq_ops.LAUNCHES["linear_recurrence"]
    out = seq_ops.linear_recurrence(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    if seq_ops.LAUNCHES["linear_recurrence"] - before != 2:
        raise AssertionError("the recurrence's Function did not launch the "
                             "kernel twice")
    plain = [log_a.clone().requires_grad_(), x.clone().requires_grad_()]
    want = torch.autograd.grad(seq_ops.linear_recurrence_plain(*plain),
                               plain, g)
    name = f"linear_recurrence backward B={b} S={s} C={c} {dtype_name}"
    errs = []
    for which, a, w in zip(("log_a", "x"), got, want):
        if a.dtype != dtype:
            raise AssertionError(f"{name}: d{which} is {a.dtype}")
        _check_close(f"{name} d{which}", a.float(), w.float(),
                     **LINREC_GRAD_TOL[dtype_name])
        errs.append(_max_err(a, w))
    if not timed:
        log(f"[train] {name}: dlog_a max abs {errs[0]:.3e}, dx {errs[1]:.3e}"
            f" vs autograd of the step loop: ok")
        return max(errs)

    def both():
        o = seq_ops.linear_recurrence(*leaves)
        return torch.autograd.grad(o, leaves, g)
    ms_fb = time_ms(both)
    ms_f = time_ms(lambda: seq_ops.linear_recurrence(*[t.detach()
                                                       for t in leaves]))
    n = b * s * c
    # the adjoint's own work: log_a, g and h read, dlog_a and dx written
    b_ms, b_by = bound_ms(5 * 4 * n, 6 * n)
    log(f"[train] {name}: dlog_a max abs {errs[0]:.3e}, dx {errs[1]:.3e} vs "
        f"autograd of the step loop: ok; forward {ms_f:.4f} ms, forward + "
        f"backward {ms_fb:.4f} ms (backward {ms_fb - ms_f:.4f} ms, bound "
        f"{b_ms:.6f} ms, {b_by})")
    return {"shape": [b, s, c], "max_abs_err": max(errs), "fwd_ms": ms_f,
            "bwd_ms": ms_fb - ms_f, "bwd_bound_ms": b_ms, "bwd_bound_by": b_by}


def _flash_grad_check(b, s, s_kv, h, kv, d, mask, dtype_name, seed, dev):
    """flash's Function on the card against ``attention_plain`` and its
    autograd on the same inputs: the output (the kernel, one launch) at the
    forward's tolerance ``FLASH_TOL`` (bf16: against the plain version in
    fp32 rounded once, as the forward checks hold the kernel); dq, dk, dv
    bit-equal to the plain autograd on the same inputs, since the
    backward is that same recompute (this holds its wiring: the mask passed
    through, the sum over each KV head's query group)."""
    import torch
    from repro_torch.kernels import seq_ops
    dtype = getattr(torch, dtype_name)
    q = _seq_inputs((b, s, h, d), dtype, seed, dev)
    k = _seq_inputs((b, s_kv, kv, d), dtype, seed + 1, dev)
    v = _seq_inputs((b, s_kv, kv, d), dtype, seed + 2, dev)
    g = _seq_inputs((b, s, h, d), dtype, seed + 3, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = seq_ops.LAUNCHES["flash_attention"]
    out = seq_ops.flash_attention(*leaves, **mask)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    if seq_ops.LAUNCHES["flash_attention"] - before != 1:
        raise AssertionError("flash's Function did not launch the kernel once")
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = seq_ops.attention_plain(*plain, **mask)
    want = torch.autograd.grad(want_out, plain, g)
    name = (f"flash backward B={b} S={s} S_kv={s_kv} H={h} KV={kv} D={d} "
            f"{ {k_: v_ for k_, v_ in mask.items() if v_} } {dtype_name}")
    if dtype == torch.bfloat16:
        with torch.no_grad():
            want_out = seq_ops.attention_plain(
                q.float(), k.float(), v.float(), **mask).to(dtype)
    _check_close(f"{name} output", out.float(), want_out.float(),
                 **FLASH_TOL[dtype_name])
    for which, a, w in zip("qkv", got, want):
        if not torch.equal(a, w):
            raise AssertionError(f"{name} d{which}: max abs "
                                 f"{_max_err(a, w):.3e}, not bit-equal")
    log(f"[train] {name}: output max abs {_max_err(out, want_out):.3e} vs "
        f"the plain version, dq, dk, dv bit-equal to its autograd: ok")


def phase_train(dev, card):
    """The substrate's training path on the card: the four models of
    ``TRAIN_RUNS`` at full width with remat on, one at a time
    (``_train_full``; stablelm-1.6b and recurrentgemma's unit also remat
    off beside it, stablelm also at 2 x 4096); each reduced mixer kind
    with remat on, card vs CPU (``_train_reduced``); the recurrence's
    adjoint and flash's Function against autograd of their plain versions,
    at the kernels' edges and every mask kind; flash forward and backward
    at each model's attention shapes and the recurrence's adjoint at
    recurrentgemma's, timed beside their bounds.  Returns the launches of
    one train step of each model summed, and the timed readings."""
    import torch
    runs, launches = [], {}
    flash_shapes = []
    for arch, layers, batch, seq, n_steps, why, ab, seq2 in TRAIN_RUNS:
        cfg, want, run = _train_full(arch, layers, batch, seq, n_steps, why,
                                     dev, card, ab, seq2)
        runs.append(run)
        for k, n in want.items():
            launches[k] = launches.get(k, 0) + n
        attn = []
        if cfg.encoder_layers:
            frames = cfg.stub_frames
            attn = [(batch, frames, frames, dict(causal=False)),
                    (batch, seq, seq, dict(causal=True)),
                    (batch, seq, frames, dict(causal=False))]
        elif want["flash_attention"]:
            window = cfg.window if "swa" in cfg.block_pattern else 0
            attn = [(batch, seq, seq, dict(causal=True, window=window))]
        for b, s, s_kv, mask in attn:
            r = _flash_train_ms(b, s, s_kv, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, mask, dev)
            r["arch"] = arch
            flash_shapes.append(r)
            log(f"[train] flash {arch} B={b} S={s} S_kv={s_kv} H="
                f"{cfg.n_heads} KV={cfg.n_kv_heads} D={cfg.d_head} "
                f"{r['mask']} bf16: forward {r['fwd_ms']:.4f} ms (bound "
                f"{r['fwd_bound_ms']:.6f}, {r['fwd_bound_by']}; "
                f"{r['fwd_ms'] / r['fwd_bound_ms']:.2f}x), backward "
                f"{r['bwd_ms']:.4f} ms (bound {r['bwd_bound_ms']:.6f}, "
                f"{r['bwd_bound_by']}; {r['bwd_ms'] / r['bwd_bound_ms']:.2f}x"
                f"); {card}")
    worst = {kind: _train_reduced(kind, arch, dev)
             for kind, arch in TRAIN_KINDS.items()}
    linrec = _linrec_grad_check(2, 2048, 4096, "float32", dev, timed=True)
    for b, s, c, dt in LINREC_GRAD_EDGES:
        _linrec_grad_check(b, s, c, dt, dev)
    for i, (b, s, s_kv, h, kv, d, mask) in enumerate(FLASH_GRAD_CASES):
        for dt in ("bfloat16", "float32"):
            _flash_grad_check(b, s, s_kv, h, kv, d, mask, dt, 170 + 4 * i,
                              dev)
    torch.cuda.empty_cache()
    log(f"[train] {len(runs)} models trained with remat on, launches a "
        f"step summed {launches}; reduced card vs cpu worst leaf "
        f"{ {k: round(float(v), 4) for k, v in worst.items()} } of its "
        f"bound; {card}")
    return launches, {"runs": runs, "flash": flash_shapes,
                      "linrec": linrec}


# ---------------------------------------------------------------------------
# [mesh]: the substrate across ranks on the ("data", "model") mesh
# ---------------------------------------------------------------------------

# (label, arch, layers, model axis, batch, seq, prompt, greedy tokens): a
# part with a prompt also decodes (the prompt token by token, then greedy
# tokens, over a cache of ``seq`` slots; whisper's cross cache holds the
# config's 1500 frames, written by ``prefill_cross``); one without is
# prefill only (yi context-parallel at a model axis of 3, whose cache
# would need a length 3 divides).  ``layers`` is whisper's encoder and
# decoder depth each.
# (yi-34b cut from 8 layers to 2 (4 to 2 context-parallel), xlstm-125m
# from 12 to 3 and whisper from 4 + 4 to 1 + 1 here, paying for the
# training parts)
MESH_ONE_CARD = [
    ("yi-34b 2 layers head-parallel", "yi-34b", 2, 2, 2, 1024, 16, 8),
    ("grok-1-314b 2 layers expert-parallel", "grok-1-314b", 2, 2, 2, 1024,
     16, 8),
    ("recurrentgemma-9b 1 unit channel-parallel", "recurrentgemma-9b", 3, 2,
     2, 1024, 16, 8),
    ("xlstm-125m 3 layers, heads split", "xlstm-125m", 3, 2, 2, 128, 16, 8),
    ("whisper-large-v3 1 + 1 layers head-parallel", "whisper-large-v3", 1,
     2, 2, 448, 16, 8),
    ("yi-34b 2 layers context-parallel", "yi-34b", 2, 3, 2, 3072, 0, 0),
    ("whisper-large-v3 1 + 1 layers context-parallel, self cache whole",
     "whisper-large-v3", 1, 3, 2, 448, 16, 8),
    ("xlstm-125m 3 layers, heads whole, r_gates on dh", "xlstm-125m", 3, 3,
     2, 128, 16, 8),
    ("recurrentgemma-9b 1 unit, rec whole", "recurrentgemma-9b", 3, 3, 2,
     1024, 16, 8),
]
MESH_FOUR_CARDS = [
    ("yi-34b full depth head-parallel", "yi-34b", 60, 4, 2, 4096, 64, 32),
    ("grok-1-314b 16 layers expert-parallel", "grok-1-314b", 16, 4, 2,
     4096, 64, 32),
    ("recurrentgemma-9b full depth channel-parallel", "recurrentgemma-9b",
     38, 4, 2, 4096, 64, 32),
    ("whisper-large-v3 full depth head-parallel", "whisper-large-v3", 32, 4,
     2, 448, 64, 32),
    ("xlstm-125m whole, heads split", "xlstm-125m", 12, 4, 2, 256, 64, 32),
    ("yi-34b 12 layers context-parallel", "yi-34b", 12, 3, 2, 3072, 0, 0),
    ("whisper-large-v3 full depth context-parallel, self cache whole",
     "whisper-large-v3", 32, 3, 2, 448, 64, 32),
]
MESH_SEED = 11
# the reduced fp32 check on each layout: a prompt's full logits and a
# token-by-token decode of its first MESH_REDUCED_STEPS tokens (a cache of
# 24 slots, which 2, 3 and 4 divide; whisper's 16 frames, which 3 does
# not: its cross cache whole at 3)
MESH_REDUCED_SEQ = 60
MESH_REDUCED_STEPS = 16
MESH_REDUCED_CACHE = 24


def _mesh_cfg(arch, layers):
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(n_layers=layers)
    return cfg.replace(encoder_layers=layers) if cfg.encoder_layers else cfg


def _streamed(cfg) -> bool:
    """Whether the unsharded reference of ``cfg`` streams one block at a
    time (the attention decoders, whose full depth passes a card) or
    builds the model whole (the recurrent and encoder-decoder ones fit)."""
    from repro_torch.models.transformer import ATTENTION_KINDS
    return not cfg.encoder_layers and all(k in ATTENTION_KINDS
                                          for k in cfg.block_pattern)


def _mesh_tokens(vocab, batch, seq, seed, dev):
    """The part's prompt, the same on every rank and in the parent."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (batch, seq), generator=gen).to(dev)


def _mesh_frames(cfg, batch, dev):
    """An encoder-decoder's stub frames (B, F, d) in the compute dtype,
    the same on every rank and in the parent; None for a decoder."""
    import torch
    if not cfg.encoder_layers:
        return None
    gen = torch.Generator().manual_seed(MESH_SEED + 4)
    return torch.randn((batch, cfg.stub_frames, cfg.d_model),
                       generator=gen).to(dev).to(cfg.compute_dtype)


def _decode_feed(model, tokens, frames, cache_len, steps):
    """A cache of ``cache_len`` slots (after ``prefill_cross`` of the
    frames), the first ``steps`` tokens decoded one at a time: (each
    step's logits (B, steps, V), the cache)."""
    import torch
    b = tokens.shape[0]
    with torch.no_grad():
        if frames is None:
            cache = model.init_cache(b, cache_len)
        else:
            cache = model.prefill_cross(
                model.init_cache(b, cache_len, frames.shape[1]), frames)
        out = []
        for i in range(steps):
            lg, cache = model.decode_step(tokens[:, i:i + 1], cache, i)
            out.append(lg[:, 0])
    return torch.stack(out, 1), cache


def _mesh_reduced(arch, mesh, dev):
    """The reduced fp32 config of ``arch`` drawn from ``MESH_SEED`` on
    ``mesh`` (None: unsharded): the full logits of a prompt and the logits
    of a token-by-token decode of its first tokens, on the host."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device=dev, mesh=mesh, generator=torch.Generator(
        device=dev).manual_seed(MESH_SEED))
    toks = _mesh_tokens(cfg.vocab_size, 2, MESH_REDUCED_SEQ, MESH_SEED + 1,
                        dev)
    frames = _mesh_frames(cfg, 2, dev)
    with torch.no_grad():
        full = model.apply(toks, frames)
    dec, _ = _decode_feed(model, toks, frames, MESH_REDUCED_CACHE,
                          MESH_REDUCED_STEPS)
    return full.float().cpu(), dec.float().cpu()


def _mesh_expected(cfg):
    """The launches of one prefill a rank: a tensor-core flash an
    attention call (whisper's encoder layer one, its decoder layer two),
    a recurrence a ``rec`` layer."""
    from repro_torch.models.transformer import ATTENTION_KINDS
    if cfg.encoder_layers:
        n_flash, n_rec = cfg.encoder_layers + 2 * cfg.n_layers, 0
    else:
        kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
                 for i in range(cfg.n_layers)]
        n_flash = sum(k in ATTENTION_KINDS for k in kinds)
        n_rec = kinds.count("rec")
    want = {"flash_attention": n_flash, "flash_attention_wgmma": n_flash,
            "linear_recurrence": n_rec}
    return {k: v for k, v in want.items() if v}


def _layout(model):
    """How the model axis splits the part's mixers on this rank."""
    if hasattr(model, "decoder"):
        sa, enc = model.decoder[0].self_attn, model.encoder[0].attn
        kind = ("context-parallel" if sa.seq_parallel else "head-parallel"
                if sa.head_parallel else "replicated")
        cache = model.init_cache(1, 448)["decoder"]
        return (f"decoder self-attention {kind} (q heads {sa.heads}), "
                f"encoder and cross-attention "
                f"{'head-parallel' if enc.head_parallel else 'whole'}, "
                f"self cache of 448 slots "
                f"{'whole' if cache['k'].model_split is None else 'split'} "
                f"({cache['k'].shape[2]} a rank), cross cache "
                f"{cache['cross_k'].shape[2]} frames a rank, table split "
                f"{model.table_split}")
    parts = []
    for blk in model.blocks:
        if blk.kind == "rec" and "rec" not in str(parts):
            parts.append(f"rec channels {blk.rec.channels or 'whole'}")
        if blk.kind == "mlstm" and "mLSTM" not in str(parts):
            m = blk.mlstm
            parts.append(f"mLSTM heads {m.heads} channels {m.channels}")
        if blk.kind == "slstm" and "sLSTM" not in str(parts):
            s = blk.slstm
            parts.append(f"sLSTM units {s.units}, w_gates columns "
                         f"{s.gate_cols}, r_gates split dim {s.r_split}, "
                         f"post-projection {s.ff}")
        if blk.kind in ("attn", "swa", "chunked") and "attention" not in \
                str(parts):
            a = blk.attn
            parts.append(f"attention "
                         f"{'context' if a.seq_parallel else 'head' if a.head_parallel else 'no'}"
                         f"-parallel (q heads {a.heads})")
    return "; ".join(parts) + f"; table split {model.table_split}"


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _mesh_part(label, arch, layers, n_model, batch, seq, prompt,
               new_tokens):
    """One part on this rank: the model ``arch`` at ``layers`` layers on
    ``make_host_mesh(model=n_model)`` drawn from ``MESH_SEED`` (each rank
    draws every leaf whole and keeps its block), a prefill of batch x seq
    (whisper's after its 1500 frames) with the launch counters zeroed just
    before and read just after, two timed prefills, at a context-parallel
    rank its block's offset flash call held to the plain version and timed
    alone, at a ``rec`` layer's rank the recurrence at the rank's channels
    held to the plain version and timed, then a decode (a prompt token by
    token, greedy tokens from ``make_serve_step``), peak device and host
    memory, and the reduced fp32 config on the same mesh.  Returns numpy
    and numbers."""
    import torch
    from repro_torch.kernels import seq_ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import block, make_host_mesh
    from repro_torch.models import build_model
    mesh = make_host_mesh(model=n_model)
    dev = mesh.device
    cfg = _mesh_cfg(arch, layers)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, mesh=mesh, generator=torch.Generator(
        device=dev).manual_seed(MESH_SEED))
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    tokens = _mesh_tokens(cfg.vocab_size, batch, seq, MESH_SEED + 1, dev)
    frames = _mesh_frames(cfg, batch, dev)
    batch_in = {"tokens": tokens} if frames is None else \
        {"tokens": tokens, "embeddings": frames}
    prefill, _ = steps.make_prefill_step(cfg, model=model)
    _reset_launches()
    t0 = time.perf_counter()
    last = prefill(batch_in)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        prefill(batch_in)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    attn = model.decoder[0].self_attn if hasattr(model, "decoder") else \
        next((b.attn for b in model.blocks if hasattr(b, "attn")), None)
    out = dict(label=label, coords=dict(mesh.coords), launches=launches,
               last=last.float().cpu().numpy(), build_s=build_s,
               weight_bytes=weight_bytes, first_ms=first_s * 1e3,
               prefill_ms=[w * 1e3 for w in walls], layout=_layout(model),
               seq_parallel=bool(getattr(attn, "seq_parallel", False)),
               moe_split=[getattr(b.moe, "split", None) for b in
                          getattr(model, "blocks", ())
                          if b.ffn_kind == "moe"][:1])
    if out["seq_parallel"]:
        # this rank's flash call of a context-parallel layer, alone
        lo, hi = block(seq, n_model, mesh.coords["model"])
        gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 2)
        q, k, v = (torch.randn((batch, n, h, cfg.d_head), generator=gen,
                               device=dev).to(cfg.compute_dtype)
                   for n, h in ((hi - lo, cfg.n_heads),
                                (seq, cfg.n_kv_heads), (seq, cfg.n_kv_heads)))
        # held to the plain version in fp32 on the same (bf16) inputs,
        # rounded once, at the forward's tolerance, as compare_flash holds
        # the main shape
        got = seq_ops.flash_attention(q, k, v, causal=True, q_offset=lo)
        want = flash_plain(q.float(), k.float(), v.float(), causal=True,
                           q_offset=lo).to(q.dtype)
        name = (f"[mesh] {label} rank {dict(mesh.coords)}: flash block "
                f"[{lo}, {hi}) at q_offset {lo}")
        _check_close(name, got.float(), want.float(),
                     **FLASH_TOL[str(q.dtype)[6:]])
        err = _max_err(got, want)
        del got, want
        out["offset_flash"] = dict(lo=lo, hi=hi, max_abs_err=err, ms=time_ms(
            lambda: seq_ops.flash_attention(q, k, v, causal=True,
                                            q_offset=lo)))
        del q, k, v
    rec = next((b.rec for b in getattr(model, "blocks", ())
                if b.kind == "rec"), None)
    if rec is not None:
        # the recurrence at this rank's channels and the prefill's shape,
        # bit-equal to its plain version (compare_linrec), timed alone
        c = ((cfg.rnn_width or cfg.d_model) if rec.channels is None
             else rec.channels[1] - rec.channels[0])
        err, ms_k, ms_p, b_ms, _, _ = compare_linrec(
            batch, seq, c, torch.float32, MESH_SEED + 3, dev)
        out["linrec"] = dict(c=c, max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                             bound_ms=b_ms)
    if prompt:
        serve_step, _ = steps.make_serve_step(cfg, model=model)
        t0 = time.perf_counter()
        lg, cache = _decode_feed(model, tokens, frames, seq, prompt)
        torch.cuda.synchronize(dev)
        feed_s = time.perf_counter() - t0
        tok = torch.argmax(lg[:, -1, :], dim=-1,
                           keepdim=True).to(torch.int32)
        greedy, step_ms = [tok[:, 0]], []
        for i in range(new_tokens - 1):
            t0 = time.perf_counter()
            tok, cache = serve_step(tok, cache, prompt + i)
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            greedy.append(tok[:, 0])
        out.update(prompt_logits=lg[:, -1].float().cpu().numpy(),
                   feed_ms=feed_s * 1e3, step_ms=step_ms,
                   greedy=torch.stack(greedy, 1).cpu().numpy(),
                   cache_bytes=_tensor_bytes(cache))
        del cache
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["host_peak_bytes"] = _host_peak_bytes()
    del model, prefill, last
    gc.collect()
    torch.cuda.empty_cache()
    full, dec = _mesh_reduced(arch, mesh, dev)
    out.update(reduced_full=full.numpy(), reduced_decode=dec.numpy())
    return out


def mesh_rank(parts):
    """The ranks' target (``core.mesh.spawn`` imports it from this
    script): each part in turn, by its ``kind``: a serving part
    (``_mesh_part``), a full-width training part (``_mesh_train_part``) or
    a reduced one (``_mesh_train_reduced``)."""
    out = []
    for part in parts:
        part = dict(part)
        kind = part.pop("kind", "serve")
        if kind == "serve":
            out.append(_mesh_part(**part))
        elif kind == "train":
            out.append(_mesh_train_part(**part))
        else:
            out.append(_mesh_train_reduced(part["k"], part["arch"],
                                           part["n_data"], part["n_model"]))
    return out


def _streamed_hidden(cfg, tokens):
    """The unsharded model of ``cfg`` drawn from ``MESH_SEED`` -- in
    ``Transformer``'s draw order: the embedding, the untied output table,
    then each block -- run one block at a time (each drawn, applied and
    freed: yi-34b's 60 layers take 137.6 GB, more than a card), over
    tokens (B, S): the final-normed hidden states, the output table and
    the MoE layers' aux summed."""
    import torch
    from repro_torch.models import attention, layers
    from repro_torch.models.transformer import Block, compute_stages
    dev = tokens.device
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    table = (cfg.vocab_size, cfg.d_model)
    emb = layers.normal_init(table, gen, cfg.param_dtype)
    unemb = emb if cfg.tie_embeddings else \
        layers.normal_init(table, gen, cfg.param_dtype)
    final = layers.Norm(cfg.norm, cfg.d_model, cfg.param_dtype, dev, gen)
    pat = tuple(zip(cfg.block_pattern, cfg.ffn_pattern))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    with torch.no_grad():
        x = layers.embed_apply(emb, tokens, cfg.compute_dtype)
        del emb
        if cfg.embed_scale:
            x = x * float(torch.tensor(cfg.d_model ** 0.5,
                                       dtype=cfg.compute_dtype))
        pos = torch.arange(tokens.shape[1], device=dev)
        for unit, reps in compute_stages(cfg.n_layers, pat):
            for _ in range(reps):
                for kind, ffn_kind in unit:
                    blk = Block(cfg, kind, ffn_kind, dev, gen)
                    y = attention.attention_apply(
                        blk.attn, blk.norm1(x), cfg,
                        mask_kind=blk.mask_kind(0), positions=pos,
                        use_rope=blk.use_rope(cfg))
                    x, inc = blk.ffn(x + y, cfg)
                    if inc is not None:
                        aux = aux + inc
                    del blk, y
        x = final(x)
    return x, unemb, aux


def _streamed_logits(cfg, tokens, positions):
    """``_streamed_hidden``'s float32 logits at ``positions``, on the
    host."""
    from repro_torch.models import layers
    x, unemb, _ = _streamed_hidden(cfg, tokens)
    out = layers.unembed_apply(unemb, x[:, positions]).float()
    del x, unemb
    return out.cpu()


def _streamed_loss(cfg, data):
    """The training loss of ``data`` (tokens and labels) on the unsharded
    model streamed one block at a time (``_streamed_hidden``): the cross
    entropy of its logits, one row at a time, plus the MoE aux."""
    import torch
    from repro_torch.models import layers
    x, unemb, aux = _streamed_hidden(cfg, data["tokens"])
    with torch.no_grad():
        nll = torch.stack([layers.token_nll(
            layers.unembed_apply(unemb, x[i]), data["labels"][i]).sum()
            for i in range(x.shape[0])])
    loss = nll.sum() / data["labels"].numel() + cfg.moe_aux_weight * aux
    del x, unemb
    return float(loss)


def _unsharded_logits(cfg, tokens, positions):
    """The unsharded model's float32 logits at ``positions`` over tokens
    (B, S) (after an encoder-decoder's frames), on the host: streamed
    (``_streamed_logits``) or the model built whole on the card from the
    same draws, run, and freed."""
    import torch
    from repro_torch.models import build_model
    if _streamed(cfg):
        return _streamed_logits(cfg, tokens, positions)
    dev = tokens.device
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(MESH_SEED))
    with torch.no_grad():
        h = model.hidden(tokens, _mesh_frames(cfg, tokens.shape[0], dev))
        out = model.unembed(h[:, positions]).float().cpu()
    del model, h
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_want(parts, dev):
    """Before the ranks: each part's unsharded prefill logits at the last
    position (``_unsharded_logits``) and the reduced config's unsharded
    run on the card."""
    want = []
    for label, arch, layers, n_model, batch, seq, prompt, _ in parts:
        cfg = _mesh_cfg(arch, layers)
        toks = _mesh_tokens(cfg.vocab_size, batch, seq, MESH_SEED + 1, dev)
        t0 = time.perf_counter()
        last = _unsharded_logits(cfg, toks, [seq - 1])[:, 0]
        want.append(dict(last=last, streamed_s=time.perf_counter() - t0,
                         reduced=_mesh_reduced(arch, None, dev)))
        del toks
    return want


def _mesh_check(parts, want, runs, dev, card):
    """The ranks of a spawn against the unsharded runs: per part and rank
    the launches (one tensor-core flash an attention call, one recurrence
    a ``rec`` layer, nothing else), every rank's last logits alike and
    within ``PREFILL_DECODE_REL_RMS`` of the unsharded prefill's, the
    reduced fp32 config at ``SUBSTRATE_TOL``; after the decode the
    unsharded model teacher-forced over the prompt and the greedy tokens:
    the decode's logits at the prompt's end within the same rel rms, and
    the share of greedy tokens alike.  Prints each rank's times, tokens/s
    and memory.  Returns {kernel: each rank's launches} of the part that
    launched the most of each."""
    import torch
    widest = {}
    for p, part in enumerate(parts):
        label, arch, layers, n_model, batch, seq, prompt, new_tokens = part
        cfg = _mesh_cfg(arch, layers)
        ranks = [r[p] for r in runs]
        w = want[p]
        exp = _mesh_expected(cfg)
        for rk in ranks:
            got = {k: v for k, v in rk["launches"].items() if v}
            if got != exp:
                raise AssertionError(f"[mesh] {label} rank {rk['coords']}: "
                                     f"prefill launches {got} != {exp}")
        for name in ("flash_attention_wgmma", "linear_recurrence"):
            mine = [rk["launches"].get(name, 0) for rk in ranks]
            if sum(mine) > sum(widest.get(name, [])):
                widest[name] = mine
        last0 = torch.from_numpy(ranks[0]["last"])
        for rk in ranks[1:]:
            if not torch.equal(torch.from_numpy(rk["last"]), last0):
                raise AssertionError(f"[mesh] {label}: ranks' logits differ")
        rel = _rel_rms(last0, w["last"])
        if not rel <= PREFILL_DECODE_REL_RMS:
            raise AssertionError(f"[mesh] {label}: last logits rel rms "
                                 f"{rel:.3e} against the unsharded prefill")
        same_top = float((last0.argmax(-1) == w["last"].argmax(-1))
                         .float().mean())
        full_w, dec_w = w["reduced"]
        worst = 0.0
        for rk in ranks:
            for got, ref in ((rk["reduced_full"], full_w),
                             (rk["reduced_decode"], dec_w)):
                got = torch.from_numpy(got)
                torch.testing.assert_close(got, ref, **SUBSTRATE_TOL)
                worst = max(worst, float((got - ref).abs().max()))
        r0 = ranks[0]
        how = "streamed one block at a time" if _streamed(cfg) else \
            "built whole"
        log(f"[mesh] {label} ({cfg.n_layers} layers"
            f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}"
            f", model axis {n_model}; {r0['layout']}; MoE split "
            f"{r0['moe_split']}): weights a rank "
            f"{r0['weight_bytes'] / 1e9:.2f} GB drawn in "
            f"{r0['build_s']:.1f} s; prefill {batch} x {seq}"
            f"{f' after {cfg.stub_frames} frames' if cfg.encoder_layers else ''}"
            f" last logits rel rms {rel:.3e} against the unsharded model "
            f"({how}, {w['streamed_s']:.1f} s), top token alike "
            f"{same_top:.3f}; reduced fp32 full and decode logits within "
            f"atol 2e-4 rtol 1e-3 of the unsharded (worst {worst:.2e}); "
            f"every rank's logits bit-equal; launches a rank {exp}")
        for rk in ranks:
            pre = statistics.median(rk["prefill_ms"])
            line = (f"[mesh] {label} rank {rk['coords']}: flash launches "
                    f"{rk['launches'].get('flash_attention_wgmma', 0)} "
                    f"tensor-core of "
                    f"{rk['launches'].get('flash_attention', 0)}, linrec "
                    f"{rk['launches'].get('linear_recurrence', 0)}; "
                    f"prefill {pre:.2f} ms ({batch * seq / pre * 1e3:.1f} "
                    f"tokens/s; runs {rk['prefill_ms'][0]:.2f}, "
                    f"{rk['prefill_ms'][1]:.2f}; first "
                    f"{rk['first_ms']:.2f})")
            if "step_ms" in rk:
                dec = statistics.median(rk["step_ms"])
                line += (f"; decode {dec:.3f} ms a token "
                         f"({batch / dec * 1e3:.1f} tokens/s; prompt of "
                         f"{prompt} fed in {rk['feed_ms']:.1f} ms; cache "
                         f"{rk['cache_bytes'] / 1e9:.3f} GB)")
            if "offset_flash" in rk:
                of = rk["offset_flash"]
                line += (f"; its flash block [{of['lo']}, {of['hi']}) at "
                         f"q_offset {of['lo']}: {of['ms']:.4f} ms, max abs "
                         f"err {of['max_abs_err']:.3e} against the plain "
                         f"version (bf16 tolerance atol "
                         f"{FLASH_TOL['bfloat16']['atol']} rtol "
                         f"{FLASH_TOL['bfloat16']['rtol']})")
            if "linrec" in rk:
                lr = rk["linrec"]
                line += (f"; linrec at its shape ({batch}, {seq}, "
                         f"{lr['c']}) fp32 bit-equal to the plain version "
                         f"(max abs err {lr['max_abs_err']:.3e}): "
                         f"{lr['ms']:.4f} ms, plain {lr['plain_ms']:.4f} "
                         f"ms, bound {lr['bound_ms']:.6f} ms")
            line += (f"; peak device {rk['peak_bytes'] / 1e9:.2f} GB, host "
                     f"resident peak {rk['host_peak_bytes'] / 1e9:.2f} GB")
            log(line)
            if rk["peak_bytes"] >= 80e9:
                raise AssertionError(f"[mesh] {label}: peak memory")
        if prompt:
            seq_tok = torch.cat([
                _mesh_tokens(cfg.vocab_size, batch, seq, MESH_SEED + 1,
                             "cpu")[:, :prompt],
                torch.from_numpy(r0["greedy"])], 1)
            for rk in ranks[1:]:
                if not (rk["greedy"] == r0["greedy"]).all():
                    raise AssertionError(f"[mesh] {label}: ranks' tokens "
                                         f"differ")
            # a MoE decode never drops a pair (a group of B tokens): the
            # unsharded model at the factor where nothing drops either
            ref = _unsharded_logits(_no_drop(cfg), seq_tok.to(dev),
                                    list(range(prompt - 1,
                                               prompt + new_tokens - 1)))
            rel_d = _rel_rms(torch.from_numpy(r0["prompt_logits"]),
                             ref[:, 0])
            if not rel_d <= PREFILL_DECODE_REL_RMS:
                raise AssertionError(f"[mesh] {label}: decode logits rel "
                                     f"rms {rel_d:.3e}")
            alike = float((ref.argmax(-1) == torch.from_numpy(r0["greedy"]))
                          .float().mean())
            log(f"[mesh] {label}: decode logits at the prompt's end rel rms "
                f"{rel_d:.3e} against the unsharded model over the prompt"
                f"{' (at the no-drop capacity factor)' if cfg.moe_experts else ''}; "
                f"greedy tokens alike {alike:.3f} ({new_tokens} a request, "
                f"the unsharded model teacher-forced on them); sample "
                f"{r0['greedy'][0, :8].tolist()}")
    return widest


# -- [mesh] training: the train step on the ("data", "model") mesh ----------

# (label, arch, layers, data axis, model axis, batch, seq, held[, remat
# A/B]): full-width parts trained with the training placement (FSDP over
# ``data``) and remat on, ``MESH_TRAIN_STEPS`` steps on one batch.  On one
# card they run in the two-rank gloo spawn of ``MESH_ONE_CARD``
# (stablelm-1.6b at 1 x 2 and 2 x 1 -- four gloo ranks would need a spawn
# of their own --, at 2 of its 24 layers: gloo stages every collective
# through the host, and 2 x 1 moves the 822 MB tied table's gradient and
# each layer's weights a step).  On four cards over NCCL: qwen3-8b whole,
# whose 131 GB of fp32 state no card holds, and grok-1-314b at 4 layers,
# each held to the unsharded loss streamed one block at a time and its
# gradients through the reduced configs; qwen3-8b at 8 layers (45 GB of
# fp32 state unsharded) held to the unsharded train step on each rank's
# own card, at S = 1024 so that step's logits fit beside its state; and
# at 8 layers and S = 4096 remat on against off.  ``held``: how
# ``_mesh_train_part`` holds the part ("unsharded", "streamed" or
# "stepped").
MESH_TRAIN_ONE_CARD = [
    ("stablelm-1.6b 2 layers tensor-parallel", "stablelm-1.6b", 2, 1, 2, 4,
     1024, "unsharded"),
    ("stablelm-1.6b 2 layers FSDP", "stablelm-1.6b", 2, 2, 1, 4, 1024,
     "unsharded"),
    ("recurrentgemma-9b 1 unit channel-parallel", "recurrentgemma-9b", 3, 1,
     2, 2, 1024, "unsharded"),
]
MESH_TRAIN_FOUR_CARDS = [
    ("qwen3-8b whole FSDP and tensor-parallel", "qwen3-8b", 36, 2, 2, 4,
     4096, "streamed"),
    ("qwen3-8b whole FSDP", "qwen3-8b", 36, 4, 1, 4, 4096, "streamed"),
    ("grok-1-314b 4 layers expert-parallel", "grok-1-314b", 4, 1, 4, 4,
     4096, "streamed"),
    ("qwen3-8b 8 layers FSDP against the unsharded step", "qwen3-8b", 8, 4,
     1, 4, 1024, "stepped"),
    # remat on against off on the same weights (whole, remat off would
    # keep every layer's gathered weights past a card)
    ("qwen3-8b 8 layers FSDP, remat on vs off", "qwen3-8b", 8, 4, 1, 4,
     4096, "streamed", True),
]
# the reduced fp32 config of each mixer kind, trained on its spawn's
# layouts: on one card each kind on one of 1 x 2 and 2 x 1 in turn (the
# CPU tests hold every kind on every layout); on four cards each on
# 2 x 2, 4 x 1 and 1 x 4
MESH_TRAIN_KINDS = {"attention": "yi-34b", "moe": "grok-1-314b",
                    "rec": "recurrentgemma-9b", "xlstm": "xlstm-125m",
                    "encoder-decoder": "whisper-large-v3"}
MESH_TRAIN_LAYOUTS = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}
MESH_TRAIN_STEPS = 4
# a full-width part's loss against the unsharded one (bf16 compute: the
# partials' sums run in another order), relative
MESH_TRAIN_LOSS_REL = 1e-2


def _train_seeds(cfg, batch, seq, dev):
    """A part's batch, the same on every rank and in the parent."""
    import torch
    return _train_batch(cfg, batch, seq, MESH_SEED + 5, torch.Generator(
        device=dev).manual_seed(MESH_SEED + 6), dev)


def _rank_block(whole, p, mesh):
    """This rank's block of a whole tensor shaped as parameter ``p``'s
    leaf: narrowed along its ``model_split`` and ``data_split``."""
    for axis in ("model", "data"):
        dim = getattr(p, f"{axis}_split", None)
        if dim is not None:
            n = p.shape[dim]
            whole = whole.narrow(dim, mesh.coords[axis] * n, n)
    return whole


def _mesh_train_part(label, arch, layers, n_data, n_model, batch, seq,
                     held, ab=False):
    """One full-width training part on this rank: ``make_train_step`` on
    ``make_host_mesh(model=n_model)`` (weights drawn from ``MESH_SEED``,
    each rank keeping its blocks), ``MESH_TRAIN_STEPS`` steps on one
    batch, each with the launch counters zeroed just before and read just
    after and the peak memory reset just before.  With ``held ==
    "unsharded"`` the rank first runs ``loss_and_grads`` of its own
    unsharded model from the same draws, and the first Adam moment its
    step would take ((1 - b1) × the clipped gradient), this rank's
    blocks, is held against the split step's after its first step (the
    rel rms; the moments in float32, one rounding apart at most: the
    unsharded Adam state of two ranks sharing a card would not fit
    beside theirs).  With ``"stepped"`` the rank first runs the
    unsharded ``make_train_step`` from the same draws for
    ``MESH_TRAIN_STEPS`` steps on its own card: each step's loss, and
    this rank's blocks of its first moments after one step, held against
    the split step's, and its peak.  With ``"streamed"`` (the loss held
    to the unsharded model streamed in the parent) a ``loss_and_grads``
    comes before the steps (with ``ab`` again with remat off on the same
    weights: its ms, peak and launches, and the gradients' max abs gap to
    remat on)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import clip_scale
    mesh = make_host_mesh(model=n_model)
    if mesh.shape["data"] != n_data:
        raise AssertionError(f"[mesh] {label}: a mesh of {mesh.shape}")
    dev = mesh.device
    cfg = _mesh_cfg(arch, layers)
    torch.cuda.empty_cache()
    data = _train_seeds(cfg, batch, seq, dev)
    blocks = None
    if held == "unsharded":
        ref = build_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(MESH_SEED))
        ref_loss, ref_grads = steps.loss_and_grads(ref, data)
        ref_loss = float(ref_loss)
        scale = clip_scale(ref_grads, 1.0)
        del ref
    if held == "stepped":
        layout = dict(build_model(cfg, device="meta", mesh=mesh,
                                  fsdp=True).named_parameters())
        ref_fn, ref, ref_opt = steps.make_train_step(
            cfg, lr=TRAIN_LR, device=dev, generator=torch.Generator(
                device=dev).manual_seed(MESH_SEED))
        ref_state = ref_opt.init(dict(ref.named_parameters()))
        torch.cuda.reset_peak_memory_stats(dev)
        ref_losses = []
        for i in range(MESH_TRAIN_STEPS):
            ref_state, _, m = ref_fn(ref_state, i, data)
            ref_losses.append(float(m["loss"]))
            if i == 0:
                blocks = {k: _rank_block(t, layout[k], mesh).float().clone()
                          for k, t in ref_state["m"].items()}
        ref_loss = ref_losses[0]
        ref_peak = torch.cuda.max_memory_allocated(dev)
        del ref_fn, ref, ref_opt, ref_state, layout
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_fn, model, opt = steps.make_train_step(
        cfg, lr=TRAIN_LR, device=dev, mesh=mesh,
        generator=torch.Generator(device=dev).manual_seed(MESH_SEED))
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    if held == "unsharded":
        # the first moment of AdamW's first step (b1 = 0.9)
        blocks = {k: (1 - 0.9) * _rank_block(
            ref_grads[k] * scale.to(ref_grads[k].dtype), params[k],
            mesh).float() for k in params}
        del ref_grads
        gc.collect()
        torch.cuda.empty_cache()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    out = dict(label=label, coords=dict(mesh.coords), build_s=build_s,
               weight_bytes=nbytes, state_bytes=2 * nbytes + sum(
                   t.numel() * t.element_size() for k in ("m", "v")
                   for t in opt_state[k].values()),
               fsdp_leaves=sum(p.data_split is not None
                               for p in params.values()))
    want = _train_want(cfg)
    if held == "stepped":
        out.update(ref_losses=ref_losses, ref_peak_bytes=ref_peak)
    if held == "streamed":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        t0 = time.perf_counter()
        _, grads = steps.loss_and_grads(model, data)
        torch.cuda.synchronize(dev)
        out.update(lg_ms=(time.perf_counter() - t0) * 1e3,
                   lg_launches=_seq_launches(),
                   lg_peak_bytes=torch.cuda.max_memory_allocated(dev))
        _finite_grads(f"[mesh] {label}", grads)
        if ab:
            model.cfg = cfg.replace(remat=False)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
            t0 = time.perf_counter()
            _, off = steps.loss_and_grads(model, data)
            torch.cuda.synchronize(dev)
            out.update(off_ms=(time.perf_counter() - t0) * 1e3,
                       off_launches=_seq_launches(),
                       off_want=_train_want(model.cfg),
                       off_peak_bytes=torch.cuda.max_memory_allocated(dev),
                       off_gap=max(float((off[k] - grads[k]).abs().max())
                                   for k in params))
            model.cfg = cfg
            del off
            # remat on again, warm (the first call set up the groups'
            # links)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            steps.loss_and_grads(model, data)
            torch.cuda.synchronize(dev)
            out.update(on_ms=(time.perf_counter() - t0) * 1e3,
                       on_peak_bytes=torch.cuda.max_memory_allocated(dev))
        del grads
        gc.collect()
        torch.cuda.empty_cache()
    losses, walls, peaks, launches = [], [], [], []
    for i in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        t0 = time.perf_counter()
        opt_state, _, m = step_fn(opt_state, i, data)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        launches.append(_seq_launches())
        if blocks is not None:
            got = opt_state["m"]
            num = sum(float((got[k].float() - blocks[k].float()).square()
                            .sum()) for k in params)
            den = sum(float(blocks[k].float().square().sum())
                      for k in params)
            out.update(m_rel_rms=(num / den) ** 0.5, ref_loss=ref_loss)
            blocks = None
    out.update(loss=losses[0], losses=losses, step_ms=walls,
               step_peak_bytes=peaks, step_launches=launches, want=want)
    del model, step_fn, opt_state, params, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_train_reduced(kind, arch, n_data, n_model):
    """The reduced fp32 config of ``arch`` on this rank, with the training
    placement on ``make_host_mesh(model=n_model)`` and unsharded, both from
    ``MESH_SEED``: the loss and each gradient leaf of the first (the
    rank's blocks) against the second's at the CPU tests' tolerances
    (rtol 1e-5; 1e-5 of the leaf's largest + 1e-8), then one train step
    each: the weights within the Adam-sign bound (max 2.5e-2, mean
    2e-3)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    mesh = make_host_mesh(model=n_model)
    dev = mesh.device
    cfg = get_config(arch).reduced()
    models = [build_model(cfg, device=dev, mesh=m, fsdp=True,
                          generator=torch.Generator(device=dev).manual_seed(
                              MESH_SEED)) for m in (mesh, None)]
    data = _train_seeds(cfg, 4, 32, dev)
    (loss, grads), (rloss, rgrads) = (steps.loss_and_grads(m, data)
                                      for m in models)
    params = dict(models[0].named_parameters())
    worst = 0.0
    for k, p in params.items():
        bound = 1e-5 * float(rgrads[k].abs().max()) + 1e-8
        gap = float((grads[k] - _rank_block(rgrads[k], p, mesh)).abs().max())
        worst = max(worst, gap / bound)
    losses = []
    for m in models:
        step_fn, _, opt = steps.make_train_step(cfg, lr=1e-2, model=m)
        losses.append(float(step_fn(opt.init(dict(m.named_parameters())), 0,
                                    data)[2]["loss"]))
    ref = dict(models[1].named_parameters())
    gaps = [(params[k] - _rank_block(ref[k], p, mesh)).detach().abs()
            for k, p in params.items()]
    return dict(kind=kind, arch=arch, coords=dict(mesh.coords),
                layout=(n_data, n_model), loss=float(loss),
                ref_loss=float(rloss), step_loss=losses[0],
                worst=worst, step_max=max(float(g.max()) for g in gaps),
                step_mean=max(float(g.mean()) for g in gaps))


def _mesh_train_parts(parts, world):
    """The rank dicts of a spawn of ``world`` ranks: each full-width part
    of ``parts`` and each reduced mixer kind on each layout of the
    spawn."""
    keys = ("label", "arch", "layers", "n_data", "n_model", "batch", "seq",
            "held", "ab")
    out = [dict(zip(keys, p), kind="train") for p in parts]
    layouts = MESH_TRAIN_LAYOUTS[world]
    for i, (k, a) in enumerate(MESH_TRAIN_KINDS.items()):
        mine = layouts if world == 4 else [layouts[i % len(layouts)]]
        out += [dict(kind="train-reduced", k=k, arch=a, n_data=n_data,
                     n_model=n_model) for n_data, n_model in mine]
    return out


def _mesh_train_check(parts, runs, streamed, card):
    """Every rank's training results: the loss and each step's bit-equal
    on every rank; against the unsharded step (its gradients' rel rms and
    loss, or the streamed unsharded loss); the losses falling; each
    ``loss_and_grads`` and step launching exactly ``_train_want`` a rank;
    the reduced kinds within the CPU tolerances.  Prints ms a step,
    tokens/s, the peak a rank and the state's bytes a rank.  Returns
    {kernel: each rank's launches of a step} of the part that launched
    the most."""
    widest = {}
    for p, part in enumerate(parts):
        ranks = [r[p] for r in runs]
        if part["kind"] == "train-reduced":
            tag = (f"[mesh] train reduced {part['arch']} ({part['k']}) at "
                   f"{part['n_data']} x {part['n_model']}")
            for rk in ranks:
                if not (abs(rk["loss"] - rk["ref_loss"])
                        <= 1e-5 * abs(rk["ref_loss"]) and rk["worst"] <= 1
                        and rk["step_max"] <= 2.5e-2
                        and rk["step_mean"] < 2e-3):
                    raise AssertionError(f"{tag} rank {rk['coords']}: {rk}")
            if len({(rk["loss"], rk["step_loss"]) for rk in ranks}) != 1:
                raise AssertionError(f"{tag}: the ranks' losses differ")
            log(f"{tag}: loss {ranks[0]['loss']:.6f} on every rank, "
                f"unsharded {ranks[0]['ref_loss']:.6f}; worst gradient leaf "
                f"{max(rk['worst'] for rk in ranks):.3f} of its bound "
                f"(1e-5 of its largest + 1e-8); one step's weights within "
                f"{max(rk['step_max'] for rk in ranks):.2e} (mean "
                f"{max(rk['step_mean'] for rk in ranks):.2e}) of the "
                f"unsharded step's: ok")
            continue
        label = part["label"]
        tag = (f"[mesh] train {label} ({part['n_data']} x "
               f"{part['n_model']})")
        r0 = ranks[0]
        for rk in ranks:
            if (rk["loss"], rk["losses"]) != (r0["loss"], r0["losses"]):
                seen = [(r["loss"], r["losses"]) for r in ranks]
                raise AssertionError(f"{tag}: the ranks' losses differ: "
                                     f"{seen}")
            for got in rk["step_launches"] + [rk.get("lg_launches",
                                                     rk["want"])]:
                if {k: v for k, v in got.items() if v} != \
                        {k: v for k, v in rk["want"].items() if v}:
                    raise AssertionError(f"{tag} rank {rk['coords']}: "
                                         f"launched {got}, want "
                                         f"{rk['want']}")
            if max(rk["step_peak_bytes"] + [rk.get("lg_peak_bytes", 0)]) \
                    >= 80e9:
                raise AssertionError(f"{tag}: peak memory")
        if not r0["losses"][-1] < r0["losses"][0]:
            raise AssertionError(f"{tag}: the loss did not fall: "
                                 f"{r0['losses']}")
        if part["held"] in ("unsharded", "stepped"):
            ref_loss = r0["ref_loss"]
            rel = max(rk["m_rel_rms"] for rk in ranks)
            if not rel <= PREFILL_DECODE_REL_RMS:
                raise AssertionError(f"{tag}: first moments rel rms "
                                     f"{rel:.3e} against the unsharded step")
            what = "" if part["held"] == "stepped" else \
                "(0.1 x the clipped gradients) "
            held = (f"the first step's Adam first moments {what}"
                    f"rel rms {rel:.3e} (worst rank) "
                    f"against each rank's blocks of the unsharded step's, "
                    f"loss")
        else:
            ref_loss = streamed[p]
            held = "loss against the unsharded model streamed one block " \
                   "at a time:"
        rel_loss = abs(r0["loss"] - ref_loss) / abs(ref_loss)
        if not rel_loss <= MESH_TRAIN_LOSS_REL:
            raise AssertionError(f"{tag}: loss {r0['loss']} against the "
                                 f"unsharded {ref_loss}")
        if part["held"] == "stepped":
            # every step's loss against the unsharded step's
            rels = [abs(a - b) / abs(b) for a, b in
                    zip(r0["losses"], r0["ref_losses"])]
            if not max(rels) <= MESH_TRAIN_LOSS_REL:
                raise AssertionError(f"{tag}: losses {r0['losses']} against "
                                     f"the unsharded steps' "
                                     f"{r0['ref_losses']}")
            log(f"{tag}: the unsharded train step on each rank's card "
                f"(peak {r0['ref_peak_bytes'] / 1e9:.2f} GB), losses over "
                f"{MESH_TRAIN_STEPS} steps "
                f"{[round(x, 6) for x in r0['ref_losses']]}, the split "
                f"step's within rel {max(rels):.2e} of them")
        tokens = part["batch"] * part["seq"]
        log(f"{tag}: remat on, batch {part['batch']} x {part['seq']}; "
            f"state a rank {r0['state_bytes'] / 1e9:.2f} GB (weights "
            f"{r0['weight_bytes'] / 1e9:.2f} GB, {r0['fsdp_leaves']} leaves "
            f"split over data) drawn in {r0['build_s']:.1f} s; loss "
            f"{r0['loss']:.6f} bit-equal on every rank; {held} "
            f"{ref_loss:.6f} (rel {rel_loss:.2e}); losses over "
            f"{MESH_TRAIN_STEPS} steps on one batch "
            f"{[round(x, 6) for x in r0['losses']]}, every step's bit-equal "
            f"on every rank; launches a rank a step {r0['want']}; {card}")
        if "off_ms" in r0:
            for rk in ranks:
                if rk["off_launches"] != rk["off_want"]:
                    raise AssertionError(f"{tag} rank {rk['coords']}: remat "
                                         f"off launched {rk['off_launches']}"
                                         f", want {rk['off_want']}")
            log(f"{tag}: remat off on the same weights, loss_and_grads "
                f"{r0['off_ms']:.1f} ms against {r0['on_ms']:.1f} on (run "
                f"after it), peak a rank "
                f"{max(rk['off_peak_bytes'] for rk in ranks) / 1e9:.2f} GB "
                f"against {max(rk['on_peak_bytes'] for rk in ranks) / 1e9:.2f}"
                f" on "
                f"(off keeps every layer's gathered weights for the "
                f"backward); gradients' max abs gap to remat on "
                f"{max(rk['off_gap'] for rk in ranks):.3e}; launches "
                f"{r0['off_want']}")
        for rk in ranks:
            ms = statistics.median(rk["step_ms"][1:])
            lg = (f", loss_and_grads {rk['lg_ms']:.1f} ms (first call) at "
                  f"{rk['lg_peak_bytes'] / 1e9:.2f} GB" if "lg_ms" in rk
                  else "")
            log(f"{tag} rank {rk['coords']}: step {ms:.1f} ms (median of "
                f"steps 2-{MESH_TRAIN_STEPS}; first {rk['step_ms'][0]:.1f}; "
                f"{tokens / ms * 1e3:.1f} tokens/s for the mesh); peak "
                f"device a rank {max(rk['step_peak_bytes']) / 1e9:.2f} GB a "
                f"step{lg}")
        for name in ("flash_attention_wgmma", "linear_recurrence"):
            mine = [rk["step_launches"][-1].get(name, 0) for rk in ranks]
            if sum(mine) > sum(widest.get(name, [])):
                widest[name] = mine
    return widest


def phase_mesh(dev, card, serve=True, train=True):
    """The substrate across ranks: on one card the parts of
    ``MESH_ONE_CARD`` over gloo ranks (model axis 2, then 3) after a mesh
    of one over NCCL, the training parts (``MESH_TRAIN_ONE_CARD`` and the
    reduced kinds, ``_mesh_train_parts``) in the model-2 spawn; on four
    cards ``MESH_FOUR_CARDS`` over NCCL ranks, then a spawn of four NCCL
    ranks for ``MESH_TRAIN_FOUR_CARDS``.  ``serve``/``train``: run those
    parts (``--only mesh-train``: the training ones alone).  Each spawn's
    unsharded runs come first, here, then the ranks, in turns.  Times the
    main flash shape beside the offset blocks.  Returns ({kernel: each
    rank's launches} of the serving part that launched the most of it,
    the same of a training step)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.mesh import spawn
    from repro_torch.kernels import seq_ops
    from repro_torch.launch.mesh import make_host_mesh
    four = torch.cuda.device_count() >= 4
    if serve:
        gen = torch.Generator(device=dev).manual_seed(3)
        q = torch.randn((2, 4096, 16, 256), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn((2, 4096, 1, 256), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        main_ms = time_ms(lambda: seq_ops.flash_attention(
            q, k, v, causal=True, window=2048))
        log(f"[mesh] flash main shape (bf16 B=2 S=4096 H=16 KV=1 D=256 "
            f"causal window 2048, q_offset none): {main_ms:.4f} ms on "
            f"{card}")
        del q, k, v
    if not four:
        # a mesh of one over an NCCL group of one: today's path, bit for
        # bit (no collective runs)
        import tempfile
        init = Path(tempfile.mkdtemp(prefix="repro-mesh-one-"))
        dist.init_process_group("nccl",
                                init_method=f"file://{init / 'rdv'}",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh(model=1)
            one = _mesh_reduced("yi-34b", mesh, dev)
            none = _mesh_reduced("yi-34b", None, dev)
            if mesh.size != 1 or not all(torch.equal(a, b) for a, b in
                                         zip(one, none)):
                raise AssertionError("[mesh] a mesh of one over NCCL is "
                                     "not the unsharded path")
        finally:
            dist.destroy_process_group()
            (init / "rdv").unlink(missing_ok=True)
            init.rmdir()
        log("[mesh] model=1 over an NCCL group of one: a mesh of one, "
            "the reduced yi-34b's logits and decode bit-equal to the "
            "unsharded model's")
    # (serving parts, training parts, world, backend)
    if four:
        spawns = [([p for p in MESH_FOUR_CARDS if p[3] == 4], [], 4, "nccl"),
                  ([p for p in MESH_FOUR_CARDS if p[3] == 3], [], 3, "nccl"),
                  ([], _mesh_train_parts(MESH_TRAIN_FOUR_CARDS, 4), 4,
                   "nccl")]
    else:
        spawns = [([p for p in MESH_ONE_CARD if p[3] == 2],
                   _mesh_train_parts(MESH_TRAIN_ONE_CARD, 2),
                   2, "gloo"),
                  ([p for p in MESH_ONE_CARD if p[3] == 3], [], 3, "gloo")]
    widest, train_widest = {}, {}
    for parts, train_parts, world, backend in spawns:
        parts = parts if serve else []
        train_parts = train_parts if train else []
        if not parts and not train_parts:
            continue
        t0 = time.perf_counter()
        want = _mesh_want(parts, dev)
        # the unsharded loss of each streamed part (one a config and batch)
        losses = {}
        for p in train_parts:
            key = tuple(p.get(k) for k in ("arch", "layers", "batch", "seq"))
            if p.get("held") == "streamed" and key not in losses:
                cfg = _mesh_cfg(p["arch"], p["layers"])
                losses[key] = _streamed_loss(cfg, _train_seeds(
                    cfg, p["batch"], p["seq"], dev))
        streamed = [losses.get(tuple(p.get(k) for k in
                                     ("arch", "layers", "batch", "seq")))
                    for p in train_parts]
        gc.collect()
        torch.cuda.empty_cache()
        want_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        keys = ("label", "arch", "layers", "n_model", "batch", "seq",
                "prompt", "new_tokens")
        runs = spawn(mesh_rank, world, backend=backend, device="cuda",
                     args=([dict(zip(keys, p)) for p in parts]
                           + train_parts,),
                     timeout_s=900)
        spawn_s = time.perf_counter() - t0
        log(f"[mesh] {world} {backend} ranks"
            f"{' across cards' if four else ' on one card'}: unsharded "
            f"runs {want_s:.1f} s, then the ranks {spawn_s:.1f} s (start, "
            f"CUDA context, runs; {len(parts)} serving parts, "
            f"{len(train_parts)} training parts)")
        n = len(parts)
        if parts:
            for name, mine in _mesh_check(parts, want, [r[:n] for r in runs],
                                          dev, card).items():
                if sum(mine) > sum(widest.get(name, [])):
                    widest[name] = mine
        if train_parts:
            for name, mine in _mesh_train_check(
                    train_parts, [r[n:] for r in runs], streamed,
                    card).items():
                if sum(mine) > sum(train_widest.get(name, [])):
                    train_widest[name] = mine
    return widest, train_widest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the kernel results as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one steady fcea round and a window "
                         "of DDPG slots (device idle share)")
    ap.add_argument("--only", choices=("shard", "mesh", "mesh-train"),
                    help="build the kernels and run this one phase, then "
                         "stop: a partial check (e.g. [shard] or [mesh] on "
                         "four cards; mesh-train: [mesh]'s training parts "
                         "alone) that prints no kernels line and no last "
                         "line")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.hfl_mnist import CONFIG

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        WORLDS.clear()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("build", phase_build)
    if args.only == "shard":
        launches = phase("hfl sharded drivers", phase_shard, CONFIG, dev,
                         card)
        log(f"[shard] launches a rank of the widest part, its jobs summed: "
            f"{launches}; partial run, {time.perf_counter() - t_start:.1f} "
            f"s")
        return 0
    if args.only in ("mesh", "mesh-train"):
        launches, train_launches = phase(
            "substrate across ranks", phase_mesh, dev, card,
            args.only == "mesh")
        log(f"[mesh] launches a rank of the widest part's prefill: "
            f"{launches}; of the widest training part's step: "
            f"{train_launches}; partial run, "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    main_cmp = phase("hfl kernels vs plain", phase_compare, CONFIG, dev)
    runs = phase("hfl main path", phase_main_path, CONFIG, dev)
    sim = runs["fcea"][0]
    phase("hfl card vs cpu", card_vs_cpu, CONFIG, sim.spec, sim.state,
          sim.bundle, sim.generator)
    if args.profile:
        phase("hfl profile", profile_device, runs["fcea"][0].run_round,
              "one steady fcea round", runs["fcea"][2])
    cand = phase("hfl candidate path", phase_candidates, CONFIG, dev)
    phase("hfl fleet", phase_fleet, CONFIG, dev, args.profile)
    scen_launches = phase("hfl scenarios and fpa/fca", phase_scenario,
                          CONFIG, dev, runs["fcea"][2])
    ddpg_launches = phase("hfl ddpg allocator", phase_ddpg, CONFIG, dev,
                          runs["fcea"][2], args.profile)
    phase("hfl telemetry", phase_telemetry, CONFIG, dev)
    buf_launches = phase("hfl buffered engine", phase_buffered, CONFIG, dev,
                         runs["fcea"][2])
    fault_launches = phase("hfl faults and resume", phase_faults, CONFIG,
                           dev)
    warm_launches = phase("hfl warm start", phase_warm, CONFIG, dev)
    sweep_launches = phase("hfl sweep runner", phase_sweep, CONFIG, dev)
    shard_launches = phase("hfl sharded drivers", phase_shard, CONFIG, dev,
                           card)
    seq_cmp = phase("seq kernels vs plain", phase_seq_compare, dev)
    seq_launches = phase("serve recurrentgemma-9b", phase_serve, dev,
                         args.profile)
    phase("substrate card vs cpu, prefill vs decode", phase_substrate, dev)
    phase("substrate bf16 prefill vs decode", phase_substrate_bf16, dev)
    dense_launches, dense_flash = phase("dense decoders", phase_dense, dev,
                                        card)
    vlm_moe_launches, vlm_moe_flash = phase(
        "prefix-LM and MoE decoders", phase_vlm_moe, dev, card)
    encdec_launches, encdec_flash = phase(
        "xLSTM and encoder-decoder", phase_xlstm_encdec, dev, card)
    train_launches, train = phase("train the substrate", phase_train, dev,
                                  card)
    mesh_launches, mesh_train_launches = phase(
        "substrate across ranks", phase_mesh, dev, card)

    # the entries of local_sgd_step and flash_attention are the cluster
    # kernel and the tensor-core kernel
    launches = {**runs["fcea"][1],
                "local_sgd_step": runs["fcea"][1]["local_sgd_step_cluster"],
                "flash_attention": seq_launches["flash_attention_wgmma"],
                "linear_recurrence": seq_launches["linear_recurrence"]}
    # the dynamic-scenario path's own counts (CONFIG full_dynamic, 5 rounds)
    scen_launches = {**scen_launches, "local_sgd_step":
                     scen_launches["local_sgd_step_cluster"]}
    # Algorithm 2 at the paper's defaults (CONFIG, 20 x 50 slots)
    ddpg_launches = {**ddpg_launches, "local_sgd_step":
                     ddpg_launches["local_sgd_step_cluster"]}
    # the buffered engine: CONFIG fcea dense, 64 micro-steps (and the
    # frontier's score from its CONFIG K = 2 run, 8 micro-steps)
    buf_launches = {**buf_launches, "local_sgd_step":
                    buf_launches["local_sgd_step_cluster"]}
    # the fault layer: CONFIG fcea + PDD dense under chaos, 5 rounds (and
    # the frontier's score from its K = 2 dead-edge run, 3 rounds)
    fault_launches = {**fault_launches, "local_sgd_step":
                      fault_launches["local_sgd_step_cluster"]}
    # the warm start: CONFIG fcea + PDD dense under random_waypoint, 5
    # rounds (and the frontier's score from its K = 2 run, 5 rounds)
    warm_launches = {**warm_launches, "local_sgd_step":
                     warm_launches["local_sgd_step_cluster"]}
    # the sweep runner's four grids at 32 x 4: local_sgd_step counts the
    # wrapper's launches, whichever route the lane count takes

    def phase_launches(name):
        return {"scenario_launches": scen_launches.get(name, 0),
                "ddpg_launches": ddpg_launches.get(name, 0),
                "buffered_launches": buf_launches.get(name, 0),
                "faults_launches": fault_launches.get(name, 0),
                "warm_launches": warm_launches.get(name, 0),
                "sweep_launches": sweep_launches.get(name, 0),
                "dense_launches": dense_launches.get(name, 0),
                "vlm_moe_launches": vlm_moe_launches.get(name, 0),
                "encdec_launches": encdec_launches.get(name, 0),
                "train_launches": train_launches.get(name, 0),
                "shard_launches": [rank.get(name, 0)
                                   for rank in shard_launches],
                "mesh_launches": mesh_launches.get(
                    {"flash_attention": "flash_attention_wgmma"}.get(
                        name, name), []),
                "mesh_train_launches": mesh_train_launches.get(
                    {"flash_attention": "flash_attention_wgmma"}.get(
                        name, name), [])}
    kernels = []
    for name, (err, ms_k, ms_p, work) in main_cmp.items():
        b_ms, b_by = bound_ms(*work)
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                        **phase_launches(name)})
    for name, (err, ms_k, ms_p, b_ms, b_by, lib_ms) in seq_cmp.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        **phase_launches(name)})
        if name == "flash_attention":
            # the dense, prefix-LM and MoE decoders' prefill shapes, each
            # timed as the main one
            kernels[-1]["dense_shapes"] = dense_flash
            kernels[-1]["vlm_moe_shapes"] = vlm_moe_flash
            kernels[-1]["encdec_shapes"] = encdec_flash
            kernels[-1]["train_shapes"] = train["flash"]
        if name == "linear_recurrence":
            kernels[-1]["train_adjoint"] = train["linrec"]
    for name, (n_launch, (err, ms_k, ms_p, b_ms, b_by, lib_ms)) in \
            cand.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": n_launch, "max_abs_err": err,
                        "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        **phase_launches(name)})
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card: {card}")
    result = {"kernels": kernels}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, **result, "train": train["runs"]}, indent=1))
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
