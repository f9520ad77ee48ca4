#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA GPU.  Run from the root of a checkout, on a machine with one
card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
 1. device: name, power limit, TF32 off for the float32 references;
 2. build: all nine CUDA sources from src/repro_torch/kernels/csrc with
    nvcc, in parallel; ptxas's registers, shared memory and spills of each
    kernel of the three LoRA libraries (the TF32 tile's instantiations and
    the rank reduce's), of flash attention, of the two decode libraries
    (the split-K body under its float and int8 element policies: no int8
    instantiation may spill), of the partial-softmax decode, of the SSD
    scan and of its backward; the 15 instantiations of the tiles only the
    tuner picks (64 x 128 and 32 x 64 with 16-byte copies,
    ``lora_matmul/plan.py::TUNED_TILES``) may not spill;
 3. kernel vs plain PyTorch version, on the card, at the serving and
    training paths' shapes (plus ragged ones), float32 and bfloat16: the
    forward LoRA matmul in both its regimes (M <= 16 and above, Mamba2's
    projections at M 8 and 200), its multi-tenant gather (distinct,
    repeated and out-of-range indices, ragged M/N/K, ranks 1 and 64; each
    tenant's rows bit-equal to the single-adapter kernel on them in the
    same regime), paged decode, the dX and rank-reduce backward
    kernels (the reduce at ranks 2-64, N not a multiple of 4 or 8, M not
    a multiple of its split; one launch a call; two runs bit-equal), the
    autograd backward of ``lora_matmul`` against autograd of its plain
    version, the causal flash-attention forward (D 16-128, Sq != Sk, GQA
    at S 1024, windows across KV tiles; two runs bit-equal), and the
    int8-base forward and dX (``lora_matmul(..., w_scale=)``, also at
    Mamba2's ``ssm_out`` shape) with their autograd backward, and the
    decode family: flash decode over slab
    caches (lengths 0 to L + 1, windows, GQA, ragged D) and the int8-KV
    pair (flash_decode_q8 over an int8 slab, paged_decode_q8 over an int8
    pool); both pairs' split-K body at the edges of its plan (one slot at
    511-513 of 512, capacities 16-2048 for S = 1 to 8, G 4 and 8, D
    20-256, pages of 1, 16 and 48, K/V off a 16-byte boundary; one launch
    a call, two runs bit-equal, dead slots exact zeros); flash decode's
    partial-softmax entry (f32 m, l, o; its own kernel) against its plain
    version over the last of tp 2, 4 and 8 length pieces (Lc 64 and 65, G
    1, 8 and 16, D 64, 128 and 256; empty pieces exactly (-1e30, 0, 0)),
    and its pieces joined as
    ``lse_combine`` joins them against flash_decode on the whole cache;
    and the SSD scan (y and the final state) against ``ssd_chunked``
    and the per-token oracle, f32, at repro's test shapes and the
    full-width Mamba2-2.7B prefill (80 heads of 64, state 128, chunk 256,
    S 8, 200, 300 and 512), and at the model's decays against the oracle
    in f64, no further from it than twice ``ssd_chunked``'s distance; the
    scan's edges at chunk 256 (S 1 to 1024, nh 1, 7 and 80, hd 8, 80 and
    64, N 3 to 256), each one launch with two runs bit-equal, and operands
    off a 16-byte boundary bit-equal to the aligned call;
 4. times: each kernel, its plain version and one library call, CUDA
    events, median of 60 launches with L2 flushed between launches, beside
    the least time the card could take for the same work (the decode
    family at the engine's shape: masked SDPA over the slab view, and
    dequantize-then-SDPA for the int8 pair, as the library calls; the SSD
    scan at S 200 and 512 has no library call, its bound is 3xTF32 with the
    f32 FFMA one beside, the plain ``ssd_chunked``'s min and max beside its
    median, and a [sweep] over S 8, 64 and 1024; ``lora_matmul`` also at
    Mamba2's projection shapes at M 8 and 200; the 3xTF32 tile's bound
    counts three TF32 products per f32 product, as does flash attention's,
    the q8 pair's two, as the int8 W is exact in TF32; the rank reduce at
    M 768 and 256, r 4 and 8, f32 and bf16 v; a [floor] line, what any
    launch costs under these events, a [sweep] of flash attention over
    S, and [sweep] decode lines: the four decode kernels, f32 q, with every
    slot at 16, 128 and 511 and one slot at 511, at the plan's split; the
    partial entry at yi-9b's piece at tp 8, 4 slots x 4 KV heads of G 8 x
    D 128 over Lc 65, beside aten's efficient attention with its
    log-sum-exp, and a [sweep] of it over pieces of 520 and 4096 and at
    GPT-2-S's piece at tp 8, each with its plan, plain, library and bound); two
    runs bit-equal for ``lora_matmul`` at
    M 8 and 768, dX at M 256 and the q8 pair at M 256; a sweep of M with
    each regime forced, at K = N = 768 and at ``ssm_in``;
 5. serving: ServingEngine on full-width GPT-2-S (f32, 8 slots, 512
    positions, 16-token pages) drains 16 requests; the launch counters,
    reset just before, must show the kernels carried the path; one decode
    step's logits are held against the plain path on the card; a digest of
    the token ids is printed (the naive run and phase 11 print theirs), a
    line two commits can be compared on;
 6. training: two SFL global rounds of full-width GPT-2-S through
    ``repro_torch.launch.train.run`` (3 clients x 4 x 64 tokens, 6 local
    steps, split 6, AdamW 4e-4, LoRA B != 0); the launch counters, reset
    just before, must equal the per-step counts the code implies; one
    local step through the kernels is held against the plain path;
 7. the flash-attention op's own path (no model path calls it): the
    op's entry point once per layer at the training step's attention
    shape, launch counter reset just before;
 8. heterogeneous, precision-aware SFL over an int8 base (full-width
    GPT-2-S from ``precision.quantize_params_int8``, 3 clients x 4 x 64
    tokens, 6 local steps, 2 rounds, AdamW 4e-4), each fleet through
    ``SflLLM.from_allocation`` and ``Trainer`` with the allocation's
    modeled round latency: (a) the allocator's own fleet
    (``bcd_minimize_delay_per_client`` on the 50 MHz edge problem with
    bits 4/8/16), (b) a fixed mixed fleet (splits 2/4/6, ranks 2/4/8,
    activation bits 4/8/16, gradient bits 8, stochastic rounding, error
    feedback).  The launch counters, reset just before each fleet, must
    equal the per-step counts its splits imply; for (b) one local step
    through the kernels is held against the plain path;
 9. the slab engine (``ServingEngine(paged=False)``) on full-width
    GPT-2-S (f32, 8 slots, 512 positions) drains phase 5's 16 requests:
    launch counters reset just before must show 12 ``flash_decode`` per
    decode step and 24 ``lora_matmul`` per step and per prefill, and the
    token ids must equal phase 5's; one slab decode step is held against
    the plain path; then a short run of the naive loop (``fused=False``);
10. the int8-KV ops' own path (no engine of ``repro`` builds an int8
    KV): the real GPT-2-S KV of a slab engine and of a paged engine
    mid-run, quantized per KV head (``precision.quantize_kv_int8``), then
    each q8 op once per layer — exactly 12 launches each, held against
    its plain version (f32 atol 1e-5), its distance from the f32 kernel
    printed;
11. multi-tenant serving: the paged engine on full-width GPT-2-S (f32, 8
    slots, 512 positions) with an ``AdapterRegistry`` of 8 pool slots over
    12 tenants (rank-4 q, v adapters, B != 0) drains phase 5's 16 requests
    with tenant = uid % 12: launch counters reset just before must show 24
    ``lora_matmul_gather`` and 12 ``paged_decode`` per decode step, 24
    ``lora_matmul`` per prefill chunk and nothing else; every request's
    ids must equal a single-adapter engine's serving it with its tenant's
    adapter, LRU must evict, one prompt under all 12 tenants must not give
    one answer, a hot swap between two steps must leave every pool
    tensor's storage in place, and one mixed-tenant decode step is held
    against the plain path;
12. Mamba2-2.7B serving: the slab engine on the full-width model (64
    layers, d 2560, f32, weights drawn on the card from a seeded CUDA
    generator, rank-4 ssm_in/ssm_out adapters with B != 0; 8 slots, 512
    positions) drains phase 5's 16 requests: launch counters reset just
    before must show 64 ``ssd_scan`` and 192 ``lora_matmul`` per prefill,
    128 ``lora_matmul`` per decode step and nothing else; a 300-token
    prefill (two chunks) is held against the plain path (``ssd_chunked``,
    ``torch.matmul``) block by block (output and state), and end to end
    (logits, every layer's state) against the plain path run in f64: no
    more than 3x as far from it as the plain f32 path; one decode step is
    held end to end, and ``generate()`` gives the engine's ids for two
    requests; a digest of the engine's token ids is printed;
13. a time-varying wireless SFL episode on full-width GPT-2-S (f32 base,
    random weights from seed 0): phase 8's 50 MHz edge problem, its
    allocator's fleet built with ``SflLLM.from_allocation(dynamic=True)``
    (the capacity envelope: every valid split, ranks up to 8) at fleet b's
    precision (8-bit gradients, stochastic rounding, error feedback), 3
    clients x 4 x 64 tokens, 6 local steps, AdamW 4e-4, 4 rounds under
    ``WirelessDynamics`` (8 dB AR(1) fading, rho 0.5, deadline 1.2 x the
    slowest client, drift re-allocation at 0.15, outages at 10 dB with 4
    HARQ attempts), started from phase 8's hand-set fleet b (splits
    2/4/6, ranks 2/4/8, bits 4/8/16); client 0 in certain outage in round
    1 through ``outage_override`` and a re-allocation forced in round 2
    through ``drift_threshold``, which hands the fleet to the allocator
    and moves its splits and ranks.  First the kernels at the episode's
    shapes against their plain versions (forward, dX and rank reduce at
    r 8 for a client's 256 rows and the server's 768, the forward at a
    decode step's 8); launch counters reset before each round must equal
    what the round's splits and participation imply (a dropped client runs
    its forward, not its backward); round 1 (client 0 dropped) is run
    again on its inputs through the plain path (``Runtime()``) and held to
    the kernels' at phase 6's tolerance, the dropped client's adapter and
    moments unchanged bit for bit; the episode killed after round 2 and
    resumed from its episode file by a fresh trainer must end bit-equal to
    the uninterrupted run (adapters, optimizer and error-feedback state,
    histories, the dynamics cursor); the adapter is handed off as
    ``{lora_server, lora_client0}``, joined at client 0's split, written as
    a stack and read through ``launch.serve.restore_lora``
    (``--lora-checkpoint``), and phase 5's 16 requests served from it must
    give the in-memory adapter's token ids, with 24 ``lora_matmul`` per
    decode step and per prefill chunk and 12 ``paged_decode`` per step; a
    digest of the ids is printed;
14. fault injection and recovery on full-width GPT-2-S: (a) phase 5's
    engine (f32, 8 slots, 512 positions, 16-token pages, its weights)
    drains phase 5's 16 requests under ``ServingFaults``: slots 0 and 1
    crashed at steps 6 and 14 (``benchmarks/bench_faults.py``'s
    schedule), ``deadline_steps=10`` on every third request and one NaN
    poke at step 20 on the first live request without a deadline; every
    other request must give phase 5's ids (prefix recompute through the
    prefill chunks, its own sampling stream), the poked one its
    ``error`` and a prefix of phase 5's ids; ``preemptions``,
    ``deadline_preemptions`` (each after exactly 10 decode steps of a
    residency), ``quarantined``, ``recomputed_tokens`` and the prefill
    chunks must equal what the observed schedule implies, the pages must
    all come home, and the launch counters, reset just before, must show
    24 ``lora_matmul`` per decode step and per chunk (recompute chunks
    included) and 12 ``paged_decode`` per step; a digest of the ids is
    printed; then priority preemption (2 slots x 256 positions over 16
    pages: a priority-5 request evicts the priority-0 hog, whose ids equal
    its solo run's), backpressure (every free page held: 3 steps admit
    and launch nothing; released, 4 requests give phase 5's first 8 ids)
    and one resync of a desynced page mirror.  (b) Phase 8's 50 MHz edge
    problem, its allocator's fleet through ``from_allocation(dynamic=True)``
    on full-width GPT-2-S f32, 3 clients x 4 x 64 tokens of one shared
    batch (FedAvg weights 1:2:2), 6 local steps, AdamW 4e-4, 6 rounds
    under ``WirelessDynamics(defense=DefenseConfig(clip=0.01, trim=1,
    quarantine_rounds=2))`` with ``TrainingFaults``: client 0
    ``sign_flip`` + ``scale_blowup(20)``, ``poison_round`` before round
    3; client 0 must be quarantined at least once and no other client
    ever, sit out (participation 0) while quarantined, round 3 must roll
    back bit for bit, and the launch counters, reset before each round,
    must follow its participation; round 1's ``corrupt_updates`` (four
    modes and the episode's) and ``robust_aggregate`` (off, clip, clip +
    trim, clip + median, and the episode's) run again on the CPU from
    host copies within 1e-6 of the card (no kernel computes them); the
    episode killed after round 3, mid-quarantine, and resumed with a
    fresh trainer must end bit-equal to the uninterrupted run (state,
    histories, tracker, cursor).  Per-round ``update_norm``, ``cos_dist``
    and quarantine rows are printed.
15. the dense RoPE family and the MoE FFN at full width and full depth
    (f32, weights drawn on the card from seeded CUDA generators, rank-4
    q/v adapters with B != 0; each model freed before the next is built):
    (a) yi-9b (48 layers, d 4096, 32 heads over 4 KV heads of 128) through
    the paged engine on phase 5's 16 requests, (b) olmoe-1b-7b (16 layers,
    d 2048, 64 experts of 1024, top-8) through the paged and the slab
    engines and one SFL round through ``launch.train.run`` (3 clients x 4 x
    64 tokens, 6 local steps, split 8, AdamW 4e-4; the server's aux loss
    per step, finite and > 0), (c) minicpm-2b (40 layers,
    d 2304, 36 heads of 64, tied vocabulary of 122753) through the same
    round at split 20, (d) deepseek-7b (30 layers, d 4096, 32 KV heads of
    128) through the slab engine.  Each model's kernels are held against
    their plain versions at its shapes first (``lora_matmul`` at M 8 and
    16 with N 4096 and 512, dX and the rank reduce at M 256 and 768, the
    decode pair at 8 slots x 512 with G 8 / D 128, 16 and 32 KV heads of
    128); the launch counters, reset before each engine run and each
    round, must equal what the steps imply; one decode step of each engine
    and one local step after each round are held against the plain path;
    tok/s, ms per decode step and per prefill chunk or prefill, s per
    round, peak memory and a digest of the ids are printed, and yi-9b's q
    and v projections at M 8 and its paged decode are timed beside their
    plain versions, a library call and the bound.
16. Mamba2 training: (a) the SSD scan's backward kernel
    (``ssd_scan_bwd_kernel``) at Mamba2-2.7B's decays (A = -linspace(1,
    16), dt = softplus(N(0, 1))), a random dy and a nonzero dh_last, at row
    12's shapes (B 1, 80 heads of 64, N 128, S 200 and 512), Jamba's
    full-width heads (B 2, 8 of 128, N 64, S 512) and the reduced shape
    (B 2, 4 of 32, N 16, S 40 at chunk 32) and a head dim of 192 (B 1, 4
    heads, N 64, S 256: two slices of the head dim, 128 and 64): its four
    cotangents within 1e-4 of ``ssd_scan_bwd_ref``'s largest entry, no
    further from autograd through the chunked algorithm in f64 than 3x the
    same autograd in f32, one launch a slice, two runs bit-equal; (b) its
    time at the training shapes (a
    client's B 2 and the server's pooled B 6, 320 tokens padded to 512) and
    at B 1, S 512, beside the
    plain version, autograd's backward through ``ssd_chunked`` and the
    3xTF32 bound (the f32 FFMA one beside), and at a client's shape the
    device time of each of its passes (torch.profiler); (c) one SFL round of full-width, full-depth Mamba2-2.7B
    (64 layers, d 2560, 2.83 B f32 parameters drawn on the card, rank-4
    ssm_in/ssm_out adapters with B != 0) through ``launch.train.run``: 3
    clients x 2 x 320 tokens (every step runs a padded second chunk), I =
    6, AdamW 4e-4, split 32; the launch counters, reset just before, must
    equal 128 ``ssd_scan`` and ``ssd_scan_bwd``, 256 ``lora_matmul``, 253
    ``lora_matmul_dx`` (the client's first ``ssm_in`` takes no dX) and 512
    ``lora_rank_reduce`` per local step; losses, s/round, peak memory and a
    digest of the adapters are printed; (d) one local step from the trained
    state on 64 tokens through the kernels, through the plain path and
    through the plain path in f64: the kernels no further from f64 than 3x
    the plain f32 path (loss and adapters); one more local step under
    ``torch.profiler``: device busy share, device time by kernel, and the
    backward kernel's share of the step and the peak memory; (e)
    reduced Jamba (two periods
    of one attention and seven mamba layers, MoE on the odd ones): one SFL
    round (3 x 4 x 64 tokens, split 8 of 16) with exact launch counts and
    one local step held against the plain path at phase 6's tolerance.
17. the modality front ends at full width and depth (f32, weights drawn
    on the card, rank-4 q/v adapters with B != 0, each model freed before
    the next), each taking a prefix ``frontend_emb`` (B, F, d) = 0.1 N(0,
    1) from a seeded generator: (a) InternVL2-2B (24 layers, d 2048, GQA
    16/8 of 128, vocab 92553, F 256) and (b) MusicGen-Large (48 layers, 32
    heads of 64, LayerNorm, GELU, learned positions over 524288, vocab
    2048, F 64).  For each: ``lora_matmul`` at decode M 4, at the prefill's
    4 x (F + 48) rows and, with dX and the rank reduce, at a client's 4 x
    (F + 64) and the server's 12 x (F + 64) training rows, and
    ``flash_decode`` over ``generate``'s slab caches, against their plain
    versions; ``generate`` (4 prompts of 48 tokens after the prefix, 32
    new, greedy, ``Runtime(dense_impl="fused", decode_attn_impl="flash")``)
    with exactly 2 L x 32 ``lora_matmul`` and L x 31 ``flash_decode``
    launches, its ids' digest and their equality with the plain path's
    (printed); one decode step from the prefill's caches against the plain
    path (logits 1e-3 x max(1, |logit|max), written KV 1e-4); another
    prefix moves the last text logit; ``ServingEngine`` refuses the arch
    (paged and slab), as ``repro``'s does; one SFL round through
    ``launch.engine.Trainer.fit`` (3 clients x 4 x 64 text tokens of the
    synthetic E2E corpus, each sample with its prefix, I = 6, AdamW 4e-4;
    split 12 of 24 and 24 of 48) with ``attention_per_step`` launches each
    step (96 / 90 / 192 and 192 / 186 / 384 of ``lora_matmul`` / dX / rank
    reduce), then one local step against the plain path at phase 6's
    tolerance, and once more under ``torch.profiler`` (device busy share,
    device time by kernel); (c) times, as phase 4 takes them: ``lora_matmul`` at M 1280
    and 4 (K 2048, N 2048 and 1024) and ``flash_decode`` at G 2, D 128
    (8 KV heads) and G 1, D 64 (32 KV heads) over 4 slots at the last
    decode step's length, each beside its plain version, a library call
    and the bound.
18. the multi-device path over ``torch.distributed``, in spawned ranks
    (``torch.multiprocessing``; a rank that raises fails the script):
    three runs, each from seeded weights drawn on the card — a client-axis
    round of full-width GPT-2-S (``SflLLM(mesh=)``, K 4 x 4 x 64, split 6,
    I 6, AdamW 4e-4), a ``PodRound`` round of full-width minicpm-2b (20 of
    its 40 layers, I 2, a pooled batch of 8 x 64, the frozen
    base FSDP-sharded over "data") and ``apply_moe_shard_map`` at olmoe-1b-7b's layer (d
    2048, 64 experts, top 8, ffn 1024, 4 x 256 tokens).  (a) One rank runs
    them with no group, then over a one-rank NCCL group: held to each
    other (losses 1e-4 relative; the first step's gradients 1e-4 of their
    largest entry; each adapter entry lr*1e-2, or where its first
    gradient g is under 400 times the gradients' measured error d,
    lr*min(2, 4d/|g|), which is what AdamW makes of that error; the MoE
    2e-4 against ``apply_moe`` with no drops), launches exactly the
    per-step counts.  (b) Two ranks on the one card over gloo, CUDA
    tensors staged through host memory (a printed line says so): 2
    clients a rank, FSDP over "data" = 2 (each rank draws the base a
    subtree at a time and keeps its pieces), 32 experts a rank, held to
    (a)'s no-group runs; each rank prints its resident frozen bytes (half
    the sharded leaves plus the replicated ones), the gathered bytes alive
    at most, its peak memory (the weights' construction included) and its
    launches; the clients' launches add up to the one-process count plus
    one more server pass a step (every rank runs the server on its rows).
    (c) One rank a card over NCCL where there are two cards or more; else
    a line says why not.
19. tensor parallelism over "model" and the last ``Runtime`` knobs: (a)
    one process, full-width minicpm-2b (f32, weights drawn on the card,
    rank-4 q/v adapters with B != 0), one train step at B 1 x S 4096
    (``train_4k``'s length): kv_chunk 512 with q_chunk 0 and no remat (the
    reference), then q_chunk 2048 with remat none, "full" and "dots",
    each held to the reference (loss 1e-4 relative, LoRA gradients 1e-4 of
    the largest entry) with exact launch counts ("full" runs every
    projection's forward twice, "dots" once), ms a step and peak memory;
    then a bf16 step with ``attn_s_bf16`` against f32 scores (loss 2e-2
    relative, gradients 5e-2 of the largest).  (e) rows 1, 3 and 4 at the
    TP-local shapes of (b)'s yi-9b (M 512: q and v column-parallel at N
    2048 and 256, o and down row-parallel at K 2048 and 5504) against their
    plain versions, with B as a trained adapter's (std 0.5) too, and timed
    beside the plain version, a library call and the bound.  Then
    ``PodRound`` rounds (I 2, SGD 1e-2, every step's gradients kept) in
    spawned ranks, each base drawn on the card a subtree at a time: one
    process with no group runs the references (yi-9b with LoRA on q, v, o,
    down over 8 x 64; yi-9b again through the plain projections, the f32
    yardstick; olmoe-1b-7b over 4 x 128; GPT-2-S over 8 x 64); (b) two
    ranks on the card over host-staged gloo on a (1, 2) mesh run yi-9b and
    olmoe with ``moe_constraints`` off, on, and on with ``seq_shard``; (c)
    four ranks on a (2, 2) mesh run GPT-2-S; (d) one rank a card over NCCL
    where there are two or more.  Each rank's round is held to its
    reference (losses 1e-4 relative, the first step's gradients 1e-4 of the
    largest entry, adapters within lr times the steps' summed gradient
    error), with exact launch counts, resident frozen bytes equal to the
    rule table's count for its (data, model) piece, s a round and peak
    memory; the ranks of (b) end bit-equal.
20. prefill and decode over a ("data", "model") mesh, and the dry-run, in
    spawned ranks (each base drawn on the card a subtree at a time and cut
    to the rank's pieces, f32, rank-4 adapters with B != 0): one process
    with no group runs the references through the plain PyTorch versions
    (einsum projections, the plain decode attention, the chunked scan), so
    that each kernel, at the local shapes a rank gives it, answers to plain
    PyTorch on the same weights and tokens; (a) yi-9b (LoRA on q, v, o, down)
    at tp 2, two ranks on the card over host-staged gloo,
    ``dense_impl="fused"``, ``decode_attn_impl="flash"``: a prefill of 4
    prompts of 512 tokens and 8 greedy decode steps, the KV cache cut by
    heads (``flash_decode`` on each rank's two); (b) the same at tp 8 over
    eight ranks (KH 4 does not divide 8: the cache cut by its length,
    ``decode_attn_impl="naive"``, the ranks' partial softmaxes joined by
    one all-reduce max and one sum), then under "flash" from a copy of the
    same prefill's caches (``flash_decode_partial`` on each rank's piece,
    joined alike), each 4 of the 8 decode steps and held to (a)'s plain
    reference's first 4; (c)
    Mamba2-2.7B (full width, 16 of its 64 layers) at tp 2 with
    ``ssd_impl="kernel"``: a 200-token prefill of 2 prompts and 8 decode
    steps, the mixer gathered whole, its state kept in pieces.  Each
    rank's greedy ids equal the reference's, its logits
    (gathered over the vocabulary) lie within 1e-4 of the reference's
    largest (Mamba2's reference runs in f64, as phase 12's witness: a
    random Mamba2 amplifies f32 rounding over depth, so its logits may
    also lie up to 3x the plain f32 path's distance from it), its
    launches are exactly rows 1, 6 and 12's counts (and the partial
    entry's); prefill
    and decode-step times and peak memory are printed.  (d) the dry-run
    (``python -m repro_torch.launch.dryrun``, no card) of one pair of each
    shape kind at (16, 16) and of yi-9b x decode_32k under
    ``--rt decode_attn_impl=flash``, started first and run beside the
    ranks, prints its roofline lines; its FLOPs of (a)'s decode step at a
    fake (1, 2) mesh equal ``FlopCounterMode``'s count on each of (a)'s
    ranks.
21. the five examples on the port (``examples/torch_*.py``) on the card
    at ``REPRO_SMOKE=1``, each in its own process: the quickstart, the
    train example (3 clients, 2 rounds of 2 steps at 32 tokens) writing
    its adapters in ``repro``'s msgpack format, the resource-allocation
    demo, continuous batching (paged, then naive) started together, then
    the serve example loading the train example's file; each must exit 0,
    and together they must launch rows 1-4 and 6; each one's wall time and
    launches by kernel are printed.
22. the launch-plan tuners (``kernels/lora_matmul/tune.py``,
    ``kernels/flash_attention/tune.py``), memos emptied first, at the
    main path's shapes: rows 1 (M 8 and 768 at K = N = 768, Mamba2's
    ``ssm_in``/``ssm_out`` at M 200, the front ends' M 1280 at K = N =
    2048, yi-9b's TP-local ``down`` at M 512), 3 and 8, 9 at M 768, 7 at M
    8 over 8 adapters, 2 and 6 at GPT-2-S's serving shape and yi-9b's G 8,
    D 128 over 4 KV heads (8 slots x 512); each candidate's output
    ``torch.equal`` to the heuristic plan's, f32 and bf16; the tuner's
    pick, its tuning ms, a second ``best_*`` call memoized with no launch
    and a hit's host cost; in f32 the heuristic plan and every candidate
    timed as phase 4 times, the pick's time beside the heuristic's; under
    60 s.  Every phase before it launches through the tuners (the kernels
    line's ``ms`` is at their pick) and prints a ``[tune]`` line: keys
    timed, candidates, tuning launches (no launch counter sees them) and
    host ms (phases 18-21: this process's share; their ranks and
    examples tune in their own).
The second-to-last line is ``nvidia-smi``'s name and power limit; the
last line is ``{"ok": true, "device": {...}}``.  Imports no JAX.

    python3 chip_smoke.py --host-times [TREE ...]

runs only phase 16 and phase 19 (e) (the host time of a bare and of an
op-routed fused forward a call) of each TREE (a checkout: its own
chip_smoke.py and src; this one where none is given), one process each,
in the order given: parent, change, change, parent compares two commits
on one card.

    python3 chip_smoke.py --partial-times [TREE ...]

times each TREE's ``flash_decode_partial`` (its own src, this script's
shapes and timer) at phase 4's pieces, L2 cold and warm, one process
each, in the order given.

    python3 chip_smoke.py --tuner

builds the kernels and runs phase 22 alone (~1.5 min).
"""
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}        # lora_matmul atol = rtol
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # every decode kernel
# backward kernels: f32 sums over 768 terms with TF32 off; bf16 gradients
# at repro's GRAD_TOLS
GRAD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=2e-1, rtol=5e-2)}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # repro's TOLS for f32


def _limits():
    """The card's rates, from ``repro_torch/kernels/limits.py`` (H100 SXM5
    80GB, 700 W, NVIDIA's datasheet): one source for every bound."""
    from repro_torch.kernels import limits
    return limits


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, flush, iters=60, warmup=5, spread=False):
    """Median CUDA-event time of one call; ``flush`` runs before each one,
    outside the events, so every launch finds L2 cold.  A ~1 ms device
    sleep ahead of the start event lets the host queue the whole call
    before the device reaches it, so the events time the device work and
    not the host's launch overhead.  ``spread``: (median, min, max)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if spread:
        return statistics.median(times), min(times), max(times)
    return statistics.median(times)


def host_us(torch, fn, n=200):
    """Host-clock microseconds per call over ``n`` back-to-back calls
    ending in a synchronize: the larger of launch overhead and device
    time, which is what an eager decode loop pays per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def lora_flops(M: int, K: int, N: int, r: int) -> int:
    """The fused LoRA forward's (and dX's) work: the kernel op's FLOP
    formula, the one the dry-run counts."""
    from repro_torch.kernels.lora_matmul.ops import lora_flops as formula
    return formula(M, K, N, r)


def scan_flops(B: int, nh: int, S: int, hd: int, N: int, Q: int) -> int:
    """The SSD scan's work on these inputs: the kernel op's FLOP formula."""
    from repro_torch.kernels.ssd_scan.ops import scan_flops as formula
    return formula(B, nh, S, hd, N, Q)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by) of f32 work: the larger of bytes over the
    memory rate and operations over the f32 rate outside tensor cores."""
    t_bytes = nbytes / _limits().HBM_BYTES_PER_S * 1e3
    t_ops = flops / _limits().PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_tf32(nbytes: float, flops: float, passes: int):
    """(bound_ms, bound_by) of f32 work on the TF32 tensor-core tile: the
    larger of bytes over the memory rate and `passes` TF32 products per
    f32 product over the TF32 rate (3xTF32: three; an operand exact in
    TF32, as int8 is: two)."""
    t_bytes = nbytes / _limits().HBM_BYTES_PER_S * 1e3
    t_ops = passes * flops / _limits().PEAK_FLOPS["tf32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# flash_decode_partial's pieces, f32 (what, (B, KH, G, D, Lc)): yi-9b's at tp 8
# (phase 20 (b)), longer ones with its heads, GPT-2-S's at tp 8
PARTIAL_SHAPES = (("yi-9b's piece at tp 8", (4, 4, 8, 128, 65)),
                  ("yi-9b's heads, a piece of 520", (4, 4, 8, 128, 520)),
                  ("yi-9b's heads, decode_32k's piece at tp 8", (4, 4, 8, 128, 4096)),
                  ("GPT-2-S's piece at tp 8", (8, 12, 1, 64, 64)))
PARTIAL_LIBRARY = "aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True)"


def time_partial(torch, dev, flush, partial, B, KH, G, D, Lc, full=True):
    """``partial`` (a tree's ``flash_decode_partial``) at a piece of Lc
    positions of every slot, f32, L2 cold and warm; with ``full`` also its
    plain version, the library call (the G query heads of a KV head as its
    query length, since they see the same keys under the same mask) and
    the bound: q read, the live K and V read once, m, l and o written."""
    from repro_torch.kernels.flash_attention import flash_decode_partial_ref
    gen = torch.Generator().manual_seed(Lc + D)
    q = torch.randn(B, 1, KH * G, D, generator=gen).to(dev)
    k = torch.randn(B, Lc, KH, D, generator=gen).to(dev)
    v = torch.randn(B, Lc, KH, D, generator=gen).to(dev)
    lens = torch.full((B,), Lc, dtype=torch.int32, device=dev)
    row = dict(ms=time_ms(torch, lambda: partial(q, k, v, lens), flush),
               warm_ms=time_ms(torch, lambda: partial(q, k, v, lens), lambda: None))
    if not full:
        return row
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.plan import partial_plan
    qt = q[:, 0].reshape(B, KH, G, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)              # views, no copy
    row["plain_ms"] = time_ms(torch, lambda: flash_decode_partial_ref(qt, kt, vt, lens), flush)
    # a length mask as an additive bias, its rows padded to 16-byte pitches
    pad = torch.zeros(B, 1, 1, -(-Lc // 16) * 16, device=dev)
    pad[..., :Lc].masked_fill_(torch.arange(Lc, device=dev) >= lens[:, None, None, None],
                               float("-inf"))
    bias = pad[..., :Lc].expand(B, KH, G, Lc)
    try:
        row["library_ms"] = time_ms(
            torch, lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, bias, True), flush)
    except RuntimeError as exc:
        row["library_ms"] = None
        row["refused"] = f"refused the shape: {str(exc).splitlines()[0][:160]}"
    nbytes = 4 * (B * KH * G * D + 2 * B * KH * Lc * D + B + B * KH * G * (2 + D))
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * B * KH * G * D * Lc)
    row["bytes"] = nbytes
    p_ = partial_plan(Lc, B, KH, G, D, torch.float32)
    resident = build.load("decode_partial").flash_decode_partial_clusters
    resident.argtypes, resident.restype = [ctypes.c_int] * 5, ctypes.c_int
    row["plan"] = (f"S {p_.splits} x {p_.warps} warps x {p_.stages} stages, "
                   f"{B * KH * p_.groups * p_.splits} blocks in {B * KH * p_.groups} "
                   f"clusters, {resident(D, p_.splits, p_.warps, p_.stages, 0)} resident "
                   "at once")
    return row


def ids_digest(requests) -> str:
    """sha256 of the requests' token ids, in order: one line that two runs
    (or two commits) can be compared on."""
    import hashlib
    return hashlib.sha256(json.dumps([r.output for r in requests]).encode()).hexdigest()[:16]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import models as TM
    from repro_torch.configs import get_arch
    from repro_torch.kernels import backend, build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref, flash_decode,
                                                     flash_decode_partial,
                                                     flash_decode_partial_ref,
                                                     flash_decode_q8_ref, flash_decode_ref,
                                                     paged_decode, paged_decode_q8_ref,
                                                     paged_decode_ref)
    from repro_torch.kernels.lora_matmul import (lora_matmul, lora_matmul_dx_kernel,
                                                 lora_matmul_dx_ref, lora_matmul_gather_kernel,
                                                 lora_matmul_kernel,
                                                 lora_matmul_gathered_ref,
                                                 lora_matmul_q8_dx_kernel,
                                                 lora_matmul_q8_dx_ref, lora_matmul_q8_kernel,
                                                 lora_matmul_q8_ref, lora_matmul_ref,
                                                 lora_rank_reduce_kernel,
                                                 lora_rank_reduce_ref)
    from repro_torch.kernels.flash_attention.plan import decode_plan
    from repro_torch.kernels.lora_matmul.plan import DECODE, DECODE_MAX_M, TILE
    from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan_kernel,
                                              ssd_scan_with_state, ssd_sequential_ref)
    from repro_torch.precision import quantize_kv_int8, quantize_weight_int8
    from repro_torch.serving import AdapterRegistry, Request, ServingEngine

    dev = torch.device("cuda", 0)

    # -- 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build(force=True)
    if sorted(secs) != sorted(build.SOURCES):
        fail(f"built {sorted(secs)}, expected {sorted(build.SOURCES)}")
    print(f"[build] nvcc sm_90a, in parallel: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
          + f"; wall {time.perf_counter() - t0:.1f}s")
    # the TF32 tile's (and the rank reduce's), flash attention's, the
    # decode body's under its float and int8 policies, the partial softmax's,
    # the SSD scan's and its backward's
    for lib in ("lora_matmul", "lora_matmul_bwd", "lora_matmul_q8", "flash_attention",
                "flash_decode", "paged_decode", "decode_partial", "ssd_scan", "ssd_scan_bwd"):
        for line in build.resource_usage(lib):
            print(f"[ptxas] {lib}: {line}")
    int8 = [ln for lib in ("flash_decode", "paged_decode") for ln in build.resource_usage(lib)
            if "Int8KV" in ln]
    spilled = [ln for ln in int8 if not ln.endswith("spill stores/loads 0/0 B")]
    print(f"[check] decode body: {len(int8)} Int8KV instantiations, {len(spilled)} spilling "
          f"{'ok' if int8 and not spilled else 'FAIL'}")
    if not int8 or spilled:
        fail(f"the int8 decode instantiations spill or are missing: {spilled}")
    # the tiles only the tuner picks (lora_matmul/plan.py::TUNED_TILES) are
    # instantiated where ptxas showed no spill: 8 forward and gather, 2 dX,
    # 5 of the q8 pair; they must stay so
    tuned = [ln for lib in ("lora_matmul", "lora_matmul_bwd", "lora_matmul_q8")
             for ln in build.resource_usage(lib)
             if "tile" in ln and (", 64, 128, " in ln or ", 32, 64, " in ln)]
    spilled = [ln for ln in tuned if not ln.endswith("spill stores/loads 0/0 B")]
    print(f"[check] tuner's tiles: {len(tuned)} instantiations of 64 x 128 and 32 x 64, "
          f"{len(spilled)} spilling {'ok' if len(tuned) == 15 and not spilled else 'FAIL'}")
    if len(tuned) != 15 or spilled:
        fail(f"the tuner's tile instantiations spill or are missing: {spilled or tuned}")
    tune_line("phases 1-2")

    # -- 3. kernel vs plain, on the card ----------------------------------
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std

    def lora_inputs(M, K, N, r, dt):
        return (randn(M, K).to(dev, dt), randn(K, N, std=K ** -0.5).to(dev, dt),
                randn(r, K, std=r ** -0.5).to(dev, dt), randn(N, r, std=0.02).to(dev, dt))

    def paged_inputs(B, KH, G, D, PS, MP, lengths, dt):
        NP = B * MP + 1
        q = randn(B, 1, KH * G, D).to(dev, dt)
        kp, vp = randn(KH, NP, PS, D).to(dev, dt), randn(KH, NP, PS, D).to(dev, dt)
        pages = torch.randperm(NP - 1, generator=gen) + 1        # shuffled pool
        bt = torch.zeros(B, MP, dtype=torch.int32)
        for b, n in enumerate(lengths):
            npg = -(-n // PS)
            bt[b, :npg] = pages[b * MP:b * MP + npg].int()
        lens = torch.tensor(lengths, dtype=torch.int32)
        return q, kp, vp, lens.to(dev), bt.to(dev)

    def close(op, what, got, want, tol):
        e = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
        good = (torch.allclose(got.float(), want.float(), **tol)
                and bool(torch.isfinite(got).all()))
        print(f"[check] {op} {what}: max_abs_err={e:.3g} atol={tol['atol']} "
              f"rtol={tol['rtol']} {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"{op} disagrees with its plain version ({what})")
        return e

    def grad_inputs(M, K, N, r, dt):
        # x, dY ~ N(0, 1), A ~ N(0, 1/K), B ~ N(0, 1/N): z = x A^T and
        # z2 = dY B are O(1), so each term the backward sums is O(1)
        return (randn(M, K).to(dev, dt), randn(K, N, std=K ** -0.5).to(dev, dt),
                randn(r, K, std=K ** -0.5).to(dev, dt),
                randn(N, r, std=N ** -0.5).to(dev, dt))

    def check_backward(dt, dn):
        """dX and rank reduce alone, then the autograd backward of
        lora_matmul against autograd of its plain version (all four
        cotangents, W frozen and not)."""
        gt = GRAD_TOL[dn]
        for M, K, N, r in ((256, 768, 768, 4), (768, 768, 768, 4), (33, 70, 45, 2)):
            dy = randn(M, N).to(dev, dt)
            _, w, a, b = grad_inputs(M, K, N, r, dt)
            dx = lora_matmul_dx_kernel(dy, w, a, b, scale)
            torch.cuda.synchronize()
            e = close("lora_matmul_dx", f"{dn} M={M} K={K} N={N} r={r}", dx,
                      lora_matmul_dx_ref(dy, w, a, b, scale), gt)
            if dn == "float32" and K == 768:
                err["lora_matmul_dx"] = max(err["lora_matmul_dx"], e)
        # the main path's shapes, then padded ranks (r 3, 16, 64), N not a
        # multiple of 4 or 8 (element loads) and M not a multiple of the split
        for M, r, N in ((768, 4, 768), (256, 4, 768), (768, 8, 768), (33, 2, 45),
                        (771, 3, 770), (1000, 16, 1030), (300, 64, 99), (129, 8, 13)):
            u = randn(M, r, std=M ** -0.5).to(dev)          # out is O(1)
            v = randn(M, N).to(dev, dt)
            backend.reset_launch_counts()
            out = lora_rank_reduce_kernel(u, v)
            if dict(backend.LAUNCH_COUNTS) != {"lora_rank_reduce": 1}:
                fail(f"lora_rank_reduce counted {dict(backend.LAUNCH_COUNTS)}")
            again = lora_rank_reduce_kernel(u, v)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"lora_rank_reduce is not deterministic ({dn}, M={M}, r={r}, N={N})")
            e = close("lora_rank_reduce", f"{dn} M={M} r={r} N={N} (v {dn}, out f32; "
                      "two runs bit-equal)", out, lora_rank_reduce_ref(u, v),
                      dict(atol=1e-4, rtol=1e-4))
            if dn == "float32" and M == 768:
                err["lora_rank_reduce"] = max(err["lora_rank_reduce"], e)
        for M, K, N, r in ((256, 768, 768, 4), (33, 70, 45, 2)):
            for need_w in (False, True):
                ins = grad_inputs(M, K, N, r, dt)
                cot = randn(M, N).to(dev, dt)
                need = (True, need_w, True, True)
                ink = [t.clone().requires_grad_(n) for t, n in zip(ins, need)]
                inr = [t.clone().requires_grad_(n) for t, n in zip(ins, need)]
                backend.reset_launch_counts()
                lora_matmul(*ink, scale=scale).backward(cot)
                torch.cuda.synchronize()
                want = {"lora_matmul": 1, "lora_matmul_dx": 1, "lora_rank_reduce": 2}
                if dict(backend.LAUNCH_COUNTS) != want:
                    fail(f"autograd backward launched {dict(backend.LAUNCH_COUNTS)}, "
                         f"expected {want}")
                lora_matmul_ref(*inr, scale).backward(cot)
                # the exact cotangents (float64 autograd of the plain version):
                # how far each f32 side lies from them, beside max|ref|
                in64 = [t.double().requires_grad_(n) for t, n in zip(ins, need)]
                lora_matmul_ref(*in64, scale).backward(cot.double())
                for name, tk, tr, t64 in zip(("dx", "dw", "da", "db"), ink, inr, in64):
                    if tr.grad is None:
                        if tk.grad is not None:
                            fail(f"autograd backward formed {name} for a frozen input")
                        continue
                    close("lora_matmul autograd", f"{dn} {name} M={M} K={K} N={N} r={r} "
                          f"w.requires_grad={need_w}", tk.grad, tr.grad, gt)
                    ek, ep = ((g.double() - t64.grad).abs().max().item()
                              for g in (tk.grad, tr.grad))
                    print(f"[check]   {name} against float64 autograd: kernel path "
                          f"{ek:.3g}, plain {dn} path {ep:.3g}, max|ref| "
                          f"{t64.grad.abs().max().item():.4g}")

    def check_attention(dt, dn):
        tol = dict(atol=ATTN_TOL[dn], rtol=ATTN_TOL[dn])
        # the main path's shapes, then D 80 and 128 (padded to the mma's
        # k8/n8 with zeros), Sq != Sk both ways, GQA at S 1024, windows across
        # KV tiles, a ragged D (element copies); two runs bit-equal
        for B, Sq, Sk, H, KH, D, win in ((12, 64, 64, 12, 12, 64, 0),
                                         (1, 1024, 1024, 12, 12, 64, 0),
                                         (1, 40, 72, 2, 1, 16, 0),
                                         (1, 128, 128, 4, 2, 128, 33),
                                         (2, 100, 100, 4, 4, 80, 0),
                                         (1, 200, 130, 2, 1, 128, 0),
                                         (1, 1024, 1024, 12, 4, 64, 0),
                                         (2, 300, 300, 4, 2, 64, 100),
                                         (1, 96, 160, 2, 2, 42, 70),
                                         # two warp groups: D 128 and 96 (f32: no
                                         # room to prefetch), 80, a window, Sq < Sk
                                         (1, 512, 512, 2, 1, 128, 0),
                                         (1, 600, 600, 2, 2, 64, 300),
                                         (1, 300, 300, 2, 2, 80, 0),
                                         (1, 100, 400, 2, 1, 96, 0)):
            q = randn(B, Sq, H, D).to(dev, dt)
            k, v = randn(B, Sk, KH, D).to(dev, dt), randn(B, Sk, KH, D).to(dev, dt)
            o = flash_attention(q, k, v, window=win)
            again = flash_attention(q, k, v, window=win)
            torch.cuda.synchronize()
            if not torch.equal(o, again):
                fail(f"flash_attention is not deterministic ({dn}, Sq={Sq}, D={D})")
            e = close("flash_attention", f"{dn} B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} "
                      f"D={D} window={win} (two runs bit-equal)", o,
                      flash_attention_ref(q, k, v, window=win), tol)
            if dn == "float32" and D == 64:
                err["flash_attention"] = max(err["flash_attention"], e)

    def q8_inputs(M, K, N, r, dt):
        x, w, a, b = grad_inputs(M, K, N, r, dt)
        wq, ws = quantize_weight_int8(w.float())
        return x, wq, ws, a, b

    def check_q8(dt, dn):
        """The int8-base forward and dX kernels alone at the fleets' shapes
        (a client's M = 256, the pooled server M = 768, serving M = 8),
        Mamba2's ``ssm_out`` at M 200 (eight splits of K 5120) and ragged
        ones (pitches not whole 16 bytes copy element by element), then the
        autograd backward of lora_matmul(..., w_scale=) against autograd of
        its plain version (dx, da, db; no gradient for W or its scale)."""
        tol = GRAD_TOL[dn]            # f32: atol = rtol 1e-4; bf16: repro's GRAD_TOLS
        for M, K, N, r in ((8, 768, 768, 8), (256, 768, 768, 8), (768, 768, 768, 8),
                           (256, 768, 768, 1), (768, 768, 768, 2), (256, 768, 768, 4),
                           (33, 70, 45, 2), (5, 100, 70, 1), (70, 130, 301, 64),
                           (200, 5120, 2560, 4)):
            x, wq, ws, a, b = q8_inputs(M, K, N, r, dt)
            y = lora_matmul_q8_kernel(x, wq, ws, a, b, scale)
            dy = randn(M, N).to(dev, dt)
            dx = lora_matmul_q8_dx_kernel(dy, wq, ws, a, b, scale)
            torch.cuda.synchronize()
            e = close("lora_matmul_q8", f"{dn} M={M} K={K} N={N} r={r}", y,
                      lora_matmul_q8_ref(x, wq, ws, a, b, scale), tol)
            e2 = close("lora_matmul_q8_dx", f"{dn} M={M} K={K} N={N} r={r}", dx,
                       lora_matmul_q8_dx_ref(dy, wq, ws, a, b, scale), tol)
            if dn == "float32" and K == 768:
                err["lora_matmul_q8"] = max(err["lora_matmul_q8"], e)
                err["lora_matmul_q8_dx"] = max(err["lora_matmul_q8_dx"], e2)
        for M, K, N, r in ((256, 768, 768, 8), (33, 70, 45, 2)):
            x, wq, ws, a, b = q8_inputs(M, K, N, r, dt)
            cot = randn(M, N).to(dev, dt)
            ink = [t.clone().requires_grad_() for t in (x, a, b)]
            inr = [t.clone().requires_grad_() for t in (x, a, b)]
            backend.reset_launch_counts()
            lora_matmul(ink[0], wq, ink[1], ink[2], scale=scale, w_scale=ws).backward(cot)
            torch.cuda.synchronize()
            want = {"lora_matmul_q8": 1, "lora_matmul_q8_dx": 1, "lora_rank_reduce": 2}
            if dict(backend.LAUNCH_COUNTS) != want:
                fail(f"q8 autograd backward launched {dict(backend.LAUNCH_COUNTS)}, "
                     f"expected {want}")
            lora_matmul_q8_ref(inr[0], wq, ws, inr[1], inr[2], scale).backward(cot)
            in64 = [t.double().requires_grad_() for t in (x, a, b)]
            lora_matmul_q8_ref(in64[0], wq, ws, in64[1], in64[2], scale).backward(
                cot.double())
            for name, tk, tr, t64 in zip(("dx", "da", "db"), ink, inr, in64):
                close("lora_matmul q8 autograd", f"{dn} {name} M={M} K={K} N={N} r={r}",
                      tk.grad, tr.grad, tol)
                ek, ep = ((g.double() - t64.grad).abs().max().item()
                          for g in (tk.grad, tr.grad))
                print(f"[check]   {name} against float64 autograd: kernel path {ek:.3g}, "
                      f"plain {dn} path {ep:.3g}, max|ref| {t64.grad.abs().max().item():.4g}")

    def slab_inputs(B, KH, G, D, L, lengths, dt):
        q = randn(B, 1, KH * G, D).to(dev, dt)
        k, v = randn(B, L, KH, D).to(dev, dt), randn(B, L, KH, D).to(dev, dt)
        return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)

    def check_decode(dt, dn):
        """flash_decode over slab caches in the model layout, then the
        int8-KV pair, against their plain versions: dead slots, lengths
        L and L + 1 (a finished slab slot decoding on), windows, GQA and a
        ragged D (int8 rows read byte by byte)."""
        tol = dict(atol=PAGED_TOL[dn], rtol=PAGED_TOL[dn])
        for B, KH, G, D, L, win in ((8, 12, 1, 64, 512, 0), (4, 2, 4, 128, 96, 0),
                                    (6, 2, 3, 42, 33, 7), (7, 2, 2, 20, 64, 16)):
            lengths = [0, L + 1, 1, L, 31, 32, 33, 255][:B]
            q, k, v, lens = slab_inputs(B, KH, G, D, L, [min(n, L + 1) for n in lengths], dt)
            qt = q[:, 0].reshape(B, KH, G, D)
            what = f"{dn} B={B} KH={KH} G={G} D={D} L={L} window={win} lengths={lengths}"
            o = flash_decode(q, k, v, lens, window=win)
            torch.cuda.synchronize()
            ref = flash_decode_ref(qt, k.transpose(1, 2), v.transpose(1, 2), lens,
                                   window=win).reshape(o.shape)
            e = close("flash_decode", what, o, ref, tol)
            if not bool((o[0] == 0).all()):
                fail(f"flash_decode: a dead slot did not give exact zeros ({what})")
            kq, ks = quantize_kv_int8(k, head_axis=2)
            vq, vs = quantize_kv_int8(v, head_axis=2)
            o8 = flash_decode(q, kq, vq, lens, window=win, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            e8 = close("flash_decode_q8", what + " (K/V int8)", o8, flash_decode_q8_ref(
                qt, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, lens,
                window=win).reshape(o.shape), tol)
            if dn == "float32" and D == 64 and G == 1:
                err["flash_decode"] = max(err["flash_decode"], e)
                err["flash_decode_q8"] = max(err["flash_decode_q8"], e8)
        for B, KH, G, D in ((8, 12, 1, 64), (4, 2, 4, 128), (3, 2, 3, 42)):
            PS, MP = 16, 32
            lengths = [0, 1, PS, PS + 1, MP * PS, 37, 200, 301][:B]
            q, kp, vp, lens, bt = paged_inputs(B, KH, G, D, PS, MP, lengths, dt)
            kq, ks = quantize_kv_int8(kp, head_axis=0)
            vq, vs = quantize_kv_int8(vp, head_axis=0)
            o = paged_decode(q, kq, vq, lens, bt, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            e = close("paged_decode_q8", f"{dn} B={B} KH={KH} G={G} D={D} PS={PS} MP={MP} "
                      f"lengths={lengths} (pool int8)", o, paged_decode_q8_ref(
                          q[:, 0].reshape(B, KH, G, D), kq, vq, ks, vs, lens,
                          bt).reshape(o.shape), tol)
            if not bool((o[0] == 0).all()):
                fail("paged_decode_q8: a dead slot did not give exact zeros")
            if dn == "float32" and G == 1:
                err["paged_decode_q8"] = max(err["paged_decode_q8"], e)

    def partial_pieces(q, k, v, lens, n):
        """flash_decode_partial over the n length pieces of slab caches
        (each with its live prefix clamp(length - r Lc, 0, Lc)), joined as
        sharding.tp.lse_combine joins them."""
        Lc = k.shape[1] // n
        parts = [flash_decode_partial(q, k[:, r * Lc:(r + 1) * Lc], v[:, r * Lc:(r + 1) * Lc],
                                      (lens - r * Lc).clamp(0, Lc).int()) for r in range(n)]
        M = torch.stack([p_[0] for p_ in parts]).amax(0)
        w = [torch.exp(p_[0] - M) for p_ in parts]
        den = sum(wi * p_[1] for wi, p_ in zip(w, parts))
        num = sum(wi[..., None] * p_[2] for wi, p_ in zip(w, parts))
        return num / den.clamp_min(1e-30)[..., None]

    def check_partial(dt, dn):
        """flash_decode_partial (f32 m, l, o whatever q's dtype) against its
        plain version at G 1, 8 and 16 (two head groups), D 64, 128 and
        256, pieces of Lc 65 (not a multiple of the 16-position tile) and
        64, with lengths 0 (every
        piece dead: m -1e30, l 0, o 0 exactly), inside the first piece, on
        a piece's edge and past the cache (L + 1: every piece whole); then
        its pieces over tp 2, 4 and 8 joined as lse_combine joins them,
        against flash_decode on the whole cache."""
        tol = dict(atol=PAGED_TOL["float32"], rtol=PAGED_TOL["float32"])
        for B, KH, G, D, Lc in ((6, 4, 8, 128, 65), (6, 12, 1, 64, 64), (6, 2, 8, 64, 65),
                                (6, 2, 16, 64, 65), (6, 1, 8, 256, 64), (6, 1, 16, 256, 65)):
            for n in (2, 4, 8):
                L = Lc * n
                lengths = [0, 1, Lc, Lc + 1, L, L + 1]
                q, k, v, lens = slab_inputs(B, KH, G, D, L, lengths, dt)
                what = f"{dn} B={B} KH={KH} G={G} D={D} Lc={Lc} tp={n} lengths={lengths}"
                last = slice((n - 1) * Lc, L)
                live = (lens - (n - 1) * Lc).clamp(0, Lc).int()
                m, l, o = flash_decode_partial(q, k[:, last], v[:, last], live)
                torch.cuda.synchronize()
                qt = q[:, 0].reshape(B, KH, G, D)
                ref = flash_decode_partial_ref(qt, k[:, last].transpose(1, 2),
                                               v[:, last].transpose(1, 2), live)
                e = max(close("flash_decode_partial", f"{what} ({x}, piece {n - 1})", got,
                              want.reshape(got.shape), tol)
                        for x, got, want in zip("mlo", (m, l, o), ref))
                dead = live == 0
                if not (bool((m[dead] == -1e30).all()) and bool((l[dead] == 0).all())
                        and bool((o[dead] == 0).all())):
                    fail(f"flash_decode_partial: a piece with no live key did not give "
                         f"(-1e30, 0, 0) exactly ({what})")
                joined = partial_pieces(q, k, v, lens, n)
                whole = flash_decode(q, k, v, lens)
                torch.cuda.synchronize()
                close("flash_decode_partial", f"{what}: pieces joined vs flash_decode on "
                      "the whole cache", whole, joined.reshape(whole.shape).to(dt),
                      dict(atol=PAGED_TOL[dn], rtol=PAGED_TOL[dn]))
                if dn == "float32" and G == 8 and D == 128:
                    err["flash_decode_partial"] = max(err["flash_decode_partial"], e)

    def two_runs(op, fn):
        """fn() once, then again: one launch of op's kernel each (counted
        here) and equal bits."""
        backend.reset_launch_counts()
        o, again = fn(), fn()
        torch.cuda.synchronize()
        if dict(backend.LAUNCH_COUNTS) != {op: 2}:
            fail(f"{op}: two calls counted {dict(backend.LAUNCH_COUNTS)}, expected 2 "
                 f"launches of {op}")
        if not torch.equal(o, again):
            fail(f"{op} is not deterministic")
        return o

    def shifted(t):
        """t's copy one entry into a buffer: no row 16-byte aligned."""
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    def q8_slab(k, v):
        return quantize_kv_int8(k, head_axis=2) + quantize_kv_int8(v, head_axis=2)

    def q8_pool(kp, vp):
        return quantize_kv_int8(kp, head_axis=0) + quantize_kv_int8(vp, head_axis=0)

    def check_decode_split(dt, dn):
        """Both decode pairs' split-K body at the edges of its plan: one slot
        at 511, 512 and 513 of 512 (the naive loop's shape), capacities that
        take S = 1 to 8 (16 to 2048), G 4 and 8, D 20 and 42 (element
        loads), 128 and 256 (two 16-byte pieces a lane in f32), page sizes 1,
        16 and 48, K/V one entry off a 16-byte boundary (bit-equal to the
        aligned copy); each call one launch, two runs bit-equal, dead slots
        exact zeros.  The int8 pair runs each case on K/V quantized per KV
        head, at its own plan (K/V entries int8), against its plain q8
        version."""
        tol = dict(atol=PAGED_TOL[dn], rtol=PAGED_TOL[dn])
        cases = [(1, 12, 1, 64, 512, [n], 0) for n in (511, 512, 513)]
        cases += [(3, 2, G, 64, L, [0, L, L // 2 + 1], win) for L in (16, 33, 96, 1024, 2048)
                  for G, win in ((4, 0), (8, 37))]
        cases += [(4, 2, 2, D, 96, [0, 97, 33, 64], 0) for D in (20, 42, 128, 256)]
        for B, KH, G, D, L, lengths, win in cases:
            q, k, v, lens = slab_inputs(B, KH, G, D, L, lengths, dt)
            qt = q[:, 0].reshape(B, KH, G, D)
            kq, ks, vq, vs = q8_slab(k, v)
            for op, fn, ref, kvd in (
                    ("flash_decode", lambda: flash_decode(q, k, v, lens, window=win),
                     lambda: flash_decode_ref(qt, k.transpose(1, 2), v.transpose(1, 2), lens,
                                              window=win), dt),
                    ("flash_decode_q8",
                     lambda: flash_decode(q, kq, vq, lens, window=win, k_scale=ks, v_scale=vs),
                     lambda: flash_decode_q8_ref(qt, kq.transpose(1, 2), vq.transpose(1, 2),
                                                 ks, vs, lens, window=win), torch.int8)):
                S = decode_plan(L, B, KH, G, D, kvd).splits
                o = two_runs(op, fn)
                what = (f"{dn} B={B} KH={KH} G={G} D={D} L={L} window={win} "
                        f"lengths={lengths} S={S} (one launch a call, two runs bit-equal)")
                close(op, what, o, ref().reshape(o.shape), tol)
                if B > 1 and not bool((o[0] == 0).all()):
                    fail(f"{op}: a dead slot did not give exact zeros ({what})")
        for B, KH, G, D, PS, MP in ([(5, 2, G, 64, PS, -(-300 // PS)) for PS in (1, 16, 48)
                                     for G in (4, 8)]
                                    + [(4, 2, 2, D, 16, 5) for D in (20, 42, 128, 256)]):
            lengths = [0, 1, PS + 1, 255, MP * PS][:B] if B == 5 else [0, 1, 17, 80]
            q, kp, vp, lens, bt = paged_inputs(B, KH, G, D, PS, MP, lengths, dt)
            qt = q[:, 0].reshape(B, KH, G, D)
            kq, ks, vq, vs = q8_pool(kp, vp)
            for op, fn, ref, kvd in (
                    ("paged_decode", lambda: paged_decode(q, kp, vp, lens, bt),
                     lambda: paged_decode_ref(qt, kp, vp, lens, bt), dt),
                    ("paged_decode_q8",
                     lambda: paged_decode(q, kq, vq, lens, bt, k_scale=ks, v_scale=vs),
                     lambda: paged_decode_q8_ref(qt, kq, vq, ks, vs, lens, bt), torch.int8)):
                S = decode_plan(MP * PS, B, KH, G, D, kvd).splits
                o = two_runs(op, fn)
                what = (f"{dn} B={B} KH={KH} G={G} D={D} PS={PS} MP={MP} lengths={lengths} "
                        f"S={S} (one launch a call, two runs bit-equal)")
                close(op, what, o, ref().reshape(o.shape), tol)
                if not bool((o[0] == 0).all()):
                    fail(f"{op}: a dead slot did not give exact zeros ({what})")
        # K/V one entry off a 16-byte boundary: entry loads, the same bits
        q, k, v, lens = slab_inputs(3, 2, 2, 64, 40, [0, 40, 17], dt)
        kq, ks, vq, vs = q8_slab(k, v)
        same = [torch.equal(flash_decode(q, shifted(k), shifted(v), lens),
                            flash_decode(q, k, v, lens)),
                torch.equal(flash_decode(q, shifted(kq), shifted(vq), lens, k_scale=ks,
                                         v_scale=vs),
                            flash_decode(q, kq, vq, lens, k_scale=ks, v_scale=vs))]
        q, kp, vp, lens, bt = paged_inputs(3, 2, 2, 64, 16, 4, [0, 64, 20], dt)
        kq, ks, vq, vs = q8_pool(kp, vp)
        same += [torch.equal(paged_decode(q, shifted(kp), shifted(vp), lens, bt),
                             paged_decode(q, kp, vp, lens, bt)),
                 torch.equal(paged_decode(q, shifted(kq), shifted(vq), lens, bt, k_scale=ks,
                                          v_scale=vs),
                             paged_decode(q, kq, vq, lens, bt, k_scale=ks, v_scale=vs))]
        print(f"[check] flash_decode, flash_decode_q8, paged_decode, paged_decode_q8 {dn}: "
              f"K/V one entry past a 16-byte boundary (entry loads) bit-equal to the "
              f"aligned copy: {same} {'ok' if all(same) else 'FAIL'}")
        if not all(same):
            fail("the decode body's entry loads differ from its 16-byte loads")

    def gather_inputs(M, K, N, r, A, dt):
        return (randn(M, K).to(dev, dt), randn(K, N, std=K ** -0.5).to(dev, dt),
                randn(A, r, K, std=r ** -0.5).to(dev, dt),
                randn(A, N, r, std=0.02).to(dev, dt))

    def check_gather(dt, dn):
        """The gather entry against its plain version: the decode shape
        (M = 8 slots, 8 distinct adapters), repeated and out-of-range
        indices ([-A, 0) counts from the end, the rest are NaN rows),
        ragged M/N/K, ranks 1 and 64; then each tenant's rows bit-equal to
        the single-adapter kernel on them (one body, one arithmetic order)."""
        tol = dict(atol=TOL[dn], rtol=TOL[dn])
        for M, K, N, r, A, kind in ((8, 768, 768, 4, 8, "distinct"),
                                    (16, 768, 768, 4, 8, "repeated"),
                                    (8, 768, 768, 4, 8, "out-of-range"),
                                    (37, 300, 129, 4, 5, "distinct"),
                                    (5, 100, 70, 1, 3, "repeated"),
                                    (33, 768, 768, 64, 4, "distinct"),
                                    (9, 130, 45, 64, 16, "out-of-range")):
            x, w, a, b = gather_inputs(M, K, N, r, A, dt)
            if kind == "distinct":
                idx = torch.arange(M) % A
            elif kind == "repeated":
                idx = torch.tensor([A - 1, 0, A - 1, A - 1, 1 % A])[torch.arange(M) % 5]
            else:
                idx = torch.tensor([-A - 1, -1, A, A + 3, 0, -A, A - 1, 1])[torch.arange(M) % 8]
            idx = idx.to(dev, torch.int32)
            y = lora_matmul_gather_kernel(x, w, a, b, idx, scale)
            torch.cuda.synchronize()
            want = lora_matmul_gathered_ref(x, w, a, b, idx, scale)
            nan_ok = torch.equal(torch.isnan(y), torch.isnan(want))
            fin = torch.isfinite(want)
            e = (y.float() - want.float()).abs()[fin].max().item()
            good = nan_ok and torch.allclose(y.float()[fin], want.float()[fin], **tol)
            print(f"[check] lora_matmul_gather {dn} M={M} K={K} N={N} r={r} A={A} {kind} "
                  f"indices: max_abs_err={e:.3g} atol=rtol={TOL[dn]}, NaN rows where the "
                  f"plain version's: {nan_ok} {'ok' if good else 'FAIL'}")
            if not good:
                fail(f"lora_matmul_gather disagrees with its plain version ({dn}, {kind})")
            if dn == "float32" and K == 768:
                err["lora_matmul_gather"] = max(err["lora_matmul_gather"], e)
        # a row's arithmetic depends on the regime, K and N, not on M or the
        # other rows: at a decode M each tenant's rows alone, at a tile M
        # each tenant's rows first and other rows after them up to T + 1
        # rows (so the call stays in the tile regime at another M)
        K, N, r, A = 768, 768, 4, 8
        for M in (12, 40):
            x, w, a, b = gather_inputs(M, K, N, r, A, dt)
            idx = torch.randint(0, A, (M,), generator=gen)
            y = lora_matmul_gather_kernel(x, w, a, b, idx.to(dev, torch.int32), scale)
            same = True
            for t in range(A):
                rows = (idx == t).to(dev)
                n = int(rows.sum())
                if n == 0:
                    continue
                xt = x[rows]
                if M > DECODE_MAX_M:
                    xt = torch.cat([xt, x[~rows][:max(0, DECODE_MAX_M + 1 - n)]])
                yt = lora_matmul(xt.contiguous(), w, a[t], b[t], scale=scale)[:n]
                same = same and torch.equal(y[rows], yt)
            print(f"[check] lora_matmul_gather {dn} M={M} A={A}: each tenant's rows bit-equal "
                  f"to lora_matmul on them ({'decode' if M <= DECODE_MAX_M else 'tile'} "
                  f"regime both): {same} {'ok' if same else 'FAIL'}")
            if not same:
                fail("the gather's rows differ from the single-adapter kernel's")
        # the same within the single-adapter kernel: a call's first rows
        # equal the call on those rows alone while both take one regime
        # (the tile shape differs: 32 x 32 at M 17, 64 x 64 at M 200)
        x, w, a, b = lora_inputs(200, K, N, r, dt)
        for m_small, m_big in ((3, 16), (17, 200)):
            same = torch.equal(lora_matmul(x[:m_small], w, a, b, scale=scale),
                               lora_matmul(x[:m_big], w, a, b, scale=scale)[:m_small])
            print(f"[check] lora_matmul {dn}: M={m_small} rows bit-equal to the first rows "
                  f"at M={m_big}: {same} {'ok' if same else 'FAIL'}")
            if not same:
                fail(f"lora_matmul's rows depend on M within a regime ({m_small}, {m_big})")

    def ssd_inputs(B, S, nh, hd, N):
        # the distributions of repro's test sweep: B/C ~ N(0, 1/N), dt =
        # softplus(N(0, 1)), A = -exp(linspace(0, 1.5, nh))
        return (randn(B, S, nh, hd).to(dev), randn(B, S, N, std=N ** -0.5).to(dev),
                randn(B, S, N, std=N ** -0.5).to(dev),
                F.softplus(randn(B, S, nh)).to(dev),
                (-torch.exp(torch.linspace(0.0, 1.5, nh))).to(dev))

    def check_ssd():
        """ssd_scan (y and h_last) against ssd_chunked, and against the
        per-token oracle where S <= 256, at repro's four test shapes and
        the full-width Mamba2-2.7B prefill (S 8 and 200: one chunk of S;
        300: a ragged second chunk; 512: two chunks of 256), f32."""
        tol = dict(atol=1e-4, rtol=1e-3)
        for B, S, nh, hd, N, Q in ((2, 64, 4, 32, 16, 16), (1, 100, 2, 16, 8, 32),
                                   (2, 31, 3, 8, 4, 16), (1, 256, 2, 64, 32, 64),
                                   (1, 8, 80, 64, 128, 256), (1, 200, 80, 64, 128, 256),
                                   (1, 300, 80, 64, 128, 256), (1, 512, 80, 64, 128, 256)):
            ins = ssd_inputs(B, S, nh, hd, N)
            y, h = ssd_scan_with_state(*ins, chunk=Q)
            torch.cuda.synchronize()
            what = f"f32 B={B} S={S} nh={nh} hd={hd} N={N} chunk={Q}"
            yr, hr = ssd_chunked(*ins, chunk=Q)
            e = max(close("ssd_scan", what + ": y vs ssd_chunked", y, yr, tol),
                    close("ssd_scan", what + ": h_last vs ssd_chunked", h, hr, tol))
            if S <= 256:
                ys, hs = ssd_sequential_ref(*ins)
                close("ssd_scan", what + ": y vs the per-token oracle", y, ys, tol)
                close("ssd_scan", what + ": h_last vs the per-token oracle", h, hs, tol)
            if nh == 80:
                err["ssd_scan"] = max(err["ssd_scan"], e)
        # the kernel's edges at chunk 256: S 1 to 1024 (four chunks), nh 1, 7
        # and 80, hd 8, 80 (a ragged column tile) and 64, N 3 (element
        # copies), 4, 16, 128 and 256; one launch a call, two runs bit-equal
        for B, S, nh, hd, N in ((1, 1, 1, 8, 4), (1, 7, 7, 8, 16), (1, 64, 80, 64, 128),
                                (1, 65, 7, 80, 128), (1, 256, 1, 64, 256),
                                (1, 257, 80, 64, 128), (1, 1024, 7, 80, 16),
                                (2, 1024, 1, 64, 128), (1, 1024, 80, 64, 128),
                                (1, 200, 80, 80, 256), (2, 65, 80, 8, 4), (1, 100, 7, 64, 3)):
            ins = ssd_inputs(B, S, nh, hd, N)
            backend.reset_launch_counts()
            y, h = ssd_scan_with_state(*ins, chunk=256)
            torch.cuda.synchronize()
            one = dict(backend.LAUNCH_COUNTS) == {"ssd_scan": 1}
            y2, h2 = ssd_scan_with_state(*ins, chunk=256)
            same = torch.equal(y, y2) and torch.equal(h, h2)
            what = f"f32 B={B} S={S} nh={nh} hd={hd} N={N} chunk=256"
            print(f"[check] ssd_scan {what}: one launch {one}, two runs bit-equal {same} "
                  f"{'ok' if one and same else 'FAIL'}")
            if not (one and same):
                fail(f"ssd_scan is not one launch with equal bits ({what})")
            yr, hr = ssd_chunked(*ins, chunk=256)
            close("ssd_scan", what + ": y vs ssd_chunked", y, yr, tol)
            close("ssd_scan", what + ": h_last vs ssd_chunked", h, hr, tol)
            if S <= 256:
                ys, hs = ssd_sequential_ref(*ins)
                close("ssd_scan", what + ": y vs the per-token oracle", y, ys, tol)
                close("ssd_scan", what + ": h_last vs the per-token oracle", h, hs, tol)
        # xdt, Bm and Cm one float off a 16-byte boundary (element copies):
        # the aligned call's bits
        for B, S, nh, hd, N in ((1, 200, 80, 64, 128), (1, 65, 7, 80, 16)):
            xh, Bm, Cm, dts, A = ssd_inputs(B, S, nh, hd, N)
            xdt = (xh * dts[..., None]).permute(0, 2, 1, 3).contiguous()
            g = (dts * A).permute(0, 2, 1).contiguous()

            def off(t):
                buf = torch.empty(t.numel() + 1, device=dev)
                buf[1:] = t.reshape(-1)
                return buf[1:].view(t.shape)

            y, h = ssd_scan_kernel(xdt, g, Bm, Cm, chunk=256)
            yo, ho = ssd_scan_kernel(off(xdt), g, off(Bm), off(Cm), chunk=256)
            torch.cuda.synchronize()
            same = torch.equal(y, yo) and torch.equal(h, ho)
            print(f"[check] ssd_scan f32 B={B} S={S} nh={nh} hd={hd} N={N}: operands off a "
                  f"16-byte boundary bit-equal to aligned {same} {'ok' if same else 'FAIL'}")
            if not same:
                fail("ssd_scan's element copies change its bits")
        # the model's decays (A = -linspace(1, 16), as init_mamba draws it, g
        # = A dt down to ~-70, cum in the thousands inside a chunk) at the
        # full-width prefill of a ragged 300-token prompt: the kernel and
        # ssd_chunked against the per-token oracle in f64, the kernel held
        # at the tolerance and at no more than twice ssd_chunked's distance
        # (f32 prefix sums round exp(cum_t - cum_s) apart at that scale)
        B, S, nh, hd, N, Q = 1, 300, 80, 64, 128, 256
        xh, Bm, Cm, dts, _ = ssd_inputs(B, S, nh, hd, N)
        A = -torch.linspace(1.0, 16.0, nh, device=dev)
        ins = (xh, Bm, Cm, dts, A)
        y, h = ssd_scan_with_state(*ins, chunk=Q)
        yc, hc = ssd_chunked(*ins, chunk=Q)
        y64, h64 = ssd_sequential_ref(*(t.double() for t in ins))
        torch.cuda.synchronize()
        what = f"f32 B={B} S={S} nh={nh} hd={hd} N={N} chunk={Q}, the model's decays"
        e = max(close("ssd_scan", what + ": y vs the f64 oracle", y, y64, tol),
                close("ssd_scan", what + ": h_last vs the f64 oracle", h, h64, tol))
        err["ssd_scan"] = max(err["ssd_scan"], e)
        dist = {n: [((a.double() - r).abs().max() / r.abs().max()).item() for a in (k, c)]
                for n, k, c, r in (("y", y, yc, y64), ("h_last", h, hc, h64))}
        good = all(k <= 2 * c for k, c in dist.values())
        print(f"[check] ssd_scan {what}: distance from the f64 oracle relative to its "
              "largest entry, kernel vs ssd_chunked: " + ", ".join(
                  f"{n} {k:.3g} vs {c:.3g}" for n, (k, c) in dist.items())
              + f" (kernel held at <= 2x) {'ok' if good else 'FAIL'}")
        if not good:
            fail("ssd_scan rounds further from the f64 oracle than ssd_chunked")

    scale = 2.0                       # GPT-2-S: lora_alpha / lora_rank = 8 / 4
    err = {"ssd_scan": 0.0, "lora_matmul": 0.0, "lora_matmul_gather": 0.0, "paged_decode": 0.0, "lora_matmul_dx": 0.0,
           "lora_rank_reduce": 0.0, "flash_attention": 0.0, "lora_matmul_q8": 0.0,
           "lora_matmul_q8_dx": 0.0, "flash_decode": 0.0, "flash_decode_q8": 0.0,
           "paged_decode_q8": 0.0, "flash_decode_partial": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        # both regimes (M <= 16 decode, above it the 3xTF32 tile), both sides
        # of the threshold, Mamba2's projections at decode and prefill M,
        # ragged shapes whose pitches take element copies
        for M, K, N, r in ((8, 768, 768, 4), (16, 768, 768, 4), (17, 768, 768, 4),
                           (768, 768, 768, 4), (5, 100, 70, 3), (33, 300, 129, 64),
                           (1, 7, 1, 1), (8, 2560, 10576, 4), (8, 5120, 2560, 4),
                           (200, 2560, 10576, 4), (200, 5120, 2560, 4)):
            x, w, a, b = lora_inputs(M, K, N, r, dt)
            y = lora_matmul(x, w, a, b, scale=scale)
            torch.cuda.synchronize()
            yr = lora_matmul_ref(x, w, a, b, scale)
            e = (y.float() - yr.float()).abs().max().item()
            good = torch.allclose(y.float(), yr.float(), atol=TOL[dn], rtol=TOL[dn])
            print(f"[check] lora_matmul {dn} M={M} K={K} N={N} r={r}: "
                  f"max_abs_err={e:.3g} tol={TOL[dn]} {'ok' if good else 'FAIL'}")
            if not good:
                fail(f"lora_matmul disagrees with its plain version ({dn}, M={M})")
            if dn == "float32" and K == 768:
                err["lora_matmul"] = max(err["lora_matmul"], e)
        check_gather(dt, dn)
        for B, KH, G, D in ((8, 12, 1, 64), (4, 2, 4, 128)):
            PS, MP = 16, 32
            lengths = [0, 1, PS, PS + 1, MP * PS, 37, 200, 301][:B]
            q, kp, vp, lens, bt = paged_inputs(B, KH, G, D, PS, MP, lengths, dt)
            o = paged_decode(q, kp, vp, lens, bt)
            torch.cuda.synchronize()
            orf = paged_decode_ref(q[:, 0].reshape(B, KH, G, D), kp, vp, lens,
                                   bt).reshape(o.shape)
            e = (o.float() - orf.float()).abs().max().item()
            tol = PAGED_TOL[dn]
            good = (torch.allclose(o.float(), orf.float(), atol=tol, rtol=tol)
                    and bool((o[0] == 0).all()) and bool(torch.isfinite(o).all()))
            print(f"[check] paged_decode {dn} B={B} KH={KH} G={G} D={D} PS={PS} "
                  f"MP={MP} lengths={lengths}: max_abs_err={e:.3g} tol={tol} "
                  f"dead-slot zeros={bool((o[0] == 0).all())} {'ok' if good else 'FAIL'}")
            if not good:
                fail(f"paged_decode disagrees with its plain version ({dn}, G={G})")
            if dn == "float32" and G == 1:
                err["paged_decode"] = max(err["paged_decode"], e)
        check_backward(dt, dn)
        check_attention(dt, dn)
        check_q8(dt, dn)
        check_decode(dt, dn)
        check_partial(dt, dn)
        check_decode_split(dt, dn)
    check_ssd()                       # f32 in and out: the op casts

    tune_line("phase 3")

    # -- 4. times at the serving path's shapes (f32, as the engine serves) --
    # reading 64 MB (> the 50 MB L2) between launches evicts the operands,
    # as the decode path finds them: 12 layers of weights and KV pools
    # pass through L2 between two calls of one layer's kernel
    flush_buf = torch.ones(16 * 2 ** 20, dtype=torch.int32, device=dev)
    flush = flush_buf.sum
    rows = {}
    for M in (8, 16):
        K = N = 768
        r = 4
        x, w, a, b = lora_inputs(M, K, N, r, torch.float32)
        ms = time_ms(torch, lambda: lora_matmul(x, w, a, b, scale=scale), flush)
        warm = time_ms(torch, lambda: lora_matmul(x, w, a, b, scale=scale), lambda: None)
        b2b = host_us(torch, lambda: lora_matmul(x, w, a, b, scale=scale))
        plain = time_ms(torch, lambda: lora_matmul_ref(x, w, a, b, scale), flush)
        lib = time_ms(torch, lambda: x @ w + scale * ((x @ a.T) @ b.T), flush)
        nbytes = 4 * (M * K + K * N + r * K + N * r + M * N)
        flops = lora_flops(M, K, N, r)
        t_bytes = nbytes / _limits().HBM_BYTES_PER_S * 1e3
        t_ops = flops / _limits().PEAK_FLOPS["float32"] * 1e3
        rows[("lora_matmul", M)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                        bound_ms=max(t_bytes, t_ops),
                                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"[time] lora_matmul f32 M={M} K={K} N={N} r={r}: kernel {ms * 1e3:.2f}us "
              f"plain {plain * 1e3:.2f}us library(torch.matmul) {lib * 1e3:.2f}us "
              f"bound {max(t_bytes, t_ops) * 1e3:.2f}us ({nbytes} B, {flops} flop); "
              f"kernel with L2 warm {warm * 1e3:.2f}us; back-to-back {b2b:.2f}us/call "
          f"(host clock, L2 warm)")
    # the gather at the multi-tenant decode shape: 8 slots, 8 distinct adapters
    M, K, N, r, A = 8, 768, 768, 4, 8
    x, w, a, b = gather_inputs(M, K, N, r, A, torch.float32)
    idx = torch.arange(M, dtype=torch.int32, device=dev) % A
    ms = time_ms(torch, lambda: lora_matmul_gather_kernel(x, w, a, b, idx, scale), flush)
    warm = time_ms(torch, lambda: lora_matmul_gather_kernel(x, w, a, b, idx, scale),
                   lambda: None)
    plain = time_ms(torch, lambda: lora_matmul_gathered_ref(x, w, a, b, idx, scale), flush)

    def gather_library():
        il = idx.long()
        z = torch.bmm(x[:, None], a[il].transpose(1, 2))                  # (M, 1, r)
        return x @ w + scale * torch.bmm(z, b[il].transpose(1, 2))[:, 0]

    lib = time_ms(torch, gather_library, flush)
    used = len(set(idx.tolist()))
    nbytes = 4 * (M * K + K * N + used * (r * K + N * r) + M * N + M)
    bms, bby = bound(nbytes, lora_flops(M, K, N, r))
    rows[("lora_matmul_gather", M)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                           bound_ms=bms, bound_by=bby)
    print(f"[time] lora_matmul_gather f32 M={M} K={K} N={N} r={r} A={A} ({used} adapters "
          f"used): kernel {ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(x @ w + "
          f"s*bmm(bmm(x, A[idx]^T), B[idx]^T)) {lib * 1e3:.2f}us bound {bms * 1e3:.2f}us "
          f"({bby}, {nbytes} B); kernel with L2 warm {warm * 1e3:.2f}us")
    B, KH, G, D, PS, MP = 8, 12, 1, 64, 16, 32
    lengths = [8, 40, 77, 120, 160, 200, 232, 255]      # serving-like spread
    q, kp, vp, lens, bt = paged_inputs(B, KH, G, D, PS, MP, lengths, torch.float32)
    qt = q[:, 0].reshape(B, KH, G, D)
    ms = time_ms(torch, lambda: paged_decode(q, kp, vp, lens, bt), flush)
    warm = time_ms(torch, lambda: paged_decode(q, kp, vp, lens, bt), lambda: None)
    b2b = host_us(torch, lambda: paged_decode(q, kp, vp, lens, bt))
    plain = time_ms(torch, lambda: paged_decode_ref(qt, kp, vp, lens, bt), flush)
    L = MP * PS
    sdpa_mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]

    def library():
        k = kp[:, bt.long()].permute(1, 0, 2, 3, 4).reshape(B, KH, L, D)
        v = vp[:, bt.long()].permute(1, 0, 2, 3, 4).reshape(B, KH, L, D)
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=sdpa_mask)

    lib = time_ms(torch, library, flush)
    tot = sum(lengths)
    nbytes = (4 * (2 * B * KH * G * D + 2 * KH * tot * D) + 4 * B
              + 4 * sum(math.ceil(n / PS) for n in lengths))
    flops = 4 * KH * G * D * tot
    t_bytes = nbytes / _limits().HBM_BYTES_PER_S * 1e3
    t_ops = flops / _limits().PEAK_FLOPS["float32"] * 1e3
    rows[("paged_decode", B)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                     bound_ms=max(t_bytes, t_ops),
                                     bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"[time] paged_decode f32 B={B} KH={KH} G={G} D={D} PS={PS} lengths={lengths}: "
          f"kernel {ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(gather+sdpa) "
          f"{lib * 1e3:.2f}us bound {max(t_bytes, t_ops) * 1e3:.2f}us ({nbytes} B, {flops} flop); "
          f"kernel with L2 warm {warm * 1e3:.2f}us; back-to-back {b2b:.2f}us/call "
          f"(host clock, L2 warm)")
    # the decode family at the same shape over slab caches of 512 positions
    # (the slab engine's) and over the same int8 pool
    L = MP * PS
    q, k, v, lens = slab_inputs(B, KH, G, D, L, lengths, torch.float32)
    qt = q[:, 0].reshape(B, KH, G, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)              # views, no copy
    kq, ks = quantize_kv_int8(k, head_axis=2)
    vq, vs = quantize_kv_int8(v, head_axis=2)
    kpq, kps = quantize_kv_int8(kp, head_axis=0)
    vpq, vps = quantize_kv_int8(vp, head_axis=0)

    def deq(t, s_, axis):
        shape = [1] * t.dim()
        shape[axis] = -1
        return t.float() * s_.reshape(shape)

    def paged_deq_sdpa():
        kf, vf = deq(kpq, kps, 0), deq(vpq, vps, 0)
        kg = kf[:, bt.long()].permute(1, 0, 2, 3, 4).reshape(B, KH, L, D)
        vg = vf[:, bt.long()].permute(1, 0, 2, 3, 4).reshape(B, KH, L, D)
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=sdpa_mask)

    tables = 4 * sum(math.ceil(n / PS) for n in lengths)
    qo = 4 * 2 * B * KH * G * D                                # q read, out written
    for op, kern, plain_fn, lib_fn, lib_name, nbytes in (
            ("flash_decode", lambda: flash_decode(q, k, v, lens),
             lambda: flash_decode_ref(qt, kt, vt, lens),
             lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask),
             "masked SDPA over the slab view", qo + 4 * 2 * KH * tot * D + 4 * B),
            ("flash_decode_q8", lambda: flash_decode(q, kq, vq, lens, k_scale=ks, v_scale=vs),
             lambda: flash_decode_q8_ref(qt, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs,
                                         lens),
             lambda: F.scaled_dot_product_attention(
                 qt, deq(kq, ks, 2).transpose(1, 2), deq(vq, vs, 2).transpose(1, 2),
                 attn_mask=sdpa_mask),
             "dequantize + masked SDPA", qo + 2 * KH * tot * D + 4 * B + 2 * 4 * KH),
            ("paged_decode_q8", lambda: paged_decode(q, kpq, vpq, lens, bt, k_scale=kps,
                                                     v_scale=vps),
             lambda: paged_decode_q8_ref(qt, kpq, vpq, kps, vps, lens, bt),
             paged_deq_sdpa, "dequantize + gather + SDPA",
             qo + 2 * KH * tot * D + 4 * B + tables + 2 * 4 * KH)):
        ms = time_ms(torch, kern, flush)
        warm = time_ms(torch, kern, lambda: None)
        plain = time_ms(torch, plain_fn, flush)
        lib = time_ms(torch, lib_fn, flush)
        bms, bby = bound(nbytes, 4 * KH * G * D * tot)
        rows[(op, B)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                             bound_by=bby)
        print(f"[time] {op} f32 q, B={B} KH={KH} G={G} D={D} L={L} lengths={lengths}: "
              f"kernel {ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library({lib_name}) "
              f"{lib * 1e3:.2f}us bound {bms * 1e3:.2f}us ({bby}, {nbytes} B); kernel "
              f"with L2 warm {warm * 1e3:.2f}us")
    # the split-K body against the length of its walks, f32 q over f32 and
    # int8 K/V: all 8 slots at one length (16, 128, 511), then one slot at
    # 511 (the naive loop's shape), each at the plan's split S
    for B_, n in ((8, 16), (8, 128), (8, 511), (1, 511)):
        qs_, ks_, vs_, ls_ = slab_inputs(B_, KH, G, D, L, [n] * B_, torch.float32)
        qp_, kp_, vp_, lp_, bt_ = paged_inputs(B_, KH, G, D, PS, MP, [n] * B_, torch.float32)
        s8 = q8_slab(ks_, vs_)
        p8 = q8_pool(kp_, vp_)
        for op, fn, nb in (
                ("flash_decode", lambda: flash_decode(qs_, ks_, vs_, ls_), 4),
                ("paged_decode", lambda: paged_decode(qp_, kp_, vp_, lp_, bt_), 4),
                ("flash_decode_q8", lambda: flash_decode(qs_, s8[0], s8[2], ls_, k_scale=s8[1],
                                                         v_scale=s8[3]), 1),
                ("paged_decode_q8", lambda: paged_decode(qp_, p8[0], p8[2], lp_, bt_,
                                                         k_scale=p8[1], v_scale=p8[3]), 1)):
            S = decode_plan(L, B_, KH, G, D, torch.float32 if nb == 4 else torch.int8).splits
            bms, _ = bound(4 * 2 * B_ * KH * G * D + nb * 2 * KH * B_ * n * D + 4 * B_
                           + (4 * B_ * -(-n // PS) if op.startswith("paged") else 0)
                           + (2 * 4 * KH if nb == 1 else 0),
                           4 * KH * G * D * B_ * n)
            print(f"[sweep] decode {op} f32 q B={B_} KH={KH} G={G} D={D} capacity {L} "
                  f"(pages of {PS}) every length {n}: S={S} ({B_ * KH * S} blocks), kernel "
                  f"{time_ms(torch, fn, flush) * 1e3:.2f}us, bound {bms * 1e3:.2f}us")
    # the partial-softmax entry at the shape phase 20 (b) gives it (yi-9b's
    # piece of the cache at tp 8, every piece full: ranks 0-6 at every
    # decode step), then a [sweep] over longer pieces and GPT-2-S's
    for i, (what, shape) in enumerate(PARTIAL_SHAPES):
        r_ = time_partial(torch, dev, flush, flash_decode_partial, *shape)
        B, KH, G, D, Lc = shape
        if i == 0:
            rows[("flash_decode_partial", B)] = {k_: r_[k_] for k_ in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        print(f"[{'time' if i == 0 else 'sweep'}] flash_decode_partial f32, {what}: B={B} "
              f"KH={KH} G={G} D={D} Lc={Lc}, every piece full, plan {r_['plan']}: kernel "
              f"{r_['ms'] * 1e3:.2f}us plain {r_['plain_ms'] * 1e3:.2f}us library("
              f"{PARTIAL_LIBRARY}) " + (f"{r_['library_ms'] * 1e3:.2f}us"
                                        if r_['library_ms'] is not None else r_['refused'])
              + f" bound {r_['bound_ms'] * 1e3:.2f}us ({r_['bound_by']}, {r_['bytes']} B); "
              f"kernel with L2 warm {r_['warm_ms'] * 1e3:.2f}us")

    # -- 4b. times at the training path's shapes (f32) -------------------------
    # the forward and dX at M above the decode threshold run the 3xTF32
    # tile: their bound is 3 TF32 products per f32 product over 495 TFLOP/s
    # (or the bytes), with the f32-FFMA bound printed beside it; two runs on
    # the same inputs must give equal bits (no atomics)
    def same_bits(op, what, fn):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        good = torch.equal(first, again)
        print(f"[check] {op} {what}: two runs bit-equal: {good} {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"{op} is not deterministic ({what})")

    M, K, N, r = 768, 768, 768, 4
    x, w, a, b = lora_inputs(M, K, N, r, torch.float32)
    same_bits("lora_matmul", f"f32 M={M} K={K} N={N} r={r}",
              lambda: lora_matmul(x, w, a, b, scale=scale))
    ms = time_ms(torch, lambda: lora_matmul(x, w, a, b, scale=scale), flush)
    plain = time_ms(torch, lambda: lora_matmul_ref(x, w, a, b, scale), flush)
    lib = time_ms(torch, lambda: x @ w + scale * ((x @ a.T) @ b.T), flush)
    nbytes = 4 * (M * K + K * N + r * K + N * r + M * N)
    flops = lora_flops(M, K, N, r)
    bms, bby = bound_tf32(nbytes, flops, 3)
    rows[("lora_matmul", M)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                                    bound_by=bby)
    print(f"[time] lora_matmul f32 M={M} K={K} N={N} r={r} (training M, tile regime): "
          f"kernel {ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(torch.matmul) "
          f"{lib * 1e3:.2f}us bound {bms * 1e3:.2f}us (3xTF32, {bby}; f32 FFMA bound "
          f"{bound(nbytes, flops)[0] * 1e3:.2f}us); {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    for M in (256, 768):               # one client's rows; the server's rows
        dy = randn(M, N).to(dev)
        _, w, a, b = lora_inputs(M, K, N, r, torch.float32)
        if M == 256:
            same_bits("lora_matmul_dx", f"f32 M={M} K={K} N={N} r={r}",
                      lambda: lora_matmul_dx_kernel(dy, w, a, b, scale))
        ms = time_ms(torch, lambda: lora_matmul_dx_kernel(dy, w, a, b, scale), flush)
        plain = time_ms(torch, lambda: lora_matmul_dx_ref(dy, w, a, b, scale), flush)
        lib = time_ms(torch, lambda: dy @ w.T + scale * ((dy @ b) @ a), flush)
        nbytes = 4 * (M * N + K * N + r * K + N * r + M * K)
        flops = lora_flops(M, K, N, r)
        bms, bby = bound_tf32(nbytes, flops, 3)
        rows[("lora_matmul_dx", M)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                           bound_ms=bms, bound_by=bby)
        print(f"[time] lora_matmul_dx f32 M={M} K={K} N={N} r={r}: kernel "
              f"{ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(dy @ w.T + "
              f"s*(dy @ b) @ a) {lib * 1e3:.2f}us bound {bms * 1e3:.2f}us (3xTF32, {bby}; "
              f"f32 FFMA bound {bound(nbytes, flops)[0] * 1e3:.2f}us); "
              f"{2 * M * N * K / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    # the rank reduce at the server's rows (M = 768) and a client's (256),
    # at phase 6's rank 4 and the fleets' rank 8, f32 and bf16 v: one launch
    for M, r, vdt in ((768, 4, torch.float32), (256, 4, torch.float32),
                      (768, 8, torch.float32), (768, 4, torch.bfloat16)):
        N = 768
        u, v = randn(M, r).to(dev), randn(M, N).to(dev, vdt)
        ms = time_ms(torch, lambda: lora_rank_reduce_kernel(u, v), flush)
        plain = time_ms(torch, lambda: lora_rank_reduce_ref(u, v), flush)
        lib = time_ms(torch, lambda: u.T @ v.float(), flush)
        nbytes = 4 * (M * r + r * N) + v.element_size() * M * N
        bms, bby = bound(nbytes, 2 * M * r * N)
        vn = str(vdt).split(".")[1]
        key = ("lora_rank_reduce", M) if (r, vdt) == (4, torch.float32) else (
            "lora_rank_reduce", M, r, vn)
        rows[key] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=bby)
        print(f"[time] lora_rank_reduce u f32, v {vn} M={M} r={r} N={N}: kernel "
              f"{ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(u.T @ v) "
              f"{lib * 1e3:.2f}us bound {bms * 1e3:.2f}us ({bby}, {nbytes} B); "
              f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    # flash attention on the 3xTF32 tensor-core tiles: its bound is three
    # TF32 products per f32 product over 495 TFLOP/s (or the bytes), with
    # the f32-FFMA bound printed beside it
    for B, S in ((12, 64), (1, 1024)):     # the training batch; one long sequence
        H = KH = 12
        D = 64
        q, k, v = (randn(B, S, H, D).to(dev) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = time_ms(torch, lambda: flash_attention(q, k, v), flush)
        plain = time_ms(torch, lambda: flash_attention_ref(q, k, v), flush)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush)
        visible = S * (S + 1) // 2                  # causal pairs per head
        nbytes = 4 * (2 * B * S * H * D + 2 * B * S * KH * D)
        flops = 4 * B * H * visible * D
        bms, bby = bound_tf32(nbytes, flops, 3)
        rows[("flash_attention", B)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                            bound_ms=bms, bound_by=bby)
        print(f"[time] flash_attention f32 B={B} S={S} H={H} D={D} causal: kernel "
              f"{ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(SDPA is_causal, "
              f"(B, H, S, D) layout) {lib * 1e3:.2f}us bound {bms * 1e3:.2f}us (3xTF32, "
              f"{bby}; f32 FFMA bound {bound(nbytes, flops)[0] * 1e3:.2f}us); "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    # what any launch costs under time_ms (a 4-float add_), and the
    # attention kernel's time against the length of its longest KV walk
    # (S / 64 tiles) and the grid: two warp groups share walks of 4 tiles
    # and more while the grid has fewer blocks than two per SM (B 1), one
    # group takes the rest (B 12 at S 256: 576 blocks)
    x4 = torch.zeros(4, device=dev)
    floor = time_ms(torch, lambda: x4.add_(1), flush)
    print(f"[floor] time_ms of one 4-float add_: {floor * 1e3:.2f}us")
    for B, S in ((1, 64), (1, 128), (1, 192), (1, 256), (12, 256), (1, 512), (1, 1024)):
        q, k, v = (randn(B, S, 12, 64).to(dev) for _ in range(3))
        print(f"[sweep] flash_attention f32 B={B} S={S} H=12 D=64 causal ({-(-S // 64)} KV "
              f"tiles, {12 * B * -(-S // 64)} blocks): kernel "
              f"{time_ms(torch, lambda: flash_attention(q, k, v), flush) * 1e3:.2f}us")
    # the int8-base kernels at the fleets' training shapes: a client's rows
    # (M = b * S = 256) and the pooled server's (M = 768), r = 8; on the
    # TF32 tile in two passes (the int8 W is exact in TF32): their bound is
    # two TF32 products per f32 product, the f32-FFMA bound beside it.  Also
    # at r = 4, the rank of the f32 tile's rows above: the rank tile Z = L U
    # is f32 FFMA, BM * r * 32 per chunk beside the tensor-core product
    for M, r in ((256, 8), (768, 8), (768, 4)):
        K = N = 768
        x, wq, ws, a, b = q8_inputs(M, K, N, r, torch.float32)
        dy = randn(M, N).to(dev)
        if M == 256:
            same_bits("lora_matmul_q8", f"f32 M={M} K={K} N={N} r={r}",
                      lambda: lora_matmul_q8_kernel(x, wq, ws, a, b, scale))
            same_bits("lora_matmul_q8_dx", f"f32 M={M} K={K} N={N} r={r}",
                      lambda: lora_matmul_q8_dx_kernel(dy, wq, ws, a, b, scale))
        for op, kern, plain_fn, lib_fn, nbytes in (
                ("lora_matmul_q8", lambda: lora_matmul_q8_kernel(x, wq, ws, a, b, scale),
                 lambda: lora_matmul_q8_ref(x, wq, ws, a, b, scale),
                 lambda: x @ (wq.float() * ws) + scale * ((x @ a.T) @ b.T),
                 4 * M * K + K * N + 4 * N + 4 * r * K + 4 * N * r + 4 * M * N),
                ("lora_matmul_q8_dx",
                 lambda: lora_matmul_q8_dx_kernel(dy, wq, ws, a, b, scale),
                 lambda: lora_matmul_q8_dx_ref(dy, wq, ws, a, b, scale),
                 lambda: dy @ (wq.float() * ws).T + scale * ((dy @ b) @ a),
                 4 * M * N + K * N + 4 * N + 4 * r * K + 4 * N * r + 4 * M * K)):
            ms = time_ms(torch, kern, flush)
            plain = time_ms(torch, plain_fn, flush)
            lib = time_ms(torch, lib_fn, flush)
            flops = lora_flops(M, K, N, r)
            bms, bby = bound_tf32(nbytes, flops, 2)
            rows[(op, M) if r == 8 else (op, M, r)] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=bby)
            print(f"[time] {op} f32 M={M} K={K} N={N} r={r} (W int8): kernel "
                  f"{ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(dequantize + "
                  f"torch.matmul) {lib * 1e3:.2f}us bound {bms * 1e3:.2f}us (2xTF32, "
                  f"{bby}, {nbytes} B; f32 FFMA bound {bound(nbytes, flops)[0] * 1e3:.2f}us); "
                  f"{2 * M * N * K / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    # -- 4c. times at Mamba2-2.7B's serving shapes (f32) -----------------------
    # lora_matmul at a decode step's projections (8 slots: the decode
    # regime) and at a 200-token prefill (the tile regime): ssm_in (K 2560,
    # N 2 * 5120 + 2 * 128 + 80) and ssm_out (K 5120, N 2560)
    for M in (8, 200):
        for what, K, N in (("ssm_in", 2560, 10576), ("ssm_out", 5120, 2560)):
            r = 4
            x, w, a, b = lora_inputs(M, K, N, r, torch.float32)
            if M == 8 and what == "ssm_out":
                same_bits("lora_matmul", f"f32 M={M} K={K} N={N} r={r}",
                          lambda: lora_matmul(x, w, a, b, scale=scale))
            ms = time_ms(torch, lambda: lora_matmul(x, w, a, b, scale=scale), flush)
            plain = time_ms(torch, lambda: lora_matmul_ref(x, w, a, b, scale), flush)
            lib = time_ms(torch, lambda: x @ w + scale * ((x @ a.T) @ b.T), flush)
            nbytes = 4 * (M * K + K * N + r * K + N * r + M * N)
            flops = lora_flops(M, K, N, r)
            tile = M > DECODE_MAX_M
            bms, bby = bound_tf32(nbytes, flops, 3) if tile else bound(nbytes, flops)
            rows[("lora_matmul", what, M)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                                  bound_ms=bms, bound_by=bby)
            print(f"[time] lora_matmul f32 M={M} K={K} N={N} r={r} (Mamba2 {what}, "
                  f"{'tile' if tile else 'decode'} regime): kernel {ms * 1e3:.2f}us plain "
                  f"{plain * 1e3:.2f}us library(torch.matmul) {lib * 1e3:.2f}us bound "
                  f"{bms * 1e3:.2f}us ({'3xTF32, ' if tile else ''}{bby}"
                  + (f"; f32 FFMA bound {bound(nbytes, flops)[0] * 1e3:.2f}us" if tile else "")
                  + f"); {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s, "
                  f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    # -- 4d. the regime crossover: each regime forced at every M ---------------
    # (the decode regime re-reads W once per 16 rows; the tile pays three
    # TF32 products per f32 product but reads W once per 64 rows)
    for what, K, N in (("K=N=768", 768, 768), ("ssm_in", 2560, 10576)):
        r = 4
        for M in (1, 8, 16, 17, 32, 64, 200, 768):
            x, w, a, b = lora_inputs(M, K, N, r, torch.float32)
            t = {reg: time_ms(torch, lambda: lora_matmul_kernel(x, w, a, b, scale, regime=reg),
                              flush, iters=20, warmup=2) for reg in (DECODE, TILE)}
            lib = time_ms(torch, lambda: x @ w + scale * ((x @ a.T) @ b.T), flush, iters=20,
                          warmup=2)
            pick = "decode" if M <= DECODE_MAX_M else "tile"
            print(f"[sweep] lora_matmul f32 {what} M={M}: decode regime {t[DECODE] * 1e3:.2f}us, "
                  f"tile regime {t[TILE] * 1e3:.2f}us, library {lib * 1e3:.2f}us; the plan "
                  f"takes {pick} (T = {DECODE_MAX_M})")
    # the SSD scan at the full-width prefill: the kernel alone on its
    # pre-scaled operands, the op (pre-scaling, kernel, layout) and the
    # plain ssd_chunked (its median, min and max over the 60 calls); no
    # single PyTorch call computes the scan.  Bound: 3xTF32 (three TF32
    # products per f32 product), the f32 FFMA bound beside; [sweep] over S
    B, nh, hd, N, chunk = 1, 80, 64, 128, 256
    for S in (200, 512, 8, 64, 1024):
        xh, Bm, Cm, dts, A = ssd_inputs(B, S, nh, hd, N)
        Q = min(chunk, S)
        xdt = (xh * dts[..., None]).permute(0, 2, 1, 3).contiguous()
        g = (dts * A).permute(0, 2, 1).contiguous()
        # the work these inputs need (the kernel op's FLOP formula); each
        # operand read once and y, h_last written once
        flops = scan_flops(B, nh, S, hd, N, Q)
        nbytes = 4 * (2 * B * nh * S * hd + B * nh * S + 2 * B * S * N + B * nh * hd * N)
        bms, bby = bound_tf32(nbytes, flops, 3)
        ms = time_ms(torch, lambda: ssd_scan_kernel(xdt, g, Bm, Cm, chunk=Q), flush)
        if S not in (200, 512):
            print(f"[sweep] ssd_scan f32 B={B} S={S} nh={nh} hd={hd} N={N} chunk={chunk}: "
                  f"kernel {ms * 1e3:.2f}us, bound {bms * 1e3:.2f}us (3xTF32, {bby}; f32 FFMA "
                  f"{bound(nbytes, flops)[0] * 1e3:.2f}us)")
            continue
        op = time_ms(torch, lambda: ssd_scan_with_state(xh, Bm, Cm, dts, A, chunk=chunk),
                     flush)
        plain, plain_min, plain_max = time_ms(
            torch, lambda: ssd_chunked(xh, Bm, Cm, dts, A, chunk=chunk), flush, spread=True)
        rows[("ssd_scan", S)] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms,
                                     bound_by=bby)
        print(f"[time] ssd_scan f32 B={B} S={S} nh={nh} hd={hd} N={N} chunk={chunk}: kernel "
              f"{ms * 1e3:.2f}us (op with pre-scaling {op * 1e3:.2f}us) plain ssd_chunked "
              f"{plain * 1e3:.2f}us (min {plain_min * 1e3:.2f}, max {plain_max * 1e3:.2f}) "
              f"library none; bound {bms * 1e3:.2f}us (3xTF32, {bby}, {flops} flop, "
              f"{nbytes} B; f32 FFMA bound {bound(nbytes, flops)[0] * 1e3:.2f}us); "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    del flush_buf

    tune_line("phase 4")

    # -- 5. serving on full-width GPT-2-S ------------------------------------
    cfg = get_arch("gpt2-s")
    t0 = time.perf_counter()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cuda")
    lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(1), None,
                              torch.float32, "cuda")
    g_b = torch.Generator().manual_seed(2)
    for layer in lora:           # B != 0, or the rank path would be a no-op
        for ad in layer["mixer"].values():
            ad["b"].copy_(torch.randn(ad["b"].shape, generator=g_b) * 0.02)
    print(f"[serve] GPT-2-S full width: {cfg.num_layers} layers d={cfg.d_model} "
          f"vocab={cfg.vocab_size} max_seq_len={cfg.max_seq_len}, f32, LoRA r="
          f"{cfg.lora_rank} on {cfg.lora_targets}; init {time.perf_counter() - t0:.1f}s")
    eng = ServingEngine(cfg, params, lora=lora, max_slots=8, max_len=512,
                        page_size=16, device="cuda")
    eng.submit(Request(uid=1000, prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
    eng.run()                            # first-call set-up, not measured
    for k in eng.stats:
        eng.stats[k] = 0
    rng = np.random.default_rng(0)
    plens = rng.permutation(np.linspace(8, 200, 16).astype(int))
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                    max_new_tokens=32) for i, n in enumerate(plens)]
    for r_ in reqs:
        eng.submit(r_)
    backend.reset_launch_counts()        # just before the main path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(backend.LAUNCH_COUNTS)
    st = eng.stats
    n_tok = sum(len(r_.output) for r_ in reqs)
    print(f"[serve] {len(reqs)} requests, prompts {int(plens.min())}-{int(plens.max())} "
          f"tokens, 32 new each, greedy: {n_tok} tokens in {wall:.3f}s = "
          f"{n_tok / wall:.1f} tok/s; {st['decode_steps']} decode steps, mean "
          f"{st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f} ms/step; "
          f"{st['prefill_chunks']} prefill chunks, {st['prefill_s'] * 1e3:.1f} ms total "
          f"({st['prefill_s'] / max(st['prefill_chunks'], 1) * 1e3:.2f} ms/chunk)")
    print(f"[serve] launches during the run: {launches}")
    if not all(r_.done and len(r_.output) == 32 for r_ in reqs):
        fail("not every request finished with 32 tokens")
    if not eng.check_consistency(resync=False) or eng.pages_in_use() != 0:
        fail("page accounting inconsistent after drain")
    want = {"lora_matmul": 2 * cfg.num_layers * (st["decode_steps"] + st["prefill_chunks"]),
            "paged_decode": cfg.num_layers * st["decode_steps"]}
    for k, v in want.items():
        if launches.get(k, 0) == 0 or launches.get(k) != v:
            fail(f"{k}: {launches.get(k, 0)} launches on the main path, expected {v}")
    print(f"[serve] launch counts match the path: {want} "
          f"(24 lora_matmul per decode step and per chunk, 12 paged_decode per step)")
    print(f"[serve] token ids digest of the {len(reqs)} requests: {ids_digest(reqs)}")

    # one decode step, kernel path vs plain path, on the same state
    B = 8
    caches = TM.init_paged_cache(cfg, 8 * 32 + 1, 16, torch.float32, "cuda")
    for c in caches:
        c["k"].normal_(generator=torch.Generator(device=dev).manual_seed(3))
        c["v"].normal_(generator=torch.Generator(device=dev).manual_seed(4))
    pos = torch.tensor(lengths, dtype=torch.int32)
    bt = torch.zeros(B, 32, dtype=torch.int32)
    pages = torch.randperm(8 * 32, generator=gen) + 1
    for b_, n in enumerate(lengths):
        bt[b_, :n // 16 + 1] = pages[b_ * 32:b_ * 32 + n // 16 + 1].int()
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    outs = []
    for rt in (TM.default_serve_runtime(), TM.Runtime()):
        cc = [{k: v.clone() for k, v in c.items()} for c in caches]
        logits, cc = TM.paged_decode_step(cfg, eng.params, tok.to(dev), cc, bt.to(dev),
                                          pos.to(dev), lora=eng.lora, rt=rt)
        torch.cuda.synchronize()
        outs.append((logits, cc))
    (lk, ck), (lp, cp) = outs
    e_log = (lk - lp).abs().max().item()
    e_kv = max((a[n] - b[n]).abs().max().item() for a, b in zip(ck, cp) for n in "kv")
    good = (tuple(lk.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(lk).all())
            and torch.allclose(lk, lp, atol=1e-3, rtol=1e-3) and e_kv < 1e-4)
    print(f"[serve] paged_decode_step logits kernel vs plain path: shape "
          f"{tuple(lk.shape)} max_abs_err={e_log:.3g} (atol=rtol=1e-3), pools "
          f"max_abs_err={e_kv:.3g} (tol 1e-4) {'ok' if good else 'FAIL'}")
    if not good:
        fail("decode step through the kernels disagrees with the plain path")

    tune_line("phase 5")

    # -- 6. training on full-width GPT-2-S -------------------------------------
    serve_launches = launches
    from repro_torch.launch.train import build_argparser, run
    from repro_torch.tree import tree_leaves
    targs = build_argparser().parse_args(
        ["--arch", "gpt2-s", "--clients", "3", "--batch", "4", "--seq", "64",
         "--local-steps", "6", "--steps", "12", "--split", "6", "--lr", "4e-4",
         "--device", "cuda", "--seed", "0"])
    lora_t = TM.init_lora_stack(cfg, torch.Generator().manual_seed(1), None,
                                torch.float32, "cuda")
    g_b = torch.Generator().manual_seed(2)
    for layer in lora_t:         # B != 0: both adapter factors get gradients
        for ad in layer["mixer"].values():
            ad["b"].copy_(torch.randn(ad["b"].shape, generator=g_b) * 0.02)
    backend.reset_launch_counts()        # just before the main path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist, sfl = run(targs, lora=lora_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = dict(backend.LAUNCH_COUNTS)
    Kc, L, ell = targs.clients, cfg.num_layers, sfl.ell_c
    steps = len(hist.losses)
    per_step = {"lora_matmul": 2 * (Kc * ell + L - ell),
                "lora_rank_reduce": 4 * (Kc * ell + L - ell),
                "lora_matmul_dx": 2 * (Kc * (ell - 1) + L - ell)}
    print(f"[train] SFL on full-width GPT-2-S: K={Kc} clients x b={targs.batch} x "
          f"S={targs.seq}, I={targs.local_steps} local steps, {len(hist.round_losses)} "
          f"rounds, split ell_c={ell} of L={L} (the allocator's choice is printed "
          f"above), AdamW lr={targs.lr}, f32, LoRA r={cfg.lora_rank} on "
          f"{cfg.lora_targets} with B != 0; wall {wall:.2f}s incl. data and allocator")
    print(f"[train] per round: " + ", ".join(
        f"{t:.3f}s ({t / targs.local_steps * 1e3:.1f} ms/local step)"
        for t in hist.round_seconds) + "  (host clock, round ends in a host read "
        "of its losses; FedAvg included)")
    print(f"[train] losses: {' '.join(f'{x:.4f}' for x in hist.losses)} "
          f"({hist.losses[0]:.4f} -> {hist.losses[-1]:.4f})")
    print(f"[train] launches during the run: {train_launches}; per local step "
          f"expected {per_step} (lora_matmul 2(K*ell_c + L - ell_c), rank reduce "
          f"twice that, dX 2(K*(ell_c - 1) + L - ell_c): layer 0's input needs no "
          f"gradient)")
    if not all(math.isfinite(x) for x in hist.losses) or steps != 12:
        fail(f"training losses not finite or wrong count: {hist.losses}")
    if hist.rolled_back_rounds:
        fail(f"rounds rolled back: {hist.rolled_back_rounds}")
    for k, v in per_step.items():
        if train_launches.get(k, 0) != v * steps or v == 0:
            fail(f"{k}: {train_launches.get(k, 0)} launches in {steps} local steps, "
                 f"expected {v * steps}")

    # one local step from the trained state, kernels vs plain path
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (Kc, targs.batch, targs.seq)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    outs = []
    for rt in (TM.default_train_runtime(), TM.Runtime()):
        sfl.rt = rt
        st, m = sfl.local_step(state, batch)
        torch.cuda.synchronize()
        outs.append((float(m["loss"]), st))
    sfl.rt = TM.default_train_runtime()
    (lk, sk), (lp, sp) = outs
    pairs = [(a_, b_) for side in ("lora_client", "lora_server")
             for a_, b_ in zip(tree_leaves(getattr(sk, side)),
                               tree_leaves(getattr(sp, side)))]
    e_ad = max((a_ - b_).abs().max().item() for a_, b_ in pairs)
    ad_tol = targs.lr * 1e-2
    good = abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)) and e_ad <= ad_tol
    print(f"[train] local_step kernels vs plain path (Runtime()): loss {lk:.6f} vs "
          f"{lp:.6f} (tol 1e-4 rel), adapters max_abs_err={e_ad:.3g} "
          f"(tol lr*1e-2 = {ad_tol:.1g}) {'ok' if good else 'FAIL'}")
    if not good:
        fail("a local step through the kernels disagrees with the plain path")

    tune_line("phase 6")

    # -- 7. the flash_attention op's own path --------------------------------
    # No model path calls kernels.flash_attention.flash_attention (training
    # attention is plain PyTorch, as it is jnp in JAX), so its path is the
    # op's entry point: once per layer at the training step's attention
    # shape (K*b sequences of S tokens, 12 heads of 64).
    q, k, v = (randn(Kc * targs.batch, targs.seq, cfg.num_heads, cfg.head_dim).to(dev)
               for _ in range(3))
    backend.reset_launch_counts()        # just before the op's path
    outs = [flash_attention(q, k, v) for _ in range(L)]
    torch.cuda.synchronize()
    attn_launches = dict(backend.LAUNCH_COUNTS)
    good = (attn_launches == {"flash_attention": L}
            and all(tuple(o.shape) == tuple(q.shape) and bool(torch.isfinite(o).all())
                    for o in outs))
    print(f"[attn] flash_attention op, {L} calls at (B, S, H, D) = {tuple(q.shape)}: "
          f"launches {attn_launches} {'ok' if good else 'FAIL'}")
    if not good:
        fail(f"flash_attention op path launched {attn_launches}, expected "
             f"{{'flash_attention': {L}}}, or gave a bad output")

    tune_line("phase 7")

    # -- 8. heterogeneous, precision-aware fleets over an int8 base -------------
    import dataclasses
    from repro_torch.configs import DEFAULT_SYSTEM
    from repro_torch.core import Problem, SflLLM, sample_clients
    from repro_torch.core.resource import HeteroAllocation, bcd_minimize_delay_per_client
    from repro_torch.data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
    from repro_torch.launch.engine import (SflRound, Trainer, allocation_round_latency,
                                           modeled_total_seconds)
    from repro_torch.optim import adamw
    from repro_torch.precision import PrecisionConfig, quantize_params_int8

    Kf, bf, Sf, If, lrf, rounds = 3, 4, 64, 6, 4e-4, 2
    # the edge problem of benchmarks/bench_precision.py at this run's shapes
    edge = dataclasses.replace(DEFAULT_SYSTEM, num_clients=Kf, total_bandwidth_hz=50e6,
                               f_server_hz=1.0e9, f_client_hz_range=(0.3e9, 3.0e9))
    prob = Problem(cfg=cfg, sys_cfg=edge, envs=tuple(sample_clients(edge, 0)), seq_len=Sf,
                   batch=bf, local_steps=If, bits_candidates=(4, 8, 16))
    t0 = time.perf_counter()
    alloc_a, _ = bcd_minimize_delay_per_client(prob)
    t_alloc = time.perf_counter() - t0
    alloc_b = HeteroAllocation(
        assign_main=alloc_a.assign_main.copy(), assign_fed=alloc_a.assign_fed.copy(),
        power_main=alloc_a.power_main.copy(), power_fed=alloc_a.power_fed.copy(),
        ell_c=6, rank=8, act_bits=16, ell_k=np.array([2, 4, 6]),
        rank_k=np.array([2, 4, 8]), bits_k=np.array([4, 8, 16]))
    train_ex, _, _ = e2e_splits(4000, 400, 400, seed=0)
    tok_e2e = WordTokenizer.from_corpus([e.text for e in train_ex])
    if tok_e2e.vocab_size > cfg.vocab_size:
        fail(f"E2E vocabulary {tok_e2e.vocab_size} exceeds GPT-2-S's {cfg.vocab_size}")
    parts = [np.array(train_ex, dtype=object)[idx]
             for idx in iid_partition(len(train_ex), Kf, 0)]
    counts = [len(p_) for p_ in parts]
    base8 = quantize_params_int8(TM.init_params(cfg, torch.Generator().manual_seed(0),
                                                torch.float32, "cuda"))
    wq0 = base8["layers"][0]["mixer"]["wq"]
    print(f"[fleet] int8 base: {wq0['w'].dtype} w + {wq0['w_scale'].dtype} w_scale per "
          f"projection; allocator (bcd_minimize_delay_per_client, bits 4/8/16, "
          f"{edge.total_bandwidth_hz / 1e6:.0f} MHz, K={Kf}, S={Sf}, b={bf}, I={If}) "
          f"{t_alloc:.1f}s on the host")
    nt = len(cfg.lora_targets)
    ad_tol = lrf * 1e-2

    def fleet(label, alloc, prec, rt=None):
        """Trains one fleet for `rounds` rounds; through the kernels and
        held to their exact launch counts, or through `rt` when given."""
        kern = rt is None
        rt = (TM.default_train_runtime() if kern else rt).replace(precision=prec)
        sfl = SflLLM.from_allocation(prob, alloc, base8, adamw(lrf), rt=rt, device="cuda")
        lora0 = sfl.init_lora(torch.Generator().manual_seed(1))
        g_b = torch.Generator().manual_seed(2)
        for layer in lora0:      # B != 0: both adapter factors get gradients
            for ad in layer["mixer"].values():
                ad["b"].copy_(torch.randn(ad["b"].shape, generator=g_b) * 0.02)
        state = sfl.init_state(lora0)
        report = allocation_round_latency(prob, alloc)
        trainer = Trainer(SflRound(sfl, counts), local_steps=If, round_latency=report)
        data = sfl_batches(tok_e2e, parts, bf, Sf, 0)
        backend.reset_launch_counts()    # just before the fleet's main path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = trainer.fit(state, data, global_rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(backend.LAUNCH_COUNTS)
        ells, L = sfl.ell_k, cfg.num_layers
        fwd = nt * (sum(ells) + L - min(ells))
        per_step = {"lora_matmul_q8": fwd, "lora_rank_reduce": 2 * fwd,
                    "lora_matmul_q8_dx": nt * (sum(e - 1 for e in ells) + L - min(ells))}
        steps = len(hist.losses)
        print(f"[fleet {label}] ell_k={list(sfl.ell_k)} r_k={list(sfl.rank_k)} "
              f"act_bits={list(sfl.act_bits_k or [16] * Kf)} grad_bits="
              f"{prec.grad_bits} stochastic_rounding={prec.stochastic_rounding} "
              f"error_feedback={prec.error_feedback}; modeled wireless "
              f"{hist.modeled_seconds:.3f}s for {rounds} rounds "
              f"({hist.modeled_seconds / rounds:.3f}s/round), allocation total "
              f"{modeled_total_seconds(prob, alloc):.3f}s (eq. 17)")
        print(f"[fleet {label}] per round: " + ", ".join(
            f"{t_:.3f}s ({t_ / If * 1e3:.1f} ms/local step)" for t_ in hist.round_seconds)
            + f"; wall {wall:.2f}s (host clock, rounds end in a host read of their losses)")
        print(f"[fleet {label}] losses: {' '.join(f'{x:.4f}' for x in hist.losses)}")
        if steps != rounds * If or not all(math.isfinite(x) for x in hist.losses):
            fail(f"fleet {label}: losses not finite or wrong count: {hist.losses}")
        if hist.rolled_back_rounds:
            fail(f"fleet {label}: rounds rolled back: {hist.rolled_back_rounds}")
        if not kern:
            return sfl, state, got, hist.losses
        print(f"[fleet {label}] launches: {got}; per local step expected {per_step} "
              f"(q8 {nt}(sum ell_k + L - min ell_k), q8 dX {nt}(sum(ell_k - 1) + L - "
              f"min ell_k), rank reduce twice the q8 forward)")
        want = {k: v * steps for k, v in per_step.items()}
        if got != want:
            fail(f"fleet {label}: launched {got}, expected exactly {want}")
        return sfl, state, got, hist.losses

    prec_b = PrecisionConfig(grad_bits=8, stochastic_rounding=True, error_feedback=True)
    _, _, fleet_a, _ = fleet("a", alloc_a, PrecisionConfig())
    sfl_b, state_b, fleet_b, loss_b = fleet("b", alloc_b, prec_b)
    if state_b.err_act is None or state_b.err_grad is None:
        fail("fleet b carries no error-feedback state")
    prec_det = prec_b.replace(stochastic_rounding=False)

    # fleet b's trajectory, a witness and no check: its 4-bit quantizers
    # carry f32 rounding from step to step, so the 12 losses are compared
    # with the plain path's (dequantize + matmul) own, with stochastic
    # rounding on and off
    traj = {"on": (loss_b, fleet("b, plain path", alloc_b, prec_b, TM.Runtime())[3])}
    traj["off"] = tuple(fleet(f"b, stochastic rounding off, {w}", alloc_b, prec_det, rt)[3]
                        for w, rt in (("kernels", None), ("plain path", TM.Runtime())))
    for sr, (lk_, lp_) in traj.items():
        print(f"[fleet b] 12-step losses, kernels vs plain path, stochastic rounding {sr}: "
              f"end {lk_[-1]:.4f} vs {lp_[-1]:.4f}, max |diff| over the steps "
              f"{max(abs(x - y) for x, y in zip(lk_, lp_)):.3g} (first step "
              f"{abs(lk_[0] - lp_[0]):.3g})")

    # fleet b: one local step from the trained state through the kernels and
    # through the plain path (dequantize + matmul), stochastic rounding off
    rng = np.random.default_rng(6)
    tok = rng.integers(0, tok_e2e.vocab_size, (Kf, bf, Sf)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    outs = []
    for rt in (TM.default_train_runtime(), TM.Runtime()):
        s_ = SflLLM.from_allocation(prob, alloc_b, base8, adamw(lrf),
                                    rt=rt.replace(precision=prec_det), device="cuda")
        st, m = s_.local_step(state_b, batch)
        torch.cuda.synchronize()
        outs.append((float(m["loss"]), st))
    (lk, sk), (lp, sp) = outs
    pairs = [(a_, b_) for side in ("lora_client", "lora_server")
             for a_, b_ in zip(tree_leaves(getattr(sk, side)), tree_leaves(getattr(sp, side)))]
    e_ad = max((a_ - b_).abs().max().item() for a_, b_ in pairs)
    moved = int(((sk.err_act - sp.err_act).abs() > 1e-3).sum())
    good = abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)) and e_ad <= ad_tol
    print(f"[fleet b] local_step kernels vs plain path (stochastic rounding off): loss "
          f"{lk:.6f} vs {lp:.6f} (tol 1e-4 rel), adapters max_abs_err={e_ad:.3g} (tol "
          f"lr*1e-2 = {ad_tol:.1g}); uploaded entries on another quantization level: "
          f"{moved} of {sk.err_act[:2].numel()} {'ok' if good else 'FAIL'}")
    if not good:
        fail("fleet b: a local step through the kernels disagrees with the plain path")

    tune_line("phase 8")

    # -- 9. the slab engine on full-width GPT-2-S ------------------------------
    L = cfg.num_layers
    slab = ServingEngine(cfg, params, lora=lora, max_slots=8, max_len=512, paged=False,
                         device="cuda")
    if slab.paged:
        fail("ServingEngine(paged=False) built a paged engine")
    slab.submit(Request(uid=1000, prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
    slab.run()                           # first-call set-up, not measured
    for k in slab.stats:
        slab.stats[k] = 0
    sreqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=32) for r_ in reqs]
    for r_ in sreqs:
        slab.submit(r_)
    backend.reset_launch_counts()        # just before the main path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slab.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slab_launches = dict(backend.LAUNCH_COUNTS)
    st = slab.stats
    n_tok = sum(len(r_.output) for r_ in sreqs)
    print(f"[slab] ServingEngine(paged=False), 8 slots x 512 positions, f32: the same "
          f"{len(sreqs)} requests: {n_tok} tokens in {wall:.3f}s = {n_tok / wall:.1f} tok/s; "
          f"{st['decode_steps']} decode steps, mean "
          f"{st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f} ms/step; "
          f"{st['prefills']} prefills ({slab.prefill_compiles()} bucket lengths), "
          f"{st['prefill_s'] * 1e3:.1f} ms total "
          f"({st['prefill_s'] / max(st['prefills'], 1) * 1e3:.2f} ms/prefill)")
    print(f"[slab] launches during the run: {slab_launches}")
    if not all(r_.done and len(r_.output) == 32 for r_ in sreqs):
        fail("slab engine: not every request finished with 32 tokens")
    same = sum(a.output == b.output for a, b in zip(reqs, sreqs))
    print(f"[slab] token ids equal to phase 5's paged engine: {same} of {len(reqs)} "
          f"requests {'ok' if same == len(reqs) else 'FAIL'}")
    if same != len(reqs):
        fail("the slab engine's greedy token ids differ from the paged engine's")
    want = {"lora_matmul": 2 * L * (st["decode_steps"] + st["prefills"]),
            "flash_decode": L * st["decode_steps"]}
    if slab_launches != want:
        fail(f"slab engine launched {slab_launches}, expected exactly {want}")
    print(f"[slab] launch counts match the path: {want} (24 lora_matmul per decode "
          f"step and per prefill, 12 flash_decode per step, no paged_decode)")

    # one slab decode step, kernel path vs plain path, on the same state
    B = 8
    caches = TM.init_cache(cfg, B, 512, torch.float32, "cuda")
    g_kv = torch.Generator(device=dev).manual_seed(3)
    pos = torch.tensor(lengths, dtype=torch.int32)
    for c in caches:
        c["k"].normal_(generator=g_kv)
        c["v"].normal_(generator=g_kv)
        c["pos"].copy_(torch.where(torch.arange(512)[None] < pos[:, None],
                                   torch.arange(512, dtype=torch.int32)[None], -1))
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    outs = []
    for rt in (TM.default_serve_runtime(), TM.Runtime()):
        cc = [{k: v.clone() for k, v in c.items()} for c in caches]
        logits, cc = TM.decode_step(cfg, slab.params, tok.to(dev), cc, pos.to(dev),
                                    lora=slab.lora, rt=rt)
        torch.cuda.synchronize()
        outs.append((logits, cc))
    (lk, ck), (lp, cp) = outs
    e_log = (lk - lp).abs().max().item()
    e_kv = max((a[n].float() - b[n].float()).abs().max().item()
               for a, b in zip(ck, cp) for n in ("k", "v", "pos"))
    good = (tuple(lk.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(lk).all())
            and torch.allclose(lk, lp, atol=1e-3, rtol=1e-3) and e_kv < 1e-4)
    print(f"[slab] decode_step logits kernel vs plain path (flash_decode vs "
          f"decode_masked_attention): shape {tuple(lk.shape)} max_abs_err={e_log:.3g} "
          f"(atol=rtol=1e-3), caches max_abs_err={e_kv:.3g} (tol 1e-4) "
          f"{'ok' if good else 'FAIL'}")
    if not good:
        fail("slab decode step through the kernels disagrees with the plain path")

    # the naive loop (repro's measured baseline): per-slot decode at batch 1
    naive = ServingEngine(cfg, params, lora=lora, max_slots=8, max_len=512, fused=False,
                          device="cuda")
    nreqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=8)
             for r_ in reqs[:8]]
    for r_ in nreqs:
        naive.submit(r_)
    backend.reset_launch_counts()        # just before the main path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    naive.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    naive_launches = dict(backend.LAUNCH_COUNTS)
    decoded = sum(len(r_.output) - 1 for r_ in nreqs)       # one B=1 decode each
    want = {"lora_matmul": 2 * L * (decoded + len(nreqs)), "flash_decode": L * decoded}
    same = all(a.output == b.output[:8] for a, b in zip(nreqs, reqs))
    st = naive.stats
    print(f"[naive] ServingEngine(fused=False): {len(nreqs)} requests x 8 tokens in "
          f"{wall:.3f}s = {sum(len(r_.output) for r_ in nreqs) / wall:.1f} tok/s, "
          f"{st['decode_steps']} steps ({st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f}"
          f" ms/step, {decoded} batch-1 decodes); launches {naive_launches}, expected "
          f"{want}; token ids equal to phase 5's first 8: {same} "
          f"{'ok' if same and naive_launches == want else 'FAIL'}")
    if naive_launches != want or not same:
        fail("the naive loop's launches or token ids are off")
    print(f"[naive] token ids digest of the {len(nreqs)} requests: {ids_digest(nreqs)}")

    tune_line("phase 9")

    # -- 10. the int8-KV ops' own path ----------------------------------------
    # No engine of repro builds an int8 KV; the q8 kernels are reached
    # through the ops' own entry points.  Their inputs: the real GPT-2-S KV
    # of a slab engine and of a paged engine mid-run, slots live.
    def mid_run(engine):
        for r_ in [Request(uid=2000 + r_.uid, prompt=list(r_.prompt), max_new_tokens=32)
                   for r_ in reqs[:8]]:
            engine.submit(r_)
        for _ in range(12):
            engine.step()
        live = torch.tensor([r_ is not None for r_ in engine.slots], device=dev)
        return torch.where(live, engine._positions, torch.zeros_like(engine._positions))

    slab_lens = mid_run(slab)
    paged_lens = mid_run(eng)
    H, D = cfg.num_heads, cfg.head_dim
    qs = [randn(8, 1, H, D).to(dev) for _ in range(L)]
    q8_in = []
    for i in range(L):
        c, p_ = slab.caches[i], eng.caches[i]
        q8_in.append((quantize_kv_int8(c["k"], head_axis=2) + quantize_kv_int8(c["v"], head_axis=2),
                      quantize_kv_int8(p_["k"], head_axis=0)
                      + quantize_kv_int8(p_["v"], head_axis=0)))
    torch.cuda.synchronize()
    backend.reset_launch_counts()        # just before the ops' path
    outs = []
    for i in range(L):
        (kq, ks, vq, vs), (kpq, kps, vpq, vps) = q8_in[i]
        outs.append((flash_decode(qs[i], kq, vq, slab_lens, k_scale=ks, v_scale=vs),
                     paged_decode(qs[i], kpq, vpq, paged_lens, eng._bt, k_scale=kps,
                                  v_scale=vps)))
    torch.cuda.synchronize()
    q8_launches = dict(backend.LAUNCH_COUNTS)
    e_plain = {"flash_decode_q8": 0.0, "paged_decode_q8": 0.0}
    e_f32 = {"flash_decode_q8": 0.0, "paged_decode_q8": 0.0}
    for i, (o_s, o_p) in enumerate(outs):
        (kq, ks, vq, vs), (kpq, kps, vpq, vps) = q8_in[i]
        qt = qs[i][:, 0].reshape(8, cfg.num_kv_heads, -1, D)
        c, p_ = slab.caches[i], eng.caches[i]
        r_s = flash_decode_q8_ref(qt, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs,
                                  slab_lens).reshape(o_s.shape)
        r_p = paged_decode_q8_ref(qt, kpq, vpq, kps, vps, paged_lens,
                                  eng._bt).reshape(o_p.shape)
        f_s = flash_decode(qs[i], c["k"], c["v"], slab_lens)
        f_p = paged_decode(qs[i], p_["k"], p_["v"], paged_lens, eng._bt)
        for op, o_, r_, f_ in (("flash_decode_q8", o_s, r_s, f_s),
                               ("paged_decode_q8", o_p, r_p, f_p)):
            if not (bool(torch.isfinite(o_).all()) and tuple(o_.shape) == (8, 1, H, D)):
                fail(f"{op}: non-finite or misshapen output on the ops' path")
            e_plain[op] = max(e_plain[op], (o_ - r_).abs().max().item())
            e_f32[op] = max(e_f32[op], (o_ - f_).abs().max().item())
    want = {"flash_decode_q8": L, "paged_decode_q8": L}
    good = q8_launches == want and all(e <= 1e-5 for e in e_plain.values())
    print(f"[int8 kv] slab lengths {slab_lens.tolist()}, paged lengths "
          f"{paged_lens.tolist()} (real GPT-2-S KV mid-run, quantized per KV head); "
          f"launches {q8_launches} (expected {want}); max_abs_err against the plain q8 "
          f"version {e_plain} (atol 1e-5); against the f32 kernel on the unquantized "
          f"KV {e_f32} {'ok' if good else 'FAIL'}")
    if not good:
        fail("the int8-KV ops' path launched the wrong counts or disagrees with its "
             "plain version")

    tune_line("phase 10")

    # -- 11. multi-tenant serving on full-width GPT-2-S -------------------------
    from repro_torch.launch.serve import tenant_adapter
    NT, POOL = 12, 8
    ads = [tenant_adapter(cfg, 100 + t, cfg.lora_rank) for t in range(NT)]
    reg = AdapterRegistry(cfg, pool_size=POOL, device="cuda")
    for t, ad in enumerate(ads):
        reg.publish(t, ad)
    mt = ServingEngine(cfg, params, adapters=reg, max_slots=8, max_len=512, page_size=16,
                       device="cuda")
    mreqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=32, tenant=r_.uid % NT)
             for r_ in reqs]
    for r_ in mreqs:
        mt.submit(r_)
    backend.reset_launch_counts()        # just before the main path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mt_launches = dict(backend.LAUNCH_COUNTS)
    st = mt.stats
    n_tok = sum(len(r_.output) for r_ in mreqs)
    print(f"[tenants] ServingEngine(adapters=AdapterRegistry(pool_size={POOL})), {NT} tenants "
          f"(rank {cfg.lora_rank} on {cfg.lora_targets}, B != 0), 8 slots x 512 positions, "
          f"f32, phase 5's {len(mreqs)} requests with tenant = uid % {NT}: {n_tok} tokens in "
          f"{wall:.3f}s = {n_tok / wall:.1f} tok/s; {st['decode_steps']} decode steps, mean "
          f"{st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f} ms/step; "
          f"{st['prefill_chunks']} prefill chunks, {st['prefill_s'] * 1e3:.1f} ms total; "
          f"{st['adapter_swaps']} adapter swaps, {reg.stats['evictions']} evictions; "
          f"tokens per tenant {dict(sorted(st['tenant_tokens'].items()))}")
    print(f"[tenants] launches during the run: {mt_launches}")
    if not all(r_.done and len(r_.output) == 32 for r_ in mreqs):
        fail("multi-tenant engine: not every request finished with 32 tokens")
    if not mt.check_consistency(resync=False) or mt.pages_in_use() != 0:
        fail("multi-tenant engine: page accounting inconsistent after drain")
    want = {"lora_matmul_gather": 2 * L * st["decode_steps"],
            "paged_decode": L * st["decode_steps"],
            "lora_matmul": 2 * L * st["prefill_chunks"]}
    if mt_launches != want or st["decode_steps"] == 0:
        fail(f"multi-tenant engine launched {mt_launches}, expected exactly {want}")
    if reg.stats["evictions"] < 1:
        fail("multi-tenant engine: 12 tenants over 8 pool slots evicted nothing")
    print(f"[tenants] launch counts match the path: {want} (24 lora_matmul_gather and 12 "
          f"paged_decode per decode step, 24 lora_matmul per prefill chunk, no lora_matmul "
          f"in decode, no flash_decode)")

    # each request against a single-adapter paged engine with its tenant's adapter
    same = 0
    for t in range(NT):
        mine = [r_ for r_ in mreqs if r_.tenant == t]
        one = ServingEngine(cfg, params, lora=ads[t], max_slots=8, max_len=512, page_size=16,
                            device="cuda")
        sreqs_t = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=32)
                   for r_ in mine]
        for r_ in sreqs_t:
            one.submit(r_)
        one.run()
        same += sum(a_.output == b_.output for a_, b_ in zip(mine, sreqs_t))
        del one
    print(f"[tenants] token ids equal to single-adapter engines serving each request with "
          f"its tenant's adapter: {same} of {len(mreqs)} {'ok' if same == len(mreqs) else 'FAIL'}")
    if same != len(mreqs):
        fail("multi-tenant token ids differ from the per-tenant single-adapter engines'")
    print(f"[tenants] token ids digest of the {len(mreqs)} requests: {ids_digest(mreqs)}")

    # one prompt under every tenant, with a hot swap between two steps
    shared = [Request(uid=3000 + t, prompt=list(reqs[0].prompt), max_new_tokens=8, tenant=t)
              for t in range(NT)]
    for r_ in shared:
        mt.submit(r_)
    for _ in range(2):
        mt.step()
    hot = next(t for t in range(NT) if reg.resident(t))
    ptrs = [p_.data_ptr() for p_ in tree_leaves(reg.pool)]
    v_new = tenant_adapter(cfg, 999, cfg.lora_rank)
    version = reg.publish(hot, v_new)
    torch.cuda.synchronize()
    kept = [p_.data_ptr() for p_ in tree_leaves(reg.pool)] == ptrs
    loaded = all(torch.equal(p_[reg.slot_of(hot)].cpu(), h_)
                 for p_, h_ in zip(tree_leaves(reg.pool), tree_leaves(v_new)))
    mt.run()
    answers = {tuple(r_.output) for r_ in shared}
    good = (kept and loaded and version == 2 and reg.stats["hot_swaps"] == 1
            and all(r_.done for r_ in shared) and len(answers) > 1)
    print(f"[tenants] hot swap of resident tenant {hot} between two steps: version {version}, "
          f"pool storage unchanged {kept}, slot holds the new weights {loaded}; one prompt "
          f"under {NT} tenants gave {len(answers)} distinct answers {'ok' if good else 'FAIL'}")
    if not good:
        fail("hot swap moved the pool, or the tenants' answers did not differ")

    # one mixed-tenant decode step, kernel path vs plain path, on the same state
    B = 8
    caches = TM.init_paged_cache(cfg, 8 * 32 + 1, 16, torch.float32, "cuda")
    for c in caches:
        c["k"].normal_(generator=torch.Generator(device=dev).manual_seed(3))
        c["v"].normal_(generator=torch.Generator(device=dev).manual_seed(4))
    pos = torch.tensor(lengths, dtype=torch.int32)
    bt = torch.zeros(B, 32, dtype=torch.int32)
    pages = torch.randperm(8 * 32, generator=gen) + 1
    for b_, n in enumerate(lengths):
        bt[b_, :n // 16 + 1] = pages[b_ * 32:b_ * 32 + n // 16 + 1].int()
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    aidx = torch.tensor([3, 0, 7, 3, 5, 1, 6, 2], dtype=torch.int32, device=dev)
    outs = []
    for rt in (TM.default_serve_runtime(), TM.Runtime()):
        cc = [{k: v.clone() for k, v in c.items()} for c in caches]
        backend.reset_launch_counts()
        logits, cc = TM.paged_decode_step(cfg, mt.params, tok.to(dev), cc, bt.to(dev),
                                          pos.to(dev), lora=reg.pool, rt=rt, adapter_idx=aidx)
        torch.cuda.synchronize()
        outs.append((logits, cc, dict(backend.LAUNCH_COUNTS)))
    (lk, ck, nk), (lp, cp, npl) = outs
    e_log = (lk - lp).abs().max().item()
    e_kv = max((a[n] - b[n]).abs().max().item() for a, b in zip(ck, cp) for n in "kv")
    good = (tuple(lk.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(lk).all())
            and torch.allclose(lk, lp, atol=1e-3, rtol=1e-3) and e_kv < 1e-4
            and nk == {"lora_matmul_gather": 2 * L, "paged_decode": L} and not npl)
    print(f"[tenants] paged_decode_step(adapter_idx={aidx.tolist()}) logits kernel vs plain "
          f"path: shape {tuple(lk.shape)} max_abs_err={e_log:.3g} (atol=rtol=1e-3), pools "
          f"max_abs_err={e_kv:.3g} (tol 1e-4); launches {nk} vs plain {npl} "
          f"{'ok' if good else 'FAIL'}")
    if not good:
        fail("a mixed-tenant decode step through the kernels disagrees with the plain path")

    tune_line("phase 11")
    mamba_launches = phase_mamba(torch, np, dev, reqs)
    tune_line("phase 12")
    dyn_train, dyn_serve, dyn_err = phase_dynamic(torch, np, dev, reqs)
    for k, v in dyn_err.items():
        err[k] = max(err[k], v)
    tune_line("phase 13")
    fault_serve, fault_train = phase_faults(torch, np, dev, reqs, eng.params, eng.lora)
    tune_line("phase 14")
    # phase 15 builds models of 11-35 GB: GPT-2-S's engines go first
    del eng, slab, naive, mt, params, lora, caches, cc, outs
    arch_launches, arch_err = phase_archs(torch, np, dev, reqs, flush)
    for k, v in arch_err.items():
        err[k] = max(err[k], v)
    tune_line("phase 15")
    ssm_train, ssm_err, ssm_rows = phase_mamba_train(torch, np, dev, flush)
    err.update(ssm_err)
    rows.update(ssm_rows)
    tune_line("phase 16")
    fe_launches, fe_err = phase_frontends(torch, np, dev, flush)
    for k, v in fe_err.items():
        err[k] = max(err[k], v)
    tune_line("phase 17")
    # phases 18-21 run most of their work in processes of their own, each
    # tuning apart: the lines count this process's share only
    mesh_launches = phase_mesh(torch, np, dev)
    tune_line("phase 18 (this process)")
    tp_launches, tp_err = phase_tp(torch, np, dev, flush)
    for k, v in tp_err.items():
        err[k] = max(err[k], v)
    tune_line("phase 19 (this process)")
    serve_tp_launches = phase_serve_tp(torch, np, dev, flush)
    tune_line("phase 20 (this process)")
    example_launches = phase_examples(dev)
    tune_line("phase 21 (this process)")
    phase_tuner(torch, dev, flush)
    runs = (serve_launches, train_launches, attn_launches, fleet_a, fleet_b,
            slab_launches, naive_launches, q8_launches,
            mt_launches, mamba_launches, dyn_train, dyn_serve, fault_serve, fault_train,
            arch_launches, ssm_train, fe_launches, mesh_launches, tp_launches,
            serve_tp_launches, example_launches)
    launches = {k: sum(r_.get(k, 0) for r_ in runs) for k in set().union(*runs)}

    # -- result ---------------------------------------------------------------
    kernels = [
        dict(name="lora_matmul", route="cuda",
             source="src/repro_torch/kernels/csrc/lora_matmul.cu",
             replaces="src/repro/kernels/lora_matmul/kernel.py:57",
             launches=launches["lora_matmul"], max_abs_err=err["lora_matmul"],
             **rows[("lora_matmul", 8)]),
        dict(name="paged_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode.cu",
             replaces="src/repro/kernels/flash_attention/paged_decode.py:184",
             launches=launches["paged_decode"], max_abs_err=err["paged_decode"],
             **rows[("paged_decode", 8)]),
        dict(name="lora_matmul_dx", route="cuda",
             source="src/repro_torch/kernels/csrc/lora_matmul_bwd.cu",
             replaces="src/repro/kernels/lora_matmul/kernel.py:317",
             launches=launches["lora_matmul_dx"], max_abs_err=err["lora_matmul_dx"],
             **rows[("lora_matmul_dx", 768)]),
        dict(name="lora_rank_reduce", route="cuda",
             source="src/repro_torch/kernels/csrc/lora_matmul_bwd.cu",
             replaces="src/repro/kernels/lora_matmul/kernel.py:371",
             launches=launches["lora_rank_reduce"], max_abs_err=err["lora_rank_reduce"],
             **rows[("lora_rank_reduce", 768)]),
        # launched on the op's own path (phase 7) only: no model path calls it
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:72",
             launches=launches["flash_attention"],
             max_abs_err=err["flash_attention"], **rows[("flash_attention", 12)]),
        # the int8-base pair, launched by the fleets of phase 8; times at the
        # pooled server's M = 768
        dict(name="lora_matmul_q8", route="cuda",
             source="src/repro_torch/kernels/csrc/lora_matmul_q8.cu",
             replaces="src/repro/kernels/lora_matmul/kernel.py:115",
             launches=launches["lora_matmul_q8"], max_abs_err=err["lora_matmul_q8"],
             **rows[("lora_matmul_q8", 768)]),
        dict(name="lora_matmul_q8_dx", route="cuda",
             source="src/repro_torch/kernels/csrc/lora_matmul_q8.cu",
             replaces="src/repro/kernels/lora_matmul/kernel.py:174",
             launches=launches["lora_matmul_q8_dx"], max_abs_err=err["lora_matmul_q8_dx"],
             **rows[("lora_matmul_q8_dx", 768)]),
        # the slab engine's decode (phase 9) at its shape: 8 slots x 512
        # positions, lengths 8-255
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_attention/decode.py:177",
             launches=launches["flash_decode"], max_abs_err=err["flash_decode"],
             **rows[("flash_decode", 8)]),
        # the partial softmax over a piece of a cache cut by its length,
        # launched by phase 20 (b)'s decode; timed at that piece's shape
        dict(name="flash_decode_partial", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_partial.cu",
             replaces="src/repro/kernels/flash_attention/decode.py:177 (partitioned by "
                      "GSPMD over a cache sharded by length)",
             launches=launches["flash_decode_partial"],
             max_abs_err=err["flash_decode_partial"],
             **rows[("flash_decode_partial", 4)]),
        # the int8-KV pair, launched on the ops' own path (phase 10) only
        dict(name="flash_decode_q8", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_attention/decode.py:136",
             launches=launches["flash_decode_q8"], max_abs_err=err["flash_decode_q8"],
             **rows[("flash_decode_q8", 8)]),
        dict(name="paged_decode_q8", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode.cu",
             replaces="src/repro/kernels/flash_attention/paged_decode.py:134",
             launches=launches["paged_decode_q8"], max_abs_err=err["paged_decode_q8"],
             **rows[("paged_decode_q8", 8)]),
        # the multi-tenant decode (phase 11) at its shape: 8 slots, 8 adapters
        dict(name="lora_matmul_gather", route="cuda",
             source="src/repro_torch/kernels/csrc/lora_matmul.cu",
             replaces="src/repro/kernels/lora_matmul/kernel.py:236",
             launches=launches["lora_matmul_gather"], max_abs_err=err["lora_matmul_gather"],
             **rows[("lora_matmul_gather", 8)]),
        # Mamba2's prefill (phase 12), timed at the full-width prefill of a
        # 200-token prompt (one chunk)
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:63",
             launches=launches["ssd_scan"], max_abs_err=err["ssd_scan"],
             **rows[("ssd_scan", 200)]),
        # its backward (phase 16), timed at a client's training shape: 2 x
        # 320 tokens padded to 512, 80 heads of 64, state 128
        dict(name="ssd_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
             replaces="src/repro/models/ssm.py:87 ssd_chunked (jax.grad; no Pallas kernel)",
             launches=launches["ssd_scan_bwd"], max_abs_err=err["ssd_scan_bwd"],
             **rows[("ssd_scan_bwd", 512)]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def phase_mamba(torch, np, dev, reqs):
    """Phase 12: full-width Mamba2-2.7B through the slab engine.  Returns
    the launch counts of the engine's run."""
    from repro_torch import models as TM
    from repro_torch.configs import get_arch
    from repro_torch.kernels import backend
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_arch("mamba2-2.7b")
    L = cfg.num_layers
    # 2.8 B parameters drawn on the card (a CPU generator takes ~20-30 s of
    # host draws for them)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            torch.float32, "cuda")
    lora = TM.init_lora_stack(cfg, torch.Generator(device=dev).manual_seed(1), None,
                              torch.float32, "cuda")
    g_b = torch.Generator(device=dev).manual_seed(2)
    for layer in lora:           # B != 0, or the rank path would be a no-op
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.02, generator=g_b)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_par = sum(t.numel() for t in tree_leaves(params))
    print(f"[mamba] Mamba2-2.7B full width: {L} layers d={cfg.d_model} d_inner="
          f"{cfg.d_inner}, {cfg.ssm_num_heads} SSD heads of {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, f32: {n_par} "
          f"parameters ({n_par * 4 / 1e9:.2f} GB), LoRA r={cfg.lora_rank} on "
          f"{cfg.lora_targets} with B != 0; drawn on the card in {t_init:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, lora=lora, max_slots=8, max_len=512, paged=False,
                        device="cuda")
    if eng.paged or eng.prefill_buckets:
        fail("Mamba2: the engine must be the slab one, prefilling at exact length")
    eng.submit(Request(uid=1000, prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
    eng.run()                            # first-call set-up, not measured
    eng.reset_stats()
    sreqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=32) for r_ in reqs]
    for r_ in sreqs:
        eng.submit(r_)
    backend.reset_launch_counts()        # just before the main path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(backend.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = eng.stats
    n_tok = sum(len(r_.output) for r_ in sreqs)
    plens = [len(r_.prompt) for r_ in sreqs]
    print(f"[mamba] ServingEngine(paged=False), 8 slots x 512 positions, f32, phase 5's "
          f"{len(sreqs)} requests (prompts {min(plens)}-{max(plens)}, 32 new each, greedy): "
          f"{n_tok} tokens in {wall:.3f}s = {n_tok / wall:.1f} tok/s; {st['decode_steps']} "
          f"decode steps, mean {st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f} "
          f"ms/step; {st['prefills']} prefills at exact length, {st['prefill_s'] * 1e3:.1f} "
          f"ms total ({st['prefill_s'] / max(st['prefills'], 1) * 1e3:.2f} ms/prefill); "
          f"peak device memory {peak:.2f} GiB")
    print(f"[mamba] launches during the run: {launches}")
    print(f"[mamba] token ids digest of the {len(sreqs)} requests: {ids_digest(sreqs)}")
    if not all(r_.done and len(r_.output) == 32 for r_ in sreqs):
        fail("Mamba2 engine: not every request finished with 32 tokens")
    want = {"ssd_scan": L * st["prefills"],
            "lora_matmul": 3 * L * st["prefills"] + 2 * L * st["decode_steps"]}
    if launches != want or st["prefills"] != len(sreqs):
        fail(f"Mamba2 engine launched {launches}, expected exactly {want}")
    print(f"[mamba] launch counts match the path: {want} (per prefill {L} ssd_scan and "
          f"{3 * L} lora_matmul: in_proj, out_proj and the conv tail's in_proj; per "
          f"decode step {2 * L} lora_matmul; nothing else)")

    # the kernel path against the plain path (ssd_chunked, torch.matmul) on
    # the card.  Block by block: every block takes the plain path's input
    # through both paths, its output (the residual update) and state held
    # at 1e-3 of the plain tensor's largest entry.  End to end: a random
    # 64-layer Mamba2 amplifies any f32 rounding over its depth, so the
    # prefill's logits and per-layer states are held against the plain path
    # run in f64 (the witness), the kernel path no more than 3x further from
    # it than the plain f32 path (the two paths round alike; an f32 prefix
    # sum in the scan put the kernel path 14x further from the plain one
    # than the fused projections alone).  The decode step, one token from
    # the engine's state, is held end to end.
    from repro_torch.models.layers import embed
    from repro_torch.models.stack import apply_block
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 300)).astype(np.int32)).to(dev)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1)).astype(np.int32)).to(dev)
    pos = torch.tensor([len(r_.prompt) + 31 for r_ in sreqs[-8:]], dtype=torch.int32,
                       device=dev)
    kern_rt, plain_rt = TM.default_serve_runtime(), TM.Runtime()
    scale = cfg.lora_alpha / cfg.lora_rank

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    worst = {"block output": 0.0, "ssm": 0.0, "conv": 0.0}
    backend.reset_launch_counts()
    x = embed(cfg, eng.params["embed"], prompt, torch.arange(300, device=dev))
    for i, (pat, p_) in enumerate(zip(cfg.layer_kinds, eng.params["layers"])):
        outs = [apply_block(cfg, pat, p_, x, lora=eng.lora[i], lora_scale=scale, rt=rt,
                            mode="prefill") for rt in (kern_rt, plain_rt)]
        (xk, ck, _), (xp, cp, _) = outs
        worst["block output"] = max(worst["block output"], rel(xk - x, xp - x))
        for n in ("ssm", "conv"):
            worst[n] = max(worst[n], rel(ck[n], cp[n]))
        x = xp
    torch.cuda.synchronize()
    blocks = dict(backend.LAUNCH_COUNTS)
    ends = {}
    for label, rt in (("kernels", kern_rt), ("plain", plain_rt),
                      ("fused projections only", TM.Runtime(dense_impl="fused"))):
        lg, pre = TM.prefill(cfg, eng.params, prompt, lora=eng.lora, rt=rt)
        caches = [{k: v.clone() for k, v in c.items()} for c in eng.caches]
        backend.reset_launch_counts()
        lg1, caches = TM.decode_step(cfg, eng.params, tok, caches, pos, lora=eng.lora, rt=rt)
        torch.cuda.synchronize()
        ends[label] = (lg, pre, lg1, caches, dict(backend.LAUNCH_COUNTS))
    (lk, _, dk, sk, nk), (lp, _, dp, sp, npl) = ends["kernels"], ends["plain"]
    e_dec = {"logits": rel(dk, dp), "ssm": max(rel(a["ssm"], b["ssm"]) for a, b in zip(sk, sp)),
             "conv": max(rel(a["conv"], b["conv"]) for a, b in zip(sk, sp))}
    # the f64 witness: the plain path in double precision on the same weights
    to64 = lambda t: tree_map(lambda v: v.double() if v.is_floating_point() else v, t)
    p64, l64 = to64(eng.params), to64(eng.lora)
    lg64, pre64 = TM.prefill(cfg, p64, prompt, lora=l64, rt=plain_rt)
    torch.cuda.synchronize()
    del p64, l64
    wit = {label: {"logits": rel(v[0], lg64),
                   **{n: max(rel(a[n], b[n]) for a, b in zip(v[1], pre64))
                      for n in ("ssm", "conv")},
                   "layer-0 ssm": rel(v[1][0]["ssm"], pre64[0]["ssm"])}
           for label, v in ends.items()}
    wk, wp = wit["kernels"], wit["plain"]
    ratio_ok = all(wk[n] <= 3 * wp[n] for n in ("logits", "ssm", "conv"))
    good = (tuple(lk.shape) == (1, cfg.vocab_size) and tuple(dk.shape) == (8, cfg.vocab_size)
            and all(bool(torch.isfinite(t).all()) for t in (lk, dk))
            and max(worst.values()) <= 1e-3 and max(e_dec.values()) <= 1e-3 and ratio_ok
            and blocks == {"ssd_scan": L, "lora_matmul": 3 * L}
            and nk == {"lora_matmul": 2 * L} and not npl)
    print(f"[mamba] kernel vs plain path: a 300-token prefill (chunks 256 + 44) block by "
          f"block, largest error over the {L} blocks relative to the plain tensor's largest "
          f"entry: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (tol 1e-3; launches {blocks}); one 8-slot decode step from the engine's "
          f"state end to end: " + ", ".join(f"{k} {v:.3g}" for k, v in e_dec.items())
          + f" (tol 1e-3; launches {nk} vs plain {npl})")
    print("[mamba] the 300-token prefill end to end against the plain path in f64, "
          "distance relative to the f64 tensor's largest entry (ssm, conv: the worst "
          f"of the {L} layers): " + "; ".join(
              f"{label} " + ", ".join(f"{n} {v:.3g}" for n, v in w.items())
              for label, w in wit.items())
          + f" (kernels held at <= 3x plain on logits, ssm, conv) {'ok' if good else 'FAIL'}")
    if not good:
        fail("Mamba2 prefill or decode through the kernels disagrees with the plain path")

    same = 0
    for r_ in sreqs[:2]:
        out, _ = TM.generate(cfg, eng.params, torch.tensor([r_.prompt], dtype=torch.int32,
                                                          device=dev),
                             lora=eng.lora, rt=TM.default_serve_runtime(),
                             max_new_tokens=32, sc=TM.SampleConfig(greedy=True))
        same += out[0].tolist() == r_.output
    print(f"[mamba] generate() ids equal to the engine's for {same} of 2 requests "
          f"{'ok' if same == 2 else 'FAIL'}")
    if same != 2:
        fail("Mamba2 generate() ids differ from the slab engine's")
    print(f"[mamba] phase 12 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    return launches


def phase_dynamic(torch, np, dev, reqs):
    """Phase 13: a time-varying wireless SFL episode on full-width GPT-2-S,
    killed and resumed, and its adapter served from a checkpoint.  Returns
    the launch counts of the episode's rounds and of the served run, and
    the largest error of each kernel checked at the episode's shapes."""
    import dataclasses
    import os
    import tempfile

    from repro_torch import models as TM
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs import DEFAULT_SYSTEM, get_arch
    from repro_torch.core import Problem, SflLLM, sample_clients
    from repro_torch.core.lora import concat_tree, split_tree
    from repro_torch.core.resource import bcd_minimize_delay_per_client
    from repro_torch.data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
    from repro_torch.interop import lora_from_numpy, lora_to_numpy
    from repro_torch.kernels import backend
    from repro_torch.kernels.lora_matmul import (lora_matmul, lora_matmul_dx_kernel,
                                                 lora_matmul_dx_ref, lora_matmul_ref,
                                                 lora_rank_reduce_kernel, lora_rank_reduce_ref)
    from repro_torch.launch.engine import SflRound, Trainer, WirelessDynamics
    from repro_torch.launch.serve import restore_lora
    from repro_torch.optim import adamw
    from repro_torch.precision import PrecisionConfig
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_arch("gpt2-s")
    L, P, nt, D = cfg.num_layers, len(cfg.pattern), len(cfg.lora_targets), cfg.d_model
    Kd, bd, Sd, Id, lrd, rounds, kill = 3, 4, 64, 6, 4e-4, 4, 2
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cuda")
    # phase 8's 50 MHz edge problem, its allocator, and a trainer whose
    # capacity envelope holds the whole search space, at fleet b's precision
    edge = dataclasses.replace(DEFAULT_SYSTEM, num_clients=Kd, total_bandwidth_hz=50e6,
                               f_server_hz=1.0e9, f_client_hz_range=(0.3e9, 3.0e9))
    prob = Problem(cfg=cfg, sys_cfg=edge, envs=tuple(sample_clients(edge, 0)), seq_len=Sd,
                   batch=bd, local_steps=Id, bits_candidates=(4, 8, 16))
    alloc, _ = bcd_minimize_delay_per_client(prob)
    # the episode starts from phase 8's hand-set fleet b on the allocator's
    # subchannels and powers; the re-allocation forced in round 2 hands it
    # to the allocator, which moves its splits and ranks
    start = dataclasses.replace(alloc, ell_k=np.array([2, 4, 6]), rank_k=np.array([2, 4, 8]),
                                bits_k=np.array([4, 8, 16]))
    prec = PrecisionConfig(grad_bits=8, stochastic_rounding=True, error_feedback=True)
    train_ex, _, _ = e2e_splits(4000, 400, 400, seed=0)
    tok = WordTokenizer.from_corpus([e.text for e in train_ex])
    parts = [np.array(train_ex, dtype=object)[idx]
             for idx in iid_partition(len(train_ex), Kd, 0)]
    counts = [len(p_) for p_ in parts]
    knobs = dict(fade_std_db=8.0, fade_rho=0.5, deadline_factor=1.2, drift_threshold=0.15,
                 outage_snr_db=10.0, max_harq=4, rng=0)

    def trainer_sfl(rt):
        return SflLLM.from_allocation(prob, alloc, params, adamw(lrd), dynamic=True,
                                      rt=rt.replace(precision=prec), device="cuda")

    # -- the kernels at the episode's shapes, against their plain versions:
    # r = the envelope's r_max (every adapter is padded to it), a client's
    # b x S rows, the server's pool of K x b x S, and the served engine's
    # decode step of 8 slots (the forward only: its decode regime)
    r8 = max(prob.rank_candidates)
    scale8 = cfg.lora_alpha / r8
    gen = torch.Generator().manual_seed(13)
    errs = {}

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    def held(op, what, got, want, tol):
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        good = (torch.allclose(got.float(), want.float(), **tol)
                and bool(torch.isfinite(got).all()))
        print(f"[check] {op} {what}: max_abs_err={e:.3g} atol={tol['atol']} "
              f"rtol={tol['rtol']} {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"{op} disagrees with its plain version ({what}, phase 13)")
        errs[op] = max(errs.get(op, 0.0), e)

    for M in (bd * Sd, Kd * bd * Sd, 8):
        x, w = rn(M, D), rn(D, D, std=D ** -0.5)
        a, b = rn(r8, D, std=r8 ** -0.5), rn(D, r8, std=0.02)
        what = f"float32 M={M} K=N={D} r={r8}"
        held("lora_matmul", what, lora_matmul(x, w, a, b, scale=scale8),
             lora_matmul_ref(x, w, a, b, scale8), dict(atol=TOL["float32"], rtol=TOL["float32"]))
        if M == 8:
            continue
        dy, b = rn(M, D), rn(D, r8, std=D ** -0.5)
        a = rn(r8, D, std=D ** -0.5)
        held("lora_matmul_dx", what, lora_matmul_dx_kernel(dy, w, a, b, scale8),
             lora_matmul_dx_ref(dy, w, a, b, scale8), GRAD_TOL["float32"])
        u, v = rn(M, r8, std=M ** -0.5), rn(M, D)
        held("lora_rank_reduce", f"float32 M={M} r={r8} N={D}", lora_rank_reduce_kernel(u, v),
             lora_rank_reduce_ref(u, v), dict(atol=1e-4, rtol=1e-4))

    def schedule(wd, r):
        """The knobs that force this phase's coverage, set for round r (a
        pure function of r, so a resumed run sets the same ones): client 0
        in certain outage in round 1 (outage_override = [1, 0, 0]: a hard
        outage, and E[m] = max_harq on its links); a re-allocation forced
        in round 2 (drift_threshold = -1: any delay exceeds 0 x ref)."""
        wd.outage_override = np.array([1.0, 0.0, 0.0]) if r == 1 else None
        wd.drift_threshold = -1.0 if r == 2 else knobs["drift_threshold"]

    def copied(st):
        return dataclasses.replace(st, **{f.name: tree_map(lambda v: v.clone(),
                                                           getattr(st, f.name))
                                          for f in dataclasses.fields(st)})

    class Kept(SflRound):
        """SflRound that keeps round `at`'s inputs and outputs."""

        def __init__(self, sfl, counts, at):
            super().__init__(sfl, counts)
            self.at, self.calls, self.kept = at, 0, None

        def run_round(self, state, round_batches, dynamics=None):
            keep = self.calls == self.at
            self.calls += 1
            before = copied(state) if keep else None
            state, metrics = super().run_round(state, round_batches, dynamics=dynamics)
            if keep:
                self.kept = (before, round_batches, dynamics, copied(state),
                             metrics["loss"].clone(), metrics["participation"].clone())
            return state, metrics

    def episode(path, upto, start_round=0, log=None, keep_at=None):
        sfl = trainer_sfl(TM.default_train_runtime())
        lora0 = sfl.init_lora(torch.Generator().manual_seed(1))
        g_b = torch.Generator().manual_seed(2)
        for layer in lora0:      # B != 0: both adapter factors get gradients
            for ad in layer["mixer"].values():
                ad["b"].copy_(torch.randn(ad["b"].shape, generator=g_b) * 0.02)
        wd = WirelessDynamics(prob, start, sfl, **knobs)

        def callback(e, state, hist):
            torch.cuda.synchronize()
            if log is not None:
                log.append(dict(round=e, launches=dict(backend.LAUNCH_COUNTS),
                                part=list(hist.participation[-1]),
                                realloc=e in hist.realloc_rounds,
                                ell=[int(x) for x in wd.alloc.ell_k],
                                rank=[int(x) for x in wd.alloc.rank_k],
                                bits=None if wd.alloc.bits_k is None
                                else [int(x) for x in wd.alloc.bits_k],
                                modeled=hist.modeled_seconds, secs=hist.round_seconds[-1]))
            schedule(wd, e + 1)
            backend.reset_launch_counts()    # just before the next round

        algo = SflRound(sfl, counts) if keep_at is None else Kept(sfl, counts, keep_at)
        trainer = Trainer(algo, local_steps=Id, dynamics=wd, callback=callback,
                          episode_path=path, episode_every=1)
        data = sfl_batches(tok, parts, bd, Sd, 0)
        schedule(wd, start_round)        # the knobs of the first round this run plays
        backend.reset_launch_counts()        # just before the main path
        torch.cuda.synchronize()
        state, hist = trainer.fit(sfl.init_state(lora0), data, global_rounds=upto,
                                  resume=start_round > 0)
        torch.cuda.synchronize()
        return sfl, wd, state, hist, algo

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    log = []
    t0 = time.perf_counter()
    sfl, wd, st_a, h_a, kept = episode(os.path.join(tmp, "a.ckpt"), rounds, log=log, keep_at=1)
    wall = time.perf_counter() - t0
    print(f"[dynamic] GPT-2-S full width, f32 base; the allocator's fleet ell_k="
          f"{alloc.ell_k.tolist()} r_k={alloc.rank_k.tolist()} bits_k={alloc.bits_k.tolist()} "
          f"built with from_allocation(dynamic=True): envelope reps [{sfl.rep_min}, "
          f"{sfl.rep_max}], r_max {sfl.r_max}; precision grad_bits={prec.grad_bits} "
          f"stochastic_rounding={prec.stochastic_rounding} error_feedback="
          f"{prec.error_feedback}; the episode starts from ell_k={start.ell_k.tolist()} "
          f"r_k={start.rank_k.tolist()} bits_k={start.bits_k.tolist()}; K={Kd} x b={bd} x "
          f"S={Sd}, I={Id}, AdamW {lrd}, {rounds} rounds; WirelessDynamics {knobs}; "
          f"deadline {wd.deadline_s:.6f}s; wall {wall:.2f}s")
    train_launches, problems, before = {}, [], 0.0
    for row in log:
        ells, live = row["ell"], [k for k in range(Kd) if row["part"][k]]
        server = L - min(ells)
        want = {"lora_matmul": nt * (sum(ells) + server) * Id,
                "lora_rank_reduce": 2 * nt * (sum(ells[k] for k in live) + server) * Id,
                "lora_matmul_dx": nt * (sum(ells[k] - 1 for k in live) + server) * Id}
        want = {k: v for k, v in want.items() if v}
        got = row["launches"]
        for k, v in got.items():
            train_launches[k] = train_launches.get(k, 0) + v
        ok = got == want
        if not ok:
            problems.append(row["round"])
        print(f"[dynamic] round {row['round']}: participation {row['part']}, re-allocated "
              f"{row['realloc']}, (ell_k, r_k, bits_k) = ({row['ell']}, {row['rank']}, "
              f"{row['bits']}); modeled {row['modeled'] - before:.6f}s; measured "
              f"{row['secs']:.3f}s/round (host clock); launches {got}, expected {want} "
              f"{'ok' if ok else 'FAIL'}")
        before = row["modeled"]
    print(f"[dynamic] losses: {' '.join(f'{x:.4f}' for x in h_a.losses)}")
    print(f"[dynamic] per round expected: lora_matmul {nt}(sum ell_k + L - min ell_k), rank "
          f"reduce {2 * nt}(sum over the round's participants of ell_k + L - min ell_k), dX "
          f"{nt}(sum over participants of (ell_k - 1) + L - min ell_k), x I={Id}: every "
          f"client runs its forward (its upload feeds the quantizer), a dropped one no "
          f"backward")
    if problems:
        fail(f"dynamic episode: launch counts differ from the splits in rounds {problems}")
    dropped = [(r, k) for r, p_ in enumerate(h_a.participation) for k in range(Kd) if not p_[k]]
    config = [(row["ell"], row["rank"]) for row in log]
    moved = [r for r in h_a.realloc_rounds if r > 0 and config[r] != config[r - 1]]
    if not dropped or not moved or all(c == config[0] for c in config):
        fail(f"dynamic episode: dropped client-rounds {dropped}, re-allocations "
             f"{h_a.realloc_rounds}, of which moved (ell_k, r_k) {moved}: the phase needs "
             f"a dropped client-round and a re-allocation that moves the splits or ranks")
    if not all(math.isfinite(x) for x in h_a.losses) or h_a.rolled_back_rounds:
        fail(f"dynamic episode: losses {h_a.losses}, rolled back {h_a.rolled_back_rounds}")
    print(f"[dynamic] coverage: dropped client-rounds {dropped} (round 1: outage_override "
          f"= [1, 0, 0], a hard outage of client 0; any other: the deadline or a drawn "
          f"outage), re-allocations in rounds {h_a.realloc_rounds} (round 2: drift_threshold "
          f"= -1 for that round; any other: the channel's drift over 0.15), of which "
          f"{moved} moved (ell_k, r_k): {config[0]} -> {config[-1]}")

    # round 1 (client 0 dropped) again on its inputs: its first local step
    # and the partial FedAvg through the kernels and through the plain path
    # (Runtime()), held at phase 6's tolerance for one local step; the whole
    # round (6 steps) is printed beside it as a witness, no check: over 6
    # steps the 4- and 8-bit quantizers and AdamW carry f32 rounding further
    st_in, rb1, dyn1, st_k6, loss_k6, part_k = kept.kept
    sfl_p = trainer_sfl(TM.Runtime())
    rb1_one = {k: v[:1] for k, v in rb1.items()}
    outs = []
    for s_ in (sfl, sfl_p):
        backend.reset_launch_counts()
        st_, m_ = s_.train_round(st_in, rb1_one, counts, dynamics=dyn1)
        torch.cuda.synchronize()
        outs.append((st_, m_, dict(backend.LAUNCH_COUNTS)))
    (st_k, m_k, k_launches), (st_p, m_p, plain_launches) = outs

    def adapter_err(x_st, y_st):
        return max((x - y).abs().max().item() for side in ("lora_client", "lora_server")
                   for x, y in zip(tree_leaves(getattr(x_st, side)),
                                   tree_leaves(getattr(y_st, side))))
    e_ad = adapter_err(st_k, st_p)
    e_loss = (m_k["loss"] - m_p["loss"]).abs().max().item()
    ad_tol = lrd * 1e-2
    frozen = all(torch.equal(x[0], y[0]) for side in ("lora_client", "opt_client")
                 for st in (st_k, st_p, st_k6)
                 for x, y in zip(tree_leaves(getattr(st, side)), tree_leaves(getattr(st_in, side)))
                 if x.dim() > 0)
    good = (part_k.tolist() == m_k["participation"].tolist() == m_p["participation"].tolist()
            == [0.0, 1.0, 1.0] and e_loss <= 1e-4 * max(1.0, m_p["loss"].abs().max().item())
            and e_ad <= ad_tol and frozen and not plain_launches
            and k_launches.get("lora_matmul", 0) > 0)
    print(f"[dynamic] round 1 (participation {part_k.tolist()}) on its inputs, its first local "
          f"step and the partial FedAvg: kernels (launches {k_launches}) vs plain path "
          f"(Runtime(), launches {plain_launches}): loss {m_k['loss'].item():.6f} vs "
          f"{m_p['loss'].item():.6f}, max_abs_err={e_loss:.3g} (tol 1e-4 rel), adapters "
          f"max_abs_err={e_ad:.3g} (tol lr*1e-2 = {ad_tol:.1g}); client 0's adapter and "
          f"moments unchanged bit for bit on both paths and in the episode's round: "
          f"{frozen} {'ok' if good else 'FAIL'}")
    if not good:
        fail("dynamic round 1 through the kernels disagrees with the plain path")
    st_p6, m_p6 = sfl_p.train_round(st_in, rb1, counts, dynamics=dyn1)
    torch.cuda.synchronize()
    print(f"[dynamic] round 1 whole ({Id} local steps), the episode's kernels vs the plain "
          f"path, a witness: losses max |diff| {(loss_k6 - m_p6['loss']).abs().max().item():.3g}, "
          f"adapters max |diff| {adapter_err(st_k6, st_p6):.3g}")

    # kill after `kill` rounds, resume with a fresh trainer and dynamics
    path_b = os.path.join(tmp, "b.ckpt")
    episode(path_b, kill)
    _, wd_b, st_b, h_b, _ = episode(path_b, rounds, start_round=kill)
    if (st_a.err_act is None or st_a.err_grad is None
            or not (st_a.err_act.abs().max() > 0 and st_a.err_grad.abs().max() > 0)):
        fail("dynamic episode: the error-feedback state is missing or zero")
    diff = [f for f in ("lora_client", "lora_server", "opt_client", "opt_server", "err_act",
                        "err_grad", "step")
            if not all(torch.equal(x, y) for x, y in zip(tree_leaves(getattr(st_a, f)),
                                                         tree_leaves(getattr(st_b, f))))]
    diff += [f for f in ("participation", "realloc_rounds", "modeled_delays", "losses")
             if getattr(h_a, f) != getattr(h_b, f)]
    if wd_b.cursor() != wd.cursor():
        diff.append("dynamics cursor")
    print(f"[dynamic] killed after round {kill}, resumed to round {rounds} with a fresh "
          f"trainer and dynamics: adapters, optimizer state, error feedback (non-zero, "
          f"restored from the episode file), participation, re-allocations, modeled delays, "
          f"losses and cursor bit-equal to the uninterrupted run: "
          f"{'ok' if not diff else 'FAIL ' + str(diff)}")
    if diff:
        fail(f"resumed episode differs from the uninterrupted one in {diff}")

    # the hand-off: {"lora_server", "lora_client0"} (examples/train_sfl_e2e.py's
    # schema), restored and joined at client 0's split into the served stack,
    # written as a whole stack and served through launch.serve's restore path
    c0 = tree_map(lambda v: v[0], st_a.lora_client)
    handoff = os.path.join(tmp, "handoff.ckpt")
    save_pytree(handoff, {"lora_server": lora_to_numpy(st_a.lora_server, P),
                          "lora_client0": lora_to_numpy(c0, P)})
    got = restore_pytree(handoff, {"lora_server": lora_to_numpy(st_a.lora_server, P),
                                   "lora_client0": lora_to_numpy(c0, P)})
    rep0 = int(wd.alloc.ell_k[0]) // P
    served = concat_tree(split_tree(lora_from_numpy(got["lora_client0"], dev), rep0, P)[0],
                         split_tree(lora_from_numpy(got["lora_server"], dev),
                                    rep0 - sfl.rep_min, P)[1])
    in_memory = concat_tree(split_tree(c0, rep0, P)[0],
                            split_tree(st_a.lora_server, rep0 - sfl.rep_min, P)[1])
    stack_path = os.path.join(tmp, "served.ckpt")
    save_pytree(stack_path, lora_to_numpy(served, P))
    cfg_s = cfg.replace(lora_rank=sfl.r_max)     # the scale alpha / r_max it trained at
    restored = restore_lora(cfg_s, stack_path,
                            TM.init_lora_stack(cfg_s, torch.Generator().manual_seed(9), None,
                                               torch.float32, "cuda"))
    if len(restored) != L or not all(torch.equal(x, y) for x, y in
                                     zip(tree_leaves(restored), tree_leaves(in_memory))):
        fail("the restored served stack differs from the in-memory one")
    outs = []
    for lora in (restored, in_memory):
        eng = ServingEngine(cfg_s, params, lora=lora, max_slots=8, max_len=512, page_size=16,
                            device="cuda")
        sreqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=32) for r_ in reqs]
        for r_ in sreqs:
            eng.submit(r_)
        backend.reset_launch_counts()        # just before the main path
        eng.run()
        torch.cuda.synchronize()
        outs.append((sreqs, dict(backend.LAUNCH_COUNTS), dict(eng.stats)))
    (sr, serve_launches, stt), (sm, _, _) = outs
    want = {"lora_matmul": 2 * L * (stt["decode_steps"] + stt["prefill_chunks"]),
            "paged_decode": L * stt["decode_steps"]}
    same = sum(a.output == b.output for a, b in zip(sr, sm))
    good = (serve_launches == want and same == len(sr)
            and all(r_.done and len(r_.output) == 32 for r_ in sr))
    print(f"[dynamic] hand-off: {{lora_server, lora_client0}} saved, restored, joined at "
          f"client 0's split (ell {int(wd.alloc.ell_k[0])}) into a {L}-layer r={sfl.r_max} "
          f"stack, written with save_pytree and read by launch.serve.restore_lora; phase 5's "
          f"{len(sr)} requests through the paged engine: ids equal to the in-memory "
          f"adapter's for {same} of {len(sr)}; launches {serve_launches}, expected {want}; "
          f"token ids digest {ids_digest(sr)} {'ok' if good else 'FAIL'}")
    if not good:
        fail("serving the restored adapter: ids or launch counts are wrong")
    print(f"[dynamic] phase 13 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    return train_launches, serve_launches, errs


def phase_faults(torch, np, dev, reqs, params, lora):
    """Phase 14: fault injection and recovery on full-width GPT-2-S.  (a)
    phase 5's engine drains phase 5's requests under slot crashes,
    residency deadlines and a NaN poke, then priority preemption,
    backpressure and a resync; (b) a defended wireless episode under a
    Byzantine client and a poisoned round, killed mid-quarantine and
    resumed.  Returns the launch counts of (a) and of (b)."""
    import dataclasses
    import os
    import tempfile
    import warnings

    from repro_torch.configs import DEFAULT_SYSTEM, get_arch
    from repro_torch.core import Problem, SflLLM, sample_clients
    from repro_torch.core import sfl as sfl_mod
    from repro_torch.core.aggregation import RobustAggConfig, robust_aggregate
    from repro_torch.core.defense import ByzantineOps, DefenseConfig, corrupt_updates
    from repro_torch.core.resource import bcd_minimize_delay_per_client
    from repro_torch.data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
    from repro_torch.faults import ServingFaults, TrainingFaults
    from repro_torch.kernels import backend
    from repro_torch.launch.engine import SflRound, Trainer, WirelessDynamics
    from repro_torch.optim import adamw
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_arch("gpt2-s")
    L, nt = cfg.num_layers, len(cfg.lora_targets)
    want_of = {r_.uid: r_.output for r_ in reqs}      # phase 5's ids
    serve_launches = {}

    def add(into, counts):
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v

    def engine(**kw):
        kw = {"max_slots": 8, "max_len": 512, **kw}
        return ServingEngine(cfg, params, lora=lora, page_size=16, device="cuda", **kw)

    def path_counts(eng, what):
        """The main path's launches since the last reset, against what the
        engine's steps and chunks imply."""
        torch.cuda.synchronize()
        got, st = dict(backend.LAUNCH_COUNTS), eng.stats
        want = {"lora_matmul": 2 * L * (st["decode_steps"] + st["prefill_chunks"]),
                "paged_decode": L * st["decode_steps"]}
        want = {k: v for k, v in want.items() if v}
        if got != want:
            fail(f"{what}: launches {got}, expected {want} (phase 14)")
        add(serve_launches, got)
        return got

    # -- (a) serving chaos: bench_faults' crash schedule, a residency
    # deadline on every third request, one NaN poke -------------------------
    CRASH_AT, POKE_STEP, DEADLINE = {6: 0, 14: 1}, 20, 10
    eng = engine()
    sf = ServingFaults(eng)
    creqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=32,
                     deadline_steps=DEADLINE if r_.uid % 3 == 0 else None) for r_ in reqs]
    for r_ in creqs:
        eng.submit(r_)
    events, crashes, poked = [], {}, None     # (step, uid, crash?, prefix, gained)
    start_len = {r_.uid: 0 for r_ in creqs}
    backend.reset_launch_counts()        # just before the main path
    torch.cuda.synchronize()
    t0, steps = time.perf_counter(), 0
    while eng.queue or any(s is not None for s in eng.slots):
        if steps in CRASH_AT and eng.slots[CRASH_AT[steps]] is not None:
            sf.crash_slot(CRASH_AT[steps])
            crashes[steps] = eng.slots[CRASH_AT[steps]].uid
        if steps == POKE_STEP:
            # the first live slot with no deadline: a poke is not a victim
            s = next(s for s, r_ in enumerate(eng.slots)
                     if r_ is not None and r_.deadline_steps is None)
            sf.poke_nan(s)
            poked = eng.slots[s].uid
        before = {r_.uid: r_.preempted for r_ in creqs}
        eng.step()
        for r_ in creqs:
            if r_.preempted > before[r_.uid]:
                events.append((steps, r_.uid, crashes.get(steps) == r_.uid,
                               len(r_.prompt) + len(r_.output),
                               len(r_.output) - start_len[r_.uid]))
                start_len[r_.uid] = len(r_.output)
        steps += 1
        if steps > 2000:
            fail("serving chaos did not drain (phase 14)")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    chaos_launches = path_counts(eng, "serving chaos")
    n_crash = sum(1 for e in events if e[2])
    deadline_ev = [e for e in events if not e[2]]
    want_stats = {"preemptions": len(events), "deadline_preemptions": len(deadline_ev),
                  "quarantined": 1, "recomputed_tokens": sum(e[3] for e in events)}
    got_stats = {k: st[k] for k in want_stats}
    chunks = (sum(-(-len(r_.prompt) // 16) for r_ in creqs)
              + sum(-(-e[3] // 16) for e in events))
    bad_ids = [r_.uid for r_ in creqs if r_.uid != poked
               and (r_.output != want_of[r_.uid] or r_.error is not None or not r_.done)]
    pr = next(r_ for r_ in creqs if r_.uid == poked)
    good = (not bad_ids and got_stats == want_stats and n_crash == len(crashes) == 2
            and all(creqs[e[1]].deadline_steps == DEADLINE and e[4] == DEADLINE + 1
                    for e in deadline_ev)
            and pr.error == "non-finite logits" and pr.done
            and pr.output == want_of[poked][:len(pr.output)] and len(pr.output) < 32
            and st["prefill_chunks"] == chunks
            and eng.check_consistency(resync=False) and eng.pages_in_use() == 0)
    print(f"[faults] serving chaos on phase 5's engine (GPT-2-S f32, 8 slots x 512, pages of "
          f"16) and requests: crashes at steps {crashes} (step: uid), deadline_steps="
          f"{DEADLINE} on uids {[r_.uid for r_ in creqs if r_.deadline_steps]}, NaN poke at "
          f"step {POKE_STEP} on uid {poked}; {steps} steps, {wall:.3f}s (host clock)")
    print(f"[faults] preemption events (step, uid, crash, prefix recomputed, tokens gained in "
          f"the residency): {events}")
    print(f"[faults] stats {got_stats}, implied by the schedule {want_stats}; prefill chunks "
          f"{st['prefill_chunks']} (prompts and recomputed prefixes imply {chunks}), "
          f"{st['prefill_s'] / max(st['prefill_chunks'], 1) * 1e3:.2f} ms/chunk; decode "
          f"steps {st['decode_steps']}, {st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f} "
          f"ms/step (host clock); launches {chaos_launches} (24 lora_matmul per decode step "
          f"and per chunk, 12 paged_decode per step)")
    print(f"[faults] ids equal to phase 5's for {len(creqs) - 1 - len(bad_ids)} of "
          f"{len(creqs) - 1} unpoked requests; poked uid {poked}: error {pr.error!r}, "
          f"{len(pr.output)} tokens delivered, a prefix of phase 5's; token ids digest "
          f"{ids_digest(creqs)} {'ok' if good else 'FAIL'}")
    if not good:
        fail(f"serving chaos: ids differ for {bad_ids}, or stats {got_stats} != {want_stats}, "
             f"or the poked request or the page accounting is wrong (phase 14)")

    # priority preemption: 2 slots x 256 positions over 16 pages, which hold
    # the hog's 15 and 1 more, so a higher-priority request evicts it; the
    # hog's ids equal a solo run's
    long_r = max(reqs, key=lambda r_: len(r_.prompt))
    short_r = min(reqs, key=lambda r_: len(r_.prompt))
    hog_pages = -(-(len(long_r.prompt) + 32) // 16)
    solo = Request(uid=long_r.uid, prompt=list(long_r.prompt), max_new_tokens=32)
    e0 = engine(max_slots=2, max_len=256)
    e0.submit(solo)
    backend.reset_launch_counts()
    e0.run()
    path_counts(e0, "solo run")
    ep = engine(max_slots=2, max_len=256, num_pages=hog_pages + 2, preempt=True)
    hog = Request(uid=long_r.uid, prompt=list(long_r.prompt), max_new_tokens=32, priority=0)
    vip = Request(uid=short_r.uid, prompt=list(short_r.prompt), max_new_tokens=32, priority=5)
    backend.reset_launch_counts()
    ep.submit(hog)
    ep.step()
    ep.step()
    ep.submit(vip)
    ep.run()
    path_counts(ep, "priority preemption")
    good = (hog.done and vip.done and hog.preempted >= 1 and ep.stats["preemptions"] >= 1
            and hog.output == solo.output and vip.output == want_of[vip.uid]
            and ep.check_consistency(resync=False) and ep.pages_in_use() == 0)
    print(f"[faults] priority preemption: {ep.num_pages - 1} pages, hog uid {hog.uid} "
          f"({hog_pages} pages, priority 0) evicted {hog.preempted}x by uid {vip.uid} "
          f"(priority 5); hog's ids equal its solo run: {hog.output == solo.output} (and "
          f"phase 5's: {hog.output == want_of[hog.uid]}); the vip's equal phase 5's: "
          f"{vip.output == want_of[vip.uid]} {'ok' if good else 'FAIL'}")
    if not good:
        fail("priority preemption: the evicted request's ids differ from its solo run")

    # backpressure: every free page held, nothing admitted; released, all finish
    eb = engine()
    fb = ServingFaults(eb)
    breqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=8) for r_ in reqs[:4]]
    held = fb.exhaust_pages()
    for r_ in breqs:
        eb.submit(r_)
    backend.reset_launch_counts()
    for _ in range(3):
        eb.step()
    stalled = (all(s is None for s in eb.slots) and len(eb.queue) == 4
               and not backend.LAUNCH_COUNTS)
    fb.release_pages()
    eb.run()
    path_counts(eb, "backpressure")
    good = (stalled and all(r_.done and r_.output == want_of[r_.uid][:8] for r_ in breqs)
            and eb.check_consistency(resync=False) and eb.pages_in_use() == 0)
    print(f"[faults] backpressure: {held} pages held, 3 steps admitted nothing and launched "
          f"nothing: {stalled}; released, 4 requests x 8 tokens equal phase 5's first 8 "
          f"{'ok' if good else 'FAIL'}")
    if not good:
        fail("backpressure: admission while the pages were held, or wrong ids after")

    # resync: a desynced mirror is caught and repaired once
    er = engine()
    ServingFaults(er).desync_mirror(2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        flagged = not er.check_consistency()
    rr = Request(uid=reqs[0].uid, prompt=list(reqs[0].prompt), max_new_tokens=4)
    er.submit(rr)
    backend.reset_launch_counts()
    er.run()
    path_counts(er, "resync")
    good = (flagged and len(caught) == 1 and er.stats["resyncs"] == 1
            and er.check_consistency(resync=False) and rr.output == want_of[rr.uid][:4])
    print(f"[faults] resync: desync_mirror(2) flagged {flagged}, {len(caught)} warning, "
          f"resyncs {er.stats['resyncs']}, then consistent and serving "
          f"{'ok' if good else 'FAIL'}")
    if not good:
        fail("resync: the desynced mirror was not repaired exactly once")

    # -- (b) training under attack ----------------------------------------------
    Kd, bd, Sd, Id, lrd, rounds, kill, poison_at = 3, 4, 64, 6, 4e-4, 6, 3, 3
    edge = dataclasses.replace(DEFAULT_SYSTEM, num_clients=Kd, total_bandwidth_hz=50e6,
                               f_server_hz=1.0e9, f_client_hz_range=(0.3e9, 3.0e9))
    prob = Problem(cfg=cfg, sys_cfg=edge, envs=tuple(sample_clients(edge, 0)), seq_len=Sd,
                   batch=bd, local_steps=Id, bits_candidates=(4, 8, 16))
    alloc, _ = bcd_minimize_delay_per_client(prob)
    defense = DefenseConfig(clip=0.01, trim=1, quarantine_rounds=2)
    train_ex, _, _ = e2e_splits(4000, 400, 400, seed=0)
    tok = WordTokenizer.from_corpus([e.text for e in train_ex])
    parts = [np.array(train_ex, dtype=object)[idx]
             for idx in iid_partition(len(train_ex), Kd, 0)]
    first = next(sfl_batches(tok, parts, bd, Sd, 0))
    # every client the same batch (repro's _shared_data): benign updates
    # correlate, so the cosine score separates the attacker.  FedAvg
    # weights 1:2:2, the attacker's the smallest: every upload is clipped
    # to the same norm, and with equal weights a benign client's
    # leave-one-out peer mean would be the attacker's upload and a benign
    # one cancelling to rounding, whose direction no threshold can hold
    batch = {k: np.broadcast_to(v[:1], v.shape).copy() for k, v in first.items()}
    counts = [1.0, 2.0, 2.0]

    def copied(st_):
        return dataclasses.replace(st_, **{f.name: tree_map(lambda v: v.clone(),
                                                            getattr(st_, f.name))
                                           for f in dataclasses.fields(st_)})

    def episode(path, upto, start_round=0, log=None, kept=None):
        sfl = SflLLM.from_allocation(prob, alloc, params, adamw(lrd), dynamic=True,
                                     device="cuda")
        lora0 = sfl.init_lora(torch.Generator().manual_seed(1))
        g_b = torch.Generator().manual_seed(2)
        for layer in lora0:      # B != 0: both adapter factors get gradients
            for ad in layer["mixer"].values():
                ad["b"].copy_(torch.randn(ad["b"].shape, generator=g_b) * 0.02)
        wd = WirelessDynamics(prob, alloc, sfl, rng=0, deadline_s=1e9, defense=defense)
        tf = TrainingFaults(wd)
        tf.arm_byzantine(seed=0)     # the hooks are transient: re-armed on resume
        tf.sign_flip([0])
        tf.scale_blowup([0], 20.0)

        def callback(e, state, hist):
            torch.cuda.synchronize()
            if log is not None:
                log.append(dict(round=e, launches=dict(backend.LAUNCH_COUNTS),
                                part=list(hist.participation[-1])))
            if kept is not None:
                kept[e] = copied(state)
            if e + 1 == poison_at:
                tf.poison_round()
            backend.reset_launch_counts()    # just before the next round

        trainer = Trainer(SflRound(sfl, counts), local_steps=Id, dynamics=wd,
                          callback=callback, episode_path=path, episode_every=1)
        if start_round == poison_at:
            tf.poison_round()
        backend.reset_launch_counts()        # just before the main path
        torch.cuda.synchronize()
        state, hist = trainer.fit(sfl.init_state(lora0), iter(lambda: batch, None),
                                  global_rounds=upto, resume=start_round > 0)
        torch.cuda.synchronize()
        return sfl, wd, state, hist

    # capture round 1's corruption and aggregation on the card, to run them
    # again on the CPU from host copies
    capture, orig = {}, (sfl_mod.corrupt_updates, sfl_mod.robust_aggregate)
    calls = {"n": 0}

    def corrupt_spy(stacked, ref, ops):
        out = orig[0](stacked, ref, ops)
        if calls["n"] == 1:
            capture["corrupt"] = (stacked, ref, ops, out)
        return out

    def robust_spy(stacked, ref, weights, part, masks, rcfg):
        out = orig[1](stacked, ref, weights, part, masks, rcfg)
        if calls["n"] == 1:
            capture["robust"] = (stacked, ref, weights, part, masks, rcfg, out)
        calls["n"] += 1
        return out

    tmp = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    log, kept = [], {}
    sfl_mod.corrupt_updates, sfl_mod.robust_aggregate = corrupt_spy, robust_spy
    try:
        t0 = time.perf_counter()
        sfl, wd, st_a, h_a = episode(os.path.join(tmp, "a.ckpt"), rounds, log=log, kept=kept)
        wall = time.perf_counter() - t0
    finally:
        sfl_mod.corrupt_updates, sfl_mod.robust_aggregate = orig
    ells = [int(x) for x in alloc.ell_k]
    server = L - min(ells)
    print(f"[faults] GPT-2-S full width f32, the allocator's fleet ell_k={ells} r_k="
          f"{alloc.rank_k.tolist()} bits_k={alloc.bits_k.tolist()} through from_allocation("
          f"dynamic=True); K={Kd} x b={bd} x S={Sd}, I={Id}, AdamW {lrd}, every client the "
          f"same batch, FedAvg weights {counts}; WirelessDynamics(defense={defense}); client 0 sign_flip + "
          f"scale_blowup(20), poison_round before round {poison_at}; {rounds} rounds, "
          f"wall {wall:.2f}s")
    train_launches, problems = {}, []
    for row, sc, q, secs in zip(log, h_a.anomaly_scores, h_a.quarantined, h_a.round_seconds):
        live = [k for k in range(Kd) if row["part"][k]]
        want = {"lora_matmul": nt * (sum(ells) + server) * Id,
                "lora_rank_reduce": 2 * nt * (sum(ells[k] for k in live) + server) * Id,
                "lora_matmul_dx": nt * (sum(ells[k] - 1 for k in live) + server) * Id}
        want = {k: v for k, v in want.items() if v}
        add(train_launches, row["launches"])
        ok = row["launches"] == want
        if not ok:
            problems.append(row["round"])
        print(f"[faults] round {row['round']}: update_norm "
              f"{[float(f'{x:.6g}') for x in sc['update_norm']]} cos_dist "
              f"{[float(f'{x:.6g}') for x in sc['cos_dist']]} quarantined {q} participation "
              f"{row['part']} rolled back {row['round'] in h_a.rolled_back_rounds}; "
              f"{secs:.3f}s (host clock); launches {row['launches']}, expected {want} {'ok' if ok else 'FAIL'}")
    q = np.asarray(h_a.quarantined)
    p_ = np.asarray(h_a.participation)
    norms = np.asarray([s_["update_norm"] for s_ in h_a.anomaly_scores])
    good = (not problems and q.shape == (rounds, Kd) and q[:, 0].sum() >= 1
            and q[:, 1:].sum() == 0 and (p_[q[:, 0] == 1, 0] == 0).all()
            and h_a.rolled_back_rounds == [poison_at]
            and (norms[:, 1:] > defense.clip).all()
            and all(math.isfinite(x) for x in h_a.losses))
    same = [f.name for f in dataclasses.fields(kept[poison_at])
            if not all(torch.equal(x, y) for x, y in
                       zip(tree_leaves(getattr(kept[poison_at], f.name)),
                           tree_leaves(getattr(kept[poison_at - 1], f.name))))]
    print(f"[faults] quarantined client-rounds {[(r, 0) for r in np.nonzero(q[:, 0])[0].tolist()]}"
          f", benign ever quarantined {int(q[:, 1:].sum())}, tracker {wd.tracker.state()}; "
          f"rolled back {h_a.rolled_back_rounds}, state after round {poison_at} bit-equal to "
          f"before it: {not same} {'ok' if good and not same else 'FAIL'}")
    if problems or not good or same:
        fail(f"training under attack: launch counts differ in rounds {problems}, or the "
             f"quarantine {q.tolist()}, the rollback {h_a.rolled_back_rounds} or the state "
             f"fields {same} are wrong (phase 14)")

    # round 1's corruption and aggregation again on the CPU, from host copies
    cpu = lambda t_: tree_map(lambda v: v.detach().cpu(), t_)        # noqa: E731

    def dist(a, b):
        return max((x.cpu().float() - y.float()).abs().max().item()
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))
    stacked, ref, ops, out = capture["corrupt"]
    K_ = len(ops.sign)
    modes = {"sign_flip": dict(sign=[1.0] + [0.0] * (K_ - 1)),
             "scale_blowup": dict(scale=[20.0] + [1.0] * (K_ - 1)),
             "gaussian_noise": dict(noise_std=[0.01] + [0.0] * (K_ - 1)),
             "replay_stale": dict(replay=[1.0] + [0.0] * (K_ - 1))}
    errs, worst = {}, 0.0
    errs["episode's ops"] = dist(out, corrupt_updates(cpu(stacked), cpu(ref), ops))
    for name, kw in modes.items():
        o = ByzantineOps.benign(K_, seed=3, round_idx=1)
        o = dataclasses.replace(o, **{k: np.asarray(v, np.float32) for k, v in kw.items()})
        errs[name] = dist(corrupt_updates(stacked, ref, o),
                          corrupt_updates(cpu(stacked), cpu(ref), o))
    cstacked, cref, weights, part, masks, rcfg, (agg, scores) = capture["robust"]
    configs = {"episode's": rcfg, "off": RobustAggConfig.off(),
               "clip": RobustAggConfig.make(clip=defense.clip),
               "clip+trim 1": RobustAggConfig.make(clip=defense.clip, trim=1),
               "clip+median": RobustAggConfig.make(clip=defense.clip, median=True)}
    for name, rc in configs.items():
        g_agg, g_sc = ((agg, scores) if name == "episode's" else
                       robust_aggregate(cstacked, cref, weights, part, masks, rc))
        c_agg, c_sc = robust_aggregate(cpu(cstacked), cpu(cref), weights, part, cpu(masks), rc)
        errs[f"aggregate {name}"] = max(dist(g_agg, c_agg),
                                        dist([g_sc["update_norm"]], [c_sc["update_norm"]]),
                                        dist([g_sc["cos_dist"]], [c_sc["cos_dist"]]))
    worst = max(errs.values())
    print(f"[faults] round 1 again on the CPU from host copies, max |card - CPU| (tol 1e-6): "
          f"corrupt_updates {{{', '.join(f'{k}: {v:.3g}' for k, v in errs.items() if not k.startswith('aggregate'))}}}; "
          f"robust_aggregate (aggregate, update_norm, cos_dist) "
          f"{{{', '.join(f'{k[10:]}: {v:.3g}' for k, v in errs.items() if k.startswith('aggregate'))}}} "
          f"{'ok' if worst <= 1e-6 else 'FAIL'}")
    if worst > 1e-6:
        fail(f"robust_aggregate/corrupt_updates on the card differ from the CPU: {errs}")

    # kill during the quarantine, resume with a fresh trainer and dynamics
    path_b = os.path.join(tmp, "b.ckpt")
    episode(path_b, kill)
    _, wd_b, st_b, h_b = episode(path_b, rounds, start_round=kill)
    diff = [f.name for f in dataclasses.fields(st_a)
            if not all(torch.equal(x, y) for x, y in zip(tree_leaves(getattr(st_a, f.name)),
                                                         tree_leaves(getattr(st_b, f.name))))]
    diff += [f for f in ("losses", "participation", "quarantined", "anomaly_scores",
                         "rolled_back_rounds") if getattr(h_a, f) != getattr(h_b, f)]
    if wd_b.tracker.state() != wd.tracker.state():
        diff.append("tracker")
    if wd_b.cursor() != wd.cursor():
        diff.append("dynamics cursor")
    print(f"[faults] killed after round {kill} (client 0 quarantined: "
          f"{bool(q[kill - 1, 0])}), resumed to round {rounds} with a fresh trainer, "
          f"dynamics and re-armed attacker: adapters, optimizer state, losses, "
          f"participation, quarantine and score histories, tracker and cursor bit-equal to "
          f"the uninterrupted run: {'ok' if not diff else 'FAIL ' + str(diff)}")
    if diff or not q[kill - 1, 0]:
        fail(f"resume under quarantine differs from the uninterrupted run in {diff}, or the "
             f"kill was not during the quarantine (phase 14)")
    print(f"[faults] phase 14 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    return serve_launches, train_launches


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def attention_per_step(Kc, L, ell):
    """Launches per local step of a homogeneous round whose every layer has
    LoRA on q and v: the forward per projection and pass, dX where the
    projection's input needs a gradient (not the client's first layer),
    two rank reduces per projection."""
    return {"lora_matmul": 2 * (Kc * ell + L - ell),
            "lora_rank_reduce": 4 * (Kc * ell + L - ell),
            "lora_matmul_dx": 2 * (Kc * (ell - 1) + L - ell)}


def mamba_per_step(Kc, L, ell):
    """Launches per local step of Mamba2 with LoRA on ssm_in and ssm_out:
    the scan and its backward once per block per client or server pass,
    the forward per projection and pass, dX for every projection but the
    client's first ssm_in (its input, the embedding, needs no gradient),
    two rank reduces per projection."""
    passes = Kc * ell + L - ell
    return {"ssd_scan": passes, "ssd_scan_bwd": passes, "lora_matmul": 2 * passes,
            "lora_rank_reduce": 4 * passes, "lora_matmul_dx": Kc * (2 * ell - 1) + 2 * (L - ell)}


def jamba_per_step(Kc, L, ell):
    """Launches per local step of reduced Jamba (periods of one attention
    layer with LoRA on q and v, then seven mamba layers without LoRA):
    every mamba block's scan and backward (each lies above an adapter),
    the attention layers' LoRA as ``attention_per_step`` counts them."""
    per = 8
    att = attention_per_step(Kc, L // per, ell // per)
    return {**att, "ssd_scan": 7 * (Kc * ell + L - ell) // per,
            "ssd_scan_bwd": 7 * (Kc * ell + L - ell) // per}


def sfl_round(torch, np, tag, cfg, params, lora, *, split, per_step, batch=4, seq=64,
              reduced=False, witness_seq=None):
    """One homogeneous SFL round through ``launch.train.run`` (3 clients x
    ``batch`` x ``seq`` tokens of the synthetic E2E corpus, I = 6, AdamW
    4e-4; ``params``/``lora`` None: drawn by ``run`` from its seed); the
    launch counters, reset just before, must equal ``per_step(clients,
    layers, split)`` times the steps; the server's aux loss is read from
    each round's metrics; then one local step from the trained state
    through the kernels and through the plain path (``Runtime()``).  By
    default the two are held at phase 6's tolerance (loss 1e-4 relative,
    adapters lr 1e-2).  With ``witness_seq`` the step runs on
    ``witness_seq`` tokens, and the plain path also in f64 on the same
    weights (every leaf cast, as phase 12's witness): the kernel path's
    distance from it (loss, adapters) must be at most 3x the plain f32
    path's, or within 1e-6 of the loss.  Returns (state, history, sfl,
    launches)."""
    from repro_torch import models as TM
    from repro_torch.core import SflLLM
    from repro_torch.kernels import backend
    from repro_torch.launch import engine as engine_mod
    from repro_torch.launch.train import build_argparser, run
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    targs = build_argparser().parse_args(
        ["--arch", cfg.name, "--clients", "3", "--batch", str(batch), "--seq", str(seq),
         "--local-steps", "6", "--steps", "6", "--split", str(split), "--lr", "4e-4",
         "--device", "cuda", "--seed", "0", "--log-every", "1"]
        + (["--reduced"] if reduced else []))
    seen = []
    plain_run_round = engine_mod.SflRound.run_round

    def run_round(self, *a, **kw):
        out = plain_run_round(self, *a, **kw)
        seen.append(out[1])
        return out

    engine_mod.SflRound.run_round = run_round
    try:
        backend.reset_launch_counts()    # just before the main path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist, sfl = run(targs, params=params, lora=lora)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine_mod.SflRound.run_round = plain_run_round
    launches = dict(backend.LAUNCH_COUNTS)
    cfg = sfl.cfg
    Kc, L, ell = targs.clients, cfg.num_layers, sfl.ell_c
    steps = len(hist.losses)
    want = per_step(Kc, L, ell)
    aux = [a for m in seen for a in m["aux"].tolist()]
    print(f"[{tag}] SFL round of {cfg.name}: K={Kc} x b={targs.batch} x S={targs.seq}, "
          f"I={targs.local_steps}, split {ell} of {L}, AdamW lr={targs.lr}: wall "
          f"{wall:.2f}s incl. data and allocator; per round "
          + ", ".join(f"{t:.3f}s" for t in hist.round_seconds)
          + f" (host clock); peak device memory {peak_gib(torch):.2f} GiB")
    print(f"[{tag}] losses: {' '.join(f'{x:.4f}' for x in hist.losses)}")
    print(f"[{tag}] server aux per step: {' '.join(f'{x:.4f}' for x in aux)} "
          f"(aux_coef {sfl.aux_coef})")
    print(f"[{tag}] launches during the run: {launches}; per local step expected {want}")
    if steps != 6 or not all(math.isfinite(x) for x in hist.losses):
        fail(f"{cfg.name}: training losses not finite or wrong count: {hist.losses}")
    if hist.rolled_back_rounds:
        fail(f"{cfg.name}: rounds rolled back: {hist.rolled_back_rounds}")
    if len(aux) != steps or not all(math.isfinite(x) for x in aux):
        fail(f"{cfg.name}: aux losses missing or not finite: {aux}")
    if cfg.num_experts and not min(aux) > 0:
        fail(f"{cfg.name}: an MoE model's aux must be > 0: {aux}")
    for k, v in want.items():
        if launches.get(k, 0) != v * steps or v == 0:
            fail(f"{cfg.name} {k}: {launches.get(k, 0)} launches in {steps} local "
                 f"steps, expected {v * steps}")
    if set(launches) != set(want):
        fail(f"{cfg.name}: unexpected kernels on the training path: {launches}")

    S = witness_seq or targs.seq
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (Kc, targs.batch, S)).astype(np.int32)
    step_batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    kern_rt = sfl.rt

    def step(s_, st_, rt):
        s_.rt = rt
        out, m = s_.local_step(st_, step_batch)
        torch.cuda.synchronize()
        return float(m["loss"]), [out.lora_client, out.lora_server]

    (lk, ak), (lp, ap) = step(sfl, state, kern_rt), step(sfl, state, TM.Runtime())
    sfl.rt = kern_rt
    e_ad = max((a_ - b_).abs().max().item() for a_, b_ in zip(tree_leaves(ak),
                                                             tree_leaves(ap)))
    ad_tol = targs.lr * 1e-2
    if witness_seq is None:
        good = abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)) and e_ad <= ad_tol
        print(f"[{tag}] local_step kernels vs plain path (Runtime()): loss {lk:.6f} vs "
              f"{lp:.6f} (tol 1e-4 rel), adapters max_abs_err={e_ad:.3g} (tol lr*1e-2 = "
              f"{ad_tol:.1g}) {'ok' if good else 'FAIL'}")
    else:
        to64 = lambda t: tree_map(lambda v: v.double() if v.is_floating_point() else v, t)
        sfl64 = SflLLM(cfg, to64(params), ell, sfl.tc, adamw(targs.lr), TM.Runtime(),
                       device="cuda")
        state64 = dataclasses.replace(state, **{
            f.name: to64(getattr(state, f.name)) for f in dataclasses.fields(state)})
        l64, a64 = step(sfl64, state64, TM.Runtime())
        del state64
        del sfl64
        torch.cuda.empty_cache()
        dist = lambda x: max((a_.double() - b_).abs().max().item()
                             for a_, b_ in zip(tree_leaves(x), tree_leaves(a64)))
        dk, dp = dist(ak), dist(ap)
        lk64, lp64 = abs(lk - l64), abs(lp - l64)
        good = (lk64 <= max(3 * lp64, 1e-6 * abs(l64)) and dk <= 3 * dp
                and abs(lk - lp) <= 1e-3 * abs(lp))
        print(f"[{tag}] local_step on {S} tokens, kernels vs plain path (Runtime()): loss "
              f"{lk:.6f} vs {lp:.6f}, adapters max_abs_err={e_ad:.3g} (phase 6's tolerances: "
              f"1e-4 rel, lr*1e-2 = {ad_tol:.1g}; a witness); against the plain path in f64 "
              f"(loss {l64:.8f}): loss distance kernels {lk64:.3g} plain {lp64:.3g}, adapters "
              f"kernels {dk:.3g} plain {dp:.3g} (kernels held at <= 3x plain, the loss also "
              f"within 1e-6 rel; kernels vs plain loss within 1e-3 rel) "
              f"{'ok' if good else 'FAIL'}")
    if not good:
        fail(f"{cfg.name}: a local step through the kernels disagrees with the plain path")
    return state, hist, sfl, launches


def lora_operands(randn, M, K, N, r=4):
    """x (M, K), w (K, N), a (r, K), b (N, r) from ``randn(*shape, std=)``."""
    return (randn(M, K), randn(K, N, std=K ** -0.5), randn(r, K, std=r ** -0.5),
            randn(N, r, std=0.02))


def check_lora_shape(torch, tag, randn, note, M, K, N, backward=False, r=4, scale=2.0):
    """The forward at (M, K, N), and with ``backward`` dX and the rank
    reduce at the same M, against their plain versions (f32 atol = rtol
    1e-4, the reduce's atol times sqrt(M)); ``note(op, err)`` keeps each
    op's largest error."""
    from repro_torch.kernels.lora_matmul import (lora_matmul_dx_kernel, lora_matmul_dx_ref,
                                                 lora_matmul_kernel, lora_matmul_ref,
                                                 lora_rank_reduce_kernel,
                                                 lora_rank_reduce_ref)
    x, w, a, b = lora_operands(randn, M, K, N, r)
    pairs = [("lora_matmul", lora_matmul_kernel(x, w, a, b, scale),
              lora_matmul_ref(x, w, a, b, scale))]
    if backward:
        dy, u = randn(M, N), randn(M, r)
        pairs += [("lora_matmul_dx", lora_matmul_dx_kernel(dy, w, a, b, scale),
                   lora_matmul_dx_ref(dy, w, a, b, scale)),
                  ("lora_rank_reduce", lora_rank_reduce_kernel(u, dy),
                   lora_rank_reduce_ref(u, dy))]
    torch.cuda.synchronize()
    for op, got, want in pairs:
        e = (got - want).abs().max().item()
        atol = 1e-4 * (M ** 0.5 if op == "lora_rank_reduce" else 1.0)
        ok = torch.allclose(got, want, atol=atol, rtol=1e-4)
        print(f"[{tag}] {op} f32 M={M} K={K} N={N} r={r}: max_abs_err={e:.3g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{op} at ({M}, {K}, {N}) disagrees with its plain version")
        note(op, e)


def phase_archs(torch, np, dev, reqs, flush):
    """Phase 15: the dense RoPE family and the MoE FFN at full width and full
    depth, from seed weights drawn on the card, rank-4 LoRA on q and v with
    B != 0, f32: (a) yi-9b through the paged engine, (b) olmoe-1b-7b through
    the paged and the slab engines and one SFL round, (c) minicpm-2b's SFL
    round (tied embeddings across the split), (d) deepseek-7b through the
    slab engine.  Each model is freed before the next is built.  Returns
    (the main paths' launch counts, the largest kernel-vs-plain error of
    each kernel at this phase's shapes)."""
    import torch.nn.functional as F

    from repro_torch import models as TM
    from repro_torch.configs import get_arch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import (flash_decode_kernel, flash_decode_ref,
                                                     paged_decode_kernel, paged_decode_ref)
    from repro_torch.kernels.lora_matmul import lora_matmul_kernel, lora_matmul_ref
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(15)
    runs, err = [], {}
    lengths = [8, 40, 77, 120, 160, 200, 232, 255]      # phase 4's serving-like spread
    scale = 8.0 / 4                                     # lora_alpha / rank

    def note(op, e):
        err[op] = max(err.get(op, 0.0), e)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    def check_lora(tag, M, K, N, backward=False, r=4):
        check_lora_shape(torch, tag, randn, note, M, K, N, backward, r, scale)

    def decode_inputs(KH, G, D, PS=16, MP=32):
        B, NP = len(lengths), len(lengths) * MP + 1
        q = randn(B, KH, G, D)
        kp, vp = randn(KH, NP, PS, D), randn(KH, NP, PS, D)
        pages = torch.randperm(NP - 1, generator=gen) + 1
        bt = torch.zeros(B, MP, dtype=torch.int32)
        for b_, n in enumerate(lengths):
            npg = -(-n // PS)
            bt[b_, :npg] = pages[b_ * MP:b_ * MP + npg].int()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return q, kp, vp, lens, bt.to(dev)

    def check_decode(tag, KH, G, D, paged=True, slab=True):
        """The decode kernels at the engines' shape, 8 slots x 512 positions,
        against their plain versions (f32 atol = rtol 1e-5)."""
        q, kp, vp, lens, bt = decode_inputs(KH, G, D)
        k, v = randn(8, 512, KH, D), randn(8, 512, KH, D)
        pairs = []
        if paged:
            pairs.append(("paged_decode", paged_decode_kernel(q, kp, vp, lens, bt),
                          paged_decode_ref(q, kp, vp, lens, bt)))
        if slab:
            pairs.append(("flash_decode", flash_decode_kernel(q, k, v, lens),
                          flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2), lens)))
        torch.cuda.synchronize()
        for op, got, want in pairs:
            e = (got - want).abs().max().item()
            ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
            print(f"[{tag}] {op} f32 8 slots x 512, KH={KH} G={G} D={D}: "
                  f"max_abs_err={e:.3g} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{op} at KH {KH}, G {G}, D {D} disagrees with its plain version")
            note(op, e)

    def build(tag, name, seed):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_arch(name)
        t0 = time.perf_counter()
        params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                torch.float32, "cuda")
        lora = TM.init_lora_stack(cfg, torch.Generator(device=dev).manual_seed(seed + 1),
                                  None, torch.float32, "cuda")
        g_b = torch.Generator(device=dev).manual_seed(seed + 2)
        for layer in lora:           # B != 0, or the rank path would be a no-op
            for ad in layer["mixer"].values():
                ad["b"].normal_(0, 0.02, generator=g_b)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in tree_leaves(params))
        if n_par != TM.num_params(cfg):
            fail(f"{name}: {n_par} parameters built, num_params says "
                 f"{TM.num_params(cfg)}")
        moe = (f", {cfg.num_experts} experts of {cfg.d_ff} top-{cfg.experts_per_token} "
               f"({TM.num_active_params(cfg)} active a token)" if cfg.num_experts
               else f", d_ff {cfg.d_ff}")
        print(f"[{tag}] {name} full width: {cfg.num_layers} layers d={cfg.d_model}, "
              f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of {cfg.head_dim}"
              f"{moe}, vocab {cfg.vocab_size}{', tied' if cfg.tie_embeddings else ''}, "
              f"f32: {n_par} parameters ({n_par * 4 / 1e9:.2f} GB) drawn on the card in "
              f"{time.perf_counter() - t0:.2f}s; LoRA r={cfg.lora_rank} on "
              f"{cfg.lora_targets} with B != 0")
        return cfg, params, lora

    def serve(tag, cfg, params, lora, paged):
        """Phase 5's 16 requests through one engine; the launch counters,
        reset just before, must equal what the engine's steps imply."""
        L = cfg.num_layers
        eng = ServingEngine(cfg, params, lora=lora, max_slots=8, max_len=512, page_size=16,
                            paged=paged, device="cuda")
        if eng.paged != paged:
            fail(f"{cfg.name}: ServingEngine(paged={paged}) built the other engine")
        eng.submit(Request(uid=1000, prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
        eng.run()                            # first-call set-up, not measured
        eng.reset_stats()
        sreqs = [Request(uid=r_.uid, prompt=list(r_.prompt), max_new_tokens=32)
                 for r_ in reqs]
        for r_ in sreqs:
            eng.submit(r_)
        backend.reset_launch_counts()        # just before the main path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(backend.LAUNCH_COUNTS)
        st = eng.stats
        n_tok = sum(len(r_.output) for r_ in sreqs)
        pre = st["prefill_chunks"] if paged else st["prefills"]
        what = "prefill chunks" if paged else "prefills"
        print(f"[{tag}] {cfg.name} {'paged' if paged else 'slab'} engine, 8 slots x 512 "
              f"positions: phase 5's {len(sreqs)} requests, {n_tok} tokens in {wall:.3f}s = "
              f"{n_tok / wall:.1f} tok/s; {st['decode_steps']} decode steps, mean "
              f"{st['decode_s'] / max(st['decode_steps'], 1) * 1e3:.2f} ms/step; {pre} "
              f"{what}, {st['prefill_s'] / max(pre, 1) * 1e3:.2f} ms each (host clock); "
              f"peak device memory {peak_gib(torch):.2f} GiB")
        print(f"[{tag}] launches during the run: {launches}")
        print(f"[{tag}] token ids digest of the {len(sreqs)} requests: {ids_digest(sreqs)}")
        if not all(r_.done and len(r_.output) == 32 for r_ in sreqs):
            fail(f"{cfg.name}: not every request finished with 32 tokens")
        attn = "paged_decode" if paged else "flash_decode"
        want = {"lora_matmul": 2 * L * (st["decode_steps"] + pre),
                attn: L * st["decode_steps"]}
        if launches != want:
            fail(f"{cfg.name} {'paged' if paged else 'slab'} engine launched {launches}, "
                 f"expected exactly {want}")
        if paged and (not eng.check_consistency(resync=False) or eng.pages_in_use() != 0):
            fail(f"{cfg.name}: page accounting inconsistent after drain")
        runs.append(launches)
        return eng

    def decode_check(tag, cfg, eng, paged):
        """One decode step, kernel path vs plain path (``Runtime()``), on
        one random state: logits within 1e-3 of the plain logits' largest
        entry, and each layer's cache within 1e-4 of the largest K or V
        entry the plain step wrote there (each at least 1), since random
        weights at full depth grow the residual stream and with it the deep
        layers' K and V."""
        B, L, KH, D = 8, 512, cfg.num_kv_heads, cfg.head_dim
        g_kv = torch.Generator(device=dev).manual_seed(3)
        pos = torch.tensor(lengths, dtype=torch.int32)
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen).to(dev)
        if paged:
            caches = TM.init_paged_cache(cfg, B * 32 + 1, 16, torch.float32, "cuda")
            bt = torch.zeros(B, 32, dtype=torch.int32)
            pages = torch.randperm(B * 32, generator=gen) + 1
            for b_, n in enumerate(lengths):
                bt[b_, :n // 16 + 1] = pages[b_ * 32:b_ * 32 + n // 16 + 1].int()
        else:
            caches = TM.init_cache(cfg, B, L, torch.float32, "cuda")
        for c in caches:
            c["k"].normal_(generator=g_kv)
            c["v"].normal_(generator=g_kv)
            if not paged:
                c["pos"].copy_(torch.where(torch.arange(L)[None] < pos[:, None],
                                           torch.arange(L, dtype=torch.int32)[None], -1))
        outs = []
        for rt in (TM.default_serve_runtime(), TM.Runtime()):
            cc = [{k: v.clone() for k, v in c.items()} for c in caches]
            if paged:
                logits, cc = TM.paged_decode_step(cfg, eng.params, tok, cc, bt.to(dev),
                                                  pos.to(dev), lora=eng.lora, rt=rt)
            else:
                logits, cc = TM.decode_step(cfg, eng.params, tok, cc, pos.to(dev),
                                            lora=eng.lora, rt=rt)
            torch.cuda.synchronize()
            outs.append((logits, cc))
        del caches
        (lk, ck), (lp, cp) = outs
        top = lp.abs().max().item()
        e_log = (lk - lp).abs().max().item()
        rows = torch.arange(B)
        if paged:                        # (KH, B, D): each slot's page and offset
            at = lambda t: t[:, bt[rows, pos // 16].long().to(dev), (pos % 16).long().to(dev)]
        else:                            # (B, KH, D) at each slot's position
            at = lambda t: t[rows.to(dev), pos.long().to(dev)]
        kv_top = [max(at(b[n]).abs().max().item() for n in "kv") for b in cp]
        e_kv = [max((a[n] - b[n]).abs().max().item() for n in "kv") / max(1.0, t_)
                for a, b, t_ in zip(ck, cp, kv_top)]
        good = (tuple(lk.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(lk).all())
                and e_log <= 1e-3 * max(1.0, top) and max(e_kv) <= 1e-4)
        print(f"[{tag}] {'paged_decode_step' if paged else 'decode_step'} logits kernel vs "
              f"plain path: max_abs_err={e_log:.3g} of largest |logit| {top:.3g} (tol "
              f"1e-3 x max(1, that)); caches: worst layer's max_abs_err over the largest "
              f"entry the step wrote there {max(e_kv):.3g} (tol 1e-4; written |K|, |V| "
              f"up to {max(kv_top):.3g}) "
              f"{'ok' if good else 'FAIL'}")
        if not good:
            fail(f"{cfg.name}: a decode step through the kernels disagrees with the plain path")

    def time_rows(tag):
        """yi-9b's q and v projections at decode M 8, and its paged decode
        (G 8, D 128) at phase 4's lengths: kernel, plain version, one library
        call and the bound, as phase 4 times GPT-2-S's."""
        for N in (4096, 512):
            M, K, r = 8, 4096, 4
            x, w = randn(M, K), randn(K, N, std=K ** -0.5)
            a, b = randn(r, K, std=r ** -0.5), randn(N, r, std=0.02)
            ms = time_ms(torch, lambda: lora_matmul_kernel(x, w, a, b, scale), flush)
            plain = time_ms(torch, lambda: lora_matmul_ref(x, w, a, b, scale), flush)
            lib = time_ms(torch, lambda: x @ w + scale * ((x @ a.T) @ b.T), flush)
            nbytes = 4 * (M * K + K * N + r * K + N * r + M * N)
            bms, bby = bound(nbytes, lora_flops(M, K, N, r))
            print(f"[time] {tag} lora_matmul f32 M={M} K={K} N={N} r={r}: kernel "
                  f"{ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(torch.matmul) "
                  f"{lib * 1e3:.2f}us bound {bms * 1e3:.2f}us ({bby}, {nbytes} B)")
        KH, G, D, PS, MP = 4, 8, 128, 16, 32
        B, L = len(lengths), PS * MP
        q, kp, vp, lens, bt = decode_inputs(KH, G, D, PS, MP)
        ms = time_ms(torch, lambda: paged_decode_kernel(q, kp, vp, lens, bt), flush)
        plain = time_ms(torch, lambda: paged_decode_ref(q, kp, vp, lens, bt), flush)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]

        def library():            # the G query heads of a KV head as its query rows
            k = kp[:, bt.long()].permute(1, 0, 2, 3, 4).reshape(B, KH, L, D)
            v = vp[:, bt.long()].permute(1, 0, 2, 3, 4).reshape(B, KH, L, D)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        lib = time_ms(torch, library, flush)
        tot = sum(lengths)
        nbytes = (4 * (2 * B * KH * G * D + 2 * KH * tot * D) + 4 * B
                  + 4 * sum(math.ceil(n / PS) for n in lengths))
        bms, bby = bound(nbytes, 4 * KH * G * D * tot)
        print(f"[time] {tag} paged_decode f32 B={B} KH={KH} G={G} D={D} PS={PS} "
              f"lengths={lengths}: kernel {ms * 1e3:.2f}us plain {plain * 1e3:.2f}us "
              f"library(gather+sdpa) {lib * 1e3:.2f}us bound {bms * 1e3:.2f}us ({bby}, "
              f"{nbytes} B)")

    # (a) yi-9b: GQA 32 heads over 4 KV heads of 128 (G 8), the paged engine
    t_model = time.perf_counter()
    cfg, params, lora = build("yi", "yi-9b", 150)
    for M in (8, 16):
        for N in (4096, 512):
            check_lora("yi", M, 4096, N)
    check_decode("yi", 4, 8, 128, slab=False)
    time_rows("yi-9b")
    eng = serve("yi", cfg, params, lora, paged=True)
    decode_check("yi", cfg, eng, paged=True)
    del eng, params, lora
    print(f"[yi] wall {time.perf_counter() - t_model:.1f}s (host clock)")

    # (b) olmoe-1b-7b: 64 experts of 1024, top-8; both engines (each held
    # against its own plain path: routing capacity depends on the group, so
    # the two engines need not agree) and one SFL round at split 8 of 16
    t_model = time.perf_counter()
    cfg, params, lora = build("olmoe", "olmoe-1b-7b", 151)
    for M in (8, 16):
        check_lora("olmoe", M, 2048, 2048)
    for M in (256, 768):
        check_lora("olmoe", M, 2048, 2048, backward=True)
    check_decode("olmoe", 16, 1, 128)
    for paged in (True, False):
        eng = serve("olmoe", cfg, params, lora, paged=paged)
        decode_check("olmoe", cfg, eng, paged=paged)
        del eng
    runs.append(sfl_round(torch, np, "olmoe", cfg, params, lora, split=8,
                          per_step=attention_per_step)[3])
    del params, lora
    print(f"[olmoe] wall {time.perf_counter() - t_model:.1f}s (host clock)")

    # (c) minicpm-2b: 36 heads of 64, tied vocabulary of 122753 (the client
    # embeds and the server un-embeds with the same table), SFL at split 20
    t_model = time.perf_counter()
    cfg, params, lora = build("minicpm", "minicpm-2b", 152)
    for M in (256, 768):
        check_lora("minicpm", M, 2304, 2304, backward=True)
    runs.append(sfl_round(torch, np, "minicpm", cfg, params, lora, split=20,
                          per_step=attention_per_step)[3])
    del params, lora
    print(f"[minicpm] wall {time.perf_counter() - t_model:.1f}s (host clock)")

    # (d) deepseek-7b: 32 KV heads of 128, the slab engine
    t_model = time.perf_counter()
    cfg, params, lora = build("deepseek", "deepseek-7b", 153)
    for M in (8, 200):
        check_lora("deepseek", M, 4096, 4096)
    check_decode("deepseek", 32, 1, 128, paged=False)
    eng = serve("deepseek", cfg, params, lora, paged=False)
    decode_check("deepseek", cfg, eng, paged=False)
    del eng, params, lora
    torch.cuda.empty_cache()
    print(f"[deepseek] wall {time.perf_counter() - t_model:.1f}s (host clock)")
    print(f"[archs] phase 15 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    launches = {k: sum(r_.get(k, 0) for r_ in runs) for k in set().union(*runs)}
    return launches, err


def ssd_bwd_inputs(torch, dev, B, nh, S, hd, N, Q, seed):
    """The SSD scan's operands at Mamba2's decays: A = -linspace(1, 16, nh)
    (A_log's init), dt = softplus(N(0, 1)) (dt_bias 0), xdt = x dt, g = A
    dt; B, C ~ N(0, 1/N); a random dy and a nonzero dh_last; S tokens
    padded with zeros to a multiple of Q, as the op pads.  Returns (the
    kernel layout's xdt, g, Bm, Cm, dy; dh_last; the model layout's xh,
    Bm, Cm, dt, A), on ``dev``."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(seed)
    dt = F.softplus(torch.randn(B, S, nh, generator=gen))
    A = -torch.linspace(1.0, 16.0, nh)
    xh = torch.randn(B, S, nh, hd, generator=gen)
    Bm = torch.randn(B, S, N, generator=gen) * N ** -0.5
    Cm = torch.randn(B, S, N, generator=gen) * N ** -0.5
    dy = torch.randn(B, nh, S, hd, generator=gen)
    dh = torch.randn(B, nh, hd, N, generator=gen)
    pad = (-S) % Q
    kern = (F.pad((xh * dt[..., None]).permute(0, 2, 1, 3), (0, 0, 0, pad)),
            F.pad((dt * A).permute(0, 2, 1), (0, pad)), F.pad(Bm, (0, 0, 0, pad)),
            F.pad(Cm, (0, 0, 0, pad)), F.pad(dy, (0, 0, 0, pad)))
    model = (xh, Bm, Cm, dt, A)
    return ([t.contiguous().to(dev) for t in kern], dh.to(dev),
            [t.to(dev) for t in model])


def kernel_label(name: str) -> str:
    """A traced kernel's name without its return type, namespace and
    parameters: ``void (anonymous namespace)::bwd_pairs<4>(ChunkArgs)`` ->
    ``bwd_pairs<4>``."""
    import re
    return re.sub(r"^void |\(anonymous namespace\)::", "", name).split("(")[0]


def device_time_by_kernel(torch, fn, reps=10):
    """Device time of one call of ``fn`` by kernel name, in us, under
    torch.profiler (CUPTI): {name: (launches a call, us a call)}, after
    one warm-up call.  Empty where no device events were traced."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    return {k: (n / reps, t / reps) for k, (n, t) in by_name.items()}


def ssd_bwd_work(B, nh, S, hd, N, Q):
    """(bytes, flops) of the backward: each input (xdt, g, B, C, dy,
    dh_last) read once and each output (dxdt, dg, dB, dC) written once;
    the work this run needs by the kernel op's FLOP formula
    (``ssd_scan.ops.scan_bwd_flops``)."""
    from repro_torch.kernels.ssd_scan.ops import scan_bwd_flops
    flops = scan_bwd_flops(B, nh, S, hd, N, Q)
    nbytes = 4 * (3 * B * nh * S * hd + 2 * B * nh * S + 4 * B * S * N + B * nh * hd * N)
    return nbytes, flops


def ssd_bwd_times(torch, dev, flush):
    """Phase 16 (b): times of ``ssd_scan_bwd_kernel`` at the training
    shapes (a client's 2 x 320 tokens padded to 512, the server's pooled 6
    x 320) and S 512 at B 1; the plain version, autograd's backward through
    ssd_chunked (model layout, its graph built once; no single PyTorch call
    computes the gradient) and the bounds (3xTF32, f32 FFMA beside, from
    ``ssd_bwd_work``); at a client's shape also the device
    time of each pass.  Imports the kernel from whichever ``repro_torch``
    comes first on sys.path, so that one call can time a parent commit's
    kernel with this function.  Returns the JSON line's row."""
    from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan_bwd_kernel,
                                              ssd_scan_bwd_ref)
    rows = {}
    for B, S_tok in ((2, 320), (6, 320), (1, 512)):
        nh, S, hd, N, Q = 80, 512, 64, 128, 256
        kern, dh, model = ssd_bwd_inputs(torch, dev, B, nh, S_tok, hd, N, Q, seed=B)
        ms = time_ms(torch, lambda: ssd_scan_bwd_kernel(*kern, dh, chunk=Q), flush)
        plain = time_ms(torch, lambda: ssd_scan_bwd_ref(*kern, dh, chunk=Q), flush, iters=20)
        leaves = [t.clone().requires_grad_() for t in model]
        y, h = ssd_chunked(*leaves, chunk=Q)
        Sm = model[0].shape[1]
        loss = (y * kern[4][:, :, :Sm].permute(0, 2, 1, 3)).sum() + (h * dh).sum()
        auto = time_ms(torch, lambda: torch.autograd.grad(loss, leaves, retain_graph=True),
                       flush, iters=20)
        nbytes, flops = ssd_bwd_work(B, nh, S, hd, N, Q)
        bms, bby = bound_tf32(nbytes, flops, 3)
        fms, fby = bound(nbytes, flops)
        print(f"[time] ssd_scan_bwd f32 B={B} S={Sm} (padded to {S}) nh={nh} hd={hd} N={N} "
              f"chunk={Q}: kernel {ms * 1e3:.2f}us plain ssd_scan_bwd_ref {plain * 1e3:.2f}us "
              f"autograd backward through ssd_chunked {auto * 1e3:.2f}us library none; bound "
              f"{bms * 1e3:.2f}us (3xTF32, {bby}; f32 FFMA {fms * 1e3:.2f}us, {fby}; {flops} "
              f"flop, {nbytes} B); {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        if B == 2:                   # the JSON line's row: a client's shape
            rows[("ssd_scan_bwd", S)] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                             bound_ms=bms, bound_by=bby)
            # where the kernel's time goes: device time of each of its
            # passes under torch.profiler
            passes = device_time_by_kernel(
                torch, lambda: ssd_scan_bwd_kernel(*kern, dh, chunk=Q))
            tot = sum(t for _, t in passes.values())
            print(f"[time] ssd_scan_bwd passes at B={B} S={Sm} (torch.profiler, device time "
                  f"a call, {sum(n for n, _ in passes.values()):g} launches): "
                  + "; ".join(f"{kernel_label(k)} {t:.2f}us ({100 * t / tot:.1f}%)"
                              for k, (_, t) in sorted(passes.items(), key=lambda kv: -kv[1][1]))
                  + f"; total {tot:.2f}us")
        del kern, dh, model, leaves, y, h, loss
    torch.cuda.empty_cache()
    return rows


def phase_mamba_train(torch, np, dev, flush):
    """Phase 16: Mamba2 training on the card.  (a) the scan's backward
    kernel against its plain version and against autograd through the
    chunked algorithm in f64; (b) its times; (c) one SFL round of
    full-width, full-depth Mamba2-2.7B; (d) one local step from the trained
    state through the kernels and through the plain path, held against the
    plain path in f64; (e) reduced Jamba: one SFL round and one local step.
    Returns (the main paths' launch counts, the largest kernel-vs-plain
    error of the backward kernel, its time row at the training shape)."""
    import hashlib

    import torch.nn.functional as F

    from repro_torch import models as TM
    from repro_torch.configs import get_arch
    from repro_torch.kernels import backend
    from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan_bwd_kernel,
                                              ssd_scan_bwd_ref, ssd_scan_ref)
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    err, rows, runs = {"ssd_scan_bwd": 0.0}, {}, []

    def autograd_grads(kern, dh, Q, dtype):
        """dxdt, dg, dBm, dCm by autograd through the chunked algorithm
        (``ssd_scan_ref``: ``ssd_chunked``'s, in the kernel layout)."""
        leaves = [t.to(dtype).clone().requires_grad_() for t in kern[:4]]
        y, h = ssd_scan_ref(*leaves, chunk=Q)
        loss = (y * kern[4].to(dtype)).sum() + (h * dh.to(dtype)).sum()
        return torch.autograd.grad(loss, leaves)


    # (a) the op at row 12's shapes, Jamba's full-width heads and the reduced
    # shape: the four cotangents against the plain version (1e-4 of its
    # largest entry: f32 sums in another order) and against the f64 witness,
    # no further from it than 3x autograd through the chunked algorithm in f32
    for B, nh, S, hd, N, Q, what in ((1, 80, 200, 64, 128, 256, "Mamba2-2.7B S 200"),
                                     (1, 80, 512, 64, 128, 256, "Mamba2-2.7B S 512"),
                                     (2, 8, 512, 128, 64, 256, "Jamba's heads"),
                                     (2, 4, 40, 32, 16, 32, "reduced"),
                                     (1, 4, 256, 192, 64, 256, "a head dim of 192")):
        kern, dh, _ = ssd_bwd_inputs(torch, dev, B, nh, S, hd, N, Q, seed=S + nh)
        backend.reset_launch_counts()
        got = ssd_scan_bwd_kernel(*kern, dh, chunk=Q)
        again = ssd_scan_bwd_kernel(*kern, dh, chunk=Q)
        torch.cuda.synchronize()
        # one launch a slice of at most 128 head dims
        one = dict(backend.LAUNCH_COUNTS) == {"ssd_scan_bwd": 2 * -(-hd // 128)}
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        plain = ssd_scan_bwd_ref(*kern, dh, chunk=Q)
        w64 = autograd_grads(kern, dh, Q, torch.float64)
        a32 = autograd_grads(kern, dh, Q, torch.float32)
        torch.cuda.synchronize()
        parts, good = [], one and same
        for name, k_, p_, w_, a_ in zip(("dxdt", "dg", "dBm", "dCm"), got, plain, w64, a32):
            top = p_.abs().max().item()
            e = (k_ - p_).abs().max().item()
            dk = (k_.double() - w_).abs().max().item() / w_.abs().max().item()
            da = (a_.double() - w_).abs().max().item() / w_.abs().max().item()
            ok = bool(torch.isfinite(k_).all()) and e <= 1e-4 * max(1.0, top) and dk <= 3 * da
            good = good and ok
            err["ssd_scan_bwd"] = max(err["ssd_scan_bwd"], e)
            parts.append(f"{name} max_abs_err={e:.3g} (tol 1e-4 x max(1, {top:.3g})), from "
                         f"f64 kernel {dk:.3g} autograd f32 {da:.3g}")
        print(f"[train16] ssd_scan_bwd f32 B={B} S={S} nh={nh} hd={hd} N={N} chunk={Q} "
              f"({what}; model decays, dh_last != 0): " + "; ".join(parts)
              + f" (kernel <= 3x autograd's distance from f64); one launch a slice {one}, two runs "
              f"bit-equal {same} {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"ssd_scan_bwd disagrees at {what}")
        del kern, dh, got, again, plain, w64, a32

    # (b) times
    rows.update(ssd_bwd_times(torch, dev, flush))

    # (c) full-width, full-depth Mamba2-2.7B: one SFL round through
    # launch.train.run, 3 clients x 2 x 320 tokens (chunks of 256: every
    # step runs a padded second chunk), I = 6, split 32, rank-4 LoRA on
    # ssm_in/ssm_out with B != 0, weights drawn on the card; (d) its local
    # step held against the plain path in f64 on 64 tokens, since the plain
    # path's autograd at 320 tokens (its Q x Q chunk tensors per layer and
    # client) does not fit the card beside the model, and a random 64-layer
    # Mamba2 amplifies f32 rounding over depth (phase 12)
    t_model = time.perf_counter()
    cfg = get_arch("mamba2-2.7b")
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(160),
                            torch.float32, "cuda")
    lora = TM.init_lora_stack(cfg, torch.Generator(device=dev).manual_seed(161), 4,
                              torch.float32, "cuda")
    g_b = torch.Generator(device=dev).manual_seed(162)
    for layer in lora:           # B != 0, or the rank path would be a no-op
        for ad in layer["mixer"].values():
            ad["b"].normal_(0, 0.02, generator=g_b)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_leaves(params))
    print(f"[train16] Mamba2-2.7B full width: {cfg.num_layers} layers d={cfg.d_model}, "
          f"{cfg.ssm_num_heads} SSD heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, f32: {n_par} parameters ({n_par * 4 / 1e9:.2f} GB) drawn on the "
          f"card; LoRA r=4 on {cfg.lora_targets} with B != 0")
    torch.cuda.reset_peak_memory_stats()
    state, hist, sfl, launches = sfl_round(
        torch, np, "train16", cfg, params, lora, split=32, per_step=mamba_per_step,
        batch=2, seq=320, witness_seq=64)
    runs.append(launches)
    ad = b"".join(t.detach().cpu().numpy().tobytes()
                  for t in tree_leaves([state.lora_client, state.lora_server]))
    print(f"[train16] Mamba2-2.7B adapters digest after the round: "
          f"{hashlib.sha256(ad).hexdigest()[:16]}; wall {time.perf_counter() - t_model:.1f}s "
          f"(host clock)")
    # where a local step's time goes: one more step from the trained state
    # at the round's shape, its output dropped, under torch.profiler (device
    # busy share over the step's wall, device time by kernel), after a
    # warm-up step and outside the round's clock
    from repro_torch.launch.serve import _report
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 2, 320)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    torch.cuda.reset_peak_memory_stats()
    sfl.local_step(state, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sfl.local_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"[train16] one local step of the round's shape under torch.profiler: "
          f"{wall * 1e3:.1f} ms (host clock, profiler on)")
    _report(prof, wall, top=14)
    from torch.autograd import DeviceType
    kern_us = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    bwd_us = sum(t for n_, t in kern_us
                 if any(p in n_ for p in ("bwd_prep", "bwd_pairs", "bwd_rows", "bwd_finish")))
    all_us = sum(t for _, t in kern_us) or 1.0
    print(f"[train16] ssd_scan_bwd's passes in the profiled step: {bwd_us / 1e3:.2f} ms of "
          f"{all_us / 1e3:.2f} ms of kernel time ({100 * bwd_us / all_us:.1f}%), "
          f"{100 * bwd_us * 1e-6 / wall:.1f}% of the step's {wall * 1e3:.1f} ms wall; peak "
          f"device memory of this step and its warm-up {peak_gib(torch):.2f} GiB")
    del state, hist, sfl, params, lora
    torch.cuda.empty_cache()

    # (e) reduced Jamba (two periods of one attention and seven mamba layers,
    # MoE on the odd layers, d 256, 16 SSD heads of 32, state 16, chunk 32):
    # one SFL round on 64 tokens (two chunks) at split 8 and one local step,
    # kernels vs plain path at phase 6's tolerance
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state, hist, sfl, launches = sfl_round(
        torch, np, "jamba", get_arch("jamba-1.5-large-398b"), None, None, split=8,
        per_step=jamba_per_step, reduced=True)
    runs.append(launches)
    print(f"[jamba] {sfl.cfg.num_layers} layers ({[p.mixer + '/' + p.mlp for p in sfl.cfg.pattern]}"
          f" a period) d={sfl.cfg.d_model}; wall {time.perf_counter() - t_model:.1f}s (host clock)")
    del state, hist, sfl
    torch.cuda.empty_cache()
    print(f"[train16] phase 16 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    launches = {k: sum(r_.get(k, 0) for r_ in runs) for k in set().union(*runs)}
    return launches, err, rows


def phase_frontends(torch, np, dev, flush):
    """Phase 17: the modality front ends at full width and depth, each model
    taking a prefix of precomputed embeddings ``frontend_emb`` (B, F, d) =
    0.1 N(0, 1) from a seeded generator: (a) InternVL2-2B (F 256) and (b)
    MusicGen-Large (F 64, learned positions from F on), f32 weights drawn
    on the card, rank-4 LoRA on q and v with B != 0, each model freed before
    the next.  For each: ``lora_matmul`` (decode M, a client's and the
    server's training M, with dX and the rank reduce) and ``flash_decode``
    (``generate``'s slab caches) against their plain versions at its shapes;
    ``generate`` (4 prompts of 48 tokens after the prefix, 32 new, greedy,
    fused LoRA and the flash decode) with exact launch counts; one decode
    step from its prefill's caches against the plain path; the prefix moves
    the last text logit; both engines refuse the arch; one SFL round
    through ``Trainer.fit`` (3 clients x 4 x 64 text tokens of the
    synthetic E2E corpus, each with its prefix, I = 6, AdamW 4e-4) with
    ``attention_per_step`` launches a step, then one local step against
    the plain path, and once more under ``torch.profiler``.  (c) The
    kernels' times at the new shapes.  Returns
    (the main paths' launch counts, the largest kernel-vs-plain error of
    each kernel at this phase's shapes)."""
    import hashlib

    import torch.nn.functional as F

    from repro_torch import models as TM
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import SflLLM
    from repro_torch.data import WordTokenizer, e2e_splits, iid_partition, sfl_batches
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_decode_kernel, flash_decode_ref
    from repro_torch.kernels.lora_matmul import lora_matmul_kernel, lora_matmul_ref
    from repro_torch.launch.engine import SflRound, Trainer
    from repro_torch.models.generate import SampleConfig
    from repro_torch.optim import adamw
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(17)
    runs, err = [], {}
    scale = 8.0 / 4                                     # lora_alpha / rank
    NB, PROMPT, NEW = 4, 48, 32                         # generate's batch and lengths
    KC, BC, SC, IC, LR = 3, 4, 64, 6, 4e-4              # the SFL round's shape

    def note(op, e):
        err[op] = max(err.get(op, 0.0), e)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    def prefix(rng, cfg, *lead):
        return (0.1 * rng.standard_normal(lead + (cfg.frontend_tokens, cfg.d_model))
                ).astype(np.float32)

    def check_lora(tag, M, K, N, backward=False):
        check_lora_shape(torch, tag, randn, note, M, K, N, backward, 4, scale)

    def decode_operands(KH, G, D, L, lengths):
        B = len(lengths)
        return (randn(B, KH, G, D), randn(B, L, KH, D), randn(B, L, KH, D),
                torch.tensor(lengths, dtype=torch.int32, device=dev))

    def check_decode(tag, KH, G, D, L, lengths):
        q, k, v, lens = decode_operands(KH, G, D, L, lengths)
        got = flash_decode_kernel(q, k, v, lens)
        want = flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2), lens)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
        print(f"[{tag}] flash_decode f32 {len(lengths)} slots x {L}, KH={KH} G={G} D={D}, "
              f"lengths {lengths}: max_abs_err={e:.3g} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_decode at KH {KH}, G {G}, D {D} disagrees with its plain version")
        note("flash_decode", e)

    # (c) times at the new shapes: row 1 at InternVL2's client training M
    # (4 x (256 + 64) = 1280 rows) and at generate's decode M 4, q (N 2048)
    # and InternVL2's v (N 1024) at K 2048; row 6 at generate's last decode
    # step (4 slots at F + 48 + 31 of F + 48 + 32): InternVL2's 8 KV heads of
    # 128 (G 2) and MusicGen's 32 of 64 (G 1)
    for M, N in ((1280, 2048), (1280, 1024), (4, 2048), (4, 1024)):
        K, r = 2048, 4
        x, w, a, b = lora_operands(randn, M, K, N, r)
        ms = time_ms(torch, lambda: lora_matmul_kernel(x, w, a, b, scale), flush)
        plain = time_ms(torch, lambda: lora_matmul_ref(x, w, a, b, scale), flush)
        lib = time_ms(torch, lambda: x @ w + scale * ((x @ a.T) @ b.T), flush)
        nbytes = 4 * (M * K + K * N + r * K + N * r + M * N)
        flops = lora_flops(M, K, N, r)
        ffma, fby = bound(nbytes, flops)
        if M > 16:
            bms, bby = bound_tf32(nbytes, flops, 3)
            what = f"3xTF32, {bby}; f32 FFMA {ffma * 1e3:.2f}us"
        else:
            bms, what = ffma, fby
        print(f"[time] frontends lora_matmul f32 M={M} K={K} N={N} r={r}: kernel "
              f"{ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(torch.matmul x3) "
              f"{lib * 1e3:.2f}us bound {bms * 1e3:.2f}us ({what}; {nbytes} B, {flops} FLOP)")
    for tag, KH, G, D, L in (("internvl2-2b", 8, 2, 128, 336), ("musicgen-large", 32, 1, 64, 144)):
        lengths = [L - 1] * NB
        q, k, v, lens = decode_operands(KH, G, D, L, lengths)
        ms = time_ms(torch, lambda: flash_decode_kernel(q, k, v, lens), flush)
        plain = time_ms(torch, lambda: flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                                        lens), flush)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)       # the slab view (B, KH, L, D)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kt, vt, attn_mask=mask),
                      flush)
        tot = sum(lengths)
        nbytes = 4 * (2 * NB * KH * G * D + 2 * KH * tot * D) + 4 * NB
        bms, bby = bound(nbytes, 4 * KH * G * D * tot)
        print(f"[time] {tag} flash_decode f32 B={NB} KH={KH} G={G} D={D} L={L} lengths="
              f"{lengths}: kernel {ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library(masked "
              f"sdpa) {lib * 1e3:.2f}us bound {bms * 1e3:.2f}us ({bby}, {nbytes} B)")
    del q, k, v, lens, kt, vt, mask, x, w, a, b

    def build(tag, name, seed):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_arch(name)
        t0 = time.perf_counter()
        params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                torch.float32, "cuda")
        lora = TM.init_lora_stack(cfg, torch.Generator(device=dev).manual_seed(seed + 1),
                                  None, torch.float32, "cuda")
        g_b = torch.Generator(device=dev).manual_seed(seed + 2)
        for layer in lora:           # B != 0, or the rank path would be a no-op
            for ad in layer["mixer"].values():
                ad["b"].normal_(0, 0.02, generator=g_b)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in tree_leaves(params))
        if n_par != TM.num_params(cfg):
            fail(f"{name}: {n_par} parameters built, num_params says {TM.num_params(cfg)}")
        pos = (f", learned positions over {cfg.max_seq_len} "
               f"({cfg.max_seq_len * cfg.d_model * 4 / 1e9:.2f} GB)"
               if cfg.pos_emb == "learned" else "")
        print(f"[{tag}] {name} full width: {cfg.num_layers} layers d={cfg.d_model}, "
              f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of {cfg.head_dim}, "
              f"{cfg.mlp_kind} {cfg.d_ff}, {cfg.norm}, vocab {cfg.vocab_size}{pos}; "
              f"{cfg.frontend} prefix of F={cfg.frontend_tokens}; f32: {n_par} parameters "
              f"({n_par * 4 / 1e9:.2f} GB) drawn on the card in "
              f"{time.perf_counter() - t0:.2f}s; LoRA r={cfg.lora_rank} on {cfg.lora_targets} "
              f"with B != 0")
        return cfg, params, lora

    def serve(tag, cfg, params, lora):
        """generate() with the prefix through the kernels (exact launch
        counts), against the plain path's ids (printed); one decode step
        from the prefill's caches against the plain path; the prefix's
        effect on the last text logit; the engines' refusal."""
        L, F_ = cfg.num_layers, cfg.frontend_tokens
        rng = np.random.default_rng(170)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (NB, PROMPT))
                                  .astype(np.int32)).to(dev)
        fe = torch.from_numpy(prefix(rng, cfg, NB)).to(dev)
        rt = TM.Runtime(dense_impl="fused", decode_attn_impl="flash")
        sc = SampleConfig(greedy=True)
        TM.generate(cfg, params, tokens[:, :8], lora=lora, rt=rt, max_new_tokens=2, sc=sc,
                    frontend_emb=fe)                 # first-call set-up, not measured
        backend.reset_launch_counts()                # just before the main path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, _ = TM.generate(cfg, params, tokens, lora=lora, rt=rt, max_new_tokens=NEW,
                             sc=sc, frontend_emb=fe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(backend.LAUNCH_COUNTS)
        want = {"lora_matmul": 2 * L * NEW, "flash_decode": L * (NEW - 1)}
        plain_ids, _ = TM.generate(cfg, params, tokens, lora=lora, rt=TM.Runtime(),
                                   max_new_tokens=NEW, sc=sc, frontend_emb=fe)
        same = int((ids == plain_ids).all(dim=1).sum())
        digest = hashlib.sha256(ids.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"[{tag}] generate(frontend_emb (4, {F_}, {cfg.d_model})): {NB} prompts of "
              f"{PROMPT} tokens after the prefix, {NEW} new, greedy, slab caches of "
              f"{F_ + PROMPT + NEW}: {NB * NEW / wall:.1f} tok/s, {wall * 1e3:.1f} ms (host "
              f"clock); peak device memory {peak_gib(torch):.2f} GiB")
        print(f"[{tag}] launches during generate: {launches}; expected {want}")
        print(f"[{tag}] token ids digest: {digest}; rows equal to the plain path's "
              f"(Runtime()): {same} of {NB} (printed, not required: a near tie may flip)")
        if tuple(ids.shape) != (NB, NEW) or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab_size:
            fail(f"{cfg.name}: generate gave ids of shape {tuple(ids.shape)} outside the vocab")
        if launches != want:
            fail(f"{cfg.name}: generate launched {launches}, expected exactly {want}")
        runs.append(launches)

        # one decode step from the prefill's caches (F + 48 positions live),
        # kernel path vs plain path, at phase 15's tolerances
        logits0, caches = TM.prefill(cfg, params, tokens, lora=lora, rt=rt, frontend_emb=fe,
                                     cache_len=F_ + PROMPT + NEW)
        tok = logits0.argmax(-1).to(torch.int32)[:, None]
        cur = F_ + PROMPT
        outs = []
        for r_ in (rt, TM.Runtime()):
            cc = [{k: v.clone() for k, v in c.items()} for c in caches]
            logits, cc = TM.decode_step(cfg, params, tok, cc, cur, lora=lora, rt=r_)
            torch.cuda.synchronize()
            outs.append((logits, cc))
        (lk, ck), (lp, cp) = outs
        top = lp.abs().max().item()
        e_log = (lk - lp).abs().max().item()
        kv_top = [max(b[n][:, cur].abs().max().item() for n in "kv") for b in cp]
        e_kv = [max((a[n] - b[n]).abs().max().item() for n in "kv") / max(1.0, t_)
                for a, b, t_ in zip(ck, cp, kv_top)]
        good = (tuple(lk.shape) == (NB, cfg.vocab_size) and bool(torch.isfinite(lk).all())
                and e_log <= 1e-3 * max(1.0, top) and max(e_kv) <= 1e-4)
        print(f"[{tag}] decode_step at position {cur} after the prefix, logits kernel vs plain "
              f"path: max_abs_err={e_log:.3g} of largest |logit| {top:.3g} (tol 1e-3 x max(1, "
              f"that)); caches: worst layer's max_abs_err over the largest entry the step "
              f"wrote there {max(e_kv):.3g} (tol 1e-4; written |K|, |V| up to "
              f"{max(kv_top):.3g}) {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"{cfg.name}: a decode step through the kernels disagrees with the plain path")
        del outs, caches, cc, ck, cp

        # another prefix moves the last text logit
        fe2 = torch.from_numpy(prefix(np.random.default_rng(171), cfg, NB)).to(dev)
        logits2, _ = TM.prefill(cfg, params, tokens, lora=lora, rt=rt, frontend_emb=fe2)
        moved = (logits2 - logits0).abs().max().item()
        print(f"[{tag}] another prefix moves the last text logit by up to {moved:.3g} "
              f"(must exceed 1e-4) {'ok' if moved > 1e-4 else 'FAIL'}")
        if not moved > 1e-4:
            fail(f"{cfg.name}: the prefix does not reach the text logits")
        for paged in (True, False):
            try:
                ServingEngine(cfg, params, lora=lora, paged=paged, device="cuda")
            except NotImplementedError as e:
                print(f"[{tag}] ServingEngine(paged={paged}) refuses the arch, as repro's "
                      f"does: {e}")
            else:
                fail(f"{cfg.name}: ServingEngine(paged={paged}) accepted a front-end arch")

    def train(tag, cfg, params, lora, split):
        """One SFL round through Trainer.fit on the E2E corpus with a prefix
        per client sample; exact launch counts; one local step from the
        trained state through the kernels and through the plain path."""
        F_, d = cfg.frontend_tokens, cfg.d_model
        train_ex, _, _ = e2e_splits(4000, 400, 400, seed=0)
        tok = WordTokenizer.from_corpus([e.text for e in train_ex])
        if tok.vocab_size > cfg.vocab_size:
            fail(f"{cfg.name}: the corpus' {tok.vocab_size} words exceed the vocab")
        parts = [np.array(train_ex, dtype=object)[idx]
                 for idx in iid_partition(len(train_ex), KC, 0)]
        rng = np.random.default_rng(172)

        def data():
            for batch in sfl_batches(tok, parts, BC, SC, 0):
                yield dict(batch, frontend_emb=prefix(rng, cfg, KC, BC))

        sfl = SflLLM(cfg, params, ell_c=split,
                     train_cfg=TrainConfig(num_clients=KC, batch_size=BC, local_steps=IC,
                                           learning_rate=LR),
                     optimizer=adamw(LR), device="cuda")
        state = sfl.init_state(lora)
        trainer = Trainer(SflRound(sfl, [len(p) for p in parts]), local_steps=IC)
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launch_counts()                # just before the main path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = trainer.fit(state, data(), global_rounds=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(backend.LAUNCH_COUNTS)
        L = cfg.num_layers
        want = attention_per_step(KC, L, split)
        print(f"[{tag}] SFL round of {cfg.name} through Trainer.fit: K={KC} x b={BC} x "
              f"(F {F_} + S {SC}) rows, I={IC}, split {split} of {L}, AdamW lr={LR}: "
              f"{hist.round_seconds[0]:.3f}s (host clock), wall {wall:.2f}s incl. data; peak "
              f"device memory {peak_gib(torch):.2f} GiB")
        print(f"[{tag}] losses: {' '.join(f'{x:.4f}' for x in hist.losses)}")
        print(f"[{tag}] launches during the round: {launches}; per local step expected {want}")
        if len(hist.losses) != IC or not all(math.isfinite(x) for x in hist.losses):
            fail(f"{cfg.name}: training losses not finite or wrong count: {hist.losses}")
        if hist.rolled_back_rounds:
            fail(f"{cfg.name}: the round rolled back")
        if launches != {k: v * IC for k, v in want.items()}:
            fail(f"{cfg.name}: the round launched {launches}, expected {want} x {IC}")
        runs.append(launches)
        ad = b"".join(t.detach().cpu().numpy().tobytes()
                      for t in tree_leaves([state.lora_client, state.lora_server]))
        print(f"[{tag}] adapters digest after the round: {hashlib.sha256(ad).hexdigest()[:16]}")

        rng2 = np.random.default_rng(5)
        tk = rng2.integers(0, cfg.vocab_size, (KC, BC, SC)).astype(np.int32)
        step_batch = {"tokens": tk, "labels": np.roll(tk, -1, axis=-1),
                      "frontend_emb": prefix(rng2, cfg, KC, BC)}
        kern_rt = sfl.rt

        def step(rt):
            sfl.rt = rt
            out, m = sfl.local_step(state, step_batch)
            torch.cuda.synchronize()
            return float(m["loss"]), [out.lora_client, out.lora_server]

        (lk, ak), (lp, ap) = step(kern_rt), step(TM.Runtime())
        sfl.rt = kern_rt
        e_ad = max((a_ - b_).abs().max().item() for a_, b_ in zip(tree_leaves(ak),
                                                                 tree_leaves(ap)))
        good = abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)) and e_ad <= LR * 1e-2
        print(f"[{tag}] local_step with the prefix, kernels vs plain path (Runtime()): loss "
              f"{lk:.6f} vs {lp:.6f} (tol 1e-4 rel), adapters max_abs_err={e_ad:.3g} (tol "
              f"lr*1e-2 = {LR * 1e-2:.1g}) {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"{cfg.name}: a local step through the kernels disagrees with the plain path")
        # where a local step's time goes: the same step again through the
        # kernels, its output dropped, under torch.profiler (device busy
        # share over the step's wall, device time by kernel)
        from repro_torch.launch.serve import _report
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sfl.local_step(state, step_batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[{tag}] one local step with the prefix under torch.profiler: "
              f"{wall * 1e3:.1f} ms (host clock, profiler on)")
        _report(prof, wall, top=10)

    # (a) InternVL2-2B: GQA 16 over 8 KV heads of 128, SwiGLU, RMSNorm, RoPE,
    # vocab 92553, a vision prefix of 256; split 12 of 24
    # (b) MusicGen-Large: 32 heads of 64, GELU MLP, LayerNorm, learned
    # positions over 524288, vocab 2048, an audio prefix of 64; split 24 of 48
    for tag, name, seed, split in (("internvl", "internvl2-2b", 170, 12),
                                   ("musicgen", "musicgen-large", 171, 24)):
        t_model = time.perf_counter()
        cfg, params, lora = build(tag, name, seed)
        F_, KH, G, D = (cfg.frontend_tokens, cfg.num_kv_heads,
                        cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)
        for M in (NB, NB * (F_ + PROMPT)):
            for N in sorted({cfg.num_heads * D, KH * D}):
                check_lora(tag, M, cfg.d_model, N)
        for M in (BC * (F_ + SC), KC * BC * (F_ + SC)):
            for N in sorted({cfg.num_heads * D, KH * D}):
                check_lora(tag, M, cfg.d_model, N, backward=True)
        cap = F_ + PROMPT + NEW
        check_decode(tag, KH, G, D, cap, [F_ + PROMPT + 1, F_ + PROMPT + 7, cap - 1, cap])
        serve(tag, cfg, params, lora)
        train(tag, cfg, params, lora, split)
        del params, lora
        torch.cuda.empty_cache()
        print(f"[{tag}] wall {time.perf_counter() - t_model:.1f}s (host clock)")
    print(f"[frontends] phase 17 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    launches = {k: sum(r_.get(k, 0) for r_ in runs) for k in set().union(*runs)}
    return launches, err


# ---------------------------------------------------------------------------
# 18. the multi-device path over torch.distributed
# ---------------------------------------------------------------------------

MESH_LR = 4e-4
MESH_SFL = dict(K=4, b=4, S=64, split=6, I=6)      # full-width GPT-2-S
# full-width minicpm-2b at 20 of its 40 layers: two ranks sharing the card
# gather every layer through host memory twice a step (85-103 s a round at
# 40 layers on one H100), which phase 19 needs of the script's time
MESH_POD = dict(I=2, B=8, S=64, L=20)
MESH_MOE = dict(B=4, S=256, cf_one=1.0, cf_two=2.0)  # olmoe-1b-7b's layer


def _mesh_cfgs(small: bool):
    """The three workloads' configs; ``small`` cuts each to d_model 64 (and
    4 heads of 16, d_ff 128, 8 experts of 64) for a rehearsal on the CPU."""
    from repro_torch.configs import get_arch
    cfgs = [get_arch("gpt2-s"), get_arch("minicpm-2b").replace(num_layers=MESH_POD["L"]),
            get_arch("olmoe-1b-7b")]
    if small:
        cut = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128)
        cfgs = [cfgs[0].replace(**cut), cfgs[1].replace(num_layers=4, **cut),
                cfgs[2].replace(num_layers=1, **cut, num_experts=8)]
    return cfgs


def _mesh_lora(torch, TM, cfg, dev, seed):
    """Rank-4 adapters with B != 0, drawn from seeded generators."""
    lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(seed), 4, device=dev)
    g_b = torch.Generator().manual_seed(seed + 1)
    for layer in lora:
        for ad in layer.get("mixer", {}).values():
            ad["b"].copy_(torch.randn(ad["b"].shape, generator=g_b) * 0.02)
    return lora


def _recording(opt, first: int):
    """``opt`` that also keeps, on the host, the gradients of its first
    ``first`` updates (a round's first step: identical inputs on every
    path).  Returns (optimizer, the list they go to)."""
    from repro_torch.optim import Optimizer
    from repro_torch.tree import tree_map
    calls = []

    def update(grads, state, params):
        if len(calls) < first:
            calls.append(tree_map(lambda v: v.detach().cpu().clone(), grads))
        return opt.update(grads, state, params)
    return Optimizer(opt.init, update), calls


def _mesh_peak(torch, dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0


def _mesh_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_sfl(torch, np, dev, mesh, small):
    """One client-axis round (``SflLLM(mesh=)``; ``mesh`` None: one process
    with no group): full-width GPT-2-S, K 4 x b 4 x S 64, split 6, I 6."""
    from repro_torch import models as TM
    from repro_torch.configs import TrainConfig
    from repro_torch.core import SflLLM
    from repro_torch.kernels import backend
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    cfg = _mesh_cfgs(small)[0]
    m = MESH_SFL
    gen = torch.Generator(device=dev).manual_seed(180)
    params = TM.init_params(cfg, gen, device=dev)
    lora = _mesh_lora(torch, TM, cfg, dev, 181)
    tok = np.random.default_rng(182).integers(
        0, cfg.vocab_size, (m["I"], m["K"], m["b"], m["S"])).astype(np.int32)
    batches = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    tc = TrainConfig(num_clients=m["K"], batch_size=m["b"], local_steps=m["I"])
    opt, first = _recording(adamw(MESH_LR), 2)       # the server's, then the clients'
    sfl = SflLLM(cfg, params, m["split"], tc, opt, device=dev, mesh=mesh)
    state = sfl.init_state(lora)
    backend.reset_launch_counts()
    _mesh_sync(torch, dev)
    t0 = time.perf_counter()
    state, met = sfl.train_round(state, batches, [1.0, 2.0, 3.0, 4.0])
    _mesh_sync(torch, dev)
    secs = time.perf_counter() - t0
    launches = dict(backend.LAUNCH_COUNTS)
    whole = sfl.gather_state(state)
    cpu = lambda t: tree_map(lambda v: v.detach().cpu(), t)  # noqa: E731
    return {"loss": met["loss"].cpu().tolist(), "lora": cpu([whole.lora_client,
                                                            whole.lora_server]),
            "grads": [first[1], first[0]], "launches": launches, "seconds": secs,
            "local_clients": sfl._kl,
            "L": cfg.num_layers, "split": sfl.ell_c}


def recomputes(rt) -> bool:
    """Whether a layer's projections run again in the backward."""
    return rt.remat and rt.remat_policy == "full"


def _mesh_pod(torch, np, dev, mesh, small):
    """One ``PodRound`` round of full-width minicpm-2b (20 layers): I 2,
    a pooled batch of 8 x 64 cut over "data".  Each rank draws the seeded
    base a subtree at a time and keeps its pieces (``ShardedParams.init``),
    so no rank's card holds the whole base unless it is a world of one."""
    from repro_torch import models as TM
    from repro_torch.kernels import backend
    from repro_torch.launch.engine import PodRound
    from repro_torch.optim import adamw
    from repro_torch.sharding.fsdp import ShardedParams
    from repro_torch.tree import tree_map
    cfg = _mesh_cfgs(small)[1]
    m = MESH_POD
    if mesh is None:            # a world of one: no group, nothing sharded
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((1, 1), ("data", "model"), dev)
    params = ShardedParams.init(cfg, torch.Generator(device=dev).manual_seed(183), mesh)
    lora = _mesh_lora(torch, TM, cfg, dev, 184)
    opt, first = _recording(adamw(MESH_LR), 1)
    # remat "full": over more than one "data" rank every layer is gathered
    # again and recomputed in the backward (phase 19 (c) runs "dots")
    pod = PodRound(cfg, params, TM.default_train_runtime().replace(remat_policy="full"),
                   opt, mesh)
    tok = np.random.default_rng(185).integers(
        0, cfg.vocab_size, (m["I"], m["B"], m["S"])).astype(np.int32)
    backend.reset_launch_counts()
    _mesh_sync(torch, dev)
    t0 = time.perf_counter()
    (lo, _), met = pod.run_round(pod.init_state(lora), {"tokens": tok,
                                                         "labels": np.roll(tok, -1, -1)})
    _mesh_sync(torch, dev)
    secs = time.perf_counter() - t0
    sp = pod.params
    sh, rep = sp.rule_bytes()
    layer = max(sp.gathered_bytes(f"layers/{i}") for i in range(cfg.num_layers))
    return {"loss": met["loss"].cpu().tolist(), "lora": tree_map(lambda v: v.cpu(), lo),
            "grads": first[0], "launches": dict(backend.LAUNCH_COUNTS), "seconds": secs,
            "resident": sp.resident_bytes(), "sharded": sh, "replicated": rep,
            "layer_bytes": layer, "embed_bytes": sp.gathered_bytes("embed"),
            "peak_live": sp.peak_live_bytes, "gather_s": sp.gather_seconds,
            "L": cfg.num_layers}


def _mesh_moe(torch, np, dev, mesh, small):
    """``apply_moe_shard_map`` at olmoe-1b-7b's layer (d 2048, 64 experts,
    top 8, ffn 1024) on 4 x 256 tokens (``mesh`` None: ``apply_moe`` with
    no drops, group 1 and capacity factor 4).  Returns this rank's output
    piece and its (data, model) coordinate."""
    from repro_torch.models.moe import apply_moe, init_moe
    from repro_torch.models.moe_shard_map import (apply_moe_shard_map, shard_moe_input,
                                                  shard_moe_params)
    cfg = _mesh_cfgs(small)[2]
    gen = torch.Generator(device=dev).manual_seed(186)
    p = init_moe(cfg, gen, torch.float32, dev)
    x = torch.randn((MESH_MOE["B"], MESH_MOE["S"], cfg.d_model), generator=gen,
                    device=dev) * 0.5
    t0 = time.perf_counter()
    with torch.no_grad():
        if mesh is None:
            y = apply_moe(cfg, p, x, group_size=1, capacity_factor=4.0)[0]
            coord = (0, 0)
        else:
            tp = mesh.shape["model"]
            cf = MESH_MOE["cf_one"] if tp == 1 else MESH_MOE["cf_two"]
            y = apply_moe_shard_map(cfg, shard_moe_params(p, mesh), shard_moe_input(x, mesh),
                                    mesh, capacity_factor=cf)
            coord = (mesh.axis_rank("data"), mesh.axis_rank("model"))
    _mesh_sync(torch, dev)
    return {"y": y.cpu(), "coord": coord, "seconds": time.perf_counter() - t0}


def _mesh_rank(rank, world, store, out, device, backend, small):
    """One rank of phase 18 (a spawned process).  World 1: first the three
    runs in this process with no group (the references), then over a
    one-rank ``backend`` group; world 2: over a ``backend`` group, 2
    clients a rank, FSDP over "data" = 2, 32 experts a rank.  Every result
    goes to ``{out}.{rank}`` (a pickle); any error ends the process with an
    exception, which fails the phase."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_file_store, make_client_mesh, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(2)
    res = {"rank": rank, "world": world, "backend": backend}
    runs = (("sfl", _mesh_sfl), ("pod", _mesh_pod), ("moe", _mesh_moe))
    if world == 1:
        # the first pass pays the process's first-call set-up (cuBLAS,
        # the kernel libraries); its times are printed, the second pass
        # is the reference
        res["first_s"] = {k: fn(torch, np, dev, None, small)["seconds"] for k, fn in runs}
        res["ref"] = {k: fn(torch, np, dev, None, small) for k, fn in runs}
    dev = init_file_store(store, rank, world, device=dev.type, backend=backend)
    meshes = {"sfl": make_client_mesh(device=dev),
              "pod": make_mesh((world, 1), ("data", "model"), dev),
              "moe": make_mesh((1, world), ("data", "model"), dev)}
    res["mesh"] = {}
    for k, fn in runs:
        # the peak of each run, its weights' construction included
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        res["mesh"][k] = fn(torch, np, dev, meshes[k], small)
        res["mesh"][k]["peak_gib"] = _mesh_peak(torch, dev)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _mesh_spawn(world, backend, device, small, tmp):
    """Spawn ``world`` ranks of ``_mesh_rank``; a rank that raises fails
    the phase (``torch.multiprocessing`` re-raises it here).  Returns the
    ranks' results."""
    import pickle

    import torch.multiprocessing as mp
    store, out = tmp / f"store{world}{backend}", tmp / f"out{world}{backend}"
    mp.start_processes(_mesh_rank, args=(world, str(store), str(out), device, backend, small),
                       nprocs=world, join=True, start_method="spawn")
    res = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))
    return res


def _mesh_err(a, b) -> float:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return math.inf
    return max((x.double() - y.double()).abs().max().item() for x, y in zip(la, lb))


def loss_ok(a, b) -> bool:
    """Losses at phase 6's 1e-4 relative."""
    return all(abs(x - y) <= 1e-4 * max(1.0, abs(y)) for x, y in zip(a, b)) and \
        len(a) == len(b)


def mesh_held(tag, got, want, what):
    """Losses at phase 6's 1e-4 relative; the first step's gradients
    (the same inputs on both paths) within 1e-4 of their largest entry;
    every adapter entry after the round within a bound that follows
    from the measured gradient error d (the largest absolute error of
    the first step's gradients).  AdamW's first step moves an entry by
    lr*g/(|g|+eps), its next ones by lr*m/sqrt(v): a gradient error d
    on an entry comes back as about lr*d/|g|, and a sign flip of a
    gradient under d moves the entry by 2 lr.  So an entry whose first
    gradient is g is held to lr*min(2, max(1e-2, 4*d/|g|)): phase 6's
    lr*1e-2 wherever |g| >= 400 d, and no more than one flip anywhere."""
    from repro_torch.tree import tree_leaves
    g_got, g_want = tree_leaves(got["grads"]), tree_leaves(want["grads"])
    scale = max(g.abs().max().item() for g in g_want)
    d_g = max((a - b).abs().max().item() for a, b in zip(g_got, g_want))
    tol_ad = MESH_LR * 1e-2
    e_ad = worst = 0.0
    n_wide = n_past = n_all = 0
    for a, b, g in zip(tree_leaves(got["lora"]), tree_leaves(want["lora"]), g_want):
        d = (a.double() - b.double()).abs()
        bound = MESH_LR * (4 * d_g / g.double().abs()).clamp(1e-2, 2.0)
        e_ad = max(e_ad, d.max().item())
        worst = max(worst, (d / bound).max().item())
        n_wide += int((bound > tol_ad).sum())
        n_past += int((d > tol_ad).sum())
        n_all += d.numel()
    good = (loss_ok(got["loss"], want["loss"]) and len(g_got) == len(g_want)
            and d_g <= 1e-4 * scale and worst <= 1.0)
    print(f"[mesh] {tag} {what}: losses {' '.join(f'{x:.6f}' for x in got['loss'])} vs "
          f"{' '.join(f'{x:.6f}' for x in want['loss'])} (tol 1e-4 rel); first-step "
          f"gradients max_abs_err d={d_g:.3g}, {d_g / scale:.3g} of the largest entry "
          f"{scale:.3g} (tol 1e-4); adapters max_abs_err={e_ad:.3g}, at most {worst:.3g} of "
          f"each entry's bound lr*min(2, max(1e-2, 4d/|g|)) (tol 1; {n_wide} of {n_all} "
          f"entries have a bound above lr*1e-2 = {tol_ad:.1g}, {n_past} are past "
          f"lr*1e-2) {'ok' if good else 'FAIL'}")
    if not good:
        fail(f"phase 18 {tag}: {what} disagrees")


def mesh_expect(tag, name, launches, want, steps, phase=18, prefix="mesh"):
    """The launches of a run: exactly ``want`` per step, and nothing else."""
    good = all(launches.get(k, 0) == v * steps for k, v in want.items()) and \
        set(launches) == set(want)
    print(f"[{prefix}] {tag} {name} launches {launches}; expected {want} x {steps} steps "
          f"{'ok' if good else 'FAIL'}")
    if not good:
        fail(f"phase {phase} {tag}: {name} launches")


def pod_per_step(L, recompute):
    """Launches per ``PodRound`` step with LoRA on q and v: where each layer
    is recomputed in the backward under remat "full" (``recompute``: the
    runtime of (b) and (c), more than one "data" rank), its forward runs
    twice; under "dots" the recompute takes the projections' saved
    outputs and launches none; every layer's input but the first's (the
    embedding) takes a dX; two rank reduces per projection."""
    return {"lora_matmul": (4 if recompute else 2) * L, "lora_matmul_dx": 2 * (L - 1),
            "lora_rank_reduce": 4 * L}


def phase_mesh(torch, np, dev, small=False):
    """18. The multi-device path: (a) one rank over a one-rank NCCL group
    against the same trainers in one process with no group, (b) two ranks
    on the one card over gloo (CUDA tensors staged through host memory)
    against (a), (c) one rank a card over NCCL where there are two cards or
    more.  Returns the launches of the ranks' main-path runs."""
    import tempfile
    t_phase = time.perf_counter()
    device = dev.type
    nccl = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    launches_total = {}

    def add(l_):
        for k, v in l_.items():
            launches_total[k] = launches_total.get(k, 0) + v

    held = mesh_held
    expect = mesh_expect

    def whole_sfl(ranks):
        """Rank 0's client round with the first step's client gradients of
        every rank put together (each holds its own clients')."""
        from repro_torch.tree import tree_map
        r0 = ranks[0]["mesh"]["sfl"]
        client = tree_map(lambda *vs: torch.cat(vs), *[r["mesh"]["sfl"]["grads"][0]
                                                        for r in ranks])
        return {**r0, "grads": [client, r0["grads"][1]]}

    def moe_held(tag, y, y_ref, what):
        e = (y - y_ref).abs().max().item()
        good = tuple(y.shape) == tuple(y_ref.shape) and e <= 2e-4 and bool(
            torch.isfinite(y).all())
        print(f"[mesh] {tag} apply_moe_shard_map vs {what}: shape {tuple(y.shape)} "
              f"max_abs_err={e:.3g} (tol 2e-4) {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"phase 18 {tag}: the expert-parallel MoE disagrees with {what}")

    # -- (a) one rank, one-rank NCCL group vs no group -----------------------
    t0 = time.perf_counter()
    (a,) = _mesh_spawn(1, nccl, device, small, tmp)
    ref, one = a["ref"], a["mesh"]
    I_, Ks = MESH_SFL["I"], MESH_SFL["K"]
    L, ell = one["sfl"]["L"], one["sfl"]["split"]
    print(f"[mesh] (a) one rank over a one-rank {nccl} group: spawned and ran in "
          f"{time.perf_counter() - t0:.1f}s (host clock)")
    held("(a)", one["sfl"], ref["sfl"], "client-axis round (K 4 x b 4 x S 64, split 6, I 6) "
         "vs SflLLM with no group")
    expect("(a)", "client round", one["sfl"]["launches"], attention_per_step(Ks, L, ell), I_)
    expect("(a)", "no-group client round", ref["sfl"]["launches"],
           attention_per_step(Ks, L, ell), I_)
    held("(a)", one["pod"], ref["pod"], "PodRound (minicpm-2b, I 2, 8 x 64) vs PodRound "
         "with no group")
    expect("(a)", "PodRound", one["pod"]["launches"],
           pod_per_step(one["pod"]["L"], False), MESH_POD["I"])
    moe_held("(a)", one["moe"]["y"], ref["moe"]["y"], "apply_moe with no drops")
    for k in ("sfl", "pod"):
        add(one[k]["launches"])
    first = a["first_s"]
    print(f"[mesh] (a) s a run (host clock): client round {one['sfl']['seconds']:.3f} (no "
          f"group {ref['sfl']['seconds']:.3f}, its first call {first['sfl']:.3f}), PodRound "
          f"{one['pod']['seconds']:.3f} (no group {ref['pod']['seconds']:.3f}, first "
          f"{first['pod']:.3f}), MoE {one['moe']['seconds']:.3f} (apply_moe "
          f"{ref['moe']['seconds']:.3f}, first {first['moe']:.3f}); PodRound peak "
          f"{one['pod']['peak_gib']:.2f} GiB (construction included), resident frozen "
          f"{one['pod']['resident'] / 2 ** 30:.3f} GiB")

    # -- (b) two ranks on one card over gloo ---------------------------------
    t0 = time.perf_counter()
    two = _mesh_spawn(2, "gloo", device, small, tmp)
    print(f"[mesh] (b) two ranks on one {device} over gloo (CUDA tensors staged through host "
          f"memory): spawned and ran in {time.perf_counter() - t0:.1f}s (host clock)")
    per_rank = attention_per_step(Ks // 2, L, ell)
    for r in two:
        m = r["mesh"]
        pod = m["pod"]
        rows = {k: m["sfl"]["launches"].get(k, 0) for k in
                ("lora_matmul", "lora_matmul_dx", "lora_rank_reduce")}
        bound_b = pod["sharded"] // 2 + pod["replicated"] + 2 * max(pod["layer_bytes"],
                                                                    pod["embed_bytes"])
        good = (m["sfl"]["local_clients"] == Ks // 2 and pod["resident"] <= bound_b
                and pod["resident"] == pod["sharded"] // 2 + pod["replicated"])
        print(f"[mesh] (b) rank {r['rank']}: {m['sfl']['local_clients']} clients; client round "
              f"launches of rows 1, 3, 4 {rows}; PodRound resident frozen bytes "
              f"{pod['resident']} = sharded {pod['sharded']} / 2 + replicated "
              f"{pod['replicated']} (bound with two gathered layers {bound_b}), gathered bytes "
              f"alive at most {pod['peak_live']} (a layer {pod['layer_bytes']}, the embedding "
              f"{pod['embed_bytes']}), peak device memory {pod['peak_gib']:.2f} GiB "
              f"(construction included; every rank on the one card allocates its own), "
              f"launches {pod['launches']}; s a run: client round {m['sfl']['seconds']:.3f}, "
              f"PodRound {pod['seconds']:.3f} (of "
              f"which gathering the base {pod['gather_s']:.3f}), MoE "
              f"{m['moe']['seconds']:.3f} {'ok' if good else 'FAIL'}")
        if not good:
            fail("phase 18 (b): a rank's clients or resident frozen bytes")
        expect(f"(b) rank {r['rank']}", "client round", m["sfl"]["launches"], per_rank, I_)
        # FSDP over two "data" ranks under remat "full": every layer's
        # forward runs again in the backward
        expect(f"(b) rank {r['rank']}", "PodRound", pod["launches"],
               pod_per_step(pod["L"], True), MESH_POD["I"])
        add(m["sfl"]["launches"])
        add(pod["launches"])
    # the clients' launches add up to the one-process count; the server runs
    # on every rank (each on its clients' rows), so it counts once a rank
    total = {k: sum(r["mesh"]["sfl"]["launches"].get(k, 0) for r in two) for k in per_rank}
    server = attention_per_step(0, L, ell)
    want_sum = {k: ref["sfl"]["launches"].get(k, 0) + (len(two) - 1) * server[k] * I_
                for k in per_rank}
    good = total == want_sum
    print(f"[mesh] (b) client round launches summed over the ranks {total} = the one-process "
          f"count {ref['sfl']['launches']} + one more server pass a step {server} x {I_} "
          f"{'ok' if good else 'FAIL'}")
    if not good:
        fail("phase 18 (b): the ranks' launches do not add up")
    held("(b)", whole_sfl(two), ref["sfl"], "client-axis round (2 clients a rank) vs (a)'s "
         "no-group round")
    for k in ("sfl", "pod"):
        a_, b_ = two[1]["mesh"][k], two[0]["mesh"][k]
        good = a_["loss"] == b_["loss"] and _mesh_err(a_["lora"], b_["lora"]) == 0.0
        print(f"[mesh] (b) {k}: rank 1's losses and gathered adapters equal rank 0's bit for "
              f"bit {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"phase 18 (b): the ranks' {k} states differ")
    held("(b)", two[0]["mesh"]["pod"], ref["pod"], "PodRound, FSDP over 'data' = 2, vs (a)'s "
         "no-group PodRound")
    y = torch.zeros_like(ref["moe"]["y"])
    s = MESH_MOE["S"] // 2
    for r in two:
        _, j = r["mesh"]["moe"]["coord"]
        y[:, j * s:(j + 1) * s] = r["mesh"]["moe"]["y"]
    moe_held("(b)", y, ref["moe"]["y"], "(a)'s apply_moe (32 experts a rank)")
    moe_held("(b)", y, one["moe"]["y"], "(a)'s one-rank shard map")

    # -- (c) one rank a card --------------------------------------------------
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    if n_cards >= 2:
        world = min(n_cards, 4)
        t0 = time.perf_counter()
        many = _mesh_spawn(world, "nccl", device, small, tmp)
        print(f"[mesh] (c) {world} ranks, one card each, over NCCL: "
              f"{time.perf_counter() - t0:.1f}s (host clock)")
        held("(c)", whole_sfl(many), ref["sfl"], f"client-axis round over {world} ranks")
        held("(c)", many[0]["mesh"]["pod"], ref["pod"], f"PodRound over {world} ranks")
        for r in many:
            add(r["mesh"]["sfl"]["launches"])
            add(r["mesh"]["pod"]["launches"])
    else:
        print(f"[mesh] (c) not run: {n_cards} card(s) visible; one rank a card over NCCL "
              "needs two or more")
    print(f"[mesh] phase 18 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    return launches_total


# ---------------------------------------------------------------------------
# 19. tensor parallelism over "model" and the last Runtime knobs
# ---------------------------------------------------------------------------

KNOB = dict(B=1, S=4096, kv_chunk=512, q_chunk=2048)   # train_4k's length
TP_RUNS = {
    # name: (config, Runtime knobs, rows, tokens a row)
    "yi": ("yi-9b", {}, 8, 64),
    # 4 rows: two ranks sharing the card stage every capacity buffer of the
    # exchange through the host (26-28 s a round at 8 rows on one H100)
    "olmoe": ("olmoe-1b-7b", {}, 4, 128),
    "olmoe_mc": ("olmoe-1b-7b", {"moe_constraints": True}, 4, 128),
    "olmoe_seq": ("olmoe-1b-7b", {"moe_constraints": True, "seq_shard": True}, 4, 128),
    "gpt2": ("gpt2-s", {}, 8, 64),
    # the yardstick: yi-9b in one process through the plain projections
    "yi_plain": ("yi-9b", {"dense_impl": "einsum"}, 8, 64),
}
TP_I = 2
# SGD: the adapters then move by the gradients themselves.  Under AdamW, on
# one H100, yi-9b's first-step gradients agreed to 3.08e-5 of their
# largest entry, but Adam's lr*g/(|g|+eps) flipped the B entries whose
# first gradient lay under that error, and the second step's gradients of
# A (proportional to B) moved by a few percent: 217,337 entries past
# lr*1e-2, up to 2 lr
TP_LR = 1e-2
TP_YI_TARGETS = ("q", "v", "o", "down")    # column- and row-parallel LoRA
TP_SEED = {"yi-9b": 190, "olmoe-1b-7b": 192, "gpt2-s": 194}


def _tp_cfg(name: str, small: bool):
    """A phase-19 config at full width (``small``: cut to d_model 64 with 4
    heads of 16 and d_ff 128 at 2 layers, for a rehearsal on the CPU)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    if name == "yi-9b":
        cfg = cfg.replace(lora_targets=TP_YI_TARGETS)
    if small:
        kv = 2 if cfg.num_kv_heads < cfg.num_heads else 4
        cfg = cfg.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=kv,
                          head_dim=16, d_ff=128, num_experts=min(cfg.num_experts, 8),
                          experts_per_token=min(cfg.experts_per_token, 2))
    return cfg


def _tp_lora(torch, TM, cfg, dev, seed):
    """Rank-4 adapters on every target with B != 0, from seeded generators."""
    lora = TM.init_lora_stack(cfg, torch.Generator().manual_seed(seed), 4, device=dev)
    g_b = torch.Generator().manual_seed(seed + 1)
    for layer in lora:
        for group in layer.values():
            for ad in group.values():
                ad["b"].copy_(torch.randn(ad["b"].shape, generator=g_b) * 0.02)
    return lora


def _step_errs(got, want):
    """Per step: (the gradients' largest absolute error, that over their
    largest entry, the worst leaf, the largest entry)."""
    from repro_torch.tree import tree_leaves
    out = []
    for g_got, g_want in zip(got["grads"], want["grads"]):
        a, b = tree_leaves(g_got), tree_leaves(g_want)
        errs = [(x - y).abs().max().item() for x, y in zip(a, b)]
        d = max(errs)
        j = errs.index(d)
        top = max(y.abs().max().item() for y in b)
        out.append((d, d / top, f"leaf {j} {tuple(b[j].shape)} of largest "
                    f"{b[j].abs().max().item():.3g}", top))
    return out


def tp_held(tag, got, want, what, plain=None):
    """Phase 18's bounds where they apply to an SGD round: losses at 1e-4
    relative; each step's gradients within 1e-4 of their largest entry, a
    later step's within twice ``plain``'s error where that is larger
    (``plain``: the one-process plain path, the same f32 model through
    other sums, against the same reference: the conditioning of the
    steps after the first, whatever the layout); the adapters within lr
    times the sum over the steps of those bounds on the gradients'
    absolute error (SGD moves them by the gradients themselves), plus
    1e-6 for the updates' own rounding."""
    errs = _step_errs(got, want)
    yard = None if plain is None else _step_errs(plain, want)
    tols = [1e-4 if i == 0 or yard is None else max(1e-4, 2 * yard[i][1])
            for i in range(len(errs))]
    bound_ad = TP_LR * sum(t * e[3] for t, e in zip(tols, errs)) + 1e-6
    e_ad = _mesh_err(got["lora"], want["lora"])
    good = (loss_ok(got["loss"], want["loss"]) and len(errs) == TP_I == len(want["grads"])
            and all(e[1] <= t for e, t in zip(errs, tols)) and e_ad <= bound_ad)
    seen = "" if yard is None else "; the plain path's (dense_impl einsum): " + " ".join(
        f"{e[1]:.3g}" for e in yard)
    print(f"[tp] {tag} {what}: losses {' '.join(f'{x:.6f}' for x in got['loss'])} vs "
          f"{' '.join(f'{x:.6f}' for x in want['loss'])} (tol 1e-4 rel); the steps' "
          f"gradients max_abs_err {' '.join(f'{e[0]:.3g}' for e in errs)}, "
          f"{' '.join(f'{e[1]:.3g}' for e in errs)} of their largest entry (tol "
          f"{' '.join(f'{t:.3g}' for t in tols)}; worst: {'; '.join(e[2] for e in errs)}"
          f"{seen}); adapters max_abs_err={e_ad:.3g} (tol lr*sum(tol*largest) + 1e-6 = "
          f"{bound_ad:.3g}) {'ok' if good else 'FAIL'}")
    if not good:
        fail(f"phase 19 {tag}: {what} disagrees")


def tp_per_step(cfg, recompute):
    """Launches per step of every rank: one forward per adapted projection
    (two where the layer is recomputed under remat "full"), a dX for each
    but the first layer's q/k/v (their input comes from the frozen
    embedding), two rank reduces each."""
    n = len(cfg.lora_targets)
    first = sum(t in ("q", "k", "v") for t in cfg.lora_targets)
    L = cfg.num_layers
    return {"lora_matmul": (2 if recompute else 1) * n * L, "lora_matmul_dx": n * L - first,
            "lora_rank_reduce": 2 * n * L}


def rule_table_bytes(cfg, mesh) -> int:
    """The rule table's bytes of one rank's (data, model) piece of the f32
    base: each leaf's bytes over the sizes of the axes its spec names."""
    from repro_torch.models.model import abstract_params
    from repro_torch.sharding.specs import param_spec, tree_paths
    total = 0
    for path, v in tree_paths(abstract_params(cfg)):
        spec = param_spec(path, tuple(v.shape), mesh)
        total += v.numel() * v.element_size() // math.prod(
            mesh.shape.get(e, 1) for e in spec if e is not None)
    return total


def _tp_pod(torch, np, dev, mesh, small, run):
    """One ``PodRound`` round (I 2) of ``run`` (``TP_RUNS``) over ``mesh``
    (None: one process with no group), the base drawn on the device a
    subtree at a time (``ShardedParams.init``), SGD at ``TP_LR``; every
    step's gradients are kept."""
    from repro_torch import models as TM
    from repro_torch.kernels import backend
    from repro_torch.launch.engine import PodRound
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import sgd
    from repro_torch.sharding.fsdp import ShardedParams
    from repro_torch.tree import tree_map
    name, knobs, B, S = TP_RUNS[run]
    cfg = _tp_cfg(name, small)
    if mesh is None:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
    params = ShardedParams.init(cfg, torch.Generator(device=dev).manual_seed(TP_SEED[name]),
                                mesh)
    lora = _tp_lora(torch, TM, cfg, dev, TP_SEED[name] + 1)
    opt, grads = _recording(sgd(TP_LR), TP_I)
    pod = PodRound(cfg, params, TM.default_train_runtime().replace(**knobs), opt, mesh)
    tok = np.random.default_rng(TP_SEED[name] + 2).integers(
        0, cfg.vocab_size, (TP_I, B, S)).astype(np.int32)
    backend.reset_launch_counts()
    _mesh_sync(torch, dev)
    t0 = time.perf_counter()
    (lo, _), met = pod.run_round(pod.init_state(lora), {"tokens": tok,
                                                         "labels": np.roll(tok, -1, -1)})
    _mesh_sync(torch, dev)
    secs = time.perf_counter() - t0
    return {"loss": met["loss"].cpu().tolist(), "aux": met["aux"].cpu().tolist(),
            "lora": tree_map(lambda v: v.cpu(), lo), "grads": grads,
            "launches": dict(backend.LAUNCH_COUNTS), "seconds": secs,
            "resident": pod.params.resident_bytes(),
            "want_resident": rule_table_bytes(cfg, mesh),
            "per_step": tp_per_step(cfg, recomputes(pod.rt)), "tp": pod.rt.tp_axis,
            "seq": bool(knobs.get("seq_shard")), "mesh": dict(mesh.shape)}


def _tp_rank(rank, world, store, out, device, backend, small, runs, shape):
    """One rank of phase 19 (a spawned process): ``runs`` over a mesh of
    ``shape`` ("data", "model") on a ``backend`` group, or with no group in
    a world of one.  Results go to ``{out}.{rank}``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_file_store, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    mesh = None
    if world > 1:
        dev = init_file_store(store, rank, world, device=dev.type, backend=backend)
        mesh = make_mesh(shape, ("data", "model"), dev)
    res = {"rank": rank, "runs": {}}
    t0 = time.perf_counter()
    _tp_pod(torch, np, dev, mesh, True, "gpt2")      # the process's first-call set-up
    res["warm_s"] = time.perf_counter() - t0
    for run in runs:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        res["runs"][run] = _tp_pod(torch, np, dev, mesh, small, run)
        res["runs"][run]["peak_gib"] = _mesh_peak(torch, dev)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()


def _tp_spawn(world, backend, device, small, tmp, runs, shape):
    import pickle

    import torch.multiprocessing as mp
    tag = f"{world}{backend}{runs[0]}"
    store, out = tmp / f"store{tag}", tmp / f"out{tag}"
    mp.start_processes(_tp_rank, args=(world, str(store), str(out), device, backend, small,
                                       runs, shape),
                       nprocs=world, join=True, start_method="spawn")
    res = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))
    return res


def _knob_step(torch, np, dev, small):
    """(a) one train step of full-width minicpm-2b at S 4096 under each
    runtime: the loss, the LoRA gradients, ms a step (host clock around a
    synchronized step), peak memory and the launches."""
    from repro_torch import models as TM
    from repro_torch.kernels import backend
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.tree import tree_map
    from repro_torch.configs import get_arch
    cfg = get_arch("minicpm-2b")
    B, S = KNOB["B"], KNOB["S"]
    if small:
        cfg = cfg.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                          d_ff=128)
        S = 256
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(196), device=dev)
    lora = _tp_lora(torch, TM, cfg, dev, 197)
    tok = torch.from_numpy(np.random.default_rng(198).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)).to(dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    base = TM.default_train_runtime().replace(kv_chunk=KNOB["kv_chunk"])
    q_chunk = KNOB["q_chunk"] if not small else 128
    rts = {"ref": base, "none": base.replace(q_chunk=q_chunk),
           "full": base.replace(q_chunk=q_chunk, remat=True, remat_policy="full"),
           "dots": base.replace(q_chunk=q_chunk, remat=True, remat_policy="dots")}

    def step(rt, p, lo):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        backend.reset_launch_counts()
        _mesh_sync(torch, dev)
        t0 = time.perf_counter()
        loss, aux, grads = _value_and_grad(
            lambda lo_: TM.loss_fn(cfg, p, lo_, batch, rt=rt), lo)
        _mesh_sync(torch, dev)
        return {"loss": loss.item(), "grads": tree_map(lambda v: v.float().cpu(), grads),
                "ms": (time.perf_counter() - t0) * 1e3, "peak_gib": _mesh_peak(torch, dev),
                "launches": dict(backend.LAUNCH_COUNTS)}

    step(rts["ref"], params, lora)                 # first-call set-up, not kept
    out = {k: step(rt, params, lora) for k, rt in rts.items()}
    # the low-precision score einsum on a bf16 step, against f32 scores
    p16 = tree_map(lambda v: v.to(torch.bfloat16), params)
    l16 = tree_map(lambda v: v.to(torch.bfloat16), lora)
    del params
    rt16 = base.replace(q_chunk=q_chunk)
    out["bf16_f32s"] = step(rt16, p16, l16)
    out["bf16_s16"] = step(rt16.replace(attn_s_bf16=True), p16, l16)
    return cfg, S, q_chunk, out


def _tp_kernels(torch, np, dev, flush, note):
    """(e) rows 1, 3 and 4 at the TP-local shapes of (b)'s yi-9b round
    (8 x 64 rows on each rank of a (1, 2) mesh): q and v column-parallel
    at N 2048 and 256, o and down row-parallel at K 2048 and 5504; each
    against its plain version, then timed beside it, a library call and
    the bound."""
    from repro_torch.kernels.lora_matmul import (lora_matmul_dx_kernel, lora_matmul_dx_ref,
                                                 lora_matmul_kernel, lora_matmul_ref,
                                                 lora_rank_reduce_kernel,
                                                 lora_rank_reduce_ref)
    gen = torch.Generator(device=dev).manual_seed(199)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    M, r, s = 512, 4, 2.0
    shapes = {"q": (4096, 2048), "v": (4096, 256), "o": (2048, 4096), "down": (5504, 4096)}
    for name, (K, N) in shapes.items():
        check_lora_shape(torch, "tp", randn, note, M, K, N, backward=True)
        # B as a trained adapter's (std 0.5, not 0.02): the low-rank term weighs;
        # held relative to the largest entry, which the f32 sums' error follows
        x, w, a, b = lora_operands(randn, M, K, N, r)
        b = b * 25.0
        dy = randn(M, N)
        for op, got, want in (("lora_matmul", lora_matmul_kernel(x, w, a, b, s),
                               lora_matmul_ref(x, w, a, b, s)),
                              ("lora_matmul_dx", lora_matmul_dx_kernel(dy, w, a, b, s),
                               lora_matmul_dx_ref(dy, w, a, b, s))):
            e, top = (got - want).abs().max().item(), want.abs().max().item()
            ok = e <= 1e-6 * top
            print(f"[tp] {op} f32 {name} M={M} K={K} N={N} r={r}, B std 0.5: "
                  f"max_abs_err={e:.3g}, {e / top:.3g} of the largest entry {top:.3g} (tol "
                  f"1e-6: the outputs reach ~500, where f32's own spacing is 3e-5) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{op} at ({M}, {K}, {N}) with a large B disagrees with its plain version")
    for name, (K, N) in shapes.items():
        x, w, a, b = lora_operands(randn, M, K, N, r)
        dy, u = randn(M, N), randn(M, r)
        f_bytes = 4 * (M * K + K * N + r * K + N * r + M * N)
        f_ops = lora_flops(M, K, N, r)
        rr_bytes = 4 * (M * r + M * N + r * N)
        for op, kern, ref, lib, nb, fl, tc in (
                ("lora_matmul", lambda: lora_matmul_kernel(x, w, a, b, s),
                 lambda: lora_matmul_ref(x, w, a, b, s),
                 lambda: x @ w + s * ((x @ a.T) @ b.T), f_bytes, f_ops, True),
                ("lora_matmul_dx", lambda: lora_matmul_dx_kernel(dy, w, a, b, s),
                 lambda: lora_matmul_dx_ref(dy, w, a, b, s),
                 lambda: dy @ w.T + s * ((dy @ b) @ a), f_bytes, f_ops, True),
                ("lora_rank_reduce", lambda: lora_rank_reduce_kernel(u, dy),
                 lambda: lora_rank_reduce_ref(u, dy), lambda: u.T @ dy, rr_bytes,
                 2 * M * r * N, False)):
            ms = time_ms(torch, kern, flush)
            plain = time_ms(torch, ref, flush)
            lib_ms = time_ms(torch, lib, flush)
            bms, bby = bound_tf32(nb, fl, 3) if tc else bound(nb, fl)
            print(f"[tp] time {op} f32 {name} M={M} K={K} N={N} r={r} (yi-9b at tp 2): "
                  f"kernel {ms * 1e3:.2f}us plain {plain * 1e3:.2f}us library "
                  f"{lib_ms * 1e3:.2f}us bound {bms * 1e3:.2f}us "
                  f"({'3xTF32, ' if tc else ''}{bby})")
    # within backend.as_ops (remat "dots") the fused forward goes through the
    # custom op repro_torch::kernel_lora_matmul (so that the policy can save
    # it); elsewhere it is the bare launch: the host cost of each at a decode
    # shape, GPT-2-S's q at 8 slots
    from repro_torch.kernels import backend
    from repro_torch.kernels.lora_matmul.ops import _forward
    x, w, a, b = lora_operands(randn, 8, 768, 768, r)

    def through_op():
        with backend.as_ops(("lora_matmul",)):
            return _forward(x, w, a, b, s)

    with torch.no_grad():
        t_op = host_us(torch, through_op, n=2000)
        t_bare = host_us(torch, lambda: _forward(x, w, a, b, s), n=2000)
        t_op2 = host_us(torch, through_op, n=2000)
        t_bare2 = host_us(torch, lambda: _forward(x, w, a, b, s), n=2000)
    print(f"[tp] host time of the fused forward at M 8, K = N 768 (GPT-2-S's q at 8 slots), "
          f"2000 back-to-back calls, synchronized: through the custom op {t_op:.2f} / "
          f"{t_op2:.2f} us a call, the bare launch {t_bare:.2f} / {t_bare2:.2f} us ({smi_line()})")


def phase_tp(torch, np, dev, flush=None, small=False):
    """19. Tensor parallelism over "model" and the last ``Runtime`` knobs:
    (a) the knobs on one process, (b) two ranks on the one card over gloo
    on a (1, 2) mesh, (c) four on a (2, 2) mesh, (d) one rank a card over
    NCCL where there are two or more, (e) rows 1, 3 and 4 at (b)'s
    TP-local shapes.  Returns (the launches of the main-path runs, the
    kernels' largest errors at the TP-local shapes)."""
    import tempfile
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    device = dev.type
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    launches_total, err = {}, {}

    def add(l_):
        for k, v in l_.items():
            launches_total[k] = launches_total.get(k, 0) + v

    def note(op, e):
        err[op] = max(err.get(op, 0.0), e)

    held = tp_held
    expect = functools.partial(mesh_expect, phase=19, prefix="tp")

    # -- (a) the knobs, one process -------------------------------------------
    cfg, S, q_chunk, a = _knob_step(torch, np, dev, small)
    ref = a["ref"]
    scale = max(g.abs().max().item() for g in tree_leaves(ref["grads"]))
    per = tp_per_step(cfg, False)
    for k in ("ref", "none", "full", "dots"):
        r_ = a[k]
        d_g = max((x - y).abs().max().item()
                  for x, y in zip(tree_leaves(r_["grads"]), tree_leaves(ref["grads"])))
        want = tp_per_step(cfg, k == "full")
        good = (math.isfinite(r_["loss"]) and abs(r_["loss"] - ref["loss"])
                <= 1e-4 * max(1.0, abs(ref["loss"])) and d_g <= 1e-4 * scale
                and r_["launches"] == want)
        print(f"[tp] (a) minicpm-2b B {KNOB['B']} x S {S}, kv_chunk {KNOB['kv_chunk']}, "
              f"{'q_chunk 0, no remat (the reference)' if k == 'ref' else f'q_chunk {q_chunk}, remat {k}'}: "
              f"loss {r_['loss']:.6f} vs {ref['loss']:.6f} (tol 1e-4 rel), LoRA gradients "
              f"max_abs_err {d_g:.3g} = {d_g / scale:.3g} of the largest {scale:.3g} (tol "
              f"1e-4); {r_['ms']:.1f} ms a step (host clock, synchronized), peak "
              f"{r_['peak_gib']:.2f} GiB; launches {r_['launches']} (expected {want}) "
              f"{'ok' if good else 'FAIL'}")
        if not good:
            fail(f"phase 19 (a): the {k} step disagrees")
        if k != "ref":
            add(r_["launches"])
    lo, hi = a["bf16_f32s"], a["bf16_s16"]
    g_lo, g_hi = tree_leaves(lo["grads"]), tree_leaves(hi["grads"])
    sc = max(g.abs().max().item() for g in g_lo)
    d16 = max((x - y).abs().max().item() for x, y in zip(g_hi, g_lo))
    good = (math.isfinite(hi["loss"]) and abs(hi["loss"] - lo["loss"])
            <= 2e-2 * max(1.0, abs(lo["loss"])) and d16 <= 5e-2 * sc
            and hi["launches"] == per)
    print(f"[tp] (a) bf16 step, attn_s_bf16 (score einsum in bf16) vs f32 scores: loss "
          f"{hi['loss']:.6f} vs {lo['loss']:.6f} (tol 2e-2 rel), LoRA gradients max_abs_err "
          f"{d16:.3g} = {d16 / sc:.3g} of the largest {sc:.3g} (tol 5e-2); {hi['ms']:.1f} vs "
          f"{lo['ms']:.1f} ms a step, peak {hi['peak_gib']:.2f} vs {lo['peak_gib']:.2f} GiB "
          f"{'ok' if good else 'FAIL'}")
    if not good:
        fail("phase 19 (a): the bf16 score einsum moves the step past bf16 tolerance")
    add(hi["launches"])
    del a, ref, lo, hi
    if device == "cuda":
        torch.cuda.empty_cache()

    def report(tag, r, want):
        rr = r["rank"]
        for run, m in r["runs"].items():
            good = (m["resident"] == m["want_resident"] and m["tp"] == "model"
                    and all(math.isfinite(x) for x in m["loss"]))
            print(f"[tp] {tag} rank {rr} {run} {TP_RUNS[run][0]} mesh {m['mesh']}"
                  f"{' seq_shard' if m['seq'] else ''}: resident frozen bytes {m['resident']} "
                  f"(the rule table's {m['want_resident']}), {m['seconds']:.3f} s a round "
                  f"(host clock), peak {m['peak_gib']:.2f} GiB (construction included), "
                  f"aux {' '.join(f'{x:.6f}' for x in m['aux'])} {'ok' if good else 'FAIL'}")
            if not good:
                fail(f"phase 19 {tag}: rank {rr}'s {run} round")
            expect(f"{tag} rank {rr}", f"{run} PodRound", m["launches"], m["per_step"], TP_I)
            held(f"{tag} rank {rr}", m, want[run], f"{run} PodRound over {m['mesh']} vs one "
                 "process", plain if run == "yi" else None)
            add(m["launches"])

    # -- (e) rows 1, 3, 4 at the TP-local shapes ---------------------------------
    if device == "cuda":
        _tp_kernels(torch, np, dev, flush, note)

    # -- references: one process, no group -------------------------------------
    t0 = time.perf_counter()
    (one,) = _tp_spawn(1, "gloo", device, small, tmp, ["yi", "yi_plain", "olmoe", "gpt2"],
                       (1, 1))
    want = dict(one["runs"])
    plain = want.pop("yi_plain")
    for k in ("olmoe_mc", "olmoe_seq"):
        want[k] = want["olmoe"]
    print(f"[tp] (ref) one process: the first-call set-up (a PodRound of GPT-2-S cut to d "
          f"64) {one['warm_s']:.1f}s (host clock)")
    for run, m in one["runs"].items():
        if run == "yi_plain":
            print(f"[tp] (ref) yi-9b one process through the plain projections: "
                  f"{m['seconds']:.3f} s a round, losses "
                  f"{' '.join(f'{x:.6f}' for x in m['loss'])}, launches {m['launches']}")
            continue
        expect("(ref)", f"{run} PodRound with no group", m["launches"], m["per_step"], TP_I)
        print(f"[tp] (ref) {run} {TP_RUNS[run][0]} one process: {m['seconds']:.3f} s a round, "
              f"peak {m['peak_gib']:.2f} GiB, losses {' '.join(f'{x:.6f}' for x in m['loss'])}")
    print(f"[tp] references spawned and ran in {time.perf_counter() - t0:.1f}s (host clock)")

    # -- (b) two ranks, one card, gloo, (1, 2) ----------------------------------
    t0 = time.perf_counter()
    two = _tp_spawn(2, "gloo", device, small, tmp, ["yi", "olmoe", "olmoe_mc", "olmoe_seq"],
                    (1, 2))
    print(f"[tp] (b) two ranks on one {device} over gloo, mesh (1, 2): spawned and ran in "
          f"{time.perf_counter() - t0:.1f}s (host clock)")
    for r in two:
        print(f"[tp] (b) rank {r['rank']}: first-call set-up {r['warm_s']:.1f}s")
        report("(b)", r, want)
    for run in two[0]["runs"]:
        x, y = two[0]["runs"][run], two[1]["runs"][run]
        good = x["loss"] == y["loss"] and _mesh_err(x["lora"], y["lora"]) == 0.0
        print(f"[tp] (b) {run}: rank 1's losses and adapters equal rank 0's bit for bit "
              f"{'ok' if good else 'FAIL'}")
        if not good:
            fail(f"phase 19 (b): the ranks' {run} states differ")

    # -- (c) four ranks, one card, gloo, (2, 2) ---------------------------------
    t0 = time.perf_counter()
    four = _tp_spawn(4, "gloo", device, small, tmp, ["gpt2"], (2, 2))
    print(f"[tp] (c) four ranks on one {device} over gloo, mesh (2, 2): spawned and ran in "
          f"{time.perf_counter() - t0:.1f}s (host clock)")
    for r in four:
        report("(c)", r, want)

    # -- (d) one rank a card ------------------------------------------------------
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    if n_cards >= 2:
        t0 = time.perf_counter()
        for r in _tp_spawn(2, "nccl", device, small, tmp, ["yi", "olmoe_seq"], (1, 2)):
            report("(d)", r, want)
        if n_cards >= 4:
            for r in _tp_spawn(4, "nccl", device, small, tmp, ["gpt2"], (2, 2)):
                report("(d)", r, want)
        print(f"[tp] (d) one rank a card over NCCL: {time.perf_counter() - t0:.1f}s")
    else:
        print(f"[tp] (d) not run: {n_cards} card(s) visible; one rank a card over NCCL needs "
              "two or more")

    print(f"[tp] phase 19 wall {time.perf_counter() - t_phase:.1f}s (host clock)")
    return launches_total, err



# -- phase 20: prefill and decode over a mesh, and the dry-run ---------------

SERVE_DIMS = {"yi-9b": (4, 512, 8), "mamba2-2.7b": (2, 200, 8)}   # B, prompt, steps
SERVE_SEED = {"yi-9b": 200, "mamba2-2.7b": 203}
SERVE_RUNS = {
    # name: (config, ranks over "model", Runtime knobs); the *_plain runs
    # are the references, one process through the plain PyTorch versions
    "yi_heads": ("yi-9b", 2, dict(dense_impl="fused", decode_attn_impl="flash")),
    "yi_len": ("yi-9b", 8, dict(dense_impl="fused", decode_attn_impl="naive")),
    "yi_len_flash": ("yi-9b", 8, dict(dense_impl="fused", decode_attn_impl="flash")),
    "mamba": ("mamba2-2.7b", 2, dict(dense_impl="fused", ssd_impl="kernel")),
    "yi_plain": ("yi-9b", 1, dict(dense_impl="einsum", decode_attn_impl="naive")),
    "mamba_plain": ("mamba2-2.7b", 1, dict(dense_impl="einsum", ssd_impl="chunked")),
    "mamba_f64": ("mamba2-2.7b", 1, dict(dense_impl="einsum", ssd_impl="chunked")),
}
# (b)'s runs decode 4 of the cache's 8 new positions (eight ranks sharing
# the card over host-staged gloo take 6.7-9.2 s a step), held to the
# reference's first 4 steps; the cache keeps the reference's length (520:
# pieces of 65 a rank)
SERVE_STEPS = {"yi_len": 4, "yi_len_flash": 4}
# runs that decode from a copy of another run's prefill on the same rank
# (the same weights, tokens and prefill: only the decode attention
# differs), which saves their own weights and prefill: run -> that run
SERVE_FOLLOWS = {"yi_len_flash": "yi_len"}
# runs whose weights and adapters are cast to float64: Mamba2's witness,
# since a random Mamba2 amplifies f32 rounding over its depth and the
# plain f32 path is itself far from exact (phase 12)
SERVE_F64 = ("mamba_f64",)
# the dry-run's pairs, one of each shape kind, at (16, 16): the shallowest
# configs of each, so that the abstract runs end within a minute or two;
# (arch, shape, --rt overrides): yi-9b's decode also under "flash", whose
# KV cache (KH 4 over tp 16) is cut by its length
DRYRUN_PAIRS = (("olmoe-1b-7b", "train_4k", ()), ("olmoe-1b-7b", "prefill_32k", ()),
                ("yi-9b", "decode_32k", ()),
                ("yi-9b", "decode_32k", ("decode_attn_impl=flash",)))
SERVE_TOL = 1e-4        # logits: f32, against the largest of the reference's


SERVE_SSM_LAYERS = 16   # of Mamba2-2.7B's 64: see _serve_cfg


def _serve_cfg(name: str, small: bool):
    """A phase-20 config at full width: yi-9b with LoRA on q, v, o, down
    (column- and row-parallel) at full depth, Mamba2-2.7B on
    ssm_in/ssm_out at 16 of its 64 layers (each rank gathers every mixer
    through the host for each prefill and decode step: 15.4 s a step at
    64 layers over gloo on one H100).  ``small``: 2 layers at d_model 64
    (yi-9b: 8 heads of 8 over its 4 KV heads; the full vocabularies), for
    a rehearsal on the CPU."""
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    if name == "yi-9b":
        cfg = cfg.replace(lora_targets=TP_YI_TARGETS)
        if small:
            cfg = cfg.replace(num_layers=2, d_model=64, num_heads=8, head_dim=8, d_ff=128)
    elif small:
        cfg = cfg.replace(num_layers=2, d_model=64, ssm_state=16, ssm_head_dim=32)
    else:
        cfg = cfg.replace(num_layers=SERVE_SSM_LAYERS)
    return cfg


def serve_per_run(cfg, run: str, steps: int) -> dict:
    """Launches of one prefill and ``steps`` decode steps on every rank (a
    run of ``SERVE_FOLLOWS``: the steps alone): under
    ``dense_impl="fused"`` each adapted projection once a prefill and once
    a step (a Mamba2 prefill also recomputes ``in_proj`` on the conv
    tail); under ``decode_attn_impl="flash"`` one ``flash_decode`` a
    layer a step over a cache cut by heads, one ``flash_decode_partial``
    over a cache cut by its length (KH % tp != 0); under
    ``ssd_impl="kernel"`` one ``ssd_scan`` a Mamba2 layer a prefill.  The
    plain routes launch nothing."""
    L = cfg.num_layers
    n = len(cfg.lora_targets)
    _, tp, knobs = SERVE_RUNS[run]
    prefills = 0 if run in SERVE_FOLLOWS else 1
    out = {}
    if knobs["dense_impl"] == "fused":
        out["lora_matmul"] = n * L * (prefills + steps) + \
            (L * prefills if cfg.family == "ssm" else 0)
    if knobs.get("decode_attn_impl") == "flash":
        cut = "flash_decode" if cfg.num_kv_heads % tp == 0 else "flash_decode_partial"
        out[cut] = L * steps
    if knobs.get("ssd_impl") == "kernel" and prefills:
        out["ssd_scan"] = L
    return out


def _serve_run(torch, np, dev, mesh, small, run, kept):
    """One prefill of ``run``'s prompts and greedy decode steps over
    ``mesh``'s "model" axis (None: one process, no group), the base drawn
    on the device a subtree at a time and cut to this rank's pieces
    (``ShardedParams.init``); the logits gathered whole each step.  Then,
    with the launch counts read, one more decode step under
    ``FlopCounterMode`` (its count for the dry-run's to meet).  ``kept``
    (this rank's, across its runs): a run that others follow leaves its
    weights, tokens, prefill logits and a copy of its prefill's caches
    there, and a run of ``SERVE_FOLLOWS`` takes them instead of its own
    (the launch counts then cover its decode steps alone)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import models as TM
    from repro_torch.kernels import backend
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.collectives import all_gather
    from repro_torch.sharding.fsdp import ShardedParams
    from repro_torch.tree import tree_map
    name, _, knobs = SERVE_RUNS[run]
    cfg = _serve_cfg(name, small)
    B, S, cap = SERVE_DIMS[name]
    steps = SERVE_STEPS.get(run, cap)
    rt = TM.Runtime(**knobs)
    group = None
    if mesh is None:
        base_mesh = make_mesh((1, 1), ("data", "model"), dev)
    else:
        base_mesh = mesh
        rt = rt.replace(tp_axis="model", mesh=mesh)
        group = mesh.group("model")

    def whole(lg):
        return lg if lg.shape[-1] == cfg.vocab_size else all_gather(lg, group, -1)

    follows = SERVE_FOLLOWS.get(run)
    if follows is None:
        params = ShardedParams.init(
            cfg, torch.Generator(device=dev).manual_seed(SERVE_SEED[name]), base_mesh).local
        lora = _tp_lora(torch, TM, cfg, dev, SERVE_SEED[name] + 1)
        if run in SERVE_F64:
            params, lora = (tree_map(lambda v: v.double() if v.is_floating_point() else v, t)
                            for t in (params, lora))
        tok = torch.from_numpy(np.random.default_rng(SERVE_SEED[name] + 2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int64)).to(dev)
    else:
        params, lora, tok, first, caches, t_pre = kept.pop(follows)

    logits_all, ids = [], []
    backend.reset_launch_counts()
    _mesh_sync(torch, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        if follows is None:
            lg, caches = TM.prefill(cfg, params, tok, lora=lora, rt=rt, cache_len=S + cap)
            lg = whole(lg)
            _mesh_sync(torch, dev)
            t_pre = time.perf_counter() - t0
            if run in SERVE_FOLLOWS.values():
                kept[run] = (params, lora, tok, lg, tree_map(lambda v: v.clone(), caches),
                             t_pre)
        else:                   # t_dec below takes t_pre off this clock
            lg, t0 = first, t0 - t_pre
        for t in range(steps + 1):
            logits_all.append(lg.float().cpu())
            ids.append(lg.argmax(-1))
            if t == steps:
                break
            lg, caches = TM.decode_step(cfg, params, ids[-1][:, None], caches, S + t,
                                        lora=lora, rt=rt)
            lg = whole(lg)
        _mesh_sync(torch, dev)
    t_dec = (time.perf_counter() - t0 - t_pre) / steps
    launches = dict(backend.LAUNCH_COUNTS)
    shapes = [{k: tuple(v.shape) for k, v in c.items()} for c in caches[:2]]
    backend.define_ops()
    with torch.no_grad(), FlopCounterMode(display=False) as fc, backend.as_ops():
        TM.decode_step(cfg, params, ids[-1][:, None], caches, S + steps - 1, lora=lora, rt=rt)
    return {"ids": torch.stack(ids, 1).cpu(), "logits": torch.stack(logits_all, 1),
            "launches": launches, "prefill_s": t_pre, "step_s": t_dec, "steps": steps,
            "flops": int(fc.get_total_flops()), "cache_shapes": shapes,
            "per_run": serve_per_run(cfg, run, steps)}


def _serve_rank(rank, world, store, out, device, backend, small, runs):
    """One rank of phase 20 (a spawned process): ``runs`` over a (1, world)
    mesh on a ``backend`` group, or with no group in a world of one."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_file_store, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    mesh = None
    if world > 1:
        dev = init_file_store(store, rank, world, device=dev.type, backend=backend)
        mesh = make_mesh((1, world), ("data", "model"), dev)
    res = {"rank": rank, "runs": {}}
    kept = {}
    for run in runs:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        res["runs"][run] = _serve_run(torch, np, dev, mesh, small, run, kept)
        res["runs"][run]["peak_gib"] = _mesh_peak(torch, dev)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()


def _serve_spawn(world, backend, device, small, tmp, runs):
    import pickle

    import torch.multiprocessing as mp
    tag = f"serve{world}{runs[0]}"
    store, out = tmp / f"store{tag}", tmp / f"out{tag}"
    mp.start_processes(_serve_rank, args=(world, str(store), str(out), device, backend, small,
                                          runs),
                       nprocs=world, join=True, start_method="spawn")
    res = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))
    return res


DRYRUN_CHECK = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import evaluate, fake_device
from repro_torch.launch.mesh import init_fake, make_mesh
B, L, tp, rank = (int(a) for a in sys.argv[2:6])
cfg = get_arch("yi-9b").replace(lora_targets=tuple(sys.argv[6].split(",")))
if sys.argv[7] == "small":
    cfg = cfg.replace(num_layers=2, d_model=64, num_heads=8, head_dim=8, d_ff=128)
init_fake(tp, rank)
mesh = make_mesh((1, tp), ("data", "model"), fake_device())
_, cost, _ = evaluate(cfg, ShapeConfig("decode", L, B, "decode"), mesh,
                      {"dense_impl": "fused", "decode_attn_impl": "flash"})
print(json.dumps({"flops": cost.flops, "by_op": cost.flops_by_op}))
"""


def phase_serve_tp(torch, np, dev, flush=None, small=False):
    """20. Prefill and decode over a ("data", "model") mesh, and the
    dry-run: (a) yi-9b at tp 2 (its KV cache cut by heads, ``flash_decode``
    on each rank's), (b) at tp 8 (KH 4 does not divide 8: the cache cut by
    its length, the partial softmaxes joined over the ranks: the plain
    ones, then ``flash_decode_partial``'s from the same prefill), (c)
    Mamba2-2.7B at tp 2 (``ssd_scan`` on each rank, the state in pieces),
    each held against one process of the port on the same weights through
    the plain PyTorch versions (einsum projections, the plain decode
    attention, the chunked scan; Mamba2's in f64 beside f32, held as
    phase 12 holds its witness), so that every kernel launched at a
    rank's local shapes answers to plain PyTorch on the same inputs; (d) the
    dry-run of one pair of each shape kind at (16, 16) (yi-9b's decode
    also under "flash"), and its FLOPs of
    (a)'s decode step against ``FlopCounterMode``'s on (a)'s ranks.
    Returns the launches of the main-path runs."""
    import os
    import tempfile
    t_phase = time.perf_counter()
    device = dev.type
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    smi = smi_line() if device == "cuda" else "cpu"
    launches_total = {}
    expect = functools.partial(mesh_expect, phase=20, prefix="serve")

    def add(l_):
        for k, v in l_.items():
            launches_total[k] = launches_total.get(k, 0) + v

    # (d) starts first: its abstract runs need no card and take the host's
    # other cores while the ranks run
    env = dict(os.environ, PYTHONPATH=str(SRC))
    drs = {}
    for i, (arch, shape, rt_) in enumerate(DRYRUN_PAIRS):
        drs[(arch, shape, rt_)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--out", str(tmp / f"dryrun{i}")] + (["--rt", *rt_] if rt_ else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    yi = _serve_cfg("yi-9b", small)
    B, S, steps = SERVE_DIMS["yi-9b"]
    checks = {r: subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHECK, str(SRC), str(B), str(S + steps), "2", str(r),
         ",".join(yi.lora_targets), "small" if small else "full"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)}

    def held(tag, got, want, what, yard=None):
        """``got``'s ids equal ``want``'s, its logits within SERVE_TOL of
        the largest; against an f64 witness, ``yard`` (the plain f32
        path's distance from it) allows up to 3x that, as phase 12 does.
        A run of ``SERVE_STEPS`` is held to ``want``'s first steps."""
        n = got["logits"].shape[1]
        want = {k: want[k][:, :n] for k in ("ids", "logits")}
        e = (got["logits"] - want["logits"]).abs().max().item()
        top = want["logits"].abs().max().item()
        same = torch.equal(got["ids"], want["ids"])
        tol = SERVE_TOL * top if yard is None else max(SERVE_TOL * top, 3 * yard)
        good = same and e <= tol and bool(torch.isfinite(got["logits"]).all())
        why = (f"tol {SERVE_TOL:g} of it" if yard is None else
               f"tol {tol:.3g}: the larger of {SERVE_TOL:g} of it and 3x the plain f32 "
               f"path's distance {yard:.3g} from the witness")
        print(f"[serve] {tag} {what}: token ids {'identical' if same else 'DIFFER'} "
              f"({tuple(got['ids'].shape)}), logits max_abs_err {e:.3g} = {e / top:.3g} of "
              f"the largest {top:.3g} ({why}) {'ok' if good else 'FAIL'}")
        if not good:
            fail(f"phase 20 {tag}: {what} disagrees")

    def witness_yard(plain, wit):
        """The plain f32 path's largest logit distance from the f64 witness
        over the steps whose inputs agree: up to and including the first
        step whose greedy id differs."""
        agree = (plain["ids"] == wit["ids"]).all(0).tolist()
        k = agree.index(False) + 1 if False in agree else len(agree)
        return (plain["logits"][:, :k] - wit["logits"][:, :k]).abs().max().item()

    def report(tag, ranks, want, run, plain=None):
        yard = None if plain is None else witness_yard(plain, want)
        what = "the plain versions" + (" in f64" if plain is not None else "")
        for r in ranks:
            m = r["runs"][run]
            print(f"[serve] {tag} rank {r['rank']} {run}: prefill {m['prefill_s'] * 1e3:.1f} ms, "
                  f"{m['step_s'] * 1e3:.2f} ms a decode step (host clock, synchronized), "
                  f"peak {m['peak_gib']:.2f} GiB, cache pieces {m['cache_shapes']} ({smi})")
            start = (f"{SERVE_FOLLOWS[run]}'s prefill," if run in SERVE_FOLLOWS
                     else "prefill +")
            expect(f"{tag} rank {r['rank']}", f"{run} {start} {m['steps']} decode steps",
                   m["launches"], m["per_run"], 1)
            held(f"{tag} rank {r['rank']}", m, want,
                 f"{run} over (1, {len(ranks)}) vs one process through {what}", yard)
            add(m["launches"])

    # -- references: one process, no group, the plain versions ------------------
    t0 = time.perf_counter()
    (one,) = _serve_spawn(1, "gloo", device, small, tmp,
                          ["yi_plain", "mamba_plain", "mamba_f64"])
    for run, m in one["runs"].items():
        expect("(ref)", f"{run} with no group", m["launches"], m["per_run"], 1)
        print(f"[serve] (ref) {run} one process: prefill {m['prefill_s'] * 1e3:.1f} ms, "
              f"{m['step_s'] * 1e3:.2f} ms a decode step, peak {m['peak_gib']:.2f} GiB ({smi})")
    print(f"[serve] references spawned and ran in {time.perf_counter() - t0:.1f}s (host clock)")

    # -- (a) yi-9b, tp 2, the cache cut by heads ---------------------------------
    t0 = time.perf_counter()
    two = _serve_spawn(2, "gloo", device, small, tmp, ["yi_heads"])
    print(f"[serve] (a) two ranks on one {device} over gloo, mesh (1, 2): {time.perf_counter() - t0:.1f}s")
    report("(a)", two, one["runs"]["yi_plain"], "yi_heads")

    # -- (b) yi-9b, tp 8, the cache cut by its length: naive, then flash from a
    # copy of the same prefill's caches --------------------------------------------
    t0 = time.perf_counter()
    eight = _serve_spawn(8, "gloo", device, small, tmp, ["yi_len", "yi_len_flash"])
    print(f"[serve] (b) eight ranks on one {device} over gloo, mesh (1, 8): {time.perf_counter() - t0:.1f}s")
    report("(b)", eight, one["runs"]["yi_plain"], "yi_len")
    report("(b)", eight, one["runs"]["yi_plain"], "yi_len_flash")

    # -- (c) Mamba2-2.7B, tp 2 ----------------------------------------------------
    t0 = time.perf_counter()
    mam = _serve_spawn(2, "gloo", device, small, tmp, ["mamba"])
    print(f"[serve] (c) two ranks on one {device} over gloo, mesh (1, 2): {time.perf_counter() - t0:.1f}s")
    report("(c)", mam, one["runs"]["mamba_f64"], "mamba", one["runs"]["mamba_plain"])

    # -- (d) the dry-run ------------------------------------------------------------
    for (arch, shape, rt_), proc in drs.items():
        out, _ = proc.communicate(timeout=900)
        lines = [ln for ln in out.splitlines() if ln.startswith(("==", "roofline:", "memory_"))]
        for ln in lines:
            print(f"[serve] (d) {ln}" + (f" (--rt {' '.join(rt_)})" if rt_ else ""))
        if proc.returncode != 0 or not any(ln.startswith("roofline:") for ln in lines):
            print(out[-3000:])
            fail(f"phase 20 (d): the dry-run of {arch} x {shape} {' '.join(rt_)} failed")
    for r, proc in checks.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            print(out[-3000:])
            fail("phase 20 (d): the dry-run of (a)'s decode step failed")
        fake = json.loads(out.strip().splitlines()[-1])
        real = two[r]["runs"]["yi_heads"]["flops"]
        good = int(fake["flops"]) == real
        print(f"[serve] (d) (a)'s decode step, rank {r}: the dry-run's FLOPs at a fake (1, 2) "
              f"mesh {int(fake['flops'])} vs FlopCounterMode's on the card's rank {real} "
              f"{'ok' if good else 'FAIL'}")
        if not good:
            fail("phase 20 (d): the dry-run's FLOPs differ from the real rank's")
    print(f"[serve] phase 20 wall {time.perf_counter() - t_phase:.1f}s (host clock) ({smi})")
    return launches_total

# -- phase 21: the five examples on the port -----------------------------------

# each example in its own process through this runner, which prints its
# wall time (host clock, from the example's first line to its last) and its
# launches by kernel after it (argv: src, the example, its arguments)
EXAMPLE_RUN = """
import json, runpy, sys, time
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import backend
sys.argv = sys.argv[2:]
t0 = time.perf_counter()
runpy.run_path(sys.argv[0], run_name="__main__")
print(f"WALL {time.perf_counter() - t0}")
print("LAUNCHES " + json.dumps(dict(sorted(backend.LAUNCH_COUNTS.items()))))
"""
EXAMPLES = ("quickstart", "train_sfl_e2e", "resource_allocation_demo", "continuous_batching",
            "serve_lora")
EXAMPLE_TRAIN = ("--steps", "4", "--local-steps", "2", "--clients", "3", "--batch", "2",
                 "--seq", "32")
# what the examples reach together on the card: rows 1-4 and 6 of PERF.md's
# table (the fused runtime's projections and their backward, the paged and
# the slab decode)
EXAMPLE_KERNELS = ("lora_matmul", "lora_matmul_dx", "lora_rank_reduce", "paged_decode",
                   "flash_decode")


def phase_examples(dev):
    """21. ``examples/torch_*.py`` on the card at ``REPRO_SMOKE=1``, each in
    a subprocess with its default device: the four that need nothing
    started together, then ``torch_serve_lora.py --adapter`` on the file
    ``torch_train_sfl_e2e.py`` wrote (``repro``'s msgpack format).  Each
    must exit 0; prints each one's wall time (run beside the others) and
    its launches by kernel.  Returns their launches."""
    import os
    import tempfile
    t_phase = time.perf_counter()
    smi = smi_line() if dev.type == "cuda" else "cpu"
    ada = str(Path(tempfile.mkdtemp(prefix="chip_smoke_examples_")) / "ada.msgpack")
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_SMOKE="1")
    args = {"train_sfl_e2e": [*EXAMPLE_TRAIN, "--out", ada],
            "serve_lora": ["--adapter", ada, "--gen", "8"]}

    def start(name):
        return subprocess.Popen(
            [sys.executable, "-c", EXAMPLE_RUN, str(SRC),
             str(SRC.parent / "examples" / f"torch_{name}.py"), *args.get(name, [])]
            + (["--device", "cpu"] if dev.type == "cpu" else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)

    def finish(name, p_):
        out, _ = p_.communicate(timeout=600)
        tail = {ln.split(" ", 1)[0]: ln.split(" ", 1)[1] for ln in out.splitlines()
                if ln.startswith(("WALL ", "LAUNCHES "))}
        if p_.returncode != 0 or len(tail) != 2:
            print(out[-3000:])
            fail(f"phase 21: examples/torch_{name}.py exited {p_.returncode}")
        n = json.loads(tail["LAUNCHES"])
        print(f"[examples] torch_{name}.py: rc 0, {float(tail['WALL']):.1f}s wall (host clock, "
              f"beside the others), launches {n} ({smi})")
        return n

    procs = {n_: start(n_) for n_ in EXAMPLES if n_ != "serve_lora"}
    res = {"train_sfl_e2e": finish("train_sfl_e2e", procs.pop("train_sfl_e2e"))}
    serve = start("serve_lora")
    res.update({n_: finish(n_, p_) for n_, p_ in procs.items()})
    res["serve_lora"] = finish("serve_lora", serve)
    total = {}
    for n in res.values():
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    missing = [k for k in EXAMPLE_KERNELS if not total.get(k)]
    print(f"[examples] together: {total}; rows 1-4 and 6 reached: "
          f"{'ok' if not missing else 'FAIL, missing ' + ', '.join(missing)}")
    if missing:
        fail(f"phase 21: the examples launched no {missing}")
    print(f"[examples] phase 21 wall {time.perf_counter() - t_phase:.1f}s (host clock) ({smi})")
    return total


# -- phase 22: the launch-plan tuners ------------------------------------------

# (row, problem, what, (M, K, N, r)): phase 22's LoRA shapes, f32 and bf16;
# problem is the launch: forward, gather (8 adapters), dx, q8, q8_dx
TUNE_LORA = (("1", "forward", "GPT-2-S decode", (8, 768, 768, 4)),
             ("1", "forward", "GPT-2-S training", (768, 768, 768, 4)),
             ("1", "forward", "Mamba2 ssm_in prefill", (200, 2560, 10576, 4)),
             ("1", "forward", "Mamba2 ssm_out prefill", (200, 5120, 2560, 4)),
             ("1", "forward", "front ends' prefill", (1280, 2048, 2048, 4)),
             ("1", "forward", "yi-9b's TP-local down", (512, 5504, 4096, 4)),
             ("3", "dx", "GPT-2-S training", (768, 768, 768, 4)),
             ("7", "gather", "multi-tenant decode", (8, 768, 768, 4)),
             ("8", "q8", "fleet server", (768, 768, 768, 8)),
             ("9", "q8_dx", "fleet server", (768, 768, 768, 8)))
# (row, what, (B, KH, G, D), paged): the decode shapes at 512 positions
# (16-position pages), the serving spread of lengths
TUNE_DECODE = (("2", "GPT-2-S serving", (8, 12, 1, 64), True),
               ("6", "GPT-2-S serving", (8, 12, 1, 64), False),
               ("2", "yi-9b", (8, 4, 8, 128), True),
               ("6", "yi-9b", (8, 4, 8, 128), False))
TUNE_LENGTHS = [8, 40, 77, 120, 160, 200, 232, 255]


def tune_line(label: str) -> None:
    """Print the tuning this process has done since the last such line
    (keys timed, their candidates and launches, host ms) and count anew."""
    from repro_torch.kernels import autotune
    s = autotune.STATS
    print(f"[tune] {label}: {s['keys']} keys timed, {s['candidates']} candidates, "
          f"{s['launches']} tuning launches, {s['ms']:.1f} ms (host clock)")
    autotune.reset_stats()


def phase_tuner(torch, dev, flush):
    """22. The launch-plan tuners at the main path's shapes (``PERF.md``
    §6 rows 1, 2, 3, 6, 7, 8, 9), memos emptied first: each shape's
    heuristic plan and every candidate timed as phase 4 times (median of
    60, L2 flushed), the tuner's pick (``best_*`` with the caller's
    operands, as the wrapper asks) and its time; every candidate's output
    ``torch.equal`` to the heuristic plan's, f32 and bf16; a second
    ``best_*`` call returns the memoized plan with no launch and nothing
    timed, and its host cost a hit."""
    from repro_torch.kernels import autotune, backend
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import tune as ftune
    from repro_torch.kernels.flash_attention.plan import decode_plan
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.lora_matmul import tune as ltune
    t_phase = time.perf_counter()
    smi = smi_line()
    for clear in (ltune.clear_cache, ftune.clear_cache, ftune.clear_paged_cache):
        clear()
    autotune.reset_stats()
    gen = torch.Generator().manual_seed(22)
    picks = {}

    def rnd(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen) * std).to(dev, dt)

    def lora_case(problem, M, K, N, r, dt):
        """(best_* of the wrapper's call, launch(plan) into out, out,
        heuristic plan, candidates)."""
        x_or_dy = rnd(M, N if problem in ("dx", "q8_dx") else K, dt=dt)
        a, b = rnd(r, K, std=r ** -0.5, dt=dt), rnd(N, r, std=0.05, dt=dt)
        int8 = problem in ("q8", "q8_dx")
        w = (torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).to(dev)
             if int8 else rnd(K, N, std=K ** -0.5, dt=dt))
        ws = (torch.rand(N, generator=gen) * 0.01).to(dev)
        dx = problem in ("dx", "q8_dx")
        out = torch.empty(M, K if dx else N, dtype=dt, device=dev)
        aligned = lops._aligned(x_or_dy, w) if problem != "q8_dx" else lops._aligned(
            x_or_dy, w, ws)
        if problem == "gather":
            ap, bp = rnd(8, r, K, std=r ** -0.5, dt=dt), rnd(8, N, r, std=0.05, dt=dt)
            idx = torch.arange(M, dtype=torch.int32, device=dev) % 8

            def launch(p):
                lops.launch_gather(x_or_dy, w, ap, bp, idx, out, 2.0, p)

            def best():
                return ltune.best_gather_blocks(M, K, N, r, 8, dt, torch.int32, dev,
                                                aligned=aligned, run=launch)
        else:
            launch = {"forward": lambda p: lops.launch_forward(x_or_dy, w, a, b, out, 2.0, p),
                      "dx": lambda p: lops.launch_dx(x_or_dy, w, a, b, out, 2.0, p),
                      "q8": lambda p: lops.launch_q8(x_or_dy, w, ws, a, b, out, 2.0, p),
                      "q8_dx": lambda p: lops.launch_q8_dx(x_or_dy, w, ws, a, b, out, 2.0,
                                                           p)}[problem]

            def best():
                return ltune.best_blocks(M, K, N, r, dt, dev, torch.int8 if int8 else None,
                                         problem="dx" if dx else "forward", aligned=aligned,
                                         run=launch)
        plan = ltune.heuristic_plan("dx" if dx else "forward", M, K, N, dt.itemsize, int8,
                                    aligned)
        cands = ltune.candidates(plan, M, dt.itemsize, 1 if int8 else dt.itemsize, dx)
        return best, launch, out, plan, cands

    def decode_case(B, KH, G, D, paged, dt):
        PS, MP = 16, 32
        q = rnd(B, KH, G, D, dt=dt)
        lens = torch.tensor(TUNE_LENGTHS[:B], dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        if paged:
            NP = B * MP + 1
            kp, vp = rnd(KH, NP, PS, D, dt=dt), rnd(KH, NP, PS, D, dt=dt)
            bt = (torch.randperm(NP - 1, generator=gen)[:B * MP].int() + 1).reshape(
                B, MP).to(dev)

            def launch(p, n=lens):
                fops.launch_paged(q, kp, vp, n, bt, out, p)

            def best():
                return ftune.best_paged_block(B, KH, G, MP, PS, D, dt, dev, dt,
                                              aligned=fops._kv_aligned(kp, vp), run=launch)
        else:
            k, v = rnd(B, MP * PS, KH, D, dt=dt), rnd(B, MP * PS, KH, D, dt=dt)

            def launch(p, n=lens):
                fops.launch_slab(q, k, v, n, out, 0, p)

            def best():
                return ftune.best_decode_block(B, KH, G, MP * PS, D, dt, dev, dt,
                                               aligned=fops._kv_aligned(k, v), run=launch)
        plan = decode_plan(MP * PS, B, KH, G, D, dt)
        return best, launch, out, plan, ftune.candidates(plan, G, dt)

    def run_case(label, op, case, dn):
        best, launch, out, plan, cands = case
        outs = []
        for p in cands:
            launch(p)
            torch.cuda.synchronize()
            outs.append(out.clone())
        differ = [p for p, o in zip(cands, outs) if not torch.equal(o, outs[0])]
        finite = bool(torch.isfinite(outs[0].float()).all())
        st0 = dict(autotune.STATS)
        t0 = time.perf_counter()
        pick = best()
        tune_ms = (time.perf_counter() - t0) * 1e3
        before, st1 = dict(backend.LAUNCH_COUNTS), dict(autotune.STATS)
        again = best()
        memo_ok = (again is pick and dict(autotune.STATS) == st1
                   and dict(backend.LAUNCH_COUNTS) == before)
        n_hit = 20000
        t0 = time.perf_counter()
        for _ in range(n_hit):
            best()
        hit_us = (time.perf_counter() - t0) / n_hit * 1e6
        good = not differ and finite and memo_ok and pick in cands
        print(f"[tuner] {label} {dn}: {len(cands)} candidates, all torch.equal to the "
              f"heuristic plan's: {not differ}; pick {pick}; tuning {tune_ms:.1f} ms "
              f"({st1['keys'] - st0['keys']} key timed); second call memoized with no "
              f"launch: {memo_ok}; a hit {hit_us:.2f} us (host clock) "
              f"{'ok' if good else 'FAIL'}")
        if not good:
            fail(f"phase 22: {label} {dn}: differing {differ}, finite {finite}, "
                 f"memo {memo_ok}, pick {pick}")
        if dn != "float32":
            return
        times = {p: time_ms(torch, lambda p=p: launch(p), flush) for p in cands}
        for p, t in times.items():
            tag = "heuristic" if p == plan else "candidate"
            tag += ", picked" if p == pick else ""
            print(f"[tuner]   {op} {label} f32 {tag}: {p} {t * 1e3:.2f}us ({smi})")
        print(f"[tuner]   {op} {label} f32: heuristic {times[plan] * 1e3:.2f}us, tuner's "
              f"pick {times[pick] * 1e3:.2f}us ({times[plan] / times[pick]:.3f}x)")

    for dt, dn in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        for row, problem, what, (M, K, N, r) in TUNE_LORA:
            op = {"forward": "lora_matmul", "gather": "lora_matmul_gather",
                  "dx": "lora_matmul_dx", "q8": "lora_matmul_q8",
                  "q8_dx": "lora_matmul_q8_dx"}[problem]
            label = f"row {row} {what} M={M} K={K} N={N} r={r}"
            run_case(label, op, lora_case(problem, M, K, N, r, dt), dn)
        for row, what, (B, KH, G, D), paged in TUNE_DECODE:
            op = "paged_decode" if paged else "flash_decode"
            label = f"row {row} {what} B={B} KH={KH} G={G} D={D} capacity 512"
            run_case(label, op, decode_case(B, KH, G, D, paged, dt), dn)
    tune_line("phase 22")
    wall = time.perf_counter() - t_phase
    print(f"[tuner] phase 22 wall {wall:.1f}s (host clock; budget 60 s) "
          f"{'ok' if wall < 60 else 'FAIL'} ({smi})")
    if wall >= 60:
        fail(f"phase 22 took {wall:.1f} s")


def tuner_only() -> None:
    """``--tuner``: the kernels built, then phase 22 alone."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    build.build(force=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush_buf = torch.ones(16 * 2 ** 20, dtype=torch.int32, device=dev)
    phase_tuner(torch, dev, flush_buf.sum)
    print(smi_line())


HOST_TIMES = """
import sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
sys.path.insert(0, str(cs.SRC))
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
flush = torch.ones(16 * 2 ** 20, dtype=torch.int32, device=dev).sum
print(f"[host-times] tree {sys.argv[1]} ({cs.smi_line()})", flush=True)
t0 = time.perf_counter()
cs._tp_kernels(torch, np, dev, flush, lambda op, e: None)
cs.phase_mamba_train(torch, np, dev, flush)
print(f"[host-times] tree {sys.argv[1]}: {time.perf_counter() - t0:.1f}s", flush=True)
"""


PARTIAL_TIMES = """
import sys
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels.flash_attention import flash_decode_partial
dev = torch.device("cuda", 0)
flush = torch.ones(16 * 2 ** 20, dtype=torch.int32, device=dev).sum
for what, shape in cs.PARTIAL_SHAPES:
    r = cs.time_partial(torch, dev, flush, flash_decode_partial, *shape, full=False)
    print(f"[partial-times] tree {sys.argv[1]}: {what} (B, KH, G, D, Lc) = {shape}: kernel "
          f"{r['ms'] * 1e3:.2f}us, L2 warm {r['warm_ms'] * 1e3:.2f}us", flush=True)
"""


def tree_runs(trees, script: str, label: str) -> None:
    """``--host-times`` and ``--partial-times``: every tree's kernels built
    at once, then ``script`` (argv: the tree, this script's directory) for
    each tree in its own process, in order."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    trees = [str(Path(t).resolve()) for t in trees] or [str(SRC.parent)]
    build = "import sys; sys.path.insert(0, sys.argv[1]); " \
            "from repro_torch.kernels import build; build.build(force=True)"
    procs = [subprocess.Popen([sys.executable, "-c", build, str(Path(t) / "src")])
             for t in dict.fromkeys(trees)]
    if any(p_.wait() for p_ in procs):
        fail("a tree's kernels did not build")
    for t in trees:
        if subprocess.run([sys.executable, "-c", script, t, str(SRC.parent)]).returncode:
            fail(f"{label} of {t} failed")
    print(smi_line())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-times"]:
        tree_runs(sys.argv[2:], HOST_TIMES, "phase 16 or 19 (e)")
    elif sys.argv[1:2] == ["--partial-times"]:
        tree_runs(sys.argv[2:], PARTIAL_TIMES, "flash_decode_partial's times")
    elif sys.argv[1:2] == ["--tuner"]:
        tuner_only()
    else:
        main()
